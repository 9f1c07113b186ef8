#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --wrapper-host-us DIR   # the flash forward's
        # and kernel 7's wrappers' host microseconds a call, DIR's package
        # (another checkout) against this one's, a process each, alternated
        # DIR, this, this, DIR, on one card

Phases (any failure exits non-zero; nothing is caught):

1. Card: the GPU's name and power limit (nvidia-smi), a sha256 over the
   port's sources and this script (source_fingerprint(), so a run can be
   matched to a commit), and the build of every kernel under
   horovod_tpu_torch/csrc/ with nvcc (all at once), with the libraries
   that _build/ already held before it.
2. Kernel vs plain: the flash-attention forward kernel against its plain
   PyTorch version on the card, q/k/v as column views of one fused
   projection, at GPT-2 small's serving and training shape (B=8, S=1024,
   H=12, D=64, causal bf16), at batch 16 (the fp8 step's), two
   ragged/offset cases, two with query tiles that see no key, the new
   phases' non-causal shapes (ViT-L/16 at 224: B=32, S=197, H=16; BERT-base:
   B=32, S=512, H=12; D=64), and ragged
   tile edges (Sq, Skv of 1, 63, 65, 127, 129, 1000 with kv_len < Skv, D
   64 and 128, causal with q_offset > 0); prints max |d out| (<= 1e-2)
   and max |d lse| (<= 1e-3), the rows without keys (-inf in both), and
   a second call must equal the first bit for bit. At batch 8 and 16: the
   kernel's and the plain version's times (CUDA events around runs of 10
   back-to-back calls, median of 25 runs after warm-up), the kernel's
   device time (device_ms: 20 calls enqueued behind a spin kernel that
   holds the stream, so the events time the card's work alone), the
   wrapper's host microseconds a
   call (enqueue only), torch's scaled_dot_product_attention on the same
   inputs as a yardstick (timed here only, by events and by device time;
   the port never calls it), TFLOP/s by each, and the least time the card
   could take (bytes over 3.35 TB/s, operations over 989 TFLOP/s).
3. Kernel vs plain, flash backward: the dQ and dK/dV kernels (one
   flash_attention_bwd call: dQ first, computing delta, then dK/dV)
   against flash_attention_bwd_reference at GPT-2 small's training shape
   (B=8, S=1024, H=12, D=64, causal; q/k/v column views of one [8, 1024,
   2304] bf16 tensor, out and lse from the kernel forward), at batch 16
   (the fp8 step's), two ragged/offset cases (non-causal with kv_len and
   q_offset; D=128 causal with q_offset > 0), two with an fp32 cotangent
   of out (delta from it as given, the products from it rounded to bf16)
   and three on ragged tile edges (Sq, Skv of 1, 63, 65, 127, 129, 1000
   with kv_len < Skv, D 64 and 128), and the new phases' non-causal shapes
   (ViT-L/16 at 224: B=32, S=197, H=16; BERT-base: B=32, S=512, H=12; D=64);
   both cotangents nonzero; max |d dq|,
   |d dk|, |d dv| <= 1e-2 x the plain version's largest gradient (bf16
   outputs, P and dS rounded to bf16 at other points of the sums), and a
   second call equal to the first bit for bit. At batch 8 and 16 the pair
   is timed with CUDA events, each kernel alone by its device time under
   torch.profiler; beside them the plain version and the backward of
   scaled_dot_product_attention(is_causal=True) as the yardstick, by
   events and by device time (device_ms: every kernel of its call), with
   TFLOP/s by each. The pair's bound counts the five products the gradient
   needs (S, dP, dV, dK, dQ); each kernel's, S, dP and its own products.
4. Kernel vs plain, fused AdamW: flat fp32 buffers of the trainer's bucket
   sizes (GPT-2 small, world 1, default fusion threshold); max |d| of the
   update and both moments <= 1e-6 x the largest value (every operation is
   IEEE-rounded in the plain version's order; powf of the bias corrections
   may differ from torch.pow by an ulp). The gradient guard's skip flag at
   the same buckets: ok = 0 leaves the moments bit for bit and writes -0.0
   updates (the plain version with the flag agrees bit for bit), ok = 1 is
   the flagless call bit for bit; both timed beside it. Timed over all buckets with the
   plain version and torch.optim.AdamW(fused=True) on the same buffers as
   the yardstick (its decay order differs); bound 28 bytes an element.
5. Training: GPT-2 small at full width with fp32 master weights and bf16
   compute, from convert.init_params(seed=0), on a one-rank NCCL world
   (horovod_tpu_torch.init(backend="nccl")), through
   make_train_step(loss, fused_adamw(1e-4), sharded=True,
   fused_update=True), on one batch of 8 x 1024 tokens from a numpy seed
   used every step. From the same start, the gradients and one step of
   the plain path (use_flash=False, fused_update=False) are held against
   the kernel path: all gradients within 5e-2 in relative L2 norm, every
   parameter within 2 lr (1 + wd |p|) + 1e-6 of the plain step's, and at
   most 2% of the elements stepping the other way (Adam's first step
   moves every element by lr (sign g + wd p), so a gradient element within
   bf16 noise of zero can flip). Then 3 warm-up and 20 timed steps: each
   step's loss, the median step ms, tokens/s and MFU (obs/flops.py, H100
   SXM bf16 peak).
   Every loss must be finite and the last below the first; the launch
   counts, set to 0 just before the timed steps, must be 12 forward,
   12 dK/dV, 12 dQ and one AdamW per bucket per step. A torch.profiler
   window over one step gives device time by kernel category and the
   device's idle share.
6. Serving: GPT-2 small at full width from convert.init_params(seed=0),
   saved with the port's save_checkpoint and served by ServePool
   (2 workers, batch 8); 64 requests of 1024 tokens from a numpy seed,
   submitted all at once, in 5 rounds (each round's requests/s and p50/p95
   latency are printed, so the spread is seen within one run).
   The kernel's launch count is set to 0 just before the rounds and must
   equal 12 x batches served. The first 8 answers are recomputed with attention
   forced to the plain version: max |d logits| <= 0.05 max |logits| and
   the same argmax wherever the top-2 margin exceeds that bound. A
   torch.profiler window over 16 more served requests reports device
   time by kernel (flash, matmul, copies, other) and the device's idle
   share of the window's wall time (profiler overhead included). Then a
   step-2 checkpoint is published and the pool must roll onto it one
   worker at a time.
7. [quant] Kernel vs plain, blockwise quantize and dequantize: flat fp32
   buffers of the quantized trainer's bucket sizes (the 4 buckets above,
   padded to 256) and ragged cases (n = 1000 at block 256; blocks 8, 16 and
   65536; a buffer off a 16-byte boundary; an all-zero block and a block
   holding a NaN), int8 and fp8 e4m3. Payloads, scales and dequantized
   values must equal the plain version's bit for bit (every operation is
   IEEE-rounded in the same order), except the int8 value of a NaN element,
   undefined in both (an fp8 NaN may differ in its sign bit). Timed over
   the buckets with time_ms beside the plain versions and, for the int8
   dequantize, torch.mul of the payload rows by the scale column (one
   PyTorch call computing the same function; no single call computes the
   quantize); bound: 5 + 4/256 bytes an element over 3.35 TB/s. Then the
   decode path's KV shapes at block = head_dim = 64 (quantize_kv_heads /
   dequantize_kv_heads): one round's write, k and v of [12, 8, 12, 64]
   fp32 (an all-zero head, and a copy 4 bytes past a 16-byte boundary),
   and one round's gather, k and v of [12, 8, 1040, 12, 64] int8 with
   their scales, bit for bit against the plain versions, each pair timed
   by events and by device time beside the plain versions (and torch.mul
   for the gather) with its byte bound.
8. [train-quant] The quantized wire on/off pair, the JAX package's
   bench_quant configuration: from the same convert.init_params(seed=0)
   start, make_train_step(loss, adamw(1e-4), compression=...) with
   Compression.none and then Compression.int8 (block 256, error
   feedback), each 3 warm-up and 20 timed steps on the training batch:
   step_ms_off, step_ms_on, tokens/s, and the gradient wire bytes
   (quantized_wire_bytes of the padded buckets against the fp32 and bf16
   gradient bytes). Losses finite and falling; the int8 run's last loss
   within 5% of the none run's. Launch counts, set to 0 just before the
   timed steps: 12 of each flash kernel a step in both, and in the int8 run
   exactly 2 quantize and 2 dequantize per bucket per step (the send and
   the gather; the EF residual's dequantize and the final one; the
   all-to-all sum is plain). One profiled int8 step gives device time by
   category.
9. [train-quant-zero1] make_train_step(loss, fused_adamw(1e-4),
   sharded=True, fused_update=True, compression=Compression.int8): 3
   warm-up and 10 timed steps; per bucket per step 2 quantize, 2
   dequantize (the quantized reduce-scatter and update all-gather) and 1
   fused AdamW; losses fall.
10. [train-quant-fp8] Three replicated steps on the fp8 wire: losses
   finite, 2 quantize and 2 dequantize per bucket per step.
   The serving phase (6.) runs after 11.-13., before 14. and 15.
11. [fp8] Kernel 8 (fp8 wgmma on K-major operands) vs its plain version
   (fp8_matmul_reference): the reference test's ragged cases (5, 300, 70),
   (16, 512, 128), (1, 257, 10) and (130, 129, 260) in the four pairings
   (e4m3 / e5m2 each side), fp32 and bf16 out, each once K-major and once
   with w as a row-major [K, N] tensor, which (like K not a multiple of 16)
   goes through the relayout copy; and every distinct call of a
   GPT-2-small fp8 training step at M = 16 x 1024 rows (forward x @ w.T, dX
   g @ w, dW g.T @ x, for the 768x768, fc and proj weights; bf16 out, dW in
   fp32 too), operands in the K-major layouts the path hands it (0
   relayouts). Largest difference relative to the largest plain value:
   <= 1e-4 (fp32), <= 8e-3 (bf16); the fp32 dW (K = 16,384) is printed as
   the promotion's error, and one k-step ([768, 32] x [32, 768], fp32) as
   the fp8 tensor cores' own rounding of a 32-product sum. Each call timed with time_ms beside the plain
   version and torch._scaled_mm on the same operands (a yardstick the port
   never calls), with its TFLOP/s and its bound: fp8 bytes in and bf16 out
   over 3.35 TB/s, or its operations over 1,979 TFLOP/s, the larger;
   summed over one step's 216 launches. Each call is also timed by its
   device time (device_ms), and so is torch._scaled_mm: the wrapper's
   host time exceeds the shorter calls' kernel time, and the event times
   then measure the host.
12. [fp8-cast] The fused cast-transpose-amax kernel vs fp8_cast_reference,
   bit for bit (a NaN payload may differ in its sign bit): at the step's
   shapes (activations and gradients 16,384 x 768 and 16,384 x 3072 bf16,
   e4m3 and e5m2; the weights 768 x 768, 3072 x 768 and 768 x 3072 in
   weight mode with their fp32 residual), on a tensor holding NaN, +-inf
   and values past qmax, with a fresh (all-zero) ring, and on ragged shapes
   with rows off 16-byte boundaries. Each step shape timed (CUDA events and
   device time) beside the plain composition, with its byte bound
   (activation: 2 bytes in, 2 out an element; weight: 6 in, 6 out), summed
   over one step's 216 launches.
13. [train-fp8] The JAX package's bench_fp8 pair at GPT-2 small: "" then
   "fp8", each from convert.init_params(seed=0), make_train_step(loss,
   adamw(1e-3), compute_dtype=...) on one batch of 16 x 1025 tokens from
   numpy.random.RandomState(0), 1 warm-up and 12 timed steps: step_ms_off,
   step_ms_on, speedup, tokens/s, first and last losses, converged (the
   fp8 loss finite, falling, within 0.15 relative of the off run's last),
   the three fp8_state_gauges. Launch counts, set to 0 just before the
   timed steps: 12 of each flash kernel a step, and 216 of kernel 8, 216
   casts and 0 relayouts in the fp8 run (0 of each in the off run). Then
   one Fp8Linear forward and backward at the first layer's fc (its real
   input and trained state) against the same math on fp8_matmul_reference
   (out, dx, dw within 8e-3; the four state gradients bit for bit; 3 casts,
   3 kernel-8 launches, 0 relayouts), and one profiled fp8 step (device
   time by category: elementwise, kernel 8, the cast kernel, the head's
   cuBLAS GEMMs, flash).
14. [int8] Kernel 7 vs its plain version (int8_weight_matmul_reference):
   the reference test's ragged cases (5, 300, 70), (16, 512, 128),
   (1, 64, 10), (130, 1000, 260) and (33, 17, 129) (K not a multiple of 16;
   rows off 16-byte boundaries, which the bf16 kernel's TMA reads only
   after one aligned copy: launches_int8_relayout) with fp32 and bf16
   activations, and the four GPT-2-small serving products (768->2304,
   768->768, 768->3072, 3072->768; bf16, weights quantized on the card) at
   M = 8192 (a batch of 8 x 1024) and M = 8 (decode-sized, a split
   contraction and its sum). Largest
   difference relative to the largest plain value: <= 1e-5 (fp32),
   <= 8e-3 (bf16). Every call is repeated and must equal itself bit for
   bit, and with a bias it must equal the unbiased call plus the bias in
   x's dtype bit for bit; the GPT-2 products take no relayout. The
   compiler's report of int8_matmul.cu (ptxas -v, SASS counts) is printed:
   the bf16 kernel must show HGMMA, UTMALDG, no HMMA and no local memory.
   Each product timed with time_ms as the served path calls it, with its
   bf16 bias, beside the plain version with the same bias,
   torch._weight_int8pack_mm where the build runs it on CUDA (a yardstick
   the port never calls; its scales in bf16, no bias), and F.linear of
   the bf16-dequantized weight with the bias (cuBLAS, the cost the int8
   path replaces: "bf16_ms"), each also by its device time (device_ms;
   at M = 8 the events time the host's launches), with its
   bound: bf16 x, out and bias, int8 weight and fp32 scales over 3.35
   TB/s, or its operations over 989 TFLOP/s, the larger; summed over one
   batch's 48 launches; and the wrapper's host microseconds a call
   (host_us, enqueue only).
15. [serve-int8] GPT-2 small through ServePool(weight_dtype="int8") from a
   copy of the serving phase's step-1 fp32 checkpoint (2 workers, batch 8,
   5 rounds of 64 x 1024-token requests): after load every Dense holds an
   int8 payload and fp32 scales and no floating weight, kernel 4 ran 48
   times (one restore), layer 0's fc payload and scales equal the CPU plain
   quantize_weight of the checkpoint's fp32 tensor bit for bit; the model's
   weight bytes beside the bf16 pool's. Launch counts, set to 0 just before
   the rounds: kernel 7 = 48 x batches (each projection's bias in its
   epilogue), flash forward = 12 x batches, no relayout and no split. The
   first 8 answers against a bf16 model holding the dequantized weights
   (cuBLAS): max |d logits| <= 0.05 max |logits| and the same argmax where
   the top-2 margin exceeds that bound; their relative L2 against the bf16
   pool's answers (the quantization's own error, no bound). One profiled
   window (kernel 7 its own category), whose elementwise launches a batch
   must stay within 24 of the bf16 pool's window (a separate bias add
   would be 48 more); then step 2 is published and the
   pool must roll onto it one worker at a time, int8 again (48 kernel-4
   launches a worker), with changed answers.
16. [ckpt-reshard] (after 8.-10.) GPT-2 small's ZeRO-1 state through
   make_train_step(loss, fused_adamw(1e-4), sharded=True,
   fused_update=True) on the one-rank NCCL world and the training batch:
   (a) at a 64 MiB fusion threshold (7 buckets, the default's 4 printed
   beside it), 2 steps, save_checkpoint, 1 more step (the reference);
   restore_checkpoint into a target at the default threshold and 1 step:
   every parameter within rtol 2e-5, atol 1e-6 of the reference (the JAX
   test's tolerance), max |d| printed; (b) on the int8 wire (block 256,
   error feedback) 2 steps, save, 2 more; restored into a fresh target, 2
   steps that must equal the uninterrupted run bit for bit (losses,
   parameters, moments, residuals), with the launch counts of 9. over the
   resumed steps (set to 0 just before them). The checkpoints' bytes and
   the save and restore seconds are printed, and the phase's wall seconds.
17. [decode] (last) CacheLM at GPT-2-small width (vocab 50257, 12 layers,
   12 heads of 64, 1024 positions), fp32 params from init_params(0),
   through DecodeEngine(rows=8, workers=1, kv_blocks=520,
   kv_block_size=16, max_seq_len=1024): bench_decode's closed loop (rows x
   2 clients) over 32 streams (prompts of 64-512 tokens from
   numpy.random.RandomState(0), 64 new tokens each), after one warm-up
   stream, with fp32 KV, int8 KV, and int8 KV with spec_k=3 and
   perturbed_params(params, 0.02) as the draft: tokens/s, TTFT and TPOT
   p50/p95/p99 ms, mean batch fill, requeued, preempted, accept rate, the
   KV pool's bytes per token. Launch counts, set to 0 just before the
   load: 2 quantize and 2 dequantize per extend call (target and draft,
   counted by a wrapper) with int8 KV, 0 with fp32. The fp32 run's first 4
   streams must equal a full recompute over prompt + generated tokens, and
   the speculative run's streams the plain int8 run's, except at a step
   whose top-2 logit margin (the recompute's; for the int8 runs, the int8
   cache's logits at that prefix) is below 1e-4 x max |logit| (printed);
   the first decode step's logits with int8 KV within 0.05 x max |logit|
   of fp32 KV over 8 prompts, the argmax equal where the fp32 top-2 margin
   exceeds that bound. One profiled window of decode rounds (8 streams
   after their prefill; the tracer brought up before they are submitted)
   in the int8 run: device time by category and the
   idle share. The phase's wall seconds are printed.
18. [train-bert] (after 17.) BERT-base MLM (BertConfig.base(): vocab
   30522, 512 positions, d 768, 12 heads of 64, 12 layers) at bench_bert's
   shape, 32 x 512 tokens from numpy.random.default_rng(5) with MLM weights
   on ~15% of the positions, fp32 master weights and bf16 compute from
   convert.init_bert_params(seed=0), on the one-rank NCCL world. The loss is
   fused_cross_entropy(return_hidden h, mlm_decoder.weight.t(), bias,
   weights). On the flash path, the chunked loss against F.cross_entropy on
   the full fp32 logits: the losses within 1e-5 relative, the gradients
   within 5e-2 relative L2 (the full gradient computed twice printed
   beside it), each gradient's peak memory. The kernel path (flash,
   chunked) against the plain path (plain attention, full logits): the
   loss within 2e-3 relative, the gradients within 5e-2 relative L2. Then
   make_train_step(sharded=True, fused_update=True): 3 warm-up and 10
   timed steps (step ms, tokens/s, MFU, peak memory), 12 of each flash
   kernel and one AdamW a bucket a step, losses finite and falling; then 2
   steps with a padding mask (the last quarter of each row): 0 flash
   launches (the masked route is plain attention).
19. [train-remat] GPT-2 small at the JAX bench's default batch, 32 x 1024
   (tokens from default_rng(7)), from convert.init_params(seed=0): 3 ZeRO-1
   fused steps each with remat none, and dots_saveable and full both per
   block (TransformerConfig.remat) and over the loss (make_train_step(
   remat=)). The first step's gradients and parameters against none's, bit
   for bit (else max |d|, the parameters that differ, and [train]'s 5e-2
   bound), and the parameters after the 3 steps bit for bit where the
   first step was (else within 3 x [train]'s per-step bound); the state
   trains copies of the module's parameters, so a block's recompute must
   read the state's; the last two steps' median ms, the peak memory, and launch
   counts: forward 24 a step under remat (recomputed), 12 without; dK/dV and
   dQ 12. Then at [train]'s batch 8: fused_cross_entropy(h, wte.T) against
   F.cross_entropy on the tied head's bf16 logits (within 1e-3 relative)
   and the peak memory of each gradient.
20. [zoo] ViT-L/16 at 224 (batch 32, S = 197; fed by ShardedBatches, an
   epoch a step over one batch of seeded images, through
   prefetch_to_device), ResNet-50 at 224 (batch 64, channels_last, bf16)
   and SwitchTransformerLM(MoEConfig()) at 8 x 1024 (the aux loss added at
   aux_loss_weight), from seeded init_*_params, 3 ZeRO-1 fused steps each
   on one batch (each ViT step pulls its batch from the feed inside its
   timed window, while the copy of the next one is staged on the copy
   stream): losses finite and falling, step ms and peak memory,
   launches a step 24 (ViT), 0 (ResNet, whose BatchNorm statistics must
   all move) and 12 (MoE) of each flash kernel and one AdamW a bucket. One
   forward of each is held against the same model in fp32 with plain
   attention: relative L2 <= 5e-2; for the MoE on the tokens routed alike
   (expert and capacity) in every MoE layer, at least 90% of them, <= 0.1,
   and its aux loss within 5e-2. Then the fused AdamW kernel against its
   plain version (4.'s bound) at the ZeRO-1 shard sizes of [train-bert] and
   of each [zoo] model's step ([train-remat] has [train]'s layout).
21. [train-adasum] ViT-L/16 at 224 (ViTConfig.large(), batch 32, fp32
   master weights and bf16 compute from init_vit_params(seed=0), four
   seeded batches) through the replicated step on the one-rank NCCL world:
   (1) make_train_step(adamw(1e-4), op=Adasum) and op=Average, one step
   each from the same start: the parameters equal bit for bit (both
   reductions are the identity at one rank); (2) 3 timed Adasum steps on
   one batch: losses finite and falling, step ms, peak memory, 24 forward,
   24 dK/dV and 24 dQ flash launches a step and 0 AdamW kernel launches;
   (3) DistributedOptimizer(adamw(1e-4), op=Adasum,
   backward_passes_per_step=2) with distribute_optimizer=False over 4 steps
   on two alternating batches: after steps 1 and 3 the parameters and the
   inner AdamW state unchanged bit for bit, after step 2 the parameters
   equal one AdamW step on g1 + g2 computed on its own, bit for bit; the
   host enqueue ms of a skipping and of a syncing step; (4) Adasum's
   arithmetic: the fp32 gradients of 4 (then 3) seeded batches as virtual
   ranks through the VHDD schedule (adasum_stacked, the distributed
   path's combine) against the fp64 adasum_fold, every leaf within 1e-5
   relative L2 (the worst printed), and one combine round over the whole
   gradient timed by device_ms, with its launches (one profiler window)
   and its byte bound (a and b read, the result written, over 3.35 TB/s);
   (5) broadcast_object of a dict with a string, an int and a numpy
   array, allgather_object, broadcast_parameters of ViT-L's parameters and
   broadcast_optimizer_state of the AdamW state of (3), bit for bit, and
   the uneven allgather and alltoall(splits) at one rank.
22. [train-overlap] The JAX package's bench_overlap configuration: GPT-2
   small (fp32 masters, bf16 compute, per-block dots_saveable) at 32 x 1024
   in 4 microbatches of 8 through the replicated adamw(1e-4) step on the
   one-rank NCCL world, overlap off and then on from one start, each one
   warm-up and 12 timed steps pulled from prefetch_to_device(depth=2):
   each step's ms, the losses falling, 96 forward and 48 of each backward
   flash launch a step, record_overlap_pair's dict (ring model over the
   gradient bytes at one rank: 0 ms on the wire, efficiency null). Then 3
   steps each of ZeRO-1 fused and of the int8 wire (EF) with overlap off
   and on from one start: parameters, optimizer state and residuals bit for
   bit after every step, launch counts (one AdamW a bucket; 2 quantizes and
   2 dequantizes a bucket). The issue order the step agreed on after its
   first step (the order its buckets became whole; pack order would put
   the tied wte's bucket, whole only when the backward ends, first).
   Profiled overlap-on steps (GPT-2, and GPT-2 on the int8 wire), the last
   microbatch's backward marked by spin kernels: the backward's stream and
   the bucket work's streams, the bucket work's device ms and overlapped_ms
   (its part inside the last backward's span); a collective, quantize or
   dequantize on the backward's stream fails, and so does bucket work that
   does not start before the last backward kernel ended.
23. [train-actquant] GPT-2 small at 32 x 1024 ([train-remat]'s
   configuration, ZeRO-1 fused; per-block full beside it), ResNet-50 at
   224 batch 64 ([zoo]'s) and bench_act_quant's MLP tower (8 x 512, 2048
   rows, 10 classes, replicated adamw), act-quant off then "int8" from one
   start, 3 steps each: losses falling, peak GiB, step ms, launches a step
   (kernel 4: one a boundary; kernel 5: one a boundary and one a held
   boundary output -- GPT-2 12 and 23, ResNet-50 16 and 31, the MLP 8 and
   16), the int8 peak below the off peak for GPT-2 and ResNet-50; one
   forward and backward outside the step: the first and last boundary
   outputs bit for bit the plain boundary's, every held boundary output
   int8 payload and fp32 scales (GPT-2 11, ResNet-50 15, the MLP 8); and
   kernels 4 and 5 timed at a GPT-2 boundary (25.2 M fp32 elements) beside
   their plain versions, torch.mul and the byte bound.
24. [train-3d] The 3-D parallel GPT (parallel/transformer.py) at
   examples/jax/gpt2_3d_parallel.py's defaults -- vocab 50304, 1024
   positions, d 768, 12 heads, 12 layers, d_ff 3072, per-block remat -- in
   bf16 compute with fp32 masters from init_params(Generator seed 0), on a
   one-rank NCCL world whose mesh is dp = sp = tp = 1
   (init(mesh=..., world_axes=("dp", "sp"))), batch 8 x 1024 from
   default_rng(14): one step's gradients (loss_and_grads: the dense ring,
   the Megatron pair, the (dp, sp) Sum) against gpt3d_dense_loss, the same
   math in fp32 with plain attention, within [train]'s 5e-2 relative L2
   (the worst leaf printed); then make_parallel_train_step(cfg,
   adamw(3e-4)), 3 warm-up and 10 timed steps on that batch: step ms
   (median), tokens/s, MFU (obs/flops.py; every parameter but wpe is a
   matmul's, the tied wte the head's), peak GiB, the losses finite and
   falling, fused_allreduce's buckets a step (counted at
   fusion.reduce_bucket), and 0 flash launches (the reference's GPT runs
   the dense ring).
25. [ring-flash] The flash ring's hops at the example's long-context
   shapes (--seq-len 2048 --sp 2 --tp 2: q/k/v [8, 2048, 6, 64] bf16 per
   sp group, causal), run for 2 and 4 virtual sp ranks through
   parallel/sp.py's flash_ring -- ring_attention's own loop -- with the
   key/value blocks sliced instead of passed along the ring: out within
   1e-2 and the merged lse within 1e-3 of kernel 1 over the whole sequence
   and of its plain version (-inf rows alike); dq/dk/dv through autograd
   (kernels 2 and 3 with each hop's lse cotangent) within 1e-2 of the
   largest plain gradient, of the whole-sequence kernels and of the plain
   backward, no NaN; every hop whose key block lies wholly after its query
   block has lse -inf, out 0 and zero cotangents, and its backward with
   nonzero cotangents of both outputs is zero; launches, set to 0 just
   before, n^2 of each kernel. The ring and the whole-sequence call timed,
   forward and forward + backward, by events (time_ms) and by busy device
   time by category (ring_times: a profiler window after a warm-up window,
   its sums divided by the calls its flash launches show it saw, taken
   again if it saw under half; the ring holds more launches than
   device_ms's held stream can queue), the whole call also behind a held
   stream, which its profiled busy time a call must match within 10%.
   Then ring_attention(use_flash=True) itself on a one-rank world (mesh
   sp = 1: one hop) equal bit for bit to flash_attention_with_lse.
26. [train-guard] [train]'s configuration (GPT-2 small, fp32 masters,
   bf16 compute, 8 x 1025 tokens, ZeRO-1 fused_adamw(1e-4), one-rank
   NCCL) under make_train_step(guard=GuardConfig(max_skips=2,
   audit_every=0)), spike detection at its default warmup of 20 (these
   runs are shorter: armed after 3 steps it takes this fixed batch's
   growing gradient norm for a spike and skips one state forever; each
   step's norm and that threshold are logged), the batch carrying
   per-example loss weights of 1 (the floating leaf the grad.nan site
   poisons). With
   grad.nan:nan@step=6;n=1 armed, call 6 is skipped: the parameters, the
   moments, both counts and state.step equal step 5's bit for bit, its
   launches are 12/12/12 flash and one AdamW a bucket, each carrying
   ok = 0, and the calls after it commit with the loss falling; the same on
   the int8 wire, the EF residuals bit for bit too and 2 quantize + 2
   dequantize launches a bucket. Then a 7-step run inside
   hvt.elastic.run committing each clean step into an elastic TrainState
   (ZeRO-1 state in canonical form): two NaN attempts at step 4 make the
   next call raise HorovodInternalError, the loop restores the step-3
   commit and finishes; its last loss and parameters against a clean
   run's, bit for bit or within [train]'s bound with the reason. Last,
   guarded and unguarded steps alternated (median of 20 after 3 warm-up,
   each step between synchronizations; then blocks of 20 back to back,
   two a side), the host syncs a step (CUDA's sync debug mode), the host
   ms of the
   guard's read of the previous step's counters, the screen's device ms
   beside its byte bound, and check_gradients (with its all-reduce) by
   events.
27. [gspmd] GPT-2 small bf16 with parallel.gspmd.shard_params on a
   one-rank NCCL DeviceMesh(("tp",)): one forward and backward of 8 x
   1024 tokens through the local-heads attention (12/12/12 flash
   launches, counts set to 0 just before), the collectives CommDebugMode
   counts, logits and gradients against the dense module's (bit for bit,
   or within [train]'s bound with the reason), forward + backward timed
   beside the dense module's.
28. [decode-chaos] [decode]'s CacheLM, fp32 KV, two workers of 4 rows, 8
   streams of 64 tokens, clean and then with
   serve.decode:crash@step=20;n=1: the first worker to reach round 20
   dies, its streams requeue (n_requeued > 0, one worker left) and every
   stream's tokens equal the clean run's (a difference only at a near-tie
   the full recompute confirms).
29. [launch] ``python -m horovod_tpu_torch.runner.launch -np 1 -H
   localhost:1`` starts a worker that takes [train]'s configuration for 3
   steps in a one-rank NCCL world whose store rank 0 published through
   the launcher's rendezvous KV: rc 0, 12/12/12 + 4 launches a step, the
   losses [train]'s first three bit for bit (else [train]'s bound, the
   reason printed).
30. [elastic-recover] run_elastic in this process on a discovery script
   that prints localhost:1 (blacklist cooldown 1 s): [train-guard]'s
   configuration through hvt.elastic.run for 8 commits, checkpointed at
   3 and 6, clean and under worker.step:crash@step=5;spawn=0 (the host
   returns on probation, the respawn restores the step-3 checkpoint and
   runs to 8): both rc 0, the final parameters and optimizer state bit
   for bit (else [train]'s bound, the reason printed), [train-guard]'s
   launches a step; the time to recover, split (crash to exit seen, the
   cooldown to the new round, respawn to a formed world with its kernels
   loaded, the restore, the first step after it).
31. [serve-kv] a KVServeCoordinator on the driver's rendezvous server and
   two serving worker processes (localhost, 127.0.0.1) on the card, each
   GPT-2 small bf16 from init_params(seed=0): 64 requests of 1024 tokens,
   batch 8, clean and with serve.dispatch:crash@step=2;host=127.0.0.1;
   spawn=0: zero dropped, requests requeued in the chaos run, 12 kernel-1
   launches a batch in each worker, every answer (the greedy next-token
   id at every position) equal to this process's forward of the request
   (a difference only at a near-tie the full recompute confirms);
   requests/s and wall of both runs.
32. [obs] [train]'s configuration (GPT-2 small, fp32 masters, bf16
   compute, 8 x 1025 tokens, ZeRO-1 fused_adamw(1e-4), one-rank NCCL)
   with the metrics, trace and goodput planes off and on in alternated
   blocks of 10 steps, four a side, each step between synchronizations:
   both medians and their difference (no limit). With the planes on:
   step.count and the three step histograms count the steps taken, each
   step's host_dispatch + device is its total within 1% (its trace
   spans), step.tokens is 8192 a step, step.mfu equals throughput()'s MFU
   at the step time of step.per_sec to 1e-6 relative, rank0.jsonl's last
   counters equal the registry's, rank0.prom parses, the trace dump holds
   one step span a step with step.host_dispatch and step.device inside
   it, the ledger conserves within 1 ms and books the device brackets as
   compute or exposed_comm; 12/12/12 + 4 launches every step, on and off;
   three steps from one start bit for bit on and off (parameters, moments,
   counts). Then [serve]'s pool, 16 requests, metrics off and on: the
   request histogram counts 16, the greedy answers are the metrics-off
   pool's, 12 flash launches a batch.
33. [elastic-quant] the quant soak scenario at full width: GPT-2 small,
   ZeRO-1 fused AdamW on the int8 wire (block 256, error feedback)
   through hvt.elastic.run under run_elastic at [elastic-recover]'s
   settings, 8 commits, the TrainState saved at 3 and 6,
   worker.step:crash@step=5;spawn=0, the metrics, trace and goodput planes
   on in the driver and the workers: rc 0, the respawn's restored EF
   residuals non-zero and bit for bit those saved at step 3, the final
   parameters, moments and residuals bit for bit an uninterrupted run of
   8 steps in this process (else [train]'s bound, the reason printed), 2
   quantizes and 2 dequantizes a bucket a step, the dead incarnation's
   flight dump on disk, hvdtpu_trace merging every dump with the crash and
   the respawn's first step in it, the driver's goodput conserving with
   rescale_downtime > 0; the time to recover split as [elastic-recover]
   splits it, beside the ledger's categories.
34. [autotune] GPT-2 small (fp32 masters, bf16 compute, 8 x 1025 tokens,
   replicated unfused adamw(1e-4), one-rank NCCL) under make_train_step(
   autotune=AutotuneConfig(window 5, warmup 2, 6 trials, patience 3, seed
   0)): the local search over the fusion threshold (1-512 MiB) run to
   convergence, a line a trial (vector, buckets built, score, retraces);
   every loss finite and falling, 12/12/12 flash launches a step, each
   step's bucket count the one its threshold gives, the autotune.* gauges
   and counters the client's own; then an untuned run of as many steps
   from the same start, bit for bit (else [train]'s bound, n steps of it,
   the reason printed); the default and tuned vectors' step medians (no
   limit).
35. [serve-autotune] [serve]'s model (GPT-2 small bf16) in a ServePool of
   2 workers, batch 8, with a QueueDepthPolicy and autotune=AutotuneConfig(
   window 2, warmup 1, 4 trials): rounds of 64 1024-token requests until 3
   trials closed; every trial's vector equal to the dispatcher's fill
   window and the policy's watermarks after it flipped; 12 flash launches
   a batch; the answers those of an untuned pool bit for bit (else
   [serve]'s bound, the reason printed).
36. [stream] CacheLM at [decode]'s width as the trainer's flat dict,
   ZeRO-1 fused_adamw(1e-4) through make_train_step(publish=2) into an
   in-process RendezvousServer, the teacher-forced loss through
   CacheLM.extend over an empty cache, 8 x 128 tokens, 10 steps, chaos
   publish.delta:torn@step=4;n=1; an int8-KV DecodeEngine (2 workers of 4
   rows) attached to a StreamSubscriber decodes 8 streams meanwhile; then
   a stale-epoch manifest: no torn version served, every worker's version
   log a subsequence of the engine's, the torn set and the stale epoch
   each rejected once, the engine's parameters bit for bit the last
   published ones, 1 fused AdamW a bucket a step, 2 quantizes + 2
   dequantizes an extend, 8 streams decoded after the last flip token for
   token a fresh engine's on those parameters (a near-tie only where the
   int8-KV logits' top-2 margin is below DECODE_MARGIN); a second
   subscriber (weight_dtype="int8", apply=) re-quantizing only the changed
   buckets through kernel 4, bit for bit quantize_params on the CPU; the
   publish, apply and staleness times and the step with publish=2 against
   publish=0, alternated (no limit).
37. [profile-step] ``python -m horovod_tpu_torch.tools.profile_step``
   --model bert (32 x 512) and --model resnet50 (128 x 224 x 224 bf16, SGD
   momentum 0.9), each its own process: exit 0, the category rollup and
   the idle share and the scopes (BERT's decoder and loss, ResNet-50's
   BatchNorm, forward and backward) printed, the categories summing to
   within 1% of the device time linked to the operators that launched it,
   BERT's window 12/12/12 flash launches a step.
38. [analysis] the analysis plane (horovod_tpu_torch.analysis): [train]'s
   step (GPT-2 small ZeRO-1 fused, 8 x 1025), the same on the int8 wire
   and the fp8-compute step (replicated adamw), each recorded under fake
   tensors, linted and certified: the collective sites, the findings (no
   ERROR), the cert digest and the record's wall time, with every launch
   counter and torch.cuda.memory_allocated unchanged across the record;
   then [train]'s step run from the same start, its losses [train]'s bit
   for bit (12/12/12 + 4 launches a step); step.memplan()'s peak and
   breakdown beside the measured peak (max_memory_allocated over the
   step less memory_allocated before it) at [train-remat]'s 32 x 1024
   under per-block none, dots_saveable and full, compare_to_measured's ok
   the gate, and [train-remat]'s peaks ordered full < dots_saveable <
   none; two equal builds' digests equal, a 64 MiB threshold's
   diff_certs index; a launched world of one (localhost:1) whose first
   call's preflight over the KV passes under HVDTPU_CERT=raise with
   [train]'s digest; kernels 1, 2, 3 and 6 timed straight and through
   their hvt ops in turns (events and host us a call). The workers of
   [elastic-recover] and [elastic-quant] run with HVDTPU_CERT=off: their
   first steps are timed as before the preflight existed.
39. [eager] the dynamic-enqueue runtime (horovod_tpu_torch.native) and its
   PyTorch frontend (horovod_tpu_torch.torch) on a one-rank world of the
   card (its own gloo group and NCCL group): every allreduce op (Sum,
   Average, Min, Max, Product, Adasum) with a prescale and a postscale in
   fp32, bf16, fp16, int32 and int64 through the NCCL group, bit for bit
   against the same values computed on the host; the grouped allreduce,
   allgather, in-place broadcast, alltoall with splits, reducescatter,
   barrier and join() (the rank) on CUDA tensors; ops/eager's collectives
   on CUDA tensors; SyncBatchNorm forward and backward against
   nn.BatchNorm2d on [8, 64, 56, 56] (1e-4 of the largest value); the host
   microseconds of an allreduce_async_ + synchronize pair on a 4-byte
   tensor (median of 200) and the runtime's cycles for them.
40. [hvd-torch] GPT-2 small (148 parameter tensors, seed-0 weights) at
   [train]'s 8 x 1024 tokens, 10 steps of hvd.DistributedOptimizer(
   torch.optim.AdamW) with named_parameters and broadcast_parameters first,
   against the same 10 steps of the unwrapped AdamW: losses and final
   parameters bit for bit; the runtime's counters (148 cache misses in
   step 1, none after, 148 x 9 hits in steps 2-10; fused batches a step);
   12/12/12 flash launches a step; the wrapped and unwrapped steps timed
   in turns (median of 10 after 3 warm-up steps each); the idle share of
   one wrapped step's torch.profiler window.
41. [hvd-torch-tune] [hvd-torch]'s model, batch and frontend on a runtime
   started with HVT_AUTOTUNE=1: its ParameterManager
   (horovod_tpu_torch.native.autotune) scores windows of 10 busy cycles
   and proposes fusion thresholds and cycle times until it converges (at
   most 60 wrapped steps); the scored windows, the tuned and default
   knobs; then the wrapped step at the tuned knobs and at the defaults in
   turns (median of 10 after 3 warm-up each), its fused batches and cycles
   a step, and one profiled wrapped step at each (device ms, wall ms, idle
   share). An unwrapped AdamW takes every step beside the wrapped one:
   losses and final parameters bit for bit at both settings; 12/12/12
   flash launches a wrapped step, no fused AdamW.
   The TensorFlow and Keras frontends (horovod_tpu_torch.tensorflow,
   .keras) have no phase: the card's machine has no TensorFlow, and this
   script imports neither. Their parity tests run on the CPU.
42. [spark-estimator] the Spark workers' training path: GPT-2 small
   (seed-0 weights as a parameter dict, fp32, bf16 compute) fitted by
   horovod_tpu_torch.spark.ParamsEstimator.fit_arrays on 24 seeded rows of
   1024 token ids (labels the shifted ids) and one validation batch, 8
   rows a step, 2 epochs of 3 steps, adamw(1e-4), checkpointing into a
   FilesystemStore under _build/: every loss finite and the last below
   the first; the step losses bit for bit a hand-written loop of the same
   port calls (the estimator's batch order, functional_call,
   accumulate_gradients, the adamw update) and its parameters the last
   epoch checkpoint's; 96/72/72 flash launches (12 a step each, 12 a
   validation pass); both epoch checkpoints and the final one written;
   ParamsModel.load the best epoch's parameters and the returned model's
   bit for bit, its logits equal. Printed: the step median (the steps
   inside an epoch), the checkpoint writes, the fit and the phase's wall.
   The Ray, MXNet and pyspark parts have no phase: none of those packages
   is on the card's machine; their parity tests run on the CPU.
43. [flash-general] (after 3.) the general flash kernels
   (csrc/flash_general.cu: bf16 at head dims other than 64 and 128, fp32
   at every head dim up to 256) against their plain versions, forward
   and backward (each twice, bit for bit), on fused-QKV views: head
   dims 12-256 in bf16 and fp32, causal and not, at [2, 200 / 333, 3, d];
   at d 16, 96 and 256 kv_len < Skv, rows without keys, a ring hop's
   wholly masked block, sm_scale < 0, q/k/v all views of one fused
   output, no lse cotangent, Sq = 1 and Skv = 1. Each case's forward runs
   on the route ops/flash_attention.py's fwd_route picks and its backward
   on bwd_route's: the sm90 kernels (csrc/flash_fwd_sm90_general.cu and
   csrc/flash_bwd_sm90_general.cu: bf16 on wgmma fed by TMA, fp32 as
   3xTF32 on the tensor cores) at the sizes they take, else the general
   ones. Tolerances: bf16 the flash checks' (2., 3.); fp32 2e-5 (out, lse
   absolute; gradients of the largest plain gradient), the plain version's
   matmuls in full fp32. The fp32 kernels' (the routes' and the general
   ones called directly) and plain version's errors against an fp64
   computation at d 96, 64 and 16, the routed forward's out and lse within
   5e-6; launches by route (two forwards and two of each backward kernel
   on their routes, no wgmma launch a case). Timed, at [8, 1024, 768 / d,
   d] causal, fp32 d 64, 16, 32, 128 and bf16 d 16, 32, 48, 96, 256: the
   forward on its route (twice, around the general forward called
   directly), the pair on its route (twice, around the general pair
   called directly), their device times, the plain versions, SDPA's
   forward and backward with the backend it took, bounds (fp32 at the
   FFMA rate and as 3xTF32 on the tensor cores), and whether the sm90
   forward and pair beat the general ones in both orders. The sm90
   forward's compiler report (advisories, HGMMA and LDL/STL counts a
   kernel, registers and spills) is printed.
44. [train-fp32] (after 5.) GPT-2 small with dtype=float32 (fp32 compute,
   no TF32) from init_params(seed=0) through make_train_step(sharded=True,
   fused_update=True), fused_adamw(1e-4), on [train]'s seeded 8 x 1025
   batch: the first step's loss within 1e-5 relative and gradients within
   1e-4 relative L2 of the use_flash=False model; one warm-up and 3 steps
   with 12 launches a step of the sm90 forward and of each sm90 backward
   kernel, no general and no wgmma launch, one fused AdamW a bucket;
   losses finite and falling. Printed: the step median,
   the flash device time of a profiled step by kernel, peak memory.
45. [zoo-tiny] (after 44.) the repository's GPT2Config, BertConfig (no
   padding mask) and ViTConfig .tiny() (head dim 16) in bf16 and fp32 with
   fp32 weights under use_flash=None: a forward and backward against the
   use_flash=False twin (0.05 of the largest plain value in bf16, 1e-4 in
   fp32), n_layers launches of the sm90 forward and of each sm90 backward
   kernel and none on the plain side; the tiny GPT-2 trains 3 ZeRO-1
   fused steps with falling losses, and 3 more at head dim 256 (2 heads of
   256: the sm90 kernels in bf16, the general ones in fp32).
   Each of 43.-45. prints its wall time; the script prints its own.
46. [hvd-elastic] (after 40.) the eager runtime across an elastic round:
   run_elastic on the discovery localhost:1 (HVDTPU_BLACKLIST_COOLDOWN=1,
   every other setting the launcher's own) runs one worker that trains
   [hvd-torch]'s GPT-2 small (fp32 weights, seed 0, the seed-3 batch of 8
   x 1025 tokens) through hvd.DistributedOptimizer(torch.optim.AdamW(
   1e-4)) with broadcast_parameters and broadcast_optimizer_state, under
   hvd.elastic.run over TorchState, a commit a step, for 8 commits. The
   worker raises HorovodInternalError once, after step 4's backward and
   before its optimizer step: elastic.run restores commit 3 and resets,
   which shuts the runtime down and starts it again on the card (the next
   generation, new gloo and NCCL groups, size 1), and training goes on to
   8. Gates: the steps ran 1-3 on the first generation and 4-8 on the
   next; 148 cache misses in step 1 and again in the first step after the
   restart, none and 148 hits in every other step; 108 launches of each of
   kernels 1-3 (12 a forward/backward pass, the failed step's included),
   none of the general or sm90 kernels, no fused AdamW; the final
   parameters and AdamW state bit for bit an unwrapped AdamW of 8 steps in
   this process, else [train]'s bound with the reason printed. Printed:
   the time from the fault to the first step after it, split into the
   restore, the runtime's shutdown, the round's rejoin and the runtime's
   start; the step ms before and after the restart.
47. Output: a "kernels" JSON line (the nine TPU kernels' counterparts, the
   general route of the first three ("flash_general_*": the launches in
   [zoo-tiny]'s fp32 head-dim-256 run, each [zoo-tiny] run's as
   "launches_zoo_tiny", the fp32 times with every timed shape's under
   "timed"), the sm90 forward ("flash_fwd_sm90": [train-fp32]'s launches,
   the 3xTF32 bound beside the FFMA one, the general forward's time from
   the same run), the sm90 backward pair
   ("flash_bwd_sm90_*": [train-fp32]'s launches, the 3xTF32 bound beside
   the FFMA one, the general pair's time from the same run) and
   the cast kernel; "launches" is the training run's count -- for the
   quantize pair the int8 [train-quant] run's (beside it the
   [ckpt-reshard] and int8 [decode] runs' and the KV shapes' times as
   "kv_write" / "kv_gather"), for kernel 8 and the cast kernel the fp8
   [train-fp8] run's, for kernel 7 the [serve-int8] rounds' -- the forward
   kernel's serving count beside it as "launches_serve", and the flash
   kernels', AdamW's and (from 22.) the quantize pair's counts in 18.-42.
   and 46., each read over its own run, as "launches_phases" (29.-31., 33.
   and 46. counted in the worker processes); the flash rows' ring
   times at n = 2, 4 and the whole sequence as "ring_flash_*"; the quantize pair's
   times at an act-quant boundary as "boundary"; kernels 1, 2, 3 and 6's
   straight and hvt-op times as "wrap"), the card's name and power limit,
   and the last line
   {"ok": true, "device": {...}}.

A crash in native code prints every thread's Python stack to stderr
(faulthandler). After the serving and decode phases and at the end, the
Python threads still alive are listed ("[threads]"); a passed run leaves
through os._exit(0) once its output is flushed, without the interpreter's
teardown of the CUDA, NCCL and profiler libraries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import functools
import hashlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (at its full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # dense tf32 tensor cores
OUT_TOL, LSE_TOL = 1e-2, 1e-3
GRAD_TOL = 1e-2  # flash backward, relative to the largest plain gradient
ADAM_TOL = 1e-6  # fused AdamW, relative to the largest plain value
ADAM_OPS = 30  # fp32 operations per element of the AdamW update
STEP_GRAD_TOL, FLIP_TOL = 5e-2, 0.02  # kernel vs plain train step
TRAIN_LR, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 1e-4, 8, 3, 20
SERVE_ROUNDS = 5
QUANT_BLOCK = 256  # the default HVDTPU_QUANT_BLOCK
QUANT_OPS = 7  # fp32 operations an element: abs, max, divide, round, clip, cast
QUANT_LOSS_TOL = 0.05  # int8 last loss vs none's, relative
ZERO1_QUANT_STEPS, FP8_QUANT_STEPS = 10, 3
FP8_FLOPS_PER_S = 1979e12  # dense fp8 tensor cores
# Kernel 8 vs its plain version, relative to the largest plain value: exact
# products and fp32 sums in another order; bf16 adds one rounding.
FP8_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
FP8_BATCH, FP8_STEPS, FP8_LR, FP8_LOSS_RTOL = 16, 12, 1e-3, 0.15
# Kernel 7 vs its plain version, relative to the largest plain value: exact
# products, fp32 sums in another order; bf16 adds one rounding.
INT8_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
SERVE_REQUESTS, SERVE_BATCH = 64, 8
# The decode path's KV shapes for kernels 4 and 5 at block = head_dim: one
# round's k (or v) write, [layers, rows, heads, head_dim], and its gather,
# [layers, rows, 65 blocks x 16 slots, heads, head_dim].
KV_WRITE_SHAPE = (12, 8, 12, 64)
KV_GATHER_SHAPE = (12, 8, 1040, 12, 64)
# [ckpt-reshard]: a fusion threshold that packs GPT-2 small's fp32 tree in
# more buckets than the default 128 MiB, and the JAX package's tolerance for
# a trajectory continued under another layout.
CKPT_THRESHOLD = 64 * 2**20
CKPT_RTOL, CKPT_ATOL = 2e-5, 1e-6
# [decode]: CacheLM at GPT-2-small width, bench_decode's closed loop.
DECODE_CFG = dict(vocab=50257, n_layers=12, n_heads=12, head_dim=64,
                  max_positions=1024)
DECODE_ROWS, DECODE_BLOCK, DECODE_MAX_SEQ = 8, 16, 1024
# Enough blocks for every row at full length with the widest (spec_k 3)
# round; the draft's pool is a second pool of the same size.
DECODE_KV_BLOCKS = DECODE_ROWS * -(-(DECODE_MAX_SEQ + 4) // DECODE_BLOCK)
DECODE_STREAMS, DECODE_NEW, DECODE_PROMPT = 32, 64, (64, 512)
# A greedy token may leave its reference only at a near-tie: a top-2 logit
# margin below this share of max |logit|.
DECODE_MARGIN = 1e-4
KV_LOGIT_TOL = 0.05  # int8 vs fp32 KV logits, of max |logit|
# [train-bert]: bench_bert's shape, MLM weights on ~15% of the positions.
BERT_BATCH, BERT_MLM_SHARE, BERT_WARMUP, BERT_STEPS = 32, 0.15, 3, 10
# The chunked loss against full fp32 logits on the same hidden states: the
# same fp32 products summed in another order, so the losses within 1e-5;
# the gradients then pass the bf16 backward, which carries a last-bit
# difference of the decoder's products down to the embeddings, and are held
# to [train]'s bound (the same gradient computed twice is printed beside).
BERT_SAME_TOL, BERT_SAME_GRAD_TOL = 1e-5, 5e-2
# The kernel path (flash, chunked loss) against the plain path (plain
# attention, full logits): bf16 attention outputs rounded at other points.
BERT_LOSS_RTOL = 2e-3
# [train-remat]: the JAX bench's GPT-2 default batch; the chunked loss
# (fp32 products of the bf16 values) against the tied head's bf16 logits.
REMAT_BATCH, REMAT_STEPS, GPT2_CHUNK_RTOL = 32, 3, 1e-3
# [zoo]: 3 ZeRO-1 steps each; one bf16 forward against the fp32 model with
# plain attention within relative L2 ZOO_TOL (bf16 rounding through up to
# 24 layers). For the MoE a near-tie of the gate flips a token's expert
# (and may push another past its expert's capacity), so its logits are held
# on the tokens routed alike in every MoE layer, at least MOE_ROUTE_AGREE of
# them, within MOE_TOL: the flipped tokens still reach them through causal
# attention.
ZOO_STEPS, ZOO_LR, ZOO_TOL, MOE_ROUTE_AGREE, MOE_TOL = 3, 1e-4, 5e-2, 0.9, 0.1
VIT_BATCH, RESNET_BATCH, MOE_BATCH, RESNET_IMAGE = 32, 64, 8, 224
# [train-adasum]: 3 timed steps; the fp32 VHDD against the fp64 fold,
# relative L2 per leaf (fp32 products and row sums against fp64 sums).
ADASUM_STEPS, ADASUM_LR, ADASUM_TOL = 3, 1e-4, 1e-5
# [train-overlap]: bench_overlap's GPT-2 (32 x 1024 in 4 microbatches of 8,
# per-block dots_saveable, replicated adamw) 1 warm-up + 12 timed steps each
# side; 3 steps of each bit-for-bit pair; the spin kernels that mark the
# last microbatch's backward in a profile.
OVERLAP_ACCUM, OVERLAP_STEPS, OVERLAP_BIT_STEPS = 4, 12, 3
MARK_CYCLES = 1000
# [train-actquant]: 3 steps a side; bench_act_quant's MLP tower (width,
# depth, rows, classes).
ACTQ_STEPS, ACTQ_LR, ACTQ_MLP = 3, 1e-4, (512, 8, 2048, 10)
# [train-guard]: [train]'s configuration under make_train_step(guard=...):
# the guard's knobs; step 6 poisoned (grad.nan) among 10; a NaN storm at
# step 4 (two attempts) in a 7-step elastic run; 20 timed steps a side
# after 3 warm-up, guarded and unguarded alternated. Spike detection keeps
# its default warmup (20 committed steps), so these runs screen NaN only:
# on this fixed batch the gradient norm grows from ~1.2 to ~2.2 in six
# steps, and armed after 3 steps the detector (mean + 6 max(std, 0.1 mean)
# over an EW baseline that skipped steps never feed) takes that growth for
# a spike and skips the same state forever (the skip run logs each step's
# norm against that threshold).
GUARD_CFG = dict(max_skips=2, audit_every=0)
GUARD_EARLY_WARMUP = 3
GUARD_STEPS, GUARD_NAN_AT = 10, 6
GUARD_STORM_AT, GUARD_RUN_STEPS = 4, 7
GUARD_WARMUP, GUARD_TIMED = 3, 20
# [gspmd]: GPT-2 small, bf16, one forward and backward at [train]'s shape.
# [decode-chaos]: [decode]'s model, 8 streams of 64 tokens over two workers
# of 4 rows; the first worker to reach this round is killed.
DECODE_CHAOS_STREAMS, DECODE_CHAOS_ROUND = 8, 20
# [autotune]: the local search over GPT-2 small's fusion threshold (its
# window, warmup, budget, patience and seed), a ceiling on its steps, and
# the steps timed on the tuned vector after it.
AUTOTUNE_CFG = dict(window_steps=5, warmup_steps=2, max_trials=6, patience=3,
                    seed=0)
AUTOTUNE_MAX_STEPS, AUTOTUNE_TIMED = 120, 5
# [serve-autotune]: ServeLatencyScorer closes a trial on 8 x window_steps
# responses after 8 x warmup_steps; rounds of SERVE_REQUESTS until this
# many trials closed.
AUTOTUNE_SERVE_CFG = dict(window_steps=2, warmup_steps=1, max_trials=4,
                          patience=4, seed=0)
AUTOTUNE_SERVE_MIN_TRIALS, AUTOTUNE_SERVE_MAX_ROUNDS = 3, 8
# [stream]: the trainer (CacheLM at DECODE_CFG, batch x seq tokens, its
# learning rate, publish cadence, steps), the torn publish, the engine's
# rows a worker and the streams decoded after the last flip, and the steps
# timed with and without publishing, alternated.
STREAM_BATCH, STREAM_SEQ, STREAM_LR, STREAM_EVERY, STREAM_STEPS = (
    8, 128, 1e-4, 2, 10)
STREAM_TORN_STEP = 4
STREAM_CHAOS = f"publish.delta:torn@step={STREAM_TORN_STEP};n=1"
STREAM_ROWS, STREAM_STREAMS, STREAM_TIMED = 4, 8, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def log_threads(after: str) -> None:
    """The Python threads other than this one still alive after a phase
    (a serving pool's or decode engine's threads should all be gone)."""
    names = sorted(t.name for t in threading.enumerate()
                   if t is not threading.current_thread())
    log(f"[threads] after {after}: {names or 'none'}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def source_fingerprint() -> str:
    """sha256 over this script and every .py/.cu/.cuh file of the port (by
    relative path, build outputs left out): the same on any checkout of
    one commit."""
    root = Path(__file__).resolve().parent
    files = [root / "chip_smoke.py"] + sorted(
        f for pat in ("*.py", "*.cu", "*.cuh")
        for f in (root / "horovod_tpu_torch").rglob(pat)
        if "_build" not in f.parts and "__pycache__" not in f.parts
    )
    h = hashlib.sha256()
    for f in files:
        h.update(f.relative_to(root).as_posix().encode() + b"\0")
        h.update(f.read_bytes() + b"\0")
    return h.hexdigest()


def time_ms(fn, samples: int = 25, per_sample: int = 10,
            warmup: int = 3) -> float:
    """Median over ``samples`` of the mean time of ``per_sample``
    back-to-back calls between two CUDA events: the launch queue stays
    ahead of the device, so the wrapper's host time is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_sample):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_sample)
    return float(np.median(times))


def valid_pairs(sq, kv_len, causal, q_offset, kv_offset) -> int:
    """(query, key) pairs the mask keeps for one (batch, head)."""
    if not causal:
        return sq * kv_len
    q_pos = q_offset + np.arange(sq)
    return int(np.clip(q_pos - kv_offset + 1, 0, kv_len).sum())


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return, enqueue only:
    no synchronisation inside the window (the launch queue absorbs the
    kernels), one before it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def attention_work(es, b, sq, skv, h, d, causal, q_offset=0, kv_offset=0,
                   kv_len=None):
    """(bytes, flops) of the flash forward (``"fwd"``), the backward pair
    (``"pair"``) and each backward kernel (``"dkdv"``, ``"dq"``), as the
    kernels line counts them: each input read once, each output written
    once (``es`` bytes an element of q, k, v, out, dO and the gradients;
    lse, delta and g_lse fp32), the products over the valid (query, key)
    pairs. The pair reads q, out, dO, k, v, lse, g_lse, writes dq, dk, dv
    (delta is its own, from out and dO) and needs five products (S, dP,
    dV, dK, dQ); each backward kernel reads q, k, v, dO, lse, delta,
    g_lse, writes its gradients and needs S, dP and its own products."""
    kvl = skv if kv_len is None else kv_len
    pairs = valid_pairs(sq, kvl, causal, q_offset, kv_offset)
    n_q, n_kv, n_row = b * sq * h * d, b * skv * h * d, b * h * sq
    product = 2 * d * b * h * pairs  # one QK^T-sized product
    return {
        "fwd": (es * (2 * n_q + 2 * n_kv) + 4 * n_row, 2 * product),
        "pair": (es * (4 * n_q + 4 * n_kv) + 4 * 2 * n_row, 5 * product),
        "dkdv": (es * (2 * n_q + 4 * n_kv) + 4 * 3 * n_row, 4 * product),
        "dq": (es * (3 * n_q + 2 * n_kv) + 4 * 3 * n_row, 3 * product),
    }


def bound(nbytes, flops, dt=torch.bfloat16):
    """The least time for ``nbytes`` and ``flops`` at the card's peaks:
    the larger of bytes over the memory rate and operations over the
    peak rate of ``dt`` (fp32 outside the tensor cores, else bf16)."""
    peak = FP32_FLOPS_PER_S if dt == torch.float32 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tf32_bound(nbytes, flops):
    """The least time for an fp32 function whose products run on the
    tensor cores as 3xTF32 (three tf32 products a product): the larger of
    bytes over the memory rate and 3 x ``flops`` over the tf32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS_PER_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_case(fa, gen, *, b, sq, skv, h, d, causal, q_offset=0,
               kv_offset=0, kv_len=None, timed=False):
    """Kernel vs plain version on one shape, q/k/v as the model hands them
    (column views of a fused projection); a second call must equal the
    first bit for bit. Returns the case's record."""
    q, k, v = qkv_views(gen, b, sq, skv, h, d)
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              layout="bsm", n_heads=h, kv_len=kv_len)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    again = fa.flash_attention_with_lse(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    if out.shape != ref_out.shape or lse.shape != ref_lse.shape:
        raise AssertionError(f"kernel shapes {out.shape} {lse.shape} vs plain "
                             f"{ref_out.shape} {ref_lse.shape}")
    err_out = (out.float() - ref_out.float()).abs().max().item()
    inf_k, inf_r = torch.isneginf(lse), torch.isneginf(ref_lse)
    if not torch.equal(inf_k, inf_r):
        raise AssertionError("kernel and plain version disagree on -inf rows")
    fin = ~inf_r
    err_lse = (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
    bitwise = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    empty_rows = int(inf_r.sum().item())
    name = (f"B={b} Sq={sq} Skv={skv} H={h} D={d} causal={causal} "
            f"q_offset={q_offset} kv_offset={kv_offset} kv_len={kv_len}")
    log(f"[kernel] {name}: max|d out|={err_out:.3e} max|d lse|={err_lse:.3e}"
        f"; rows without keys {empty_rows}; bitwise again {bitwise}")
    if not (err_out <= OUT_TOL and err_lse <= LSE_TOL):
        raise AssertionError(
            f"flash kernel disagrees with its plain version on {name}: "
            f"out {err_out} (tol {OUT_TOL}), lse {err_lse} (tol {LSE_TOL})"
        )
    if not bitwise:
        raise AssertionError(f"two calls of the flash forward on {name} "
                             f"gave different results")
    rec = {"err_out": err_out, "err_lse": err_lse, "bitwise": bitwise}
    if timed:
        call = lambda: fa.flash_attention_with_lse(q, k, v, **kw)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_ms(call)
        rec["host_us"] = host_us(call)
        rec["plain_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, **kw)
        )
        qh, kh, vh = (x.unflatten(-1, (h, d)).transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=causal
        )
        rec["library_ms"] = time_ms(sdpa)
        # Every kernel of its call, summed by name: torch's vendored flash
        # kernels share names with this repository's.
        rec["library_device_ms"] = device_ms(sdpa)
        nbytes, flops = attention_work(2, b, sq, skv, h, d, causal, q_offset,
                                       kv_offset, kv_len)["fwd"]
        rec.update(bound(nbytes, flops))
        tflops = lambda ms: flops / ms / 1e9  # noqa: E731
        log(f"[kernel] B={b}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP: "
            f"kernel {rec['ms']:.4f} ms by events ({tflops(rec['ms']):.1f} "
            f"TFLOP/s), {rec['device_ms']:.4f} ms device "
            f"({tflops(rec['device_ms']):.1f} TFLOP/s), wrapper "
            f"{rec['host_us']:.1f} us host a call; plain {rec['plain_ms']:.4f}"
            f" ms; sdpa {rec['library_ms']:.4f} ms by events "
            f"({tflops(rec['library_ms']):.1f} TFLOP/s), "
            f"{rec['library_device_ms']:.4f} ms device "
            f"({tflops(rec['library_device_ms']):.1f} TFLOP/s) (kernel / sdpa:"
            f" {rec['ms'] / rec['library_ms']:.2f}x by events, "
            f"{rec['device_ms'] / rec['library_device_ms']:.2f}x device); "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def qkv_views(gen, b, sq, skv, h, d, dtype=torch.bfloat16):
    """q, k, v as the model hands them to the kernels: column views of one
    fused projection (of q and a fused key/value one when Sq != Skv)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if sq == skv:
        return rand(b, sq, 3 * h * d).split(h * d, dim=-1)
    k, v = rand(b, skv, 2 * h * d).split(h * d, dim=-1)
    return rand(b, sq, h * d), k, v


def bwd_case(fa, gen, *, b, sq, skv, h, d, causal, q_offset=0, kv_offset=0,
             kv_len=None, g_dtype=torch.bfloat16, timed=False):
    """The backward kernel pair vs its plain version on one shape, from the
    kernel forward's out and lse and two nonzero cotangents (the cotangent
    of out in ``g_dtype``: an fp32 one is rounded for the products only);
    a second call must give the same gradients bit for bit."""
    q, k, v = qkv_views(gen, b, sq, skv, h, d)
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              layout="bsm", n_heads=h, kv_len=kv_len)
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g_out = torch.randn((b, sq, h * d), generator=gen,
                        device="cuda").to(g_dtype)
    g_lse = torch.randn((b, h, sq), generator=gen, device="cuda")
    args = (q, k, v, out, lse, g_out, g_lse)
    got = fa.flash_attention_bwd(*args, **kw)
    ref = fa.flash_attention_bwd_reference(*args, **kw)
    again = fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    errs, rels = [], []
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"gradient {g.shape} {g.dtype} vs plain "
                                 f"{r.shape} {r.dtype}")
        err = (g.float() - r.float()).abs().max().item()
        scale = max(r.float().abs().max().item(), 1e-6)
        errs.append(err)
        rels.append(err / scale)
    bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
    name = (f"B={b} Sq={sq} Skv={skv} H={h} D={d} causal={causal} "
            f"q_offset={q_offset} kv_offset={kv_offset} kv_len={kv_len} "
            f"g_out {str(g_dtype).replace('torch.', '')}")
    log(f"[bwd] {name}: max|d dq|={errs[0]:.3e} max|d dk|={errs[1]:.3e} "
        f"max|d dv|={errs[2]:.3e}; relative {max(rels):.3e}; "
        f"bitwise again {bitwise}")
    if max(rels) > GRAD_TOL:
        raise AssertionError(
            f"flash backward kernels disagree with their plain version on "
            f"{name}: relative {rels} (tol {GRAD_TOL})"
        )
    if not bitwise:
        raise AssertionError(f"two calls of the backward pair on {name} "
                             f"gave different gradients")
    rec = {"err": max(errs), "rel_err": max(rels), "bitwise": bitwise}
    if timed:
        call = lambda: fa.flash_attention_bwd(*args, **kw)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["kernel_ms"] = kernel_ms(call, 10)
        rec["plain_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_reference(*args, **kw)
        )
        qh, kh, vh = (x.unflatten(-1, (h, d)).transpose(1, 2).contiguous()
                      .requires_grad_(True) for x in (q, k, v))
        oh = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal
        )
        goh = g_out.unflatten(-1, (h, d)).transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(oh, (qh, kh, vh), goh,
                                       retain_graph=True)

        rec["library_ms"] = time_ms(sdpa_bwd)
        # Every kernel the call launches is the backward's (the graph is
        # kept, so no forward runs), summed by name: torch's vendored
        # flash kernels share names with this repository's.
        rec["library_device_ms"] = device_ms(sdpa_bwd)
        work = attention_work(2, b, sq, skv, h, d, causal, q_offset,
                              kv_offset, kv_len)
        product = work["pair"][1] // 5  # one QK^T-sized product
        for name, key in (("pair", "pair"), ("flash_bwd_dkdv", "dkdv"),
                          ("flash_bwd_dq", "dq")):
            rec[name] = bound(*work[key])
        pair = rec["pair"]
        pair_dev = sum(rec["kernel_ms"][n]
                       for n in ("flash_bwd_dkdv", "flash_bwd_dq"))
        tflops = lambda flops, ms: flops / ms / 1e9  # noqa: E731
        log(f"[bwd] B={b}: {pair['bytes'] / 1e6:.1f} MB, "
            f"{pair['flops'] / 1e9:.2f} GFLOP (5 products): kernel pair "
            f"{rec['ms']:.4f} ms by events ({tflops(pair['flops'], rec['ms']):.1f}"
            f" TFLOP/s), {pair_dev:.4f} ms device "
            f"({tflops(pair['flops'], pair_dev):.1f} TFLOP/s); plain "
            f"{rec['plain_ms']:.4f} ms; sdpa backward {rec['library_ms']:.4f}"
            f" ms by events, {rec['library_device_ms']:.4f} ms device "
            f"(pair / sdpa: {rec['ms'] / rec['library_ms']:.2f}x by events, "
            f"{pair_dev / rec['library_device_ms']:.2f}x device); bound "
            f"{pair['bound_ms']:.4f} ms ({pair['bound_by']})")
        for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
            ms = rec["kernel_ms"][name]
            log(f"[bwd] B={b} {name}: {ms:.4f} ms a launch (device), "
                f"{tflops(rec[name]['flops'], ms):.1f} TFLOP/s "
                f"({rec[name]['flops'] // product} products), bound "
                f"{rec[name]['bound_ms']:.4f} ms ({rec[name]['bound_by']})")
    return rec


def trainer_bucket_sizes(hvt, cfg):
    """Elements per fused bucket of the trainer's parameter dict (world 1,
    default fusion threshold), from shapes alone (a meta-device model)."""
    from horovod_tpu_torch.ops.fusion import bucket_byte_layout

    params = dict(hvt.GPT2LMModel(cfg, device="meta").named_parameters())
    return [nbytes // 4 for dt, nbytes in bucket_byte_layout(params)
            if dt == "float32"]


def adamw_buffers(gen, sizes):
    """(p, m, v, g) of each bucket size, as an AdamW step meets them."""
    def rand(n, s):
        return torch.randn((n,), generator=gen, device="cuda") * s

    return [(rand(n, 1.0), rand(n, 0.01), rand(n, 0.03).abs() ** 2,
             rand(n, 0.1)) for n in sizes]


def adamw_compare(fadam, bufs, spec, count, tag):
    """The fused AdamW kernel vs its plain version on every bucket of
    ``bufs``; raises past ADAM_TOL. Returns (max|d|, relative, bitwise)."""
    err, rel, bitwise = 0.0, 0.0, True
    for p, m, v, g in bufs:
        mk, vk = m.clone(), v.clone()
        u = fadam.fused_adamw_update(p, mk, vk, g, count, spec)
        ref = fadam.fused_adamw_update_reference(p, m, v, g, count, spec)
        for a, r in zip((u, mk, vk), ref):
            d = (a - r).abs().max().item()
            err = max(err, d)
            rel = max(rel, d / max(r.abs().max().item(), 1e-30))
            bitwise = bitwise and torch.equal(a, r)
    sizes = [p.numel() for p, _, _, _ in bufs]
    log(f"[adamw] {tag}: buckets {sizes} ({sum(sizes)} elements): max|d| "
        f"{err:.3e}, relative {rel:.3e}, bit for bit {bitwise}")
    if rel > ADAM_TOL:
        raise AssertionError(
            f"fused AdamW kernel disagrees with its plain version on {tag}: "
            f"{rel} (tol {ADAM_TOL})"
        )
    return err, rel, bitwise


def adamw_phase_checks(fadam, gen, phases):
    """The kernel vs its plain version at each new phase's own bucket
    layout (``phases``: name -> the ZeRO-1 step's shard sizes)."""
    spec = fadam.FusedAdamSpec(TRAIN_LR)
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    out = {}
    for tag, sizes in phases.items():
        bufs = adamw_buffers(gen, sizes)
        err, rel, bitwise = adamw_compare(fadam, bufs, spec, count, tag)
        out[tag] = {"buckets": len(sizes), "elements": sum(sizes),
                    "max_abs_err": err, "max_rel_err": rel,
                    "bitwise": bitwise}
        del bufs
        torch.cuda.empty_cache()
    return out


def adamw_case(fadam, gen, sizes):
    """The fused AdamW kernel vs its plain version on every bucket of the
    [train] step, then timed beside the plain version and the library."""
    spec = fadam.FusedAdamSpec(TRAIN_LR)
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    bufs = adamw_buffers(gen, sizes)
    err, rel, bitwise = adamw_compare(fadam, bufs, spec, count, "train")
    n = sum(sizes)
    rec = {"err": err, "rel_err": rel, "bitwise": bitwise,
           "buckets": list(sizes)}
    rec["ms"] = time_ms(lambda: [
        fadam.fused_adamw_update(p, m, v, g, count, spec)
        for p, m, v, g in bufs
    ])
    rec["plain_ms"] = time_ms(lambda: [
        fadam.fused_adamw_update_reference(p, m, v, g, count, spec)
        for p, m, v, g in bufs
    ], samples=9, per_sample=3)
    for p, _, _, g in bufs:
        p.grad = g
    lib = torch.optim.AdamW([p for p, _, _, _ in bufs], lr=spec.learning_rate,
                            betas=(spec.b1, spec.b2), eps=spec.eps,
                            weight_decay=spec.weight_decay, fused=True)
    rec["library_ms"] = time_ms(lib.step)
    nbytes, flops = 28 * n, ADAM_OPS * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[adamw] {nbytes / 1e9:.3f} GB: kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, torch.optim.AdamW(fused=True) "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']})")
    rec["skip_flag"] = adamw_skip_flag(fadam, bufs, spec, count)
    return rec


def adamw_skip_flag(fadam, bufs, spec, count):
    """Kernel 6's skip flag (the gradient guard's) at the [train] buckets:
    with ok = 0 every update element is -0.0 and the moments stay bit for
    bit, in place, and the plain version with the flag agrees bit for bit;
    with ok = 1 the call is bit for bit the flagless one. Both timed beside
    the flagless call."""
    flags = {v: torch.tensor(v, dtype=torch.int32, device="cuda")
             for v in (0, 1)}
    noop, same = True, True
    for p, m, v, g in bufs:
        mk, vk = m.clone(), v.clone()
        u = fadam.fused_adamw_update(p, mk, vk, g, count, spec, flags[0])
        ref = fadam.fused_adamw_update_reference(p, m, v, g, count, spec,
                                                 flags[0])
        noop = (noop and torch.equal(mk, m) and torch.equal(vk, v)
                and bool((u == 0).all()) and bool(torch.signbit(u).all())
                and all(torch.equal(a, r) for a, r in zip((u, mk, vk), ref)))
        mk, vk, mf, vf = m.clone(), v.clone(), m.clone(), v.clone()
        u1 = fadam.fused_adamw_update(p, mk, vk, g, count, spec, flags[1])
        uf = fadam.fused_adamw_update(p, mf, vf, g, count, spec)
        same = (same and torch.equal(u1, uf) and torch.equal(mk, mf)
                and torch.equal(vk, vf))
    times = {f"ms_ok{k}": time_ms(lambda k=k: [
        fadam.fused_adamw_update(p, m, v, g, count, spec, flags[k])
        for p, m, v, g in bufs]) for k in (0, 1)}
    times["ms_flagless"] = time_ms(lambda: [
        fadam.fused_adamw_update(p, m, v, g, count, spec)
        for p, m, v, g in bufs])
    log(f"[adamw] skip flag over {len(bufs)} buckets: ok=0 a no-op bit for "
        f"bit (-0.0 updates, moments kept) {noop}; ok=1 bit for bit the "
        f"flagless call {same}; " + ", ".join(
            f"{k} {t:.4f}" for k, t in times.items()))
    if not (noop and same):
        raise AssertionError("[adamw] the skip flag changed what it must not")
    return {"ok0_noop_bitwise": noop, "ok1_bitwise_flagless": same, **times}


def quant_bucket_sizes(hvt, cfg):
    """Elements per bucket of the quantized trainer (world 1, default
    fusion threshold, padded to the block), from shapes alone."""
    from horovod_tpu_torch.ops.fusion import quantized_bucket_layout

    params = dict(hvt.GPT2LMModel(cfg, device="meta").named_parameters())
    comp = hvt.Compression.int8.with_block(QUANT_BLOCK)
    return [b["elements"] for b in quantized_bucket_layout(
        params, world=1, compression=comp)]


def quant_compare(tq, x, block, spec):
    """The quantize and dequantize kernels vs their plain versions on one
    buffer: bit for bit, NaN elements aside (see the docstring). Returns
    the largest difference seen (0.0 when bit for bit)."""
    q, s = tq.quantize_blockwise(x, block, spec)
    rq, rs = tq.quantize_blockwise_reference(x, block, spec)
    d = tq.dequantize_blockwise(q, s, block)
    rd = tq.dequantize_blockwise_reference(q, s, block)
    torch.cuda.synchronize()
    qb, rqb = q.view(torch.uint8), rq.view(torch.uint8)
    keep = ~torch.isnan(x)
    if not spec.integer:
        keep = torch.ones_like(keep)
        keep &= ~(((qb & 0x7F) == 0x7F) & ((rqb & 0x7F) == 0x7F))
    fin = ~torch.isnan(rd)
    same = (q.shape == rq.shape and q.dtype == rq.dtype
            and torch.equal(s.view(torch.int32), rs.view(torch.int32))
            and torch.equal(qb[keep], rqb[keep])
            and torch.equal(torch.isnan(d), ~fin)
            and torch.equal(d[fin].view(torch.int32), rd[fin].view(torch.int32)))
    err_q = (q.float()[keep] - rq.float()[keep]).abs().max().item() if (
        keep.any()) else 0.0
    err = max(err_q, (s - rs).abs().max().item(),
              (d[fin] - rd[fin]).abs().max().item() if fin.any() else 0.0)
    if not same:
        raise AssertionError(
            f"quantize/dequantize kernels differ from their plain versions "
            f"({spec.name}, n={x.numel()}, block={block}): max |d| {err}"
        )
    return err


def quant_case(tq, gen, sizes):
    """Kernels 4 and 5 vs their plain versions at the trainer's buckets and
    on the ragged cases, then timed at the buckets."""
    def rand(n, offset=0):
        return (torch.randn((n + offset,), generator=gen, device="cuda")
                * 1e-3)[offset:]

    bufs = [rand(n) for n in sizes]
    special = rand(1_000_000)
    special[QUANT_BLOCK:2 * QUANT_BLOCK] = 0.0  # an all-zero block
    special[3 * QUANT_BLOCK + 17] = float("nan")  # a block holding a NaN
    ragged = [("n=1000", rand(1000), QUANT_BLOCK),
              ("block=8", rand(1_000_003), 8),
              ("block=16", rand(1_000_003), 16),
              ("block=65536", rand(1_000_003), 65536),
              ("unaligned", rand(1_000_001, offset=1), QUANT_BLOCK),
              ("zero+NaN blocks", special, QUANT_BLOCK)]
    err = 0.0
    for spec in (tq.INT8, tq.FP8):
        for b in bufs:
            err = max(err, quant_compare(tq, b, QUANT_BLOCK, spec))
        for name, x, block in ragged:
            err = max(err, quant_compare(tq, x, block, spec))
        _, s = tq.quantize_blockwise(special, QUANT_BLOCK, spec)
        if s[1].item() != 1.0 or s[3].item() != 1.0:
            raise AssertionError("an all-zero or NaN block's scale is not 1")
    n = sum(sizes)
    log(f"[quant] buckets {sizes} ({n} elements) and {len(ragged)} ragged "
        f"cases, int8 and fp8: kernels equal their plain versions bit for "
        f"bit (max |d| {err})")
    rec = {"buckets": list(sizes), "max_abs_err": err, "bitwise": True}
    for spec in (tq.INT8, tq.FP8):
        wires = [tq.quantize_blockwise(b, QUANT_BLOCK, spec) for b in bufs]
        key = "" if spec.integer else "_fp8"
        rec["quant_ms" + key] = time_ms(lambda: [
            tq.quantize_blockwise(b, QUANT_BLOCK, spec) for b in bufs])
        rec["dequant_ms" + key] = time_ms(lambda: [
            tq.dequantize_blockwise(q, sc, QUANT_BLOCK) for q, sc in wires])
        rec["quant_plain_ms" + key] = time_ms(lambda: [
            tq.quantize_blockwise_reference(b, QUANT_BLOCK, spec)
            for b in bufs], samples=9, per_sample=3)
        rec["dequant_plain_ms" + key] = time_ms(lambda: [
            tq.dequantize_blockwise_reference(q, sc, QUANT_BLOCK)
            for q, sc in wires], samples=9, per_sample=3)
        if spec.integer:
            # int8 x fp32 promotes to fp32 in one call: the same function.
            rows = [(q.view(-1, QUANT_BLOCK), sc[:, None]) for q, sc in wires]
            rec["dequant_library_ms"] = time_ms(lambda: [
                torch.mul(q, sc) for q, sc in rows])
        del wires
    n_blocks = sum(-(-m // QUANT_BLOCK) for m in sizes)
    nbytes = 5 * n + 4 * n_blocks  # fp32 in, one-byte payload + scales out
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = QUANT_OPS * n / FP32_FLOPS_PER_S
    rec["bytes"] = nbytes
    rec["bound_ms"] = max(t_bytes, t_ops) * 1e3  # the same for both passes
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[quant] {nbytes / 1e6:.1f} MB a pass: int8 quantize "
        f"{rec['quant_ms']:.4f} ms (plain {rec['quant_plain_ms']:.4f}), "
        f"dequantize {rec['dequant_ms']:.4f} ms (plain "
        f"{rec['dequant_plain_ms']:.4f}, torch.mul "
        f"{rec['dequant_library_ms']:.4f}); fp8 quantize "
        f"{rec['quant_ms_fp8']:.4f} ms, dequantize {rec['dequant_ms_fp8']:.4f} "
        f"ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    del bufs, special, ragged
    torch.cuda.empty_cache()
    return rec


def plain_attention(fa):
    def attn(q, k, v, *, causal, mask=None):
        return fa.flash_attention_reference(q, k, v, causal=causal)[0]

    return attn


def kernel_category(name: str) -> str:
    n = name.lower()
    # dequantize_blockwise before quantize_blockwise: the one name holds
    # the other.
    for kernel in ("flash_general_fwd", "flash_general_dkdv",
                   "flash_general_dq", "flash_bwd_sm90_dkdv",
                   "flash_bwd_sm90_dq", "flash_fwd_sm90", "flash_fwd",
                   "flash_bwd_dkdv",
                   "flash_bwd_dq",
                   "fused_adamw", "dequantize_blockwise",
                   "quantize_blockwise", "fp8_matmul_reduce", "fp8_matmul",
                   "fp8_cast", "int8_matmul_reduce", "int8_matmul"):
        if kernel + "_kernel" in n:
            return kernel
    if "nccl" in n:
        return "nccl"
    if "elementwise" in n:
        return "elementwise"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def device_ms_by_name(prof, counts=None):
    """Device ms by kernel name, and by kernel category, from a finished
    torch.profiler window; with a dict ``counts``, the recorded launches by
    category are added to it."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.key_averages():
        # A scheduled window's step range ("ProfilerStep*") is annotated on
        # the device too, spanning the whole step: it is no kernel.
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
        if counts is not None:
            c = kernel_category(e.key)
            counts[c] = counts.get(c, 0) + e.count
    by_cat = {}
    for name, ms in by_name.items():
        c = kernel_category(name)
        by_cat[c] = by_cat.get(c, 0.0) + ms
    return by_name, by_cat


def kernel_ms(fn, calls, tries=4):
    """Device ms a launch of each of this repository's kernels that ``fn``
    launches once a call, from torch.profiler over ``calls`` calls after a
    warm-up: each kernel's time over the launches the window recorded (its
    first launches can go unrecorded). A window that recorded none of them
    is taken again with twice the calls; after ``tries`` such windows the
    measurement fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {}
        _, by_cat = device_ms_by_name(prof, counts)
        ours = {c: ms / counts[c] for c, ms in by_cat.items()
                if counts.get(c) and c.startswith(
                    ("flash", "fused", "quantize", "dequantize", "fp8",
                     "int8"))}
        if ours:
            return ours
        calls *= 2
    raise AssertionError(f"torch.profiler recorded none of this "
                         f"repository's kernels in {tries} windows")


# Cycles of the spin kernel that holds the stream in device_ms: about 10 ms
# at the H100's 1980 MHz, against a host that enqueues 20 calls in 1-2 ms.
HOLD_CYCLES = 20_000_000


def device_ms(fn, calls=20, tries=4):
    """Device ms a call of ``fn``, back to back with the host's launches
    hidden: for calls too short for time_ms, whose back-to-back events then
    time the host's launches. A spin kernel (``torch.cuda._sleep``) holds
    the stream while the host enqueues a start event, ``calls`` calls and
    an end event, so the events time the device's work alone (every kernel
    the call launches, and the gaps between them). The spin must outlast
    the enqueue: if the start event has fired before the host enqueued the
    end event, the window is taken again with a spin four times as long;
    after ``tries`` such windows the measurement fails."""
    fn()
    torch.cuda.synchronize()
    cycles = HOLD_CYCLES
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / calls
        cycles *= 4
    raise AssertionError(f"the host did not enqueue {calls} calls within "
                         f"a spin of {cycles // 4} cycles in {tries} windows")


def host_calls(prof):
    """CUDA runtime calls of a finished torch.profiler window: ``{name:
    [count, host ms]}``, and the host's busiest ops by self time. A
    synchronizing call (cudaStreamSynchronize, cudaFree, a device-to-host
    copy) makes the host wait for the device, which exposes every launch
    after it."""
    from torch.autograd import DeviceType

    api, ops = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        ms = e.self_cpu_time_total / 1e3
        if e.key.startswith("cuda"):
            api[e.key] = [e.count, ms]
        else:
            ops.append((e.key, e.count, ms))
    ops.sort(key=lambda t: -t[2])
    return api, [[k[:60], c, ms] for k, c, ms in ops[:8]]


def device_breakdown(prof, wall_ms, extra):
    """Device time by kernel from a finished torch.profiler window."""
    launches = {}
    by_name, by_cat = device_ms_by_name(prof, launches)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    api, host_top = host_calls(prof)
    rec = dict(extra, wall_ms=wall_ms, device_ms=device_ms,
               idle_share=1.0 - device_ms / wall_ms if wall_ms else None,
               by_category_ms=by_cat, launches_by_category=launches,
               top_kernels_ms=[[n[:80], ms] for n, ms in top],
               cuda_api=api, host_top_self_ms=host_top)
    log(f"[profile] {json.dumps(rec)}")
    return rec


def profile_window(fn, extra):
    """Run ``fn`` under torch.profiler; device time by kernel category and
    the idle share of the window's wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_breakdown(prof, wall_ms, extra)


def profile_serving(pool, tokens):
    """Device time by kernel over a window of served requests, and the
    batches the window served."""
    extra = {"requests": len(tokens)}

    def run():
        b0 = pool.dispatcher.n_batches
        futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
        for f in futs:
            f.result(timeout=600.0)
        extra["batches"] = pool.dispatcher.n_batches - b0

    return profile_window(run, extra)


def train_loss(model):
    """Next-token cross entropy on the fp32 logits, through the parameter
    dict the step hands in."""
    import torch.nn.functional as F

    def loss_fn(params, tokens):
        logits = torch.func.functional_call(model, params, (tokens[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())

    return loss_fn


def train(hvt, fa, fadam, cfg, sizes):
    """GPT-2 small through make_train_step(sharded=True, fused_update=True)
    on a one-rank NCCL world, held against the plain path, then timed."""
    from horovod_tpu_torch.obs import flops
    from horovod_tpu_torch.parallel import dp

    hvt.init(backend="nccl")
    seq = cfg.max_len
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, seq + 1), dtype=np.int64
    )).cuda()
    n_matmul = sum(v.numel() for k, v in sd0.items()
                   if not k.startswith(("transformer.wte", "transformer.wpe")))
    tokens_per_step = TRAIN_BATCH * seq
    flops_per_step = tokens_per_step * flops.transformer_flops_per_token(
        n_matmul, cfg.n_layers, seq, cfg.d_model
    )

    def build(use_flash, fused):
        model = hvt.GPT2LMModel(dataclasses.replace(cfg, use_flash=use_flash))
        model.load_state_dict(sd0)
        step, opt = hvt.make_train_step(
            train_loss(model), hvt.fused_adamw(TRAIN_LR), sharded=True,
            fused_update=fused, tokens_per_step=tokens_per_step,
            flops_per_step=flops_per_step,
        )
        return model, step, dp.init_state(model, opt)

    model_k, step_k, state_k = build(None, True)
    model_p, step_p, state_p = build(False, False)
    got = [b.numel() for b in state_k.opt_state.inner.mu.buffers]
    if got != list(sizes):
        raise AssertionError(f"trainer buckets {got} != predicted {sizes}")

    # Gradients at the start: kernel path vs plain attention.
    _, _, g_k = dp.accumulate_gradients(train_loss(model_k), state_k.params,
                                        tokens, 1)
    _, _, g_p = dp.accumulate_gradients(train_loss(model_p), state_p.params,
                                        tokens, 1)
    grad_rel = grads_rel_l2(g_k, g_p)
    del g_k, g_p
    log(f"[train] gradients, kernel vs plain path: relative L2 {grad_rel:.3e} "
        f"(tol {STEP_GRAD_TOL})")
    if not grad_rel <= STEP_GRAD_TOL:
        raise AssertionError("kernel-path gradients disagree with the plain path")

    # One step each from the same start.
    p0 = {n: p.detach().clone() for n, p in state_k.params.items()}
    state_k, loss_k = step_k(state_k, tokens)
    state_p, loss_p = step_p(state_p, tokens)
    wd = hvt.fused_adamw(TRAIN_LR).fused_spec.weight_decay
    excess, flipped, total = -1.0, 0, 0
    with torch.no_grad():
        for n, p in p0.items():
            d = (state_k.params[n] - state_p.params[n]).abs()
            bound = 2 * TRAIN_LR * (1 + wd * p.abs()) + 1e-6
            excess = max(excess, float((d - bound).max()))
            flipped += int((d > TRAIN_LR).sum())
            total += d.numel()
    flip_share = flipped / total
    log(f"[train] one step, kernel vs plain path: loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f}; largest excess over 2 lr (1 + wd |p|) + 1e-6: "
        f"{excess:.3e}; elements stepping the other way {flipped}/{total} "
        f"({flip_share:.3e}, tol {FLIP_TOL})")
    if excess > 0 or flip_share > FLIP_TOL:
        raise AssertionError("the kernel step's parameters disagree with the "
                             "plain step's")
    del model_p, step_p, state_p, p0
    torch.cuda.empty_cache()

    losses = [float(loss_k)]
    for _ in range(TRAIN_WARMUP - 1):
        state_k, loss = step_k(state_k, tokens)
        losses.append(float(loss))
    fa.reset_launches()
    fadam.reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_k, loss = step_k(state_k, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"flash_fwd": fa.launches, "flash_bwd_dkdv": fa.launches_dkdv,
              "flash_bwd_dq": fa.launches_dq, "fused_adamw": fadam.launches}
    log(f"[train] losses {losses}")
    log(f"[train] launches over {TRAIN_STEPS} steps: {counts}")
    general = (fa.launches_general, fa.launches_general_dq,
               fa.launches_general_dkdv, fa.launches_sm90_fwd,
               fa.launches_sm90_dq, fa.launches_sm90_dkdv)
    if any(general):
        raise RuntimeError(f"[train] bf16 head dim 64 took the general or "
                           f"sm90 kernels {general} times: the wgmma route "
                           f"alone")
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers, "fused_adamw": len(sizes)}
    for name, per_step in want.items():
        if counts[name] != per_step * TRAIN_STEPS:
            raise AssertionError(
                f"{name} launched {counts[name]} times in {TRAIN_STEPS} "
                f"steps, not {per_step} a step"
            )
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not reduce the loss: {losses}")
    if int(state_k.step) != TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError(f"state.step is {int(state_k.step)}")
    step_ms = float(np.median(times)) * 1e3
    tp = step_k.throughput(step_ms / 1e3)
    log(f"[train] step median {step_ms:.3f} ms (min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}); {tp['tokens_per_s']:.1f} tokens/s; "
        f"MFU {tp['mfu']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def one_step():
        nonlocal state_k
        state_k, _ = step_k(state_k, tokens)

    prof = profile_window(one_step, {"steps": 1})
    hvt.shutdown()
    del model_k, step_k, state_k
    torch.cuda.empty_cache()
    return {"launches": counts, "losses": losses, "step_ms": step_ms,
            "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": tp["tokens_per_s"], "mfu": tp["mfu"],
            "grad_rel_l2": grad_rel, "flip_share": flip_share,
            "param_excess": excess, "profile": prof}


def reset_counts(fa, fadam, tq):
    fa.reset_launches()
    fadam.reset_launches()
    tq.reset_launches()


def read_counts(fa, fadam, tq):
    return {"flash_fwd": fa.launches, "flash_bwd_dkdv": fa.launches_dkdv,
            "flash_bwd_dq": fa.launches_dq, "fused_adamw": fadam.launches,
            "quantize_blockwise": tq.launches_quant,
            "dequantize_blockwise": tq.launches_dequant,
            "fp8_matmul": tq.launches_fp8_matmul,
            "fp8_cast": tq.launches_fp8_cast,
            "fp8_relayout": tq.launches_fp8_relayout,
            "int8_matmul": tq.launches_int8_matmul}


def quant_train_run(hvt, kernels, cfg, sd0, tokens, compression, *, label,
                    sharded=False, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
                    n_buckets, bracket=None, profile=False):
    """One training run from ``sd0``: ``warmup`` steps, then ``steps``
    timed steps with every launch count set to 0 just before and read just
    after; checks the counts a step against the path's kernels."""
    from horovod_tpu_torch.optimizer import ef_residual_norm
    from horovod_tpu_torch.parallel import dp

    fa, fadam, tq = kernels
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(sd0)
    if sharded:
        opt, kw = hvt.fused_adamw(TRAIN_LR), dict(sharded=True,
                                                   fused_update=True)
    else:
        opt, kw = hvt.adamw(TRAIN_LR), {}
    step, wopt = hvt.make_train_step(train_loss(model), opt,
                                     compression=compression, **kw,
                                     **(bracket or {}))
    state = dp.init_state(model, wopt)
    losses = []
    for _ in range(warmup):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    reset_counts(fa, fadam, tq)
    times, enqueue = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        enqueue.append(time.perf_counter() - t0)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts(fa, fadam, tq)
    quantized = getattr(compression, "is_quantized", False)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers,
            "fused_adamw": n_buckets if sharded else 0,
            "quantize_blockwise": 2 * n_buckets if quantized else 0,
            "dequantize_blockwise": 2 * n_buckets if quantized else 0,
            "fp8_matmul": 0}
    log(f"[{label}] losses {losses}")
    log(f"[{label}] launches over {steps} steps: {counts}")
    for name, per_step in want.items():
        if counts[name] != per_step * steps:
            raise AssertionError(
                f"[{label}] {name} launched {counts[name]} times in {steps} "
                f"steps, not {per_step} a step"
            )
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{label}] the loss did not fall: {losses}")
    step_ms = float(np.median(times)) * 1e3
    # Host time until the step function returns, before the loss is read:
    # near the step time when the host is what holds the device back.
    enqueue_ms = float(np.median(enqueue)) * 1e3
    rec = {"losses": losses, "launches": counts, "step_ms": step_ms,
           "step_ms_all": [t * 1e3 for t in times], "enqueue_ms": enqueue_ms}
    if bracket:
        rec.update(step.throughput(step_ms / 1e3))
    res = getattr(state.opt_state, "residual", None)
    if quantized and res is not None:
        rec["residual_norm"] = ef_residual_norm(state)
        if not rec["residual_norm"] > 0:
            raise AssertionError(f"[{label}] the EF residuals stayed zero")
    log(f"[{label}] step median {step_ms:.3f} ms (min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}), host enqueue {enqueue_ms:.3f} ms; "
        f"tokens/s {rec.get('tokens_per_s')}; "
        f"residual norm {rec.get('residual_norm')}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        def one_step():
            nonlocal state
            state, _ = step(state, tokens)

        rec["profile"] = profile_window(one_step, {"steps": 1, "run": label})
    del model, step, wopt, state
    torch.cuda.empty_cache()
    return rec


def train_quant(hvt, kernels, cfg, sizes, qsizes):
    """[train-quant], [train-quant-zero1] and [train-quant-fp8]."""
    from horovod_tpu_torch.obs import flops
    from horovod_tpu_torch.ops import quantization as tq

    hvt.init(backend="nccl")
    seq = cfg.max_len
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, seq + 1), dtype=np.int64
    )).cuda()
    n_matmul = sum(v.numel() for k, v in sd0.items()
                   if not k.startswith(("transformer.wte", "transformer.wpe")))
    bracket = {"tokens_per_step": TRAIN_BATCH * seq,
               "flops_per_step": TRAIN_BATCH * seq
               * flops.transformer_flops_per_token(n_matmul, cfg.n_layers,
                                                   seq, cfg.d_model)}
    int8 = hvt.Compression.int8.with_block(QUANT_BLOCK)
    run = dict(n_buckets=len(qsizes))
    off = quant_train_run(hvt, kernels, cfg, sd0, tokens, hvt.Compression.none,
                          label="train-quant off", bracket=bracket,
                          profile=True, **run)
    on = quant_train_run(hvt, kernels, cfg, sd0, tokens, int8,
                         label="train-quant on", bracket=bracket,
                         profile=True, **run)
    rel = abs(on["losses"][-1] - off["losses"][-1]) / abs(off["losses"][-1])
    n = sum(sizes)
    wire = {"gradient_wire_bytes_fp32": 4 * n,
            "gradient_wire_bytes_bf16": 2 * n,
            "gradient_wire_bytes_int8": sum(
                tq.quantized_wire_bytes(m, QUANT_BLOCK, tq.INT8)
                for m in qsizes)}
    wire["ratio_vs_fp32"] = wire["gradient_wire_bytes_int8"] / (4 * n)
    wire["ratio_vs_bf16"] = wire["gradient_wire_bytes_int8"] / (2 * n)
    pair = dict(wire, step_ms_off=off["step_ms"], step_ms_on=on["step_ms"],
                tokens_per_s_off=off["tokens_per_s"],
                tokens_per_s_on=on["tokens_per_s"],
                speedup=off["step_ms"] / on["step_ms"],
                last_loss_off=off["losses"][-1], last_loss_on=on["losses"][-1],
                last_loss_rel=rel, block=QUANT_BLOCK)
    log(f"[train-quant] {json.dumps(pair)}")
    if not rel < QUANT_LOSS_TOL:
        raise AssertionError(
            f"the int8 run's last loss is {rel:.3%} from the none run's "
            f"(tol {QUANT_LOSS_TOL:.0%})"
        )
    zero1 = quant_train_run(hvt, kernels, cfg, sd0, tokens, int8,
                            label="train-quant-zero1", sharded=True,
                            steps=ZERO1_QUANT_STEPS, **run)
    fp8 = quant_train_run(hvt, kernels, cfg, sd0, tokens,
                          hvt.Compression.fp8.with_block(QUANT_BLOCK),
                          label="train-quant-fp8", warmup=1,
                          steps=FP8_QUANT_STEPS, **run)
    hvt.shutdown()
    return {"pair": pair, "off": off, "on": on, "zero1": zero1, "fp8": fp8}


def fp8_step_shapes(cfg):
    """Kernel 8's distinct calls in one GPT-2 training step at FP8_BATCH x
    max_len tokens: ``(name, launches a step, kind, weight [N, K])``; kind
    fwd is x @ w.T, dx is g @ w, dw is g.T @ x."""
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    shapes = []
    for kind in ("fwd", "dx", "dw"):
        shapes += [(f"{kind} q/k/v/out", 4 * layers, kind, (d, d)),
                   (f"{kind} fc", layers, kind, (f, d)),
                   (f"{kind} proj", layers, kind, (d, f))]
    return shapes


def fp8_operands(gen, m, kind, w_shape):
    """The fp8 operands of one call as the path hands them, K-major: the
    casts write x [M, K], w [N, K] and g [M, N] row-major and transposed
    (x^T [K, M] and w^T [K, N] in e4m3, g^T [N, M] in e5m2). Returns (a, b)
    with out = a @ b, b the transposed view of a row-major payload."""
    n_w, k_w = w_shape

    def rand(rows, cols, dtype, s=4.0):
        return (torch.randn((rows, cols), generator=gen, device="cuda")
                * s).to(dtype)

    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    if kind == "fwd":  # x @ (w [N, K])^T
        return rand(m, k_w, e4), rand(n_w, k_w, e4).t()
    if kind == "dx":  # g @ w = g @ (w^T [K, N])^T
        return rand(m, n_w, e5), rand(k_w, n_w, e4).t()
    return rand(n_w, m, e5), rand(k_w, m, e4).t()  # g^T @ (x^T)^T


def fp8_compare(tq, a, b, out_dtype, scale):
    """Kernel 8 vs its plain version on one call: (max |d|, relative to
    the largest plain value)."""
    got = tq.fp8_matmul(a, b, scale, out_dtype=out_dtype)
    ref = tq.fp8_matmul_reference(a, b, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"fp8_matmul {got.shape} {got.dtype} vs plain "
                             f"{ref.shape} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not rel <= FP8_TOL[out_dtype]:
        raise AssertionError(
            f"fp8 matmul kernel disagrees with its plain version on "
            f"{tuple(a.shape)} x {tuple(b.shape)} {a.dtype} x {b.dtype} -> "
            f"{out_dtype}: {rel} (tol {FP8_TOL[out_dtype]})")
    return err, rel


def scaled_mm_ms(a, b, scale, out_dtype):
    """torch._scaled_mm on the same operands as the yardstick (the port
    never calls it): it takes a row-major and b column-major, so other
    layouts get copies made here, outside the timing. None where it
    refuses the case."""
    a_l = a if a.is_contiguous() else a.contiguous()
    b_l = b if b.t().is_contiguous() else b.t().contiguous().t()
    one = torch.ones((), device="cuda")

    def call():
        return torch._scaled_mm(a_l, b_l, scale_a=scale, scale_b=one,
                                out_dtype=out_dtype)

    try:
        call()
    except (RuntimeError, TypeError) as exc:
        log(f"[fp8] torch._scaled_mm refuses {a.dtype} x {b.dtype}: {exc}")
        return None
    return time_ms(call)


def fp8_case(tq, gen, cfg):
    """[fp8]: kernel 8 vs its plain version at the main path's calls (M =
    FP8_BATCH x max_len, K-major, no relayout) and on the reference test's
    ragged cases (K-major and through the relayout), then the main path's
    calls timed beside the plain version and torch._scaled_mm, each with
    its bound."""
    scale = torch.tensor(0.37, device="cuda")
    m = FP8_BATCH * cfg.max_len
    err = rel = 0.0
    rng = np.random.RandomState(11)
    f8 = (torch.float8_e4m3fn, torch.float8_e5m2)
    tq.reset_launches()
    ragged = 0
    for fx in f8:
        for fw in f8:
            for mm, kk, nn in ((5, 300, 70), (16, 512, 128), (1, 257, 10),
                               (130, 129, 260)):
                a = torch.from_numpy(rng.randn(mm, kk).astype(np.float32))
                b = torch.from_numpy(rng.randn(kk, nn).astype(np.float32))
                a = a.cuda().to(fx)
                b_rows = b.cuda().to(fw)  # [K, N] row-major: relayout
                b_kmaj = b_rows.t().contiguous().t()  # K-major
                for bb in (b_kmaj, b_rows):
                    for out_dtype in (torch.float32, torch.bfloat16):
                        e, r = fp8_compare(tq, a, bb, out_dtype, scale)
                        err, rel = max(err, e), max(rel, r)
                        ragged += 1
    relayouts = tq.launches_fp8_relayout
    log(f"[fp8] ragged cases, 4 pairings, K-major and row-major w, fp32 and "
        f"bf16 ({ragged} calls, {relayouts} relayouts): max |d| {err:.3e}, "
        f"relative {rel:.3e}")
    if relayouts == 0:
        raise AssertionError("the ragged cases never took the relayout")
    # One k-step (K = 32, one wgmma, nothing promoted): the tensor cores'
    # own rounding of a 32-product sum, relative to the largest output.
    a1, b1 = fp8_operands(gen, 768, "fwd", (768, 32))
    got = tq.fp8_matmul(a1, b1, scale)
    ref = tq.fp8_matmul_reference(a1, b1, scale)
    torch.cuda.synchronize()
    d = (got - ref).float()
    one_step = {"max_rel": (d.abs().max() / ref.abs().max()).item(),
                "rms_rel": (d.square().mean().sqrt()
                            / ref.square().mean().sqrt()).item()}
    log(f"[fp8] one k-step's rounding by the fp8 tensor cores ([768, 32] x "
        f"[32, 768], fp32 out): max {one_step['max_rel']:.3e}, rms "
        f"{one_step['rms_rel']:.3e} of the plain version's largest / rms")
    cases, step = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "t_bytes": 0.0, "t_ops": 0.0, "bound_ms": 0.0,
                       "flops": 0.0, "launches": 0}
    promotion = None
    for name, count, kind, w_shape in fp8_step_shapes(cfg):
        a, b = fp8_operands(gen, m, kind, w_shape)
        out_dtypes = ((torch.bfloat16, torch.float32) if kind == "dw"
                      else (torch.bfloat16,))
        r_case = {}
        tq.reset_launches()
        for out_dtype in out_dtypes:
            e, r = fp8_compare(tq, a, b, out_dtype, scale)
            err, rel = max(err, e), max(rel, r)
            r_case[str(out_dtype).replace("torch.", "")] = r
        if tq.launches_fp8_relayout:
            raise AssertionError(f"[fp8] {name}: the main path's layout took "
                                 f"{tq.launches_fp8_relayout} relayouts")
        mm, kk = a.shape
        nn = b.shape[1]
        if kind == "dw" and (promotion is None or r_case["float32"] > promotion):
            promotion = r_case["float32"]
        rec = {"name": name, "launches_per_step": count, "m": mm, "k": kk,
               "n": nn, "a": str(a.dtype), "b": str(b.dtype),
               "a_stride": list(a.stride()), "b_stride": list(b.stride()),
               "rel_err": r_case}
        rec["ms"] = time_ms(lambda: tq.fp8_matmul(a, b, scale,
                                                  out_dtype=torch.bfloat16))
        rec["device_ms"] = device_ms(lambda: tq.fp8_matmul(
            a, b, scale, out_dtype=torch.bfloat16))
        rec["plain_ms"] = time_ms(
            lambda: tq.fp8_matmul_reference(a, b, scale,
                                            out_dtype=torch.bfloat16),
            samples=5, per_sample=3)
        rec["library_ms"] = scaled_mm_ms(a, b, scale, torch.bfloat16)
        one = torch.ones((), device="cuda")
        rec["library_device_ms"] = (device_ms(lambda: torch._scaled_mm(
            a, b, scale_a=scale, scale_b=one, out_dtype=torch.bfloat16))
            if rec["library_ms"] else None)
        nbytes = mm * kk + kk * nn + 2 * mm * nn  # fp8 in, bf16 out
        flops = 2 * mm * nn * kk
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP8_FLOPS_PER_S
        rec.update(bytes=nbytes, flops=flops,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["library_tflops"] = (flops / rec["library_ms"] / 1e9
                                 if rec["library_ms"] else None)
        log(f"[fp8] {name}: [{mm}, {kk}] x [{kk}, {nn}] {a.dtype} x {b.dtype}"
            f" (strides {tuple(a.stride())}, {tuple(b.stride())}): kernel "
            f"{rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s; device "
            f"{rec['device_ms']:.4f}), plain {rec['plain_ms']:.4f} ms, "
            f"torch._scaled_mm {rec['library_ms']} ms ({rec['library_tflops']}"
            f" TFLOP/s; device {rec['library_device_ms']}), bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); relative error "
            f"{r_case}")
        cases.append(rec)
        for key in ("ms", "device_ms", "plain_ms", "bound_ms"):
            step[key] = step.get(key, 0.0) + count * rec[key]
        for key in ("library_ms", "library_device_ms"):
            step[key] = (None if step.get(key, 0.0) is None
                         or rec[key] is None
                         else step.get(key, 0.0) + count * rec[key])
        step["t_bytes"] += count * t_bytes * 1e3
        step["t_ops"] += count * t_ops * 1e3
        step["flops"] += count * flops
        step["launches"] += count
        del a, b
    step["bound_by"] = ("bytes" if step["t_bytes"] >= step["t_ops"]
                        else "operations")
    step["tflops"] = step["flops"] / step["ms"] / 1e9
    log(f"[fp8] one step's {step['launches']} launches: kernel "
        f"{step['ms']:.3f} ms ({step['tflops']:.1f} TFLOP/s; device "
        f"{step['device_ms']:.3f} ms), plain "
        f"{step['plain_ms']:.3f} ms, torch._scaled_mm {step['library_ms']} "
        f"ms (device {step['library_device_ms']} ms), bound "
        f"{step['bound_ms']:.3f} ms ({step['bound_by']}); max |d| "
        f"{err:.3e}, relative {rel:.3e}; promotion's error at K = {m}: "
        f"{promotion:.3e} (fp32 out, tol {FP8_TOL[torch.float32]})")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_rel_err": rel, "step": step,
            "promotion_rel_err": promotion, "one_k_step_rel_err": one_step,
            "ragged_relayouts": relayouts, "cases": cases}


def fp8_cast_shapes(cfg):
    """The cast kernel's distinct calls in one GPT-2 training step at
    FP8_BATCH x max_len tokens: ``(name, launches a step, rows, cols, wire,
    weight mode)``."""
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    m = FP8_BATCH * cfg.max_len
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    return [("x q/k/v/out/fc", 5 * layers, m, d, e4, False),
            ("x proj", layers, m, f, e4, False),
            ("g q/k/v/out/proj", 5 * layers, m, d, e5, False),
            ("g fc", layers, m, f, e5, False),
            ("w q/k/v/out", 4 * layers, d, d, e4, True),
            ("w fc", layers, f, d, e4, True),
            ("w proj", layers, d, f, e4, True)]


def cast_compare(tq, x, hist, wire, res=None, **kw):
    """The cast kernel vs its plain version, bit for bit except a NaN
    payload's sign bit; returns the largest |kernel - plain| over the
    non-NaN elements of every output (payloads, ring, scale, residual)."""
    got = tq.fp8_cast(x, hist, wire, residual=res, **kw)
    want = tq.fp8_cast_reference(x, hist, wire, residual=res, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"fp8_cast {name}: {a is None} vs plain "
                                 f"{b is None}")
        if a is None:
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"fp8_cast {name} {a.shape} {a.dtype} vs "
                                 f"plain {b.shape} {b.dtype}")
        nan = torch.isnan(b.float())
        view = {1: torch.uint8, 4: torch.int32}[a.element_size()]
        same = (torch.equal(torch.isnan(a.float()), nan) and torch.equal(
            a.contiguous().view(view)[~nan], b.contiguous().view(view)[~nan]))
        if not same:
            raise AssertionError(
                f"fp8_cast kernel disagrees with its plain version on {name} "
                f"of {tuple(x.shape)} {x.dtype} -> {wire}")
        af, bf = a.float(), b.float()
        d = torch.where(af == bf, 0.0, (af - bf).abs())[~nan]
        if d.numel():
            err = max(err, d.max().item())
    return err


def fp8_cast_case(tq, gen, cfg):
    """[fp8-cast]: the cast kernel bit for bit against its plain version at
    the step's shapes and on special values and ragged shapes, then the
    step's shapes timed beside the plain composition and the byte bound."""
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    checked, err = 0, 0.0
    # Special values, a fresh ring, ragged shapes, rows off 16-byte
    # boundaries, fp32 and bf16, both modes and formats.
    for rows, cols, pad in ((1000, 768, 0), (130, 70, 0), (33, 129, 3),
                            (1, 17, 0)):
        base = torch.randn((rows, cols + pad), generator=gen,
                           device="cuda")[:, :cols] * 3
        for i, v in enumerate((float("nan"), float("inf"), -float("inf"),
                               1e6, -1e6, 0.0, -0.0, 1e-30)):
            base[(7 * i) % rows, (13 * i) % cols] = v
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            for wire in (e4, e5):
                for fresh in (True, False):
                    hist = torch.rand((16,), generator=gen,
                                      device="cuda") * 40
                    if fresh:
                        hist.zero_()
                    res = torch.randn((rows, cols), generator=gen,
                                      device="cuda") * 1e-3
                    err = max(err, cast_compare(tq, x, hist, wire),
                              cast_compare(tq, x, hist, wire, res))
                    checked += 2
    log(f"[fp8-cast] special values (NaN, +-inf, past qmax, signed zeros), "
        f"fresh and filled rings, ragged and unaligned shapes, fp32 and bf16, "
        f"e4m3 and e5m2, activation and weight mode: {checked} casts bit for "
        f"bit (max |d| {err})")
    cases, step = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                       "bytes": 0.0, "elements": 0.0, "launches": 0}
    for name, count, rows, cols, wire, weight in fp8_cast_shapes(cfg):
        x = (torch.randn((rows, cols), generator=gen, device="cuda")
             * (0.05 if weight else 3.0)).to(torch.bfloat16)
        hist = torch.rand((16,), generator=gen, device="cuda") * 10
        res = (torch.randn((rows, cols), generator=gen, device="cuda") * 1e-4
               if weight else None)
        err = max(err, cast_compare(tq, x, hist, wire, res))
        rec = {"name": name, "launches_per_step": count, "rows": rows,
               "cols": cols, "wire": str(wire), "weight": weight}
        rec["ms"] = time_ms(lambda: tq.fp8_cast(x, hist, wire, residual=res))
        rec["device_ms"] = device_ms(
            lambda: tq.fp8_cast(x, hist, wire, residual=res))
        rec["plain_ms"] = time_ms(
            lambda: tq.fp8_cast_reference(x, hist, wire, residual=res),
            samples=5, per_sample=3)
        per = 12 if weight else 4  # bytes an element in and out
        rec["bytes"] = rows * cols * per
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        rec["gbps"] = rec["bytes"] / rec["ms"] / 1e6
        log(f"[fp8-cast] {name}: [{rows}, {cols}] bf16 -> {wire}"
            f"{' + residual' if weight else ''}: kernel {rec['ms']:.4f} ms "
            f"({rec['gbps']:.0f} GB/s; device {rec['device_ms']:.4f} ms), "
            f"plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms (bytes); bit for bit")
        cases.append(rec)
        for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bytes"):
            step[key] = step.get(key, 0.0) + count * rec[key]
        step["elements"] += count * rows * cols
        step["launches"] += count
        del x, res
    step["bound_by"] = "bytes"
    log(f"[fp8-cast] one step's {step['launches']} launches "
        f"({step['elements'] / 1e9:.3f} G elements, {step['bytes'] / 1e9:.2f} "
        f"GB): kernel {step['ms']:.3f} ms (device {step['device_ms']:.3f} "
        f"ms), plain {step['plain_ms']:.3f} ms, bound {step['bound_ms']:.3f} "
        f"ms; max |d| over every cast checked {err}")
    torch.cuda.empty_cache()
    return {"checked": checked, "max_abs_err": err, "step": step,
            "cases": cases}


def fp8_linear_plain(tq, x, w, kr, xh, kh, gh, g):
    """Fp8Linear's forward and backward written out with the plain matmul:
    (out, dx, dw, new kr, new xh, new kh, new gh)."""
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    sx = tq.fp8_scale_from_history(xh, tq.E4M3_MAX)
    sk = tq.fp8_scale_from_history(kh, tq.E4M3_MAX)
    kc = w.float() + kr
    qx = tq.fp8_saturating_cast(x, sx, e4, tq.E4M3_MAX).flatten(0, -2)
    qk = tq.fp8_saturating_cast(kc, sk, e4, tq.E4M3_MAX)
    out = tq.fp8_matmul_reference(qx, qk.t(), sx * sk, out_dtype=x.dtype)
    sg = tq.fp8_scale_from_history(gh, tq.E5M2_MAX)
    qg = tq.fp8_saturating_cast(g, sg, e5, tq.E5M2_MAX).flatten(0, -2)
    dx = tq.fp8_matmul_reference(qg, qk, sg * sk, out_dtype=x.dtype)
    dw = tq.fp8_matmul_reference(qg.t(), qx, sx * sg, out_dtype=x.dtype)
    return (out.reshape(g.shape), dx.reshape(x.shape), dw,
            kc - qk.float() * sk, tq.fp8_push_amax(xh, x),
            tq.fp8_push_amax(kh, kc), tq.fp8_push_amax(gh, g))


def fp8_linear_check(hvt, tq, gen, model, tokens):
    """One Fp8Linear forward and backward at the first layer's fc (its
    real input and trained state, a gradient of the ring's magnitude)
    against the same math on the plain matmul: out, dx, dw within the bf16
    tolerance, the four state gradients bit for bit."""
    fc = model.transformer.blocks[0].mlp.fc
    seen = {}

    def keep_input(mod, inp, out):
        seen["x"] = inp[0].detach()

    hook = fc.register_forward_hook(keep_input)
    with torch.no_grad():
        model(tokens[:, :-1])
    hook.remove()
    x = seen["x"]
    w = fc.weight.detach().to(x.dtype)
    state = [p.detach() for p in (fc.fp8_k_residual, fc.fp8_x_amax_history,
                                  fc.fp8_k_amax_history,
                                  fc.fp8_g_amax_history)]
    g = (torch.randn(x.shape[:-1] + (w.shape[0],), generator=gen,
                     device="cuda") * (state[3].max() / 4)).to(x.dtype)
    leaves = [t.clone().requires_grad_(True) for t in [x, w] + state]
    tq.reset_launches()
    out = hvt.Fp8Linear.apply(*leaves)
    got = (out.detach(),) + torch.autograd.grad(out, leaves, g)
    counts = {"fp8_matmul": tq.launches_fp8_matmul,
              "fp8_cast": tq.launches_fp8_cast,
              "fp8_relayout": tq.launches_fp8_relayout}
    want = fp8_linear_plain(tq, x, w, *state, g)
    torch.cuda.synchronize()
    rels = []
    for name, a, b in zip(("out", "dx", "dw"), got[:3], want[:3]):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"Fp8Linear {name} {a.shape} {a.dtype} vs "
                                 f"plain {b.shape} {b.dtype}")
        rels.append((a.float() - b.float()).abs().max().item()
                    / max(b.float().abs().max().item(), 1e-30))
    same = [torch.equal(a, b) for a, b in zip(got[3:], want[3:])]
    log(f"[train-fp8] Fp8Linear at the first fc, x {tuple(x.shape)}, w "
        f"{tuple(w.shape)}, kernel vs plain: relative out/dx/dw "
        f"{rels} (tol {FP8_TOL[torch.bfloat16]}); state gradients bit for "
        f"bit {same}; launches {counts}")
    if max(rels) > FP8_TOL[torch.bfloat16] or not all(same):
        raise AssertionError("Fp8Linear on the kernel disagrees with its "
                             "plain math")
    if counts != {"fp8_matmul": 3, "fp8_cast": 3, "fp8_relayout": 0}:
        raise AssertionError(f"Fp8Linear launched {counts}")
    return {"rel_err_out_dx_dw": rels, "state_bitwise": all(same),
            "launches": counts}


def train_fp8(hvt, kernels, cfg_base):
    """[train-fp8]: the JAX package's bench_fp8 pair at GPT-2 small, "" then
    "fp8", each from convert.init_params(seed=0), 1 warm-up and FP8_STEPS
    timed steps on one batch of FP8_BATCH x 1025 tokens."""
    from horovod_tpu_torch.parallel import dp

    fa, fadam, tq = kernels
    hvt.init(backend="nccl")
    seq = cfg_base.max_len
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg_base.vocab_size, size=(FP8_BATCH, seq + 1)).astype(np.int32)
    ).long().cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    runs = {}
    for mode in ("", "fp8"):
        label = f"train-fp8 {mode or 'off'}"
        cfg = dataclasses.replace(cfg_base, compute_dtype=mode)
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
        step, wopt = hvt.make_train_step(
            train_loss(model), hvt.adamw(FP8_LR), compute_dtype=mode,
            tokens_per_step=FP8_BATCH * seq)
        state = dp.init_state(model, wopt)
        torch.cuda.reset_peak_memory_stats()
        state, loss = step(state, tokens)
        losses = [float(loss)]
        reset_counts(fa, fadam, tq)
        times, enqueue = [], []
        for _ in range(FP8_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, tokens)
            enqueue.append(time.perf_counter() - t0)
            losses.append(float(loss))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = read_counts(fa, fadam, tq)
        want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "fused_adamw": 0,
                "quantize_blockwise": 0, "dequantize_blockwise": 0,
                "fp8_matmul": 18 * cfg.n_layers if mode else 0,
                "fp8_cast": 18 * cfg.n_layers if mode else 0,
                "fp8_relayout": 0}
        log(f"[{label}] losses {losses}")
        log(f"[{label}] launches over {FP8_STEPS} steps: {counts}")
        for name, per_step in want.items():
            if counts[name] != per_step * FP8_STEPS:
                raise AssertionError(
                    f"[{label}] {name} launched {counts[name]} times in "
                    f"{FP8_STEPS} steps, not {per_step} a step")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[{label}] non-finite loss: {losses}")
        step_ms = float(np.median(times)) * 1e3
        rec = {"losses": losses, "launches": counts, "step_ms": step_ms,
               "step_ms_all": [t * 1e3 for t in times],
               "enqueue_ms": float(np.median(enqueue)) * 1e3,
               "tokens_per_s": step.throughput(step_ms / 1e3)["tokens_per_s"],
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"[{label}] step median {step_ms:.3f} ms (min "
            f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), host "
            f"enqueue {rec['enqueue_ms']:.3f} ms; {rec['tokens_per_s']:.1f} "
            f"tokens/s; peak memory {rec['peak_memory_gib']:.2f} GiB")
        if mode:
            rec["gauges"] = hvt.fp8_state_gauges(state.params)
            log(f"[{label}] gauges {rec['gauges']}")
            rec["fp8_linear"] = fp8_linear_check(hvt, tq, gen, model, tokens)

            def one_step():
                nonlocal state
                state, _ = step(state, tokens)

            rec["profile"] = profile_window(one_step,
                                            {"steps": 1, "run": label})
        runs[mode or "off"] = rec
        del model, step, wopt, state
        torch.cuda.empty_cache()
    hvt.shutdown()
    off, on = runs["off"], runs["fp8"]
    converged = bool(
        np.isfinite(on["losses"][-1]) and on["losses"][-1] < on["losses"][0]
        and abs(on["losses"][-1] - off["losses"][-1])
        <= FP8_LOSS_RTOL * max(abs(off["losses"][-1]), 1e-9))
    pair = {"batch": FP8_BATCH, "seq_len": seq, "timing_steps": FP8_STEPS,
            "step_ms_off": off["step_ms"], "step_ms_on": on["step_ms"],
            "speedup": off["step_ms"] / on["step_ms"],
            "tokens_per_s_off": off["tokens_per_s"],
            "tokens_per_s_on": on["tokens_per_s"],
            "loss_off_first": off["losses"][0], "loss_off": off["losses"][-1],
            "loss_on_first": on["losses"][0], "loss_on": on["losses"][-1],
            "loss_rtol": FP8_LOSS_RTOL, "converged": converged,
            **on["gauges"]}
    log(f"[train-fp8] {json.dumps(pair)}")
    if not converged:
        raise AssertionError(f"the fp8 run did not converge: {pair}")
    return {"pair": pair, "off": off, "on": on}


def serve(hvt, fa, workdir):
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.small()
    n_req, seq, batch = SERVE_REQUESTS, cfg.max_len, SERVE_BATCH
    t0 = time.perf_counter()
    params = hvt.convert.init_params(cfg, seed=0)
    hvt.save_checkpoint(workdir, params, step=1)
    log(f"[serve] GPT-2 small ({sum(p.numel() for p in params.values())} "
        f"params) made and saved in {time.perf_counter() - t0:.1f} s")
    # bf16 matmul/embedding weights: the fp32 checkpoint is cast once at
    # load (LayerNorm parameters stay fp32).
    template = hvt.GPT2LMModel(cfg, device="cuda")

    def infer(model, tokens):
        return model(tokens)[:, -1, :]

    pool = ServePool(
        infer, ckpt_dir=workdir, ckpt_target=template, workers=2,
        batch_size=batch, batch_timeout_ms=5.0, request_timeout_secs=600.0,
        ckpt_poll_secs=0.2, device="cuda",
    ).start()
    try:
        model = pool._init_params
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (n_req, seq), dtype=np.int64
        )
        with torch.inference_mode():  # warm-up (cuBLAS, allocator)
            infer(model, torch.from_numpy(tokens[:batch]).cuda())
        torch.cuda.synchronize()

        fa.reset_launches()
        batches0 = pool.dispatcher.n_batches
        rounds, answers = [], None
        for r in range(SERVE_ROUNDS):
            t0 = time.perf_counter()
            futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
            got = [f.result(timeout=600.0) for f in futs]
            wall = time.perf_counter() - t0
            lat = np.asarray(list(pool.dispatcher.latencies)[-n_req:])
            p50, p95 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 95))
            rounds.append({"req_per_s": n_req / wall,
                           "tokens_per_s": n_req * seq / wall,
                           "p50_ms": p50, "p95_ms": p95})
            log(f"[serve] round {r}: {n_req} requests in {wall:.4f} s: "
                f"{n_req / wall:.2f} req/s, {n_req * seq / wall:.1f} "
                f"tokens/s; latency p50 {p50:.2f} ms, p95 {p95:.2f} ms")
            answers = answers or got
        launches = fa.launches
        batches = pool.dispatcher.n_batches - batches0
        log(f"[serve] {SERVE_ROUNDS} x {n_req} requests in {batches} "
            f"batches; flash launches {launches}")
        if launches != cfg.n_layers * batches:
            raise AssertionError(
                f"flash launches {launches} != {cfg.n_layers} x {batches} "
                "batches: the main path did not run the kernel once per layer"
            )
        for a in answers:
            if a.shape != (cfg.vocab_size,) or a.dtype != torch.float32:
                raise AssertionError(f"bad answer {a.shape} {a.dtype}")
            if not torch.isfinite(a).all():
                raise AssertionError("non-finite logits")

        plain = hvt.GPT2LMModel(cfg, device="cuda",
                                attention_fn=plain_attention(fa))
        plain.load_state_dict(model.state_dict())
        with torch.inference_mode():
            ref = infer(plain, torch.from_numpy(tokens[:batch]).cuda()).cpu()
        got = torch.stack(answers[:batch])
        err = (got - ref).abs().max().item()
        bound = 0.05 * ref.abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > bound
        same = got.argmax(-1) == ref.argmax(-1)
        log(f"[serve] kernel vs plain logits: max|d|={err:.4e} "
            f"(bound {bound:.4e}); argmax agrees on "
            f"{int(same.sum())}/{batch} rows, {int(decided.sum())} decided")
        if err > bound or not bool(same[decided].all()):
            raise AssertionError("served logits disagree with the plain path")
        prof = profile_serving(pool, tokens[:16])

        hvt.save_checkpoint(workdir, hvt.convert.init_params(cfg, seed=2),
                            step=2)
        t0 = time.time()
        while len(pool.swap_log) < 2 and time.time() - t0 < 300.0:
            time.sleep(0.05)
        log(f"[serve] swap_log {pool.swap_log}")
        if sorted(w for w, _, _, _ in pool.swap_log) != ["w0", "w1"] or any(
            s != 2 for _, s, _, _ in pool.swap_log
        ):
            raise AssertionError("the pool did not roll onto step 2")
        ivals = sorted((a, b) for _, _, a, b in pool.swap_log)
        if any(end > start for (_, end), (start, _) in zip(ivals, ivals[1:])):
            raise AssertionError("hot-swap windows overlap")
        after = pool.submit(torch.from_numpy(tokens[0])).result(timeout=600.0)
        if not torch.isfinite(after).all() or torch.equal(after, answers[0]):
            raise AssertionError("step-2 weights are not being served")
    finally:
        pool.stop()
    return {"launches": launches, "batches": batches, "rounds": rounds,
            "req_per_s_median": float(np.median(
                [r["req_per_s"] for r in rounds])),
            "logit_err": err, "profile": prof,
            "answers8": torch.stack(answers[:batch])}


def int8_products(cfg):
    """Kernel 7's calls in one GPT-2 serving batch: ``(name, launches a
    batch, K, N)``."""
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    return [("qkv", layers, d, 3 * d), ("out", layers, d, d),
            ("fc", layers, d, f), ("proj", layers, f, d)]


def int8_compare(tq, x, qw, b):
    """Kernel 7 vs its plain version on one call, a second call equal to the
    first bit for bit, and the fused bias equal to the separate add bit for
    bit: (max |d|, relative to the largest plain value, both bitwise)."""
    got = tq.int8_weight_matmul(x, qw)
    ref = tq.int8_weight_matmul_reference(x, qw)
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"int8_weight_matmul {got.shape} {got.dtype} vs "
                             f"plain {ref.shape} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    if not rel <= INT8_TOL[x.dtype]:
        raise AssertionError(
            f"int8 matmul kernel disagrees with its plain version on x "
            f"{tuple(x.shape)} {x.dtype} x w {tuple(qw.shape)}: {rel} "
            f"(tol {INT8_TOL[x.dtype]})")
    repeat = torch.equal(got, tq.int8_weight_matmul(x, qw))
    fused = torch.equal(tq.int8_weight_matmul(x, qw, b), got + b.to(x.dtype))
    if not (repeat and fused):
        raise AssertionError(
            f"int8 matmul kernel on x {tuple(x.shape)} {x.dtype} x w "
            f"{tuple(qw.shape)}: bitwise repeat {repeat}, fused bias equal to "
            f"the separate add {fused}")
    return err, rel, repeat and fused


def compiler_report(name):
    """ptxas's report (-Xptxas -v: registers, spills, advisories) and SASS
    instruction counts of each kernel of csrc/<name>.cu, compiled to an
    object file with the package's flags."""
    from horovod_tpu_torch.ops import _build

    nvcc = _build.nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        obj = str(Path(d) / f"{name}.o")
        proc = subprocess.run(
            [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", obj,
             str(_build.SRC_DIR / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", obj],
            capture_output=True, text=True, check=True).stdout
    report = {"ptxas": [], "advisories": [], "sass": {}}
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            report["ptxas"].append(line.split("info    : ")[-1].strip())
        if "C75" in line:
            report["advisories"].append(line.strip())
    for chunk in sass.split("Function : ")[1:]:
        fn = chunk.split()[0]
        report["sass"][fn] = {op: chunk.count(op) for op in (
            "HGMMA", "HMMA", "UTMALDG", "UTMASTG", "LDL", "STL")}
    return report


def int8pack_call(x2, qw):
    """torch._weight_int8pack_mm on the same operands, the yardstick (the
    port never calls it; it takes its scales in x's dtype), as a callable;
    None where the build does not run it on CUDA."""
    w_nk = qw.q.t()
    scales = qw.scales.to(x2.dtype)

    def call():
        return torch._weight_int8pack_mm(x2, w_nk, scales)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, AttributeError, NotImplementedError) as exc:
        log(f"[int8] torch._weight_int8pack_mm does not run here: "
            f"{str(exc).splitlines()[0][:160]}")
        return None
    return call


def _int8_times(rec):
    def ms(key):
        return "-" if rec[key] is None else f"{rec[key]:.4f}"

    return (f"ms by events / device: kernel {ms('ms')} / {ms('device_ms')}, "
            f"plain {ms('plain_ms')}, _weight_int8pack_mm {ms('library_ms')} / "
            f"{ms('device_library_ms')}, bf16 F.linear {ms('bf16_ms')} / "
            f"{ms('device_bf16_ms')}; bound {ms('bound_ms')} ({rec['bound_by']})")


def int8_case(tq, gen, cfg, report):
    """[int8]: kernel 7 vs its plain version on ragged cases and at one
    serving batch's products (M = 8192) and decode-sized ones (M = 8), each
    repeated bit for bit and with the bias fused bit for bit; the latter two
    timed beside the plain version, the library call and the bf16 cuBLAS
    product of the dequantized weight, each with its bound, and the
    wrapper's host time a call; ``report`` the compiler's (a future)."""
    import torch.nn.functional as F

    err = rel = 0.0
    rng = np.random.RandomState(6)
    tq.reset_launches()
    for mm, kk, nn in ((5, 300, 70), (16, 512, 128), (1, 64, 10),
                       (130, 1000, 260), (33, 17, 129)):
        w = torch.from_numpy(rng.randn(kk, nn).astype(np.float32)).cuda()
        x = torch.from_numpy(rng.randn(mm, kk).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.randn(nn).astype(np.float32)).cuda()
        qw = tq.quantize_weight(w)
        for dtype in (torch.float32, torch.bfloat16):
            e, r, _ = int8_compare(tq, x.to(dtype), qw, b)
            err, rel = max(err, e), max(rel, r)
    ragged = {"relayout": tq.launches_int8_relayout,
              "reduce": tq.launches_int8_matmul_reduce,
              "launches": tq.launches_int8_matmul}
    log(f"[int8] ragged cases, fp32 and bf16, each repeated and with a fused "
        f"bias (both bit for bit): max |d| {err:.3e}, relative {rel:.3e}; "
        f"launches {ragged}")
    cases, sums = [], {}
    timed = ("ms", "plain_ms", "library_ms", "bf16_ms")
    for m, label in ((SERVE_BATCH * cfg.max_len, "batch"),
                     (SERVE_BATCH, "decode")):
        tot = {"bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0, "launches": 0,
               "launches_reduce": 0, "host_us": 0.0, "m": m}
        for key in timed:
            tot[key] = tot["device_" + key] = 0.0
        for name, count, kk, nn in int8_products(cfg):
            rows = (SERVE_BATCH, m // SERVE_BATCH)  # [B, S, K] as the model
            x = torch.randn((*rows, kk), generator=gen,
                            device="cuda").to(torch.bfloat16)
            qw = tq.quantize_weight(
                torch.randn((kk, nn), generator=gen, device="cuda") * 0.02)
            b = torch.randn((nn,), generator=gen, device="cuda")
            tq.reset_launches()
            e, r, _ = int8_compare(tq, x, qw, b)
            err, rel = max(err, e), max(rel, r)
            calls = {"relayout": tq.launches_int8_relayout,
                     "reduce": tq.launches_int8_matmul_reduce,
                     "launches": tq.launches_int8_matmul}
            if calls["relayout"]:
                raise AssertionError(f"[int8] {label} {name}: the model's "
                                     f"layout took {calls} relayouts")
            x2 = x.reshape(m, kk)
            w_bf16 = tq.dequantize_weight(qw).t().contiguous().to(
                torch.bfloat16)
            rec = {"name": name, "launches_per_batch": count, "m": m,
                   "k": kk, "n": nn, "rel_err": r,
                   "reduce_per_call": calls["reduce"] // calls["launches"]}
            # Timed as the served path calls it (Dense.forward: the bias in
            # the epilogue); the plain version and F.linear with the same
            # bias, _weight_int8pack_mm (no bias argument) without.
            b16 = b.to(torch.bfloat16)
            fns = {"ms": lambda: tq.int8_weight_matmul(x, qw, b16),
                   "plain_ms": lambda: tq.int8_weight_matmul_reference(
                       x, qw, b16),
                   "library_ms": int8pack_call(x2, qw),
                   "bf16_ms": lambda: F.linear(x2, w_bf16, b16)}
            # Event times; at M = 8 they time the host's launches, so each
            # call's device time (device_ms) stands beside them -- not
            # the plain version's, which launches a kernel many times a call.
            for key, fn in fns.items():
                slow = key in ("plain_ms", "library_ms")
                rec[key] = None if fn is None else time_ms(
                    fn, **(dict(samples=5, per_sample=3) if slow else {}))
                rec["device_" + key] = (
                    None if fn is None or key == "plain_ms"
                    else device_ms(fn, calls=5 if slow else 20))
            rec["host_us"] = host_us(fns["ms"])
            nbytes = 2 * m * kk + kk * nn + (4 + 2) * nn + 2 * m * nn
            flops = 2 * m * nn * kk
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / BF16_FLOPS_PER_S
            rec.update(bytes=nbytes, flops=flops,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            # Rates from the kernel's device time.
            rec["tflops"] = flops / rec["device_ms"] / 1e9
            rec["gbytes_per_s"] = nbytes / rec["device_ms"] / 1e6
            log(f"[int8] {label} {name}: [{m}, {kk}] x [{kk}, {nn}] bf16 x "
                f"int8 ({rec['tflops']:.1f} TFLOP/s, "
                f"{rec['gbytes_per_s']:.0f} GB/s), {_int8_times(rec)}; "
                f"wrapper {rec['host_us']:.1f} us a call; "
                f"{rec['reduce_per_call']} reduce launches a call; relative "
                f"error {r:.3e}")
            cases.append(rec)
            for key in [*timed, *("device_" + k for k in timed), "bound_ms"]:
                tot[key] = (None if tot[key] is None or rec[key] is None
                            else tot[key] + count * rec[key])
            tot["t_bytes"] += count * t_bytes * 1e3
            tot["t_ops"] += count * t_ops * 1e3
            tot["launches"] += count
            tot["launches_reduce"] += count * rec["reduce_per_call"]
            tot["host_us"] += count * rec["host_us"]
            del x, x2, qw, b16, w_bf16, fns
        tot["bound_by"] = ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                           else "operations")
        tot["host_us"] /= tot["launches"]  # the mean over the 48 launches
        log(f"[int8] one {label}'s {tot['launches']} launches (M = {m}, "
            f"{tot['launches_reduce']} reduce launches), {_int8_times(tot)}; "
            f"wrapper {tot['host_us']:.1f} us a call on average")
        sums[label] = tot
    log(f"[int8] max |d| {err:.3e}, relative {rel:.3e}; every call repeated "
        f"bit for bit and its fused bias bit for bit the separate add")
    comp = report.result()
    log(f"[int8] compiler (int8_matmul.cu): {json.dumps(comp)}")
    main_fn = [f for f in comp["sass"] if "int8_matmul_kernel" in f
               and "f32" not in f]
    sass = comp["sass"][main_fn[0]] if main_fn else {}
    if not (sass.get("HGMMA", 0) > 0 and sass.get("HMMA", 1) == 0
            and sass.get("UTMALDG", 0) > 0 and sass.get("LDL", 1) == 0
            and sass.get("STL", 1) == 0):
        raise AssertionError(f"[int8] the bf16 kernel's SASS is not wgmma "
                             f"fed by TMA without spills: {sass}")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "max_rel_err": rel, "bitwise_repeat": True,
            "bias_bitwise": True, "ragged": ragged, "batch": sums["batch"],
            "decode": sums["decode"], "cases": cases, "compiler": comp}


def _dense_layers(model):
    from horovod_tpu_torch.models.transformer import Dense

    return [m for m in model.modules() if isinstance(m, Dense)]


def check_int8_model(model, where):
    """Every Dense holds an int8 payload and fp32 scales, no floating
    weight."""
    dense = _dense_layers(model)
    bad = [i for i, m in enumerate(dense)
           if not m.quantized or "weight" in m._parameters
           or m.weight_q.dtype != torch.int8
           or m.weight_scales.dtype != torch.float32]
    if not dense or bad:
        raise AssertionError(f"{where}: Dense layers {bad} of {len(dense)} "
                             "are not int8")


def weight_bytes(model):
    """(all parameter and buffer bytes, the projections' bytes)."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    total = nbytes(list(model.parameters()) + list(model.buffers()))
    proj = sum(nbytes([m.weight_q, m.weight_scales]) if m.quantized
               else nbytes([m.weight]) for m in _dense_layers(model))
    return total, proj


def serve_int8(hvt, fa, tq, workdir, bf16_answers, bf16_profile):
    """[serve-int8]: GPT-2 small through ServePool(weight_dtype="int8")."""
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.small()
    n_req, seq, batch = SERVE_REQUESTS, cfg.max_len, SERVE_BATCH
    per_restore = 4 * cfg.n_layers
    ckdir = Path(workdir) / "int8"
    shutil.copytree(Path(workdir) / "step_1", ckdir / "step_1")
    ckdir = str(ckdir)
    fc_name = "transformer.blocks.0.mlp.fc.weight"
    fc32 = hvt.restore_checkpoint(
        ckdir, {fc_name: torch.zeros((cfg.d_ff, cfg.d_model))})[fc_name]
    template = hvt.GPT2LMModel(cfg, device="cuda")

    def infer(model, tokens):
        return model(tokens)[:, -1, :]

    tq.reset_launches()
    t0 = time.perf_counter()
    pool = ServePool(
        infer, ckpt_dir=ckdir, ckpt_target=template, workers=2,
        batch_size=batch, batch_timeout_ms=5.0, request_timeout_secs=600.0,
        ckpt_poll_secs=0.2, device="cuda", weight_dtype="int8",
    ).start()
    try:
        load_s = time.perf_counter() - t0
        quant_load = tq.launches_quant
        model = pool._init_params
        check_int8_model(model, "after load")
        if quant_load != per_restore:
            raise AssertionError(f"kernel 4 launched {quant_load} times at "
                                 f"load, not {per_restore}")
        want = tq.quantize_weight(fc32.t())  # the plain version, on the CPU
        fc = model.transformer.blocks[0].mlp.fc
        same_fc = (torch.equal(fc.quantized_weight().q.cpu(), want.q)
                   and torch.equal(fc.weight_scales.cpu().view(torch.int32),
                                   want.scales.view(torch.int32)))
        if not same_fc:
            raise AssertionError("layer 0's fc payload differs from the plain "
                                 "quantize_weight of the fp32 checkpoint")
        total, proj = weight_bytes(model)
        total16, proj16 = weight_bytes(template)
        log(f"[serve-int8] loaded in {load_s:.1f} s; kernel 4 launches "
            f"{quant_load}; every Dense int8; layer 0 fc bit for bit with the "
            f"CPU plain quantize_weight; weight bytes {total} (projections "
            f"{proj}) vs the bf16 pool's {total16} ({proj16})")
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (n_req, seq), dtype=np.int64)
        with torch.inference_mode():  # warm-up
            infer(model, torch.from_numpy(tokens[:batch]).cuda())
        torch.cuda.synchronize()

        fa.reset_launches()
        tq.reset_launches()
        batches0 = pool.dispatcher.n_batches
        rounds, answers = [], None
        for r in range(SERVE_ROUNDS):
            t0 = time.perf_counter()
            futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
            got = [f.result(timeout=600.0) for f in futs]
            wall = time.perf_counter() - t0
            lat = np.asarray(list(pool.dispatcher.latencies)[-n_req:])
            p50, p95 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 95))
            rounds.append({"req_per_s": n_req / wall,
                           "tokens_per_s": n_req * seq / wall,
                           "p50_ms": p50, "p95_ms": p95})
            log(f"[serve-int8] round {r}: {n_req} requests in {wall:.4f} s: "
                f"{n_req / wall:.2f} req/s, {n_req * seq / wall:.1f} "
                f"tokens/s; latency p50 {p50:.2f} ms, p95 {p95:.2f} ms")
            answers = answers or got
        launches = {"int8_matmul": tq.launches_int8_matmul,
                    "flash_fwd": fa.launches,
                    "int8_relayout": tq.launches_int8_relayout,
                    "int8_matmul_reduce": tq.launches_int8_matmul_reduce}
        batches = pool.dispatcher.n_batches - batches0
        log(f"[serve-int8] {SERVE_ROUNDS} x {n_req} requests in {batches} "
            f"batches; launches {launches}")
        if launches != {"int8_matmul": per_restore * batches,
                        "flash_fwd": cfg.n_layers * batches,
                        "int8_relayout": 0, "int8_matmul_reduce": 0}:
            raise AssertionError(
                f"launches {launches} in {batches} batches: the main path "
                f"did not run kernel 7 once a projection (with no relayout "
                f"and no split) and the flash kernel once a layer")
        for a in answers:
            if a.shape != (cfg.vocab_size,) or a.dtype != torch.float32:
                raise AssertionError(f"bad answer {a.shape} {a.dtype}")
            if not torch.isfinite(a).all():
                raise AssertionError("non-finite logits")

        # A bf16 model holding the dequantized weights, on cuBLAS.
        deq = hvt.GPT2LMModel(cfg, device="cuda")
        sd = {}
        for name, t in model.state_dict().items():
            if name.endswith(".weight_scales"):
                continue
            if name.endswith(".weight_q"):
                pre = name[:-len("weight_q")]
                qw = tq.QuantizedWeight(t.t(), model.state_dict()[
                    pre + "weight_scales"], "float32")
                sd[pre + "weight"] = tq.dequantize_weight(qw).t()
            else:
                sd[name] = t
        deq.load_state_dict(sd)
        with torch.inference_mode():
            ref = infer(deq, torch.from_numpy(tokens[:batch]).cuda()).cpu()
        del deq, sd
        got = torch.stack(answers[:batch])
        err = (got - ref).abs().max().item()
        bound = 0.05 * ref.abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > bound
        same = got.argmax(-1) == ref.argmax(-1)
        rel_l2 = float((got - bf16_answers).norm() / bf16_answers.norm())
        argmax_bf16 = int((got.argmax(-1) == bf16_answers.argmax(-1)).sum())
        log(f"[serve-int8] kernel 7 vs the dequantized bf16 model (cuBLAS): "
            f"max|d|={err:.4e} (bound {bound:.4e}); argmax agrees on "
            f"{int(same.sum())}/{batch} rows, {int(decided.sum())} decided; "
            f"relative L2 against the bf16 pool's answers {rel_l2:.4e} "
            f"(argmax agrees on {argmax_bf16}/{batch})")
        if err > bound or not bool(same[decided].all()):
            raise AssertionError("int8 answers disagree with the dequantized "
                                 "bf16 model")
        prof = profile_serving(pool, tokens[:16])
        # The bias rides kernel 7's epilogue: a batch launches no more
        # elementwise kernels than the bf16 pool's, whose cuBLAS products
        # fuse theirs (a separate add would be 48 more a batch).
        ew = {name: p["launches_by_category"].get("elementwise", 0)
              / max(p["batches"], 1)
              for name, p in (("int8", prof), ("bf16", bf16_profile))}
        log(f"[serve-int8] elementwise launches a batch: {ew['int8']:.1f} "
            f"(bf16 pool {ew['bf16']:.1f})")
        if not ew["int8"] - ew["bf16"] < per_restore / 2:
            raise AssertionError(f"the int8 pool launches {ew} elementwise "
                                 "kernels a batch: a separate bias add?")

        tq.reset_launches()
        hvt.save_checkpoint(ckdir, hvt.convert.init_params(cfg, seed=2),
                            step=2)
        t0 = time.time()
        while len(pool.swap_log) < 2 and time.time() - t0 < 300.0:
            time.sleep(0.05)
        log(f"[serve-int8] swap_log {pool.swap_log}; kernel 4 launches "
            f"{tq.launches_quant}")
        if sorted(w for w, _, _, _ in pool.swap_log) != ["w0", "w1"] or any(
            s != 2 for _, s, _, _ in pool.swap_log
        ):
            raise AssertionError("the int8 pool did not roll onto step 2")
        ivals = sorted((a, b) for _, _, a, b in pool.swap_log)
        if any(end > start for (_, end), (start, _) in zip(ivals, ivals[1:])):
            raise AssertionError("hot-swap windows overlap")
        for w in pool._workers.values():
            check_int8_model(w.params, f"worker {w.name} after the swap")
        if tq.launches_quant != 2 * per_restore:
            raise AssertionError(f"kernel 4 launched {tq.launches_quant} "
                                 f"times in the swap, not 2 x {per_restore}")
        after = pool.submit(torch.from_numpy(tokens[0])).result(timeout=600.0)
        if not torch.isfinite(after).all() or torch.equal(after, answers[0]):
            raise AssertionError("step-2 weights are not being served")
    finally:
        pool.stop()
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"launches": launches["int8_matmul"],
            "launches_flash_fwd": launches["flash_fwd"],
            "launches_relayout": launches["int8_relayout"],
            "launches_reduce": launches["int8_matmul_reduce"],
            "elementwise_per_batch": ew, "batches": batches,
            "rounds": rounds, "req_per_s_median": float(np.median(
                [r["req_per_s"] for r in rounds])),
            "quant_launches_per_restore": quant_load,
            "weight_bytes": total, "projection_bytes": proj,
            "weight_bytes_bf16": total16, "projection_bytes_bf16": proj16,
            "load_s": load_s, "logit_err": err, "logit_bound": bound,
            "rel_l2_vs_bf16_pool": rel_l2, "argmax_vs_bf16_pool": argmax_bf16,
            "profile": prof}


def kv_quant_case(tq, gen):
    """Kernels 4 and 5 at the decode path's KV shapes (block = head_dim =
    64): one round's write (k and v, [12, 8, 12, 64] fp32 each) and one
    round's gather ([12, 8, 1040, 12, 64] int8 and its scales, k and v),
    bit for bit against the plain versions, timed with their byte bounds."""
    n_w = int(np.prod(KV_WRITE_SHAPE))
    ks = [torch.randn(KV_WRITE_SHAPE, generator=gen, device="cuda") * 3
          for _ in range(2)]
    ks[0][0, 0, 0] = 0.0  # an all-zero head: scale 1
    # One copy 4 bytes past a 16-byte boundary: the kernels' element path.
    off = torch.empty((n_w + 1,), device="cuda")[1:].reshape(KV_WRITE_SHAPE)
    off.copy_(ks[1])
    for x in ks + [off]:
        q, s = tq.quantize_kv_heads(x)
        rq, rs = tq.quantize_kv_heads_reference(x)
        if not (torch.equal(q, rq)
                and torch.equal(s.view(torch.int32), rs.view(torch.int32))):
            raise AssertionError("quantize_kv_heads differs from its plain "
                                 "version")
    if tq.quantize_kv_heads(ks[0])[1][0, 0, 0].item() != 1.0:
        raise AssertionError("an all-zero head's scale is not 1")
    payloads = []
    for _ in range(2):
        q = torch.randint(-127, 128, KV_GATHER_SHAPE, generator=gen,
                          device="cuda", dtype=torch.int8)
        s = torch.rand(KV_GATHER_SHAPE[:-1], generator=gen,
                       device="cuda") * 0.05 + 1e-3
        d = tq.dequantize_kv_heads(q, s)
        rd = tq.dequantize_kv_heads_reference(q, s)
        if not torch.equal(d.view(torch.int32), rd.view(torch.int32)):
            raise AssertionError("dequantize_kv_heads differs from its "
                                 "plain version")
        payloads.append((q, s))
        del d, rd
    torch.cuda.synchronize()
    rec = {"write_shape": list(KV_WRITE_SHAPE),
           "gather_shape": list(KV_GATHER_SHAPE), "bitwise": True}
    write = {
        "ms": time_ms(lambda: [tq.quantize_kv_heads(x) for x in ks]),
        # Two launches of one kernel a call: device_ms times one.
        "device_ms": 2 * device_ms(lambda: tq.quantize_kv_heads(ks[0])),
        "plain_ms": time_ms(lambda: [tq.quantize_kv_heads_reference(x)
                                     for x in ks]),
        "library_ms": None,
    }
    n_g = int(np.prod(KV_GATHER_SHAPE))
    gather = {
        "ms": time_ms(lambda: [tq.dequantize_kv_heads(q, s)
                               for q, s in payloads]),
        "device_ms": 2 * device_ms(
            lambda: tq.dequantize_kv_heads(*payloads[0]), calls=10),
        "plain_ms": time_ms(lambda: [tq.dequantize_kv_heads_reference(q, s)
                                     for q, s in payloads],
                            samples=9, per_sample=3),
        # int8 x fp32 promotes to fp32 in one call: the same function.
        "library_ms": time_ms(lambda: [torch.mul(q, s[..., None])
                                       for q, s in payloads]),
    }
    hd = KV_WRITE_SHAPE[-1]
    for case, n, nbytes in (
            (write, n_w, 2 * (4 * n_w + n_w + 4 * n_w // hd)),
            (gather, n_g, 2 * (n_g + 4 * n_g // hd + 4 * n_g))):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2 * QUANT_OPS * n / FP32_FLOPS_PER_S
        case.update(bytes=nbytes, launches_per_call=2,
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
    rec["write"], rec["gather"] = write, gather
    log(f"[quant] KV heads at block {hd}, k and v, bit for bit: write "
        f"{KV_WRITE_SHAPE} x 2: {write['ms']:.4f} ms by events, "
        f"{write['device_ms']:.4f} device (plain {write['plain_ms']:.4f}), "
        f"bound {write['bound_ms']:.5f} ({write['bound_by']}); gather "
        f"{KV_GATHER_SHAPE} x 2: {gather['ms']:.4f} ms, {gather['device_ms']:.4f} "
        f"device (plain {gather['plain_ms']:.4f}, torch.mul "
        f"{gather['library_ms']:.4f}), bound {gather['bound_ms']:.4f} "
        f"({gather['bound_by']})")
    del ks, off, payloads
    torch.cuda.empty_cache()
    return rec


def _params_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def ckpt_reshard(hvt, kernels, cfg, n_quant_buckets):
    """[ckpt-reshard]: GPT-2 small's ZeRO-1 state saved in its canonical
    form and restored (a) under another fusion threshold, (b) on the int8
    wire with error feedback, continuing the uninterrupted run."""
    from horovod_tpu_torch.parallel import dp

    from horovod_tpu_torch.ops import _build

    fa, fadam, tq = kernels
    t_phase = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="ckpt-", dir=_build.BUILD_DIR)
    hvt.init(backend="nccl")
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1), dtype=np.int64
    )).cuda()

    def build(**kw):
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(sd0)
        step, opt = hvt.make_train_step(
            train_loss(model), hvt.fused_adamw(TRAIN_LR), sharded=True,
            fused_update=True, **kw)
        return step, dp.init_state(model, opt)

    def save(d, state, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = hvt.save_checkpoint(d, state, step=step)
        secs = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).rglob("*")
                     if f.is_file())
        return secs, nbytes

    def restore(d, target):
        t0 = time.perf_counter()
        state = hvt.restore_checkpoint(d, target)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    rec = {}
    # (a) Across fusion thresholds.
    step_a, sa = build(threshold_bytes=CKPT_THRESHOLD)
    for _ in range(2):
        sa, _ = step_a(sa, tokens)
    d_a = str(Path(workdir) / "ckpt-thr")
    save_s, nbytes = save(d_a, sa, 2)
    ref, _ = step_a(sa, tokens)
    ref_params = {k: v.detach().clone() for k, v in ref.params.items()}
    n_saved = len(sa.opt_state.inner.mu.buffers)
    del step_a, sa, ref
    step_b, target = build()
    n_target = len(target.opt_state.inner.mu.buffers)
    restored, restore_s = restore(d_a, target)
    if restored.opt_state.threshold == CKPT_THRESHOLD or len(
            restored.opt_state.inner.mu.buffers) != n_target:
        raise AssertionError("the restore did not take the target's layout")
    got, _ = step_b(restored, tokens)
    diff, excess = 0.0, 0.0
    for k, want in ref_params.items():
        d = (got.params[k].detach() - want).abs()
        diff = max(diff, d.max().item())
        excess = max(excess, (d - (CKPT_ATOL + CKPT_RTOL * want.abs()))
                     .max().item())
    rec["thresholds"] = {
        "threshold_saved": CKPT_THRESHOLD, "buckets_saved": n_saved,
        "buckets_target": n_target, "max_abs_diff": diff,
        "checkpoint_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
    }
    log(f"[ckpt-reshard] across thresholds: saved at {CKPT_THRESHOLD} bytes "
        f"({n_saved} buckets) after 2 steps, restored at the default "
        f"({n_target} buckets), one step on: max |d| {diff:.3e} against the "
        f"uninterrupted run (tolerance rtol {CKPT_RTOL}, atol {CKPT_ATOL}); "
        f"checkpoint {nbytes} bytes, save {save_s:.2f} s, restore "
        f"{restore_s:.2f} s")
    if n_saved == n_target or excess > 0:
        raise AssertionError(f"[ckpt-reshard] thresholds: {rec['thresholds']}")
    del step_b, target, restored, got, ref_params
    torch.cuda.empty_cache()

    # (b) The int8 wire with error feedback, continued bit for bit.
    int8 = hvt.Compression.int8.with_block(QUANT_BLOCK)
    step_q, sq = build(compression=int8)
    for _ in range(2):
        sq, _ = step_q(sq, tokens)
    d_b = str(Path(workdir) / "ckpt-int8")
    save_s, nbytes = save(d_b, sq, 2)
    want_losses = []
    for _ in range(2):
        sq, loss = step_q(sq, tokens)
        want_losses.append(float(loss))
    step_r, target = build(compression=int8)
    restored, restore_s = restore(d_b, target)
    reset_counts(fa, fadam, tq)
    got_losses = []
    for _ in range(2):
        restored, loss = step_r(restored, tokens)
        got_losses.append(float(loss))
    counts = read_counts(fa, fadam, tq)
    same = (got_losses == want_losses
            and _params_equal(sq.params, restored.params)
            and all(torch.equal(a, b) for a, b in zip(
                sq.opt_state.inner.mu.buffers + sq.opt_state.inner.nu.buffers
                + sq.opt_state.residual.buffers,
                restored.opt_state.inner.mu.buffers
                + restored.opt_state.inner.nu.buffers
                + restored.opt_state.residual.buffers)))
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers, "fused_adamw": n_quant_buckets,
            "quantize_blockwise": 2 * n_quant_buckets,
            "dequantize_blockwise": 2 * n_quant_buckets}
    rec["int8"] = {"losses": got_losses, "bitwise": same, "launches": counts,
                   "checkpoint_bytes": nbytes, "save_s": save_s,
                   "restore_s": restore_s}
    log(f"[ckpt-reshard] int8 wire (block {QUANT_BLOCK}, error feedback): "
        f"saved after 2 steps, restored, 2 steps on: losses {got_losses} vs "
        f"{want_losses} uninterrupted, parameters, moments and residuals "
        f"bit for bit: {same}; checkpoint {nbytes} bytes, save {save_s:.2f} "
        f"s, restore {restore_s:.2f} s; launches over the 2 resumed steps "
        f"{counts}")
    if not same:
        raise AssertionError("[ckpt-reshard] the resumed int8 run left the "
                             "uninterrupted one")
    for name, per_step in want.items():
        if counts[name] != 2 * per_step:
            raise AssertionError(f"[ckpt-reshard] {name} launched "
                                 f"{counts[name]} times in 2 steps, not "
                                 f"{per_step} a step")
    del step_q, sq, step_r, target, restored
    hvt.shutdown()
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[ckpt-reshard] phase wall {rec['wall_s']:.1f} s")
    return rec


class CountingModel:
    """A decode model whose ``extend`` calls are counted (the launches a
    call are held against them)."""

    def __init__(self, model):
        self.model, self.calls = model, 0
        self.n_layers = model.n_layers
        self.n_heads, self.head_dim = model.n_heads, model.head_dim

    def extend(self, *args):
        self.calls += 1
        return self.model.extend(*args)


def top2_margin(rows):
    """(argmax, top-2 margin, max |logit|) of each row of ``rows``."""
    top = rows.topk(2, dim=-1).values
    return (rows.argmax(dim=-1), top[..., 0] - top[..., 1],
            rows.abs().amax(dim=-1))


def cached_step(model, params, pool, contexts, feeds=None):
    """Prefill ``contexts`` (token lists) into fresh tables of ``pool``,
    then one decode step feeding ``feeds`` (default: each context's greedy
    next token). Returns (the prefill's logits at each context's last
    token, the decode step's logits), ``[R, vocab]`` each."""
    r = len(contexts)
    width = max(len(c) for c in contexts)
    m = -(-(width + 1) // pool.block_size)
    toks = torch.zeros((r, width), dtype=torch.int32, device="cuda")
    for i, c in enumerate(contexts):
        toks[i, :len(c)] = torch.tensor(c, dtype=torch.int32)
    zeros = torch.zeros((r,), dtype=torch.int32, device="cuda")
    scratch = torch.full((r, m), pool.n_blocks, dtype=torch.int64,
                         device="cuda")
    logits, k_new, v_new = model.extend(params, toks, zeros, scratch, zeros,
                                        *pool.device_args())
    lens = torch.tensor([len(c) for c in contexts], device="cuda")
    last = logits[torch.arange(r, device="cuda"), lens - 1]
    if feeds is None:
        feeds = last.argmax(dim=-1).tolist()
    rows = np.full((r, m), pool.n_blocks, np.int64)
    for i, c in enumerate(contexts):
        t = pool.new_table()
        t.ensure(len(c) + 1)
        pool.write(t.flat_slots(0, len(c)), k_new[i, :len(c)],
                   v_new[i, :len(c)])
        rows[i] = t.padded_blocks(m)
    step, _, _ = model.extend(
        params, torch.tensor(feeds, dtype=torch.int32, device="cuda")[:, None],
        lens.int(), torch.from_numpy(rows).cuda(), lens.int(),
        *pool.device_args())
    return last, step[:, 0]


def recompute_check(model, params, prompts, outs):
    """The engine's greedy tokens against a from-scratch forward over
    prompt + generated tokens (each step's logits from the engine's own
    prefix): a token may differ only where the recomputed top-2 margin is
    below DECODE_MARGIN x max |logit|. Returns the divergent steps."""
    from horovod_tpu_torch.serve import KVBlockPool

    pool = KVBlockPool(1, DECODE_BLOCK, n_layers=model.n_layers,
                       n_heads=model.n_heads, head_dim=model.head_dim,
                       device="cuda")
    allowed = []
    for i, (prompt, gen) in enumerate(zip(prompts, outs)):
        toks = torch.tensor([prompt + gen[:-1]], dtype=torch.int32,
                            device="cuda")
        zero = torch.zeros((1,), dtype=torch.int32, device="cuda")
        scratch = torch.full((1, 1), pool.n_blocks, dtype=torch.int64,
                             device="cuda")
        logits, _, _ = model.extend(params, toks, zero, scratch, zero,
                                    *pool.device_args())
        n = len(prompt)
        pred, margin, amax = top2_margin(logits[0, n - 1:n - 1 + len(gen)])
        for j in (pred.cpu() != torch.tensor(gen)).nonzero()[:, 0].tolist():
            rel = margin[j].item() / amax[j].item()
            if rel >= DECODE_MARGIN:
                raise AssertionError(
                    f"[decode] stream {i} step {j}: the engine's token "
                    f"{gen[j]} is not the recompute's {pred[j].item()} "
                    f"(top-2 margin {rel:.3e} of max |logit|)")
            allowed.append([i, j, rel])
            log(f"[decode] stream {i} step {j}: a near-tie (top-2 margin "
                f"{rel:.3e} of max |logit|) decided otherwise")
    return allowed


def first_divergence(tag, model, params, prompts, want, got):
    """Streams of ``got`` that part from the reference run's ``want``: at
    the first difference the int8-KV logits that decided it (the prefix
    prefilled into an int8 pool, one decode step) must have a top-2 margin
    below DECODE_MARGIN x max |logit|. Returns the near-ties."""
    from horovod_tpu_torch.serve import KVBlockPool

    allowed = []
    for i, (a, b) in enumerate(zip(want, got)):
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            if len(a) != len(b):
                raise AssertionError(f"[{tag}] stream {i} lengths differ")
            continue
        pool = KVBlockPool(-(-DECODE_MAX_SEQ // DECODE_BLOCK), DECODE_BLOCK,
                           n_layers=model.n_layers, n_heads=model.n_heads,
                           head_dim=model.head_dim, kv_dtype="int8",
                           device="cuda")
        ctx = prompts[i] + a[:k - 1] if k else prompts[i]
        last, step = cached_step(model, params, pool, [ctx],
                                 [a[k - 1]] if k else None)
        _, margin, amax = top2_margin(step[0] if k else last[0])
        rel = margin.item() / amax.item()
        if rel >= DECODE_MARGIN:
            raise AssertionError(
                f"[{tag}] stream {i}: token {b[k]} at step {k} where the "
                f"reference run has {a[k]} (top-2 margin {rel:.3e})")
        allowed.append([i, k, rel])
        log(f"[{tag}] stream {i} step {k}: a near-tie (top-2 margin "
            f"{rel:.3e} of max |logit|) decided otherwise")
    return allowed


def decode_run(tq, model, params, prompts, *, label, kv_dtype, spec_k=0,
               draft=None, profile=False):
    """One closed-loop load (bench_decode's: rows x 2 clients, each
    submitting its streams one after another) through a fresh engine."""
    from horovod_tpu_torch.serve import DecodeEngine

    counting = CountingModel(model)
    eng = DecodeEngine(
        counting, params, draft_model=counting if spec_k else None,
        draft_params=draft, workers=1, rows=DECODE_ROWS,
        kv_blocks=DECODE_KV_BLOCKS, kv_block_size=DECODE_BLOCK,
        max_seq_len=DECODE_MAX_SEQ, kv_dtype=kv_dtype, spec_k=spec_k,
        device="cuda").start()
    try:
        # Off the clock: cuBLAS and the allocator meet every shape once.
        eng.submit(prompts[0], 8).result(timeout=600.0)
        torch.cuda.synchronize()
        r0, f0 = eng.n_rounds, eng.fill_sum
        p0, a0 = eng.n_proposed, eng.n_accepted
        counting.calls = 0
        tq.reset_launches()
        futs = [None] * len(prompts)
        clients = DECODE_ROWS * 2

        def client(k):
            for i in range(k, len(prompts), clients):
                futs[i] = eng.submit(prompts[i], DECODE_NEW)
                futs[i].result(timeout=600.0)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        counts = {"quantize_blockwise": tq.launches_quant,
                  "dequantize_blockwise": tq.launches_dequant,
                  "extend_calls": counting.calls}
        outs = [f.result() for f in futs]
        ttft = [(f.first_token_t - f.submit_t) * 1e3 for f in futs]
        tpot = [(b - a) * 1e3 for f in futs
                for a, b in zip(f.token_times(), f.token_times()[1:])]
        n_tokens = sum(len(o) for o in outs)
        rounds = eng.n_rounds - r0
        rec = {
            "run": label, "kv_dtype": kv_dtype or "fp32", "spec_k": spec_k,
            "streams": len(outs), "tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            **{f"ttft_p{q}_ms": float(np.percentile(ttft, q))
               for q in (50, 95, 99)},
            **{f"tpot_p{q}_ms": float(np.percentile(tpot, q))
               for q in (50, 95, 99)},
            "rounds": rounds,
            "mean_batch_fill": (eng.fill_sum - f0) / rounds,
            "requeued": eng.n_requeued, "preempted": eng.n_preempted,
            "accept_rate": ((eng.n_accepted - a0) / (eng.n_proposed - p0)
                            if spec_k else None),
            "kv_bytes_per_token": eng.pools()[0].bytes_per_token(),
            "launches": counts,
        }
        log(f"[decode] {label}: {json.dumps(rec)}")
        if profile:
            rec["profile"] = decode_window(eng, prompts[:DECODE_ROWS], label)
    finally:
        eng.stop()
    want = 2 * counts["extend_calls"] if kv_dtype == "int8" else 0
    if not (counts["quantize_blockwise"] == counts["dequantize_blockwise"]
            == want):
        raise AssertionError(f"[decode] {label}: {counts}, not {want} "
                             f"quantize and dequantize launches")
    if any(len(o) != DECODE_NEW for o in outs):
        raise AssertionError(f"[decode] {label}: a stream fell short")
    return rec, outs


def decode_window(eng, prompts, label):
    """A profiled window of decode rounds: the streams admitted (their
    prefill off the window), then profiled until every one has finished.
    The tracer comes up in the warm-up step of a schedule, before the
    streams are submitted, while no thread launches work: brought up in
    the middle of the worker's rounds, it crashed the process at the
    window's end in 3 of 7 runs (a native thread, in the profiler's stop;
    H100 80GB HBM3, torch 2.11.0+cu128). Only the active step, the rounds,
    is reported."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        pf = [eng.submit(p, 48) for p in prompts]
        while not all(f.tokens_so_far() for f in pf):
            time.sleep(0.001)
        extra = {"run": label, "rounds": -eng.n_rounds}
        prof.step()
        t0 = time.perf_counter()
        for f in pf:
            f.result(timeout=600.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        extra["rounds"] += eng.n_rounds
        prof.step()
    return device_breakdown(prof, wall_ms, extra)


def decode(hvt, tq):
    """[decode]: CacheLM at GPT-2-small width through DecodeEngine, fp32
    KV, int8 KV, and int8 KV with speculation."""
    from horovod_tpu_torch.serve import (CacheLM, CacheLMConfig, KVBlockPool,
                                         perturbed_params)

    t_phase = time.perf_counter()
    cfg = CacheLMConfig(**DECODE_CFG)
    model = CacheLM(cfg, block_size=DECODE_BLOCK)
    params = model.init_params(0)
    draft = perturbed_params(params, 0.02)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=rng.randint(
        DECODE_PROMPT[0], DECODE_PROMPT[1] + 1)).tolist()
        for _ in range(DECODE_STREAMS)]
    log(f"[decode] CacheLM {DECODE_CFG}, fp32 params from init_params(0); "
        f"engine rows {DECODE_ROWS}, 1 worker, kv_blocks {DECODE_KV_BLOCKS} "
        f"of {DECODE_BLOCK}, max_seq_len {DECODE_MAX_SEQ}; {DECODE_STREAMS} "
        f"streams of {DECODE_NEW} new tokens, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{DECODE_ROWS * 2} clients")
    rec = {}
    rec["fp32"], fp32_outs = decode_run(tq, model, params, prompts,
                                        label="fp32 KV", kv_dtype="")
    rec["int8"], int8_outs = decode_run(tq, model, params, prompts,
                                        label="int8 KV", kv_dtype="int8",
                                        profile=True)
    rec["spec"], spec_outs = decode_run(tq, model, params, prompts,
                                        label="int8 KV, spec_k 3",
                                        kv_dtype="int8", spec_k=3,
                                        draft=draft)
    with torch.inference_mode():
        rec["recompute_near_ties"] = recompute_check(
            model, params, prompts[:4], fp32_outs[:4])
        # The speculative run's tokens against the non-speculative int8
        # run's.
        rec["spec_near_ties"] = first_divergence("decode", model, params,
                                                 prompts, int8_outs,
                                                 spec_outs)
        pools = {kv: KVBlockPool(DECODE_KV_BLOCKS, DECODE_BLOCK,
                                 n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                                 head_dim=cfg.head_dim, kv_dtype=kv,
                                 device="cuda") for kv in ("", "int8")}
        last, fp = cached_step(model, params, pools[""],
                               prompts[:DECODE_ROWS])
        feeds = last.argmax(dim=-1).tolist()
        _, q8 = cached_step(model, params, pools["int8"],
                            prompts[:DECODE_ROWS], feeds)
    bound = KV_LOGIT_TOL * fp.abs().max().item()
    err = (q8 - fp).abs().max().item()
    ref_arg, margin, _ = top2_margin(fp)
    decided = margin > bound
    same = bool((q8.argmax(dim=-1) == ref_arg)[decided].all())
    rec["int8_vs_fp32"] = {"max_abs_diff": err, "bound": bound,
                           "argmax_equal_where_decided": same,
                           "decided_rows": int(decided.sum())}
    log(f"[decode] first decode step, int8 vs fp32 KV over "
        f"{DECODE_ROWS} prompts: max |d logits| {err:.4e} (bound {bound:.4e}"
        f" = {KV_LOGIT_TOL} max |logit|), argmax equal on the "
        f"{int(decided.sum())} rows whose top-2 margin exceeds it: {same}")
    if err > bound or not same:
        raise AssertionError(f"[decode] int8 KV: {rec['int8_vs_fp32']}")
    log(f"[decode] the fp32 run's first 4 streams equal the full recompute "
        f"(near-ties {rec['recompute_near_ties']}); the speculative run's "
        f"equal the int8 run's (near-ties {rec['spec_near_ties']})")
    del pools, params, draft
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[decode] phase wall {rec['wall_s']:.1f} s")
    return rec


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def grads_rel_l2(a, b) -> float:
    num = sum(float((a[n] - b[n]).float().norm()) ** 2 for n in b)
    den = sum(float(b[n].float().norm()) ** 2 for n in b)
    return (num / den) ** 0.5


def check_counts(tag, counts, want, steps):
    for name, per_step in want.items():
        if counts[name] != per_step * steps:
            raise AssertionError(
                f"[{tag}] {name} launched {counts[name]} times in {steps} "
                f"steps, not {per_step} a step")


def timed_steps(step, state, batch_fn, steps, losses):
    """``steps`` steps, each timed between synchronizations with its
    ``batch_fn(i)`` inside the window (an input pipeline's host time and
    stall count in the step); appends each loss; returns the state and the
    step times in ms."""
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch_fn(i))
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, times


def check_falling(tag, losses):
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}")


def bucket_sizes(state):
    """Elements of each ZeRO-1 shard the fused AdamW updates a step."""
    return [b.numel() for b in state.opt_state.inner.mu.buffers]


def n_buckets(state) -> int:
    return len(bucket_sizes(state))


def bert_losses(hvt, model):
    """The chunked MLM loss (fused_cross_entropy on return_hidden, against
    mlm_decoder) and the full-logit one (F.cross_entropy on the fp32
    logits, weighted the same), through the parameter dict."""
    import torch.nn.functional as F

    def chunked(params, b):
        h = torch.func.functional_call(
            model, params, (b["tokens"],),
            {"attention_mask": b.get("mask"), "return_hidden": True})
        return hvt.fused_cross_entropy(
            h, params["mlm_decoder.weight"].t(), b["targets"],
            bias=params["mlm_decoder.bias"], weights=b["weights"])

    def full(params, b):
        logits = torch.func.functional_call(
            model, params, (b["tokens"],), {"attention_mask": b.get("mask")})
        per = F.cross_entropy(logits.flatten(0, 1), b["targets"].flatten(),
                              reduction="none")
        w = b["weights"].flatten()
        return (per * w).sum() / w.sum()

    return chunked, full


def train_bert(hvt, kernels):
    """[train-bert]: BERT-base MLM at bench_bert's shape (32 x 512) through
    make_train_step(sharded=True, fused_update=True) with the chunked loss,
    held against the full-logit plain path, then timed; 2 masked steps."""
    from horovod_tpu_torch.obs import flops
    from horovod_tpu_torch.parallel import dp

    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    cfg = hvt.BertConfig.base(param_dtype=torch.float32)
    sd0 = hvt.convert.init_bert_params(cfg, seed=0)
    rng = np.random.default_rng(5)
    b, s = BERT_BATCH, cfg.max_len
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))),
        "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))),
        "weights": torch.from_numpy(
            (rng.random((b, s)) < BERT_MLM_SHARE).astype(np.float32)),
    }
    batch = {k: v.cuda() for k, v in batch.items()}
    n_matmul = sum(v.numel() for k, v in sd0.items()
                   if not k.startswith(("encoder.wte", "encoder.wpe",
                                        "encoder.wtt")))
    tokens_per_step = b * s
    flops_per_step = tokens_per_step * flops.transformer_flops_per_token(
        n_matmul, cfg.n_layers, s, cfg.d_model)

    def build(use_flash):
        model = hvt.BertModel(dataclasses.replace(cfg, use_flash=use_flash))
        model.load_state_dict(sd0)
        return model

    model_k = build(None)
    chunked_k, full_k = bert_losses(hvt, model_k)
    params_k = dict(model_k.named_parameters())
    # The two losses on the same model (flash path): peak memory of each
    # gradient, and the losses on the same hidden states.
    rec = {}
    for name, fn in (("full", full_k), ("full_again", full_k),
                     ("chunked", chunked_k)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _, grads = dp.accumulate_gradients(fn, params_k, batch, 1)
        torch.cuda.synchronize()
        rec[name] = {"loss": float(loss), "peak_gib": peak_gib(),
                     "grads": grads}
    same_rel = abs(rec["chunked"]["loss"] - rec["full"]["loss"]) / abs(
        rec["full"]["loss"])
    same_grad = grads_rel_l2(rec["chunked"]["grads"], rec["full"]["grads"])
    repeat = grads_rel_l2(rec["full_again"]["grads"], rec["full"]["grads"])
    log(f"[train-bert] the full-logit gradient computed twice: relative L2 "
        f"{repeat:.3e}; largest per-parameter differences, repeat "
        f"{top_diffs(rec['full_again']['grads'], rec['full']['grads'])}, "
        f"chunked vs full "
        f"{top_diffs(rec['chunked']['grads'], rec['full']['grads'])}")
    log(f"[train-bert] flash path, chunked vs full-logit loss: "
        f"{rec['chunked']['loss']:.6f} vs {rec['full']['loss']:.6f} "
        f"(relative {same_rel:.3e}, tol {BERT_SAME_TOL}); gradients relative "
        f"L2 {same_grad:.3e} (tol {BERT_SAME_GRAD_TOL}); peak memory of the gradient: chunked "
        f"{rec['chunked']['peak_gib']:.3f} GiB, full logits "
        f"{rec['full']['peak_gib']:.3f} GiB (saved "
        f"{rec['full']['peak_gib'] - rec['chunked']['peak_gib']:.3f} GiB)")
    if not same_rel <= BERT_SAME_TOL or not same_grad <= BERT_SAME_GRAD_TOL:
        raise AssertionError("the chunked loss disagrees with full logits")
    grads_k = rec["chunked"]["grads"]
    del rec["full"]["grads"], rec["chunked"]["grads"], rec["full_again"]

    # The kernel path (chunked loss, flash) against the plain path (full
    # logits, plain attention), from the same start.
    model_p = build(False)
    _, full_p = bert_losses(hvt, model_p)
    params_p = dict(model_p.named_parameters())
    torch.cuda.reset_peak_memory_stats()
    loss_p, _, grads_p = dp.accumulate_gradients(full_p, params_p, batch, 1)
    plain_peak = peak_gib()
    cross_rel = abs(rec["chunked"]["loss"] - float(loss_p)) / abs(
        float(loss_p))
    grad_rel = grads_rel_l2(grads_k, grads_p)
    log(f"[train-bert] kernel path (chunked loss) vs plain path (full "
        f"logits, plain attention): loss {rec['chunked']['loss']:.6f} vs "
        f"{float(loss_p):.6f} (relative {cross_rel:.3e}, tol "
        f"{BERT_LOSS_RTOL}); gradients relative L2 {grad_rel:.3e} (tol "
        f"{STEP_GRAD_TOL}); plain path peak {plain_peak:.3f} GiB")
    if not cross_rel <= BERT_LOSS_RTOL or not grad_rel <= STEP_GRAD_TOL:
        raise AssertionError("[train-bert] kernel path disagrees with plain")
    del grads_k, grads_p, model_p, params_p
    torch.cuda.empty_cache()

    step, opt = hvt.make_train_step(
        chunked_k, hvt.fused_adamw(TRAIN_LR), sharded=True, fused_update=True,
        tokens_per_step=tokens_per_step, flops_per_step=flops_per_step)
    state = dp.init_state(model_k, opt)
    sizes = bucket_sizes(state)
    buckets = len(sizes)
    losses = []
    state, _ = timed_steps(step, state, lambda i: batch, BERT_WARMUP, losses)
    reset_counts(*kernels)
    torch.cuda.reset_peak_memory_stats()
    state, times = timed_steps(step, state, lambda i: batch, BERT_STEPS,
                               losses)
    counts = read_counts(*kernels)
    step_peak = peak_gib()
    log(f"[train-bert] losses {losses}")
    log(f"[train-bert] launches over {BERT_STEPS} steps: {counts} "
        f"({buckets} buckets)")
    check_counts("train-bert", counts, {
        "flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
        "flash_bwd_dq": cfg.n_layers, "fused_adamw": buckets}, BERT_STEPS)
    check_falling("train-bert", losses)
    step_ms = float(np.median(times))
    tp = step.throughput(step_ms / 1e3)
    log(f"[train-bert] step median {step_ms:.3f} ms (min {min(times):.3f}, "
        f"max {max(times):.3f}); {tp['tokens_per_s']:.1f} tokens/s; MFU "
        f"{tp['mfu']}; peak memory {step_peak:.3f} GiB")

    # A padding mask (the last quarter of each row): plain attention, so no
    # flash launch.
    masked = dict(batch, mask=torch.ones_like(batch["tokens"]))
    masked["mask"][:, s - s // 4:] = 0
    reset_counts(*kernels)
    mlosses = []
    state, mtimes = timed_steps(step, state, lambda i: masked, 2, mlosses)
    mcounts = read_counts(*kernels)
    log(f"[train-bert] 2 masked steps: losses {mlosses}, {mtimes} ms, "
        f"launches {mcounts}")
    check_counts("train-bert masked", mcounts, {
        "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
        "fused_adamw": buckets}, 2)
    if not all(np.isfinite(mlosses)):
        raise AssertionError(f"[train-bert] masked losses {mlosses}")
    hvt.shutdown()
    del model_k, step, state
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[train-bert] phase wall {wall:.1f} s")
    return {"launches": counts, "launches_masked": mcounts,
            "losses": losses, "masked_losses": mlosses, "step_ms": step_ms,
            "step_ms_all": times, "tokens_per_s": tp["tokens_per_s"],
            "mfu": tp["mfu"], "peak_gib": step_peak,
            "grad_peak_gib_chunked": rec["chunked"]["peak_gib"],
            "grad_peak_gib_full": rec["full"]["peak_gib"],
            "grad_peak_gib_plain_path": plain_peak,
            "loss_rel_same_model": same_rel, "grad_rel_same_model": same_grad,
            "grad_rel_repeat": repeat,
            "loss_rel_vs_plain": cross_rel, "grad_rel_vs_plain": grad_rel,
            "bucket_sizes": sizes, "wall_s": wall}


def top_diffs(a, b, k=4):
    """The ``k`` parameters whose gradients differ most, relative to each
    one's own norm, as ``[[name, relative L2], ...]``."""
    rel = {n: float((a[n] - b[n]).float().norm()
                    / b[n].float().norm().clamp_min(1e-30)) for n in b}
    return [[n, r] for n, r in sorted(rel.items(), key=lambda kv: -kv[1])[:k]]


def max_abs_diff(a, b) -> float:
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in b)


def train_remat(hvt, kernels):
    """[train-remat]: GPT-2 small at 32 x 1024 (the JAX bench's default),
    one step each with remat none, dots_saveable and full, per block
    (TransformerConfig.remat) and over the loss (make_train_step(remat=)),
    from one start; then the chunked-loss pair at [train]'s batch 8."""
    from horovod_tpu_torch.parallel import dp

    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    cfg0 = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg0, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg0.vocab_size, (REMAT_BATCH, cfg0.max_len + 1),
        dtype=np.int64)).cuda()
    runs = {}
    ref = None
    for form, remat in (("none", "none"), ("block", "dots_saveable"),
                        ("block", "full"), ("loss", "dots_saveable"),
                        ("loss", "full")):
        key = remat if form == "none" else f"{form}/{remat}"
        cfg = dataclasses.replace(
            cfg0, remat=remat if form == "block" else False)
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(sd0)
        loss_fn = train_loss(model)
        step, opt = hvt.make_train_step(
            loss_fn, hvt.fused_adamw(TRAIN_LR), sharded=True,
            fused_update=True, remat=remat if form == "loss" else "none")
        # The state trains copies, not the module's own parameters: a
        # block's recompute must read what the step differentiates.
        state = dp.init_state({n: p.detach().clone()
                               for n, p in model.named_parameters()}, opt)
        grad_fn = hvt.checkpoint_fn(loss_fn, remat if form == "loss"
                                    else "none")
        grads = dp.accumulate_gradients(grad_fn, state.params, tokens, 1)[2]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        losses = []
        state, times = timed_steps(step, state, lambda i: tokens, 1, losses)
        params = {n: p.detach().clone() for n, p in state.params.items()}
        # Two more steps, timed (the first step of a trainer also pays for
        # its allocations).
        state, times = timed_steps(step, state, lambda i: tokens,
                                   REMAT_STEPS - 1, losses)
        counts = read_counts(*kernels)
        peak = peak_gib()
        final = {n: p.detach().clone() for n, p in state.params.items()}
        run = {"loss": losses[0], "losses": losses,
               "step_ms": float(np.median(times)), "step_ms_all": times,
               "peak_gib": peak, "launches": counts}
        if ref is None:
            ref = {"grads": grads, "params": params, "final": final}
        else:
            gbit = all(torch.equal(grads[n], ref["grads"][n]) for n in grads)
            pbit = all(torch.equal(params[n], ref["params"][n])
                       for n in params)
            run.update(grads_bitwise=gbit, params_bitwise=pbit,
                       grads_max_abs_diff=max_abs_diff(grads, ref["grads"]),
                       params_max_abs_diff=max_abs_diff(params,
                                                        ref["params"]))
            if not (gbit and pbit):
                rel = grads_rel_l2(grads, ref["grads"])
                run["grads_rel_l2"] = rel
                run["grads_top_diffs"] = top_diffs(grads, ref["grads"])
                log(f"[train-remat] {key}: not bit for bit with none (max "
                    f"|d| gradients {run['grads_max_abs_diff']:.3e}, "
                    f"parameters {run['params_max_abs_diff']:.3e}; largest "
                    f"{run['grads_top_diffs']}); held to [train]'s bound, "
                    f"gradients relative L2 {rel:.3e} (tol {STEP_GRAD_TOL})")
                if not rel <= STEP_GRAD_TOL:
                    raise AssertionError(f"[train-remat] {key} gradients")
            # After all REMAT_STEPS steps: bit for bit where the first step
            # was, else within [train]'s per-step bound summed over them.
            fbit = all(torch.equal(final[n], ref["final"][n]) for n in final)
            run.update(final_params_bitwise=fbit,
                       final_params_max_abs_diff=max_abs_diff(
                           final, ref["final"]))
            wd = hvt.fused_adamw(TRAIN_LR).fused_spec.weight_decay
            within = all(bool(((final[n] - r).abs() <= REMAT_STEPS * (
                2 * TRAIN_LR * (1 + wd * r.abs())) + 1e-6).all())
                for n, r in ref["final"].items())
            if not (fbit if gbit and pbit else within):
                raise AssertionError(
                    f"[train-remat] {key}: the parameters after "
                    f"{REMAT_STEPS} steps differ from none's (max |d| "
                    f"{run['final_params_max_abs_diff']:.3e})")
            del grads
        want_fwd = cfg0.n_layers * (1 if remat == "none" else 2)
        check_counts("train-remat " + key, counts, {
            "flash_fwd": want_fwd, "flash_bwd_dkdv": cfg0.n_layers,
            "flash_bwd_dq": cfg0.n_layers, "fused_adamw": n_buckets(state)},
            REMAT_STEPS)
        log(f"[train-remat] {key}: losses {losses}; step (median of the "
            f"last {REMAT_STEPS - 1}) {run['step_ms']:.3f} ms; peak "
            f"{peak:.3f} GiB; launches over {REMAT_STEPS} steps "
            f"{counts}; bit for bit with none: "
            f"{run.get('grads_bitwise', True)} (gradients), "
            f"{run.get('params_bitwise', True)} (parameters), "
            f"{run.get('final_params_bitwise', True)} (parameters after "
            f"{REMAT_STEPS} steps)")
        runs[key] = run
        del model, step, state, params, final
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()

    # The chunked-loss pair at [train]'s batch 8 (ROADMAP A4's chip gate):
    # fused_cross_entropy on the hidden states and wte.T against
    # F.cross_entropy on the tied head's logits, each one gradient.
    model = hvt.GPT2LMModel(cfg0)
    model.load_state_dict(sd0)
    params = dict(model.named_parameters())
    tok8 = tokens[:TRAIN_BATCH]

    def chunked(p, t):
        h = torch.func.functional_call(model, p, (t[:, :-1],),
                                       {"return_hidden": True})
        return hvt.fused_cross_entropy(h, p["transformer.wte.weight"].t(),
                                       t[:, 1:])

    pair = {}
    for name, fn in (("full", train_loss(model)), ("chunked", chunked)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loss, _, g = dp.accumulate_gradients(fn, params, tok8, 1)
        torch.cuda.synchronize()
        pair[name] = {"loss": float(loss), "peak_gib": peak_gib()}
        del g
    rel = abs(pair["chunked"]["loss"] - pair["full"]["loss"]) / abs(
        pair["full"]["loss"])
    pair["loss_rel"] = rel
    log(f"[train-remat] chunked loss at batch 8: {pair['chunked']['loss']:.6f}"
        f" vs F.cross_entropy on the tied head's bf16 logits "
        f"{pair['full']['loss']:.6f} (relative {rel:.3e}, tol "
        f"{GPT2_CHUNK_RTOL}); gradient peak {pair['chunked']['peak_gib']:.3f}"
        f" vs {pair['full']['peak_gib']:.3f} GiB")
    if not rel <= GPT2_CHUNK_RTOL:
        raise AssertionError("[train-remat] the chunked loss disagrees")
    hvt.shutdown()
    del model, params
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[train-remat] phase wall {wall:.1f} s")
    return {"runs": runs, "chunked_pair": pair, "wall_s": wall}


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


class RouteRecorder:
    """Records every MoE layer's top-1 expert of each token, and whether the
    token was kept (within its expert's capacity), while installed in place
    of models.moe.top1_dispatch."""

    def __init__(self, moe_mod):
        self.mod = moe_mod
        self.orig = moe_mod.top1_dispatch
        self.routes = []

    def __enter__(self):
        def rec(logits, capacity):
            out = self.orig(logits, capacity)
            self.routes.append((logits.argmax(-1), out[0].sum((1, 2)) > 0))
            return out
        self.mod.top1_dispatch = rec
        return self

    def __exit__(self, *exc):
        self.mod.top1_dispatch = self.orig


def zoo_model(hvt, name):
    """The full-width zoo model ``name`` in bf16 compute with fp32 master
    weights, and its seeded state dict."""
    if name == "vit":
        cfg = hvt.ViTConfig.large(param_dtype=torch.float32)
        return hvt.ViT(cfg), hvt.convert.init_vit_params(cfg, seed=0)
    if name == "moe":
        cfg = hvt.MoEConfig(param_dtype=torch.float32)
        return (hvt.SwitchTransformerLM(cfg),
                hvt.convert.init_moe_params(cfg, seed=0))
    model = hvt.ResNet50(num_classes=1000)
    return model, hvt.convert.init_resnet_params(model, seed=0)


def zoo_reference(hvt, name, sd):
    """The same model in fp32 with plain attention."""
    if name == "vit":
        m = hvt.ViT(hvt.ViTConfig.large(dtype=torch.float32, use_flash=False))
    elif name == "moe":
        m = hvt.SwitchTransformerLM(hvt.MoEConfig(dtype=torch.float32,
                                                  use_flash=False))
    else:
        m = hvt.ResNet50(num_classes=1000, dtype=torch.float32)
    m.load_state_dict(sd)
    return m


def zoo_check(hvt, name, model, sd, inputs):
    """One forward of ``model`` against the fp32 plain-attention model."""
    from horovod_tpu_torch.models import moe as moe_mod

    ref = zoo_reference(hvt, name, sd)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad(), RouteRecorder(moe_mod) as routes:
        got = model(inputs)
        want = ref(inputs)
    model.load_state_dict(buffers, strict=False)  # undo BatchNorm updates
    out = {}
    if name == "moe":
        (got, aux), (want, aux_ref) = got, want
        n = len(routes.routes) // 2
        agree = torch.ones_like(routes.routes[0][1])
        for (ea, ka), (eb, kb) in zip(routes.routes[:n], routes.routes[n:]):
            agree &= (ea == eb) & (ka == kb)
        agree = agree.reshape(got.shape[:2])
        out["route_agreement"] = float(agree.float().mean())
        out["aux"], out["aux_ref"] = float(aux), float(aux_ref)
        out["aux_rel"] = abs(float(aux) - float(aux_ref)) / abs(
            float(aux_ref))
        out["rel_l2_all"] = rel_l2(got, want)
        got, want = got[agree], want[agree]
    out["rel_l2"] = rel_l2(got, want)
    out["max_abs"] = float((got.float() - want.float()).abs().max())
    out["max_ref"] = float(want.float().abs().max())
    del ref
    torch.cuda.empty_cache()
    log(f"[zoo] {name}: bf16 kernel path vs fp32 plain attention, one "
        f"forward: {json.dumps(out)} (tol: relative L2 "
        + (f"{MOE_TOL} on the tokens routed alike (expert and capacity) in "
           f"every MoE layer, at least {MOE_ROUTE_AGREE} of them; aux "
           f"within {ZOO_TOL} relative)" if name == "moe"
           else f"{ZOO_TOL})"))
    tol = MOE_TOL if name == "moe" else ZOO_TOL
    bad = not out["rel_l2"] <= tol
    if name == "moe":
        bad |= not (out["route_agreement"] >= MOE_ROUTE_AGREE
                    and out["aux_rel"] <= ZOO_TOL)
    if bad:
        raise AssertionError(f"[zoo] {name} disagrees with fp32")
    return out


def zoo(hvt, kernels):
    """[zoo]: ViT-L/16 at 224 (batch 32, fed by ShardedBatches and
    prefetch_to_device), ResNet-50 at 224 (batch 64, channels_last, bf16,
    BatchNorm statistics updated) and the Switch MoE at 8 x 1024, 3 steps
    each through the ZeRO-1 fused step on the one-rank NCCL world."""
    import torch.nn.functional as F

    from horovod_tpu_torch.parallel import dp

    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    rng = np.random.default_rng(11)
    out = {}
    for name in ("vit", "resnet", "moe"):
        t0 = time.perf_counter()
        model, sd = zoo_model(hvt, name)
        model.load_state_dict(sd)
        if name == "moe":
            cfg = model.cfg
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (MOE_BATCH, cfg.max_len + 1))).cuda()

            def loss_fn(p, t, model=model, cfg=cfg):
                logits, aux = torch.func.functional_call(model, p,
                                                         (t[:, :-1],))
                nll = F.cross_entropy(logits.flatten(0, 1),
                                      t[:, 1:].flatten())
                return nll + cfg.aux_loss_weight * aux

            check_inputs = toks[:, :-1]
            batch_fn = lambda i, toks=toks: toks  # noqa: E731
            want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                    "flash_bwd_dq": cfg.n_layers}
        else:
            n = VIT_BATCH if name == "vit" else RESNET_BATCH
            # One batch of seeded images and labels, taken every step (each
            # step must lower the loss on what it saw).
            size = model.cfg.image_size if name == "vit" else RESNET_IMAGE
            images = rng.standard_normal((n, 3, size, size), dtype=np.float32)
            labels = rng.integers(0, model.head.weight.shape[0], (n,))

            def loss_fn(p, b, model=model):
                logits = torch.func.functional_call(model, p, (b[0],))
                return F.cross_entropy(logits, b[1])

            if name == "vit":
                # The input path: an epoch a step (each epoch the same
                # images in a new order), staged by prefetch_to_device.
                feed = hvt.ShardedBatches(
                    [images, labels], n,
                    hvt.ShardedIndexSampler(n, seed=0))

                def epochs(feed=feed):
                    for epoch in range(ZOO_STEPS + 1):
                        feed.sampler.set_epoch(epoch)
                        yield from feed

                # Pulled inside each timed step: the copy of batch n + 1
                # is staged on the copy stream while step n runs.
                staged = hvt.prefetch_to_device(epochs())
                check_inputs = next(staged)[0]
                batch_fn = lambda i, it=staged: next(it)[:2]  # noqa: E731
            else:
                x = torch.from_numpy(images).cuda()
                check_inputs = x
                batch = (x, torch.from_numpy(labels).cuda())
                batch_fn = lambda i, batch=batch: batch  # noqa: E731
            layers = model.cfg.n_layers if name == "vit" else 0
            want = {"flash_fwd": layers, "flash_bwd_dkdv": layers,
                    "flash_bwd_dq": layers}
        check = zoo_check(hvt, name, model, sd, check_inputs)
        del sd
        step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(ZOO_LR),
                                        sharded=True, fused_update=True)
        state = dp.init_state(model, opt)
        sizes = bucket_sizes(state)
        want["fused_adamw"] = len(sizes)
        stats0 = ({k: v.clone() for k, v in model.named_buffers()}
                  if name == "resnet" else None)
        reset_counts(*kernels)
        torch.cuda.reset_peak_memory_stats()
        losses = []
        state, times = timed_steps(step, state, batch_fn,
                                   ZOO_STEPS, losses)
        counts = read_counts(*kernels)
        peak = peak_gib()
        if name == "vit" and next(staged, None) is not None:
            raise AssertionError("[zoo] vit: the feed outlasted its epochs")
        rec = {"losses": losses, "step_ms": times, "peak_gib": peak,
               "launches": counts, "check": check, "bucket_sizes": sizes,
               "wall_s": time.perf_counter() - t0}
        if stats0 is not None:
            moved = sum(not torch.equal(v, stats0[k])
                        for k, v in model.named_buffers())
            rec["bn_buffers_updated"] = f"{moved}/{len(stats0)}"
            if moved != len(stats0):
                raise AssertionError("[zoo] resnet: BatchNorm statistics "
                                     f"updated in {moved}/{len(stats0)}")
        log(f"[zoo] {name}: losses {losses}; step ms {times}; peak "
            f"{peak:.3f} GiB; launches over {ZOO_STEPS} steps {counts}"
            + (f"; BatchNorm buffers updated {rec['bn_buffers_updated']}"
               if stats0 is not None else ""))
        check_counts("zoo " + name, counts, want, ZOO_STEPS)
        check_falling("zoo " + name, losses)
        out[name] = rec
        del model, step, state, batch_fn, check_inputs
        torch.cuda.empty_cache()
    hvt.shutdown()
    wall = time.perf_counter() - t_phase
    log(f"[zoo] phase wall {wall:.1f} s")
    out["wall_s"] = wall
    return out


def tree_equal(a, b) -> bool:
    """Equal structure and tensors bit for bit (NaN payloads included)."""
    from horovod_tpu_torch.ops.batching import tree_flatten

    (la, ta), (lb, tb) = tree_flatten(a), tree_flatten(b)
    return ta == tb and all(
        torch.equal(x.view(torch.uint8) if x.dtype.is_floating_point
                    else x, y.view(torch.uint8) if y.dtype.is_floating_point
                    else y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def snapshot(tree):
    from horovod_tpu_torch.ops.batching import tree_map

    return tree_map(lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def adasum_arithmetic(grads, n):
    """(4.) the fp32 VHDD over the first ``n`` gradients against the fp64
    fold, per leaf; returns the worst leaf's relative L2."""
    from horovod_tpu_torch.ops import adasum

    got = adasum.adasum_stacked(grads[:n])
    worst = (0.0, None)
    for name in got:
        want = adasum.adasum_fold(torch.stack([g[name] for g in grads[:n]]))
        den = float(want.norm())
        err = (float((got[name].double() - want).norm()) / den if den
               else float(got[name].abs().max()))
        worst = max(worst, (err, name))
    log(f"[train-adasum] VHDD fp32 vs fp64 fold, {n} virtual ranks, "
        f"{len(got)} leaves: worst leaf {worst[1]} relative L2 {worst[0]:.3e}"
        f" (tol {ADASUM_TOL})")
    if not worst[0] <= ADASUM_TOL:
        raise AssertionError(f"[train-adasum] VHDD vs fold at {n} ranks")
    return {"worst_rel_l2": worst[0], "worst_leaf": worst[1]}


def combine_round(grads):
    """One combine round over the whole gradient (two virtual ranks'
    packed fp32 buffers): device ms (device_ms), its launches (one
    profiler window) and its byte bound."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops.batching import tree_flatten

    leaves = [tree_flatten(g)[0] for g in grads[:2]]
    layout = adasum.FlatLayout(leaves[0])
    (a,), (b,) = layout.pack(leaves[0]), layout.pack(leaves[1])
    ((seg, n_seg),) = layout.segments()

    def fn():
        return adasum.combine(a, b, seg, n_seg)

    ms = device_ms(fn, calls=10)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    device_ms_by_name(prof, counts)
    elements = sum(x.numel() for x in leaves[0])
    bound = 3 * elements * 4 / HBM_BYTES_PER_S * 1e3
    rec = {"device_ms": ms, "launches": sum(counts.values()),
           "launches_by_category": counts, "elements": elements,
           "padded_elements": a.numel(), "bound_ms": bound,
           "bound_by": "bytes", "over_bound": ms / bound}
    log(f"[train-adasum] one combine round over {elements} fp32 elements "
        f"({len(leaves[0])} leaves, {a.numel()} packed): {ms:.4f} device ms,"
        f" {rec['launches']} launches, byte bound {bound:.4f} ms "
        f"({rec['over_bound']:.2f}x)")
    return rec


def train_adasum(hvt, kernels):
    """[train-adasum]: ViT-L/16 through the replicated step with op=Adasum
    on the one-rank NCCL world, backward_passes_per_step=2, Adasum's
    arithmetic over virtual ranks and the object and state helpers."""
    import torch.nn.functional as F

    from horovod_tpu_torch.parallel import dp

    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    # The patch embedding's convolution: a deterministic cuDNN algorithm, so
    # a gradient computed twice is the same bits (check 3).
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(12)
    model, sd = zoo_model(hvt, "vit")
    size, n = model.cfg.image_size, VIT_BATCH
    batches = [(torch.from_numpy(rng.standard_normal(
        (n, 3, size, size), dtype=np.float32)).cuda(),
        torch.from_numpy(rng.integers(0, model.head.weight.shape[0],
                                      (n,))).cuda()) for _ in range(4)]

    def loss_fn(p, b):
        return F.cross_entropy(torch.func.functional_call(model, p, (b[0],)),
                               b[1])

    rec = {}
    # (1) Adasum and Average from the same start, one step each.
    after = {}
    for op in (hvt.Adasum, hvt.Average):
        model.load_state_dict(sd)
        step, opt = hvt.make_train_step(loss_fn, hvt.adamw(ADASUM_LR), op=op)
        state, _ = step(dp.init_state(model, opt), batches[0])
        after[op] = (snapshot(state.params), snapshot(state.opt_state))
        del step, opt, state
    same = (tree_equal(*(a[0] for a in after.values()))
            and tree_equal(*(a[1] for a in after.values())))
    log(f"[train-adasum] (1) one step with op=Adasum and with op=Average "
        f"from one start, one rank: parameters and AdamW state bit for bit "
        f"{same}")
    if not same:
        raise AssertionError("[train-adasum] Adasum != Average at one rank")
    rec["adasum_equals_average"] = same
    del after

    # (2) Three timed Adasum steps.
    model.load_state_dict(sd)
    step, opt = hvt.make_train_step(loss_fn, hvt.adamw(ADASUM_LR),
                                    op=hvt.Adasum)
    state = dp.init_state(model, opt)
    reset_counts(*kernels)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    state, times = timed_steps(step, state, lambda i: batches[0],
                               ADASUM_STEPS, losses)
    counts = read_counts(*kernels)
    peak = peak_gib()
    layers = model.cfg.n_layers
    log(f"[train-adasum] (2) ViT-L/16 b{n} Adasum steps: losses {losses}; "
        f"step ms {times}; peak {peak:.3f} GiB; launches over "
        f"{ADASUM_STEPS} steps {counts}")
    check_counts("train-adasum", counts, {
        "flash_fwd": layers, "flash_bwd_dkdv": layers,
        "flash_bwd_dq": layers, "fused_adamw": 0}, ADASUM_STEPS)
    check_falling("train-adasum", losses)
    rec.update(losses=losses, step_ms=times, peak_gib=peak, launches=counts)
    del step, opt, state

    # (3) backward_passes_per_step=2 on two alternating batches.
    model.load_state_dict(sd)
    inner = hvt.adamw(ADASUM_LR)
    opt = hvt.DistributedOptimizer(inner, op=hvt.Adasum,
                                   backward_passes_per_step=2)
    step, _ = hvt.make_train_step(loss_fn, opt, distribute_optimizer=False)
    state = dp.init_state(model, opt)
    enqueue, checks = [], []
    for i in range(4):
        batch = batches[i % 2]
        before = (snapshot(state.params), snapshot(state.opt_state.inner))
        if i == 1:
            g1 = grads_before
            _, _, g2 = dp.accumulate_gradients(loss_fn, state.params, batch, 1)
            want, _ = inner.update({k: g1[k] + g2[k] for k in g1},
                                   inner.init(before[0]), before[0])
            want = {k: before[0][k] + want[k] for k in want}
            del g1, g2
        if i == 0:
            _, _, grads_before = dp.accumulate_gradients(
                loss_fn, state.params, batch, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        if i % 2 == 0:  # a skipping step
            checks.append(tree_equal(state.params, before[0])
                          and tree_equal(state.opt_state.inner, before[1]))
        elif i == 1:
            checks.append(tree_equal(state.params, want))
            del want
        del before
    inner_count = int(state.opt_state.inner.count)
    log(f"[train-adasum] (3) backward_passes_per_step=2, 4 steps: steps 1 "
        f"and 3 left parameters and AdamW state bit for bit {checks[0]}, "
        f"{checks[2]}; step 2 equals AdamW on g1 + g2 bit for bit "
        f"{checks[1]}; AdamW count {inner_count}; host enqueue ms skipping "
        f"{enqueue[0::2]}, syncing {enqueue[1::2]}")
    if not all(checks) or inner_count != 2:
        raise AssertionError("[train-adasum] backward_passes_per_step=2")
    rec.update(accumulation_checks=checks, enqueue_ms_skip=enqueue[0::2],
               enqueue_ms_sync=enqueue[1::2])
    opt_state = state.opt_state
    del step, state

    # (4) Adasum's arithmetic over virtual ranks.
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    grads = [dp.accumulate_gradients(loss_fn, params, b, 1)[2]
             for b in batches]
    rec["vhdd_vs_fold"] = {k: adasum_arithmetic(grads, k) for k in (4, 3)}
    rec["combine_round"] = combine_round(grads)
    del grads

    # (5) The object and state helpers on the NCCL world.
    obj = {"name": "vit-l", "step": 7, "array": np.arange(11.0)}
    got = hvt.broadcast_object(obj)
    gathered = hvt.allgather_object(obj)
    objects_ok = (got["name"] == "vit-l" and got["step"] == 7
                  and np.array_equal(got["array"], obj["array"])
                  and len(gathered) == 1 and gathered[0]["step"] == 7)
    params_ok = tree_equal(hvt.broadcast_parameters(params), params)
    state_ok = tree_equal(hvt.broadcast_optimizer_state(opt_state), opt_state)
    x = torch.arange(12.0, device=hvt.device()).reshape(6, 2)
    y, recv = hvt.alltoall(x, splits=[6])
    moves_ok = (torch.equal(hvt.allgather(x[:5]), x[:5])
                and torch.equal(y, x) and recv.tolist() == [6])
    helpers = {"objects": objects_ok, "parameters": params_ok,
               "optimizer_state": state_ok, "uneven_moves": moves_ok}
    log(f"[train-adasum] (5) on the NCCL world, bit for bit: {helpers}")
    if not all(helpers.values()):
        raise AssertionError(f"[train-adasum] helpers {helpers}")
    rec["helpers"] = helpers
    del model, params, opt_state, batches
    torch.cuda.empty_cache()
    hvt.shutdown()
    torch.backends.cudnn.deterministic = cudnn_deterministic
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[train-adasum] phase wall {rec['wall_s']:.1f} s")
    return rec


# -- [train-overlap] and [train-actquant] --------------------------------------


def kernel_events(prof):
    """Every device event of a finished torch.profiler window: (name,
    stream id, start ns, end ns)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), e.device_resource_id(), start, start + dur))
    return out


@contextlib.contextmanager
def marked_backward():
    """A spin kernel on the compute stream just before the bucket scheduler
    arms its hooks (after the last microbatch's forward) and one just after
    that backward returns: the marks of the last backward in a profile."""
    from horovod_tpu_torch.ops import layout

    orig = layout.BucketScheduler.armed

    @contextlib.contextmanager
    def armed(self):
        torch.cuda._sleep(MARK_CYCLES)
        with orig(self) as sched:
            yield sched
        torch.cuda._sleep(MARK_CYCLES)

    layout.BucketScheduler.armed = armed
    try:
        yield
    finally:
        layout.BucketScheduler.armed = orig


@contextlib.contextmanager
def agreed_orders():
    """A list of every issue order the overlap steps agree on after their
    first step (BucketScheduler.agree_order), while it is open."""
    from horovod_tpu_torch.ops import layout

    got, orig = [], layout.BucketScheduler.agree_order

    def agree(self):
        got.append(orig(self))
        return got[-1]

    layout.BucketScheduler.agree_order = agree
    try:
        yield got
    finally:
        layout.BucketScheduler.agree_order = orig


def overlap_profile(tag, step, state, batch):
    """Two overlap-on steps in one profiler window (the first warms it);
    of the second: the stream the backward ran on, the streams of the
    bucket work (every kernel on another stream from the first mark on:
    the side streams' packs, casts, quantizes, dequantizes, and NCCL's
    own), the bucket work's device ms, and overlapped_ms, the part of it
    inside the span of the last microbatch's backward (from the first
    mark's end to the end of the last kernel the compute stream ran before
    the second mark). Fails if a collective, quantize or dequantize ran on
    the backward's stream in that step, if there was no bucket work, or if
    none of it started before the last backward kernel ended."""
    from torch.profiler import ProfilerActivity, profile

    with marked_backward(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    ev = kernel_events(prof)
    marks = [e for e in ev if "spin_kernel" in e[0]]
    if len(marks) < 2:
        raise AssertionError(f"[train-overlap] {tag}: the marks of the "
                             f"backward were not recorded ({len(marks)})")
    m0, m1 = marks[-2], marks[-1]
    compute = m0[1]
    last = [e for e in ev if e[2] >= m0[2] and e not in (m0, m1)]
    span0 = m0[3]
    span1 = max([e[3] for e in last if e[1] == compute and e[2] < m1[2]]
                or [m1[2]])
    work = [e for e in last if e[1] != compute and "Memcpy" not in e[0]]
    wrong = [e[0] for e in last if e[1] == compute and kernel_category(
        e[0]) in ("nccl", "quantize_blockwise", "dequantize_blockwise")]
    if not work or wrong:
        raise AssertionError(
            f"[train-overlap] {tag}: bucket work on side streams "
            f"{len(work)} kernels; on the backward's stream {wrong[:4]}")
    streams = {}
    for name, sid, _, _ in work:
        c = kernel_category(name)
        streams.setdefault(sid, {}).setdefault(c, 0)
        streams[sid][c] += 1
    bucket_ms = sum(e[3] - e[2] for e in work) / 1e6
    overlapped = sum(max(0, min(e[3], span1) - max(e[2], span0))
                     for e in work) / 1e6
    first = min(e[2] for e in work)
    rec = {"backward_stream": compute,
           "bucket_streams": {str(k): v for k, v in streams.items()},
           "bucket_ms": bucket_ms, "overlapped_ms": overlapped,
           "backward_span_ms": (span1 - span0) / 1e6,
           "first_bucket_start_ms": (first - span0) / 1e6,
           "started_before_backward_end": bool(first < span1)}
    log(f"[train-overlap] {tag} profile: backward on stream {compute}; "
        f"bucket work on streams {rec['bucket_streams']}; bucket work "
        f"{bucket_ms:.3f} device ms, overlapped_ms {overlapped:.3f} of a "
        f"{rec['backward_span_ms']:.3f} ms last backward; first bucket "
        f"kernel {rec['first_bucket_start_ms']:.3f} ms after the backward "
        f"began (before its end: {rec['started_before_backward_end']})")
    if not rec["started_before_backward_end"]:
        raise AssertionError(f"[train-overlap] {tag}: no bucket's work "
                             "started before the last backward kernel ended")
    return rec, state


def state_tensors(tree):
    """Every tensor of an optimizer state, in a fixed order."""
    from horovod_tpu_torch.ops.fusion import FlatBuckets

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, FlatBuckets):
        return list(tree.buffers)
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in state_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in state_tensors(x)]
    return []


def snapshot_step(state):
    return ([p.detach().clone() for _, p in sorted(state.params.items())],
            [t.detach().clone() for t in state_tensors(state.opt_state)])


def overlap_bitwise(hvt, kernels, model, loss_fn, tokens, name, kw):
    """OVERLAP_BIT_STEPS steps with overlap off, then on, from one start:
    the parameters, the optimizer state and the EF residuals after every
    step bit for bit; the launch counts of each side."""
    from horovod_tpu_torch.parallel import dp

    kw = dict(kw)
    opt_fn = kw.pop("opt")
    snaps, rec = [], {}
    for overlap in (False, True):
        step, opt = hvt.make_train_step(loss_fn, opt_fn(TRAIN_LR),
                                        accum_steps=OVERLAP_ACCUM,
                                        overlap=overlap, **kw)
        state = dp.init_state({n: p.detach().clone()
                               for n, p in model.named_parameters()}, opt)
        reset_counts(*kernels)
        losses = []
        for i in range(OVERLAP_BIT_STEPS):
            state, loss = step(state, tokens)
            losses.append(float(loss))
            snap = snapshot_step(state)
            if not overlap:
                snaps.append(snap)
                continue
            want = snaps[i]
            same = (len(snap[1]) == len(want[1]) and all(
                torch.equal(a, b) for a, b in zip(snap[0] + snap[1],
                                                  want[0] + want[1])))
            if not same:
                diff = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(snap[0] + snap[1],
                                           want[0] + want[1]))
                raise AssertionError(
                    f"[train-overlap] {name}: step {i + 1} with overlap is "
                    f"not bit for bit the step without (max |d| {diff:.3e})")
        counts = read_counts(*kernels)
        n_b = (len(state.opt_state.residual.buffers)
               if getattr(state.opt_state, "residual", None) is not None
               else n_buckets(state))
        if "compression" in kw:
            want_counts = {"quantize_blockwise": 2 * n_b,
                           "dequantize_blockwise": 2 * n_b,
                           "fused_adamw": 0}
        else:
            want_counts = {"fused_adamw": n_b, "quantize_blockwise": 0}
        check_counts(f"train-overlap {name}", counts, want_counts,
                     OVERLAP_BIT_STEPS)
        rec["on" if overlap else "off"] = {"losses": losses,
                                           "launches": counts,
                                           "buckets": n_b}
        if overlap and "compression" in kw:
            # Kernels 4 and 5 of the wire on a side stream, never on the
            # backward's.
            rec["profile"], state = overlap_profile(name, step, state, tokens)
        del step, state, opt
        torch.cuda.empty_cache()
    rec["bitwise"] = True
    log(f"[train-overlap] {name}: {OVERLAP_BIT_STEPS} steps with overlap "
        f"equal the steps without bit for bit (parameters, optimizer state"
        + (", EF residuals" if "compression" in kw else "") + f"); losses "
        f"{rec['on']['losses']}; launches with overlap "
        f"{rec['on']['launches']}")
    del snaps
    torch.cuda.empty_cache()
    return rec


def mlp_tower(hvt, dtype=torch.float32):
    """bench_act_quant's MLP tower (ACTQ_MLP) with seeded weights, its loss
    and one seeded batch on the card."""
    import torch.nn.functional as F

    width, depth, rows, classes = ACTQ_MLP
    model = hvt.MLP(features=(width,) * depth, num_classes=classes,
                    in_features=width, dtype=dtype)
    model.load_state_dict(hvt.convert.init_mlp_params(model, seed=0))
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((rows, width),
                                             dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, classes, (rows,))).cuda()

    def loss_fn(p, b, model=model):
        return F.cross_entropy(torch.func.functional_call(model, p, (b[0],)),
                               b[1])

    return model, loss_fn, (x, y)


def train_overlap(hvt, kernels):
    """[train-overlap]: bench_overlap's GPT-2 configuration on the one-rank
    NCCL world with overlap off, then on (12 timed steps each, fed by
    prefetch_to_device); the ZeRO-1 fused and int8-wire pairs bit for bit;
    the issue order the steps agreed on; profiled overlap-on steps of GPT-2
    and of the int8 wire."""
    from horovod_tpu_torch.obs import overlap as obs_overlap
    from horovod_tpu_torch.ops.fusion import BucketPlan
    from horovod_tpu_torch.parallel import dp

    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    cfg0 = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg0, seed=0)
    cfg = dataclasses.replace(cfg0, remat="dots_saveable")
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(sd0)
    del sd0
    loss_fn = train_loss(model)
    tokens_np = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (REMAT_BATCH, cfg.max_len + 1), dtype=np.int64)
    tokens = torch.from_numpy(tokens_np).cuda()
    n_l, k = cfg.n_layers, OVERLAP_ACCUM
    plan = BucketPlan(dict(model.named_parameters()))
    first_bucket = [n for n, b in zip(sorted(dict(model.named_parameters())),
                                      plan.bucket_of()) if b == 0]
    out = {"buckets": plan.n_buckets, "bucket0": first_bucket}
    runs = {}
    with agreed_orders() as agreed:
        for overlap in (False, True):
            key = "on" if overlap else "off"
            step, opt = hvt.make_train_step(loss_fn, hvt.adamw(TRAIN_LR),
                                            accum_steps=k, overlap=overlap)
            state = dp.init_state(
                {n: p.detach().clone() for n, p in model.named_parameters()},
                opt)
            feed = hvt.prefetch_to_device(
                itertools.repeat(tokens_np, OVERLAP_STEPS + 1), depth=2)
            losses = []
            state, warm = timed_steps(step, state, lambda i: next(feed), 1,
                                      losses)
            torch.cuda.reset_peak_memory_stats()
            reset_counts(*kernels)
            state, times = timed_steps(step, state, lambda i: next(feed),
                                       OVERLAP_STEPS, losses)
            counts = read_counts(*kernels)
            check_counts("train-overlap " + key, counts, {
                "flash_fwd": 2 * n_l * k, "flash_bwd_dkdv": n_l * k,
                "flash_bwd_dq": n_l * k, "fused_adamw": 0,
                "quantize_blockwise": 0, "dequantize_blockwise": 0},
                OVERLAP_STEPS)
            check_falling("train-overlap " + key, losses)
            run = {"losses": losses, "warmup_ms": warm[0],
                   "step_ms": times, "median_ms": float(np.median(times)),
                   "peak_gib": peak_gib(), "launches": counts}
            log(f"[train-overlap] GPT-2 small 32 x 1024 in {k} microbatches,"
                f" overlap {key}: step ms {[round(t, 3) for t in times]} "
                f"(median {run['median_ms']:.3f}, warm-up {warm[0]:.1f}); "
                f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
                f"{run['peak_gib']:.3f} GiB; launches over {OVERLAP_STEPS} "
                f"steps {counts}")
            if overlap:
                run["profile"], state = overlap_profile("gpt2", step, state,
                                                        tokens)
            runs[key] = run
            del step, state, opt, feed
            torch.cuda.empty_cache()
    out["runs"] = runs
    wire = sum(p.numel() * p.element_size() for p in model.parameters())
    out["pair"] = obs_overlap.record_overlap_pair(
        runs["on"]["median_ms"], runs["off"]["median_ms"], wire_bytes=wire,
        n_chips=hvt.size(), device=torch.cuda.get_device_name(0))
    log(f"[train-overlap] record_overlap_pair (ring model over {wire} "
        f"gradient bytes, {hvt.size()} rank): {json.dumps(out['pair'])}")
    out["issue_order"] = agreed[0]
    log(f"[train-overlap] {plan.n_buckets} buckets; pack order's bucket 0 "
        f"holds {first_bucket}, whole only when the backward ends; the "
        f"issue order the steps agreed on after the first: {agreed[0]}")
    out["zero1_fused"] = overlap_bitwise(
        hvt, kernels, model, loss_fn, tokens, "zero1_fused",
        dict(opt=hvt.fused_adamw, sharded=True, fused_update=True))
    out["int8_wire"] = overlap_bitwise(
        hvt, kernels, model, loss_fn, tokens, "int8_wire",
        dict(opt=hvt.adamw, compression=hvt.Compression.int8))
    del model, loss_fn, tokens
    hvt.shutdown()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[train-overlap] phase wall {out['wall_s']:.1f} s")
    return out


def boundary_plain(aq, tq, x, nhwc):
    """The boundary's plain version on the card: the plain quantize and
    dequantize of the same flat fp32 activation."""
    held_q, held_s = tq.quantize_blockwise_reference(
        aq._flat(x, nhwc), QUANT_BLOCK, tq.INT8)
    flat = tq.dequantize_blockwise_reference(held_q, held_s, QUANT_BLOCK)
    if nhwc:
        b, c, h, w = x.shape
        return flat.reshape(b, h, w, c).permute(0, 3, 1, 2).to(x.dtype)
    return flat.reshape(x.shape).to(x.dtype)


def actquant_probe(aq, tq, loss_fn, params, batch, held_want):
    """One act-quant forward and backward of ``loss_fn`` outside the step:
    the first and last boundaries' outputs against the plain boundary bit
    for bit, and every tensor the backward holds for a boundary output --
    int8 payload and fp32 scales, one scale a 256-block -- counted."""
    seen, held = [], []
    boundary, pack = aq.boundary, aq._pack

    def spy_boundary(x, **kw):
        y = boundary(x, **kw)
        seen.append((x.detach(), y.detach(), kw.get("nhwc", False)))
        return y

    def spy_pack(t):
        out = pack(t)
        if isinstance(out, aq._Held):
            held.append(out)
        return out

    aq.boundary, aq._pack = spy_boundary, spy_pack
    try:
        loss = aq.checkpoint_fn(loss_fn, "", "int8")(params, batch)
    finally:
        aq.boundary, aq._pack = boundary, pack
    loss.backward()
    for p in params.values():
        p.grad = None
    for x, y, nhwc in (seen[0], seen[-1]):
        if not torch.equal(y, boundary_plain(aq, tq, x, nhwc)):
            raise AssertionError("[train-actquant] a boundary's kernel path "
                                 "differs from its plain version")
    for h in held:
        n = h.q.numel()
        if not (h.q.dtype == torch.int8 and h.s.dtype == torch.float32
                and h.s.numel() == -(-n // QUANT_BLOCK)):
            raise AssertionError(f"[train-actquant] held {h.q.dtype} "
                                 f"{tuple(h.q.shape)}, {h.s.dtype} scales")
    if len(held) != held_want:
        raise AssertionError(f"[train-actquant] {len(held)} held boundary "
                             f"outputs, not {held_want}")
    held_bytes = sum(h.q.numel() + 4 * h.s.numel() for h in held)
    full_bytes = sum(h.q.numel() * h.dtype.itemsize for h in held)
    return {"boundaries": len(seen), "held": len(held),
            "held_bytes": held_bytes, "model_dtype_bytes": full_bytes,
            "boundary_bitwise": True}


def actquant_kernel_times(tq, gen, n):
    """Kernels 4 and 5 at one boundary's shape (``n`` fp32 elements, block
    256) beside their plain versions, with the byte bound; and the whole
    boundary of a bf16 activation (the cast to fp32, kernel 4, kernel 5,
    the cast back)."""
    from horovod_tpu_torch.ops import actquant as aq

    x = torch.randn((n,), generator=gen, device="cuda")
    q, s = tq.quantize_blockwise(x, QUANT_BLOCK, tq.INT8)
    xb = x.to(torch.bfloat16)
    rec = {"elements": n,
           "quant_ms": time_ms(lambda: tq.quantize_blockwise(
               x, QUANT_BLOCK, tq.INT8)),
           "dequant_ms": time_ms(lambda: tq.dequantize_blockwise(
               q, s, QUANT_BLOCK)),
           "quant_plain_ms": time_ms(lambda: tq.quantize_blockwise_reference(
               x, QUANT_BLOCK, tq.INT8), samples=5, per_sample=2),
           "dequant_plain_ms": time_ms(
               lambda: tq.dequantize_blockwise_reference(q, s, QUANT_BLOCK),
               samples=5, per_sample=2),
           "dequant_library_ms": time_ms(lambda: torch.mul(
               q.view(-1, QUANT_BLOCK), s[:, None]))}
    with aq.activate("int8"):
        rec["boundary_bf16_ms"] = time_ms(lambda: aq.boundary(xb))
    nbytes = 5 * n + 4 * (-(-n // QUANT_BLOCK))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = QUANT_OPS * n / FP32_FLOPS_PER_S
    rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[train-actquant] kernels 4 and 5 at a GPT-2 boundary ({n} fp32 "
        f"elements, block {QUANT_BLOCK}): quantize {rec['quant_ms']:.4f} ms "
        f"(plain {rec['quant_plain_ms']:.4f}), dequantize "
        f"{rec['dequant_ms']:.4f} ms (plain {rec['dequant_plain_ms']:.4f}, "
        f"torch.mul {rec['dequant_library_ms']:.4f}); bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); the whole bf16 "
        f"boundary {rec['boundary_bf16_ms']:.4f} ms")
    del x, q, s, xb
    torch.cuda.empty_cache()
    return rec


def train_actquant(hvt, kernels, gen):
    """[train-actquant]: GPT-2 small at 32 x 1024 ([train-remat]'s
    configuration, ZeRO-1 fused; per-block full beside it), ResNet-50 at
    224 batch 64 ([zoo]'s) and bench_act_quant's MLP tower, each with
    act-quant off and then "int8" from one start."""
    from horovod_tpu_torch.ops import actquant as aq
    from horovod_tpu_torch.parallel import dp

    tq = kernels[2]
    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    out = {"kernels": actquant_kernel_times(
        tq, gen, REMAT_BATCH * 1024 * 768)}
    rng = np.random.default_rng(15)
    cfg0 = hvt.GPT2Config.small(param_dtype=torch.float32)
    toks = torch.from_numpy(rng.integers(
        0, cfg0.vocab_size, (REMAT_BATCH, cfg0.max_len + 1))).cuda()
    images = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE),
        dtype=np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (RESNET_BATCH,))).cuda()
    n_l, depth = cfg0.n_layers, ACTQ_MLP[1]
    zero1 = dict(opt=hvt.fused_adamw, sharded=True, fused_update=True)
    # Launches a step with act-quant: a quantize a boundary; a dequantize a
    # boundary (its value) and one for every saved use of a boundary output
    # (each segment's input; GPT-2's tail casts its last boundary output to
    # fp32 and ResNet's pools it, which keep no int8; the MLP's head saves
    # its input). The held boundary outputs: the segments' inputs (and the
    # MLP head's).
    specs = [
        ("gpt2", lambda: gpt2_actquant_model(hvt, cfg0), toks, zero1,
         {"quantize_blockwise": n_l, "dequantize_blockwise": 2 * n_l - 1,
          "flash_fwd": 2 * n_l, "flash_bwd_dkdv": n_l, "flash_bwd_dq": n_l},
         n_l - 1),
        ("resnet50", lambda: resnet_actquant_model(hvt), (images, labels),
         zero1, {"quantize_blockwise": 16, "dequantize_blockwise": 31,
                 "flash_fwd": 0}, 15),
        ("mlp", lambda: mlp_tower(hvt), None, dict(opt=hvt.adamw),
         {"quantize_blockwise": depth, "dequantize_blockwise": 2 * depth,
          "fused_adamw": 0}, depth),
    ]
    for name, build, batch, kw, want, held_want in specs:
        rec = {}
        built = build()
        model, loss_fn = built[:2]
        if batch is None:
            batch = built[2]
        sides = ("off", "int8") + (("block_full",) if name == "gpt2" else ())
        for side in sides:
            if side == "block_full":
                del model, loss_fn
                torch.cuda.empty_cache()
                model, loss_fn = gpt2_actquant_model(hvt, cfg0, remat="full")
            kwargs = dict(kw)
            opt_fn = kwargs.pop("opt")
            step, opt = hvt.make_train_step(
                loss_fn, opt_fn(ACTQ_LR),
                act_quant="int8" if side == "int8" else "", **kwargs)
            # The state trains copies: the module keeps the start.
            state = dp.init_state({n: p.detach().clone()
                                   for n, p in model.named_parameters()},
                                  opt)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(*kernels)
            losses = []
            state, times = timed_steps(step, state, lambda i: batch,
                                       ACTQ_STEPS, losses)
            counts = read_counts(*kernels)
            peak = peak_gib()
            check_falling(f"train-actquant {name} {side}", losses)
            run = {"losses": losses, "step_ms": times,
                   "median_ms": float(np.median(times[1:])),
                   "peak_gib": peak, "launches": counts}
            if side == "int8":
                want_steps = dict(want)
                if "fused_adamw" not in want_steps:
                    want_steps["fused_adamw"] = n_buckets(state)
                check_counts(f"train-actquant {name}", counts, want_steps,
                             ACTQ_STEPS)
            del step, state, opt
            torch.cuda.empty_cache()
            if side == "int8":
                run["probe"] = actquant_probe(
                    aq, tq, loss_fn, dict(model.named_parameters()), batch,
                    held_want)
            log(f"[train-actquant] {name} {side}: losses {losses}; step ms "
                f"{[round(t, 3) for t in times]}; peak {peak:.3f} GiB; "
                f"launches over {ACTQ_STEPS} steps {counts}"
                + (f"; held {run['probe']['held']} boundary outputs, "
                   f"{run['probe']['held_bytes']} bytes (int8 + fp32 "
                   f"scales) for {run['probe']['model_dtype_bytes']} in the "
                   f"model's dtype; boundaries bit for bit the plain "
                   f"version's" if side == "int8" else ""))
            rec[side] = run
        del model, loss_fn, built
        torch.cuda.empty_cache()
        if name != "mlp" and not rec["int8"]["peak_gib"] < rec["off"][
                "peak_gib"]:
            raise AssertionError(
                f"[train-actquant] {name}: the int8 peak "
                f"{rec['int8']['peak_gib']:.3f} GiB is not below the off "
                f"peak {rec['off']['peak_gib']:.3f}")
        out[name] = rec
    del images, labels, toks
    hvt.shutdown()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[train-actquant] phase wall {out['wall_s']:.1f} s")
    return out


def gpt2_actquant_model(hvt, cfg0, remat=False):
    """GPT-2 small (fp32 masters, bf16 compute, seeded), per-block ``remat``
    and its next-token loss."""
    model = hvt.GPT2LMModel(dataclasses.replace(cfg0, remat=remat))
    model.load_state_dict(hvt.convert.init_params(cfg0, seed=0))
    return model, train_loss(model)


def resnet_actquant_model(hvt):
    """[zoo]'s ResNet-50 (bf16, channels_last, seeded) and its loss."""
    import torch.nn.functional as F

    model, sd = zoo_model(hvt, "resnet")
    model.load_state_dict(sd)

    def loss_fn(p, b, model=model):
        return F.cross_entropy(torch.func.functional_call(model, p, (b[0],)),
                               b[1])

    return model, loss_fn


# [train-3d]: examples/jax/gpt2_3d_parallel.py's defaults at full width on a
# one-rank mesh (dp = sp = tp = 1), bf16 compute; 3 warm-up + 10 timed
# steps on one seeded batch.
GPT3D_CFG = dict(vocab_size=50304, max_len=1024, d_model=768, n_heads=12,
                 n_layers=12, d_ff=3072, remat=True)
GPT3D_BATCH, GPT3D_LR, GPT3D_WARMUP, GPT3D_STEPS = 8, 3e-4, 3, 10
# [ring-flash]: the example's long-context shapes (--seq-len 2048 --sp 2
# --tp 2): q/k/v [8, 2048, 6, 64] bf16, causal, split over 2 and 4 virtual
# sp ranks.
RING_SHAPE, RING_VIRTUAL = (8, 2048, 6, 64), (2, 4)


def gpt3d_dense_loss(p, tokens, cfg):
    """The 3-D GPT's math written densely in fp32 (plain causal softmax
    attention over the whole sequence, no ring, no collective): the plain
    reference [train-3d] holds the step's gradients against."""
    import torch.nn.functional as F

    def ln(x, scale, bias, eps=1e-5):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * scale + bias

    b, s = tokens.shape
    d = cfg.head_dim
    mask = torch.ones((s, s), dtype=torch.bool, device=tokens.device).tril()
    x = p["wte"][tokens] + p["wpe"][:s]
    for i in range(cfg.n_layers):
        h = ln(x, p["ln1_scale"][i], p["ln1_bias"][i])
        q, k, v = (torch.einsum("bsd,dhk->bhsk", h, p[w][i])
                   for w in ("wq", "wk", "wv"))
        scores = (q @ k.transpose(-1, -2)) / d ** 0.5
        a = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1) @ v
        x = x + torch.einsum("bhsk,hkd->bsd", a, p["wo"][i])
        h = ln(x, p["ln2_scale"][i], p["ln2_bias"][i])
        up = F.gelu(h @ p["w_up"][i] + p["b_up"][i], approximate="tanh")
        x = x + up @ p["w_down"][i] + p["b_down"][i]
    x = ln(x, p["lnf_scale"], p["lnf_bias"])
    logits = x @ p["wte"].t()
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def train_3d(hvt, kernels):
    """[train-3d]: the 3-D parallel GPT at GPT-2-small width through
    make_parallel_train_step on a one-rank mesh, its gradients held against
    an fp32 dense computation, then timed."""
    from horovod_tpu_torch.obs import flops
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.parallel import transformer as ptr

    t_phase = time.perf_counter()
    hvt.init(backend="nccl", mesh={"dp": 1, "sp": 1, "tp": 1},
             world_axes=("dp", "sp"))
    cfg = ptr.ParallelGPTConfig(**GPT3D_CFG, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = ptr.shard_params(ptr.init_params(cfg, gen), cfg)
    seq = cfg.max_len
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (GPT3D_BATCH, seq), dtype=np.int64)).cuda()
    rec = {"config": {**GPT3D_CFG, "dtype": "bfloat16", "batch": GPT3D_BATCH,
                      "mesh": {"dp": 1, "sp": 1, "tp": 1}}}

    # (1) One step's gradients against the fp32 dense computation.
    loss, grads = ptr.loss_and_grads(params, tokens, cfg)
    ref_params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
    ref_loss = gpt3d_dense_loss(ref_params, tokens, cfg)
    ref_grads = dict(zip(ref_params, torch.autograd.grad(
        ref_loss, list(ref_params.values()))))
    rel = grads_rel_l2(grads, ref_grads)
    per_leaf = {k: grads_rel_l2({k: grads[k]}, {k: ref_grads[k]})
                for k in grads}
    worst = max(per_leaf, key=per_leaf.get)
    log(f"[train-3d] one step's gradients (bf16 compute, the ring, the "
        f"Megatron pair, the (dp, sp) Sum) against the fp32 dense "
        f"computation: relative L2 {rel:.4e} (bound {STEP_GRAD_TOL}); worst "
        f"leaf {worst} {per_leaf[worst]:.4e}; loss {float(loss):.6f} vs fp32 "
        f"{float(ref_loss.detach()):.6f}")
    if not rel <= STEP_GRAD_TOL or not np.isfinite(float(loss)):
        raise AssertionError(f"[train-3d] gradients off the fp32 dense "
                             f"computation: relative L2 {rel}")
    rec.update(grad_rel_l2=rel, grad_rel_l2_by_leaf=per_leaf,
               loss_bf16=float(loss), loss_fp32=float(ref_loss.detach()))
    del grads, ref_grads, ref_params, ref_loss
    torch.cuda.empty_cache()

    # (2) The timed steps; each fused_allreduce bucket counted.
    opt = hvt.adamw(GPT3D_LR)
    state = opt.init(params)
    step = ptr.make_parallel_train_step(cfg, opt)
    buckets = []
    reduce_bucket = fusion.reduce_bucket

    def counted(*a, **kw):
        buckets.append(1)
        return reduce_bucket(*a, **kw)

    fusion.reduce_bucket = counted
    reset_counts(*kernels)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    try:
        for _ in range(GPT3D_WARMUP + GPT3D_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, tokens)
            losses.append(float(loss))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        fusion.reduce_bucket = reduce_bucket
    counts = read_counts(*kernels)
    n_steps = GPT3D_WARMUP + GPT3D_STEPS
    check_falling("train-3d", losses)
    check_counts("train-3d", counts, {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                                      "flash_bwd_dq": 0, "fused_adamw": 0},
                 n_steps)
    ms = float(np.median(times[GPT3D_WARMUP:]))
    tok_s = GPT3D_BATCH * seq / ms * 1e3
    # The tied wte is the head's matmul too, so it counts; wpe is a lookup.
    n_matmul = sum(v.numel() for k, v in params.items() if k != "wpe")
    fpt = flops.transformer_flops_per_token(n_matmul, cfg.n_layers, seq,
                                            cfg.d_model)
    mfu = flops.mfu(tok_s, fpt, torch.cuda.get_device_name(0))
    peak = peak_gib()
    log(f"[train-3d] GPT-2 small width (vocab {cfg.vocab_size}, d "
        f"{cfg.d_model}, {cfg.n_layers} layers, remat) {GPT3D_BATCH} x {seq} "
        f"bf16 on dp = sp = tp = 1: step {ms:.2f} ms (median of "
        f"{GPT3D_STEPS} after {GPT3D_WARMUP} warm-up; all "
        f"{json.dumps([round(t, 2) for t in times])}), {tok_s:.0f} tokens/s, "
        f"MFU {mfu if mfu is None else round(mfu, 4)}, peak {peak:.2f} GiB; "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; fused_allreduce "
        f"buckets {len(buckets) / n_steps:g} a step; flash launches "
        f"{counts['flash_fwd']} (the reference's GPT runs the dense ring)")
    rec.update(step_ms=ms, step_times_ms=times, tokens_per_s=tok_s, mfu=mfu,
               peak_gib=peak, losses=losses, launches=counts,
               buckets_per_step=len(buckets) / n_steps,
               phase_s=time.perf_counter() - t_phase)
    hvt.shutdown()
    del params, state, step
    torch.cuda.empty_cache()
    return rec


def virtual_ring(q, k, v, n):
    """The flash ring of n virtual sp ranks in one process: each rank r's
    query block through sp.flash_ring -- the loop ring_attention runs --
    with its key/value blocks sliced from the whole sequence instead of
    passed along the ring. Returns the whole output, the merged lse and
    every hop's (r, kv_rank, o_i, lse_i)."""
    from horovod_tpu_torch.parallel import sp as psp

    s = q.shape[1] // n
    outs, lses, hops = [], [], []
    for r in range(n):
        o, lse, hops_r = psp.flash_ring(
            q[:, r * s:(r + 1) * s],
            lambda step, kv: (k[:, kv * s:(kv + 1) * s],
                              v[:, kv * s:(kv + 1) * s]),
            n=n, r=r, causal=True)
        hops += [(r, *hop) for hop in hops_r]
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 2), hops


def ring_times(attend, q, k, v, g, launches, held=None, calls=8, tries=4):
    """``attend(q, k, v) -> out``'s times: the forward alone and the forward
    with its backward (cotangent ``g``), each by CUDA events around
    back-to-back calls (time_ms: the host's gaps count where the host is
    the slower) and by its busy device time -- every kernel of ``calls``
    calls in a torch.profiler window, summed by category. The window is the
    active step of a schedule whose warm-up step runs the same calls first,
    so the tracing is up before the calls it counts. It can still miss
    launches (a window of 8 whole-sequence forwards once recorded none of
    them): ``launches`` gives the flash kernels' launches a call, for
    ``"fwd"`` and ``"fwd_bwd"``, so the recorded flash launches say how
    many calls the window saw, and the sums are divided by that. A window
    that saw under half its calls, or whose busy time a call reads outside
    0.9-1.1 of ``held``'s (device_ms's held-stream time of the same calls,
    where the call is short enough for it), is taken again with twice the
    calls; after ``tries`` such windows the measurement fails. The ring
    enqueues more launches than the launch queue holds, so device_ms's
    held stream cannot time it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def fwd():
        with torch.no_grad():
            attend(q, k, v)

    def fwd_bwd():
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.autograd.grad(attend(*xs), xs, g)

    out = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        out[name + "_ms"] = time_ms(fn, samples=5, per_sample=2)
        n, windows = calls, []
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(2):
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
            counts = {}
            _, by_cat = device_ms_by_name(prof, counts)
            seen = (sum(counts.get(c, 0) for c in launches[name])
                    / sum(launches[name].values()))
            busy = sum(by_cat.values()) / seen if seen else 0.0
            windows.append((n, seen, busy, by_cat))
            if seen >= n / 2 and (held is None
                                  or 0.9 <= busy / held[name] <= 1.1):
                break
            n *= 2
        else:
            raise AssertionError(
                f"torch.profiler saw too few calls of {name} in {tries} "
                f"windows (calls, calls seen, busy ms a call, ms by "
                f"category): {windows}"
                + ("" if held is None else f"; held {held[name]} ms"))
        out[name + "_device_ms"] = busy
        out[name + "_device_ms_by_category"] = {
            c: ms / seen for c, ms in sorted(by_cat.items())}
        out[name + "_windows"] = windows
    return out


def describe_times(t):
    cats = ", ".join(f"{c} {ms:.4f}"
                     for c, ms in t["fwd_device_ms_by_category"].items())
    return (f"forward {t['fwd_ms']:.4f} ms by events, "
            f"{t['fwd_device_ms']:.4f} device ({cats}); forward + backward "
            f"{t['fwd_bwd_ms']:.4f} by events, {t['fwd_bwd_device_ms']:.4f} "
            f"device")


def ring_flash(hvt, kernels):
    """[ring-flash]: the flash ring's hops (kernel 1 forward, kernels 2 and
    3 with the lse cotangent backward) at the 3-D example's long-context
    shapes, 2 and 4 virtual sp ranks, against the whole-sequence kernels;
    then ring_attention(use_flash=True) itself on the one-rank world."""
    from horovod_tpu_torch.parallel import sp as psp

    fa = kernels[0]
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)

    def rand():
        return torch.randn(RING_SHAPE, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, g = rand(), rand(), rand(), rand()
    with torch.no_grad():
        out_w, lse_w = fa.flash_attention_with_lse(q, k, v, causal=True)
        grads_w = fa.flash_attention_bwd(q, k, v, out_w, lse_w, g,
                                         causal=True)
        plain_w = fa.flash_attention_bwd_reference(q, k, v, out_w, lse_w, g,
                                                   causal=True)
        out_p, lse_p = fa.flash_attention_reference(q, k, v, causal=True)
    scale = max(float(x.float().abs().max()) for x in plain_w)
    fin_w = torch.isfinite(lse_w)
    if not torch.equal(torch.isfinite(lse_p), fin_w):
        raise AssertionError("[ring-flash] the whole-sequence kernel's -inf "
                             "lse rows differ from the plain forward's")
    rec = {"shape": list(RING_SHAPE), "causal": True, "runs": {}}
    for n in RING_VIRTUAL:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        reset_counts(*kernels)
        out, lse, hops = virtual_ring(*leaves, n)
        fwd = read_counts(*kernels)
        masked = [(o_i, lse_i) for r, kv, o_i, lse_i in hops if kv > r]
        for o_i, lse_i in masked:
            o_i.retain_grad()
            lse_i.retain_grad()
        (out.float() * g.float()).sum().backward()
        counts = read_counts(*kernels)
        want = {"flash_fwd": n * n, "flash_bwd_dkdv": n * n,
                "flash_bwd_dq": n * n}
        got = {"flash_fwd": fwd["flash_fwd"],
               "flash_bwd_dkdv": counts["flash_bwd_dkdv"],
               "flash_bwd_dq": counts["flash_bwd_dq"]}
        if got != want or counts["flash_fwd"] != n * n:
            raise AssertionError(f"[ring-flash] n={n}: launches {got} (and "
                                 f"{counts['flash_fwd']} forward after the "
                                 f"backward), not {want}")
        got = counts  # every kernel's count over the run
        err_out = float((out.detach().float() - out_w.float()).abs().max())
        same_inf = bool(torch.equal(torch.isinf(lse), ~fin_w))
        err_lse = float((lse.detach()[fin_w] - lse_w[fin_w]).abs().max())
        err_out_plain = float((out.detach().float()
                               - out_p.float()).abs().max())
        err_lse_plain = float((lse.detach()[fin_w]
                               - lse_p[fin_w]).abs().max())
        errs = [float((x.grad.float() - w.float()).abs().max())
                for x, w in zip(leaves, grads_w)]
        errs_plain = [float((x.grad.float() - w.float()).abs().max())
                      for x, w in zip(leaves, plain_w)]
        nan = any(bool(torch.isnan(x.grad).any()) for x in leaves)
        # Hops whose key block lies wholly after their query block.
        hop_ok = all(
            bool(torch.isneginf(lse_i).all()) and not bool(o_i.any())
            and not bool(o_i.grad.any()) and not bool(lse_i.grad.any())
            for o_i, lse_i in masked)
        # The same hops' backward with nonzero cotangents of both outputs:
        # zeros and no NaN (launched outside the counted run).
        r, kv, o_i, lse_i = next(h for h in hops if h[1] > h[0])
        bsz, s = RING_SHAPE[0], RING_SHAPE[1] // n
        with torch.no_grad():
            hop_grads = fa.flash_attention_bwd(
                q[:, r * s:(r + 1) * s].reshape(bsz, s, -1),
                k[:, kv * s:(kv + 1) * s].reshape(bsz, s, -1),
                v[:, kv * s:(kv + 1) * s].reshape(bsz, s, -1),
                o_i.detach().reshape(bsz, s, -1), lse_i.detach(),
                g[:, r * s:(r + 1) * s].reshape(bsz, s, -1),
                torch.randn(lse_i.shape, generator=gen, device="cuda"),
                causal=True, q_offset=r * s, kv_offset=kv * s, layout="bsm",
                n_heads=RING_SHAPE[2])
        masked_zero = all(not bool(x.any()) and not bool(torch.isnan(x).any())
                          for x in hop_grads)
        times = ring_times(lambda a, b, c: virtual_ring(a, b, c, n)[0],
                           q, k, v, g, {"fwd": {"flash_fwd": n * n},
                                        "fwd_bwd": want})
        run = {"launches": got, "max_abs_err_out": err_out,
               "max_abs_err_lse": err_lse,
               "max_abs_err_out_vs_plain": err_out_plain,
               "max_abs_err_lse_vs_plain": err_lse_plain,
               "lse_inf_rows_match": same_inf,
               "grad_err": errs, "grad_err_vs_plain": errs_plain,
               "grad_scale": scale, "nan": nan,
               "masked_hops": len(masked), "masked_hops_zero": hop_ok,
               "masked_hop_bwd_zero": masked_zero, **times}
        log(f"[ring-flash] n={n} virtual sp ranks of {s} tokens: out max |d| "
            f"{err_out:.3e} against the whole-sequence kernel, "
            f"{err_out_plain:.3e} against the plain forward (<= {OUT_TOL}), "
            f"merged lse {err_lse:.3e}, {err_lse_plain:.3e} (<= {LSE_TOL}), "
            f"-inf rows alike {same_inf}; dq/dk/dv max |d| "
            f"{', '.join(f'{e:.3e}' for e in errs)} against the whole-sequence "
            f"kernels ({', '.join(f'{e:.3e}' for e in errs_plain)} against "
            f"the plain backward; bound {GRAD_TOL} x {scale:.3e}), NaN {nan}; "
            f"{len(masked)} hops wholly in the future: lse -inf, out 0, zero "
            f"cotangents {hop_ok}, their backward with nonzero cotangents 0 "
            f"{masked_zero}; launches {got}; {describe_times(times)}")
        if (max(err_out, err_out_plain) > OUT_TOL
                or max(err_lse, err_lse_plain) > LSE_TOL or not same_inf
                or nan or max(errs + errs_plain) > GRAD_TOL * scale
                or not hop_ok
                or not masked_zero or not masked):
            raise AssertionError(f"[ring-flash] n={n} failed: {run}")
        rec["runs"][f"n{n}"] = run
        del leaves, out, lse, hops, masked

    def whole(a, b, c):
        return fa.flash_attention_with_lse(a, b, c, causal=True)[0]

    # Its few launches fit behind device_ms's held stream, which checks the
    # profiled windows of the whole call.
    with torch.no_grad():
        held_fwd = device_ms(lambda: whole(q, k, v))
    held = {"fwd": held_fwd, "fwd_bwd": held_fwd + device_ms(
        lambda: fa.flash_attention_bwd(q, k, v, out_w, lse_w, g,
                                       causal=True))}
    rec["whole"] = ring_times(
        whole, q, k, v, g, {"fwd": {"flash_fwd": 1},
                            "fwd_bwd": {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                                        "flash_bwd_dq": 1}}, held=held)
    rec["whole"]["fwd_held_device_ms"] = held["fwd"]
    rec["whole"]["fwd_bwd_held_device_ms"] = held["fwd_bwd"]
    log(f"[ring-flash] the whole {RING_SHAPE[1]}-token sequence in one call: "
        f"{describe_times(rec['whole'])}; behind a held stream: forward "
        f"{rec['whole']['fwd_held_device_ms']:.4f}, forward + backward "
        f"{rec['whole']['fwd_bwd_held_device_ms']:.4f} (no limit on the "
        f"ring: its merges and masked hops are extra work by design)")

    # ring_attention itself on the one-rank world: one hop, equal to the
    # whole-sequence call's output.
    hvt.init(backend="nccl", mesh={"sp": 1})
    bsz, s = RING_SHAPE[0], RING_SHAPE[1] // 2
    qh, kh, vh = (x[:, :s].contiguous() for x in (q, k, v))
    with torch.no_grad():
        got = psp.ring_attention(qh, kh, vh, axis="sp", causal=True,
                                 use_flash=True)
        want, _ = fa.flash_attention_with_lse(
            *(x.reshape(bsz, s, -1) for x in (qh, kh, vh)), causal=True,
            layout="bsm", n_heads=RING_SHAPE[2])
        want = want.reshape(got.shape)
    same = bool(torch.equal(got, want))
    hvt.shutdown()
    log(f"[ring-flash] ring_attention(use_flash=True) on the one-rank world "
        f"({[bsz, s, *RING_SHAPE[2:]]}, one hop) equals flash_attention_with_lse bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("[ring-flash] the one-hop ring differs from "
                             "flash_attention_with_lse")
    rec["one_rank_equal"] = same
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def guard_loss(model):
    """[train]'s next-token cross entropy with a per-example weight (ones):
    the batch's floating leaf, the one the grad.nan site poisons (token ids
    alone have none)."""
    import torch.nn.functional as F

    def loss_fn(params, batch):
        tokens, weight = batch
        logits = torch.func.functional_call(model, params, (tokens[:, :-1],))
        ce = F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten(),
                             reduction="none")
        return (ce.view(tokens.shape[0], -1).mean(-1) * weight).mean()

    return loss_fn


def guard_build(hvt, cfg, sd0, guard, quant=False):
    """GPT-2 small from ``sd0`` through [train]'s ZeRO-1 fused step (on the
    int8 wire with ``quant``), guarded by ``guard``."""
    from horovod_tpu_torch.parallel import dp

    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(sd0)
    kw = dict(compression=hvt.Compression.int8) if quant else {}
    step, opt = hvt.make_train_step(
        guard_loss(model), hvt.fused_adamw(TRAIN_LR), sharded=True,
        fused_update=True, guard=guard, **kw)
    return model, step, dp.init_state(model, opt)


def guard_snapshot(state):
    """Clones of what a skipped step must leave: the parameters, the ZeRO-1
    moments, both counts, the step and the EF residuals."""
    o = state.opt_state
    t = [p.detach().clone() for p in state.params.values()]
    t += [b.clone() for b in o.inner.mu.buffers + o.inner.nu.buffers]
    t += [o.inner.count.clone(), o.count.clone(), state.step.clone()]
    if o.residual is not None:
        t += [b.clone() for b in o.residual.buffers]
    return t


def guard_skip_run(hvt, kernels, cfg, sd0, batch, quant):
    """Step GUARD_NAN_AT's batch poisoned by the armed grad.nan site (n=1,
    so the retry is clean): the step is skipped bit for bit with every
    kernel-6 launch carrying ok = 0, and the steps after it commit."""
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.guard import GuardConfig

    label = "int8 wire" if quant else "ZeRO-1 fused"
    model, step, state = guard_build(hvt, cfg, sd0,
                                     GuardConfig(**GUARD_CFG), quant)
    flags = []
    orig = topt.fused_adamw_update

    def spy(p, m, v, g, count, spec, ok=None):
        flags.append(ok)
        return orig(p, m, v, g, count, spec, ok)

    losses, norms = [], []

    def note(state):
        # The guard's host-safe norm, and the spike threshold a detector
        # armed after GUARD_EARLY_WARMUP steps would hold it to.
        g = state.guard
        mean, std = float(g.mean), float(g.var) ** 0.5
        norms.append({"step": int(state.step), "norm": float(g.last_norm),
                      "mean": mean, "std": std,
                      "threshold": mean + 6.0 * max(std, 0.1 * mean)})

    chaos.plan(f"grad.nan:nan@step={GUARD_NAN_AT};n=1", seed=0)
    try:
        for _ in range(GUARD_NAN_AT - 1):
            state, loss = step(state, batch)
            losses.append(float(loss))
            note(state)
        before = guard_snapshot(state)
        reset_counts(*kernels)
        topt.fused_adamw_update = spy
        try:
            state, skipped_loss = step(state, batch)
        finally:
            topt.fused_adamw_update = orig
        torch.cuda.synchronize()
        counts = read_counts(*kernels)
        bitwise = all(torch.equal(a, b)
                      for a, b in zip(before, guard_snapshot(state)))
        del before
        flag_values = [None if f is None else int(f) for f in flags]
        skipped, at = int(state.guard.skipped), int(state.step)
        for _ in range(GUARD_STEPS - GUARD_NAN_AT):
            state, loss = step(state, batch)
            losses.append(float(loss))
            note(state)
    finally:
        chaos.clear()
    # Where a detector armed after GUARD_EARLY_WARMUP committed steps would
    # have skipped: a norm above the threshold of the state before it.
    early = [b["step"] for a, b in zip(norms, norms[1:])
             if a["step"] >= GUARD_EARLY_WARMUP and b["norm"] > a["threshold"]]
    nb = n_buckets(state)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers, "fused_adamw": nb}
    if quant:
        want.update(quantize_blockwise=2 * nb, dequantize_blockwise=2 * nb)
    check_counts("train-guard", counts, want, 1)
    rec = {"bitwise_skip": bitwise, "kernel6_flags": flag_values,
           "skipped_loss": float(skipped_loss), "losses": losses,
           "step_after_skip": at, "final_step": int(state.step),
           "guard": {f: float(getattr(state.guard, f))
                     for f in state.guard._fields},
           "norms": norms, "early_warmup_spikes_at": early,
           "runtime": {k: getattr(step.guard_runtime, k) for k in (
               "consecutive", "last_norm", "skips", "escalations")},
           "launches": counts}
    log(f"[train-guard] {label}: call {GUARD_NAN_AT} poisoned (loss "
        f"{float(skipped_loss)}): skipped bit for bit (params, mu, nu, "
        f"counts, step{', EF residuals' if quant else ''}) {bitwise}; "
        f"kernel-6 flags {flag_values}; state.step {at}; launches {counts}; "
        f"losses {[round(x, 4) for x in losses]}; guard {rec['guard']}; "
        f"runtime {rec['runtime']}; "
        f"norm / threshold by step "
        f"{[(b['step'], round(b['norm'], 4), round(b['threshold'], 4)) for b in norms]}"
        f"; a detector armed after {GUARD_EARLY_WARMUP} steps would skip "
        f"the steps after {early}")
    if not (bitwise and flag_values == [0] * nb and skipped == 1
            and at == GUARD_NAN_AT - 1
            and int(state.step) == GUARD_STEPS - 1):
        raise AssertionError(f"[train-guard] {label}: the poisoned step was "
                             f"not skipped cleanly: {rec}")
    if not (np.isnan(float(skipped_loss)) and all(np.isfinite(losses))
            and losses[-1] < losses[GUARD_NAN_AT - 2] < losses[0]):
        raise AssertionError(f"[train-guard] {label}: losses {losses}")
    del model, step, state
    torch.cuda.empty_cache()
    return rec


def guard_elastic_run(hvt, cfg, sd0, batch, storm):
    """GUARD_RUN_STEPS steps inside hvt.elastic.run, committing each clean
    step; with ``storm`` the grad.nan site poisons both attempts at step
    GUARD_STORM_AT, so the third call raises and the loop restores."""
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.guard import GuardConfig
    from horovod_tpu_torch.parallel import dp

    model, step, state = guard_build(hvt, cfg, sd0, GuardConfig(**GUARD_CFG))
    est = hvt.elastic.TrainState(params=state.params,
                                 opt_state=state.opt_state, step=state.step,
                                 guard=state.guard)
    attempts, losses, commit_ms = [], [], []

    @hvt.elastic.run
    def train(st):
        while int(st.step) < GUARD_RUN_STEPS:
            cur = dp.TrainState(st.params, st.opt_state, st.step, None,
                                st.guard)
            new, loss = step(cur, batch)
            attempts.append(int(new.step))
            losses.append(float(loss))
            st.opt_state, st.step, st.guard = (new.opt_state, new.step,
                                               new.guard)
            if int(new.guard.consecutive) == 0:
                t0 = time.perf_counter()
                st.commit()
                commit_ms.append((time.perf_counter() - t0) * 1e3)
        return st

    if storm:
        chaos.plan(f"grad.nan:nan@step={GUARD_STORM_AT};n=2", seed=0)
    try:
        train(est)
    finally:
        chaos.clear()
    out = {"attempts": attempts, "losses": losses, "commit_ms": commit_ms,
           "escalations": step.guard_runtime.escalations,
           "params": {k: v.detach().clone() for k, v in est.params.items()}}
    del model, step, state, est
    torch.cuda.empty_cache()
    return out


def guard_timing(hvt, cfg, sd0, batch):
    """Guarded vs unguarded [train] steps, alternated in one process (which
    goes first swaps every round); the host syncs a step (CUDA's sync debug
    mode, one step each), the host ms the guard's read of the previous
    step's counters takes, and the screen's device ms."""
    import warnings

    from horovod_tpu_torch.guard import GuardConfig, check_gradients
    from horovod_tpu_torch.guard import fresh_state
    from horovod_tpu_torch.ops.guards import finite_and_sumsq
    from horovod_tpu_torch.parallel import dp

    runs = {"guarded": guard_build(hvt, cfg, sd0, GuardConfig(**GUARD_CFG)),
            "unguarded": guard_build(hvt, cfg, sd0, False)}
    states = {k: r[2] for k, r in runs.items()}
    rt = runs["guarded"][1].guard_runtime
    drain = []
    escalate = rt._escalate_and_record

    def timed_escalate(state):
        t0 = time.perf_counter()
        escalate(state)
        drain.append((time.perf_counter() - t0) * 1e3)

    rt._escalate_and_record = timed_escalate
    times = {k: [] for k in runs}
    for i in range(GUARD_WARMUP + GUARD_TIMED):
        order = list(runs) if i % 2 == 0 else list(runs)[::-1]
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[k], _ = runs[k][1](states[k], batch)
            torch.cuda.synchronize()
            if i >= GUARD_WARMUP:
                times[k].append((time.perf_counter() - t0) * 1e3)
    synced_drain = drain[GUARD_WARMUP:]
    drain.clear()
    # Back to back, one synchronization a block of GUARD_TIMED steps: here
    # the guard's read of the previous step's counters stops the host from
    # enqueueing ahead (blocks alternated, two a side).
    b2b = {k: [] for k in runs}
    for i in range(4):
        k = list(runs)[i % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GUARD_TIMED):
            states[k], _ = runs[k][1](states[k], batch)
        torch.cuda.synchronize()
        b2b[k].append((time.perf_counter() - t0) * 1e3 / GUARD_TIMED)
    b2b_drain = list(drain)
    syncs, sync_sites = {}, {}
    for k in runs:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                states[k], _ = runs[k][1](states[k], batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # The mode's own notice ("... is a prototype feature ...") is not
        # a sync.
        hits = [w for w in caught if "synchroniz" in str(w.message)
                and "prototype" not in str(w.message)]
        syncs[k] = len(hits)
        sync_sites[k] = [f"{Path(w.filename).name}:{w.lineno}" for w in hits]
    _, _, grads = dp.accumulate_gradients(
        guard_loss(runs["unguarded"][0]), states["unguarded"].params, batch,
        1)
    screen_ms = device_ms(lambda: finite_and_sumsq(grads))
    gcfg, gs = GuardConfig(**GUARD_CFG), fresh_state("cuda")
    # With its NCCL all-reduce the call cannot queue behind a held stream
    # (the collective's launch waits on it): timed by events.
    check_ms = time_ms(lambda: check_gradients(grads, gs, gcfg), samples=9,
                       per_sample=5)
    nbytes = sum(g.numel() * g.element_size() for g in grads.values())
    rec = {k: {"step_ms": float(np.median(t)), "step_ms_all": t,
               "back_to_back_ms": b2b[k]}
           for k, t in times.items()}
    rec.update(host_syncs_a_step=syncs, host_sync_sites=sync_sites,
               drain_ms_synced=float(np.median(synced_drain)),
               drain_ms_back_to_back=float(np.median(b2b_drain)),
               screen_device_ms=screen_ms, check_ms=check_ms,
               screen_bytes=nbytes,
               screen_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    log(f"[train-guard] step ms, median of {GUARD_TIMED} after "
        f"{GUARD_WARMUP} warm-up, alternated: guarded "
        f"{rec['guarded']['step_ms']:.3f}, unguarded "
        f"{rec['unguarded']['step_ms']:.3f} (all: guarded "
        f"{[round(t, 2) for t in times['guarded']]}, unguarded "
        f"{[round(t, 2) for t in times['unguarded']]}); back to back "
        f"(ms a step over blocks of {GUARD_TIMED}): {b2b}; host syncs a step "
        f"{syncs} at {sync_sites}; the guard's read of the previous "
        f"step's counters (host ms, median) {rec['drain_ms_synced']:.3f} "
        f"after a synchronized step, {rec['drain_ms_back_to_back']:.3f} "
        f"back to back; screen "
        f"{screen_ms:.4f} device ms over {nbytes / 1e6:.1f} MB (bound "
        f"{rec['screen_bound_ms']:.4f} ms), check_gradients with its "
        f"all-reduce {check_ms:.4f} ms by events")
    del runs, states, grads
    torch.cuda.empty_cache()
    return rec


def train_guard(hvt, kernels):
    """[train-guard]: [train]'s GPT-2 small ZeRO-1 fused step under the
    gradient guard: a poisoned step skipped bit for bit (also on the int8
    wire), a NaN storm escalated and recovered by hvt.elastic.run, and the
    guard's cost against the unguarded step."""
    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1),
        dtype=np.int64)).cuda()
    batch = (tokens, torch.ones(TRAIN_BATCH, device="cuda"))
    log(f"[train-guard] GPT-2 small, fp32 masters, bf16 compute, "
        f"{TRAIN_BATCH} x {cfg.max_len + 1} tokens (rng 3, [train]'s batch) "
        f"with per-example weights of 1, ZeRO-1 fused_adamw({TRAIN_LR}), "
        f"one-rank NCCL, GuardConfig({GUARD_CFG})")
    rec = {"config": {"guard": GUARD_CFG, "batch": TRAIN_BATCH,
                      "seq": cfg.max_len}}
    rec["skip"] = guard_skip_run(hvt, kernels, cfg, sd0, batch, False)
    rec["skip_int8"] = guard_skip_run(hvt, kernels, cfg, sd0, batch, True)
    clean = guard_elastic_run(hvt, cfg, sd0, batch, storm=False)
    storm = guard_elastic_run(hvt, cfg, sd0, batch, storm=True)
    params_bitwise = all(torch.equal(clean["params"][k], storm["params"][k])
                         for k in clean["params"])
    p_rel = grads_rel_l2(storm["params"], clean["params"])
    loss_bitwise = storm["losses"][-1] == clean["losses"][-1]
    rec["escalation"] = {
        "attempts": storm["attempts"], "clean_attempts": clean["attempts"],
        "escalations": storm["escalations"], "losses": storm["losses"],
        "clean_losses": clean["losses"], "last_loss_bitwise": loss_bitwise,
        "params_bitwise": params_bitwise, "params_rel_l2": p_rel,
        "commit_ms": storm["commit_ms"]}
    del clean, storm
    log(f"[train-guard] escalation: two NaN attempts at step "
        f"{GUARD_STORM_AT} under max_skips 2 -> HorovodInternalError "
        f"({rec['escalation']['escalations']} escalation), hvt.elastic.run "
        f"restored the step-{GUARD_STORM_AT - 1} commit and finished: "
        f"attempts {rec['escalation']['attempts']}; last loss "
        f"{rec['escalation']['losses'][-1]!r} vs the clean run's "
        f"{rec['escalation']['clean_losses'][-1]!r} (bit for bit "
        f"{loss_bitwise}); final parameters bit for bit {params_bitwise} "
        f"(relative L2 {p_rel:.3e}); commit ms "
        f"{[round(t, 1) for t in rec['escalation']['commit_ms']]}")
    e = rec["escalation"]
    if e["escalations"] != 1 or e["attempts"].count(GUARD_STORM_AT - 1) != 3:
        raise AssertionError(f"[train-guard] escalation: {e}")
    if not (loss_bitwise and params_bitwise):
        log("[train-guard] the restored run is not bit for bit the clean "
            "run: a step on the card is not bitwise repeatable here; held "
            f"to [train]'s bound (relative L2 <= {STEP_GRAD_TOL})")
        if not p_rel <= STEP_GRAD_TOL:
            raise AssertionError(f"[train-guard] escalation: {e}")
    rec["timing"] = guard_timing(hvt, cfg, sd0, batch)
    hvt.shutdown()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[train-guard] phase wall {rec['phase_s']:.1f} s")
    return rec


def gspmd_phase(hvt, kernels):
    """[gspmd]: GPT-2 small with its parameters placed as DTensors by
    parallel.gspmd.shard_params on a one-rank NCCL DeviceMesh(("tp",)):
    one bf16 forward and backward through kernels 1-3 on the local heads,
    held against the dense module's."""
    from horovod_tpu_torch.parallel import gspmd
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode

    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small()
    sd0 = hvt.convert.init_params(cfg, seed=0)
    dense, sharded = hvt.GPT2LMModel(cfg), hvt.GPT2LMModel(cfg)
    dense.load_state_dict(sd0)
    sharded.load_state_dict(sd0)
    mesh = DeviceMesh("cuda", [0], mesh_dim_names=("tp",))
    gspmd.shard_params(sharded, mesh)
    placements = {n: str(p.placements) for n, p in
                  sharded.named_parameters() if ".blocks.0." in n}
    tokens = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len),
        dtype=np.int64)).cuda()
    reset_counts(*kernels)
    with CommDebugMode() as fwd:
        logits = sharded(tokens).full_tensor()
    with CommDebugMode() as bwd:
        logits.float().logsumexp(-1).mean().backward()
    torch.cuda.synchronize()
    counts = read_counts(*kernels)
    check_counts("gspmd", counts, {"flash_fwd": cfg.n_layers,
                                   "flash_bwd_dkdv": cfg.n_layers,
                                   "flash_bwd_dq": cfg.n_layers,
                                   "fused_adamw": 0}, 1)
    want = dense(tokens)
    want.float().logsumexp(-1).mean().backward()
    torch.cuda.synchronize()
    logits, want = logits.detach(), want.detach()
    logits_bitwise = torch.equal(logits, want)
    logit_err = float((logits.float() - want.float()).abs().max())
    ref = {n: p.grad for n, p in dense.named_parameters()}
    got = {n: p.grad.full_tensor().reshape(ref[n].shape)
           for n, p in sharded.named_parameters()}
    grads_bitwise = all(torch.equal(got[n], ref[n]) for n in ref)
    rel = grads_rel_l2(got, ref)

    def fb(model):
        out = model(tokens)
        out = out.full_tensor() if model is sharded else out
        out.float().logsumexp(-1).mean().backward()

    times = {k: time_ms(lambda m=m: fb(m), samples=5, per_sample=2)
             for k, m in (("dtensor", sharded), ("dense", dense))}
    rec = {"launches": counts, "placements_block0": placements,
           "comm_forward": {str(k): v for k, v in
                            fwd.get_comm_counts().items()},
           "comm_backward": {str(k): v for k, v in
                             bwd.get_comm_counts().items()},
           "logits_bitwise": logits_bitwise, "max_abs_logit_diff": logit_err,
           "grads_bitwise": grads_bitwise, "grads_rel_l2": rel,
           "fwd_bwd_ms": times}
    log(f"[gspmd] GPT-2 small bf16, {TRAIN_BATCH} x {cfg.max_len}, "
        f"parameters as DTensors on a one-rank DeviceMesh(('tp',)) "
        f"(block 0: {placements}); launches {counts}; CommDebugMode "
        f"forward {rec['comm_forward']}, backward {rec['comm_backward']}; "
        f"logits vs the dense module bit for bit {logits_bitwise} (max |d| "
        f"{logit_err:.3e}); gradients bit for bit {grads_bitwise} "
        f"(relative L2 {rel:.3e}, bound {STEP_GRAD_TOL}); forward + "
        f"backward ms {times}")
    if not (logits_bitwise and grads_bitwise):
        log("[gspmd] not bit for bit: DTensor dispatches the dense "
            "products itself and may order their work otherwise; held to "
            "[train]'s bound")
    if not (rel <= STEP_GRAD_TOL
            and logit_err <= 1e-2 * float(want.float().abs().max())):
        raise AssertionError(f"[gspmd] the sharded module disagrees: {rec}")
    hvt.shutdown()
    del dense, sharded, logits, want, got, ref
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def decode_chaos(hvt):
    """[decode-chaos]: [decode]'s CacheLM at GPT-2-small width, fp32 KV,
    two decode workers of 4 rows, 8 streams of 64 tokens, clean and then
    with serve.decode:crash@step=R;n=1: the first worker to reach round R
    dies, its streams requeue and finish on the survivor with the clean
    run's tokens."""
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.serve import CacheLM, CacheLMConfig, DecodeEngine

    t_phase = time.perf_counter()
    cfg = CacheLMConfig(**DECODE_CFG)
    model = CacheLM(cfg, block_size=DECODE_BLOCK)
    params = model.init_params(0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=rng.randint(
        DECODE_PROMPT[0], DECODE_PROMPT[1] + 1)).tolist()
        for _ in range(DECODE_CHAOS_STREAMS)]
    rows = DECODE_CHAOS_STREAMS // 2
    spec = f"serve.decode:crash@step={DECODE_CHAOS_ROUND};n=1"

    def run(armed, prompts=prompts):
        fired0 = chaos.fired.get("serve.decode", 0)
        if armed:
            chaos.plan(spec, seed=0)
        eng = DecodeEngine(model, params, workers=2, rows=rows,
                           kv_blocks=DECODE_KV_BLOCKS // 2,
                           kv_block_size=DECODE_BLOCK,
                           max_seq_len=DECODE_MAX_SEQ, device="cuda").start()
        try:
            t0 = time.perf_counter()
            outs = [f.result(timeout=600.0) for f in
                    [eng.submit(p, DECODE_NEW) for p in prompts]]
            wall = time.perf_counter() - t0
            res = {"requeued": eng.n_requeued, "workers_left": eng.n_workers,
                   "wall_s": wall,
                   "fired": chaos.fired.get("serve.decode", 0) - fired0}
        finally:
            eng.stop()
            chaos.clear()
        return res, outs

    run(False, prompts[:2])  # off the clock: shapes met once
    clean, clean_outs = run(False)
    hit, outs = run(True)
    equal = [list(a) == list(b) for a, b in zip(outs, clean_outs)]
    near_ties = []
    if not all(equal):
        with torch.inference_mode():
            near_ties = recompute_check(
                model, params, [p for p, e in zip(prompts, equal) if not e],
                [o for o, e in zip(outs, equal) if not e])
    rec = {"config": {"streams": DECODE_CHAOS_STREAMS, "new": DECODE_NEW,
                      "workers": 2, "rows": rows, "spec": spec},
           "clean": clean, "chaos": hit, "streams_equal": sum(equal),
           "near_ties": near_ties}
    log(f"[decode-chaos] {spec}: every stream answered "
        f"({sum(len(o) for o in outs)} tokens), requeued {hit['requeued']}, "
        f"workers left {hit['workers_left']}, fired {hit['fired']}; streams "
        f"equal to the clean run's {sum(equal)}/{len(equal)} (near-ties "
        f"{near_ties}); wall {hit['wall_s']:.2f} s vs clean "
        f"{clean['wall_s']:.2f} s")
    if not (hit["requeued"] > 0 and hit["workers_left"] == 1
            and hit["fired"] == 1
            and all(len(o) == DECODE_NEW for o in outs)):
        raise AssertionError(f"[decode-chaos] {rec}")
    del params
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


# ---- the launcher: [launch], [elastic-recover], [serve-kv] ------------------

# The workers these phases start are chaos_soak's harness workers:
# WORKER_PRELUDE (its log() appends JSON records to the run's
# progress.jsonl, which chaos_soak.read_records reads back), then the
# constants, this shared part and the phase's body. record() stamps each
# record with the worker's host, spawn round and wall time (one clock:
# every process runs on this machine).
WORKER_COMMON = '''
import horovod_tpu_torch as hvt
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import fused_adamw as fadam
from horovod_tpu_torch.parallel import dp

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
DEVICE = "cuda"
SPAWN = int(os.environ.get("HVDTPU_SPAWN_ROUND", "-1"))


def record(rec):
    log(dict(rec, host=host_id, spawn=SPAWN, t=time.time()))


def world():
    """This worker's world: NCCL on the card, bootstrapped over the
    launcher's KV; then the kernels the step runs, loaded."""
    hvt.init(backend="nccl")
    for src in (fa.KERNEL_SOURCE, fa.BWD_SOURCE, fadam.KERNEL_SOURCE):
        _build.load(src)


def batch_tokens(cfg, batch):
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (batch, cfg.max_len + 1), dtype=np.int64)
    ).to(DEVICE)


def counts():
    return {"flash_fwd": fa.launches, "flash_bwd_dkdv": fa.launches_dkdv,
            "flash_bwd_dq": fa.launches_dq, "fused_adamw": fadam.launches}


def reset():
    fa.reset_launches()
    fadam.reset_launches()


def digests(tree):
    """sha256 of every tensor's bytes, in the tree's walk order."""
    import hashlib

    out = []
    hvt.checkpoint.map_tensors(lambda t: out.append(hashlib.sha256(
        t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    ).hexdigest()) or t, tree)
    return out
'''

# [launch]: [train]'s configuration, LAUNCH_STEPS steps, one rank.
LAUNCH_WORKER = '''
import torch.nn.functional as F

world()
cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
model = hvt.GPT2LMModel(cfg, device=DEVICE)
model.load_state_dict(hvt.convert.init_params(cfg, seed=0))


def loss_fn(params, tokens):
    logits = torch.func.functional_call(model, params, (tokens[:, :-1],))
    return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())


step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(LR), sharded=True,
                                fused_update=True, device=DEVICE)
state = dp.init_state(model, opt)
tokens = batch_tokens(cfg, BATCH)
losses, launches = [], []
for _ in range(STEPS):
    reset()
    state, loss = step(state, tokens)
    losses.append(float(loss))
    launches.append(counts())
record({"rank": hvt.rank(), "size": hvt.size(),
        "backend": hvt.context.context().backend,
        "kv_store": not os.environ.get("MASTER_ADDR"),
        "losses": losses, "launches": launches})
hvt.shutdown()
'''

# [elastic-recover]: [train-guard]'s configuration through hvt.elastic.run
# for RECOVER_COMMITS commits, checkpointed at RECOVER_CKPT_AT; resumes from
# the newest checkpoint when one exists (the respawn).
RECOVER_WORKER = '''
import torch.nn.functional as F

from horovod_tpu_torch.elastic import worker as ew
from horovod_tpu_torch.guard import GuardConfig

record({"event": "started"})
t0 = time.time()
world()
record({"event": "ready", "init_s": time.time() - t0,
        "join": ew.last_join})
cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
model = hvt.GPT2LMModel(cfg, device=DEVICE)
model.load_state_dict(hvt.convert.init_params(cfg, seed=0))


def loss_fn(params, batch):
    tokens, weight = batch
    logits = torch.func.functional_call(model, params, (tokens[:, :-1],))
    ce = F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten(),
                         reduction="none")
    return (ce.view(tokens.shape[0], -1).mean(-1) * weight).mean()


guard = GuardConfig(**GUARD)
step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(LR), sharded=True,
                                fused_update=True, guard=guard, device=DEVICE)
state = dp.init_state(model, opt, guard=guard)
tokens = batch_tokens(cfg, BATCH)
batch = (tokens, torch.ones(BATCH, device=DEVICE))
t0 = time.time()
try:
    state = hvt.checkpoint.restore_checkpoint(CKDIR, state)
    resumed = int(state.step)
except FileNotFoundError:
    resumed = None
record({"event": "restored", "step": resumed, "restore_s": time.time() - t0})
est = hvt.elastic.TrainState(params=state.params, opt_state=state.opt_state,
                             step=state.step, guard=state.guard)


@hvt.elastic.run
def train(st):
    while int(st.step) < COMMITS:
        cur = dp.TrainState(st.params, st.opt_state, st.step, None, st.guard)
        reset()
        t1 = time.time()
        new, loss = step(cur, batch)
        loss = float(loss)
        c = counts()
        st.params, st.opt_state, st.step, st.guard = (
            new.params, new.opt_state, new.step, new.guard)
        s = int(new.step)
        record({"step": s, "loss": loss, "launches": c, "t0": t1,
                "t1": time.time()})
        if s in CKPT_AT:
            hvt.checkpoint.save_checkpoint(
                CKDIR, dp.TrainState(st.params, st.opt_state, st.step, None,
                                     st.guard), step=s, keep=2)
        record({"event": "commit", "step": s})
        st.commit()
    return st


train(est)
torch.save({"params": {k: v.detach().cpu() for k, v in est.params.items()},
            "opt_sha256": digests(est.opt_state), "step": int(est.step)},
           FINAL)
record({"event": "done"})
hvt.shutdown()
'''

# [serve-kv]: GPT-2 small bf16 from init_params(seed=0) answering the KV
# transport's leases: the greedy next-token id at every position.
SERVE_KV_WORKER = '''
from horovod_tpu_torch.elastic import worker as ew
from horovod_tpu_torch.serve import kv as skv

rank, size = ew.join_world()
cfg = hvt.GPT2Config.small()
model = hvt.GPT2LMModel(cfg, device=DEVICE)
model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
with torch.inference_mode():  # kernels loaded, the batch shape met once
    model(torch.zeros(BATCH, cfg.max_len, dtype=torch.long, device=DEVICE))
record({"event": "ready", "rank": rank})
per_batch = []


def infer(batch):
    fa.reset_launches()
    ids = model(batch.long()).argmax(-1).float()
    per_batch.append(fa.launches)
    return ids


served = skv.kv_worker_serve_loop(
    infer, host_id=host_id, poll_secs=0.02, device=DEVICE,
    on_batch=lambda rec: record(dict(rec, event="batch",
                                     flash=per_batch[-1])))
record({"event": "served", "batches": served})
ew.heartbeat_stop()
sys.exit(0)
'''

LAUNCH_STEPS = 3
RECOVER_COMMITS, RECOVER_CKPT_AT, RECOVER_CRASH_AT = 8, (3, 6), 5
SERVE_KV_REQUESTS = 64
SERVE_KV_CRASH = "serve.dispatch:crash@step=2;host=127.0.0.1;spawn=0"
WORKER_TIMEOUT_S = 300.0
# The recovery phases time what they timed before the analysis plane: the
# certification preflight (a fresh worker's first record, ~12 s of its
# first step on the card) is [analysis]'s to run and to time.
CERT_OFF = {"HVDTPU_CERT": "off"}


def phase_dir(prefix: str) -> Path:
    """A fresh directory for a phase's workers under the ignored _build/."""
    from horovod_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=_build.BUILD_DIR))


def worker_source(body: str, **consts) -> str:
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    return head + WORKER_COMMON + body


def summed(per_step):
    return {k: sum(c[k] for c in per_step) for k in per_step[0]}


def run_group(cmd, env, timeout, cwd):
    """Run ``cmd`` in a session of its own; on the timeout kill the whole
    group (the launcher and its workers) and raise."""
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"{cmd} outlived {timeout} s")
    return proc.returncode, out, err


def launch_phase(hvt, trained):
    """[launch]: ``python -m horovod_tpu_torch.runner.launch -np 1 -H
    localhost:1`` runs a worker that takes [train]'s configuration for
    LAUNCH_STEPS steps in a one-rank NCCL world bootstrapped over the
    launcher's KV."""
    from horovod_tpu_torch.tools.chaos_soak import (WORKER_PRELUDE,
                                                    read_records)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    workdir = phase_dir("launch-")
    try:
        worker = workdir / "worker.py"
        worker.write_text(WORKER_PRELUDE + worker_source(
            LAUNCH_WORKER, BATCH=TRAIN_BATCH, LR=TRAIN_LR,
            STEPS=LAUNCH_STEPS))
        env = dict(os.environ, PYTHONPATH=str(root), PYTHONUNBUFFERED="1",
                   HVDTPU_TEST_WORKDIR=str(workdir),
                   HVDTPU_HOST_ID="localhost")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", "1", "-H", "localhost:1", sys.executable, str(worker)]
        t0 = time.perf_counter()
        rc, _, err = run_group(cmd, env, WORKER_TIMEOUT_S, root)
        wall = time.perf_counter() - t0
        recs = read_records(str(workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if rc != 0 or len(recs) != 1:
        raise AssertionError(f"[launch] rc {rc}, records {recs}: {err[-3000:]}")
    r = recs[0]
    want = trained["losses"][:LAUNCH_STEPS]
    bitwise = r["losses"] == want
    rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], want))
    launches = r["launches"]
    rec = {"rc": rc, "wall_s": wall, "rank": r["rank"], "size": r["size"],
           "backend": r["backend"], "kv_store": r["kv_store"],
           "losses": r["losses"], "train_losses": want,
           "losses_bitwise": bitwise, "losses_max_rel": rel,
           "launches_per_step": launches, "launches": summed(launches)}
    log(f"[launch] hvdtpu-run-torch -np 1 -H localhost:1: rc {rc}, wall "
        f"{wall:.1f} s (process start, CUDA init, kernel load, GPT-2 small "
        f"build, {LAUNCH_STEPS} steps); rank {r['rank']}/{r['size']} "
        f"{r['backend']} world over the KV's store {r['kv_store']}; losses "
        f"{r['losses']} vs [train]'s {want}: bit for bit {bitwise}; launches "
        f"a step {launches}")
    if r["size"] != 1 or not r["kv_store"]:
        raise AssertionError(f"[launch] {rec}")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    check_counts("launch", rec["launches"], {
        "flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
        "flash_bwd_dq": cfg.n_layers,
        "fused_adamw": len(trainer_bucket_sizes(hvt, cfg))}, LAUNCH_STEPS)
    if not bitwise:
        log(f"[launch] the launched losses are not [train]'s bit for bit "
            f"(largest relative difference {rel:.3e}): a step on the card "
            f"is not bitwise repeatable across processes here; held to "
            f"[train]'s bound {STEP_GRAD_TOL}")
        if not rel <= STEP_GRAD_TOL:
            raise AssertionError(f"[launch] {rec}")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def _first(events, kind, after, host=None):
    for e in events:
        if e[0] == kind and e[2] >= after and (host is None or e[1] == host):
            return e
    raise AssertionError(f"no {kind} event after {after}: {events}")


def recover_split(recs, events):
    """The time to recover, split: the crash (the last record before the
    crashed commit) to the driver's reaping of the exit; that to the
    round the host re-enters on probation (the cooldown and discovery);
    the respawn's spawn to its world formed and its kernels loaded (start,
    join, CUDA and NCCL init); the checkpoint restore; the first step
    after the restore."""
    crash = max(r["t"] for r in recs if r.get("spawn") == 0
                and r.get("event") == "commit")
    exit_ = _first(events, "exit", crash)
    round_ = _first(events, "round", exit_[2])
    spawn = _first(events, "spawn", exit_[2])
    new = [r for r in recs if r.get("spawn", 0) > 0]
    started = next(r for r in new if r.get("event") == "started")
    ready = next(r for r in new if r.get("event") == "ready")
    restored = next(r for r in new if r.get("event") == "restored")
    first = next(r for r in new if "loss" in r)
    split = {"crash_to_exit_seen_s": exit_[2] - crash,
             "cooldown_to_round_s": round_[2] - exit_[2],
             "spawn_to_world_s": ready["t"] - spawn[2],
             "spawn_to_started_s": started["t"] - spawn[2],
             "started_to_world_s": ready["t"] - started["t"],
             "round_join_s": ready["join"].get("secs"),
             "restore_s": restored["restore_s"],
             "first_step_s": first["t1"] - first["t0"],
             "total_s": first["t1"] - crash,
             "resumed_at": restored["step"]}
    return split


def elastic_recover(hvt):
    """[elastic-recover]: run_elastic in this process on a discovery script
    that prints localhost:1 (cooldown 1 s; every other setting the
    launcher's own, none of the harness's speed-ups), the worker running
    [train-guard]'s configuration through hvt.elastic.run for
    RECOVER_COMMITS commits, clean and under worker.step:crash at commit
    RECOVER_CRASH_AT (the respawn restores the step-3 checkpoint)."""
    from horovod_tpu_torch.tools.chaos_soak import run_elastic_scenario

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    workdir = phase_dir("recover-")
    runs = {}
    try:
        for label, chaos in (
                ("clean", None),
                ("chaos", f"worker.step:crash@step={RECOVER_CRASH_AT};"
                          "spawn=0")):
            d = workdir / label
            d.mkdir()
            src = worker_source(
                RECOVER_WORKER, BATCH=TRAIN_BATCH, LR=TRAIN_LR,
                GUARD=GUARD_CFG, COMMITS=RECOVER_COMMITS,
                CKPT_AT=RECOVER_CKPT_AT, CKDIR=str(d / "ckpt"),
                FINAL=str(d / "final.pt"))
            job_ref = {}
            t0 = time.perf_counter()
            rc, recs = run_elastic_scenario(
                str(d), src, initial_hosts=["localhost:1"], chaos=chaos,
                extra_env=CERT_OFF,
                driver_env={"HVDTPU_BLACKLIST_COOLDOWN": "1"},
                timeout=WORKER_TIMEOUT_S, drain_timeout=60.0,
                job_ref=job_ref, fast=False)
            wall = time.perf_counter() - t0
            final = torch.load(d / "final.pt")
            runs[label] = {"rc": rc, "wall_s": wall, "recs": recs,
                           "events": list(job_ref["job"].events),
                           "final": final}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    clean, hit = runs["clean"], runs["chaos"]
    pa, pb = clean["final"]["params"], hit["final"]["params"]
    params_bitwise = all(torch.equal(pa[k], pb[k]) for k in pa)
    opt_bitwise = clean["final"]["opt_sha256"] == hit["final"]["opt_sha256"]
    p_rel = grads_rel_l2(pb, pa)
    spawns = sorted({r["spawn"] for r in hit["recs"]})
    steps_by_spawn = {s: [r["step"] for r in hit["recs"]
                          if r.get("spawn") == s and "loss" in r]
                      for s in spawns}
    per_step = [r["launches"] for r in clean["recs"] + hit["recs"]
                if "launches" in r]
    split = recover_split(hit["recs"], hit["events"])
    rec = {"rc": [clean["rc"], hit["rc"]],
           "wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "steps_by_spawn": steps_by_spawn,
           "final_step": [clean["final"]["step"], hit["final"]["step"]],
           "params_bitwise": params_bitwise, "opt_bitwise": opt_bitwise,
           "params_rel_l2": p_rel, "time_to_recover": split,
           "launches_per_step": per_step[0],
           "launches": summed(per_step), "steps": len(per_step),
           "losses": {k: [r["loss"] for r in run["recs"] if "loss" in r]
                      for k, run in runs.items()}}
    log(f"[elastic-recover] run_elastic, discovery localhost:1, cooldown "
        f"1 s, the launcher's own discovery and poll intervals, "
        f"[train-guard]'s configuration for {RECOVER_COMMITS} commits "
        f"(checkpoints at {RECOVER_CKPT_AT}): clean rc {clean['rc']} in "
        f"{clean['wall_s']:.1f} s; worker.step:crash@step={RECOVER_CRASH_AT}"
        f";spawn=0 rc {hit['rc']} in {hit['wall_s']:.1f} s, steps by "
        f"spawn round {steps_by_spawn}; final parameters bit for bit "
        f"{params_bitwise}, optimizer state bit for bit {opt_bitwise} "
        f"(relative L2 {p_rel:.3e}); launches a step {per_step[0]}")
    log("[elastic-recover] time to recover (s): " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in split.items()))
    if clean["rc"] != 0 or hit["rc"] != 0:
        raise AssertionError(f"[elastic-recover] {rec}")
    if not (len(spawns) == 2 and steps_by_spawn[spawns[0]][-1]
            == RECOVER_CRASH_AT and split["resumed_at"] == RECOVER_CKPT_AT[0]
            and steps_by_spawn[spawns[1]] == list(
                range(RECOVER_CKPT_AT[0] + 1, RECOVER_COMMITS + 1))
            and hit["final"]["step"] == clean["final"]["step"]
            == RECOVER_COMMITS):
        raise AssertionError(f"[elastic-recover] the crash and resume did not "
                             f"run as scheduled: {rec}")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    check_counts("elastic-recover", rec["launches"], {
        "flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
        "flash_bwd_dq": cfg.n_layers,
        "fused_adamw": len(trainer_bucket_sizes(hvt, cfg))}, len(per_step))
    if not (params_bitwise and opt_bitwise):
        log("[elastic-recover] the resumed run is not the clean run bit for "
            "bit: a step on the card is not bitwise repeatable across "
            f"processes here; held to [train]'s bound (relative L2 <= "
            f"{STEP_GRAD_TOL})")
        if not p_rel <= STEP_GRAD_TOL:
            raise AssertionError(f"[elastic-recover] {rec}")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def serve_kv_reference(hvt, requests, batch):
    """This process's own answers: the same model, the requests packed
    ``batch`` at a time (the workers' shape), greedy ids at every
    position; and a function recomputing one request's logits."""
    from horovod_tpu_torch.ops.batching import pack_requests, unpack_responses

    cfg = hvt.GPT2Config.small()
    model = hvt.GPT2LMModel(cfg, device="cuda")
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
    answers = []
    with torch.inference_mode():
        for i in range(0, len(requests), batch):
            packed, spec = pack_requests(
                [torch.from_numpy(r) for r in requests[i:i + batch]], batch)
            ids = model(packed.cuda().long()).argmax(-1).float()
            answers += [r.tolist() for r in unpack_responses(ids, spec)]

    def logits_of(req):
        packed, spec = pack_requests([torch.from_numpy(req)], batch)
        with torch.inference_mode():
            logits = model(packed.cuda().long())
        return logits[spec.row_to_request.index(0)].float().cpu()

    return answers, logits_of, model


def serve_kv_run(workdir, requests, chaos):
    """One KV-transport run (``chaos_soak.run_kv_serving``): a
    KVServeCoordinator on the driver's rendezvous server, two serving
    worker processes under the elastic driver (localhost, 127.0.0.1;
    cooldown 1 s; every other setting the launcher's own), every request
    submitted at once and answered."""
    from horovod_tpu_torch.tools.chaos_soak import run_kv_serving

    workdir.mkdir()
    run = run_kv_serving(
        str(workdir), worker_source(SERVE_KV_WORKER, BATCH=SERVE_BATCH),
        requests, extra_env={"HVDTPU_CHAOS": chaos} if chaos else None,
        batch_size=SERVE_BATCH, request_timeout=2.0, trickle=0.0,
        timeout=WORKER_TIMEOUT_S, fast=False)
    if run["timed_out"] or run["wall_s"] is None:
        raise AssertionError(f"[serve-kv] the run did not finish: "
                             f"{run['exc']} {run['diagnostics']}")
    run["requests_per_s"] = len(requests) / run["wall_s"]
    return run


def serve_kv(hvt):
    """[serve-kv]: the KV transport with two GPT-2 small bf16 serving worker
    processes on the one card, clean and then with 127.0.0.1's first
    incarnation killed at its second leased batch."""
    t_phase = time.perf_counter()
    cfg = hvt.GPT2Config.small()
    rng = np.random.default_rng(11)
    requests = [rng.integers(0, cfg.vocab_size, cfg.max_len).astype(
        np.float32) for _ in range(SERVE_KV_REQUESTS)]
    want, logits_of, model = serve_kv_reference(hvt, requests, SERVE_BATCH)
    torch.cuda.empty_cache()
    workdir = phase_dir("servekv-")
    try:
        runs = {label: serve_kv_run(workdir / label, requests, chaos)
                for label, chaos in (("clean", None),
                                     ("chaos", SERVE_KV_CRASH))}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec = {"config": {"requests": SERVE_KV_REQUESTS, "tokens": cfg.max_len,
                      "batch": SERVE_BATCH, "chaos": SERVE_KV_CRASH}}
    for label, run in runs.items():
        near, wrong = [], []
        for i, got in run["answered"].items():
            diff = [p for p, (a, b) in enumerate(zip(got, want[i])) if a != b]
            if not diff:
                continue
            lg = logits_of(requests[i])
            top = lg.abs().max()
            for p in diff:
                gap = abs(float(lg[p, int(got[p])] - lg[p, int(want[i][p])]))
                (near if gap <= DECODE_MARGIN * float(top) else wrong
                 ).append((i, p, gap))
        batches = [r for r in run["records"] if r.get("event") == "batch"]
        flash = sorted({r["flash"] for r in batches})
        by_host = {}
        for r in batches:
            by_host.setdefault(f"{r['host']}/{r['spawn']}", 0)
            by_host[f"{r['host']}/{r['spawn']}"] += 1
        rec[label] = {"rc": run["rc"], "wall_s": run["wall_s"],
                      "requests_per_s": run["requests_per_s"],
                      "answered": len(run["answered"]),
                      "dropped": len(run["errors"]),
                      "requeued": run["requeued"],
                      "batches_by_host_spawn": by_host,
                      "flash_launches_per_batch": flash,
                      "flash_launches": sum(r["flash"] for r in batches),
                      "answers_equal": len(run["answered"]) - len(
                          {i for i, _, _ in near + wrong}),
                      "near_ties": near, "wrong": wrong[:8]}
        log(f"[serve-kv] {label}: {rec[label]['answered']}/"
            f"{SERVE_KV_REQUESTS} answered, dropped {rec[label]['dropped']}, "
            f"requeued {run['requeued']}, wall {run['wall_s']:.3f} s, "
            f"{run['requests_per_s']:.2f} requests/s; batches by host/spawn "
            f"{by_host}; kernel-1 launches a batch {flash}; answers equal to "
            f"this process's forward {rec[label]['answers_equal']} (near-ties "
            f"{near[:4]}, wrong {wrong[:4]})")
        if not (run["rc"] == 0 and not run["errors"]
                and len(run["answered"]) == SERVE_KV_REQUESTS and not wrong):
            raise AssertionError(f"[serve-kv] {label}: {rec[label]} "
                                 f"{run.get('exc')}")
        check_counts(f"serve-kv {label}", {"flash_fwd": sum(
            r["flash"] for r in batches)}, {"flash_fwd": cfg.n_layers},
            len(batches))
    hit = rec["chaos"]
    respawned = any(k.startswith("127.0.0.1/") and not k.endswith("/0")
                    for k in hit["batches_by_host_spawn"])
    log(f"[serve-kv] the killed host served again after its respawn: "
        f"{respawned}")
    if not hit["requeued"] > 0:
        raise AssertionError(f"[serve-kv] nothing was re-queued: {hit}")
    del model
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


# ---- the telemetry planes: [obs], [elastic-quant] -------------------------

OBS_BLOCK, OBS_BLOCKS, OBS_BIT_STEPS, OBS_SERVE_REQUESTS = 10, 4, 3, 16


def obs_arm(on: bool, trace_dir=None):
    """The metrics, trace and goodput planes of this process on or off
    (the step wrapper reads them at every call)."""
    from horovod_tpu_torch.obs import goodput, registry, trace

    if on:
        registry.enable()
        trace.enable(directory=trace_dir)
        goodput.enable()
    else:
        registry.disable()
        trace.disable()
        goodput.disable()


def obs_reset():
    """Every plane off, and their process-global books empty."""
    from horovod_tpu_torch.obs import export, goodput, registry, trace

    registry._registry.reset()
    registry._enabled = None
    trace._reset_for_tests()
    goodput._reset_for_tests()
    export._reporter = None


def state_digest(state):
    """sha256 of every tensor of a TrainState's parameters and optimizer
    state (moments, counts, EF residuals), in walk order."""
    from horovod_tpu_torch import checkpoint as ckpt

    h = hashlib.sha256()

    def add(t):
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
        return t

    ckpt.map_tensors(add, (state.params, state.opt_state))
    return h.hexdigest()


def obs_steps(hvt, cfg, sd0, tokens, bracket, steps, on, trace_dir=None):
    """``steps`` steps of [train]'s configuration from ``sd0`` with the
    planes on or off: the state's digest and the losses."""
    from horovod_tpu_torch.parallel import dp

    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(sd0)
    step, opt = hvt.make_train_step(
        train_loss(model), hvt.fused_adamw(TRAIN_LR), sharded=True,
        fused_update=True, **bracket)
    state = dp.init_state(model, opt)
    obs_reset()
    obs_arm(on, trace_dir)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    obs_arm(False)
    obs_reset()
    digest = state_digest(state)
    del model, step, state
    torch.cuda.empty_cache()
    return digest, losses


def parse_prom(path):
    """Every sample line of a Prometheus textfile as {name: value}; raises
    on a malformed line."""
    out = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        if not name.endswith('{rank="0"}'):
            raise AssertionError(f"malformed prom line {line!r}")
        out[name[:-len('{rank="0"}')]] = float(value)
    return out


def obs_serve(hvt, fa):
    """[serve]'s pool (GPT-2 small bf16, two workers, batch 8) for
    OBS_SERVE_REQUESTS requests, metrics off and on: the greedy next
    token of each request, and the registry's serving counts."""
    from horovod_tpu_torch import obs
    from horovod_tpu_torch.obs import registry
    from horovod_tpu_torch.serve import ServePool

    cfg = hvt.GPT2Config.small()
    model = hvt.GPT2LMModel(cfg, device="cuda")
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (OBS_SERVE_REQUESTS, cfg.max_len), dtype=np.int64)

    def infer(m, t):
        return m(t)[:, -1, :].float()

    out = {}
    for label, on in (("off", False), ("on", True)):
        obs_reset()
        if on:
            obs.enable()
        pool = ServePool(infer, model, workers=2, batch_size=SERVE_BATCH,
                         batch_timeout_ms=5.0, request_timeout_secs=600.0,
                         device="cuda").start()
        try:
            fa.reset_launches()
            futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
            logits = torch.stack([f.result(timeout=600.0) for f in futs])
            batches = pool.dispatcher.n_batches
        finally:
            pool.stop()
        out[label] = {"logits": logits, "flash": fa.launches,
                      "batches": batches,
                      "snapshot": registry._registry.snapshot()}
        obs.disable()
    obs_reset()
    del model
    torch.cuda.empty_cache()
    return out


def obs_phase(hvt, kernels):
    """[obs]: [train]'s configuration with the metrics, trace and goodput
    planes off and on, in alternated blocks of OBS_BLOCK steps; the
    registry, exports, trace and ledger checked against the steps taken;
    then [serve]'s pool with the metrics on."""
    from horovod_tpu_torch.obs import export, flops, goodput, registry, trace
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.tools import hvdtpu_trace as ht

    fa, fadam, tq = kernels
    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    seq = cfg.max_len
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, seq + 1), dtype=np.int64)).cuda()
    n_matmul = sum(v.numel() for k, v in sd0.items()
                   if not k.startswith(("transformer.wte", "transformer.wpe")))
    tokens_per_step = TRAIN_BATCH * seq
    bracket = {"tokens_per_step": tokens_per_step,
               "flops_per_step": tokens_per_step
               * flops.transformer_flops_per_token(n_matmul, cfg.n_layers,
                                                   seq, cfg.d_model)}
    workdir = phase_dir("obs-")
    try:
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(sd0)
        step, opt = hvt.make_train_step(
            train_loss(model), hvt.fused_adamw(TRAIN_LR), sharded=True,
            fused_update=True, **bracket)
        state = dp.init_state(model, opt)
        for _ in range(TRAIN_WARMUP):
            state, _ = step(state, tokens)
        n_bkt = n_buckets(state)
        obs_reset()
        export._reporter = export.MetricsReporter(
            directory=str(workdir / "metrics"))
        times = {"off": [], "on": []}
        per_step = {"off": [], "on": []}
        losses = []
        for b in range(2 * OBS_BLOCKS):
            side = "off" if b % 2 == 0 else "on"
            obs_arm(side == "on", str(workdir / "trace"))
            for _ in range(OBS_BLOCK):
                reset_counts(fa, fadam, tq)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, tokens)
                torch.cuda.synchronize()
                times[side].append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
                per_step[side].append(read_counts(fa, fadam, tq))
        # The last block ran with the planes on: read and export them
        # before switching them off.
        n_on = OBS_BLOCK * OBS_BLOCKS
        snap = registry._registry.snapshot()
        per_sec = snap["gauges"]["step.per_sec"]
        tp = step.throughput(1.0 / per_sec)
        mfu = snap["gauges"].get("step.mfu")
        record = export._reporter.flush(summarize=False)
        dump = trace.flight_dump("obs")
        obs_arm(False)
        jsonl = [json.loads(line) for line in
                 (workdir / "metrics" / "rank0.jsonl").read_text()
                 .splitlines()]
        prom = parse_prom(workdir / "metrics" / "rank0.prom")
        doc = json.loads(Path(dump).read_text())
        spans = [e for e in doc["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "train"]
        steps_ = [e for e in spans if e["name"] == "step"]
        disp = [e for e in spans if e["name"] == "step.host_dispatch"]
        dev = [e for e in spans if e["name"] == "step.device"]
        inside = all(
            s["ts"] <= h["ts"] and h["ts"] + h["dur"] <= s["ts"] + s["dur"] + 2
            and s["ts"] <= d["ts"] and d["ts"] + d["dur"] <= s["ts"]
            + s["dur"] + 2
            for s, h, d in zip(steps_, disp, dev))
        parts = [abs(h["dur"] + d["dur"] - s["dur"]) / s["dur"]
                 for s, h, d in zip(steps_, disp, dev)]
        gp = goodput.ledger().snapshot()
        device_s = sum(d["dur"] for d in dev) / 1e6
        merged = ht.merge_dir(str(workdir / "trace"))
        del model, step, state
        torch.cuda.empty_cache()
        # Three steps from one start, the planes off and on.
        d_off, l_off = obs_steps(hvt, cfg, sd0, tokens, bracket,
                                 OBS_BIT_STEPS, False)
        d_on, l_on = obs_steps(hvt, cfg, sd0, tokens, bracket,
                               OBS_BIT_STEPS, True, str(workdir / "trace3"))
        hvt.shutdown()
        served = obs_serve(hvt, fa)
    finally:
        obs_arm(False)
        obs_reset()
        shutil.rmtree(workdir, ignore_errors=True)
    med = {k: float(np.median(v)) for k, v in times.items()}
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers, "fused_adamw": n_bkt,
            "quantize_blockwise": 0, "dequantize_blockwise": 0}
    for side in ("off", "on"):
        for c in per_step[side]:
            check_counts(f"obs {side}", c, want, 1)
    counts = {side: summed(per_step[side]) for side in per_step}
    checks = {
        "step_count": snap["counters"].get("step.count") == n_on,
        "step_tokens": snap["counters"].get("step.tokens")
        == tokens_per_step * n_on,
        "histogram_counts": all(
            snap["histograms"][h]["count"] == n_on for h in (
                "step.total_ms", "step.host_dispatch_ms", "step.device_ms")),
        "dispatch_plus_device_is_total": len(parts) == n_on
        and max(parts) <= 0.01,
        "mfu_is_throughputs": mfu is not None and tp["mfu"] is not None
        and abs(mfu - tp["mfu"]) <= 1e-6 * abs(tp["mfu"]),
        "jsonl_counters": jsonl[-1]["counters"] == record["counters"]
        == snap["counters"],
        "prom_parses": prom.get("hvdtpu_step_count") == n_on,
        "trace_one_step_span_a_step": len(steps_) == len(disp) == len(dev)
        == n_on and inside,
        "trace_merges": merged is not None
        and ht.validate_events(merged["traceEvents"]) == [],
        "ledger_conserves": abs(sum(gp["totals"].values())
                                - gp["elapsed_s"]) <= 1e-3,
        # The ledger books the device bracket as compute, less the
        # exposed_comm it carves out against the rolling-min device time.
        "ledger_device": gp["totals"]["compute"]
        + gp["totals"]["exposed_comm"] >= device_s - 1e-3,
        "bitwise_on_off": d_on == d_off and l_on == l_off,
    }
    s_on, s_off = served["on"], served["off"]
    ss = s_on["snapshot"]
    serve_checks = {
        "requests": ss["counters"].get("serve.requests")
        == OBS_SERVE_REQUESTS,
        "responses": ss["counters"].get("serve.responses")
        == OBS_SERVE_REQUESTS,
        "request_histogram": ss["histograms"]["serve.request_ms"]["count"]
        == OBS_SERVE_REQUESTS,
        "answers_equal": torch.equal(s_on["logits"].argmax(-1),
                                     s_off["logits"].argmax(-1)),
        "off_recorded_nothing": s_off["snapshot"]["counters"] == {},
    }
    logit_diff = float((s_on["logits"] - s_off["logits"]).abs().max())
    rec = {"step_ms_median": med, "step_ms": times,
           "on_minus_off_ms": med["on"] - med["off"],
           "on_over_off": med["on"] / med["off"], "losses": losses,
           "launches": counts, "launches_per_step": per_step["on"][0],
           "steps_on": n_on, "mfu_gauge": mfu, "mfu_throughput": tp["mfu"],
           "tokens_per_s_gauge": snap["gauges"].get("step.tokens_per_sec"),
           "host_dispatch_ms_p50":
               snap["histograms"]["step.host_dispatch_ms"]["p50"],
           "device_ms_p50": snap["histograms"]["step.device_ms"]["p50"],
           "total_ms_p50": snap["histograms"]["step.total_ms"]["p50"],
           "dispatch_plus_device_max_rel": max(parts) if parts else None,
           "goodput": gp, "device_s": device_s, "names": {
               sec: sorted(snap[sec]) for sec in snap},
           "checks": checks, "serve": {
               "checks": serve_checks, "logit_max_abs_diff": logit_diff,
               "flash": {k: served[k]["flash"] for k in served},
               "batches": {k: served[k]["batches"] for k in served},
               "request_ms": ss["histograms"]["serve.request_ms"]}}
    log(f"[obs] [train]'s configuration, planes off / on in alternated "
        f"blocks of {OBS_BLOCK} ({OBS_BLOCKS} a side): step median off "
        f"{med['off']:.3f} ms, on {med['on']:.3f} ms, on - off "
        f"{med['on'] - med['off']:+.3f} ms ({med['on'] / med['off']:.4f}x); "
        f"host_dispatch p50 {rec['host_dispatch_ms_p50']:.3f} ms, device p50 "
        f"{rec['device_ms_p50']:.3f} ms, total p50 {rec['total_ms_p50']:.3f}"
        f" ms; step.mfu {mfu} vs throughput() {tp['mfu']}; launches a step "
        f"{per_step['on'][0]}")
    log("[obs] goodput (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in gp["totals"].items() if v)
        + f"; elapsed {gp['elapsed_s']:.4f}, fraction {gp['fraction']:.4f}; "
        f"sum of step.device {device_s:.4f}")
    log(f"[obs] checks {checks}")
    log(f"[obs] serve: {OBS_SERVE_REQUESTS} requests, metrics on vs off: "
        f"{serve_checks}; request_ms {rec['serve']['request_ms']}; max |d| "
        f"of the last logits {logit_diff:.3e}; flash launches "
        f"{rec['serve']['flash']} in {rec['serve']['batches']} batches")
    bad = [k for k, v in {**checks, **serve_checks}.items() if not v]
    if bad:
        raise AssertionError(f"[obs] failed {bad}: {rec}")
    for label in ("off", "on"):
        check_counts(f"obs serve {label}", {"flash_fwd": served[label][
            "flash"]}, {"flash_fwd": cfg.n_layers}, served[label]["batches"])
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


# [elastic-quant]: [train-quant-zero1]'s configuration (ZeRO-1 fused AdamW on
# the int8 wire, block 256, error feedback) through hvt.elastic.run for
# QUANT_COMMITS commits, the TrainState checkpointed at QUANT_CKPT_AT; resumes
# from the newest checkpoint when one exists (the respawn).
ELASTIC_QUANT_WORKER = """
import torch.nn.functional as F

from horovod_tpu_torch.elastic import worker as ew
from horovod_tpu_torch.ops import quantization as tq
from horovod_tpu_torch.optimizer import ef_residual_norm

record({"event": "started", "pid": os.getpid()})
t0 = time.time()
world()
_build.load(tq.KERNEL_SOURCE)
record({"event": "ready", "init_s": time.time() - t0,
        "join": ew.last_join})
cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
model = hvt.GPT2LMModel(cfg, device=DEVICE)
model.load_state_dict(hvt.convert.init_params(cfg, seed=0))


def loss_fn(params, tokens):
    logits = torch.func.functional_call(model, params, (tokens[:, :-1],))
    return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())


def residual_digests(opt_state):
    return digests(opt_state.residual)


step, opt = hvt.make_train_step(
    loss_fn, hvt.fused_adamw(LR), sharded=True, fused_update=True,
    compression=hvt.Compression.int8.with_block(BLOCK), device=DEVICE)
state = dp.init_state(model, opt)
tokens = batch_tokens(cfg, BATCH)
t0 = time.time()
try:
    state = hvt.checkpoint.restore_checkpoint(CKDIR, state)
    resumed = int(state.step)
except FileNotFoundError:
    resumed = None
record({"event": "restored", "step": resumed, "restore_s": time.time() - t0,
        "residual_norm": ef_residual_norm(state.opt_state),
        "residual_sha256": residual_digests(state.opt_state)})
est = hvt.elastic.TrainState(params=state.params, opt_state=state.opt_state,
                             step=state.step)


def counts_q():
    return dict(counts(), quantize_blockwise=tq.launches_quant,
                dequantize_blockwise=tq.launches_dequant)


@hvt.elastic.run
def train(st):
    while int(st.step) < COMMITS:
        cur = dp.TrainState(st.params, st.opt_state, st.step)
        reset()
        tq.reset_launches()
        t1 = time.time()
        new, loss = step(cur, tokens)
        loss = float(loss)
        c = counts_q()
        st.params, st.opt_state, st.step = (new.params, new.opt_state,
                                            new.step)
        s = int(new.step)
        record({"step": s, "loss": loss, "launches": c, "t0": t1,
                "t1": time.time()})
        if s in CKPT_AT:
            hvt.checkpoint.save_checkpoint(
                CKDIR, dp.TrainState(st.params, st.opt_state, st.step),
                step=s, keep=2)
            record({"event": "saved", "step": s,
                    "residual_norm": ef_residual_norm(st.opt_state),
                    "residual_sha256": residual_digests(st.opt_state)})
        record({"event": "commit", "step": s})
        st.commit()
    return st


train(est)
torch.save({"params": {k: v.detach().cpu() for k, v in est.params.items()},
            "opt_sha256": digests(est.opt_state), "step": int(est.step)},
           FINAL)
record({"event": "done"})
hvt.shutdown()
"""


def elastic_quant_reference(hvt, commits):
    """The uninterrupted run in this process: ``commits`` steps of the
    worker's configuration from the same start."""
    from horovod_tpu_torch.parallel import dp

    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
    step, opt = hvt.make_train_step(
        train_loss(model), hvt.fused_adamw(TRAIN_LR), sharded=True,
        fused_update=True,
        compression=hvt.Compression.int8.with_block(QUANT_BLOCK))
    state = dp.init_state(model, opt)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1), dtype=np.int64)
    ).cuda()
    losses = []
    for _ in range(commits):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    out = {"params": {k: v.detach().cpu() for k, v in state.params.items()},
           "opt_sha256": [], "losses": losses}
    hvt.checkpoint.map_tensors(lambda t: out["opt_sha256"].append(
        hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8)
                       .cpu().numpy()).hexdigest()) or t, state.opt_state)
    hvt.shutdown()
    del model, step, state
    torch.cuda.empty_cache()
    return out


def elastic_quant(hvt, n_quant_buckets):
    """[elastic-quant]: the ``quant`` soak scenario at full width -- GPT-2
    small on the int8 ZeRO-1 wire through hvt.elastic.run under
    run_elastic at [elastic-recover]'s settings, the worker killed at
    commit RECOVER_CRASH_AT and the respawn resumed from the step-3
    checkpoint, with the metrics, trace and goodput planes on in the driver
    and the workers."""
    from horovod_tpu_torch.obs import export, goodput, registry, trace
    from horovod_tpu_torch.runner import elastic_driver
    from horovod_tpu_torch.tools import hvdtpu_trace as ht
    from horovod_tpu_torch.tools.chaos_soak import run_elastic_scenario

    t_phase = time.perf_counter()
    want_run = elastic_quant_reference(hvt, RECOVER_COMMITS)
    torch.cuda.empty_cache()
    workdir = phase_dir("equant-")
    trace_dir = workdir / "trace"
    try:
        src = worker_source(
            ELASTIC_QUANT_WORKER, BATCH=TRAIN_BATCH, LR=TRAIN_LR,
            BLOCK=QUANT_BLOCK, COMMITS=RECOVER_COMMITS,
            CKPT_AT=RECOVER_CKPT_AT, CKDIR=str(workdir / "ckpt"),
            FINAL=str(workdir / "final.pt"))
        planes = {"HVDTPU_METRICS": "1",
                  "HVDTPU_METRICS_DIR": str(workdir / "metrics"),
                  "HVDTPU_TRACE": "1", "HVDTPU_TRACE_DIR": str(trace_dir),
                  "HVDTPU_GOODPUT": "1", **CERT_OFF}
        obs_reset()
        registry.enable()
        goodput.enable()
        trace.enable(directory=str(trace_dir))
        # The driver's exports go beside the workers' (its reporter is
        # made once a process; this phase's is dropped after).
        elastic_driver._driver_rep = export.MetricsReporter(
            role="driver", directory=str(workdir / "metrics"))
        job_ref = {}
        t0 = time.perf_counter()
        try:
            rc, recs = run_elastic_scenario(
                str(workdir), src, initial_hosts=["localhost:1"],
                chaos=f"worker.step:crash@step={RECOVER_CRASH_AT};spawn=0",
                extra_env=planes,
                driver_env={"HVDTPU_BLACKLIST_COOLDOWN": "1"},
                timeout=WORKER_TIMEOUT_S, drain_timeout=60.0,
                job_ref=job_ref, fast=False)
        finally:
            job = job_ref.get("job")
            gp = job.goodput_snapshot() if job is not None else None
            events = list(job.events) if job is not None else []
            obs_arm(False)
            obs_reset()
            elastic_driver._driver_rep = None
        wall = time.perf_counter() - t0
        final = torch.load(workdir / "final.pt")
        dumps = sorted(p.name for p in trace_dir.glob("trace_*.json"))
        merged = ht.merge_dir(str(trace_dir))
        dead = [r["pid"] for r in recs
                if r.get("event") == "started" and r.get("spawn") == 0]
        dead_dump = None
        for name in dumps:
            if dead and name.endswith(f".{dead[0]}.json"):
                dead_dump = json.loads((trace_dir / name).read_text())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    saved = {r["step"]: r for r in recs if r.get("event") == "saved"
             and r.get("spawn") == 0}
    restored = [r for r in recs if r.get("event") == "restored"
                and r.get("spawn", 0) > 0]
    per_step = [r["launches"] for r in recs if "launches" in r]
    pa, pb = want_run["params"], final["params"]
    params_bitwise = all(torch.equal(pa[k], pb[k]) for k in pa)
    opt_bitwise = want_run["opt_sha256"] == final["opt_sha256"]
    p_rel = grads_rel_l2(pb, pa)
    events_m = (merged or {}).get("traceEvents", [])
    crash = [e for e in events_m if e.get("name") == "chaos.worker.step"
             and e.get("args", {}).get("action") == "crash"]
    after = [e for e in events_m if e.get("name") == "step"
             and e.get("cat") == "train" and crash
             and e["ts"] > max(c["ts"] for c in crash)]
    split = recover_split(recs, events)
    res_ok = bool(restored) and bool(saved.get(RECOVER_CKPT_AT[0])) and (
        restored[0]["residual_norm"] or 0) > 0 and restored[0][
        "residual_sha256"] == saved[RECOVER_CKPT_AT[0]]["residual_sha256"]
    checks = {
        "rc": rc == 0,
        "resumed_at_first_checkpoint": bool(restored)
        and restored[0]["step"] == RECOVER_CKPT_AT[0],
        "residuals_restored_bitwise": res_ok,
        "final_step": final["step"] == RECOVER_COMMITS,
        "dead_dump_on_disk": dead_dump is not None and any(
            r.startswith("chaos_crash") for r in
            dead_dump["metadata"]["reasons"]),
        # One dump a process: the driver's and each incarnation's.
        "trace_merges_every_dump": merged is not None
        and len(merged["metadata"]["merged_from"]) == len(dumps) >= 3
        and set(merged["metadata"]["merged_from"]) == {"driver", "localhost"}
        and ht.validate_events(events_m) == [],
        "trace_holds_crash_and_respawn_step": bool(crash) and bool(after),
        "ledger_conserves": gp is not None and abs(
            sum(gp["totals"].values()) - gp["elapsed_s"]) <= 1e-3,
        "rescale_downtime": gp is not None
        and gp["totals"]["rescale_downtime"] > 0,
    }
    rec = {"rc": rc, "wall_s": wall, "final_step": final["step"],
           "params_bitwise": params_bitwise, "opt_bitwise": opt_bitwise,
           "params_rel_l2": p_rel, "time_to_recover": split,
           "goodput": gp, "dumps": dumps,
           "merged_from": (merged or {}).get("metadata", {}).get(
               "merged_from"),
           "residual_norm_saved": saved.get(RECOVER_CKPT_AT[0], {}).get(
               "residual_norm"),
           "residual_norm_restored": restored[0]["residual_norm"]
           if restored else None,
           "launches_per_step": per_step[0] if per_step else None,
           "launches": summed(per_step) if per_step else {},
           "steps": len(per_step),
           "losses": [r["loss"] for r in recs if "loss" in r],
           "reference_losses": want_run["losses"], "checks": checks}
    log(f"[elastic-quant] run_elastic, discovery localhost:1, cooldown 1 s, "
        f"the launcher's own intervals; GPT-2 small ZeRO-1 fused AdamW on "
        f"the int8 wire (block {QUANT_BLOCK}, EF) for {RECOVER_COMMITS} "
        f"commits, checkpoints at {RECOVER_CKPT_AT}, "
        f"worker.step:crash@step={RECOVER_CRASH_AT};spawn=0, the planes on: "
        f"rc {rc} in {wall:.1f} s; residual norm saved at step "
        f"{RECOVER_CKPT_AT[0]} {rec['residual_norm_saved']}, restored "
        f"{rec['residual_norm_restored']}; final parameters bit for bit "
        f"the uninterrupted run {params_bitwise}, moments and residuals "
        f"{opt_bitwise} (relative L2 {p_rel:.3e}); launches a step "
        f"{rec['launches_per_step']}")
    log("[elastic-quant] time to recover (s): " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in split.items()))
    if gp is not None:
        log("[elastic-quant] the driver's goodput (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in gp["totals"].items() if v)
            + f"; elapsed {gp['elapsed_s']:.4f}")
    log(f"[elastic-quant] dumps {dumps}; checks {checks}")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"[elastic-quant] failed {bad}: {rec}")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    check_counts("elastic-quant", rec["launches"], {
        "flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
        "flash_bwd_dq": cfg.n_layers, "fused_adamw": n_quant_buckets,
        "quantize_blockwise": 2 * n_quant_buckets,
        "dequantize_blockwise": 2 * n_quant_buckets}, len(per_step))
    if not (params_bitwise and opt_bitwise):
        log("[elastic-quant] the resumed run is not the uninterrupted one bit "
            "for bit: a step on the card is not bitwise repeatable across "
            f"processes here; held to [train]'s bound (relative L2 <= "
            f"{STEP_GRAD_TOL})")
        if not p_rel <= STEP_GRAD_TOL:
            raise AssertionError(f"[elastic-quant] {rec}")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


# ---- the tuning and streaming planes: [autotune], [serve-autotune],
# ---- [stream], [profile-step] -----------------------------------------------


def autotune_phase(hvt, kernels):
    """[autotune]: GPT-2 small, replicated unfused adamw(1e-4), under
    make_train_step(autotune=AutotuneConfig(...)) on a one-rank NCCL world:
    the local search over the fusion threshold to convergence, each trial's
    vector, bucket count, score and retraces; then an untuned run of as
    many steps from the same start, bit for bit."""
    from horovod_tpu_torch import obs, tune
    from horovod_tpu_torch.ops import batching, fusion
    from horovod_tpu_torch.parallel import dp

    fa, fadam, tq = kernels
    t_phase = time.perf_counter()
    card = card_line()
    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1),
        dtype=np.int64)).cuda()
    tcfg = tune.AutotuneConfig(**AUTOTUNE_CFG)
    calls = [0]
    orig = fusion.reduce_bucket

    def spy(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    def build(autotune):
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(sd0)
        step, opt = hvt.make_train_step(
            train_loss(model), hvt.adamw(TRAIN_LR), sharded=False,
            fused_update=False, autotune=autotune)
        return model, step, dp.init_state(model, opt)

    # A switch writes its knobs into the environment (that is how a
    # rebuild reads them): put them back for the untuned run and every
    # later phase.
    env0 = {k: v for k, v in os.environ.items() if k.startswith("HVDTPU_")}
    obs_reset()
    obs.enable()
    fusion.reduce_bucket = spy
    try:
        model, step, state = build(tcfg)
        client = step.autotune
        reset_counts(fa, fadam, tq)
        per_step, losses, trials = [], [], {}
        n = 0
        while not client.done and n < AUTOTUNE_MAX_STEPS:
            calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, tokens)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n += 1
            losses.append(float(loss))
            trial = client.applied_trial
            want = len(batching.pack_spec(state.params)[1].buckets)
            per_step.append({"trial": trial, "ms": ms, "buckets": calls[0],
                             "buckets_want": want})
            trials.setdefault(trial, {"vector": dict(client.applied),
                                      "buckets": calls[0],
                                      "buckets_want": want, "ms": [],
                                      "retraces": step._n_retraces})
            trials[trial]["ms"].append(ms)
        counts = read_counts(fa, fadam, tq)
        search = client.source.search
        snap = obs.metrics().snapshot()
    finally:
        fusion.reduce_bucket = orig
        obs_reset()
    hist = search.history()
    for t, (vec, score) in enumerate(hist):
        rec = trials.get(t, {})
        log(f"[autotune] trial {t}: {vec}, {rec.get('buckets')} buckets "
            f"(its threshold gives {rec.get('buckets_want')}), score "
            f"{score:.4f} (-mean step ms of the window), step median "
            f"{np.median(rec.get('ms', [float('nan')])):.3f} ms on {card}; "
            f"retraces before it {rec.get('retraces')}")
    if not client.done:
        raise AssertionError(f"[autotune] no convergence in {n} steps")
    best = client.best
    log(f"[autotune] converged after {search.n_trials} trials, {n} steps: "
        f"best {best} (score {search.best_score:.4f}); retraces "
        f"{step._n_retraces}; switches {len(client.switch_log)}")
    # The tuned vector timed beside the default (trial 0), after the search.
    tuned_ms = []
    for _ in range(AUTOTUNE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        torch.cuda.synchronize()
        tuned_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        n += 1
    check_counts("autotune", {k: v for k, v in counts.items()
                              if k.startswith("flash")},
                 {k: cfg.n_layers for k in ("flash_fwd", "flash_bwd_dkdv",
                                            "flash_bwd_dq")},
                 n - AUTOTUNE_TIMED)
    check_falling("autotune", losses)
    bad = [s for s in per_step if s["buckets"] != s["buckets_want"]]
    if bad:
        raise AssertionError(f"[autotune] steps whose bucket count is not "
                             f"their threshold's: {bad[:4]}")
    gauges, counters = snap["gauges"], snap["counters"]
    want_counters = {"autotune.trials": search.n_trials,
                     "autotune.switches": len(client.switch_log),
                     "autotune.retraces": step._n_retraces}
    got_counters = {k: counters.get(k, 0) for k in want_counters}
    if got_counters != want_counters or gauges.get(
            "autotune.converged") != 1.0 or gauges.get(
            "autotune.best_score") != search.best_score or gauges.get(
            "autotune.trial") != float(client.applied_trial):
        raise AssertionError(f"[autotune] registry {got_counters}, gauges "
                             f"{gauges} vs the client's {want_counters}")
    tuned = {k: v.detach().cpu() for k, v in state.params.items()}
    retraces = step._n_retraces
    for k in [k for k in os.environ if k.startswith("HVDTPU_")]:
        if k not in env0:
            del os.environ[k]
    os.environ.update(env0)
    hvt.shutdown()
    del model, step, state
    torch.cuda.empty_cache()
    # The untuned run, as many steps from the same start.
    hvt.init(backend="nccl")
    model, step_u, state_u = build(False)
    for _ in range(n):
        state_u, _ = step_u(state_u, tokens)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(tuned[k], v.detach().cpu())
                  for k, v in state_u.params.items())
    excess = None
    if not bitwise:
        # [train]'s one-step bound, n steps of it.
        excess = max(float(((tuned[k] - v.detach().cpu()).abs()
                            - n * (2 * TRAIN_LR * (1 + 1e-4 * v.detach(
                                ).cpu().abs()) + 1e-6)).max())
                     for k, v in state_u.params.items())
        log(f"[autotune] tuned and untuned parameters differ (largest "
            f"excess over n x 2 lr: {excess:.3e}): the reduction's bucket "
            f"layout changed a sum's order")
        if excess > 0:
            raise AssertionError("[autotune] the tuned run left [train]'s "
                                 "bound")
    hvt.shutdown()
    del model, step_u, state_u, tuned
    torch.cuda.empty_cache()
    default_ms = float(np.median(trials[0]["ms"]))
    tuned_med = float(np.median(tuned_ms))
    rec = {"config": AUTOTUNE_CFG, "steps": n, "trials": [
        {"vector": v, "score": s, "buckets": trials.get(t, {}).get("buckets"),
         "step_ms_median": float(np.median(trials.get(t, {}).get(
             "ms", [float("nan")])))} for t, (v, s) in enumerate(hist)],
        "best": best, "retraces": retraces,
        "launches": counts, "default_step_ms": default_ms,
        "tuned_step_ms": tuned_med, "bitwise_untuned": bitwise,
        "excess": excess, "losses": losses, "card": card}
    log(f"[autotune] step median, default vector {default_ms:.3f} ms, tuned "
        f"{tuned_med:.3f} ms ({AUTOTUNE_TIMED} steps after the search) on "
        f"{card}; parameters after {n} steps bit for bit the untuned run's: "
        f"{bitwise}; launches {counts}; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def serve_autotune(hvt, fa):
    """[serve-autotune]: [serve]'s model (GPT-2 small, bf16) in a ServePool
    of 2 workers, batch 8, with autotune=...: 1024-token requests until
    ServeLatencyScorer has closed AUTOTUNE_SERVE_MIN_TRIALS trials; the
    dispatcher's fill window and the policy's watermarks flipped in place
    to each trial's vector; the answers those of an untuned pool."""
    from horovod_tpu_torch import tune
    from horovod_tpu_torch.serve import QueueDepthPolicy, ServePool
    from horovod_tpu_torch.tune import serve as tserve

    t_phase = time.perf_counter()
    card = card_line()
    cfg = hvt.GPT2Config.small()
    model = hvt.GPT2LMModel(cfg, device="cuda")
    model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE_REQUESTS, cfg.max_len), dtype=np.int64)

    def infer(m, t):
        return m(t)[:, -1, :]

    applied = []
    orig_apply = tserve.ServeTuner._apply

    def spy_apply(self, vector):
        orig_apply(self, vector)
        d, p = self.pool.dispatcher, self.pool.policy
        applied.append({"vector": dict(vector),
                        "timeout_ms": d.batch_timeout_ms,
                        "high": p.high, "low": p.low})

    def run(autotune):
        pool = ServePool(infer, model, workers=2, batch_size=SERVE_BATCH,
                         batch_timeout_ms=5.0, request_timeout_secs=600.0,
                         policy=QueueDepthPolicy(), device="cuda",
                         autotune=autotune).start()
        answers, rounds = [], 0
        try:
            with torch.inference_mode():
                infer(model, torch.from_numpy(tokens[:SERVE_BATCH]).cuda())
            torch.cuda.synchronize()
            fa.reset_launches()
            b0 = pool.dispatcher.n_batches
            t0 = time.perf_counter()
            while True:
                futs = [pool.submit(torch.from_numpy(t)) for t in tokens]
                got = [f.result(timeout=600.0) for f in futs]
                answers = answers or got
                rounds += 1
                if autotune is False or rounds >= AUTOTUNE_SERVE_MAX_ROUNDS:
                    break
                if (pool.tuner.done or pool.tuner.search.n_trials
                        >= AUTOTUNE_SERVE_MIN_TRIALS):
                    break
            wall = time.perf_counter() - t0
            launches, batches = fa.launches, pool.dispatcher.n_batches - b0
            tuner = pool.tuner
        finally:
            pool.stop()
        return {"answers": answers, "rounds": rounds, "wall_s": wall,
                "launches": launches, "batches": batches, "tuner": tuner}

    tserve.ServeTuner._apply = spy_apply
    try:
        tuned = run(tune.AutotuneConfig(**AUTOTUNE_SERVE_CFG))
    finally:
        tserve.ServeTuner._apply = orig_apply
        obs_reset()
    plain = run(False)
    search = tuned["tuner"].search
    for a in applied:
        v = a["vector"]
        if (a["timeout_ms"] != v["SERVE_BATCH_TIMEOUT_MS"]
                or a["high"] != v["SERVE_QUEUE_HIGH"]
                or a["low"] != v["SERVE_QUEUE_LOW"]):
            raise AssertionError(f"[serve-autotune] a trial's vector is not "
                                 f"the pool's: {a}")
    for t, (v, s) in enumerate(search.history()):
        log(f"[serve-autotune] trial {t}: {v}, score {s:.3f} (-p95 request "
            f"ms) on {card}")
    if search.n_trials < AUTOTUNE_SERVE_MIN_TRIALS:
        raise AssertionError(f"[serve-autotune] {search.n_trials} trials "
                             "closed")
    if tuned["launches"] != cfg.n_layers * tuned["batches"]:
        raise AssertionError(f"[serve-autotune] {tuned['launches']} flash "
                             f"launches in {tuned['batches']} batches")
    got = torch.stack(tuned["answers"])
    ref = torch.stack(plain["answers"])
    bitwise = torch.equal(got, ref)
    if not bitwise:
        err = (got - ref).abs().max().item()
        bound = 0.05 * ref.abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > bound
        same = got.argmax(-1) == ref.argmax(-1)
        log(f"[serve-autotune] answers differ from the untuned pool's "
            f"(max |d| {err:.4e}, bound {bound:.4e}; argmax equal on "
            f"{int(same.sum())}/{len(same)}): another batch composition")
        if err > bound or not bool(same[decided].all()):
            raise AssertionError("[serve-autotune] answers disagree")
    rec = {"config": AUTOTUNE_SERVE_CFG, "trials": [
        {"vector": v, "score": s} for v, s in search.history()],
        "applied": applied, "done": tuned["tuner"].done,
        "rounds": tuned["rounds"], "batches": tuned["batches"],
        "launches": {"flash_fwd": tuned["launches"]},
        "answers_bitwise_untuned": bitwise,
        "wall_s": tuned["wall_s"], "untuned_wall_s": plain["wall_s"],
        "card": card}
    log(f"[serve-autotune] {tuned['rounds']} rounds of {SERVE_REQUESTS} "
        f"requests, {tuned['batches']} batches, {search.n_trials} trials "
        f"closed (done {tuned['tuner'].done}), {len(applied)} vectors "
        f"applied in place; answers bit for bit the untuned pool's: "
        f"{bitwise}; wall {tuned['wall_s']:.2f} s vs untuned "
        f"{plain['wall_s']:.2f} s for {plain['rounds']} round(s) on {card}")
    del model
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def stream_loss(model, pool):
    """Teacher-forced next-token cross entropy through ``model.extend``
    over an empty cache (every row's window is its whole context), on the
    nested tree of the trainer's flat parameter dict."""
    import torch.nn.functional as F

    from horovod_tpu_torch.stream import as_tree

    def loss_fn(params, toks):
        r = toks.shape[0]
        zeros = torch.zeros((r,), dtype=torch.int32, device=toks.device)
        scratch = torch.full((r, 1), pool.n_blocks, dtype=torch.int64,
                             device=toks.device)
        logits, _, _ = model.extend(as_tree(params), toks[:, :-1], zeros,
                                    scratch, zeros, *pool.device_args())
        return F.cross_entropy(logits.flatten(0, 1).float(),
                               toks[:, 1:].flatten())

    return loss_fn


def stream_phase(hvt, kernels):
    """[stream]: a ZeRO-1 fused trainer of CacheLM at [decode]'s width
    publishing every STREAM_EVERY steps through an in-process
    RendezvousServer into a StreamSubscriber that flips an int8-KV
    DecodeEngine (2 workers) while it decodes; publish.delta:torn once,
    a stale-epoch manifest after; then the int8 subscriber's
    re-quantization through kernel 4."""
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.ops import batching
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.runner.http_server import RendezvousServer
    from horovod_tpu_torch.serve import (CacheLM, CacheLMConfig, DecodeEngine,
                                         KVBlockPool)
    from horovod_tpu_torch.stream import StreamSubscriber, as_tree
    from horovod_tpu_torch.stream import protocol as sproto

    fa, fadam, tq = kernels
    t_phase = time.perf_counter()
    card = card_line()
    hvt.init(backend="nccl")
    cfg = CacheLMConfig(**DECODE_CFG)
    model = CacheLM(cfg, block_size=DECODE_BLOCK)
    nested0 = model.init_params(0)
    # The trainer's own copies: it updates them in place, and the engine
    # serves nested0 until the first flip.
    flat = {"emb": nested0["emb"].clone(), "pos": nested0["pos"].clone()}
    for i, layer in enumerate(nested0["layers"]):
        for k, v in layer.items():
            flat[f"layers.{i}.{k}"] = v.clone()
    train_pool = KVBlockPool(1, DECODE_BLOCK, n_layers=cfg.n_layers,
                             n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                             device="cuda")
    rng = np.random.default_rng(7)
    batch = torch.from_numpy(rng.integers(
        1, cfg.vocab, (STREAM_BATCH, STREAM_SEQ + 1))).cuda()
    loss_fn = stream_loss(model, train_pool)

    def build(publish, params):
        step, opt = hvt.make_train_step(
            loss_fn, hvt.fused_adamw(STREAM_LR), sharded=True,
            fused_update=True, publish=publish)
        return step, dp.init_state(params, opt)

    server = RendezvousServer(host="127.0.0.1")
    server.start()
    step, state = build(STREAM_EVERY, flat)
    pub = step.stream_publisher
    pub.kv = server
    counting = CountingModel(model)
    eng = DecodeEngine(counting, nested0, workers=2, rows=STREAM_ROWS,
                       kv_blocks=DECODE_KV_BLOCKS, kv_block_size=DECODE_BLOCK,
                       max_seq_len=DECODE_MAX_SEQ, kv_dtype="int8",
                       device="cuda").start()
    sub = StreamSubscriber(eng, kv=server, staleness_secs=1e9)
    eng.attach_stream(sub)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(
        DECODE_PROMPT[0], DECODE_PROMPT[1] + 1))).tolist()
        for _ in range(STREAM_STREAMS)]
    # The steps captured, and the trainer's parameters at the last one.
    published, last_params = [], {}
    publish_t, apply_ms, staleness, publish_ms = {}, [], [], []
    orig_maybe = pub.maybe_publish

    def timed_maybe(params, s):
        t0 = time.perf_counter()
        v = orig_maybe(params, s)
        if s % STREAM_EVERY == 0:
            publish_ms.append((time.perf_counter() - t0) * 1e3)
            published.append(s)
            last_params.clear()
            last_params.update({k: p.detach().clone()
                                for k, p in params.items()})
        if v is not None:
            publish_t[v] = time.perf_counter()
        return v

    pub.maybe_publish = timed_maybe
    stop_poll = threading.Event()

    def poll_loop():
        while not stop_poll.is_set():
            t0 = time.perf_counter()
            v = sub.poll_once()
            if v is not None:
                t1 = time.perf_counter()
                apply_ms.append((t1 - t0) * 1e3)
                staleness.append((t1 - publish_t.get(v, t1)) * 1e3)
            stop_poll.wait(0.01)

    poller = threading.Thread(target=poll_loop, name="stream-poll")
    chaos._reset_for_tests()
    chaos.plan(STREAM_CHAOS, seed=0)
    reset_counts(fa, fadam, tq)
    counting.calls = 0
    poller.start()
    losses, during = [], []
    try:
        futs = [eng.submit(p, DECODE_NEW) for p in prompts[:STREAM_ROWS * 2]]
        for i in range(STREAM_STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        torch.cuda.synchronize()
        for f in futs:
            during.append(list(f.result(timeout=600.0)))
        last = published[-1]
        deadline = time.time() + 60.0
        while eng.stream_version != last and time.time() < deadline:
            time.sleep(0.01)
        n_steps = STREAM_STEPS
        train_counts = {"fused_adamw": fadam.launches}
        n_extend, q_counts = counting.calls, {
            "quantize_blockwise": tq.launches_quant,
            "dequantize_blockwise": tq.launches_dequant}
        # Streams decoded wholly after the last flip.
        after = [list(f.result(timeout=600.0)) for f in
                 [eng.submit(p, DECODE_NEW) for p in prompts]]
        # A dead trainer's late write: a lower epoch than any seen.
        server.put("stream", sproto.HEAD_KEY, sproto.frame_manifest(
            version=last + 7, epoch=-1, step=last + 7, layout={},
            buckets=[]))
        deadline = time.time() + 10.0
        while sub.n_epoch_rejected < 1 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        stop_poll.set()
        poller.join(timeout=10.0)
        chaos.clear()
        chaos._reset_for_tests()
    with eng._cond:
        version_log = list(eng.stream_version_log)
        worker_logs = {n: list(w.version_log)
                       for n, w in eng._workers.items()}
        served = eng.params
    eng.stop()
    n_buckets_z = n_buckets(state)
    log(f"[stream] CacheLM {DECODE_CFG} as a flat dict of "
        f"{len(flat)} leaves, ZeRO-1 fused_adamw({STREAM_LR}) over "
        f"{n_buckets_z} buckets, {STREAM_BATCH} x {STREAM_SEQ} tokens, "
        f"publish={STREAM_EVERY}, chaos {STREAM_CHAOS}; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    log(f"[stream] published {published}, engine version log "
        f"{version_log}, worker logs {worker_logs}; torn rejected "
        f"{sub.n_torn}, stale epoch rejected {sub.n_epoch_rejected}; "
        f"applied {sub.applied_log}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[stream] non-finite loss: {losses}")
    torn = [v for v in version_log
            if v not in {int(a) for a, _ in sub.applied_log}]
    if torn or STREAM_TORN_STEP in version_log:
        raise AssertionError(f"[stream] a torn version was served: "
                             f"{version_log}")
    for name, wl in worker_logs.items():
        it = iter(version_log)
        if not all(v in it for v in wl):
            raise AssertionError(f"[stream] worker {name}'s versions {wl} "
                                 f"are not a subsequence of {version_log}")
    if sub.n_torn != 1 or sub.n_epoch_rejected != 1:
        raise AssertionError(f"[stream] torn {sub.n_torn}, stale epoch "
                             f"{sub.n_epoch_rejected}: each once wanted")
    if version_log[-1] != last:
        raise AssertionError(f"[stream] last flip {version_log[-1]}, last "
                             f"publish {last}")
    want_tree = as_tree(last_params)
    got_leaves = batching.tree_flatten(served)[0]
    want_leaves = batching.tree_flatten(want_tree)[0]
    if not all(torch.equal(a, b) for a, b in zip(got_leaves, want_leaves)):
        raise AssertionError("[stream] the engine's parameters are not the "
                             "trainer's last published ones")
    check_counts("stream", train_counts, {"fused_adamw": n_buckets_z},
                 n_steps)
    if not (q_counts["quantize_blockwise"] == q_counts[
            "dequantize_blockwise"] == 2 * n_extend) or n_extend == 0:
        raise AssertionError(f"[stream] {q_counts} over {n_extend} extend "
                             "calls, not 2 + 2 each")
    # The streams decoded after the last flip, against a fresh engine on
    # the last published parameters.
    fresh = DecodeEngine(model, want_tree, workers=2, rows=STREAM_ROWS,
                         kv_blocks=DECODE_KV_BLOCKS,
                         kv_block_size=DECODE_BLOCK,
                         max_seq_len=DECODE_MAX_SEQ, kv_dtype="int8",
                         device="cuda").start()
    try:
        ref = [list(f.result(timeout=600.0)) for f in
               [fresh.submit(p, DECODE_NEW) for p in prompts]]
    finally:
        fresh.stop()
    with torch.inference_mode():
        near = first_divergence("stream", model, want_tree, prompts, ref,
                                after)
    # The int8 subscriber: only the changed buckets re-quantize (kernel 4
    # at block = K), bit for bit the plain version.
    q_rec = stream_int8_subscriber(hvt, tq, server, nested0, state, step,
                                   batch)
    # The step with publish against without, alternated.
    step0, state0 = build(0, {k: v.detach().clone()
                              for k, v in state.params.items()})
    t_pub, t_off = [], []
    for _ in range(STREAM_TIMED):
        for stp, times, which in ((step, t_pub, 0), (step0, t_off, 1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == 0:
                state, _ = stp(state, batch)
            else:
                state0, _ = stp(state0, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    server.stop()
    hvt.shutdown()
    rec = {"config": {"model": DECODE_CFG, "batch": STREAM_BATCH,
                      "seq": STREAM_SEQ, "publish": STREAM_EVERY,
                      "steps": STREAM_STEPS, "chaos": STREAM_CHAOS,
                      "rows": STREAM_ROWS, "streams": STREAM_STREAMS},
           "published": published, "version_log": version_log,
           "worker_logs": worker_logs, "torn_rejected": sub.n_torn,
           "epoch_rejected": sub.n_epoch_rejected,
           "launches": {**train_counts, **q_counts, "extend_calls": n_extend},
           "near_ties": near, "int8_subscriber": q_rec,
           "publish_ms": publish_ms, "apply_ms": apply_ms,
           "staleness_ms": staleness,
           "step_ms_publish": float(np.median(t_pub)),
           "step_ms_no_publish": float(np.median(t_off)),
           "step_ms_publish_all": t_pub, "step_ms_no_publish_all": t_off,
           "losses": losses, "card": card}
    log(f"[stream] on {card}: publish (capture: pack + host copy; CRC, "
        f"frame, KV put) median {np.median(publish_ms):.2f} ms over "
        f"{len(publish_ms)}; apply (stage, CRC-verify, unpack, flip) median "
        f"{np.median(apply_ms):.2f} ms over {len(apply_ms)}; staleness "
        f"(publish returned -> flip) median {np.median(staleness):.2f} ms; "
        f"step with publish={STREAM_EVERY} {rec['step_ms_publish']:.2f} ms "
        f"vs publish=0 {rec['step_ms_no_publish']:.2f} ms (medians of "
        f"{STREAM_TIMED}, alternated); launches {rec['launches']}; the "
        f"{STREAM_STREAMS} streams after the last flip equal a fresh "
        f"engine's (near-ties {near})")
    del step, state, step0, state0, served, last_params, want_tree
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def stream_int8_subscriber(hvt, tq, server, nested0, state, step, batch):
    """A second subscriber, weight_dtype="int8" with an apply= callback, on
    the server's stream: the next two versions re-quantize only the
    buckets whose bytes changed (kernel 4), bit for bit quantize_params of
    the same leaves on the CPU (the plain version)."""
    from horovod_tpu_torch.ops import batching
    from horovod_tpu_torch.stream import StreamSubscriber, as_tree

    applied = []
    sub = StreamSubscriber(None, template_params=nested0, kv=server,
                           staleness_secs=1e9, weight_dtype="int8",
                           apply=lambda tree, v: applied.append((v, tree)))
    quant_calls = []
    real = tq.quantize_params

    def spy(tree, *a, **k):
        quant_calls.append(1)
        return real(tree, *a, **k)

    tq.quantize_params = spy
    rec = {"versions": [], "requantized": [], "launches": []}
    pub = step.stream_publisher
    # The server's head is the stale manifest by now: two fresh versions,
    # the second with only the position embeddings moved (only the
    # buckets that hold them change).
    v = int(state.step) + 1
    v += (-v) % pub.publish_every
    try:
        for k, bump in enumerate((0.0, 1e-3)):
            with torch.no_grad():
                state.params["pos"].add_(bump)
            n_before = len(quant_calls)
            tq.reset_launches()
            pub.maybe_publish(state.params, v + k * pub.publish_every)
            got_v = sub.poll_once()
            if got_v != v + k * pub.publish_every:
                raise AssertionError(f"[stream] the int8 subscriber applied "
                                     f"{got_v}")
            rec["versions"].append(got_v)
            rec["requantized"].append(len(quant_calls) - n_before)
            rec["launches"].append(tq.launches_quant)
    finally:
        tq.quantize_params = real
    tree = applied[-1][1]
    leaves = batching.tree_flatten(tree)[0]
    cpu = batching.tree_flatten(batching.tree_map(
        lambda t: t.detach().cpu(), as_tree(state.params)))[0]
    bitwise = True
    n_q = 0
    for got, leaf in zip(leaves, cpu):
        want = real(leaf)
        if hasattr(got, "q"):
            n_q += 1
            bitwise &= torch.equal(got.q.cpu(), want.q) and torch.equal(
                got.scales.cpu(), want.scales)
        else:
            bitwise &= torch.equal(got.cpu(), want)
    _, spec = batching.pack_spec(nested0)
    rec.update({"bitwise_plain": bitwise, "quantized_leaves": n_q,
                "buckets": len(spec.buckets)})
    log(f"[stream] int8 subscriber: versions {rec['versions']}, leaves "
        f"re-quantized {rec['requantized']} (of {len(leaves)}; {n_q} int8), "
        f"kernel-4 launches {rec['launches']}; bit for bit "
        f"the plain version: {bitwise}")
    # Kernel 4 runs once for each int8 leaf (2-D, >= 4096 elements) of a
    # re-quantized bucket: every one of them for the first version.
    if not bitwise or not 0 < rec["requantized"][1] < rec["requantized"][0] \
            or rec["launches"][0] != n_q \
            or not 0 < rec["launches"][1] <= rec["requantized"][1]:
        raise AssertionError(f"[stream] int8 subscriber: {rec}")
    return rec


def profile_step_phase(hvt):
    """[profile-step]: ``python -m horovod_tpu_torch.tools.profile_step``
    for BERT-base (32 x 512) and ResNet-50 (128 x 224 x 224), each a
    process of its own: exit 0, the category totals within 1% of the
    device time the profiler links to the operators that launched it,
    BERT's window 12/12/12 flash launches a step."""
    t_phase = time.perf_counter()
    card = card_line()
    out = {}
    from horovod_tpu_torch.ops import _build

    tmp = Path(tempfile.mkdtemp(prefix="profile-", dir=_build.BUILD_DIR))
    try:
        for model in ("bert", "resnet50"):
            path = tmp / f"{model}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "horovod_tpu_torch.tools.profile_step",
                 "--model", model, "--top", "15", "--json", str(path)],
                cwd=str(Path(__file__).resolve().parent),
                capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            for line in proc.stdout.splitlines():
                log(f"[profile-step] {model}: {line}")
            if proc.returncode != 0:
                log(proc.stderr[-4000:])
                raise AssertionError(f"[profile-step] {model} exited "
                                     f"{proc.returncode}")
            s = json.loads(path.read_text())
            # The categories sum the device event list; the linked total
            # reaches the same kernels another way, through the operators
            # that launched them.
            rel = (abs(s["category_us"] - s["linked_us"]) / s["linked_us"]
                   if s["linked_us"] else float("inf"))
            rec = {"categories": s["categories"], "device_ms":
                   s["device_us"] / 1e3, "category_ms": s["category_us"] / 1e3,
                   "window_ms": (s["window_us"] or 0) / 1e3,
                   "busy_ms": (s["busy_us"] or 0) / 1e3,
                   "idle_share": s["idle_share"], "losses": s["losses"],
                   "flash_launches": s["flash_launches"],
                   "top": s["kernels"][:15], "wall_s": wall,
                   "scopes_ms": {k: v["us"] / 1e3
                                 for k, v in s["scopes"].items()},
                   "linked_ms": s["linked_us"] / 1e3,
                   "sum_rel_diff": rel}
            out[model] = rec
            log(f"[profile-step] {model} on {card}: device {rec['device_ms']:.3f}"
                f" ms over {s['steps']} steps, categories sum "
                f"{rec['category_ms']:.3f} ms, linked to an operator "
                f"{rec['linked_ms']:.3f} ms (relative {rel:.2e}); window "
                f"{rec['window_ms']:.3f} ms, busy {rec['busy_ms']:.3f} ms, "
                f"idle share {rec['idle_share']}; scopes "
                f"{rec['scopes_ms']} ms; process {wall:.1f} s")
            if not rel <= 0.01 or s["idle_share"] is None:
                raise AssertionError(f"[profile-step] {model}: {rec}")
            if not all(np.isfinite(s["losses"])):
                raise AssertionError(f"[profile-step] {model} losses "
                                     f"{s['losses']}")
        want = {k: 12 * 5 for k in ("flash_fwd", "flash_bwd_dkdv",
                                    "flash_bwd_dq")}
        if out["bert"]["flash_launches"] != want:
            raise AssertionError(f"[profile-step] BERT's window launched "
                                 f"{out['bert']['flash_launches']}, not "
                                 "12/12/12 a step")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["card"] = card
    out["phase_s"] = time.perf_counter() - t_phase
    return out



# ---- the analysis plane: [analysis] -----------------------------------------

# A launched world of one: [train]'s step, its first call's certification
# preflight over the launcher's KV under HVDTPU_CERT=raise.
CERT_WORKER = '''
import torch.nn.functional as F

from horovod_tpu_torch.elastic import worker as ew

world()
os.environ["HVDTPU_CERT"] = "raise"
cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
model = hvt.GPT2LMModel(cfg, device=DEVICE)
model.load_state_dict(hvt.convert.init_params(cfg, seed=0))


def loss_fn(params, tokens):
    logits = torch.func.functional_call(model, params, (tokens[:, :-1],))
    return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())


step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(LR), sharded=True,
                                fused_update=True, device=DEVICE)
state = dp.init_state(model, opt)
tokens = batch_tokens(cfg, BATCH)
channel = ew.cert_channel()
t0 = time.perf_counter()
report = step.preflight(state, tokens)  # this process's first record
t1 = time.perf_counter()
step.preflight(state, tokens)
t2 = time.perf_counter()
reset()
state, loss = step(state, tokens)
record({"preflight_s": [t1 - t0, t2 - t1],
        "channel": None if channel is None else {
            "host": channel.host_id, "round": channel.round_,
            "n_hosts": channel.n_hosts},
        "report": None if report is None else {
            k: report[k] for k in ("ok", "round", "n_hosts", "n_published",
                                   "digest", "hosts")},
        "latched": step._cert_latch["done"], "loss": float(loss),
        "launches": counts()})
'''


def all_counts(fa, fadam, tq):
    """Every kernel's launch counter."""
    return (fa.launches, fa.launches_dkdv, fa.launches_dq, fadam.launches,
            tq.launches_quant, tq.launches_dequant, tq.launches_fp8_matmul,
            tq.launches_fp8_cast, tq.launches_fp8_relayout,
            tq.launches_int8_matmul, tq.launches_int8_matmul_reduce,
            tq.launches_int8_relayout)


def analysis_record(hvt, kernels, tag, step, state, tokens):
    """One step recorded, linted and certified (the row and the cert); the
    record must launch no kernel and allocate no device memory."""
    import gc

    from horovod_tpu_torch import analysis as an

    # Earlier builds' cycles collected first, and no collection during the
    # record: the allocated bytes change only if the record allocates.
    gc.collect()
    torch.cuda.synchronize()
    before = (all_counts(*kernels), torch.cuda.memory_allocated())
    gc.disable()
    try:
        t0 = time.perf_counter()
        rec = step.trace(state, tokens)
        wall = time.perf_counter() - t0
        findings = step.lint(state, tokens, jaxpr=rec)
        cert = step.certify(state, tokens, jaxpr=rec)
        torch.cuda.synchronize()
        after = (all_counts(*kernels), torch.cuda.memory_allocated())
    finally:
        gc.enable()
    sites = [f"{s.kind} {[str(a) for a in s.in_avals]} -> "
             f"{[str(a) for a in s.out_avals]}" for s in rec.collectives]
    errs = an.errors(findings)
    hvt_ops = {k: v for k, v in rec.op_counts.items()
               if k.startswith("hvt::")}
    log(f"[analysis] {tag}: recorded in {wall:.3f} s ({rec.n_eqns} ops, "
        f"hvt ops {hvt_ops}); "
        f"collective sites {sites}; findings "
        f"{[str(f) for f in findings] or 'none'}; cert {cert.digest} "
        f"({cert.n_collectives} collectives); launches and allocated bytes "
        f"unchanged across the record: {before == after}")
    if errs:
        raise AssertionError(f"[analysis] {tag}: ERROR findings {errs}")
    if before != after:
        raise AssertionError(f"[analysis] {tag}: the record launched or "
                             f"allocated: {before} -> {after}")
    return {"record_s": wall, "n_ops": rec.n_eqns, "hvt_ops": hvt_ops,
            "sites": sites, "findings": [f.to_dict() for f in findings],
            "digest": cert.digest, "entries": list(cert.entries),
            "unchanged": before == after}, cert


def wrap_times(fa, fadam, gen, sizes):
    """Kernels 1, 2, 3 and 6 called straight (the wrapper's views, checks
    and ctypes launch, as before the ops) and through their hvt ops, in
    turns: event ms of back-to-back calls and the host us a call."""
    import math as _math

    b, s, h, d = 8, 1024, 12, 64
    q, k, v = qkv_views(gen, b, s, s, h, d)
    kw = dict(causal=True, layout="bsm", n_heads=h)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)

    # The wrappers' CUDA paths as they were before the ops: views, checks,
    # the launch.
    def fwd_direct():
        q4, k4, v4 = fa._views(q, k, v, "bsm", h)
        kv_len = fa._check(q4, k4, v4, None)
        return fa._launch(q4, k4, v4, causal=True, q_offset=0, kv_offset=0,
                          sm_scale=1.0 / _math.sqrt(q4.shape[-1]),
                          layout="bsm", kv_len=kv_len)

    def bwd_direct():
        q4, k4, v4 = fa._views(q, k, v, "bsm", h)
        kv_len = fa._check(q4, k4, v4, None)
        return fa._bwd_launch(
            q4, k4, v4, fa._view4(out, "bsm", h), fa._view4(g, "bsm", h),
            lse, None, causal=True, q_offset=0, kv_offset=0,
            sm_scale=1.0 / _math.sqrt(q4.shape[-1]), layout="bsm",
            kv_len=kv_len)

    n = max(sizes)
    p, m, vv, gr = (torch.randn(n, generator=gen, device="cuda")
                    for _ in range(4))
    vv = vv.abs()
    count = torch.full((), 3, dtype=torch.int32, device="cuda")
    spec = fadam.FusedAdamSpec(TRAIN_LR)

    def adam_direct():
        fadam._check(p, m, vv, gr, count, None)
        return fadam._launch(p, m, vv, gr, count, spec, None)

    pairs = {
        "flash_fwd": (fwd_direct,
                      lambda: fa.flash_attention_with_lse(q, k, v, **kw)),
        "flash_bwd": (bwd_direct,
                      lambda: fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                     **kw)),
        "fused_adamw": (adam_direct,
                        lambda: fadam.fused_adamw_update(p, m, vv, gr, count,
                                                         spec)),
    }
    res = {}
    for name, (direct, op) in pairs.items():
        rounds = []
        for _ in range(3):  # in turns: direct, op, op, direct
            rounds.append({
                "direct_ms": time_ms(direct), "op_ms": time_ms(op),
                "op_host_us": host_us(op), "direct_host_us": host_us(direct),
            })
        row = {key: float(np.median([r[key] for r in rounds]))
               for key in rounds[0]}
        row["host_us_added"] = row["op_host_us"] - row["direct_host_us"]
        res[name] = row
        log(f"[analysis] wrap {name}: events {row['direct_ms']:.4f} -> "
            f"{row['op_ms']:.4f} ms a call; host {row['direct_host_us']:.1f}"
            f" -> {row['op_host_us']:.1f} us a call "
            f"(+{row['host_us_added']:.1f} us) [{card_line()}]")
    return res


def analysis_phase(hvt, kernels, trained, remat, sizes):
    """[analysis]: the analysis plane on the card. Records (fake tensors:
    no launch, no allocation) of [train]'s GPT-2 small ZeRO-1 fused step,
    of the same step on the int8 wire and of the fp8-compute step, each
    linted and certified; then [train]'s step run from the same start, its
    losses [train]'s bit for bit; the memory plan against the measured
    peak at [train-remat]'s 32 x 1024 under none, dots_saveable and full;
    equal builds' digests and a threshold change's first divergence; a
    launched world of one's preflight over the KV under HVDTPU_CERT=raise;
    and kernels 1, 2, 3 and 6 timed before and after their op wrap."""
    from horovod_tpu_torch import analysis as an
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.tools.chaos_soak import run_elastic_scenario

    fa, fadam, tq = kernels
    t_phase = time.perf_counter()
    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    seq = cfg.max_len
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, seq + 1), dtype=np.int64)).cuda()

    def build(c=cfg, sd=sd0, opt=None, **kw):
        model = hvt.GPT2LMModel(c)
        model.load_state_dict(sd)
        step, wopt = hvt.make_train_step(
            train_loss(model), opt or hvt.fused_adamw(TRAIN_LR), **kw)
        return model, step, dp.init_state(model, wopt)

    rec = {}
    zero1 = dict(sharded=True, fused_update=True)
    model, step, state = build(**zero1)
    rec["train"], cert = analysis_record(hvt, kernels, "[train]'s step",
                                         step, state, tokens)
    # The step itself, from the same start: [train]'s losses bit for bit.
    reset_counts(*kernels)
    losses = []
    for _ in range(len(trained["losses"])):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    counts = read_counts(*kernels)
    same = losses == trained["losses"]
    log(f"[analysis] [train]'s step after its record: losses {losses}; "
        f"[train]'s bit for bit: {same}; launches {counts}")
    if not same:
        raise AssertionError(f"[analysis] losses {losses} != [train]'s "
                             f"{trained['losses']}")
    check_counts("analysis", counts, {
        "flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
        "flash_bwd_dq": cfg.n_layers, "fused_adamw": len(sizes)},
        len(losses))
    rec["train"]["losses_bitwise"] = same
    rec["launches"] = counts
    # Equal knobs: equal digests; another threshold: the first divergence.
    _, step2, state2 = build(**zero1)
    again = step2.certify(state2, tokens)
    _, step3, state3 = build(threshold_bytes=64 << 20, **zero1)
    other = step3.certify(state3, tokens)
    diff = an.diff_certs(cert, other)
    rec["certs"] = {"equal": again.digest == rec["train"]["digest"],
                    "other_digest": other.digest,
                    "first_divergent_index": diff["first_divergent_index"],
                    "reason": diff["reason"]}
    log(f"[analysis] two builds with equal knobs: digests equal "
        f"{rec['certs']['equal']}; threshold 64 MiB: {diff['reason']} at "
        f"index {diff['first_divergent_index']} "
        f"({diff.get('a_entry', {}).get('in')} vs "
        f"{diff.get('b_entry', {}).get('in')})")
    if not rec["certs"]["equal"] or diff["first_divergent_index"] is None:
        raise AssertionError(f"[analysis] certs {rec['certs']}")
    del model, step, state, step2, state2, step3, state3
    torch.cuda.empty_cache()
    # The int8 wire and fp8 compute.
    _, step, state = build(compression=hvt.Compression.int8, **zero1)
    rec["int8_wire"] = analysis_record(hvt, kernels, "int8 wire", step,
                                       state, tokens)[0]
    del step, state
    cfg8 = dataclasses.replace(cfg, compute_dtype="fp8")
    _, step, state = build(cfg8, hvt.convert.init_params(cfg8, seed=0),
                           hvt.adamw(FP8_LR), compute_dtype="fp8")
    rec["fp8"] = analysis_record(hvt, kernels, "fp8 compute", step, state,
                                 tokens)[0]
    del step, state
    torch.cuda.empty_cache()
    # The plan against the measured peak at [train-remat]'s shape.
    big = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (REMAT_BATCH, seq + 1), dtype=np.int64)).cuda()
    plans = {}
    for remat_mode in ("none", "dots_saveable", "full"):
        c = dataclasses.replace(cfg, remat=remat_mode)
        model = hvt.GPT2LMModel(c)
        model.load_state_dict(sd0)
        step, wopt = hvt.make_train_step(train_loss(model),
                                         hvt.fused_adamw(TRAIN_LR), **zero1)
        state = dp.init_state({n: p.detach().clone()
                               for n, p in model.named_parameters()}, wopt)
        state, _ = step(state, big)  # the trainer's own first allocations
        t0 = time.perf_counter()
        plan = step.memplan(state, big)
        plan_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        measured, source = an.measure_step_bytes(lambda: step(state, big),
                                                 device="cuda")
        gate = an.compare_to_measured(plan, measured, source)
        above = plan.peak_bytes - plan.resident_bytes
        plans[remat_mode] = dict(gate, plan_s=plan_s,
                                 planned_above_resident=above,
                                 remat_phase_peak_gib=remat["runs"][
                                     "none" if remat_mode == "none"
                                     else f"block/{remat_mode}"]["peak_gib"])
        log(f"[analysis] memplan {remat_mode} at {REMAT_BATCH} x {seq}: "
            f"planned peak {plan.peak_bytes / 2**30:.3f} GiB "
            f"{ {k: round(v / 2**30, 3) for k, v in plan.breakdown.items()} } "
            f"(above the resident state {above / 2**30:.3f} GiB; planned in "
            f"{plan_s:.2f} s); measured {measured / 2**30:.3f} GiB "
            f"(max_memory_allocated over the step less allocated before); "
            f"ratio {gate['ratio']}; ok {gate['ok']} (tolerance "
            f"{gate['tolerance']}); [train-remat]'s peak "
            f"{plans[remat_mode]['remat_phase_peak_gib']:.3f} GiB "
            f"[{card_line()}]")
        if not gate["ok"]:
            raise AssertionError(f"[analysis] memplan {remat_mode}: {gate}")
        del model, step, state
        torch.cuda.empty_cache()
    rec["memplan"] = plans
    peaks = {k: remat["runs"][k]["peak_gib"] for k in (
        "none", "block/dots_saveable", "block/full")}
    if not (peaks["block/dots_saveable"] < peaks["none"]
            and peaks["block/full"] < peaks["block/dots_saveable"]):
        raise AssertionError(f"[analysis] [train-remat]'s peaks {peaks}")
    hvt.shutdown()
    del big, tokens
    torch.cuda.empty_cache()
    # A launched world of one: the preflight over the KV, raising.
    workdir = phase_dir("cert-")
    try:
        src = worker_source(CERT_WORKER, BATCH=TRAIN_BATCH, LR=TRAIN_LR)
        t0 = time.perf_counter()
        rc, recs = run_elastic_scenario(
            str(workdir), src, initial_hosts=["localhost:1"],
            timeout=WORKER_TIMEOUT_S, drain_timeout=60.0, fast=False)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    got = [r for r in recs if "report" in r]
    pre = {"rc": rc, "wall_s": wall, "records": got}
    log(f"[analysis] launched world of one (localhost:1), HVDTPU_CERT=raise:"
        f" rc {rc} in {wall:.1f} s; preflight s (the process's first "
        f"record, then again) {[r.get('preflight_s') for r in got]}; {got}")
    if not (rc == 0 and len(got) == 1 and got[0]["report"]
            and got[0]["report"]["ok"] and got[0]["latched"]
            and got[0]["report"]["digest"] == rec["train"]["digest"]):
        raise AssertionError(f"[analysis] preflight {pre}")
    rec["preflight"] = pre
    rec["wrap"] = wrap_times(fa, fadam, torch.Generator(
        device="cuda").manual_seed(19), sizes)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[analysis] phase wall {rec['phase_s']:.1f} s")
    return rec


# ---- the runtime and the frontend: [eager], [hvd-torch] --------------------

SYNC_BN_SHAPE = (8, 64, 56, 56)
SYNC_BN_TOL = 1e-4  # of the largest value: fp64 sums vs cuDNN's fp32 ones
HVD_STEPS, HVD_TIMED, HVD_WARMUP = 10, 10, 3
ROUND_TRIPS = 200


def host_reference(native, x, op, pre, post):
    """What a one-rank world's allreduce returns, computed on the host with
    the runtime's own scaling (a reduction of one tensor is the tensor;
    Average divides by one, an integer one by floor division)."""
    from horovod_tpu_torch.native import runtime as rt

    y = x.clone()
    rt.scale_buffer(y, pre)
    if op == native.ADASUM:
        folded = rt.adasum_fold([y.double()], [0])
        y.copy_(folded.float() if y.dtype in (torch.float16, torch.bfloat16)
                else folded)
    if op == native.AVERAGE and not y.dtype.is_floating_point:
        y = torch.div(y, 1, rounding_mode="floor")
    rt.scale_buffer(y, post)
    return y


def eager_phase(hvt):
    """[eager]: the runtime's handles and blocking collectives on CUDA
    tensors through its NCCL group, held bit for bit against the host;
    SyncBatchNorm against nn.BatchNorm2d; the round trip of one handle."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import native
    from horovod_tpu_torch.ops import eager as E

    t_phase = time.perf_counter()
    hvd.init()
    rt = native.get_runtime()
    if rt.nccl is None or rt.device.type != "cuda":
        raise AssertionError("[eager] the runtime has no NCCL group")
    rng = np.random.default_rng(11)
    ops = {"Sum": native.SUM, "Average": native.AVERAGE, "Min": native.MIN,
           "Max": native.MAX, "Product": native.PRODUCT,
           "Adasum": native.ADASUM}
    checked, names = 0, 0
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
               torch.int64):
        if dt.is_floating_point:
            host = torch.from_numpy(rng.standard_normal(1000).astype(
                np.float32)).to(dt)
        else:
            host = torch.from_numpy(rng.integers(0, 9, 1000)).to(dt)
        for name, op in ops.items():
            if op == native.ADASUM and not dt.is_floating_point:
                continue
            x = host.cuda()
            hs = [native.allreduce_async(f"e.{dt}.{name}.{i}", x, op=op,
                                         prescale=2.0, postscale=0.5)
                  for i in range(2)]
            want = host_reference(native, host, op, 2.0, 0.5)
            for h in hs:
                got = native.synchronize(h).cpu()
                if got.dtype != dt or not torch.equal(got, want):
                    raise AssertionError(f"[eager] allreduce {name} {dt}: "
                                         f"{got[:4]} != {want[:4]}")
                checked += 1
            names += 1
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(4, 3)
    outs = hvd.grouped_allreduce([x, x[:2] * 3], name="grp", op=hvd.Sum)
    if not (torch.equal(outs[0], x) and torch.equal(outs[1], x[:2] * 3)):
        raise AssertionError("[eager] grouped allreduce")
    g = hvd.allgather(x, name="ag")
    b = torch.full((5,), 7.0, device="cuda")
    ptr = b.data_ptr()
    hvd.broadcast_(b, 0, name="bc_")
    a2a, splits = hvd.alltoall(torch.arange(6.0, device="cuda"),
                               torch.tensor([6]), name="a2a")
    rs = hvd.reducescatter(x, name="rs", op=hvd.Sum)
    hvd.barrier()
    last = hvd.join()
    if not (torch.equal(g, x) and b.data_ptr() == ptr
            and torch.equal(b, torch.full((5,), 7.0, device="cuda"))
            and torch.equal(a2a, torch.arange(6.0, device="cuda"))
            and splits.tolist() == [6] and torch.equal(rs, x)
            and last == 0 and g.is_cuda and rs.is_cuda):
        raise AssertionError("[eager] allgather / broadcast / alltoall / "
                             "reducescatter / join")
    e_out = [E.allreduce(x, E.Average), E.allgather(x), E.broadcast(x, 0),
             E.reducescatter(x, E.Sum)]
    E.barrier()
    if not all(o.is_cuda and torch.equal(o, x) for o in e_out):
        raise AssertionError("[eager] ops/eager on CUDA tensors")
    log(f"[eager] {checked} allreduce results bit for bit against the host "
        f"({names} op x dtype pairs, 2 handles each); grouped, allgather, "
        f"in-place broadcast, alltoall {splits.tolist()}, reducescatter, "
        f"barrier, join() = {last}, ops/eager on CUDA tensors: ok")

    # SyncBatchNorm on the runtime's allgather against nn.BatchNorm2d.
    gen = torch.Generator(device="cuda").manual_seed(5)
    inp = torch.randn(SYNC_BN_SHAPE, generator=gen, device="cuda")
    cot = torch.randn(SYNC_BN_SHAPE, generator=gen, device="cuda")
    errs = {}
    sbn = hvd.SyncBatchNorm(SYNC_BN_SHAPE[1]).cuda().train()
    bn = torch.nn.BatchNorm2d(SYNC_BN_SHAPE[1]).cuda().train()
    bn.load_state_dict(sbn.state_dict())
    outs = []
    for mod in (sbn, bn):
        xin = inp.clone().requires_grad_(True)
        y = mod(xin)
        (y * cot).sum().backward()
        outs.append((y.detach(), xin.grad, mod.weight.grad, mod.bias.grad,
                     mod.running_mean, mod.running_var))
    for key, a, b in zip(("out", "dx", "dw", "db", "mean", "var"), *outs):
        errs[key] = float((a - b).abs().max() / b.abs().max())
    log(f"[eager] SyncBatchNorm {list(SYNC_BN_SHAPE)} vs nn.BatchNorm2d, max "
        f"|d| / max |ref|: {json.dumps(errs)} (tol {SYNC_BN_TOL})")
    if not all(e <= SYNC_BN_TOL for e in errs.values()):
        raise AssertionError("[eager] SyncBatchNorm disagrees with BatchNorm2d")

    # The round trip of one handle on a 4-byte tensor.
    t = torch.ones(1, device="cuda")
    for _ in range(20):
        hvd.synchronize(hvd.allreduce_async_(t, name="rt", op=hvd.Sum))
    torch.cuda.synchronize()
    c0 = native.metrics_counters()
    us = []
    for _ in range(ROUND_TRIPS):
        t0 = time.perf_counter()
        hvd.synchronize(hvd.allreduce_async_(t, name="rt", op=hvd.Sum))
        us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    cycles = native.metrics_counters()["cycles"] - c0["cycles"]
    knobs = rt.knobs
    hvd.shutdown()
    rec = {"allreduce_checked": checked, "round_trip_us": float(
        np.median(us)), "round_trip_us_min": min(us),
        "round_trip_us_max": max(us), "cycles": cycles,
        "cycles_per_round_trip": cycles / ROUND_TRIPS,
        "cycle_time_us": knobs.cycle_time_us,
        "sync_bn_rel_err": errs, "seconds": time.perf_counter() - t_phase}
    log(f"[eager] allreduce_async_ + synchronize, 4 bytes: median "
        f"{rec['round_trip_us']:.1f} us (min {min(us):.1f}, max "
        f"{max(us):.1f}) over {ROUND_TRIPS}; {cycles} runtime cycles "
        f"({cycles / ROUND_TRIPS:.2f} a round trip, idle cycle "
        f"{knobs.cycle_time_us} us); phase {rec['seconds']:.1f} s")
    return rec


def hvd_losses(model, opt, tokens, steps, before_step=None):
    import torch.nn.functional as F

    losses = []
    for i in range(steps):
        if before_step is not None:
            before_step(i)
        opt.zero_grad()
        logits = model(tokens[:, :-1])
        loss = F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return [float(v) for v in losses]


def hvd_torch_phase(hvt, kernels):
    """[hvd-torch]: GPT-2 small trained by hvd.DistributedOptimizer(AdamW)
    in the reference's script shape, bit for bit the unwrapped AdamW."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import native
    from torch.profiler import ProfilerActivity, profile, schedule

    fa = kernels[0]
    t_phase = time.perf_counter()
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1), dtype=np.int64
    )).cuda()
    hvd.init()

    def build(wrap):
        model = hvt.GPT2LMModel(cfg)
        model.load_state_dict(sd0)
        opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR)
        if wrap:
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=model.named_parameters())
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            hvd.broadcast_optimizer_state(opt, root_rank=0)
        return model, opt

    plain, plain_opt = build(False)
    n_params = len(list(plain.parameters()))
    want = hvd_losses(plain, plain_opt, tokens, HVD_STEPS)
    wrapped, wrapped_opt = build(True)
    counters = []
    torch.cuda.synchronize()
    reset_counts(*kernels)
    got = hvd_losses(wrapped, wrapped_opt, tokens, HVD_STEPS,
                     lambda i: counters.append(native.metrics_counters()))
    torch.cuda.synchronize()
    launches = {"flash_fwd": fa.launches, "flash_bwd_dkdv": fa.launches_dkdv,
                "flash_bwd_dq": fa.launches_dq}
    counters.append(native.metrics_counters())
    same_params = all(torch.equal(a, b) for a, b in zip(
        plain.parameters(), wrapped.parameters()))
    log(f"[hvd-torch] losses wrapped {got}")
    log(f"[hvd-torch] losses plain   {want}")
    d = {k: [counters[i + 1][k] - counters[i][k] for i in range(HVD_STEPS)]
         for k in ("cache_hits", "cache_misses", "fused_batches",
                   "fused_tensors", "cycles")}
    later_hits = sum(d["cache_hits"][1:])
    log(f"[hvd-torch] {n_params} parameter tensors; per step: cache misses "
        f"{d['cache_misses']}, hits {d['cache_hits']} ({later_hits} in "
        f"steps 2-{HVD_STEPS}), fused batches {d['fused_batches']}, fused "
        f"tensors {d['fused_tensors']}, cycles {d['cycles']}; launches "
        f"{launches}; final parameters bit for bit: {same_params}")
    if got != want or not same_params:
        raise AssertionError("[hvd-torch] the wrapped AdamW is not the "
                             "unwrapped one bit for bit")
    if (n_params != 148 or d["cache_misses"][0] != n_params
            or any(d["cache_misses"][1:])
            or later_hits != n_params * (HVD_STEPS - 1)):
        raise AssertionError("[hvd-torch] the cache did not serve steps 2-"
                             f"{HVD_STEPS}: {d}")
    check_counts("hvd-torch", launches,
                 {k: cfg.n_layers for k in launches}, HVD_STEPS)

    # The wrapped and unwrapped steps in turns.
    times = {"plain": [], "wrapped": []}
    runs = {"plain": (plain, plain_opt), "wrapped": (wrapped, wrapped_opt)}
    for i in range(HVD_WARMUP + HVD_TIMED):
        for key in (("plain", "wrapped") if i % 2 == 0
                    else ("wrapped", "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hvd_losses(*runs[key], tokens, 1)
            torch.cuda.synchronize()
            if i >= HVD_WARMUP:
                times[key].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[hvd-torch] step ms, median of {HVD_TIMED} in turns after "
        f"{HVD_WARMUP} warm-up: plain {med['plain']:.3f}, wrapped "
        f"{med['wrapped']:.3f} (+{med['wrapped'] - med['plain']:.3f} ms, "
        f"{med['wrapped'] / med['plain'] - 1:+.2%}); all "
        f"{json.dumps({k: [round(t, 3) for t in v] for k, v in times.items()})}")

    # One wrapped step profiled; the tracer comes up in a warm-up step.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        hvd_losses(wrapped, wrapped_opt, tokens, 1)
        torch.cuda.synchronize()
        prof.step()
        c0 = native.metrics_counters()
        t0 = time.perf_counter()
        hvd_losses(wrapped, wrapped_opt, tokens, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        c1 = native.metrics_counters()
        prof.step()
    profiled = device_breakdown(prof, wall_ms, {
        "steps": 1, "fused_batches": c1["fused_batches"]
        - c0["fused_batches"]})
    hvd.shutdown()
    del plain, plain_opt, wrapped, wrapped_opt
    torch.cuda.empty_cache()
    rec = {"launches": launches, "losses": got, "n_params": n_params,
           "per_step": d, "cache_hits_steps_2_on": later_hits,
           "step_ms": med, "step_ms_all": times,
           "overhead_ms": med["wrapped"] - med["plain"],
           "profile": profiled, "seconds": time.perf_counter() - t_phase}
    log(f"[hvd-torch] wrapped step's window: idle share "
        f"{profiled['idle_share']:.3f} ({profiled['device_ms']:.2f} device "
        f"ms in {wall_ms:.2f} wall); phase {rec['seconds']:.1f} s")
    return rec


HVD_TUNE_CAP = 60  # wrapped steps the tuner may take to converge


def hvd_tune_phase(hvt, kernels):
    """[hvd-torch-tune]: GPT-2 small under hvd.DistributedOptimizer(AdamW)
    on a runtime started with HVT_AUTOTUNE=1: its ParameterManager tunes
    the fusion threshold and cycle time; then the wrapped step at the
    tuned knobs and at the defaults, in turns. An unwrapped AdamW mirror
    takes every step beside it: losses and parameters bit for bit."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import native
    from torch.profiler import ProfilerActivity, profile, schedule

    t_phase = time.perf_counter()
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1), dtype=np.int64
    )).cuda()
    log_path = Path(tempfile.mkdtemp(prefix="hvd_tune_")) / "autotune.log"
    armed = {"HVT_AUTOTUNE": "1", "HVT_AUTOTUNE_LOG": str(log_path)}
    os.environ.update(armed)
    try:
        hvd.init()
    finally:
        for k in armed:
            os.environ.pop(k)
    rt = native.get_runtime()
    default = (rt.knobs.fusion_threshold, rt.knobs.cycle_time_us)
    plain = hvt.GPT2LMModel(cfg)
    plain.load_state_dict(sd0)
    plain_opt = torch.optim.AdamW(plain.parameters(), lr=TRAIN_LR)
    wrapped = hvt.GPT2LMModel(cfg)
    wrapped.load_state_dict(sd0)
    wrapped_opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(wrapped.parameters(), lr=TRAIN_LR),
        named_parameters=wrapped.named_parameters())
    hvd.broadcast_parameters(wrapped.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(wrapped_opt, root_rank=0)
    losses = {"plain": [], "wrapped": []}
    launches = dict.fromkeys(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                              "fused_adamw"), 0)

    def wrapped_step():
        """One wrapped step, its launches counted; its ms."""
        torch.cuda.synchronize()
        c0 = read_counts(*kernels)
        t0 = time.perf_counter()
        losses["wrapped"] += hvd_losses(wrapped, wrapped_opt, tokens, 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c1 = read_counts(*kernels)
        for k in launches:
            launches[k] += c1[k] - c0[k]
        return ms

    def plain_steps(n):
        t0 = time.perf_counter()
        losses["plain"] += hvd_losses(plain, plain_opt, tokens, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    # The tuner's windows see the wrapped steps back to back, as in a
    # training loop; the mirror takes the same steps after.
    tune_steps = 0
    t0 = time.perf_counter()
    while tune_steps < HVD_TUNE_CAP and not native.autotune_best()[2]:
        wrapped_step()
        tune_steps += 1
    tune_s = time.perf_counter() - t0
    plain_steps(tune_steps)
    fusion, cycle_us, done = native.autotune_best()
    rt.autotune.active = False  # capped: the knobs stay where they are set
    samples = [list(s) for s in rt.autotune.samples]
    rows = log_path.read_text().splitlines()
    log(f"[hvd-torch-tune] {'converged' if done else 'capped'} after "
        f"{tune_steps} wrapped steps ({tune_s:.1f} s), {len(samples)} "
        f"scored windows ({len(rows)} log rows); tuned fusion {fusion} B, "
        f"cycle {cycle_us} us; default fusion {default[0]} B, cycle "
        f"{default[1]} us")
    log(f"[hvd-torch-tune] samples (fusion B, cycle us, score B/s): "
        f"{json.dumps(samples)}")
    if not samples or len(rows) != len(samples):
        raise AssertionError("[hvd-torch-tune] the tuner scored no window "
                             f"or its log disagrees: {samples} / {rows}")
    applied = [list(a) for a in rt.applied_knobs]

    # The wrapped step at each setting, in turns; the controller's knobs
    # ride the next negotiation, as the manager's own do.
    settings = {"default": default, "tuned": (fusion, cycle_us)}
    times = {k: [] for k in settings}
    plain_ms = []
    batches = {k: [] for k in settings}
    cycles = {k: [] for k in settings}
    for i in range(HVD_WARMUP + HVD_TIMED):
        for key in (("default", "tuned") if i % 2 == 0
                    else ("tuned", "default")):
            rt.controller.set_knobs(*settings[key])
            c0 = native.metrics_counters()
            ms = wrapped_step()
            c1 = native.metrics_counters()
            pms = plain_steps(1)
            if i >= HVD_WARMUP:
                times[key].append(ms)
                plain_ms.append(pms)
                batches[key].append(c1["fused_batches"]
                                    - c0["fused_batches"])
                cycles[key].append(c1["cycles"] - c0["cycles"])
    n_pairs = tune_steps + 2 * (HVD_WARMUP + HVD_TIMED)
    same = (losses["wrapped"] == losses["plain"] and all(
        torch.equal(a, b) for a, b in zip(plain.parameters(),
                                          wrapped.parameters())))
    log(f"[hvd-torch-tune] {n_pairs} wrapped steps beside the unwrapped "
        f"AdamW: losses and final parameters bit for bit: {same}; "
        f"launches {launches}")
    if not same:
        raise AssertionError("[hvd-torch-tune] the wrapped AdamW is not the "
                             "unwrapped one bit for bit")
    check_counts("hvd-torch-tune", launches,
                 {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                  "flash_bwd_dq": cfg.n_layers, "fused_adamw": 0}, n_pairs)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[hvd-torch-tune] wrapped step ms, median of {HVD_TIMED} in turns "
        f"after {HVD_WARMUP} warm-up: default {med['default']:.3f}, tuned "
        f"{med['tuned']:.3f} ({med['tuned'] - med['default']:+.3f} ms); the "
        f"unwrapped mirror {float(np.median(plain_ms)):.3f}; fused batches "
        f"a step default {batches['default']}, tuned {batches['tuned']}; "
        f"cycles a step default {cycles['default']}, tuned "
        f"{cycles['tuned']}; all {json.dumps(times)}")

    # One wrapped step profiled at each setting ([hvd-torch]'s breakdown);
    # the mirror takes the same steps after, outside the window.
    profiled = {}
    for key in ("default", "tuned"):
        rt.controller.set_knobs(*settings[key])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            hvd_losses(wrapped, wrapped_opt, tokens, 1)
            torch.cuda.synchronize()
            prof.step()
            c0 = native.metrics_counters()
            t0 = time.perf_counter()
            hvd_losses(wrapped, wrapped_opt, tokens, 1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            c1 = native.metrics_counters()
            prof.step()
        hvd_losses(plain, plain_opt, tokens, 2)
        profiled[key] = device_breakdown(prof, wall_ms, {
            "setting": key, "knobs": list(settings[key]),
            "fused_batches": c1["fused_batches"] - c0["fused_batches"],
            "cycles": c1["cycles"] - c0["cycles"]})
        log(f"[hvd-torch-tune] {key} window: {profiled[key]['device_ms']:.2f}"
            f" device ms in {wall_ms:.2f} wall, idle share "
            f"{profiled[key]['idle_share']:.3f}, "
            f"{profiled[key]['fused_batches']} fused batches")
    hvd.shutdown()
    del plain, plain_opt, wrapped, wrapped_opt
    torch.cuda.empty_cache()
    shutil.rmtree(log_path.parent, ignore_errors=True)
    rec = {"launches": launches, "converged": bool(done),
           "tune_steps": tune_steps, "tune_seconds": tune_s,
           "tuned": {"fusion_threshold_bytes": fusion,
                     "cycle_time_us": cycle_us},
           "default": {"fusion_threshold_bytes": default[0],
                       "cycle_time_us": default[1]},
           "samples": samples, "applied_knobs": applied, "step_ms": med,
           "step_ms_all": times, "plain_ms": float(np.median(plain_ms)),
           "fused_batches": batches, "cycles": cycles, "profile": profiled,
           "seconds": time.perf_counter() - t_phase}
    log(f"[hvd-torch-tune] phase {rec['seconds']:.1f} s")
    return rec


SPARK_EPOCHS, SPARK_STEPS = 2, 3  # [spark-estimator]: epochs, steps each


class TimedStore:
    """A store's writes timed (the checkpoint writes of [spark-estimator])."""

    def __init__(self, store):
        self.store, self.write_s = store, []

    def __getattr__(self, name):
        return getattr(self.store, name)

    def write(self, path, data):
        t0 = time.perf_counter()
        self.store.write(path, data)
        self.write_s.append(time.perf_counter() - t0)


# [hvd-elastic]: [hvd-torch]'s model, batch and frontend under hvd.elastic.run
# over TorchState, a commit a step for COMMITS commits; HorovodInternalError
# raised once after step FAULT_AT's backward, before its optimizer step.
HVD_ELASTIC_WORKER = '''
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import native
from horovod_tpu_torch.elastic import worker as ew
from horovod_tpu_torch.exceptions import HorovodInternalError

hvd.init()
for src in (fa.KERNEL_SOURCE, fa.BWD_SOURCE):
    _build.load(src)
cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
model = hvt.GPT2LMModel(cfg, device=DEVICE)
model.load_state_dict(hvt.convert.init_params(cfg, seed=0))
opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=LR),
                               named_parameters=model.named_parameters())
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
hvd.broadcast_optimizer_state(opt, root_rank=0)
tokens = batch_tokens(cfg, BATCH)


class State(hvd.elastic.TorchState):
    def restore(self):
        t0 = time.time()
        super().restore()
        torch.cuda.synchronize()
        record({"event": "restored", "restore_s": time.time() - t0})


def other_launches():
    return {"general": fa.launches_general + fa.launches_general_dq
            + fa.launches_general_dkdv,
            "sm90": fa.launches_sm90_fwd + fa.launches_sm90_dq
            + fa.launches_sm90_dkdv}


state = State(model, opt, step=0)
first = native.get_runtime()
first_groups = (first.gloo, first.nccl)  # held: compared by identity
fault = [FAULT_AT]
reset()


@hvd.elastic.run
def train(st):
    record({"event": "synced", "step": st.step,
            "counters": native.metrics_counters()})
    while st.step < COMMITS:
        t0 = time.time()
        opt.zero_grad()
        logits = model(tokens[:, :-1])
        loss = F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())
        loss.backward()
        if st.step + 1 == fault[0]:
            fault[0] = None
            torch.cuda.synchronize()
            record({"event": "fault", "step": st.step + 1,
                    "generation": native.generation(),
                    "counters": native.metrics_counters()})
            raise HorovodInternalError(
                f"injected after step {st.step + 1}'s backward")
        opt.step()
        torch.cuda.synchronize()
        st.step += 1
        rt = native.get_runtime()
        record({"step": st.step, "loss": float(loss), "t0": t0,
                "t1": time.time(), "generation": native.generation(),
                "size": hvd.size(), "counters": native.metrics_counters(),
                "new_groups": rt.gloo is not first_groups[0]
                and rt.nccl is not first_groups[1]
                and rt.nccl is not None})
        st.commit()


train(state)
torch.save({"params": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
            "opt_sha256": digests(opt.state_dict()), "step": state.step},
           FINAL)
record({"event": "done", "rejoin": ew.last_rejoin, "launches": counts(),
        "other_launches": other_launches()})
hvd.shutdown()
'''
HVD_ELASTIC_COMMITS, HVD_ELASTIC_FAULT_AT = 8, 4


def tensor_digests(tree):
    """sha256 of every tensor's bytes in the tree's walk order (the
    workers' digests())."""
    from horovod_tpu_torch.checkpoint import map_tensors

    out = []
    map_tensors(lambda t: out.append(hashlib.sha256(
        t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    ).hexdigest()) or t, tree)
    return out


def hvd_elastic_phase(hvt):
    """[hvd-elastic]: run_elastic on the discovery localhost:1 (cooldown 1
    s, every other setting the launcher's own) runs one worker that trains
    [hvd-torch]'s GPT-2 small through hvd.DistributedOptimizer(AdamW)
    under hvd.elastic.run over TorchState, a commit a step, and raises
    HorovodInternalError once after step HVD_ELASTIC_FAULT_AT's backward:
    elastic.run restores the last commit and resets, which shuts the
    runtime down and starts it again on the card (a new generation, new
    gloo and NCCL groups), and training goes on to HVD_ELASTIC_COMMITS.
    Held against an unwrapped AdamW of as many steps in this process."""
    from horovod_tpu_torch.tools.chaos_soak import run_elastic_scenario

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1), dtype=np.int64
    )).cuda()
    model = hvt.GPT2LMModel(cfg)
    model.load_state_dict(sd0)
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR)
    n_params = len(list(model.parameters()))
    want = hvd_losses(model, opt, tokens, HVD_ELASTIC_COMMITS)
    plain = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    plain_opt = tensor_digests(opt.state_dict())
    del model, opt
    torch.cuda.empty_cache()
    workdir = phase_dir("hvd-elastic-")
    try:
        src = worker_source(
            HVD_ELASTIC_WORKER, BATCH=TRAIN_BATCH, LR=TRAIN_LR,
            COMMITS=HVD_ELASTIC_COMMITS, FAULT_AT=HVD_ELASTIC_FAULT_AT,
            FINAL=str(workdir / "final.pt"))
        t0 = time.perf_counter()
        rc, recs = run_elastic_scenario(
            str(workdir), src, initial_hosts=["localhost:1"],
            driver_env={"HVDTPU_BLACKLIST_COOLDOWN": "1"},
            timeout=WORKER_TIMEOUT_S, drain_timeout=60.0, fast=False)
        wall = time.perf_counter() - t0
        final = torch.load(workdir / "final.pt")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if rc != 0:
        raise AssertionError(f"[hvd-elastic] rc {rc}: {recs}")
    steps = [r for r in recs if "loss" in r]
    fault = next(r for r in recs if r.get("event") == "fault")
    restored = next(r for r in recs if r.get("event") == "restored")
    synced = [r for r in recs if r.get("event") == "synced"]
    done = next(r for r in recs if r.get("event") == "done")
    rejoin = done["rejoin"]
    after = [r for r in steps if r["t0"] > fault["t"]]
    before = [r for r in steps if r["t0"] < fault["t"]]
    gen0 = fault["generation"]
    restarted = (
        [r["step"] for r in before] == list(range(1, HVD_ELASTIC_FAULT_AT))
        and [r["step"] for r in after] == list(range(
            HVD_ELASTIC_FAULT_AT, HVD_ELASTIC_COMMITS + 1))
        and {r["generation"] for r in before} == {gen0}
        and {r["generation"] for r in after} == {gen0 + 1}
        and rejoin.get("generation") == gen0 + 1
        and all(r["size"] == 1 for r in steps)
        and not any(r["new_groups"] for r in before)
        and all(r["new_groups"] for r in after))

    def delta(a, b, key):
        return b["counters"][key] - a["counters"][key]

    # Cache misses and hits a step, each step against the record before it
    # (the first step after each sync against that sync).
    marks = sorted(synced + steps, key=lambda r: r["t"])
    per_step = {r["step"]: {k: delta(prev, r, k)
                            for k in ("cache_misses", "cache_hits")}
                for prev, r in zip(marks, marks[1:]) if "loss" in r}
    first_after = per_step[HVD_ELASTIC_FAULT_AT]
    cache_back = (per_step[1]["cache_misses"] == n_params
                  and first_after["cache_misses"] == n_params
                  and all(per_step[s]["cache_misses"] == 0
                          and per_step[s]["cache_hits"] == n_params
                          for s in per_step
                          if s not in (1, HVD_ELASTIC_FAULT_AT)))
    got = [r["loss"] for r in steps]
    params_bitwise = all(torch.equal(final["params"][k], plain[k])
                         for k in plain)
    opt_bitwise = final["opt_sha256"] == plain_opt
    p_rel = grads_rel_l2(final["params"], plain)
    split = {"restore_s": restored["restore_s"],
             "shutdown_s": rejoin["shutdown_s"],
             "rejoin_s": rejoin["join_s"],
             "runtime_start_s": rejoin["runtime_start_s"],
             "fault_to_first_step_s": after[0]["t1"] - fault["t"]}
    ms_before = [1e3 * (r["t1"] - r["t0"]) for r in before[1:]]
    ms_after = [1e3 * (r["t1"] - r["t0"]) for r in after[1:]]
    launches = done["launches"]
    n_runs = HVD_ELASTIC_COMMITS + 1  # the failed step ran its backward
    rec = {"rc": rc, "wall_s": wall, "losses": got, "plain_losses": want,
           "params_bitwise": params_bitwise, "opt_bitwise": opt_bitwise,
           "params_rel_l2": p_rel, "restarted": restarted,
           "generations": [gen0, gen0 + 1], "time_to_recover": split,
           "step_ms_before": ms_before, "step_ms_after": ms_after,
           "cache_per_step": per_step, "launches": launches,
           "other_launches": done["other_launches"],
           "flash_steps": n_runs}
    log(f"[hvd-elastic] run_elastic, discovery localhost:1, cooldown 1 s, "
        f"the launcher's own settings: rc {rc} in {wall:.1f} s; "
        f"HorovodInternalError after step {HVD_ELASTIC_FAULT_AT}'s backward; "
        f"steps {[r['step'] for r in before]} on generation {gen0}, "
        f"{[r['step'] for r in after]} on generation "
        f"{after[0]['generation'] if after else None} (size "
        f"{sorted({r['size'] for r in steps})}, new gloo and NCCL groups "
        f"{all(r['new_groups'] for r in after)}); restarted in place "
        f"{restarted}")
    log("[hvd-elastic] fault to the first step after it (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    log(f"[hvd-elastic] step ms before the restart {[round(t, 3) for t in ms_before]}"
        f" (median {float(np.median(ms_before)):.3f}), after "
        f"{[round(t, 3) for t in ms_after]} (median "
        f"{float(np.median(ms_after)):.3f})")
    log(f"[hvd-elastic] cache misses/hits a step: " + ", ".join(
        f"{s}: {c['cache_misses']}/{c['cache_hits']}"
        for s, c in sorted(per_step.items())) + f"; misses back after the "
        f"restart {cache_back}")
    log(f"[hvd-elastic] losses {got}")
    log(f"[hvd-elastic] unwrapped AdamW {want}")
    log(f"[hvd-elastic] final parameters bit for bit {params_bitwise}, AdamW "
        f"state bit for bit {opt_bitwise} (relative L2 {p_rel:.3e}); "
        f"launches {launches} over {n_runs} forward/backward passes, general "
        f"and sm90 {done['other_launches']}")
    if not (restarted and cache_back):
        raise AssertionError(f"[hvd-elastic] the runtime did not restart in "
                             f"place as scheduled: {rec}")
    check_counts("hvd-elastic", launches, {
        "flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
        "flash_bwd_dq": cfg.n_layers, "fused_adamw": 0}, n_runs)
    if any(done["other_launches"].values()):
        raise AssertionError(f"[hvd-elastic] launches off the wgmma route: "
                             f"{done['other_launches']}")
    if not (params_bitwise and opt_bitwise and got == want):
        log("[hvd-elastic] the recovered run is not the unwrapped AdamW bit "
            "for bit: a step on the card is not bitwise repeatable across "
            f"processes here; held to [train]'s bound (relative L2 <= "
            f"{STEP_GRAD_TOL})")
        if not p_rel <= STEP_GRAD_TOL:
            raise AssertionError(f"[hvd-elastic] {rec}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[hvd-elastic] phase {rec['phase_s']:.1f} s")
    return rec


def timed_optimizer(hvt, opt, ends):
    """``opt`` with each update's end stamped after a synchronization:
    consecutive stamps inside an epoch are its steps' times."""
    def update(grads, state, params=None):
        out = opt.update(grads, state, params)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    return hvt.optimizer.Optimizer(opt.init, update)


def spark_estimator_phase(hvt, kernels):
    """[spark-estimator]: the Spark workers' training path
    (horovod_tpu_torch.spark.ParamsEstimator.fit_arrays) fits GPT-2 small at
    [train]'s 8 x 1024 (bf16 compute, fp32 parameters) for 2 epochs of 3
    steps with a one-batch validation set, checkpointing into a
    FilesystemStore; held bit for bit against a hand-written loop of the
    same port calls on the same batches, and its checkpoint reloaded bit
    for bit."""
    from horovod_tpu_torch import spark
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.spark.estimator import (
        as_batch, auto_loss, params_from_blob,
    )

    fa = kernels[0]
    t_phase = time.perf_counter()
    cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    n = TRAIN_BATCH * SPARK_STEPS
    tok = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (n + TRAIN_BATCH, cfg.max_len + 1), dtype=np.int64)
    x, y = tok[:n, :-1], tok[:n, 1:]
    vx, vy = tok[n:, :-1], tok[n:, 1:]
    # The module on meta: the estimator's parameter dict is the one copy
    # of the weights on the card.
    model = hvt.GPT2LMModel(cfg, device="meta")
    workdir = tempfile.mkdtemp(prefix="spark-", dir=_build.BUILD_DIR)
    try:
        store = TimedStore(spark.FilesystemStore(workdir))
        ends = []
        est = spark.ParamsEstimator(
            model=model, params=sd0,
            optimizer=timed_optimizer(hvt, hvt.adamw(TRAIN_LR), ends),
            loss="auto", batch_size=TRAIN_BATCH, epochs=SPARK_EPOCHS,
            store=store, run_id="gpt2")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        reset_counts(*kernels)
        t0 = time.perf_counter()
        fitted = est.fit_arrays(x, y, validation=(vx, vy))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_peak = torch.cuda.max_memory_allocated() - base_bytes
        launches = {"flash_fwd": fa.launches,
                    "flash_bwd_dkdv": fa.launches_dkdv,
                    "flash_bwd_dq": fa.launches_dq}
        steps = SPARK_EPOCHS * SPARK_STEPS
        hist = fitted.history
        losses, val = hist["step_loss"], hist["val_loss"]
        log(f"[spark-estimator] step losses {losses}; epoch means "
            f"{hist['loss']}; val {val}; launches {launches} over {steps} "
            f"steps and {SPARK_EPOCHS} validation forwards")
        if not (len(losses) == steps and np.all(np.isfinite(losses))
                and np.all(np.isfinite(val)) and losses[-1] < losses[0]):
            raise RuntimeError(f"[spark-estimator] losses {losses}")
        want = {"flash_fwd": cfg.n_layers * (steps + SPARK_EPOCHS),
                "flash_bwd_dkdv": cfg.n_layers * steps,
                "flash_bwd_dq": cfg.n_layers * steps}
        if launches != want:
            raise RuntimeError(f"[spark-estimator] flash launches {launches}, "
                               f"not {want}")

        # The same steps by hand: the estimator's batch order (its rng),
        # forward, backward and AdamW update through the same port calls.
        names = {k for k, _ in model.named_parameters()}
        if set(sd0) != names:
            raise RuntimeError("[spark-estimator] the seeded state dict is "
                               "not GPT-2's parameters")
        params = {k: sd0[k].cuda().clone().requires_grad_()
                  for k in sorted(sd0)}
        opt = hvt.adamw(TRAIN_LR)
        opt_state = opt.init(params)
        loss_fn = auto_loss(y.dtype)

        def objective(p, batch):
            return loss_fn(torch.func.functional_call(model, p, (batch[0],)),
                           batch[1])

        rng = np.random.default_rng(0)
        manual = []
        for _ in range(SPARK_EPOCHS):
            order = rng.permutation(n)
            for b in range(SPARK_STEPS):
                idx = torch.from_numpy(order[b * TRAIN_BATCH:
                                             (b + 1) * TRAIN_BATCH])
                batch = (as_batch(torch.from_numpy(x)[idx], "cuda"),
                         as_batch(torch.from_numpy(y)[idx], "cuda"))
                loss, _, grads = dp.accumulate_gradients(objective, params,
                                                         batch, 1)
                with torch.no_grad():
                    upd, opt_state = opt.update(grads, opt_state, params)
                    for k, t in params.items():
                        t.add_(upd[k])
                manual.append(float(loss))
        last = params_from_blob(store.read(store.get_epoch_checkpoint_path(
            "gpt2", SPARK_EPOCHS - 1)), "cuda")
        same_last = all(torch.equal(last[k], params[k].detach())
                        for k in params)
        log(f"[spark-estimator] hand-written loop losses {manual}; its "
            f"parameters the last epoch's checkpoint bit for bit: {same_last}")
        if manual != losses or not same_last:
            raise RuntimeError("[spark-estimator] the estimator's steps are "
                               "not the hand-written loop's bit for bit")
        del params, opt_state, last

        paths = [store.get_epoch_checkpoint_path("gpt2", e)
                 for e in range(SPARK_EPOCHS)] + [
                     store.get_checkpoint_path("gpt2")]
        missing = [p for p in paths if not store.exists(p)]
        if missing:
            raise RuntimeError(f"[spark-estimator] missing checkpoints "
                               f"{missing}")
        best = int(np.argmin(val))
        best_params = params_from_blob(store.read(paths[best]), "cuda")
        loaded = spark.ParamsModel.load(store.store, "gpt2", model=model)
        same_best = all(
            torch.equal(loaded.params[k], best_params[k])
            and torch.equal(loaded.params[k], fitted.params[k].detach())
            for k in best_params)
        got, ref = (m.transform_arrays(vx[:1]) for m in (loaded, fitted))
        same_logits = bool(np.array_equal(got, ref))
        log(f"[spark-estimator] best epoch {best}; reloaded parameters bit "
            f"for bit the best epoch's and the returned model's: {same_best};"
            f" transform_arrays logits {got.shape} equal: {same_logits}, "
            f"finite: {bool(np.isfinite(got).all())}")
        if not (same_best and same_logits and np.isfinite(got).all()
                and got.shape == (1, cfg.max_len, cfg.vocab_size)):
            raise RuntimeError("[spark-estimator] the reloaded model is not "
                               "the best epoch's")
        ckpt_bytes = os.path.getsize(paths[-1])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del est, fitted, loaded, best_params, model
    torch.cuda.empty_cache()
    # Steps inside an epoch: consecutive update stamps (an epoch's first
    # step follows the previous epoch's validation and checkpoint).
    step_ms = [(b - a) * 1e3 for e in range(SPARK_EPOCHS)
               for a, b in zip(ends[e * SPARK_STEPS:(e + 1) * SPARK_STEPS],
                               ends[e * SPARK_STEPS + 1:
                                    (e + 1) * SPARK_STEPS])]
    rec = {"launches": launches, "losses": losses, "val_loss": val,
           "step_ms": float(np.median(step_ms)), "step_ms_all": step_ms,
           "ckpt_write_s": store.write_s, "ckpt_bytes": ckpt_bytes,
           "fit_s": fit_s, "fit_peak_bytes": fit_peak,
           "seconds": time.perf_counter() - t_phase}
    log(f"[spark-estimator] step median {rec['step_ms']:.3f} ms (of "
        f"{[round(t, 3) for t in step_ms]}); checkpoint writes "
        f"{[round(t, 3) for t in store.write_s]} s of {ckpt_bytes} bytes "
        f"each; fit {fit_s:.2f} s, its peak {fit_peak} bytes allocated "
        f"over the phase's start; phase wall {rec['seconds']:.1f} s on "
        f"{card_line()}")
    return rec


# [flash-general]: the general flash kernels (csrc/flash_general.cu) at every
# head dim and dtype of the grid below, against their plain versions.
GENERAL_DIMS = {torch.bfloat16: (12, 16, 24, 32, 48, 80, 96, 160, 256),
                torch.float32: (12, 16, 24, 32, 48, 64, 80, 96, 128, 160,
                                256)}
GENERAL_EDGE_DIMS = (16, 96, 256)
# fp32 against the fp32 plain version at allow_tf32 = False: out and lse
# absolute, the gradients of the largest plain gradient (the CPU parity
# tests' fp32 tolerances: summation order only).
FP32_TOL = 2e-5
# Timed at [8, 1024, 768 // d, d] causal: each (dtype, d_pad) the sm90
# backward pair takes (fp32 64 is [train-fp32]'s, 16 [zoo-tiny]'s), and bf16
# 256 on the general pair.
GENERAL_TIMED_DIMS = {torch.float32: (64, 16, 32, 128),
                      torch.bfloat16: (16, 32, 48, 96, 256)}
ZOO_TINY_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-4}
ZOO_TINY_STEPS = 3
# [zoo-tiny]'s tiny GPT-2 at head dim 256 (2 heads of 256): in fp32 the
# backward pair's general route, which no other model of the repository
# takes.
ZOO_TINY_D256 = dict(d_model=512, n_heads=2)


def general_counts(fa):
    """The flash counters split by route: the general kernels' own, the
    sm90 kernels', and the wgmma kernels' (every launch less the
    others)."""
    return {"general_fwd": fa.launches_general,
            "general_dq": fa.launches_general_dq,
            "general_dkdv": fa.launches_general_dkdv,
            "sm90_fwd": fa.launches_sm90_fwd,
            "sm90_dq": fa.launches_sm90_dq,
            "sm90_dkdv": fa.launches_sm90_dkdv,
            "wgmma_fwd": (fa.launches - fa.launches_general
                          - fa.launches_sm90_fwd),
            "wgmma_dq": (fa.launches_dq - fa.launches_general_dq
                         - fa.launches_sm90_dq),
            "wgmma_dkdv": (fa.launches_dkdv - fa.launches_general_dkdv
                           - fa.launches_sm90_dkdv)}


def fwd_counts(fa, dt, d, n):
    """``n`` launches of the forward kernel on ``fwd_route``'s route for
    (dt, d), as :func:`general_counts` names them."""
    return {f"{fa.fwd_route(dt, d)[0]}_fwd": n}


def bwd_counts(fa, dt, d, n):
    """``n`` launches of each backward kernel on ``bwd_route``'s route for
    (dt, d), as :func:`general_counts` names them."""
    route = fa.bwd_route(dt, d)[0]
    return {f"{route}_dq": n, f"{route}_dkdv": n}


def check_general_counts(tag, fa, want):
    got = general_counts(fa)
    want = dict({k: 0 for k in got}, **want)
    if got != want:
        raise RuntimeError(f"[{tag}] flash launches {got}, not {want}")
    return got


def general_case(fa, gen, dt, *, b, sq, skv, h, d, causal, g_lse=True,
                 **kw):
    """One forward and one backward (each twice: bit for bit) of the
    kernels on fwd_route's and bwd_route's routes against their plain
    versions on fused-QKV views; returns the errors."""
    q, k, v = qkv_views(gen, b, sq, skv, h, d, dt)
    kw = dict(causal=causal, layout="bsm", n_heads=h, **kw)
    fa.reset_launches()
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    fwd_again = fa.flash_attention_with_lse(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
    gl = (torch.randn(lse.shape, generator=gen, device="cuda")
          if g_lse else None)
    args = (q, k, v, out, lse, g, gl)
    got = fa.flash_attention_bwd(*args, **kw)
    again = fa.flash_attention_bwd(*args, **kw)
    ref = fa.flash_attention_bwd_reference(*args, **kw)
    torch.cuda.synchronize()
    name = (f"{str(dt)[6:]} B={b} Sq={sq} Skv={skv} H={h} D={d} "
            f"causal={causal} {kw} g_lse={g_lse}")
    route = fa.bwd_route(dt, d)[0]
    fwd_route = fa.fwd_route(dt, d)[0]
    check_general_counts("flash-general " + name, fa, {
        **fwd_counts(fa, dt, d, 2), **bwd_counts(fa, dt, d, 2)})
    if not torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse)):
        raise RuntimeError(f"[flash-general] -inf rows differ on {name}")
    fin = ~torch.isneginf(ref_lse)
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = ((lse[fin] - ref_lse[fin]).abs().max().item()
               if fin.any() else 0.0)
    errs, rels = [], []
    for x, r in zip(got, ref):
        scale = max(r.float().abs().max().item(), 1e-6)
        errs.append((x.float() - r.float()).abs().max().item())
        rels.append(errs[-1] / scale)
    bitwise = all(torch.equal(x, y) for x, y in zip(
        [*got, out, lse], [*again, *fwd_again]))
    tol = ((FP32_TOL,) * 3 if dt == torch.float32
           else (OUT_TOL, LSE_TOL, GRAD_TOL))
    ok = (err_out <= tol[0] and err_lse <= tol[1] and max(rels) <= tol[2]
          and bitwise and out.dtype == dt)
    log(f"[flash-general] {name}: max|d out| {err_out:.3e} max|d lse| "
        f"{err_lse:.3e}; dq dk dv relative {rels[0]:.3e} {rels[1]:.3e} "
        f"{rels[2]:.3e}; rows without keys {int((~fin).sum())}; forward on "
        f"{fwd_route}, backward on {route}, bitwise again {bitwise}")
    if not ok:
        raise RuntimeError(
            f"[flash-general] the general kernels disagree with their plain "
            f"versions on {name} (tol out {tol[0]}, lse {tol[1]}, grads "
            f"{tol[2]}, bitwise repeat)")
    return {"err_out": err_out, "err_lse": err_lse, "err_grad": max(errs),
            "rel_grad": max(rels), "dtype": str(dt)[6:], "bwd_route": route,
            "fwd_route": fwd_route}


def fp64_attention_grads(q4, k4, v4, g4, g_lse, causal, sm_scale):
    """out, lse and the gradients of sum(out * g) + sum(lse * g_lse) in
    fp64, by autograd through the dense formula ([B, S, H, D] inputs)."""
    x = [t.detach().double().requires_grad_(True) for t in (q4, k4, v4)]
    s = torch.einsum("bqhd,bkhd->bhqk", x[0], x[1]) * sm_scale
    if causal:
        sq, skv = s.shape[-2:]
        keep = torch.ones(sq, skv, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                       x[2])
    ((out * g4.double()).sum() + (lse * g_lse.double()).sum()).backward()
    return out, lse, [t.grad for t in x]


def general_pair(fa, q, k, v, out, lse, g, g_lse, *, causal, layout,
                 n_heads):
    """flash_general.cu's backward pair called directly on "bsm" operands
    (the route the sm90 pair replaced where bwd_route picks it)."""
    assert layout == "bsm"
    q4, k4, v4, o4, g4 = (fa._view4(x, layout, n_heads)
                          for x in (q, k, v, out, g))
    d = q4.shape[-1]
    return fa._bwd_pair(
        "general", fa.kernel_route(q.dtype, d)[1], q4, k4, v4, o4, g4, lse,
        g_lse, causal=causal, q_offset=0, kv_offset=0,
        sm_scale=1.0 / math.sqrt(d), layout=layout, kv_len=k4.shape[1])


def general_fwd(fa, q, k, v, *, causal, layout, n_heads):
    """flash_general.cu's forward called directly on "bsm" operands (the
    route the sm90 forward replaced where fwd_route picks it)."""
    assert layout == "bsm"
    q4, k4, v4 = (fa._view4(x, layout, n_heads) for x in (q, k, v))
    d = q4.shape[-1]
    return fa._fwd_launch(
        "general", q4, k4, v4, fa.kernel_route(q.dtype, d)[1], causal=causal,
        q_offset=0, kv_offset=0, sm_scale=1.0 / math.sqrt(d), layout=layout,
        kv_len=k4.shape[1])


# The sm90 fp32 forward against fp64: out and lse absolute (3xTF32 keeps
# the products to ~2^-22 of each term; the fp32 sums and exp2 the rest).
FP64_FWD_TOL = 5e-6


def fp64_error(fa, gen, d=96):
    """Error of the fp32 kernels (the forward on fwd_route's route, the
    backward on bwd_route's), of the general forward and backward pair
    called directly, and of the fp32 plain version against an fp64
    computation, at [2, 200, 3, d] causal (Sq = Skv)."""
    b, s, h = 2, 200, 3
    q, k, v = qkv_views(gen, b, s, s, h, d, torch.float32)
    kw = dict(causal=True, layout="bsm", n_heads=h)
    g = torch.randn((b, s, h * d), generator=gen, device="cuda")
    gl = torch.randn((b, h, s), generator=gen, device="cuda")
    out64, lse64, grads64 = fp64_attention_grads(
        *(fa._view4(x, "bsm", h) for x in (q, k, v, g)), gl, True,
        1.0 / math.sqrt(d))
    rec = {"d": d, "fwd_route": fa.fwd_route(torch.float32, d)[0],
           "bwd_route": fa.bwd_route(torch.float32, d)[0]}
    for name, fwd, bwd in (
            ("kernel", fa.flash_attention_with_lse, fa.flash_attention_bwd),
            ("general", functools.partial(general_fwd, fa),
             functools.partial(general_pair, fa)),
            ("plain", fa.flash_attention_reference,
             fa.flash_attention_bwd_reference)):
        out, lse = fwd(q, k, v, **kw)
        grads = bwd(q, k, v, out, lse, g, gl, **kw)
        torch.cuda.synchronize()
        errs = {"out": (fa._view4(out, "bsm", h).double()
                        - out64).abs().max().item(),
                "lse": (lse.double() - lse64).abs().max().item()}
        for gname, x, r in zip(("dq", "dk", "dv"), grads, grads64):
            errs[gname] = ((fa._view4(x, "bsm", h).double() - r).abs().max()
                           / r.abs().max()).item()
        rec[name] = errs
    log(f"[flash-general] fp32 against fp64 at [{b}, {s}, {h}, {d}] causal "
        f"(out, lse absolute; dq dk dv of the largest fp64 gradient): "
        f"{json.dumps(rec)}")
    worst = max(max(rec[k].values()) for k in ("kernel", "general"))
    fwd = max(rec["kernel"]["out"], rec["kernel"]["lse"])
    if worst > FP32_TOL or fwd > FP64_FWD_TOL:
        raise RuntimeError("[flash-general] the fp32 kernels are not fp32-"
                           f"accurate against fp64 (forward tol "
                           f"{FP64_FWD_TOL}): {rec}")
    return rec


def sdpa_backend(fn) -> str:
    """The backend scaled_dot_product_attention took in ``fn``, from the
    names of the kernels one call launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "efficient", "cutlass"))):
        if any(m in names for m in marks):
            return backend
    return "math"


def general_times(fa, gen, dt, h, d, b=8, s=1024):
    """At [b, s, h, d] causal in ``dt``: the forward on fwd_route's route
    (twice, around flash_general.cu's forward called directly), the
    backward pair on bwd_route's route (twice, around flash_general.cu's
    pair called directly), by CUDA events, each kernel by device time;
    their plain versions; SDPA's forward and backward (a yardstick the port
    never calls) with the backend it took; bounds from the function's own
    bytes and operations (fp32: at the FFMA rate, and as 3xTF32 on the
    tensor cores)."""
    q, k, v = qkv_views(gen, b, s, s, h, d, dt)
    kw = dict(causal=True, layout="bsm", n_heads=h)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
    args = (q, k, v, out, lse, g, None)
    route, d_pad = fa.bwd_route(dt, d)
    fwd_route = fa.fwd_route(dt, d)[0]
    fwd = lambda: fa.flash_attention_with_lse(q, k, v, **kw)  # noqa: E731
    gfwd = lambda: general_fwd(fa, q, k, v, **kw)  # noqa: E731
    bwd = lambda: fa.flash_attention_bwd(*args, **kw)  # noqa: E731
    gbwd = lambda: general_pair(fa, *args, **kw)  # noqa: E731
    rec = {"shape": [b, s, h, d], "dtype": str(dt)[6:], "d_pad": d_pad,
           "fwd_route": fwd_route, "bwd_route": route,
           "fwd_ms": time_ms(fwd, samples=10),
           "general_fwd_ms": time_ms(gfwd, samples=10),
           "fwd_ms_again": time_ms(fwd, samples=10),
           "pair_ms": time_ms(bwd, samples=10),
           "general_pair_ms": time_ms(gbwd, samples=10),
           "plain_fwd_ms": time_ms(
               lambda: fa.flash_attention_reference(q, k, v, **kw),
               samples=5, per_sample=2),
           "plain_pair_ms": time_ms(
               lambda: fa.flash_attention_bwd_reference(*args, **kw),
               samples=5, per_sample=2)}
    # The pair on its route again after the general one: the two in turns.
    rec["pair_ms_again"] = time_ms(bwd, samples=10)
    rec["device_ms"] = {**kernel_ms(gfwd, 10), **kernel_ms(fwd, 10),
                        **kernel_ms(gbwd, 10), **kernel_ms(bwd, 10)}
    qh, kh, vh = (x.unflatten(-1, (h, d)).transpose(1, 2).detach()
                  .requires_grad_(True) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True)
    oh = sdpa()
    goh = g.unflatten(-1, (h, d)).transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        oh, (qh, kh, vh), goh, retain_graph=True)
    with torch.no_grad():
        rec["sdpa_fwd_ms"] = time_ms(sdpa, samples=10)
        rec["sdpa_backend"] = sdpa_backend(sdpa)
    rec["sdpa_bwd_ms"] = time_ms(sdpa_bwd, samples=10)
    es = 4 if dt == torch.float32 else 2
    work = attention_work(es, b, s, s, h, d, True)
    rec["bounds"] = {k: bound(nb, fl, dt) for k, (nb, fl) in work.items()}
    if dt == torch.float32:
        rec["bounds_tf32"] = {k: tf32_bound(nb, fl)
                              for k, (nb, fl) in work.items()}
    del oh, qh, kh, vh
    dev = rec["device_ms"]
    split = lambda pre: (f"dq {dev[pre + '_dq']:.4f} + dkdv "  # noqa: E731
                         f"{dev[pre + '_dkdv']:.4f} ms device")
    tf32 = (f", 3xTF32 {rec['bounds_tf32']['pair']['bound_ms']:.4f} ms"
            if dt == torch.float32 else "")
    routed = (f"sm90 pair {rec['pair_ms']:.4f} / {rec['pair_ms_again']:.4f}"
              f" ms by events, {split('flash_bwd_sm90')}; "
              if route == "sm90" else "")
    fwd_dev = dev.get("flash_fwd_sm90", dev["flash_general_fwd"])
    tf32_fwd = (f", 3xTF32 {rec['bounds_tf32']['fwd']['bound_ms']:.4f} ms"
                if dt == torch.float32 else "")
    log(f"[flash-general] {rec['dtype']} [{b}, {s}, {h}, {d}] causal (d_pad "
        f"{d_pad}, forward on {fwd_route}, backward on {route}): forward "
        f"{rec['fwd_ms']:.4f} / {rec['fwd_ms_again']:.4f} ms by events, "
        f"{fwd_dev:.4f} ms device; general forward "
        f"{rec['general_fwd_ms']:.4f} ms by events, "
        f"{dev['flash_general_fwd']:.4f} ms device (bound "
        f"{rec['bounds']['fwd']['bound_ms']:.4f} ms, "
        f"{rec['bounds']['fwd']['bound_by']}{tf32_fwd}); {routed}general pair "
        f"{rec['general_pair_ms']:.4f} ms by events, "
        f"{split('flash_general')} (pair bound "
        f"{rec['bounds']['pair']['bound_ms']:.4f} ms{tf32}); plain "
        f"{rec['plain_fwd_ms']:.4f} / {rec['plain_pair_ms']:.4f} ms; sdpa "
        f"({rec['sdpa_backend']}) {rec['sdpa_fwd_ms']:.4f} / "
        f"{rec['sdpa_bwd_ms']:.4f} ms; on {card_line()}")
    if route == "sm90":
        rec["sm90_faster"] = max(rec["pair_ms"], rec["pair_ms_again"]) < (
            rec["general_pair_ms"])
        log(f"[flash-general] {rec['dtype']} d_pad {d_pad}: the sm90 pair "
            f"{'beats' if rec['sm90_faster'] else 'does not beat'} the "
            f"general pair in this run")
    if fwd_route == "sm90":
        # Faster in both orders: before and after the general forward.
        rec["sm90_fwd_faster"] = max(rec["fwd_ms"], rec["fwd_ms_again"]) < (
            rec["general_fwd_ms"])
        log(f"[flash-general] {rec['dtype']} d_pad {d_pad}: the sm90 forward "
            f"{'beats' if rec['sm90_fwd_faster'] else 'does not beat'} the "
            f"general forward in this run")
    return rec


def sm90_fwd_compiler(fa, report):
    """The sm90 forward's compiler report (a future of compiler_report),
    printed: ptxas's advisories, and each kernel's HGMMA, HMMA and local
    load and store (LDL, STL) counts and its registers and spills."""
    comp = report.result()
    log(f"[flash-general] compiler ({fa.SM90_FWD_SOURCE}.cu): advisories "
        f"{comp['advisories'] or 'none'}")
    for fn, ops in comp["sass"].items():
        log(f"[flash-general]   {fn}: {json.dumps(ops)}")
    for line in comp["ptxas"]:
        log(f"[flash-general]   ptxas: {line}")
    return comp


def flash_general_phase(fa, gen, report):
    """[flash-general]: the general kernels and the sm90 forward and
    backward pair against their plain versions on the grid and the edge
    cases, fp32 against fp64, and the timed shapes; ``report`` the sm90
    forward's compiler report (a future)."""
    t0 = time.perf_counter()
    cases = []
    for dt, dims in GENERAL_DIMS.items():
        for d in dims:
            for causal in (False, True):
                cases.append(general_case(fa, gen, dt, b=2, sq=200, skv=333,
                                          h=3, d=d, causal=causal))
        for d in GENERAL_EDGE_DIMS:
            edge = dict(dt=dt, d=d)
            cases += [
                general_case(fa, gen, b=2, sq=200, skv=333, h=3,
                             causal=False, kv_len=250, **edge),
                # Query rows 0-99 see no key; rows 100 on see some.
                general_case(fa, gen, b=1, sq=150, skv=300, h=2, causal=True,
                             kv_offset=100, **edge),
                # A ring hop's future block: no query sees any key.
                general_case(fa, gen, b=1, sq=70, skv=70, h=2, causal=True,
                             kv_offset=100, **edge),
                general_case(fa, gen, b=1, sq=150, skv=300, h=2, causal=True,
                             kv_len=290, sm_scale=-1.0 / math.sqrt(d),
                             **edge),
                # q, k and v all column views of one fused QKV output, with
                # and without an lse cotangent.
                general_case(fa, gen, b=1, sq=130, skv=130, h=2, causal=True,
                             **edge),
                general_case(fa, gen, b=1, sq=130, skv=130, h=2, causal=True,
                             g_lse=False, **edge),
                general_case(fa, gen, b=2, sq=1, skv=70, h=3, causal=True,
                             q_offset=69, **edge),
                general_case(fa, gen, b=1, sq=70, skv=1, h=3, causal=False,
                             **edge),
            ]
    t_checks = time.perf_counter() - t0
    fp64 = {d: fp64_error(fa, gen, d) for d in (96, 64, 16)}
    timed = {str(dt)[6:]: {d: general_times(fa, gen, dt, 768 // d, d)
                           for d in dims}
             for dt, dims in GENERAL_TIMED_DIMS.items()}
    wall = time.perf_counter() - t0
    by_route, by_fwd_route = {}, {}
    for c in cases:
        key = f"{c['dtype']}/{c['bwd_route']}"
        by_route[key] = by_route.get(key, 0) + 1
        key = f"{c['dtype']}/{c['fwd_route']}"
        by_fwd_route[key] = by_fwd_route.get(key, 0) + 1
    sm90 = [c for c in cases if c["bwd_route"] == "sm90"]
    sm90_fwd = [c for c in cases if c["fwd_route"] == "sm90"]
    # Each timed (dtype, d_pad) on the sm90 forward: did it beat the general
    # forward in both orders?
    fwd_won = {f"{r['dtype']}/{r['d_pad']}": r["sm90_fwd_faster"]
               for by_d in timed.values() for r in by_d.values()
               if "sm90_fwd_faster" in r}
    rec = {"cases": len(cases), "cases_by_bwd_route": by_route,
           "cases_by_fwd_route": by_fwd_route,
           "max_err_out": max(c["err_out"] for c in cases),
           "max_err_lse": max(c["err_lse"] for c in cases),
           "max_err_grad": max(c["err_grad"] for c in cases),
           "max_rel_grad": max(c["rel_grad"] for c in cases),
           "sm90_max_err_grad": {dt: max(c["err_grad"] for c in sm90
                                         if c["dtype"] == dt)
                                 for dt in ("bfloat16", "float32")},
           "sm90_max_rel_grad": {dt: max(c["rel_grad"] for c in sm90
                                         if c["dtype"] == dt)
                                 for dt in ("bfloat16", "float32")},
           "sm90_fwd_max_err_out": {dt: max(c["err_out"] for c in sm90_fwd
                                            if c["dtype"] == dt)
                                    for dt in ("bfloat16", "float32")},
           "sm90_fwd_max_err_lse": {dt: max(c["err_lse"] for c in sm90_fwd
                                            if c["dtype"] == dt)
                                    for dt in ("bfloat16", "float32")},
           "sm90_fwd_faster": fwd_won,
           "fp64": fp64[96], "fp64_by_d": fp64, "timed": timed,
           "compiler_sm90_fwd": sm90_fwd_compiler(fa, report),
           "checks_s": t_checks, "wall_s": wall}
    log(f"[flash-general] {len(cases)} cases passed in {t_checks:.1f} s "
        f"(forward by route {by_fwd_route}, backward by route {by_route}); "
        f"the sm90 forward beat the general one in both orders at "
        f"{sorted(k for k, w in fwd_won.items() if w)}, not at "
        f"{sorted(k for k, w in fwd_won.items() if not w)}; phase wall "
        f"{wall:.1f} s")
    return rec


def train_fp32(hvt, kernels, sizes):
    """[train-fp32]: GPT-2 small with dtype=float32 through the ZeRO-1 fused
    step on the one-rank NCCL world, on [train]'s seeded batch: the first
    step's loss and gradients against use_flash=False, then one warm-up and
    3 timed steps (12 launches a step of the general forward and of each
    backward kernel on fwd_route's and bwd_route's routes -- the sm90
    kernels -- none of the general or wgmma ones, one AdamW a bucket)."""
    from horovod_tpu_torch.parallel import dp

    fa, fadam, tq = kernels
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    hvt.init(backend="nccl")
    cfg = hvt.GPT2Config.small(dtype=torch.float32,
                               param_dtype=torch.float32)
    sd0 = hvt.convert.init_params(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len + 1), dtype=np.int64
    )).cuda()

    def build(use_flash):
        model = hvt.GPT2LMModel(dataclasses.replace(cfg, use_flash=use_flash))
        model.load_state_dict(sd0)
        return model

    model_k, model_p = build(None), build(False)
    step, opt = hvt.make_train_step(train_loss(model_k),
                                    hvt.fused_adamw(TRAIN_LR), sharded=True,
                                    fused_update=True)
    state = dp.init_state(model_k, opt)
    if bucket_sizes(state) != list(sizes):
        raise RuntimeError(f"[train-fp32] buckets {bucket_sizes(state)} != "
                           f"[train]'s {list(sizes)}")
    loss_k, _, g_k = dp.accumulate_gradients(train_loss(model_k),
                                             state.params, tokens, 1)
    loss_p, _, g_p = dp.accumulate_gradients(
        train_loss(model_p), dict(model_p.named_parameters()), tokens, 1)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel = grads_rel_l2(g_k, g_p)
    del g_k, g_p, model_p
    torch.cuda.empty_cache()
    log(f"[train-fp32] first step, kernels vs plain attention: loss "
        f"{float(loss_k):.7f} vs {float(loss_p):.7f} (relative {loss_rel:.3e},"
        f" tol 1e-5); gradients relative L2 {grad_rel:.3e} (tol 1e-4)")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
        raise RuntimeError("[train-fp32] the kernels' step disagrees with "
                           "plain attention")
    losses = []
    state, _ = timed_steps(step, state, lambda i: tokens, 1, losses)
    reset_counts(fa, fadam, tq)
    torch.cuda.reset_peak_memory_stats()
    state, times = timed_steps(step, state, lambda i: tokens, 3, losses)
    counts = general_counts(fa)
    counts["fused_adamw"] = fadam.launches
    peak = peak_gib()
    head_dim = cfg.d_model // cfg.n_heads
    want = dict({k: 0 for k in counts}, fused_adamw=len(sizes),
                **fwd_counts(fa, torch.float32, head_dim, cfg.n_layers),
                **bwd_counts(fa, torch.float32, head_dim, cfg.n_layers))
    check_counts("train-fp32", counts, want, 3)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"[train-fp32] the losses did not fall: {losses}")

    def one_step():
        nonlocal state
        state, _ = step(state, tokens)

    prof = profile_window(one_step, {"steps": 1})
    flash_split = {c: ms for c, ms in prof["by_category_ms"].items()
                   if c.startswith(("flash_general", "flash_bwd_sm90",
                                    "flash_fwd_sm90"))}
    flash_ms = sum(flash_split.values())
    step_ms = float(np.median(times))
    log(f"[train-fp32] losses {losses}; step median {step_ms:.1f} ms "
        f"({times}); flash device time {flash_ms:.2f} ms a step of "
        f"{prof['device_ms']:.2f} ({flash_split}); peak memory {peak:.2f} "
        f"GiB; launches over 3 steps {counts}")
    hvt.shutdown()
    del model_k, step, state
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"[train-fp32] phase wall {wall:.1f} s")
    return {"losses": losses, "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
            "step_ms": step_ms, "step_ms_all": times,
            "flash_device_ms": flash_ms, "flash_device_ms_split": flash_split,
            "peak_gib": peak,
            "launches": counts, "profile": prof, "wall_s": wall}


def zoo_tiny_model(hvt, name, dt, use_flash, **cfg_kw):
    """The repository's tiny ``name`` (head dim 16, or as ``cfg_kw`` sets
    it) computing in ``dt`` with fp32 weights, its seeded weights loaded,
    and one seeded input batch."""
    kw = dict(dtype=dt, param_dtype=torch.float32, use_flash=use_flash,
              **cfg_kw)
    rng = np.random.default_rng(5)
    if name == "vit":
        cfg = hvt.ViTConfig.tiny(**kw)
        model, sd = hvt.ViT(cfg), hvt.convert.init_vit_params(cfg, seed=0)
        x = rng.standard_normal((4, 3, cfg.image_size, cfg.image_size),
                                dtype=np.float32)
    else:
        tiny = hvt.GPT2Config.tiny if name == "gpt2" else hvt.BertConfig.tiny
        cfg = tiny(**kw)
        if name == "gpt2":
            model, sd = hvt.GPT2LMModel(cfg), hvt.convert.init_params(cfg, 0)
        else:
            model = hvt.BertModel(cfg)
            sd = hvt.convert.init_bert_params(cfg, seed=0)
        x = rng.integers(0, cfg.vocab_size, (4, 64))
    model.load_state_dict(sd)
    return model, torch.from_numpy(x).cuda()


def zoo_tiny_train(hvt, kernels, dt, label, cfg_kw):
    """The tiny GPT-2 (its head dim as ``cfg_kw`` sets it) trains
    ZOO_TINY_STEPS ZeRO-1 fused steps in ``dt`` with falling losses and
    n_layers launches a step of the forward kernel on fwd_route's route
    and of each backward kernel on bwd_route's route."""
    import torch.nn.functional as F

    from horovod_tpu_torch.parallel import dp

    fa = kernels[0]
    model, _ = zoo_tiny_model(hvt, "gpt2", dt, None, **cfg_kw)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, model.cfg.vocab_size, (8, 65))).cuda()

    def loss_fn(p, t, model=model):
        logits = torch.func.functional_call(model, p, (t[:, :-1],))
        return F.cross_entropy(logits.flatten(0, 1), t[:, 1:].flatten())

    step, opt = hvt.make_train_step(loss_fn, hvt.fused_adamw(1e-3),
                                    sharded=True, fused_update=True)
    state = dp.init_state(model, opt)
    reset_counts(*kernels)
    losses = []
    state, times = timed_steps(step, state, lambda i: toks, ZOO_TINY_STEPS,
                               losses)
    n = model.cfg.n_layers * ZOO_TINY_STEPS
    head_dim = model.cfg.d_model // model.cfg.n_heads
    tag = f"gpt2 {str(dt)[6:]}{label}"
    counts = check_general_counts(f"zoo-tiny {tag} train", fa, {
        **fwd_counts(fa, dt, head_dim, n), **bwd_counts(fa, dt, head_dim, n)})
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"[zoo-tiny] {tag}: the losses did not fall: "
                           f"{losses}")
    log(f"[zoo-tiny] {tag} (head dim {head_dim}) trains: losses {losses}; "
        f"step ms {times}; launches {counts}")
    return {"losses": losses, "launches": counts, "head_dim": head_dim}


def zoo_tiny(hvt, kernels):
    """[zoo-tiny]: the tiny GPT-2, BERT (no padding mask) and ViT, head dim
    16, in bf16 and fp32 under use_flash=None: a forward and backward
    against the use_flash=False twin, n_layers launches of the forward
    kernel on fwd_route's route and of each backward kernel on bwd_route's;
    the tiny GPT-2 trains 3 steps, and 3 more at head dim 256 (in fp32 the
    general route, forward and backward)."""
    fa, fadam, tq = kernels
    t0 = time.perf_counter()
    hvt.init(backend="nccl")
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for name in ("gpt2", "bert", "vit"):
            tag = f"{name} {str(dt)[6:]}"
            res = {}
            for use_flash in (None, False):
                model, x = zoo_tiny_model(hvt, name, dt, use_flash)
                n = model.cfg.n_layers
                head_dim = model.cfg.d_model // model.cfg.n_heads
                fa.reset_launches()
                y = model(x).float()
                w = torch.from_numpy(np.random.default_rng(6).standard_normal(
                    tuple(y.shape), dtype=np.float32)).cuda()
                (y * w).sum().backward()
                # The kernels on the flash side, one forward and one
                # backward a layer; none on the plain side.
                counts = check_general_counts(
                    f"zoo-tiny {tag} use_flash={use_flash}", fa,
                    {**fwd_counts(fa, dt, head_dim, n),
                     **bwd_counts(fa, dt, head_dim, n)}
                    if use_flash is None else {})
                res[use_flash] = (y.detach(), {
                    k: p.grad for k, p in model.named_parameters()
                    if p.grad is not None}, counts)
            (y_k, g_k, counts), (y_p, g_p, _) = res[None], res[False]
            if g_k.keys() != g_p.keys():
                raise RuntimeError(f"[zoo-tiny] {tag}: the twins' gradients "
                                   f"reach other parameters")
            err_y = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
            err_g = max((g_k[k].float() - g_p[k].float()).abs().max().item()
                        for k in g_p) / max(g_p[k].float().abs().max().item()
                                            for k in g_p)
            tol = ZOO_TINY_TOL[dt]
            log(f"[zoo-tiny] {tag}: forward max|d| / max|plain| {err_y:.3e}, "
                f"gradients {err_g:.3e} (tol {tol}); launches {counts}")
            if not (err_y <= tol and err_g <= tol):
                raise RuntimeError(f"[zoo-tiny] {tag} disagrees with its "
                                   f"use_flash=False twin")
            out[tag] = {"out_err": err_y, "grad_err": err_g,
                        "launches": counts}
        # The tiny GPT-2 trains through the ZeRO-1 fused step, at head dim
        # 16 and at 256.
        for label, cfg_kw in (("", {}), (" d256", ZOO_TINY_D256)):
            out[f"gpt2 {str(dt)[6:]}{label} train"] = zoo_tiny_train(
                hvt, kernels, dt, label, cfg_kw)
    hvt.shutdown()
    wall = time.perf_counter() - t0
    log(f"[zoo-tiny] phase wall {wall:.1f} s")
    out["wall_s"] = wall
    return out


def flash_route_rows(general, fp32_trained, tiny):
    """The "kernels" line's rows of the general flash kernels, the sm90
    forward and the sm90 backward pair, from [flash-general], [train-fp32]
    and [zoo-tiny]."""
    src = "horovod_tpu_torch/csrc/"
    ref = "horovod_tpu/ops/pallas_kernels.py:"
    kernels = []
    # The general route of rows 1-3 (csrc/flash_general.cu): "ms",
    # "device_ms", "plain_ms", "library_ms" and the bounds at the fp32
    # [train-fp32] shape [8, 1024, 12, 64] causal (the backward rows: "ms"
    # the pair called directly, by events, "device_ms" each kernel; bounds
    # at the FFMA rate), "timed" the same at every timed shape [8, 1024,
    # 768 / d, d] causal; "launches" the [zoo-tiny] head-dim-256 tiny
    # GPT-2's 3 steps in fp32 (the general route, forward and backward),
    # "launches_train_fp32" the 3 timed [train-fp32] steps' (0: that path
    # runs the sm90 kernels), and "launches_zoo_tiny" each [zoo-tiny] run's.
    timed = general["timed"]
    g32 = timed["float32"][64]
    tiny_runs = {k: r["launches"] for k, r in tiny.items()
                 if isinstance(r, dict)}
    d256 = [r for k, r in tiny_runs.items() if k.endswith("d256 train")]

    def times(r, work, pair, dev, bounds="bounds", fwd_key="fwd_ms"):
        fwd = work == "fwd"
        return {"ms": r[fwd_key] if fwd else r[pair],
                "device_ms": r["device_ms"][dev],
                "plain_ms": r["plain_fwd_ms"] if fwd else r["plain_pair_ms"],
                "bound_ms": r[bounds][work]["bound_ms"],
                "bound_by": r[bounds][work]["bound_by"],
                "pair_bound_ms": r[bounds]["pair"]["bound_ms"],
                "library_ms": r["sdpa_fwd_ms"] if fwd else r["sdpa_bwd_ms"],
                "library": f"scaled_dot_product_attention "
                           f"({r['sdpa_backend']})",
                "shape": r["shape"], "d_pad": r["d_pad"],
                "bwd_route": r["bwd_route"]}

    for name, line in (("flash_general_fwd", "125"),
                       ("flash_general_dkdv", "480"),
                       ("flash_general_dq", "541")):
        fwd = name == "flash_general_fwd"
        count = name.replace("flash_", "")
        work = "fwd" if fwd else name.replace("flash_general_", "")
        row = functools.partial(times, work=work, pair="general_pair_ms",
                                dev=name, fwd_key="general_fwd_ms")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "flash_general.cu",
            "replaces": ref + line,
            "launches": sum(c[count] for c in d256),
            "launches_train_fp32": fp32_trained["launches"][count],
            "launches_zoo_tiny": {k: c[count] for k, c in tiny_runs.items()},
            "max_abs_err": general["max_err_out"] if fwd
            else general["max_err_grad"],
            "max_abs_err_lse": general["max_err_lse"],
            "max_rel_err": general["max_rel_grad"],
            "fp64_err": {d: r["general"] for d, r in
                         general["fp64_by_d"].items()},
            "dtype": "float32",
            **row(g32),
            "timed": {dt: {d: row(r) for d, r in by_d.items()}
                      for dt, by_d in timed.items()},
        })
    # The sm90 forward (csrc/flash_fwd_sm90_general.cu) on fwd_route's sm90
    # sizes: "ms" by events, "device_ms", "plain_ms", "library_ms" (SDPA's
    # forward) at [train-fp32]'s fp32 shape; "bound_ms" there the 3xTF32
    # tensor-core bound, "bound_ffma_ms" the FFMA-rate one; "general_ms"
    # and "general_device_ms" the general forward in the same run, timed
    # between the two "ms" readings ("ms_again" the second); "timed" every
    # sm90 shape of the grid, bf16 bounds at the bf16 rate; "launches" the
    # 3 timed [train-fp32] steps'.
    def sm90_fwd_row(r):
        fp32 = r["dtype"] == "float32"
        row = times(r, "fwd", "pair_ms", "flash_fwd_sm90",
                    "bounds_tf32" if fp32 else "bounds")
        del row["pair_bound_ms"]
        row.update(ms_again=r["fwd_ms_again"], general_ms=r["general_fwd_ms"],
                   general_device_ms=r["device_ms"]["flash_general_fwd"],
                   faster_than_general=r["sm90_fwd_faster"],
                   fwd_route=r["fwd_route"])
        if fp32:
            row["bound_ffma_ms"] = r["bounds"]["fwd"]["bound_ms"]
        return row

    kernels.append({
        "name": "flash_fwd_sm90",
        "route": "cuda",
        "source": src + "flash_fwd_sm90_general.cu",
        "replaces": ref + "125",
        "launches": fp32_trained["launches"]["sm90_fwd"],
        "launches_zoo_tiny": {k: c.get("sm90_fwd", 0)
                              for k, c in tiny_runs.items()},
        "max_abs_err": max(general["sm90_fwd_max_err_out"].values()),
        "max_abs_err_by_dtype": general["sm90_fwd_max_err_out"],
        "max_abs_err_lse": general["sm90_fwd_max_err_lse"],
        "fp64_err": {d: {k: r["kernel"][k] for k in ("out", "lse")}
                     for d, r in general["fp64_by_d"].items()},
        "dtype": "float32",
        **sm90_fwd_row(g32),
        "timed": {dt: {d: sm90_fwd_row(r) for d, r in by_d.items()
                       if r["fwd_route"] == "sm90"}
                  for dt, by_d in timed.items()},
    })
    # The sm90 backward pair (csrc/flash_bwd_sm90_general.cu) on bwd_route's
    # sm90 sizes: "ms" (the pair by events), "device_ms" (each kernel),
    # "plain_ms", "library_ms" (SDPA's backward) at [train-fp32]'s fp32
    # shape; "bound_ms" there the 3xTF32 tensor-core bound (the products as
    # three tf32 products each), "bound_ffma_ms" the FFMA-rate bound the
    # general rows use; "general_pair_ms" the general pair in the same run;
    # "timed" every sm90 shape of the grid, bf16 bounds at the bf16 rate;
    # "launches" the 3 timed [train-fp32] steps'.
    for name, line in (("flash_bwd_sm90_dkdv", "480"),
                       ("flash_bwd_sm90_dq", "541")):
        count = name.replace("flash_bwd_", "")
        work = name.replace("flash_bwd_sm90_", "")

        def sm90_row(r, work=work, name=name):
            fp32 = r["dtype"] == "float32"
            row = times(r, work, "pair_ms", name,
                        "bounds_tf32" if fp32 else "bounds")
            row["pair_ms_again"] = r["pair_ms_again"]
            row["general_pair_ms"] = r["general_pair_ms"]
            row["general_device_ms"] = r["device_ms"][
                name.replace("bwd_sm90", "general")]
            row["faster_than_general"] = r["sm90_faster"]
            if fp32:
                row["bound_ffma_ms"] = r["bounds"][work]["bound_ms"]
                row["pair_bound_ffma_ms"] = r["bounds"]["pair"]["bound_ms"]
            return row

        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "flash_bwd_sm90_general.cu",
            "replaces": ref + line,
            "launches": fp32_trained["launches"][count],
            "launches_zoo_tiny": {k: c.get(count, 0)
                                  for k, c in tiny_runs.items()},
            "max_abs_err": max(general["sm90_max_err_grad"].values()),
            "max_rel_err": general["sm90_max_rel_grad"],
            "fp64_err": {d: r["kernel"] for d, r in
                         general["fp64_by_d"].items()},
            "dtype": "float32",
            **sm90_row(g32),
            "timed": {dt: {d: sm90_row(r) for d, r in by_d.items()
                           if r["bwd_route"] == "sm90"}
                      for dt, by_d in timed.items()},
        })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import quantization as tq

    t_script = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[card] sources sha256 {source_fingerprint()}")
    before = sorted(p.name for p in _build.BUILD_DIR.glob("lib*.so"))
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[card] built {built} in {time.perf_counter() - t0:.1f} s "
        f"(libraries in _build/ before: {before or 'none'})")
    # Kernel 7's and the sm90 forward's compiler reports, in the background
    # until [int8] and [flash-general] read them.
    reporter = ThreadPoolExecutor(max_workers=1)
    report = reporter.submit(compiler_report, tq.INT8_MATMUL_SOURCE)
    fwd_report = reporter.submit(compiler_report, fa.SM90_FWD_SOURCE)
    reporter.shutdown(wait=False)

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_case = flash_case(fa, gen, b=8, sq=1024, skv=1024, h=12, d=64,
                           causal=True, timed=True)
    # The fp8 step's shape (batch 16), timed only to price the forward there.
    fwd_b16 = flash_case(fa, gen, b=16, sq=1024, skv=1024, h=12, d=64,
                         causal=True, timed=True)
    cases = [
        main_case,
        fwd_b16,
        flash_case(fa, gen, b=2, sq=333, skv=1000, h=12, d=64, causal=False,
                   q_offset=40, kv_len=937),
        flash_case(fa, gen, b=2, sq=200, skv=520, h=4, d=128, causal=True,
                   q_offset=300, kv_offset=0, kv_len=517),
        # Query tiles with no valid key (all zeros and -inf) beside tiles
        # that see some.
        flash_case(fa, gen, b=1, sq=300, skv=300, h=2, d=64, causal=True,
                   kv_offset=150),
        flash_case(fa, gen, b=1, sq=300, skv=300, h=2, d=128, causal=True,
                   kv_offset=150),
        # The new phases' shapes, non-causal: ViT-L/16 at 224 (S 197, a
        # ragged tile edge) and BERT-base at 32 x 512.
        flash_case(fa, gen, b=32, sq=197, skv=197, h=16, d=64, causal=False),
        flash_case(fa, gen, b=32, sq=512, skv=512, h=12, d=64, causal=False),
    ]
    # Ragged tile edges: every length around the 128-row tiles, keys masked
    # past kv_len < Skv, causal with q_offset > 0.
    for sq, skv in ((1, 1), (63, 65), (65, 63), (127, 129), (129, 127),
                    (1, 1000), (1000, 1), (129, 1000), (1000, 129)):
        for d in fa.WGMMA_HEAD_DIMS:
            for causal in (False, True):
                cases.append(flash_case(
                    fa, gen, b=1, sq=sq, skv=skv, h=2, d=d, causal=causal,
                    kv_len=max(skv * 3 // 4, 1),
                    q_offset=max(skv - sq, 1) if causal else 0,
                ))
    bwd_main = bwd_case(fa, gen, b=8, sq=1024, skv=1024, h=12, d=64,
                        causal=True, timed=True)
    # The fp8 step's shape (batch 16), timed only to price the pair there.
    bwd_b16 = bwd_case(fa, gen, b=16, sq=1024, skv=1024, h=12, d=64,
                       causal=True, timed=True)
    f32 = torch.float32
    bwd_cases = [
        bwd_main,
        bwd_b16,
        bwd_case(fa, gen, b=2, sq=333, skv=1000, h=12, d=64, causal=False,
                 q_offset=40, kv_len=937),
        bwd_case(fa, gen, b=2, sq=200, skv=520, h=4, d=128, causal=True,
                 q_offset=300, kv_len=517),
        # An fp32 cotangent (delta from it as given) and ragged tile edges.
        bwd_case(fa, gen, b=2, sq=1024, skv=1024, h=12, d=64, causal=True,
                 g_dtype=f32),
        bwd_case(fa, gen, b=2, sq=129, skv=1000, h=4, d=128, causal=False,
                 kv_len=999, g_dtype=f32),
        bwd_case(fa, gen, b=1, sq=65, skv=127, h=2, d=64, causal=True,
                 q_offset=62, kv_len=100),
        bwd_case(fa, gen, b=1, sq=1, skv=129, h=2, d=128, causal=True,
                 q_offset=128),
        bwd_case(fa, gen, b=1, sq=1000, skv=63, h=2, d=128, causal=False,
                 kv_len=60, g_dtype=f32),
        # The new phases' shapes (ViT-L/16 at 224, BERT-base at 32 x 512).
        bwd_case(fa, gen, b=32, sq=197, skv=197, h=16, d=64, causal=False),
        bwd_case(fa, gen, b=32, sq=512, skv=512, h=12, d=64, causal=False),
    ]
    general = flash_general_phase(fa, gen, fwd_report)
    train_cfg = hvt.GPT2Config.small(param_dtype=torch.float32)
    sizes = trainer_bucket_sizes(hvt, train_cfg)
    adam = adamw_case(fadam, gen, sizes)
    torch.cuda.empty_cache()
    trained = train(hvt, fa, fadam, train_cfg, sizes)
    fp32_trained = train_fp32(hvt, (fa, fadam, tq), sizes)
    tiny = zoo_tiny(hvt, (fa, fadam, tq))
    qsizes = quant_bucket_sizes(hvt, train_cfg)
    quant = quant_case(tq, gen, qsizes)
    kv_quant = kv_quant_case(tq, gen)
    quant_trained = train_quant(hvt, (fa, fadam, tq), train_cfg, sizes,
                                qsizes)
    resharded = ckpt_reshard(hvt, (fa, fadam, tq), train_cfg, len(qsizes))
    fp8 = fp8_case(tq, gen, train_cfg)
    fp8_cast = fp8_cast_case(tq, gen, train_cfg)
    fp8_trained = train_fp8(hvt, (fa, fadam, tq), train_cfg)

    workdir = tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_DIR)
    try:
        served = serve(hvt, fa, workdir)
        int8 = int8_case(tq, gen, hvt.GPT2Config.small(), report)
        served_int8 = serve_int8(hvt, fa, tq, workdir,
                                 served.pop("answers8"), served["profile"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log_threads("[serve-int8]")
    decoded = decode(hvt, tq)
    log_threads("[decode]")
    bert = train_bert(hvt, (fa, fadam, tq))
    remat = train_remat(hvt, (fa, fadam, tq))
    zooed = zoo(hvt, (fa, fadam, tq))
    adasum = train_adasum(hvt, (fa, fadam, tq))
    overlapped = train_overlap(hvt, (fa, fadam, tq))
    actq = train_actquant(hvt, (fa, fadam, tq), gen)
    gpt3d = train_3d(hvt, (fa, fadam, tq))
    ring = ring_flash(hvt, (fa, fadam, tq))
    guarded = train_guard(hvt, (fa, fadam, tq))
    gsp = gspmd_phase(hvt, (fa, fadam, tq))
    dchaos = decode_chaos(hvt)
    launched = launch_phase(hvt, trained)
    recovered = elastic_recover(hvt)
    served_kv = serve_kv(hvt)
    log_threads("[serve-kv]")
    observed = obs_phase(hvt, (fa, fadam, tq))
    log_threads("[obs]")
    equant = elastic_quant(hvt, len(qsizes))
    tuned = autotune_phase(hvt, (fa, fadam, tq))
    served_tuned = serve_autotune(hvt, fa)
    log_threads("[serve-autotune]")
    streamed = stream_phase(hvt, (fa, fadam, tq))
    log_threads("[stream]")
    profiled = profile_step_phase(hvt)
    analyzed = analysis_phase(hvt, (fa, fadam, tq), trained, remat, sizes)
    eagered = eager_phase(hvt)
    hvd_torch = hvd_torch_phase(hvt, (fa, fadam, tq))
    log_threads("[hvd-torch]")
    hvd_elastic = hvd_elastic_phase(hvt)
    log_threads("[hvd-elastic]")
    hvd_tune = hvd_tune_phase(hvt, (fa, fadam, tq))
    log_threads("[hvd-torch-tune]")
    sparked = spark_estimator_phase(hvt, (fa, fadam, tq))
    # [train-remat] trains GPT-2 small, [train]'s layout (held in adam).
    adam_phases = adamw_phase_checks(fadam, gen, {
        "train_bert": bert["bucket_sizes"],
        **{"zoo_" + k: zooed[k]["bucket_sizes"]
           for k in ("vit", "resnet", "moe")}})
    new_launches = {"launches_train_bert": bert["launches"],
                    "launches_train_bert_masked": bert["launches_masked"],
                    "launches_train_remat": {
                        k: r["launches"] for k, r in remat["runs"].items()},
                    "launches_zoo": {k: zooed[k]["launches"]
                                     for k in ("vit", "resnet", "moe")},
                    "launches_train_adasum": adasum["launches"],
                    "launches_train_overlap": {
                        k: overlapped["runs"][k]["launches"]
                        for k in ("off", "on")} | {
                        k + "_on": overlapped[k]["on"]["launches"]
                        for k in ("zero1_fused", "int8_wire")},
                    "launches_train_actquant": {
                        f"{m}/{side}": r["launches"]
                        for m in ("gpt2", "resnet50", "mlp")
                        for side, r in actq[m].items()},
                    "launches_train_3d": gpt3d["launches"],
                    "launches_ring_flash": {
                        k: r["launches"] for k, r in ring["runs"].items()},
                    "launches_train_guard": {
                        "skip_step": guarded["skip"]["launches"],
                        "skip_step_int8": guarded["skip_int8"]["launches"]},
                    "launches_gspmd": gsp["launches"],
                    "launches_launch": launched["launches"],
                    "launches_elastic_recover": recovered["launches"],
                    "launches_obs": observed["launches"],
                    "launches_elastic_quant": equant["launches"],
                    "launches_autotune": tuned["launches"],
                    "launches_serve_autotune": served_tuned["launches"],
                    "launches_stream": streamed["launches"],
                    "launches_profile_step":
                        profiled["bert"]["flash_launches"],
                    "launches_analysis": analyzed["launches"],
                    "launches_hvd_torch": hvd_torch["launches"],
                    "launches_hvd_elastic": hvd_elastic["launches"],
                    "launches_hvd_torch_tune": hvd_tune["launches"],
                    "launches_spark_estimator": sparked["launches"]}
    # [serve-kv]'s workers run kernel 1 only: its count over every batch
    # of both runs, the other kernels' 0.
    serve_kv_flash = (served_kv["clean"]["flash_launches"]
                      + served_kv["chaos"]["flash_launches"])

    src = "horovod_tpu_torch/csrc/"
    ref = "horovod_tpu/ops/pallas_kernels.py:"
    launches = trained["launches"]
    def phase_launches(name):
        """The new phases' counts of kernel ``name`` (each read over its own
        run, the counts set to 0 just before it)."""
        return {
            "train_bert": new_launches["launches_train_bert"][name],
            "train_bert_masked":
                new_launches["launches_train_bert_masked"][name],
            "train_remat": {k: c[name] for k, c in
                            new_launches["launches_train_remat"].items()},
            "zoo": {k: c[name] for k, c in
                    new_launches["launches_zoo"].items()},
            "train_adasum": new_launches["launches_train_adasum"][name],
            "train_overlap": {k: c[name] for k, c in
                              new_launches["launches_train_overlap"].items()},
            "train_actquant": {k: c[name] for k, c in
                               new_launches["launches_train_actquant"].items()},
            "train_3d": new_launches["launches_train_3d"][name],
            "ring_flash": {k: c[name] for k, c in
                           new_launches["launches_ring_flash"].items()},
            "train_guard": {k: c[name] for k, c in
                            new_launches["launches_train_guard"].items()},
            "gspmd": new_launches["launches_gspmd"][name],
            "launch": new_launches["launches_launch"].get(name, 0),
            "elastic_recover":
                new_launches["launches_elastic_recover"].get(name, 0),
            "serve_kv": serve_kv_flash if name == "flash_fwd" else 0,
            "obs": {k: c.get(name, 0) for k, c in
                    new_launches["launches_obs"].items()},
            "obs_serve": sum(observed["serve"]["flash"].values())
            if name == "flash_fwd" else 0,
            "elastic_quant":
                new_launches["launches_elastic_quant"].get(name, 0),
            "autotune": new_launches["launches_autotune"].get(name, 0),
            "serve_autotune":
                new_launches["launches_serve_autotune"].get(name, 0),
            "stream": new_launches["launches_stream"].get(name, 0),
            "profile_step_bert":
                new_launches["launches_profile_step"].get(name, 0),
            "analysis": new_launches["launches_analysis"].get(name, 0),
            "hvd_torch": new_launches["launches_hvd_torch"].get(name, 0),
            "hvd_elastic": new_launches["launches_hvd_elastic"].get(name, 0),
            "hvd_torch_tune":
                new_launches["launches_hvd_torch_tune"].get(name, 0),
            "spark_estimator":
                new_launches["launches_spark_estimator"].get(name, 0),
        }

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": ref + "125",
        "launches": launches["flash_fwd"],
        "launches_serve": served["launches"],
        "launches_phases": phase_launches("flash_fwd"),
        "max_abs_err": max(c["err_out"] for c in cases),
        "max_abs_err_lse": max(c["err_lse"] for c in cases),
        "bitwise_repeat": all(c["bitwise"] for c in cases),
        "ms": main_case["ms"],
        "device_ms": main_case["device_ms"],
        "host_us": main_case["host_us"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "b16": {key: fwd_b16[key] for key in (
            "ms", "device_ms", "host_us", "bound_ms", "library_ms",
            "library_device_ms")},
        # The flash ring's forward at [8, 2048, 6, 64] causal: n^2 hops and
        # their merges over n virtual sp ranks, beside one whole call.
        "ring_flash_fwd_device_ms": {
            **{k: r["fwd_device_ms"] for k, r in ring["runs"].items()},
            "whole": ring["whole"]["fwd_device_ms"],
            "whole_held": ring["whole"]["fwd_held_device_ms"]},
        # [analysis]: straight launch vs the hvt op, in the same run.
        "wrap": analyzed["wrap"]["flash_fwd"],
    }]
    # The two backward kernels run as one pair (flash_attention_bwd): "ms"
    # is the pair's CUDA-event time, as for every row, "device_ms" each
    # kernel's own profiled time; the plain version and the yardstick (SDPA's
    # backward, by events and by device time) compute the pair's function.
    # "b16" holds the same at batch 16, the fp8 step's shape.
    for name, line in (("flash_bwd_dkdv", "480"), ("flash_bwd_dq", "541")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": ref + line,
            "launches": launches[name],
            "launches_phases": phase_launches(name),
            "max_abs_err": max(c["err"] for c in bwd_cases),
            "max_rel_err": max(c["rel_err"] for c in bwd_cases),
            "bitwise_repeat": all(c["bitwise"] for c in bwd_cases),
            "ms": bwd_main["ms"],
            "device_ms": bwd_main["kernel_ms"][name],
            "plain_ms": bwd_main["plain_ms"],
            "bound_ms": bwd_main[name]["bound_ms"],
            "bound_by": bwd_main[name]["bound_by"],
            "pair_bound_ms": bwd_main["pair"]["bound_ms"],
            "library_ms": bwd_main["library_ms"],
            "library_device_ms": bwd_main["library_device_ms"],
            "ring_flash_fwd_bwd_device_ms": {
                **{k: r["fwd_bwd_device_ms"]
                   for k, r in ring["runs"].items()},
                "whole": ring["whole"]["fwd_bwd_device_ms"],
                "whole_held": ring["whole"]["fwd_bwd_held_device_ms"]},
            "wrap_pair": analyzed["wrap"]["flash_bwd"],
            "b16": {
                "ms": bwd_b16["ms"],
                "device_ms": bwd_b16["kernel_ms"][name],
                "bound_ms": bwd_b16[name]["bound_ms"],
                "pair_bound_ms": bwd_b16["pair"]["bound_ms"],
                "library_ms": bwd_b16["library_ms"],
                "library_device_ms": bwd_b16["library_device_ms"],
            },
        })
    kernels += flash_route_rows(general, fp32_trained, tiny)
    kernels.append({
        "name": "fused_adamw",
        "route": "cuda",
        "source": src + "fused_adamw.cu",
        "replaces": ref + "1064",
        "launches": launches["fused_adamw"],
        "launches_phases": phase_launches("fused_adamw"),
        "max_abs_err": max([adam["err"]] + [
            r["max_abs_err"] for r in adam_phases.values()]),
        "max_rel_err": max([adam["rel_err"]] + [
            r["max_rel_err"] for r in adam_phases.values()]),
        "bitwise": adam["bitwise"],
        "skip_flag": adam["skip_flag"],
        "phases_checked": adam_phases,
        "ms": adam["ms"],
        "plain_ms": adam["plain_ms"],
        "bound_ms": adam["bound_ms"],
        "bound_by": adam["bound_by"],
        "library_ms": adam["library_ms"],
        "wrap": analyzed["wrap"]["fused_adamw"],
    })
    qlaunch = {r: quant_trained[r]["launches"] for r in ("on", "zero1", "fp8")}
    # "kv_write" / "kv_gather": the decode path's KV shapes at block 64 (one
    # round's two launches, with their own bounds), and "launches_decode" the
    # int8 [decode] run's count.
    for name, line, pre, kv in (
            ("quantize_blockwise", "963", "quant", "write"),
            ("dequantize_blockwise", "978", "dequant", "gather")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "quant_blockwise.cu",
            "replaces": ref + line,
            "launches": qlaunch["on"][name],
            "launches_zero1": qlaunch["zero1"][name],
            "launches_fp8": qlaunch["fp8"][name],
            "launches_ckpt_reshard": resharded["int8"]["launches"][name],
            "launches_decode": decoded["int8"]["launches"][name],
            "launches_phases": phase_launches(name),
            "max_abs_err": quant["max_abs_err"],
            "bitwise": quant["bitwise"],
            "ms": quant[pre + "_ms"],
            "ms_fp8": quant[pre + "_ms_fp8"],
            "plain_ms": quant[pre + "_plain_ms"],
            "plain_ms_fp8": quant[pre + "_plain_ms_fp8"],
            "bound_ms": quant["bound_ms"],
            "bound_by": quant["bound_by"],
            "library_ms": quant.get(pre + "_library_ms"),
            "kv_" + kv: kv_quant[kv],
            # One act-quant boundary of GPT-2 small at 32 x 1024 (25.2 M
            # fp32 elements, block 256), with its bound and plain time.
            "boundary": {
                "ms": actq["kernels"][pre + "_ms"],
                "plain_ms": actq["kernels"][pre + "_plain_ms"],
                "bound_ms": actq["kernels"]["bound_ms"],
                "bound_by": actq["kernels"]["bound_by"],
                "library_ms": actq["kernels"].get(pre + "_library_ms"),
                "elements": actq["kernels"]["elements"]},
        })
    # Kernel 8: "ms", "plain_ms", "library_ms" and "bound_ms" are one
    # training step's 216 launches (each shape's time times its launches a
    # step); "cases" holds each shape's own. "ms" and "library_ms" are the
    # CUDA-event times of back-to-back calls, as for every other kernel
    # (they include the host's time where a wrapper takes longer than its
    # kernel); "device_ms" and "library_device_ms" the device times
    # (device_ms: the kernel's and torch._scaled_mm's calls with the host's
    # launches hidden).
    step8 = fp8["step"]
    kernels.append({
        "name": "fp8_matmul",
        "route": "cuda",
        "source": src + "fp8_matmul.cu",
        "replaces": ref + "1268",
        "launches": fp8_trained["on"]["launches"]["fp8_matmul"],
        "launches_per_step": step8["launches"],
        "launches_relayout": fp8_trained["on"]["launches"]["fp8_relayout"],
        "max_abs_err": fp8["max_abs_err"],
        "max_rel_err": fp8["max_rel_err"],
        "promotion_rel_err": fp8["promotion_rel_err"],
        "ms": step8["ms"],
        "device_ms": step8["device_ms"],
        "plain_ms": step8["plain_ms"],
        "bound_ms": step8["bound_ms"],
        "bound_by": step8["bound_by"],
        "library_ms": step8["library_ms"],
        "library_device_ms": step8["library_device_ms"],
    })
    # The cast kernel (not a TPU kernel: the port's counterpart of XLA's
    # fusion of the jnp cast and amax in horovod_tpu/ops/fp8.py): "ms",
    # "plain_ms" and "bound_ms" are one training step's 216 launches, "ms"
    # the CUDA-event time and "device_ms" the device time, as for kernel 8.
    step_c = fp8_cast["step"]
    kernels.append({
        "name": "fp8_cast",
        "route": "cuda",
        "source": src + "fp8_cast.cu",
        "replaces": "horovod_tpu/ops/fp8.py:136",
        "launches": fp8_trained["on"]["launches"]["fp8_cast"],
        "launches_per_step": step_c["launches"],
        "max_abs_err": fp8_cast["max_abs_err"],
        "bitwise": True,
        "ms": step_c["ms"],
        "device_ms": step_c["device_ms"],
        "plain_ms": step_c["plain_ms"],
        "bound_ms": step_c["bound_ms"],
        "bound_by": step_c["bound_by"],
        "library_ms": None,
    })
    # Kernel 7: "ms", "plain_ms", "library_ms", "bf16_ms" and "bound_ms" are
    # one serving batch's 48 launches at M = 8192 (the device_* keys the
    # device times (device_ms) of the kernel, the library call and the bf16
    # F.linear); "decode" the same at M = 8 (its split contraction's sums
    # included), where the event times are the host's and the device_* times
    # the card's. "host_us" is the wrapper's host time a call (enqueue only),
    # averaged over one batch's 48 calls.
    batch7, decode7 = int8["batch"], int8["decode"]
    kernels.append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": src + "int8_matmul.cu",
        "replaces": ref + "1162",
        "launches": served_int8["launches"],
        "launches_per_batch": batch7["launches"],
        "launches_relayout": served_int8["launches_relayout"],
        "launches_reduce": served_int8["launches_reduce"],
        "max_abs_err": int8["max_abs_err"],
        "max_rel_err": int8["max_rel_err"],
        "bitwise_repeat": int8["bitwise_repeat"],
        "bias_bitwise": int8["bias_bitwise"],
        "ms": batch7["ms"],
        "device_ms": batch7["device_ms"],
        "host_us": batch7["host_us"],
        "plain_ms": batch7["plain_ms"],
        "bound_ms": batch7["bound_ms"],
        "bound_by": batch7["bound_by"],
        "library_ms": batch7["library_ms"],
        "device_library_ms": batch7["device_library_ms"],
        "bf16_ms": batch7["bf16_ms"],
        "device_bf16_ms": batch7["device_bf16_ms"],
        "decode": {k: v for k, v in decode7.items()
                   if k not in ("t_bytes", "t_ops")},
    })
    log_threads("every phase")
    log(f"[card] script wall {time.perf_counter() - t_script:.1f} s "
        f"([flash-general] {general['wall_s']:.1f}, [train-fp32] "
        f"{fp32_trained['wall_s']:.1f}, [zoo-tiny] {tiny['wall_s']:.1f})")
    print(json.dumps({"kernels": kernels, "train": trained,
                      "flash_general": general, "train_fp32": fp32_trained,
                      "zoo_tiny": tiny, "quant": quant,
                      "train_quant": quant_trained, "fp8": fp8,
                      "fp8_cast": fp8_cast,
                      "train_fp8": fp8_trained, "serve": served,
                      "int8": int8, "serve_int8": served_int8,
                      "kv_quant": kv_quant, "ckpt_reshard": resharded,
                      "decode": decoded, "train_bert": bert,
                      "train_remat": remat, "zoo": zooed,
                      "train_adasum": adasum, "train_overlap": overlapped,
                      "train_actquant": actq, "train_3d": gpt3d,
                      "ring_flash": ring, "train_guard": guarded,
                      "gspmd": gsp, "decode_chaos": dchaos,
                      "launch": launched, "elastic_recover": recovered,
                      "serve_kv": served_kv, "obs": observed,
                      "elastic_quant": equant, "autotune": tuned,
                      "serve_autotune": served_tuned, "stream": streamed,
                      "profile_step": profiled, "analysis": analyzed,
                      "eager": eagered, "hvd_torch": hvd_torch,
                      "hvd_elastic": hvd_elastic,
                      "hvd_torch_tune": hvd_tune,
                      "spark_estimator": sparked}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def wrapper_host_us(other_root: str) -> int:
    """``--wrapper-host-us DIR``: the host microseconds a call takes to
    return (enqueue only) of two wrappers -- the flash forward at GPT-2
    small's attention shape, and kernel 7's at its fc product (M = 8192 and
    M = 8, bf16 [B, S, K] x, a weight quantized by each package; without a
    bias, and with one as Dense.forward adds it: in the epilogue where the
    wrapper takes a bias, else a separate ``+ b``) -- for the
    ``horovod_tpu_torch`` under DIR (another checkout, e.g. the parent
    commit's) and for this checkout's. Each package runs in a process of
    its own (both register the ``hvt`` op library, which a process takes
    once), four processes in the order DIR, this, this, DIR, so that the
    host's drift falls on both alike; each times ten windows of 200 calls
    a wrapper. Prints each process's windows, each wrapper's median per
    package over its two processes, and the ratio."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    roots = {"other": Path(other_root).resolve(),
             "this": Path(__file__).resolve().parent}
    times = {}
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--wrapper-host-us-one", str(roots[name])],
            capture_output=True, text=True, check=True)
        for wrapper, t in json.loads(proc.stdout.splitlines()[-1]).items():
            times.setdefault(wrapper, {}).setdefault(name, []).extend(t)
            log(f"[host] {wrapper} {name} {roots[name]}: one process's "
                f"windows {json.dumps([round(x, 2) for x in t])} us a call")
    for wrapper, by_name in times.items():
        med = {n: float(np.median(t)) for n, t in by_name.items()}
        log(f"[host] {wrapper}: median this {med['this']:.2f}, other "
            f"{med['other']:.2f} us a call; this / other "
            f"{med['this'] / med['other']:.3f}")
    log(f"[host] {card_line()}")
    return 0


def wrapper_host_us_one(root: str) -> int:
    """``--wrapper-host-us-one DIR``: one process of :func:`wrapper_host_us`
    for the ``horovod_tpu_torch`` under DIR: prints, as its last line, a
    JSON object of each wrapper's ten windows (host us a call)."""
    import inspect

    sys.path.insert(0, str(Path(root).resolve()))
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantization as tq

    if not Path(fa.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {fa.__file__}, not the package under "
                           f"{root}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = qkv_views(gen, 8, 1024, 1024, 12, 64)
    w = torch.randn((768, 3072), generator=gen, device="cuda") * 0.02
    b = (torch.randn((3072,), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    qw = tq.quantize_weight(w)
    fused = "bias" in inspect.signature(tq.int8_weight_matmul).parameters
    calls = {"flash_fwd": lambda: fa.flash_attention_with_lse(
        q, k, v, causal=True, layout="bsm", n_heads=12)}
    for m in (8192, 8):
        x = torch.randn((8, m // 8, 768), generator=gen,
                        device="cuda").to(torch.bfloat16)
        calls[f"int8_matmul M={m}"] = (
            lambda x=x: tq.int8_weight_matmul(x, qw))
        calls[f"int8_matmul+bias M={m}"] = (
            (lambda x=x: tq.int8_weight_matmul(x, qw, b)) if fused
            else (lambda x=x: tq.int8_weight_matmul(x, qw) + b))
    with torch.no_grad():
        times = {name: [host_us(call) for _ in range(10)]
                 for name, call in calls.items()}
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    # A crash in native code (SIGSEGV, SIGABRT) prints every thread's Python
    # stack to stderr before the process dies.
    faulthandler.enable(all_threads=True)
    if len(sys.argv) == 3 and sys.argv[1] == "--wrapper-host-us":
        sys.exit(wrapper_host_us(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--wrapper-host-us-one":
        sys.exit(wrapper_host_us_one(sys.argv[2]))
    rc = main()
    if rc == 0:
        # Every phase passed and printed; every thread and process the
        # script started has ended ("[threads] after every phase"). Leave
        # without the interpreter's teardown of the CUDA, NCCL and profiler
        # libraries' state, which has nothing left to check.
        torch.cuda.synchronize()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    sys.exit(rc)
