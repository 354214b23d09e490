#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`distributed_model_parallel_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU (an H100):

    python3 chip_smoke.py

Phases; any failure exits non-zero (nothing is caught and passed over).
Every LM CLI run in this process, and in each gloo rank of phases 14
and 15, reuses the Markov corpus and loss floor its flags name, made
once (`lm_corpus_made_once`: 3.2 s a run at vocab 50257 until phase 16
was added). Every torch.profiler reading is tallied from the profiler's
raw events (`profile_tally`: 0.2-0.3 s a profiled BERT_BASE step on the
card's host, where `key_averages()` took 2.2-3.3 s), and the first
profile of each kind in a process is held against `key_averages()`.
The phases:

1. Device: require CUDA, print the card's name and power limit
   (nvidia-smi). TF32 is switched off for matmuls and cuDNN, so every
   f32 product on the card is a full-precision one.
2. Build: compile `csrc/int8_matmul.cu` and `csrc/flash_attention.cu`
   with nvcc for sm_90a, one process each, started together, and print
   the build times and each kernel's ptxas registers and spills; the
   flash kernels at their default tiles (K3 at Dh 64) and the int8
   kernel must not spill.
3. Kernel vs plain version on the card, at the four GPT-2-small decode
   projection shapes with M = 8 slots, plus M = 3 and M = 256: identical
   int8 activation codes, scales and outputs (torch.equal); per shape
   the kernel's, the plain version's and `torch.matmul`'s (f32, same
   (M,K)x(K,N); an unquantized product, not the kernel's function, and
   a yardstick the port never calls) times, CUDA events and profiler
   device time, the device time of `torch._int_mm` on the same codes
   (cuBLASLt s8 x s8 -> s32 with M padded to 32: the integer product
   alone, not K4's function, never called by the port), and the bound
   (bytes over 3.35 TB/s vs int8 ops over 1,979 TOP/s).
4. Serving: the port's serve CLI (`cli/serve.py` main) at the full
   width of `GPTConfig()` (vocab 50257, dim 768, 12 layers, 12 heads,
   ffn 3072, 1024 positions; random weights from seed 0): 8 slots,
   prefill_len 128, 16 requests of 16-128 prompt tokens, 32 new tokens
   each, greedy — once f32, once int8. The int8 run must launch the
   kernel 48 times (4 projections x 12 layers) per decode step. Then
   the first decode step at full width, f32 and int8, on the card and
   on the CPU (plain versions) with the same weights and inputs: the
   int8 engine's logits must equal those it gives with the plain GEMM
   swapped in; int8 must lie within INT8_LOGIT_REL of f32 on both; f32
   on the card must match the CPU within F32_CARD_VS_CPU; int8 card and
   CPU codes may differ only by rounding ties that start from f32
   noise, and their logits by less than int8 differs from f32. A small
   model's logits on the card must match the CPU's tightly.
   The flash-attention kernels K1-K3 (`csrc/flash_attention.cu`) are
   checked against their plain versions, f32 and bf16, at the training
   path's shape (B 8, T 1024, H 12, Dh 64, causal, all-true key mask),
   at T 1000 (a ragged tile) and with a batch row whose keys are all
   masked, K3 at every tile `TILES` lists; at the path shape each is
   timed (CUDA events and profiler),
   beside its plain version, SDPA (forward; forward + backward, and the
   backward's device time, which computes dq, dk and dv together; a
   yardstick the port never calls), its bound (f32 67 / bf16 989
   TFLOP/s vs 3.35 TB/s) and a sweep over every tile `TILES` lists.
5. LM training: the port's LM CLI (`cli/lm.py` main) at GPT-2-small
   width (vocab 50257, dim 768, 12 layers, 12 heads, ffn 3072, T 1024,
   batch 8; random weights from seed 0), 4 train steps and 1 validation
   batch, `--attention ulysses_flash` in f32 and bf16, then a 2-layer
   `--attention ring_flash` run (the external-LSE entry points). Exact
   launch counts (K1 = layers x (steps + val batches), K2 = K3 = layers
   x steps), finite losses, per-step loss and ms, tokens/s, and one
   profiled step's device idle share and per-kernel device time. Then
   one train step of a small GPT on the card against the CPU (loss and
   every gradient leaf), and at full width the kernels against the
   plain attention swapped in on the card.
6. Data-parallel training: the port's DP CLI (`cli/data_parallel.py`
   main) on MobileNetV2 (the CIFAR `CFG` widths, about 2.2 M
   parameters), global batch 512, SyntheticTextures (50,000 train and
   10,000 val images at CIFAR-10's shapes, made once for the three
   runs, on a thread during phase 2's build), lr 0.4, `-j 8`, 16 train steps (30 until phase 13 was added)
   and the validation pass, as
   `--engine ddp` f32, `--engine ddp --dtype bfloat16` and `--engine
   gspmd` f32, on a world of one NCCL rank. cudnn.benchmark stays off
   (the default). Per run one JSON line: synchronized ms/step (mean
   over steps 6-16), images/s, the trainer's wall time and data wait
   per batch, the native augment's host ms per batch, one profiled
   step's device busy ms, idle share, kernels a step and top five
   kernel families, the peak of `torch.cuda.max_memory_allocated`, the
   first and last train loss. Checks: the process group is NCCL at
   world 1 and the gradient all-reduce ran once a step; the native
   augment built and made every train batch; losses finite and falling.
   Then, f32 and bf16, the forward + backward device ms a step of each
   layer kind at batch 512, each layer alone (depthwise convs, other
   convs, the port's BN, cuDNN's fused BN as a yardstick), and one
   tinycnn DDP step on the card against the CPU (loss and every
   parameter, rtol 1e-5, TF32 off). No TPU kernel lies on this
   path: convolutions are cuDNN's, the all-reduce NCCL's.
7. Checkpoint and resume (every CLI run of phases 5-7 writes its
   checkpoints under one temporary directory in the working directory,
   deleted at the end):
   (a) the f32 determinism probe: a MobileNetV2 DDP step at batch 512,
   the same batches twice with cuDNN free to choose its algorithms and
   twice with `cudnn.deterministic` (the CLIs' setting), per-step
   losses, ms a step and the convolution kernels of each, then one step
   under `torch.use_deterministic_algorithms(True, warn_only=True)`;
   the deterministic runs must be equal. Then the DP CLI, MobileNetV2
   f32, two epochs of 8 steps (30 until phase 13 was added, 12 until
   phase 14 was): `--engine ddp` twice and `--engine gspmd` once (equal
   per-step losses), one epoch then `--resume` to two (the straight
   run's losses and epoch-1 record), each epoch's validation on the
   first 2,560 of the 10,000 val images (all until phase 14 was added),
   save / restore ms and file bytes.
   (b) the LM CLI at GPT-2-small width, `ulysses_flash` f32, 2 + 2
   steps across `--resume` against 4 straight: equal per-step losses,
   exact K1-K3 launches, save / restore ms and bytes.
   (c) `serve --checkpoint` on (b)'s directory, f32 and int8 (K4 48
   times a decode step), and the first decode step's int8-vs-f32 logits
   on those trained weights.
8. Pipeline model parallelism (slice 7): the port's pipeline CLI
   (`cli/model_parallel.py` main) on MobileNetV2 at batch 512, lr 0.4,
   `-j 8`, on phase 6's SyntheticTextures, `--world-size 4` (four
   stages on the one card, so they run one after another: no bubble
   can show), 6 steps and a validation pass over the first 512 of
   the 10,000 validation images each (30 steps and all 10,000 until
   phase 10 was added, 12 steps until phase 11, 10 steps and 2,560
   images until phase 13, 1,024 images until phase 14; cut in depth to
   keep the whole run near 1,000 s):
   the reference
   split at `--microbatches 1` (the reference's schedule) and at 8 with
   gpipe and 1f1b in f32 and bf16, and interleaved (V 2, the default
   8-chunk split) at 8. Per run one JSON line (ms/step over steps 6-10,
   images/s, device busy / idle share and kernels a step from one
   profiled step, top five kernel families, peak memory, per-step
   losses, val acc1). Checks: losses finite and falling; NCCL at world
   1 with the gradient all-reduce; 1f1b's peak memory below gpipe's at
   M 8; one f32 step of 1f1b and of interleaved within PP_STEP_REL of
   gpipe's (every parameter and BN buffer; bit-equality printed), and
   the M 1 step within it of the DataParallelEngine's at world 1; one
   tinycnn pipeline step (S 2, M 2) on the card against the CPU. Then
   the LM CLI at GPT-2-small width with `--pipeline-stages 4
   --microbatches 4`, gpipe f32 and 1f1b bf16, 4 steps and 1 val batch
   (ms a step, tokens/s, peak memory, per-step loss); K1-K4 must launch
   0 times in the whole phase (the stages attend dense, as in JAX).
9. Serving features (slice 8), at phase 4's width and flags: (a)
   `--page-size 16 --prefill-chunk 64` f32 through the serve CLI, whose
   tokens must equal phase 4's contiguous f32 run's request by request
   (tokens/s, decode and TTFT p50/p99, peak pages, KV bytes against the
   contiguous stripes), and one paged and one contiguous decode step's
   device busy time, idle share and kernels a step; (b)
   `ServingEngine.run` on 16 requests sharing a 96-token prefix (16-32
   token tails), with and without `prefix_cache`: equal tokens, hit
   rate, pages reused, TTFT; (c) speculative int8 at k = 4 through the
   serve CLI (8 requests a run; 16 until phase 15 was added), with
   phase 7's LM checkpoint as target and draft (the
   full-accept path: accept rate above 0.9) and with a fresh 2-layer
   draft (the rollback path): tokens equal to a plain paged int8 run of
   the same target, K4 launched 48 x (target decode + verify steps) + 4
   x draft layers x draft decode steps; (d) `--compute-dtype bf16`,
   contiguous and paged (tokens/s, decode p50, token agreement with
   f32), and the first decode step's bf16-vs-f32 logit gap on the card
   and on the CPU under BF16_LOGIT_REL. K1-K3 must launch 0 times in
   the phase.
10. Slice 9 (the training knobs and the transformer classifiers):
   (a) the LM CLI at phase 5's width and flags with `--remat`, 4 steps
   (8 until phase 15 was added),
   f32 and bf16: per-step losses against phase 5's runs without remat
   (1e-5 f32, S9_REMAT_REL bf16; bit-equality printed), peak memory
   below theirs, K1 = 2 x 12 a step (the recompute) and K2 = K3 = 12;
   (b) the same runs with `--steps-per-dispatch 4 --profile-dir
   --metrics-out x.prom` (the step captured in a CUDA graph and
   replayed) against them, and MobileNetV2 DDP bf16 (phase 6's flags,
   16 steps) with and without it: each dispatch's metric sums equal the
   step-by-step run's summed in the same groups and order, and every
   final parameter and BN statistic, bit for bit; the wrappers' counts
   and the all-reduces the host issues are exact (under the graph: the
   warmup step and the capture; a replay runs no Python), and the
   replays' K1-K3 launches, counted by kernel name in a profile of one
   4-step dispatch and in the `--profile-dir` trace, equal four eager
   steps' (the LM's 4-step run is made again, at most S9_TRACE_TRIES
   times, while its trace holds fewer records: the profiler drops
   some; the tries are printed, and the phase fails when both dtypes
   needed more than one); per run ms a step, and from one profiled 4-step pass its
   own wall ms, device busy, idle share, kernels and host CUDA API calls
   a step (timed after the run), peak memory, capture seconds; the
   trace of the MobileNetV2 run must hold three steady-state steps'
   kernels and each `.prom` file parse as Prometheus text with the
   `train_step_s` summary; (c) the DP CLI on `--model vit` (SyntheticTextures, batch
   512, AdamW) gspmd f32, ddp f32, ddp bf16, and `--model bert`
   (BERT_BASE, SyntheticText, batch 512, AdamW, dropout 0.1; 2 epochs
   of 5 steps, of 8 until phase 15 was added) f32 with
   and without `--remat` (remat's peak memory must be the lower): ms a
   step, samples/s, busy / idle, kernels a step, peak memory, losses
   (finite and falling), val acc1; (d) the pipeline CLI on bert_tiny,
   4 stages, M 4, gpipe and 1f1b, 2 epochs of 8 steps (4 until phase
   15 was added; losses falling), and one bert_tiny
   step through 4 stages against the DataParallelEngine's within
   PP_STEP_REL; (e) one ViT, one bert_tiny and one 2-layer BERT_BASE-
   width DDP step (dropout 0) on the card against the CPU within
   DP_CARD_VS_CPU. K4 must launch 0 times.
11. Slice 10 (gradient reduction; DDP's bucketed Reducer and the
   stagewise overlapped backward), at world 1 on NCCL: (a) the DP CLI
   on MobileNetV2 `--engine ddp` at phase 6's flags, 8 steps (12 until
   phase 15 was added) and
   validation on 2,560 images, f32 and bf16,
   `--grad-reduction monolithic`, `bucketed --bucket-mb 1` and
   `overlapped --bucket-mb 1`
   (4 segments); (b) the LM CLI at phase 5's width (12 layers,
   `ulysses_flash`, 4 steps and 1 val batch), f32 and bf16, monolithic,
   bucketed (25 MB) and overlapped, K1-K3 launches exact. Per run one
   JSON line: ms a step, per-step losses, collectives issued a step, and
   from one profiled step device busy, idle share, kernels a step, NCCL
   kernels (none at world 1) and peak memory; in f32, bucketed and
   overlapped losses and final parameters must equal monolithic's bit
   for bit (bf16 printed). (c) MobileNetV2 DDP bf16 overlapped 1 MB with
   and without `--steps-per-dispatch 4`: dispatch sums and final state
   bit-equal, collectives issued exact, ms a step and idle share of
   each. (d) tinycnn and bert_tiny DDP steps, bucketed and overlapped,
   card against CPU within DP_CARD_VS_CPU. (e) the int8 and bf16 wire
   codecs on MobileNetV2's real gradient bucket: card codes and scales
   equal the CPU's. The hierarchical and compressed paths need two
   ranks: a printed line says so, and nothing here fakes them. K4 must
   launch 0 times.
12. Slice 11 (tensor parallelism, the device-resident dataset cache,
   the image-folder datasets), on phase 11's SyntheticTextures (val cut
   to 2,560): (a) the DP CLI at world 1 on NCCL, `--model bert`
   (BERT_BASE, SyntheticText, batch 512, AdamW lr 1e-3, dropout 0.1, 1
   epoch of 4 steps) and `--model vit` (VIT_CIFAR, batch 512, 4
   steps; 2 x 6 and 12 until phase 13 was added, 2 x 4 and 8 until
   phase 15), f32 and bf16, under `--engine tp --model-shards 1` and
   under
   `--engine gspmd`: per run ms a step, samples/s, busy / idle, kernels
   a step, peak memory; f32 losses and final parameters bit-equal
   between the two engines (bf16 printed); BERT f32 tp with `--steps-per-dispatch 4`
   bit-equal to its eager run. (b) TP at M 2: two processes on the one
   card over gloo (NCCL puts one rank on a GPU), 3 SGD steps of
   bert_tiny and of a 2-layer BERT_BASE-width model against the M 1
   engine on the card (losses and gathered parameters within
   S11_M2_TOL), qkv shards (768, 1152), per-rank parameter bytes, and
   times labelled host-staged gloo (not a TP time); if gloo refuses CUDA
   tensors a line says so. (c) MobileNetV2 DDP at phase 11's flags, f32
   and bf16, with and without `--device-cache`: ms a step, data wait a
   batch, host-to-device bytes a step, busy / idle, the cache's bytes on
   the card; the initial state's eval logits on one val batch through
   the cache and the host loader within S11_LOGIT_REL; bf16
   `--device-cache --steps-per-dispatch 4` bit-equal to eager, with the
   crops differing from step to step. (d) With PIL, a 10-class tree of
   64x64 PNGs and `--dataset-type Imagenet --model resnet18`, 4 steps
   (finite losses); without PIL a line says so. (e) K1-K4 launch 0
   times in the phase.
13. Slice 12 (FSDP, the sharded checkpoint format, elastic restart):
   (a) the DP CLI at world 1 on NCCL, `--engine fsdp` against `--engine
   ddp` at the same flags, monolithic, bucketed and overlapped, on
   BERT_BASE (phase 12's flags: batch 512, AdamW 1e-3, dropout 0.1, 1
   epoch of 2 steps) in f32 and bf16 and on MobileNetV2 (phase 11's
   flags at 2 steps, f32; 8 until phase 15 was added): per run ms a
   step, samples/s, busy / idle, kernels a
   step, peak memory and the collectives issued a step (gradient ones
   and FSDP's weight all-gathers); f32 losses and final parameters
   bit-equal between the engines (bf16 printed); BERT f32 fsdp
   bucketed with `--steps-per-dispatch 4` bit-equal to its eager run.
   (b) FSDP at N 2: two processes on the one card over gloo (NCCL puts
   one rank on a GPU), 3 SGD steps of a 2-layer BERT_BASE-width model
   (dropout 0: the keys fold the data rank) against N 1 on the card
   (losses and gathered parameters within S11_M2_TOL), once more on a
   dcn 2 mesh with the int8 wire (losses within S12_M2_INT8_LOSS_REL
   and rank 0's gathered parameters off N 1's by at most
   S12_M2_INT8_PARAM_REL of N 1's own update, leaf by leaf, and
   S12_M2_INT8_PARAM_ALL_REL over all leaves); the
   per-rank bytes of parameters and AdamW moments against N 1; the ms
   labelled host-staged gloo (not an FSDP time); the N 2 state saved
   as a sharded checkpoint. (c) The DP CLI on MobileNetV2 (`--engine
   ddp` and `fsdp`, 2 epochs of 4 steps, `--checkpoint-format sharded
   --async-save`): one epoch then `--resume` equal to two straight (per-
   step losses and the epoch-1 record), fsdp `--max-restarts 1` with a
   failure injected at the start of epoch 1 equal to straight, the
   time each save held the loop and each shard file's write, the
   files; (b)'s N 2 file restored at N 1 on the card, bit-exact. (d)
   The LM CLI at phase 7's flags (GPT-2-small width, `ulysses_flash`
   f32) under `--checkpoint-format sharded --async-save`: 2 + 2 steps
   across `--resume`, bit-equal to phase 7's 4 straight steps (the
   same training, saved in the legacy format), K1-K3 launches exact;
   the time each save held the loop against phase 7's legacy save
   times of the same state. K4 must launch 0 times. Runs whose
   checkpoints no check reads (phases 5, 6, 8, 10-12 and 13 (a)) save
   none: the machine takes 45 GiB of disk writes a call.
14. Slice 13 (sequence parallelism at N > 1): (a) the LM CLI at
   `--seq-shards 2` in two spawned processes on the one card, each in a
   gloo world of 2 that it joins before `cli/lm.main` does (NCCL puts
   one rank on a GPU; the K/V hops, all-to-alls and all-reduces stage
   CUDA tensors through the host), GPT-2-small width, `--optimizer sgd`,
   2 steps (3 until phase 16 was added) and 1 val batch: `ring_flash`
   f32 at 4 layers, bf16 and
   `ulysses_flash` f32 at 2 (12, 4 and 4 until phase 15 was added; the
   f32 run 6 until phase 16),
   plain `ring` and `ulysses` and a
   `--grad-reduction bucketed` ring_flash run at 2, each against
   `--seq-shards 1` in this process at the same flags (f32: per-step
   losses and rank 0's final parameters within S11_M2_TOL; bf16
   printed; rank 1's parameters equal to rank 0's bit for bit); exact
   K1-K4 launches on each seq rank s, counted in the rank (ring_flash:
   K1 = layers x (s + 1) x (steps + val batches), K2 = K3 = layers x
   (s + 1) x steps; ulysses_flash as at N 1; the plain cores none; K4
   none); each rank's
   ms a step (host-staged gloo, not a ring time), and its device busy
   over one profiled step of the ring_flash f32 run. (b) K1-K3 at the
   hop shapes (S13_HOP_CASES: ring_flash's resident block and a masked
   non-causal hop at (8, 512, 12, 64), ulysses_flash's (8, 1024, 6,
   64)), f32 and bf16, through the path shape's `flash_case` and
   `flash_timings`: against their plain versions (FLASH_TOL), with the
   non-finite and tile-sweep checks, each timed with its bound and SDPA
   as the yardstick. (c) `SequenceParallelEngine` (BERT, ring_flash,
   padded key masks) at N 2 over gloo, 2-layer BERT_BASE width, dropout
   0, 3 SGD steps, against `DDPEngine` at N 1 on the card within
   S11_M2_TOL, rank 1's parameters equal to rank 0's; K1-K3 12
   launches a rank and K4 none.
15. Slice 14 (the tp / sp serving layouts, collective matmul): (c) K4
   against its plain version at the shapes the layouts give it at
   GPT-2-small width (S14_SHAPES: the Megatron shards at M 8, the row
   shards with the whole row's absmax as the kernel's input, and the
   ring chunks of 4 and 2 rows at S 2 and 4), each timed as in phase 3
   with its bound and `torch._int_mm`; (a, b) two spawned processes on
   the one card in a gloo world of 2 (joined before the CLIs do) run the
   serve CLI at phase 4's width and flags (8 requests of 8 new tokens,
   16 until phase 16 was added; phase 4 serves 16 of 32) under `--layout tp --model-shards 2`, f32
   and int8, each with and without `--collective-matmul`, and `--layout
   sp --seq-shards 2`, contiguous and `--page-size 16`: the K4 launches
   of each run exact (48 a decode step a rank declarative, 96 on the
   rings at S 2, 0 in f32), and every layout's engine through a
   teacher-forced script (8 prompts, S14_STEPS decode steps): the ranks'
   logits bit-equal, f32 and every prefill within S14_F32_REL of this
   process's replicated engine, int8 decode within INT8_LOGIT_REL of
   replicated f32 and int8 (the share inside the reference's
   elementwise budget printed); tokens/s and decode p50 / p99 labelled
   host-staged gloo (not a tp or sp time). (d) The same ranks run the
   LM CLI at `--seq-shards 2 --attention ring_flash` (2 layers) and the
   DP CLI's BERT_BASE at `--engine tp --model-shards 2` (dropout 0.1, 2
   steps), each with and without `--collective-matmul`: per-step losses
   within S14_LOSS_REL, K1-K4 launches equal.
16. Slice 15 (expert parallelism): (a) the LM CLI with `--moe-experts 8
   --moe-every 2` at GPT-2-small width (12 layers, 6 of them MoE, top-2,
   capacity factor 1.25, AdamW), 3 steps and 1 val batch, gspmd f32 and
   bf16 and hierarchical f32 at S 1: per run ms and loss a step,
   tokens/s, peak memory, one profiled step's device busy, idle share
   and top kernels, K1-K4 0 launches, losses finite; the hierarchical
   run's losses and final parameters bit-equal to gspmd's; one MoE
   layer's forward + backward at the path shapes by parts (routing, the
   dispatch / combine einsums, the expert FFN; CUDA events) and each
   part's share of the step over the 6 MoE layers. (b) A small MoE GPT
   with dropped tokens (capacity factor 0.5): one train step's loss and
   every gradient leaf on the card against the CPU within
   SMALL_CARD_VS_CPU. (c) Gloo ranks on the one card (host-staged), at
   full width with 2 layers, SGD, 2 steps: `--expert-shards 2`,
   hierarchical at data 2, hierarchical `--moe-overlap` (two processes
   each), then `--dcn-slices 2 --moe-dispatch hierarchical
   --dcn-compression int8` (four processes), each against the N 1 run
   at the same flags in this process: losses within S11_M2_TOL (int8:
   S15_INT8_LOSS_REL), rank 0's gathered parameters within S11_M2_TOL
   (int8: each leaf off N 1's by at most S15_INT8_PARAM_REL of the
   distance N 1's steps moved it), expert bytes a rank 1/N of N 1's, the exchange's hops
   `exchange_permutes` twice a train step and once a val batch, K1-K4
   none. (d) The phase's seconds.
17. Slice 16 (composed parallel plans): (a) `cli.lm --plan dp1` at world
   1 on NCCL at GPT-2-small width (12 layers; the composed engine's
   dp-only tick program), SGD, 3 steps and 1 val batch, f32 and bf16:
   per-step ms and loss, tokens/s, peak memory above the start, K1-K4 0
   launches; the f32 run against the dense single-rank LM CLI run of the
   same flags and seed (the same weights) within S11_M2_TOL, losses and
   every parameter. (b) Gloo ranks on the one card (host-staged hops;
   their ms are host copies, not plan times), full width with 2 blocks a
   stage, SGD, 2 steps and 1 val batch: `--plan pp2xsp2 --attention
   ring_flash` and `--attention ulysses_flash`, `pp2-1f1bxdp2` and
   `pp2xfsdp2` (4 ranks each), the narrow
   `pp2xsp2xdp2` (8 ranks, dim 256), each against the N 1 LM run of the
   same flags without the plan in this process: losses and rank 0's
   gathered parameters within S11_M2_TOL, the ranks' sums equal, K1-K3
   exact per rank under ring_flash ((q + 1) x 2 blocks x 2 microbatches a
   step on seq rank q) and ulysses_flash (2 blocks x 2 microbatches) and
   none elsewhere, K4 none, the stage wire's
   payloads (2 a train step and a val batch from stage 0, 2 a train step
   from stage 1) and one fused reduction a train step; `cli.data_parallel
   --plan fsdp2` (MobileNetV2, Synthetic, 2 ranks) against `--engine ddp
   --sync-bn` on 2 ranks. The runs start in waves (S16_WAVES). (c) K1-K3
   at the plan's hop shapes (S16_HOP_CASES: (b)'s microbatch of 4 at
   (4, 512, 12, 64) for the ring's resident block and masked hop and
   (4, 1024, 6, 64) for Ulysses), f32 and bf16, as in phase 14 (b):
   against their plain versions (FLASH_TOL), timed with their bounds.
18. One `{"kernels": [...]}` JSON line (int8_matmul, flash_fwd,
   flash_bwd_dq, flash_bwd_dkv; `launches_slice6` counts phase 7's
   runs, `launches_slice7` phase 8's, `launches_slice8` phase 9's,
   `launches_slice9` phase 10's as the wrappers count them,
   `replays_slice9_traced` the launches that phase 10's profiles of
   4-step graph dispatches show, `launches_slice10` phase 11's,
   `launches_slice11` phase 12's, `launches_slice12` phase 13's,
   `launches_slice13` phase 14's over both ranks, `launches_slice14`
   phase 15's, `launches_slice15` phase 16's over every rank,
   `launches_slice16` phase 17's over every rank, each flash
   kernel's `hop_shapes` its phase-14 (b) rows, `plan_hop_shapes` its
   phase-17 (c) rows,
   and K4's `shard_and_ring_shapes` its phase-15 (c) rows), then
   the nvidia-smi line, then
   the last line `{"ok": true, "device": {...}}`. Each phase prints its
   seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
DECODE_SHAPES = (  # (name, K, N) of one GPT-2-small decoder block
    ("attn.qkv", 768, 2304), ("attn.out", 768, 768),
    ("ffn.in", 768, 3072), ("ffn.out", 3072, 768),
)
EXTRA_SHAPES = ((3, 768, 768), (256, 768, 3072))
SLOTS = 8
SPEC_K = 4
# The speculative verify step's K4 shapes: num_slots x (k+1) rows, at
# k = 4 (M = 40) for the four projections, and at k = 2 (M = 24).
VERIFY_SHAPES = tuple((SLOTS * (SPEC_K + 1), k, n)
                      for _, k, n in DECODE_SHAPES) + ((SLOTS * 3, 768, 768),)
SERVE_FLAGS = [
    "--device", "cuda", "--vocab-size", "50257", "--dim", "768",
    "--layers", "12", "--heads", "12", "--ffn-dim", "3072",
    "--num-slots", str(SLOTS), "--max-len", "1024", "--prefill-len", "128",
    "--num-requests", "16", "--prompt-len-min", "16",
    "--prompt-len-max", "128", "--max-new-tokens", "32", "--seed", "0",
]
LAYERS = 12
DEPTHS = (1, 2, 4, 8)  # cut depths for the int8-vs-f32 gap, beside LAYERS
# Ceiling on the first decode step's int8-vs-f32 logit gap, as
# max|int8 - f32| / max|f32| at full width, on the card and on the CPU.
# It is set from this script's readings, not from a reference bar (the
# full-width step fails both of the reference's: the single-GEMM 2e-2
# of tests/test_quant_matmul.py:142 and the elementwise decode-logit
# check of tests/test_serving.py, rtol 5e-2 atol 1e-2; both are printed).
# On one H100 the gap read 2.457e-2 on the card and 2.398e-2 on the CPU,
# and f32 rounding noise alone moved int8 logits by 1.62e-2 of max|logit|
# between card and CPU; the ceiling is the card reading plus that move.
# The gap is the reference's own: the JAX engine reads 2.2251e-2 against
# the port's 2.2250e-2 on the same CPU-drawn weights (int8_gap_vs_jax.py).
INT8_LOGIT_REL = 4.1e-2
# f32 logits on the card against the port's CPU run at full width: read
# 3.2e-6 (prefill) and 2.6e-6 (decode) on one H100; ten times that.
F32_CARD_VS_CPU = 3e-5
# Relative input difference that still counts as f32 rounding noise:
# card and CPU int8 GEMM inputs read up to 5.3e-7 before the first
# flipped code.
F32_NOISE_REL = 2e-6


# Checkpoints the CLI runs write (they save the best-val-acc model by
# default) go under one temporary directory in the working directory,
# deleted when the script ends.
SCRATCH = []


def scratch_dir(name: str) -> str:
    if not SCRATCH:
        SCRATCH.append(tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                        dir=os.getcwd()))
    return os.path.join(SCRATCH[0], name)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(m: int, k: int, n: int, absmax: bool = False):
    """Least time for y(M,N) f32 = int8 GEMM of x(M,K) f32 against a
    prepared (N,K) int8 weight + (N,) f32 scales (and, with `absmax`, an
    (M,) f32 input absmax): each input read once, the output written
    once, against 2*M*N*K int8 operations."""
    nbytes = 4 * m * k + n * k + 4 * n + 4 * m * n + (4 * m if absmax
                                                      else 0)
    ops = 2 * m * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, ops


def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean device time per call over `iters` calls cycling through
    `arg_sets` (copies whose weights together exceed the 50 MB L2, so
    each call finds its weight in HBM as a decode step does)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets, iters: int, key="int8_matmul_kernel"):
    """Mean device time per call of the device kernels whose name holds
    `key` (of every kernel `fn` launches when `key` is None), from
    torch.profiler's CUDA activity: the part of `time_ms` that is not
    host launch overhead. A profile that records fewer such launches
    than calls (the profiler drops kernel records now and then on the
    card, and once kept 1 of 60, giving 0.1 us a launch) is taken again,
    twice at most; None if none records them all."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        seen = [(t, n) for t, n, name in device_kernels(prof)
                if key is None or key in name]
        if sum(n for _, n in seen) >= iters:
            return sum(t for t, _ in seen) / iters / 1e3
    return None


def copies_for(nbytes: int) -> int:
    return max(2, min(400, math.ceil(120e6 / nbytes)))


def check_shape(qm, m, k, n, seed, absmax: bool = False):
    """Phase 3 at one shape: codes, scales and outputs vs the plain
    version, then the four timings. `absmax`: the kernel takes each
    row's absmax as an input (1.5 times the row's own, as a slice of a
    longer row would see), and the plain version the same."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = 0.02 * torch.randn((k, n), generator=g, device="cuda")
    wq_t, wscale = qm.prepare_weight(w)
    a = (1.5 * x.abs().amax(dim=-1)).contiguous() if absmax else None
    y, codes, scales = qm.int8_matmul(x, wq_t, wscale, absmax=a,
                                      return_codes=True)
    torch.cuda.synchronize()
    ref_codes, ref_scales = qm.quantize_rows(x, a)
    ref = qm.int8_matmul_plain(x, wq_t, wscale, a)
    require(torch.equal(codes, ref_codes),
            f"int8 codes differ from the plain version at {(m, k, n)}")
    require(torch.equal(scales, ref_scales),
            f"activation scales differ at {(m, k, n)}")
    err = float((y - ref).abs().max())
    require(torch.equal(y, ref), f"int8 outputs differ from the plain "
            f"version at {(m, k, n)} by up to {err:.3e}")
    kcopies = [(x, *qm.prepare_weight(w.roll(i, 1)))
               for i in range(copies_for(n * k))]
    fcopies = [(x, w.roll(i, 1)) for i in range(copies_for(4 * n * k))]

    def kernel(x, wq_t, wscale):
        return qm.int8_matmul(x, wq_t, wscale, absmax=a)

    def plain(x, wq_t, wscale):
        return qm.int8_matmul_plain(x, wq_t, wscale, a)

    kernel_ms = time_ms(kernel, kcopies, 300)
    kernel_device_ms = device_ms(kernel, kcopies, 60)
    plain_ms = time_ms(plain, kcopies, 30)
    library_ms = time_ms(torch.matmul, fcopies, 300)
    library_device_ms = device_ms(torch.matmul, fcopies, 60, None)
    int_mm_device_ms = None
    if k % 8 == 0 and n % 8 == 0:  # cuBLASLt's shape rule for _int_mm
        padded = torch.zeros((max(32, m), k), dtype=torch.int8,
                             device="cuda")
        padded[:m] = codes
        icopies = [(padded, wq.t()) for _, wq, _ in kcopies]
        int_mm_device_ms = device_ms(torch._int_mm, icopies, 60, None)
    bound_ms, bound_by, nbytes, ops = bound(m, k, n, absmax)
    return {"M": m, "K": k, "N": n, "input_absmax": absmax,
            "kernel_ms": kernel_ms,
            "kernel_device_ms": kernel_device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "int_mm_device_ms": int_mm_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "max_abs_err": err}


def serve_run(serve, flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(flags)
    return out


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def first_step(eng, p, prompts, tokens):
    """Prefill every slot, then one decode step with `tokens` fed in:
    (prefill next-token logits (slots, vocab), decode logits (slots,
    vocab)), both on the host."""
    cache = eng.init_cache()
    rows = []
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        cache, nl = eng.prefill(p, cache, ids, length, slot)
        rows.append(nl)
    active = torch.ones(len(prompts), dtype=torch.bool, device=eng.device)
    logits = eng.decode_step(p, cache, tokens.to(eng.device), active)[1]
    return torch.stack(rows).cpu(), logits.cpu()


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def bert_made_once():
    """SyntheticText and BERT_BASE's initial weights made once for the
    CLI runs inside: each run would make the same ones again from seed
    0 (0.9 and 1.2 s on the card's host, PR 12). The model's init returns
    copies of the first init's trees for the same class count and seed."""
    from distributed_model_parallel_tpu_torch.cli import common
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.training.optim import tree_map

    text = datasets.DatasetCollection("SyntheticText").init()
    make_data = datasets.DatasetCollection.init
    make_bert = common.MODELS["bert"]
    weights = {}

    def data(self):
        return text if self.dataset_type == "SyntheticText" \
            else make_data(self)

    def bert(num_classes, *, remat=False):
        model = make_bert(num_classes, remat=remat)

        def init(gen):
            key = (num_classes, gen.initial_seed())
            if key not in weights:
                weights[key] = model.init(gen)
            return tree_map(torch.clone, weights[key])

        return dataclasses.replace(model, init=init)

    common.MODELS["bert"] = bert
    try:
        with patched(datasets.DatasetCollection, "init", data):
            yield
    finally:
        common.MODELS["bert"] = make_bert


@contextlib.contextmanager
def lm_corpus_made_once():
    """The LM CLI's Markov corpora and loss floor made once for the runs
    inside (this process's): each run would make the same ones again
    from the same seeds, a Python walk of about 3 s at vocab 50257.
    Each run gets its own copy of the corpus."""
    import functools

    from distributed_model_parallel_tpu_torch.cli import lm

    corpus = functools.lru_cache(maxsize=None)(lm.synthetic_corpus)
    floor = functools.lru_cache(maxsize=None)(lm.chain_entropy)
    with patched(lm, "synthetic_corpus",
                 lambda *a, **kw: corpus(*a, **kw).copy()), \
            patched(lm, "chain_entropy", floor):
        yield


@contextlib.contextmanager
def without_saves():
    """The training CLIs' trainers with no best-acc save: the runs whose
    checkpoints no check reads write none (the card's machine takes
    45 GiB of disk writes a call; a BERT_BASE + AdamW save is 1.3 GB,
    a GPT-2-small one 1.96 GB). Phases 7, 9 and 13 (c, d) save."""
    import functools

    from distributed_model_parallel_tpu_torch.cli import (
        data_parallel,
        lm,
        model_parallel,
    )

    with contextlib.ExitStack() as stack:
        for mod in (data_parallel, lm, model_parallel):
            stack.enter_context(patched(mod, "TrainerConfig", functools.partial(
                mod.TrainerConfig, save_best=False)))
        yield


def plain_gemm(qm):
    """Route the engine's int8 GEMM through the plain version
    (`quant_matmul` looks `int8_matmul` up in its module)."""
    return patched(qm, "int8_matmul",
                   lambda x, wq_t, ws, absmax=None: qm.int8_matmul_plain(
                       x, wq_t, ws, absmax))


@contextlib.contextmanager
def recording_gemm(qm, inputs):
    """Record, as (M, K) host copies, the input of every projection the
    int8 policy runs (its column and row projections)."""
    def recording(call):
        def recorded(self, h, w, b):
            inputs.append(h.detach().reshape(-1, h.shape[-1]).cpu())
            return call(self, h, w, b)
        return recorded

    with patched(qm.QuantMatmul, "column",
                 recording(qm.QuantMatmul.column)), \
            patched(qm.QuantMatmul, "row", recording(qm.QuantMatmul.row)):
        yield


def int8_vs_f32(got, ref):
    """max|int8 - f32| / max|f32|, and the reference's elementwise
    decode-logit check (tests/test_serving.py: assert_allclose rtol 5e-2,
    atol 1e-2) as its worst excess over that allowance (<= 0 passes)."""
    diff = (got - ref).abs()
    excess = float((diff - (1e-2 + 5e-2 * ref.abs())).max())
    return {"rel": float(diff.max() / ref.abs().max()),
            "max_abs": float(diff.max()),
            "max_abs_f32_logit": float(ref.abs().max()),
            "reference_allclose_excess": excess,
            "passes_reference_allclose": excess <= 0}


def code_flips(qm, card_inputs, cpu_inputs):
    """Per int8 GEMM of one decode step (layer-major: qkv, out, ffn.in,
    ffn.out), the card's input against the CPU's: the input's relative
    difference and how many activation codes differ, and by how much."""
    rows = []
    for i, (xg, xc) in enumerate(zip(card_inputs, cpu_inputs)):
        dq = (qm.quantize_rows(xg)[0].int()
              - qm.quantize_rows(xc)[0].int()).abs()
        rows.append({"call": i,
                     "x_rel_diff": float((xg - xc).abs().max()
                                         / xc.abs().max()),
                     "flipped_codes": int((dq > 0).sum()),
                     "max_code_diff": int(dq.max())})
    return rows


def first_step_readings(serve, engine_cls, cfg_cls, qm):
    """The first decode step at full width, on the same weights, prompts
    and fed tokens: f32 and int8 engines on the card and on the CPU (the
    plain versions), the int8 engine on the card once more with the
    plain GEMM swapped in, and the int8-vs-f32 gap on the card at cut
    depths. Readings are printed before they are checked."""
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    cfg = cfg_cls(vocab_size=50257, dim=768, num_layers=LAYERS,
                  num_heads=12, ffn_dim=3072, max_position=1024,
                  dropout_rate=0.0, pad_token_id=0)
    kw = dict(num_slots=SLOTS, max_len=1024, prefill_len=128)
    prompts = [r.prompt for r in serve.synthetic_trace(args)[:SLOTS]]
    engines = {(mode, dev): engine_cls(cfg, compute_dtype=mode, device=dev,
                                       **kw)
               for mode in ("f32", "int8") for dev in ("cuda", "cpu")}
    host = tree_to(engines["f32", "cuda"].init_params(0), "cpu")
    params = {key: eng.place_params(host) for key, eng in engines.items()}

    def run(mode, dev, tokens):
        return first_step(engines[mode, dev], params[mode, dev], prompts,
                          tokens)

    pre_f32, f32 = run("f32", "cuda", torch.zeros(SLOTS, dtype=torch.int64))
    tokens = pre_f32.argmax(-1)
    f32 = run("f32", "cuda", tokens)[1]
    card_inputs, cpu_inputs = [], []
    with recording_gemm(qm, card_inputs):
        i8 = run("int8", "cuda", tokens)[1]
    with plain_gemm(qm):
        i8_plain = run("int8", "cuda", tokens)[1]
    cpu_pre_f32, cpu_f32 = run("f32", "cpu", tokens)
    with recording_gemm(qm, cpu_inputs):
        cpu_i8 = run("int8", "cpu", tokens)[1]

    by_depth = {}
    for depth in DEPTHS:
        cut = dataclasses.replace(cfg, num_layers=depth)
        sub = dict(host, blocks={str(i): host["blocks"][str(i)]
                                 for i in range(depth)})
        got = []
        for mode in ("f32", "int8"):
            eng = engine_cls(cut, compute_dtype=mode, device="cuda", **kw)
            got.append(first_step(eng, eng.place_params(sub), prompts,
                                  tokens)[1])
        by_depth[depth] = int8_vs_f32(got[1], got[0])["rel"]

    flips = code_flips(qm, card_inputs, cpu_inputs)
    first = next((r for r in flips if r["flipped_codes"]), None)
    readings = {
        "int8_vs_f32_card": int8_vs_f32(i8, f32),
        "int8_vs_f32_cpu": int8_vs_f32(cpu_i8, cpu_f32),
        "int8_vs_f32_card_rel_by_depth": by_depth,
        "kernel_vs_plain_engine_max_abs": float((i8 - i8_plain).abs().max()),
        "card_vs_cpu_max_abs": {
            "f32_prefill": float((pre_f32 - cpu_pre_f32).abs().max()),
            "f32_decode": float((f32 - cpu_f32).abs().max()),
            "int8_decode": float((i8 - cpu_i8).abs().max()),
        },
        "card_vs_cpu_int8_gemm_inputs": {
            "gemms": len(flips),
            "gemms_with_flipped_codes": sum(bool(r["flipped_codes"])
                                            for r in flips),
            "flipped_codes": sum(r["flipped_codes"] for r in flips),
            "codes": sum(x.numel() for x in cpu_inputs),
            "first_flipped": first,
            "per_gemm": flips,
        },
    }
    emit({"first_decode_step_full_width": readings})

    require(i8.shape == (SLOTS, 50257) and bool(torch.isfinite(i8).all())
            and bool(torch.isfinite(f32).all()),
            "first decode step logits not finite / wrong shape")
    require(len(flips) == 4 * LAYERS, f"{len(flips)} int8 GEMMs recorded")
    kp = readings["kernel_vs_plain_engine_max_abs"]
    require(kp <= 1e-5, f"int8 engine logits with the kernel differ from "
            f"those with the plain GEMM by {kp:.3e}")
    for where in ("card", "cpu"):
        rel = readings[f"int8_vs_f32_{where}"]["rel"]
        require(rel <= INT8_LOGIT_REL, f"int8 first-step logits on the "
                f"{where} off by {rel:.3e} of max|logit| (ceiling "
                f"{INT8_LOGIT_REL})")
    cvc = readings["card_vs_cpu_max_abs"]
    for key in ("f32_prefill", "f32_decode"):
        require(cvc[key] <= F32_CARD_VS_CPU, f"{key} logits on the card "
                f"differ from the CPU's by {cvc[key]:.3e} (tolerance "
                f"{F32_CARD_VS_CPU})")
    # The int8 card and CPU runs quantize f32 inputs that differ by f32
    # rounding; a code whose x / scale sits within that noise of a
    # half-integer rounds the other way. Such flips must start from f32
    # noise (the first flipped GEMM's inputs agree to F32_NOISE_REL and
    # its codes move by one), and the logits they move must stay inside
    # the int8 contract's own gap to f32.
    require(first is None or (first["x_rel_diff"] <= F32_NOISE_REL
                              and first["max_code_diff"] == 1),
            f"first card-vs-CPU code flip is not a rounding tie: {first}")
    gap = readings["int8_vs_f32_card"]["max_abs"]
    require(cvc["int8_decode"] <= gap, f"int8 logits on the card differ "
            f"from the CPU's by {cvc['int8_decode']:.3e}, more than int8 "
            f"differs from f32 ({gap:.3e})")
    breakdown = {
        name: decode_breakdown(engines[name, "cuda"], params[name, "cuda"],
                               tokens.cuda(), torch.ones(
                                   SLOTS, dtype=torch.bool, device="cuda"),
                               prompts)
        for name in ("f32", "int8")}
    return readings, breakdown


def device_kernels_averaged(prof):
    """`device_kernels` through `prof.key_averages()`, which first builds
    the tree of every CPU op (1-3 s a profiled train step with the CPU
    activity on the card's host)."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0
            and getattr(e, "device_type", None) == DeviceType.CUDA]


def profile_tally(prof):
    """(`device_kernels` rows, host CUDA API calls) of a profile, read
    from the profiler's raw events as `key_averages()` would sum them:
    a device event's time is its span (0 when asynchronous), events group
    by name, device type and the user-annotation flag, and the sums run
    in start order; a host CUDA API call is any event named cuda*."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    result = prof.profiler.kineto_results
    start = result.trace_start_ns()
    device, calls = [], 0
    for e in result.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        name = _rewrite_name(name=name, with_wildcard=True)
        calls += name.startswith("cuda")
        if e.device_type() == DeviceType.CUDA:
            t0, t1 = (e.start_ns() - start) / 1000, (e.end_ns() - start) / 1000
            asynchronous = e.is_async() or (e.start_thread_id()
                                            != e.end_thread_id())
            device.append((t0, -t1, name, e.is_user_annotation(),
                           0.0 if asynchronous else t1 - t0))
    groups = {}
    for _, _, name, note, us in sorted(device, key=lambda d: d[:2]):
        g = groups.setdefault((name, note), [0.0, 0])
        g[0] += us
        g[1] += 1
    return [(t, n, name) for (name, _), (t, n) in groups.items()
            if t > 0], calls


# Profile kinds (with the CPU activity or not) whose tally has been held
# against key_averages() in this run.
TALLY_CHECKED = set()


def device_kernels(prof):
    """(device us, launches, name) of every device kernel a profile
    holds. Device-side entries only: a CPU op's own entry repeats the
    device time of the kernels it launched. The first profile of each
    kind in a run is also read through key_averages(), and the two must
    agree."""
    from torch.profiler import ProfilerActivity

    rows, calls = profile_tally(prof)
    kind = ProfilerActivity.CPU in prof.activities
    if kind not in TALLY_CHECKED:
        TALLY_CHECKED.add(kind)
        want = sorted(device_kernels_averaged(prof), key=lambda r: r[2])
        got = sorted(rows, key=lambda r: r[2])
        want_calls = sum(e.count for e in prof.key_averages()
                         if e.key.startswith("cuda"))
        require(calls == want_calls and len(got) == len(want) and all(
            a[1:] == b[1:] and abs(a[0] - b[0]) <= 1e-9 * abs(b[0])
            for a, b in zip(got, want)),
            f"the profile tally differs from key_averages(): "
            f"{len(got)} / {len(want)} kernels, busy "
            f"{sum(r[0] for r in got)} / {sum(r[0] for r in want)} us, "
            f"host CUDA calls {calls} / {want_calls}")
    return rows


def decode_breakdown(eng, p, tokens, active, prompts, steps=10):
    """Where one contiguous decode step's time goes at full width, all
    slots active (`timed_breakdown`)."""
    cache = eng.init_cache()
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        cache, _ = eng.prefill(p, cache, ids, length, slot)
    return timed_breakdown(
        lambda: eng.decode_step(p, cache, tokens, active), steps)


def timed_breakdown(step, steps=10):
    """Host wall time per `step()` (synchronized), device busy time per
    step and the int8 kernel's part of it (torch.profiler), and the
    number of device kernels per step."""
    from torch.profiler import ProfilerActivity, profile

    step()
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
    by_kernel = device_kernels(prof)
    busy = sum(t for t, _, _ in by_kernel)
    launches = sum(n for _, n, _ in by_kernel)
    kernel = sum(t for t, _, key in by_kernel if "int8_matmul_kernel" in key)
    busy_ms = busy / steps / 1e3
    top = [{"kernel": key[:80], "ms_per_step": t / steps / 1e3,
            "launches_per_step": n / steps}
           for t, n, key in sorted(by_kernel, reverse=True)[:8]]
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy else None,
            "int8_kernel_ms_per_step": kernel / steps / 1e3,
            "device_kernels_per_step": launches / steps,
            "top_device_kernels": top}


def small_model_matches_cpu(engine_cls, cfg_cls, init_params):
    """A small GPT on the card vs the port's CPU run (plain versions):
    prefill + 3 lockstep decode steps, f32 at 1e-4 and int8 at 5e-3."""
    cfg = cfg_cls(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                  ffn_dim=256, max_position=32, dropout_rate=0.0,
                  pad_token_id=0)
    host = init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 97, (n,), generator=g).numpy()
               for n in (3, 7, 5, 12)]
    worst = {}
    for mode, tol in (("f32", 1e-4), ("int8", 5e-3)):
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = engine_cls(cfg, num_slots=4, max_len=32, prefill_len=16,
                             compute_dtype=mode, device=dev)
            p = eng.place_params(host)
            cache = eng.init_cache()
            rows = []
            for slot, prompt in enumerate(prompts):
                ids, length = eng.pad_prompt(prompt)
                cache, nl = eng.prefill(p, cache, ids, length, slot)
                rows.append(nl.cpu())
            runs[dev] = (eng, p, cache, torch.stack(rows))
        err = float((runs["cuda"][3] - runs["cpu"][3]).abs().max())
        tokens = runs["cpu"][3].argmax(-1)
        active = torch.ones(4, dtype=torch.bool)
        for _ in range(3):
            out = {}
            for dev, (eng, p, cache, _) in runs.items():
                _, lg = eng.decode_step(p, cache, tokens.to(dev),
                                        active.to(dev))
                out[dev] = lg.cpu()
            err = max(err, float((out["cuda"] - out["cpu"]).abs().max()))
            tokens = out["cpu"].argmax(-1)
        require(err <= tol, f"small {mode} model: GPU vs CPU logits differ "
                            f"by {err:.3e} (tolerance {tol})")
        worst[mode] = err
    return worst


# ---------------------------------------------------------------------
# Flash attention (K1-K3) and LM training


F32_OPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# How each flash kernel is built (the kernels line's "design").
FLASH_DESIGN = {
    "flash_fwd": "bf16: mma.sync m16n8k16 (q fragments resident, p fed "
                 "back in registers); f32: FFMA on 4 x keys/8 register "
                 "tiles; cp.async 2-stage K/V ring",
    "flash_bwd_dq": "bf16: mma.sync m16n8k16 (q, dO fragments resident, "
                    "dS fed back in registers); f32: FFMA on 4 x keys/8 "
                    "register tiles; cp.async 2-stage K/V ring",
    "flash_bwd_dkv": "bf16: mma.sync m16n8k16, 16 keys a warp (K, V "
                     "fragments resident to Dh 64), S^T/dP^T in registers, "
                     "P^T and dS^T fed back as A operands of dV and dK; "
                     "f32: FFMA on 4-key x rows/8 register tiles; cp.async "
                     "2-stage q/dO ring with LSE/delta, heaviest key tiles "
                     "first",
}
INT8_DESIGN = ("a cluster of 2 (K <= 1024) or 8 blocks splits K for 64 "
               "columns x 8 rows (row absmax and int32 partial sums meet "
               "in distributed shared memory), 16-byte weight loads "
               "issued first, x quantized once per cluster, __dp4a")
FLASH_KERNELS = (  # wrapper, device kernel name, TPU kernel it replaces
    ("flash_fwd", "flash_fwd_kernel",
     "distributed_model_parallel_tpu/ops/pallas_attention.py:260"),
    ("flash_bwd_dq", "flash_bwd_dq_kernel",
     "distributed_model_parallel_tpu/ops/pallas_attention.py:420"),
    ("flash_bwd_dkv", "flash_bwd_dkv_kernel",
     "distributed_model_parallel_tpu/ops/pallas_attention.py:459"),
)
# (name, B, T, H, Dh, mask kind): the training path's shape (GPT-2-small
# width, batch 8, all-true key mask from pad_token_id=0, causal), a
# length that is a multiple of 8 but not of the tile, and a batch row
# whose keys are all masked.
FLASH_CASES = (
    ("path", 8, 1024, 12, 64, "all"),
    ("ragged_tile", 2, 1000, 12, 64, "random"),
    ("masked_row", 2, 256, 12, 64, "row"),
)
# Kernel vs plain version on the card, causal, same inputs. Both sum
# f32 products in another order; f32: rtol 1e-4, atol 2e-5 (the worst
# reading on one H100 was 2.9e-6, dk/dv). bf16: outputs are rounded to
# bf16 (2**-8 relative), and p / dS values an f32 ulp apart may round to
# neighbouring bf16 values before their products: rtol/atol 2e-2 (worst
# reading 7.8e-3, one bf16 ulp of a value near 2). LSE is f32 in both
# dtypes: 1e-5 (worst reading 2.4e-6).
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LM_BASE = [
    "--device", "cuda", "--vocab-size", "50257", "--dim", "768",
    "--heads", "12", "--ffn-dim", "3072", "--seq-len", "1024", "-b", "8",
]
LM_FLAGS = LM_BASE + ["--epochs", "1", "--steps-per-epoch", "4"]
LM_RUNS = (  # (name, layers, extra flags)
    ("f32", 12, ["--attention", "ulysses_flash", "--dtype", "float32"]),
    ("bf16", 12, ["--attention", "ulysses_flash", "--dtype", "bfloat16"]),
    ("ring_flash_f32", 2, ["--attention", "ring_flash",
                           "--dtype", "float32"]),
)
LM_STEPS, LM_VAL_BATCHES, LM_TOKENS = 4, 1, 8 * 1024
# One train step, f32, as max|d|/max|ref| over the loss and every
# compared gradient leaf. A small GPT on the card (kernels) against the
# CPU (plain versions) read 1.0e-7 (loss) and 7.1e-7 (worst leaf) on one
# H100; the full-width step with the kernels against the plain attention
# on the card read 0.0 (loss) and 1.3e-6 (worst attention projection
# gradient). Both bars are about ten times the worst reading: f32 sums in
# another order, nothing else differs.
SMALL_CARD_VS_CPU = 1e-5
FULL_KERNEL_VS_PLAIN = 1e-5


def flash_inputs(b, t, h, dh, kind, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, h, dh), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
    if kind == "random":
        mask = torch.rand((b, t), generator=g, device="cuda") > 0.2
        mask[:, 0] = True
    elif kind == "row":
        mask[1] = False
    return q, k, v, do, mask


def visible_pairs(mask, h) -> int:
    """Causal (q, k) pairs with a valid key, over batch and heads: the
    work this run's data needs."""
    t = mask.shape[1]
    tri = torch.ones((t, t), dtype=torch.bool, device=mask.device).tril()
    per_b = (tri[None] & mask[:, None, :]).sum()
    return int(per_b) * h


def flash_bound(kind, b, t, h, dh, dtype, pairs):
    """Least time of one launch: each input read once, each output
    written once, against its flops (4, 6 or 8 x Dh per visible pair)
    at the dtype's peak."""
    act = b * t * h * dh * (4 if dtype == torch.float32 else 2)
    stats, maskb = b * h * t * 4, b * t
    nbytes, per_pair = {
        "flash_fwd": (4 * act + maskb + stats, 4),
        "flash_bwd_dq": (5 * act + maskb + 2 * stats, 6),
        "flash_bwd_dkv": (6 * act + maskb + 2 * stats, 8),
    }[kind]
    ops = per_pair * dh * pairs
    peak = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def flash_case(fa, case, dtype, causal=True):
    """K1 (with and without LSE), K2 and K3 against their plain versions
    at one case, causal or not; returns the max errors per kernel and the
    tensors the timings reuse."""
    name, b, t, h, dh, kind = case
    q, k, v, do, mask = flash_inputs(b, t, h, dh, kind, dtype, seed=t + dh)
    kw = dict(scale=1.0 / math.sqrt(dh), causal=causal)
    out, lse = fa.flash_fwd(q, k, v, mask, need_lse=True, **kw)
    out_nolse, none = fa.flash_fwd(q, k, v, mask, **kw)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, mask, need_lse=True, **kw)
    delta = fa.flash_delta(do, ref_out)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, mask, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, mask, **kw)
    torch.cuda.synchronize()
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, mask, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                            mask, **kw)
    # K3 at every tile it is built for (the default's result is dk, dv)
    dkv_tiles = {tile: fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, mask,
                                        tile=tile, **kw)
                 for tile in fa.TILES["flash_bwd_dkv"][dh]}
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]

    def err(a, r):
        fin = torch.isfinite(r)
        require(bool((torch.isfinite(a) == fin).all())
                and bool((a[~fin] == r[~fin]).all()),
                f"{name} {dtype}: non-finite values differ from the plain "
                f"version's")
        return float((a.float() - r.float())[fin].abs().max())

    errs = {"flash_fwd": max(err(out, ref_out), err(out_nolse, ref_out)),
            "flash_fwd_lse": err(lse, ref_lse),
            "flash_bwd_dq": err(dq, ref_dq),
            "flash_bwd_dkv": max(err(dk, ref_dk), err(dv, ref_dv))}
    by_tile = {tile_key(tl): max(err(x, ref_dk), err(y, ref_dv))
               for tl, (x, y) in dkv_tiles.items()}
    errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], *by_tile.values())
    emit({"flash_check": name, "dtype": str(dtype).split(".")[-1],
          "shape": [b, t, h, dh], "max_abs_err": errs,
          "flash_bwd_dkv_by_tile": by_tile})
    require(none is None, "flash_fwd returned an LSE it was not asked for")
    pairs = [(out, ref_out), (out_nolse, ref_out), (dq, ref_dq),
             (dk, ref_dk), (dv, ref_dv)]
    for tk, tv in dkv_tiles.values():
        pairs += [(tk, ref_dk), (tv, ref_dv)]
    for got, want in pairs:
        torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    if kind == "row":
        require(bool((out[1] == 0).all()) and bool(torch.isinf(lse[1]).all())
                and bool((dq[1] == 0).all())
                and all(bool((x[1] == 0).all())
                        for pair in [(dk, dv), *dkv_tiles.values()]
                        for x in pair),
                "a row with no valid key must give out 0, LSE +inf and "
                "zero gradients")
    return errs, (q, k, v, do, mask, ref_lse, delta, kw)


def flash_timings(fa, dtype, tensors):
    """At one case's tensors (`flash_case`): per kernel the CUDA-event
    time per launch (host launch included), its device time (profiler),
    the plain version's time and the bound over the visible pairs (every
    valid key of every row when not causal); SDPA (forward; forward +
    backward; the backward's device time) as the library yardstick the
    port never calls; the sweep over every tile TILES lists at Dh 64."""
    import torch.nn.functional as F

    q, k, v, do, mask, lse, delta, kw = tensors
    b, t, h, dh = q.shape
    causal = kw["causal"]
    pairs = (visible_pairs(mask, h) if causal
             else int(mask.sum()) * t * h)
    calls = {
        "flash_fwd": lambda **x: fa.flash_fwd(q, k, v, mask, need_lse=True,
                                              **kw, **x),
        "flash_bwd_dq": lambda **x: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                    mask, **kw, **x),
        "flash_bwd_dkv": lambda **x: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta, mask, **kw, **x),
    }
    plains = {
        "flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, mask, need_lse=True,
                                                **kw),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      mask, **kw),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, mask, **kw),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
    fq, fk, fv = (x.clone().requires_grad_(True) for x in (q, k, v))
    am = None if causal else mask[:, None, None, :]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                              is_causal=causal)

    def sdpa_fwd_bwd():
        torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=am,
                                           is_causal=causal),
            (qg, kg, vg), dot)

    def flash_fwd_bwd():
        fa.flash_attention(fq, fk, fv, mask, causal=causal).backward(do)

    rows = {}
    for name, dev_key, _ in FLASH_KERNELS:
        bound_ms, bound_by, nbytes, ops = flash_bound(name, b, t, h, dh,
                                                      dtype, pairs)
        sweep = {tile_key(tile): device_ms(
            lambda: calls[name](tile=tile), [()], 10, dev_key)
            for tile in fa.TILES[name][dh]}
        rows[name] = {
            "ms": time_ms(calls[name], [()], 20),
            "device_ms": device_ms(calls[name], [()], 10, dev_key),
            "plain_ms": time_ms(plains[name], [()], 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": ops, "visible_pairs": pairs,
            "tile": tile_key(fa.DEFAULT_TILE[name][dtype][dh]),
            "tile_sweep_device_ms": sweep,
        }
    fwd_dev = device_ms(sdpa_fwd, [()], 10, None)
    both_dev = device_ms(sdpa_fwd_bwd, [()], 10, None)
    rows["flash_fwd"]["library_ms"] = time_ms(sdpa_fwd, [()], 20)
    rows["flash_fwd"]["library_device_ms"] = fwd_dev
    yard = {"sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, [()], 10),
            # SDPA's backward alone: dq, dk and dv together in one call
            "sdpa_bwd_device_ms": None if None in (fwd_dev, both_dev)
            else both_dev - fwd_dev,
            "flash_attention_fwd_bwd_ms": time_ms(flash_fwd_bwd, [()], 10)}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name]["library_ms"] = None  # no one PyTorch call computes it
        rows[name].update(yard)
    emit({"flash_timings": str(dtype).split(".")[-1], "shape": [b, t, h, dh],
          "causal": causal, **rows})
    return rows


def tile_key(tile) -> str:
    """"64x64" for a (rows, keys) tile, "64" for K3's."""
    return "x".join(map(str, tile)) if isinstance(tile, tuple) else str(tile)


def flash_phase(fa):
    errs, timings = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            e, tensors = flash_case(fa, case, dtype)
            for key, val in e.items():
                errs[key] = max(errs.get(key, 0.0), val)
            if case[0] == "path":
                timings[dtype] = flash_timings(fa, dtype, tensors)
            del tensors
    return errs, timings


def reset_counts(fa, qm) -> None:
    for name, _, _ in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    qm.int8_matmul.launches = 0


def counts(fa) -> dict:
    return {name: getattr(fa, name).launches for name, _, _ in FLASH_KERNELS}


def recorded_run(main, flags, cls):
    """`main(flags)`, its stdout captured, with `cls.train_step` timed
    (synchronized) and each step's loss recorded: (result, steps, the
    engine, state, batch and lr of the last step)."""
    steps, seen = [], {}
    train_step = cls.train_step

    def recorded(self, ts, *batch_lr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = train_step(self, ts, *batch_lr)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "loss": float(m["loss_sum"] / m["count"])})
        seen.update(engine=self, state=ts, batch=batch_lr[:-1],
                    lr=batch_lr[-1])
        return ts, m

    with patched(cls, "train_step", recorded), \
            contextlib.redirect_stdout(io.StringIO()):
        out = main(flags)
    return out, steps, seen


def lm_run(lm, engine_cls, fa, qm, name, layers, extra):
    """One training run through the port's LM CLI (`cli/lm.py` main);
    each train step is timed (synchronized) and its loss recorded."""
    directory = scratch_dir(f"lm_{name}")
    reset_counts(fa, qm)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, steps, seen = recorded_run(
        lm.main, LM_FLAGS + ["--layers", str(layers)] + extra + [
            "--checkpoint-dir", directory], engine_cls)
    peak = torch.cuda.max_memory_allocated() - base
    got = counts(fa)
    # its best-acc checkpoint, where one was saved, is not needed
    shutil.rmtree(directory, ignore_errors=True)
    want = {"flash_fwd": layers * (LM_STEPS + LM_VAL_BATCHES),
            "flash_bwd_dq": layers * LM_STEPS,
            "flash_bwd_dkv": layers * LM_STEPS}
    require(got == want, f"LM run {name}: kernel launches {got}, want {want}")
    require(qm.int8_matmul.launches == 0, f"LM run {name} launched int8")
    hist = out["history"][0]
    losses = [s["loss"] for s in steps] + [hist["train"]["loss"],
                                           hist["val"]["loss"]]
    require(len(steps) == LM_STEPS and all(map(math.isfinite, losses)),
            f"LM run {name}: {len(steps)} steps, losses {losses}")
    warm = steps[1:]
    ms = sum(s["ms"] for s in warm) / len(warm)
    row = {"lm_run": name, "layers": layers, "flags": extra,
           "launches": got, "step_ms": [s["ms"] for s in steps],
           "step_loss": [s["loss"] for s in steps],
           "ms_per_step": ms, "tokens_per_s": LM_TOKENS / ms * 1e3,
           "train_loss": hist["train"]["loss"],
           "val_loss": hist["val"]["loss"], "loss_floor": out["loss_floor"],
           "peak_above_start_bytes": peak}
    row.update(step_breakdown(seen, ms))
    emit(row)
    return row


def profiled_step(seen, cpu: bool = True):
    """`device_kernels` of one more train step of the engine, state,
    batch and lr a recorded run last saw, under torch.profiler. With
    `cpu=False` only the CUDA activity is recorded: the same kernels but
    NCCL's (on the card, PR 12), in a fraction of the seconds (a BERT_BASE
    step 1.9 against 3.5 s, a pipeline step at M 8 ~20 s with the CPU
    ops); for the world-1 paths whose all-reduce launches no kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        seen["engine"].train_step(seen["state"], *seen["batch"], seen["lr"])
        torch.cuda.synchronize()
    return device_kernels(prof)


def step_breakdown(seen, wall_ms):
    """One more train step under torch.profiler: device busy time, the
    idle share against the unprofiled step wall time, and each flash
    kernel's device ms within the step."""
    top = profiled_step(seen, cpu=False)
    busy = sum(t for t, _, _ in top)
    per_kernel = {dev_key: sum(t for t, _, key in top if dev_key in key)
                  for _, dev_key, _ in FLASH_KERNELS}
    busy_ms = busy / 1e3
    return {"device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "flash_kernel_device_ms": {k: v / 1e3
                                       for k, v in per_kernel.items()},
            "flash_share_of_busy": sum(per_kernel.values()) / busy
            if busy else None,
            "top_device_kernels": [
                {"kernel": key[:70], "ms": t / 1e3, "launches": n}
                for t, n, key in sorted(top, reverse=True)[:8]]}


def rel_diff(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def training_card_vs_cpu(fa, engine_cls, cfg_cls, init_params, optim, lm):
    """(a) A small GPT, same weights and batch: one train step's loss and
    every gradient leaf on the card (kernels) against the CPU (plain
    versions). (b) At full width on the card: the kernels against the
    plain attention swapped in, loss and the attention projections'
    gradients."""
    small = cfg_cls(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                    ffn_dim=256, max_position=64, dropout_rate=0.0,
                    pad_token_id=0)
    host = init_params(small, 0, device="cpu")
    ids = lm.synthetic_corpus(97, 4 * 64, seed=3).reshape(4, 64)
    res = {}
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh

    for dev in ("cuda", "cpu"):
        # the CPU engine without the LM CLI's NCCL group
        eng = engine_cls(small, optim.SGD(), attention="ulysses_flash",
                         device=dev,
                         mesh=Mesh(1, None) if dev == "cpu" else None)
        ts = eng.state_from_params(host)
        m, g = eng.grads(ts, *eng.shard_batch(ids))
        res[dev] = (m["loss_sum"] / m["count"],
                    dict(zip(leaf_names(g), optim.tree_leaves(g))))
    small_loss = rel_diff(res["cuda"][0].cpu(), res["cpu"][0])
    small_grads = {n: rel_diff(res["cuda"][1][n].cpu(), res["cpu"][1][n])
                   for n in res["cpu"][1]}

    full = cfg_cls(dropout_rate=0.0, pad_token_id=0)
    eng = engine_cls(full, optim.SGD(), attention="ulysses_flash",
                     device="cuda")
    ts = eng.state_from_params(init_params(full, 0, device="cuda"))
    ids = lm.synthetic_corpus(50257, LM_TOKENS, seed=0).reshape(8, 1024)
    batch = eng.shard_batch(ids)
    m_k, g_k = eng.grads(ts, *batch)
    with patched(fa, "flash_fwd", fa.flash_fwd_plain), \
            patched(fa, "flash_bwd_dq", fa.flash_bwd_dq_plain), \
            patched(fa, "flash_bwd_dkv", fa.flash_bwd_dkv_plain):
        m_p, g_p = eng.grads(ts, *batch)
    gk = dict(zip(leaf_names(g_k), optim.tree_leaves(g_k)))
    gp = dict(zip(leaf_names(g_p), optim.tree_leaves(g_p)))
    attn = [n for n in gp if "/attn/" in n]
    full_loss = rel_diff(m_k["loss_sum"] / m_k["count"],
                         m_p["loss_sum"] / m_p["count"])
    full_grads = {n: rel_diff(gk[n], gp[n]) for n in attn}
    readings = {
        "small_loss_rel": small_loss,
        "small_grad_rel_max": max(small_grads.values()),
        "small_grad_rel_worst_leaf": max(small_grads, key=small_grads.get),
        "full_loss_rel": full_loss,
        "full_attn_grad_rel_max": max(full_grads.values()),
        "full_attn_grad_rel_worst_leaf": max(full_grads, key=full_grads.get),
        "full_loss": float(m_k["loss_sum"] / m_k["count"]),
    }
    emit({"training_card_vs_cpu": readings})
    require(len(small_grads) == 27 and len(full_grads) == 48,
            f"compared {len(small_grads)} / {len(full_grads)} leaves")
    require(max(small_loss, readings["small_grad_rel_max"])
            <= SMALL_CARD_VS_CPU, f"small GPT train step on the card "
            f"differs from the CPU's: {readings}")
    require(max(full_loss, readings["full_attn_grad_rel_max"])
            <= FULL_KERNEL_VS_PLAIN, f"full-width step with the kernels "
            f"differs from the plain attention's: {readings}")
    return readings


def leaf_names(tree, prefix=""):
    """Leaf paths of a nested dict, in `tree_leaves` (sorted) order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def kernel_label(mangled: str) -> str:
    """flash_fwd_kernel<bf16,Dh=64,rows=64,keys=64> (K1/K2),
    flash_bwd_dkv_kernel<f32,Dh=64,keys=64,rows=64> (K3) or
    int8_matmul_kernel<V=4,S=2> (K4: V 4-byte words a weight load, S
    blocks a cluster) from a mangled entry name."""
    import re

    k = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I"
                  r"(f|13__nv_bfloat16)((?:Li\d+E)+)", mangled)
    if not k:
        i8 = re.search(r"int8_matmul_kernelILi(\d+)ELi(\d+)E", mangled)
        return (f"int8_matmul_kernel<V={i8.group(1)},S={i8.group(2)}>"
                if i8 else mangled)
    ints = re.findall(r"Li(\d+)E", k.group(3))
    names = (("Dh", "keys", "rows") if k.group(1) == "flash_bwd_dkv_kernel"
             else ("Dh", "rows", "keys"))
    dtype = "f32" if k.group(2) == "f" else "bf16"
    return (f"{k.group(1)}<{dtype},"
            + ",".join(f"{n}={v}" for n, v in zip(names, ints)) + ">")


def ptxas_summary(report: str):
    """(one line per kernel of a ptxas -v report: registers and spills;
    {kernel label: spill store bytes})."""
    import re

    name, out, spills = None, [], {}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"ptxas: {name}: {line.split(':', 1)[-1].strip()}")
            st = re.search(r"(\d+) bytes spill stores", line)
            if st:
                spills[name] = int(st.group(1))
    return out, spills


def flash_entry(name, replaces, lm_rows, errs, times):
    """A flash kernel's entry of the kernels line: launches over the LM
    training runs, the worst error against the plain version over every
    check, and the f32 times at the path shape (bf16 beside them)."""
    f32, bf16 = times[torch.float32][name], times[torch.bfloat16][name]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tile", "tile_sweep_device_ms")
    extra = ("library_device_ms", "sdpa_fwd_bwd_ms", "sdpa_bwd_device_ms",
             "flash_attention_fwd_bwd_ms")
    return {
        "name": name,
        "route": "cuda",
        "source": "distributed_model_parallel_tpu_torch/csrc/"
                  "flash_attention.cu",
        "replaces": replaces,
        "design": FLASH_DESIGN[name],
        "launches": sum(r["launches"][name] for r in lm_rows),
        "launches_by_run": {r["lm_run"]: r["launches"][name]
                            for r in lm_rows},
        "max_abs_err": max(errs[name], errs["flash_fwd_lse"])
        if name == "flash_fwd" else errs[name],
        # One launch at the path shape (B 8, T 1024, H 12, Dh 64, causal,
        # all-true key mask), f32; "bf16" holds the same in bf16.
        **{k: f32[k] for k in keys + extra if k in f32},
        "bf16": {k: bf16[k] for k in keys + extra if k in bf16},
    }


DP_STEPS = 16
DP_TIMED_FROM = 5  # steps 6-16 are timed
DP_BATCH = 512
DP_FLAGS = [
    "--device", "cuda", "--model", "mobilenetv2", "--dataset-type",
    "SyntheticTextures", "-b", str(DP_BATCH), "--val-batch-size", "1000",
    "--lr", "0.4", "-j", "8", "--epochs", "1",
    "--steps-per-epoch", str(DP_STEPS),
]
DP_RUNS = (  # (name, extra flags)
    ("ddp_f32", ["--engine", "ddp"]),
    ("ddp_bf16", ["--engine", "ddp", "--dtype", "bfloat16"]),
    ("gspmd_f32", ["--engine", "gspmd"]),
)
# One tinycnn DDP step, card against CPU, f32 with TF32 off: rtol 1e-5
# (the repo's f32 bar; cuDNN and the CPU sum in another order).
DP_CARD_VS_CPU = 1e-5


def kernel_family(name: str) -> str:
    """A device kernel's name without its template and argument lists."""
    import re

    return re.sub(r"^void\s+", "", name).split("<")[0].split("(")[0]


def dp_breakdown(seen, wall_ms):
    """One more train step under torch.profiler: device busy ms, the idle
    share against the synchronized step wall, kernels a step and the top
    five kernel families by device time."""
    kernels = profiled_step(seen, cpu=False)
    busy_ms = sum(t for t, _, _ in kernels) / 1e3
    families = {}
    for t, n, name in kernels:
        fam = families.setdefault(kernel_family(name), [0.0, 0])
        fam[0] += t / 1e3
        fam[1] += n
    top = sorted(families.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernels_per_step": sum(n for _, n, _ in kernels),
            "top_kernel_families": [
                {"family": f[:80], "ms": ms, "launches": n}
                for f, (ms, n) in top]}


def dp_run(dp_cli, dp_mod, native, name, extra):
    """One run of the DP CLI; each train step is timed (synchronized),
    each native augment call timed on the host."""
    import torch.distributed as dist

    augment_ms = []
    augment = native.augment_normalize

    def timed_augment(*args, **kw):
        t0 = time.perf_counter()
        out = augment(*args, **kw)
        augment_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    torch.cuda.reset_peak_memory_stats()
    with patched(native, "augment_normalize", timed_augment):
        out, steps, seen = recorded_run(
            dp_cli.main, DP_FLAGS + extra + [
                "--checkpoint-dir", scratch_dir(f"dp_{name}")],
            dp_mod._DataParallel)
    peak = torch.cuda.max_memory_allocated()
    backend, world = dist.get_backend(), dist.get_world_size()
    grad_reductions = seen["engine"].grad_reductions
    hist = out["history"][0]
    losses = [s["loss"] for s in steps]
    require(len(steps) == DP_STEPS and all(map(math.isfinite, losses))
            and math.isfinite(hist["val"]["loss"]),
            f"DP run {name}: {len(steps)} steps, losses {losses}")
    half = DP_STEPS // 2
    require(sum(losses[-half:]) < sum(losses[:half]),
            f"DP run {name}: the train loss did not fall: {losses}")
    require(backend == "nccl" and world == 1,
            f"DP run {name}: process group {backend} at world {world}, "
            "want nccl at 1")
    require(grad_reductions == DP_STEPS,
            f"DP run {name}: {grad_reductions} gradient all-reduces in "
            f"{DP_STEPS} steps")
    require(native.available() and len(augment_ms) >= DP_STEPS,
            f"DP run {name}: the native augment made {len(augment_ms)} "
            f"batches for {DP_STEPS} steps")
    timed = steps[DP_TIMED_FROM:]
    ms = sum(s["ms"] for s in timed) / len(timed)
    row = {"dp_run": name, "flags": extra, "ms_per_step": ms,
           "images_per_s": DP_BATCH / ms * 1e3,
           "trainer_batch_time_ms": hist["train"]["batch_time"] * 1e3,
           "trainer_data_wait_ms": hist["train"]["data_time"] * 1e3,
           "native_augment_ms_per_batch":
               sum(augment_ms) / len(augment_ms),
           "native_augment_batches": len(augment_ms),
           "step_ms": [s["ms"] for s in steps],
           "first_train_loss": losses[0], "last_train_loss": losses[-1],
           "epoch_train_loss": hist["train"]["loss"],
           "val_loss": hist["val"]["loss"], "val_acc1": hist["val"]["acc1"],
           "max_memory_allocated_gib": peak / 2 ** 30,
           "backend": backend, "grad_allreduces": grad_reductions}
    row.update(dp_breakdown(seen, ms))
    emit(row)
    return row


def dp_card_vs_cpu():
    """One tinycnn DDP step (per-replica BN, 16 images of 8x8) on the
    card, world 1 on NCCL, against the same step on the CPU with no
    process group: loss and every parameter leaf."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_leaves,
    )

    rng = np.random.RandomState(0)
    images = rng.randn(16, 8, 8, 3).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    res = {}
    for dev, mesh in (("cuda", None), ("cpu", Mesh(1, None))):
        eng = DDPEngine(tiny_cnn(10), SGD(), mesh=mesh, device=dev)
        ts, m = eng.train_step(eng.init_state(0),
                               *eng.shard_batch(images, labels), 0.1)
        res[dev] = (m["loss_sum"] / m["count"],
                    dict(zip(leaf_names(ts.params),
                             tree_leaves(ts.params))))
    loss = rel_diff(res["cuda"][0].cpu(), res["cpu"][0])
    params = {n: rel_diff(res["cuda"][1][n].detach().cpu(),
                          res["cpu"][1][n].detach())
              for n in res["cpu"][1]}
    readings = {"loss_rel": loss, "param_rel_max": max(params.values()),
                "param_rel_worst_leaf": max(params, key=params.get),
                "leaves": len(params)}
    emit({"dp_card_vs_cpu": readings})
    require(max(loss, readings["param_rel_max"]) <= DP_CARD_VS_CPU,
            f"tinycnn DDP step on the card differs from the CPU's: "
            f"{readings}")
    return readings


def dp_conv_shapes():
    """(input NCHW shape, weight shape, stride, padding, groups) of every
    convolution of MobileNetV2 at batch DP_BATCH, read off one CPU
    forward at batch 1. Every one of them feeds a BN layer."""
    import torch.nn.functional as F

    from distributed_model_parallel_tpu_torch.models import layers as L
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        mobilenet_v2,
    )

    shapes, conv = [], F.conv2d

    def recording(x, w, stride=1, padding=0, groups=1):
        shapes.append(((DP_BATCH, *x.shape[1:]), tuple(w.shape), stride,
                       padding, groups))
        return conv(x, w, stride=stride, padding=padding, groups=groups)

    model = mobilenet_v2(10)
    params, state = model.init(torch.Generator())
    with patched(F, "conv2d", recording), torch.no_grad():
        model.apply(params, state, torch.zeros(1, 32, 32, 3), L.Context())
    return shapes


def dp_layer_times(dtype, iters=3):
    """Forward + backward device ms a step of MobileNetV2's layer kinds
    at batch DP_BATCH, each layer alone on channels-last tensors with a
    ones cotangent (torch.profiler device time of the kernels, summed
    over the model's layers; host gaps between launches are not
    counted): the depthwise 3x3 convs, the other convs, the port's BN
    (the reference's arithmetic), and cuDNN's fused BN (`F.batch_norm`,
    a yardstick the port never calls: Welford statistics, not the
    reference's E[x²] - E[x]²)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from distributed_model_parallel_tpu_torch.models import layers as L

    def timed(calls):
        for fn, args in calls:
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for fn, args in calls:
                    fn(*args)
            torch.cuda.synchronize()
        return sum(t for t, _, _ in device_kernels(prof)) / iters / 1e3

    def leaf(shape, leaf_dtype):
        t = torch.randn(shape, device="cuda").to(leaf_dtype)
        return t.contiguous(memory_format=torch.channels_last
                            ).requires_grad_(True)

    def conv_step(x, w, stride, padding, groups):
        y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding,
                     groups=groups)
        y.backward(torch.ones_like(y))

    def port_bn_step(x, p, s):
        y, _ = L.batchnorm2d(x.shape[1]).apply(p, s, x, L.Context(train=True))
        y.backward(torch.ones_like(y))

    def cudnn_bn_step(x, p, s):
        y = F.batch_norm(x, s["mean"].clone(), s["var"].clone(), p["scale"],
                         p["bias"], training=True)
        y.backward(torch.ones_like(y))

    calls = {"depthwise_conv_ms": [], "other_conv_ms": [],
             "bn_port_ms": [], "bn_cudnn_fused_ms": []}
    for in_shape, w_shape, stride, padding, groups in dp_conv_shapes():
        x, w = leaf(in_shape, dtype), leaf(w_shape, torch.float32)
        key = "depthwise_conv_ms" if groups > 1 else "other_conv_ms"
        calls[key].append((conv_step, (x, w, stride, padding, groups)))
        with torch.no_grad():
            y = F.conv2d(x, w.to(dtype), stride=stride, padding=padding,
                         groups=groups)
        c = y.shape[1]
        p = {"scale": torch.ones(c, device="cuda", requires_grad=True),
             "bias": torch.zeros(c, device="cuda", requires_grad=True)}
        st = {"mean": torch.zeros(c, device="cuda"),
              "var": torch.ones(c, device="cuda")}
        bn_args = (y.requires_grad_(True), p, st)
        calls["bn_port_ms"].append((port_bn_step, bn_args))
        calls["bn_cudnn_fused_ms"].append((cudnn_bn_step, bn_args))
    return {key: timed(kind) for key, kind in calls.items()}


def in_background(fn):
    """Start `fn()` on a thread; returns a function that waits for it and
    gives (its result, its seconds), or raises what it raised."""
    import threading

    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["value"] = fn()
        except BaseException as e:  # raised again in the caller
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"], box["s"]

    return result


def make_textures():
    """Phase 6's SyntheticTextures (50,000 train and 10,000 val images)."""
    from distributed_model_parallel_tpu_torch.data import datasets

    return datasets.DatasetCollection("SyntheticTextures").init()


def dp_phase(textures):
    """The data-parallel phase: the three DP CLI runs on one dataset made
    once (`textures` waits for it: it is made on a thread during the
    build), then the card-vs-CPU step."""
    from distributed_model_parallel_tpu_torch import native
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    t0 = time.perf_counter()
    data, made_s = textures()
    print(f"data-parallel: SyntheticTextures made in {made_s:.1f} s on a "
          f"thread during the build, waited {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    require(native.available(), "the native augment library did not build")
    rows = []
    with patched(datasets.DatasetCollection, "init", lambda self: data):
        for name, extra in DP_RUNS:
            rows.append(dp_run(data_parallel, dp_mod, native, name, extra))
    for dtype in (torch.float32, torch.bfloat16):
        emit({"dp_layer_times": str(dtype).split(".")[-1],
              **dp_layer_times(dtype)})
    dp_card_vs_cpu()
    torch.distributed.destroy_process_group()
    return rows, data


# ---------------------------------------------------------------------
# Checkpoint and resume (slice 6)

# Train steps an epoch of the phase-7 DP runs (60 until the pipeline
# phase was added, 12 until phase 14 was; cut in depth to keep the whole
# run near its earlier length).
CK_DP_STEPS = 8
CK_DP_FLAGS = DP_FLAGS[:DP_FLAGS.index("--epochs")] + [
    "--steps-per-epoch", str(CK_DP_STEPS)]
CK_LM_FLAGS = LM_BASE + ["--layers", str(LAYERS), "--attention",
                         "ulysses_flash", "--dtype", "float32",
                         "--steps-per-epoch", "2"]
CK_PROBE_STEPS = 12  # steps of each determinism probe run
CK_PROBE_TIMED_FROM = 3  # steps 4-12 are timed
# Kernel names a profiled DP step shows for its convolutions (cuDNN's
# and the CUTLASS-style sm90 kernels it dispatches to).
CONV_KERNEL_KEYS = ("conv", "wgrad", "dgrad", "fprop", "xmma", "implicit",
                    "cudnn", "sm90_")


@contextlib.contextmanager
def checkpoint_timing(records):
    """Time the Trainer's checkpoint I/O, synchronized: a save is the
    device-to-host copy of the state (`train_state_to_jax`) plus the
    file write (`save_checkpoint`); a restore is the file read
    (`restore_checkpoint`) plus the host-to-device copy
    (`train_state_from_jax`). Each record has the op, its ms and the
    npz bytes."""
    from distributed_model_parallel_tpu_torch.training import trainer

    def timed(name, op):
        fn = getattr(trainer, name)

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec = {"op": op, "part": name,
                   "ms": (time.perf_counter() - t0) * 1e3}
            if name == "save_checkpoint":
                rec["bytes"] = os.path.getsize(out)
            records.append(rec)
            return out
        return patched(trainer, name, run)

    with timed("train_state_to_jax", "save"), \
            timed("save_checkpoint", "save"), \
            timed("restore_checkpoint", "restore"), \
            timed("train_state_from_jax", "restore"):
        yield


def io_summary(records):
    """Checkpoint I/O ms by part (each entry one call: a state's
    device-to-host copy, one file's write, one file's read, the
    host-to-device copy) and the largest file written. A save is one
    copy and one write; an epoch that writes 'ckpt' and 'last' writes
    one copy twice."""
    out = {f"{part}_ms": [r["ms"] for r in records if r["part"] == part]
           for part in ("train_state_to_jax", "save_checkpoint",
                        "restore_checkpoint", "train_state_from_jax")}
    out["file_bytes"] = max((r["bytes"] for r in records if "bytes" in r),
                            default=None)
    return out


def epoch_numbers(history):
    """An epoch record without its timings."""
    return [{"epoch": h["epoch"], "best_acc": h["best_acc"],
             **{f"{part}_{k}": v for part in ("train", "val")
                for k, v in h[part].items() if not k.endswith("_time")}}
            for h in history]


def determinism_probe(data):
    """C.1 on the card: a MobileNetV2 DDP f32 step at batch 512, the same
    CK_PROBE_STEPS batches twice with cuDNN free to pick its algorithms
    and twice with `cudnn.deterministic` (the CLIs' setting): per-step
    losses, whether the runs' parameters are equal, synchronized ms a
    step (steps 2 on), and the convolution kernels of one profiled step
    in each mode; then one step under
    `torch.use_deterministic_algorithms(True, warn_only=True)`, whose
    warnings name any op with no deterministic implementation."""
    import warnings

    from distributed_model_parallel_tpu_torch.data.datasets import (
        CIFAR10_MEAN,
        CIFAR10_STD,
    )
    from distributed_model_parallel_tpu_torch.data.loader import Loader
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        mobilenet_v2,
    )
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_leaves,
    )

    loader = Loader(data[0], DP_BATCH, augment=True, mean=CIFAR10_MEAN,
                    std=CIFAR10_STD, workers=8)
    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == CK_PROBE_STEPS:
            break

    def run():
        eng = DDPEngine(mobilenet_v2(10), SGD(), device="cuda")
        ts = eng.init_state(0)
        losses, ms = [], []
        for images, labels in batches:
            placed = eng.shard_batch(images, labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = eng.train_step(ts, *placed, 0.04)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss_sum"] / m["count"]))
        params = [t.detach().clone() for t in tree_leaves(ts.params)]
        seen = {"engine": eng, "state": ts, "batch": placed, "lr": 0.04}
        kernels = profiled_step(seen)
        convs = sorted({kernel_family(name)[:90] for _, _, name in kernels
                        if any(k in name.lower()
                               for k in CONV_KERNEL_KEYS)})
        busy = sum(t for t, _, _ in kernels) / 1e3
        return losses, params, ms[CK_PROBE_TIMED_FROM:], (convs, busy), seen

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # In turns (free, deterministic, deterministic, free), so that host
    # noise spreads over both modes.
    runs = {False: [], True: []}
    try:
        for det in (False, True, True, False):
            torch.backends.cudnn.deterministic = det
            runs[det].append(run())
        modes = {}
        for det, ((l1, p1, ms1, (convs, busy1), _),
                  (l2, p2, ms2, (_, busy2), _)) in runs.items():
            modes["deterministic" if det else "free"] = {
                "losses": [l1, l2], "params_equal": same(p1, p2),
                "losses_equal": l1 == l2,
                "ms_per_step": sum(ms1 + ms2) / len(ms1 + ms2),
                "device_busy_ms": [busy1, busy2],
                "conv_kernels": convs}
        seen = runs[True][1][4]
        torch.backends.cudnn.deterministic = True
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                seen["engine"].train_step(seen["state"], *seen["batch"],
                                          seen["lr"])
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        torch.backends.cudnn.deterministic = True
    reading = {"steps": CK_PROBE_STEPS, **modes,
               "nondeterministic_op_warnings": sorted(
                   {str(w.message)[:200] for w in caught
                    if "deterministic" in str(w.message)})}
    emit({"c1_determinism_probe": reading})
    d = modes["deterministic"]
    require(d["losses_equal"] and d["params_equal"],
            f"DDP f32 with cudnn.deterministic is not deterministic: {d}")
    return reading


def checkpoint_dp_phase(dp_cli, dp_mod, data):
    """7(a): MobileNetV2 f32 through the DP CLI, two epochs of
    CK_DP_STEPS steps. `--engine ddp` straight twice and `--engine gspmd`
    straight once must give the same per-step losses (C.1: at world 1
    the engines compute the same step); one epoch then `--resume` to two
    must give the straight run's epoch-1 record and step losses."""
    from distributed_model_parallel_tpu_torch.data import datasets

    runs, io_records = {}, []
    data = s11_cut_val(data)
    plan = (("ddp_a", ["--engine", "ddp", "--epochs", "2"], "ddp_a"),
            ("ddp_b", ["--engine", "ddp", "--epochs", "2"], "ddp_b"),
            ("gspmd", ["--engine", "gspmd", "--epochs", "2"], "gspmd"),
            ("split_1", ["--engine", "ddp", "--epochs", "1"], "split"),
            ("split_2", ["--engine", "ddp", "--epochs", "2", "--resume"],
             "split"))
    with patched(datasets.DatasetCollection, "init", lambda self: data), \
            checkpoint_timing(io_records):
        for name, extra, directory in plan:
            out, steps, _ = recorded_run(
                dp_cli.main, CK_DP_FLAGS + extra + [
                    "--checkpoint-dir", scratch_dir(f"ck_dp_{directory}")],
                dp_mod._DataParallel)
            runs[name] = {"history": epoch_numbers(out["history"]),
                          "losses": [st["loss"] for st in steps],
                          "ms": [st["ms"] for st in steps]}
    torch.distributed.destroy_process_group()
    a, b, g = runs["ddp_a"], runs["ddp_b"], runs["gspmd"]
    split_losses = runs["split_1"]["losses"] + runs["split_2"]["losses"]
    reading = {
        "steps_per_epoch": CK_DP_STEPS,
        "ddp_twice_losses_equal": a["losses"] == b["losses"],
        "ddp_twice_epochs_equal": a["history"] == b["history"],
        "gspmd_vs_ddp_losses_equal": g["losses"] == a["losses"],
        "gspmd_vs_ddp_max_abs_loss_diff": max(
            abs(x - y) for x, y in zip(g["losses"], a["losses"])),
        "resume_losses_equal": split_losses == a["losses"],
        "resume_epoch1_equal": runs["split_2"]["history"]
        == a["history"][1:],
        "epochs": a["history"],
        "ddp_ms_per_step": sum(a["ms"][5:]) / len(a["ms"][5:]),
        "first_last_loss": [a["losses"][0], a["losses"][-1]],
        **io_summary(io_records),
    }
    emit({"dp_checkpoint_resume": reading})
    require(len(a["losses"]) == 2 * CK_DP_STEPS
            and len(split_losses) == 2 * CK_DP_STEPS,
            f"DP resume runs took {len(a['losses'])} / "
            f"{len(split_losses)} steps")
    require(reading["ddp_twice_losses_equal"]
            and reading["ddp_twice_epochs_equal"],
            "two ddp f32 runs with the same seeds differ (C.1)")
    require(reading["gspmd_vs_ddp_losses_equal"],
            "gspmd and ddp differ at world 1 (C.1): "
            f"{reading['gspmd_vs_ddp_max_abs_loss_diff']}")
    require(reading["resume_losses_equal"] and reading["resume_epoch1_equal"],
            "DP one epoch + --resume differs from two epochs straight")
    return reading


def checkpoint_lm_phase(lm, engine_cls, fa, qm):
    """7(b): the LM CLI at GPT-2-small width, `ulysses_flash` f32, two
    epochs of 2 steps straight against one epoch then `--resume` to two:
    equal per-step losses and epoch-1 record, and exact K1-K3 launches
    in each run. The runs also write `last` every epoch
    (`TrainerConfig.save_last`), so that they resume whatever the
    validation accuracy of a random-weight epoch. Returns (reading, the
    straight run's directory)."""
    import functools

    val_batches = LM_VAL_BATCHES
    runs, io_records, launches = {}, [], {}
    plan = (("straight", ["--epochs", "2"], "straight", 4, 2),
            ("split_1", ["--epochs", "1"], "split", 2, 1),
            ("split_2", ["--epochs", "2", "--resume"], "split", 2, 1))
    with checkpoint_timing(io_records), patched(
            lm, "TrainerConfig",
            functools.partial(lm.TrainerConfig, save_last=True)):
        for name, extra, directory, steps, epochs in plan:
            reset_counts(fa, qm)
            out, rec, _ = recorded_run(
                lm.main, CK_LM_FLAGS + extra + [
                    "--checkpoint-dir", scratch_dir(f"ck_lm_{directory}")],
                engine_cls)
            got = counts(fa)
            want = {"flash_fwd": LAYERS * (steps + val_batches * epochs),
                    "flash_bwd_dq": LAYERS * steps,
                    "flash_bwd_dkv": LAYERS * steps}
            require(got == want, f"LM resume run {name}: kernel launches "
                    f"{got}, want {want}")
            require(qm.int8_matmul.launches == 0,
                    f"LM resume run {name} launched int8")
            launches[name] = got
            runs[name] = {"history": epoch_numbers(out["history"]),
                          "losses": [st["loss"] for st in rec]}
    straight = runs["straight"]
    split_losses = runs["split_1"]["losses"] + runs["split_2"]["losses"]
    reading = {
        "losses": straight["losses"], "resumed_losses": split_losses,
        "resume_losses_equal": split_losses == straight["losses"],
        "resume_epoch1_equal": runs["split_2"]["history"]
        == straight["history"][1:],
        "epochs": straight["history"],
        "launches": launches, **io_summary(io_records),
    }
    emit({"lm_checkpoint_resume": reading})
    require(all(map(math.isfinite, straight["losses"]))
            and len(straight["losses"]) == 4,
            f"LM straight run losses {straight['losses']}")
    require(reading["resume_losses_equal"] and reading["resume_epoch1_equal"],
            "LM 2 + 2 steps across --resume differ from 4 straight")
    return reading, scratch_dir("ck_lm_straight")


def checkpoint_serve_phase(serve, engine_cls, cfg_cls, fa, qm, directory,
                           random_gap):
    """7(c): `serve --checkpoint` on 7(b)'s directory, f32 and int8 (K4
    48 times a decode step), then the first decode step's int8-vs-f32
    logits on those trained weights beside the random weights' gap."""
    outs, launches = {}, {}
    for mode in ("f32", "int8"):
        reset_counts(fa, qm)
        outs[mode] = serve_run(serve, SERVE_FLAGS + [
            "--compute-dtype", mode, "--checkpoint", directory])
        launches[mode] = qm.int8_matmul.launches
        require(not any(counts(fa).values()),
                "serving a checkpoint launched flash kernels")
    steps = outs["int8"]["serving"]["decode_steps"]
    require(launches["f32"] == 0 and steps > 0
            and launches["int8"] == 4 * LAYERS * steps,
            f"serve --checkpoint int8 launched the kernel "
            f"{launches['int8']} times over {steps} decode steps")
    for mode, out in outs.items():
        s = out["serving"]
        require(s["checkpoint"] == directory and s["requests"] == 16
                and s["generated_tokens"] == 16 * 32,
                f"serve --checkpoint {mode}: {s['requests']} requests, "
                f"{s['generated_tokens']} tokens")
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    cfg = cfg_cls(vocab_size=50257, dim=768, num_layers=LAYERS,
                  num_heads=12, ffn_dim=3072, max_position=1024,
                  dropout_rate=0.0, pad_token_id=0)
    prompts = [r.prompt for r in serve.synthetic_trace(args)[:SLOTS]]
    with contextlib.redirect_stdout(io.StringIO()):
        host = serve.load_checkpoint_params(
            directory, serve.newest_checkpoint_name(directory), cfg, 0,
            "cuda")
    kw = dict(num_slots=SLOTS, max_len=1024, prefill_len=128)
    engines = {mode: engine_cls(cfg, compute_dtype=mode, device="cuda", **kw)
               for mode in ("f32", "int8")}
    params = {mode: eng.place_params(host) for mode, eng in engines.items()}
    pre, _ = first_step(engines["f32"], params["f32"], prompts,
                        torch.zeros(SLOTS, dtype=torch.int64))
    tokens = pre.argmax(-1)
    f32 = first_step(engines["f32"], params["f32"], prompts, tokens)[1]
    i8 = first_step(engines["int8"], params["int8"], prompts, tokens)[1]
    pairs = [(x, y) for ra, rb in zip(outs["f32"]["requests"],
                                      outs["int8"]["requests"])
             for x, y in zip(ra["tokens"], rb["tokens"])]
    reading = {"int8_launches": launches["int8"], "decode_steps": steps,
               "launches_per_step": launches["int8"] / steps,
               "int8_vs_f32_trained": int8_vs_f32(i8, f32),
               "int8_vs_f32_random_weights_rel": random_gap,
               "greedy_token_agreement_int8_vs_f32":
                   sum(x == y for x, y in pairs) / len(pairs),
               "tokens_per_s": {m: o["serving"]["tokens_per_s"]
                                for m, o in outs.items()}}
    emit({"serve_checkpoint": reading})
    require(bool(torch.isfinite(i8).all()) and bool(torch.isfinite(f32).all())
            and reading["int8_vs_f32_trained"]["rel"] <= INT8_LOGIT_REL,
            f"int8 first-step logits on trained weights: "
            f"{reading['int8_vs_f32_trained']}")
    return reading


# ---------------------------------------------------------------------
# Pipeline model parallelism (slice 7)

# 30 before phase 10 (slice 9) was added, 12 before phase 11 (slice 10)
PP_STEPS = 6
PP_TIMED_FROM = 2  # steps 3-6 are timed
PP_VAL_IMAGES = 512  # of phase 6's 10,000 (1 batch; 1,024 until phase 14)
PP_FLAGS = [
    "./data", "--device", "cuda", "--model", "mobilenetv2", "-type",
    "SyntheticTextures", "-b", str(DP_BATCH), "--lr", "0.4", "-j", "8",
    "--epochs", "1", "--steps-per-epoch", str(PP_STEPS), "--world-size", "4",
]
PP_REF = ["--reference-split", "--microbatches"]
PP_RUNS = (  # (name, extra flags)
    ("reference_m1_f32", PP_REF + ["1"]),
    ("gpipe_m8_f32", PP_REF + ["8"]),
    ("gpipe_m8_bf16", PP_REF + ["8", "--dtype", "bfloat16"]),
    ("1f1b_m8_f32", PP_REF + ["8", "--pipeline-schedule", "1f1b"]),
    ("1f1b_m8_bf16", PP_REF + ["8", "--pipeline-schedule", "1f1b",
                               "--dtype", "bfloat16"]),
    ("interleaved_v2_m8_f32", ["--microbatches", "8", "--pipeline-schedule",
                               "interleaved", "--virtual-stages", "2"]),
)
# One f32 step from the same weights and batch, as max|d|/max|ref| over
# every parameter and BN buffer: 1f1b and interleaved against gpipe, the
# M = 1 pipeline against the DP engine, the card against the CPU. The
# repo's f32 bar; only the order of the sums over microbatches (or
# cuDNN's against the CPU's) differs.
PP_STEP_REL = 1e-5
PP_LM_FLAGS = LM_BASE + [
    "--layers", str(LAYERS), "--epochs", "1", "--steps-per-epoch",
    str(LM_STEPS), "--pipeline-stages", "4", "--microbatches", "4"]
PP_LM_RUNS = (  # (name, extra flags)
    ("gpipe_f32", ["--dtype", "float32"]),
    ("1f1b_bf16", ["--pipeline-schedule", "1f1b", "--dtype", "bfloat16"]),
)


def pp_run(mp_cli, pp_mod, name, extra):
    """One run of the pipeline CLI (`cli/model_parallel.py` main) from
    its own directory (its log and best-val-acc checkpoint go there);
    each train step timed (synchronized)."""
    import torch.distributed as dist

    directory = scratch_dir(f"pp_{name}")
    os.makedirs(directory)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.chdir(directory):
        out, steps, seen = recorded_run(mp_cli.main, PP_FLAGS + extra,
                                        pp_mod.PipelineEngine)
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"][0]
    losses = [st["loss"] for st in steps]
    require(len(steps) == PP_STEPS and all(map(math.isfinite, losses))
            and math.isfinite(hist["val"]["loss"]),
            f"pipeline run {name}: {len(steps)} steps, losses {losses}")
    half = PP_STEPS // 2
    require(sum(losses[-half:]) < sum(losses[:half]),
            f"pipeline run {name}: the train loss did not fall: {losses}")
    eng = seen["engine"]
    require(dist.get_backend() == "nccl" and eng.grad_reductions > 0
            and all(d.type == "cuda" for d in eng.devices),
            f"pipeline run {name}: {dist.get_backend()}, devices "
            f"{eng.devices}")
    timed = steps[PP_TIMED_FROM:]
    ms = sum(st["ms"] for st in timed) / len(timed)
    row = {"pp_run": name, "flags": extra, "ms_per_step": ms,
           "images_per_s": DP_BATCH / ms * 1e3,
           "step_ms": [st["ms"] for st in steps], "step_loss": losses,
           "first_train_loss": losses[0], "last_train_loss": losses[-1],
           "val_loss": hist["val"]["loss"], "val_acc1": hist["val"]["acc1"],
           "max_memory_allocated_gib": peak / 2 ** 30,
           "peak_above_start_gib": (peak - base) / 2 ** 30,
           "devices": sorted({str(d) for d in eng.devices}),
           "chunks": eng.num_chunks, "microbatches": eng.num_microbatches}
    row.update(dp_breakdown(seen, ms))
    emit(row)
    return row


def pp_compare(got, want) -> dict:
    """max|d|/max|ref| over every parameter and BN buffer of two
    pipeline states (per-chunk trees), the worst leaf, and whether each
    part is equal to the bit."""
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    out = {}
    for part in ("params", "model_state"):
        a = list(tree_leaves(getattr(got, part)))
        b = list(tree_leaves(getattr(want, part)))
        rels = [rel_diff(x.detach(), y.detach()) for x, y in zip(a, b)]
        out[part] = {"max_rel": max(rels), "worst_leaf": rels.index(
            max(rels)), "bit_equal": all(torch.equal(x, y)
                                         for x, y in zip(a, b))}
    return out


def pp_step_checks():
    """One f32 step of MobileNetV2 at batch 512 on the card from the same
    weights (seed 0) and batch: 1f1b against gpipe (reference split, M =
    8), interleaved (S = 4, V = 2) against gpipe over the same 8 chunks
    (S = 8), and the M = 1 pipeline against the DataParallelEngine at
    world 1 (the reference's MP and DP computing the same update)."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models import mobilenetv2
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
        TrainState,
    )
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        PipelineEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    cuda = torch.device("cuda")
    rng = np.random.RandomState(0)
    images = rng.randn(DP_BATCH, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, DP_BATCH)

    def step(chunks, stages, m, schedule="gpipe", v=1):
        split = ([3, 9, 15] if chunks == 4 else None)
        eng = PipelineEngine(
            mobilenetv2.split_stages(chunks, 10, boundaries=split), SGD(),
            Mesh(1, None, stages, (cuda,)), num_microbatches=m,
            schedule=schedule, virtual_stages=v)
        ts, _ = eng.train_step(eng.init_state(0),
                               *eng.shard_batch(images, labels), 0.4)
        return ts

    gpipe = step(4, 4, 8)
    reading = {"1f1b_vs_gpipe": pp_compare(step(4, 4, 8, "1f1b"), gpipe)}
    del gpipe
    reading["interleaved_vs_gpipe"] = pp_compare(
        step(8, 4, 8, "interleaved", 2), step(8, 8, 8))
    dp = DataParallelEngine(mobilenetv2.mobilenet_v2(10), SGD(),
                            mesh=Mesh(1, None), device=cuda)
    dts, _ = dp.train_step(dp.init_state(0),
                           *dp.shard_batch(images, labels), 0.4)
    split = dict(boundaries=[3, 9, 15])
    as_chunks = TrainState(
        tuple(mobilenetv2.partition_pytree(dts.params, 4, **split)),
        tuple(mobilenetv2.partition_pytree(dts.model_state, 4, **split)),
        None, 1)
    reading["m1_vs_data_parallel"] = pp_compare(step(4, 4, 1), as_chunks)
    emit({"pp_step_checks": reading})
    for name, r in reading.items():
        worst = max(r["params"]["max_rel"], r["model_state"]["max_rel"])
        require(worst <= PP_STEP_REL,
                f"pipeline step check {name}: {worst} > {PP_STEP_REL}: {r}")
    return reading


def pp_card_vs_cpu():
    """One tinycnn pipeline step (S = 2, M = 2, gpipe and 1f1b, 16 images
    of 8x8) on the card against the same step on the CPU: the loss and
    every parameter and BN buffer."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models.tinycnn import (
        split_stages,
    )
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        PipelineEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_map,
    )

    rng = np.random.RandomState(0)
    images = rng.randn(16, 8, 8, 3).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    readings = {}
    for schedule in ("gpipe", "1f1b"):
        res = {}
        for dev in ("cuda", "cpu"):
            eng = PipelineEngine(split_stages(2, 10), SGD(),
                                 Mesh(1, None, 2, (torch.device(dev),)),
                                 num_microbatches=2, schedule=schedule)
            ts, m = eng.train_step(eng.init_state(0),
                                   *eng.shard_batch(images, labels), 0.1)
            res[dev] = ts, (m["loss_sum"] / m["count"]).cpu()
        card = res["cuda"][0]
        cmp = pp_compare(card._replace(
            params=tree_map(lambda t: t.detach().cpu(), card.params),
            model_state=tree_map(lambda t: t.cpu(), card.model_state)),
            res["cpu"][0])
        readings[schedule] = {"loss_rel": rel_diff(res["cuda"][1],
                                                   res["cpu"][1]), **cmp}
    emit({"pp_card_vs_cpu": readings})
    for schedule, r in readings.items():
        worst = max(r["loss_rel"], r["params"]["max_rel"],
                    r["model_state"]["max_rel"])
        require(worst <= PP_STEP_REL,
                f"tinycnn pipeline ({schedule}) on the card differs from "
                f"the CPU's: {r}")
    return readings


def pp_lm_run(lm, fa, qm, name, extra):
    """One LM CLI run with `--pipeline-stages 4 --microbatches 4` at
    GPT-2-small width: ms a step, tokens/s, peak memory, per-step loss;
    no flash kernel may launch (the stages attend dense, as in JAX)."""
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        LMPipelineEngine,
    )

    reset_counts(fa, qm)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, steps, seen = recorded_run(
        lm.main, PP_LM_FLAGS + extra + [
            "--checkpoint-dir", scratch_dir(f"pp_lm_{name}")],
        LMPipelineEngine)
    peak = torch.cuda.max_memory_allocated()
    got = counts(fa)
    require(not any(got.values()) and qm.int8_matmul.launches == 0,
            f"pipeline LM run {name} launched {got}, int8 "
            f"{qm.int8_matmul.launches}")
    hist = out["history"][0]
    losses = [st["loss"] for st in steps]
    require(len(steps) == LM_STEPS and all(map(math.isfinite, losses))
            and math.isfinite(hist["val"]["loss"]),
            f"pipeline LM run {name}: {len(steps)} steps, losses {losses}")
    warm = steps[1:]
    ms = sum(st["ms"] for st in warm) / len(warm)
    row = {"pp_lm_run": name, "flags": extra, "launches": got,
           "step_ms": [st["ms"] for st in steps], "step_loss": losses,
           "ms_per_step": ms, "tokens_per_s": LM_TOKENS / ms * 1e3,
           "train_loss": hist["train"]["loss"],
           "val_loss": hist["val"]["loss"],
           "max_memory_allocated_gib": peak / 2 ** 30,
           "peak_above_start_gib": (peak - base) / 2 ** 30}
    row.update(dp_breakdown(seen, ms))
    emit(row)
    return row


def pipeline_phase(data, lm, fa, qm):
    """8: the pipeline CLI runs on one dataset made in phase 6, the step
    checks, the card-vs-CPU step and the LM pipeline runs; every flash
    and int8 launch of the phase is counted (slice 7's launches)."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.cli import model_parallel
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.parallel import (
        pipeline as pp_mod,
    )

    reset_counts(fa, qm)
    rows = {}
    val = data[1]
    data = (data[0], datasets.ArrayDataset(val.images[:PP_VAL_IMAGES],
                                           val.labels[:PP_VAL_IMAGES],
                                           val.num_classes))
    with patched(datasets.DatasetCollection, "init", lambda self: data):
        for name, extra in PP_RUNS:
            rows[name] = pp_run(model_parallel, pp_mod, name, extra)
    if dist.is_initialized():
        dist.destroy_process_group()
    gp, ob = rows["gpipe_m8_f32"], rows["1f1b_m8_f32"]
    emit({"pp_memory_m8_f32": {
        "gpipe_peak_gib": gp["max_memory_allocated_gib"],
        "1f1b_peak_gib": ob["max_memory_allocated_gib"],
        "gpipe_above_start_gib": gp["peak_above_start_gib"],
        "1f1b_above_start_gib": ob["peak_above_start_gib"]}})
    require(ob["peak_above_start_gib"] < gp["peak_above_start_gib"],
            "1f1b's peak memory is not below gpipe's at M = 8")
    # The f32 runs' per-step losses side by side: 1f1b and interleaved
    # sum the microbatch gradients in one order, gpipe (autograd) in
    # another; where they part, and by how much at each step after.
    il = rows["interleaved_v2_m8_f32"]["step_loss"]
    parts = {}
    for name in ("1f1b_m8_f32", "interleaved_v2_m8_f32"):
        diffs = [abs(x - y) for x, y in zip(rows[name]["step_loss"],
                                            gp["step_loss"])]
        parts[name] = {"first_differing_step": next(
            (i + 1 for i, d in enumerate(diffs) if d), None),
            "abs_loss_diff_by_step": diffs}
    emit({"pp_trajectories_f32_vs_gpipe": parts,
          "interleaved_equals_1f1b": il == ob["step_loss"]})
    pp_step_checks()
    pp_card_vs_cpu()
    lm_rows = [pp_lm_run(lm, fa, qm, *run) for run in PP_LM_RUNS]
    launches = dict(counts(fa), int8_matmul=qm.int8_matmul.launches)
    require(not any(launches.values()),
            f"the pipeline phase launched a K1-K4 kernel: {launches}")
    return rows, lm_rows, launches


# ---------------------------------------------------------------------
# Serving features (slice 8): paged cache, chunked prefill, prefix cache,
# speculative decoding, bf16 decode

PAGED_FLAGS = ["--page-size", "16", "--prefill-chunk", "64"]
PREFIX_LEN = 96
# Ceiling on the first decode step's bf16-vs-f32 logit gap (max|bf16 -
# f32| / max|f32|) at full width, on the card and on the CPU. It is set
# from this script's CPU reading, as INT8_LOGIT_REL is from its int8
# readings: on one H100 the gap read 1.155e-2 on the CPU and 1.083e-2 on
# the card; the ceiling is the CPU reading rounded up.
BF16_LOGIT_REL = 1.2e-2


def serve_summary(out) -> dict:
    s = out["serving"]
    keys = ("tokens_per_s", "decode_p50_ms", "decode_p99_ms",
            "prefill_p50_ms", "ttft_p99_ms", "decode_steps",
            "engine_iterations", "mean_iter_occupancy", "generated_tokens")
    row = {k: s[k] for k in keys}
    for section in ("paged", "prefix_cache", "speculative"):
        if isinstance(s.get(section), dict):
            row[section] = s[section]
    return row


def by_rid(out) -> dict:
    return {r["rid"]: r["tokens"] for r in out["requests"]}


@contextlib.contextmanager
def paged_step_counts(engine_cls):
    """Count the paged decode and verify steps of the target (the engine
    with speculative_k) and of the draft (the one without), and the
    draft's depth."""
    seen = {"target_decode": 0, "verify": 0, "draft_decode": 0,
            "draft_layers": set()}
    decode, verify = engine_cls.paged_decode_step, \
        engine_cls.paged_verify_step

    def counted_decode(self, *args):
        if self.speculative_k:
            seen["target_decode"] += 1
        else:
            seen["draft_decode"] += 1
            seen["draft_layers"].add(self.cfg.num_layers)
        return decode(self, *args)

    def counted_verify(self, *args):
        seen["verify"] += 1
        return verify(self, *args)

    with patched(engine_cls, "paged_decode_step", counted_decode), \
            patched(engine_cls, "paged_verify_step", counted_verify):
        yield seen


def paged_decode_breakdown(eng, p, tokens, prompts, steps=10):
    """`timed_breakdown` of one paged decode step at full width, all
    slots active: monolithic paged prefill of `prompts`, pages for every
    position the timed steps write, then steps that each upload the
    positions, tokens and active mask, as the serving loop does."""
    import numpy as np

    host, cache = eng.new_host(), eng.init_cache()
    positions = np.zeros(eng.num_slots, np.int64)
    for slot, prompt in enumerate(prompts):
        host.ensure_pages(slot, len(prompt) + 2 * steps + 2)
        ids, length = eng.pad_prompt(prompt)
        cache, _ = eng.paged_prefill_step(p, cache, host.device_row(slot),
                                          ids, length)
        positions[slot] = length
    active = np.ones(eng.num_slots, bool)
    table = host.device_table()

    def step():
        eng.paged_decode_step(p, cache, table,
                              *eng.step_inputs(positions, tokens, active))
        positions[:] += 1

    return timed_breakdown(step, steps)


def prefix_requests(request_cls, vocab: int):
    """16 requests sharing a PREFIX_LEN-token prefix, each with its own
    16-32-token tail, 32 new tokens each (greedy)."""
    import numpy as np

    rng = np.random.RandomState(8)
    prefix = rng.randint(1, vocab, size=PREFIX_LEN)
    return [request_cls(i, np.concatenate(
        [prefix, rng.randint(1, vocab, size=int(rng.randint(16, 33)))]),
        max_new_tokens=32) for i in range(16)]


def serve_setup(serve, cfg_cls):
    """SERVE_FLAGS as (config, engine kwargs without the device, device,
    the first num_slots prompts of the trace)."""
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    cfg = cfg_cls(vocab_size=args.vocab_size, dim=args.dim,
                  num_layers=args.layers, num_heads=args.heads,
                  ffn_dim=args.ffn_dim, max_position=args.max_len,
                  dropout_rate=0.0, pad_token_id=0)
    kw = dict(num_slots=args.num_slots, max_len=args.max_len,
              prefill_len=args.prefill_len)
    prompts = [r.prompt for r in serve.synthetic_trace(args)]
    return cfg, kw, args.device, prompts[:args.num_slots]


def bf16_first_step_gap(serve, engine_cls, cfg_cls):
    """The first decode step at full width (SERVE_FLAGS' first 8 prompts,
    each slot fed its prompt's last token), f32 and bf16, on the card and
    on the CPU with the same weights: max|bf16 - f32| / max|f32|."""
    cfg, kw, device, prompts = serve_setup(serve, cfg_cls)
    tokens = torch.tensor([int(p[-1]) for p in prompts])
    host = None
    logits = {}
    for dev in (device, "cpu"):
        for mode in ("f32", "bf16"):
            eng = engine_cls(cfg, compute_dtype=mode, device=dev, **kw)
            if host is None:
                host = tree_to(eng.init_params(0), "cpu")
            logits[mode, dev] = first_step(eng, eng.place_params(host),
                                           prompts, tokens)[1]
    return {"card" if dev != "cpu" else dev:
            int8_vs_f32(logits["bf16", dev], logits["f32", dev])
            for dev in (device, "cpu")}


def verify_rows_vs_decode(engine_cls, cfg, kw, prompts, mode):
    """One verify step of every slot's (k+1)-token span against k+1
    paged decode steps feeding the same tokens from the same pool: the
    largest logit difference, whether the rows are bit-equal and pick the
    same argmax, and the smallest top-2 logit gap among the rows (how
    close an argmax flip is). Under f32, also each decode projection's
    f32 GEMM at M = slots x (k+1) against the same rows at M = slots."""
    import numpy as np

    eng = engine_cls(cfg, page_size=16, prefill_chunk=64, compute_dtype=mode,
                     speculative_k=SPEC_K, **kw)
    p = eng.init_params(0)
    host, cache = eng.new_host(), eng.init_cache()
    n = len(prompts)
    positions = np.array([len(x) for x in prompts], np.int64)
    for slot, prompt in enumerate(prompts):
        host.ensure_pages(slot, len(prompt) + SPEC_K + 1)
        ids, length = eng.pad_prompt(prompt)
        cache, _ = eng.paged_prefill_step(p, cache, host.device_row(slot),
                                          ids, length)
    span = np.stack([x[-SPEC_K - 1:] for x in prompts]).astype(np.int64)
    active = np.ones(n, bool)
    before = {k: v.clone() for k, v in cache.items()}
    table = host.device_table()
    _, vlog = eng.paged_verify_step(
        p, cache, table, *eng.step_inputs(positions, span, active))
    rows = [eng.paged_decode_step(
        p, before, table, *eng.step_inputs(positions + j, span[:, j],
                                           active))[1]
        for j in range(SPEC_K + 1)]
    dlog = torch.stack(rows, dim=1)
    top2 = dlog.topk(2, dim=-1).values
    reading = {"max_abs": float((vlog - dlog).abs().max()),
               "bit_equal": bool(torch.equal(vlog, dlog)),
               "argmax_equal": bool(torch.equal(vlog.argmax(-1),
                                                dlog.argmax(-1))),
               "min_top2_gap": float((top2[..., 0] - top2[..., 1]).min())}
    if mode == "f32":
        x = torch.randn((n * (SPEC_K + 1), cfg.ffn_dim), device=eng.device)
        gemms = {}
        for name, _, _ in DECODE_SHAPES:
            group, proj = name.split(".")
            w = p["blocks"]["0"][group][proj]["w"]
            k = w.shape[0]
            big, small = x[:, :k] @ w, x[:n, :k].contiguous() @ w
            gemms[name] = float((big[:n] - small).abs().max())
        reading["f32_gemm_rows_m40_vs_m8_max_abs"] = gemms
    return reading


def serving_features_phase(serve, engine_cls, cfg_cls, fa, qm, ckpt_dir,
                           contiguous_f32):
    """9: the slice-8 serving features at GPT-2-small width through
    `cli.serve` (and `ServingEngine.run` for the prefix cache), every K1-K4
    launch of the phase counted (slice 8's launches). `contiguous_f32`
    is phase 4's contiguous f32 run of the same flags; `ckpt_dir` a
    GPT-2-small-width checkpoint (phase 7's LM run)."""
    from distributed_model_parallel_tpu_torch.serving.scheduler import (
        Request,
    )

    reset_counts(fa, qm)
    rows = {}
    # (a) paged f32 against phase 4's contiguous f32 run.
    paged = serve_run(serve, SERVE_FLAGS + PAGED_FLAGS)
    require(by_rid(paged) == by_rid(contiguous_f32),
            "paged f32 tokens differ from the contiguous f32 run's")
    require(qm.int8_matmul.launches == 0, "the paged f32 run launched K4")
    rows["paged_f32"] = serve_summary(paged)
    rows["contiguous_f32"] = serve_summary(contiguous_f32)
    cfg, kw, device, prompts = serve_setup(serve, cfg_cls)
    kw["device"] = device
    tokens = [int(p[-1]) for p in prompts]
    ceng = engine_cls(cfg, **kw)
    cp = ceng.init_params(0)
    peng = engine_cls(cfg, page_size=16, prefill_chunk=64, **kw)
    pp = peng.place_params(cp)
    rows["decode_step_breakdown"] = {
        "contiguous_f32": decode_breakdown(
            ceng, cp, torch.tensor(tokens, device=device),
            torch.ones(len(prompts), dtype=torch.bool, device=device),
            prompts),
        "paged_f32": paged_decode_breakdown(peng, pp, tokens, prompts)}
    emit({"serve_paged": rows})

    # (b) prefix cache, through ServingEngine.run.
    prefix = {}
    for name, on in (("prefix_cache", True), ("no_prefix_cache", False)):
        eng = engine_cls(cfg, page_size=16, prefill_chunk=64,
                         prefix_cache=on, **kw)
        sched = eng.run(eng.place_params(cp),
                        prefix_requests(Request, cfg.vocab_size))
        prefix[name] = {"tokens": {f.rid: f.tokens for f in sched.finished},
                        "report": sched.latency_report()}
    on, off = prefix["prefix_cache"], prefix["no_prefix_cache"]
    require(on["tokens"] == off["tokens"] and len(on["tokens"]) == 16,
            "the prefix-cached run's tokens differ from the uncached run's")
    pc = on["report"]["prefix_cache"]
    reading = {"prefix_cache": pc,
               "shared_pages_reused": pc["tokens_reused"] // 16,
               "cow_copies": on["report"]["paged"]["cow_copies"],
               **{f"{name}_{k}": prefix[name]["report"][k]
                  for name in prefix for k in ("prefill_p50_ms",
                                               "ttft_p99_ms",
                                               "tokens_per_s")}}
    emit({"serve_prefix_cache": reading})
    require(pc["hits"] > 0, f"the prefix cache never hit: {pc}")

    # (c) speculative decoding, k = 4. First the verify step's rows
    # against decode steps (int8 must be bit-equal: K4's rows are exact
    # at any M), then through the CLI: the checkpoint as its own draft (the
    # full-accept path) and a fresh 2-layer draft (the rollback path),
    # each against a plain paged int8 run of the same target.
    rows_vs_decode = {mode: verify_rows_vs_decode(engine_cls, cfg, kw,
                                                  prompts, mode)
                      for mode in ("int8", "f32")}
    emit({"verify_rows_vs_decode_steps": rows_vs_decode})
    require(rows_vs_decode["int8"]["bit_equal"], "int8 verify rows differ "
            f"from decode steps: {rows_vs_decode['int8']}")
    # 8 requests a run of the pair (16 until phase 15 was added).
    spec_flags = PAGED_FLAGS + ["--compute-dtype", "int8",
                                "--num-requests", "8"]
    spec = {}
    for name, target, draft in (
            ("checkpoint_draft", ["--checkpoint", ckpt_dir],
             ["--speculative-draft", ckpt_dir]),
            ("fresh_2_layer_draft", [],
             ["--speculative-draft-layers", "2"])):
        plain = serve_run(serve, SERVE_FLAGS + spec_flags + target)
        before = qm.int8_matmul.launches
        with paged_step_counts(engine_cls) as seen:
            out = serve_run(serve, SERVE_FLAGS + spec_flags + target + [
                "--speculative-k", str(SPEC_K)] + draft)
        launches = qm.int8_matmul.launches - before
        layers = seen.pop("draft_layers")
        require(len(layers) == 1, f"draft depths {layers}")
        draft_layers = layers.pop()
        want = (4 * cfg.num_layers * (seen["target_decode"]
                                      + seen["verify"])
                + 4 * draft_layers * seen["draft_decode"])
        rep = out["serving"]["speculative"]
        spec[name] = {**serve_summary(out), "steps": seen,
                      "draft_layers": draft_layers, "k4_launches": launches,
                      "k4_launches_want": want,
                      "plain_paged_int8": serve_summary(plain),
                      "tokens_equal_plain": by_rid(out) == by_rid(plain)}
        require(by_rid(out) == by_rid(plain), f"speculative {name} tokens "
                "differ from the plain paged int8 run's")
        require(launches == want and seen["verify"] > 0,
                f"speculative {name}: K4 launched {launches} times, want "
                f"{want} ({seen}, draft layers {draft_layers})")
        if name == "checkpoint_draft":
            require(rep["accept_rate"] > 0.9,
                    f"checkpoint as its own draft accepts {rep}")
    emit({"serve_speculative_int8": spec})

    # (d) bf16, contiguous and paged, and the first-step gap to f32.
    bf16 = {}
    for name, extra in (("contiguous", []), ("paged", PAGED_FLAGS)):
        out = serve_run(serve, SERVE_FLAGS + extra + ["--compute-dtype",
                                                      "bf16"])
        got, ref = by_rid(out), by_rid(contiguous_f32)
        pairs = [(a, b) for rid in ref for a, b in zip(got[rid], ref[rid])]
        bf16[name] = {**serve_summary(out),
                      "greedy_token_agreement_bf16_vs_f32":
                          sum(a == b for a, b in pairs) / len(pairs)}
    gap = bf16_first_step_gap(serve, engine_cls, cfg_cls)
    bf16["first_step_bf16_vs_f32"] = gap
    emit({"serve_bf16": bf16})
    for dev, reading in gap.items():
        rel = reading["rel"]
        require(math.isfinite(rel) and rel <= BF16_LOGIT_REL,
                f"bf16 first-step logits on the {dev} off by {rel:.3e} of "
                f"max|logit| (ceiling {BF16_LOGIT_REL})")
    launches = dict(counts(fa), int8_matmul=qm.int8_matmul.launches)
    require(not any(counts(fa).values()),
            f"the serving-features phase launched K1-K3: {launches}")
    return launches


# ---------------------------------------------------------------------
# Slice 9: --remat, --steps-per-dispatch (CUDA graphs), --profile-dir,
# --metrics-out, and the ViT and BERT classifiers

# The default corpus gives 8 batches of 8 x 1024; 4 of them (8 until
# phase 15 was added).
S9_LM_STEPS = 4
S9_K = 4  # --steps-per-dispatch
S9_LM = LM_BASE + ["--layers", str(LAYERS), "--attention", "ulysses_flash",
                   "--epochs", "1", "--steps-per-epoch", str(S9_LM_STEPS)]
S9_OBS = ["--profile-dir", "prof", "--metrics-out", "m.prom"]
# Runs of the LM's k = S9_K dispatch at most, while its --profile-dir
# trace holds fewer K1-K3 records than the replays launched (the
# profiler drops records: two calls of this script on one H100 read 92
# of 96 and 47 of 48); the wrappers' counts are held exactly in every
# run. The tries of each dtype are printed, and the phase fails when
# both dtypes needed more than one: a fault of the replays that shows
# in every trace is not taken for a dropped record.
S9_TRACE_TRIES = 3
# bf16 per-step losses, remat against no remat: the bf16 bar of
# tests/test_torch_port_lm.py (5e-2) is for bf16 against f32; both runs
# here are bf16, so they are held at the f32 bar's neighbour, 1e-3, with
# bit-equality printed.
S9_REMAT_REL = {"float32": 1e-5, "bfloat16": 1e-3}
S9_VIT = DP_FLAGS[:DP_FLAGS.index("--lr")] + [
    "--model", "vit", "--optimizer", "adamw", "--lr", "1e-2", "--wd", "0.05",
    "-j", "8", "--epochs", "1", "--steps-per-epoch", str(DP_STEPS)]
S9_VIT_RUNS = (("vit_gspmd_f32", ["--engine", "gspmd"]),
               ("vit_ddp_f32", ["--engine", "ddp"]),
               ("vit_ddp_bf16", ["--engine", "ddp", "--dtype", "bfloat16"]))
# SyntheticText: 4,096 examples, 8 batches of 512 an epoch. BERT_BASE
# runs 2 epochs (16 steps, ~0.5 s each), bert_tiny 4 (32 steps: its loss
# leaves chance after ~10).
S9_BERT = [  # 2 epochs of 5 steps (of 8 until phase 15 was added)
    "--device", "cuda", "--model", "bert", "-type", "SyntheticText",
    "-b", str(DP_BATCH), "--val-batch-size", "1024", "--optimizer", "adamw",
    "--lr", "1e-3", "--epochs", "2", "--steps-per-epoch", "5"]
S9_BERT_TINY_PP = [
    "./data", "--device", "cuda", "--model", "bert_tiny", "-type",
    "SyntheticText", "-b", str(DP_BATCH), "--optimizer", "adamw",
    "--lr", "1e-2", "--epochs", "2", "--world-size", "4",
    "--microbatches", "4"]  # 2 epochs (16 steps; 4 until phase 15)


@contextlib.contextmanager
def s9_recording(engine_cls):
    """Record, in order, the metric sums of every train dispatch: an
    eager step's as (1, sums), a graph dispatch's as (its batch count,
    summed sums; the warmup step it runs inside is not recorded apart);
    and the Trainer a CLI builds."""
    from distributed_model_parallel_tpu_torch.training import multistep
    from distributed_model_parallel_tpu_torch.training import trainer as tr

    box = {"steps": [], "in_graph": False}
    step, run, fit = (engine_cls.train_step, multistep.StepGraph.run,
                      tr.Trainer.fit)

    def recorded(self, ts, *batch_lr):
        ts, m = step(self, ts, *batch_lr)
        if not box["in_graph"]:
            box["steps"].append((1, m))
        return ts, m

    def dispatched(self, state, batches, *args, **kw):
        box["in_graph"] = True
        try:
            sums = run(self, state, batches, *args, **kw)
        finally:
            box["in_graph"] = False
        if self.train:
            box["steps"].append((len(batches), sums))
        return sums

    def grab(self):
        box["trainer"] = self
        return fit(self)

    with patched(engine_cls, "train_step", recorded), \
            patched(multistep.StepGraph, "run", dispatched), \
            patched(tr.Trainer, "fit", grab):
        yield box


def s9_run(main, flags, engine_cls, directory):
    """`main(flags)` from `directory`, unsynchronized: (result, each
    dispatch's (steps, metric sums as floats), the Trainer, peak memory
    above the start in bytes, wall seconds, stdout)."""
    from distributed_model_parallel_tpu_torch.observability import metrics

    metrics.set_metrics(None)  # each run exports its own samples
    os.makedirs(directory, exist_ok=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with s9_recording(engine_cls) as box, contextlib.chdir(directory), \
            contextlib.redirect_stdout(out):
        result = main(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    steps = [(n, {k: float(v) for k, v in m.items()})
             for n, m in box["steps"]]
    return result, steps, box["trainer"], peak, wall, out.getvalue()


def s9_grouped_equal(eager, graph) -> bool:
    """Whether a graph run's dispatches (`s9_run`) equal the step-by-step
    run's steps summed in the same groups, bit for bit: in f32, in the
    order a dispatch adds them (`StepGraph.run`); every step covered."""
    import numpy as np

    i = 0
    for n, sums in graph:
        part = [m for _, m in eager[i:i + n]]
        if len(part) < n or set(sums) != set(part[0]):
            return False
        for key, got in sums.items():
            acc = np.float32(part[0][key])
            for m in part[1:]:
                acc = np.float32(acc + np.float32(m[key]))
            if float(acc) != got:
                return False
        i += n
    return i == len(eager)


def s9_timing(trainer, k: int, names=(), reps: int = 1) -> dict:
    """Four train steps of a finished run's Trainer from its own loader:
    as four `train_step` calls (k = 1) or one dispatch of the captured
    graph (k = 4), synchronized, `reps` times after one warm pass (ms a
    step); then one more pass under torch.profiler, timed itself: its
    wall ms a step, device busy ms and the idle share of that same
    window (the profiler's host cost included; busy sums the kernels of
    every stream), kernels and host CUDA API calls a step, and the
    launches of each device kernel whose name holds one of `names`."""
    from torch.profiler import ProfilerActivity, profile

    eng = trainer.engine
    it = iter(trainer.train_loader)
    batches = [eng.shard_batch(*next(it)) for _ in range(S9_K)]
    lr = trainer.lr_fn(0)

    def once():
        if k > 1:
            trainer.state, _ = trainer._multi(trainer.state, batches, lr)
        else:
            for b in batches:
                trainer.state, _ = eng.train_step(trainer.state, *b, lr)

    once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (reps * S9_K)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)  # the profiler settles; not in the timed window
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / S9_K
    kernels = device_kernels(prof)
    busy = sum(t for t, _, _ in kernels) / 1e3 / S9_K
    _, calls = profile_tally(prof)
    return {"ms_per_step": ms, "profiled_ms_per_step": profiled_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / profiled_ms,
            "kernels_per_step": sum(n for _, n, _ in kernels) / S9_K,
            "host_cuda_calls_per_step": calls / S9_K,
            "launches": {name: sum(n for _, n, key in kernels if name in key)
                         for name in names}}


def s9_same(a, b) -> dict:
    """Bit-equality and max|d|/max|ref| of two states' parameters and
    model state (any tree shapes)."""
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    la = list(tree_leaves((a.params, a.model_state)))
    lb = list(tree_leaves((b.params, b.model_state)))
    require(len(la) == len(lb) > 0, f"{len(la)} / {len(lb)} state leaves")
    return {"bit_equal": all(torch.equal(x, y) for x, y in zip(la, lb)),
            "max_rel": max(rel_diff(x.detach(), y.detach())
                           for x, y in zip(la, lb))}


def s9_trace_kernels(path: str, names=()) -> tuple:
    """(device kernels in a Chrome trace, {name: those whose name holds
    it})."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    return len(events), {name: sum(1 for e in events
                                   if name in e.get("name", ""))
                         for name in names}


def s9_prom(path: str) -> dict:
    """Parse a Prometheus text file: every sample line `name{labels}
    value`; returns {name: [values]}."""
    import re

    samples = {}
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                        r'(NaN|[-+]?[0-9.eE+-]+)$')
    with open(path) as f:
        for line in f.read().splitlines():
            if not line or line.startswith("#"):
                continue
            m = sample.match(line)
            require(m is not None, f"{path}: not Prometheus text: {line!r}")
            samples.setdefault(m.group(1), []).append(float(m.group(3)))
    return samples


def s9_trace_path(d: str) -> str:
    """The --profile-dir trace of the k = S9_K run under `d`."""
    prof = os.path.join(d, f"k{S9_K}", "prof")
    return os.path.join(prof, os.listdir(prof)[0])


def s9_lm(lm, fa, qm, lm_rows) -> tuple:
    """(a) and (b) on the LM path at GPT-2-small width, f32 and bf16:
    remat against phase 5's runs; remat + steps per dispatch 4 (+ trace
    and metrics) against remat step by step. Returns the K1-K3 launches
    the wrappers counted in these runs, and those that the profiles of
    one 4-step graph dispatch showed."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine as LMEngine

    launches = {name: 0 for name, _, _ in FLASH_KERNELS}
    replays = {name: 0 for name, _, _ in FLASH_KERNELS}
    tries = {}
    kernel_names = [kname for _, kname, _ in FLASH_KERNELS]
    # K1 twice a block under remat (the recompute), K2 and K3 once
    per_step = {"flash_fwd_kernel": 2 * LAYERS,
                "flash_bwd_dq_kernel": LAYERS, "flash_bwd_dkv_kernel": LAYERS}
    for dtype, base in (("float32", lm_rows[0]), ("bfloat16", lm_rows[1])):
        d = scratch_dir(f"s9_lm_{dtype}")
        flags = S9_LM + ["--dtype", dtype, "--remat", "--checkpoint-dir",
                         os.path.join(d, "ck")]
        runs = {}
        traced = {kname: S9_K * n for kname, n in per_step.items()}
        for k in (1, S9_K):
            # The k = 4 run again when its --profile-dir trace came back
            # short (the profiler drops kernel records, §7 of PERF.md):
            # at most S9_TRACE_TRIES runs; the trace is held below.
            for attempt in range(1, 1 + (S9_TRACE_TRIES if k == S9_K
                                         else 1)):
                reset_counts(fa, qm)
                extra = ([] if k == 1 else
                         ["--steps-per-dispatch", str(k)] + S9_OBS)
                shutil.rmtree(os.path.join(d, f"k{k}"), ignore_errors=True)
                runs[k] = s9_run(lm.main, flags + extra, LMEngine,
                                 os.path.join(d, f"k{k}"))
                got = counts(fa)
                # The launches the host issues: every step of the k = 1
                # run; under the graph the warmup step and the capture
                # (one capture, checked below), the replays none.
                # Validation (LM_VAL_BATCHES, fewer than k) runs eagerly
                # in both.
                host_steps = S9_LM_STEPS if k == 1 else 2
                want = {"flash_fwd": LAYERS * (2 * host_steps
                                               + LM_VAL_BATCHES),
                        "flash_bwd_dq": LAYERS * host_steps,
                        "flash_bwd_dkv": LAYERS * host_steps}
                require(got == want, f"LM remat k={k} {dtype}: launches "
                        f"{got}, want {want}")
                require(qm.int8_matmul.launches == 0, "the LM launched K4")
                if k == 1 or s9_trace_kernels(s9_trace_path(d),
                                              kernel_names)[1] == traced:
                    break
            if k == S9_K:
                tries[dtype] = attempt
            for name in launches:
                launches[name] += got[name]
        (_, s1, tr1, peak1, wall1, _), (_, s4, tr4, peak4, wall4, _) = \
            runs[1], runs[S9_K]
        # f32 division, as phase 5's losses are divided on the card
        loss1 = [float(np.float32(m["loss_sum"]) / np.float32(m["count"]))
                 for _, m in s1]
        require(len(s1) == S9_LM_STEPS and [n for n, _ in s4] == [S9_K] * (S9_LM_STEPS // S9_K)
                and all(map(math.isfinite, loss1)),
                f"LM {dtype}: dispatches {len(s1)} / {[n for n, _ in s4]}, "
                f"losses {loss1}")
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(loss1, base["step_loss"]))
        require(rel <= S9_REMAT_REL[dtype],
                f"LM {dtype}: remat losses {loss1[:4]} vs no remat "
                f"{base['step_loss']}: {rel}")
        require(peak1 < base["peak_above_start_bytes"],
                f"LM {dtype}: remat peak {peak1} not below "
                f"{base['peak_above_start_bytes']}")
        same = s9_same(tr4.state, tr1.state)
        require(s9_grouped_equal(s1, s4) and same["bit_equal"],
                f"LM {dtype}: the graph run differs from step by step: "
                f"{same}, {s4} vs {s1}")
        graph = tr4._multi.graph
        require(graph.captures == 1 and graph.replays == S9_LM_STEPS - 1,
                f"LM {dtype}: {graph.captures} captures, {graph.replays} "
                "replays")
        # The trace holds the first dispatch (the epoch is too short for
        # step 10): its warmup step and three replays.
        trace_n, trace_named = s9_trace_kernels(s9_trace_path(d),
                                                kernel_names)
        timing = {"eager": s9_timing(tr1, 1, kernel_names),
                  "graph": s9_timing(tr4, S9_K, kernel_names)}
        # Four eager steps' launches, as the wrappers counted them in the
        # k = 1 run (exactly, above). The eager pass's own profile is
        # printed, not held: its traces have come back a few kernel
        # records short (4,321.5 kernels a step over 4 steps).
        want = {kname: S9_K * n for kname, n in per_step.items()}
        require(timing["graph"]["launches"] == trace_named == want,
                f"LM {dtype}: traced K1-K3 launches of 4 steps: graph "
                f"replays {timing['graph']['launches']}, --profile-dir "
                f"trace {trace_named}; want {want} (eager pass: "
                f"{timing['eager']['launches']})")
        for name, kname, _ in FLASH_KERNELS:
            replays[name] += timing["graph"]["launches"][kname]
        prom = s9_prom(os.path.join(d, f"k{S9_K}", "m.prom"))
        require(len(prom.get("train_step_s", [])) == 3
                and prom["train_step_s_count"] == [S9_LM_STEPS / S9_K],
                f"LM {dtype}: m.prom train_step_s {prom}")
        row = {"s9_lm": dtype, "remat": True,
               "step_loss_remat": loss1,
               "step_loss_no_remat_phase5": base["step_loss"],
               "loss_rel_remat_vs_no_remat": rel,
               "loss_bit_equal_remat_vs_no_remat":
                   loss1[:len(base["step_loss"])] == base["step_loss"],
               "peak_above_start_gib": {
                   "no_remat": base["peak_above_start_bytes"] / 2 ** 30,
                   "remat": peak1 / 2 ** 30,
                   "remat_graph": peak4 / 2 ** 30},
               "graph_vs_eager": same, "graph_capture_s": graph.capture_s,
               "wall_s": {"eager": wall1, "graph": wall4},
               "trace_file_kernels": trace_n,
               "trace_file_flash_launches": trace_named,
               "trace_tries": tries[dtype],
               "prom_samples": len(prom), **timing}
        emit(row)
        del runs, tr1, tr4
    require(min(tries.values()) == 1, f"LM k={S9_K}: every dtype's "
            f"--profile-dir trace came back short at first: tries {tries}")
    return launches, replays, tries


def s9_dispatch_dp(dp_cli, dp_mod, data) -> dict:
    """(b) MobileNetV2 DDP bf16, DP_STEPS (16) steps: --steps-per-dispatch
    4 (4 groups; its validation in groups of 4) against step
    by step, with the trace of three steady-state steps and the
    Prometheus file."""
    from distributed_model_parallel_tpu_torch.data import datasets

    flags = DP_FLAGS + ["--engine", "ddp", "--dtype", "bfloat16"]
    runs = {}
    with patched(datasets.DatasetCollection, "init", lambda self: data):
        for k in (1, S9_K):
            d = scratch_dir(f"s9_dp_k{k}")
            extra = [] if k == 1 else ["--steps-per-dispatch", str(k)] + S9_OBS
            runs[k] = s9_run(dp_cli.main, flags + extra + [
                "--checkpoint-dir", os.path.join(d, "ck")],
                dp_mod._DataParallel, d)
    (_, s1, tr1, peak1, wall1, _), (_, s4, tr4, peak4, wall4, _) = \
        runs[1], runs[S9_K]
    same = s9_same(tr4.state, tr1.state)
    losses = [m["loss_sum"] / m["count"] for _, m in s1]
    require(len(s1) == DP_STEPS and s9_grouped_equal(s1, s4)
            and same["bit_equal"],
            f"MobileNetV2 graph run differs from step by step: {same}")
    graph = tr4._multi.graph
    train_replays = graph.replays
    # The host issues the all-reduce for every eager step (the k = 1
    # run; the warmup step and the tail of the graph run) and once for
    # the capture, which the replays repeat without Python.
    issued = {"eager": tr1.engine.grad_reductions,
              "graph": tr4.engine.grad_reductions}
    require(issued["eager"] == DP_STEPS
            and issued["graph"] == DP_STEPS - train_replays + graph.captures,
            f"MobileNetV2: gradient all-reduces issued {issued} "
            f"({train_replays} replays, {graph.captures} captures)")
    d4 = scratch_dir(f"s9_dp_k{S9_K}")
    prof_dir = os.path.join(d4, "prof")
    trace_kernels, _ = s9_trace_kernels(
        os.path.join(prof_dir, os.listdir(prof_dir)[0]))
    prom = s9_prom(os.path.join(d4, "m.prom"))
    # NCCL kernels in each profiled pass, printed (`launches`; at world
    # 1 the all-reduce has launched none)
    eager, graphed = (s9_timing(tr1, 1, ("nccl",)),
                      s9_timing(tr4, S9_K, ("nccl",)))
    require(trace_kernels >= 3 * eager["kernels_per_step"],
            f"the trace holds {trace_kernels} kernels, fewer than three "
            f"steps of {eager['kernels_per_step']}")
    require("train_step_s" in prom and len(prom["train_step_s"]) == 3,
            f"m.prom: {sorted(prom)}")
    row = {"s9_dispatch_dp": "mobilenetv2_ddp_bf16", "steps": DP_STEPS,
           "k": S9_K, "graph_vs_eager": same,
           "dispatch_sums_equal": True,
           "first_loss": losses[0], "last_loss": losses[-1],
           "graph_captures": graph.captures, "graph_replays": train_replays,
           "grad_allreduces_issued": issued,
           "graph_capture_s": graph.capture_s,
           "eval_graph_replays": tr4._multi_eval.graph.replays,
           "peak_above_start_gib": {"eager": peak1 / 2 ** 30,
                                    "graph": peak4 / 2 ** 30},
           "wall_s": {"eager": wall1, "graph": wall4},
           "trace_file_kernels": trace_kernels,
           "prom_train_step_s": prom["train_step_s"],
           "eager": eager, "graph": graphed}
    emit(row)
    return row


def s9_classifier_run(dp_cli, dp_mod, name, flags) -> dict:
    """(c) one DP CLI run of a transformer classifier, each step timed
    (synchronized): ms a step, samples/s, busy / idle, kernels a step,
    peak memory, first and last loss, val acc1; the loss must be finite
    and fall."""
    d = scratch_dir(f"s9_{name}")
    os.makedirs(d, exist_ok=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.chdir(d):
        out, steps, seen = recorded_run(dp_cli.main, flags + [
            "--checkpoint-dir", os.path.join(d, "ck")], dp_mod._DataParallel)
    peak = torch.cuda.max_memory_allocated() - base
    losses = [st["loss"] for st in steps]
    hist = out["history"]
    require(all(map(math.isfinite, losses)) and len(losses) >= 10,
            f"{name}: losses {losses}")
    require(sum(losses[-5:]) < sum(losses[:5]),
            f"{name}: the train loss did not fall: {losses}")
    timed = steps[DP_TIMED_FROM:]
    ms = sum(st["ms"] for st in timed) / len(timed)
    row = {"s9_classifier": name, "flags": flags[2:], "steps": len(steps),
           "ms_per_step": ms, "samples_per_s": DP_BATCH / ms * 1e3,
           "first_loss": losses[0], "last_loss": losses[-1],
           "step_loss": losses,
           "val_acc1": [h["val"]["acc1"] for h in hist],
           "peak_above_start_gib": peak / 2 ** 30}
    row.update(dp_breakdown(seen, ms))
    emit(row)
    return row


def s9_transformer_checks() -> dict:
    """(d) one bert_tiny step (dropout 0) through 4 pipeline stages at M
    4, gpipe and 1f1b, against the DataParallelEngine's step on the whole
    model; (e) one ViT step (2 layers, dim 64) and one bert_tiny DDP step
    (dropout 0) and one 2-layer BERT_BASE-width DDP step (dropout 0) on
    the card against the CPU. TF32 off."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.cli.common import (
        _bert_tiny_cfg,
    )
    from distributed_model_parallel_tpu_torch.models import bert, vit
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
        DDPEngine,
        TrainState,
    )
    from distributed_model_parallel_tpu_torch.parallel.pipeline import (
        PipelineEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    cuda = torch.device("cuda")
    cfg = dataclasses.replace(_bert_tiny_cfg(), dropout_rate=0.0)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, cfg.vocab_size, size=(DP_BATCH, 64)).astype(
        np.int32)
    labels = rng.randint(0, 4, DP_BATCH)
    model = bert.bert_for_classification(4, cfg)
    dp = DataParallelEngine(model, SGD(), mesh=Mesh(1, None), device=cuda)
    whole, state = model.init(torch.Generator().manual_seed(0))
    dts, _ = dp.train_step(dp.state_from_params(whole, state),
                           *dp.shard_batch(ids, labels), 0.05)
    as_chunks = TrainState(tuple(bert.partition_pytree(dts.params, 4, cfg)),
                           ((),) * 4, None, 1)
    reading = {}
    for schedule in ("gpipe", "1f1b"):
        stages = bert.split_stages(4, 4, cfg)
        eng = PipelineEngine(stages, SGD(), Mesh(1, None, 4, (cuda,)),
                             num_microbatches=4, schedule=schedule)
        ts = eng.state_from_params(
            bert.partition_pytree(whole, 4, cfg),
            tuple(st.init(torch.Generator())[1] for st in stages))
        ts, _ = eng.train_step(ts, *eng.shard_batch(ids, labels), 0.05)
        reading[f"bert_tiny_{schedule}_m4_vs_dp"] = s9_same(
            ts._replace(model_state=((),) * 4), as_chunks)

    def card_vs_cpu(make, x, y):
        res = {}
        for dev in ("cuda", "cpu"):
            eng = DDPEngine(make(), SGD(), mesh=Mesh(1, None), device=dev)
            ts, m = eng.train_step(eng.init_state(0),
                                   *eng.shard_batch(x, y), 0.05)
            res[dev] = (m["loss_sum"] / m["count"], ts)
        loss = rel_diff(res["cuda"][0].cpu(), res["cpu"][0])
        cpu_ts = res["cpu"][1]
        card = TrainState(
            *(tree_to(t, "cpu") for t in (res["cuda"][1].params,
                                          res["cuda"][1].model_state)),
            None, 1)
        return {"loss_rel": loss, **s9_same(card, cpu_ts)}

    images = rng.randn(16, 32, 32, 3).astype(np.float32)
    vcfg = vit.ViTConfig(image_size=32, patch_size=4, dim=64, num_layers=2,
                         num_heads=4, mlp_dim=128)
    reading["vit_card_vs_cpu"] = card_vs_cpu(
        lambda: vit.vit(10, vcfg), images, rng.randint(0, 10, 16))
    reading["bert_tiny_card_vs_cpu"] = card_vs_cpu(
        lambda: bert.bert_for_classification(4, cfg), ids[:16], labels[:16])
    # BERT_BASE's widths (vocab 30522, 768, 12 heads, 3072) at 2 layers:
    # phase (c) holds the full model to falling losses only.
    base2 = dataclasses.replace(bert.BERT_BASE, num_layers=2,
                                dropout_rate=0.0)
    reading["bert_base_2layer_card_vs_cpu"] = card_vs_cpu(
        lambda: bert.bert_for_classification(4, base2),
        rng.randint(1, base2.vocab_size, size=(16, 64)).astype(np.int32),
        labels[:16])
    emit({"s9_transformer_checks": reading})
    for name, r in reading.items():
        bar = PP_STEP_REL if "_vs_dp" in name else DP_CARD_VS_CPU
        worst = max(r["max_rel"], r.get("loss_rel", 0.0))
        require(worst <= bar, f"{name}: {worst} > {bar}: {r}")
    return reading


def s9_bert_tiny_pipeline(mp_cli, pp_mod) -> list:
    """(d) the pipeline CLI on bert_tiny, 4 stages on the card, M 4,
    gpipe and 1f1b, on SyntheticText: ms a step, losses (finite and
    falling), val acc1."""
    rows = []
    for schedule in ("gpipe", "1f1b"):
        d = scratch_dir(f"s9_pp_{schedule}")
        os.makedirs(d)
        with contextlib.chdir(d):
            out, steps, seen = recorded_run(
                mp_cli.main, S9_BERT_TINY_PP + ["--pipeline-schedule",
                                                schedule], pp_mod.PipelineEngine)
        losses = [st["loss"] for st in steps]
        require(all(map(math.isfinite, losses))
                and sum(losses[-5:]) < sum(losses[:5]),
                f"bert_tiny pipeline {schedule}: losses {losses}")
        timed = steps[DP_TIMED_FROM:]
        ms = sum(st["ms"] for st in timed) / len(timed)
        row = {"s9_pp_bert_tiny": schedule, "steps": len(steps),
               "ms_per_step": ms, "samples_per_s": DP_BATCH / ms * 1e3,
               "first_loss": losses[0], "last_loss": losses[-1],
               "step_loss": losses,
               "val_acc1": [h["val"]["acc1"] for h in out["history"]],
               "devices": sorted({str(x) for x in seen["engine"].devices})}
        emit(row)
        rows.append(row)
    return rows


def slice9_phase(lm, fa, qm, lm_rows, dp_data) -> dict:
    """Phase 10 (module docstring). Returns the K1-K3 launches of the
    phase's main paths (the wrappers' counts), those of its profiled
    4-step graph dispatches (counted in the traces), and the LM k = 4
    runs made for a whole trace, by dtype."""
    from distributed_model_parallel_tpu_torch.cli import (
        data_parallel,
        model_parallel,
    )
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )
    from distributed_model_parallel_tpu_torch.parallel import (
        pipeline as pp_mod,
    )

    t0 = time.perf_counter()
    launches, replays, tries = s9_lm(lm, fa, qm, lm_rows)
    print(f"phase 10 (a, b) LM: {time.perf_counter() - t0:.1f} s",
          flush=True)
    reset_counts(fa, qm)
    s9_dispatch_dp(data_parallel, dp_mod, dp_data)
    with patched(datasets.DatasetCollection, "init", lambda self: dp_data):
        for name, extra in S9_VIT_RUNS:
            s9_classifier_run(data_parallel, dp_mod, name, S9_VIT + extra)
    peaks = {}
    for name, extra in (("bert_base_f32", []),
                        ("bert_base_f32_remat", ["--remat"])):
        row = s9_classifier_run(data_parallel, dp_mod, name, S9_BERT + extra)
        peaks[name] = row["peak_above_start_gib"]
    require(peaks["bert_base_f32_remat"] < peaks["bert_base_f32"],
            f"BERT remat peak {peaks['bert_base_f32_remat']} GiB not below "
            f"{peaks['bert_base_f32']}")
    s9_bert_tiny_pipeline(model_parallel, pp_mod)
    s9_transformer_checks()
    got = counts(fa)
    require(not any(got.values()) and qm.int8_matmul.launches == 0,
            f"the DP / pipeline runs of phase 10 launched K1-K4: {got}")
    torch.distributed.destroy_process_group()
    return launches, replays, tries


# ---------------------------------------------------------------------
# Gradient reduction (slice 10)

S10_STEPS = 8  # 12 until phase 15 was added; steps 6-8 are timed
S10_VAL_IMAGES = 2560  # of phase 6's 10,000, as phase 8 validates
S10_DP_FLAGS = DP_FLAGS[:DP_FLAGS.index("--steps-per-epoch")] + [
    "--steps-per-epoch", str(S10_STEPS), "--engine", "ddp"]
# (mode, extra flags): MobileNetV2's 9.2 MB of f32 gradients are one
# bucket at the default 25 MB, so the DP runs cut 1 MB buckets; the LM's
# ~497 MB are ~20 buckets at 25 MB. Overlapped is auto: 4 segments.
S10_DP_MODES = (("monolithic", []),
                ("bucketed", ["--grad-reduction", "bucketed",
                              "--bucket-mb", "1"]),
                ("overlapped", ["--grad-reduction", "overlapped",
                                "--bucket-mb", "1"]))
S10_LM_MODES = (("monolithic", []),
                ("bucketed", ["--grad-reduction", "bucketed"]),
                ("overlapped", ["--grad-reduction", "overlapped"]))
S10_NOT_ON_ONE_CARD = (
    "--dcn-slices 2 (the hierarchical reduce-scatter / cross-slice "
    "all-reduce / all-gather) and --dcn-compression bf16|int8 need two "
    "or more data ranks, and NCCL puts one rank on a GPU: they run on "
    "gloo CPU ranks in tests/test_torch_port_grad_reduction.py and "
    "tests/test_torch_port_wire_codec.py, not here; neither does the "
    "overlap of bucket traffic with the backward show at world 1, where "
    "NCCL launches no kernel")


def s10_profile(seen, wall_ms):
    """One more train step under torch.profiler: device busy ms, the idle
    share against the synchronized step wall, kernels a step, NCCL
    kernels and the flash kernels' device ms."""
    kernels = profiled_step(seen)
    busy_ms = sum(t for t, _, _ in kernels) / 1e3
    return {"device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernels_per_step": sum(n for _, n, _ in kernels),
            "nccl_kernels_per_step": sum(n for _, n, key in kernels
                                         if "nccl" in key.lower()),
            "flash_kernel_device_ms": {
                dev_key: sum(t for t, _, key in kernels
                             if dev_key in key) / 1e3
                for _, dev_key, _ in FLASH_KERNELS}}


def s10_run(main, flags, cls, name, steps):
    """One CLI run, each train step timed (synchronized) and its loss
    recorded: (row, the final parameters before the profiled step, the
    wrappers' counts). ms a step over steps 2.. (LM) or 6.. (DP)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, rec, seen = recorded_run(main, flags, cls)
    peak = torch.cuda.max_memory_allocated() - base
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    params = [t.detach().clone() for t in tree_leaves(seen["state"].params)]
    losses = [s["loss"] for s in rec]
    hist = out["history"][0]
    require(len(rec) == steps and all(map(math.isfinite, losses))
            and math.isfinite(hist["val"]["loss"]),
            f"slice-10 run {name}: {len(rec)} steps, losses {losses}")
    timed = rec[DP_TIMED_FROM:] if steps > DP_TIMED_FROM else rec[1:]
    ms = sum(s["ms"] for s in timed) / len(timed)
    eng = seen["engine"]
    row = {"s10_run": name, "ms_per_step": ms,
           "median_ms_per_step": sorted(s["ms"] for s in timed)[
               len(timed) // 2],
           "step_ms": [s["ms"] for s in rec], "step_loss": losses,
           "val_loss": hist["val"]["loss"],
           "collectives_per_step": eng.grad_reductions / steps,
           "peak_above_start_gib": peak / 2 ** 30}
    return row, params, seen


def s10_modes(name, runs, f32):
    """Bucketed and overlapped against monolithic: per-step losses and
    final parameters bit-equal (required in f32, printed in bf16)."""
    (_, mono), rest = runs[0], runs[1:]
    same = {}
    for mode, (row, params) in rest:
        eq_loss = row["step_loss"] == mono[0]["step_loss"]
        eq_params = all(torch.equal(a, b) for a, b in zip(params, mono[1]))
        same[mode] = {"losses_bit_equal": eq_loss,
                      "params_bit_equal": eq_params}
        if f32:
            require(eq_loss and eq_params,
                    f"{name} {mode}: not bit-equal to monolithic at world "
                    f"1 ({same[mode]})")
    emit({"s10_modes_vs_monolithic": name, **same})


def s10_dp(dp_cli, dp_mod, data):
    """(a) MobileNetV2 DDP, f32 and bf16, monolithic / bucketed 1 MB /
    overlapped 1 MB through the DP CLI, S10_STEPS steps each."""
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.data import datasets

    val = data[1]
    data = (data[0], datasets.ArrayDataset(val.images[:S10_VAL_IMAGES],
                                           val.labels[:S10_VAL_IMAGES],
                                           val.num_classes))
    for dtype in ("float32", "bfloat16"):
        runs = []
        for mode, extra in S10_DP_MODES:
            name = f"dp_{mode}_{dtype}"
            with patched(datasets.DatasetCollection, "init",
                         lambda self: data):
                row, params, seen = s10_run(
                    dp_cli.main, S10_DP_FLAGS + ["--dtype", dtype] + extra
                    + ["--checkpoint-dir", scratch_dir(f"s10_{name}")],
                    dp_mod._DataParallel, name, S10_STEPS)
            require(dist.get_backend() == "nccl"
                    and dist.get_world_size() == 1,
                    f"{name}: not NCCL at world 1")
            row.update(s10_profile(seen, row["ms_per_step"]))
            del row["flash_kernel_device_ms"]
            emit(row)
            runs.append((mode, (row, params)))
        s10_modes(f"mobilenetv2_{dtype}", runs, dtype == "float32")


def s10_lm(lm, fa, qm):
    """(b) The LM CLI at GPT-2-small width, ulysses_flash, f32 and bf16,
    monolithic / bucketed / overlapped, 4 steps and 1 val batch each;
    returns the K1-K3 launches the wrappers counted over the six runs."""
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine

    total = dict.fromkeys(counts(fa), 0)
    want = {"flash_fwd": LAYERS * (LM_STEPS + LM_VAL_BATCHES),
            "flash_bwd_dq": LAYERS * LM_STEPS,
            "flash_bwd_dkv": LAYERS * LM_STEPS}
    for dtype in ("float32", "bfloat16"):
        runs = []
        for mode, extra in S10_LM_MODES:
            name = f"lm_{mode}_{dtype}"
            directory = scratch_dir(f"s10_{name}")
            reset_counts(fa, qm)
            row, params, seen = s10_run(
                lm.main, LM_FLAGS + ["--layers", str(LAYERS), "--attention",
                                     "ulysses_flash", "--dtype", dtype]
                + extra + ["--checkpoint-dir", directory],
                CausalLMSequenceParallelEngine, name, LM_STEPS)
            got = counts(fa)
            shutil.rmtree(directory, ignore_errors=True)
            require(got == want and qm.int8_matmul.launches == 0,
                    f"{name}: launches {got} / int8 "
                    f"{qm.int8_matmul.launches}, want {want} / 0")
            for key in total:
                total[key] += got[key]
            row["launches"] = got
            row["tokens_per_s"] = LM_TOKENS / row["ms_per_step"] * 1e3
            row.update(s10_profile(seen, row["ms_per_step"]))
            emit(row)
            runs.append((mode, (row, params)))
            del seen
        s10_modes(f"lm_{dtype}", runs, dtype == "float32")
        del runs
    return total


def s10_dispatch(dp_cli, dp_mod, data):
    """(c) MobileNetV2 DDP bf16, overlapped 1 MB, S10_STEPS steps: step by step
    and `--steps-per-dispatch 4` (the overlapped step captured in a CUDA
    graph, its collectives issued from the reducer's stream): dispatch
    sums and final state bit-equal, ms a step and idle share of each."""
    from distributed_model_parallel_tpu_torch.data import datasets

    flags = S10_DP_FLAGS + ["--dtype", "bfloat16", "--grad-reduction",
                            "overlapped", "--bucket-mb", "1"]
    val = data[1]
    data = (data[0], datasets.ArrayDataset(val.images[:S10_VAL_IMAGES],
                                           val.labels[:S10_VAL_IMAGES],
                                           val.num_classes))
    runs = {}
    with patched(datasets.DatasetCollection, "init", lambda self: data):
        for k in (1, S9_K):
            d = scratch_dir(f"s10_dispatch_k{k}")
            extra = [] if k == 1 else ["--steps-per-dispatch", str(k)]
            runs[k] = s9_run(dp_cli.main, flags + extra + [
                "--checkpoint-dir", os.path.join(d, "ck")],
                dp_mod._DataParallel, d)
    (_, s1, tr1, peak1, _, _), (_, s4, tr4, peak4, _, _) = \
        runs[1], runs[S9_K]
    same = s9_same(tr4.state, tr1.state)
    require(len(s1) == S10_STEPS and s9_grouped_equal(s1, s4)
            and same["bit_equal"],
            f"overlapped graph run differs from step by step: {same}")
    graph = tr4._multi.graph
    per_step = tr1.engine.grad_reductions / S10_STEPS
    issued = {"eager": tr1.engine.grad_reductions,
              "graph": tr4.engine.grad_reductions}
    require(per_step == int(per_step) and issued["graph"] == per_step * (
        S10_STEPS - graph.replays + graph.captures),
        f"collectives issued {issued} ({graph.replays} replays, "
        f"{graph.captures} captures)")
    row = {"s10_dispatch": "mobilenetv2_ddp_bf16_overlapped", "k": S9_K,
           "steps": S10_STEPS, "graph_vs_eager": same,
           "dispatch_sums_equal": True, "collectives_issued": issued,
           "graph_captures": graph.captures, "graph_replays": graph.replays,
           "graph_capture_s": graph.capture_s,
           "peak_above_start_gib": {"eager": peak1 / 2 ** 30,
                                    "graph": peak4 / 2 ** 30},
           "eager": s9_timing(tr1, 1, ("nccl",)),
           "graph": s9_timing(tr4, S9_K, ("nccl",))}
    emit(row)
    return row


def s10_card_vs_cpu():
    """(d) One tinycnn and one bert_tiny DDP step, bucketed and
    overlapped, at world 1 on NCCL against the CPU with no process
    group: loss and every parameter within DP_CARD_VS_CPU."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.cli.common import MODELS
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_leaves,
    )

    rng = np.random.RandomState(0)
    inputs = {"tinycnn": (rng.randn(16, 8, 8, 3).astype(np.float32),
                          rng.randint(0, 10, 16), 10),
              "bert_tiny": (rng.randint(1, 512, (16, 64)),
                            rng.randint(0, 4, 16), 4)}
    readings = {}
    for name, (x, y, classes) in inputs.items():
        for mode in ("bucketed", "overlapped"):
            res = {}
            for dev, mesh in (("cuda", None), ("cpu", Mesh(1, None))):
                eng = DDPEngine(MODELS[name](classes), SGD(), mesh=mesh,
                                device=dev, grad_reduction=mode,
                                bucket_mb=0.05)
                ts, m = eng.train_step(eng.init_state(0),
                                       *eng.shard_batch(x, y), 0.05)
                res[dev] = (m["loss_sum"] / m["count"],
                            list(tree_leaves(ts.params)),
                            eng.grad_reductions)
            params = max(rel_diff(a.detach().cpu(), b.detach())
                         for a, b in zip(res["cuda"][1], res["cpu"][1]))
            readings[f"{name}_{mode}"] = {
                "loss_rel": rel_diff(res["cuda"][0].cpu(), res["cpu"][0]),
                "param_rel_max": params,
                "collectives": {"cuda": res["cuda"][2], "cpu": res["cpu"][2]}}
    emit({"s10_card_vs_cpu": readings})
    for key, r in readings.items():
        require(max(r["loss_rel"], r["param_rel_max"]) <= DP_CARD_VS_CPU
                and r["collectives"]["cuda"] > 0
                and r["collectives"]["cpu"] == 0,
                f"{key} on the card differs from the CPU's: {r}")
    return readings


def s10_codec():
    """(e) The int8 and bf16 wire codecs on one real gradient bucket
    (MobileNetV2, the one 25 MB bucket of its gradients after one DDP
    step at batch 64) on the card and on the CPU: codes and scales
    equal (torch.equal). Printed beside: how many int8 codes a scale
    taken as absmax x (1/127) would change (the trap a true division
    avoids)."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models import layers as L
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        mobilenet_v2,
    )
    from distributed_model_parallel_tpu_torch.ops import wire_codec
    from distributed_model_parallel_tpu_torch.ops.grad_reduction import (
        plan_buckets,
    )
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.metrics import (
        cross_entropy,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        tree_leaves,
    )

    rng = np.random.RandomState(4)
    batches = [(rng.randn(64, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, 64)) for _ in range(2)]
    eng = DDPEngine(mobilenet_v2(10), SGD(), mesh=Mesh(1, None),
                    device="cuda")
    ts, _ = eng.train_step(eng.init_state(0), *eng.shard_batch(
        *batches[0]), 0.1)
    x, y = eng.shard_batch(*batches[1])
    logits, _ = eng.model.apply(ts.params, ts.model_state, x,
                                L.Context(train=True))
    leaves = list(tree_leaves(ts.params))
    grads = torch.autograd.grad(cross_entropy(logits, y), leaves)
    (bucket,) = plan_buckets(grads)
    flat = torch.cat([grads[s.index].reshape(-1) for s in bucket.slots])
    out = {"elements": flat.numel()}
    for wire in ("int8", "bf16"):
        pg, sg = wire_codec.wire_encode(wire, flat)
        pc, sc = wire_codec.wire_encode(wire, flat.cpu())
        out[wire] = {"codes_equal": torch.equal(pg.cpu(), pc),
                     "scale_equal": None if sg is None
                     else torch.equal(sg.cpu(), sc)}
        if wire == "int8":
            recip = flat.abs().amax() * (1 / 127)
            out[wire]["scale"] = float(sg)
            out[wire]["codes_a_reciprocal_scale_changes"] = int(
                (torch.clamp(torch.round(flat / recip), -127, 127)
                 .to(torch.int8) != pg).sum())
        require(out[wire]["codes_equal"]
                and out[wire]["scale_equal"] in (True, None),
                f"{wire} codec on the card differs from the CPU's: {out}")
    emit({"s10_codec_card_vs_cpu": out})
    return out


def slice10_phase(lm, fa, qm, dp_data) -> dict:
    """Phase 11 (module docstring). Returns the K1-K4 launches of the
    phase's main paths, as the wrappers count them."""
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    emit({"slice10_not_run_on_one_card": S10_NOT_ON_ONE_CARD})
    t0 = time.perf_counter()
    reset_counts(fa, qm)
    s10_dp(data_parallel, dp_mod, dp_data)
    require(not any(counts(fa).values()) and qm.int8_matmul.launches == 0,
            f"the DP runs of phase 11 launched K1-K4: {counts(fa)}")
    print(f"phase 11 (a) DP: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = s10_lm(lm, fa, qm)
    launches["int8_matmul"] = 0
    print(f"phase 11 (b) LM: {time.perf_counter() - t0:.1f} s", flush=True)
    s10_dispatch(data_parallel, dp_mod, dp_data)
    s10_card_vs_cpu()
    s10_codec()
    torch.distributed.destroy_process_group()
    return launches


# ---------------------------------------------------------------------
# Slice 11: tensor parallelism, the device-resident dataset cache and the
# image-folder datasets

# 4 steps a run (8 until phase 15 was added; the checks are bit-equality
# and finite losses, which 4 steps show as 8 do).
S11_STEPS = 4
# Where phase 12 runs (its flags say it too): what its functions build
# themselves goes here.
S11_DEVICE = "cuda"
S11_BERT = [  # SyntheticText: 8 batches of 512 an epoch; 1 x 4 steps
    "--device", "cuda", "--model", "bert", "-type", "SyntheticText",
    "-b", str(DP_BATCH), "--val-batch-size", "1024", "--optimizer", "adamw",
    "--lr", "1e-3", "--epochs", "1", "--steps-per-epoch", str(S11_STEPS)]
S11_VIT = DP_FLAGS[:DP_FLAGS.index("--lr")] + [
    "--model", "vit", "--optimizer", "adamw", "--lr", "1e-2", "--wd", "0.05",
    "-j", "8", "--epochs", "1", "--steps-per-epoch", str(S11_STEPS)]
S11_ENGINES = (("tp", ["--engine", "tp", "--model-shards", "1"]),
               ("gspmd", ["--engine", "gspmd"]))
# TP at M 2 over gloo, both ranks on the one card, against M 1 on it,
# elementwise at the port's f32 bar (tests/test_torch_port_pipeline.py);
# the row-parallel products add in another order. SGD (momentum 0.9, wd
# 1e-4, lr 0.05): AdamW's normalized update carries rounding-level
# differences of the start past this bar within 3 steps (bert_tiny), SGD
# keeps them under it.
S11_M2_STEPS = 3
S11_M2_LR = 0.05
S11_M2_TOL = dict(rtol=1e-5, atol=1e-6)
S11_CACHE_FLAGS = S10_DP_FLAGS  # MobileNetV2 DDP, S10_STEPS, batch 512
# The initial state's eval logits, device cache against host loader:
# f32 rounding, relative to max |logit|.
S11_LOGIT_REL = 1e-5
S11_TREE = (10, 32, 8, 64)  # classes, train / val images a class, side
S11_IMAGE_FLAGS = [
    "--device", "cuda", "--model", "resnet18", "-type", "Imagenet",
    "-b", "32", "--val-batch-size", "80", "--epochs", "1",
    "--steps-per-epoch", "4", "--lr", "0.1"]


def s11_cut_val(data):
    """Phase 6's SyntheticTextures with the val split cut to 2,560."""
    from distributed_model_parallel_tpu_torch.data import datasets

    val = data[1]
    return (data[0], datasets.ArrayDataset(val.images[:S10_VAL_IMAGES],
                                           val.labels[:S10_VAL_IMAGES],
                                           val.num_classes))


def s11_tp_runs(dp_cli, dp_mod, data) -> list:
    """(a) BERT_BASE and VIT_CIFAR through the DP CLI at world 1 on NCCL,
    f32 and bf16, `--engine tp --model-shards 1` and `--engine gspmd`,
    S11_STEPS steps and validation each; in f32 the two engines'
    per-step losses and final parameters must be bit-equal (every
    collective is the identity at M 1 and the dropout keys coincide),
    in bf16 printed. Then BERT f32 under tp with `--steps-per-dispatch
    4`: bit-equal to the eager run."""
    from distributed_model_parallel_tpu_torch.data import datasets

    rows = []
    for model, flags in (("bert", S11_BERT), ("vit", S11_VIT)):
        for dtype in ("float32", "bfloat16"):
            runs = {}
            for engine, extra in S11_ENGINES:
                name = f"{model}_{engine}_{dtype}"
                with patched(datasets.DatasetCollection, "init",
                             lambda self: data) if model == "vit" \
                        else contextlib.nullcontext():
                    row, params, seen = s10_run(
                        dp_cli.main, flags + ["--dtype", dtype] + extra
                        + ["--checkpoint-dir", scratch_dir(f"s11_{name}")],
                        dp_mod._DataParallel, name, S11_STEPS)
                row = {"s11_tp_run": name, **{
                    k: v for k, v in row.items() if k != "s10_run"}}
                row["samples_per_s"] = DP_BATCH / row["ms_per_step"] * 1e3
                row.update(s10_profile(seen, row["ms_per_step"]))
                del row["flash_kernel_device_ms"]
                emit(row)
                rows.append(row)
                runs[engine] = (row, params)
                del seen
            (tp, tp_p), (gs, gs_p) = runs["tp"], runs["gspmd"]
            same = {"losses_bit_equal": tp["step_loss"] == gs["step_loss"],
                    "params_bit_equal": all(
                        torch.equal(a, b) for a, b in zip(tp_p, gs_p)),
                    "params_max_rel": max(rel_diff(a, b)
                                          for a, b in zip(tp_p, gs_p))}
            emit({"s11_tp_vs_gspmd": f"{model}_{dtype}", **same})
            if dtype == "float32":
                require(same["losses_bit_equal"] and same["params_bit_equal"],
                        f"{model} f32: tp at M 1 differs from gspmd: {same}")
    d1, d4 = scratch_dir("s11_bert_k1"), scratch_dir(f"s11_bert_k{S9_K}")
    tp = S11_BERT + S11_ENGINES[0][1]
    (_, s1, tr1, _, _, _), (_, s4, tr4, _, _, _) = (
        s9_run(dp_cli.main, tp + ["--checkpoint-dir", "ck"],
               dp_mod._DataParallel, d1),
        s9_run(dp_cli.main, tp + ["--steps-per-dispatch", str(S9_K),
                                  "--checkpoint-dir", "ck"],
               dp_mod._DataParallel, d4))
    same = s9_same(tr4.state, tr1.state)
    graph = tr4._multi.graph
    row = {"s11_tp_dispatch": "bert_f32", "k": S9_K, "graph_vs_eager": same,
           "dispatch_sums_equal": s9_grouped_equal(s1, s4),
           "graph_captures": graph.captures, "graph_replays": graph.replays,
           "eager": s9_timing(tr1, 1), "graph": s9_timing(tr4, S9_K)}
    emit(row)
    require(len(s1) == S11_STEPS and row["dispatch_sums_equal"]
            and same["bit_equal"] and graph.replays > 0,
            f"BERT tp graph run differs from step by step: {row}")
    return rows


def s11_gloo_rank(rank, port, out, cases, device):
    """One rank of (b): a gloo world of 2 on the one card, TP at M 2. For
    each case, S11_M2_STEPS SGD steps of TensorParallelEngine on the given
    batches; writes the per-step losses and ms (host-staged gloo), the
    gathered canonical parameters (rank 0), the qkv shard's shape and
    this rank's parameter bytes. A gloo that refuses CUDA tensors is
    reported, not faked."""
    import pickle

    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.models import bert
    from distributed_model_parallel_tpu_torch.parallel import (
        tensor_parallel as tp,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    result = {}
    try:
        probe = torch.ones(4, device=device)
        try:
            dist.all_reduce(probe)
        except RuntimeError as e:  # the issue's "gloo refuses CUDA" case
            result["gloo_cuda_refused"] = str(e)[:300]
        if "gloo_cuda_refused" not in result:
            mesh = make_mesh(MeshSpec(data=-1, model=2))
            for name, cfg, ids, labels in cases:
                eng = tp.TensorParallelEngine(
                    bert.bert_for_classification(4, cfg), SGD(), mesh,
                    device=device)
                ts = eng.init_state(0)
                losses, ms = [], []
                for _ in range(S11_M2_STEPS):
                    x = eng.shard_batch(ids, labels)
                    t0 = time.perf_counter()
                    ts, m = eng.train_step(ts, *x, S11_M2_LR)
                    # the float() read waits for the step
                    losses.append(float(m["loss_sum"] / m["count"]))
                    ms.append((time.perf_counter() - t0) * 1e3)
                canon = eng.to_canonical(ts)
                result[name] = {
                    "losses": losses, "host_staged_gloo_ms": ms,
                    "qkv_shard": tuple(ts.params["blocks"]["0"]["attn"][
                        "qkv"]["w"].shape),
                    "param_bytes": s11_param_bytes(ts),
                    "params": canon["params"] if rank == 0 else None}
    finally:
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(result, f)


def s11_param_bytes(ts) -> int:
    """Bytes of a state's parameters (this rank's shards)."""
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    return sum(t.numel() * t.element_size() for t in tree_leaves(ts.params))


def s11_m2_cases():
    import numpy as np

    from distributed_model_parallel_tpu_torch.cli.common import (
        _bert_tiny_cfg,
    )
    from distributed_model_parallel_tpu_torch.models import bert

    rng = np.random.RandomState(5)
    cases = []
    for name, cfg in (("bert_tiny", _bert_tiny_cfg()),
                      ("bert_base_width_2layer",
                       dataclasses.replace(bert.BERT_BASE, num_layers=2))):
        ids = rng.randint(1, min(cfg.vocab_size, 512), size=(64, 64))
        cases.append((name, cfg, ids.astype(np.int32),
                      rng.randint(0, 4, 64)))
    return cases


def s11_tp_m2() -> dict:
    """(b) TP at M 2 on the card: two processes over gloo (NCCL cannot
    put two ranks on one GPU), each holding its shards on the card, 3
    SGD steps of bert_tiny and of a 2-layer BERT_BASE-width model
    (dropout 0.1), against the M 1 engine on the card in this process:
    losses and the gathered parameters within S11_M2_TOL; the qkv shard
    (768, 1152) at BERT_BASE width. The ms print labelled as host-staged
    gloo times: not a TP time."""
    import multiprocessing
    import pickle

    import numpy as np

    from distributed_model_parallel_tpu_torch.models import bert
    from distributed_model_parallel_tpu_torch.models.convert import (
        train_state_to_jax,
    )
    from distributed_model_parallel_tpu_torch.parallel import (
        tensor_parallel as tp,
    )
    from distributed_model_parallel_tpu_torch.runtime.dist import free_port
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.checkpoint import (
        flatten_tree,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    cases = s11_m2_cases()
    torch.cuda.empty_cache()  # the two ranks share this process's card
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [scratch_dir(f"s11_m2_rank{r}.pkl") for r in range(2)]
    os.makedirs(os.path.dirname(outs[0]), exist_ok=True)
    procs = [ctx.Process(target=s11_gloo_rank,
                         args=(r, port, outs[r], cases, S11_DEVICE))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    require(not hung and all(p.exitcode == 0 for p in procs),
            f"TP M 2 ranks: exit codes {[p.exitcode for p in procs]}")
    got = []
    for path in outs:
        with open(path, "rb") as f:
            got.append(pickle.load(f))
    wall = time.perf_counter() - t0
    if "gloo_cuda_refused" in got[0]:
        emit({"s11_tp_m2": "not run: gloo refused CUDA tensors on this "
              "machine", "error": got[0]["gloo_cuda_refused"]})
        return {"gloo_cuda": False}
    row = {"s11_tp_m2": "gloo, 2 processes on one card", "gloo_cuda": True,
           "wall_s": wall}
    for name, cfg, ids, labels in cases:
        eng = tp.TensorParallelEngine(bert.bert_for_classification(4, cfg),
                                      SGD(), Mesh(1, None),
                                      device=S11_DEVICE)
        ts = eng.init_state(0)
        losses = []
        for _ in range(S11_M2_STEPS):
            ts, m = eng.train_step(ts, *eng.shard_batch(ids, labels),
                                   S11_M2_LR)
            losses.append(float(m["loss_sum"] / m["count"]))
        want = train_state_to_jax(ts)["params"]
        gw, ww = flatten_tree(got[0][name]["params"]), flatten_tree(want)
        params_close = all(np.allclose(gw[k], ww[k], **S11_M2_TOL)
                           for k in ww)
        worst = max(ww, key=lambda k: float(np.abs(gw[k] - ww[k]).max()))
        loss_rel = max(abs(a - b) / abs(b)
                       for r in got for a, b in zip(r[name]["losses"],
                                                    losses))
        row[name] = {
            "m1_losses": losses,
            "m2_losses": [r[name]["losses"] for r in got],
            "loss_max_rel": loss_rel, "params_within_bar": params_close,
            "bar": S11_M2_TOL, "param_max_abs_diff": {
                worst: float(np.abs(gw[worst] - ww[worst]).max())},
            "qkv_shard": [r[name]["qkv_shard"] for r in got],
            "per_rank_param_bytes": [r[name]["param_bytes"] for r in got],
            "m1_param_bytes": s11_param_bytes(ts),
            "host_staged_gloo_ms_per_step": [
                r[name]["host_staged_gloo_ms"] for r in got]}
        require(loss_rel <= S11_M2_TOL["rtol"] and params_close,
                f"TP M 2 {name} differs from M 1: {row[name]}")
        if cfg.hidden_size == 768:
            require(all(tuple(s) == (768, 1152)
                        for s in row[name]["qkv_shard"]),
                    f"qkv shards {row[name]['qkv_shard']}")
    emit(row)
    return row


def s11_run(main, flags, cls, name, steps):
    """`s10_run` plus the trainer's data wait a batch (ms)."""
    from distributed_model_parallel_tpu_torch.training import trainer as tr

    waits = []
    train_epoch = tr.Trainer.train_epoch

    def epoch(self, e):
        stats = train_epoch(self, e)
        waits.append(stats.data_time * 1e3)
        return stats

    with patched(tr.Trainer, "train_epoch", epoch):
        row, params, seen = s10_run(main, flags, cls, name, steps)
    row["trainer_data_wait_ms"] = sum(waits) / len(waits)
    return row, params, seen


def s11_cache_runs(dp_cli, dp_mod, data) -> dict:
    """(c) MobileNetV2 DDP at phase 11's flags, f32 and bf16, with and
    without `--device-cache`: ms a step, the trainer's data wait a batch,
    the host-to-device bytes a step (what `shard_batch` places), busy /
    idle, the cache's bytes on the card; the initial state's eval logits
    on one val batch through the cache and through the host loader; then
    bf16 `--device-cache --steps-per-dispatch 4` against its eager run,
    bit for bit (the crops are keyed by the step: a graph that froze the
    captured step's crops would differ)."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.cli.common import (
        build_index_loaders,
        build_loaders,
    )
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.models import layers as L
    from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
        mobilenet_v2,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    placed = []
    shard = dp_mod._DataParallel.shard_batch

    def counted(self, inputs, labels):
        placed.append((inputs.nbytes, labels.nbytes))
        return shard(self, inputs, labels)

    rows = {}
    with patched(datasets.DatasetCollection, "init", lambda self: data):
        with patched(dp_mod._DataParallel, "shard_batch", counted):
            for dtype in ("float32", "bfloat16"):
                for cached in (False, True):
                    name = (f"mobilenetv2_{dtype}_"
                            f"{'cache' if cached else 'host'}")
                    placed.clear()
                    row, _, seen = s11_run(
                        dp_cli.main, S11_CACHE_FLAGS + ["--dtype", dtype]
                        + (["--device-cache"] if cached else [])
                        + ["--checkpoint-dir", scratch_dir(f"s11_{name}")],
                        dp_mod._DataParallel, name, S10_STEPS)
                    tf = seen["engine"].input_transform
                    row = {"s11_cache_run": name,
                           **{k: v for k, v in row.items()
                              if k != "s10_run"}}
                    row["h2d_input_bytes_per_step"] = placed[0][0]
                    row["h2d_label_bytes_per_step"] = placed[0][1]
                    row["device_cache_bytes"] = (tf.cache.nbytes if cached
                                                 else 0)
                    row.update(s10_profile(seen, row["ms_per_step"]))
                    del row["flash_kernel_device_ms"]
                    emit(row)
                    rows[name] = row
                    del seen, tf
        want = sum(split.images.nbytes for split in data)
        require(rows["mobilenetv2_float32_cache"]["device_cache_bytes"]
                == want, f"the cache's bytes on the card, want {want}")
        # The initial state's eval logits on the first val batch.
        host_val = build_loaders("SyntheticTextures", "", DP_BATCH,
                                 val_batch_size=DP_BATCH)[1]
        _, idx_val, _, tf = build_index_loaders(
            "SyntheticTextures", "", DP_BATCH, S11_DEVICE,
            val_batch_size=DP_BATCH)
    model = mobilenet_v2(10)
    eng = dp_mod.DDPEngine(model, SGD(), mesh=Mesh(1, None),
                           device=S11_DEVICE)
    ts = eng.init_state(0)
    (hx, hy), (ix, iy) = next(iter(host_val)), next(iter(idx_val))
    with torch.no_grad():
        x_host = eng.shard_batch(hx, hy)[0]
        x_cache = tf(eng.shard_batch(ix, iy)[0], step=0, train=False)
        logits = [model.apply(ts.params, ts.model_state, x,
                              L.Context(train=False))[0]
                  for x in (x_host, x_cache)]
    reading = {"pixels_bit_equal": bool(torch.equal(x_host, x_cache)),
               "logit_max_rel": rel_diff(logits[1], logits[0]),
               "bar": S11_LOGIT_REL,
               "labels_equal": bool(np.array_equal(hy, iy))}
    emit({"s11_cache_vs_host_eval_logits": reading})
    require(reading["labels_equal"]
            and reading["logit_max_rel"] <= S11_LOGIT_REL,
            f"device cache eval logits differ from the host's: {reading}")
    del tf, eng, ts
    flags = S11_CACHE_FLAGS + ["--dtype", "bfloat16", "--device-cache"]
    runs = {}
    with patched(datasets.DatasetCollection, "init", lambda self: data):
        for k in (1, S9_K):
            d = scratch_dir(f"s11_cache_k{k}")
            extra = [] if k == 1 else ["--steps-per-dispatch", str(k)]
            runs[k] = s9_run(dp_cli.main, flags + extra + [
                "--checkpoint-dir", os.path.join(d, "ck")],
                dp_mod._DataParallel, d)
    (_, s1, tr1, _, _, _), (_, s4, tr4, _, _, _) = runs[1], runs[S9_K]
    same = s9_same(tr4.state, tr1.state)
    graph = tr4._multi.graph
    cache = tr1.engine.input_transform.cache
    idx = torch.arange(DP_BATCH, device=S11_DEVICE, dtype=torch.int32)
    draws = [torch.cat([d.long() for d in cache.augment_draws(idx, s)])
             for s in range(S9_K)]
    row = {"s11_cache_dispatch": "mobilenetv2_ddp_bf16_cache", "k": S9_K,
           "graph_vs_eager": same,
           "dispatch_sums_equal": s9_grouped_equal(s1, s4),
           "graph_captures": graph.captures, "graph_replays": graph.replays,
           "crops_differ_step_to_step": all(
               not torch.equal(draws[s], draws[s + 1])
               for s in range(S9_K - 1)),
           "eager": s9_timing(tr1, 1), "graph": s9_timing(tr4, S9_K)}
    emit(row)
    require(len(s1) == S10_STEPS and row["dispatch_sums_equal"]
            and same["bit_equal"] and graph.replays > 0
            and row["crops_differ_step_to_step"],
            f"device-cache graph run differs from step by step: {row}")
    return rows


def s11_image_folder(dp_cli, dp_mod) -> dict:
    """(d) With PIL: a 10-class tree of 64x64 PNGs (32 train and 8 val a
    class) and `--dataset-type Imagenet --model resnet18` for 4 steps on
    the card (images resized to 224, finite losses). Without PIL a line
    says so."""
    try:
        from PIL import Image
    except ImportError as e:
        row = {"s11_image_folder": "not run: PIL is not importable on "
               "this machine", "error": str(e)}
        emit(row)
        return row
    import numpy as np

    classes, n_train, n_val, side = S11_TREE
    root = scratch_dir("s11_tree")
    rng = np.random.RandomState(7)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(classes):
            d = os.path.join(root, "data", split, f"class{c:02d}")
            os.makedirs(d)
            for i in range(n):
                Image.fromarray(rng.randint(
                    0, 256, (side, side, 3)).astype(np.uint8)).save(
                    os.path.join(d, f"{i}.png"))
    with contextlib.chdir(root):
        out, steps, seen = recorded_run(dp_cli.main, S11_IMAGE_FLAGS + [
            "--data", "data", "--checkpoint-dir", "ck"],
            dp_mod._DataParallel)
    losses = [s["loss"] for s in steps]
    hist = out["history"][0]
    row = {"s11_image_folder": "Imagenet tree, resnet18", "steps": len(steps),
           "step_loss": losses, "step_ms": [s["ms"] for s in steps],
           "val_loss": hist["val"]["loss"], "val_count": hist["val"]["count"],
           "input_shape": list(seen["batch"][0].shape)}
    emit(row)
    require(len(steps) == 4 and all(map(math.isfinite, losses))
            and math.isfinite(hist["val"]["loss"])
            and row["input_shape"][1:] == [224, 224, 3],
            f"image-folder run: {row}")
    return row


def slice11_phase(fa, qm, dp_data) -> dict:
    """Phase 12 (module docstring). Returns the K1-K4 launches of the
    phase's main paths (none lies on them)."""
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    data = s11_cut_val(dp_data)
    reset_counts(fa, qm)
    t0 = time.perf_counter()
    s11_tp_runs(data_parallel, dp_mod, data)
    print(f"phase 12 (a) TP at M 1: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    s11_tp_m2()
    print(f"phase 12 (b) TP at M 2 over gloo: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    s11_cache_runs(data_parallel, dp_mod, data)
    print(f"phase 12 (c) device cache: {time.perf_counter() - t0:.1f} s",
          flush=True)
    s11_image_folder(data_parallel, dp_mod)
    got = dict(counts(fa), int8_matmul=qm.int8_matmul.launches)
    emit({"s11_k1_k4_launches": got})
    require(not any(got.values()),
            f"the runs of phase 12 launched K1-K4: {got}")
    torch.distributed.destroy_process_group()
    return got


# ---------------------------------------------------------------------
# Slice 12: FSDP, the sharded checkpoint format, elastic restart

S12_STEPS = 2  # 8 until phase 15 was added
# BERT_BASE, batch 512, AdamW 1e-3, dropout 0.1, 1 x 2 (S11_BERT's 1 x 4
# for the dispatch run)
S12_BERT = S11_BERT[:-1] + [str(S12_STEPS)]
S12_BERT_MODES = (("monolithic", []),
                  ("bucketed", ["--grad-reduction", "bucketed"]),
                  ("overlapped", ["--grad-reduction", "overlapped"]))
S12_DP = DP_FLAGS[:DP_FLAGS.index("--steps-per-epoch")] + [
    "--steps-per-epoch", str(S12_STEPS)]  # MobileNetV2
S12_DP_MODES = S10_DP_MODES
S12_ENGINES = ("fsdp", "ddp")
# (b): N 2 against N 1 at the f32 bar, SGD (S11_M2_*); dropout 0, as the
# dropout keys fold the data rank and N 2 draws other masks than N 1. The
# int8 dcn run's bars, as phase 16 (c)'s: its losses against N 1's
# (relative), each parameter leaf's distance from N 1's over the
# distance N 1's own steps moved it (Frobenius norms, the worst leaf),
# and the same over all leaves at once, each set near the geometric mean
# of the sound wire's reading and a broken wire's (the weight gather's
# coded hops zeroed), both measured on the card by `chip_smoke_probe.py
# fsdp`: sound 0.0262 / 0.848 / 0.258, broken 0.0557 / 1.051 / 0.959
# (one H100, PERF.md section 6). The loss bar was 5e-2 before.
S12_M2_INT8_LOSS_REL = 0.038
S12_M2_INT8_PARAM_REL = 0.94
S12_M2_INT8_PARAM_ALL_REL = 0.5
# (c): the sharded resumes, MobileNetV2, 2 epochs of 4 steps
S12_CK_STEPS = 4
S12_CK = DP_FLAGS[:DP_FLAGS.index("--epochs")] + [
    "--steps-per-epoch", str(S12_CK_STEPS), "--checkpoint-format",
    "sharded", "--async-save"]
S12_LM = CK_LM_FLAGS + ["--checkpoint-format", "sharded", "--async-save"]


def s12_fsdp_runs(dp_cli, dp_mod, data) -> list:
    """(a) FSDP at world 1 on NCCL against DDP at the same flags: BERT_BASE
    f32 and bf16 and MobileNetV2 f32, each mode; f32 losses and final
    parameters bit-equal, bf16 printed; then BERT f32 fsdp bucketed under
    `--steps-per-dispatch 4`, bit-equal to its eager run."""
    from distributed_model_parallel_tpu_torch.data import datasets

    rows = []
    plan = (("bert", S12_BERT, S12_BERT_MODES, ("float32", "bfloat16")),
            ("mobilenetv2", S12_DP, S12_DP_MODES, ("float32",)))
    for model, flags, modes, dtypes in plan:
        for dtype in dtypes:
            for mode, extra in modes:
                runs = {}
                for engine in S12_ENGINES:
                    name = f"{model}_{engine}_{mode}_{dtype}"
                    with patched(datasets.DatasetCollection, "init",
                                 lambda self: data) if model != "bert" \
                            else contextlib.nullcontext():
                        row, params, seen = s10_run(
                            dp_cli.main, flags + [
                                "--dtype", dtype, "--engine", engine] + extra
                            + ["--checkpoint-dir",
                               scratch_dir(f"s12_{name}")],
                            dp_mod._DataParallel, name, S12_STEPS)
                    eng = seen["engine"]
                    row = {"s12_run": name, **{
                        k: v for k, v in row.items() if k != "s10_run"}}
                    # the gradient collectives and FSDP's weight gathers
                    row["collectives_per_step"] = (
                        eng.grad_reductions
                        + getattr(eng, "param_gathers", 0)) / S12_STEPS
                    row["samples_per_s"] = DP_BATCH / row["ms_per_step"] * 1e3
                    row.update(s10_profile(seen, row["ms_per_step"]))
                    del row["flash_kernel_device_ms"]
                    emit(row)
                    rows.append(row)
                    runs[engine] = (row, params)
                    del seen, eng
                (fs, fs_p), (dd, dd_p) = runs["fsdp"], runs["ddp"]
                same = {"losses_bit_equal": fs["step_loss"] == dd["step_loss"],
                        "params_bit_equal": all(
                            torch.equal(a, b) for a, b in zip(fs_p, dd_p)),
                        "params_max_rel": max(rel_diff(a, b)
                                              for a, b in zip(fs_p, dd_p))}
                emit({"s12_fsdp_vs_ddp": f"{model}_{mode}_{dtype}", **same})
                if dtype == "float32":
                    require(same["losses_bit_equal"]
                            and same["params_bit_equal"],
                            f"{model} {mode} f32: fsdp at world 1 differs "
                            f"from ddp: {same}")
    d1, d4 = scratch_dir("s12_bert_k1"), scratch_dir(f"s12_bert_k{S9_K}")
    flags = S11_BERT + ["--engine", "fsdp", "--grad-reduction", "bucketed",
                        "--checkpoint-dir", "ck"]
    (_, s1, tr1, _, _, _), (_, s4, tr4, _, _, _) = (
        s9_run(dp_cli.main, flags, dp_mod._DataParallel, d1),
        s9_run(dp_cli.main, flags + ["--steps-per-dispatch", str(S9_K)],
               dp_mod._DataParallel, d4))
    same = s9_same(tr4.state, tr1.state)
    graph = tr4._multi.graph
    row = {"s12_fsdp_dispatch": "bert_f32_bucketed", "k": S9_K,
           "graph_vs_eager": same,
           "dispatch_sums_equal": s9_grouped_equal(s1, s4),
           "graph_captures": graph.captures, "graph_replays": graph.replays}
    emit(row)
    require(len(s1) == S11_STEPS and row["dispatch_sums_equal"]
            and same["bit_equal"] and graph.replays > 0,
            f"BERT fsdp graph run differs from step by step: {row}")
    return rows


def s12_state_bytes(ts) -> int:
    """Bytes of a state's parameters and optimizer tensors (this rank's
    shards)."""
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    return sum(t.numel() * t.element_size()
               for t in tree_leaves((ts.params, tuple(ts.opt_state)))
               if isinstance(t, torch.Tensor))


def s12_m2_case():
    """The 2-layer BERT_BASE-width model without dropout, and a seeded
    global batch of 64 sequences of 64 tokens."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models import bert

    cfg = dataclasses.replace(bert.BERT_BASE, num_layers=2, dropout_rate=0.0)
    rng = np.random.RandomState(5)
    return (cfg, rng.randint(1, 512, size=(64, 64)).astype(np.int32),
            rng.randint(0, 4, 64).astype(np.int32))


def s12_fsdp_steps(eng, ids, labels, rank: int, world: int):
    """S11_M2_STEPS SGD steps on this rank's rows; (state, losses, ms)."""
    ts = eng.init_state(0)
    b = len(labels) // world
    x = eng.shard_batch(ids[rank * b:(rank + 1) * b],
                        labels[rank * b:(rank + 1) * b])
    losses, ms = [], []
    for _ in range(S11_M2_STEPS):
        t0 = time.perf_counter()
        ts, m = eng.train_step(ts, *x, S11_M2_LR)
        losses.append(float(m["loss_sum"] / m["count"]))  # waits
        ms.append((time.perf_counter() - t0) * 1e3)
    return ts, losses, ms


def s12_gloo_rank(rank, port, out, directory, device):
    """One rank of (b): a gloo world of 2 on the one card. FSDP SGD steps
    on `MeshSpec(data=2)`, saved as a sharded checkpoint into
    `directory`; then on `MeshSpec(dcn=2)` with the int8 wire; and the
    AdamW state's bytes on this rank. Writes the losses, host-staged ms,
    the gathered canonical parameters (rank 0) and the bytes."""
    import pickle

    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.models import bert
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        AdamW,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    result = {}
    try:
        cfg, ids, labels = s12_m2_case()
        model = bert.bert_for_classification(4, cfg)
        eng = FSDPEngine(model, SGD(), make_mesh(MeshSpec()), device=device)
        ts, losses, ms = s12_fsdp_steps(eng, ids, labels, rank, 2)
        checkpointing.save_sharded(directory, eng.to_canonical_sharded(ts),
                                   acc=0.0, epoch=0)
        dist.barrier()
        canon = eng.to_canonical(ts)
        result["mono"] = {"losses": losses, "host_staged_gloo_ms": ms,
                          "params": canon["params"] if rank == 0 else None,
                          "param_gathers": eng.param_gathers}
        eng = FSDPEngine(model, SGD(), make_mesh(MeshSpec(dcn=2)),
                         device=device, dcn_compression="int8")
        ts, losses, ms = s12_fsdp_steps(eng, ids, labels, rank, 2)
        canon = eng.to_canonical(ts)
        result["int8"] = {"losses": losses, "host_staged_gloo_ms": ms,
                          "params": canon["params"] if rank == 0 else None}
        eng = FSDPEngine(model, AdamW(), make_mesh(MeshSpec()),
                         device=device)
        result["adamw_state_bytes"] = s12_state_bytes(eng.init_state(0))
    finally:
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(result, f)


def s12_fsdp_m2() -> dict:
    """(b) FSDP at N 2 as two gloo processes on the one card (NCCL puts
    one rank on a GPU), against N 1 on the card in this process: losses
    and gathered parameters within S11_M2_TOL; with the int8 wire on a
    dcn 2 mesh, losses within S12_M2_INT8_LOSS_REL and rank 0's gathered
    parameters, leaf by leaf, off N 1's by at most S12_M2_INT8_PARAM_REL
    of N 1's own update (S12_M2_INT8_PARAM_ALL_REL over all leaves);
    per-rank parameter + AdamW bytes
    against N 1. The ms are host-staged gloo, not FSDP times. Returns
    the directory of the N 2 sharded checkpoint and rank 0's gathered
    parameters."""
    import multiprocessing
    import pickle

    import numpy as np

    from distributed_model_parallel_tpu_torch.models import bert
    from distributed_model_parallel_tpu_torch.models.convert import (
        train_state_to_jax,
    )
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.dist import free_port
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.checkpoint import (
        flatten_tree,
    )
    from distributed_model_parallel_tpu_torch.training.optim import (
        SGD,
        AdamW,
    )

    torch.cuda.empty_cache()  # the two ranks share this process's card
    directory = scratch_dir("s12_m2_sharded")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [scratch_dir(f"s12_m2_rank{r}.pkl") for r in range(2)]
    procs = [ctx.Process(target=s12_gloo_rank,
                         args=(r, port, outs[r], directory, S11_DEVICE))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    require(not hung and all(p.exitcode == 0 for p in procs),
            f"FSDP N 2 ranks: exit codes {[p.exitcode for p in procs]}")
    got = []
    for path in outs:
        with open(path, "rb") as f:
            got.append(pickle.load(f))
    wall = time.perf_counter() - t0
    cfg, ids, labels = s12_m2_case()
    model = bert.bert_for_classification(4, cfg)
    eng = FSDPEngine(model, SGD(), Mesh(1, None), device=S11_DEVICE)
    init = flatten_tree(train_state_to_jax(eng.init_state(0))["params"])
    ts, losses, ms = s12_fsdp_steps(eng, ids, labels, 0, 1)
    want = train_state_to_jax(ts)["params"]
    gw, ww = flatten_tree(got[0]["mono"]["params"]), flatten_tree(want)
    params_close = all(np.allclose(gw[k], ww[k], **S11_M2_TOL) for k in ww)
    worst = max(ww, key=lambda k: float(np.abs(gw[k] - ww[k]).max()))
    rel = {run: max(abs(a - b) / abs(b) for r in got
                    for a, b in zip(r[run]["losses"], losses))
           for run in ("mono", "int8")}
    # the int8 wire: each leaf's distance from N 1 over the distance N 1's
    # own steps moved it (the worst leaf)
    g8 = flatten_tree(got[0]["int8"]["params"])
    moved, offs, steps = {}, {}, {}
    for k, v in ww.items():
        steps[k] = float(np.linalg.norm(v - init[k]))
        offs[k] = float(np.linalg.norm(g8[k] - v))
        moved[k] = (offs[k] / steps[k] if steps[k]
                    else (0.0 if offs[k] == 0 else math.inf))
    far = max(moved, key=moved.get)
    mats = [k for k in ww if ww[k].ndim == 2]
    spread = {
        "int8_param_off_over_update_all_leaves": math.sqrt(
            sum(o * o for o in offs.values())
            / sum(t * t for t in steps.values())),
        "int8_param_off_over_update_median": float(np.median(
            list(moved.values()))),
        "int8_param_off_over_update_worst_matrix": max(
            moved[k] for k in mats)}
    n1_bytes = s12_state_bytes(FSDPEngine(model, AdamW(), Mesh(1, None),
                                          device=S11_DEVICE).init_state(0))
    row = {"s12_fsdp_m2": "gloo, 2 processes on one card", "wall_s": wall,
           "model": "BERT_BASE width, 2 layers, dropout 0, SGD",
           "n1_losses": losses, "n1_ms": ms,
           "n2_losses": [r["mono"]["losses"] for r in got],
           "loss_max_rel": rel["mono"], "params_within_bar": params_close,
           "bar": S11_M2_TOL, "param_max_abs_diff": {
               worst: float(np.abs(gw[worst] - ww[worst]).max())},
           "int8_dcn2_losses": [r["int8"]["losses"] for r in got],
           "int8_loss_max_rel": rel["int8"],
           "int8_loss_bar": S12_M2_INT8_LOSS_REL,
           "int8_param_off_over_update": moved[far],
           "int8_param_off_over_update_leaf": far,
           "int8_param_bar": S12_M2_INT8_PARAM_REL, **spread,
           "int8_param_all_leaves_bar": S12_M2_INT8_PARAM_ALL_REL,
           "param_gathers_per_step": got[0]["mono"]["param_gathers"]
           / S11_M2_STEPS,
           "per_rank_param_adamw_bytes": [r["adamw_state_bytes"]
                                          for r in got],
           "n1_param_adamw_bytes": n1_bytes,
           "per_rank_over_n1": got[0]["adamw_state_bytes"] / n1_bytes,
           "host_staged_gloo_ms_per_step": [
               r["mono"]["host_staged_gloo_ms"] for r in got],
           "int8_host_staged_gloo_ms_per_step": [
               r["int8"]["host_staged_gloo_ms"] for r in got]}
    emit(row)
    require(rel["mono"] <= S11_M2_TOL["rtol"] and params_close,
            f"FSDP N 2 differs from N 1: {row}")
    require(rel["int8"] <= S12_M2_INT8_LOSS_REL,
            f"FSDP N 2 int8 wire: losses off N 1's: {row}")
    require(moved[far] <= S12_M2_INT8_PARAM_REL
            and spread["int8_param_off_over_update_all_leaves"]
            <= S12_M2_INT8_PARAM_ALL_REL,
            f"FSDP N 2 int8 wire: parameters off N 1's: {row}")
    return directory, got[0]["mono"]["params"]


@contextlib.contextmanager
def s12_save_timing(records):
    """Each save's time in the epoch loop (`checkpoint_blocked`, the
    snapshot under --async-save) and each shard file's write on the
    writer thread, in ms."""
    from distributed_model_parallel_tpu_torch.checkpointing import (
        writer as writer_mod,
    )
    from distributed_model_parallel_tpu_torch.training import trainer

    write_checkpoint = trainer.Trainer._write_checkpoint
    write_shard = writer_mod._write_shard

    def blocked(self, payload, name, epoch):
        t0 = time.perf_counter()
        write_checkpoint(self, payload, name, epoch)
        records.append({"part": "blocked",
                        "ms": (time.perf_counter() - t0) * 1e3})

    def shard(path, arrays):
        t0 = time.perf_counter()
        write_shard(path, arrays)
        records.append({"part": "shard_write", "bytes":
                        os.path.getsize(path),
                        "ms": (time.perf_counter() - t0) * 1e3})

    with patched(trainer.Trainer, "_write_checkpoint", blocked), \
            patched(writer_mod, "_write_shard", shard):
        yield


def s12_io(records, directory) -> dict:
    files = sorted(os.listdir(directory))
    return {"blocked_ms": [r["ms"] for r in records
                           if r["part"] == "blocked"],
            "shard_write_ms": [r["ms"] for r in records
                               if r["part"] == "shard_write"],
            "shard_bytes": max((r["bytes"] for r in records
                                if "bytes" in r), default=None),
            "files": files}


def s12_fail_once(epoch: int):
    """Trainer.train_epoch failing once at the start of `epoch`."""
    from distributed_model_parallel_tpu_torch.training import trainer

    train_epoch = trainer.Trainer.train_epoch
    failed = []

    def failing(self, e):
        if e == epoch and not failed:
            failed.append(e)
            raise RuntimeError(f"injected failure in epoch {e}")
        return train_epoch(self, e)

    return patched(trainer.Trainer, "train_epoch", failing)


def s12_sharded_dp(dp_cli, dp_mod, data, m2_dir, m2_params) -> dict:
    """(c) MobileNetV2 ddp and fsdp through the DP CLI, sharded format
    with --async-save: two epochs straight against one then --resume,
    per-step losses and the epoch-1 record equal; fsdp --max-restarts 1
    with a failure injected at epoch 1 equal to straight; (b)'s N 2 file
    restored at N 1 on the card, bit-exact."""
    import numpy as np

    from distributed_model_parallel_tpu_torch import checkpointing
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.models import bert
    from distributed_model_parallel_tpu_torch.parallel.fsdp import (
        FSDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.checkpoint import (
        flatten_tree,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    readings = {}
    for engine in S12_ENGINES:
        runs, records = {}, []
        plan = [("straight", ["--epochs", "2"], "straight", None),
                ("split_1", ["--epochs", "1"], "split", None),
                ("split_2", ["--epochs", "2", "--resume"], "split", None)]
        if engine == "fsdp":
            plan.append(("restart", ["--epochs", "2", "--max-restarts",
                                     "1"], "restart", 1))
        with patched(datasets.DatasetCollection, "init",
                     lambda self: data), s12_save_timing(records):
            for name, extra, where, fail in plan:
                with s12_fail_once(fail) if fail is not None \
                        else contextlib.nullcontext():
                    out, steps, _ = recorded_run(
                        dp_cli.main, S12_CK + ["--engine", engine] + extra
                        + ["--checkpoint-dir",
                           scratch_dir(f"s12_ck_{engine}_{where}")],
                        dp_mod._DataParallel)
                runs[name] = {"history": epoch_numbers(out["history"]),
                              "losses": [s["loss"] for s in steps],
                              "elastic": out.get("elastic")}
        straight = runs["straight"]
        split = runs["split_1"]["losses"] + runs["split_2"]["losses"]
        r = {"resume_losses_equal": split == straight["losses"],
             "resume_epoch1_equal": runs["split_2"]["history"]
             == straight["history"][1:],
             **s12_io(records, scratch_dir(f"s12_ck_{engine}_straight"))}
        if engine == "fsdp":
            rs = runs["restart"]
            r["restart_losses_equal"] = rs["losses"] == straight["losses"]
            r["restart_epoch1_equal"] = rs["history"] == \
                straight["history"][1:]
            r["elastic"] = rs["elastic"]
        emit({"s12_sharded_resume": f"mobilenetv2_{engine}", **r})
        require(len(straight["losses"]) == 2 * S12_CK_STEPS
                and r["resume_losses_equal"] and r["resume_epoch1_equal"],
                f"{engine}: one epoch + --resume differs from two straight")
        if engine == "fsdp":
            require(r["restart_losses_equal"] and r["restart_epoch1_equal"]
                    and r["elastic"]["attempts"] == 2,
                    f"fsdp --max-restarts 1 differs from straight: {r}")
        readings[engine] = r
    torch.distributed.destroy_process_group()
    cfg, _, _ = s12_m2_case()
    eng = FSDPEngine(bert.bert_for_classification(4, cfg), SGD(),
                     Mesh(1, None), device=S11_DEVICE)
    like = eng.init_state(1)
    t0 = time.perf_counter()
    tree, _, _ = checkpointing.restore_checkpoint(m2_dir,
                                                  eng.canonical_spec(like))
    ts = eng.from_canonical(tree, like)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    got = flatten_tree(eng.to_canonical(ts)["params"])
    want = flatten_tree(m2_params)
    exact = all(np.array_equal(got[k], want[k]) for k in want)
    m = checkpointing.load_manifest(m2_dir)
    row = {"s12_reshard_n2_to_n1": exact, "restore_ms": restore_ms,
           "saved_topology": checkpointing.saved_topology(m2_dir),
           "files": m.shards}
    emit(row)
    require(exact and m.mesh_axes["data"] == 2,
            f"the N 2 sharded file restored at N 1 differs: {row}")
    readings["reshard"] = row
    return readings


def s12_lm(lm, engine_cls, fa, qm, legacy) -> dict:
    """(d) The LM CLI at GPT-2-small width (phase 7's flags) under
    `--checkpoint-format sharded --async-save`: 2 + 2 steps across
    --resume, bit-equal to phase 7's 4 straight steps of the same
    training (`legacy`, its reading); exact K1-K3 launches; the time
    each save held the loop against phase 7's legacy saves of the same
    state in this run."""
    import functools

    runs, records, launches = {}, [], {}
    plan = (("split_1", ["--epochs", "1"]),
            ("split_2", ["--epochs", "2", "--resume"]))
    with s12_save_timing(records), patched(
            lm, "TrainerConfig",
            functools.partial(lm.TrainerConfig, save_last=True)):
        for name, extra in plan:
            reset_counts(fa, qm)
            out, rec, _ = recorded_run(
                lm.main, S12_LM + extra + [
                    "--checkpoint-dir", scratch_dir("s12_lm")], engine_cls)
            got = counts(fa)
            want = {"flash_fwd": LAYERS * (2 + LM_VAL_BATCHES),
                    "flash_bwd_dq": LAYERS * 2, "flash_bwd_dkv": LAYERS * 2}
            require(got == want, f"LM sharded run {name}: kernel launches "
                    f"{got}, want {want}")
            require(qm.int8_matmul.launches == 0,
                    f"LM sharded run {name} launched int8")
            launches[name] = got
            runs[name] = {"history": epoch_numbers(out["history"]),
                          "losses": [s["loss"] for s in rec]}
    split = runs["split_1"]["losses"] + runs["split_2"]["losses"]
    reading = {
        "straight_losses_phase7": legacy["losses"], "resumed_losses": split,
        "resume_losses_equal": split == legacy["losses"],
        "resume_epoch1_equal": runs["split_2"]["history"]
        == legacy["epochs"][1:],
        "launches": launches,
        **s12_io(records, scratch_dir("s12_lm")),
        "legacy_save_ms_phase7": legacy["save_checkpoint_ms"],
        "legacy_copy_ms_phase7": legacy["train_state_to_jax_ms"],
        "legacy_file_bytes_phase7": legacy["file_bytes"]}
    emit({"s12_lm_sharded_resume": reading})
    shutil.rmtree(scratch_dir("s12_lm"), ignore_errors=True)
    require(len(split) == 4 and reading["resume_losses_equal"]
            and reading["resume_epoch1_equal"],
            "LM 2 + 2 steps across a sharded --resume differ from phase "
            "7's 4 straight steps")
    return {name: sum(r[name] for r in launches.values())
            for name, _, _ in FLASH_KERNELS}


def slice12_phase(lm, engine_cls, fa, qm, dp_data, legacy) -> dict:
    """Phase 13 (module docstring). Returns the K1-K4 launches of the
    phase's main paths: K1-K3 on the LM run, none on the DP runs."""
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    data = s11_cut_val(dp_data)
    reset_counts(fa, qm)
    t0 = time.perf_counter()
    with without_saves():
        s12_fsdp_runs(data_parallel, dp_mod, data)
    print(f"phase 13 (a) FSDP at world 1: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    m2_dir, m2_params = s12_fsdp_m2()
    print(f"phase 13 (b) FSDP at N 2 over gloo: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    s12_sharded_dp(data_parallel, dp_mod, data, m2_dir, m2_params)
    got = dict(counts(fa), int8_matmul=qm.int8_matmul.launches)
    require(not any(got.values()),
            f"the DP runs of phase 13 launched K1-K4: {got}")
    print(f"phase 13 (c) sharded DP checkpoints: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = s12_lm(lm, engine_cls, fa, qm, legacy)
    launches["int8_matmul"] = 0
    print(f"phase 13 (d) LM sharded resume: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


S13_STEPS = 2  # 3 until phase 16 was added
S13_LR = 0.05
S13_LM = LM_BASE + ["--optimizer", "sgd", "--lr", str(S13_LR), "--epochs",
                    "1", "--steps-per-epoch", str(S13_STEPS)]
S13_RUNS = (  # (name, layers, extra flags), each at --seq-shards 2 and 1
    ("ring_flash_f32", 4, ["--attention", "ring_flash"]),  # 12, then 6
    # until phases 15 and 16 were added
    ("ring_flash_bf16", 2, ["--attention", "ring_flash", "--dtype",
                            "bfloat16"]),  # 4 layers until phase 15
    ("ulysses_flash_f32", 2, ["--attention", "ulysses_flash"]),  # and 4
    ("ring_f32", 2, ["--attention", "ring"]),
    ("ulysses_f32", 2, ["--attention", "ulysses"]),
    ("ring_flash_bucketed_f32", 2, ["--attention", "ring_flash",
                                    "--grad-reduction", "bucketed"]),
)
# (name, B, T, H, Dh, mask kind, causal): K1-K3 at the shapes the rings
# give them at GPT-2-small width, T 1024, N 2: ring_flash's resident block
# (causal) and a visible hop (non-causal, a padded key mask) at T/N rows,
# ulysses_flash's whole sequence over H/N heads.
S13_HOP_CASES = (
    ("ring_resident", 8, 512, 12, 64, "all", True),
    ("ring_hop", 8, 512, 12, 64, "random", False),
    ("ulysses_heads", 8, 1024, 6, 64, "all", True),
)
S13_BERT = (32, 128, 0.05)  # (batch, T, lr) of (c), 3 SGD steps


def s13_sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def s13_flat(tree) -> dict:
    """A parameter tree's leaves by path, copied to the host."""
    from distributed_model_parallel_tpu_torch.training.optim import (
        tree_leaves,
    )

    return dict(zip(leaf_names(tree), (t.detach().float().cpu().clone()
                                        for t in tree_leaves(tree))))


def s13_lm_run(lm, engine_cls, flags, directory, device, init=False):
    """`lm.main(flags)` with each train step timed (synchronized):
    (per-step losses and ms, the engine, state, batch and lr of the last
    step, the history). With `init`, `seen["init"]` holds the canonical
    parameters before the first step (numpy, by `leaf_names`)."""
    steps, seen = [], {}
    train_step = engine_cls.train_step

    def recorded(self, ts, *batch_lr):
        if init and "init" not in seen:
            tree = self.to_canonical(ts)["params"]  # numpy
            seen["init"] = {n: v.copy() for n, v in zip(
                leaf_names(tree), optim_leaves(tree))}
        s13_sync(device)
        t0 = time.perf_counter()
        ts, m = train_step(self, ts, *batch_lr)
        loss = float(m["loss_sum"] / m["count"])  # waits for the step
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "loss": loss})
        seen.update(engine=self, state=ts, batch=batch_lr[:-1],
                    lr=batch_lr[-1])
        return ts, m

    with patched(engine_cls, "train_step", recorded), without_saves(), \
            contextlib.redirect_stdout(io.StringIO()):
        out = lm.main(flags + ["--checkpoint-dir", directory])
    shutil.rmtree(directory, ignore_errors=True)
    return steps, seen, out["history"]


def s13_want(name, layers, s_idx):
    """The exact K1-K3 launches of one N 2 run on seq rank `s_idx`: a
    ring_flash rank runs its resident block and its s visible hops a
    layer, K1 in every train and val step, K2 / K3 in every train step;
    ulysses_flash runs each layer's whole sequence once; the plain cores
    none; K4 never runs."""
    per = (s_idx + 1 if "ring_flash" in name else
           1 if "ulysses_flash" in name else 0) * layers
    return {"flash_fwd": per * (S13_STEPS + LM_VAL_BATCHES),
            "flash_bwd_dq": per * S13_STEPS,
            "flash_bwd_dkv": per * S13_STEPS, "int8_matmul": 0}


def s13_bert_want() -> dict:
    """(c)'s K1-K4 launches a rank: 2 layers x 2 pairs (the resident
    block and the one hop, non-causal) a train step; no K4."""
    return {**{k: 2 * 2 * S11_M2_STEPS for k, _, _ in FLASH_KERNELS},
            "int8_matmul": 0}


def s13_counts(fa, qm) -> dict:
    """This process's K1-K4 launches."""
    return {**counts(fa), "int8_matmul": qm.int8_matmul.launches}


def s13_bert_case():
    """(c): the 2-layer BERT_BASE-width model without dropout, and a
    seeded global batch with padded tails (the key masks)."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models import bert

    b, t, _ = S13_BERT
    cfg = dataclasses.replace(bert.BERT_BASE, num_layers=2, dropout_rate=0.0)
    rng = np.random.RandomState(13)
    ids = rng.randint(1, 512, size=(b, t)).astype(np.int32)
    for i in range(b):  # 0..t/2-1 pad positions at each row's end
        ids[i, t - (i * 7) % (t // 2):] = 0
    return cfg, ids, rng.randint(0, 4, b).astype(np.int32)


def s13_gloo_rank(rank, port, out, directory, runs, device):
    """One rank of (a) and (c): a gloo world of 2 on the one card, which
    it joins before `cli/lm.main` does (`initialize_backend` is
    idempotent). For each run of `runs`, the LM CLI at --seq-shards 2:
    per-step losses and host-staged ms, the K1-K4 launches, one profiled
    step's device busy, and the final parameters saved under `directory`
    (`<run>_<rank>.pt`); then `SequenceParallelEngine` (ring_flash) on
    the BERT case. A gloo that refuses CUDA tensors is reported, not
    faked."""
    import pickle

    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.cli import lm
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm
    from distributed_model_parallel_tpu_torch.parallel import (
        sequence_parallel as sp,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    result = {}
    corpus_once = contextlib.ExitStack()  # the rank's LM CLI runs
    corpus_once.enter_context(lm_corpus_made_once())
    try:
        probe = torch.ones(4, device=device)
        try:
            dist.all_reduce(probe)
        except RuntimeError as e:
            result["gloo_cuda_refused"] = str(e)[:300]
        for name, layers, flags in ([] if result else runs):
            reset_counts(fa, qm)
            steps, seen, hist = s13_lm_run(
                lm, sp.CausalLMSequenceParallelEngine, flags,
                os.path.join(directory, f"ck_{name}_{rank}"), device)
            got = s13_counts(fa, qm)
            torch.save(s13_flat(seen["state"].params),
                       os.path.join(directory, f"{name}_{rank}.pt"))
            ms = [s["ms"] for s in steps]
            row = {"losses": [s["loss"] for s in steps],
                   "host_staged_gloo_ms": ms, "launches": got,
                   "val_loss": hist[0]["val"]["loss"]}
            if device == "cuda" and name == runs[0][0]:
                # one more step of the first run, profiled on both ranks
                brk = step_breakdown(seen, sum(ms[1:]) / len(ms[1:]))
                row.update(device_busy_ms=brk["device_busy_ms"],
                           flash_kernel_device_ms=brk[
                               "flash_kernel_device_ms"])
            result[name] = row
        if not result.get("gloo_cuda_refused"):
            reset_counts(fa, qm)
            cfg, ids, labels = s13_bert_case()
            eng = sp.SequenceParallelEngine(
                cfg, 4, SGD(), mesh=make_mesh(MeshSpec(data=-1, seq=2)),
                attention="ring_flash", device=device)
            ts = eng.init_state(0)
            x = eng.shard_batch(ids, labels)
            losses, ms = [], []
            for _ in range(S11_M2_STEPS):
                t0 = time.perf_counter()
                ts, m = eng.train_step(ts, *x, S13_BERT[2])
                losses.append(float(m["loss_sum"] / m["count"]))  # waits
                ms.append((time.perf_counter() - t0) * 1e3)
            result["bert"] = {"losses": losses, "host_staged_gloo_ms": ms,
                              "launches": s13_counts(fa, qm)}
            torch.save(s13_flat(ts.params),
                       os.path.join(directory, f"bert_{rank}.pt"))
    finally:
        corpus_once.close()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(result, f)


def s13_compare(directory, name, want) -> dict:
    """The ranks' final parameters of run `name` (host trees they saved):
    rank 1's must equal rank 0's bit for bit (replicas over seq), and
    rank 0's are held against this process's `want`: within
    S11_M2_TOL, and the worst leaf."""
    import numpy as np

    got, other = (torch.load(os.path.join(directory, f"{name}_{r}.pt"))
                  for r in range(2))
    require(got.keys() == other.keys()
            and all(torch.equal(got[k], other[k]) for k in got),
            f"SP N 2 {name}: seq rank 1's parameters differ from rank 0's")
    diff = {k: float((got[k] - want[k]).abs().max()) for k in want}
    worst = max(diff, key=diff.get)
    close = all(np.allclose(got[k].numpy(), want[k].numpy(), **S11_M2_TOL)
                for k in want)
    return {"params_within_bar": close, "worst_leaf": worst,
            "worst_abs_diff": diff[worst]}


def s13_m2(lm, engine_cls, runs, device) -> dict:
    """(a) and (c): the two gloo ranks run every N 2 run while this
    process runs each at --seq-shards 1 (and the BERT case on
    `DDPEngine` at N 1); then the comparisons. Returns the K1-K4
    launches the ranks' runs made, summed over both ranks."""
    import multiprocessing
    import pickle

    from distributed_model_parallel_tpu_torch.models import bert
    from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
        DDPEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.dist import free_port
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training.optim import SGD

    torch.cuda.empty_cache()  # the two ranks share this process's card
    directory = scratch_dir("s13_m2")
    os.makedirs(directory, exist_ok=True)
    n2 = [(name, layers, S13_LM + ["--layers", str(layers), "--seq-shards",
                                   "2"] + extra)
          for name, layers, extra in runs]
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(directory, f"rank{r}.pkl") for r in range(2)]
    procs = [ctx.Process(target=s13_gloo_rank,
                         args=(r, port, outs[r], directory, n2, device))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    # N 1 in this process meanwhile (world 1 on NCCL)
    n1 = {}
    for name, layers, extra in runs:
        steps, seen, _ = s13_lm_run(
            lm, engine_cls, S13_LM + ["--layers", str(layers)] + extra,
            scratch_dir(f"s13_n1_{name}"), device)
        n1[name] = {"losses": [s["loss"] for s in steps],
                    "ms": [s["ms"] for s in steps],
                    "params": s13_flat(seen["state"].params)}
        del seen
    cfg, ids, labels = s13_bert_case()
    eng = DDPEngine(bert.bert_for_classification(4, cfg), SGD(),
                    Mesh(1, None), device=device)
    ts = eng.init_state(0)
    x = eng.shard_batch(ids, labels)
    bert_n1 = []
    for _ in range(S11_M2_STEPS):
        ts, m = eng.train_step(ts, *x, S13_BERT[2])
        bert_n1.append(float(m["loss_sum"] / m["count"]))
    bert_params = s13_flat(ts.params)
    del eng, ts, x
    for p in procs:
        p.join(900)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    require(not hung and all(p.exitcode == 0 for p in procs),
            f"SP N 2 ranks: exit codes {[p.exitcode for p in procs]}")
    got = []
    for path in outs:
        with open(path, "rb") as f:
            got.append(pickle.load(f))
    wall = time.perf_counter() - t0
    require("gloo_cuda_refused" not in got[0],
            f"gloo refused CUDA tensors: {got[0].get('gloo_cuda_refused')}")
    launches = dict.fromkeys(s13_bert_want(), 0)
    for name, layers, extra in runs:
        f32 = "bfloat16" not in extra
        rel = max(abs(a - b) / abs(b) for r in got
                  for a, b in zip(r[name]["losses"], n1[name]["losses"]))
        row = {"s13_run": name, "layers": layers, "flags": extra,
               "n1_losses": n1[name]["losses"], "n1_ms": n1[name]["ms"],
               "n2_losses": [r[name]["losses"] for r in got],
               "loss_max_rel": rel, "bar": S11_M2_TOL if f32 else "printed",
               "n2_val_loss": got[0][name]["val_loss"],
               "launches_by_rank": [r[name]["launches"] for r in got],
               "host_staged_gloo_ms_per_step": [
                   r[name]["host_staged_gloo_ms"] for r in got],
               "device_busy_ms_by_rank": [r[name].get("device_busy_ms")
                                          for r in got],
               "flash_device_ms_by_rank": [
                   r[name].get("flash_kernel_device_ms") for r in got]}
        row.update(s13_compare(directory, name, n1[name]["params"]))
        emit(row)
        for s_idx, r in enumerate(got):
            want = s13_want(name, layers, s_idx)
            require(r[name]["launches"] == want,
                    f"SP N 2 {name} seq rank {s_idx}: launches "
                    f"{r[name]['launches']}, want {want}")
            for k in launches:
                launches[k] += r[name]["launches"][k]
        require(got[0][name]["losses"] == got[1][name]["losses"],
                f"SP N 2 {name}: the ranks' metric sums differ")
        require(all(map(math.isfinite, got[0][name]["losses"])),
                f"SP N 2 {name}: losses {got[0][name]['losses']}")
        if f32:
            require(rel <= S11_M2_TOL["rtol"] and row["params_within_bar"],
                    f"SP N 2 {name} differs from N 1: {row}")
    rel = max(abs(a - b) / abs(b) for r in got
              for a, b in zip(r["bert"]["losses"], bert_n1))
    row = {"s13_bert_sp_n2": "SequenceParallelEngine ring_flash vs "
           "DDPEngine N 1", "model": "BERT_BASE width, 2 layers, dropout 0, "
           "SGD", "batch_seq_lr": S13_BERT, "n1_losses": bert_n1,
           "n2_losses": [r["bert"]["losses"] for r in got],
           "loss_max_rel": rel, "bar": S11_M2_TOL,
           "launches_by_rank": [r["bert"]["launches"] for r in got],
           "host_staged_gloo_ms_per_step": [r["bert"]["host_staged_gloo_ms"]
                                            for r in got], "wall_s": wall}
    row.update(s13_compare(directory, "bert", bert_params))
    emit(row)
    bert_want = s13_bert_want()
    for r in got:
        require(r["bert"]["launches"] == bert_want,
                f"SP BERT N 2 launches {r['bert']['launches']}, want "
                f"{bert_want}")
        for k in launches:
            launches[k] += r["bert"]["launches"][k]
    require(rel <= S11_M2_TOL["rtol"] and row["params_within_bar"],
            f"SP BERT N 2 differs from DDP at N 1: {row}")
    require(launches["int8_matmul"] == 0, "phase 14 launched K4")
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def s13_hop_kernels(fa, cases=S13_HOP_CASES, tag="s13_hop_kernels") -> dict:
    """(b) K1-K3 at the hop shapes (`cases`), f32 and bf16, through
    `flash_case` and `flash_timings` as at the path shape: each kernel
    against its plain version on the same inputs, its times, its bound
    over this run's visible pairs, and SDPA's as the yardstick (its
    backward, dq, dk and dv in one call, as its forward + backward less
    its forward by CUDA events). Returns each case's row per kernel,
    each printed under `tag`."""
    keep = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "tile_sweep_device_ms")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for *case, causal in cases:
            errs, tensors = flash_case(fa, case, dtype, causal)
            timed = flash_timings(fa, dtype, tensors)
            del tensors
            row = {}
            for n, _, _ in FLASH_KERNELS:
                got = {**timed[n], "max_abs_err": errs[n]}
                row[n] = {k: got[k] for k in keep}
            sdpa_bwd = (timed["flash_bwd_dq"]["sdpa_fwd_bwd_ms"]
                        - timed["flash_fwd"]["library_ms"])
            for n in ("flash_bwd_dq", "flash_bwd_dkv"):
                row[n]["sdpa_bwd_ms"] = sdpa_bwd
            key = f"{case[0]}_{'f32' if dtype == torch.float32 else 'bf16'}"
            rows[key] = row
            emit({tag: key, "shape": case[1:5],
                  "causal": causal, "mask": case[5],
                  "visible_pairs": timed["flash_fwd"]["visible_pairs"],
                  **row})
    return rows


def slice13_phase(lm, engine_cls, fa) -> tuple:
    """Phase 14 (module docstring). Returns (the K1-K4 launches of the
    phase's N 2 runs over both ranks, the hop-shape kernel rows)."""
    t0 = time.perf_counter()
    launches = s13_m2(lm, engine_cls, S13_RUNS, S11_DEVICE)
    print(f"phase 14 (a, c) sequence parallelism at N 2 over gloo: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    hops = s13_hop_kernels(fa)
    print(f"phase 14 (b) K1-K3 at the hop shapes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, hops


# ---- phase 15: the tp / sp serving layouts and collective matmul -----

# (name, serve CLI flags, engine kwargs, K4 launches a decode step a rank):
# the main path's layouts at phase 4's width and flags, two ranks on the
# card. The rings run 4 projections x 12 layers x S chunk GEMMs a step.
S14_SERVE = (
    ("tp_f32", ["--layout", "tp", "--model-shards", "2"],
     dict(layout="tp"), 0),
    ("tp_f32_cm", ["--layout", "tp", "--model-shards", "2",
                   "--collective-matmul"],
     dict(layout="tp", collective_matmul=True), 0),
    ("tp_int8", ["--layout", "tp", "--model-shards", "2",
                 "--compute-dtype", "int8"],
     dict(layout="tp", compute_dtype="int8"), 4 * LAYERS),
    ("tp_int8_cm", ["--layout", "tp", "--model-shards", "2",
                    "--collective-matmul", "--compute-dtype", "int8"],
     dict(layout="tp", collective_matmul=True, compute_dtype="int8"),
     4 * LAYERS * 2),
    ("sp_f32", ["--layout", "sp", "--seq-shards", "2"], dict(layout="sp"),
     0),
    ("sp_f32_paged", ["--layout", "sp", "--seq-shards", "2",
                      "--page-size", "16"],
     dict(layout="sp", page_size=16), 0),
)
S14_STEPS = 6  # teacher-forced decode steps after the 8 prompts
# The serve runs' depth: 8 requests (one admission wave) of 16 tokens.
S14_REQUESTS, S14_NEW = 8, 8  # 16 new tokens until phase 16
S14_SERVE_DEPTH = ["--num-requests", str(S14_REQUESTS), "--max-new-tokens",
                   str(S14_NEW)]
S14_MAX_LEN, S14_PREFILL = 1024, 128  # phase 4's --max-len, --prefill-len
# Teacher-forced logits against the replicated layout on the card, as
# max|got - ref| / max|ref|: f32 layouts (and every layout's f32
# prefill) against f32 within 1e-4 (the sums of partial products over 2
# ranks add in another order). int8 decode against replicated f32 and
# int8 within phase 4's INT8_LOGIT_REL: int8 turns the f32 rounding of
# another summation order into flipped activation codes, 12 layers
# deep, as between card and CPU (phase 4: 1.62e-2 of max|logit|); the
# share of elements inside the reference's elementwise int8 budget
# (tests/test_serving.py QUANT_LOGIT_RTOL/ATOL, which replicated int8
# against f32 fails at this width too, phase 4) is printed.
S14_F32_REL = 1e-4
S14_INT8_BUDGET = dict(rtol=5e-2, atol=1e-2)
# (d): the LM at --seq-shards 2 (2 layers, ring_flash) and the DP CLI's
# BERT_BASE at --engine tp --model-shards 2 (dropout 0.1, 2 SGD steps of
# 16 sequences, val cut to 128), each with and without --collective-matmul:
# losses within 1e-5 relative, K1-K3 launches equal.
S14_LM = S13_LM + ["--layers", "2", "--seq-shards", "2", "--attention",
                   "ring_flash"]
S14_DP = ["--device", "cuda", "--model", "bert", "-type", "SyntheticText",
          "-b", "16", "--val-batch-size", "128", "--optimizer", "sgd",
          "--lr", "0.05", "--epochs", "1", "--steps-per-epoch", "2",
          "--engine", "tp", "--model-shards", "2"]
S14_DP_VAL = 128
S14_LOSS_REL = 1e-5
# (c): K4 at the shapes the layouts give it at GPT-2-small width, 8 slots:
# (M, K, N, input absmax). Megatron shards at M 8 (the column shards
# whole rows; the row shards, without the rings, with the whole row's
# absmax as an input) and the ring chunks of 8/S rows at S 2 and 4.
S14_SHAPES = (
    (8, 768, 1152, False), (8, 768, 1536, False),
    (8, 384, 768, True), (8, 1536, 768, True),
    (4, 768, 1152, False), (4, 384, 768, False),
    (4, 768, 1536, False), (4, 1536, 768, False),
    (2, 768, 576, False), (2, 192, 768, False), (2, 768, 768, False),
)


def s14_config():
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=50257, dim=768, num_layers=LAYERS,
                     num_heads=12, ffn_dim=3072, max_position=S14_MAX_LEN,
                     dropout_rate=0.0, pad_token_id=0)


def s14_script(eng, params, qm) -> dict:
    """The teacher-forced script on `eng`: 8 seeded prompts of 16-128
    tokens (at prefill_len 128) prefilled into the 8 slots, then
    S14_STEPS decode steps of
    seeded tokens for every slot. Returns the prefill and decode logits
    on the host and the K4 launches of the decode steps."""
    import numpy as np

    rng = np.random.RandomState(14)
    vocab = eng.cfg.vocab_size
    lens = rng.randint(eng.prefill_len // 8, eng.prefill_len + 1, SLOTS)
    prompts = [rng.randint(1, vocab, n).astype(np.int32) for n in lens]
    tokens = rng.randint(1, vocab, (S14_STEPS, SLOTS))
    cache = eng.init_cache()
    host = eng.new_host() if eng.paged_spec is not None else None
    prefill = []
    for slot, prompt in enumerate(prompts):
        ids, length = eng.pad_prompt(prompt)
        if host is None:
            cache, nl = eng.prefill(params, cache, ids, length, slot)
        else:
            host.ensure_pages(slot, length)
            cache, nl = eng.paged_prefill_step(
                params, cache, host.device_row(slot), ids, length)
        prefill.append(nl.cpu())
    positions = lens.astype(np.int64)
    active = np.ones(SLOTS, bool)
    decode = []
    qm.int8_matmul.launches = 0
    for step in range(S14_STEPS):
        if host is None:
            cache, logits = eng.decode_step(
                params, cache, torch.from_numpy(tokens[step]).to(eng.device),
                torch.from_numpy(active).to(eng.device))
        else:
            for slot in range(SLOTS):
                cache = host.ensure_writable(cache, slot,
                                             int(positions[slot]))
            cache, logits = eng.paged_decode_step(
                params, cache, host.device_table(),
                *eng.step_inputs(positions, tokens[step], active))
        decode.append(logits.cpu())
        positions += 1
    s13_sync(eng.device.type)
    return {"prefill": torch.stack(prefill), "decode": torch.stack(decode),
            "launches": qm.int8_matmul.launches}


def s14_dp_steps(cls):
    """`cls.train_step` recording each step's loss (the float() read
    waits for the step): (the patch, the losses)."""
    losses = []
    train_step = cls.train_step

    def recorded(self, ts, *batch_lr):
        ts, m = train_step(self, ts, *batch_lr)
        losses.append(float(m["loss_sum"] / m["count"]))
        return ts, m

    return patched(cls, "train_step", recorded), losses


def s14_gloo_rank(rank, port, out, directory, device):
    """One rank of phase 15: a gloo world of 2 on the one card, which it
    joins before the CLIs do (`initialize_backend` is idempotent). (a,
    b) the serve CLI under each layout of S14_SERVE, with the K4
    launches its decode steps made, then the same layout's engine through
    the teacher-forced script (logits saved under `directory`); (d) the
    LM CLI and the DP CLI with and without --collective-matmul, the
    per-step losses and the K1-K4 launches. A gloo that refuses CUDA
    tensors is reported, not faked."""
    import pickle

    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.cli import (
        data_parallel,
        lm,
        serve,
    )
    from distributed_model_parallel_tpu_torch.data import datasets
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )
    from distributed_model_parallel_tpu_torch.parallel import (
        sequence_parallel as sp,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    result = {}
    corpus_once = contextlib.ExitStack()  # the rank's LM CLI runs
    corpus_once.enter_context(lm_corpus_made_once())
    try:
        probe = torch.ones(4, device=device)
        try:
            dist.all_reduce(probe)
        except RuntimeError as e:
            result["gloo_cuda_refused"] = str(e)[:300]
        cfg = s14_config()
        for name, flags, kw, _ in ([] if result else S14_SERVE):
            reset_counts(fa, qm)
            t0 = time.perf_counter()
            rep = serve_run(serve, SERVE_FLAGS + S14_SERVE_DEPTH + flags)
            result[name] = {"serve": rep["serving"],
                            "tokens": [r["tokens"] for r in rep["requests"]],
                            "serve_wall_s": time.perf_counter() - t0,
                            "serve_launches": {**counts(fa), "int8_matmul":
                                               qm.int8_matmul.launches}}
            axis = "model" if kw["layout"] == "tp" else "seq"
            eng = ServingEngine(cfg, mesh=make_mesh(MeshSpec(
                data=1, **{axis: 2})), num_slots=SLOTS, max_len=S14_MAX_LEN,
                prefill_len=S14_PREFILL, device=device, **kw)
            got = s14_script(eng, eng.init_params(0), qm)
            result[name]["script_launches"] = got.pop("launches")
            torch.save(got, os.path.join(directory, f"{name}_{rank}.pt"))
            del eng, got
        if not result.get("gloo_cuda_refused"):
            for cm in (False, True):
                extra = ["--collective-matmul"] if cm else []
                reset_counts(fa, qm)
                steps, _, _ = s13_lm_run(
                    lm, sp.CausalLMSequenceParallelEngine, S14_LM + extra,
                    os.path.join(directory, f"lm_{cm}_{rank}"), device)
                result["lm", cm] = {
                    "losses": [s["loss"] for s in steps],
                    "host_staged_gloo_ms": [s["ms"] for s in steps],
                    "launches": s13_counts(fa, qm)}
                reset_counts(fa, qm)
                small = datasets.synthetic_text

                def cut(n, *a, seed=0, **k):
                    return small(S14_DP_VAL if seed == 2 else n, *a,
                                 seed=seed, **k)

                rec, losses = s14_dp_steps(dp_mod._DataParallel)
                with rec, patched(datasets, "synthetic_text", cut), \
                        without_saves(), \
                        contextlib.redirect_stdout(io.StringIO()):
                    data_parallel.main(S14_DP + extra + [
                        "--checkpoint-dir",
                        os.path.join(directory, f"dp_{cm}_{rank}")])
                result["dp", cm] = {"losses": losses,
                                    "launches": s13_counts(fa, qm)}
    finally:
        corpus_once.close()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(result, f)


def s14_rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def s14_kernel_shapes(qm) -> list:
    """(c) K4 against its plain version at every shape of S14_SHAPES
    (phase 3's `check_shape`: codes, scales and outputs equal; device
    time a launch, the bound, torch._int_mm on the same codes)."""
    rows = []
    for i, (m, k, n, absmax) in enumerate(S14_SHAPES):
        r = check_shape(qm, m, k, n, seed=40 + i, absmax=absmax)
        emit({"s14_int8_matmul_shape": r})
        rows.append(r)
    return rows


def s14_layouts(fa, qm, phase4) -> dict:
    """(a), (b) and (d): the two gloo ranks run every serve layout, its
    teacher-forced script, and the training CLIs' runs, while this
    process runs the script on the replicated engine (f32 and int8) for
    the references; then the comparisons. Returns the K1-K4 launches of
    the ranks' CLI runs, summed over both ranks."""
    import multiprocessing
    import pickle

    import numpy as np

    from distributed_model_parallel_tpu_torch.runtime.dist import free_port
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )

    if S11_DEVICE == "cuda":
        torch.cuda.empty_cache()  # the two ranks share this process's card
    directory = scratch_dir("s14")
    os.makedirs(directory, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(directory, f"rank{r}.pkl") for r in range(2)]
    procs = [ctx.Process(target=s14_gloo_rank,
                         args=(r, port, outs[r], directory, S11_DEVICE))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    # The replicated references meanwhile, on the same weights (seed 0).
    cfg = s14_config()
    ref = {}
    for mode in ("f32", "int8"):
        eng = ServingEngine(cfg, num_slots=SLOTS, max_len=S14_MAX_LEN,
                            prefill_len=S14_PREFILL, compute_dtype=mode,
                            device=S11_DEVICE)
        ref[mode] = s14_script(eng, eng.init_params(0), qm)
        del eng
    for p in procs:
        p.join(900)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    require(not hung and all(p.exitcode == 0 for p in procs),
            f"phase 15 ranks: exit codes {[p.exitcode for p in procs]}")
    got = []
    for path in outs:
        with open(path, "rb") as f:
            got.append(pickle.load(f))
    wall = time.perf_counter() - t0
    require("gloo_cuda_refused" not in got[0],
            f"gloo refused CUDA tensors: {got[0].get('gloo_cuda_refused')}")
    launches = {**dict.fromkeys(counts(fa), 0), "int8_matmul": 0}
    for name, flags, kw, per_step in S14_SERVE:
        mode = kw.get("compute_dtype", "f32")
        logits = [torch.load(os.path.join(directory, f"{name}_{r}.pt"))
                  for r in range(2)]
        same = all(torch.equal(logits[0][k], logits[1][k])
                   for k in ("prefill", "decode"))
        want = ref[mode]
        rel = {k: s14_rel(logits[0][k], want[k]) for k in ("prefill",
                                                           "decode")}
        rel_f32 = s14_rel(logits[0]["decode"], ref["f32"]["decode"])
        d = (logits[0]["decode"] - want["decode"]).abs()
        budget = d <= (S14_INT8_BUDGET["atol"] + S14_INT8_BUDGET["rtol"]
                       * want["decode"].abs())
        reps = [r[name]["serve"] for r in got]
        phase4_tokens = [q["tokens"] for q in phase4[mode]["requests"]]
        pairs = [(a, b) for ra, rb in zip(got[0][name]["tokens"],
                                          phase4_tokens)
                 for a, b in zip(ra, rb)]
        row = {"s14_layout": name, "flags": flags,
               "ranks_logits_equal": same,
               "rel_to_replicated": rel, "decode_rel_to_replicated_f32":
               rel_f32,
               "int8_budget_share_within": float(budget.float().mean()),
               "script_k4_launches_by_rank": [r[name]["script_launches"]
                                              for r in got],
               "want_k4_launches_a_rank": per_step * S14_STEPS,
               "serve_k4_launches_by_rank": [
                   r[name]["serve_launches"]["int8_matmul"] for r in got],
               "decode_steps_by_rank": [r["decode_steps"] for r in reps],
               "greedy_token_agreement_with_phase4": (
                   sum(a == b for a, b in pairs) / len(pairs)),
               "host_staged_gloo": {
                   "tokens_per_s": reps[0]["tokens_per_s"],
                   "decode_p50_ms": reps[0]["decode_p50_ms"],
                   "decode_p99_ms": reps[0]["decode_p99_ms"],
                   "serve_wall_s": got[0][name]["serve_wall_s"]}}
        emit(row)
        require(same, f"phase 15 {name}: rank 1's logits differ from rank "
                "0's")
        for r, rep in zip(got, reps):
            require(rep["requests"] == S14_REQUESTS
                    and rep["generated_tokens"] == S14_REQUESTS * S14_NEW,
                    f"phase 15 {name}: {rep['requests']} requests, "
                    f"{rep['generated_tokens']} tokens")
            require(r[name]["script_launches"] == per_step * S14_STEPS,
                    f"phase 15 {name}: K4 launched "
                    f"{r[name]['script_launches']} times in "
                    f"{S14_STEPS} decode steps, want {per_step} a step")
            want_serve = per_step * rep["decode_steps"]
            require(r[name]["serve_launches"] == {
                **dict.fromkeys(counts(fa), 0), "int8_matmul": want_serve},
                f"phase 15 {name}: the serve run launched "
                f"{r[name]['serve_launches']}, want K4 {want_serve}")
            for k, v in r[name]["serve_launches"].items():
                launches[k] += v
        if mode == "f32":
            require(max(rel.values()) <= S14_F32_REL,
                    f"phase 15 {name}: logits {rel} from the replicated "
                    f"layout's, over {S14_F32_REL}")
        else:
            require(rel["prefill"] <= S14_F32_REL
                    and max(rel["decode"], rel_f32) <= INT8_LOGIT_REL,
                    f"phase 15 {name}: int8 logits past {INT8_LOGIT_REL} "
                    f"of max|logit| from the replicated layout's: {row}")
    for kind in ("lm", "dp"):
        plain, cm = ([r[kind, flag] for r in got] for flag in (False, True))
        rel = max(abs(a - b) / abs(b) for p, c in zip(plain, cm)
                  for a, b in zip(c["losses"], p["losses"]))
        row = {"s14_cm_run": kind,
               "flags": S14_LM if kind == "lm" else S14_DP,
               "losses": [r["losses"] for r in plain],
               "cm_losses": [r["losses"] for r in cm],
               "loss_max_rel": rel, "bar": S14_LOSS_REL,
               "launches_by_rank": [r["launches"] for r in plain],
               "cm_launches_by_rank": [r["launches"] for r in cm]}
        if kind == "lm":
            row["cm_host_staged_gloo_ms_per_step"] = [
                r["host_staged_gloo_ms"] for r in cm]
        emit(row)
        require(rel <= S14_LOSS_REL and all(
            map(math.isfinite, cm[0]["losses"])),
            f"phase 15 {kind}: --collective-matmul moved the losses: {row}")
        require(all(c["launches"] == p["launches"]
                    for p, c in zip(plain, cm)),
                f"phase 15 {kind}: --collective-matmul changed the K1-K4 "
                f"launches: {row}")
        # ring_flash runs K1-K3 on every rank; BERT's dense attention and
        # training run no kernel of the port.
        for r in plain + cm:
            require(r["launches"]["int8_matmul"] == 0 and all(
                (r["launches"][k] > 0) == (kind == "lm") for k in counts(fa)),
                f"phase 15 {kind}: launches {r['launches']}")
            for k, v in r["launches"].items():
                launches[k] += v
    emit({"s14_ranks_wall_s": wall})
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def slice14_phase(fa, qm, phase4) -> tuple:
    """Phase 15 (module docstring). Returns (the K1-K4 launches of the
    phase's rank runs over both ranks, the (c) shape rows)."""
    t0 = time.perf_counter()
    shapes = s14_kernel_shapes(qm)
    print(f"phase 15 (c) K4 at the shard and ring-chunk shapes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = s14_layouts(fa, qm, phase4)
    print(f"phase 15 (a, b, d) tp / sp serving and collective matmul over "
          f"gloo: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, shapes


# ---- phase 16: expert parallelism (slice 15) --------------------------

# (a) the LM CLI's MoE path at GPT-2-small width: 8 experts on every
# second block (6 of 12), top-2, capacity factor 1.25, AdamW (the CLI's
# default), 3 steps and 1 val batch.
S15_STEPS = 3
S15_LM = LM_BASE + ["--layers", str(LAYERS), "--moe-experts", "8",
                    "--moe-every", "2", "--epochs", "1",
                    "--steps-per-epoch", str(S15_STEPS)]
S15_RUNS = (  # (name, extra flags)
    ("gspmd_f32", ["--dtype", "float32"]),
    ("gspmd_bf16", ["--dtype", "bfloat16"]),
    ("hierarchical_f32", ["--moe-dispatch", "hierarchical", "--dtype",
                          "float32"]),
)
S15_E, S15_CAP = 8, 320  # experts; slots an expert a sample: ceil(2 T 1.25 / E)
# (c) the gloo ranks' runs at full width, 2 layers (block 1 MoE), SGD:
# (name, world, extra flags, loss bar); each against the N 1 run in this
# process at the same flags. The int8 dcn run's bars: its losses against
# N 1's (relative), and each parameter leaf's distance from N 1's over
# the distance N 1's own steps moved it (Frobenius norms, the worst
# leaf). On one H100 the run read 2.0e-6 and 0.0132; the same run with
# the dcn stage's decoded chunks zeroed (a broken wire) read 5.4e-5 and
# 0.704. Each bar lies near the geometric mean of the two readings.
S15_INT8_LOSS_REL = 1e-5
S15_INT8_PARAM_REL = 0.1
S15_M2 = LM_BASE + ["--layers", "2", "--moe-experts", "8", "--moe-every",
                    "2", "--optimizer", "sgd", "--lr", str(S13_LR),
                    "--epochs", "1", "--steps-per-epoch", str(S13_STEPS)]
S15_M2_RUNS = (
    ("expert_shards_2", 2, ["--expert-shards", "2"], S11_M2_TOL["rtol"]),
    ("hierarchical_s2", 2, ["--moe-dispatch", "hierarchical"],
     S11_M2_TOL["rtol"]),
    ("hierarchical_s2_overlap", 2, ["--moe-dispatch", "hierarchical",
                                    "--moe-overlap"], S11_M2_TOL["rtol"]),
    ("hierarchical_dcn2_int8", 4, ["--moe-dispatch", "hierarchical",
                                   "--dcn-slices", "2", "--dcn-compression",
                                   "int8"], S15_INT8_LOSS_REL),
)


def s15_expert_bytes(ts) -> int:
    """Bytes of a state's expert stacks (this rank's shards)."""
    return sum(v.numel() * v.element_size()
               for b in ts.params["blocks"].values() if "moe" in b
               for v in b["moe"]["experts"].values())


def s15_run(lm, engine_cls, fa, qm, name, extra):
    """(a): one LM CLI run at full width, each train step timed, then one
    more step profiled; K1-K4 must launch 0 times."""
    reset_counts(fa, qm)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with without_saves():
        out, steps, seen = recorded_run(
            lm.main, S15_LM + extra + ["--checkpoint-dir",
                                       scratch_dir(f"s15_{name}")],
            engine_cls)
    peak = torch.cuda.max_memory_allocated() - base
    got = s13_counts(fa, qm)
    require(not any(got.values()), f"MoE LM {name} launched {got}")
    hist = out["history"][0]
    losses = [s["loss"] for s in steps] + [hist["train"]["loss"],
                                           hist["val"]["loss"]]
    require(len(steps) == S15_STEPS and all(map(math.isfinite, losses)),
            f"MoE LM {name}: {len(steps)} steps, losses {losses}")
    ms = sum(s["ms"] for s in steps[1:]) / len(steps[1:])
    row = {"s15_run": name, "flags": extra, "launches": got,
           "step_ms": [s["ms"] for s in steps],
           "step_loss": [s["loss"] for s in steps], "ms_per_step": ms,
           "tokens_per_s": LM_TOKENS / ms * 1e3,
           "val_loss": hist["val"]["loss"],
           "peak_above_start_bytes": peak,
           "expert_bytes": s15_expert_bytes(seen["state"])}
    brk = step_breakdown(seen, ms)
    row.update({k: brk[k] for k in ("device_busy_ms", "device_idle_share",
                                    "top_device_kernels")})
    emit(row)
    return row, seen


def s15_events_ms(fn, reps: int = 5) -> float:
    """CUDA-event ms a call of `fn`, after one warmup call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def s15_moe_parts(dtype) -> dict:
    """One MoE layer's forward + backward at the path's shapes (B 8, T
    1024, D 768, E 8, C 320, H 3072), by parts, CUDA events: the routing
    (router, softmax, the k rounds, the combine tensor), the dispatch and
    combine einsums, and the expert FFN."""
    from distributed_model_parallel_tpu_torch.models import moe

    b, t, d, e = 8, 1024, 768, S15_E
    g = torch.Generator(device="cuda").manual_seed(15)
    params = moe.moe_params(torch.Generator().manual_seed(15), d, 3072, e)
    w = {n: v.cuda().requires_grad_() for n, v in params["experts"].items()}
    router = params["router"]["w"].cuda().requires_grad_()
    h = torch.randn((b, t, d), generator=g, device="cuda").to(dtype)
    h.requires_grad_()
    mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
    cap = moe.capacity(t, e, 2, 1.25)
    require(cap == S15_CAP, f"capacity {cap}")

    def combine():
        gates, chosen, _ = moe.route(h, mask, router, e, 2, cap)
        denom = sum(c[0] for c in chosen) + 1e-9
        return moe.combine_tensor([c[0] / denom for c in chosen], chosen,
                                  cap)

    comb = combine().detach().to(dtype)
    disp = (comb > 0).to(dtype)
    xin = torch.einsum("btec,btd->ebcd", disp, h).detach().requires_grad_()
    y = moe.expert_ffn(w, xin, dtype).detach().requires_grad_()
    cot = torch.randn((b, t, d), generator=g, device="cuda").to(dtype)

    def routing():
        c = combine()
        torch.autograd.grad(c, [h, router], torch.ones_like(c))

    def einsums():
        x = torch.einsum("btec,btd->ebcd", disp, h)
        out = torch.einsum("btec,ebcd->btd", comb, y)
        torch.autograd.grad([x, out], [h, y], [torch.ones_like(x), cot])

    def ffn():
        out = moe.expert_ffn(w, xin, dtype)
        torch.autograd.grad(out, [xin] + list(w.values()),
                            torch.ones_like(out))

    return {"routing_ms": s15_events_ms(routing),
            "dispatch_combine_einsums_ms": s15_events_ms(einsums),
            "expert_ffn_ms": s15_events_ms(ffn)}


def s15_card_vs_cpu(engine_cls, optim) -> dict:
    """(b): one train step's loss and every gradient leaf of a small MoE
    GPT with dropped tokens (capacity factor 0.5), card against CPU."""
    from distributed_model_parallel_tpu_torch.data.lm import synthetic_corpus
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        gpt_lm_model,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh

    cfg = GPTConfig(vocab_size=97, dim=64, num_layers=2, num_heads=4,
                    ffn_dim=256, max_position=64, dropout_rate=0.0,
                    pad_token_id=0, num_experts=4, moe_every=2,
                    moe_capacity_factor=0.5)
    model = gpt_lm_model(cfg)
    params, state = model.init(torch.Generator().manual_seed(0))
    ids = synthetic_corpus(97, 4 * 64, seed=3).reshape(4, 64)
    res = {}
    for dev in ("cuda", "cpu"):
        eng = engine_cls(model, optim.SGD(), Mesh(1, None), device=dev,
                         pad_token_id=0)
        ts = eng.state_from_params(params, state)
        m, grads = eng.grads(ts, *eng.shard_batch(ids))
        res[dev] = (m["loss_sum"] / m["count"],
                    dict(zip(leaf_names(grads), optim.tree_leaves(grads))))
    loss = rel_diff(res["cuda"][0].cpu(), res["cpu"][0])
    grads = {n: rel_diff(res["cuda"][1][n].cpu(), res["cpu"][1][n])
             for n in res["cpu"][1]}
    worst = max(grads, key=grads.get)
    row = {"loss_rel": loss, "grad_rel_max": grads[worst],
           "grad_rel_worst_leaf": worst, "leaves": len(grads),
           "bar": SMALL_CARD_VS_CPU}
    emit({"s15_card_vs_cpu": row})
    require(max(loss, grads[worst]) <= SMALL_CARD_VS_CPU,
            f"MoE GPT step on the card differs from the CPU's: {row}")
    return row


def s15_gloo_rank(rank, world, port, out, directory, name, flags, device,
                  go=None):
    """One rank of (c): a gloo world on the one card, joined before
    `cli/lm.main` does (once the file `go` exists, when given: a later
    wave's ranks start, import and make their CUDA context while the
    earlier wave runs); the LM CLI with `flags`: per-step losses and
    host-staged ms, the exchange's hops a step, this rank's expert
    bytes, K1-K4 launches, and (rank 0) the canonical parameters saved
    under `directory`."""
    import pickle

    import numpy as np
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.cli import lm
    from distributed_model_parallel_tpu_torch.ops import expert_dispatch as xd
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import ExpertParallelLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device=device)  # the CUDA context, now
    while go is not None and not os.path.exists(go):
        time.sleep(0.05)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    result = {}
    evals = []
    eval_step = ExpertParallelLMEngine.eval_step

    def counted(self, *args):
        evals.append(1)
        return eval_step(self, *args)

    try:
        reset_counts(fa, qm)
        hops = xd.hops
        with patched(ExpertParallelLMEngine, "eval_step", counted):
            steps, seen, hist = s13_lm_run(
                lm, ExpertParallelLMEngine, flags,
                os.path.join(directory, f"ck_{name}_{rank}"), device)
        eng, ts = seen["engine"], seen["state"]
        tree = eng.to_canonical(ts)  # collective over the shard axis
        if rank == 0:
            np.savez(os.path.join(directory, f"{name}.npz"),
                     **{k: v for k, v in zip(leaf_names(tree["params"]),
                                             optim_leaves(tree["params"]))})
        result = {"losses": [s["loss"] for s in steps],
                  "host_staged_gloo_ms": [s["ms"] for s in steps],
                  "hops": xd.hops - hops, "steps": len(steps),
                  "val_batches": len(evals),
                  "expert_bytes": s15_expert_bytes(ts),
                  "launches": s13_counts(fa, qm),
                  "val_loss": hist[0]["val"]["loss"]}
    finally:
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(result, f)


def optim_leaves(tree):
    """Leaves of a nested dict in `leaf_names` (sorted) order."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in optim_leaves(tree[k])]
    return [tree]


def s15_spawn(world, name, flags, directory, device, go=None):
    """Start `world` gloo rank processes of run `name` (waiting for the
    file `go`, when given); returns (procs, their result files)."""
    import multiprocessing

    from distributed_model_parallel_tpu_torch.runtime.dist import free_port

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(directory, f"{name}_rank{r}.pkl")
            for r in range(world)]
    procs = [ctx.Process(target=s15_gloo_rank,
                         args=(r, world, port, outs[r], directory, name,
                               flags, device, go)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def s15_join(name, procs, outs) -> list:
    import pickle

    for p in procs:
        p.join(600)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    require(not hung and all(p.exitcode == 0 for p in procs),
            f"EP {name} ranks: exit codes {[p.exitcode for p in procs]}")
    got = []
    for path in outs:
        with open(path, "rb") as f:
            got.append(pickle.load(f))
    return got


def s15_m2(lm, engine_cls, device) -> dict:
    """(c): each run of S15_M2_RUNS as gloo ranks on the one card (the
    2-rank runs' six processes together, while this process runs N 1 at
    the same flags, then the 4-rank run, whose processes start with the
    first wave and wait), against that N 1 run: losses within the run's
    bar, rank 0's canonical parameters within S11_M2_TOL (f32 wires) or,
    leaf by leaf, off N 1's by at most S15_INT8_PARAM_REL of N 1's own
    update (the int8 wire), expert bytes a rank 1/N of N 1's, the hops `exchange_permutes` x (2 a train step, forward and
    backward of the one MoE layer, + 1 a val batch), K1-K4 none. Returns
    the ranks' launches."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.ops.expert_dispatch import (
        exchange_permutes,
    )

    torch.cuda.empty_cache()
    directory = scratch_dir("s15_m2")
    os.makedirs(directory, exist_ok=True)
    launches = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                              "int8_matmul"), 0)
    t0 = time.perf_counter()
    # two waves (the 2-rank runs with N 1 in this process, then the
    # 4-rank run): ten ranks at once do not fit beside this process
    waves = [[r for r in S15_M2_RUNS if r[1] == w] for w in (2, 4)]
    go = os.path.join(directory, "wave2.go")
    started = [(run, s15_spawn(run[1], run[0], S15_M2 + run[2], directory,
                               device, go if run in waves[1] else None))
               for run in waves[0] + waves[1]]
    steps, seen, _ = s13_lm_run(lm, engine_cls, S15_M2,
                                scratch_dir("s15_n1"), device, init=True)
    tree = seen["engine"].to_canonical(seen["state"])
    n1 = {"losses": [s["loss"] for s in steps],
          "ms": [s["ms"] for s in steps],
          "expert_bytes": s15_expert_bytes(seen["state"]),
          "params": dict(zip(leaf_names(tree["params"]),
                             optim_leaves(tree["params"]))),
          "init": seen["init"]}
    del seen, tree
    torch.cuda.empty_cache()
    joined = []
    for (run, (procs, outs)) in started:
        if run == waves[1][0]:  # the first wave is done: the second runs
            open(go, "w").close()
        joined.append((run, s15_join(run[0], procs, outs)))
    for (name, world, extra, bar), got in joined:
        ways = world  # expert ranks (gspmd) or data ranks
        k = 2 if "--dcn-slices" in extra else 1
        hier = "hierarchical" in extra
        pair = exchange_permutes(ways // k, k) if hier else 0
        rel = max(abs(a - b) / abs(b) for r in got
                  for a, b in zip(r["losses"], n1["losses"]))
        row = {"s15_m2_run": name, "world": world, "flags": extra,
               "n1_losses": n1["losses"], "n1_ms": n1["ms"],
               "losses_by_rank": [r["losses"] for r in got],
               "loss_max_rel": rel, "bar": bar,
               "expert_bytes_by_rank": [r["expert_bytes"] for r in got],
               "n1_expert_bytes": n1["expert_bytes"],
               "hops_by_rank": [r["hops"] for r in got],
               "exchange_permutes": pair,
               "launches_by_rank": [r["launches"] for r in got],
               "host_staged_gloo_ms_per_step": [
                   r["host_staged_gloo_ms"] for r in got],
               "wall_s": time.perf_counter() - t0}
        saved = np.load(os.path.join(directory, f"{name}.npz"))
        diff = {n: float(np.abs(saved[n] - v).max())
                for n, v in n1["params"].items()}
        worst = max(diff, key=diff.get)
        row.update(worst_leaf=worst, worst_abs_diff=diff[worst])
        if "int8" not in extra:
            row["params_within_bar"] = all(
                np.allclose(saved[n], v, **S11_M2_TOL)
                for n, v in n1["params"].items())
        else:  # the int8 wire: each leaf's distance from N 1 against the
            # distance N 1's own steps moved it
            moved = {}
            for n, v in n1["params"].items():
                step = float(np.linalg.norm(v - n1["init"][n]))
                off = float(np.linalg.norm(saved[n] - v))
                moved[n] = off / step if step else (0.0 if off == 0
                                                     else math.inf)
            far = max(moved, key=moved.get)
            row.update(param_off_over_update=moved[far],
                       param_off_over_update_leaf=far,
                       param_bar=S15_INT8_PARAM_REL)
            row["params_within_bar"] = moved[far] <= S15_INT8_PARAM_REL
        emit(row)
        require(row["params_within_bar"],
                f"EP {name}: parameters off N 1's: {row}")
        require(rel <= bar, f"EP {name}: losses off N 1's: {row}")
        require(all(r["losses"] == got[0]["losses"] for r in got),
                f"EP {name}: the ranks' metric sums differ")
        require(all(b * ways == n1["expert_bytes"]
                    for b in row["expert_bytes_by_rank"]),
                f"EP {name}: expert bytes a rank {row}")
        for r in got:  # a train step's exchanges forward and back,
            want = pair * (2 * r["steps"] + r["val_batches"])  # val's
            require(r["hops"] == want, f"EP {name}: {r['hops']} hops "
                    f"over {r['steps']} steps and {r['val_batches']} "
                    f"val batches, want {want}")
        for r in got:
            require(not any(r["launches"].values()),
                    f"EP {name} launched {r['launches']}")
            for key in launches:
                launches[key] += r["launches"][key]
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def slice15_phase(lm, fa, qm) -> dict:
    """Phase 16 (module docstring). Returns the K1-K4 launches of the
    phase's runs (all zero)."""
    from distributed_model_parallel_tpu_torch.parallel.expert_parallel \
        import ExpertParallelLMEngine
    from distributed_model_parallel_tpu_torch.training import optim

    t_phase = time.perf_counter()
    rows, seen = {}, {}
    for name, extra in S15_RUNS:
        rows[name], seen[name] = s15_run(lm, ExpertParallelLMEngine, fa, qm,
                                         name, extra)
    a, b = rows["gspmd_f32"], rows["hierarchical_f32"]
    same_params = all(torch.equal(x, y) for x, y in zip(
        optim.tree_leaves(seen["gspmd_f32"]["state"].params),
        optim.tree_leaves(seen["hierarchical_f32"]["state"].params)))
    seen.clear()
    parts = {("f32" if dt == torch.float32 else "bf16"): s15_moe_parts(dt)
             for dt in (torch.float32, torch.bfloat16)}
    shares = {}
    for key, run in (("f32", a), ("bf16", rows["gspmd_bf16"])):
        moe_layers = LAYERS // 2
        shares[key] = {p: moe_layers * v / run["ms_per_step"]
                       for p, v in parts[key].items()}
    emit({"s15_hierarchical_s1_vs_gspmd": {
        "losses_equal": a["step_loss"] == b["step_loss"],
        "val_loss_equal": a["val_loss"] == b["val_loss"],
        "params_bit_equal": same_params},
        "s15_moe_layer_parts_ms": parts,
        "s15_share_of_step_6_layers": shares})
    require(a["step_loss"] == b["step_loss"] and same_params,
            "hierarchical at S 1 differs from gspmd")
    print(f"phase 16 (a) the MoE LM at full width: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    t0 = time.perf_counter()
    s15_card_vs_cpu(ExpertParallelLMEngine, optim)
    launches = s15_m2(lm, ExpertParallelLMEngine, S11_DEVICE)
    print(f"phase 16 (b, c) card vs CPU, EP over gloo: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 16 (d) expert parallelism: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---- phase 17: composed parallel plans (slice 16) ----------------------

# (a) `cli.lm --plan dp1` at world 1 on NCCL, GPT-2-small width (12
# layers), SGD, 3 steps and 1 val batch, f32 and bf16 (the composed
# engine's dp-only tick program), and the dense single-rank LM step at
# the same flags and seed (the same weights): the f32 plan within
# S11_M2_TOL of it, losses and every parameter.
S16_STEPS = 3
S16_A = LM_BASE + ["--layers", str(LAYERS), "--optimizer", "sgd", "--lr",
                   str(S13_LR), "--epochs", "1", "--steps-per-epoch",
                   str(S16_STEPS)]
S16_A_RUNS = (  # (name, extra flags)
    ("dense_f32", ["--dtype", "float32"]),
    ("dp1_f32", ["--plan", "dp1", "--dtype", "float32"]),
    ("dp1_bf16", ["--plan", "dp1", "--dtype", "bfloat16"]),
)
# (b) gloo ranks on the one card (host-staged hops), full width with 2
# blocks a stage (4 layers), SGD, 2 steps and 1 val batch, each against
# the N 1 run of the same flags without the plan in this process (the
# same seed, so the same weights; the same global batches): losses and
# rank 0's gathered parameters within S11_M2_TOL. (name, world, CLI,
# flags, the run it is held against); the narrow 8-rank run at dim 256,
# 4 heads, FFN 1024. The DP CLI's loader keys its crops and flips by
# rank, so no world-1 run sees the 2 ranks' batches: `--plan fsdp2` is
# held against `--engine ddp --sync-bn` (FSDP's BN is over the data
# ranks) on 2 ranks of its own (a run held against nothing; phase 13 (b)
# holds FSDP at N 2 against N 1 on the engine).
# The runs start in waves (S16_WAVES): ten full-width rank processes
# beside this one ran the card out of memory in phase 16's first
# version.
S16_M2 = S13_LM + ["--layers", "4"]
S16_NARROW = ["--dim", "256", "--heads", "4", "--ffn-dim", "1024"]
S16_DP = ["--device", "cuda", "--model", "mobilenetv2", "--dataset-type",
          "Synthetic", "-b", "128", "--val-batch-size", "512", "--lr",
          "0.05", "--epochs", "1", "--steps-per-epoch", "2", "-j", "1"]
S16_M2_RUNS = (
    ("pp2xsp2_ring_flash", 4, "lm", ["--plan", "pp2xsp2", "--attention",
                                     "ring_flash"], "lm_ring_flash"),
    # held against the N 1 ring_flash run: at N 1 both cores are one
    # flash call on the whole sequence
    ("pp2xsp2_ulysses_flash", 4, "lm", ["--plan", "pp2xsp2", "--attention",
                                        "ulysses_flash"], "lm_ring_flash"),
    ("dp_ddp2", 2, "dp", ["--engine", "ddp", "--sync-bn"], None),
    ("dp_fsdp2", 2, "dp", ["--plan", "fsdp2"], "dp_ddp2"),
    ("pp2_1f1bxdp2", 4, "lm", ["--plan", "pp2-1f1bxdp2"], "lm_dense"),
    ("pp2xfsdp2", 4, "lm", ["--plan", "pp2xfsdp2"], "lm_dense"),
    ("pp2xsp2xdp2_narrow", 8, "lm", ["--plan", "pp2xsp2xdp2"] + S16_NARROW,
     "lm_narrow"),
)
S16_N1 = {  # the N 1 runs: (CLI, flags)
    "lm_ring_flash": ("lm", S16_M2 + ["--attention", "ring_flash"]),
    "lm_dense": ("lm", S16_M2),
    "lm_narrow": ("lm", S16_M2 + S16_NARROW),
}
S16_WAVES = (("pp2xsp2_ring_flash", "dp_ddp2", "dp_fsdp2"),
             ("pp2_1f1bxdp2", "pp2xfsdp2"),
             ("pp2xsp2xdp2_narrow", "pp2xsp2_ulysses_flash"))
S16_MICRO = 2  # the pp2 plans' default microbatches (pp)
# (c) K1-K3 at the shapes the plan's seq leg gives them in (b): a
# microbatch of B 8 / 2 = 4 at T 1024 over 2 seq ranks, GPT-2-small's 12
# heads of 64: ring_flash's resident block (causal) and a visible hop
# (non-causal, a padded key mask) at T/2 rows, ulysses_flash's whole
# sequence over 12/2 heads.
S16_HOP_CASES = (
    ("plan_ring_resident", 4, 512, 12, 64, "all", True),
    ("plan_ring_hop", 4, 512, 12, 64, "random", False),
    ("plan_ulysses_heads", 4, 1024, 6, 64, "all", True),
)


def s16_engine_cls(cli):
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )
    from distributed_model_parallel_tpu_torch.parallel.plan import (
        ComposedPlanEngine,
    )
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine

    def pick(flags):
        if cli == "dp":
            return dp_mod._DataParallel
        return (ComposedPlanEngine if "--plan" in flags
                else CausalLMSequenceParallelEngine)

    return pick


def s16_main(cli):
    if cli == "dp":
        from distributed_model_parallel_tpu_torch.cli import data_parallel
        return data_parallel
    from distributed_model_parallel_tpu_torch.cli import lm
    return lm


def s16_run(cli, flags, directory, device):
    """One CLI run of this phase, each train step timed: (steps, seen,
    history, K1-K4 launches, peak bytes above the start)."""
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm

    reset_counts(fa, qm)
    if device == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    steps, seen, hist = s13_lm_run(s16_main(cli), s16_engine_cls(cli)(flags),
                                   flags, directory, device)
    peak = (torch.cuda.max_memory_allocated() - base if device == "cuda"
            else None)
    return steps, seen, hist, s13_counts(fa, qm), peak


def s16_a(device="cuda") -> dict:
    """(a): the full-width dp1 plan in f32 and bf16 against the dense
    single-rank step (module docstring)."""
    import numpy as np

    rows, params = {}, {}
    for name, extra in S16_A_RUNS:
        steps, seen, hist, got, peak = s16_run(
            "lm", S16_A + extra, scratch_dir(f"s16_{name}"), device)
        require(not any(got.values()), f"plan {name} launched {got}")
        losses = [s["loss"] for s in steps]
        require(len(steps) == S16_STEPS and all(map(math.isfinite, losses)),
                f"plan {name}: losses {losses}")
        ms = sum(s["ms"] for s in steps[1:]) / len(steps[1:])
        rows[name] = {"s16_run": name, "flags": extra,
                      "engine": type(seen["engine"]).__name__,
                      "step_ms": [s["ms"] for s in steps],
                      "step_loss": losses, "ms_per_step": ms,
                      "tokens_per_s": LM_TOKENS / ms * 1e3,
                      "val_loss": hist[0]["val"]["loss"],
                      "peak_above_start_bytes": peak, "launches": got}
        params[name] = s13_flat(seen["state"].params)
        del seen
    dense, plan = params["dense_f32"], params["dp1_f32"]
    diff = {k: float((plan[k] - dense[k]).abs().max()) for k in dense}
    worst = max(diff, key=diff.get)
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        rows["dp1_f32"]["step_loss"], rows["dense_f32"]["step_loss"]))
    check = {"loss_max_rel": rel, "worst_leaf": worst,
             "worst_abs_diff": diff[worst], "bar": S11_M2_TOL,
             "bit_equal": all(torch.equal(plan[k], dense[k])
                              for k in dense),
             "params_within_bar": plan.keys() == dense.keys() and all(
                 np.allclose(plan[k].numpy(), dense[k].numpy(),
                             **S11_M2_TOL) for k in dense)}
    for row in rows.values():
        emit(row)
    emit({"s16_dp1_vs_dense_f32": check})
    require(rows["dp1_f32"]["engine"] == "ComposedPlanEngine",
            f"--plan dp1 ran {rows['dp1_f32']['engine']}")
    require(rel <= S11_M2_TOL["rtol"] and check["params_within_bar"],
            f"--plan dp1 differs from the dense step: {check}")
    return rows


def s16_gloo_rank(rank, world, port, out, directory, name, cli, flags,
                  device, go=None):
    """One rank of (b): a gloo world on the one card, joined before the
    CLI does (once the file `go` exists, when given); the CLI with
    `flags`: per-step losses and host-staged ms, the K1-K4 launches, the
    stage wire's payloads and the fused reductions, this rank's
    parameter bytes, and (rank 0) the gathered canonical parameters
    saved under `directory`."""
    import pickle

    import numpy as np
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.models.convert import (
        train_state_to_jax,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device=device)  # the CUDA context, now
    while go is not None and not os.path.exists(go):
        time.sleep(0.05)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    result = {}
    corpus_once = contextlib.ExitStack()
    corpus_once.enter_context(lm_corpus_made_once())
    try:
        steps, seen, hist, got, _ = s16_run(
            cli, flags, os.path.join(directory, f"ck_{name}_{rank}"), device)
        eng, ts = seen["engine"], seen["state"]
        # collective over the plan's ranks (DDP's replicas need none)
        tree = (eng.to_canonical(ts) if hasattr(eng, "to_canonical")
                else train_state_to_jax(ts))
        if rank == 0:
            np.savez(os.path.join(directory, f"{name}.npz"),
                     **{k: v for k, v in zip(leaf_names(tree["params"]),
                                             optim_leaves(tree["params"]))})
        result = {"losses": [s["loss"] for s in steps],
                  "host_staged_gloo_ms": [s["ms"] for s in steps],
                  "launches": got, "steps": len(steps),
                  "val_loss": hist[0]["val"]["loss"],
                  "wire_hops": getattr(eng, "wire_hops", None),
                  "grad_reductions": getattr(eng, "grad_reductions", None),
                  "param_bytes": sum(
                      t.numel() * t.element_size()
                      for t in s13_flat(ts.params).values()),
                  "stage": getattr(eng.mesh, "stage_index", 0),
                  "seq": eng.mesh.seq_index if hasattr(eng.mesh, "seq_index")
                  else 0}
    finally:
        corpus_once.close()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(result, f)


def s16_spawn(world, name, cli, flags, directory, device, go=None):
    import multiprocessing

    from distributed_model_parallel_tpu_torch.runtime.dist import free_port

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(directory, f"{name}_rank{r}.pkl")
            for r in range(world)]
    procs = [ctx.Process(target=s16_gloo_rank,
                         args=(r, world, port, outs[r], directory, name, cli,
                               flags, device, go)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def s16_want(name, got) -> dict:
    """The exact K1-K4 launches of a rank of run `name`, for each of its
    stage's 2 blocks and each of the 2 microbatches: under pp2xsp2
    ring_flash a seq rank q runs its resident block and its q visible
    hops, under ulysses_flash one launch on its heads; K1 in every train
    and val step, K2 / K3 in every train step; the other runs attend
    dense (none); K4 never."""
    per = ((got["seq"] + 1) * 2 * S16_MICRO if "ring_flash" in name
           else 2 * S16_MICRO if "ulysses_flash" in name else 0)
    return {"flash_fwd": per * (got["steps"] + LM_VAL_BATCHES),
            "flash_bwd_dq": per * got["steps"],
            "flash_bwd_dkv": per * got["steps"], "int8_matmul": 0}


def s16_m2(device) -> dict:
    """(b): every run of S16_M2_RUNS as gloo ranks on the one card, in
    waves (each later wave's processes start with the first and wait),
    while this process runs the N 1 runs; then each run against its N 1
    run: losses and rank 0's gathered parameters within S11_M2_TOL, the
    ranks' metric sums equal, K1-K3 exact (pp2xsp2 ring_flash) or none,
    K4 none, the stage wire's payloads (stage 0: M a train step and a
    val batch; stage 1: M a train step) and one fused reduction a train
    step on ranks whose stage has more than one rank. Returns the
    ranks' K1-K4 launches."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.models.convert import (
        train_state_to_jax,
    )

    torch.cuda.empty_cache()
    directory = scratch_dir("s16_m2")
    os.makedirs(directory, exist_ok=True)
    runs = {r[0]: r for r in S16_M2_RUNS}
    t0 = time.perf_counter()
    gos = [None] + [os.path.join(directory, f"wave{i}.go")
                    for i in range(1, len(S16_WAVES))]
    started = {}
    for wave, go in zip(S16_WAVES, gos):
        for name in wave:
            _, world, cli, flags, _ = runs[name]
            base = S16_M2 if cli == "lm" else S16_DP
            started[name] = s16_spawn(world, name, cli, base + flags,
                                      directory, device, go)
    n1 = {}
    for key, (cli, flags) in S16_N1.items():
        steps, seen, hist, got, _ = s16_run(cli, flags,
                                            scratch_dir(f"s16_n1_{key}"),
                                            device)
        tree = train_state_to_jax(seen["state"])
        n1[key] = {"losses": [s["loss"] for s in steps],
                   "ms": [s["ms"] for s in steps], "launches": got,
                   "params": dict(zip(leaf_names(tree["params"]),
                                      optim_leaves(tree["params"]))),
                   "param_bytes": sum(
                       t.numel() * t.element_size()
                       for t in s13_flat(seen["state"].params).values())}
        del seen, tree
    torch.cuda.empty_cache()
    joined = {}
    for wave, go in zip(S16_WAVES, gos):
        if go is not None:
            open(go, "w").close()
        for name in wave:
            joined[name] = s15_join(name, *started[name])
    launches = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                              "int8_matmul"), 0)
    for name, world, cli, flags, ref in S16_M2_RUNS:
        if ref is None:  # a reference run: rank 0's losses and parameters
            saved = np.load(os.path.join(directory, f"{name}.npz"))
            n1[name] = {"losses": joined[name][0]["losses"],
                        "ms": joined[name][0]["host_staged_gloo_ms"],
                        "params": {k: saved[k] for k in saved.files},
                        "param_bytes": joined[name][0]["param_bytes"]}
    rows = {}
    for name, world, cli, flags, ref in S16_M2_RUNS:
        if ref is None:
            continue
        got, want = joined[name], n1[ref]
        rel = max(abs(a - b) / abs(b) for r in got
                  for a, b in zip(r["losses"], want["losses"]))
        saved = np.load(os.path.join(directory, f"{name}.npz"))
        diff = {k: float(np.abs(saved[k] - v).max())
                for k, v in want["params"].items()}
        worst = max(diff, key=diff.get)
        row = {"s16_m2_run": name, "world": world, "cli": cli,
               "flags": flags, "n1": ref, "n1_losses": want["losses"],
               "n1_ms": want["ms"],
               "losses_by_rank": [r["losses"] for r in got],
               "loss_max_rel": rel, "bar": S11_M2_TOL,
               "worst_leaf": worst, "worst_abs_diff": diff[worst],
               "params_within_bar": sorted(saved.files) == sorted(
                   want["params"]) and all(
                       np.allclose(saved[k], v, **S11_M2_TOL)
                       for k, v in want["params"].items()),
               "launches_by_rank": [r["launches"] for r in got],
               "wire_hops_by_rank": [r["wire_hops"] for r in got],
               "grad_reductions_by_rank": [r["grad_reductions"]
                                           for r in got],
               "param_bytes_by_rank": [r["param_bytes"] for r in got],
               "n1_param_bytes": want["param_bytes"],
               "host_staged_gloo_ms_per_step": [
                   r["host_staged_gloo_ms"] for r in got],
               "wall_s": time.perf_counter() - t0}
        emit(row)
        rows[name] = row
        require(row["params_within_bar"] and rel <= S11_M2_TOL["rtol"],
                f"plan {name} differs from N 1: {row}")
        require(all(r["losses"] == got[0]["losses"] for r in got),
                f"plan {name}: the ranks' metric sums differ")
        for r in got + (joined[ref] if ref in joined else []):
            want_k = s16_want(name, r)
            require(r["launches"] == want_k, f"plan {name} stage "
                    f"{r['stage']} seq {r['seq']}: launches "
                    f"{r['launches']}, want {want_k}")
            for k in launches:
                launches[k] += r["launches"][k]
            if cli != "lm":
                continue
            hops = S16_MICRO * (r["steps"] + (LM_VAL_BATCHES
                                              if r["stage"] == 0 else 0))
            require(r["wire_hops"] == hops, f"plan {name} stage "
                    f"{r['stage']}: {r['wire_hops']} wire payloads, "
                    f"want {hops}")
            fused = r["steps"] if world > 2 else 0
            require(r["grad_reductions"] == fused, f"plan {name}: "
                    f"{r['grad_reductions']} fused reductions, want "
                    f"{fused}")
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def slice16_phase(fa) -> tuple:
    """Phase 17 (module docstring). Returns (the ranks' K1-K4 launches,
    K1-K3 from pp2xsp2 ring_flash and ulysses_flash; the plan's
    hop-shape kernel rows)."""
    t_phase = time.perf_counter()
    s16_a()
    print(f"phase 17 (a) --plan dp1 at full width: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = s16_m2(S11_DEVICE)
    print(f"phase 17 (b) plans over gloo ranks: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    hops = s13_hop_kernels(fa, S16_HOP_CASES, "s16_hop_kernels")
    print(f"phase 17 (c) K1-K3 at the plan's hop shapes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, hops


def main() -> int:
    # cuBLAS reads this when it first starts: the determinism probe's
    # torch.use_deterministic_algorithms needs it (phase 7).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        return smoke()
    finally:
        for directory in SCRATCH:
            shutil.rmtree(directory, ignore_errors=True)


def smoke() -> int:
    phase_t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal phase_t0
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0:.1f} s", flush=True)
        phase_t0 = now

    # ---- 1. device -------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is "
            "false: this smoke run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.backends.cudnn.allow_tf32 = False

    from distributed_model_parallel_tpu_torch.cli import lm, serve
    from distributed_model_parallel_tpu_torch.data import lm as lm_data
    from distributed_model_parallel_tpu_torch.models.gpt import (
        GPTConfig,
        init_params,
    )
    from distributed_model_parallel_tpu_torch.ops import _cuda
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.ops import quant_matmul as qm
    from distributed_model_parallel_tpu_torch.parallel.sequence_parallel \
        import CausalLMSequenceParallelEngine
    from distributed_model_parallel_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from distributed_model_parallel_tpu_torch.training import optim
    phase_done("device")

    corpus_once = contextlib.ExitStack()  # every in-process LM CLI run
    corpus_once.enter_context(lm_corpus_made_once())

    # ---- 2. build: both sources at once, one nvcc each ----------------
    # phase 6's images meanwhile (numpy on the host, ~22 s)
    textures = in_background(make_textures)
    t0 = time.perf_counter()
    for source in ("int8_matmul.cu", "flash_attention.cu"):
        # a library left by an earlier run would give no ptxas report
        _cuda.library_path(source).unlink(missing_ok=True)
    _cuda.build(["int8_matmul.cu", "flash_attention.cu"])
    qm._library()
    fa._library()
    print(f"build: both sources in {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    spills = {}
    for source in ("int8_matmul.cu", "flash_attention.cu"):
        build_s, report = _cuda.build_info[source]
        print(f"build: {source} in {build_s:.2f} s", flush=True)
        lines, found = ptxas_summary(report)
        spills.update(found)
        for line in lines:
            print(line, flush=True)
    must_not_spill = [f"int8_matmul_kernel<V={v},S={s}>"
                      for v in (1, 4) for s in (2, 8)]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for dtype, tiles in fa.DEFAULT_TILE[name].items():
            for dh, (t0, t1) in tiles.items():
                if name == "flash_bwd_dkv" and dh != 64:
                    continue  # K3: the path's Dh (Dh 128 is printed)
                names = ("keys", "rows") if name == "flash_bwd_dkv" \
                    else ("rows", "keys")
                must_not_spill.append(
                    f"{name}_kernel<"
                    f"{'f32' if dtype == torch.float32 else 'bf16'},"
                    f"Dh={dh},{names[0]}={t0},{names[1]}={t1}>")
    for label in must_not_spill:
        require(spills.get(label) == 0,
                f"{label}: ptxas spill stores {spills.get(label)}")
    phase_done("build")

    # ---- 3. kernel vs plain version ---------------------------------
    shapes = []
    for i, (name, k, n) in enumerate(DECODE_SHAPES):
        r = check_shape(qm, SLOTS, k, n, seed=i)
        r["projection"] = name
        shapes.append(r)
        emit({"int8_matmul_shape": r})
    for i, (m, k, n) in enumerate(EXTRA_SHAPES + VERIFY_SHAPES):
        r = check_shape(qm, m, k, n, seed=10 + i)
        shapes.append(r)
        emit({"int8_matmul_shape": r})
    max_err = max(r["max_abs_err"] for r in shapes)
    phase_done("int8 kernel vs plain")
    flash_errs, flash_times = flash_phase(fa)
    phase_done("flash kernels vs plain")

    # ---- 4. serving at full width (a main path) ----------------------
    reset_counts(fa, qm)
    out_f32 = serve_run(serve, SERVE_FLAGS + ["--compute-dtype", "f32"])
    require(qm.int8_matmul.launches == 0,
            "the f32 run launched the int8 kernel")
    reset_counts(fa, qm)
    out_i8 = serve_run(serve, SERVE_FLAGS + ["--compute-dtype", "int8"])
    launches = qm.int8_matmul.launches
    require(not any(counts(fa).values()), "serving launched flash kernels")
    steps = out_i8["serving"]["decode_steps"]
    require(steps > 0 and launches == 4 * LAYERS * steps,
            f"int8 run launched the kernel {launches} times over {steps} "
            f"decode steps; want {4 * LAYERS} per step")
    for name, out in (("f32", out_f32), ("int8", out_i8)):
        s = out["serving"]
        require(s["requests"] == 16 and s["generated_tokens"] == 16 * 32,
                f"{name} run finished {s['requests']} requests / "
                f"{s['generated_tokens']} tokens")
        emit({"serve": name, "device": s["device"],
              "tokens_per_s": s["tokens_per_s"],
              "decode_p50_ms": s["decode_p50_ms"],
              "decode_p99_ms": s["decode_p99_ms"],
              "ttft_p50_ms": s["prefill_p50_ms"],
              "ttft_p99_ms": s["ttft_p99_ms"],
              "decode_steps": s["decode_steps"],
              "mean_batch_occupancy": s["mean_batch_occupancy"]})
    pairs = [(a, b) for ra, rb in zip(out_f32["requests"],
                                      out_i8["requests"])
             for a, b in zip(ra["tokens"], rb["tokens"])]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    readings, breakdown = first_step_readings(serve, ServingEngine,
                                              GPTConfig, qm)
    small = small_model_matches_cpu(ServingEngine, GPTConfig, init_params)
    emit({"int8_kernel_launches": launches, "decode_steps": steps,
          "launches_per_step": launches / steps,
          "greedy_token_agreement_int8_vs_f32": agree,
          "int8_vs_f32_card_rel": readings["int8_vs_f32_card"]["rel"],
          "int8_vs_f32_cpu_rel": readings["int8_vs_f32_cpu"]["rel"],
          "card_vs_cpu_max_abs": readings["card_vs_cpu_max_abs"],
          "small_model_gpu_vs_cpu_max_abs_err": small,
          "decode_step_breakdown": breakdown})
    phase_done("serving")

    # ---- 5. LM training at GPT-2-small width (a main path) -----------
    with without_saves():
        lm_rows = [lm_run(lm, CausalLMSequenceParallelEngine, fa, qm, *run)
                   for run in LM_RUNS]
    phase_done("LM training")
    training_card_vs_cpu(fa, CausalLMSequenceParallelEngine, GPTConfig,
                         init_params, optim, lm_data)
    phase_done("training card vs CPU")

    # ---- 6. data-parallel MobileNetV2 training (a main path) ----------
    reset_counts(fa, qm)
    with without_saves():
        _, dp_data = dp_phase(textures)
    require(not any(counts(fa).values()) and qm.int8_matmul.launches == 0,
            "data-parallel training launched a K1-K4 kernel")
    phase_done("data-parallel training")

    # ---- 7. checkpoint and resume (the slice-6 paths) -----------------
    from distributed_model_parallel_tpu_torch.cli import data_parallel
    from distributed_model_parallel_tpu_torch.parallel import (
        data_parallel as dp_mod,
    )

    determinism_probe(dp_data)
    reset_counts(fa, qm)
    checkpoint_dp_phase(data_parallel, dp_mod, dp_data)
    require(not any(counts(fa).values()) and qm.int8_matmul.launches == 0,
            "data-parallel resume launched a K1-K4 kernel")
    phase_done("checkpoint and resume: data-parallel")
    lm_resume, lm_dir = checkpoint_lm_phase(
        lm, CausalLMSequenceParallelEngine, fa, qm)
    phase_done("checkpoint and resume: LM")
    serve_ckpt = checkpoint_serve_phase(
        serve, ServingEngine, GPTConfig, fa, qm, lm_dir,
        readings["int8_vs_f32_card"]["rel"])
    phase_done("checkpoint and resume: serve --checkpoint")
    slice6 = {name: sum(r[name] for r in lm_resume["launches"].values())
              for name, _, _ in FLASH_KERNELS}
    slice6["int8_matmul"] = serve_ckpt["int8_launches"]

    # ---- 8. pipeline model parallelism (the slice-7 paths) -------------
    with without_saves():
        _, _, slice7 = pipeline_phase(dp_data, lm, fa, qm)
    phase_done("pipeline model parallelism")

    # ---- 9. serving features (the slice-8 paths) ----------------------
    slice8 = serving_features_phase(serve, ServingEngine, GPTConfig, fa, qm,
                                    lm_dir, out_f32)
    phase_done("serving features")

    # ---- 10. remat, CUDA graphs, trace / metrics, ViT and BERT --------
    reset_counts(fa, qm)
    made_once = contextlib.ExitStack()  # phases 10-13 share BERT's inputs
    made_once.enter_context(bert_made_once())
    with without_saves():
        slice9, replays9, tries9 = slice9_phase(lm, fa, qm, lm_rows,
                                                dp_data)
    phase_done("remat, steps per dispatch, classifiers")

    # ---- 11. gradient reduction (slice 10) ---------------------------
    with without_saves():
        slice10 = slice10_phase(lm, fa, qm, dp_data)
    phase_done("gradient reduction")

    # ---- 12. tensor parallelism, device cache, image folders ---------
    with without_saves():
        slice11 = slice11_phase(fa, qm, dp_data)
    phase_done("tensor parallelism, device cache, image folders")

    # ---- 13. FSDP, sharded checkpoints, elastic restart ---------------
    slice12 = slice12_phase(lm, CausalLMSequenceParallelEngine, fa, qm,
                            dp_data, lm_resume)
    del dp_data
    made_once.close()
    phase_done("FSDP, sharded checkpoints, elastic restart")

    # ---- 14. sequence parallelism at N 2 (slice 13) -------------------
    slice13, hops13 = slice13_phase(lm, CausalLMSequenceParallelEngine, fa)
    phase_done("sequence parallelism")

    # ---- 15. the tp / sp serving layouts, collective matmul -----------
    slice14, shapes14 = slice14_phase(fa, qm, {"f32": out_f32,
                                               "int8": out_i8})
    phase_done("tp / sp serving layouts and collective matmul")

    # ---- 16. expert parallelism (slice 15) ---------------------------
    slice15 = slice15_phase(lm, fa, qm)
    phase_done("expert parallelism")

    # ---- 17. composed parallel plans (slice 16) ------------------------
    slice16, hops16 = slice16_phase(fa)
    phase_done("composed parallel plans")

    corpus_once.close()

    # ---- 18. kernels line, card line, last line ----------------------
    decode = [r for r in shapes if r["M"] == SLOTS]
    step = {key: None if any(r[key] is None for r in decode)
            else LAYERS * sum(r[key] for r in decode)
            for key in ("kernel_ms", "kernel_device_ms", "plain_ms",
                        "library_ms", "library_device_ms",
                        "int_mm_device_ms", "bound_ms", "bytes", "ops")}
    emit({"kernels": [{
        "name": "int8_matmul",
        "route": "cuda",
        "source": "distributed_model_parallel_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "distributed_model_parallel_tpu/ops/quant_matmul.py:190",
        "design": INT8_DESIGN,
        "launches": launches,
        # serve --checkpoint int8 (phase 7), counted apart
        "launches_slice6": slice6["int8_matmul"],
        # the pipeline phase (phase 8): none on the pipeline paths
        "launches_slice7": slice7["int8_matmul"],
        # the serving-features phase (phase 9): paged and speculative
        # int8 decode and verify steps
        "launches_slice8": slice8["int8_matmul"],
        # phase 10: the LM, DP, pipeline and classifier runs of slice 9
        "launches_slice9": 0,
        "replays_slice9_traced": 0,
        # phase 11: the gradient-reduction runs (none on this path)
        "launches_slice10": slice10["int8_matmul"],
        # phase 12: tensor parallelism, the device cache and the image
        # folders (none on this path)
        "launches_slice11": slice11["int8_matmul"],
        # phase 13: FSDP, the sharded format, elastic restart (none)
        "launches_slice12": slice12["int8_matmul"],
        # phase 14: sequence parallelism at N 2 (none)
        "launches_slice13": slice13["int8_matmul"],
        # phase 15: the tp / sp serve runs of both ranks (tp int8: 48 a
        # decode step a rank, 96 on the rings at S 2), none in (d)
        "launches_slice14": slice14["int8_matmul"],
        # phase 16: the MoE LM runs and the EP ranks (none on this path)
        "launches_slice15": slice15["int8_matmul"],
        # phase 17: the plan runs (none on this path)
        "launches_slice16": slice16["int8_matmul"],
        # phase 15 (c): the Megatron shard and ring-chunk shapes
        "shard_and_ring_shapes": shapes14,
        "max_abs_err": max_err,
        # Times of one decode step's 48 launches (12 layers x the four
        # projection shapes at M = 8), each shape timed in phase 3.
        "ms": step["kernel_ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": ("bytes" if step["bytes"] / HBM_BYTES_PER_S
                     >= step["ops"] / INT8_OPS_PER_S else "operations"),
        "library_ms": step["library_ms"],
        # Device time (profiler) of the same 48 launches, and of the f32
        # torch.matmul yardstick: an unquantized product, not the
        # kernel's function.
        "device_ms": step["kernel_device_ms"],
        "library_device_ms": step["library_device_ms"],
        # cuBLASLt's s8 x s8 -> s32 (torch._int_mm, M padded to 32) on the
        # same codes: the integer product alone, not K4's function.
        "int_mm_device_ms": step["int_mm_device_ms"],
        "per_shape": shapes,
    }] + [dict(flash_entry(name, replaces, lm_rows, flash_errs,
                           flash_times), launches_slice6=slice6[name],
               launches_slice7=slice7[name], launches_slice8=slice8[name],
               launches_slice9=slice9[name],
               replays_slice9_traced=replays9[name],
               # the LM k = 4 runs made, by dtype, until the --profile-dir
               # trace held every replay (S9_TRACE_TRIES)
               trace_tries_slice9=tries9,
               launches_slice10=slice10[name],
               launches_slice11=slice11[name],
               launches_slice12=slice12[name],
               # phase 14 (a, c): both gloo ranks of every N 2 run
               launches_slice13=slice13[name],
               # phase 15 (d): both ranks' LM runs, with and without
               # --collective-matmul
               launches_slice14=slice14[name],
               # phase 16: the MoE LM attends dense (none)
               launches_slice15=slice15[name],
               # phase 17 (b): every rank of pp2xsp2 ring_flash and
               # ulysses_flash
               launches_slice16=slice16[name],
               # phase 14 (b): one launch at each ring / Ulysses shape
               hop_shapes={case: row[name] for case, row in hops13.items()},
               # phase 17 (c): the same at the plan's microbatch
               plan_hop_shapes={case: row[name]
                                for case, row in hops16.items()})
          for name, _, replaces in FLASH_KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
