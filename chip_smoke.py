#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  Phases, one JSON line each:

1. device   — the card (``nvidia-smi`` name and power limit); TF32 off.
2. build    — compile every ``mxnet_tpu_torch/ops/csrc/*.cu`` (one nvcc
              each, in parallel) and report seconds and each kernel
              function's registers and spills (ptxas); no tensor-core
              flash kernel (bf16, and the f32 3xTF32 forward, dQ and
              dK/dV) may spill, at any head dim.
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card at its path's shapes: 2-bit pack and unpack (ResNet-50's
              193 gradient shapes and edge sizes, thresholds 0.5, 0 and
              1e9, bit for bit; timed at the largest gradient and summed
              over one step's), BatchNorm stats and normalize
              (ResNet-50's shapes, f32 and bf16, bitwise repeatable; and
              BatchNorm's gradient through them), LayerNorm (forward at
              M = 8, 512 and the LM training step's 8,192 rows, and its
              gradient — kernel forward plus autograd — at the training
              rows), paged attention over the float pool and over the int8
              pool (q in float32 and bfloat16; decode at block sizes 32
              and 16, one 1,000-position row, three queries a row, head
              dims 128 and 40, speculative verify steps at T = 2, 4
              and 5 over B = 8 ragged rows, and T=512 prefill chunks;
              bitwise
              repeatable; timed over table sets that cycle past the L2;
              decode and verify at T <= 4 launching the split and merge
              kernels, prefill and verify at T = 5 the tile kernel, by
              kernel name), and the three flash
              attention kernels (forward with lse, dQ, dK/dV; float32 and
              bfloat16, causal and not, the training shape, a ragged T and
              D = 16, 32 and 128; the backward kernels bitwise equal over
              two runs; bf16 launching the three tensor-core kernels
              and f32 the three 3xTF32 kernels, by kernel name; a NaN in
              q and in g, causal and not, NaN where the plain versions'
              are, by the rule in ``_flash_nan_cases``).  With the
              error, the kernel's time, the plain version's, a library
              call's where one computes the same function, and the least
              time the card could take (bytes or operations over the H100's
              peak rates).
4. model    — the GPT-2-small-width LM (random weights from a seed): a
              prefill chunk plus T=1 decode steps through the paged KV
              cache and both kernels, against the full-sequence forward;
              the same through an int8 pool, the paged path (the int8
              kernel) against the dequantizing gather path.
5. training — the reference trainer's LM step (B=8, T=1024, labels the
              tokens rolled by one, lr 0.1, momentum 0.9) at the same width:
              one float32 ``train_step`` with flash attention against one
              with ``local_attention`` (loss and every gradient; wall and
              device time of each), then ten
              chained bfloat16 steps through the flash kernels (losses
              finite and falling, 12 launches of each flash kernel and 25
              LayerNorms per step); step ms, tokens/s, peak memory.
6. serving  — ``GenerationService`` on ``cuda`` serves 12 requests (8
              greedy, 4 sampled) through reserve-ahead admission, chunked
              prefill and continuous-batching decode; greedy tokens are
              checked teacher-forced against the full-sequence forward
              and against the same request served alone; both kernels
              must have launched on this path.
7. serving_default — the same model under the reference's default
              ``GenerationConfig`` (incremental allocation with
              preemption, the prefix cache) on a 52-block pool: two waves
              of requests sharing 256-token system prompts; greedy tokens
              checked teacher-forced; preemption, prefix hits and
              copy-on-write copies must all have happened.
8. serving_int8 — the ``serving`` phase's requests with
              ``kv_dtype="int8"``: all complete, only the int8 kernel
              serves attention, and greedy tokens agree with the float
              pool's on >= 75% of positions.
9. resnet_training — ``bench.py``'s flagship step: Gluon ``resnet50_v1``
              channels-last at 224x224 (random weights from a seed); an
              f32 step at B=32 with the BatchNorm kernels against one
              with the plain BatchNorm, then ten bf16 steps at B=128 (53
              launches of each BatchNorm kernel a step); images/s, peak
              memory.
10. resnet_compressed — the same net through the port's mesh-less
              ``DataParallelTrainer`` (Gluon ``SoftmaxCrossEntropyLoss``,
              bf16 compute, lr 0.1, momentum 0.9) at B=128: ten steps
              without compression and ten with ``{"type": "2bit",
              "threshold": 0.5}``, twice each in turns (one pack and one
              unpack launch per trainable parameter a step, 53 of each
              BatchNorm kernel); step ms, images/s, peak memory of each,
              and the compression alone between syncs.  Checks: the f32
              trainer loss against resnet_training's step, and a step at
              threshold 1e9 that leaves every parameter unchanged and the
              gradients in the residuals.
11. gluon_training — the imperative Gluon loop on the same net in f32
              (``NDArray``, ``autograd.record``/``backward``,
              ``gluon.Trainer`` over the ``device`` kvstore,
              ``DataLoader``, parameter files; cuDNN deterministic): one
              Trainer step at B=32 against ``_resnet_step`` (loss 1e-6,
              weights against the net's noise floor, running statistics),
              ten steps at B=128 from a ``DataLoader`` over 1,280 random
              images (53 launches of each BatchNorm kernel a step and no
              other; the first two updates lower the repeated first
              batch's loss; two backwards leave one gradient), images/s
              and peak memory beside ``_sgd_foreach_step``'s (the same
              ``_foreach`` SGD pass over ``block_train_fn`` and over the
              block called with tensors) on the same batches and one
              profiled step of each, three 2-bit
              steps at B=32 (a pack and an unpack per trainable parameter
              a step; the residuals and pulled gradients bit for bit
              against the plain 2-bit round trip), a dataset kept on the
              card (batches stacked on the card), and ``save_parameters``/
              ``load_parameters`` (outputs and file bytes bitwise).
12. module_fit — ``Module.fit`` over the symbolic API: the example
              ResNet-50 symbol (``_example_resnet_symbol``, NCHW, through
              ``tojson`` and ``sym.load_json``) on the default context in
              f32 (cuDNN deterministic), ``NDArrayIter`` over 12 x 128
              random images, ``kvstore="tpu_sync"``, SGD lr 0.05
              momentum 0.9 with a ``MultiFactorScheduler``, Xavier,
              metrics acc and top-5, ``Speedometer``, ``do_checkpoint``.
              Checks: a fused Module step against a legacy one (1e-6,
              bitwise reported); the cifar-depth symbol on the card
              against the CPU (outputs, gradients, moving statistics);
              losses finite and the first two updates lowering the
              repeated first batch's loss; the checkpoint files read
              back bitwise; a channels-last check net through the
              BatchNorm kernels (one stats and one normalize launch per
              BatchNorm node a step) against its CPU run.  Images/s, step
              ms, the executor's host ms a forward, a profiled step's
              device time and idle share, peak memory, the metrics.
13. gluon_hybrid — the rest of the Gluon surface: ``inception_v3(
              classes=1000, layout="NHWC")`` (Xavier magnitude 2),
              ``cast("bfloat16")``, ``hybridize()`` (each call replays
              two captured CUDA graphs), ``Trainer("sgd", lr 0.1,
              momentum 0.9, wd 1e-4, multi_precision)`` and
              ``SoftmaxCrossEntropyLoss`` on one B=128 batch of 299x299
              images kept on the card: ten hybridized steps, then ten
              eager ones (``hybridize(False)``); step ms, images/s, a
              profiled step's idle share and its 94 + 94 BatchNorm
              launches by kernel name, peak memory, each way.  Checks:
              (a) a captured program bitwise against the same program
              uncaptured on the card (outputs, gradients, running
              statistics; f32, cuDNN deterministic) and one bf16 step of
              the cast check net; (b) ``uniform`` bits and a ``Dropout``
              mask card = CPU bitwise, the kept fraction binomial; (c) the
              repeated batch's loss falls, no NaN; (d) ``load_parameters``
              on a hybridized net is seen; (e) ``export`` +
              ``SymbolBlock.imports`` reproduce the hybridized net's
              output; (f) ``gluon.nn.LayerNorm`` on the card launches the
              LayerNorm kernel.

14. rnn_lm — ``example/gluon/word_language_model/train.py``'s
              ``RNNModel`` (``Embedding`` -> ``gluon.rnn.LSTM`` -> ``Dense``)
              at the upstream example's medium width (650/650, two
              layers, dropout 0.5, vocab 33,278), bptt 35, batch 32, f32:
              the ``RNN`` op (lstm and gru, two layers, bidirectional) on
              the card against the CPU (outputs, final states, gradients;
              TOL float32), then twenty truncated-BPTT steps
              (``clip_global_norm``, ``Trainer("sgd")``) over the example's
              Markov token stream; the first segment's loss falls, nothing
              is NaN (SGD lr 20 and clip 0.2, the upstream defaults).
              Tokens/s, step ms, peak memory, a profiled step's
              idle share, and cuDNN's LSTM forward + backward beside the
              port's op (a yardstick, never on the path).
15. bucketing_fit — ``example/rnn/bucketing/lstm_bucketing.py`` at its
              widths (2 x ``LSTMCell(200)``, embed 200, buckets 10-40,
              batch 32, Adam lr 0.01, Xavier(in, 2.34)) over ``word_lm.py``'s
              Markov corpus (3,200 sentences of 5-40 tokens, vocab 10,000):
              two epochs of ``BucketingModule.fit`` (every bucket bound,
              perplexity falls, no fused step); a bucket switch sees the
              trained weights; one step per bucket card vs CPU (loss and
              gradients 1e-4); a ``FusedRNNCell`` against its ``unfuse()``d
              cells on the card.  Sentences/s, ms a step per bucket, the
              executor's host ms a forward.
16. image_rec — ``ImageRecordIter`` over a RAW0 ``.rec`` of 1,280
              random 256x256 images (``train_imagenet``'s settings: resize
              256, random 224 crops and mirrors, its mean) on 8 threads,
              uint8 to the card and normalized there: one-thread batches
              card = CPU bitwise with an exact trailing pad, the iterator's
              images/s alone, and ``Module.fit``'s ms a batch over four
              batches of the example ResNet-50 symbol fed by it (beside
              module_fit's ``NDArrayIter`` figure when that phase ran).
17. serving_spec — speculative and multi-step decode at the same LM
              width: ``bench.py`` ``speculative_decode_throughput``'s mix
              (16 requests, half periodic, prompts 24 or 48, 64 new
              tokens, 4 sampled) in waves of 8 slots, served single-step,
              multi-step (k=8: one CUDA-graph replay a dispatch), n-gram
              speculative (draft_k=4) and self-draft speculative (the
              target as draft, window 128), then single-step, multi-step
              and n-gram on the int8 pool.  Checks: multi-step = single-
              step bit for bit (float, int8); speculative tokens teacher-
              forced (greedy, and sampled with their Gumbel keys; int8
              n-gram may miss at most twice the positions, at least 2,
              that single-step int8 misses against the float forward); self-
              draft greedy acceptance >= 0.9; no program key or capture
              after warmup; LayerNorm and the pool's paged kernel launched.
              Tokens/s per mode, mean accepted length, verify and multi-
              step ms per iteration against single-step's.
18. serving_fleet — ``GenerationRouter`` with two replicas on the card
              (affinity on, tracing on, the flight recorder in a temporary
              directory) serving ``serving_default``'s traffic: plainly
              (teacher-forced), with replica 1 killed after its third
              dispatch (queued work resubmitted and finished, only streams
              under way end in ``ReplicaDeadError``) and with one request
              failing every step (it alone ends in ``GenerationStepError``,
              the others' tokens equal the plain run's, a
              ``gen_quarantine`` dump names it); the generation gauges in
              ``to_prometheus()``, both replicas in ``health()``.
19. ops_breadth — every op name of ``_breadth_cases`` (194 names: the
              image, detection, spatial and CTC ones among them, CTC
              also at the OCR example's batch of 32) on
              the card against the same call on the CPU: output
              dtypes, outputs and gradients within rtol 1e-5 (an
              absolute floor of 1e-5 x the largest magnitude), the
              ``linalg_*`` decompositions by their reconstructions, the
              sampling ops' tokens exactly, sort/topk ties as on the CPU;
              a channels-last ``BatchNorm_v1`` launches kernels 3-4.
              Then ``_contrib_flash_attention``/``flash_attention`` at
              the LM training shape (B=8, T=1024, H=12, D=64), f32 and
              bf16, causal and not: one launch of each flash kernel a
              forward + backward (wrapper counts and kernel names), out
              and gradients against the plain versions under ``TOL``.
20. fcn_fit — FCN-32s (``symbol/fcnxs.py``: the public example's
              ``get_fcn32s_symbol``, VGG-16 trunk, 21 classes) by
              ``Module.fit``, f32 NCHW, B=8 at 500x500, ``fcn_xs.py``'s
              SGD (lr 1e-10, momentum 0.99, wd 5e-4), labels with 255s
              ignored: ``init.Bilinear`` on ``bigscore`` equal to the
              numpy filter; one fused ``Module.fit`` step's loss and
              every gradient card vs CPU at B=1, 224x224 (normwise
              within 1e-3, or 3 x the card-vs-card floor where that is
              larger, the tensors past 1e-3 listed; cuDNN
              deterministic); two warm-up and ten timed batches from the
              public init (``bigscore`` per class): images/s, median
              step, the fused step alone and the host metric's update,
              peak memory, a profiled step's idle share, and the
              Deconvolution's own forward and backward ms; the fit must
              lower the first batch's loss and move conv1_1.  No port
              kernel on this path: its launch counts stay 0.

21. spmd_lm — ``make_sharded_train_step`` over a world of one process on
              NCCL (``make_mesh(dp=1, sp=1)``; NCCL refuses two ranks on
              one card) at GPT-2 width, B=8, T=1024: ulysses_flash in f32
              and bf16, ulysses and ring in f32, each step against
              ``train_step`` with the same attention callable (loss 1e-5,
              gradients 1e-4); 12 launches of each flash kernel a
              ulysses_flash step (wrapper counts and kernel names), NCCL's
              96 all-to-alls on the device timeline of the profiled step
              (at one rank NCCL copies and launches no kernel of its
              own); the flash kernels through
              Ulysses against their plain versions; step ms of each.
22. dp_mesh — ``DataParallelTrainer(mesh=dp_mesh(1))`` over the world of
              one on resnet_compressed's net (B=128, bf16): ten steps
              plain (BatchNorm synced over dp, the path of any world
              size), ten with 2-bit at t = 0.5; the first step of each
              bit for bit against the mesh-less trainer's; 53 + 53
              BatchNorm launches a step, and 193 + 193 2-bit launches with
              compression (also by kernel name); the 2-bit kernels on the
              step's largest gradient against their plain versions.
23. dist_kvstore — ``tools/launch.py -n 2`` starts two worker processes
              on the one card (the parameter server in rank 0's): five
              ``gluon.Trainer(kvstore="dist_sync")`` steps of
              ``resnet50_v1`` f32 with 2-bit pushes (SGD on the server),
              then one ``Module.fit`` epoch of the cifar ResNet-20 symbol
              over ``dist_sync``; both workers' parameters bitwise equal
              after every step, the loss falls, 193 packs a step a worker
              and 2 x 193 server unpacks a step in rank 0's process; the
              first two steps' pushes bitwise the plain pack on the plain
              residual chain, and the server's values after them against
              their recomputation from the codes sent; the fit's first
              step against the same job on the CPU; wall ms a
              step and its parts, bytes pushed and pulled a step.

24. model_parallel — model parallelism over a world of one on NCCL at
              GPT-2 width: ``make_partitioned_train_step`` (dp=1 x mp=1,
              f32, B=8, T=1024) by the compute (tensor-parallel) and
              storage (FSDP) routes against ``train_step`` (loss 1e-5,
              gradients 1e-4), 25 LayerNorms a step by wrapper and by
              kernel name; ``pipeline_apply_sharded`` at pp=1 (the 12
              blocks as one stage, 8 microbatches) against the
              sequential blocks; ``moe_apply_sharded`` at ep=1 (a Switch
              FFN over 8,192 tokens) against its dense oracle;
              ``paged_attention_sharded`` at mp=1 bitwise
              ``paged_attention`` (decode and prefill, float and int8
              pools; kernels by name).  The four-card legs are
              ``chip_multicard.py``'s.

25. fit_resume — fault-tolerant ``Module.fit`` right after module_fit,
              on its ResNet-50 symbol at B=32 over 12 batches (f32, cuDNN
              deterministic, seeded numpy parameters): an uninterrupted run
              whose telemetry gauges (every 4 steps) equal the norms of
              ``get_params`` and the gradients (rtol 1e-5); a second one
              (the card's floor); telemetry off and an async checkpoint
              every 2 steps, both bitwise the first; a run checkpointing
              every 4 steps preempted at step 7 (a real SIGTERM) that
              returns False after a synchronous checkpoint, and a fresh
              Module resuming it to the uninterrupted losses and
              parameters bitwise (or within the floor); the newest
              checkpoint flipped, restore takes the one before; the
              channels-last check net through the same flow (its
              BatchNorm kernels' launches).  Save ms and bytes, step ms
              with and without a write in flight, with telemetry on and
              off; no failed write.
26. inference_service — ``serving.InferenceService`` over the ResNet-50
              symbol bound for inference at B=32: after ``warmup`` 8
              client threads send 512 single images (4, then 16 in flight
              each, a fresh service each time); every output equals
              the image's row of one ``Module.predict`` (rtol 1e-5, or the
              card's floor where a bucket's batch size moves cuDNN), no
              executor bound after warmup; requests/s, p50/p99 latency,
              batch occupancy beside predict's images/s.  A BERT-base-width
              FFN block with ``LayerNorm`` at sequence 128 served the same
              way (kernel 5 once a forward), and ``Module.predict`` on a
              final batch of 8 after 32 (the padded tail's rows equal the
              predict rows).

27. sparse_fit — ``example/sparse/linear_classification.py``'s linear
              classifier at upstream's Avazu width (1,000,001 features,
              batch 8192), its data declared ``stype="csr"``, over 16
              batches of seeded synthetic LibSVM rows (5-19 values a row):
              ``LibSVMIter``'s rows/s parsing and serving to the card,
              two epochs of ``Module.fit`` (samples/s, step ms, the peak
              device bytes it adds under 1 GiB; no dense batch exists),
              three steps card against CPU, and the example's ``main`` at
              its defaults reaching the CPU's accuracy; no port kernel.
28. control_flow — a two-layer LSTM word LM of ``sym.contrib.foreach``
              cells at rnn_lm's width (vocabulary 33,278, 650/650, bptt
              35, batch 32): loss and gradients card against CPU, its
              outputs against the fused ``RNN`` op's with the same weights,
              step ms beside the ``RNN``-op LM's and rnn_lm's; a foreach
              body of LayerNorm launching kernel 5 35 times a forward,
              held against the plain version's loop; a hybridized
              ``while_loop``/``cond`` block captured on the card against
              the CPU; the foreach graph saved and loaded, bitwise.
29. image_iter — the Python image feeds: ``ImageRecordIter(use_native=
              False)`` at image_rec's settings over an indexed RAW0 file
              (and a C = 1 one), card batches = CPU batches bitwise under
              the same seeds, its images/s alone; then
              ``gluon.data.vision.ImageRecordDataset`` + transforms +
              ``DataLoader`` (its images/s alone; transforms on the
              card, its first batch against the CPU's) feeding Gluon
              ResNet-50 v1 steps channels-last: ms a step, 53 + 53
              BatchNorm launches a step.
30. ssd_fit — ``ImageDetIter`` into example/ssd's loop: the ToySSD (64²,
              B=16, Adam) three steps card against CPU (losses and the
              final ``MultiBoxDetection`` within 1e-4, the same rows
              kept; hybridized blocks running ``MultiBoxDetection`` and
              color jitter stay uncaptured), then an SSD over ``resnet50_v1``'s features at 3 x
              512², B=32, 20 classes: ms a step, ``MultiBoxTarget`` and
              ``MultiBoxDetection`` (nms_topk 400) alone, peak bytes, 53 +
              53 BatchNorm launches a step.

Every ResNet phase also requires that the BatchNorm op copied no
non-contiguous input (``batch_norm.noncontiguous_copies`` stays 0); no
port kernel runs on the three sequence and RecordIO paths, so their
launch counts must stay 0.

An optional comma-separated argument (``kernels``, ``model``,
``training``, ``serving``, ``serving_default``, ``serving_int8`` — which
also runs ``serving``, its float baseline — ``resnet_training``,
``resnet_compressed``, ``gluon_training``, ``module_fit``,
``gluon_hybrid``, ``rnn_lm``, ``bucketing_fit``, ``image_rec``,
``serving_spec``, ``serving_fleet``, ``ops_breadth``, ``fcn_fit``,
``spmd_lm``, ``dp_mesh``, ``dist_kvstore``, ``model_parallel``,
``module_parallel``, ``amp``, ``fit_resume``, ``inference_service``,
``inference_int8``, ``optimizers``, ``custom_op``, ``sparse_fit``,
``control_flow``, ``image_iter``, ``ssd_fit``, and
``profile``, ``profile_training`` and ``profile_resnet``, which are not in
the default run: the serving window, or two bf16 LM or ResNet training
steps, once more under ``torch.profiler``)
runs only those phases after device and build.  Then the kernel table line
(when ``kernels`` and a path ran), the ``nvidia-smi`` line and, last, the
result line ``{"ok": true, "device": {...}}``.  Any failure raises: the
script exits non-zero and prints no result line.  It also exits non-zero
without a CUDA device or without the rest of the repository beside it.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peak rates (NVIDIA data sheet, dense): device memory bandwidth,
# f32 outside the tensor cores, bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# f32 accuracy on the tensor cores takes three TF32 products (3xTF32), so
# the least time for f32 products is the faster of the two routes
PEAK_FLOPS["float32_3xtf32"] = max(PEAK_FLOPS["float32"],
                                   PEAK_FLOPS["tf32"] / 3)

# kernel vs plain version on the same card
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-3),
       # BatchNorm kernels: f32 statistics and f32 out; bf16 out within one
       # bf16 ulp beyond this
       "batch_norm": dict(rtol=1e-5, atol=1e-5)}
# BatchNorm's gradient through the kernel forward against the plain
# forward's, normwise (bf16: the two outputs may differ by one bf16 ulp)
BN_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024)
# LayerNorm's rows: a decode batch, a prefill chunk, and the LM training
# step's B x T = 8 x 1024
LN_ROWS = (8, 512, 8192)
SEED = 0
# flash attention shapes (B, T, H, D): the LM training step's, a T that is
# no multiple of the kernels' 64-row tiles, and the other head dims (every
# instantiation of each kernel, float32 and bfloat16)
FLASH_SHAPES = {"training": (8, 1024, 12, 64), "ragged": (2, 1000, 3, 64),
                "d16": (2, 200, 2, 16), "d32": (2, 200, 2, 32),
                "d128": (2, 200, 2, 128)}
# the flash kernel functions each dtype must launch (bf16: the tensor-core
# forward, dQ and dK/dV; f32: the 3xTF32 forward, dQ and dK/dV)
FLASH_ROUTES = {"bfloat16": ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                             "flash_dkv_tc_kernel"),
                "float32": ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel",
                            "flash_dkv_tf32_kernel")}
# ResNet-50's BatchNorm inputs (B, H, W, C) at B = 128, 224x224: the stem,
# stages 1, 2 and 4; and an odd M = B*H*W
BN_SHAPES = ((128, 112, 112, 64), (128, 56, 56, 256), (128, 28, 28, 512),
             (128, 7, 7, 2048), (1, 1, 12345, 320))
# resnet_training: bench.py's flagship step (resnet50_v1, 1000 classes,
# channels-last 224x224x3, SGD lr 0.1 momentum 0.9) and its 53 BatchNorms
# (stem 1, 16 bottleneck units x 3, 4 projections)
RESNET_CLASSES, RESNET_HW, RESNET_BNS = 1000, 224, 53
RESNET_BATCH, RESNET_F32_BATCH = 128, 32
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
# the port's CUDA kernel functions, as the profiler names them
PORT_KERNELS = ("twobit_pack_kernel", "twobit_unpack_kernel",
                "bn_stats_partial", "bn_stats_final", "bn_normalize",
                "layer_norm_kernel", "flash_fwd_tf32_kernel",
                "flash_dq_tf32_kernel", "flash_dkv_tf32_kernel",
                "flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                "flash_dkv_tc_kernel",
                "paged_decode_split_kernel", "paged_decode_merge_kernel",
                "paged_prefill_tile_kernel")
# serving_default's pool: small enough that its two waves preempt
DEFAULT_POOL_BLOCKS = 52
# 2-bit compression: the reference's documented default threshold; the
# pack/unpack edge sizes (one element, a 2048-element row less and more
# one, the TPU kernel's 64-row block, one element past it — padded to 128
# rows — and 65 rows); chained steps of each resnet_compressed trainer
TWOBIT_THRESHOLD = 0.5
TWOBIT_EDGES = (1, 2047, 2049, 64 * 2048, 64 * 2048 + 1, 65 * 2048)
COMPRESSED_STEPS = 10
# gluon_training: the imperative loop's DataLoader samples and steps, and
# its compressed steps (at RESNET_F32_BATCH)
GLUON_SAMPLES, GLUON_STEPS, GLUON_COMPRESSED_STEPS = 1280, 10, 3
# module_fit: Module.fit over the example ResNet-50 symbol (bench.py
# e2e_throughput's SGD: lr 0.05, momentum 0.9, no wd; a MultiFactorScheduler
# step at update 8), the cifar card-vs-CPU check's batch, and the
# channels-last check net (units of 1x1 conv + BatchNorm + ReLU)
FIT_BATCHES, FIT_LR, FIT_MOMENTUM = 12, 0.05, 0.9
FIT_LR_STEPS, FIT_LR_FACTOR = (8,), 0.1
CIFAR_BATCH = 16
NHWC_BATCH, NHWC_BATCHES, NHWC_HW, NHWC_C, NHWC_UNITS = 32, 3, 56, 256, 3
# fit_resume: module_fit's symbol at RESNET_F32_BATCH over FIT_BATCHES
# batches: an async checkpoint every RESUME_EVERY steps and a preemption at
# step RESUME_AT; the timing run's cadence; telemetry's publishing cadence
# (it divides FIT_BATCHES: the last step publishes)
RESUME_EVERY, RESUME_AT, RESUME_TIMING_EVERY, RESUME_TELE_EVERY = 4, 7, 2, 4
# inference_service: the ResNet-50 symbol served to SERVE_CLIENTS threads,
# each keeping SERVE_WINDOWS[i] requests in flight (one run a window: 32
# and 128 requests outstanding), batch buckets up to
# SERVE_MAX_BATCH (also the Module's bound batch); a BERT-base-width FFN
# block with LayerNorm (width, d_ff, sequence, requests, bound batch); the
# partial final batch of F5 (32 + 8 images)
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_MAX_BATCH = 512, 8, 32
SERVE_WINDOWS = (4, 16)
BERT_WIDTH, BERT_FF, BERT_SEQ, BERT_REQUESTS, BERT_MAX_BATCH = \
    768, 3072, 128, 64, 16
SERVE_PARTIAL = 40
# inference_int8: inference_service's two models and traffic served int8;
# calibrated on INT8_CALIB_IMAGES seeded images (one batch) and
# INT8_CALIB_SEQS sequences; the CPU check's images and sequences (the
# card's int8-against-f32 error held to twice the CPU's on them); the
# batch at which ResNet-50's convolution shapes check the quantized ops;
# the card's int8 outputs against the CPU int8 service's on the CPU
# check's samples, as a share of the CPU's int8-against-f32 error there
# (read on an H100 80GB HBM3 at 700 W: ResNet-50 1.924e-3 of 3.587e-3,
# 0.54; the BERT block 3.8e-6 of 0.0710, f32 sum order alone), and the
# int8 activations of the converted graph, card against CPU on the same
# samples: the largest difference of any element and the share that
# differ over all quantize nodes (read: ResNet-50 4 and 2.52%, growing
# with depth from 1 element of 1.6 M at the second node; the BERT block
# 0 and 0)
INT8_CALIB_IMAGES, INT8_CALIB_SEQS = 32, 16
INT8_CPU_IMAGES, INT8_CPU_SEQS = 8, 8
INT8_CARD_CPU_SHARE = {"resnet": 0.75, "bert_ffn": 1e-3}
INT8_ACT_MAX_DIFF, INT8_ACT_SHARE = 8, 0.05
INT8_OP_BATCH = 2
# optimizers: a tanh MLP fitted OPT_BATCHES batches of OPT_BATCH on the
# card and on the CPU, per optimizer (its settings); custom_op: the
# example's numpy softmax as a symbolic Custom node, CUSTOM_BATCHES of
# CUSTOM_BATCH
OPT_WIDTHS, OPT_BATCH, OPT_BATCHES = (64, 32, 10), 64, 6
OPT_SETTINGS = {
    "ftml": {"learning_rate": 0.01},
    "lbsgd": {"learning_rate": 0.05, "momentum": 0.9, "batch_scale": 4,
              "warmup_epochs": 1, "updates_per_epoch": OPT_BATCHES},
    "dcasgd": {"learning_rate": 0.05, "momentum": 0.9},
    "sgld": {"learning_rate": 1e-3},
    "adadelta": {},
    "ftrl": {"learning_rate": 0.1},
    "adamax": {"learning_rate": 0.002},
    "nadam": {"learning_rate": 0.001},
    "test": {}}
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
CUSTOM_BATCH, CUSTOM_BATCHES = 64, 6
# gluon_hybrid: Inception v3 at its published input, B=128, one BatchNorm
# per conv unit (94); the capture check net's batch; the export round
# trip's tolerance, relative to the output's largest magnitude
GH_BATCH, GH_HW, GH_CLASSES, GH_STEPS, GH_BN = 128, 299, 1000, 10, 94
# amp: the Gluon bf16 loop's steps (at RESNET_BATCH), its card-vs-CPU
# check (resnet18_v1: B, HW, classes), the Module.fit batches a dtype, the
# cifar fp16 scaler check's batches (at CIFAR_BATCH), and the reference's
# low-precision tolerance (tests/test_amp.py)
AMP_GLUON_STEPS, AMP_CHECK, AMP_FIT_BATCHES = 10, (8, 64, 10), 6
AMP_CIFAR_BATCHES, AMP_RTOL = 4, 0.05
# empty kernels that open a profiler session counting kernels by name:
# their records take the loss of a session's first records (``_profiled``)
PROFILE_LEAD = 1024
GH_CHECK_BATCH = 8
# rnn_lm: the Gluon word language model at the upstream example's "medium"
# width (train.py --nhid 650 --emsize 650 --dropout 0.5; two layers;
# WikiText-2's vocabulary) with its other defaults: bptt 35, batch 32, SGD
# lr 20, clip 0.2 a token; the RNN op's card-vs-CPU check size (T, N, I,
# H, L)
LM_VOCAB, LM_WIDTH, LM_LAYERS, LM_DROPOUT = 33278, 650, 2, 0.5
LM_BPTT, LM_BATCH, LM_STEPS, LM_LR, LM_CLIP = 35, 32, 20, 20.0, 0.2
RNN_CHECK = (35, 4, 128, 128, 2)
# bucketing_fit: lstm_bucketing.py at its own widths (2 x LSTMCell(200),
# embed 200, buckets 10-40, batch 32, Adam lr 0.01) over PTB's vocabulary
BK_VOCAB, BK_HIDDEN, BK_EMBED, BK_LAYERS = 10000, 200, 200, 2
BK_BUCKETS, BK_BATCH, BK_LR, BK_EPOCHS = (10, 20, 30, 40), 32, 0.01, 2
BK_SENTENCES = 3200
# sparse_fit: upstream MXNet's Avazu linear classification width
# (example/sparse/linear_classification: 1,000,001 features, batch 8192)
# over SP_BATCHES batches of seeded synthetic LibSVM rows, SGD at the
# repo's example's lr 0.1, two epochs; the card-vs-CPU check's steps; the
# device bytes the fit may add at its peak
SP_FEATURES, SP_BATCH, SP_BATCHES, SP_EPOCHS, SP_LR = \
    1_000_001, 8192, 16, 2, 0.1
SP_CHECK_STEPS, SP_PEAK_BYTES = 3, 1 << 30
# control_flow: timed steps of the foreach LM (and of the RNN-op LM), the
# LayerNorm body's forwards, and the hybridized while_loop/cond block
# (batch, width, max_iterations)
CF_STEPS, CF_LN_FORWARDS, CF_HYB = 5, 3, (8, 16, 6)
# image_rec: a RAW0 file of 1,280 images stored at 256 x 256, read at
# train_imagenet's settings (resize 256, 224 x 224 random crops and
# mirrors, its mean), B=128 on 8 threads; four Module.fit batches of the
# example ResNet-50 symbol fed by it; the one-thread card-vs-CPU check's B
REC_IMAGES, REC_STORED, REC_BATCH, REC_THREADS = 1280, 256, 128, 8
REC_MEAN, REC_FIT_BATCHES, REC_CHECK_BATCH = (123.68, 116.779, 103.939), 4, 100
# image_iter: an indexed RAW0 file of II_IMAGES images stored at REC_STORED²
# read through ImageRecordIter(use_native=False) at image_rec's settings
# (II_RATE_BATCHES batches of REC_BATCH timed, II_CHECK_BATCHES of B=32
# card against CPU) and a C = 1 file of II_GRAY images at II_GRAY_HW²; then
# ImageRecordDataset + transforms + DataLoader(batch_size=II_BATCH) feeding
# II_STEPS Gluon ResNet-50 v1 steps (the first a warm-up)
II_IMAGES, II_RATE_BATCHES, II_CHECK_BATCHES = 384, 2, 2
II_GRAY, II_GRAY_HW, II_BATCH, II_STEPS = 64, 64, 32, 4
II_MEAN, II_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# ssd_fit: example/ssd/train.py's ToySSD (64², batch 16, 2 classes, Adam at
# 0.005, three steps, card against CPU from the same weights, rtol
# SSD_RTOL); then the full-width leg: resnet50_v1's features as the body
# (NHWC), 3 x 512 x 512, batch 32, 20 VOC classes, priors on the stride-16
# and stride-32 maps with upstream example/ssd's resnet50 sizes and ratios
# for its first two scales, SSD_STEPS steps (the first a warm-up) and
# MultiBoxDetection with upstream's nms_topk 400
SSD_TOY_HW, SSD_TOY_BATCH, SSD_TOY_STEPS, SSD_LR, SSD_RTOL = \
    64, 16, 3, 0.005, 1e-4
SSD_HW, SSD_BATCH, SSD_CLASSES, SSD_STEPS, SSD_TOPK = 512, 32, 20, 4, 400
SSD_SCALES = (((0.1, 0.141), (1.0, 2.0, 0.5)),
              ((0.2, 0.272), (1.0, 2.0, 0.5, 3.0, 1.0 / 3)))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _close(a, b, dtype: str):
    import torch

    a, b = a.float(), b.float()
    tol = TOL[dtype]
    diff = (a - b).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * b.abs()).all())
    rel = (diff / b.abs().clamp_min(1e-6)).max().item()
    return ok, diff.max().item(), rel


def time_ms(fn, x0, iters: int = 20, reps: int = 9) -> float:
    """Median device time of one call: ``iters`` chained calls (each call's
    output is the next one's input) captured in a CUDA graph, replayed
    ``reps`` times between CUDA events."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(x0)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x0
        for _ in range(iters):
            y = fn(y)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 ------------------------------------------------------------------------
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from mxnet_tpu_torch.context import resolve_device

    dev = resolve_device(None)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})
    return dev, smi


# -- phase 2 ------------------------------------------------------------------------
def _ptxas_functions(report: str):
    """Registers, spill bytes and shared memory of each kernel function in
    one source's ``-Xptxas -v`` report, by mangled name."""
    import re

    funcs, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return funcs


# paged-attention kernel functions (by mangled-name fragment: kernel, q's
# type, the pool's type, queries a block) that ptxas lets spill, with the
# most bytes each may; every other paged function, the main path's f32 and
# int8 decode (one query) and every prefill tile, must not spill
PAGED_SPILLS_ALLOWED = {
    "paged_decode_split_kernelI13__nv_bfloat16S1_Li1E": 8,
    "paged_decode_split_kernelI13__nv_bfloat16S1_Li4E": 16,
    "paged_decode_split_kernelIffLi4E": 12,
}


def _spills(rows: dict, allowed: dict) -> dict:
    """The functions of ``rows`` that spill more than ``allowed`` lets
    them (keyed by a fragment of the mangled name; 0 if none matches)."""
    bad = {}
    for f, r in rows.items():
        cap = next((n for k, n in allowed.items() if k in f), 0)
        if max(r.get("spill_stores", 1), r.get("spill_loads", 1)) > cap:
            bad[f] = r
    return bad


def phase_build():
    """Build every kernel source; no tensor-core flash kernel (the three
    bf16 and the three f32 3xTF32 functions at four head dims: 24) may
    spill registers, and no paged-attention function (22) beyond
    ``PAGED_SPILLS_ALLOWED``."""
    from mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    funcs = {n: _ptxas_functions(v["ptxas"]) for n, v in info.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": v["seconds"], "functions": funcs[n]}
                      for n, v in info.items()}})
    if info["flash_attention"]["ptxas"]:   # empty when loaded from disk
        tc = {f: r for f, r in funcs["flash_attention"].items()
              if "_tc_kernelILi" in f or "_tf32_kernelILi" in f}
        if len(tc) != 24 or _spills(tc, {}):
            raise SystemExit(f"tensor-core flash kernels spill: {tc}")
    if info["paged_attention"]["ptxas"]:
        paged = funcs["paged_attention"]
        bad = _spills(paged, PAGED_SPILLS_ALLOWED)
        if len(paged) != 22 or bad:
            raise SystemExit(f"paged attention kernels spill: {bad} "
                             f"({len(paged)} functions)")


# -- phase 3 ------------------------------------------------------------------------
def _layer_norm_cases(dev):
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.layer_norm import (layer_norm_fused,
                                                layer_norm_reference)

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    C = GPT2_SMALL["d_model"]
    for M in LN_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            for gelu in (False, True):
                x = (torch.randn(M, C, generator=g, device=dev) * 2.0
                     + 0.5).to(dtype)
                gam = (1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
                       ).to(dtype)
                bet = (0.1 * torch.randn(C, generator=g, device=dev)
                       ).to(dtype)
                got = layer_norm_fused(x, gam, bet, 1e-5, gelu)
                want = layer_norm_reference(x, gam, bet, 1e-5, gelu)
                torch.cuda.synchronize()
                dname = str(dtype).split(".")[-1]
                ok, err, rel = _close(got, want, dname)
                ms = time_ms(lambda t: layer_norm_fused(t, gam, bet, 1e-5,
                                                        gelu), x)
                plain = time_ms(lambda t: layer_norm_reference(
                    t, gam, bet, 1e-5, gelu), x)
                lib = None if gelu else time_ms(
                    lambda t: F.layer_norm(t, (C,), gam, bet, 1e-5), x)
                item = x.element_size()
                bms, by = bound_ms(2 * M * C * item + 2 * C * item,
                                   (18 if gelu else 8) * M * C, dname)
                rows.append({"M": M, "C": C, "dtype": dname, "gelu": gelu,
                             "ok": ok, "max_abs_err": err,
                             "max_rel_err": rel, "ms": ms, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bms,
                             "bound_by": by})
    return rows


def _paged_bytes_flops(q, k_pool, tables, pos, max_pos, bs):
    """Bytes the call must move (q and out; the indices; the rows of live
    K/V blocks up to the row's last query position, once, with their two
    f32 scales per block and head for an int8 pool) and the f32 operations
    its unmasked (query, key) pairs need."""
    import torch

    B, T, H, D = q.shape
    item = q.element_size()
    kv_item = k_pool.element_size()
    scale_bytes = 2 * H * 4 if k_pool.dtype == torch.int8 else 0
    tab = tables.cpu().numpy()
    mp = max_pos.cpu().numpy()
    ps = pos.cpu().numpy()
    W = tab.shape[1]
    nbytes = 2 * q.numel() * item + tables.numel() * 4 + pos.numel() * 4
    pairs = 0
    for b in range(B):
        live = [w for w in range(W) if tab[b, w] != 0 and w * bs <= mp[b]]
        ctx = np.concatenate([np.arange(w * bs, (w + 1) * bs)
                              for w in live]) if live else np.zeros(0)
        nbytes += len(live) * scale_bytes + int(
            (ctx <= ps[b].max()).sum()) * 2 * H * D * kv_item
        for t in range(T):
            pairs += int((ctx <= ps[b, t]).sum())
    return nbytes, 4.0 * D * H * pairs


# paged attention: each case's K/V pool holds enough disjoint table sets
# that one cycle of timed calls reads more than the 50 MB L2
PAGED_ROTATE_BYTES = 64e6
# the paged kernel functions each route must launch
PAGED_ROUTES = {"decode": ("paged_decode_split_kernel",
                           "paged_decode_merge_kernel"),
                "prefill": ("paged_prefill_tile_kernel",)}
# the speculative verify chunk lengths (Tk ladder at draft_k=4) and the
# route each takes
VERIFY_TS = (2, 4, 5)
VERIFY_ROUTES = {2: "decode", 4: "decode", 5: "prefill"}


def _paged_cases():
    """The paged-attention call shapes of the serving path and its edges:
    (name, B, T, W, bs, H, D, starts, lengths, table template).  Row b's
    queries sit at positions starts[b] .. starts[b]+T-1, of which
    lengths[b] are valid; the template marks the table entries that hold a
    block (each timed set gets its own physical blocks)."""
    def decode(ctx, W, bs, T=1):
        tmpl = np.zeros((len(ctx), W), np.int32)
        for b, n in enumerate(ctx):
            if n:
                tmpl[b, :-(-(n + 1) // bs)] = 1
        starts = [max(0, n - T + 1) for n in ctx]
        lengths = [T if n else 0 for n in ctx]
        return starts, lengths, tmpl

    # the serving decode step: 8 slots with ragged contexts, one inactive
    # (max_pos = -1), null entries past each row's blocks and one null
    # entry inside a live range (row 7, logical block 10)
    ctx = [1000, 37, 300, 0, 511, 64, 129, 800]
    cases = []
    for name, W, bs, H, D in (("decode", 32, 32, 12, 64),
                              ("decode_bs16", 64, 16, 12, 64),
                              ("decode_d128", 32, 32, 6, 128),
                              ("decode_d40", 32, 32, 4, 40)):
        st, ln, tmpl = decode(ctx, W, bs)
        tmpl[7, 320 // bs] = 0
        cases.append((name, 8, 1, W, bs, H, D, st, ln, tmpl))
    # split-K's own case: one 1,000-position row
    st, ln, tmpl = decode([1000], 32, 32)
    cases.append(("decode_long", 1, 1, 32, 32, 12, 64, st, ln, tmpl))
    # three queries a row (the multi-query decode kernel), one row with two
    # valid
    st, ln, tmpl = decode(ctx, 32, 32, T=3)
    ln[2] = 2
    cases.append(("decode_t3", 8, 3, 32, 32, 12, 64, st, ln, tmpl))
    # speculative verify steps ([pending, d_1..d_s], Tk = s + 1 on the
    # engine's ladder for draft_k=4: 2, 4, 5): the decode contexts, one
    # row inactive, one with a draft fewer; T <= 4 takes split + merge,
    # T = 5 the prefill tile kernel
    for T in VERIFY_TS:
        st, ln, tmpl = decode(ctx, 32, 32, T=T)
        ln[2] = T - 1
        cases.append((f"verify_t{T}", 8, T, 32, 32, 12, 64, st, ln, tmpl))
    # prefill: one 512-query chunk at offset 256 (a chunked prompt), 400
    # valid queries, so blocks past the last valid position are skipped
    for name, W, bs, H, D in (("prefill", 32, 32, 12, 64),
                              ("prefill_bs16", 64, 16, 12, 64),
                              ("prefill_d40", 32, 32, 4, 40)):
        cases.append((name, 1, 512, W, bs, H, D, [256], [400],
                      np.ones((1, W), np.int32)))
    return cases


def _int8_pools(dev, nb, bs, H, D, seed):
    """Random int8 K/V pools with per-(block, head) scales; block 0 (the
    null block) carries NaN scales, which no reader may touch."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randint(-127, 128, (nb, bs, H, D), generator=g, device=dev,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (nb, bs, H, D), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(nb, H, generator=g, device=dev) * 0.05 + 1e-3
    vs = torch.rand(nb, H, generator=g, device=dev) * 0.05 + 1e-3
    ks[0] = vs[0] = float("nan")
    return kp, vp, ks, vs


def _paged_inputs(dev, dtype, int8, case, rotate=True):
    """One case's inputs: q, the pools (block 0 poisoned with NaN: NaN
    scales for int8, NaN values for a float pool), the table sets (with
    ``rotate``, enough that one cycle reads more than PAGED_ROTATE_BYTES,
    at most 256; else one), positions and max_pos."""
    import torch

    name, B, T, W, bs, H, D, starts, lengths, tmpl = case
    pos = (torch.tensor(starts, device=dev)[:, None]
           + torch.arange(T, device=dev)[None, :]).to(torch.int32)
    valid = torch.arange(T, device=dev)[None, :] < torch.tensor(
        lengths, device=dev)[:, None]
    max_pos = torch.where(valid, pos, -1).amax(dim=1).to(torch.int32)
    n_live = int(tmpl.sum())
    q0 = torch.zeros(B, T, H, D, device=dev, dtype=dtype)
    probe = torch.zeros(2, bs, H, D, device=dev,
                        dtype=torch.int8 if int8 else dtype)
    tab0 = torch.tensor(tmpl, dtype=torch.int32, device=dev)
    per_set, _ = _paged_bytes_flops(q0, probe, tab0, pos, max_pos, bs)
    n_sets = min(256, max(2, int(np.ceil(PAGED_ROTATE_BYTES / per_set)))) \
        if rotate else 1
    nb = 1 + n_sets * n_live
    rs = np.random.RandomState(SEED + T + W + D)
    phys = (rs.permutation(nb - 1) + 1).reshape(n_sets, n_live)
    tables = []
    for i in range(n_sets):
        t = np.zeros((B, W), np.int32)
        t[tmpl != 0] = phys[i]
        tables.append(torch.tensor(t, device=dev))
    g = torch.Generator(device=dev).manual_seed(SEED + B * 1000 + T)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    ks = vs = None
    if int8:
        kp, vp, ks, vs = _int8_pools(dev, nb, bs, H, D, SEED + B + T)
    else:
        kp = torch.randn(nb, bs, H, D, generator=g, device=dev).to(dtype)
        vp = torch.randn(nb, bs, H, D, generator=g, device=dev).to(dtype)
        kp[0] = vp[0] = float("nan")
    return q, kp, vp, ks, vs, tables, pos.contiguous(), max_pos


def _paged_attention_cases(dev, int8: bool = False):
    """Kernels 9 (float pool) and 10 (int8 pool) against their plain
    version on the card, every case of ``_paged_cases`` with q float32 and
    bfloat16: outputs at ``TOL``, inactive rows exactly 0, two runs equal
    bit for bit; times of kernel and plain version over table sets that
    cycle past the L2 (one CUDA graph of one call per set)."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import (attention_scale,
                                                     paged_attention,
                                                     paged_attention_plain)

    out = []
    for case in _paged_cases():
        name, B, T, W, bs, H, D = case[:7]
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, ks, vs, tables, pos, mp = _paged_inputs(
                dev, dtype, int8, case)
            scale = attention_scale(D)
            got = paged_attention(q, kp, vp, tables[0], pos, mp,
                                  k_scale=ks, v_scale=vs)
            again = paged_attention(q, kp, vp, tables[0], pos, mp,
                                    k_scale=ks, v_scale=vs)
            want = paged_attention_plain(q, kp, vp, tables[0], pos, mp,
                                         scale, ks, vs)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            ok, err, rel = _close(got, want, dname)
            ok = ok and bool(torch.isfinite(got).all())
            bitwise = bool(torch.equal(got, again))
            zero_rows = [b for b in range(B) if int(mp[b]) < 0]
            zeros_ok = all(bool((got[b] == 0).all()) for b in zero_rows)
            nxt = _rotating(tables)
            n = max(20, len(tables))
            ms = time_ms(lambda t: paged_attention(
                t, kp, vp, nxt(), pos, mp, k_scale=ks, v_scale=vs), q,
                iters=n)
            nxt = _rotating(tables)
            plain = time_ms(lambda t: paged_attention_plain(
                t, kp, vp, nxt(), pos, mp, scale, ks, vs), q, iters=n,
                reps=5)
            nbytes, flops = _paged_bytes_flops(q, kp, tables[0], pos, mp,
                                               bs)
            bms, by = bound_ms(nbytes, flops, dname)
            out.append({"case": name, "kind": name.split("_")[0], "B": B,
                        "T": T, "W": W, "bs": bs, "H": H, "D": D,
                        "dtype": dname, "kv": "int8" if int8 else dname,
                        "ok": ok and zeros_ok and bitwise,
                        "inactive_rows_zero": zeros_ok,
                        "bitwise_deterministic": bitwise,
                        "table_sets": len(tables), "max_abs_err": err,
                        "max_rel_err": rel, "ms": ms, "plain_ms": plain,
                        "library_ms": None, "bound_ms": bms, "bound_by": by,
                        "bytes": nbytes})
            del q, kp, vp, ks, vs, tables
    return out


def _paged_routes(dev):
    """Which kernel functions ``paged_attention`` launches (torch.profiler
    over two calls of each route and pool at a small shape): decode must
    run the split and merge kernels, prefill the tile kernel
    (``PAGED_ROUTES``), and no other paged kernel function runs."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    rows = []
    calls_by = [("decode", "decode", 1), ("prefill", "prefill", 64)] + [
        (f"verify_t{T}", VERIFY_ROUTES[T], T) for T in VERIFY_TS]
    for case_name, route, T in calls_by:
        for int8 in (False, True):
            case = (route, 2, T, 8, 32, 2, 64, [100, 37], [T, T],
                    np.ones((2, 8), np.int32))
            q, kp, vp, ks, vs, tables, pos, mp = _paged_inputs(
                dev, torch.float32, int8, case, rotate=False)

            def calls():
                for _ in range(2):
                    paged_attention(q, kp, vp, tables[0], pos, mp,
                                    k_scale=ks, v_scale=vs)

            names, sessions = _launched(calls, "paged_")
            ok, other = _routed(names, PAGED_ROUTES[route])
            rows.append({"case": case_name, "route": route,
                         "kv": "int8" if int8 else "float32",
                         "kernels": names, "other": other,
                         "profiler_sessions": sessions, "ok": ok})
    return rows


def _layer_norm_backward_cases(dev):
    """LayerNorm's gradient on the card at the training path's rows (B*T =
    8192, C = 768): the kernel forward plus autograd through the plain
    version, against autograd through the plain version alone."""
    import torch

    from mxnet_tpu_torch.ops.layer_norm import (layer_norm_fused,
                                                layer_norm_reference)

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    M, C = 8 * 1024, GPT2_SMALL["d_model"]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for gelu in (False, True):
            x = (torch.randn(M, C, generator=g, device=dev) * 2.0 + 0.5
                 ).to(dtype).requires_grad_()
            gam = (1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
                   ).to(dtype).requires_grad_()
            bet = (0.1 * torch.randn(C, generator=g, device=dev)
                   ).to(dtype).requires_grad_()
            dy = torch.randn(M, C, generator=g, device=dev).to(dtype)
            n0 = layer_norm_fused.launches
            out = layer_norm_fused(x, gam, bet, 1e-5, gelu)
            launched = layer_norm_fused.launches - n0
            has_grad_fn = out.grad_fn is not None
            got = torch.autograd.grad(out, (x, gam, bet), dy)
            want = torch.autograd.grad(
                layer_norm_reference(x, gam, bet, 1e-5, gelu),
                (x, gam, bet), dy)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[-1]
            close = [_close(a, b, dname) for a, b in zip(got, want)]
            rows.append({"M": M, "C": C, "dtype": dname, "gelu": gelu,
                         "grad_fn": has_grad_fn, "launches": launched,
                         "ok": has_grad_fn and launched == 1
                         and all(c[0] for c in close),
                         "bitwise_equal": all(bool(torch.equal(a, b))
                                              for a, b in zip(got, want)),
                         "max_abs_err": {n: c[1] for n, c in
                                         zip(("dx", "dgamma", "dbeta"),
                                             close)}})
    return rows


def _event_ms(fn, n: int = 10) -> float:
    """Mean device time of ``fn`` over ``n`` calls between CUDA events,
    after two warm-up calls (for work a CUDA graph cannot capture)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _flash_work(B, T, H, D, item, causal):
    """Bytes each flash kernel must move (inputs read once, outputs
    written once; lse and delta are f32 rows) and the operations its live
    (query, key) pairs need: 4*D per pair forward, 6*D for dQ, 8*D for
    dK/dV."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    n, rows = B * T * H * D * item, B * H * T * 4
    return {"fwd": (4 * n + rows, 4 * D * pairs),
            "dq": (5 * n + 2 * rows, 6 * D * pairs),
            "dkv": (6 * n + 2 * rows, 8 * D * pairs)}


def _flash_cases(dev):
    """Kernels 6-8 against their plain versions on the card: the LM's
    training shape (q, k, v strided views of one fused qkv product, as the
    model passes them), a ragged T and the head dims 16, 32 and 128
    (``FLASH_SHAPES``), float32 and bfloat16, causal and not.  The
    backward kernels and their plain versions take the same out,
    lse and delta; each backward kernel runs twice and must give the same
    bits.  Times at the training shape only."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    rows = []
    for shape, (B, T, H, D) in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                dname = str(dtype).split(".")[-1]
                g = torch.Generator(device=dev).manual_seed(
                    SEED + T + int(causal))
                if shape == "training":
                    qkv = torch.randn(B, T, 3 * H * D, generator=g,
                                      device=dev).to(dtype)
                    q, k, v = (t.reshape(B, T, H, D)
                               for t in qkv.split(H * D, dim=-1))
                else:
                    q, k, v = (torch.randn(B, T, H, D, generator=g,
                                           device=dev).to(dtype)
                               for _ in range(3))
                go = torch.randn(B, T, H, D, generator=g,
                                 device=dev).to(dtype)
                scale = 1.0 / np.sqrt(D)
                out, lse = fa.flash_attention_forward(q, k, v, causal)
                w_out, w_lse = fa.flash_attention_forward_reference(
                    q, k, v, causal)
                delta = fa.flash_delta(w_out, go)
                bwd_args = (q, k, v, go, w_lse, delta, causal)
                runs = [(fa.flash_attention_dq(*bwd_args),
                         *fa.flash_attention_dkv(*bwd_args))
                        for _ in range(2)]
                want = (fa.flash_attention_dq_reference(*bwd_args, scale),
                        *fa.flash_attention_dkv_reference(*bwd_args, scale))
                torch.cuda.synchronize()
                errs, ok = {}, True
                for name, a, b, tol in (
                        ("out", out, w_out, dname), ("lse", lse, w_lse,
                                                     "float32"),
                        ("dq", runs[0][0], want[0], dname),
                        ("dk", runs[0][1], want[1], dname),
                        ("dv", runs[0][2], want[2], dname)):
                    good, err, _ = _close(a, b, tol)
                    good = good and bool(torch.isfinite(a.float()).all())
                    errs[name] = err
                    ok = ok and good
                bitwise = all(bool(torch.equal(a, b))
                              for a, b in zip(runs[0], runs[1]))
                row = {"shape": shape, "B": B, "T": T, "H": H, "D": D,
                       "dtype": dname, "causal": causal,
                       "ok": ok and bitwise, "bitwise_deterministic": bitwise,
                       "max_abs_err": errs}
                if shape == "training":
                    row["ms"] = {
                        "fwd": time_ms(lambda _: fa.flash_attention_forward(
                            q, k, v, causal)[0], q),
                        "dq": time_ms(lambda _: fa.flash_attention_dq(
                            *bwd_args), q),
                        "dkv": time_ms(lambda _: fa.flash_attention_dkv(
                            *bwd_args)[0], q)}
                    row["plain_ms"] = {
                        "fwd": time_ms(
                            lambda _: fa.flash_attention_forward_reference(
                                q, k, v, causal)[0], q, iters=4, reps=5),
                        "dq": time_ms(
                            lambda _: fa.flash_attention_dq_reference(
                                *bwd_args, scale), q, iters=4, reps=5),
                        "dkv": time_ms(
                            lambda _: fa.flash_attention_dkv_reference(
                                *bwd_args, scale)[0], q, iters=4, reps=5)}
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    sdpa_fwd = time_ms(
                        lambda _: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, scale=scale), q)
                    lq, lk, lv = (t.detach().requires_grad_()
                                  for t in (qt, kt, vt))
                    gt = go.transpose(1, 2)

                    def sdpa_step():
                        o = F.scaled_dot_product_attention(
                            lq, lk, lv, is_causal=causal, scale=scale)
                        torch.autograd.grad(o, (lq, lk, lv), gt)

                    both = _event_ms(sdpa_step)
                    row["sdpa_ms"] = {"fwd": sdpa_fwd, "fwd_bwd": both,
                                      "bwd": both - sdpa_fwd}
                    row["bound_ms"], row["bound_by"] = {}, {}
                    rate = "float32_3xtf32" if dname == "float32" \
                        else dname
                    for kname, (nbytes, flops) in _flash_work(
                            B, T, H, D, q.element_size(), causal).items():
                        row["bound_ms"][kname], row["bound_by"][kname] = \
                            bound_ms(nbytes, flops, rate)
                rows.append(row)
    return rows


def _flash_nan_cases(dev):
    """A NaN reaches each flash kernel's outputs as it reaches its plain
    version's: the card's own NaN (0x7fffffff, what q * scale gives for a
    NaN q) in q at one (batch, row, head) and in g at another, float32 and
    bfloat16, D = 64 and 128, T = 200, causal and not.  out, lse and dq
    must be NaN exactly where the plain versions' are, and so must dk and
    dv without the mask.  Under it the plain version puts a NaN row's NaN
    into every key's dk and dv (exp(-1e30 - NaN) and 0 * NaN are NaN at
    masked positions) and a tiled kernel only into the keys of the tiles
    that are live for that row's tile; so there, for any tile size, dk
    and dv must be (a) NaN wherever the plain version is NaN at a key j <=
    r, the keys that the NaN row r attends to, and (b) NaN nowhere the
    plain version is not.  Where the plain version is not NaN, kernel and
    plain version agree within the dtype's tolerance."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
    B, T, H = 2, 200, 2
    # each (batch, head)'s NaN row (q's at (0, 5, 0), g's at (1, 40, 1)),
    # -1 where none; the keys j <= it in dk and dv's layout
    nan_row = torch.full((B, 1, H, 1), -1, device=dev)
    nan_row[0, 0, 0, 0], nan_row[1, 0, 1, 0] = 5, 40
    attended = torch.arange(T, device=dev).view(1, T, 1, 1) <= nan_row
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for causal in (False, True):
                dname = str(dtype).split(".")[-1]
                g = torch.Generator(device=dev).manual_seed(SEED + D)
                q, k, v, go = (torch.randn(B, T, H, D, generator=g,
                                           device=dev) for _ in range(4))
                q[0, 5, 0, 3:4] = nan  # a bit copy: the pattern stays
                go[1, 40, 1, D - 1:] = nan
                q, k, v, go = (t.to(dtype) for t in (q, k, v, go))
                out, lse = fa.flash_attention_forward(q, k, v, causal)
                w_out, w_lse = fa.flash_attention_forward_reference(
                    q, k, v, causal)
                args = (q, k, v, go, w_lse, fa.flash_delta(w_out, go),
                        causal)
                scale = 1.0 / np.sqrt(D)
                got = (out, lse, fa.flash_attention_dq(*args),
                       *fa.flash_attention_dkv(*args))
                want = (w_out, w_lse,
                        fa.flash_attention_dq_reference(*args, scale),
                        *fa.flash_attention_dkv_reference(*args, scale))
                torch.cuda.synchronize()
                ok, counts = True, {}
                for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                      got, want):
                    a, b = a.float(), b.float()
                    na, nb = torch.isnan(a), torch.isnan(b)
                    counts[name] = [int(na.sum()), int(nb.sum())]
                    if causal and name in ("dk", "dv"):
                        placed = bool((na | ~(nb & attended)).all()) \
                            and not bool((na & ~nb).any())
                    else:
                        placed = bool(torch.equal(na, nb))
                    close, _, _ = _close(
                        a.masked_fill(nb, 0), b.masked_fill(nb, 0),
                        "float32" if name == "lse" else dname)
                    ok = ok and bool(nb.any()) and placed and close
                rows.append({"dtype": dname, "D": D, "causal": causal,
                             "nan_counts": counts, "ok": ok})
    return rows


def _launched(fn, family):
    """The names of the CUDA kernel functions containing ``family`` that
    ``fn`` launches (``torch.profiler``), and the sessions it took.  A
    session that records none of them runs again, up to three sessions: a
    process's profiler sessions can come back without kernels the program
    launched, and an empty list says nothing about which kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = []
    for sessions in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and family in e.name})
        if names:
            break
    return names, sessions


def _routed(names, want):
    """Whether the kernel functions ``names`` are exactly ``want``, each
    run (demangled "name<" or mangled "nameI") and no other; and the
    others."""
    import re

    def hit(w, n):
        return re.search(rf"(?<![A-Za-z_]){w}[<I]", n) is not None

    ran = [w for w in want if any(hit(w, n) for n in names)]
    other = [n for n in names if not any(hit(w, n) for w in want)]
    return ran == list(want) and not other and len(names) == len(want), \
        other


def _flash_routes(dev):
    """Which kernel functions the three flash wrappers launch for each
    dtype (``torch.profiler`` over two calls of each at a small shape):
    bf16 must take the three tensor-core kernels, f32 the three 3xTF32
    kernels (``FLASH_ROUTES``), and no other flash kernel (bf16 no
    ``_tf32_kernel``, f32 no ``_tc_kernel``)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    rows = []
    for dname, want in FLASH_ROUTES.items():
        dtype = getattr(torch, dname)
        g = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v, go = (torch.randn(2, 128, 2, 64, generator=g,
                                   device=dev).to(dtype) for _ in range(4))

        def calls():
            for _ in range(2):
                out, lse = fa.flash_attention_forward(q, k, v, True)
                delta = fa.flash_delta(out, go)
                fa.flash_attention_dq(q, k, v, go, lse, delta, True)
                fa.flash_attention_dkv(q, k, v, go, lse, delta, True)

        names, sessions = _launched(calls, "flash_")
        ok, other = _routed(names, want)
        rows.append({"dtype": dname, "kernels": names, "other": other,
                     "profiler_sessions": sessions, "ok": ok})
    return rows


def _bf16_ulps(a, b, tol) -> float:
    """Largest |a - b| beyond the f32 tolerance ``tol`` that the two sides
    may differ by before rounding, in units of b's bf16 ulp (2^(e-7) for
    |b| in [2^e, 2^(e+1))): <= 1 means the two agree to one bf16 rounding."""
    import torch

    a, b = a.float(), b.float()
    e = torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126)))
    beyond = ((a - b).abs() - tol["atol"] - tol["rtol"] * b.abs())
    return (beyond.clamp_min(0.0) / torch.exp2(e - 7)).max().item()


def _rotating(xs):
    """A call argument that cycles through ``xs`` (copies of one input,
    more bytes than the 50 MB L2 together), so chained timed calls read
    device memory as the training step does, not L2."""
    it = itertools.cycle(xs)
    return lambda: next(it)


def _batch_norm_cases(dev):
    """Kernels 3-4 against their plain versions on the card at ResNet-50's
    BatchNorm shapes at B = 128 (the stem, stages 1, 2 and 4) and an odd
    M, f32 and bf16: ``bn_train_fused`` (stats, then normalize) against
    ``bn_train_reference`` — mean and var rtol 1e-5 / atol 1e-5, out the
    same in f32 and, in bf16, within one bf16 ulp beyond that f32
    tolerance (the kernel's ``x * scale + shift`` and the plain
    ``(x - mean) * scale + beta`` round differently in f32 before the
    cast) — and bitwise equal over two runs.  Times of each kernel alone
    (and of the pair) against its plain version and one PyTorch call:
    ``torch.var_mean`` for the stats, ``torch.addcmul`` for normalize,
    ``F.batch_norm`` on the ``channels_last`` tensor for the pair."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import batch_norm as bn

    rows = []
    for (B, H, W, C), dtype in itertools.product(
            BN_SHAPES, (torch.float32, torch.bfloat16)):
        M = B * H * W
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(SEED + C)
        x = (torch.randn(M, C, generator=g, device=dev) * 2.0 + 0.5
             ).to(dtype)
        gam = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
        bet = 0.1 * torch.randn(C, generator=g, device=dev)
        runs = [bn.bn_train_fused(x, gam, bet, 1e-5) for _ in range(2)]
        want = bn.bn_train_reference(x, gam, bet, 1e-5)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for name, a, b in zip(("out", "mean", "var"), runs[0], want):
            good, errs[name], _ = _close(a, b, "batch_norm")
            if name == "out" and dtype == torch.bfloat16:
                errs["out_bf16_ulps"] = _bf16_ulps(a, b, TOL["batch_norm"])
                good = errs["out_bf16_ulps"] <= 1.0
            ok = ok and good and bool(torch.isfinite(a).all())
        bitwise = all(bool(torch.equal(a, b))
                      for a, b in zip(runs[0], runs[1]))
        _, mean, var = want
        scale = gam * torch.rsqrt(var + 1e-5)
        shift = bet - mean * scale
        item = x.element_size()
        copies = max(1, -(-120_000_000 // (M * C * item)))
        xs = [x] + [x.clone() for _ in range(copies - 1)]
        nxt = _rotating(xs)
        nxt4 = _rotating([t.view(B, H, W, C).permute(0, 3, 1, 2)
                          for t in xs])
        ms = {"stats": time_ms(lambda _: bn.bn_stats(nxt())[0], x),
              "normalize": time_ms(lambda _: bn.bn_normalize(
                  nxt(), scale, shift), x),
              "pair": time_ms(lambda _: bn.bn_train_fused(
                  nxt(), gam, bet, 1e-5)[0], x)}
        plain = {"stats": time_ms(lambda _: bn.bn_stats_reference(
                     nxt())[0], x),
                 "normalize": time_ms(lambda _: bn.bn_normalize_reference(
                     nxt(), scale, shift), x),
                 "pair": time_ms(lambda _: bn.bn_train_reference(
                     nxt(), gam, bet, 1e-5)[0], x)}
        lib = {"stats": time_ms(lambda _: torch.var_mean(
                   nxt(), dim=0, unbiased=False)[0], x),
               "normalize": time_ms(lambda _: torch.addcmul(
                   shift, nxt(), scale), x),
               "pair": time_ms(lambda _: F.batch_norm(
                   nxt4(), None, None, gam, bet, True, 0.1, 1e-5), x)}
        work = {"stats": (M * C * item + 2 * C * 4, 3 * M * C),
                "normalize": (2 * M * C * item + 2 * C * 4, 2 * M * C)}
        # the pair reads x once and writes out once at the least
        work["pair"] = (2 * M * C * item + 4 * C * 4, 5 * M * C)
        bounds = {k: bound_ms(nb, fl, "float32") for k, (nb, fl)
                  in work.items()}
        rows.append({"shape": [B, H, W, C], "M": M, "C": C, "dtype": dname,
                     "ok": ok and bitwise,
                     "bitwise_deterministic": bitwise, "max_abs_err": errs,
                     "l2_copies": copies, "ms": ms, "plain_ms": plain,
                     "library_ms": lib,
                     "bound_ms": {k: v[0] for k, v in bounds.items()},
                     "bound_by": {k: v[1] for k, v in bounds.items()}})
        del x, xs, runs, want, nxt, nxt4
    return rows


def _batch_norm_backward_cases(dev):
    """BatchNorm's gradient on the card at ResNet-50 stage-1 rows (B = 32,
    56x56, C = 256): the kernel forward plus autograd through the plain
    version (``_BatchNormFn``) against autograd through the plain version
    alone, for dx, dgamma and dbeta, normwise."""
    import torch

    from mxnet_tpu_torch.ops import batch_norm as bn

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    shape = (32, 56, 56, 256)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(*shape, generator=g, device=dev) * 2.0 + 0.5
             ).to(dtype).requires_grad_()
        gam = (1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
               ).requires_grad_()
        bet = (0.1 * torch.randn(shape[-1], generator=g, device=dev)
               ).requires_grad_()
        dy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        n0 = bn.bn_stats.launches
        out = bn.bn_train_fused(x, gam, bet, 1e-5)[0]
        launched = bn.bn_stats.launches - n0
        got = torch.autograd.grad(out, (x, gam, bet), dy)
        want = torch.autograd.grad(bn.bn_train_reference(x, gam, bet, 1e-5)[0],
                                   (x, gam, bet), dy)
        torch.cuda.synchronize()
        rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
               for n, a, b in zip(("dx", "dgamma", "dbeta"), got, want)}
        dname = str(dtype).split(".")[-1]
        rows.append({"shape": list(shape), "dtype": dname,
                     "grad_fn": out.grad_fn is not None, "launches": launched,
                     "grad_rel_err": rel,
                     "ok": out.grad_fn is not None and launched == 1
                     and max(rel.values()) <= BN_GRAD_TOL[dname]})
        del x, dy, out, got, want
    return rows


def _twobit_inputs(dev, shape, t, gen):
    """A gradient (N(0, 0.6^2)) and residual (N(0, 0.2^2)) of ``shape``
    whose first elements are exactly +t, -t, 0 and +t with residual 0."""
    import torch

    grad = torch.randn(shape, generator=gen, device=dev) * 0.6
    res = torch.randn(shape, generator=gen, device=dev) * 0.2
    k = min(4, grad.numel())
    grad.view(-1)[:k] = torch.tensor([t, -t, 0.0, t], device=dev)[:k]
    res.view(-1)[:k] = 0.0
    return grad, res


def _twobit_case(dev, shape, t, gen):
    """Pack and unpack (f32 and bf16 out) against their plain versions at
    one shape and threshold: packed words (shape and bits), new residual
    and unpacked values, each bitwise equal."""
    import torch

    from mxnet_tpu_torch.ops import twobit as tb

    grad, res = _twobit_inputs(dev, shape, t, gen)
    packed, newres = tb.twobit_pack(grad, res, t)
    want_p, want_r = tb.twobit_pack_reference(grad, res, t)
    ok = {"packed": tuple(packed.shape) == tuple(want_p.shape)
          and torch.equal(packed.view(torch.int32),
                          want_p.view(torch.int32)),
          "residual": torch.equal(newres.view(torch.int32),
                                  want_r.view(torch.int32))}
    err = (newres - want_r).abs().max().item()
    for dtype, ints in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        out = tb.twobit_unpack(packed, shape, t, dtype)
        want = tb.twobit_unpack_reference(want_p, shape, t, dtype)
        ok["unpack_" + str(dtype).split(".")[-1]] = torch.equal(
            out.view(ints), want.view(ints))
        err = max(err, (out.float() - want.float()).abs().max().item())
    return ok, err


def _twobit_cases(dev):
    """Kernels 1-2 against their plain versions on the card, bit for bit
    (zero tolerance): every one of ResNet-50's 193 trainable parameter
    shapes (the gradients of a compressed step) at the threshold 0.5; the
    edge sizes of TWOBIT_EDGES at thresholds 0.5, 0 (padded words 0b11)
    and 1e9; each input with elements exactly at +-t.  Times (CUDA graph
    of chained calls, inputs rotating past the 50 MB L2) at the largest
    shape and summed over the 193 shapes of a step, against the plain
    versions and the byte bound: pack reads grad and residual and writes
    the residual (12 bytes an element) and the words (512 bytes a row);
    unpack reads the words and writes 4 bytes an element.  No single
    PyTorch call packs or unpacks, so there is no library time."""
    import math

    import torch

    from mxnet_tpu_torch.ops import twobit as tb

    _, _, params, _ = _resnet(dev)
    shapes = [tuple(v.shape) for v in params.values()]
    del params
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = [(s, TWOBIT_THRESHOLD) for s in shapes] + [
        ((n,), t) for n in TWOBIT_EDGES for t in (TWOBIT_THRESHOLD, 0.0, 1e9)]
    bad, err = [], 0.0
    for shape, t in cases:
        ok, e = _twobit_case(dev, shape, t, gen)
        err = max(err, e)
        if not all(ok.values()):
            bad.append({"shape": list(shape), "threshold": t, **ok})
    torch.cuda.synchronize()

    def work(n):
        words = tb.packed_rows(n) * tb.WORDS_PER_ROW
        return {"pack": (12 * n + 4 * words, 5 * n),
                "unpack": (4 * words + 4 * n, n)}

    t = TWOBIT_THRESHOLD
    big = max(shapes, key=math.prod)
    n = math.prod(big)
    copies = max(1, -(-120_000_000 // (8 * n)))
    pairs = [_twobit_inputs(dev, big, t, gen) for _ in range(copies)]
    words = [tb.twobit_pack(g, r, t)[0] for g, r in pairs]
    nxt, nxt_w = _rotating(pairs), _rotating(words)
    ms = {"pack": time_ms(lambda _: tb.twobit_pack(*nxt(), t)[1], pairs[0][0]),
          "unpack": time_ms(lambda _: tb.twobit_unpack(nxt_w(), big, t),
                            pairs[0][0])}
    plain = {"pack": time_ms(lambda _: tb.twobit_pack_reference(
                 *nxt(), t)[1], pairs[0][0]),
             "unpack": time_ms(lambda _: tb.twobit_unpack_reference(
                 nxt_w(), big, t), pairs[0][0])}
    bounds = {k: bound_ms(*v, "float32") for k, v in work(n).items()}
    del pairs, words, nxt, nxt_w
    # one step's worth: every gradient of the net once (313.6 MB for pack)
    step = [_twobit_inputs(dev, s, t, gen) for s in shapes]
    step_words = [tb.twobit_pack(g, r, t)[0] for g, r in step]

    def all_of(fn, args):
        def run(_):
            for a in args:
                out = fn(*a)
            return out
        return run

    pack_args = [(g, r, t) for g, r in step]
    unpack_args = [(w, s, t) for w, s in zip(step_words, shapes)]
    step_ms = {"pack": time_ms(all_of(lambda *a: tb.twobit_pack(*a)[1],
                                      pack_args), None, iters=5),
               "unpack": time_ms(all_of(tb.twobit_unpack, unpack_args),
                                 None, iters=5)}
    step_plain = {"pack": time_ms(all_of(
                      lambda *a: tb.twobit_pack_reference(*a)[1], pack_args),
                      None, iters=5),
                  "unpack": time_ms(all_of(tb.twobit_unpack_reference,
                                           unpack_args), None, iters=5)}
    total = {k: [sum(work(math.prod(s))[k][i] for s in shapes)
                 for i in (0, 1)] for k in ("pack", "unpack")}
    step_bounds = {k: bound_ms(*v, "float32") for k, v in total.items()}
    del step, step_words, pack_args, unpack_args
    return [{"kernel": k, "ok": not bad, "cases": len(cases),
             "mismatches": bad, "max_abs_err": err,
             "tolerance": "bitwise",
             "largest_shape": list(big), "ms": ms[k], "plain_ms": plain[k],
             "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
             "library_ms": None, "step_tensors": len(shapes),
             "step_elements": sum(math.prod(s) for s in shapes),
             "step_bytes": total[k][0], "step_ms": step_ms[k],
             "step_plain_ms": step_plain[k],
             "step_bound_ms": step_bounds[k][0]}
            for k in ("pack", "unpack")]


def phase_kernels(dev):
    rows = {"twobit": _twobit_cases(dev),
            "batch_norm": _batch_norm_cases(dev),
            "batch_norm_backward": _batch_norm_backward_cases(dev),
            "layer_norm": _layer_norm_cases(dev),
            "layer_norm_backward": _layer_norm_backward_cases(dev),
            "paged_attention": _paged_attention_cases(dev),
            "paged_attention_int8": _paged_attention_cases(dev, int8=True),
            "paged_routes": _paged_routes(dev),
            "flash_attention": _flash_cases(dev),
            "flash_nan": _flash_nan_cases(dev),
            "flash_routes": _flash_routes(dev)}
    emit({"phase": "kernels", "tolerance": TOL, **rows})
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return rows


# -- phase 4 ------------------------------------------------------------------------
def _model(dev):
    from mxnet_tpu_torch.parallel.transformer import (TransformerConfig,
                                                      transformer_lm_init)

    cfg = TransformerConfig(**GPT2_SMALL)
    return cfg, transformer_lm_init(cfg, seed=SEED, device=dev)


def phase_model(dev, cfg, params):
    import torch

    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention
    from mxnet_tpu_torch.parallel.transformer import (transformer_lm_apply,
                                                      transformer_lm_decode)

    bs, nb, T, n_prompt, n_dec = 32, 64, 128, 100, 4
    rs = np.random.RandomState(SEED)
    seq = rs.randint(0, cfg.vocab, size=n_prompt + n_dec).astype(np.int64)
    shape = (cfg.n_layers, nb, bs, cfg.n_heads, cfg.d_head)
    k_pool = torch.zeros(shape, device=dev)
    v_pool = torch.zeros(shape, device=dev)
    W = 8
    table = np.zeros((1, W), np.int32)
    table[0, :4] = [5, 9, 2, 17]
    ln0, pa0 = layer_norm_fused.launches, paged_attention.launches
    toks = np.zeros((1, T), np.int64)
    toks[0, :n_prompt] = seq[:n_prompt]
    logits, k_pool, v_pool = transformer_lm_decode(
        params, toks, np.arange(T)[None], [n_prompt], k_pool, v_pool, table,
        cfg, attention_kernel="paged")
    got = [logits[0, :n_prompt]]
    for j in range(n_dec):
        p = n_prompt + j
        lg, k_pool, v_pool = transformer_lm_decode(
            params, seq[None, p:p + 1], [[p]], [1], k_pool, v_pool, table,
            cfg, attention_kernel="paged")
        got.append(lg[0])
    got = torch.cat(got, dim=0)
    want = transformer_lm_apply(
        params, torch.as_tensor(seq[None], device=dev),
        torch.arange(len(seq), device=dev), cfg)[0]
    torch.cuda.synchronize()
    diff = (got - want).abs()
    ok = bool((diff <= 1e-4 + 1e-3 * want.abs()).all())
    launches = {"layer_norm": layer_norm_fused.launches - ln0,
                "paged_attention": paged_attention.launches - pa0}
    int8 = _model_int8(dev, cfg, params, seq, n_prompt, n_dec, T, table)
    emit({"phase": "model", "config": GPT2_SMALL, "prompt": n_prompt,
          "prefill_bucket": T, "decode_steps": n_dec, "ok": ok,
          "max_abs_err": diff.max().item(), "tolerance":
          {"rtol": 1e-3, "atol": 1e-4}, "launches": launches,
          "int8": int8, "step_ms": _step_times(dev, cfg, params)})
    if not ok:
        raise SystemExit("paged model step disagrees with the full forward")
    if not int8["ok"]:
        raise SystemExit("int8 paged model step disagrees with the gather "
                         "path")


def _model_int8(dev, cfg, params, seq, n_prompt, n_dec, T, table):
    """The same prefill chunk + decode steps through int8 pools, once with
    the paged path (the int8 kernel) and once with the dequantizing gather
    path: layer-0 pool writes (block 0 aside) must be bitwise equal, and
    the logits within 2% of max |logit| (the reference's own bound for its
    kernel against its gather path)."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import paged_attention
    from mxnet_tpu_torch.parallel.transformer import transformer_lm_decode

    nb, bs = 64, 32
    shape = (cfg.n_layers, nb, bs, cfg.n_heads, cfg.d_head)
    sshape = (cfg.n_layers, nb, cfg.n_heads)
    runs = {}
    for kernel in ("paged", "gather"):
        pools = [torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.ones(sshape, device=dev),
                 torch.ones(sshape, device=dev)]
        q0 = paged_attention.launches_int8
        toks = np.zeros((1, T), np.int64)
        toks[0, :n_prompt] = seq[:n_prompt]
        feeds = [(toks, np.arange(T)[None], [n_prompt])] + [
            (seq[None, p:p + 1], [[p]], [1])
            for p in range(n_prompt, n_prompt + n_dec)]
        logits = []
        for tk, ps, ln in feeds:
            lg, *pools = transformer_lm_decode(
                params, tk, ps, ln, pools[0], pools[1], table, cfg,
                attention_kernel=kernel, k_scale=pools[2],
                v_scale=pools[3])
            logits.append(lg[0, :ln[0]])
        torch.cuda.synchronize()
        runs[kernel] = (torch.cat(logits), pools,
                        paged_attention.launches_int8 - q0)
    (lp, pp, np_), (lg, pg, ng) = runs["paged"], runs["gather"]
    layer0_equal = all(bool(torch.equal(a[0, 1:], b[0, 1:]))
                       for a, b in zip(pp, pg))
    err = (lp - lg).abs().max().item()
    bound = 0.02 * lg.abs().max().item()
    return {"ok": layer0_equal and err <= bound and np_ > 0 and ng == 0,
            "layer0_pools_equal": layer0_equal, "max_abs_err": err,
            "bound": bound, "int8_launches": {"paged": np_, "gather": ng}}


def _step_times(dev, cfg, params):
    """Host wall time (ending in a device sync) of the serving step's
    parts, eager as the engine runs them: a decode model step at
    max_slots=8 (contexts of 300 positions, table width 16), the sampler
    over its (8, vocab) logits, and a T=512 prefill chunk; then the same
    decode step through an int8 pool, with its two int8-specific parts
    alone: the 2 x n_layers quantizing scatters and the n_layers int8
    paged-attention kernel calls (the float pool's n_layers kernel calls
    beside them), as host wall time and as device time."""
    import torch

    from mxnet_tpu_torch.ops.paged_attention import (attention_scale,
                                                     paged_attention)
    from mxnet_tpu_torch.ops.sampling import sample_logits
    from mxnet_tpu_torch.parallel.transformer import (_scatter_kv_quantized,
                                                      transformer_lm_decode)

    B, bs, W, ctx = 8, 32, 16, 300
    nb = 1 + B * W
    shape = (cfg.n_layers, nb, bs, cfg.n_heads, cfg.d_head)
    k_pool = torch.zeros(shape, device=dev)
    v_pool = torch.zeros(shape, device=dev)
    tables = np.arange(1, 1 + B * W, dtype=np.int32).reshape(B, W)
    rs = np.random.RandomState(SEED)

    def median_ms(fn, n=15):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    toks = rs.randint(0, cfg.vocab, (B, 1))
    decode = median_ms(lambda: transformer_lm_decode(
        params, toks, np.full((B, 1), ctx), np.ones(B), k_pool, v_pool,
        tables, cfg))
    logits = torch.randn(B, cfg.vocab, device=dev)
    seeds = torch.arange(B, device=dev)
    temp = torch.full((B,), 0.8, device=dev)
    top_k = torch.full((B,), 40, device=dev)
    top_p = torch.ones(B, device=dev)
    sample = median_ms(lambda: sample_logits(logits, seeds, seeds + ctx,
                                             temp, top_k, top_p))
    ptoks = rs.randint(0, cfg.vocab, (1, 512))
    prefill = median_ms(lambda: transformer_lm_decode(
        params, ptoks, np.arange(512)[None], [512], k_pool, v_pool,
        tables[:1], cfg), n=5)
    # int8 pool: the whole step, then its scatter and kernel parts alone
    kq, vq, ksq, vsq = _int8_pools(dev, nb, bs, cfg.n_heads, cfg.d_head,
                                   SEED)
    kq = kq[None].repeat(cfg.n_layers, 1, 1, 1, 1)
    vq = vq[None].repeat(cfg.n_layers, 1, 1, 1, 1)
    ksq = ksq.nan_to_num(1.0)[None].repeat(cfg.n_layers, 1, 1)
    vsq = vsq.nan_to_num(1.0)[None].repeat(cfg.n_layers, 1, 1)
    decode_q = median_ms(lambda: transformer_lm_decode(
        params, toks, np.full((B, 1), ctx), np.ones(B), kq, vq, tables,
        cfg, k_scale=ksq, v_scale=vsq))
    t_tab = torch.as_tensor(tables, device=dev)
    pos = torch.full((B, 1), ctx, dtype=torch.int32, device=dev)
    valid = torch.ones(B, 1, dtype=torch.bool, device=dev)
    max_pos = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    vals = torch.randn(B, 1, cfg.n_heads, cfg.d_head, device=dev)

    def scatters():
        for i in range(cfg.n_layers):
            _scatter_kv_quantized(kq[i], ksq[i], vals, t_tab, pos, valid,
                                  max_pos, 1)
            _scatter_kv_quantized(vq[i], vsq[i], vals, t_tab, pos, valid,
                                  max_pos, 1)

    q = torch.randn(B, 1, cfg.n_heads, cfg.d_head, device=dev)
    scale = attention_scale(cfg.d_head)

    def attend(quantized, x=q):
        for i in range(cfg.n_layers):
            if quantized:
                y = paged_attention(x, kq[i], vq[i], t_tab, pos, max_pos,
                                    scale, ksq[i], vsq[i])
            else:
                y = paged_attention(x, k_pool[i], v_pool[i], t_tab, pos,
                                    max_pos, scale)
        return y

    # the n_layers calls' device time: a CUDA graph of them, the next
    # step's queries the last call's output
    return {"decode_b8_w16": decode, "sample_b8": sample,
            "prefill_t512": prefill, "decode_int8_b8_w16": decode_q,
            "int8_scatters_b8": median_ms(scatters),
            "int8_attention_b8": median_ms(lambda: attend(True)),
            "float_attention_b8": median_ms(lambda: attend(False)),
            "int8_attention_b8_device": time_ms(
                lambda x: attend(True, x), q, iters=5),
            "float_attention_b8_device": time_ms(
                lambda x: attend(False, x), q, iters=5)}


# -- phase 5 ------------------------------------------------------------------------
def _service(dev, cfg, params, kv_dtype=None):
    """The serving configuration and its 12 requests: prompt lengths
    16..512 from a numpy seed (the largest rung, 512, is the longest
    prompt submit() accepts; prompts past the smallest rung, 64, prefill
    in chunks), 8 greedy and 4 sampled."""
    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    gcfg = GenerationConfig(max_slots=8, block_size=32, num_blocks=2048,
                            seq_buckets=[64, 128, 256, 512],
                            max_new_tokens=32, preemption=False,
                            prefix_cache=False, kv_dtype=kv_dtype)
    rs = np.random.RandomState(SEED)
    lens = rs.randint(16, 513, size=12)
    prompts = [rs.randint(0, cfg.vocab, size=int(n)) for n in lens]
    return GenerationService(params, cfg, gcfg, device=dev), prompts


def _serve(svc, prompts):
    """Submit every request at once and wait; the streams and outputs."""
    streams = []
    for i, p in enumerate(prompts):
        if i < 8:
            streams.append(svc.submit(p))
        else:
            streams.append(svc.submit(p, temperature=0.8, top_k=40, seed=i))
    return streams, [s.result(timeout=600) for s in streams]


def _reset_launches():
    from mxnet_tpu_torch.ops import batch_norm as bn
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops import twobit as tb
    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    tb.twobit_pack.launches = 0
    tb.twobit_unpack.launches = 0
    ops_nn.batch_norm.noncontiguous_copies = 0
    bn.bn_stats.launches = 0
    bn.bn_normalize.launches = 0
    layer_norm_fused.launches = 0
    paged_attention.launches = 0
    paged_attention.launches_int8 = 0
    fa.flash_attention_forward.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0


def _read_launches():
    """Each kernel's launches since :func:`_reset_launches`, and the copies
    the BatchNorm op made of non-contiguous channels-last input (a layout
    slip: 0 on every ResNet path)."""
    from mxnet_tpu_torch.ops import batch_norm as bn
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops import twobit as tb
    from mxnet_tpu_torch.ops.layer_norm import layer_norm_fused
    from mxnet_tpu_torch.ops.paged_attention import paged_attention

    return {"twobit_pack": tb.twobit_pack.launches,
            "twobit_unpack": tb.twobit_unpack.launches,
            "bn_noncontiguous_copies":
            ops_nn.batch_norm.noncontiguous_copies,
            "bn_stats": bn.bn_stats.launches,
            "bn_normalize": bn.bn_normalize.launches,
            "layer_norm": layer_norm_fused.launches,
            "paged_attention": paged_attention.launches,
            "paged_attention_int8": paged_attention.launches_int8,
            "flash_attention_fwd": fa.flash_attention_forward.launches,
            "flash_attention_dq": fa.flash_attention_dq.launches,
            "flash_attention_dkv": fa.flash_attention_dkv.launches}


def _greedy_check(dev, cfg, params, prompts, outs):
    """Greedy tokens teacher-forced against the full-sequence forward: a
    mismatch counts as a near tie where the oracle's top-2 logit gap is
    < 1e-3, else it is a failure.  Returns (mismatches, near ties, the
    per-request gap arrays)."""
    import torch

    from mxnet_tpu_torch.parallel.transformer import transformer_lm_apply

    mismatches, near_ties, gaps = [], 0, []
    for i, (prompt, out) in enumerate(zip(prompts, outs)):
        seq = np.concatenate([prompt, out])
        logits = transformer_lm_apply(
            params, torch.as_tensor(seq[None, :-1], device=dev),
            torch.arange(len(seq) - 1, device=dev), cfg)[0]
        tail = logits[len(prompt) - 1:]
        top2 = torch.topk(tail, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        pred = tail.argmax(dim=-1).cpu().numpy()
        for j, (a, b) in enumerate(zip(pred, out)):
            if int(a) != int(b):
                if gap[j] < 1e-3:
                    near_ties += 1
                else:
                    mismatches.append((i, j, int(a), int(b), float(gap[j])))
        gaps.append(gap)
    return mismatches, near_ties, gaps


def _window(stats, steps0, streams, wall, n_tokens):
    """Throughput, TTFT and model-step time of a served window."""
    ttft = sorted(s.ttft_ms for s in streams)
    return {"wall_s": wall, "tokens": n_tokens,
            "tokens_per_s": n_tokens / wall,
            "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                        "p99": float(np.percentile(ttft, 99))},
            "steps": {k: {"steps": v["steps"]
                          - steps0.get(k, {}).get("steps", 0),
                          "seconds": v["seconds"]
                          - steps0.get(k, {}).get("seconds", 0.0)}
                      for k, v in stats["step_seconds"].items()}}


def phase_serving(dev, cfg, params, kv_dtype=None, baseline=None):
    """The 12-request serving window (reserve-ahead; ``kv_dtype="int8"``:
    the ``serving_int8`` phase, held against the float pool's greedy
    tokens ``baseline``)."""
    import torch

    name = "serving_int8" if kv_dtype else "serving"
    svc, prompts = _service(dev, cfg, params, kv_dtype)
    lens = [len(p) for p in prompts]
    try:
        t0 = time.perf_counter()
        warmed = svc.warmup()
        warm_s = time.perf_counter() - t0
        steps0 = svc.stats()["step_seconds"]
        _reset_launches()
        t0 = time.perf_counter()
        streams, outs = _serve(svc, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        stats = svc.stats()
        # batch-composition independence: each greedy request once more,
        # alone in the engine (decode still runs at all 8 slots' shape)
        alone = [svc.submit(p).result(timeout=600) for p in prompts[:8]]
    finally:
        svc.stop()
    n_tokens = sum(len(o) for o in outs)
    res = {"phase": name, "kv_dtype": stats["kv_dtype"], "requests": 12,
           "succeeded": len(outs), "failed": stats["counts"]["failed"],
           "prompt_lens": [int(n) for n in lens],
           **_window(stats, steps0, streams, wall, n_tokens),
           "warmup_s": warm_s, "warmup_signatures": warmed,
           "iterations": stats["iterations"],
           "prefill_tokens": stats["counts"]["prefill_tokens"],
           "launches": launches}
    alone_diverged = [
        (i, next(j for j, (a, b) in enumerate(zip(alone[i], outs[i]))
                 if a != b))
        for i in range(8) if alone[i] != outs[i]]
    res["greedy_alone_identical"] = 8 - len(alone_diverged)
    res["greedy_alone_diverged"] = alone_diverged
    res["sampled_in_support"] = all(
        len(o) == 32 and all(0 <= t < cfg.vocab for t in o)
        for o in outs[8:])
    res["outs"] = outs
    if kv_dtype is None:
        # greedy check, teacher-forced against the full-sequence forward;
        # a request served alone must emit the batched tokens up to the
        # first near-tie of the oracle (top-2 gap < 1e-3)
        mismatches, near_ties, gaps = _greedy_check(dev, cfg, params,
                                                    prompts[:8], outs[:8])
        for i, j in alone_diverged:
            if gaps[i][j] >= 1e-3:
                mismatches.append((i, j, "alone", alone[i][j], outs[i][j]))
        res.update(greedy_mismatches=mismatches,
                   greedy_near_tie_mismatches=near_ties)
        emit({k: v for k, v in res.items() if k != "outs"})
        if mismatches or not res["sampled_in_support"]:
            raise SystemExit("served tokens disagree with the oracle")
        if not (launches["layer_norm"] and launches["paged_attention"]):
            raise SystemExit(f"a kernel never launched on the serving "
                             f"path: {launches}")
        return res
    # int8: the float pool's greedy tokens are the reference, with the
    # reference's own bound for int8 against float (75% of positions)
    agree = sum(a == b for o1, o2 in zip(outs[:8], baseline["outs"][:8])
                for a, b in zip(o1, o2))
    total = sum(len(o) for o in baseline["outs"][:8])
    res.update(greedy_agreement_with_float=agree / total)
    emit({k: v for k, v in res.items() if k != "outs"})
    if len(outs) != 12 or res["failed"] or not res["sampled_in_support"]:
        raise SystemExit("int8 serving did not complete every request")
    if not (launches["layer_norm"] and launches["paged_attention_int8"]) \
            or launches["paged_attention"]:
        raise SystemExit(f"int8 serving did not run on LayerNorm and the "
                         f"int8 kernel alone: {launches}")
    if agree / total < 0.75:
        raise SystemExit(f"int8 greedy tokens agree with the float pool on "
                         f"{agree}/{total} positions (< 75%)")
    return res


def _default_traffic(cfg):
    """Two waves over four distinct 256-token (8-block) system prompts:
    wave 1 is one request each, system prompt plus a 16-128-token suffix
    (the first suffix 32 tokens, so that prompt is block-aligned); wave 2,
    sent when wave 1 has finished, three per system prompt: first the
    block-aligned wave-1 prompt again, then new suffixes."""
    rs = np.random.RandomState(SEED + 1)
    system = [rs.randint(0, cfg.vocab, 256) for _ in range(4)]

    def ask(i, n):
        return np.concatenate([system[i], rs.randint(0, cfg.vocab, n)])

    wave1 = [ask(i, 32 if i == 0 else int(rs.randint(16, 129)))
             for i in range(4)]
    wave2 = [wave1[0].copy()] + [ask(i, int(rs.randint(16, 129)))
                                 for i in range(4) for _ in range(3 - (i == 0))]
    return [wave1, wave2]


def phase_serving_default(dev, cfg, params):
    """``GenerationService`` with the reference's default preemption and
    prefix cache (f32 pool, a 52-block pool so that preemption fires),
    the serving phase's block size, rungs and max_new_tokens."""
    import torch

    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    gcfg = GenerationConfig(max_slots=8, block_size=32,
                            num_blocks=DEFAULT_POOL_BLOCKS,
                            seq_buckets=[64, 128, 256, 512],
                            max_new_tokens=32)
    assert gcfg.preemption and gcfg.prefix_cache
    svc = GenerationService(params, cfg, gcfg, device=dev)
    waves = _default_traffic(cfg)
    try:
        t0 = time.perf_counter()
        warmed = svc.warmup()
        warm_s = time.perf_counter() - t0
        steps0 = svc.stats()["step_seconds"]
        _reset_launches()
        windows, prompts, outs = [], [], []
        for wave in waves:
            t0 = time.perf_counter()
            streams = [svc.submit(p) for p in wave]
            got = [st.result(timeout=600) for st in streams]
            torch.cuda.synchronize()
            stats = svc.stats()
            windows.append(_window(stats, steps0, streams,
                                   time.perf_counter() - t0,
                                   sum(len(o) for o in got)))
            steps0 = stats["step_seconds"]
            prompts += wave
            outs += got
        launches = _read_launches()
        preempted_reqs = sum(1 for st in streams if st._req.n_preempted)
    finally:
        svc.stop()
    counts = stats["counts"]
    mismatches, near_ties, _ = _greedy_check(dev, cfg, params, prompts, outs)
    res = {"phase": "serving_default", "requests": len(prompts),
           "succeeded": sum(len(o) == 32 for o in outs),
           "config": {"num_blocks": DEFAULT_POOL_BLOCKS, "preemption": True,
                      "prefix_cache": True,
                      "watermarks": stats["watermarks"]},
           "waves": windows, "warmup_s": warm_s,
           "warmup_signatures": warmed, "iterations": stats["iterations"],
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "counts": {k: counts[k] for k in (
               "preempted", "prefix_hits", "prefix_misses", "cached_tokens",
               "prefill_tokens", "cow_copies", "prefix_evictions",
               "tokens", "failed")},
           "wave2_preempted_requests": preempted_reqs,
           "peak_occupancy": stats["kv_blocks"]["peak_occupancy"],
           "greedy_mismatches": mismatches,
           "greedy_near_tie_mismatches": near_ties, "launches": launches}
    emit(res)
    if mismatches or res["succeeded"] != len(prompts):
        raise SystemExit("served tokens disagree with the oracle")
    need = ("prefix_hits", "cached_tokens", "cow_copies", "preempted")
    if not all(counts[k] > 0 for k in need):
        raise SystemExit(f"the default configuration did not exercise "
                         f"{need}: {res['counts']}")
    if not (launches["layer_norm"] and launches["paged_attention"]):
        raise SystemExit(f"a kernel never launched on the serving path: "
                         f"{launches}")
    return res


# -- serving_spec and serving_fleet ------------------------------------------------
# serving_spec: bench.py speculative_decode_throughput's request mix at the
# LM's vocabulary (16 requests, odd ones periodic: 6 tokens tiled; prompts
# 24 or 48 tokens; 64 new tokens; requests 12-15 sampled), served in waves
# of max_slots so decode runs with an empty queue
SPEC_REQUESTS, SPEC_NEW_TOKENS, SPEC_SAMPLED = 16, 64, (12, 13, 14, 15)
SPEC_MULTISTEP_K, SPEC_DRAFT_K, SPEC_DRAFT_WINDOW = 8, 4, 128
SPEC_ACCEPT_MIN = 0.9


def _spec_traffic(cfg):
    rs = np.random.RandomState(0)
    prompts = []
    for i in range(SPEC_REQUESTS):
        n = int(rs.choice([24, 48]))
        if i % 2:
            prompts.append(np.tile(rs.randint(0, cfg.vocab, 6), 8)[:n])
        else:
            prompts.append(rs.randint(0, cfg.vocab, n))
    return prompts


def _spec_kwargs(i):
    if i in SPEC_SAMPLED:
        return dict(temperature=0.8, top_k=40, seed=1000 + i)
    return {}


def _sampled_check(dev, cfg, params, prompts, outs, idx):
    """Sampled tokens teacher-forced: the full forward's logits at each
    position, filtered and perturbed with the request's (seed, position)
    Gumbel noise, must pick the served token unless the top-2 gap of the
    perturbed logits is < 1e-3.  Returns (mismatches, near ties)."""
    import torch

    from mxnet_tpu_torch.ops import sampling as S
    from mxnet_tpu_torch.parallel.transformer import transformer_lm_apply

    mismatches, near_ties = [], 0
    for i in idx:
        kw = _spec_kwargs(i)
        prompt, out = prompts[i], outs[i]
        seq = np.concatenate([prompt, out])
        logits = transformer_lm_apply(
            params, torch.as_tensor(seq[None, :-1], device=dev),
            torch.arange(len(seq) - 1, device=dev), cfg)[0]
        tail = logits[len(prompt) - 1:].float()
        n = tail.shape[0]
        ctr = np.arange(len(prompt), len(prompt) + n, dtype=np.uint32)
        seeds = np.full(n, kw["seed"], np.uint32)
        filt = S.temperature_scale(
            S.top_p_mask(S.top_k_mask(tail, kw["top_k"]), 1.0),
            kw["temperature"])
        pert = filt + S.gumbel(S.fold_keys(seeds, ctr).to(dev),
                               tail.shape[-1])
        top2 = torch.topk(pert, 2, dim=-1)
        gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        pred = top2.indices[:, 0].cpu().numpy()
        for j, (a, b) in enumerate(zip(pred, out)):
            if int(a) != int(b):
                if gap[j] < 1e-3:
                    near_ties += 1
                else:
                    mismatches.append((i, j, int(a), int(b), float(gap[j])))
    return mismatches, near_ties


def _spec_run(dev, cfg, params, prompts, mode, kv_dtype=None):
    """Serve the spec traffic once in ``mode`` (single, multistep, ngram,
    model) in waves of max_slots: outputs, the window's numbers, the
    speculative/multi-step stats, kernel launches, and the program keys and
    CUDA-graph captures added after warmup (must be 0)."""
    import torch

    from mxnet_tpu_torch.serving.generation import (GenerationConfig,
                                                    GenerationService)

    kw = {"single": {}, "multistep": dict(multistep_k=SPEC_MULTISTEP_K),
          "ngram": dict(speculative=True, draft_mode="ngram",
                        draft_k=SPEC_DRAFT_K),
          "model": dict(speculative=True, draft_mode="model",
                        draft_k=SPEC_DRAFT_K,
                        draft_window=SPEC_DRAFT_WINDOW)}[mode]
    gcfg = GenerationConfig(max_slots=8, block_size=32,
                            seq_buckets=[64, 128, 256, 512],
                            max_new_tokens=SPEC_NEW_TOKENS,
                            kv_dtype=kv_dtype, **kw)
    draft = (dict(draft_params=params, draft_cfg=cfg) if mode == "model"
             else {})
    svc = GenerationService(params, cfg, gcfg, device=dev, **draft)
    try:
        t0 = time.perf_counter()
        warmed = svc.warmup()
        warm_s = time.perf_counter() - t0
        keys0 = svc.stats()["compiled_signatures"]
        caps0 = svc._programs.captures
        stats0 = svc.compile_stats()
        _reset_launches()
        t0 = time.perf_counter()
        outs, streams = [], []
        for w in range(0, len(prompts), gcfg.max_slots):
            wave = [svc.submit(p, **_spec_kwargs(i))
                    for i, p in enumerate(prompts[w:w + gcfg.max_slots],
                                          start=w)]
            outs += [s.result(timeout=600) for s in wave]
            streams += wave
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        stats = svc.stats()
        new_keys = stats["compiled_signatures"] - keys0
        new_caps = svc._programs.captures - caps0
        steps = {}
        for key, per in svc.compile_stats().items():
            kind = key[0]
            k = dict(x for x in key[1] if x[0] == "k").get("k", 1)
            before = stats0.get(key, {"hits": 0, "misses": 0,
                                      "seconds": 0.0})
            n = per["hits"] + per["misses"] - before["hits"] \
                - before["misses"]
            agg = steps.setdefault(kind, {"steps": 0, "iterations": 0,
                                          "seconds": 0.0})
            agg["steps"] += n
            agg["iterations"] += n * k
            agg["seconds"] += per["seconds"] - before["seconds"]
        greedy = [i for i in range(len(prompts)) if i not in SPEC_SAMPLED]
        acc = [streams[i].stats() for i in greedy]
        prop = sum(e["draft_proposed_tokens"] for e in acc)
    finally:
        svc.stop()
    n_tokens = sum(len(o) for o in outs)
    per_iter = {k: (v["seconds"] * 1e3 / v["iterations"]
                    if v["iterations"] else None) for k, v in steps.items()}
    return {"mode": mode, "kv_dtype": stats["kv_dtype"],
            "decode_mode": stats["decode_mode"], "outs": outs,
            "tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "warmup_s": warm_s,
            "warmup_signatures": warmed, "new_keys_after_warmup": new_keys,
            "captures_after_warmup": new_caps,
            "captures": svc._programs.captures,
            "failed": stats["counts"]["failed"],
            "speculative": stats["speculative"],
            "multistep": stats["multistep"],
            "greedy_accepted_ratio": (None if not prop else sum(
                e["draft_accepted_tokens"] for e in acc) / prop),
            "steps": steps, "ms_per_iteration": per_iter,
            "launches": launches}


def phase_serving_spec(dev, cfg, params):
    """Speculative and multi-step decode at GPT-2 width (random weights
    from seed 0): the spec traffic served single-step, multi-step
    (k=8, CUDA-graph replays), n-gram speculative (draft_k=4),
    self-draft speculative (the target's weights as draft, window 128),
    then multi-step and n-gram on the int8 pool (beside a single-step int8
    run).  Checks: (a) multi-step tokens equal single-step tokens bit for
    bit, float and int8; (b) speculative greedy tokens teacher-forced
    against the full forward, sampled ones against the same (seed,
    position) Gumbel keys on its logits (a mismatch at a top-2 gap >= 1e-3
    fails); int8 n-gram tokens, which a partial rejection's requantized
    boundary block can move off single-step int8's, teacher-forced the
    same way, missing at most twice the positions single-step int8
    misses (at least 2);
    (c) the self-draft acceptance ratio of the greedy requests >= 0.9;
    (d) no program key or capture added after warmup; (e) LayerNorm and
    the pool's paged kernel launched in every run, the other pool's
    never."""
    prompts = _spec_traffic(cfg)
    runs = {}
    for mode, kv in (("single", None), ("multistep", None),
                     ("ngram", None), ("model", None),
                     ("single", "int8"), ("multistep", "int8"),
                     ("ngram", "int8")):
        name = mode if kv is None else f"{mode}_int8"
        runs[name] = _spec_run(dev, cfg, params, prompts, mode, kv)
        emit({"phase": "serving_spec", "run": name,
              **{k: v for k, v in runs[name].items() if k != "outs"}})
    fails = []
    base, base8 = runs["single"]["outs"], runs["single_int8"]["outs"]
    # (a) multi-step bit for bit against single-step
    for name, ref in (("multistep", base), ("multistep_int8", base8)):
        diff = [i for i, (a, b) in enumerate(zip(runs[name]["outs"], ref))
                if a != b]
        if diff:
            fails.append(f"{name} differs from single-step at requests "
                         f"{diff}")
    # (b) teacher-forced checks of every float run; int8 speculative
    # against int8 single-step
    greedy = [i for i in range(len(prompts)) if i not in SPEC_SAMPLED]
    checks = {}
    for name in ("single", "ngram", "model"):
        outs = runs[name]["outs"]
        mm, nt, _ = _greedy_check(dev, cfg, params,
                                  [prompts[i] for i in greedy],
                                  [outs[i] for i in greedy])
        smm, snt = _sampled_check(dev, cfg, params, prompts, outs,
                                  SPEC_SAMPLED)
        checks[name] = {"greedy_mismatches": mm, "greedy_near_ties": nt,
                        "sampled_mismatches": smm, "sampled_near_ties": snt}
        if mm or smm:
            fails.append(f"{name}: tokens disagree with the teacher-forced "
                         f"forward: {mm + smm}")
    # int8 n-gram: a partial rejection requantizes the boundary block
    # under scales that saw the rejected drafts, so its tokens may leave
    # single-step int8's; both are teacher-forced against the float
    # forward, and the n-gram run may miss at most twice as many positions
    # (at least 2) as the single-step int8 run misses there
    missed = {}
    for name in ("single_int8", "ngram_int8"):
        outs = runs[name]["outs"]
        mm, nt, _ = _greedy_check(dev, cfg, params,
                                  [prompts[i] for i in greedy],
                                  [outs[i] for i in greedy])
        smm, snt = _sampled_check(dev, cfg, params, prompts, outs,
                                  SPEC_SAMPLED)
        missed[name] = len(mm) + len(smm)
        checks[name] = {"greedy_mismatches": mm, "greedy_near_ties": nt,
                        "sampled_mismatches": smm, "sampled_near_ties": snt}
    limit = 2 * max(1, missed["single_int8"])
    checks["ngram_int8_vs_single_int8"] = {
        "requests_differing": [i for i, (a, b) in enumerate(
            zip(runs["ngram_int8"]["outs"], base8)) if a != b],
        "teacher_forced_misses": missed, "limit": limit}
    if missed["ngram_int8"] > limit:
        fails.append(f"ngram_int8 misses the float forward at "
                     f"{missed['ngram_int8']} positions, more than {limit} "
                     f"(twice single-step int8's {missed['single_int8']})")
    # (c) self-draft acceptance on the greedy requests
    ratio = runs["model"]["greedy_accepted_ratio"]
    if ratio is None or ratio < SPEC_ACCEPT_MIN:
        fails.append(f"self-draft greedy acceptance {ratio} < "
                     f"{SPEC_ACCEPT_MIN}")
    for name, r in runs.items():
        # (d) nothing new after warmup
        if r["new_keys_after_warmup"] or r["captures_after_warmup"]:
            fails.append(f"{name}: {r['new_keys_after_warmup']} program "
                         f"keys and {r['captures_after_warmup']} captures "
                         f"after warmup")
        if r["failed"] or any(len(o) != SPEC_NEW_TOKENS for o in r["outs"]):
            fails.append(f"{name}: a request did not complete")
        # (e) kernels 5 and the pool's paged kernel on every run
        la = r["launches"]
        own, other = (("paged_attention_int8", "paged_attention")
                      if r["kv_dtype"] == "int8"
                      else ("paged_attention", "paged_attention_int8"))
        if not (la["layer_norm"] and la[own]) or la[other]:
            fails.append(f"{name}: launches {la}")
    if not runs["multistep"]["multistep"]["steps"] \
            or not runs["multistep_int8"]["multistep"]["steps"]:
        fails.append("no multi-step dispatch ran")
    if not runs["multistep"]["captures"]:
        fails.append("multi-step captured no CUDA graph")
    summary = {
        "phase": "serving_spec", "requests": len(prompts),
        "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
        "mean_accepted_len": {k: (r["speculative"] or {}).get(
            "mean_accepted_len") for k, r in runs.items()
            if r["speculative"]},
        "accepted_ratio": {k: (r["speculative"] or {}).get("accepted_ratio")
                           for k, r in runs.items() if r["speculative"]},
        "self_draft_greedy_accepted_ratio": ratio,
        "verify_ms": {k: r["ms_per_iteration"].get("gen_verify")
                      for k, r in runs.items() if r["speculative"]},
        "multistep_ms_per_token": {
            k: r["ms_per_iteration"].get("gen_multistep")
            for k, r in runs.items() if k.startswith("multistep")},
        "single_ms_per_token": {
            k: r["ms_per_iteration"].get("gen_decode")
            for k, r in runs.items() if k.startswith("single")},
        "checks": checks, "failures": fails}
    emit(summary)
    if fails:
        raise SystemExit(f"serving_spec failed: {fails}")
    launches = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "summary": summary}


def _fleet_serve(router, waves):
    """Serve the waves through the router; per request the stream and
    its tokens or the exception it raised."""
    results = []
    for wave in waves:
        streams = [router.submit(p) for p in wave]
        for s in streams:
            try:
                results.append((s, s.result(timeout=600), None))
            except Exception as exc:  # noqa: BLE001 — recorded, checked
                results.append((s, None, exc))
    return results


def _fleet(dev, cfg, params, first_rid=1000):
    """A two-replica router (affinity on) over the serving_default
    configuration with the default 128-block pools; replica 1 numbers its
    requests from ``first_rid``, so a rid names one request on one
    replica."""
    from mxnet_tpu_torch.serving import GenerationRouter, RouterConfig
    from mxnet_tpu_torch.serving.generation import GenerationConfig

    gcfg = GenerationConfig(max_slots=8, block_size=32,
                            seq_buckets=[64, 128, 256, 512],
                            max_new_tokens=32)
    router = GenerationRouter(params, cfg, gcfg,
                              RouterConfig(num_replicas=2, affinity=True),
                              start=False, device=dev)
    router._replicas[1].service._next_rid = first_rid
    return router


def phase_serving_fleet(dev, cfg, params):
    """``GenerationRouter`` with two replicas sharing the card, tracing on
    and the flight recorder writing to a temporary directory, serving
    ``_default_traffic`` three times: plainly (every stream teacher-
    forced); with ``TPUMX_FAULT_GEN_KILL_REPLICA=1@3`` (queued work on the
    killed replica resubmitted and finished, only streams under way end in
    ``ReplicaDeadError``); with ``TPUMX_FAULT_GEN_STEP_FAIL=1@1`` (request
    rid 1 of replica 0 alone ends in ``GenerationStepError``, the others'
    tokens equal the plain run's, a ``gen_quarantine`` dump names it).
    Also: ``to_prometheus()`` holds the generation gauges and ``health()``
    reports both replicas."""
    import os
    import tempfile

    import torch

    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.fault.inject import injector
    from mxnet_tpu_torch.serving import ReplicaDeadError
    from mxnet_tpu_torch.serving.generation import GenerationStepError

    waves = _default_traffic(cfg)
    prompts = [p for w in waves for p in w]
    tmp = tempfile.mkdtemp(prefix="tpumx_fleet_")
    saved = {k: os.environ.get(k) for k in (
        "TPUMX_TRACING", "TPUMX_FLIGHT_RECORDER_DIR",
        "TPUMX_FAULT_GEN_KILL_REPLICA", "TPUMX_FAULT_GEN_STEP_FAIL")}
    os.environ["TPUMX_TRACING"] = "1"
    os.environ["TPUMX_FLIGHT_RECORDER_DIR"] = tmp
    fails, res = [], {"phase": "serving_fleet", "requests": len(prompts)}
    launches = {}

    def add_launches():
        for k, v in _read_launches().items():
            launches[k] = launches.get(k, 0) + v

    def run(env):
        for k in ("TPUMX_FAULT_GEN_KILL_REPLICA",
                  "TPUMX_FAULT_GEN_STEP_FAIL"):
            os.environ.pop(k, None)
        os.environ.update(env)
        injector().reset()
        router = _fleet(dev, cfg, params)
        try:
            t0 = time.perf_counter()
            warmed = router.warmup()
            warm_s = time.perf_counter() - t0
            router.start()
            _reset_launches()
            t0 = time.perf_counter()
            results = _fleet_serve(router, waves)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            add_launches()
            st = router.stats()
            prom = obs.to_prometheus()
        finally:
            router.stop(drain=False, timeout=30)
        return router, results, st, prom, {"wall_s": wall,
                                           "warmup_s": warm_s,
                                           "warmup_signatures": warmed}

    try:
        # 1. plain
        _, results, st, prom, win = run({})
        outs = [o for _, o, _ in results]
        errs = [repr(e) for _, _, e in results if e is not None]
        if errs:
            fails.append(f"plain fleet: {errs}")
            outs = [o or [] for o in outs]
        mm, nt, _ = _greedy_check(dev, cfg, params, prompts, outs)
        if mm:
            fails.append(f"plain fleet: tokens disagree with the oracle "
                         f"{mm}")
        gauges = ("generation_running_requests", "generation_waiting_requests",
                  "generation_kv_block_occupancy", "generation_tokens_per_sec",
                  "generation_kv_blocks_used", "router_healthy_replicas")
        missing = [g for g in gauges if g not in prom]
        if missing:
            fails.append(f"to_prometheus() lacks {missing}")
        health = [r["health"] for r in st["replicas"]]
        if len(health) != 2 or not all(h["alive"] for h in health):
            fails.append(f"health() of the replicas: {health}")
        res["plain"] = {**win, "tokens": sum(len(o) for o in outs),
                        "tokens_per_s": sum(len(o) for o in outs)
                        / win["wall_s"],
                        "dispatches": [r["dispatches"]
                                       for r in st["replicas"]],
                        "affinity_entries": st["affinity_entries"],
                        "greedy_mismatches": mm, "greedy_near_ties": nt,
                        "wide_events": len(obs.recent_requests()),
                        "prometheus_gauges_present": not missing}
        # 2. replica 1 killed after its third dispatch
        router, results, st, _, win = run(
            {"TPUMX_FAULT_GEN_KILL_REPLICA": "1@3"})
        dead = [(s, e) for s, _, e in results if e is not None]
        bad = [repr(e) for s, e in dead
               if not isinstance(e, ReplicaDeadError)]
        done = [(prompts[i], o) for i, (_, o, e) in enumerate(results)
                if e is None]
        mm2, _, _ = _greedy_check(dev, cfg, params, [p for p, _ in done],
                                  [o for _, o in done])
        resubmits = sum(s.resubmits for s, _, _ in results)
        if bad or mm2:
            fails.append(f"kill: errors {bad}, mismatches {mm2}")
        if not st["replicas"][1]["dead"] or resubmits < 1:
            fails.append(f"kill: replica 1 dead={st['replicas'][1]['dead']}"
                         f", resubmits {resubmits}")
        res["kill"] = {**win, "finished": len(done),
                       "replica_dead_errors": len(dead),
                       "resubmits": resubmits,
                       "dispatches": [r["dispatches"]
                                      for r in st["replicas"]]}
        # 3. request rid 1 of replica 0 fails every step it is in
        before = set(os.listdir(tmp))
        _, results, st, _, win = run({"TPUMX_FAULT_GEN_STEP_FAIL": "1@1"})
        errs = [(i, s, e) for i, (s, _, e) in enumerate(results)
                if e is not None]
        target = [i for i, s, e in errs
                  if isinstance(e, GenerationStepError)
                  and s.replica == 0 and s.request_id == 1]
        if len(errs) != 1 or len(target) != 1:
            fails.append(f"quarantine: errors {[(i, repr(e)) for i, _, e in errs]}")
        diverged = [i for i, (s, o, e) in enumerate(results)
                    if e is None and o != outs[i]]
        if diverged:
            fails.append(f"quarantine: tokens differ from the plain run at "
                         f"requests {diverged}")
        dumps = []
        for f in sorted(set(os.listdir(tmp)) - before):
            if "gen_quarantine" in f:
                with open(os.path.join(tmp, f)) as fh:
                    dumps.append(json.load(fh)["extra"])
        if not any(d.get("rid") == 1 and d.get("replica") == 0
                   for d in dumps):
            fails.append(f"quarantine: no gen_quarantine dump for rid 1: "
                         f"{dumps}")
        res["quarantine"] = {**win, "errors": len(errs),
                             "dumps": [{k: d.get(k) for k in ("rid",
                                                              "replica")}
                                       for d in dumps],
                             "tokens_equal_plain": not diverged}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        injector().reset()
    res["launches"] = launches
    res["failures"] = fails
    emit(res)
    if fails:
        raise SystemExit(f"serving_fleet failed: {fails}")
    if not (launches["layer_norm"] and launches["paged_attention"]):
        raise SystemExit(f"a kernel never launched on the fleet path: "
                         f"{launches}")
    return {"launches": launches}


def _grad_rel_errors(m_a, m_b, m0, momentum):
    """Per-parameter normwise error ||a - b|| / ||b|| of the gradients read
    back from two steps' momenta: ``g = m_after - momentum * m_before``."""
    out = {}
    for k in m_b:
        a = m_a[k] - momentum * m0[k]
        b = m_b[k] - momentum * m0[k]
        out[k] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    return out


def phase_training(dev, cfg, params):
    """The LM training step of the reference's trainer
    (``benchmark/python/transformer/lm_bench.py``: B=8, T=1024, labels
    ``np.roll(tokens, -1, 1)``, lr 0.1, momentum 0.9) at GPT-2-small width.

    f32 check: one ``train_step`` with ``flash_attention(causal=True)``
    against one with ``local_attention(causal=True)`` from the same params
    and zero momenta — loss within 1e-5 relative, every parameter's
    gradient within 1e-4 normwise; each step's wall time (a second step)
    and device time (a third, under ``torch.profiler``: the union of its
    kernels' intervals).  Then the main path, lm_bench's flash
    leg: ten chained bf16 steps (``compute_dtype=torch.bfloat16``) on the
    same batch, counted from 0 — every loss finite, the last below the
    first, the first within 2e-2 of the f32 loss, and per step 12 launches
    of each flash kernel, 25 LayerNorms and no paged attention."""
    import functools

    import torch

    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel.ring_attention import local_attention
    from mxnet_tpu_torch.parallel.transformer import train_step

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    B, T, lr, momentum = 8, 1024, 0.1, 0.9
    rs = np.random.RandomState(SEED)
    tokens_np = rs.randint(0, cfg.vocab, (B, T))
    tokens = torch.as_tensor(tokens_np, device=dev)
    labels = torch.as_tensor(np.roll(tokens_np, -1, 1), device=dev)
    positions = torch.arange(T, device=dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    flash = functools.partial(flash_attention, causal=True)
    local = functools.partial(local_attention, causal=True)

    def timed_step(attention, p, m, dtype=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_step(p, m, tokens, labels, positions, cfg, lr=lr,
                         momentum=momentum, attention=attention,
                         compute_dtype=dtype)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    n = cfg.n_layers
    per_step = {"flash_attention_fwd": n, "flash_attention_dq": n,
                "flash_attention_dkv": n, "layer_norm": 2 * n + 1,
                "paged_attention": 0, "paged_attention_int8": 0,
                "bn_stats": 0, "bn_normalize": 0, "twobit_pack": 0,
                "twobit_unpack": 0, "bn_noncontiguous_copies": 0}
    # f32: flash against local attention
    f32 = {}
    for name, att in (("flash", flash), ("local", local)):
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (loss, _, mom), first_ms = timed_step(att, params, zeros)
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        _, again_ms = timed_step(att, params, zeros)
        f32[name] = {"loss": loss.item(), "momenta": mom,
                     "step_ms": again_ms,
                     "device_ms": _device_ms(
                         lambda: timed_step(att, params, zeros)),
                     "first_step_ms": first_ms,
                     "tokens_per_s": B * T / (again_ms / 1e3),
                     "peak_bytes": peak, "launches": launches}
    rel = _grad_rel_errors(f32["flash"]["momenta"], f32["local"]["momenta"],
                           zeros, momentum)
    loss_rel = abs(f32["flash"]["loss"] - f32["local"]["loss"]) \
        / abs(f32["local"]["loss"])
    worst = max(rel, key=rel.get)
    for v in f32.values():
        del v["momenta"]
    # the main path: lm_bench's bf16 flash leg, ten chained steps
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    p, m, losses, step_ms = params, zeros, [], []
    for _ in range(10):
        (loss, p, m), ms = timed_step(flash, p, m, torch.bfloat16)
        losses.append(loss)
        step_ms.append(ms)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    del p, m
    steady = float(np.median(step_ms[1:]))
    res = {"phase": "training", "config": dataclasses.asdict(cfg),
           "B": B, "T": T,
           "lr": lr, "momentum": momentum,
           "f32": {"flash": f32["flash"], "local": f32["local"],
                   "loss_rel_err": loss_rel,
                   "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
                   "grad_rel_err": rel,
                   "tolerance": {"loss_rel": 1e-5, "grad_rel": 1e-4}},
           "bf16": {"losses": losses, "step_ms": step_ms,
                    "steady_step_ms": steady,
                    "tokens_per_s": B * T / (steady / 1e3),
                    "peak_bytes": peak, "launches": launches,
                    "first_loss_rel_to_f32":
                    abs(losses[0] - f32["flash"]["loss"])
                    / abs(f32["flash"]["loss"])},
           "launches": launches}
    emit(res)
    bad = []
    if loss_rel > 1e-5:
        bad.append(f"f32 flash loss differs from local by {loss_rel:.3g}")
    if rel[worst] > 1e-4:
        bad.append(f"gradient of {worst} differs by {rel[worst]:.3g}")
    if f32["flash"]["launches"] != per_step:
        bad.append(f"f32 flash step launches {f32['flash']['launches']}")
    if f32["local"]["launches"] != dict(
            per_step, flash_attention_fwd=0, flash_attention_dq=0,
            flash_attention_dkv=0):
        bad.append(f"f32 local step launches {f32['local']['launches']}")
    if launches != {k: 10 * v for k, v in per_step.items()}:
        bad.append(f"bf16 steps launched {launches}, not 10 x {per_step}")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite bf16 loss: {losses}")
    elif not losses[-1] < losses[0]:
        bad.append(f"bf16 loss did not fall at lr {lr}, momentum "
                   f"{momentum}: {losses}")
    if res["bf16"]["first_loss_rel_to_f32"] > 2e-2:
        bad.append(f"bf16 first loss {losses[0]} vs f32 "
                   f"{f32['flash']['loss']}")
    if bad:
        raise SystemExit("training phase failed: " + "; ".join(bad))
    return res


def _profiled(fn, families=()):
    """Run ``fn`` under ``torch.profiler``: wall time, device busy time
    (the union of kernel intervals), the idle share, device time by kernel
    name, and by autograd backward node; with ``families``, the launches
    and names of the kernel functions whose names contain each, and the
    launch records that came back without their kernel's record
    (``lost_records``: before ``fn`` and inside it).  The profiler slows
    the host, so the wall time is not an unprofiled run's.

    A session can come back without the records of its first kernels,
    though each has its launch record, and the more of them the longer
    the process has lived, idle or not; a long first kernel does not
    help, many short ones do.  So a session that counts ``families``
    first launches ``PROFILE_LEAD`` empty ``spin_kernel``s, whose records
    take the loss; they count in no number returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD if families else 0):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("profiled_fn"):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(prof.events())
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.name
               # the window's own annotation, recorded on the device too
               and e.name != "profiled_fn"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:   # union of kernel intervals (one stream: ~the sum)
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for e in kernels:
        agg = by_name.setdefault(e.name, [0, 0.0])
        agg[0] += 1
        agg[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # the port's own kernels, by kernel function
    ours = {}
    for n, (c, us) in by_name.items():
        for k in PORT_KERNELS:
            if k in n:
                ours[k] = ours.get(k, 0.0) + us / 1e3
    # device time under each autograd backward node, inclusive of the
    # kernels its ops launch (a node whose backward runs autograd itself,
    # as the BatchNorm and LayerNorm Functions' do, includes the nodes it
    # evaluates, so the times nest and do not add up)
    nodes = {}
    for e in prof.key_averages():
        if e.key.startswith("autograd::engine::evaluate_function: "):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            nodes[e.key.split(": ", 1)[1]] = us / 1e3
    out = {"wall_s": wall, "kernels": len(kernels),
           "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / 1e6 / wall,
           "top": [{"name": n[:80], "count": c, "ms": us / 1e3}
                   for n, (c, us) in top],
           "port_kernels_ms": ours,
           "backward_nodes_ms": dict(sorted(nodes.items(),
                                            key=lambda kv: -kv[1])[:10])}
    if families:
        out["families"] = {f: sum(c for n, (c, _) in by_name.items()
                                  if f in n) for f in families}
        out["family_names"] = {f: sorted(n for n in by_name if f in n)
                               for f in families}
        # launch records whose kernel record never came back
        recorded = {e.id for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA}
        start = min((e.time_range.start for e in events
                     if e.name == "profiled_fn"), default=0.0)
        lost = [e.time_range.start >= start for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA
                and "LaunchKernel" in e.name and e.id not in recorded]
        out["lost_records"] = {"lead": lost.count(False),
                               "fn": lost.count(True)}
    return out


def _device_ms(fn):
    """Device time of ``fn`` in ms, the union of its kernels' intervals
    (``_profiled``), or None when three profiler sessions record no kernel
    (a session can come back empty; see ``_launched``)."""
    for _ in range(3):
        res = _profiled(fn)
        if res["kernels"]:
            return res["device_busy_s"] * 1e3
    return None


def phase_profile(dev, cfg, params):
    """Optional (not in the default run): the serving window once more
    under ``torch.profiler`` — device time by kernel name and the share of
    the window with no kernel running."""
    svc, prompts = _service(dev, cfg, params)
    try:
        svc.warmup()
        res = _profiled(lambda: _serve(svc, prompts))
    finally:
        svc.stop()
    emit({"phase": "profile", **res})


def phase_profile_training(dev, cfg, params):
    """Optional (not in the default run): two chained bf16 training steps
    of the ``training`` phase's main path under ``torch.profiler``, after
    one unprofiled warm-up step; the flash kernels that ran must be the
    bf16 ones (``FLASH_ROUTES``)."""
    import functools

    import torch

    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel.transformer import train_step

    B, T = 8, 1024
    tokens_np = np.random.RandomState(SEED).randint(0, cfg.vocab, (B, T))
    tokens = torch.as_tensor(tokens_np, device=dev)
    labels = torch.as_tensor(np.roll(tokens_np, -1, 1), device=dev)
    positions = torch.arange(T, device=dev)
    state = [params, {k: torch.zeros_like(v) for k, v in params.items()}]

    def steps(n):
        for _ in range(n):
            _, state[0], state[1] = train_step(
                state[0], state[1], tokens, labels, positions, cfg,
                attention=functools.partial(flash_attention, causal=True),
                compute_dtype=torch.bfloat16)

    steps(1)
    torch.cuda.synchronize()
    res = _profiled(lambda: steps(2))
    emit({"phase": "profile_training", "steps": 2, **res})
    # the bf16 window's flash kernels are the routed ones, by name
    ran = {k for k in res["port_kernels_ms"] if k.startswith("flash_")}
    if ran != set(FLASH_ROUTES["bfloat16"]):
        raise SystemExit(f"bf16 training ran flash kernels {sorted(ran)}, "
                         f"not {FLASH_ROUTES['bfloat16']}")


# -- phase 9 ------------------------------------------------------------------------
def _resnet(dev, hw=RESNET_HW):
    """``resnet50_v1(classes=1000, layout="NHWC")``, Gluon's default
    initializer drawing from seed 0, shapes resolved by one eager forward
    at ``hw`` x ``hw``; with ``block_train_fn``'s function and initial
    tensors."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel.data_parallel import block_train_fn

    net = resnet50_v1(classes=RESNET_CLASSES, layout="NHWC")
    net.initialize(ctx=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        net(torch.zeros(1, hw, hw, 3, device=dev))
    return net, *block_train_fn(net, is_train=True)


def _resnet_step(apply_fn, params, momenta, aux, x, y, dtype=None):
    """``bench.py``'s ``make_step`` over ``block_train_fn``: params, aux
    and input cast to ``dtype`` inside the loss (None: f32), f32 logits,
    ``log_softmax`` NLL mean, ``m = 0.9 m + g``, ``p = p - 0.1 m``.  Returns
    new dicts (the new running statistics in aux's dtype) and the
    gradients; the inputs are untouched."""
    import torch

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    p, a, xc = leaves, aux, x
    if dtype is not None:
        p = {k: v.to(dtype) for k, v in leaves.items()}
        a = {k: v.to(dtype) for k, v in aux.items()}
        xc = x.to(dtype)
    out, new_aux = apply_fn(p, a, xc)
    logp = torch.log_softmax(out.float(), dim=-1)
    loss = -logp.gather(1, y[:, None]).mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    with torch.no_grad():
        momenta = {k: RESNET_MOMENTUM * m + grads[k].to(m.dtype)
                   for k, m in momenta.items()}
        params = {k: v - RESNET_LR * momenta[k] for k, v in params.items()}
        new_aux = {k: v.detach().to(aux[k].dtype) for k, v in new_aux.items()}
    return loss.detach(), params, momenta, new_aux, grads


def _resnet_batch(dev, B, hw=RESNET_HW):
    """B random NHWC ``hw`` x ``hw`` images and labels, from seed 1."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(B, hw, hw, 3, generator=g, device=dev)
    y = torch.randint(0, RESNET_CLASSES, (B,), generator=g, device=dev)
    return x, y


def phase_resnet_training(dev):
    """The flagship's training step (``bench.py`` ``main``: Gluon
    ``resnet50_v1``, channels-last, bf16 compute, SGD with momentum 0.9 at
    lr 0.1) at 224x224x3, random weights and images from seed 0.

    f32 check, cuDNN deterministic: one step at B = 32 with the BatchNorm
    kernels against the same step with every BatchNorm through
    ``bn_train_reference`` — loss within 1e-5 relative, the new running
    statistics rtol 1e-5 / atol 1e-6.  The gradients: this randomly
    initialised 53-BatchNorm net amplifies f32 rounding (moving the images
    by ~2^-22 relative moves its gradients by ~2% normwise), so they are
    held against that measured floor — the plain step on the moved images
    — all together within 3x the floor, each within max(1e-4, 10x its
    own); a conv bias feeding a BatchNorm has an analytically zero
    gradient, held below 1e-6 of the largest gradient's norm on both
    sides.  (BatchNorm's own gradient, kernel forward against plain, is
    held to 1e-5 in the kernels phase.)  Then the main path: ten chained
    bf16 steps at B = 128 on one batch, counted from 0 — losses finite,
    the first two updates each lowering the loss, the first loss within
    2e-2 of the f32 loss on that batch, and per step 53 launches of each
    BatchNorm kernel and none of any other kernel; images/s (median of
    steps 2-10, host wall ending in a sync) and peak memory; the same ten
    steps with the plain BatchNorm, for the loss trajectory."""
    import torch

    from mxnet_tpu_torch.ops import batch_norm as bn
    from mxnet_tpu_torch.ops import nn as ops_nn

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    net, apply_fn, params, aux = _resnet(dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def step_with(bn_fn, x, y, dtype=None, p=params, m=zeros, a=aux):
        """One timed step with every BatchNorm through ``bn_fn``, counted
        from 0; (loss, params, momenta, aux, grads), its launches, ms and
        peak bytes."""
        ops_nn.bn_train_fused = bn_fn
        try:
            _reset_launches()
            torch.cuda.reset_peak_memory_stats()
            res, ms = timed(lambda: _resnet_step(apply_fn, p, m, a, x, y,
                                                 dtype))
            return res, _read_launches(), ms, \
                torch.cuda.max_memory_allocated()
        finally:
            ops_nn.bn_train_fused = bn.bn_train_fused

    # f32, cuDNN deterministic (the same conv algorithms throughout): the
    # step with the kernels, with the plain BatchNorm, and with the plain
    # BatchNorm on the images moved by ~one f32 rounding — the network's
    # own noise floor, against which the kernels' gradients are held
    x32, y32 = _resnet_batch(dev, RESNET_F32_BATCH)
    g1 = torch.Generator(device=dev).manual_seed(SEED + 3)
    x32p = x32 + x32 * 2.0 ** -22 * torch.empty_like(x32).uniform_(
        -1.0, 1.0, generator=g1)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        step_with(bn.bn_train_fused, x32, y32)   # warm-up
        f32 = {name: step_with(fn, x, y32) for name, fn, x in (
            ("kernels", bn.bn_train_fused, x32),
            ("plain", bn.bn_train_reference, x32),
            ("floor", bn.bn_train_reference, x32p))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    (lk, _, _, ak, gk), launches_k, ms_k, peak_k = f32["kernels"]
    (lp, _, _, ap, gp), launches_p, ms_p, peak_p = f32["plain"]
    gf = f32["floor"][0][4]
    top = max(v.norm().item() for v in gp.values())
    zero_grads = sorted(k for k, v in gp.items() if v.norm() < 1e-6 * top)
    zero_ok = all(gk[k].norm() < 1e-6 * top for k in zero_grads) and all(
        k.endswith("bias") and "conv2d" in k for k in zero_grads)

    def rel(a, keys):
        return (torch.cat([(a[k] - gp[k]).flatten() for k in keys]).norm()
                / torch.cat([gp[k].flatten() for k in keys]).norm()).item()

    live = [k for k in gp if k not in zero_grads]
    grad_rel = {k: rel(gk, [k]) for k in live}
    floor_rel = {k: rel(gf, [k]) for k in live}
    glob, glob_floor = rel(gk, live), rel(gf, live)
    over = sorted(k for k in live if grad_rel[k] > max(
        1e-4, 10 * floor_rel[k]))
    worst = max(grad_rel, key=grad_rel.get)
    aux_err = max(((ak[k] - ap[k]).abs() - 1e-5 * ap[k].abs()).max().item()
                  for k in ap)
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    f32 = {"B": RESNET_F32_BATCH,
           "kernels": {"loss": lk.item(), "step_ms": ms_k,
                       "peak_bytes": peak_k, "launches": launches_k},
           "plain": {"loss": lp.item(), "step_ms": ms_p,
                     "peak_bytes": peak_p, "launches": launches_p},
           "floor_loss": f32["floor"][0][0].item(),
           "loss_rel_err": loss_rel,
           "grad_rel_err_global": glob, "grad_rel_err_floor_global":
           glob_floor, "grad_rel_err_max": grad_rel[worst],
           "grad_rel_err_worst": worst,
           "grad_rel_err_floor_of_worst": floor_rel[worst],
           "grads_beyond_floor": over, "zero_grads": zero_grads,
           "zero_grads_ok": zero_ok,
           "running_stats_err_beyond_rtol": aux_err,
           "tolerance": {"loss_rel": 1e-5, "grad_global":
                         "3 x floor", "grad_each": "max(1e-4, 10 x floor)",
                         "running_stats": {"rtol": 1e-5, "atol": 1e-6}}}
    del gk, gp, gf, ak, ap, x32, y32, x32p

    # the f32 loss on the bf16 steps' batch (forward only)
    B = RESNET_BATCH
    x, y = _resnet_batch(dev, B)
    with torch.no_grad():
        out, _ = apply_fn(params, aux, x)
        loss128 = -torch.log_softmax(out.float(), -1).gather(
            1, y[:, None]).mean().item()
    del out
    # the main path: ten chained bf16 steps
    p, m, a, losses, step_ms = params, zeros, aux, [], []
    launches, peak = {}, 0
    for _ in range(10):
        (loss, p, m, a, _), n, ms, pk = step_with(
            bn.bn_train_fused, x, y, torch.bfloat16, p, m, a)
        losses.append(loss)
        step_ms.append(ms)
        launches = {k: launches.get(k, 0) + v for k, v in n.items()}
        peak = max(peak, pk)
    losses = [v.item() for v in losses]
    # the same ten steps with the plain BatchNorm, for the trajectory
    p, m, a, plain_losses = params, zeros, aux, []
    for _ in range(10):
        (loss, p, m, a, _), _, _, _ = step_with(
            bn.bn_train_reference, x, y, torch.bfloat16, p, m, a)
        plain_losses.append(loss.item())
    del p, m, a
    steady = float(np.median(step_ms[1:]))
    per_step = {k: 0 for k in launches}
    per_step.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    res = {"phase": "resnet_training",
           "config": {"model": "resnet50_v1", "classes": RESNET_CLASSES,
                      "layout": "NHWC", "image": [RESNET_HW, RESNET_HW, 3],
                      "parameters": sum(v.numel() for v in params.values()),
                      "batch_norms": RESNET_BNS},
           "lr": RESNET_LR, "momentum": RESNET_MOMENTUM,
           "f32": f32,
           "bf16": {"B": B, "losses": losses, "step_ms": step_ms,
                    "steady_step_ms": steady,
                    "images_per_s": B / (steady / 1e3), "peak_bytes": peak,
                    "f32_loss_same_batch": loss128,
                    "first_loss_rel_to_f32":
                    abs(losses[0] - loss128) / abs(loss128),
                    "plain_batch_norm_losses": plain_losses},
           "launches": launches}
    emit(res)
    bad = []
    if loss_rel > 1e-5:
        bad.append(f"f32 loss with the kernels differs by {loss_rel:.3g}")
    if glob > 3 * glob_floor:
        bad.append(f"gradients differ by {glob:.3g} normwise, over 3 x the "
                   f"noise floor {glob_floor:.3g}")
    if over:
        bad.append(f"gradients beyond max(1e-4, 10 x their floor): {over}")
    if not zero_ok:
        bad.append(f"gradients expected zero are not: {zero_grads}")
    if aux_err > 1e-6:
        bad.append(f"running statistics differ by {aux_err:.3g} beyond "
                   f"rtol 1e-5")
    if launches_k != per_step:
        bad.append(f"f32 kernel step launches {launches_k}")
    if launches_p != {k: 0 for k in launches}:
        bad.append(f"f32 plain step launches {launches_p}")
    if launches != {k: 10 * v for k, v in per_step.items()}:
        bad.append(f"bf16 steps launched {launches}, not 10 x {per_step}")
    if not all(np.isfinite(losses + plain_losses)):
        bad.append(f"non-finite bf16 loss: {losses}, {plain_losses}")
    elif not losses[2] < losses[1] < losses[0]:
        bad.append(f"bf16 loss did not fall over the first two updates: "
                   f"{losses}")
    if res["bf16"]["first_loss_rel_to_f32"] > 2e-2:
        bad.append(f"bf16 first loss {losses[0]} vs f32 {loss128}")
    if bad:
        raise SystemExit("resnet_training phase failed: " + "; ".join(bad))
    return res


def _trainer(net, **kw):
    """The port's ``DataParallelTrainer`` over ``net`` with Gluon's
    ``SoftmaxCrossEntropyLoss`` and bench.py's SGD (lr 0.1, momentum
    0.9)."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    return DataParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                               lr=RESNET_LR, momentum=RESNET_MOMENTUM, **kw)


def phase_resnet_compressed(dev):
    """2-bit gradient compression on the flagship: ``resnet50_v1``
    channels-last at 224x224 (random weights from a seed) trained through
    the port's mesh-less ``DataParallelTrainer`` with Gluon's
    ``SoftmaxCrossEntropyLoss``, bf16 compute, SGD lr 0.1 momentum 0.9.

    Checks first.  f32 at B = 32: the uncompressed trainer's first loss
    against ``_resnet_step``'s (the resnet_training phase's step) within
    1e-5 relative.  bf16 at B = 32, cuDNN deterministic: one compressed
    step at threshold 1e9 (every code 0) leaves every parameter
    unchanged and the residuals equal to the step's f32 gradients.  Then
    the main path: COMPRESSED_STEPS chained bf16 steps at B = 128 on one
    batch without compression and with ``{"type": "2bit", "threshold":
    0.5}``, twice each in turns (A B B A), each step counted from 0 —
    losses finite; per step 53 launches of each BatchNorm kernel, no
    BatchNorm input copy, and with compression one pack and one unpack
    launch per trainable parameter (none without); step ms (median and
    quartiles of steps 2 on of both runs), images/s and peak memory of
    each, and the compression alone between syncs (``compress_ms``)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    net, apply_fn, params, aux = _resnet(dev)
    n_params = len(params)
    bad = []
    # f32: the trainer's loss against _resnet_step's
    x, y = _resnet_batch(dev, RESNET_F32_BATCH)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    want_loss = _resnet_step(apply_fn, params, zeros, aux, x, y)[0].item()
    got = _trainer(net).step(x, y).item()
    f32_rel = abs(got - want_loss) / abs(want_loss)
    del zeros
    # threshold 1e9: nothing reaches the update, everything the residual
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        tr = _trainer(net, compute_dtype=torch.bfloat16,
                      compression_params={"type": "2bit",
                                          "threshold": 1e9})
        # the gradients the step will take, from the same parameters
        _, grads, _ = tr._loss_and_grads(x, y)
        before = dict(tr.params)
        tr.step(x, y)
        torch.cuda.synchronize()
        unchanged = [k for k in before if torch.equal(before[k],
                                                      tr.params[k])]
        carried = [k for k in grads if torch.equal(tr.residuals[k][0],
                                                   grads[k].float())]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    blocked = {"params_unchanged": len(unchanged),
               "residuals_equal_grads": len(carried), "of": n_params}
    del tr, grads, before, x, y
    # the main path, without and with compression, in turns (A B B A) so
    # that drift of the host clock falls on both alike
    B = RESNET_BATCH
    x, y = _resnet_batch(dev, B)
    comp2 = {"type": "2bit", "threshold": TWOBIT_THRESHOLD}
    runs, total = {}, {}
    for name, comp in (("uncompressed", None), ("2bit", comp2),
                       ("2bit", comp2), ("uncompressed", None)):
        tr = _trainer(net, compute_dtype=torch.bfloat16,
                      compression_params=comp)
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, per_step = [], [], []
        for _ in range(COMPRESSED_STEPS):
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            losses.append(tr.step(x, y))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(_read_launches())
        peak = torch.cuda.max_memory_allocated()
        losses = [v.item() for v in losses]
        want = {k: 0 for k in per_step[0]}
        want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
        if comp is not None:
            want.update(twobit_pack=n_params, twobit_unpack=n_params)
        run = runs.setdefault(name, {"losses": losses, "step_ms": [],
                                     "peak_bytes": 0,
                                     "launches_per_step": per_step[0],
                                     "expected_per_step": want})
        run["step_ms"].append(step_ms)
        run["peak_bytes"] = max(run["peak_bytes"], peak)
        if comp is not None and "compress_ms" not in run:
            # the compression alone, between syncs: the 386 launches and
            # their host work on an idle queue
            run["residual_max_abs"] = max(v.abs().max().item()
                                          for v in tr.residuals.values())
            _, grads, _ = tr._loss_and_grads(x, y)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr._compress(grads)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            run["compress_ms"] = float(np.median(times))
            del grads
        for n in per_step:
            total = {k: total.get(k, 0) + v for k, v in n.items()}
        off = [n for n in per_step if n != want]
        if off:
            bad.append(f"{len(off)} {name} steps launched other counts than "
                       f"{want}, the first {off[0]}")
        if not all(np.isfinite(losses)):
            bad.append(f"non-finite {name} loss: {losses}")
        del tr
    for run in runs.values():
        steady = [t for ms in run["step_ms"] for t in ms[1:]]
        run["steady_step_ms"] = float(np.median(steady))
        run["steady_step_ms_quartiles"] = [float(q) for q in np.percentile(
            steady, [25, 75])]
        run["images_per_s"] = B / (run["steady_step_ms"] / 1e3)
    res = {"phase": "resnet_compressed",
           "config": {"model": "resnet50_v1", "classes": RESNET_CLASSES,
                      "layout": "NHWC", "image": [RESNET_HW, RESNET_HW, 3],
                      "B": B, "compute_dtype": "bfloat16",
                      "trainable_parameters": n_params,
                      "elements": sum(v.numel() for v in params.values()),
                      "threshold": TWOBIT_THRESHOLD},
           "lr": RESNET_LR, "momentum": RESNET_MOMENTUM,
           "f32_loss": {"trainer": got, "resnet_step": want_loss,
                        "rel_err": f32_rel, "tolerance": 1e-5},
           "threshold_1e9": blocked, **runs,
           "compression_overhead_ms":
           runs["2bit"]["steady_step_ms"]
           - runs["uncompressed"]["steady_step_ms"],
           "launches": total}
    emit(res)
    if f32_rel > 1e-5:
        bad.append(f"f32 trainer loss {got} vs _resnet_step {want_loss}")
    if len(unchanged) != n_params or len(carried) != n_params:
        bad.append(f"threshold 1e9 step: {blocked}")
    if bad:
        raise SystemExit("resnet_compressed phase failed: " + "; ".join(bad))
    return res


def _gluon_trainable(net):
    return [(n, p) for n, p in net.collect_params().items()
            if p.grad_req != "null"]


def _gluon_one_step(dev):
    """One ``gluon.Trainer`` step (sgd, lr 0.1, momentum 0.9, wd 0, the
    ``device`` kvstore) at f32 B = 32 from ``_resnet(dev)``'s weights,
    against ``_resnet_step`` on the same net's ``block_train_fn`` tensors
    (the same update: the Trainer's 1/B rescale of the summed loss's
    gradient is exact at a power of two), and the reference step on the
    images moved by ~2^-22 (the net's f32 noise floor)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    net, apply_fn, params, aux = _resnet(dev)
    B = RESNET_F32_BATCH
    x, y = _resnet_batch(dev, B)
    g1 = torch.Generator(device=dev).manual_seed(SEED + 3)
    xp = x + x * 2.0 ** -22 * torch.empty_like(x).uniform_(
        -1.0, 1.0, generator=g1)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    # the reference first: params and aux share the net's storage, which
    # the Trainer's step writes
    lr_, p_ref, _, aux_ref, g_ref = _resnet_step(apply_fn, params, zeros,
                                                 aux, x, y)
    p_floor = _resnet_step(apply_fn, params, zeros, aux, xp, y)[1]
    old = {k: v.clone() for k, v in params.items()}
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM, "wd": 0.0},
                            kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = nd.array(x, ctx=mx.gpu(0)), nd.array(y, ctx=mx.gpu(0))
    torch.cuda.synchronize()
    _reset_launches()
    with autograd.record():
        L = loss_fn(net(X), Y)
    L.backward()
    trainer.step(B)
    torch.cuda.synchronize()
    launches = _read_launches()
    loss = L.mean().asscalar().item()
    pd = net.collect_params()
    new = {k: pd[k].data()._data for k in p_ref}
    top = max(v.norm().item() for v in g_ref.values())
    zero = sorted(k for k, v in g_ref.items() if v.norm() < 1e-6 * top)

    def rel(a, keys):
        num = torch.cat([(a[k] - p_ref[k]).flatten() for k in keys]).norm()
        den = torch.cat([(p_ref[k] - old[k]).flatten() for k in keys]).norm()
        return (num / den).item()

    live = [k for k in p_ref if k not in zero]
    each = {k: rel(new, [k]) for k in live}
    floor = {k: rel(p_floor, [k]) for k in live}
    glob, glob_floor = rel(new, live), rel(p_floor, live)
    over = sorted(k for k in live if each[k] > max(1e-4, 10 * floor[k]))
    zero_ok = all(k.endswith("bias") and "conv2d" in k for k in zero) and \
        all((new[k] - old[k]).norm() <= 1e-6 * top * RESNET_LR for k in zero)
    aux_err = max(((pd[k].data()._data - v).abs() - 1e-5 * v.abs()).max()
                  .item() for k, v in aux_ref.items())
    bitwise = all(torch.equal(new[k], p_ref[k]) for k in p_ref)
    worst = max(each, key=each.get)
    res = {"B": B, "loss": loss, "resnet_step_loss": lr_.item(),
           "loss_rel_err": abs(loss - lr_.item()) / abs(lr_.item()),
           "weights_bitwise_equal": bitwise,
           "update_rel_err_global": glob,
           "update_rel_err_floor_global": glob_floor,
           "update_rel_err_max": each[worst], "update_rel_err_worst": worst,
           "update_rel_err_floor_of_worst": floor[worst],
           "updates_beyond_floor": over, "zero_grads": zero,
           "zero_grads_ok": zero_ok,
           "running_stats_err_beyond_rtol": aux_err, "launches": launches,
           "tolerance": {"loss_rel": 1e-6, "update_global": "3 x floor",
                         "update_each": "max(1e-4, 10 x floor)",
                         "running_stats": {"rtol": 1e-5, "atol": 1e-6}}}
    bad = []
    if res["loss_rel_err"] > 1e-6:
        bad.append(f"loss {loss} vs _resnet_step {lr_.item()}")
    if glob > 3 * glob_floor:
        bad.append(f"weights differ by {glob:.3g} of the update, over 3 x "
                   f"the floor {glob_floor:.3g}")
    if over:
        bad.append(f"weights beyond max(1e-4, 10 x their floor): {over}")
    if not zero_ok:
        bad.append(f"zero-gradient parameters moved: {zero}")
    if aux_err > 1e-6:
        bad.append(f"running statistics differ by {aux_err:.3g}")
    want = {k: 0 for k in launches}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    if launches != want:
        bad.append(f"one step launched {launches}")
    return res, bad


def _sgd_foreach_step(forward, ws, ms, x, y):
    """The Gluon loop's step without the NDArray / autograd tape / kvstore
    / Trainer layer: ``forward(x)``, the gradient of the summed softmax
    cross-entropy (the per-sample loss's head gradients of ones) with
    respect to ``ws``, and the Trainer's SGD pass
    (``optimizer.SGD._update_list``: rescale 1/B, wd 1e-4, lr, momentum)
    as the same ``torch._foreach_*`` ops, in place on ``ws`` and ``ms``."""
    import torch

    out = forward(x)
    loss = -torch.log_softmax(out, dim=-1).gather(1, y[:, None]).sum()
    gs = list(torch.autograd.grad(loss, ws))
    with torch.no_grad():
        g = torch._foreach_mul(gs, 1.0 / x.shape[0])
        torch._foreach_add_(g, torch._foreach_mul(ws, [1e-4] * len(ws)))
        lg = torch._foreach_mul(g, [RESNET_LR] * len(ws))
        torch._foreach_mul_(ms, RESNET_MOMENTUM)
        torch._foreach_sub_(ms, lg)
        torch._foreach_add_(ws, ms)


def _timed_steps(step, batches):
    """``step(x, y)`` over ``batches`` (host wall ms each, ending in a
    sync), then the last batch once more under the profiler."""
    import torch

    ms = []
    for xb, yb in batches:
        xt, yt = xb._data, yb._data.long()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(xt, yt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    steady = float(np.median(ms[1:]))
    return {"step_ms": ms, "steady_step_ms": steady,
            "images_per_s": xt.shape[0] / (steady / 1e3),
            "profiled_step": _profiled(lambda: step(xt, yt))}


def _gluon_loop(dev):
    """The main path: the user's loop, ten f32 steps at B = 128 from a
    ``DataLoader`` over 1,280 random images (numpy, from SEED), the
    Trainer made before the first forward resolves the shapes.  Steps 2
    and 3 take the first batch again, so that the first two updates are
    each held to lower its loss (as ``resnet_training`` holds them on its
    one batch); the rest take the loader's next batches.  Then the same
    ten batches through ``_sgd_foreach_step`` (the same loss and
    ``_foreach`` SGD pass without the NDArray/Trainer layer), once over
    ``block_train_fn`` and once over the block called with tensors: the
    Gluon step's time less the latter's is that layer's cost."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.parallel.data_parallel import block_train_fn

    ctx = mx.gpu(0)
    B = RESNET_BATCH
    rs = np.random.default_rng(SEED)
    X = rs.standard_normal((GLUON_SAMPLES, RESNET_HW, RESNET_HW, 3),
                           dtype=np.float32)
    Y = rs.integers(0, RESNET_CLASSES, GLUON_SAMPLES).astype(np.int32)
    torch.manual_seed(SEED)    # the initializer draws from torch's own
    net = gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES,
                                             layout="NHWC")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    np.random.seed(SEED)       # the shuffle draws from numpy's own
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, Y),
                                   batch_size=B, shuffle=True,
                                   last_batch="discard")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM, "wd": 1e-4})
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, data_ms, per_step, batches = [], [], [], [], []
    write_check = None
    it = iter(loader)
    for step in range(GLUON_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step in (1, 2):
            x, y = batches[0]   # the first batch again (see the doc)
        else:
            x, y = next(it)
            x, y = x.as_in_context(ctx), y.as_in_context(ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _reset_launches()
        with autograd.record():
            L = loss_fn(net(x), y)
        if step == GLUON_STEPS - 1:
            # grad_req="write": a second backward over the same graph
            # leaves the one gradient, not their sum
            L.backward(retain_graph=True)
            once = {n: p.grad()._data.clone()
                    for n, p in _gluon_trainable(net)}
        L.backward()
        if step == GLUON_STEPS - 1:
            write_check = {n: (p.grad()._data - once[n]).abs().max().item()
                           / max(once[n].abs().max().item(), 1e-30)
                           for n, p in _gluon_trainable(net)}
            del once
        trainer.step(x.shape[0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per_step.append(_read_launches())
        data_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        losses.append(L.mean().asscalar().item())
        batches.append((x, y))
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.median(step_ms[1:]))
    loop_ms = float(np.median([a + b for a, b in zip(step_ms[1:],
                                                     data_ms[1:])]))
    launches = {k: sum(n[k] for n in per_step) for k in per_step[0]}
    # one more step under the profiler: every kernel the step launches
    x, y = batches[-1]

    def gluon_step():
        with autograd.record():
            L2 = loss_fn(net(x), y)
        L2.backward()
        trainer.step(x.shape[0])

    prof = _profiled(gluon_step)
    # the same ten batches, and the same _foreach SGD pass, without the
    # NDArray, autograd tape, kvstore or Trainer: through block_train_fn's
    # functional forward, and through the block itself called with tensors
    # (the one forward the Gluon step runs, so the difference is the
    # layer's alone)
    apply_fn, params, aux = block_train_fn(net, is_train=True)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    box = [{k: v.clone() for k, v in aux.items()}]

    def functional(xt):
        out, new_aux = apply_fn(leaves, box[0], xt)
        box[0] = {k: v.detach() for k, v in new_aux.items()}
        return out

    ws = list(leaves.values())
    ms = [torch.zeros_like(w) for w in ws]
    functional_run = _timed_steps(
        lambda xt, yt: _sgd_foreach_step(functional, ws, ms, xt, yt), batches)
    del leaves, box, ws, ms

    def eager(xt):
        with autograd.train_mode():
            return net(xt)

    ws = [p._tensor() for _, p in _gluon_trainable(net)]
    ms = [torch.zeros_like(w) for w in ws]
    eager_run = _timed_steps(
        lambda xt, yt: _sgd_foreach_step(eager, ws, ms, xt, yt), batches)
    del ws, ms, batches
    n_params = len(_gluon_trainable(net))
    res = {"B": B, "steps": GLUON_STEPS, "samples": GLUON_SAMPLES,
           "trainable_parameters": n_params, "losses": losses,
           "step_ms": step_ms,
           "data_ms": data_ms, "steady_step_ms": steady,
           "images_per_s": B / (steady / 1e3),
           "loop_images_per_s": B / (loop_ms / 1e3), "peak_bytes": peak,
           "profiled_step": prof,
           "block_train_fn": functional_run, "eager_block": eager_run,
           "trainer_layer_ms": steady - eager_run["steady_step_ms"],
           "trainer_layer_device_ms": (
               prof["device_busy_s"]
               - eager_run["profiled_step"]["device_busy_s"]) * 1e3,
           "grad_write_rel_err": max(write_check.values()),
           "launches_per_step": per_step[0], "launches": launches}
    bad = []
    want = {k: 0 for k in per_step[0]}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    off = [n for n in per_step if n != want]
    if off:
        bad.append(f"{len(off)} loop steps launched other counts than "
                   f"{want}, the first {off[0]}")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite loss: {losses}")
    if not losses[2] < losses[1] < losses[0]:
        bad.append(f"the first two updates did not each lower the first "
                   f"batch's loss: {losses[:3]}")
    if res["grad_write_rel_err"] > 1e-6:
        bad.append(f"two backwards left {res['grad_write_rel_err']:.3g} "
                   f"relative beyond one gradient (grad_req='write')")
    return net, res, bad


def _gluon_compressed(dev):
    """Three f32 Trainer steps at B = 32 with 2-bit compression through
    the ``device`` kvstore: one pack and one unpack a trainable parameter
    a step.  After step 1, the store's residuals and the gradients it
    pulled back are held, bit for bit, to the 2-bit round trip written out
    plainly here (from a zero residual: q = +-t where the gradient reaches
    +-t, else 0; residual = gradient - q), so that a wrong quantization
    fails as well as a wrong wiring.  (The kernels themselves are held to
    their plain versions in the kernels phase.)"""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    net = _resnet(dev)[0]
    comp = {"type": "2bit", "threshold": TWOBIT_THRESHOLD}
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM, "wd": 1e-4},
                            compression_params=comp)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _resnet_batch(dev, RESNET_F32_BATCH)
    X, Y = nd.array(x, ctx=mx.gpu(0)), nd.array(y, ctx=mx.gpu(0))
    trainable = _gluon_trainable(net)
    n = len(trainable)
    losses, per_step, raw = [], [], None
    for step in range(GLUON_COMPRESSED_STEPS):
        torch.cuda.synchronize()
        _reset_launches()
        with autograd.record():
            L = loss_fn(net(X), Y)
        L.backward()
        if step == 0:
            raw = [p.grad()._data.clone() for _, p in trainable]
        trainer.step(RESNET_F32_BATCH)
        torch.cuda.synchronize()
        per_step.append(_read_launches())
        losses.append(L.mean().asscalar().item())
        if step == 0:
            t = torch.tensor(TWOBIT_THRESHOLD, device=dev)
            store, idx = trainer._kvstore._residuals, trainer._param2idx
            res_equal = grad_equal = 0
            for (name, p), g in zip(trainable, raw):
                q = t * (g >= t) - t * (g <= -t)
                res_equal += torch.equal(store[(idx[name], 0)], g - q)
                grad_equal += torch.equal(p.grad()._data, q)
            del raw
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}
    res = {"B": RESNET_F32_BATCH, "steps": GLUON_COMPRESSED_STEPS,
           "threshold": TWOBIT_THRESHOLD, "trainable_parameters": n,
           "losses": losses, "residuals_bitwise_equal": res_equal,
           "pulled_grads_bitwise_equal": grad_equal,
           "launches_per_step": per_step[0], "launches": launches}
    want = {k: 0 for k in per_step[0]}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS,
                twobit_pack=n, twobit_unpack=n)
    bad = []
    off = [s for s in per_step if s != want]
    if off:
        bad.append(f"{len(off)} compressed steps launched other counts than "
                   f"{want}, the first {off[0]}")
    if res_equal != n or grad_equal != n:
        bad.append(f"after step 1, {res_equal} residuals and {grad_equal} "
                   f"pulled gradients of {n} bitwise equal to the plain "
                   f"2-bit round trip")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite compressed loss: {losses}")
    return res, bad


def _gluon_files(dev, net):
    """``save_parameters`` on the card, ``load_parameters`` into a fresh
    net: eval-mode outputs bitwise equal; the file's bytes equal those a
    CPU net holding the same weights writes."""
    import os

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_files")
    os.makedirs(out_dir, exist_ok=True)
    f_gpu = os.path.join(out_dir, "resnet50_gpu.params")
    f_cpu = os.path.join(out_dir, "resnet50_cpu.params")
    net.save_parameters(f_gpu)
    fresh = gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES,
                                               layout="NHWC")
    fresh.load_parameters(f_gpu, ctx=mx.gpu(0))
    x = nd.array(_resnet_batch(dev, 8)[0], ctx=mx.gpu(0))
    a, b = net(x), fresh(x)
    equal = torch.equal(a._data, b._data)
    on_cpu = gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES,
                                                layout="NHWC")
    on_cpu.load_parameters(f_gpu, ctx=mx.cpu())
    on_cpu.save_parameters(f_cpu)
    with open(f_gpu, "rb") as f1, open(f_cpu, "rb") as f2:
        same = f1.read() == f2.read()
    res = {"bytes": os.path.getsize(f_gpu), "outputs_bitwise_equal": equal,
           "cpu_file_bytes_equal": same}
    for f in (f_gpu, f_cpu):
        os.remove(f)
    bad = []
    if not equal:
        bad.append("the reloaded net's eval output differs")
    if not same:
        bad.append("the parameter file written on the card differs from "
                   "the CPU net's")
    return res, bad


def _gluon_card_dataset(dev):
    """A dataset kept on the card, ``ArrayDataset(nd.array(X, ctx=gpu))``:
    its batches are stacked where the samples lie (``nd.stack``, as the
    reference's ``default_batchify_fn`` stacks), so they come out on the
    card, bit for bit the same rows uploaded whole; the labels (a 1-d
    array, which ``ArrayDataset`` reads through numpy, as the reference's
    does) come out equal to the numpy rows."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    ctx, n, B = mx.gpu(0), 64, 32
    rs = np.random.default_rng(SEED + 5)
    X = rs.standard_normal((n, RESNET_HW, RESNET_HW, 3), dtype=np.float32)
    Y = rs.integers(0, RESNET_CLASSES, n).astype(np.int32)
    ds = gluon.data.ArrayDataset(nd.array(X, ctx=ctx), nd.array(Y, ctx=ctx))
    batches = list(gluon.data.DataLoader(ds, batch_size=B))
    devices = sorted({str(x.context) for x, _ in batches})
    equal = sum(torch.equal(x._data, torch.from_numpy(X[i * B:(i + 1) * B])
                            .to(dev))
                for i, (x, _) in enumerate(batches))
    labels = sum(np.array_equal(y.asnumpy(), Y[i * B:(i + 1) * B])
                 for i, (_, y) in enumerate(batches))
    res = {"samples": n, "B": B, "batches": len(batches),
           "image_batch_devices": devices, "images_bitwise_equal": equal,
           "labels_equal": labels}
    bad = []
    if devices != [str(ctx)] or len(batches) != n // B:
        bad.append(f"a dataset on the card gave {len(batches)} image "
                   f"batches on {devices}")
    if equal != n // B or labels != n // B:
        bad.append(f"card dataset batches: {equal} image and {labels} "
                   f"label batches of {n // B} equal to the rows")
    return res, bad


def phase_gluon_training(dev):
    """The imperative Gluon training loop through the port's own
    modules — ``NDArray``, ``autograd.record``/``backward``,
    ``gluon.Trainer`` over the ``device`` kvstore, ``DataLoader`` and
    parameter files — on ``resnet50_v1(classes=1000, layout="NHWC")`` at
    224x224x3 in f32 (Gluon's default dtype), cuDNN deterministic, TF32
    off.  ``_gluon_one_step`` holds one Trainer step against
    ``_resnet_step``; ``_gluon_loop`` is the main path (ten steps at B =
    128: 53 + 53 BatchNorm launches a step and no other port kernel,
    losses finite, the first two updates each lowering the first batch's
    loss, ``grad_req="write"`` seen on the card; images/s and peak memory
    beside ``_sgd_foreach_step``'s over ``block_train_fn`` and over the
    block on the same batches, and one profiled step of each); ``_gluon_compressed`` the 2-bit path; ``_gluon_files``
    the parameter files; ``_gluon_card_dataset`` a dataset kept on the
    card."""
    import gc

    import torch

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    gc.collect()   # earlier phases' nets hold marked variables until then
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        one, bad = _gluon_one_step(dev)
        gc.collect()
        net, loop, bad_loop = _gluon_loop(dev)
        comp, bad_comp = _gluon_compressed(dev)
        files, bad_files = _gluon_files(dev, net)
        card_ds, bad_ds = _gluon_card_dataset(dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    launches = {k: loop["launches"][k] + comp["launches"][k]
                for k in loop["launches"]}
    res = {"phase": "gluon_training",
           "config": {"model": "resnet50_v1", "classes": RESNET_CLASSES,
                      "layout": "NHWC", "image": [RESNET_HW, RESNET_HW, 3],
                      "dtype": "float32", "optimizer": "sgd",
                      "lr": RESNET_LR, "momentum": RESNET_MOMENTUM,
                      "kvstore": "device"},
           "one_step": one, "loop": loop, "compressed": comp,
           "files": files, "card_dataset": card_ds, "launches": launches}
    emit(res)
    bad += bad_loop + bad_comp + bad_files + bad_ds
    if bad:
        raise SystemExit("gluon_training phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# module_fit: Module.fit over the example ResNet symbol
# ---------------------------------------------------------------------------

_FIT_BN = dict(fix_gamma=False, eps=2e-5, momentum=0.9)


def _fit_preact_conv(mx, x, width, kernel, stride, tag):
    normed = mx.sym.BatchNorm(data=x, name=tag + "_norm", **_FIT_BN)
    active = mx.sym.Activation(data=normed, act_type="relu")
    k = (kernel, kernel)
    conv = mx.sym.Convolution(data=active, num_filter=width, kernel=k,
                              stride=(stride, stride), pad=(kernel // 2,) * 2,
                              no_bias=True, name=tag + "_w")
    return active, conv


def _fit_residual_unit(mx, x, width, stride, project, tag, deep):
    if deep:
        plan = [(width // 4, 1, 1), (width // 4, 3, stride), (width, 1, 1)]
    else:
        plan = [(width, 3, stride), (width, 3, 1)]
    first_act = None
    h = x
    for step, (w, kernel, s) in enumerate(plan):
        act, h = _fit_preact_conv(mx, h, w, kernel, s, f"{tag}_p{step}")
        if first_act is None:
            first_act = act
    if project:
        skip = mx.sym.Convolution(data=first_act, num_filter=width,
                                  kernel=(1, 1), stride=(stride, stride),
                                  no_bias=True, name=tag + "_proj")
    else:
        skip = x
    return h + skip


def _example_resnet_symbol(num_classes, num_layers=50,
                           image_shape="3,224,224"):
    """``example/image-classification/symbols/resnet.py``'s
    ``get_symbol``, written against the port (the example imports the JAX
    package): pre-activation units, the thumbnail stem at cifar sizes.
    Built under a fresh ``NameManager``, its graph JSON is the example's,
    byte for byte (``tests/test_torch_symbol.py``)."""
    import mxnet_tpu_torch as mx

    shape = [int(v) for v in image_shape.split(",")] \
        if isinstance(image_shape, str) else list(image_shape)
    if shape[1] <= 32:
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            reps, deep, widths = (num_layers - 2) // 9, True, [16, 64, 128,
                                                               256]
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            reps, deep, widths = (num_layers - 2) // 6, False, [16, 16, 32,
                                                                64]
        else:
            raise ValueError(f"no cifar resnet spec for depth {num_layers}")
        repeats, thumbnail = [reps] * 3, True
    else:
        depths = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
                  50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
                  152: ([3, 8, 36, 3], True)}
        if num_layers not in depths:
            raise ValueError(f"no imagenet resnet spec for depth "
                             f"{num_layers}")
        repeats, deep = depths[num_layers]
        base = 256 if deep else 64
        widths, thumbnail = [64] + [base << i for i in range(4)], False
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.BatchNorm(data=x, fix_gamma=True, eps=2e-5, momentum=0.9,
                             name="input_whiten")
        if thumbnail:
            x = mx.sym.Convolution(data=x, num_filter=widths[0],
                                   kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                   no_bias=True, name="stem_w")
        else:
            x = mx.sym.Convolution(data=x, num_filter=widths[0],
                                   kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                                   no_bias=True, name="stem_w")
            x = mx.sym.BatchNorm(data=x, name="stem_norm", **_FIT_BN)
            x = mx.sym.Activation(data=x, act_type="relu")
            x = mx.sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2),
                               pad=(1, 1), pool_type="max")
        for stage, (reps, width) in enumerate(zip(repeats, widths[1:])):
            for unit in range(reps):
                stride = 2 if (stage > 0 and unit == 0) else 1
                x = _fit_residual_unit(mx, x, width, stride,
                                       project=(unit == 0),
                                       tag=f"s{stage}u{unit}", deep=deep)
        x = mx.sym.BatchNorm(data=x, name="head_norm", **_FIT_BN)
        x = mx.sym.Activation(data=x, act_type="relu")
        x = mx.sym.Pooling(data=x, global_pool=True, kernel=(7, 7),
                           pool_type="avg", name="head_pool")
        x = mx.sym.FullyConnected(data=mx.sym.Flatten(data=x),
                                  num_hidden=num_classes, name="fc1")
        return mx.sym.SoftmaxOutput(data=x, name="softmax")


def _fit_loaded_symbol():
    """The ResNet-50 symbol through ``tojson`` -> ``sym.load_json`` (the
    loaded one is what the phase binds), and whether the loaded symbol
    writes the same bytes."""
    import mxnet_tpu_torch as mx

    net = _example_resnet_symbol(RESNET_CLASSES, 50,
                                 f"3,{RESNET_HW},{RESNET_HW}")
    text = net.tojson()
    loaded = mx.sym.load_json(text)
    return loaded, text, loaded.tojson() == text


def _fit_optimizer_params():
    """``bench.py`` ``e2e_throughput``'s SGD settings plus a
    ``MultiFactorScheduler`` as ``common/fit.py`` builds one (its step
    at update 8, so the decay falls inside the 12-batch epoch)."""
    import mxnet_tpu_torch as mx

    return {"learning_rate": FIT_LR, "momentum": FIT_MOMENTUM,
            "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                step=list(FIT_LR_STEPS), factor=FIT_LR_FACTOR)}


def _fit_images(n, B, seed, image=None, classes=RESNET_CLASSES):
    """``n`` batches of B random images of shape ``image`` (N(0, 1);
    default 3 x RESNET_HW x RESNET_HW) and labels from a seeded numpy
    generator; batches 1 and 2 repeat batch 0, so the first two updates
    can each be held to lower its loss."""
    image = image or (3, RESNET_HW, RESNET_HW)
    rs = np.random.default_rng(seed)
    X = rs.standard_normal((n * B,) + tuple(image), dtype=np.float32)
    Y = rs.integers(0, classes, n * B).astype(np.float32)
    for k in range(1, min(n, 3)):
        X[k * B:(k + 1) * B] = X[:B]
        Y[k * B:(k + 1) * B] = Y[:B]
    return X, Y


def _ce(probs, labels) -> float:
    """Mean cross-entropy of a SoftmaxOutput's probabilities."""
    import torch

    p = probs._data.float()
    y = labels._data.long().to(p.device)
    return -torch.log(p.gather(1, y[:, None]).clamp_min(1e-30)).mean().item()


def _rel(a, b) -> float:
    import torch

    num = (a.double() - b.double()).norm().item()
    den = b.double().norm().item()
    return num / den if den else num


def _fit_fused_vs_legacy(net):
    """One fused Module step (``Executor.fused_step``) against one legacy
    step (``forward_backward`` + ``update`` through the ``Updater``) from
    the same parameters and batch: loss and every weight and moving
    statistic to 1e-6 normwise."""
    import torch

    import mxnet_tpu_torch as mx

    B = RESNET_BATCH
    X, Y = _fit_images(1, B, SEED + 5)
    it = mx.io.NDArrayIter(X, Y, batch_size=B)
    batch = next(iter(it))
    res = {}
    start = None
    for route in ("fused", "legacy"):
        mod = mx.mod.Module(net, label_names=["softmax_label"])
        mod.bind(it.provide_data, it.provide_label)
        if start is None:
            torch.manual_seed(SEED)
            mod.init_params(mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
            start = mod.get_params()
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                           optimizer_params=_fit_optimizer_params())
        took = route == "fused" and mod._try_fused_step(batch)
        if route == "legacy":
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        loss = _ce(mod.get_outputs()[0], batch.label[0])
        arg, aux = mod.get_params()
        res[route] = (loss, {**arg, **{"aux:" + k: v for k, v in
                                       aux.items()}}, took)
        del mod
    (la, pa, fused_took), (lb, pb, _) = res["fused"], res["legacy"]
    errs = {k: _rel(pa[k]._data, pb[k]._data) for k in pb}
    worst = max(errs, key=errs.get)
    out = {"B": B, "loss_fused": la, "loss_legacy": lb,
           "loss_rel_err": abs(la - lb) / abs(lb),
           "fused_route_taken": fused_took,
           "max_rel_err": errs[worst], "worst": worst,
           "bitwise_equal": all(torch.equal(pa[k]._data, pb[k]._data)
                                for k in pb),
           "tolerance": 1e-6}
    bad = []
    if not fused_took:
        bad.append("the fused Module step was not taken")
    if out["loss_rel_err"] > 1e-6 or errs[worst] > 1e-6:
        bad.append(f"fused and legacy steps differ: loss {la} vs {lb}, "
                   f"{worst} by {errs[worst]:.3g}")
    return out, bad


def _fit_main(net, text):
    """The main path: ``Module.fit`` over ``NDArrayIter`` (FIT_BATCHES x
    B random images), ``kvstore="tpu_sync"``, SGD with the scheduler,
    Xavier(gaussian, in, 2), metrics acc and top-5, ``Speedometer`` and a
    timing callback (a sync, then the host clock), ``do_checkpoint``."""
    import tempfile

    import torch

    import mxnet_tpu_torch as mx

    B = RESNET_BATCH
    X, Y = _fit_images(FIT_BATCHES, B, SEED)
    it = mx.io.NDArrayIter(X, Y, batch_size=B)
    mod = mx.mod.Module(net, label_names=["softmax_label"])
    metric = mx.metric.create(["acc", mx.metric.create("top_k_accuracy",
                                                       top_k=5)])
    marks, losses = [], []

    def timing(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(_ce(param.locals["self"].get_outputs()[0],
                          param.locals["data_batch"].label[0]))

    torch.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = f"{tmp}/resnet50"
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, kvstore="tpu_sync", optimizer="sgd",
                optimizer_params=_fit_optimizer_params(),
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                eval_metric=metric,
                batch_end_callback=[mx.callback.Speedometer(B, 4,
                                                            auto_reset=False),
                                    timing],
                epoch_end_callback=mx.callback.do_checkpoint(prefix))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _read_launches()
        fused_steps = mod._fused_step_count
        peak = torch.cuda.max_memory_allocated()
        # check 4: the checkpoint files read back bitwise, the JSON bytes
        _, cargs, cauxs = mx.model.load_checkpoint(prefix, 1)
        with open(f"{prefix}-symbol.json") as f:
            json_equal = f.read() == text
    arg, aux = mod.get_params()
    ckpt_bitwise = (set(cargs) == set(arg) and set(cauxs) == set(aux) and all(
        torch.equal(cargs[k]._data.to(arg[k]._data.device), arg[k]._data)
        for k in arg) and all(
        torch.equal(cauxs[k]._data.to(aux[k]._data.device), aux[k]._data)
        for k in aux))
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
    steady = float(np.median(step_ms[1:10]))
    # the fused step alone on a batch already on the card, and the
    # executor's host time for one forward (per-node dispatch)
    it.reset()
    batch = next(iter(it))
    alone = []
    for _ in range(4):
        torch.cuda.synchronize()
        s = time.perf_counter()
        mod._try_fused_step(batch)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - s) * 1e3)
    ex = mod._exec
    fwd_host, fwd_wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        s = time.perf_counter()
        ex.forward(is_train=False)
        fwd_host.append((time.perf_counter() - s) * 1e3)
        torch.cuda.synchronize()
        fwd_wall.append((time.perf_counter() - s) * 1e3)
    prof = _profiled(lambda: (mod._try_fused_step(batch),
                              mod.update_metric(metric, batch.label)))
    nodes = sum(1 for n in ex._order if n.kind == "op")
    res = {"B": B, "batches": FIT_BATCHES, "fit_s": fit_s,
           "step_ms": step_ms, "steady_step_ms": steady,
           "images_per_s": B / (steady / 1e3),
           "fused_step_alone_ms": alone,
           "fused_step_alone_images_per_s": B / (
               float(np.median(alone[1:])) / 1e3),
           "executor_forward_host_ms": float(np.median(fwd_host)),
           "executor_forward_wall_ms": float(np.median(fwd_wall)),
           "op_nodes": nodes, "peak_bytes": peak, "losses": losses,
           "metric": dict(metric.get_name_value()),
           "lr_after": mod._optimizer.learning_rate,
           "fused_steps": fused_steps,
           "checkpoint_bitwise": ckpt_bitwise,
           "checkpoint_json_equal": json_equal,
           "profiled_step": prof, "launches": launches}
    bad = []
    if fused_steps != FIT_BATCHES:
        bad.append(f"fit took the fused step {fused_steps} times in "
                   f"{FIT_BATCHES} batches")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite loss: {losses}")
    if not losses[2] < losses[1] < losses[0]:
        bad.append(f"the first two updates did not each lower the first "
                   f"batch's loss: {losses[:3]}")
    if not (ckpt_bitwise and json_equal):
        bad.append(f"checkpoint files: params bitwise {ckpt_bitwise}, "
                   f"JSON bytes {json_equal}")
    want_lr = FIT_LR * FIT_LR_FACTOR ** sum(FIT_BATCHES > s
                                            for s in FIT_LR_STEPS)
    if abs(res["lr_after"] - want_lr) > 1e-12:
        bad.append(f"scheduled rate {res['lr_after']}, expected {want_lr}")
    if any(launches.values()):
        bad.append(f"the channels-first net launched port kernels: "
                   f"{launches}")
    return mod, res, bad


def _fill(ex, args, aux, dev):
    import torch

    for n, v in args.items():
        ex.arg_dict[n]._data.copy_(torch.from_numpy(v).to(dev))
    for n, v in aux.items():
        ex.aux_dict[n]._data.copy_(torch.from_numpy(v).to(dev))


def _random_values(sym, data_shape, seed, classes):
    """Numpy arguments (weights N(0, 1/fan-in), gammas near 1, labels in
    range) and aux states (moving variances positive) for ``sym``."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    rs = np.random.default_rng(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rs.integers(0, classes, s).astype(np.float32)
        elif n == "data":
            args[n] = rs.standard_normal(s, dtype=np.float32)
        elif n.endswith("gamma"):
            args[n] = (1 + 0.1 * rs.standard_normal(s)).astype(np.float32)
        else:
            fan = int(np.prod(s[1:])) if len(s) > 1 else 1
            args[n] = (rs.standard_normal(s) / np.sqrt(fan)).astype(
                np.float32)
    aux = {n: (0.1 * rs.standard_normal(s) if n.endswith("mean")
               else 1 + 0.5 * rs.random(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _tolerance(errs, floors):
    """Each tensor's error against max(1e-4, 10 x its floor), the global
    one against max(1e-4, 3 x the global floor): which tensors fail."""
    return sorted(k for k in errs
                  if errs[k] > max(1e-4, 10 * floors.get(k, 0.0)))


def _fit_cifar_card_vs_cpu(dev):
    """The example symbol at its cifar depth (ResNet-20, 32x32, B=16)
    through the executor on the card and on the CPU from the same numpy
    arguments: the training forward's output, every parameter gradient
    and every moving-statistic update.  The floor is the card against
    itself with the images moved by ~2^-22 (gluon_training's measure)."""
    import torch

    import mxnet_tpu_torch as mx

    net = _example_resnet_symbol(10, 20, "3,32,32")
    shape = (CIFAR_BATCH, 3, 32, 32)
    args, aux = _random_values(net, shape, SEED + 6, 10)
    req = {n: ("null" if n in ("data", "softmax_label") else "write")
           for n in net.list_arguments()}
    moved = dict(args)
    u = np.random.default_rng(SEED + 7).uniform(-1, 1, shape)
    moved["data"] = (args["data"] * (1 + 2.0 ** -22 * u)).astype(np.float32)

    def run(ctx, values):
        ex = net.simple_bind(ctx=ctx, grad_req=req, data=shape)
        _fill(ex, values, aux, mx.context.resolve_device(ctx))
        out = ex.forward(is_train=True)[0]._data
        ex.backward()
        got = {"out": out}
        got.update({"grad:" + n: ex.grad_dict[n]._data
                    for n in ex._grad_arg_names})
        got.update({"aux:" + n: ex.aux_dict[n]._data for n in ex._aux_names})
        return {k: v.detach().cpu() for k, v in got.items()}

    card = run(mx.gpu(0), args)
    card_moved = run(mx.gpu(0), moved)
    cpu = run(mx.cpu(), args)
    errs = {k: _rel(card[k], cpu[k]) for k in cpu}
    floors = {k: _rel(card_moved[k], card[k]) for k in card}
    glob = _rel(torch.cat([card[k].flatten() for k in cpu]),
                torch.cat([cpu[k].flatten() for k in cpu]))
    glob_floor = _rel(torch.cat([card_moved[k].flatten() for k in card]),
                      torch.cat([card[k].flatten() for k in card]))
    over = _tolerance(errs, floors)
    worst = max(errs, key=errs.get)
    res = {"B": CIFAR_BATCH, "tensors": len(errs), "rel_err_global": glob,
           "floor_global": glob_floor, "max_rel_err": errs[worst],
           "worst": worst, "floor_of_worst": floors[worst],
           "over_tolerance": over,
           "tolerance": {"each": "max(1e-4, 10 x floor)",
                         "global": "max(1e-4, 3 x floor)",
                         "set_by": "floor" if 3 * glob_floor > 1e-4
                         else "1e-4"}}
    bad = []
    if over or glob > max(1e-4, 3 * glob_floor):
        bad.append(f"cifar ResNet-20 card vs CPU: global {glob:.3g} "
                   f"(floor {glob_floor:.3g}), beyond tolerance {over}")
    return res, bad


def _nhwc_symbol():
    """The channels-last check net: NHWC_UNITS units of a 1x1
    ``Convolution(layout="NHWC")`` + ``BatchNorm(axis=3)`` + ReLU at
    56x56x256, global average pooling, a 10-way ``FullyConnected`` and
    ``SoftmaxOutput``."""
    import mxnet_tpu_torch as mx

    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        for u in range(NHWC_UNITS):
            x = mx.sym.Convolution(data=x, num_filter=NHWC_C, kernel=(1, 1),
                                   no_bias=True, layout="NHWC",
                                   name=f"u{u}_conv")
            x = mx.sym.BatchNorm(data=x, axis=3, name=f"u{u}_bn",
                                 **_FIT_BN)
            x = mx.sym.Activation(data=x, act_type="relu")
        x = mx.sym.Pooling(data=x, global_pool=True, kernel=(1, 1),
                           pool_type="avg", layout="NHWC")
        x = mx.sym.FullyConnected(data=mx.sym.Flatten(data=x),
                                  num_hidden=10, name="fc")
        return mx.sym.SoftmaxOutput(data=x, name="softmax")


def _fit_channels_last(dev):
    """``Module.fit`` over the channels-last check net at B=NHWC_BATCH on
    the card (BatchNorm through ``bn_train_fused``: one stats and one
    normalize launch per BatchNorm node a step) and on the CPU, from the
    same numpy parameters and batches: each batch's outputs and the final
    parameters and moving statistics, to check 2's tolerance against the
    card's own floor (the images moved by ~2^-22)."""
    import torch

    import mxnet_tpu_torch as mx

    net = _nhwc_symbol()
    B, n = NHWC_BATCH, NHWC_BATCHES
    X, Y = _fit_images(n, B, SEED + 8, (NHWC_HW, NHWC_HW, NHWC_C), 10)
    params, aux = _random_values(net, (B, NHWC_HW, NHWC_HW, NHWC_C),
                                 SEED + 9, 10)
    params = {k: v for k, v in params.items()
              if k not in ("data", "softmax_label")}
    u = np.random.default_rng(SEED + 10).uniform(-1, 1, X.shape)
    X_moved = (X * (1 + 2.0 ** -22 * u)).astype(np.float32)

    def run(ctx, images):
        outs = []

        def keep(param):
            outs.append(param.locals["self"].get_outputs()[0]._data.cpu())

        with ctx:
            it = mx.io.NDArrayIter(images, Y, batch_size=B)
            mod = mx.mod.Module(net, label_names=["softmax_label"],
                                context=ctx)
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params=_fit_optimizer_params(),
                    arg_params=params, aux_params=aux,
                    batch_end_callback=keep)
            arg, auxs = mod.get_params()
        got = {f"out{i}": o for i, o in enumerate(outs)}
        got.update({k: v._data.cpu() for k, v in arg.items()})
        got.update({"aux:" + k: v._data.cpu() for k, v in auxs.items()})
        return got

    torch.cuda.synchronize()
    _reset_launches()
    card = run(mx.gpu(0), X)
    torch.cuda.synchronize()
    launches = _read_launches()
    card_moved = run(mx.gpu(0), X_moved)
    cpu = run(mx.cpu(), X)
    errs = {k: _rel(card[k], cpu[k]) for k in cpu}
    floors = {k: _rel(card_moved[k], card[k]) for k in card}
    over = _tolerance(errs, floors)
    worst = max(errs, key=errs.get)
    res = {"B": B, "batches": n, "shape": [B, NHWC_HW, NHWC_HW, NHWC_C],
           "units": NHWC_UNITS, "max_rel_err": errs[worst], "worst": worst,
           "floor_of_worst": floors[worst], "over_tolerance": over,
           "launches": launches}
    bad = []
    want = {k: 0 for k in launches}
    want.update(bn_stats=NHWC_UNITS * n, bn_normalize=NHWC_UNITS * n)
    if launches != want:
        bad.append(f"channels-last fit launched {launches}, expected "
                   f"{want}")
    if over:
        bad.append(f"channels-last fit card vs CPU beyond tolerance: "
                   f"{over} (worst {worst} {errs[worst]:.3g})")
    return res, bad


def phase_module_fit(dev):
    """``Module.fit`` over the symbolic API (SURVEY §3.1's path, the one
    ``bench.py`` ``e2e_throughput`` times): the example ResNet-50 symbol
    (``_example_resnet_symbol``, NCHW, 1000 classes) through ``tojson`` ->
    ``sym.load_json``, bound by ``Module`` on the default context, in f32
    with TF32 off and cuDNN deterministic.  Checks: a fused against a
    legacy Module step (1e-6); the cifar depth on the card against the
    CPU; losses finite, the first two updates lowering the repeated first
    batch's loss; the ``do_checkpoint`` files bitwise; the channels-last
    check net through ``bn_train_fused`` (its launches are this phase's).
    Numbers: images/s and step ms (median of steps 2-10), the executor's
    host ms a forward and its op-node count, one profiled step's device
    ms and idle share, peak memory, the metrics."""
    import gc

    import torch

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    gc.collect()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        net, text, json_roundtrip = _fit_loaded_symbol()
        mod, main, bad = _fit_main(net, text)
        del mod
        gc.collect()
        fused, bad_fused = _fit_fused_vs_legacy(net)
        gc.collect()
        cifar, bad_cifar = _fit_cifar_card_vs_cpu(dev)
        nhwc, bad_nhwc = _fit_channels_last(dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    launches = {k: main["launches"][k] + nhwc["launches"][k]
                for k in main["launches"]}
    res = {"phase": "module_fit",
           "config": {"symbol": "example/image-classification/symbols/"
                      "resnet.py", "num_layers": 50,
                      "num_classes": RESNET_CLASSES,
                      "image_shape": [3, RESNET_HW, RESNET_HW],
                      "dtype": "float32", "optimizer": "sgd", "lr": FIT_LR,
                      "momentum": FIT_MOMENTUM,
                      "lr_scheduler": {"MultiFactorScheduler": {
                          "step": list(FIT_LR_STEPS),
                          "factor": FIT_LR_FACTOR}},
                      "kvstore": "tpu_sync",
                      "initializer": "Xavier(gaussian, in, 2)"},
           "json_roundtrip": json_roundtrip, "fit": main,
           "fused_vs_legacy": fused, "cifar_card_vs_cpu": cifar,
           "channels_last": nhwc, "launches": launches}
    emit(res)
    if not json_roundtrip:
        bad.append("load_json(tojson()) wrote other bytes")
    bad += bad_fused + bad_cifar + bad_nhwc
    if bad:
        raise SystemExit("module_fit phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# fit_resume: fault-tolerant Module.fit (checkpoints, preemption, resume)
# and the fused step's device-side telemetry
# ---------------------------------------------------------------------------

class _Env:
    """Set environment variables for a block, then put them back."""

    def __init__(self, **env):
        self.env = {k: str(v) for k, v in env.items()}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _resume_fit(net, X, Y, init, B, num_epoch=1, ckdir=None, every=0,
                preempt=None, resume=False, telemetry=True, ctx=None):
    """One ``Module.fit`` of ``net`` over ``NDArrayIter(X, Y)`` from the
    numpy ``init = (args, aux)``, SGD with module_fit's settings: whether
    it completed, each batch's loss and end mark (a sync of the step's
    stream, then the host clock), whether a checkpoint write was in flight
    when each next step began, the parameters and aux states (on the
    card), the module and its checkpoint manager."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.fault import injector

    env = {"TPUMX_TELEMETRY": int(telemetry),
           "TPUMX_TELEMETRY_EVERY": RESUME_TELE_EVERY}
    if preempt:
        env["TPUMX_FAULT_PREEMPT_AT_STEP"] = preempt
    out = {"losses": [], "marks": [], "busy": [], "manager": None}

    def batch_end(param):
        torch.cuda.current_stream().synchronize()
        out["marks"].append(time.perf_counter())
        out["losses"].append(_ce(param.locals["self"].get_outputs()[0],
                                 param.locals["data_batch"].label[0]))
        ck = param.locals.get("ckpt")
        if ck is not None:
            out["manager"] = ck.manager
            out["busy"].append(not ck.manager._idle.is_set())

    with _Env(**env):
        injector().reset()
        try:
            with ctx or mx.gpu(0):
                mod = mx.mod.Module(net, label_names=["softmax_label"],
                                    context=ctx)
                torch.cuda.current_stream().synchronize()
                out["t0"] = time.perf_counter()
                out["done"] = mod.fit(
                    mx.io.NDArrayIter(X, Y, batch_size=B),
                    num_epoch=num_epoch, optimizer="sgd",
                    optimizer_params={"learning_rate": FIT_LR,
                                      "momentum": FIT_MOMENTUM},
                    arg_params=init[0], aux_params=init[1],
                    batch_end_callback=batch_end, checkpoint_dir=ckdir,
                    checkpoint_every=every, resume=resume)
                arg, aux = mod.get_params()
        finally:
            with _Env(TPUMX_FAULT_PREEMPT_AT_STEP=""):
                injector().reset()
    out["params"] = {k: v._data for k, v in arg.items()}
    out["params"].update({"aux:" + k: v._data for k, v in aux.items()})
    out["module"] = mod
    return out


def _step_ms(run):
    marks = [run["t0"]] + run["marks"]
    return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def _bit_diff(a, b):
    """The largest |a - b| over the tensors of two parameter dicts (0.0
    when every tensor is bitwise equal), and the tensors that differ."""
    import torch

    worst, names = 0.0, []
    for k in b:
        if not torch.equal(a[k], b[k]):
            names.append(k)
            worst = max(worst, float((a[k].double() - b[k].double()).abs()
                                     .max()))
    return worst, names


def _resume_check(tag, full, floor_run, pre, res, at):
    """The preempted run stopped after a synchronous checkpoint at step
    ``at``; the resumed run's losses and final parameters equal the
    uninterrupted run's bitwise, or within the card's own floor (two
    uninterrupted runs, ``floor_run``) where those already differ."""
    floor, floor_names = _bit_diff(floor_run["params"], full["params"])
    loss_floor = max([abs(a - b) for a, b in zip(floor_run["losses"],
                                                  full["losses"])] or [0])
    diff, names = _bit_diff(res["params"], full["params"])
    loss_diff = max(abs(a - b) for a, b in zip(res["losses"],
                                               full["losses"][at:]))
    out = {"preempted_returned": pre["done"], "resumed_returned": res["done"],
           "resumed_steps": res["module"]._fused_step_count,
           "losses_full": full["losses"], "losses_resumed": res["losses"],
           "param_max_abs_diff": diff, "params_differing": len(names),
           "loss_max_abs_diff": loss_diff,
           "floor_param_max_abs_diff": floor,
           "floor_params_differing": len(floor_names),
           "floor_loss_max_abs_diff": loss_floor,
           "bitwise": diff == 0.0 and loss_diff == 0.0}
    bad = []
    if pre["done"] is not False:
        bad.append(f"{tag}: the preempted fit returned {pre['done']}")
    if res["done"] is not True or out["resumed_steps"] != \
            len(full["losses"]) - at:
        bad.append(f"{tag}: the resumed fit returned {res['done']} after "
                   f"{out['resumed_steps']} steps")
    if diff > floor or loss_diff > loss_floor:
        bad.append(f"{tag}: the resumed run left the uninterrupted one: "
                   f"params {diff:.3g} (floor {floor:.3g}), losses "
                   f"{loss_diff:.3g} (floor {loss_floor:.3g})")
    return out, bad


def _resume_channels_last(dev):
    """The channels-last check net (kernels 3-4 in its BatchNorms) through
    the same flow at B=NHWC_BATCH: two uninterrupted runs of two epochs of
    two batches, one preempted at step 3, one resumed."""
    import tempfile

    net = _nhwc_symbol()
    B = NHWC_BATCH
    X, Y = _fit_images(2, B, SEED + 8, (NHWC_HW, NHWC_HW, NHWC_C), 10)
    args, aux = _random_values(net, (B, NHWC_HW, NHWC_HW, NHWC_C),
                               SEED + 9, 10)
    init = ({k: v for k, v in args.items()
             if k not in ("data", "softmax_label")}, aux)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, kw in (("full", {}), ("again", {}),
                        ("preempted", dict(ckdir=tmp, every=2, preempt=3)),
                        ("resumed", dict(ckdir=tmp, every=2, resume=True))):
            runs[tag] = _resume_fit(net, X, Y, init, B, num_epoch=2, **kw)
    return _resume_check("channels-last", runs["full"], runs["again"],
                         runs["preempted"], runs["resumed"], 3)


def _telemetry_check(run):
    """The gauges published at the last step (``TPUMX_TELEMETRY_EVERY``
    divides the step count) against the norms of ``get_params`` and of
    the bound gradients, in f64 on the card."""
    import torch

    from mxnet_tpu_torch import observability as obs

    gauges = obs.snapshot()["gauges"]
    mod = run["module"]
    ex = mod._exec
    pn = float(torch.sqrt(sum((mod.get_params()[0][n]._data.double() ** 2)
                              .sum() for n in ex._grad_arg_names)))
    gn = float(torch.sqrt(sum((ex.grad_dict[n]._data.double() ** 2).sum()
                              for n in ex._grad_arg_names)))
    out = {"train_grad_norm": gauges.get("train_grad_norm"),
           "grad_norm": gn, "train_param_norm": gauges.get(
               "train_param_norm"), "param_norm": pn,
           "train_loss": gauges.get("train_loss"),
           "train_nonfinite_grads_total": gauges.get(
               "train_nonfinite_grads_total"),
           "train_skip_steps_total": gauges.get("train_skip_steps_total"),
           "rtol": 1e-5}
    bad = []
    for g, want in (("train_grad_norm", gn), ("train_param_norm", pn)):
        got = out[g]
        if got is None or abs(got - want) > 1e-5 * abs(want):
            bad.append(f"telemetry {g} {got} against {want}")
    if out["train_nonfinite_grads_total"] != 0 or \
            out["train_skip_steps_total"] != 0:
        bad.append(f"telemetry counted non-finite gradients: {out}")
    return out, bad


def _stall_profile(run, X, Y, B, directory):
    """One profiled fused step of a fitted module alone and one while an
    async checkpoint write of it is in flight: wall and device ms and the
    idle share of each (does the writer stall the host or the card?)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import TrainCheckpointer

    mod = run["module"]
    with mx.gpu(0):
        batch = next(iter(mx.io.NDArrayIter(X[:B], Y[:B], batch_size=B)))
        mod._try_fused_step(batch)
        quiet = _profiled(lambda: mod._try_fused_step(batch))
        ck = TrainCheckpointer(mod, directory)
        ck.save(0, 1, 1, blocking=False)
        loaded = _profiled(lambda: mod._try_fused_step(batch))
        still = not ck.manager._idle.is_set()
        ck.close()
    keep = ("wall_s", "device_busy_s", "idle_share", "kernels")
    return {"alone": {k: quiet[k] for k in keep},
            "write_in_flight": {k: loaded[k] for k in keep},
            "write_still_in_flight_after": still}


def phase_fit_resume(dev):
    """Fault-tolerant ``Module.fit`` on module_fit's ResNet-50 symbol
    (224x224, 1000 classes) at B=RESNET_F32_BATCH over FIT_BATCHES batches,
    f32, TF32 off, cuDNN deterministic, SGD lr FIT_LR momentum 0.9, from
    seeded numpy parameters: (1) an uninterrupted run with telemetry
    (``TPUMX_TELEMETRY_EVERY=4``: the published norms against
    ``get_params`` and the gradients, rtol 1e-5); (2) the same with
    telemetry off (parameters bitwise); (3) the same writing an async
    checkpoint every RESUME_TIMING_EVERY steps (parameters bitwise: the
    writer only reads; the median step with a write in flight beside one
    without); a second uninterrupted run gives the card's floor; (4) a run writing every RESUME_EVERY steps preempted at step
    RESUME_AT (``TPUMX_FAULT_PREEMPT_AT_STEP``: a real SIGTERM) that
    returns False after a synchronous checkpoint; (5) a fresh Module that
    resumes and finishes: losses and parameters bitwise the uninterrupted
    run's, or within the card's floor where two uninterrupted runs differ
    (runs 2 and 3 are held to it too);
    then the newest checkpoint flipped: restore falls back to the one
    before.  The channels-last check net runs the same flow (its
    BatchNorms launch kernels 3-4).  Numbers: save ms and bytes, async
    and sync; step ms with and without a write in flight, and one
    profiled step of each (device time and idle share); step ms with
    telemetry on and off; launches by wrapper.  A failed async write
    (``checkpoint_save_failures_total``) fails the phase."""
    import gc
    import tempfile

    import torch

    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.fault import corrupt_checkpoint

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    gc.collect()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    failures0 = obs.snapshot()["counters"].get(
        "checkpoint_save_failures_total", 0)
    B = RESNET_F32_BATCH
    net, _, _ = _fit_loaded_symbol()
    X, Y = _fit_images(FIT_BATCHES, B, SEED + 20)
    args, aux = _random_values(net, (B, 3, RESNET_HW, RESNET_HW), SEED + 21,
                               RESNET_CLASSES)
    init = ({k: v for k, v in args.items()
             if k not in ("data", "softmax_label")}, aux)
    runs, bad = {}, []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            _reset_launches()
            runs["full"] = _resume_fit(net, X, Y, init, B)
            tele, bad_tele = _telemetry_check(runs["full"])
            runs["again"] = _resume_fit(net, X, Y, init, B)
            runs["telemetry_off"] = _resume_fit(net, X, Y, init, B,
                                                telemetry=False)
            runs["timing"] = _resume_fit(net, X, Y, init, B,
                                         ckdir=f"{tmp}/timing",
                                         every=RESUME_TIMING_EVERY)
            ckdir = f"{tmp}/resume"
            runs["preempted"] = _resume_fit(net, X, Y, init, B, ckdir=ckdir,
                                            every=RESUME_EVERY,
                                            preempt=RESUME_AT)
            pre_steps = [s for s, _ in CheckpointManager(ckdir).list()]
            runs["resumed"] = _resume_fit(net, X, Y, init, B, ckdir=ckdir,
                                          every=RESUME_EVERY, resume=True)
            nhwc, bad_nhwc = _resume_channels_last(dev)
            torch.cuda.synchronize()
            launches = _read_launches()
            stall = _stall_profile(runs["timing"], X, Y, B, f"{tmp}/stall")
            # the newest checkpoint corrupted: restore takes the one before
            mgr = CheckpointManager(ckdir)
            steps = [s for s, _ in mgr.list()]
            corrupt_checkpoint(mgr.list()[0][1], "flip")
            fallback = mgr.restore()[0].step
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    resumed, bad_resume = _resume_check("ResNet-50", runs["full"],
                                        runs["again"], runs["preempted"],
                                        runs["resumed"], RESUME_AT)
    floor = resumed["floor_param_max_abs_diff"]
    off_diff, _ = _bit_diff(runs["telemetry_off"]["params"],
                            runs["full"]["params"])
    timing_diff, _ = _bit_diff(runs["timing"]["params"],
                               runs["full"]["params"])
    timing = runs["timing"]
    steps_ms = _step_ms(timing)
    # step k began with a write in flight when the writer was busy at
    # step k-1's end; the first step of each run is left out (warm-up)
    in_flight = [ms for ms, b in zip(steps_ms[1:], timing["busy"]) if b]
    idle = [ms for ms, b in zip(steps_ms[1:], timing["busy"]) if not b]
    saves = {}
    for tag in ("timing", "preempted", "resumed"):
        for mode, s, nbytes, host_s in runs[tag]["manager"].history:
            saves.setdefault(mode, []).append({
                "run": tag, "ms": s * 1e3, "to_host_ms": host_s * 1e3,
                "bytes": nbytes})
    failures = obs.snapshot()["counters"].get(
        "checkpoint_save_failures_total", 0) - failures0
    res = {"phase": "fit_resume",
           "config": {"symbol": "example/image-classification/symbols/"
                      "resnet.py", "num_layers": 50,
                      "image_shape": [3, RESNET_HW, RESNET_HW],
                      "num_classes": RESNET_CLASSES, "B": B,
                      "batches": FIT_BATCHES, "dtype": "float32",
                      "optimizer": "sgd", "lr": FIT_LR,
                      "momentum": FIT_MOMENTUM,
                      "checkpoint_every": RESUME_EVERY,
                      "preempt_at": RESUME_AT,
                      "timing_checkpoint_every": RESUME_TIMING_EVERY,
                      "telemetry_every": RESUME_TELE_EVERY},
           "resume": resumed, "channels_last": nhwc,
           "checkpoints_when_preempted": pre_steps,
           "checkpoints_after_resume": steps, "fallback_step": fallback,
           "saves": saves, "save_failures": failures,
           "step_ms_no_checkpoints": _step_ms(runs["full"]),
           "step_ms_checkpointing": steps_ms,
           "write_in_flight": timing["busy"],
           "profiled_step": stall,
           "median_step_ms": {
               "no_checkpoints": float(np.median(_step_ms(runs["full"])[1:])),
               "write_in_flight": float(np.median(in_flight))
               if in_flight else None,
               "no_write_in_flight": float(np.median(idle))
               if idle else None,
               "telemetry_off": float(np.median(
                   _step_ms(runs["telemetry_off"])[1:]))},
           "telemetry": tele,
           "telemetry_off_param_max_abs_diff": off_diff,
           "checkpointing_run_param_max_abs_diff": timing_diff,
           "launches": launches}
    emit(res)
    bad += bad_tele + bad_resume + bad_nhwc
    if max(pre_steps) != RESUME_AT:
        bad.append(f"the preempted run's checkpoints {pre_steps}: none at "
                   f"step {RESUME_AT}")
    if len(steps) < 2 or fallback != steps[1]:
        bad.append(f"restore after flipping {steps[:1]} took {fallback}, "
                   f"not {steps[1:2]}")
    if off_diff > floor:
        bad.append(f"telemetry off moved the parameters by {off_diff:.3g} "
                   f"(floor {floor:.3g})")
    if timing_diff > floor:
        bad.append(f"checkpoint writes moved the parameters by "
                   f"{timing_diff:.3g} (floor {floor:.3g})")
    if failures:
        bad.append(f"{failures} checkpoint writes failed")
    want = {k: 0 for k in launches}
    steps_nhwc = 4 + 4 + 3 + 1  # two full runs, preempted, resumed
    want.update(bn_stats=NHWC_UNITS * steps_nhwc,
                bn_normalize=NHWC_UNITS * steps_nhwc)
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if bad:
        raise SystemExit("fit_resume phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# inference_service: InferenceService with its micro-batcher
# ---------------------------------------------------------------------------

def _serve_clients(svc, samples, clients, window):
    """``clients`` threads share ``samples``, each keeping ``window``
    requests in flight: the outputs (on the host, in order), the wall
    seconds and the first client error."""
    import threading

    outs = [None] * len(samples)
    errors = []

    def client(c):
        try:
            mine = list(range(c, len(samples), clients))
            for i in range(0, len(mine), window):
                idx = mine[i:i + window]
                futs = [svc.submit(samples[j]) for j in idx]
                for j, f in zip(idx, futs):
                    outs[j] = f.result(120)._data.cpu()
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return outs, time.perf_counter() - t0, errors[:1]


def _served_vs_predict(svc, outs, want, probe, rtol=1e-5, atol=1e-6):
    """Each served row against the same sample's ``Module.predict`` row;
    where a bucket's batch size alone moves cuDNN's result, the card's
    floor: each bound bucket executor run directly on the first samples
    (``probe``) against predict's rows."""
    import torch

    got = torch.stack(outs)
    err = (got - want).abs()
    excess = float((err - (atol + rtol * want.abs())).max())
    floor = 0.0
    for sig, ex in svc._adapter._cache.items():
        name, (b, *_), _ = sig[0]
        rows = ex.forward(is_train=False, **{name: probe[:b]})[0]._data
        floor = max(floor, float((rows.cpu() - want[:b]).abs().max()))
    return {"max_abs_err": float(err.max()), "excess_over_tol": excess,
            "bucket_floor_max_abs": floor, "rtol": rtol, "atol": atol}


def _serve_model(mod, samples, shape, max_batch, clients, windows):
    """``InferenceService`` over ``mod`` (bound for inference) with batch
    buckets up to ``max_batch`` and one shape bucket, once for each client
    window (a fresh service each): warmup, then the clients; each run's
    stats and binds after warmup, its outputs against ``Module.predict``'s
    over the same samples (predict's samples/s beside), and the launches
    counted up to that predict."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import InferenceService, ServingConfig

    runs, outs, svcs, bad = [], [], [], []
    try:
        for window in windows:
            svc = InferenceService(mod, ServingConfig(
                max_batch_size=max_batch, batch_timeout_ms=2.0,
                shape_buckets=[tuple(shape)], queue_bound=1024))
            svcs.append(svc)
            t0 = time.perf_counter()
            warmed = svc.warmup()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            binds0 = svc.stats()["compile_cache"]["misses"]
            got, wall, errors = _serve_clients(svc, samples, clients, window)
            stats = svc.stats()
            outs.append(got)
            runs.append({
                "window": window, "warmup_binds": warmed, "warmup_s": warm_s,
                "binds_after_warmup":
                stats["compile_cache"]["misses"] - binds0,
                "wall_s": wall, "requests_per_s": len(samples) / wall,
                "latency_ms": stats["latency_ms"],
                "queue_wait_ms_p99": stats.get("queue_wait_ms_p99"),
                "batches": stats["batches"],
                "avg_batch_size": stats["avg_batch_size"],
                "batch_occupancy": stats["batch_occupancy"],
                "errors": errors})
            if errors or any(o is None for o in got):
                bad.append(f"window {window}: requests failed: {errors}")
            if runs[-1]["binds_after_warmup"]:
                bad.append(f"window {window}: "
                           f"{runs[-1]['binds_after_warmup']} executor "
                           f"binds after warmup")
        B = mod.data_shapes[0][1][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = mod.predict(mx.io.NDArrayIter(np.stack(samples),
                                             batch_size=B))
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        launches = _read_launches()   # the path's; the floor pass follows
        want = want._data.cpu()
        probe = torch.from_numpy(np.stack(samples[:max_batch]))
        checks = [_served_vs_predict(svcs[0], got, want, probe)
                  for got in outs if all(o is not None for o in got)]
    finally:
        for svc in svcs:
            svc.stop()
    for run, check in zip(runs, checks):
        run["vs_predict"] = check
        if check["excess_over_tol"] > check["bucket_floor_max_abs"]:
            bad.append(f"window {run['window']}: served outputs against "
                       f"Module.predict: {check}")
    res = {"requests": len(samples), "clients": clients,
           "max_batch": max_batch,
           "batch_buckets": svcs[0]._config.batch_buckets, "runs": runs,
           "predict_s": predict_s,
           "predict_per_s": len(samples) / predict_s, "launches": launches}
    return res, want, bad


class _TailIter:
    """Full batches of ``X``, then one smaller final batch (no pad)."""

    def __init__(self, mx, X, B):
        self.mx, self.X, self.B = mx, X, B
        self.provide_data = [mx.io.DataDesc("data", (B,) + X.shape[1:])]
        self.provide_label = []

    def reset(self):
        pass

    def __iter__(self):
        for i in range(0, len(self.X), self.B):
            yield self.mx.io.DataBatch(
                data=[self.mx.nd.array(self.X[i:i + self.B])], label=None)


def _bert_block():
    """A BERT-base-width feed-forward block: FullyConnected 768 -> 3072,
    GELU, 3072 -> 768, the residual and ``LayerNorm`` (kernel 5), over
    (B, BERT_SEQ, BERT_WIDTH)."""
    import mxnet_tpu_torch as mx

    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        h = mx.sym.FullyConnected(x, num_hidden=BERT_FF, flatten=False,
                                  name="ffn_1")
        h = mx.sym.LeakyReLU(h, act_type="gelu")
        h = mx.sym.FullyConnected(h, num_hidden=BERT_WIDTH, flatten=False,
                                  name="ffn_2")
        return mx.sym.LayerNorm(h + x, name="ln")


def _inference_module(net, data_shape, seed, labels):
    import mxnet_tpu_torch as mx

    args, aux = _random_values(net, data_shape, seed, RESNET_CLASSES)
    mod = mx.mod.Module(net, label_names=["softmax_label"] if labels
                        else None)
    label_shapes = [("softmax_label", data_shape[:1])] if labels else None
    mod.bind(data_shapes=[("data", data_shape)], label_shapes=label_shapes,
             for_training=False)
    mod.init_params(arg_params={k: v for k, v in args.items()
                                if k not in ("data", "softmax_label")},
                    aux_params=aux)
    return mod


def phase_inference_service(dev):
    """``serving.InferenceService`` on the card: (a) module_fit's ResNet-50
    symbol bound for inference at B=SERVE_MAX_BATCH (f32, cuDNN
    deterministic), batch buckets up to it; after ``warmup`` SERVE_CLIENTS
    threads send SERVE_REQUESTS single images, each client keeping 4 in
    flight, then 16, on a fresh service (SERVE_WINDOWS); every output equals the same image's row of
    one ``Module.predict`` over the images (rtol 1e-5, atol 1e-6, or the
    card's floor where a bucket's batch size alone moves cuDNN's result);
    no executor bound after warmup; requests/s, p50/p99 latency and batch
    occupancy beside predict's images/s.  (b) A BERT-base-width FFN block
    with ``LayerNorm`` at sequence BERT_SEQ served the same way (kernel 5's
    launches by wrapper, counted from before (a)'s warmup to (b)'s
    predict).  (c) ``Module.predict`` on a final batch of 8 after 32 (F5):
    its rows equal (a)'s predict rows."""
    import torch

    import mxnet_tpu_torch as mx

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    bad = []
    try:
        with mx.gpu(0):
            net, _, _ = _fit_loaded_symbol()
            shape = (3, RESNET_HW, RESNET_HW)
            mod = _inference_module(net, (SERVE_MAX_BATCH,) + shape,
                                    SEED + 30, labels=True)
            X, _ = _fit_images(SERVE_REQUESTS // SERVE_MAX_BATCH,
                               SERVE_MAX_BATCH, SEED + 31)
            images = list(X)
            bert = _inference_module(
                _bert_block(), (BERT_MAX_BATCH, BERT_SEQ, BERT_WIDTH),
                SEED + 32, labels=False)
            seqs = list(np.random.default_rng(SEED + 33).standard_normal(
                (BERT_REQUESTS, BERT_SEQ, BERT_WIDTH), dtype=np.float32))
            torch.cuda.synchronize()
            _reset_launches()
            resnet, want, bad_a = _serve_model(mod, images, shape,
                                               SERVE_MAX_BATCH,
                                               SERVE_CLIENTS, SERVE_WINDOWS)
            ex = mod._exec
            tail = mod.predict(_TailIter(mx, X[:SERVE_PARTIAL],
                                         SERVE_MAX_BATCH))
            tail = tail._data.cpu()
            partial = {"rows": list(tail.shape),
                       "same_executor": mod._exec is ex,
                       "max_abs_err": float((tail - want[:SERVE_PARTIAL])
                                            .abs().max()),
                       "bitwise": bool(torch.equal(
                           tail, want[:SERVE_PARTIAL]))}
            ffn, _, bad_b = _serve_model(bert, seqs, (BERT_SEQ, BERT_WIDTH),
                                         BERT_MAX_BATCH, SERVE_CLIENTS, (1,))
            # counted from before (a) to (b)'s Module.predict
            launches = ffn.pop("launches")
            resnet.pop("launches")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    # LayerNorm runs once per forward of the block: the warmup's, the
    # served batches', and Module.predict's
    ln_want = sum(r["warmup_binds"] + r["batches"] for r in ffn["runs"]) \
        + -(-BERT_REQUESTS // BERT_MAX_BATCH)
    res = {"phase": "inference_service",
           "config": {"resnet": {"symbol": "example/image-classification/"
                                 "symbols/resnet.py", "num_layers": 50,
                                 "image_shape": list(shape),
                                 "bound_batch": SERVE_MAX_BATCH},
                      "bert_ffn": {"width": BERT_WIDTH, "ff": BERT_FF,
                                   "seq": BERT_SEQ,
                                   "bound_batch": BERT_MAX_BATCH},
                      "dtype": "float32"},
           "resnet": resnet, "bert_ffn": ffn, "partial_final_batch": partial,
           "layer_norm_launches_expected": ln_want, "launches": launches}
    emit(res)
    bad += bad_a + bad_b
    if partial["rows"] != [SERVE_PARTIAL, RESNET_CLASSES] or \
            not partial["same_executor"] or \
            partial["max_abs_err"] > resnet["runs"][0]["vs_predict"][
                "bucket_floor_max_abs"] + 1e-6:
        bad.append(f"Module.predict on a partial final batch: {partial}")
    want_l = {k: 0 for k in launches}
    want_l["layer_norm"] = ln_want
    if launches != want_l:
        bad.append(f"launches {launches}, expected {want_l}")
    if bad:
        raise SystemExit("inference_service phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# inference_int8: int8 quantization served through InferenceService
# ---------------------------------------------------------------------------

def _conv_layers(net, B):
    """ResNet-50's distinct convolutions at batch ``B``: (data shape,
    weight shape, stride, pad)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.symbol.graph import SymbolEntry, topo_order

    convs = [n for n in topo_order(net._entries)
             if n.kind == "op" and n.op.name == "Convolution"]
    probe = mx.sym.Group([mx.sym.Symbol([SymbolEntry(n.inputs[0].node,
                                                     n.inputs[0].index)])
                          for n in convs])
    _, in_shapes, _ = probe.infer_shape(data=(B, 3, RESNET_HW, RESNET_HW))
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(B, 3, RESNET_HW, RESNET_HW))[0]))
    seen = {}
    for n, sh in zip(convs, in_shapes):
        key = (tuple(sh), tuple(shapes[n.name + "_weight"]),
               tuple(n.attrs.get("stride", (1, 1))),
               tuple(n.attrs.get("pad", (0, 0))))
        seen.setdefault(key, n.name)
    return list(seen)


def _int8_op_checks(dev, net):
    """Every ``_contrib_quantized_*`` accumulator on the card against the
    port's CPU op on the same int8 inputs (bitwise), and every
    ``_tpumx_quantized_*`` output within rtol 1e-5, atol 1e-5 x max|CPU|:
    at ResNet-50's convolution shapes (batch INT8_OP_BATCH, with and
    without bias), its classifier and the BERT-width block's two
    FullyConnected layers (rows INT8_OP_BATCH x BERT_SEQ); the exact
    int8 GEMM's device time at each FullyConnected shape beside
    ``torch.matmul``'s in f32 on the f32-widened operands."""
    import torch

    from mxnet_tpu_torch.ops import quantization_ops as qo

    g = torch.Generator().manual_seed(SEED + 40)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8)

    def rng(v):
        return torch.tensor([v], dtype=torch.float32)

    ranges = [rng(v) for v in (-1.3, 1.2, -0.4, 0.5, -0.2, 0.3)]
    act = torch.tensor([0.02])
    cases, bad = [], []
    for (dshape, wshape, stride, pad) in _conv_layers(net, INT8_OP_BATCH):
        d, w = i8(*dshape), i8(*wshape)
        wsc = torch.rand(wshape[0], generator=g) * 0.01 + 1e-3
        kw = dict(kernel=wshape[2:], stride=stride, pad=pad,
                  num_filter=wshape[0])
        cases.append(("quantized_conv", [d, w, *ranges[:4]],
                      dict(kw, no_bias=True), f"conv{list(dshape)}"
                      f"x{list(wshape)}/s{stride[0]}"))
        cases.append(("tpumx_quantized_conv_int8", [d, act, w, wsc],
                      dict(kw, no_bias=True), cases[-1][3]))
    first = _conv_layers(net, INT8_OP_BATCH)[0]
    d, w = i8(*first[0]), i8(*first[1])
    cases.append(("quantized_conv", [d, w, i8(first[1][0]), *ranges],
                  dict(kernel=first[1][2:], stride=first[2], pad=first[3],
                       num_filter=first[1][0]), "conv0+bias"))
    fcs = [((INT8_OP_BATCH, 2048), (RESNET_CLASSES, 2048), "classifier"),
           ((INT8_OP_BATCH * BERT_SEQ, BERT_WIDTH), (BERT_FF, BERT_WIDTH),
            "ffn_1"),
           ((INT8_OP_BATCH * BERT_SEQ, BERT_FF), (BERT_WIDTH, BERT_FF),
            "ffn_2")]
    gemm_ms = {}
    for dshape, wshape, tag in fcs:
        x, w = i8(*dshape), i8(*wshape)
        wsc = torch.rand(wshape[0], generator=g) * 0.01 + 1e-3
        b = torch.randn(wshape[0], generator=g)
        cases.append(("quantized_fully_connected",
                      [x, w, i8(wshape[0]), *ranges],
                      {"num_hidden": wshape[0]}, tag))
        cases.append(("tpumx_quantized_fc_int8", [x, act, w, wsc, b],
                      {"num_hidden": wshape[0]}, tag))
        xd, wd = x.to(dev), w.to(dev)
        xf, wf = xd.float(), wd.float()
        gemm_ms[tag] = {"int8_ms": _event_ms(
            lambda: qo.int8_matmul(xd, wd), 20),
            "f32_matmul_ms": _event_ms(lambda: torch.matmul(xf, wf.t()),
                                       20)}
    worst = {"contrib_mismatches": 0, "tpumx_excess": 0.0}
    for fn, args, kw, tag in cases:
        want = getattr(qo, fn)(*args, **kw)
        got = getattr(qo, fn)(*[a.to(dev) for a in args], **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for i, (a, b) in enumerate(zip(got, want)):
            a = a.cpu()
            if fn.startswith("tpumx"):
                tol = 1e-5 * float(b.abs().max())
                excess = float(((a - b).abs() - tol - 1e-5 * b.abs()).max())
                worst["tpumx_excess"] = max(worst["tpumx_excess"], excess)
                if excess > 0:
                    bad.append(f"{fn} {tag}: {excess} past the tolerance")
            elif a.dtype != b.dtype or not torch.equal(a, b):
                worst["contrib_mismatches"] += 1
                bad.append(f"{fn} {tag} output {i}: not the CPU op's bits")
    return {"cases": len(cases), "conv_shapes": len(_conv_layers(
        net, INT8_OP_BATCH)), **worst, "gemm_ms": gemm_ms}, bad


def _param_bytes(adapter):
    """Bytes of an executor adapter's served parameters (the arguments
    other than its inputs and labels) and of its float graph's."""
    skip = set(adapter.input_names) | {n for n, _ in adapter._label_shapes}

    def nbytes(ex):
        return sum(a._data.numel() * a._data.element_size()
                   for n, a in ex.arg_dict.items() if n not in skip)

    return {"served": nbytes(adapter._base),
            "float": nbytes(adapter._float_base)}


def _serve_int8(mod, samples, shape, max_batch, clients, windows, table):
    """``InferenceService(quantize="int8")`` over ``mod`` with
    ``table``, once for each client window (a fresh service each), as
    :func:`_serve_model` serves the float model: each run's stats, binds
    after warmup and kernel launches (counted from 0 just before the
    service is made, read just after its last request), its outputs (on
    the host), and the served parameter bytes against the float graph's."""
    import torch

    from mxnet_tpu_torch.serving import InferenceService, ServingConfig

    runs, outs, bad = [], [], []
    for window in windows:
        torch.cuda.synchronize()
        _reset_launches()
        svc = InferenceService(mod, ServingConfig(
            max_batch_size=max_batch, batch_timeout_ms=2.0,
            shape_buckets=[tuple(shape)], queue_bound=1024,
            quantize="int8", quantize_calibration=table))
        try:
            t0 = time.perf_counter()
            warmed = svc.warmup()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            binds0 = svc.stats()["compile_cache"]["misses"]
            got, wall, errors = _serve_clients(svc, samples, clients, window)
            torch.cuda.synchronize()
            launches = _read_launches()
            stats = svc.stats()
            ad = svc._adapter
            nbytes = _param_bytes(ad)
            int8_dtype = all(
                a._data.dtype == torch.int8
                for n, a in ad._base.arg_dict.items() if n.endswith("_int8"))
        finally:
            svc.stop()
        outs.append(got)
        runs.append({
            "window": window, "warmup_binds": warmed, "warmup_s": warm_s,
            "binds_after_warmup":
            stats["compile_cache"]["misses"] - binds0,
            "wall_s": wall, "requests_per_s": len(samples) / wall,
            "latency_ms": stats["latency_ms"],
            "batches": stats["batches"],
            "avg_batch_size": stats["avg_batch_size"],
            "batch_occupancy": stats["batch_occupancy"],
            "errors": errors, "launches": launches})
        if errors or any(o is None for o in got):
            bad.append(f"int8 window {window}: requests failed: {errors}")
        if runs[-1]["binds_after_warmup"]:
            bad.append(f"int8 window {window}: "
                       f"{runs[-1]['binds_after_warmup']} binds after warmup")
        if not int8_dtype:
            bad.append(f"int8 window {window}: weights not int8")
    return runs, outs, nbytes, bad


def _int8_error(got, want):
    """The int8 outputs against the float ones: the largest absolute
    error, it over the float outputs' largest magnitude, and the share
    of rows whose argmax agrees."""
    import torch

    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    err = float((got - want).abs().max())
    top = float((got.flatten(1).argmax(1) == want.flatten(1).argmax(1))
                .float().mean())
    return {"max_abs_err": err,
            "rel_err": err / max(float(want.abs().max()), 1e-30),
            "argmax_agree": top}


def _int8_cpu_check(net, shape, data_shape, args, aux, labels, samples,
                    table):
    """The same model bound on the CPU from the same numpy values: its
    f32 ``Module.predict`` and its int8 service's outputs over
    ``samples`` (one batch, the same calibration table)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import InferenceService, ServingConfig

    n = len(samples)
    with mx.cpu():
        mod = mx.mod.Module(net, label_names=["softmax_label"] if labels
                            else None, context=mx.cpu())
        mod.bind(data_shapes=[("data", (n,) + tuple(shape))],
                 label_shapes=[("softmax_label", (n,))] if labels else None,
                 for_training=False)
        mod.init_params(arg_params={k: v for k, v in args.items()
                                    if k not in ("data", "softmax_label")},
                        aux_params=aux)
        f32 = mod.predict(mx.io.NDArrayIter(np.stack(samples),
                                            batch_size=n))._data
        svc = InferenceService(mod, ServingConfig(
            max_batch_size=n, batch_timeout_ms=50.0,
            shape_buckets=[tuple(shape)], quantize="int8",
            quantize_calibration=table))
        try:
            got, _, errors = _serve_clients(svc, samples, 1, n)
        finally:
            svc.stop()
    if errors:
        raise SystemExit(f"inference_int8: the CPU int8 service failed: "
                         f"{errors}")
    return torch.stack(got), f32


def _int8_activations_card_vs_cpu(net, args, aux, table, x):
    """The int8 output of every ``_tpumx_quantize_int8`` node of ``net``'s
    converted graph (``table``, a path) on the samples ``x``, bound once
    on the card and once on the CPU from the same numpy values and int8
    weights: for each node in graph order, its element count, how many
    differ and the largest difference.  The integer GEMMs are exact on
    both, so a node differs only where an upstream f32 pass (BatchNorm,
    the dequantize epilogue) lands the other side of a rounding boundary,
    and what follows carries that flip on."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import quantization as q

    table = q.CalibrationTable.load(table)
    params = {k: v for k, v in args.items()
              if k not in ("data", "softmax_label")}
    qsym = q.convert_symbol(net, table, param_shapes={
        k: tuple(v.shape) for k, v in params.items()})
    inner = qsym.get_internals()
    names = [n for n in inner.list_outputs()
             if n.startswith("quantize_int8_") and n.endswith("_output0")]
    grp = mx.sym.Group([inner[n] for n in names])
    qargs = dict(q.quantize_weights(net, params, table=table), data=x)
    got = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            ex = grp.bind(ctx=ctx, args={
                k: mx.nd.array(v, ctx=ctx, dtype=v.dtype)
                for k, v in qargs.items() if k in grp.list_arguments()},
                args_grad=None, grad_req="null", aux_states={
                    k: mx.nd.array(v, ctx=ctx)
                    for k, v in aux.items()
                    if k in grp.list_auxiliary_states()})
            with torch.no_grad():
                got.append([o._data.cpu()
                            for o in ex.forward(is_train=False)])
    card, cpu = got
    nodes = []
    for n, a, b in zip(names, card, cpu):
        d = (a.int() - b.int()).abs()
        nodes.append({"node": n, "elements": d.numel(),
                      "differ": int((d > 0).sum()), "max_diff": int(d.max())})
    return nodes


def phase_inference_int8(dev):
    """int8 serving on the card: inference_service's ResNet-50 symbol (f32
    weights from the same seeds, bound at B=SERVE_MAX_BATCH) and its
    BERT-width FFN block, calibrated (``quantization.calibrate_module`` on
    seeded samples, the card's activations), the tables saved and loaded
    back, then served through ``InferenceService(ServingConfig(
    quantize="int8", quantize_calibration=path))`` to the same traffic:
    SERVE_REQUESTS images from SERVE_CLIENTS threads at each of
    SERVE_WINDOWS in flight, and BERT_REQUESTS sequences.  The float
    service takes the same traffic in the same process, the two kinds
    served in the order float, int8, int8, float.  Checks: (a) the
    quantized ops at ResNet-50's real layer shapes against the port's CPU
    ops (``_int8_op_checks``); (b) no bind after warmup, the weights int8
    on the card; (c) the int8 outputs against ``Module.predict``'s float
    ones on the same samples, on the first INT8_CPU_IMAGES images
    (INT8_CPU_SEQS sequences) within twice the same model's
    int8-against-f32 error on the CPU (same values, same table), and
    within INT8_CARD_CPU_SHARE of that error of the CPU int8 service's
    outputs; the converted graph's int8 activations on those samples,
    card against CPU, the data's node bit for bit, no element off by more
    than INT8_ACT_MAX_DIFF, at most INT8_ACT_SHARE of them differing; (d) each int8 service's kernel launches, counted from its
    construction to its last request: kernel 5 once a BERT-block forward
    (warm-up buckets and served batches), nothing in ResNet-50.  Reports
    requests/s and p50/p99 latency of every run of each kind and their
    ratio, the parameter bytes int8 against f32, and one B=32 forward's
    device time each way."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import quantization as q

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    tables = os.path.join("build", "chip_smoke_int8")
    os.makedirs(tables, exist_ok=True)
    bad, res = [], {"phase": "inference_int8"}
    try:
        with mx.gpu(0):
            net, _, _ = _fit_loaded_symbol()
            shape = (3, RESNET_HW, RESNET_HW)
            data_shape = (SERVE_MAX_BATCH,) + shape
            args, aux = _random_values(net, data_shape, SEED + 30,
                                       RESNET_CLASSES)
            mod = _inference_module(net, data_shape, SEED + 30, labels=True)
            X, _ = _fit_images(SERVE_REQUESTS // SERVE_MAX_BATCH,
                               SERVE_MAX_BATCH, SEED + 31)
            images = list(X)
            bsym = _bert_block()
            bshape = (BERT_MAX_BATCH, BERT_SEQ, BERT_WIDTH)
            bargs, baux = _random_values(bsym, bshape, SEED + 32,
                                         RESNET_CLASSES)
            bert = _inference_module(bsym, bshape, SEED + 32, labels=False)
            seqs = list(np.random.default_rng(SEED + 33).standard_normal(
                (BERT_REQUESTS, BERT_SEQ, BERT_WIDTH), dtype=np.float32))
            res["op_checks"], bad_ops = _int8_op_checks(dev, net)
            bad += bad_ops
            # calibration on seeded samples apart from the traffic
            Xc = np.random.default_rng(SEED + 34).standard_normal(
                (INT8_CALIB_IMAGES,) + shape, dtype=np.float32)
            Sc = np.random.default_rng(SEED + 35).standard_normal(
                (INT8_CALIB_SEQS, BERT_SEQ, BERT_WIDTH), dtype=np.float32)
            t0 = time.perf_counter()
            table = q.calibrate_module(mod, mx.io.NDArrayIter(
                Xc, batch_size=SERVE_MAX_BATCH))
            torch.cuda.synchronize()
            calib_s = time.perf_counter() - t0
            btable = q.calibrate_module(bert, mx.io.NDArrayIter(
                Sc, batch_size=BERT_MAX_BATCH))
            paths = [table.save(os.path.join(tables, "resnet50.calib.json")),
                     btable.save(os.path.join(tables, "bert_ffn.calib.json"))]
            loaded = [q.CalibrationTable.load(p) for p in paths]
            same = all(a.act_scale(n) == b.act_scale(n)
                       for a, b in zip((table, btable), loaded)
                       for n in a.activations)
            res["calibration"] = {
                "resnet_nodes": len(table.activations),
                "resnet_weights": len(table.weights),
                "bert_nodes": len(btable.activations),
                "resnet_calibrate_s": calib_s, "file_round_trip": same,
                "converted_nodes": q.count_quantized_nodes(
                    q.convert_symbol(net, table))}
            if not same or len(table.activations) != 54:
                bad.append(f"calibration: {res['calibration']}")
            # the float and the int8 service, a fresh one each, served
            # in the order float, int8, int8, float, so that neither kind
            # always runs first in the process; the float runs also give
            # Module.predict's outputs over the traffic
            served = {m: {"float": [], "int8": []}
                      for m in ("resnet", "bert_ffn")}
            outs_r, outs_b = [], []
            for rnd, order in enumerate((("float", "int8"),
                                         ("int8", "float"))):
                for kind in order:
                    if kind == "float":
                        fr, want, bad_f = _serve_model(
                            mod, images, shape, SERVE_MAX_BATCH,
                            SERVE_CLIENTS, SERVE_WINDOWS)
                        fb, bwant, bad_fb = _serve_model(
                            bert, seqs, (BERT_SEQ, BERT_WIDTH),
                            BERT_MAX_BATCH, SERVE_CLIENTS, (1,))
                        bad += bad_f + bad_fb
                        runs_r, runs_b = fr["runs"], fb["runs"]
                    else:
                        runs_r, o_r, bytes_r, bad_r = _serve_int8(
                            mod, images, shape, SERVE_MAX_BATCH,
                            SERVE_CLIENTS, SERVE_WINDOWS, paths[0])
                        runs_b, o_b, bytes_b, bad_b = _serve_int8(
                            bert, seqs, (BERT_SEQ, BERT_WIDTH),
                            BERT_MAX_BATCH, SERVE_CLIENTS, (1,), paths[1])
                        bad += bad_r + bad_b
                        outs_r += o_r
                        outs_b += o_b
                    for m, runs in (("resnet", runs_r), ("bert_ffn", runs_b)):
                        served[m][kind] += [dict(r, round=rnd)
                                            for r in runs]
            # one B=32 forward's device time, float against int8
            from mxnet_tpu_torch.serving import (InferenceService,
                                                 ServingConfig)

            svc = InferenceService(mod, ServingConfig(
                max_batch_size=SERVE_MAX_BATCH, quantize="int8",
                quantize_calibration=paths[0]))
            try:
                qex = svc._adapter._base
                x32 = torch.from_numpy(X[:SERVE_MAX_BATCH]).to(dev)
                with torch.no_grad():
                    fwd_ms = {
                        "float32": _event_ms(lambda: mod._exec.forward(
                            is_train=False, data=x32), 5),
                        "int8": _event_ms(lambda: qex.forward(
                            is_train=False, data=x32), 5)}
            finally:
                svc.stop()
            acts = {
                "resnet": _int8_activations_card_vs_cpu(
                    net, args, aux, paths[0],
                    np.stack(images[:INT8_CPU_IMAGES])),
                "bert_ffn": _int8_activations_card_vs_cpu(
                    bsym, bargs, baux, paths[1],
                    np.stack(seqs[:INT8_CPU_SEQS]))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    # (c) the card's int8 error against the CPU's on the same samples
    cpu_r, f32_r = _int8_cpu_check(net, shape, data_shape, args, aux, True,
                                   images[:INT8_CPU_IMAGES], paths[0])
    cpu_b, f32_b = _int8_cpu_check(bsym, (BERT_SEQ, BERT_WIDTH), bshape,
                                   bargs, baux, False,
                                   seqs[:INT8_CPU_SEQS], paths[1])
    errors = {}
    for tag, outs, ref, n, cpu, f32 in (
            ("resnet", outs_r, want, INT8_CPU_IMAGES, cpu_r, f32_r),
            ("bert_ffn", outs_b, bwant, INT8_CPU_SEQS, cpu_b, f32_b)):
        card_all = [_int8_error(torch.stack(o), ref) for o in outs]
        card_n = [_int8_error(torch.stack(o[:n]), ref[:n]) for o in outs]
        cpu_err = _int8_error(cpu, f32)
        # the card's int8 outputs against the CPU int8 service's on the
        # same samples, values and table: both routes' GEMMs are exact, so
        # only a rounding flip at a quantize boundary parts them
        vs_cpu = [float((torch.stack(o[:n]).float() - cpu.float())
                        .abs().max()) for o in outs]
        limit = INT8_CARD_CPU_SHARE[tag] * cpu_err["max_abs_err"]
        nodes = acts[tag]
        differ = sum(a["differ"] for a in nodes) \
            / sum(a["elements"] for a in nodes)
        errors[tag] = {"card_all": card_all, "card_first": card_n,
                       "cpu_first": cpu_err, "samples": n,
                       "card_vs_cpu_int8": vs_cpu,
                       "card_vs_cpu_int8_limit": limit,
                       "int8_activations": {
                           "nodes": len(nodes), "share_differing": differ,
                           "max_diff": max(a["max_diff"] for a in nodes),
                           "first_differing": next(
                               (a for a in nodes if a["differ"]), None),
                           "by_node": nodes}}
        for e in card_n:
            if not 0 < e["max_abs_err"] <= 2 * cpu_err["max_abs_err"]:
                bad.append(f"{tag}: the card's int8 error {e} against "
                           f"twice the CPU's {cpu_err}")
        if max(vs_cpu) > limit:
            bad.append(f"{tag}: the card's int8 outputs {vs_cpu} from the "
                       f"CPU int8 service's, past {limit}")
        act = errors[tag]["int8_activations"]
        if nodes[0]["differ"] or act["max_diff"] > INT8_ACT_MAX_DIFF \
                or differ > INT8_ACT_SHARE:
            bad.append(f"{tag}: int8 activations card against CPU: the "
                       f"data's node {nodes[0]}, largest difference "
                       f"{act['max_diff']} (limit {INT8_ACT_MAX_DIFF}), "
                       f"share {differ} (limit {INT8_ACT_SHARE})")
    # kernel 5 in each int8 service: once a BERT-block forward (warm-up
    # buckets and served batches), never in ResNet-50
    launches = {}
    for m in ("resnet", "bert_ffn"):
        for r in served[m]["int8"]:
            want_l = {k: 0 for k in r["launches"]}
            if m == "bert_ffn":
                want_l["layer_norm"] = r["warmup_binds"] + r["batches"]
            if r["launches"] != want_l:
                bad.append(f"{m} int8 round {r['round']} window "
                           f"{r['window']}: launches {r['launches']}, "
                           f"expected {want_l}")
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    ln_want = sum(r["warmup_binds"] + r["batches"]
                  for r in served["bert_ffn"]["int8"])

    def brief(runs):
        return [{k: r[k] for k in ("round", "window", "requests_per_s",
                                   "latency_ms", "avg_batch_size",
                                   "batch_occupancy")}
                for r in runs]

    # int8 over float requests/s, each round and window on its own
    ratio = {m: [{"round": i["round"], "window": i["window"],
                  "int8_over_float": i["requests_per_s"]
                  / f["requests_per_s"]}
                 for i, f in zip(served[m]["int8"], served[m]["float"])]
             for m in served}

    res.update({
        "config": {"resnet": {"symbol": "example/image-classification/"
                              "symbols/resnet.py", "num_layers": 50,
                              "bound_batch": SERVE_MAX_BATCH},
                   "bert_ffn": {"width": BERT_WIDTH, "ff": BERT_FF,
                                "seq": BERT_SEQ,
                                "bound_batch": BERT_MAX_BATCH},
                   "quantize": "int8", "calibration": "naive absmax"},
        "resnet": {"int8": served["resnet"]["int8"],
                   "float": brief(served["resnet"]["float"]),
                   "requests_per_s_ratio": ratio["resnet"],
                   "parameter_bytes": bytes_r},
        "bert_ffn": {"int8": served["bert_ffn"]["int8"],
                     "float": brief(served["bert_ffn"]["float"]),
                     "requests_per_s_ratio": ratio["bert_ffn"],
                     "parameter_bytes": bytes_b},
        "forward_ms_b32": fwd_ms, "errors": errors,
        "layer_norm_launches_expected": ln_want, "launches": launches})
    emit(res)
    if bad:
        raise SystemExit("inference_int8 phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# optimizers: the nine optimizers of this slice through Module.fit
# ---------------------------------------------------------------------------

def _opt_mlp():
    """The MLP: tanh, not ReLU.  FTML, Adamax and Nadam move a weight by
    about ``lr * g / (|g| + eps)``, near ``lr * sign(g)``: where a ReLU's
    input sits at 0 the card's and the CPU's f32 sums put it on either
    side, one side's gradient is 0, and that weight then differs by a
    whole step (on an H100 80GB HBM3 at 700 W, a 784-256-128-10 ReLU MLP
    left FTML 0.0286 off the CPU after six steps, about three times its
    lr).  A smooth activation leaves the f32 sum order's own noise."""
    import mxnet_tpu_torch as mx

    with mx.name.NameManager():
        h = mx.sym.Variable("data")
        for i, w in enumerate(OPT_WIDTHS[1:]):
            h = mx.sym.FullyConnected(h, num_hidden=w, name=f"fc{i}")
            if i < len(OPT_WIDTHS) - 2:
                h = mx.sym.Activation(h, act_type="tanh")
        return mx.sym.SoftmaxOutput(h, name="softmax")


def _opt_fit(ctx, name, X, Y, init):
    """``Module.fit`` of the MLP for one epoch on ``ctx`` with the
    optimizer ``name``: the final parameters (numpy) and the fit's wall
    seconds."""
    import torch

    import mxnet_tpu_torch as mx

    mx.random.seed(SEED)
    with ctx:
        mod = mx.mod.Module(_opt_mlp(), context=ctx)
        it = mx.io.NDArrayIter(X, Y, batch_size=OPT_BATCH)
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer=name,
                optimizer_params=dict(OPT_SETTINGS[name]),
                arg_params={k: mx.nd.array(v) for k, v in init.items()},
                initializer=mx.init.Zero(), eval_metric="acc")
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
            wall, type(mod._optimizer).__name__


def phase_optimizers(dev):
    """The nine optimizers this slice ports (FTML, LBSGD, DCASGD, SGLD,
    AdaDelta, Ftrl, Adamax, Nadam, Test): OPT_BATCHES ``Module.fit``
    steps of an MLP (OPT_WIDTHS, batch OPT_BATCH, f32, TF32 off) on the
    card and on the CPU from the same parameters, data and random seed
    (SGLD's noise); the final parameters held at rtol OPT_RTOL, atol
    OPT_ATOL, and every parameter moved."""
    import torch

    import mxnet_tpu_torch as mx

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    rs = np.random.default_rng(SEED + 50)
    n = OPT_BATCH * OPT_BATCHES
    X = rs.standard_normal((n, OPT_WIDTHS[0]), dtype=np.float32)
    Y = rs.integers(0, OPT_WIDTHS[-1], n).astype(np.float32)
    shapes = dict(zip(_opt_mlp().list_arguments(), _opt_mlp().infer_shape(
        data=(OPT_BATCH, OPT_WIDTHS[0]))[0]))
    init = {k: (rs.standard_normal(s) / np.sqrt(s[-1] if len(s) > 1
                                                 else 1) * 0.5)
            .astype(np.float32) for k, s in shapes.items()
            if k not in ("data", "softmax_label")}
    _reset_launches()
    rows, bad = {}, []
    for name in OPT_SETTINGS:
        card, wall, cls = _opt_fit(mx.gpu(0), name, X, Y, init)
        cpu, _, _ = _opt_fit(mx.cpu(), name, X, Y, init)
        excess = max(float((np.abs(card[k] - cpu[k])
                            - OPT_ATOL - OPT_RTOL * np.abs(cpu[k])).max())
                     for k in cpu)
        err = max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu)
        moved = min(float(np.abs(card[k] - init[k]).max()) for k in init)
        rows[name] = {"class": cls, "max_abs_err": err,
                      "excess_over_tol": excess, "min_moved": moved,
                      "card_fit_s": wall}
        if excess > 0 or moved == 0:
            bad.append(f"{name}: {rows[name]}")
    launches = _read_launches()
    res = {"phase": "optimizers", "mlp": list(OPT_WIDTHS),
           "batch": OPT_BATCH, "steps": OPT_BATCHES, "rtol": OPT_RTOL,
           "atol": OPT_ATOL, "optimizers": rows, "launches": launches}
    emit(res)
    if any(launches.values()):
        bad.append(f"launches {launches}, expected none")
    if bad:
        raise SystemExit("optimizers phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# custom_op: user ops in Python (mx.operator)
# ---------------------------------------------------------------------------

def _custom_fit(ctx, X, Y, W0):
    """``Module.fit`` through FullyConnected -> the example's numpy
    softmax as a symbolic ``Custom`` node -> a log loss: the weight."""
    import mxnet_tpu_torch as mx

    with ctx, mx.name.NameManager():
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        fc = mx.sym.FullyConnected(data, num_hidden=10, no_bias=True,
                                   name="fc")
        p = mx.sym.Custom(fc, op_type="numpy_softmax", name="sm")
        net = mx.sym.MakeLoss(-mx.sym.sum(mx.sym.log(
            mx.sym.pick(p, label, axis=1) + 1e-6)))
        mod = mx.mod.Module(net, data_names=["data"],
                            label_names=["softmax_label"], context=ctx)
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=CUSTOM_BATCH),
                num_epoch=1, optimizer="sgd", eval_metric="loss",
                optimizer_params={"learning_rate": 0.01},
                arg_params={"fc_weight": mx.nd.array(W0)},
                initializer=mx.init.Zero())
        return mod.get_params()[0]["fc_weight"].asnumpy()


def phase_custom_op(dev):
    """``example/numpy-ops/custom_softmax.py``'s op (exec'd against the
    port) on the card: (a) its forward against ``nd.softmax`` and its
    gradient against autograd through ``nd.softmax`` (rtol 1e-5, atol
    1e-6), outputs on the card; (b) ``Module.fit`` through a symbolic
    ``Custom`` node, CUSTOM_BATCHES steps, on the card against the same
    fit on the CPU (rtol 1e-5, atol 1e-6); (c) a hybridized block whose
    forward runs the op: the program stays uncaptured on the card
    (``cached_op.UNCAPTURED``), its outputs the eager block's."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import cached_op, nn

    ns = _example_ns(os.path.join("example", "numpy-ops",
                                  "custom_softmax.py"))
    rs = np.random.default_rng(SEED + 60)
    bad = []
    _reset_launches()
    with mx.gpu(0):
        x = mx.nd.array(rs.standard_normal((CUSTOM_BATCH, 10),
                                           dtype=np.float32))
        g = mx.nd.array(rs.standard_normal((CUSTOM_BATCH, 10),
                                           dtype=np.float32))
        out = mx.nd.Custom(x, op_type="numpy_softmax")
        ref = mx.nd.softmax(x, axis=1)
        grads = []
        for fn in (lambda v: mx.nd.Custom(v, op_type="numpy_softmax"),
                   lambda v: mx.nd.softmax(v, axis=1)):
            v = x.copy()
            v.attach_grad()
            with mx.autograd.record():
                y = fn(v)
            y.backward(g)
            grads.append(v.grad._data.detach().clone().cpu())
        ns["main"](type("Args", (), {"batch_size": 32})())
        fwd_err = float((out._data - ref._data).abs().max())
        grad_err = float((grads[0] - grads[1]).abs().max())
        on_card = out._data.device.type == "cuda" and \
            grads[0].shape == (CUSTOM_BATCH, 10)

        class Net(mx.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.dense = nn.Dense(10, in_units=10)

            def hybrid_forward(self, F, v):
                return F.Custom(self.dense(v), op_type="numpy_softmax")

        blk = Net()
        blk.initialize(ctx=mx.gpu(0))
        eager = blk(x)._data.cpu()
        blk.hybridize()
        before = dict(cached_op.UNCAPTURED)
        hyb = [blk(x)._data.cpu() for _ in range(3)]
        unc = {k: cached_op.UNCAPTURED[k] - before[k] for k in before}
    hyb_err = max(float((h - eager).abs().max()) for h in hyb)
    X = rs.standard_normal((CUSTOM_BATCH * CUSTOM_BATCHES, 784),
                           dtype=np.float32)
    Y = rs.integers(0, 10, len(X)).astype(np.float32)
    W0 = (rs.standard_normal((10, 784)) * 0.01).astype(np.float32)
    card = _custom_fit(mx.gpu(0), X, Y, W0)
    cpu = _custom_fit(mx.cpu(), X, Y, W0)
    fit_excess = float((np.abs(card - cpu) - 1e-6 - 1e-5 * np.abs(cpu))
                       .max())
    launches = _read_launches()
    res = {"phase": "custom_op", "forward_max_abs_err": fwd_err,
           "grad_max_abs_err": grad_err, "on_card": on_card,
           "fit": {"steps": CUSTOM_BATCHES, "batch": CUSTOM_BATCH,
                   "max_abs_err": float(np.abs(card - cpu).max()),
                   "excess_over_tol": fit_excess,
                   "moved": float(np.abs(card - W0).max())},
           "hybridized": {"uncaptured": unc, "max_abs_err": hyb_err},
           "launches": launches}
    emit(res)
    if fwd_err > 1e-5 or grad_err > 1e-5 or not on_card:
        bad.append(f"eager op: forward {fwd_err}, gradient {grad_err}, "
                   f"on the card {on_card}")
    if fit_excess > 0 or res["fit"]["moved"] == 0:
        bad.append(f"Module.fit through Custom: {res['fit']}")
    if unc != {"programs": 1, "calls": 3} or hyb_err > 1e-6:
        bad.append(f"hybridized Custom: {res['hybridized']}")
    if any(launches.values()):
        bad.append(f"launches {launches}, expected none")
    if bad:
        raise SystemExit("custom_op phase failed: " + "; ".join(bad))
    return res


# ---------------------------------------------------------------------------
# amp: automatic mixed precision (Gluon amp.init, Module under TPUMX_AMP)
# ---------------------------------------------------------------------------

_AMP_ENV = ("TPUMX_AMP", "TPUMX_AMP_DTYPE", "TPUMX_AMP_LOSS_SCALE")


def _amp_env(dtype=None):
    """A context setting ``TPUMX_AMP*`` for ``dtype`` (fp16 with dynamic
    loss scaling; None: AMP off), restoring the variables after."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        old = {k: os.environ.get(k) for k in _AMP_ENV}
        for k in _AMP_ENV:
            os.environ.pop(k, None)
        if dtype is not None:
            os.environ.update(TPUMX_AMP="1", TPUMX_AMP_DTYPE=dtype)
            if dtype == "float16":
                os.environ["TPUMX_AMP_LOSS_SCALE"] = "dynamic"
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return scope()


def _amp_gluon_net(mx, ctx, classes, depth, hw, init_from=None):
    """``resnet<depth>_v1(layout="NHWC")`` on ``ctx``, its deferred shapes
    resolved by one paused forward, its values ``init_from`` (numpy, by
    creation order) when given; then ``amp.init(net, "bfloat16")``."""
    import torch

    from mxnet_tpu_torch import amp, autograd, gluon

    torch.manual_seed(SEED + 30)
    net = getattr(gluon.model_zoo.vision, f"resnet{depth}_v1")(
        classes=classes, layout="NHWC")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with autograd.pause():
        net(mx.nd.zeros((2, hw, hw, 3), ctx=ctx))
    if init_from is not None:
        for p, v in zip(net.collect_params().values(), init_from):
            p.set_data(mx.nd.array(v, ctx=ctx))
    return amp.init(net, "bfloat16")


def _amp_trainer(mx, net):
    from mxnet_tpu_torch import gluon

    return gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": RESNET_LR,
                          "momentum": RESNET_MOMENTUM, "wd": 1e-4,
                          "multi_precision": True})


def _amp_step(mx, net, trainer, loss_fn, x, y):
    """One Gluon step of a converted net, the loss taken in f32 (as the
    reference's AMP tests do); returns the loss NDArray."""
    from mxnet_tpu_torch import autograd

    with autograd.record():
        L = loss_fn(net(x).astype("float32"), y)
    L.backward()
    trainer.step(x.shape[0])
    return L


def _amp_dtypes(net):
    """Each parameter's dtype by block kind: the Conv2D/Dense weights and
    biases (bf16 under amp.init), BatchNorm's (f32)."""
    from mxnet_tpu_torch.base import dtype_name

    kinds = {}
    for name, p in net.collect_params().items():
        kind = "batchnorm" if "batchnorm" in name else "conv_dense"
        kinds.setdefault(kind, set()).add(dtype_name(p.data()._data.dtype))
    return {k: sorted(v) for k, v in kinds.items()}


def _amp_gluon_loop(dev):
    """(a) Gluon ResNet-50 v1 channels-last at 224x224x3, B = 128, under
    ``amp.init(net, "bfloat16")`` with ``Trainer(sgd, multi_precision=
    True)``: AMP_GLUON_STEPS steps, steps 2 and 3 on the first batch again
    (each update must lower its loss); launches by wrapper each step and
    by kernel name in one profiled step (53 + 53, f32 instantiations:
    BatchNorm is on AMP's f32 list); parameter dtypes; images/s, step ms
    and peak memory."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    ctx = mx.gpu(0)
    B = RESNET_BATCH
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    n = AMP_GLUON_STEPS - 2
    X = torch.randn((n * B, RESNET_HW, RESNET_HW, 3), generator=g,
                    device=dev)
    Y = torch.randint(0, RESNET_CLASSES, (n * B,), generator=g, device=dev)
    net = _amp_gluon_net(mx, ctx, RESNET_CLASSES, 50, RESNET_HW)
    dtypes = _amp_dtypes(net)
    trainer = _amp_trainer(mx, net)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for step in range(AMP_GLUON_STEPS):
        i = 0 if step < 3 else step - 2
        x = mx.nd.NDArray(X[i * B:(i + 1) * B])
        y = mx.nd.NDArray(Y[i * B:(i + 1) * B])
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        L = _amp_step(mx, net, trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(_read_launches())
        losses.append(L.mean().asscalar().item())
    peak = torch.cuda.max_memory_allocated()
    prof = _profiled(lambda: _amp_step(mx, net, trainer, loss_fn, x, y),
                     families=("bn_stats_partial", "bn_normalize"))
    masters = [s for s in trainer._updaters[0].states.values()
               if isinstance(s, tuple)]
    steady = float(np.median(step_ms[1:]))
    launches = {k: sum(p[k] for p in per_step) for k in per_step[0]}
    names = prof["family_names"]
    res = {"B": B, "steps": AMP_GLUON_STEPS, "losses": losses,
           "step_ms": step_ms, "steady_step_ms": steady,
           "images_per_s": B / (steady / 1e3), "peak_bytes": peak,
           "param_dtypes": dtypes, "f32_masters": len(masters),
           "profiled_step": {k: prof[k] for k in (
               "wall_s", "kernels", "device_busy_s", "idle_share", "top",
               "port_kernels_ms")},
           "bn_launches_by_name": {"stats": prof["families"][
               "bn_stats_partial"], "normalize": prof["families"][
               "bn_normalize"]},
           "bn_kernel_names": names,
           "profiler_lost_records": prof["lost_records"],
           "launches_per_step": per_step[0], "launches": launches}
    bad = []
    want = {k: 0 for k in per_step[0]}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    off = [p for p in per_step if p != want]
    if off:
        bad.append(f"(a) {len(off)} AMP steps launched other counts than "
                   f"{want}, the first {off[0]}")
    if res["bn_launches_by_name"] != {"stats": RESNET_BNS,
                                      "normalize": RESNET_BNS}:
        bad.append(f"(a) BatchNorm kernels by name: "
                   f"{res['bn_launches_by_name']}")
    wrong = [n for ns in names.values() for n in ns
             if "<float," not in n.replace(" ", "")]
    if wrong or not all(names.values()):
        bad.append(f"(a) BatchNorm kernel functions not the f32 "
                   f"instantiation: {names}")
    if dtypes != {"batchnorm": ["float32"], "conv_dense": ["bfloat16"]}:
        bad.append(f"(a) parameter dtypes {dtypes}")
    if not masters:
        bad.append("(a) no f32 master weights in the Trainer's states")
    if not all(np.isfinite(losses)):
        bad.append(f"(a) non-finite loss: {losses}")
    if not losses[2] < losses[1] < losses[0]:
        bad.append(f"(a) the first two updates did not each lower the "
                   f"first batch's loss: {losses[:3]}")
    return res, bad


def _amp_gluon_card_vs_cpu(dev):
    """(a) at a small depth: resnet18_v1 channels-last under
    ``amp.init(net, "bfloat16")`` from the same values on the card and
    on the CPU, one ``multi_precision`` Trainer step: the f32 loss within
    AMP_RTOL, and every parameter after the update within the
    reference's low-precision tolerance (``tests/test_amp.py``: rtol
    AMP_RTOL, atol AMP_RTOL x the tensor's largest magnitude) or, where
    the card moves by more than that against itself, within 3 x that
    floor.  The floor is the card's step with the images moved by one
    bf16 step (2^-8, relative): one update from a random init at B = 8
    carries bf16 noise of several tolerances in the BatchNorm shifts
    (the CPU measures the same against its own f32 step)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    B, hw, classes = AMP_CHECK
    rs = np.random.default_rng(SEED + 32)
    X = rs.standard_normal((B, hw, hw, 3), dtype=np.float32)
    Y = rs.integers(0, classes, B).astype(np.float32)
    u = np.random.default_rng(SEED + 34).uniform(-1, 1, X.shape)
    moved = (X * (1 + 2.0 ** -8 * u)).astype(np.float32)
    base, names, got = None, None, {}
    for tag, ctx, image in (("cpu", mx.cpu(), X), ("card", mx.gpu(0), X),
                            ("card_moved", mx.gpu(0), moved)):
        with ctx:
            # the card's nets take the CPU net's converted values
            net = _amp_gluon_net(mx, ctx, classes, 18, hw, base)
            if base is None:
                names = list(net.collect_params())
                base = [p.data().astype("float32").asnumpy()
                        for p in net.collect_params().values()]
            trainer = _amp_trainer(mx, net)
            L = _amp_step(mx, net, trainer, gluon.loss.
                          SoftmaxCrossEntropyLoss(),
                          mx.nd.array(image, ctx=ctx),
                          mx.nd.array(Y, ctx=ctx))
            got[tag] = [L.mean().asscalar().item()] + [
                p.data().astype("float32").asnumpy()
                for p in net.collect_params().values()]
            del net, trainer

    def over(a, b):
        """|a - b| in units of the tolerance at b, the largest."""
        lim = AMP_RTOL * np.abs(b) + AMP_RTOL * max(float(np.abs(b).max()),
                                                    1e-3)
        return float((np.abs(a - b) / lim).max())

    errs = {n: over(a, b) for n, a, b in zip(names, got["card"][1:],
                                              got["cpu"][1:])}
    floors = {n: over(a, b) for n, a, b in zip(
        names, got["card_moved"][1:], got["card"][1:])}
    failing = {n: {"err": errs[n], "floor": floors[n]} for n in names
               if errs[n] > max(1.0, 3 * floors[n])}
    worst = max(errs, key=errs.get)
    loss_err = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    res = {"model": "resnet18_v1", "B": B, "hw": hw, "classes": classes,
           "rtol": AMP_RTOL, "loss_card": got["card"][0],
           "loss_cpu": got["cpu"][0], "loss_rel_err": loss_err,
           "params": len(errs), "worst": worst,
           "worst_err_in_tolerances": errs[worst],
           "floor_of_worst": floors[worst],
           "over_tolerance_not_floor": sorted(
               n for n in names if errs[n] > 1.0),
           "failing": failing,
           "tolerance": "each: max(1, 3 x floor) tolerances"}
    bad = []
    if loss_err > AMP_RTOL or failing:
        bad.append(f"(a) amp card vs CPU: loss {loss_err:.3g}, beyond "
                   f"max(1, 3 x floor) tolerances: {failing}")
    return res, bad


def _amp_fit(net, dtype, f32_fit):
    """(b) ``Module.fit`` over module_fit's ResNet-50 symbol (NCHW) under
    ``TPUMX_AMP=1`` in ``dtype`` (fp16 with dynamic loss scaling):
    AMP_FIT_BATCHES batches at B = 128 through the fused step, the
    converted graph bound, ``do_checkpoint``'s symbol and
    ``save_checkpoint`` of the bound (converted) graph both without
    ``amp_cast``; images/s beside module_fit's f32 figure."""
    import tempfile

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp

    B = RESNET_BATCH
    X, Y = _fit_images(AMP_FIT_BATCHES, B, SEED)
    marks, losses, scales = [], [], []
    with _amp_env(dtype), tempfile.TemporaryDirectory() as tmp:
        mod = mx.mod.Module(net, label_names=["softmax_label"])

        def timing(param):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            losses.append(_ce(param.locals["self"].get_outputs()[0],
                              param.locals["data_batch"].label[0]))
            sc = param.locals["self"]._loss_scaler
            if sc is not None:
                scales.append([sc.scale_value, sc.good_steps])

        torch.manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="tpu_sync", optimizer="sgd",
                optimizer_params=_fit_optimizer_params(),
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                batch_end_callback=timing,
                epoch_end_callback=mx.callback.do_checkpoint(
                    f"{tmp}/amp"))
        launches = _read_launches()
        fused = mod._fused_step_count
        peak = torch.cuda.max_memory_allocated()
        # one more fused step on the last batch, profiled: where it goes
        batch = mx.io.DataBatch(data=[mx.nd.array(X[-B:])],
                                label=[mx.nd.array(Y[-B:])])
        prof = _profiled(lambda: mod._try_fused_step(batch))
        arg, aux = mod.get_params()
        mx.model.save_checkpoint(f"{tmp}/bound", 1, mod._exec._symbol, arg,
                                 aux)
        files = {k: amp.count_amp_casts(mx.sym.load(
            f"{tmp}/{k}-symbol.json")) for k in ("amp", "bound")}
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
    steady = float(np.median(step_ms[1:]))
    f32_ips = (f32_fit or {}).get("fit", {}).get("images_per_s")
    res = {"dtype": dtype, "B": B, "batches": AMP_FIT_BATCHES,
           "loss_scale": "dynamic" if dtype == "float16" else None,
           "bound_amp_casts": amp.count_amp_casts(mod._exec._symbol),
           "checkpoint_amp_casts": files,
           "fused_steps": fused, "losses": losses,
           "scaler_trail": scales, "step_ms": step_ms,
           "steady_step_ms": steady, "images_per_s": B / (steady / 1e3),
           "f32_module_fit_images_per_s": f32_ips,
           "speedup_over_f32": (B / (steady / 1e3)) / f32_ips
           if f32_ips else None,
           "peak_bytes": peak,
           "profiled_step": {k: prof[k] for k in (
               "wall_s", "kernels", "device_busy_s", "idle_share", "top",
               "backward_nodes_ms")},
           "launches": launches}
    bad = []
    if res["fused_steps"] != AMP_FIT_BATCHES:
        bad.append(f"(b) {dtype}: fit took the fused step "
                   f"{res['fused_steps']} times in {AMP_FIT_BATCHES} "
                   f"batches")
    if not res["bound_amp_casts"] or any(files.values()):
        bad.append(f"(b) {dtype}: bound graph casts "
                   f"{res['bound_amp_casts']}, checkpoint casts {files}")
    if not all(np.isfinite(losses)):
        bad.append(f"(b) {dtype}: non-finite loss {losses}")
    if dtype == "bfloat16" and not losses[2] < losses[1] < losses[0]:
        bad.append(f"(b) bf16: the first two updates did not each lower "
                   f"the first batch's loss: {losses[:3]}")
    if dtype == "float16" and len(scales) != AMP_FIT_BATCHES:
        bad.append(f"(b) fp16: no loss scaler trail {scales}")
    if any(launches.values()):
        bad.append(f"(b) {dtype}: the channels-first net launched port "
                   f"kernels {launches}")
    return res, bad


def _amp_cifar_scaler(dev):
    """(b) at the cifar depth (ResNet-20, 32x32, B = CIFAR_BATCH): fp16
    ``Module.fit`` with dynamic loss scaling on the card and on the CPU
    over the same batches from the same values; the scaler's ``(scale,
    good_steps)`` after every step must be equal.  Each step's largest
    gradient magnitude (infinite on a skipped step) is kept beside it."""
    import mxnet_tpu_torch as mx

    net = _example_resnet_symbol(10, 20, "3,32,32")
    shape = (CIFAR_BATCH, 3, 32, 32)
    args, aux = _random_values(net, shape, SEED + 6, 10)
    params = {k: v for k, v in args.items()
              if k not in ("data", "softmax_label")}
    X, Y = _fit_images(AMP_CIFAR_BATCHES, CIFAR_BATCH, SEED + 33,
                       image=shape[1:], classes=10)
    trails = {}
    with _amp_env("float16"):
        for tag, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            with ctx:
                mod = mx.mod.Module(net, context=ctx)
                trail = []

                def keep(param, mod=mod, trail=trail):
                    ex = mod._exec
                    sc = mod._loss_scaler
                    trail.append([sc.scale_value, sc.good_steps, max(
                        float(ex.grad_dict[n]._data.abs().max())
                        for n in ex._grad_arg_names)])

                mod.fit(mx.io.NDArrayIter(X, Y, batch_size=CIFAR_BATCH),
                        num_epoch=1, kvstore="local", optimizer="sgd",
                        optimizer_params={"learning_rate": FIT_LR,
                                          "momentum": FIT_MOMENTUM},
                        arg_params=params, aux_params=aux,
                        batch_end_callback=keep)
                trails[tag] = {"trail": trail,
                               "fused_steps": mod._fused_step_count}
    card, cpu = trails["card"]["trail"], trails["cpu"]["trail"]
    differ = [i for i, (a, b) in enumerate(zip(card, cpu))
              if a[:2] != b[:2]]
    res = {"B": CIFAR_BATCH, "batches": AMP_CIFAR_BATCHES, "card": card,
           "cpu": cpu, "first_difference": differ[0] if differ else None}
    bad = []
    if differ or len(card) != len(cpu) != AMP_CIFAR_BATCHES:
        i = differ[0] if differ else None
        bad.append(f"(b) fp16 scaler card vs CPU differ at step {i}: card "
                   f"{card[i] if differ else card} (scale, good steps, "
                   f"largest gradient), CPU {cpu[i] if differ else cpu}")
    if not any(np.isinf(c[2]) for c in card) or np.isinf(card[-1][2]):
        bad.append(f"(b) fp16 scaler trail without a backed-off overflow "
                   f"and a clean step after it: {card}")
    return res, bad


def phase_amp(dev, runs):
    """Mixed precision through the port's own ``amp`` (``convert_symbol``
    under ``TPUMX_AMP``, the loss-scaled fused step, Gluon ``amp.init``
    with f32 master weights), cuDNN deterministic.  (a) Gluon ResNet-50
    v1 channels-last in bf16 (``_amp_gluon_loop``: BatchNorm's two kernels
    at their f32 instantiation, 53 + 53 a step) and its card-vs-CPU check
    at a small depth; (b) ``Module.fit`` over module_fit's ResNet-50
    symbol in bf16 and in fp16 with dynamic scaling, and the fp16
    scaler's trajectory at the cifar depth, card against CPU.  Each
    images/s stands beside the f32 phase's (``gluon_training``,
    ``module_fit``) when that ran in the same process."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        loop, bad = _amp_gluon_loop(dev)
        gc.collect()
        torch.cuda.empty_cache()
        check, bad_check = _amp_gluon_card_vs_cpu(dev)
        net, _, _ = _fit_loaded_symbol()
        fits, bad_fits = {}, []
        for dtype in ("bfloat16", "float16"):
            fits[dtype], b = _amp_fit(net, dtype, runs.get("module_fit"))
            bad_fits += b
            gc.collect()
        cifar, bad_cifar = _amp_cifar_scaler(dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    f32 = (runs.get("gluon_training") or {}).get("loop") or {}
    loop["f32_gluon_training"] = {k: f32.get(k) for k in (
        "images_per_s", "steady_step_ms", "peak_bytes")} if f32 else None
    launches = {k: loop["launches"][k] + sum(f["launches"][k]
                                             for f in fits.values())
                for k in loop["launches"]}
    res = {"phase": "amp",
           "config": {"gluon": {"model": "resnet50_v1", "layout": "NHWC",
                                "image": [RESNET_HW, RESNET_HW, 3],
                                "amp": "amp.init(net, 'bfloat16')",
                                "optimizer": "sgd", "multi_precision": True,
                                "lr": RESNET_LR, "momentum": RESNET_MOMENTUM},
                      "module": {"symbol": "example/image-classification/"
                                 "symbols/resnet.py", "num_layers": 50,
                                 "env": "TPUMX_AMP=1, TPUMX_AMP_DTYPE",
                                 "kvstore": "tpu_sync"}},
           "gluon": loop, "gluon_card_vs_cpu": check, "fit": fits,
           "cifar_fp16_scaler": cifar, "launches": launches}
    emit(res)
    bad += bad_check + bad_fits + bad_cifar
    if bad:
        raise SystemExit("amp phase failed: " + "; ".join(bad))
    return res


# -- phase 13: gluon_hybrid -----------------------------------------------------------------

def _gh_check_net(mx, layout="NHWC"):
    """The capture check net: conv-BN-relu units, a concat fan-out with
    asymmetric 1x7/7x1 kernels and a padded ``AvgPool2D(3, 1, 1)``
    branch, ``MaxPool2D``, ``Dropout(0.3)``, ``Dense(10)``."""
    nn = mx.gluon.nn
    ax = -1 if layout == "NHWC" else 1

    def unit(ch, k, p=0):
        u = nn.HybridSequential(prefix="")
        u.add(nn.Conv2D(ch, k, 1, p, use_bias=False, layout=layout),
              nn.BatchNorm(axis=ax, epsilon=1e-3), nn.Activation("relu"))
        return u

    net = nn.HybridSequential(prefix="check_")
    with net.name_scope():
        net.add(unit(32, 3, 1))
        cat = nn.HybridConcatenate(axis=ax)
        b2 = nn.HybridSequential(prefix="")
        b2.add(unit(32, 1), unit(32, (1, 7), (0, 3)),
               unit(48, (7, 1), (3, 0)))
        b3 = nn.HybridSequential(prefix="")
        b3.add(nn.AvgPool2D(3, 1, 1, layout=layout), unit(32, 1))
        cat.add(unit(64, 1), b2, b3)
        net.add(cat, nn.MaxPool2D(2, 2, layout=layout), nn.Dropout(0.3),
                nn.Flatten(), nn.Dense(10))
    return net


def _gh_state(net):
    """Every parameter, gradient and running statistic, cloned."""
    out = {}
    for name, p in net.collect_params().items():
        out[name] = p._tensor().detach().clone()
        if p.grad_req != "null":
            out[name + ".grad"] = p.grad()._data.detach().clone()
    return out


def _gh_capture_exact(dev):
    """Check (a): from one stream state, the captured program (the API's
    ``net(x)`` after ``hybridize()``) and the same pure program run
    uncaptured on the card give bitwise-equal outputs, gradients and
    running statistics (f32, cuDNN deterministic) over one sequence that
    makes three captures of one program: a training-mode forward outside
    ``record`` (capture A), a recorded siamese pair ``net(x) + net(x2)``
    before one backward (capture B, then C while B waits for its
    backward), and A replayed again, whose masks must come from its own
    key table; then one hybridized ``Trainer`` step of the check net cast
    to bf16 (multi_precision)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, random as mxr
    from mxnet_tpu_torch.gluon import cached_op

    net = _gh_check_net(mx)
    net.initialize(mx.init.Xavier(magnitude=2), ctx=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn(GH_CHECK_BATCH, 35, 35, 3, generator=g, device=dev)
    with torch.no_grad(), autograd.pause():
        net(x)                                   # deferred shapes
    start = {n: p._tensor().detach().clone()
             for n, p in net.collect_params().items()}
    x2 = torch.randn(GH_CHECK_BATCH, 35, 35, 3, generator=g, device=dev)
    net.hybridize()
    base = mxr.prng_key(1234)
    prog = cached_op.CachedProgram(net, ["__t__"], True)
    results = {}
    for captured in (True, False):
        with torch.no_grad():
            for n, p in net.collect_params().items():
                p._tensor().copy_(start[n])
        mxr.set_state(base)

        def call(a):
            if captured:
                return net(mx.nd.array(a, ctx=dev))
            # the same program uncaptured, with the call's one draw
            return mx.nd.NDArray(prog([a], mxr.next_key(),
                                      autograd.is_recording(),
                                      capture=False))

        outs = []
        with autograd.train_mode():
            outs.append(call(x))
        with autograd.record():
            outs += [call(x), call(x2)]
            loss = outs[1].sum() + outs[2].sum()
        loss.backward()
        with autograd.train_mode():
            outs.append(call(x))
        torch.cuda.synchronize()
        results[captured] = ([o._data.detach().clone() for o in outs],
                             _gh_state(net))
    (o_c, s_c), (o_u, s_u) = results[True], results[False]
    diffs = {f"out{i}": float((a - b).abs().max())
             for i, (a, b) in enumerate(zip(o_c, o_u))}
    for k in s_c:
        diffs[k] = float((s_c[k].float() - s_u[k].float()).abs().max())
    bitwise = all(torch.equal(a, b) for a, b in zip(o_c, o_u)) and \
        all(torch.equal(s_c[k], s_u[k]) for k in s_c)
    captures = [len(c) for p in net._cached_ops.values()
                for c in p._captures.values()]
    moved = any(not torch.equal(s_c[n], start[n]) for n in start
                if n.endswith("running_mean"))
    net.cast("bfloat16")
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9,
                           "multi_precision": True})
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    y = mx.nd.array(torch.arange(GH_CHECK_BATCH, device=dev) % 10, ctx=dev)
    with autograd.record():
        L = lf(net(mx.nd.array(x, ctx=dev, dtype="bfloat16")), y)
    L.backward()
    tr.step(GH_CHECK_BATCH)
    torch.cuda.synchronize()
    return {"bitwise": bool(bitwise), "max_abs_diff": max(diffs.values()),
            "tensors": len(diffs), "running_stats_moved": bool(moved),
            "programs": len(net._cached_ops), "captures": captures,
            "bf16_step_loss": float(L.astype("float32").mean().asscalar()),
            "bf16_params_finite": all(
                bool(torch.isfinite(p._tensor().float()).all())
                for p in net.collect_params().values()),
            "bf16_weight_dtype": str(
                net.collect_params()["check_dense0_weight"]._tensor().dtype)}


def _gh_masks(dev):
    """Check (b): ``uniform`` bits and a ``Dropout`` mask for a fixed key
    are the same on the card and on the CPU, bit for bit; the kept
    fraction of a 10**6-element mask (p = 0.5) lies within 5 binomial
    standard deviations."""
    import torch

    from mxnet_tpu_torch import random as mxr
    from mxnet_tpu_torch.ops import nn as ops_nn, random_ops

    n = 10 ** 6
    key = mxr.prng_key(42)
    u_card = random_ops.uniform01(mxr.key_tensor(key, dev), (n,)).cpu()
    u_cpu = random_ops.uniform01(mxr.key_tensor(key, "cpu"), (n,))
    ones = torch.ones(n)
    m_card = ops_nn.dropout(ones.to(dev), rng_key=mxr.key_tensor(key, dev),
                            p=0.5).cpu()
    m_cpu = ops_nn.dropout(ones, rng_key=mxr.key_tensor(key, "cpu"), p=0.5)
    kept = int((m_card != 0).sum())
    sd = (n * 0.25) ** 0.5
    return {"uniform_bitwise": bool(torch.equal(u_card.view(torch.int32),
                                                u_cpu.view(torch.int32))),
            "mask_bitwise": bool(torch.equal(m_card, m_cpu)),
            "kept": kept, "kept_sd": (kept - n / 2) / sd,
            "within_5sd": abs(kept - n / 2) <= 5 * sd}


def _gh_reload(dev, tmp):
    """Check (d): after ``load_parameters`` on a hybridized net (its
    program captured), the next call uses the loaded values: its output
    equals a second net's, eager, whose parameters the file holds."""
    import os

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn(GH_CHECK_BATCH, 35, 35, 3, generator=g, device=dev)
    nets = []
    for seed in (SEED, SEED + 7):
        net = _gh_check_net(mx)
        net.initialize(mx.init.Xavier(magnitude=2), ctx=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           seed))
        with torch.no_grad(), autograd.pause():
            net(x)
        nets.append(net)
    a, b = nets
    a.hybridize()
    xs = mx.nd.array(x, ctx=dev)
    before = a(xs)._data.clone()
    path = os.path.join(tmp, "gh_reload.params")
    b.save_parameters(path)
    a.load_parameters(path, ctx=dev)
    after = a(xs)._data
    want = b(xs)._data
    return {"changed": not torch.equal(before, after),
            "max_abs_err": float((after - want).abs().max()),
            "bitwise": bool(torch.equal(after, want))}


def _gh_export(dev, net, x, tmp):
    """Check (e): ``export`` and ``SymbolBlock.imports`` reproduce the
    hybridized (bf16) net's inference output on the card bit for bit (the
    executor runs the same ops in the same order); the largest absolute
    difference is reported against the output's scale."""
    import os

    import torch

    import mxnet_tpu_torch as mx

    prefix = os.path.join(tmp, "gh_inception")
    xs = mx.nd.array(x, ctx=dev)
    ref = net(xs)._data.float()
    net.export(prefix)
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params", ctx=dev)
    got = blk(xs)._data.float()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    return {"max_abs_err": err, "out_abs_max": scale,
            "rel_err": err / max(scale, 1e-30),
            "bitwise": bool(torch.equal(got, ref)),
            "symbol_bytes": os.path.getsize(prefix + "-symbol.json")}


def _gh_layer_norm(dev):
    """Check (f): ``gluon.nn.LayerNorm`` on a CUDA tensor (the serving
    decode shape, 8 x 768, f32) launches the LayerNorm kernel: the
    wrapper counts one launch a call, and the profiler (``_launched``, 20
    calls between two matmuls a session) sees ``layer_norm_kernel`` and
    no other LayerNorm function; its output agrees with the plain
    version."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.layer_norm import (layer_norm_fused,
                                                layer_norm_reference)

    ln = mx.gluon.nn.LayerNorm(in_channels=768)
    ln.initialize(ctx=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    x = torch.randn(8, 768, generator=g, device=dev)
    lead = torch.randn(256, 256, generator=g, device=dev)
    calls = 20

    def session():
        with torch.no_grad():
            lead @ lead
            for _ in range(calls):
                ln(x)
            lead @ lead

    with torch.no_grad():
        got = ln(x)
        want = layer_norm_reference(x, ln.gamma._tensor(), ln.beta._tensor())
    before = layer_norm_fused.launches
    names, sessions = _launched(session, "layer_norm")
    counted = layer_norm_fused.launches - before
    return {"max_abs_err": float((got - want).abs().max()),
            "functions": names, "sessions": sessions, "counted": counted,
            "routed": counted == calls * sessions
            and _routed(names, ("layer_norm_kernel",))[0]}


def _gh_train(dev, net, trainer, loss_fn, x, y, steps):
    """``steps`` Trainer steps on the one batch: losses (f32 mean), host
    wall ms each (ending in a sync)."""
    import torch

    from mxnet_tpu_torch import autograd

    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            L = loss_fn(net(x), y)
        L.backward()
        trainer.step(x.shape[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(L.astype("float32").mean().asscalar()))
    return losses, ms


def phase_gluon_hybrid(dev):
    """The rest of the Gluon surface on the card: ``inception_v3(classes=
    1000, layout="NHWC")`` (Xavier magnitude 2 from seed 0, one eager
    forward for the deferred shapes), ``cast("bfloat16")``,
    ``hybridize()``, ``Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4,
    multi_precision)`` with ``SoftmaxCrossEntropyLoss``, one batch of
    B=128 random 299x299x3 images kept on the card: ten hybridized steps
    (captured CUDA graphs), then ten eager steps of the same net
    (``hybridize(False)``).  Numbers: step ms and images/s (median of
    steps 2-10), a profiled step's idle share and its BatchNorm stats and
    normalize launches by kernel name, peak memory, each way; the
    wrappers' counts over the ten steps, which on the hybridized run are
    the two warm-ups and the replays of each capture (94 + 94 each).
    Checks (a)-(f): ``_gh_capture_exact``, ``_gh_masks``, the losses
    falling without NaN, ``_gh_reload``, ``_gh_export``,
    ``_gh_layer_norm``."""
    import gc
    import tempfile

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo.vision import inception_v3

    bad = []
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        capture = _gh_capture_exact(dev)
        gc.collect()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    if not capture["bitwise"]:
        bad.append(f"(a) captured and uncaptured programs differ "
                   f"({capture['max_abs_diff']})")
    if capture["captures"] != [1, 2]:
        bad.append(f"(a) captures per signature {capture['captures']}, "
                   f"want [1, 2] (inference-mode A; B and C)")
    if not capture["running_stats_moved"]:
        bad.append("(a) the running statistics were not committed")
    if not (capture["bf16_params_finite"]
            and capture["bf16_weight_dtype"] == "torch.bfloat16"):
        bad.append(f"(a) the bf16 step: {capture}")
    masks = _gh_masks(dev)
    if not (masks["uniform_bitwise"] and masks["mask_bitwise"]
            and masks["within_5sd"]):
        bad.append(f"(b) masks: {masks}")
    ln = _gh_layer_norm(dev)
    tmp = tempfile.mkdtemp(prefix="gh_", dir="build")
    reload = _gh_reload(dev, tmp)
    if not (reload["changed"] and reload["max_abs_err"] <= 1e-5):
        bad.append(f"(d) load_parameters: {reload}")
    gc.collect()

    net = inception_v3(classes=GH_CLASSES, layout="NHWC")
    net.initialize(mx.init.Xavier(magnitude=2), ctx=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad(), autograd.pause():
        net(torch.zeros(2, GH_HW, GH_HW, 3, device=dev))
    net.cast("bfloat16")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = mx.nd.NDArray(torch.randn(GH_BATCH, GH_HW, GH_HW, 3, generator=g,
                                  device=dev).to(torch.bfloat16))
    y = mx.nd.NDArray(torch.randint(0, GH_CLASSES, (GH_BATCH,), generator=g,
                                    device=dev).float())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4, "multi_precision": True})
    runs = {}
    for mode in ("hybridized", "eager"):
        net.hybridize(mode == "hybridized")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        losses, ms = _gh_train(dev, net, trainer, loss_fn, x, y, GH_STEPS)
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        captures = sum(len(c) for p in net._cached_ops.values()
                       for c in p._captures.values())
        prof = _profiled(
            lambda: _gh_train(dev, net, trainer, loss_fn, x, y, 1),
            families=("bn_stats_partial", "bn_normalize"))
        step = float(np.median(ms[1:]))
        runs[mode] = {"losses": losses, "step_ms": ms,
                      "step_ms_median": step,
                      "images_per_s": GH_BATCH / step * 1e3,
                      "peak_bytes": peak,
                      "profiled": {k: prof[k] for k in (
                          "wall_s", "kernels", "device_busy_s",
                          "idle_share", "top", "port_kernels_ms")},
                      "bn_launches_per_step": {
                          "stats": prof["families"]["bn_stats_partial"],
                          "normalize": prof["families"]["bn_normalize"]},
                      "profiler_lost_records": prof["lost_records"],
                      "launches": launches, "captures": captures}
        if mode == "hybridized":
            runs[mode]["programs"] = len(net._cached_ops)
    if not ln["routed"] or \
            ln["max_abs_err"] > TOL["float32"]["atol"] * 10:
        bad.append(f"(f) LayerNorm: {ln}")
    ls = runs["hybridized"]["losses"]
    if not min(ls[1:4]) < ls[0]:
        bad.append(f"(c) the first updates did not lower the loss: {ls}")
    for mode, r in runs.items():
        if not all(np.isfinite(r["losses"])):
            bad.append(f"(c) {mode} losses {r['losses']}")
        if not (r["launches"]["bn_stats"] and r["launches"]["bn_normalize"]):
            bad.append(f"{mode}: a BatchNorm kernel never launched")
        want = GH_BN * (GH_STEPS + 2 * r["captures"])
        if (r["launches"]["bn_stats"], r["launches"]["bn_normalize"]) != \
                (want, want):
            bad.append(f"{mode}: counted BatchNorm launches "
                       f"{r['launches']['bn_stats']} + "
                       f"{r['launches']['bn_normalize']}, want {want} each "
                       f"({r['captures']} captures)")
        if r["bn_launches_per_step"] != {"stats": GH_BN, "normalize": GH_BN}:
            bad.append(f"{mode}: BatchNorm launches a step "
                       f"{r['bn_launches_per_step']}, want {GH_BN} + {GH_BN} "
                       f"(launch records without a kernel record: "
                       f"{r['profiler_lost_records']})")
        if r["launches"]["bn_noncontiguous_copies"]:
            bad.append(f"{mode}: BatchNorm copied non-contiguous input")
    net.hybridize()
    export = _gh_export(dev, net, x._data[:GH_CHECK_BATCH], tmp)
    if not export["bitwise"]:
        bad.append(f"(e) export round trip: {export}")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["eager"]["launches"]}
    res = {"phase": "gluon_hybrid",
           "config": {"model": "inception_v3", "classes": GH_CLASSES,
                      "layout": "NHWC", "image": [GH_HW, GH_HW, 3],
                      "batch": GH_BATCH, "dtype": "bfloat16 (cast)",
                      "optimizer": "sgd", "lr": 0.1, "momentum": 0.9,
                      "wd": 1e-4, "multi_precision": True,
                      "initializer": "Xavier(magnitude=2)"},
           "capture_exact": capture, "masks": masks, "reload": reload,
           "export": export, "layer_norm": ln, "runs": runs,
           "launches": launches}
    emit(res)
    if bad:
        raise SystemExit("gluon_hybrid phase failed: " + "; ".join(bad))
    return res


# -- phase 14: rnn_lm ----------------------------------------------------------------

def _example_ns(relpath):
    """An example script's namespace, built against the port (its package
    import swapped), as a user runs it under ``import mxnet_tpu_torch``."""
    import os
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    with open(path) as f:
        src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", f.read())
    ns = {"__name__": "chip_smoke_example", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    return ns


def _rnn_op_card_vs_cpu(dev):
    """The ``RNN`` op (lstm and gru, two layers, bidirectional, with the
    final states) on the card against the port on the CPU at RNN_CHECK:
    outputs, final states and the gradients of every input."""
    import torch

    from mxnet_tpu_torch.ops.rnn import rnn, rnn_param_size

    T, N, I, H, L = RNN_CHECK
    rows, bad = [], []
    for mode in ("lstm", "gru"):
        rs = np.random.RandomState(SEED)
        P = rnn_param_size(mode, L, I, H, True)
        host = [rs.randn(T, N, I), 0.1 * rs.randn(P), rs.randn(2 * L, N, H)]
        if mode == "lstm":
            host.append(rs.randn(2 * L, N, H))
        host = [a.astype(np.float32) for a in host]
        shapes = [(T, N, 2 * H)] + [(2 * L, N, H)] * (len(host) - 2)
        cts = [rs.randn(*s).astype(np.float32) for s in shapes]

        def run(d):
            args = [torch.tensor(a, device=d, requires_grad=True)
                    for a in host]
            outs = rnn(*args, state_size=H, num_layers=L, mode=mode,
                       bidirectional=True, state_outputs=True)
            grads = torch.autograd.grad(
                outs, args, [torch.tensor(c, device=d) for c in cts])
            return [t.detach().cpu() for t in list(outs) + list(grads)]

        names = ["out", "hT"] + (["cT"] if mode == "lstm" else []) + \
            ["d_data", "d_parameters", "d_state"] + \
            (["d_state_cell"] if mode == "lstm" else [])
        errs = {}
        for n, a, b in zip(names, run(dev), run("cpu")):
            ok, err, _ = _close(a, b, "float32")
            errs[n] = err
            if not ok:
                bad.append(f"RNN {mode} {n}: card vs CPU max error {err}")
        rows.append({"mode": mode, "shape": [T, N, I, H, L],
                     "max_abs_err": errs})
    return rows, bad


def _lm_data(mx, ns):
    """The example's Markov token stream at WikiText-2's vocabulary, enough
    for LM_STEPS segments of LM_BPTT, batchified on the card."""
    tokens, vocab = ns["get_stream"](
        num_tokens=LM_BATCH * (LM_STEPS * LM_BPTT + 1), vocab_size=LM_VOCAB,
        seed=0)
    return ns["batchify"](tokens, LM_BATCH), vocab


def _lm_train(mx, ns, model, data, loss_fn, trainer, steps):
    """``steps`` of the example's truncated-BPTT loop: losses (mean per
    token) and host wall ms each (ending in a sync)."""
    import torch

    autograd, gluon = mx.autograd, mx.gluon
    hidden = model.begin_state(func=mx.nd.zeros, batch_size=LM_BATCH)
    losses, ms = [], []
    for k in range(steps):
        i = k * LM_BPTT
        X = data[i:i + LM_BPTT]
        y = data[i + 1:i + 1 + LM_BPTT].reshape((-1,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden = ns["detach"](hidden)
        with autograd.record():
            out, hidden = model(X, hidden)
            L = loss_fn(out, y)
        L.backward()
        grads = [p.grad() for p in model.collect_params().values()
                 if p.grad_req != "null"]
        gluon.utils.clip_global_norm(grads, LM_CLIP * LM_BPTT * LM_BATCH)
        trainer.step(LM_BPTT * LM_BATCH)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(L.mean().asscalar()))
    return losses, ms


def _lm_first_loss(mx, model, data, loss_fn):
    """The first segment's mean loss from zero states, in inference (no
    dropout)."""
    hidden = model.begin_state(func=mx.nd.zeros, batch_size=LM_BATCH)
    out, _ = model(data[0:LM_BPTT], hidden)
    return float(loss_fn(out, data[1:1 + LM_BPTT].reshape((-1,)))
                 .mean().asscalar())


def _cudnn_lstm_ms(dev):
    """The yardstick (PERF.md only, never on the port's path): cuDNN's
    LSTM (``torch.nn.LSTM``) forward + backward at the word LM's shape,
    beside the port's ``RNN`` op on the same shape, device ms each."""
    import torch

    from mxnet_tpu_torch.ops.rnn import rnn, rnn_param_size

    g = torch.Generator(device="cpu").manual_seed(SEED)
    shape = (LM_BPTT, LM_BATCH, LM_WIDTH)
    x = torch.randn(shape, generator=g).to(dev).requires_grad_()
    lstm = torch.nn.LSTM(LM_WIDTH, LM_WIDTH, LM_LAYERS).to(dev)
    P = rnn_param_size("lstm", LM_LAYERS, LM_WIDTH, LM_WIDTH)
    blob = (0.07 * torch.randn(P, generator=g)).to(dev).requires_grad_()
    h0 = torch.zeros((LM_LAYERS, LM_BATCH, LM_WIDTH), device=dev)
    ct = torch.randn(shape, generator=g).to(dev)

    def cudnn():
        out, _ = lstm(x, (h0, h0))
        torch.autograd.grad(out, [x] + list(lstm.parameters()), ct)

    def port():
        out = rnn(x, blob, h0, h0, state_size=LM_WIDTH,
                  num_layers=LM_LAYERS, mode="lstm")
        torch.autograd.grad(out, [x, blob], ct)

    return {"shape": list(shape), "layers": LM_LAYERS,
            "cudnn_fwd_bwd_ms": _event_ms(cudnn),
            "port_rnn_op_fwd_bwd_ms": _event_ms(port)}


def phase_rnn_lm(dev):
    """Path A: ``example/gluon/word_language_model/train.py``'s
    ``RNNModel`` (``Embedding`` -> ``rnn.LSTM`` -> ``Dense``, dropout 0.5)
    at the upstream example's medium width, f32, on the default context:
    the RNN op card vs CPU at RNN_CHECK, then LM_STEPS truncated-BPTT steps
    (``clip_global_norm``, ``Trainer("sgd")``) over the example's token
    stream.  Checks: the op's outputs, states and gradients (TOL float32);
    no NaN; the first segment's loss (inference, zero states) lower after
    the steps than before.  Numbers: tokens/s and step ms (median of steps
    2-LM_STEPS), peak memory, a profiled step's device time and idle
    share, cuDNN's LSTM beside the port's op."""
    import gc

    import torch

    import mxnet_tpu_torch as mx

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    gc.collect()
    op_rows, bad = _rnn_op_card_vs_cpu(dev)
    ns = _example_ns("example/gluon/word_language_model/train.py")
    mx.random.seed(SEED)
    data, vocab = _lm_data(mx, ns)
    model = ns["RNNModel"](vocab, LM_WIDTH, LM_WIDTH, LM_LAYERS, LM_DROPOUT)
    model.initialize(mx.init.Xavier(), ctx=mx.current_context())
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": LM_LR, "momentum": 0,
                                "wd": 0})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss0 = _lm_first_loss(mx, model, data, loss_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    losses, ms = _lm_train(mx, ns, model, data, loss_fn, trainer, LM_STEPS)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    loss1 = _lm_first_loss(mx, model, data, loss_fn)
    prof = _profiled(lambda: _lm_train(mx, ns, model, data, loss_fn,
                                       trainer, 1))
    steady = float(np.median(ms[1:]))
    res = {"phase": "rnn_lm",
           "config": {"example": "example/gluon/word_language_model/"
                      "train.py", "vocab": vocab, "emsize": LM_WIDTH,
                      "nhid": LM_WIDTH, "nlayers": LM_LAYERS,
                      "dropout": LM_DROPOUT, "bptt": LM_BPTT,
                      "batch": LM_BATCH, "lr": LM_LR, "clip": LM_CLIP,
                      "params": sum(p.data().size for p in
                                    model.collect_params().values())},
           "rnn_op_card_vs_cpu": op_rows, "losses": losses, "step_ms": ms,
           "steady_step_ms": steady,
           "tokens_per_s": LM_BPTT * LM_BATCH / (steady / 1e3),
           "first_segment_loss": [loss0, loss1], "peak_bytes": peak,
           "profiled_step": prof, "yardstick": _cudnn_lstm_ms(dev),
           "launches": launches}
    emit(res)
    if not all(np.isfinite(losses + [loss0, loss1])):
        bad.append(f"non-finite loss: {losses}, {loss0}, {loss1}")
    if not loss1 < loss0:
        bad.append(f"the first segment's loss did not fall: {loss0} -> "
                   f"{loss1}")
    if any(launches.values()):
        bad.append(f"the word LM launched port kernels: {launches}")
    if bad:
        raise SystemExit("rnn_lm phase failed: " + "; ".join(bad))
    return res


# -- phase 15: bucketing_fit ---------------------------------------------------------

def _bk_corpus(n=None, seed=0):
    """``word_lm.py``'s Markov corpus (each token one of three successors of
    the last) at PTB's vocabulary, sentence lengths 5-40 so every bucket
    gets batches."""
    rs = np.random.RandomState(seed)
    trans = rs.randint(1, BK_VOCAB, size=(BK_VOCAB, 3))
    sentences = []
    for _ in range(n or BK_SENTENCES):
        tok = rs.randint(1, BK_VOCAB)
        sent = [int(tok)]
        for _ in range(rs.randint(5, max(BK_BUCKETS) + 1) - 1):
            tok = trans[tok, rs.randint(3)]
            sent.append(int(tok))
        sentences.append(sent)
    return sentences


def _bk_sym_gen(mx):
    """``lstm_bucketing.py``'s ``sym_gen``: Embedding, the unrolled stack
    of LSTMCells, a FullyConnected decoder, SoftmaxOutput."""
    stack = mx.rnn.SequentialRNNCell()
    for i in range(BK_LAYERS):
        stack.add(mx.rnn.LSTMCell(num_hidden=BK_HIDDEN, prefix=f"lstm_l{i}_"))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=BK_VOCAB,
                                 output_dim=BK_EMBED, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, BK_HIDDEN))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=BK_VOCAB,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def _bk_batches(mx):
    """One batch of each bucket (the corpus's, in bucket order)."""
    import random

    random.seed(SEED)
    it = mx.rnn.BucketSentenceIter(_bk_corpus(400, seed=1), BK_BATCH,
                                   buckets=list(BK_BUCKETS), invalid_label=0)
    got = {}
    for b in it:
        got.setdefault(b.bucket_key, b)
    return [got[k] for k in BK_BUCKETS]


def _bk_seeded_params(shapes):
    """Parameters of the bucket model drawn from ``SEED`` as the fit's
    initializer draws them (Xavier, uniform, fan-in, magnitude 2.34;
    vectors 0), in name order: the card-vs-CPU check starts from these,
    not from the fitted weights, which the card does not reproduce bit
    for bit from run to run."""
    rs = np.random.RandomState(SEED)
    out = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        if len(shape) < 2:
            out[name] = np.zeros(shape, np.float32)
            continue
        bound = np.sqrt(3.0 * 2.34 / int(np.prod(shape[1:])))
        out[name] = rs.uniform(-bound, bound, shape).astype(np.float32)
    return out


def _bk_card_vs_cpu(mx, arg_params):
    """One forward_backward per bucket on a card and on a CPU
    ``BucketingModule`` from the same seeded parameters
    (:func:`_bk_seeded_params`): the loss and every gradient within 1e-4
    (relative to each gradient's largest entry)."""
    import torch

    rows, bad = [], []
    mods = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            batches = _bk_batches(mx)
            mod = mx.mod.BucketingModule(_bk_sym_gen(mx),
                                         default_bucket_key=max(BK_BUCKETS),
                                         context=ctx)
            mod.bind(batches[-1].provide_data, batches[-1].provide_label)
            mod.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in arg_params.items()})
            mods[name] = (mod, batches)
    for k, key in enumerate(BK_BUCKETS):
        out = {}
        for name, (mod, batches) in mods.items():
            mod.forward_backward(batches[k])
            ex = mod._curr_module._exec
            out[name] = (_ce(ex.outputs[0],
                             batches[k].label[0].reshape((-1,))),
                         {n: g._data.float().cpu()
                          for n, g in ex.grad_dict.items()
                          if n not in ("data", "softmax_label")})
        (lc, gc_), (lp, gp) = out["card"], out["cpu"]
        err = max(float((gc_[n] - gp[n]).abs().max() /
                        gp[n].abs().max().clamp_min(1e-12)) for n in gp)
        rows.append({"bucket": key, "loss_card": lc, "loss_cpu": lp,
                     "max_grad_rel_err": err})
        if abs(lc - lp) > 1e-4 * abs(lp) or err > 1e-4:
            bad.append(f"bucket {key}: card vs CPU loss {lc} / {lp}, "
                       f"gradient error {err}")
    del mods
    torch.cuda.empty_cache()
    return rows, bad


def _bk_fused_vs_unfused(mx, dev):
    """A two-layer ``FusedRNNCell`` (the ``RNN`` op) at the bucket model's
    widths against its ``unfuse()``d LSTMCells on the card, T = the largest
    bucket."""
    T = max(BK_BUCKETS)
    with mx.name.NameManager():
        fused = mx.rnn.FusedRNNCell(BK_HIDDEN, num_layers=BK_LAYERS,
                                    mode="lstm", prefix="fz_")
        fo, _ = fused.unroll(T, inputs=mx.sym.Variable("data"),
                             layout="TNC", merge_outputs=True)
        uo, _ = fused.unfuse().unroll(T, inputs=mx.sym.Variable("data"),
                                      layout="TNC", merge_outputs=True)
    arg_shapes, _, _ = fo.infer_shape(data=(T, BK_BATCH, BK_EMBED))
    rs = np.random.RandomState(SEED)
    vals = {n: (0.0 * rs.randn(*s) if "state" in n else
                (0.1 if n != "data" else 1.0) * rs.randn(*s)).astype(
                    np.float32)
            for n, s in zip(fo.list_arguments(), arg_shapes)}
    want = _bound_outputs(fo, vals, dev)[0]
    unfused = _fused_to_unfused(vals["fz_parameters"], "lstm", BK_LAYERS,
                                BK_EMBED, BK_HIDDEN, False, "fz_")
    got = _bound_outputs(uo, {**unfused, "data": vals["data"]}, dev)[0]
    import torch

    ok, err, _ = _close(torch.from_numpy(got), torch.from_numpy(want),
                        "float32")
    return {"T": T, "max_abs_err": err}, ([] if ok else [
        f"FusedRNNCell vs its unfused cells on the card: {err}"])


def _bk_switch_check(mx, mod, batches):
    """After a step on the largest bucket, the smallest bucket's module
    forwards with the weights that step left (bitwise)."""
    import torch

    big, small = batches[-1], batches[0]
    mod.forward_backward(big)
    mod.update()
    trained = {n: v._data.clone() for n, v in
               mod._curr_module._exec.arg_dict.items()
               if n not in ("data", "softmax_label")}
    mod.forward(small, is_train=False)
    seen = mod._buckets[small.bucket_key]._exec.arg_dict
    same = all(torch.equal(seen[n]._data, v) for n, v in trained.items())
    return same, ([] if same else [
        "bucket switch: the small bucket did not see the trained weights"])


def phase_bucketing_fit(dev):
    """Path B: ``example/rnn/bucketing/lstm_bucketing.py``'s
    ``BucketingModule.fit`` at its widths over the Markov corpus
    (BK_SENTENCES sentences, lengths 5-40, ``BucketSentenceIter``), Adam lr
    0.01, Xavier(in, 2.34), Perplexity(ignore_label=0), BK_EPOCHS epochs,
    f32 on the default context.  Checks: every bucket bound, perplexity
    lower in epoch 2 than in epoch 1, no fused step (the reference's
    route); a bucket switch sees the trained weights; one step per bucket
    card vs CPU from seeded weights (loss, gradients 1e-4); a FusedRNNCell
    against its
    unfused cells on the card.  Numbers: sentences/s, step ms per bucket
    (median), the executor's host ms a forward per bucket, peak memory."""
    import gc
    import random

    import torch

    import mxnet_tpu_torch as mx

    gc.collect()
    random.seed(SEED)
    it = mx.rnn.BucketSentenceIter(_bk_corpus(), BK_BATCH,
                                   buckets=list(BK_BUCKETS), invalid_label=0)
    mod = mx.mod.BucketingModule(_bk_sym_gen(mx),
                                 default_bucket_key=it.default_bucket_key)
    perplexity = mx.metric.Perplexity(ignore_label=0)
    ppl, marks, keys = [], [], []

    def timing(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        keys.append(param.locals["data_batch"].bucket_key)

    def per_epoch(epoch, sym, arg, aux):
        ppl.append(perplexity.get()[1])

    torch.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=perplexity, optimizer="adam",
            optimizer_params={"learning_rate": BK_LR},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=BK_EPOCHS, batch_end_callback=timing,
            epoch_end_callback=per_epoch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
    per_bucket = {k: float(np.median([m for m, kk in zip(step_ms, keys)
                                      if kk == k][2:] or [float("nan")]))
                  for k in BK_BUCKETS}
    counts = {k: keys.count(k) for k in BK_BUCKETS}
    fused = [m._fused_step_count for m in mod._buckets.values()]
    fwd_host = {}
    for k, m in sorted(mod._buckets.items()):
        ex, host = m._exec, []
        for _ in range(3):
            torch.cuda.synchronize()
            s = time.perf_counter()
            ex.forward(is_train=False)
            host.append((time.perf_counter() - s) * 1e3)
        torch.cuda.synchronize()
        fwd_host[k] = {"ms": float(np.median(host)),
                       "op_nodes": sum(1 for n in ex._order
                                       if n.kind == "op")}
    arg_params = _bk_seeded_params({n: v.shape for n, v in
                                    mod.get_params()[0].items()})
    same, bad = _bk_switch_check(mx, mod, _bk_batches(mx))
    del mod
    gc.collect()
    card_cpu, bad_cc = _bk_card_vs_cpu(mx, arg_params)
    fused_check, bad_fu = _bk_fused_vs_unfused(mx, dev)
    res = {"phase": "bucketing_fit",
           "config": {"example": "example/rnn/bucketing/lstm_bucketing.py",
                      "vocab": BK_VOCAB, "num_hidden": BK_HIDDEN,
                      "num_embed": BK_EMBED, "num_layers": BK_LAYERS,
                      "buckets": list(BK_BUCKETS), "batch": BK_BATCH,
                      "optimizer": "adam", "lr": BK_LR,
                      "sentences": BK_SENTENCES, "epochs": BK_EPOCHS},
           "fit_s": fit_s, "batches": len(marks),
           "batches_per_bucket": counts,
           "sentences_per_s": BK_BATCH * len(marks) / fit_s,
           "step_ms_per_bucket": per_bucket,
           "executor_forward_host": fwd_host, "perplexity": ppl,
           "fused_steps": fused, "peak_bytes": peak,
           "switch_sees_trained_weights": same,
           "card_vs_cpu": card_cpu, "fused_vs_unfused": fused_check,
           "launches": launches}
    emit(res)
    bad += bad_cc + bad_fu
    if sorted(counts) != sorted(BK_BUCKETS) or not all(counts.values()):
        bad.append(f"not every bucket trained: {counts}")
    if not (len(ppl) == BK_EPOCHS and np.all(np.isfinite(ppl))
            and ppl[1] < ppl[0]):
        bad.append(f"perplexity did not fall from epoch 1 to 2: {ppl}")
    if any(fused):
        bad.append(f"a bucket module took fused steps: {fused}")
    if any(launches.values()):
        bad.append(f"the bucketing fit launched port kernels: {launches}")
    if bad:
        raise SystemExit("bucketing_fit phase failed: " + "; ".join(bad))
    return res


# -- phase 27: sparse_fit ------------------------------------------------------------

def _sp_write_libsvm(path, rows, features, seed):
    """``example/sparse/linear_classification.py``'s ``synthetic_libsvm``
    rows at ``features`` columns: 5-19 distinct sorted indices a row,
    N(0, 1) values written to four decimals, the label the sign of the
    row against a N(0, 1) rule.  The draws are vectorized, and a row's
    indices come from ``randint`` with repeats drawn again (``choice``
    without replacement permutes every column a row)."""
    rs = np.random.RandomState(seed)
    w_true = rs.randn(features)
    nnz = rs.randint(5, 20, size=rows)
    row = np.repeat(np.arange(rows), nnz)
    col = rs.randint(0, features, size=row.size)
    while True:
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        dup = np.zeros(row.size, bool)
        dup[1:] = (row[1:] == row[:-1]) & (col[1:] == col[:-1])
        if not dup.any():
            break
        col[dup] = rs.randint(0, features, size=int(dup.sum()))
    val = rs.randn(row.size)
    label = np.bincount(row, weights=val * w_true[col],
                        minlength=rows) > 0
    starts = np.concatenate([[0], np.cumsum(nnz)])
    with open(path, "w") as f:
        for r in range(rows):
            a, b = starts[r], starts[r + 1]
            f.write(f"{int(label[r])} " + " ".join(
                f"{i}:{v:.4f}" for i, v in zip(col[a:b], val[a:b])) + "\n")
    return int(row.size)


def _sp_linear_model(mx, features):
    """The example's ``linear_model`` (two classes, SoftmaxOutput, a
    ``row_sparse`` weight declared (features, 2)) with its data declared
    ``stype="csr"``, as upstream's model declares it."""
    data = mx.sym.Variable("data", stype="csr")
    label = mx.sym.Variable("softmax_label")
    weight = mx.sym.Variable("weight", stype="row_sparse",
                             shape=(features, 2))
    bias = mx.sym.Variable("bias", shape=(2,))
    pred = mx.sym.broadcast_add(mx.sym.dot(data, weight), bias)
    return mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def _sp_fit(mx, ctx, path, init, batches=None, epochs=1, callback=None):
    """``Module.fit`` of the linear model over ``LibSVMIter`` on ``ctx``
    from the numpy ``init`` (SGD lr SP_LR, accuracy); the Module and its
    train accuracy after the fit (``score``)."""
    with ctx:
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(SP_FEATURES,),
                              batch_size=SP_BATCH, label_name="softmax_label")
        feed = it if batches is None else mx.io.ResizeIter(it, batches)
        mod = mx.mod.Module(_sp_linear_model(mx, SP_FEATURES),
                            label_names=["softmax_label"], context=ctx)
        mod.fit(feed, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": SP_LR},
                arg_params={k: mx.nd.array(v) for k, v in init.items()},
                initializer=mx.init.Zero(), eval_metric="accuracy",
                batch_end_callback=callback)
        metric = mx.metric.Accuracy()
        feed.reset()
        mod.score(feed, metric)
    return mod, metric.get()[1]


def _sp_example_main(mx, ctx):
    """The repo's ``example/sparse/linear_classification.py`` ``main`` at
    its defaults (100 features, batch 64, five epochs, SGD lr 0.1) on
    ``ctx``: its final train accuracy.  Its ``Normal(0.01)`` draws from one
    seeded CPU generator, so the card and the CPU start alike."""
    import argparse
    import types

    import torch

    ns = _example_ns(os.path.join("example", "sparse",
                                  "linear_classification.py"))

    class SeededNormal(mx.init.Normal):
        def __call__(self, desc, arr, generator=None):
            return super().__call__(desc, arr, torch.Generator().manual_seed(
                SEED))

    ns["mx"] = types.SimpleNamespace(**{k: getattr(mx, k) for k in dir(mx)
                                        if not k.startswith("__")})
    ns["mx"].init = types.SimpleNamespace(
        **{k: getattr(mx.init, k) for k in dir(mx.init)
           if not k.startswith("__")})
    ns["mx"].init.Normal = SeededNormal
    args = argparse.Namespace(data=None, num_features=100, batch_size=64,
                              epochs=5, lr=0.1, optimizer="sgd")
    with ctx:
        return float(ns["main"](args))


def phase_sparse_fit(dev):
    """Path A (sparse storage): the example's linear classifier at the
    Avazu width (SP_FEATURES columns, batch SP_BATCH) with its data
    declared csr, over SP_BATCHES x SP_BATCH seeded synthetic LibSVM rows:
    ``LibSVMIter`` alone (rows/s parsing and serving batches to the card),
    then SP_EPOCHS epochs of ``Module.fit`` on the card (the fused step;
    the batch's data, indices and indptr on the card, no dense buffer):
    samples/s and step ms (median, a sync in the batch-end callback), the
    peak device bytes the fit added (under SP_PEAK_BYTES; a dense batch
    would be 32.8 GB).  Checks: SP_CHECK_STEPS fitted steps card against
    CPU from the same weights (rtol 1e-5 with an absolute floor of 1e-5 x
    the largest CPU magnitude: the card's ``index_add_`` sums in no fixed
    order), no port kernel launched, and the repo's example ``main`` at
    its defaults reaching the CPU's final accuracy on the card."""
    import gc

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.sparse import CSRNDArray

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    out_dir = os.path.join("build", "sparse_fit")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "avazu_width.libsvm")
    rows = SP_BATCH * SP_BATCHES
    t0 = time.perf_counter()
    nnz = _sp_write_libsvm(path, rows, SP_FEATURES, SEED + 80)
    write_s = time.perf_counter() - t0
    bad = []
    # the iterator alone: parse, then one epoch of batches on the card
    with mx.gpu(0):
        t0 = time.perf_counter()
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(SP_FEATURES,),
                              batch_size=SP_BATCH,
                              label_name="softmax_label")
        parse_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = 0
        for b in it:
            served += b.data[0].shape[0] - b.pad
            on_card = b.data[0].data_.is_cuda and b.label[0]._data.is_cuda
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        del it, b
    if served != rows or not on_card:
        bad.append(f"LibSVMIter served {served} rows (on the card: "
                   f"{on_card}), expected {rows}")
    rs = np.random.RandomState(SEED + 81)
    init = {"weight": (rs.randn(SP_FEATURES, 2) * 0.01).astype(np.float32),
            "bias": np.zeros(2, np.float32)}
    # the main path on the card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks = []

    def timing(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod, acc = _sp_fit(mx, mx.gpu(0), path, init, epochs=SP_EPOCHS,
                       callback=timing)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
    steady = float(np.median(ms[2:]))
    data_arg = mod._exec.arg_dict["data"]
    fused = mod._fused_step_count
    moved = float(np.abs(mod.get_params()[0]["weight"].asnumpy()
                         - init["weight"]).max())
    del mod
    # card against CPU over the first steps
    fitted = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        m, _ = _sp_fit(mx, ctx, path, init, batches=SP_CHECK_STEPS)
        fitted[name] = {k: v.asnumpy() for k, v in
                        m.get_params()[0].items()}
        del m
    excess, err = -np.inf, 0.0
    for k, cpu in fitted["cpu"].items():
        d = np.abs(fitted["card"][k] - cpu)
        floor = 1e-5 * float(np.abs(cpu).max())
        excess = max(excess, float((d - floor - 1e-5 * np.abs(cpu)).max()))
        err = max(err, float(d.max()))
    example = {name: _sp_example_main(mx, ctx) for name, ctx in
               (("card", mx.gpu(0)), ("cpu", mx.cpu()))}
    res = {"phase": "sparse_fit",
           "config": {"model": "example/sparse/linear_classification.py "
                      "linear_model, data stype=csr",
                      "features": SP_FEATURES, "batch": SP_BATCH,
                      "rows": rows, "nnz": nnz, "epochs": SP_EPOCHS,
                      "lr": SP_LR, "dense_batch_bytes":
                      SP_BATCH * SP_FEATURES * 4},
           "write_file_s": write_s,
           "libsvm_iter": {"parse_s": parse_s,
                           "parse_rows_per_s": rows / parse_s,
                           "serve_s": serve_s,
                           "serve_rows_per_s": rows / serve_s},
           "fit": {"step_ms": ms, "steady_step_ms": steady,
                   "samples_per_s": SP_BATCH / (steady / 1e3),
                   "fused_steps": fused, "train_accuracy": acc,
                   "weight_moved": moved,
                   "data_arg": type(data_arg).__name__,
                   "peak_bytes_added": peak},
           "card_vs_cpu": {"steps": SP_CHECK_STEPS, "max_abs_err": err,
                           "excess_over_tol": excess},
           "example_main_accuracy": example, "launches": launches}
    emit(res)
    if not isinstance(data_arg, CSRNDArray) or fused != \
            SP_BATCHES * SP_EPOCHS:
        bad.append(f"the fit's data argument {type(data_arg).__name__}, "
                   f"fused steps {fused}")
    if peak >= SP_PEAK_BYTES:
        bad.append(f"the fit added {peak} device bytes at its peak, over "
                   f"{SP_PEAK_BYTES}")
    if not np.isfinite(acc) or moved == 0:
        bad.append(f"fit: accuracy {acc}, weight moved {moved}")
    if excess > 0:
        bad.append(f"card against CPU after {SP_CHECK_STEPS} steps: "
                   f"{res['card_vs_cpu']}")
    if abs(example["card"] - example["cpu"]) > 1e-3:
        bad.append(f"example main: card accuracy {example['card']}, CPU "
                   f"{example['cpu']}")
    if any(launches.values()):
        bad.append(f"launches {launches}, expected none")
    if bad:
        raise SystemExit("sparse_fit phase failed: " + "; ".join(bad))
    return res


# -- phase 28: control_flow ----------------------------------------------------------

def _cf_lm(mx, fused=False):
    """A two-layer LSTM word LM at rnn_lm's width over (bptt, batch)
    tokens (TNC): an Embedding, each layer a ``sym.contrib.foreach`` over
    an LSTM cell (gates i, f, g, o; no forget bias, as the ``RNN`` op), or
    with ``fused`` the ``RNN`` op; a FullyConnected decoder and
    SoftmaxOutput.  Every weight and begin state is declared.  Returns
    (the loss symbol, the top layer's outputs)."""
    sym = mx.sym
    T, N, V, H, L = LM_BPTT, LM_BATCH, LM_VOCAB, LM_WIDTH, LM_LAYERS
    with mx.name.NameManager():
        data = sym.Variable("data", shape=(T, N))
        label = sym.Variable("softmax_label", shape=(T, N))
        x = sym.Embedding(data, weight=sym.Variable("embed_weight",
                                                    shape=(V, H)),
                          input_dim=V, output_dim=H, name="embed")
        if fused:
            from mxnet_tpu_torch.ops.rnn import rnn_param_size

            P = rnn_param_size("lstm", L, H, H)
            x = sym.RNN(x, parameters=sym.Variable("rnn_params", shape=(P,)),
                        state=sym.Variable("rnn_h0", shape=(L, N, H)),
                        state_cell=sym.Variable("rnn_c0", shape=(L, N, H)),
                        state_size=H, num_layers=L, mode="lstm", name="rnn")
        else:
            for layer in range(L):
                w = {k: sym.Variable(f"l{layer}_{k}", shape=s) for k, s in (
                    ("i2h_weight", (4 * H, H)), ("i2h_bias", (4 * H,)),
                    ("h2h_weight", (4 * H, H)), ("h2h_bias", (4 * H,)))}

                def cell(x_t, states, w=w, layer=layer):
                    h, c = states
                    gates = sym.FullyConnected(
                        x_t, weight=w["i2h_weight"], bias=w["i2h_bias"],
                        num_hidden=4 * H, name=f"l{layer}_i2h") + \
                        sym.FullyConnected(
                            h, weight=w["h2h_weight"], bias=w["h2h_bias"],
                            num_hidden=4 * H, name=f"l{layer}_h2h")
                    i, f, g, o = sym.SliceChannel(gates, num_outputs=4,
                                                  axis=1,
                                                  name=f"l{layer}_gates")
                    c = sym.sigmoid(f) * c + sym.sigmoid(i) * sym.tanh(g)
                    h = sym.sigmoid(o) * sym.tanh(c)
                    return h, [h, c]

                x, _ = sym.contrib.foreach(
                    cell, x, [sym.Variable(f"l{layer}_h0", shape=(N, H)),
                              sym.Variable(f"l{layer}_c0", shape=(N, H))],
                    name=f"lstm{layer}")
        pred = sym.FullyConnected(
            sym.Reshape(x, shape=(-1, H)),
            weight=sym.Variable("pred_weight", shape=(V, H)),
            bias=sym.Variable("pred_bias", shape=(V,)), num_hidden=V,
            name="pred")
        loss = sym.SoftmaxOutput(pred, sym.Reshape(label, shape=(-1,)),
                                 name="softmax")
    return loss, x


def _cf_values(mx):
    """Seeded numpy arguments of both LMs: the fused ``RNN`` op's blob, and
    the same weights cut into the foreach cells' variables
    (``ops.rnn._unpack_params``)."""
    import torch

    from mxnet_tpu_torch.ops.rnn import _unpack_params, rnn_param_size

    T, N, V, H, L = LM_BPTT, LM_BATCH, LM_VOCAB, LM_WIDTH, LM_LAYERS
    rs = np.random.RandomState(SEED + 90)
    blob = rs.uniform(-0.08, 0.08, rnn_param_size("lstm", L, H, H)).astype(
        np.float32)
    common = {"data": rs.randint(0, V, (T, N)).astype(np.float32),
              "softmax_label": rs.randint(0, V, (T, N)).astype(np.float32),
              "embed_weight": (rs.randn(V, H) * 0.1).astype(np.float32),
              "pred_weight": (rs.randn(V, H) * 0.05).astype(np.float32),
              "pred_bias": np.zeros(V, np.float32)}
    Ws, Bs = _unpack_params(torch.from_numpy(blob), "lstm", L, H, H, False)
    cells = dict(common)
    for layer, ((wx, wh), (bx, bh)) in enumerate(zip(Ws, Bs)):
        cells.update({f"l{layer}_i2h_weight": wx.numpy().copy(),
                      f"l{layer}_h2h_weight": wh.numpy().copy(),
                      f"l{layer}_i2h_bias": bx.numpy().copy(),
                      f"l{layer}_h2h_bias": bh.numpy().copy(),
                      f"l{layer}_h0": np.zeros((N, H), np.float32),
                      f"l{layer}_c0": np.zeros((N, H), np.float32)})
    fused = dict(common, rnn_params=blob,
                 rnn_h0=np.zeros((L, N, H), np.float32),
                 rnn_c0=np.zeros((L, N, H), np.float32))
    return cells, fused


_CF_FIXED = ("data", "softmax_label")


def _cf_bind(mx, net, vals, ctx, train=True):
    req = {n: ("write" if train and n not in _CF_FIXED
               and not n.endswith(("_h0", "_c0")) else "null")
           for n in net.list_arguments()}
    ex = net.simple_bind(ctx=ctx, grad_req=req)
    for n, v in vals.items():
        if n in ex.arg_dict:
            ex.arg_dict[n][:] = v
    return ex


def _cf_step(ex):
    ex.forward(is_train=True)
    ex.backward()


def _cf_step_ms(ex, n):
    import torch

    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _cf_step(ex)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _cf_ln_symbol(mx):
    """A ``foreach`` over (bptt, batch, width) whose body applies LayerNorm
    to the step's input plus the state: one LayerNorm a step."""
    sym = mx.sym
    H = LM_WIDTH
    with mx.name.NameManager():
        gamma = sym.Variable("ln_gamma", shape=(H,))
        beta = sym.Variable("ln_beta", shape=(H,))
        outs, _ = sym.contrib.foreach(
            lambda x_t, st: (lambda h: (h, [h]))(sym.LayerNorm(
                x_t + st[0], gamma=gamma, beta=beta, name="ln")),
            sym.Variable("data", shape=(LM_BPTT, LM_BATCH, H)),
            [sym.Variable("h0", shape=(LM_BATCH, H))], name="ln_scan")
    return outs


def _cf_hybrid_block(mx):
    """A hybridized block whose forward runs ``F.contrib.while_loop`` (at
    most CF_HYB[2] masked steps, stopping after three) and
    ``F.contrib.cond`` on the card."""
    B, W, K = CF_HYB

    class Net(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.inp = mx.gluon.nn.Dense(W, in_units=W, flatten=False)
                self.step = mx.gluon.nn.Dense(W, in_units=W, flatten=False)

        def hybrid_forward(self, F, x, n0):
            outs, lv = F.contrib.while_loop(
                lambda a, n: n < 3.0,
                lambda a, n: ([F.tanh(self.step(a))],
                              [F.tanh(self.step(a)), n + 1.0]),
                [self.inp(x), n0], max_iterations=K)
            picked = F.contrib.cond(F.sum(lv[0]) > 0.0,
                                    lambda: lv[0] * 2.0,
                                    lambda: lv[0] - 1.0)
            return outs[0], picked, lv[1]

    return Net()


def _cf_hybrid(mx):
    """The while_loop/cond block on the card (three calls: captured and
    replayed) against the same block on the CPU; the captures it holds and
    the change in ``cached_op.UNCAPTURED``."""
    import torch

    from mxnet_tpu_torch.gluon import cached_op

    B, W, K = CF_HYB
    rs = np.random.RandomState(SEED + 91)
    x = rs.randn(B, W).astype(np.float32)
    vals = [(rs.randn(W, W) * 0.5).astype(np.float32),
            (rs.randn(W) * 0.1).astype(np.float32)] * 2
    outs = {}
    before = dict(cached_op.UNCAPTURED)
    captures = 0
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        net = _cf_hybrid_block(mx)
        net.initialize(ctx=ctx)
        for p, v in zip(net.collect_params().values(), vals):
            p.set_data(mx.nd.array(v, ctx=ctx))
        net.hybridize()
        for _ in range(3):
            got = net(mx.nd.array(x, ctx=ctx), mx.nd.zeros((1,), ctx=ctx))
        outs[name] = [g._data.cpu() for g in got]
        if name == "card":
            captures = sum(len(c) for prog in net._cached_ops.values()
                           for c in prog._captures.values())
    unc = {k: cached_op.UNCAPTURED[k] - before[k] for k in before}
    err = max(float((a - b).abs().max())
              for a, b in zip(outs["card"], outs["cpu"]))
    ok = all(_close(a, b, "float32")[0]
             for a, b in zip(outs["card"], outs["cpu"]))
    steps = float(outs["card"][2].reshape(-1)[0])
    return {"batch": B, "width": W, "max_iterations": K, "loop_steps": steps,
            "max_abs_err": err, "captures": captures, "uncaptured": unc}, \
        ([] if ok and captures > 0 and not any(unc.values()) and steps == 3
         else [f"hybridized while_loop/cond: card vs CPU {err} (within TOL: "
               f"{ok}), captures {captures}, uncaptured {unc}, loop steps "
               f"{steps}"])


def phase_control_flow(dev, rnn_lm=None):
    """Path B (control flow): a two-layer LSTM word LM of
    ``sym.contrib.foreach`` cells at rnn_lm's width (LM_*), its weights
    declared, through the executor on the card.  Checks: (a) one training
    forward + backward, loss and every gradient card against CPU
    (normwise 1e-4, the loss 1e-5); (b) its top-layer outputs and loss
    against the fused ``RNN`` op's given the same weights (TOL float32);
    (c) a ``foreach`` body of LayerNorm over the 650-wide state launches
    kernel 5 LM_BPTT times a forward, and its outputs match the plain
    version's loop on the card (TOL float32); (d) a hybridized block's
    ``while_loop`` and ``cond`` on the card against the CPU, captured as
    CUDA graphs (``cached_op.UNCAPTURED`` unchanged); (e) the foreach LM
    saved and loaded (``sym.save``/``sym.load``) gives the same JSON and
    bitwise the same outputs.  Numbers: step ms of the foreach LM and of
    the ``RNN``-op LM (forward + backward through the executor, median
    of CF_STEPS after one), beside rnn_lm's Gluon step where it ran."""
    import gc

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.layer_norm import layer_norm_reference

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    gc.collect()
    bad = []
    net, top = _cf_lm(mx)
    fused_net, fused_top = _cf_lm(mx, fused=True)
    cells, fused_vals = _cf_values(mx)
    # the main path: timed foreach LM steps and LayerNorm-body forwards
    ex = _cf_bind(mx, net, cells, mx.gpu(0))
    _cf_step(ex)
    ln_net = _cf_ln_symbol(mx)
    rs = np.random.RandomState(SEED + 92)
    ln_vals = {"data": rs.randn(LM_BPTT, LM_BATCH, LM_WIDTH).astype(
        np.float32), "h0": np.zeros((LM_BATCH, LM_WIDTH), np.float32),
        "ln_gamma": (1 + 0.1 * rs.randn(LM_WIDTH)).astype(np.float32),
        "ln_beta": (0.1 * rs.randn(LM_WIDTH)).astype(np.float32)}
    ln_ex = _cf_bind(mx, ln_net, ln_vals, mx.gpu(0), train=False)
    torch.cuda.synchronize()
    _reset_launches()
    ms = _cf_step_ms(ex, CF_STEPS)
    for _ in range(CF_LN_FORWARDS):
        ln_out = ln_ex.forward(is_train=False)[0]._data.clone()
    torch.cuda.synchronize()
    launches = _read_launches()
    # (c) the LayerNorm body against the plain version's loop
    with torch.no_grad():
        h = torch.from_numpy(ln_vals["h0"]).to(ln_out.device)
        g, b = (torch.from_numpy(ln_vals[k]).to(ln_out.device)
                for k in ("ln_gamma", "ln_beta"))
        x = torch.from_numpy(ln_vals["data"]).to(ln_out.device)
        plain = []
        for t in range(LM_BPTT):
            h = layer_norm_reference(x[t] + h, g, b, 1e-5)
            plain.append(h)
        plain = torch.stack(plain)
    ln_ok, ln_err, _ = _close(ln_out, plain, "float32")
    # (a) card against CPU
    card = (_ce(ex.outputs[0], mx.nd.array(cells["softmax_label"].reshape(
        -1))), {n: g._data.float().cpu() for n, g in ex.grad_dict.items()})
    cpu_ex = _cf_bind(mx, net, cells, mx.cpu())
    _cf_step(cpu_ex)
    cpu = (_ce(cpu_ex.outputs[0], mx.nd.array(
        cells["softmax_label"].reshape(-1), ctx=mx.cpu())),
        {n: g._data.float() for n, g in cpu_ex.grad_dict.items()})
    del cpu_ex
    grad_err = {n: _rel(card[1][n], cpu[1][n]) for n in cpu[1]}
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    if loss_err > 1e-5 or max(grad_err.values()) > 1e-4:
        bad.append(f"foreach LM card vs CPU: loss {card[0]} / {cpu[0]}, "
                   f"gradients {grad_err}")
    # (b) against the fused RNN op, and its step time
    fused_ex = _cf_bind(mx, fused_net, fused_vals, mx.gpu(0))
    fused_ms = _cf_step_ms(fused_ex, CF_STEPS + 1)[1:]
    fused_loss = _ce(fused_ex.outputs[0], mx.nd.array(
        cells["softmax_label"].reshape(-1)))
    del fused_ex
    tops = [_bound_outputs(s, {k: v for k, v in vals.items()
                               if k in s.list_arguments()}, dev)[0]
            for s, vals in ((top, cells), (fused_top, fused_vals))]
    top_ok, top_err, _ = _close(torch.from_numpy(tops[0]),
                                torch.from_numpy(tops[1]), "float32")
    fused_loss_err = abs(card[0] - fused_loss) / abs(fused_loss)
    if not top_ok or fused_loss_err > 1e-5:
        bad.append(f"foreach LSTM vs the RNN op: outputs {top_err}, loss "
                   f"{card[0]} / {fused_loss}")
    # (e) saved and loaded
    path = os.path.join("build", "control_flow", "foreach_lm-symbol.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    net.save(path)
    loaded = mx.sym.load(path)
    lex = _cf_bind(mx, loaded, cells, mx.gpu(0), train=False)
    same_json = loaded.tojson() == net.tojson()
    a = ex.forward(is_train=False)[0]._data
    bitwise = bool(torch.equal(a, lex.forward(is_train=False)[0]._data))
    del lex
    if not (same_json and bitwise):
        bad.append(f"saved and loaded foreach LM: same JSON {same_json}, "
                   f"bitwise outputs {bitwise}")
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    hyb, hyb_bad = _cf_hybrid(mx)
    bad += hyb_bad
    want_ln = LM_BPTT * CF_LN_FORWARDS
    res = {"phase": "control_flow",
           "config": {"vocab": LM_VOCAB, "width": LM_WIDTH,
                      "layers": LM_LAYERS, "bptt": LM_BPTT,
                      "batch": LM_BATCH, "cells": "sym.contrib.foreach"},
           "foreach_step_ms": ms, "foreach_steady_ms":
           float(np.median(ms[1:])), "rnn_op_step_ms": fused_ms,
           "rnn_op_steady_ms": float(np.median(fused_ms)),
           "rnn_lm_gluon_steady_ms": (rnn_lm or {}).get("steady_step_ms"),
           "card_vs_cpu": {"loss": [card[0], cpu[0]],
                           "grad_rel_err": grad_err},
           "vs_rnn_op": {"top_max_abs_err": top_err,
                         "loss": [card[0], fused_loss]},
           "layer_norm_body": {"forwards": CF_LN_FORWARDS,
                               "launches": launches["layer_norm"],
                               "per_forward": launches["layer_norm"]
                               / CF_LN_FORWARDS, "max_abs_err": ln_err},
           "saved_loaded": {"same_json": same_json, "bitwise": bitwise},
           "hybridized": hyb, "launches": launches}
    emit(res)
    if launches["layer_norm"] != want_ln or not ln_ok:
        bad.append(f"LayerNorm body: {launches['layer_norm']} launches, "
                   f"expected {want_ln}; against the plain loop {ln_err}")
    others = {k: v for k, v in launches.items() if k != "layer_norm" and v}
    if others:
        bad.append(f"other kernels launched: {others}")
    if bad:
        raise SystemExit("control_flow phase failed: " + "; ".join(bad))
    return res


# -- phase 16: image_rec -------------------------------------------------------------

def _write_rec(path):
    """A RAW0 RecordIO file of REC_IMAGES random REC_STORED² RGB images
    with labels below RESNET_CLASSES (about 250 MB at 1,280 of 256²)."""
    import struct

    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(SEED)
    side = REC_STORED
    head = b"RAW0" + struct.pack("<I", 3) + \
        np.asarray((side, side, 3), np.int32).tobytes()
    w = mx.recordio.MXRecordIO(path, "w")
    for i in range(REC_IMAGES):
        img = rs.randint(0, 256, (side, side, 3), dtype=np.uint8)
        w.write(mx.recordio.pack(mx.recordio.IRHeader(
            0, float(rs.randint(RESNET_CLASSES)), i, 0), head + img.tobytes()))
    w.close()


def _rec_iter(mx, path, **kw):
    args = dict(path_imgrec=path, data_shape=(3, RESNET_HW, RESNET_HW),
                batch_size=REC_BATCH, resize=REC_STORED, rand_crop=True,
                rand_mirror=True, mean_r=REC_MEAN[0], mean_g=REC_MEAN[1],
                mean_b=REC_MEAN[2], preprocess_threads=REC_THREADS, seed=SEED)
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def _rec_card_vs_cpu(mx, path):
    """One epoch at B=REC_CHECK_BATCH on one thread (deterministic) under
    the card's context and under the CPU's: every batch bitwise, and the
    trailing batch's pad exact."""
    import torch

    epochs = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            it = _rec_iter(mx, path, batch_size=REC_CHECK_BATCH,
                           preprocess_threads=1)
            epochs[name] = [(b.data[0]._data.cpu(), b.label[0]._data.cpu(),
                             b.pad, b.data[0]._data.device.type)
                            for b in it]
            it.close()
    card, cpu = epochs["card"], epochs["cpu"]
    want_pads = [0] * (REC_IMAGES // REC_CHECK_BATCH) + (
        [REC_CHECK_BATCH - REC_IMAGES % REC_CHECK_BATCH]
        if REC_IMAGES % REC_CHECK_BATCH else [])
    same = len(card) == len(cpu) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(card, cpu))
    res = {"B": REC_CHECK_BATCH, "batches": len(card), "bitwise": same,
           "pads": [b[2] for b in card], "devices": sorted(
               {b[3] for b in card} | {b[3] for b in cpu})}
    bad = []
    if not same:
        bad.append("ImageRecordIter: the card's batches differ from the "
                   "CPU's")
    if res["pads"] != want_pads or [b[2] for b in cpu] != want_pads:
        bad.append(f"pads {res['pads']}, expected {want_pads}")
    if res["devices"] != ["cpu", "cuda"]:
        bad.append(f"batch devices {res['devices']}")
    return res, bad


def _rec_throughput(mx, path):
    """The iterator alone on REC_THREADS threads at B=REC_BATCH: images/s of
    the second epoch (batches on the card, normalized, then a sync)."""
    import torch

    it = _rec_iter(mx, path)
    rates = []
    for _ in range(2):
        it.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(b.data[0].shape[0] - b.pad for b in it)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    it.close()
    return {"threads": REC_THREADS, "B": REC_BATCH, "images_per_s": rates}


def _rec_fit(mx, path):
    """``Module.fit`` on the example ResNet-50 symbol (f32, NCHW, SGD as
    module_fit's) fed by the iterator for REC_FIT_BATCHES batches: ms a
    batch (a sync, then the host clock, in the batch-end callback)."""
    import torch

    net, _, _ = _fit_loaded_symbol()
    feed = _rec_iter(mx, path)
    it = mx.io.ResizeIter(feed, REC_FIT_BATCHES)
    mod = mx.mod.Module(net, label_names=["softmax_label"])
    marks, losses = [], []

    def timing(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(_ce(param.locals["self"].get_outputs()[0],
                          param.locals["data_batch"].label[0]))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore="tpu_sync", optimizer="sgd",
            optimizer_params={"learning_rate": FIT_LR,
                              "momentum": FIT_MOMENTUM},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=timing)
    feed.close()
    ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
    res = {"batches": len(marks), "step_ms": ms,
           "steady_ms": float(np.median(ms[1:])), "losses": losses,
           "fused_steps": mod._fused_step_count}
    bad = []
    if len(marks) != REC_FIT_BATCHES or not np.all(np.isfinite(losses)):
        bad.append(f"fit over ImageRecordIter: {len(marks)} batches, "
                   f"losses {losses}")
    return res, bad


def phase_image_rec(dev, module_fit=None):
    """Path C: ``ImageRecordIter`` over a RAW0 ``.rec`` of REC_IMAGES
    images (``train_imagenet``'s settings: resize 256, random 224 crops and
    mirrors, its mean) on REC_THREADS host threads, uint8 to the card and
    normalized there.  Checks: one-thread batches card = CPU bitwise with
    an exact trailing pad; fit batches finite.  Numbers: the iterator's
    images/s alone; ``Module.fit``'s ms a batch on the example ResNet-50
    symbol fed by it, beside module_fit's ``NDArrayIter`` figure when that
    phase ran."""
    import gc
    import os
    import tempfile

    import torch

    import mxnet_tpu_torch as mx

    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.rec")
        t0 = time.perf_counter()
        _write_rec(path)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        check, bad = _rec_card_vs_cpu(mx, path)
        rate = _rec_throughput(mx, path)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        fit, bad_fit = _rec_fit(mx, path)
        launches = _read_launches()
    res = {"phase": "image_rec",
           "config": {"images": REC_IMAGES, "stored": [REC_STORED] * 2,
                      "data_shape": [3, RESNET_HW, RESNET_HW],
                      "resize": REC_STORED, "rand_crop": True,
                      "rand_mirror": True, "mean": list(REC_MEAN),
                      "batch": REC_BATCH, "threads": REC_THREADS},
           "rec_bytes": size, "write_s": write_s, "card_vs_cpu": check,
           "iterator": rate, "fit": fit,
           "module_fit_ndarrayiter_ms": (module_fit or {}).get(
               "fit", {}).get("steady_step_ms"),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    emit(res)
    bad += bad_fit
    if any(launches.values()):
        bad.append(f"the NCHW fit launched port kernels: {launches}")
    if bad:
        raise SystemExit("image_rec phase failed: " + "; ".join(bad))
    return res


# -- phase 29: image_iter ------------------------------------------------------------

def _write_indexed_rec(path, n, side, channels, seed, sample=None):
    """An indexed RAW0 RecordIO file (its ``.idx`` beside it) of ``n``
    ``side``² images of ``channels`` channels: ``sample(i, rs)`` gives
    each (uint8 image, label) (default: random pixels and a label below
    RESNET_CLASSES)."""
    import struct

    import mxnet_tpu_torch as mx

    def noise(i, rs):
        return (rs.randint(0, 256, (side, side, channels), dtype=np.uint8),
                float(rs.randint(RESNET_CLASSES)))

    rs = np.random.RandomState(seed)
    head = b"RAW0" + struct.pack("<I", 3) + \
        np.asarray((side, side, channels), np.int32).tobytes()
    w = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img, lab = (sample or noise)(i, rs)
        w.write_idx(i, mx.recordio.pack(mx.recordio.IRHeader(0, lab, i, 0),
                                        head + img.tobytes()))
    w.close()


def _ii_iter(mx, path, **kw):
    """``ImageRecordIter``'s ImageIter route at image_rec's settings."""
    args = dict(path_imgrec=path, data_shape=(3, RESNET_HW, RESNET_HW),
                batch_size=REC_BATCH, resize=REC_STORED, rand_crop=True,
                rand_mirror=True, mean_r=REC_MEAN[0], mean_g=REC_MEAN[1],
                mean_b=REC_MEAN[2], use_native=False)
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def _ii_card_vs_cpu(mx, rgb, gray):
    """The first II_CHECK_BATCHES batches (B = 32) of the RGB iterator and
    of a C = 1 one, under the card's context and the CPU's, Python's and
    numpy's streams seeded alike: bitwise equal, each on its device."""
    import random

    import torch

    gray_shape = (1, II_GRAY_HW - 8, II_GRAY_HW - 8)
    epochs = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        got = []
        for path, kw in ((rgb, {}), (gray, {"data_shape": gray_shape,
                                            "resize": 0, "mean_r": 0.0,
                                            "mean_g": 0.0, "mean_b": 0.0})):
            random.seed(SEED)
            np.random.seed(SEED)
            with ctx:
                it = _ii_iter(mx, path, batch_size=32, **kw)
                for _ in range(II_CHECK_BATCHES):
                    b = it.next()
                    got.append((b.data[0]._data.cpu(), b.label[0]._data.cpu(),
                                b.data[0]._data.device.type))
        epochs[name] = got
    card, cpu = epochs["card"], epochs["cpu"]
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(card, cpu))
    res = {"B": 32, "batches": len(card), "bitwise": same,
           "shapes": [list(b[0].shape) for b in card],
           "devices": sorted({b[2] for b in card} | {b[2] for b in cpu})}
    bad = []
    if not same:
        bad.append("ImageIter route: the card's batches differ from the CPU's")
    if res["shapes"][-1] != [32, *gray_shape]:
        bad.append(f"C = 1 batches of shape {res['shapes'][-1]}")
    if res["devices"] != ["cpu", "cuda"]:
        bad.append(f"batch devices {res['devices']}")
    return res, bad


def _ii_rate(mx, path):
    """The ImageIter route alone at B = REC_BATCH: images/s over
    II_RATE_BATCHES batches on the card."""
    import torch

    it = _ii_iter(mx, path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(it.next().data[0].shape[0] for _ in range(II_RATE_BATCHES))
    torch.cuda.synchronize()
    return {"B": REC_BATCH, "images": n,
            "images_per_s": n / (time.perf_counter() - t0)}


def _ii_gluon(mx, path):
    """``ImageRecordDataset`` + ``transforms.Compose([RandomResizedCrop,
    RandomFlipLeftRight, ToTensor, Normalize])`` + ``DataLoader(batch_size
    =II_BATCH)``: the feed alone (images/s), then II_STEPS Gluon ResNet-50
    v1 steps fed by it (NCHW batches transposed to channels-last, f32, SGD
    as gluon_training's): ms a step and each step's kernel launches.  The
    feed's transforms compute on the card; its first batch is held against
    the CPU's under the same seeds (rtol 1e-5, atol 1e-5)."""
    import random

    import torch

    from mxnet_tpu_torch import autograd, gluon

    T = gluon.data.vision.transforms
    ctx = mx.gpu(0)

    def loader():
        random.seed(SEED)
        np.random.seed(SEED)
        ds = gluon.data.vision.ImageRecordDataset(path).transform_first(
            T.Compose([T.RandomResizedCrop(RESNET_HW), T.RandomFlipLeftRight(),
                       T.ToTensor(), T.Normalize(II_MEAN, II_STD)]))
        return iter(gluon.data.DataLoader(ds, batch_size=II_BATCH,
                                          last_batch="discard"))

    first = {}
    for name, c in (("cpu", mx.cpu()), ("card", ctx)):
        with c:
            x, y = next(loader())
            first[name] = (x._data.cpu(), y._data.cpu(), x._data.device.type)
    feed_err = float((first["card"][0] - first["cpu"][0]).abs().max())
    feed_same = first["card"][2] == "cuda" and bool(torch.allclose(
        first["card"][0], first["cpu"][0], rtol=1e-5, atol=1e-5)) and \
        torch.equal(first["card"][1], first["cpu"][1])
    with ctx:
        feed = loader()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(next(feed)[0].shape[0] for _ in range(II_STEPS))
        torch.cuda.synchronize()
        feed_rate = n / (time.perf_counter() - t0)
        torch.manual_seed(SEED)
        net = gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES,
                                                 layout="NHWC")
        net.initialize(mx.init.Xavier(), ctx=ctx)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": RESNET_LR,
                                 "momentum": RESNET_MOMENTUM, "wd": 1e-4})
        feed = loader()
        step_ms, losses, per_step = [], [], []
        for _ in range(II_STEPS):
            x, y = next(feed)
            # channels-last, laid out so (a permuted view would reach
            # the first BatchNorm non-contiguous)
            x = mx.nd.NDArray(x._data.permute(0, 2, 3, 1).contiguous())
            y = y.as_in_context(ctx)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _reset_launches()
            with autograd.record():
                L = loss_fn(net(x), y)
            L.backward()
            trainer.step(x.shape[0])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            per_step.append(_read_launches())
            losses.append(L.mean().asscalar().item())
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}
    res = {"B": II_BATCH, "steps": II_STEPS, "feed_images_per_s": feed_rate,
           "first_batch_card_vs_cpu": {"max_abs_err": feed_err,
                                       "within_1e-5": feed_same},
           "step_ms": step_ms, "steady_step_ms": float(np.median(step_ms[1:])),
           "losses": losses, "launches_per_step": per_step[0],
           "launches": launches}
    want = {k: 0 for k in per_step[0]}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    bad = []
    off = [s for s in per_step if s != want]
    if off:
        bad.append(f"{len(off)} dataset-fed steps launched other counts than "
                   f"{want}, the first {off[0]}")
    if not all(np.isfinite(losses)):
        bad.append(f"dataset-fed steps: non-finite loss {losses}")
    if not feed_same:
        bad.append(f"the vision feed's first batch on the card against the "
                   f"CPU's: {res['first_batch_card_vs_cpu']}")
    return res, bad


def phase_image_iter(dev):
    """Path A: the Python image pipeline into a training step.  An indexed
    RAW0 ``.rec`` of II_IMAGES images at REC_STORED² (and a C = 1 one)
    through ``ImageRecordIter(use_native=False)`` (``image.ImageIter``:
    resize, random crops and mirrors on the host, Python's ``random``):
    the first batches on the card bitwise the CPU's under the same seeds,
    and its images/s alone; then ``gluon.data.vision.ImageRecordDataset``
    with transforms through a ``DataLoader`` feeding Gluon ResNet-50 v1
    steps in channels-last: images/s of the feed alone, ms a step, and
    53 + 53 BatchNorm launches a step (kernels 3 and 4)."""
    import gc
    import os
    import tempfile

    import torch

    import mxnet_tpu_torch as mx

    gc.collect()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rgb = os.path.join(tmp, "train.rec")
            gray = os.path.join(tmp, "gray.rec")
            t0 = time.perf_counter()
            _write_indexed_rec(rgb, II_IMAGES, REC_STORED, 3, SEED)
            _write_indexed_rec(gray, II_GRAY, II_GRAY_HW, 1, SEED + 1)
            write_s = time.perf_counter() - t0
            check, bad = _ii_card_vs_cpu(mx, rgb, gray)
            rate = _ii_rate(mx, rgb)
            torch.cuda.reset_peak_memory_stats()
            fit, bad_fit = _ii_gluon(mx, rgb)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    res = {"phase": "image_iter",
           "config": {"images": II_IMAGES, "stored": [REC_STORED] * 2,
                      "data_shape": [3, RESNET_HW, RESNET_HW],
                      "resize": REC_STORED, "rand_crop": True,
                      "rand_mirror": True, "mean": list(REC_MEAN),
                      "gray": [II_GRAY, II_GRAY_HW], "dataset_batch": II_BATCH,
                      "model": "resnet50_v1", "layout": "NHWC"},
           "write_s": write_s, "card_vs_cpu": check, "image_iter": rate,
           "dataset_fit": fit, "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": fit["launches"]}
    emit(res)
    bad += bad_fit
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise SystemExit("image_iter phase failed: " + "; ".join(bad))
    return res


# -- phase 30: ssd_fit ---------------------------------------------------------------

def _toy_ssd(mx, num_classes, num_anchors):
    """example/ssd/train.py's ToySSD, its NDArray methods as ``nd`` calls
    (the port's blocks compute on tensors)."""
    gluon, nn, nd = mx.gluon, mx.gluon.nn, mx.nd

    class ToySSD(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.body = nn.Sequential()
                for f in (16, 32, 64):
                    self.body.add(nn.Conv2D(f, 3, padding=1, strides=2,
                                            activation="relu"))
                self.cls_head = nn.Conv2D(num_anchors * (num_classes + 1), 3,
                                          padding=1)
                self.loc_head = nn.Conv2D(num_anchors * 4, 3, padding=1)

        def forward(self, x):
            feat = self.body(x)
            B = x.shape[0]
            cls = nd.reshape(nd.transpose(self.cls_head(feat),
                                          axes=(0, 2, 3, 1)),
                             shape=(B, -1, num_classes + 1))
            loc = nd.reshape(nd.transpose(self.loc_head(feat),
                                          axes=(0, 2, 3, 1)), shape=(B, -1))
            return [feat], cls, loc

    return ToySSD()


def _resnet_ssd(mx, num_classes):
    """SSD over ``resnet50_v1``'s features (channels-last): class and box
    heads (3 x 3 convolutions) on the stride-16 map (the third stage's
    output) and the stride-32 map (the fourth's), anchors per SSD_SCALES."""
    gluon, nn, nd = mx.gluon, mx.gluon.nn, mx.nd
    zoo = gluon.model_zoo.vision.resnet50_v1(classes=num_classes,
                                             layout="NHWC")
    stages = list(zoo.features._children.values())

    class ResNetSSD(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.stage16 = nn.HybridSequential()
                self.stage16.add(*stages[:7])
                self.stage32 = stages[7]
                self.heads = nn.Sequential()
                for sizes, ratios in SSD_SCALES:
                    a = len(sizes) + len(ratios) - 1
                    self.heads.add(nn.Conv2D(a * (num_classes + 1), 3,
                                             padding=1, layout="NHWC"),
                                   nn.Conv2D(a * 4, 3, padding=1,
                                             layout="NHWC"))

        def forward(self, x):
            f16 = self.stage16(x)
            f32 = self.stage32(f16)
            heads = list(self.heads._children.values())
            B = x.shape[0]
            cls, loc = [], []
            for i, f in enumerate((f16, f32)):
                cls.append(nd.reshape(heads[2 * i](f),
                                      shape=(B, -1, num_classes + 1)))
                loc.append(nd.reshape(heads[2 * i + 1](f), shape=(B, -1)))
            # MultiBoxPrior reads (H, W) from an NCHW shape
            feats = [nd.transpose(f, axes=(0, 3, 1, 2)) for f in (f16, f32)]
            return feats, nd.concat(*cls, dim=1), nd.concat(*loc, dim=1)

    return ResNetSSD()


def _ssd_anchors(mx, feats, scales):
    nd = mx.nd
    return nd.concat(*[nd.contrib.MultiBoxPrior(f, sizes=s, ratios=r)
                       for f, (s, r) in zip(feats, scales)], dim=1)


def _ssd_step(mx, net, trainer, x, y, scales):
    """example/ssd/train.py's step: anchors, targets, softmax
    cross-entropy + Huber, backward, Adam; the two losses' means."""
    from mxnet_tpu_torch import autograd, gluon

    nd = mx.nd
    with autograd.record():
        feats, cls_preds, loc_preds = net(x)
        anchors = _ssd_anchors(mx, feats, scales)
        loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
            anchors, y, nd.transpose(cls_preds, axes=(0, 2, 1)))
        l_cls = gluon.loss.SoftmaxCrossEntropyLoss()(cls_preds, cls_t)
        l_loc = gluon.loss.HuberLoss()(loc_preds * loc_m, loc_t * loc_m)
        L = l_cls + l_loc
    L.backward()
    trainer.step(x.shape[0])
    return l_cls.mean().asscalar().item(), l_loc.mean().asscalar().item()


def _ssd_detect(mx, net, x, scales, **kw):
    nd = mx.nd
    feats, cls_preds, loc_preds = net(x)
    anchors = _ssd_anchors(mx, feats, scales)
    probs = nd.transpose(nd.softmax(cls_preds, axis=-1), axes=(0, 2, 1))
    return probs, loc_preds, anchors, nd.contrib.MultiBoxDetection(
        probs, loc_preds, anchors, **kw)


def _ssd_toy_sample(hw):
    """example/ssd/train.py's synthetic image (one square in its class's
    channel, 0 or 255) and its label packed by ``ImageDetIter``."""
    import mxnet_tpu_torch as mx

    def sample(i, rs):
        img = np.zeros((hw, hw, 3), np.uint8)
        cls = rs.randint(0, 2)
        s = rs.randint(hw // 4, hw // 2)
        l, t = rs.randint(0, hw - s), rs.randint(0, hw - s)
        img[t:t + s, l:l + s, cls] = 255
        return img, mx.image.ImageDetIter.pack_label(
            [[cls, l / hw, t / hw, (l + s) / hw, (t + s) / hw]])

    return sample


def _ssd_hybridized(mx, probs, loc, anchors, eager, images):
    """Hybridized blocks on the card whose forwards read the card: one
    runs ``MultiBoxDetection`` (its NMS's greedy pass), one
    ``nd.image.random_color_jitter`` (its order).  Each program runs
    uncaptured (``cached_op.UNCAPTURED``: one program, three calls); the
    detections are the eager call's bitwise, the jittered images finite
    float32 of the input's shape."""
    import torch

    from mxnet_tpu_torch.gluon import cached_op

    class Detect(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, p, l, a):
            return F.contrib.MultiBoxDetection(p, l, a, nms_threshold=0.45)

    class Jitter(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.image.random_color_jitter(x, brightness=0.3,
                                               contrast=0.3, saturation=0.3,
                                               hue=0.1)

    res, bad = {}, []
    for name, blk, args in (("MultiBoxDetection", Detect(),
                             (probs, loc, anchors)),
                            ("random_color_jitter", Jitter(), (images,))):
        blk.hybridize()
        before = dict(cached_op.UNCAPTURED)
        outs = [blk(*args)._data for _ in range(3)]
        unc = {k: cached_op.UNCAPTURED[k] - before[k] for k in before}
        if name == "MultiBoxDetection":
            same = all(torch.equal(o, eager._data) for o in outs)
        else:
            same = all(o.shape == images.shape and o.dtype == torch.float32
                       and bool(torch.isfinite(o).all()) for o in outs)
        res[name] = {"uncaptured": unc, "as_expected": same}
        if unc != {"programs": 1, "calls": 3} or not same:
            bad.append(f"hybridized {name}: {res[name]}")
    return res, bad


def _ssd_toy_card_vs_cpu(mx, rec):
    """ToySSD at the example's settings fed by ``ImageDetIter`` (pixels
    scaled to [0, 1]): SSD_TOY_STEPS steps on the card and on the CPU from
    the same weights (the card's Xavier draw copied), then
    ``MultiBoxDetection`` on the next batch; losses and detections within
    SSD_RTOL, the same rows kept."""
    import torch

    scales = (((0.3, 0.6, 0.9), (1.0, 2.0)),)
    A = len(scales[0][0]) + len(scales[0][1]) - 1
    out, weights = {}, None
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            it = mx.image.ImageDetIter(
                SSD_TOY_BATCH, (3, SSD_TOY_HW, SSD_TOY_HW), path_imgrec=rec,
                max_objects=1, mean=(0.0, 0.0, 0.0),
                std=(255.0, 255.0, 255.0))
            batches = [it.next() for _ in range(SSD_TOY_STEPS + 1)]
            net = _toy_ssd(mx, 2, A)
            torch.manual_seed(SEED)
            net.initialize(mx.init.Xavier(), ctx=ctx)
            net(batches[0].data[0])
            params = net.collect_params().values()
            if weights is None:
                weights = [p.data()._data.cpu().clone() for p in params]
            else:
                for p, w in zip(params, weights):
                    p.set_data(mx.nd.array(w))
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": SSD_LR})
            losses = [_ssd_step(mx, net, trainer, b.data[0], b.label[0],
                                scales) for b in batches[:-1]]
            probs, loc, anchors, det = _ssd_detect(
                mx, net, batches[-1].data[0], scales, nms_threshold=0.45)
            out[name] = (losses, det._data.cpu())
            if name == "card":
                hyb, bad_hyb = _ssd_hybridized(mx, probs, loc, anchors, det,
                                               batches[-1].data[0])
    (lc, dc), (lp, dp) = out["card"], out["cpu"]
    loss_ok = np.allclose(np.asarray(lc), np.asarray(lp), rtol=SSD_RTOL,
                          atol=1e-6)
    kept_same = bool(torch.equal(dc[..., 0], dp[..., 0]))
    det_err = float((dc - dp).abs().max())
    det_ok = kept_same and bool(torch.allclose(dc, dp, rtol=SSD_RTOL,
                                               atol=1e-5))
    res = {"B": SSD_TOY_BATCH, "hw": SSD_TOY_HW, "steps": SSD_TOY_STEPS,
           "losses_card": lc, "losses_cpu": lp,
           "kept": int((dc[..., 0] >= 0).sum()), "kept_same": kept_same,
           "det_max_abs_err": det_err, "hybridized": hyb}
    bad = bad_hyb
    if not loss_ok:
        bad.append(f"ToySSD losses card {lc} against CPU {lp}")
    if not det_ok:
        bad.append(f"ToySSD detections: same kept rows {kept_same}, max "
                   f"error {det_err}")
    return res, bad


def _ssd_full(mx, rec):
    """The full-width leg on the card: ResNet-50 SSD at SSD_HW², B =
    SSD_BATCH, SSD_CLASSES classes, fed by ``ImageDetIter`` (ImageNet mean
    and std): ms a step and its kernel launches, ``MultiBoxTarget`` and
    ``MultiBoxDetection`` (nms_topk SSD_TOPK) alone, peak bytes."""
    import torch

    ctx = mx.gpu(0)
    nd = mx.nd
    with ctx:
        it = mx.image.ImageDetIter(SSD_BATCH, (3, SSD_HW, SSD_HW),
                                   path_imgrec=rec, max_objects=3, mean=True,
                                   std=True)
        net = _resnet_ssd(mx, SSD_CLASSES)
        torch.manual_seed(SEED)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": SSD_LR})
        torch.cuda.reset_peak_memory_stats()
        step_ms, data_ms, losses, per_step = [], [], [], []
        for _ in range(SSD_STEPS):
            t0 = time.perf_counter()
            b = it.next()
            x = nd.NDArray(b.data[0]._data.permute(0, 2, 3, 1).contiguous())
            y = b.label[0]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _reset_launches()
            losses.append(_ssd_step(mx, net, trainer, x, y, SSD_SCALES))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            per_step.append(_read_launches())
            data_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        with mx.autograd.pause():
            probs, loc, anchors, det = _ssd_detect(
                mx, net, x, SSD_SCALES, nms_threshold=0.45, nms_topk=SSD_TOPK)
            target_ms = _event_ms(lambda: nd.contrib.MultiBoxTarget(
                anchors, y, probs)[2].wait_to_read(), 5)
            # a few steps in, the net calls nearly every anchor background
            # (no score above 0.01: an empty NMS); time the NMS at its
            # heaviest on seeded class probabilities where every anchor
            # passes the threshold
            gen = torch.Generator(device=probs._data.device).manual_seed(SEED)
            busy = nd.NDArray(torch.softmax(torch.randn(
                probs.shape, generator=gen, device=probs._data.device), 1))
            busy_det = nd.contrib.MultiBoxDetection(
                busy, loc, anchors, nms_threshold=0.45, nms_topk=SSD_TOPK)
            detect_ms = _event_ms(lambda: nd.contrib.MultiBoxDetection(
                busy, loc, anchors, nms_threshold=0.45,
                nms_topk=SSD_TOPK).wait_to_read(), 5)
        kept = int((det._data[..., 0] >= 0).sum())
        busy_kept = int((busy_det._data[..., 0] >= 0).sum())
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}
    res = {"B": SSD_BATCH, "hw": SSD_HW, "classes": SSD_CLASSES,
           "anchors": int(anchors.shape[1]), "steps": SSD_STEPS,
           "step_ms": step_ms, "steady_step_ms": float(np.median(step_ms[1:])),
           "data_ms": data_ms, "losses": losses,
           "multibox_target_ms": target_ms,
           "multibox_detection_ms": detect_ms, "nms_topk": SSD_TOPK,
           "kept": kept, "timed_detection_kept": busy_kept,
           "peak_bytes": peak,
           "launches_per_step": per_step[0], "launches": launches}
    want = {k: 0 for k in per_step[0]}
    want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
    bad = []
    off = [s for s in per_step if s != want]
    if off:
        bad.append(f"{len(off)} ResNet-50 SSD steps launched other counts "
                   f"than {want}, the first {off[0]}")
    if not np.all(np.isfinite(losses)):
        bad.append(f"ResNet-50 SSD: non-finite losses {losses}")
    if tuple(det.shape) != (SSD_BATCH, res["anchors"], 6) or \
            not bool(torch.isfinite(det._data).all()) or busy_kept == 0:
        bad.append(f"ResNet-50 SSD detections {tuple(det.shape)}, finite "
                   f"{bool(torch.isfinite(det._data).all())}; "
                   f"{busy_kept} kept of the timed call")
    return res, bad


def phase_ssd_fit(dev):
    """Path B: detection.  ``ImageDetIter`` over detection ``.rec`` files
    feeds example/ssd/train.py's loop (MultiBoxPrior, MultiBoxTarget,
    softmax cross-entropy + Huber, Adam) and ``MultiBoxDetection`` with its
    NMS: the ToySSD card against the CPU, then the ResNet-50 SSD at full
    width (53 + 53 BatchNorm launches a step)."""
    import gc
    import os
    import tempfile

    import torch

    import mxnet_tpu_torch as mx

    gc.collect()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False

    def voc_sample(i, rs):
        """Random pixels and one to three boxes of the 20 classes."""
        n = 1 + rs.randint(3)
        lo = rs.uniform(0.0, 0.6, (n, 2))
        size = rs.uniform(0.1, 0.4, (n, 2))
        objs = np.concatenate([rs.randint(0, SSD_CLASSES, (n, 1)), lo,
                               np.minimum(lo + size, 1.0)], 1)
        img = rs.randint(0, 256, (SSD_HW, SSD_HW, 3), dtype=np.uint8)
        return img, mx.image.ImageDetIter.pack_label(objs)

    try:
        with tempfile.TemporaryDirectory() as tmp:
            toy = os.path.join(tmp, "toy.rec")
            full = os.path.join(tmp, "voc.rec")
            t0 = time.perf_counter()
            _write_indexed_rec(toy, SSD_TOY_BATCH * (SSD_TOY_STEPS + 1),
                               SSD_TOY_HW, 3, SEED,
                               _ssd_toy_sample(SSD_TOY_HW))
            _write_indexed_rec(full, SSD_BATCH * SSD_STEPS, SSD_HW, 3,
                               SEED + 2, voc_sample)
            write_s = time.perf_counter() - t0
            toy_res, bad = _ssd_toy_card_vs_cpu(mx, toy)
            gc.collect()
            full_res, bad_full = _ssd_full(mx, full)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    res = {"phase": "ssd_fit",
           "config": {"toy": {"hw": SSD_TOY_HW, "batch": SSD_TOY_BATCH,
                              "classes": 2, "optimizer": "adam",
                              "lr": SSD_LR},
                      "full": {"body": "resnet50_v1 features (NHWC)",
                               "hw": SSD_HW, "batch": SSD_BATCH,
                               "classes": SSD_CLASSES,
                               "scales": [list(map(list, s))
                                          for s in SSD_SCALES]}},
           "write_s": write_s, "toy": toy_res, "full": full_res,
           "launches": full_res["launches"]}
    emit(res)
    bad += bad_full
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise SystemExit("ssd_fit phase failed: " + "; ".join(bad))
    return res



def phase_profile_resnet(dev):
    """Optional (not in the default run): two chained bf16 ResNet-50
    training steps of the ``resnet_training`` phase's main path under
    ``torch.profiler``, after one unprofiled warm-up step."""
    import torch

    _, apply_fn, params, aux = _resnet(dev)
    x, y = _resnet_batch(dev, RESNET_BATCH)
    state = [params, {k: torch.zeros_like(v) for k, v in params.items()},
             aux]

    def steps(n):
        for _ in range(n):
            _, state[0], state[1], state[2], _ = _resnet_step(
                apply_fn, *state, x, y, torch.bfloat16)

    steps(1)
    torch.cuda.synchronize()
    emit({"phase": "profile_resnet", "steps": 2, "B": RESNET_BATCH,
          **_profiled(lambda: steps(2))})


# -- sequence models: helpers of rnn_lm and bucketing_fit ---------------------

def _fused_to_unfused(blob, mode, num_layers, input_size, H, bidirectional,
                      prefix, forget_bias=1.0):
    """A ``FusedRNNCell``'s flat blob (numpy) as the weights of its
    ``unfuse()``d cells (``{prefix}l{i}_`` / ``{prefix}r{i}_``
    i2h/h2h weight and bias).  An unfused ``LSTMCell`` adds
    ``forget_bias`` to its forget gate in the graph, where the fused op
    adds none, so that gate's i2h bias is lowered by it."""
    import torch

    from mxnet_tpu_torch.ops.rnn import _unpack_params

    Ws, Bs = _unpack_params(torch.from_numpy(np.asarray(blob, np.float32)),
                            mode, num_layers, input_size, H, bidirectional)
    dirs = 2 if bidirectional else 1
    out = {}
    for k, ((wx, wh), (bx, bh)) in enumerate(zip(Ws, Bs)):
        layer, d = divmod(k, dirs)
        cell = f"{prefix}{'lr'[d]}{layer}_"
        bx = bx.numpy().copy()
        if mode == "lstm":
            bx[H:2 * H] -= forget_bias
        out.update({cell + "i2h_weight": wx.numpy().copy(),
                    cell + "h2h_weight": wh.numpy().copy(),
                    cell + "i2h_bias": bx, cell + "h2h_bias": bh.numpy().copy()})
    return out


def _bound_outputs(sym, vals, dev, mx=None):
    """``sym``'s outputs (numpy) from an inference forward bound on
    ``dev`` with the numpy arguments ``vals`` (``mx``: the package, the
    port's by default)."""
    if mx is None:
        import mxnet_tpu_torch as mx

    ctx = mx.cpu() if str(dev) == "cpu" else mx.gpu(0)
    ex = sym.simple_bind(ctx=ctx, grad_req="null",
                         **{n: v.shape for n, v in vals.items()})
    for n, v in vals.items():
        ex.arg_dict[n][:] = v
    return [o.asnumpy() for o in ex.forward(is_train=False)]


# -- phase 19: ops_breadth -----------------------------------------------------------

# card against CPU: f32 values within rtol 1e-5, with an absolute floor of
# 1e-5 x the CPU output's largest magnitude (a sum's last bits where it
# cancels to ~0); integers and tokens exact
BREADTH_RTOL = 1e-5
# the flash op at the LM training shape, each dtype and mask
BREADTH_FLASH_SHAPE = (8, 1024, 12, 64)


def _breadth_cases():
    """``(name, numpy inputs, attrs, compare)`` for every op name
    ops_breadth runs but the flash op (the tensor, nn, Crop/SVMOutput,
    update-rule and sampling names beyond those the model paths run;
    ``tests/test_torch_ops_breadth.py`` holds their coverage of the
    reference's registry): small inputs from a seed, in each op's domain; ``compare`` is "value" (outputs and gradients) or, for
    the decompositions, a reconstruction check."""
    rs = np.random.default_rng(SEED + 19)

    def f32(*shape, lo=None, hi=None):
        if lo is None:
            return rs.standard_normal(shape).astype(np.float32)
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def zeros_in(x):
        x = x.copy()
        x.flat[::3] = 0.0
        return x

    def spd(n):
        a = f32(2, n, n)
        return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)

    pos, unit = dict(lo=0.5, hi=2.0), dict(lo=-0.9, hi=0.9)
    dom = {"reciprocal": pos, "rsqrt": pos, "cbrt": pos, "rcbrt": pos,
           "log1p": pos, "log2": pos, "log10": pos, "tan": unit,
           "arcsin": unit, "arccos": unit, "arctanh": unit, "erfinv": unit,
           "gamma": pos, "gammaln": pos, "arccosh": dict(lo=1.2, hi=3.0)}
    cases = []
    for n in ("floor", "ceil", "round", "rint", "fix", "trunc", "expm1",
              "sin", "cos", "sinh", "cosh", "arcsinh", "arctan", "erf",
              "degrees", "radians", "softsign", "hard_sigmoid") + tuple(dom):
        cases.append((n, [f32(64, 33, **dom.get(n, {})) * (
            3.0 if n in ("floor", "ceil", "round", "rint", "fix", "trunc")
            else 1.0)], {}))
    cases.append(("logical_not", [zeros_in(f32(64, 33))], {}))
    for n in ("elemwise_hypot", "_hypot", "elemwise_logical_and",
              "elemwise_logical_or", "elemwise_logical_xor", "_logical_and",
              "_logical_or", "_logical_xor"):
        cases.append((n, [zeros_in(f32(64, 33)), zeros_in(f32(64, 33))], {}))
    for n in ("broadcast_hypot", "broadcast_logical_and",
              "broadcast_logical_or", "broadcast_logical_xor"):
        cases.append((n, [zeros_in(f32(64, 33)), zeros_in(f32(1, 33))], {}))
    for n, s in (("_hypot_scalar", 1.5), ("_logical_and_scalar", 1.0),
                 ("_logical_or_scalar", 0.0), ("_logical_xor_scalar", 1.0),
                 ("_plus_scalar", 2.5), ("_minus_scalar", 2.5),
                 ("_rminus_scalar", 2.5)):
        cases.append((n, [zeros_in(f32(64, 33))], {"scalar": s}))
    x = f32(16, 40)
    for n in ("BlockGrad", "stop_gradient", "stop_gradient_identity",
              "make_loss", "identity", "_copy", "IdentityAttachKLSparseReg"):
        cases.append((n, [x], {}))
    for n in ("add_n", "ElementWiseSum", "_grad_add_n"):
        cases.append((n, [x, f32(16, 40), f32(16, 40)], {}))
    cases += [("_grad_add", [x, f32(16, 40)], {}),
              ("_identity_with_attr_like_rhs", [x, f32(16, 40)], {})]
    xn = x.copy()
    xn[0, 1] = np.nan
    ties = np.round(f32(16, 40) * 2)       # many equal keys
    cases += [
        ("sort", [ties], {"axis": 1, "is_ascend": False}),
        ("argsort", [ties], {"axis": 0}),
        ("topk", [ties], {"axis": 1, "k": 5, "ret_typ": "both"}),
        ("histogram", [x], {"bin_cnt": 7}),
        ("_histogram", [x], {"bin_cnt": 4, "range": (-1.0, 1.0)}),
        ("nansum", [xn], {"axis": 1}), ("nanprod", [xn * 0.1 + 1.0], {}),
        ("argmax_channel", [x], {}),
        ("_square_sum", [x], {"axis": 0, "keepdims": True})]
    idx2 = np.stack([rs.integers(-16, 16, 20),
                     rs.integers(0, 40, 20)]).astype(np.int32)
    sl = {"begin": (0, 1), "end": (9, 40), "step": (1, 3)}
    flat = rs.integers(0, 640, 30).astype(np.int32)
    cases += [
        ("gather_nd", [x, idx2], {}),
        ("scatter_nd", [f32(20), np.abs(idx2) % np.array(
            [[16], [40]], np.int32)], {"shape": (16, 40)}),
        ("batch_take", [x, rs.integers(0, 40, 16).astype(np.int32)], {}),
        ("slice_like", [x, f32(5, 7)], {"axes": (0, 1)}),
        ("_slice_assign", [x, f32(9, 13)], sl),
        ("_slice_assign_scalar", [x], dict(sl, scalar=7.0)),
        ("ravel_multi_index", [np.stack([flat // 40, flat % 40])],
         {"shape": (16, 40)}),
        ("_ravel_multi_index", [np.stack([flat // 40, flat % 40]).astype(
            np.float32)], {"shape": (16, 40)}),
        ("unravel_index", [flat], {"shape": (16, 40)}),
        ("_unravel_index", [flat.astype(np.float32)], {"shape": (16, 40)}),
        ("diag", [x], {"k": 2}), ("roll", [x], {"shift": 3, "axis": 1}),
        ("shape_array", [x], {}), ("size_array", [x], {}),
        ("broadcast_axis", [x[:, :1].copy()], {"axis": 1, "size": 9}),
        ("broadcast_axes", [x[None]], {"axis": (0,), "size": (3,)}),
        ("_arange", [], {"start": 1.0, "stop": 40.0, "step": 0.7,
                         "repeat": 2}),
        ("_zeros", [], {"shape": (4, 5), "dtype": "int32"}),
        ("_ones", [], {"shape": (4, 5)}),
        ("_full", [], {"shape": (7,), "value": 2.5}),
        ("_eye", [], {"N": 5, "M": 7, "k": 1}),
        ("amp_cast", [x * 100], {"dtype": "int8"}),
        ("_rnn_param_concat", [x, f32(16, 3)], {"dim": 1})]
    x4 = f32(4, 16, 12, 10)
    cases += [
        ("pad", [x4], {"mode": "reflect",
                       "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
        ("Pad", [x4], {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 0, 0,
                                                       2)}),
        ("L2Normalization", [x4], {"mode": "channel"}),
        ("smooth_l1", [x4 * 2], {"scalar": 1.5}),
        ("depth_to_space", [x4], {"block_size": 2}),
        ("space_to_depth", [x4], {"block_size": 2})]
    low = np.linalg.cholesky(spd(6)).astype(np.float32)
    cases += [
        ("batch_dot", [f32(4, 8, 16), f32(4, 12, 16)],
         {"transpose_b": True}),
        ("khatri_rao", [f32(5, 3), f32(4, 3)], {}),
        ("linalg_gemm", [f32(4, 8, 16), f32(4, 16, 5), f32(4, 8, 5)],
         {"alpha": 0.5, "beta": 2.0}),
        ("linalg_gemm2", [f32(4, 16, 8), f32(4, 16, 5)],
         {"transpose_a": True, "alpha": 1.5}),
        ("linalg_potrf", [spd(6)], {"compare": "potrf"}),
        ("linalg_potri", [low], {"compare": "potri"}),
        ("linalg_trsm", [low, f32(2, 6, 4)], {"transpose": True,
                                              "alpha": 2.0}),
        ("linalg_trmm", [low, f32(2, 4, 6)], {"rightside": True,
                                              "lower": False}),
        ("linalg_syrk", [f32(2, 6, 8)], {"transpose": True, "alpha": 0.5}),
        ("linalg_syevd", [spd(6)], {"compare": "syevd"}),
        ("linalg_gelqf", [f32(2, 6, 8)], {"compare": "gelqf"}),
        ("linalg_sumlogdiag", [spd(6)], {}),
        ("linalg_extractdiag", [f32(2, 6, 8)], {"offset": 1}),
        ("linalg_makediag", [f32(2, 6)], {"offset": -1})]
    xc = f32(4, 8, 15, 15)
    cases += [
        ("Deconvolution", [xc, f32(8, 3, 4, 4), f32(6)],
         {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "adj": (1, 0),
          "num_filter": 6, "num_group": 2}),
        ("LRN", [xc], {"nsize": 3, "alpha": 0.01}),
        ("UpSampling", [xc], {"scale": 2, "sample_type": "bilinear"}),
        ("softmin", [xc], {"axis": 1}),
        ("softmax_cross_entropy", [f32(16, 10), rs.integers(
            0, 10, 16).astype(np.float32)], {}),
        ("_contrib_AdaptiveAvgPooling2D", [xc], {"output_size": (4, 6)}),
        ("_contrib_BilinearResize2D", [xc], {"height": 7, "width": 31}),
        ("BatchNorm_v1", [xc, f32(8), f32(8), np.zeros(8, np.float32),
                          np.ones(8, np.float32)],
         {"fix_gamma": False, "output_mean_var": True}),
        # channels-last: the BatchNorm op's kernels 3-4 on the card
        ("BatchNorm_v1", [f32(8, 14, 14, 64), f32(64), f32(64),
                          np.zeros(64, np.float32), np.ones(64, np.float32)],
         {"fix_gamma": False, "axis": 3}),
        ("Convolution_v1", [xc, f32(5, 8, 3, 3), f32(5)],
         {"kernel": (3, 3), "num_filter": 5, "pad": (1, 1)}),
        ("Pooling_v1", [xc], {"kernel": (3, 3), "stride": (2, 2),
                              "pool_type": "avg",
                              "pooling_convention": "full"}),
        ("Crop", [f32(2, 3, 19, 18), f32(2, 1, 11, 9)], {"offset": (3, 5)}),
        ("SVMOutput", [f32(16, 10), rs.integers(0, 10, 16).astype(
            np.float32)], {"margin": 0.5, "regularization_coefficient": 2.0})]
    w, g = f32(16, 40), f32(16, 40)
    p = [f32(16, 40, lo=0.1, hi=1.0) for _ in range(3)]
    m = [0.1 * f32(16, 40) for _ in range(3)]
    cases += [
        ("sgd_update", [w, g], {"lr": 0.1, "wd": 0.01, "clip_gradient": 0.5}),
        ("sgd_mom_update", [w, g, m[0]], {"lr": 0.1, "momentum": 0.9}),
        ("mp_sgd_update", [w, g, w.copy()], {"lr": 0.1}),
        ("mp_sgd_mom_update", [w, g, m[0], w.copy()], {"lr": 0.1,
                                                       "momentum": 0.9}),
        ("adam_update", [w, g, m[0], p[0]], {"lr": 0.01, "wd": 0.1}),
        ("ftrl_update", [w, g, m[0], p[0]], {"lr": 0.1, "lamda1": 0.05}),
        ("ftml_update", [w, g, p[0], p[1], m[0]], {"lr": 0.01, "t": 2}),
        ("rmsprop_update", [w, g, p[0]], {"lr": 0.01}),
        ("rmspropalex_update", [w, g, p[0], m[0], m[1]], {"lr": 0.01}),
        ("signsgd_update", [w, g], {"lr": 0.1, "wd": 0.1}),
        ("signum_update", [w, g, m[0]], {"lr": 0.1, "momentum": 0.9}),
        ("_sparse_adagrad_update", [w, g, p[0]], {"lr": 0.1})]
    logits = f32(8, 50257)
    for n, a in (("_sampling_greedy", {}), ("sample_greedy", {}),
                 ("_sampling_temperature", {"temperature": 0.7}),
                 ("sample_temperature", {"temperature": 1.3}),
                 ("_sampling_top_k", {"k": 40, "temperature": 0.9}),
                 ("sample_top_k", {"k": 0}),
                 ("_sampling_top_p", {"p": 0.6, "temperature": 1.1}),
                 ("sample_top_p", {"p": 0.95})):
        cases.append((n, [logits], a))
    cases += _breadth_image_cases(rs, f32)
    cases += _breadth_detection_cases(rs, f32)
    return cases


def _breadth_image_cases(rs, f32):
    """The ``_image_*`` ops (the random ones at ops_breadth's fixed key),
    ``_copyto`` and the OpenCV-style helpers, on uint8 and float images."""
    def u8(*shape):
        return rs.integers(0, 256, shape).astype(np.uint8)

    hwc, chw, nchw = u8(12, 10, 3), f32(3, 12, 10, lo=0, hi=255), \
        f32(2, 3, 12, 10, lo=0, hi=255)
    norm = {"mean": (120.0, 110.0, 100.0), "std": (50.0, 55.0, 60.0)}
    cases = [("_image_to_tensor", [hwc], {}),
             ("_image_to_tensor", [u8(2, 12, 10, 3)], {}),
             ("_image_normalize", [chw], norm),
             ("_image_normalize", [nchw], norm),
             ("_image_flip_left_right", [chw], {}),
             ("_image_flip_top_bottom", [nchw], {}),
             ("_image_crop", [nchw], {"x": 1, "y": 2, "width": 5,
                                      "height": 6}),
             ("_image_adjust_lighting", [u8(3, 12, 10)],
              {"alpha": (2.0, 1.0, -3.0)})]
    for interp in (0, 1):
        for size in ((5, 4), (17, 13)):
            cases += [("_image_resize", [chw], {"size": size,
                                                "interp": interp}),
                      ("_image_resize", [u8(3, 12, 10)],
                       {"size": size, "interp": interp})]
    rand = {"_image_random_flip_left_right": {},
            "_image_random_flip_top_bottom": {},
            "_image_random_brightness": {},
            "_image_random_contrast": {},
            "_image_random_saturation": {},
            "_image_random_hue": {"min_factor": -0.4, "max_factor": 0.4},
            "_image_random_lighting": {"alpha_std": 0.3},
            "_image_random_color_jitter": {"brightness": 0.4,
                                           "contrast": 0.3,
                                           "saturation": 0.5, "hue": 0.2}}
    for name, attrs in rand.items():
        cases += [(name, [u8(3, 12, 10)], attrs), (name, [chw], attrs)]
    cases += [("_copyto", [chw], {}),
              ("_cvcopyMakeBorder", [hwc], {"top": 1, "bot": 2, "left": 3,
                                            "value": 7.0}),
              ("copyMakeBorder", [f32(12, 10, 3)], {"right": 2})]
    for interp in (0, 1, 2):
        cases += [("_cvimresize", [hwc], {"w": 7, "h": 17, "interp": interp}),
                  ("cv_imresize", [f32(12, 10, 3, lo=0, hi=255)],
                   {"w": 5, "h": 6, "interp": interp})]
    return cases


def _breadth_detection_cases(rs, f32):
    """The box, ROI, spatial, SSD, RPN and CTC ops (gradients where the
    op is differentiable); CTC also at example/ctc/lstm_ocr_ctc.py's batch
    of 32 (T = 24 columns, 10 digits and the blank, 4-digit labels)."""
    def boxes(*lead, hi=1.0):
        a, b = rs.uniform(0, hi, lead + (2,)), rs.uniform(0, hi, lead + (2,))
        return np.concatenate([np.minimum(a, b), np.maximum(a, b) + 0.05],
                              -1).astype(np.float32)

    def rois(R, B, H, W, scale=1.0):
        x = np.sort(rs.uniform(0, (W - 1) / scale, (R, 2)), 1)
        y = np.sort(rs.uniform(0, (H - 1) / scale, (R, 2)), 1)
        b = rs.integers(0, B, (R, 1))
        return np.concatenate([b, x[:, :1], y[:, :1], x[:, 1:], y[:, 1:]],
                              1).astype(np.float32)

    nms = np.concatenate([rs.integers(0, 3, (2, 40, 1)),
                          rs.uniform(0, 1, (2, 40, 1)), boxes(2, 40, hi=0.6)],
                         -1).astype(np.float32)
    feat = f32(2, 4, 6, 6)
    anchors = np.concatenate(
        [np.stack(np.meshgrid(np.linspace(0, .8, 6), np.linspace(0, .8, 6),
                              indexing="ij"), -1).reshape(-1, 2)] * 2,
        -1).astype(np.float32)[None] + np.float32([0, 0, .25, .3])
    label = np.full((2, 3, 5), -1.0, np.float32)
    label[:, :2] = np.concatenate([rs.integers(0, 2, (2, 2, 1)),
                                   boxes(2, 2, hi=0.7)], -1)
    N = anchors.shape[1]
    logits = f32(2, 3, N)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    A = 6
    cls = rs.uniform(0, 1, (2, 2 * A, 5, 6)).astype(np.float32)
    info = np.asarray([[40, 48, 1.0], [36, 44, 0.8]], np.float32)
    prop = {"rpn_pre_nms_top_n": 60, "rpn_post_nms_top_n": 12,
            "threshold": 0.6, "rpn_min_size": 4, "scales": (2.0, 4.0),
            "ratios": (0.5, 1.0, 2.0), "feature_stride": 8}
    ctc_x = f32(7, 4, 6)
    ctc_y = rs.integers(1, 6, (4, 3)).astype(np.float32)
    ctc_y[1, 2:] = 0
    ocr_x = f32(24, 32, 11)
    ocr_y = rs.integers(1, 11, (32, 4)).astype(np.float32)
    theta = (np.asarray([1, 0, 0, 0, 1, 0], np.float32)
             + 0.2 * f32(2, 6)).astype(np.float32)
    return [
        ("_contrib_box_iou", [boxes(2, 5), boxes(2, 3)], {}),
        ("box_iou", [boxes(4), boxes(3)], {"format": "center"}),
        ("_contrib_box_nms", [nms], {"id_index": 0, "overlap_thresh": 0.3}),
        ("box_nms", [nms[0]], {"topk": 12, "valid_thresh": 0.2}),
        ("_contrib_box_encode", [rs.uniform(0, 1, (2, 6)).astype(
            np.float32), rs.integers(0, 4, (2, 6)).astype(np.float32),
            np.abs(f32(2, 6, 4)) + 0.2, np.abs(f32(2, 4, 4)) + 0.2], {}),
        ("_contrib_bipartite_matching", [f32(2, 5, 4)], {"threshold": 0.1}),
        ("ROIPooling", [f32(2, 3, 12, 10), rois(5, 2, 12, 10, 0.5)],
         {"pooled_size": (3, 2), "spatial_scale": 0.5}),
        ("_contrib_ROIAlign", [f32(2, 3, 9, 11), rois(4, 2, 9, 11)],
         {"pooled_size": (3, 3)}),
        ("_contrib_PSROIPooling", [f32(2, 18, 10, 12), rois(4, 2, 10, 12)],
         {"output_dim": 2, "pooled_size": 3, "group_size": 3}),
        ("_contrib_DeformablePSROIPooling",
         [f32(2, 8, 9, 10), rois(3, 2, 9, 10), 0.5 * f32(3, 4, 2, 2)],
         {"output_dim": 2, "group_size": 2, "pooled_size": 3,
          "part_size": 2, "sample_per_part": 2, "trans_std": 0.1}),
        ("_contrib_DeformableConvolution",
         [f32(2, 4, 7, 8), 1.5 * f32(2, 36, 7, 8), f32(6, 2, 3, 3),
          f32(6)], {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
                    "num_group": 2, "num_deformable_group": 2}),
        ("GridGenerator", [theta], {"target_shape": (5, 7)}),
        ("GridGenerator", [f32(2, 2, 6, 5)], {"transform_type": "warp"}),
        ("BilinearSampler", [f32(2, 3, 6, 5),
                             f32(2, 2, 4, 7, lo=-1.1, hi=1.1)], {}),
        ("SpatialTransformer", [f32(2, 3, 6, 5), theta],
         {"target_shape": (4, 6)}),
        ("Correlation", [f32(2, 3, 8, 9), f32(2, 3, 8, 9)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "pad_size": 3}),
        ("_contrib_MultiBoxPrior", [feat], {"sizes": (0.3, 0.6),
                                            "ratios": (1.0, 2.0, 0.5)}),
        ("_contrib_MultiBoxTarget", [anchors, label, logits],
         {"negative_mining_ratio": 3.0}),
        ("_contrib_MultiBoxDetection", [probs, 0.5 * f32(2, N * 4), anchors],
         {"nms_threshold": 0.45}),
        ("_contrib_Proposal", [cls, 0.3 * f32(2, 4 * A, 5, 6), info], prop),
        ("_contrib_MultiProposal", [cls, 0.3 * f32(2, 4 * A, 5, 6), info],
         dict(prop, output_score=True)),
        ("_contrib_CTCLoss", [ctc_x, ctc_y], {}),
        ("CTCLoss", [ctc_x, ctc_y - 1, np.float32([7, 5, 6, 7]),
                     np.float32([3, 2, 3, 1])],
         {"blank_label": "last", "use_data_lengths": True,
          "use_label_lengths": True}),
        ("ctc_loss", [ocr_x, ocr_y], {})]


def _breadth_same(a, b):
    """Card tensor ``a`` against CPU tensor ``b``: (ok, max abs error)."""
    import torch

    a = a.detach().cpu()
    b = b.detach()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False, float("inf")
    if not b.dtype.is_floating_point:
        return bool(torch.equal(a, b)), float((a.long() - b.long()).abs()
                                               .max()) if b.numel() else 0.0
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)):
        return False, float("inf")
    if not fin.any():
        return True, 0.0
    err = (a - b).abs()[fin]
    scale = float(b[fin].abs().max())
    ok = bool((err <= BREADTH_RTOL * (b.abs()[fin] + scale)).all())
    return ok, float(err.max())


def _breadth_recon(kind, ins, outs):
    """The decompositions' checks on one device: (ok, max abs error) of
    the reconstruction against the input (and the factor's own rule)."""
    import torch

    a = ins[0].double()
    if kind == "potrf":
        lo = outs[0].double()
        err = (lo @ lo.mT - a).abs().max()
        ok = bool(torch.equal(lo, torch.tril(lo)))
    elif kind == "potri":
        inv = outs[0].double()
        err = (inv @ (a @ a.mT) - torch.eye(a.shape[-1], dtype=a.dtype,
                                            device=a.device)).abs().max()
        ok = True
    elif kind == "syevd":
        u, lam = (o.double() for o in outs)
        err = (u.mT @ torch.diag_embed(lam) @ u - a).abs().max()
        ok = bool((lam[..., 1:] >= lam[..., :-1]).all())
    else:   # gelqf: A = L Q, Q's rows orthonormal, L lower, diagonal > 0
        q, lo = (o.double() for o in outs)
        err = (lo @ q - a).abs().max()
        ok = bool(torch.equal(lo, torch.tril(lo))) and bool(
            (torch.diagonal(lo, dim1=-2, dim2=-1) > 0).all())
    err = float(err)
    return ok and err < 1e-4 * max(1.0, float(a.abs().max())), err


def _breadth_run(op, ins, attrs, dev, grad):
    """The op on ``ins`` (numpy) placed on ``dev``: outputs, and the
    gradients of ``sum(out * c)`` over the float outputs (``c`` random,
    from a seed) with respect to the float inputs (None when there is
    none)."""
    import torch

    import mxnet_tpu_torch as mx

    ts = [torch.from_numpy(a).to(dev) for a in ins]
    for t in ts:
        if grad and t.dtype.is_floating_point:
            t.requires_grad_(True)
    kw = dict(attrs)
    if op.rng:
        kw["rng_key"] = torch.tensor([7, 1234], dtype=torch.int64,
                                     device=dev)
    if not ins:
        kw["ctx"] = mx.gpu(0) if dev.type == "cuda" else mx.cpu()
    outs = op.fn(*ts, **kw)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    leaves = [t for t in ts if t.requires_grad]
    heads = [o for o in outs if o.dtype.is_floating_point and o.requires_grad]
    grads = None
    if grad and leaves and heads:
        # random cotangents, the same on both devices (a constant one
        # gives softmin's or BatchNorm's data gradient as pure rounding)
        gen = torch.Generator().manual_seed(SEED + 192)
        loss = sum((o * torch.randn(o.shape, generator=gen).to(dev)).sum()
                   for o in heads)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if gr is None else gr
                 for gr, t in zip(grads, leaves)]
    return ts, outs, grads


def _breadth_flash(dev):
    """``_contrib_flash_attention`` on the card at the LM training shape,
    f32 and bf16, causal and not: the forward and backward through the
    op launch the flash forward, dQ and dK/dV kernels (one each, by the
    wrappers' counts and by kernel name), and out, dq, dk, dv hold to the
    plain versions under TOL."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    B, T, H, D = BREADTH_FLASH_SHAPE
    rows = []
    for name, dname, causal in (("_contrib_flash_attention", "float32",
                                 True),
                                ("flash_attention", "float32", False),
                                ("_contrib_flash_attention", "bfloat16",
                                 True),
                                ("flash_attention", "bfloat16", False)):
        dtype = getattr(torch, dname)
        g = torch.Generator(device=dev).manual_seed(SEED + 191)
        q, k, v, go = (torch.randn(B, T, H, D, generator=g,
                                   device=dev).to(dtype) for _ in range(4))
        op = OP_REGISTRY[name]
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

        def run():
            out = op.fn(*leaves, causal=causal)
            grads = torch.autograd.grad(out, leaves, go)
            return out, grads

        _reset_launches()
        out, grads = run()
        torch.cuda.synchronize()
        counts = _read_launches()
        # empty kernels first: a session loses its first launches' records
        names, sessions = _launched(
            lambda: ([torch.cuda._sleep(0) for _ in range(PROFILE_LEAD)],
                     run()), "flash_")
        routed, other = _routed(names, FLASH_ROUTES[dname])
        ref_out, lse = fa.flash_attention_forward_reference(q, k, v, causal)
        ref = (ref_out,) + tuple(fa.flash_attention_backward_reference(
            q, k, v, ref_out, lse, go, causal))
        errs, within, ok = {}, {}, routed
        for key, a, b in zip(("out", "dq", "dk", "dv"),
                             (out,) + tuple(grads), ref):
            good, err, _ = _close(a.detach(), b, dname)
            errs[key], within[key] = err, good
            ok = ok and good
        launches = {kk: counts[kk] for kk in ("flash_attention_fwd",
                                              "flash_attention_dq",
                                              "flash_attention_dkv")}
        ok = ok and all(c == 1 for c in launches.values())
        rows.append({"name": name, "dtype": dname, "causal": causal,
                     "shape": [B, T, H, D], "launches": launches,
                     "kernels": names, "other": other,
                     "profiler_sessions": sessions, "routed": routed,
                     "max_abs_err": errs, "within_tol": within, "ok": ok})
    return rows


def phase_ops_breadth(dev):
    """Every op name of ``_breadth_cases`` on the card
    against the same call on the CPU: output dtypes, outputs and, where
    the op is differentiable, the gradients (``BREADTH_RTOL``); the
    decompositions by their reconstructions on each device; the sampling
    ops' tokens exactly.  Then the flash op at the training shape through
    kernels 6-8 (``_breadth_flash``)."""
    import torch

    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    t0 = time.perf_counter()
    cases = _breadth_cases()
    names = {c[0] for c in cases} | {"_contrib_flash_attention",
                                     "flash_attention"}
    rows, bad = [], []
    torch.manual_seed(SEED)
    _reset_launches()
    for name, ins, attrs in cases:
        attrs = dict(attrs)
        recon = attrs.pop("compare", None)
        op = OP_REGISTRY[name]
        grad = op.differentiable and recon is None
        cpu_in, cpu_out, cpu_g = _breadth_run(op, ins, attrs,
                                              torch.device("cpu"), grad)
        card_in, card_out, card_g = _breadth_run(op, ins, attrs, dev, grad)
        torch.cuda.synchronize()
        row = {"name": name, "dtypes": [str(o.dtype).split(".")[-1]
                                        for o in card_out]}
        if recon is not None:
            ok_c, err_c = _breadth_recon(recon, card_in, card_out)
            ok_p, err_p = _breadth_recon(recon, cpu_in, cpu_out)
            same_dt = [o.dtype for o in card_out] == \
                [o.dtype for o in cpu_out]
            row.update(ok=ok_c and ok_p and same_dt, recon_err=err_c,
                       cpu_recon_err=err_p)
        else:
            checks = [_breadth_same(a, b) for a, b in zip(card_out, cpu_out)]
            if card_g is not None or cpu_g is not None:
                if card_g is None or cpu_g is None:
                    checks.append((False, float("inf")))
                else:
                    checks += [_breadth_same(a, b)
                               for a, b in zip(card_g, cpu_g)]
            row.update(ok=len(card_out) == len(cpu_out)
                       and all(c[0] for c in checks),
                       max_abs_err=max(c[1] for c in checks),
                       grads=card_g is not None)
        rows.append(row)
    loop = _read_launches()
    # only the channels-last BatchNorm_v1 case reaches a kernel (3 and 4)
    leaked = {k: v for k, v in loop.items()
              if v and k not in ("bn_stats", "bn_normalize")}
    flash = _breadth_flash(dev)
    res = {"phase": "ops_breadth", "names": len(names),
           "cases": len(rows), "rtol": BREADTH_RTOL,
           "failed": [r for r in rows if not r["ok"]],
           "worst": sorted((r for r in rows if "max_abs_err" in r),
                           key=lambda r: -r["max_abs_err"])[:8],
           "flash": flash, "launches_outside_flash": leaked,
           "seconds": time.perf_counter() - t0,
           "launches": {k: loop[k] + sum(r["launches"].get(k, 0)
                                          for r in flash)
                        for k in loop}}
    emit(res)
    if res["failed"]:
        bad.append(f"card disagrees with the CPU: "
                   f"{[r['name'] for r in res['failed']]}")
    if leaked or not (loop["bn_stats"] and loop["bn_normalize"]):
        bad.append(f"kernel launches outside the flash op: {loop} (only "
                   f"channels-last BatchNorm_v1's kernels expected)")
    bad += [f"flash op {r['name']} {r['dtype']} causal={r['causal']}: "
            f"launches {r['launches']}, kernels {r['kernels']}, errors "
            f"{r['max_abs_err']}" for r in flash if not r["ok"]]
    if bad:
        raise SystemExit("ops_breadth phase failed: " + "; ".join(bad))
    return res


# -- phase 20: fcn_fit ---------------------------------------------------------------

# fcn_fit: FCN-32s (``symbol/fcnxs.py``, the public example's
# get_fcn32s_symbol) at its published widths, 21 PASCAL VOC classes, f32
# NCHW at B=8 on 500x500 images, fcn_xs.py's SGD (lr 1e-10, momentum
# 0.99, wd 5e-4); two warm-up batches, then FCN_STEPS timed ones; the
# card-vs-CPU Module.fit step at B=1 on a 224x224 crop; labels 255
# (ignored) on a band of rows
FCN_CLASSES, FCN_BATCH, FCN_HW, FCN_WARM, FCN_STEPS = 21, 8, 500, 2, 10
FCN_LR, FCN_MOMENTUM, FCN_WD = 1e-10, 0.99, 5e-4
FCN_CHECK_HW, FCN_CHECK_RTOL = 224, 1e-3
# the first node id of the check's graph: far above any id a run reaches
FCN_CHECK_UID = 1 << 40


def _fcn_symbol():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.symbol.fcnxs import get_fcn32s_symbol

    with mx.name.NameManager():
        return get_fcn32s_symbol(mx.sym, numclass=FCN_CLASSES)


def _fcn_images(n, hw, seed):
    """n random images in [0, 1) and per-pixel labels in [0, 21), the
    first eighth of each label image's rows 255 (ignored)."""
    rs = np.random.default_rng(seed)
    X = rs.random((n, 3, hw, hw), dtype=np.float32)
    Y = rs.integers(0, FCN_CLASSES, (n, hw, hw)).astype(np.float32)
    Y[:, :hw // 8, :] = 255.0
    return X, Y


def _fcn_loss(probs, label):
    """Mean cross entropy over the pixels not labelled 255."""
    import torch

    lab = label.to(probs.device).long()
    keep = lab != 255
    p = probs.gather(1, torch.where(keep, lab, 0)[:, None])[:, 0]
    return float(-torch.log(p.clamp_min(1e-30))[keep].mean())


def _bilinear_filter(k):
    f = np.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.ogrid[:k, :k]
    return ((1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))).astype(
        np.float32)


def _fcn_init():
    import mxnet_tpu_torch as mx

    return mx.init.Mixed(["bigscore_weight", ".*"],
                         [mx.init.Bilinear(),
                          mx.init.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2)])


def _fcn_bigscore(shape):
    """``bigscore_weight`` as the public ``init_fcnxs.py`` sets it: each
    class upsampled from its own score plane.  ``init.Bilinear`` puts
    the filter in every (in, out) plane, which gives every class the
    same logit and the trunk a gradient of exactly 0."""
    w = np.zeros(shape, np.float32)
    w[range(shape[0]), range(shape[1])] = _bilinear_filter(shape[-1])
    return w


def _fcn_fit_kwargs():
    return dict(num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": FCN_LR,
                                  "momentum": FCN_MOMENTUM, "wd": FCN_WD},
                eval_metric="acc")


def _fcn_card_vs_cpu(net):
    """One ``Module.fit`` step (the fused step the timed run takes, with
    its optimizer) at B=1 on a 224x224 crop, on the card and on the CPU
    from the same numpy arguments (He-scaled random trunk, the per-class
    bilinear ``bigscore``) and the same Dropout key: the loss and each
    parameter's gradient, normwise.  Each must be within rtol
    FCN_CHECK_RTOL or, where the card moves by more than that against
    itself, within 3 x that floor (the card with the image moved by
    ~2^-22, cuDNN deterministic); the tensors past the rtol are listed
    with their floors.  Two card runs bitwise equal.

    A symbolic Dropout node draws ``fold_in(key, node id)``, and node ids
    count every graph node the process made: the check's graph is loaded
    with its ids from FCN_CHECK_UID, so its masks (and with them the
    floor) do not depend on which phases ran before it."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.symbol.graph import Node

    made = Node._next_uid[0]
    Node._next_uid[0] = FCN_CHECK_UID
    try:
        net = mx.sym.load_json(net.tojson())
    finally:
        Node._next_uid[0] = made
    hw = FCN_CHECK_HW
    X, Y = _fcn_images(1, hw, SEED + 20)
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(1, 3, hw, hw))[0]))
    rs = np.random.default_rng(SEED + 21)
    params = {}
    for n, s in shapes.items():
        if n == "bigscore_weight":
            params[n] = _fcn_bigscore(s)
        elif n.endswith("bias"):
            params[n] = (0.01 * rs.standard_normal(s)).astype(np.float32)
        elif n not in ("data", "softmax_label"):
            params[n] = (rs.standard_normal(s) * np.sqrt(
                2.0 / np.prod(s[1:]))).astype(np.float32)
    u = np.random.default_rng(SEED + 22).uniform(-1, 1, X.shape)
    moved = (X * (1 + 2.0 ** -22 * u)).astype(np.float32)

    def fit_step(ctx, image):
        it = mx.io.NDArrayIter(image, Y, batch_size=1)
        mod = mx.mod.Module(net, context=ctx)
        got = {}

        def grab(param):
            got["loss"] = torch.tensor([_fcn_loss(
                mod.get_outputs()[0]._data, torch.from_numpy(Y))])

        mx.random.seed(SEED)   # the same Dropout masks on both devices
        mod.fit(it, arg_params=params, batch_end_callback=grab,
                **_fcn_fit_kwargs())
        got.update({n: mod._exec.grad_dict[n]._data.detach().cpu()
                    for n in mod._exec._grad_arg_names})
        return got, mod._fused_step_count

    # cuDNN deterministic (the same conv algorithms in every card run)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        card, fused = fit_step(mx.gpu(0), X)
        card_again, _ = fit_step(mx.gpu(0), X)
        card_moved, _ = fit_step(mx.gpu(0), moved)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    cpu, cpu_fused = fit_step(mx.cpu(), X)
    errs = {k: _rel(card[k], cpu[k]) for k in cpu}
    floors = {k: _rel(card_moved[k], card[k]) for k in card}
    repeat = all(torch.equal(card[k], card_again[k]) for k in card)
    grad_norm = float(torch.linalg.vector_norm(cpu["conv1_1_weight"]))
    worst = max(errs, key=errs.get)
    over_rtol = {k: {"err": errs[k], "floor": floors[k]}
                 for k in sorted(errs) if errs[k] > FCN_CHECK_RTOL}
    # the trunk's lower gradients move by ~3e-3 when the image moves by
    # 2^-22 (ReLU and max pooling's routing over a random trunk): the
    # floor sets their limit where it exceeds the rtol
    over = sorted(k for k in errs
                  if errs[k] > max(FCN_CHECK_RTOL, 3 * floors[k]))
    res = {"B": 1, "hw": hw, "route": "Module.fit, one fused step",
           "fused_steps": [fused, cpu_fused], "tensors": len(errs),
           "rtol": FCN_CHECK_RTOL,
           "tolerance": "rtol, or 3 x floor where the floor is larger",
           "over_rtol": over_rtol, "over_tolerance": over,
           "card_bitwise_repeatable": repeat,
           "loss_card": float(card["loss"][0]),
           "loss_cpu": float(cpu["loss"][0]), "ln_21": float(np.log(21)),
           "loss_rel_err": errs["loss"], "conv1_1_grad_norm": grad_norm,
           "max_rel_err": errs[worst], "worst": worst,
           "floor_of_worst": floors[worst],
           "max_floor": max(floors.values()),
           "rel_err": errs, "floor": floors}
    bad = [f"FCN card vs CPU beyond max({FCN_CHECK_RTOL}, 3 x floor): "
           f"{ {k: errs[k] for k in over} } (floors "
           f"{ {k: floors[k] for k in over} })"] if over else []
    if not repeat:
        bad.append("FCN card step not bitwise repeatable (cuDNN "
                   "deterministic)")
    if [fused, cpu_fused] != [1, 1]:
        bad.append(f"FCN check step not fused: {[fused, cpu_fused]}")
    if not grad_norm > 0 or abs(res["loss_cpu"] - np.log(21)) < 0.01:
        bad.append(f"FCN check step: conv1_1 gradient norm {grad_norm}, "
                   f"loss {res['loss_cpu']} (ln 21 = {np.log(21)})")
    return res, bad


def _fcn_deconv_ms(dev):
    """``bigscore``'s Deconvolution alone at the path's shape (B=8, 21
    channels, 15x15 in, 543x543 out): forward ms, and the backward (data
    and weight gradients) ms."""
    import torch

    from mxnet_tpu_torch.ops.nn import deconvolution

    g = torch.Generator(device=dev).manual_seed(SEED)
    side = (FCN_HW + 198) // 32 - 6     # score's side: 15 at 500x500
    x = torch.randn(FCN_BATCH, FCN_CLASSES, side, side, generator=g,
                    device=dev, requires_grad=True)
    w = torch.randn(FCN_CLASSES, FCN_CLASSES, 64, 64, generator=g,
                    device=dev, requires_grad=True)
    kw = dict(kernel=(64, 64), stride=(32, 32), adj=(31, 31),
              num_filter=FCN_CLASSES, no_bias=True)
    out = deconvolution(x, w, **kw)
    go = torch.randn(out.shape, generator=g, device=dev)
    fwd = _event_ms(lambda: deconvolution(x, w, **kw))
    bwd = _event_ms(lambda: torch.autograd.grad(out, (x, w), go,
                                                retain_graph=True))
    return {"in": list(x.shape), "out": list(out.shape), "fwd_ms": fwd,
            "bwd_ms": bwd}


def phase_fcn_fit(dev, smi):
    """FCN-32s by ``Module.fit`` at its published widths: ``init.Bilinear``
    on ``bigscore`` against the numpy filter, the card-vs-CPU
    ``Module.fit`` step, then FCN_WARM + FCN_STEPS batches at B=8,
    500x500, f32 NCHW from the public example's init (``bigscore`` per
    class); images/s, median step, peak memory, a profiled step's idle
    share, the Deconvolution's own forward and backward ms.  The fit must
    lower the first batch's loss (Dropout off) and move conv1_1.  The
    path runs no port kernel (no BatchNorm, no LayerNorm): every launch
    count stays 0."""
    import torch

    import mxnet_tpu_torch as mx

    net = _fcn_symbol()
    json_roundtrip = mx.sym.load_json(net.tojson()).tojson() == net.tojson()
    # the bilinear init on the card
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (1, 3, FCN_CHECK_HW, FCN_CHECK_HW))],
             label_shapes=[("softmax_label",
                            (1, FCN_CHECK_HW, FCN_CHECK_HW))])
    mod.init_params(initializer=_fcn_init())
    w = mod.get_params()[0]["bigscore_weight"].asnumpy()
    bilinear_ok = bool(np.array_equal(
        w, np.broadcast_to(_bilinear_filter(64), w.shape)))
    del mod
    check, bad = _fcn_card_vs_cpu(net)
    torch.cuda.empty_cache()

    B, n = FCN_BATCH, FCN_WARM + FCN_STEPS
    X, Y = _fcn_images(n * B, FCN_HW, SEED + 23)
    it = mx.io.NDArrayIter(X, Y, batch_size=B)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    # the trunk by Xavier (He-scaled), bigscore per class (init_fcnxs.py)
    mod.init_params(initializer=_fcn_init(), allow_missing=True,
                    arg_params={"bigscore_weight": _fcn_bigscore(
                        (FCN_CLASSES, FCN_CLASSES, 64, 64))})
    held = next(iter(it))
    it.reset()

    def held_loss():
        """The first batch's loss, Dropout off."""
        mod.forward(held, is_train=False)
        return _fcn_loss(mod.get_outputs()[0]._data, held.label[0]._data)

    held_before = held_loss()
    conv1_start = mod._exec.arg_dict["conv1_1_weight"]._data.clone()
    marks, losses = [], []

    def timing(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if param.nbatch in (0, n - 1):
            losses.append(_fcn_loss(mod.get_outputs()[0]._data,
                                    param.locals["data_batch"].label[0]
                                    ._data))

    torch.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    mod.fit(it, batch_end_callback=timing, **_fcn_fit_kwargs())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _read_launches()
    fused_steps = mod._fused_step_count
    held_after = held_loss()
    # weight decay alone cannot move an f32 weight at lr 1e-10 (lr x wd
    # = 5e-14 a step, under half an ulp): a change is the gradient's
    conv1_moved = float((mod._exec.arg_dict["conv1_1_weight"]._data
                         - conv1_start).abs().max() / conv1_start.abs().max())
    peak = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
    steady = float(np.median(step_ms[FCN_WARM:]))
    it.reset()
    batch = next(iter(it))
    # the fused step alone on a batch already on the card, and the host
    # metric's update over its outputs (what the fit loop adds)
    alone, metric_ms = [], []
    metric = mx.metric.create("acc")
    for _ in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mod._try_fused_step(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
        alone.append((t2 - t1) * 1e3)
        metric_ms.append((time.perf_counter() - t2) * 1e3)
    prof = _profiled(lambda: mod._try_fused_step(batch))
    deconv = _fcn_deconv_ms(dev)
    res = {"phase": "fcn_fit", "card": smi,
           "config": {"symbol": "mxnet_tpu_torch/symbol/fcnxs.py "
                      "get_fcn32s_symbol (example/fcn-xs symbol_fcnxs.py)",
                      "classes": FCN_CLASSES, "batch": B,
                      "image": [3, FCN_HW, FCN_HW], "dtype": "float32",
                      "layout": "NCHW", "optimizer": "sgd", "lr": FCN_LR,
                      "momentum": FCN_MOMENTUM, "wd": FCN_WD,
                      "initializer": "bigscore_weight: the bilinear filter "
                                     "per class (init_fcnxs.py); the rest "
                                     "Xavier(gaussian, in, 2)"},
           "json_roundtrip": json_roundtrip, "bilinear_init": bilinear_ok,
           "card_vs_cpu": check, "fit_s": fit_s, "step_ms": step_ms,
           "steady_step_ms": steady, "images_per_s": B / (steady / 1e3),
           "fused_step_alone_ms": alone,
           "fused_step_alone_images_per_s": B / (
               float(np.median(alone[1:])) / 1e3),
           "metric_update_ms": metric_ms,
           "peak_bytes": peak, "losses_first_last": losses,
           "held_batch_loss": {"before": held_before, "after": held_after,
                               "ln_21": float(np.log(21))},
           "conv1_1_moved_rel": conv1_moved,
           "fused_steps": fused_steps,
           "profiled_step": {k: prof[k] for k in (
               "wall_s", "device_busy_s", "idle_share", "kernels", "top")},
           "deconvolution": deconv, "launches": launches}
    emit(res)
    if not json_roundtrip:
        bad.append("load_json(tojson()) wrote other bytes")
    if not bilinear_ok:
        bad.append("init.Bilinear gave bigscore_weight another filter")
    if not all(np.isfinite(losses)) or len(losses) != 2:
        bad.append(f"losses {losses}")
    # the labels are uniform random, so ln 21 is the least expected loss:
    # training lowers a loss above it (the logits differ by class) toward it
    if not (held_after < held_before and held_before - np.log(21) > 0.01):
        bad.append(f"the first batch's loss {held_before} -> {held_after} "
                   f"(ln 21 = {np.log(21)}): not lowered by the fit")
    if not conv1_moved > 0:
        bad.append("the fit left conv1_1_weight unchanged (no gradient)")
    if fused_steps != n:
        bad.append(f"fit took the fused step {fused_steps} times in {n} "
                   f"batches")
    if any(launches.values()):
        bad.append(f"the FCN path launched port kernels: {launches}")
    if bad:
        raise SystemExit("fcn_fit phase failed: " + "; ".join(bad))
    return res


# -- phases 21-23: several processes --------------------------------------------------
def _ulysses_flash_cases(dev, mesh):
    """Kernels 6-8 through ``ulysses_attention(impl="flash")`` at the
    sharded step's shape (B=8, T=1024, H=12, D=64, causal; float32 and
    bfloat16) against their plain versions on the same q, k, v and output
    gradient under ``TOL``: out and lse against the plain forward's, dq,
    dk and dv against the plain backward's from the kernel forward's out
    and lse (as ``_flash_cases`` holds each kernel alone)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel.collectives import spmd
    from mxnet_tpu_torch.parallel.sequence_parallel import ulysses_attention

    B, T, H, D = FLASH_SHAPES["training"]
    rows, bad = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(SEED + 41)
        q, k, v, go = (torch.randn(B, T, H, D, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with spmd(mesh):
            out = ulysses_attention(*leaves, axis_name="sp", causal=True,
                                    impl="flash")
            grads = torch.autograd.grad(out, leaves, go)
        with torch.no_grad():
            k_out, k_lse = fa.flash_attention_forward(q, k, v, causal=True)
            ref_out, ref_lse = fa.flash_attention_forward_reference(
                q, k, v, causal=True)
            ref_grads = fa.flash_attention_backward_reference(
                q, k, v, k_out, k_lse, go, causal=True)
        row = {"dtype": dname, "max_abs_err": {}}
        for name, a, b, tol in (("out", out.detach(), ref_out, dname),
                                ("lse", k_lse, ref_lse, "float32"),
                                *((n, g_, r_, dname) for n, g_, r_ in zip(
                                    ("dq", "dk", "dv"), grads, ref_grads))):
            ok, err, _ = _close(a, b, tol)
            row["max_abs_err"][name] = err
            if not ok:
                bad.append(f"ulysses flash {dname} {name}: {err:.3g}")
        rows.append(row)
        del leaves, out, grads, ref_grads
    return rows, bad


def phase_spmd_lm(dev, cfg, params):
    """``make_sharded_train_step`` over a world of one process on NCCL
    (``make_mesh(dp=1, sp=1)``: NCCL refuses two ranks on one card, so
    the rotation and the all-to-all across ranks are held by the CPU
    tests over gloo) at GPT-2 width, B=8, T=1024, lr 0.1, momentum 0.9.

    The main path, each step counted from 0: the sharded step with
    ``sp_impl="ulysses_flash"`` in f32 and in bf16 compute, then
    ``"ulysses"`` and ``"ring"`` in f32, each from the same params and
    zero momenta — per step 12 launches of each flash kernel (ulysses_flash)
    and 25 LayerNorms.  Each against ``train_step`` with the same attention
    callable on the card: loss within 1e-5 relative and every gradient
    (the new momenta) within 1e-4 normwise (the training phase's
    tolerances; bitwise reported).  One bf16 ulysses_flash step profiled:
    the flash kernels by name, and NCCL's 96 all-to-alls on the device
    timeline (at one rank NCCL copies, and launches no kernel of its
    own; its kernels and the copies are counted beside).
    Kernels 6-8 through Ulysses against their plain versions.  Step ms of
    each against ``train_step``'s (medians of three calls each, in
    turns)."""
    import functools

    import torch

    from mxnet_tpu_torch.parallel import mesh as pmesh
    from mxnet_tpu_torch.parallel.collectives import spmd
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    from mxnet_tpu_torch.parallel.sequence_parallel import ulysses_attention
    from mxnet_tpu_torch.parallel.transformer import (make_sharded_train_step,
                                                      shard_batch,
                                                      train_step)

    B, T, lr, momentum = 8, 1024, 0.1, 0.9
    rs = np.random.RandomState(SEED)
    tokens_np = rs.randint(0, cfg.vocab, (B, T))
    mesh = pmesh.make_mesh(dp=1, sp=1, device=dev, install=False)
    attn = {"ulysses_flash": functools.partial(
                ulysses_attention, axis_name="sp", causal=True,
                impl="flash"),
            "ulysses": functools.partial(ulysses_attention, axis_name="sp",
                                         causal=True, impl="dense"),
            "ring": functools.partial(ring_attention, axis_name="sp",
                                      causal=True)}
    legs = (("ulysses_flash", "float32"), ("ulysses_flash", "bfloat16"),
            ("ulysses", "float32"), ("ring", "float32"))
    n = cfg.n_layers
    bad = []
    try:
        batch = shard_batch(mesh, tokens_np, np.roll(tokens_np, -1, 1),
                            np.arange(T))
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        steps, legs_out = {}, {}
        _reset_launches()
        for impl, dname in legs:
            dt = None if dname == "float32" else getattr(torch, dname)
            steps[impl, dname] = make_sharded_train_step(
                mesh, cfg, lr=lr, momentum=momentum, sp_impl=impl,
                compute_dtype=dt)
            before = _read_launches()
            (loss, _, mom), ms = timed(lambda: steps[impl, dname](
                params, zeros, *batch))
            after = _read_launches()
            legs_out[impl, dname] = {
                "loss": loss.item(), "momenta": mom, "first_step_ms": ms,
                "launches": {k: after[k] - before[k] for k in after}}
        launches = _read_launches()
        rows = []
        for impl, dname in legs:
            leg = legs_out[impl, dname]
            dt = None if dname == "float32" else getattr(torch, dname)
            with spmd(mesh):
                (ref_loss, _, ref_m), ref_first = timed(lambda: train_step(
                    params, zeros, *batch, cfg, lr=lr, momentum=momentum,
                    attention=attn[impl], compute_dtype=dt))
                # in turns, three each: one call can catch a host stall
                ref_runs, runs = [], []
                for _ in range(3):
                    ref_runs.append(timed(lambda: train_step(
                        params, zeros, *batch, cfg, lr=lr,
                        momentum=momentum, attention=attn[impl],
                        compute_dtype=dt))[1])
                    runs.append(timed(lambda: steps[impl, dname](
                        params, zeros, *batch))[1])
            ref_ms, ms = float(np.median(ref_runs)), float(np.median(runs))
            rel = _grad_rel_errors(leg["momenta"], ref_m, zeros, momentum)
            worst = max(rel, key=rel.get)
            loss_rel = abs(leg["loss"] - ref_loss.item()) \
                / abs(ref_loss.item())
            bitwise = leg["loss"] == ref_loss.item() and all(
                torch.equal(leg["momenta"][k], ref_m[k]) for k in ref_m)
            want = {k: 0 for k in leg["launches"]}
            want["layer_norm"] = 2 * n + 1
            if impl == "ulysses_flash":
                want.update(flash_attention_fwd=n, flash_attention_dq=n,
                            flash_attention_dkv=n)
            row = {"sp_impl": impl, "compute_dtype": dname,
                   "loss": leg["loss"], "train_step_loss": ref_loss.item(),
                   "loss_rel_err": loss_rel,
                   "grad_rel_err_max": rel[worst],
                   "grad_rel_err_worst": worst, "bitwise": bitwise,
                   "step_ms": ms, "step_ms_runs": runs,
                   "first_step_ms": leg["first_step_ms"],
                   "train_step_ms": ref_ms, "train_step_ms_runs": ref_runs,
                   "train_step_first_ms": ref_first,
                   "tokens_per_s": B * T / (ms / 1e3),
                   "launches": leg["launches"]}
            rows.append(row)
            if loss_rel > 1e-5 or rel[worst] > 1e-4:
                bad.append(f"{impl} {dname}: loss {loss_rel:.3g}, "
                           f"gradient of {worst} {rel[worst]:.3g}")
            if leg["launches"] != want:
                bad.append(f"{impl} {dname} launched {leg['launches']}, "
                           f"not {want}")
            del leg["momenta"], ref_m
        # NCCL marks each collective on the device's timeline
        # ("nccl:all_to_all"); at one rank it launches no kernel of its
        # own, its all-to-all is a device-to-device copy
        prof = _profiled(lambda: steps["ulysses_flash", "bfloat16"](
            params, zeros, *batch), families=(
                "flash_fwd", "flash_dq", "flash_dkv", "nccl:", "ncclDevKernel",
                "Memcpy DtoD"))
        fam = prof["families"]
        if [fam["flash_fwd"], fam["flash_dq"], fam["flash_dkv"]] != [n] * 3:
            bad.append(f"profiled bf16 step: flash kernels by name {fam}")
        # q, k, v and out, forward and backward, in every layer
        if fam["nccl:"] != 8 * n:
            bad.append(f"{fam['nccl:']} NCCL collectives on the device in "
                       f"the profiled step, not {8 * n}: "
                       f"{prof['family_names']['nccl:']}")
        cases, case_bad = _ulysses_flash_cases(dev, mesh)
        bad += case_bad
    finally:
        pmesh.shutdown()
    res = {"phase": "spmd_lm", "config": dataclasses.asdict(cfg), "B": B,
           "T": T, "lr": lr, "momentum": momentum,
           "world": {"backend": "nccl", "size": 1, "mesh": {"dp": 1,
                                                            "sp": 1}},
           "legs": rows, "tolerance": {"loss_rel": 1e-5, "grad_rel": 1e-4},
           "profiled_bf16_step": {
               "families": fam, "family_names": prof["family_names"],
               "idle_share": prof["idle_share"],
               "device_busy_s": prof["device_busy_s"],
               "wall_s": prof["wall_s"],
               "lost_records": prof["lost_records"], "top": prof["top"]},
           "flash_through_ulysses": cases,
           "launches": launches}
    emit(res)
    if bad:
        raise SystemExit("spmd_lm phase failed: " + "; ".join(bad))
    return res


def phase_dp_mesh(dev):
    """``DataParallelTrainer(mesh=dp_mesh(1))`` over a world of one process
    on NCCL, on the resnet_compressed net (``resnet50_v1`` channels-last
    224x224, bf16 compute, Gluon's ``SoftmaxCrossEntropyLoss``, SGD lr 0.1
    momentum 0.9) at B=128: ten steps plain, then ten
    with ``{"type": "2bit", "threshold": 0.5}``, each step counted from 0 (53
    launches of each BatchNorm kernel, and with 2-bit one pack and one
    unpack per trainable parameter).  The plain step's BatchNorm is the
    synced one of any world size (each rank's statistics gathered over
    ``dp`` and combined), which at one rank must change no bit: the first
    step of each, cuDNN deterministic, is held bit for bit against the
    mesh-less trainer's step from the same state (loss, parameters,
    momenta, running statistics, residuals); the rest run as
    resnet_compressed's do.  One more step of each profiled (the
    BatchNorm kernels by name, 53 each, and with 2-bit the pack and unpack
    kernels, 193 each; top kernels, idle share); the pack and unpack kernels
    against their plain versions on that step's gradients.  Step ms of
    each."""
    import torch

    from mxnet_tpu_torch.ops import twobit as tb
    from mxnet_tpu_torch.parallel import mesh as pmesh

    net, _, params, _ = _resnet(dev)
    n_params = len(params)
    del params
    x, y = _resnet_batch(dev, RESNET_BATCH)
    comp2 = {"type": "2bit", "threshold": TWOBIT_THRESHOLD}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    bad, legs = [], {}
    try:
        mesh = pmesh.dp_mesh(1, device=dev)
        for name, comp in (("plain", None), ("2bit", comp2)):
            # the first step against the mesh-less trainer's
            ref = _trainer(net, compute_dtype=torch.bfloat16,
                           compression_params=comp)
            tr = _trainer(net, compute_dtype=torch.bfloat16, mesh=mesh,
                          compression_params=comp)
            ref_loss = ref.step(x, y)
            state_ref = (ref.params, ref.momenta, ref.aux, ref.residuals)
            del ref
            losses, step_ms, per_step = [], [], []
            for i in range(COMPRESSED_STEPS):
                if i == 1:
                    # the rest timed as resnet_compressed times them
                    torch.backends.cudnn.deterministic, \
                        torch.backends.cudnn.benchmark = det
                torch.cuda.synchronize()
                _reset_launches()
                t0 = time.perf_counter()
                losses.append(tr.step(x, y))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(_read_launches())
                if i == 0:
                    mine = (tr.params, tr.momenta, tr.aux, tr.residuals)
                    unequal = [f"{part}:{k}" for part, a, b in zip(
                        ("params", "momenta", "aux", "residuals"),
                        mine, state_ref) if a is not None
                        for k in a if not torch.equal(a[k], b[k])]
                    bitwise = torch.equal(losses[0], ref_loss) \
                        and not unequal
                    del mine, state_ref
            losses = [v.item() for v in losses]
            want = {k: 0 for k in per_step[0]}
            want.update(bn_stats=RESNET_BNS, bn_normalize=RESNET_BNS)
            if comp is not None:
                want.update(twobit_pack=n_params, twobit_unpack=n_params)
            off = [c for c in per_step if c != want]
            legs[name] = {"losses": losses, "step_ms": step_ms,
                          "steady_step_ms": float(np.median(step_ms[1:])),
                          "images_per_s": RESNET_BATCH / (float(np.median(
                              step_ms[1:])) / 1e3),
                          "first_step_bitwise": bitwise,
                          "first_step_unequal": unequal[:8],
                          "launches_per_step": per_step[0],
                          "expected_per_step": want}
            if not bitwise:
                bad.append(f"{name}: first step differs from the mesh-less "
                           f"trainer's: loss {ref_loss.item()} vs "
                           f"{losses[0]}, {unequal[:4]}")
            if off:
                bad.append(f"{name}: {len(off)} steps launched other counts "
                           f"than {want}, the first {off[0]}")
            if not all(np.isfinite(losses)):
                bad.append(f"{name}: non-finite loss {losses}")
            prof = _profiled(lambda: tr.step(x, y), families=(
                "twobit_pack_kernel", "twobit_unpack_kernel",
                "bn_stats_final", "bn_normalize"))
            legs[name]["profiled_step"] = {
                k: prof[k] for k in ("families", "idle_share", "wall_s",
                                     "device_busy_s", "lost_records",
                                     "top", "backward_nodes_ms")}
            fam = prof["families"]
            if fam != {"twobit_pack_kernel": 0 if comp is None else n_params,
                       "twobit_unpack_kernel":
                       0 if comp is None else n_params,
                       "bn_stats_final": RESNET_BNS,
                       "bn_normalize": RESNET_BNS}:
                bad.append(f"profiled {name} step: {fam}")
            if comp is not None:
                # the kernels on this step's gradients: the largest one
                _, grads, _ = tr._loss_and_grads(x, y)
                key = max(grads, key=lambda k: grads[k].numel())
                gk = grads[key].float().contiguous()
                rk = tr.residuals[key][0]
                pk, nr = tb.twobit_pack(gk, rk, TWOBIT_THRESHOLD)
                pr, nrr = tb.twobit_pack_reference(gk, rk, TWOBIT_THRESHOLD)
                uk = tb.twobit_unpack(pk, gk.shape, TWOBIT_THRESHOLD)
                ur = tb.twobit_unpack_reference(pr, gk.shape,
                                                TWOBIT_THRESHOLD)
                legs[name]["kernels_vs_plain"] = {
                    "gradient": key, "shape": list(gk.shape),
                    "pack_bitwise": bool(torch.equal(
                        pk.view(torch.int32), pr.view(torch.int32))
                        and torch.equal(nr, nrr)),
                    "unpack_bitwise": bool(torch.equal(uk, ur))}
                if not (legs[name]["kernels_vs_plain"]["pack_bitwise"]
                        and legs[name]["kernels_vs_plain"]["unpack_bitwise"]):
                    bad.append(f"2-bit kernels vs plain on {key}: "
                               f"{legs[name]['kernels_vs_plain']}")
                del grads
            del tr
            torch.backends.cudnn.deterministic, \
                torch.backends.cudnn.benchmark = True, False
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
        pmesh.shutdown()
    total = {}
    for leg in legs.values():
        for k, v in leg["launches_per_step"].items():
            total[k] = total.get(k, 0) + COMPRESSED_STEPS * v
    res = {"phase": "dp_mesh",
           "config": {"model": "resnet50_v1", "layout": "NHWC",
                      "image": [RESNET_HW, RESNET_HW, 3], "B": RESNET_BATCH,
                      "compute_dtype": "bfloat16",
                      "trainable_parameters": n_params,
                      "threshold": TWOBIT_THRESHOLD},
           "world": {"backend": "nccl", "size": 1, "mesh": {"dp": 1}},
           **legs,
           "compression_overhead_ms": legs["2bit"]["steady_step_ms"]
           - legs["plain"]["steady_step_ms"],
           "launches": total}
    emit(res)
    if bad:
        raise SystemExit("dp_mesh phase failed: " + "; ".join(bad))
    return res


# dist_kvstore: two worker processes on the one card through
# tools/launch.py; ResNet-50 v1 f32 channels-last, 32 images a worker,
# five Trainer steps over dist_sync with 2-bit pushes (the server runs the
# SGD), then one Module.fit epoch of the cifar ResNet-20 symbol
DIST_WORKERS, DIST_BATCH, DIST_STEPS, DIST_TIMEOUT = 2, 32, 5, 420
# the server's SGD step: with 2-bit pushes every coded element moves by
# lr * t * (its code sum) / 64, a sign-like step; 0.01 keeps five of them
# on a repeated batch descending
DIST_LR = 0.01
DIST_FIT_BATCH, DIST_FIT_BATCHES = 16, 4
# the Trainer steps whose pushes are held against the plain versions
DIST_HELD_STEPS = 2
DIST_WORKER = r"""
import hashlib, json, os, sys, time

import numpy as np
import torch

sys.path.insert(0, {repo!r})
import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch import kvstore_dist as kd
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import twobit as tb
from mxnet_tpu_torch.parallel import compression

rank = int(os.environ["MXTPU_PROC_ID"])
num = int(os.environ["MXTPU_NUM_PROCS"])
ctx = mx.cpu() if {cpu!r} else mx.gpu(0)
dev = ctx.torch_device
out = {{"rank": rank, "device": str(dev)}}
log = open(os.path.join({out!r}, f"{{{tag!r}}}_rank{{rank}}.jsonl"), "w")


def digest(net):
    # the trainable parameters' bytes (the running statistics are each
    # worker's own, as in the reference)
    h = hashlib.sha256()
    for p in net.collect_params().values():
        if p.grad_req != "null":
            h.update(p.data()._data.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


# time inside the step: the worker's quantize, the server's dequantize and
# update (rank 0's process)
spent = {{"quantize_s": 0.0, "server_dequantize_s": 0.0,
          "server_update_s": 0.0}}
q_real = compression.GradientCompression.quantize
apply_real = kd.KVStoreDistServer._apply
handle_real = kd.KVStoreDistServer._handle
push_real = kd.KVStoreDist.push
# a held step's pushes: key -> (gradient, residual in, codes, residual out)
held = {{"on": False, "key": None, "calls": {{}}}}


def push(self, key, value, priority=0):
    held["key"] = key
    return push_real(self, key, value, priority)


def quantize(self, grad, residual=None):
    sync(); t0 = time.perf_counter()
    r = q_real(self, grad, residual)
    sync(); spent["quantize_s"] += time.perf_counter() - t0
    if held["on"]:
        held["calls"][str(held["key"])] = (
            grad.clone(), None if residual is None else residual.clone(),
            r[0].clone(), r[1].clone())
    return r


def apply(self, st, key, merged):
    t0 = time.perf_counter()
    apply_real(self, st, key, merged)
    spent["server_update_s"] += time.perf_counter() - t0


def handle(self, msg):
    t0 = time.perf_counter()
    r = handle_real(self, msg)
    if msg[0] == "push_c":
        spent["server_dequantize_s"] += time.perf_counter() - t0
    return r


compression.GradientCompression.quantize = quantize
kd.KVStoreDistServer._apply = apply
kd.KVStoreDistServer._handle = handle
kd.KVStoreDist.push = push


def trained(trainer):
    # kvstore key -> the trainable parameter's value
    return {{str(trainer._param2idx[p.name]): p.data()._data.detach().cpu()
             .numpy() for p in trainer._params if p.grad_req != "null"}}

with ctx:
    if {part!r} in ("all", "trainer"):
        from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

        net = resnet50_v1(classes=cs.RESNET_CLASSES, layout="NHWC")
        net.initialize(ctx=ctx, generator=torch.Generator(device=dev)
                       .manual_seed(cs.SEED))
        with torch.no_grad():
            net(torch.zeros(1, cs.RESNET_HW, cs.RESNET_HW, 3, device=dev))
        g = torch.Generator(device=dev).manual_seed(cs.SEED + 10 + rank)
        x = mx.nd.NDArray(torch.randn(cs.DIST_BATCH, cs.RESNET_HW,
                                      cs.RESNET_HW, 3, generator=g,
                                      device=dev))
        y = mx.nd.NDArray(torch.randint(0, cs.RESNET_CLASSES,
                                        (cs.DIST_BATCH,), generator=g,
                                        device=dev).float())
        trainer = gluon.Trainer(
            net.collect_params(), "sgd",
            {{"learning_rate": cs.DIST_LR, "momentum": cs.RESNET_MOMENTUM,
             "rescale_grad": 1.0 / (cs.DIST_BATCH * num)}},
            kvstore="dist_sync",
            compression_params={{"type": "2bit",
                                "threshold": cs.TWOBIT_THRESHOLD}})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        out["trainable"] = sum(1 for p in net.collect_params().values()
                               if p.grad_req != "null")
        steps = []
        # the plain version's residual of each key, its own chain
        chain = {{}}
        cs._reset_launches()
        for s in range({steps}):
            if rank == 0 and s == 0:
                np.savez(os.path.join({out!r}, f"{{{tag!r}}}_w0.npz"),
                         **trained(trainer))
            held["on"], held["calls"] = s < cs.DIST_HELD_STEPS, {{}}
            kv = trainer._kvstore
            b0 = (kv.bytes_sent, kv.bytes_received) if kv else (0, 0)
            before = cs._read_launches()
            spent.update(dict.fromkeys(spent, 0.0))
            sync(); t0 = time.perf_counter()
            with autograd.record():
                L = loss_fn(net(x), y)
            L.backward()
            sync(); t1 = time.perf_counter()
            trainer.step(cs.DIST_BATCH)
            sync(); t2 = time.perf_counter()
            kv = trainer._kvstore
            after = cs._read_launches()
            steps.append({{"loss": float(L.mean().asscalar()),
                          "compute_ms": (t1 - t0) * 1e3,
                          "kvstore_ms": (t2 - t1) * 1e3,
                          "step_ms": (t2 - t0) * 1e3,
                          **{{k[:-2] + "_ms": v * 1e3
                              for k, v in spent.items()}},
                          "bytes_sent": kv.bytes_sent - b0[0],
                          "bytes_received": kv.bytes_received - b0[1],
                          "launches": {{k: after[k] - before[k]
                                       for k in after}},
                          "digest": digest(net)}})
            if held["on"]:
                # each push against the plain pack on the same gradient
                # and the plain residual chain; the codes sent, for the
                # server's update to be recomputed from
                off = []
                for key, (g, r_in, codes, r_out) in held["calls"].items():
                    want, want_r = tb.twobit_pack_reference(
                        g, chain.get(key, torch.zeros_like(g)),
                        cs.TWOBIT_THRESHOLD)
                    if r_in is not None and not torch.equal(r_in,
                                                            chain[key]):
                        off.append(f"{{key}}: residual in")
                    if not (torch.equal(codes.view(torch.int32),
                                        want.view(torch.int32))
                            and torch.equal(r_out, want_r)):
                        off.append(f"{{key}}: codes or residual out")
                    chain[key] = want_r
                steps[-1]["held"] = {{"pushes": len(held["calls"]),
                                     "off_plain": off[:8]}}
                np.savez(os.path.join({out!r},
                                      f"{{{tag!r}}}_codes{{s}}_rank{{rank}}.npz"),
                         **{{k: v[2].cpu().numpy()
                            for k, v in held["calls"].items()}})
                held["calls"] = {{}}
                if rank == 0:
                    np.savez(os.path.join({out!r},
                                          f"{{{tag!r}}}_w{{s + 1}}.npz"),
                             **trained(trainer))
            log.write(json.dumps({{"step": s, **steps[-1]}}) + "\n")
            log.flush()
        # every push of the last step is merged before its pull returns
        trainer._kvstore.barrier()
        out["trainer"] = steps
        out["unpack_total"] = cs._read_launches()["twobit_unpack"]
        out["built_seconds"] = {{k: v["seconds"]
                                for k, v in _build.build_info.items()}}
        trainer._kvstore.close()
    if {part!r} in ("all", "fit"):
        host = os.environ["MXTPU_COORDINATOR"].rsplit(":", 1)[0]
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        sym = cs._example_resnet_symbol(10, 20, "3,32,32")
        shape = (cs.DIST_FIT_BATCH, 3, 32, 32)
        values, aux_values = cs._random_values(sym, shape, cs.SEED + 6, 10)
        out["fit"] = {{}}
        for i, (fit_tag, moved) in enumerate({fits!r}):
            # a store of its own each, on a port of its own
            os.environ["MXTPU_COORDINATOR"] = f"{{host}}:{{{fit_ports!r}[i]}}"
            args = {{k: mx.nd.array(v, ctx=ctx) for k, v in values.items()
                    if k not in ("data", "softmax_label")}}
            aux = {{k: mx.nd.array(v, ctx=ctx) for k, v in aux_values.items()}}
            # the epoch's batches, of which this job fits the first ones
            rs = np.random.default_rng(cs.SEED + 20 + rank)
            n = cs.DIST_FIT_BATCH * cs.DIST_FIT_BATCHES
            images = rs.standard_normal((n, 3, 32, 32), dtype=np.float32)
            labels = rs.integers(0, 10, n).astype(np.float32)
            n = cs.DIST_FIT_BATCH * {fit_batches}
            images, labels = images[:n], labels[:n]
            if moved:   # by ~2^-22: the card's own noise floor
                u = np.random.default_rng(cs.SEED + 7).uniform(
                    -1, 1, images.shape)
                images = (images * (1 + 2.0 ** -22 * u)).astype(np.float32)
            it = mx.io.NDArrayIter(
                images, labels, batch_size=cs.DIST_FIT_BATCH,
                label_name="softmax_label")
            mod = mx.mod.Module(sym, context=ctx)
            fit = {{"digests": []}}

            def end(param, mod=mod, fit=fit, fit_tag=fit_tag):
                a, _ = mod.get_params()
                if param.nbatch == 0:
                    np.savez(os.path.join({out!r},
                                          f"{{fit_tag}}_fit_rank{{rank}}.npz"),
                             **{{k: v.asnumpy() for k, v in a.items()}})
                h = hashlib.sha256()
                for k in sorted(a):
                    h.update(a[k].asnumpy().tobytes())
                fit["digests"].append(h.hexdigest())

            t0 = time.perf_counter()
            mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
                    optimizer_params={{"learning_rate": 0.05,
                                      "momentum": 0.9}},
                    arg_params=args, aux_params=aux, eval_metric="acc",
                    batch_end_callback=end)
            sync()
            fit["seconds"] = time.perf_counter() - t0
            fit["update_on_kvstore"] = bool(mod._update_on_kvstore)
            out["fit"][fit_tag] = fit
            mod._kvstore.close()
json.dump(out, open(os.path.join({out!r}, f"{{{tag!r}}}_rank{{rank}}.json"),
                    "w"))
"""


def _free_ports(n):
    """``n`` distinct ports that were free at once."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _dist_start(tag, cpu, part, steps, fits, fit_batches, ports):
    """Start DIST_WORKER as ``tools/launch.py -n DIST_WORKERS`` in a session
    of its own (so that a hung job's workers die with it).  ``ports``: the
    coordinator's (the Trainer's store's one server), then one for each
    fit's store."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "dist_kvstore")
    os.makedirs(out, exist_ok=True)
    script = os.path.join(out, f"worker_{tag}.py")
    with open(script, "w") as f:
        f.write(DIST_WORKER.format(repo=root, cpu=cpu, out=out, tag=tag,
                                   part=part, steps=steps, fits=fits,
                                   fit_batches=fit_batches,
                                   fit_ports=ports[1:]))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env["PYTHONPATH"] = root
    # a dead peer fails the job in two minutes, not the default 630 s a try
    env.update(TPUMX_KV_TIMEOUT="120", TPUMX_KV_RETRIES="0")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
         str(DIST_WORKERS), "--coordinator", f"127.0.0.1:{ports[0]}", "--",
         sys.executable, script], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=root,
        start_new_session=True)
    return tag, proc, time.perf_counter(), out


def _dist_finish(job):
    """Wait for a started job (a worker that fails or hangs fails it):
    each worker's result and the job's wall seconds."""
    import os

    tag, proc, t0, out = job
    try:
        stdout, stderr = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        stdout, stderr = proc.communicate()
        raise SystemExit(f"dist_kvstore {tag} job hung past {DIST_TIMEOUT} "
                         f"s: {stdout[-1500:]} {stderr[-3000:]}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"dist_kvstore {tag} job failed ({proc.returncode})"
                         f": {stdout[-1500:]} {stderr[-4000:]}")
    results = []
    for rank in range(DIST_WORKERS):
        with open(os.path.join(out, f"{tag}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results, wall


def _dist_server_check(out):
    """The server's values after each held Trainer step against the same
    update recomputed on the host from the codes the two workers sent:
    the plain unpack of each, their sum, and the optimizer's SGD in plain
    ops (``g = rescale * sum``; ``m = momentum * m - lr * g``; ``w += m``)
    from the server's values before the step.  Each key's update within
    1e-4 normwise; how many keys agree bit for bit."""
    import torch

    from mxnet_tpu_torch.ops import twobit as tb

    w = {k: torch.from_numpy(v) for k, v in
         np.load(f"{out}/card_w0.npz").items()}
    mom = {k: torch.zeros_like(v) for k, v in w.items()}
    steps = []
    for s in range(DIST_HELD_STEPS):
        codes = [np.load(f"{out}/card_codes{s}_rank{r}.npz")
                 for r in range(DIST_WORKERS)]
        got = {k: torch.from_numpy(v) for k, v in
               np.load(f"{out}/card_w{s + 1}.npz").items()}
        errs, bitwise = {}, 0
        for k in w:
            merged = sum(tb.twobit_unpack_reference(
                torch.from_numpy(c[k].view(np.int32)), tuple(w[k].shape),
                TWOBIT_THRESHOLD) for c in codes)
            g = torch.mul(merged, 1.0 / (DIST_BATCH * DIST_WORKERS))
            mom[k].mul_(RESNET_MOMENTUM)
            mom[k].sub_(torch.mul(g, DIST_LR))
            want = w[k] + mom[k]
            errs[k] = _rel(got[k] - w[k], want - w[k])
            bitwise += bool(torch.equal(got[k], want))
        worst = max(errs, key=errs.get)
        steps.append({"keys": len(errs), "bitwise_keys": bitwise,
                      "worst": worst, "max_rel_err": errs[worst]})
        w = got
    return {"steps": steps, "tolerance": 1e-4,
            "over_tolerance": [st for st in steps
                               if st["max_rel_err"] > 1e-4]}


def phase_dist_kvstore(dev):
    """The parameter server between processes: ``tools/launch.py -n 2
    --coordinator 127.0.0.1:<free port>`` starts two workers on the one
    card (the kernels built by this process already; rank 0 hosts the
    server in-process, its SGD updates on the card).  Each trains
    ``resnet50_v1`` channels-last, f32, on 32 images of its own for five
    steps through ``gluon.Trainer("sgd", lr 0.1, momentum 0.9, rescale
    1/64, kvstore="dist_sync", compression_params={"type": "2bit",
    "threshold": 0.5})`` and then runs one ``Module.fit`` epoch (4
    batches of 16) of the cifar ResNet-20 symbol over ``dist_sync``
    uncompressed (SGD on the server).  Checks: both workers' parameters
    bitwise equal after every step and every fit batch; the repeated
    batch's loss falls; each worker 193 pack launches a step, rank 0's
    process 2 x 193 unpacks a step (its server); the first two steps'
    pushes, each against the plain pack of the same gradient on the plain
    residual chain (bitwise), and the server's values after them against
    their recomputation from the codes sent (``_dist_server_check``);
    Module.fit's first step,
    run alone on the card, against the same two-worker job on the CPU
    from the same state (each
    weight's update normwise within max(1e-4, 10 x its floor), all of
    them within max(1e-4, 3 x the global floor); the floor is the card
    job again with the images moved by ~2^-22, module_fit's rule); no
    worker built a kernel.  Wall ms a step and its parts, bytes pushed and pulled a
    step."""
    import torch

    # every store's port, taken at once: two jobs run side by side below
    ports = _free_ports(7)
    job = _dist_start("card", False, "all", DIST_STEPS, [("card", False)],
                      DIST_FIT_BATCHES, ports[:2])
    out = job[3]
    card, wall = _dist_finish(job)
    # the card-vs-CPU check: one fit step alone on the card (and again
    # with the images moved by ~2^-22) while the CPU job runs beside it
    jobs = [_dist_start("cpu", True, "fit", 0, [("cpu", False)], 1,
                        ports[2:4]),
            _dist_start("cardfit", False, "fit", 0,
                        [("cardfit", False), ("moved", True)], 1,
                        ports[4:7])]
    (cpu, cpu_wall), (cardfit, _) = [_dist_finish(j) for j in jobs]
    bad = []
    n_params = card[0]["trainable"]
    tr = [w["trainer"] for w in card]
    for s in range(DIST_STEPS):
        if tr[0][s]["digest"] != tr[1][s]["digest"]:
            bad.append(f"workers' parameters differ after step {s}")
    for job in (card, cardfit, cpu):
        for t in job[0]["fit"]:
            if job[1]["fit"][t]["digests"] != job[0]["fit"][t]["digests"]:
                bad.append(f"the workers' {t} fit parameters differ")
    for w in card:
        if any(v for v in w["built_seconds"].values()):
            bad.append(f"rank {w['rank']} built kernels "
                       f"{w['built_seconds']}")
    losses = [[st["loss"] for st in steps] for steps in tr]
    for rank, ls in enumerate(losses):
        if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
            bad.append(f"rank {rank}'s loss did not fall: {ls}")
    packs = [[st["launches"]["twobit_pack"] for st in steps] for steps in tr]
    if any(p != n_params for ps in packs for p in ps):
        bad.append(f"pack launches a step {packs}, not {n_params}")
    unpacks = [w["unpack_total"] for w in card]
    want_unpacks = [DIST_STEPS * DIST_WORKERS * n_params, 0]
    if unpacks != want_unpacks:
        bad.append(f"unpack launches {unpacks}, not {want_unpacks}")
    for rank, steps in enumerate(tr):
        for s in range(DIST_HELD_STEPS):
            h = steps[s]["held"]
            if h["pushes"] != n_params or h["off_plain"]:
                bad.append(f"rank {rank} step {s}: {h['pushes']} pushes, "
                           f"against the plain pack {h['off_plain']}")
    server = _dist_server_check(out)
    if server["over_tolerance"]:
        bad.append(f"the server's 2-bit SGD against its recomputation from "
                   f"the codes sent: {server}")
    # Module.fit's first step: card against CPU, from the same state
    base = _random_values(_example_resnet_symbol(10, 20, "3,32,32"),
                          (DIST_FIT_BATCH, 3, 32, 32), SEED + 6, 10)[0]
    # the updates, card against CPU, held as module_fit's cifar check
    # holds its gradients: against the card's own floor (its images moved
    # by ~2^-22)
    steps_of = {t: {k: torch.from_numpy(v - base[k]) for k, v in np.load(
        f"{out}/{t}_fit_rank0.npz").items()}
        for t in ("card", "cardfit", "cpu", "moved")}
    keys = sorted(steps_of["cpu"])
    upd = {k: _rel(steps_of["cardfit"][k], steps_of["cpu"][k])
           for k in keys}
    floors = {k: _rel(steps_of["moved"][k], steps_of["cardfit"][k])
              for k in keys}

    def flat(t):
        return torch.cat([steps_of[t][k].flatten() for k in keys])

    glob = _rel(flat("cardfit"), flat("cpu"))
    glob_floor = _rel(flat("moved"), flat("cardfit"))
    # the fit that ran after the Trainer in the same processes
    after_trainer = {"vs_cpu": _rel(flat("card"), flat("cpu")),
                     "vs_fit_alone": _rel(flat("card"), flat("cardfit"))}
    over = _tolerance(upd, floors)
    if over or glob > max(1e-4, 3 * glob_floor):
        bad.append(f"Module.fit's first step card vs CPU: global "
                   f"{glob:.3g} (floor {glob_floor:.3g}), beyond tolerance "
                   f"{over}")
    per = {k: float(np.median([st[k] for steps in tr for st in steps[1:]]))
           for k in ("step_ms", "compute_ms", "kvstore_ms", "quantize_ms",
                     "bytes_sent", "bytes_received")}
    server_ms = {k: float(np.median([st[k] for st in tr[0][1:]]))
                 for k in ("server_dequantize_ms", "server_update_ms")}
    launches = {k: sum(st["launches"][k] for steps in tr for st in steps)
                for k in tr[0][0]["launches"]}
    launches["twobit_unpack"] = unpacks[0]
    res = {"phase": "dist_kvstore",
           "config": {"workers": DIST_WORKERS, "model": "resnet50_v1",
                      "layout": "NHWC", "dtype": "float32",
                      "B_per_worker": DIST_BATCH, "steps": DIST_STEPS,
                      "threshold": TWOBIT_THRESHOLD, "kvstore": "dist_sync",
                      "fit": {"symbol": "resnet-20 cifar",
                              "B": DIST_FIT_BATCH,
                              "batches": DIST_FIT_BATCHES}},
           "job_wall_s": wall, "cpu_job_wall_s": cpu_wall,
           "losses": losses, "steps": tr[0], "median_step": per,
           "server_median_ms": server_ms,
           "server_update_vs_plain": server,
           "fit": {"seconds": [w["fit"]["card"]["seconds"] for w in card],
                   "cpu_seconds": [w["fit"]["cpu"]["seconds"] for w in cpu],
                   "update_on_kvstore":
                   card[0]["fit"]["card"]["update_on_kvstore"],
                   "first_step_card_vs_cpu": {
                       "global": glob, "floor_global": glob_floor,
                       "max_tensor": max(upd.values()),
                       "worst": max(upd, key=upd.get),
                       "floor_of_worst": floors[max(upd, key=upd.get)],
                       "over_tolerance": over,
                       "fit_after_trainer": after_trainer,
                       "tolerance": {"each": "max(1e-4, 10 x floor)",
                                     "global": "max(1e-4, 3 x floor)"}}},
           "pack_launches": packs, "unpack_launches": unpacks,
           "launches": launches}
    emit(res)
    if bad:
        raise SystemExit("dist_kvstore phase failed: " + "; ".join(bad))
    return res


# -- phase 24: model_parallel --------------------------------------------------------

MP_PIPE_MICRO = 8       # microbatches of (1, T, D) through the pipeline
MP_MOE_TOKENS = 8192    # Switch FFN tokens (D = 768, d_ff = 3072)


def _mp_stage_fn(cfg):
    """One pipeline stage: the GPT-2 blocks whose parameters its slice of
    the stacked dict holds (``(L, ...)`` per block parameter), causal
    ``local_attention`` on all heads."""
    import functools

    from mxnet_tpu_torch.parallel.ring_attention import local_attention
    from mxnet_tpu_torch.parallel.transformer import _block

    attend = functools.partial(local_attention, causal=True)

    def stage(p, x):
        for j in range(next(iter(p.values())).shape[0]):
            x = _block(x, {f"l0_{k}": v[j] for k, v in p.items()}, 0,
                       cfg.d_head, lambda i, q, k, v: attend(q, k, v))
        return x
    return stage


def _mp_stacked(params, cfg, stages):
    """The GPT-2 blocks' parameters stacked (stages, blocks a stage, ...)
    under their names without the ``l{i}_`` prefix."""
    import torch

    per = cfg.n_layers // stages
    names = [k[3:] for k in params if k.startswith("l0_")]
    return {n: torch.stack([torch.stack([params[f"l{s * per + j}_{n}"]
                                         for j in range(per)])
                            for s in range(stages)]) for n in names}


def _rel_err(a, b) -> float:
    return float((a - b).float().norm() / b.float().norm().clamp_min(1e-30))


def phase_model_parallel(dev, cfg, params):
    """Model parallelism over a world of one process on NCCL (NCCL refuses
    two ranks on one card; the four-card legs are ``chip_multicard.py``'s
    and the gloo CPU tests'), at GPT-2 width.

    The main path, counted from 0: ``make_partitioned_train_step`` at
    dp=1 x mp=1, f32, B=8, T=1024, by the compute route (tensor
    parallelism) and the storage route (FSDP), each one step against
    ``train_step`` (loss within 1e-5 relative, every gradient within 1e-4
    normwise), 25 LayerNorms a step by wrapper and by kernel name;
    ``pipeline_apply_sharded`` at pp=1 over the 12 GPT-2 blocks as one
    stage, 8 microbatches of (1, 1024, 768), outputs and gradients (of
    the stacked blocks and the input) against the sequential blocks
    (1e-5 normwise); ``moe_apply_sharded`` at ep=1, a Switch FFN (768 ->
    3072 -> 768, GELU) over 8,192 tokens, outputs and gradients against
    the dense oracle (1e-5); ``paged_attention_sharded`` at mp=1 on the
    serving decode and prefill shapes, float and int8 pools, bitwise
    ``paged_attention``, its kernels by name.  Step ms of each route
    beside ``train_step``'s (medians of three, in turns), pipeline and
    MoE forward + backward ms."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_sharded)
    from mxnet_tpu_torch.parallel import mesh as pmesh
    from mxnet_tpu_torch.parallel.moe import moe_apply_sharded
    from mxnet_tpu_torch.parallel.partition_rules import max_bytes_per_device
    from mxnet_tpu_torch.parallel.pipeline import pipeline_apply_sharded
    from mxnet_tpu_torch.parallel.transformer import (
        make_partitioned_train_step, train_step)

    B, T, lr, momentum = 8, 1024, 0.1, 0.9
    rs = np.random.RandomState(SEED)
    tokens_np = rs.randint(0, cfg.vocab, (B, T))
    tokens = torch.as_tensor(tokens_np, device=dev)
    labels = torch.as_tensor(np.roll(tokens_np, -1, 1), device=dev)
    positions = torch.arange(T, device=dev)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    n = cfg.n_layers
    bad = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    mesh = pmesh.make_mesh(dp=1, mp=1, device=dev, install=False)
    try:
        # -- the partitioned LM step, both routes --------------------------
        _reset_launches()
        routes, steps = {}, {}
        for route in ("compute", "storage"):
            step, shard_fn, gather_fn = make_partitioned_train_step(
                mesh, cfg, lr=lr, momentum=momentum,
                mp_compute=route == "compute")
            blocks, mblocks = shard_fn(params), shard_fn(zeros)
            before = _read_launches()
            (loss, p1, m1), first_ms = timed(lambda: step(
                blocks, mblocks, tokens, labels, positions))
            after = _read_launches()
            steps[route] = (step, blocks, mblocks)
            routes[route] = {
                "loss": loss.item(), "momenta": gather_fn(m1),
                "first_step_ms": first_ms,
                "stored_bytes": max_bytes_per_device([p1, m1]),
                "launches": {k: after[k] - before[k] for k in after}}
            del p1, m1
        (ref_loss, _, ref_m), ref_first = timed(lambda: train_step(
            params, zeros, tokens, labels, positions, cfg, lr=lr,
            momentum=momentum))
        rows = []
        for route, leg in routes.items():
            step, blocks, mblocks = steps[route]
            ref_runs, runs = [], []
            for _ in range(3):
                ref_runs.append(timed(lambda: train_step(
                    params, zeros, tokens, labels, positions, cfg, lr=lr,
                    momentum=momentum))[1])
                runs.append(timed(lambda: step(blocks, mblocks, tokens,
                                               labels, positions))[1])
            rel = _grad_rel_errors(leg["momenta"], ref_m, zeros, momentum)
            worst = max(rel, key=rel.get)
            loss_rel = abs(leg["loss"] - ref_loss.item()) \
                / abs(ref_loss.item())
            want = {k: 0 for k in leg["launches"]}
            want["layer_norm"] = 2 * n + 1
            prof = _profiled(lambda: step(blocks, mblocks, tokens, labels,
                                          positions),
                             families=("layer_norm_kernel",))
            ms = float(np.median(runs))
            rows.append({
                "route": route, "loss": leg["loss"],
                "train_step_loss": ref_loss.item(), "loss_rel_err": loss_rel,
                "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
                "step_ms": ms, "step_ms_runs": runs,
                "first_step_ms": leg["first_step_ms"],
                "train_step_ms": float(np.median(ref_runs)),
                "train_step_ms_runs": ref_runs,
                "train_step_first_ms": ref_first,
                "tokens_per_s": B * T / (ms / 1e3),
                "stored_bytes": leg["stored_bytes"],
                "launches": leg["launches"],
                "layer_norm_by_name": prof["families"]["layer_norm_kernel"],
                "idle_share": prof["idle_share"],
                "lost_records": prof["lost_records"]})
            if loss_rel > 1e-5 or rel[worst] > 1e-4:
                bad.append(f"partitioned {route}: loss {loss_rel:.3g}, "
                           f"gradient of {worst} {rel[worst]:.3g}")
            if leg["launches"] != want:
                bad.append(f"partitioned {route} launched "
                           f"{leg['launches']}, not {want}")
            if prof["families"]["layer_norm_kernel"] != 2 * n + 1:
                bad.append(f"partitioned {route}: "
                           f"{prof['families']['layer_norm_kernel']} "
                           f"LayerNorm kernels by name, not {2 * n + 1}")
            leg.pop("momenta")
        del ref_m, steps

        # -- the pipeline at pp=1 ---------------------------------------------
        pp = pmesh.make_mesh(pp=1, device=dev, install=False)
        stage = _mp_stage_fn(cfg)
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(MP_PIPE_MICRO, 1, T, cfg.d_model, generator=g,
                        device=dev)
        c = torch.randn(x.shape, generator=g, device=dev)
        stacked = {k: v.clone().requires_grad_()
                   for k, v in _mp_stacked(params, cfg, 1).items()}
        xg = x.clone().requires_grad_()
        before = _read_launches()

        def piped():
            y = pipeline_apply_sharded(stage, stacked, xg, mesh=pp)
            return (y.detach(), *torch.autograd.grad(
                (y * c).sum(), [xg, *stacked.values()]))

        (y, *gp), pipe_ms = timed(piped)
        pipe_launches = {k: v - before[k]
                         for k, v in _read_launches().items()}
        seq_st = {k: v.detach()[0].clone().requires_grad_()
                  for k, v in stacked.items()}
        xs = x.clone().requires_grad_()

        def sequential():
            ys = torch.stack([stage(seq_st, xs[i])
                              for i in range(MP_PIPE_MICRO)])
            return (ys.detach(), *torch.autograd.grad(
                (ys * c).sum(), [xs, *seq_st.values()]))

        (ys, *gs), seq_ms = timed(sequential)
        pipe_err = {"out": _rel_err(y, ys), "grad_x": _rel_err(gp[0], gs[0]),
                    "grad_params": max(_rel_err(a[0], b) for a, b in
                                       zip(gp[1:], gs[1:]))}
        if max(pipe_err.values()) > 1e-5:
            bad.append(f"pipeline at pp=1 against the sequential blocks: "
                       f"{pipe_err}")
        if pipe_launches["layer_norm"] != 2 * n * MP_PIPE_MICRO:
            bad.append(f"pipeline: {pipe_launches['layer_norm']} "
                       f"LayerNorms, not {2 * n * MP_PIPE_MICRO}")
        del stacked, seq_st, gp, gs, y, ys

        # -- Switch MoE at ep=1 ---------------------------------------------------
        ep = pmesh.make_mesh(ep=1, device=dev, install=False)
        D, Fd = cfg.d_model, cfg.d_ff
        xm = torch.randn(MP_MOE_TOKENS, D, generator=g, device=dev)
        cm = torch.randn(MP_MOE_TOKENS, D, generator=g, device=dev)
        w = {"w_in": torch.randn(1, D, Fd, generator=g, device=dev)
             / D ** 0.5,
             "w_out": torch.randn(1, Fd, D, generator=g, device=dev)
             / Fd ** 0.5}
        rw = torch.randn(D, 1, generator=g, device=dev)

        def expert(p, h):
            return F.gelu(h @ p["w_in"], approximate="tanh") @ p["w_out"]

        def moe_run(fn):
            leaves = [t.clone().requires_grad_() for t in
                      (xm, rw, w["w_in"], w["w_out"])]
            out = fn(*leaves)
            return (out.detach(), *torch.autograd.grad(
                (out * cm).sum(), leaves, allow_unused=True))

        (ym, *gm), moe_ms = timed(lambda: moe_run(
            lambda x_, r_, a, b: moe_apply_sharded(
                x_, r_, {"w_in": a, "w_out": b}, expert, mesh=ep,
                capacity_factor=2.0)))

        def dense(x_, r_, a, b):
            gate = torch.softmax(x_ @ r_, dim=-1).max(dim=-1).values
            return gate[:, None] * expert({"w_in": a[0], "w_out": b[0]}, x_)

        (yd, *gd), dense_ms = timed(lambda: moe_run(dense))
        moe_err = {"out": _rel_err(ym, yd)}
        for nm, a, b in zip(("x", "router", "w_in", "w_out"), gm, gd):
            moe_err["grad_" + nm] = 0.0 if b is None or not b.abs().max() \
                else _rel_err(a, b)
        if max(moe_err.values()) > 1e-5:
            bad.append(f"MoE at ep=1 against the dense oracle: {moe_err}")
        del gm, gd

        # -- paged attention per head at mp=1 ----------------------------------
        mp1 = pmesh.make_mesh(mp=1, device=dev, install=False)
        paged = []
        for case in _paged_cases():
            if case[0] not in ("decode", "prefill"):
                continue
            for int8 in (False, True):
                q, kp, vp, ks, vs, tables, pos, mpos = _paged_inputs(
                    dev, torch.float32, int8, case, rotate=False)
                before = _read_launches()

                def sharded():
                    return paged_attention_sharded(
                        q, kp, vp, tables[0], pos, mpos, mp1, k_scale=ks,
                        v_scale=vs)

                got = sharded()
                counted = {k: v - before[k]
                           for k, v in _read_launches().items()}
                want = paged_attention(q, kp, vp, tables[0], pos, mpos,
                                       k_scale=ks, v_scale=vs)
                # by name in a session opened with PROFILE_LEAD empty
                # kernels: late in a long process, a bare session can
                # come back without the first records (_profiled)
                names = _profiled(sharded, families=("paged_",))[
                    "family_names"]["paged_"]
                ok, other = _routed(names, PAGED_ROUTES[case[0]])
                same = torch.equal(got, want)
                key = "paged_attention_int8" if int8 else "paged_attention"
                paged.append({"case": case[0],
                              "kv": "int8" if int8 else "float32",
                              "bitwise": same, "launches": counted[key],
                              "kernels": names, "routes_ok": ok})
                if not same or counted[key] != 1 or not ok:
                    bad.append(f"paged_attention_sharded {case[0]} "
                               f"{'int8' if int8 else 'float'}: bitwise "
                               f"{same}, {counted[key]} launches, kernels "
                               f"{names}")
        launches = _read_launches()
    finally:
        pmesh.shutdown()
    res = {"phase": "model_parallel", "config": dataclasses.asdict(cfg),
           "B": B, "T": T, "lr": lr, "momentum": momentum,
           "world": {"backend": "nccl", "size": 1},
           "partitioned": rows,
           "tolerance": {"loss_rel": 1e-5, "grad_rel": 1e-4,
                         "pipeline_moe_rel": 1e-5},
           "pipeline": {"stages": 1, "blocks_a_stage": n,
                        "microbatches": MP_PIPE_MICRO,
                        "microbatch": [1, T, cfg.d_model],
                        "rel_err": pipe_err, "fwd_bwd_ms": pipe_ms,
                        "sequential_fwd_bwd_ms": seq_ms,
                        "launches": pipe_launches},
           "moe": {"experts": 1, "tokens": MP_MOE_TOKENS, "d_model": D,
                   "d_ff": Fd, "capacity_factor": 2.0, "rel_err": moe_err,
                   "fwd_bwd_ms": moe_ms, "dense_fwd_bwd_ms": dense_ms},
           "paged_attention_sharded": paged,
           "launches": launches}
    emit(res)
    if bad:
        raise SystemExit("model_parallel phase failed: " + "; ".join(bad))
    return res


# module_parallel: the symbolic API over a mesh of one card
MPAR_STEPS, MPAR_TIMED = 3, 4      # compared steps, then timed steps
MPAR_G2C = (4, 128, 1024)          # group2ctx layers, batch, width
MPAR_PP = (8, 4, 64, 1024)         # pp symbol: layers, stages, batch, width


def _mpar_module(net, it, start, mesh=None):
    """A ``Module`` over ``net`` bound on the card from ``start``'s
    parameters, with ``mesh`` attached to its executor (a dp mesh of the
    world: the mesh fused step) or none (the plain fused step)."""
    import mxnet_tpu_torch as mx

    mod = mx.mod.Module(net, label_names=["softmax_label"])
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=start[0], aux_params=start[1])
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                       optimizer_params={"learning_rate": FIT_LR,
                                         "momentum": FIT_MOMENTUM})
    if mesh is not None:
        mod._exec.set_spmd(mesh, ["data", "softmax_label"])
    return mod


def _mpar_steps(mod, batches):
    """One fused step a batch: each step's loss, and ms (a sync, then the
    host clock) of each."""
    import torch

    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not mod._try_fused_step(b):
            raise SystemExit("module_parallel: the fused step was not taken")
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(_ce(mod.get_outputs()[0], b.label[0]))
    return losses, ms


def _mpar_resnet(mesh):
    """The module_fit ResNet-50 symbol (NCHW f32, B=RESNET_BATCH): the mesh
    fused step against the plain fused step from the same parameters,
    MPAR_STEPS batches (loss, every parameter and moving statistic
    bitwise), then MPAR_TIMED more of each, in turns."""
    import gc

    import torch

    import mxnet_tpu_torch as mx

    net, _, _ = _fit_loaded_symbol()
    B = RESNET_BATCH
    X, Y = _fit_images(MPAR_STEPS, B, SEED + 11)
    it = mx.io.NDArrayIter(X, Y, batch_size=B)
    batches = list(it)
    torch.manual_seed(SEED)
    mod = mx.mod.Module(net, label_names=["softmax_label"])
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    start = mod.get_params()
    del mod
    res, finals = {}, {}
    for route, m in (("plain", None), ("mesh", mesh)):
        mod = _mpar_module(net, it, start, m)
        losses, ms = _mpar_steps(mod, batches)
        arg, aux = mod.get_params()
        finals[route] = {**arg, **{"aux:" + k: v for k, v in aux.items()}}
        res[route] = {"losses": losses, "ms": ms, "module": mod}
    # timed steps in turns over one batch (each module goes on training)
    for _ in range(MPAR_TIMED):
        for route in ("plain", "mesh"):
            _, ms = _mpar_steps(res[route]["module"], batches[:1])
            res[route].setdefault("timed_ms", []).extend(ms)
    for route in res:
        del res[route]["module"]
        res[route]["step_ms"] = float(np.median(res[route]["timed_ms"]))
    gc.collect()
    bitwise = {k: bool(torch.equal(finals["plain"][k]._data,
                                   finals["mesh"][k]._data))
               for k in finals["plain"]}
    out = {"B": B, "steps": MPAR_STEPS, **res,
           "losses_bitwise": res["plain"]["losses"] == res["mesh"]["losses"],
           "params_bitwise": all(bitwise.values()),
           "tensors": len(bitwise),
           "not_bitwise": sorted(k for k, v in bitwise.items() if not v),
           "mesh_over_plain": res["mesh"]["step_ms"]
           / res["plain"]["step_ms"]}
    bad = []
    if not (out["losses_bitwise"] and out["params_bitwise"]):
        bad.append(f"ResNet-50 mesh step is not the plain step bit for bit: "
                   f"losses {res['plain']['losses']} vs "
                   f"{res['mesh']['losses']}, differing {out['not_bitwise']}")
    if not all(np.isfinite(res["mesh"]["losses"])):
        bad.append(f"non-finite mesh loss {res['mesh']['losses']}")
    return out, bad


def _mpar_channels_last(dev, mesh):
    """The channels-last check net (``_nhwc_symbol``) through the mesh
    fused step, NHWC_BATCHES batches: each step launches NHWC_UNITS
    BatchNorm stats and normalize kernels (wrapper counts, from 0 just
    before); one more step profiled for the kernels by name.  Outside the
    counted window: each BatchNorm's kernels held against their plain
    versions on this path's activation (B x 56 x 56 x 256), as the kernels
    phase holds them (f32 tolerance, bitwise repeatable)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import batch_norm as bn

    net = _nhwc_symbol()
    B, n = NHWC_BATCH, NHWC_BATCHES
    X, Y = _fit_images(n, B, SEED + 12, (NHWC_HW, NHWC_HW, NHWC_C), 10)
    params, aux = _random_values(net, (B, NHWC_HW, NHWC_HW, NHWC_C),
                                 SEED + 13, 10)
    start = ({k: v for k, v in params.items()
              if k not in ("data", "softmax_label")}, aux)
    it = mx.io.NDArrayIter(X, Y, batch_size=B)
    batches = list(it)
    mod = _mpar_module(net, it, start, mesh)
    torch.cuda.synchronize()
    _reset_launches()
    losses, ms = _mpar_steps(mod, batches)
    torch.cuda.synchronize()
    launches = _read_launches()
    prof = _profiled(lambda: mod._try_fused_step(batches[0]), families=(
        "bn_stats_partial", "bn_stats_final", "bn_normalize"))
    # the kernels against their plain versions on this path's input
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    x = torch.randn(B * NHWC_HW * NHWC_HW, NHWC_C, generator=g, device=dev)
    gam = 1.0 + 0.1 * torch.randn(NHWC_C, generator=g, device=dev)
    bet = 0.1 * torch.randn(NHWC_C, generator=g, device=dev)
    runs = [bn.bn_train_fused(x, gam, bet, 2e-5) for _ in range(2)]
    want = bn.bn_train_reference(x, gam, bet, 2e-5)
    errs, ok = {}, True
    for name, a, b in zip(("out", "mean", "var"), runs[0], want):
        good, errs[name], _ = _close(a, b, "batch_norm")
        ok = ok and good
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(*runs))
    res = {"B": B, "batches": n, "units": NHWC_UNITS,
           "shape": [B, NHWC_HW, NHWC_HW, NHWC_C], "losses": losses,
           "step_ms": ms, "launches": launches,
           "profiled": {k: prof[k] for k in ("families", "family_names",
                                             "lost_records", "idle_share")},
           "kernels_vs_plain": {"max_abs_err": errs, "ok": ok,
                                "bitwise_repeatable": bitwise}}
    bad = []
    want_l = {k: 0 for k in launches}
    want_l.update(bn_stats=NHWC_UNITS * n, bn_normalize=NHWC_UNITS * n)
    if launches != want_l:
        bad.append(f"channels-last mesh steps launched {launches}, "
                   f"expected {want_l}")
    fam = prof["families"]
    if not (fam["bn_stats_partial"] == fam["bn_stats_final"]
            == fam["bn_normalize"] == NHWC_UNITS):
        bad.append(f"profiled channels-last mesh step ran BatchNorm kernels"
                   f" {fam}, expected {NHWC_UNITS} of each")
    if not (ok and bitwise):
        bad.append(f"BatchNorm kernels vs plain on the mesh path: {errs}, "
                   f"bitwise repeatable {bitwise}")
    if not all(np.isfinite(losses)):
        bad.append(f"non-finite channels-last mesh loss {losses}")
    return res, bad


def _mpar_group2ctx(dev):
    """``group2ctx`` with layers alternating between ``gpu(0)`` and
    ``cpu(0)`` (``example/model-parallel/group2ctx_lstm.py``'s stacked
    tanh layers): a training forward and a backward with head gradients
    against the ungrouped executor on the card, outputs and every
    gradient within 1e-5 normwise; where each group's weights live."""
    import torch

    import mxnet_tpu_torch as mx

    L, B, H = MPAR_G2C
    with mx.name.NameManager():
        h = mx.sym.Variable("data")
        for g in range(L):
            with mx.AttrScope(ctx_group=f"layer{g}"):
                h = mx.sym.Activation(mx.sym.FullyConnected(
                    h, num_hidden=H, name=f"l{g}"), act_type="tanh")
        out = mx.sym.FullyConnected(h, num_hidden=2, name="out")
    g2c = {f"layer{g}": mx.gpu(0) if g % 2 == 0 else mx.cpu(0)
           for g in range(L)}
    rs = np.random.default_rng(SEED + 15)
    vals = {n: (rs.standard_normal(s) / np.sqrt(s[-1] if len(s) > 1 else 1)
                ).astype(np.float32)
            for n, s in zip(out.list_arguments(),
                            out.infer_shape(data=(B, H))[0])}
    ct = rs.standard_normal((B, 2)).astype(np.float32)

    def run(group2ctx):
        ex = out.simple_bind(ctx=mx.gpu(0), group2ctx=group2ctx,
                             data=(B, H))
        for n, v in vals.items():
            ex.arg_dict[n]._data.copy_(torch.from_numpy(v))
        t0 = time.perf_counter()
        o = ex.forward(is_train=True)[0]._data
        ex.backward(out_grads=[mx.nd.array(ct, ctx=mx.gpu(0))])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = {"out": o.cpu()}
        got.update({"grad:" + n: g._data.cpu()
                    for n, g in ex.grad_dict.items()})
        where = {n: str(ex.arg_dict[n]._data.device)
                 for n in ("l0_weight", "l1_weight", "out_weight")}
        return got, where, wall, ex

    grouped, where, g_ms, ex = run(g2c)
    plain, _, p_ms, _ = run(None)
    errs = {k: _rel(grouped[k], plain[k]) for k in plain}
    worst = max(errs, key=errs.get)
    res = {"layers": L, "B": B, "width": H,
           "groups": {k: str(v) for k, v in g2c.items()},
           "segments": ex._grouped.num_segments, "placed": where,
           "max_rel_err": errs[worst], "worst": worst, "tolerance": 1e-5,
           "fwd_bwd_ms": g_ms, "ungrouped_fwd_bwd_ms": p_ms}
    bad = []
    if errs[worst] > 1e-5:
        bad.append(f"group2ctx vs ungrouped: {worst} by {errs[worst]:.3g}")
    if not (where["l0_weight"].startswith("cuda")
            and where["l1_weight"] == "cpu" and res["segments"] == L):
        bad.append(f"group2ctx placement {where}, {res['segments']} "
                   f"segments")
    return res, bad


def _mpar_plan():
    """``plan_pipeline``'s split of a stage-stackable FC stack (MPAR_PP)
    into its stages: the describe line and each stage's parameters."""
    import types

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.symbol.staging import plan_pipeline

    L, S, B, H = MPAR_PP
    net = _mpar_stack(mx, L, H)
    shapes, _, _ = net.infer_shape(data=(B, H), softmax_label=(B,))
    structs = {n: types.SimpleNamespace(shape=tuple(s), dtype=np.float32)
               for n, s in zip(net.list_arguments(), shapes)}
    plan = plan_pipeline(net._entries, S, structs,
                         input_names=["data", "softmax_label"])
    want = (f"pp plan: 1 prologue ops | {S} stages × {L // S} units "
            f"({2 * L // S} ops/stage) | 3 epilogue ops")
    res = {"layers": L, "stages": S, "describe": plan.describe(),
           "stage_params": plan.stage_param_names}
    bad = [] if plan.describe() == want else [
        f"pp plan {plan.describe()!r}, expected {want!r}"]
    return res, bad


def _mpar_stack(mx, layers, width, classes=10):
    """A stage-stackable FC stack: an input layer, ``layers`` equal
    FC + ReLU units, a classifier and ``SoftmaxOutput``."""
    with mx.name.NameManager():
        h = mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=width, name="fc_in"),
            act_type="relu")
        for i in range(layers):
            h = mx.sym.Activation(mx.sym.FullyConnected(
                h, num_hidden=width, name=f"body{i}"), act_type="relu")
        out = mx.sym.FullyConnected(h, num_hidden=classes, name="fc_out")
        return mx.sym.SoftmaxOutput(out, mx.sym.Variable("softmax_label"),
                                    name="softmax")


def phase_module_parallel(dev):
    """The symbolic API over a mesh (``Executor.set_spmd``, ``Module``'s
    mesh step, ``group2ctx``, ``plan_pipeline``) in a world of one process
    on NCCL (NCCL refuses two ranks on one card; ``chip_multicard.py``'s
    ``module`` legs run four).  The main path, counted from 0: the mesh
    fused step of the module_fit ResNet-50 symbol (f32, B=128), held bit
    for bit to the plain fused step (loss and every parameter and moving
    statistic after three steps), step ms of each in turns; the
    channels-last BatchNorm symbol's mesh steps (kernels 3-4 counted by
    wrapper and by name, and held to their plain versions).  Then
    ``group2ctx`` over ``gpu(0)`` and ``cpu(0)`` against the ungrouped
    executor, and the pipeline plan of an FC stack."""
    import gc

    import torch

    from mxnet_tpu_torch.parallel import mesh as pmesh

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the f32 comparison needs full f32")
    gc.collect()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        mesh = pmesh.make_mesh({"dp": 1}, install=False, device=dev)
        _reset_launches()
        resnet, bad = _mpar_resnet(mesh)
        resnet_launches = _read_launches()
        gc.collect()
        nhwc, bad_nhwc = _mpar_channels_last(dev, mesh)
        gc.collect()
        g2c, bad_g2c = _mpar_group2ctx(dev)
        plan, bad_plan = _mpar_plan()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
        pmesh.shutdown()
    launches = {k: resnet_launches[k] + nhwc["launches"][k]
                for k in resnet_launches}
    res = {"phase": "module_parallel",
           "world": {"backend": "nccl", "size": 1, "mesh": {"dp": 1}},
           "resnet50_mesh_vs_plain": resnet, "channels_last": nhwc,
           "group2ctx": g2c, "pipeline_plan": plan, "launches": launches}
    emit(res)
    bad += bad_nhwc + bad_g2c + bad_plan
    if any(resnet_launches.values()):
        bad.append(f"the channels-first ResNet launched port kernels: "
                   f"{resnet_launches}")
    if bad:
        raise SystemExit("module_parallel phase failed: " + "; ".join(bad))
    return res



def _kernel_table(kern, runs):
    """One row per CUDA kernel: its times and bound from the kernels phase
    at the main path's shape (2-bit pack and unpack: the largest of
    ResNet-50's gradients, 2,359,296 elements, with the sum over one
    step's 193 gradients beside it; LayerNorm and paged attention: the serving
    decode shape, f32, with paged attention's T=512 prefill chunk and its
    kernel functions beside it; flash attention: the training shape, bf16, causal —
    the bf16 recipe's; BatchNorm: ResNet-50's stage-1 expansion input,
    (128, 56, 56, 256) bf16), the largest error over all its cases, and its
    launches on each main path run (each counted from 0 just before its
    window).  The flash rows also carry, under ``float32``, the f32 route's
    numbers at the training shape (causal) and its launches in the
    training phase's f32 flash step."""
    flash, flash32 = (next(c for c in kern["flash_attention"]
                           if c["shape"] == "training" and c["dtype"] == d
                           and c["causal"])
                      for d in ("bfloat16", "float32"))
    bnorm = next(c for c in kern["batch_norm"]
                 if c["shape"] == [128, 56, 56, 256]
                 and c["dtype"] == "bfloat16")
    pick = {"layer_norm": lambda r: r["M"] == 8 and not r["gelu"]
            and r["dtype"] == "float32",
            "paged_attention": lambda r: r["case"] == "decode"
            and r["dtype"] == "float32",
            "paged_attention_int8": lambda r: r["case"] == "decode"
            and r["dtype"] == "float32"}
    meta = {"twobit_pack": ("mxnet_tpu_torch/ops/csrc/twobit.cu",
                            "mxnet_tpu/ops/pallas_kernels.py:41"),
            "twobit_unpack": ("mxnet_tpu_torch/ops/csrc/twobit.cu",
                              "mxnet_tpu/ops/pallas_kernels.py:59"),
            "bn_stats": ("mxnet_tpu_torch/ops/csrc/batch_norm.cu",
                         "mxnet_tpu/ops/pallas_kernels.py:190"),
            "bn_normalize": ("mxnet_tpu_torch/ops/csrc/batch_norm.cu",
                             "mxnet_tpu/ops/pallas_kernels.py:222"),
            "layer_norm": ("mxnet_tpu_torch/ops/csrc/layer_norm.cu",
                           "mxnet_tpu/ops/pallas_kernels.py:325"),
            "paged_attention": ("mxnet_tpu_torch/ops/csrc/paged_attention.cu",
                                "mxnet_tpu/ops/paged_attention.py:71"),
            "paged_attention_int8": (
                "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
                "mxnet_tpu/ops/paged_attention.py:121"),
            "flash_attention_fwd": (
                "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
                "mxnet_tpu/ops/flash_attention.py:88"),
            "flash_attention_dq": (
                "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
                "mxnet_tpu/ops/flash_attention.py:207"),
            "flash_attention_dkv": (
                "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
                "mxnet_tpu/ops/flash_attention.py:242")}
    rows = []
    for name, (src, rep) in meta.items():
        extra = {}
        if name.startswith("twobit"):
            r = next(c for c in kern["twobit"] if c["kernel"] == name[7:])
            err = r["max_abs_err"]
            extra = {k: r[k] for k in ("largest_shape", "step_ms",
                                       "step_plain_ms", "step_bound_ms")}
        elif name.startswith("bn_"):
            part = name[3:]
            r = {k: bnorm[k][part] for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}
            outs = ("mean", "var") if part == "stats" else ("out",)
            err = max(c["max_abs_err"][o] for c in kern["batch_norm"]
                      for o in outs)
        elif name.startswith("flash"):
            part = name.rsplit("_", 1)[1]
            outs = {"fwd": ("out", "lse"), "dq": ("dq",),
                    "dkv": ("dk", "dv")}[part]
            r = {"ms": flash["ms"][part], "plain_ms": flash["plain_ms"][part],
                 "bound_ms": flash["bound_ms"][part],
                 "bound_by": flash["bound_by"][part],
                 # one library call computes the forward; none computes
                 # dQ or dK/dV alone (SDPA's backward is in the kernels
                 # phase's sdpa_ms)
                 "library_ms": flash["sdpa_ms"]["fwd"] if part == "fwd"
                 else None}
            err = max(c["max_abs_err"][o] for c in kern["flash_attention"]
                      for o in outs)
            i = ("fwd", "dq", "dkv").index(part)
            extra = {"functions": {d: f[i] for d, f in FLASH_ROUTES.items()}}
            f32_step = runs.get("training", {}).get("f32", {}).get("flash")
            extra["float32"] = {
                **{k: flash32[k][part] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
                "library_ms": flash32["sdpa_ms"]["fwd"] if part == "fwd"
                else None,
                "launches": f32_step["launches"][name] if f32_step
                else None}
        else:
            r = next(c for c in kern[name] if pick[name](c))
            err = max(c["max_abs_err"] for c in kern[name])
            if name == "layer_norm":
                # the training step's rows beside the decode row above
                extra = {"M8192": {
                    c["dtype"]: {k: c[k] for k in ("ms", "plain_ms",
                                                   "library_ms", "bound_ms",
                                                   "bound_by")}
                    for c in kern[name] if c["M"] == 8192 and not c["gelu"]}}
            if name.startswith("paged"):
                # the decode call's numbers above; the T=512 prefill
                # chunk's beside them
                pre = next(c for c in kern[name] if c["case"] == "prefill"
                           and c["dtype"] == "float32")
                extra = {"functions": PAGED_ROUTES,
                         **{"prefill_" + k: pre[k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by")},
                         "verify": {
                             c["case"]: {k: c[k] for k in (
                                 "ms", "plain_ms", "bound_ms", "bound_by")}
                             for c in kern[name] if c["kind"] == "verify"
                             and c["dtype"] == "float32"}}
        by_phase = {ph: res["launches"][name] for ph, res in runs.items()}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": sum(by_phase.values()),
                     "launches_by_phase": by_phase, "max_abs_err": err,
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], **extra})
    return rows


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    phases = set(argv[1].split(",")) if len(argv) > 1 else {
        "kernels", "model", "training", "serving", "serving_default",
        "serving_int8", "resnet_training", "resnet_compressed",
        "gluon_training", "module_fit", "gluon_hybrid", "rnn_lm",
        "bucketing_fit", "image_rec", "serving_spec", "serving_fleet",
        "ops_breadth", "fcn_fit", "spmd_lm", "dp_mesh", "dist_kvstore",
        "model_parallel", "module_parallel", "amp", "fit_resume",
        "inference_service", "inference_int8", "optimizers", "custom_op",
        "sparse_fit", "control_flow", "image_iter", "ssd_fit"}
    if "serving_int8" in phases:
        phases.add("serving")   # its float baseline
    t_start = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    kern = phase_kernels(dev) if "kernels" in phases else None
    runs = {}
    if phases & {"model", "training", "serving", "serving_default",
                 "serving_int8", "profile", "profile_training", "spmd_lm",
                 "model_parallel"}:
        cfg, params = _model(dev)
        if "model" in phases:
            phase_model(dev, cfg, params)
        if "training" in phases:
            runs["training"] = phase_training(dev, cfg, params)
        if "spmd_lm" in phases:
            runs["spmd_lm"] = phase_spmd_lm(dev, cfg, params)
        if "model_parallel" in phases:
            runs["model_parallel"] = phase_model_parallel(dev, cfg, params)
        if "serving" in phases:
            runs["serving"] = phase_serving(dev, cfg, params)
        if "serving_default" in phases:
            runs["serving_default"] = phase_serving_default(dev, cfg,
                                                              params)
        if "serving_int8" in phases:
            runs["serving_int8"] = phase_serving(
                dev, cfg, params, kv_dtype="int8",
                baseline=runs["serving"])
        if "profile" in phases:
            phase_profile(dev, cfg, params)
        if "profile_training" in phases:
            phase_profile_training(dev, cfg, params)
        del params
    if "resnet_training" in phases:
        runs["resnet_training"] = phase_resnet_training(dev)
    if "resnet_compressed" in phases:
        runs["resnet_compressed"] = phase_resnet_compressed(dev)
    if "dp_mesh" in phases:
        runs["dp_mesh"] = phase_dp_mesh(dev)
    if "dist_kvstore" in phases:
        runs["dist_kvstore"] = phase_dist_kvstore(dev)
    if "gluon_training" in phases:
        runs["gluon_training"] = phase_gluon_training(dev)
    if "module_fit" in phases:
        runs["module_fit"] = phase_module_fit(dev)
    if "fit_resume" in phases:
        runs["fit_resume"] = phase_fit_resume(dev)
    if "inference_service" in phases:
        runs["inference_service"] = phase_inference_service(dev)
    if "inference_int8" in phases:
        runs["inference_int8"] = phase_inference_int8(dev)
    if "optimizers" in phases:
        runs["optimizers"] = phase_optimizers(dev)
    if "custom_op" in phases:
        runs["custom_op"] = phase_custom_op(dev)
    if "amp" in phases:
        runs["amp"] = phase_amp(dev, runs)
    if "module_parallel" in phases:
        runs["module_parallel"] = phase_module_parallel(dev)
    if "gluon_hybrid" in phases:
        runs["gluon_hybrid"] = phase_gluon_hybrid(dev)
    if "rnn_lm" in phases:
        runs["rnn_lm"] = phase_rnn_lm(dev)
    if "bucketing_fit" in phases:
        runs["bucketing_fit"] = phase_bucketing_fit(dev)
    if "sparse_fit" in phases:
        runs["sparse_fit"] = phase_sparse_fit(dev)
    if "control_flow" in phases:
        runs["control_flow"] = phase_control_flow(dev, runs.get("rnn_lm"))
    if "image_rec" in phases:
        runs["image_rec"] = phase_image_rec(dev, runs.get("module_fit"))
    if "image_iter" in phases:
        runs["image_iter"] = phase_image_iter(dev)
    if "ssd_fit" in phases:
        runs["ssd_fit"] = phase_ssd_fit(dev)
    if "ops_breadth" in phases:
        runs["ops_breadth"] = phase_ops_breadth(dev)
    if "fcn_fit" in phases:
        runs["fcn_fit"] = phase_fcn_fit(dev, smi)
    # the generation phases last, on the LM built again
    if phases & {"serving_spec", "serving_fleet"}:
        cfg, params = _model(dev)
        if "serving_spec" in phases:
            runs["serving_spec"] = phase_serving_spec(dev, cfg, params)
        if "serving_fleet" in phases:
            runs["serving_fleet"] = phase_serving_fleet(dev, cfg, params)
        del params
    if "profile_resnet" in phases:
        phase_profile_resnet(dev)
    if kern is not None and runs:
        emit({"kernels": _kernel_table(kern, runs)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
