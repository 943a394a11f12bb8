#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: serving, training, eval,
deployment, region proposals, the ViT-L/14 distillation run from files,
the multi-rank paths and the last modules (context view, BERT, detector
training).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases; each one passes or raises, and any failure exits non-zero:

1. Device: requires `torch.cuda.is_available()`; prints the card's
   `nvidia-smi --query-gpu=name,power.limit` line.
2. Build and load: compiles `dclip_tpu_torch/kernels/csrc/*.cu` with nvcc
   from the checkout, prints the build time and ptxas resource lines, then
   loads the library, which runs its self-check (one x2 launch on an
   [8, 128] f32 buffer, compared exactly) and prints the result.
3. Kernels: at ViT-B/16 shapes (B=64, S=197, D=768, 12 heads, MLP 3072,
   bf16) holds every CUDA kernel (layernorm, the four GEMM epilogues,
   attention) and both blocks (attention, MLP) against their plain
   PyTorch twins on the same inputs, plus a ragged B=1 case and the
   retrieval eval's B=256, and again at ViT-L/14 shapes (B=64, S=257,
   D=1024, 16 heads, MLP 4096: the zero-shot eval's); times kernel and
   twin at B/16 B=64 and L/14 B=64 with CUDA events in turns (plain,
   kernel, kernel, plain), the LayerNorm beside `F.layer_norm` there and at
   the teacher ViT's crops (403,456 x 768 rows). Then the GEMM (`csrc/gemm.cu`) alone: NN and NT
   at the four projections of a B/16 layer for M = 12,608 (serving bucket
   64), 50,432 (the student at B=256) and 403,456 (the teacher ViT over
   2,048 crops), at L/14 widths the region encode's four for M = 526,336
   and K6's forward (a1 saved) and dx for M = 65,792, TN at K8's and K9's
   weight-gradient shapes, each timed in turns against one PyTorch call
   (`torch.addmm` / `torch.mm` / `F.linear` with a bf16 bias,
   `torch.matmul`), with TFLOP/s, share of the bf16 peak and the schedule
   that ran (wide / narrow); held against the twin at the two smaller B/16
   M, and on the first and last 1,024 rows at the L/14 ones.
4. Slice: builds the B/16 `ClipService` through the serve CLI's own
   `build_service` (random weights from seed 0, bf16, buckets 1,4,16,64,
   index_dim 512), runs `warmup()`, the CLI's `--selftest` against a live
   HTTP server, and 8 random images; checks the launch counters rose by
   exactly 12 layers x launches per layer x image batches, the embeddings
   are 512-d, finite and unit-norm, and the bf16 kernel path agrees with
   the f32 plain-twin path on the card in cosine.
5. Timing: `--bench`-style lines per modality at concurrency 1 and 32.
6. Training kernels: at the ViT-B/16 cache-warm step's shapes holds the
   attention forward with stats (vision S=197 D=768 H=12 at B=256; the
   text tower's packed rows, causal + segments, and unpacked batch, causal
   + padding, S=77 D=512 H=8), its stats-free mode, the attention
   backward (dq, dk, dv), the frozen-MLP forward (y, a1) and dx, the
   LayerNorm backward, and the distillation loss (parts; dsi, dst) at
   B=256 against their plain twins, plus a ragged small case of each (the
   loss also at B=4,096, timed on lines of their own outside the table;
   two calls bit-identical at each B; beside the loss's eager per-call
   times, which the wrapper's host time bounds at B=256, the device times
   of it and its twin from CUDA graph replays of 20 calls, also outside
   the table), with
   CUDA-event times in turns, the attention backward beside SDPA's and the
   LayerNorm backward beside `F.layer_norm`'s input gradient. Then the
   attention backward, untimed, at every edge of its tiles, blocks, narrow
   last tile and ring (S = 1, 63, 64, 65, 128, 197, 257, 320, 321) with
   each mask kind, two calls on the same inputs giving the same bits.
7. Cross-attention kernels (K10): at the teacher tail's shapes (B=256, 77
   text tokens with the synthetic batch's content-token masks, 8 boxes with
   two all-invalid rows and random others, D=512, 8 heads, f32 inputs)
   holds the fused cross-attention, its attention core and its add +
   LayerNorm pass against their twins, and times them, the core also
   beside two `scaled_dot_product_attention` calls (one a direction, with
   boolean key masks); times the loader's self-check kernel. Every
   torch.profiler window below also prints the device time of K10's and
   K11's kernels by name.
8. Training slice, cache-warm: the port's `DistillTrainer` at ViT-B/16
   (student = teacher CLIP, random weights from seed 0, bf16, kernels on,
   packed text, B=256, accumulate 1) on the synthetic batch (seed 0) with
   its full teacher targets in an in-memory `TeacherTargetCache` (seeded
   unit vectors): 2 warm-up and 5 timed steps, finite and falling loss,
   launch counters at exactly 7 x the per-step count, one no-grad packed
   text encode on the stats-free attention, a torch.profiler window of 2
   steps, ms per step and cache-warm images/s.
9. Training slice, uncached (the main path of this slice): the same trainer
   with the meta-teacher `TeacherConfig(512, 8 heads, 8 boxes, 77 tokens)`
   (random weights from seed 0) and no teacher cache, as bench.py runs it:
   every step crops the 2,048 boxes, runs the teacher ViT over them (K1 /
   K2), the teacher text tower (K3) and the cross-attention (K10), then the
   student step. 2 warm-up and 5 timed steps: ms per step, images/s, peak
   device memory, exact launch counts (7 x the per-step count), a
   torch.profiler breakdown of one step by stage and by kernel. Then one
   step with the teacher's k-NN gate over a 100,000-row store of seeded
   unit keys: the same launches plus one K12 (Q = 2,048 patch embeddings),
   and a second gated step under torch.profiler: its device time by
   kernel, K12's kernels by name, beside the gated and ungated step times.
   Then one step with the gate's projection head too (`projection_params`,
   seeded): the same launches, every patch a miss that takes source 1.
10. Cache levels: a `TeacherTargetCache`; the first step misses and fills
   every level, a repeat hits the device full-target level (no K1 / K2 /
   K10 launch), the same images with resampled captions hit the device
   patch-embedding level (no K1 / K2 launch, one K10).
11. Teacher-target agreement: B=2, 8 boxes (3 invalid), full width and
   depth: the bf16 kernels on the card vs the port's f32 plain path (the
   modules, no kernel) on the CPU on the same weights; per-row cosine
   >= 0.99 for the image and the text target.
12. Gradient agreement: one cache-warm step's trainable gradients at full
   width and depth, B=8, bf16 kernels on the card vs the same step in f32
   on the CPU through the twins: global cosine >= 0.99, every tensor >= 0.95.
13. Trainable-block kernels (K8, K9): at the fused step's shapes (the
   packed text rows [R, 77, 512], mlp 2048; vision [256, 197, 768], 12
   heads) holds K8's forward (y, a1) and its seven gradients, K9's forward
   (o, q, k, v, attn, m, rinv) and its eleven gradients, and their CUDA
   parts (the GEMM's NT and TN modes, the column sums, the LayerNorm
   weight-gradient backward) against their twins, plus a ragged small case
   of each, with CUDA-event times in turns.
14. K7 at ViT-L/14 widths: the frozen-MLP pair (K6, which K7 folds into)
   forward and dx at [32, 257, 1024], mlp 4096, against its twin, timed:
   the kernels line's `mlp_frozen_{fwd,bwd}[l14]` rows, whose launches are
   phase 31's.
15. Training slice, fused cache-warm: the slice of phase 8 with
   `fused_text_mlp` (K8) and `fused_attn_block` (K9): 2 warm-up and 5 timed
   steps, exact launch counts by the blocks' skip rules, peak memory, a
   profile, printed beside phase 8's numbers.
16. Gradient agreement in the fused configuration, as phase 12, with the
   vision LN1 unfrozen at epoch 0 so that K9's LayerNorm weight gradients
   are held too.
17. Fit: `DistillTrainer.fit` at B=32 in the fused configuration, 2 epochs
   of 2 steps, `UnfreezeStage(epoch=1, patterns=("mlp", "layer_norm"))`, a
   `CheckpointManager` in a temporary directory: K6 runs in epoch 0 only,
   K9 in both, the vision LN1 / MLP gradients are non-zero in epoch 1; a
   fresh trainer's `resume` restores step, parameters and optimizer state
   bit for bit and replays the stage, and its next update equals the
   uninterrupted trainer's bit for bit (no kernel sums with atomics).

18. K12, the streamed top-k: at the serving search (Q=64, N=1,000,000,
   D=512, k=10; a 2.05 GB f32 store on the card) and the teacher's k-NN
   gate (Q=2,048, N=100,000, k=3) against its twin (f32 matmul without TF32
   and a stable sort), plus a ragged N, all-negative scores, k > N,
   duplicated rows, k = 64, k = 150 (three rounds of 64), 200 equal rows
   at k = 150, a TF32 trap (entries with bits below TF32's on both sides,
   where one TF32 product errs by 3e-4), near ties 2-5x the tolerance
   apart (indices equal to the twin's), ragged N at D = 8 and 16, and two
   chunk plans giving equal bits (k = 10 and 100); scores within 1e-5 *
   max(1, |twin|), indices equal wherever the twin's neighbouring scores
   are further apart than that, exact ties to the lower row; CUDA-event
   times beside `torch.matmul` + `torch.topk`, with the 3xTF32 bound and
   the f32 CUDA-core one. Phase 4's service searches through K12 (the
   selftest's search, then a 1,000,000-row index: the first search after
   the add, which copies the keys to the card once, and 3 searches of 64
   queries over the device-resident keys, each timed end to end, with the
   peak device memory; one search by the per-call-copy path timed beside
   them; all results bit-equal to K12 over the store's keys on the card).
19. Retrieval eval: ViT-B/16 from `load_clip` (random weights, seed 0,
   bf16) embeds 1,000 seeded preprocessed images (`make_image_encoder`, K1 /
   K2) and 5,000 captions of 8-24 hash-tokenizer words (packed), then
   `retrieval_metrics` on the card: ranks equal to the CPU port's on the
   same similarity, the similarity within 1e-5 of the CPU one, bf16 image
   embeddings vs the f32 module route on the card (cosine >= 0.99, 64
   images); images/s, captions/s, metrics ms.
20. Zero-shot eval: ViT-L/14 (the zero-shot CLI's default preset, full width
   and depth, bf16), 100 class prompts, 1,024 seeded images in batches of
   64 through `evaluate_zero_shot`, which runs the module route as the JAX
   eval does (no block kernel launches): top-1 / top-5 equal to the stable
   top-k of the same logits on the host; images/s. K1 / K2 at S=257,
   D=1024, 16 heads, MLP 4096 (the retrieval encoder's route) against the
   f32 module route, cosine >= 0.99 (32 images); phase 3 holds them at
   these widths against their twins.
21. Trainable cross-attention (`kernels.cross_attention_trainable`, K10's
   differentiable form) at B=32 and B=256, T=77 with the synthetic batch's
   content-token masks, P=8 with two boxless rows, D=512, 8 heads, bf16
   inputs: the forward against its f32 twin on the live weights, the
   gradients of both streams (one bf16 ulp) and all 12 parameters (1e-4 of
   the largest) against autograd through the f32 module; CUDA-event times
   of forward and backward with their bounds; two Adam steps after which
   K10 agrees with the twin on the updated weights and the pack made
   before the update does not.
22. Teacher training slice (the main path of the meta-teacher slice):
   `TeacherTrainer` at ViT-B/16 (random CLIP weights from seed 0, bf16,
   kernels on) with the meta-teacher of phase 9, no pe cache, at B=32 (the
   teacher CLI's default) and B=256: 2 warm-up and 5 timed steps, ms per
   step, images/s, peak memory, exact launches (per step 12 K1 + 12 K2
   over the B x 8 crops, 12 K3, one K10 call of 6 launches), a falling
   loss, a torch.profiler breakdown of one B=256 step by range.
23. Teacher fit: `TeacherTrainer.fit` at B=32, 2 epochs of 2 steps over
   in-memory batches with host indices, an in-memory pe cache with its
   device level, a `CheckpointManager` in a temporary directory: epoch 1
   launches no K1 / K2 and K10 every step; ms per step of both epochs; a
   fresh trainer's `resume` restores step, parameters and Adam state bit
   for bit and its next update equals the uninterrupted trainer's; a
   profile of one pe-cache-hit step.
24. Teacher gradient agreement: one step's gradients of the 12 teacher
   tensors at full width and depth, B=8, bf16 kernels on the card vs f32
   twins on the CPU: global cosine >= 0.99, every tensor >= 0.95 (the
   in_proj biases by their q and v parts; the k part, zero in exact
   arithmetic, held below 0.1 of the q part's norm).

25. Int8 serving: `ClipService(quantize="int8")` through the CLI's
   `build_service` (ViT-B/16, random weights from seed 0, buckets
   1,4,16,64, `--tokenizer_dir hash`): warmup, `--selftest`, no K1 / K2
   launch, both towers unit-norm and finite with cosine >= 0.99 against the
   f32 module route on the card on the same weights; `--bench` p50 and
   throughput at concurrency 1 and 32 beside phase 5's bf16 lines; the
   int8 weights' bytes against bf16 and f32.
26. Export: `--export_dir` for buckets 1 and 64 on platform cuda, f32 and
   int8, into a temporary directory: export time and each file's bytes;
   the int8 params.npz under 0.45 of the f32 one and every program under
   half its params.npz; `load_exported(device="cuda")` texts and images
   against the live service of the same route and weights (the f32 module
   route: cosine >= 0.999; int8: >= 0.99); ms per batch of each program.
27. Student: a perturbed student saved by the port's `CheckpointManager`
   and served through `--student_checkpoint`: its text embeddings move
   from the base service's and equal a service given the same weights
   directly; `cli.export_hf` writes its HF snapshot, which the port's
   reader loads back bit-equal, `logit_scale` 0-d.

28. Detector: YOLOv8x (`DetectorConfig.v8x()`, 640 px, random weights from
   seed 0, f32 with TF32 on process-wide: the detector pins f32
   convolutions for its forward) on seeded images (smooth colour fields
   with noise on top): `Detector.detect` at B = 1, 16, 32, the network and
   decode + NMS apart on CUDA events and the host clock, images/s, peak
   memory, beside the f32 bound from the module's own conv shapes (257.8
   GFLOPs an image, checked against ultralytics' table, over 67 TFLOP/s),
   a TF32 forward and a forward with `cudnn.benchmark` on (measurements
   only); a torch.profiler window of one B=1 forward (kernel count, device
   busy share, the top kernels); no hand-written kernel launches. The f32 logits of one image
   against the same module on the CPU (within 1e-4 of the largest |cpu|
   logit, the TF32 forward's error printed beside); decode against the CPU's on the
   same logits and postprocess on identical decoded candidates (B=16),
   indices, classes, masks, boxes and scores bit-equal.
29. Region tokens: the top 8 detections of each of phase 28's 32 images
   through `RegionTokenizer` at ViT-B/16 (random weights from seed 0, bf16,
   K1 / K2) with a seeded projection head, over 100,000 seeded unit keys,
   one of them planted for each region at a set cosine to its f32-route
   embedding (0.60 to 0.99, by the region's rank along the batch's first
   principal axis, so that neighbours get neighbouring cosines): exact K1 /
   K2 / K12 launches and ms of `batch_tokenize` and of an 8-threshold
   `evaluate_threshold` (one region encode, 8 K12); K12 at the gate's shape
   against its plain twin on the CPU; the sweep against the plain
   reference at every threshold, and moving; the region embeddings against
   the f32 module route, raw and centred on the batch mean (cosine >= 0.99
   both; another image's region in a region's place fails the centred
   bound); the sources
   against the reference's and the f32 route's; at a threshold above 1
   every region on the projection branch (centred cosine >= 0.99). The
   precache, build_index and tune_gate CLIs
   read images with PIL, which the card machine lacked when they were
   ported: the CPU tests run
   them.

30. Doctor: `cli.doctor.collect()` (versions, the card's name and power
   limit, a matmul, the kernel library's self-check, the native KV store's
   and the JPEG decoder's builds), printed.
31. ViT-L/14 distillation, the reference's student: student and teacher
   CLIP at `vit-l-14` (full width and depth, random weights from seed 0,
   bf16, kernels on, packed text) with `TeacherConfig(768, 8 heads, 8
   boxes, 77 tokens)` at B=256: the cache-warm step (targets of seeded unit
   vectors in an in-memory cache) and the uncached step (2,048 crops
   through the L/14 teacher), each with remat off and on, 2 warm-up and 3
   timed steps: ms per step, images/s, peak device memory (reset for each),
   exact launch counts (under remat every forward kernel of a student layer
   twice a step, the backward kernels once), the trainable parameters with
   remat bit-equal to those without (else the differing tensors named and
   the updates held to the gradient-agreement bounds). The L/14 teacher
   targets against the f32 module route on the CPU (cosine >= 0.99, B=2).
   `TeacherTrainer` at L/14, B=32 (the teacher CLI's default): 2 warm-up
   and 3 timed steps, exact launches, peak memory. K10 at D=768 (8 heads
   of 96), `cross_attention_trainable` at D=768, B=32, and K11 at D=768,
   B=256 against their twins, timed: the kernels line's `[d768]` rows,
   whose launches are this phase's.
32. Files: the committed JPEG fixtures (`tests/data/`) through the native
   decoder (shapes, ranges, original sizes, exact and scaled DCT); the PNG
   and the CMYK JPEG, which need PIL (raising without it, naming the
   file); a corpus of 64 items and a validation file of 8 over the JPEGs
   with a detection cache written by `DetectionCache.put`; the host's
   decode images/s with its CPU's name; then `cli.train_teacher` (one
   epoch) and `cli.train_distill` (`--remat`, `--teacher_checkpoint` the
   teacher's) at `--model_preset vit-l-14 --decode_backend native`, at
   their default batch: checkpoints exist and losses are finite. Where
   the machine cannot build the decoder, `decode_backend="native"` must
   raise naming it, and nothing falls back to PIL.

33. Data parallelism (run after phase 23): a one-rank NCCL group made by
   `cli.common.init_multihost` from the env triple on a free port (the
   backend, `torch.cuda.nccl.version()`, the preemption guard's flag
   gather on the card): (a) `DistillTrainer(dp_equivalent=True)` in the
   group at ViT-B/16, B=256, 3 uncached steps then the same batches
   cache-warm (after a warm-up step on a batch of its own), against the
   trainer without a group on the same seed:
   losses, the gradients summed by the all-reduce and every parameter
   bit-equal (else the largest differences printed), the same launches
   (K11 once a step, over the gathered batch), ms per step of both; (b)
   `TeacherTrainer` in the group at B=32, 3 steps, held the same way; (c)
   `knn_search_sharded` over 1,000,000 seeded unit keys with `n_valid`
   one row short (that row a query's copy) against `knn_search` (K12) over
   the valid rows: equal scores and indices, then 3 calls of each timed in
   turns; (d) `fit_with_preemption` at
   B=32, 2 epochs of 4 steps, SIGTERM to the process when batch 3 is
   drawn: the stop at step boundary 2, one `preempt` checkpoint whose
   parameters are bit-equal to 2 uninterrupted steps'. The group is
   destroyed at the end. Its launches add to the kernels line's rows.
34. Profiling: (a) `cli.profile.main` at `--model_preset
   vit-b-16 --batch 256 --steps 3 --json --trace_dir <tmp>`, the port's
   normal trainer: every phase above 0 and under 20x the full step (the
   JAX test's bound), each `images_per_sec_*` batch over its phase, the
   four MFU values (`core.flops`, the card's peak) non-null in (0, 1], a
   trace file written, the range table printed, and every kernel of the
   path launched (the counts reset before the run and read after it; they
   add to the kernels line's rows); (b) `--per_op --json` at B=256: every
   row at or above 0.95 of its floor at the card's constants, the
   composite above 0, K4 / K5 / K6 / K11 launched, the table printed; (c)
   as (a) at `vit-l-14`, 2 steps (its launches add to the `[l14]` and
   `[d768]` rows). The phase's time is printed.
35. Tensor parallelism (run after phase 34): `TP_RANKS` (2) processes of this script
   (`--tp-rank`) on the one card in a gloo group of CUDA tensors (NCCL
   refuses two ranks on one GPU; gloo carries each collective through host
   memory), made by `cli.common.init_multihost(backend="gloo")` from the
   env triple, a (1, 2) mesh: `DistillTrainer` at ViT-B/16, B=32, 8 boxes
   (a warm-up step, 3 uncached steps, the same batches cache-warm), then
   `TeacherTrainer` at B=32 (a warm-up, 3 steps), each rank on its slices
   (`parallel.tp`), against the same steps in this process without a
   group, from the same weights and batches: the teacher targets' and the
   student's features before training within 2^-6 max(1, |ref|), the
   distill losses within 1e-3 of the reference's (relative), the
   teacher's within 2e-4 (absolute), the first step's gathered trainable
   gradients of each trainer within 2^-4 of the reference's (relative, L2
   over the sharded tensors and over the replicated ones), the gathered trainable parameters after the steps
   within 2 lr steps; each rank's launches exactly the expected counts (K4
   / K5 once per layer per step at heads / 2, the region encode's
   LayerNorm, GEMM and K1's core a layer, K10, K11 1 + 1 a step); ms per
   step beside the one-process step's. Each rank records the arguments of
   every kernel wrapper its warm-up steps call (the first call of each
   shape: the QKV, out_proj and fc2 GEMMs at shard width, the latter two
   writing f32 without bias, K1's core, K3 / K4 / K5 at heads / 2, the
   replicated K10 and K11) and holds the kernel against its twin on those
   tensors, at the kernel phases' tolerances; rank 0 then times kernel,
   twin and library call there alone. Either rank failing fails the
   phase. Its launches (both ranks') are the launches of `[tp]` rows of
   the kernels line, which carry these checks and times.

36. Serving over ranks (run after phase 35): the reference is the
   one-process B/16 service through the serve CLI's `build_service`
   (random weights from seed 0, bf16, buckets 2,4,16,64, index_dim 512)
   on the main path: the CLI's `--selftest`, 37 texts and 37 images of
   mixed sizes, an index of 100,000 seeded unit rows added after the
   selftest's probe (100,001 rows: one row pads it to the ranks), 64 text
   queries at k = 10. Then `SERVE_RANKS` (2) processes of this script
   (`--serve-rank`) on the one card in a gloo group of CUDA tensors from
   the env triple, each building the service through `build_service` over
   the CLI's `serve_mesh`: rank 0 drives the same path through
   `serve.fanout.lead` while rank 1 runs `follow`, then `--bench`'s lines
   at concurrency 1 and 8 (p50 / p99 through gloo, host memory: no measure
   of serving across cards) and the int8 service's selftest. Holds: the
   rows bit-equal to the reference's (else within REL_TOL, the line says
   which), the top-10 ids equal and scores within 1e-5, each rank's
   launches exactly the expected counts (K1 / K2 a layer on its half of
   each image bucket, K12 for each search its shard takes part in), and
   each rank's K1 / K2 / K12 calls held against their twins at the kernel
   phases' tolerances (rank 0 times them alone: the kernels line's
   `[serve_dp]` rows, with both ranks' launches). Then a one-rank NCCL
   group made by `serve_mesh` from the triple serves the same path
   through `lead`, bit-equal to the reference. The phase's time is
   printed.

37. The last modules (run after phase 36). (a) The context view: the B/16
   teacher CLIP (seeded random weights, bf16) over phase 9's synthetic
   batch, B=256 x 8 boxes, through `encode_patches_with_context` on the
   route a user gets (`models.encoding.image_forward`: K1 / K2): the
   counts from 0 before the encode must be twice one image features
   call's (patch view, then context view); K1 and K2 held against their
   twins on the first call of each that the context view made, and
   timed there (the kernels line's `[context]` rows, with the encode's
   launches); the region encode and the encode with its context view
   timed (host clock to a synchronize), the peak memory printed; at B=2,
   3 boxes invalid, both views held against the f32 modules on the CPU
   (per-row cosine >= 0.99). (b) BERT-base (seeded random weights) over
   64 captions through the WordPiece tokenizer on the CPU tests'
   vocabulary, padded to 77, projected to 512 by `bert_to_clip_features`:
   f32 on the card (TF32 off) within 1e-4 of the largest value of the
   CPU's, the bf16 route's error beside it, each timed. (c) YOLOv8x at 640
   px in train mode: one B=2 step's gradients through `detection_step` in
   f32 within 1e-3 relative L2 of the same step in f64 on the card (the
   CPU's f32 step and a backward in TF32 printed beside it); 5 Adam steps
   at B=8 on one batch with finite, falling losses, ms a step and the
   peak memory. The phase's time is printed.
38. SigLIP so400m/14-384 (alone: `python3 chip_smoke.py --siglip`, which
   prints its rows of the kernels line). (a) Every kernel instance the
   SigLIP cell adds, against its twin at the cell's shapes: K4 with o's
   rounding residual, K3 and K5 with it (dq, dk, dv) at head_dim 72 over
   the vision tower (S=729, 16 heads; B=32, where the twin's f32 logits
   fit) and the unmasked text tower (S=64, B=256); the GEMM's tanh-GELU
   forms (a1 saved; times tanh-GELU') at K=1152 and K=4304; K6's forward
   and dx at D=1152, MLP 4304 (B=16 x 729 rows); the LayerNorm and its
   backward at D=1152; K11 at D=1152, B=256. Each held within the
   head_dim-64 instances' bounds and timed beside its twin (the kernels
   line's `[siglip]` and `[d1152]` rows). (b) `DistillTrainer` with a
   SigLIP student at published widths (27 + 27 layers), B=16, targets
   from the cache, remat off and on: every launch counted from zero
   before the steps against the step's formula, finite falling losses,
   and remat's parameters bit-equal to those without it. The rows'
   launches are (b)'s.
39. The kernels' times at B=256 (alone, over any checkout's package:
   `python3 chip_smoke.py --kernel-times [all|new|existing]`, one
   `kernel_times` JSON line). Each case is one call timed with CUDA events
   over two windows after a warm call: K4 (attention forward
   with stats) and K5 (dq and dk / dv) at head_dim 72 over SigLIP's
   vision (S=729, 16 heads) and text (S=64) shapes, K6's forward (tanh-GELU
   with a1 saved) and dx at D=1152, MLP 4304 (K=4304), the LayerNorm and
   its backward at D=1152, K11 at D=1152; and the head_dim-64 / D <= 1024
   instances the existing cells run: K4 / K5 at B/16 vision and packed-free
   causal text and L/14 vision, K6 at L/14, the LayerNorm at 768 and 1024,
   K11 at 512 and 768. In the full smoke a case that fails fails the
   phase; alone, a case the tree cannot run is printed as such, so the
   same script runs over an older checkout's package (copied into it) for
   a comparison in turns within one call.

Every kernel's entry in the `kernels` line carries its bound: the larger
of its operations over the card's peak for their type and the bytes it
must move (each input read once, each output written once) over its
memory rate, from the shapes of this run. The peaks are
`dclip_tpu_torch.core.flops.card_peaks` of the card (on the SXM H100:
989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 CUDA cores, 495 TFLOP/s
TF32 tensor cores for K12's three products per score, 3.35 TB/s); a card
that table does not name stops the run, naming the card; and `library_ms`, the time of one PyTorch call that
computes the same function, where there is one
(`scaled_dot_product_attention` and its backward, and two of its calls
for K10's core; `F.layer_norm` and
its input gradient, and its weight gradients for the LayerNorm's; `torch.addmm`,
`F.linear` and `torch.matmul` for the GEMM's NN, NT and TN modes, without
their epilogues' activation and residual terms; `torch.matmul` +
`torch.topk` for K12), else null.

The second-to-last line is `{"kernels": [...]}` and the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

B, S, D, HEADS, MLP = 64, 197, 768, 12, 3072
EPS = 1e-5
# Kernel vs twin: bf16 keeps 8 significant bits (unit roundoff 2^-9). The
# kernels round their output and their bf16 intermediates (LN output,
# q/k/v, softmax weights P, GELU output) where the f32 twin does not, so a
# few bf16 roundings at the top of the output's range must pass:
# max |kernel - twin| <= 2^-6 * max(1, max |twin|).
REL_TOL = 2.0**-6
# Backward kernels vs their f32 twins: the gradients chain two more bf16
# roundings (e and dS, or da1, enter the tensor cores as bf16) and the
# twin runs from the f32 forward's statistics (ROADMAP Queue 3: the bf16
# forward's rinv comes from rounded exponentials), so one more bit:
# max |kernel - twin| <= 2^-5 * max(1, max |twin|).
BWD_TOL = 2.0**-5
# The distillation loss computes in f32 from the same bf16 / f32 inputs as
# its twin; only the summation order differs. Each of the four parts is
# held to a relative f32 bound; the gradients (O(1/B)) are both rounded
# from f32 to bf16 at the end, so they differ by at most one bf16 ulp:
# max |kernel - twin| <= 2^-7 * max |twin|.
DL_RTOL = 1e-5
DL_BWD_TOL = 2.0**-7
# Service: bf16 kernel path vs f32 plain-twin path, 12 layers of bf16
# rounding on random weights; every image's cosine must reach this.
COS_BOUND = 0.99

# The card's dense peaks (`core.flops.CardPeaks`: bf16, f32, TF32 for K12's
# 3xTF32 products, HBM bytes/s), set by main() from `core.flops.card_peaks`.
PEAKS = None

SRC = "dclip_tpu_torch/kernels/csrc/"
TPU = "dclip_tpu/kernels/vit_block.py"
KERNELS = {  # wrapper -> (source, TPU kernel it replaces)
    "layernorm": (SRC + "layernorm.cu", TPU + ":47,96"),
    "gemm_bias_act_residual": (SRC + "gemm.cu", TPU + ":47,96"),
    "attention": (SRC + "attention.cu", TPU + ":47"),
    "attention_block": ("dclip_tpu_torch/kernels/vit_block.py", TPU + ":47"),
    "mlp_block": ("dclip_tpu_torch/kernels/vit_block.py", TPU + ":96"),
}
# The training path's kernels (K3/K4/K5, K6, K11).
TRAIN_KERNELS = {
    "self_attention_fused": (SRC + "attention.cu", "dclip_tpu/kernels/vit_attention.py:127"),
    "self_attention_fwd_stats": (SRC + "attention.cu", "dclip_tpu/kernels/vit_attention.py:246"),
    "self_attention_bwd_stats": (SRC + "attention_bwd.cu",
                                 "dclip_tpu/kernels/vit_attention.py:308"),
    "mlp_frozen_fwd": ("dclip_tpu_torch/kernels/mlp_frozen.py",
                       "dclip_tpu/kernels/mlp_frozen.py:135"),
    "mlp_frozen_bwd": ("dclip_tpu_torch/kernels/mlp_frozen.py",
                       "dclip_tpu/kernels/mlp_frozen.py:159"),
    "layernorm_bwd": (SRC + "layernorm.cu", "dclip_tpu/kernels/mlp_frozen.py:159"),
    "distill_loss_fwd": (SRC + "distill_loss.cu", "dclip_tpu/kernels/distill_loss.py:47"),
    "distill_loss_bwd": (SRC + "distill_loss.cu", "dclip_tpu/kernels/distill_loss.py:73"),
}
# The uncached step's new kernels: K10 and its two CUDA kernels, and the
# loader's self-check (K13).
XATTN = "dclip_tpu/kernels/cross_attention.py:74"
TEACHER_KERNELS = {
    "cross_attention": ("dclip_tpu_torch/kernels/cross_attention.py", XATTN),
    "cross_attention_core": (SRC + "cross_attention.cu", XATTN),
    "add_layernorm_f32": (SRC + "cross_attention.cu", XATTN),
    "loader_self_check": (SRC + "status.cu", "dclip_tpu/kernels/__init__.py:39"),
}
# The teacher trainer's: K10's differentiable form.
TEACHER_TRAIN_KERNELS = {
    "cross_attention_trainable": ("dclip_tpu_torch/kernels/cross_attention.py",
                                  "dclip_tpu/kernels/cross_attention.py:148"),
}
# The fused-trainable step's kernels: K8, K9 and the GEMM modes and row
# reductions they add.
K8 = "dclip_tpu/kernels/mlp_trainable.py"
K9 = "dclip_tpu/kernels/attn_block_trainable.py"
TRAINABLE_KERNELS = {
    "mlp_trainable_fwd": ("dclip_tpu_torch/kernels/mlp_trainable.py",
                          "dclip_tpu/kernels/mlp_frozen.py:135"),
    "mlp_trainable_bwd": ("dclip_tpu_torch/kernels/mlp_trainable.py", K8 + ":82,134"),
    "attn_block_trainable_fwd": ("dclip_tpu_torch/kernels/attn_block_trainable.py", K9 + ":78"),
    "attn_block_trainable_bwd": ("dclip_tpu_torch/kernels/attn_block_trainable.py",
                                 K9 + ":224"),
    "gemm_nt": (SRC + "gemm.cu", K9 + ":78"),
    "gemm_tn": (SRC + "gemm.cu", K8 + ":82,134"),
    "colsum": (SRC + "reduce.cu", K8 + ":82,134"),
    "layernorm_bwd_wgrad": (SRC + "layernorm.cu", K8 + ":82"),
}
# The search's kernel: K12.
TOPK_KERNELS = {"topk_streamed": (SRC + "topk.cu", "dclip_tpu/kernels/topk.py:51")}
# K12 vs its twin: f32 sums in another order, |score| <= 1 (unit rows).
TOPK_TOL = 1e-5
SEARCH_N, SEARCH_Q, SEARCH_K, SEARCH_CALLS = 1_000_000, 64, 10, 3
GATE_Q, GATE_N, GATE_K = 2048, 100_000, 3
EVAL_IMAGES, EVAL_CAPS_PER_IMAGE, EVAL_COS_IMAGES = 1000, 5, 64
ZS_IMAGES, ZS_CLASSES, ZS_BATCH, ZS_COS_IMAGES = 1024, 100, 64, 32
TRAIN_B, TEXT_S, TEXT_D, TEXT_HEADS, TEXT_MLP = 256, 77, 512, 8, 2048
# A weight or bias gradient, kernel vs twin on the same bf16 operands: f32
# sums of the same products in another order, within 1e-4 of the largest
# |twin| (csrc/gemm.cu TN mode, csrc/reduce.cu, the LayerNorm sums).
SUM_TOL = 1e-4
# ViT-L/14 widths (CLIPConfig.vit_l_14()): the vision tower, where K6 runs
# at K7's widths, and the text tower.
L14_S, L14_D, L14_HEADS, L14_MLP = 257, 1024, 16, 4096
L14_TEXT_D, L14_TEXT_HEADS = 768, 12
EVAL_BATCH = 256  # the retrieval eval's image batch
# The kernel phase's cases: (label, B, S, D, heads, MLP, timed). ViT-B/16 at
# the serving batch, a ragged B=1 and the retrieval eval's batch; ViT-L/14
# (the zero-shot eval's preset: 257 tokens, a ragged last row tile) at the
# zero-shot batch.
BLOCK_CASES = (("B/16", B, S, D, HEADS, MLP, True), ("B/16", 1, S, D, HEADS, MLP, False),
               ("B/16", EVAL_BATCH, S, D, HEADS, MLP, False),
               ("L/14", ZS_BATCH, L14_S, L14_D, L14_HEADS, L14_MLP, True))
# The GEMM phase: the rows of a ViT-B/16 layer's projections at the serving
# bucket of 64 images, the cache-warm student at B=256, and the teacher ViT
# over 2,048 region crops (B=256 x 8 boxes); at ViT-L/14 widths the region
# encode's rows and K6's (the student's frozen MLP at B=256: forward with
# a1 saved, and dx); TN at K9's weight gradients (B=256 vision rows) and
# K8's (the 64 packed text rows of 77 tokens).
GEMM_ROWS = (B * S, TRAIN_B * S, TRAIN_B * 8 * S)
GEMM_L14_REGION_ROWS, GEMM_L14_K6_ROWS = TRAIN_B * 8 * L14_S, TRAIN_B * L14_S
GEMM_TN_CASES = (("K9 dwqkv", TRAIN_B * S, 3 * D, D), ("K9 dwo", TRAIN_B * S, D, D),
                 ("K8 dw2", 64 * TEXT_S, TEXT_D, TEXT_MLP), ("K8 dw1", 64 * TEXT_S, TEXT_MLP, TEXT_D))
FIT_B, FIT_EPOCHS, FIT_STEPS = 32, 2, 2
WARMUP_STEPS, TIMED_STEPS = 2, 5
GRAD_B, GRAD_COS_GLOBAL, GRAD_COS_TENSOR = 8, 0.99, 0.95
# The L/14 student's gradients are held at this batch (the f32 CPU side
# costs about 4x a B/16 row).
L14_GRAD_B = 4
# k_proj.bias gradients are rounding noise (see grad_agreement_phase); their
# norm must stay below this share of the layer's q_proj.bias gradient.
GRAD_NOISE_RATIO = 0.1
# bench.py's teacher: TeacherConfig(embed_dim=512, num_heads=8,
# max_patches=8, max_text_tokens=77).
TEACHER_P = 8
AGREE_B, TARGET_COS = 2, 0.99
# K10's and K11's kernels, whose device time each profile prints by name.
PROFILED_KERNELS = ("cross_attention_core_kernel", "add_layernorm_f32_kernel",
                    "distill_tiles_kernel", "distill_grad_kernel")
# K11 is timed at the step's batch and, alone, at this one (128 x 128 tiles).
DL_BIG_B = 4096
# The meta-teacher slice: the CLI's default batch and bench.py's.
TEACHER_B = XATTN_TRAIN_B = (32, 256)
TEACHER_LR = 1e-4
# Phase 33, the data-parallel path in a one-rank NCCL group: the distill
# step's batch and steps (uncached, then cache-warm), the teacher step's,
# the sharded search's store (one row short of valid) and the preempted
# fit (epochs of steps, SIGTERM when this batch is drawn).
# (tests/test_torch_cli_e2e.py runs the phase on the CPU at the tiny preset.)
DP_DEVICE, DP_PRESET = "cuda", "vit-b-16"
DP_B, DP_TEACHER_B, DP_STEPS = 256, 32, 3
DP_SEARCH_N, DP_SEARCH_D, DP_SEARCH_Q, DP_SEARCH_K = 1_000_000, 512, 64, 10
DP_FIT_B, DP_FIT_EPOCHS, DP_FIT_STEPS, DP_KILL_AT = 32, 2, 4, 2
# Phase 34, the profiling slice: `cli.profile` runs (preset, batch, timed
# steps) in order (a) and (c), the per-op table's batch and calls a window
# (b), on PROFILE_DEVICE. A phase may reach 20x the full step (the JAX
# test's bound, tests/test_cli_e2e.py:183-190); no op may run under 0.95
# of its floor (cli/profile_ops.py). (tests/test_torch_cli_e2e.py runs the
# phase on the CPU at the tiny preset.)
PROFILE_DEVICE = "cuda"
PROFILE_RUNS = (("vit-b-16", 256, 3), ("vit-l-14", 256, 2))
PROFILE_OPS_B, PROFILE_OPS_STEPS = 256, 10
PHASE_BOUND = 20.0
# The kernels the profiled path must launch (the uncached and cache-warm
# steps, the two teacher phases), and the per-op table's.
PROFILE_PATH_KERNELS = ("layernorm", "gemm_bias_act_residual", "attention", "attention_block",
                        "mlp_block", "self_attention_fused", "self_attention_fwd_stats",
                        "self_attention_bwd_stats", "mlp_frozen_fwd", "mlp_frozen_bwd",
                        "layernorm_bwd", "distill_loss_fwd", "distill_loss_bwd",
                        "cross_attention", "cross_attention_core", "add_layernorm_f32")
PER_OP_KERNELS = ("self_attention_fwd_stats", "self_attention_bwd_stats", "mlp_frozen_fwd",
                  "mlp_frozen_bwd", "layernorm_bwd", "distill_loss_fwd", "distill_loss_bwd")
# Phase 35, tensor parallelism: TP_RANKS processes of this script on
# TP_DEVICE in a gloo group, the model axis across them; the distill step's
# batch (TEACHER_P boxes), the teacher step's, the counted steps of each
# (the distill batches run uncached, then again cache-warm), and the bound
# of a rank's run. Each rank holds every kernel wrapper its warm-up steps
# called against the twin, on the tensors of those calls; the kernels line
# gives the phase's launches and these checks `[tp]` rows of their own.
# (tests/test_torch_cli_e2e.py runs the phase on the CPU at the tiny preset.)
TP_DEVICE, TP_PRESET, TP_RANKS = "cuda", "vit-b-16", 2
TP_B, TP_TEACHER_B, TP_STEPS, TP_TIMEOUT = 32, 32, 3, 900
# The losses against one process's: the distill loss (near 4) within
# TP_DISTILL_LOSS_RTOL of it, relative (3.3e-4 read); the teacher's InfoNCE
# (0.03-0.05, where one relative bound would sit at the bf16 roundings that
# differ between the sharded and the whole-weight compositions) within
# TP_TEACHER_LOSS_ATOL, absolute (6.5e-5 read). The first step's trainable
# gradients, gathered, within TP_GRAD_TOL of one process's, relative in
# the L2 norm over the sharded tensors and over the replicated ones (all
# of them together read 3.15e-2: two bf16 compositions of 12-layer
# towers). Readings: this phase on an NVIDIA H100 80GB HBM3 at 700.00 W.
# Faults the bounds are there to catch, planted in the phase at the tiny
# preset in f32 on the CPU: a shard's input gradient without its
# all-reduce reads gradients 0.25-0.29 off and a later distill loss
# 2.5e-3; gradients summed over the model ranks too, 1.0 and 1.8e-2; a
# row-sharded bias added on every rank, a loss 1.8e-2.
TP_DISTILL_LOSS_RTOL, TP_TEACHER_LOSS_ATOL, TP_GRAD_TOL = 1e-3, 2e-4, 2.0**-4
# Phase 36, serving over ranks: SERVE_RANKS processes of this script on
# SERVE_DEVICE in a gloo group, the data axis across them, serving
# SERVE_PRESET from seeded random weights through the serve CLI's
# `build_service` at phase 4's flags with SERVE_BUCKETS (every bucket even);
# the main path's requests (SERVE_TEXTS texts, SERVE_IMAGES images,
# SERVE_ROWS index rows after the selftest's probe, so the index holds
# SERVE_ROWS + 1 rows and one row pads it to the ranks, SERVE_QUERIES text
# queries at k = SERVE_K); rank 0's latencies at SERVE_CONCURRENCY; the
# bound of a rank's run. The ranks' rows against one process's: bit-equal
# is expected (a row's work does not depend on the others of its bucket);
# failing that, within SERVE_ROW_TOL of unit-norm rows, the bound phase 3
# holds each bf16 kernel to against its twin (phase 4 holds no padding
# bound). (tests/test_torch_cli_e2e.py runs the phase on the CPU at the
# tiny preset.)
SERVE_DEVICE, SERVE_PRESET, SERVE_RANKS = "cuda", "vit-b-16", 2
SERVE_BUCKETS, SERVE_INDEX_DIM = "2,4,16,64", 512
SERVE_TEXTS, SERVE_IMAGES, SERVE_ROWS, SERVE_QUERIES, SERVE_K = 37, 37, 100_000, 64, 10
SERVE_CONCURRENCY, SERVE_TIMEOUT, SERVE_ROW_TOL = (1, 8), 600, REL_TOL
# Phase 37, the last modules, on LAST_DEVICE. (a) The context view: the
# LAST_PRESET teacher CLIP from seeded random weights (seed 0) at
# LAST_DTYPE over phase 9's synthetic batch of CONTEXT_B images x 8 boxes,
# each region encode and context encode timed over CONTEXT_REPEATS calls;
# CONTEXT_AGREE_B images (3 boxes invalid) against the f32 module path on
# the CPU. (b) BERT at BERT_PRESET, seeded random weights, BERT_CAPTIONS
# captions through the WordPiece tokenizer on WORDPIECE_VOCAB (the CPU
# tests' vocabulary, tests/test_torch_bert.py) padded to BERT_T, projected
# to BERT_CLIP_DIM; the card's f32 within BERT_TOL of the largest |value|
# of the CPU's. (c) The detector (DetectorConfig.v8x() with
# DET_TRAIN_CHANGES) in train mode: DET_TRAIN_STEPS Adam(DET_LR) steps at
# DET_TRAIN_B, and one step's f32 gradients at DET_GRAD_B against the same
# step in f64 on the device (DET_GRAD_TOL relative L2; the CPU's f32 step
# and a backward in TF32 printed beside it); DET_GT boxes an image.
# (tests/test_torch_cli_e2e.py runs the phase on the CPU at tiny sizes.)
LAST_DEVICE, LAST_PRESET, LAST_DTYPE = "cuda", "vit-b-16", "bfloat16"
CONTEXT_B, CONTEXT_REPEATS, CONTEXT_AGREE_B = TRAIN_B, 2, AGREE_B
BERT_PRESET, BERT_CAPTIONS, BERT_T, BERT_CLIP_DIM, BERT_TOL = "base_uncased", 64, 77, 512, 1e-4
WORDPIECE_VOCAB = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "dog", "run",
                   "##ning", "##s", "##ed", "jump", "a", "photo", "of", "un", "##believ",
                   "##able", "over", ",", ".", "!", "?", "-", "'", '"', "naive", "cafe",
                   "hello", "world", "12", "##3", "中", "国")
DET_TRAIN_CHANGES = {}
DET_TRAIN_B, DET_GRAD_B, DET_TRAIN_STEPS, DET_LR, DET_GT = 8, 2, 5, 2e-3, 4
DET_GRAD_TOL = 1e-3
# The ViT-L/14 slice (phases 30-32): the reference's student, with the
# teacher CLIP at the same preset and TeacherConfig(768, 8 heads, 8 boxes,
# 77 tokens), so K10 runs at head_dim 96. Each configuration of phase 31
# takes WARMUP_STEPS and these timed steps.
L14_XATTN_D, L14_XATTN_HEADS, L14_TIMED_STEPS = 768, 8, 3
# Phase 32's inputs: the committed fixtures (tests/data/make_jpeg_fixtures.py)
# as a corpus of FILES_ITEMS items and a validation file of FILES_VAL.
FIXTURES = "tests/data/"
FILES_JPEGS = ("rgb_640x480.jpg", "rgb_375x500.jpg", "rgb_53x37.jpg", "rgb_224x224.jpg",
               "gray_121x90.jpg", "progressive_300x200.jpg")
FILES_PIL_ONLY = ("rgb_40x30.png", "cmyk_50x40.jpg")
FILES_ITEMS, FILES_VAL = 64, 8
FILES_DEVICE, FILES_PRESET = "cuda", "vit-l-14"
# Rows of the kernels line with phase 31's launches: K10 and K10' at D=768
# (head_dim 96) and K11 at D=768, held and timed there; K4 / K3 / K5, K6 at
# K7's widths and its LayerNorm backward at the L/14 student's shapes (B=256),
# held and timed in the training kernel phase.
L14_ROWS = {
    "cross_attention[d768]": TEACHER_KERNELS["cross_attention"],
    "cross_attention_core[d768]": TEACHER_KERNELS["cross_attention_core"],
    "add_layernorm_f32[d768]": TEACHER_KERNELS["add_layernorm_f32"],
    "distill_loss_fwd[d768]": TRAIN_KERNELS["distill_loss_fwd"],
    "distill_loss_bwd[d768]": TRAIN_KERNELS["distill_loss_bwd"],
    "cross_attention_trainable[d768]": TEACHER_TRAIN_KERNELS["cross_attention_trainable"],
    "mlp_frozen_fwd[l14]": ("dclip_tpu_torch/kernels/mlp_frozen.py",
                            "dclip_tpu/kernels/mlp_frozen.py:201"),
    "mlp_frozen_bwd[l14]": ("dclip_tpu_torch/kernels/mlp_frozen.py",
                            "dclip_tpu/kernels/mlp_frozen.py:242"),
    "layernorm_bwd[l14]": TRAIN_KERNELS["layernorm_bwd"],
    "self_attention_fwd_stats[l14]": TRAIN_KERNELS["self_attention_fwd_stats"],
    "self_attention_fused[l14]": TRAIN_KERNELS["self_attention_fused"],
    "self_attention_bwd_stats[l14]": TRAIN_KERNELS["self_attention_bwd_stats"],
}

# Rows of the kernels line with phase 38's launches: the SigLIP cell's new
# instances (head_dim 72, tanh-GELU, D = 1152, K = 4304), held and timed there.
SIGLIP_ROWS = {
    **{n + "[siglip]": TRAIN_KERNELS[n]
       for n in ("self_attention_fwd_stats", "self_attention_fused", "self_attention_bwd_stats",
                 "mlp_frozen_fwd", "mlp_frozen_bwd", "layernorm_bwd")},
    **{n + "[siglip]": KERNELS[n] for n in ("layernorm", "gemm_bias_act_residual")},
    "distill_loss_fwd[d1152]": TRAIN_KERNELS["distill_loss_fwd"],
    "distill_loss_bwd[d1152]": TRAIN_KERNELS["distill_loss_bwd"],
}
SIGLIP_B, SIGLIP_CHECK_B, SIGLIP_MLP_B = 16, 32, 16


def _width_suffix(d: int) -> str:
    """The kernels line's rows of K10, K10' and K11 at width `d`: the
    B/16 teacher's (512) unnamed, another width's named `[d<width>]`."""
    return "" if d == TEXT_D else f"[d{d}]"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_state() -> str:
    """The card's SM clock, power draw and temperature, now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return "sm clock, power, temperature: " + out.stdout.strip().splitlines()[0]


def import_port_modules():
    """The port modules the phases use (each phase imports its own lazily,
    so that the script fails fast, and cleanly, without a card)."""
    import importlib

    for name in ("dclip_tpu_torch.cli.serve", "dclip_tpu_torch.cli.common",
                 "dclip_tpu_torch.kernels._build", "dclip_tpu_torch.kernels.vit_block",
                 "dclip_tpu_torch.kernels.vit_attention", "dclip_tpu_torch.kernels.mlp_frozen",
                 "dclip_tpu_torch.kernels.distill_loss",
                 "dclip_tpu_torch.kernels.cross_attention", "dclip_tpu_torch.models.weights",
                 "dclip_tpu_torch.kernels.mlp_trainable",
                 "dclip_tpu_torch.kernels.attn_block_trainable",
                 "dclip_tpu_torch.kernels.trainable_ops", "dclip_tpu_torch.train.checkpoint",
                 "dclip_tpu_torch.train.distill_trainer", "dclip_tpu_torch.ops.image_ops",
                 "dclip_tpu_torch.ops.packing", "dclip_tpu_torch.kernels.topk",
                 "dclip_tpu_torch.ops.knn", "dclip_tpu_torch.ops.retrieval",
                 "dclip_tpu_torch.train.teacher_trainer", "dclip_tpu_torch.models.cross_modal",
                 "dclip_tpu_torch.models.encoding", "dclip_tpu_torch.eval.retrieval",
                 "dclip_tpu_torch.eval.zero_shot", "dclip_tpu_torch.data.embedding_store",
                 "dclip_tpu_torch.data.tokenizer", "dclip_tpu_torch.serve.quant",
                 "dclip_tpu_torch.serve.export", "dclip_tpu_torch.models.hf_export",
                 "dclip_tpu_torch.cli.export_hf", "dclip_tpu_torch.ops.nms",
                 "dclip_tpu_torch.models.detector", "dclip_tpu_torch.models.detector_import",
                 "dclip_tpu_torch.models.projections", "dclip_tpu_torch.models.region_tokenizer",
                 "dclip_tpu_torch.data.index", "dclip_tpu_torch.cli.precache",
                 "dclip_tpu_torch.cli.build_index", "dclip_tpu_torch.cli.tune_gate",
                 "dclip_tpu_torch.cli.doctor", "dclip_tpu_torch.native",
                 "dclip_tpu_torch.data.pipeline", "dclip_tpu_torch.data.corpus",
                 "dclip_tpu_torch.data.detection_cache", "dclip_tpu_torch.cli.train_teacher",
                 "dclip_tpu_torch.cli.train_distill", "dclip_tpu_torch.core.flops",
                 "dclip_tpu_torch.cli.profile", "dclip_tpu_torch.cli.profile_ops"):
        importlib.import_module(name)


# -- the kernel table: errors, times, bounds --------------------------------------


class KernelTable:
    """Per kernel: the largest error against its twin, and summed over the
    timed cases its time, its twin's, its bound and its library call's."""

    def __init__(self, names):
        self.rows = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": None, "_ops_ms": 0.0, "_bytes_ms": 0.0} for n in names}

    def error(self, name, err):
        r = self.rows[name]
        r["max_abs_err"] = max(r["max_abs_err"], float(err))

    def timed(self, name, ms, plain_ms, bound, library_ms=None):
        """`bound` = (operations ms, bytes ms) of the timed call."""
        r = self.rows[name]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += max(bound)
        r["_ops_ms"] += bound[0]
        r["_bytes_ms"] += bound[1]
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms

    def entry(self, name):
        r = dict(self.rows[name])
        r["bound_by"] = "operations" if r.pop("_ops_ms") >= r.pop("_bytes_ms") else "bytes"
        return r


def work(bf16_flops=0.0, f32_flops=0.0, nbytes=0.0, tf32_flops=0.0):
    """(ms at the operations' peaks, ms at the memory rate)."""
    return (1e3 * (bf16_flops / PEAKS.bf16 + f32_flops / PEAKS.f32 + tf32_flops / PEAKS.tf32),
            1e3 * nbytes / PEAKS.hbm)


def gemm_work(m, k, n, extra_mn=0):
    """A bf16 GEMM [m, k] @ [k, n] + bias, bf16 out; `extra_mn` more bf16
    [m, n] tensors moved (residual, saved pre-activation)."""
    return work(bf16_flops=2.0 * m * k * n,
                nbytes=2.0 * (m * k + k * n + m * n * (1 + extra_mn)) + 4.0 * n)


def distill_loss_cases(torch, randn, card: str, table: KernelTable, d: int, cases):
    """K11 forward (the four parts) and backward (dsi, dst) against their
    twins at width `d` for each (variant, B, timed, in the kernels line),
    two calls bit-identical; rows `distill_loss_{fwd,bwd}` + `_width_suffix(d)`.
    `randn(*shape, scale, dtype)` draws the inputs on the card."""
    from dclip_tpu_torch.kernels import distill_loss as dl

    dev = torch.device("cuda")
    suffix = _width_suffix(d)
    for variant, b, timed, row in cases:
        si, st = randn(b, d), randn(b, d)
        # Targets correlated with the student rows (cosine ~0.9), so li and
        # lt sit far from 1 and a dropped cosine term moves them.
        ti = si.float() + randn(b, d, scale=0.5, dtype=torch.float32)
        tt = st.float() + randn(b, d, scale=0.5, dtype=torch.float32)
        parts = dl.distill_loss_fwd(si, st, ti, tt)
        want = dl.distill_loss_fwd_reference(si, st, ti, tt)
        torch.cuda.synchronize()
        if not (want[0] < 0.5 and want[1] < 0.5):
            raise AssertionError(f"distill_loss_fwd[{variant}]: li, lt {want[:2].tolist()} "
                                 f"not far from 1")
        # f32 throughout on identical bf16/f32 inputs: only the summation
        # order differs, so each part within DL_RTOL of its twin.
        rel = ((parts - want).abs() / want.abs()).tolist()
        print(f"kernel distill_loss_fwd[{variant}]: parts {parts.tolist()} twin "
              f"{want.tolist()} rel_err {rel} bound {DL_RTOL}", flush=True)
        if parts.shape != want.shape or not all(r <= DL_RTOL for r in rel):
            raise AssertionError(f"distill_loss_fwd[{variant}]: rel_err {rel} > {DL_RTOL}")
        err = (parts - want).abs().max().item()
        inputs = 4.0 * b * d + 8.0 * b * d
        _record(torch, card, table, "distill_loss_fwd" + suffix, err, timed,
                lambda: dl.distill_loss_fwd(si, st, ti, tt),
                lambda: dl.distill_loss_fwd_reference(si, st, ti, tt), 20, variant,
                work(f32_flops=2.0 * b * b * d + 10.0 * b * d, nbytes=inputs + 16.0),
                graph=True, table_row=row)
        cts = torch.tensor([1.0, 1.0, 1.0], device=dev)
        got = dl.distill_loss_bwd(si, st, ti, tt, cts)
        want = dl.distill_loss_bwd_reference(si, st, ti, tt, cts)
        errb = max(_bound_check(torch, f"distill_loss_bwd[{variant}] {n}", a, w, DL_BWD_TOL,
                                with_one=False)
                   for n, a, w in zip(("dsi", "dst"), got, want))
        _record(torch, card, table, "distill_loss_bwd" + suffix, errb, timed,
                lambda: dl.distill_loss_bwd(si, st, ti, tt, cts),
                lambda: dl.distill_loss_bwd_reference(si, st, ti, tt, cts), 20, variant,
                work(f32_flops=6.0 * b * b * d + 20.0 * b * d,
                     nbytes=inputs + 12.0 + 4.0 * b * d), graph=True, table_row=row)
        # No atomics on values: two calls on the same inputs give the same bits.
        again = dl.distill_loss_bwd(si, st, ti, tt, cts)
        if not (torch.equal(dl.distill_loss_fwd(si, st, ti, tt), parts)
                and all(torch.equal(x, y) for x, y in zip(again, got))):
            raise AssertionError(f"distill_loss[{variant}]: two calls differ")
        print(f"kernel distill_loss[{variant}]: two calls bit-identical", flush=True)


def time_pair(torch, kernel_fn, plain_fn, iters: int):
    """Mean ms per call of kernel and twin, in turns plain, kernel, kernel,
    plain, after one warm call of each."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if which == "kernel" else plain_fn
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms[which].append(start.elapsed_time(end) / iters)
    return sum(ms["kernel"]) / 2, sum(ms["plain"]) / 2


def time_one(torch, fn, iters: int) -> float:
    """Mean ms per call over two windows after a warm call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return sum(out) / 2


_CAPTURE_STREAM = []  # one for the run: a stream that runs cuBLAS keeps a workspace of its own


def time_graph(torch, fn, iters: int) -> float:
    """Mean ms per call of `fn` replayed from a CUDA graph of `iters` calls:
    the device's time without the host's per-call cost (a wrapper whose
    host time exceeds its kernels' is timed by the host in `time_pair`)."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # a warm call on the capture stream
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def time_pair_graph(torch, kernel_fn, plain_fn, iters: int):
    """`time_pair` with each side replayed from a CUDA graph (`time_graph`),
    in turns plain, kernel, kernel, plain."""
    ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        ms[which].append(time_graph(torch, kernel_fn if which == "kernel" else plain_fn, iters))
    return sum(ms["kernel"]) / 2, sum(ms["plain"]) / 2


def sdpa_calls(torch, q, k, v, heads, keep, g=None):
    """`scaled_dot_product_attention` on the same q, k, v ([B, S, D] views)
    with the same boolean mask `keep` [B, S, S] (None: unmasked): the
    forward, and with `g` the backward of that call."""
    F = torch.nn.functional
    b, s, d = q.shape

    def h(t):
        return t.reshape(b, s, heads, d // heads).transpose(1, 2)

    mask = None
    if keep is not None:  # a 16-aligned row stride, as the fused backends want
        store = torch.zeros((b, 1, s, (s + 15) // 16 * 16), dtype=torch.bool, device=q.device)
        store[..., :s] = keep[:, None]
        mask = store[..., :s]
    if g is None:
        return lambda: F.scaled_dot_product_attention(h(q), h(k), h(v), attn_mask=mask)
    qg, kg, vg = (h(t).detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    g4 = h(g)
    return lambda: torch.autograd.grad(o, (qg, kg, vg), g4, retain_graph=True)


def ln_work(rows, d):
    """The LayerNorm forward's bound: bf16 in and out, f32 scale and bias."""
    return work(f32_flops=8.0 * rows * d, nbytes=4.0 * rows * d + 8.0 * d)


def layer_norm_call(torch, x, scale, bias):
    """`F.layer_norm` on the same bf16 rows, with bf16 copies of scale and
    bias (made here, outside the timed call)."""
    d = x.shape[-1]
    w, b = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    return lambda: torch.nn.functional.layer_norm(x, (d,), w, b, EPS)


def layer_norm_grad_call(torch, x, scale, dh, weights: bool = False):
    """The backward of that `F.layer_norm` call for the cotangent dh (as
    bf16): the input gradient, and with `weights` also scale's and bias's."""
    d = x.shape[-1]
    xr = x.detach().requires_grad_()
    w = scale.to(torch.bfloat16).requires_grad_(weights)
    b = torch.zeros_like(w).requires_grad_(weights)
    y = torch.nn.functional.layer_norm(xr, (d,), w, b, EPS)
    wrt = (xr, w, b) if weights else (xr,)
    dy = dh.to(torch.bfloat16)
    return lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True)


def layer_weights(rng, torch, device, d=D, mlp=MLP):
    """One encoder layer of width d in the packed layout, drawn like random
    weights (N(0, 0.02) matrices) but with non-trivial biases and LN affines
    so every epilogue term is exercised."""
    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32") * 0.02).to(device)

    def f32(n, base):
        return torch.from_numpy(base + 0.1 * rng.standard_normal(n).astype("float32")).to(device)

    bf = torch.bfloat16
    return {
        "ln1_scale": f32(d, 1.0), "ln1_bias": f32(d, 0.0),
        "qkv_w": w(d, 3 * d).to(bf), "qkv_b": f32(3 * d, 0.0),
        "out_w": w(d, d).to(bf), "out_b": f32(d, 0.0),
        "ln2_scale": f32(d, 1.0), "ln2_bias": f32(d, 0.0),
        "fc1_w": w(d, mlp).to(bf), "fc1_b": f32(mlp, 0.0),
        "fc2_w": w(mlp, d).to(bf), "fc2_b": f32(d, 0.0),
    }


def kernel_phase(torch, vb, card: str, table: KernelTable):
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    weights = {}

    def randn(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(torch.bfloat16))

    for label, b, s, d, heads, mlp, timed in BLOCK_CASES:
        if (d, mlp) not in weights:
            weights[d, mlp] = layer_weights(rng, torch, dev, d, mlp)
        p = weights[d, mlp]
        m = b * s
        x = randn(b, s, d)
        h = randn(b, s, d)
        a = randn(b, s, d)
        g = randn(b, s, mlp)
        qkv = randn(b, s, 3 * d)
        attn_flops = 4.0 * b * heads * s * s * (d // heads)

        def addmm(act, name):
            """The projection's product and bias in one PyTorch call (its
            activation and residual terms are not in it)."""
            act2, bias = act.reshape(-1, act.shape[-1]), p[f"{name}_b"].to(torch.bfloat16)
            return lambda: torch.addmm(bias, act2, p[f"{name}_w"])

        cases = [  # name, variant, (kernel, twin), args, kwargs, bound, library call
            ("layernorm", "ln", (vb.layernorm, vb.layernorm_reference),
             (x, p["ln1_scale"], p["ln1_bias"], EPS), {},
             ln_work(m, d), layer_norm_call(torch, x, p["ln1_scale"], p["ln1_bias"])),
            ("gemm_bias_act_residual", "qkv",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (h, p["qkv_w"], p["qkv_b"]), {}, gemm_work(m, d, 3 * d), addmm(h, "qkv")),
            ("gemm_bias_act_residual", "out_proj+residual",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (a, p["out_w"], p["out_b"]), {"residual": x}, gemm_work(m, d, d, 1),
             addmm(a, "out")),
            ("gemm_bias_act_residual", "fc1+gelu",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (h, p["fc1_w"], p["fc1_b"]), {"gelu": True}, gemm_work(m, d, mlp), addmm(h, "fc1")),
            ("gemm_bias_act_residual", "fc2+residual",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (g, p["fc2_w"], p["fc2_b"]), {"residual": x}, gemm_work(m, mlp, d, 1),
             addmm(g, "fc2")),
            ("attention", "core", (vb.attention, vb.attention_reference), (qkv, heads), {},
             work(bf16_flops=attn_flops, nbytes=2.0 * m * 4 * d),
             sdpa_calls(torch, qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], heads, None)),
            ("attention_block", "block",
             (vb.attention_block_fused, vb.attention_block_reference), (x, p, heads, EPS), {},
             work(bf16_flops=2.0 * m * d * 4 * d + attn_flops,
                  nbytes=4.0 * m * d + 8.0 * d * d + 4.0 * 6 * d), None),
            ("mlp_block", "block", (vb.mlp_block_fused, vb.mlp_block_reference),
             (x, p, EPS), {},
             work(bf16_flops=4.0 * m * d * mlp,
                  nbytes=4.0 * m * d + 4.0 * d * mlp + 4.0 * (mlp + 3 * d)), None),
        ]
        for name, variant, (kernel, twin), args, kwargs, bound, library in cases:
            got = kernel(*args, **kwargs)
            want = twin(*args, **kwargs)
            torch.cuda.synchronize()
            what = f"{name}[{variant}] {label} B={b}"
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                raise AssertionError(f"{what}: got {got.shape} {got.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{what}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            tol = REL_TOL * max(1.0, want.float().abs().max().item())
            print(f"kernel {what}: max_abs_err {err} bound {tol}", flush=True)
            if not err <= tol:
                raise AssertionError(f"{what}: max_abs_err {err} > {tol}")
            table.error(name, err)
            if timed:
                iters = 10 if name.endswith("block") else 20
                ms, plain_ms = time_pair(
                    torch, lambda: kernel(*args, **kwargs), lambda: twin(*args, **kwargs), iters)
                lib_ms = None if library is None else time_one(torch, library, iters)
                print(f"time {what}: kernel {ms} ms, plain {plain_ms} ms, "
                      f"bound {max(bound)} ms, library {lib_ms} ms ({card})", flush=True)
                # The GEMM entry sums its four epilogues: one layer's GEMMs;
                # every entry sums its B/16 and L/14 cases.
                table.timed(name, ms, plain_ms, bound, lib_ms)
        del x, h, a, g, qkv, got, want
    # The teacher ViT's LN1 / LN2 over 2,048 region crops (B=256 x 8 boxes).
    rows = TRAIN_B * 8 * S
    p = weights[D, MLP]
    x = randn(rows, D)
    args = (x, p["ln1_scale"], p["ln1_bias"], EPS)
    got, want = vb.layernorm(*args), vb.layernorm_reference(*args)
    table.error("layernorm", _bound_check(torch, f"layernorm[crops] rows={rows}", got, want,
                                          REL_TOL))
    del got, want
    ms, plain_ms = time_pair(torch, lambda: vb.layernorm(*args),
                             lambda: vb.layernorm_reference(*args), 10)
    lib_ms = time_one(torch, layer_norm_call(torch, x, p["ln1_scale"], p["ln1_bias"]), 10)
    bound = ln_work(rows, D)
    print(f"time layernorm[crops] rows={rows} D={D}: kernel {ms} ms, plain {plain_ms} ms, "
          f"bound {max(bound)} ms ({max(bound) / ms} of it), F.layer_norm {lib_ms} ms ({card})",
          flush=True)
    table.timed("layernorm", ms, plain_ms, bound, lib_ms)
    del x, args, weights
    torch.cuda.empty_cache()


def gemm_phase(torch, card: str):
    """The port's GEMM (`csrc/gemm.cu`) in each mode against one PyTorch call
    on the same operands, timed in turns (library, kernel, kernel, library):
    NN and NT at the four projections of a ViT-B/16 layer for the main
    path's row counts, and at ViT-L/14 widths the region encode's four (NN,
    NT) and K6's forward and dx (NN), TN at K8's and K9's weight-gradient
    shapes; each NN / NT row names the schedule that ran (`vb.GEMM_SCHEDULES`,
    which must hold one launch). Held against the f32 twin at the two
    smaller B/16 M, on their first and last 1,024 rows at the L/14 ones (the
    twin's f32 copies at the teacher's M cost memory and time for nothing).
    Printed only: each mode's row in the kernel table comes from the phases
    that drive it."""
    from dclip_tpu_torch.kernels import trainable_ops as to
    from dclip_tpu_torch.kernels import vit_block as vb

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    def report(what, m, k, n, ms, lib_ms, lib_name, bound, schedule=""):
        flop = 2.0 * m * k * n
        tflops, lib_tflops = flop / ms / 1e9, flop / lib_ms / 1e9
        print(f"gemm {what} M={m} K={k} N={n}: kernel {ms} ms ({tflops} TFLOP/s, "
              f"{tflops / (PEAKS.bf16 / 1e12)} of peak), {lib_name} {lib_ms} ms ({lib_tflops} "
              f"TFLOP/s), kernel / library {ms / lib_ms}, bound {max(bound)} ms"
              f"{', schedule ' + schedule if schedule else ''} ({card})", flush=True)

    def schedule_of(kernel):
        """The schedule (wide / narrow) that one launch of `kernel()` ran,
        from the wrapper's counter."""
        vb.reset_launches()
        kernel()
        ran = [name for name, count in vb.GEMM_SCHEDULES.items() if count]
        if len(ran) != 1:
            raise AssertionError(f"gemm: schedules {vb.GEMM_SCHEDULES} for one launch")
        return ran[0]

    def held_on_rows(what, kernel, twin_rows, rows):
        """Large M: the kernel's first and last 1,024 rows against the twin
        on those rows (the twin's f32 copies of the whole would cost memory
        and time for nothing); either returns one tensor or a tuple."""
        def parts(out):
            return out if isinstance(out, tuple) else (out,)

        got = parts(kernel())
        for sl in (slice(0, 1024), slice(rows - 1024, rows)):
            for i, (gt, wt) in enumerate(zip(got, parts(twin_rows(sl)))):
                _bound_check(torch, f"{what}[{i}] rows {sl.start}:{sl.stop}", gt[sl], wt, REL_TOL)

    bias = {n: torch.randn(n, device=dev, generator=gen) * 0.1 for n in (D, 3 * D, MLP)}
    weights = {}  # (K, N) -> ([K, N] NN layout, [N, K] nn.Linear layout)
    for k, n in ((D, 3 * D), (D, D), (D, MLP), (MLP, D)):
        w = randn(k, n, scale=k**-0.5)
        weights[k, n] = (w, w.t().contiguous())
    for m in GEMM_ROWS:
        checked = m <= TRAIN_B * S
        iters = max(2, int(2e6 / m))  # ~ 20-40 ms a window
        x, h, g = randn(m, D), randn(m, D), randn(m, MLP)
        cases = (("qkv", h, (D, 3 * D), {}, 0), ("out_proj+residual", h, (D, D), {"residual": x}, 1),
                 ("fc1+gelu", h, (D, MLP), {"gelu": True, "save_preact": True}, 1),
                 ("fc2+residual", g, (MLP, D), {"residual": x}, 1))
        for what, a, (k, n), kw, extra in cases:
            w_kn, w_nk = weights[k, n]
            b32, b16 = bias[n], bias[n].to(torch.bfloat16)
            modes = (("NN", lambda: vb.gemm_bias_act_residual(a, w_kn, b32, **kw),
                      lambda: vb.gemm_bias_act_residual_reference(a, w_kn, b32, **kw),
                      lambda: torch.addmm(b16, a, w_kn), "torch.addmm"),
                     ("NT", lambda: to.gemm_nt(a, w_nk, b32, **kw),
                      lambda: to.gemm_nt_reference(a, w_nk, b32, **kw),
                      lambda: F.linear(a, w_nk, b16), "F.linear"))
            for mode, kernel, twin, library, lib_name in modes:
                if checked:
                    got, want = kernel(), twin()
                    pairs = zip(got, want) if kw.get("save_preact") else ((got, want),)
                    for i, (gt, wt) in enumerate(pairs):
                        _bound_check(torch, f"gemm {mode} {what}[{i}] M={m}", gt, wt, REL_TOL)
                    del got, want
                schedule = schedule_of(kernel)
                ms, lib_ms = time_pair(torch, kernel, library, iters)
                report(f"{mode} {what}", m, k, n, ms, lib_ms, lib_name,
                       gemm_work(m, k, n, extra), schedule)
        del x, h, g
        torch.cuda.empty_cache()
    # ViT-L/14: the region encode's four projections (NN and NT) and K6's
    # forward and dx, each held on its first and last rows.
    d, mlp = L14_D, L14_MLP
    w14 = {}
    for k, n in ((d, 3 * d), (d, d), (d, mlp), (mlp, d)):
        w = randn(k, n, scale=k**-0.5)
        w14[k, n] = (w, w.t().contiguous())
    b14 = {n: torch.randn(n, device=dev, generator=gen) * 0.1 for n in (d, 3 * d, mlp)}
    for rows, cases in (
            (GEMM_L14_REGION_ROWS, (("region qkv", "h", (d, 3 * d), {}, 0, True),
                                    ("region out_proj+residual", "h", (d, d), {"residual": "x"}, 1,
                                     True),
                                    ("region fc1+gelu", "h", (d, mlp), {"gelu": True}, 0, True),
                                    ("region fc2+residual", "g", (mlp, d), {"residual": "x"}, 1,
                                     True))),
            (GEMM_L14_K6_ROWS, (("K6 fc1+gelu (a1 saved)", "h", (d, mlp),
                                 {"gelu": True, "save_preact": True}, 1, True),
                                ("K6 fc2+residual", "g", (mlp, d), {"residual": "x"}, 1, True),
                                ("K6 dx da1 (x gelu'(a1))", "h", (d, mlp), {"dgelu_of": "g"}, 1,
                                 False),
                                ("K6 dx dh (f32)", "g", (mlp, d), {"out_dtype": torch.float32}, 1,
                                 False)))):
        act = {"x": randn(rows, d), "h": randn(rows, d), "g": randn(rows, mlp)}
        iters = max(2, int(2e6 / rows))
        for what, a_name, (k, n), kw, extra, with_bias in cases:
            a = act[a_name]
            kw = {key: act[v] if isinstance(v, str) else v for key, v in kw.items()}
            w_kn, w_nk = w14[k, n]
            b32 = b14[n] if with_bias else None
            b16 = b32.to(torch.bfloat16) if with_bias else None
            modes = [("NN", lambda: vb.gemm_bias_act_residual(a, w_kn, b32, **kw),
                      lambda sl: vb.gemm_bias_act_residual_reference(
                          a[sl], w_kn, b32, **{key: v[sl] if torch.is_tensor(v) else v
                                               for key, v in kw.items()}),
                      (lambda: torch.addmm(b16, a, w_kn)) if with_bias else
                      (lambda: torch.mm(a, w_kn)), "torch.addmm" if with_bias else "torch.mm")]
            if what.startswith("region"):
                modes.append(("NT", lambda: to.gemm_nt(a, w_nk, b32, **kw),
                              lambda sl: to.gemm_nt_reference(
                                  a[sl], w_nk, b32, **{key: v[sl] if torch.is_tensor(v) else v
                                                       for key, v in kw.items()}),
                              lambda: F.linear(a, w_nk, b16), "F.linear"))
            for mode, kernel, twin_rows, library, lib_name in modes:
                held_on_rows(f"gemm {mode} L/14 {what} M={rows}", kernel, twin_rows, rows)
                schedule = schedule_of(kernel)
                ms, lib_ms = time_pair(torch, kernel, library, iters)
                report(f"{mode} L/14 {what}", rows, k, n, ms, lib_ms, lib_name,
                       gemm_work(rows, k, n, extra), schedule)
        del act
        torch.cuda.empty_cache()
    del w14, b14
    for what, rows, p, q in GEMM_TN_CASES:
        xa, ya = randn(rows, p), randn(rows, q)
        got = to.gemm_tn(xa, ya)
        _bound_check(torch, f"gemm TN {what}", got, to.gemm_tn_reference(xa, ya), SUM_TOL)
        if not torch.equal(got, to.gemm_tn(xa, ya)):
            raise AssertionError(f"gemm TN {what}: two runs differ")
        ms, lib_ms = time_pair(torch, lambda: to.gemm_tn(xa, ya),
                               lambda: torch.matmul(xa.t(), ya), 10)
        report(f"TN {what}", p, rows, q, ms, lib_ms, "torch.matmul",
               work(bf16_flops=2.0 * rows * p * q, nbytes=2.0 * rows * (p + q) + 4.0 * p * q))
        del xa, ya, got
    del weights, bias
    torch.cuda.empty_cache()


def slice_phase(torch, np, vb, cli_serve, card: str):
    from dclip_tpu_torch.ops.image_ops import normalize

    args = cli_serve.parse_args([
        "--model_preset", "vit-b-16", "--clip_weights", "random", "--seed", "0",
        "--tokenizer_dir", "hash", "--buckets", "1,4,16,64", "--index_dim", "512",
        "--device", "cuda",
    ])
    t0 = time.perf_counter()
    service = cli_serve.build_service(args)
    print(f"slice: service built in {time.perf_counter() - t0} s", flush=True)
    cfg = service.cfg
    if service.model.dtype != torch.bfloat16:
        raise AssertionError(f"compute dtype {service.model.dtype}, expected bf16 on CUDA")

    from dclip_tpu_torch.kernels import topk as tk

    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (cfg.vision.image_size,) * 2 + (3,), np.uint8)
              for _ in range(8)]
    vb.reset_launches()
    tk.reset_launches()
    print("slice: warmup", json.dumps(service.warmup()), f"({card})", flush=True)
    if cli_serve.selftest(service, args) != 0:
        raise AssertionError("serve --selftest failed")
    img = service.encode_images(images)
    txt = service.encode_texts(["a photo of a dog", "a red car", "two cats on a sofa"])
    torch.cuda.synchronize()
    launches = dict(vb.LAUNCHES)

    batches = len(service.buckets) + 1 + 1  # warmup buckets, selftest image, 8 images
    layers = cfg.vision.num_layers
    expected = {
        "layernorm": 2 * layers * batches,
        "gemm_bias_act_residual": 4 * layers * batches,
        "attention": layers * batches,
        "attention_block": layers * batches,
        "mlp_block": layers * batches,
        "encoder_forward": batches,
        "image_features": batches,
    }
    print("slice: launches", json.dumps(launches), "expected", json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")

    for name, e in (("image", img), ("text", txt)):
        norms = np.linalg.norm(e, axis=-1)
        if e.shape[1] != cfg.projection_dim or not np.isfinite(e).all() \
                or not np.allclose(norms, 1.0, atol=1e-3):
            raise AssertionError(f"{name} embeddings bad: shape {e.shape}, norms {norms}")

    with torch.no_grad():
        w32 = vb.pack_vision_weights(cfg, service.model.state_dict(), torch.float32)
        px = torch.from_numpy(np.stack(images)).to(service.device)
        px = normalize(px.float() / 255.0)
        ref = vb.fused_image_features_reference(cfg, w32, px).float()
        ref = (ref / ref.norm(dim=-1, keepdim=True)).cpu().numpy()
    cos = (img * ref).sum(-1)
    print(f"slice: image cosine bf16 kernels vs f32 twin: min {cos.min()} "
          f"mean {cos.mean()} bound {COS_BOUND}", flush=True)
    if not cos.min() >= COS_BOUND:
        raise AssertionError(f"image cosine {cos.min()} < {COS_BOUND}")
    launches["topk_streamed"] = search_phase(torch, np, service, card)
    print(f"slice: K12 launches {launches['topk_streamed']} (the selftest's search + "
          f"{1 + SEARCH_CALLS} index searches)", flush=True)
    if launches["topk_streamed"] != 2 + SEARCH_CALLS:
        raise AssertionError(f"K12 launches {launches['topk_streamed']} != {2 + SEARCH_CALLS}")
    return service, args, launches


def search_phase(torch, np, service, card: str):
    """`ClipService.search` over a 1,000,000-row index of seeded unit keys:
    the first search after the add (it copies the keys to the card once),
    then SEARCH_CALLS searches of 64 text queries over the device-resident
    keys, each timed end to end, with the peak device memory; one search
    by the per-call-copy path (keys copied to the card, K12, results to
    the host: what each search paid before) timed beside them. Every
    result equal, ids and score bits, to K12 over
    `torch.as_tensor(store.keys)` on the card. Returns the K12 launch count
    after the service's searches."""
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.kernels import topk as tk
    from dclip_tpu_torch.ops.knn import knn_search
    from dclip_tpu_torch.serve.service import ClipService

    dim = service.cfg.projection_dim
    gen = torch.Generator(device="cuda").manual_seed(5)
    keys_dev = torch.randn((SEARCH_N, dim), generator=gen, device="cuda")
    keys_dev /= keys_dev.norm(dim=-1, keepdim=True)
    store = EmbeddingStore.from_arrays(keys_dev.cpu().numpy(),
                                       ids=[f"img{i}" for i in range(SEARCH_N)])
    del keys_dev
    torch.cuda.empty_cache()
    big = ClipService(service.model, service.cfg, service.tokenizer, index=store,
                      device=service.device)
    texts = [f"a photo of object {i} on a table" for i in range(SEARCH_Q)]
    queries = big.encode_texts(texts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launched = tk.LAUNCHES["topk_streamed"]
    t0 = time.perf_counter()
    results = [big.search(queries, k=SEARCH_K)]
    first = time.perf_counter() - t0
    seconds, collections = [], []
    for _ in range(SEARCH_CALLS):
        before = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        results.append(big.search(queries, k=SEARCH_K))
        seconds.append(time.perf_counter() - t0)
        collections.append(gc.get_stats()[2]["collections"] - before)
    path_launches = tk.LAUNCHES["topk_streamed"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if path_launches - launched != 1 + SEARCH_CALLS:
        raise AssertionError("ClipService.search did not launch K12 once per call")
    # The per-call-copy path; its launch is the comparison's, not the path's.
    t0 = time.perf_counter()
    with torch.inference_mode():
        want_s, want_i = knn_search(torch.as_tensor(queries, device="cuda"),
                                    torch.as_tensor(store.keys, device="cuda"), SEARCH_K)
        want_s, want_i = want_s.cpu().numpy(), want_i.cpu().numpy()
    per_call = time.perf_counter() - t0
    for hits in results:
        got_i = np.asarray([[int(h[0][3:]) for h in row] for row in hits])
        got_s = np.asarray([[h[1] for h in row] for row in hits], np.float32)
        if not (np.array_equal(got_i, want_i) and np.array_equal(got_s, want_s)):
            raise AssertionError("ClipService.search differs from K12 over the store's keys")
    print(f"search: ClipService.search, {SEARCH_Q} queries x {SEARCH_N} keys x {dim}, "
          f"k={SEARCH_K}, end to end: first after the add (one key copy) {1e3 * first} ms, "
          f"then device-resident {json.dumps([1e3 * x for x in seconds])} ms (full garbage "
          f"collections during each: {collections}); per-call key "
          f"copy {1e3 * per_call} ms; peak device memory {peak} GiB; results bit-equal to "
          f"K12 over torch.as_tensor(store.keys) ({card})", flush=True)
    del big, store
    torch.cuda.empty_cache()
    return path_launches


def _bound_check(torch, name, got, want, tol, with_one=True):
    """max |got - want| <= tol * max(1, max |want|) (or tol * max |want|)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    bound = tol * (max(1.0, scale) if with_one else scale)
    print(f"kernel {name}: max_abs_err {err} bound {bound}", flush=True)
    if not err <= bound:
        raise AssertionError(f"{name}: max_abs_err {err} > {bound}")
    return err


def _text_masks(torch, np, dev):
    """The text tower's masks at the training batch: the synthetic batch's
    captions (seed 0), packed (causal + segment ids) and unpacked (causal
    + key padding)."""
    from dclip_tpu_torch.cli.common import synthetic_distill_batch
    from dclip_tpu_torch.core import CLIPConfig, TeacherConfig
    from dclip_tpu_torch.ops.packing import pack_captions

    cfg = CLIPConfig.vit_b_16()
    batch = synthetic_distill_batch(cfg, TeacherConfig(), TRAIN_B, np.random.RandomState(0))
    packed = pack_captions(batch["input_ids"], batch["attention_mask"], cfg.text.eos_token_id)
    seg = torch.from_numpy(packed["packed_segments"]).to(dev)
    pad = torch.from_numpy(batch["attention_mask"]).to(dev)
    return seg, pad, batch


def _keep(torch, b, s, dev, kw):
    """The boolean [B, S, S] of the (query, key) pairs the masks keep, or
    None without masks."""
    if not kw:
        return None
    keep = torch.ones((b, s, s), dtype=torch.bool, device=dev)
    if kw.get("causal"):
        keep &= torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    if kw.get("segment_ids") is not None:
        seg = kw["segment_ids"]
        keep &= seg[:, :, None] == seg[:, None, :]
    if kw.get("padding_mask") is not None:
        keep &= kw["padding_mask"][:, None, :] > 0
    return keep


ATTN_BWD_EDGE_S = (1, 63, 64, 65, 128, 197, 257, 320, 321)


def attention_bwd_edges(torch, np, va, table: KernelTable):
    """K5 against its twin at every edge of its 64-row tiles, 128-row
    blocks, narrow last tile (<= 16 live columns) and 4-slot ring, with
    each mask kind (a fully masked batch row under causal + padding), B=3,
    D=128, 2 heads; two calls on the same inputs give the same bits."""
    dev = torch.device("cuda")
    b, d, heads = 3, 128, 2
    for s in ATTN_BWD_EDGE_S:
        rng = np.random.RandomState(2000 + s)
        lengths = np.maximum(1, (np.arange(b) + 1) * s // b)
        lengths[-1] = 0
        pad = torch.from_numpy((np.arange(s)[None] < lengths[:, None]).astype("float32")).to(dev)
        segs = (np.arange(s) * 3 // s + 1)[None].repeat(b, 0).astype("int32")
        segs[:, s - s // 5:] = 0
        seg = torch.from_numpy(segs).to(dev)
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * d)).astype("float32")).to(
            dev, torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal((b, s, d)).astype("float32")).to(
            dev, torch.bfloat16)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        for what, kw in (("none", {}), ("causal_pad", {"causal": True, "padding_mask": pad}),
                         ("segments", {"segment_ids": seg}),
                         ("causal_segments", {"causal": True, "segment_ids": seg})):
            o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
            o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
            grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
            want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw)
            err = max(_bound_check(torch, f"attention_bwd[edge S={s} {what}] {n}", a, w, BWD_TOL)
                      for n, a, w in zip(("dq", "dk", "dv"), grads, want))
            table.error("self_attention_bwd_stats", err)
            again = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
            if not all(torch.equal(x1, x2) for x1, x2 in zip(grads, again)):
                raise AssertionError(f"attention_bwd[edge S={s} {what}]: two calls differ")


def _record(torch, card, table, name, err, timed, kernel_fn=None, plain_fn=None, iters=10,
            variant="", bound=(0.0, 0.0), library_fn=None, graph=False, table_row=True):
    """Holds the error; when timed, prints the eager times (and with `graph`
    the device times of CUDA graph replays beside them) and, with
    `table_row`, puts the eager times in the kernels line."""
    table.error(name, err)
    if timed:
        ms, plain_ms = time_pair(torch, kernel_fn, plain_fn, iters)
        lib_ms = None if library_fn is None else time_one(torch, library_fn, iters)
        print(f"time {name}[{variant}]: kernel {ms} ms, plain {plain_ms} ms, bound "
              f"{max(bound)} ms, library {lib_ms} ms ({card})", flush=True)
        if graph:  # the device's time without the wrapper's host time
            g_ms, g_plain_ms = time_pair_graph(torch, kernel_fn, plain_fn, iters)
            print(f"time {name}[{variant}] device (CUDA graph of {iters} calls): kernel "
                  f"{g_ms} ms, plain {g_plain_ms} ms ({card})", flush=True)
        if table_row:
            table.timed(name, ms, plain_ms, bound, lib_ms)


def train_kernel_phase(torch, np, card: str, table: KernelTable):
    """The training kernels against their twins at the cache-warm step's
    shapes, ViT-B/16 and (the `[l14]` rows) ViT-L/14 at B=256, plus a
    ragged small case of each; CUDA-event times."""
    from dclip_tpu_torch.kernels import mlp_frozen as mf
    from dclip_tpu_torch.kernels import vit_attention as va

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(dtype))

    def record(*args, **kw):
        _record(torch, card, table, *args, **kw)

    seg, pad, _ = _text_masks(torch, np, dev)
    packed, unpacked = {"causal": True, "segment_ids": seg}, {"causal": True, "padding_mask": pad}
    attn_cases = [  # (variant, b, s, d, heads, masks, timed, row suffix)
        ("vision", TRAIN_B, S, D, HEADS, {}, True, ""),
        ("text_packed", seg.shape[0], TEXT_S, TEXT_D, TEXT_HEADS, packed, True, ""),
        ("text_unpacked", TRAIN_B, TEXT_S, TEXT_D, TEXT_HEADS, unpacked, True, ""),
        ("ragged", 3, 50, 128, 2, {"padding_mask": (torch.arange(50, device=dev)[None]
                                                     < torch.tensor([[50], [17], [1]],
                                                                    device=dev)).float()},
         False, ""),
        ("l14_vision", TRAIN_B, L14_S, L14_D, L14_HEADS, {}, True, "[l14]"),
        ("l14_text_packed", seg.shape[0], TEXT_S, L14_TEXT_D, L14_TEXT_HEADS, packed, True,
         "[l14]"),
        ("l14_text_unpacked", TRAIN_B, TEXT_S, L14_TEXT_D, L14_TEXT_HEADS, unpacked, True,
         "[l14]"),
    ]
    for variant, b, s, d, heads, kw, timed, row in attn_cases:
        qkv = randn(b, s, 3 * d)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        g = randn(b, s, d)
        keep = _keep(torch, b, s, dev, kw)
        pairs = float(b * s * s if keep is None else keep.sum().item())
        hd = d // heads
        mask_bytes = 4.0 * b * s if kw.get("padding_mask") is not None \
            or kw.get("segment_ids") is not None else 0.0
        io = 2.0 * b * s * d  # one bf16 [B, S, D] tensor
        stats = 8.0 * b * s * heads
        fwd_bound = work(bf16_flops=4.0 * hd * heads * pairs, nbytes=4 * io + mask_bytes + stats)
        fused_bound = work(bf16_flops=4.0 * hd * heads * pairs, nbytes=4 * io + mask_bytes)
        bwd_bound = work(bf16_flops=10.0 * hd * heads * pairs,
                         nbytes=8 * io + stats + mask_bytes)
        o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
        o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
        err = max(_bound_check(torch, f"attention_fwd[{variant}] o", o, o_ref, REL_TOL),
                  _bound_check(torch, f"attention_fwd[{variant}] m", m, m_ref, REL_TOL))
        # rinv <= 1: held elementwise relative to the twin's.
        rel = ((r - r_ref).abs() / r_ref.abs()).max().item()
        print(f"kernel attention_fwd[{variant}] rinv: max_rel_err {rel} bound {REL_TOL}",
              flush=True)
        if not rel <= REL_TOL:
            raise AssertionError(f"rinv[{variant}] relative error {rel} > {REL_TOL}")
        lib_fwd = sdpa_calls(torch, q, k, v, heads, keep) if timed else None
        record("self_attention_fwd_stats" + row, err, timed,
               lambda: va.self_attention_fwd_stats(q, k, v, heads, **kw),
               lambda: va.attention_reference(q, k, v, heads, stats=True, **kw), 10, variant,
               fwd_bound, lib_fwd)
        o3 = va.self_attention_fused(q, k, v, heads, **kw)
        err3 = _bound_check(torch, f"attention_fused[{variant}]", o3, o_ref, REL_TOL)
        record("self_attention_fused" + row, err3, timed,
               lambda: va.self_attention_fused(q, k, v, heads, **kw),
               lambda: va.attention_reference(q, k, v, heads, **kw), 10, variant,
               fused_bound, lib_fwd)
        grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
        want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw)
        errb = max(_bound_check(torch, f"attention_bwd[{variant}] {n}", a, w, BWD_TOL)
                   for n, a, w in zip(("dq", "dk", "dv"), grads, want))
        record("self_attention_bwd_stats" + row, errb, timed,
               lambda: va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw),
               lambda: va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw),
               5, variant, bwd_bound,
               sdpa_calls(torch, q, k, v, heads, keep, g) if timed else None)
        del qkv, q, k, v, g, o, m, r, o_ref, m_ref, r_ref, grads, want, lib_fwd
        torch.cuda.empty_cache()
    attention_bwd_edges(torch, np, va, table)

    # (variant, b, s, d, mlp, timed, row suffix): ViT-L/14's is K7's widths.
    for variant, b, s, d, mlp, timed, row in (
            ("vision", TRAIN_B, S, D, MLP, True, ""), ("ragged", 1, S, D, MLP, False, ""),
            ("l14_vision", TRAIN_B, L14_S, L14_D, L14_MLP, True, "[l14]")):
        mrows = b * s
        lw = layer_weights(rng, torch, dev, d, mlp)
        p = mf.pack_frozen_mlp(lw["ln2_scale"], lw["ln2_bias"], lw["fc1_w"].t(), lw["fc1_b"],
                               lw["fc2_w"].t(), lw["fc2_b"], torch.bfloat16)
        x, g = randn(b, s, d), randn(b, s, d)
        y, a1 = mf.mlp_frozen_fwd(x, p)
        y_ref, a1_ref = mf.mlp_frozen_fwd_reference(x, p)
        err = max(_bound_check(torch, f"mlp_frozen_fwd[{variant}] y", y, y_ref, REL_TOL),
                  _bound_check(torch, f"mlp_frozen_fwd[{variant}] a1", a1, a1_ref, REL_TOL))
        weights = 4.0 * d * mlp + 4.0 * (mlp + 3 * d)
        record("mlp_frozen_fwd" + row, err, timed, lambda: mf.mlp_frozen_fwd(x, p),
               lambda: mf.mlp_frozen_fwd_reference(x, p), 5, variant,
               work(bf16_flops=4.0 * mrows * d * mlp,
                    nbytes=4.0 * mrows * d + 2.0 * mrows * mlp + weights))
        dx = mf.mlp_frozen_bwd(x, g, a1, p)
        errb = _bound_check(torch, f"mlp_frozen_bwd[{variant}] dx", dx,
                            mf.mlp_frozen_bwd_reference(x, g, a1_ref, p), BWD_TOL)
        record("mlp_frozen_bwd" + row, errb, timed, lambda: mf.mlp_frozen_bwd(x, g, a1, p),
               lambda: mf.mlp_frozen_bwd_reference(x, g, a1_ref, p), 5, variant,
               work(bf16_flops=4.0 * mrows * d * mlp,
                    nbytes=6.0 * mrows * d + 2.0 * mrows * mlp + 4.0 * d * mlp + 4.0 * d))
        dh = randn(b, s, d, dtype=torch.float32)
        errl = _bound_check(torch, f"layernorm_bwd[{variant}]",
                            mf.layernorm_bwd(x, g, dh, p["ln2_scale"]),
                            mf.layernorm_bwd_reference(x, g, dh, p["ln2_scale"]), REL_TOL)
        record("layernorm_bwd" + row, errl, timed,
               lambda: mf.layernorm_bwd(x, g, dh, p["ln2_scale"]),
               lambda: mf.layernorm_bwd_reference(x, g, dh, p["ln2_scale"]), 20, variant,
               work(f32_flops=12.0 * mrows * d, nbytes=10.0 * mrows * d + 4.0 * d),
               layer_norm_grad_call(torch, x, p["ln2_scale"], dh) if timed else None)
        del x, g, y, a1, y_ref, a1_ref, dx, dh, p, lw
        torch.cuda.empty_cache()

    # (variant, b, timed, in the kernels line): B=4096 is timed beside the step's batch.
    distill_loss_cases(torch, randn, card, table, TEXT_D,
                       (("b256", TRAIN_B, True, True), ("ragged", 5, False, False),
                        (f"b{DL_BIG_B}", DL_BIG_B, True, False)))
    torch.cuda.empty_cache()


def _teacher_sd(rng, torch, d, device):
    """Cross-attention weights with 1/sqrt(D) matrices (attention far from
    uniform), non-zero biases and LN affines, in the teacher's names."""
    def n(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype("float32"))

    sd = {}
    for direction in ("text_to_image", "image_to_text"):
        pre = f"cross_modal_attention.{direction}."
        sd[pre + "in_proj_weight"] = n(3 * d, d, scale=d**-0.5)
        sd[pre + "in_proj_bias"] = n(3 * d, scale=0.1)
        sd[pre + "out_proj.weight"] = n(d, d, scale=d**-0.5)
        sd[pre + "out_proj.bias"] = n(d, scale=0.1)
    for norm in ("norm_text", "norm_image"):
        sd[f"cross_modal_attention.{norm}.weight"] = 1.0 + n(d, scale=0.1)
        sd[f"cross_modal_attention.{norm}.bias"] = n(d, scale=0.1)
    return {k: v.to(device) for k, v in sd.items()}


def core_sdpa_calls(torch, qkv_t, qkv_i, text_mask, image_mask, heads):
    """K10's core as two `scaled_dot_product_attention` calls, one a
    direction, on the same f32 q | k | v views with boolean key masks (f32
    out; a row with no valid key gives NaN there, not the uniform average)."""
    F = torch.nn.functional
    b, t, three_d = qkv_t.shape
    p, d = qkv_i.shape[1], three_d // 3

    def h(x):
        return x.reshape(b, x.shape[1], heads, d // heads).transpose(1, 2)

    qt, kt, vt = (h(qkv_t[..., i * d:(i + 1) * d]) for i in range(3))
    qi, ki, vi = (h(qkv_i[..., i * d:(i + 1) * d]) for i in range(3))
    keep_t, keep_i = (m[:, None, None, :] > 0 for m in (text_mask, image_mask))
    return lambda: (F.scaled_dot_product_attention(qt, ki, vi, attn_mask=keep_i),
                    F.scaled_dot_product_attention(qi, kt, vt, attn_mask=keep_t))


def xattn_kernel_phase(torch, np, card: str, table: KernelTable, d=TEXT_D, heads=TEXT_HEADS):
    """K10 at the teacher tail's shapes and width `d`, and its two CUDA
    kernels, against their twins; CUDA-event times in the rows named
    with `_width_suffix(d)`."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.kernels import cross_attention as xa

    dev = torch.device("cuda")
    suffix = _width_suffix(d)
    rng = np.random.RandomState(3)
    b, t, p = TRAIN_B, TEXT_S, TEACHER_P
    w = xa.pack_cross_attention(_teacher_sd(rng, torch, d, dev), torch.bfloat16)
    _, _, batch = _text_masks(torch, np, dev)
    ids, am = batch["input_ids"], batch["attention_mask"]
    # The content-token mask of encode_tokens: valid, not BOS, not EOS.
    eos = CLIPConfig.vit_b_16().text.eos_token_id
    tmask_np = (am > 0) & (np.arange(t)[None] > 0) & (ids != eos)
    tmask = torch.from_numpy(tmask_np.astype("float32")).to(dev)
    imask_np = (rng.rand(b, p) > 0.25).astype("float32")
    imask_np[:2] = 0.0  # two images with no valid box
    imask = torch.from_numpy(imask_np).to(dev)
    # bf16-valued f32 inputs zeroed at masked slots, as the trainer gives them.
    text = (torch.from_numpy(rng.standard_normal((b, t, d)).astype("float32")).to(dev)
            .bfloat16().float() * tmask[..., None])
    image = (torch.from_numpy(rng.standard_normal((b, p, d)).astype("float32")).to(dev)
             .bfloat16().float() * imask[..., None])
    rows = b * (t + p)

    got = xa.cross_attention_fused(w, text, image, tmask, imask, heads)
    want = xa.cross_attention_reference(w, text, image, tmask, imask, heads)
    err = max(_bound_check(torch, f"cross_attention[{name}]", g, r, REL_TOL)
              for name, g, r in zip(("text", "image"), got, want))
    if got[0].dtype != torch.float32:
        raise AssertionError(f"cross_attention: f32 inputs gave {got[0].dtype}")
    # The two boxless rows: every text query averages the image values.
    table.error("cross_attention" + suffix, err)
    gemm_flops = 2.0 * b * (t + p) * d * 3 * d + 2.0 * rows * d * d
    core_flops = 8.0 * b * t * p * d
    bound = work(bf16_flops=gemm_flops, f32_flops=core_flops + 10.0 * rows * d,
                 nbytes=8.0 * rows * d + 4.0 * rows + 2.0 * 8 * d * d + 4.0 * 12 * d)
    ms, plain_ms = time_pair(torch, lambda: xa.cross_attention_fused(w, text, image, tmask,
                                                                      imask, heads),
                             lambda: xa.cross_attention_reference(w, text, image, tmask, imask,
                                                                  heads), 20)
    print(f"time cross_attention{suffix}: kernel {ms} ms, plain {plain_ms} ms, bound "
          f"{max(bound)} ms ({card})", flush=True)
    table.timed("cross_attention" + suffix, ms, plain_ms, bound)

    qkv_t = (text.bfloat16() @ w["w_text"]).float() + w["b_text"]
    qkv_i = (image.bfloat16() @ w["w_image"]).float() + w["b_image"]
    out = xa.cross_attention_core(qkv_t, qkv_i, tmask, imask, heads)
    ref = xa.cross_attention_core_reference(qkv_t, qkv_i, tmask, imask, heads)
    err = max(_bound_check(torch, f"cross_attention_core[{name}]", g, r, REL_TOL)
              for name, g, r in zip(("text", "image"), out, ref))
    boxless = ref[0][:2]
    uniform = qkv_i[:2, :, 2 * d:].mean(1, keepdim=True).expand_as(boxless)
    _bound_check(torch, "cross_attention_core[boxless rows: uniform average]", out[0][:2],
                 uniform, REL_TOL)
    table.error("cross_attention_core" + suffix, err)
    bound = work(f32_flops=core_flops, nbytes=12.0 * rows * d + 4.0 * rows + 2.0 * rows * d)
    ms, plain_ms = time_pair(
        torch, lambda: xa.cross_attention_core(qkv_t, qkv_i, tmask, imask, heads),
        lambda: xa.cross_attention_core_reference(qkv_t, qkv_i, tmask, imask, heads), 20)
    lib_ms = time_one(torch, core_sdpa_calls(torch, qkv_t, qkv_i, tmask, imask, heads), 20)
    print(f"time cross_attention_core{suffix}: kernel {ms} ms, plain {plain_ms} ms, bound "
          f"{max(bound)} ms, library (two SDPA calls, one a direction) {lib_ms} ms ({card})",
          flush=True)
    table.timed("cross_attention_core" + suffix, ms, plain_ms, bound, lib_ms)

    a_t = torch.from_numpy(rng.standard_normal((b, t, d)).astype("float32")).to(dev)
    a_i = torch.from_numpy(rng.standard_normal((b, p, d)).astype("float32")).to(dev)
    streams = ((text, a_t), (image, a_i))
    scales, biases = (w["lnt_scale"], w["lni_scale"]), (w["lnt_bias"], w["lni_bias"])
    out = xa.add_layernorm_f32(streams, scales, biases)
    err = max(_bound_check(torch, f"add_layernorm_f32[{i}]", g,
                           xa.add_layernorm_reference(x, a, s, bb), REL_TOL)
              for i, (g, (x, a), s, bb) in enumerate(zip(out, streams, scales, biases)))
    table.error("add_layernorm_f32" + suffix, err)
    bound = work(f32_flops=10.0 * rows * d, nbytes=12.0 * rows * d + 16.0 * d)
    ms, plain_ms = time_pair(
        torch, lambda: xa.add_layernorm_f32(streams, scales, biases),
        lambda: [xa.add_layernorm_reference(x, a, s, bb)
                 for (x, a), s, bb in zip(streams, scales, biases)], 20)
    print(f"time add_layernorm_f32{suffix}: kernel {ms} ms, plain {plain_ms} ms, bound "
          f"{max(bound)} ms ({card})", flush=True)
    table.timed("add_layernorm_f32" + suffix, ms, plain_ms, bound)
    torch.cuda.empty_cache()


def loader_self_check_phase(torch, card: str, table: KernelTable):
    """K13, the loader's self-check kernel, against its twin; CUDA-event
    times."""
    from dclip_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128) * 0.25 - 7.0
    err = (_build.probe_x2(x) - _build.probe_x2_reference(x)).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"loader self-check kernel: max_abs_err {err}")
    table.error("loader_self_check", err)
    bound = work(f32_flops=1024.0, nbytes=8.0 * 1024)
    ms, plain_ms = time_pair(torch, lambda: _build.probe_x2(x),
                             lambda: _build.probe_x2_reference(x), 50)
    print(f"time loader_self_check: kernel {ms} ms, plain {plain_ms} ms, bound {max(bound)} ms "
          f"({card})", flush=True)
    table.timed("loader_self_check", ms, plain_ms, bound)


# -- the training slices --------------------------------------------------------------


def _kernel_sources():
    """{kernel wrapper: (source, TPU kernel it replaces)} of the kernels line's plain rows."""
    return {**KERNELS, **TRAIN_KERNELS, **TEACHER_KERNELS, **TRAINABLE_KERNELS, **TOPK_KERNELS,
            **TEACHER_TRAIN_KERNELS}


def _all_modules():
    from dclip_tpu_torch.kernels import (
        _build,
        attn_block_trainable,
        cross_attention,
        distill_loss,
        mlp_frozen,
        mlp_trainable,
        topk,
        trainable_ops,
        vit_attention,
        vit_block,
    )

    return (vit_block, vit_attention, mlp_frozen, distill_loss, cross_attention, _build,
            mlp_trainable, attn_block_trainable, trainable_ops, topk)


def _reset_all_launches():
    for mod in _all_modules():
        mod.reset_launches()


def _all_launches():
    out = {}
    for mod in _all_modules():
        out.update(mod.LAUNCHES)
    return out


def _teacher_config():
    from dclip_tpu_torch.core import TeacherConfig

    return TeacherConfig(embed_dim=512, num_heads=TEXT_HEADS, max_patches=TEACHER_P,
                         max_text_tokens=TEXT_S)


def _distill_config(batch_size, **changes):
    import dataclasses

    from dclip_tpu_torch.core import DistillConfig

    return dataclasses.replace(
        DistillConfig(train_batch_size=batch_size, accumulate_grad_batches=1,
                      learning_rate=1e-4, student_model="vit-b-16",
                      teacher_clip_model="vit-b-16", packed_text=True,
                      teacher=_teacher_config()), **changes)


def _batch(np, batch_size, seed=0, first=0, clip_cfg=None, teacher_cfg=None):
    from dclip_tpu_torch.cli.common import synthetic_distill_batch
    from dclip_tpu_torch.core import CLIPConfig

    batch = synthetic_distill_batch(clip_cfg or CLIPConfig.vit_b_16(),
                                    teacher_cfg or _teacher_config(), batch_size,
                                    np.random.RandomState(seed))
    batch["index"] = np.arange(first, first + batch_size, dtype=np.int64)
    return batch


def _distill_trainer(torch, np, sd, tsd, device, batch_size, l14=False, cached=True,
                     **changes):
    """The port's DistillTrainer at ViT-B/16, or with `l14` at ViT-L/14
    (student = teacher CLIP, `_l14_teacher_config()`), on the synthetic
    batch; `cached`: the batch's full teacher targets (seeded unit vectors)
    in an in-memory cache, else no cache (every step computes them)."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig.vit_l_14() if l14 else CLIPConfig.vit_b_16()
    batch = _batch(np, batch_size, clip_cfg=cfg,
                   teacher_cfg=_l14_teacher_config() if l14 else None)
    # A salt: no teacher fingerprint pass.
    cache = TeacherTargetCache(salt="chip-smoke") if cached else None
    config = (_l14_distill_config if l14 else _distill_config)(batch_size, **changes)
    trainer = DistillTrainer(config, sd, sd, tsd, cfg, cfg, device=device, teacher_cache=cache)
    if cached:
        targets = np.random.RandomState(2).standard_normal(
            (batch_size, 2, cfg.projection_dim)).astype(np.float32)
        targets /= np.linalg.norm(targets, axis=-1, keepdims=True)
        cache.put_batch(cache.keys_for(batch), targets)
    return trainer, batch


def _student_per_step(trainer):
    """Per layer: K4 and K6's forward (its LayerNorm and two GEMMs), K5 and
    K6's backward (two GEMMs, the LayerNorm backward); under remat the
    backward runs every layer's forward kernels again."""
    v, t = trainer.student_config.vision.num_layers, trainer.student_config.text.num_layers
    f = 2 if trainer.cfg.remat else 1
    return {"layernorm": f * v, "gemm_bias_act_residual": (2 * f + 2) * v,
            "self_attention_fwd_stats": f * (v + t), "self_attention_bwd_stats": v + t,
            "mlp_frozen_fwd": f * v, "mlp_frozen_bwd": v, "layernorm_bwd": v,
            "distill_loss_fwd": 1, "distill_loss_bwd": 1}


def _expected(per_step, steps):
    names = _all_launches()
    return {k: per_step.get(k, 0) * steps for k in names}


def _run_steps(torch, np, trainer, batch, what, card, batch_size=TRAIN_B,
               timed_steps=TIMED_STEPS):
    """Warm-up steps, then timed steps on the host clock ending in a
    synchronize; CUDA events between steps give each step's span on the
    device clock without a host synchronize."""
    losses = []
    for _ in range(WARMUP_STEPS):
        losses.append(trainer.train_step_on_batch(batch)["loss"])
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed_steps + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(timed_steps):
        losses.append(trainer.train_step_on_batch(batch)["loss"])
        marks[i + 1].record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_step = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    print(f"{what}: per-step ms (device clock between steps) {json.dumps(per_step)}; "
          f"{gpu_state()}", flush=True)
    losses = [float(x) for x in losses]
    print(f"{what}: losses", json.dumps(losses), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: training loss not finite and falling: {losses}")
    ms = 1000.0 * seconds / timed_steps
    print(f"{what}: step {ms} ms, {batch_size * timed_steps / seconds} images/s (B={batch_size}, "
          f"{timed_steps} steps after {WARMUP_STEPS} warm-up; {card})", flush=True)
    return ms


def train_slice_phase(torch, np, sd, tsd, card: str):
    """The cache-warm B/16 training step at B=256 on the card."""
    trainer, batch = _distill_trainer(torch, np, sd, tsd, "cuda", TRAIN_B)
    student = trainer.student
    if student.dtype != torch.bfloat16 or not trainer._use_kernels or not trainer._packed_text:
        raise AssertionError("expected bf16, kernels on and packed text on CUDA")
    steps = WARMUP_STEPS + TIMED_STEPS
    _reset_all_launches()
    ms = _run_steps(torch, np, trainer, batch, "train cache-warm", card)
    launches = _all_launches()
    if trainer._dev_full.hits != steps - 1:
        raise AssertionError(f"device target cache hits {trainer._dev_full.hits}, "
                             f"expected {steps - 1} (the first step hits the host cache)")
    expected = _expected(_student_per_step(trainer), steps)
    print("train: launches", json.dumps(launches), "expected", json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"training launch counts {launches} != {expected}")
    print(f"train: peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB",
          flush=True)

    # One no-grad packed text encode: the stats-free attention mode.
    t = trainer.student_config.text.num_layers
    sb = trainer._maybe_pack_text(batch, {})
    keys = ("packed_ids", "packed_segments", "packed_positions", "packed_eos_rows",
            "packed_eos_cols")
    _reset_all_launches()
    with torch.no_grad():
        emb = student.get_packed_text_features(*(sb[k] for k in keys))
    torch.cuda.synchronize()
    text_launches = _all_launches()
    print(f"train: no-grad packed text encode of {sb['packed_ids'].shape[0]} rows, launches "
          f"{json.dumps(text_launches)}", flush=True)
    if text_launches["self_attention_fused"] != t or text_launches["self_attention_fwd_stats"] \
            or not torch.isfinite(emb.float()).all() or emb.shape != (TRAIN_B, 512):
        raise AssertionError(f"no-grad text encode: launches {text_launches}, {emb.shape}")
    launches["self_attention_fused"] = text_launches["self_attention_fused"]

    profile_steps(torch, trainer, batch, card)
    del trainer
    torch.cuda.empty_cache()
    return launches, ms


def _uncached_per_step(trainer):
    """Launches of one uncached step: the region encode over B x P crops
    (12 layers of K1 + K2), the teacher text tower (K3 x 12), K10 (4
    GEMMs, its core, its add + LayerNorm), then the student step."""
    v = trainer.teacher_clip_config.vision.num_layers
    t = trainer.teacher_clip_config.text.num_layers
    per = _student_per_step(trainer)
    per.update({
        "layernorm": per["layernorm"] + 2 * v,
        "gemm_bias_act_residual": per["gemm_bias_act_residual"] + 4 * v + 4,
        "attention": v, "attention_block": v, "mlp_block": v,
        "encoder_forward": 1, "image_features": 1,
        "self_attention_fused": t,
        "cross_attention_core": 1, "add_layernorm_f32": 1, "cross_attention": 1,
    })
    return per


def uncached_slice_phase(torch, np, sd, tsd, card: str):
    """The uncached B/16 step at B=256, P=8 on the card: the main path."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    cfg = CLIPConfig.vit_b_16()
    trainer = DistillTrainer(_distill_config(TRAIN_B), sd, sd, tsd, cfg, cfg, device="cuda",
                             teacher_cache=None)
    if trainer._xattn is None or trainer._teacher_image_features is None \
            or not trainer._compact:
        raise AssertionError("expected the teacher kernels and crop compaction on CUDA")
    batch = _batch(np, TRAIN_B)
    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    ms = _run_steps(torch, np, trainer, batch, "uncached", card)
    launches = _all_launches()
    expected = _expected(_uncached_per_step(trainer), steps)
    print("uncached: launches", json.dumps(launches), "expected", json.dumps(expected),
          flush=True)
    if launches != expected:
        raise AssertionError(f"uncached launch counts {launches} != {expected}")
    print(f"uncached: peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB "
          f"({card})", flush=True)
    profile_steps(torch, trainer, batch, card, steps=1,
                  spans=("dclip.h2d", "dclip.crop", "dclip.region_encode", "dclip.teacher_text",
                         "dclip.cross_attention", "dclip.student_step"))
    launches["topk_streamed"] = gated_step(torch, np, trainer, batch, ms, card)
    del trainer
    torch.cuda.empty_cache()
    return launches, ms


def gated_step(torch, np, trainer, batch, ungated_ms, card: str):
    """One more uncached step with the teacher's k-NN gate on: a GATE_N-row
    store of seeded unit keys (`knn_store`), so K12 runs once per step on
    the B x P = GATE_Q patch embeddings. Returns K12's launches."""
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore

    gen = torch.Generator(device="cuda").manual_seed(7)
    keys = torch.randn((GATE_N, trainer.teacher_clip_config.projection_dim), generator=gen,
                       device="cuda")
    store = EmbeddingStore.from_arrays((keys / keys.norm(dim=-1, keepdim=True)).cpu().numpy())
    trainer._init_knn_gate(store)
    torch.cuda.synchronize()
    _reset_all_launches()
    t0 = time.perf_counter()
    loss = float(trainer.train_step_on_batch(batch)["loss"])
    torch.cuda.synchronize()
    gated_ms = 1e3 * (time.perf_counter() - t0)
    launches = _all_launches()
    expected = _expected({**_uncached_per_step(trainer), "topk_streamed": 1}, 1)
    print(f"gated: one uncached step with the k-NN gate over {GATE_N} keys: {gated_ms} ms "
          f"(ungated mean {ungated_ms} ms), loss {loss}, launches {json.dumps(launches)} "
          f"({card})", flush=True)
    if launches != expected or not np.isfinite(loss):
        raise AssertionError(f"gated step: launches {launches} != {expected}, loss {loss}")
    gated_profile(torch, trainer, batch, gated_ms, ungated_ms, card)
    projected = projection_step(torch, np, trainer, batch, store, expected, gated_ms,
                                ungated_ms, card)
    trainer._init_knn_gate(None)
    return launches["topk_streamed"] + projected


def projection_step(torch, np, trainer, batch, store, expected, gated_ms, ungated_ms, card):
    """One more uncached step with the gate's projection head on
    (`projection_params`, seeded `init_image_projection`) over the same
    store: the gated step's launches, and every patch that misses the store
    (all of them: its keys are random) takes the projection, source 1.
    Returns its K12 launches."""
    from dclip_tpu_torch.models.projections import init_image_projection
    from dclip_tpu_torch.ops import knn

    d = trainer.teacher_clip_config.projection_dim
    trainer._init_knn_gate(store, init_image_projection(seed=0, clip_dim=d)[1], d)
    sources = []
    real_gate = knn.knn_or_projection

    def recording_gate(*a, **k):
        res = real_gate(*a, **k)
        sources.append(res.source)
        return res

    knn.knn_or_projection = recording_gate
    try:
        torch.cuda.synchronize()
        _reset_all_launches()
        t0 = time.perf_counter()
        loss = float(trainer.train_step_on_batch(batch)["loss"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        knn.knn_or_projection = real_gate
    launches = _all_launches()
    src = torch.cat(sources).cpu()
    counts = {int(s): int((src == s).sum()) for s in (0, 1, 2)}
    print(f"gated: one uncached step with the projection head over {GATE_N} keys: {ms} ms "
          f"(store only {gated_ms}, ungated mean {ungated_ms} ms), loss {loss}, sources "
          f"{counts} (0 knn, 1 projection, 2 clip), launches {json.dumps(launches)} ({card})",
          flush=True)
    if launches != expected or not np.isfinite(loss) or counts[2] or not counts[1]:
        raise AssertionError(f"projection step: launches {launches} != {expected}, loss {loss}, "
                             f"sources {counts}")
    return launches["topk_streamed"]


def gated_profile(torch, trainer, batch, gated_ms, ungated_ms, card: str):
    """One more gated step under torch.profiler: its device time by kernel,
    K12's kernels (the query split, pass 1, the merge) by name, beside the
    gated and ungated step times, to attribute the gate's extra time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step_on_batch(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0
                   and not e.key.startswith("dclip.")), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    k12 = [(key[:60], ms) for key, ms in rows if "topk" in key or "split_tf32" in key]
    print(f"gated: profiled gated step: wall {wall_ms} ms, device {device_ms} ms; K12 kernels "
          f"{json.dumps(k12)}, {sum(ms for _, ms in k12)} ms in all; timed gated step "
          f"{gated_ms} ms, ungated mean {ungated_ms} ms ({card})", flush=True)
    for key, ms in rows[:8]:
        print(f"gated: {ms:9.3f} ms {key[:110]}", flush=True)


def cache_levels_phase(torch, np, sd, tsd, card: str):
    """A teacher cache's three levels, told apart by their launches."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig.vit_b_16()
    cache = TeacherTargetCache()
    trainer = DistillTrainer(_distill_config(TRAIN_B), sd, sd, tsd, cfg, cfg, device="cuda",
                             teacher_cache=cache)
    batch = _batch(np, TRAIN_B)
    resampled = dict(batch, input_ids=np.roll(batch["input_ids"], 1, axis=0),
                     attention_mask=np.roll(batch["attention_mask"], 1, axis=0))
    t = cfg.text.num_layers
    cases = [  # what, batch, attention_block, self_attention_fused, cross_attention
        ("miss: every level filled", batch, cfg.vision.num_layers, t, 1),
        ("repeat: device full-target hit", batch, 0, 0, 0),
        ("resampled captions: device pe hit", resampled, 0, t, 1),
    ]
    for what, b, k1, k3, k10 in cases:
        _reset_all_launches()
        loss = trainer.train_step_on_batch(b)["loss"]
        torch.cuda.synchronize()
        n = _all_launches()
        got = (n["attention_block"], n["mlp_block"], n["self_attention_fused"],
               n["cross_attention"])
        print(f"levels: {what}: K1 {got[0]}, K2 {got[1]}, K3 {got[2]}, K10 {got[3]}, loss "
              f"{float(loss)}, device full hits {trainer._dev_full.hits}, pe hits "
              f"{trainer._dev_pe.hits}", flush=True)
        if got != (k1, k1, k3, k10) or not np.isfinite(float(loss)):
            raise AssertionError(f"cache level '{what}': launches {got} != {(k1, k1, k3, k10)}")
    if trainer._dev_full.hits != 1 or trainer._dev_pe.hits != 1:
        raise AssertionError(f"cache hits: full {trainer._dev_full.hits}, pe "
                             f"{trainer._dev_pe.hits}; expected 1 and 1")
    del trainer
    torch.cuda.empty_cache()


def target_agreement_phase(torch, np, sd, tsd, l14=False):
    """Teacher targets at B=2, full width and depth: bf16 kernels on the card
    vs the f32 modules on the CPU, on the same weights; ViT-B/16, or with
    `l14` ViT-L/14 and the 768-wide meta-teacher."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    cfg = CLIPConfig.vit_l_14() if l14 else CLIPConfig.vit_b_16()
    config = _l14_distill_config if l14 else _distill_config
    tag = "l14 targets" if l14 else "targets"
    batch = _batch(np, AGREE_B, clip_cfg=cfg,
                   teacher_cfg=_l14_teacher_config() if l14 else None)
    batch["box_mask"][1, 5:] = 0.0
    targets = {}
    for device, changes in (("cuda", {}),
                            ("cpu", {"use_pallas": False, "compute_dtype": "float32"})):
        trainer = DistillTrainer(config(AGREE_B, **changes), sd, sd, tsd, cfg, cfg,
                                 device=device)
        t0 = time.perf_counter()
        got = trainer._teacher_targets(trainer._device_batch(batch))
        targets[device] = [x.double().cpu() for x in got]
        print(f"{tag}: {device} ({'kernels, bf16' if device == 'cuda' else 'modules, f32'}) "
              f"{time.perf_counter() - t0} s", flush=True)
        del trainer
    for name, a, b in zip(("teacher_img", "teacher_txt"), targets["cuda"], targets["cpu"]):
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        print(f"{tag}: {name} per-row cosine {cos.tolist()} bound {TARGET_COS}", flush=True)
        if not torch.isfinite(a).all() or not cos.min().item() >= TARGET_COS:
            raise AssertionError(f"{name}: cosine {cos.tolist()} < {TARGET_COS}")
    torch.cuda.empty_cache()


def profile_steps(torch, trainer, batch, card: str, steps: int = 2, spans=()):
    """Device busy share and device time by kernel over `steps` steps, and
    the device time under each of `spans` (torch.profiler ranges), read by
    `core.metrics.device_time_by_range`."""
    from torch.profiler import ProfilerActivity, profile

    from dclip_tpu_torch.core.metrics import device_time_by_range

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step_on_batch(batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    r = device_time_by_range(prof, steps, wall_s)
    if r["busy"] is None:
        print("profile: key_averages() show no device time", flush=True)
        return
    print(f"profile: {steps} steps, wall {1e3 * wall_s} ms, device {r['device_ms'] * steps} ms, "
          f"busy {100.0 * r['busy']}% ({card})", flush=True)
    step_ms = 1e3 * wall_s / steps
    for name in spans:
        span = r["ranges"].get(name, {"device_ms": 0.0, "host_ms": 0.0})
        print(f"profile: stage {name}: device span {span['device_ms']} ms/step "
              f"({100.0 * span['device_ms'] / step_ms:.2f}% of the wall), host "
              f"{span['host_ms']} ms/step", flush=True)
    for key, ms, count in r["kernels"][:20]:
        print(f"profile: {100.0 * ms / r['device_ms']:6.2f}% {ms:9.3f} ms/step "
              f"x{int(count):<5d} {key[:110]}", flush=True)
    for kernel in PROFILED_KERNELS:
        hit = [k for k in r["kernels"] if kernel in k[0]]
        print(f"profile: kernel {kernel}: {sum(k[1] for k in hit)} ms/step "
              f"x{int(sum(k[2] for k in hit))} ({card})", flush=True)


def grad_agreement_phase(torch, np, sd, tsd, what="grads", must_hold=(), batch_size=GRAD_B,
                         **changes):
    """One step's trainable gradients: bf16 kernels on the card vs f32
    twins on the CPU. `changes` go to `_distill_trainer` (`l14`) and the
    DistillConfig; the trainer enters epoch 0 first (its unfreeze stages
    at epoch 0 apply); each of `must_hold` must name some held tensor."""
    grads = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        trainer, batch = _distill_trainer(torch, np, sd, tsd, device, batch_size,
                                          compute_dtype=dtype, use_pallas=True, **changes)
        trainer._on_epoch_start(0)
        t0 = time.perf_counter()
        trainer.train_step_on_batch(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"{what}: {device} {dtype} step {time.perf_counter() - t0} s", flush=True)
        grads[device] = {n: (torch.zeros_like(p) if p.grad is None else p.grad).double().cpu()
                         for n, p in trainer.student.named_parameters() if p.requires_grad}
        del trainer
    # k_proj.bias: its gradient is zero in exact arithmetic (a key bias adds
    # q . b_k to every logit of a row, and softmax ignores a per-row shift),
    # so both sides hold rounding noise there; it counts in the global
    # cosine, and its norm is held below GRAD_NOISE_RATIO of the layer's
    # q_proj.bias gradient on both sides.
    dot = na = nb = 0.0
    cos = {}
    for name, a in grads["cuda"].items():
        b = grads["cpu"][name]
        dot += float((a * b).sum())
        na += float((a * a).sum())
        nb += float((b * b).sum())
        if float(b.abs().max()) == 0.0 and float(a.abs().max()) == 0.0:
            continue  # a leaf the loss does not reach (logit_scale)
        cos[name] = float((a * b).sum() / (a.norm() * b.norm()))
    glob = dot / (na ** 0.5 * nb ** 0.5)
    noise = sorted(n for n in cos if n.endswith("self_attn.k_proj.bias"))
    held = {n: c for n, c in cos.items() if n not in noise}
    worst_name = min(held, key=held.get)
    ratio = max(float(grads[d][n].norm() / grads[d][n.replace("k_proj", "q_proj")].norm())
                for n in noise for d in ("cuda", "cpu"))
    lowest = sorted(held.items(), key=lambda kv: kv[1])[:5]
    for pattern in must_hold:
        if not any(pattern in n for n in held):
            raise AssertionError(f"{what}: no held gradient matches {pattern!r}")
    print(f"{what}: {len(grads['cuda'])} trainable tensors, global cosine {glob}, min cosine "
          f"{held[worst_name]} ({worst_name}); lowest {json.dumps(lowest)}; "
          f"{len(held)} held, {len(noise)} k_proj.bias (max |g| / |g q_proj.bias| {ratio}), "
          f"{len(grads['cuda']) - len(cos)} all-zero (logit_scale); bounds {GRAD_COS_GLOBAL} / "
          f"{GRAD_COS_TENSOR}, noise ratio {GRAD_NOISE_RATIO}", flush=True)
    if not (glob >= GRAD_COS_GLOBAL and held[worst_name] >= GRAD_COS_TENSOR
            and ratio < GRAD_NOISE_RATIO):
        raise AssertionError(f"{what} agreement: global {glob}, min {held[worst_name]} "
                             f"({worst_name}), k_proj.bias noise ratio {ratio}")


# -- the fused-trainable configuration (K8, K9), fit and resume --------------------------


def trainable_kernel_phase(torch, np, card: str, table: KernelTable):
    """K8 and K9 at the fused step's shapes and a ragged small case, their
    CUDA parts, against their f32 twins; CUDA-event times in turns."""
    from dclip_tpu_torch.kernels import attn_block_trainable as ab
    from dclip_tpu_torch.kernels import mlp_trainable as mt
    from dclip_tpu_torch.kernels import trainable_ops as to
    from dclip_tpu_torch.kernels import vit_attention as va
    from dclip_tpu_torch.kernels import vit_block as vb

    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    F = torch.nn.functional

    def randn(*shape, base=0.0, scale=1.0, dtype=torch.bfloat16):
        t = base + scale * rng.standard_normal(shape).astype("float32")
        return torch.from_numpy(t.astype("float32")).to(dev).to(dtype)

    def f32(*shape, base=0.0, scale=1.0):
        return randn(*shape, base=base, scale=scale, dtype=torch.float32)

    def timed(name, variant, kernel_fn, plain_fn, iters, bound, library_fn=None, lib_note=""):
        ms, plain_ms = time_pair(torch, kernel_fn, plain_fn, iters)
        lib_ms = None if library_fn is None else time_one(torch, library_fn, iters)
        print(f"time {name}[{variant}]: kernel {ms} ms, plain {plain_ms} ms, bound {max(bound)} "
              f"ms, library {lib_ms} ms{lib_note} ({card})", flush=True)
        table.timed(name, ms, plain_ms, bound, lib_ms)

    def sum_check(name, got, want):
        return _bound_check(torch, name, got, want, SUM_TOL)

    def tn_work(rows, p, q):
        return work(bf16_flops=2.0 * rows * p * q, nbytes=2.0 * rows * (p + q) + 4.0 * p * q)

    def colsum_work(rows, n):
        return work(f32_flops=1.0 * rows * n, nbytes=2.0 * rows * n + 4.0 * n)

    def lnw_work(rows, d):
        return work(f32_flops=14.0 * rows * d, nbytes=10.0 * rows * d + 12.0 * d)

    seg, _, _ = _text_masks(torch, np, dev)
    text_rows = seg.shape[0]
    for variant, (b, s, d, mlp), timed_case in (
            ("text_packed", (text_rows, TEXT_S, TEXT_D, TEXT_MLP), True),
            ("ragged", (3, 50, 128, 256), False)):
        m = b * s
        weights = [f32(d, base=1.0, scale=0.1), f32(d, scale=0.1), f32(mlp, d, scale=d**-0.5),
                   f32(mlp, scale=0.1), f32(d, mlp, scale=mlp**-0.5), f32(d, scale=0.1)]
        x, g = randn(b, s, d), randn(b, s, d)
        p = mt.pack_trainable_mlp(*weights, dtype=torch.bfloat16)
        y, a1, h, act = mt.mlp_trainable_fwd(x, p)
        y_ref, a1_ref = mt.mlp_trainable_fwd_reference(x, *weights)
        table.error("mlp_trainable_fwd", max(
            _bound_check(torch, f"mlp_trainable_fwd[{variant}] y", y, y_ref, REL_TOL),
            _bound_check(torch, f"mlp_trainable_fwd[{variant}] a1", a1, a1_ref, REL_TOL)))
        grads = mt.mlp_trainable_bwd(x, g, a1, h, act, p)
        want = mt.mlp_trainable_bwd_reference(x, g, a1_ref, *weights)
        names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
        table.error("mlp_trainable_bwd", max(
            _bound_check(torch, f"mlp_trainable_bwd[{variant}] {n}", a, w, BWD_TOL)
            for n, a, w in zip(names, grads, want)))
        # Its CUDA parts on the same operands.
        nt_cases = [("fc1+gelu", (h, p["w1"], p["b1"]), {"gelu": True, "save_preact": True},
                     gemm_work(m, d, mlp, 1)),
                    ("fc2+residual", (act, p["w2"], p["b2"]), {"residual": x},
                     gemm_work(m, mlp, d, 1))]
        da1 = vb.gemm_bias_act_residual(g, p["w2"], dgelu_of=a1)
        dh = f32(b, s, d)
        tn_cases = [("dw2", (g, act), tn_work(m, d, mlp)), ("dw1", (da1, h), tn_work(m, mlp, d))]
        cs_cases = [("db2", g, colsum_work(m, d)), ("db1", da1, colsum_work(m, mlp))]
        _trainable_parts(torch, to, table, timed, sum_check, variant, timed_case, nt_cases,
                         tn_cases, cs_cases, (x, g, dh, p["ln_scale"]), lnw_work(m, d))
        if timed_case:
            w_bytes = 8.0 * d * mlp + 4.0 * (mlp + 3 * d)
            timed("mlp_trainable_fwd", variant, lambda: mt.mlp_trainable_fwd(x, p),
                  lambda: mt.mlp_trainable_fwd_reference(x, *weights), 5,
                  work(bf16_flops=4.0 * m * d * mlp,
                       nbytes=4.0 * m * d + 2.0 * m * mlp + w_bytes))
            timed("mlp_trainable_bwd", variant, lambda: mt.mlp_trainable_bwd(x, g, a1, h, act, p),
                  lambda: mt.mlp_trainable_bwd_reference(x, g, a1_ref, *weights), 5,
                  work(bf16_flops=8.0 * m * d * mlp,
                       nbytes=6.0 * m * d + 2.0 * m * mlp + 2 * w_bytes))
        del x, g, y, a1, h, act, y_ref, a1_ref, grads, want, da1, dh

    for variant, (b, s, d, heads), timed_case in (("vision", (TRAIN_B, S, D, HEADS), True),
                                                  ("ragged", (3, 50, 128, 2), False)):
        m = b * s
        weights = [f32(d, base=1.0, scale=0.1), f32(d, scale=0.1)]
        for _ in range(4):
            weights += [f32(d, d, scale=d**-0.5), f32(d, scale=0.1)]
        x, g = randn(b, s, d), randn(b, s, d)
        p = ab.pack_trainable_attn(*weights, dtype=torch.bfloat16)
        o, h, qkv, attn, mx, r = ab.attention_block_trainable_fwd(x, p, heads)
        want = ab.attention_block_trainable_fwd_reference(x, *weights, heads)
        err = max(_bound_check(torch, f"attn_block_trainable_fwd[{variant}] {n}", a, w, REL_TOL)
                  for n, a, w in zip(("o", "q", "k", "v", "attn", "m"),
                                     (o, *qkv.split(d, -1), attn, mx), want))
        # rinv: its logits come from bf16 q and k here and from f32 ones in
        # the twin, and a logit's rounding error grows with its size: held
        # relative to the twin's at the backward bound.
        rel = ((r - want[6]).abs() / want[6].abs()).max().item()
        print(f"kernel attn_block_trainable_fwd[{variant}] rinv: max_rel_err {rel} bound "
              f"{BWD_TOL}", flush=True)
        if not rel <= BWD_TOL:
            raise AssertionError(f"attn_block_trainable_fwd[{variant}] rinv: {rel} > {BWD_TOL}")
        table.error("attn_block_trainable_fwd", err)
        grads = ab.attention_block_trainable_bwd(x, g, h, qkv, attn, mx, r, p, heads)
        wgrads = ab.attention_block_trainable_bwd_reference(x, g, *want[1:], *weights, heads)
        names = ("dx", "dln_scale", "dln_bias", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
                 "dbo")
        errs = []
        for n, a, w in zip(names, grads, wgrads):
            if n == "dbk":
                # 0 in exact arithmetic (softmax ignores a per-row shift):
                # both sides hold rounding noise of the row sum, held to the
                # backward bound on the scale of its sibling dbq.
                e = (a - w).abs().max().item()
                bound = BWD_TOL * wgrads[4].abs().max().item()
                print(f"kernel attn_block_trainable_bwd[{variant}] dbk: max_abs_err {e} bound "
                      f"{bound} (scale of dbq)", flush=True)
                if not e <= bound:
                    raise AssertionError(f"attn_block_trainable_bwd[{variant}] dbk: {e} > {bound}")
            else:
                errs.append(_bound_check(torch, f"attn_block_trainable_bwd[{variant}] {n}", a, w,
                                         BWD_TOL))
        table.error("attn_block_trainable_bwd", max(errs))
        ga = vb.gemm_bias_act_residual(g, p["wo"])
        dqkv = torch.empty_like(qkv)
        va.self_attention_bwd_stats(*qkv.split(d, -1), ga, attn, mx, r, heads,
                                    out=dqkv.split(d, -1))
        dh = f32(b, s, d)
        nt_cases = [("qkv", (h, p["wqkv"], p["bqkv"]), {}, gemm_work(m, d, 3 * d)),
                    ("out_proj+residual", (attn, p["wo"], p["bo"]), {"residual": x},
                     gemm_work(m, d, d, 1))]
        tn_cases = [("dwqkv", (dqkv, h), tn_work(m, 3 * d, d)), ("dwo", (g, attn), tn_work(m, d, d))]
        cs_cases = [("dbqkv", dqkv, colsum_work(m, 3 * d)), ("dbo", g, colsum_work(m, d))]
        _trainable_parts(torch, to, table, timed, sum_check, variant, timed_case, nt_cases,
                         tn_cases, cs_cases, (x, g, dh, p["ln_scale"]), lnw_work(m, d))
        if timed_case:
            h2 = h.reshape(m, d)
            bias = p["bqkv"].to(torch.bfloat16)
            lib = time_one(torch, lambda: F.linear(h2, p["wqkv"], bias), 10)
            print(f"time gemm_nt[qkv] yardstick: F.linear on the same operands (bf16 bias) "
                  f"{lib} ms ({card})", flush=True)
            attn_flops = 4.0 * b * heads * s * s * (d // heads)
            w_bytes = 16.0 * d * d + 24.0 * d
            timed("attn_block_trainable_fwd", variant,
                  lambda: ab.attention_block_trainable_fwd(x, p, heads),
                  lambda: ab.attention_block_trainable_fwd_reference(x, *weights, heads), 3,
                  work(bf16_flops=8.0 * m * d * d + attn_flops,
                       nbytes=12.0 * m * d + 8.0 * m * heads + w_bytes))
            timed("attn_block_trainable_bwd", variant,
                  lambda: ab.attention_block_trainable_bwd(x, g, h, qkv, attn, mx, r, p, heads),
                  lambda: ab.attention_block_trainable_bwd_reference(x, g, *want[1:], *weights,
                                                                     heads), 2,
                  work(bf16_flops=16.0 * m * d * d + 2.5 * attn_flops,
                       nbytes=14.0 * m * d + 8.0 * m * heads + 2 * w_bytes))
        del x, g, o, h, qkv, attn, mx, r, want, grads, wgrads, ga, dqkv, dh
    torch.cuda.empty_cache()


def _trainable_parts(torch, to, table, timed, sum_check, variant, timed_case, nt_cases, tn_cases,
                     cs_cases, ln_args, ln_bound):
    """The GEMM's NT and TN modes, the column sums and the LayerNorm
    weight-gradient backward on one block's operands, against their twins."""
    F = torch.nn.functional
    for what, args, kw, bound in nt_cases:
        got, want = to.gemm_nt(*args, **kw), to.gemm_nt_reference(*args, **kw)
        pairs = zip(got, want) if kw.get("save_preact") else ((got, want),)
        table.error("gemm_nt", max(_bound_check(torch, f"gemm_nt[{variant} {what}]", a, w,
                                                REL_TOL) for a, w in pairs))
        if timed_case:
            a2, w, bias = args[0].reshape(-1, args[0].shape[-1]), args[1], args[2]
            timed("gemm_nt", f"{variant} {what}", lambda: to.gemm_nt(*args, **kw),
                  lambda: to.gemm_nt_reference(*args, **kw), 10, bound,
                  lambda: F.linear(a2, w, bias.to(torch.bfloat16)), " (F.linear, bf16 bias)")
    for what, (xa, ya), bound in tn_cases:
        got = to.gemm_tn(xa, ya)
        table.error("gemm_tn", sum_check(f"gemm_tn[{variant} {what}]", got,
                                         to.gemm_tn_reference(xa, ya)))
        if not torch.equal(got, to.gemm_tn(xa, ya)):
            raise AssertionError(f"gemm_tn[{variant} {what}]: two runs differ")
        if timed_case:
            x2, y2 = xa.reshape(-1, xa.shape[-1]), ya.reshape(-1, ya.shape[-1])
            timed("gemm_tn", f"{variant} {what}", lambda: to.gemm_tn(xa, ya),
                  lambda: to.gemm_tn_reference(xa, ya), 10, bound,
                  lambda: torch.matmul(x2.t(), y2), " (torch.matmul, bf16 out)")
    for what, xa, bound in cs_cases:
        table.error("colsum", sum_check(f"colsum[{variant} {what}]", to.colsum(xa),
                                        to.colsum_reference(xa)))
        if timed_case:
            x2 = xa.reshape(-1, xa.shape[-1])
            timed("colsum", f"{variant} {what}", lambda: to.colsum(xa),
                  lambda: to.colsum_reference(xa), 20, bound,
                  lambda: x2.sum(0, dtype=torch.float32), " (Tensor.sum)")
    x, g, dh, scale = ln_args
    got = to.layernorm_bwd_wgrad(x, g, dh, scale)
    want = to.layernorm_bwd_wgrad_reference(x, g, dh, scale)
    err = max(_bound_check(torch, f"layernorm_bwd_wgrad[{variant}] dx", got[0], want[0], REL_TOL),
              sum_check(f"layernorm_bwd_wgrad[{variant}] dscale", got[1], want[1]),
              sum_check(f"layernorm_bwd_wgrad[{variant}] dbias", got[2], want[2]))
    table.error("layernorm_bwd_wgrad", err)
    if not all(torch.equal(a, b) for a, b in zip(got, to.layernorm_bwd_wgrad(x, g, dh, scale))):
        raise AssertionError(f"layernorm_bwd_wgrad[{variant}]: two runs differ")
    if timed_case:
        timed("layernorm_bwd_wgrad", variant, lambda: to.layernorm_bwd_wgrad(x, g, dh, scale),
              lambda: to.layernorm_bwd_wgrad_reference(x, g, dh, scale), 20, ln_bound,
              layer_norm_grad_call(torch, x, scale, dh, weights=True),
              " (F.layer_norm backward: input, scale and bias gradients)")


def _fused_changes(**more):
    return dict(fused_text_mlp=True, fused_attn_block=True, **more)


def _fused_per_step(trainer):
    """Launches of one fused step by the skip rules of
    `kernels/{mlp_trainable,attn_block_trainable}.py`, read off the
    student's current flags and trainable mask: a weight that needs no
    gradient gets no weight-gradient launch, and a block whose input and
    LayerNorm need none (the first vision layer, behind frozen embeddings)
    runs neither its dh product nor its LayerNorm backward."""
    per: dict = {"distill_loss_fwd": 1, "distill_loss_bwd": 1}

    def add(name, n=1):
        per[name] = per.get(name, 0) + n

    def trains(*params):
        return any(p.requires_grad for p in params)

    vision = trainer.student.vision_model
    x_grad = trains(*vision.embeddings.parameters(), *vision.pre_layrnorm.parameters())
    for layer in vision.encoder.layers:
        attn, ln1 = layer.self_attn, layer.layer_norm1
        if not layer.fused_trainable_attn_block:
            raise AssertionError("fused configuration: a vision layer without K9")
        add("layernorm"), add("gemm_nt", 2), add("self_attention_fwd_stats")
        add("attn_block_trainable_fwd"), add("attn_block_trainable_bwd")
        add("gemm_bias_act_residual"), add("self_attention_bwd_stats")  # g Wo, K5
        add("gemm_tn", trains(attn.out_proj.weight)), add("colsum", trains(attn.out_proj.bias))
        add("gemm_tn", trains(*(getattr(attn, n).weight for n in ("q_proj", "k_proj", "v_proj"))))
        add("colsum", trains(*(getattr(attn, n).bias for n in ("q_proj", "k_proj", "v_proj"))))
        if x_grad or trains(*ln1.parameters()):
            add("gemm_bias_act_residual")
            add("layernorm_bwd_wgrad" if trains(*ln1.parameters()) else "layernorm_bwd")
        if layer.fused_frozen_mlp:  # K6
            add("layernorm"), add("gemm_bias_act_residual", 4), add("layernorm_bwd")
            add("mlp_frozen_fwd"), add("mlp_frozen_bwd")
        x_grad = x_grad or trains(*layer.parameters())
    text = trainer.student.text_model
    for layer in text.encoder.layers:
        if not layer.fused_trainable_mlp:
            raise AssertionError("fused configuration: a text layer without K8")
        ln2, mlp = layer.layer_norm2, layer.mlp
        add("self_attention_fwd_stats"), add("self_attention_bwd_stats")
        add("layernorm"), add("gemm_nt", 2), add("mlp_trainable_fwd"), add("mlp_trainable_bwd")
        add("gemm_bias_act_residual", 2)  # da1, dh (the text input always trains here)
        add("layernorm_bwd_wgrad" if trains(*ln2.parameters()) else "layernorm_bwd")
        add("gemm_tn", trains(mlp.fc1.weight) + trains(mlp.fc2.weight))
        add("colsum", trains(mlp.fc1.bias) + trains(mlp.fc2.bias))
    return per


def fused_slice_phase(torch, np, sd, tsd, card: str, default_ms: float):
    """The cache-warm B/16 step at B=256 with K8 and K9 on, beside the
    default configuration's step of phase 8."""
    trainer, batch = _distill_trainer(torch, np, sd, tsd, "cuda", TRAIN_B, **_fused_changes())
    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    ms = _run_steps(torch, np, trainer, batch, "fused cache-warm", card)
    launches = _all_launches()
    expected = _expected(_fused_per_step(trainer), steps)
    print("fused: launches", json.dumps(launches), "expected", json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"fused launch counts {launches} != {expected}")
    print(f"fused: peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB ({card})",
          flush=True)
    print(f"fused: step {ms} ms vs the default configuration's {default_ms} ms in this run "
          f"({TRAIN_B * 1000.0 / ms} vs {TRAIN_B * 1000.0 / default_ms} images/s; {card})",
          flush=True)
    profile_steps(torch, trainer, batch, card)
    del trainer
    torch.cuda.empty_cache()
    return launches


def fit_phase(torch, np, sd, tsd, card: str):
    """fit across an unfreeze stage with checkpoints, then resume."""
    import shutil
    import tempfile

    from dclip_tpu_torch.core.config import UnfreezeStage
    from dclip_tpu_torch.train.checkpoint import CheckpointManager

    changes = _fused_changes(phase1_epochs=FIT_EPOCHS, unfreeze_schedule=(
        UnfreezeStage(epoch=1, patterns=("mlp", "layer_norm")),))
    trainer, batch = _distill_trainer(torch, np, sd, tsd, "cuda", FIT_B, **changes)
    log = []

    class Pipeline:
        def epoch(self, epoch):
            expected = _expected(_fused_per_step(trainer), FIT_STEPS)
            _reset_all_launches()
            for _ in range(FIT_STEPS):
                yield batch
            torch.cuda.synchronize()
            layers = trainer.student.vision_model.encoder.layers
            grads = [float(p.grad.abs().max()) if p.grad is not None else 0.0
                     for lay in layers for p in (lay.mlp.fc1.weight, lay.layer_norm1.weight)]
            log.append((epoch, _all_launches(), expected, min(grads)))

    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpts = CheckpointManager(directory, save_top_k=2)
        t0 = time.perf_counter()
        history = trainer.fit(Pipeline(), checkpoints=ckpts)
        print(f"fit: {FIT_EPOCHS} epochs x {FIT_STEPS} steps at B={FIT_B} with checkpoints in "
              f"{time.perf_counter() - t0} s, losses {json.dumps(history['train_loss'])}",
              flush=True)
        layers = trainer.student.vision_model.encoder.layers
        for epoch, got, expected, min_grad in log:
            k6, k9 = got["mlp_frozen_fwd"], got["attn_block_trainable_fwd"]
            print(f"fit: epoch {epoch}: K6 {k6} + {got['mlp_frozen_bwd']}, K9 {k9} + "
                  f"{got['attn_block_trainable_bwd']}, K8 {got['mlp_trainable_fwd']}, min over "
                  f"vision layers of max |grad| of fc1 / LN1 {min_grad}", flush=True)
            if got != expected:
                raise AssertionError(f"fit epoch {epoch}: launches {got} != {expected}")
            n = len(layers) * FIT_STEPS
            want_k6 = n if epoch == 0 else 0
            if k6 != want_k6 or got["mlp_frozen_bwd"] != want_k6 or k9 != n \
                    or got["attn_block_trainable_bwd"] != n:
                raise AssertionError(f"fit epoch {epoch}: K6 {k6}, K9 {k9}")
            if epoch == 1 and not min_grad > 0.0:
                raise AssertionError("fit epoch 1: a vision LN1 / MLP gradient is zero")
        fresh, _ = _distill_trainer(torch, np, sd, tsd, "cuda", FIT_B, **changes)
        start = fresh.resume(ckpts)
        same = all(torch.equal(a, b) for a, b in zip(trainer.student.parameters(),
                                                     fresh.student.parameters()))
        mine, theirs = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
        same_opt = (mine["count"], mine["mini_step"]) == (theirs["count"], theirs["mini_step"]) \
            and all(torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(mine[k], theirs[k]))
        replayed = not any(lay.fused_frozen_mlp for lay in fresh.student.vision_model.encoder.layers)
        print(f"fit: resume from {ckpts.latest()['path'].rsplit('/', 1)[-1]}: start epoch {start}, "
              f"step {fresh.step} (uninterrupted {trainer.step}), parameters bit-equal {same}, "
              f"optimizer state bit-equal {same_opt}, stage replayed (K6 off) {replayed}",
              flush=True)
        if not (start == FIT_EPOCHS and fresh.step == trainer.step and same and same_opt
                and replayed):
            raise AssertionError("fit: resume did not restore the uninterrupted state")
        for t in (trainer, fresh):
            t.train_step_on_batch(batch)
        torch.cuda.synchronize()
        diff = max((a - b).abs().max().item() for a, b in zip(trainer.student.parameters(),
                                                                fresh.student.parameters()))
        print(f"fit: next update after resume vs uninterrupted: max |diff| {diff} (bound 0: no "
              f"kernel sums with atomics)", flush=True)
        if diff != 0.0:
            raise AssertionError(f"fit: the resumed run's next update differs by {diff}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del trainer, fresh
    torch.cuda.empty_cache()


# -- the meta-teacher training path: K10's trainable form, TeacherTrainer ----------------


def _xattn_trainable_case(torch, np, rng, b, dev, d=TEXT_D):
    """Live f32 teacher parameters (`CrossModalAttention` names) of width
    `d`, bf16 inputs zeroed at masked slots, the synthetic batch's
    content-token masks and P=8 box masks with two boxless rows."""
    from dclip_tpu_torch.core import CLIPConfig

    sd = _teacher_sd(rng, torch, d, dev)
    params = {k[len("cross_modal_attention."):]: v.requires_grad_() for k, v in sd.items()}
    batch = _batch(np, b)
    ids, am = batch["input_ids"], batch["attention_mask"]
    eos = CLIPConfig.vit_b_16().text.eos_token_id
    tmask_np = (am > 0) & (np.arange(TEXT_S)[None] > 0) & (ids != eos)
    tmask = torch.from_numpy(tmask_np.astype("float32")).to(dev)
    imask_np = (rng.rand(b, TEACHER_P) > 0.25).astype("float32")
    imask_np[:2] = 0.0
    imask = torch.from_numpy(imask_np).to(dev)

    def stream(n, mask):
        x = torch.from_numpy(rng.standard_normal((b, n, d)).astype("float32")).to(dev)
        return (x * mask[..., None]).bfloat16()

    return params, stream(TEXT_S, tmask), stream(TEACHER_P, imask), tmask, imask


def xattn_trainable_phase(torch, np, card: str, table: KernelTable, d=TEXT_D, h=TEXT_HEADS,
                          batches=XATTN_TRAIN_B):
    """`cross_attention_trainable` at the teacher step's shapes (B=32, 256)
    and width `d`: the forward (K10 on weights packed from the live
    parameters) against its f32 twin, the gradients against the twin's
    (autograd through the f32 module on the card), CUDA-event times of
    forward and backward in the row named with `_width_suffix(d)`."""
    from torch.func import functional_call

    from dclip_tpu_torch.kernels import cross_attention as xa
    from dclip_tpu_torch.models.cross_modal import CrossModalAttention

    dev = torch.device("cuda")
    rng = np.random.RandomState(23)
    suffix = _width_suffix(d)
    module = CrossModalAttention(d, h, device="meta")
    t, p = TEXT_S, TEACHER_P
    for b in batches:
        params, text, image, tmask, imask = _xattn_trainable_case(torch, np, rng, b, dev, d)
        names = list(params)
        text.requires_grad_()
        image.requires_grad_()
        out = xa.cross_attention_trainable(params, text, image, tmask, imask, h)
        w32 = xa.pack_cross_attention(params, torch.float32, prefix="")
        want = xa.cross_attention_reference(w32, text, image, tmask, imask, h)
        err = max(_bound_check(torch, f"cross_attention_trainable[B={b} {name}]", g, r, REL_TOL)
                  for name, g, r in zip(("text", "image"), out, want))
        if out[0].dtype != torch.bfloat16:
            raise AssertionError(f"cross_attention_trainable: bf16 inputs gave {out[0].dtype}")
        table.error("cross_attention_trainable" + suffix, err)
        gt = torch.randn(text.shape, device=dev).bfloat16()
        gi = torch.randn(image.shape, device=dev).bfloat16()
        wrt = [text, image] + [params[n] for n in names]
        grads = torch.autograd.grad(out, wrt, (gt, gi), retain_graph=True)
        t32, i32 = (x.detach().float().requires_grad_() for x in (text, image))
        ps = {n: v.detach().clone().requires_grad_() for n, v in params.items()}
        ref = functional_call(module, ps, (t32, i32, tmask, imask))
        ref_grads = torch.autograd.grad(ref, [t32, i32] + [ps[n] for n in names],
                                        (gt.float(), gi.float()))
        # Inputs' gradients are rounded to bf16 at the end (one bf16 ulp);
        # the parameters' are f32 sums of the same products.
        for i, (name, g, r) in enumerate(zip(["text", "image"] + names, grads, ref_grads)):
            _bound_check(torch, f"cross_attention_trainable[B={b}] grad {name}", g, r,
                         DL_BWD_TOL if i < 2 else SUM_TOL, with_one=False)

        rows = b * (t + p)
        gemm_flops, core_flops = 8.0 * rows * d * d, 8.0 * b * t * p * d
        param_bytes = 4.0 * (8 * d * d + 12 * d)
        fwd_bound = work(bf16_flops=gemm_flops, f32_flops=core_flops + 10.0 * rows * d,
                         nbytes=4.0 * rows * d + 4.0 * rows + param_bytes)
        bwd_bound = work(f32_flops=3.0 * (gemm_flops + core_flops + 10.0 * rows * d),
                         nbytes=6.0 * rows * d + 4.0 * rows + 2.0 * param_bytes)

        def fwd():
            with torch.no_grad():
                return xa.cross_attention_trainable(params, text, image, tmask, imask, h)

        def twin():
            w = xa.pack_cross_attention(params, torch.float32, prefix="")
            return xa.cross_attention_reference(w, text.detach(), image.detach(), tmask, imask, h)

        fwd_ms, twin_ms = time_pair(torch, fwd, twin, 10)
        bwd_ms = time_one(torch, lambda: torch.autograd.grad(out, wrt, (gt, gi),
                                                             retain_graph=True), 5)
        print(f"time cross_attention_trainable{suffix}[B={b}]: forward kernel {fwd_ms} ms, twin "
              f"{twin_ms} ms, bound {max(fwd_bound)} ms ({gemm_flops / 1e9} GFLOP bf16 + "
              f"{core_flops / 1e9} GFLOP f32); backward (f32 recompute through the module, "
              f"the same code behind either forward) {bwd_ms} ms, bound {max(bwd_bound)} ms "
              f"({3.0 * (gemm_flops + core_flops) / 1e9} GFLOP f32) ({card})", flush=True)
        table.timed("cross_attention_trainable" + suffix, fwd_ms + bwd_ms, twin_ms + bwd_ms,
                    tuple(a + c for a, c in zip(fwd_bound, bwd_bound)))
        del out, grads, ref, ref_grads
    torch.cuda.empty_cache()


def xattn_update_phase(torch, np):
    """Two Adam steps of `cross_attention_trainable`'s parameters at B=32:
    after the first, K10 runs on a fresh pack of the updated weights, and
    the pack made before the update fails the bound."""
    from dclip_tpu_torch.kernels import cross_attention as xa
    from dclip_tpu_torch.train.optim import make_optimizer

    dev = torch.device("cuda")
    rng = np.random.RandomState(24)
    h = TEXT_HEADS
    params, text, image, tmask, imask = _xattn_trainable_case(torch, np, rng, XATTN_TRAIN_B[0],
                                                              dev)
    stale = xa.pack_cross_attention(params, torch.bfloat16, prefix="")
    opt = make_optimizer(list(params.values()), 1e-2, kind="adam")
    for step in range(2):
        for v in params.values():
            v.grad = None
        at, ai = xa.cross_attention_trainable(params, text, image, tmask, imask, h)
        w32 = xa.pack_cross_attention(params, torch.float32, prefix="")
        want = xa.cross_attention_reference(w32, text, image, tmask, imask, h)
        err = max(_bound_check(torch, f"cross_attention_trainable[after {step} steps] {name}",
                               g, r, REL_TOL) for name, g, r in zip(("text", "image"),
                                                                    (at, ai), want))
        if step == 1:
            old = xa.cross_attention_fused(stale, text, image, tmask, imask, h)[0]
            stale_err = (old.float() - want[0].float()).abs().max().item()
            bound = REL_TOL * max(1.0, want[0].float().abs().max().item())
            print(f"cross_attention_trainable: after one update, fresh pack max_abs_err {err}, "
                  f"the pack made before the update {stale_err} (bound {bound})", flush=True)
            if not stale_err > bound:
                raise AssertionError("the stale pack passes: the update did not reach K10")
        (at.float().square().mean() + ai.float().square().mean()).backward()
        opt.step()
    torch.cuda.empty_cache()


def _teacher_trainer(sd, tsd, device, batch_size, pe_cache=None, l14=False, mesh=None,
                     **changes):
    """The port's TeacherTrainer at ViT-B/16 (random CLIP weights from seed
    0) with the meta-teacher of `_teacher_config()` (random, seed 0); with
    `l14`, ViT-L/14 and `_l14_teacher_config()`; `mesh` as the trainer's."""
    import dataclasses

    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.core.config import TeacherTrainConfig
    from dclip_tpu_torch.train import TeacherTrainer

    cfg = dataclasses.replace(
        TeacherTrainConfig(batch_size=batch_size, learning_rate=TEACHER_LR, seed=0,
                           clip_model="vit-l-14" if l14 else "vit-b-16",
                           teacher=_l14_teacher_config() if l14 else _teacher_config()),
        **changes)
    clip_cfg = CLIPConfig.vit_l_14() if l14 else CLIPConfig.vit_b_16()
    return TeacherTrainer(cfg, sd, clip_cfg, tsd, pe_cache=pe_cache, device=device, mesh=mesh)


def _teacher_per_step(trainer, region_encode=True):
    """Launches of one teacher step: the region encode over B x P crops
    (12 layers of K1 + K2) unless the pe cache serves it, the text tower
    (K3 x 12), one `cross_attention_trainable` (K10: 4 GEMMs, its core,
    its add + LayerNorm)."""
    v = trainer.clip_config.vision.num_layers
    per = {"gemm_bias_act_residual": 4, "self_attention_fused": trainer.clip_config.text.num_layers,
           "cross_attention_core": 1, "add_layernorm_f32": 1, "cross_attention": 1,
           "cross_attention_trainable": 1}
    if region_encode:
        per.update({"layernorm": 2 * v, "gemm_bias_act_residual": 4 * v + 4, "attention": v,
                    "attention_block": v, "mlp_block": v, "encoder_forward": 1,
                    "image_features": 1})
    return per


TEACHER_SPANS = ("dclip.crop", "dclip.region_encode", "dclip.teacher_text",
                 "dclip.cross_attention", "dclip.cross_attention_bwd", "dclip.backward",
                 "dclip.optimizer", "dclip.teacher_train_step")


def teacher_slice_phase(torch, np, sd, tsd, card: str):
    """The main path of the meta-teacher slice: `TeacherTrainer` steps at
    ViT-B/16, bf16, kernels on, no pe cache, at B=32 and B=256. Returns the
    launches of both runs."""
    steps = WARMUP_STEPS + TIMED_STEPS
    total = {}
    for b in TEACHER_B:
        trainer = _teacher_trainer(sd, tsd, "cuda", b)
        if trainer._dtype != torch.bfloat16 or not trainer._use_kernels \
                or trainer._frozen_image_features is None:
            raise AssertionError("expected bf16 and the kernels on CUDA")
        batch = _batch(np, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_launches()
        _run_steps(torch, np, trainer, batch, f"teacher B={b}", card, batch_size=b)
        launches = _all_launches()
        expected = _expected(_teacher_per_step(trainer), steps)
        print(f"teacher B={b}: launches", json.dumps(launches), "expected", json.dumps(expected),
              flush=True)
        if launches != expected:
            raise AssertionError(f"teacher launch counts {launches} != {expected}")
        print(f"teacher B={b}: peak device memory {torch.cuda.max_memory_allocated() / 2**30} "
              f"GiB ({card})", flush=True)
        if b == TEACHER_B[-1]:
            profile_steps(torch, trainer, batch, card, steps=1, spans=TEACHER_SPANS)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        del trainer
        torch.cuda.empty_cache()
    return total


def teacher_fit_phase(torch, np, sd, tsd, card: str):
    """`TeacherTrainer.fit`, 2 epochs of 2 steps at B=32 over in-memory
    batches with host indices, an in-memory pe cache with its device level,
    checkpoints in a temporary directory; then a bit-exact resume."""
    import shutil
    import tempfile

    from dclip_tpu_torch.train.checkpoint import CheckpointManager
    from dclip_tpu_torch.train.distill_trainer import TeacherTargetCache

    trainer = _teacher_trainer(sd, tsd, "cuda", FIT_B, pe_cache=TeacherTargetCache(),
                               epochs=FIT_EPOCHS)
    batches = [_batch(np, FIT_B, seed=i, first=i * FIT_B) for i in range(FIT_STEPS)]
    log = []

    class Pipeline:
        def epoch(self, epoch):
            _reset_all_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield from batches
            torch.cuda.synchronize()
            log.append((epoch, 1e3 * (time.perf_counter() - t0) / FIT_STEPS, _all_launches()))

    directory = tempfile.mkdtemp(prefix="chip_smoke_teacher_")
    try:
        ckpts = CheckpointManager(directory, prefix="teacher", save_top_k=0)
        history = trainer.fit(Pipeline(), checkpoints=ckpts)
        print(f"teacher fit: {FIT_EPOCHS} epochs x {FIT_STEPS} steps at B={FIT_B}, losses "
              f"{json.dumps(history['train_loss'])}, device pe hits {trainer._dev_pe.hits}",
              flush=True)
        for epoch, ms, got in log:
            expected = _expected(_teacher_per_step(trainer, region_encode=epoch == 0),
                                 FIT_STEPS)
            print(f"teacher fit: epoch {epoch}: {ms} ms per step (host clock; {card}), K1 "
                  f"{got['attention_block']}, K2 {got['mlp_block']}, K3 "
                  f"{got['self_attention_fused']}, K10 {got['cross_attention']}", flush=True)
            if got != expected:
                raise AssertionError(f"teacher fit epoch {epoch}: launches {got} != {expected}")
        print(f"teacher fit: ms per step, epoch 1 (pe cache hits) {log[1][1]} vs epoch 0 "
              f"(region encode) {log[0][1]} ({card})", flush=True)
        if trainer._dev_pe.hits != FIT_STEPS or not all(np.isfinite(history["train_loss"])):
            raise AssertionError(f"teacher fit: device pe hits {trainer._dev_pe.hits}, "
                                 f"losses {history['train_loss']}")
        fresh = _teacher_trainer(sd, tsd, "cuda", FIT_B, pe_cache=TeacherTargetCache(),
                                 epochs=FIT_EPOCHS)
        start = fresh.resume(ckpts)
        same = all(torch.equal(a, b) for a, b in zip(trainer.teacher.parameters(),
                                                     fresh.teacher.parameters()))
        mine, theirs = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
        same_opt = (mine["count"], mine["mini_step"]) == (theirs["count"], theirs["mini_step"]) \
            and all(torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(mine[k], theirs[k]))
        print(f"teacher fit: resume from {ckpts.latest()['path'].rsplit('/', 1)[-1]}: start "
              f"epoch {start}, step {fresh.step} (uninterrupted {trainer.step}), parameters "
              f"bit-equal {same}, Adam state bit-equal {same_opt}", flush=True)
        if not (start == FIT_EPOCHS and fresh.step == trainer.step and same and same_opt):
            raise AssertionError("teacher fit: resume did not restore the uninterrupted state")
        # The resumed trainer encodes (its pe cache is empty), the other hits.
        for tr in (trainer, fresh):
            tr.train_step_on_batch(batches[1])
        torch.cuda.synchronize()
        diff = max((a - b).abs().max().item() for a, b in zip(trainer.teacher.parameters(),
                                                                fresh.teacher.parameters()))
        print(f"teacher fit: next update after resume vs uninterrupted: max |diff| {diff} "
              f"(bound 0)", flush=True)
        if diff != 0.0:
            raise AssertionError(f"teacher fit: the resumed run's next update differs by {diff}")
        print("teacher fit: profile of one pe-cache-hit step", flush=True)
        profile_steps(torch, trainer, batches[0], card, steps=1, spans=TEACHER_SPANS)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del trainer, fresh
    torch.cuda.empty_cache()


# -- the data-parallel path: torch.distributed over NCCL, one rank ---------------


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _hold_bit_equal(torch, what, got, want):
    """Two {name: tensor} dicts bit-equal, else the largest differences
    printed and an AssertionError."""
    diffs = {k: (got[k].float() - want[k].float()).abs().max().item() for k in want
             if not torch.equal(got[k], want[k])}
    if set(got) != set(want) or diffs:
        worst = sorted(diffs.items(), key=lambda kv: -kv[1])[:5]
        print(f"dp: {what}: {len(diffs)} tensors differ, largest {json.dumps(worst)}",
              flush=True)
        raise AssertionError(f"dp: {what} not bit-equal to the run without a group: {worst}")


def _grads(torch, module, names):
    return {n: (p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in module.named_parameters() if n in names}


def _dp_run(torch, trainer, module, names, warmup, batches, card, what):
    """One step on `warmup`, then steps over `batches` (host clock to a
    synchronize each): losses, the trainable gradients of the last step,
    every parameter, ms per step, launches of the counted steps."""
    sync = torch.cuda.synchronize if DP_DEVICE == "cuda" else (lambda: None)
    trainer.train_step_on_batch(warmup)
    _reset_all_launches()
    losses, ms = [], []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        losses.append(trainer.train_step_on_batch(b)["loss"])
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = _all_launches()
    out = {"losses": torch.stack([x.float() for x in losses]),
           "grads": _grads(torch, module, names),
           "params": {n: p.detach().clone() for n, p in module.named_parameters()},
           "ms": ms, "launches": launches}
    print(f"dp: {what}: ms per step {json.dumps(ms)} ({card}); losses "
          f"{json.dumps([float(x) for x in losses])}", flush=True)
    return out


def dp_phase(torch, np, sd, tsd, card: str) -> dict:
    """Phase 33: the data-parallel path at `DP_PRESET` (ViT-B/16) in a
    one-rank group on `DP_DEVICE` (NCCL on the card) made by
    `init_multihost` from the env triple on a free port: (a) the distill
    step with `dp_equivalent=True`, (b) the teacher step, each against the
    trainer without a group on the same seed, bit for bit; (c)
    `knn_search_sharded` against `knn_search`; (d) a preempted fit. `sd` /
    `tsd`: the CLIP's and the meta-teacher's state dicts. Returns the
    launches of (a) - (d)."""
    import dataclasses
    import shutil
    import signal
    import tempfile

    from dclip_tpu_torch.cli.common import fit_with_preemption, init_multihost
    from dclip_tpu_torch.core import CLIPConfig, TeacherConfig
    from dclip_tpu_torch.core.config import TeacherTrainConfig
    from dclip_tpu_torch.ops.knn import knn_search, knn_search_sharded
    from dclip_tpu_torch.parallel.mesh import collective_device, local_mesh, make_mesh
    from dclip_tpu_torch.parallel.multihost import allgather_flags
    from dclip_tpu_torch.train import TeacherTrainer
    from dclip_tpu_torch.train.checkpoint import CheckpointManager
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    on_card = DP_DEVICE == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = CLIPConfig.from_name(DP_PRESET)
    d = cfg.projection_dim
    tcfg = TeacherConfig(embed_dim=d, num_heads=TEXT_HEADS if d % 64 == 0 else 4,
                         max_patches=TEACHER_P, max_text_tokens=cfg.text.max_length)

    def distill_config(batch_size, **changes):
        return _distill_config(batch_size, student_model=DP_PRESET, teacher_clip_model=DP_PRESET,
                               teacher=tcfg, use_pallas=True, **changes)

    def batch(b, seed, first):
        return _batch(np, b, seed=seed, first=first, clip_cfg=cfg, teacher_cfg=tcfg)

    triple = {"DCLIP_COORDINATOR": f"127.0.0.1:{_free_port()}", "DCLIP_NUM_PROCESSES": "1",
              "DCLIP_PROCESS_ID": "0"}
    saved_env = {k: os.environ.get(k) for k in triple}
    os.environ.update(triple)
    t0 = time.perf_counter()
    device = init_multihost(DP_DEVICE)
    group = make_mesh()
    print(f"dp: init_multihost: {torch.distributed.get_backend()} group of "
          f"{torch.distributed.get_world_size()} on {device} in {time.perf_counter() - t0} s"
          + (f", NCCL {torch.cuda.nccl.version()}" if on_card else ""), flush=True)
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    try:
        if not group.distributed or collective_device(group).type != device.type:
            raise AssertionError(f"dp: expected a group on {device.type}")
        if allgather_flags(True) != [True]:
            raise AssertionError("dp: the preemption guard's flag gather failed")

        # (a) The distill step: after a warm-up step on a batch of its own, 3
        # uncached steps (each batch misses and fills the caches), then the
        # same batches cache-warm (device full level).
        batches = [batch(DP_B, 10 + i, i * DP_B) for i in range(DP_STEPS)]
        warmup = batch(DP_B, 9, 100 * DP_B)
        runs = {}
        for what, mesh, eq in (("without a group", local_mesh(), False),
                               ("in the group, dp_equivalent", group, True)):
            trainer = DistillTrainer(distill_config(DP_B), sd, sd, tsd, cfg, cfg, device=device,
                                     teacher_cache=TeacherTargetCache(salt="chip-smoke-dp"),
                                     mesh=mesh, dp_equivalent=eq)
            if trainer._dp != eq:
                raise AssertionError(f"dp: the trainer {what} took the wrong path")
            runs[what] = _dp_run(torch, trainer, trainer.student,
                                 set(trainer._trainable_names()), warmup, batches + batches,
                                 card, f"distill B={DP_B} {what}")
            del trainer
            if on_card:
                torch.cuda.empty_cache()
        plain, dp = runs["without a group"], runs["in the group, dp_equivalent"]
        steps = 2 * DP_STEPS
        per_step = {k: v / steps for k, v in dp["launches"].items() if v}
        print(f"dp: distill launches per step in the group {json.dumps(per_step)}; ms per "
              f"step uncached {sum(dp['ms'][:DP_STEPS]) / DP_STEPS} vs "
              f"{sum(plain['ms'][:DP_STEPS]) / DP_STEPS} without a group, cache-warm "
              f"{sum(dp['ms'][DP_STEPS:]) / DP_STEPS} vs {sum(plain['ms'][DP_STEPS:]) / DP_STEPS}"
              f" ({card})", flush=True)
        if dp["launches"] != plain["launches"] or on_card and not (
                dp["launches"]["distill_loss_fwd"] == dp["launches"]["distill_loss_bwd"] == steps):
            raise AssertionError(f"dp: distill launches {dp['launches']} != "
                                 f"{plain['launches']}, or K11 not once a step")
        _hold_bit_equal(torch, "distill losses", {"l": dp["losses"]}, {"l": plain["losses"]})
        _hold_bit_equal(torch, "distill gradients", dp["grads"], plain["grads"])
        _hold_bit_equal(torch, "distill parameters", dp["params"], plain["params"])
        print("dp: distill losses, gradients and parameters bit-equal to the run without a "
              "group", flush=True)
        add(dp["launches"])

        # (b) The teacher step at B=32.
        tbatches = [batch(DP_TEACHER_B, 20 + i, i * DP_TEACHER_B) for i in range(DP_STEPS + 1)]
        truns = {}
        for what, mesh in (("without a group", local_mesh()), ("in the group", group)):
            config = dataclasses.replace(TeacherTrainConfig(
                batch_size=DP_TEACHER_B, learning_rate=TEACHER_LR, seed=0, clip_model=DP_PRESET,
                teacher=tcfg), use_pallas=True)
            trainer = TeacherTrainer(config, sd, cfg, tsd, device=device, mesh=mesh)
            truns[what] = _dp_run(torch, trainer, trainer.teacher,
                                  set(trainer._trainable_names()), tbatches[0], tbatches[1:],
                                  card, f"teacher B={DP_TEACHER_B} {what}")
            del trainer
        tplain, tdp = truns["without a group"], truns["in the group"]
        if tdp["launches"] != tplain["launches"]:
            raise AssertionError(f"dp: teacher launches {tdp['launches']} != "
                                 f"{tplain['launches']}")
        _hold_bit_equal(torch, "teacher losses", {"l": tdp["losses"]}, {"l": tplain["losses"]})
        _hold_bit_equal(torch, "teacher gradients", tdp["grads"], tplain["grads"])
        _hold_bit_equal(torch, "teacher parameters", tdp["params"], tplain["params"])
        print("dp: teacher losses, gradients and parameters bit-equal to the run without a "
              "group", flush=True)
        add(tdp["launches"])

        # (c) knn_search_sharded over the group's one shard, n_valid one row
        # short; the padding row is a query's copy, so it would win if searched.
        gen = torch.Generator(device=device).manual_seed(33)
        keys = torch.randn(DP_SEARCH_N, DP_SEARCH_D, device=device, generator=gen)
        keys /= keys.norm(dim=1, keepdim=True)
        queries = torch.randn(DP_SEARCH_Q, DP_SEARCH_D, device=device, generator=gen)
        queries /= queries.norm(dim=1, keepdim=True)
        keys[-1] = queries[0]
        n_valid = DP_SEARCH_N - 1
        want = knn_search(queries, keys[:n_valid], DP_SEARCH_K)
        _reset_all_launches()
        got = knn_search_sharded(queries, keys, group, DP_SEARCH_K, n_valid=n_valid)
        search_launches = _all_launches()
        times = {"sharded": [], "plain": []}  # in turns: sharded, plain, plain, sharded
        for which in ("sharded", "plain", "plain", "sharded", "sharded", "plain"):
            sync()
            t0 = time.perf_counter()
            if which == "sharded":
                knn_search_sharded(queries, keys, group, DP_SEARCH_K, n_valid=n_valid)
            else:
                knn_search(queries, keys[:n_valid], DP_SEARCH_K)
            sync()
            times[which].append(1e3 * (time.perf_counter() - t0))
        print(f"dp: knn_search_sharded Q={DP_SEARCH_Q} N={DP_SEARCH_N} (n_valid {n_valid}) "
              f"k={DP_SEARCH_K}: ms {json.dumps(times['sharded'])} vs knn_search "
              f"{json.dumps(times['plain'])} (host clock to a synchronize, after one call of "
              f"each; {card}), K12 launches of one call {search_launches['topk_streamed']}",
              flush=True)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])) \
                or (got[1] == n_valid).any() \
                or on_card and search_launches["topk_streamed"] < 1:
            raise AssertionError("dp: knn_search_sharded != knn_search over the valid rows")
        add(search_launches)
        del keys, queries, got, want

        # (d) fit_with_preemption: SIGTERM when batch DP_KILL_AT of epoch 0 is
        # drawn; the guard stops at that step boundary.
        fbatches = [batch(DP_FIT_B, 40 + i, i * DP_FIT_B) for i in range(DP_FIT_STEPS)]

        class Pipeline:
            def epoch(self, epoch):
                for i, b in enumerate(fbatches):
                    if epoch == 0 and i == DP_KILL_AT:
                        os.kill(os.getpid(), signal.SIGTERM)
                    yield b

        directory = tempfile.mkdtemp(prefix="chip_smoke_dp_")
        try:
            config = distill_config(DP_FIT_B, phase1_epochs=DP_FIT_EPOCHS)
            trainer = DistillTrainer(config, sd, sd, tsd, cfg, cfg, device=device, mesh=group)
            ckpts = CheckpointManager(directory, save_top_k=2)
            _reset_all_launches()
            preempted = fit_with_preemption(trainer, Pipeline(), None, ckpts, None)
            add(_all_launches())
            entries = [e for e in ckpts._index if e.get("tag") == "preempt"]
            print(f"dp: fit_with_preemption returned {preempted} at step {trainer.step}; "
                  f"checkpoints {[os.path.basename(e['path']) for e in ckpts._index]}",
                  flush=True)
            if not (preempted and trainer.step == DP_KILL_AT and len(entries) == 1
                    and entries[0]["step"] == DP_KILL_AT and ckpts.latest() is None):
                raise AssertionError("dp: the preempted fit did not stop at its step boundary "
                                     "with one preempt checkpoint")
            saved = torch.load(entries[0]["path"], map_location=device,
                               weights_only=True)["params"]
            del trainer
            ref = DistillTrainer(config, sd, sd, tsd, cfg, cfg, device=device, mesh=local_mesh())
            for b in fbatches[:DP_KILL_AT]:
                ref.train_step_on_batch(b)
            _hold_bit_equal(torch, "preempt checkpoint", saved,
                            {n: p.detach() for n, p in ref.student.named_parameters()})
            print(f"dp: the preempt checkpoint's parameters bit-equal to {DP_KILL_AT} "
                  "uninterrupted steps", flush=True)
            del ref
        finally:
            shutil.rmtree(directory, ignore_errors=True)
    finally:
        torch.distributed.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if on_card:
        torch.cuda.empty_cache()
    return total

def teacher_grad_phase(torch, np, sd, tsd):
    """One teacher step's gradients at full width and depth, B=8: bf16
    kernels on the card vs f32 twins on the CPU."""
    grads = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        trainer = _teacher_trainer(sd, tsd, device, GRAD_B, compute_dtype=dtype,
                                   use_pallas=True)
        t0 = time.perf_counter()
        trainer.train_step_on_batch(_batch(np, GRAD_B))
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"teacher grads: {device} {dtype} step {time.perf_counter() - t0} s", flush=True)
        grads[device] = {n: p.grad.double().cpu() for n, p in trainer.teacher.named_parameters()}
        del trainer
    d = TEXT_D
    dot = na = nb = 0.0
    cos, ratios = {}, []
    for name, a in grads["cuda"].items():
        b = grads["cpu"][name]
        dot += float((a * b).sum())
        na += float((a * a).sum())
        nb += float((b * b).sum())
        parts = {name: (a, b)}
        if name.endswith("in_proj_bias"):  # q | k | v; k's gradient is rounding noise
            parts = {f"{name}[q]": (a[:d], b[:d]), f"{name}[v]": (a[2 * d:], b[2 * d:])}
            ratios += [float(g[d:2 * d].norm() / g[:d].norm()) for g in (a, b)]
        for n, (x, y) in parts.items():
            cos[n] = float((x * y).sum() / (x.norm() * y.norm()))
    glob = dot / (na ** 0.5 * nb ** 0.5)
    worst = min(cos, key=cos.get)
    print(f"teacher grads: {len(grads['cuda'])} tensors, global cosine {glob}, min cosine "
          f"{cos[worst]} ({worst}); all {json.dumps(cos)}; k-bias max |g| / |g q-bias| "
          f"{max(ratios)}; bounds {GRAD_COS_GLOBAL} / {GRAD_COS_TENSOR}, noise ratio "
          f"{GRAD_NOISE_RATIO}", flush=True)
    if not (glob >= GRAD_COS_GLOBAL and cos[worst] >= GRAD_COS_TENSOR
            and max(ratios) < GRAD_NOISE_RATIO):
        raise AssertionError(f"teacher gradient agreement: global {glob}, min {cos[worst]} "
                             f"({worst}), k-bias noise ratio {max(ratios)}")


# -- K12 and the eval paths ------------------------------------------------------------


def _hold_topk(torch, name, got, queries, store, k, table=None):
    """K12's result against its twin's top-(k + 1) on the same inputs:
    scores within TOPK_TOL * max(1, |twin|), indices equal wherever the
    twin's neighbouring scores are further apart than that, exact ties in
    ascending row order. Returns the largest score error."""
    from dclip_tpu_torch.kernels import topk as tk

    gs, gi = got
    ws, wi = tk.topk_streamed_reference(queries, store, k + 1)
    if gs.is_cuda:
        torch.cuda.synchronize()
    k = min(k, store.shape[0])
    if gs.shape != (queries.shape[0], k) or gi.dtype != torch.int32:
        raise AssertionError(f"{name}: got {tuple(gs.shape)} {gi.dtype}")
    tol = TOPK_TOL * ws.abs().clamp_min(1.0)
    err = (gs - ws[:, :k]).abs().max().item()
    gaps = ws[:, :-1] - ws[:, 1:]
    inf = torch.full_like(ws[:, :1], float("inf"))
    apart = (torch.cat([inf, gaps], 1)[:, :k] > tol[:, :k]) & \
        (torch.cat([gaps, inf], 1)[:, :k] > tol[:, :k])
    same = torch.equal(gi[apart], wi[:, :k][apart])
    tied = gs[:, 1:] == gs[:, :-1]
    ordered = bool((gi[:, 1:][tied] > gi[:, :-1][tied]).all())
    print(f"kernel topk_streamed[{name}]: max_abs_err {err} bound {TOPK_TOL} * max(1, |twin|); "
          f"indices equal at {int(apart.sum())} of {apart.numel()} separated positions: {same}; "
          f"{int(tied.sum())} exact ties in row order: {ordered}", flush=True)
    if not ((gs - ws[:, :k]).abs() <= tol[:, :k]).all() or not same or not ordered:
        raise AssertionError(f"topk_streamed[{name}] disagrees with its twin")
    if table is not None:
        table.error("topk_streamed", err)
    return err


def topk_kernel_phase(torch, np, card: str, table: KernelTable):
    """K12 against its twin at the serving search's and the k-NN gate's
    shapes, timed beside torch.matmul + torch.topk, and its edge cases."""
    from dclip_tpu_torch.kernels import topk as tk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    for name, (nq, n, k) in (("serving search", (SEARCH_Q, SEARCH_N, SEARCH_K)),
                             ("k-NN gate", (GATE_Q, GATE_N, GATE_K))):
        d = 512
        q, s = unit(nq, d), unit(n, d)
        got = tk.topk_streamed(q, s, k)
        _hold_topk(torch, f"{name} {nq}x{n}x{d} k={k}", got, q, s, k, table)
        again = tk.topk_streamed(q, s, k)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"topk_streamed[{name}]: two runs differ")

        def library():  # f32 matmul: TF32 is off (main)
            return torch.topk(q @ s.T, k, dim=-1)

        nbytes = 4.0 * (n * d + nq * d) + 8.0 * nq * k
        # The kernel's arithmetic: three TF32 products per score (3xTF32);
        # the f32 CUDA-core bound of the same scores is printed beside it.
        bound = work(tf32_flops=3 * 2.0 * nq * n * d, nbytes=nbytes)
        f32_bound = work(f32_flops=2.0 * nq * n * d, nbytes=nbytes)
        ms, plain_ms = time_pair(torch, lambda: tk.topk_streamed(q, s, k),
                                 lambda: tk.topk_streamed_reference(q, s, k), 5)
        lib_ms = time_one(torch, library, 5)
        print(f"time topk_streamed[{name}]: kernel {ms} ms, plain {plain_ms} ms, 3xTF32 bound "
              f"{max(bound)} ms ({'operations' if bound[0] >= bound[1] else 'bytes'}; "
              f"{100.0 * max(bound) / ms}% of it), f32 CUDA-core bound {max(f32_bound)} ms "
              f"({100.0 * max(f32_bound) / ms}%), library (torch.matmul + torch.topk) {lib_ms} ms "
              f"({card})", flush=True)
        table.timed("topk_streamed", ms, plain_ms, bound, lib_ms)
        del q, s, got, again
    torch.cuda.empty_cache()

    # The CPU tests' inputs (tests/topk_cases.py): entries with bits below
    # TF32's on both sides, where one TF32 product errs by 3e-4; scores
    # 2-5x the tolerance apart.
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from topk_cases import near_ties, tf32_trap

    trap = [torch.from_numpy(a).to(dev) for a in tf32_trap(seed=14)]
    ties = [torch.from_numpy(a).to(dev) for a in near_ties(seed=15)]
    rng = np.random.RandomState(13)
    base = rng.standard_normal((3000, 64)).astype("float32")
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    dup = torch.from_numpy(np.concatenate([base, base[:100], base[:100]])).to(dev)
    queries = torch.from_numpy(base[:100]).to(dev)
    edge = [  # name, queries, store, k
        ("ragged N (not a chunk multiple)", unit(37, 512), unit(100_037, 512), 7),
        ("all-negative scores", -torch.from_numpy(np.abs(rng.standard_normal((5, 16))))
         .float().to(dev), torch.from_numpy(np.abs(rng.standard_normal((1300, 16)))).float()
         .to(dev), 5),
        ("k > N", unit(9, 32), unit(4, 32), 10),
        ("duplicated rows", queries, dup, 4),
        ("k = 64, D = 30 (padded)", unit(70, 30), unit(9_000, 30), 64),
        ("k = 150 (three rounds)", unit(70, 30), unit(9_000, 30), 150),
        ("one tie across round bounds", queries[:3], dup[:1].expand(200, -1).contiguous(), 150),
        ("TF32 trap (3xTF32 needs both cross terms)", *trap, 20),
        ("near ties 2-5x the tolerance apart", *ties, 16),
        ("ragged N, D = 8", unit(5, 8), unit(1037, 8), 7),
        ("ragged N, D = 16", unit(70, 16), unit(4099, 16), 10),
    ]
    for name, qe, se, k in edge:
        got = tk.topk_streamed(qe, se, k)
        _hold_topk(torch, name, got, qe, se, k, table)
        if name == "all-negative scores" and not (got[0] < 0).all():
            raise AssertionError("all-negative case: a non-negative score was selected")
        if name == "duplicated rows":
            r = torch.arange(100, device=dev, dtype=torch.int32)
            if not torch.equal(got[1][:, :3], torch.stack([r, r + 3000, r + 3100], 1)):
                raise AssertionError("duplicated rows: the tie did not go to the lower row")
        if name == "one tie across round bounds" and not torch.equal(
                got[1], torch.arange(k, device=dev, dtype=torch.int32).expand(3, k)):
            raise AssertionError("200 equal rows: the rounds did not rank them in row order")
        if name.startswith("near ties") and not torch.equal(
                got[1], tk.topk_streamed_reference(qe, se, k)[1]):
            raise AssertionError("near ties: the ranking differs from the twin's")
    _chunk_plans_agree(torch, tk, unit(70, 512), unit(50_000, 512))
    torch.cuda.empty_cache()


def _chunk_plans_agree(torch, tk, q, s):
    """The same search under two chunk plans (2 and 4,000 resident blocks
    assumed), in one round (k = 10) and in two (k = 100): equal bits."""
    real = tk._slots
    try:
        for k in (10, 100):
            out = []
            for slots in (2, 4000):
                tk._slots = lambda device_index, kr, slots=slots: slots
                out.append(tk.topk_streamed(q, s, k))
            same = torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
            plans = [tk.chunk_plan(q.shape[0], s.shape[0], min(k, tk.ROUND_K), slots)
                     for slots in (2, 4000)]
            print(f"kernel topk_streamed[chunk plans {plans[0]} vs {plans[1]}, k={k}]: "
                  f"bit-equal {same}", flush=True)
            if not same:
                raise AssertionError(f"topk_streamed: two chunk plans differ at k={k}")
    finally:
        tk._slots = real


def _eval_pixels(np, n, size, seed):
    """n seeded preprocessed images: uint8 noise through the CLIP
    normalization of `data.pipeline.preprocess_image`, NHWC f32."""
    from dclip_tpu_torch.ops.image_ops import CLIP_MEAN, CLIP_STD

    u8 = np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)
    return ((u8.astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN, np.float32))
            / np.asarray(CLIP_STD, np.float32))


def _route_cosine(torch, np, model, pixels, what):
    """Image features of the bf16 route (K1 / K2) against the f32 module
    route on the card, on the same weights: per-row cosine."""
    from dclip_tpu_torch.kernels import vit_block as vb
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.encoding import make_image_encoder

    f32 = CLIPModule(model.cfg, dtype=torch.float32, device="meta")
    f32.load_state_dict(model.state_dict(), strict=True, assign=True)
    feats = {}
    for dtype, m in (("bfloat16", model), ("float32", f32.eval())):
        vb.reset_launches()
        feats[dtype] = make_image_encoder(m, batch_size=len(pixels))(pixels)
        torch.cuda.synchronize()
        if (vb.LAUNCHES["image_features"] > 0) != (dtype == "bfloat16"):
            raise AssertionError(f"{what}: the {dtype} route launched {vb.LAUNCHES}")
    a, b = feats["bfloat16"], feats["float32"]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    print(f"{what}: bf16 kernels vs f32 module route on the card, {len(pixels)} images: per-row "
          f"cosine min {cos.min()} mean {cos.mean()} bound {COS_BOUND}", flush=True)
    if not cos.min() >= COS_BOUND:
        raise AssertionError(f"{what}: image cosine {cos.min()} < {COS_BOUND}")


def eval_retrieval_phase(torch, np, card: str):
    """The retrieval eval at ViT-B/16 and Karpathy-test scale on the card."""
    from dclip_tpu_torch.cli.common import load_clip
    from dclip_tpu_torch.data.tokenizer import HashTokenizer
    from dclip_tpu_torch.eval.retrieval import embed_captions
    from dclip_tpu_torch.kernels import vit_block as vb
    from dclip_tpu_torch.models.encoding import make_image_encoder
    from dclip_tpu_torch.ops import retrieval as ret

    cfg, model = load_clip("vit-b-16", "random", 0, "bfloat16", "cuda")
    # vocab_size = the preset's, so the tokenizer's EOS id is the model's.
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    pixels = _eval_pixels(np, EVAL_IMAGES, cfg.vision.image_size, 19)
    rng = np.random.RandomState(19)
    words = [f"w{i}" for i in range(400)]
    captions = [" ".join(rng.choice(words, rng.randint(8, 25)))
                for _ in range(EVAL_IMAGES * EVAL_CAPS_PER_IMAGE)]
    c2i = np.repeat(np.arange(EVAL_IMAGES), EVAL_CAPS_PER_IMAGE)

    vb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = make_image_encoder(model, batch_size=256)(list(pixels))
    img_s = time.perf_counter() - t0
    batches = -(-EVAL_IMAGES // 256)
    if vb.LAUNCHES["attention_block"] != cfg.vision.num_layers * batches \
            or vb.LAUNCHES["mlp_block"] != cfg.vision.num_layers * batches:
        raise AssertionError(f"retrieval eval: the image encode launched {vb.LAUNCHES}")
    t0 = time.perf_counter()
    cap = embed_captions(model, tok, captions, batch_size=256, packed=True)
    cap_s = time.perf_counter() - t0
    if img.shape != (EVAL_IMAGES, cfg.projection_dim) or cap.shape != (len(captions),
                                                                       cfg.projection_dim) \
            or not (np.isfinite(img).all() and np.isfinite(cap).all()):
        raise AssertionError(f"retrieval eval: embeddings {img.shape} {cap.shape} not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = ret.retrieval_metrics(cap, img, c2i, device="cuda")
    metrics = {dd: {k: float(v) for k, v in m.items()} for dd, m in metrics.items()}
    metrics_ms = 1e3 * (time.perf_counter() - t0)
    print(f"eval retrieval: ViT-B/16 bf16, {EVAL_IMAGES} images {EVAL_IMAGES / img_s} images/s "
          f"({img_s} s), {len(captions)} captions packed {len(captions) / cap_s} captions/s "
          f"({cap_s} s), retrieval_metrics {metrics_ms} ms ({card}); metrics "
          f"{json.dumps(metrics)} (random weights)", flush=True)

    # The ranks on the card against the CPU port's, on the same similarity.
    c2i_dev = torch.from_numpy(c2i).cuda()
    sim = ret.similarity_matrix(torch.from_numpy(cap).cuda(), torch.from_numpy(img).cuda())
    ranks = (ret.t2i_ranks(sim, c2i_dev).cpu(), ret.i2t_ranks(sim, c2i_dev).cpu())
    sim_host = sim.cpu()
    want = (ret.t2i_ranks(sim_host, torch.from_numpy(c2i)),
            ret.i2t_ranks(sim_host, torch.from_numpy(c2i)))
    sim_err = (ret.similarity_matrix(torch.from_numpy(cap), torch.from_numpy(img))
               - sim_host).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(ranks, want))
    print(f"eval retrieval: t2i / i2t ranks on the card equal the CPU port's on the same "
          f"similarity: {same}; similarity card vs CPU max |diff| {sim_err} (bound 1e-5)",
          flush=True)
    if not same or not sim_err <= 1e-5:
        raise AssertionError("retrieval eval: ranks or similarity differ from the CPU port")
    _route_cosine(torch, np, model, pixels[:EVAL_COS_IMAGES], "eval retrieval")
    del model, sim
    torch.cuda.empty_cache()


def eval_zero_shot_phase(torch, np, card: str):
    """Zero-shot classification at ViT-L/14, the zero-shot CLI's default
    preset, on the card: K1 / K2 at L/14 widths."""
    from dclip_tpu_torch.cli.common import load_clip
    from dclip_tpu_torch.data.tokenizer import HashTokenizer
    from dclip_tpu_torch.eval.zero_shot import IMAGENET_PROMPT, embed_classnames, evaluate_zero_shot
    from dclip_tpu_torch.kernels import vit_block as vb
    from dclip_tpu_torch.models.encoding import zero_shot_logits
    from dclip_tpu_torch.ops.retrieval import stable_topk

    t0 = time.perf_counter()
    cfg, model = load_clip("vit-l-14", "random", 0, "bfloat16", "cuda")
    print(f"eval zero-shot: ViT-L/14 random weights built in {time.perf_counter() - t0} s",
          flush=True)
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    names = [f"object kind {i}" for i in range(ZS_CLASSES)]
    text = embed_classnames(model, tok, names, IMAGENET_PROMPT)
    pixels = _eval_pixels(np, ZS_IMAGES, cfg.vision.image_size, 20)
    labels = np.random.RandomState(20).randint(0, ZS_CLASSES, ZS_IMAGES)

    def batches():
        for i in range(0, ZS_IMAGES, ZS_BATCH):
            yield pixels[i:i + ZS_BATCH], labels[i:i + ZS_BATCH]

    evaluate_zero_shot(model, text, [next(batches())], log_every=0)  # warm
    vb.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate_zero_shot(model, text, batches(), log_every=0)
    seconds = time.perf_counter() - t0
    # The module route, as the JAX eval's: no block kernel runs.
    if any(vb.LAUNCHES.values()):
        raise AssertionError(f"zero-shot eval: the module route launched {vb.LAUNCHES}")
    # The same logits (the same module calls), their top-5 on the host.
    c1 = c5 = 0
    for px, lab in batches():
        logits = zero_shot_logits(model.image_features, torch.from_numpy(px).cuda(), text)
        _, top = stable_topk(logits, 5)
        host = np.argsort(-logits.cpu().numpy(), axis=1, kind="stable")[:, :5]
        if not np.array_equal(top.cpu().numpy(), host):
            raise AssertionError("zero-shot eval: top-5 differs from the host's stable top-k")
        c1 += int((host[:, 0] == lab).sum())
        c5 += int((host == lab[:, None]).any(axis=1).sum())
    print(f"eval zero-shot: ViT-L/14 bf16 module route, {ZS_CLASSES} classes, {ZS_IMAGES} "
          f"images in batches of {ZS_BATCH}: {ZS_IMAGES / seconds} images/s ({seconds} s); "
          f"top-1 {res['top1']} "
          f"top-5 {res['top5']} (random weights; host replay {c1}, {c5}) ({card})", flush=True)
    if (res["top1"], res["top5"], res["total"]) != (c1 / ZS_IMAGES, c5 / ZS_IMAGES, ZS_IMAGES):
        raise AssertionError(f"zero-shot eval: {res} != the host's top-k ({c1}, {c5})")
    _route_cosine(torch, np, model, pixels[:ZS_COS_IMAGES], "eval zero-shot")
    del model, text
    torch.cuda.empty_cache()


# -- the serving deployment path: int8, the exported artifact, the student ------

SERVE_FLAGS = ["--model_preset", "vit-b-16", "--clip_weights", "random", "--seed", "0",
               "--tokenizer_dir", "hash", "--device", "cuda"]
DEPLOY_TEXTS = ["a photo of a dog", "a red car", "two cats on a sofa", "a mountain lake",
                "a bowl of soup"]
EXPORT_BUCKETS = (1, 64)
INT8_COS, EXPORT_COS_F32, EXPORT_COS_INT8 = 0.99, 0.999, 0.99


def _unit_cosines(np, a, b, what, bound):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    norms = np.linalg.norm(a, axis=-1)
    if not (np.isfinite(a).all() and np.allclose(norms, 1.0, atol=1e-3)):
        raise AssertionError(f"{what}: embeddings not finite and unit-norm: norms {norms}")
    cos = (a * b).sum(-1) / (norms * np.linalg.norm(b, axis=-1))
    print(f"{what}: per-row cosine min {cos.min()} mean {cos.mean()} bound {bound}", flush=True)
    if not cos.min() >= bound:
        raise AssertionError(f"{what}: cosine {cos.min()} < {bound}")


def _f32_references(torch, np, model, tok, texts, u8):
    """The f32 module route's text and image features on the card."""
    from dclip_tpu_torch.ops.image_ops import normalize

    ids, mask = tok.encode_batch(texts, max_length=model.cfg.text.max_length)
    with torch.inference_mode():
        t = model.get_text_features(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())
        i = model.image_features(normalize(torch.from_numpy(u8).cuda().float() / 255.0))
    return t.float().cpu().numpy(), i.float().cpu().numpy()


def int8_phase(torch, np, cli_serve, card: str, bf16_rows):
    """Phase 25: `ClipService(quantize="int8")` through the CLI's
    `build_service` at ViT-B/16 (buckets 1,4,16,64): warmup, the selftest,
    no K1 / K2 launch, both towers unit-norm and within cosine 0.99 of the
    f32 module route on the same weights, `--bench` lines at concurrency 1
    and 32 beside phase 5's bf16 ones, and the weights' bytes."""
    from dclip_tpu_torch.cli.common import load_clip
    from dclip_tpu_torch.kernels import vit_block as vb
    from dclip_tpu_torch.serve import quant

    args = cli_serve.parse_args(SERVE_FLAGS + ["--buckets", "1,4,16,64", "--index_dim", "512",
                                               "--quantize", "int8"])
    t0 = time.perf_counter()
    service = cli_serve.build_service(args)
    print(f"int8: service built in {time.perf_counter() - t0} s", flush=True)
    if service.model is not None or service.image_route != "int8":
        raise AssertionError("int8: the service kept a float model")
    cfg = service.cfg
    u8 = np.random.RandomState(25).randint(0, 256, (8,) + (cfg.vision.image_size,) * 2 + (3,),
                                           np.uint8)
    vb.reset_launches()
    print("int8: warmup", json.dumps(service.warmup()), f"({card})", flush=True)
    if cli_serve.selftest(service, args) != 0:
        raise AssertionError("int8: serve --selftest failed")
    img, txt = service.encode_images(list(u8)), service.encode_texts(DEPLOY_TEXTS)
    torch.cuda.synchronize()
    if set(vb.LAUNCHES.values()) != {0}:
        raise AssertionError(f"int8: block kernels launched {vb.LAUNCHES}")
    print(f"int8: block kernel launches {json.dumps(vb.LAUNCHES)} (none expected)", flush=True)
    _, f32 = load_clip("vit-b-16", "random", 0, "float32", "cuda")
    want_t, want_i = _f32_references(torch, np, f32, service.tokenizer, DEPLOY_TEXTS, u8)
    _unit_cosines(np, txt, want_t, "int8: text vs f32 module route on the card", INT8_COS)
    _unit_cosines(np, img, want_i, "int8: image vs f32 module route on the card", INT8_COS)
    rows = cli_serve.bench(service, args, concurrencies=(1, 32))
    for row in rows:
        bf16 = next(r for r in bf16_rows if (r["modality"], r["concurrency"])
                    == (row["modality"], row["concurrency"]))
        print(f"int8 vs bf16: {row['modality']} concurrency {row['concurrency']}: p50 "
              f"{row['p50_ms']} vs {bf16['p50_ms']} ms, {row['requests_per_sec']} vs "
              f"{bf16['requests_per_sec']} req/s ({card})", flush=True)
    n_float = sum(v.numel() for k, v in f32.state_dict().items())
    print(f"int8: weights {quant.tree_bytes(service.params)} bytes on the card against "
          f"{2 * n_float} in bf16 and {4 * n_float} in f32", flush=True)
    return service, f32


def export_phase(torch, np, cli_serve, card: str, int8_service, f32):
    """Phase 26: `--export_dir` for buckets 1 and 64 on platform cuda, with
    f32 weights and int8, into a temporary directory: export time, each
    file's bytes, the int8 params.npz under 0.45 of the f32 one, each
    program under half its params.npz; `load_exported(device="cuda")`
    texts and images against the live service of the same route and
    weights (f32 module route: cosine 0.999; int8: 0.99); ms per batch of
    the programs."""
    import tempfile

    from dclip_tpu_torch.ops.image_ops import normalize
    from dclip_tpu_torch.serve import ClipService
    from dclip_tpu_torch.serve.export import load_exported

    cfg, tok = int8_service.cfg, int8_service.tokenizer
    u8 = np.random.RandomState(26).randint(0, 256, (5,) + (cfg.vision.image_size,) * 2 + (3,),
                                           np.uint8)
    px = normalize(torch.from_numpy(u8).float() / 255.0).numpy()
    ids, mask = tok.encode_batch(DEPLOY_TEXTS, max_length=cfg.text.max_length)
    live = {None: ClipService(f32, cfg, tokenizer=tok, buckets=EXPORT_BUCKETS, device="cuda"),
            "int8": int8_service}
    sizes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for quantize, bound in ((None, EXPORT_COS_F32), ("int8", EXPORT_COS_INT8)):
            out = os.path.join(tmp, str(quantize))
            argv = SERVE_FLAGS + ["--buckets", ",".join(map(str, EXPORT_BUCKETS)),
                                  "--export_dir", out, "--export_platforms", "cuda"]
            t0 = time.perf_counter()
            if cli_serve.main(argv + (["--quantize", quantize] if quantize else [])) != 0:
                raise AssertionError(f"export {quantize}: --export_dir failed")
            seconds = time.perf_counter() - t0
            sizes[quantize] = {n: os.path.getsize(os.path.join(out, n)) for n in os.listdir(out)}
            print(f"export {quantize or 'f32'}: {seconds} s (weights built, traced, written), "
                  f"files {json.dumps(sizes[quantize])}", flush=True)
            params = sizes[quantize]["params.npz"]
            big = {n: b for n, b in sizes[quantize].items() if n.endswith(".pt2") and b >= params / 2}
            if big:
                raise AssertionError(f"export {quantize}: programs {big} >= params.npz / 2")
            loaded = load_exported(out, device="cuda")
            what = f"export {quantize or 'f32'}: loaded on cuda vs the live service"
            _unit_cosines(np, loaded.encode_texts_ids(ids, mask),
                          live[quantize].encode_texts(DEPLOY_TEXTS), what + " (text)", bound)
            _unit_cosines(np, loaded.encode_images(px), live[quantize].encode_images(list(u8)),
                          what + " (image)", bound)
            for (modality, b), fn in sorted(loaded._fns.items()):
                if modality == "text":
                    args = (torch.zeros((b, cfg.text.max_length), dtype=torch.int32,
                                        device="cuda"),) * 2
                else:
                    args = (torch.zeros((b,) + (cfg.vision.image_size,) * 2 + (3,),
                                        device="cuda"),)
                with torch.inference_mode():
                    ms = time_one(torch, lambda: fn(*args), 5)
                print(f"export {quantize or 'f32'}: program {modality} b={b}: {ms} ms a batch "
                      f"({card})", flush=True)
            del loaded
    ratio = sizes["int8"]["params.npz"] / sizes[None]["params.npz"]
    print(f"export: int8 params.npz / f32 params.npz = {ratio} (bound 0.45)", flush=True)
    if not ratio < 0.45:
        raise AssertionError(f"export: int8 params.npz is {ratio} of the f32 one")
    del live
    torch.cuda.empty_cache()


def student_phase(torch, np, cli_serve, card: str):
    """Phase 27: a perturbed student (the text projection plus seeded
    noise) saved with the port's `CheckpointManager` and served through
    `--student_checkpoint`: its text embeddings differ from the base
    service's and equal a service built on the same weights directly;
    `cli.export_hf` writes its HF snapshot, which the port's reader loads
    back bit-equal to the state dict, `logit_scale` 0-d."""
    import tempfile

    from dclip_tpu_torch.cli import export_hf
    from dclip_tpu_torch.cli.common import load_clip
    from dclip_tpu_torch.models.weights import load_state_dict_file
    from dclip_tpu_torch.serve import ClipService
    from dclip_tpu_torch.train.checkpoint import CheckpointManager

    # The served model's build: compute dtype "auto" (bf16 on the card).
    cfg, model = load_clip("vit-b-16", "random", 0, "auto", "cuda")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    w = sd["text_projection.weight"]
    sd["text_projection.weight"] = w + torch.from_numpy(
        np.random.RandomState(27).standard_normal(tuple(w.shape)).astype(np.float32) * 0.02)
    flags = SERVE_FLAGS + ["--buckets", "1,4"]
    with tempfile.TemporaryDirectory() as tmp:
        CheckpointManager(os.path.join(tmp, "ckpt")).save({"params": sd, "step": 1}, step=1,
                                                          epoch=0)
        served_svc = cli_serve.build_service(cli_serve.parse_args(
            flags + ["--student_checkpoint", os.path.join(tmp, "ckpt")]))
        served = served_svc.encode_texts(DEPLOY_TEXTS)
        tok = served_svc.tokenizer
        del served_svc
        base = cli_serve.build_service(cli_serve.parse_args(flags)).encode_texts(DEPLOY_TEXTS)
        model.load_state_dict(sd)
        direct = ClipService(model, cfg, tokenizer=tok, buckets=(1, 4),
                             device="cuda").encode_texts(DEPLOY_TEXTS)
        moved = float(np.abs(served - base).max())
        print(f"student: --student_checkpoint text embeddings moved by {moved} (max abs) from "
              f"the base service's; equal to a service given the weights directly: "
              f"{np.array_equal(served, direct)}", flush=True)
        if not moved > 1e-3 or not np.array_equal(served, direct):
            raise AssertionError("student: --student_checkpoint not applied as given")
        snap = os.path.join(tmp, "snapshot")
        t0 = time.perf_counter()
        export_hf.main(["--model_preset", "vit-b-16", "--checkpoint", os.path.join(tmp, "ckpt"),
                        "--out", snap])
        seconds = time.perf_counter() - t0
        back = load_state_dict_file(snap)
        files = {n: os.path.getsize(os.path.join(snap, n)) for n in sorted(os.listdir(snap))}
        if set(back) != set(sd) or back["logit_scale"].shape != () or not all(
                torch.equal(back[k], v) for k, v in sd.items()):
            raise AssertionError("student: the HF snapshot does not hold the checkpoint's weights")
        print(f"student: export_hf wrote {json.dumps(files)} in {seconds} s; reloaded "
              f"bit-equal, logit_scale shape {tuple(back['logit_scale'].shape)}", flush=True)
    torch.cuda.empty_cache()


# -- the region-proposal slice: YOLOv8x, region tokens, the projection gate ------

# YOLOv8x at 640 (`DetectorConfig.v8x()`, the reference's proposal source):
# B=1 is what precache runs per image, 16 and 32 the batched forward.
DET_BATCHES, DET_ITERS = (1, 16, 32), 3
# The card's f32 logits vs the same module on the CPU, one image: f32 sums
# in other orders over ~100 convolutions with BatchNorm between, within
# 1e-4 of the largest |cpu| logit of each output (a TF32 forward's error is
# printed beside it). At random weights the logits are small, so the error
# is taken relative to their scale, not to 1.
DET_LOGIT_TOL = 1e-4
# Decode on the card vs on the CPU from the same logits: coordinates up to
# ~1,000 px, softmax sums of 16 bins.
DET_BOX_TOL, DET_SCORE_TOL = 1e-3, 1e-6
# Region tokens: the top 8 detections of each of 32 images, the default
# threshold, 8 thresholds in the sweep (`evaluate_threshold`'s default,
# 0.60 to 0.95). The store: 100,000 seeded unit keys, the first of them
# planted, one for each valid region, at a cosine from REGION_PLANT_COS to
# its f32-route embedding. A random ViT puts a batch's regions close
# together, so a key near one region is near its neighbours too: the
# cosines rise with the region's rank along the batch's first principal
# axis, so that neighbours have neighbouring cosines and the thresholds
# split hits from misses.
REGION_P, REGION_STORE_N = 8, 100_000
REGION_THRESHOLD = 0.85
REGION_SWEEP = tuple(0.60 + 0.05 * i for i in range(8))
REGION_PLANT_COS = (0.60, 0.99)
# The sweep has to move: from its first threshold to its last, at least
# this share of the valid regions turns from a hit into a miss.
REGION_SWEEP_MOVE = 0.25
# A source may differ from the reference's only where the top-1 similarity
# lies within this much of the threshold.
REGION_NEAR = 1e-3
# The embeddings are compared centred on their route's batch mean, where
# the regions lie apart; a region's embedding put in the place of another
# image's nearest region has to fail that bound for at least this share of
# the regions, or the comparison could not see rows mixed up across the
# batch. (Crops of one image overlap and may lie closer.)
REGION_SWAP_SHARE = 0.9


def _conv_flops(torch, model, image_size: int) -> float:
    """f32 FLOPs of one image through `model`'s convolutions (2 per
    multiply-add, plus the bias adds), from a forward on the meta device."""
    flops = [0.0]

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        flops[0] += 2.0 * out.numel() * (mod.in_channels // mod.groups) * k
        flops[0] += out.numel() if mod.bias is not None else 0.0

    from dclip_tpu_torch.models.detector import YOLO

    meta = YOLO(model.cfg, device="meta")
    handles = [m.register_forward_hook(hook) for m in meta.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        meta(torch.empty((1, image_size, image_size, 3), device="meta"))
    for h in handles:
        h.remove()
    return flops[0]


def _scene_images(torch, n: int, size: int, seed: int):
    """[n, size, size, 3] in [0, 1] on the card: a smooth colour field (a
    seeded 16 x 16 grid, bicubic upsampled) with 0.2 of uniform noise on
    top, so that crops of other places and images differ in colour, as
    crops of photographs do. Crops of pure noise all look alike to a random
    ViT; so do crops of a 6 x 6 field, whose regions are too close together
    for phase 29 to see rows mixed up across the batch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grid = torch.rand((n, 3, 16, 16), generator=gen, device="cuda")
    field = torch.nn.functional.interpolate(grid, size=(size, size), mode="bicubic",
                                            align_corners=False).clamp(0, 1)
    noise = torch.rand((n, size, size, 3), generator=gen, device="cuda")
    return (0.8 * field.permute(0, 2, 3, 1) + 0.2 * noise).contiguous()


def _detector_profile(torch, detector, images, card: str):
    """One B=1 forward under torch.profiler (kernel count, device busy
    share of the wall time, the top kernels), and the network timed with
    `cudnn.benchmark` on (measurement only; the flag is restored)."""
    from torch.profiler import ProfilerActivity, profile

    x = images[:1]
    detector.logits(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detector.logits(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    device_ms = sum(ms for _, _, ms in rows)
    print(f"detector: profiled B=1 forward: wall {wall_ms} ms, {sum(n for _, n, _ in rows)} "
          f"device kernels, device {device_ms} ms, busy {100.0 * device_ms / wall_ms}% "
          f"({card})", flush=True)
    for key, n, ms in rows[:6]:
        print(f"detector: {ms:9.3f} ms x{n:<4d} {key[:100]}", flush=True)
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        bench_ms = {b: time_one(torch, lambda b=b: detector.logits(images[:b]), DET_ITERS)
                    for b in (1, 16)}
    finally:
        torch.backends.cudnn.benchmark = prev
    print(f"detector: network with cudnn.benchmark on (measurement only): "
          f"{json.dumps(bench_ms)} ms at B = 1, 16 ({card})", flush=True)


def _max_rel_err(outs, refs) -> float:
    """max over every scale's box and class logits of max |got - ref| / max |ref|."""
    return max((g.float().cpu() - r).abs().max().item() / r.abs().max().item()
               for pair, ref in zip(outs, refs) for g, r in zip(pair, ref))


def detector_phase(torch, np, card: str):
    """Phase 28: YOLOv8x at 640 px, random weights from seed 0, f32 on the
    card: `Detector.detect` at B = 1, 16, 32 (the network and decode + NMS
    apart, on CUDA events and the host clock; images/s, peak memory) beside
    the f32 bound from the module's own conv shapes and a TF32 forward
    (measurement only); the f32 logits against the same module on the CPU
    on one image; decode against the CPU's on the same logits and
    postprocess on identical decoded candidates, bit-equal. No hand-written
    kernel runs on this path (the JAX detector is XLA). Returns the
    detector's images and detections at B=32 for phase 29."""
    from dclip_tpu_torch.models import detector as det

    cfg = det.DetectorConfig.v8x()
    sd = det.random_detector_state_dict(cfg, seed=0)
    t0 = time.perf_counter()
    detector = det.Detector(cfg, sd, "cuda")
    print(f"detector: YOLOv8x built in {time.perf_counter() - t0} s, "
          f"{sum(p.numel() for p in detector.model.parameters())} parameters", flush=True)
    gflops = _conv_flops(torch, detector.model, cfg.image_size) / 1e9
    print(f"detector: {gflops} GFLOPs an image at {cfg.image_size} px from the port's conv "
          f"shapes (ultralytics' table: 257.8)", flush=True)
    if abs(gflops - 257.8) > 0.5:
        raise AssertionError(f"detector FLOP count {gflops} is not YOLOv8x's 257.8")
    images = _scene_images(torch, max(DET_BATCHES), cfg.image_size, seed=0)
    torch.backends.cudnn.allow_tf32 = True  # the process default: the detector pins f32 itself
    _reset_all_launches()
    out = None
    for b in DET_BATCHES:
        x = images[:b]

        def tf32_forward():
            with torch.inference_mode():
                return detector.model(x)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        detector.detect(x)
        torch.cuda.synchronize()
        host, host_net = [], []
        for _ in range(DET_ITERS):
            t0 = time.perf_counter()
            outs = detector.logits(x)
            torch.cuda.synchronize()
            host_net.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            out = detector.detect(x)
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        net_ms = time_one(torch, lambda: detector.logits(x), DET_ITERS)
        post_ms = time_one(torch, lambda: det.postprocess(cfg, *det.decode_predictions(cfg, outs)),
                           DET_ITERS)
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("the detector did not restore the process's TF32 flag")
        tf32_ms = time_one(torch, tf32_forward, DET_ITERS)
        bound_ms = 1e3 * b * gflops * 1e9 / PEAKS.f32
        detect_ms = sum(host) / len(host)
        print(f"detector: B={b}: network {net_ms} ms (CUDA events; host {host_net}), decode + NMS "
              f"{post_ms} ms, detect end to end {host} ms host, {1e3 * b / detect_ms} images/s; "
              f"f32 bound {bound_ms} ms ({b * gflops} GFLOP / 67 TFLOP/s, "
              f"{bound_ms / net_ms} of it); TF32 forward {tf32_ms} ms; peak {peak} GiB "
              f"({card})", flush=True)
    launches = {k: v for k, v in _all_launches().items() if v}
    print(f"detector: hand-written kernel launches {json.dumps(launches)} (expected none)",
          flush=True)
    _detector_profile(torch, detector, images, card)
    if launches:
        raise AssertionError(f"the detector path launched {launches}")
    picks = out.mask.sum(1)
    print(f"detector: picks per image at B=32: min {picks.min().item()} mean "
          f"{picks.mean().item()} of {cfg.max_detections}", flush=True)

    # The f32 logits against the CPU's, one image; the TF32 forward beside.
    x1 = images[:1]
    t0 = time.perf_counter()
    ref = det.Detector(cfg, sd, "cpu").logits(x1.cpu())
    cpu_s = time.perf_counter() - t0
    err = _max_rel_err(detector.logits(x1), ref)
    with torch.inference_mode():
        err_tf32 = _max_rel_err(detector.model(x1), ref)
    scale = [(bx.abs().max().item(), c.abs().max().item()) for bx, c in ref]
    print(f"detector: f32 logits card vs CPU (one image, CPU forward {cpu_s} s): max err "
          f"{err} of the largest |cpu| logit (max |box|, |cls| per scale {scale}), bound "
          f"{DET_LOGIT_TOL}; a TF32 forward: {err_tf32}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    if not err <= DET_LOGIT_TOL:
        raise AssertionError(f"detector f32 logits err {err} > {DET_LOGIT_TOL}")

    # Decode: card vs CPU on the same logits; postprocess on identical
    # decoded candidates, bit-equal.
    outs = detector.logits(images[:16])
    with torch.inference_mode():
        cand = det.decode_predictions(cfg, outs)
        cpu_cand = det.decode_predictions(cfg, [(bx.cpu(), c.cpu()) for bx, c in outs])
        box_err = (cand[0].cpu() - cpu_cand[0]).abs().max().item()
        score_err = (cand[1].cpu() - cpu_cand[1]).abs().max().item()
        got = det.postprocess(cfg, *cand)
        want = det.postprocess(cfg, *(t.cpu() for t in cand))
    equal = {name: torch.equal(g.cpu(), w) for name, g, w in zip(got._fields, got, want)}
    print(f"detector: decode card vs CPU on the same logits: boxes {box_err} px (bound "
          f"{DET_BOX_TOL}), scores {score_err} (bound {DET_SCORE_TOL}); postprocess on identical "
          f"candidates (B=16, {int(want.mask.sum())} picks) equal: {json.dumps(equal)}",
          flush=True)
    if not (box_err <= DET_BOX_TOL and score_err <= DET_SCORE_TOL and all(equal.values())):
        raise AssertionError("detector decode / postprocess differ from the CPU's")
    return images, out


def _tokenizer(model, store, pparams):
    from dclip_tpu_torch.models.region_tokenizer import RegionTokenizer

    return RegionTokenizer(model, store=store, projection_params=pparams,
                           similarity_threshold=REGION_THRESHOLD,
                           patch_size=model.cfg.vision.image_size)


def _planted_keys(torch, emb, n: int, seed: int):
    """n seeded unit keys [n, D] (numpy f32) on emb's device; key i < len(emb)
    is planted at cosine c_i to the unit row emb[i]: c_i e_i + (1 - c_i^2)^0.5
    u_i with u_i a seeded unit vector orthogonal to e_i, and c_i rising
    over REGION_PLANT_COS with the row's rank along the first principal
    axis of the centred rows. Returns (keys, c)."""
    gen = torch.Generator(device=emb.device).manual_seed(seed)
    keys = torch.randn((n, emb.shape[1]), generator=gen, device=emb.device)
    keys = keys / keys.norm(dim=-1, keepdim=True)
    m = emb.shape[0]
    centred = emb - emb.mean(0)
    axis = torch.linalg.svd(centred, full_matrices=False)[2][0]
    rank = (centred @ axis).argsort().argsort().float() / max(m - 1, 1)
    lo, hi = REGION_PLANT_COS
    c = lo + (hi - lo) * rank
    u = keys[:m] - (keys[:m] * emb).sum(-1, keepdim=True) * emb
    u = u / u.norm(dim=-1, keepdim=True)
    keys[:m] = c[:, None] * emb + (1 - c * c).sqrt()[:, None] * u
    return keys.cpu().numpy(), c


def _centred(x):
    x = x - x.mean(0)
    return x / x.norm(dim=-1, keepdim=True)


def region_token_phase(torch, np, images, detections, card: str, table: KernelTable):
    """Phase 29: the top 8 YOLOv8x boxes of each of 32 images through
    `RegionTokenizer` at ViT-B/16 (random weights from seed 0, bf16: K1 / K2)
    with a seeded projection head, over a store of 100,000 seeded unit keys,
    one planted for each valid region (`_planted_keys`): exact K1 / K2 / K12
    launches for `batch_tokenize` and for an 8-threshold
    `evaluate_threshold` (one region encode, 8 K12), ms of each; K12 at the
    gate's shape against its plain twin on the CPU, on the same queries and
    keys; the sweep against the plain reference's top-1 similarities at
    every threshold (the hit shares equal but for rows within 1e-3 of the
    threshold), and moving; the region embeddings against the f32 module
    route on the card, raw and centred on the batch mean (cosine >= 0.99;
    another image's region in a region's place has to fail the centred
    bound); the sources at
    the default threshold against the reference's and the f32 route's, no
    source 2; at a threshold above 1 every region takes the projection head
    on both routes (centred cosine >= 0.99). Returns the K1 / K2 and K12
    launches of both timed calls."""
    from dclip_tpu_torch.cli.common import load_clip
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.projections import init_image_projection
    from dclip_tpu_torch.ops import knn

    cfg, model = load_clip("vit-b-16", "random", 0, "bfloat16", "cuda")
    f32 = CLIPModule(cfg, dtype=torch.float32, device="meta")
    f32.load_state_dict(model.state_dict(), strict=True, assign=True)
    f32.eval()
    boxes = detections.boxes[:, :REGION_P].contiguous()
    mask = detections.mask[:, :REGION_P].contiguous()
    b = boxes.shape[0]
    valid = mask.reshape(-1) > 0
    nv = int(valid.sum())
    print(f"regions: {b} images x {REGION_P} boxes, {nv} valid", flush=True)
    _, pparams = init_image_projection(seed=0, clip_dim=cfg.projection_dim)
    raw32 = _tokenizer(f32, None, None)._queries(images, boxes, mask)[0]
    keys, planted = _planted_keys(torch, raw32[valid], REGION_STORE_N, seed=3)
    store = EmbeddingStore.from_arrays(keys)
    tok = _tokenizer(model, store, pparams)
    tok32 = _tokenizer(f32, store, pparams)
    layers = cfg.vision.num_layers
    encode = {"layernorm": 2 * layers, "gemm_bias_act_residual": 4 * layers,
              "attention": layers, "attention_block": layers, "mlp_block": layers,
              "encoder_forward": 1, "image_features": 1}
    launches = {}
    calls = (("batch_tokenize", lambda: tok.batch_tokenize(images, boxes, mask), 1),
             ("evaluate_threshold",
              lambda: tok.evaluate_threshold(images, boxes, mask, REGION_SWEEP), len(REGION_SWEEP)))
    for what, call, k12 in calls:
        call()
        torch.cuda.synchronize()
        host = []
        for _ in range(3):
            _reset_all_launches()
            t0 = time.perf_counter()
            result = call()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        got = {k: v for k, v in _all_launches().items() if v}
        expected = dict(encode, topk_streamed=k12)
        print(f"regions: {what}: {host} ms host ({b * REGION_P} crops, {REGION_STORE_N} keys), "
              f"launches {json.dumps(got)} ({card})", flush=True)
        if got != expected:
            raise AssertionError(f"{what}: launches {got} != {expected}")
        launches[what] = got
    sweep = result

    # K12 at the gate's shape against its plain twin on the CPU.
    raw16 = tok._queries(images, boxes, mask)[0]
    keys_cpu = torch.from_numpy(keys)
    got = knn.knn_search(raw16, tok._store_keys, tok.top_k)
    _hold_topk(torch, f"region gate {raw16.shape[0]}x{REGION_STORE_N}x{cfg.projection_dim} "
               f"k={tok.top_k}", tuple(t.cpu() for t in got), raw16.cpu(), keys_cpu,
               tok.top_k, table)

    # The sweep against the plain reference's top-1 similarities.
    top1 = knn.knn_search(raw16.cpu(), keys_cpu, 1)[0][:, 0][valid.cpu()]
    top1_32 = knn.knn_search(raw32.cpu(), keys_cpu, 1)[0][:, 0][valid.cpu()]
    if not (top1_32 >= planted.cpu() - TOPK_TOL).all():
        raise AssertionError("a region's planted key is not at its set cosine")
    print(f"regions: planted cosines {REGION_PLANT_COS[0]} to {REGION_PLANT_COS[1]}; reference "
          f"top-1 of the bf16 queries min {top1.min().item()} mean {top1.mean().item()} max "
          f"{top1.max().item()}", flush=True)
    print("regions: sweep", json.dumps(sweep), flush=True)
    fractions = []
    for th in REGION_SWEEP:
        row = sweep[round(float(th), 2)]
        hits, near = top1 >= th, (top1 - th).abs() <= REGION_NEAR
        lo, hi = (hits & ~near).sum().item() / nv, (hits | near).sum().item() / nv
        want_sim = top1[hits].mean().item() if hits.any() else 0.0
        print(f"regions: sweep at {th}: knn_fraction {row['knn_fraction']}, reference "
              f"{hits.sum().item() / nv} ({int(near.sum())} rows within {REGION_NEAR}); mean "
              f"similarity {row['mean_similarity']}, reference {want_sim}", flush=True)
        if not lo <= row["knn_fraction"] <= hi or (
                not near.any() and abs(row["mean_similarity"] - want_sim) > TOPK_TOL):
            raise AssertionError(f"the sweep at {th} differs from the plain reference")
        fractions.append(row["knn_fraction"])
    moved = fractions[0] - fractions[-1]
    if any(a < c for a, c in zip(fractions, fractions[1:])) or moved < REGION_SWEEP_MOVE:
        raise AssertionError(f"the sweep does not move: knn fractions {fractions} (at least "
                             f"{REGION_SWEEP_MOVE} of the regions must turn into misses)")

    # The bf16 route against the f32 module route on the card, raw and
    # centred on the batch mean.
    q16, q32 = raw16[valid].float(), raw32[valid]
    cos = (q16 * q32).sum(-1)
    c16, c32 = _centred(q16), _centred(q32)
    ccos = (c16 * c32).sum(-1)
    image = torch.arange(b, device=valid.device).repeat_interleave(REGION_P)[valid]
    others = c32 @ c32.T
    others.fill_diagonal_(-2.0)
    swap = (others.max(1).values < COS_BOUND).float().mean().item()
    others[image[:, None] == image[None, :]] = -2.0
    swap_images = (others.max(1).values < COS_BOUND).float().mean().item()
    print(f"regions: bf16 kernels vs f32 module route, {nv} regions: cosine min "
          f"{cos.min().item()} mean {cos.mean().item()}; centred on the batch mean min "
          f"{ccos.min().item()} mean {ccos.mean().item()}; bound {COS_BOUND}. The nearest "
          f"region of another image in a region's place fails the centred bound for "
          f"{swap_images} of the regions, the nearest of any image for {swap} (raw cosine to "
          f"the nearest other: mean "
          f"{(q32 @ q32.T).fill_diagonal_(-2.0).max(1).values.mean().item()})", flush=True)
    if not (cos.min().item() >= COS_BOUND and ccos.min().item() >= COS_BOUND):
        raise AssertionError(f"region embeddings cosine {cos.min().item()} / centred "
                             f"{ccos.min().item()} < {COS_BOUND}")
    if swap_images < REGION_SWAP_SHARE:
        raise AssertionError(f"the regions lie too close together for the centred cosine to "
                             f"see rows mixed up ({swap_images} < {REGION_SWAP_SHARE})")

    # The sources at the default threshold: the reference's and the f32 route's.
    src = tok.batch_tokenize(images, boxes, mask).source.reshape(-1)[valid].cpu()
    src32 = tok32.batch_tokenize(images, boxes, mask).source.reshape(-1)[valid].cpu()
    want = torch.where(top1 >= REGION_THRESHOLD, knn.SOURCE_KNN, knn.SOURCE_PROJECTION)
    near = (top1 - REGION_THRESHOLD).abs() <= REGION_NEAR
    lo, hi = torch.minimum(top1, top1_32), torch.maximum(top1, top1_32)
    between = (lo - REGION_NEAR <= REGION_THRESHOLD) & (REGION_THRESHOLD <= hi + REGION_NEAR)
    counts = {int(v): int((src == v).sum()) for v in (0, 1, 2)}
    print(f"regions: sources at {REGION_THRESHOLD} {counts} (0 knn, 1 projection, 2 clip); "
          f"{int((src != want).sum())} differ from the reference's ({int(near.sum())} rows within "
          f"{REGION_NEAR} of the threshold), {int((src != src32).sum())} from the f32 route's "
          f"({int(between.sum())} rows with the threshold between the routes' top-1)", flush=True)
    if counts[2] or ((src != want) & ~near).any() or ((src != src32) & ~between).any() \
            or not (counts[0] and counts[1]):
        raise AssertionError(f"region sources {counts}: a clip source, a difference away from "
                             "the threshold, or no hit or no miss")
    # Nothing reaches a threshold above 1: every valid region takes the
    # projection head, on both routes.
    ours = tok.batch_tokenize(images, boxes, mask, threshold=1.01)
    theirs = tok32.batch_tokenize(images, boxes, mask, threshold=1.01)
    e16 = _centred(ours.embeddings.reshape(-1, cfg.projection_dim)[valid].float())
    e32 = _centred(theirs.embeddings.reshape(-1, cfg.projection_dim)[valid])
    proj_cos = (e16 * e32).sum(-1)
    print(f"regions: at threshold 1.01 every region takes the projection: "
          f"{bool((ours.source.reshape(-1)[valid] == knn.SOURCE_PROJECTION).all())}; centred "
          f"cosine bf16 vs f32 route min {proj_cos.min().item()} bound {COS_BOUND}", flush=True)
    if not ((ours.source.reshape(-1)[valid] == knn.SOURCE_PROJECTION).all()
            and proj_cos.min().item() >= COS_BOUND):
        raise AssertionError("the projection branch: a miss did not take source 1, or its "
                             f"centred cosine {proj_cos.min().item()} < {COS_BOUND}")
    return launches


# -- the ViT-L/14 slice: the doctor, L/14 distillation, the files route ---------------


def doctor_phase(card: str) -> dict:
    """Phase 30: `cli.doctor.collect()` on this machine; returns its JPEG
    decoder entry."""
    from dclip_tpu_torch.cli import doctor

    info = doctor.collect()
    print("doctor:", json.dumps(info), flush=True)
    if not info["ok"] or info["devices"]["platform"] != "gpu" \
            or info["kernels"]["self_check"].get("max_abs_err") != 0.0:
        raise AssertionError(f"doctor: {info}")
    return info["native_runtime"]["jpeg_decoder"]


def _l14_teacher_config():
    from dclip_tpu_torch.core import TeacherConfig

    return TeacherConfig(embed_dim=L14_XATTN_D, num_heads=L14_XATTN_HEADS,
                         max_patches=TEACHER_P, max_text_tokens=TEXT_S)


def _l14_distill_config(batch_size, **changes):
    import dataclasses

    return dataclasses.replace(_distill_config(batch_size, **changes), student_model="vit-l-14",
                               teacher_clip_model="vit-l-14", teacher=_l14_teacher_config())


def _hold_remat(torch, what, params, steps):
    """Remat's parameters against those without it: bit-equal (the kernels
    use no atomics and the recompute runs the same kernels on the same
    inputs), or the tensors that differ are named."""
    off, on = params[False], params[True]
    differ = [n for n in off if not torch.equal(off[n], on[n])]
    if differ:
        raise AssertionError(f"{what}: remat on and off differ in {len(differ)} of {len(off)} "
                             f"trainable tensors after {steps} steps: {differ}")
    print(f"{what}: remat on and off give bit-equal parameters after {steps} steps "
          f"({len(off)} trainable tensors)", flush=True)


def l14_distill_phase(torch, np, card: str, table: KernelTable) -> dict:
    """Phase 31: the ViT-L/14 distillation step at B=256, cache-warm and
    uncached, each with remat off and on; the L/14 teacher targets and the
    student's gradients (B=4) against the f32 route; the L/14 teacher
    trainer at B=32; K10 and K10' (head_dim
    96) and K11 at D=768 against their twins. Returns the launches of the
    five runs, summed."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict

    t0 = time.perf_counter()
    sd = random_state_dict(CLIPConfig.vit_l_14(), seed=0)
    tsd = random_teacher_state_dict(_l14_teacher_config(), seed=0)
    print(f"l14: random weights from seed 0 in {time.perf_counter() - t0} s", flush=True)
    steps = WARMUP_STEPS + L14_TIMED_STEPS
    counts: dict = {}
    summary = []
    for label, cached, per_step in (("cache-warm", True, _student_per_step),
                                    ("uncached", False, _uncached_per_step)):
        params = {}
        for remat in (False, True):
            what = f"l14 {label} remat {'on' if remat else 'off'}"
            trainer, batch = _distill_trainer(torch, np, sd, tsd, "cuda", TRAIN_B, l14=True,
                                              cached=cached, remat=remat)
            if trainer.student.vision_model.encoder.remat != remat or not trainer._use_kernels:
                raise AssertionError(f"{what}: expected the kernels on and remat {remat}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_launches()
            ms = _run_steps(torch, np, trainer, batch, what, card, timed_steps=L14_TIMED_STEPS)
            launches = _all_launches()
            expected = _expected(per_step(trainer), steps)
            print(f"{what}: launches", json.dumps(launches), "expected", json.dumps(expected),
                  flush=True)
            if launches != expected:
                raise AssertionError(f"{what}: launch counts {launches} != {expected}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"{what}: peak device memory {peak} GiB ({card})", flush=True)
            summary.append((label, remat, ms, TRAIN_B * 1000.0 / ms, peak))
            for k, n in launches.items():
                counts[k] = counts.get(k, 0) + n
            params[remat] = {n: p.detach().cpu() for n, p in trainer.student.named_parameters()
                             if p.requires_grad}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        _hold_remat(torch, f"l14 {label}", params, steps)
        del params
    for label, remat, ms, ips, peak in summary:
        print(f"l14 summary: {label} remat {'on' if remat else 'off'}: {ms} ms/step, {ips} "
              f"images/s, peak {peak} GiB (ViT-L/14, B={TRAIN_B}; {card})", flush=True)
    for label in ("cache-warm", "uncached"):
        off, on = (r[2] for r in summary if r[0] == label)
        print(f"l14 summary: {label} remat costs {on / off} x the step without ({card})",
              flush=True)
    target_agreement_phase(torch, np, sd, tsd, l14=True)
    grad_agreement_phase(torch, np, sd, tsd, "l14 grads", batch_size=L14_GRAD_B, l14=True)

    # The meta-teacher's training at L/14, at the teacher CLI's default batch.
    b = TEACHER_B[0]
    trainer = _teacher_trainer(sd, tsd, "cuda", b, l14=True)
    batch = _batch(np, b, clip_cfg=CLIPConfig.vit_l_14(), teacher_cfg=_l14_teacher_config())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    _run_steps(torch, np, trainer, batch, f"l14 teacher B={b}", card, batch_size=b,
               timed_steps=L14_TIMED_STEPS)
    launches = _all_launches()
    expected = _expected(_teacher_per_step(trainer), steps)
    print(f"l14 teacher B={b}: launches", json.dumps(launches), "expected",
          json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"l14 teacher launch counts {launches} != {expected}")
    print(f"l14 teacher B={b}: peak device memory {torch.cuda.max_memory_allocated() / 2**30} "
          f"GiB ({card})", flush=True)
    for k, n in launches.items():
        counts[k] = counts.get(k, 0) + n
    del trainer, sd, tsd
    gc.collect()
    torch.cuda.empty_cache()

    xattn_trainable_phase(torch, np, card, table, d=L14_XATTN_D, h=L14_XATTN_HEADS,
                          batches=TEACHER_B[:1])
    xattn_kernel_phase(torch, np, card, table, d=L14_XATTN_D, heads=L14_XATTN_HEADS)
    dev = torch.device("cuda")
    rng = np.random.RandomState(31)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(dtype))

    distill_loss_cases(torch, randn, card, table, L14_XATTN_D, (("b256", TRAIN_B, True, True),))
    torch.cuda.empty_cache()
    return counts


def _fixture_size(name: str):
    """(w, h) from a fixture's name, `<kind>_<w>x<h>.<ext>`."""
    w, h = name.rsplit("_", 1)[1].split(".")[0].split("x")
    return int(w), int(h)


def _host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            names = [line.split(":", 1)[1].strip() for line in f if line.startswith("model name")]
    except OSError:
        return "unknown host CPU"
    return f"{names[0]} x{len(names)}" if names else "unknown host CPU"


def files_phase(torch, np, card: str, jpeg: dict):
    """Phase 32: both training CLIs at `FILES_PRESET` (ViT-L/14) on
    `FILES_DEVICE` from the committed JPEG fixtures through the native
    decoder, or, where this machine cannot build it, the clean raise of
    `decode_backend="native"`."""
    import tempfile

    from dclip_tpu_torch import native
    from dclip_tpu_torch.cli import train_distill, train_teacher
    from dclip_tpu_torch.data.corpus import load_corpus
    from dclip_tpu_torch.data.detection_cache import DetectionCache
    from dclip_tpu_torch.data.pipeline import MultiModalPipeline
    from dclip_tpu_torch.data.tokenizer import HashTokenizer

    tok = HashTokenizer(vocab_size=1000, max_length=TEXT_S)
    if not jpeg["available"]:
        print(f"files: this machine cannot build or load the JPEG decoder: {jpeg['error']}",
              flush=True)
        try:
            MultiModalPipeline([], tok, decode_backend="native")
        except RuntimeError as e:
            print(f"files: decode_backend='native' raises: {e}", flush=True)
            if "native JPEG decoder" not in str(e):
                raise AssertionError(f"files: the raise does not name the decoder: {e}") from e
            return
        raise AssertionError("files: decode_backend='native' did not raise without a decoder")

    fixtures = {n: os.path.abspath(FIXTURES + n) for n in FILES_JPEGS + FILES_PIL_ONLY}
    # The decoder alone: shapes, ranges and original sizes, fixture by fixture.
    from dclip_tpu_torch.data.pipeline import _CLIP_MEAN_F32, _CLIP_STD_F32

    for name in FILES_JPEGS:
        with open(fixtures[name], "rb") as f:
            data = f.read()
        for fast in (False, True):
            out = native.decode_preprocess(data, 224, 224, fast=fast, mean=_CLIP_MEAN_F32,
                                           std=_CLIP_STD_F32)
            if out is None or out[2] != _fixture_size(name) or out[0].shape != (224, 224, 3) \
                    or out[1].shape != (224, 224, 3) or not np.isfinite(out[0]).all() \
                    or not 0.0 <= out[1].min() <= out[1].max() <= 1.0:
                raise AssertionError(f"files: decode of {name} (fast={fast}): "
                                     f"{None if out is None else (out[0].shape, out[2])}")
    print(f"files: {len(FILES_JPEGS)} fixtures decode natively (exact and scaled DCT), "
          "original sizes from the frames", flush=True)
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    for name in FILES_PIL_ONLY:  # the per-item rule: these need PIL
        pipe = MultiModalPipeline([{"image_path": fixtures[name], "captions": ["x"]}], tok,
                                  decode_backend="native")
        if have_pil:
            pipe._load_item(0, 0)
            print(f"files: {name} took the PIL route (PIL is installed here)", flush=True)
            continue
        try:
            pipe._load_item(0, 0)
        except ImportError as e:
            if name not in str(e):
                raise AssertionError(f"files: {name}: the error does not name it: {e}") from e
            print(f"files: {name} needs PIL, which this machine lacks: {e}", flush=True)
        else:
            raise AssertionError(f"files: {name} loaded without PIL")

    with tempfile.TemporaryDirectory(prefix="dclip_files_") as root:
        rng = np.random.RandomState(32)
        items = [{"image_path": fixtures[FILES_JPEGS[i % len(FILES_JPEGS)]],
                  "captions": [f"photo {i} of a scene with {w}" for w in
                               rng.choice(["dogs", "a red car", "two people", "trees"], 2)]}
                 for i in range(FILES_ITEMS + FILES_VAL)]
        train_file = os.path.join(root, "files_train.json")
        with open(train_file, "w") as f:
            json.dump(items[:FILES_ITEMS], f)
        with open(os.path.join(root, "files_val.json"), "w") as f:
            json.dump(items[FILES_ITEMS:], f)
        cache = DetectionCache()
        for name in FILES_JPEGS:  # 8 boxes of a 4 x 2 grid, in the frame's pixels
            w, h = _fixture_size(name)
            boxes = [[w * c / 4, h * r / 2, w * (c + 1) / 4, h * (r + 1) / 2]
                     for r in range(2) for c in range(4)]
            cache.put(fixtures[name], np.asarray(boxes, np.float32),
                      np.linspace(0.9, 0.2, 8).astype(np.float32))
        npz = os.path.join(root, "precache.npz")
        cache.save(npz)

        pipe = MultiModalPipeline(load_corpus(train_file), tok, DetectionCache.load(npz),
                                  batch_size=32, max_patches=TEACHER_P, image_size=224,
                                  teacher_image_size=224, max_text_tokens=TEXT_S,
                                  decode_backend="native")
        t0 = time.perf_counter()
        batches = list(pipe.epoch(0))
        seconds = time.perf_counter() - t0
        pipe.close()
        for b in batches:
            if b.pixel_values.shape != (32, 224, 224, 3) or b.teacher_pixels.min() < 0 \
                    or b.teacher_pixels.max() > 1 or not np.isfinite(b.pixel_values).all() \
                    or b.box_mask.sum() != 32 * TEACHER_P or b.boxes.max() > 224.0 + 1e-3:
                raise AssertionError("files: a batch of the native route is malformed")
        print(f"files: host decode of {FILES_ITEMS} items (native, 8 threads, 224 px student "
              f"and teacher) {seconds} s, {FILES_ITEMS / seconds} images/s on the host "
              f"({_host_cpu()}; host CPU, not the card)", flush=True)

        preset = FILES_PRESET
        common = ["--detection_cache", npz, "--model_preset", preset, "--decode_backend",
                  "native", "--device", FILES_DEVICE]
        t0 = time.perf_counter()
        if train_teacher.main(["--train_file", train_file, "--epochs", "1", "--output_path",
                               os.path.join(root, "models", "teacher")] + common) != 0:
            raise AssertionError("files: train_teacher failed")
        print(f"files: train_teacher ({preset}, --decode_backend native, 1 epoch of "
              f"{FILES_ITEMS} items at its default batch) {time.perf_counter() - t0} s ({card})",
              flush=True)
        index = json.load(open(os.path.join(root, "models", "checkpoints.json")))
        teacher_ckpt = index[-1]["path"]
        t0 = time.perf_counter()
        if train_distill.main(["--train_file", train_file, "--phase1_epochs", "1",
                               "--accumulate_grad_batches", "1", "--checkpoint_dir",
                               os.path.join(root, "ckpts"), "--teacher_checkpoint",
                               teacher_ckpt, "--remat"] + common) != 0:
            raise AssertionError("files: train_distill failed")
        print(f"files: train_distill ({preset}, --remat, --decode_backend native, 1 epoch at "
              f"its default batch) {time.perf_counter() - t0} s ({card})", flush=True)
        distill = json.load(open(os.path.join(root, "ckpts", "checkpoints.json")))
        for what, entries in (("teacher", index), ("distill", distill)):
            losses = [v for e in entries for v in e["metrics"].values()]
            print(f"files: {what} checkpoints {[os.path.basename(e['path']) for e in entries]}, "
                  f"losses {losses}", flush=True)
            if not entries or not all(os.path.exists(e["path"]) for e in entries) \
                    or not losses or not all(np.isfinite(losses)):
                raise AssertionError(f"files: {what} checkpoints or losses: {entries}")


def _run_cli(main_fn, argv):
    """main_fn(argv) with its standard output captured: (its lines, the
    JSON record of the last)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main_fn(argv)
    lines = out.getvalue().strip().splitlines()
    if code != 0:
        raise AssertionError(f"profile: {argv} returned {code}")
    return lines, json.loads(lines[-1])


def _hold_profile(rec, batch, on_card: bool, trace_dir: str, card: str):
    """Phase 34 (a) / (c)'s checks of one `cli.profile --json` record."""
    import glob

    ph = rec["phases_ms"]
    full = ph["full uncached step"]
    print(f"profile: {rec['preset']} B={batch}: phases ms {json.dumps(ph)}; images/s uncached "
          f"{rec['images_per_sec_uncached']}, cache-warm {rec['images_per_sec_cache_warm']}; "
          f"MFU uncached {rec['mfu_uncached']} (true {rec['mfu_uncached_masked_true']}), "
          f"cache-warm {rec['mfu_cache_warm']} (true {rec['mfu_cache_warm_masked_true']}); "
          f"{rec['backend']}, {card}", flush=True)
    for name in ("full uncached step", "teacher patch encode", "teacher tail (text+xattn)",
                 "student step (cache-warm)"):
        if not 0 < ph[name] < PHASE_BOUND * full:
            raise AssertionError(f"profile: {name} {ph[name]} ms outside (0, {PHASE_BOUND} x "
                                 f"{full})")
    for key, name in (("images_per_sec_uncached", "full uncached step"),
                      ("images_per_sec_cache_warm", "student step (cache-warm)")):
        # The record rounds the rate and the phase each to two decimals
        # (cli/profile.py, as the JAX CLI): half a unit of the rate's last
        # place, plus what the phase's own half unit moves the rate.
        want = batch / (ph[name] / 1e3)
        if abs(rec[key] - want) > 0.005 + want * 0.005 / ph[name]:
            raise AssertionError(f"profile: {key} {rec[key]} != batch / phase {want}")
    mfus = [rec[k] for k in ("mfu_uncached", "mfu_uncached_masked_true", "mfu_cache_warm",
                             "mfu_cache_warm_masked_true")]
    if on_card and not all(m is not None and 0 < m <= 1 for m in mfus):
        raise AssertionError(f"profile: MFU values {mfus} not all in (0, 1]")
    if not on_card and any(m is not None for m in mfus):
        raise AssertionError(f"profile: MFU values {mfus} without a card")
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if not traces:
        raise AssertionError(f"profile: no trace file in {trace_dir}")
    print(f"profile: trace {os.path.basename(traces[0])}, "
          f"{os.path.getsize(traces[0])} bytes", flush=True)


def _held_launches(launches, names, what):
    missing = [n for n in names if launches.get(n, 0) == 0]
    print(f"profile: {what} launches {json.dumps({n: launches.get(n, 0) for n in names})}",
          flush=True)
    if missing:
        raise AssertionError(f"profile: {what} launched no {missing}")


def profile_phase(torch, np, card: str) -> dict:
    """Phase 34: the profiling slice's CLIs on `PROFILE_DEVICE`, (a) the
    phase profile at ViT-B/16, (b) the per-op table, (c) the phase profile
    at ViT-L/14. Returns each run's launches by preset (the per-op table's
    are not the main path's and are only held)."""
    import shutil
    import tempfile

    from dclip_tpu_torch.cli import profile
    from dclip_tpu_torch.cli.profile_ops import FLOOR_SHARE

    t0 = time.perf_counter()
    on_card = PROFILE_DEVICE == "cuda"
    launches = {}

    def profile_run(preset, batch, steps):
        t_run = time.perf_counter()
        trace_dir = tempfile.mkdtemp(prefix="dclip_profile_")
        try:
            _reset_all_launches()
            lines, rec = _run_cli(profile.main, [
                "--model_preset", preset, "--batch", str(batch), "--steps", str(steps),
                "--json", "--trace_dir", trace_dir, "--device", PROFILE_DEVICE])
            launches[preset] = _all_launches()
            for line in lines[:-1]:
                print(f"profile: {line}", flush=True)
            _hold_profile(rec, batch, on_card, trace_dir, card)
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        if on_card:
            _held_launches(launches[preset], PROFILE_PATH_KERNELS, f"{preset} path")
        print(f"profile: {preset} run {time.perf_counter() - t_run} s", flush=True)

    (b16, b16_batch, b16_steps), l14 = PROFILE_RUNS[0], PROFILE_RUNS[1:]
    profile_run(b16, b16_batch, b16_steps)

    t_ops = time.perf_counter()
    _reset_all_launches()
    _, ops = _run_cli(profile.main, ["--per_op", "--batch", str(PROFILE_OPS_B), "--steps",
                                     str(PROFILE_OPS_STEPS), "--json", "--device",
                                     PROFILE_DEVICE])
    per_op_launches = _all_launches()
    gc.collect()
    print(f"profile: per-op B={ops['batch']} S={ops['seq']} D={ops['hidden']} packed rows "
          f"{ops['packed_rows']}; {ops['device']}, peaks {json.dumps(ops['peaks'])}; {card}",
          flush=True)
    print(f"profile: {'op':<38}{'meas ms':>12}{'floor ms':>12}{'x/floor':>10}  bound",
          flush=True)
    below = []
    for row in ops["rows"]:
        ratio = row["x_over_floor"]
        print(f"profile: {row['op']:<38}{row['measured_ms']:>12.5f}{row['floor_ms']:>12.5f}"
              f"{ratio if ratio is None else round(ratio, 3)!s:>10}  {row['bound']}", flush=True)
        if on_card and row["measured_ms"] < FLOOR_SHARE * row["floor_ms"]:
            below.append(row["op"])
    print("profile: per-op summary " + json.dumps(
        {k: v for k, v in ops.items() if k not in ("rows", "peaks")}), flush=True)
    if below:
        raise AssertionError(f"profile: rows under {FLOOR_SHARE} of their floor: {below}")
    if not ops["per_layer_composite_ms"] > 0:
        raise AssertionError("profile: the composite layer row is not above 0")
    if on_card:
        _held_launches(per_op_launches, PER_OP_KERNELS, "per-op")
    print(f"profile: per-op run {time.perf_counter() - t_ops} s", flush=True)

    for preset, batch, steps in l14:
        profile_run(preset, batch, steps)
    print(f"profile: phase 34 {time.perf_counter() - t0} s ({card})", flush=True)
    return launches


# -- tensor parallelism: ranks of this script on one card over gloo ------------------


def _tp_wrappers():
    """{launch counter: (module, wrapper)} of the kernels phase 35 runs."""
    from dclip_tpu_torch.kernels import cross_attention as xa
    from dclip_tpu_torch.kernels import distill_loss as dl
    from dclip_tpu_torch.kernels import vit_attention as va
    from dclip_tpu_torch.kernels import vit_block as vb

    return {"layernorm": (vb, "layernorm"), "gemm_bias_act_residual": (vb, "gemm_bias_act_residual"),
            "attention": (vb, "attention"), "self_attention_fused": (va, "self_attention_fused"),
            "self_attention_fwd_stats": (va, "self_attention_fwd_stats"),
            "self_attention_bwd_stats": (va, "self_attention_bwd_stats"),
            "distill_loss_fwd": (dl, "distill_loss_fwd"), "distill_loss_bwd": (dl, "distill_loss_bwd"),
            "cross_attention": (xa, "cross_attention_fused"),
            "cross_attention_core": (xa, "cross_attention_core"),
            "add_layernorm_f32": (xa, "add_layernorm_f32"),
            "cross_attention_trainable": (xa, "cross_attention_trainable")}


def _signature(torch, x):
    """What tells two calls' shapes apart: each tensor's shape, dtype and
    strides, any other value itself."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), tuple(x.stride()))
    if isinstance(x, dict):
        return tuple((k, _signature(torch, v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(torch, v) for v in x)
    return repr(x)


class FirstCalls:
    """While active, records the arguments of the first call of each
    signature of every wrapper of `wrappers` (default `_tp_wrappers()`), as
    {(counter, signature): bound arguments}. The wrapper is replaced in
    every loaded module of the port that binds it, so a caller that
    imported it by name is seen too."""

    def __init__(self, torch, wrappers=None):
        self.torch, self.calls, self._undo = torch, {}, []
        self.wrappers = wrappers or _tp_wrappers()

    def __enter__(self):
        import inspect

        for name, (mod, attr) in self.wrappers.items():
            real = getattr(mod, attr)
            sig = inspect.signature(real)

            def recording(*a, _name=name, _real=real, _sig=sig, **k):
                bound = _sig.bind(*a, **k)
                bound.apply_defaults()
                args = dict(bound.arguments)
                args.pop("out", None)  # K5's output views: the replays write fresh tensors
                self.calls.setdefault((_name, _signature(self.torch, args)), args)
                return _real(*a, **k)

            for m in list(sys.modules.values()):
                if getattr(m, "__name__", "").startswith("dclip_tpu_torch"):
                    for binding, value in list(vars(m).items()):
                        if value is real:
                            setattr(m, binding, recording)
                            self._undo.append((m, binding, real))
        return self

    def __exit__(self, *exc):
        for m, binding, real in reversed(self._undo):
            setattr(m, binding, real)
        self._undo.clear()


def _tensor_bytes(torch, x) -> float:
    """The bytes of every tensor in x (nested dicts, lists, tuples)."""
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(torch, v) for v in x)
    return 0.0


def _tp_case(torch, name, a):
    """One recorded call `a` (bound arguments) of the wrapper counted as
    `name`: (kernel, twin, compare, f32 and bf16 operations, library call
    or None). `compare(got, want)` holds the outputs at the kernel phases'
    tolerances and returns the largest |kernel - twin|."""
    from dclip_tpu_torch.kernels import cross_attention as xa
    from dclip_tpu_torch.kernels import distill_loss as dl
    from dclip_tpu_torch.kernels import vit_attention as va
    from dclip_tpu_torch.kernels import vit_block as vb

    mod, attr = _tp_wrappers()[name]
    real = getattr(mod, attr)

    def kernel():
        with torch.no_grad():
            return real(**a)

    def each(tol, with_one=True):
        def compare(got, want):
            pairs = zip(got, want) if isinstance(want, (list, tuple)) else [(got, want)]
            return max(_bound_check(torch, f"{name}[tp] {i}", g, w, tol, with_one)
                       for i, (g, w) in enumerate(pairs))
        return compare

    masks = {k: a[k] for k in ("padding_mask", "causal", "segment_ids") if k in a}
    if name == "layernorm":
        x = a["x"]
        return (kernel, lambda: vb.layernorm_reference(**a), each(REL_TOL), 8.0 * x.numel(), 0.0,
                layer_norm_call(torch, x, a["scale"], a["bias"]))
    if name == "gemm_bias_act_residual":
        act, w, bias = a["a"], a["w"], a["bias"]
        k, n = w.shape
        act2 = act.reshape(-1, k)
        library = ((lambda: torch.mm(act2, w)) if bias is None else
                   (lambda b16=bias.to(torch.bfloat16): torch.addmm(b16, act2, w)))
        return (kernel, lambda: vb.gemm_bias_act_residual_reference(**a), each(REL_TOL), 0.0,
                2.0 * act2.shape[0] * k * n, library)
    if name == "attention":
        qkv, heads = a["qkv"], a["num_heads"]
        b, s, d3 = qkv.shape
        d = d3 // 3
        return (kernel, lambda: vb.attention_reference(**a), each(REL_TOL), 0.0,
                4.0 * b * s * s * d,
                sdpa_calls(torch, qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], heads, None))
    if name.startswith("self_attention_"):
        q, k, v, heads = a["q"], a["k"], a["v"], a["num_heads"]
        b, s, d = q.shape
        keep = _keep(torch, b, s, q.device, {n: m for n, m in masks.items() if m is not None
                                             and m is not False})
        pairs = float(b * s * s if keep is None else keep.sum().item())
        if name == "self_attention_fused":
            return (kernel, lambda: va.attention_reference(q, k, v, heads, **masks),
                    each(REL_TOL), 0.0, 4.0 * d * pairs, sdpa_calls(torch, q, k, v, heads, keep))
        if name == "self_attention_fwd_stats":
            def compare(got, want):
                err = each(REL_TOL)(got[:2], want[:2])
                rel = ((got[2] - want[2]).abs() / want[2].abs()).max().item()
                print(f"kernel {name}[tp] rinv: max_rel_err {rel} bound {REL_TOL}", flush=True)
                if not rel <= REL_TOL:
                    raise AssertionError(f"{name}[tp] rinv: relative error {rel} > {REL_TOL}")
                return err
            return (kernel, lambda: va.attention_reference(q, k, v, heads, stats=True, **masks),
                    compare, 0.0, 4.0 * d * pairs, sdpa_calls(torch, q, k, v, heads, keep))
        g = a["g"]

        def twin():
            o, m, r = va.attention_reference(q, k, v, heads, stats=True, **masks)
            return va.attention_bwd_reference(q, k, v, g, o, m, r, heads, **masks)
        return (kernel, twin, each(BWD_TOL), 0.0, 10.0 * d * pairs,
                sdpa_calls(torch, q, k, v, heads, keep, g))
    if name.startswith("distill_loss_"):
        b, d = a["si"].shape
        if name == "distill_loss_bwd":
            return (kernel, lambda: dl.distill_loss_bwd_reference(**a), each(DL_BWD_TOL, False),
                    6.0 * b * b * d + 20.0 * b * d, 0.0, None)

        def compare(got, want):
            rel = ((got - want).abs() / want.abs()).max().item()
            print(f"kernel {name}[tp]: parts {got.tolist()} twin {want.tolist()} max_rel_err "
                  f"{rel} bound {DL_RTOL}", flush=True)
            if got.shape != want.shape or not rel <= DL_RTOL:
                raise AssertionError(f"{name}[tp]: relative error {rel} > {DL_RTOL}")
            return (got - want).abs().max().item()
        return (kernel, lambda: dl.distill_loss_fwd_reference(**a), compare,
                2.0 * b * b * d + 10.0 * b * d, 0.0, None)
    if name == "cross_attention_core":
        qkv_t, qkv_i = a["qkv_t"], a["qkv_i"]
        b, t, d3 = qkv_t.shape
        return (kernel, lambda: xa.cross_attention_core_reference(**a), each(REL_TOL),
                8.0 * b * t * qkv_i.shape[1] * d3 // 3, 0.0,
                core_sdpa_calls(torch, qkv_t, qkv_i, a["text_mask"], a["image_mask"],
                                a["num_heads"]))
    if name == "add_layernorm_f32":
        def twin():
            return [xa.add_layernorm_reference(x, r, s, bb, a["eps"])
                    for (x, r), s, bb in zip(a["xs"], a["scales"], a["biases"])]
        rows_d = sum(x.numel() for x, _ in a["xs"])
        return kernel, twin, each(REL_TOL), 10.0 * rows_d, 0.0, None
    # K10 and K10': the four projections (bf16) and the core (f32).
    text, image = a["text"], a["image"]
    b, t, d = text.shape
    rows = b * (t + image.shape[1])
    f32_ops = 8.0 * b * t * image.shape[1] * d + 10.0 * rows * d
    if name == "cross_attention":
        return (kernel, lambda: xa.cross_attention_reference(**a), each(REL_TOL), f32_ops,
                2.0 * rows * d * 3 * d + 2.0 * rows * d * d, None)

    def twin():
        w = xa.pack_cross_attention(a["params"], torch.float32, prefix="")
        return xa.cross_attention_reference(w, text.detach(), image.detach(), a["text_mask"],
                                            a["image_mask"], a["num_heads"])
    return kernel, twin, each(REL_TOL), f32_ops, 8.0 * rows * d * d, None


def _tp_work_case(torch, name, a):
    """`_tp_case` with its operations as `work` arguments."""
    kernel, twin, compare, f32_ops, bf16_ops, library = _tp_case(torch, name, a)
    return kernel, twin, compare, {"f32_flops": f32_ops, "bf16_flops": bf16_ops}, library


def tp_kernel_checks(torch, calls, card: str, timed: bool, suffix: str = "[tp]",
                     case=_tp_work_case) -> dict:
    """Each recorded call (`FirstCalls.calls`) held against its twin; with
    `timed`, kernel and twin timed in turns and the library call alone, at
    the bound of this call (its operations, and the bytes of its inputs and
    outputs unless the case names them). `case(torch, counter, arguments)`
    gives (kernel, twin, compare, `work` arguments, library call or None).
    Returns the rows `counter + suffix` ("[tp]"): {row: kernels-line
    entry}, each summing its calls' times and bounds (one call of each
    shape) and keeping the largest error."""
    names = sorted({name for name, _ in calls})
    table = KernelTable([n + suffix for n in names])
    for (name, _), a in sorted(calls.items(), key=lambda kv: kv[0][0]):
        kernel, twin, compare, ops, library = case(torch, name, a)
        got = kernel()
        err = compare(got, twin())
        table.error(name + suffix, err)
        if timed:
            ops = dict(ops)
            ops.setdefault("nbytes", _tensor_bytes(torch, a) + _tensor_bytes(torch, got))
            bound = work(**ops)
            ms, plain_ms = time_pair(torch, kernel, twin, 5)
            lib_ms = None if library is None else time_one(torch, library, 5)
            shapes = {k: tuple(v.shape) for k, v in a.items() if isinstance(v, torch.Tensor)}
            print(f"time {name}{suffix} {shapes}: kernel {ms} ms, plain {plain_ms} ms, bound "
                  f"{max(bound)} ms, library {lib_ms} ms ({card})", flush=True)
            table.timed(name + suffix, ms, plain_ms, bound, lib_ms)
        del got
    return {row: table.entry(row) for row in table.rows}


def _tp_configs(preset: str):
    """(CLIP config, teacher config) of phase 35 at `preset`: the
    B/16 phases' teacher (`_teacher_config()`) at its width."""
    from dclip_tpu_torch.core import CLIPConfig, TeacherConfig

    cfg = CLIPConfig.from_name(preset)
    d = cfg.projection_dim
    return cfg, TeacherConfig(embed_dim=d, num_heads=TEXT_HEADS if d % 64 == 0 else 4,
                              max_patches=TEACHER_P, max_text_tokens=cfg.text.max_length)


def _tp_expected(clip_cfg, counted: int, teacher: bool = False):
    """A rank's launches of phase 35's counted steps under tensor
    parallelism: per uncached step the region encode at shard width (LN1,
    LN2, 4 GEMMs and K1's core a layer, no whole-block launch), the
    teacher text tower (K3 a layer) and K10 (4 GEMMs, its core, its add +
    LayerNorm); per distill step K4 / K5 a student layer and K11 1 + 1.
    `counted` steps; the distill runs TP_STEPS of them uncached."""
    v, t = clip_cfg.vision.num_layers, clip_cfg.text.num_layers
    teacher_part = {"layernorm": 2 * v, "gemm_bias_act_residual": 4 * v + 4, "attention": v,
                    "image_features": 1, "self_attention_fused": t, "cross_attention": 1,
                    "cross_attention_core": 1, "add_layernorm_f32": 1}
    names = _all_launches()
    if teacher:
        per = dict(teacher_part, cross_attention_trainable=1)
        return {k: per.get(k, 0) * counted for k in names}
    uncached = TP_STEPS
    per_student = {"self_attention_fwd_stats": v + t, "self_attention_bwd_stats": v + t,
                   "distill_loss_fwd": 1, "distill_loss_bwd": 1}
    return {k: per_student.get(k, 0) * counted + teacher_part.get(k, 0) * uncached
            for k in names}


def _tp_run(torch, np, device, preset: str, batch: int, teacher_batch: int, steps: int,
            mesh, sd, tsd, recorder=None) -> dict:
    """Phase 35's work on `mesh` (a rank's, or the one-rank mesh of the
    reference): features before training, the distill steps, the teacher
    steps; the warm-up (first) step's trainable gradients, the counted
    steps' losses, ms, launches, and the trainable parameters after them,
    whole (gathered over the model group). `recorder` (a `FirstCalls`), if
    given, is active over the two warm-up steps."""
    import contextlib
    import dataclasses

    from dclip_tpu_torch.core.config import TeacherTrainConfig
    from dclip_tpu_torch.parallel.tp import gather_clip_params
    from dclip_tpu_torch.train import TeacherTrainer
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg, tcfg = _tp_configs(preset)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def one(b, seed, first):
        return _batch(np, b, seed=seed, first=first, clip_cfg=cfg, teacher_cfg=tcfg)

    def counted(trainer, batches):
        sync()
        _reset_all_launches()
        losses, ms = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            losses.append(trainer.train_step_on_batch(b)["loss"])
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        return [float(x) for x in losses], ms, _all_launches()

    def trainable(module, names, grads=False):
        named = dict(module.named_parameters())
        picked = {n: named[n].detach() for n in names}
        if grads:  # a parameter without .grad counts as zeros, as in the optimizer
            picked = {n: torch.zeros_like(t) if named[n].grad is None else named[n].grad
                      for n, t in picked.items()}
        whole = gather_clip_params(picked, mesh)
        return {n: whole[n].float().cpu() for n in names}

    recording = recorder if recorder is not None else contextlib.nullcontext()

    out = {}
    config = _distill_config(batch, student_model=preset, teacher_clip_model=preset, teacher=tcfg,
                             use_pallas=True)
    trainer = DistillTrainer(config, sd, sd, tsd, cfg, cfg, device=device, mesh=mesh,
                             teacher_cache=TeacherTargetCache(salt="chip-smoke-tp"))
    probe = trainer._device_batch(one(batch, 49, 10 ** 6))
    with torch.no_grad():
        t_img, t_txt = trainer._teacher_targets(probe)
        out["features"] = {
            "teacher_img": t_img, "teacher_txt": t_txt,
            "student_img": trainer.student.image_features(probe["pixel_values"]),
            "student_txt": trainer.student.get_text_features(probe["input_ids"],
                                                             probe["attention_mask"])}
    out["features"] = {k: v.float().cpu() for k, v in out["features"].items()}
    batches = [one(batch, 60 + i, i * batch) for i in range(steps)]
    with recording:
        trainer.train_step_on_batch(one(batch, 59, 10 ** 7))  # warm-up
    out["grads"] = trainable(trainer.student, trainer._trainable_names(), grads=True)
    out["losses"], out["ms"], out["launches"] = counted(trainer, batches + batches)
    out["expected"] = _tp_expected(cfg, 2 * steps)
    out["params"] = trainable(trainer.student, trainer._trainable_names())
    del trainer, probe
    if on_card:
        torch.cuda.empty_cache()

    tconfig = dataclasses.replace(TeacherTrainConfig(
        batch_size=teacher_batch, learning_rate=TEACHER_LR, seed=0, clip_model=preset,
        teacher=tcfg), use_pallas=True)
    trainer = TeacherTrainer(tconfig, sd, cfg, tsd, device=device, mesh=mesh)
    tbatches = [one(teacher_batch, 70 + i, i * teacher_batch) for i in range(steps + 1)]
    with recording:
        trainer.train_step_on_batch(tbatches[0])  # warm-up
    names = [n for n, p in trainer.teacher.named_parameters() if p.requires_grad]
    out["teacher_grads"] = trainable(trainer.teacher, names, grads=True)
    out["teacher_losses"], out["teacher_ms"], out["teacher_launches"] = counted(trainer,
                                                                                tbatches[1:])
    out["teacher_expected"] = _tp_expected(cfg, steps, teacher=True)
    out["teacher_params"] = {n: p.detach().float().cpu()
                             for n, p in trainer.teacher.named_parameters()}
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    return out


def tp_rank_main(argv) -> int:
    """One rank of phase 35 (`chip_smoke.py --tp-rank OUT_DIR DEVICE PRESET
    B TEACHER_B STEPS CARD` under the DCLIP env triple): joins the gloo
    group, builds the (1, world) mesh, runs `_tp_run` on the weights of
    `OUT_DIR/weights.pt` recording the kernel wrappers' calls, holds the
    kernels on them (`tp_kernel_checks`) and writes `OUT_DIR/rank<r>.pt`
    (rank 0 with the gathered parameters and gradients)."""
    import torch

    import numpy as np

    from dclip_tpu_torch.cli.common import init_multihost
    from dclip_tpu_torch.core.config import MeshConfig
    from dclip_tpu_torch.parallel.mesh import make_mesh

    global PEAKS
    out_dir, device, preset, batch, teacher_batch, steps, card = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_multihost(device, timeout=TP_TIMEOUT / 3, backend="gloo")
    try:
        world = torch.distributed.get_world_size()
        mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=world))
        print(f"rank {mesh.global_rank}: {torch.distributed.get_backend()} group of {world} on "
              f"{dev}, mesh {mesh.shape}, model index {mesh.model_index}", flush=True)
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            from dclip_tpu_torch.core.flops import card_peaks

            PEAKS = card_peaks(dev)
        weights = torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)
        recorder = FirstCalls(torch)
        res = _tp_run(torch, np, dev, preset, int(batch), int(teacher_batch), int(steps), mesh,
                      weights["sd"], weights["tsd"], recorder)
        # The kernels on the recorded calls, one rank at a time: rank 0
        # times them with the card to itself.
        for turn in range(world):
            if turn == mesh.global_rank:
                res["kernels"] = tp_kernel_checks(torch, recorder.calls, card,
                                                  timed=on_card and turn == 0)
            torch.distributed.barrier()
        del recorder
        if mesh.global_rank:
            del res["params"], res["teacher_params"], res["grads"], res["teacher_grads"]
        torch.save(res, os.path.join(out_dir, f"rank{mesh.global_rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _tp_hold_close(what, got, want, bound_of) -> list:
    """The tensors of `got` beyond bound_of(`want`'s) of `want`'s, the
    largest difference printed."""
    worst = []
    for name, ref in want.items():
        err = (got[name] - ref).abs().max().item()
        if not err <= bound_of(ref):
            worst.append((name, err, bound_of(ref)))
    print(f"tp: {what}: {len(want)} tensors, largest |tp - one process| "
          f"{max((got[n] - want[n]).abs().max().item() for n in want)}, beyond the bound "
          f"{len(worst)}", flush=True)
    return [f"{what}: {worst[:5]}"] if set(got) != set(want) or worst else []


def _tp_grads_close(what, got, want) -> list:
    """The gathered gradients `got` against one process's `want`: over the
    tensors the model axis shards and, apart, over the replicated ones, the
    L2 norm of the difference within TP_GRAD_TOL of `want`'s (so a
    replicated gradient summed over the model ranks, or a shard's gradient
    missing its all-reduce, fails); the largest contributors to the
    difference and the lowest cosines printed."""
    from dclip_tpu_torch.parallel.tp import param_spec

    failures = [f"{what}: names differ"] if set(got) != set(want) else []
    for part in ("sharded", "replicated"):
        names = [n for n in want if (param_spec(n) is not None) == (part == "sharded")]
        if not names:
            continue
        sq = {n: (got[n] - want[n]).double().square().sum().item() for n in names}
        norm = sum(want[n].double().square().sum().item() for n in names) ** 0.5
        rel = sum(sq.values()) ** 0.5 / norm
        top = sorted(names, key=sq.get, reverse=True)[:3]
        cos = sorted((_cosine(got[n], want[n]), n) for n in names)[:3]
        print(f"tp: {what}, {part}: {len(names)} tensors, |tp - one process| / |one process| "
              f"{rel} (L2; bound {TP_GRAD_TOL}); largest shares of the difference "
              f"{[(n, sq[n] / sum(sq.values())) for n in top]}; lowest cosines {cos}", flush=True)
        if not rel <= TP_GRAD_TOL:
            failures.append(f"{what}, {part}: relative L2 difference {rel} > {TP_GRAD_TOL}")
    return failures


def _cosine(a, b) -> float:
    """The cosine of two tensors as flat f64 vectors (1 when both are 0)."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    return 1.0 if na == nb == 0.0 else (a @ b).item() / max(na * nb, 1e-300)


def tp_phase(torch, np, sd, tsd, card: str):
    """Phase 35: `_tp_run` in this process without a group (the reference),
    then in TP_RANKS processes of this script with the model axis across
    them, on the same weights; holds them (module docstring) and fails
    with every check that failed. `sd` / `tsd`: the CLIP and meta-teacher
    state dicts of `TP_PRESET`. Returns both ranks' launches and the `[tp]`
    rows of the kernels line (the ranks' largest errors, rank 0's times)."""
    import shutil
    import subprocess
    import tempfile

    from dclip_tpu_torch.parallel.mesh import local_mesh

    t_phase = time.perf_counter()
    on_card = TP_DEVICE == "cuda"
    ref = _tp_run(torch, np, TP_DEVICE, TP_PRESET, TP_B, TP_TEACHER_B, TP_STEPS, local_mesh(),
                  sd, tsd)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    port = _free_port()
    procs = []
    try:
        torch.save({"sd": sd, "tsd": tsd}, os.path.join(out_dir, "weights.pt"))
        for r in range(TP_RANKS):
            env = dict(os.environ, DCLIP_COORDINATOR=f"127.0.0.1:{port}",
                       DCLIP_NUM_PROCESSES=str(TP_RANKS), DCLIP_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank", out_dir, TP_DEVICE,
                 TP_PRESET, str(TP_B), str(TP_TEACHER_B), str(TP_STEPS), card],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=TP_TIMEOUT)
            for line in out.strip().splitlines():
                print(f"tp: rank {r} | {line}", flush=True)
            if proc.returncode != 0:
                failed.append((r, proc.returncode))
        if failed:
            raise AssertionError(f"tp: ranks failed (rank, exit code): {failed}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP_RANKS)]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    tp0 = ranks[0]
    steps = 2 * TP_STEPS
    print(f"tp: distill {TP_PRESET} B={TP_B} mp={TP_RANKS} over gloo: ms per step uncached "
          f"{json.dumps(tp0['ms'][:TP_STEPS])}, cache-warm {json.dumps(tp0['ms'][TP_STEPS:])}; "
          f"one process {json.dumps(ref['ms'][:TP_STEPS])}, {json.dumps(ref['ms'][TP_STEPS:])}; "
          f"teacher B={TP_TEACHER_B} {json.dumps(tp0['teacher_ms'])} vs "
          f"{json.dumps(ref['teacher_ms'])} (host clock to a synchronize; {card}). gloo carries "
          "every collective through host memory, so these times are no measure of what "
          "tensor parallelism costs over NVLink", flush=True)
    print(f"tp: losses distill {json.dumps(tp0['losses'])} vs {json.dumps(ref['losses'])}, "
          f"teacher {json.dumps(tp0['teacher_losses'])} vs {json.dumps(ref['teacher_losses'])}",
          flush=True)
    failures = []
    total = {}
    for r, res in enumerate(ranks):
        if res["losses"] != tp0["losses"] or res["teacher_losses"] != tp0["teacher_losses"]:
            failures.append(f"rank {r}'s losses differ from rank 0's")
        for what, got, want in (("distill", res["launches"], res["expected"]),
                                ("teacher", res["teacher_launches"], res["teacher_expected"])):
            print(f"tp: rank {r} {what} launches "
                  f"{json.dumps({k: v for k, v in got.items() if v})}", flush=True)
            if on_card and got != want:
                failures.append(f"rank {r} {what} launches {got} != expected {want}")
            for k, n in got.items():
                total[k] = total.get(k, 0) + n
        # Every kernel the counted steps launched was held on this rank's
        # recorded calls.
        launched = {k for k in (*res["launches"], *res["teacher_launches"])
                    if res["launches"][k] + res["teacher_launches"][k] and k in _kernel_sources()}
        checked = {row[:-len("[tp]")] for row in res["kernels"]}
        if on_card and launched != checked:
            failures.append(f"rank {r}: kernels launched {sorted(launched)} != held on their "
                            f"recorded calls {sorted(checked)}")
    for what, got, want, bound, relative in (
            ("distill", tp0["losses"], ref["losses"], TP_DISTILL_LOSS_RTOL, True),
            ("teacher", tp0["teacher_losses"], ref["teacher_losses"], TP_TEACHER_LOSS_ATOL, False)):
        worst = max(abs(a - b) / (abs(b) if relative else 1.0) for a, b in zip(got, want))
        print(f"tp: {what} losses: largest |tp - one process|{' / |one process|' * relative} "
              f"{worst} (bound {bound})", flush=True)
        if not worst <= bound:
            failures.append(f"{what} losses {got} not within {bound} of {want}")
    failures += _tp_hold_close("features before training", tp0["features"], ref["features"],
                               lambda t: REL_TOL * max(1.0, t.abs().max().item()))
    failures += _tp_grads_close("distill gradients of the first step", tp0["grads"],
                                ref["grads"])
    failures += _tp_grads_close("teacher gradients of the first step", tp0["teacher_grads"],
                                ref["teacher_grads"])
    failures += _tp_hold_close(f"trainable parameters after {steps + 1} distill steps",
                               tp0["params"], ref["params"],
                               lambda t: 2 * _distill_config(TP_B).learning_rate * (steps + 1))
    failures += _tp_hold_close(f"teacher parameters after {TP_STEPS + 1} steps",
                               tp0["teacher_params"], ref["teacher_params"],
                               lambda t: 2 * TEACHER_LR * (TP_STEPS + 1))
    rows = {}
    for row, entry in tp0["kernels"].items():
        rows[row] = dict(entry, max_abs_err=max(res["kernels"][row]["max_abs_err"]
                                                for res in ranks))
        print(f"tp: {row}: {json.dumps(rows[row])}", flush=True)
    print(f"tp: phase 35 {time.perf_counter() - t_phase} s ({card})", flush=True)
    if failures:
        raise AssertionError("tp: " + "; ".join(failures))
    return total, rows


# -- serving over ranks: ranks of this script on one card over gloo ------------------


def _serve_wrappers():
    """{launch counter: (module, wrapper)} of the kernels phase 36 holds:
    K1, K2 and K12."""
    from dclip_tpu_torch.kernels import topk as tk
    from dclip_tpu_torch.kernels import vit_block as vb

    return {"attention_block": (vb, "attention_block_fused"),
            "mlp_block": (vb, "mlp_block_fused"), "topk_streamed": (tk, "topk_streamed")}


def _serve_case(torch, name, a, suffix="[serve_dp]"):
    """One recorded call `a` of K1, K2 or K12 on a rank of phase 36 (or of
    K1 / K2 in phase 37, with its `suffix`): (kernel, twin, compare, `work`
    arguments, library call or None), at the kernel phases' bounds and
    tolerances (`kernel_phase`, `topk_kernel_phase`)."""
    from dclip_tpu_torch.kernels import topk as tk
    from dclip_tpu_torch.kernels import vit_block as vb

    mod, attr = _serve_wrappers()[name]
    real = getattr(mod, attr)

    def kernel():
        with torch.no_grad():
            return real(**a)

    if name == "topk_streamed":
        q, store, k = a["queries"], a["store"], a["k"]
        nq, d = q.shape
        n = store.shape[0]
        k = min(k, n)

        def compare(got, want):
            return _hold_topk(torch, f"serve_dp {nq}x{n}x{d} k={k}", got, q, store, k)
        return (kernel, lambda: tk.topk_streamed_reference(q, store, k), compare,
                {"tf32_flops": 3 * 2.0 * nq * n * d,
                 "nbytes": 4.0 * (n * d + nq * d) + 8.0 * nq * k},
                lambda: torch.topk(q @ store.T, k, dim=-1))
    x, p = a["x"], a["p"]
    b, s, d = x.shape
    m = b * s

    def compare(got, want):
        return _bound_check(torch, f"{name}{suffix} B={b}", got, want, REL_TOL)
    if name == "attention_block":
        return (kernel, lambda: vb.attention_block_reference(**a), compare,
                {"bf16_flops": 2.0 * m * d * 4 * d + 4.0 * b * s * s * d,
                 "nbytes": 4.0 * m * d + 8.0 * d * d + 4.0 * 6 * d}, None)
    mlp = p["fc1_w"].shape[1]
    return (kernel, lambda: vb.mlp_block_reference(**a), compare,
            {"bf16_flops": 4.0 * m * d * mlp,
             "nbytes": 4.0 * m * d + 4.0 * d * mlp + 4.0 * (mlp + 3 * d)}, None)


def _serve_args(cli_serve, quantize: str = "", mesh_data: int = 1):
    """The serve CLI's flags of phase 36 (phase 4's, with SERVE_BUCKETS)."""
    return cli_serve.parse_args([
        "--model_preset", SERVE_PRESET, "--clip_weights", "random", "--seed", "0",
        "--tokenizer_dir", "hash", "--buckets", SERVE_BUCKETS, "--index_dim",
        str(SERVE_INDEX_DIM), "--device", SERVE_DEVICE, "--quantize", quantize,
        "--mesh_data", str(mesh_data)])


def _serve_requests(np, size: int):
    """Phase 36's requests: SERVE_TEXTS texts, SERVE_IMAGES seeded uint8
    images of mixed sizes (every 4th at the tower's, the rest resized on
    the host), SERVE_QUERIES query texts."""
    rng = np.random.RandomState(36)
    texts = [f"photo {i}: " + " ".join(rng.choice(["a", "dog", "red", "car", "two", "cats",
                                                   "on", "the", "grass", "street"], 2 + i % 9))
             for i in range(SERVE_TEXTS)]
    images = [rng.randint(0, 256, (size, size, 3) if i % 4 == 0 else
                          (size // 2 + 11 * i, size + 5 * i, 3), np.uint8)
              for i in range(SERVE_IMAGES)]
    queries = [f"a query about object {i} in a room" for i in range(SERVE_QUERIES)]
    return texts, images, queries


def _serve_index(torch, dim: int):
    """SERVE_ROWS seeded unit rows of `dim` made on SERVE_DEVICE, on the
    host, and their ids."""
    gen = torch.Generator(device=SERVE_DEVICE).manual_seed(36)
    keys = torch.randn((SERVE_ROWS, dim), generator=gen, device=SERVE_DEVICE)
    keys /= keys.norm(dim=-1, keepdim=True)
    return keys.cpu().numpy(), [f"row{i}" for i in range(SERVE_ROWS)]


def _serve_path(torch, np, cli_serve, front, args) -> dict:
    """Phase 36's main path on `front` (a `ClipService` or its `Lead`): the
    CLI's selftest (its probe is the index's first row), the encodes, the
    index add, the text search."""
    if cli_serve.selftest(front, args) != 0:
        raise AssertionError("serve: the selftest failed")
    texts, images, queries = _serve_requests(np, front.cfg.vision.image_size)
    out = {"texts": front.encode_texts(texts), "images": front.encode_images(images)}
    keys, ids = _serve_index(torch, front.cfg.projection_dim)
    front.add_to_index(ids, keys)
    out["hits"] = front.search_texts(queries, k=SERVE_K)
    out["index_size"] = front.index_size
    return out


def _serve_expected(cfg, rank: int) -> dict:
    """A rank's launches on phase 36's main path: two image batches (the
    selftest's, bucket 2; the SERVE_IMAGES, one bucket) through K1 / K2 a
    layer, on its half of each; K12 once for each search in which its
    shard holds a row: the 64 queries on each rank, and the probe searches
    of the bf16 and the int8 selftests (a one-row index) on rank 0."""
    layers, batches = cfg.vision.num_layers, 2
    out = {"layernorm": 2 * layers * batches, "gemm_bias_act_residual": 4 * layers * batches,
           "attention": layers * batches, "attention_block": layers * batches,
           "mlp_block": layers * batches, "encoder_forward": batches, "image_features": batches,
           "topk_streamed": 1 + (2 if rank == 0 else 0)}
    return {k: out.get(k, 0) for k in _all_launches()}


def serve_rank_main(argv) -> int:
    """One rank of phase 36 (`chip_smoke.py --serve-rank OUT_DIR CARD
    CONSTANTS` under the DCLIP env triple; CONSTANTS, a JSON object, sets
    the phase's SERVE_* constants as the parent has them): joins a gloo
    group on SERVE_DEVICE, takes
    the serve CLI's mesh of it (`cli.common.serve_mesh`), builds the
    service through `build_service` and, on global rank 0, drives the main
    path through `serve.fanout.lead` (the others `follow`), recording the
    K1 / K2 / K12 calls; then the bench through a second lead; then the
    int8 service's selftest. Each rank holds the kernels on its recorded
    calls (rank 0 times them alone) and writes `OUT_DIR/rank<r>.pt`."""
    import torch

    import numpy as np

    from dclip_tpu_torch.cli import serve as cli_serve
    from dclip_tpu_torch.cli.common import init_multihost, serve_mesh
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.serve.fanout import follow, lead

    global PEAKS
    out_dir, card, constants = argv
    globals().update(json.loads(constants))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_multihost(SERVE_DEVICE, timeout=SERVE_TIMEOUT / 3, backend="gloo")
    try:
        world = torch.distributed.get_world_size()
        mesh, _ = serve_mesh(_serve_args(cli_serve, mesh_data=world))
        print(f"rank {mesh.global_rank}: {torch.distributed.get_backend()} group of {world} on "
              f"{dev}, mesh {mesh.shape}", flush=True)
        on_card = torch.device(dev).type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        if on_card:
            from dclip_tpu_torch.core.flops import card_peaks
            from dclip_tpu_torch.kernels import _build

            PEAKS = card_peaks(dev)
            _build.load_library()  # its self-check launch (K13) before the path
        res, launches = {}, {}
        recorder = FirstCalls(torch, _serve_wrappers())
        for quantize in ("", "int8"):
            args = _serve_args(cli_serve, quantize, mesh.size)
            service = cli_serve.build_service(args, mesh)
            sync()
            _reset_all_launches()
            with recorder:
                if mesh.is_primary:
                    with lead(service) as front:
                        t0 = time.perf_counter()
                        if quantize:
                            res["int8_selftest"] = cli_serve.selftest(front, args)
                        else:
                            res.update(_serve_path(torch, np, cli_serve, front, args))
                        res[f"path_s{quantize}"] = time.perf_counter() - t0
                else:
                    follow(service)
            sync()
            for k, n in _all_launches().items():
                launches[k] = launches.get(k, 0) + n
            if not quantize:  # rank 0's latencies through a second lead
                if mesh.is_primary:
                    with lead(service) as front:
                        res["bench"] = cli_serve.bench(front, args,
                                                       concurrencies=SERVE_CONCURRENCY)
                else:
                    follow(service)
            del service
            if on_card:
                torch.cuda.empty_cache()
        res["launches"] = launches
        res["expected"] = _serve_expected(CLIPConfig.from_name(SERVE_PRESET), mesh.global_rank)
        for turn in range(world):
            if turn == mesh.global_rank:
                res["kernels"] = tp_kernel_checks(torch, recorder.calls, card,
                                                  timed=on_card and turn == 0,
                                                  suffix="[serve_dp]", case=_serve_case)
            torch.distributed.barrier()
        del recorder
        torch.save(res, os.path.join(out_dir, f"rank{mesh.global_rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _serve_constants() -> str:
    """The SERVE_* constants, as `serve_rank_main` takes them."""
    return json.dumps({k: v for k, v in globals().items() if k.startswith("SERVE_")})


def _serve_rows_held(np, what, got, want) -> list:
    """Rows of the ranks against one process's: bit-equal, else within
    SERVE_ROW_TOL (the line says which held)."""
    diff = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    same = got.shape == want.shape and np.array_equal(got, want)
    print(f"serve_dp: {what} {got.shape}: bit-equal to one process {same}; largest |ranks - "
          f"one process| {diff} (bound {SERVE_ROW_TOL} where not bit-equal)", flush=True)
    return [] if diff <= SERVE_ROW_TOL else [f"{what}: |ranks - one process| {diff} > "
                                             f"{SERVE_ROW_TOL}"]


def _serve_hits_held(np, what, got, want) -> list:
    """Top-k of the ranks against one process's: ids equal, scores within
    TOPK_TOL."""
    ids_equal = [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
    scores = np.asarray([[x for _, x in r] for r in got], np.float64)
    ref = np.asarray([[x for _, x in r] for r in want], np.float64)
    diff = float(np.abs(scores - ref).max()) if scores.shape == ref.shape else float("inf")
    print(f"serve_dp: {what}: {len(got)} queries x top-{SERVE_K}: ids equal {ids_equal}, "
          f"largest score difference {diff} (bound {TOPK_TOL})", flush=True)
    return [] if ids_equal and diff <= TOPK_TOL else [f"{what}: ids equal {ids_equal}, "
                                                      f"score difference {diff}"]


def serve_phase(torch, np, card: str):
    """Phase 36: the one-process service through the serve CLI's
    `build_service` on the main path (the reference), then SERVE_RANKS
    processes of this script in a gloo group on the card (`--serve-rank`),
    then a one-rank NCCL group (gloo off the card) from the serve CLI's
    `serve_mesh`; holds them (module docstring) and fails with every check
    that failed. Returns the ranks' launches and the `[serve_dp]` rows of
    the kernels line (the ranks' largest errors, rank 0's times)."""
    import shutil
    import subprocess
    import tempfile

    from dclip_tpu_torch.cli import serve as cli_serve
    from dclip_tpu_torch.cli.common import serve_mesh
    from dclip_tpu_torch.serve.fanout import lead

    t_phase = time.perf_counter()
    on_card = SERVE_DEVICE == "cuda"
    args = _serve_args(cli_serve)
    service = cli_serve.build_service(args)
    t0 = time.perf_counter()
    ref = _serve_path(torch, np, cli_serve, service, args)
    ref_s = time.perf_counter() - t0
    del service
    if on_card:
        torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    port = _free_port()
    procs = []
    try:
        for r in range(SERVE_RANKS):
            env = dict(os.environ, DCLIP_COORDINATOR=f"127.0.0.1:{port}",
                       DCLIP_NUM_PROCESSES=str(SERVE_RANKS), DCLIP_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--serve-rank", out_dir, card,
                 _serve_constants()],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=SERVE_TIMEOUT)
            for line in out.strip().splitlines():
                print(f"serve_dp: rank {r} | {line}", flush=True)
            if proc.returncode != 0:
                failed.append((r, proc.returncode))
        if failed:
            raise AssertionError(f"serve_dp: ranks failed (rank, exit code): {failed}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(SERVE_RANKS)]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    failures = []
    failures += _serve_rows_held(np, f"{SERVE_TEXTS} texts", r0["texts"], ref["texts"])
    failures += _serve_rows_held(np, f"{SERVE_IMAGES} images", r0["images"], ref["images"])
    failures += _serve_hits_held(np, "text search", r0["hits"], ref["hits"])
    if not r0["index_size"] == ref["index_size"] == SERVE_ROWS + 1:
        failures.append(f"index sizes {r0['index_size']} / {ref['index_size']}")
    if r0["int8_selftest"] != 0:
        failures.append("the int8 selftest over ranks failed")
    print(f"serve_dp: main path {r0['path_s']} s over {SERVE_RANKS} ranks, {ref_s} s in one "
          f"process; int8 selftest {r0['path_sint8']} s ({card})", flush=True)
    for row in r0["bench"]:
        print(f"serve_dp: bench over {SERVE_RANKS} ranks through gloo (host memory; no measure "
              f"of serving across cards): {json.dumps(row)} ({card})", flush=True)
    total = {}
    for r, res in enumerate(ranks):
        got = res["launches"]
        print(f"serve_dp: rank {r} launches {json.dumps({k: v for k, v in got.items() if v})}, "
              f"expected {json.dumps({k: v for k, v in res['expected'].items() if v})}",
              flush=True)
        if on_card and got != res["expected"]:
            failures.append(f"rank {r} launches {got} != expected {res['expected']}")
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        checked = {row[:-len("[serve_dp]")] for row in res["kernels"]}
        if on_card and checked != set(_serve_wrappers()):
            failures.append(f"rank {r}: kernels held on their recorded calls {sorted(checked)}")
    if on_card and not all(total[k] for k in _serve_wrappers()):
        failures.append(f"a kernel of the path was never launched: {total}")

    # One NCCL rank (gloo off the card): the serve CLI's group and mesh.
    triple = {"DCLIP_COORDINATOR": f"127.0.0.1:{_free_port()}", "DCLIP_NUM_PROCESSES": "1",
              "DCLIP_PROCESS_ID": "0"}
    saved_env = {k: os.environ.get(k) for k in triple}
    os.environ.update(triple)
    try:
        one_args = _serve_args(cli_serve, mesh_data=-1)
        mesh, made = serve_mesh(one_args)
        try:
            backend = torch.distributed.get_backend()
            service = cli_serve.build_service(one_args, mesh)
            with lead(service) as front:
                group = _serve_path(torch, np, cli_serve, front, one_args)
            del service
        finally:
            if made:
                torch.distributed.destroy_process_group()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    same = {what: np.array_equal(group[what], ref[what]) for what in ("texts", "images")}
    same["hits"] = group["hits"] == ref["hits"]
    print(f"serve_dp: a one-rank {backend} group (mesh {mesh.shape}, made by serve_mesh) "
          f"against no group: bit-equal {json.dumps(same)}", flush=True)
    if not made or not all(same.values()):
        failures.append(f"the one-rank {backend} group: bit-equal {same}")
    if on_card:
        torch.cuda.empty_cache()
    rows = {}
    for row, entry in r0["kernels"].items():
        rows[row] = dict(entry, max_abs_err=max(res["kernels"].get(row, {"max_abs_err": 0.0})
                                                ["max_abs_err"] for res in ranks))
        print(f"serve_dp: {row}: {json.dumps(rows[row])}", flush=True)
    print(f"serve_dp: phase 36 {time.perf_counter() - t_phase} s ({card})", flush=True)
    if failures:
        raise AssertionError("serve_dp: " + "; ".join(failures))
    return total, rows


# -- the last modules: the context view, BERT, detector training ---------------------


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_ms(torch, device, fn, repeats: int) -> float:
    """Mean host ms of `fn()` over `repeats` calls after a warm one, each
    ended by a synchronize."""
    fn()
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
        _sync(torch, device)
    return (time.perf_counter() - t0) * 1000.0 / repeats


def _peak_gib(torch, device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**30


def _reset_peak(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _context_wrappers():
    """{launch counter: (module, wrapper)} of K1 and K2."""
    return {k: v for k, v in _serve_wrappers().items() if k != "topk_streamed"}


def context_phase(torch, np, card: str):
    """Phase 37 (a): `encode_patches_with_context` of the LAST_PRESET teacher
    CLIP over CONTEXT_B images x 8 boxes, through the route a user gets
    (`models.encoding.image_forward`: K1 / K2 for bf16 on the card). The
    counts start at 0 before the encode and must be twice one image
    features call's (the patch view, then the context view); K1 and K2 are
    held against their twins on the first call of each that the context
    view made. Times the region encode alone and the encode with the
    context view (host clock to a synchronize), prints the peak memory,
    and holds CONTEXT_AGREE_B images (3 boxes invalid) against the f32
    module path on the CPU by per-row cosine. Returns (launches of the
    encode, `[context]` rows)."""
    from dclip_tpu_torch.cli.common import load_clip
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.encoding import image_forward
    from dclip_tpu_torch.models.teacher import encode_patches, encode_patches_with_context

    on_card = LAST_DEVICE == "cuda"
    dev = torch.device(LAST_DEVICE)
    cfg, model = load_clip(LAST_PRESET, "random", 0, LAST_DTYPE, LAST_DEVICE)
    fn = image_forward(model)
    s = cfg.vision.image_size

    def inputs(batch_size):
        batch = _batch(np, batch_size, clip_cfg=cfg)
        return [torch.as_tensor(batch[k], device=dev) for k in ("teacher_pixels", "boxes",
                                                                 "box_mask")]

    images, boxes, mask = inputs(CONTEXT_B)
    b, p = boxes.shape[:2]
    _reset_all_launches()
    with torch.no_grad():
        fn(torch.zeros((1, s, s, 3), device=dev))
    _sync(torch, dev)
    per_call = {k: v for k, v in _all_launches().items() if v}

    calls, views = {}, []

    def recorded(px):
        views.append(px.shape[0])
        if len(views) == 2 and on_card:  # the context view's frames
            with FirstCalls(torch, _context_wrappers()) as rec:
                out = fn(px)
            calls.update(rec.calls)
            return out
        return fn(px)

    _reset_peak(torch, dev)
    _reset_all_launches()
    with torch.no_grad():
        pe, ce = encode_patches_with_context(model, images, boxes, mask, s, recorded)
    _sync(torch, dev)
    launches = _all_launches()
    peak = _peak_gib(torch, dev)
    got = {k: v for k, v in launches.items() if v}
    expected = {k: 2 * v for k, v in per_call.items()}
    print(f"context: {LAST_PRESET} {LAST_DTYPE} on {LAST_DEVICE}, {b} images x {p} boxes: "
          f"views of {views} frames, launches {json.dumps(got)}, expected {json.dumps(expected)}"
          f" (one image features call: {json.dumps(per_call)}), peak {peak} GiB ({card})",
          flush=True)
    failures = []
    if on_card and (got != expected or not all(got.get(k) for k in _context_wrappers())):
        failures.append(f"launches {got} != {expected}")
    invalid = mask <= 0
    for name, x in (("patch", pe), ("context", ce)):
        if tuple(x.shape) != (b, p, cfg.projection_dim) or not torch.isfinite(x).all():
            failures.append(f"{name} embeddings {tuple(x.shape)} not finite or misshapen")
        elif invalid.any() and x[invalid].abs().max().item() != 0.0:
            failures.append(f"{name} embeddings of invalid slots are not zero")
    del pe, ce
    with torch.no_grad():
        region_ms = _host_ms(torch, dev, lambda: encode_patches(model, images, boxes, mask, s, fn),
                             CONTEXT_REPEATS)
        both_ms = _host_ms(torch, dev, lambda: encode_patches_with_context(
            model, images, boxes, mask, s, fn), CONTEXT_REPEATS)
    print(f"context: region encode {region_ms} ms, region + context encode {both_ms} ms, "
          f"the context view {both_ms - region_ms} ms ({b * p} frames, host clock to a "
          f"synchronize, mean of {CONTEXT_REPEATS}; {card})", flush=True)
    del images, boxes, mask
    rows = tp_kernel_checks(torch, calls, card, timed=on_card, suffix="[context]",
                            case=lambda t, n, a: _serve_case(t, n, a, "[context]"))
    del calls
    for row, entry in rows.items():
        print(f"context: {row}: {json.dumps(entry)}", flush=True)

    # Agreement: the route on LAST_DEVICE against the f32 modules on the CPU.
    images, boxes, mask = inputs(CONTEXT_AGREE_B)
    mask[1, 5:] = 0.0
    cpu = CLIPModule(cfg, dtype=torch.float32, device="meta")
    cpu.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()},
                        strict=True, assign=True)
    with torch.no_grad():
        got = encode_patches_with_context(model, images, boxes, mask, s, fn)
        t0 = time.perf_counter()
        want = encode_patches_with_context(cpu.eval(), images.cpu(), boxes.cpu(), mask.cpu(), s)
    cpu_s = time.perf_counter() - t0
    valid = mask.cpu() > 0
    for name, g, w in zip(("patch", "context"), got, want):
        g, w = g.double().cpu()[valid], w.double()[valid]
        cos = torch.nn.functional.cosine_similarity(g, w, dim=-1)
        print(f"context: {name} view, {CONTEXT_AGREE_B} images ({int(valid.sum())} valid of "
              f"{valid.numel()}): {LAST_DTYPE} on {LAST_DEVICE} vs the f32 modules on the CPU "
              f"({cpu_s} s), per-row cosine min {cos.min().item()} bound {COS_BOUND}", flush=True)
        if not cos.min().item() >= COS_BOUND:
            failures.append(f"{name} view cosine {cos.min().item()} < {COS_BOUND}")
    del model, cpu
    _reset_peak(torch, dev)
    if failures:
        raise AssertionError("context: " + "; ".join(failures))
    return launches, rows


def _random_bert_state_dict(torch, cfg, seed: int = 0):
    """Seeded BERT weights by `transformers`' init rule: Linear and
    Embedding weights N(0, 0.02), biases 0, LayerNorm 1 / 0."""
    from dclip_tpu_torch.models.bert import BertEncoder

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in BertEncoder(cfg, device="meta").state_dict().items():
        if "LayerNorm" in name:
            out[name] = torch.ones(t.shape) if name.endswith("weight") else torch.zeros(t.shape)
        elif name.endswith("bias"):
            out[name] = torch.zeros(t.shape)
        else:
            out[name] = torch.randn(t.shape, generator=gen) * 0.02
    return out


def _bert_captions(np, n: int):
    """n seeded captions of 3-60 words from the vocabulary's words, unknown
    words, accents and punctuation (the longest overflow BERT_T)."""
    rng = np.random.RandomState(37)
    words = ["the", "cat", "dog", "running", "jumps", "a", "photo", "of", "unbelievable", "over",
             "naïve", "café", "hello", "world", "123", "zebra", ",", ".", "!", "中国"]
    return [" ".join(rng.choice(words, 3 + (i * 7) % 58)) for i in range(n)]


def bert_phase(torch, np, card: str):
    """Phase 37 (b): BERT_CAPTIONS captions -> WordPiece ids (BERT_T) ->
    `BertEncoder(BERT_PRESET)` -> `TextProjectionModule` (BERT_CLIP_DIM), in
    f32 on the CPU, in f32 on LAST_DEVICE (TF32 off) and in bf16 there; the
    f32 device output within BERT_TOL of the largest |value| of the CPU's,
    the bf16 route's error printed beside it, each route timed."""
    from dclip_tpu_torch.data.bert_tokenizer import BertWordPieceTokenizer
    from dclip_tpu_torch.models.bert import BertConfig, BertEncoder, bert_to_clip_features
    from dclip_tpu_torch.models.projections import TextProjectionModule

    cfg = getattr(BertConfig, BERT_PRESET)()
    tok = BertWordPieceTokenizer({t: i for i, t in enumerate(WORDPIECE_VOCAB)}, max_length=BERT_T)
    ids, mask = tok.encode_batch(_bert_captions(np, BERT_CAPTIONS))
    sd = _random_bert_state_dict(torch, cfg, seed=0)
    head = TextProjectionModule(clip_dim=BERT_CLIP_DIM, bert_dim=cfg.hidden_size, device="meta")
    gen = torch.Generator().manual_seed(1)
    head_sd = {k: (torch.randn(t.shape, generator=gen) * t.shape[1] ** -0.5 if t.dim() == 2
                   else torch.zeros(t.shape)) for k, t in head.state_dict().items()}
    print(f"bert: {BERT_PRESET} ({cfg.num_layers} layers, {cfg.hidden_size} wide), "
          f"{len(ids)} captions, {int(mask.sum())} of {mask.size} tokens real, "
          f"{int((mask.sum(1) == BERT_T).sum())} truncated to {BERT_T}", flush=True)
    outs, times = {}, {}
    for name, device, dtype in (("cpu f32", "cpu", torch.float32),
                                ("f32", LAST_DEVICE, torch.float32),
                                ("bf16", LAST_DEVICE, torch.bfloat16)):
        bert = BertEncoder(cfg, dtype=dtype, device="meta")
        bert.load_state_dict({k: v.to(device, dtype) for k, v in sd.items()}, strict=True,
                             assign=True)
        proj = TextProjectionModule(clip_dim=BERT_CLIP_DIM, bert_dim=cfg.hidden_size,
                                    device="meta")
        proj.load_state_dict({k: v.to(device, dtype) for k, v in head_sd.items()}, strict=True,
                             assign=True)
        ids_t = torch.as_tensor(ids, device=device)
        mask_t = torch.as_tensor(mask, device=device)

        def run():
            with torch.inference_mode():
                return bert_to_clip_features(bert.eval(), proj, ids_t, mask_t)

        t0 = time.perf_counter()
        outs[name] = run().float().cpu()
        times[name] = ((time.perf_counter() - t0) * 1000.0 if device == "cpu"
                       else _host_ms(torch, device, run, 5))
        del bert, proj
    want = outs["cpu f32"]
    scale = want.abs().max().item()
    errs = {n: (outs[n] - want).abs().max().item() / scale for n in ("f32", "bf16")}
    print(f"bert: [{len(ids)}, {BERT_CLIP_DIM}] features, largest |value| {scale}; on "
          f"{LAST_DEVICE} f32 (TF32 off) max |err| / largest {errs['f32']} bound {BERT_TOL}, "
          f"bf16 {errs['bf16']}; ms a batch: {json.dumps(times)} ({card})", flush=True)
    if not torch.isfinite(outs["f32"]).all() or not errs["f32"] <= BERT_TOL:
        raise AssertionError(f"bert: f32 error {errs['f32']} > {BERT_TOL} of the largest value")
    if not all(torch.isfinite(o).all() for o in outs.values()):
        raise AssertionError("bert: non-finite features")


def _det_batch(torch, cfg, n: int, seed: int):
    """n seeded images [n, S, S, 3] in [0, 1] with DET_GT boxes each (the
    last of every other image padding), a brighter field inside each box,
    and their labels and mask, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    s = cfg.image_size
    images = torch.rand((n, s, s, 3), generator=gen) * 0.3
    lo = torch.rand((n, DET_GT, 2), generator=gen) * (0.7 * s)
    size = (0.1 + 0.2 * torch.rand((n, DET_GT, 2), generator=gen)) * s
    boxes = torch.cat([lo, torch.clamp(lo + size, max=float(s))], -1).floor()
    labels = torch.randint(0, cfg.num_classes, (n, DET_GT), generator=gen)
    mask = torch.ones((n, DET_GT))
    mask[1::2, -1] = 0.0
    for i in range(n):
        for j in range(DET_GT):
            if mask[i, j] > 0:
                x1, y1, x2, y2 = (int(v) for v in boxes[i, j])
                images[i, y1:y2, x1:x2] += 0.2 + 0.1 * j
    return images.clamp(0, 1), boxes, labels, mask


def detector_train_phase(torch, np, card: str):
    """Phase 37 (c): the detector in train mode. One step's parameter
    gradients at DET_GRAD_B through `detection_step` (forward and backward
    in f32) on LAST_DEVICE against the same step in f64 there (global
    relative L2 within DET_GRAD_TOL); beside it, the same step on the CPU
    in f32 and the same step with its backward outside the f32 block and
    cuDNN's TF32 on, each against the f64 step, and the device's f32
    against the CPU's. Then DET_TRAIN_STEPS Adam(DET_LR) steps at
    DET_TRAIN_B on one fixed batch: finite losses that fall, ms a step,
    peak memory."""
    import dataclasses

    from dclip_tpu_torch.models.detector import (
        YOLO,
        DetectorConfig,
        f32_convolutions,
        random_detector_state_dict,
    )
    from dclip_tpu_torch.models.detector_loss import detection_loss, detection_step

    cfg = dataclasses.replace(DetectorConfig.v8x(), **DET_TRAIN_CHANGES)
    sd = random_detector_state_dict(cfg, seed=0)

    def fresh(device, dtype=torch.float32):
        model = YOLO(cfg, device="meta")
        model.load_state_dict({k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
                               for k, v in sd.items()}, strict=True, assign=True)
        return model.train()

    def grads(model):
        return torch.cat([p.grad.reshape(-1) for p in model.parameters()]).double().cpu()

    batch = _det_batch(torch, cfg, DET_GRAD_B, seed=37)
    runs = {}
    for name, device, dtype in (("f64", LAST_DEVICE, torch.float64),
                                ("f32", LAST_DEVICE, torch.float32),
                                ("cpu f32", "cpu", torch.float32)):
        model = fresh(device, dtype)
        t0 = time.perf_counter()
        _, parts = detection_step(model, cfg, *(x.to(device) for x in batch))
        _sync(torch, device)
        runs[name] = (grads(model), {k: v.item() for k, v in parts.items()},
                      time.perf_counter() - t0)
        del model
    # The trap: the same step with its backward outside the f32 block, cuDNN
    # TF32 on (the process default the smoke turned off).
    model = fresh(LAST_DEVICE)
    with f32_convolutions():
        total, parts = detection_loss(cfg, model(batch[0].to(LAST_DEVICE)),
                                      *(x.to(LAST_DEVICE) for x in batch[1:]))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        total.backward()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    runs["tf32 backward"] = (grads(model), {k: v.item() for k, v in parts.items()}, None)
    del model
    want = runs["f64"][0]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    errs = {n: rel(runs[n][0], want) for n in ("f32", "cpu f32", "tf32 backward")}
    errs["f32 vs cpu f32"] = rel(runs["f32"][0], runs["cpu f32"][0])
    print(f"det_train: {cfg.width}-wide depth {cfg.depth} at {cfg.image_size} px, B="
          f"{DET_GRAD_B}: loss parts {json.dumps({n: r[1] for n, r in runs.items()})}; "
          f"gradients ({want.numel()} values) relative L2 vs the f64 step on {LAST_DEVICE}: "
          f"{json.dumps(errs)}, bound {DET_GRAD_TOL} on f32; step s "
          f"{json.dumps({n: r[2] for n, r in runs.items() if r[2] is not None})} ({card})",
          flush=True)
    failures = []
    if len({r[1]["num_pos"] for r in runs.values()}) != 1:
        failures.append(f"positives differ: {[r[1]['num_pos'] for r in runs.values()]}")
    if not torch.isfinite(runs["f32"][0]).all() or not errs["f32"] <= DET_GRAD_TOL:
        failures.append(f"gradients relative L2 {errs['f32']} > {DET_GRAD_TOL}")

    _reset_peak(torch, LAST_DEVICE)
    model = fresh(LAST_DEVICE)
    images, boxes, labels, mask = (x.to(LAST_DEVICE) for x in _det_batch(torch, cfg,
                                                                         DET_TRAIN_B, seed=38))
    opt = torch.optim.Adam(model.parameters(), lr=DET_LR)
    losses, step_ms = [], []
    for _ in range(DET_TRAIN_STEPS):
        _sync(torch, LAST_DEVICE)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        total, _ = detection_step(model, cfg, images, boxes, labels, mask)
        opt.step()
        losses.append(total.item())
        step_ms.append((time.perf_counter() - t0) * 1000.0)
    peak = _peak_gib(torch, LAST_DEVICE)
    print(f"det_train: B={DET_TRAIN_B}, {DET_TRAIN_STEPS} Adam({DET_LR}) steps on one batch: "
          f"losses {losses}; ms a step {step_ms} (the first warms up; host clock to the loss's "
          f"read), peak {peak} GiB ({card})", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses {losses} not finite or not falling")
    del model, opt
    _reset_peak(torch, LAST_DEVICE)
    if failures:
        raise AssertionError("det_train: " + "; ".join(failures))


def last_modules_phase(torch, np, card: str):
    """Phase 37: (a) `context_phase`, (b) `bert_phase`, (c)
    `detector_train_phase`. Returns (a)'s (launches, `[context]` rows)."""
    t_phase = time.perf_counter()
    launches, rows = context_phase(torch, np, card)
    bert_phase(torch, np, card)
    detector_train_phase(torch, np, card)
    print(f"last: phase 37 {time.perf_counter() - t_phase} s ({card})", flush=True)
    return launches, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from dclip_tpu_torch.cli import serve as cli_serve
    from dclip_tpu_torch.kernels import _build
    from dclip_tpu_torch.kernels import vit_block as vb

    from dclip_tpu_torch.core.flops import card_peaks

    global PEAKS
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    PEAKS = card_peaks("cuda")  # raises on a card the table does not name
    print(f"peaks: {PEAKS}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    seconds = _build.build(force=True)
    print(f"build: {seconds} s", flush=True)
    with open(_build.LOG_PATH) as f:
        for line in f:
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print("build:", line.strip(), flush=True)
    # The loader's path: the first load runs the self-check launch.
    _build.reset_launches()
    _build.load_library()
    loader_launches = dict(_build.LAUNCHES)
    print(f"load: self-check {json.dumps(_build.SELF_CHECK)}, launches "
          f"{json.dumps(loader_launches)}", flush=True)

    table = KernelTable(list(KERNELS) + list(TRAIN_KERNELS) + list(TEACHER_KERNELS)
                        + list(TRAINABLE_KERNELS) + list(TOPK_KERNELS)
                        + list(TEACHER_TRAIN_KERNELS) + list(L14_ROWS) + list(SIGLIP_ROWS))
    kernel_phase(torch, vb, card, table)
    gemm_phase(torch, card)
    service, args, launches = slice_phase(torch, np, vb, cli_serve, card)
    bf16_rows = cli_serve.bench(service, args, concurrencies=(1, 32))
    del service
    torch.cuda.empty_cache()

    train_kernel_phase(torch, np, card, table)
    xattn_kernel_phase(torch, np, card, table)
    loader_self_check_phase(torch, card, table)
    xattn_trainable_phase(torch, np, card, table)
    xattn_update_phase(torch, np)
    trainable_kernel_phase(torch, np, card, table)
    topk_kernel_phase(torch, np, card, table)
    eval_retrieval_phase(torch, np, card)
    eval_zero_shot_phase(torch, np, card)
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict

    sd = random_state_dict(CLIPConfig.vit_b_16(), seed=0)
    tsd = random_teacher_state_dict(_teacher_config(), seed=0)
    train_launches, default_ms = train_slice_phase(torch, np, sd, tsd, card)
    fused_launches = fused_slice_phase(torch, np, sd, tsd, card, default_ms)
    uncached_launches, _ = uncached_slice_phase(torch, np, sd, tsd, card)
    cache_levels_phase(torch, np, sd, tsd, card)
    target_agreement_phase(torch, np, sd, tsd)
    grad_agreement_phase(torch, np, sd, tsd)
    # The vision LN1 unfrozen at epoch 0: K9's LayerNorm weight gradients
    # are held too, beside the text LN2 / MLP ones of K8.
    from dclip_tpu_torch.core.config import UnfreezeStage

    grad_agreement_phase(torch, np, sd, tsd, "fused grads",
                         must_hold=("vision_model.encoder.layers.0.layer_norm1.weight",
                                    "text_model.encoder.layers.0.layer_norm2.weight",
                                    "text_model.encoder.layers.0.mlp.fc1.weight"),
                         **_fused_changes(unfreeze_schedule=(
                             UnfreezeStage(epoch=0, patterns=("layer_norm1",)),)))
    fit_phase(torch, np, sd, tsd, card)
    teacher_launches = teacher_slice_phase(torch, np, sd, tsd, card)
    teacher_fit_phase(torch, np, sd, tsd, card)
    dp_launches = dp_phase(torch, np, sd, tsd, card)
    teacher_grad_phase(torch, np, sd, tsd)
    int8_service, f32 = int8_phase(torch, np, cli_serve, card, bf16_rows)
    export_phase(torch, np, cli_serve, card, int8_service, f32)
    del int8_service, f32
    student_phase(torch, np, cli_serve, card)
    det_images, detections = detector_phase(torch, np, card)
    region_launches = region_token_phase(torch, np, det_images, detections, card, table)
    del det_images, detections
    region = {n: sum(r.get(n, 0) for r in region_launches.values())
              for n in list(KERNELS) + ["topk_streamed"]}
    jpeg = doctor_phase(card)
    l14_launches = l14_distill_phase(torch, np, card, table)
    files_phase(torch, np, card, jpeg)
    profiled = profile_phase(torch, np, card)
    tp_launches, tp_rows = tp_phase(torch, np, sd, tsd, card)
    serve_launches, serve_rows = serve_phase(torch, np, card)
    last_launches, context_rows = last_modules_phase(torch, np, card)
    siglip_launches = siglip_phase(torch, np, card, table)
    kernel_times_phase(torch, card, tolerant=False)

    counts = {**{n: launches[n] + region[n] for n in KERNELS},
              **{n: train_launches[n] for n in TRAIN_KERNELS},
              **{n: uncached_launches[n] for n in TEACHER_KERNELS if n in uncached_launches},
              "loader_self_check": loader_launches["loader_self_check"],
              **{n: fused_launches[n] for n in TRAINABLE_KERNELS},
              "topk_streamed": (launches["topk_streamed"] + uncached_launches["topk_streamed"]
                                + region["topk_streamed"]),
              "cross_attention_trainable": teacher_launches["cross_attention_trainable"],
              **{n: l14_launches[n.split("[")[0]] for n in L14_ROWS},
              **{n: siglip_launches.get(n.split("[")[0], 0) for n in SIGLIP_ROWS}}
    # Phase 33 runs the same kernels on the data-parallel path (K11 over the
    # gathered batch): its launches add to each kernel's row.
    for name in counts:
        if "[" not in name:
            counts[name] += dp_launches.get(name, 0)
    # Phase 34's profiled steps: ViT-B/16's add to the plain rows, ViT-L/14's
    # to the [l14] / [d768] rows.
    for name in counts:
        if "[" not in name:
            counts[name] += profiled[PROFILE_RUNS[0][0]].get(name, 0)
    for preset, _, _ in PROFILE_RUNS[1:]:
        for name in L14_ROWS:
            counts[name] += profiled[preset].get(name.split("[")[0], 0)
    sources = {**_kernel_sources(), **L14_ROWS, **SIGLIP_ROWS}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], **table.entry(name)}
               for name, (src, rep) in sources.items()]
    # Phase 35's ranks: their launches in `[tp]` rows, held and timed on
    # the calls the ranks made.
    kernels += [{"name": row, "route": "cuda", "source": sources[row[:-4]][0],
                 "replaces": sources[row[:-4]][1], "launches": tp_launches[row[:-4]], **entry}
                for row, entry in tp_rows.items()]
    # Phase 36's ranks: their main path's launches in `[serve_dp]` rows,
    # held and timed on the calls the ranks made.
    kernels += [{"name": row, "route": "cuda", "source": sources[row[:-10]][0],
                 "replaces": sources[row[:-10]][1], "launches": serve_launches[row[:-10]],
                 **entry} for row, entry in serve_rows.items()]
    # Phase 37's context view: K1 / K2 launches of its encode (both views)
    # in `[context]` rows, held and timed on the context view's calls.
    kernels += [{"name": row, "route": "cuda", "source": sources[row[:-9]][0],
                 "replaces": sources[row[:-9]][1], "launches": last_launches[row[:-9]],
                 **entry} for row, entry in context_rows.items()]
    print(f"chip_smoke: {time.perf_counter() - t_start} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _siglip_trainer(torch, np, sd, tsd, remat: bool):
    """The port's DistillTrainer with the SigLIP student (teacher CLIP the
    same; it never runs) on a synthetic batch of SIGLIP_B rows whose
    targets (seeded unit vectors, 1152 wide) are in the cache."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig.siglip_so400m_14_384()
    teacher = _siglip_teacher_config()
    batch = _batch(np, SIGLIP_B, clip_cfg=cfg, teacher_cfg=teacher)
    cache = TeacherTargetCache(salt="chip-smoke-siglip")
    config = _distill_config(SIGLIP_B, student_model="siglip-so400m-14-384",
                             teacher_clip_model="siglip-so400m-14-384", teacher=teacher,
                             packed_text=False, remat=remat)
    trainer = DistillTrainer(config, sd, sd, tsd, cfg, cfg, device="cuda", teacher_cache=cache)
    targets = np.random.RandomState(3).standard_normal(
        (SIGLIP_B, 2, cfg.projection_dim)).astype(np.float32)
    targets /= np.linalg.norm(targets, axis=-1, keepdims=True)
    cache.put_batch(cache.keys_for(batch), targets)
    return trainer, batch


def _siglip_teacher_config():
    from dclip_tpu_torch.core import TeacherConfig

    return TeacherConfig(embed_dim=1152, num_heads=8, max_patches=TEACHER_P, max_text_tokens=64)


def siglip_phase(torch, np, card: str, table: KernelTable) -> dict:
    """Phase 38 (module docstring): the SigLIP cell's kernel instances
    against their twins, then the trainer's steps with a SigLIP student.
    Returns the steps' launches, summed over remat off and on."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.kernels import mlp_frozen as mf
    from dclip_tpu_torch.kernels import vit_attention as va
    from dclip_tpu_torch.kernels import vit_block as vb
    from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(38)
    d, heads, mlp, eps = 1152, 16, 4304, 1e-6

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(dtype))

    def record(*args, **kw):
        _record(torch, card, table, *args, **kw)

    for variant, b, s in (("vision", SIGLIP_CHECK_B, 729), ("text", TRAIN_B, 64)):
        qkv = randn(b, s, 3 * d)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        g = randn(b, s, d)
        pairs, hd, io = float(b * s * s), d // heads, 2.0 * b * s * d
        stats = 8.0 * b * s * heads
        o, m, r, o_lo = va.self_attention_fwd_stats(q, k, v, heads, residual=True)
        o_ref, m_ref, r_ref, lo_ref = va.attention_reference(q, k, v, heads, stats=True,
                                                             residual=True)
        err = max(_bound_check(torch, f"attention_fwd[siglip {variant}] o", o, o_ref, REL_TOL),
                  _bound_check(torch, f"attention_fwd[siglip {variant}] m", m, m_ref, REL_TOL),
                  _bound_check(torch, f"attention_fwd[siglip {variant}] o + o_lo",
                               o.float() + o_lo.float(), o_ref.float() + lo_ref.float(),
                               REL_TOL))
        rel = ((r - r_ref).abs() / r_ref.abs()).max().item()
        print(f"kernel attention_fwd[siglip {variant}] rinv: max_rel_err {rel} bound {REL_TOL}",
              flush=True)
        if not rel <= REL_TOL:
            raise AssertionError(f"rinv[siglip {variant}] relative error {rel} > {REL_TOL}")
        # o_lo holds what rounding o to bf16 dropped: at most half an ulp of o.
        if not bool((o_lo.float().abs() <= 2.0**-8 * o.float().abs()).all()):
            raise AssertionError(f"o_lo[siglip {variant}] exceeds half an ulp of o")
        record("self_attention_fwd_stats[siglip]", err, True,
               lambda: va.self_attention_fwd_stats(q, k, v, heads, residual=True),
               lambda: va.attention_reference(q, k, v, heads, stats=True, residual=True), 5,
               variant, work(bf16_flops=4.0 * hd * heads * pairs, nbytes=5 * io + stats))
        o3 = va.self_attention_fused(q, k, v, heads)
        record("self_attention_fused[siglip]",
               _bound_check(torch, f"attention_fused[siglip {variant}]", o3, o_ref, REL_TOL),
               True, lambda: va.self_attention_fused(q, k, v, heads),
               lambda: va.attention_reference(q, k, v, heads), 5, variant,
               work(bf16_flops=4.0 * hd * heads * pairs, nbytes=4 * io))
        grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, o_lo=o_lo)
        want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, o_lo=lo_ref)
        errb = max(_bound_check(torch, f"attention_bwd[siglip {variant}] {n}", a, w, BWD_TOL)
                   for n, a, w in zip(("dq", "dk", "dv"), grads, want))
        again = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, o_lo=o_lo)
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"attention_bwd[siglip {variant}]: two calls differ")
        record("self_attention_bwd_stats[siglip]", errb, True,
               lambda: va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, o_lo=o_lo),
               lambda: va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads,
                                                  o_lo=lo_ref), 3, variant,
               work(bf16_flops=10.0 * hd * heads * pairs, nbytes=9 * io + stats))
        del qkv, q, k, v, g, o, m, r, o_lo, o_ref, m_ref, r_ref, lo_ref, grads, want, again
        torch.cuda.empty_cache()

    act = "gelu_pytorch_tanh"
    rows = SIGLIP_MLP_B * 729
    # The GEMM's tanh-GELU forms at fc1's (K = 1152) and fc2's / dx's (K = 4304) shapes.
    for variant, n, kk in (("fc1", mlp, d), ("k4304", d, mlp)):
        a, w = randn(rows, kk), randn(kk, n, scale=kk**-0.5)
        bias, aux = randn(n, scale=0.1, dtype=torch.float32), randn(rows, n)
        got, pre = vb.gemm_bias_act_residual(a, w, bias, gelu=True, save_preact=True, act=act)
        want, want_pre = vb.gemm_bias_act_residual_reference(a, w, bias, gelu=True,
                                                             save_preact=True, act=act)
        err = max(_bound_check(torch, f"gemm tanh[{variant}] y", got, want, REL_TOL),
                  _bound_check(torch, f"gemm tanh[{variant}] a1", pre, want_pre, REL_TOL),
                  _bound_check(torch, f"gemm tanh'[{variant}]",
                               vb.gemm_bias_act_residual(a, w, dgelu_of=aux, act=act),
                               vb.gemm_bias_act_residual_reference(a, w, dgelu_of=aux, act=act),
                               REL_TOL))
        record("gemm_bias_act_residual[siglip]", err, True,
               lambda: vb.gemm_bias_act_residual(a, w, bias, gelu=True, save_preact=True,
                                                 act=act),
               lambda: vb.gemm_bias_act_residual_reference(a, w, bias, gelu=True,
                                                           save_preact=True, act=act),
               5, variant, gemm_work(rows, kk, n, extra_mn=1))
        del a, w, bias, aux, got, pre, want, want_pre
        torch.cuda.empty_cache()

    lw = layer_weights(rng, torch, dev, d, mlp)
    p = mf.pack_frozen_mlp(lw["ln2_scale"], lw["ln2_bias"], lw["fc1_w"].t(), lw["fc1_b"],
                           lw["fc2_w"].t(), lw["fc2_b"], torch.bfloat16)
    x, g = randn(SIGLIP_MLP_B, 729, d), randn(SIGLIP_MLP_B, 729, d)
    y, a1 = mf.mlp_frozen_fwd(x, p, eps, act)
    y_ref, a1_ref = mf.mlp_frozen_fwd_reference(x, p, eps, act)
    err = max(_bound_check(torch, "mlp_frozen_fwd[siglip] y", y, y_ref, REL_TOL),
              _bound_check(torch, "mlp_frozen_fwd[siglip] a1", a1, a1_ref, REL_TOL))
    weights = 4.0 * d * mlp + 4.0 * (mlp + 3 * d)
    record("mlp_frozen_fwd[siglip]", err, True, lambda: mf.mlp_frozen_fwd(x, p, eps, act),
           lambda: mf.mlp_frozen_fwd_reference(x, p, eps, act), 5, "vision",
           work(bf16_flops=4.0 * rows * d * mlp,
                nbytes=4.0 * rows * d + 2.0 * rows * mlp + weights))
    dx = mf.mlp_frozen_bwd(x, g, a1, p, eps, act)
    errb = _bound_check(torch, "mlp_frozen_bwd[siglip] dx", dx,
                        mf.mlp_frozen_bwd_reference(x, g, a1_ref, p, eps, act), BWD_TOL)
    record("mlp_frozen_bwd[siglip]", errb, True, lambda: mf.mlp_frozen_bwd(x, g, a1, p, eps, act),
           lambda: mf.mlp_frozen_bwd_reference(x, g, a1_ref, p, eps, act), 5, "vision",
           work(bf16_flops=4.0 * rows * d * mlp,
                nbytes=6.0 * rows * d + 2.0 * rows * mlp + 4.0 * d * mlp + 4.0 * d))
    sc, bi = p["ln2_scale"], p["ln2_bias"]
    errl = _bound_check(torch, "layernorm[siglip]", vb.layernorm(x, sc, bi, eps),
                        vb.layernorm_reference(x, sc, bi, eps), REL_TOL)
    record("layernorm[siglip]", errl, True, lambda: vb.layernorm(x, sc, bi, eps),
           lambda: vb.layernorm_reference(x, sc, bi, eps), 20, "vision",
           work(f32_flops=8.0 * rows * d, nbytes=4.0 * rows * d + 8.0 * d))
    dh = randn(SIGLIP_MLP_B, 729, d, dtype=torch.float32)
    errl = _bound_check(torch, "layernorm_bwd[siglip]", mf.layernorm_bwd(x, g, dh, sc, eps),
                        mf.layernorm_bwd_reference(x, g, dh, sc, eps), REL_TOL)
    record("layernorm_bwd[siglip]", errl, True, lambda: mf.layernorm_bwd(x, g, dh, sc, eps),
           lambda: mf.layernorm_bwd_reference(x, g, dh, sc, eps), 20, "vision",
           work(f32_flops=12.0 * rows * d, nbytes=10.0 * rows * d + 4.0 * d))
    del lw, p, x, g, y, a1, y_ref, a1_ref, dx, dh
    torch.cuda.empty_cache()
    distill_loss_cases(torch, randn, card, table, d, (("b256", TRAIN_B, True, True),))
    torch.cuda.empty_cache()
    print(f"siglip: kernel checks in {time.perf_counter() - t0} s", flush=True)

    # (b) The trainer's cached step with the SigLIP student, remat off and on.
    cfg = CLIPConfig.siglip_so400m_14_384()
    sd = random_state_dict(cfg, seed=0)
    tsd = random_teacher_state_dict(_siglip_teacher_config(), seed=0)
    steps = WARMUP_STEPS + TIMED_STEPS
    counts: dict = {}
    params = {}
    for remat in (False, True):
        what = f"siglip cache-warm remat {'on' if remat else 'off'}"
        trainer, batch = _siglip_trainer(torch, np, sd, tsd, remat)
        if trainer.student.vision_model.encoder.remat != remat or not trainer._use_kernels:
            raise AssertionError(f"{what}: expected the kernels on and remat {remat}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_launches()
        ms = _run_steps(torch, np, trainer, batch, what, card, batch_size=SIGLIP_B)
        launches = _all_launches()
        expected = _expected(_student_per_step(trainer), steps)
        print(f"{what}: launches", json.dumps(launches), "expected", json.dumps(expected),
              flush=True)
        if launches != expected:
            raise AssertionError(f"{what}: launch counts {launches} != {expected}")
        print(f"{what}: {ms} ms/step, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30} GiB (B={SIGLIP_B}; {card})",
              flush=True)
        for k, n in launches.items():
            counts[k] = counts.get(k, 0) + n
        params[remat] = {n: p.detach().cpu() for n, p in trainer.student.named_parameters()
                         if p.requires_grad}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    _hold_remat(torch, "siglip cache-warm", params, steps)
    print(f"siglip: phase in {time.perf_counter() - t0} s", flush=True)
    return counts


def siglip_main() -> int:
    """Phase 38 alone (`--siglip`): its rows of the kernels line."""
    import numpy as np
    import torch

    from dclip_tpu_torch.core.flops import card_peaks
    from dclip_tpu_torch.kernels import _build

    global PEAKS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    PEAKS = card_peaks("cuda")
    print(f"build: {_build.build()} s", flush=True)
    table = KernelTable(list(SIGLIP_ROWS))
    launches = siglip_phase(torch, np, card, table)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches.get(n.split("[")[0], 0), **table.entry(n)}
        for n, (src, rep) in SIGLIP_ROWS.items()]}), flush=True)
    return 0


def kernel_times_phase(torch, card: str, which: str = "all", tolerant: bool = True) -> dict:
    """Phase 39: {case: ms a call, or with `tolerant` the error's text}
    (module docstring); `which`: "all", "new" (SigLIP's shapes) or
    "existing" (the others)."""
    from dclip_tpu_torch.kernels import distill_loss as dl
    from dclip_tpu_torch.kernels import mlp_frozen as mf
    from dclip_tpu_torch.kernels import vit_attention as va
    from dclip_tpu_torch.kernels import vit_block as vb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)

    def attention(b, s, d, heads, masked):
        qkv = randn(b, s, 3 * d)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        kw = {}
        if masked:
            kw = {"causal": True, "padding_mask": (torch.arange(s, device=dev)[None]
                                                   < torch.randint(8, 25, (b, 1), device=dev,
                                                                   generator=gen)).float()}
        o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
        g = randn(b, s, d)
        return ((lambda: va.self_attention_fwd_stats(q, k, v, heads, **kw)),
                (lambda: va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)))

    def frozen_mlp(b, s, d, mlp, act):
        kw = {} if act == "quick_gelu" else {"act": act}
        p = mf.pack_frozen_mlp(randn(d, scale=0.1, dtype=torch.float32) + 1,
                               randn(d, scale=0.1, dtype=torch.float32),
                               randn(mlp, d, scale=d**-0.5), randn(mlp, scale=0.1,
                                                                    dtype=torch.float32),
                               randn(d, mlp, scale=mlp**-0.5), randn(d, scale=0.1,
                                                                     dtype=torch.float32),
                               torch.bfloat16)
        x, g = randn(b, s, d), randn(b, s, d)
        _, a1 = mf.mlp_frozen_fwd(x, p, 1e-6, **kw)
        return ((lambda: mf.mlp_frozen_fwd(x, p, 1e-6, **kw)),
                (lambda: mf.mlp_frozen_bwd(x, g, a1, p, 1e-6, **kw)))

    def layernorm(rows, d):
        x, g = randn(rows, d), randn(rows, d)
        sc, bi = randn(d, dtype=torch.float32) + 1, randn(d, scale=0.1, dtype=torch.float32)
        dh = randn(rows, d, dtype=torch.float32)
        return (lambda: vb.layernorm(x, sc, bi)), (lambda: mf.layernorm_bwd(x, g, dh, sc))

    def distill(b, d):
        si, st = randn(b, d), randn(b, d)
        ti, tt = randn(b, d, dtype=torch.float32), randn(b, d, dtype=torch.float32)
        cts = torch.ones(3, device=dev)
        return ((lambda: dl.distill_loss_fwd(si, st, ti, tt)),
                (lambda: dl.distill_loss_bwd(si, st, ti, tt, cts)))

    cases = {
        "attention hd72 siglip vision [256,729,1152]": lambda: attention(256, 729, 1152, 16, False),
        "attention hd72 siglip text [256,64,1152]": lambda: attention(256, 64, 1152, 16, False),
        "attention hd64 b16 vision [256,197,768]": lambda: attention(256, 197, 768, 12, False),
        "attention hd64 b16 text causal+pad [256,77,512]": lambda: attention(256, 77, 512, 8, True),
        "attention hd64 l14 vision [256,257,1024]": lambda: attention(256, 257, 1024, 16, False),
        "mlp_frozen siglip tanh [256,729,1152] mlp 4304":
            lambda: frozen_mlp(256, 729, 1152, 4304, "gelu_pytorch_tanh"),
        "mlp_frozen l14 quick [256,257,1024] mlp 4096":
            lambda: frozen_mlp(256, 257, 1024, 4096, "quick_gelu"),
        "layernorm d1152 rows 186624": lambda: layernorm(256 * 729, 1152),
        "layernorm d1024 rows 65792": lambda: layernorm(256 * 257, 1024),
        "layernorm d768 rows 50432": lambda: layernorm(256 * 197, 768),
        "distill_loss d1152 b256": lambda: distill(256, 1152),
        "distill_loss d768 b256": lambda: distill(256, 768),
        "distill_loss d512 b256": lambda: distill(256, 512),
    }
    out = {}
    for name, make in cases.items():
        new = "siglip" in name or "d1152" in name
        if which != "all" and new != (which == "new"):
            continue
        try:
            fwd, bwd = make()
            out[name + " fwd"] = time_one(torch, fwd, 10)
            out[name + " bwd"] = time_one(torch, bwd, 10)
        except Exception as err:  # noqa: BLE001 - a tree without the shape
            if not tolerant:
                raise
            out[name] = f"not run here: {type(err).__name__}: {str(err)[:120]}"
        torch.cuda.synchronize()
    for name, ms in out.items():
        print(f"[kernel_times] {name}: {ms if isinstance(ms, str) else f'{ms:.4f} ms'}",
              flush=True)
    return out


def kernel_times_main(argv) -> int:
    """Phase 39 alone (`--kernel-times [all|new|existing]`)."""
    import torch

    from dclip_tpu_torch.kernels import _build

    print(f"card: {card_line()}", flush=True)
    print(f"build_s {_build.build()}", flush=True)
    out = kernel_times_phase(torch, card_line(), argv[0] if argv else "all")
    print(json.dumps({"kernel_times": out}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--siglip"]:
        sys.exit(siglip_main())
    if sys.argv[1:2] == ["--kernel-times"]:
        sys.exit(kernel_times_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-rank"]:
        sys.exit(serve_rank_main(sys.argv[2:]))
    sys.exit(main())
