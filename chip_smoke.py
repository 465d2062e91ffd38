#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (znicz_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. prints the card's name and power limit (``nvidia-smi``), then builds
   every kernel from ``znicz_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` a source, all at once) and prints the
   compiler's register/shared-memory lines, each source's build time
   and the TMA forward's shared memory by width; a spill fails the
   phase;
2. kernels: holds each kernel against its plain PyTorch version on the
   card, within the tolerance printed beside each case — the flash
   kernels (B7–B9) in bf16 and f32, at head dims 64, 128, 32, 256, 512
   and the zero-padded 8, 40, 96, 200 and 264, causal, with offsets and
   ragged lengths (in f32 also at the tile edges of the forward and the
   backward, and on views whose rows are off 16-byte boundaries), fully
   masked rows exactly at out 0 and lse −1e30, and the
   dh = 4 attention core launching none of them; the layer norm both
   ways (B5, B6) on both of its routes, each case on the one it must
   take: the register kernels at the sequence stack's training shape in
   both dtypes, serving's 2048-row bucket, the widest row (1024), 3
   vectors a lane and ragged row counts, the general kernels on a width
   that is not a multiple of 8, one past 1024, views off 16-byte
   boundaries and B6 at D = 25,608 with β and 51,208 without (their
   columns walked in chunks); B6's sums the same bits on a rerun; the
   timed shapes in
   CUDA graphs over three rotating input copies, B6's two launches (rows,
   fold) apart from a profiler window; the LRN both ways (B1, B2) on both
   of its routes,
   each case on the one it must take: the vector kernels at AlexNet's
   two shapes in both storage dtypes, n = 5 and 4, at their edges (one
   vector a row, n = 19, mixed dtypes, tiles left short), the general
   kernels on an odd channel count, on views off 16-byte boundaries and
   at C = 16,392 with n = 5 and 257 (the channels tiled, the halos
   staged); the two AlexNet shapes timed over a rotation of three input
   copies, as conv2's bf16 input would fit the 50 MB L2, the kernels in
   CUDA graphs; dropout (B3) on both of its routes, bitwise against
   its plain version, forward and backward masks identical, the keep
   fraction within 4σ, ratio 0 the identity; softmax + argmax (B4) on
   both of its routes with planted ties, a −inf column and a row of
   NaNs, the serving buckets' (16, 8) timed beside the head's
   (128, 1000); an empty kernel's launch timed as the floor under B3's
   and B4's bounds. Times the kernel, the plain version
   and one PyTorch library call for the same function (a yardstick only
   — the port never calls it; B3's and B4's three through CUDA graphs,
   as their kernels take less time than their wrappers) and computes the
   bound (the least time the card could take: bytes over 3.35 TB/s or
   operations over the peak rate for their type, the larger);
3. serving: writes a full-width bf16 scorer bundle in the reference
   format (attention 8 heads → layer_norm → softmax over 8 classes,
   T=2048, D=512, weights from a fixed seed), serves ragged requests of
   1, 3 and 16 rows through ``ServingEngine(max_batch=16)``, each bucket
   a CUDA graph captured at ``start()`` (5 captures), checks that B7,
   B5 and B4 launched exactly once a dispatch (the replay accounting),
   B5 and B4 on their register routes only, times the closed loop with
   the buckets eager and graphed in turns (p50, rows/s, peak device
   memory), and holds the 1-row reply against
   ``ExportedModel.load(path, device="cpu")``;
4. sequence training: the same stack (bf16, momentum SGD on every
   layer as ``benchmarks/seq_bench.py`` trains it, at a tenth of its
   rate, :data:`SEQ_GD`) through the port's
   ``StandardWorkflow`` on 4 × 16 samples made from a fixed seed,
   ``initialize()`` with no device (the card), 2 warm-up and 10 timed
   train steps; B4–B9 launch once a step, B4, B5 and B6 on their
   register routes only (as in phase 6); prints the step time,
   tokens/s, MFU, the device time of each unit, the profiler's busy
   share and top kernels and the peak memory; then holds one train
   step on the card (B=2, full T and D) against the same step on the
   CPU;
5. AlexNet training: ``models/samples/alexnet.py`` at full width (bf16,
   B=128, dropout 0.5, uint8 frames resident on the card), 2 warm-up
   and 10 timed train steps; B1 and B2 launch twice a step (at conv1's
   and conv2's shape, both on the vector route), B3 four times (on its
   vector route) and B4 once (on its register route); prints step time,
   img/s, MFU (``bench.py``'s FLOP
   count), the device time of each unit, the busy share and top
   kernels and the peak memory; then holds one train step at B=2 with
   dropout on against the CPU's, each parameter's update in f32 and in
   bf16 (bf16 against its own rounding noise, the CPU's bf16 step
   against its f32 step), and shows that a planted wrong dropout mask
   fails that check;
6. the sequence stack of phase 4 in f32 (the default precision, the
   f32 flash kernels), timed the same way: 2 + 10 steps, the step time,
   tokens/s, MFU against the f32 peak, the device time of each unit and
   the busy share and top kernels, and one train step at B=2 against
   the CPU's (within ``TRAIN_STEP_TOL_F32``); then a few train steps
   each at dh = 32 (the 32-wide bf16 instantiation), at dh = 256 in
   bf16 and in f32 (2 heads of 256 at D = 512), at dh = 512 in bf16 and
   in f32 (1 head of 512, column chunks past 256) and at
   dh = 4 (the ``attention_seq`` sample, whose attention takes the plain
   core and launches no flash kernel);
7. CIFAR-10 through ``Main().run(["cifar", ...])`` on the card: 8 epochs
   of the synthetic stand-in, B1/B2 and B4 launch counts, validation
   error by epoch under 45 %, step time, img/s, per-unit times and busy
   share; two runs resumed with ``-s`` from the snapshot the
   uninterrupted run wrote at the end of epoch 6 stay within 1e-5 of it
   after one train step and 1e-2 at the end, counters equal, and runs
   resumed from two planted faults must fail that check;
8. the three training paths with their regions as CUDA graphs (phases
   4–7 run them eagerly, as a ``mark``ed step runs, as before the port
   had graphs): CIFAR-10 through ``Main().run(["cifar",
   "--chunk", "16", ...])`` for 8 epochs (launch counts exact through
   the replay accounting, one capture a key and none after the first
   epoch, the validation bar of phase 7), the last epoch resumed from
   phase 7's snapshot graphed step by step and in chunks against phase
   7's eager run (1e-5 after the first two train steps, 1e-2 at the end,
   counters equal), the train step graphed and 16 a dispatch beside the
   eager one, ``--dump-graph`` naming the region; AlexNet at B = 128
   graphed (B1–B4 counts, the step beside phase 5's, each step's dropout
   seed that of phase 5's eager step, outputs zero wherever their step's
   mask drops and masks new each step, and a planted fault — the seed
   passed by value, frozen in the capture — caught by that check); the
   bf16 sequence stack graphed (B4–B9 counts, the step beside phase
   4's).  AlexNet and the sequence stack also run 3 steps eager and 3
   graphed (the capture's warm-up, then replays) from one seed, each
   state tensor held to the eager run's within 2⁻⁸ and the counters
   equal, and a planted fault (the head's update left out of the
   capture) must fail that check.  In each path's profiled window the
   launches the wrappers counted (on a graphed path, through the replay
   accounting) must be the hand-written kernels the profiler saw run.
   Each time is printed beside the card's name and power limit;
9. the MLP family, graphed, through ``Main().run([...])``: MNIST
   784-100-10 for three epochs of the synthetic stand-in (B4 at
   (100, 10) once a step on its register route, one capture a key, the
   validation error by epoch), the MNIST-784 autoencoder (the MSE loss,
   no hand-written kernel, the MSE by epoch falling; one train step on
   the card against the CPU's per parameter within ``TRAIN_STEP_TOL``)
   and Wine with an exponential learning-rate schedule on both layers
   and the confusion counts (B4 at (10, 3); after every step
   ``lr_state`` read back equals the policy's rate, the train key
   captured once while the rate changes every step, the counts
   consistent with the error counts; a ``FixedPolicy`` run bit-equal to a run with no
   schedule; ``--chunk 8`` writes the rate once a chunk).  Each is timed
   graphed and eager in turns (Wine also with and without its
   schedule), its profiled windows' counts checked as in phase 8, and
   held graphed against eager from one seed (``MLP_GRAPH_TOL``) with a
   planted fault that must fail the check: the head's update left out
   of the capture (MNIST, the autoencoder) or the rates passed as
   floats, frozen in the capture (Wine); an adjuster that rebinds
   ``lr_state`` must raise at the next replay.  The phase prints which
   Wine data the card used (the UCI set needs scikit-learn).
10. the token LM and the LSTM chain, bf16: the byte LM
   (``benchmarks/serve_bench.py``'s ``train_and_export_lm`` chain at the
   sequence stack's widths, a layer_norm before the head: embedding
   (256, 512) → pos_encoding → causal attention, 8 heads of 64 →
   layer_norm → last_token → softmax over 256; T=2048, B=16, the
   reference's synthetic next-token task from a seed) trained eager and
   then graphed, 2 + 10 steps each: B7–B9 causal, B5, B6 and B4 at
   (16, 256) once a step (the graphed counts through the replay
   accounting), step time, tokens/s, MFU, per-unit times, busy share, top
   kernels, peak memory; graphed and eager in turns; 3 graphed steps
   against 3 eager from one seed (2⁻⁸) with the embedding's update left
   out of the capture planted; one step at B=2 against the CPU
   (``TRAIN_STEP_TOL``); the embedding's gradient the same bits on
   reruns.  Then ``run_accumulated(4)`` at 16 rows a microbatch,
   graphed, for one epoch: captures for validation, accumulate and
   apply, flat after the first optimizer step; B7–B9 4 times an
   optimizer step; the parameters after 3 optimizer steps against a
   fused run of 64-row minibatches (``LM_ACCUM_TOL``), graphed against
   eager (2⁻⁸), and two planted faults caught (the apply phase not
   dividing by M, accumulate phases that write the parameters); the
   optimizer step's time beside the fused step's.  Then the trained LM
   exported (``kind`` "lm", the reference's ``sequence`` block, written
   out here as ``LM_SEQUENCE``) and served through
   ``ServingEngine(max_batch=16)``, graphed, with 1, 3 and 16 rows of
   2048 ids (B7 causal, B5 and B4 once a dispatch, the 1-row reply
   against the CPU within ``SLICE_TOL``, p50 and rows/s eager and
   graphed in turns).  Then the LSTM chain, embedding
   (256, 512) → lstm (512) → softmax (256) at T=256 (the recurrence is
   serial), eager and graphed, timed, graphed against eager, one step
   against the CPU, B4 counted, the embedding's gradient rerun; and one
   train step of conv → to_sequence → attention → softmax (bf16) against
   the CPU.
11. the A1b options (under a minute): Wine on the numpy oracle
   (``NumpyDevice``: no region, every unit's ``numpy_run``) against the
   card, f32, after 3 train steps (``ORACLE_TOL``); ``engine.debug_checks``
   on the graphed bf16 sequence stack and on AlexNet: 2 + 5 steps with
   the checks off and, on a second workflow from the same seed, on,
   every state tensor bit-equal, the flags written a step counted; the
   checks switched on (one more capture) and off (none); a NaN planted
   in place in the layer norm's γ (AlexNet: conv1's weights) must raise
   naming that unit; the step time on beside off;
   ``engine.fp8_matmul``: ``mxu_dot`` on ``torch._scaled_mm`` against its
   plain version at MNIST's and the byte LM's product shapes
   (``FP8_TOL``), timed in CUDA graphs beside the bf16 and f32 products,
   what ``_scaled_mm`` refuses unpadded, the overflow case (±463.9,
   ±464, ±464.1, ±inf) against the CPU with a saturating cast planted in
   place of ``q8``, which must fail it; MNIST 784-100-10 and the byte LM
   graphed with the lever on, beside their f32 and bf16 steps, every
   product on ``_scaled_mm``, graphed against eager from one seed with a
   planted fault caught.
12. the small vision samples and the conv autoencoders, graphed, f32:
   ``hands``, ``yale_faces`` and ``channels`` through ``Main().run([...])``
   for 8 epochs each (B4 once a step at (40, 2), (20, 15) and (50, 8) on
   its register route, counted through the replay accounting; one
   capture a key; the best validation error under the reference test's
   bars, 15 %, 25 % and 30 %; the step graphed and eager in turns);
   ``mnist_ae`` (B = 100, 28² → 12² → 6² and back) and ``imagenet_ae``
   (B = 64, 216² → 53² → 27², the pool's last window cut, and back) at
   full width through ``Main().run([...])`` for 3 epochs (imagenet_ae
   at its default learning rate, printed, then at ``AE_LR``; no
   hand-written kernel; the validation and train MSE falling; step time,
   img/s, peak memory, graphed and eager in turns; 3 graphed steps
   against 3 eager from one seed within ``MLP_GRAPH_TOL`` with the
   deconv's update left out of the capture planted; one train step
   against the CPU's within ``TRAIN_STEP_TOL_F32``, which a planted
   depooling that scatters every window to its first cell must fail;
   imagenet_ae's bf16 step against the CPU's bf16 step within
   ``TRAIN_STEP_TOL``); the trained mnist_ae exported (its ties in the
   manifest) and served through ``ServingEngine(max_batch=16)``, graphed,
   with 1, 3 and 16 rows, the 1-row reply against the CPU's within
   ``SLICE_TOL``, p50 and rows/s eager and graphed in turns; then mnist_ae with ``tied_weights`` graphed: after 10
   train steps the conv's and the deconv's weights one moved storage
   (a deconv untied to a copy, planted, must fail that), and graphed
   against eager with the deconv's update left out of the capture
   planted.  Phase 2 also times B4 at the three new heads' shapes
   beside ``torch.softmax``; channels' 8-class launches count in the
   ``softmax_argmax_small`` row.
13. the RBM, the Kohonen map and the last op units, graphed, f32:
   ``mnist_rbm`` (64 visible → 48 hidden, B = 32) through
   ``Main().run(["mnist_rbm"])`` for its 25 epochs (no hand-written
   kernel, two captures: train and eval; the best validation MSE under
   0.75 × the first epoch's, the reference test's bar; the step graphed
   and eager in turns; one train step against the CPU's within
   ``TRAIN_STEP_TOL_F32``; 20 steps across an epoch's end graphed
   against eager from one seed, every state tensor bit-equal, with the
   weight update bound to a new tensor planted, which that check must
   catch); ``kohonen`` (an 8 × 8 map, B = 40) the same way for its 12
   epochs (the best quantization error under 0.5 × the first epoch's,
   the neurons used by epoch; 25 steps graphed bit-equal to eager, and
   the decision's reset of the hits by rebinding planted, which a
   replay refuses); the cutter chain, conv (5 × 5, 16) → cutter (2) →
   max_pooling → all2all (64) → softmax (10) on synthetic 32 × 32 RGB
   images at B = 100, with a ``ZeroFiller`` masking a third of the
   conv's weights in the step's graph and an ``ImageSaver`` linked,
   through
   ``run_chunked(8)``, which falls back to per-step replays (B4 once a
   step at (100, 10) on its register route, in the
   ``softmax_argmax_cifar`` row; the masked weights exactly 0; the
   saver's PNGs read back, pixels equal to their samples'; the step
   graphed and eager in turns; one train step against the CPU's); and
   the filter similarity of the trained conv (``diversity``'s Gram
   product) on the card against numpy within ``DIVERSITY_TOL``.
14. serving graphed, on phase 3's bf16 scorer (B ≤ 16): 5 captures at
   ``start()`` that stay 5 through every step below, B7, B5 and B4 once
   a dispatch; graphed replies against eager ones at 1, 3 and 16 rows
   (``SERVE_GRAPH_TOL``); ``SWAPS`` hot swaps between the bundle and a
   perturbed twin while a thread sends requests, every reply one weight
   set's bit for bit, the publish's pause and the staging time printed;
   ``SwapIncompatible`` candidates leaving the replies bit-identical; a
   bucket above the ladder captured while another thread stages a swap;
   a planted rebinding swap caught by the next replay; the journal of
   the swaps, and an event dropped and counted under
   ``observe.recorder_stall``; ``serving.program_error`` retried to
   success and ``serving.latency_spike`` expiring a deadlined request
   whose rows never reach a graph, both counted; every served request
   traced with its queue and dispatch phases; the shadow audit at rate
   1 clean on every batch, and a planted ``sdc.serving_bitflip``
   corrected from the oracle, the engine suspect, the hook called once
   (the audit's host time printed); then the int8 twin
   (``quantize_bundle``) served graphed, its 1-row reply against the
   int8 numpy oracle (``INT8_ORACLE_TOL``) with the same argmax, its
   3- and 16-row replies against it and each other on their shared
   rows (``INT8_ROWS_TOL``), its ``bytes_ratio`` and resident weight
   bytes printed.
15. decode, through ``DecodeEngine`` on the card, each decode program a
   CUDA graph: the byte LM of phase 10 without its layer norm (the
   decoder takes none; bf16, trained graphed at T = 64 until the
   validation error is under 5 % or a step cap, which it prints), a
   drafter (the same chain at D = 128) and the LSTM chain of phase 10
   (its seed's weights), at 16 lanes, sequences to 2048 tokens,
   16-token pages and prompts to 1024 (LSTM: 256) in steps of 64.  The
   paged, prefix-sharing, speculative engine's captures at ``start()``
   equal its programs and stay flat through a ragged mix of 32 prompts
   of 1–1024 tokens with 16–256 new tokens and 3 hot swaps (TTFT and
   per-token p50/p99, the prefix hit and draft acceptance rates
   printed); greedy tokens equal the CPU engine's on the same bundle
   and prompts for flat, paged, paged + prefix sharing, paged +
   speculative, self-drafted (every draft accepted), int8 KV pages, int8
   weights and the LSTM chain flat and paged — where two sequences
   part, the CPU's top-two logit margin there must be under
   ``TIE_TOL`` (the count of such ties printed); the first-token
   logits within ``DECODE_LOGIT_TOL`` of the CPU's; the graphed engine
   against the same engine eager, tokens equal and logits bit-equal;
   tokens/s for the flat, paged and speculative arms at equal KV bytes
   in turns, KV bytes a lane f32 and int8, warmup seconds, captures and
   peak device memory; and three planted faults caught: a paged write
   that rebinds its pool, a swap that leaves the prefix cache stale
   (tokens other than a fresh engine's on the new weights), a swap that
   rebinds a weight (and a cache rebound at the model), each refused.
   Decode launches none of B1–B9: its path's counts are all 0.
16. parallelism: (a) ``Launcher()`` through the env contract
   (``ZNICZ_COORDINATOR`` on a free port, one process) starts an NCCL
   world of one and gives the card with a (data 1, model 1) mesh; the
   sequence stack of phase 4 trains graphed on it, its gradient fold and
   the evaluator's sums all-reduces captured in the step's graph, held
   to the one-process graphed step (expected bit-equal), timed in turns
   beside it (ratio printed), the group's backend ``nccl`` and NCCL in
   a profiler window; then AlexNet (B = 128, bf16, dropout on) for 3
   graphed steps on it, B1–B4 counted, held to one process (expected
   bit-equal, the same dropout seeds); (d) B3 with its block map at
   fc6/fc7's (128, 4096): 4 row blocks (the data layout), 2 column
   blocks (the tensor-parallel one), 2 × 2, and columns cut at 2044
   (the general kernel), each block's output and backward bit-equal to
   the slices of one launch over the whole and to the plain version,
   a block timed; dropout, stochastic pooling and ``Binarization`` run
   as each rank of a data axis of 4 would, their draws stacked equal to
   one draw over the batch; (b) the ring fold (``LocalRing``, 4 members of 512
   rows in one process) at the stack's attention, (16, 2048, 8, 64), in
   bf16 and f32, non-causal and causal: 16 hops of B7 forward and 16 of
   B8 and of B9 backward, counted, the output and dq, dk, dv held to one
   whole-sequence B7/B8/B9 call and to the same fold on the plain
   versions (``RING_TOL``), timed beside the whole-sequence call, and a
   remote hop's key offset planted one tile off caught; (c)
   ``run_pipelined(2 stages, M = 4)`` of the stack graphed (one graph an
   op, 16 captures) against ``run_accumulated(4)`` graphed on the same
   data, expected bit-equal, with the measured bubble and both arms'
   peak device memory;
17. the input plane: the alexnet sample's synthetic set (1024 train and
   128 validation frames, 227×227×3 uint8) written as shards under
   ``build/``, then AlexNet at B = 128 in bf16, graphed, for 3 epochs
   through ``StreamingLoader`` (``prefetch_depth=2``: page-locked
   staging ring, side-stream uploads, each batch copied in place into
   the graph's input) and through the resident ``ArrayLoader``, epoch
   by epoch in turns: every delivered batch equal to the set's rows at
   its schedule entry exactly, the parameters within ``CIFAR_EPOCH_TOL``
   of the resident run's, B1–B4 counted on both paths (equal); the
   train and validation step times of both, the input wait p50/p99, the
   share of the input's time hidden, the H2D bytes a step, the ring's
   page-locked bytes and the staging tensors', the pinned H2D and the
   in-place D2D timed alone; a delivery that rebinds ``minibatch_raw``
   must be refused by the next replay, and ``loader.reader_death`` fired
   mid-epoch must restart the pipeline with every batch still exact;
   (b) image decode on the card: the native pool built with g++ from
   the checkout (its own JPEG and PNG decoders; its library's
   DT_NEEDED naming zlib and neither libjpeg nor libpng), a
   class-per-subdirectory tree of 16 × 64 ImageNet-sized frames written
   with PIL (70 % baseline JPEG at quality 90 and 4:2:0, 10 %
   progressive, 5 % each 4:4:4, grayscale, restart markers and PNG) and
   every file decoded by the pool at its own size held to PIL's decode
   (JPEGs within one level, with the count printed, PNGs bit-equal, no
   failure), ``imagenet`` trained from the tree through ``python -m
   znicz_tpu_torch`` at its defaults (1000 classes, B = 128, 227
   crops): its validation step and 6 graphed train steps (11 or 16
   where a profiler window lost a record and was repeated), the
   replays' step time between CUDA events, the pool's wait, the
   device's busy share, the wrappers' counts against the kernels the
   profiler saw, no capture after the first graphed step, finite
   losses, no anomaly, B1–B4 exactly once a layer a step; the pool's
   decode rate over the whole tree at 256 resize and 227 crop with 1, 4
   and all threads beside the step's demand and PIL's one thread at a
   time over every 7th file (``tools/decode_ab.py``, in turns); ``hands``, ``yale_faces`` and ``channels`` over PNG trees,
   3 graphed epochs each, B4 once a step.
18. resilience, with the anomaly guard and the SDC fingerprints on, the
   default (every phase before runs with them too): (a) AlexNet at B =
   128 in bf16, graphed, and the full-width sequence stack: the step's
   p50 and mean with the guard on, off and on without its per-step read,
   in turns; the kernels' launches a step the same guarded and not, the
   clean steps reading no anomaly; ``train.nonfinite_loss`` at one step and
   ``train.nonfinite_grad`` at another, each leaving every parameter and
   momentum tensor bit-equal with no new capture, the totals (1, 1);
   five injected steps in a row rolled back to a snapshot written before
   them (a step after them: the card reads the guard's state a step
   behind), the graphed run going on after; a clean guarded step against
   the unguarded one from that snapshot, beside two unguarded ones (conv
   backward adds with atomics); (b) the byte LM's
   ``run_accumulated(4)`` graphed and guarded, a NaN in one microbatch
   of one optimizer step skipping the whole step; (c) MNIST 784-100-10
   guarded bit-equal to unguarded, ``sdc.flip_param`` localized by the
   sticky self-check and the vote of a world of one, ``sdc.flip_grad``
   caught by the shadow audit on the numpy oracle after a clean audit;
   (d) the full-width stack trained and published into phase 14's
   graphed scorer engine under a closed loop of requests: promoted,
   ``publish.corrupt`` refused by the watcher, ``swap.canary_regress``
   refused at the canary, ``swap.probation_fail`` rolled back, no new
   capture, every reply one version's; (e) the ``ElasticSupervisor``
   with one-process gangs of ``elastic_worker`` on the card:
   ``host.preempt`` → the checkpoint on signal → a restart from it,
   bit-equal to an uninterrupted run (gangs of several processes need
   a card each and stay on the CPU under gloo).
19. serving at scale and ops: (a) one ``FleetEngine`` holds the
   phase-3 scorer at v1 (two replicas sharing one graphed model) and v2
   (perturbed weights) at 0.75/0.25 traffic, and phase 15's decode LM
   as ``kind="lm"``, for tenants ``hi`` (priority 0) and ``lo``
   (priority 2, a token bucket, a deadline, a queue bound): every reply
   of a closed loop of 1–16 rows is one version's lone-engine reply for
   the same rows in the same bucket bit for bit, and within
   ``SLICE_TOL`` of that version's CPU reply; the split is exact; decode's
   greedy tokens equal a lone ``DecodeEngine``'s; ``hi``'s p50 and p99
   alone and under ``fleet.tenant_flood`` (lo's shed, preempted and
   expired counts; hi sheds and fails nothing); (b) ``fleet.replica_loss``
   repaired by ``FleetAutoscaler`` with no new capture; (c) a shared
   budget of 7 programs over two ladders of 5 evicting the
   low-priority model's buckets, each re-capture counted and every
   reply its lone engine's; B7, B5 and B4 (8 classes) counted on the
   ``fleet`` path; (d) ``WebStatusServer`` on 127.0.0.1: ``/healthz``
   200, ``/readyz`` 200 with the tenants and 503 while
   ``serving.program_error`` holds an engine's breaker open,
   ``/metrics`` with the ``znicz_fleet_*`` series; (e) the kernel-library
   store: this process fills a fresh one; child processes on a copy of
   the package with an empty ``build/`` load all nine libraries from it
   with an ``nvcc`` that refuses to build, rebuild exactly one after
   ``aotcache.corrupt``, import the pack ``publish_bundle`` wrote beside
   a bundle through ``PublicationWatcher``; each child's reply bit-equal
   to this process's, and the cold start to the first reply printed with
   a store hit and, with phase 1's build in place of the load, with the
   build.

20. disaggregated decode: phase 15's LM at its full width and geometry
   through ``DisaggEngine`` (2 prefill and 2 decode workers over private
   paged caches, at most 4 of each, all partitions of one model's
   arena): (a) greedy tokens equal to the fused ``DecodeEngine``'s on the
   card and to the CPU engine's for ``CPU_LENGTHS`` (a parting only at a
   CPU tie under ``TIE_TOL``), prefix sharing and copy on write in the
   prefill workers, the LSTM chain's carry handoff against the CPU; (b)
   the decode pool grown from 2 to 4 and a killed worker repaired by
   ``PoolAutoscaler`` with no new capture; (c) the interference arm: 8
   lanes decoding 512 tokens while 16 prompts of 1024 tokens land
   mid-stream, the per-token p99 with and without the burst, fused and
   disaggregated in turns, median of 3 (a finding: on one card both
   pools share the chip and the model's dispatch lock); (d) the spill
   arm: 32 system prompts of 256 tokens served twice through a page
   pool a quarter of their pages with a host-DRAM tier behind each
   prefill worker's trie, restores counted, the hit rate within 10 % of
   an all-device pool's and the tokens its; (e) dropped handoffs
   (``disagg.handoff_drop``) retried on a fresh prefill, ``balanced()``
   true; (f) the handoff's and the restore's ms and bytes a page.
21. the report chain: which of matplotlib and pyzmq import (without
   matplotlib the plotters run with the render thread off, as
   ``--no-graphics`` runs them, and no PNG may be claimed; without
   pyzmq the live-viewer arm is skipped with a line); (a) MNIST
   784-100-10 (f32, B = 100, the confusion counts on) for 3 epochs
   graphed, in turns with and without the side units (the error,
   confusion and 28 × 28 weights plotters, a weight histogram, the
   report publisher in md, html and json): no capture more with them,
   the parameters bit-equal, 3 × 4 lines in ``events.jsonl``, the
   confusion matrix's trace the validation count less the last epoch's
   errors, the report's metrics the decision's and fired once under
   ``run`` and under ``run_chunked(8)``, the step time (CUDA events,
   median of the epochs) with and without them and the host time of an
   epoch's firing; (b) ``KohonenHits`` on kohonen and ``MSEHistogram`` on
   mnist_ae on short graphed runs: the hit map sums to the epoch's
   samples, the histogram to the minibatch, no capture more; (c)
   ``ChannelSplitter`` in a captured region: bit-equal to ``numpy_run``
   at the captured addresses, a rebound output refused by the next
   replay; (d) the forge: Wine packaged as two versions, uploaded to a
   ``ForgeServer`` on 127.0.0.1, the newest fetched by ``ForgeClient``
   and served by ``ExportedModel`` on its graphed buckets bit-equal to
   the bundle exported directly, ``fleet.model_corrupt`` quarantining it
   and the fetch falling back (counted); package, upload and fetch
   times.
22. the population engine (``znicz_tpu_torch.population``): (a) MNIST
   784-100-10 (f32, B = 100) as K = 8 members (seeds ``SEED`` + i,
   no evolution) for 2 epochs, the K members' step one CUDA graph a
   key (3 captures), 8 B4 launches a population step; then the 8
   members one after another as ordinary graphed runs, every member's
   weights, bias and momentum bit-equal to its slice and its best
   validation error the member's fitness; the population step against
   one member's step (CUDA events, medians, in turns); (b) the blobs net
   of ``tests/test_population.py`` with dropout, K = 3 for 3 epochs,
   bit-equal to 3 sequential runs (B3's seed chains a member); (c)
   (a)'s population for 3 epochs with PBT and with GA, each twice from
   one seed: the history, the rates and the weights equal, each PBT
   loser's leaves its donor's before the explore, no capture after a
   generation; (d) ``train_drafter`` at phase 15's drafter geometry on
   its training data (K = 4, PBT every 2 epochs, a step budget), the
   best member published into a temporary directory and served as phase
   15's LM's drafter: the tokens those of the engine without
   speculation, the acceptance rate beside phase 15's drafter's; (e)
   ``python -m znicz_tpu_torch wine --optimize 2x4`` with a
   ``Tune(...)`` learning rate in a child process on the card: exit 0,
   the best genome in range.

Each path of phases 3–22 runs with every launch counter set to 0 just
before it and read just after, and every B3 and B4 launch on them must
take the route rebuilt for Hopper.  After each of phases 3–17 the state
of every anomaly guard built in it is read: a step skipped as
non-finite on a clean path fails the run (phase 11's planted NaN is
left out).  A replayed graph runs no Python, so
a region adds what its capture counted once a replay
(``znicz_tpu_torch/ops/launch_counts.py``).  The last three lines of standard
output are one JSON object with the rows timed at shapes no path gives
their kernel (C7's wide rows, ``off_path_kernels``), one listing the
kernels of the paths with their numbers and their launches by path,
then ``{"ok": true, "device": ...}``.  Without a
CUDA device, or without ``nvcc``, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import ctypes
import gzip
import itertools
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12

SEED = 20261016
#: the full-width scorer (benchmarks/seq_bench.py's sequence stack)
BATCH, SEQ, DIM, HEADS, CLASSES = 16, 2048, 512, 8, 8
#: 1-row GPU reply vs the CPU reply of the same bundle, probabilities:
#: both round at the same points (the request, q/k/v, p, the attention
#: and layer-norm outputs) but sum in other orders, which moves some
#: bf16 activations by one rounding step; over the 2048·512 inputs of
#: the head those steps add up to a few 1e-3 of a logit, a few 1e-4 of
#: a probability.  The bound leaves a margin of ten.
SLICE_TOL = 1e-2
#: one train step on the card against the same step on the CPU: each
#: parameter's update, relative to its largest |update|.  Both round at
#: the same points, but the kernels sum in other orders than the plain
#: versions, which flips single bf16 roundings of p, ds, δ and the
#: stored activations; each flip moves every gradient it feeds by one
#: bf16 step of that term (2⁻⁸ relative), and the CPU tests see ~1e-2
#: of the largest momentum after several steps for the same reason.
TRAIN_STEP_TOL = 5e-2
#: the same check in f32 (phase 6): nothing is rounded to bf16 on either
#: side and TF32 is off, so the kernels and the CPU's plain versions
#: differ in summation order only (a few f32 ulps of each term, summed
#: over T = 2048 keys and B·T rows): around 1e-4 of the largest update.
TRAIN_STEP_TOL_F32 = 1e-4

#: phases 4–7 run their regions eagerly (:func:`set_graphs`), as the
#: paths ran before the port had CUDA graphs; phase 8 runs the same paths
#: graphed (the port's way on the card) and reads their eager numbers
#: here
EAGER: dict = {}
#: each :func:`device_busy` reading's kernel time a step, in ms
BUSY_KERNEL_MS: list = []


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after ``warmup`` calls."""
    import torch
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


def graph_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """Mean device time of ``fn`` with the host taken out: ``iters``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events.  For kernels that take less time than their Python
    wrapper, where back-to-back calls time the wrapper."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
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
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
#: name, operand dtype, B, Tq, Tk, H, dh, causal, q_offset, k_offset,
#: and the suffix of the kernel row the case is timed for (None: not
#: timed).  The bf16 kernels at dh 64 and 128, then the f32 kernels
#: (R1) and the head dims other than 64/128 (R2): the 32-wide
#: instantiation, and 40 and 96, zero-padded to 64 and 128; then the
#: head dims past 128 (C2): 256 in both dtypes, and 200 zero-padded to
#: 256 (the bf16 kernels read it through TMA's zero fill); then past
#: 256 (C5): 512 and 264 (the f32 kernels pad it to 384), the f32
#: cases at B = 2, T = 1024 to keep the run short.
ATTN_CASES = (
    ("serving", "bfloat16", BATCH, SEQ, SEQ, HEADS, DIM // HEADS, False,
     0, 0, ""),
    ("causal", "bfloat16", BATCH, SEQ, SEQ, HEADS, DIM // HEADS, True, 0, 0,
     "_causal"),
    ("dh128", "bfloat16", 4, SEQ, SEQ, 4, 128, False, 0, 0, None),
    ("dh128_causal", "bfloat16", 4, SEQ, SEQ, 4, 128, True, 0, 0, None),
    # keys placed after the first 512 queries: those rows are fully
    # masked (out 0, lse -1e30)
    ("offsets", "bfloat16", 2, 1024, 1024, HEADS, 64, True, 512, 1024, None),
    ("ragged", "bfloat16", 3, 1000, 1000, HEADS, 64, False, 0, 0, None),
    ("ragged_cross", "bfloat16", 2, 1000, 777, 4, 128, True, 300, 0, None),
    ("f32", "float32", BATCH, SEQ, SEQ, HEADS, DIM // HEADS, False, 0, 0,
     "_f32"),
    ("f32_causal", "float32", 4, SEQ, SEQ, 4, 128, True, 0, 0, None),
    ("f32_offsets_dh32", "float32", 2, 1024, 1024, HEADS, 32, True, 512,
     1024, None),
    ("f32_ragged_cross", "float32", 2, 1000, 777, 4, 128, True, 300, 0,
     None),
    ("f32_dh96_padded", "float32", 3, 1000, 1000, 4, 96, False, 0, 0, None),
    ("dh32", "bfloat16", BATCH, SEQ, SEQ, 2 * HEADS, 32, False, 0, 0,
     "_dh32"),
    ("dh32_causal_ragged", "bfloat16", 3, 1000, 1000, 2 * HEADS, 32, True,
     0, 0, None),
    ("dh40_padded", "bfloat16", 2, 1000, 777, 4, 40, True, 300, 0, None),
    ("dh256", "bfloat16", BATCH, SEQ, SEQ, 2, 256, False, 0, 0, "_dh256"),
    ("dh256_causal_offsets", "bfloat16", 2, 1024, 1024, 2, 256, True, 512,
     1024, None),
    ("dh200_padded", "bfloat16", 2, 1000, 777, 2, 200, True, 300, 0, None),
    ("f32_dh256", "float32", BATCH, SEQ, SEQ, 2, 256, False, 0, 0,
     "_f32_dh256"),
    ("f32_dh256_causal_offsets", "float32", 2, 1024, 1024, 2, 256, True,
     512, 1024, None),
    ("f32_dh200_padded", "float32", 2, 1000, 777, 2, 200, True, 300, 0,
     None),
    ("dh512", "bfloat16", BATCH, SEQ, SEQ, 1, 512, False, 0, 0, "_wide"),
    ("dh512_causal_offsets", "bfloat16", 2, 1024, 1024, 1, 512, True, 512,
     1024, None),
    ("dh264_padded", "bfloat16", 2, 1000, 777, 2, 264, True, 300, 0, None),
    ("f32_dh512", "float32", 2, 1024, 1024, 1, 512, False, 0, 0,
     "_f32_wide"),
    ("f32_dh512_causal_offsets", "float32", 2, 1024, 1024, 1, 512, True,
     512, 1024, None),
    ("f32_dh264_padded", "float32", 2, 1000, 777, 2, 264, True, 300, 0,
     None),
    # the f32 backward's tile edges (64 rows, 32-column slices): lengths
    # just past a multiple of 64, a causal diagonal that cuts its tiles
    # with offsets, dh 8 (padded to 32, the 32-wide chunk), and one head
    # of 512 at B = 1 (a grid too small for the card: narrower chunks)
    ("f32_129x65", "float32", 2, 129, 65, 4, 64, False, 0, 0, None),
    ("f32_causal_cut_tile", "float32", 2, 300, 200, 4, 128, True, 37,
     101, None),
    ("f32_dh8_padded", "float32", 2, 333, 333, 8, 8, True, 0, 0, None),
    ("f32_dh512_small_grid", "float32", 1, 1000, 1000, 1, 512, True, 0, 0,
     None),
    # the f32 forward's edges (blocks of 128 query rows up to dh 128, of
    # 64 past it): one row past a block at both heights over a ragged
    # key count; a causal diagonal that leaves the first block one
    # visible key (its other rows fully masked); operands whose rows
    # start off 16-byte boundaries (copied before the kernel's 16-byte
    # loads)
    ("f32_129_dh128", "float32", 2, 129, 100, 4, 128, False, 0, 0, None),
    ("f32_65_dh256", "float32", 2, 65, 99, 2, 256, True, 0, 0, None),
    ("f32_causal_one_key", "float32", 2, 300, 300, 4, 64, True, 0, 127,
     None),
    ("f32_unaligned_view", "float32", 2, 300, 250, 4, 64, True, 20, 0,
     None),
)
#: cases whose q, k and v are views one element into their packed
#: projection, so no row starts on a 16-byte boundary
OFF_ALIGN_CASES = ("f32_unaligned_view",)
#: cases whose forward is timed though they have no row of their own
#: (their launches count under the "bf16" row)
FWD_TIMED_ONLY = ("dh128",)
#: out and lse against the plain version.  bf16 operands: out differs
#: by bf16 rounding of p at different running maxima and by summation
#: order; lse is f32 throughout.  f32 operands: f32 products on both
#: sides, in other summation orders (a few f32 ulps of O(1) values).
ATTN_OUT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
ATTN_LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
#: kernel row suffix → the variant its launches are counted under
ROW_VARIANT = {"": "bf16", "_causal": "causal", "_f32": "f32",
               "_dh32": "dh32",
               "_dh256": "dh256", "_f32_dh256": "f32_dh256",
               "_wide": "wide", "_f32_wide": "f32_wide"}
#: kernel row suffix → the (forward, backward) sources of its kernels
ATTN_SOURCES = {
    suffix: (("flash_attention_f32.cu", "flash_attention_bwd_f32.cu")
             if "f32" in suffix else
             ("flash_attention_fwd.cu", "flash_attention_bwd.cu"))
    for suffix in ROW_VARIANT}


def _visible_pairs(tq: int, tk: int, causal: bool, q_off: int,
                   k_off: int) -> int:
    if not causal:
        return tq * tk
    return sum(min(max(q_off + i - k_off + 1, 0), tk) for i in range(tq))


def _attn_operands(gen, dtype, b, tq, tk, h, dh, off=0):
    """q/k/v as strided slices of packed projections, as the attention
    unit hands them over, each ``off`` elements into its slot."""
    import torch
    d = h * dh
    qkv_q = torch.randn(b, tq, 3 * d + off, generator=gen, device="cuda",
                        dtype=dtype)
    qkv_k = torch.randn(b, tk, 3 * d + off, generator=gen, device="cuda",
                        dtype=dtype)
    return (qkv_q[..., off:off + d].view(b, tq, h, dh),
            qkv_k[..., off + d:off + 2 * d].view(b, tk, h, dh),
            qkv_k[..., off + 2 * d:off + 3 * d].view(b, tk, h, dh))


def _peak(dtype) -> float:
    import torch
    return PEAK_F32_FLOP_S if dtype == torch.float32 else PEAK_BF16_FLOP_S


def check_flash(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import flash_attention as fa
    rows = {}
    for (name, dtype_name, b, tq, tk, h, dh, causal, q_off, k_off,
         suffix) in ATTN_CASES:
        dtype = getattr(torch, dtype_name)
        d = h * dh
        q, k, v = _attn_operands(gen, dtype, b, tq, tk, h, dh,
                                 int(name in OFF_ALIGN_CASES))
        out, lse = fa.flash_attention_fwd(q, k, v, causal, q_off, k_off)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal, q_off,
                                                    k_off)
        torch.cuda.synchronize()
        err_o, err_l = max_err(out, ref_out), max_err(lse, ref_lse)
        finite = bool(torch.isfinite(out.float()).all()
                      and torch.isfinite(lse).all())
        # fully masked rows: exactly the plain version's out 0 and lse
        masked = ref_lse == fa.NEG_INF
        exact = bool(torch.equal(lse[masked], ref_lse[masked])
                     and (out.transpose(1, 2)[masked] == 0).all())
        tol_o, tol_l = ATTN_OUT_TOL[dtype_name], ATTN_LSE_TOL[dtype_name]
        say(f"  flash_attention_fwd {name}: {dtype_name} B={b} Tq={tq} "
            f"Tk={tk} H={h} dh={dh} (kernel width "
            f"{fa.kernel_head_dim(dh)} in the f32 kernels) causal={causal} "
            f"offsets=({q_off},{k_off}) max_abs_err out={err_o:.3g} "
            f"(tol {tol_o}) lse={err_l:.3g} (tol {tol_l}), "
            f"{int(masked.sum())} fully masked rows exact={exact}")
        if out.dtype != dtype or out.shape != q.shape or not finite \
                or err_o > tol_o or err_l > tol_l or not exact:
            raise AssertionError(f"flash_attention_fwd disagrees with its "
                                 f"plain version in case '{name}'")
        if suffix is None and name not in FWD_TIMED_ONLY:
            continue
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), 20)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                           5, warmup=1)
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), 20)
        flops = 4.0 * b * h * dh * _visible_pairs(tq, tk, causal, q_off,
                                                  k_off)
        es = q.element_size()
        nbytes = es * (2 * b * tq * d + 2 * b * tk * d) + 4.0 * b * h * tq
        bound_ms, bound_by = bound(nbytes, flops, _peak(dtype))
        say(f"  flash_attention_fwd {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops:.4g} FLOP, {nbytes:.4g} B)")
        if suffix is None:
            continue
        key = f"flash_attention_fwd{suffix}"
        rows[key] = {"name": key, "route": "cuda",
                     "source": "znicz_tpu_torch/csrc/"
                               + ATTN_SOURCES[suffix][0],
                     "replaces": "znicz_tpu/ops/pallas_attention.py:173",
                     "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms}
    check_core_route(gen)
    return rows


def check_core_route(gen) -> None:
    """dh = 4 is no multiple of 8: the attention core takes the plain
    core, as the reference routes it, and no kernel launches."""
    import torch
    from znicz_tpu_torch.ops import flash_attention as fa
    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    before = [k.launches for k in kernels]
    q, k, v = (a.detach().requires_grad_() for a in _attn_operands(
        gen, torch.float32, 2, 256, 256, 128, 4))
    out = fa.attention_core(q, k, v, causal=True, dot_dtype=torch.bfloat16)
    out.sum().backward()
    out = out.detach()
    ref, _ = fa.flash_attention_plain(*(a.detach().to(torch.bfloat16)
                                        for a in (q, k, v)), True)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    rose = [k.launches - b for k, b in zip(kernels, before)]
    say(f"  attention_core dh=4 (B=2, T=256, 128 heads, causal, bf16): "
        f"kernel_legal={fa.kernel_legal(4)}, launches {rose}, "
        f"max_abs_err vs the flash plain version {err:.3g} (tol "
        f"{ATTN_OUT_TOL['bfloat16']})")
    if any(rose) or err > ATTN_OUT_TOL["bfloat16"] \
            or not bool(torch.isfinite(q.grad).all()):
        raise AssertionError("the dh=4 attention core launched a kernel or "
                             "disagrees")


#: the cases given a random nonzero lse cotangent (the ring's term)
DLSE_CASES = ("ragged_cross", "f32_ragged_cross", "dh200_padded",
              "f32_dh200_padded", "dh264_padded", "f32_dh264_padded",
              "f32_causal_cut_tile")
#: dq, dk and dv against the plain version, relative to the largest
#: |reference|.  bf16: both round p and ds to bf16 before their products,
#: at exp(s − lse) values that differ in the last f32 bits (expf and
#: another summation order of s), which flips single bf16 roundings of p
#: and ds; the f32 sums then round once more to bf16.  f32: nothing is
#: rounded to bf16; the sums differ in order only.
ATTN_BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def _attn_bwd_flops(b, h, dh, tq, tk, causal, q_off, k_off, products):
    return 2.0 * products * b * h * dh * _visible_pairs(tq, tk, causal,
                                                        q_off, k_off)


def check_flash_bwd(gen) -> dict:
    """B8 and B9 against their plain versions in every geometry of
    ``ATTN_CASES``, then their times at the training shape of each
    variant."""
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import flash_attention as fa
    rows = {}
    for (name, dtype_name, b, tq, tk, h, dh, causal, q_off, k_off,
         suffix) in ATTN_CASES:
        dtype = getattr(torch, dtype_name)
        d = h * dh
        q, k, v = _attn_operands(gen, dtype, b, tq, tk, h, dh,
                                 int(name in OFF_ALIGN_CASES))
        out, lse = fa.flash_attention_fwd(q, k, v, causal, q_off, k_off)
        dout = torch.randn(b, tq, h, dh, generator=gen, device="cuda",
                           dtype=dtype)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        if name in DLSE_CASES:
            delta = delta - torch.randn(b, h, tq, generator=gen,
                                        device="cuda")
        delta = delta.contiguous()
        args = (q, k, v, dout, lse, delta, causal, q_off, k_off)
        dq = fa.flash_attention_dq(*args)
        dk, dv = fa.flash_attention_dkv(*args)
        ref_dq = fa.flash_attention_dq_plain(*args)
        ref_dk, ref_dv = fa.flash_attention_dkv_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        tol = ATTN_BWD_TOL[dtype_name]
        for key, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                              ("dv", dv, ref_dv)):
            scale = float(ref.float().abs().max())
            err = max_err(got, ref)
            errs[key] = err
            if got.dtype != dtype or got.shape != ref.shape \
                    or not bool(torch.isfinite(got.float()).all()) \
                    or err > tol * max(scale, 1e-30):
                raise AssertionError(
                    f"flash_attention {key} disagrees with its plain "
                    f"version in case '{name}': {err:.3g} > "
                    f"{tol} x {scale:.3g}")
        say(f"  flash_attention_dq/dkv {name}: {dtype_name} dh={dh} "
            f"dlse={name in DLSE_CASES} "
            + ", ".join(f"{key} max_abs_err={e:.3g}" for key, e in
                        errs.items())
            + f" (tol {tol} x max|ref|)")
        if suffix is None:
            continue
        ms_dq = time_ms(lambda: fa.flash_attention_dq(*args), 10)
        ms_dkv = time_ms(lambda: fa.flash_attention_dkv(*args), 10)
        plain_dq = time_ms(lambda: fa.flash_attention_dq_plain(*args), 3,
                           warmup=1)
        plain_dkv = time_ms(lambda: fa.flash_attention_dkv_plain(*args),
                            3, warmup=1)
        # yardstick: one backward of scaled_dot_product_attention, which
        # computes dq, dk and dv together (the port never calls it)
        qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_()
                      for a in (q, k, v))
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        g = dout.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, (qh, kh, vh), g, retain_graph=True), 10)
        stat_bytes = 2 * 4.0 * b * h * tq
        es = q.element_size()
        for key, products, ms, plain_ms, nbytes in (
                ("flash_attention_dq", 3, ms_dq, plain_dq,
                 es * (2 * b * tq * d + 2 * b * tk * d) + stat_bytes),
                ("flash_attention_dkv", 4, ms_dkv, plain_dkv,
                 es * (2 * b * tq * d + 4 * b * tk * d) + stat_bytes)):
            flops = _attn_bwd_flops(b, h, dh, tq, tk, causal, q_off, k_off,
                                    products)
            bound_ms, bound_by = bound(nbytes, flops, _peak(dtype))
            say(f"  {key} {name}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, scaled_dot_product_attention "
                f"backward {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}: {flops:.4g} FLOP, {nbytes:.4g} B)")
            err = errs["dq"] if key.endswith("dq") else max(errs["dk"],
                                                            errs["dv"])
            rows[key + suffix] = {
                "name": key + suffix, "route": "cuda",
                "source": "znicz_tpu_torch/csrc/" + ATTN_SOURCES[suffix][1],
                "replaces": ("znicz_tpu/ops/pallas_attention.py:286"
                             if key.endswith("dq") else
                             "znicz_tpu/ops/pallas_attention.py:323"),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
    return rows


#: name, rows, D, dtype, with beta, offset (elements the operands lie
#: into their buffers), the route it must take (fused_kernels.
#: layer_norm_route), and the kernel row it is timed for ("bucket1":
#: timed and printed only; None: not timed).  The sequence stack's
#: shapes: training (16·2048 rows) in both dtypes, serving's bucket of 1
#: (2048 rows); the register kernels' edges: the widest row (1024) in
#: both dtypes, 3 vectors a lane (520), ragged row counts; and the general
#: kernels: a width that is not a multiple of 8, one past 1024, and views
#: off 16-byte boundaries.
LN_CASES = (
    ("serving", BATCH * SEQ, DIM, "bfloat16", True, 0, "register", ""),
    ("no_beta", BATCH * SEQ, DIM, "bfloat16", False, 0, "register", None),
    ("f32", BATCH * SEQ, DIM, "float32", True, 0, "register", "_f32"),
    ("f32_no_beta", BATCH * SEQ, DIM, "float32", False, 0, "register",
     None),
    ("bucket1", SEQ, DIM, "bfloat16", True, 0, "register", "bucket1"),
    ("wide", 4099, 1024, "bfloat16", True, 0, "register", None),
    ("wide_f32", 4099, 1024, "float32", False, 0, "register", None),
    ("d520_f32", 3001, 520, "float32", True, 0, "register", None),
    ("ragged_width", 1000, 100, "bfloat16", True, 0, "general", None),
    ("past_1024", 1000, 1032, "float32", True, 0, "general", None),
    ("off16", 4096, DIM, "bfloat16", True, 1, "general", None),
)
#: layer-norm row suffix → the x dtype its launches are counted under
LN_ROW_DTYPE = {"": "bfloat16", "_f32": "float32"}
#: input copies the layer-norm timings rotate over
LN_ROTATION = 3


def _ln_tol(dtype, ref) -> float:
    """bf16 output: one bf16 ulp of the largest |y| (a rounding flip
    from f32 statistics summed in another order); f32: 1e-5 (rsqrtf
    and summation order)."""
    import torch
    if dtype == torch.bfloat16:
        return 2.0 ** -7 * float(ref.float().abs().max())
    return 1e-5


def _ln_operands(gen, m, d, dtype, offset, n):
    """``n`` (m, d) tensors of ``dtype`` (x, then err), each a view
    ``offset`` elements into its buffer: x ~ 2·N + 0.5, err ~ 0.1·N."""
    import torch
    out = []
    for scale, shift in ((2.0, 0.5), (0.1, 0.0))[:n]:
        flat = (scale * torch.randn(m * d + offset, generator=gen,
                                    device="cuda") + shift).to(dtype)
        out.append(flat[offset:].view(m, d))
    return out


def _took(fn, before: dict) -> list:
    """The routes ``fn`` launched on since its by-route counts were
    ``before``."""
    return [r for r, n in before.items() if fn.launches_by_route[r] != n]


def check_layer_norm(gen) -> dict:
    """B5 against its plain version on every case of :data:`LN_CASES`,
    each on the route the case names (read from the wrapper's counters);
    then the timed cases: the kernel in CUDA graphs over
    :data:`LN_ROTATION` input copies (back-to-back calls printed beside:
    at serving's 2 MB bucket the wrapper's enqueue outlasts the kernel),
    the plain version, and ``F.layer_norm`` in graphs over the same
    copies.  Rotating matters: a 32 MB bf16 x would stay in the 50 MB
    L2."""
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import fused_kernels as fk
    rows = {}
    eps = 1e-5
    for name, m, d, dtype_name, with_beta, offset, route, timed in LN_CASES:
        dtype = getattr(torch, dtype_name)
        (x,) = _ln_operands(gen, m, d, dtype, offset, 1)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = (0.1 * torch.randn(d, generator=gen, device="cuda")
                if with_beta else None)
        before = dict(fk.layer_norm_forward.launches_by_route)
        y = fk.layer_norm_forward(x, gamma, beta, eps)
        took = _took(fk.layer_norm_forward, before)
        ref = fk.layer_norm_forward_plain(x, gamma, beta, eps)
        torch.cuda.synchronize()
        err, tol = max_err(y, ref), _ln_tol(dtype, ref)
        say(f"  layer_norm_forward {name}: ({m}, {d}) {dtype_name} "
            f"beta={with_beta} offset={offset}, {took} route: "
            f"max_abs_err={err:.3g} (tol {tol:.3g})")
        if took != [route]:
            raise AssertionError(f"layer_norm_forward case '{name}' took "
                                 f"the routes {took}, not {route}")
        if y.dtype != x.dtype or not bool(torch.isfinite(y.float()).all()) \
                or err > tol:
            raise AssertionError(f"layer_norm_forward disagrees with its "
                                 f"plain version in case '{name}'")
        if timed is None:
            continue
        copies = [(x,)] + [(x.clone(),) for _ in range(LN_ROTATION - 1)]
        fwd = rotating(lambda a: fk.layer_norm_forward(a, gamma, beta, eps),
                       copies)
        calls = 7 * LN_ROTATION
        wrapper_ms, ms = time_ms(fwd, calls), graph_ms(fwd, calls)
        plain_ms = time_ms(rotating(
            lambda a: fk.layer_norm_forward_plain(a, gamma, beta, eps),
            copies), 5)
        g_t = gamma.to(dtype)
        b_t = None if beta is None else beta.to(dtype)
        lib_ms = graph_ms(rotating(
            lambda a: F.layer_norm(a, (d,), g_t, b_t, eps), copies), calls)
        del copies
        elem = m * d
        nbytes = 2.0 * elem * x.element_size() + 4.0 * d * 2
        bound_ms, bound_by = bound(nbytes, 8.0 * elem, PEAK_F32_FLOP_S)
        say(f"  layer_norm_forward {name}: kernel {ms:.5f} ms in a graph "
            f"(back to back {wrapper_ms:.5f}), plain {plain_ms:.4f} ms, "
            f"F.layer_norm {lib_ms:.5f} ms in a graph, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {nbytes:.4g} B; "
            f"{100 * bound_ms / ms:.1f} % of it)")
        if timed not in LN_ROW_DTYPE:
            continue
        rows["layer_norm_forward" + timed] = {
            "name": "layer_norm_forward" + timed, "route": "cuda",
            "source": "znicz_tpu_torch/csrc/layer_norm_fwd.cu",
            "replaces": "znicz_tpu/ops/pallas_kernels.py:182",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    return rows


#: name, rows, D, dtype, with beta, offset, route, the kernel row it is
#: timed for (None: not timed); 32771 rows fit no block tiling.  The last
#: four are the general route's widest, past what one block's shared memory
#: held before the columns were walked in chunks: timed rows of their own
#: (:data:`OFF_PATH_ROWS`), over a ragged row count
LN_BWD_CASES = (
    ("training", BATCH * SEQ, DIM, "bfloat16", True, 0, "register", ""),
    ("no_beta", BATCH * SEQ, DIM, "bfloat16", False, 0, "register", None),
    ("f32", BATCH * SEQ, DIM, "float32", True, 0, "register", "_f32"),
    ("ragged_rows", 32771, DIM, "bfloat16", True, 0, "register", None),
    ("seq_pass", 4 * 1024, DIM, "float32", True, 0, "register", None),
    ("wide", 4099, 1024, "bfloat16", True, 0, "register", None),
    ("wide_f32", 4099, 1024, "float32", True, 0, "register", None),
    ("d520_f32", 3001, 520, "float32", False, 0, "register", None),
    ("one_row", 1, DIM, "bfloat16", True, 0, "register", None),
    ("ragged_width", 1000, 100, "bfloat16", True, 0, "general", None),
    ("past_1024", 1000, 1032, "float32", True, 0, "general", None),
    ("off16", 4096, DIM, "bfloat16", True, 1, "general", None),
    ("d25608", 1031, 25608, "bfloat16", True, 0, "general", "_d25608"),
    ("d25608_f32", 1031, 25608, "float32", True, 0, "general", None),
    ("d51208_no_beta", 1031, 51208, "bfloat16", False, 0, "general",
     "_d51208_no_beta"),
    ("d51208_no_beta_f32", 1031, 51208, "float32", False, 0, "general",
     None),
)
#: kernel rows timed at shapes no main path gives the kernel (the general
#: routes at C7's widths): printed on a line of their own, not in the
#: ``kernels`` line, whose every row a main path launches
OFF_PATH_ROWS = ("layer_norm_backward_d25608",
                 "layer_norm_backward_d51208_no_beta",
                 "lrn_forward_c16392", "lrn_backward_c16392",
                 "lrn_forward_c16392_n257", "lrn_backward_c16392_n257")
#: the f32 γ/β sums against the plain version, per column, relative to
#: the sum of the absolute terms: both add f32 terms, in other orders
LN_SUM_TOL = 1e-5


#: idle time at each end of a profiler window: the trace keeps only the
#: device activity it places inside its window, and a graph replay
#: starts its first kernels microseconds after the host enqueues it, so
#: a window that opens straight into a replay now and then loses the
#: replay's opening kernels (``tools/profile_window_probe.py`` counts
#: such windows with and without the margin)
PROFILE_MARGIN_S = 0.05
#: profiler windows at most for one reading of the launches, each one
#: repeated only when the profiler lost a record (see above)
PROFILE_TRIES = 3


def kernel_split_ms(fn, calls: int, names) -> dict:
    """Mean device time a call of each kernel whose name contains one of
    ``names``, from a ``torch.profiler`` window over ``calls`` calls of
    ``fn`` (0.0 where the profiler saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for key in names:
            if key + "<" in e.key or key + "(" in e.key:
                out[key] += getattr(e, "self_device_time_total", getattr(
                    e, "self_cuda_time_total", 0)) / 1e3 / calls
    return out


def check_layer_norm_bwd(gen) -> dict:
    """B6 against its plain version on every case of
    :data:`LN_BWD_CASES`, each on the route the case names, its sums
    the same bits on a rerun; then the timed cases as
    :func:`check_layer_norm` times them, beside
    ``native_layer_norm_backward`` in graphs, and its two launches (the
    rows kernel and the fold over blocks) apart from a profiler
    window."""
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    rows = {}
    eps = 1e-5
    for name, m, d, dtype_name, with_beta, offset, route, timed in \
            LN_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        x, err = _ln_operands(gen, m, d, dtype, offset, 2)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        before = dict(fk.layer_norm_backward.launches_by_route)
        dx, gg, gb = fk.layer_norm_backward(x, err, gamma, eps, with_beta)
        took = _took(fk.layer_norm_backward, before)
        rdx, rgg, rgb = fk.layer_norm_backward_plain(x, err, gamma, eps,
                                                     with_beta)
        again = fk.layer_norm_backward(x, err, gamma, eps, with_beta)
        torch.cuda.synchronize()
        xf = x.float()
        xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
            xf.var(-1, unbiased=False, keepdim=True) + eps)
        abs_g = (err.float() * xhat).abs().sum(0)
        abs_b = err.float().abs().sum(0)
        dx_tol = _ln_tol(dtype, rdx)
        err_dx = max_err(dx, rdx)
        rel_g = float(((gg - rgg).abs() / abs_g.clamp_min(1e-30)).max())
        rel_b = (float(((gb - rgb).abs() / abs_b.clamp_min(1e-30)).max())
                 if with_beta else 0.0)
        same_bits = all(torch.equal(a, b) for a, b in
                        zip((dx, gg, gb), again) if a is not None)
        say(f"  layer_norm_backward {name}: ({m}, {d}) {dtype_name} "
            f"beta={with_beta} offset={offset}, {took} route: dx "
            f"max_abs_err={err_dx:.3g} (tol {dx_tol:.3g}), sums max rel_err "
            f"gamma={rel_g:.3g} beta={rel_b:.3g} (tol {LN_SUM_TOL} of sum "
            f"|terms|), rerun bitwise={same_bits}")
        if took != [route]:
            raise AssertionError(f"layer_norm_backward case '{name}' took "
                                 f"the routes {took}, not {route}")
        if dx.dtype != err.dtype or err_dx > dx_tol \
                or rel_g > LN_SUM_TOL or rel_b > LN_SUM_TOL \
                or (gb is None) == with_beta or not same_bits \
                or not bool(torch.isfinite(dx.float()).all()):
            raise AssertionError(f"layer_norm_backward disagrees with its "
                                 f"plain version in case '{name}'")
        if timed is None:
            continue
        copies = [(x, err)] + [(x.clone(), err.clone())
                               for _ in range(LN_ROTATION - 1)]
        bwd = rotating(lambda a, e: fk.layer_norm_backward(
            a, e, gamma, eps, with_beta), copies)
        calls = 7 * LN_ROTATION
        wrapper_ms, ms = time_ms(bwd, calls), graph_ms(bwd, calls)
        kernels = {"register": ("ln_bwd_reg_kernel", "ln_bwd_reg_fold_kernel"),
                   "general": ("ln_bwd_rows_kernel", "ln_bwd_fold_kernel")
                   }[route]
        split = kernel_split_ms(bwd, calls, kernels)
        plain_ms = time_ms(rotating(
            lambda a, e: fk.layer_norm_backward_plain(a, e, gamma, eps,
                                                      with_beta), copies), 5)
        g_t, b_t = gamma.to(dtype), torch.zeros_like(gamma).to(dtype)
        stats = [torch.ops.aten.native_layer_norm(a, (d,), g_t, b_t, eps)[1:]
                 for a, _ in copies]
        lib_ms = graph_ms(rotating(
            lambda a, e, mean, rstd: torch.ops.aten.native_layer_norm_backward(
                e, a, (d,), mean, rstd, g_t, b_t, [True, True, with_beta]),
            [c + s for c, s in zip(copies, stats)]), calls)
        del copies, stats
        elem = m * d
        nbytes = 3.0 * elem * x.element_size() + 4.0 * d * 3
        bound_ms, bound_by = bound(nbytes, 20.0 * elem, PEAK_F32_FLOP_S)
        say(f"  layer_norm_backward {name}: kernel {ms:.5f} ms in a graph "
            f"(back to back {wrapper_ms:.5f}; profiler: rows kernel "
            f"{split[kernels[0]]:.5f} ms, fold {split[kernels[1]]:.5f} ms), "
            f"plain {plain_ms:.4f} ms, native_layer_norm_backward "
            f"{lib_ms:.5f} ms in a graph, bound {bound_ms:.5f} ms "
            f"({bound_by}: {nbytes:.4g} B; {100 * bound_ms / ms:.1f} % of "
            f"it)")
        rows["layer_norm_backward" + timed] = {
            "name": "layer_norm_backward" + timed, "route": "cuda",
            "source": "znicz_tpu_torch/csrc/layer_norm_bwd.cu",
            "replaces": "znicz_tpu/ops/pallas_kernels.py:191",
            "max_abs_err": err_dx, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "split_ms": {"rows": split[kernels[0]],
                         "fold": split[kernels[1]]},
            "shape": [m, d], "dtype": dtype_name, "kernel_route": route}
    return rows


# ----------------------------------------------------------------------
# phase 2, continued: the AlexNet kernels (LRN, dropout, softmax+argmax)
# ----------------------------------------------------------------------
#: the AlexNet minibatch of phase 5
ALEX_BATCH = 128
LRN_CFG = {"alpha": 1e-4, "beta": 0.75, "k": 2.0}
#: CIFAR-10's (phase 7): minibatch 100, LRNs after the 16×16 and 8×8
#: pools at C = 32, α = 5e-5, and its head of 10 classes
CIFAR_BATCH = 100
#: the Wine sample's minibatch (phase 9), the B4 row of its head
WINE_BATCH = 10
#: the byte LM's vocabulary (phase 10): its head's B4 row at (16, 256)
LM_VOCAB = 256
CIFAR_LRN1, CIFAR_LRN2 = CIFAR_BATCH * 16 * 16, CIFAR_BATCH * 8 * 8
CIFAR_LRN_CFG = {"alpha": 5e-5, "beta": 0.75, "k": 2.0}
#: conv1's and conv2's LRN inputs at the minibatch of phase 5, as rows
LRN_CONV1, LRN_CONV2 = ALEX_BATCH * 55 * 55, ALEX_BATCH * 27 * 27
#: name, rows, C, x dtype, err dtype, n, offset, the route it must take,
#: timed.  The two shapes of the slice (after conv1 and conv2) in both
#: storage dtypes; n = 4, whose forward window and its adjoint differ; the
#: vector kernels' edges: one vector a row (C = 8), a window no template
#: takes reaching two vectors away (n = 19 at C = 32), x and err in
#: different dtypes, row counts that fill no tile (21 rows of 96 a tile, 8
#: of 256); and the general kernels: an odd channel count over a ragged row
#: count, views ``offset`` elements into their buffers, off 16-byte
#: boundaries, and C7's wide rows (C = 16392, past what one block's shared
#: memory held before the channels were tiled) at AlexNet's n and at a
#: window that spans many tiles, timed as rows of their own.
LRN_CASES = (
    ("conv1", LRN_CONV1, 96, "bfloat16", "bfloat16", 5, 0, "vector", True),
    ("conv2", LRN_CONV2, 256, "bfloat16", "bfloat16", 5, 0, "vector", True),
    ("conv1_f32", LRN_CONV1, 96, "float32", "float32", 5, 0, "vector",
     False),
    ("conv2_f32", LRN_CONV2, 256, "float32", "float32", 5, 0, "vector",
     False),
    ("conv1_n4", LRN_CONV1, 96, "bfloat16", "bfloat16", 4, 0, "vector",
     False),
    ("conv2_f32_n4", LRN_CONV2, 256, "float32", "float32", 4, 0, "vector",
     False),
    ("c8", 100003, 8, "bfloat16", "bfloat16", 5, 0, "vector", False),
    ("c8_f32_n3", 100003, 8, "float32", "float32", 3, 0, "vector", False),
    ("c32_n19", 100003, 32, "bfloat16", "bfloat16", 19, 0, "vector", False),
    ("c32_f32_n19", 100003, 32, "float32", "float32", 19, 0, "vector",
     False),
    ("x_f32_err_bf16", LRN_CONV2, 256, "float32", "bfloat16", 5, 0,
     "vector", False),
    ("x_bf16_err_f32", LRN_CONV1, 96, "bfloat16", "float32", 4, 0,
     "vector", False),
    ("conv1_ragged", 21 * 997 + 9, 96, "bfloat16", "bfloat16", 5, 0,
     "vector", False),
    ("conv2_ragged_f32", 8 * 997 + 5, 256, "float32", "float32", 4, 0,
     "vector", False),
    ("conv1_off", LRN_CONV1, 96, "bfloat16", "bfloat16", 5, 1, "general",
     False),
    ("conv2_off_f32", LRN_CONV2, 256, "float32", "float32", 5, 1,
     "general", False),
    ("odd_ragged", 100003, 37, "bfloat16", "bfloat16", 4, 0, "general",
     False),
    ("odd_ragged_f32", 100003, 37, "float32", "float32", 5, 0, "general",
     False),
    ("c16392", ALEX_BATCH, 16392, "bfloat16", "bfloat16", 5, 0, "general",
     True),
    ("c16392_f32", ALEX_BATCH, 16392, "float32", "float32", 5, 0, "general",
     False),
    ("c16392_n257", ALEX_BATCH, 16392, "bfloat16", "bfloat16", 257, 0,
     "general", True),
    ("c16392_n257_f32", ALEX_BATCH, 16392, "float32", "float32", 257, 0,
     "general", False),
    ("cifar1", CIFAR_LRN1, 32, "float32", "float32", 5, 0, "vector", True),
    ("cifar2", CIFAR_LRN2, 32, "float32", "float32", 5, 0, "vector", True),
)
#: LRN cases at another α than AlexNet's
LRN_CASE_CFG = {"cifar1": CIFAR_LRN_CFG, "cifar2": CIFAR_LRN_CFG}
#: LRN row suffix → the counter its launches are counted under and the
#: key: AlexNet's rows by channel count, CIFAR's (both at C = 32) by
#: (rows, C)
LRN_ROW_KEYS = {"": ("launches_by_channels", 96),
                "_conv2": ("launches_by_channels", 256),
                "_cifar1": ("launches_by_shape", (CIFAR_LRN1, 32)),
                "_cifar2": ("launches_by_shape", (CIFAR_LRN2, 32))}
#: input copies the LRN timings rotate over, at least: more where the
#: copies of x and err would otherwise fit twice in the 50 MB L2
LRN_ROTATION = 3
L2_BYTES = 50e6


def _rel_tol(dtype) -> float:
    """Kernel against plain version, relative to the largest |plain|:
    both do the same f32 arithmetic in the same channel order, but the
    compiler may contract a multiply-add into one FMA and the card's
    rsqrt/sqrt differ from PyTorch's in the last bits: a few f32 ulps
    (f32 storage), or one bf16 rounding flip (bf16 storage, 2⁻⁸ of the
    element, at most 2⁻⁸ of the largest)."""
    import torch
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


def rotating(fn, copies):
    """A call of ``fn`` on the next of ``copies`` (argument tuples) each
    time, round and round."""
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def check_lrn(gen) -> dict:
    """B1 and B2 against their plain versions on every case of
    :data:`LRN_CASES`, each on the route the case names (read from the
    wrappers' counters), then the times of the two timed shapes beside
    the library call's (``F.local_response_norm`` with α·n, which
    computes the same function, and its autograd).  The timed calls
    rotate over :data:`LRN_ROTATION` copies of their inputs: conv2's
    bf16 x and err (47.8 MB each) would fit the 50 MB L2, and
    back-to-back calls on one buffer could read them faster than device
    memory gives them.  The kernels' times come from calls captured in
    a CUDA graph, as at conv2's shape the wrapper's enqueue (tens of µs
    of Python) comes near the kernel's time and back-to-back calls may
    time the host; their back-to-back times are printed beside."""
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import fused_kernels as fk
    rows = {}
    for (name, m, c, x_dtype, err_dtype, n, offset, route,
         timed) in LRN_CASES:
        dtype, edtype = getattr(torch, x_dtype), getattr(torch, err_dtype)
        cfg = dict(LRN_CASE_CFG.get(name, LRN_CFG), n=n)
        # conv outputs large enough that α·Σx² moves d well off k
        x = (30.0 * torch.randn(m * c + offset, generator=gen,
                                device="cuda")).to(dtype)[offset:]
        err = torch.randn(m * c + offset, generator=gen,
                          device="cuda").to(edtype)[offset:]
        x, err = x.view(m, c), err.view(m, c)
        before = {fn: dict(fn.launches_by_route)
                  for fn in (fk.lrn_forward, fk.lrn_backward)}
        y = fk.lrn_forward(x, **cfg)
        dx = fk.lrn_backward(x, err, **cfg)
        took = {fn.__name__: _took(fn, counts)
                for fn, counts in before.items()}
        if any(t != [route] for t in took.values()):
            raise AssertionError(f"LRN case '{name}' took the routes {took}, "
                                 f"not {route}")
        ref_y = fk.lrn_forward_plain(x, **cfg)
        ref_dx = fk.lrn_backward_plain(x, err, **cfg)
        torch.cuda.synchronize()
        errs = {}
        for key, got, ref, want in (("y", y, ref_y, dtype),
                                    ("dx", dx, ref_dx, edtype)):
            tol = _rel_tol(want) * float(ref.float().abs().max())
            errs[key] = max_err(got, ref)
            if got.dtype != want or got.shape != x.shape \
                    or not bool(torch.isfinite(got.float()).all()) \
                    or errs[key] > tol:
                raise AssertionError(f"LRN {key} disagrees with its plain "
                                     f"version in case '{name}': "
                                     f"{errs[key]:.3g} > {tol:.3g}")
        say(f"  lrn_forward/backward {name}: ({m}, {c}) x {x_dtype} err "
            f"{err_dtype} n={n}, {route} route: max_abs_err y="
            f"{errs['y']:.3g} (tol {_rel_tol(dtype):.3g} x max|ref|) dx="
            f"{errs['dx']:.3g} (tol {_rel_tol(edtype):.3g} x max|ref|)")
        if not timed:
            continue
        rotation = max(LRN_ROTATION, math.ceil(
            2 * L2_BYTES / (m * c * (x.element_size() + err.element_size()))))
        copies = [(x, err)] + [(x.clone(), err.clone())
                               for _ in range(rotation - 1)]
        fwd = rotating(lambda a, e: fk.lrn_forward(a, **cfg), copies)
        bwd = rotating(lambda a, e: fk.lrn_backward(a, e, **cfg), copies)
        calls = max(7 * LRN_ROTATION, rotation)
        wrapper_f, wrapper_b = time_ms(fwd, calls), time_ms(bwd, calls)
        ms_f, ms_b = graph_ms(fwd, calls), graph_ms(bwd, calls)
        plain_f = time_ms(rotating(
            lambda a, e: fk.lrn_forward_plain(a, **cfg), copies), 5)
        plain_b = time_ms(rotating(
            lambda a, e: fk.lrn_backward_plain(a, e, **cfg), copies), 5)
        lib_args = dict(size=n, alpha=cfg["alpha"] * n, beta=cfg["beta"],
                        k=cfg["k"])
        lib_f = time_ms(rotating(
            lambda a, e: F.local_response_norm(a.view(m, c, 1), **lib_args),
            copies), 20)
        graphs = []
        for a, e in copies:
            xg = a.view(m, c, 1).detach().requires_grad_()
            graphs.append((F.local_response_norm(xg, **lib_args), xg,
                           e.view(m, c, 1)))
        lib_b = time_ms(rotating(
            lambda yl, xg, e3: torch.autograd.grad(yl, xg, e3,
                                                   retain_graph=True),
            graphs), 20)
        del graphs, copies
        elem, es = m * c, x.element_size()
        suffix = "" if name == "conv1" else "_" + name
        for (key, lib, ms, wrapper_ms, plain_ms, lib_ms, nbytes, ops,
             replaces) in (
                ("lrn_forward", "F.local_response_norm", ms_f, wrapper_f,
                 plain_f, lib_f, 2.0 * elem * es, elem * (2.0 * n + 6),
                 "znicz_tpu/ops/pallas_kernels.py:103"),
                ("lrn_backward", "its autograd", ms_b, wrapper_b, plain_b,
                 lib_b, 3.0 * elem * es, elem * (3.0 * n + 12),
                 "znicz_tpu/ops/pallas_kernels.py:109")):
            bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_FLOP_S)
            say(f"  {key} {name}: kernel {ms:.4f} ms in a graph (back to "
                f"back {wrapper_ms:.4f}), plain {plain_ms:.4f} ms, {lib} "
                f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{nbytes:.4g} B, {ops:.4g} f32 ops; {100 * bound_ms / ms:.1f}"
                f" % of it; {rotation} input copies)")
            rows[key + suffix] = {
                "name": key + suffix, "route": "cuda",
                "source": "znicz_tpu_torch/csrc/lrn.cu", "replaces": replaces,
                "max_abs_err": errs["y" if key == "lrn_forward" else "dx"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms, "shape": [m, c],
                "n": n, "kernel_route": route}
    return rows


def launch_floor_ms() -> float:
    """Device time of one launch of an empty kernel (one block of 32
    threads), 50 in a CUDA graph as :func:`graph_ms` times B3 and B4:
    the least time any kernel node of such a graph takes."""
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    empty = fk._lib("dropout").znicz_empty_launch
    return graph_ms(lambda: empty(torch.cuda.current_stream().cuda_stream))


#: name, shape, dtype, offset, the route it must take, timed: the slice's
#: fc activations in both storage dtypes, a long ragged vector whose last
#: run of 8 is short and which takes the grid-stride loop, and a view off
#: 16-byte boundaries
DROPOUT_CASES = (
    ("fc", (ALEX_BATCH, 4096), "bfloat16", 0, "vector", True),
    ("fc_f32", (ALEX_BATCH, 4096), "float32", 0, "vector", False),
    ("long_ragged", (4_000_037,), "bfloat16", 0, "vector", False),
    ("long_ragged_f32", (4_000_037,), "float32", 0, "vector", False),
    ("off16", (ALEX_BATCH, 4096), "bfloat16", 1, "general", False))
DROP_RATIO = 0.5
#: Philox4x32-10: ten rounds of two 32-bit multiplies (high and low
#: words each), four xors and two key adds, then the compare, the select
#: and the scale
PHILOX_OPS_PER_ELEMENT = 10 * 10 + 4


def check_dropout(gen, floor_ms: float) -> dict:
    """B3 on every case of :data:`DROPOUT_CASES`, each on the route it
    names: the mask bitwise equal to the plain version's, forward and
    backward masks identical, the keep fraction within 4σ of 1 − ratio,
    ratio 0 the identity; times beside ``F.dropout`` (time only: its
    mask is another one) and the launch floor."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import fused_kernels as fk
    seeds = np.random.default_rng(SEED).integers(0, 2 ** 63, size=8)
    row = None
    for (name, shape, dtype_name, offset, route, timed), seed in zip(
            DROPOUT_CASES, seeds):
        dtype = getattr(torch, dtype_name)
        seed = int(seed)
        numel = int(np.prod(shape))
        x, err = (torch.randn(numel + offset, generator=gen, device="cuda")
                  .to(dtype)[offset:].view(shape) for _ in range(2))
        # the seed as the training path passes it: a device tensor the
        # kernel reads through a pointer
        seed_t = fk.seed_tensor(seed, "cuda")
        before = dict(fk.dropout_apply.launches_by_route)
        y = fk.dropout_apply(x, seed_t, DROP_RATIO)
        dx = fk.dropout_apply(err, seed_t, DROP_RATIO)
        took = _took(fk.dropout_apply, before)
        by_value = torch.equal(fk.dropout_apply(x, seed, DROP_RATIO), y)
        same_y = torch.equal(y, fk.dropout_apply_plain(x, seed, DROP_RATIO))
        same_dx = torch.equal(dx, fk.dropout_apply_plain(err, seed,
                                                         DROP_RATIO))
        nonzero = (x != 0) & (err != 0)
        same_mask = torch.equal((y != 0) & nonzero, (dx != 0) & nonzero)
        frac = float((y != 0)[nonzero].float().mean())
        sigma = (DROP_RATIO * (1 - DROP_RATIO) / int(nonzero.sum())) ** 0.5
        identity = torch.equal(fk.dropout_apply(x, seed, 0.0), x)
        torch.cuda.synchronize()
        say(f"  dropout_apply {name}: {tuple(shape)} {dtype_name} offset "
            f"{offset} ratio {DROP_RATIO}, {took} route: bitwise = plain y "
            f"{same_y} dx {same_dx}, forward mask = backward mask "
            f"{same_mask}, keep fraction {frac:.5f} "
            f"({abs(frac - (1 - DROP_RATIO)) / sigma:.2f} σ, tol 4 σ), "
            f"ratio 0 identity {identity}, an int seed the same bits "
            f"{by_value}")
        if took != [route]:
            raise AssertionError(f"dropout_apply case '{name}' took the "
                                 f"routes {took}, not {route}")
        if not (same_y and same_dx and same_mask and identity and by_value) \
                or abs(frac - (1 - DROP_RATIO)) > 4 * sigma:
            raise AssertionError(f"dropout_apply fails its contract in case "
                                 f"'{name}'")
        if not timed:
            continue
        # the kernel is shorter than its wrapper: device times from CUDA
        # graphs, beside the wrapper's back-to-back rate
        wrapper_ms = time_ms(lambda: fk.dropout_apply(x, seed_t,
                                                      DROP_RATIO), 50)
        ms = graph_ms(lambda: fk.dropout_apply(x, seed_t, DROP_RATIO))
        plain_ms = graph_ms(lambda: fk.dropout_apply_plain(x, seed,
                                                           DROP_RATIO), 10)
        lib_ms = graph_ms(lambda: F.dropout(x, DROP_RATIO, training=True))
        elem = x.numel()
        nbytes = 2.0 * elem * x.element_size()
        # the data sheet gives no integer rate: the f32 CUDA-core rate
        # stands in for the Philox integer operations
        ops = float(elem * PHILOX_OPS_PER_ELEMENT)
        bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_FLOP_S)
        say(f"  dropout_apply {name}: kernel {ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms, F.dropout {lib_ms:.5f} ms (CUDA graphs), "
            f"the wrapper back to back {wrapper_ms:.4f} ms, bound "
            f"{bound_ms:.3g} ms ({bound_by}: {nbytes:.4g} B, {ops:.4g} "
            f"integer ops; {100 * bound_ms / ms:.1f} % of it), launch floor "
            f"{floor_ms:.5f} ms")
        row = {"name": "dropout_apply", "route": "cuda",
               "source": "znicz_tpu_torch/csrc/dropout.cu",
               "replaces": "znicz_tpu/ops/pallas_kernels.py:143",
               "max_abs_err": max_err(y, fk.dropout_apply_plain(
                   x, seed, DROP_RATIO)),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "floor_ms": floor_ms, "kernel_route": route}
    return {"dropout_apply": row}


#: name, rows, classes, offset, the route it must take, the kernel row it
#: is timed for (None: not timed): the AlexNet head (a group of 8 warps a
#: row) and the serving buckets' and sequence stack's 8 classes (four rows
#: a warp); a lone class, 33 classes (two warps a row, most of them
#: padding), the register route's widest row, a view off 16 bytes (its
#: scalar loads, 4 a thread), and one class past it (the general route)
SOFTMAX_CASES = (
    ("head", ALEX_BATCH, 1000, 0, "register", ""),
    ("small", 16, 8, 0, "register", "_small"),
    ("one_class", 5, 1, 0, "register", None),
    ("c33", 7, 33, 0, "register", None),
    ("c1024", 7, 1024, 0, "register", None),
    ("head_off", ALEX_BATCH + 1, 1000, 1, "register", None),
    ("c1025", 6, 1025, 0, "general", None),
    ("cifar", CIFAR_BATCH, 10, 0, "register", "_cifar"),
    ("wine", WINE_BATCH, 3, 0, "register", "_wine"),
    ("lm", BATCH, LM_VOCAB, 0, "register", "_lm"),
    ("hands", 40, 2, 0, "register", "_hands"),
    ("yale", 20, 15, 0, "register", "_yale"),
    # channels' head: timed here, its launches counted in the 8-class row
    ("channels", 50, 8, 0, "register", "_channels"))
#: probabilities against the plain version: f32 exp on both sides and
#: another summation order of the row sum
PROB_TOL = 1e-6
#: softmax row suffix → the class count its launches are counted under
SOFTMAX_ROW_CLASSES = {"": 1000, "_small": CLASSES, "_cifar": 10,
                       "_wine": 3, "_lm": LM_VOCAB, "_hands": 2,
                       "_yale": 15}


def check_softmax_argmax(gen, floor_ms: float) -> dict:
    """B4 on every case of :data:`SOFTMAX_CASES`, each on the route it
    names, with planted ties (the first index wins), a −inf column and
    (from 6 rows) a row of NaNs after its first columns, which counts as
    the maximum; the argmax equal to the plain version's and the sums
    the same bits on a rerun.  The timed cases beside
    ``torch.softmax`` and the launch floor."""
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    rows_out = {}
    for name, rows, c, offset, route, timed in SOFTMAX_CASES:
        v = 3.0 * torch.randn(rows * c + offset, generator=gen,
                              device="cuda")[offset:].view(rows, c)
        if c >= 6 and rows >= 4:
            v[0, 5] = v[0, 2] = v[0].max() + 1.0
            v[1, :] = 0.5
            v[2, 3] = float("-inf")
            v[3, -1] = v[3, 0] = v[3].max() + 2.0
        if c >= 6 and rows >= 6:
            v[5, c // 2:] = float("nan")
        before = dict(fk.softmax_argmax.launches_by_route)
        probs, idx = fk.softmax_argmax(v)
        took = _took(fk.softmax_argmax, before)
        again = fk.softmax_argmax(v)
        ref_p, ref_i = fk.softmax_argmax_plain(v)
        torch.cuda.synchronize()
        finite = torch.isfinite(ref_p).all(dim=1)
        err = max_err(probs[finite], ref_p[finite])
        nan_rows = bool(torch.isnan(probs[~finite]).all())
        same_idx = torch.equal(idx, ref_i)
        same_bits = torch.equal(probs.nan_to_num(), again[0].nan_to_num()) \
            and torch.equal(idx, again[1])
        firsts = idx[:4].tolist()
        planted = c >= 6 and rows >= 4
        say(f"  softmax_argmax {name}: ({rows}, {c}) offset {offset}, "
            f"{took} route: max_abs_err probabilities {err:.3g} (tol "
            f"{PROB_TOL}), argmax equal {same_idx}, rerun bitwise "
            f"{same_bits}"
            + (f", planted ties → {firsts[:2] + firsts[3:]} (want [2, 0, "
               f"0]), p(−inf) = {float(probs[2, 3])}" if planted else "")
            + (f", NaN row → {int(idx[5])} (want {c // 2})"
               if rows >= 6 and c >= 6 else ""))
        if took != [route]:
            raise AssertionError(f"softmax_argmax case '{name}' took the "
                                 f"routes {took}, not {route}")
        if probs.dtype != torch.float32 or idx.dtype != torch.int32 \
                or err > PROB_TOL or not same_idx or not same_bits \
                or not nan_rows \
                or (planted and (firsts[:2] + firsts[3:] != [2, 0, 0]
                                 or float(probs[2, 3]) != 0.0)):
            raise AssertionError(f"softmax_argmax disagrees with its plain "
                                 f"version in case '{name}'")
        if timed is None:
            continue
        wrapper_ms = time_ms(lambda: fk.softmax_argmax(v), 50)
        ms = graph_ms(lambda: fk.softmax_argmax(v))
        plain_ms = graph_ms(lambda: fk.softmax_argmax_plain(v))
        lib_ms = graph_ms(lambda: torch.softmax(v, dim=1))
        nbytes = 2.0 * 4 * rows * c + 4.0 * rows
        bound_ms, bound_by = bound(nbytes, 5.0 * rows * c, PEAK_F32_FLOP_S)
        say(f"  softmax_argmax {name}: kernel {ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms, torch.softmax {lib_ms:.5f} ms (CUDA "
            f"graphs), the wrapper back to back {wrapper_ms:.4f} ms, "
            f"bound {bound_ms:.3g} ms ({bound_by}: {nbytes:.4g} B; "
            f"{100 * bound_ms / ms:.1f} % of it), launch floor "
            f"{floor_ms:.5f} ms")
        if timed not in SOFTMAX_ROW_CLASSES:
            continue  # a timing only: no row of the kernels line
        rows_out["softmax_argmax" + timed] = {
            "name": "softmax_argmax" + timed, "route": "cuda",
            "source": "znicz_tpu_torch/csrc/softmax_argmax.cu",
            "replaces": "znicz_tpu/ops/pallas_kernels.py:382",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "floor_ms": floor_ms, "shape": [rows, c], "kernel_route": route}
    return rows_out


# ----------------------------------------------------------------------
# phase 3: the serving slice at full width
# ----------------------------------------------------------------------
def write_scorer_bundle(path: str, seq: int = SEQ, dim: int = DIM,
                        dtype: str = "bfloat16") -> None:
    """A bf16 attention → layer_norm → softmax scorer bundle in the
    reference's export format, weights from ``SEED`` (``seq`` × ``dim``
    samples: phase 3's unless told otherwise)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    t, d, c = seq, dim, CLASSES

    def normal(shape, std):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    params = {
        "layer0_weights": normal((d, 3 * d), d ** -0.5),
        "layer0_bias": normal((3 * d,), 0.1),
        "layer0_weights_out": normal((d, d), d ** -0.5),
        "layer0_bias_out": normal((d,), 0.1),
        "layer1_weights": 1.0 + normal((d,), 0.1),
        "layer1_bias": normal((d,), 0.1),
        "layer2_weights": normal((t * d, c), (t * d) ** -0.5),
        "layer2_bias": normal((c,), 0.1),
    }
    layers = [("attention", {"n_heads": HEADS, "causal": False}),
              ("layer_norm", {"eps": 1e-5}),
              ("softmax", {"output_sample_shape": c})]
    manifest = {
        "format": "znicz-tpu-forward", "version": 1,
        "workflow": "chip_smoke_scorer", "loss": "softmax",
        "input_shape": [t, d], "dtype": dtype, "kind": "scorer",
        "layers": [{"type": kind, "config": cfg, "has_weights": True,
                    "has_bias": True, "name": f"{kind}{i}"}
                   for i, (kind, cfg) in enumerate(layers)],
    }
    write_bundle(path, manifest, params)


def write_bundle(path: str, manifest: dict, params: dict) -> str:
    """``params`` beside ``manifest`` in the reference's ``.npz`` format."""
    import numpy as np
    np.savez(path, manifest=np.frombuffer(json.dumps(manifest).encode(),
                                          dtype=np.uint8), **params)
    return path


def unit_breakdown(model, x) -> None:
    """Device time of each unit of the chain at the full bucket."""
    import torch
    with torch.inference_mode():
        h = torch.from_numpy(x).to(model.dtype).to(model.device)
        parts = []
        for unit in model.forwards:
            parts.append(f"{type(unit).__name__} "
                         f"{time_ms(lambda: unit(h), 5):.4f} ms")
            h = unit(h)
    say(f"  per-unit device time at batch {x.shape[0]}: "
        + ", ".join(parts))


#: the wrappers' counters of launches by kind: by variant (flash), by
#: route (LRN, layer norm, dropout, softmax), by channel count and by
#: (rows, C) (LRN), by x's dtype (layer norm) and by class count
#: (softmax)
SPLIT_COUNTERS = ("launches_by_variant", "launches_by_route",
                  "launches_by_channels", "launches_by_shape",
                  "launches_by_dtype", "launches_by_classes")


def kernel_counters() -> dict:
    """Row name of the ``kernels`` line → (wrapper, (its counter by kind,
    the key its launches are counted under) or None for the wrapper's
    own count)."""
    from znicz_tpu_torch.ops import flash_attention as fa
    from znicz_tpu_torch.ops import fused_kernels as fk
    table = {}
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        for suffix, variant in ROW_VARIANT.items():
            table[fn.__name__ + suffix] = (fn, ("launches_by_variant",
                                                variant))
    for fn in (fk.lrn_forward, fk.lrn_backward):
        for suffix, key in LRN_ROW_KEYS.items():
            table[fn.__name__ + suffix] = (fn, key)
    for fn in (fk.layer_norm_forward, fk.layer_norm_backward):
        for suffix, dtype in LN_ROW_DTYPE.items():
            table[fn.__name__ + suffix] = (fn, ("launches_by_dtype", dtype))
    for suffix, c in SOFTMAX_ROW_CLASSES.items():
        table["softmax_argmax" + suffix] = (
            fk.softmax_argmax, ("launches_by_classes", c))
    table["dropout_apply"] = (fk.dropout_apply, None)
    return table


#: each wrapper's kernels as the profiler names them (in anonymous
#: namespaces, each name ending at ``<`` or ``(``), and how many of them
#: one call launches: B6 launches its rows kernel and its fold, the flash
#: backward's one template is the dq kernel with DKV false and the dk/dv
#: kernel with DKV true
DEVICE_KERNELS = {
    "flash_attention_fwd": (r"flash_fwd(_f32)?_kernel[<(]", 1),
    "flash_attention_dq": (r"flash_bwd(_f32)?_kernel<false", 1),
    "flash_attention_dkv": (r"flash_bwd(_f32)?_kernel<true", 1),
    "layer_norm_forward": (r"ln_fwd(_reg)?_kernel[<(]", 1),
    "layer_norm_backward": (r"ln_bwd_(rows|fold|reg|reg_fold)_kernel[<(]",
                            2),
    "lrn_forward": (r"lrn_fwd(_vec)?_kernel[<(]", 1),
    "lrn_backward": (r"lrn_bwd(_vec)?_kernel[<(]", 1),
    "dropout_apply": (r"dropout(_vec)?_kernel[<(]", 1),
    "softmax_argmax": (r"softmax_argmax(_reg)?_kernel[<(]", 1),
}


def wrapper_launches() -> dict:
    """Each wrapper's ``launches`` counter now, by its name."""
    return {fn.__name__: fn.launches
            for fn, _ in kernel_counters().values()}


def expect_device_launches(prof, before: dict, window: str,
                           no_kernels: bool = False,
                           last_try: bool = True) -> bool:
    """What the wrappers counted since ``before`` against the kernels the
    profiler saw run on the card in the same window, by name: equal for
    every wrapper.  On a graphed path the counts are the replay
    accounting (what a capture counted, once a replay), so this shows
    that the captured kernels ran on every replay.  With ``no_kernels``
    (a path that runs none, the autoencoder's) both must be empty.

    The profiler can lose a kernel's record (once it saw 2 of 3 replays'
    flash forward and every other kernel of the same replays).  So when
    the only disagreement is the profiler seeing fewer than counted and
    this is not the ``last_try``, it returns False for the caller to
    repeat the window; a replay that really skips a kernel skips it in
    every window.  Any other disagreement raises at once."""
    from torch.autograd import DeviceType
    ran = dict.fromkeys(DEVICE_KERNELS, 0)
    records = {}  # every device record of the window by name, for a miss
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        records[e.key] = records.get(e.key, 0) + e.count
        for name, (pattern, _) in DEVICE_KERNELS.items():
            if re.search(r"(?<!\w)" + pattern, e.key):
                ran[name] += e.count
    counted = {name: (n - before[name]) * DEVICE_KERNELS[name][1]
               for name, n in wrapper_launches().items()}
    seen = {name: (counted[name], ran[name]) for name in DEVICE_KERNELS
            if counted[name] or ran[name]}
    say(f"  {window}: kernel launches counted by the wrappers (× kernels a "
        f"call) against those the profiler saw run: {seen}")
    if not any(c != r for c, r in seen.values()) \
            and bool(seen) != no_kernels:
        return True
    say(f"  {window}: the window's device records by name: "
        + "; ".join(f"{n} {key[:72]}" for key, n in sorted(
            records.items(), key=lambda kv: -kv[1])))
    if not last_try and all(c >= r for c, r in seen.values()):
        say(f"  {window}: the profiler saw fewer kernels than were "
            f"counted; the window is repeated")
        return False
    raise AssertionError(f"{window}: the counted launches are not the "
                         f"kernels that ran: {seen}")


def reset_counts() -> None:
    """Every launch counter to 0."""
    for fn, _ in kernel_counters().values():
        fn.launches = 0
        for split in SPLIT_COUNTERS:
            counts = getattr(fn, split, {})
            for key in counts:
                counts[key] = 0


def read_counts() -> dict:
    """Row name → launches since :func:`reset_counts`."""
    return {name: getattr(fn, by[0])[by[1]] if by else fn.launches
            for name, (fn, by) in kernel_counters().items()}


def expect_counts(path: str, counts: dict, want: dict) -> None:
    """Each kernel's launches on one path: ``want`` gives the exact count
    of the kernels the path runs, every other kernel must read 0."""
    ran = {k: v for k, v in counts.items() if v}
    say(f"  launches on the {path} path: {ran}")
    bad = {k: (v, want.get(k, 0)) for k, v in counts.items()
           if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{path}: launches (got, want) {bad}")


def expect_only(path: str, counts: dict, name: str) -> None:
    """Launches on a path whose count the ladder's warm-up sets: ``name``
    launched, every other kernel not."""
    ran = {k: v for k, v in counts.items() if v}
    say(f"  launches on the {path} path: {ran}")
    if set(ran) != {name}:
        raise AssertionError(f"{path}: launches {ran}, want {name} only")


def expect_ln_register(path: str) -> None:
    """Every layer-norm launch since :func:`reset_counts` went by the
    register route: each path of phases 3, 4 and 6 runs at D = 512."""
    from znicz_tpu_torch.ops import fused_kernels as fk
    by_route = {fn.__name__: dict(fn.launches_by_route)
                for fn in (fk.layer_norm_forward, fk.layer_norm_backward)}
    say(f"  layer-norm launches on the {path} path by route: {by_route}")
    if any(counts["general"] for counts in by_route.values()):
        raise AssertionError(f"{path}: a layer-norm launch at D = {DIM} "
                             f"took the general route: {by_route}")


def expect_new_routes(path: str) -> None:
    """Every B3 and B4 launch since :func:`reset_counts` took the route
    rebuilt for Hopper: dropout's vector kernel and the softmax's
    register kernel (every path's tensors lie on 16-byte boundaries, and
    no head has more than 1024 classes)."""
    from znicz_tpu_torch.ops import fused_kernels as fk
    by_route = {fn.__name__: dict(fn.launches_by_route)
                for fn in (fk.dropout_apply, fk.softmax_argmax)}
    say(f"  dropout and softmax launches on the {path} path by route: "
        f"{by_route}")
    if by_route["dropout_apply"]["general"] \
            or by_route["softmax_argmax"]["general"]:
        raise AssertionError(f"{path}: a dropout or softmax launch took "
                             f"the old route: {by_route}")


def closed_loop(eng, x):
    """Sends ``eng`` 30 requests of 1, 3 and 16 rows of ``x`` in turn, each
    after the last reply; returns their latencies in seconds, sorted, and
    the rows served a second."""
    lat, rows = [], 0
    t_loop = time.perf_counter()
    for i in range(30):
        n = (1, 3, 16)[i % 3]
        t_req = time.perf_counter()
        eng(x[:n], timeout=300)
        lat.append(time.perf_counter() - t_req)
        rows += n
    return sorted(lat), rows / (time.perf_counter() - t_loop)


#: ``ExportedModel.graphed`` as the port has it, kept while a phase runs
#: the serving buckets eagerly
_SERVE_GRAPHED: list = []


def set_serve_graphs(on: bool) -> None:
    """Every serving bucket a CUDA graph, the port's way on the card
    (``ExportedModel.graphed``), or, off, the chain eagerly on the card
    over the same resident input buffer: the eager turns of phases 3,
    10, 12 and 14, for this process only."""
    from znicz_tpu_torch.export import ExportedModel
    if not _SERVE_GRAPHED:
        _SERVE_GRAPHED.append(ExportedModel.graphed)
    ExportedModel.graphed = _SERVE_GRAPHED[0] if on \
        else property(lambda self: False)


def serve_ab(eng, x, label: str, card: str) -> dict:
    """The closed loop of :func:`closed_loop` on a started engine, its
    buckets eager and graphed in the turns of :data:`AB_ORDER`: each
    turn's p50 (ms), rows/s and peak device memory (GiB) by mode."""
    import torch
    out = {"eager": [], "graphed": []}
    for mode in AB_ORDER:
        set_serve_graphs(mode == "graphed")
        torch.cuda.reset_peak_memory_stats()
        lat, rate = closed_loop(eng, x)
        out[mode].append((1e3 * lat[len(lat) // 2], rate,
                          torch.cuda.max_memory_allocated() / 2 ** 30))
    set_serve_graphs(True)

    def one(mode):
        return " / ".join(f"p50 {p:.3f} ms, {r:.1f} rows/s" for p, r, _
                          in out[mode]) + (f", peak device memory "
                                           f"{out[mode][0][2]:.2f} GiB")
    say(f"  {label}: 30 sequential requests (1/3/16 rows) a turn on "
        f"{card}, in turns {'/'.join(AB_ORDER)}: graphed {one('graphed')}; "
        f"eager {one('eager')}")
    return out


def expect_ladder_captures(eng, label: str) -> None:
    """The engine's model holds one captured graph a bucket of its
    ladder, and no other."""
    from znicz_tpu_torch.serving.buckets import ladder
    want = len(ladder(eng.max_batch))
    if eng.model.captures != want:
        raise AssertionError(f"{label}: {eng.model.captures} captures, "
                             f"the ladder has {want} buckets")


def graphed_dispatches(eng, x, kernels, label: str) -> dict:
    """Requests of 1, 3 and 16 rows through the started engine, graphed:
    each launches each of ``kernels`` exactly once (the replay
    accounting); returns the replies by row count."""
    import numpy as np
    replies = {}
    for n in (1, 3, 16):
        before = [k.launches for k in kernels]
        y = eng(x[:n], timeout=300)
        rose = [k.launches - b for k, b in zip(kernels, before)]
        say(f"  {label}: request of {n} rows → reply {y.shape}, launches "
            f"{dict(zip((k.__name__ for k in kernels), rose))}")
        if any(r != 1 for r in rose):
            raise AssertionError(f"{label}: the {n}-row dispatch did not "
                                 f"launch each kernel once: {rose}")
        if not np.isfinite(y).all():
            raise AssertionError(f"{label}: a {n}-row reply is not finite")
        replies[n] = y
    return replies


def serve_slice(path: str, kernels, card: str) -> dict:
    """Phase 3: the scorer through ``ServingEngine(max_batch=16)``, each
    bucket a CUDA graph captured at ``start()``: 1, 3 and 16 rows (each
    kernel once a dispatch), the closed loop eager and graphed in turns,
    and the 1-row reply against the CPU's."""
    import numpy as np
    import torch
    from znicz_tpu_torch.export import ExportedModel
    from znicz_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(SEED + 1)
    x = rng.normal(0.0, 0.3, size=(BATCH, SEQ, DIM)).astype(np.float32)

    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(path, max_batch=BATCH, max_delay_ms=2.0)
    try:
        eng.start()
        expect_ladder_captures(eng, "serving")
        say(f"  engine started in {time.perf_counter() - t0:.2f} s "
            f"(buckets {eng.stats()['buckets_warmed']}, "
            f"{eng.model.captures} captured, warmup "
            f"{eng.warmup_seconds:.2f} s; peak device memory while "
            f"capturing the ladder "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held after)")
        replies = graphed_dispatches(eng, x, kernels, "serving")
        for n, y in replies.items():
            if y.shape != (n, CLASSES) \
                    or np.abs(y.sum(axis=1) - 1.0).max() > 1e-4:
                raise AssertionError(f"bad {n}-row reply: {y}")
        serve_ab(eng, x, "the scorer", card)
        expect_ladder_captures(eng, "serving")
        launches = read_counts()
        expect_ln_register("serving")
        expect_new_routes("serving")
        unit_breakdown(eng.model, x)
    finally:
        eng.shutdown()

    cpu = ExportedModel.load(path, device="cpu")
    ref = cpu(x[:1])
    err = float(np.abs(ref - replies[1]).max())
    same = bool((ref.argmax(1) == replies[1].argmax(1)).all())
    say(f"  1-row reply vs ExportedModel(device='cpu'): max_abs_err "
        f"{err:.3g} (tol {SLICE_TOL}), argmax agree={same}")
    if err > SLICE_TOL or not same:
        raise AssertionError("the card's reply disagrees with the CPU's")
    ran = {k: v for k, v in launches.items() if v}
    say(f"  launches on the serving path: {ran}")
    return launches


# ----------------------------------------------------------------------
# phase 4: the training slice at full width
# ----------------------------------------------------------------------
#: the sequence stack's update: benchmarks/seq_bench.py's momentum at a
#: tenth of its rate.  At its rate (0.01) this full-width stack (a head
#: of fan-in T·D = 1 M over random labels) diverges on the card: the
#: layer-norm gain and the attention weights pass 1e4 by step 20 and
#: Σ g² overflows f32 by step 22, on the kernels and on their plain
#: versions alike, in bf16 and f32 (tools/seq_divergence.py); the guard
#: then skips every step.  At 1e-3 the run stays finite
SEQ_GD = {"learning_rate": 1e-3, "gradient_moment": 0.9}


def make_trainer(x, y, batch: int, device=None, precision: str = "bfloat16",
                 heads: int = HEADS, seq_parallel: bool = False):
    """The seq_bench stack through the port's ``StandardWorkflow``:
    attention (``heads`` heads; over the ring with ``seq_parallel``) →
    layer_norm → softmax, momentum SGD on every layer, train samples
    only."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.precision_type = precision
    prng.seed_all(SEED)
    gd = SEQ_GD
    wf = StandardWorkflow(
        name="chip_smoke_trainer",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x, train_labels=y, minibatch_size=batch),
        layers=[{"type": "attention",
                 "->": {"n_heads": heads, "causal": False,
                        "seq_parallel": seq_parallel}, "<-": gd},
                {"type": "layer_norm", "->": {}, "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": CLASSES},
                 "<-": gd}],
        decision_config={"max_epochs": 10 ** 6})
    wf.initialize(device=device)
    return wf


def train_flops(b: int) -> float:
    """Model FLOPs of one train step, ``benchmarks/seq_bench.py``'s
    count: the four D×D projections, the score and value products and
    the head, times three for forward and backward."""
    proj = 4 * 2.0 * b * SEQ * DIM * DIM
    scores = 2 * 2.0 * b * HEADS * SEQ * SEQ * (DIM // HEADS)
    head = 2.0 * b * SEQ * DIM * CLASSES
    return 3.0 * (proj + scores + head)


def step_breakdown(wf) -> None:
    """Device time of each unit of one train step, between the CUDA
    events that ``StandardWorkflow.step`` has recorded after each unit
    (host gaps included)."""
    import torch
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    wf.step(mark)
    torch.cuda.synchronize()
    parts = [f"{name} {a.elapsed_time(b):.4f} ms" for (_, a), (name, b)
             in zip(marks, marks[1:])]
    say("  per-unit device time of one train step: " + ", ".join(parts))


def device_busy(wf, steps: int = 3, window: str = "",
                no_kernels: bool = False) -> float | None:
    """The device's busy share over a few steady train steps: the sum of
    the CUDA kernels' times in a ``torch.profiler`` window over the
    window's host time (which ends in a synchronize); None when the
    profiler saw no device time.  The kernels' time a step is kept in
    ``BUSY_KERNEL_MS`` for phase 8.  In the same window the wrappers'
    counts must be the hand-written kernels the profiler saw run
    (:func:`expect_device_launches`; a window whose profiler lost a
    record is repeated, ``PROFILE_TRIES`` windows at most, each repeat
    after one more step in the profiler's warm-up); a
    ``window`` that the profiler saw nothing of fails when it names a
    graphed path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    for attempt in range(1, PROFILE_TRIES + 1):
        # a repeated window opens with one more step, whose records the
        # profiler's warm-up drops: on some hosts the first replay after
        # the profiler starts loses its opening kernels' records
        # whatever the margin (C18)
        warm = int(attempt > 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(
                         wait=0, warmup=1, active=1) if warm else None
                     ) as prof:
            for _ in range(warm):
                wf.step()
                torch.cuda.synchronize()
                prof.step()  # the warm-up ends; what follows is kept
            before = wrapper_launches()
            time.sleep(PROFILE_MARGIN_S)
            t0 = time.perf_counter()
            for _ in range(steps):
                wf.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_MARGIN_S)
        # kernels only: an operator's row repeats its kernels' time, and
        # the units' spans (``record_function`` ranges while the profiler
        # is open) show on the device lanes as the time between their
        # first and last kernel
        spans = {u.name for u in wf.units}
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in spans
                   and not e.key.startswith(("workflow:", "chunk:",
                                             "capture:"))]
        busy_ms = sum(device_ms(e) for e in kernels)
        if busy_ms <= 0.0:
            say("  device busy share: not measured (the profiler saw no "
                "device time)")
            if "graphed" in window:
                raise AssertionError(f"{window}: the profiler saw no "
                                     f"kernel, so nothing shows the "
                                     f"replays ran")
            return None
        if expect_device_launches(prof, before, window or "profiled steps",
                                  no_kernels,
                                  last_try=attempt == PROFILE_TRIES):
            break
    top = sorted(kernels, key=device_ms, reverse=True)[:10]
    BUSY_KERNEL_MS.append(busy_ms / steps)
    say(f"  device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms over {steps} "
        f"profiled train steps ({100 * busy_ms / wall_ms:.1f} % busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f} % idle); kernels by time, "
        f"ms a step: " + "; ".join(f"{e.key[:48]} {device_ms(e) / steps:.3f}"
                                   for e in top))
    return busy_ms / wall_ms


def timed_steps(wf, warmup: int, steps: int) -> float:
    """``warmup`` then ``steps`` train steps; the mean device time of the
    latter between CUDA events, in ms."""
    import torch
    for _ in range(warmup):
        wf.step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        wf.step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def train_slice(precision: str = "bfloat16") -> dict:
    """The sequence stack trained at full width in ``precision``: 2 + 10
    timed steps, each flash kernel of that dtype launched once a step;
    then one step at B=2 held against the CPU's."""
    import math
    import numpy as np
    import torch
    from znicz_tpu_torch.loader.base import TRAIN
    rng = np.random.default_rng(SEED + 2)
    n = 4 * BATCH
    # the dataset resident in the working dtype (bf16 as seq_bench
    # stores it)
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(n, SEQ, DIM))
                         .astype(np.float32)).to(getattr(torch, precision))
    y = rng.integers(0, CLASSES, size=n).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf = make_trainer(x, y, BATCH, precision=precision)
    say(f"  StandardWorkflow.initialize() on {wf.device} in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(type(u).__name__ for u in wf.forwards) + " / "
        + ", ".join(type(u).__name__ for u in wf.gds))
    if wf.device.type != "cuda":
        raise AssertionError(f"initialize() chose {wf.device}")
    reset_counts()
    warmup, steps = 2, 10
    step_ms = timed_steps(wf, warmup, steps)
    launches = read_counts()
    say(f"  {warmup} + {steps} train steps (B={BATCH}, T={SEQ}, D={DIM}, "
        f"{HEADS} heads, {precision})")
    n_steps = warmup + steps
    flash = "" if precision == "bfloat16" else "_f32"
    path = "training" if precision == "bfloat16" else "seq_f32"
    expect_counts(path, launches, {
        **{f"flash_attention_{k}{flash}": n_steps
           for k in ("fwd", "dq", "dkv")},
        f"layer_norm_forward{flash}": n_steps,
        f"layer_norm_backward{flash}": n_steps,
        "softmax_argmax_small": n_steps})
    expect_ln_register(path)
    expect_new_routes(path)
    loss = wf.decision.epoch_loss[TRAIN]
    if loss is None or not math.isfinite(loss):
        raise AssertionError(f"train loss {loss}")
    flops = train_flops(BATCH)
    peak = PEAK_BF16_FLOP_S if precision == "bfloat16" else PEAK_F32_FLOP_S
    say(f"  step {step_ms:.3f} ms, {BATCH * SEQ / step_ms * 1e3:.0f} "
        f"tokens/s, MFU {flops / (step_ms * 1e-3) / peak:.4f} "
        f"({flops:.4g} FLOP/step against {peak:.3g}), mean "
        f"train loss of the last epoch {loss:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    step_breakdown(wf)
    EAGER[f"seq_{precision}"] = {"step_ms": step_ms,
                                 "busy": device_busy(wf, window=path)}
    del wf
    check_step_on_cpu(
        lambda device: make_trainer(x[:2], y[:2], 2, device, precision),
        f"B=2, {precision}",
        TRAIN_STEP_TOL if precision == "bfloat16" else TRAIN_STEP_TOL_F32)
    return launches


def step_updates(wf) -> dict:
    """One step of ``wf``: each parameter's update (``unit.name``), as
    f32 on the CPU."""
    params = {f"{u.name}.{name}": p for u in wf.forwards
              for name, p in u.named_parameters()}
    before = {k: p.detach().float().cpu().clone() for k, p in params.items()}
    wf.step()
    return {k: p.detach().float().cpu() - before[k]
            for k, p in params.items()}


def max_rel(got, want) -> float:
    """max|got − want| / max|want|."""
    return float((got - want).abs().max() / want.abs().max())


def norm_rel(got, want) -> float:
    """‖got − want‖ / ‖want‖."""
    return float((got - want).norm() / want.norm())


def check_finite(updates: dict) -> None:
    import torch
    for name, u in updates.items():
        if not bool(torch.isfinite(u).all()) or float(u.abs().max()) == 0.0:
            raise AssertionError(f"the update of {name} is not finite or "
                                 f"is zero")


def check_step_on_cpu(make, label: str, tol: float) -> None:
    """One train step on the card and on the CPU from the same seed and
    data (``make(device)`` builds the workflow): each parameter's
    update must agree with the CPU's, the largest difference relative
    to the largest |update|."""
    t0 = time.perf_counter()
    card, cpu = step_updates(make(None)), step_updates(make("cpu"))
    check_finite(card)
    worst = max(max_rel(card[k], cpu[k]) for k in cpu)
    worst_norm = max(norm_rel(card[k], cpu[k]) for k in cpu)
    say(f"  one train step ({label}) on the card vs the CPU: {len(card)} "
        f"parameter updates, worst max|card − cpu| / max|cpu update| "
        f"{worst:.3g} (tol {tol}), worst ‖card − cpu‖ / ‖cpu update‖ "
        f"{worst_norm:.3g}, {time.perf_counter() - t0:.1f} s")
    if worst > tol:
        raise AssertionError("the card's train step disagrees with the "
                             "CPU's")


# ----------------------------------------------------------------------
# phase 5: AlexNet training at full width
# ----------------------------------------------------------------------
#: One AlexNet train step (B=2, dropout on) on the card against the same
#: step on the CPU, each parameter's update.  Both draw the same dropout
#: masks (one seed, the same Philox bits) and round at the same points;
#: cuDNN and the CPU's convolutions sum in other orders, which flips
#: roundings.  f32: the largest difference relative to the largest
#: |update|, as for the sequence stack (TRAIN_STEP_TOL).  bf16 rounds
#: every conv output and δ to 8 bits, and at the reference's init
#: (stddev 0.01) the first step's bias updates of the first convs are
#: sums of thousands of such terms that largely cancel, so a flipped
#: rounding moves them by several percent; no fixed fraction of the
#: update separates that from a fault.  The yardstick is instead each
#: parameter's own rounding noise, measured in the same run: the CPU's
#: bf16 update against its f32 update of the same step.  The card's
#: flips are a subset of those roundings, so ‖card − cpu‖ stays about
#: that size (√2 of it if they were independent); ALEX_NOISE_FACTOR
#: bounds the ratio.  A planted wrong mask must fail the same bound.
ALEX_NOISE_FACTOR = 2.0
#: planted faults, card only, each applied after its forward unit ran:
#: the dropout backward regenerates the mask of the next seed (B3), or
#: the LRN backward takes a window of 4 (B2's adjoint window of n = 4).
#: The second is printed, not required: at this init the window's term
#: of the LRN gradient is ~1e-5 of its first term, far under a bf16
#: rounding, so no step check can see it; phase 2's n = 4 cases hold
#: the window.
FAULTS = {"dropout mask of seed + 1": ("DropoutForward", "seed", 1),
          "LRN backward n = 4": ("LRNormalizerForward", "n", -1)}


def plant(wf, fault: str) -> None:
    """Shift one attribute of each forward unit of a kind just after it
    ran, so its backward unit reads the shifted value."""
    kind, attr, shift = FAULTS[fault]
    for unit in wf.forwards:
        if type(unit).__name__ != kind:
            continue
        forward = unit.forward

        def shifted(x, unit=unit, forward=forward):
            y = forward(x)
            setattr(unit, attr, getattr(unit, attr) + shift)
            return y
        unit.forward = shifted


def check_alexnet_step() -> None:
    """The B=2 AlexNet step, card against CPU, in f32 and bf16, each
    parameter's reading printed; then the planted faults."""
    import math
    t0 = time.perf_counter()

    def updates(device, precision, fault=None):
        wf = make_alexnet(2, 2, device, precision)
        if fault:
            plant(wf, fault)
        return step_updates(wf)

    cpu = {p: updates("cpu", p) for p in ("float32", "bfloat16")}
    card = {p: updates(None, p) for p in ("float32", "bfloat16")}
    for ups in card.values():
        check_finite(ups)
    f32, bf16 = card["float32"], card["bfloat16"]
    cpu32, cpu16 = cpu["float32"], cpu["bfloat16"]
    noise = {k: float((cpu16[k] - cpu32[k]).norm()) for k in cpu16}

    def ratio(got, k):
        diff = float((got - cpu16[k]).norm())
        return diff / noise[k] if noise[k] else (0.0 if not diff else math.inf)

    say(f"  AlexNet B=2, dropout on, one train step on the card vs the "
        f"CPU, by parameter: f32 max-rel = max|card − cpu| / max|cpu "
        f"update| (tol {TRAIN_STEP_TOL}); bf16 max-rel, norm-rel = "
        f"‖card − cpu‖ / ‖cpu update‖, noise = ‖cpu bf16 − cpu f32‖ / "
        f"‖cpu update‖, ratio = ‖card − cpu‖ / ‖cpu bf16 − cpu f32‖ (tol "
        f"{ALEX_NOISE_FACTOR})")
    for k in cpu16:
        say(f"    {k:32s} f32 max-rel {max_rel(f32[k], cpu32[k]):.3g}; "
            f"bf16 max-rel {max_rel(bf16[k], cpu16[k]):.3g}, norm-rel "
            f"{norm_rel(bf16[k], cpu16[k]):.3g}, noise "
            f"{noise[k] / float(cpu16[k].norm()):.3g}, ratio "
            f"{ratio(bf16[k], k):.3g}")
    worst32 = max(cpu32, key=lambda k: max_rel(f32[k], cpu32[k]))
    worst16 = max(cpu16, key=lambda k: ratio(bf16[k], k))
    w32, w16 = max_rel(f32[worst32], cpu32[worst32]), ratio(bf16[worst16],
                                                            worst16)
    say(f"  worst: f32 max-rel {w32:.3g} ({worst32}), bf16 ratio "
        f"{w16:.3g} ({worst16})")
    if w32 > TRAIN_STEP_TOL or w16 > ALEX_NOISE_FACTOR:
        raise AssertionError("the card's AlexNet step disagrees with the "
                             "CPU's")
    for fault in FAULTS:
        bad = updates(None, "bfloat16", fault)
        k = max(cpu16, key=lambda k: ratio(bad[k], k))
        caught = ratio(bad[k], k) > ALEX_NOISE_FACTOR
        say(f"  planted fault '{fault}': worst bf16 ratio "
            f"{ratio(bad[k], k):.3g} ({k}), max-rel "
            f"{max_rel(bad[k], cpu16[k]):.3g}: "
            f"{'caught' if caught else 'not caught'}")
        if fault.startswith("dropout") and not caught:
            raise AssertionError("the step check passes a wrong dropout "
                                 "mask")
    say(f"  AlexNet step checks in {time.perf_counter() - t0:.1f} s")


def make_alexnet(batch: int, n_train: int, device=None,
                 precision: str = "bfloat16"):
    """``models/samples/alexnet.py``'s net at full width, fed ``n_train``
    synthetic uint8 frames and no validation set, so that every step is
    a train step."""
    from znicz_tpu_torch.models.samples import alexnet
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.precision_type = precision
    prng.seed_all(SEED)
    wf = alexnet.build(minibatch_size=batch, n_train_samples=n_train,
                       n_valid_samples=0)
    wf.initialize(device=device)
    return wf


def alexnet_flops(wf) -> float:
    """Model FLOPs of one train step, ``bench.py``'s ``train_step_flops``:
    2·MACs of each conv and fully connected forward, times three for the
    forward, the input gradient and the weight gradient; pooling, LRN
    and the elementwise work are not counted."""
    import math
    batch = wf.loader.max_minibatch_size
    fwd = 0.0
    for unit in wf.forwards:
        weights = getattr(unit, "weights", None)
        if weights is None:
            continue
        if hasattr(unit, "kx"):  # conv: NHWC output, kernel kx·ky·Cin
            fwd += (2.0 * batch * math.prod(unit.output_shape) * unit.kx
                    * unit.ky * unit.input_shape[-1])
        else:
            fwd += 2.0 * batch * weights.numel()
    return 3.0 * fwd


def alexnet_slice() -> dict:
    import math
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    from znicz_tpu_torch.loader.base import TRAIN
    warmup, steps = 2, 10
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf = make_alexnet(ALEX_BATCH, (warmup + steps) * ALEX_BATCH)
    say(f"  alexnet.build() + initialize() on {wf.device} in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(type(u).__name__ for u in wf.forwards))
    if wf.device.type != "cuda":
        raise AssertionError(f"initialize() chose {wf.device}")
    data = wf.loader.original_data
    say(f"  dataset on the device: {tuple(data.shape)} {data.dtype}, "
        f"{data.numel() * data.element_size() / 2 ** 20:.1f} MiB")
    dropouts = [u for u in wf.forwards if type(u).__name__ == "DropoutForward"]
    seeds = []  # each step's seed tensors (new ones every eager step)
    wf.add_step_hook(lambda: seeds.append([u.seed for u in dropouts]))
    reset_counts()
    t_host = time.perf_counter()
    step_ms = timed_steps(wf, warmup, steps)
    host_s = time.perf_counter() - t_host
    launches = read_counts()
    n = warmup + steps
    say(f"  {warmup} + {steps} train steps (B={ALEX_BATCH}, 227×227×3, "
        f"bf16, dropout 0.5) in {host_s:.2f} s on the host clock")
    expect_counts("alexnet", launches, {
        "lrn_forward": n, "lrn_forward_conv2": n, "lrn_backward": n,
        "lrn_backward_conv2": n, "dropout_apply": 4 * n,
        "softmax_argmax": n})
    expect_new_routes("alexnet")
    routes = {fn.__name__: dict(fn.launches_by_route)
              for fn in (fk.lrn_forward, fk.lrn_backward)}
    say(f"  B1/B2 launches by route: {routes}")
    if any(r != {"vector": 2 * n, "general": 0} for r in routes.values()):
        raise AssertionError(f"alexnet: B1/B2 off the vector route: {routes}")
    loss = wf.decision.epoch_loss[TRAIN]
    if loss is None or not math.isfinite(loss):
        raise AssertionError(f"train loss {loss}")
    flops = alexnet_flops(wf)
    say(f"  step {step_ms:.3f} ms, {ALEX_BATCH / step_ms * 1e3:.1f} img/s, "
        f"MFU {flops / (step_ms * 1e-3) / PEAK_BF16_FLOP_S:.4f} "
        f"({flops:.4g} FLOP/step against {PEAK_BF16_FLOP_S:.3g}), mean "
        f"train loss of the epoch {loss:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    step_breakdown(wf)
    EAGER["alexnet"] = {"step_ms": step_ms,
                        "busy": device_busy(wf, window="alexnet"),
                        "seeds": [[int(t) for t in step] for step in seeds]}
    del wf
    check_alexnet_step()
    return launches


# ----------------------------------------------------------------------
# phase 6: the sequence stack in f32 and at other head dims
# ----------------------------------------------------------------------
def seq_pass(path: str, precision: str, heads: int, variant: str) -> dict:
    """A short training run of the sequence stack (B=4, T=1024, D=512)
    in ``precision`` with ``heads`` heads: each flash kernel launches
    once a step, all of them the kernels of ``variant``."""
    import math
    import numpy as np
    import torch
    from znicz_tpu_torch.loader.base import TRAIN
    batch, seq, steps = 4, 1024, 4
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(batch * steps, seq, DIM))
                         .astype(np.float32))
    if precision == "bfloat16":
        x = x.to(torch.bfloat16)
    y = rng.integers(0, CLASSES, size=batch * steps).astype(np.int32)
    wf = make_trainer(x, y, batch, precision=precision, heads=heads)
    reset_counts()
    for _ in range(steps):
        wf.step()
    torch.cuda.synchronize()
    launches = read_counts()
    loss = wf.decision.epoch_loss[TRAIN]
    say(f"  {path}: {steps} train steps (B={batch}, T={seq}, D={DIM}, "
        f"{heads} heads, dh={DIM // heads}, {precision}), loss {loss:.4f}")
    suffix = {v: s for s, v in ROW_VARIANT.items()}[variant]
    ln = {dtype: s for s, dtype in LN_ROW_DTYPE.items()}[precision]
    expect_counts(path, launches, {
        **{f"flash_attention_{k}{suffix}": steps
           for k in ("fwd", "dq", "dkv")},
        f"layer_norm_forward{ln}": steps, f"layer_norm_backward{ln}": steps,
        "softmax_argmax_small": steps})
    expect_ln_register(path)
    expect_new_routes(path)
    if loss is None or not math.isfinite(loss):
        raise AssertionError(f"{path}: train loss {loss}")
    return launches


def dh4_pass() -> dict:
    """``models/samples/attention_seq.py`` at its defaults (dh = 4) on
    the card: the attention core is the plain one, as the reference
    routes it, so no flash kernel launches, and its head of 3 classes
    launches the softmax once a step (counted in the 3-class row,
    ``softmax_argmax_wine``); the loss must fall."""
    import torch
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.models.samples import attention_seq
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.precision_type = "float32"
    prng.seed_all(9)
    wf = attention_seq.build(max_epochs=3, n_train=192, n_valid=48)
    wf.initialize()
    reset_counts()
    losses, steps = [], 0
    while not wf.decision.complete:
        wf.step()
        steps += 1
        if wf.decision.epoch_ended:
            losses.append(wf.decision.epoch_loss[TRAIN])
    torch.cuda.synchronize()
    launches = read_counts()
    say(f"  seq_dh4: attention_seq sample on {wf.device} (dh=4), train "
        f"loss by epoch {[round(v, 4) for v in losses]}, best validation "
        f"error {wf.decision.min_validation_n_err_pt:.1f} %")
    expect_counts("seq_dh4", launches, {"softmax_argmax_wine": steps})
    expect_new_routes("seq_dh4")
    if not losses[-1] < losses[0]:
        raise AssertionError("seq_dh4: the loss did not fall")
    return launches


# ----------------------------------------------------------------------
# phase 7: CIFAR-10 through the port's CLI, with snapshots and resume
# ----------------------------------------------------------------------
#: epochs of the uninterrupted run; it writes a snapshot at the end of
#: epoch CIFAR_EPOCHS − 2, from which the resumed runs train the last
#: epoch again.  An epoch of the synthetic stand-in is 10 test, 5
#: validation and 45 train minibatches.  The reference's validation
#: error on the CPU (``python -m znicz_tpu cifar --root
#: cifar.max_epochs=7``, seed 1234) falls 90.6, 82.4, 55.6, 24.6, 2.8,
#: 1.2, then 1.4 %.
CIFAR_EPOCHS = 8
CIFAR_STEPS, CIFAR_TRAIN_STEPS = 60, 45
#: the best validation error must fall under half of chance (90 %)
CIFAR_MAX_ERR_PT = 45.0
#: Two CIFAR runs on the card do not give the same bits: cuDNN's filter
#: gradient (``wgrad_alg0``) adds with atomics, and two runs from one
#: seed part by epoch 3 (25.8 against 26.8 % validation error).  So the
#: snapshot is written by the uninterrupted run itself at the end of the
#: last epoch but one, and a run resumed from it with ``-s`` retrains the
#: last epoch.  Each of its tensors (parameters, momentum, evaluator
#: sums) must lie within CIFAR_STEP_TOL of the uninterrupted run's after
#: the first train step, and within CIFAR_EPOCH_TOL at the end, as
#: ‖resumed − straight‖ / ‖straight‖; its counters (loader, decision,
#: evaluator) must be equal, since the last epoch's test and validation
#: errors come from the snapshot's weights.  One step from the same state
#: differs only where the card adds in another order, a few f32 ulps of
#: a reduction (~1e-7 of a tensor); over the epoch's 45 steps such
#: differences grow, as training amplifies them, to ~1e-3 (PERF.md, the
#: CIFAR resume runs).  A resume that lost its momentum moves a tensor by
#: its whole size after one step, and one that lost the decision's state
#: counts differently; the planted faults below must fail the check.
CIFAR_STEP_TOL, CIFAR_EPOCH_TOL = 1e-5, 1e-2


def zero_momentum(state: dict) -> None:
    for unit in state["__units__"].values():
        for key in unit:
            if key.startswith("accumulated_gradient"):
                unit[key] = unit[key] * 0


def drop_decision(state: dict) -> None:
    state["__units__"]["decision"] = {}
    state["__units__"]["evaluator"] = {}


#: faults planted in a copy of the snapshot: the momentum lost, and the
#: decision's and evaluator's state lost (C8)
CIFAR_FAULTS = {"momentum lost": zero_momentum,
                "decision state lost": drop_decision}


def cifar_cli(snapshots: str, *args: str, snapshot_at: int | None = None):
    """``python -m znicz_tpu_torch cifar <args>`` in this process, on the
    card (no ``-b``), writing its snapshots into ``snapshots`` (and,
    with ``snapshot_at``, ``cifar_epoch<k>`` at the end of epoch k
    through ``Snapshotter.write``, as the emergency snapshot is
    written).  Returns the ``Main`` that ran, the validation error and
    the region's graph captures at the end of each epoch, and the run's
    state (:func:`run_state`) after each of the first two decisions of a
    train minibatch in its last epoch (after the first two train steps;
    under ``--chunk``, after the first two chunks)."""
    from znicz_tpu_torch.__main__ import Main
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    from znicz_tpu_torch.ops.decision import DecisionGD
    from znicz_tpu_torch.utils.config import reset_root, root
    from znicz_tpu_torch.utils.snapshotter import Snapshotter
    reset_root()
    root.common.dirs.snapshots = snapshots
    errors, captures, train_steps = [], [], []
    decide = DecisionGD.run

    def decide_and_record(decision):
        decide(decision)
        wf = decision.workflow
        if wf.loader.minibatch_class == TRAIN and len(train_steps) < 2 \
                and wf.loader.epoch_number == decision.max_epochs - 1:
            train_steps.append(run_state(wf))
        if not decision.epoch_ended:
            return
        errors.append(decision.epoch_n_err_pt[VALID])
        captures.append(wf.region.captures)
        if wf.loader.epoch_number == snapshot_at:
            Snapshotter.write(wf.state_dict(), snapshots, "cifar",
                              f"epoch{snapshot_at}")

    DecisionGD.run = decide_and_record
    try:
        main = Main()
        rc = main.run(["cifar", *args])
    finally:
        DecisionGD.run = decide
    if rc:
        raise AssertionError(f"cifar {args}: exit code {rc}")
    return main, errors, captures, train_steps


def run_state(wf) -> dict:
    """The state a resumed run must reproduce, flat: each unit's
    tensors and counters, the loader's schedule and the generator."""
    import numpy as np
    flat = {}
    for unit, values in wf.state_dict()["__units__"].items():
        for key, value in values.items():
            flat[f"{unit}.{key}"] = value
    flat["prng"] = str(wf.state_dict()["__prng__"]["numpy_state"])
    return {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in flat.items()}


def state_diff(a: dict, b: dict) -> tuple[dict, list]:
    """``({tensor: ‖a − b‖ / ‖a‖}, [other keys that differ])``."""
    import numpy as np
    rel, other = {}, []
    for key, va in a.items():
        vb = b[key]
        if isinstance(va, np.ndarray) and va.dtype.kind == "f":
            d = float(np.linalg.norm(va - vb))
            rel[key] = d / max(float(np.linalg.norm(va)), 1e-30)
        elif isinstance(va, np.ndarray):
            if not np.array_equal(va, vb):
                other.append(key)
        elif va != vb:
            other.append(key)
    return rel, other


def cifar_pass() -> dict:
    """CIFAR-10 trained through ``Main().run(["cifar", ...])`` on the
    card: the launches of an uninterrupted run, its validation error by
    epoch, the train step time, images/s, per-unit device time and busy
    share; then two runs resumed with ``-s`` from the snapshot the
    uninterrupted run wrote an epoch before its end must stay with it
    (:data:`CIFAR_STEP_TOL`, :data:`CIFAR_EPOCH_TOL`, equal counters),
    and runs from snapshots with planted faults must not; the snapshot
    loads back through the port's ``Snapshotter.load`` with its sidecar
    checked."""
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.utils.snapshotter import Snapshotter
    tmp = tempfile.mkdtemp(prefix="cifar_snapshots_")
    reset_counts()
    t0 = time.perf_counter()
    main, errors, _, straight_steps = cifar_cli(
        os.path.join(tmp, "straight"), "--root",
        f"cifar.max_epochs={CIFAR_EPOCHS}", snapshot_at=CIFAR_EPOCHS - 2)
    straight_step = straight_steps[0]
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    wf = main.launcher.workflow
    if wf.device.type != "cuda":
        raise AssertionError(f"the CLI chose {wf.device}")
    say(f"  python -m znicz_tpu_torch cifar --root cifar.max_epochs="
        f"{CIFAR_EPOCHS}: {CIFAR_EPOCHS} epochs on {wf.device} in "
        f"{host_s:.2f} s on the host clock (build, initialize and the "
        f"first calls included), dataset {tuple(wf.loader.class_lengths)} "
        f"(test, validation, train); validation error by epoch, %: "
        f"{[round(e, 2) for e in errors]}")
    steps, train = CIFAR_EPOCHS * CIFAR_STEPS, CIFAR_EPOCHS * CIFAR_TRAIN_STEPS
    expect_counts("cifar", launches, {
        "lrn_forward_cifar1": steps, "lrn_forward_cifar2": steps,
        "lrn_backward_cifar1": train, "lrn_backward_cifar2": train,
        "softmax_argmax_cifar": steps})
    expect_new_routes("cifar")
    routes = {fn.__name__: dict(fn.launches_by_route)
              for fn in (fk.lrn_forward, fk.lrn_backward)}
    say(f"  B1/B2 launches by route: {routes}")
    if routes != {"lrn_forward": {"vector": 2 * steps, "general": 0},
                  "lrn_backward": {"vector": 2 * train, "general": 0}}:
        raise AssertionError(f"cifar: B1/B2 off the vector route: {routes}")
    best = wf.decision.min_validation_n_err_pt
    if len(errors) != CIFAR_EPOCHS or not best < CIFAR_MAX_ERR_PT:
        raise AssertionError(f"cifar: best validation error {best} % (want "
                             f"< {CIFAR_MAX_ERR_PT} %)")
    straight = run_state(wf)

    # timing: the next epoch's 15 test and validation minibatches, then
    # train minibatches only
    for _ in range(CIFAR_STEPS - CIFAR_TRAIN_STEPS):
        wf.step()
    warmup, timed = 2, 20
    step_ms = timed_steps(wf, warmup, timed)
    if wf.loader.minibatch_class != TRAIN:
        raise AssertionError("cifar: a timed step was not a train step")
    say(f"  train step (B={CIFAR_BATCH}, f32) {step_ms:.4f} ms over "
        f"{timed} steps after {warmup}, "
        f"{CIFAR_BATCH / step_ms * 1e3:.0f} img/s")
    step_breakdown(wf)
    busy = device_busy(wf, window="cifar")

    # resume: the last epoch again from the snapshot of the one before
    path = os.path.join(tmp, "straight",
                        f"cifar_epoch{CIFAR_EPOCHS - 2}.pickle.gz")
    state = Snapshotter.load(path)  # the sidecar's digest checked
    if not os.path.exists(path + ".sha256") or state["__units__"][
            wf.loader.name]["epoch_number"] != CIFAR_EPOCHS - 2:
        raise AssertionError(f"cifar: snapshot {path} has no sidecar or "
                             f"the wrong epoch")

    def resume(name: str, snapshot: str) -> tuple[float, float, list]:
        """``-s snapshot`` to the end: the worst distance from the
        uninterrupted run after the first train step and at the end, and
        the counters that differ."""
        main, _, _, first = cifar_cli(
            os.path.join(tmp, name), "-s", snapshot, "--root",
            f"cifar.max_epochs={CIFAR_EPOCHS}")
        step_rel, step_other = state_diff(straight_step, first[0])
        rel, other = state_diff(straight, run_state(main.launcher.workflow))
        worst = max(rel, key=rel.get)
        say(f"    {name}: after one step worst {max(step_rel.values()):.3g}"
            f", at the end worst {rel[worst]:.3g} ({worst}), "
            f"{sum(v == 0.0 for v in rel.values())} of {len(rel)} tensors "
            f"bit-equal, counters that differ: {sorted(set(step_other + other))}")
        return max(step_rel.values()), rel[worst], step_other + other

    def passes(step_err: float, end_err: float, other: list) -> bool:
        return (step_err <= CIFAR_STEP_TOL and end_err <= CIFAR_EPOCH_TOL
                and not other)

    say(f"  resume: {os.path.basename(path)} (written by the uninterrupted "
        f"run at the end of epoch {CIFAR_EPOCHS - 2}, sidecar checked by "
        f"Snapshotter.load), epoch {CIFAR_EPOCHS - 1} again through -s; "
        f"‖resumed − straight‖ / ‖straight‖ by tensor (tol "
        f"{CIFAR_STEP_TOL} after one step, {CIFAR_EPOCH_TOL} at the end)")
    for i in range(2):
        if not passes(*resume(f"resumed{i}", path)):
            raise AssertionError("cifar: the resumed run leaves the "
                                 "uninterrupted one")
    for fault, plant in CIFAR_FAULTS.items():
        planted = copy.deepcopy(state)
        plant(planted)
        name = "planted_" + fault.replace(" ", "_")
        bad = Snapshotter.write(planted, os.path.join(tmp, name), "cifar",
                                name)
        if passes(*resume(name, bad)):
            raise AssertionError(f"cifar: the resume check passes a "
                                 f"planted fault ({fault})")
    EAGER["cifar"] = {"step_ms": step_ms, "busy": busy, "errors": errors,
                      "straight": straight, "steps": straight_steps,
                      "snapshot": path, "tmp": tmp}
    return launches


# ----------------------------------------------------------------------
# phase 8: the three training paths with their regions as CUDA graphs
# ----------------------------------------------------------------------
_GRAPHED: list = []


def set_graphs(on: bool) -> None:
    """Every region graphed, the port's way on the card
    (``JitRegion.graphed``: on the card, with no ``mark``), or, off, run
    eagerly on the card as a ``mark``ed step runs: the eager baseline of
    phases 4–7 and of phase 8's turns, for this process only."""
    from znicz_tpu_torch.accelerated_units import JitRegion
    if not _GRAPHED:
        _GRAPHED.append(JitRegion.graphed)
    JitRegion.graphed = _GRAPHED[0] if on else property(lambda self: False)


#: the order of the eager and graphed timings of one workflow in phase 8:
#: each mode twice, in turns, so that a drift of the host's speed over
#: the call falls on both
AB_ORDER = ("eager", "graphed", "graphed", "eager")


def ab_steps(wf, name: str, warmup: int, steps: int, ready=None,
             no_kernels: bool = False) -> dict:
    """Train step times (ms, CUDA events) of one workflow with its region
    eager and graphed, in the turns of :data:`AB_ORDER`, then each
    mode's busy share over 3 profiled steps, in whose windows the
    counted launches must be the kernels that ran (the path's ``name``
    printed; ``no_kernels``: none on either side); ``ready(n)`` first
    makes the next n steps train steps."""
    out = {"eager": [], "graphed": []}
    for mode in AB_ORDER:
        set_graphs(mode == "graphed")
        if ready:
            ready(warmup + steps)
        out[mode].append(timed_steps(wf, warmup, steps))
    for mode in ("eager", "graphed"):
        set_graphs(mode == "graphed")
        if ready:
            ready(3)
        out[f"{mode}_busy"] = device_busy(wf, window=f"{name} {mode}",
                                          no_kernels=no_kernels)
        out[f"{mode}_kernel_ms"] = BUSY_KERNEL_MS[-1] if out[
            f"{mode}_busy"] is not None else None
    set_graphs(True)
    return out


def ab_line(ab: dict, per_step: float, unit: str) -> str:
    """``graphed … ms (rate, busy), eager … ms (rate, busy)``, each
    mode's two readings with the rate of the first; beside the
    profiler's busy share (whose short window the host's profiled
    overhead dilutes), the kernels' time a step over the unprofiled
    step time."""
    def one(mode):
        ms = ab[mode]
        kernel = ab[mode + "_kernel_ms"]
        share = ("not measured" if kernel is None else
                 f"kernels {kernel:.4f} ms a step, "
                 f"{100 * kernel * len(ms) / sum(ms):.1f} % of the step")
        return (f"{mode} {' / '.join(f'{v:.4f}' for v in ms)} ms "
                f"({per_step / ms[0] * 1e3:.0f} {unit}, busy "
                f"{pct(ab[mode + '_busy'])} in the profiler's window, "
                f"{share})")
    return one("graphed") + "; " + one("eager")


def cifar_graphed(card: str) -> dict:
    """CIFAR-10 through ``Main().run(["cifar", "--chunk", "16", ...])``:
    8 epochs, the region replayed (16 steps a dispatch); exact launch
    counts through the replay accounting, one capture a key and none
    after the first epoch, the validation bar of phase 7; then the last
    epoch again from phase 7's snapshot, graphed step by step and in
    chunks, against phase 7's eager run (CIFAR_STEP_TOL after the first
    and the second train step, the first a warm-up and the second a
    replay; CIFAR_EPOCH_TOL at the end; counters equal); the train step
    graphed and in chunks beside phase 7's eager step; ``--dump-graph``
    names the region."""
    import torch
    from znicz_tpu_torch.__main__ import Main
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.observe import metrics
    eager = EAGER["cifar"]
    tmp = eager["tmp"]
    reset_counts()
    before = metrics.graph_captures("train_region").value
    t0 = time.perf_counter()
    main, errors, captures, _ = cifar_cli(
        os.path.join(tmp, "graphed"), "--chunk", "16", "--root",
        f"cifar.max_epochs={CIFAR_EPOCHS}")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    wf = main.launcher.workflow
    steps, train = CIFAR_EPOCHS * CIFAR_STEPS, CIFAR_EPOCHS * CIFAR_TRAIN_STEPS
    say(f"  python -m znicz_tpu_torch cifar --chunk 16: {CIFAR_EPOCHS} "
        f"epochs in {host_s:.2f} s on the host clock (build and initialize "
        f"included); validation error by epoch, %: "
        f"{[round(e, 2) for e in errors]} (eager, phase 7: "
        f"{[round(e, 2) for e in eager['errors']]}); graph captures at "
        f"each epoch's end {captures} (counter "
        f"{metrics.graph_captures('train_region').value - before:.0f})")
    expect_counts("cifar_graphed", launches, {
        "lrn_forward_cifar1": steps, "lrn_forward_cifar2": steps,
        "lrn_backward_cifar1": train, "lrn_backward_cifar2": train,
        "softmax_argmax_cifar": steps})
    expect_new_routes("cifar_graphed")
    if len(set(captures)) != 1 or captures[0] != 3:
        raise AssertionError(f"cifar_graphed: captures by epoch {captures}, "
                             f"want one a key (3: test, validation, train) "
                             f"and none after the first epoch")
    best = wf.decision.min_validation_n_err_pt
    if len(errors) != CIFAR_EPOCHS or not best < CIFAR_MAX_ERR_PT:
        raise AssertionError(f"cifar_graphed: best validation error {best} "
                             f"% (want < {CIFAR_MAX_ERR_PT} %)")

    # the trajectory against phase 7's eager run, from its snapshot
    snapshot, straight = eager["snapshot"], eager["straight"]
    worst = {}
    for name, chunk in (("graphed_steps", ()), ("graphed_chunks",
                                                ("--chunk", "16"))):
        resumed, _, _, firsts = cifar_cli(
            os.path.join(tmp, name), "-s", snapshot, *chunk, "--root",
            f"cifar.max_epochs={CIFAR_EPOCHS}")
        rel, other = state_diff(straight,
                                run_state(resumed.launcher.workflow))
        step_errs = [] if chunk else [
            max(state_diff(e, g)[0].values())
            for e, g in zip(eager["steps"], firsts)]
        other += [k for e, g in zip(eager["steps"] if not chunk else [],
                                    firsts) for k in state_diff(e, g)[1]]
        end = max(rel.values())
        say(f"    {name}: after the first and second train step "
            f"{[f'{v:.3g}' for v in step_errs] or 'not seen (chunks)'}, "
            f"at the end worst {end:.3g}, counters that differ: "
            f"{sorted(set(other))}")
        if any(v > CIFAR_STEP_TOL for v in step_errs) \
                or end > CIFAR_EPOCH_TOL or other \
                or (not chunk and len(step_errs) != 2):
            raise AssertionError(f"cifar_graphed: the {name} run leaves the "
                                 f"eager one")
        worst[name] = end

    # timing on the graphed run's workflow: its train steps eager and
    # graphed in turns, then 16 graphed steps a dispatch
    loader, region = wf.loader, wf.region
    ab = ab_steps(wf, "cifar_graphed", 1, 8, lambda n: train_ahead(wf, n))
    train_ahead(wf, 16)
    for _ in range(16):
        loader.run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    region.run_chunk(16)
    b.record()
    torch.cuda.synchronize()
    chunk_ms = a.elapsed_time(b) / 16
    say(f"  train step (B={CIFAR_BATCH}, f32) on {card}: "
        + ab_line(ab, CIFAR_BATCH, "img/s")
        + f"; 16 a dispatch {chunk_ms:.4f} ms "
        f"({CIFAR_BATCH / chunk_ms * 1e3:.0f} img/s); phase 7's eager run "
        f"{eager['step_ms']:.4f} ms (busy {pct(eager['busy'])})")
    EAGER["cifar_ab"] = dict(ab, chunk_ms=chunk_ms)

    path = os.path.join(tmp, "cifar.dot")
    if Main().run(["cifar", "--dump-graph", path]) != 0:
        raise AssertionError("cifar --dump-graph failed")
    with open(path) as f:
        dot = f.read()
    say(f"  cifar --dump-graph: {len(dot.splitlines())} lines of DOT, "
        f"train_region named: {'train_region' in dot}")
    if "train_region\\nRegionUnit" not in dot:
        raise AssertionError("the dumped graph names no region unit")
    return launches


def train_ahead(wf, n: int) -> None:
    """Step ``wf`` until its next n minibatches are train minibatches."""
    from znicz_tpu_torch.loader.base import TRAIN
    loader = wf.loader
    while sum(1 for cls, _, _ in loader._schedule[loader._cursor:]
              if cls == TRAIN) < n \
            or (loader._cursor < len(loader._schedule)
                and loader._schedule[loader._cursor][0] != TRAIN):
        wf.step()


def pct(share) -> str:
    return "not measured" if share is None else f"{100 * share:.1f} %"


def by_value(frozen: list):
    """The planted fault of phase 8: ``dropout_apply`` with its seed
    read on the host and passed by value, which a capture freezes."""
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk

    def dropout_apply(x, seed, ratio, block=None):
        if not torch.cuda.is_current_stream_capturing():
            frozen[:] = [int(seed)]
        return fk.dropout_apply(x, frozen[0], ratio, block)
    return dropout_apply


#: the trajectory of a graphed run against an eager one on the card, from
#: one seed: each state tensor (parameters, momentum, the evaluator's
#: sums) after GRAPH_STEPS steps, the first the capture's warm-up and the
#: others replays, as ‖graphed − eager‖ / ‖eager‖.  The two run the same
#: kernels in the same order and differ only where a kernel adds with
#: atomics (cuDNN's filter gradient), in the last f32 bits of a sum; a
#: bf16 store (activations, momentum) turns that at worst into one
#: rounding step of an element, so 2⁻⁸ of a tensor's norm bounds it.
#: The counters must be equal.  A planted fault, the head's update left
#: out of the capture, must fail the check.
GRAPH_STEPS, GRAPH_TOL_BF16 = 3, 2.0 ** -8


def frozen_update(wf, index: int = -1) -> None:
    """The planted fault: a unit's gradient step (by default the last
    unit's, the head's GD, the first of the backward) runs eagerly but
    is left out of the capture, so its parameters do not move on a
    replay and the GDs after it read the error the warm-up left."""
    import torch
    gd = wf.gds[index]
    device_run = gd.device_run

    def skipped_in_capture():
        if not torch.cuda.is_current_stream_capturing():
            device_run()
    gd.device_run = skipped_in_capture


def graphed_vs_eager(make, path: str, steps: int = GRAPH_STEPS,
                     tol: float = GRAPH_TOL_BF16, ready=None,
                     captures: int = 1, plant=frozen_update,
                     fault: str = "the head update left out of the "
                                  "capture") -> float:
    """``steps`` train steps of ``make()`` eager, then of a second
    ``make()`` graphed, then of a third graphed with ``plant`` (the
    fault ``fault``) planted; each graphed state held to the eager one
    (``tol``, counters equal).  ``ready(wf, n)`` first steps each run
    (in its mode) until its next n minibatches are train minibatches;
    a graphed run must have captured ``captures`` keys.  Returns the
    worst distance of the true graphed run."""
    import torch
    states = {}
    for mode in ("eager", "graphed", "planted"):
        set_graphs(mode != "eager")
        wf = make()
        if mode == "planted":
            plant(wf)
        if ready is not None:
            ready(wf, steps)
        for _ in range(steps):
            wf.step()
        torch.cuda.synchronize()
        if mode != "eager" and wf.region.captures != captures:
            raise AssertionError(f"{path}: {wf.region.captures} captures")
        states[mode] = run_state(wf)
        del wf
    set_graphs(True)
    worst = {}
    for mode, how in (("graphed", ""), ("planted", ", " + fault)):
        rel, other = state_diff(states["eager"], states[mode])
        name = max(rel, key=rel.get)
        worst[mode] = (rel[name], other)
        say(f"  {path}: {steps} steps graphed (a warm-up, then "
            f"replays{how}) against eager from one seed: worst "
            f"‖graphed − eager‖ / "
            f"‖eager‖ {rel[name]:.3g} ({name}; tol {tol:.3g}), "
            f"{sum(v == 0.0 for v in rel.values())} of {len(rel)} tensors "
            f"bit-equal, counters that differ: {sorted(other)}")
    if worst["graphed"][0] > tol or worst["graphed"][1]:
        raise AssertionError(f"{path}: the graphed run leaves the eager one")
    if worst["planted"][0] <= tol and not worst["planted"][1]:
        raise AssertionError(f"{path}: the trajectory check passes a "
                             f"planted fault ({fault})")
    say(f"  {path}: planted fault ({fault}) caught")
    return worst["graphed"][0]


def alexnet_graphed(card: str) -> dict:
    """AlexNet at B=128 with its region graphed: B1–B4 counts, the step
    beside phase 5's eager one; each step's dropout seed that of phase
    5's eager step, the masks of consecutive steps different, and each
    output zero wherever the step's mask drops; the same check must
    catch a planted fault (the seed passed by value, frozen in the
    capture)."""
    import torch
    from znicz_tpu_torch.ops import dropout as dropout_mod
    from znicz_tpu_torch.ops import fused_kernels as fk
    eager = EAGER["alexnet"]
    warmup, steps = 2, 10
    n = warmup + steps

    def masks_check(wf, k: int) -> tuple[bool, bool, list]:
        """``k`` steps: (seeds = eager's, every output consistent with
        its step's mask and masks differ step to step, the seeds)."""
        units = [u for u in wf.forwards
                 if type(u).__name__ == "DropoutForward"]
        seeds, consistent, prev = [], True, None
        for _ in range(k):
            wf.step()
            step = [int(u.seed) for u in units]
            seeds.append(step)
            masks = [fk.dropout_apply(torch.ones_like(u.output), u.seed,
                                      u.dropout_ratio) != 0 for u in units]
            for u, m in zip(units, masks):
                consistent &= not bool(((u.output != 0) & ~m).any())
            if prev is not None:
                consistent &= all(not torch.equal(a, b)
                                  for a, b in zip(prev, masks))
            prev = masks
        return seeds == eager["seeds"][:k], consistent, seeds

    wf = make_alexnet(ALEX_BATCH, n * ALEX_BATCH)
    reset_counts()
    timed_steps(wf, warmup, steps)
    launches = read_counts()
    expect_counts("alexnet_graphed", launches, {
        "lrn_forward": n, "lrn_forward_conv2": n, "lrn_backward": n,
        "lrn_backward_conv2": n, "dropout_apply": 4 * n,
        "softmax_argmax": n})
    expect_new_routes("alexnet_graphed")
    captures = wf.region.captures
    ab = ab_steps(wf, "alexnet_graphed", warmup, steps)
    say(f"  AlexNet B={ALEX_BATCH} bf16 on {card}: "
        + ab_line(ab, ALEX_BATCH, "img/s")
        + f"; {captures} capture(s); phase 5's eager run "
        f"{eager['step_ms']:.3f} ms (busy {pct(eager['busy'])})")
    EAGER["alexnet_ab"] = ab
    if captures != 1 or wf.region.captures != 1:
        raise AssertionError(f"alexnet_graphed: {wf.region.captures} "
                             f"captures")
    del wf
    EAGER["alexnet_ab"]["trajectory"] = graphed_vs_eager(
        lambda: make_alexnet(ALEX_BATCH, n * ALEX_BATCH), "alexnet_graphed")
    k = 4
    same, consistent, seeds = masks_check(
        make_alexnet(ALEX_BATCH, n * ALEX_BATCH), k)
    say(f"  dropout over {k} graphed steps (a warm-up, then replays): seeds "
        f"= phase 5's eager seeds {same}, outputs within their step's "
        f"masks and masks new each step {consistent}")
    if not (same and consistent):
        raise AssertionError("alexnet_graphed: the graphed dropout masks "
                             "are not the eager run's")
    frozen = []
    real = dropout_mod.dropout_apply
    dropout_mod.dropout_apply = by_value(frozen)
    try:
        _, consistent, _ = masks_check(
            make_alexnet(ALEX_BATCH, n * ALEX_BATCH), k)
    finally:
        dropout_mod.dropout_apply = real
    say(f"  planted fault (the seed passed by value, frozen in the "
        f"capture): {'caught' if not consistent else 'not caught'}")
    if consistent:
        raise AssertionError("alexnet_graphed: the mask check passes a "
                             "seed frozen in the capture")
    return launches


def seq_graphed(card: str) -> dict:
    """The bf16 sequence stack of phase 4 graphed: B5–B9 launch counts,
    the step beside phase 4's eager one."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(4 * BATCH, SEQ, DIM))
                         .astype(np.float32)).to(torch.bfloat16)
    y = rng.integers(0, CLASSES, size=4 * BATCH).astype(np.int32)
    wf = make_trainer(x, y, BATCH)
    reset_counts()
    warmup, steps = 2, 10
    timed_steps(wf, warmup, steps)
    launches = read_counts()
    n = warmup + steps
    expect_counts("seq_graphed", launches, {
        **{f"flash_attention_{k}": n for k in ("fwd", "dq", "dkv")},
        "layer_norm_forward": n, "layer_norm_backward": n,
        "softmax_argmax_small": n})
    expect_ln_register("seq_graphed")
    expect_new_routes("seq_graphed")
    ab = ab_steps(wf, "seq_graphed", warmup, steps)
    eager = EAGER["seq_bfloat16"]
    say(f"  sequence stack (B={BATCH}, T={SEQ}, D={DIM}, bf16) on {card}: "
        + ab_line(ab, BATCH * SEQ, "tokens/s")
        + f"; {wf.region.captures} capture(s); phase 4's eager run "
        f"{eager['step_ms']:.3f} ms (busy {pct(eager['busy'])})")
    EAGER["seq_ab"] = ab
    if wf.region.captures != 1:
        raise AssertionError(f"seq_graphed: {wf.region.captures} captures")
    del wf
    ab["trajectory"] = graphed_vs_eager(lambda: make_trainer(x, y, BATCH),
                                        "seq_graphed")
    return launches


# ----------------------------------------------------------------------
# phase 9: the MLP family
# ----------------------------------------------------------------------
#: epochs of MNIST and of the autoencoder through the command line
MLP_EPOCHS = 3
#: MNIST's synthetic stand-in (the idx files are not in the checkout):
#: 1000 test, 600 validation and 5400 train images, 100 a minibatch
MNIST_BATCH, MNIST_STEPS, MNIST_TRAIN_STEPS = 100, 70, 54
#: the best validation error MNIST's graphed run must reach (the
#: stand-in's digits are prototypes plus noise: the CPU reaches 0 % in
#: three epochs)
MNIST_MAX_ERR_PT = 5.0
#: Wine: 28 validation and 150 train samples, 10 a minibatch
WINE_STEPS, WINE_TRAIN_STEPS = 18, 15
WINE_SCHEDULE = {"lr_policy": ("exp", {"gamma": 0.9})}
#: train steps of Wine's graphed-against-eager check: enough for a rate
#: frozen at the capture's (iteration 0) to lag the schedule's by
#: 1 − 0.9⁹ = 61 % by the last
WINE_GRAPH_STEPS = 10
#: an MLP's graphed run against its eager run, in f32: the same kernels
#: in the same order, but cuBLAS may split a product's sum otherwise
#: under capture (another workspace), a few f32 ulps, which the
#: autoencoder's updates amplify about threefold a step
#: (tests/test_torch_mlp.py); over a few steps 1e-5 of a tensor's norm
#: bounds that, where a rate frozen in the capture or an update left out
#: of it moves a tensor by percents
MLP_GRAPH_TOL = 1e-5


def mlp_cli(*args: str):
    """``python -m znicz_tpu_torch <args>`` in this process, on the card,
    graphed: returns the workflow that ran, the validation error (%), the
    MSE by class or the SOM's quantization error and neurons used of
    each epoch, and the region's graph captures at each epoch's end."""
    from znicz_tpu_torch.__main__ import Main
    from znicz_tpu_torch.loader.base import VALID
    from znicz_tpu_torch.ops.decision import DecisionBase
    from znicz_tpu_torch.utils.config import reset_root
    reset_root()
    metric, captures = [], []
    decide = DecisionBase.decide

    def decide_and_record(decision):
        decide(decision)
        if decision.epoch_ended:
            err = getattr(decision, "epoch_n_err_pt", None)
            if err is not None:
                metric.append(round(err[VALID], 2))
            elif hasattr(decision, "epoch_mse"):
                metric.append([round(v, 4) for v in decision.epoch_mse])
            else:  # the SOM's quantization error and neurons used
                metric.append((round(decision.epoch_qe, 5),
                               decision.neurons_used))
            captures.append(decision.workflow.region.captures)

    DecisionBase.decide = decide_and_record
    try:
        main = Main()
        rc = main.run(list(args))
    finally:
        DecisionBase.decide = decide
    if rc:
        raise AssertionError(f"{args}: exit code {rc}")
    wf = main.launcher.workflow
    if wf.device.type != "cuda":
        raise AssertionError(f"the CLI chose {wf.device}")
    return wf, metric, captures


def make_mlp(module, device=None, **overrides):
    """A sample's workflow (``module.build(**overrides)``) from ``SEED``
    on ``device`` (None: the card), f32."""
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root
    reset_root()
    prng.seed_all(SEED)
    wf = module.build(**overrides)
    wf.initialize(device=device)
    return wf


def expect_captures(path: str, captures: list, keys: int) -> None:
    if set(captures) != {keys}:
        raise AssertionError(f"{path}: captures by epoch {captures}, want "
                             f"{keys} (one a key) from the first epoch on")


def mnist_pass(card: str) -> dict:
    """MNIST 784-100-10 through ``Main().run(["mnist", ...])`` graphed:
    B4 once a step at (100, 10) on its register route, one capture a
    key, the validation error by epoch; the train step graphed and eager
    in turns, the counted launches the kernels the profiler saw; the
    graphed trajectory against eager from one seed, with the head's
    update left out of the capture planted."""
    import torch
    from znicz_tpu_torch import datasets
    from znicz_tpu_torch.models.samples import mnist
    from znicz_tpu_torch.observe import metrics
    reset_counts()
    before = metrics.graph_captures("train_region").value
    t0 = time.perf_counter()
    wf, errors, captures = mlp_cli("mnist", "--root",
                                   f"mnist.max_epochs={MLP_EPOCHS}")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    steps = MLP_EPOCHS * MNIST_STEPS
    say(f"  python -m znicz_tpu_torch mnist --root mnist.max_epochs="
        f"{MLP_EPOCHS}: {MLP_EPOCHS} epochs in {host_s:.2f} s on the host "
        f"clock (build and initialize included), dataset "
        f"{tuple(wf.loader.class_lengths)} (test, validation, train), "
        + ("the idx files" if datasets.mnist_is_real() else
           "the synthetic stand-in")
        + f"; validation error by epoch, %: {errors}; "
        f"graph captures at each epoch's end {captures} (counter "
        f"{metrics.graph_captures('train_region').value - before:.0f})")
    expect_counts("mnist", launches, {"softmax_argmax_cifar": steps})
    expect_new_routes("mnist")
    expect_captures("mnist", captures, 3)
    best = wf.decision.min_validation_n_err_pt
    if len(errors) != MLP_EPOCHS or not best < MNIST_MAX_ERR_PT:
        raise AssertionError(f"mnist: best validation error {best} % (want "
                             f"< {MNIST_MAX_ERR_PT} %)")
    ab = ab_steps(wf, "mnist", 2, 20, lambda n: train_ahead(wf, n))
    say(f"  MNIST train step (B={MNIST_BATCH}, f32) on {card}: "
        + ab_line(ab, MNIST_BATCH, "img/s"))
    del wf
    ab["trajectory"] = graphed_vs_eager(
        lambda: make_mlp(mnist), "mnist", tol=MLP_GRAPH_TOL,
        ready=train_ahead, captures=3)
    EAGER["mnist_ab"] = ab
    return launches


def mnist784_pass(card: str) -> dict:
    """The MNIST-784 autoencoder (MSE) through ``Main().run(["mnist784",
    ...])`` graphed: no hand-written kernel, the MSE by epoch falling on
    the train and validation sets; the step graphed and eager in turns;
    the graphed trajectory against eager from one seed (with the planted
    head-update fault); one train step on the card against the CPU's per
    parameter (max-relative, phase 5's f32 bar)."""
    import torch
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    from znicz_tpu_torch.models.samples import mnist784
    reset_counts()
    t0 = time.perf_counter()
    wf, mses, captures = mlp_cli("mnist784", "--root",
                                 f"mnist784.max_epochs={MLP_EPOCHS}")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    history = wf.decision.epoch_mse_history
    say(f"  python -m znicz_tpu_torch mnist784 --root mnist784.max_epochs="
        f"{MLP_EPOCHS}: {MLP_EPOCHS} epochs in {host_s:.2f} s on the host "
        f"clock; MSE by epoch (test, validation, train): {mses}; graph "
        f"captures at each epoch's end {captures}")
    expect_counts("mnist784", launches, {})
    expect_captures("mnist784", captures, 3)
    for cls in (VALID, TRAIN):
        h = history[cls]
        if len(h) != MLP_EPOCHS or not h[-1] < h[0]:
            raise AssertionError(f"mnist784: the MSE does not fall: {h}")
    ab = ab_steps(wf, "mnist784", 2, 20, lambda n: train_ahead(wf, n),
                  no_kernels=True)
    say(f"  MNIST-784 autoencoder train step (B={MNIST_BATCH}, f32) on "
        f"{card}: " + ab_line(ab, MNIST_BATCH, "img/s"))
    del wf
    ab["trajectory"] = graphed_vs_eager(
        lambda: make_mlp(mnist784), "mnist784", tol=MLP_GRAPH_TOL,
        ready=train_ahead, captures=3)

    def ready_to_train(device):
        wf = make_mlp(mnist784, device)
        train_ahead(wf, 1)
        return wf

    check_step_on_cpu(ready_to_train, f"mnist784, B={MNIST_BATCH}, f32",
                      TRAIN_STEP_TOL)
    EAGER["mnist784_ab"] = ab
    return launches


def frozen_rates(wf) -> None:
    """A planted fault of phase 9: each scheduled unit's rates read on
    the host and passed as floats, which a capture freezes."""
    import torch
    for gd in wf.gds:
        if gd.lr_state is None:
            continue
        held = {}

        def rate(slot, gd=gd, held=held):
            if not torch.cuda.is_current_stream_capturing():
                held[slot] = float(gd.lr_state[slot])
            return held[slot]
        gd._lr = lambda rate=rate: rate(0)
        gd._lr_bias = lambda rate=rate: rate(1)


def rebinding_write(gd, lr: float, lr_bias: float) -> None:
    """A planted fault of phase 9: an adjuster that binds a new
    ``lr_state`` instead of writing the captured one in place."""
    import torch
    gd.lr_state = torch.tensor([lr, lr_bias], dtype=torch.float32,
                               device=gd.lr_state.device)


def wine_pass(card: str) -> dict:
    """Wine with an exponential schedule on both layers and the
    confusion counts, graphed: the rate read back after every step
    equals the policy's for the iteration, the train key captured once
    while the rate changes every step, the counts consistent with the
    error counts; the graphed trajectory against eager from one seed, with a
    rate frozen in the capture planted; a ``FixedPolicy`` run bit-equal
    to a run with no schedule; ``--chunk 8`` writes the rate once a
    chunk; an adjuster that rebinds ``lr_state`` raises at the next
    replay; the step with and without the schedule in turns."""
    import numpy as np
    import torch
    from znicz_tpu_torch import datasets
    from znicz_tpu_torch.models.samples import wine
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.ops.lr_adjust import make_policy
    from znicz_tpu_torch.ops.nn_units import GradientDescentBase
    say("  Wine data: " + ("the UCI set scikit-learn bundles"
                           if datasets.wine_is_real() else
                           "the synthetic stand-in (no scikit-learn on "
                           "this machine)"))
    policy = make_policy(WINE_SCHEDULE["lr_policy"])
    n = 2 * WINE_STEPS
    confusion = {"compute_confusion": True}
    wf = make_mlp(wine, lr_adjuster_config=WINE_SCHEDULE, max_epochs=100,
                  evaluator_config=confusion)
    reset_counts()
    before = metrics.graph_captures("train_region").value
    wrong, captures = [], []
    for _ in range(n):
        wf.step()
        itr = wf.lr_adjuster._n_iterations
        for gd in wf.gds:
            want = np.float32([policy(gd.learning_rate, itr),
                               policy(gd.learning_rate_bias, itr)])
            got = gd.lr_state.cpu().numpy()
            if not np.array_equal(got, want):
                wrong.append((itr, gd.name, got.tolist(), want.tolist()))
        captures.append(wf.region.captures)
    torch.cuda.synchronize()
    launches = read_counts()
    counter = metrics.graph_captures("train_region").value - before
    # the confusion counts, added on the device in the captured steps
    cm = wf.decision.confusion_matrixes
    errors = wf.decision.last_epoch_n_err
    counted = [int(m.sum()) for m in cm[1:]]
    off_diagonal = [int(m.sum() - np.trace(m)) for m in cm[1:]]
    say(f"  Wine confusion counts of the last epoch (validation, train): "
        f"{counted} samples, {off_diagonal} off the diagonal, the error "
        f"counts {errors[1:]}")
    # (28 and 150 on the UCI set; the stand-in's 177 samples leave 27)
    if counted != wf.loader.class_lengths[1:] or off_diagonal != errors[1:]:
        raise AssertionError(f"wine: confusion counts {cm}")
    say(f"  Wine, lr_policy exp(0.9) on both layers, {n} graphed steps: "
        f"{wf.lr_adjuster._n_iterations} iterations, the rate read back "
        f"after each step equal to the policy's: {not wrong}; captures "
        f"after each step {sorted(set(captures))} (counter {counter:.0f}, "
        f"flat from step {captures.index(max(captures)) + 1} on while the "
        f"rate changed every train step); validation error "
        f"{wf.decision.epoch_n_err_pt[1]:.2f} %")
    expect_counts("wine", launches, {"softmax_argmax_wine": n})
    expect_new_routes("wine")
    if wrong or counter != 2 or captures[-1] != 2 \
            or wf.lr_adjuster._n_iterations != 2 * WINE_TRAIN_STEPS:
        raise AssertionError(f"wine: rates {wrong[:3]}, captures "
                             f"{captures}, counter {counter}")

    # the step with and without the schedule, in turns
    plain = make_mlp(wine, max_epochs=100)
    # an epoch has 15 train steps: 2 + 10 fit in its train segment
    ab = ab_steps(wf, "wine", 2, 10, lambda k: train_ahead(wf, k))
    times = {"schedule": [], "none": []}
    for mode in ("none", "schedule", "schedule", "none"):
        run = wf if mode == "schedule" else plain
        train_ahead(run, 12)
        times[mode].append(timed_steps(run, 2, 10))
    say(f"  Wine train step (B={WINE_BATCH}, f32) on {card}: "
        + ab_line(ab, WINE_BATCH, "samples/s")
        + "; graphed with the schedule "
        + " / ".join(f"{v:.4f}" for v in times["schedule"])
        + " ms, without " + " / ".join(f"{v:.4f}" for v in times["none"])
        + " ms")
    ab["schedule_vs_none"] = times
    del wf, plain

    ab["trajectory"] = graphed_vs_eager(
        lambda: make_mlp(wine, lr_adjuster_config=WINE_SCHEDULE,
                         max_epochs=100, evaluator_config=confusion),
        "wine_scheduled", steps=WINE_GRAPH_STEPS, tol=MLP_GRAPH_TOL,
        ready=train_ahead, captures=2, plant=frozen_rates,
        fault="the rates passed as floats, frozen in the capture")

    # FixedPolicy against no schedule, both graphed: the same bits
    states = []
    for config in ({"lr_policy": ("fixed", {})}, None):
        run = make_mlp(wine, lr_adjuster_config=config, max_epochs=100)
        for _ in range(n):
            run.step()
        states.append({k: v for k, v in run_state(run).items()
                       if "lr_state" not in k and "lr_adjuster" not in k})
    rel, other = state_diff(*states)
    same = all(v == 0.0 for v in rel.values()) and not other
    say(f"  Wine, FixedPolicy against no schedule, {n} graphed steps: "
        f"{sum(v == 0.0 for v in rel.values())} of {len(rel)} tensors "
        f"bit-equal, counters that differ: {other}")
    if not same:
        raise AssertionError("wine: a FixedPolicy run leaves the run with "
                             "no schedule")

    # --chunk 8: the rate written once a chunk
    writes = []
    real = GradientDescentBase.write_lr_state

    def record(gd, lr, lr_bias):
        if gd is gd.workflow.gds[0]:
            writes.append((gd.workflow.lr_adjuster._n_iterations, lr))
        real(gd, lr, lr_bias)

    GradientDescentBase.write_lr_state = record
    try:
        chunked, _, chunk_captures = mlp_cli(
            "wine", "--chunk", "8", "--root", "wine.max_epochs=2",
            "--root", f"wine.lr_adjuster_config={WINE_SCHEDULE!r}")
    finally:
        GradientDescentBase.write_lr_state = real
    want = [(i, policy(0.3, i)) for i in (0, 8, 15, 23, 30)]
    say(f"  wine --chunk 8 with the schedule: the rate written at "
        f"iterations {[i for i, _ in writes]} (want {[i for i, _ in want]}: "
        f"once at initialize, then once a train chunk of 8, 7, 8, 7 "
        f"steps), values the policy's: {writes == want}; captures by "
        f"epoch {chunk_captures}")
    if writes != want or chunked.lr_adjuster._n_iterations != 30:
        raise AssertionError(f"wine --chunk 8: rate writes {writes}")

    # an adjuster that rebinds lr_state: the next replay must refuse
    GradientDescentBase.write_lr_state = rebinding_write
    caught = ""
    try:
        run = make_mlp(wine, lr_adjuster_config=WINE_SCHEDULE,
                       max_epochs=100)
        train_ahead(run, 2)
        run.step()  # the train key's capture, then the rebinding write
        run.step()
    except RuntimeError as exc:
        caught = str(exc)
    finally:
        GradientDescentBase.write_lr_state = real
    say(f"  planted fault (an adjuster that rebinds lr_state): "
        f"{'caught: ' + caught[:120] if caught else 'not caught'}")
    if "lr_state was rebound" not in caught:
        raise AssertionError("wine: a rebound lr_state was not refused")
    EAGER["wine_ab"] = ab
    return launches


# ----------------------------------------------------------------------
# phase 10: the token LM and the LSTM chain
# ----------------------------------------------------------------------
#: the byte LM: ``benchmarks/serve_bench.py``'s ``train_and_export_lm``
#: chain at the sequence stack's widths, a layer_norm before the head;
#: its train and validation sequences, and its updates
LM_TRAIN, LM_VALID = 4 * BATCH, 2 * BATCH
LM_GD = {"learning_rate": 0.01, "gradient_moment": 0.9}
LM_LAYERS = (
    {"type": "embedding", "->": {"vocab_size": LM_VOCAB, "dim": DIM},
     "<-": LM_GD},
    {"type": "pos_encoding", "->": {}},
    {"type": "attention", "->": {"n_heads": HEADS, "causal": True},
     "<-": LM_GD},
    {"type": "layer_norm", "->": {}, "<-": LM_GD},
    {"type": "last_token", "->": {}},
    {"type": "softmax", "->": {"output_sample_shape": LM_VOCAB},
     "<-": LM_GD})
#: the sequence block the reference's ``_sequence_meta`` gives for
#: LM_LAYERS at T = SEQ (``znicz_tpu/export.py:74-113``), written out
LM_SEQUENCE = {"train_t": SEQ, "vocab": LM_VOCAB, "dim": DIM,
               "cache": [{"layer": 2, "kind": "attention", "heads": HEADS,
                          "head_dim": DIM // HEADS, "features": DIM}]}
#: microbatches of an accumulated optimizer step, and the steps held
#: against fused 64-row minibatches
LM_MICRO, LM_ACCUM_STEPS = 4, 3
#: accumulated against fused, each parameter's ‖accum − fused‖ over its
#: ‖update‖ after LM_ACCUM_STEPS steps.  Each sample's forward and
#: backward are the same on both sides (the evaluator's 1/16 and 1/64
#: scale the errors by powers of two, which bf16 stores exactly); only
#: the sums over the batch (the weight gradients, the embedding's
#: scatter, B6's column sums) add in other orders.  That moves the
#: parameters by f32 ulps, which can flip a bf16 rounding of a later
#: step's activations or errors: at most 2⁻⁸ of the terms it feeds, in
#: each step after the first.
LM_ACCUM_TOL = LM_ACCUM_STEPS * 2.0 ** -8
#: the LSTM chain's sequence length: its recurrence is serial, an eager
#: train step ~14,000 launches at T = 256 (~10⁵ at 2048); widths full
LSTM_SEQ = 256
LSTM_LAYERS = (
    {"type": "embedding", "->": {"vocab_size": LM_VOCAB, "dim": DIM},
     "<-": LM_GD},
    {"type": "lstm", "->": {"units": DIM}, "<-": LM_GD},
    {"type": "softmax", "->": {"output_sample_shape": LM_VOCAB},
     "<-": LM_GD})
#: conv → to_sequence → attention → softmax, small, bf16: the attention
#: one head of 32 (the flash kernels' dh-32 instantiation)
SEQ_CONV_LAYERS = (
    {"type": "conv", "->": {"n_kernels": 32, "kx": 3, "ky": 3,
                            "padding": 1}, "<-": LM_GD},
    {"type": "to_sequence", "->": {}},
    {"type": "attention", "->": {"n_heads": 1}, "<-": LM_GD},
    {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": LM_GD})


def lm_data(n: int, t: int, seed: int):
    """The reference's synthetic next-token task: ``x_{t+1} = (x_t + 1)
    mod V`` from a random start, the label ``(x_0 + T) mod V``; ids as
    f32, as the loader's float minibatch path carries them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    start = rng.integers(0, LM_VOCAB, size=n)
    x = ((start[:, None] + np.arange(t)[None, :]) % LM_VOCAB)
    return x.astype(np.float32), ((start + t) % LM_VOCAB).astype(np.int32)


def make_lm(x, y, n_train: int, batch: int, device=None, layers=LM_LAYERS,
            grad_accum: int = 1, max_epochs: int = 10 ** 6,
            precision: str = "bfloat16"):
    """A token chain (``layers``) through the port's ``StandardWorkflow``
    from ``SEED``: the first ``n_train`` samples for training, the rest
    (if any) for validation; ``grad_accum`` microbatch buffers."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.precision_type = precision
    root.common.engine.grad_accum = grad_accum
    prng.seed_all(SEED)
    valid = ({"valid_data": x[n_train:], "valid_labels": y[n_train:]}
             if len(x) > n_train else {})
    wf = StandardWorkflow(
        name="chip_smoke_lm",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x[:n_train], train_labels=y[:n_train],
            minibatch_size=batch, **valid),
        layers=[dict(spec) for spec in layers],
        decision_config={"max_epochs": max_epochs})
    wf.initialize(device=device)
    return wf


def lm_train_flops(b: int) -> float:
    """Model FLOPs of one LM train step: the four D×D projections, the
    score and value products over the visible (causal) pairs and the
    head at the last position, times three for forward and backward
    (the embedding's gather and scatter, the encoding and the norms are
    not counted)."""
    proj = 4 * 2.0 * b * SEQ * DIM * DIM
    pairs = SEQ * (SEQ + 1) / 2
    scores = 2 * 2.0 * b * HEADS * pairs * (DIM // HEADS)
    head = 2.0 * b * DIM * LM_VOCAB
    return 3.0 * (proj + scores + head)


def lstm_train_flops(b: int) -> float:
    """Model FLOPs of one LSTM-chain train step: each step's
    (F+H)×4H product and the head, times three (the backward's
    recomputed forward not counted)."""
    return 3.0 * (2.0 * b * LSTM_SEQ * (2 * DIM) * 4 * DIM
                  + 2.0 * b * DIM * LM_VOCAB)


def lm_counts(n_train: int, n_eval: int = 0) -> dict:
    """The kernels of the byte LM: each once a train step, the forward's
    once an evaluation step."""
    fwd = n_train + n_eval
    return {"flash_attention_fwd_causal": fwd,
            "flash_attention_dq_causal": n_train,
            "flash_attention_dkv_causal": n_train,
            "layer_norm_forward": fwd, "layer_norm_backward": n_train,
            "softmax_argmax_lm": fwd}


def add_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def embedding_rerun(tokens, path: str) -> None:
    """The embedding's table gradient at the path's (B, T) ids, D wide:
    the same bits on four reruns (the scatter-add is deterministic),
    beside the CPU's (``index_add_``, in order) and its time."""
    import torch
    from znicz_tpu_torch.ops.embedding import Embedding
    from znicz_tpu_torch.ops.nn_units import gd_for
    b, t = tokens.shape
    fwd = Embedding((t,), torch.bfloat16, vocab_size=LM_VOCAB, dim=DIM)
    fwd.init_params("cuda")
    grads = []
    gd = gd_for(Embedding)(fwd, learning_rate=1.0)
    gd.apply_weights = grads.append
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    err = torch.randn(b, t, DIM, generator=gen, device="cuda").bfloat16()
    x = tokens.cuda()
    for _ in range(5):
        gd.run(x, err, None)
    torch.cuda.synchronize()
    same = all(torch.equal(g, grads[0]) for g in grads[1:])
    cpu = torch.zeros(LM_VOCAB, DIM).index_add_(
        0, x.cpu().long().reshape(-1), err.float().cpu().reshape(-1, DIM))
    diff = float((grads[0].cpu() - cpu).abs().max())
    ms = time_ms(lambda: gd.run(x, err, None), 10)
    say(f"  {path}: the embedding's gradient ({b}·{t} rows onto "
        f"{LM_VOCAB}, D={DIM}) the same bits on 4 reruns {same}; against "
        f"the CPU's in-order sum: max_abs_err {diff:.3g} (bit-equal "
        f"{diff == 0.0}); the backward {ms:.4f} ms")
    if not same:
        raise AssertionError(f"{path}: the embedding's gradient changes "
                             f"from run to run")


def lm_pass(card: str) -> tuple[dict, dict]:
    """The byte LM at B=16, T=2048, bf16 with its region eager, then
    graphed: 2 + 10 train steps each, every kernel of the chain once a
    step (the graphed run's counts through the replay accounting);
    step time, tokens/s, MFU, the units' device times, busy share, top
    kernels and peak memory; graphed and eager in turns; 3 graphed steps
    against 3 eager from one seed (with the embedding's update left out
    of the capture planted); one step at B=2 against the CPU's; the
    embedding's gradient the same on a rerun."""
    import torch
    x, y = lm_data(LM_TRAIN, SEQ, SEED + 10)
    warmup, steps = 2, 10
    n = warmup + steps
    flops = lm_train_flops(BATCH)
    counts = {}
    for mode in ("eager", "graphed"):
        set_graphs(mode == "graphed")
        path = "lm" if mode == "eager" else "lm_graphed"
        torch.cuda.reset_peak_memory_stats()
        wf = make_lm(x, y, LM_TRAIN, BATCH)
        reset_counts()
        step_ms = timed_steps(wf, warmup, steps)
        counts[mode] = read_counts()
        expect_counts(path, counts[mode], lm_counts(n))
        expect_ln_register(path)
        expect_new_routes(path)
        say(f"  byte LM {mode} (V={LM_VOCAB}, D={DIM}, {HEADS} causal "
            f"heads, T={SEQ}, B={BATCH}, bf16) on {card}: {warmup} + "
            f"{steps} train steps, step {step_ms:.3f} ms, "
            f"{BATCH * SEQ / step_ms * 1e3:.0f} tokens/s, MFU "
            f"{flops / (step_ms * 1e-3) / PEAK_BF16_FLOP_S:.4f} "
            f"({flops:.4g} FLOP a step, the causal pairs only), peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
            f" GiB, {wf.region.captures} capture(s)")
        if mode == "eager":
            step_breakdown(wf)
            EAGER["lm"] = {"step_ms": step_ms,
                           "busy": device_busy(wf, window=path)}
        else:
            if wf.region.captures != 1:
                raise AssertionError(f"{path}: {wf.region.captures} "
                                     f"captures")
            ab = ab_steps(wf, path, warmup, steps)
            say("  byte LM in turns: " + ab_line(ab, BATCH * SEQ,
                                                   "tokens/s"))
            EAGER["lm_ab"] = ab
        del wf
    EAGER["lm_ab"]["trajectory"] = graphed_vs_eager(
        lambda: make_lm(x, y, LM_TRAIN, BATCH), "lm_graphed",
        plant=lambda wf: frozen_update(wf, 0),
        fault="the embedding's update left out of the capture")
    check_step_on_cpu(lambda device: make_lm(x[:2], y[:2], 2, 2, device),
                      "the byte LM, B=2, bf16", TRAIN_STEP_TOL)
    embedding_rerun(torch.from_numpy(x[:BATCH]), "lm")
    return counts["eager"], counts["graphed"]


def lm_params(wf) -> dict:
    return {f"{u.name}.{name}": p.detach().float().cpu().clone()
            for u in wf.forwards for name, p in u.named_parameters()}


@contextlib.contextmanager
def accum_fault(kind: str | None):
    """A context in which the backward units see a wrong accumulation
    phase (the phase they read when a step runs eagerly or is captured):
    ``"no division"`` — the apply phase as ``("apply", 1)``, so the sum
    is not divided by M; ``"accumulate writes"`` — no phase in the
    accumulate microbatches, so each writes its parameters."""
    from znicz_tpu_torch.ops import nn_units
    real = nn_units.current_accum_phase

    def wrong():
        phase = real()
        if phase is None or kind is None:
            return phase
        if kind == "no division" and phase[0] == "apply":
            return ("apply", 1)
        if kind == "accumulate writes" and phase[0] == "accum":
            return None
        return phase

    nn_units.current_accum_phase = wrong
    try:
        yield
    finally:
        nn_units.current_accum_phase = real


def lm_accum_pass(card: str) -> dict:
    """``run_accumulated(4)`` of the byte LM at 16 rows a microbatch for
    one epoch (two validation minibatches, run unaccumulated, then
    LM_ACCUM_STEPS optimizer steps), graphed: three captures (validation,
    accumulate, apply), flat after the first optimizer step; B7–B9
    4 times an optimizer step; the parameters against a fused run of
    64-row minibatches within LM_ACCUM_TOL, graphed against eager
    within 2⁻⁸ (counters equal), and two planted faults caught; the
    optimizer step's time beside the fused step's."""
    import torch
    from znicz_tpu_torch.loader.base import TRAIN
    n_train = LM_ACCUM_STEPS * LM_MICRO * BATCH
    x, y = lm_data(n_train + LM_VALID, SEQ, SEED + 11)
    n_valid = LM_VALID // BATCH

    def accumulated(graphed: bool, fault: str | None = None):
        set_graphs(graphed)
        wf = make_lm(x, y, n_train, BATCH, grad_accum=LM_MICRO,
                     max_epochs=1)
        captures, marks = [], []

        def hook():
            captures.append(wf.region.captures)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((wf.loader.minibatch_class, ev))

        wf.add_step_hook(hook)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks.append((None, start))
        with accum_fault(fault):
            wf.run_accumulated(LM_MICRO)
        torch.cuda.synchronize()
        times = [(cls, a.elapsed_time(b)) for (_, a), (cls, b)
                 in zip(marks, marks[1:])]
        return wf, captures, times

    # the fused reference: 64-row minibatches, the same samples a step
    set_graphs(True)
    torch.cuda.reset_peak_memory_stats()
    fused = make_lm(x, y, n_train, LM_MICRO * BATCH, max_epochs=1)
    init = lm_params(fused)
    fused.run()
    fused_mem = torch.cuda.max_memory_allocated()
    want = lm_params(fused)
    del fused
    fused = make_lm(x[:n_train], y[:n_train], n_train, LM_MICRO * BATCH)
    fused_ms = timed_steps(fused, 2, 6)
    del fused

    def against_fused(wf) -> tuple[float, str]:
        got = lm_params(wf)
        rel = {k: float((got[k] - want[k]).norm()
                        / (want[k] - init[k]).norm()) for k in want}
        name = max(rel, key=rel.get)
        return rel[name], name

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wf, captures, times = accumulated(True)
    launches = read_counts()
    accum_mem = torch.cuda.max_memory_allocated()
    expect_counts("lm_accum", launches, lm_counts(
        LM_ACCUM_STEPS * LM_MICRO, n_valid))
    expect_ln_register("lm_accum")
    expect_new_routes("lm_accum")
    opt_ms = [ms for cls, ms in times if cls == TRAIN]
    worst, name = against_fused(wf)
    graphed_state = run_state(wf)
    say(f"  run_accumulated({LM_MICRO}) graphed on {card}: {n_valid} "
        f"validation steps and {LM_ACCUM_STEPS} optimizer steps of "
        f"{LM_MICRO} × {BATCH} rows; captures after each step {captures} "
        f"(validation, accumulate, apply); B7–B9 "
        f"{launches['flash_attention_dq_causal'] / LM_ACCUM_STEPS:.0f} "
        f"times an optimizer step; optimizer step "
        f"{' / '.join(f'{v:.3f}' for v in opt_ms)} ms (the first with "
        f"both captures), {opt_ms[-1] / LM_MICRO:.3f} ms a microbatch, "
        f"beside a fused 64-row step of {fused_ms:.3f} ms "
        f"({fused_ms / LM_MICRO:.3f} ms per 16 rows); peak device memory "
        f"{accum_mem / 2 ** 30:.2f} GiB accumulated, "
        f"{fused_mem / 2 ** 30:.2f} GiB fused")
    say(f"  accumulated against fused: worst ‖accum − fused‖ / ‖update‖ "
        f"{worst:.3g} ({name}; tol {LM_ACCUM_TOL:.4g} = "
        f"{LM_ACCUM_STEPS} steps × 2⁻⁸)")
    if captures != [1] * n_valid + [3] * LM_ACCUM_STEPS:
        raise AssertionError(f"lm_accum: captures {captures}")
    if worst > LM_ACCUM_TOL:
        raise AssertionError("lm_accum: the accumulated run leaves the "
                             "fused one")
    del wf
    eager, _, _ = accumulated(False)
    rel, other = state_diff(run_state(eager), graphed_state)
    key = max(rel, key=rel.get)
    say(f"  run_accumulated graphed against eager from one seed: worst "
        f"‖graphed − eager‖ / ‖eager‖ {rel[key]:.3g} ({key}; tol "
        f"{GRAPH_TOL_BF16:.3g}), {sum(v == 0.0 for v in rel.values())} of "
        f"{len(rel)} tensors bit-equal, counters that differ: "
        f"{sorted(other)}")
    if rel[key] > GRAPH_TOL_BF16 or other:
        raise AssertionError("lm_accum: the graphed accumulation leaves "
                             "the eager one")
    del eager
    for fault in ("no division", "accumulate writes"):
        wf, _, _ = accumulated(True, fault)
        worst, name = against_fused(wf)
        say(f"  planted fault ({fault}): worst ‖accum − fused‖ / "
            f"‖update‖ {worst:.3g} ({name}): "
            f"{'caught' if worst > LM_ACCUM_TOL else 'not caught'}")
        if worst <= LM_ACCUM_TOL:
            raise AssertionError(f"lm_accum: the check passes a planted "
                                 f"fault ({fault})")
        del wf
    set_graphs(True)
    return launches


def lm_serve_pass(card: str) -> dict:
    """The byte LM trained 4 graphed steps, exported (``kind`` "lm", the
    reference's ``sequence`` block) and served through
    ``ServingEngine(max_batch=16)``, each bucket a CUDA graph: ragged
    requests of 1, 3 and 16 rows of 2048 ids, B7 (causal), B5 and B4
    once a dispatch, the 1-row reply against
    ``ExportedModel.load(path, device="cpu")``, p50 and rows/s eager and
    graphed in turns."""
    import numpy as np
    from znicz_tpu_torch.export import ExportedModel, read_bundle
    from znicz_tpu_torch.ops import flash_attention as fa
    from znicz_tpu_torch.ops import fused_kernels as fk
    from znicz_tpu_torch.serving import ServingEngine
    x, y = lm_data(LM_TRAIN + BATCH, SEQ, SEED + 12)
    wf = make_lm(x[:LM_TRAIN], y[:LM_TRAIN], LM_TRAIN, BATCH)
    for _ in range(4):
        wf.step()
    kernels = (fa.flash_attention_fwd, fk.layer_norm_forward,
               fk.softmax_argmax)
    with tempfile.TemporaryDirectory() as tmp:
        path = wf.export_forward(os.path.join(tmp, "lm.npz"))
        del wf
        manifest, _ = read_bundle(path)
        say(f"  export_forward: kind {manifest['kind']!r}, sequence "
            f"{manifest.get('sequence')}")
        if manifest["kind"] != "lm" or manifest.get("sequence") \
                != LM_SEQUENCE:
            raise AssertionError("the LM's bundle is not the reference's "
                                 "lm bundle")
        requests = x[LM_TRAIN:]
        reset_counts()
        eng = ServingEngine(path, max_batch=BATCH, max_delay_ms=2.0)
        try:
            eng.start()
            expect_ladder_captures(eng, "lm_serve")
            replies = graphed_dispatches(eng, requests, kernels,
                                         f"lm_serve ({SEQ} ids a row)")
            for n, reply in replies.items():
                if reply.shape != (n, LM_VOCAB) \
                        or np.abs(reply.sum(axis=1) - 1.0).max() > 1e-4:
                    raise AssertionError(f"lm_serve: bad {n}-row reply")
            serve_ab(eng, requests, "the byte LM", card)
            expect_ladder_captures(eng, "lm_serve")
            launches = read_counts()
            expect_ln_register("lm_serve")
            expect_new_routes("lm_serve")
            if launches["flash_attention_fwd_causal"] \
                    != fa.flash_attention_fwd.launches:
                raise AssertionError("lm_serve: a flash forward that is "
                                     "not causal")
        finally:
            eng.shutdown()
        cpu = ExportedModel.load(path, device="cpu")
        want = cpu(requests[:1])
    err = float(np.abs(want - replies[1]).max())
    say(f"  1-row reply vs ExportedModel(device='cpu'): max_abs_err "
        f"{err:.3g} (tol {SLICE_TOL}), kind {cpu.kind!r}")
    if err > SLICE_TOL or cpu.kind != "lm":
        raise AssertionError("lm_serve: the card's reply disagrees with "
                             "the CPU's")
    return launches


def lstm_pass(card: str) -> dict:
    """embedding (256, 512) → lstm (512) → softmax (256), B=16, T=256,
    bf16: 1 + 3 train steps eager, then 1 + 5 graphed, B4 once a step;
    3 graphed steps against 3 eager (with the head's update left out of
    the capture planted); one step at B=2 against the CPU's; the
    embedding's gradient the same on a rerun."""
    import torch
    x, y = lm_data(LM_TRAIN, LSTM_SEQ, SEED + 13)
    flops = lstm_train_flops(BATCH)
    counts = []
    for mode, warmup, steps in (("eager", 1, 3), ("graphed", 1, 5)):
        set_graphs(mode == "graphed")
        torch.cuda.reset_peak_memory_stats()
        wf = make_lm(x, y, LM_TRAIN, BATCH, layers=LSTM_LAYERS)
        reset_counts()
        t0 = time.perf_counter()
        step_ms = timed_steps(wf, warmup, steps)
        host_s = time.perf_counter() - t0
        counts.append(read_counts())
        expect_counts(f"lstm {mode}", counts[-1],
                      {"softmax_argmax_lm": warmup + steps})
        expect_new_routes("lstm")
        say(f"  LSTM chain {mode} (V={LM_VOCAB}, D=H={DIM}, T={LSTM_SEQ}, "
            f"B={BATCH}, bf16) on {card}: {warmup} + {steps} train steps "
            f"in {host_s:.2f} s on the host clock, step {step_ms:.3f} ms, "
            f"{BATCH * LSTM_SEQ / step_ms * 1e3:.0f} tokens/s, MFU "
            f"{flops / (step_ms * 1e-3) / PEAK_BF16_FLOP_S:.5f} "
            f"({flops:.4g} FLOP a step), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"{wf.region.captures} capture(s)")
        if mode == "graphed":
            if wf.region.captures != 1:
                raise AssertionError(f"lstm: {wf.region.captures} captures")
            busy = device_busy(wf, window="lstm graphed")
            say(f"  LSTM chain graphed: busy {pct(busy)} in the profiler's "
                f"window")
        del wf
    graphed_vs_eager(lambda: make_lm(x, y, LM_TRAIN, BATCH,
                                     layers=LSTM_LAYERS), "lstm")
    check_step_on_cpu(lambda device: make_lm(
        x[:2], y[:2], 2, 2, device, layers=LSTM_LAYERS),
        "the LSTM chain, B=2, bf16", TRAIN_STEP_TOL)
    embedding_rerun(torch.from_numpy(x[:BATCH]), "lstm")
    return add_counts(*counts)


def to_sequence_pass() -> dict:
    """One train step of conv → to_sequence → attention → softmax (8×8×3
    images, 32 kernels, one head of 32, 10 classes, bf16) on the card
    against the CPU's."""
    import numpy as np
    rng = np.random.default_rng(SEED + 14)
    x = rng.normal(0.0, 1.0, size=(8, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=8).astype(np.int32)
    reset_counts()

    def make(device):
        if device == "cpu":
            launches.update(read_counts())  # the card's step is done
        return make_lm(x, y, 8, 8, device, layers=SEQ_CONV_LAYERS)

    launches = {}
    check_step_on_cpu(make, "conv → to_sequence → attention → softmax, "
                      "bf16", TRAIN_STEP_TOL)
    expect_counts("to_sequence", launches, {
        **{f"flash_attention_{k}_dh32": 1 for k in ("fwd", "dq", "dkv")},
        "softmax_argmax_cifar": 1})
    return launches


# ----------------------------------------------------------------------
# phase 11: the numpy oracle, engine.debug_checks and engine.fp8_matmul
# ----------------------------------------------------------------------
#: the numpy oracle against the card, Wine in f32 after 3 train steps:
#: each parameter's max|card − oracle| over its max|value|.  Both compute
#: in f32 (TF32 off on the card) and round at the same points; numpy's
#: BLAS and cuBLAS sum the products in other orders, a few ulps of each
#: term (the CPU tests measure ~1e-7 against the CPU device)
ORACLE_TOL = 1e-5
#: timed steps of each phase-11 workflow, after 2 of warm-up
CHECK_STEPS = 5
#: ``fp8.fp8_dot`` on the card against its plain version (the same e4m3
#: operands multiplied in f32, TF32 off), each element's |difference|
#: over Σ|a₈||b₈| of its dot product: every e4m3 product is exact, so
#: only the accumulation differs.  Hopper's fp8 tensor cores add inside
#: an MMA with about 14 bits of mantissa before cuBLAS promotes the
#: partial sums to f32 (``use_fast_accum=False``): ~2⁻¹⁴ of the terms
#: for each of the ≤ 16 additions of a block, 2⁻¹⁰ at most
FP8_TOL = 2.0 ** -10
#: the product shapes the lever's paths give ``mxu_dot`` (M, K, N): MNIST
#: 784-100-10 at B = 100 (both forwards, the explicit GD products δ·Wᵀ
#: and xᵀ·δ of both layers), the byte LM at B = 16, T = 2048 (the QKV
#: and output projections, the head, the head's GD products)
FP8_SHAPES = {"mnist": ((100, 784, 100), (100, 100, 10), (100, 10, 100),
                        (784, 100, 100), (100, 100, 10)),
              "lm": ((BATCH * SEQ, DIM, 3 * DIM), (BATCH * SEQ, DIM, DIM),
                     (BATCH, DIM, LM_VOCAB), (BATCH, LM_VOCAB, DIM),
                     (DIM, BATCH, LM_VOCAB))}


def param_state(wf) -> dict:
    """Each parameter and momentum tensor of ``wf``'s units, f32 numpy."""
    return {f"{u.name}.{n}": t.detach().float().cpu().numpy()
            for u in [*wf.forwards, *wf.gds]
            for n, t in [*u.named_parameters(recurse=False),
                         *u.named_buffers(recurse=False)]}


def oracle_pass(card: str) -> dict:
    """Wine on the numpy oracle (``-b numpy``'s device: no region, every
    unit's ``numpy_run``) and on the card, graphed, from one seed, until
    3 train steps ran: each parameter within ``ORACLE_TOL``; the oracle
    launches no kernel, the card B4 (10, 3) once a step."""
    import numpy as np
    import torch
    from znicz_tpu_torch.backends import NumpyDevice
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.models.samples import wine
    states, launches, times = {}, {}, {}
    for device in ("numpy", None):
        reset_counts()
        t0 = time.perf_counter()
        wf = make_mlp(wine, device=device)
        steps = trained = 0
        while trained < 3:
            wf.step()
            steps += 1
            trained += wf.loader.minibatch_class == TRAIN
        if device is None:
            torch.cuda.synchronize()
        times[device or "card"] = time.perf_counter() - t0
        launches[device or "card"] = read_counts()
        states[device or "card"] = param_state(wf)
        if device == "numpy" and (wf.region is not None
                                  or not isinstance(wf.device, NumpyDevice)):
            raise AssertionError("oracle: the workflow is not on the "
                                 "numpy oracle")
    expect_counts("oracle_wine (the oracle)", launches["numpy"], {})
    expect_counts("oracle_wine (the card)", launches["card"],
                  {"softmax_argmax_wine": steps})
    worst = {k: float(np.abs(states["card"][k] - v).max()
                      / max(float(np.abs(v).max()), 1e-30))
             for k, v in states["numpy"].items()}
    name = max(worst, key=worst.get)
    say(f"  Wine on the numpy oracle against the card ({card}), f32, "
        f"{steps} steps (3 train): {len(worst)} tensors, worst max|card − "
        f"oracle| / max|oracle| {worst[name]:.3g} ({name}; tol "
        f"{ORACLE_TOL}); host time build + steps: oracle "
        f"{times['numpy']:.2f} s, card {times['card']:.2f} s")
    if worst[name] > ORACLE_TOL:
        raise AssertionError("oracle: the card leaves the numpy oracle")
    return launches["card"]


def checks_pass(card: str, path: str, make, per_step: dict,
                plant_unit: int) -> dict:
    """``engine.debug_checks`` on a graphed path (``make()`` from one
    seed, every step a train step): 2 + ``CHECK_STEPS`` steps with the
    checks off and, on a second workflow, on, every state tensor equal
    to the bit and the flags written once a member's tensor a step
    (through the replay accounting); on the first workflow the checks
    switched on (one more capture) and off again (none); then a NaN
    planted in place in the weights of forward ``plant_unit`` must
    raise naming that unit.  The step time with the checks on beside
    off.  Every B-kernel launch of the path counted (``per_step`` a
    step)."""
    import torch
    from znicz_tpu_torch import accelerated_units as au
    from znicz_tpu_torch.utils.config import root
    set_graphs(True)
    reset_counts()
    runs, ms, flags = {}, {}, {}
    for checks in (False, True):
        root.common.engine.debug_checks = checks
        wf = make()
        before = au.nan_flag.launches
        ms[checks] = timed_steps(wf, 2, CHECK_STEPS)
        flags[checks] = au.nan_flag.launches - before
        if wf.region.captures != 1:
            raise AssertionError(f"{path}: {wf.region.captures} captures")
        runs[checks] = (wf, run_state(wf))
    wf = runs[False][0]
    rel, other = state_diff(runs[False][1], runs[True][1])
    equal = sum(v == 0.0 for v in rel.values())
    n_flags = len(runs[True][0].region._flag_owner)
    del runs
    root.common.engine.debug_checks = True
    wf.step()
    on = wf.region.captures
    root.common.engine.debug_checks = False
    wf.step()
    off = wf.region.captures
    root.common.engine.debug_checks = True
    wf.step()  # a replay of the checked graph
    unit = wf.forwards[plant_unit]
    drilled(wf)
    with torch.no_grad():
        unit.weights.view(-1)[0] = float("nan")
    raised = ""
    try:
        wf.step()
    except RuntimeError as exc:
        raised = str(exc)
    root.common.engine.debug_checks = False
    torch.cuda.synchronize()
    launches = read_counts()
    n = 2 * (2 + CHECK_STEPS) + 4
    expect_counts(path, launches, {k: v * n for k, v in per_step.items()})
    expect_new_routes(path)
    say(f"  {path} on {card}: the graphed step with the checks off "
        f"{ms[False]:.4f} ms, on {ms[True]:.4f} ms ({n_flags} flags "
        f"laid out, {flags[True] / (2 + CHECK_STEPS):.0f} written a step "
        f"and one read, {flags[False]} with the checks off); checks on "
        f"against off over {2 + CHECK_STEPS} steps: {equal} of {len(rel)} "
        f"tensors bit-equal, counters that differ {sorted(other)}; "
        f"captures: 1, {on} after the checks went on, {off} after they "
        f"went off; a NaN planted in {unit.name}'s weights: "
        + (f"raised: {raised[:160]}" if raised else "not caught"))
    if equal != len(rel) or other:
        raise AssertionError(f"{path}: the checked step is not the "
                             f"unchecked one")
    if on != 2 or off != 2 or flags[False] or not flags[True]:
        raise AssertionError(f"{path}: the checks' key: captures {on}, "
                             f"{off}; flags {flags}")
    if f"written by unit '{unit.name}'" not in raised \
            or "nan" not in raised:
        raise AssertionError(f"{path}: the planted NaN in {unit.name} was "
                             f"not named: {raised!r}")
    return launches


def fp8_products(card: str) -> None:
    """``mxu_dot`` with the lever on, on ``_scaled_mm``, against its plain
    version at the paths' product shapes (``FP8_TOL``), timed beside the
    plain version and the bf16 and f32 products; what ``_scaled_mm``
    refuses unpadded; the overflow case against the CPU's, and the
    saturating cast planted in place of ``q8``, which must fail it."""
    import torch
    from znicz_tpu_torch.ops import fp8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    one = torch.ones((), device=dev)
    for path, shapes in FP8_SHAPES.items():
        for m, k, n in shapes:
            a = torch.randn(m, k, device=dev, generator=gen)
            b = torch.randn(k, n, device=dev, generator=gen) * 0.1
            before = fp8.fp8_matmul.launches_by_route["scaled_mm"]
            got = fp8.fp8_dot(a, b)
            if fp8.fp8_matmul.launches_by_route["scaled_mm"] != before + 1:
                raise AssertionError("fp8: the product did not take "
                                     "_scaled_mm")
            a8, b8 = fp8.q8(a).float(), fp8.q8(b).float()
            plain = a8 @ b8
            scale = a8.abs() @ b8.abs()
            err = float(((got - plain).abs() / scale.clamp(min=1e-30))
                        .max())
            # device times, 10 calls a CUDA graph, as the main path runs
            # them inside its captured step
            t_fp8 = graph_ms(lambda: fp8.fp8_dot(a, b), 10)
            t_plain = graph_ms(lambda: fp8.q8(a).float() @ fp8.q8(b).float(),
                               10)
            ab, bb = a.bfloat16(), b.bfloat16()
            t_bf16 = graph_ms(lambda: ab @ bb, 10)
            t_f32 = graph_ms(lambda: a @ b, 10)
            refused = []
            for mm, kk, nn in ((m, k, n),):
                try:
                    torch._scaled_mm(
                        fp8.q8(a[:mm, :kk]), fp8.q8(b[:kk, :nn]).t()
                        .contiguous().t(), scale_a=one, scale_b=one,
                        out_dtype=torch.float32)
                except RuntimeError as exc:
                    refused.append(str(exc).splitlines()[0][:120])
            say(f"  fp8 mxu_dot {path} ({m}, {k}) @ ({k}, {n}) on {card}: "
                f"max |scaled_mm − plain| / Σ|a₈||b₈| {err:.3g} (tol "
                f"{FP8_TOL:.3g}); ms: fp8 {t_fp8:.4f} (casts and padding "
                f"included), plain {t_plain:.4f}, bf16 matmul "
                f"{t_bf16:.4f}, f32 matmul {t_f32:.4f}; _scaled_mm "
                f"unpadded: " + (f"refused ({refused[0]})" if refused
                                 else "accepted"))
            if not err <= FP8_TOL:
                raise AssertionError(f"fp8: ({m}, {k}, {n}) off by {err}")
    # the overflow case: the card's product against the CPU's
    x = torch.zeros(4, 32)
    x[0, :6] = torch.tensor([463.9, -463.9, 464.0, -464.0, 1.5, -2.25])
    x[1, 3], x[2, 5], x[3, 0] = 464.1, float("inf"), -464.1
    w = torch.full((32, 16), 0.5)

    def agrees() -> bool:
        cpu = fp8.fp8_dot(x, w)
        gpu = fp8.fp8_dot(x.cuda(), w.cuda()).cpu()
        nan_rows = torch.isnan(gpu).all(dim=1).tolist()
        return (torch.equal(torch.isnan(cpu), torch.isnan(gpu))
                and torch.equal(torch.nan_to_num(cpu),
                                torch.nan_to_num(gpu))
                and nan_rows == [False, True, True, True])

    ok = agrees()
    real = fp8.q8
    # the planted fault: a cast that saturates to ±448, inf included, as
    # torch's own ``.to(float8_e4m3fn)`` does in the CPU tests' build
    fp8.q8 = lambda t: t.clamp(-448.0, 448.0).to(fp8.FP8)
    try:
        planted = agrees()
    finally:
        fp8.q8 = real
    edge = torch.tensor([463.9, 464.0, 464.1, float("inf")])
    own = {dev: edge.to(dev).to(fp8.FP8).float().cpu().tolist()
           for dev in ("cpu", "cuda")}
    say(f"  fp8 overflow case (±463.9, ±464, ±464.1, ±inf) on the card "
        f"against the CPU: {'equal' if ok else 'differs'}; planted fault "
        f"(a saturating cast in place of q8): "
        f"{'caught' if not planted else 'not caught'}; this build's own "
        f"`.to(float8_e4m3fn)` of (463.9, 464, 464.1, inf): {own}")
    if not ok or planted:
        raise AssertionError("fp8: the overflow case")


def fp8_mnist(card: str) -> dict:
    """MNIST 784-100-10 graphed with the lever on: the step beside the
    f32 step (the same workflow, lever off) and a bf16 one, then graphed
    against eager from one seed with the lever on (``MLP_GRAPH_TOL``, the
    head's update left out of the capture planted).  B4 (100, 10) once a
    step; the fp8 products on ``_scaled_mm`` inside the captured step."""
    from znicz_tpu_torch.models.samples import mnist
    from znicz_tpu_torch.ops import fp8
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root, root

    def make():
        wf = make_mlp(mnist)  # (resets root)
        root.common.engine.fp8_matmul = True
        return wf

    set_graphs(True)
    reset_counts()
    steps = 2 + CHECK_STEPS
    ms = {}
    wf = make()
    train_ahead(wf, 4 * steps)
    before = dict(fp8.fp8_matmul.launches_by_route)
    ms["fp8"] = timed_steps(wf, 2, CHECK_STEPS)
    captures = wf.region.captures
    routes = {k: v - before[k]
              for k, v in fp8.fp8_matmul.launches_by_route.items()}
    root.common.engine.fp8_matmul = False
    ms["f32"] = timed_steps(wf, 2, CHECK_STEPS)
    root.common.engine.fp8_matmul = True
    ms["fp8 again"] = timed_steps(wf, 2, CHECK_STEPS)
    reset_root()
    root.common.precision_type = "bfloat16"
    prng.seed_all(SEED)
    bf = mnist.build()
    bf.initialize()
    train_ahead(bf, steps)
    ms["bf16"] = timed_steps(bf, 2, CHECK_STEPS)
    launches = read_counts()
    del bf
    say(f"  MNIST B=100 graphed on {card}, ms a train step: fp8 "
        f"{ms['fp8']:.4f} / {ms['fp8 again']:.4f}, f32 {ms['f32']:.4f}, "
        f"bf16 {ms['bf16']:.4f}; {captures} capture(s) with the lever on "
        f"(+1 a key when flipped: {wf.region.captures}); fp8 products a "
        f"step by route {({k: v / steps for k, v in routes.items()})}")
    if routes["plain"] or routes["scaled_mm"] != 5 * steps:
        raise AssertionError(f"fp8_mnist: products by route {routes}")
    del wf
    root.common.engine.fp8_matmul = False
    graphed_vs_eager(make, "fp8_mnist", tol=MLP_GRAPH_TOL,
                     ready=train_ahead, captures=3)
    root.common.engine.fp8_matmul = False
    return launches


def fp8_lm(card: str) -> dict:
    """The byte LM graphed with the lever on (bf16 activations, e4m3
    products): the step beside the bf16 step (lever off) and the f32
    step, then graphed against eager from one seed with the lever on.
    Its kernels once a step, the f32 run's the f32 rows."""
    from znicz_tpu_torch.ops import fp8
    from znicz_tpu_torch.utils.config import root
    x, y = lm_data(LM_TRAIN, SEQ, SEED + 10)
    steps = 2 + CHECK_STEPS
    set_graphs(True)
    reset_counts()
    ms = {}
    root.common.engine.fp8_matmul = True
    wf = make_lm(x, y, LM_TRAIN, BATCH)
    before = dict(fp8.fp8_matmul.launches_by_route)
    ms["fp8"] = timed_steps(wf, 2, CHECK_STEPS)
    routes = {k: v - before[k]
              for k, v in fp8.fp8_matmul.launches_by_route.items()}
    root.common.engine.fp8_matmul = False
    ms["bf16"] = timed_steps(wf, 2, CHECK_STEPS)
    del wf
    want = lm_counts(2 * steps)
    wf = make_lm(x, y, LM_TRAIN, BATCH, precision="float32")
    ms["f32"] = timed_steps(wf, 2, CHECK_STEPS)
    del wf
    launches = read_counts()
    want.update({"flash_attention_fwd_f32": steps,
                 "flash_attention_dq_f32": steps,
                 "flash_attention_dkv_f32": steps,
                 "layer_norm_forward_f32": steps,
                 "layer_norm_backward_f32": steps})
    want["softmax_argmax_lm"] += steps
    expect_counts("fp8_lm", launches, want)
    expect_new_routes("fp8_lm")
    say(f"  byte LM B={BATCH} T={SEQ} graphed on {card}, ms a train step: "
        f"fp8 products (bf16 activations) {ms['fp8']:.4f}, bf16 "
        f"{ms['bf16']:.4f}, f32 {ms['f32']:.4f}; fp8 products a step by "
        f"route {({k: v / steps for k, v in routes.items()})}")
    if routes["plain"] or not routes["scaled_mm"]:
        raise AssertionError(f"fp8_lm: products by route {routes}")

    def make_fp8():
        root.common.engine.fp8_matmul = True
        return make_lm(x, y, LM_TRAIN, BATCH)

    graphed_vs_eager(make_fp8, "fp8_lm", plant=lambda wf: frozen_update(
        wf, 0), fault="the embedding's update left out of the capture")
    root.common.engine.fp8_matmul = False
    return launches


# ----------------------------------------------------------------------
# phase 12: the small vision samples and the conv autoencoders
# ----------------------------------------------------------------------
#: epochs of each small vision sample (tests/test_vision_samples.py's)
A6A_EPOCHS = 8
#: (sample, minibatch, classes, the ``kernels`` row its head's launches
#: count in, the best validation error (%) its 8 epochs must reach:
#: tests/test_vision_samples.py's bars); channels' 8-class head counts
#: in the scorer head's 8-class row
A6A = (("hands", 40, 2, "softmax_argmax_hands", 15.0),
       ("yale_faces", 20, 15, "softmax_argmax_yale", 25.0),
       ("channels", 50, 8, "softmax_argmax_small", 30.0))
#: epochs of each autoencoder's CLI run
AE_EPOCHS = 3
#: (sample, minibatch, the region's keys (test, validation, train),
#: warm-up and timed train steps of ab_steps: no more than an epoch's
#: train minibatches)
AE = (("mnist_ae", 100, 3, 2, 20), ("imagenet_ae", 64, 2, 2, 6))
#: imagenet_ae's learning rate for the run whose MSE must fall: at the
#: sample's 0.005 (the reference's) the reconstruction of its uniform
#: noise frames diverges to the tanh's saturation in both packages (the
#: default run is printed first); at 5e-5 the reference's falls too
AE_LR = {"imagenet_ae": 5e-05}
#: graphed train steps of the tied mnist_ae before its storage check
AE_TIED_STEPS = 10


def steps_per_epoch(loader) -> int:
    """Minibatches of one epoch, a short last one of a class included."""
    return sum(-(-n // loader.max_minibatch_size)
               for n in loader.class_lengths)


def a6a_pass(card: str, name: str, batch: int, classes: int, row: str,
             bar: float) -> dict:
    """A small vision sample through ``Main().run([name, ...])`` graphed
    for 8 epochs: B4 once a step at (batch, classes) on its register
    route (the replay accounting), one capture a key, the best
    validation error under the reference test's bar; the train step
    graphed and eager in turns, the counted launches the kernels the
    profiler saw."""
    import torch
    reset_counts()
    t0 = time.perf_counter()
    wf, errors, captures = mlp_cli(name, "--root",
                                   f"{name}.max_epochs={A6A_EPOCHS}")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    steps = A6A_EPOCHS * steps_per_epoch(wf.loader)
    head = tuple(wf.forwards[-1].output.shape)
    say(f"  python -m znicz_tpu_torch {name} --root {name}.max_epochs="
        f"{A6A_EPOCHS}: {A6A_EPOCHS} epochs ({steps} steps) in "
        f"{host_s:.2f} s on the host clock, dataset "
        f"{tuple(wf.loader.class_lengths)} (test, validation, train), "
        f"head {head}; validation error by epoch, %: {errors}; graph "
        f"captures at each epoch's end {captures}")
    if head != (batch, classes):
        raise AssertionError(f"{name}: the head is {head}")
    expect_counts(name, launches, {row: steps})
    expect_new_routes(name)
    expect_captures(name, captures, 2)
    best = wf.decision.min_validation_n_err_pt
    if len(errors) != A6A_EPOCHS or not best <= bar:
        raise AssertionError(f"{name}: best validation error {best} % "
                             f"(want <= {bar} %)")
    ab = ab_steps(wf, name, 2, 6, lambda n: train_ahead(wf, n))
    say(f"  {name} train step (B={batch}, f32) on {card}: "
        + ab_line(ab, batch, "img/s"))
    EAGER[f"{name}_ab"] = ab
    return launches


def make_ae(module, device=None, precision: str = "float32",
            **overrides):
    """An autoencoder sample's workflow from ``SEED`` on ``device``
    (None: the card) in ``precision``."""
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root, root
    reset_root()
    root.common.precision_type = precision
    prng.seed_all(SEED)
    wf = module.build(**overrides)
    wf.initialize(device=device)
    return wf


def first_cell_depooling(wf) -> None:
    """The planted fault of phase 12: the depooling scatters every window
    to its first cell, not to the pooling's winner."""
    import copy
    import torch
    depool = wf.forwards[2]
    pool = depool.pooling_unit
    fake = copy.copy(pool)

    def winners(px, with_indices=True):
        n, h, w, c = px.shape
        oh, ow = pool.output_spatial(h, w)
        sy, sx = pool.sliding
        wp = (ow - 1) * sx + pool.kx
        first = (torch.arange(oh, device=px.device)[:, None] * sy * wp
                 + torch.arange(ow, device=px.device)[None, :] * sx)
        return None, first.expand(n, c, oh, ow).contiguous()

    fake.winners = winners
    depool.__dict__["pooling_unit"] = fake


def ae_steps_vs_cpu(module, label: str, batch: int, precision: str,
                    tol: float, plant=None) -> None:
    """One train step on the card against the CPU's from the same seed,
    each parameter's update (max-relative, as :func:`check_step_on_cpu`);
    with ``plant`` a second card step with that fault planted must fail
    the same bound."""
    def ready(device):
        wf = make_ae(module, device, precision)
        train_ahead(wf, 1)
        return wf

    t0 = time.perf_counter()
    cpu = step_updates(ready("cpu"))
    runs = {"true": None} if plant is None else {"true": None,
                                                  "planted": plant}
    worst = {}
    for mode, fault in runs.items():
        wf = ready(None)
        if fault is not None:
            fault(wf)
        card = step_updates(wf)
        del wf
        check_finite(card)
        worst[mode] = (max(max_rel(card[k], cpu[k]) for k in cpu),
                       max(norm_rel(card[k], cpu[k]) for k in cpu))
    say(f"  one train step ({label}, B={batch}, {precision}) on the card "
        f"vs the CPU: worst max|card − cpu| / max|cpu update| "
        f"{worst['true'][0]:.3g} (tol {tol}), worst ‖card − cpu‖ / ‖cpu "
        f"update‖ {worst['true'][1]:.3g}"
        + ("" if plant is None else
           f"; with a depooling that scatters every window to its first "
           f"cell planted: {worst['planted'][0]:.3g}")
        + f", {time.perf_counter() - t0:.1f} s")
    if worst["true"][0] > tol:
        raise AssertionError(f"{label}: the card's train step disagrees "
                             f"with the CPU's")
    if plant is not None and worst["planted"][0] <= tol:
        raise AssertionError(f"{label}: the check against the CPU passes "
                             f"a planted depooling fault")


def ae_serve(card: str, wf) -> dict:
    """``wf`` (the trained mnist_ae) exported and served through
    ``ServingEngine(max_batch=16)``, each bucket a CUDA graph: 1, 3 and
    16 rows, no hand-written kernel, the 1-row reply against
    ``ExportedModel.load(path, device="cpu")`` within ``SLICE_TOL``, p50
    and rows/s eager and graphed in turns."""
    import numpy as np
    from znicz_tpu_torch import datasets
    from znicz_tpu_torch.export import ExportedModel, read_bundle
    from znicz_tpu_torch.serving import ServingEngine
    x = (datasets.load_mnist()[2][:16, :, :, None].astype(np.float32)
         / np.float32(255.0))
    with tempfile.TemporaryDirectory() as tmp:
        path = wf.export_forward(os.path.join(tmp, "mnist_ae.npz"))
        manifest, _ = read_bundle(path)
        ties = [(i, spec.get("tied_to"), spec.get("tied_weights"))
                for i, spec in enumerate(manifest["layers"])
                if "tied_to" in spec]
        reset_counts()
        eng = ServingEngine(path, max_batch=BATCH, max_delay_ms=2.0)
        try:
            eng.start()
            expect_ladder_captures(eng, "mnist_ae_serve")
            replies = graphed_dispatches(eng, x, (), "mnist_ae_serve")
            for n, reply in replies.items():
                if reply.shape != (n, 28, 28, 1) \
                        or np.abs(reply).max() > 1.7159:
                    raise AssertionError(f"mnist_ae_serve: bad {n}-row "
                                         f"reply {reply.shape}")
            ab = serve_ab(eng, x, "mnist_ae", card)
            expect_ladder_captures(eng, "mnist_ae_serve")
            launches = read_counts()
        finally:
            eng.shutdown()
        want = ExportedModel.load(path, device="cpu")(x[:1])
    expect_counts("mnist_ae_serve", launches, {})
    err = float(np.abs(want - replies[1]).max())
    say(f"  mnist_ae exported (ties {ties}: (layer, tied_to, tied_weights))"
        f" and served through ServingEngine(max_batch={BATCH}) on {card}: "
        f"replies of 1, 3 and 16 rows (28, 28, 1), graphed p50 latency "
        f"{ab['graphed'][0][0]:.3f} ms, {ab['graphed'][0][1]:.1f} rows/s; "
        f"1-row reply "
        f"vs ExportedModel(device='cpu'): max_abs_err {err:.3g} (tol "
        f"{SLICE_TOL})")
    if err > SLICE_TOL or ties != [(2, 1, False), (3, 0, False)]:
        raise AssertionError("mnist_ae_serve: the card's reply disagrees "
                             "with the CPU's, or the ties are lost")
    return launches


def ae_pass(card: str, name: str, batch: int, keys: int, warmup: int,
            steps: int) -> dict:
    """An autoencoder sample through ``Main().run([name, ...])`` graphed
    at full width, f32: no hand-written kernel, one capture a key, the
    validation MSE by epoch falling; the train step graphed and eager in
    turns (img/s, peak memory); 3 graphed steps against 3 eager from one
    seed (``MLP_GRAPH_TOL``) with the deconv's update left out of the
    capture planted; one train step against the CPU's
    (``TRAIN_STEP_TOL_F32``), a planted first-cell depooling caught by
    it; imagenet_ae also in bf16 (``TRAIN_STEP_TOL``); mnist_ae exported
    and served.  Returns the launches by path."""
    import importlib
    import torch
    from znicz_tpu_torch.loader.base import TRAIN, VALID
    module = importlib.import_module(f"znicz_tpu_torch.models.samples.{name}")
    args = ["--root", f"{name}.max_epochs={AE_EPOCHS}"]
    if name in AE_LR:
        reset_counts()
        wf, mses, _ = mlp_cli(name, *args)
        expect_counts(name, read_counts(), {})
        say(f"  python -m znicz_tpu_torch {name} at the sample's learning "
            f"rate {wf.gds[0].learning_rate}: MSE by epoch (test, "
            f"validation, train): {mses}")
        del wf
        args += ["--root", f"{name}.learning_rate={AE_LR[name]}"]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf, mses, captures = mlp_cli(name, *args)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    out = {name: read_counts()}
    history = wf.decision.epoch_mse_history
    shapes = [tuple(u.output.shape) for u in wf.forwards]
    say(f"  python -m znicz_tpu_torch {name} {' '.join(args)}: "
        f"{AE_EPOCHS} epochs in {host_s:.2f} s on the host "
        f"clock, dataset {tuple(wf.loader.class_lengths)} (test, "
        f"validation, train), outputs {shapes}; MSE by epoch (test, "
        f"validation, train): {mses}; graph captures at each epoch's end "
        f"{captures}")
    expect_counts(name, out[name], {})
    expect_captures(name, captures, keys)
    if shapes[-1] != (batch, *wf.loader.sample_shape):
        raise AssertionError(f"{name}: the decoder gives {shapes[-1]}")
    for cls in (VALID, TRAIN):
        h = history[cls]
        if len(h) != AE_EPOCHS or not h[-1] < h[0]:
            raise AssertionError(f"{name}: the MSE does not fall: {h}")
    ab = ab_steps(wf, name, warmup, steps, lambda n: train_ahead(wf, n),
                  no_kernels=True)
    say(f"  {name} train step (B={batch}, f32) on {card}: "
        + ab_line(ab, batch, "img/s") + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if name == "mnist_ae":
        out["mnist_ae_serve"] = ae_serve(card, wf)
    del wf
    ab["trajectory"] = graphed_vs_eager(
        lambda: make_ae(module), name, tol=MLP_GRAPH_TOL, ready=train_ahead,
        captures=keys, fault="the deconv's update left out of the capture")
    ae_steps_vs_cpu(module, name, batch, "float32", TRAIN_STEP_TOL_F32,
                    plant=first_cell_depooling)
    if name == "imagenet_ae":
        ae_steps_vs_cpu(module, name, batch, "bfloat16", TRAIN_STEP_TOL)
    EAGER[f"{name}_ab"] = ab
    return out


def untie(wf) -> None:
    """The planted fault: the deconv's weights untied to a copy of the
    conv's."""
    import torch
    deconv, conv = wf.forwards[3], wf.forwards[0]
    deconv._linked_attrs.pop("weights")
    deconv.weights = torch.nn.Parameter(conv.weights.detach().clone(),
                                        requires_grad=False)


def tied_ae_pass(card: str) -> dict:
    """mnist_ae with ``tied_weights`` on its deconv, graphed: after
    ``AE_TIED_STEPS`` train steps the deconv's and the conv's weights are
    one storage and have moved, with a deconv untied to a copy planted
    (which that check must catch); 3 graphed steps against 3 eager from
    one seed (``MLP_GRAPH_TOL``), the deconv's update left out of the
    capture planted."""
    import torch
    from znicz_tpu_torch.models.samples import mnist_ae
    plain = mnist_ae.ae_layers

    def tied_layers(cfg):
        layers = plain(cfg)
        layers[3] = {**layers[3], "tied_weights": True}
        return layers

    mnist_ae.ae_layers = tied_layers
    try:
        shared = {}
        launches = None
        for mode in ("true", "planted"):
            reset_counts()
            wf = make_ae(mnist_ae)
            if mode == "planted":
                untie(wf)
            train_ahead(wf, AE_TIED_STEPS)
            conv, deconv = wf.forwards[0], wf.forwards[3]
            w0 = conv.weights.detach().clone()
            for _ in range(AE_TIED_STEPS):
                wf.step()
            torch.cuda.synchronize()
            if mode == "true":
                launches = read_counts()
            shared[mode] = (deconv.weights.data_ptr()
                            == conv.weights.data_ptr()
                            and deconv.weights is conv.weights
                            and not torch.equal(w0, conv.weights),
                            wf.region.captures)
            del wf
        say(f"  mnist_ae with tied_weights, {AE_TIED_STEPS} graphed train "
            f"steps on {card}: the conv's and the deconv's weights one "
            f"moved storage {shared['true'][0]} (captures "
            f"{shared['true'][1]}); with the deconv untied to a copy "
            f"planted: {shared['planted'][0]}")
        expect_counts("mnist_ae_tied", launches, {})
        if not shared["true"][0]:
            raise AssertionError("mnist_ae_tied: the tied weights are not "
                                 "one storage")
        if shared["planted"][0]:
            raise AssertionError("mnist_ae_tied: the storage check passes "
                                 "a deconv untied to a copy")
        say("  mnist_ae_tied: planted fault (the deconv untied to a copy) "
            "caught")
        graphed_vs_eager(lambda: make_ae(mnist_ae), "mnist_ae_tied",
                         tol=MLP_GRAPH_TOL, ready=train_ahead, captures=3,
                         fault="the deconv's update left out of the "
                               "capture")
    finally:
        mnist_ae.ae_layers = plain
    return launches


# ----------------------------------------------------------------------
# phase 13: the RBM, the Kohonen map and the last op units, graphed
# ----------------------------------------------------------------------
#: the reference test's bars: mnist_rbm's best validation MSE under this
#: share of its first epoch's, kohonen's best quantization error under
#: this share of its first epoch's
RBM_MSE_BAR, SOM_QE_BAR = 0.75, 0.5
#: steps of the graphed-against-eager runs after the first three train
#: minibatches are reached: across an epoch's end (mnist_rbm: 13 steps
#: an epoch, kohonen: 20), so the eval key and the decision's in-place
#: resets are replayed too
LOOP_GRAPH_STEPS = {"mnist_rbm": 20, "kohonen": 25}
#: the cutter chain: 10 classes of synthetic 32 × 32 RGB images, 800
#: train and 200 validation, B = 100, two epochs
CHAIN_BATCH, CHAIN_TRAIN, CHAIN_VALID, CHAIN_EPOCHS = 100, 800, 200, 2
CHAIN_LAYERS = (
    {"type": "conv_tanh", "->": {"n_kernels": 16, "kx": 5, "ky": 5,
                                 "padding": 2},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "cutter", "->": {"padding": 2}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 64},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
)
#: the cutter chain's image saver: at most this many files an epoch
CHAIN_SAVE_LIMIT = 8
#: the filter similarity (a Gram product of fan-in 75) on the card
#: against numpy, f32 on both sides: sums in other orders, a few ulps of
#: a unit-diagonal matrix
DIVERSITY_TOL = 1e-5


def param_updates(wf, params) -> dict:
    """One step of ``wf``: the update of each of ``params`` (name →
    tensor), as f32 on the CPU."""
    before = {k: p.detach().float().cpu().clone() for k, p in params.items()}
    wf.step()
    return {k: p.detach().float().cpu() - before[k]
            for k, p in params.items()}


def loop_params(wf) -> dict:
    """The trained tensors of the RBM's or the SOM's workflow."""
    if hasattr(wf, "grbm"):
        return {"encoder.weights": wf.encoder.weights,
                "encoder.bias": wf.encoder.bias,
                "gradient_rbm.vbias": wf.grbm.vbias}
    return {"kohonen.weights": wf.forward.weights}


def loop_step_vs_cpu(module, label: str) -> None:
    """One train step of a sample on the card against the CPU's from
    ``SEED`` (each tensor's update, max-relative, ``TRAIN_STEP_TOL_F32``:
    f32 on both sides, the products summed in other orders)."""
    def ready(device):
        wf = make_mlp(module, device)
        train_ahead(wf, 1)
        return wf

    t0 = time.perf_counter()
    cpu_wf = ready("cpu")
    cpu = param_updates(cpu_wf, loop_params(cpu_wf))
    card_wf = ready(None)
    card = param_updates(card_wf, loop_params(card_wf))
    del card_wf
    check_finite(card)
    worst = max(max_rel(card[k], cpu[k]) for k in cpu)
    say(f"  one train step ({label}) on the card vs the CPU: worst "
        f"max|card − cpu| / max|cpu update| {worst:.3g} (tol "
        f"{TRAIN_STEP_TOL_F32}), {time.perf_counter() - t0:.1f} s")
    if worst > TRAIN_STEP_TOL_F32:
        raise AssertionError(f"{label}: the card's train step disagrees "
                             f"with the CPU's")


def rebound_rbm_update(wf) -> None:
    """The planted fault of mnist_rbm: the weight update bound to a new
    tensor (``W + ΔW``, a new Parameter) instead of written into W."""
    import torch
    grbm, enc = wf.grbm, wf.encoder
    cd = grbm.cd

    def cd_rebinding(v0, h0, s0):
        w = enc.weights
        old = w.detach().clone()
        out = cd(v0, h0, s0)                # W += ΔW in place
        new = w.detach().clone()
        w.data.copy_(old)                   # W left as it was
        enc.weights = torch.nn.Parameter(new, requires_grad=False)
        return out

    grbm.cd = cd_rebinding


def rebound_hits(wf) -> None:
    """The planted fault of kohonen: ``DecisionSOM`` resets the hit
    counts by binding a new zero tensor, not by zeroing them in place."""
    import torch
    decision, fwd = wf.decision, wf.forward
    on_epoch_ended = decision.on_epoch_ended

    def rebinding():
        hits = fwd.hits
        counts = hits.clone()
        on_epoch_ended()                    # zeroes them in place
        hits.copy_(counts)                  # the old tensor keeps them
        fwd.hits = torch.zeros_like(counts)

    decision.on_epoch_ended = rebinding


def loop_graphed_vs_eager(module, path: str, plant, fault: str) -> None:
    """``LOOP_GRAPH_STEPS[path]`` steps of the sample from ``SEED`` with
    its region eager, then graphed (2 captures: train and eval), then
    graphed with ``plant`` planted; the graphed run's state bit-equal to
    the eager run's (parameters, sums, counts, the seed chain, the
    clock), the planted run caught: its state leaves the eager one, or
    a replay refuses a rebound tensor."""
    import torch
    steps = LOOP_GRAPH_STEPS[path]
    states, caught = {}, None
    for mode in ("eager", "graphed", "planted"):
        set_graphs(mode != "eager")
        wf = make_mlp(module)
        if mode == "planted":
            plant(wf)
        try:
            train_ahead(wf, 3)
            for _ in range(steps):
                wf.step()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            if mode != "planted" or "rebound" not in str(exc):
                raise
            caught = str(exc)
            del wf
            continue
        if mode != "eager" and wf.region.captures != 2:
            raise AssertionError(f"{path}: {wf.region.captures} captures")
        states[mode] = run_state(wf)
        del wf
    set_graphs(True)
    rel, other = state_diff(states["eager"], states["graphed"])
    same = sum(v == 0.0 for v in rel.values())
    say(f"  {path}: {steps} steps graphed (a warm-up a key, then replays) "
        f"against eager from one seed: {same} of {len(rel)} tensors "
        f"bit-equal (worst ‖graphed − eager‖ / ‖eager‖ "
        f"{max(rel.values()):.3g}), counters that differ: {sorted(other)}")
    if same != len(rel) or other:
        raise AssertionError(f"{path}: the graphed run is not the eager "
                             f"run bit for bit")
    if caught is None:
        rel, other = state_diff(states["eager"], states["planted"])
        worst = max(rel.values())
        say(f"  {path}: with {fault} planted: worst ‖planted − eager‖ / "
            f"‖eager‖ {worst:.3g}, counters that differ: {sorted(other)}")
        if worst == 0.0 and not other:
            raise AssertionError(f"{path}: the check passes a planted "
                                 f"fault ({fault})")
    else:
        say(f"  {path}: with {fault} planted, a replay refused: "
            f"{caught[:160]}")
    say(f"  {path}: planted fault ({fault}) caught")


def rbm_pass(card: str) -> dict:
    """mnist_rbm through ``Main().run(["mnist_rbm"])`` graphed for the
    sample's 25 epochs: no hand-written kernel, one capture a key, the
    reference test's MSE bar; the step graphed and eager in turns; one
    train step against the CPU's; graphed bit-equal to eager with a
    rebound weight update planted."""
    import importlib
    import torch
    from znicz_tpu_torch.loader.base import VALID
    module = importlib.import_module("znicz_tpu_torch.models.samples."
                                     "mnist_rbm")
    reset_counts()
    t0 = time.perf_counter()
    wf, mses, captures = mlp_cli("mnist_rbm")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    history = wf.decision.epoch_mse_history[VALID]
    epochs = len(history)
    say(f"  python -m znicz_tpu_torch mnist_rbm: {epochs} epochs "
        f"({epochs * steps_per_epoch(wf.loader)} steps) in {host_s:.2f} s "
        f"on the host clock, dataset {tuple(wf.loader.class_lengths)} "
        f"(test, validation, train), 64 visible → 48 hidden, B = "
        f"{wf.loader.max_minibatch_size}; MSE by epoch (test, validation, "
        f"train): first {mses[0]}, last {mses[-1]}; best validation "
        f"{wf.decision.min_validation_mse:.4f} (bar < {RBM_MSE_BAR} × "
        f"{history[0]:.4f}); graph captures at each epoch's end "
        f"{sorted(set(captures))}")
    expect_counts("mnist_rbm", launches, {})
    expect_captures("mnist_rbm", captures, 2)
    if epochs != 25 or not wf.decision.min_validation_mse \
            < RBM_MSE_BAR * history[0]:
        raise AssertionError("mnist_rbm: the reconstruction MSE misses the "
                             "reference test's bar")
    ab = ab_steps(wf, "mnist_rbm", 2, 6, lambda n: train_ahead(wf, n),
                  no_kernels=True)
    say(f"  mnist_rbm train step (B={wf.loader.max_minibatch_size}, f32) "
        f"on {card}: " + ab_line(ab, wf.loader.max_minibatch_size,
                                 "samples/s"))
    EAGER["mnist_rbm_ab"] = ab
    del wf
    loop_step_vs_cpu(module, "mnist_rbm")
    loop_graphed_vs_eager(module, "mnist_rbm", rebound_rbm_update,
                          "the weight update bound to a new tensor")
    return launches


def som_pass(card: str) -> dict:
    """kohonen through ``Main().run(["kohonen"])`` graphed for the
    sample's 12 epochs: no hand-written kernel, one capture a key, the
    reference test's QE bar, the neurons used; the step graphed and
    eager in turns; one train step against the CPU's; graphed bit-equal
    to eager with the decision's reset of the hits by rebinding
    planted."""
    import importlib
    import torch
    module = importlib.import_module("znicz_tpu_torch.models.samples."
                                     "kohonen")
    reset_counts()
    t0 = time.perf_counter()
    wf, qes, captures = mlp_cli("kohonen")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    say(f"  python -m znicz_tpu_torch kohonen: {len(qes)} epochs "
        f"({len(qes) * steps_per_epoch(wf.loader)} steps) in {host_s:.2f} "
        f"s on the host clock, dataset {tuple(wf.loader.class_lengths)} "
        f"(test, validation, train), an 8 × 8 map of 2-D points, B = "
        f"{wf.loader.max_minibatch_size}; (quantization error, neurons "
        f"used of 64) by epoch: {qes}; best {wf.decision.best_qe:.5f} (bar "
        f"< {SOM_QE_BAR} × {qes[0][0]}); graph captures at each epoch's "
        f"end {sorted(set(captures))}")
    expect_counts("kohonen", launches, {})
    expect_captures("kohonen", captures, 2)
    if len(qes) != 12 or not wf.decision.best_qe < SOM_QE_BAR * qes[0][0]:
        raise AssertionError("kohonen: the quantization error misses the "
                             "reference test's bar")
    if not all(0 < used <= 64 for _, used in qes):
        raise AssertionError(f"kohonen: neurons used by epoch {qes}")
    ab = ab_steps(wf, "kohonen", 2, 6, lambda n: train_ahead(wf, n),
                  no_kernels=True)
    say(f"  kohonen train step (B={wf.loader.max_minibatch_size}, f32) on "
        f"{card}: " + ab_line(ab, wf.loader.max_minibatch_size,
                              "samples/s"))
    EAGER["kohonen_ab"] = ab
    del wf
    loop_step_vs_cpu(module, "kohonen")
    loop_graphed_vs_eager(module, "kohonen", rebound_hits,
                          "the decision's reset of the hits by rebinding")
    return launches


def make_chain(device=None, out_dir: str | None = None):
    """The cutter chain (``CHAIN_LAYERS``) on synthetic 10-class images
    from ``SEED``; with ``out_dir`` a zero filler masking every third of
    the conv's weights (after the backward chain: the last member of
    the region) and an image saver writing there (after the decision)
    are linked.  Returns ``(workflow, mask)``."""
    import numpy as np
    from znicz_tpu_torch import datasets
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.ops.weights_zerofilling import ZeroFiller
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root
    reset_root()
    prng.seed_all(SEED)
    x, y, _, _ = datasets.synthetic_images(
        n_train=CHAIN_TRAIN + CHAIN_VALID, n_test=0, size=32, channels=3,
        n_classes=10, seed=SEED)
    wf = StandardWorkflow(
        name="cutter_chain",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x[CHAIN_VALID:], train_labels=y[CHAIN_VALID:],
            valid_data=x[:CHAIN_VALID], valid_labels=y[:CHAIN_VALID],
            minibatch_size=CHAIN_BATCH, normalization_scale=2.0 / 255.0,
            normalization_bias=-1.0),
        layers=[dict(spec) for spec in CHAIN_LAYERS],
        decision_config={"max_epochs": CHAIN_EPOCHS})
    mask = None
    if out_dir is not None:
        mask = (np.arange(5 * 5 * 3 * 16).reshape(5, 5, 3, 16) % 3 != 0
                ).astype(np.float32)
        zf = ZeroFiller(wf, name="zero_filler")
        zf.link_attrs(wf.forwards[0], ("target_weights", "weights"))
        zf.zero_mask.reset(mask)
        zf.link_from(wf.gds[0])          # in the region, after the update
        wf.link_image_saver(out_dir=out_dir, limit=CHAIN_SAVE_LIMIT)
    wf.initialize(device=device)
    return wf, mask


def read_png(path: str):
    """A PNG that ``ImageSaver`` wrote, decoded (8-bit L or RGB, one
    filter type 0 a row): checks the signature and every chunk's CRC."""
    import struct
    import zlib
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head
    ch = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    if depth != 8 or raw[:, 0].any():
        raise AssertionError(f"{path}: depth {depth}, row filters "
                             f"{set(raw[:, 0])}")
    img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def chain_pass(card: str) -> dict:
    """conv → cutter → max_pooling → all2all → softmax (10 classes) with
    a zero filler and an image saver, through ``run_chunked(8)``, which
    falls back to per-step replays for the saver: B4 once a step on its
    register route (the ``softmax_argmax_cifar`` row), two captures, the
    masked weights exactly 0, the saver's PNGs read back against their
    samples; the step graphed and eager in turns; one train step against
    the CPU's; the filter similarity of the trained conv on the card
    against numpy."""
    import numpy as np
    import torch
    from znicz_tpu_torch.ops import diversity
    from znicz_tpu_torch.ops.image_saver import to_image_array
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        wf, mask = make_chain(out_dir=tmp)
        t0 = time.perf_counter()
        wf.run_chunked(8)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = read_counts()
        steps = CHAIN_EPOCHS * steps_per_epoch(wf.loader)
        saver = wf.image_saver
        shapes = [tuple(u.output.shape) for u in wf.forwards]
        say(f"  the cutter chain, {CHAIN_EPOCHS} epochs ({steps} steps) "
            f"through run_chunked(8) in {host_s:.2f} s on the host clock: "
            f"outputs {shapes}; validation error by epoch "
            f"{wf.decision.epoch_n_err_pt}; captures "
            f"{wf.region.captures}; the image saver ran {saver.run_count} "
            f"times")
        expect_counts("cutter_chain", launches,
                      {"softmax_argmax_cifar": steps})
        expect_new_routes("cutter_chain")
        if shapes[1] != (CHAIN_BATCH, 28, 28, 16) \
                or wf.region.captures != 2 or saver.run_count != steps \
                or type(wf.region.units[-1]).__name__ != "ZeroFiller":
            raise AssertionError("cutter_chain: the cutter's shape, the "
                                 "captures, the per-step fallback or the "
                                 "zero filler in the region")
        w = wf.forwards[0].weights.detach().cpu().numpy()
        masked = w[mask == 0.0]
        say(f"  zero filler (in the step's graph): {masked.size} masked "
            f"conv weights, max |w| "
            f"there {np.abs(masked).max()}, {int((w[mask == 1.0] != 0).sum())}"
            f" of {int(mask.sum())} others nonzero")
        if np.any(masked != 0.0) or not np.all(w[mask == 1.0] != 0.0):
            raise AssertionError("cutter_chain: the masked weights are not "
                                 "exactly 0")
        files = sorted(os.path.join(d, f) for d, _, names in os.walk(tmp)
                       for f in names)
        data = wf.loader.original_data.cpu().numpy()
        for path in files:
            sample = int(os.path.basename(path).split("_")[0])
            norm = (data[sample].astype(np.float64) * np.float32(2.0 / 255.0)
                    + np.float32(-1.0)).astype(np.float32)
            if not np.array_equal(read_png(path), to_image_array(norm)):
                raise AssertionError(f"{path}: the pixels are not the "
                                     f"sample's")
        epochs = sorted({os.path.basename(os.path.dirname(p))
                         for p in files})
        say(f"  image saver: {len(files)} PNGs of misclassified "
            f"validation samples in {epochs}, each read back (signature, "
            f"CRCs, pixels equal to its sample's)")
        if not files:
            raise AssertionError("cutter_chain: the image saver wrote no "
                                 "file")
        sim = diversity.filter_similarity(
            diversity.filter_rows(wf.forwards[0].weights), xp=torch)
        want = diversity.filter_similarity(w)
        err = float(np.abs(sim.cpu().numpy() - want).max())
        say(f"  diversity of the trained conv (16 filters of fan-in 75): "
            f"the Gram product on the card vs numpy max_abs_err {err:.3g} "
            f"(tol {DIVERSITY_TOL}), groups at 0.85 "
            f"{diversity.similar_kernel_groups(w)}")
        if err > DIVERSITY_TOL:
            raise AssertionError("the filter similarity on the card "
                                 "disagrees with numpy")
        ab = ab_steps(wf, "cutter_chain", 2, 6, lambda n: train_ahead(wf, n))
        say(f"  cutter chain train step (B={CHAIN_BATCH}, f32, the zero "
            f"filler in the step's graph, the image saver after it) on "
            f"{card}: "
            + ab_line(ab, CHAIN_BATCH, "img/s"))
        EAGER["cutter_chain_ab"] = ab
        del wf

    def ready(device):
        chain, _ = make_chain(device)
        train_ahead(chain, 1)
        return chain

    check_step_on_cpu(ready, "the cutter chain, B=100, f32",
                      TRAIN_STEP_TOL_F32)
    return launches


# ----------------------------------------------------------------------
# phase 14: the serving buckets as CUDA graphs — hot swap under load,
# int8, the SDC shadow audit, the fault sites, request traces and the
# flight recorder
# ----------------------------------------------------------------------
#: weight swaps under load in phase 14, in and out
SWAPS = 8
#: graphed replies against eager ones of the same engine and input: the
#: same kernels in the same order, with no atomics in a forward, so the
#: bits must agree
SERVE_GRAPH_TOL = 0.0
#: an int8 reply of the card against the int8 bundle's numpy oracle,
#: probabilities: both dequantize the same q·scale rounded to bf16, but
#: the card rounds the request, q/k/v, p and the attention and
#: layer-norm outputs to bf16 where the oracle stays f32 (~2⁻⁸ relative
#: on each activation); the bound is the shadow audit's own (rtol 0.05
#: of max(|p|, 1)), which the engine's audit applies to the same pair
INT8_ORACLE_TOL = 5e-2
#: the int8 twin's replies to requests of 1, 3 and 16 rows on the rows
#: they share, probabilities: each row is computed alone, but each bucket
#: runs its products at its own row count, whose summation order may
#: differ, and an f32 sum that moves across a bf16 rounding midpoint
#: moves a logit by ~2e-4 (phase 15's DECODE_LOGIT_TOL note); the bound
#: leaves room for a few such flips, 50 times under a mixed or padded row
INT8_ROWS_TOL = 1e-3


def perturbed(params: dict, seed: int) -> dict:
    """A second weight set for the swaps: each tensor plus gaussian
    noise of 5 % of its spread, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(0.0, 0.05 * float(v.std()) + 1e-3,
                               v.shape)).astype(np.float32)
            for k, v in params.items()}


def oracle_rows(x):
    """Request rows as the engine stages them (bf16), as f32 numpy: what
    the shadow audit gives its oracle."""
    import torch
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def swap_under_load(eng, path_a: str, path_b: str, x, card: str) -> None:
    """``SWAPS`` swaps between the two bundles while a thread sends
    requests of 3 rows one after another: every reply is one weight
    set's graphed reply bit for bit, and no bucket is captured again."""
    import threading
    import numpy as np
    x3 = x[:3]
    ref_a = eng(x3, timeout=300)
    eng.swap_weights(path_b)
    ref_b = eng(x3, timeout=300)
    eng.swap_weights(path_a)
    if np.array_equal(ref_a, ref_b):
        raise AssertionError("serve_graphs: the two weight sets reply "
                             "alike; the swap check would see nothing")
    replies, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            replies.append(eng(x3, timeout=300))

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for i in range(SWAPS):
            eng.swap_weights(path_b if i % 2 == 0 else path_a)
            # let the submitter through between two swaps
            n = len(replies)
            while len(replies) == n and t.is_alive():
                time.sleep(0.001)
    finally:
        stop.set()
        t.join(300)
    seen = {"a": 0, "b": 0}
    for i, y in enumerate(replies):
        if np.array_equal(y, ref_a):
            seen["a"] += 1
        elif np.array_equal(y, ref_b):
            seen["b"] += 1
        else:
            raise AssertionError(f"serve_graphs: reply {i} under swaps is "
                                 f"neither weight set's, bit for bit "
                                 f"(max dev {np.abs(y - ref_a).min():.3g})")
    pauses, stages = eng.swap_pauses_ms(), eng.swap_stages_ms()
    say(f"  {SWAPS} swaps under load ({len(replies)} replies of 3 rows "
        f"meanwhile: {seen['a']} the first weight set's, {seen['b']} the "
        f"second's, bit for bit, never a mix) on {card}: publish pause "
        f"(one device-to-device copy of "
        f"{eng.model.resident_weight_bytes() / 2 ** 20:.1f} MiB, waited "
        f"for) min / median / max {min(pauses):.3f} / "
        f"{sorted(pauses)[len(pauses) // 2]:.3f} / {max(pauses):.3f} ms, "
        f"staging (validate, upload on a side stream, off the dispatch "
        f"path) {min(stages):.2f} / {sorted(stages)[len(stages) // 2]:.2f}"
        f" / {max(stages):.2f} ms")
    if not seen["a"] or not seen["b"]:
        raise AssertionError(f"serve_graphs: the replies under swaps saw "
                             f"one weight set only: {seen}")
    expect_ladder_captures(eng, "serve_graphs under swaps")


def capture_race_and_rebinding(manifest: dict, params_a: dict,
                               params_b: dict, x) -> None:
    """A bucket above the warmed ladder captured lazily while another
    thread stages a swap's weights (thread-local capture mode); then a
    swap that rebinds a parameter instead of copying into it, which the
    next replay must refuse."""
    import threading
    import numpy as np
    import torch
    from znicz_tpu_torch.export import ExportedModel
    model = ExportedModel(manifest, params_a, max_batch=2)
    model.warmup(2)
    staged, capturing, stop = [], threading.Event(), threading.Event()

    def stage():
        capturing.wait(60)
        while not stop.is_set():
            staged.append(model.stage_weights(params_b, manifest))

    t = threading.Thread(target=stage)
    t.start()
    try:
        capturing.set()
        while not staged:
            time.sleep(0.001)
        before = len(staged)
        warm = model(x[:4])  # bucket 4: captured here, the warm-up's reply
        during = len(staged) - before
    finally:
        stop.set()
        t.join(300)
    replay = model(x[:4])
    # the ladder's cap (two programs) evicted bucket 1 for bucket 4
    if model.captures != 2 or list(model._programs) != [2, 4] \
            or not np.array_equal(warm, replay):
        raise AssertionError(f"serve_graphs: the lazily captured bucket "
                             f"({model.captures} captures) replays "
                             f"{np.abs(warm - replay).max():.3g} off its "
                             f"warm-up")
    say(f"  bucket 4 captured above a ladder of 2 while another thread "
        f"staged the swap {during} time(s) (thread-local capture): its "
        f"replay bit-equal to the capture's warm-up reply; bucket 1, the "
        f"least recently used, evicted by the ladder's cap")
    unit = model.forwards[2]
    unit.load_params({"weights": torch.from_numpy(params_b["layer2_weights"]),
                      "bias": torch.from_numpy(params_b["layer2_bias"])})
    try:
        model(x[:2])
    except RuntimeError as exc:
        if "rebound" not in str(exc):
            raise
        say(f"  planted: a swap that rebinds the head's weights instead of "
            f"copying into them — caught by the next replay ({exc})")
    else:
        raise AssertionError("serve_graphs: a rebound parameter was not "
                             "caught by the replay")


#: the clean shadow audit's batches, by rows: one batch of one row, as
#: the numpy oracle takes ~6.5 s a row of the scorer on the card's host
#: (the planted arm's every-batch audits after it take 2 more batches)
AUDIT_CLEAN_ROWS = (1,)


def audit_checks(eng, manifest: dict, x, card: str) -> None:
    """The sampled SDC shadow audit on the graphed engine: at rate 1 a
    clean run audits every batch with no mismatch; a planted
    ``sdc.serving_bitflip`` is corrected from the oracle, marks the
    engine suspect and calls the hook once."""
    import numpy as np
    from znicz_tpu_torch.export import ExportedModel
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.utils.config import root
    eng.shadow_audit_rate = 1.0
    stats0 = dict(eng._audit_stats)
    t0 = eng._audit_seconds
    for n in AUDIT_CLEAN_ROWS:
        eng(x[:n], timeout=300)
    sdc = eng.stats()["resilience"]["sdc"]
    audited = sdc["audited"] - stats0["audited"]
    per_batch = 1e3 * (eng._audit_seconds - t0) / max(audited, 1)
    say(f"  shadow audit at rate 1, clean: {audited} of "
        f"{len(AUDIT_CLEAN_ROWS)} batch(es) of {AUDIT_CLEAN_ROWS} rows "
        f"audited on the numpy oracle, {sdc['mismatched']} mismatched (rtol "
        f"{eng.sdc_audit_rtol}), host time {per_batch:.1f} ms a batch on "
        f"{card}'s host")
    if audited != len(AUDIT_CLEAN_ROWS) \
            or sdc["mismatched"] != stats0["mismatched"]:
        raise AssertionError(f"serve_graphs: the clean audit {sdc}")
    hooked = []
    eng.on_sdc_suspect = hooked.append
    detected = metrics.sdc_detected("serving").value
    root.common.engine.faults = {
        "sdc.serving_bitflip": {"at": [1], "factor": 64.0}}
    try:
        # one row a request: each row costs the full-width oracle ~6 s
        got = eng(x[:1], timeout=300)
        again = eng(x[:1], timeout=300)
    finally:
        root.common.engine.faults = None
    oracle = ExportedModel(manifest, eng.current_bundle()[1],
                           device="numpy")
    want = oracle(oracle_rows(x[:1]))
    sdc = eng.stats()["resilience"]["sdc"]
    say(f"  planted sdc.serving_bitflip (column 0 × 64): reply corrected "
        f"from the oracle (bit-equal {np.array_equal(got, want)}), suspect "
        f"{sdc['suspect']}, hook calls {len(hooked)}, then every batch "
        f"audited ({sdc['audited'] - stats0['audited']} audits in all, "
        f"{sdc['mismatched'] - stats0['mismatched']} mismatched)")
    if not np.array_equal(got, want) or not eng.sdc_suspect \
            or hooked != [eng] or sdc["mismatched"] \
            != stats0["mismatched"] + 1 \
            or metrics.sdc_detected("serving").value != detected + 1 \
            or not np.isfinite(again).all():
        raise AssertionError(f"serve_graphs: the planted bitflip {sdc}")


def fault_site_checks(eng, x) -> None:
    """``serving.program_error`` retried to success and
    ``serving.latency_spike`` expiring a deadlined request queued behind
    it, whose rows never reach a graph, each counted on
    ``znicz_faults_injected_total``."""
    import numpy as np
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.ops import fused_kernels as fk
    from znicz_tpu_torch.serving import DeadlineExceeded
    from znicz_tpu_torch.utils.config import root
    injected = {site: metrics.faults_injected(site).value
                for site in ("serving.program_error",
                             "serving.latency_spike")}
    retried = eng.stats()["resilience"]["retried"]
    root.common.engine.faults = {"serving.program_error": {"at": [1]}}
    try:
        y = eng(x[:2], timeout=300)
    finally:
        root.common.engine.faults = None
    if eng.stats()["resilience"]["retried"] != retried + 1 \
            or not np.isfinite(y).all():
        raise AssertionError("serve_graphs: serving.program_error was not "
                             "retried to success")
    rows0 = sum(b["rows"] for b in eng.stats()["buckets"].values())
    root.common.engine.faults = {
        "serving.latency_spike": {"at": [1], "ms": 300}}
    try:
        # B4 launches once a replay of the scorer's graph
        ran0 = fk.softmax_argmax.launches
        slow = eng.submit(x[:2])
        while eng._batcher.queue_rows:  # taken into the spiked dispatch
            time.sleep(0.0005)
        doomed = eng.submit(x[2:5], deadline_ms=60)
        try:
            doomed.result(timeout=300)
        except DeadlineExceeded:
            pass
        else:
            raise AssertionError("serve_graphs: the deadlined request "
                                 "behind the spike was served")
        slow.result(timeout=300)
        ran = fk.softmax_argmax.launches - ran0
    finally:
        root.common.engine.faults = None
    rows = sum(b["rows"] for b in eng.stats()["buckets"].values()) - rows0
    fired = {site: metrics.faults_injected(site).value - n
             for site, n in injected.items()}
    say(f"  serving.program_error retried to success; "
        f"serving.latency_spike (300 ms): the 60 ms-deadlined request "
        f"behind it expired, rows dispatched meanwhile {rows}, graph "
        f"replays {ran}; znicz_faults_injected_total by site {fired}")
    if rows != 2 or ran != 1 or fired != {"serving.program_error": 1,
                                          "serving.latency_spike": 1}:
        raise AssertionError("serve_graphs: the fault sites")


def trace_checks(mark: int, served: int) -> None:
    """Every request served since ``mark`` has a trace whose root span
    closed ``ok`` with its queue and dispatch (``decode``) phases."""
    from znicz_tpu_torch.observe.tracing import TRACER
    events = TRACER.to_chrome_trace(mark)["traceEvents"]
    phases: dict = {}
    roots = []
    for ev in events:
        if ev.get("cat") != "request" or ev.get("ph") != "X":
            continue
        args = ev["args"]
        if args.get("parent_span_id") == 0:
            roots.append(args)
        elif "phase" in args:
            phases.setdefault(args["trace_id"], set()).add(args["phase"])
    ok = [r for r in roots if r["outcome"] == "ok"]
    bad = [r["trace_id"] for r in ok
           if phases.get(r["trace_id"]) != {"queue", "decode"}]
    outcomes = {}
    for r in roots:
        outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
    say(f"  request traces: {len(roots)} closed ({outcomes}), "
        f"{len(ok) - len(bad)} of the {served} served with their queue and "
        f"dispatch phases")
    if len(ok) != served or bad:
        raise AssertionError(f"serve_graphs: {served} served, {len(ok)} "
                             f"traces ok, {len(bad)} without their phases")


def serve_graphs_pass(card: str) -> dict:
    """Phase 14 on the full-width bf16 scorer of phase 3, through
    ``ServingEngine(max_batch=16)`` with every bucket a CUDA graph."""
    import numpy as np
    from znicz_tpu_torch.export import (ExportedModel, SwapIncompatible,
                                        read_bundle)
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.observe.recorder import (FlightRecorder,
                                                  set_recorder)
    from znicz_tpu_torch.observe.tracing import TRACER
    from znicz_tpu_torch.ops import flash_attention as fa
    from znicz_tpu_torch.ops import fused_kernels as fk
    from znicz_tpu_torch.serving import ServingEngine
    from znicz_tpu_torch.serving import quantize as qz
    from znicz_tpu_torch.utils.config import root
    kernels = (fa.flash_attention_fwd, fk.layer_norm_forward,
               fk.softmax_argmax)
    rng = np.random.default_rng(SEED + 14)
    x = rng.normal(0.0, 0.3, size=(BATCH, SEQ, DIM)).astype(np.float32)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path_a = os.path.join(tmp, "scorer.npz")
        write_scorer_bundle(path_a)
        manifest, params_a = read_bundle(path_a)
        params_b = perturbed(params_a, SEED + 15)
        path_b = write_bundle(os.path.join(tmp, "scorer_b.npz"), manifest,
                              params_b)
        rec = FlightRecorder(os.path.join(tmp, "journal"))
        set_recorder(rec)
        reset_counts()
        eng = ServingEngine(path_a, max_batch=BATCH, max_delay_ms=2.0,
                            retry_budget=1)
        try:
            eng.start()
            mark = TRACER.mark()
            served0 = eng.requests_served
            expect_ladder_captures(eng, "serve_graphs")
            graphed = graphed_dispatches(eng, x, kernels, "serve_graphs")
            set_serve_graphs(False)
            try:
                eager = {n: eng(x[:n], timeout=300) for n in graphed}
            finally:
                set_serve_graphs(True)
            dev = {n: float(np.abs(graphed[n] - eager[n]).max())
                   for n in graphed}
            say(f"  graphed replies against eager ones of the same engine: "
                f"max |Δ| by rows {dev}, bit-equal "
                f"{all(np.array_equal(graphed[n], eager[n]) for n in graphed)}"
                f" (tol {SERVE_GRAPH_TOL})")
            if max(dev.values()) > SERVE_GRAPH_TOL:
                raise AssertionError("serve_graphs: graphed replies off the "
                                     "eager ones")
            expect_ladder_captures(eng, "serve_graphs")
            swap_under_load(eng, path_a, path_b, x, card)
            before = eng(x[:3], timeout=300)
            for bad, why in (({"layer0_weights": np.zeros((2, 2),
                                                          np.float32)},
                              "shape"),
                             ((dict(manifest, dtype="float32"), params_a),
                              "dtype")):
                try:
                    eng.swap_weights(bad)
                except SwapIncompatible as exc:
                    if why not in str(exc):
                        raise
                else:
                    raise AssertionError(f"serve_graphs: a candidate of "
                                         f"the wrong {why} was taken")
            if not np.array_equal(eng(x[:3], timeout=300), before):
                raise AssertionError("serve_graphs: a refused candidate "
                                     "changed the replies")
            say("  SwapIncompatible candidates (a wrong shape, a wrong "
                "dtype) refused, the replies bit-identical after")
            swaps = rec.dump_since(0, kinds=["swap"])
            want_swaps = eng.swap_counts["promoted"]
            dropped = metrics.flightrecord_dropped().value
            root.common.engine.faults = {
                "observe.recorder_stall": {"at": [1]}}
            try:
                eng.swap_weights(path_a)
            finally:
                root.common.engine.faults = None
            after = rec.dump_since(0, kinds=["swap"])
            say(f"  flight recorder: {len(swaps)} swaps journaled of "
                f"{want_swaps}; under observe.recorder_stall the next "
                f"swap went through and its event was dropped (journal "
                f"{len(after)}, dropped "
                f"{metrics.flightrecord_dropped().value - dropped:.0f})")
            if len(swaps) != want_swaps or len(after) != len(swaps) \
                    or metrics.flightrecord_dropped().value != dropped + 1:
                raise AssertionError("serve_graphs: the journal")
            capture_race_and_rebinding(manifest, params_a, params_b, x)
            fault_site_checks(eng, x)
            trace_checks(mark, eng.requests_served - served0)
            audit_checks(eng, manifest, x, card)
            expect_ladder_captures(eng, "serve_graphs")
            out["serve_graphs"] = read_counts()
        finally:
            eng.shutdown()
            set_recorder(None)
            root.common.engine.faults = None

        qman, qparams, info = qz.quantize_bundle(manifest, params_a)
        path_q = write_bundle(os.path.join(tmp, "scorer_int8.npz"), qman,
                              qparams)
        reset_counts()
        eng = ServingEngine(path_q, max_batch=BATCH, max_delay_ms=2.0)
        try:
            eng.start()
            expect_ladder_captures(eng, "serve_int8")
            replies = graphed_dispatches(eng, x, kernels, "serve_int8")
            resident = eng.model.resident_weight_bytes()
            expect_ladder_captures(eng, "serve_int8")
            out["serve_int8"] = read_counts()
        finally:
            eng.shutdown()
        f32 = ExportedModel(manifest, params_a, device="cpu")
        oracle = ExportedModel(qman, qparams, device="numpy")
        # the 1-row reply: a row costs the full-width oracle ~6 s
        want = oracle(oracle_rows(x[:1]))
    err = float(np.abs(replies[1] - want).max())
    same = bool((replies[1].argmax(1) == want.argmax(1)).all())
    # the batched buckets on the rows they share with the 1-row reply,
    # which the oracle holds, and with each other
    shared = {f"{a} vs {b}": float(np.abs(replies[a][:b] - replies[b]).max())
              for a, b in ((3, 1), (16, 1), (16, 3))}
    say(f"  int8 ({', '.join(qman['quant']['weights'])}): bytes_ratio "
        f"{info['bytes_ratio']:.4f} ({info['bytes_quant']} of "
        f"{info['bytes_f32']} B), resident weight bytes on the card "
        f"{resident} (f32 chain {f32.resident_weight_bytes()}); 1-row "
        f"reply vs the int8 numpy oracle max_abs_err {err:.3g} (tol "
        f"{INT8_ORACLE_TOL}), argmax agree={same}; the 3- and 16-row "
        f"replies on their shared rows, max |Δ| {shared} (tol "
        f"{INT8_ROWS_TOL})")
    if err > INT8_ORACLE_TOL or not same or resident != info["bytes_quant"]:
        raise AssertionError("serve_int8: the int8 replies disagree with "
                             "the oracle")
    if max(shared.values()) > INT8_ROWS_TOL:
        raise AssertionError(f"serve_int8: the batched buckets disagree "
                             f"on shared rows: {shared}")
    return out


# ----------------------------------------------------------------------
# phase 15: decode — the KV caches flat and paged, prefix sharing,
# continuous token batching, speculative decoding, int8 pages and int8
# weights, hot swap; each decode program a CUDA graph
# ----------------------------------------------------------------------
#: the byte LM of phase 10 without its layer norm (the decoder takes no
#: layer_norm), trained at DEC_TRAIN_T until the validation error is
#: under DEC_ERR_BAR % or DEC_STEP_CAP steps (train and validation
#: minibatches); the drafter the same chain at DRAFT_DIM, 2 heads; both
#: bf16, as phase 10.  Phase 10's rate (0.01) leaves the task at chance
#: for 3000 steps; 0.05 (half on the attention) reaches 2 % in ~1400
DEC_GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
DEC_GD_ATTENTION = dict(DEC_GD, learning_rate=0.025)
DECODE_LAYERS = tuple(
    dict(spec, **{"<-": DEC_GD_ATTENTION if spec["type"] == "attention"
                  else DEC_GD}) if "<-" in spec else spec
    for spec in LM_LAYERS if spec["type"] != "layer_norm")
DEC_TRAIN_T, DEC_TRAIN, DEC_VALID, DEC_BATCH = 64, 1024, 256, 64
DEC_STEP_CAP, DEC_ERR_BAR = 3000, 5.0
DRAFT_DIM, DRAFT_HEADS = 128, 2
#: the decode geometry: 16 lanes, sequences to 2048 tokens, 16-token
#: pages, prompts to 1024 in steps of 64; the pool at its default, the
#: flat arm's bytes (max_slots · max_t tokens)
DECODE_GEOMETRY = {"max_slots": 16, "max_t": 2048, "max_prompt": 1024,
                   "prompt_align": 64, "page_tokens": 16}
#: the LSTM chain decodes prompts to its phase-10 length
LSTM_DECODE_GEOMETRY = dict(DECODE_GEOMETRY, max_prompt=LSTM_SEQ)
#: the planted faults' engines: small, as only their behavior is checked
PLANT_GEOMETRY = {"max_slots": 2, "max_t": 256, "max_prompt": 128,
                  "prompt_align": 64, "page_tokens": 16}
SPEC_K = 3
#: the card's first-token logits against the CPU's: f32 on both sides,
#: TF32 off, so the products differ in summation order only (~1e-6
#: relative); but the bf16 head rounds its f32 features to bf16, and a
#: feature within that difference of a rounding midpoint rounds the
#: other way on one side (rare: ~1e-4 of the features), moving a logit
#: by |w|·2⁻⁸·|x|, ~2e-4: the bound leaves a margin of five over one
#: such flip
DECODE_LOGIT_TOL = 1e-3
#: two greedy sequences may part only where the CPU's top two logits
#: are closer than the two sides' logits can differ
TIE_TOL = 2 * DECODE_LOGIT_TOL
#: graphed against eager on the card: the same kernels on the same
#: inputs in the same order, no atomics, so the same bits
DECODE_GRAPH_TOL = 0.0
#: the ragged mix: prompts of 1–1024 tokens (system prompts shared), a
#: budget of 16–256 new tokens each; the throughput arms' batch
MIX_PROMPTS, MIX_NEW = 32, (16, 256)
TPUT_PROMPT, TPUT_NEW = 256, 128
#: the prompts held to the CPU engine, and their new tokens
CPU_LENGTHS = (1, 17, 64, 130, 300, 511, 777, 1024)
LSTM_CPU_LENGTHS = (1, 9, 64, 100, 200, 256)
CPU_NEW = 24
#: the prefix arm's prompts: a system prompt with tails, and two that
#: part from it mid-page (copy on write)
PREFIX_SYSTEM, PREFIX_TAILS = 300, (1, 5, 40, 200)
_DECODE_GRAPHED: list = []


#: files a later phase reuses (phase 15's decode LM for phase 19), in
#: :func:`keep_dir`
KEPT: dict = {}


def keep_dir() -> str:
    """A directory that lives as long as this process."""
    if "dir" not in KEPT:
        KEPT["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
        atexit.register(shutil.rmtree, KEPT["dir"], True)
    return KEPT["dir"]


def set_decode_graphs(on: bool) -> None:
    """Every decode program a CUDA graph (``DecodeModel.graphed``, the
    port's way on the card) or, off, its body run eagerly on the card:
    the eager engine phase 15 holds the graphed one to."""
    from znicz_tpu_torch.serving.decode import DecodeModel
    if not _DECODE_GRAPHED:
        _DECODE_GRAPHED.append(DecodeModel.graphed)
    DecodeModel.graphed = _DECODE_GRAPHED[0] if on \
        else property(lambda self: False)


def train_decode_lm(path: str, layers, seed: int, cap: int,
                    bar: float | None) -> tuple:
    """A token chain trained bf16 and graphed through the port's
    ``StandardWorkflow`` on the reference's next-token rule at
    T = DEC_TRAIN_T, stepped until the validation error is under
    ``bar`` % or ``cap`` steps, then exported.  Returns (steps, best
    validation error %, whether the bar was met)."""
    x, y = lm_data(DEC_TRAIN + DEC_VALID, DEC_TRAIN_T, seed)
    wf = make_lm(x, y, DEC_TRAIN, DEC_BATCH, layers=layers)
    steps = 0
    met = False
    while steps < cap:
        wf.step()
        steps += 1
        best = wf.decision.min_validation_n_err_pt
        if bar is not None and wf.decision.epoch_ended and best < bar:
            met = True
            break
    wf.export_forward(path)
    best = wf.decision.min_validation_n_err_pt
    del wf
    return steps, best, met


def narrowed(layers, dim: int, heads: int):
    out = []
    for spec in layers:
        spec = copy.deepcopy(spec)
        if spec["type"] == "embedding":
            spec["->"]["dim"] = dim
        if spec["type"] == "attention":
            spec["->"]["n_heads"] = heads
        out.append(spec)
    return tuple(out)


def decode_engine(path: str, geometry=DECODE_GEOMETRY, device=None,
                  **kwargs):
    from znicz_tpu_torch.serving import DecodeEngine
    return DecodeEngine(path, device=device, **{**geometry, **kwargs})


def generate_all(eng, prompts, n_new) -> list:
    """Every prompt submitted at once (continuous admission); the
    generated ids."""
    budgets = n_new if isinstance(n_new, list) else [n_new] * len(prompts)
    futs = [eng.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    return [[int(t) for t in f.result(timeout=600)] for f in futs]


def recording(eng) -> list:
    """The logits each of ``eng``'s samples reads, in order."""
    import numpy as np
    rec: list = []
    real = eng._sample

    def sample(logits):
        rec.append(np.array(logits, copy=True))
        return real(logits)

    eng._sample = sample
    return rec


def cpu_margin(path: str, prompt, prefix, geometry, kwargs) -> float:
    """The CPU's top-two logit margin where it sampled the token after
    ``prompt + prefix``: a one-request CPU engine of the arm's paging
    (no speculation: a verify window computes the same logits) replays
    it."""
    import numpy as np
    kw = {k: v for k, v in kwargs.items()
          if k not in ("spec_draft_k", "drafter")}
    with decode_engine(path, geometry, device="cpu", **kw) as eng:
        rec = recording(eng)
        eng.generate(prompt, max_new_tokens=len(prefix) + 1, timeout=600)
    top = np.sort(rec[len(prefix)])[-2:]
    return float(top[1] - top[0])


def tokens_vs_cpu(label: str, path: str, gpu, prompts, n_new, geometry,
                  kwargs) -> int:
    """The card's greedy tokens (engine ``gpu``) against the CPU engine's
    of the same arm on the same bundle and prompts.  Where two sequences
    part, the CPU's top-two margin there must be under ``TIE_TOL``;
    returns how many sequences parted at such a tie."""
    t0 = time.perf_counter()
    got = generate_all(gpu, prompts, n_new)
    with decode_engine(path, geometry, device="cpu", **kwargs) as cpu:
        want = generate_all(cpu, prompts, n_new)
    ties = 0
    for p, g, w in zip(prompts, got, want):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        margin = cpu_margin(path, p, w[:i], geometry, kwargs)
        say(f"  {label}: a {len(p)}-token prompt parts from the CPU's at "
            f"token {i} ({g[i:i + 3]} against {w[i:i + 3]}), the CPU's "
            f"top-two margin there {margin:.3g} (tie bound {TIE_TOL})")
        if margin >= TIE_TOL:
            raise AssertionError(f"{label}: greedy tokens differ from the "
                                 f"CPU's with a margin of {margin}")
        ties += 1
    say(f"  {label}: {len(prompts)} prompts × {n_new} tokens, card = CPU "
        f"on {len(prompts) - ties}, {ties} ended at a tie "
        f"({time.perf_counter() - t0:.1f} s)")
    return ties


def expect_decode_captures(eng, label: str) -> int:
    """After ``start()``: each program resident is one captured graph."""
    st = eng.stats()
    say(f"  {label}: {st['programs_live']} programs resident, "
        f"{st['captures']} captured in {st['warmup_seconds']:.2f} s "
        f"(warmup), cache {st['cache_bytes']} B, "
        f"{st['kv_bytes_per_lane']} B a lane")
    if not (st["captures"] == st["programs_live"] == eng.warmup_compiles
            > 0):
        raise AssertionError(f"{label}: captures {st['captures']}, "
                             f"programs {st['programs_live']}")
    return st["captures"]


def capture_metric() -> float:
    from znicz_tpu_torch.observe import metrics
    return sum(metrics.graph_captures(site).value for site in
               ("serving-prefill", "serving-decode", "serving-verify",
                "serving-page"))


def ragged_prompts(rng, n: int, systems) -> tuple[list, list]:
    """``n`` prompts of 1–1024 tokens, half of them a shared system
    prompt plus a tail, the others runs of the training rule (each id the
    last plus 1), and their budgets of 16–256 new tokens."""
    import numpy as np
    prompts = []
    for i in range(n):
        if i % 2:
            system = systems[i % len(systems)]
            tail = rng.integers(0, LM_VOCAB, size=int(rng.integers(1, 257)))
            p = list(system) + list(tail)
        else:
            start = int(rng.integers(0, LM_VOCAB))
            p = list((start + np.arange(int(rng.integers(1, 1025))))
                     % LM_VOCAB)
        prompts.append([int(t) for t in p[:DECODE_GEOMETRY["max_prompt"]]])
    # the ends of the range
    prompts[0] = prompts[0][:1]
    prompts[2] = [int(t) for t in rng.integers(
        0, LM_VOCAB, size=DECODE_GEOMETRY["max_prompt"])]
    budgets = [int(b) for b in rng.integers(MIX_NEW[0], MIX_NEW[1] + 1,
                                            size=n)]
    budgets[0], budgets[1] = MIX_NEW
    return prompts, budgets


def mix_pass(path: str, drafter: str, params_a: dict, params_b: dict,
             manifest: dict, card: str) -> dict:
    """The paged, prefix-sharing, speculative engine at full geometry:
    its captures at ``start()`` equal its programs and stay flat through
    a ragged mix of MIX_PROMPTS prompts and 3 hot swaps; TTFT and
    per-token p50/p99, the prefix hit rate, the acceptance rate."""
    import numpy as np
    rng = np.random.default_rng(SEED + 20)
    systems = [list(rng.integers(0, LM_VOCAB, size=n))
               for n in (256, 512, 768)]
    prompts, budgets = ragged_prompts(rng, MIX_PROMPTS, systems)
    eng = decode_engine(path, spec_draft_k=SPEC_K, drafter=drafter)
    metric0 = capture_metric()
    eng.start()
    try:
        captures = expect_decode_captures(eng, "paged + prefix + "
                                          "speculative")
        if capture_metric() - metric0 != captures:
            raise AssertionError("the captures series disagrees with "
                                 "the programs captured")
        t0 = time.perf_counter()
        out = generate_all(eng, prompts, budgets)
        wall = time.perf_counter() - t0
        st = eng.stats()
        pc, spec = st["prefix_cache"], st["speculative"]
        hit = pc["hits"] / max(1, pc["hits"] + pc["misses"])
        n_tok = sum(len(o) for o in out)
        say(f"  ragged mix on {card}: {MIX_PROMPTS} prompts of "
            f"{min(map(len, prompts))}–{max(map(len, prompts))} tokens, "
            f"{n_tok} tokens generated in {wall:.2f} s "
            f"({n_tok / wall:.0f} tokens/s); TTFT p50 "
            f"{st['ttft_ms']['p50']} ms, p99 {st['ttft_ms']['p99']} ms; "
            f"per token p50 {st['token_ms']['p50']} ms, p99 "
            f"{st['token_ms']['p99']} ms; prefix hits {pc['hits']} of "
            f"{pc['hits'] + pc['misses']} ({100 * hit:.1f} %), "
            f"{pc['shared_tokens']} prompt tokens shared; drafts accepted "
            f"{spec['accepted']} of {spec['accepted'] + spec['rejected']} "
            f"({100 * spec['accept_rate']:.1f} %)")
        if any(len(o) != b for o, b in zip(out, budgets)):
            raise AssertionError("a sequence stopped short of its budget")
        for k, state in enumerate((params_b, params_a, params_b)):
            res = eng.swap_weights((manifest, state), drain_ms=10_000)
            generate_all(eng, [p[:300] for p in prompts[k::8]], 16)
            say(f"  swap {k + 1}: version {res['version']}, pause "
                f"{res['pause_ms']} ms, captures "
                f"{eng.stats()['captures']}")
        st = eng.stats()
        if st["captures"] != captures \
                or capture_metric() - metric0 != captures \
                or st["swaps"]["promoted"] != 3:
            raise AssertionError(f"captures moved across the mix and the "
                                 f"swaps: {st['captures']} != {captures}")
        return {"ttft": st["ttft_ms"], "token": st["token_ms"],
                "hit_rate": hit, "accept_rate": spec["accept_rate"],
                "captures": captures, "warmup_s": st["warmup_seconds"]}
    finally:
        eng.shutdown()


def throughput(eng, prompts) -> float:
    t0 = time.perf_counter()
    n = sum(len(o) for o in generate_all(eng, prompts, TPUT_NEW))
    return n / (time.perf_counter() - t0)


def planted_faults(path: str, manifest: dict, params: dict) -> None:
    """The three faults phase 15 must catch: a cache update that rebinds
    its pool, a swap that leaves the prefix cache stale, a swap that
    rebinds a weight (and a cache rebound at the model) — each on small
    engines."""
    import numpy as np
    import torch
    from znicz_tpu_torch.ops.attention import MultiHeadAttention
    from znicz_tpu_torch.serving.decode import DecodeEngine, DecodeModel

    def rebinding(pool, rows, tables, positions, live):
        ptok, nb = pool.shape[1], tables.shape[1] - 1
        block = torch.div(positions.long(), ptok, rounding_mode="floor")
        page = torch.gather(tables.long(), 1, block.clamp(max=nb))
        return pool.index_put((page, positions.long() % ptok),
                              rows.to(pool.dtype))

    real = MultiHeadAttention.__dict__["_paged_write"]
    MultiHeadAttention._paged_write = staticmethod(rebinding)
    try:
        DecodeModel(path, paged=True, **PLANT_GEOMETRY).warmup()
        caught = None
    except RuntimeError as exc:
        caught = str(exc)
    finally:
        MultiHeadAttention._paged_write = real
    say(f"  planted: a paged write that rebinds its pool → {caught}")
    if caught is None or "rebound by its update" not in caught:
        raise AssertionError("a cache update that rebinds was not caught")
    # the new weights: the attention's key and value projections redrawn
    # (the trained chain reads mostly the last position's own value, so
    # only stale keys and values of the prefix show in its tokens)
    rng = np.random.default_rng(SEED + 21)
    far = dict(params)
    w, b = params["layer2_weights"], params["layer2_bias"]
    far["layer2_weights"] = np.concatenate(
        [w[:, :DIM], rng.normal(0.0, float(w.std()), (DIM, 2 * DIM))],
        axis=1).astype(np.float32)
    far["layer2_bias"] = np.concatenate(
        [b[:DIM], rng.normal(0.0, float(b.std()) + 1e-3, 2 * DIM)]
    ).astype(np.float32)
    shared = [int(t) for t in rng.integers(0, LM_VOCAB, size=96)]
    prompt = shared + [5, 7, 9]
    with decode_engine(path, PLANT_GEOMETRY) as fresh:
        fresh.swap_weights((manifest, far))
        want = [int(t) for t in fresh.generate(prompt, max_new_tokens=32)]
    got = {}
    real_clear = DecodeEngine._clear_prefix
    for planted in (False, True):
        if planted:
            DecodeEngine._clear_prefix = lambda self: None
        try:
            with decode_engine(path, PLANT_GEOMETRY) as eng:
                eng.generate(shared, max_new_tokens=4)
                eng.swap_weights((manifest, far), drain_ms=10_000)
                got[planted] = [int(t) for t in eng.generate(
                    prompt, max_new_tokens=32)]
                hits = eng.stats()["prefix_cache"]["hits"]
        finally:
            DecodeEngine._clear_prefix = real_clear
        say(f"  {'planted' if planted else 'sound'} swap: prefix hits "
            f"after it {hits}, tokens equal a fresh engine's on the new "
            f"weights {got[planted] == want}")
    if got[False] != want or got[True] == want:
        raise AssertionError("a swap that leaves the prefix cache stale "
                             "was not caught")
    model = DecodeModel(path, paged=False, **PLANT_GEOMETRY)
    model.warmup()
    model.run_prefill(np.array([1, 2, 3]), 0)
    step = (np.array([4]), np.array([0]), np.array([3]))
    model.run_decode(*step)
    for what in ("weight", "cache"):
        if what == "weight":
            # a swap that binds a new tensor in place of copying into it
            ws = list(model._weights)
            ws[2] = (torch.from_numpy(far["layer2_weights"]).cuda(),) \
                + ws[2][1:]
            model._weights = tuple(ws)
        else:
            model.cache.arrays[0] = model.cache.arrays[0].clone()
        try:
            model.run_decode(*step)
            caught = None
        except RuntimeError as exc:
            caught = str(exc)
        say(f"  planted: a {what} rebound → {caught}")
        if caught is None or "rebound after the capture" not in caught:
            raise AssertionError(f"a rebound {what} was not refused")
        model = DecodeModel(path, paged=False, **PLANT_GEOMETRY)
        model.warmup()


def decode_pass(card: str) -> dict:
    """Phase 15: train the decode LM and its drafter, write the int8 twin
    and the LSTM chain, then drive decode through ``DecodeEngine`` on the
    card with every launch counter at 0 (decode runs none of B1–B9)."""
    import numpy as np
    import torch
    from znicz_tpu_torch.export import read_bundle
    from znicz_tpu_torch.serving import quantize as qz
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decode_lm.npz")
        drafter = os.path.join(tmp, "drafter.npz")
        lstm = os.path.join(tmp, "lstm.npz")
        t0 = time.perf_counter()
        steps, best, met = train_decode_lm(path, DECODE_LAYERS, SEED + 16,
                                           DEC_STEP_CAP, DEC_ERR_BAR)
        KEPT["decode_lm"] = shutil.copy(path, keep_dir())
        say(f"  the decode LM (V={LM_VOCAB}, D={DIM}, {HEADS} causal heads, "
            f"no layer norm, bf16, T={DEC_TRAIN_T}, B={DEC_BATCH}) graphed: "
            f"{steps} steps, best validation error {best:.2f} % — "
            + (f"under {DEC_ERR_BAR} %" if met else
               f"the step cap ({DEC_STEP_CAP}) reached first"))
        d_steps, d_best, d_met = train_decode_lm(
            drafter, narrowed(DECODE_LAYERS, DRAFT_DIM, DRAFT_HEADS),
            SEED + 17, DEC_STEP_CAP, DEC_ERR_BAR)
        say(f"  the drafter (D={DRAFT_DIM}, {DRAFT_HEADS} heads): {d_steps} "
            f"steps, best validation error {d_best:.2f} % — "
            + (f"under {DEC_ERR_BAR} %" if d_met else "the step cap first"))
        x, y = lm_data(4 * BATCH, 64, SEED + 18)
        wf = make_lm(x, y, 4 * BATCH, BATCH, layers=LSTM_LAYERS)
        wf.export_forward(lstm)  # its weights the seed's
        KEPT["lstm"] = shutil.copy(lstm, keep_dir())
        del wf
        manifest, params = read_bundle(path)
        qman, qparams, info = qz.quantize_bundle(manifest, params)
        int8 = write_bundle(os.path.join(tmp, "decode_lm_int8.npz"), qman,
                            qparams)
        say(f"  set-up (training, exports, the int8 twin: bytes_ratio "
            f"{info['bytes_ratio']:.4f}) {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        out = {"mix": mix_pass(path, drafter, params,
                               perturbed(params, SEED + 19), manifest, card)}
        rng = np.random.default_rng(SEED + 22)
        cpu_prompts = [[int(t) for t in rng.integers(0, LM_VOCAB, size=n)]
                       for n in CPU_LENGTHS]
        system = [int(t) for t in rng.integers(0, LM_VOCAB,
                                               size=PREFIX_SYSTEM)]
        half = PREFIX_SYSTEM // 2
        prefix_prompts = [system + [int(t) for t in rng.integers(
            0, LM_VOCAB, size=n)] for n in PREFIX_TAILS] \
            + [system[:half] + [1, 2, 3], system[:half + 7] + [9] * 30]
        tput_prompts = [[int(t) for t in rng.integers(
            0, LM_VOCAB, size=TPUT_PROMPT)] for _ in range(16)]
        unshared = {"prefix_cache": False}
        arms = {
            "flat": ({"paged": False}, cpu_prompts),
            "paged": (unshared, cpu_prompts),
            "paged + prefix sharing": ({}, prefix_prompts),
            "paged + speculative": (dict(unshared, spec_draft_k=SPEC_K,
                                         drafter=drafter), cpu_prompts),
            "paged, self-drafted": (dict(unshared, spec_draft_k=SPEC_K,
                                         drafter=path), cpu_prompts[:4]),
            "int8 KV pages": (dict(unshared, kv_quant=True), cpu_prompts),
        }
        ties, engines, stats = {}, {}, {}
        for label, (kw, prompts) in arms.items():
            eng = engines[label] = decode_engine(path, **kw)
            eng.start()
            expect_decode_captures(eng, label)
            ties[label] = tokens_vs_cpu(label, path, eng, prompts, CPU_NEW,
                                        DECODE_GEOMETRY, kw)
            stats[label] = eng.stats()
        # the drafter on the runs it was trained on (positions < T = 64)
        spec_eng = engines["paged + speculative"]
        before = stats["paged + speculative"]["speculative"]
        rule_runs = [[int(t) for t in (int(rng.integers(0, LM_VOCAB))
                                       + np.arange(32)) % LM_VOCAB]
                     for _ in range(16)]
        generate_all(spec_eng, rule_runs, 24)
        after = spec_eng.stats()["speculative"]
        acc = after["accepted"] - before["accepted"]
        drafted = acc + after["rejected"] - before["rejected"]
        say(f"  the drafter on 16 runs of the training rule (32 tokens, 24 "
            f"new): {acc} of {drafted} drafts accepted "
            f"({100 * acc / max(1, drafted):.1f} %)")
        KEPT["draft_accept"] = (acc, drafted)  # phase 22's yardstick
        self_spec = stats["paged, self-drafted"]["speculative"]
        say(f"  self-drafted: {self_spec['accepted']} of "
            f"{self_spec['accepted'] + self_spec['rejected']} drafts "
            f"accepted")
        if self_spec["rejected"] or not self_spec["accepted"]:
            raise AssertionError("the bundle as its own drafter had a "
                                 "draft rejected")
        tput = {k: [] for k in ("flat", "paged", "paged + speculative")}
        for label in list(tput) + list(tput)[::-1]:
            tput[label].append(throughput(engines[label], tput_prompts))
        kv = {"f32": stats["paged"]["kv_bytes_per_lane"],
              "int8": stats["int8 KV pages"]["kv_bytes_per_lane"],
              "flat": stats["flat"]["kv_bytes_per_lane"]}
        say(f"  tokens/s at 16 lanes ({TPUT_PROMPT}-token prompts, "
            f"{TPUT_NEW} new tokens each, in turns) on {card}: "
            + "; ".join(f"{k} {v[0]:.0f} / {v[1]:.0f}"
                        for k, v in tput.items())
            + f"; KV bytes a lane: flat {kv['flat']}, paged f32 "
            f"{kv['f32']}, int8 {kv['int8']} "
            f"({kv['int8'] / kv['f32']:.4f} of f32)")
        # graphed against eager, one request at a time: the prefix arm
        # graphed, then the same engine eager
        runs = {}
        for mode in ("graphed", "eager"):
            set_decode_graphs(mode == "graphed")
            if mode == "graphed":
                eng = engines["paged + prefix sharing"]
            else:
                eng = decode_engine(path)
                eng.start()
            rec = recording(eng)
            toks = [[int(t) for t in eng.generate(p, max_new_tokens=32)]
                    for p in cpu_prompts[1:5]]
            runs[mode] = (toks, np.stack(rec))
            say(f"  {mode}: {eng.stats()['captures']} captures")
            if mode == "eager":
                eng.shutdown()
        set_decode_graphs(True)
        diff = float(np.abs(runs["graphed"][1] - runs["eager"][1]).max())
        say(f"  graphed against eager (4 prompts × 32 tokens): tokens "
            f"equal {runs['graphed'][0] == runs['eager'][0]}, logits "
            f"max_abs_err {diff:.3g} (tol {DECODE_GRAPH_TOL}: bit-equal)")
        if runs["graphed"][0] != runs["eager"][0] \
                or diff > DECODE_GRAPH_TOL:
            raise AssertionError("decode graphed disagrees with eager")
        # the first-token logits of the flat arm, card against CPU
        from znicz_tpu_torch.serving import DecodeModel
        card_model = engines["flat"].model
        for eng in engines.values():
            eng.shutdown()
        cpu_model = DecodeModel(path, paged=False, device="cpu",
                                **DECODE_GEOMETRY)
        err = max(float(np.abs(card_model.run_prefill(np.array(p), 0)
                               - cpu_model.run_prefill(np.array(p), 0))
                        .max()) for p in cpu_prompts[::2])
        say(f"  first-token logits, card against CPU (flat, prompts of "
            f"{CPU_LENGTHS[::2]}): max_abs_err {err:.3g} (tol "
            f"{DECODE_LOGIT_TOL})")
        if err > DECODE_LOGIT_TOL:
            raise AssertionError("decode logits: the card disagrees with "
                                 "the CPU")
        # int8 weights
        with decode_engine(int8, **unshared) as eng:
            expect_decode_captures(eng, "int8 weights")
            ties["int8 weights"] = tokens_vs_cpu(
                "int8 weights", int8, eng, cpu_prompts, CPU_NEW,
                DECODE_GEOMETRY, unshared)
        # the LSTM chain, flat and paged
        rng = np.random.default_rng(SEED + 23)
        lstm_prompts = [[int(t) for t in rng.integers(0, LM_VOCAB, size=n)]
                        for n in LSTM_CPU_LENGTHS]
        for label, kw in (("LSTM flat", {"paged": False}),
                          ("LSTM paged", {})):
            with decode_engine(lstm, LSTM_DECODE_GEOMETRY, **kw) as eng:
                expect_decode_captures(eng, label)
                ties[label] = tokens_vs_cpu(label, lstm, eng, lstm_prompts,
                                            CPU_NEW, LSTM_DECODE_GEOMETRY,
                                            kw)
        planted_faults(path, manifest, params)
        launches = read_counts()
        expect_counts("decode", launches, {})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"  sequences ended at a tie, by arm: {ties}")
        say(f"  phase 15 on {card}: peak device memory {peak:.2f} GiB; the "
            f"decode drive {time.perf_counter() - t1:.1f} s")
    return launches


# ----------------------------------------------------------------------
# phase 16: parallelism
# ----------------------------------------------------------------------
#: graphed train steps of the world-size-1 NCCL path and of its
#: one-process twin, held to each other (expected bit-equal: a sum over
#: one rank is that rank's value)
DP_STEPS = 6
#: the ring's members, in one process (LocalRing)
RING_MEMBERS = 4
#: the ring against one whole-sequence flash call, and against the same
#: fold on the kernels' plain versions: max|ring − whole| / max|whole| of
#: the output and of each gradient.  bf16: each hop's output and
#: gradients are rounded to bf16 before the f32 combine, where the
#: whole-sequence kernel rounds once (2⁻⁸ relative a rounding, a few
#: roundings deep); f32 as phase 2's f32 tolerances
RING_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the planted fault: a remote hop's key offset one tile (64 rows) off
RING_FAULT_ROWS = 64
PIPE_STAGES, PIPE_MICRO, PIPE_STEPS = 2, 4, 2


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def seq_data(n: int, seed: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(n, SEQ, DIM))
                         .astype(np.float32)).to(torch.bfloat16)
    return x, rng.integers(0, CLASSES, size=n).astype(np.int32)


def params_of(wf) -> dict:
    return {f"{u.name}.{name}": p.detach().float().cpu().clone()
            for u in wf.forwards for name, p in u.named_parameters()}


def params_diff(got: dict, want: dict) -> tuple[float, str, int]:
    """(worst ‖got − want‖ / ‖want‖, its name, tensors bit-equal)."""
    rel = {k: norm_rel(got[k], want[k]) for k in want}
    name = max(rel, key=rel.get)
    return rel[name], name, sum(bool((got[k] == want[k]).all())
                                for k in want)


def nccl_events(prof) -> tuple[int, int]:
    """(NCCL kernels on the card, NCCL ranges on the host) in a profiler
    window."""
    from torch.autograd import DeviceType
    dev = host = 0
    for e in prof.key_averages():
        if "nccl" not in e.key.lower():
            continue
        if e.device_type == DeviceType.CUDA:
            dev += e.count
        else:
            host += e.count
    return dev, host


def dp_nccl_pass(card: str) -> dict:
    """(a) The sequence stack through the launcher's env contract at
    world size 1 on NCCL: ``Launcher()`` reads ``ZNICZ_*``, starts the
    group and gives the card with a (data 1, model 1) mesh; the step's
    gradient fold and the evaluator's sums are all-reduces captured in
    the step's graph.  Held to the one-process graphed step, timed in
    turns beside it, and NCCL shown in a profiler window."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from znicz_tpu_torch.launcher import Launcher
    from znicz_tpu_torch.parallel import distributed
    from znicz_tpu_torch.utils.config import root
    # the device takes the precision mode when it is made
    root.common.precision_type = "bfloat16"
    env = {"ZNICZ_COORDINATOR": f"127.0.0.1:{free_port()}",
           "ZNICZ_NUM_PROCESSES": "1", "ZNICZ_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        launcher = Launcher()
        device = launcher.make_device()
    finally:
        for key in env:
            os.environ.pop(key)
    backend = dist.get_backend(device.group("data"))
    say(f"  Launcher() from ZNICZ_*: mode {launcher.mode}, "
        f"{device!r}, the data group's backend {backend}")
    if launcher.mode != "master" or backend != "nccl" \
            or device.mesh.shape != {"data": 1, "model": 1}:
        raise AssertionError("dp_nccl: the env contract did not start "
                             "an NCCL world of one")
    x, y = seq_data(4 * BATCH, SEED + 16)
    set_graphs(True)
    single = make_trainer(x, y, BATCH)
    dp = make_trainer(x, y, BATCH, device=device)
    if dp.device.mesh is None or single.device.mesh is not None:
        raise AssertionError("dp_nccl: the workflows' devices")
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dp.step()  # the warm-up and the capture
        torch.cuda.synchronize()
    captured = nccl_events(prof)
    for _ in range(DP_STEPS - 1):
        dp.step()
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts("dp_nccl", launches, {
        **{f"flash_attention_{k}": DP_STEPS for k in ("fwd", "dq", "dkv")},
        "layer_norm_forward": DP_STEPS, "layer_norm_backward": DP_STEPS,
        "softmax_argmax_small": DP_STEPS})
    for _ in range(DP_STEPS):
        single.step()
    worst, name, equal = params_diff(params_of(dp), params_of(single))
    say(f"  {DP_STEPS} graphed steps, NCCL world of one against one "
        f"process: worst ‖dp − single‖ / ‖single‖ {worst:.3g} ({name}), "
        f"{equal} of {len(params_of(dp))} parameters bit-equal (expected "
        f"all; tol {GRAPH_TOL_BF16:.3g})")
    if worst > GRAPH_TOL_BF16:
        raise AssertionError("dp_nccl: the NCCL step leaves the "
                             "one-process step")
    times = {"single": [], "nccl": []}
    for mode in ("single", "nccl", "nccl", "single"):
        times[mode].append(timed_steps(dp if mode == "nccl" else single,
                                       2, 10))
    ratio = sum(times["nccl"]) / sum(times["single"])
    say(f"  graphed step on {card}: one process "
        f"{' / '.join(f'{v:.4f}' for v in times['single'])} ms, NCCL "
        f"world of one {' / '.join(f'{v:.4f}' for v in times['nccl'])} "
        f"ms, ratio {ratio:.4f}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(3):
            dp.step()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    graphed = nccl_events(prof)
    set_graphs(False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dp.step()
        torch.cuda.synchronize()
    set_graphs(True)
    eager = nccl_events(prof)
    # one all-reduce a parameter (the fold) and two of the evaluator's
    # sums (its errors and its loss) a step
    calls = len(params_of(dp)) + 2
    say(f"  NCCL in the profiler (kernels on the card, host ranges): the "
        f"first step, its warm-up and its capture, {captured}; 1 eager "
        f"step {eager}; 3 graphed steps {graphed}; {calls} all-reduces a "
        f"step (NCCL launches no kernel for an all-reduce over one rank; "
        f"a replay calls no NCCL function)")
    if eager[1] != calls or captured[1] != 2 * calls or graphed[1]:
        raise AssertionError("dp_nccl: the NCCL calls of the step are not "
                             "the captured ones")
    device_busy(dp, window="dp_nccl graphed")
    del dp, single
    alexnet = dp_alexnet(card, device)
    distributed.shutdown()
    torch.cuda.empty_cache()
    return launches, alexnet


def ring_operands(gen, dtype):
    import torch
    shape = (BATCH, SEQ, HEADS, DIM // HEADS)
    return [torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            for _ in range(4)]


def ring_run(fold: str, causal: bool, q, k, v, do):
    """The ring over ``RING_MEMBERS`` members in one process, forward
    and backward through ``RingFold``: (out, dq, dk, dv), whole."""
    import torch
    from znicz_tpu_torch.parallel import ring_attention as ra
    ring = ra.LocalRing(RING_MEMBERS)
    leaves = [a.detach().chunk(RING_MEMBERS, dim=1) for a in (q, k, v)]
    leaves = [[c.requires_grad_(True) for c in group] for group in leaves]
    outs = ra.RingFold.apply(ring, fold, causal, *leaves[0], *leaves[1],
                             *leaves[2])[:RING_MEMBERS]
    torch.autograd.backward(outs, do.chunk(RING_MEMBERS, dim=1))
    return [torch.cat(outs, dim=1).detach()] + [
        torch.cat([c.grad for c in group], dim=1) for group in leaves]


def ring_errs(got, want) -> dict:
    return {key: max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
            for key, a, b in zip(("out", "dq", "dk", "dv"), got, want)}


def ring_pass(card: str, dtype_name: str, causal: bool, gen) -> dict:
    """(b) The ring fold at the stack's attention, (16, 2048, 8, 64),
    over 4 members of 512 rows in one process: 16 hops of B7 forward and
    16 of B8 and B9 backward, counted; held to one whole-sequence
    B7/B8/B9 call and to the same fold on the plain versions; with
    ``causal``, a remote hop's key offset planted one tile off must be
    caught."""
    import torch
    from znicz_tpu_torch.ops import flash_attention as fa
    from znicz_tpu_torch.parallel import ring_attention as ra
    dtype = getattr(torch, dtype_name)
    q, k, v, do = ring_operands(gen, dtype)
    torch.cuda.synchronize()
    reset_counts()
    got = ring_run("kernel", causal, q, k, v, do)
    torch.cuda.synchronize()
    launches = read_counts()
    suffix = "_f32" if dtype == torch.float32 else (
        "_causal" if causal else "")
    hops = RING_MEMBERS ** 2
    path = f"ring_{dtype_name}{'_causal' if causal else ''}"
    expect_counts(path, launches, {f"flash_attention_{k}{suffix}": hops
                                   for k in ("fwd", "dq", "dkv")})
    out_w, lse_w = fa.flash_attention_fwd(q, k, v, causal)
    whole = [out_w, *fa.flash_attention_bwd(q, k, v, out_w, lse_w, do,
                                            None, causal)]
    plain = ring_run("plain", causal, q, k, v, do)
    torch.cuda.synchronize()
    tol = RING_TOL[dtype_name]
    e_whole, e_plain = ring_errs(got, whole), ring_errs(got, plain)
    for e in (e_whole, e_plain):
        if max(e.values()) > tol or not all(
                bool(torch.isfinite(t.float()).all()) for t in got):
            raise AssertionError(f"{path}: the ring disagrees: {e} "
                                 f"(tol {tol})")
    ring_ms = time_ms(lambda: ring_run("kernel", causal, q, k, v, do), 3,
                      warmup=1)

    def whole_pass():
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        fa.flash_attention_bwd(q, k, v, o, lse, do, None, causal)

    whole_ms = time_ms(whole_pass, 3, warmup=1)
    say(f"  {path}: {RING_MEMBERS} members × {SEQ // RING_MEMBERS} rows, "
        f"B7/B8/B9 {hops} hops each; against one whole-sequence call "
        + ", ".join(f"{k} {v:.3g}" for k, v in e_whole.items())
        + "; against the plain fold "
        + ", ".join(f"{k} {v:.3g}" for k, v in e_plain.items())
        + f" (tol {tol} × max|ref|); forward + backward {ring_ms:.3f} ms "
        f"on {card}, one whole-sequence call {whole_ms:.3f} ms")
    if causal:
        kernels = ra._FNS["kernel"]

        def shifted(q_, k_, v_, causal_, q_off, k_off):
            if k_off != q_off:
                k_off += RING_FAULT_ROWS
            return kernels[0](q_, k_, v_, causal_, q_off, k_off)

        ra._FNS["kernel"] = (shifted, *kernels[1:])
        try:
            bad = ring_run("kernel", causal, q, k, v, do)
        finally:
            ra._FNS["kernel"] = kernels
        err = ring_errs(bad, whole)["out"]
        say(f"  planted fault (a remote hop's keys {RING_FAULT_ROWS} rows "
            f"off): out {err:.3g}: "
            f"{'caught' if err > tol else 'not caught'}")
        if err <= tol:
            raise AssertionError(f"{path}: the check passes a planted "
                                 f"fault")
    del q, k, v, do, got, whole, plain
    torch.cuda.empty_cache()
    return launches


#: graphed AlexNet steps in the NCCL world of one, against one process
DP_ALEX_STEPS = 3
#: B3's block layouts at fc6/fc7's (128, 4096): name, blocks as (row
#: slice, column slice), the route each block must take.  The data
#: layout (4 row blocks), the tensor-parallel one (2 column blocks),
#: both (2 × 2), and columns cut at 2044, off 8, which the general
#: kernel takes
DROPOUT_BLOCKS = (
    ("rows4", tuple((slice(32 * k, 32 * k + 32), slice(0, 4096))
                    for k in range(4)), "vector"),
    ("cols2", tuple((slice(0, 128), slice(2048 * k, 2048 * k + 2048))
                    for k in range(2)), "vector"),
    ("grid2x2", tuple((slice(64 * i, 64 * i + 64),
                       slice(2048 * j, 2048 * j + 2048))
                      for i in range(2) for j in range(2)), "vector"),
    ("cols_off8", ((slice(0, 128), slice(0, 2044)),
                   (slice(0, 128), slice(2044, 4096))), "general"))


class BlockPlace:
    """A process's place on a (data, model) mesh as a unit's device reads
    it (sizes and coordinates, no process groups): lets one process run
    a unit as rank (d, m) of such a mesh would, to hold its draw against
    one draw over the whole."""

    device_type = "cuda"

    def __init__(self, n_data: int, data_rank: int) -> None:
        self.shape = {"data": n_data, "model": 1}
        self.coords = {"data": data_rank, "model": 0}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return None


def check_dropout_blocks(gen) -> dict:
    """(d) B3 with its block map at fc6/fc7's (128, 4096), bf16 (and the
    row blocks in f32): each block of :data:`DROPOUT_BLOCKS` launched on
    its own with its map, its output and its backward's bit-equal to the
    slices of one launch over the whole tensor and to the plain version
    with the map, on the route the layout names; the first block of each
    layout timed in a CUDA graph beside its bound.  Returns the layouts'
    rows for the kernel line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import fused_kernels as fk
    seed = int(np.random.default_rng(SEED + 28).integers(0, 2 ** 63))
    seed_t = fk.seed_tensor(seed, "cuda")
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        x, err = (torch.randn(ALEX_BATCH, 4096, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        y = fk.dropout_apply(x, seed_t, DROP_RATIO)
        dx = fk.dropout_apply(err, seed_t, DROP_RATIO)
        for name, blocks, route in DROPOUT_BLOCKS:
            if dtype_name == "float32" and name != "rows4":
                continue
            ok, took = True, []
            for rs, cs in blocks:
                block = fk.BlockMap(rs.start, cs.start, 4096)
                xb, eb = x[rs, cs].contiguous(), err[rs, cs].contiguous()
                before = dict(fk.dropout_apply.launches_by_route)
                yb = fk.dropout_apply(xb, seed_t, DROP_RATIO, block)
                db = fk.dropout_apply(eb, seed_t, DROP_RATIO, block)
                took += _took(fk.dropout_apply, before)
                ok &= torch.equal(yb, y[rs, cs]) and torch.equal(
                    db, dx[rs, cs]) and torch.equal(yb, fk.dropout_apply_plain(
                        xb, seed, DROP_RATIO, block))
            torch.cuda.synchronize()
            rs, cs = blocks[0]
            block = fk.BlockMap(rs.start, cs.start, 4096)
            xb = x[rs, cs].contiguous()
            ms = graph_ms(lambda: fk.dropout_apply(xb, seed_t, DROP_RATIO,
                                                   block))
            plain_ms = graph_ms(lambda: fk.dropout_apply_plain(
                xb, seed, DROP_RATIO, block), 10)
            lib_ms = graph_ms(lambda: F.dropout(xb, DROP_RATIO,
                                                training=True))
            elem = xb.numel()
            bound_ms, bound_by = bound(
                2.0 * elem * xb.element_size(),
                float(elem * PHILOX_OPS_PER_ELEMENT), PEAK_F32_FLOP_S)
            key = name if dtype_name == "bfloat16" else f"{name}_f32"
            say(f"  B3 block map {key}: {len(blocks)} blocks of "
                f"{tuple(xb.shape)} {dtype_name}, routes {sorted(set(took))}"
                f" (want {route}): output and backward bit-equal to the "
                f"whole launch's slices and to the plain version {ok}; a "
                f"block {ms:.5f} ms, plain {plain_ms:.4f} ms, F.dropout "
                f"{lib_ms:.5f} ms (CUDA graphs), bound {bound_ms:.3g} ms "
                f"({bound_by})")
            if not ok or set(took) != {route}:
                raise AssertionError(f"dropout block map {key}: bit-equal "
                                     f"{ok}, routes {took}")
            out[key] = {"blocks": len(blocks), "shape": list(xb.shape),
                        "route": route, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}
    return out


def stochastic_unit_blocks() -> None:
    """(d), continued: the units' draws on the card as rank k of a data
    axis of 4 would draw them (:class:`BlockPlace`), each bit-equal to
    its rows of one unit's draw over the whole batch from the same seed:
    dropout at fc6's (128, 4096) bf16, stochastic pooling at AlexNet's
    pool5 input (128, 13, 13, 256) bf16 (its output and its choices) and
    ``Binarization`` at (128, 4096) f32."""
    import torch
    from znicz_tpu_torch.backends import CudaDevice
    from znicz_tpu_torch.ops.dropout import DropoutForward
    from znicz_tpu_torch.ops.pooling import StochasticPooling
    from znicz_tpu_torch.ops.rbm_units import Binarization
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 29)
    cases = (
        ("dropout", lambda: DropoutForward((4096,), torch.bfloat16,
                                           dropout_ratio=DROP_RATIO),
         torch.randn(ALEX_BATCH, 4096, generator=gen, device="cuda")
         .to(torch.bfloat16), ("output",)),
        ("stochastic_pooling", lambda: StochasticPooling(
            (13, 13, 256), torch.bfloat16, kx=3, ky=3, sliding=(2, 2)),
         torch.randn(ALEX_BATCH, 13, 13, 256, generator=gen, device="cuda")
         .to(torch.bfloat16), ("output", "last_choice")),
        ("binarization", lambda: Binarization((4096,), torch.float32),
         torch.rand(ALEX_BATCH, 4096, generator=gen, device="cuda"),
         ("output",)))
    n, rows = 4, ALEX_BATCH // 4
    for name, make, x, fields in cases:
        got = {}
        for rank in (None,) + tuple(range(n)):
            unit = make()
            place = None if rank is None else BlockPlace(n, rank)
            unit.initialize(device=CudaDevice(dev, mesh=place))
            unit.seed_chain.set_value(SEED + 30)
            part = x if rank is None else x[rank * rows:(rank + 1) * rows]
            with torch.no_grad():
                unit.output = unit(part.contiguous())
            got[rank] = [getattr(unit, f).clone() for f in fields]
        torch.cuda.synchronize()
        equal = all(torch.equal(torch.cat([got[r][i] for r in range(n)]),
                                got[None][i]) for i in range(len(fields)))
        say(f"  {name} as rank k of a data axis of {n} ({rows} rows each, "
            f"{tuple(x.shape)} {x.dtype}): the ranks' {', '.join(fields)} "
            f"stacked = one draw over the whole batch: {equal}")
        if not equal:
            raise AssertionError(f"{name}: the ranks' draws are not the "
                                 f"whole batch's")


def dp_alexnet(card: str, device) -> dict:
    """(a), continued: AlexNet at B = 128 in bf16 with dropout on, its
    region graphed, in the NCCL world of one (``device``, the launcher's
    card with its mesh) for :data:`DP_ALEX_STEPS` steps: B1–B4 counted
    (B3 four times a step), held to the same steps in one process
    (expected bit-equal), each step's dropout seeds the one process's."""
    import torch
    steps = DP_ALEX_STEPS
    set_graphs(True)
    runs = {}
    for arm, dev in (("nccl", device), ("single", None)):
        wf = make_alexnet(ALEX_BATCH, steps * ALEX_BATCH, device=dev)
        units = [u for u in wf.forwards
                 if type(u).__name__ == "DropoutForward"]
        seeds = []
        wf.add_step_hook(lambda: seeds.append([int(u.seed) for u in units]))
        reset_counts()
        for _ in range(steps):
            wf.step()
        torch.cuda.synchronize()
        runs[arm] = (wf, read_counts(), seeds)
    dp, launches, seeds = runs["nccl"]
    expect_counts("dp_alexnet", launches, {
        "lrn_forward": steps, "lrn_forward_conv2": steps,
        "lrn_backward": steps, "lrn_backward_conv2": steps,
        "dropout_apply": 4 * steps, "softmax_argmax": steps})
    worst, name, equal = params_diff(params_of(dp),
                                     params_of(runs["single"][0]))
    say(f"  AlexNet B={ALEX_BATCH} bf16, dropout on, {steps} graphed steps "
        f"in the NCCL world of one on {card}: {dp.region.captures} "
        f"capture(s), B3 launches {launches['dropout_apply']}; against one "
        f"process: worst ‖dp − single‖ / ‖single‖ {worst:.3g} ({name}), "
        f"{equal} of {len(params_of(dp))} parameters bit-equal (expected "
        f"all; tol {GRAPH_TOL_BF16:.3g}); the dropout seeds the same "
        f"{seeds == runs['single'][2]}")
    if worst > GRAPH_TOL_BF16 or seeds != runs["single"][2]:
        raise AssertionError("dp_alexnet: the NCCL step leaves the "
                             "one-process step")
    for wf, _, _ in runs.values():
        wf.release_graphs()
    return launches


def pipeline_pass(card: str) -> dict:
    """(c) ``run_pipelined(2 stages, M = 4)`` of the sequence stack,
    graphed (one graph an op: 2 · K · M captures), against
    ``run_accumulated(4)`` graphed on the same data, from one seed, for
    ``PIPE_STEPS`` optimizer steps: the same kernels on the same
    microbatches in the same order, expected bit-equal; the captures,
    the measured bubble and each arm's peak device memory."""
    import torch
    from znicz_tpu_torch.parallel.pipeline import bubble_fraction
    from znicz_tpu_torch.utils.config import root
    x, y = seq_data(PIPE_STEPS * PIPE_MICRO * BATCH, SEED + 17)
    set_graphs(True)
    arms = {}
    for arm in ("accumulated", "pipelined"):
        root.common.engine.grad_accum = PIPE_MICRO
        wf = make_trainer(x, y, BATCH)
        wf.decision.max_epochs = 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        if arm == "pipelined":
            wf.run_pipelined(PIPE_STAGES, PIPE_MICRO)
        else:
            wf.run_accumulated(PIPE_MICRO)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        arms[arm] = {"params": params_of(wf), "launches": launches,
                     "mem": torch.cuda.max_memory_allocated(),
                     "wall": wall, "wf": wf}
        n = PIPE_STEPS * PIPE_MICRO
        expect_counts(f"pipeline_{arm}", launches, {
            **{f"flash_attention_{k}": n for k in ("fwd", "dq", "dkv")},
            "layer_norm_forward": n, "layer_norm_backward": n,
            "softmax_argmax_small": n})
    root.common.engine.grad_accum = 1
    pipe = arms["pipelined"]["wf"]._pipeline
    if pipe.captures != 2 * PIPE_STAGES * PIPE_MICRO:
        raise AssertionError(f"pipeline: {pipe.captures} captures")
    worst, name, equal = params_diff(arms["pipelined"]["params"],
                                     arms["accumulated"]["params"])
    say(f"  run_pipelined({PIPE_STAGES} stages, M={PIPE_MICRO}) against "
        f"run_accumulated({PIPE_MICRO}), {PIPE_STEPS} optimizer steps of "
        f"{PIPE_MICRO} × {BATCH} rows, graphed on {card}: worst "
        f"‖pipe − accum‖ / ‖accum‖ {worst:.3g} ({name}), {equal} of "
        f"{len(arms['pipelined']['params'])} parameters bit-equal "
        f"(expected all; tol {GRAPH_TOL_BF16:.3g}); {pipe.captures} "
        f"captures (one an op); last step makespan "
        f"{1e3 * pipe.last_makespan:.3f} ms, bubble "
        f"{1e3 * pipe.last_bubble_seconds:.3f} stage-ms (the model's "
        f"fraction {bubble_fraction(PIPE_STAGES, PIPE_MICRO):.3f} of "
        f"{PIPE_STAGES} × makespan: "
        f"{pipe.last_bubble_seconds / (PIPE_STAGES * pipe.last_makespan):.3f}"
        f" measured); peak device memory "
        f"{arms['pipelined']['mem'] / 2 ** 30:.2f} GiB pipelined, "
        f"{arms['accumulated']['mem'] / 2 ** 30:.2f} GiB accumulated; "
        f"wall {arms['pipelined']['wall']:.2f} s / "
        f"{arms['accumulated']['wall']:.2f} s (captures included)")
    if worst > GRAPH_TOL_BF16:
        raise AssertionError("pipeline: the pipelined run leaves the "
                             "accumulated one")
    launches = arms["pipelined"]["launches"]
    del arms, pipe
    torch.cuda.empty_cache()
    return launches


#: phase 17: the synthetic ImageNet set of the alexnet sample, streamed
STREAM_TRAIN, STREAM_VALID, STREAM_EPOCHS = 1024, 128, 3
#: rows per shard file of phase 17's set (5 files, 256 · 154,587 bytes)
STREAM_ROWS_PER_SHARD = 256
#: the reader_death fault's arrival (the producer's 5th batch: mid-epoch)
STREAM_DEATH_AT = 5


def stream_shards(x, y) -> str:
    """Phase 17's set (``STREAM_VALID`` validation frames, then the
    train frames) written as shards under ``build/`` (gitignored)."""
    from znicz_tpu_torch.loader.streaming import write_shards
    out = os.path.join(REPO, "build", "stream_shards")
    return write_shards(out, x[:STREAM_TRAIN], y[:STREAM_TRAIN],
                        valid_data=x[STREAM_TRAIN:],
                        valid_labels=y[STREAM_TRAIN:],
                        rows_per_shard=STREAM_ROWS_PER_SHARD)


def make_streamed(shard_dir: str, **loader_kwargs):
    """The alexnet sample's net at full width in bf16, fed through a
    ``StreamingLoader`` over ``shard_dir`` (normalized as the sample's
    resident loader does)."""
    from znicz_tpu_torch.loader.streaming import StreamingLoader
    from znicz_tpu_torch.models.samples import alexnet
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.precision_type = "bfloat16"
    cfg = {**root.alexnet.as_dict(), "minibatch_size": ALEX_BATCH}
    prng.seed_all(SEED)
    wf = StandardWorkflow(
        name="alexnet_stream",
        loader_factory=lambda w: StreamingLoader(
            w, shard_dir, minibatch_size=ALEX_BATCH,
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0,
            **loader_kwargs),
        layers=alexnet.layers(cfg),
        decision_config={"max_epochs": cfg["max_epochs"]})
    wf.initialize()
    return wf


def same_seeds(*wfs) -> None:
    """One seed chain for the workflows' dropout units, unit by unit: a
    chain roots lazily, after the last ``seed_all``, so two workflows
    built one after the other and stepped in turns would draw different
    roots."""
    for wf in wfs:
        chains = [u.seed_chain for u in wf.forwards
                  if hasattr(u, "seed_chain")]
        for i, chain in enumerate(chains):
            chain.set_value(SEED + i)


def delivered_ok(loader, glob) -> bool:
    """This step's delivery against the set: the rows of ``minibatch_raw``
    equal ``glob[idx]`` exactly, where ``idx`` is the schedule's entry for
    the step (also ``minibatch_indices``), and the count and labels are
    the entry's."""
    import numpy as np
    import torch
    idx, _, count = loader.schedule_entry(loader.epoch_number,
                                          loader._cursor - 1)
    want = torch.from_numpy(idx.astype(np.int64)).to(glob["x"].device)
    return (torch.equal(loader.minibatch_indices, want)
            and int(loader.minibatch_valid) == count
            and torch.equal(loader.minibatch_raw.devmem,
                            glob["x"].index_select(0, want))
            and torch.equal(loader.minibatch_labels,
                            glob["y"].index_select(0, want)))


def pctl(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def stream_pass(card: str) -> tuple[dict, dict]:
    """Phase 17 (a): AlexNet at B = 128 in bf16, graphed, for
    ``STREAM_EPOCHS`` epochs through ``StreamingLoader`` over the
    alexnet sample's synthetic set written as shards, epoch by epoch in
    turns with the same net fed by the resident ``ArrayLoader`` (phase
    8's path, here with its validation set).  Every delivered batch must
    equal the set's rows at its schedule entry, exactly; after the run
    every parameter must lie within ``CIFAR_EPOCH_TOL`` of the resident
    run's; B1–B4 must launch on the streamed path as on the resident
    one.  Prints the step times (train and validation steps apart), the
    input wait, the share of the input's time hidden, the bytes moved
    and held, then times the pipeline's copies alone.  Two planted
    faults: a delivery that rebinds ``minibatch_raw`` must be refused by
    the next replay, and ``loader.reader_death`` fired mid-epoch must
    restart the pipeline with every batch still exact.  Returns the
    launches of the streamed path and of the resident one."""
    import numpy as np
    import torch
    from znicz_tpu_torch import datasets
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.memory import Vector
    from znicz_tpu_torch.models.samples import alexnet
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    t0 = time.perf_counter()
    x, y = datasets.synthetic_imagenet(STREAM_TRAIN + STREAM_VALID,
                                       size=227, n_classes=1000)
    shard_dir = stream_shards(x, y)
    say(f"  wrote {x.nbytes / 1e6:.1f} MB as "
        f"{-(-len(x) // STREAM_ROWS_PER_SHARD)} shards in "
        f"{time.perf_counter() - t0:.1f} s")
    # the set in global order (validation, then train) on the card
    glob = {"x": torch.from_numpy(np.concatenate(
                [x[STREAM_TRAIN:], x[:STREAM_TRAIN]])).cuda(),
            "y": torch.from_numpy(np.concatenate(
                [y[STREAM_TRAIN:], y[:STREAM_TRAIN]])).cuda()}
    root.common.precision_type = "bfloat16"
    prng.seed_all(SEED)
    resident = alexnet.build(minibatch_size=ALEX_BATCH,
                             n_train_samples=STREAM_TRAIN,
                             n_valid_samples=STREAM_VALID)
    resident.initialize()
    streamed = make_streamed(shard_dir, prefetch_depth=2)
    same_seeds(resident, streamed)
    loader = streamed.loader
    n_sched = len(loader._schedule)
    name = loader.name
    stage0 = metrics.input_stage_seconds(name)
    stage_sum0, stage_n0 = stage0.sum, stage0.count
    ms = {("stream", TRAIN): [], ("stream", "valid"): [],
          ("resident", TRAIN): [], ("resident", "valid"): []}
    waits = {TRAIN: [], "valid": []}
    counts = {"stream": {}, "resident": {}}
    bad = []
    torch.cuda.synchronize()
    for epoch in range(STREAM_EPOCHS):
        order = ("resident", "stream") if epoch % 2 == 0 \
            else ("stream", "resident")
        for mode in order:
            wf = streamed if mode == "stream" else resident
            reset_counts()
            for _ in range(n_sched):
                waited = loader.input_wait_s
                t1 = time.perf_counter()
                wf.step()
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t1) * 1e3
                cls = wf.loader.minibatch_class
                kind = TRAIN if cls == TRAIN else "valid"
                ms[mode, kind].append(step_ms)
                if mode == "stream":
                    waits[kind].append(
                        (loader.input_wait_s - waited) * 1e3)
                    if not delivered_ok(loader, glob):
                        bad.append((loader.epoch_number,
                                    loader._cursor - 1))
            for k, v in read_counts().items():
                counts[mode][k] = counts[mode].get(k, 0) + v
    stage_s = stage0.sum - stage_sum0
    stage_n = stage0.count - stage_n0
    pipe = loader.pipeline
    raw_bytes = pipe.ring.buffer(0).nbytes
    meta_bytes = pipe.meta_ring.buffer(0).nbytes
    wait_s = sum(waits[TRAIN] + waits["valid"]) / 1e3
    hidden = 1.0 - wait_s / stage_s if stage_s else float("nan")
    # the first step starts the pipeline: its read is synchronous
    first_s = waits["valid"][0] / 1e3
    steady = 1.0 - (wait_s - first_s) / stage_s if stage_s else float("nan")
    steps = STREAM_EPOCHS * n_sched
    say(f"  {steps} steps each ({STREAM_EPOCHS} epochs of "
        f"{n_sched - 1} train steps and 1 validation step) on {card}, "
        f"graphed ({streamed.region.captures} captures streamed, "
        f"{resident.region.captures} resident), epochs in turns; host "
        f"time a step to a synchronize:")
    for kind, label in ((TRAIN, "train"), ("valid", "validation")):
        for mode in ("stream", "resident"):
            vals = ms[mode, kind][1:]  # the first of a kind: a capture
            say(f"    {label} {mode}: p50 {pctl(vals, 50):.4f} ms, mean "
                f"{float(np.mean(vals)):.4f} ms, max {max(vals):.4f} ms "
                f"over {len(vals)} steps (the first, a capture, "
                f"{ms[mode, kind][0]:.1f} ms, left out)")
    say(f"  input wait (host time blocked on the pipeline): train p50 "
        f"{pctl(waits[TRAIN], 50):.4f} ms, p99 {pctl(waits[TRAIN], 99):.4f}"
        f" ms; validation p50 {pctl(waits['valid'], 50):.4f} ms, p99 "
        f"{pctl(waits['valid'], 99):.4f} ms; hits {loader.prefetch_hits}, "
        f"misses {loader.prefetch_misses}, epoch crossings served "
        f"{loader.epoch_cross_prefetches}")
    say(f"  shard gather: {stage_n} batches, {1e3 * stage_s / stage_n:.3f}"
        f" ms a batch in the producer ({loader.n_reader_threads} reader "
        f"threads, page cache warm); input time hidden "
        f"{100 * hidden:.2f} % (1 − wait {wait_s * 1e3:.3f} ms / stage "
        f"{stage_s * 1e3:.3f} ms), {100 * steady:.2f} % without the first "
        f"step's synchronous start ({first_s * 1e3:.3f} ms)")
    say(f"  H2D a step: {raw_bytes + meta_bytes:,} bytes (batch "
        f"{raw_bytes:,} + count, indices and labels {meta_bytes:,}); "
        f"ring: {pipe.ring.n_slots} slots, {pipe.ring.nbytes:,} bytes "
        f"page-locked={pipe.ring.pinned} (+ {pipe.meta_ring.nbytes:,} of "
        f"meta rows); device staging {len(pipe.stage_raw)} × "
        f"{raw_bytes:,} + meta = {pipe.staging_nbytes:,} bytes")
    if bad:
        raise AssertionError(f"stream: delivered batches differ from the "
                             f"set at (epoch, cursor) {bad}")
    say(f"  every one of the {steps} delivered batches equals the set's "
        f"rows at its schedule entry, exactly (indices, count, labels "
        f"too), across {STREAM_EPOCHS - 1} epoch boundaries and the "
        f"{streamed.region.captures} captures taken while the pipeline "
        f"ran")
    if raw_bytes != ALEX_BATCH * 227 * 227 * 3 or not pipe.ring.pinned:
        raise AssertionError("stream: the ring is not the pinned batch")
    ran = {k: v for k, v in counts["stream"].items() if v}
    say(f"  launches on the stream path: {ran}")
    if counts["stream"] != counts["resident"] or not all(
            counts["stream"][k] for k in (
                "lrn_forward", "lrn_forward_conv2", "lrn_backward",
                "lrn_backward_conv2", "dropout_apply", "softmax_argmax")):
        raise AssertionError(f"stream: launches {ran} against the "
                             f"resident run's {counts['resident']}")
    err, worst, same = params_diff(params_of(streamed), params_of(resident))
    say(f"  streamed against resident after {steps} steps: worst "
        f"‖streamed − resident‖ / ‖resident‖ {err:.3g} ({worst}; tol "
        f"{CIFAR_EPOCH_TOL}), {same} of {len(params_of(resident))} "
        f"parameters bit-equal")
    if err > CIFAR_EPOCH_TOL:
        raise AssertionError("stream: the streamed run leaves the resident "
                             "one")
    copies = stream_copy_ms(pipe)
    say(f"  the pipeline's copies alone ({ALEX_BATCH} frames, CUDA events,"
        f" 20 each): pinned H2D on a side stream {copies['h2d']:.4f} ms "
        f"({raw_bytes / copies['h2d'] / 1e6:.1f} GB/s), the in-place "
        f"delivery D2D {copies['d2d']:.4f} ms "
        f"({2 * raw_bytes / copies['d2d'] / 1e6:.1f} GB/s read + write)")
    # planted fault 1: a delivery that rebinds minibatch_raw
    real = Vector.accept_device

    def rebinding(self, value):
        self._devmem = value.clone()
    Vector.accept_device = rebinding
    try:
        streamed.step()
        refused = False
    except RuntimeError as exc:
        refused = "rebound" in str(exc)
    finally:
        Vector.accept_device = real
    say(f"  planted fault (a delivery that rebinds minibatch_raw): "
        f"{'refused by the next replay' if refused else 'not caught'}")
    if not refused:
        raise AssertionError("stream: a rebinding delivery was replayed")
    loader.stop()
    streamed.stop()
    del streamed, resident
    stream_reader_death(shard_dir, glob, n_sched)
    say(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    return counts["stream"], counts["resident"]


def stream_copy_ms(pipe) -> dict:
    """The pipeline's two copies of one batch timed alone (fresh
    tensors of the pipeline's shapes): the page-locked slot to a staging
    tensor on a side stream, and a staging tensor into another device
    tensor (the delivery)."""
    import torch
    ring = pipe.ring.tensor(0)
    src = torch.empty(ring.shape, dtype=ring.dtype, pin_memory=True)
    stage = torch.empty_like(pipe.stage_raw[0])
    dst = torch.empty_like(stage)
    side = torch.cuda.Stream()
    out = {}
    for name, stream, fn in (
            ("h2d", side, lambda: stage.copy_(src, non_blocking=True)),
            ("d2d", torch.cuda.current_stream(),
             lambda: dst.copy_(stage, non_blocking=True))):
        with torch.cuda.stream(stream):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(20):
                fn()
            end.record(stream)
        end.synchronize()
        out[name] = start.elapsed_time(end) / 20
    return out


def stream_reader_death(shard_dir: str, glob, n_sched: int) -> None:
    """The planted ``loader.reader_death`` on the card: the producer dies
    at its ``STREAM_DEATH_AT``-th batch, mid-epoch; over one epoch and
    two steps the loader must restart the pipeline once, and deliver
    every batch exactly (the clean run's batches are the set's rows at
    the same entries).  A bare loader, no region: the delivery is what
    is checked."""
    from znicz_tpu_torch.loader.streaming import StreamingLoader
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    from znicz_tpu_torch.workflow import Workflow
    root.common.engine.faults = {"loader.reader_death":
                                 {"at": [STREAM_DEATH_AT]}}
    try:
        prng.seed_all(SEED)
        loader = StreamingLoader(
            Workflow(name="stream_fault"), shard_dir,
            minibatch_size=ALEX_BATCH, prefetch_depth=2,
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0)
        loader.initialize(device="cuda")
        bad = []
        for _ in range(n_sched + 2):
            loader.run()
            if not delivered_ok(loader, glob):
                bad.append((loader.epoch_number, loader._cursor - 1))
        restarts = loader.pipeline_restarts
        loader.stop()
    finally:
        root.common.engine.faults = None
    say(f"  planted fault (loader.reader_death at the producer's batch "
        f"{STREAM_DEATH_AT}): {restarts} pipeline restart(s), "
        f"{n_sched + 2 - len(bad)} of {n_sched + 2} batches exact")
    if restarts != 1 or bad:
        raise AssertionError(f"stream: reader death gave {restarts} "
                             f"restarts, wrong batches at {bad}")


# ----------------------------------------------------------------------
# phase 17 (b): image decode on the card — the pool's own JPEG and PNG
# decoders, imagenet trained from a JPEG tree, the PNG samples
# ----------------------------------------------------------------------
#: the JPEG tree: classes and images a class (ImageNet's layout)
TREE_CLASSES, TREE_PER_CLASS = 16, 64
#: the kind of image i is TREE_KINDS[i % 20]: 70 % baseline (quality 90,
#: 4:2:0), 10 % progressive, 5 % each 4:4:4, grayscale, restart markers
#: and PNG
TREE_KINDS = ("baseline",) * 14 + ("progressive",) * 2 + (
    "444", "gray", "restart", "png")
#: imagenet's train steps from the tree: the capture, then profiler
#: windows of a warm-up replay (its records dropped) and TREE_WINDOW kept
#: replays each, a window repeated only when the profiler lost a record
#: (``PROFILE_TRIES`` at most): 6 train steps, or 11 or 16
TREE_WINDOW = 4
#: the pool thread counts of the decode rates (over the whole tree), and
#: PIL's yardstick over every 7th file (7 is coprime with the 20 of
#: TREE_KINDS' cycle, so the subset keeps the mix)
TREE_THREADS, TREE_PIL_EVERY = (1, 4, 0), 7
#: the PNG samples' trees: (sample, directory, classes, images a class)
PNG_SAMPLE_DIRS = (("hands", "hands", 2, 14),
                   ("yale_faces", "yalefaces", 4, 6),
                   ("channels", "channels", 3, 10))
#: epochs of each PNG sample: a key's first step captures it, the last
#: epoch replays only
PNG_SAMPLE_EPOCHS = 3


def tree_image(i: int):
    """Image ``i`` of the tree: a textured frame (waves and noise, not
    white noise) of an ImageNet size, 333–500 wide and 281–500 high."""
    import numpy as np
    rng = np.random.default_rng(SEED + i)
    h, w = int(rng.integers(281, 501)), int(rng.integers(333, 501))
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    planes = [128 + 90 * np.sin(x / rng.uniform(3, 40) + c)
              * np.cos(y / rng.uniform(3, 40) - c) for c in range(3)]
    noise = rng.integers(-14, 15, size=(h, w, 3), dtype=np.int16)
    return np.clip(np.stack(planes, -1) + noise, 0, 255).astype(np.uint8)


def write_tree(root: str) -> dict:
    """The class-per-subdirectory tree, written with PIL in threads:
    ``{path: (kind, (h, w))}``."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image

    def write(i: int):
        kind = TREE_KINDS[i % len(TREE_KINDS)]
        img = tree_image(i)
        d = os.path.join(root, f"n{i // TREE_PER_CLASS:08d}")
        path = os.path.join(d, f"{i:05d}.{'png' if kind == 'png' else 'jpg'}")
        pil = Image.fromarray(img)
        if kind == "png":
            pil.save(path)
        elif kind == "gray":
            pil.convert("L").save(path, quality=90)
        else:
            pil.save(path, quality=90,
                     subsampling=0 if kind == "444" else 2,
                     progressive=kind == "progressive",
                     **({"restart_marker_blocks": 4}
                        if kind == "restart" else {}))
        return path, (kind, img.shape[:2])

    for c in range(TREE_CLASSES):
        os.makedirs(os.path.join(root, f"n{c:08d}"), exist_ok=True)
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        return dict(ex.map(write, range(TREE_CLASSES * TREE_PER_CLASS)))


def tree_against_pil(tree: dict) -> None:
    """Every file of the tree through the pool at its own size (no
    resize, the crop the whole frame) and through PIL (its bundled
    libjpeg-turbo, zlib): the JPEGs bit-equal, or the differing pixels
    and the largest difference printed and within one level; the PNGs
    bit-equal; no file failed.  A pool of one thread a worker thread,
    one file a submit."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from PIL import Image
    from znicz_tpu_torch.native import ImagePipeline
    local = threading.local()
    pools = []

    def check(item):
        path, (kind, hw) = item
        if not hasattr(local, "pipe"):
            local.pipe = ImagePipeline(1)
            pools.append(local.pipe)
        out = np.empty((1, *hw, 3), np.uint8)
        local.pipe.submit([path], out, out_hw=hw)
        failed = local.pipe.wait()
        with Image.open(path) as img:
            want = np.asarray(img.convert("RGB"))
        diff = np.abs(out[0].astype(np.int16) - want.astype(np.int16))
        return kind, failed, int((diff.max(-1) > 0).sum()), int(diff.max())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        results = list(ex.map(check, tree.items()))
    for pipe in pools:
        pipe.close()
    by_kind = {}
    for kind, failed, n_diff, worst in results:
        k = by_kind.setdefault(kind, [0, 0, 0, 0, 0])
        k[0] += 1
        k[1] += failed
        k[2] += n_diff == 0
        k[3] += n_diff
        k[4] = max(k[4], worst)
    say(f"  {len(results)} files through the pool at their own sizes and "
        f"through PIL in {time.perf_counter() - t0:.1f} s ({os.cpu_count()} "
        f"threads): by "
        f"kind (files, failed, bit-equal to PIL, differing pixels, max "
        f"|Δ|): {by_kind}")
    failed = sum(k[1] for k in by_kind.values())
    worst = max(k[4] for kind, k in by_kind.items() if kind != "png")
    if failed or worst > 1 or by_kind["png"][3]:
        raise AssertionError(f"the pool against PIL: {failed} failed, "
                             f"JPEGs off by up to {worst}, PNG pixels off "
                             f"{by_kind['png'][3]}")


def pool_build() -> float:
    """The pool built from the checkout's sources with g++ (timed), its
    library's DT_NEEDED entries printed: zlib, and neither libjpeg nor
    libpng."""
    from znicz_tpu_torch import native
    from znicz_tpu_torch.native import ImagePipeline
    path = native.library_path()
    cached = path.exists()
    t0 = time.perf_counter()
    if not ImagePipeline.available():
        raise AssertionError(f"the pool did not build: "
                             f"{ImagePipeline.build_error()}")
    build_s = time.perf_counter() - t0
    dyn = subprocess.run(["readelf", "-d", str(path)], capture_output=True,
                         text=True, check=True).stdout
    needed = [line.split("[", 1)[1].rstrip("]") for line in dyn.splitlines()
              if "(NEEDED)" in line]
    say(f"  the pool {'loaded (built before)' if cached else 'built'} in "
        f"{build_s:.2f} s with g++ from "
        f"{', '.join(p.name for p in native.SOURCES)} into "
        f"{os.path.relpath(path, REPO)}; DT_NEEDED {needed}")
    if [n for n in needed if "jpeg" in n or "png" in n] \
            or not any(n.startswith("libz.") for n in needed):
        raise AssertionError(f"the pool links {needed}")
    return build_s


def imagenet_tree_cli(root: str, card: str) -> tuple[dict, float]:
    """``python -m znicz_tpu_torch imagenet --root imagenet.train_dir=
    <tree>`` in this process at the sample's defaults (1000 classes,
    B = 128, 256 resize, 227 random crops and flips, the 4 % validation
    carve), stopped once a profiler window over the replays has read the
    launches right: a CUDA event after each step's decision (the step
    time between two, median over the replays with no profiler work
    between them), the pool's wait a step, the region's captures, the
    train loss a step (finite), the window's busy share and the
    wrappers' counts against the kernels it saw
    (:func:`expect_device_launches`; the window repeated, as in
    :func:`device_busy`, only when the profiler saw fewer), B1–B4's
    launches exactly one a layer a step.  Returns the launches and the
    step's kernels (ms): the device's time a step, which sets the rate
    the pool must feed."""
    import math
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from znicz_tpu_torch.__main__ import Main
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.ops.decision import DecisionBase
    from znicz_tpu_torch.utils.config import reset_root
    reset_root()
    steps = []
    # the window: idle, warm (its warm-up replay runs) or kept
    win = {"state": "idle", "tries": 0}
    decide = DecisionBase.decide

    def profile_window(decision, n_train: int) -> bool:
        """The window's work after train step ``n_train``: True where
        it did some (the next step's gap holds it)."""
        acted = False
        if win["state"] == "warm":
            torch.cuda.synchronize()
            win["prof"].step()  # the warm-up ends; what follows is kept
            win["before"] = wrapper_launches()
            time.sleep(PROFILE_MARGIN_S)
            win["t0"] = time.perf_counter()
            win["state"], win["last"] = "kept", n_train + TREE_WINDOW
            return True
        if win["state"] == "kept" and n_train == win["last"]:
            torch.cuda.synchronize()
            win["wall_ms"] = (time.perf_counter() - win["t0"]) * 1e3
            time.sleep(PROFILE_MARGIN_S)
            win["prof"].__exit__(None, None, None)
            win["state"], acted = "idle", True
            try:
                if expect_device_launches(
                        win["prof"], win["before"], "imagenet replays",
                        last_try=win["tries"] == PROFILE_TRIES):
                    win["wf"] = decision.workflow
                    decision.complete = True
                    return True
            except AssertionError as exc:
                win["error"] = exc
                decision.complete = True
                return True
        if win["state"] == "idle" and n_train >= 1:  # after the capture
            torch.cuda.synchronize()
            win["prof"] = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1))
            win["prof"].__enter__()
            win["state"] = "warm"
            win["tries"] += 1
            acted = True
        return acted

    def decide_and_record(decision):
        wf = decision.workflow
        loader = wf.loader
        loss_in = wf.evaluator.epoch_loss[TRAIN].clone()
        decide(decision)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        steps.append({"cls": loader.minibatch_class, "event": event,
                      "wait": loader.prefetch_wait_s,
                      "captures": wf.region.captures, "loss_in": loss_in,
                      "loss_out": wf.evaluator.epoch_loss[TRAIN].clone(),
                      "host": time.perf_counter(), "acted": False})
        if loader.minibatch_class == TRAIN:
            n_train = sum(step["cls"] == TRAIN for step in steps)
            steps[-1]["n_train"] = n_train
            steps[-1]["acted"] = profile_window(decision, n_train)

    reset_counts()
    DecisionBase.decide = decide_and_record
    t0 = time.perf_counter()
    try:
        main = Main()
        rc = main.run(["imagenet", "--root", f"imagenet.train_dir={root}"])
    finally:
        DecisionBase.decide = decide
        if win["state"] != "idle":
            win["prof"].__exit__(None, None, None)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if "error" in win:
        raise win["error"]
    if rc or "wf" not in win:
        raise AssertionError(f"imagenet: exit code {rc}, profiler windows "
                             f"{win['tries']}")
    counts = read_counts()
    wf = win["wf"]
    loader = wf.loader
    classes = [step["cls"] for step in steps]
    train = [i for i, cls in enumerate(classes) if cls == TRAIN]
    head = tuple(wf.forwards[-1].output.shape)
    say(f"  python -m znicz_tpu_torch imagenet --root imagenet.train_dir="
        f"<tree> on {card}: {len(steps)} steps ({len(train)} train, "
        f"{win['tries']} profiler window(s)) in {host_s:.1f} s on the "
        f"host clock, build and initialize included; decoder "
        f"{loader.decoder} ({loader.n_threads or os.cpu_count()} "
        f"threads), dataset {tuple(loader.class_lengths)} (test, "
        f"validation, train) over {len(loader.file_paths)} files, head "
        f"{head}")
    if loader.decoder != "native" or wf.device.type != "cuda" \
            or head != (ALEX_BATCH, 1000) or classes[0] == TRAIN:
        raise AssertionError(f"imagenet: decoder {loader.decoder} on "
                             f"{wf.device}, head {head}, steps {classes}")
    gaps = [steps[i - 1]["event"].elapsed_time(steps[i]["event"])
            for i in train[1:]]
    host_gaps = [1e3 * (steps[i]["host"] - steps[i - 1]["host"])
                 for i in train[1:]]
    # the replays whose gap holds no profiler work and no other step (the
    # first replay's batch was decoded during the capture step)
    quiet = [steps[i - 1]["event"].elapsed_time(steps[i]["event"])
             for i in train[2:]
             if classes[i - 1] == TRAIN and not steps[i - 1]["acted"]]
    step_ms = float(np.median(quiet))
    waits = [1e3 * (steps[i]["wait"] - steps[i - 1]["wait"])
             for i in train[1:]]
    captures = [steps[i]["captures"] for i in train]
    losses = [float(steps[i]["loss_in"] - steps[i - 1]["loss_out"])
              for i in train]
    say(f"  train steps between CUDA events (ms): "
        f"{[round(g, 3) for g in gaps]} (on the host clock "
        f"{[round(g, 3) for g in host_gaps]}); the {len(quiet)} with no "
        f"profiler work in their gap, median {step_ms:.3f} ms "
        f"({ALEX_BATCH / step_ms * 1e3:.0f} img/s); the pool's wait a "
        f"train step (ms) {[round(v, 3) for v in waits]} (prefetch hits "
        f"{loader.prefetch_hits}, misses {loader.prefetch_misses}); region "
        f"captures after each train step {captures}; train loss a step "
        f"{[round(v, 4) for v in losses]}")
    if captures[1:] != [captures[1]] * (len(captures) - 1) \
            or not all(math.isfinite(v) and v > 0 for v in losses):
        raise AssertionError("imagenet: a capture after the first graphed "
                             "step, or a loss that is not finite")
    prof = win["prof"]
    spans = {u.name for u in wf.units}
    busy_ms = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) / 1e3
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key not in spans
                  and not e.key.startswith(("workflow:", "chunk:",
                                            "capture:")))
    # (a window that holds an epoch's first steps holds its validation
    # step's forward too)
    kernel_ms = busy_ms / TREE_WINDOW
    busy = busy_ms / win["wall_ms"]
    say(f"  device busy {busy_ms:.3f} ms of {win['wall_ms']:.3f} ms over "
        f"the last window's {TREE_WINDOW} replayed train steps "
        f"({100 * busy:.1f} % busy) on {card}: the step's kernels "
        f"{kernel_ms:.3f} ms, so AlexNet (f32, the sample's precision) "
        f"asks {ALEX_BATCH / kernel_ms * 1e3:.0f} img/s of the pool")
    # a validation step begins each epoch
    per_epoch = -(-loader.class_lengths[TRAIN] // ALEX_BATCH)
    n_valid = len(steps) - len(train)
    expect_counts("imagenet_tree", counts, {
        "lrn_forward": len(steps), "lrn_forward_conv2": len(steps),
        "lrn_backward": len(train), "lrn_backward_conv2": len(train),
        "dropout_apply": 4 * len(train), "softmax_argmax": len(steps)})
    if n_valid != -(-len(train) // per_epoch):
        raise AssertionError(f"imagenet: {n_valid} validation steps in "
                             f"{len(train)} train steps")
    return counts, kernel_ms


def png_samples(datasets: str, card: str) -> dict:
    """``hands``, ``yale_faces`` and ``channels`` over PNG trees written
    under ``datasets`` (the reference's layout), each through
    ``Main().run`` for ``PNG_SAMPLE_EPOCHS`` epochs, graphed: the
    directory read by ``FullBatchImageLoader`` with the native pool, B4
    once a step, no capture in the last epoch."""
    import importlib
    import numpy as np
    from PIL import Image
    from znicz_tpu_torch.loader.image import FullBatchImageLoader
    from znicz_tpu_torch.utils.config import root
    paths = {}
    rows = {name: row for name, _b, _c, row, _bar in A6A}
    rng = np.random.default_rng(SEED + 17)
    for name, directory, n_classes, per_class in PNG_SAMPLE_DIRS:
        # the sample's defaults register when its module is imported
        importlib.import_module(f"znicz_tpu_torch.models.samples.{name}")
        size = dict(getattr(root, name).as_dict())["image_size"]
        for c in range(n_classes):
            d = os.path.join(datasets, directory, f"c{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                level = 40 + 160 * c / max(1, n_classes - 1)
                arr = np.clip(rng.normal(level, 20, (size + 3, size + 5, 3)),
                              0, 255).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{i}.png"))
        reset_counts()
        wf, errors, captures = mlp_cli(
            name, "--root", f"common.dirs.datasets={datasets}", "--root",
            f"{name}.max_epochs={PNG_SAMPLE_EPOCHS}")
        launches = read_counts()
        steps = PNG_SAMPLE_EPOCHS * steps_per_epoch(wf.loader)
        say(f"  {name} from {n_classes} × {per_class} PNGs on {card}: "
            f"{type(wf.loader).__name__} ({wf.loader.decoder}), dataset "
            f"{tuple(wf.loader.class_lengths)}, {steps} steps, validation "
            f"error by epoch {errors} %, captures by epoch {captures}")
        if not isinstance(wf.loader, FullBatchImageLoader) \
                or wf.loader.decoder != "native" \
                or captures[-1] != captures[-2]:
            raise AssertionError(f"{name}: loader {wf.loader}, decoder "
                                 f"{wf.loader.decoder}, captures {captures}")
        expect_counts(f"{name}_png", launches, {rows[name]: steps})
        paths[f"{name}_png"] = launches
    return paths


#: the committed arithmetic-coded JPEGs (C22) and their digests: the
#: reference pool's RGB bytes, computed where libjpeg is
ARITH_DIR = os.path.join(REPO, "tests", "torch_jpeg_arith")
#: the ImageNet-sized ones, timed beside a Huffman coding of the frame
ARITH_TIMED = {"imagenet_420_sof9.jpg": {"subsampling": 2},
               "imagenet_420_sof10.jpg": {"subsampling": 2,
                                          "progressive": True}}
#: decodes a file when timing the pool on one
ARITH_REPEATS = 25


def pool_file_ms(pipe, path: str, hw) -> float:
    """The pool's median ms to decode ``path`` at its own size, one
    file a submit, after one untimed decode."""
    import numpy as np
    out = np.empty((1, *hw, 3), np.uint8)
    times = []
    for i in range(ARITH_REPEATS + 1):
        t0 = time.perf_counter()
        pipe.submit([path], out, out_hw=hw)
        pipe.wait()
        if i:
            times.append(time.perf_counter() - t0)
    return 1e3 * sorted(times)[len(times) // 2]


def arith_files(card: str, tmp: str) -> None:
    """Phase 17 (b)'s arithmetic-coded JPEGs (SOF9, SOF10; C22): each
    committed file of ``tests/torch_jpeg_arith/`` through the pool at its
    own size, held to its ``digests.json`` entry (the reference pool's
    bytes and failed count); held to PIL too where the card's PIL
    decodes arithmetic coding (within one level, as the tree's files),
    the truncated file left to the digest; the pool's ms a file for the
    ImageNet-sized ones beside a Huffman coding (PIL, quality 90) of the
    same frame."""
    import hashlib
    import numpy as np
    from PIL import Image
    from znicz_tpu_torch.native import ImagePipeline
    with open(os.path.join(ARITH_DIR, "digests.json")) as f:
        digests = json.load(f)
    pipe = ImagePipeline(1)
    lines, bad = [], []
    try:
        for name, entry in sorted(digests.items()):
            path = os.path.join(ARITH_DIR, name)
            hw = tuple(entry["hw"])
            out = np.zeros((1, *hw, 3), np.uint8)
            pipe.submit([path], out, out_hw=hw)
            failed = pipe.wait()
            sha = hashlib.sha256(out[0].tobytes()).hexdigest()
            if failed != entry["failed"] or sha != entry["sha256"]:
                bad.append(name)
            if "truncated" in name:
                pil = "not compared (truncated)"
            else:
                try:
                    with Image.open(path) as img:
                        want = np.asarray(img.convert("RGB"))
                    diff = np.abs(want.astype(np.int16) - out[0])
                    pil = ("bit-equal" if not diff.any() else
                           f"{int((diff.max(-1) > 0).sum())} pixels off, "
                           f"max |Δ| {int(diff.max())}")
                    if diff.max() > 1:
                        bad.append(f"{name} against PIL")
                except OSError as exc:
                    pil = f"PIL refuses it ({exc})"
            timed = ""
            if name in ARITH_TIMED:
                twin = os.path.join(tmp, f"huffman_{name}")
                Image.fromarray(out[0]).save(twin, quality=90,
                                             **ARITH_TIMED[name])
                timed = (f", pool {pool_file_ms(pipe, path, hw):.2f} ms a "
                         f"decode against {pool_file_ms(pipe, twin, hw):.2f}"
                         f" ms for its Huffman twin "
                         f"({os.path.getsize(path)} / "
                         f"{os.path.getsize(twin)} bytes)")
            lines.append(f"{name} {hw[1]}x{hw[0]}: digest "
                         f"{'equal' if name not in bad else 'DIFFERS'}, "
                         f"PIL {pil}{timed}")
    finally:
        pipe.close()
    say(f"  {len(digests)} arithmetic-coded JPEGs (C22) through the pool "
        f"on {card}'s host, median of {ARITH_REPEATS} decodes where timed, "
        f"one thread:")
    for line in lines:
        say(f"    {line}")
    if bad:
        raise AssertionError(f"arithmetic-coded JPEGs: {bad}")


def image_decode_pass(card: str) -> dict:
    """Phase 17 (b): the pool built with g++ (no libjpeg, no libpng),
    the committed arithmetic-coded JPEGs held to their digests
    (:func:`arith_files`), the JPEG tree written and held to PIL, imagenet trained from it
    through the CLI, the decode rates against the step's demand and
    PIL's (``tools/decode_ab.py``), the PNG samples.  Returns the paths'
    launches."""
    import importlib.util
    t0 = time.perf_counter()
    pool_build()
    with tempfile.TemporaryDirectory() as tmp:
        arith_files(card, tmp)
        t1 = time.perf_counter()
        root = os.path.join(tmp, "train")
        tree = write_tree(root)
        kinds = {k: sum(v[0] == k for v in tree.values())
                 for k in dict.fromkeys(TREE_KINDS)}
        say(f"  wrote {len(tree)} files ({TREE_CLASSES} classes × "
            f"{TREE_PER_CLASS}) in {time.perf_counter() - t1:.1f} s: {kinds}")
        tree_against_pil(tree)
        paths = {}
        paths["imagenet_tree"], kernel_ms = imagenet_tree_cli(root, card)
        spec = importlib.util.spec_from_file_location(
            "decode_ab", os.path.join(REPO, "tools", "decode_ab.py"))
        decode_ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(decode_ab)
        timed = sorted(tree)
        t1 = time.perf_counter()
        rates = decode_ab.ab(timed, TREE_THREADS, pil_every=TREE_PIL_EVERY)
        demand = ALEX_BATCH / kernel_ms * 1e3
        for t, runs in rates.items():
            pool = " / ".join(f"{r:.1f}" for r in runs["pool"])
            pil = " / ".join(f"{r:.1f}" for r in runs["pil"])
            say(f"  decode at 256 resize, 227 crop, on {card}'s host: the "
                f"pool with {t or os.cpu_count()} thread(s) over the "
                f"{len(timed)} files {pool} img/s, PIL one thread at a "
                f"time over every {TREE_PIL_EVERY}th "
                f"({len(timed[::TREE_PIL_EVERY])} files) {pil} img/s (pool, "
                f"PIL, PIL, pool); AlexNet's kernels ask {demand:.0f} "
                f"img/s")
        say(f"  the decode rates took {time.perf_counter() - t1:.1f} s")
        paths.update(png_samples(os.path.join(tmp, "datasets"), card))
    say(f"  phase 17 (b) took {time.perf_counter() - t0:.1f} s")
    return paths



# ----------------------------------------------------------------------
# phase 18: resilience — the anomaly guard and the SDC fingerprints in
# the graphed step (on by default), the sentinel's vote and audit, the
# publisher into the graphed scorer engine, the elastic supervisor
# ----------------------------------------------------------------------
#: AlexNet steps a timed turn of phase 18 (after one warm-up step)
RES_STEPS = 8
#: the turns of phase 18's step timing: the guard on with its state read
#: after every step (the default), no guard, the guard on with the read
#: off (``engine.anomaly_check_interval`` past the run)
RES_ORDER = ("on", "off", "noread", "noread", "off", "on")
#: AlexNet steps whose launches phase 18 counts, guarded and not
RES_COUNTED = 2
#: the byte LM's optimizer steps in phase 18 (4 microbatches each)
RES_LM_STEPS = 3
#: the held-out rows the publishing canary scores on the numpy oracle
RES_CANARY_ROWS = 1
#: requests of the publishing drill's probation
RES_PROBATION = 4


def state_bits(wf) -> dict:
    """Every parameter, momentum and microbatch-sum tensor of ``wf``,
    cloned on the device."""
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for name, t in [*unit.named_parameters(recurse=False),
                        *unit.named_buffers(recurse=False)]:
            if name != "lr_state":
                out[f"{unit.name}.{name}"] = t.detach().clone()
    return out


def bits_differ(a: dict, b: dict) -> list:
    """The tensors of ``a`` and ``b`` that differ in any bit, every NaN
    taken as one (the card's arithmetic returns its canonical NaN, a
    planted NaN has torch's payload)."""
    import torch

    def raw(t):
        if t.is_floating_point():
            t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")),
                            t)
        return t.contiguous().view(torch.uint8)

    return [k for k in a if not torch.equal(raw(a[k]), raw(b[k]))]


def worst_rel(a: dict, b: dict) -> float:
    """The largest ‖a − b‖ / ‖b‖ over the tensors."""
    return max(float((a[k].float() - b[k].float()).norm())
               / max(float(b[k].float().norm()), 1e-30) for k in a)


def turn_ms(wf, steps: int) -> tuple[float, float]:
    """One warm-up step, then ``steps`` steps each between CUDA events:
    ``(p50 of the steps, mean over the run)`` in ms.  A step that reads
    the guard's state waits for it, so its span holds the read and the
    host's work after it."""
    import torch
    wf.step()
    torch.cuda.synchronize()
    evs = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        wf.step()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    per = sorted(a.elapsed_time(b) for a, b in evs)
    return per[len(per) // 2], evs[0][0].elapsed_time(evs[-1][1]) / steps


def guard_alexnet(card: str, tmp: str) -> dict:
    """Phase 18 (a): AlexNet at B=128 in bf16, graphed, with the guard
    and the fingerprints on (the default) and off: the step times in
    turns, B1–B4's launches a step the same both ways, an injected
    non-finite loss and an injected non-finite gradient each leaving
    every parameter and momentum bit for bit with no new capture, five
    injected steps in a row rolled back to the run's snapshot with the
    graphed run going on after, and a clean guarded step against the
    unguarded one from that snapshot beside two unguarded ones."""
    import torch
    from znicz_tpu_torch.models.samples import alexnet
    from znicz_tpu_torch.mutable import Bool
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    from znicz_tpu_torch.utils.snapshotter import Snapshotter
    # the guarded workflow's steps before the drill: two timed turns
    # with the read, two without, then the counted steps
    drill = 4 * (1 + RES_STEPS) + RES_COUNTED
    loss_at, grad_at = drill + 2, drill + 4
    streak = list(range(drill + 6, drill + 11))

    def build(guard: bool):
        root.common.precision_type = "bfloat16"
        root.common.engine.anomaly_guard = guard
        prng.seed_all(SEED)
        wf = alexnet.build(minibatch_size=ALEX_BATCH,
                           n_train_samples=8 * ALEX_BATCH,
                           n_valid_samples=0,
                           snapshotter_config={"prefix": "alex18",
                                               "directory": tmp})
        # the drill writes its own snapshot
        wf.snapshotter.gate_skip = Bool._derived(lambda: True)
        wf.initialize()
        return wf

    root.common.engine.faults = None
    unguarded = build(False)
    # the drill's plan, for the guarded workflow's arrivals only (the
    # unguarded one has no guard to arm)
    root.common.engine.faults = {
        "train.nonfinite_loss": {"at": [loss_at] + streak},
        "train.nonfinite_grad": {"at": [grad_at]}}
    guarded = build(True)
    root.common.engine.anomaly_guard = True
    if guarded.anomaly_guard is None or unguarded.anomaly_guard is not None:
        raise AssertionError("guard_alexnet: the guard is not on by default")
    times = {"on": [], "off": [], "noread": []}
    for mode in RES_ORDER:
        root.common.engine.anomaly_check_interval = \
            10 ** 9 if mode == "noread" else 1
        times[mode].append(turn_ms(unguarded if mode == "off" else guarded,
                                   RES_STEPS))
    root.common.engine.anomaly_check_interval = 1

    def line(mode):
        return " / ".join(f"p50 {p:.3f} ms, mean {m:.3f} ms"
                          for p, m in times[mode])

    on = min(m for _, m in times["on"])
    off = min(m for _, m in times["off"])
    noread = min(m for _, m in times["noread"])
    say(f"  AlexNet B={ALEX_BATCH} bf16 graphed on {card}, {RES_STEPS} steps "
        f"a turn in the order {'/'.join(RES_ORDER)}: guard on (state read "
        f"a step) {line('on')}; no guard {line('off')}; guard on without "
        f"the read {line('noread')}; the guard in the graph costs "
        f"{noread - off:+.3f} ms a step ({100 * (noread - off) / off:+.2f} "
        f"%), the read {on - noread:+.3f} ms ({100 * (on - noread) / off:+.2f}"
        f" %), both {on - off:+.3f} ms ({100 * (on - off) / off:+.2f} %) "
        f"(best mean of each mode)")
    counts = {}
    for name, wf in (("guarded", guarded), ("unguarded", unguarded)):
        reset_counts()
        for _ in range(RES_COUNTED):
            wf.step()
        torch.cuda.synchronize()
        counts[name] = read_counts()
    want = {"lrn_forward": RES_COUNTED, "lrn_forward_conv2": RES_COUNTED,
            "lrn_backward": RES_COUNTED, "lrn_backward_conv2": RES_COUNTED,
            "dropout_apply": 4 * RES_COUNTED, "softmax_argmax": RES_COUNTED}
    expect_counts("guard_alexnet", counts["guarded"], want)
    expect_counts("guard_alexnet unguarded", counts["unguarded"], want)
    expect_new_routes("guard_alexnet")

    guard = guarded.anomaly_guard
    captures = guarded.region.captures
    base = guard.read_state()
    if base != (0, 0, 0):
        raise AssertionError(f"guard_alexnet: the clean steps before the "
                             f"drill read (streak, loss, grad) {base}")
    for k in range(1, 6):
        before = state_bits(guarded)
        guarded.step()
        moved = bits_differ(before, state_bits(guarded))
        injected = drill + k in (loss_at, grad_at)
        if injected and moved:
            raise AssertionError(f"guard_alexnet: the injected step {drill + k}"
                                 f" changed {moved[:4]}")
        if not injected and not moved:
            raise AssertionError("guard_alexnet: a clean step changed "
                                 "nothing")
    totals = guard.read_state()
    say(f"  train.nonfinite_loss at step {loss_at} and train.nonfinite_grad "
        f"at step {grad_at}: every parameter and momentum tensor bit-equal "
        f"across each, the clean steps between them moved; (streak, loss, "
        f"grad) {base} → {totals}; captures {captures} → "
        f"{guarded.region.captures}")
    if totals[1:] != (base[1] + 1, base[2] + 1) or totals[0] != 0 \
            or guarded.region.captures != captures or captures != 1:
        raise AssertionError("guard_alexnet: the anomaly totals or the "
                             "captures")

    # the drill's snapshot in gzip's stored blocks (level 0) and without a
    # sidecar, which Snapshotter.load reads: the state is 0.5 GB of
    # floats, which compress little, and level 9 takes ~20 s to write
    t0 = time.perf_counter()
    path = os.path.join(tmp, "alex18_pre.pickle.gz")
    with gzip.open(path, "wb", compresslevel=0) as fh:
        pickle.dump(guarded.state_dict(), fh,
                    protocol=pickle.HIGHEST_PROTOCOL)
    write_s = time.perf_counter() - t0
    guarded.snapshotter.destination = path
    snap = state_bits(guarded)
    rollbacks = metrics.anomaly_rollbacks(guarded.name).value
    t0 = time.perf_counter()
    for _ in streak:
        guarded.step()
    early = metrics.anomaly_rollbacks(guarded.name).value - rollbacks
    # the tick reads the state a step behind on the card: the streak's
    # fifth step is read after the next (clean) step, whose update the
    # rollback's load then overwrites
    guarded.step()
    torch.cuda.synchronize()
    streak_s = time.perf_counter() - t0
    restored = bits_differ(snap, state_bits(guarded))
    after = guard.read_state()
    say(f"  five injected steps in a row ({streak[0]}–{streak[-1]}): "
        f"{early:.0f} rollback after them, then "
        f"{metrics.anomaly_rollbacks(guarded.name).value - rollbacks:.0f} "
        f"after one more step (the read a step behind) to the snapshot "
        f"written before them ({write_s:.2f} s to write at gzip level 0; "
        f"the six steps and the load {streak_s:.2f} s), "
        f"{len(snap) - len(restored)} of {len(snap)} tensors bit-equal to "
        f"it after, streak {after[0]}")
    if metrics.anomaly_rollbacks(guarded.name).value != rollbacks + 1 \
            or early or restored or after[0] != 0:
        raise AssertionError("guard_alexnet: the rollback")
    before = state_bits(guarded)
    for _ in range(3):
        guarded.step()
    now = state_bits(guarded)
    finite = all(bool(torch.isfinite(t).all()) for t in now.values())
    say(f"  3 graphed steps after the rollback: parameters moved "
        f"{bool(bits_differ(before, now))}, finite {finite}, captures "
        f"{guarded.region.captures}")
    if not finite or not bits_differ(before, now) \
            or guarded.region.captures != 1:
        raise AssertionError("guard_alexnet: the run after the rollback")

    # a clean step from the run's snapshot, guarded and unguarded (conv
    # backward adds with atomics, so two unguarded steps give the noise)
    root.common.engine.faults = None
    state = Snapshotter.load(path)
    steps = {}
    for name, wf in (("guarded", guarded), ("unguarded", unguarded),
                     ("unguarded again", unguarded)):
        wf.load_state(state)
        wf.step()
        steps[name] = state_bits(wf)
    noise = worst_rel(steps["unguarded again"], steps["unguarded"])
    dev = worst_rel(steps["guarded"], steps["unguarded"])
    bound = max(4 * noise, 1e-5)
    say(f"  one clean step from the snapshot: guarded against unguarded "
        f"worst ‖Δ‖/‖x‖ {dev:.3g}, two unguarded steps {noise:.3g} (bound "
        f"{bound:.3g}); tensors bit-equal guarded/unguarded "
        f"{len(steps['guarded']) - len(bits_differ(steps['guarded'], steps['unguarded']))}"
        f" of {len(steps['guarded'])}")
    if dev > bound:
        raise AssertionError("guard_alexnet: the guarded step leaves the "
                             "unguarded one")
    EAGER["guard_alexnet"] = {"on": on, "off": off, "noread": noread}
    return counts["guarded"]


def guard_seq(card: str) -> dict:
    """Phase 18 (a), continued: the full-width bf16 sequence stack's
    graphed train step (phase 4's trainer) with the guard and the
    fingerprints on, off, and on without the per-step read, in turns;
    its kernels' launches a step the same guarded and not."""
    import numpy as np
    import torch
    from znicz_tpu_torch.utils.config import root
    rng = np.random.default_rng(SEED + 20)
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(4 * BATCH, SEQ, DIM))
                         .astype(np.float32)).to(torch.bfloat16)
    y = rng.integers(0, CLASSES, size=4 * BATCH).astype(np.int32)
    root.common.engine.faults = None
    wfs = {}
    for guard in (False, True):
        root.common.engine.anomaly_guard = guard
        wfs[guard] = make_trainer(x, y, BATCH)
    root.common.engine.anomaly_guard = True
    times = {"on": [], "off": [], "noread": []}
    for mode in RES_ORDER:
        root.common.engine.anomaly_check_interval = \
            10 ** 9 if mode == "noread" else 1
        times[mode].append(turn_ms(wfs[mode != "off"], RES_STEPS))
    root.common.engine.anomaly_check_interval = 1
    counts = {}
    for guard, wf in wfs.items():
        reset_counts()
        for _ in range(RES_COUNTED):
            wf.step()
        torch.cuda.synchronize()
        counts[guard] = read_counts()
    want = {f"flash_attention_{k}": RES_COUNTED for k in ("fwd", "dq",
                                                          "dkv")}
    want.update(layer_norm_forward=RES_COUNTED,
                layer_norm_backward=RES_COUNTED,
                softmax_argmax_small=RES_COUNTED)
    expect_counts("guard_seq", counts[True], want)
    expect_counts("guard_seq unguarded", counts[False], want)
    state = wfs[True].anomaly_guard.read_state()
    if state != (0, 0, 0):
        raise AssertionError(f"guard_seq: the clean guarded steps read "
                             f"(streak, loss, grad) {state}")
    on, off, noread = (min(m for _, m in times[k])
                       for k in ("on", "off", "noread"))
    say(f"  the sequence stack B={BATCH} bf16 graphed on {card}, "
        f"{RES_STEPS} steps a turn: guard on "
        + " / ".join(f"p50 {p:.3f} ms, mean {m:.3f} ms"
                     for p, m in times["on"])
        + "; no guard " + " / ".join(f"p50 {p:.3f} ms, mean {m:.3f} ms"
                                     for p, m in times["off"])
        + "; without the read " + " / ".join(
            f"p50 {p:.3f} ms, mean {m:.3f} ms" for p, m in times["noread"])
        + f"; the guard in the graph {noread - off:+.3f} ms "
        f"({100 * (noread - off) / off:+.2f} %), the read "
        f"{on - noread:+.3f} ms ({100 * (on - noread) / off:+.2f} %)")
    EAGER["guard_seq"] = {"on": on, "off": off, "noread": noread}
    return counts[True]


def guard_lm_accum(card: str) -> dict:
    """Phase 18 (b): the byte LM's ``run_accumulated(4)``, graphed and
    guarded: a NaN in one microbatch of one optimizer step (token 255,
    whose embedding row is made NaN, planted in one sample that the
    step's second microbatch gathers, and in no other) skips the whole
    step — every parameter, momentum and microbatch sum bit-equal across
    it, one loss anomaly counted — and the next step trains."""
    import torch
    from znicz_tpu_torch.observe import metrics
    n_train = RES_LM_STEPS * LM_MICRO * BATCH
    x, y = lm_data(n_train, SEQ, SEED + 18)
    x[x == 255] = 254  # token 255 appears only where it is planted
    set_graphs(True)
    reset_counts()
    wf = make_lm(x, y, n_train, BATCH, grad_accum=LM_MICRO, max_epochs=1)
    loader, emb = wf.loader, wf.forwards[0].weights
    guard = wf.anomaly_guard
    seen, plant = {}, {}

    def hook():
        step = len(seen) + 1
        seen[step] = (state_bits(wf), guard.read_state(),
                      wf.region.captures)
        if step == 1:
            # the next step's second microbatch: plant token 255 in one
            # of its samples, and make its embedding row NaN
            idx, _, _ = loader.schedule_entry(loader.epoch_number,
                                              loader._cursor + 1)
            sample = int(idx[0])
            plant["at"] = (sample, loader.original_data[sample, 0].item(),
                           emb[255].clone())
            loader.original_data[sample, 0] = 255.0
            emb[255] = float("nan")
            seen[step] = (state_bits(wf),) + seen[step][1:]
        elif step == 2:
            sample, token, row = plant["at"]
            loader.original_data[sample, 0] = token
            emb[255] = row

    wf.add_step_hook(hook)
    wf.run_accumulated(LM_MICRO)
    torch.cuda.synchronize()
    counts = read_counts()
    skipped = bits_differ(seen[1][0], seen[2][0])
    trained = bits_differ(seen[2][0], seen[3][0])
    (_, s1, c1), (_, s2, c2), (_, s3, c3) = seen[1], seen[2], seen[3]
    finite = all(bool(torch.isfinite(t).all())
                 for t in seen[3][0].values())
    say(f"  byte LM run_accumulated({LM_MICRO}) graphed and guarded on "
        f"{card}: a NaN in microbatch 2 of optimizer step 2 only: "
        f"{len(seen[1][0]) - len(skipped)} of {len(seen[1][0])} parameter, "
        f"momentum and microbatch-sum tensors bit-equal across the step "
        f"(every NaN taken as one); "
        f"(streak, loss, grad) {s1} → {s2} → {s3}; step 3 moved "
        f"{len(trained)} tensors, finite {finite}; captures {c1}, {c2}, {c3}"
        f" (loss anomalies counted "
        f"{metrics.step_anomalies(wf.name, 'loss').value:.0f})")
    if skipped or s2[1] != s1[1] + 1 or not trained or not finite \
            or not c1 == c2 == c3:
        say(f"  tensors that moved across the skipped step: {skipped}")
        raise AssertionError("guard_lm_accum: one NaN microbatch did not "
                             "skip exactly its optimizer step")
    expect_counts("guard_lm_accum", counts,
                  lm_counts(RES_LM_STEPS * LM_MICRO))
    expect_ln_register("guard_lm_accum")
    return counts


def sdc_mnist(card: str) -> None:
    """Phase 18 (c) at phase 9's MNIST 784-100-10 width (f32, graphed):
    the guarded run bit-equal to the unguarded one; ``sdc.flip_param``
    raising the sticky self-check to 1 and the vote of a world of one
    naming process 0; ``sdc.flip_grad`` caught by the shadow audit on
    the numpy oracle, after a clean audit at the reference's
    ``sdc_audit_rtol`` that raised nothing."""
    from znicz_tpu_torch.models.samples import mnist
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root, root

    def build(faults=None, guard=True):
        reset_root()
        root.common.engine.faults = faults
        root.common.engine.anomaly_guard = guard
        prng.seed_all(SEED)
        wf = mnist.build()
        wf.initialize()
        train_ahead(wf, 8)  # past the validation minibatches
        if wf.integrity is not None:
            wf.integrity._tick = 0
        return wf

    runs = {}
    for guard in (True, False):
        wf = build(guard=guard)
        for _ in range(3):
            wf.step()
        runs[guard] = state_bits(wf)
        del wf
    differ = bits_differ(runs[True], runs[False])
    say(f"  MNIST 784-100-10 graphed on {card}: 3 train steps guarded "
        f"against unguarded from one seed: {len(runs[True]) - len(differ)} "
        f"of {len(runs[True])} tensors bit-equal")
    if differ:
        raise AssertionError(f"sdc_mnist: the guarded run differs: {differ}")

    wf = build({"sdc.flip_param": {"at": [2]}})
    sentinel = wf.integrity
    sentinel.vote_interval = 3
    votes = metrics.sdc_votes(wf.name, "divergent").value
    wf.step()
    wf.step()
    sticky = wf.anomaly_guard.read_sdc_fingerprint()[3]
    wf.step()  # the third tick votes
    verdict = getattr(sentinel, "last_verdict", None)
    say(f"  sdc.flip_param before train step 2: the sticky self-check "
        f"{sticky:.0f} after it; the vote of a world of one at tick 3 "
        f"{verdict}; quarantined {sentinel.quarantined}")
    if sticky != 1.0 or verdict is None or verdict["culprits"] != [0] \
            or metrics.sdc_votes(wf.name, "divergent").value != votes + 1:
        raise AssertionError("sdc_mnist: flip_param not localized")
    del wf

    wf = build({"sdc.flip_grad": {"at": [6]}})
    sentinel = wf.integrity
    sentinel.vote_interval, sentinel.audit_interval = 0, 3
    audits, real = [], sentinel._run_audit

    def timed_audit():
        t0 = time.perf_counter()
        real()
        audits.append((list(sentinel.last_audit), time.perf_counter() - t0))

    sentinel._run_audit = timed_audit
    for _ in range(6):
        wf.step()
    say(f"  shadow audits on the numpy oracle at rtol "
        f"{sentinel.audit_rtol:g}: step 3 (clean) mismatches "
        f"{audits[0][0] if audits else None} in {audits[0][1]:.3f} s (the "
        f"shadow clone built in it), step 6 (sdc.flip_grad) mismatches "
        f"{[name for name, _, _ in audits[1][0]]} in {audits[1][1]:.3f} s")
    if len(audits) != 2 or audits[0][0] or not audits[1][0] \
            or not sentinel.quarantined:
        raise AssertionError("sdc_mnist: the audits")
    root.common.engine.faults = None


def publish_serve(card: str, tmp: str) -> dict:
    """Phase 18 (d): the full-width bf16 sequence stack trains graphed and
    publishes (``publish_bundle``) into phase 14's scorer engine, every
    bucket a CUDA graph, under a closed loop of requests: a good bundle
    promoted and through its probation, ``publish.corrupt`` refused by
    the watcher, ``swap.canary_regress`` refused at the canary (the
    numpy oracle on held-out rows), a promoted bundle rolled back by
    ``swap.probation_fail``; no new capture, and every reply one
    version's bit for bit."""
    import threading
    import numpy as np
    import torch
    from znicz_tpu_torch.export import read_bundle
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.resilience.publisher import (PublicationWatcher,
                                                      SwapController,
                                                      classifier_score,
                                                      publish_bundle)
    from znicz_tpu_torch.serving import ServingEngine
    from znicz_tpu_torch.utils.config import root
    rng = np.random.default_rng(SEED + 19)
    x = rng.normal(0.0, 0.3, size=(2 * BATCH, SEQ, DIM)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=2 * BATCH).astype(np.int32)
    root.common.engine.faults = None
    set_graphs(True)
    reset_counts()
    trainer = make_trainer(torch.from_numpy(x).to(torch.bfloat16), y, BATCH)
    # the trainer's capture before the engine's threads run: a capture
    # in the default global mode is invalidated by another thread's
    # CUDA work, so the serving threads see only the trainer's replays
    trainer.step()
    torch.cuda.synchronize()
    scorer = os.path.join(tmp, "scorer.npz")
    write_scorer_bundle(scorer)
    pub = os.path.join(tmp, "published")
    eng = ServingEngine(scorer, max_batch=BATCH, max_delay_ms=2.0)
    eng.start()
    watcher = PublicationWatcher(pub)
    ctl = SwapController(eng, watcher, classifier_score(
        x[:RES_CANARY_ROWS], y[:RES_CANARY_ROWS]), guard_margin=1.0,
        probation_steps=RES_PROBATION)
    x3 = x[:3]
    events, replies, stop = [], [], threading.Event()
    failures = []

    def hammer():
        try:
            while not stop.is_set():
                replies.append(eng(x3, timeout=300))
        except Exception as exc:  # noqa: BLE001 — re-raised below
            failures.append(exc)

    spent = {"publish": [], "tick": []}

    def publish(n_steps: int, faults=None) -> int:
        for _ in range(n_steps):
            trainer.step()
        root.common.engine.faults = faults
        t0 = time.perf_counter()
        try:
            version, _ = publish_bundle(trainer, pub)
        finally:
            root.common.engine.faults = None
        spent["publish"].append(time.perf_counter() - t0)
        return version

    def tick(faults=None) -> list:
        root.common.engine.faults = faults
        t0 = time.perf_counter()
        try:
            got = ctl.tick()
        finally:
            root.common.engine.faults = None
        spent["tick"].append(time.perf_counter() - t0)
        events.extend(got)
        return got

    try:
        expect_ladder_captures(eng, "publish_serve")
        refs = {0: eng(x3, timeout=300)}
        thread = threading.Thread(target=hammer)
        thread.start()
        t0 = time.perf_counter()
        v1 = publish(2)
        tick()
        refs[v1] = eng(x3, timeout=300)
        target = eng.requests_served + RES_PROBATION + 1
        while eng.requests_served < target and thread.is_alive():
            time.sleep(0.001)
        tick()
        failed = metrics.snapshot_failures("publish").value
        v2 = publish(1, {"publish.corrupt": {"at": [1]}})
        tick()
        refused = v2 in watcher._bad and eng.model_version == v1 \
            and metrics.snapshot_failures("publish").value == failed + 1
        v3 = publish(1)
        tick({"swap.canary_regress": {"at": [1], "penalty": 10.0}})
        v4 = publish(1)
        tick()
        refs[v4] = eng(x3, timeout=300)
        tick({"swap.probation_fail": {"at": [1]}})
        loop_s = time.perf_counter() - t0
        n = len(replies)
        while len(replies) < n + 2 and thread.is_alive():
            time.sleep(0.001)
    finally:
        stop.set()
        thread.join(300)
        final = eng.model_version
        expect_ladder_captures(eng, "publish_serve after the swaps")
        eng.shutdown()
    if failures:
        raise failures[0]
    counts = read_counts()
    seen = {v: 0 for v in refs}
    for i, r in enumerate(replies):
        hit = [v for v, ref in refs.items() if np.array_equal(r, ref)]
        if not hit:
            raise AssertionError(f"publish_serve: reply {i} is no "
                                 f"version's bit for bit")
        seen[hit[0]] += 1
    newest = os.path.join(pub, f"model_v{v4:06d}.npz")
    manifest, _ = read_bundle(newest)
    # the kernel-library store is off here (phase 19 turns it on): no
    # programs pack beside the bundles, and the reference's manifest
    packed = os.path.exists(newest[:-len(".npz")] + ".programs.npz")
    say(f"  publishing into the graphed scorer engine on {card} "
        f"({loop_s:.2f} s, {len(replies)} replies of 3 rows meanwhile, by "
        f"version {seen}, each one version's bit for bit): events "
        f"{events}; v{v2} (publish.corrupt) refused by the watcher "
        f"{refused}; v{v3} (swap.canary_regress); serving v{final} at the "
        f"end; a programs pack beside it {packed} (the store is off); "
        f"host seconds by publish "
        f"{', '.join(f'{v:.2f}' for v in spent['publish'])} and by tick "
        f"{', '.join(f'{v:.2f}' for v in spent['tick'])} (a tick with a "
        f"candidate scores it on the numpy oracle, {RES_CANARY_ROWS} "
        f"held-out row(s))")
    kinds = [e.split(" ")[0] for e in events]
    if kinds != ["promoted", f"v{v1}", "rejected", "promoted", "rolled"] \
            or not refused or final != v1 or not seen[v1] \
            or packed or "aot_programs" in manifest:
        raise AssertionError("publish_serve: the publish, canary and "
                             "rollback sequence")
    return counts


def drill_shards(directory: str) -> str:
    """The elastic drills' set (``tests/test_torch_elastic.py``'s): 128
    + 32 frames of 6 × 6 over 4 classes, in shards of 32 rows under
    ``directory``; returns the shard directory."""
    import numpy as np
    from znicz_tpu_torch.loader.streaming import write_shards
    rng = np.random.default_rng(21)
    protos = rng.normal(0, 1, (4, 6, 6))
    data = np.concatenate(
        [p + 0.3 * rng.normal(size=(40, 6, 6)) for p in protos])
    data = np.clip((data + 4.0) * 32.0, 0, 255).astype(np.uint8)
    labels = np.repeat(np.arange(4), 40).astype(np.int32)
    order = rng.permutation(len(data))
    data, labels = data[order], labels[order]
    shard_dir = os.path.join(directory, "shards")
    write_shards(shard_dir, data[:128], labels[:128],
                 valid_data=data[128:], valid_labels=labels[128:],
                 rows_per_shard=32)
    return shard_dir


def elastic_card(card: str, tmp: str) -> None:
    """Phase 18 (e): the :class:`ElasticSupervisor` with one-process gangs
    of ``elastic_worker`` on the card (NCCL worlds of one): ``host.preempt``
    at step 23 leads to the checkpoint on signal at the barrier step 24
    and the exit ``EXIT_PREEMPTED``; a restart from that checkpoint ends
    with parameters bit-equal to an uninterrupted run's, run beside the
    preempted one."""
    import threading
    from znicz_tpu_torch.resilience import supervisor as sup
    shard_dir = drill_shards(tmp)

    def gang(tag, faults=None, initial=None):
        work = os.path.join(tmp, tag)
        snaps = os.path.join(work, "snaps")

        def argv_for(pid, n, attempt):
            return [sys.executable, "-m",
                    "znicz_tpu_torch.resilience.elastic_worker",
                    os.path.join(work, f"digest_a{attempt}_p{pid}.json"),
                    shard_dir]

        return sup.ElasticSupervisor(
            argv_for, n_processes=1, work_dir=work, snapshot_dir=snaps,
            snapshot_prefix="elastic", heartbeat_timeout_s=60.0,
            start_grace_s=300.0, poll_interval_s=0.1, max_restarts=0,
            initial_snapshot=initial,
            env={"PYTHONPATH": REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", ""),
                 "ZNICZ_ELASTIC_SNAPSHOT_DIR": snaps,
                 "ZNICZ_HEARTBEAT_INTERVAL_S": "0.2"},
            fault_env=({"ZNICZ_ELASTIC_FAULTS": json.dumps(faults)}
                       if faults else None))

    def digest(g) -> dict:
        with open(os.path.join(g.work_dir, "digest_a0_p0.json")) as fh:
            return json.load(fh)

    ref = gang("uninterrupted")
    drill = gang("preempted", {"host.preempt": {"process": 0, "at": [23]}})
    results, errors, walls = {}, [], {}

    def run(name, g):
        t0 = time.perf_counter()
        try:
            results[name] = g.run()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
        walls[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(name, g))
               for name, g in (("uninterrupted", ref), ("preempted", drill))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors:
        raise errors[0]
    pre = results["preempted"]
    ckpt = sup.newest_good_snapshot(drill.snapshot_dir, "elastic")
    resume = gang("restarted", initial=ckpt)
    run("restarted", resume)
    if errors:
        raise errors[0]
    got, want = digest(resume), digest(ref)
    say(f"  elastic gangs of one on {card}: uninterrupted {walls['uninterrupted']:.1f} s "
        f"({results['uninterrupted'].get('ok')}); preempted at step 23 "
        f"{walls['preempted']:.1f} s: {pre.get('losses')}, "
        f"{pre.get('reason')}, checkpoint {os.path.basename(ckpt or '')}; "
        f"restarted from it {walls['restarted']:.1f} s (spawn to exit, "
        f"resumed at step {results['restarted'].get('resumed_step')}, "
        f"captures of one more step {got['warmed_step_captures']}, "
        f"device {got['device']}); weights sha256 {got['weights_sha256'][:12]}"
        f" against the uninterrupted run's {want['weights_sha256'][:12]}")
    if pre.get("losses") != {"preempt": 1} or not ckpt \
            or "preempt_s24" not in ckpt or not results["restarted"]["ok"] \
            or results["restarted"].get("resumed_step") != 24 \
            or got["resumed_from"] != ckpt \
            or got["warmed_step_captures"] != 0 \
            or got["weights_sha256"] != want["weights_sha256"] \
            or not got["device"].startswith("cuda"):
        raise AssertionError("elastic_card: the preemption drill")
    EAGER["elastic_restart_s"] = walls["restarted"]


def resilience_pass(card: str) -> dict:
    """Phase 18: (a)–(e)."""
    from znicz_tpu_torch.utils.config import root
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths["guard_alexnet"] = guard_alexnet(card, tmp)
        paths["guard_seq"] = guard_seq(card)
        say(f"  (a) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths["guard_lm_accum"] = guard_lm_accum(card)
        say(f"  (b) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sdc_mnist(card)
        say(f"  (c) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths["publish_serve"] = publish_serve(card, tmp)
        say(f"  (d) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        elastic_card(card, tmp)
        say(f"  (e) took {time.perf_counter() - t0:.1f} s")
    root.common.engine.faults = None
    return paths


#: ``(workflow, anomaly_state)`` of each guard built since the last
#: :func:`expect_no_anomalies` (the tensor, not the guard: the workflow
#: may go)
GUARD_STATES: list = []


def track_guards() -> None:
    """Keep each anomaly guard's state tensor as the guard is built."""
    from znicz_tpu_torch.resilience.guard import AnomalyGuard
    init = AnomalyGuard.initialize

    def initialize(self, *args, **kwargs):
        init(self, *args, **kwargs)
        wf = self.workflow
        GUARD_STATES.append((wf.name if wf is not None else self.name,
                             self.anomaly_state))
    AnomalyGuard.initialize = initialize


def drilled(wf) -> None:
    """Leave ``wf``'s guard out of the next :func:`expect_no_anomalies`:
    its run plants a NaN on purpose."""
    state = wf.anomaly_guard.anomaly_state
    GUARD_STATES[:] = [(n, s) for n, s in GUARD_STATES if s is not state]


def expect_no_anomalies(phase: str) -> None:
    """Every guard built since the last call read: a path meant to be
    clean that skipped a step (a non-finite loss or gradient) fails."""
    states = [(name, tuple(int(v) for v in s.tolist()))
              for name, s in GUARD_STATES]
    GUARD_STATES.clear()
    bad = [(name, st) for name, st in states if st[1] or st[2]]
    say(f"  {phase}: {len(states)} guarded workflow(s) read, "
        f"{len(bad)} with anomalous steps")
    if bad:
        raise AssertionError(f"{phase}: anomalous steps (streak, loss, "
                             f"grad) on a clean path: {bad[:6]}")


# ----------------------------------------------------------------------
# phase 19: serving at scale and ops — the fleet on the scorer's graphed
# buckets, the kernel-library store, the web status page
# ----------------------------------------------------------------------
#: request sizes of the fleet's closed loops: every bucket of the ladder
#: of 16, full and padded
FLEET_ROWS = (1, 2, 3, 5, 8, 11, 16)
#: closed-loop requests a turn (a multiple of 4, so the 0.75/0.25 split
#: is exact over it)
FLEET_REQUESTS = 28
#: the decode LM in the fleet: a flat cache, 4 lanes, sequences to 512
FLEET_LM = {"max_slots": 4, "max_t": 512, "max_prompt": 256,
            "paged": False, "max_new_tokens": 16}
#: the shared budget of (c): 7 programs for two ladders of 5
FLEET_BUDGET = 7
#: a child process of (e): builds (or loads) the kernels from the tree
#: it is given, serves the scorer bundle (a path, or the newest bundle a
#: ``PublicationWatcher`` surfaces from a directory) on the card and
#: writes its reply and timings
STORE_CHILD = r"""
import json, os, sys, time
tree, source, xpath, out, mode = sys.argv[1:6]
sys.path.insert(0, tree)
import numpy as np
import torch
from znicz_tpu_torch.ops import _cuda
from znicz_tpu_torch.ops import flash_attention as fa
from znicz_tpu_torch.ops import fused_kernels as fk
from znicz_tpu_torch.serving import ServingEngine, aot_cache
from znicz_tpu_torch.utils.config import root
if os.environ.get("CHILD_FAULTS"):
    root.common.engine.faults = json.loads(os.environ["CHILD_FAULTS"])
bundle = source
if mode == "poll":
    from znicz_tpu_torch.resilience.publisher import PublicationWatcher
    bundle = PublicationWatcher(source, prefix="scorer").poll()[1]
t0 = time.time()
_cuda.build_all()
build_s = time.time() - t0
eng = ServingEngine(bundle, max_batch=16, max_delay_ms=1.0)
eng.start()
y = eng(np.load(xpath), timeout=300)
first = time.time() - float(os.environ["CHILD_T0"])
eng.shutdown()
np.save(out + ".npy", y)
with open(out + ".json", "w") as f:
    json.dump({"first_reply_s": first, "build_s": build_s,
               "store": aot_cache.status(),
               "build_dir": str(_cuda.build_dir()),
               "launches": {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                            "layer_norm_forward": fk.layer_norm_forward.launches,
                            "softmax_argmax": fk.softmax_argmax.launches}}, f)
"""


def fleet_replies_ok(replies, lone: dict, oracle: dict, label: str) -> dict:
    """Each ``(rows, reply)`` is one version's lone-engine reply for the
    same rows (the same bucket) bit for bit, and within ``SLICE_TOL`` of
    that version's CPU reply; returns the replies counted by version."""
    import numpy as np
    served = dict.fromkeys(lone, 0)
    for n, y in replies:
        same = [v for v in lone if np.array_equal(y, lone[v][n])]
        if len(same) != 1:
            raise AssertionError(f"{label}: a {n}-row reply is no one "
                                 f"version's lone-engine reply ({same})")
        err = float(np.abs(y - oracle[same[0]][:n]).max())
        if err > SLICE_TOL:
            raise AssertionError(f"{label}: a {n}-row {same[0]} reply is "
                                 f"{err:.3g} off the CPU's (tol "
                                 f"{SLICE_TOL})")
        served[same[0]] += 1
    return served


def fleet_closed_loop(fleet, x, tenant: str, n_requests: int) -> tuple:
    """``n_requests`` requests of :data:`FLEET_ROWS` rows of ``x`` in
    turn, each after the last reply; the ``(rows, reply)`` pairs and the
    latencies in ms, sorted."""
    out, lat = [], []
    for i in range(n_requests):
        n = FLEET_ROWS[i % len(FLEET_ROWS)]
        t0 = time.perf_counter()
        y = fleet("scorer", x[:n], tenant=tenant, timeout=300)
        lat.append(1e3 * (time.perf_counter() - t0))
        out.append((n, y))
    return out, sorted(lat)


def fleet_captures() -> float:
    """Serving captures so far (``znicz_graph_captures_total{serving:*}``)."""
    from znicz_tpu_torch.observe import metrics
    fam = metrics.REGISTRY.get("znicz_graph_captures_total")
    return sum(float(child.value) for key, child in fam.items()
               if key[0].startswith("serving:"))


def web_checks(fleet, lone, x) -> None:
    """(d): the status page over the fleet on 127.0.0.1, fetched with
    ``urllib``; ``/readyz`` 503 while the lone engine's breaker is held
    open by ``serving.program_error``, 200 again after a probe closes
    it."""
    import urllib.error
    import urllib.request
    from znicz_tpu_torch.utils.config import root
    from znicz_tpu_torch.web_status import WebStatusServer
    server = WebStatusServer(port=0)
    base = f"http://127.0.0.1:{server.port}"

    def get(route):
        try:
            with urllib.request.urlopen(base + route, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    try:
        server.register(fleet)
        server.register(lone)
        code, _ = get("/healthz")
        ready, body = get("/readyz")
        report = json.loads(body)
        tenants = {k: v for k, v in report.get("tenants", {}).items()
                   if k.startswith(f"{fleet._obs_id}/")}
        _, scrape = get("/metrics")
        series = sorted({line.split("{")[0] for line in
                         scrape.decode().splitlines()
                         if line.startswith("znicz_fleet_")})
        say(f"  web page on 127.0.0.1:{server.port}: /healthz {code}, "
            f"/readyz {ready} (tenants {tenants}), /metrics "
            f"{len(series)} znicz_fleet_* series")
        if code != 200 or ready != 200 \
                or {f"{fleet._obs_id}/hi", f"{fleet._obs_id}/lo"} \
                - set(tenants) \
                or "znicz_fleet_requests_total" not in series:
            raise AssertionError(f"web: /healthz {code}, /readyz {ready} "
                                 f"{report.get('reasons')}, {series}")
        root.common.engine.faults = {"serving.program_error": {"after": 1}}
        try:
            for _ in range(4):
                try:
                    lone(x[:1], timeout=300)
                except Exception:  # noqa: BLE001 — the planted failure
                    pass
        finally:
            root.common.engine.faults = None
        held, body = get("/readyz")
        reasons = json.loads(body)["reasons"]
        t_open = time.perf_counter()
        while True:  # the cooldown, then a probe closes the breaker
            try:
                lone(x[:1], timeout=300)
                break
            except Exception:  # noqa: BLE001 — still shedding
                if time.perf_counter() - t_open > 60:
                    raise
                time.sleep(0.05)
        after, _ = get("/readyz")
        say(f"  serving.program_error ×4 on the lone engine: /readyz "
            f"{held} ({reasons}), {after} once a probe closed the breaker")
        if held != 503 or after != 200 or not any(
                "breaker open" in r for r in reasons):
            raise AssertionError(f"web: /readyz {held} then {after}")
    finally:
        server.stop()


def store_checks(tmp: str, path_a: str, x, lone_reply, card: str,
                 build_s: float) -> None:
    """(e): the kernel-library store.  This process fills a fresh store;
    children on a copy of the package with an empty ``build/`` then load
    all nine libraries from it with an ``nvcc`` that refuses to build
    (``--version`` answered by the real one, as the key reads it; every
    build exits 1), rebuild exactly one library after
    ``aotcache.corrupt`` rots its entry, and import a pack that
    ``publish_bundle`` wrote and ``PublicationWatcher`` surfaced (these
    two run together, after the first, whose cold start is timed
    alone).  Every child serves a scorer bundle and its reply must be
    this process's for the same bundle and rows, bit for bit.  The cold start with the
    build is the hit child's with its load replaced by ``build_s``, this
    process's own ``nvcc`` build of phase 1."""
    import numpy as np
    import torch
    from znicz_tpu_torch.ops import _cuda
    from znicz_tpu_torch.resilience.publisher import publish_bundle
    from znicz_tpu_torch.serving import aot_cache
    from znicz_tpu_torch.utils.config import root
    nvcc = _cuda.find_nvcc()
    store = os.path.join(tmp, "store")
    root.common.engine.aot_cache = store
    try:
        t0 = time.perf_counter()
        _cuda.build_all()
        entries = aot_cache.active_cache().entries()
        say(f"  this process filled a fresh store with {len(entries)} "
            f"libraries ({aot_cache.active_cache().total_bytes()} B) in "
            f"{time.perf_counter() - t0:.2f} s")
        if len(entries) != len(_cuda.SOURCES):
            raise AssertionError("store: not every library was stored")
        pub = os.path.join(tmp, "published")
        wf = make_trainer(torch.from_numpy(x).to(torch.bfloat16),
                          np.zeros(BATCH, np.int32), BATCH)
        _, published = publish_bundle(wf, pub, prefix="scorer")
        del wf
        pack = aot_cache._pack_path(published)
        if not os.path.exists(pack):
            raise AssertionError("store: publish_bundle wrote no pack")
    finally:
        root.common.engine.aot_cache = None
    from znicz_tpu_torch.serving import ServingEngine
    with ServingEngine(published, max_batch=BATCH) as eng:
        published_reply = eng(x[:3], timeout=300)
    np.save(os.path.join(tmp, "x3.npy"), x[:3])
    with open(os.path.join(tmp, "child.py"), "w") as f:
        f.write(STORE_CHILD)
    toolkits = {}
    for name, body in (
            ("refusing", f'for a in "$@"; do [ "$a" = "--version" ] && '
                         f'exec {nvcc} --version; done\n'
                         f'echo build >> "$NVCC_LOG"\nexit 1\n'),
            ("logging", f'for a in "$@"; do [ "$a" = "--version" ] && '
                        f'exec {nvcc} --version; done\n'
                        f'echo build >> "$NVCC_LOG"\nexec {nvcc} "$@"\n')):
        home = os.path.join(tmp, f"cuda_{name}")
        os.makedirs(os.path.join(home, "bin"))
        script = os.path.join(home, "bin", "nvcc")
        with open(script, "w") as f:
            f.write("#!/bin/sh\n" + body)
        os.chmod(script, 0o755)
        toolkits[name] = home

    def start(label, toolkit, store_dir, source, mode="serve",
              faults=None):
        """A child on its own copy of the package, started."""
        tree = os.path.join(tmp, f"tree_{label}")
        shutil.copytree(os.path.join(REPO, "znicz_tpu_torch"),
                        os.path.join(tree, "znicz_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        log = os.path.join(tmp, f"nvcc_{label}.log")
        env = dict(os.environ, CUDA_HOME=toolkit, NVCC_LOG=log,
                   CHILD_T0=repr(time.time()))
        env.pop("ZNICZ_AOT_CACHE", None)
        if store_dir is not None:
            env["ZNICZ_AOT_CACHE"] = store_dir
        if faults is not None:
            env["CHILD_FAULTS"] = json.dumps(faults)
        out = os.path.join(tmp, f"out_{label}")
        with open(out + ".log", "w") as stream:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(tmp, "child.py"), tree,
                 source, os.path.join(tmp, "x3.npy"), out, mode],
                cwd=tree, env=env, stdout=stream, stderr=subprocess.STDOUT)
        running.append(proc)
        return label, tree, log, out, proc

    def finish(job, want):
        """The child's exit, its ``nvcc`` builds and its reply, checked."""
        label, tree, log, out, proc = job
        rc = proc.wait(timeout=600)
        if rc != 0:
            with open(out + ".log") as f:
                raise AssertionError(f"store: child {label} exited {rc}:\n"
                                     f"{f.read()[-8000:]}")
        with open(out + ".json") as f:
            info = json.load(f)
        builds = (open(log).read().split() if os.path.exists(log) else [])
        reply = np.load(out + ".npy")
        same = bool(np.array_equal(reply, want))
        say(f"  child {label}: {len(builds)} nvcc build(s), store "
            f"{ {k: info['store'].get(k) for k in ('hits', 'misses', 'corrupt')} }, "
            f"kernels loaded in {info['build_s']:.2f} s, cold start to "
            f"the first reply {info['first_reply_s']:.2f} s, launches "
            f"{info['launches']}, the 3-row reply bit-equal to this "
            f"process's: {same}")
        if not info["build_dir"].startswith(tree):
            raise AssertionError(f"store: child {label} built outside its "
                                 f"tree: {info['build_dir']}")
        if not same or not all(info["launches"].values()):
            raise AssertionError(f"store: child {label}'s reply or "
                                 f"launches {info['launches']}")
        return info, builds

    running: list = []
    try:
        # the hit alone, for its cold start; then the other two together
        hit, builds = finish(start("hit", toolkits["refusing"], store,
                                   path_a), lone_reply)
        if builds or hit["store"]["hits"] != len(_cuda.SOURCES):
            raise AssertionError(f"store: the hit child built {builds}")
        rotted = os.path.join(tmp, "store_rotted")
        shutil.copytree(store, rotted)
        jobs = (start("quarantine", toolkits["logging"], rotted, path_a,
                      faults={"aotcache.corrupt": {"at": [1]}}),
                start("publish", toolkits["refusing"],
                      os.path.join(tmp, "store_cold"), pub, mode="poll"))
        quarantine, builds = finish(jobs[0], lone_reply)
        quarantined = [n for n in os.listdir(rotted)
                       if n.endswith(".quarantined")]
        if len(builds) != 1 or quarantine["store"]["corrupt"] != 1 \
                or not quarantined:
            raise AssertionError(f"store: the quarantine child built "
                                 f"{builds}, quarantined {quarantined}")
        polled, builds = finish(jobs[1], published_reply)
        if builds or polled["store"]["hits"] != len(_cuda.SOURCES):
            raise AssertionError(f"store: the publish child built {builds}")
    finally:
        for proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with_build = hit["first_reply_s"] - hit["build_s"] + build_s
    say(f"  cold start to the first reply ({card}): "
        f"{hit['first_reply_s']:.2f} s with a store hit (the libraries "
        f"loaded in {hit['build_s']:.2f} s); with the nvcc build "
        f"{with_build:.2f} s (the hit's, its load replaced by phase 1's "
        f"build, {build_s:.1f} s)")


def fleet_pass(card: str, decode_lm: str, build_s: float) -> dict:
    """Phase 19.  (a) one ``FleetEngine`` holds the scorer at v1 (two
    replicas) and v2 (perturbed weights) at 0.75/0.25, and the decode LM
    of phase 15 as ``kind="lm"``; tenants ``hi`` (priority 0) and ``lo``
    (priority 2, a token bucket, a deadline, a queue bound).  Every
    scorer reply is one version's lone-engine reply bit for bit (the
    same rows, the same bucket) and within ``SLICE_TOL`` of its CPU
    reply; the split is exact; decode's greedy tokens are a lone
    ``DecodeEngine``'s; hi's p50/p99 alone and under ``fleet.tenant_
    flood``; (b) ``fleet.replica_loss`` repaired with no capture; (c) a
    shared budget smaller than two ladders evicting the low-priority
    model's buckets first, each re-capture counted, the replies right.
    Returns the launches of (a)–(c); then (d) the web page and (e) the
    store (``build_s``: phase 1's build, for the cold start with it)."""
    import threading
    import numpy as np
    from znicz_tpu_torch.export import ExportedModel, read_bundle
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.serving import (DecodeEngine, FleetEngine,
                                         ServingEngine, TenantClass)
    from znicz_tpu_torch.utils.config import root
    rng = np.random.default_rng(SEED + 19)
    x = rng.normal(0.0, 0.3, size=(BATCH, SEQ, DIM)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path_a = os.path.join(tmp, "scorer.npz")
        write_scorer_bundle(path_a)
        manifest, params_a = read_bundle(path_a)
        path_b = write_bundle(os.path.join(tmp, "scorer_b.npz"), manifest,
                              perturbed(params_a, SEED + 191))
        paths = {"v1": path_a, "v2": path_b}
        t0 = time.perf_counter()
        oracle = {}
        for v, p in paths.items():
            cpu = ExportedModel.load(p, device="cpu")
            oracle[v] = np.concatenate([cpu(x[i:i + 4])
                                        for i in range(0, BATCH, 4)])
        say(f"  the CPU's replies for 16 rows of both versions in "
            f"{time.perf_counter() - t0:.1f} s")
        lone, engines = {}, {}
        for v, p in paths.items():
            eng = engines[v] = ServingEngine(p, max_batch=BATCH,
                                             max_delay_ms=1.0,
                                             retry_budget=0,
                                             breaker_cooldown_ms=500.0)
            eng.start()
            lone[v] = {n: eng(x[:n], timeout=300) for n in FLEET_ROWS}
        engines["v2"].shutdown()
        fleet_replies_ok([(n, lone[v][n]) for v in lone for n in FLEET_ROWS],
                         lone, oracle, "lone engines")
        prompts = [[int(t) for t in rng.integers(0, LM_VOCAB, size=n)]
                   for n in (5, 17, 64, 130)]
        lone_lm = DecodeEngine(decode_lm, **FLEET_LM)
        lone_lm.start()
        try:
            want_tokens = [[int(t) for t in lone_lm.submit(p).result(600)]
                           for p in prompts]
        finally:
            lone_lm.shutdown()

        reset_counts()
        captures0 = fleet_captures()
        fleet = FleetEngine(tenants=[
            TenantClass("hi", priority=0),
            TenantClass("lo", priority=2, rate=100.0, burst=BATCH,
                        deadline_ms=250.0, max_queue_rows=BATCH)],
            name="phase19")
        t0 = time.perf_counter()
        # a queue of one full bucket: hi's rows preempt lo's queued ones
        fleet.add_model("scorer", path_a, max_batch=BATCH,
                        max_delay_ms=1.0, max_queue=BATCH, replicas=2)
        fleet.add_version("scorer", path_b, version="v2", max_batch=BATCH,
                          max_delay_ms=1.0, max_queue=BATCH)
        fleet.set_traffic("scorer", {"v1": 0.75, "v2": 0.25})
        fleet.add_model("lm", decode_lm, kind="lm", **FLEET_LM)
        try:
            fleet.start()
            say(f"  fleet of 3 versions started in "
                f"{time.perf_counter() - t0:.2f} s, "
                f"{fleet_captures() - captures0:.0f} serving captures")
            replies, alone = fleet_closed_loop(fleet, x, "hi",
                                               FLEET_REQUESTS)
            split = fleet_replies_ok(replies, lone, oracle, "fleet")
            stats = fleet.stats()["models"]["scorer"]["versions"]
            served = {v: s["served"] for v, s in stats.items()}
            say(f"  {FLEET_REQUESTS} hi requests of {FLEET_ROWS} rows: each "
                f"one version's lone-engine reply bit for bit and within "
                f"{SLICE_TOL} of the CPU's; by version {split} (engines "
                f"{served}), hi alone p50 {pctl(alone, 50):.3f} ms, p99 "
                f"{pctl(alone, 99):.3f} ms")
            want_split = {"v1": FLEET_REQUESTS * 3 // 4,
                          "v2": FLEET_REQUESTS // 4}
            if split != want_split or served != want_split:
                raise AssertionError(f"fleet: the split {split} / "
                                     f"{served} is not {want_split}")
            got_tokens = [[int(t) for t in fleet("lm", p, tenant=t,
                                                 timeout=600)]
                          for p, t in zip(prompts, ("hi", "lo") * 2)]
            say(f"  decode through the fleet: {len(prompts)} prompts, "
                f"greedy tokens equal to a lone DecodeEngine's: "
                f"{got_tokens == want_tokens}")
            if got_tokens != want_tokens:
                raise AssertionError("fleet: decode tokens differ from a "
                                     "lone DecodeEngine's")
            shed0 = sum(e.stats()["resilience"]["shed"]
                        for v in ("v1", "v2") for e in
                        fleet._models["scorer"].versions[v].group.engines())
            root.common.engine.faults = {
                "fleet.tenant_flood": {"after": 1, "n": 32}}
            stop, ticks = threading.Event(), []

            def flood():
                while not stop.is_set():
                    ticks.append(fleet.tick())
                    time.sleep(0.002)

            flooder = threading.Thread(target=flood)
            flooder.start()
            try:
                replies, flooded = fleet_closed_loop(fleet, x, "hi",
                                                     FLEET_REQUESTS)
            finally:
                stop.set()
                flooder.join(300)
                root.common.engine.faults = None
            for n, y in replies:  # coalesced with lo: any bucket
                err = min(float(np.abs(y - oracle[v][:n]).max())
                          for v in oracle)
                if err > SLICE_TOL:
                    raise AssertionError(f"fleet: a flooded {n}-row hi "
                                         f"reply is {err:.3g} off")
            tenants = fleet.stats()["tenants"]
            preempted = sum(e.stats()["resilience"]["shed"]
                            for v in ("v1", "v2") for e in
                            fleet._models["scorer"].versions[v].group
                            .engines()) - shed0
            say(f"  hi under fleet.tenant_flood ({len(ticks)} floods of 32 "
                f"lo rows): p50 {pctl(flooded, 50):.3f} ms, p99 "
                f"{pctl(flooded, 99):.3f} ms (alone {pctl(alone, 50):.3f} / "
                f"{pctl(alone, 99):.3f}); lo submitted "
                f"{tenants['lo']['submitted']}, served "
                f"{tenants['lo']['served']}, shed {tenants['lo']['shed']} "
                f"(of which preempted in the engines {preempted}), expired "
                f"{tenants['lo']['expired']}; hi shed "
                f"{tenants['hi']['shed']}, failed {tenants['hi']['failed']}")
            if tenants["hi"]["shed"] or tenants["hi"]["failed"] \
                    or not tenants["lo"]["shed"]:
                raise AssertionError(f"fleet: isolation {tenants}")

            group = fleet._models["scorer"].versions["v1"].group
            target = group.target  # 2, or more if the flood scaled it up
            before = fleet_captures()
            root.common.engine.faults = {"fleet.replica_loss": {"at": [1]}}
            try:
                t0 = time.perf_counter()
                events = fleet.tick()
                repair_ms = 1e3 * (time.perf_counter() - t0)
            finally:
                root.common.engine.faults = None
            replies, _ = fleet_closed_loop(fleet, x, "hi", 8)
            fleet_replies_ok(replies, lone, oracle, "after the repair")
            say(f"  fleet.replica_loss: {events}; the tick that killed and "
                f"repaired took {repair_ms:.1f} ms, {group.live()} live "
                f"replicas of {target}, serving captures "
                f"{fleet_captures() - before:.0f} new, 8 requests served")
            if group.live() != target or fleet_captures() != before \
                    or not any("repaired" in e for e in events):
                raise AssertionError("fleet: the repair")
        finally:
            fleet.shutdown()
            root.common.engine.faults = None

        budget = FleetEngine(tenants=[TenantClass("hi", priority=0),
                                      TenantClass("lo", priority=2)],
                             max_programs=FLEET_BUDGET, autoscale=False,
                             name="phase19_budget")
        budget.add_model("premium", path_a, priority=0, max_batch=BATCH,
                         max_delay_ms=1.0)
        budget.add_model("cheap", path_b, priority=2, max_batch=BATCH,
                         max_delay_ms=1.0)
        try:
            before = fleet_captures()
            budget.start()
            st = budget.budget.stats()
            evicted = metrics.fleet_ladder_evictions(
                "phase19_budget", "cheap@v1").value
            say(f"  shared budget of {FLEET_BUDGET} programs over two "
                f"ladders of 5: {st['per_model']} resident after start, "
                f"{evicted:.0f} of cheap's evicted, "
                f"{fleet_captures() - before:.0f} captures")
            if st["per_model"] != {"premium@v1": 5, "cheap@v1": 2}:
                raise AssertionError(f"budget: {st['per_model']}")
            before = fleet_captures()
            got = {}
            for model_id, v in (("premium", "v1"), ("cheap", "v2")):
                for n in (1, 3, 16):
                    got[model_id, n] = budget(model_id, x[:n], tenant="hi",
                                              timeout=300)
                    if not np.array_equal(got[model_id, n], lone[v][n]):
                        raise AssertionError(f"budget: {model_id}'s {n}-row "
                                             f"reply")
            recaptures = fleet_captures() - before
            evicted = metrics.fleet_ladder_evictions(
                "phase19_budget", "cheap@v1").value
            say(f"  then 1, 3 and 16 rows on each: premium replayed, cheap "
                f"re-captured {recaptures:.0f} bucket(s) (counted on "
                f"znicz_graph_captures_total), {evicted:.0f} evictions of "
                f"cheap in all, none of premium, every reply its lone "
                f"engine's bit for bit")
            if recaptures < 1 or metrics.fleet_ladder_evictions(
                    "phase19_budget", "premium@v1").value:
                raise AssertionError("budget: the re-captures")
        finally:
            budget.shutdown()
        counts = read_counts()
        fwd = counts["flash_attention_fwd"]
        expect_counts("fleet", counts, {"flash_attention_fwd": fwd,
                                        "layer_norm_forward": fwd,
                                        "softmax_argmax_small": fwd})
        expect_ln_register("fleet")
        expect_new_routes("fleet")
        if not fwd:
            raise AssertionError("fleet: no kernel launched")

        try:
            fleet = FleetEngine(tenants=[TenantClass("hi", priority=0),
                                         TenantClass("lo", priority=2)],
                                autoscale=False, name="phase19_web")
            fleet.add_model("scorer", path_a, max_batch=BATCH,
                            max_delay_ms=1.0)
            with fleet:
                fleet("scorer", x[:1], tenant="hi", timeout=300)
                web_checks(fleet, engines["v1"], x)
        finally:
            engines["v1"].shutdown()
        store_checks(tmp, path_a, x, lone["v1"][3], card, build_s)
    return counts


# ----------------------------------------------------------------------
# phase 20: disaggregated decode — prefill and decode pools over private
# paged caches, the page handoff through pinned staging, the host-DRAM
# spill tier, PoolAutoscaler
# ----------------------------------------------------------------------
#: the pools: two of each at start, four at most (the caches the model
#: plans beside its own); the autoscaler repairs only (its thresholds out
#: of reach), so the interference arm keeps its pool sizes
DISAGG_POOLS = {"prefill_replicas": 2, "decode_replicas": 2,
                "max_prefill_replicas": 4, "max_decode_replicas": 4,
                "handoff_retry_budget": 3, "max_queue_tokens": 10 ** 7,
                "autoscale": True, "queue_age_up_s": 1e9,
                "idle_down_s": 1e9}
#: the interference arm: DISAGG_LANES lanes decode DISAGG_NEW tokens from
#: DISAGG_PROMPT-token prompts while DISAGG_BURST prompts of the longest
#: length land once a quarter of the lanes' tokens are out (one new token
#: each, as the reference's benchmark: the burst adds prefill work only);
#: a round is a pass without the burst and one with it, for each engine
#: in turns
DISAGG_LANES, DISAGG_PROMPT, DISAGG_NEW = 8, 64, 512
DISAGG_BURST, DISAGG_ROUNDS = 16, 3
#: the spill arm: SPILL_FAMILIES system prompts of SPILL_PREFIX tokens,
#: each served twice with a SPILL_TAIL-token tail and SPILL_NEW new
#: tokens, one request at a time, through pools of SPILL_POOL tokens (a
#: quarter of the families' pages) with SPILL_FRAMES host frames behind
#: each prefill worker's trie, against pools at their default size
SPILL_FAMILIES, SPILL_PREFIX, SPILL_TAIL, SPILL_NEW = 32, 256, 32, 16
SPILL_POOL, SPILL_FRAMES = 2048, 2048
#: the chaos arm's dropped handoffs (arrival numbers at the site)
DROP_AT = (2, 5, 9)
#: page copies timed a measurement (the 1024-token prompt's 64 pages)
COPY_PAGES, COPY_REPEATS = 64, 10


def parted_at_ties(label: str, path: str, got, want, prompts, geometry,
                   kwargs) -> int:
    """Two runs' greedy tokens on the same prompts: where a pair parts,
    the CPU's top-two logit margin there must be under ``TIE_TOL``.
    Returns how many pairs parted at such a tie."""
    ties = 0
    for p, g, w in zip(prompts, got, want):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        margin = cpu_margin(path, p, w[:i], geometry, kwargs)
        say(f"  {label}: a {len(p)}-token prompt parts at token {i} "
            f"({g[i:i + 3]} against {w[i:i + 3]}), the CPU's top-two "
            f"margin there {margin:.3g} (tie bound {TIE_TOL})")
        if margin >= TIE_TOL:
            raise AssertionError(f"{label}: greedy tokens differ with a "
                                 f"margin of {margin}")
        ties += 1
    return ties


def disagg_engine(path: str, geometry=DECODE_GEOMETRY, **kwargs):
    from znicz_tpu_torch.serving import DisaggEngine
    return DisaggEngine(path, **{**geometry, **DISAGG_POOLS, **kwargs})


def expect_disagg_graphed(eng, label: str) -> None:
    """On the card, every program of the shared model is a captured
    graph (no eager fallback), and the pools' staging is page-locked."""
    model = eng.model
    st = eng.stats()
    say(f"  {label}: {st['programs_live']} programs resident, "
        f"{st['captures']} captured in {st['warmup_seconds']:.2f} s, "
        f"caches {st['caches']}, pools prefill "
        f"{st['pools']['prefill']['live']} + decode "
        f"{st['pools']['decode']['live']}")
    if model.device.type != "cuda" or not model.graphed \
            or not st["captures"] == st["programs_live"] > 0:
        raise AssertionError(f"{label}: not graphed on the card ({st})")
    if not eng._stager.cuda or not all(r.pinned
                                       for r in eng._stager.rings):
        raise AssertionError(f"{label}: staging not page-locked")


def interference_pass(eng, lanes, burst) -> tuple[float, float, list]:
    """One pass: the lanes decode DISAGG_NEW tokens each, the burst (if
    any) submitted once a quarter of their tokens are out.  Returns the
    pass's per-token p99 and longest gap in ms (a few stalls of the
    lanes' ~4,000 gaps stay under the p99), and the lanes' tokens."""
    from znicz_tpu_torch.observe import metrics
    eng._token_win.clear()
    futs = [eng.submit(p, max_new_tokens=DISAGG_NEW) for p in lanes]
    bf = []
    if burst:
        mark = len(lanes) * DISAGG_NEW // 4
        deadline = time.monotonic() + 120
        while len(eng._token_win) < mark and time.monotonic() < deadline:
            time.sleep(0.001)
        bf = [eng.submit(b, max_new_tokens=1) for b in burst]
    outs = [[int(t) for t in f.result(timeout=600)] for f in futs]
    for f in bf:
        f.result(timeout=600)
    return (1e3 * metrics.window_p99(eng._token_win),
            1e3 * max(eng._token_win), outs)


def spill_arm(path: str, prompts, kwargs) -> tuple[list, dict]:
    """The spill arm's requests one at a time through a disaggregated
    engine with one prefill worker (one trie sees every prompt)."""
    with disagg_engine(path, prefill_replicas=1, decode_replicas=1,
                       max_new_tokens=SPILL_NEW, **kwargs) as eng:
        outs = [[int(t) for t in eng.generate(p, timeout=600)]
                for p in prompts]
        st = eng.stats()
        tier = eng.prefill_pool.engines()[0]._spill
        if tier is not None and not tier.pinned:
            raise AssertionError("the host tier's frames are not "
                                 "page-locked")
        pool_pages = eng.model.cache.pool_pages
        if not eng.balanced():
            raise AssertionError("spill arm: the token budget is "
                                 "unbalanced")
    pc = st["prefix_cache"]
    pc["pool_pages"] = pool_pages
    pc["hit_rate"] = pc["hits"] / max(1, pc["hits"] + pc["misses"])
    return outs, pc


def copy_costs(eng, card: str) -> dict:
    """(f): the handoff's and the restore's copies, timed on the host
    clock around synchronized work: the export of a 1024-token prompt's
    pages (one gather and one fenced copy a pool), their landing one page
    at a time (the staging ring's upload, then the ``page_in`` replay),
    a spill (one page exported into a host frame) and a restore (a frame
    through the ring and ``page_in``)."""
    import numpy as np
    import torch
    from znicz_tpu_torch.memory import HostPageTier
    model = eng.model
    cache = model.make_cache()
    tier = HostPageTier(model.page_shapes(), COPY_PAGES,
                        targets=model.page_stage)
    try:
        pids = [cache.alloc_page() for _ in range(COPY_PAGES)]
        page_bytes = sum(int(np.prod(s)) * np.dtype(d).itemsize
                         for s, d in model.page_shapes())

        def per_page(fn, pages_a_call: int) -> float:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(COPY_REPEATS):
                fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / (COPY_REPEATS
                                                       * pages_a_call)

        held: list = []

        def export():
            held[:] = model.export_pages(pids, cache=cache)

        def land():
            for pid, page in zip(pids, held):
                with model.dispatch_lock:
                    staged = eng._stager.upload(page)
                    model.page_in(staged, pid, cache=cache)

        def spill():
            for pid in pids:
                hid = tier.store(model.export_page(pid, cache=cache))
                tier.free(hid)

        out = {"page_bytes": page_bytes,
               "export_ms": per_page(export, COPY_PAGES),
               "land_ms": per_page(land, COPY_PAGES),
               "spill_ms": per_page(spill, COPY_PAGES)}
        hids = [tier.store(p) for p in held]

        def restore():
            for pid, hid in zip(pids, hids):
                with model.dispatch_lock:
                    model.page_in(tier.upload(hid), pid, cache=cache)

        out["restore_ms"] = per_page(restore, COPY_PAGES)
        # the landed pages hold what was exported, bit for bit
        back = model.export_pages(pids, cache=cache)
        for a, b in zip(back, held):
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError("a page landed through the staging "
                                     "ring differs from its export")
    finally:
        tier.shutdown()
        model.release_cache(cache)
    handoff_ms = out["export_ms"] + out["land_ms"]
    shapes = " + ".join(f"{'×'.join(map(str, s))} {np.dtype(d).name}"
                        for s, d in model.page_shapes())
    say(f"  (f) copies on {card}, {out['page_bytes']} B a page ({shapes}): "
        f"handoff {handoff_ms:.4f} ms a "
        f"page (export {out['export_ms']:.4f}, batched over "
        f"{COPY_PAGES}; landing {out['land_ms']:.4f}, a page at a time), "
        f"{out['page_bytes'] / handoff_ms / 1e6:.3f} GB/s; spill "
        f"{out['spill_ms']:.4f} ms a page; restore "
        f"{out['restore_ms']:.4f} ms a page "
        f"({out['page_bytes'] / out['restore_ms'] / 1e6:.3f} GB/s)")
    return out


def disagg_pass(card: str, path: str, lstm: str) -> dict:
    """Phase 20 on phase 15's decode LM at its full width and geometry
    (16 lanes, max_t 2048, prompts to 1024, 16-token pages) through
    ``DisaggEngine``: 2 prefill and 2 decode workers over private caches,
    at most 4 of each.  (a) greedy tokens equal to the fused engine's on
    the card and to the CPU engine's (ties within ``TIE_TOL``), prefix
    sharing and copy on write in the prefill workers, the LSTM chain's
    carry handoff; (b) a scale-up from 2 to 4 decode workers and the
    repair of a killed one by ``PoolAutoscaler`` capture nothing; (c) the
    interference arm, fused against disagg in turns (a finding, not a
    gate); (d) the spill arm; (e) dropped handoffs retried, the budget
    balanced; (f) the copies' costs.  Decode runs none of B1–B9."""
    import numpy as np
    import torch
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.utils.config import root
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    cpu_prompts = [[int(t) for t in rng.integers(0, LM_VOCAB, size=n)]
                   for n in CPU_LENGTHS]
    system = [int(t) for t in rng.integers(0, LM_VOCAB,
                                           size=PREFIX_SYSTEM)]
    half = PREFIX_SYSTEM // 2
    prefix_prompts = [system + [int(t) for t in rng.integers(
        0, LM_VOCAB, size=n)] for n in PREFIX_TAILS] \
        + [system[:half] + [1, 2, 3], system[:half + 7] + [9] * 30]
    rng = np.random.default_rng(SEED + 20)
    fused = decode_engine(path, max_queue_tokens=10 ** 7)
    fused.start()
    eng = disagg_engine(path)
    eng.start()
    try:
        expect_disagg_graphed(eng, "disagg")
        # (a) the tokens
        ta = time.perf_counter()
        ties = {}
        got = generate_all(eng, cpu_prompts, CPU_NEW)
        want = generate_all(fused, cpu_prompts, CPU_NEW)
        ties["disagg = fused"] = parted_at_ties(
            "disagg against fused", path, got, want, cpu_prompts,
            DECODE_GEOMETRY, {})
        ties["disagg = CPU"] = tokens_vs_cpu(
            "disagg", path, eng, cpu_prompts, CPU_NEW, DECODE_GEOMETRY, {})
        ties["prefix sharing"] = tokens_vs_cpu(
            "disagg + prefix sharing", path, eng, prefix_prompts, CPU_NEW,
            DECODE_GEOMETRY, {})
        pc = eng.stats()["prefix_cache"]
        if not pc["hits"]:
            raise AssertionError(f"no prefix hit in the prefill pool: {pc}")
        lstm_rng = np.random.default_rng(SEED + 23)
        lstm_prompts = [[int(t) for t in lstm_rng.integers(0, LM_VOCAB,
                                                           size=n)]
                        for n in LSTM_CPU_LENGTHS[::2]]
        with disagg_engine(lstm, LSTM_DECODE_GEOMETRY) as leng:
            expect_disagg_graphed(leng, "disagg LSTM")
            if "carry-in" not in leng.model._programs["carry-in"]:
                raise AssertionError("the LSTM chain's carry_in program "
                                     "was not captured")
            ties["LSTM"] = tokens_vs_cpu(
                "disagg LSTM (carry handoff)", lstm, leng, lstm_prompts,
                CPU_NEW, LSTM_DECODE_GEOMETRY, {})
            lst = leng.stats()
            if not lst["handoffs"]["total"] or not leng.balanced():
                raise AssertionError(f"LSTM handoffs: {lst['handoffs']}")
        say(f"  (a) took {time.perf_counter() - ta:.1f} s; sequences "
            f"ended at a tie: {ties}; prefix hits {pc['hits']} of "
            f"{pc['hits'] + pc['misses']}")
        # (b) scale-up and repair capture nothing
        tb = time.perf_counter()
        caps, model_caps = capture_metric(), eng.model.captures
        eng.decode_pool.scale_to(4, "scale-up")
        if eng.decode_pool.live() != 4:
            raise AssertionError("the decode pool did not grow to 4")
        eng.decode_pool.kill_one()
        deadline = time.monotonic() + 60
        while eng.decode_pool.live() < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        repaired_s = time.perf_counter() - tb
        again = generate_all(eng, cpu_prompts, CPU_NEW)
        ties["after scale-up and repair"] = parted_at_ties(
            "disagg after scale-up and repair", path, again, got,
            cpu_prompts, DECODE_GEOMETRY, {})
        new_caps = capture_metric() - caps
        say(f"  (b) decode pool 2 → 4, one killed and repaired by "
            f"PoolAutoscaler to {eng.decode_pool.live()} in "
            f"{repaired_s:.2f} s: {new_caps:.0f} new captures "
            f"(model {model_caps} → {eng.model.captures}), caches "
            f"{eng.stats()['caches']}")
        if eng.decode_pool.live() != 4 or new_caps \
                or eng.model.captures != model_caps:
            raise AssertionError("scale-up or repair captured a graph or "
                                 "failed")
        eng.decode_pool.scale_to(2, "back")
        # (c) interference
        lanes = [[int(t) for t in rng.integers(0, LM_VOCAB,
                                               size=DISAGG_PROMPT)]
                 for _ in range(DISAGG_LANES)]
        burst = [[int(t) for t in rng.integers(
            0, LM_VOCAB, size=DECODE_GEOMETRY["max_prompt"])]
            for _ in range(DISAGG_BURST)]
        tc = time.perf_counter()
        arms = {"fused": fused, "disagg": eng}
        for e in arms.values():
            interference_pass(e, lanes, burst)  # warm
        rows: dict = {k: [] for k in arms}
        outs: dict = {}
        for r in range(DISAGG_ROUNDS):
            order = list(arms) if r % 2 == 0 else list(arms)[::-1]
            for name in order:
                base, base_max, o1 = interference_pass(arms[name], lanes,
                                                       [])
                hit, hit_max, o2 = interference_pass(arms[name], lanes,
                                                     burst)
                rows[name].append((base, hit, hit / base, base_max,
                                   hit_max))
                outs.setdefault(name, o1)
                ties[f"{name} burst"] = ties.get(f"{name} burst", 0) \
                    + parted_at_ties(f"{name} with the burst", path, o2,
                                     o1, lanes, DECODE_GEOMETRY, {})
        ties["interference disagg = fused"] = parted_at_ties(
            "interference, disagg against fused", path, outs["disagg"],
            outs["fused"], lanes, DECODE_GEOMETRY, {})
        inter = {}
        for name, rs in rows.items():
            med = sorted(rs, key=lambda x: x[2])[len(rs) // 2]
            inter[name] = {"base_p99_ms": med[0], "burst_p99_ms": med[1],
                           "ratio": med[2],
                           "pairs": [[round(a, 4), round(b, 4)]
                                     for a, b, *_ in rs],
                           "longest_gap_ms": [[round(a, 3), round(b, 3)]
                                              for *_, a, b in rs]}
        say(f"  (c) interference on {card} ({DISAGG_LANES} lanes × "
            f"{DISAGG_NEW} tokens, a burst of {DISAGG_BURST} × "
            f"{DECODE_GEOMETRY['max_prompt']}-token prompts, in turns, "
            f"median of {DISAGG_ROUNDS}): per-token p99 without / with "
            f"the burst: fused {inter['fused']['base_p99_ms']:.3f} / "
            f"{inter['fused']['burst_p99_ms']:.3f} ms "
            f"({inter['fused']['ratio']:.3f}×), disagg "
            f"{inter['disagg']['base_p99_ms']:.3f} / "
            f"{inter['disagg']['burst_p99_ms']:.3f} ms "
            f"({inter['disagg']['ratio']:.3f}×); pairs {inter}; "
            f"{time.perf_counter() - tc:.1f} s")
        # (e) dropped handoffs
        te = time.perf_counter()
        before = eng.stats()["handoffs"]
        root.common.engine.faults = {"disagg.handoff_drop":
                                     {"at": list(DROP_AT)}}
        try:
            chaos = generate_all(eng, cpu_prompts + prefix_prompts, CPU_NEW)
        finally:
            root.common.engine.faults = None
        after = eng.stats()["handoffs"]
        dropped = after["dropped"] - before["dropped"]
        retried = after["retried"] - before["retried"]
        ties["chaos"] = parted_at_ties(
            "disagg under dropped handoffs", path, chaos[:len(cpu_prompts)],
            got, cpu_prompts, DECODE_GEOMETRY, {})
        say(f"  (e) {dropped} handoffs dropped, {retried} retried on a "
            f"fresh prefill, balanced() {eng.balanced()}, "
            f"{time.perf_counter() - te:.1f} s")
        if dropped != len(DROP_AT) or retried != dropped \
                or not eng.balanced():
            raise AssertionError("dropped handoffs were not retried "
                                 "exactly once each with the budget "
                                 "balanced")
        # (f) the copies
        copy_costs(eng, card)
        st = eng.stats()
        phase_p99 = {p: round(1e3 * metrics.window_p99(w), 4)
                     for p, w in eng._phase_win.items()}
        say(f"  disagg: {st['handoffs']}; phase p99 ms {phase_p99}; "
            f"TTFT {st['ttft_ms']}; token {st['token_ms']}")
    finally:
        eng.shutdown()
        fused.shutdown()
    # (d) the spill arm
    td = time.perf_counter()
    families = [[int(t) for t in rng.integers(0, LM_VOCAB,
                                              size=SPILL_PREFIX)]
                for _ in range(SPILL_FAMILIES)]
    spill_prompts = [f + [int(t) for t in rng.integers(0, LM_VOCAB,
                                                       size=SPILL_TAIL)]
                     for _ in range(2) for f in families]
    all_outs, all_pc = spill_arm(path, spill_prompts, {})
    sp_outs, sp_pc = spill_arm(path, spill_prompts,
                               {"pool_tokens": SPILL_POOL,
                                "spill_pages": SPILL_FRAMES})
    working = SPILL_FAMILIES * SPILL_PREFIX // DECODE_GEOMETRY["page_tokens"]
    ratio = working / sp_pc["pool_pages"]
    ties["spill"] = parted_at_ties("spill arm against the all-device pool",
                                   path, sp_outs, all_outs, spill_prompts,
                                   DECODE_GEOMETRY, {})
    say(f"  (d) spill arm: {working} family pages over a {sp_pc['pool_pages']}"
        f"-page pool ({ratio:.1f}×), {SPILL_FRAMES} host frames: hit rate "
        f"{sp_pc['hit_rate']:.4f} against {all_pc['hit_rate']:.4f} on an "
        f"all-device pool; migrations {sp_pc['migrations']}; "
        f"{time.perf_counter() - td:.1f} s")
    if ratio < 4 or not sp_pc["migrations"]["restore"] \
            or sp_pc["hit_rate"] < 0.9 * all_pc["hit_rate"]:
        raise AssertionError(f"spill arm: {sp_pc} against {all_pc}")
    launches = read_counts()
    expect_counts("disagg", launches, {})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"  sequences ended at a tie, by arm: {ties}")
    say(f"  phase 20 on {card}: peak device memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------------------
# phase 21: the report chain — the plotters, the report publisher, the
# aux units and the forge, on the graphed step
# ----------------------------------------------------------------------
#: MNIST's epochs in each turn of the side-unit arm
REPORT_EPOCHS = 3
#: the turns of the side-unit arm: (side units linked, run_chunked's
#: steps a dispatch or 1 for ``run``); the two ``run`` turns with the
#: units bracket the two without, and the chunked turn comes last
REPORT_TURNS = ((True, 1), (False, 1), (False, 1), (True, 1), (True, 8))
#: the plotters the side-unit arm links, by unit name (the multi
#: histogram draws no PNG in either package: its payload kind has no
#: drawing, as in the reference)
REPORT_PLOTTERS = ("error_plotter", "confusion_matrix", "weights2d_l0",
                   "weights_hist")
REPORT_PNGS = ("confusion_matrix.png", "error_plotter.png",
               "weights2d_l0.png")
#: the short graphed runs of the hit map and the MSE histogram (epochs)
HITS_EPOCHS, AE_HIST_EPOCHS = 2, 1
#: the splitter's input: a minibatch of 100 RGB 28 × 28 frames, split
#: into three towers (one repeats and permutes channels)
SPLIT_SHAPE = (100, 28, 28, 3)
SPLIT_GROUPS = ([0], [1, 2], [2, 0, 1])
SPLIT_REPLAYS = 4
#: the Wine bundle's epochs, forge versions and served rows
FORGE_EPOCHS = 5
FORGE_VERSIONS = ("1.0.0", "1.1.0")
FORGE_ROWS = (1, 3, 10)


def graphics_probe() -> dict:
    """The graphics service's optional libraries on this machine: name →
    version, or None where the import fails."""
    import importlib
    found = {}
    for lib in ("matplotlib", "zmq"):
        try:
            found[lib] = getattr(importlib.import_module(lib),
                                 "__version__", "?")
        except ImportError:
            found[lib] = None
    return found


def report_root(tmp: str, render: bool) -> None:
    """The plots and the reports under ``tmp``, the render thread on or
    off (``--no-graphics``), the process's graphics server dropped."""
    from znicz_tpu_torch import graphics
    from znicz_tpu_torch.utils.config import root
    graphics.reset_server()
    root.common.dirs.plots = os.path.join(tmp, "plots")
    root.common.dirs.cache = tmp
    root.common.graphics.render = render


def epoch_marks(wf, device_events: bool) -> list:
    """A mark at each epoch's end, recorded where the decision decides
    (before the side units fire): a CUDA event on the card, the host
    clock elsewhere; the caller adds the mark before the run."""
    import torch

    def mark():
        if not device_events:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    marks = [mark()]
    decide = wf.decision.decide

    def decide_and_mark():
        decide()
        if wf.decision.epoch_ended:
            marks.append(mark())

    wf.decision.decide = decide_and_mark
    return marks


def epoch_ms(marks: list, steps: int, device_events: bool) -> list:
    """Each epoch's time a step, ms, from :func:`epoch_marks`."""
    import torch
    if device_events:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / steps for a, b in zip(marks, marks[1:])]
    return [1e3 * (b - a) / steps for a, b in zip(marks, marks[1:])]


def report_turn(tmp: str, side: bool, chunk: int, render: bool,
                device=None) -> dict:
    """One turn of the side-unit arm: MNIST 784-100-10 (f32, B = 100) from
    ``SEED`` for ``REPORT_EPOCHS`` with the confusion counts, graphed on
    the card, by ``run`` or ``run_chunked(chunk)``; with ``side``, the
    error, confusion and weights plotters, a weight histogram and the
    report publisher (md, html, json) linked after the decision."""
    import torch
    from znicz_tpu_torch.models.samples import mnist
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.ops.aux_units import MultiHistogram
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root
    reset_root()
    report_root(tmp, render)
    prng.seed_all(SEED)
    wf = mnist.build(max_epochs=REPORT_EPOCHS)
    wf.evaluator.compute_confusion = True
    if side:
        wf.link_error_plotter()
        wf.link_confusion_plotter()
        wf.link_weights_plotter(sample_shape=(28, 28))
        wf.link_publisher(formats=("md", "html", "json"))
    wf.initialize(device=device)
    if side:  # its weights exist once the forwards are initialized
        hist = MultiHistogram(wf, name="weights_hist")
        hist.watch_workflow_weights()
        wf._epoch_side_unit(hist)
    on_card = wf.device.type == "cuda"
    before = metrics.graph_captures("train_region").value
    marks = epoch_marks(wf, on_card)
    reset_counts()
    t0 = time.perf_counter()
    if chunk > 1:
        wf.run_chunked(chunk)
    else:
        wf.run()
    if on_card:
        torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    out = {"wf": wf, "launches": read_counts(), "host_s": host_s,
           "step_ms": epoch_ms(marks, MNIST_STEPS, on_card),
           "captures": wf.region.captures, "graphed": on_card,
           "counter": metrics.graph_captures("train_region").value - before,
           "params": {k: v.numpy() for k, v in params_of(wf).items()}}
    return out


def report_checks(turn: dict, tmp: str, render: bool, chunk: int) -> dict:
    """What one turn with the side units must show: a line an epoch a
    plotter in ``events.jsonl``, the confusion matrix's trace the
    validation count less the last epoch's errors, the report fired once
    with the decision's metrics and this run's PNGs (none claimed without
    the render thread); returns the host ms of one epoch's firing of
    the plotters and the publisher's ms."""
    import numpy as np
    from znicz_tpu_torch import graphics
    from znicz_tpu_torch.loader.base import VALID
    wf = turn["wf"]
    if not graphics.flush_server():
        raise AssertionError("report: the render thread did not drain")
    plots = os.path.join(tmp, "plots")
    events = [json.loads(line)
              for line in open(os.path.join(plots, "events.jsonl"))]
    by_name = sorted(e["name"] for e in events)
    want = sorted(REPORT_PLOTTERS * REPORT_EPOCHS)
    if by_name != want:
        raise AssertionError(f"report (chunk {chunk}): events.jsonl has "
                             f"{by_name}, want {want}")
    cm = wf.decision.confusion_matrixes[VALID]
    n_valid = wf.loader.class_lengths[VALID]
    if int(cm.sum()) != n_valid or int(np.trace(cm)) != \
            n_valid - wf.decision.last_epoch_n_err[VALID]:
        raise AssertionError(f"report: confusion matrix trace "
                             f"{np.trace(cm)} of {cm.sum()}, last epoch's "
                             f"errors {wf.decision.last_epoch_n_err}")
    pub = wf.publisher
    if pub.run_count != 1 or len(pub.destinations) != 3:
        raise AssertionError(f"report (chunk {chunk}): the publisher fired "
                             f"{pub.run_count} time(s)")
    blob = json.load(open(pub.destinations[-1]))
    metrics = {"epochs": wf.loader.epoch_number,
               "best validation error %":
                   float(wf.decision.min_validation_n_err_pt)}
    if blob["metrics"] != metrics:
        raise AssertionError(f"report: metrics {blob['metrics']}, the "
                             f"decision's {metrics}")
    pngs = sorted(f for f in os.listdir(plots) if f.endswith(".png"))
    claimed = sorted(os.path.basename(p) for p in blob["plots"])
    want_pngs = sorted(REPORT_PNGS) if render else []
    if pngs != want_pngs or claimed != want_pngs:
        raise AssertionError(f"report: PNGs {pngs}, the report claims "
                             f"{claimed}, want {want_pngs}")
    page = open(pub.destinations[1]).read()
    if render != ("data:image/png;base64," in page):
        raise AssertionError("report: the html embeds the wrong plots")
    fire_ms = sum(1e3 * u.run_time_total / u.run_count
                  for u in wf.units if u.name in REPORT_PLOTTERS)
    return {"fire_ms": fire_ms, "publish_ms": 1e3 * pub.run_time_total,
            "events": len(events), "pngs": claimed}


def report_arm(card: str, render: bool, device=None) -> dict:
    """(a) The turns of :data:`REPORT_TURNS`: the side units capture
    nothing more, leave the weights bit-equal to a run without them,
    and fire as they should under ``run`` and ``run_chunked``; the step
    time with and without them (median of the epochs) and the host time
    of their firing."""
    import numpy as np
    turns = []
    for i, (side, chunk) in enumerate(REPORT_TURNS):
        tmp = tempfile.mkdtemp(prefix=f"report{i}_")
        try:
            turn = report_turn(tmp, side, chunk, render, device)
            if side:
                turn.update(report_checks(turn, tmp, render, chunk))
            turn["side"], turn["chunk"] = side, chunk
            del turn["wf"]
            turns.append(turn)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    plain = [t for t in turns if not t["side"]]
    keys = 3 if turns[0]["graphed"] else 0  # one a key (none eager)
    for t in turns:
        if (t["captures"], t["counter"]) != (keys, keys):
            raise AssertionError(f"report: captures {t['captures']} "
                                 f"(counter {t['counter']:.0f}) with side "
                                 f"units {t['side']}, chunk {t['chunk']}; "
                                 f"want {keys} (one a key)")
        if t["chunk"] == 1:
            bad = [k for k, v in plain[0]["params"].items()
                   if not np.array_equal(v, t["params"][k])]
            if bad:
                raise AssertionError(f"report: parameters {bad} differ "
                                     f"between the runs with and without "
                                     f"the side units")
    steps = REPORT_EPOCHS * MNIST_STEPS
    expect_counts("report_mnist", turns[0]["launches"],
                  {"softmax_argmax_cifar": steps})
    med = {side: [float(np.median(t["step_ms"])) for t in turns
                  if t["side"] == side and t["chunk"] == 1]
           for side in (True, False)}
    fire = [t["fire_ms"] for t in turns if t["side"]]
    pub = [t["publish_ms"] for t in turns if t["side"]]
    say(f"  report arm, MNIST 784-100-10 f32 B={MNIST_BATCH}, "
        f"{REPORT_EPOCHS} epochs a turn, graphed, render thread "
        f"{'on' if render else 'off (no matplotlib: --no-graphics)'}: "
        f"captures {[t['captures'] for t in turns]} by turn (side units "
        f"{[t['side'] for t in turns]}, chunk {[t['chunk'] for t in turns]}"
        f"), the parameters bit-equal with and without the side units, "
        f"{turns[0]['events']} events.jsonl lines a run, the report fired "
        f"once under run and under run_chunked({REPORT_TURNS[-1][1]}), its "
        f"plots {turns[0]['pngs']}")
    say(f"  report arm on {card}: step ms (CUDA events, median of the "
        f"epochs a turn) with the side units {[f'{v:.4f}' for v in med[True]]}"
        f", without {[f'{v:.4f}' for v in med[False]]}; by epoch "
        + "; ".join(f"{'with' if t['side'] else 'without'}"
                    f"{'' if t['chunk'] == 1 else ' chunked'} "
                    f"{[round(v, 4) for v in t['step_ms']]}"
                    for t in turns))
    say(f"  report arm on {card}: host ms of one epoch's firing of the "
        f"four plotters (their reads back and submits) "
        f"{[round(v, 3) for v in fire]}; the publisher's report "
        f"{[round(v, 2) for v in pub]} ms; host s a turn "
        f"{[round(t['host_s'], 3) for t in turns]}")
    return turns[0]["launches"]


def plotter_events(tmp: str, name: str) -> list:
    path = os.path.join(tmp, "plots", "events.jsonl")
    return [e for e in map(json.loads, open(path)) if e["name"] == name]


def hits_and_hist_arm(card: str, render: bool, device=None) -> dict:
    """(b) ``KohonenHits`` on the kohonen sample and ``MSEHistogram`` on
    mnist_ae, each on a short graphed run: the hit map read at each
    epoch's last step (between the region and the decision, which zeroes
    the hits) sums to the epoch's samples, the histogram's counts to the
    minibatch, and neither adds a capture."""
    import numpy as np
    from znicz_tpu_torch import graphics
    from znicz_tpu_torch.models.samples import kohonen, mnist_ae
    from znicz_tpu_torch.mutable import Bool
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.ops.nn_plotting_units import (KohonenHits,
                                                       MSEHistogram)
    out = {}
    tmp = tempfile.mkdtemp(prefix="hits_")
    try:
        wf = make_mlp(kohonen, device=device, max_epochs=HITS_EPOCHS)
        report_root(tmp, render)
        hits = KohonenHits(wf, name="kohonen_hits")
        hits.link_attrs(wf.forward, ("input", "hits"), two_way=False)
        hits.shape_grid = wf.forward.shape_grid
        region = wf._region_unit
        wf.decision.unlink_from(region)
        hits.link_from(region)
        wf.decision.link_from(hits)
        loader = wf.loader
        hits.gate_skip = Bool._derived(lambda: not bool(loader.epoch_ended))
        before = metrics.graph_captures("som_region").value
        reset_counts()
        wf.run()
        out["report_kohonen"] = read_counts()
        if not graphics.flush_server():
            raise AssertionError("the render thread did not drain")
        sums = [int(np.sum(e["data"]))
                for e in plotter_events(tmp, "kohonen_hits")]
        captures = (wf.region.captures,
                    metrics.graph_captures("som_region").value - before)
        say(f"  KohonenHits on kohonen ({HITS_EPOCHS} epochs graphed, "
            f"{loader.total_samples} samples an epoch, an 8 × 8 map): hit "
            f"map sums {sums} by epoch; captures {captures[0]} (counter "
            f"{captures[1]:.0f})")
        keys = 2 if wf.region.graphed else 0
        if sums != [loader.total_samples] * HITS_EPOCHS \
                or captures != (keys, keys):
            raise AssertionError("kohonen hits: the hit map or the "
                                 "captures are wrong")
        expect_counts("report_kohonen", out["report_kohonen"], {})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="hist_")
    try:
        wf = make_ae(mnist_ae, device=device, max_epochs=AE_HIST_EPOCHS)
        report_root(tmp, render)
        hist = MSEHistogram(wf, name="mse_hist")
        hist.link_attrs(wf.forwards[-1], "output", two_way=False)
        hist.link_attrs(wf.evaluator, "target", two_way=False)
        wf._epoch_side_unit(hist)
        before = metrics.graph_captures("train_region").value
        reset_counts()
        wf.run()
        out["report_mnist_ae"] = read_counts()
        if not graphics.flush_server():
            raise AssertionError("the render thread did not drain")
        counts = [int(np.sum(e["data"]))
                  for e in plotter_events(tmp, "mse_hist")]
        batch = wf.loader.max_minibatch_size
        captures = (wf.region.captures,
                    metrics.graph_captures("train_region").value - before)
        say(f"  MSEHistogram on mnist_ae ({AE_HIST_EPOCHS} epoch graphed, "
            f"B = {batch}): the histogram's counts sum to {counts}; "
            f"captures {captures[0]} (counter {captures[1]:.0f})")
        keys = 3 if wf.region.graphed else 0
        if counts != [batch] * AE_HIST_EPOCHS or captures != (keys, keys):
            raise AssertionError("mse histogram: the counts or the "
                                 "captures are wrong")
        expect_counts("report_mnist_ae", out["report_mnist_ae"], {})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def splitter_arm(card: str, device=None) -> None:
    """(c) ``ChannelSplitter`` in a captured region on the card: the
    source and the splitter captured once, each replay's outputs
    bit-equal to ``numpy_run`` on the same planes at the addresses of the
    capture, and an output rebound after the capture refused by the next
    replay."""
    import numpy as np
    import torch
    from znicz_tpu_torch.accelerated_units import AcceleratedUnit, JitRegion
    from znicz_tpu_torch.dummy import DummyUnit, DummyWorkflow
    from znicz_tpu_torch.ops.aux_units import ChannelSplitter

    class Planes(AcceleratedUnit):
        def __init__(self, workflow, x):
            super().__init__(workflow, name="planes")
            self.x = x
            self.output = torch.empty_like(x)

        def device_run(self):
            torch.mul(self.x, 2.0, out=self.output)

    wf = DummyWorkflow(device="cuda" if device is None else device)
    dev = wf.device.torch_device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    x = torch.randn(SPLIT_SHAPE, generator=gen, device=dev)
    src = Planes(wf, x)
    src.initialize(device=wf.device)
    split = ChannelSplitter(wf, groups=SPLIT_GROUPS, name="splitter")
    split.link_attrs(src, ("input", "output"))
    split.initialize(device=wf.device)
    region = JitRegion("split_region", [src, split], wf.device)
    ptrs = [v.devmem.data_ptr() for v in split.outputs]
    for step in range(SPLIT_REPLAYS):
        x.normal_(generator=gen)
        region.run()
        planes = src.output.cpu().numpy()
        owf = DummyWorkflow(device="numpy")
        oracle = ChannelSplitter(owf, groups=SPLIT_GROUPS)
        oracle.link_attrs(DummyUnit(owf, output=planes), ("input", "output"))
        oracle.initialize(device="numpy")
        oracle.run()
        for i, (got, want) in enumerate(zip(split.outputs, oracle.outputs)):
            got.map_read()
            if not np.array_equal(got.mem, want.mem):
                raise AssertionError(f"splitter: replay {step}, group {i} "
                                     f"differs from numpy_run")
        if [v.devmem.data_ptr() for v in split.outputs] != ptrs:
            raise AssertionError("splitter: an output moved")
    graphed = region.graphed
    if region.captures != (1 if graphed else 0):
        raise AssertionError(f"splitter: {region.captures} captures")
    split.out1._devmem = split.out1._devmem.clone()
    refused = False
    try:
        region.run()
    except RuntimeError as exc:
        refused = "rebound" in str(exc)
    if graphed and not refused:
        raise AssertionError("splitter: a rebound output was not refused")
    say(f"  ChannelSplitter {SPLIT_SHAPE} → groups {list(SPLIT_GROUPS)} in a "
        f"region on {card}: {region.captures} capture, {SPLIT_REPLAYS} "
        f"steps bit-equal to numpy_run at the captured addresses, a "
        f"rebound output refused by the next replay: {refused}")


def forge_arm(card: str, device=None) -> dict:
    """(d) Wine trained graphed and packaged as v1.0.0 and, perturbed, as
    v1.1.0; both uploaded to a ``ForgeServer`` on 127.0.0.1; the newest
    fetched by ``ForgeClient`` and served by ``ExportedModel`` (graphed
    buckets on the card) bit-equal to the bundle exported directly;
    ``fleet.model_corrupt`` fired once: v1.1.0 quarantined, the fetch
    falling back to v1.0.0, counted on
    ``znicz_recoveries_total{kind=forge_fallback}``, served bit-equal to
    v1.0.0's direct bundle.  The package, upload and fetch times on the
    host clock."""
    import numpy as np
    import torch
    from znicz_tpu_torch import datasets
    from znicz_tpu_torch.export import ExportedModel
    from znicz_tpu_torch.forge import (ForgeClient, ForgeRegistry,
                                       ForgeServer, extract_model, package,
                                       read_manifest)
    from znicz_tpu_torch.models.samples import wine
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.utils.config import root
    wf = make_mlp(wine, device=device, max_epochs=FORGE_EPOCHS)
    reset_counts()
    wf.run()
    out = {"report_forge_train": read_counts()}
    expect_counts("report_forge_train", out["report_forge_train"],
                  {"softmax_argmax_wine": FORGE_EPOCHS * WINE_STEPS})
    x = datasets.load_wine()[0][:max(FORGE_ROWS)]
    tmp = tempfile.mkdtemp(prefix="forge_")
    times = {"package": [], "upload": [], "fetch": []}
    try:
        report_root(tmp, False)
        bundles, direct = [], []
        gen = torch.Generator(device=wf.device.torch_device)
        gen.manual_seed(SEED + 22)
        for i, version in enumerate(FORGE_VERSIONS):
            if i:  # the perturbed twin
                with torch.no_grad():
                    for u in wf.forwards:
                        u.weights.add_(1e-2 * torch.randn(
                            u.weights.shape, generator=gen,
                            device=u.weights.device))
            t0 = time.perf_counter()
            bundles.append(package(wf, os.path.join(
                tmp, f"wine-{version}.forge.tar.gz"), version=version))
            times["package"].append(time.perf_counter() - t0)
            direct.append(wf.export_forward(os.path.join(
                tmp, f"direct-{version}.npz")))
        registry = ForgeRegistry(os.path.join(tmp, "registry"))
        server = ForgeServer(registry, port=0, host="127.0.0.1")
        try:
            client = ForgeClient(f"http://127.0.0.1:{server.port}")
            for bundle in bundles:
                t0 = time.perf_counter()
                client.upload(bundle)
                times["upload"].append(time.perf_counter() - t0)

            def fetch_and_serve(label):
                t0 = time.perf_counter()
                fetched = client.fetch("wine", os.path.join(tmp, label))
                times["fetch"].append(time.perf_counter() - t0)
                version = read_manifest(fetched)["version"]
                model_path = extract_model(fetched,
                                           os.path.join(tmp, label))
                return version, model_path

            def replies(path):
                model = ExportedModel.load(path, device=device)
                model.warmup()
                got = {n: model(x[:n]) for n in FORGE_ROWS}
                return got, model.captures, model.graphed

            reset_counts()
            served = []
            version, path = fetch_and_serve("newest")
            served.append((version, replies(path), replies(direct[1])))
            r0 = metrics.recoveries("forge_fallback").value
            f0 = metrics.snapshot_failures("forge").value
            root.common.engine.faults = {"fleet.model_corrupt": {"at": [1]}}
            try:
                version, path = fetch_and_serve("fallback")
                fired = root.common.engine.faults.counts()
            finally:
                root.common.engine.faults = None
            served.append((version, replies(path), replies(direct[0])))
            out["report_forge_serve"] = read_counts()
            recovered = metrics.recoveries("forge_fallback").value - r0
            failed = metrics.snapshot_failures("forge").value - f0
            quarantine = sorted(os.listdir(os.path.join(
                tmp, "registry", "wine", "quarantine")))
            listed = client.list()
        finally:
            server.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for (version, (got, caps, graphed), (want, _, _)), expect in zip(
            served, reversed(FORGE_VERSIONS)):
        bad = [n for n in FORGE_ROWS if not np.array_equal(got[n], want[n])]
        if version != expect or bad:
            raise AssertionError(f"forge: served {version} (want {expect}), "
                                 f"rows {bad} differ from the direct "
                                 f"bundle's")
    if fired != {"fleet.model_corrupt": 1} or (recovered, failed) != (1, 1) \
            or quarantine != ["1.1.0.forge.tar.gz",
                              "1.1.0.forge.tar.gz.sha256"] \
            or listed != {"wine": ["1.0.0"]}:
        raise AssertionError(f"forge: fired {fired}, recoveries "
                             f"{recovered}, failures {failed}, quarantine "
                             f"{quarantine}, listed {listed}")
    serve = out["report_forge_serve"]
    expect_only("report_forge_serve", serve, "softmax_argmax_wine")
    say(f"  forge: Wine ({FORGE_EPOCHS} epochs graphed) packaged as "
        f"{FORGE_VERSIONS[0]} and, perturbed, {FORGE_VERSIONS[1]}, uploaded "
        f"to ForgeServer on 127.0.0.1; the newest fetched and served by "
        f"ExportedModel on {card} ({served[0][1][1]} graphed buckets: "
        f"{served[0][1][2]}), replies of {list(FORGE_ROWS)} rows bit-equal "
        f"to the bundle exported directly; fleet.model_corrupt fired "
        f"{fired}: {quarantine} quarantined, the fetch fell back to "
        f"{served[1][0]} (bit-equal), forge_fallback recoveries +"
        f"{recovered:.0f}, forge failures +{failed:.0f}; B4 launches while "
        f"serving {serve['softmax_argmax_wine']}")
    say(f"  forge on {card}'s host: package ms "
        f"{[round(1e3 * v, 2) for v in times['package']]}, upload ms "
        f"{[round(1e3 * v, 2) for v in times['upload']]}, fetch ms "
        f"{[round(1e3 * v, 2) for v in times['fetch']]} (host clock)")
    return out


def report_pass(card: str, device=None) -> dict:
    """Phase 21: the probe, then arms (a)–(d).  Returns the launches by
    path."""
    from znicz_tpu_torch import graphics
    found = graphics_probe()
    say(f"  graphics libraries on this machine: {found}")
    render = found["matplotlib"] is not None
    if not render:
        say("  no matplotlib: the plotters run with the render thread off, "
            "as --no-graphics runs them, and no PNG may be claimed")
    if found["zmq"] is None:
        say("  no pyzmq: the live-viewer arm (GraphicsClient) is skipped; "
            "ForgeServer needs neither library")
    else:
        zmq_arm(card, render)
    paths = {"report_mnist": report_arm(card, render, device)}
    paths.update(hits_and_hist_arm(card, render, device))
    splitter_arm(card, device)
    paths.update(forge_arm(card, device))
    graphics.reset_server()
    return paths


def zmq_arm(card: str, render: bool) -> None:
    """The live-viewer channel: a PUB server on 127.0.0.1 and a SUB client
    in this process, a payload received (and drawn with matplotlib)."""
    import numpy as np
    from znicz_tpu_torch.graphics import GraphicsClient, GraphicsServer
    tmp = tempfile.mkdtemp(prefix="zmq_")
    try:
        srv = GraphicsServer(out_dir=os.path.join(tmp, "srv"), render=False,
                             publish_port=0)
        cli = GraphicsClient(srv.endpoint, out_dir=os.path.join(tmp, "cli"))
        try:
            got = False
            for _ in range(50):
                srv.submit({"kind": "image", "name": "live",
                            "data": np.eye(8)})
                if render:
                    got = cli.poll_once(200)
                elif cli._sub.poll(200):  # received; drawing needs matplotlib
                    _topic, blob = cli._sub.recv_multipart()
                    got = pickle.loads(blob)["name"] == "live"
                if got:
                    break
        finally:
            cli.close()
            srv.stop()
        if not got:
            raise AssertionError("zmq: the client received nothing")
        say(f"  zmq: a payload published on {srv.endpoint} received by "
            f"GraphicsClient"
            + (" and drawn" if render else " (not drawn: no matplotlib)"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 22: the population engine
# ----------------------------------------------------------------------
#: (a): MNIST's members and epochs; (c): the epochs with evolution
POP_K, POP_EPOCHS, POP_EVOLVE_EPOCHS = 8, 2, 3
#: (b): the blobs net of tests/test_population.py
BLOBS_K, BLOBS_EPOCHS = 3, 3
#: (a): steps a turn of the population step against one member's
POP_TURN_STEPS = 20
POP_TURNS = ("population", "member", "member", "population")
#: (d): the drafter population and its step budget (20 steps an epoch:
#: phase 15's lone drafter needs ~1,400 steps to leave chance)
DRAFT_K, DRAFT_POP_EPOCHS = 4, 90
#: (d): the decode engines' geometry (small: only the tokens and the
#: drafter's acceptance are read)
DRAFT_GEOMETRY = {"max_slots": 4, "max_t": 256, "max_prompt": 128,
                  "prompt_align": 64, "page_tokens": 16}
DRAFT_LENGTHS = (1, 17, 64, 100)
#: (e): the child's search
OPT_SPEC, OPT_EPOCHS = "2x4", 3


def pop_tensors(wf) -> dict:
    """Weights, bias and both momenta of every weighted layer, by
    ``<layer index>.<attribute>``."""
    import torch
    out = {}
    for i, (fwd, gd) in enumerate(zip(wf.forwards, wf.gds)):
        for owner, names in ((fwd, ("weights", "bias")),
                             (gd, ("accumulated_gradient_weights",
                                   "accumulated_gradient_bias"))):
            for name in names:
                t = getattr(owner, name, None)
                if isinstance(t, torch.Tensor):
                    out[f"{i}.{name}"] = t
    return out


def add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def pop_guard_clean(label: str, trainer) -> None:
    """No member of the population skipped a step (the guard's state is
    member state: each member's own)."""
    wf = trainer.template
    if wf.anomaly_guard is None:
        return
    st = trainer.region.read_leaf(wf.anomaly_guard.anomaly_state)
    if st[:, 1:].any():
        raise AssertionError(f"{label}: anomalous member steps (streak, "
                             f"loss, grad) {st.tolist()}")


def blobs_build(**kw):
    """The blobs net of ``tests/test_population.py`` (dropout on)."""
    import numpy as np
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    rng = np.random.default_rng(7)
    centers = rng.normal(0.0, 1.0, size=(3, 10))
    data = np.concatenate([centers[c] + 0.35 * rng.normal(size=(24, 10))
                           for c in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 24).astype(np.int32)
    order = rng.permutation(len(data))
    data, labels = data[order], labels[order]
    gd = {"learning_rate": 0.05, "gradient_moment": 0.9}
    return StandardWorkflow(
        name="pop_blobs", loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
                 "<-": gd},
                {"type": "dropout", "->": {"dropout_ratio": 0.25}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": gd}],
        decision_config={"max_epochs": kw.get("max_epochs", BLOBS_EPOCHS)})


def pop_vs_sequential(label: str, build, k: int, epochs: int,
                      rows: dict) -> tuple:
    """K members of ``build`` from ``SEED`` + i trained ``epochs`` epochs
    as one population, graphed; then each member alone as an ordinary
    graphed run, held to its slice bit for bit and its fitness to the
    run's best validation error.  ``rows`` gives the kernels a member's
    step launches (row → launches a step); the population's counts must
    be at least K times them a step, and no other kernel may run.
    Returns (trainer, the population's launches, the last member's
    workflow)."""
    import torch
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.population import PopulationTrainer
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root
    reset_root()
    reset_counts()
    t0 = time.perf_counter()
    trainer = PopulationTrainer(build, k, base_seed=SEED, evolve=None,
                                name=label)
    trainer.initialize()
    trainer.run(epochs)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counts()
    region = trainer.region
    loader = trainer.template.loader
    steps = epochs * len(loader._schedule)
    captures = metrics.graph_captures(f"population:{label}").value
    say(f"  {label}: K = {k} for {epochs} epochs ({steps} population "
        f"steps) in {host_s:.2f} s on the host clock (builds included); "
        f"captures {region.captures} (counter {captures:.0f}), one a key; "
        f"best validation error by member, %: "
        f"{[round(float(-f), 2) for f in trainer.member_best_fitness]}")
    keys = len({cls for cls, _, _ in loader._schedule})
    if region.captures != keys or captures != keys:
        raise AssertionError(f"{label}: {region.captures} captures "
                             f"(counter {captures}), want {keys}, one a key")
    ran = {name: n for name, n in launches.items() if n}
    say(f"  launches on the {label} population: {ran}")
    for name, n in launches.items():
        want = rows.get(name, 0) * k * steps
        if (n < want) if name in rows else n:
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"want {'at least ' if rows else ''}{want}")
    pop_guard_clean(label, trainer)
    stacked = {name: region.read_leaf(t)
               for name, t in pop_tensors(trainer.template).items()}
    wf = None
    for i in range(k):
        reset_root()
        prng.seed_all(SEED + i)
        wf = build(max_epochs=epochs)
        wf.initialize()
        wf.run()
        for name, t in pop_tensors(wf).items():
            got = t.detach().float().cpu().numpy()
            if not (got == stacked[name][i]).all():
                raise AssertionError(
                    f"{label}: member {i}'s {name} is not its sequential "
                    f"run's (max_abs_err "
                    f"{float(abs(got - stacked[name][i]).max()):.3g})")
        fit = -wf.decision.min_validation_n_err_pt
        if fit != trainer.member_best_fitness[i]:
            raise AssertionError(f"{label}: member {i}'s fitness "
                                 f"{trainer.member_best_fitness[i]}, its "
                                 f"run's {fit}")
    say(f"  {label}: each of the {k} members bit-equal to its sequential "
        f"graphed run (weights, bias, momentum: {len(stacked)} tensors "
        f"each), its fitness the run's")
    return trainer, launches, wf


def pop_step_turns(trainer, wf, card: str) -> dict:
    """The population's step against one member's (``wf``, graphed), in
    the turns of :data:`POP_TURNS`: each step between two CUDA events,
    the train steps of the next epoch, medians."""
    import numpy as np
    import torch
    from znicz_tpu_torch.loader.base import TRAIN
    region = trainer.region
    loader = trainer.template.loader
    out = {"population": [], "member": []}

    def ahead(step, ldr):
        while sum(1 for cls, _, _ in ldr._schedule[ldr._cursor:]
                  if cls == TRAIN) < POP_TURN_STEPS \
                or (ldr._cursor < len(ldr._schedule)
                    and ldr._schedule[ldr._cursor][0] != TRAIN):
            step()

    for turn in POP_TURNS:
        step, ldr = ((region.step, loader) if turn == "population"
                     else (wf.step, wf.loader))
        ahead(step, ldr)
        events = []
        for _ in range(POP_TURN_STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        out[turn].append(float(np.median([a.elapsed_time(b)
                                          for a, b in events])))
    pop = float(np.median(out["population"]))
    one = float(np.median(out["member"]))
    k = trainer.n_members
    say(f"  population step (K = {k}) against one member's step on "
        f"{card}, median ms by turn (CUDA events around each call): "
        f"population {out['population']}, member {out['member']}; "
        f"{pop:.4f} ms against {one:.4f} ms: {pop / one:.2f} member "
        f"steps, {pop / (k * one):.3f} of K sequential steps")
    return {"population_ms": pop, "member_ms": one,
            "turns": out}


def pop_launches_a_step(trainer, name: str) -> None:
    """One more population step: K launches of ``name``, nothing else."""
    reset_counts()
    trainer.region.step()
    counts = {k: v for k, v in read_counts().items() if v}
    say(f"  launches of one population step (K = {trainer.n_members}): "
        f"{counts}")
    if counts != {name: trainer.n_members}:
        raise AssertionError(f"a population step launched {counts}, want "
                             f"{ {name: trainer.n_members} }")


def evolve_runs(card: str, build, strategy: str) -> dict:
    """(a)'s population for :data:`POP_EVOLVE_EPOCHS` epochs evolving by
    ``strategy`` every epoch, twice from one seed: the history, the rates
    and the weights replay equal; no capture after a generation; under
    PBT each loser's leaves (its rates aside) its donor's as they were
    before the generation."""
    import numpy as np
    import torch
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.population import PopulationTrainer
    from znicz_tpu_torch.utils.config import reset_root
    runs, launches = [], {}
    for run in range(2):
        reset_root()
        reset_counts()
        name = f"pop_{strategy}_{run}"
        trainer = PopulationTrainer(
            build, POP_K, base_seed=SEED, evolve=strategy, evolve_every=1,
            lr_bounds=(0.005, 0.3), seed=SEED + 31, name=name)
        trainer.initialize()
        region = trainer.region
        checked = []
        if strategy == "pbt":
            apply = region.apply_evolution
            slots = region.evolvable_slots()
            lr_ids = {id(t) for t in region._lr_tensors}

            def apply_checked(fn, fitness, gen, apply=apply, slots=slots):
                before = [region.svec(region.leaves[j].home).clone()
                          for j in slots]
                draws = apply(fn, fitness, gen)
                src = draws.src.cpu().numpy()
                for j, was in zip(slots, before):
                    if id(region.leaves[j].home) in lr_ids:
                        continue
                    now = region.svec(region.leaves[j].home)
                    for i in np.flatnonzero(draws.explored.cpu().numpy()):
                        if not torch.equal(now[i], was[src[i]]):
                            raise AssertionError(
                                f"{name}: loser {i}'s "
                                f"{region.leaves[j].label} is not its "
                                f"donor {src[i]}'s")
                checked.append(int(draws.explored.sum()))
                return draws
            region.apply_evolution = apply_checked
        trainer.run(POP_EVOLVE_EPOCHS)
        torch.cuda.synchronize()
        # every key is captured in the first epoch: a capture after a
        # generation would be one more
        captures = metrics.graph_captures(f"population:{name}").value
        if captures != region.captures or captures != 3:
            raise AssertionError(f"{name}: {captures:.0f} captures over "
                                 f"{POP_EVOLVE_EPOCHS} epochs and "
                                 f"{trainer.generations} generations, want "
                                 f"3 (one a key)")
        pop_guard_clean(name, trainer)
        launches = add_counts(launches, read_counts())
        w = region.read_leaf(trainer.template.forwards[0].weights)
        runs.append((trainer.history, region.member_lrs(), w,
                     trainer.generations, checked))
        del trainer, region
    (h0, lr0, w0, g0, c0), (h1, lr1, w1, g1, c1) = runs
    if h0 != h1 or not np.array_equal(lr0, lr1) \
            or not np.array_equal(w0, w1) or g0 != g1:
        raise AssertionError(f"{strategy}: the two runs from one seed "
                             f"differ")
    say(f"  {strategy}: {g0} generations, two runs from one seed equal "
        f"(history, rates {np.round(lr0, 5).tolist()}, weights); best "
        f"fitness by epoch {[h['best'] for h in h0]}; no capture after a "
        f"generation"
        + (f"; losers checked against their donors: {c0}"
           if strategy == "pbt" else ""))
    return launches


def drafter_arm(card: str, decode_lm: str) -> dict:
    """(d): ``train_drafter`` at phase 15's drafter geometry and data, the
    best member published and served as ``decode_lm``'s drafter."""
    import numpy as np
    import torch
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.population import train_drafter
    from znicz_tpu_torch.utils.config import reset_root, root
    x, y = lm_data(DEC_TRAIN + DEC_VALID, DEC_TRAIN_T, SEED + 17)
    layers = narrowed(DECODE_LAYERS, DRAFT_DIM, DRAFT_HEADS)

    def build(**kw):
        return StandardWorkflow(
            name="pop_drafter", loader_factory=lambda w: ArrayLoader(
                w, train_data=x[:DEC_TRAIN], train_labels=y[:DEC_TRAIN],
                valid_data=x[DEC_TRAIN:], valid_labels=y[DEC_TRAIN:],
                minibatch_size=DEC_BATCH),
            layers=[dict(spec) for spec in layers],
            decision_config={"max_epochs": DRAFT_POP_EPOCHS})

    reset_root()
    root.common.precision_type = "bfloat16"
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        version, path, trainer = train_drafter(
            build, DRAFT_K, publish_dir=tmp, evolve="pbt", evolve_every=2,
            name="pop_drafter")
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = read_counts()
        steps = DRAFT_POP_EPOCHS * len(trainer.template.loader._schedule)
        say(f"  train_drafter (K = {DRAFT_K}, D = {DRAFT_DIM}, "
            f"{DRAFT_HEADS} heads, bf16, T = {DEC_TRAIN_T}, B = "
            f"{DEC_BATCH}, PBT every 2 epochs): {DRAFT_POP_EPOCHS} epochs, "
            f"{steps} population steps in {host_s:.1f} s on the host clock "
            f"(builds included); "
            f"best member {trainer.best_member} at "
            f"{-trainer.best_fitness:.2f} % validation error; rates "
            f"{np.round(trainer.region.member_lrs(), 5).tolist()}; "
            f"published as version {version}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        pop_guard_clean("pop_drafter", trainer)
        published_is_best(path, trainer)
        del trainer
        reset_root()
        rng = np.random.default_rng(SEED + 32)
        prompts = [[int(t) for t in rng.integers(0, LM_VOCAB, size=n)]
                   for n in DRAFT_LENGTHS]
        rule_runs = [[int(t) for t in (int(rng.integers(0, LM_VOCAB))
                                       + np.arange(32)) % LM_VOCAB]
                     for _ in range(16)]
        edge = np.random.default_rng(SEED + 33)
        edge_runs = [[int(t) for t in (int(edge.integers(0, LM_VOCAB))
                                       + np.arange(DEC_TRAIN_T)) % LM_VOCAB]
                     for _ in range(16)]
        unshared = {"prefix_cache": False}
        follows = {}
        for label, bundle in (("the decode LM", decode_lm),
                              ("the drafter alone", path)):
            with decode_engine(bundle, DRAFT_GEOMETRY, **unshared) as eng:
                if bundle == decode_lm:
                    plain = generate_all(eng, prompts, CPU_NEW)
                follows[label] = (
                    rule_share(rule_runs, generate_all(eng, rule_runs, 24)),
                    rule_share(edge_runs, generate_all(eng, edge_runs, 1)))
        with decode_engine(decode_lm, DRAFT_GEOMETRY, spec_draft_k=SPEC_K,
                           drafter=path, **unshared) as eng:
            spec = generate_all(eng, prompts, CPU_NEW)
            before = eng.stats()["speculative"]
            generate_all(eng, rule_runs, 24)
            after = eng.stats()["speculative"]
    if spec != plain:
        raise AssertionError("the population's drafter changed the tokens")
    acc = after["accepted"] - before["accepted"]
    drafted = acc + after["rejected"] - before["rejected"]
    ref = KEPT.get("draft_accept")
    say(f"  served as the decode LM's drafter (spec_draft_k={SPEC_K}): "
        f"tokens equal to the engine's without speculation on "
        f"{len(prompts)} prompts; on 16 runs of the training rule {acc} "
        f"of {drafted} drafts accepted ({100 * acc / max(1, drafted):.1f} "
        f"%), phase 15's drafter "
        + (f"{ref[0]} of {ref[1]} ({100 * ref[0] / max(1, ref[1]):.1f} %)"
           if ref else "not run"))
    for label, ((hit, total), (e_hit, e_total)) in follows.items():
        say(f"  {label}, greedy: {hit} of {total} new tokens follow the "
            f"rule after 32-token rule prompts (positions 32–55, "
            f"{100 * hit / total:.1f} %); {e_hit} of {e_total} after "
            f"{DEC_TRAIN_T}-token ones (the one position training "
            f"scores, {100 * e_hit / e_total:.1f} %)")
    return launches


def rule_share(runs, outs) -> tuple[int, int]:
    """How many generated tokens follow the training rule (each the
    token before it plus one, mod V), of how many."""
    hit = total = 0
    for prompt, out in zip(runs, outs):
        prev = prompt[-1]
        for tok in out:
            hit += int(tok == (prev + 1) % LM_VOCAB)
            total += 1
            prev = tok
    return hit, total


def published_is_best(path: str, trainer) -> None:
    """The published bundle holds the best member's parameters bit for
    bit, as the population's stacked leaves on the card hold them."""
    import numpy as np
    from znicz_tpu_torch.export import read_bundle
    _, params = read_bundle(path)
    best, region = trainer.best_member, trainer.region
    checked = others = 0
    for i, unit in enumerate(trainer.template.forwards):
        for attr in unit.EXPORT_PARAMS:
            if not hasattr(unit, attr):
                continue
            key = f"layer{i}_{attr}"
            stacked = np.asarray(region.read_leaf(getattr(unit, attr)),
                                 dtype=np.float32)
            if key not in params or stacked.shape != (
                    (trainer.n_members,) + params[key].shape):
                raise AssertionError(f"{key}: not a member leaf of the "
                                     f"published shape")
            if not np.array_equal(params[key].view(np.uint32),
                                  stacked[best].view(np.uint32)):
                raise AssertionError(f"the published {key} is not member "
                                     f"{best}'s")
            others += sum(not np.array_equal(stacked[m], stacked[best])
                          for m in range(trainer.n_members) if m != best)
            checked += 1
    if not checked:
        raise AssertionError("the drafter published no parameters")
    say(f"  the published bundle: {checked} parameters bit-equal to best "
        f"member {best}'s stacked leaves on the card ({others} "
        f"member-parameter pairs of the others differ from them)")


def optimize_child(card: str) -> None:
    """(e): the genetic search through the command line, in a child
    process on the card."""
    cmd = [sys.executable, "-m", "znicz_tpu_torch", "wine", "--no-graphics",
           "--optimize", OPT_SPEC, "--root", f"wine.max_epochs={OPT_EPOCHS}",
           "--root", "wine.learning_rate=Tune(0.3, 0.05, 0.8)"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    host_s = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    found = re.search(r"best genome \(fitness ([-0-9.]+)\): "
                      r"\{'wine\.learning_rate': ([-0-9.e]+)\}", log)
    if proc.returncode != 0 or found is None:
        raise AssertionError(f"--optimize exited {proc.returncode}:\n"
                             f"{log[-6000:]}")
    lr = float(found.group(2))
    say(f"  python -m znicz_tpu_torch wine --optimize {OPT_SPEC} --root "
        f"wine.max_epochs={OPT_EPOCHS} --root 'wine.learning_rate=Tune(0.3, "
        f"0.05, 0.8)' on {card}: exit 0 in {host_s:.1f} s, best genome "
        f"learning_rate {lr} (fitness {found.group(1)})")
    if not 0.05 <= lr <= 0.8:
        raise AssertionError(f"--optimize: the best rate {lr} is out of "
                             f"its range")


def population_pass(card: str, decode_lm: str) -> dict:
    """Phase 22: the population engine's paths on the card; returns the
    launches of the population runs (the ``population`` path)."""
    from znicz_tpu_torch.models.samples import mnist

    def mnist_build(**kw):
        return mnist.build(**{"max_epochs": POP_EPOCHS, **kw})

    launches = {}
    t0 = time.perf_counter()
    trainer, counts, wf = pop_vs_sequential(
        "pop_mnist", mnist_build, POP_K, POP_EPOCHS,
        {"softmax_argmax_cifar": 1})
    launches = add_counts(launches, counts)
    pop_launches_a_step(trainer, "softmax_argmax_cifar")
    pop_step_turns(trainer, wf, card)
    del trainer, wf
    say(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trainer, counts, wf = pop_vs_sequential(
        "pop_blobs", blobs_build, BLOBS_K, BLOBS_EPOCHS,
        {"softmax_argmax_wine": 1, "dropout_apply": 0})
    if not counts["dropout_apply"]:
        raise AssertionError("pop_blobs: no dropout launch")
    launches = add_counts(launches, counts)
    del trainer, wf
    say(f"  (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for strategy in ("pbt", "ga"):
        launches = add_counts(launches, evolve_runs(card, mnist_build,
                                                    strategy))
    say(f"  (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = add_counts(launches, drafter_arm(card, decode_lm))
    say(f"  (d) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    optimize_child(card)
    say(f"  (e) took {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing to check",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "znicz_tpu_torch", "csrc")):
        print(f"chip_smoke: no znicz_tpu_torch/csrc beside {__file__} — "
              f"run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from znicz_tpu_torch.ops import _cuda
    from znicz_tpu_torch.ops import flash_attention as fa
    from znicz_tpu_torch.ops import fused_kernels as fk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    track_guards()
    say("phase 1: build")
    t0 = time.perf_counter()
    _cuda.build_all()
    build_s = time.perf_counter() - t0
    say(f"  built in {build_s:.1f} s into "
        f"{os.path.relpath(_cuda.build_dir(), REPO)}")
    spills = []
    for name in _cuda.SOURCES:
        stem = os.path.splitext(name)[0]
        serialized = 0
        for line in _cuda.build_log(stem).splitlines():
            # ptxas's wgmma notes (C75xx) are counted, not printed: each
            # injected wait is a line
            if "Performance Loss" in line:
                serialized += 1
            elif "C75" in line:
                continue
            elif "registers" in line or "spill" in line \
                    or "wall time" in line:
                say(f"  {stem}: {line.strip()}")
            spills += [(stem, line.strip()) for n in re.findall(
                r"(\d+) bytes spill", line) if int(n)]
        if serialized:
            say(f"  {stem}: ptxas serialized wgmma in {serialized} place(s)")
    if spills:
        raise AssertionError(f"the compiler spilled registers: {spills}")
    smem = _cuda.library("flash_attention_fwd").znicz_flash_attention_fwd_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    say("  flash_attention_fwd (TMA + wgmma) dynamic shared memory by width: "
        + ", ".join(f"{w}: {smem(w)} B" for w in (64, 128, 256, 512)))

    say("phase 2: kernels against their plain versions")
    t2 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = check_flash(gen)
    rows.update(check_layer_norm(gen))
    rows.update(check_flash_bwd(gen))
    rows.update(check_layer_norm_bwd(gen))
    rows.update(check_lrn(gen))
    floor_ms = launch_floor_ms()
    say(f"  launch floor: an empty kernel {floor_ms:.5f} ms (one block of "
        f"32 threads, 50 in a CUDA graph)")
    rows.update(check_dropout(gen, floor_ms))
    rows.update(check_softmax_argmax(gen, floor_ms))
    off_path = {name: rows.pop(name) for name in OFF_PATH_ROWS}
    say(f"  phase 2 took {time.perf_counter() - t2:.1f} s")

    paths = {}
    say("phase 3: full-width bf16 scorer through ServingEngine")
    t3 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scorer.npz")
        write_scorer_bundle(path)
        paths["serving"] = serve_slice(path, (fa.flash_attention_fwd,
                                              fk.layer_norm_forward,
                                              fk.softmax_argmax), smi)

    say(f"  phase 3 took {time.perf_counter() - t3:.1f} s")
    # phases 4–7: the regions eager, as before the port had CUDA graphs
    set_graphs(False)
    expect_no_anomalies("phase 3")
    say("phase 4: full-width bf16 training through StandardWorkflow")
    t4 = time.perf_counter()
    paths["training"] = train_slice()
    say(f"  phase 4 took {time.perf_counter() - t4:.1f} s")

    expect_no_anomalies("phase 4")
    say("phase 5: full-width AlexNet training through StandardWorkflow")
    t5 = time.perf_counter()
    paths["alexnet"] = alexnet_slice()
    say(f"  phase 5 took {time.perf_counter() - t5:.1f} s")

    expect_no_anomalies("phase 5")
    say("phase 6: the full-width sequence stack in f32, then short runs at "
        "head dims 32, 256, 512 and 4")
    t6 = time.perf_counter()
    paths["seq_f32"] = train_slice("float32")
    paths["seq_dh32"] = seq_pass("seq_dh32", "bfloat16", 2 * HEADS, "dh32")
    paths["seq_dh256"] = seq_pass("seq_dh256", "bfloat16", 2, "dh256")
    paths["seq_f32_dh256"] = seq_pass("seq_f32_dh256", "float32", 2,
                                      "f32_dh256")
    paths["seq_dh512"] = seq_pass("seq_dh512", "bfloat16", 1, "wide")
    paths["seq_f32_dh512"] = seq_pass("seq_f32_dh512", "float32", 1,
                                      "f32_wide")
    paths["seq_dh4"] = dh4_pass()
    say(f"  phase 6 took {time.perf_counter() - t6:.1f} s")

    expect_no_anomalies("phase 6")
    say("phase 7: CIFAR-10 through python -m znicz_tpu_torch, with "
        "snapshots and resume")
    t7 = time.perf_counter()
    paths["cifar"] = cifar_pass()
    say(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    expect_no_anomalies("phase 7")
    say("phase 8: the three training paths with their regions as CUDA "
        "graphs")
    t8 = time.perf_counter()
    set_graphs(True)
    paths["cifar_graphed"] = cifar_graphed(smi)
    set_graphs(True)
    paths["alexnet_graphed"] = alexnet_graphed(smi)
    paths["seq_graphed"] = seq_graphed(smi)
    say(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    expect_no_anomalies("phase 8")
    say("phase 9: the MLP family (MNIST 784-100-10, the MNIST-784 "
        "autoencoder, Wine with a schedule), graphed")
    t9 = time.perf_counter()
    paths["mnist"] = mnist_pass(smi)
    paths["mnist784"] = mnist784_pass(smi)
    paths["wine"] = wine_pass(smi)
    say(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    expect_no_anomalies("phase 9")
    say("phase 10: the byte LM (eager, graphed, accumulated, served), the "
        "LSTM chain and to_sequence")
    t10 = time.perf_counter()
    paths["lm"], paths["lm_graphed"] = lm_pass(smi)
    paths["lm_accum"] = lm_accum_pass(smi)
    paths["lm_serve"] = lm_serve_pass(smi)
    paths["lstm"] = lstm_pass(smi)
    paths["to_sequence"] = to_sequence_pass()
    say(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    expect_no_anomalies("phase 10")
    say("phase 11: the numpy oracle, engine.debug_checks and "
        "engine.fp8_matmul")
    t11 = time.perf_counter()
    paths["oracle_wine"] = oracle_pass(smi)
    import numpy as np
    rng = np.random.default_rng(SEED + 12)
    x11 = torch.from_numpy(rng.normal(0.0, 0.3, size=(4 * BATCH, SEQ, DIM))
                           .astype(np.float32)).to(torch.bfloat16)
    y11 = rng.integers(0, CLASSES, size=4 * BATCH).astype(np.int32)
    paths["checks_seq"] = checks_pass(
        smi, "checks_seq", lambda: make_trainer(x11, y11, BATCH), {
            **{f"flash_attention_{k}": 1 for k in ("fwd", "dq", "dkv")},
            "layer_norm_forward": 1, "layer_norm_backward": 1,
            "softmax_argmax_small": 1}, plant_unit=1)
    paths["checks_alexnet"] = checks_pass(
        smi, "checks_alexnet",
        lambda: make_alexnet(ALEX_BATCH, 4 * ALEX_BATCH), {
            "lrn_forward": 1, "lrn_forward_conv2": 1, "lrn_backward": 1,
            "lrn_backward_conv2": 1, "dropout_apply": 4,
            "softmax_argmax": 1}, plant_unit=0)
    fp8_products(smi)
    paths["fp8_mnist"] = fp8_mnist(smi)
    paths["fp8_lm"] = fp8_lm(smi)
    say(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    expect_no_anomalies("phase 11")
    say("phase 12: the small vision samples (hands, yale_faces, channels) "
        "and the conv autoencoders (mnist_ae, imagenet_ae, tied), graphed")
    t12 = time.perf_counter()
    for name, batch, classes, row, bar in A6A:
        paths[name] = a6a_pass(smi, name, batch, classes, row, bar)
    for name, batch, keys, warmup, steps in AE:
        paths.update(ae_pass(smi, name, batch, keys, warmup, steps))
    paths["mnist_ae_tied"] = tied_ae_pass(smi)
    say(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    expect_no_anomalies("phase 12")
    say("phase 13: the RBM (mnist_rbm), the Kohonen map (kohonen) and the "
        "cutter chain with a zero filler and an image saver, graphed")
    t13 = time.perf_counter()
    paths["mnist_rbm"] = rbm_pass(smi)
    paths["kohonen"] = som_pass(smi)
    paths["cutter_chain"] = chain_pass(smi)
    say(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    expect_no_anomalies("phase 13")
    say("phase 14: the scorer's buckets as CUDA graphs: hot swap under "
        "load, int8, the SDC shadow audit, the fault sites, request traces "
        "and the flight recorder")
    t14 = time.perf_counter()
    paths.update(serve_graphs_pass(smi))
    say(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    expect_no_anomalies("phase 14")
    say("phase 15: decode — the byte LM and the LSTM chain through "
        "DecodeEngine, each program a CUDA graph")
    t15 = time.perf_counter()
    paths["decode"] = decode_pass(smi)
    say(f"  phase 15 took {time.perf_counter() - t15:.1f} s")

    expect_no_anomalies("phase 15")
    say("phase 16: parallelism — the NCCL world of one through the "
        "launcher (the stack and AlexNet), B3's block map and the "
        "stochastic units' blocks, the ring fold at full width, the "
        "temporal pipeline")
    t16 = time.perf_counter()
    paths["dp_nccl"], paths["dp_alexnet"] = dp_nccl_pass(smi)
    rows["dropout_apply"]["blocks"] = check_dropout_blocks(gen)
    stochastic_unit_blocks()
    for dtype_name in ("bfloat16", "float32"):
        for causal in (False, True):
            paths[f"ring_{dtype_name}{'_causal' if causal else ''}"] = \
                ring_pass(smi, dtype_name, causal, gen)
    paths["pipeline"] = pipeline_pass(smi)
    say(f"  phase 16 took {time.perf_counter() - t16:.1f} s")

    expect_no_anomalies("phase 16")
    say("phase 17: the input plane — AlexNet streamed from shards through "
        "the pinned staging ring, graphed, in turns with the resident "
        "loader, then (b) image decode on the card: the pool's own JPEG "
        "and PNG decoders, imagenet from a JPEG tree, the PNG samples")
    paths["stream"], paths["stream_resident"] = stream_pass(smi)
    paths.update(image_decode_pass(smi))

    expect_no_anomalies("phase 17")
    say("phase 18: resilience — the anomaly guard and the SDC fingerprints "
        "in the graphed step, the sentinel, the publisher into the graphed "
        "scorer, the elastic supervisor")
    t18 = time.perf_counter()
    GUARD_STATES.clear()  # phase 18's parts read their own guards
    paths.update(resilience_pass(smi))
    say(f"  phase 18 took {time.perf_counter() - t18:.1f} s")

    say("phase 19: serving at scale and ops — the fleet on the scorer's "
        "graphed buckets, the web status page, the kernel-library store")
    t19 = time.perf_counter()
    paths["fleet"] = fleet_pass(smi, KEPT["decode_lm"], build_s)
    say(f"  phase 19 took {time.perf_counter() - t19:.1f} s")

    say("phase 20: disaggregated decode — prefill and decode pools over "
        "private paged caches, the page handoff through pinned staging, "
        "the host-DRAM spill tier, PoolAutoscaler")
    t20 = time.perf_counter()
    paths["disagg"] = disagg_pass(smi, KEPT["decode_lm"], KEPT["lstm"])
    say(f"  phase 20 took {time.perf_counter() - t20:.1f} s")

    say("phase 21: the report chain — the plotters, the report publisher, "
        "the aux units and the forge on the graphed step")
    t21 = time.perf_counter()
    GUARD_STATES.clear()  # phase 21's workflows only
    paths.update(report_pass(smi))
    expect_no_anomalies("phase 21")
    say(f"  phase 21 took {time.perf_counter() - t21:.1f} s")

    say("phase 22: the population engine — K members in one CUDA graph, "
        "PBT and GA in place, train_drafter, --optimize")
    t22 = time.perf_counter()
    GUARD_STATES.clear()  # phase 22's sequential runs
    set_graphs(True)
    paths["population"] = population_pass(smi, KEPT["decode_lm"])
    expect_no_anomalies("phase 22")
    say(f"  phase 22 took {time.perf_counter() - t22:.1f} s")

    for name, row in rows.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    idle = [name for name, row in rows.items() if not row["launches"]]
    if idle:
        raise AssertionError(f"kernels no path launched: {idle}")
    for row in off_path.values():
        # no main path launches the general routes at these widths (the
        # paths check their layer-norm and LRN routes)
        row["launches"], row["launches_by_path"] = 0, {}

    print(json.dumps({"off_path_kernels": list(off_path.values())}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
