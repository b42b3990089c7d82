#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (any failure raises and exits
nonzero; nothing is caught):

1. env      torch/CUDA versions, the card's name and power limit.
2. build    nvcc builds of ``csrc/lstm_seq.cu``, ``csrc/flash_attn.cu``,
            ``csrc/flash_attn_bwd.cu``, ``csrc/flash_attn_bwd_wgmma.cu`` and
            ``csrc/conv_stats.cu``, started together, with their ptxas
            reports; the count of HGMMA (wgmma)
            instructions in the conv and flash libraries' SASS and of HMMA
            (mma.sync) in the flash libraries', where a cuobjdump exists.
3. kernels  ``lstm_seq`` held against ``lstm_seq_plain`` on the card, f32
            and bf16, with and without peepholes and mask, at the served
            shapes (T=128, H=512, B in {1, 8, 64}), at H=1024 (B=8 and 64)
            and at a ragged H=100, each on the variant its ``plan()``
            names (``persistent`` on every served shape; its shared memory
            and blocks an SM checked against the built library); with the
            kernel's time back to back (``ms``) and on the card alone
            (``device_ms``), the plain loop's time, the bound and cuDNN's
            ``torch.nn.LSTM`` as a yardstick (``library_ms``,
            ``library_device_ms``); the f32 final state (what a caller
            carries on) checked against the plain version's and against
            the hT/cT it rounds to, and one sequence run in two calls
            from the first call's final state against the whole run
            (``kernels.carry``, persistent and step_cluster); then one
            call at the served path's shape under ``torch.profiler``: the
            device's kernel launches by name, one
            ``lstm_persistent_kernel`` for all 128 steps.
4. flash    ``flash_attn`` held against ``flash_attention_plain`` on the
            card (out and lse), and the autograd.Function's dq/dk/dv
            against autograd through the plain version: B=4, H=8,
            T in {1000, 4096}, D in {64, 128}, f32 and bf16, causal or not,
            with and without a [B,T] key mask whose last row is fully
            masked; q, k, v are views of one [B,T,3,H,D] tensor, as the
            fused projection leaves them (``f32_3xtf32_wgmma`` at D=64,
            ``f32_3xtf32`` at D=128, ``bf16_wgmma``), and, once each,
            views with odd strides (the unaligned variants); each case on
            the variant its ``plan()`` names. Times at the training path's shape (T=4096, D=64,
            causal) beside the bound, the plain version and
            ``scaled_dot_product_attention`` as a yardstick, back to back
            and on the card, forward and forward + backward (with the
            backward's bound); the backward kernel (``flash_attn_bwd``, the
            variant its ``plan_bwd()`` names in every grid case:
            ``f32_3xtf32_wgmma`` at D=64, ``f32_3xtf32`` at D=128,
            ``bf16_wgmma``, the unaligned ones on odd views, each plan's
            shared memory checked against the built library; exactly zero
            gradient on the fully masked row) alone, back to back and on the
            card, each of its two passes alone on the card, beside their
            bounds, the plain backward and SDPA's backward, the earlier
            ``mma.sync`` design on the same inputs, two calls bit-identical
            in f32 and bf16, and per call at a TP 4-head slice and at a
            one-sequence pipelined microbatch beside SDPA's backward and
            the forward beside SDPA's forward there; then
            the kernels against the port's naive attention, forward and
            backward, at T in {256, ..., 4096}: the length crossover.
5. train    ``transformer_lm`` at the width of the JAX package's long-context
            bench (vocab 8192, 6 x 512, 8 heads, seq 4096; 29,408,256
            params, random weights from the seed) trained by
            ``MultiLayerNetwork.fit`` at batch 4 on a learnable synthetic
            sequence, under the f32 policy and ``bf16_policy``: 2 warm-up
            steps then 10 timed ones, 6 flash launches a step, all on the
            planned variant (``f32_3xtf32_wgmma``: q, k, v stay f32 under
            both policies), the last loss
            below the first; and one step from identical weights with the
            plain attention forward agreeing with the kernel's step.
            After each, one step under ``torch.profiler``: device time by
            family and the device's busy share.
6. conv     ``conv_mm_stats`` and ``conv3x3_stats`` held against their plain
            versions on the card, z and both statistics, f32 and bf16, at
            all 19 conv geometries of the fused ResNet50 at batch 64 and at
            edge cases (channels off the tiles, a row count off the row
            tile, the 7x7 map, stride-2 3x3 on even dims), each on the
            variant its ``plan()`` names (whose shared memory and blocks an
            SM are checked against the built library); each path geometry
            timed beside its bound, the plain version and cuDNN's
            ``F.conv2d`` on the same z (a yardstick without the
            statistics), back to back (``ms``, host launch cost included
            where it exceeds the call) and on the card alone
            (``device_ms``), and the sums over one forward's 36 + 16 calls.
7. resnet   ``resnet50(fused=True)`` at the JAX package's flagship bench
            width (batch 64, 224x224x3, 1000 classes; 25,557,032 params,
            random weights from the seed) trained by
            ``ComputationGraph.fit`` on synthetic labelled images (10 class
            templates plus noise), under the f32 policy and ``bf16_policy``:
            2 warm-up steps then 10 timed ones with exactly 36 + 16 conv
            kernel launches a step, every one on the Hopper variant
            (``bf16_wgmma`` or ``f32_pipelined``), the last loss below the
            first; under
            f32 first one step from identical weights through the kernels'
            plain versions, agreeing with the kernel step within the step's
            own f32 noise (the plain step on the batch permuted). After each, one
            step under ``torch.profiler``: device time by family and busy
            share.
8. serve    the GravesLSTM char-RNN at full width (vocab 96, 2 x 512,
            seq 128; weights from a numpy seed), round-tripped through
            ``save_model``/``load_model`` and served through
            ``ModelRegistry`` on (batch, seq) buckets: a few hundred
            requests of mixed lengths and batch sizes, every result checked
            against the plain functions on the card, and the kernel's
            launch count checked against the device forwards, every launch
            ``persistent``.
9. profile  one char-RNN forward at the largest bucket under
            ``torch.profiler``: device time by kernel family and busy share.
10. cli     ``python -m deeplearning4j_tpu_torch serve --smoke 64``; then
            64 more requests through a fresh registry under the port's
            runtime sanitizer (``analysis/sanitizer.py``), each answer
            against the plain forward: no lock inversion, leaked thread or
            unresolved future, and its report merged clean with the static
            R9 lock graph of ``serving/`` and ``telemetry/`` through ``lint
            --san-report`` (the ``serve.sanitizer`` line, with its seconds).
11. charnn  the same char-RNN (3,398,752 params, random weights from the
            seed) trained by ``MultiLayerNetwork.fit`` on one-hot
            sequences of ids[t+1] = (5 ids[t] + 3) mod 96 from random
            starts, under the f32 policy and ``bf16_policy``: one step from
            identical weights through the plain forward (the same backward,
            ``lstm_seq_bwd``) held against the kernel step; 2 warm-up then
            10 timed steps at batch 64 x 128, two persistent ``lstm_seq``
            launches a step, then 28 more, the mean loss of the last 5 of
            the 40 below the first step's; one profiled step (device
            time by family: lstm_fwd, lstm_bwd, gemm, elementwise,
            optimizer; busy share); TBPTT over 3 batches of 64 x 512 in
            chunks of 128 (iteration + 12, 2 launches a chunk, the loss
            falling); ``rnn_time_step`` over 16 single steps against the
            full forward of the same steps; ``lstm_seq_bwd`` timed at
            B=64, T=128, H=512 beside its bound and cuDNN's ``nn.LSTM``
            backward (no peepholes).
12. zoo     from the zoo registry at full width, random weights from the
            seed, on 10 class templates plus noise: Inception-ResNet v1
            with the FaceNet head (``get_model("inceptionresnetv1")``,
            160x160x3, 1001 classes, blocks 5/10/5, 16,863,161 params,
            RmsProp 0.1) at batch 64 under both policies: 2 warm-up and 10
            timed steps, the mean loss of the last 5 below the first, the
            centers moved, unit embeddings from ``feed_forward``, one
            profiled step (library convs, BN/elementwise, merge
            concatenations, LRN/pooling, optimizer); one f32 step on the
            card against the same step in float64 on the CPU at batch 8
            (``irv1_step_check``); a checkpoint saved on the card and
            restored on the CPU. GoogLeNet (224x224x3, 1000 classes,
            8,048,152 params, fc1's dropout 0.4 live; weights and images
            from the next seed, ``GN_SEED_OFFSET``) likewise under f32,
            with two eval-mode outputs equal and rows summing to 1. The
            fused ResNet50 with ``checkpoint_scope="prefix"`` under both
            policies: its first step against the plain step (within the
            plain step's own noise), peak memory of a step with and without
            remat, 10 timed steps with the conv launches the segments give
            (every fused vertex sits in a group: forward and recompute, 104
            a step) on the planned variants. ``resnet50_mln`` trained one
            step at batch 2 on the card, saved, restored on the CPU.
13. finetune the fused ResNet50 at the flagship shape trained 2 steps,
            saved and restored through ``models.zoo.restore_checkpoint``,
            then ``TransferLearningGraph``: frozen up to ``s2b5_relu`` (45
            vertices), a fresh 5-way head, Adam 1e-3 (23,518,277 params,
            14,974,981 trained) on 5 class templates plus noise, batch 64,
            under both policies: under f32 first one step from identical
            weights against the same step with exactly rounded stage-3
            convs, within 3x the distance of the kernels' plain versions
            (on the card, on the batch permuted, on the CPU) from it; 2
            warm-up steps, then 10 timed steps five times,
            without and with ScoreIteration, Performance and CollectScores
            listeners in turns (the listener runs within the plain runs'
            spread plus 10% of their median, by the listener runs'
            median), 7 ``conv_mm_stats`` and 3
            ``conv3x3_stats`` launches a step on the planned variant (the
            frozen fused vertices run in inference mode and launch none),
            the frozen parameters and BN state bit-identical to the restored
            source, the loss falling. ``evaluate`` and ``evaluate_roc`` on
            640 held-out images plus an ``EvaluationCalibration``: accuracy
            at least 0.6 (chance 0.2), the confusion matrix equal to the
            argmax counts of ``output()``. Under f32 then
            ``EarlyStoppingTrainer`` over 3 epochs scored by the held-out
            loss (the restored best scores the recorded best), and the
            network served from its checkpoint through the registry on
            batch buckets 1-64: 256 requests of 1 to 16 images, one in four
            batched, every other one in the dict form, each result against
            ``output()``; then the ``serve`` and ``eval`` verbs on the
            checkpoint. Tiny YOLO from the registry at its defaults
            (416x416, 20 classes, 5 anchors, 15,861,773 params) at batch 32
            on synthetic images with 1-4 boxes, both policies, the loss
            falling; its detections and NMS from the card's output equal to
            the same on the output moved to the CPU; one f32 step at batch
            4, 224x224, against float64 on the CPU as ``irv1_step_check``
            holds Inception-ResNet v1's. The ten conv layers this slice
            ports, forward and backward at 56x56x128 (1-D: 3136 x 128),
            against float64 on the CPU.
14. fused   ``fit(steps_per_dispatch=4)``: K=4 steps a dispatch through
            ``nn/fused.py``, each dispatch one replay of a CUDA graph
            captured once per input signature. The fused ResNet50 (as in
            ``resnet``, Adam 1e-3) and the char-RNN (as in ``charnn``,
            RmsProp 1e-3) under both policies, on host (numpy) data: 10
            batches less half a batch (3 dispatches, the last with 2 real
            steps and a padded batch) trained at K=4 and at K=1 with
            ``pad_ragged`` from identical weights, bit-identical (and
            within 3x the card's f32 noise, the K=1 run on each batch's
            rows reordered); the f32 ResNet50's K=1 fit twice more and
            its timed steps once more on cuDNN's default algorithms (the
            repeat the port's deterministic choice buys, and its cost), one
            build a model run restored in place for each fit; one
            capture over 2 epochs; 5 timed dispatches (20 steps) against
            5 timed K=1 steps with their peak memory; 1 profiled
            dispatch whose replays show every conv kernel (52 a step) and
            the persistent LSTM kernel; 36 + 16 conv launches and 2
            ``lstm_seq`` launches a step, all from replays, on the planned
            variants. DropConnect(0.9) on both GravesLSTM layers: K=4
            captured against K=1 eager within the noise, and a K=1 run whose
            steps all draw the first step's masks (a mask frozen at capture)
            beyond it. The watchdog armed with NaN features in batch 5:
            ``record`` resolves the anomaly one dispatch late, ``raise``
            raises ``NumericsError`` at step 5. ``StepDriver`` at K=4: 2
            rounds, a checkpoint, a restore into a fresh net, 2 rounds:
            bit-identical to 4 rounds, the graph captured once more.
15. word2vec BASELINE config 3 at the JAX package's ``bench_word2vec``
            production scale: ``Word2Vec`` (``text/word2vec.py``) at
            V=100,000, D=300, window 5, 5 negatives, batch 2048, subsample
            1e-3, lr 0.025, one epoch over a Zipf corpus of 125,000
            sentences x 20 int tokens (2.5M words, from the seed; the bench's
            500,000 cut to a quarter for the time limit). First one
            chunk of 32 SGNS steps at that width from tables installed with
            ``tables_from_numpy`` and fixed indices, twice on the card (one
            capture, two replays), against the plain step in float64 and
            float32 on the CPU. Then a warm-up of the fit's host stages
            on the whole corpus and a timed fit of a fresh model (as the
            bench times it): words/s, the host's stages
            (vocab and encoding, pairs, the rest) against the steps, pairs,
            steps, chunk replays (every full chunk one replay of the CUDA
            graph, asserted, with one capture and its ms), tables, scratch,
            draws and generator on the card (asserted), peak memory; then
            the chunk's replays timed (device ms a step) against the
            step's bytes bound, and 3 replays profiled (busy share, device
            events a step, the largest kernels' device ms a step). Last the toy-topic checks of the JAX package's
            tests with every NLP trainer on the card: SGNS, HS and CBOW
            orderings, PV-DBOW and ``infer_vector``, GloVe, DeepWalk,
            KMeans, t-SNE. Then ``SequenceVectors(mesh=)`` at the same width
            over 4 gloo ranks on the card (``word2vec.mesh``), every
            model's vocabulary and tables built on the whole 2.5M-word
            corpus (V ~97,000): the replicated-table fit on the corpus's
            first 31,240 words and the ``shard_tables=True`` fit (V/4 rows a
            rank) on its first 15,620, with the same host-drawn negatives,
            each against the world-1 fit of the same pairs (replicated
            within 2e-6, sharded within 1e-5 relative + 1e-6, or 3x the
            world-1 fit's distance from itself where that is more), pairs
            dropped at most 3; words/s and the bytes a rank puts into a
            step's collectives; then both fits of the 31.25k words at world
            1 over NCCL, each chunk captured into its CUDA graph with its
            collectives, against the same world-1 fit.
16. mnist   BASELINE config 1 as DL4J's LenetMnistExample runs it: MNIST-
            format IDX files at MNIST's size (60,000 + 10,000 images,
            28x28, 10 class templates plus noise and shifts, from the seed;
            the training split gzipped) read back through ``mnist_iterator``
            (batch 256), a ``NormalizerStandardize`` fitted streaming over
            the 235 training batches (held against a one-shot float64
            fit), one epoch of ``MultiLayerNetwork.fit`` of LeNet (431,080
            params) over the normalized iterator under the f32 policy and
            ``bf16_policy`` (images/s with the fetch and normalization,
            the host's ms a batch for them, 5 profiled steps' busy share,
            the loss falling, ``evaluate`` on the test split); the model
            saved with its normalizer, restored on the card (outputs
            equal), the normalized test set as a labelled CSV through the
            ``eval`` verb (its statistics equal ``evaluate``'s);
            ``memory_report``'s estimate against the card's peak over one
            step; ``QuantizedInference`` (int8 bytes, accuracy, the largest
            probability change, ms a forward); the VAE of dl4j-examples'
            VariationalAutoEncoderExample (535,828 params) pretrained one
            epoch on the same pixels in [0, 1] (the -ELBO falling,
            ``reconstruction_probability``, ``generate_at_mean`` on a grid,
            one step against float64 on the CPU); an AutoEncoder 784 -> 250
            pretrained one epoch; ``Solver`` L-BFGS and conjugate gradient
            on LeNet over 10,000 images, 10 iterations each (ms and counted
            host syncs an iteration) and one L-BFGS iteration at batch 512
            against float64 on the CPU; EmbeddingLayer,
            TimeDistributedDenseLayer and AutoEncoder on the card against
            float64, both embedding layers with ids out of range and -1,
            and ``check_gradients`` in float64 on the card for a narrow VAE.
            No kernel of the port runs here: the JAX package computes all
            of it outside Pallas.
17. modelimport  DL4J ModelSerializer zips and a Keras HDF5 file restored
            on the card through ``models.zoo.restore_checkpoint`` (format
            detection) and run: (a) the char-RNN at BASELINE config 4's
            width (3,398,752 params) after 2 Adam steps, written with
            ``modelimport.dl4j.write_multilayer_network`` (Adam's m and v
            in ``updaterState.bin``), restored (wall time by stage: read,
            unflatten, install, build), every parameter and the output over
            64 x 128 equal to the source's to the bit, then served through
            the registry (a burst of 64 requests; 2 persistent ``lstm_seq``
            launches per device forward; results against the plain
            forward) and through ``serve --input-shape 128,96`` (a DL4J zip
            stores no sequence length); (b) ResNet50 (``fused=False``,
            224x224x3, 1000 classes, 25,557,032 params) written as a DL4J
            ComputationGraph zip, the zoo's pretrained format (25,636,712
            floats: the params, the BN running mean and variance, a zero
            bias for each of the 53 convs), restored with the zoo's input
            type, parameters and BN state equal to the bit, the output on
            64 images equal to the source's or within the spread of two
            source forwards, one batch of ``evaluate``; no kernel of the
            port there (the format has no FusedConvBNVertex), the conv
            kernels' launches checked to be 0; (c) the Keras examples'
            imdb_lstm (Embedding(20000, 128) -> LSTM(128) -> Dense(1,
            sigmoid), 2,691,713 params, maxlen 80) written as a tf.keras
            HDF5 file (sigmoid gates) by the port's ``Hdf5Archive``,
            restored and run at batch 32 (one persistent ``lstm_seq``
            launch) against a float64 numpy forward of the file's
            datasets, or one skip line where the host has no libhdf5;
            (d) the committed DL4J fixture zips restored on the card
            against their ``*_expected.npy``.
18. moe     the train phase's LM with every TransformerBlock an
            ``MoETransformerBlock`` (8 experts, capacity factor 1.25, aux
            weight 0.01; 117,620,736 params, random weights from the seed),
            built from the config DSL, trained by ``MultiLayerNetwork.fit``
            at batch 4 x 4096 under the f32 policy and ``bf16_policy``: one
            step from identical weights through the plain attention
            forward (the train phase's step check), the routing of every
            block (tokens an expert, dropped, the aux term, and the routing
            flips between the block's attention through the kernel and the
            plain version, each within a top-2 margin of 1e-6), 2 warm-up
            and 10 timed steps with 6 flash launches a step on the planned
            variant and 60 aux terms popped, the loss falling, one profiled
            step (flash forward, attention backward, expert products,
            dispatch/combine, router, optimizer; busy share). Under f32
            then one block's forward and backward under
            ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), the
            trained net served in eval mode through the registry at batch 1
            (8 requests at T = 4096, each answer against ``output``), and a
            fresh net at ``fit(steps_per_dispatch=4)``: one capture, every
            flash launch of 2 timed dispatches from replays, the loss
            falling.
19. sequence ``flash_attention_block`` against its plain version on the
            card (out, lse and dq/dk/dv under random cotangents on both, B=4,
            H=8, D=64, T in {1000, 4096}, f32 and bf16, causal or not, on the
            planned variants), timed at one ring block's shape (B=2,
            T=4096) beside its bound, the plain version and SDPA's forward;
            flash blocks against ``parallel/sequence.py``'s naive blocks at
            T_local in {256, 1024, 4096}. Then ``make_ring_attention_fn``
            (causal and not) and ``ulysses_self_attention`` over 4 spawned
            ranks on the one card (on gloo, since NCCL refuses two ranks on
            one GPU; K/V through pinned host buffers), B=2, T=16,384 (4096 a rank), H=8,
            D=64, f32: forward and dq/dk/dv against whole-T
            ``flash_attention`` on the card, each rank's flash launches (4
            ring blocks a forward, 1 Ulysses call at full T), the ring's
            time, one K/V hop and one block; last the ring at world size 1
            on NCCL against ``flash_attention``. The ranks' times share one
            card and hop through the host: they are not a scaling result.
20. parallel ``parallel/`` data parallelism. (a) world 1 over NCCL in this
            process: ``ParallelTrainer`` on the fused ResNet50 (batch 64,
            224x224) in the replicated, zero1 and fsdp layouts under each
            policy, 2 warm-up and 10 timed steps with 36 + 16 conv
            launches a step on the planned variant and the loss falling;
            each f32 layout's first step against ``ComputationGraph.fit``'s
            step from the same weights (bit-equal, or within the noise of
            fit's step on the batch permuted); then ``fit(steps_per_dispatch
            =4)`` through the trainer: one capture, the conv launches from
            replays. ``ParallelInference`` serves a burst to the trained
            net (every answer against ``output``) and a hot swap answers
            with the new weights; the LM's fsdp and fsdp_stream steps at
            world 1 time the streamed step's recompute alone. (b)-(d) four ranks on the one card over
            gloo (host-staged collectives), each arming
            ``faulthandler.dump_traceback_later``: (b) one step a layout of
            the same ResNet50 on the same global batch of 64 (16 a rank)
            against (a)'s world-1 step within its f32 noise, the BN running
            statistics equal on every rank, each rank's parameter and
            updater-state bytes and the collectives' ms; (c) the
            transformer LM (vocab 8192, 6 x 512, T 4096, global batch 4, 1
            a rank) under fsdp and fsdp_stream: 6 flash launches a step a
            rank under fsdp, 12 under fsdp_stream (the recompute), the step
            against the world-1 step, each rank's peak memory; (d)
            ``SharedTrainingMaster`` on the fused ResNet50 (16 a worker):
            3 exact steps, the first against the per-worker-statistics
            step computed here, then 3 threshold steps with their density
            and tau, and ``ParameterAveragingTrainingMaster`` on LeNet
            (431,080 params) with MNIST-shaped data from the seed.
21. model_parallel  ``parallel/`` model parallelism, 4 ranks on card 0
            over gloo (one spawn), references computed first in this
            process at world 1 (NCCL for the LMs). (a) the MoE LM
            (117,620,736 params) under ``ParallelTrainer(tensor_parallel=
            True)`` on data=2 x model=2: 4 of the 8 experts a rank, routed
            over the global batch (each block's drops summed over the data
            group, printed beside world 1's; the capacity factor lowered
            until a block drops), the embedding and output layer split and
            gathered for their forward; the split step's gradients (each
            data group's mean) against the world-1 step's (each leaf
            within 1e-4 of its own largest, or of 1% of the model's
            largest where that is more), then one step on 2 sequences
            (T 4096) against the world-1 ``fit`` step (loss rtol 1e-4, at
            most 8 parameters beyond 1e-4: Adam's sign flips); its sharded
            checkpoint written by the 4 ranks and restored at world 1
            over NCCL here (``model_parallel.tp_checkpoint``: parameters
            against the saving ranks', save and restore seconds). The LM
            (29,408,256) under ``tensor_parallel=True`` with
            ``fsdp_stream`` (12 flash launches a rank: the recompute), and
            with weight noise on its split layers, on data=2 x model=2:
            the gradient each rank's updater receives against its piece
            of the world-1 step's (the same hashed draws), the loss within
            rtol 1e-4. Cell (a) also prints the model group's collective
            ms (EP combine, weight gathers). (b)
            ``PipelineParallelLM`` (the LM's widths, 29,408,256 params) on
            data=2 x stage=2 (3 blocks a stage), batch 8 as 4 microbatches
            a replica, GPipe and 1F1B: the pipelined loss and
            ``loss_reference`` against the world-1 unpipelined step's
            (rtol 1e-4), every leaf's gradient held as in (a), then a
            timed step (ms, time waiting in hops, peak memory,
            microbatches stashed, flash launches). (c)
            ``ComposedParallelLM`` on stage=2 x model=2 (4 heads a rank),
            batch 8 as 4 microbatches, checked and timed as (b). (d)
            ``PipelinedGraph`` over the fused ResNet50 on stage=4, batch
            64 as 4 x 16, both schedules: loss and BN running state
            against the sequential per-microbatch run here (loss rtol
            1e-4, state 1e-4 of each tensor's magnitude), 144 + 64 conv
            launches a step over the stages. (e) ``PipelinedNetwork`` over
            the char-RNN on data=2 x stage=2, batch 64 as 4 x 8 a replica,
            masked, both schedules: the loss against the whole batch's
            masked loss (rtol 1e-5), 4 ``lstm_seq`` launches a rank. (f)
            ``ParallelInference(mesh=)`` over data=4 on the fused
            ResNet50: 32 requests, every answer row within 1e-5 of its
            largest of ``output`` on that rank's 8 rows (a row sent
            elsewhere fails), and the top class of every row equal to
            ``output`` on the whole batch's where its top-2 margin is
            more than twice the row's gap to it. A rank's failure fails
            the phase.

22. telemetry  the port's telemetry core: the transformer LM (T 4096, 6
            flash launches a step) 10 timed ``fit`` steps with telemetry
            off, then on, twice over (the watchdog off in both): step ms
            (medians within 3%) and the host's waits on the card counted
            under ``set_sync_debug_mode("warn")`` (equal); the
            ``train_step_seconds`` count and the iteration counter equal
            the steps, the score gauge the last loss read; one
            ``profile_round`` window around one round: its
            ``torch.profiler`` trace holds one ``fit.step`` range and the
            flash kernels' device events launched inside it, each of the 6
            launches accounted for by its device event or as a launch the
            trace kept without one (``launch_check``, printed with where in
            the step each lost launch fell), and, with none lost,
            ``top_ops``' top 8 lists the kernel; the HBM gauges against ``memory_allocated`` and
            ``max_memory_allocated``; a burst of 64 requests to the served
            char-RNN (``lstm_seq`` 2 a forward): the request counter, the
            latency histogram and the completed traces count 64; a NaN in
            the last of 4 char-RNN batches with the watchdog recording:
            one anomaly and one flight dump.
23. operations  (a) the fused ResNet50 (f32 policy) through ``StepDriver``:
            2 warm-up and 10 timed dispatches with telemetry off, then on
            with the goodput ledger (``set_flops_per_step(3 x
            resnet50_flops_per_example() x 64)``, ``device_peak_flops()``),
            one ``checkpoint()`` between the timed rounds: the six
            categories sum to the window within 5%, the noted checkpoint
            seconds within 5% of the host clock around the call, MFU in
            (0, 1] and within 5% of the host clock's, 36 + 16 conv launches
            a step, host syncs equal off and on; (b) the char-RNN
            registered on the serve phase's buckets, 256 requests of seq
            32-128 from two tenants and 16 ``origin="probe"``, with
            ``update_model`` to a second set of weights after 128 submits:
            nothing dropped or failed, each answer within 1e-4 of exactly
            one net's ``output`` on its row, one swap, the usage rows by
            tenant the rows served, ``health()`` with the stats, recapture
            counts and usage, ``lstm_seq`` 2 a device forward; (c) on (b)'s
            registry: the default SLO rules silent over (b) (sampled every
            32 submits with the history), ``rate_over`` equal to the SLO
            engine's rate on the same samples, ``ShapeBuckets.from_demand``
            on that history covering every length requested, a flood on a
            queue of 8 firing ``serving_shed_ratio`` (named in a flight
            dump), and ``federate`` over the local registry and a closed
            localhost port: back within its timeout, the dead member
            counted, an SLO rule over it ok, ok, then firing on a real burn.
24. compile_tune  (a) ``tuning/tune.py`` into a fresh TuningDB at the main
            paths' shapes: every distinct conv key of the fused ResNet50 at
            batch 64 (1x1: rows, Cin, Cout; 3x3: B, Ho, Wo, Cin, Cout) in
            f32 and bf16, the LSTM at T=128 B=64 and B=1 H=512 (f32), B=64
            H=1024 (f32: persistent rt against step_cluster split) and B=64
            H=512 bf16, the LM's attention (B=4, T=4096, H=8, D=64, causal)
            in f32 and bf16 against the naive path, each candidate timed
            as replays of a CUDA graph of its launches; a line a shape
            (candidates enumerated, pruned by reason, rejected by parity,
            timed; the default plan's, the fastest's and the winner's ms
            and the margin), the default plan a timed valid candidate
            everywhere and the winner unless beaten by more than the
            margin, no candidate raising, ``tuning_db_total{tune}`` the
            shapes tuned; (b) one forward
            each of the fused ResNet50 (f32, batch 64, train mode), the LM
            (T 4096) and the char-RNN (64 x 128), without and then with
            the DB bound (two calls each, the second timed): outputs
            within SERVE_ATOL, the variants launched those of the plans
            resolved, ``tuning_db_total{hit}`` the distinct plan keys, no
            miss; (c) the char-RNN served on the serve phase's grid by the
            ``serve`` CLI in three processes with ``--compile-cache``: cold
            (an empty directory: nvcc builds ``lstm_seq.cu`` once, its
            seconds on a line of their own), persistent (the same
            directory: no nvcc run) and warm (another empty directory and a
            manifest this process saved with ``save_warm_manifest``: no
            nvcc run, a hit for each of the 21 grid entries, no miss), the
            answers bitwise equal across the legs (their sha256), each leg's
            ``time_to_first_request_ms``; another grid's manifest refused
            by ``update_model(manifest=)`` (grid_mismatch), and a manifest
            saved under the DB missing every entry without it.

25. continuous  (a) the full-width char-RNN trained by a
            ``ContinuousTrainer`` at K=4 from a ``StreamingBroker`` topic fed
            by the chaos publisher subprocess (37 batches of 64 x 128
            one-hot rows, one snapshot a round): the NaN batch ends in one
            counted rollback of its dispatch (4 steps), the batch published
            600 s old in one counted stale drop, the first publisher
            SIGKILLed after 20 batches and a replacement resuming there in
            counted ingest retries (retried, then one recovered, none
            fatal); no batch dropped by the broker or the subscriber; the
            final digest (``chaos.state_digest``) bit-equal to a clean
            offline ``ContinuousTrainer`` run on the card over the batches
            the chaos run kept; its snapshot after the first dispatch
            against ``fit`` of the same 4 batches at the charnn phase's f32
            parameter tolerance; 2 ``lstm_seq`` launches a step from the
            replays; steps a second, snapshot seconds. (b)
            ``registry_updater`` swapping a ``ModelRegistry`` at every
            published snapshot: a probe batch
            answered within SERVE_ATOL of the snapshot's forward after each
            swap, and every answer of a client thread asking all along
            within SERVE_ATOL of one snapshot's forward (none dropped or
            mixed). (c) a ``FleetSupervisor`` of 2 worker processes on the
            card from the first round's snapshot and the registry engine's
            warm manifest, in an empty kernel cache directory (every grid
            entry from the manifest, no nvcc run), a ``FleetRouter`` sweep
            of 200 requests of 1-8 rows from 4 clients in a closed loop,
            w0 SIGKILLed at the 60th: all served within SERVE_ATOL of the
            snapshot's forward, the failover counted, the replacement warm with no nvcc build, then
            ``fleet_updater`` pushing the final snapshot to both workers,
            each answering within SERVE_ATOL of it and reporting
            ``lstm_seq`` launches; p50/p99, respawn and swap seconds. (d) a
            world-1 ``ParallelTrainer`` (NCCL) over the char-RNN saved by
            ``save_trainer`` with its net's warm manifest and restored into
            a fresh trainer: parameters bitwise the saved ones, its first
            K=4 dispatch a manifest hit with no nvcc build and no plan
            lookup.
26. dashboard  (a) the full-width char-RNN (f32), saved by ``save_model``,
            trained as the ``train`` verb trains it with one worker: 512
            one-hot rows of 128 x 96 from the seed through
            ``DistributedMultiLayer`` over a world-1 ``SharedTrainingMaster``
            (NCCL, batch 64: 8 steps), once without and once with a
            ``StatsListener`` into an ``InMemoryStatsStorage`` behind a
            ``UIServer``: 2 ``lstm_seq`` launches a step on ``persistent``;
            the records' scores the fit's losses, both runs' alike; the last
            record's l2 of each leaf within 1e-5 relative of the host
            copy's; exactly one host sync more a record (the sync debug
            mode); step ms with and without over steps 2-8 (the host clock
            at each step's record), the first step's and the listener's
            one-time ``_post_init`` apart; every UI route answering
            JSON or HTML with the run's session, POST /remote taken; then a
            K=4 fit captured, and a second replayed while a thread polls
            /health and /train/overview: one capture, 2 launches a step
            from the replays. (b) ``python -m deeplearning4j_tpu_torch
            train`` on the same zip and .npy files (1 worker, batch 64,
            ``--ui-port 0``, ``--model-output-path``, ``--report-score``):
            exit 0, its loss and its saved zip's forward within 1e-5 of
            (a)'s. (c) ``serve --port 0 --smoke 64`` and ``fleet --workers 2
            --warm-manifest`` (a manifest saved in this process) ``--smoke
            64`` on the trained zip, side by side: both exit 0, every
            request answered, /serving and /fleet read while they run, both
            workers warm with no nvcc run, each worker's ``lstm_seq``
            launches read from its /health. (d) LeNet (the mnist phase's
            net, library convs) 8 steps with a
            ``ConvolutionalIterationListener`` every 4: a grid per 4-D
            activation at steps 4 and 8, the last ones equal to
            ``activations_to_grid`` of the final forward. (e)
            ``NeuralNetClassifier(device="cuda")`` fit and predict on 4,096
            x 784 rows of 10 classes (the sklearn stand-ins where sklearn is
            missing): predict is the argmax of the wrapped net's output.
27. hostfleet  ``TrainingFleetSupervisor`` jobs of 2 host processes sharing
            card 0 at MNIST MLP widths (784-1024-10, batch 256, zero1, 3
            rounds of one step): (a) hostavg, clean, its hosts' digests
            equal and the registry probe (``--serve-registry``) within 1e-6;
            (d) gspmd over gloo, its hosts' digests equal, side by side with
            (a); (b) host 1 SIGKILLed mid-round 1: world 1, one counted
            rollback, its digest equal to a fault-free world-1 job from the
            rollback bundle; (c) the same kill with ``respawn=True``: world
            2 again, its digest (a)'s; (b) and (c) side by side. Each host's
            ready seconds and round ms, exchange ms and bundle seconds, the
            respawn seconds.

The four rank cells (``word2vec.mesh``, ``sequence``, ``parallel``,
``model_parallel``) prepare their references in their phases and run in
ONE spawn of 4 gloo ranks on card 0 (``run_rank_cells``, the ``ranks``
line), each rank body in turn as a process of its own would; each phase's
lines come after it.

Then a ``kernels`` line (every kernel of the paths with its launches on
its path, error, times and bound), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.

cuDNN's TF32 is off only around the kernel checks (their plain versions and
library yardsticks) and the library timings; the training and serving
phases run as a user's call does, under the port's policy
(``utils/dtypes.policy_precision``: TF32 off under f32).

Tolerances: lstm_seq f32 kernel vs plain, atol 1e-4 (the two sum the
recurrent product in different orders over 128 dependent steps); bf16
operands, atol 2e-2 + rtol 2e-2 (outputs are stored in bf16, whose ulp is
2^-8 relative, and a last-bit difference in h feeds every later step);
served softmax outputs vs the plain forward, atol 1e-4. flash_attn f32 out
atol 1e-5 (one softmax-weighted sum per row, in another order), lse atol
1e-5 + rtol 1e-6 (lse is ~10 at T=4096, where an f32 ulp is ~1e-6);
gradients atol 1e-5 + rtol 1e-4 (sums over up to 4096 rows); bf16 2e-2 +
2e-2·|x| (the kernel rounds p to bf16 against the running max, the plain
version against the final one; one bf16 ulp is 2^-8). conv kernels: f32 z
atol 1e-4 (sums of up to 4608 products in another order); bf16 z 2e-2 +
2e-2·|z| (one bf16 ulp: the two f32 accumulators may round to neighbours);
each statistic within 1e-5 of the sum of its terms' magnitudes + 1e-3
(sum z cancels, so its error is measured against sum |z|; sum z^2 against
itself), in both dtypes, since both take the sums from f32 accumulators of
the same exact products. Training: the
kernel step and the plain-attention step agree to loss rtol 1e-4, and
to updated parameters atol 1e-4 under the f32 policy; under bf16_policy,
where one-ulp operand flips move near-zero gradient elements by their own
size and Adam's first step amplifies that to up to 2·lr, each tensor's
gradient to a relative difference of 1e-2 (parameter difference
reported). ResNet50 (f32): the kernel step agrees with the plain-version
step to loss rtol 1e-4 and BN running state atol 1e-4; its gradients and
updated parameters are held against the step's own f32 noise, measured as
the plain step on the same batch permuted (see ``resnet_step_check``): at
this init that noise alone is ~3% in the gradients and ~190k parameters
beyond 1e-4 after Adam's first step. Char-RNN: the kernel step against the
plain-forward step, f32 loss rtol 1e-5, each gradient within 1e-4 of its
norm, parameters after RmsProp's first step atol 1e-4; bf16 loss rtol
1e-3, each gradient within 2e-2 of its norm, at most 1% of the parameters
beyond 1e-4 (see ``charnn_step_check``);
``rnn_time_step`` against the full forward atol 1e-5 in f32 (the same
kernel, one launch a step from the carried f32 state), 2e-2 in bf16; the
split ``lstm_seq`` run against the whole one, atol 1e-4. Zoo: the card's
Inception-ResNet v1 step against float64 within 1.5x the f32 step's noise
(see ``irv1_step_check``), embeddings' norms 1 within 1e-5 (f32), the
restored checkpoints' outputs within 1e-4 (f32; resnet50_mln's pooled
features too, relative to their largest); the remat step against the plain
one as ``resnet_step_check`` holds the kernel step, under each policy.
Fine-tune: the kernel step against the step whose stage-3 convs are
exactly rounded (the plain versions in float64), as ``noise_check`` holds
the zoo's card-vs-float64 step: loss, gradients all together and updated
parameters within 3x (FT_NOISE_FACTOR) the f32 noise, the largest distance
from it of the plain-version step on the card, on the batch permuted and
on the CPU (a permutation alone leaves each image's conv sums as they
were; the kernel's one-chain sums ran 1.0-1.4x the library's); BN state
relative to each tensor's magnitude (stage 3 sees activations far from
unit scale behind the source's frozen statistics); single tensors
reported; served rows against ``output()`` at batch 64
within 1e-4 (softmax probabilities; cuDNN may choose another algorithm at
another batch size, and the phase first measures the rows' difference
between batch 1 and batch 64, which must be at most half of it); Tiny
YOLO's f32 step against float64 as Inception-ResNet v1's; each new conv
layer on the card within 1e-4 of the float64 tensor's largest magnitude
(f32 sums of up to 2304 products). Word2vec: the card's chunk of 32 SGNS
steps (syn0, syn1 and the losses, each by its largest difference) within
3x (W2V_CHECK_FACTOR) the f32 noise from float64, the noise being the larger
of the spread between two card runs of the chunk (``index_add_``'s atomics
sum a row's gradients in no fixed order) and the plain f32 step's own
distance from float64 on the CPU; the quality checks hold the JAX tests'
orderings (t-SNE: mean silhouette of the two clusters above 0.25, see
W2V_TSNE_SILHOUETTE). MNIST: the streaming normalizer within 1e-6 of the
one-shot float64 fit (relative; float32 results); the restored net's
outputs equal to the bit and the ``eval`` verb's statistics equal to
``evaluate``'s (the CSV holds each float32 value to 9 digits, which
round-trips it, and the verb runs the same batches); test accuracy at
least MN_MIN_ACCURACY; the int8 net's accuracy within
MN_QUANT_ACCURACY_DROP of the f32 net's; the VAE step and the L-BFGS
iteration on the card against float64 on the CPU within 3x
(MN_NOISE_FACTOR) the f32 noise in loss, gradients (all together),
updated parameters' largest difference and the accepted step, the noise
the larger of the f32 step on the CPU and the card's step on the batch
permuted (parameters beyond 1e-4: 3x the noise's count plus
MN_SIGN_FLIPS, for near-zero gradients whose sign rounds either way under
RmsProp's first step); the new layers on the card within 1e-4
(LAYER_RTOL) of each float64 tensor's largest magnitude; the embedding
rows for bad ids exactly ``jnp.take``'s (NaN rows, -1 the last row).
Model import: the restored char-RNN and ResNet50 hold the source's
parameters and state to the bit (the same float32 values copied), and the
char-RNN's output is equal to the bit (same weights, same kernel); the
ResNet50's output equal to the bit or within the spread of two forwards of
the source; served rows against the plain forward atol 1e-4 (SERVE_ATOL);
imdb_lstm against the float64 numpy forward atol 1e-5 (KERAS_ATOL: sigmoid
outputs in (0, 1) after 80 f32 steps); the fixture zips rtol 1e-5 + atol
1e-6, the CPU test's tolerance, with cuDNN's TF32 off. MoE: the step check
as the train phase's; served answers within 1e-5 of ``output`` on the same
ids (the same forward at batch 1; bit-equal answers counted). Sequence:
the block entry at the flash phase's tolerances; ring and Ulysses against
whole-T ``flash_attention`` at rtol 2e-4 + atol 2e-5 forward and rtol 1e-3
+ atol 1e-4 gradients (the JAX ring tests' tolerances); the world-1 ring
the same.
"""

from __future__ import annotations

import contextlib
import gc
import gzip
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zipfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"
#: the rank cells' files, kept from their phases' preparation to the one
#: spawn of 4 ranks that runs them all (``run_rank_cells``)
RANKS_WORK = ROOT / "_smoke_ranks"
_T0 = time.perf_counter()

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32_OPS_S = 495e12

F32_ATOL = 1e-4
BF16_ATOL = BF16_RTOL = 2e-2
SERVE_ATOL = 1e-4
# the serve phase's extra burst under the runtime sanitizer
SAN_REQUESTS = 64

VOCAB, HIDDEN, SEQ = 96, 512, 128
N_PARAMS = 3_398_752
SEED = 12345

FLASH_F32_ATOL = 1e-5
FLASH_LSE_ATOL, FLASH_LSE_RTOL = 1e-5, 1e-6
FLASH_GRAD_ATOL, FLASH_GRAD_RTOL = 1e-5, 1e-4
FLASH_BF16_TOL = 2e-2
STEP_LOSS_RTOL, STEP_PARAM_ATOL, STEP_BF16_GRAD_RTOL = 1e-4, 1e-4, 1e-2

# the JAX package's long-context bench: transformer_lm(8192, 6 layers,
# d_model 512, 8 heads, seq 4096) at batch 4
LM_VOCAB, LM_LAYERS, LM_WIDTH, LM_HEADS, LM_SEQ, LM_BATCH = 8192, 6, 512, 8, 4096, 4
LM_PARAMS = 29_408_256
WARMUP_STEPS, TIMED_STEPS = 2, 10
CROSSOVER_T = (256, 512, 1024, 2048, 4096)

# the JAX package's flagship bench: ComputationGraph resnet50(fused=True),
# batch 64, 224x224x3, 1000 classes
RN_BATCH, RN_HW, RN_CLASSES, RN_PARAMS = 64, 224, 1000, 25_557_032
RN_TASK_CLASSES = 10
RN_WARMUP_STEPS, RN_TIMED_STEPS = 2, 10
CONV_F32_ZTOL = 1e-4
CONV_BF16_TOL = 2e-2
CONV_STATS_RTOL, CONV_STATS_ATOL = 1e-5, 1e-3
RN_LOSS_RTOL, RN_STATE_ATOL, RN_PARAM_ATOL, RN_NOISE_FACTOR = 1e-4, 1e-4, 1e-4, 1.5

# the char-RNN trained at its full width (BASELINE config 4): batch 64 x 128,
# TBPTT over 4 chunks of 128, streaming over 16 steps
CHARNN_BATCH, CHARNN_TBPTT_CHUNKS, CHARNN_TBPTT_BATCHES, STREAM_STEPS = 64, 4, 3, 16
CHARNN_LOSS_RTOL, CHARNN_GRAD_RTOL, CHARNN_PARAM_ATOL = 1e-5, 1e-4, 1e-4
CHARNN_BF16_LOSS_RTOL, CHARNN_BF16_GRAD_RTOL, CHARNN_BF16_PARAM_SHARE = 1e-3, 2e-2, 1e-2
# steps after the timed ones before the loss is held to have fallen (RmsProp's
# first steps move every weight by ~lr/sqrt(1 - decay) and the loss swings)
CHARNN_MORE_STEPS, CHARNN_LOSS_WINDOW = 28, 5
STREAM_F32_ATOL = 1e-5

# the zoo phase: Inception-ResNet v1 with the FaceNet head and GoogLeNet at
# the zoo's widths (inception.py defaults), the fused ResNet50 with remat
IR_BATCH, IR_HW, IR_CLASSES, IR_PARAMS = 64, 160, 1001, 16_863_161
GN_BATCH, GN_HW, GN_CLASSES, GN_PARAMS = 64, 224, 1000, 8_048_152
# GoogLeNet's first Adam steps (lr 1e-3, no batch norm) can drive every
# true-class probability under mcxent's 1e-8 clip, where the gradient is 0
# and the loss stays pinned at ~16. On the H100 (utils/collapseprobe.py),
# 2 of 8 dropout streams do so at --seed's weights and images (3 of 8 with
# masks from a torch.Generator), none of 8 at the next seed's (1 of 8).
# The GoogLeNet run takes its weights and images from seed + GN_SEED_OFFSET,
# so its loss check tests the training path rather than one stream's luck.
GN_SEED_OFFSET = 1
ZOO_WARMUP_STEPS, ZOO_TIMED_STEPS, ZOO_LOSS_WINDOW = 2, 10, 5
ZOO_CHECK_BATCH, ZOO_CKPT_ATOL = 8, 1e-4

# the finetune phase: the fused ResNet50 above trained two steps, saved,
# restored, frozen up to s2b5_relu with a fresh 5-way head (Adam 1e-3); its
# unfrozen stage 3 launches the conv kernels 7 + 3 times a step
FT_CLASSES, FT_EXTRACTOR, FT_SOURCE_STEPS = 5, "s2b5_relu", 2
FT_PARAMS, FT_TRAINABLE, FT_FROZEN = 23_518_277, 14_974_981, 45
FT_CONV_A_STEP = {"conv_mm_stats": 7, "conv3x3_stats": 3}
FT_EVAL_IMAGES, FT_ES_EPOCHS = 640, 3
FT_MIN_ACCURACY = 0.6  # chance is 1/5: held-out accuracy above it by 0.4
FT_LISTENER_ALLOWANCE = 0.1
# the fine-tune kernel step against its exactly rounded one, in units of the
# library f32 steps' distance from it: the kernel sums each output in one
# chain of up to 4608 products, which put it 0.96x, 1.23x and 1.38x the
# library's distance (gradients, all together) in three runs on the card; a
# wrong function moves the gradients by orders of magnitude more
FT_NOISE_FACTOR = 3.0
FT_SERVE_BUCKETS, FT_SERVE_REQUESTS, FT_SERVE_MAX_ROWS = (1, 2, 4, 8, 16, 32, 64), 256, 16
FT_SERVE_ATOL = 1e-4
# Tiny YOLO at the registry's defaults (416x416, 20 classes, 5 VOC anchors)
YOLO_BATCH, YOLO_HW, YOLO_CLASSES, YOLO_PARAMS = 32, 416, 20, 15_861_773
YOLO_CHECK_BATCH, YOLO_CHECK_HW, YOLO_DETECT_IMAGES, YOLO_DETECTIONS = 4, 224, 4, 64
LAYER_BATCH, LAYER_HW, LAYER_C, LAYER_RTOL = 4, 56, 128, 1e-4

# the fused phase: K steps a dispatch; a ragged dataset of 10 batches less
# half a batch gives 3 dispatches, the last with 2 real steps and a padded
# batch; the K-step run held against K=1 within 3x the card's f32 noise
# (depth cut for the time limit with the dashboard and hostfleet phases:
# epochs 3 -> 2, one capture across them still held; profiled dispatches
# 3 -> 1; the unheld repeat of the K=1 fit dropped)
FUSED_K, FUSED_EPOCHS, FUSED_NOISE_FACTOR = 4, 2, 3.0
FUSED_RAGGED_N = 10 * RN_BATCH - RN_BATCH // 2
# (the timed dispatches were 10 until the operations phase joined the script)
FUSED_TIMED_DISPATCHES, FUSED_PROFILED_DISPATCHES = 5, 1
FUSED_DC_RETAIN, FUSED_DC_STEPS = 0.9, 8
FUSED_NAN_BATCH, FUSED_RESUME_ROUNDS = 5, 2

# the word2vec phase: BASELINE config 3 at the JAX package's
# bench_word2vec production scale (BENCH_W2V_SCALE=production): a Zipf
# corpus of 500,000 sentences x 20 int tokens (10M words) over 100,000
# ranks; Word2Vec at D=300, window 5, 5 negatives, batch 2048, subsample
# 1e-3, lr 0.025, 1 epoch; here the corpus is cut to 125,000 sentences
# (2.5M words; ~97,000 of the 100,000 ranks drawn at least once) to keep the
# full script inside its time limit: cut to 5M words when a full run took
# 1016.6 s with the compile_tune phase, and to 2.5M with the continuous
# phase (~90 s), when a full run would have passed 1100 s. The full-width chunk is held against float64
# within W2V_CHECK_FACTOR x the f32 noise (the larger of two card runs'
# spread and the plain f32 step's own distance from float64)
W2V_VOCAB, W2V_DIM, W2V_SENT_LEN, W2V_SENTENCES = 100_000, 300, 20, 125_000
W2V_WINDOW, W2V_NEGATIVE, W2V_BATCH, W2V_SUBSAMPLE, W2V_LR = 5, 5, 2048, 1e-3, 0.025
W2V_CHECK_FACTOR, W2V_TIMED_REPLAYS, W2V_PROFILED_REPLAYS, W2V_TOP_KERNELS = 3.0, 20, 3, 12
# t-SNE keeps the two toy clusters apart: mean silhouette above 0.25 (on the
# CPU 0.34-0.46 for seeds 3-5 in f32 and f64). The JAX test's gap > 2 x
# spread is decided by last-bit chaos on this data (JAX f64 passes, JAX
# f32 fails, the port the other way round), so it is not used here
W2V_TSNE_SILHOUETTE = 0.25
# SequenceVectors over a mesh: W2V_MESH_RANKS gloo ranks on the one card;
# the replicated-table fit on the phase's first W2V_MESH_WORDS words within
# W2V_MESH_ATOL of the world-1 fit of the same pairs (its ragged tail cut to
# a multiple of the axis, as the mesh cuts it; the CPU test's fit
# tolerance), the table-sharded fit on the first W2V_SHARD_WORDS within
# W2V_SHARD_RTOL + W2V_SHARD_ATOL of the world-1 fit (the CPU test's), each
# or within W2V_CHECK_FACTOR x the world-1 fit's distance from itself run
# again where that is more (the card's scatter sums add in no fixed order).
# Every fit builds its vocabulary on the phase's whole corpus first, so the
# tables have the production width (V ~99,000 rows x 300, V/4 a rank when
# sharded) and only the words fitted are cut: from 1M to the slices, to keep
# the script inside its time limit (ranks sharing one card over gloo step at
# ~40-60 ms; cut to a quarter with the operations phase, when full runs took
# 1142.7 and 1172.7 s of 1200 on slower hosts, and to an eighth with the
# compile_tune phase, when a full run took 1037.2 s)
W2V_MESH_WORDS, W2V_SHARD_WORDS, W2V_MESH_RANKS, W2V_MESH_ATOL = 31_240, 15_620, 4, 2e-6
W2V_SHARD_RTOL, W2V_SHARD_ATOL, W2V_MESH_TIMEOUT_S = 1e-5, 1e-6, 600


# the mnist phase: BASELINE config 1 as DL4J's LenetMnistExample runs it
# (LeNet, 431,080 params, batch 256, one epoch of MNIST-size data read
# through the fetcher, standardized by a fitted normalizer), then the rest
# of the training core on the same pixels: dl4j-examples'
# VariationalAutoEncoderExample widths (784 -> 256, 256 -> 2 -> 256, 256 ->
# 784, Bernoulli, leaky relu, RmsProp 1e-3, batch 128: 535,828 params), the
# first layer of its MNIST anomaly example as an AutoEncoder (784 -> 250,
# AdaGrad 0.05), and the full-batch solvers on LeNet over 10,000 images
MN_TRAIN, MN_TEST, MN_BATCH, MN_PARAMS = 60_000, 10_000, 256, 431_080
MN_TEMPLATE_GAIN, MN_PIXEL_NOISE, MN_MAX_SHIFT = 0.3, 120.0, 3
MN_LOSS_WINDOW, MN_PROFILED_STEPS, MN_NORM_RTOL = 10, 5, 1e-6
MN_MIN_ACCURACY = 0.85
MN_QUANT_ACCURACY_DROP = 0.01
MN_NOISE_FACTOR, MN_PARAM_ATOL, MN_SIGN_FLIPS = 3.0, 1e-4, 8
F32_ULP = 2.0 ** -23
VAE_BATCH, VAE_PARAMS, VAE_LR, VAE_SCORED, VAE_GRID = 128, 535_828, 1e-3, 1000, 10
AE_HIDDEN, AE_LR = 250, 0.05
SOLVER_N, SOLVER_ITERS, SOLVER_CHECK_BATCH = 10_000, 10, 512
GRADCHECK_PER_LEAF = 4

# the moe phase: the train phase's LM with every TransformerBlock an
# MoETransformerBlock of 8 experts at the layer's defaults (Switch
# Transformer's capacity factor 1.25 and aux weight 0.01): 117,620,736
# params (the JAX package's init under jax.eval_shape); per block N = 16,384
# tokens and C = 2,560 slots an expert. A routing decision may differ
# between the kernel's and the plain attention only where the top-2 router
# probabilities are within MOE_TIE_MARGIN
MOE_EXPERTS, MOE_CAPACITY, MOE_AUX, MOE_PARAMS = 8, 1.25, 0.01, 117_620_736
MOE_TIE_MARGIN = 1e-6
# under bf16_policy a flip is held to the router logit gap that one bf16
# ulp (at most BF16_ULP of each element's magnitude) on every router input
# element can close (``flip_gaps``); MOE_WORST_LEAVES leaves are reported
# from the bf16 steps routed each by itself
BF16_ULP, MOE_WORST_LEAVES = 2.0 ** -7, 3
MOE_K, MOE_K_DISPATCHES, MOE_SERVE_REQUESTS = 4, 2, 8
# the sequence phase: ring and Ulysses attention over SEQ_RANKS processes on
# the one card (B=2, T=16,384: 4096 a rank, H=8, D=64, f32) against whole-T
# flash_attention at the JAX ring tests' tolerances (tests/test_attention.py)
SEQ_RANKS, SEQ_B, SEQ_T, SEQ_BLOCK_T = 4, 2, 16_384, (256, 1024, 4096)
SEQ_FWD_RTOL, SEQ_FWD_ATOL, SEQ_GRAD_RTOL, SEQ_GRAD_ATOL = 2e-4, 2e-5, 1e-3, 1e-4
SEQ_TIMEOUT_S = 300
RANK_CELLS_WORLD = 4  # the one spawn's ranks: the four rank cells' world
# the parallel phase: (a) world 1 over NCCL, (b)-(d) DP_RANKS ranks on the
# one card over gloo; a rank that hangs dumps its stacks and exits after
# DP_HANG_S seconds
DP_LAYOUTS, DP_LM_LAYOUTS, DP_RANKS, DP_K = ("replicated", "zero1", "fsdp"), \
    ("fsdp", "fsdp_stream"), 4, 4
DP_SHARED_STEPS, DP_THRESHOLD, DP_PA_FREQ, DP_PA_BATCH, DP_PA_SPLITS = 3, 1e-3, 2, 32, 2
DP_SERVE_REQUESTS, DP_SERVE_BATCH, DP_SERVE_ATOL = 32, 16, 1e-4
DP_HANG_S, DP_TIMEOUT_S = 420, 480
# a step of another summation order (world 4: per-rank partial statistics,
# the mean of four means) held to 3x the step's permutation noise, plus a
# few Adam first-step sign flips of near-zero gradients (the MNIST phase's
# allowance)
DP_NOISE_FACTOR, DP_SIGN_FLIPS = 3.0, 8
# the model_parallel phase: MP_RANKS ranks on the one card over gloo. (a)
# the MoE LM at MP_MOE_BATCH sequences on data=MP_DATA x model=MP_TP (4
# experts a rank, routed over the global batch; the capacity factor lowered
# by MP_CAPACITY_STEP, down to MP_CAPACITY_MIN, until a block drops tokens);
# the LM under tensor_parallel + fsdp_stream and with weight noise, at
# MP_STREAM_BATCH sequences on data=MP_DATA x model=MP_TP;
# (b), (c) the LM at batch MP_LM_BATCH, MP_MICRO microbatches a replica;
# in (a)-(c) each leaf's gradient within MP_GRAD_RTOL of the larger of its
# own largest and MP_GRAD_FLOOR of the model's largest (a leaf whose
# gradient is 0 in exact arithmetic, as the key bias's, is rounding noise
# held to the model's scale); (d) the fused ResNet50's batch 64 as
# MP_RN_MICRO microbatches; (e) the char-RNN's batch MP_CH_BATCH as
# MP_CH_MICRO a replica, the masked loss within MP_CH_LOSS_RTOL; (f)
# MP_INFER_REQUESTS requests, each answer row within MP_INFER_ROW_RTOL of
# its largest of ``output`` on the same rows
MP_RANKS, MP_DATA, MP_TP, MP_MOE_BATCH = 4, 2, 2, 2
MP_CAPACITY_STEP, MP_CAPACITY_MIN, MP_STREAM_BATCH, MP_NOISE_STD = 0.8, 0.25, 2, 0.01
MP_LM_BATCH, MP_MICRO, MP_GRAD_RTOL, MP_GRAD_FLOOR = 8, 4, 1e-4, 1e-2
MP_RN_MICRO, MP_CH_BATCH, MP_CH_MICRO, MP_CH_LOSS_RTOL = 4, 64, 4, 1e-5
MP_INFER_REQUESTS, MP_INFER_ROW_RTOL, MP_HANG_S, MP_TIMEOUT_S = 32, 1e-5, 420, 480
# the telemetry phase: TEL_ROUNDS alternations of TEL_STEPS LM steps with
# telemetry off and on (the medians' ratio at most TEL_OVERHEAD, the host
# syncs equal), a burst of TEL_REQUESTS requests to the served char-RNN
TEL_STEPS, TEL_ROUNDS, TEL_OVERHEAD, TEL_REQUESTS = 10, 2, 1.03, 64
# the operations phase: (a) the fused ResNet50 through StepDriver with the
# goodput ledger, RN_WARMUP_STEPS + RN_TIMED_STEPS dispatches over
# OPS_RN_BATCHES distinct batches, one checkpoint halfway through the timed
# ones; the categories within OPS_GOODPUT_RTOL of the window, the noted
# checkpoint seconds and the MFU within it of the host clock's; (b)
# OPS_REQUESTS requests of seq OPS_MIN_SEQ..SEQ from two tenants plus
# OPS_PROBES probes to the served char-RNN, hot-swapped after OPS_SWAP_AT,
# the history sampled every OPS_SAMPLE_EVERY submits; (c) a flood of
# OPS_FLOOD submits on a queue of OPS_FLOOD_QUEUE, federation with one dead
# member under a OPS_FED_TIMEOUT_S timeout
OPS_RN_BATCHES, OPS_GOODPUT_RTOL = 4, 0.05
OPS_REQUESTS, OPS_PROBES, OPS_MIN_SEQ, OPS_SWAP_AT, OPS_SAMPLE_EVERY = 256, 16, 32, 128, 32
OPS_FLOOD, OPS_FLOOD_QUEUE, OPS_FED_TIMEOUT_S, OPS_BURN_ROWS = 512, 8, 1.0, 64
OPS_FLOOD_SEED = 53

# compile_tune: each candidate timed as CT_REPS replays of a CUDA graph of
# CT_ITERS launches, its best; the LSTM shapes tuned (T, B, H, dtype); the char-RNN's forward
# at CT_CHARNN_ROWS rows; the serve legs on the serve phase's grid, each
# answering CT_REQUESTS smoke requests
CT_ITERS, CT_REPS = 5, 3
CT_LSTM = ((128, 64, 512, torch.float32), (128, 1, 512, torch.float32),
           (128, 64, 1024, torch.float32), (128, 64, 512, torch.bfloat16))
CT_CHARNN_ROWS, CT_MAX_BATCH, CT_SEQ_BUCKETS, CT_REQUESTS = 64, 64, (32, 64, 128), 16

# continuous: the full-width char-RNN (f32 policy) trained by a
# ContinuousTrainer at K=CONT_K from a stream of CONT_BATCHES batches of
# CHARNN_BATCH x SEQ one-hot rows (6.3 MB a batch) made from CONT_GEN_SEED
# and published every CONT_INTERVAL_S by the chaos publisher, one snapshot
# a round; the faults: the NaN batch CONT_POISON, the batch CONT_STALE
# published CONT_DELAY_S old against a staleness bound of CONT_STALENESS_S,
# the first publisher stalled after CONT_STALL batches and SIGKILLed once
# they are taken, its replacement started after the stream was quiet for
# 2.5 x CONT_QUIET_S; a client asking the registry every
# CONT_CLIENT_EVERY_S; the fleet: CONT_WORKERS workers, CONT_REQUESTS
# requests of 1..CONT_MAX_ROWS rows from CONT_OUTSTANDING clients in a
# closed loop, w0 SIGKILLed at request CONT_KILL_AT
CONT_K, CONT_BATCHES, CONT_POISON, CONT_STALE, CONT_STALL, CONT_GEN_SEED = 4, 37, 13, 6, 20, 71
CONT_INTERVAL_S, CONT_STALENESS_S, CONT_DELAY_S, CONT_QUIET_S, CONT_RETRIES = \
    0.05, 60.0, 600.0, 1.0, 8
CONT_CLIENT_EVERY_S, CONT_WORKERS, CONT_REQUESTS, CONT_MAX_ROWS = 0.05, 2, 200, 8
CONT_OUTSTANDING, CONT_KILL_AT = 4, 60
# dashboard: 512 one-hot char-RNN rows (8 steps of 64 at world 1), served
# in 64 requests; LeNet 8 steps, a grid every 4; the classifier's rows
DASH_ROWS, DASH_BATCH, DASH_REQUESTS, DASH_BUCKETS, DASH_ATOL = 512, 64, 64, (1, 8, 32), 1e-5
DASH_STEPS = DASH_ROWS // DASH_BATCH
DASH_LENET_STEPS, DASH_LENET_FREQ, DASH_CLF_ROWS = 8, 4, 4096
# hostfleet: 2 hosts on the card, 3 rounds of one step at MNIST MLP widths
HF_FEATURES, HF_HIDDEN, HF_CLASSES, HF_BATCH, HF_ROUNDS = 784, 1024, 10, 256, 3
HF_SEED, HF_GEN_SEED, HF_ROUND_TIMEOUT_S, HF_ROUND_SLEEP_S = 0, 123, 90.0, 0.5


def emit(phase, **fields):
    """One JSON line; ``t_s`` is the seconds since the script started, so
    the gap between two lines is what the later one's work took. One write
    a line: phases that run side by side never interleave theirs."""
    line = json.dumps({"phase": phase, **fields, "t_s": round(time.perf_counter() - _T0, 2)})
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, *, iters, reps):
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return statistics.median(out)


def device_ms(fn, *, iters, reps, sleep_cycles=20_000_000):
    """Median over ``reps`` of the mean time of ``iters`` calls on the card
    alone: a sleep kernel (~10 ms at the default ``sleep_cycles``) keeps
    the card busy while the host queues every call, so the host's launch
    cost does not show. (time_ms, calls back to back, includes it wherever
    it exceeds the call's device time.)"""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(sleep_cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return statistics.median(out)


@contextlib.contextmanager
def library_precision():
    """Full f32 in cuDNN (TF32 off) within this block, the old value back
    after it: around the kernel checks' plain versions and the library
    yardsticks, so both compute what the f32 kernels do. The training
    phases run under the port's own policy (``utils.dtypes``)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def roofline(nbytes, ops, dtype):
    """(least ms, what sets it): ``nbytes`` over the memory rate against
    ``ops`` over the dtype's peak."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_S
    by_ops = 1e3 * ops / PEAK_OPS_S[dtype]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def bound(t, b, h, dtype, peephole, mask):
    """Least time (ms) for one lstm_seq call and what sets it: every input
    read once and every output written once over the memory rate, against
    the recurrent product's 2*T*B*H*4H operations over the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    n_in = t * b * 4 * h + h * 4 * h + 2 * b * h + (3 * h if peephole else 0)
    n_out = 2 * t * b * h + 2 * b * h
    nbytes = elt * (n_in + n_out) + (4 * t * b if mask else 0)
    return roofline(nbytes, 2 * t * b * h * 4 * h, dtype)


def lstm_inputs(rs, t, b, h, dtype, peephole, mask):
    def cuda(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dt)
    xz = cuda(rs.randn(t, b, 4 * h))
    wh = cuda(rs.randn(h, 4 * h) / np.sqrt(h))
    h0 = cuda(0.1 * rs.randn(b, h))
    c0 = cuda(0.1 * rs.randn(b, h))
    wp = cuda(0.1 * rs.randn(3, h)) if peephole else None
    m = None
    if mask:
        lens = rs.randint(1, t + 1, size=b)
        m = cuda((np.arange(t)[:, None] < lens[None, :]).astype(np.float32), torch.float32)
    return xz, wh, h0, c0, wp, m


def cudnn_lstm(xz, wh, h0, c0):
    """torch.nn.LSTM computing the no-peephole, no-mask lstm_seq on the same
    xz: the input projection is the identity and W_hh = Wh^T (PyTorch's
    gate order i|f|g|o is the kernel's)."""
    h = wh.shape[0]
    mod = torch.nn.LSTM(4 * h, h, bias=False).to("cuda", xz.dtype)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(torch.eye(4 * h, device="cuda", dtype=xz.dtype))
        mod.weight_hh_l0.copy_(wh.t())
    state = (h0.to(xz.dtype)[None].contiguous(), c0.to(xz.dtype)[None].contiguous())
    return lambda: mod(xz, state)


def cudnn_recurrence(wh, h0, c0, t):
    """torch.nn.LSTM's recurrence alone with the same Wh, h0 and c0 (a
    1-wide zero input, so no input projection): a yardstick for the time
    cuDNN spends on the T dependent steps, not the same function."""
    h = wh.shape[0]
    mod = torch.nn.LSTM(1, h, bias=False).to("cuda", wh.dtype)
    with torch.no_grad():
        mod.weight_ih_l0.zero_()
        mod.weight_hh_l0.copy_(wh.t())
    x = torch.zeros(t, h0.shape[0], 1, device="cuda", dtype=wh.dtype)
    state = (h0[None].contiguous(), c0[None].contiguous())
    return lambda: mod(x, state)


def ran_variants(mod, before):
    """The variants whose launch counters moved since ``before``."""
    return [k for k in before if mod.launches_by_variant[k] != before[k]]


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_lstm_plan(L, b, h, dtype):
    """The call's plan against the built library: a persistent block's
    shared memory as the CUDA source counts it, and at least one block of
    it fitting on an SM (so the grid, at most one block an SM, is
    co-resident). Returns the plan."""
    import ctypes

    pl = L.plan(b, h, dtype, sm_count())
    if pl.variant == "persistent":
        lib = L._LIB.get()
        blocks = ctypes.c_int(0)
        err = lib.lstm_seq_occupancy(pl.rt, h, int(dtype == torch.bfloat16), 0,
                                     ctypes.byref(blocks))
        smem = lib.lstm_seq_smem_bytes(pl.rt, h)
        if err != 0 or smem != pl.smem_bytes or blocks.value < 1 or pl.grid > sm_count():
            raise AssertionError(f"lstm plan {pl} at B={b} H={h} {dtype}: the library counts "
                                 f"{smem} bytes and fits {blocks.value} blocks an SM (error {err})")
    elif L.cluster_split(b, h) != pl.split:
        raise AssertionError(f"lstm plan {pl}: the library's cluster split is "
                             f"{L.cluster_split(b, h)}")
    return pl


def lstm_launch_profile(L, rs, shapes):
    """One f32 lstm_seq call (T=SEQ, peepholes) at each (B, H) of ``shapes``,
    all under one torch.profiler session: the device's events by name.
    Shows how many kernel launches one call makes (persistent: one;
    step_cluster: one per step); the rest are the wrapper's setup copies."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for b, h in shapes:
        xz, wh, h0, c0, wp, _ = lstm_inputs(rs, SEQ, b, h, torch.float32, True, False)
        calls.append(lambda xz=xz, wh=wh, h0=h0, c0=c0, wp=wp: L.lstm_seq(xz, wh, h0, c0, wp=wp))
        calls[-1]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = ("lstm_persistent_kernel" if "lstm_persistent_kernel" in e.name else
                   "lstm_step_kernel" if "lstm_step_kernel" in e.name else e.name[:60])
            names[key] = names.get(key, 0) + 1
    return {"T": SEQ, "calls": [{"B": b, "H": h,
                                 "plan": L.plan(b, h, torch.float32, sm_count())._asdict()}
                                for b, h in shapes],
            "device_events": sum(names.values()), "by_name": names}


def check_carry(L, rs, b, h, dtype):
    """One sequence in one call against the same sequence in two calls, the
    second starting from the first's f32 final state (what TBPTT and
    rnn_time_step carry): the split run must agree with the whole one
    (F32_ATOL; the same sums in the same order, so expected exact)."""
    xz, wh, h0, c0, wp, _ = lstm_inputs(rs, SEQ, b, h, dtype, True, False)
    half = SEQ // 2
    whole = L.lstm_seq(xz, wh, h0, c0, wp=wp)
    first = L.lstm_seq(xz[:half], wh, h0, c0, wp=wp)
    second = L.lstm_seq(xz[half:], wh, first.h_state, first.c_state, wp=wp)
    torch.cuda.synchronize()
    pairs = ((torch.cat([first.hs, second.hs]), whole.hs), (second.h_state, whole.h_state),
             (second.c_state, whole.c_state))
    err = max((g.float() - w.float()).abs().max().item() for g, w in pairs)
    if not err <= F32_ATOL:
        raise AssertionError(f"lstm_seq carried across two calls differs from one call by {err} "
                             f"at B={b} H={h} {dtype}")
    return {"B": b, "H": h, "dtype": str(dtype).split(".")[-1],
            "variant": L.plan(b, h, dtype, sm_count()).variant, "max_abs_err": err,
            "exact": all(torch.equal(g, w) for g, w in pairs)}


def phase_kernels(L):
    rs = np.random.RandomState(SEED)
    cases, timings, max_err_path = [], [], 0.0
    shapes = [(SEQ, 1, HIDDEN), (SEQ, 8, HIDDEN), (SEQ, 64, HIDDEN), (SEQ, 8, 1024),
              (SEQ, 64, 1024), (SEQ, 5, 100)]
    for t, b, h in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            pl = check_lstm_plan(L, b, h, dtype)
            if h == HIDDEN and pl.variant != "persistent":
                raise AssertionError(f"served shape B={b} H={h} {dtype} planned on {pl.variant}")
            for peephole in (False, True):
                for mask in (False, True):
                    args = lstm_inputs(rs, t, b, h, dtype, peephole, mask)
                    before = dict(L.launches_by_variant)
                    got = L.lstm_seq(*args[:4], wp=args[4], mask=args[5])
                    ran = ran_variants(L, before)
                    want = L.lstm_seq_plain(*args[:4], wp=args[4], mask=args[5])
                    torch.cuda.synchronize()
                    if ran != [pl.variant]:
                        raise AssertionError(f"lstm_seq B={b} H={h} {dtype} ran {ran}, its plan "
                                             f"names {pl.variant}")
                    if not (torch.equal(got.h_state.to(dtype), got.h_last)
                            and torch.equal(got.c_state.to(dtype), got.c_last)):
                        raise AssertionError(f"lstm_seq's f32 final state does not round to its "
                                             f"hT/cT at B={b} H={h} {dtype}")
                    err = 0.0
                    for name, g, w in zip(L.SeqOut._fields, got, want):
                        g, w = g.float(), w.float()
                        if not torch.isfinite(g).all():
                            raise AssertionError(f"lstm_seq {name} not finite at {(t, b, h, dtype)}")
                        err = max(err, (g - w).abs().max().item())
                        if dtype == torch.float32:
                            ok = torch.allclose(g, w, rtol=0.0, atol=F32_ATOL)
                        else:
                            ok = torch.allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL)
                        if not ok:
                            raise AssertionError(
                                f"lstm_seq {name} disagrees with lstm_seq_plain at T={t} B={b} "
                                f"H={h} {dtype} peephole={peephole} mask={mask}: max|diff|={err}")
                    if dtype == torch.float32 and h == HIDDEN:
                        max_err_path = max(max_err_path, err)
                    cases.append({"T": t, "B": b, "H": h, "dtype": str(dtype).split(".")[-1],
                                  "peephole": peephole, "mask": mask, "variant": pl.variant,
                                  "max_abs_err": err})
        # timings in f32: the served variant (peepholes, no mask), and the
        # no-peephole variant beside cuDNN's nn.LSTM on the same inputs
        xz, wh, h0, c0, wp, _ = lstm_inputs(rs, t, b, h, torch.float32, True, False)
        iters = 10
        kern = lambda: L.lstm_seq(xz, wh, h0, c0, wp=wp)  # noqa: E731
        cudnn = cudnn_lstm(xz, wh, h0, c0)
        ms = time_ms(kern, iters=iters, reps=5)
        ms_nopeep = time_ms(lambda: L.lstm_seq(xz, wh, h0, c0), iters=iters, reps=5)
        plain_ms = time_ms(lambda: L.lstm_seq_plain(xz, wh, h0, c0, wp=wp), iters=2, reps=3)
        library_ms = time_ms(cudnn, iters=iters, reps=5)
        recurrence_ms = time_ms(cudnn_recurrence(wh, h0, c0, t), iters=iters, reps=5)
        bound_ms, bound_by = bound(t, b, h, torch.float32, True, False)
        pl = L.plan(b, h, torch.float32, sm_count())
        row = {"T": t, "B": b, "H": h, "dtype": "float32", "plan": pl._asdict(),
               "ms": ms, "device_ms": device_ms(kern, iters=iters, reps=5),
               "ms_no_peephole": ms_nopeep,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": device_ms(cudnn, iters=iters, reps=5),
               "library_recurrence_ms": recurrence_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "card": card_line()}
        timings.append(row)
        emit("kernels.timing", **row)
    carries = [check_carry(L, rs, b, h, dtype) for b, h in ((64, HIDDEN), (64, 1024))
               for dtype in (torch.float32, torch.bfloat16)]
    emit("kernels.carry", cases=carries)
    # launch attribution: one call at the served path's shape (persistent)
    # and one on the step variant, in one profiled session
    launches = lstm_launch_profile(L, rs, [(64, HIDDEN), (64, 1024)])
    if [c["plan"]["variant"] for c in launches["calls"]] != ["persistent", "step_cluster"] or \
            launches["by_name"].get("lstm_persistent_kernel") != 1 or \
            launches["by_name"].get("lstm_step_kernel") != SEQ:
        raise AssertionError(f"one persistent call and one step_cluster call launched "
                             f"{launches['by_name']}: expected 1 persistent kernel and {SEQ} "
                             "step kernels")
    emit("kernels.launches", **launches)
    emit("kernels", name="lstm_seq", cases=len(cases), f32_atol=F32_ATOL,
         bf16_atol=BF16_ATOL, bf16_rtol=BF16_RTOL,
         max_abs_err_f32=max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
         max_abs_err_bf16=max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16"),
         cases_by_variant={v: sum(c["variant"] == v for c in cases) for v in L.VARIANTS})
    return timings, max_err_path


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def qkv_views(rs, b, t, h, d, dtype, grad=False):
    """q, k, v as views of one [B,T,3,H,D] tensor (the layout the fused QKV
    projection leaves), and that tensor."""
    qkv = torch.from_numpy(rs.randn(b, t, 3, h, d).astype(np.float32)).to("cuda", dtype)
    qkv.requires_grad_(grad)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], qkv


def key_mask(rs, b, t):
    """[B,T] key mask: ragged lengths, the last batch row fully masked."""
    lens = rs.randint(1, t + 1, size=b)
    lens[-1] = 0
    return torch.from_numpy((np.arange(t)[None, :] < lens[:, None]).astype(np.float32)).cuda()


def flash_work(b, t, h, d, dtype, causal, backward=False):
    """(bytes, operations) of one flash forward (or backward): q, k, v read
    and out, lse written once (backward: q, k, v, out, its cotangent and lse
    read, dq, dk, dv written), and the two products' operations (backward:
    five, 2.5x), counting only the query-key pairs the causal mask leaves."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * (8 if backward else 4) * b * t * h * d + 4 * b * h * t
    pairs = t * (t + 1) // 2 if causal else t * t
    return nbytes, (10 if backward else 4) * b * h * d * pairs


def flash_bound(b, t, h, d, dtype, causal, backward=False):
    """Least time (ms) for one flash forward (or backward) and what sets
    it: ``flash_work`` over the memory rate and the dtype's peak."""
    return roofline(*flash_work(b, t, h, d, dtype, causal, backward), dtype)


def flash_bound_3xtf32(b, t, h, d, causal, backward=False):
    """Least time (ms) for one f32 flash forward (or backward) on the route
    it takes, the tensor cores: three TF32 products for each f32 product,
    over the TF32 peak, against the bytes over the memory rate."""
    nbytes, ops = flash_work(b, t, h, d, torch.float32, causal, backward)
    return max(1e3 * nbytes / PEAK_BYTES_S, 1e3 * 3 * ops / PEAK_TF32_OPS_S)


def check_close(what, got, want, atol, rtol):
    """Max |got - want|; raises unless every element is finite and within
    atol + rtol·|want|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: not finite")
    err = (got - want).abs()
    if (err > atol + rtol * want.abs()).any():
        raise AssertionError(f"{what}: max|diff| {err.max().item()} beyond atol {atol} "
                             f"+ rtol {rtol}")
    return err.max().item()


def check_flash_plan(A, q, k, v):
    """The call's plan against the built library: its shared memory as the
    CUDA source counts it and at least one block of it fitting on an SM.
    Returns the plan."""
    import ctypes

    strides = tuple(tuple(x.stride()[:3]) for x in (q, k, v))
    pl = A.plan(tuple(q.shape), q.dtype, strides, all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    lib = A._LIB.get()
    v_idx = A.VARIANTS.index(pl.variant)
    blocks = ctypes.c_int(0)
    err = lib.flash_attn_occupancy(v_idx, pl.dp, 0, ctypes.byref(blocks))
    smem = lib.flash_attn_smem_bytes(v_idx, pl.dp)
    if err != 0 or smem != pl.smem_bytes or blocks.value < 1:
        raise AssertionError(f"flash plan {pl}: the library counts {smem} bytes and fits "
                             f"{blocks.value} blocks an SM (error {err})")
    return pl


def check_bwd_plan(A, q, k, v, want):
    """The backward plan of the call (out and dO contiguous, as the
    autograd.Function hands them over) is ``want``, and its shared memory
    is what the built library counts, with a block of each pass fitting on
    an SM."""
    import ctypes

    strides = tuple(tuple(x.stride()[:3]) for x in (q, k, v))
    pl = A.plan_bwd(tuple(q.shape), q.dtype, strides,
                    all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    lib = A.bwd_library(pl.variant)
    v_idx = A.BWD_VARIANTS.index(pl.variant)
    blocks = ctypes.c_int(0)
    err = lib.occupancy(v_idx, pl.dp, 0, ctypes.byref(blocks))
    smem = lib.smem_bytes(v_idx, pl.dp)
    if pl.variant != want or err != 0 or smem != pl.smem_bytes or blocks.value < 1:
        raise AssertionError(f"flash backward plan {pl} (expected {want}): the library counts "
                             f"{smem} bytes and fits {blocks.value} blocks an SM (error {err})")
    return pl


def odd_views(rs, b, t, h, d, dtype, grad=False):
    """q, k, v as views of a [B,T,3,H,D+1] tensor cut to D: strides off 16
    bytes, so the plan takes an unaligned variant."""
    base = torch.from_numpy(rs.randn(b, t, 3, h, d + 1).astype(np.float32)).to("cuda", dtype)
    base.requires_grad_(grad)
    qkv = base[..., :d]
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], base


def flash_bwd_pass_bounds(b, t, h, d, dtype, causal, g_lse=False):
    """Least time (ms) of each backward pass and what sets it: the dq pass
    reads q, k, v, out, dO and lse and writes dq and delta, three products
    (S, dP, dQ); the dk/dv pass reads q, k, v, dO, lse and delta and writes
    dk and dv, four products (S, dP, dV, dK). f32 adds each pass's bound on
    its route, three TF32 products each (``_3xtf32``)."""
    elt = torch.finfo(dtype).bits // 8
    n, vec = b * t * h * d, 4 * b * h * t * (2 if g_lse else 1)
    pairs = t * (t + 1) // 2 if causal else t * t
    out = {}
    for name, nbytes, products in (("dq_pass", elt * 6 * n + vec + 4 * b * h * t, 3),
                                   ("dkdv_pass", elt * 6 * n + vec + 4 * b * h * t, 4)):
        ops = products * 2 * b * h * d * pairs
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = roofline(nbytes, ops, dtype)
        if dtype == torch.float32:
            out[f"{name}_bound_3xtf32_ms"] = max(1e3 * nbytes / PEAK_BYTES_S,
                                                 1e3 * 3 * ops / PEAK_TF32_OPS_S)
    return out


def flash_bwd_timing(A, q, k, v, g, causal, g_lse=None, plain=True, variants=None):
    """The backward kernel alone from the forward's residuals: back to back
    (``ms``) and on the card (``device_ms``), each pass alone on the card
    (``dq_pass_device_ms``, ``dkdv_pass_device_ms``), beside their bounds
    and (with ``plain``) the plain backward's time; two calls must agree to
    the bit. ``variants`` adds the same times for each variant named (in
    place of the plan's), as ``by_variant``: the designs side by side."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    with torch.no_grad():
        out, lse = A.flash_attention_fwd(q, k, v, causal=causal)

        def timed(variant=None):
            def kern(passes=A.BOTH_PASSES):
                return A.flash_attention_bwd(q, k, v, None, out, lse, g, causal=causal,
                                             scale=scale, g_lse=g_lse, passes=passes,
                                             variant=variant)
            first, second = kern(), kern()
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError(f"flash_attn_bwd {q.dtype} {tuple(q.shape)} "
                                     f"{variant or 'planned'}: two calls on the same inputs "
                                     "differ")
            del first, second
            return {"ms": time_ms(kern, iters=10, reps=5),
                    "device_ms": device_ms(kern, iters=10, reps=5),
                    **{f"{name}_pass_device_ms": device_ms(lambda: kern(bit), iters=10, reps=5)
                       for name, bit in A.BWD_PASSES.items()},
                    "bit_identical": True}
        row = timed()
        if variants:
            row["by_variant"] = {vn: timed(vn) for vn in variants}
        if plain:
            row["plain_ms"] = time_ms(lambda: A.flash_attention_bwd_plain(
                q, k, v, None, out, lse, g, causal=causal, scale=scale, g_lse=g_lse),
                iters=3, reps=3)
    row["bound_ms"], row["bound_by"] = flash_bound(b, t, h, d, q.dtype, causal, backward=True)
    row.update(flash_bwd_pass_bounds(b, t, h, d, q.dtype, causal, g_lse is not None))
    del out, lse
    return row


def slice_library_times(A, q, k, v, g):
    """At a split model's slice shape (causal): SDPA's backward alone
    (``library_ms``, autograd over one kept graph), and the forward kernel's
    time per call beside SDPA's forward (``fwd_ms``, ``fwd_library_ms``),
    back to back."""
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    gh = g.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: A.flash_attention_fwd(q, k, v, causal=True), iters=10, reps=5)
        fwd_library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), iters=10, reps=5)
    out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True),
                         iters=10, reps=5)
    del qh, kh, vh, gh, out
    return {"library_ms": library_ms, "fwd_ms": fwd_ms, "fwd_library_ms": fwd_library_ms}


def phase_flash(A):
    rs = np.random.RandomState(SEED + 1)
    b, h = LM_BATCH, LM_HEADS
    cases, path_err = [], None
    grid = [(t, d, dtype, causal, masked, False) for t in (1000, LM_SEQ) for d in (64, 128)
            for dtype in (torch.float32, torch.bfloat16) for causal in (False, True)
            for masked in (False, True)]
    grid += [(1000, 64, dtype, True, True, True) for dtype in (torch.float32, torch.bfloat16)]
    for t, d, dtype, causal, masked, odd in grid:
        f32 = dtype == torch.float32
        q, k, v, _ = (odd_views if odd else qkv_views)(rs, b, t, h, d, dtype, grad=True)
        pl = check_flash_plan(A, q, k, v)
        want_variant = {(True, False): "f32_3xtf32_wgmma" if d <= 64 else "f32_3xtf32",
                        (False, False): "bf16_wgmma", (True, True): "f32_3xtf32_unaligned",
                        (False, True): "bf16_unaligned"}[(f32, odd)]
        if pl.variant != want_variant:
            raise AssertionError(f"flash T={t} D={d} {dtype} odd={odd} planned on {pl.variant}")
        m = key_mask(rs, b, t) if masked else None
        what = f"flash_attn T={t} D={d} {dtype} causal={causal} mask={masked} {pl.variant}"
        want_bwd = {(True, False): "f32_3xtf32_wgmma" if d <= 64 else "f32_3xtf32",
                    (False, False): "bf16_wgmma", (True, True): "f32_3xtf32_unaligned",
                    (False, True): "bf16_tf32"}[(f32, odd)]
        check_bwd_plan(A, q, k, v, want_bwd)
        before = dict(A.launches_by_variant)
        with torch.no_grad():
            out_k, lse_k = A.flash_attention_fwd(q, k, v, mask=m, causal=causal)
            out_p, lse_p = A.flash_attention_plain(q, k, v, mask=m, causal=causal)
        torch.cuda.synchronize()
        if ran_variants(A, before) != [pl.variant]:
            raise AssertionError(f"{what}: ran {ran_variants(A, before)}")
        tol = (FLASH_F32_ATOL, 0.0) if f32 else (FLASH_BF16_TOL, FLASH_BF16_TOL)
        errs = {"out": check_close(f"{what} out", out_k, out_p, *tol),
                "lse": check_close(f"{what} lse", lse_k, lse_p,
                                   FLASH_LSE_ATOL, FLASH_LSE_RTOL)}
        g = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32)).to("cuda", dtype)
        before = dict(A.launches_bwd_by_variant)
        got = torch.autograd.grad(
            A.flash_attention(q, k, v, mask=m, causal=causal), (q, k, v), g)
        ran = {n: c - before[n] for n, c in A.launches_bwd_by_variant.items() if c != before[n]}
        if ran != {want_bwd: 1}:
            raise AssertionError(f"{what}: the backward ran {ran}, expected one {want_bwd}")
        want = torch.autograd.grad(
            A.flash_attention_plain(q, k, v, mask=m, causal=causal)[0], (q, k, v), g)
        gtol = (FLASH_GRAD_ATOL, FLASH_GRAD_RTOL) if f32 else (FLASH_BF16_TOL, FLASH_BF16_TOL)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = check_close(f"{what} {name}", a, w, *gtol)
        if masked and (out_k[-1].any() or (lse_k[-1] != A.NEG_INF).any()):
            raise AssertionError(f"{what}: the fully masked row is not 0 with the lse sentinel")
        if masked and any(x[-1].any() for x in got):
            raise AssertionError(f"{what}: the fully masked row's dq, dk, dv are not exactly 0")
        cases.append({"T": t, "D": d, "dtype": str(dtype).split(".")[-1], "causal": causal,
                      "mask": masked, "variant": pl.variant, "bwd_variant": want_bwd, **errs})
        if (t, d, f32, causal, masked, odd) == (LM_SEQ, LM_WIDTH // LM_HEADS, True, True, False,
                                                False):
            path_err = max(errs.values())
            bwd_err = max(errs[n] for n in ("dq", "dk", "dv"))
        del q, k, v, got, want, out_k, out_p, lse_k, lse_p
    torch.cuda.empty_cache()
    emit("flash", cases=len(cases), f32_atol=FLASH_F32_ATOL, lse_atol=FLASH_LSE_ATOL,
         lse_rtol=FLASH_LSE_RTOL, grad_atol=FLASH_GRAD_ATOL, grad_rtol=FLASH_GRAD_RTOL,
         bf16_tol=FLASH_BF16_TOL,
         max_abs_err_f32={k: max(c[k] for c in cases if c["dtype"] == "float32")
                          for k in ("out", "lse", "dq", "dk", "dv")},
         max_abs_err_bf16={k: max(c[k] for c in cases if c["dtype"] == "bfloat16")
                           for k in ("out", "lse", "dq", "dk", "dv")},
         cases_by_variant={v: sum(c["variant"] == v for c in cases) for v in A.VARIANTS},
         cases_by_bwd_variant={v: sum(c["bwd_variant"] == v for c in cases)
                               for v in A.BWD_VARIANTS})

    timings = {}
    d = LM_WIDTH // LM_HEADS
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = qkv_views(rs, b, LM_SEQ, h, d, dtype)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: A.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=True)
        with torch.no_grad():
            ms = time_ms(kern, iters=10, reps=5)
            dev_ms = device_ms(kern, iters=10, reps=5)
            plain_ms = time_ms(lambda: A.flash_attention_plain(q, k, v, causal=True),
                               iters=10, reps=5)
            library_ms = time_ms(sdpa, iters=10, reps=5)
            library_dev_ms = device_ms(sdpa, iters=10, reps=5)
        bound_ms, bound_by = flash_bound(b, LM_SEQ, h, d, dtype, True)
        # forward + backward: the port's path (kernel forward, blockwise
        # backward) and SDPA, each with the gradients of q, k and v
        g = torch.randn_like(q)
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        qhg, khg, vhg = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
        gh = g.transpose(1, 2).contiguous()
        fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            A.flash_attention(qg, kg, vg, causal=True), (qg, kg, vg), g), iters=3, reps=5)
        library_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            torch.nn.functional.scaled_dot_product_attention(qhg, khg, vhg, is_causal=True),
            (qhg, khg, vhg), gh), iters=3, reps=5)
        bwd_bound_ms, bwd_bound_by = flash_bound(b, LM_SEQ, h, d, dtype, True, backward=True)
        # the plan's design and, beside it, the earlier mma.sync one at this shape
        planned = A.plan_bwd(tuple(q.shape), dtype, tuple(tuple(x.stride()[:3]) for x in (q, k, v)))
        earlier = {torch.float32: "f32_3xtf32", torch.bfloat16: "bf16_tf32"}[dtype]
        bwd = flash_bwd_timing(A, q, k, v, g, True,
                               variants=[earlier] if planned.variant != earlier else None)
        bwd["variant"] = planned.variant
        # SDPA's backward alone: autograd over one kept graph
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qhg, khg, vhg, is_causal=True)
        library_bwd_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qhg, khg, vhg), gh, retain_graph=True), iters=10, reps=5)
        pl = A.plan(tuple(q.shape), dtype, tuple(tuple(x.stride()[:3]) for x in (q, k, v)))
        row = {"B": b, "T": LM_SEQ, "H": h, "D": d, "causal": True,
               "dtype": str(dtype).split(".")[-1], "plan": pl._asdict(), "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": library_dev_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "fwd_bwd_ms": fwd_bwd_ms, "library_fwd_bwd_ms": library_fwd_bwd_ms,
               "bwd_ms_by_difference": fwd_bwd_ms - ms,
               "library_bwd_ms_by_difference": library_fwd_bwd_ms - library_ms,
               "bwd_bound_ms": bwd_bound_ms, "bwd_bound_by": bwd_bound_by,
               "bwd": {**bwd, "library_ms": library_bwd_ms}, "card": card_line()}
        if dtype == torch.float32:
            # the route taken: three TF32 products per f32 product
            row["bound_3xtf32_ms"] = flash_bound_3xtf32(b, LM_SEQ, h, d, True)
            row["bwd"]["bound_3xtf32_ms"] = flash_bound_3xtf32(b, LM_SEQ, h, d, True,
                                                               backward=True)
            # one call at the shapes the split models give it: a TP rank's
            # 4-head slice and a pipelined one-sequence microbatch
            row["bwd_slices"] = {}
            slices = (("tp_slice", MP_STREAM_BATCH // MP_DATA, h // MP_TP),
                      ("pipeline_microbatch", MP_LM_BATCH // MP_DATA // MP_MICRO, h))
            for name, sb, sh in slices:
                sq, sk, sv, _ = qkv_views(rs, sb, LM_SEQ, sh, d, dtype)
                sg = torch.randn_like(sq)
                row["bwd_slices"][name] = {"B": sb, "H": sh, **flash_bwd_timing(
                    A, sq, sk, sv, sg, True, plain=False)}
                row["bwd_slices"][name].update(slice_library_times(A, sq, sk, sv, sg))
                del sq, sk, sv, sg
        timings[dtype] = row
        emit("flash.timing", **row)
        del q, k, v, qh, kh, vh, qg, kg, vg, qhg, khg, vhg, g, gh, sdpa_out
    torch.cuda.empty_cache()
    return timings, path_err, bwd_err


def phase_crossover(TA):
    """The kernel against the port's naive attention, forward + backward,
    B=4, H=8, D=64, causal, f32: the length from which the kernel wins."""
    rs = np.random.RandomState(SEED + 2)
    b, h, d = LM_BATCH, LM_HEADS, LM_WIDTH // LM_HEADS
    rows = []
    for t in CROSSOVER_T:
        q, k, v, qkv = qkv_views(rs, b, t, h, d, torch.float32, grad=True)
        g = torch.randn(b, t, h, d, device="cuda")

        def run(min_seq):
            out = TA.dot_product_attention(q, k, v, causal=True, min_seq=min_seq)
            torch.autograd.grad(out, qkv, g)
        flash_ms = time_ms(lambda: run(0), iters=3, reps=5)
        naive_ms = time_ms(lambda: run(1 << 30), iters=3, reps=5)
        rows.append({"T": t, "flash_ms": flash_ms, "naive_ms": naive_ms,
                     "speedup": naive_ms / flash_ms})
        del q, k, v, qkv, g
        torch.cuda.empty_cache()
    crossover = None
    for i, r in enumerate(rows):
        if all(x["speedup"] > 1.0 for x in rows[i:]):
            crossover = r["T"]
            break
    emit("flash.crossover", B=b, H=h, D=d, causal=True, dtype="float32", rows=rows,
         crossover_T=crossover, min_seq_in_port=TA.MIN_SEQ, card=card_line())
    return crossover


# ---------------------------------------------------------------------------
# training the transformer LM
# ---------------------------------------------------------------------------

def lm_data(rs, n):
    """n sequences of a rule a model can learn, ids[t+1] = (5 ids[t] + 3)
    mod V from random starts: x [n,T,1] f32 ids and y [n,T,V] one-hot next
    ids, as the JAX package's bench builds them, on the card."""
    ids = np.zeros((n, LM_SEQ + 1), np.int64)
    ids[:, 0] = rs.randint(0, LM_VOCAB, size=n)
    for t in range(LM_SEQ):
        ids[:, t + 1] = (5 * ids[:, t] + 3) % LM_VOCAB
    x = torch.from_numpy(ids[:, :LM_SEQ, None].astype(np.float32)).cuda()
    y = torch.nn.functional.one_hot(torch.from_numpy(ids[:, 1:]).cuda(), LM_VOCAB).float()
    return x, y


def make_lm(seed):
    from deeplearning4j_tpu_torch.models.misc import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(transformer_lm(LM_VOCAB, n_layers=LM_LAYERS, d_model=LM_WIDTH,
                                           n_heads=LM_HEADS, seq_len=LM_SEQ), device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    if net.num_params() != LM_PARAMS:
        raise AssertionError(f"transformer_lm has {net.num_params()} params, "
                             f"expected {LM_PARAMS}")
    return net


@contextlib.contextmanager
def plain_attention_forward(A):
    """Within this block the flash autograd.Function computes its forward
    with ``flash_attention_plain`` and its backward with
    ``flash_attention_bwd_plain`` on the card instead of the kernels."""
    saved = A.flash_attention_fwd, A.flash_attention_bwd
    A.flash_attention_fwd = lambda q, k, v, **kw: A.flash_attention_plain(q, k, v, **kw)
    A.flash_attention_bwd = A.flash_attention_bwd_plain
    try:
        yield
    finally:
        A.flash_attention_fwd, A.flash_attention_bwd = saved


def one_step(net, x, y):
    """The first step of ``fit``: gradients, then the updater from fresh
    state. Returns the loss and the gradient leaves."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    loss, _, grads = net.compute_gradients(net.params, net.state, x, y)
    net.opt_state = net.conf.updater.init(net.params)
    net.apply_update(net.params, net.opt_state, grads, 0)
    return float(loss), list(tree_leaves(grads))


def grad_rel_by_leaf(params, ga, gb):
    """{leaf path: |ga - gb| / |gb|} (norms over the leaf) for two lists of
    gradient leaves in ``params``' order."""
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    return {name: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for name, a, b in zip(flatten_tree(params), ga, gb)}


def step_check(A, x, y, seed, policy, make=None, by_leaf=False):
    """One training step of ``make(seed)`` (default ``make_lm``) from
    identical weights through the kernel and
    through the plain attention forward; the losses must agree to rtol
    1e-4. Under the f32 policy the updated parameters must agree to atol
    1e-4. Under bf16_policy the matmul operands are rounded to bf16, so the
    ~1e-7 difference between the two attention outputs moves operands that
    sit on a rounding boundary by one bf16 ulp, and a near-zero gradient
    element can differ by its own size between the runs; Adam's first step,
    about lr·g/(|g| + 3e-7), turns that into up to 2·lr. There each
    tensor's gradient is held to a relative difference of 1e-2 instead, and
    the parameter difference is reported. ``by_leaf`` adds each leaf's
    relative gradient difference (``grad_rel_by_leaf``)."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    make = make or make_lm
    kern = make(seed)
    lk, gk = one_step(kern, x, y)
    with plain_attention_forward(A):
        plain = make(seed)
        lp, gp = one_step(plain, x, y)
    if not abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp):
        raise AssertionError(f"kernel step loss {lk} vs plain-attention step loss {lp}")
    rels = grad_rel_by_leaf(kern.params, gk, gp)
    leaf = max(rels, key=rels.get)
    grad_rel, err, beyond = rels[leaf], 0.0, 0
    for a, b in zip(tree_leaves(kern.params), tree_leaves(plain.params)):
        diff = (a - b).abs()
        err = max(err, diff.max().item())
        beyond += int((diff > STEP_PARAM_ATOL).sum())
    if policy == "f32" and not err <= STEP_PARAM_ATOL:
        raise AssertionError(f"updated parameters differ by {err} between the kernel step "
                             "and the plain-attention step")
    if policy == "bf16" and not grad_rel <= STEP_BF16_GRAD_RTOL:
        raise AssertionError(f"gradients differ by {grad_rel} relative ({leaf}) between the "
                             "kernel step and the plain-attention step")
    n = sum(g.numel() for g in gp)
    del kern, plain, gk, gp
    torch.cuda.empty_cache()
    return {"loss_kernel": lk, "loss_plain": lp, "max_grad_rel_diff": grad_rel,
            "max_grad_rel_leaf": leaf, "max_abs_param_diff": err, "params_beyond_atol": beyond,
            "params": n, **({"grad_rel_by_leaf": rels} if by_leaf else {})}


def lm_family(name):
    return ("flash_fwd" if any(k in name for k in ("flash_mma_kernel", "flash_wgmma_kernel",
                                                    "flash_tf32_wgmma_kernel")) else
            "flash_bwd" if "flash_bwd_" in name else
            "gemm" if any(s in name for s in ("gemm", "cutlass", "xmma", "sm90"))
            else "elementwise_other")


def device_families(prof, wall_ms, family=lm_family, tags=(("updater.step", "optimizer"),)):
    """Device time by family from a profile: every device event is named
    by ``family(kernel name)``, except kernels launched inside a range
    listed in ``tags`` (found through their CPU op), which count under the
    range's tag instead; and the device's busy share of ``wall_ms`` (union
    of device intervals). Events are read from the device side, so kernels
    the profiler cannot link to a CPU op (cuDNN's) are counted too."""
    tags = dict(tags)
    by_family = {}
    for e in prof.events():
        # a record_function range shows on the device timeline too: skip it
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in tags:
            fam = family(e.name.lower())
            by_family[fam] = by_family.get(fam, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        tag, a = None, e
        while a is not None and tag is None:
            tag = tags.get(a.name)
            a = a.cpu_parent
        if tag is None:
            continue
        for kern in e.kernels:  # move the tagged kernel's time to its tag
            fam = family(kern.name.lower())
            by_family[fam] = by_family.get(fam, 0.0) - kern.duration / 1e3
            by_family[tag] = by_family.get(tag, 0.0) + kern.duration / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in tags)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return by_family, busy_us / 1e3, (busy_us / 1e3 / wall_ms) if spans else None


#: the backward's f32 variants at D=64: the rank cells' tensors come through
#: collectives and reshapes, whose alignment the path's views do not set
BWD_F32 = ("f32_3xtf32_wgmma", "f32_3xtf32_unaligned")


def bwd_launched(A, what, n, variants=("f32_3xtf32_wgmma",)):
    """The backward kernel's launches since ``reset_launches``: all on
    ``variants`` and, where ``n`` is given, exactly ``n`` (else at least
    one). Returns (count, by variant)."""
    count = A.launches_bwd
    by_variant = {k: c for k, c in A.launches_bwd_by_variant.items() if c}
    if (count != n if n is not None else count < 1) or not set(by_variant) <= set(variants):
        raise AssertionError(f"{what}: flash_attn_bwd launched {by_variant}, expected "
                             f"{n if n is not None else 'some'} on {variants}")
    return count, by_variant


def phase_train(A, policy, seed):
    """Warm-up, then TIMED_STEPS timed fit steps at full width under the
    named dtype policy; the step check; one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.utils import dtypes

    (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
    try:
        rs = np.random.RandomState(seed)
        n = LM_BATCH * (WARMUP_STEPS + TIMED_STEPS)
        x, y = lm_data(rs, n)
        check = step_check(A, x[:LM_BATCH], y[:LM_BATCH], seed, policy)
        net = make_lm(seed)
        warm = LM_BATCH * WARMUP_STEPS
        net.fit((x[:warm], y[:warm]), batch_size=LM_BATCH)
        first_loss = net.score_history[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        t0 = time.perf_counter()
        net.fit((x[warm:], y[warm:]), batch_size=LM_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = A.launches
        by_variant = dict(A.launches_by_variant)
        bwd, bwd_by_variant = bwd_launched(A, f"LM {policy}", LM_LAYERS * TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated()
        losses = net.score_history
        if launches != LM_LAYERS * TIMED_STEPS:
            raise AssertionError(f"flash_attn launched {launches} times in {TIMED_STEPS} steps "
                                 f"of a {LM_LAYERS}-layer model (expected {LM_LAYERS} a step)")
        # q, k, v stay f32 under both policies (nn/layers/attention.py), as
        # views of the fused projection: every launch on the f32 path variant
        planned = A.plan((LM_BATCH, LM_SEQ, LM_HEADS, LM_WIDTH // LM_HEADS), torch.float32,
                         ((LM_SEQ * 3 * LM_WIDTH, 3 * LM_WIDTH, LM_WIDTH // LM_HEADS),) * 3)
        if by_variant != {**dict.fromkeys(A.VARIANTS, 0), planned.variant: launches}:
            raise AssertionError(f"flash launches by variant {by_variant}: every one should be "
                                 f"{planned.variant}")
        if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
            raise AssertionError(f"loss did not fall: first {first_loss}, timed steps {losses}")
        tokens = TIMED_STEPS * LM_BATCH * LM_SEQ
        row = {"policy": policy, "params": net.num_params(), "batch": LM_BATCH,
               "seq": LM_SEQ, "steps": TIMED_STEPS, "step_ms": 1e3 * wall / TIMED_STEPS,
               "tokens_per_s": tokens / wall, "peak_mem_gb": peak / 1e9,
               "loss_first": first_loss, "loss_last": losses[-1], "losses": losses,
               "flash_launches": launches, "flash_launches_by_variant": by_variant,
               "flash_bwd_launches": bwd, "flash_bwd_launches_by_variant": bwd_by_variant,
               "step_check": check, "card": card_line()}
        emit("train", **row)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit((x[:LM_BATCH], y[:LM_BATCH]))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_family, busy_ms, share = device_families(prof, wall_ms)
        emit("train.profile", policy=policy, wall_ms=wall_ms,
             wall_unprofiled_ms=row["step_ms"], device_ms_by_family=by_family,
             device_busy_ms=busy_ms, device_busy_share=share,
             device_busy_share_unprofiled=busy_ms / row["step_ms"], card=card_line())
        del net, x, y
        torch.cuda.empty_cache()
        return row
    finally:
        dtypes.f32_policy()


def seeded_params(net, rs):
    """The char-RNN's weights from a numpy seed, in the JAX package's
    layout (a list of per-layer dicts)."""
    params = []
    for p in net.params:
        d = {}
        for name, t in p.items():
            shape = tuple(t.shape)
            if name == "b":
                a = np.zeros(shape, np.float32)
                if "Wh" in p:  # LSTM: forget-gate bias 1
                    h = shape[0] // 4
                    a[h:2 * h] = 1.0
            elif name == "Wp":
                a = 0.1 * rs.randn(*shape)
            else:
                a = rs.randn(*shape) * np.sqrt(2.0 / sum(shape))
            d[name] = a.astype(np.float32)
        params.append(d)
    return params


def plain_forward(L, params, x):
    """The char-RNN forward from the plain functions: x.Wx + b, the plain
    LSTM loop with peepholes, then the softmax head."""
    h = x
    for p in params[:2]:
        b, t, _ = h.shape
        hsz = p["Wh"].shape[0]
        xz = (h.reshape(b * t, -1) @ p["Wx"] + p["b"]).reshape(b, t, 4 * hsz).transpose(0, 1)
        zero = torch.zeros(b, hsz, device=x.device)
        hs = L.lstm_seq_plain(xz.contiguous(), p["Wh"], zero, zero, wp=p["Wp"])[0]
        h = hs.transpose(0, 1)
    out = params[2]
    b, t, f = h.shape
    return torch.softmax((h.reshape(b * t, f) @ out["W"] + out["b"]).reshape(b, t, -1), dim=-1)


def phase_serve(L, zip_path):
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ServingOverloaded, get_model_registry
    from deeplearning4j_tpu_torch.utils.serialization import (load_model, params_from_numpy,
                                                             save_model)

    rs = np.random.RandomState(SEED)
    net = MultiLayerNetwork(text_generation_lstm(VOCAB, hidden=HIDDEN, seq_len=SEQ), device="cuda")
    net.init(torch.Generator().manual_seed(SEED))
    params_np = seeded_params(net, rs)
    params_from_numpy(net, params_np)
    if net.num_params() != N_PARAMS:
        raise AssertionError(f"char-RNN has {net.num_params()} params, expected {N_PARAMS}")
    save_model(net, zip_path)
    net = load_model(zip_path, device="cuda")
    for mine, theirs in zip(net.params, params_np):
        for k, v in theirs.items():
            if not np.array_equal(mine[k].cpu().numpy(), v):
                raise AssertionError(f"save/load round trip changed {k}")
    params = [{k: v.detach() for k, v in p.items()} for p in net.params]

    # requests: one-hot characters, lengths 1..128, single and batched
    reqs = []
    for i in range(320):
        rows = None if i % 5 else int(rs.randint(2, 17))
        steps = int(rs.randint(1, SEQ + 1))
        ids = rs.randint(0, VOCAB, size=(rows or 1, steps))
        x = np.eye(VOCAB, dtype=np.float32)[ids]
        reqs.append((x if rows else x[0], rows is not None))

    # the main path, from registration (its warmup runs every bucket) to
    # the last result
    L.reset_launches()
    registry = get_model_registry()
    t_reg = time.perf_counter()
    engine = registry.register("charnn", net, input_spec=(SEQ, VOCAB), max_batch_size=64,
                               seq_buckets=(32, 64, 128), device="cuda")
    warm_s = time.perf_counter() - t_reg
    futs, shed = [], 0
    t0 = time.perf_counter()
    try:
        for x, batched in reqs:
            while True:
                try:
                    futs.append(engine.submit(x, batched=batched))
                    break
                except ServingOverloaded:
                    shed += 1  # queue full: back off and resubmit
                    time.sleep(0.001)
        outs = [f.get(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        registry.stop()
    launches = L.launches
    by_variant = dict(L.launches_by_variant)
    forwards = stats["forward"]["forwards"]
    if launches == 0 or launches != 2 * forwards:
        raise AssertionError(f"lstm_seq launched {launches} times for {forwards} device "
                             "forwards of a 2-layer LSTM (expected exactly 2 per forward)")
    if by_variant != {**dict.fromkeys(L.VARIANTS, 0), "persistent": launches}:
        raise AssertionError(f"lstm_seq launches by variant {by_variant}: every served launch "
                             "should be persistent")

    max_err = 0.0
    tokens = 0
    for (x, batched), y in zip(reqs, outs):
        xb = x if batched else x[None]
        yb = y if batched else y[None]
        if yb.shape != xb.shape[:2] + (VOCAB,):
            raise AssertionError(f"served output shape {y.shape} for input {x.shape}")
        if not np.isfinite(yb).all():
            raise AssertionError("served output not finite")
        if not np.allclose(yb.sum(-1), 1.0, atol=1e-4):
            raise AssertionError("served softmax rows do not sum to 1")
        want = plain_forward(L, params, torch.from_numpy(xb).cuda()).cpu().numpy()
        err = float(np.abs(yb - want).max())
        max_err = max(max_err, err)
        if err > SERVE_ATOL:
            raise AssertionError(f"served output differs from the plain forward by {err}")
        tokens += xb.shape[0] * xb.shape[1]
    lats = sorted(f.latency_s for f in futs)
    result = {
        "params": net.num_params(), "requests": len(reqs), "rows": stats["requests"]["served"],
        "tokens": tokens, "resubmits_after_queue_full": shed, "device_forwards": forwards,
        "warmup_forwards": stats["forward"]["warmed"], "lstm_seq_launches": launches,
        "lstm_seq_launches_by_variant": by_variant,
        "register_s": warm_s, "wall_s": wall, "tokens_per_s": tokens / wall,
        "p50_ms": 1e3 * float(np.percentile(lats, 50)),
        "p99_ms": 1e3 * float(np.percentile(lats, 99)),
        "max_abs_err_vs_plain": max_err, "atol": SERVE_ATOL, "card": card_line()}
    emit("serve", **result)
    return result, net


def serve_sanitized(L, net):
    """After the serve phase's measured burst: SAN_REQUESTS more requests
    through a fresh registry and engine under the port's runtime
    sanitizer (``analysis/sanitizer.py``: the locks the port's modules
    allocate record their acquisition order, every InferenceFuture is
    tracked, threads left alive are swept), each answer held against the
    plain forward. The sanitizer must report nothing, and its report,
    merged with the static R9 lock graph of ``serving/`` and
    ``telemetry/`` through ``lint --san-report``, must merge clean."""
    import contextlib
    import io

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.analysis.sanitizer import Sanitizer
    from deeplearning4j_tpu_torch.serving import ModelRegistry

    rs = np.random.RandomState(SEED + 7)
    reqs = [np.eye(VOCAB, dtype=np.float32)[rs.randint(0, VOCAB, size=(
        int(rs.randint(1, 4)), int(rs.randint(1, SEQ + 1))))] for _ in range(SAN_REQUESTS)]
    params = [{k: v.detach() for k, v in p.items()} for p in net.params]
    t0 = time.perf_counter()
    with Sanitizer() as san:
        registry = ModelRegistry()
        try:
            engine = registry.register("charnn", net, input_spec=(SEQ, VOCAB),
                                       max_batch_size=64, seq_buckets=(32, 64, 128),
                                       device="cuda")
            futs = [engine.submit(x, batched=True) for x in reqs]
            outs = [f.get(timeout=300) for f in futs]
        finally:
            registry.stop()
        findings = san.check()
        report = san.report(findings)
        tracked = {"locks": len(report["locks"]), "futures": len(san._futures)}
    served_s = time.perf_counter() - t0
    if findings:
        raise AssertionError("the sanitizer reported: " + "; ".join(f.human() for f in findings))
    if not tracked["locks"] or tracked["futures"] < len(reqs):
        raise AssertionError(f"the sanitizer tracked {tracked}: it did not see the engine")
    max_err = 0.0
    for x, y in zip(reqs, outs):
        want = plain_forward(L, params, torch.from_numpy(x).cuda()).cpu().numpy()
        if y.shape != want.shape or not np.isfinite(y).all():
            raise AssertionError(f"sanitized burst: output {y.shape} for input {x.shape}")
        max_err = max(max_err, float(np.abs(y - want).max()))
    if max_err > SERVE_ATOL:
        raise AssertionError(f"sanitized burst differs from the plain forward by {max_err}")
    path = WORK / "graftsan.json"
    path.write_text(json.dumps(report))
    t1 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["lint", "--san-report", str(path),
                       str(ROOT / "deeplearning4j_tpu_torch" / "serving"),
                       str(ROOT / "deeplearning4j_tpu_torch" / "telemetry")])
    merge_s = time.perf_counter() - t1
    if rc != 0 or "merge clean" not in out.getvalue():
        raise AssertionError(f"lint --san-report exited {rc}:\n{out.getvalue()}")
    row = {"requests": len(reqs), "findings": [], "observed_edges": len(report["lock_order_edges"]),
           "tracked": tracked, "max_abs_err_vs_plain": max_err, "served_s": served_s,
           "merge_s": merge_s, "seconds": time.perf_counter() - t0,
           "merge": out.getvalue().strip().splitlines()[-1], "card": card_line()}
    emit("serve.sanitizer", **row)
    return row


def phase_profile(net):
    """Where one forward at the largest bucket (64 x 128) spends device
    time, from a torch.profiler trace: device time by kernel family and
    the share of the forward's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(64, SEQ, VOCAB, device="cuda")
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        net.apply_fn(net.params, net.state, x)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_unprofiled_ms = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.apply_fn(net.params, net.state, x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_family = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        family = ("lstm_seq" if "lstm_persistent_kernel" in name or "lstm_step_kernel" in name else
                  "gemm" if any(k in name for k in ("gemm", "cutlass", "matmul", "xmma")) else
                  "copy" if "memcpy" in name or "copy" in name else "other")
        spans.append((e.time_range.start, e.time_range.end))
        by_family[family] = by_family.get(family, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy_us, end = 0.0, None
    for a, b in sorted(spans):  # union of device intervals
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    # the profiler slows the host's launches, so the busy share is given
    # against both the profiled and the unprofiled wall time
    emit("profile", bucket=[64, SEQ], wall_ms=wall_ms, wall_unprofiled_ms=wall_unprofiled_ms,
         device_events=len(spans), device_ms_by_family=by_family, device_busy_ms=busy_us / 1e3,
         device_busy_share=(busy_us / 1e3 / wall_ms) if spans else None,
         device_busy_share_unprofiled=(busy_us / 1e3 / wall_unprofiled_ms) if spans else None,
         card=card_line())


def phase_cli(zip_path):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path", str(zip_path),
         "--max-batch", "64", "--smoke", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    stats = json.loads(proc.stdout[proc.stdout.index("{"):])
    if stats["requests"]["served"] != 64:
        raise AssertionError(f"serve CLI served {stats['requests']['served']} of 64")
    emit("cli", rc=proc.returncode, served=stats["requests"]["served"],
         device=stats["device"], seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# training the char-RNN (the LSTM backward, TBPTT, streaming)
# ---------------------------------------------------------------------------

def charnn_data(rs, n, t):
    """n one-hot sequences of ids[t+1] = (5 ids[t] + 3) mod V from random
    starts: x [n,t,V] and its next-character labels y, on the card."""
    ids = np.zeros((n, t + 1), np.int64)
    ids[:, 0] = rs.randint(0, VOCAB, size=n)
    for i in range(t):
        ids[:, i + 1] = (5 * ids[:, i] + 3) % VOCAB
    ids = torch.from_numpy(ids).cuda()
    one_hot = torch.nn.functional.one_hot(ids, VOCAB).float()
    return one_hot[:, :t].contiguous(), one_hot[:, 1:].contiguous()


def make_charnn(seed):
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(text_generation_lstm(VOCAB, hidden=HIDDEN, seq_len=SEQ),
                            device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    if net.num_params() != N_PARAMS:
        raise AssertionError(f"char-RNN has {net.num_params()} params, expected {N_PARAMS}")
    return net


@contextlib.contextmanager
def plain_lstm_forward(L):
    """Within this block the LSTM's autograd.Function computes its forward
    with ``lstm_seq_plain`` on the card instead of the kernel (the backward,
    ``lstm_seq_bwd``, is the same)."""
    saved = L.lstm_seq_fwd

    def plain(xz, wh, h0, c0, wp=None, mask=None):
        with torch.no_grad():
            return L.lstm_seq_plain(xz, wh, h0, c0, wp=wp, mask=mask)
    L.lstm_seq_fwd = plain
    try:
        yield
    finally:
        L.lstm_seq_fwd = saved


def charnn_step_check(L, x, y, seed, policy):
    """One step from identical weights through the kernel forward and
    through the plain forward, the same backward after both. f32: loss
    within rtol 1e-5, each gradient within 1e-4 of its norm, parameters
    after RmsProp's first step within atol 1e-4. bf16: the two forwards
    round h to bf16 after sums taken in different orders, so an output can
    sit one bf16 ulp apart and the gradients follow: loss within rtol 1e-3,
    each gradient within 2e-2 of its norm, at most 1% of the parameters
    beyond atol 1e-4 (RmsProp's first step is about lr/sqrt(1 - decay)
    sign(g), so a gradient element near zero may take either sign)."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    kern = make_charnn(seed)
    before = L.launches
    lk, gk = one_step(kern, x, y)
    kern_launches = L.launches - before
    with plain_lstm_forward(L):
        plain = make_charnn(seed)
        before = L.launches
        lp, gp = one_step(plain, x, y)
        if L.launches != before:
            raise AssertionError("the plain-forward step launched lstm_seq")
    if kern_launches != 2:
        raise AssertionError(f"the kernel step launched lstm_seq {kern_launches} times, not 2")
    f32 = policy == "f32"
    loss_rtol, grad_rtol = (CHARNN_LOSS_RTOL, CHARNN_GRAD_RTOL) if f32 else \
        (CHARNN_BF16_LOSS_RTOL, CHARNN_BF16_GRAD_RTOL)
    if not abs(lk - lp) <= loss_rtol * abs(lp):
        raise AssertionError(f"kernel step loss {lk} vs plain-forward step loss {lp} ({policy})")
    err, beyond, grad_rel = 0.0, 0, 0.0
    for a, b, ga, gb in zip(tree_leaves(kern.params), tree_leaves(plain.params), gk, gp):
        grad_rel = max(grad_rel, ((ga - gb).norm() / gb.norm().clamp_min(1e-30)).item())
        diff = (a - b).abs()
        err = max(err, diff.max().item())
        beyond += int((diff > CHARNN_PARAM_ATOL).sum())
    if not grad_rel <= grad_rtol:
        raise AssertionError(f"gradients differ by {grad_rel} relative between the kernel step "
                             f"and the plain-forward step ({policy})")
    if f32 and not err <= CHARNN_PARAM_ATOL:
        raise AssertionError(f"updated parameters differ by {err} between the kernel step and "
                             "the plain-forward step")
    n = sum(g.numel() for g in gp)
    if not f32 and not beyond <= CHARNN_BF16_PARAM_SHARE * n:
        raise AssertionError(f"{beyond} of {n} updated parameters differ by more than "
                             f"{CHARNN_PARAM_ATOL} between the kernel and plain-forward steps")
    del kern, plain, gk, gp
    torch.cuda.empty_cache()
    return {"loss_kernel": lk, "loss_plain": lp, "max_grad_rel_diff": grad_rel,
            "max_abs_param_diff": err, "params_beyond_atol": beyond, "params": n,
            "param_atol": CHARNN_PARAM_ATOL, "loss_rtol": loss_rtol, "grad_rtol": grad_rtol}


def charnn_family(name):
    return ("lstm_fwd" if "lstm_persistent_kernel" in name or "lstm_step_kernel" in name else
            "gemm" if any(s in name for s in ("gemm", "cutlass", "xmma", "sm90", "matmul"))
            else "elementwise_other")


def bwd_bound(t, b, h, dtype):
    """Least time (ms) for one lstm_seq_bwd call and what sets it: its
    inputs (xz, Wh, Wp, h0, c0, hs, cs, dhs) read once and outputs (dxz,
    dWh, dWp, dh0, dc0) written once, against three products a step the
    size of the forward's (the gate recompute, dz.Wh^T and dWh) over the
    dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    n_in = t * b * 4 * h + h * 4 * h + 3 * h + 2 * b * h + 3 * t * b * h
    n_out = t * b * 4 * h + h * 4 * h + 3 * h + 2 * b * h
    return roofline(elt * (n_in + n_out), 3 * 2 * t * b * h * 4 * h, dtype)


def cudnn_lstm_train(xz, wh, h0, c0):
    """torch.nn.LSTM on the same xz as ``cudnn_lstm`` (no peepholes, no
    mask), with gradients: (forward, forward + backward)."""
    h = wh.shape[0]
    mod = torch.nn.LSTM(4 * h, h, bias=False).to("cuda", xz.dtype)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(torch.eye(4 * h, device="cuda", dtype=xz.dtype))
        mod.weight_hh_l0.copy_(wh.t())
    xg = xz.detach().clone().requires_grad_(True)
    state = (h0.to(xz.dtype)[None].contiguous(), c0.to(xz.dtype)[None].contiguous())
    dy = torch.randn(xz.shape[0], xz.shape[1], h, device="cuda", dtype=xz.dtype)

    def fwd():
        with torch.enable_grad():
            return mod(xg, state)[0]

    def fwd_bwd():
        with torch.enable_grad():
            torch.autograd.grad(mod(xg, state)[0], (xg, mod.weight_hh_l0), dy)
    return fwd, fwd_bwd


def bwd_timing(L, dtype):
    """``lstm_seq_bwd`` at the path's shape (T=128, B=64, H=512, peepholes)
    in ``dtype``: back to back, on the card alone, its bound, and cuDNN's
    nn.LSTM backward (its forward + backward less its forward, TF32 off;
    cuDNN's LSTM has no peepholes)."""
    rs = np.random.RandomState(SEED + 6)
    b = CHARNN_BATCH
    xz, wh, h0, c0, wp, _ = lstm_inputs(rs, SEQ, b, HIDDEN, dtype, True, False)
    fwd = L.lstm_seq(xz, wh, h0, c0, wp=wp)
    dhs = torch.randn_like(fwd.hs)
    bwd = lambda: L.lstm_seq_bwd(xz, wh, wp, h0, c0, None, fwd.hs, fwd.cs, dhs,  # noqa: E731
                                 None, None)
    ms = time_ms(bwd, iters=5, reps=5)
    # one call a timing: its ~900 launches stay within the launch queue, so
    # all of them wait behind the sleep kernel
    dev_ms = device_ms(bwd, iters=1, reps=5, sleep_cycles=200_000_000)
    with library_precision():
        lib_fwd, lib_fwd_bwd = cudnn_lstm_train(xz, wh, h0, c0)
        lib_fwd_ms = time_ms(lib_fwd, iters=5, reps=5)
        lib_fwd_bwd_ms = time_ms(lib_fwd_bwd, iters=5, reps=5)
    bound_ms, bound_by = bwd_bound(SEQ, b, HIDDEN, dtype)
    return {"T": SEQ, "B": b, "H": HIDDEN, "dtype": str(dtype).split(".")[-1], "ms": ms,
            "device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd_bwd_ms - lib_fwd_ms, "library_fwd_ms": lib_fwd_ms,
            "library_fwd_bwd_ms": lib_fwd_bwd_ms, "library_note": "cuDNN nn.LSTM backward "
            "(forward + backward less forward), no peepholes", "card": card_line()}


def phase_charnn(L, policy, seed):
    """The full-width char-RNN trained by ``MultiLayerNetwork.fit`` under
    the named policy: the step check, warm-up, TIMED_STEPS timed steps (2
    persistent lstm_seq launches a step), one profiled step, CHARNN_MORE_STEPS
    more after which the mean of the last CHARNN_LOSS_WINDOW losses must be
    below the first step's, TBPTT over sequences of 4 x SEQ, rnn_time_step
    against the full forward, and the backward's times. Returns the summary
    row."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.utils import dtypes

    (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
    try:
        rs = np.random.RandomState(seed + 7)
        n = CHARNN_BATCH * (WARMUP_STEPS + TIMED_STEPS + CHARNN_MORE_STEPS)
        x, y = charnn_data(rs, n, SEQ)
        check = charnn_step_check(L, x[:CHARNN_BATCH], y[:CHARNN_BATCH], seed, policy)
        net = make_charnn(seed)
        warm = CHARNN_BATCH * WARMUP_STEPS
        net.fit((x[:warm], y[:warm]), batch_size=CHARNN_BATCH)
        first_loss = net.score_history[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = slice(warm, warm + CHARNN_BATCH * TIMED_STEPS)
        L.reset_launches()
        t0 = time.perf_counter()
        net.fit((x[timed], y[timed]), batch_size=CHARNN_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_variant = L.launches, dict(L.launches_by_variant)
        peak = torch.cuda.max_memory_allocated()
        losses = net.score_history
        if launches != 2 * TIMED_STEPS or \
                by_variant != {**dict.fromkeys(L.VARIANTS, 0), "persistent": launches}:
            raise AssertionError(f"lstm_seq launched {by_variant} in {TIMED_STEPS} steps "
                                 "(expected 2 persistent launches a step)")
        L.reset_launches()
        net.fit((x[timed.stop:], y[timed.stop:]), batch_size=CHARNN_BATCH)
        more_launches = L.launches
        later = net.score_history
        late_mean = float(np.mean(later[-CHARNN_LOSS_WINDOW:]))
        if not all(np.isfinite(losses + later)) or not late_mean < first_loss or \
                more_launches != 2 * CHARNN_MORE_STEPS:
            raise AssertionError(f"loss did not fall: first {first_loss}, timed steps {losses}, "
                                 f"then {later} ({more_launches} lstm_seq launches)")
        row = {"policy": policy, "params": net.num_params(), "batch": CHARNN_BATCH,
               "seq": SEQ, "steps": TIMED_STEPS, "step_ms": 1e3 * wall / TIMED_STEPS,
               "tokens_per_s": TIMED_STEPS * CHARNN_BATCH * SEQ / wall,
               "peak_mem_gb": peak / 1e9, "loss_first": first_loss, "loss_last": losses[-1],
               "losses": losses, "steps_in_all": WARMUP_STEPS + TIMED_STEPS + CHARNN_MORE_STEPS,
               "loss_last_mean": late_mean, "losses_after": later, "lstm_launches": launches,
               "lstm_launches_by_variant": by_variant, "step_check": check,
               "card": card_line()}
        emit("charnn", **row)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit((x[:CHARNN_BATCH], y[:CHARNN_BATCH]))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_family, busy_ms, share = device_families(
            prof, wall_ms, charnn_family,
            (("lstm_seq.backward", "lstm_bwd"), ("updater.step", "optimizer")))
        kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                      and e.name not in ("lstm_seq.backward", "updater.step")
                      for e in prof.events())
        emit("charnn.profile", policy=policy, wall_ms=wall_ms,
             wall_unprofiled_ms=row["step_ms"], device_ms_by_family=by_family,
             device_busy_ms=busy_ms, device_busy_share=share,
             device_busy_share_unprofiled=busy_ms / row["step_ms"],
             device_events_per_step=kernels, card=card_line())

        # TBPTT: sequences of 4 x SEQ in chunks of SEQ, from fresh weights
        xt, yt = charnn_data(rs, CHARNN_BATCH * CHARNN_TBPTT_BATCHES, CHARNN_TBPTT_CHUNKS * SEQ)
        tnet = make_charnn(seed + 1)
        it0 = tnet.iteration
        L.reset_launches()
        t0 = time.perf_counter()
        tnet.fit((xt, yt), batch_size=CHARNN_BATCH)
        torch.cuda.synchronize()
        tb_wall = time.perf_counter() - t0
        tb_launches, tb_variant = L.launches, dict(L.launches_by_variant)
        chunks = CHARNN_TBPTT_CHUNKS * CHARNN_TBPTT_BATCHES
        tb_losses = tnet.score_history
        if tnet.iteration - it0 != chunks:
            raise AssertionError(f"TBPTT advanced iteration by {tnet.iteration - it0}, "
                                 f"expected {chunks}")
        if tb_launches != 2 * chunks or tb_variant["persistent"] != tb_launches:
            raise AssertionError(f"TBPTT launched lstm_seq {tb_variant} for {chunks} chunks "
                                 "(expected 2 persistent launches a chunk)")
        if len(tb_losses) != CHARNN_TBPTT_BATCHES or not all(np.isfinite(tb_losses)) or \
                not tb_losses[-1] < tb_losses[0]:
            raise AssertionError(f"TBPTT losses {tb_losses}: one a batch, falling")
        del tnet, xt, yt

        # streaming: rnn_time_step over STREAM_STEPS single steps against the
        # full forward of the same steps
        xs = x[:CHARNN_BATCH, :STREAM_STEPS]
        L.reset_launches()
        full = net.output(xs)
        net.rnn_clear_previous_state()
        stream = torch.stack([net.rnn_time_step(xs[:, i]) for i in range(STREAM_STEPS)], 1)
        torch.cuda.synchronize()
        st_launches = L.launches
        stream_err = (stream.float() - full.float()).abs().max().item()
        stream_tol = STREAM_F32_ATOL if policy == "f32" else BF16_ATOL
        if stream.shape != full.shape or not torch.isfinite(stream).all() or \
                not stream_err <= stream_tol:
            raise AssertionError(f"rnn_time_step differs from the full forward by {stream_err} "
                                 f"({policy})")
        if st_launches != 2 * (STREAM_STEPS + 1):
            raise AssertionError(f"streaming launched lstm_seq {st_launches} times, expected "
                                 f"{2 * (STREAM_STEPS + 1)}")
        emit("charnn.tbptt", policy=policy, batch=CHARNN_BATCH, seq=CHARNN_TBPTT_CHUNKS * SEQ,
             chunk=SEQ, batches=CHARNN_TBPTT_BATCHES, iterations=chunks,
             ms_per_chunk=1e3 * tb_wall / chunks,
             tokens_per_s=CHARNN_BATCH * CHARNN_TBPTT_CHUNKS * SEQ * CHARNN_TBPTT_BATCHES
             / tb_wall, losses=tb_losses, lstm_launches=tb_launches,
             stream_steps=STREAM_STEPS, stream_max_abs_err=stream_err, stream_atol=stream_tol,
             stream_launches=st_launches, card=card_line())
        bwd = bwd_timing(L, torch.float32 if policy == "f32" else torch.bfloat16)
        emit("charnn.backward", **bwd)
        del net, x, y
        torch.cuda.empty_cache()
        return {**row, "path_launches": launches + more_launches + tb_launches + st_launches,
                "bwd": bwd}
    finally:
        dtypes.f32_policy()


# ---------------------------------------------------------------------------
# conv-statistics kernels and the fused ResNet50
# ---------------------------------------------------------------------------

def resnet_conv_calls():
    """(kernel, stride, x shape, Cout) of every conv-kernel call in one
    forward of the fused ResNet50 at the smoke's batch, in graph order."""
    from deeplearning4j_tpu_torch.models import resnet50

    conf = resnet50(RN_HW, RN_HW, n_classes=RN_CLASSES, fused=True)
    types = conf.vertex_types()
    calls = []
    for v in conf.vertices:
        if type(v.vertex).__name__ != "FusedConvBNVertex":
            continue
        it = types[v.inputs[0]]
        calls.append((tuple(v.vertex.kernel), tuple(v.vertex.stride),
                      (RN_BATCH, it.height, it.width, it.channels), v.vertex.n_out))
    return calls


def conv_bound(kernel, stride, shape, cout, dtype):
    """Least time (ms) for one conv-statistics call and what sets it: the
    input pixels the conv reads, w, z and the statistics moved once over the
    memory rate, against 2*M*k*k*Cin*Cout operations over the dtype's peak."""
    b, h, w, cin = shape
    ho, wo = -(-h // stride[0]), -(-w // stride[1])
    m, kk = b * ho * wo, kernel[0] * kernel[1]
    elt = torch.finfo(dtype).bits // 8
    x_elems = m * cin if kk == 1 else b * h * w * cin
    nbytes = elt * (x_elems + kk * cin * cout + m * cout) + 4 * 2 * cout
    return roofline(nbytes, 2 * m * kk * cin * cout, dtype)


def conv_inputs(rs, kernel, shape, cout, dtype):
    cin = shape[3]
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to("cuda", dtype)
    w = rs.randn(*kernel, cin, cout) / np.sqrt(kernel[0] * kernel[1] * cin)
    return x, torch.from_numpy(w.astype(np.float32)).to("cuda", dtype)


def conv_fns(C, kernel, stride, x, w):
    """The kernel, its plain version and cuDNN's ``F.conv2d`` (NCHW views
    of the NHWC tensors, channels-last, XLA's SAME pads: z alone, no
    statistics) on the same inputs."""
    cin, cout = w.shape[2], w.shape[3]
    if kernel == (1, 1):
        w2 = w.reshape(cin, cout)
        kern = lambda: C.conv_mm_stats(x, w2, stride)  # noqa: E731
        plain = lambda: C.conv_mm_stats_plain(x, w2, stride)  # noqa: E731
    else:
        kern = lambda: C.conv3x3_stats(x, w, stride)  # noqa: E731
        plain = lambda: C.conv3x3_stats_plain(x, w, stride)  # noqa: E731
    (hl, hh), (wl, wh) = (C.same_pads(x.shape[1], kernel[0], stride[0]),
                          C.same_pads(x.shape[2], kernel[1], stride[1]))
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if (hl, wl) != (hh, wh):
        xn, pad = torch.nn.functional.pad(xn, (wl, wh, hl, hh)), (0, 0)
    else:
        pad = (hl, wl)
    library = lambda: torch.nn.functional.conv2d(xn, wn, stride=stride, padding=pad)  # noqa: E731
    return kern, plain, library


def check_conv(C, rs, kernel, stride, shape, cout, dtype):
    """The kernel against its plain version on the card: z within
    CONV_F32_ZTOL (f32) or CONV_BF16_TOL + CONV_BF16_TOL·|z| (bf16); each
    statistic within CONV_STATS_RTOL of the sum of its terms' magnitudes
    (sum |z| for sum z, which cancels, sum z^2 itself) + CONV_STATS_ATOL.
    Returns the max |diff| of z and the statistics' largest relative error."""
    x, w = conv_inputs(rs, kernel, shape, cout, dtype)
    kern, plain, _ = conv_fns(C, kernel, stride, x, w)
    (z, st), (zp, sp) = kern(), plain()
    torch.cuda.synchronize()
    what = f"conv {kernel} s{stride} {shape}->{cout} {dtype}"
    if dtype == torch.float32:
        z_err = check_close(f"{what} z", z, zp, CONV_F32_ZTOL, 0.0)
    else:
        z_err = check_close(f"{what} z", z, zp, CONV_BF16_TOL, CONV_BF16_TOL)
    zf = zp.float().reshape(-1, cout)
    scale = torch.stack((zf.abs().sum(0), (zf * zf).sum(0)))
    if not torch.isfinite(st).all():
        raise AssertionError(f"{what} statistics: not finite")
    st_rel = ((st - sp).abs() / (scale + CONV_STATS_ATOL / CONV_STATS_RTOL)).max().item()
    if st_rel > CONV_STATS_RTOL:
        raise AssertionError(f"{what} statistics differ by {st_rel} of their terms' magnitude "
                             f"(tolerance {CONV_STATS_RTOL})")
    return z_err, st_rel


def check_plan(C, kernel, stride, shape, cout, dtype):
    """The call's launch plan against the built library: its shared memory
    as the CUDA source counts it, and at least ``blocks_per_sm`` blocks of
    it fitting on an SM. Returns the plan."""
    import ctypes

    pl = C.plan(kernel[0], shape, cout, stride, dtype, C._sm_count(torch.device("cuda")))
    lib = C._LIB.get()
    v = C.VARIANTS.index(pl.variant)
    smem = lib.conv_stats_smem_bytes(v, pl.bm, pl.bn)
    blocks = ctypes.c_int(0)
    err = lib.conv_stats_occupancy(v, kernel[0], pl.bm, pl.bn, 0, ctypes.byref(blocks))
    if err != 0 or smem != pl.smem_bytes or blocks.value < max(pl.blocks_per_sm, 1):
        raise AssertionError(f"plan {pl} for {kernel} s{stride} {shape}->{cout} {dtype}: the "
                             f"library counts {smem} bytes and fits {blocks.value} blocks an "
                             f"SM (error {err})")
    return pl


def phase_conv(C):
    """Both kernels against their plain versions at every geometry of the
    fused ResNet50 at batch 64 and at edge cases, f32 and bf16, each on the
    variant its plan names; then the path geometries timed beside the
    bound, the plain version and cuDNN."""
    rs = np.random.RandomState(SEED + 3)
    calls = resnet_conv_calls()
    geoms = list(dict.fromkeys(calls))
    edge = [((1, 1), (1, 1), (3, 7, 7, 48), 96),     # Cin, Cout off the tiles, N = 147
            ((1, 1), (1, 1), (5, 7, 9, 20), 72),     # Cin off the 16-channel step
            ((1, 1), (2, 2), (3, 7, 7, 48), 96),     # strided on an odd map
            ((3, 3), (1, 1), (3, 7, 7, 48), 96),     # the 7x7 map, ragged channels
            ((3, 3), (2, 2), (RN_BATCH, 56, 56, 64), 64),   # stride 2 on even dims
            ((3, 3), (2, 2), (2, 10, 12, 40), 70)]
    cases, path_err = [], 0.0
    for kernel, stride, shape, cout in geoms + edge:
        for dtype in (torch.float32, torch.bfloat16):
            pl = check_plan(C, kernel, stride, shape, cout, dtype)
            before = dict(C.launches_by_variant)
            z_err, st_rel = check_conv(C, rs, kernel, stride, shape, cout, dtype)
            ran = [k for k in before if C.launches_by_variant[k] != before[k]]
            if ran != [pl.variant]:
                raise AssertionError(f"{kernel} {shape}->{cout} {dtype} ran {ran}, its plan "
                                     f"names {pl.variant}")
            on_path = (kernel, stride, shape, cout) in geoms
            if on_path and pl.variant not in ("bf16_wgmma", "f32_pipelined"):
                raise AssertionError(f"path geometry {kernel} {shape}->{cout} planned on "
                                     f"{pl.variant}")
            if on_path and dtype == torch.float32:
                path_err = max(path_err, z_err)
            cases.append({"kernel": kernel[0], "stride": stride[0], "x": list(shape), "cout": cout,
                          "dtype": str(dtype).split(".")[-1], "path": on_path,
                          "variant": pl.variant, "max_abs_err_z": z_err, "stats_rel_err": st_rel})
    torch.cuda.empty_cache()
    emit("conv", cases=len(cases), path_geometries=len(geoms), edge_cases=len(edge),
         f32_z_atol=CONV_F32_ZTOL, bf16_tol=CONV_BF16_TOL, stats_rtol=CONV_STATS_RTOL,
         stats_atol=CONV_STATS_ATOL,
         max_abs_err_z_f32=max(c["max_abs_err_z"] for c in cases if c["dtype"] == "float32"),
         max_abs_err_z_bf16=max(c["max_abs_err_z"] for c in cases if c["dtype"] == "bfloat16"),
         max_stats_rel_err=max(c["stats_rel_err"] for c in cases),
         cases_by_variant={v: sum(c["variant"] == v for c in cases) for v in C.VARIANTS})

    rows = []
    for kernel, stride, shape, cout in geoms:
        n = calls.count((kernel, stride, shape, cout))
        for dtype in (torch.float32, torch.bfloat16):
            x, w = conv_inputs(rs, kernel, shape, cout, dtype)
            kern, plain, library = conv_fns(C, kernel, stride, x, w)
            bound_ms, bound_by = conv_bound(kernel, stride, shape, cout, dtype)
            pl = C.plan(kernel[0], shape, cout, stride, dtype, C._sm_count(x.device))
            row = {"kernel": kernel[0], "stride": stride[0], "x": list(shape), "cout": cout,
                   "dtype": str(dtype).split(".")[-1], "calls_per_forward": n,
                   "plan": {k: getattr(pl, k) for k in ("variant", "bm", "bn", "grid", "tiles")},
                   "ms": time_ms(kern, iters=5, reps=5),
                   "plain_ms": time_ms(plain, iters=5, reps=5),
                   "library_ms": time_ms(library, iters=5, reps=5),
                   "device_ms": device_ms(kern, iters=10, reps=5),
                   "plain_device_ms": device_ms(plain, iters=5, reps=3),
                   "library_device_ms": device_ms(library, iters=10, reps=5),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows.append(row)
            emit("conv.timing", **row)
            del x, w
    torch.cuda.empty_cache()
    totals = {}
    for name, ks in (("conv_mm_stats", 1), ("conv3x3_stats", 3)):
        for dt in ("float32", "bfloat16"):
            sel = [r for r in rows if r["kernel"] == ks and r["dtype"] == dt]
            totals[(name, dt)] = {k: sum(r[k] * r["calls_per_forward"] for r in sel)
                                  for k in ("ms", "plain_ms", "library_ms", "device_ms",
                                            "plain_device_ms", "library_device_ms",
                                            "bound_ms")}
            by_ops = sum(r["calls_per_forward"] * r["bound_ms"] for r in sel
                         if r["bound_by"] == "operations")
            totals[(name, dt)]["bound_by"] = ("operations" if 2 * by_ops >=
                                              totals[(name, dt)]["bound_ms"] else "bytes")
            emit("conv.forward_total", kernel=name, dtype=dt,
                 calls=sum(r["calls_per_forward"] for r in sel), **totals[(name, dt)],
                 card=card_line())
    return totals, path_err


def resnet_data(seed, n, hw=RN_HW, n_out=RN_CLASSES, classes=RN_TASK_CLASSES, draw_seed=None):
    """n synthetic labelled images on the card: each of ``classes`` class
    templates (uniform noise images from the seed) plus noise of half its
    amplitude, labels one-hot over the ``n_out`` outputs; ``draw_seed``
    draws other labels and noise over the same templates (held-out
    images)."""
    rs = np.random.RandomState(seed)
    templates = torch.from_numpy(rs.rand(classes, hw, hw, 3).astype(np.float32))
    if draw_seed is not None:
        rs = np.random.RandomState(draw_seed)
    labels = torch.from_numpy(rs.randint(0, classes, size=n)).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed if draw_seed is None else draw_seed)
    x = templates.cuda()[labels] + 0.5 * torch.rand(n, hw, hw, 3, device="cuda", generator=g)
    return x, torch.nn.functional.one_hot(labels, n_out).float()


def make_resnet(seed, scope=None):
    from deeplearning4j_tpu_torch.models import resnet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(resnet50(RN_HW, RN_HW, n_classes=RN_CLASSES, fused=True,
                                    checkpoint_scope=scope), device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    if net.num_params() != RN_PARAMS:
        raise AssertionError(f"resnet50 has {net.num_params()} params, expected {RN_PARAMS}")
    return net


@contextlib.contextmanager
def plain_conv_kernels(C):
    """Within this block the fused op computes z and its statistics with the
    kernels' plain versions on the card instead of the kernels."""
    saved = C.conv_mm_stats, C.conv3x3_stats
    C.conv_mm_stats, C.conv3x3_stats = C.conv_mm_stats_plain, C.conv3x3_stats_plain
    try:
        yield
    finally:
        C.conv_mm_stats, C.conv3x3_stats = saved


def graph_step(C, seed, x, y, plain=False, scope=None):
    """The first step of ``fit`` on a fresh net from ``seed`` (remat with
    ``scope="prefix"``): gradients and BN state, then the updater from
    fresh state; with ``plain`` the fused op runs the kernels' plain
    versions (and must launch no kernel). Returns (loss, {path: gradient},
    {path: parameter}, {path: state})."""
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    from deeplearning4j_tpu_torch.utils import dtypes

    net = make_resnet(seed, scope)
    launched = dict(C.launches)
    # the policy's precision, as fit runs it (cuDNN without TF32 under f32)
    with plain_conv_kernels(C) if plain else contextlib.nullcontext(), \
            dtypes.policy_precision():
        loss, state, grads = net.compute_gradients(net.params, net.state, x, y)
    if plain and C.launches != launched:
        raise AssertionError("the plain-version step launched a conv kernel")
    net.opt_state = net.conf.updater.init(net.params)
    net.apply_update(net.params, net.opt_state, grads, 0)
    out = (float(loss), flatten_tree(grads), {k: v.detach() for k, v in
                                              flatten_tree(net.params).items()},
           flatten_tree(state))
    del net
    return out


def step_diff(a, b):
    """How far step ``a`` is from step ``b``: relative loss difference, the
    gradients' relative difference (all tensors together, and per tensor),
    the state's max |diff| (absolute, and per tensor relative to the larger
    of 1 and the tensor's largest magnitude), the parameters' max |diff|
    and the parameter elements beyond RN_PARAM_ATOL."""
    rel = {k: ((a[1][k] - b[1][k]).norm() / b[1][k].norm().clamp_min(1e-30)).item() for k in b[1]}
    num = sum(((a[1][k] - b[1][k]) ** 2).sum() for k in b[1])
    den = sum((b[1][k] ** 2).sum() for k in b[1])
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]), "grad_rel": (num / den).sqrt().item(),
            "grad_rel_by_tensor": rel,
            "state_max_abs": max((a[3][k] - b[3][k]).abs().max().item() for k in b[3]),
            "state_max_rel": max(((a[3][k] - b[3][k]).abs().max() /
                                  b[3][k].abs().max().clamp_min(1.0)).item() for k in b[3]),
            "param_max_abs": max((a[2][k] - b[2][k]).abs().max().item() for k in b[2]),
            "params_beyond_atol": sum(int(((a[2][k] - b[2][k]).abs() > RN_PARAM_ATOL).sum())
                                      for k in b[2])}


def resnet_step_check(C, x, y, seed):
    """One f32 step from identical weights through the kernels (K) and
    through their plain versions (P), held against the f32 noise of the
    step itself: the plain step on the same batch in another order (Q),
    which is the same step mathematically. A freshly initialised ResNet50
    is so ill-conditioned that Q differs from P by ~3% in its gradients and
    moves ~190k parameters by more than 1e-4 (Adam's first step is about
    lr·sign(g)), so a fixed parameter tolerance cannot hold. K must match P
    in loss (RN_LOSS_RTOL) and BN running state (RN_STATE_ATOL), and be no
    farther from P than the noise: gradients within RN_NOISE_FACTOR x Q's
    difference (all tensors together) and 2 x that per tensor (+1e-5), and
    no more parameters beyond RN_PARAM_ATOL than RN_NOISE_FACTOR x Q's."""
    k = graph_step(C, seed, x, y)
    p = graph_step(C, seed, x, y, plain=True)
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(seed)).cuda()
    q = graph_step(C, seed, x[perm], y[perm], plain=True)
    torch.cuda.empty_cache()
    return within_noise(k, p, q, "kernel", "plain")


def within_noise(k, p, q, k_name, p_name, state_rel=False):
    """Hold step ``k`` against step ``p`` within the noise of ``q`` (``p``'s
    step on the batch permuted), as ``resnet_step_check`` states."""
    return noise_check(k, p, step_diff(k, p), step_diff(q, p), k_name, p_name,
                       f"{p_name}_vs_{p_name}_permuted", state_rel=state_rel)


def noise_check(k, p, kp, qp, k_name, p_name, noise_name, per_tensor=True, state_rel=False,
                factor=RN_NOISE_FACTOR):
    """Hold ``kp`` (step_diff of step ``k`` from step ``p``) within ``factor``
    x the noise ``qp`` (a step_diff of the same kind); ``per_tensor=False``
    reports the worst tensor's gradient difference without holding it. The
    state is held to RN_STATE_ATOL absolutely, or with ``state_rel``
    relative to each tensor's largest magnitude (where that exceeds 1: BN
    statistics of activations far from unit scale)."""
    if not kp["loss_rel"] <= RN_LOSS_RTOL:
        raise AssertionError(f"{k_name} step loss {k[0]} vs {p_name} step loss {p[0]}")
    state_err = kp["state_max_rel" if state_rel else "state_max_abs"]
    if not state_err <= RN_STATE_ATOL:
        raise AssertionError(f"BN running state differs by {state_err}"
                             + (" relative" if state_rel else ""))
    if not kp["grad_rel"] <= factor * qp["grad_rel"]:
        raise AssertionError(f"gradients differ by {kp['grad_rel']} relative, beyond "
                             f"{factor} x the step's own noise {qp['grad_rel']}")
    worst = max(kp["grad_rel_by_tensor"],
                key=lambda n: kp["grad_rel_by_tensor"][n] / (qp["grad_rel_by_tensor"][n] + 1e-5))
    if per_tensor and not kp["grad_rel_by_tensor"][worst] <= 2 * factor * \
            qp["grad_rel_by_tensor"][worst] + 1e-5:
        raise AssertionError(f"gradient {worst} differs by {kp['grad_rel_by_tensor'][worst]}, "
                             f"beyond the noise {qp['grad_rel_by_tensor'][worst]}")
    if not kp["params_beyond_atol"] <= factor * qp["params_beyond_atol"]:
        raise AssertionError(f"{kp['params_beyond_atol']} updated parameters beyond "
                             f"{RN_PARAM_ATOL}, against {qp['params_beyond_atol']} from noise")
    summary = {k_: v for k_, v in kp.items() if k_ != "grad_rel_by_tensor"}
    noise = {k_: v for k_, v in qp.items() if k_ != "grad_rel_by_tensor"}
    return {f"loss_{k_name}": k[0], f"loss_{p_name}": p[0], f"{k_name}_vs_{p_name}": summary,
            noise_name: noise, "worst_tensor": worst,
            "worst_tensor_grad_rel": kp["grad_rel_by_tensor"][worst],
            "worst_tensor_noise": qp["grad_rel_by_tensor"][worst]}


def resnet_family(name):
    if "conv_stats_" in name:  # both kernels and the partials reduction
        return "conv_stats_kernels"
    if any(s in name for s in ("conv", "cudnn", "gemm", "cutlass", "xmma", "sm90", "wgrad",
                               "dgrad", "implicit")):
        return "library_conv_gemm"
    return "bn_elementwise_other"


def phase_resnet(C, policy, seed):
    """The full-width fused ResNet50 trained by ``ComputationGraph.fit``
    under the named policy: the f32 plain-version step check, warm-up,
    RN_TIMED_STEPS timed steps with the kernels' launches counted, one
    profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.utils import dtypes

    (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
    try:
        x, y = resnet_data(seed, RN_BATCH * (RN_WARMUP_STEPS + RN_TIMED_STEPS))
        check = resnet_step_check(C, x[:RN_BATCH], y[:RN_BATCH], seed) \
            if policy == "f32" else None
        net = make_resnet(seed)
        warm = RN_BATCH * RN_WARMUP_STEPS
        net.fit(x[:warm], y[:warm], batch_size=RN_BATCH)
        first_loss = net.score_history[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        C.reset_launches()
        t0 = time.perf_counter()
        net.fit(x[warm:], y[warm:], batch_size=RN_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(C.launches)
        by_variant = dict(C.launches_by_variant)
        peak = torch.cuda.max_memory_allocated()
        losses = net.score_history
        want = {"conv_mm_stats": 36 * RN_TIMED_STEPS, "conv3x3_stats": 16 * RN_TIMED_STEPS}
        if launches != want:
            raise AssertionError(f"conv kernels launched {launches} times in {RN_TIMED_STEPS} "
                                 f"steps (expected {want}: 36 + 16 a step)")
        hopper = "bf16_wgmma" if policy == "bf16" else "f32_pipelined"
        if by_variant != {**dict.fromkeys(C.VARIANTS, 0), hopper: sum(want.values())}:
            raise AssertionError(f"conv launches by variant {by_variant}: every one of the "
                                 f"path's launches should be {hopper}")
        if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
            raise AssertionError(f"loss did not fall: first {first_loss}, timed steps {losses}")
        row = {"policy": policy, "params": net.num_params(), "batch": RN_BATCH,
               "image": [RN_HW, RN_HW, 3], "steps": RN_TIMED_STEPS,
               "step_ms": 1e3 * wall / RN_TIMED_STEPS,
               "images_per_s": RN_BATCH * RN_TIMED_STEPS / wall, "peak_mem_gb": peak / 1e9,
               "loss_first": first_loss, "loss_last": losses[-1], "losses": losses,
               "conv_launches": launches, "conv_launches_by_variant": by_variant,
               "step_check": check, "card": card_line()}
        emit("resnet", **row)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit(x[:RN_BATCH], y[:RN_BATCH])
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_family, busy_ms, share = device_families(prof, wall_ms, resnet_family,
                                                    {"updater.step": "optimizer"})
        emit("resnet.profile", policy=policy, wall_ms=wall_ms,
             wall_unprofiled_ms=row["step_ms"], device_ms_by_family=by_family,
             device_busy_ms=busy_ms, device_busy_share=share, card=card_line())
        del net, x, y
        torch.cuda.empty_cache()
        return row
    finally:
        dtypes.f32_policy()


# ---------------------------------------------------------------------------
# zoo: the Inception graphs and the remat'd fused ResNet50
# ---------------------------------------------------------------------------

def zoo_family(name):
    """Device-kernel families of the Inception and remat steps (LRN's
    forward is tagged by its range, see ``tagged_ranges``)."""
    if "catarraybatchedcopy" in name or "cat_" in name:
        return "merge_concat"
    if "pool" in name:
        return "lrn_pooling"
    return resnet_family(name)


@contextlib.contextmanager
def tagged_ranges():
    """Within this block every LocalResponseNormalization forward runs in a
    ``record_function("lrn")`` range, so a profile counts its kernels (a
    pad, a windowed sum and a power) under ``lrn_pooling``; the layer is
    left as it was afterwards."""
    from deeplearning4j_tpu_torch.nn.layers import LocalResponseNormalization as LRN

    apply = LRN.apply

    def ranged(self, *a, **k):
        with torch.profiler.record_function("lrn"):
            return apply(self, *a, **k)

    LRN.apply = ranged
    try:
        yield
    finally:
        LRN.apply = apply


ZOO_TAGS = {"updater.step": "optimizer", "lrn": "lrn_pooling"}


def zoo_profile(net, x, y, name, policy, step_ms):
    """One fit step under torch.profiler: device time by family and busy share."""
    from torch.profiler import ProfilerActivity, profile

    with tagged_ranges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_family, busy_ms, share = device_families(prof, wall_ms, zoo_family, ZOO_TAGS)
    emit("zoo.profile", model=name, policy=policy, wall_ms=wall_ms, wall_unprofiled_ms=step_ms,
         device_ms_by_family=by_family, device_busy_ms=busy_ms, device_busy_share=share,
         device_busy_share_unprofiled=busy_ms / step_ms, card=card_line())


def zoo_train(net, x, y, batch, name, policy, extra=None, before_timed=None):
    """ZOO_WARMUP_STEPS warm-up steps, then the timed fit steps over the rest
    of (x, y) (``before_timed`` called just before them); the loss must fall
    (the mean of the last ZOO_LOSS_WINDOW timed steps below the first
    warm-up step's). Returns the row to print."""
    warm = batch * ZOO_WARMUP_STEPS
    net.fit(x[:warm], y[:warm], batch_size=batch)
    first_loss = net.score_history[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if before_timed is not None:
        before_timed()
    t0 = time.perf_counter()
    net.fit(x[warm:], y[warm:], batch_size=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = net.score_history
    tail = float(np.mean(losses[-ZOO_LOSS_WINDOW:]))
    if not all(np.isfinite(losses)) or not tail < first_loss:
        raise AssertionError(f"{name}: loss did not fall: first {first_loss}, timed steps {losses}")
    steps = len(losses)
    row = {"model": name, "policy": policy, "params": net.num_params(), "batch": batch,
           "image": list(x.shape[1:]), "steps": steps, "step_ms": 1e3 * wall / steps,
           "images_per_s": batch * steps / wall, "peak_mem_gb": peak / 1e9,
           "loss_first": first_loss, f"loss_mean_last{ZOO_LOSS_WINDOW}": tail, "losses": losses,
           **(extra or {}), "card": card_line()}
    return row


def irv1_step(net, x, y):
    """The first step of ``fit`` from ``net``'s weights: (loss, {path:
    gradient}, {path: parameter after RmsProp's first step}, {path: state:
    BN statistics and centers})."""
    return first_step(net, {"input": x}, {"lossLayer": y})


def irv1_step_check(seed, x, y):
    """Inception-ResNet v1 at full width: one f32 step on the card (K) and
    the same step on the CPU from identical weights in float64 (R, the
    truth). K must be no farther from R than RN_NOISE_FACTOR x the f32
    step's own noise in loss (RN_LOSS_RTOL), gradients (all tensors
    together), state (BN statistics and the centers, RN_STATE_ATOL) and
    parameters beyond RN_PARAM_ATOL after RmsProp's first step. The noise
    is the largest, measure by measure, of three f32 samples: the step in
    f32 on the CPU (P) and on the batch permuted (P') against R, and K's
    step on the batch permuted (Q) against K. Q alone cannot be it: a conv
    computes each image's outputs in the same order whatever the batch
    order, so Q repeats K's per-element rounding (on an H100, Q was 2.8e-6
    from K in a BN beta gradient that K and R put 0.6% apart).
    The worst single tensor is reported, not held: two f32 runs on the CPU
    put single tensors 0.0003x to 5.6x as far from float64 as each other
    (Inception-ResNet v1 at 96², batch 8), where the total moves 0.75x to
    1.2x."""
    from deeplearning4j_tpu_torch.models import get_model
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.utils import serialization

    def card_net():
        return get_model("inceptionresnetv1").build(device="cuda", seed=seed)

    net = card_net()
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(seed)).cuda()
    cpu_steps, cpu_s = {}, {}
    for name, dt, order in (("f64", torch.float64, None), ("f32", torch.float32, None),
                            ("f32_permuted", torch.float32, perm)):
        ref = ComputationGraph(get_model("inceptionresnetv1").builder(seed=seed), device="cpu")
        ref.init(dtype=dt)
        serialization.params_from_numpy(
            ref, {k: {n: t.detach().cpu().to(dt) for n, t in d.items()}
                  for k, d in net.params.items()},
            state={k: {n: t.cpu().to(dt) for n, t in d.items()} for k, d in net.state.items()})
        xs, ys = (x, y) if order is None else (x[order], y[order])
        t0 = time.perf_counter()
        step = irv1_step(ref, xs.cpu().to(dt), ys.cpu().to(dt))
        cpu_s[name] = time.perf_counter() - t0
        cpu_steps[name] = (step[0],) + tuple({k: v.float().cuda() for k, v in d.items()}
                                             for d in step[1:])
        del ref
    r = cpu_steps["f64"]
    k = irv1_step(net, x, y)
    q = irv1_step(card_net(), x[perm], y[perm])
    kr, qk = step_diff(k, r), step_diff(q, k)
    samples = {"cpu_f32_vs_cpu_f64": step_diff(cpu_steps["f32"], r),
               "cpu_f32_permuted_vs_cpu_f64": step_diff(cpu_steps["f32_permuted"], r),
               "card_f32_permuted_vs_card_f32": qk}
    noise = {m: (max(d[m] for d in samples.values()) if m != "grad_rel_by_tensor" else
                 {t: max(d[m][t] for d in samples.values()) for t in kr[m]}) for m in kr}
    emit("zoo.irv1_step_diffs", card_f32_vs_cpu_f64={m: v for m, v in kr.items()
                                                     if m != "grad_rel_by_tensor"},
         **{n: {m: v for m, v in d.items() if m != "grad_rel_by_tensor"}
            for n, d in samples.items()}, cpu_step_s=cpu_s)
    out = noise_check(k, r, kr, noise, "card_f32", "cpu_f64", "f32_noise", per_tensor=False)
    out["centers_max_abs_change"] = k[3]["['lossLayer']['centers']"].abs().max().item()
    out["cpu_step_s"] = cpu_s
    del net
    torch.cuda.empty_cache()
    return out


def conv_launches_planned(net):
    """The conv kernel launches of one remat step from the segments: a
    fused vertex inside a group launches twice (forward and recompute), a
    single once."""
    from deeplearning4j_tpu_torch.nn.fusion import FusedConvBNVertex

    want = {"conv_mm_stats": 0, "conv3x3_stats": 0}
    for seg in net._segments:
        names, times = (seg[1], 2) if seg[0] == "group" else ((seg[1],), 1)
        for n in names:
            v = net._defs[n].vertex
            if isinstance(v, FusedConvBNVertex):
                want["conv_mm_stats" if tuple(v.kernel) == (1, 1) else "conv3x3_stats"] += times
    return want


def remat_resnet(C, policy, seed):
    """The fused ResNet50 with ``checkpoint_scope="prefix"``: its first step
    against the plain step from the same weights (within the plain step's
    own noise, under this policy), peak memory of one step with and without
    remat, the timed steps with their conv launches against the count from
    the segments, every launch on the planned variant."""
    x, y = resnet_data(seed, RN_BATCH * (ZOO_WARMUP_STEPS + ZOO_TIMED_STEPS))
    xb, yb = x[:RN_BATCH], y[:RN_BATCH]
    perm = torch.randperm(RN_BATCH, generator=torch.Generator().manual_seed(seed)).cuda()
    check = within_noise(graph_step(C, seed, xb, yb, scope="prefix"),
                         graph_step(C, seed, xb, yb), graph_step(C, seed, xb[perm], yb[perm]),
                         "remat", "plain")
    peaks = {}
    for scope in (None, "prefix"):
        net = make_resnet(seed, scope)
        net.fit(xb, yb)  # updater state made, first-step allocations done
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        net.fit(xb, yb)
        torch.cuda.synchronize()
        peaks["remat" if scope else "plain"] = torch.cuda.max_memory_allocated() / 1e9
        del net
        torch.cuda.empty_cache()
    if not peaks["remat"] < peaks["plain"]:
        raise AssertionError(f"remat step peak {peaks['remat']} GB is not below the plain "
                             f"step's {peaks['plain']} GB")
    net = make_resnet(seed, "prefix")
    planned = conv_launches_planned(net)
    row = zoo_train(net, x, y, RN_BATCH, "resnet50_fused_remat", policy,
                    before_timed=C.reset_launches)
    launches, by_variant = dict(C.launches), dict(C.launches_by_variant)
    want = {k: v * ZOO_TIMED_STEPS for k, v in planned.items()}
    if launches != want:
        raise AssertionError(f"remat conv launches {launches} in {ZOO_TIMED_STEPS} steps, "
                             f"expected {want} from the segments ({planned} a step)")
    hopper = "bf16_wgmma" if policy == "bf16" else "f32_pipelined"
    if by_variant != {**dict.fromkeys(C.VARIANTS, 0), hopper: sum(want.values())}:
        raise AssertionError(f"remat conv launches by variant {by_variant}: every one should "
                             f"be {hopper}")
    row.update(conv_launches=launches, conv_launches_planned_a_step=planned,
               conv_launches_by_variant=by_variant, peak_step_gb=peaks, step_check=check)
    emit("zoo.remat", **row)
    zoo_profile(net, xb, yb, "resnet50_fused_remat", policy, row["step_ms"])
    del net, x, y
    torch.cuda.empty_cache()
    return row


def phase_zoo(C, seed):
    """Inception-ResNet v1 (FaceNet head) and GoogLeNet from the zoo
    registry at full width, the remat'd fused ResNet50, and checkpoints
    saved on the card and loaded on the CPU."""
    from deeplearning4j_tpu_torch.models import get_model, resnet50_mln
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import dtypes, serialization

    rows = {}
    n = IR_BATCH * (ZOO_WARMUP_STEPS + ZOO_TIMED_STEPS)
    x, y = resnet_data(seed, n, IR_HW, IR_CLASSES)
    for policy in ("f32", "bf16"):
        (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
        try:
            net = get_model("inceptionresnetv1").build(device="cuda", seed=seed)
            if net.num_params() != IR_PARAMS:
                raise AssertionError(f"inception_resnet_v1 has {net.num_params()} params, "
                                     f"expected {IR_PARAMS}")
            centers0 = net.state["lossLayer"]["centers"].clone()
            row = zoo_train(net, x, y, IR_BATCH, "inception_resnet_v1", policy)
            change = (net.state["lossLayer"]["centers"] - centers0).abs()
            if not (torch.isfinite(change).all() and change.max() > 0):
                raise AssertionError(f"the centers did not move: max change {change.max()}")
            emb = net.feed_forward(x[:IR_BATCH])["embeddings"].float().norm(dim=1)
            norm_err = (emb - 1).abs().max().item()
            if policy == "f32" and not norm_err <= 1e-5:
                raise AssertionError(f"embedding norms off 1 by {norm_err}")
            row.update(centers_max_abs_change=change.max().item(), embedding_norm_err=norm_err)
            emit("zoo.irv1", **row)
            rows[("irv1", policy)] = row
            zoo_profile(net, x[:IR_BATCH], y[:IR_BATCH], "inception_resnet_v1", policy,
                        row["step_ms"])
            if policy == "f32":
                ckpt = WORK / "irv1.zip"
                # the outputs are compared: the updater state's round trip
                # (the fused phase's resume, the bundles) is not repeated
                serialization.save_model(net, ckpt, save_updater=False)
                back = serialization.load_model(ckpt, device="cpu")
                xs = x[:4]
                with dtypes.policy_precision():
                    diff = (back.output(xs.cpu()) - net.output(xs).cpu()).abs().max().item()
                if not diff <= ZOO_CKPT_ATOL:
                    raise AssertionError(f"Inception-ResNet v1 on the CPU differs by {diff}")
                emit("zoo.checkpoint", model="inception_resnet_v1", batch=4, max_abs_diff=diff,
                     zip_mb=ckpt.stat().st_size / 1e6)
            del net
            torch.cuda.empty_cache()
        finally:
            dtypes.f32_policy()
    rows["irv1_step_check"] = irv1_step_check(seed, x[:ZOO_CHECK_BATCH], y[:ZOO_CHECK_BATCH])
    emit("zoo.irv1_step_check", **rows["irv1_step_check"], card=card_line())
    del x, y

    gn_seed = seed + GN_SEED_OFFSET
    x, y = resnet_data(gn_seed, GN_BATCH * (ZOO_WARMUP_STEPS + ZOO_TIMED_STEPS), GN_HW,
                       GN_CLASSES)
    net = get_model("googlenet").build(device="cuda", seed=gn_seed)
    if net.num_params() != GN_PARAMS:
        raise AssertionError(f"googlenet has {net.num_params()} params, expected {GN_PARAMS}")
    fc1 = net.conf.vertices[[v.name for v in net.conf.vertices].index("fc1")].vertex.layer
    row = zoo_train(net, x, y, GN_BATCH, "googlenet", "f32", {"fc1_dropout": fc1.dropout})
    a, b = net.output(x[:GN_BATCH]), net.output(x[:GN_BATCH])
    if not torch.equal(a, b):
        raise AssertionError("googlenet output differs between two eval-mode calls")
    row_sum_err = (a.sum(dim=1) - 1).abs().max().item()
    if not row_sum_err <= 1e-5:
        raise AssertionError(f"googlenet softmax rows sum to 1 +- {row_sum_err}")
    row["eval_row_sum_err"] = row_sum_err
    emit("zoo.googlenet", **row)
    rows[("googlenet", "f32")] = row
    zoo_profile(net, x[:GN_BATCH], y[:GN_BATCH], "googlenet", "f32", row["step_ms"])
    del net, x, y
    torch.cuda.empty_cache()

    for policy in ("f32", "bf16"):
        (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
        try:
            rows[("remat", policy)] = remat_resnet(C, policy, seed)
        finally:
            dtypes.f32_policy()

    mln = MultiLayerNetwork(resnet50_mln(), device="cuda")
    mln.init(torch.Generator().manual_seed(seed))
    xm, ym = resnet_data(seed, 2)
    mln.fit(xm, ym)
    ckpt = WORK / "resnet50_mln.zip"
    serialization.save_model(mln, ckpt, save_updater=False)
    back = serialization.load_model(ckpt, device="cpu")
    with dtypes.policy_precision():
        diff = (back.output(xm.cpu()) - mln.output(xm).cpu()).abs().max().item()
        # the pooled features too: after one step the eval-mode softmax may
        # saturate, where the output alone would hide a state mismatch
        last = len(mln.conf.layers) - 1
        feats = mln.apply_fn(mln.params, mln.state, xm, layer_limit=last)[0].cpu()
        feats_back = back.apply_fn(back.params, back.state, xm.cpu(), layer_limit=last)[0]
    feat_rel = ((feats_back - feats).abs().max() / feats.abs().max()).item()
    if not (diff <= ZOO_CKPT_ATOL and feat_rel <= ZOO_CKPT_ATOL):
        raise AssertionError(f"resnet50_mln restored on the CPU differs by {diff} (output), "
                             f"{feat_rel} relative (pooled features)")
    emit("zoo.checkpoint", model="resnet50_mln", batch=2, max_abs_diff=diff,
         features_max_rel_diff=feat_rel, state_tensors=sum(len(s) for s in back.state),
         zip_mb=ckpt.stat().st_size / 1e6)
    del mln
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# finetune: transfer learning of the fused ResNet50, evaluation, early
# stopping, graph serving, Tiny YOLO and the other conv layers
# ---------------------------------------------------------------------------

def ft_build(source, seed):
    """The fine-tuned graph: ``source``'s fused ResNet50 frozen up to and
    including FT_EXTRACTOR, a fresh FT_CLASSES-way head, Adam 1e-3."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.transfer import FineTuneConfiguration, TransferLearningGraph

    net = (TransferLearningGraph(source)
           .fine_tune_configuration(FineTuneConfiguration(updater=U.Adam(1e-3), seed=seed))
           .set_feature_extractor(FT_EXTRACTOR)
           .replace_layer("fc", L.OutputLayer(n_out=FT_CLASSES, loss="mcxent")).build())
    trainable = sum(p.numel() for n, d in net.params.items() if n not in net.frozen_vertices
                    for p in d.values())
    got = (net.num_params(), trainable, len(net.frozen_vertices))
    if got != (FT_PARAMS, FT_TRAINABLE, FT_FROZEN):
        raise AssertionError(f"fine-tuned graph: (params, trainable, frozen vertices) {got}, "
                             f"expected {(FT_PARAMS, FT_TRAINABLE, FT_FROZEN)}")
    return net


def first_step(net, x, y):
    """The first step of ``fit`` from ``net``'s weights, the updater from
    its initial state: (loss, {path: gradient}, {path: parameter},
    {path: state})."""
    from deeplearning4j_tpu_torch.utils import dtypes
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    with dtypes.policy_precision():
        loss, state, grads = net.compute_gradients(net.params, net.state, x, y)
    net.opt_state = net.conf.updater.init(net.params)
    net.apply_update(net.params, net.opt_state, grads, 0)
    return (float(loss), flatten_tree(grads),
            {k: v.detach() for k, v in flatten_tree(net.params).items()}, flatten_tree(state))


@contextlib.contextmanager
def exact_conv_kernels(C):
    """Within this block the fused op computes z with the kernels' plain
    versions in float64, rounded once to the input's dtype, and its
    statistics from that z in f32, as the kernels sum them: the f32 step
    whose convolutions are exactly rounded. (Statistics in float64 would
    also remove the f32 cancellation of E[z^2] - mean^2 that every f32
    path shares, which no f32 step can match.)"""
    saved = C.conv_mm_stats, C.conv3x3_stats

    def exact(plain):
        def run(x, w, stride=(1, 1)):
            z = plain(x.double(), w.double(), stride)[0].to(x.dtype)
            zf = z.reshape(-1, z.shape[-1]).float()
            return z, torch.stack((zf.sum(0), (zf * zf).sum(0)))
        return run

    C.conv_mm_stats, C.conv3x3_stats = exact(C.conv_mm_stats_plain), exact(C.conv3x3_stats_plain)
    try:
        yield
    finally:
        C.conv_mm_stats, C.conv3x3_stats = saved


@contextlib.contextmanager
def cpu_conv_kernels(C):
    """Within this block the fused op computes z and its statistics with the
    kernels' plain versions on the CPU in f32 (another f32 implementation:
    the CPU's library sums in its own order), the results back on the
    card."""
    saved = C.conv_mm_stats, C.conv3x3_stats

    def on_cpu(plain):
        def run(x, w, stride=(1, 1)):
            z, stats = plain(x.cpu(), w.cpu(), stride)
            return z.to(x.device), stats.to(x.device)
        return run

    C.conv_mm_stats, C.conv3x3_stats = on_cpu(C.conv_mm_stats_plain), on_cpu(C.conv3x3_stats_plain)
    try:
        yield
    finally:
        C.conv_mm_stats, C.conv3x3_stats = saved


def ft_step(C, source, seed, x, y, conv="kernel"):
    """The first fine-tune step from ``source``; ``conv`` "plain" runs the
    fused vertices on the conv kernels' plain versions, "exact" on them in
    float64 (``exact_conv_kernels``), "cpu" on them on the CPU
    (``cpu_conv_kernels``); none of these launches a kernel."""
    net = ft_build(source, seed)
    launched = dict(C.launches)
    ctx = {"kernel": contextlib.nullcontext, "plain": plain_conv_kernels,
           "exact": exact_conv_kernels, "cpu": cpu_conv_kernels}[conv]
    with ctx() if conv == "kernel" else ctx(C):
        out = first_step(net, x, y)
    if conv != "kernel" and C.launches != launched:
        raise AssertionError(f"the {conv} fine-tune step launched a conv kernel")
    del net
    return out


def frozen_unchanged(net, source):
    """Whether every frozen vertex's parameters and state equal the
    source's bit for bit."""
    return all(torch.equal(net.params[n][k], source.params[n][k]) for n in net.frozen_vertices
               for k in source.params[n]) and \
        all(torch.equal(net.state[n][k], source.state[n][k]) for n in net.frozen_vertices
            for k in source.state[n])


def ft_fit_timed(C, net, x, y, listeners, hopper):
    """The timed fine-tune steps over (x, y) with ``listeners`` attached:
    (step ms, losses, conv launches, launches by variant), the launches
    held to FT_CONV_A_STEP a step, all on ``hopper``."""
    net.listeners = list(listeners)
    torch.cuda.synchronize()
    C.reset_launches()
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=RN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = x.shape[0] // RN_BATCH
    launches, by_variant = dict(C.launches), dict(C.launches_by_variant)
    want = {k: v * steps for k, v in FT_CONV_A_STEP.items()}
    if launches != want:
        raise AssertionError(f"fine-tune conv launches {launches} in {steps} steps, expected "
                             f"{want}: the frozen vertices must launch none")
    if by_variant != {**dict.fromkeys(C.VARIANTS, 0), hopper: sum(want.values())}:
        raise AssertionError(f"fine-tune conv launches by variant {by_variant}: every one "
                             f"should be {hopper}")
    net.listeners = []
    return 1e3 * wall / steps, list(net.score_history), launches, by_variant


def finetune_train(C, source, seed, policy, x, y):
    """The fine-tune step check (f32), warm-up, then the timed steps
    without and with three listeners, interleaved (plain, listeners, plain,
    listeners, plain): the listener runs' median must stay within the
    plain runs' spread plus FT_LISTENER_ALLOWANCE of their median (a
    single run of ten steps can catch a host hiccup of 15%)."""
    from deeplearning4j_tpu_torch.nn import listeners as LS

    b = RN_BATCH
    check = None
    if policy == "f32":
        # the kernel step (K) against the step whose stage-3 convs are
        # exactly rounded (E), within FT_NOISE_FACTOR x the f32 noise: the
        # largest distance from E of three other f32 implementations, the
        # plain versions on the card (P), on the batch permuted (Q) and on
        # the CPU (R), as the zoo phase holds Inception-ResNet v1 against
        # float64. A permutation alone is too small a noise here: it leaves
        # each image's conv sums as they were, where K's and P's differ in
        # every element. Single tensors are reported, not held
        k = ft_step(C, source, seed, x[:b], y[:b])
        p = ft_step(C, source, seed, x[:b], y[:b], conv="plain")
        e = ft_step(C, source, seed, x[:b], y[:b], conv="exact")
        perm = torch.randperm(b, generator=torch.Generator().manual_seed(seed)).cuda()
        q = ft_step(C, source, seed, x[:b][perm], y[:b][perm], conv="plain")
        r = ft_step(C, source, seed, x[:b], y[:b], conv="cpu")
        ke = step_diff(k, e)
        samples = {"plain_vs_exact": step_diff(p, e), "plain_permuted_vs_exact": step_diff(q, e),
                   "plain_cpu_vs_exact": step_diff(r, e)}
        noise = {m: (max(d[m] for d in samples.values()) if m != "grad_rel_by_tensor" else
                     {t: max(d[m][t] for d in samples.values()) for t in ke[m]}) for m in ke}
        check = noise_check(k, e, ke, noise, "kernel", "exact", "f32_noise", per_tensor=False,
                            state_rel=True, factor=FT_NOISE_FACTOR)
        check["kernel_vs_plain"] = {m: v for m, v in step_diff(k, p).items()
                                    if m != "grad_rel_by_tensor"}
        check.update({n: {m: v for m, v in d.items() if m != "grad_rel_by_tensor"}
                      for n, d in samples.items()})
        del k, p, e, q, r
        torch.cuda.empty_cache()
    net = ft_build(source, seed)
    warm = b * ZOO_WARMUP_STEPS
    net.fit(x[:warm], y[:warm], batch_size=b)
    first_loss = net.score_history[0]
    hopper = "bf16_wgmma" if policy == "bf16" else "f32_pipelined"
    lines = []
    runs = {"plain": [], "listeners": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kind in ("plain", "listeners", "plain", "listeners", "plain"):
        ls = [LS.ScoreIterationListener(5, print_fn=lines.append),
              LS.PerformanceListener(5, print_fn=lines.append),
              LS.CollectScoresListener()] if kind == "listeners" else []
        step_ms, losses, launches, by_variant = ft_fit_timed(C, net, x[warm:], y[warm:], ls,
                                                             hopper)
        runs[kind].append(step_ms)
        if kind == "listeners" and ls[2].scores != losses:
            raise AssertionError("CollectScoresListener's scores are not fit's losses")
        if kind == "listeners":
            perf = ls[1].records
    peak = torch.cuda.max_memory_allocated()
    plain = runs["plain"]
    limit = max(plain) + (max(plain) - min(plain)) + FT_LISTENER_ALLOWANCE * statistics.median(plain)
    if not statistics.median(runs["listeners"]) <= limit:
        raise AssertionError(f"listeners moved the step to {runs['listeners']} ms against "
                             f"{plain} ms without them (limit {limit})")
    tail = float(np.mean(losses[-ZOO_LOSS_WINDOW:]))
    if not all(np.isfinite(losses)) or not tail < first_loss:
        raise AssertionError(f"fine-tune loss did not fall: first {first_loss}, last {losses}")
    if not frozen_unchanged(net, source):
        raise AssertionError("a frozen vertex's parameters or state moved")
    steps = x.shape[0] // b - ZOO_WARMUP_STEPS
    row = {"policy": policy, "params": net.num_params(), "trainable": FT_TRAINABLE,
           "frozen_vertices": len(net.frozen_vertices), "batch": b, "steps": steps,
           "step_ms": statistics.median(plain), "step_ms_runs": plain,
           "step_ms_listeners": runs["listeners"], "listener_limit_ms": limit,
           "images_per_s": 1e3 * b / statistics.median(plain), "peak_mem_gb": peak / 1e9,
           "loss_first": first_loss, f"loss_mean_last{ZOO_LOSS_WINDOW}": tail,
           "losses_last_run": losses, "conv_launches": launches,
           "conv_launches_by_variant": by_variant, "frozen_unchanged": True,
           "performance_listener_median_iter_ms": 1e3 * statistics.median(
               r["iter_time_s"] for r in perf),
           "performance_listener_device_mb": perf[-1].get("device_mb_in_use"),
           "listener_lines": len(lines),
           "step_check": check, "card": card_line()}
    emit("finetune.train", **row)
    return row, net


def finetune_eval(net, xe, ye, policy):
    """``evaluate`` and ``evaluate_roc`` over the held-out images, an
    EvaluationCalibration, and the confusion matrix against the argmax
    counts of ``output`` on the same rows."""
    from deeplearning4j_tpu_torch.eval import Evaluation, EvaluationCalibration

    b = RN_BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = net.evaluate(xe, ye, batch_size=b)
    eval_s = time.perf_counter() - t0
    roc = net.evaluate_roc(xe, ye, batch_size=b)
    cal, again = EvaluationCalibration(), Evaluation()
    counts = np.zeros((FT_CLASSES, FT_CLASSES), np.int64)
    host_s = 0.0
    for i in range(0, xe.shape[0], b):
        out = net.output(xe[i:i + b])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        again.eval(ye[i:i + b], out)
        host_s += time.perf_counter() - t1
        cal.eval(ye[i:i + b], out)
        np.add.at(counts, (ye[i:i + b].argmax(-1).cpu().numpy(), out.argmax(-1).cpu().numpy()), 1)
    if not np.array_equal(counts, ev.confusion.matrix):
        raise AssertionError(f"evaluate's confusion matrix {ev.confusion.matrix.tolist()} is "
                             f"not output()'s argmax counts {counts.tolist()}")
    acc = ev.accuracy()
    if not acc >= FT_MIN_ACCURACY:
        raise AssertionError(f"held-out accuracy {acc} below {FT_MIN_ACCURACY} (chance is "
                             f"{1 / FT_CLASSES})")
    row = {"policy": policy, "images": xe.shape[0], "accuracy": acc, "f1": ev.f1(),
           "min_accuracy": FT_MIN_ACCURACY, "auc": roc.average_auc(),
           "ece": cal.expected_calibration_error(), "confusion": counts.tolist(),
           "evaluate_s": eval_s, "eval_host_ms_per_batch": 1e3 * host_s / (xe.shape[0] // b),
           "card": card_line()}
    emit("finetune.eval", **row)
    return row


def finetune_early_stopping(net, x, y, xe, ye):
    """EarlyStoppingTrainer over FT_ES_EPOCHS epochs of the fine-tune data,
    scored by the held-out loss; the restored best model must score the
    recorded best."""
    from deeplearning4j_tpu_torch.nn import earlystopping as ES

    cfg = ES.EarlyStoppingConfiguration(
        score_calculator=ES.DataSetLossCalculator(xe, ye),
        epoch_terminations=(ES.MaxEpochsTermination(FT_ES_EPOCHS),
                            ES.ScoreImprovementEpochsTermination(1)),
        saver=ES.InMemoryModelSaver())
    t0 = time.perf_counter()
    res = ES.EarlyStoppingTrainer(cfg, net, x, y, batch_size=RN_BATCH).fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    restored = res.best_model.score(xe, ye)
    if restored != res.best_score:
        raise AssertionError(f"the restored best model scores {restored}, the recorded best "
                             f"is {res.best_score}")
    row = {"termination": res.termination_details, "epochs": res.total_epochs,
           "best_epoch": res.best_epoch, "best_score": res.best_score,
           "score_vs_epoch": res.score_vs_epoch, "restored_score": restored, "wall_s": wall,
           "card": card_line()}
    emit("finetune.early_stopping", **row)
    return row


def finetune_serve(net, xe, ye, seed):
    """The fine-tuned graph from its checkpoint through the registry: a
    burst of FT_SERVE_REQUESTS requests of 1 to FT_SERVE_MAX_ROWS held-out
    images (one in four batched, every other one in the dict form), every
    result against ``output()`` on the same rows in batches of RN_BATCH,
    then the ``serve`` and ``eval`` verbs on the checkpoint."""
    import threading

    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint
    from deeplearning4j_tpu_torch.serving import get_model_registry
    from deeplearning4j_tpu_torch.utils import dtypes, serialization

    zip_path = WORK / "finetuned.zip"
    serialization.save_model(net, zip_path, save_updater=False)
    served = restore_checkpoint(zip_path, device="cuda")
    images = xe.cpu().numpy()
    with dtypes.policy_precision():
        ref = torch.cat([served.output(xe[i:i + RN_BATCH])
                         for i in range(0, xe.shape[0], RN_BATCH)]).cpu().numpy()
        # the same rows one at a time: cuDNN may take another algorithm at
        # another batch size, which bounds what a served row can differ by
        single = np.concatenate([served.output(xe[i:i + 1]).cpu().numpy() for i in range(16)])
    spread = float(np.abs(single - ref[:16]).max())
    if not 2 * spread <= FT_SERVE_ATOL:
        raise AssertionError(f"outputs differ by {spread} between batch sizes 1 and "
                             f"{RN_BATCH}: FT_SERVE_ATOL {FT_SERVE_ATOL} is too tight")
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(FT_SERVE_REQUESTS):
        batched = i % 4 == 0
        idx = rs.randint(0, images.shape[0], size=int(rs.randint(1, FT_SERVE_MAX_ROWS + 1))
                         if batched else 1)
        x = images[idx] if batched else images[idx[0]]
        reqs.append((idx, batched, {"input": x} if i % 2 == 0 else x))
    registry = get_model_registry()
    t_reg = time.perf_counter()
    engine = registry.register("finetuned", served, input_spec=(RN_HW, RN_HW, 3),
                               buckets=FT_SERVE_BUCKETS, max_queue=FT_SERVE_REQUESTS *
                               FT_SERVE_MAX_ROWS, device="cuda")
    register_s = time.perf_counter() - t_reg
    t0 = time.perf_counter()
    try:
        futs = [engine.submit(x, batched=batched) for _, batched, x in reqs]
        outs = [f.get(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        registry.stop()
    max_err, rows = 0.0, 0
    for (idx, batched, _), out in zip(reqs, outs):
        y = out["fc"]
        want = ref[idx] if batched else ref[idx[0]]
        if y.shape != want.shape or not np.isfinite(y).all():
            raise AssertionError(f"served output {y.shape} for {want.shape}")
        err = float(np.abs(y - want).max())
        max_err = max(max_err, err)
        if err > FT_SERVE_ATOL:
            raise AssertionError(f"a served result differs from output() by {err}")
        rows += len(idx)
    lats = [f.latency_s for f in futs]
    row = {"requests": len(reqs), "images": rows, "dict_requests": len(reqs) // 2,
           "batched_requests": sum(b for _, b, _ in reqs), "buckets": list(FT_SERVE_BUCKETS),
           "device_forwards": stats["forward"]["forwards"] - stats["forward"]["warmed"],
           "register_s": register_s, "wall_s": wall, "images_per_s": rows / wall,
           "p50_ms": 1e3 * float(np.percentile(lats, 50)),
           "p99_ms": 1e3 * float(np.percentile(lats, 99)), "max_abs_err": max_err,
           "atol": FT_SERVE_ATOL, "batch_size_spread": spread, "card": card_line()}
    emit("finetune.serve", **row)

    np.save(WORK / "x.npy", images[:RN_BATCH])
    np.save(WORK / "y.npy", ye[:RN_BATCH].cpu().numpy())
    # the two verbs' processes run side by side, while the phase goes on:
    # each pays its own start; the phase collects them at its end
    t1 = time.perf_counter()
    procs = {verb: subprocess.Popen([sys.executable, "-m", "deeplearning4j_tpu_torch", verb,
                                     "--model-path", str(zip_path), *args],
                                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for verb, args in (("serve", ["--smoke", "8"]),
                                ("eval", ["--data", str(WORK / "x.npy"), "--labels",
                                          str(WORK / "y.npy"), "--batch-size", "32"]))}
    outs = {}
    readers = [threading.Thread(target=lambda v=v, p=p: outs.__setitem__(v, p.communicate()),
                                daemon=True) for v, p in procs.items()]
    for r in readers:
        r.start()

    def collect():
        for r in readers:
            r.join(600)
        for verb, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
            out, err = outs.get(verb, ("", "no output: the process outlived 600 s"))
            if proc.returncode != 0:
                raise AssertionError(f"{verb} CLI exited {proc.returncode}:\n{out}\n{err}")
            emit("finetune.cli", verb=verb, rc=proc.returncode,
                 seconds_to_collected=time.perf_counter() - t1, concurrent=True,
                 last_line=out.strip().splitlines()[-1])

    row["collect_cli"] = collect
    return row


def yolo_data(seed, n, hw=YOLO_HW, classes=YOLO_CLASSES):
    """n synthetic images on the card, 1 to 4 boxes each painted in its
    class's colour over dim noise, and their YOLO labels [n, g, g, 5 +
    classes] (g = hw / 32): the box centre's cell holds the indicator, the
    centre's offset in the cell, the width and height in grid units and the
    one-hot class."""
    rs = np.random.RandomState(seed)
    g = hw // 32
    colors = torch.from_numpy(rs.rand(classes, 3).astype(np.float32)).cuda()
    x = 0.2 * torch.rand(n, hw, hw, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed))
    y = np.zeros((n, g, g, 5 + classes), np.float32)
    for i in range(n):
        for _ in range(rs.randint(1, 5)):
            c = rs.randint(classes)
            w, h = rs.uniform(1.0, min(5.0, g), size=2)
            cx, cy = rs.uniform(w / 2, g - w / 2), rs.uniform(h / 2, g - h / 2)
            row, col = int(cy), int(cx)
            y[i, row, col] = 0.0
            y[i, row, col, :5] = (1.0, cx - col, cy - row, w, h)
            y[i, row, col, 5 + c] = 1.0
            x[i, int(32 * (cy - h / 2)):int(32 * (cy + h / 2)),
              int(32 * (cx - w / 2)):int(32 * (cx + w / 2))] = colors[c]
    return x, torch.from_numpy(y).cuda()


def yolo_step_check(seed):
    """Tiny YOLO at YOLO_CHECK_HW (full width, batch YOLO_CHECK_BATCH): one
    f32 step on the card against the same step in float64 on the CPU, held
    as ``irv1_step_check`` holds Inception-ResNet v1's."""
    from deeplearning4j_tpu_torch.models import tiny_yolo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import serialization

    x, y = yolo_data(seed + 1, YOLO_CHECK_BATCH, hw=YOLO_CHECK_HW)

    def card_net():
        net = MultiLayerNetwork(tiny_yolo(YOLO_CHECK_HW, YOLO_CHECK_HW, seed=seed), device="cuda")
        net.init(torch.Generator().manual_seed(seed))
        return net

    net = card_net()
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(seed)).cuda()
    cpu_steps, cpu_s = {}, {}
    for name, dt, order in (("f64", torch.float64, None), ("f32", torch.float32, None),
                            ("f32_permuted", torch.float32, perm)):
        ref = MultiLayerNetwork(tiny_yolo(YOLO_CHECK_HW, YOLO_CHECK_HW, seed=seed), device="cpu")
        ref.init(dtype=dt)
        serialization.params_from_numpy(
            ref, [{k: t.detach().cpu().to(dt) for k, t in p.items()} for p in net.params],
            state=[{k: t.cpu().to(dt) for k, t in s.items()} for s in net.state])
        xs, ys = (x, y) if order is None else (x[order], y[order])
        t0 = time.perf_counter()
        step = first_step(ref, xs.cpu().to(dt), ys.cpu().to(dt))
        cpu_s[name] = time.perf_counter() - t0
        cpu_steps[name] = (step[0],) + tuple({k: v.float().cuda() for k, v in d.items()}
                                             for d in step[1:])
        del ref
    r = cpu_steps["f64"]
    k = first_step(net, x, y)
    q = first_step(card_net(), x[perm], y[perm])
    kr = step_diff(k, r)
    samples = {"cpu_f32_vs_cpu_f64": step_diff(cpu_steps["f32"], r),
               "cpu_f32_permuted_vs_cpu_f64": step_diff(cpu_steps["f32_permuted"], r),
               "card_f32_permuted_vs_card_f32": step_diff(q, k)}
    noise = {m: (max(d[m] for d in samples.values()) if m != "grad_rel_by_tensor" else
                 {t: max(d[m][t] for d in samples.values()) for t in kr[m]}) for m in kr}
    out = noise_check(k, r, kr, noise, "card_f32", "cpu_f64", "f32_noise", per_tensor=False,
                      state_rel=True)
    out.update(image=[YOLO_CHECK_HW, YOLO_CHECK_HW, 3], batch=YOLO_CHECK_BATCH, cpu_step_s=cpu_s)
    del net
    torch.cuda.empty_cache()
    return out


def finetune_yolo(seed):
    """Tiny YOLO from the registry at its defaults, trained under both
    policies; its detections and NMS from the card's output against the
    same functions on the output moved to the CPU; the float64 step check."""
    from deeplearning4j_tpu_torch.models import get_model
    from deeplearning4j_tpu_torch.nn.layers.objdetect import non_max_suppression
    from deeplearning4j_tpu_torch.utils import dtypes

    rows = {}
    x, y = yolo_data(seed, YOLO_BATCH * (ZOO_WARMUP_STEPS + ZOO_TIMED_STEPS))
    for policy in ("f32", "bf16"):
        (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
        try:
            net = get_model("tinyyolo").build(device="cuda", seed=seed)
            if net.num_params() != YOLO_PARAMS:
                raise AssertionError(f"tiny_yolo has {net.num_params()} params, expected "
                                     f"{YOLO_PARAMS}")
            row = zoo_train(net, x, y, YOLO_BATCH, "tiny_yolo", policy)
            head = net.conf.layers[-1]
            out = net.output(x[:YOLO_DETECT_IMAGES])
            # the threshold that keeps the YOLO_DETECTIONS most confident
            # anchors of these images (a dozen steps leave every confidence low)
            conf = torch.sigmoid(out.float().reshape(*out.shape[:3], head.n_anchors, -1)[..., 4])
            threshold = float(conf.flatten().topk(YOLO_DETECTIONS + 1).values[-1])
            card = head.get_predicted_objects(out, threshold)
            host = head.get_predicted_objects(out.cpu(), threshold)
            kept = [non_max_suppression(d, 0.45) for d in card]
            if card != host or kept != [non_max_suppression(d, 0.45) for d in host]:
                raise AssertionError("detections from the card's output differ from the same "
                                     "functions on it moved to the CPU")
            row.update(detections=sum(map(len, card)), after_nms=sum(map(len, kept)),
                       threshold=threshold, grid=list(out.shape[1:3]))
            emit("finetune.yolo", **row)
            rows[policy] = row
            del net
            torch.cuda.empty_cache()
        finally:
            dtypes.f32_policy()
    del x, y
    rows["step_check"] = yolo_step_check(seed)
    emit("finetune.yolo_step_check", **rows["step_check"], card=card_line())
    return rows


def finetune_layers(seed):
    """Each conv layer this slice ports, forward and backward (input and
    parameter gradients of sum(y * g)) on the card in f32 at a realistic
    shape, against float64 on the CPU: every tensor within LAYER_RTOL of the
    reference tensor's largest magnitude."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.utils import dtypes

    b, hw, c = LAYER_BATCH, LAYER_HW, LAYER_C
    cnn, rnn = I.ConvolutionalType(hw, hw, c), I.RecurrentType(c, hw * hw)
    cases = [(L.Convolution1DLayer(n_out=c, kernel=3, padding="same"), rnn),
             (L.Deconvolution2DLayer(n_out=c // 2, kernel=(3, 3), stride=(2, 2),
                                     padding="same"), cnn),
             (L.SeparableConvolution2DLayer(n_out=c, kernel=(3, 3), padding="same",
                                            depth_multiplier=2), cnn),
             (L.Subsampling1DLayer(kernel=2, stride=2), rnn),
             (L.Upsampling2DLayer(size=(2, 2)), cnn), (L.Upsampling1DLayer(size=2), rnn),
             (L.ZeroPaddingLayer(pad=(1, 2, 1, 2)), cnn), (L.ZeroPadding1DLayer(pad=(1, 2)), rnn),
             (L.SpaceToDepthLayer(blocks=2), cnn), (L.SpaceToBatchLayer(blocks=(2, 2)), cnn)]
    rows = []
    rs = np.random.RandomState(seed)
    for layer, in_type in cases:
        shape = (b,) + tuple(in_type.shape(1)[1:])
        params = layer.init(torch.Generator().manual_seed(seed), in_type, torch.float64)
        x = torch.from_numpy(rs.randn(*shape))
        with torch.no_grad():  # the output's shape (SpaceToBatch multiplies the batch)
            g = torch.from_numpy(rs.randn(*layer.apply(params, {}, x)[0].shape))

        def run(dev, dt):
            p = {k: v.to(dev, dt).detach().requires_grad_(True) for k, v in params.items()}
            xx = x.to(dev, dt).detach().requires_grad_(True)
            with dtypes.policy_precision():
                yy = layer.apply(p, {}, xx)[0]
                (yy * g.to(dev, dt)).sum().backward()
            return {"y": yy.detach(), "dx": xx.grad, **{f"d{k}": v.grad for k, v in p.items()}}

        want = run("cpu", torch.float64)
        t0 = time.perf_counter()
        got = run("cuda", torch.float32)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        errs = {k: ((got[k].double().cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                for k, w in want.items()}
        if not max(errs.values()) <= LAYER_RTOL:
            raise AssertionError(f"{type(layer).__name__} on the card differs from float64: {errs}")
        rows.append({"layer": type(layer).__name__, "input": list(shape),
                     "output": list(want["y"].shape), "max_rel_err": errs, "card_ms": card_ms})
    emit("finetune.layers", layers=rows, rtol=LAYER_RTOL, card=card_line())
    return rows


def phase_finetune(C, seed):
    """The fused ResNet50 at the flagship shape trained FT_SOURCE_STEPS
    steps, saved and restored through the zoo's ``restore_checkpoint``,
    fine-tuned frozen up to FT_EXTRACTOR under both policies, evaluated,
    early-stopped and served; Tiny YOLO; the other conv layers."""
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint
    from deeplearning4j_tpu_torch.utils import dtypes, serialization
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    rows = {}
    src = make_resnet(seed)
    xs, ys = resnet_data(seed, RN_BATCH * FT_SOURCE_STEPS)
    src.fit(xs, ys, batch_size=RN_BATCH)
    zip_path = WORK / "resnet50_source.zip"
    serialization.save_model(src, zip_path, save_updater=False)
    source = restore_checkpoint(zip_path, device="cuda")
    mine, back = flatten_tree(src.params), flatten_tree(source.params)
    if mine.keys() != back.keys() or not all(torch.equal(mine[k], back[k]) for k in mine):
        raise AssertionError("the restored source differs from the saved network")
    emit("finetune.source", params=source.num_params(), steps=FT_SOURCE_STEPS,
         losses=src.score_history, zip_mb=zip_path.stat().st_size / 1e6, card=card_line())
    del src, xs, ys, mine
    torch.cuda.empty_cache()

    n = RN_BATCH * (ZOO_WARMUP_STEPS + ZOO_TIMED_STEPS)
    x, y = resnet_data(seed, n, n_out=FT_CLASSES, classes=FT_CLASSES)
    xe, ye = resnet_data(seed, FT_EVAL_IMAGES, n_out=FT_CLASSES, classes=FT_CLASSES,
                         draw_seed=seed + 1)
    for policy in ("f32", "bf16"):
        (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
        try:
            rows[policy], net = finetune_train(C, source, seed, policy, x, y)
            rows[("eval", policy)] = finetune_eval(net, xe, ye, policy)
            if policy == "f32":
                rows["early_stopping"] = finetune_early_stopping(net, x, y, xe, ye)
                rows["serve"] = finetune_serve(net, xe, ye, seed)
                collect_cli = rows["serve"].pop("collect_cli")
            del net
            torch.cuda.empty_cache()
        finally:
            dtypes.f32_policy()
    del source, x, y, xe, ye
    torch.cuda.empty_cache()
    rows["yolo"] = finetune_yolo(seed)
    rows["layers"] = finetune_layers(seed)
    collect_cli()  # the serve and eval verbs' processes, run meanwhile
    return rows


# ---------------------------------------------------------------------------
# fused: K steps a dispatch, one CUDA-graph replay each (nn/fused.py)
# ---------------------------------------------------------------------------

def free_card():
    """Release what deleted networks held: a net and its K-step engine
    refer to each other, so their tensors and the engine's graph pool go
    only with a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def fused_initial(net):
    """A fresh network's initial weights and layer state, copied."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_map

    return {"params": [t.detach().clone() for t in tree_leaves(net.params)],
            "state": tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, net.state)}


def fused_restore(net, initial):
    """``net`` back to ``initial`` as a fresh build of it would be: its
    weights copied in place, its layer state, no updater state (the next
    fit makes it), its counters at 0."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_map

    with torch.no_grad():
        for t, v in zip(tree_leaves(net.params), initial["params"]):
            t.copy_(v)
    net.state = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, initial["state"])
    net.opt_state = None
    net.iteration = 0
    net.epoch = 0
    net.score_value = None
    net.score_history = []


def fused_snapshot(net):
    """A trained net's per-step losses and its params, layer state and
    updater state, copied."""
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    def copy(tree):
        return {k: v.detach().clone() for k, v in flatten_tree(tree).items()}
    return {"losses": list(net.score_history), "params": copy(net.params),
            "state": copy(net.state), "opt": copy(net.opt_state)}


def fused_diff(a, b):
    """How far run ``a`` is from run ``b``: the largest relative difference
    of a step's loss, and the relative L2 difference of the parameters, the
    layer state and the updater state (each all tensors together); and
    whether everything is bit-identical."""
    if len(a["losses"]) != len(b["losses"]):
        raise AssertionError(f"{len(a['losses'])} losses against {len(b['losses'])}")

    def rel(x, y):
        num = sum(((x[k].double() - y[k].double()) ** 2).sum() for k in y)
        den = sum((y[k].double() ** 2).sum() for k in y)
        return float((num / max(float(den), 1e-300)) ** 0.5) if y else 0.0
    same = a["losses"] == b["losses"] and all(
        torch.equal(a[t][k], b[t][k]) for t in ("params", "state", "opt") for k in b[t])
    return {"loss_max_rel": max(abs(p - q) / abs(q) for p, q in zip(a["losses"], b["losses"])),
            "params_rel": rel(a["params"], b["params"]), "state_rel": rel(a["state"], b["state"]),
            "opt_rel": rel(a["opt"], b["opt"]), "bit_identical": same}


def fused_within_noise(k, p, noise_runs, what):
    """Hold the K-step run ``k`` against the K=1 run ``p`` within
    FUSED_NOISE_FACTOR x the card's own f32 noise: for each metric, the
    farthest from ``p`` of the K=1 reruns in ``noise_runs`` (by name: each
    batch's rows in another order; the same steps mathematically)."""
    kp = fused_diff(k, p)
    noise = {run: fused_diff(q, p) for run, q in noise_runs.items()}
    for m in ("loss_max_rel", "params_rel", "state_rel", "opt_rel"):
        draws = {run: n[m] for run, n in noise.items()}
        if not kp[m] <= FUSED_NOISE_FACTOR * max(draws.values()):
            raise AssertionError(f"{what}: K={FUSED_K} differs from K=1 by {m} {kp[m]}, beyond "
                                 f"{FUSED_NOISE_FACTOR} x the noise {draws}")
    return {"k_vs_k1": kp, **{f"noise_k1_vs_{run}": n for run, n in noise.items()}}


def within_batch_permutation(n, batch, seed):
    """Indices that reorder the rows inside each batch of ``batch``."""
    g = torch.Generator().manual_seed(seed)
    return np.concatenate([i + torch.randperm(min(batch, n - i), generator=g).numpy()
                           for i in range(0, n, batch)])


def fused_launches():
    """Every kernel wrapper's launch counts (the main path's reading)."""
    from deeplearning4j_tpu_torch.ops import conv_stats as C
    from deeplearning4j_tpu_torch.ops import lstm_seq as L

    return {**C.launches, "lstm_seq": L.launches,
            "by_variant": {**{f"conv.{k}": v for k, v in C.launches_by_variant.items()},
                           **{f"lstm.{k}": v for k, v in L.launches_by_variant.items()}}}


def launches_on(name, launches, variant, n):
    """The nonzero launches by variant; all ``n`` must be on ``variant``."""
    variants = {v: k for v, k in launches["by_variant"].items() if k}
    if variants != {variant: n}:
        raise AssertionError(f"{name}: launches by variant {variants}, all expected on {variant}")
    return variants


def reset_all_launches():
    from deeplearning4j_tpu_torch.nn import fused
    from deeplearning4j_tpu_torch.ops import conv_stats as C
    from deeplearning4j_tpu_torch.ops import lstm_seq as L

    C.reset_launches()
    L.reset_launches()
    fused.reset_replay_launches()


def replay_kernel_counts(prof):
    """Device events of the path's kernels in a profile, by kernel."""
    names = {"conv_stats_f32_kernel": 0, "conv_stats_wgmma_kernel": 0,
             "lstm_persistent_kernel": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    names[n] += 1
    return names


@contextlib.contextmanager
def cudnn_default_algorithms():
    """Within this block a fit runs on cuDNN's default algorithm choice:
    the port's f32 precision block is entered first with its
    deterministic flag turned back off, so the fit's own block (nested)
    leaves it so."""
    from deeplearning4j_tpu_torch.utils import dtypes

    with dtypes.policy_precision():
        torch.backends.cudnn.deterministic = False
        yield


def fused_model_run(name, make, x, y, xt, yt, batch, per_step, variant, profiled_kernels,
                    family, family_tags, policy, cudnn_default=False):
    """One model under one policy: K=1 (``pad_ragged``) and K=FUSED_K fits
    from identical weights over the ragged (x, y), which must agree to the
    bit (every step repeats itself: under the f32 policy cuDNN's algorithms
    are deterministic, ``utils/dtypes.policy_precision``), and the K=1 fit
    on the batches' rows in another order (the noise, reported); the K-step net trained
    FUSED_EPOCHS - 1 more epochs (one capture in all); then
    FUSED_TIMED_DISPATCHES timed dispatches over (xt, yt) against as many
    K=1 steps, each with its peak memory and one profiled dispatch (the
    replay's kernels counted). ``per_step`` maps each launch counter to its
    launches a step, ``profiled_kernels`` each device kernel to its events a
    step. With ``cudnn_default`` the K=1 fit runs twice more on cuDNN's
    default (non-deterministic) algorithms, to show what the port's
    deterministic choice repeats, and the timed K=1 steps once more there
    (the choice's cost). Returns the row."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.nn import fused

    k = FUSED_K
    perm = within_batch_permutation(len(x), batch, SEED)
    runs = {}
    # one build shared by the three fits: each starts from its initial
    # weights and state, restored in place (the K-step fit comes last, so
    # its engine captures the net once)
    net = make()
    initial = fused_initial(net)
    k1 = {"pad_ragged": True}
    fits = [("k1", x, y, k1), ("k1_permuted", x[perm], y[perm], k1)]
    if cudnn_default:
        fits += [("k1_cudnn_default", x, y, k1), ("k1_cudnn_default_again", x, y, k1)]
    for run, xx, yy, kw in fits + [("k", x, y, {"steps_per_dispatch": k})]:
        fused_restore(net, initial)
        with cudnn_default_algorithms() if run.startswith("k1_cudnn") else \
                contextlib.nullcontext():
            net.fit(xx, yy, batch_size=batch, **kw)
        runs[run] = fused_snapshot(net)
    del initial
    free_card()
    check = fused_within_noise(runs["k"], runs["k1"], {"k1_permuted": runs["k1_permuted"]},
                               f"{name} {policy}")
    if cudnn_default:
        check["k1_cudnn_default_repeat"] = fused_diff(runs["k1_cudnn_default_again"],
                                                      runs["k1_cudnn_default"])
    del runs
    if not check["k_vs_k1"]["bit_identical"]:
        raise AssertionError(f"{name} {policy}: K={k} is not bit-identical to K=1: "
                             f"{check['k_vs_k1']}")
    engine = net._train_steps_fused[(k, False)]
    net.fit(x, y, batch_size=batch, steps_per_dispatch=k, epochs=FUSED_EPOCHS - 1)
    if engine.captures != 1:
        raise AssertionError(f"{name}: {engine.captures} captures over {FUSED_EPOCHS} epochs "
                             "(one signature: expected 1)")
    steps = FUSED_TIMED_DISPATCHES * k
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    net.fit(xt, yt, batch_size=batch, steps_per_dispatch=k)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches, replays = fused_launches(), dict(fused.replay_launches)
    peak_k = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    for counter, n in per_step.items():
        got = launches[counter]
        want = n * steps
        if got != want or replays.get(f"conv_stats.{counter}", replays.get(counter)) != want:
            raise AssertionError(f"{name}: {counter} launched {got} times ({replays} from "
                                 f"replays) in {steps} steps; expected {want}")
    variants = launches_on(name, launches, variant, sum(per_step.values()) * steps)
    n_prof = FUSED_PROFILED_DISPATCHES * k * batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(xt[:n_prof], yt[:n_prof], batch_size=batch, steps_per_dispatch=k)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    seen = replay_kernel_counts(prof)
    prof_steps = FUSED_PROFILED_DISPATCHES * k
    for kern, want in profiled_kernels.items():
        # every conv launch shows; the LSTM's cooperative launch at least once a call
        if not (seen[kern] == want * prof_steps if kern.startswith("conv") else
                seen[kern] >= prof_steps):
            raise AssertionError(f"{name}: the profiler saw {seen} in {prof_steps} replayed "
                                 f"steps; expected {kern} {want} a step")
    by_family_k, busy_k, share_k = device_families(prof, prof_ms, family, family_tags)
    if engine.captures != 1 or engine.replays < FUSED_TIMED_DISPATCHES:
        raise AssertionError(f"{name}: captures {engine.captures}, replays {engine.replays}")
    del net
    free_card()

    net = make()
    net.fit(xt[:2 * batch], yt[:2 * batch], batch_size=batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit(xt[:FUSED_TIMED_DISPATCHES * batch], yt[:FUSED_TIMED_DISPATCHES * batch],
            batch_size=batch)
    torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t0
    wall_1_default = None
    if cudnn_default:
        with cudnn_default_algorithms():
            t0 = time.perf_counter()
            net.fit(xt[:FUSED_TIMED_DISPATCHES * batch], yt[:FUSED_TIMED_DISPATCHES * batch],
                    batch_size=batch)
            torch.cuda.synchronize()
            wall_1_default = time.perf_counter() - t0
    peak_1 = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(xt[:batch], yt[:batch], batch_size=batch)
        torch.cuda.synchronize()
        prof1_ms = 1e3 * (time.perf_counter() - t0)
    by_family_1, busy_1, share_1 = device_families(prof, prof1_ms, family, family_tags)
    del net
    free_card()
    row = {"model": name, "policy": policy, "k": k, "batch": batch,
           "check": check, "captures": engine.captures, "epochs_ragged": FUSED_EPOCHS,
           "k_step_ms": 1e3 * wall_k / steps, "k1_step_ms": 1e3 * wall_1 / FUSED_TIMED_DISPATCHES,
           # the same timed K=1 steps on cuDNN's default algorithms (the
           # port's f32 block makes them deterministic; null: not run)
           "k1_step_ms_cudnn_default": None if wall_1_default is None
           else 1e3 * wall_1_default / FUSED_TIMED_DISPATCHES,
           "k_dispatches": FUSED_TIMED_DISPATCHES, "k1_steps": FUSED_TIMED_DISPATCHES,
           "k_examples_per_s": steps * batch / wall_k,
           "k1_examples_per_s": FUSED_TIMED_DISPATCHES * batch / wall_1,
           # allocated: tensors alive; reserved: the caching allocator's hold,
           # which includes a captured graph's private memory pool
           "k_peak_allocated_gb": peak_k[0] / 1e9, "k1_peak_allocated_gb": peak_1[0] / 1e9,
           "k_peak_reserved_gb": peak_k[1] / 1e9, "k1_peak_reserved_gb": peak_1[1] / 1e9,
           "k_profiled_dispatches": FUSED_PROFILED_DISPATCHES, "k_profiled_ms": prof_ms,
           "k_device_busy_ms": busy_k,
           "k_device_busy_share": share_k, "k_device_ms_by_family": by_family_k,
           "k1_profiled_step_ms": prof1_ms, "k1_device_busy_ms": busy_1,
           "k1_device_busy_share": share_1, "k1_device_ms_by_family": by_family_1,
           "launches": {c: launches[c] for c in per_step}, "replay_launches": replays,
           "launches_by_variant": variants,
           "profiled_replay_kernels": seen, "card": card_line()}
    emit("fused", **row)
    return row


def charnn_numpy(seed, n):
    x, y = charnn_data(np.random.RandomState(seed), n, SEQ)
    return x.cpu().numpy(), y.cpu().numpy()


def make_charnn_with(seed, noise):
    """The char-RNN with ``noise`` as both GravesLSTM layers' weight noise."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    base = make_charnn(seed)
    layers = tuple(dataclasses.replace(l, weight_noise=noise) if type(l).__name__ == "GravesLSTM"
                   else l for l in base.conf.layers)
    net = MultiLayerNetwork(dataclasses.replace(base.conf, layers=layers), device=base.device)
    net.init(torch.Generator().manual_seed(seed))
    return net


def fused_dropconnect(seed):
    """DropConnect on both GravesLSTM layers: the K-step engine captured on
    the card against the K=1 loop, eager, on the same batches. The captured
    graph derives each step's seed on the card, so its masks are the K=1
    loop's: the runs agree within the noise, while a K=1 run whose every
    step draws the first step's masks (what a mask frozen at capture would
    give) is farther from them than FUSED_NOISE_FACTOR x the noise."""
    from deeplearning4j_tpu_torch.continuous import driver
    from deeplearning4j_tpu_torch.nn.layers.base import step_seed
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect

    x, y = charnn_numpy(seed + 11, FUSED_DC_STEPS * CHARNN_BATCH)
    make = lambda: make_charnn_with(seed, DropConnect(FUSED_DC_RETAIN))
    perm = within_batch_permutation(len(x), CHARNN_BATCH, SEED)
    runs = {}
    k1 = {"pad_ragged": True}
    for run, xx, yy, kw in (("k1", x, y, k1), ("k1_permuted", x[perm], y[perm], k1),
                            ("k", x, y, {"steps_per_dispatch": FUSED_K}), ("frozen", x, y, k1)):
        net = make()
        real = driver.step_seed
        if run == "frozen":
            driver.step_seed = lambda s, it: step_seed(s, 0)
        try:
            net.fit(xx, yy, batch_size=CHARNN_BATCH, **kw)
        finally:
            driver.step_seed = real
        runs[run] = fused_snapshot(net)
        del net
    free_card()
    check = fused_within_noise(runs["k"], runs["k1"], {"k1_permuted": runs["k1_permuted"]},
                               "dropconnect")
    frozen = fused_diff(runs["frozen"], runs["k"])
    noise = check["noise_k1_vs_k1_permuted"]
    if not frozen["params_rel"] > FUSED_NOISE_FACTOR * noise["params_rel"]:
        raise AssertionError(f"frozen masks {frozen} are within the noise {noise}: the check "
                             "cannot tell the masks apart")
    row = {"retain": FUSED_DC_RETAIN, "steps": FUSED_DC_STEPS, **check,
           "frozen_masks_vs_k": frozen, "card": card_line()}
    emit("fused.dropconnect", **row)
    return row


def fused_health(seed):
    """The K-step engine with the watchdog armed, NaN features in batch
    FUSED_NAN_BATCH: under ``record`` the anomaly resolves one dispatch
    late, at that step; under ``raise`` the round after the NaN's raises
    ``NumericsError`` naming it."""
    from deeplearning4j_tpu_torch.continuous import StepDriver
    from deeplearning4j_tpu_torch.telemetry import health

    k, b = FUSED_K, CHARNN_BATCH
    x, y = charnn_numpy(seed + 13, 3 * k * b)
    x[FUSED_NAN_BATCH * b:FUSED_NAN_BATCH * b + 1] = np.nan
    factory = lambda: ((x[i:i + b], y[i:i + b], None) for i in range(0, len(x), b))
    out = {}
    try:
        for policy in ("record", "raise"):
            mon = health.get_monitor()
            mon.reset()
            health.enable(policy=policy)
            net = make_charnn(seed)
            drv = StepDriver(net, factory, k=k, batch_size=b)
            drv.run_round(1)
            drv.run_round(1)  # the NaN's dispatch: queued, not yet resolved
            if mon.anomalies or mon.steps_checked != k:
                raise AssertionError(f"watchdog {mon.summary()} before the late resolution")
            if policy == "raise":
                try:
                    drv.run_round(1)
                except health.NumericsError as e:
                    out[policy] = {"raised_at_step": e.step, "kind": e.record["kind"]}
                finally:
                    drv.close_source()
                if out.get(policy, {}).get("raised_at_step") != FUSED_NAN_BATCH:
                    raise AssertionError(f"the raise policy gave {out.get(policy)}")
            else:
                drv.run_round(None)
                drv.sync()
                s = mon.summary()
                if s["anomalies"][0]["step"] != FUSED_NAN_BATCH or s["steps_checked"] != 3 * k:
                    raise AssertionError(f"watchdog summary {s}")
                out[policy] = {"first_anomaly": s["anomalies"][0], "steps_checked":
                               s["steps_checked"], "anomalous_steps": s["nonfinite_steps"]}
                drv.close_source()
            del net, drv
    finally:
        health.disable()
        health.get_monitor().reset()
    free_card()
    emit("fused.health", nan_batch=FUSED_NAN_BATCH, **out, card=card_line())
    return out


def fused_resume(seed):
    """StepDriver at K=FUSED_K on the char-RNN: 2 * FUSED_RESUME_ROUNDS
    uninterrupted rounds against FUSED_RESUME_ROUNDS rounds, a checkpoint,
    a restore into a fresh net (which had captured its own graph on other
    batches) and FUSED_RESUME_ROUNDS more: bit-identical, and the restored
    net's graph captured once more."""
    from deeplearning4j_tpu_torch.continuous import StepDriver
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    k, b, r = FUSED_K, CHARNN_BATCH, FUSED_RESUME_ROUNDS
    x, y = charnn_numpy(seed + 17, (2 * r + 1) * k * b)
    batches = [(x[i:i + b], y[i:i + b], None) for i in range(0, len(x), b)]
    factory = lambda part: (lambda: iter(part))
    whole = make_charnn(seed)
    drv = StepDriver(whole, factory(batches[:2 * r * k]), k=k, batch_size=b)
    for _ in range(2 * r):
        drv.run_round(1)
    drv.sync()
    drv.close_source()

    first = make_charnn(seed)
    drv = StepDriver(first, factory(batches[:2 * r * k]), k=k, batch_size=b)
    for _ in range(r):
        drv.run_round(1)
    path = WORK / "fused_resume.zip"
    drv.checkpoint(path)
    drv.close_source()
    del first, drv

    fresh = make_charnn(seed + 1)
    drv = StepDriver(fresh, factory(batches[2 * r * k:]), k=k, batch_size=b)
    drv.run_round(1)  # its own graph, on other batches
    engine = fresh._train_steps_fused[(k, False)]
    before = engine.captures
    drv.restore(path)
    drv.close_source()
    drv.batch_factory = factory(batches[r * k:2 * r * k])
    for _ in range(r):
        drv.run_round(1)
    drv.sync()
    drv.close_source()
    a = flatten_tree([whole.params, whole.state, whole.opt_state])
    c = flatten_tree([fresh.params, fresh.state, fresh.opt_state])
    same = a.keys() == c.keys() and all(torch.equal(a[t], c[t]) for t in a)
    if not same or fresh.iteration != whole.iteration or engine.captures != before + 1:
        worst = max((a[t] - c[t]).abs().max().item() for t in a)
        raise AssertionError(f"resumed run: bit-identical {same} (worst {worst}), iteration "
                             f"{fresh.iteration} vs {whole.iteration}, captures "
                             f"{before} -> {engine.captures}")
    row = {"rounds": 2 * r, "k": k, "iteration": fresh.iteration, "bit_identical": same,
           "captures_before_restore": before, "captures_after": engine.captures,
           "card": card_line()}
    emit("fused.resume", **row)
    del whole, fresh, drv
    free_card()
    return row


def phase_fused(seed):
    """The fused ResNet50 and the char-RNN at full width, K=FUSED_K steps a
    dispatch against K=1, under both policies; DropConnect's masks, the
    watchdog and a bit-exact resume on the char-RNN (f32)."""
    from deeplearning4j_tpu_torch.utils import dtypes

    rows = {}
    for policy in ("f32", "bf16"):
        (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
        try:
            xr, yr = (a.cpu().numpy() for a in resnet_data(seed, FUSED_RAGGED_N))
            xt, yt = (a.cpu().numpy() for a in resnet_data(
                seed, FUSED_TIMED_DISPATCHES * FUSED_K * RN_BATCH, draw_seed=seed + 5))
            rows[("resnet", policy)] = fused_model_run(
                "resnet50", lambda: make_resnet(seed), xr, yr, xt, yt, RN_BATCH,
                {"conv_mm_stats": 36, "conv3x3_stats": 16},
                f"conv.{'bf16_wgmma' if policy == 'bf16' else 'f32_pipelined'}",
                {"conv_stats_wgmma_kernel" if policy == "bf16" else "conv_stats_f32_kernel": 52},
                resnet_family,
                (("updater.step", "optimizer"),), policy, cudnn_default=policy == "f32")
            del xr, yr, xt, yt
            xr, yr = charnn_numpy(seed + 3, FUSED_RAGGED_N)
            xt, yt = charnn_numpy(seed + 5, FUSED_TIMED_DISPATCHES * FUSED_K * CHARNN_BATCH)
            rows[("charnn", policy)] = fused_model_run(
                "charnn", lambda: make_charnn(seed), xr, yr, xt, yt, CHARNN_BATCH,
                {"lstm_seq": 2}, "lstm.persistent", {"lstm_persistent_kernel": 2},
                charnn_family,
                (("lstm_seq.backward", "lstm_bwd"), ("updater.step", "optimizer")), policy)
            del xr, yr, xt, yt
        finally:
            dtypes.f32_policy()
    rows["dropconnect"] = fused_dropconnect(seed)
    rows["health"] = fused_health(seed)
    rows["resume"] = fused_resume(seed)
    return rows


# ---------------------------------------------------------------------------
# word2vec: SequenceVectors on the card (text/word2vec.py), the NLP tier

def w2v_corpus(seed, n_sentences=W2V_SENTENCES):
    """bench_word2vec's Zipf corpus: sentences of W2V_SENT_LEN int tokens
    drawn with p(rank) ~ 1/rank over W2V_VOCAB ranks."""
    rs = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, W2V_VOCAB + 1)
    return rs.choice(W2V_VOCAB, (n_sentences, W2V_SENT_LEN), p=probs / probs.sum()).tolist()


def make_w2v(seed):
    from deeplearning4j_tpu_torch.text.word2vec import Word2Vec

    return Word2Vec(vector_size=W2V_DIM, window=W2V_WINDOW, min_count=1,
                    negative=W2V_NEGATIVE, epochs=1, seed=seed, batch_size=W2V_BATCH,
                    subsample=W2V_SUBSAMPLE, learning_rate=W2V_LR)


def w2v_timed_fit(model, sents):
    """``model.fit(sents)`` on the host clock (it ends in the losses' one
    fetch), split by wrapping the instance's stages: vocab and encoding
    (``flatten_corpus``, ``build_vocab``, ``_encode_corpus``), pairs
    (``_subsampled``, ``_pairs_from_corpus``), the other host work before
    the first step (list copies, the permutation, the negatives' enqueue),
    and the steps from ``_run_batched``'s entry to the fit's end (the card's
    chunks and the host's enqueue of them, overlapped). Also the captures
    with their ms (synchronized around), and the pairs and negatives."""
    from deeplearning4j_tpu_torch.text import word2vec as W

    stages = {"vocab_encode_s": 0.0, "pairs_s": 0.0}
    seen = {"captures_ms": [], "pairs": 0, "negatives_device": None}
    marks = {}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            stages[name] += time.perf_counter() - t0
            return out
        return run

    def pairs(*a, **k):
        out = pair_fn(*a, **k)
        seen["pairs"] += len(out[0])
        return out

    def negatives(*a, **k):
        out = neg_fn(*a, **k)
        seen["negatives_device"] = str(out.device)
        return out

    def run_batched(*a, **k):
        marks.setdefault("steps", time.perf_counter())
        return run_fn(*a, **k)

    capture_fn = W._ChunkSteps._capture

    def capture(engine, m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capture_fn(engine, m)
        torch.cuda.synchronize()
        seen["captures_ms"].append(1e3 * (time.perf_counter() - t0))

    pair_fn, neg_fn, run_fn = model._pairs_from_corpus, model._draw_negatives, model._run_batched
    model.build_vocab = timed("vocab_encode_s", model.build_vocab)
    model._encode_corpus = timed("vocab_encode_s", model._encode_corpus)
    model._subsampled = timed("pairs_s", model._subsampled)
    model._pairs_from_corpus = timed("pairs_s", pairs)
    model._draw_negatives = negatives
    model._run_batched = run_batched
    flatten = W.flatten_corpus
    W.flatten_corpus = timed("vocab_encode_s", flatten)
    W._ChunkSteps._capture = capture
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(sents)
        total = time.perf_counter() - t0
    finally:
        W.flatten_corpus = flatten
        W._ChunkSteps._capture = capture_fn
        for name in ("build_vocab", "_encode_corpus", "_subsampled", "_pairs_from_corpus",
                     "_draw_negatives", "_run_batched"):
            del model.__dict__[name]
    host = marks["steps"] - t0
    return {"fit_s": total, "host_s": host, "host_share": host / total,
            **stages, "other_host_s": host - sum(stages.values()),
            "steps_s": total - host, "pairs": seen["pairs"],
            "negatives_device": seen["negatives_device"],
            "captures": len(seen["captures_ms"]), "captures_ms": seen["captures_ms"]}


def w2v_step_bytes(engine, model):
    """The bytes one SGNS step of the engine's last chunk must move, averaged
    over its steps: each distinct row it reads of syn0 (centers) and syn1
    (contexts and negatives) read once and written once, its indices read
    once, its loss written once; and its operations (the dot products, the
    gradients, the scatter sums and the row updates, f32)."""
    centers, contexts, negs = engine.bufs
    d, k = model.vector_size, negs.shape[-1]
    nbytes, ops = 0, 0
    for i in range(engine.k):
        rows0 = int(torch.unique(centers[i]).numel())
        rows1 = int(torch.unique(torch.cat([contexts[i], negs[i].reshape(-1)])).numel())
        b = centers.shape[1]
        nbytes += 2 * (rows0 + rows1) * d * 4 + b * (2 + k) * centers.element_size() + 4
        ops += b * d * (2 * (1 + k) + 2 * (1 + k) + (1 + k) + (2 + k)) + 3 * (rows0 + rows1) * d
    return nbytes / engine.k, ops / engine.k


def w2v_warm_host(model, sents):
    """The host stages a fit runs before its first step, at the corpus's
    full size (the token lists copied, ``flatten_corpus``, ``build_vocab``,
    ``_encode_corpus``): the timed fit's vocabulary pass then finds the
    process's memory as a second fit does (a fit after a warm-up on a tenth
    of the corpus spent 26.3 s there against 18.8). The card's side is warm
    from the chunk check's capture and replays. Returns the seconds."""
    from deeplearning4j_tpu_torch.text.vocab import flatten_corpus

    t0 = time.perf_counter()
    seq_list = [list(s) for s in sents]
    flat = flatten_corpus(seq_list)
    model.build_vocab(seq_list, _flat=flat)
    model._encode_corpus(seq_list, _flat=flat)
    return time.perf_counter() - t0


def w2v_production(seed):
    """The main path: a warm-up of the fit's host stages on the whole corpus
    (``w2v_warm_host``), then a timed fit of a fresh model (as
    bench_word2vec times it), its chunks' replays asserted; then the
    engine's replays timed on the card, profiled, and set against the
    step's bytes."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    sents = w2v_corpus(seed)
    corpus_s = time.perf_counter() - t0
    n_words = len(sents) * W2V_SENT_LEN
    warm_s = w2v_warm_host(make_w2v(seed), sents)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model = make_w2v(seed)
    row = w2v_timed_fit(model, sents)
    peak = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
    steps = -(-row["pairs"] // W2V_BATCH)
    chunks = row["pairs"] // (model.SCAN_CHUNK * W2V_BATCH)
    engine, = model._chunk_steps.values()
    # no fallback: tables, draws and chunks on the card, every full chunk a replay
    for what, dev in (("syn0", model.syn0.device), ("syn1", model.syn1.device),
                      ("scratch", model._scratch[0].device), ("negatives", row["negatives_device"]),
                      ("generator", model._neg_gen.device)):
        if torch.device(dev).type != "cuda":
            raise AssertionError(f"word2vec: {what} on {dev}, not on the card")
    if (engine.replays, engine.captures, row["captures"]) != (chunks, 1, 1):
        raise AssertionError(f"word2vec: {engine.replays} replays and {engine.captures} captures "
                             f"for {chunks} full chunks (expected one capture)")
    if len(model.loss_history) != steps or not np.isfinite(model.loss_history).all():
        raise AssertionError(f"word2vec: {len(model.loss_history)} losses for {steps} steps, "
                             "or a loss is not finite")
    chunk_ms = time_ms(engine.graph.replay, iters=W2V_TIMED_REPLAYS, reps=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(W2V_PROFILED_REPLAYS):
            engine.graph.replay()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, busy_ms, share = device_families(prof, prof_ms, family=lambda name: name[:48],
                                                tags=())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:W2V_TOP_KERNELS]
    events = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    nbytes, ops = w2v_step_bytes(engine, model)
    bound_ms, bound_by = roofline(nbytes, ops, torch.float32)
    step_ms = chunk_ms / engine.k
    out = {"words": n_words, "words_per_s": n_words / row["fit_s"], "corpus_s": corpus_s,
           "warm_host_s": warm_s, **row,
           "vocab": len(model.vocab), "steps": steps, "chunks": chunks,
           "eager_steps": steps - chunks * engine.k, "replays": engine.replays,
           "peak_allocated_gb": peak[0] / 1e9, "peak_reserved_gb": peak[1] / 1e9,
           "first_loss": model.loss_history[0], "last_loss": model.loss_history[-1],
           "device_ms_a_step": step_ms, "chunk_ms": chunk_ms,
           "step_bytes": nbytes, "step_ops": ops, "step_bound_ms": bound_ms,
           "step_bound_by": bound_by, "step_vs_bound": step_ms / bound_ms,
           "profiled_replays": W2V_PROFILED_REPLAYS, "profiled_ms": prof_ms,
           "device_busy_ms": busy_ms, "device_busy_share": share,
           "device_ms_a_step_by_kernel": {k: v / (W2V_PROFILED_REPLAYS * engine.k)
                                          for k, v in top},
           "device_events_a_step": events / (W2V_PROFILED_REPLAYS * engine.k),
           "captures_share_of_fit": sum(row["captures_ms"]) / 1e3 / row["fit_s"]}
    emit("word2vec.fit", **out)
    del model, engine, sents
    free_card()
    return out


def w2v_chunk_check(seed):
    """One chunk of SCAN_CHUNK SGNS steps at full width on the card (a
    capture and one replay), from tables installed with
    ``tables_from_numpy`` and fixed Zipf indices and unigram^0.75
    negatives, twice; and the plain step in float64 and float32 on the CPU
    on the same inputs. The card's tables and losses must lie within
    W2V_CHECK_FACTOR x the larger of the two card runs' spread and the f32
    plain run's distance from float64."""
    from deeplearning4j_tpu_torch.text import word2vec as W

    rs = np.random.RandomState(seed + 11)
    v, d, b, k, ck = W2V_VOCAB, W2V_DIM, W2V_BATCH, W2V_NEGATIVE, 32
    zipf = 1.0 / np.arange(1, v + 1)
    zipf /= zipf.sum()
    n = ck * b
    centers = rs.choice(v, n, p=zipf).astype(np.int32)
    contexts = rs.choice(v, n, p=zipf).astype(np.int32)
    negs = W.AliasTable(zipf ** 0.75).draw(rs, (n, k))
    syn0 = ((rs.rand(v, d) - 0.5) / d).astype(np.float32)
    syn1 = (rs.randn(v, d) * 0.01).astype(np.float32)
    model = make_w2v(seed)
    model.build_vocab([list(range(v))])
    runs = []
    for _ in range(2):
        W.tables_from_numpy(model, syn0, syn1)
        losses = model._run_batched(W._sgns_math, (centers, contexts, negs), W2V_LR)
        runs.append((model.syn0.cpu().double(), model.syn1.cpu().double(),
                     torch.stack(losses).cpu().double()))
    engine, = model._chunk_steps.values()
    if (engine.captures, engine.replays) != (1, 2):
        raise AssertionError(f"word2vec check: {engine.captures} captures, {engine.replays} "
                             "replays for two runs of one chunk")

    def plain(dtype):
        t0, t1 = (torch.from_numpy(a).to(dtype) for a in (syn0, syn1))
        scratch = W.new_scratch(v, d, dtype)
        ls = [W._sgns_math(t0, t1, *(torch.from_numpy(a[i * b:(i + 1) * b])
                                     for a in (centers, contexts, negs)),
                           W2V_LR, scratch) for i in range(ck)]
        return t0.double(), t1.double(), torch.stack(ls).double()

    exact, f32 = plain(torch.float64), plain(torch.float32)

    def dist(a, b_):
        return {name: float((x - y).abs().max()) for name, x, y in
                zip(("syn0", "syn1", "loss"), a, b_)}

    err, spread, f32_err = dist(runs[0], exact), dist(runs[0], runs[1]), dist(f32, exact)
    for name in err:
        tol = W2V_CHECK_FACTOR * max(spread[name], f32_err[name])
        if not err[name] <= tol:
            raise AssertionError(f"word2vec check: card {name} {err[name]} from float64, beyond "
                                 f"{W2V_CHECK_FACTOR} x max(card spread {spread[name]}, "
                                 f"f32 plain {f32_err[name]})")
    out = {"card_vs_float64": err, "card_spread": spread, "f32_plain_vs_float64": f32_err,
           "factor": W2V_CHECK_FACTOR, "steps": ck, "V": v, "D": d, "B": b, "K": k}
    emit("word2vec.check", **out)
    del model, engine
    free_card()
    return out


def w2v_toy_corpus(n=300, seed=0):
    """The JAX tests' two-topic corpus: (cat, dog, pet, fur, meow) and
    (car, road, drive, wheel, fuel), 8 tokens a sentence."""
    rs = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "meow"]
    vehicles = ["car", "road", "drive", "wheel", "fuel"]
    seqs = []
    for _ in range(n):
        pool = animals if rs.rand() < 0.5 else vehicles
        seqs.append([pool[rs.randint(len(pool))] for _ in range(8)])
    return seqs


def silhouette(y, labels):
    """Mean silhouette of the embedding ``y`` [N, 2] over the true labels:
    (b - a) / max(a, b) a point, a its mean distance to its own cluster's
    other points, b to the other clusters' points."""
    d = np.sqrt(((y[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    other = labels[:, None] != labels[None, :]
    a = (d * same).sum(1) / same.sum(1)
    b = (d * other).sum(1) / other.sum(1)
    return float(np.mean((b - a) / np.maximum(a, b)))


def w2v_quality():
    """The toy-topic checks of the JAX package's tests, every trainer on the
    card (``device`` left at its default)."""
    from deeplearning4j_tpu_torch.clustering import KMeans, TSNE
    from deeplearning4j_tpu_torch.graphlib import DeepWalk, Graph
    from deeplearning4j_tpu_torch.text import GloVe, ParagraphVectors, SequenceVectors

    out = {}

    def check(name, ok, **numbers):
        out[name] = numbers
        if not ok:
            raise AssertionError(f"word2vec quality: {name} failed: {numbers}")

    kw = dict(vector_size=16, window=3, min_count=1, epochs=20, learning_rate=0.1,
              batch_size=128, subsample=0)
    sv = SequenceVectors(negative=4, seed=1, **kw).fit(w2v_toy_corpus())
    within, across = sv.similarity("cat", "dog"), sv.similarity("cat", "car")
    engine, = sv._chunk_steps.values()
    check("sgns", within > across + 0.15 and sv.syn0.is_cuda and engine.captures == 1
          and engine.replays >= sv.epochs, within=within, across=across, replays=engine.replays)
    hs = SequenceVectors(use_hierarchic_softmax=True, seed=2, **kw).fit(w2v_toy_corpus(200))
    check("hs", hs.loss_history[-1] < hs.loss_history[0]
          and hs.similarity("cat", "dog") > hs.similarity("cat", "road"),
          first=hs.loss_history[0], last=hs.loss_history[-1],
          cat_dog=hs.similarity("cat", "dog"), cat_road=hs.similarity("cat", "road"))
    cb = SequenceVectors(negative=4, algorithm="cbow", seed=3, **kw).fit(w2v_toy_corpus(200))
    check("cbow", cb.similarity("wheel", "fuel") > cb.similarity("wheel", "meow"),
          wheel_fuel=cb.similarity("wheel", "fuel"), wheel_meow=cb.similarity("wheel", "meow"))
    rs = np.random.RandomState(0)
    docs = [(f"doc{i}", [(["cat", "dog", "pet"] if i % 2 == 0 else ["car", "road", "drive"])
                         [rs.randint(3)] for _ in range(12)]) for i in range(30)]
    pv = ParagraphVectors(vector_size=12, min_count=1, negative=4, epochs=40,
                          learning_rate=0.1, batch_size=128, subsample=0, seed=7)
    pv.fit_documents(docs)
    check("pv_dbow", pv.doc_similarity("doc0", "doc2") > pv.doc_similarity("doc0", "doc1")
          and pv.doc_vectors.is_cuda, same=pv.doc_similarity("doc0", "doc2"),
          diff=pv.doc_similarity("doc0", "doc1"))
    inferred = pv.infer_vector(["cat", "dog", "cat"])
    check("pv_infer", bool(np.isfinite(inferred).all()), norm=float(np.linalg.norm(inferred)))
    g = GloVe(vector_size=12, window=3, min_count=1, epochs=30, learning_rate=0.05, seed=10)
    g.fit(w2v_toy_corpus(200))
    check("glove", g.loss_history[-1] < g.loss_history[0]
          and g.similarity("cat", "dog") > g.similarity("cat", "road"),
          first=g.loss_history[0], last=g.loss_history[-1],
          cat_dog=g.similarity("cat", "dog"), cat_road=g.similarity("cat", "road"))
    bar = Graph(10)
    for i in range(5):
        for j in range(i + 1, 5):
            bar.add_edge(i, j)
            bar.add_edge(i + 5, j + 5)
    bar.add_edge(4, 5)
    dw = DeepWalk(vector_size=16, window=3, walk_length=20, walks_per_vertex=8, epochs=30,
                  learning_rate=0.2, use_hierarchic_softmax=True, seed=4).fit(bar)
    check("deepwalk", dw.similarity(0, 1) > dw.similarity(0, 9),
          within=dw.similarity(0, 1), across=dw.similarity(0, 9))
    rs = np.random.RandomState(0)  # the JAX tests' points
    pts = np.concatenate([rs.randn(50, 3) + [10, 0, 0], rs.randn(50, 3) + [-10, 0, 0],
                          rs.randn(50, 3) + [0, 10, 0]])
    km = KMeans(3, seed=1).fit(pts)
    check("kmeans", all(len(np.unique(km.labels_[i:i + 50])) == 1 for i in (0, 50, 100))
          and len(np.unique(km.labels_)) == 3 and km.inertia_ < 1000, inertia=km.inertia_)
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(30, 10) + 8, rs.randn(30, 10) - 8])
    ts = TSNE(perplexity=10, n_iter=300, learning_rate=50, seed=3)
    y = ts.fit_transform(x)
    sil = silhouette(y, np.repeat([0, 1], 30))
    check("tsne", y.shape == (60, 2) and sil > W2V_TSNE_SILHOUETTE
          and ts.kl_history[-1] < ts.kl_history[0], silhouette=sil,
          kl_first=ts.kl_history[0], kl_last=ts.kl_history[-1])
    emit("word2vec.quality", **out)
    free_card()
    return out


def w2v_mesh_model(seed, **kw):
    """The production model's settings at the mesh cell's slice, its
    negatives the host alias draws of one ``RandomState(seed)`` (the same
    on every rank and at world 1)."""
    from deeplearning4j_tpu_torch.text.word2vec import SequenceVectors

    m = SequenceVectors(vector_size=W2V_DIM, window=W2V_WINDOW, min_count=1,
                        negative=W2V_NEGATIVE, epochs=1, seed=seed, batch_size=W2V_BATCH,
                        subsample=W2V_SUBSAMPLE, learning_rate=W2V_LR, device="cuda", **kw)
    rs = np.random.RandomState(seed)
    m._draw_negatives = lambda shape: m._neg_alias.draw(rs, shape)
    return m


def w2v_mesh_vocab(model, vocab):
    """``model``'s vocabulary and tables built from ``vocab`` (a path to,
    or the dict of, the whole corpus's distinct words and their counts:
    ``build_vocab``'s flat-corpus entry, one ``np.unique`` of the corpus
    instead of one a model)."""
    from deeplearning4j_tpu_torch.text.vocab import FlatCorpus

    v = np.load(vocab) if isinstance(vocab, str) else vocab
    return model.build_vocab(None, _flat=FlatCorpus(v["words"].tolist(), None, v["counts"],
                                                     None))


def w2v_mesh_fit(model, sents):
    """(seconds, steps) of one fit, on the host clock to a synchronize;
    steps counted at the update functions' one entry a batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(sents)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, len(model.loss_history)


def w2v_mesh_rank(rank, world, seed, corpus, vocab, world1):
    """One rank of the mesh cell: the replicated-table fit and the
    table-sharded fit of their slices on a data=4 mesh, each on the
    vocabulary of the whole corpus and against the world-1 tables (rank 0
    compares)."""
    import faulthandler

    from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh

    faulthandler.dump_traceback_later(W2V_MESH_TIMEOUT_S - 60, exit=True)
    sents = np.load(corpus).tolist()
    mesh = make_mesh(MeshSpec(data=world))
    refs = ({k: v.numpy() for k, v in torch.load(world1, weights_only=True).items()}
            if rank == 0 else None)
    row = {"rank": rank}
    for name, kw, n in (("replicated", {}, W2V_MESH_WORDS),
                        ("sharded", {"shard_tables": True}, W2V_SHARD_WORDS)):
        m = w2v_mesh_vocab(w2v_mesh_model(seed, mesh=mesh, **kw), vocab)
        part = sents[:n // W2V_SENT_LEN]
        secs, steps = w2v_mesh_fit(m, part)
        syn0, syn1 = m.whole_tables()
        cell = {"words": n, "fit_s": secs, "steps": steps,
                "examples_dropped": m.examples_dropped, "vocab": len(m.vocab),
                "table_rows_here": int(m.syn0.shape[0]), "words_per_s": n / secs,
                "words_per_s_a_rank": n / secs / world,
                "loss_last": float(m.loss_history[-1])}
        if refs is not None:
            # the replicated fit cuts its ragged tail: the world-1 fit of the same pairs
            ref = {t: refs[("cut_" if name == "replicated" else "") + t] for t in ("syn0", "syn1")}
            v = len(m.vocab)
            cell["syn0_max_abs"] = float(np.abs(syn0[:v] - ref["syn0"]).max())
            cell["syn1_max_abs"] = float(np.abs(syn1[:v] - ref["syn1"][:v]).max())
            cell["syn0_rel_excess"] = float((np.abs(syn0[:v] - ref["syn0"])
                                             - W2V_SHARD_RTOL * np.abs(ref["syn0"])).max())
            cell["syn1_rel_excess"] = float((np.abs(syn1[:v] - ref["syn1"][:v])
                                             - W2V_SHARD_RTOL * np.abs(ref["syn1"][:v])).max())
        row[name] = cell
        del m
        free_card()
    faulthandler.cancel_dump_traceback_later()
    return row


def w2v_nccl_rank(rank, world, seed, corpus, vocab, world1):
    """The mesh trainers at world 1 over NCCL: the sharded slice fitted
    with replicated tables and with ``shard_tables=True``, each chunk
    captured into its CUDA graph with its collectives (the all-gathers of
    the exchange, the shard's all-reduce). Returns each fit's captures,
    eager chunk engines and distance from the world-1 tables."""
    from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh

    sents = np.load(corpus).tolist()
    mesh = make_mesh(MeshSpec(data=world))
    ref = {k: v.numpy() for k, v in torch.load(world1, weights_only=True).items()}
    row = {}
    for name, kw in (("replicated", {}), ("sharded", {"shard_tables": True})):
        m = w2v_mesh_vocab(w2v_mesh_model(seed, mesh=mesh, **kw), vocab)
        secs, steps = w2v_mesh_fit(m, sents[:W2V_SHARD_WORDS // W2V_SENT_LEN])
        engines = list(m._chunk_steps.values())
        syn0, syn1 = m.whole_tables()
        v = len(m.vocab)
        row[name] = {"fit_s": secs, "steps": steps, "vocab": v,
                     "captures": sum(e.captures for e in engines),
                     "eager_engines": sum(e.eager for e in engines),
                     "syn0_max_abs": float(np.abs(syn0[:v] - ref["syn0"]).max()),
                     "syn1_max_abs": float(np.abs(syn1[:v] - ref["syn1"][:v]).max())}
        del m
        free_card()
    return row


def w2v_mesh(seed):
    """SequenceVectors(mesh=) at full width over 4 gloo ranks on the one
    card: every model's vocabulary and tables built on the phase's whole
    corpus, then world-1 fits of the slices (the sharded slice's twice: its
    distance from itself sets the card's noise), then the replicated-table
    and table-sharded fits of the same slices with the same negatives
    (a cell of the one spawn of ranks, ``run_rank_cells``), held to the
    world-1 tables; words/s and the bytes a rank puts into the collectives
    a step. Registers the cell; its line comes after the spawn."""
    corpus = np.asarray(w2v_corpus(seed), np.int64)  # the phase's: the vocabulary's
    words, counts = np.unique(corpus, return_counts=True)
    vocab = {"words": words, "counts": counts}
    sents = corpus[:W2V_MESH_WORDS // W2V_SENT_LEN].tolist()
    shard_sents = sents[:W2V_SHARD_WORDS // W2V_SENT_LEN]
    work = RANKS_WORK / "w2v_mesh"
    work.mkdir(parents=True)
    one = []
    for cut, part in ((False, shard_sents), (False, shard_sents), (True, sents)):
        m = w2v_mesh_vocab(w2v_mesh_model(seed), vocab)
        if cut:
            def run(math_fn, arrays, lr, run=m._run_batched):
                n = len(arrays[0]) // W2V_MESH_RANKS * W2V_MESH_RANKS
                return run(math_fn, tuple(a[:n] for a in arrays), lr)
            m._run_batched = run
        secs, steps = w2v_mesh_fit(m, part)
        one.append({"syn0": m.syn0.cpu().numpy().copy(), "syn1": m.syn1.cpu().numpy().copy(),
                    "fit_s": secs, "steps": steps, "vocab": len(m.vocab)})
        del m
        free_card()
    noise = max(float(np.abs(one[0][k] - one[1][k]).max()) for k in ("syn0", "syn1"))
    np.save(work / "corpus.npy", np.asarray(sents, np.int64))
    np.savez(work / "vocab.npz", **vocab)
    torch.save({**{k: torch.from_numpy(one[0][k]) for k in ("syn0", "syn1")},
                **{"cut_" + k: torch.from_numpy(one[2][k]) for k in ("syn0", "syn1")}},
               work / "world1.pt")
    add_rank_cell("word2vec.mesh", W2V_MESH_RANKS, W2V_MESH_TIMEOUT_S,
                  dict(seed=seed, corpus=str(work / "corpus.npy"), vocab=str(work / "vocab.npz"),
                       world1=str(work / "world1.pt")),
                  lambda ranks, ranks_s: w2v_mesh_finish(seed, work, one, noise, counts, ranks,
                                                         ranks_s))


def w2v_mesh_finish(seed, work, one, noise, counts, ranks, ranks_s):
    """The mesh cell after the spawn: the world-1 NCCL fits, the checks
    of the ranks' tables, the ``word2vec.mesh`` line."""
    from deeplearning4j_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    nccl = run_ranks(w2v_nccl_rank, 1, work / "nccl", backend="nccl", device=0,
                     timeout=W2V_MESH_TIMEOUT_S, seed=seed,
                     corpus=str(work / "corpus.npy"), vocab=str(work / "vocab.npz"),
                     world1=str(work / "world1.pt"))[0]
    nccl_s = time.perf_counter() - t0
    for name, cell in nccl.items():
        if cell["captures"] < 1 or cell["eager_engines"]:
            raise AssertionError(f"word2vec mesh over NCCL ({name}): {cell['captures']} "
                                 f"captures, {cell['eager_engines']} eager chunk engines")
        if not max(cell["syn0_max_abs"], cell["syn1_max_abs"]) <= max(
                W2V_MESH_ATOL, W2V_CHECK_FACTOR * noise):
            raise AssertionError(f"word2vec mesh over NCCL ({name}): tables off world 1 by "
                                 f"{cell['syn0_max_abs']}, {cell['syn1_max_abs']}")
    r0 = ranks[0]
    rep = r0["replicated"]
    if not max(rep["syn0_max_abs"], rep["syn1_max_abs"]) <= max(W2V_MESH_ATOL,
                                                                 W2V_CHECK_FACTOR * noise):
        raise AssertionError(f"word2vec mesh: replicated tables off world 1 by "
                             f"{rep['syn0_max_abs']}, {rep['syn1_max_abs']}")
    if not rep["examples_dropped"] <= W2V_MESH_RANKS - 1:
        raise AssertionError(f"word2vec mesh: {rep['examples_dropped']} pairs dropped, at most "
                             f"{W2V_MESH_RANKS - 1} an epoch")
    sh = r0["sharded"]
    if not (max(sh["syn0_rel_excess"], sh["syn1_rel_excess"]) <= W2V_SHARD_ATOL
            or max(sh["syn0_max_abs"], sh["syn1_max_abs"]) <= W2V_CHECK_FACTOR * noise):
        raise AssertionError(f"word2vec mesh: sharded tables off world 1 by "
                             f"{sh['syn0_max_abs']}, {sh['syn1_max_abs']}")
    v = one[0]["vocab"]
    vp = -(-v // W2V_MESH_RANKS) * W2V_MESH_RANKS
    if any(rk[c]["vocab"] != v for rk in ranks for c in ("replicated", "sharded")):
        raise AssertionError("word2vec mesh: a rank built another vocabulary than world 1")
    if any(rk["sharded"]["table_rows_here"] != vp // W2V_MESH_RANKS for rk in ranks):
        raise AssertionError("word2vec mesh: a rank holds another number of rows than V/n")
    b, k, d, n = W2V_BATCH, W2V_NEGATIVE, W2V_DIM, W2V_MESH_RANKS
    out = {"words": {"replicated": W2V_MESH_WORDS, "sharded": W2V_SHARD_WORDS}, "ranks": n,
           "vocab": v, "vocab_corpus_words": int(counts.sum()),
           "sharded_rows_a_rank": vp // n,
           "world1_fit_s": {"sharded_slice": [o["fit_s"] for o in one[:2]],
                            "replicated_slice_cut": one[2]["fit_s"]},
           "world1_steps": {"sharded_slice": one[0]["steps"], "replicated_slice": one[2]["steps"]},
           "world1_words_per_s": W2V_MESH_WORDS / one[2]["fit_s"],
           "world1_self_distance": noise, "ranks_seconds": ranks_s,
           "nccl_world1": {"seconds": nccl_s, **nccl},
           # the bytes a rank puts into the collectives of one step: the
           # all-gathered (indices, gradients) of both tables' updates and
           # the loss's all-reduce; sharded, the all-reduced row gathers
           "replicated_bytes_a_step_a_rank": (b // n) * (2 + k) * (8 + 4 * d) + 4,
           "sharded_bytes_a_step_a_rank": 4 * b * d * (2 + k),
           "replicated": [{"rank": rk["rank"], **rk["replicated"]} for rk in ranks],
           "sharded": [{"rank": rk["rank"], **rk["sharded"]} for rk in ranks],
           "card": card_line()}
    emit("word2vec.mesh", **out)
    shutil.rmtree(work, ignore_errors=True)
    free_card()
    return out


def phase_word2vec(seed):
    """BASELINE config 3 on the card: the full-width chunk check, the
    production fit, the toy-topic quality checks of every NLP trainer, and
    the world-1 side of the mesh trainers' cell (its 4 ranks run in the
    one spawn, ``run_rank_cells``)."""
    check = w2v_chunk_check(seed)
    fit = w2v_production(seed)
    quality = w2v_quality()
    w2v_mesh(seed)
    return {"check": check, "fit": fit, "quality": quality, "card": card_line()}


# ---------------------------------------------------------------------------
# mnist: BASELINE config 1 through DL4J's MNIST workflow (fetcher,
# normalizer, fit, evaluate, save with the normalizer, CSV evaluation),
# the memory report, quantized inference, the VAE and AutoEncoder
# pretraining, the full-batch solvers and the new layers on the card
# ---------------------------------------------------------------------------

def mnist_write_idx(path, arr, gz=False):
    """An IDX file as MNIST ships it: the big-endian header (0, dtype code
    0x08 for uint8, rank, dims) then the bytes; gzipped with ``gz``."""
    header = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    if gz:
        with gzip.open(str(path) + ".gz", "wb", compresslevel=1) as f:
            f.write(header + arr.tobytes())
    else:
        pathlib.Path(path).write_bytes(header + arr.tobytes())


def mnist_files(root, seed):
    """MNIST-format files at MNIST's size under ``root``/mnist: 10 class
    templates (random 7x7 stroke grids blown up to 28x28) with pixel noise
    and a random shift, uint8; the training split gzipped, the test split
    raw. Returns the seconds taken."""
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    templates = np.kron(rs.rand(10, 7, 7) > 0.6, np.ones((4, 4))).astype(np.float32) * 255.0
    d = root / "mnist"
    d.mkdir(parents=True)
    for prefix, n, gz in (("train", MN_TRAIN, True), ("t10k", MN_TEST, False)):
        labels = rs.randint(0, 10, n).astype(np.uint8)
        img = templates[labels] * MN_TEMPLATE_GAIN
        img += rs.randn(n, 28, 28).astype(np.float32) * MN_PIXEL_NOISE
        shifts = rs.randint(-MN_MAX_SHIFT, MN_MAX_SHIFT + 1, (n, 2))
        for dy in range(-MN_MAX_SHIFT, MN_MAX_SHIFT + 1):
            for dx in range(-MN_MAX_SHIFT, MN_MAX_SHIFT + 1):
                sel = (shifts[:, 0] == dy) & (shifts[:, 1] == dx)
                img[sel] = np.roll(img[sel], (dy, dx), axis=(1, 2))
        img = np.clip(img, 0, 255).astype(np.uint8)
        mnist_write_idx(d / f"{prefix}-images-idx3-ubyte", img, gz)
        mnist_write_idx(d / f"{prefix}-labels-idx1-ubyte", labels, gz)
    return time.perf_counter() - t0


class NormalizedIterator:
    """A DataSetIterator's batches with the fitted normalizer applied on
    the host, as DL4J's ``iterator.setPreProcessor(normalizer)``."""

    def __init__(self, base, norm):
        self.base, self.norm = base, norm

    def __iter__(self):
        from deeplearning4j_tpu_torch.datasets.iterator import DataSet

        for ds in self.base:
            yield DataSet(self.norm.transform(ds.features), ds.labels)


def mnist_family(name):
    if any(s in name for s in ("conv", "cudnn", "gemm", "cutlass", "xmma", "sm90", "wgrad",
                               "dgrad", "implicit", "winograd", "fft")):
        return "library_conv_gemm"
    return "elementwise_other"


def mnist_data(seed):
    """The phase's data directory: files written, read back through the
    port's fetcher, the normalizer fitted streaming over 235 batches and
    held against a one-shot float64 fit."""
    from deeplearning4j_tpu_torch.datasets import fetchers as F
    from deeplearning4j_tpu_torch.datasets.normalizers import NormalizerStandardize

    root = WORK / "data"
    write_s = mnist_files(root, seed)
    os.environ["DL4J_TPU_DATA_DIR"] = str(root)
    t0 = time.perf_counter()
    train_it = F.mnist_iterator(batch_size=MN_BATCH)
    test_it = F.mnist_iterator(batch_size=MN_BATCH, train=False, shuffle=False)
    read_s = time.perf_counter() - t0
    if train_it.features.shape != (MN_TRAIN, 28, 28, 1) or test_it.features.shape != (
            MN_TEST, 28, 28, 1):
        raise AssertionError(f"fetcher shapes {train_it.features.shape} {test_it.features.shape}")
    seen = []
    t0 = time.perf_counter()
    norm = NormalizerStandardize().fit_iterator(
        (seen.append(ds.features.shape[0]) or ds) for ds in train_it)
    fit_s = time.perf_counter() - t0
    if len(seen) != -(-MN_TRAIN // MN_BATCH) or seen[-1] != MN_TRAIN % MN_BATCH:
        raise AssertionError(f"normalizer fit saw {len(seen)} batches, the last of {seen[-1]}")
    flat = train_it.features.astype(np.float64).reshape(-1, 1)
    one_shot = (flat.mean(0), flat.std(0))
    mean_err = float(np.abs(norm.mean - one_shot[0]).max() / np.abs(one_shot[0]).max())
    std_err = float(np.abs(norm.std - one_shot[1]).max() / np.abs(one_shot[1]).max())
    if not (mean_err <= MN_NORM_RTOL and std_err <= MN_NORM_RTOL):
        raise AssertionError(f"streaming fit off the one-shot float64 fit: {mean_err}, {std_err}")
    t0 = time.perf_counter()
    batches = sum(1 for _ in NormalizedIterator(train_it, norm))
    host_ms = 1e3 * (time.perf_counter() - t0) / batches
    return train_it, test_it, norm, {
        "write_s": write_s, "read_s": read_s, "normalizer_fit_s": fit_s,
        "normalizer_mean": norm.mean.tolist(), "normalizer_std": norm.std.tolist(),
        "normalizer_rel_err_vs_one_shot_f64": [mean_err, std_err],
        "host_fetch_normalize_ms_a_batch": host_ms, "batches": batches}


def mnist_net(seed):
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(lenet(seed=seed), device="cuda")
    net.init()
    if net.num_params() != MN_PARAMS:
        raise AssertionError(f"LeNet has {net.num_params()} params, not {MN_PARAMS}")
    return net


def mnist_train(train_it, test_it, norm, seed, policy):
    """One epoch of ``fit`` over the normalized iterator (the last batch
    ragged), timed on the host clock with the fetch and the normalization;
    5 more steps profiled; ``evaluate`` over the test iterator."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.utils import dtypes

    (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
    try:
        warm = mnist_net(seed)  # cuDNN's handles and plans, outside the timed epoch
        warm.fit(iter(list(itertools.islice(NormalizedIterator(train_it, norm), 2))))
        del warm
        net = mnist_net(seed)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # earlier phases' leftovers are not the epoch's
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net.fit(NormalizedIterator(train_it, norm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        losses = net.score_history
        first = float(np.mean(losses[:MN_LOSS_WINDOW]))
        last = float(np.mean(losses[-MN_LOSS_WINDOW:]))
        if len(losses) != -(-MN_TRAIN // MN_BATCH) or not np.all(np.isfinite(losses)) \
                or not last < first:
            raise AssertionError(f"LeNet {policy}: {len(losses)} steps, loss {first} -> {last}")
        batches = list(itertools.islice(NormalizedIterator(train_it, norm), MN_PROFILED_STEPS))
        net.fit(iter(batches[:1]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit(iter(batches))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_family, busy_ms, share = device_families(prof, wall_ms, mnist_family)
        t0 = time.perf_counter()
        ev = net.evaluate(NormalizedIterator(test_it, norm))
        eval_s = time.perf_counter() - t0
        if not ev.accuracy() >= MN_MIN_ACCURACY:
            raise AssertionError(f"LeNet {policy}: test accuracy {ev.accuracy()}")
        return net, ev, {
            "policy": policy, "params": net.num_params(), "batch": MN_BATCH,
            "steps": len(losses), "epoch_s": wall, "images_per_s": MN_TRAIN / wall,
            "step_ms": 1e3 * wall / len(losses), "peak_mem_gb": peak / 1e9,
            f"loss_first{MN_LOSS_WINDOW}": first, f"loss_last{MN_LOSS_WINDOW}": last,
            "profiled_steps": MN_PROFILED_STEPS, "profiled_wall_ms": wall_ms,
            "device_ms_by_family": by_family, "device_busy_ms": busy_ms,
            "device_busy_share": share, "test_accuracy": ev.accuracy(), "eval_s": eval_s}
    finally:
        dtypes.f32_policy()


def mnist_outputs(fn, test_it, norm):
    """``fn``'s outputs over the normalized test set, in the iterator's
    order and batches."""
    return torch.cat([fn(ds.features) for ds in NormalizedIterator(test_it, norm)])


def mnist_save_and_csv(net, ev, test_it, norm):
    """save_model + add_normalizer_to_model, load_model on the card +
    restore_normalizer: the restored net answers the test set exactly as
    the trained one; the normalized test set as a labelled CSV through the
    ``eval`` verb agrees with ``evaluate`` count for count. The verb's
    process runs while the phase goes on: returns (restored, a function
    that waits for it and returns the row)."""
    import threading

    from deeplearning4j_tpu_torch.utils import serialization as S

    path = WORK / "lenet_mnist.zip"
    S.save_model(net, str(path))
    S.add_normalizer_to_model(str(path), norm)
    restored = S.load_model(str(path), device="cuda")
    norm2 = S.restore_normalizer(str(path))
    if not (np.array_equal(norm2.mean, norm.mean) and np.array_equal(norm2.std, norm.std)):
        raise AssertionError("the restored normalizer differs")
    want = mnist_outputs(net.output, test_it, norm2)
    got = mnist_outputs(restored.output, test_it, norm2)
    if not torch.equal(got, want):
        raise AssertionError(f"restored outputs differ by {(got - want).abs().max().item()}")
    t0 = time.perf_counter()
    rows = np.concatenate([norm.transform(ds.features).reshape(ds.features.shape[0], -1)
                           for ds in test_it])
    labels = test_it.labels.argmax(-1)
    csv = WORK / "mnist_test.csv"
    np.savetxt(csv, np.concatenate([rows, labels[:, None]], 1),
               fmt=["%.9g"] * rows.shape[1] + ["%d"], delimiter=",")
    csv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "eval", "--model-path", str(path),
         "--data", str(csv), "--label-column", "784", "--n-classes", "10",
         "--batch-size", str(MN_BATCH)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def wait():
        done["out"] = proc.communicate(timeout=600)
        done["cli_s"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()

    def finish():
        waiter.join(610)
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        out, err = done.get("out", ("", "timed out"))
        if proc.returncode != 0:
            raise AssertionError(f"eval verb failed:\n{err[-4000:]}")
        if ev.stats() not in out:
            raise AssertionError(f"eval verb's statistics differ from evaluate's:\n{out}\n"
                                 f"---\n{ev.stats()}")
        return {"zip_mb": path.stat().st_size / 1e6, "csv_mb": csv.stat().st_size / 1e6,
                "csv_write_s": csv_s, "cli_s": done["cli_s"], "cli_concurrent": True,
                "accuracy": ev.accuracy(), "correct": int(round(ev.accuracy() * MN_TEST))}

    return restored, finish


def mnist_memory(seed, x, y):
    """memory_report's training estimate at batch 256 against the card's
    peak over one step of a fresh LeNet (its updater state made by a step
    before)."""
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.conf.memory import memory_report

    rep = memory_report(lenet(seed=seed))
    if rep.total_param_count != MN_PARAMS:
        raise AssertionError(f"memory_report counts {rep.total_param_count} params")
    free_card()
    base = torch.cuda.memory_allocated()
    net = mnist_net(seed)
    net.fit(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    net.fit(x, y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    est = rep.total_memory_bytes(MN_BATCH, training=True)
    del net
    return {"total_param_count": rep.total_param_count,
            "estimate_train_bytes": est, "measured_peak_bytes": peak,
            "measured_over_estimate": peak / est,
            "estimate_infer_bytes": rep.total_memory_bytes(MN_BATCH, training=False)}


def mnist_quantized(net, ev, test_it, norm):
    """QuantizedInference on the card over the test set against the f32
    net: weight bytes at rest, accuracy, the largest probability change,
    ms a forward at batch 256 and one call's peak beside the resident
    bytes."""
    from deeplearning4j_tpu_torch.eval.classification import Evaluation
    from deeplearning4j_tpu_torch.utils import quantization as Q
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    qi = Q.QuantizedInference(net)
    f32 = mnist_outputs(net.output, test_it, norm)
    q = mnist_outputs(qi.output, test_it, norm)
    qev = Evaluation()
    qev.eval(test_it.labels, q.cpu().numpy())
    int8_bytes = Q.weight_bytes(qi.qparams)
    scale_bytes = sum(s.numel() * s.element_size() for s in tree_leaves(qi.scales)
                      if torch.is_tensor(s))
    f32_bytes = Q.weight_bytes(net.params)
    if not abs(qev.accuracy() - ev.accuracy()) <= MN_QUANT_ACCURACY_DROP:
        raise AssertionError(f"quantized accuracy {qev.accuracy()} vs f32 {ev.accuracy()}")
    xb = torch.from_numpy(norm.transform(test_it.features[:MN_BATCH])).cuda()
    q_ms = time_ms(lambda: qi.output(xb), iters=20, reps=5)
    f_ms = time_ms(lambda: net.output(xb), iters=20, reps=5)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    qi.output(xb)
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - before
    return {"weight_bytes_f32": f32_bytes, "weight_bytes_int8": int8_bytes,
            "scale_bytes": scale_bytes, "at_rest_ratio": (int8_bytes + scale_bytes) / f32_bytes,
            "accuracy_f32": ev.accuracy(), "accuracy_int8": qev.accuracy(),
            "max_prob_diff": (q - f32).abs().max().item(),
            "argmax_agreement": (q.argmax(-1) == f32.argmax(-1)).float().mean().item(),
            "ms_a_forward_int8": q_ms, "ms_a_forward_f32": f_ms,
            "call_peak_bytes_above_resident": call_peak}


def flat_diff(a, b):
    """How far step ``a`` is from step ``b``, each (loss, [gradients],
    [parameters after the update]): the loss's relative difference, the
    gradients' relative difference (all together), the parameters' largest
    difference and the elements beyond MN_PARAM_ATOL."""
    ga, gb = (torch.cat([t.reshape(-1).double().cpu() for t in s[1]]) for s in (a, b))
    pa, pb = (torch.cat([t.reshape(-1).double().cpu() for t in s[2]]) for s in (a, b))
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "grad_rel": ((ga - gb).norm() / gb.norm()).item(),
            "param_max_abs": (pa - pb).abs().max().item(),
            "params_beyond_atol": int(((pa - pb).abs() > MN_PARAM_ATOL).sum())}


def held_to_noise(what, k_r, samples):
    """Hold the card's step (``k_r``: flat_diff from float64) within
    MN_NOISE_FACTOR x the f32 noise (the largest of ``samples``, each a
    flat_diff of an f32 step from its reference), plus MN_SIGN_FLIPS
    parameters for near-zero gradients whose sign rounds either way."""
    noise = {m: max(s[m] for s in samples.values()) for m in k_r}
    # the loss is one number: its f32 noise is at least one ulp
    noise["loss_rel"] = max(noise["loss_rel"], F32_ULP)
    for m in ("loss_rel", "grad_rel", "param_max_abs"):
        if not k_r[m] <= MN_NOISE_FACTOR * noise[m]:
            raise AssertionError(f"{what}: {m} {k_r[m]} beyond {MN_NOISE_FACTOR} x the f32 noise "
                                 f"{noise[m]} ({samples})")
    if not k_r["params_beyond_atol"] <= MN_NOISE_FACTOR * noise["params_beyond_atol"] + \
            MN_SIGN_FLIPS:
        raise AssertionError(f"{what}: {k_r['params_beyond_atol']} parameters beyond "
                             f"{MN_PARAM_ATOL}, noise {noise['params_beyond_atol']}")
    return {"card_f32_vs_cpu_f64": k_r, **samples, "noise": noise}


def vae_step(vae, params, x, eps, upd):
    """One pretraining step from ``params`` (copied): (-ELBO, gradients,
    parameters after the updater's first step)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = vae.pretrain_loss(p, x, eps=eps)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    upd.update_(p, grads, upd.init(p), 0)
    return loss.item(), list(grads.values()), [t.detach() for t in p.values()]


def mnist_pixels(train):
    """The raw IDX pixels [N, 784] through ImagePreProcessingScaler: [0, 1]."""
    from deeplearning4j_tpu_torch.datasets import fetchers as F
    from deeplearning4j_tpu_torch.datasets.normalizers import ImagePreProcessingScaler

    prefix = "train" if train else "t10k"
    raw = F._read_idx(F.MnistDataFetcher._find(str(WORK / "data" / "mnist"),
                                               f"{prefix}-images-idx3-ubyte"))
    return ImagePreProcessingScaler().transform(raw.reshape(raw.shape[0], -1).astype(np.float32))


def pretrain_epoch(layer, params, upd, x, batch, gen):
    """One epoch of ``layer.pretrain_loss`` through autograd and ``upd``,
    draws from ``gen``: (per-step losses, ms a step)."""
    from deeplearning4j_tpu_torch.utils.hostsync import fetch_losses

    opt = upd.init(params)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, s in enumerate(range(0, x.shape[0], batch)):
        for p in params.values():
            p.requires_grad_(True)
        loss = layer.pretrain_loss(params, x[s:s + batch], gen)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        upd.update_(params, grads, opt, i)
        losses.append(loss.detach())
    torch.cuda.synchronize()
    return fetch_losses(losses), 1e3 * (time.perf_counter() - t0) / len(losses)


def mnist_vae(seed, x_train, x_test):
    """dl4j-examples' VariationalAutoEncoderExample at its widths: one
    epoch of -ELBO pretraining, reconstruction_probability on 1,000 test
    images, generate_at_mean over a grid, and one step from identical
    weights held against float64 on the CPU."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I

    vae = L.VariationalAutoencoder(n_latent=2, encoder_layer_sizes=(256, 256),
                                   decoder_layer_sizes=(256, 256), reconstruction="bernoulli",
                                   activation="leakyrelu", weight_init="xavier")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = vae.init(gen, I.FeedForwardType(784))
    n_params = sum(p.numel() for p in params.values())
    if n_params != VAE_PARAMS:
        raise AssertionError(f"the VAE has {n_params} params, not {VAE_PARAMS}")
    upd = U.RmsProp(learning_rate=VAE_LR)
    check = vae_step_check(vae, params, x_train[:VAE_BATCH], upd, seed)
    losses, ms = pretrain_epoch(vae, params, upd, x_train, VAE_BATCH, gen)
    first = float(np.mean(losses[:MN_LOSS_WINDOW]))
    last = float(np.mean(losses[-MN_LOSS_WINDOW:]))
    if len(losses) != -(-MN_TRAIN // VAE_BATCH) or not np.all(np.isfinite(losses)) \
            or not last < first:
        raise AssertionError(f"VAE: {len(losses)} steps, -ELBO {first} -> {last}")
    with torch.no_grad():
        logp = vae.reconstruction_probability(params, x_test[:VAE_SCORED], gen)
        axis = torch.linspace(-2.0, 2.0, VAE_GRID, device="cuda")
        grid = torch.stack(torch.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
        images = vae.generate_at_mean(params, grid)
    if not (logp.shape == (VAE_SCORED,) and torch.isfinite(logp).all() and (logp < 0).all()):
        raise AssertionError("reconstruction_probability is not a finite log-probability")
    if not (images.shape == (VAE_GRID ** 2, 784) and images.min() >= 0 and images.max() <= 1):
        raise AssertionError("generate_at_mean left [0, 1]")
    return {"params": n_params, "batch": VAE_BATCH, "steps": len(losses), "step_ms": ms,
            f"neg_elbo_first{MN_LOSS_WINDOW}": first, f"neg_elbo_last{MN_LOSS_WINDOW}": last,
            "reconstruction_log_prob_mean": logp.mean().item(),
            "grid_images": list(images.shape), "step_check": check}


def vae_step_check(vae, params, x, upd, seed):
    """One step on the card (f32) from ``params`` with injected eps, held
    against the same step in float64 on the CPU within the f32 noise: the
    step in f32 on the CPU, and the card's step on the batch permuted (the
    eps rows with it)."""
    eps = [torch.randn((x.shape[0], vae.n_latent), generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)]
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(seed + 1))
    cpu = {k: v.detach().cpu() for k, v in params.items()}
    r = vae_step(vae, {k: v.double() for k, v in cpu.items()}, x.cpu().double(), eps, upd)
    k = vae_step(vae, params, x, [eps[0].float().cuda()], upd)
    p = vae_step(vae, cpu, x.cpu(), [eps[0].float()], upd)
    q = vae_step(vae, params, x[perm.cuda()], [eps[0][perm].float().cuda()], upd)
    return held_to_noise("VAE step", flat_diff(k, r), {
        "cpu_f32_vs_cpu_f64": flat_diff(p, r), "card_f32_permuted_vs_card_f32": flat_diff(q, k)})


def mnist_autoencoder(seed, x_train):
    """The AutoEncoder layer of dl4j-examples' MNIST anomaly example's first
    layer (784 -> 250), corruption 0.3, sigmoid, MSE, AdaGrad 0.05: one
    epoch of pretraining."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I

    ae = L.AutoEncoder(n_out=AE_HIDDEN, corruption_level=0.3, activation="sigmoid", loss="mse")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = ae.init(gen, I.FeedForwardType(784))
    losses, ms = pretrain_epoch(ae, params, U.AdaGrad(learning_rate=AE_LR), x_train, VAE_BATCH,
                                gen)
    first = float(np.mean(losses[:MN_LOSS_WINDOW]))
    last = float(np.mean(losses[-MN_LOSS_WINDOW:]))
    if not np.all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"AutoEncoder: loss {first} -> {last}")
    return {"params": sum(p.numel() for p in params.values()), "steps": len(losses),
            "step_ms": ms, f"loss_first{MN_LOSS_WINDOW}": first,
            f"loss_last{MN_LOSS_WINDOW}": last}


@contextlib.contextmanager
def counted_syncs():
    """Count the host's waits on the card inside the block (CUDA's
    sync-debug warnings, one a synchronizing call)."""
    import warnings

    box = {"n": 0}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield box
        box["n"] = sum("synchronizing" in str(w.message) for w in seen)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def mnist_solvers(seed, x, y):
    """Solver(net, "lbfgs") and Solver(net, "conjugate_gradient") full batch
    on LeNet over SOLVER_N images, SOLVER_ITERS iterations each: the loss
    falls; ms and counted host syncs an iteration."""
    from deeplearning4j_tpu_torch.nn.solvers import DEFAULT_LS_ITERATIONS, Solver

    out = {}
    xs, ys = torch.from_numpy(x[:SOLVER_N]).cuda(), torch.from_numpy(y[:SOLVER_N]).cuda()
    for algo in ("lbfgs", "conjugate_gradient"):
        # cuDNN's plans and the allocator's blocks at this batch, outside the count
        Solver(mnist_net(seed), algo, max_iterations=1, tolerance=0.0).optimize(xs, ys)
        net = mnist_net(seed)
        before = net.score(xs, ys)
        solver = Solver(net, algo, max_iterations=SOLVER_ITERS, tolerance=0.0)
        torch.cuda.synchronize()
        with counted_syncs() as syncs:
            t0 = time.perf_counter()
            score = solver.optimize(xs, ys)
            wall = time.perf_counter() - t0  # optimize ends on its score's read
        # the design: one read of the score an iteration, and the first one
        if syncs["n"] != SOLVER_ITERS + 1:
            raise AssertionError(f"{algo}: {syncs['n']} host syncs in {SOLVER_ITERS} iterations")
        if not (np.isfinite(score) and score < before) or net.iteration != SOLVER_ITERS:
            raise AssertionError(f"{algo}: loss {before} -> {score} in {net.iteration}")
        out[algo] = {"images": SOLVER_N, "iterations": net.iteration, "loss_before": before,
                     "loss_after": score, "ms_an_iteration": 1e3 * wall / SOLVER_ITERS,
                     "host_syncs": syncs["n"],
                     "host_syncs_an_iteration": (syncs["n"] - 1) / SOLVER_ITERS,
                     "ls_forwards_an_iteration": DEFAULT_LS_ITERATIONS}
        del net
    out["iteration_check"] = solver_iteration_check(seed, x[:SOLVER_CHECK_BATCH],
                                                    y[:SOLVER_CHECK_BATCH])
    return out


def solver_iteration(net, x, y):
    """LBFGS's first iteration on ``net``: (loss, [gradient], [parameters
    after the step]) and the accepted step."""
    from deeplearning4j_tpu_torch.nn import solvers as S
    from deeplearning4j_tpu_torch.utils import dtypes

    flat0, _ = S.flatten_params(net.params)

    def loss_fn(v, x, y):
        return net.loss_fn(S.unflatten_like(v, net.params), net.state, x, y, train=True,
                           rng=0)[0]

    opt = S.LBFGS(loss_fn)
    with dtypes.policy_precision():
        f, g = opt.value_and_grad(flat0, x, y)
        x1, _, _, step = opt.iteration(flat0, g, f, opt._init_aux(flat0), x, y)
    return (f.item(), [g], [x1]), step.item()


def solver_iteration_check(seed, x, y):
    """One LBFGS iteration on the card (f32) from identical weights at batch
    SOLVER_CHECK_BATCH, held against the same iteration in float64 on the
    CPU within the f32 noise (the iteration in f32 on the CPU, and the
    card's on the batch permuted): the loss and gradient it starts from,
    the accepted step and the new parameters."""
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.serialization import params_from_numpy

    card = mnist_net(seed)
    weights = [{k: v.detach().cpu().numpy() for k, v in d.items()} for d in card.params]
    runs = {}
    for name, dt, dev in (("cpu_f64", torch.float64, "cpu"), ("cpu_f32", torch.float32, "cpu")):
        net = MultiLayerNetwork(lenet(seed=seed), device=dev)
        net.init(dtype=dt)
        params_from_numpy(net, weights)
        runs[name] = solver_iteration(net, torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt))
    perm = np.random.RandomState(seed).permutation(x.shape[0])
    k = solver_iteration(card, torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    q = solver_iteration(mnist_net(seed), torch.from_numpy(x[perm]).cuda(),
                         torch.from_numpy(y[perm]).cuda())
    r = runs["cpu_f64"]
    step_rel = {n: abs(s[1] - b[1]) / abs(b[1]) for n, s, b in (
        ("card", k, r), ("cpu_f32", runs["cpu_f32"], r), ("card_permuted", q, k))}
    held = held_to_noise("LBFGS iteration", flat_diff(k[0], r[0]), {
        "cpu_f32_vs_cpu_f64": flat_diff(runs["cpu_f32"][0], r[0]),
        "card_f32_permuted_vs_card_f32": flat_diff(q[0], k[0])})
    noise = max(step_rel["cpu_f32"], step_rel["card_permuted"])
    if not step_rel["card"] <= MN_NOISE_FACTOR * noise:
        raise AssertionError(f"accepted step {k[1]} vs float64 {r[1]}: {step_rel}")
    return {**held, "step_card": k[1], "step_cpu_f64": r[1], "step_rel": step_rel}


def mnist_layers(seed):
    """EmbeddingLayer, TimeDistributedDenseLayer and AutoEncoder: one
    forward and backward on the card against the port on the CPU in
    float64; both embedding layers with ids out of range and -1 (NaN rows
    and the last row, as JAX's jnp.take, no device assert); check_gradients
    in float64 on the card for a narrow VAE."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.utils.gradcheck import check_gradients

    rs = np.random.RandomState(seed)
    g = torch.Generator().manual_seed(seed)
    cases = [
        (L.EmbeddingLayer(n_in=1000, n_out=64, has_bias=True, activation="tanh"),
         I.FeedForwardType(1), rs.randint(0, 1000, (256, 1)).astype(np.float32)),
        (L.TimeDistributedDenseLayer(n_out=128, activation="sigmoid"), I.RecurrentType(256, 32),
         rs.randn(64, 32, 256).astype(np.float32)),
        (L.AutoEncoder(n_out=AE_HIDDEN, corruption_level=0.3), I.FeedForwardType(784),
         rs.rand(128, 784).astype(np.float32)),
    ]
    out = {}
    for layer, it, x in cases:
        params = layer.init(g, it, torch.float64)
        keep = torch.from_numpy(rs.rand(*x.shape) > 0.3)

        def run(dev, dt):
            p = {k: v.to(dev, dt).requires_grad_(True) for k, v in params.items()}
            xt = torch.from_numpy(x).to(dev, dt)
            if isinstance(layer, L.AutoEncoder):
                y = layer.pretrain_loss(p, xt, keep=keep.to(dev))
            else:
                y = layer.apply(p, {}, xt)[0]
            gs = torch.autograd.grad(torch.sin(y).sum(), list(p.values()))
            return [y.detach().double().cpu()] + [t.double().cpu() for t in gs]

        ref, card = run("cpu", torch.float64), run("cuda", torch.float32)
        errs = [((c - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
                for c, r in zip(card, ref)]
        if not max(errs) <= LAYER_RTOL:
            raise AssertionError(f"{type(layer).__name__} on the card vs float64: {errs}")
        out[type(layer).__name__] = {"max_rel_err": max(errs), "tensors": len(errs)}
    n_in = 50
    for layer, ids in ((L.EmbeddingLayer(n_in=n_in, n_out=8),
                        [[0.0], [n_in], [-1.0], [n_in + 7], [-n_in - 1], [3.0]]),
                       (L.EmbeddingSequenceLayer(n_in=n_in, n_out=8),
                        [[0.0, n_in, -1.0], [n_in + 7, -n_in - 1, 3.0]])):
        params = layer.init(g, I.FeedForwardType(1), torch.float32)
        w = params["W"].numpy()
        flat = np.asarray(ids, np.int64).reshape(-1)
        want = np.where(((flat >= -n_in) & (flat < n_in))[:, None],
                        w[np.clip(np.where(flat < 0, flat + n_in, flat), 0, n_in - 1)], np.nan)
        got = layer.apply({k: v.cuda() for k, v in params.items()}, {},
                          torch.tensor(ids, device="cuda"))[0]
        torch.cuda.synchronize()  # a device assert would surface here
        if not np.array_equal(got.cpu().numpy().reshape(-1, 8), want, equal_nan=True):
            raise AssertionError(f"{type(layer).__name__}: out-of-range ids off jnp.take's rows")
        out[type(layer).__name__ + "_out_of_range"] = {
            "ids": flat.tolist(), "nan_rows": int(np.isnan(want[:, 0]).sum())}
    torch.ones(1, device="cuda").add_(1).item()  # the context still works
    vae = L.VariationalAutoencoder(n_latent=2, encoder_layer_sizes=(8,), decoder_layer_sizes=(8,),
                                   reconstruction="bernoulli", activation="tanh")
    params = {k: v.cuda() for k, v in vae.init(g, I.FeedForwardType(12), torch.float64).items()}
    xv = torch.from_numpy(np.clip(rs.rand(6, 12), 0.05, 0.95)).cuda()
    ok, failures = check_gradients(lambda p: vae.pretrain_loss(p, xv), params,
                                   max_params_per_leaf=GRADCHECK_PER_LEAF)
    if not ok:
        raise AssertionError(f"VAE gradcheck on the card: {failures[:3]}")
    out["vae_gradcheck"] = {"ok": ok, "leaves": len(params),
                            "checked": sum(min(p.numel(), GRADCHECK_PER_LEAF)
                                           for p in params.values())}
    return out


def phase_mnist(seed):
    """BASELINE config 1 as DL4J's LenetMnistExample runs it, and the rest of
    the training core on the card; one JSON line."""
    old_dir = os.environ.get("DL4J_TPU_DATA_DIR")
    out = {}

    def part(name, value):
        emit(f"mnist.{name}", **value)
        out[name] = value
        return value

    try:
        train_it, test_it, norm, data = mnist_data(seed)
        part("data", data)
        rows = {}
        for policy in ("f32", "bf16"):
            net, ev, rows[policy] = mnist_train(train_it, test_it, norm, seed, policy)
            if policy == "f32":
                f32_net, f32_ev = net, ev
            else:
                del net
        part("train", rows)
        restored, saved = mnist_save_and_csv(f32_net, f32_ev, test_it, norm)
        del restored
        part("quantized", mnist_quantized(f32_net, f32_ev, test_it, norm))
        del f32_net
        x_norm = norm.transform(train_it.features).astype(np.float32)
        part("memory", mnist_memory(seed, x_norm[:MN_BATCH], train_it.labels[:MN_BATCH]))
        part("solvers", mnist_solvers(seed, x_norm, train_it.labels))
        x_train = torch.from_numpy(mnist_pixels(True)).cuda()
        x_test = torch.from_numpy(mnist_pixels(False)).cuda()
        part("vae", mnist_vae(seed, x_train, x_test))
        part("autoencoder", mnist_autoencoder(seed, x_train))
        del x_train, x_test
        part("layers", mnist_layers(seed))
        part("saved", saved())  # the eval verb's process, run meanwhile
        emit("mnist", **out, card=card_line())
    finally:
        if old_dir is None:
            os.environ.pop("DL4J_TPU_DATA_DIR", None)
        else:
            os.environ["DL4J_TPU_DATA_DIR"] = old_dir
        free_card()


# ---------------------------------------------------------------------------
# model import: DL4J ModelSerializer zips and Keras HDF5 files, restored on
# the card and served
# ---------------------------------------------------------------------------

MI_REQUESTS = 64
MI_RN_HW, MI_RN_CLASSES, MI_RN_BATCH = 224, 1000, 64
MI_RN_PARAMS = 25_557_032
MI_RN_FLAT = 25_636_712  # the params + 53,120 BN mean/var + 26,560 zero conv biases
IMDB_VOCAB, IMDB_DIM, IMDB_UNITS, IMDB_MAXLEN, IMDB_BATCH = 20_000, 128, 128, 80, 32
IMDB_PARAMS = 2_691_713
KERAS_ATOL = 1e-5
FIXTURE_RTOL, FIXTURE_ATOL = 1e-5, 1e-6


@contextlib.contextmanager
def restore_stages(dl4j):
    """Wall time of a restore by stage, from the importer's own steps:
    ``read`` (the nd4j records, big-endian to native), ``unflatten`` (each
    layer's slice reshaped, permuted, transposed), ``install`` (the copies
    into the net's tensors, synchronized); the rest of the call (the
    network built and initialised on the card) is ``build``."""
    times = dict.fromkeys(("read", "unflatten", "install"), 0.0)
    saved = {name: getattr(dl4j, name)
             for name in ("read_nd4j", "_split_layer_params", "_install_params")}

    def wrap(stage, fn, sync=False):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            times[stage] += time.perf_counter() - t0
            return out
        return timed

    dl4j.read_nd4j = wrap("read", saved["read_nd4j"])
    dl4j._split_layer_params = wrap("unflatten", saved["_split_layer_params"])
    dl4j._install_params = wrap("install", saved["_install_params"], sync=True)
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(dl4j, name, fn)


def timed_restore(path, **kw):
    """(net, staged seconds, seconds of a second, unwrapped restore): the
    first call by stage, then the one a user's call takes."""
    from deeplearning4j_tpu_torch.modelimport import dl4j
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint

    with restore_stages(dl4j) as stages:
        t0 = time.perf_counter()
        net = restore_checkpoint(path, device="cuda", **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    stages = {**stages, "build": total - sum(stages.values()), "total": total}
    del net
    free_card()
    t0 = time.perf_counter()
    net = restore_checkpoint(path, device="cuda", **kw)
    torch.cuda.synchronize()
    return net, stages, time.perf_counter() - t0


def same_tensors(src, restored, what):
    """Every tensor of ``src`` (a per-layer list or per-vertex dict of
    dicts) equal to the bit in ``restored``; returns the keys only
    ``restored`` has (the zero biases the DL4J format stores for every
    conv), each checked to be zero."""
    keys = range(len(src)) if isinstance(src, list) else list(src)
    extra = []
    for k in keys:
        for name, t in src[k].items():
            if not torch.equal(t, restored[k][name]):
                raise AssertionError(f"{what}[{k}][{name}] changed in the restore")
        for name in set(restored[k]) - set(src[k]):
            if torch.count_nonzero(restored[k][name]):
                raise AssertionError(f"{what}[{k}][{name}] only in the restore and not zero")
            extra.append(f"{k}.{name}")
    return extra


def mi_charnn(L, seed, path):
    """(a) The char-RNN at BASELINE config 4's width, 2 Adam steps, written
    as a DL4J zip, restored on the card, held to the source to the bit,
    then served through the registry and the ``serve`` verb."""
    from deeplearning4j_tpu_torch.modelimport import dl4j
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ServingOverloaded, get_model_registry

    rs = np.random.RandomState(seed)
    net = MultiLayerNetwork(text_generation_lstm(VOCAB, hidden=HIDDEN, seq_len=SEQ,
                                                 updater=U.Adam(1e-3)), device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    if net.num_params() != N_PARAMS:
        raise AssertionError(f"char-RNN has {net.num_params()} params, expected {N_PARAMS}")
    x, y = charnn_data(rs, 128, SEQ)
    net.fit(x, y, batch_size=64)
    if net.iteration != 2:
        raise AssertionError(f"2 Adam steps expected, the net took {net.iteration}")
    t0 = time.perf_counter()
    dl4j.write_multilayer_network(net, str(path), save_updater=True)
    write_s = time.perf_counter() - t0
    with zipfile.ZipFile(path) as zf:
        sizes = {i.filename: i.file_size for i in zf.infolist()}
        n_updater = dl4j.read_nd4j(zf.read("updaterState.bin")).size
    if n_updater != 2 * N_PARAMS:
        raise AssertionError(f"updaterState.bin holds {n_updater} values, Adam's m and v "
                             f"are {2 * N_PARAMS}")
    restored, stages, restore_s = timed_restore(path)
    if type(restored).__name__ != "MultiLayerNetwork":
        raise AssertionError(f"the DL4J zip restored as a {type(restored).__name__}")
    extra = same_tensors(net.params, restored.params, "params")
    if extra:
        raise AssertionError(f"the char-RNN restore holds parameters the source lacks: {extra}")
    xb = x[:64]
    if not torch.equal(restored.output(xb), net.output(xb)):
        raise AssertionError("the restored char-RNN's output over 64 x 128 differs from the "
                             "source's (same weights, same kernel: expected equal to the bit)")
    params = [{k: v.detach() for k, v in p.items()} for p in restored.params]
    del net
    free_card()

    reqs = []
    for i in range(MI_REQUESTS):
        rows = None if i % 4 else int(rs.randint(2, 17))
        ids = rs.randint(0, VOCAB, size=(rows or 1, int(rs.randint(1, SEQ + 1))))
        xr = np.eye(VOCAB, dtype=np.float32)[ids]
        reqs.append((xr if rows else xr[0], rows is not None))
    L.reset_launches()
    registry = get_model_registry()
    t_reg = time.perf_counter()
    engine = registry.register("charnn_dl4j", restored, input_spec=(SEQ, VOCAB),
                               max_batch_size=64, seq_buckets=(32, 64, 128), device="cuda")
    register_s = time.perf_counter() - t_reg
    try:
        t0 = time.perf_counter()
        first = engine.submit(reqs[0][0], batched=reqs[0][1]).get(timeout=300)
        first_ms = 1e3 * (time.perf_counter() - t0)
        futs, shed = [], 0
        t0 = time.perf_counter()
        for xr, batched in reqs[1:]:
            while True:
                try:
                    futs.append(engine.submit(xr, batched=batched))
                    break
                except ServingOverloaded:
                    shed += 1
                    time.sleep(0.001)
        outs = [first] + [f.get(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        registry.stop()
    launches, by_variant = L.launches, dict(L.launches_by_variant)
    forwards = stats["forward"]["forwards"]
    if launches == 0 or launches != 2 * forwards:
        raise AssertionError(f"lstm_seq launched {launches} times for {forwards} device forwards "
                             "of the restored 2-layer LSTM (expected exactly 2 per forward)")
    if by_variant != {**dict.fromkeys(L.VARIANTS, 0), "persistent": launches}:
        raise AssertionError(f"lstm_seq launches by variant {by_variant}: every served launch "
                             "should be persistent")
    max_err, tokens = 0.0, 0
    for i, ((xr, batched), out) in enumerate(zip(reqs, outs)):
        xb = xr if batched else xr[None]
        ob = out if batched else out[None]
        if ob.shape != xb.shape[:2] + (VOCAB,) or not np.isfinite(ob).all():
            raise AssertionError(f"served output {ob.shape} for input {xb.shape}, or not finite")
        want = plain_forward(L, params, torch.from_numpy(xb).cuda()).cpu().numpy()
        err = float(np.abs(ob - want).max())
        max_err = max(max_err, err)
        if err > SERVE_ATOL:
            raise AssertionError(f"served output {i} differs from the plain forward by {err}")
        if i:
            tokens += xb.shape[0] * xb.shape[1]
    del restored
    free_card()

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path", str(path),
         "--input-shape", f"{SEQ},{VOCAB}", "--max-batch", "64", "--smoke", str(MI_REQUESTS),
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI on the DL4J zip exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    cli_stats = json.loads(proc.stdout[proc.stdout.index("\n{") + 1:])
    if cli_stats["requests"]["served"] != MI_REQUESTS:
        raise AssertionError(f"serve CLI served {cli_stats['requests']['served']} of "
                             f"{MI_REQUESTS}")
    return {"params": N_PARAMS, "adam_steps": 2, "zip_entry_bytes": sizes, "write_s": write_s,
            "restore_s": restore_s, "restore_stages_first_s": stages,
            "params_equal": True, "output_equal_64x128": True,
            "register_s": register_s, "first_request_ms": first_ms,
            "requests": len(reqs), "tokens_after_first": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "resubmits_after_queue_full": shed,
            "device_forwards": forwards, "lstm_seq_launches": launches,
            "lstm_seq_launches_by_variant": by_variant, "max_abs_err_vs_plain": max_err,
            "atol": SERVE_ATOL, "cli": {"rc": proc.returncode,
                                        "served": cli_stats["requests"]["served"],
                                        "seconds": time.perf_counter() - t0}}


def mi_resnet(C, seed, path):
    """(b) ResNet50 (not fused: the DL4J format has no FusedConvBNVertex)
    written as a DL4J ComputationGraph zip, restored on the card with the
    zoo's input type, held to the source, and one batch evaluated."""
    from deeplearning4j_tpu_torch.modelimport import dl4j
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    rs = np.random.RandomState(seed + 1)
    net = ComputationGraph(resnet50(MI_RN_HW, MI_RN_HW, n_classes=MI_RN_CLASSES, fused=False),
                           device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    if net.num_params() != MI_RN_PARAMS:
        raise AssertionError(f"ResNet50 has {net.num_params()} params, expected {MI_RN_PARAMS}")
    with torch.no_grad():  # BN running statistics away from their init
        for st in net.state.values():
            if "mean" in st:
                st["mean"].copy_(torch.from_numpy(0.1 * rs.randn(*st["mean"].shape)))
                st["var"].copy_(torch.from_numpy(0.5 + rs.rand(*st["var"].shape)))
    t0 = time.perf_counter()
    dl4j.write_computation_graph(net, str(path))
    write_s = time.perf_counter() - t0
    with zipfile.ZipFile(path) as zf:
        sizes = {i.filename: i.file_size for i in zf.infolist()}
    flat = (sizes["coefficients.bin"] - 64) // 4
    C.reset_launches()
    restored, stages, restore_s = timed_restore(
        path, input_type=I.convolutional(MI_RN_HW, MI_RN_HW, 3))
    extra = same_tensors(net.params, restored.params, "params")
    same_tensors(net.state, restored.state, "state")
    n_restored = restored.num_params()
    bn_stats = sum(st["mean"].numel() + st["var"].numel() for st in net.state.values()
                   if "mean" in st)
    n_convs = sum(1 for name in net.params if name.endswith("_conv"))
    if flat != MI_RN_FLAT or n_restored + bn_stats != flat or len(extra) != n_convs:
        raise AssertionError(f"restored {n_restored} params, {len(extra)} zero conv biases of "
                             f"{n_convs} convs, {bn_stats} BN statistics; the flat vector holds "
                             f"{flat} values, expected {MI_RN_FLAT}")
    x = torch.from_numpy(rs.rand(MI_RN_BATCH, MI_RN_HW, MI_RN_HW, 3).astype(np.float32)).cuda()
    src1, src2 = net.output(x), net.output(x)
    got = restored.output(x)
    spread = float((src1 - src2).abs().max())
    err = float((got - src1).abs().max())
    if not torch.equal(got, src1) and err > spread:
        raise AssertionError(f"restored ResNet50 differs from the source by {err}, beyond the "
                             f"spread of two source forwards ({spread})")
    y = torch.nn.functional.one_hot(torch.from_numpy(rs.randint(0, MI_RN_CLASSES, MI_RN_BATCH)),
                                    MI_RN_CLASSES).float()
    restored.evaluate(x, y.cuda())  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = restored.evaluate(x, y.cuda())
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0)
    if any(C.launches.values()):
        raise AssertionError(f"the DL4J ResNet50 launched the conv kernels: {C.launches}")
    del net, restored, src1, src2, got, x
    free_card()
    return {"params": MI_RN_PARAMS, "restored_params": n_restored,
            "zero_conv_biases": len(extra), "bn_statistics": bn_stats, "flat_values": flat,
            "zip_entry_bytes": sizes,
            "write_s": write_s, "restore_s": restore_s, "restore_stages_first_s": stages,
            "params_and_state_equal": True,
            "output": "equal to the bit" if err == 0.0 else "within the source's spread",
            "max_abs_err": err, "source_spread": spread, "evaluate_ms_batch": eval_ms,
            "batch": MI_RN_BATCH,
            "accuracy_random_labels": ev.accuracy(),
            "kernels": "none: the DL4J format has no FusedConvBNVertex, so every conv is a "
                       "library conv (cuDNN); conv_stats launches 0"}


def keras_lstm_numpy(ids, emb, kernel, rec, bias, wd, bd):
    """imdb_lstm's forward from the raw HDF5 arrays, in float64: the
    embedding rows, Keras's LSTM (gates i, f, c, o; sigmoid, tanh) to the
    last step, the sigmoid head."""
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    x = emb[ids].astype(np.float64)
    h = np.zeros((ids.shape[0], rec.shape[0]))
    c = np.zeros_like(h)
    for t in range(ids.shape[1]):
        i, f, g, o = np.split(x[:, t] @ kernel + h @ rec + bias, 4, axis=-1)
        c = sig(f) * c + sig(i) * np.tanh(g)
        h = sig(o) * np.tanh(c)
    return sig(h @ wd + bd)


def hdf5_on_host():
    """What the host offers the HDF5 bridge: the native library's build
    (g++), libhdf5 in the loader's cache, and whether the bridge loaded it."""
    from deeplearning4j_tpu_torch import native

    tool = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        out = subprocess.run([tool, "-p"], capture_output=True, text=True, timeout=60).stdout
        libs = [ln.strip() for ln in out.splitlines() if "hdf5" in ln]
    except OSError as e:
        libs = [f"ldconfig: {e}"]
    return {"gxx": shutil.which("g++"), "native_library_built": native.available(),
            "ldconfig_hdf5": libs, "libhdf5_loaded": native.h5_available()}


def mi_keras(L, seed, path):
    """(c) The Keras examples' imdb_lstm (Embedding(20000, 128) ->
    LSTM(128) -> Dense(1, sigmoid), maxlen 80) written as a tf.keras HDF5
    file, restored on the card, held to a numpy forward of the raw
    datasets; its LSTM launches ``lstm_seq``."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint

    if not native.available():
        emit("modelimport.keras", skipped="the native library did not build on this host")
        return None
    if not native.h5_available():
        emit("modelimport.keras", skipped="no libhdf5 on this host")
        return None
    from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

    rs = np.random.RandomState(seed + 2)

    def glorot(fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rs.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)

    u = IMDB_UNITS
    emb = rs.uniform(-0.05, 0.05, (IMDB_VOCAB, IMDB_DIM)).astype(np.float32)
    kernel = glorot(IMDB_DIM, 4 * u)
    rec = np.concatenate([np.linalg.qr(rs.randn(u, u))[0] for _ in range(4)], 1).astype(np.float32)
    bias = np.zeros(4 * u, np.float32)
    bias[u:2 * u] = 1.0  # unit_forget_bias
    wd, bd = glorot(u, 1), np.zeros(1, np.float32)
    layers = [
        {"class_name": "Embedding", "config": {
            "name": "embedding", "trainable": True, "batch_input_shape": [None, IMDB_MAXLEN],
            "dtype": "float32", "input_dim": IMDB_VOCAB, "output_dim": IMDB_DIM,
            "embeddings_initializer": {"class_name": "RandomUniform",
                                       "config": {"minval": -0.05, "maxval": 0.05}},
            "mask_zero": False, "input_length": IMDB_MAXLEN}},
        {"class_name": "LSTM", "config": {
            "name": "lstm", "trainable": True, "dtype": "float32", "return_sequences": False,
            "return_state": False, "go_backwards": False, "stateful": False, "unroll": False,
            "units": u, "activation": "tanh", "recurrent_activation": "sigmoid",
            "use_bias": True, "unit_forget_bias": True, "implementation": 2}},
        {"class_name": "Dense", "config": {
            "name": "dense", "trainable": True, "dtype": "float32", "units": 1,
            "activation": "sigmoid", "use_bias": True}}]
    weights = {"embedding": [("embedding/embeddings:0", emb)],
               "lstm": [("lstm/kernel:0", kernel), ("lstm/recurrent_kernel:0", rec),
                        ("lstm/bias:0", bias)],
               "dense": [("dense/kernel:0", wd), ("dense/bias:0", bd)]}
    t0 = time.perf_counter()
    with Hdf5Archive(str(path), "w") as f:
        f.write_attr_string("model_config", json.dumps(
            {"class_name": "Sequential", "config": {"name": "sequential", "layers": layers}}))
        f.write_attr_string("keras_version", "2.4.0")
        f.write_attr_string("backend", "tensorflow")
        f.make_group("model_weights")
        f.write_attr_strings("layer_names", list(weights), "model_weights")
        for lname, ws in weights.items():
            f.make_group(f"model_weights/{lname}")
            f.write_attr_strings("weight_names", [wn for wn, _ in ws], f"model_weights/{lname}")
            for wn, arr in ws:
                f.write_dataset(f"model_weights/{lname}/{wn}", arr)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = restore_checkpoint(str(path), device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if net.num_params() != IMDB_PARAMS:
        raise AssertionError(f"imdb_lstm has {net.num_params()} params, expected {IMDB_PARAMS}")
    lstm = net.conf.layers[1]
    if type(lstm).__name__ != "LSTM" or not lstm._sequence_op():
        raise AssertionError(f"layer 1 is {lstm}: the sigmoid-gated LSTM should take lstm_seq")
    with Hdf5Archive(str(path)) as f:  # the check reads the file, not the arrays above
        raw = {n: f.read_dataset(f"model_weights/{d}") for n, d in (
            ("emb", "embedding/embedding/embeddings:0"), ("kernel", "lstm/lstm/kernel:0"),
            ("rec", "lstm/lstm/recurrent_kernel:0"), ("bias", "lstm/lstm/bias:0"),
            ("wd", "dense/dense/kernel:0"), ("bd", "dense/dense/bias:0"))}
    ids = rs.randint(0, IMDB_VOCAB, (IMDB_BATCH, IMDB_MAXLEN))
    x = torch.from_numpy(ids.astype(np.float32)[..., None]).cuda()
    net.output(x)  # warm
    L.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = net.output(x)
    torch.cuda.synchronize()
    forward_ms = 1e3 * (time.perf_counter() - t0)
    launches, by_variant = L.launches, dict(L.launches_by_variant)
    if launches != 1 or by_variant["persistent"] != 1:
        raise AssertionError(f"imdb_lstm's forward launched lstm_seq {by_variant} "
                             "(expected once, persistent)")
    want = keras_lstm_numpy(ids, raw["emb"], raw["kernel"], raw["rec"], raw["bias"], raw["wd"],
                            raw["bd"])
    got = out.cpu().numpy()
    err = float(np.abs(got - want).max())
    if got.shape != (IMDB_BATCH, 1) or err > KERAS_ATOL:
        raise AssertionError(f"imdb_lstm output {got.shape} differs from the numpy forward of "
                             f"the HDF5 datasets by {err} (atol {KERAS_ATOL})")
    del net
    free_card()
    return {"params": IMDB_PARAMS, "file_bytes": path.stat().st_size, "write_s": write_s,
            "restore_s": restore_s, "forward_ms_32x80": forward_ms,
            "lstm_seq_launches": launches, "lstm_seq_launches_by_variant": by_variant,
            "max_abs_err_vs_numpy": err, "atol": KERAS_ATOL,
            "cut": "the examples' dropout=0.2, recurrent_dropout=0.2 left out of the LSTM "
                   "config: the JAX mapper reads neither (inference ignores them)"}


def mi_fixtures(L):
    """(d) The committed DL4J fixture zips restored on the card, each held
    to its ``*_expected.npy`` at the CPU test's tolerance (cuDNN's TF32
    off: the pinned outputs are full f32)."""
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint
    from deeplearning4j_tpu_torch.nn.conf import inputs as I

    fixdir = ROOT / "tests" / "fixtures"
    manifest = json.loads((fixdir / "dl4j_manifest.json").read_text())["fixtures"]
    rows, launches = {}, 0
    for fx in manifest:
        spec = fx["input_type"]
        it = (I.convolutional(*spec[1:]) if spec[0] == "conv" else
              I.recurrent(*spec[1:]) if spec[0] == "rnn" else I.feed_forward(spec[1]))
        net = restore_checkpoint(str(fixdir / f"{fx['name']}.zip"), input_type=it,
                                 device="cuda")
        x = torch.from_numpy(np.load(fixdir / f"{fx['name']}_input.npy")).cuda()
        want = np.load(fixdir / f"{fx['name']}_expected.npy")
        L.reset_launches()
        with library_precision():
            got = net.output(x)
        got = (next(iter(got.values())) if isinstance(got, dict) else got).cpu().numpy()
        launches += L.launches
        err = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=FIXTURE_RTOL, atol=FIXTURE_ATOL):
            raise AssertionError(f"fixture {fx['name']} on the card differs from its expected "
                                 f"output by {err}")
        rows[fx["name"]] = {"kind": type(net).__name__, "max_abs_err": err,
                            "lstm_seq_launches": L.launches}
    if not rows["dl4j_graveslstm_v1"]["lstm_seq_launches"]:
        raise AssertionError("the GravesLSTM fixture did not launch lstm_seq on the card")
    return {"fixtures": rows, "rtol": FIXTURE_RTOL, "atol": FIXTURE_ATOL,
            "lstm_seq_launches": launches}


def phase_modelimport(L, C, seed):
    """Model import on the card: DL4J zips and a Keras HDF5 file restored
    and run; one JSON line."""
    t0 = time.perf_counter()
    out = {"charnn": mi_charnn(L, seed, WORK / "charnn_dl4j.zip")}
    emit("modelimport.charnn", **out["charnn"])
    out["resnet50"] = mi_resnet(C, seed, WORK / "resnet50_dl4j.zip")
    emit("modelimport.resnet50", **out["resnet50"])
    out["keras"] = mi_keras(L, seed, WORK / "imdb_lstm.h5")
    if out["keras"] is not None:
        emit("modelimport.keras", **out["keras"])
    out["fixtures"] = mi_fixtures(L)
    emit("modelimport.fixtures", **out["fixtures"])
    out["lstm_seq_launches"] = (out["charnn"]["lstm_seq_launches"]
                                + (out["keras"] or {}).get("lstm_seq_launches", 0)
                                + out["fixtures"]["lstm_seq_launches"])
    emit("modelimport", seconds=time.perf_counter() - t0,
         lstm_seq_launches=out["lstm_seq_launches"], hdf5=hdf5_on_host(), card=card_line())
    return out


# ---------------------------------------------------------------------------
# the MoE transformer LM (the long-context tier)
# ---------------------------------------------------------------------------

def make_moe_lm(seed, capacity=MOE_CAPACITY):
    """The train phase's LM with every TransformerBlock an
    MoETransformerBlock (capacity factor ``capacity``), from the config
    DSL (the JAX package's zoo has no function for it)."""
    from deeplearning4j_tpu_torch.nn import layers as TL
    from deeplearning4j_tpu_torch.nn import updaters as TU
    from deeplearning4j_tpu_torch.nn.conf import inputs as TI
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = NeuralNetConfig(seed=seed, updater=TU.Adam(learning_rate=3e-4)).list(
        TL.EmbeddingSequenceLayer(n_in=LM_VOCAB, n_out=LM_WIDTH, add_positional=True),
        *[TL.MoETransformerBlock(n_out=LM_WIDTH, n_heads=LM_HEADS, n_experts=MOE_EXPERTS,
                                 mlp_ratio=4, capacity_factor=capacity,
                                 aux_loss_weight=MOE_AUX, causal=True)
          for _ in range(LM_LAYERS)],
        TL.RnnOutputLayer(n_out=LM_VOCAB, loss="mcxent"),
        input_type=TI.RecurrentType(1, LM_SEQ))
    net = MultiLayerNetwork(conf, device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    if net.num_params() != MOE_PARAMS:
        raise AssertionError(f"the MoE LM has {net.num_params()} params, expected {MOE_PARAMS}")
    return net


def flip_gaps(params, h, chosen, other):
    """For tokens routed to expert ``chosen`` in one run and to ``other`` in
    another, on this run's router input ``h`` [n, d] (``chosen`` its own
    argmax): (the router logit gap z[chosen] - z[other] >= 0, its limit).
    The limit is how far that gap can move when every element of the
    router input moves by one bf16 ulp (at most BF16_ULP of its magnitude)
    the way that favours the flip: BF16_ULP · Σ_i |h_i| |W_i,chosen -
    W_i,other|. Under bf16_policy the attention's output projection rounds
    its operands to bf16, so the kernel's ~1e-7 difference from the plain
    attention reaches the router input as bf16 ulps; a flip whose gap
    exceeds one ulp on every element cannot come from that rounding."""
    w = params["router_W"].float()
    hf = h.float()
    rows = torch.arange(hf.shape[0], device=hf.device)
    z = hf @ w
    gap = z[rows, chosen] - z[rows, other]
    limit = BF16_ULP * (hf.abs() * (w[:, chosen] - w[:, other]).t().abs()).sum(-1)
    return gap, limit


def hold_flips(what, policy, flips):
    """Under f32 every flip's top-2 margin must be below MOE_TIE_MARGIN;
    under bf16 every flip's logit gap within its ``flip_gaps`` limit."""
    if not flips["flips"]:
        return
    if policy == "f32" and flips["flips_max_margin"] >= MOE_TIE_MARGIN:
        raise AssertionError(f"{what}: routing flips beyond a top-2 margin of "
                             f"{MOE_TIE_MARGIN}: {flips}")
    if policy == "bf16" and flips["flips_max_gap_over_limit"] > 1:
        raise AssertionError(f"{what}: a routing flip beyond one bf16 ulp of every router "
                             f"input: {flips}")


def count_flips(report, params, r_own, top_other, h):
    """Adds to ``report`` the tokens whose own routing ``r_own`` differs
    from ``top_other``: their count, largest top-2 margin, and largest
    ``flip_gaps`` ratio of gap to limit."""
    flipped = r_own.top != top_other
    n = int(flipped.sum())
    if not n:
        return
    with torch.no_grad():
        top2 = r_own.probs[flipped].topk(2, dim=-1).values
        gap, limit = flip_gaps(params, h[flipped], r_own.top[flipped], top_other[flipped])
    report["flips"] += n
    for key, value in (("flips_max_margin", float((top2[:, 0] - top2[:, 1]).max())),
                       ("flips_max_gap_over_limit", float((gap / limit).max()))):
        report[key] = max(value, report[key] if report[key] is not None else value)


def new_flip_report():
    return {"flips": 0, "flips_max_margin": None, "flips_max_gap_over_limit": None}


@contextlib.contextmanager
def recorded_routing(n_blocks, replay):
    """Within this block the first ``n_blocks`` MoE routings (the kernel
    step's forward in ``step_check``) are recorded, and the next
    ``n_blocks`` (the plain-attention step's) are compared with them
    (``count_flips``, in the dict yielded). With ``replay`` those send
    every token to the recorded expert, so the two steps are compared
    given the same routing; without, each step routes by itself."""
    from deeplearning4j_tpu_torch.nn.layers.moe import MoETransformerBlock

    saved, tops = MoETransformerBlock.route, []
    report = {"routings": 0, **new_flip_report()}

    def route(self, params, x2d):
        r = saved(self, params, x2d)
        report["routings"] += 1
        if len(tops) < n_blocks:
            tops.append(r.top)
            return r
        top = tops[report["routings"] - n_blocks - 1]
        count_flips(report, params, r, top, x2d)
        return self.assign(r.probs, top) if replay else r
    MoETransformerBlock.route = route
    try:
        yield report
    finally:
        MoETransformerBlock.route = saved


def moe_step_check(A, x, y, seed, policy):
    """``step_check`` of the MoE LM, the plain-attention step given the
    kernel step's routing (``recorded_routing``); the plain step's own
    routing flips held by ``hold_flips``. Under bf16 the two steps also
    run each with its own routing (``moe_unreplayed_step``), reported."""
    with recorded_routing(LM_LAYERS, replay=True) as flips:
        check = step_check(A, x, y, seed, policy, make=make_moe_lm, by_leaf=True)
    if flips["routings"] != 2 * LM_LAYERS:
        raise AssertionError(f"{flips['routings']} routings in two steps of {LM_LAYERS} blocks")
    hold_flips("the kernel and the plain-attention step", policy, flips)
    replayed = check.pop("grad_rel_by_leaf")
    check = {**check, "routing_flips": flips["flips"],
             "routing_flips_max_margin": flips["flips_max_margin"],
             "routing_flips_max_gap_over_limit": flips["flips_max_gap_over_limit"]}
    if policy == "bf16":
        check["unreplayed"] = moe_unreplayed_step(A, x, y, seed, replayed)
    return check


def moe_unreplayed_step(A, x, y, seed, replayed):
    """One step of the MoE LM through the kernel and one through the plain
    attention, each with its own routing: the flips, the losses, and the
    MOE_WORST_LEAVES parameters whose gradients differ most (relative, in
    norm), beside the same parameters' difference when the steps are given
    one routing (``replayed``: ``grad_rel_by_leaf`` of that check). A
    report: a flip sends a token through another expert, which no
    tolerance of a smooth difference covers."""
    with recorded_routing(LM_LAYERS, replay=False) as flips:
        kern = make_moe_lm(seed)
        lk, gk = one_step(kern, x, y)
        with plain_attention_forward(A):
            plain = make_moe_lm(seed)
            lp, gp = one_step(plain, x, y)
    rels = grad_rel_by_leaf(kern.params, gk, gp)
    del kern, plain, gk, gp
    torch.cuda.empty_cache()
    worst = sorted(rels, key=rels.get, reverse=True)[:MOE_WORST_LEAVES]
    return {"loss_kernel": lk, "loss_plain": lp, "routing_flips": flips["flips"],
            "routing_flips_max_margin": flips["flips_max_margin"],
            "max_grad_rel": rels[worst[0]], "max_grad_rel_replayed": max(replayed.values()),
            "worst_grad_rel_leaves": [{"leaf": n, "grad_rel": rels[n],
                                       "grad_rel_replayed": replayed[n]} for n in worst]}


@contextlib.contextmanager
def popped_aux_terms():
    """Within this block every aux term a network's loss pops
    (``nn/layers/base.pop_aux_losses``) is kept, detached on its device, in
    the list yielded."""
    from deeplearning4j_tpu_torch.nn.layers import base

    saved, popped = base.pop_aux_losses, []

    def keeping(loss, states):
        popped.extend(s["aux_loss"].detach()
                      for s in (states.values() if isinstance(states, dict) else states)
                      if isinstance(s, dict) and "aux_loss" in s)
        return saved(loss, states)
    base.pop_aux_losses = keeping
    try:
        yield popped
    finally:
        base.pop_aux_losses = saved


def moe_blocks(net):
    return [(i, layer) for i, layer in enumerate(net.conf.layers)
            if type(layer).__name__ == "MoETransformerBlock"]


def moe_routing(A, net, x, policy):
    """Per MoE block, on the inputs the network gives it for ``x``: tokens
    routed to each expert, tokens kept and dropped, the Switch aux term
    (E·Σ f·p), and the routing flips between the block's attention through
    the kernel and through the plain version on the same input
    (``count_flips``), held by ``hold_flips``."""
    acts = net.feed_forward(x)
    rows = []
    with torch.inference_mode():
        for i, block in moe_blocks(net):
            a = acts[i - 1]
            d = a.shape[-1]
            h = block.mlp_input(net.params[i], a)[1].reshape(-1, d)
            r = block.route(net.params[i], h)
            with plain_attention_forward(A):
                hp = block.mlp_input(net.params[i], a)[1].reshape(-1, d)
            flips = new_flip_report()
            count_flips(flips, net.params[i], block.route(net.params[i], hp), r.top, hp)
            hold_flips(f"block {i}, the kernel and the plain attention", policy, flips)
            top2 = r.probs.topk(2, dim=-1).values
            frac = r.routed.float().mean(0)
            rows.append({"layer": i, "tokens": h.shape[0], "capacity": block.capacity(h.shape[0]),
                         "per_expert": r.routed.sum(0).tolist(),
                         "kept": int(r.keep.sum()), "dropped": int((~r.keep).sum()),
                         "aux": float(block.n_experts * (frac * r.probs.mean(0)).sum()),
                         **flips, "ties_below_margin":
                         int((top2[:, 0] - top2[:, 1] < MOE_TIE_MARGIN).sum())})
    del acts
    return rows


# the MoE block's forward ranges, and the autograd nodes of its backward
MOE_TAGS = (("updater.step", "optimizer"), ("moe.router", "router"),
            ("moe.dispatch", "dispatch_combine"), ("moe.combine", "dispatch_combine"),
            ("moe.experts", "expert_bmm"), ("BmmBackward0", "expert_bmm"),
            ("IndexAddBackward0", "dispatch_combine"),
            ("IndexSelectBackward0", "dispatch_combine"), ("SoftmaxBackward0", "router"))


def phase_moe_train(A, policy, seed):
    """Warm-up, then TIMED_STEPS timed fit steps of the MoE LM under the
    named policy (6 flash launches a step, every aux term popped), the step
    check through the plain attention, routing, one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.utils import dtypes

    (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
    try:
        rs = np.random.RandomState(seed)
        x, y = lm_data(rs, LM_BATCH * (WARMUP_STEPS + TIMED_STEPS))
        check = moe_step_check(A, x[:LM_BATCH], y[:LM_BATCH], seed, policy)
        free_card()
        net = make_moe_lm(seed)
        routing_init = moe_routing(A, net, x[:LM_BATCH], policy)
        warm = LM_BATCH * WARMUP_STEPS
        net.fit((x[:warm], y[:warm]), batch_size=LM_BATCH)
        first_loss = net.score_history[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with popped_aux_terms() as popped:
            A.reset_launches()
            t0 = time.perf_counter()
            net.fit((x[warm:], y[warm:]), batch_size=LM_BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = A.launches
            by_variant = dict(A.launches_by_variant)
            bwd, bwd_by_variant = bwd_launched(A, f"MoE LM {policy}", LM_LAYERS * TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated()
        losses = net.score_history
        if launches != LM_LAYERS * TIMED_STEPS:
            raise AssertionError(f"flash_attn launched {launches} times in {TIMED_STEPS} steps "
                                 f"of the {LM_LAYERS}-block MoE LM (expected {LM_LAYERS} a step)")
        planned = A.plan((LM_BATCH, LM_SEQ, LM_HEADS, LM_WIDTH // LM_HEADS), torch.float32,
                         ((LM_SEQ * 3 * LM_WIDTH, 3 * LM_WIDTH, LM_WIDTH // LM_HEADS),) * 3)
        if by_variant != {**dict.fromkeys(A.VARIANTS, 0), planned.variant: launches}:
            raise AssertionError(f"flash launches by variant {by_variant}: every one should be "
                                 f"{planned.variant}")
        if len(popped) != LM_LAYERS * TIMED_STEPS:
            raise AssertionError(f"{len(popped)} aux terms popped in {TIMED_STEPS} steps of "
                                 f"{LM_LAYERS} MoE blocks")
        aux = (torch.stack(popped).view(TIMED_STEPS, LM_LAYERS) / MOE_AUX).tolist()
        if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
            raise AssertionError(f"MoE loss did not fall: first {first_loss}, timed {losses}")
        if not all(np.isfinite(a) and a > 0 for row in aux for a in row) or \
                any("aux_loss" in s for s in net.state):
            raise AssertionError(f"aux terms {aux}, state keys {[list(s) for s in net.state]}")
        tokens = TIMED_STEPS * LM_BATCH * LM_SEQ
        row = {"policy": policy, "params": net.num_params(), "experts": MOE_EXPERTS,
               "capacity_factor": MOE_CAPACITY, "aux_weight": MOE_AUX, "batch": LM_BATCH,
               "seq": LM_SEQ, "steps": TIMED_STEPS, "step_ms": 1e3 * wall / TIMED_STEPS,
               "tokens_per_s": tokens / wall, "peak_mem_gb": peak / 1e9,
               "loss_first": first_loss, "loss_last": losses[-1], "losses": losses,
               "aux_popped": len(popped), "aux_by_step_and_block": aux,
               "flash_launches": launches, "flash_launches_by_variant": by_variant,
               "flash_bwd_launches": bwd, "flash_bwd_launches_by_variant": bwd_by_variant,
               "step_check": check, "routing_at_init": routing_init,
               "routing_after": moe_routing(A, net, x[:LM_BATCH], policy), "card": card_line()}
        emit("moe.train", **row)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit((x[:LM_BATCH], y[:LM_BATCH]))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_family, busy_ms, share = device_families(prof, wall_ms, tags=MOE_TAGS)
        emit("moe.profile", policy=policy, wall_ms=wall_ms, wall_unprofiled_ms=row["step_ms"],
             device_ms_by_family=by_family, device_busy_ms=busy_ms, device_busy_share=share,
             device_busy_share_unprofiled=busy_ms / row["step_ms"], card=card_line())
        return row, net
    finally:
        dtypes.f32_policy()


def leaf_copies(tree):
    """A nested dict of detached copies of ``tree``'s tensors, requiring grad."""
    return {k: leaf_copies(v) if hasattr(v, "items") else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


def moe_sync_check(A, net):
    """One MoE block, forward and backward at the path's shape, under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    i, block = moe_blocks(net)[0]
    params = leaf_copies(net.params[i])
    leaves = list(tree_leaves(params))
    x = torch.randn(LM_BATCH, LM_SEQ, LM_WIDTH, device="cuda", requires_grad=True)
    g = torch.randn(LM_BATCH, LM_SEQ, LM_WIDTH, device="cuda")

    def run():
        y, state = block.apply(params, {}, x, train=True)
        return torch.autograd.grad((y * g).sum() + state["aux_loss"], leaves + [x])
    run()
    torch.cuda.synchronize()
    before, before_bwd = A.launches, A.launches_bwd
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in grads)
    if not finite:
        raise AssertionError("the MoE block's gradients are not finite")
    return {"layer": i, "host_syncs": 0, "sync_debug_mode": "error", "grads": len(grads),
            "flash_launches": A.launches - before,
            "flash_bwd_launches": A.launches_bwd - before_bwd}


def moe_fused(A, seed):
    """``fit(steps_per_dispatch=MOE_K)`` under f32: one dispatch captures
    the graph, then MOE_K_DISPATCHES timed dispatches whose flash launches
    all come from replays; the last dispatch's mean loss below the first's."""
    from deeplearning4j_tpu_torch.nn import fused

    net = make_moe_lm(seed)
    rs = np.random.RandomState(seed + 3)
    k = MOE_K
    x, y = lm_data(rs, LM_BATCH * k * (1 + MOE_K_DISPATCHES))
    first = LM_BATCH * k
    net.fit(x[:first], y[:first], batch_size=LM_BATCH, steps_per_dispatch=k)
    engine = net._train_steps_fused[(k, False)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    A.reset_launches()
    t0 = time.perf_counter()
    net.fit(x[first:], y[first:], batch_size=LM_BATCH, steps_per_dispatch=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = k * MOE_K_DISPATCHES
    launches, replayed = A.launches, fused.replay_launches.get("attention", 0)
    if launches != LM_LAYERS * steps or replayed != launches:
        raise AssertionError(f"flash_attn launched {launches} times ({replayed} from replays) "
                             f"in {steps} K={k} steps (expected {LM_LAYERS} a step)")
    bwd, _ = bwd_launched(A, f"MoE LM K={k}", LM_LAYERS * steps)
    if fused.replay_launches.get("attention_bwd", 0) != bwd:
        raise AssertionError(f"flash_attn_bwd: {bwd} launches, "
                             f"{fused.replay_launches.get('attention_bwd', 0)} from replays")
    if engine.captures != 1:
        raise AssertionError(f"{engine.captures} captures for one signature")
    losses = net.score_history
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"K={k} MoE loss did not fall, dispatch by dispatch: {losses}")
    row = {"k": k, "dispatches": MOE_K_DISPATCHES, "steps": steps, "captures": engine.captures,
           "replays": engine.replays, "step_ms": 1e3 * wall / steps,
           "tokens_per_s": steps * LM_BATCH * LM_SEQ / wall,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "flash_launches": launches, "flash_launches_from_replays": replayed,
           "flash_bwd_launches": bwd, "flash_bwd_launches_from_replays": bwd,
           "loss_first_dispatch": first, "loss_last_dispatch": last, "losses": losses,
           "card": card_line()}
    del net, engine, x, y
    free_card()
    return row


def moe_serve(A, net, seed):
    """The trained MoE LM in eval mode through the serving registry: batch
    1 (a row's capacity slots depend on its batch), MOE_SERVE_REQUESTS
    requests at T = 4096, each answer against ``net.output`` on the same
    ids; 6 flash launches a device forward; no aux term in the state."""
    from deeplearning4j_tpu_torch.serving import get_model_registry

    rs = np.random.RandomState(seed + 4)
    ids = rs.randint(0, LM_VOCAB, size=(MOE_SERVE_REQUESTS, LM_SEQ, 1)).astype(np.float32)
    registry = get_model_registry()
    A.reset_launches()
    t_reg = time.perf_counter()
    engine = registry.register("moe_lm", net, input_spec=(LM_SEQ, 1), max_batch_size=1,
                               device="cuda")
    register_s = time.perf_counter() - t_reg
    t0 = time.perf_counter()
    try:
        futs = [engine.submit(x) for x in ids]
        outs = [f.get(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        registry.stop()
    launches, forwards = A.launches, stats["forward"]["forwards"]
    if launches != LM_LAYERS * forwards:
        raise AssertionError(f"flash_attn launched {launches} times in {forwards} device "
                             f"forwards (expected {LM_LAYERS} each)")
    errs, equal = [], 0
    for x, got in zip(ids, outs):
        want = net.output(x[None])[0].cpu().numpy()
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"served {got.shape}, expected {want.shape}, finite")
        errs.append(float(np.abs(got - want).max()))
        equal += int(np.array_equal(got, want))
    if max(errs) > FLASH_F32_ATOL or any("aux_loss" in s for s in net.state):
        raise AssertionError(f"served answers differ from net.output by {max(errs)}")
    lats = sorted(f.latency_s for f in futs)
    return {"requests": len(ids), "seq": LM_SEQ, "device_forwards": stats["forward"]["forwards"],
            "warmup_forwards": stats["forward"]["warmed"], "flash_launches": launches,
            "register_s": register_s, "wall_s": wall,
            "tokens_per_s": len(ids) * LM_SEQ / wall,
            "p50_ms": 1e3 * float(np.percentile(lats, 50)),
            "p99_ms": 1e3 * float(np.percentile(lats, 99)),
            "max_abs_diff_vs_output": max(errs), "bit_equal": equal, "card": card_line()}


def phase_moe(A, seed):
    t0 = time.perf_counter()
    rows = {}
    rows["f32"], net = phase_moe_train(A, "f32", seed)
    sync = moe_sync_check(A, net)
    emit("moe.sync", **sync, card=card_line())
    served = moe_serve(A, net, seed)
    emit("moe.serve", **served)
    del net
    free_card()
    rows["bf16"], net = phase_moe_train(A, "bf16", seed)
    del net
    free_card()
    fused_row = moe_fused(A, seed)
    emit("moe.fused", **fused_row)
    out = {"train": rows, "sync": sync, "serve": served, "fused": fused_row,
           "flash_launches": sum(r["flash_launches"] for r in rows.values())
           + fused_row["flash_launches"] + served["flash_launches"],
           "flash_bwd_launches": sum(r["flash_bwd_launches"] for r in rows.values())
           + fused_row["flash_bwd_launches"] + sync["flash_bwd_launches"]}
    emit("moe", seconds=time.perf_counter() - t0, flash_launches=out["flash_launches"],
         flash_bwd_launches=out["flash_bwd_launches"], card=card_line())
    return out


# ---------------------------------------------------------------------------
# the flash block entry, then ring and Ulysses attention across ranks
# ---------------------------------------------------------------------------

def seq_block_checks(A, rs):
    """``flash_attention_block`` against its plain version on the card: out,
    lse and dq/dk/dv under random nonzero cotangents on out and lse, at
    B=4, H=8, D=64, T in {1000, 4096}, f32 and bf16, causal or not."""
    b, h, d = LM_BATCH, LM_HEADS, LM_WIDTH // LM_HEADS
    cases = []
    for t, dtype, causal in itertools.product((1000, LM_SEQ), (torch.float32, torch.bfloat16),
                                              (False, True)):
        f32 = dtype == torch.float32
        q, k, v, _ = qkv_views(rs, b, t, h, d, dtype, grad=True)
        pl = check_flash_plan(A, q, k, v)
        what = f"flash_attention_block T={t} {dtype} causal={causal} {pl.variant}"
        before = dict(A.launches_by_variant)
        out, lse = A.flash_attention_block(q, k, v, causal, None)
        out_p, lse_p = A.flash_attention_plain(q, k, v, causal=causal)
        if ran_variants(A, before) != [pl.variant]:
            raise AssertionError(f"{what}: ran {ran_variants(A, before)}")
        tol = (FLASH_F32_ATOL, 0.0) if f32 else (FLASH_BF16_TOL, FLASH_BF16_TOL)
        errs = {"out": check_close(f"{what} out", out, out_p, *tol),
                "lse": check_close(f"{what} lse", lse, lse_p, FLASH_LSE_ATOL, FLASH_LSE_RTOL)}
        g_out = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32)).to("cuda", dtype)
        g_lse = torch.from_numpy(rs.randn(b, h, t).astype(np.float32)).cuda()
        before = dict(A.launches_bwd_by_variant)
        got = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
        ran = {n: c - before[n] for n, c in A.launches_bwd_by_variant.items() if c != before[n]}
        want_bwd = "f32_3xtf32_wgmma" if f32 else "bf16_wgmma"
        if ran != {want_bwd: 1}:
            raise AssertionError(f"{what}: the backward ran {ran}, expected one {want_bwd}")
        want = torch.autograd.grad((out_p, lse_p), (q, k, v), (g_out, g_lse))
        gtol = (FLASH_GRAD_ATOL, FLASH_GRAD_RTOL) if f32 else (FLASH_BF16_TOL, FLASH_BF16_TOL)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = check_close(f"{what} {name}", a, w, *gtol)
        cases.append({"T": t, "dtype": str(dtype).split(".")[-1], "causal": causal,
                      "variant": pl.variant, **errs})
        del q, k, v, out, lse, out_p, lse_p, got, want
    torch.cuda.empty_cache()
    return cases


def seq_block_timing(A, rs):
    """The block entry at one ring block's shape (B=2, T_local=4096, H=8,
    D=64, not causal): forward back to back and on the card beside the
    bound, the plain version and SDPA's forward, and forward + backward
    with both cotangents; then flash blocks against the naive blocks of
    ``parallel/sequence.py``, forward + backward, at T_local in
    SEQ_BLOCK_T."""
    from deeplearning4j_tpu_torch.parallel import sequence as S

    b, h, d = SEQ_B, LM_HEADS, LM_WIDTH // LM_HEADS
    t = SEQ_T // SEQ_RANKS
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = qkv_views(rs, b, t, h, d, dtype)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: A.flash_attention_block(q, k, v, False, None)  # noqa: E731
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
        with torch.no_grad():
            ms = time_ms(kern, iters=10, reps=5)
            dev_ms = device_ms(kern, iters=10, reps=5)
            plain_ms = time_ms(lambda: A.flash_attention_plain(q, k, v), iters=10, reps=5)
            library_ms = time_ms(sdpa, iters=10, reps=5)
        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        g_out, g_lse = torch.randn_like(q), torch.randn(b, h, t, device="cuda")
        fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            A.flash_attention_block(qg, kg, vg, False, None), (qg, kg, vg), (g_out, g_lse)),
            iters=3, reps=5)
        bound_ms, bound_by = flash_bound(b, t, h, d, dtype, False)
        rows[dtype] = {"B": b, "T": t, "H": h, "D": d, "causal": False,
                       "dtype": str(dtype).split(".")[-1], "ms": ms, "device_ms": dev_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "fwd_bwd_ms": fwd_bwd_ms,
                       "bwd": flash_bwd_timing(A, q, k, v, g_out, False, g_lse=g_lse),
                       "card": card_line()}
        if dtype == torch.float32:
            # the route taken: three TF32 products per f32 product
            rows[dtype]["bound_3xtf32_ms"] = flash_bound_3xtf32(b, t, h, d, False)
            rows[dtype]["bwd"]["bound_3xtf32_ms"] = flash_bound_3xtf32(b, t, h, d, False,
                                                                       backward=True)
        emit("sequence.block_timing", **rows[dtype])
        del q, k, v, qh, kh, vh, qg, kg, vg
    crossover = []
    for t in SEQ_BLOCK_T:
        q, k, v, qkv = qkv_views(rs, b, t, h, d, torch.float32, grad=True)
        g_out, g_lse = torch.randn_like(q), torch.randn(b, h, t, device="cuda")
        scale = 1.0 / math.sqrt(d)
        flash_ms = time_ms(lambda: torch.autograd.grad(
            A.flash_attention_block(q, k, v, False, scale), qkv, (g_out, g_lse)),
            iters=3, reps=5)
        naive_ms = time_ms(lambda: torch.autograd.grad(
            S._naive_block(q, k, v, scale, None), qkv, (g_out, g_lse)), iters=3, reps=5)
        crossover.append({"T_local": t, "flash_ms": flash_ms, "naive_ms": naive_ms,
                          "speedup": naive_ms / flash_ms})
        del q, k, v, qkv
    torch.cuda.empty_cache()
    emit("sequence.blocks", B=b, H=h, D=d, causal=False, dtype="float32", rows=crossover,
         card=card_line())
    return rows, crossover


def seq_reference(A, q, k, v, g, causal):
    """Whole-T ``flash_attention`` on the card: out and dq, dk, dv of
    sum(out * g)."""
    qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = A.flash_attention(qq, kk, vv, causal=causal)
    return [out.detach()] + list(torch.autograd.grad(out, (qq, kk, vv), g))


def seq_compare(what, got, want):
    errs = {}
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        atol, rtol = (SEQ_FWD_ATOL, SEQ_FWD_RTOL) if name == "out" else \
            (SEQ_GRAD_ATOL, SEQ_GRAD_RTOL)
        errs[name] = check_close(f"{what} {name}", a, w, atol, rtol)
    return errs


def sequence_rank(rank, world, seed):
    """One rank of the sequence phase, in a process of its own on card 0
    (``run_ranks`` has joined it to the group): ring attention
    (``make_ring_attention_fn``, causal and not) over the whole [B, T, H, D]
    and Ulysses on the rank's slice, forward and backward, each held
    against whole-T ``flash_attention`` on the card; the flash launches of
    each, the ring's time, and one K/V hop and one block timed. Returns its
    row."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.parallel import (MeshSpec, make_mesh, make_ring_attention_fn,
                                                   ulysses_self_attention)
    from deeplearning4j_tpu_torch.parallel import sequence as S

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MeshSpec(data=1, seq=world))
    group = mesh.group("seq")
    rs = np.random.RandomState(seed)
    shape = (SEQ_B, SEQ_T, LM_HEADS, LM_WIDTH // LM_HEADS)
    q, k, v, g = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).cuda()
                  for _ in range(4))
    t_local = SEQ_T // world
    sl = slice(rank * t_local, (rank + 1) * t_local)
    row = {"rank": rank, "backend": dist.get_backend(group), "T_local": t_local}
    planned = A.plan((SEQ_B, t_local, LM_HEADS, LM_WIDTH // LM_HEADS), torch.float32).variant
    # warm-up: the first collectives open the ranks' connections
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    torch.autograd.grad(make_ring_attention_fn(mesh)(qq, kk, vv), (qq, kk, vv), g)
    ql, kl, vl = (x[:, sl].clone().requires_grad_(True) for x in (q, k, v))
    torch.autograd.grad(ulysses_self_attention(ql, kl, vl, group=group), (ql, kl, vl),
                        g[:, sl].contiguous())
    for causal in (False, True):
        fn = make_ring_attention_fn(mesh, causal=causal)
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        torch.cuda.synchronize()
        dist.barrier()
        A.reset_launches()
        t0 = time.perf_counter()
        out = fn(qq, kk, vv)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(out, (qq, kk, vv), g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, by_variant = A.launches, {n: c for n, c in A.launches_by_variant.items()
                                            if c}
        if launches != world or by_variant != {planned: world}:
            raise AssertionError(f"rank {rank} ring causal={causal}: flash launches "
                                 f"{by_variant}, expected {world} on {planned}")
        bwd, _ = bwd_launched(A, f"rank {rank} ring causal={causal}", None, BWD_F32)
        errs = seq_compare(f"rank {rank} ring causal={causal}", [out.detach(), *grads],
                           seq_reference(A, q, k, v, g, causal))
        row[f"ring_causal{int(causal)}"] = {"flash_launches": launches,
                                            "flash_bwd_launches": bwd, "max_abs_err": errs,
                                            "fwd_ms": 1e3 * (t1 - t0),
                                            "fwd_bwd_ms": 1e3 * (t2 - t0)}
        del qq, kk, vv, out, grads
    ql, kl, vl = (x[:, sl].clone().requires_grad_(True) for x in (q, k, v))
    torch.cuda.synchronize()
    dist.barrier()
    A.reset_launches()
    t0 = time.perf_counter()
    out = ulysses_self_attention(ql, kl, vl, group=group)
    grads = torch.autograd.grad(out, (ql, kl, vl), g[:, sl].contiguous())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.launches
    if launches != 1:
        raise AssertionError(f"rank {rank} Ulysses: {launches} flash launches, expected 1")
    bwd, _ = bwd_launched(A, f"rank {rank} Ulysses", 1, BWD_F32)
    ref = seq_reference(A, q, k, v, g, False)
    errs = seq_compare(f"rank {rank} Ulysses", [out.detach(), *grads],
                       [x[:, sl] for x in ref])
    row["ulysses"] = {"flash_launches": launches, "flash_bwd_launches": bwd,
                      "max_abs_err": errs, "fwd_bwd_ms": 1e3 * wall}
    del ql, kl, vl, out, grads, ref
    # one K/V hop through the host and one flash block, timed on every rank at once
    kv = torch.stack((k[:, sl], v[:, sl]))
    perm = [(j, (j + 1) % world) for j in range(world)]
    hops = []
    for _ in range(5):
        dist.barrier()
        t0 = time.perf_counter()
        S.ppermute(kv, perm, group)
        torch.cuda.synchronize()
        hops.append(1e3 * (time.perf_counter() - t0))
    dist.barrier()
    qb, kb, vb = (x[:, sl].contiguous() for x in (q, k, v))
    block_ms = time_ms(lambda: A.flash_attention_block(qb, kb, vb, False, None),
                       iters=10, reps=5)
    row.update({"hop_ms": statistics.median(hops), "hop_mb": kv.numel() * 4 / 1e6,
                "block_ms": block_ms})
    dist.barrier()
    return row


def seq_degenerate(A, rs):
    """The ring at world size 1 over NCCL in this process: one diagonal
    block, equal to ``flash_attention``."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh, make_ring_attention_fn

    work = WORK / "degenerate"
    work.mkdir(parents=True)
    dist.init_process_group("nccl", init_method=f"file://{work / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        shape = (SEQ_B, SEQ_T // SEQ_RANKS, LM_HEADS, LM_WIDTH // LM_HEADS)
        q, k, v, g = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).cuda()
                      for _ in range(4))
        fn = make_ring_attention_fn(make_mesh(MeshSpec(seq=1)), causal=True)
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = fn(qq, kk, vv)
        got = [out.detach()] + list(torch.autograd.grad(out, (qq, kk, vv), g))
        errs = seq_compare("world-1 ring", got, seq_reference(A, q, k, v, g, True))
        return {"backend": dist.get_backend(), "world": dist.get_world_size(), "shape": shape,
                "max_abs_err": errs}
    finally:
        dist.destroy_process_group()


#: the rank cells registered by their phases: (name, world, timeout_s,
#: rank-body kwargs, finish), run together by ``run_rank_cells``
RANK_CELLS = []
RANK_BODIES = {}


def add_rank_cell(name, world, timeout_s, kwargs, finish):
    """Register a phase's rank cell: its body runs on every rank of the one
    spawn, ``finish(ranks, ranks_s)`` after it, with the ranks' rows."""
    if world != RANK_CELLS_WORLD:
        raise AssertionError(f"rank cell {name}: world {world}, the spawn's is "
                             f"{RANK_CELLS_WORLD}")
    RANK_CELLS.append((name, timeout_s, kwargs, finish))


def rank_cells(rank, world, cells):
    """One rank of the one spawn: each registered cell's body in turn, as a
    process of its own would have run it (the kernels' launch counts, the
    matmul and cuDNN precision flags, the dtype policy and the telemetry
    state reset before each; its memory freed after), between barriers.
    Returns {"rows": {cell: row}, "seconds": {cell: s}}."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.nn import fused
    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.ops import conv_stats as C
    from deeplearning4j_tpu_torch.ops import lstm_seq as L
    from deeplearning4j_tpu_torch.utils import dtypes

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    policy = dtypes.get_policy()
    out = {"rows": {}, "seconds": {}}
    for name, kwargs in cells:
        A.reset_launches()
        C.reset_launches()
        L.reset_launches()
        fused.reset_replay_launches()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
        torch.set_float32_matmul_precision(flags[2])
        dtypes.set_policy(policy.param_dtype, policy.compute_dtype, policy.accum_dtype)
        telemetry.reset()
        telemetry.disable()
        dist.barrier()
        t0 = time.perf_counter()
        out["rows"][name] = RANK_BODIES[name](rank, world, **kwargs)
        torch.cuda.synchronize()
        dist.barrier()
        out["seconds"][name] = time.perf_counter() - t0
        free_card()
    return out


def run_rank_cells():
    """The one spawn of 4 ranks (gloo, card 0) that runs every registered
    cell's body in turn, then each cell's finish in order. Returns
    {cell: what its finish returned}; {} with no cell registered."""
    from deeplearning4j_tpu_torch.parallel.launch import run_ranks

    cells, RANK_CELLS[:] = list(RANK_CELLS), []
    if not cells:
        return {}
    free_card()
    t0 = time.perf_counter()
    rows = run_ranks(rank_cells, RANK_CELLS_WORLD, RANKS_WORK / "ranks", backend="gloo",
                     device=0, timeout=sum(c[1] for c in cells),
                     cells=[(name, kwargs) for name, _, kwargs, _ in cells])
    spawn_s = time.perf_counter() - t0
    cell_s = {name: rows[0]["seconds"][name] for name, *_ in cells}
    emit("ranks", world=RANK_CELLS_WORLD, backend="gloo", cells=list(cell_s),
         seconds=spawn_s, cell_seconds=cell_s,
         start_and_stop_seconds=spawn_s - sum(cell_s.values()), card=card_line())
    return {name: finish([r["rows"][name] for r in rows], cell_s[name])
            for name, _, _, finish in cells}


def phase_sequence(A, seed):
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed + 5)
    with library_precision():
        cases = seq_block_checks(A, rs)
        timing, crossover = seq_block_timing(A, rs)
    emit("sequence.block", cases=len(cases), cases_detail=cases, f32_atol=FLASH_F32_ATOL,
         lse_atol=FLASH_LSE_ATOL, lse_rtol=FLASH_LSE_RTOL, grad_atol=FLASH_GRAD_ATOL,
         grad_rtol=FLASH_GRAD_RTOL, bf16_tol=FLASH_BF16_TOL,
         max_abs_err_f32={k: max(c[k] for c in cases if c["dtype"] == "float32")
                          for k in ("out", "lse", "dq", "dk", "dv")},
         card=card_line())
    # NCCL refuses two ranks on one GPU: the ranks run over gloo in the one
    # spawn of the rank cells
    backend = "gloo"
    degenerate = seq_degenerate(A, rs)
    emit("sequence.degenerate", **degenerate, card=card_line())
    prep_s = time.perf_counter() - t0

    def finish(ranks, ranks_s):
        emit("sequence.ranks", world=SEQ_RANKS, backend=backend, B=SEQ_B, T=SEQ_T,
             H=LM_HEADS, D=LM_WIDTH // LM_HEADS, dtype="float32", ranks=ranks,
             fwd_rtol=SEQ_FWD_RTOL, fwd_atol=SEQ_FWD_ATOL, grad_rtol=SEQ_GRAD_RTOL,
             grad_atol=SEQ_GRAD_ATOL, card=card_line())
        launches, bwd = (sum(r[key][name] for r in ranks
                             for key in ("ring_causal0", "ring_causal1", "ulysses"))
                         for name in ("flash_launches", "flash_bwd_launches"))
        emit("sequence", seconds=prep_s + ranks_s, ranks_seconds=ranks_s,
             flash_launches_in_ranks=launches, flash_bwd_launches_in_ranks=bwd, card=card_line())
        return {"cases": cases, "timing": timing, "crossover": crossover, "backend": backend,
                "ranks": ranks, "flash_launches": launches, "flash_bwd_launches": bwd,
                "max_abs_err": max(max(c[k] for k in ("out", "lse", "dq", "dk", "dv"))
                                   for c in cases if c["dtype"] == "float32")}

    add_rank_cell("sequence", SEQ_RANKS, SEQ_TIMEOUT_S, dict(seed=seed + 6), finish)


# ---------------------------------------------------------------------------
# parallel: ParallelTrainer, the TrainingMasters and ParallelInference
# ---------------------------------------------------------------------------

def dp_trainer(net, layout, mesh):
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer

    return ParallelTrainer(net, mesh, shard_optimizer_state=layout != "replicated",
                           shard_params={"fsdp": "fsdp", "fsdp_stream": "fsdp_stream"}.get(layout))


def dp_snapshot(net, loss):
    """(loss, {path: parameter}, {path: state}) of a net, on the host."""
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    return (float(loss), {k: v.detach().float().cpu() for k, v in flatten_tree(net.params).items()},
            {k: v.detach().float().cpu() for k, v in flatten_tree(net.state).items()})


def dp_diff(a, b):
    """How far snapshot ``a`` is from ``b``: relative loss difference, the
    state's max |diff| relative to each tensor's magnitude (at least 1),
    the parameters' max |diff| and the parameter elements beyond
    RN_PARAM_ATOL, and whether all are equal to the bit."""
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "state_max_rel": max([((a[2][k] - b[2][k]).abs().max() /
                                   b[2][k].abs().max().clamp_min(1.0)).item() for k in b[2]]
                                 or [0.0]),
            "param_max_abs": max((a[1][k] - b[1][k]).abs().max().item() for k in b[1]),
            "params_beyond_atol": sum(int(((a[1][k] - b[1][k]).abs() > RN_PARAM_ATOL).sum())
                                      for k in b[1]),
            "bit_equal": a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in b[1])
            and all(torch.equal(a[2][k], b[2][k]) for k in b[2])}


def dp_hold(what, kp, qp, factor=DP_NOISE_FACTOR, loss_rtol=RN_LOSS_RTOL):
    """Hold ``kp`` (a dp_diff from the reference) within ``factor`` x the
    noise ``qp`` (the reference's step on the batch permuted): loss within
    ``loss_rtol``, BN state within RN_STATE_ATOL of each tensor's
    magnitude, parameters beyond RN_PARAM_ATOL at most ``factor`` x the
    noise's count plus DP_SIGN_FLIPS. Bit-equal passes."""
    if kp["bit_equal"]:
        return {"diff": kp, "noise": qp}
    if not kp["loss_rel"] <= loss_rtol:
        raise AssertionError(f"{what}: loss differs by {kp['loss_rel']} relative")
    if not kp["state_max_rel"] <= RN_STATE_ATOL:
        raise AssertionError(f"{what}: BN state differs by {kp['state_max_rel']} relative")
    if not kp["params_beyond_atol"] <= factor * qp["params_beyond_atol"] + DP_SIGN_FLIPS:
        raise AssertionError(f"{what}: {kp['params_beyond_atol']} parameters beyond "
                             f"{RN_PARAM_ATOL}, against {qp['params_beyond_atol']} from noise")
    return {"diff": kp, "noise": qp}


def dp_fit_step(seed, x, y, make=None):
    """The first ``fit`` step of a fresh net from ``seed``: its snapshot."""
    net = (make or make_resnet)(seed)
    net.fit(x, y, batch_size=x.shape[0])
    out = dp_snapshot(net, net.score_history[0])
    del net
    return out


def dp_world1(C, seed, x, y):
    """(a): the trainer at world 1 over NCCL in this process (see the
    module docstring). Returns the rows and the timed launches."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn import fused
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.utils import dtypes

    work = WORK / "dp_nccl"
    work.mkdir(parents=True)
    dist.init_process_group("nccl", init_method=f"file://{work / 'rendezvous'}", rank=0,
                            world_size=1)
    rows, launched = [], {n: 0 for n in C.launches}
    try:
        mesh = make_mesh()
        x0, y0 = x[:RN_BATCH], y[:RN_BATCH]
        perm = torch.randperm(RN_BATCH, generator=torch.Generator().manual_seed(seed)).cuda()
        for policy in ("f32", "bf16"):
            (dtypes.bf16_policy if policy == "bf16" else dtypes.f32_policy)()
            if policy == "f32":
                ref = dp_fit_step(seed, x0, y0)
                noise = dp_diff(dp_fit_step(seed, x0[perm], y0[perm]), ref)
            for layout in DP_LAYOUTS:
                net = make_resnet(seed)
                tr = dp_trainer(net, layout, mesh).adopt_net_state()
                first = tr.step(x0, y0)
                check = None
                if policy == "f32":
                    tr.sync_to_net()
                    check = dp_hold(f"world-1 {layout} step vs fit",
                                    dp_diff(dp_snapshot(net, first), ref), noise)
                tr.step(x[RN_BATCH:2 * RN_BATCH], y[RN_BATCH:2 * RN_BATCH])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                C.reset_launches()
                t0 = time.perf_counter()
                losses = [tr.step(x[i * RN_BATCH:(i + 1) * RN_BATCH],
                                  y[i * RN_BATCH:(i + 1) * RN_BATCH])
                          for i in range(2, 2 + RN_TIMED_STEPS)]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                losses = [float(first)] + [float(v) for v in losses]
                want = {"conv_mm_stats": 36 * RN_TIMED_STEPS, "conv3x3_stats": 16 * RN_TIMED_STEPS}
                hopper = "bf16_wgmma" if policy == "bf16" else "f32_pipelined"
                if dict(C.launches) != want or C.launches_by_variant[hopper] != sum(want.values()):
                    raise AssertionError(f"{layout}/{policy}: conv launches {C.launches} by "
                                         f"variant {C.launches_by_variant}, expected {want} "
                                         f"on {hopper}")
                if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                    raise AssertionError(f"{layout}/{policy}: loss did not fall: {losses}")
                for n in launched:
                    launched[n] += C.launches[n]
                row = {"layout": layout, "policy": policy, "world": 1, "backend": "nccl",
                       "steps": RN_TIMED_STEPS, "step_ms": 1e3 * wall / RN_TIMED_STEPS,
                       "images_per_s": RN_BATCH * RN_TIMED_STEPS / wall,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "conv_launches": dict(C.launches), "loss_first": losses[0],
                       "loss_last": losses[-1], "step_check": check, **tr.tree_bytes()}
                emit("parallel.world1", **row, card=card_line())
                rows.append(row)
                del tr, net
                torch.cuda.empty_cache()
        dtypes.f32_policy()
        # K=4 through the trainer: one CUDA graph over the steps and their
        # collectives, the conv launches from its replays
        net = make_resnet(seed)
        tr = dp_trainer(net, "zero1", mesh).adopt_net_state()
        fused.reset_replay_launches()
        C.reset_launches()
        n = 2 * DP_K * RN_BATCH
        tr.fit(x[:n], y[:n], batch_size=RN_BATCH, steps_per_dispatch=DP_K)
        torch.cuda.synchronize()
        eng = tr._steps_fns_fused[DP_K]
        replayed = {k: fused.replay_launches.get(f"conv_stats.{k}", 0) for k in C.launches}
        want = {"conv_mm_stats": 36 * 2 * DP_K, "conv3x3_stats": 16 * 2 * DP_K}
        # the capture's eager warm-up runs (every step a no-op) launch too
        eager = {k: v * fused.WARMUP_RUNS // 2 for k, v in want.items()}
        if eng.captures != 1 or eng.replays != 2 or replayed != want or \
                dict(C.launches) != {k: want[k] + eager[k] for k in want}:
            raise AssertionError(f"K={DP_K}: captures {eng.captures}, replays {eng.replays}, "
                                 f"replayed launches {replayed}, counted {C.launches}, "
                                 f"expected {want} from replays and {eager} eager")
        losses = [float(v) for v in tr.score_history]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"K={DP_K}: losses {losses}")
        for k in launched:
            launched[k] += C.launches[k]
        emit("parallel.world1_fused", k=DP_K, layout="zero1", dispatches=eng.replays,
             captures=eng.captures, replayed_launches=replayed, warmup_launches=eager,
             losses=losses, card=card_line())
        serve = dp_serve(seed, tr.sync_to_net(), x)
        del tr, net
        torch.cuda.empty_cache()
        dp_lm_world1(mesh, seed)
    finally:
        dtypes.f32_policy()
        dist.destroy_process_group()
    return rows, launched, serve, ref, noise


def dp_lm_world1(mesh, seed):
    """The LM's fsdp and fsdp_stream steps at world 1 (every leaf whole, so
    no collective moves data): what the streamed step's recompute costs
    without ranks sharing the card. One warm-up and one timed step each."""
    lx, ly = lm_data(np.random.RandomState(seed + 7), LM_BATCH)
    rows = {}
    for layout in DP_LM_LAYOUTS:
        net = make_lm(seed)
        tr = dp_trainer(net, layout, mesh).adopt_net_state()
        tr.step(lx, ly)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(tr.step(lx, ly))
        torch.cuda.synchronize()
        rows[layout] = {"step_ms": 1e3 * (time.perf_counter() - t0), "loss": loss,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del tr, net
        torch.cuda.empty_cache()
    emit("parallel.lm_world1", batch=LM_BATCH, T=LM_SEQ, **rows, card=card_line())
    return rows


def dp_serve(seed, net, x):
    """ParallelInference over the trained net: a burst of single images
    against ``output`` on the same rows, then a hot swap to another net
    whose answers must be its own."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    imgs = x[:DP_SERVE_REQUESTS]
    pi = ParallelInference(net, max_batch_size=DP_SERVE_BATCH).start()
    try:
        futures = [pi.submit(imgs[i].cpu().numpy()) for i in range(DP_SERVE_REQUESTS)]
        got = np.stack([f.get(timeout=120) for f in futures])
        want = np.concatenate([net.output(imgs[i:i + DP_SERVE_BATCH]).cpu().numpy()
                               for i in range(0, DP_SERVE_REQUESTS, DP_SERVE_BATCH)])
        err = float(np.abs(got - want).max())
        other = make_resnet(seed + 1)
        pi.update_model(other)
        swapped = np.stack([pi.submit(imgs[i].cpu().numpy()).get(timeout=120)
                            for i in range(DP_SERVE_BATCH)])
        want2 = other.output(imgs[:DP_SERVE_BATCH]).cpu().numpy()
        err2 = float(np.abs(swapped - want2).max())
        moved = float(np.abs(swapped - got[:DP_SERVE_BATCH]).max())
    finally:
        pi.stop()
    if not (err <= DP_SERVE_ATOL and err2 <= DP_SERVE_ATOL and moved > DP_SERVE_ATOL):
        raise AssertionError(f"ParallelInference: answers off output by {err}, after the "
                             f"swap by {err2}, moved by {moved}")
    row = {"requests": DP_SERVE_REQUESTS, "max_batch": DP_SERVE_BATCH, "max_abs_err": err,
           "swap_max_abs_err": err2, "swap_moved": moved, "atol": DP_SERVE_ATOL}
    emit("parallel.inference", **row, card=card_line())
    return row


def dp_per_worker_step(seed, x, y, perm=None):
    """The per-worker-statistics step the exact SharedTrainingMaster takes:
    each worker's gradient on its own DP_RANKS-th of the batch with its own
    batch statistics, the gradients averaged, one updater step from fresh
    state, the BN state the mean of the workers'. ``perm`` permutes the
    rows within each worker (the step's noise)."""
    net = make_resnet(seed)
    b = x.shape[0] // DP_RANKS
    grads, states, losses = [], [], []
    for w in range(DP_RANKS):
        rows = slice(w * b, (w + 1) * b)
        xw, yw = x[rows], y[rows]
        if perm is not None:
            xw, yw = xw[perm], yw[perm]
        loss, st, g = net.compute_gradients(net.params, net.state, xw, yw)
        grads.append(g)
        states.append(st)
        losses.append(float(loss))
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like
    mean = tree_like(grads[0], iter([sum(ls) / DP_RANKS for ls in
                                     zip(*[list(tree_leaves(g)) for g in grads])]))
    net.state = tree_like(states[0], iter([sum(ls) / DP_RANKS for ls in
                                           zip(*[list(tree_leaves(s)) for s in states])]))
    net.opt_state = net.conf.updater.init(net.params)
    net.apply_update(net.params, net.opt_state, mean, 0)
    out = dp_snapshot(net, sum(losses) / DP_RANKS)
    del net
    return out


def dp_rank(rank, world, seed, refs):
    """One rank of (b)-(d), on card 0 over gloo (see the module docstring).
    Returns its row."""
    import faulthandler

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.ops import conv_stats as C
    from deeplearning4j_tpu_torch.parallel import (ParameterAveragingTrainingMaster,
                                                   SharedTrainingMaster, make_mesh)
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    faulthandler.dump_traceback_later(DP_HANG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh()
    r = torch.load(refs, map_location="cpu", weights_only=False)
    x, y = r["x"].cuda(), r["y"].cuda()
    row = {"rank": rank, "backend": dist.get_backend(), "resnet": {}, "lm": {}}

    def state_equal_on_ranks(net):
        flat = torch.cat([v.detach().float().reshape(-1).cpu()
                          for v in flatten_tree(net.state).values()])
        mine = flat.clone()
        dist.broadcast(flat, 0)
        return float((mine - flat).abs().max())

    # (b) one step a layout on the global batch, against world 1, after one
    # warm-up step (the kernels' first launches, the first exchanges)
    net = make_resnet(seed)
    dp_trainer(net, "replicated", mesh).adopt_net_state().step(x, y)
    del net
    for layout in DP_LAYOUTS:
        net2 = make_resnet(seed)
        tr = dp_trainer(net2, layout, mesh).adopt_net_state()
        C.reset_launches()
        tr.timing = True
        t0 = time.perf_counter()
        loss = tr.step(x, y)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        tr.timing = False
        launches = dict(C.launches)
        tr.sync_to_net()
        if launches != {"conv_mm_stats": 36, "conv3x3_stats": 16}:
            raise AssertionError(f"rank {rank} {layout}: conv launches {launches}")
        held = dp_hold(f"rank {rank} {layout} step vs world 1",
                       dp_diff(dp_snapshot(net2, loss), r["ref"]), r["noise"])
        row["resnet"][layout] = {"loss": float(loss), "step_ms": step_ms,
                                 "collective_ms": tr.collective_ms[-1], "conv_launches": launches,
                                 "state_max_abs_vs_rank0": state_equal_on_ranks(net2),
                                 "check": held, **tr.tree_bytes()}
        del tr, net2
        torch.cuda.empty_cache()

    # (c) the LM under fsdp and fsdp_stream, 1 sequence a rank
    lx, ly = lm_data(np.random.RandomState(seed + 7), LM_BATCH)
    for layout in DP_LM_LAYOUTS:
        net = make_lm(seed)
        tr = dp_trainer(net, layout, mesh).adopt_net_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        tr.timing = True
        t0 = time.perf_counter()
        loss = tr.step(lx, ly)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        flash = A.launches
        bwd, _ = bwd_launched(A, f"rank {rank} LM {layout}", None, BWD_F32)
        tr.sync_to_net()
        held = dp_hold(f"rank {rank} LM {layout} step vs world 1",
                       dp_diff(dp_snapshot(net, loss), r["lm_ref"]), r["lm_noise"],
                       loss_rtol=STEP_LOSS_RTOL)
        # fsdp_stream recomputes each block's forward in the backward (the
        # checkpoint region that re-gathers the block): 6 more launches
        want = LM_LAYERS * (2 if layout == "fsdp_stream" else 1)
        if flash != want:
            raise AssertionError(f"rank {rank} LM {layout}: {flash} flash launches a step, "
                                 f"expected {want}")
        row["lm"][layout] = {"loss": float(loss), "step_ms": step_ms, "peak_bytes": peak,
                             "collective_ms": tr.collective_ms[-1], "flash_launches": flash,
                             "flash_bwd_launches": bwd, "check": held, **tr.tree_bytes()}
        del tr, net
        torch.cuda.empty_cache()

    # (d) the exact SharedTrainingMaster against per-worker statistics, then
    # threshold mode, then parameter averaging on LeNet
    C.reset_launches()
    net = make_resnet(seed)
    net.opt_state = net.conf.updater.init(net.params)
    master = SharedTrainingMaster(mesh, batch_size_per_worker=RN_BATCH // world)
    t0 = time.perf_counter()
    loss_e = master.execute_training(net, x, y)
    torch.cuda.synchronize()
    exact_ms = 1e3 * (time.perf_counter() - t0)
    snap = dp_snapshot(net, loss_e)
    pw = dp_hold(f"rank {rank} shared exact vs per-worker", dp_diff(snap, r["pw_ref"]),
                 r["pw_noise"])
    vs_global = dp_diff(snap, r["ref"])
    xt, yt = resnet_data(seed + 3, (DP_SHARED_STEPS - 1) * RN_BATCH)
    losses_e = [loss_e, master.execute_training(net, xt, yt)]  # the exact steps after it
    del net
    net = make_resnet(seed)
    master_t = SharedTrainingMaster(mesh, batch_size_per_worker=RN_BATCH // world,
                                    threshold=DP_THRESHOLD)
    xt, yt = resnet_data(seed + 3, DP_SHARED_STEPS * RN_BATCH)
    loss_t = master_t.execute_training(net, xt, yt)
    stats = master_t.training_stats()
    row["shared"] = {"exact_ms": exact_ms, "exact_check": pw, "exact_losses": losses_e,
                     "exact_steps": master.training_stats()["steps"],
                     "exact_vs_global_stats_step": vs_global,
                     "threshold": {"steps": stats["steps"], "densities": stats["densities"],
                                   "final_threshold": stats["final_threshold"],
                                   "loss": loss_t},
                     "conv_launches": dict(C.launches)}
    del net
    torch.cuda.empty_cache()
    lenet = mnist_net(seed)
    pa = ParameterAveragingTrainingMaster(mesh, batch_size_per_worker=DP_PA_BATCH,
                                          averaging_frequency=DP_PA_FREQ)
    losses = [pa.execute_training(lenet, r["mx"], r["my"]) for _ in range(2)]
    flat = torch.cat([v.detach().reshape(-1).cpu() for v in flatten_tree(lenet.params).values()])
    mine = flat.clone()
    dist.broadcast(flat, 0)
    row["param_averaging"] = {"params": lenet.num_params(), "losses": losses,
                              "splits": pa.training_stats()["splits"],
                              "params_max_abs_vs_rank0": float((mine - flat).abs().max())}
    faulthandler.cancel_dump_traceback_later()
    return row


def phase_parallel(C, A, seed):
    t0 = time.perf_counter()
    x, y = resnet_data(seed, RN_BATCH * (2 + RN_TIMED_STEPS))
    rows, launched, serve, ref, noise = dp_world1(C, seed, x, y)
    x0, y0 = x[:RN_BATCH], y[:RN_BATCH]
    # the references the ranks hold their steps to
    b = RN_BATCH // DP_RANKS
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(seed)).cuda()
    pw_ref = dp_per_worker_step(seed, x0, y0)
    pw_noise = dp_diff(dp_per_worker_step(seed, x0, y0, perm), pw_ref)
    rs = np.random.RandomState(seed + 7)
    lx, ly = lm_data(rs, LM_BATCH)
    lm_ref = dp_fit_step(seed, lx, ly, make_lm)
    lperm = torch.tensor([1, 0, 3, 2]).cuda()
    lm_noise = dp_diff(dp_fit_step(seed, lx[lperm], ly[lperm], make_lm), lm_ref)
    mrs = np.random.RandomState(seed + 9)
    n_pa = DP_RANKS * DP_PA_FREQ * DP_PA_BATCH * DP_PA_SPLITS
    mx = mrs.rand(n_pa, 28, 28, 1).astype(np.float32)
    my = np.eye(10, dtype=np.float32)[mrs.randint(0, 10, n_pa)]
    refs = WORK / "dp_refs.pt"
    torch.save({"x": x0.cpu(), "y": y0.cpu(), "ref": ref, "noise": noise, "pw_ref": pw_ref,
                "pw_noise": pw_noise, "lm_ref": lm_ref, "lm_noise": lm_noise, "mx": mx,
                "my": my}, refs)
    del x, y, lx, ly
    free_card()
    prep_s = time.perf_counter() - t0
    add_rank_cell("parallel", DP_RANKS, DP_TIMEOUT_S, dict(seed=seed, refs=str(refs)),
                  lambda ranks, ranks_s: parallel_finish(C, prep_s, rows, launched, serve,
                                                         ranks, ranks_s))


def parallel_finish(C, prep_s, rows, launched, serve, ranks, ranks_s):
    """The parallel phase after the spawn: the ranks' rows checked and
    printed."""
    t0 = time.perf_counter()
    for layout in DP_LAYOUTS:
        states = [rk["resnet"][layout]["state_max_abs_vs_rank0"] for rk in ranks]
        if max(states) != 0.0:
            raise AssertionError(f"{layout}: BN running statistics differ across ranks {states}")
        emit("parallel.resnet_ranks", layout=layout, world=DP_RANKS, backend="gloo",
             batch=RN_BATCH, rows_a_rank=RN_BATCH // DP_RANKS,
             ranks=[{"rank": rk["rank"], **rk["resnet"][layout]} for rk in ranks],
             card=card_line())
    peaks = {layout: [rk["lm"][layout]["peak_bytes"] for rk in ranks] for layout in DP_LM_LAYOUTS}
    emit("parallel.lm_ranks", world=DP_RANKS, backend="gloo", batch=LM_BATCH, T=LM_SEQ,
         layouts=DP_LM_LAYOUTS, ranks=[{"rank": rk["rank"], **rk["lm"]} for rk in ranks],
         peak_bytes=peaks, streaming_lowers_peak=max(peaks["fsdp_stream"]) < min(peaks["fsdp"]),
         card=card_line())
    if any(rk["param_averaging"]["params_max_abs_vs_rank0"] != 0.0 for rk in ranks):
        raise AssertionError("parameter averaging left the ranks' parameters unequal")
    emit("parallel.masters", world=DP_RANKS, backend="gloo",
         shared=[{"rank": rk["rank"], **rk["shared"]} for rk in ranks],
         param_averaging=[{"rank": rk["rank"], **rk["param_averaging"]} for rk in ranks],
         card=card_line())
    rank_conv = {k: sum(rk["resnet"][lay]["conv_launches"][k] for rk in ranks
                        for lay in DP_LAYOUTS) + sum(rk["shared"]["conv_launches"][k]
                                                     for rk in ranks) for k in C.launches}
    flash, bwd = (sum(rk["lm"][lay][name] for rk in ranks for lay in DP_LM_LAYOUTS)
                  for name in ("flash_launches", "flash_bwd_launches"))
    seconds = prep_s + ranks_s + time.perf_counter() - t0
    emit("parallel", seconds=seconds, ranks_seconds=ranks_s, conv_launches_world1=launched,
         conv_launches_ranks=rank_conv, flash_launches_ranks=flash,
         flash_bwd_launches_ranks=bwd, card=card_line())
    return {"rows": rows, "serve": serve, "ranks": ranks,
            "conv_launches": {k: launched[k] + rank_conv[k] for k in C.launches},
            "flash_launches": flash, "flash_bwd_launches": bwd}


# ---------------------------------------------------------------------------
# model_parallel: tensor/expert parallelism, the pipelines, the composed LM
# ---------------------------------------------------------------------------

def mp_launches(A, C, L):
    """Every kernel's launch count so far in this process."""
    return {"flash_attn": A.launches, "flash_attn_bwd": A.launches_bwd,
            "conv_mm_stats": C.launches["conv_mm_stats"],
            "conv3x3_stats": C.launches["conv3x3_stats"], "lstm_seq": L.launches}


def mp_since(A, C, L, before):
    now = mp_launches(A, C, L)
    return {k: now[k] - before[k] for k in now}


def grad_gap(got, want):
    """Each leaf's largest |got - want| over the larger of its own largest
    |want| and MP_GRAD_FLOOR x the largest of all the leaves; (worst, its
    leaf)."""
    floor = MP_GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    return max((float((got[k].float().cpu() - want[k]).abs().max())
                / max(float(want[k].abs().max()), floor), k) for k in want)


def mp_lm_grads(lm, ids, labels):
    """(loss, {path: gradient} of this rank's parameters with blocks named
    by their index in the model) of one pipelined step without the update."""
    from deeplearning4j_tpu_torch.parallel.pipeline import _by_block
    from deeplearning4j_tpu_torch.utils import dtypes
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    with dtypes.policy_precision():
        loss, grads = lm._loss_and_grads(ids, labels)
    tree = _by_block(grads, lm.link.s * lm.per_stage, lm.per_stage)
    return float(loss), flatten_tree(tree)


def mp_lm_cell(A, C, L, make, ids, labels, ref, cut=None):
    """One LM pipeline on this rank, both schedules: the gradients of a
    step against the world-1 step's (``ref``; ``cut(path, grad)`` takes this
    rank's slice of a reference gradient), the loss against
    ``loss_reference`` and the world-1 loss, then one timed step."""
    out = {}
    for sched in ("gpipe", "1f1b"):
        lm = make(sched)
        before = mp_launches(A, C, L)
        loss, grads = mp_lm_grads(lm, ids, labels)
        want = {k: (cut(k, ref["grads"][k]) if cut else ref["grads"][k]) for k in grads}
        gap, leaf = grad_gap(grads, want)
        seq_loss = float(lm.loss_reference(ids, labels))
        for what, got in (("pipelined loss", loss), ("loss_reference", seq_loss)):
            if not abs(got - ref["loss"]) <= STEP_LOSS_RTOL * abs(ref["loss"]):
                raise AssertionError(f"{sched}: {what} {got} against the world-1 step's "
                                     f"{ref['loss']}")
        if not gap <= MP_GRAD_RTOL:
            raise AssertionError(f"{sched}: gradient {leaf} off the world-1 step's by {gap} "
                                 "of its largest")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lm.timing = True
        flash0 = A.launches
        t0 = time.perf_counter()
        step_loss = float(lm.step(ids, labels))
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        flash = A.launches - flash0
        want_flash = lm.per_stage * lm.n_micro
        if flash < want_flash or not np.isfinite(step_loss):
            raise AssertionError(f"{sched}: {flash} flash launches a step, at least "
                                 f"{want_flash} expected; loss {step_loss}")
        out[sched] = {"loss": loss, "loss_reference": seq_loss, "world1_loss": ref["loss"],
                      "grad_gap": gap, "grad_gap_leaf": leaf, "step_ms": step_ms,
                      "wait_ms": lm.wait_ms[-1], "bubble_share": lm.wait_ms[-1] / step_ms,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "stashed_microbatches": lm.last_peak_stash, "flash_a_step": flash,
                      "launches": mp_since(A, C, L, before)}
        del lm
        torch.cuda.empty_cache()
    return out


def mp_timed_step(model, step):
    """(ms, ms waiting in hops, peak bytes) of one more step of a pipeline,
    after its checked one (the warm-up)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.timing = True
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    model.timing = False
    return ms, model.wait_ms[-1], torch.cuda.max_memory_allocated()


def moe_block_drops(net, x):
    """Tokens each MoE block of ``net`` (whole parameters) drops on ``x``:
    over the whole batch, or under an active batch group over the global
    one (``x`` this rank's rows, the count this rank's share)."""
    acts = net.feed_forward(x)
    out = []
    with torch.inference_mode():
        for i, block in moe_blocks(net):
            h = block.mlp_input(net.params[i], acts[i - 1])[1]
            out.append(int((~block.route(net.params[i], h.reshape(-1, h.shape[-1])).keep).sum()))
    del acts
    return out


@contextlib.contextmanager
def captured_update_grads(tr):
    """The gradients a ZeRO trainer's updater receives (this rank's shard
    of each trainable leaf's exchanged gradient), on the host, a list a
    step."""
    upd = tr.net.conf.updater
    seen, update = [], upd.update_

    def update_(views, grads, opt, step):
        seen.append([g.detach().float().cpu() for g in grads])
        return update(views, grads, opt, step)
    object.__setattr__(upd, "update_", update_)
    try:
        yield seen
    finally:
        object.__delattr__(upd, "update_")


def shard_of_world1(tr, mesh, w1):
    """{path: this rank's piece of the world-1 gradient} for a trainer's
    trainable leaves: its model slice, then its data shard."""
    from deeplearning4j_tpu_torch.utils import collectives as K
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    names = list(flatten_tree(tr.net.params))
    out, j = {}, 0
    for i, (name, tr_leaf) in enumerate(zip(names, tr._trainable_mask)):
        if not tr_leaf:
            continue
        g = w1[name]
        d = tr._tp_dims[i] if tr._mg is not None else None
        if d is not None:
            g = K.local_slice(g, d, mesh.coords["model"], mesh.shape["model"])
        out[name] = tr._plan.shard(j, g).contiguous()
        j += 1
    return out


def mp_split_step(A, C, L, tr, mesh, x, y, ref, what):
    """One step of a data x model trainer on the global batch: the gradient
    each rank's updater receives against its piece of the world-1 step's
    (``ref``: loss and gradients), the loss against world 1's, flash
    launches a rank."""
    want = shard_of_world1(tr, mesh, ref["grads"])
    before = mp_launches(A, C, L)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured_update_grads(tr) as seen:
        loss = float(tr.step(x, y))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    launched = mp_since(A, C, L, before)
    got = dict(zip(want, seen[0]))
    gap, leaf = grad_gap(got, want)
    if not abs(loss - ref["loss"]) <= STEP_LOSS_RTOL * abs(ref["loss"]):
        raise AssertionError(f"{what}: loss {loss} against world 1's {ref['loss']}")
    if not gap <= MP_GRAD_RTOL:
        raise AssertionError(f"{what}: gradient {leaf} off world 1's by {gap} of its largest")
    return {"loss": loss, "world1_loss": ref["loss"], "grad_gap": gap, "grad_gap_leaf": leaf,
            "step_ms": step_ms, "launches": launched}


def make_noisy_lm(seed):
    """The LM with additive normal weight noise (std MP_NOISE_STD) on its
    embedding and output layer, the leaves tensor parallelism splits."""
    import dataclasses

    from deeplearning4j_tpu_torch.models.misc import transformer_lm
    from deeplearning4j_tpu_torch.nn.initializers import Distribution
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.weightnoise import WeightNoise

    conf = transformer_lm(LM_VOCAB, n_layers=LM_LAYERS, d_model=LM_WIDTH, n_heads=LM_HEADS,
                          seq_len=LM_SEQ)
    wn = WeightNoise(distribution=Distribution(kind="normal", mean=0.0, std=MP_NOISE_STD),
                     apply_to_bias=True)
    layers = list(conf.layers)
    for i in (0, len(layers) - 1):
        layers[i] = dataclasses.replace(layers[i], weight_noise=wn)
    net = MultiLayerNetwork(dataclasses.replace(conf, layers=tuple(layers)), device="cuda")
    net.init(torch.Generator().manual_seed(seed))
    return net


def mp_rank(rank, world, seed, refs):
    """One rank of the model_parallel cells (a)-(f), on card 0 over gloo
    (see the module docstring). Returns its row."""
    import faulthandler

    from deeplearning4j_tpu_torch.models import resnet50
    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.ops import conv_stats as C
    from deeplearning4j_tpu_torch.ops import lstm_seq as L
    from deeplearning4j_tpu_torch.parallel import (ComposedParallelLM, MeshSpec,
                                                   ParallelInference, ParallelTrainer,
                                                   PipelinedGraph, PipelinedNetwork,
                                                   PipelineParallelLM, make_mesh)
    from deeplearning4j_tpu_torch.parallel.composed import BLOCK_SPLIT
    from deeplearning4j_tpu_torch.utils import collectives as K
    from deeplearning4j_tpu_torch.utils import dtypes
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree, tree_leaves

    faulthandler.dump_traceback_later(MP_HANG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    r = torch.load(refs, map_location="cpu", weights_only=False)
    row = {"rank": rank}
    start = mp_launches(A, C, L)

    # (a) tensor + expert parallelism under a data axis: the MoE LM on
    # data=2 x model=2, routed over the global batch
    mesh = make_mesh(MeshSpec(data=MP_DATA, model=MP_TP))
    net = make_moe_lm(seed, r["moe_capacity"])
    tr = ParallelTrainer(net, mesh, tensor_parallel=True).adopt_net_state()
    experts = {k: tuple(v.shape) for k, v in flatten_tree(net.params).items() if "expert_" in k}
    if any(s[0] != MOE_EXPERTS // MP_TP for s in experts.values()):
        raise AssertionError(f"rank {rank}: expert leaves {experts}")
    x, y = r["moe_x"].cuda(), r["moe_y"].cuda()
    xl, yl = tr._local(x), tr._local(y)
    # the first step's routing over the global batch: each block's drops
    # (this rank's share, summed over the data group) against world 1's
    tr.sync_to_net()
    with K.sync_batch(tr._bg), dtypes.policy_precision():
        drops = torch.tensor(moe_block_drops(net, xl), dtype=torch.float64)
    drops = [int(v) for v in K.all_reduce_(drops, tr.group)]
    tr._tp_local()
    # the gradients of the split step, each leaf (its data group's mean)
    # against this rank's slice of the world-1 step's
    before = mp_launches(A, C, L)
    with K.sync_batch(tr._bg), K.sync_model(tr._mg), dtypes.policy_precision():
        leaves = list(tree_leaves(net._watch(net.params)))
        g_loss, _ = net.loss_fn(net.params, net.state, xl, yl, train=True)
        gs = torch.autograd.grad(g_loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    names = list(flatten_tree(net.params))
    got = {k: K.all_reduce_((torch.zeros_like(t) if g is None else g).contiguous().clone(),
                            tr.group) / tr.world
           for k, t, g in zip(names, leaves, gs)}
    g_loss = float(K.all_reduce_(g_loss.detach().reshape(1).clone(), tr.group)[0]) / tr.world
    want = {k: (r["moe_grads"][k] if d is None else
                K.local_slice(r["moe_grads"][k], d, mesh.coords["model"], MP_TP))
            for k, d in zip(names, tr._tp_dims)}
    grad_gap_a, grad_leaf_a = grad_gap(got, want)
    if not abs(g_loss - r["moe_grad_loss"]) <= STEP_LOSS_RTOL * abs(r["moe_grad_loss"]):
        raise AssertionError(f"rank {rank}: split loss {g_loss} against world 1's "
                             f"{r['moe_grad_loss']}")
    if not grad_gap_a <= MP_GRAD_RTOL:
        raise AssertionError(f"rank {rank}: TP+EP gradient {grad_leaf_a} off world 1's by "
                             f"{grad_gap_a} of its largest")
    del got, gs, want
    torch.cuda.synchronize()
    tr.timing = True
    t0 = time.perf_counter()
    loss = tr.step(x, y)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    launched = mp_since(A, C, L, before)
    stored = tr.tree_bytes()
    tr.sync_to_net()
    # no permutation noise here: the sequences' order decides which tokens
    # the experts' capacity drops, so a swap is another step; the gradient
    # check above is the gate, and the update may flip at most
    # DP_SIGN_FLIPS near-zero gradients' Adam steps
    held = dp_hold(f"rank {rank} TP+EP step vs world 1", dp_diff(dp_snapshot(net, loss),
                                                                 r["moe_ref"]),
                   {"params_beyond_atol": 0}, loss_rtol=STEP_LOSS_RTOL)
    if launched["flash_attn"] < LM_LAYERS:
        raise AssertionError(f"rank {rank}: {launched['flash_attn']} flash launches in the "
                             f"TP+EP step, at least {LM_LAYERS} expected")
    digest = {k: (float(v.double().sum()), float((v.double() ** 2).sum()))
              for k, v in flatten_tree(net.params).items()}
    # the TP trainer's sharded checkpoint: each rank writes its pieces
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    SC.save_trainer(r["ckpt"], tr)
    save_s = time.perf_counter() - t0
    row["tp_ep"] = {"mesh": f"data={MP_DATA} x model={MP_TP}", "loss": float(loss),
                    "world1_loss": r["moe_ref"][0], "step_ms": step_ms,
                    "capacity_factor": r["moe_capacity"], "drops": drops,
                    "world1_drops": r["moe_drops"], "grad_gap": grad_gap_a,
                    "grad_gap_leaf": grad_leaf_a,
                    "model_collective_ms": tr.model_collective_ms[-1],
                    "data_collective_ms": tr.collective_ms[-1], "expert_leaf_shapes": experts,
                    "check": held, "launches": launched, "ckpt_save_s": save_s,
                    "ckpt_digest": digest if rank == 0 else None, **stored}
    del tr, net
    free_card()

    # the LM under tensor_parallel + fsdp_stream, then with weight noise,
    # on data=2 x model=2: one step each against world 1
    sx, sy = r["stream_x"].cuda(), r["stream_y"].cuda()
    net = make_lm(seed)
    tr = ParallelTrainer(net, mesh, tensor_parallel=True,
                         shard_params="fsdp_stream").adopt_net_state()
    row["tp_stream"] = mp_split_step(A, C, L, tr, mesh, sx, sy, r["stream_ref"],
                                     f"rank {rank} TP + fsdp_stream")
    row["tp_stream"]["trunk"] = list(tr._trunk)
    if row["tp_stream"]["launches"]["flash_attn"] != 2 * LM_LAYERS:
        raise AssertionError(f"rank {rank}: {row['tp_stream']['launches']['flash_attn']} flash "
                             f"launches in the streamed step, {2 * LM_LAYERS} expected (the "
                             "recompute)")
    del tr, net
    free_card()
    net = make_noisy_lm(seed)
    tr = ParallelTrainer(net, mesh, tensor_parallel=True).adopt_net_state()
    row["tp_noise"] = mp_split_step(A, C, L, tr, mesh, sx, sy, r["noise_ref"],
                                    f"rank {rank} TP + weight noise")
    del tr, net
    free_card()

    ids, labels = r["lm_ids"].cuda(), r["lm_labels"].cuda()
    lm_kw = dict(vocab_size=LM_VOCAB, n_layers=LM_LAYERS, d_model=LM_WIDTH, n_heads=LM_HEADS,
                 seq_len=LM_SEQ, device="cuda")

    # (b) PipelineParallelLM on data=2 x stage=2
    mesh2 = make_mesh(MeshSpec(data=2, stage=2))
    row["pipeline_lm"] = mp_lm_cell(
        A, C, L, lambda s: PipelineParallelLM(mesh=mesh2, schedule=s, n_microbatches=MP_MICRO,
                                              **lm_kw).init(torch.Generator().manual_seed(seed)),
        ids, labels, r["lm_ref"])
    free_card()

    # (c) ComposedParallelLM on stage=2 x model=2
    mesh22 = make_mesh(MeshSpec(data=1, model=2, stage=2))

    def cut(path, g):
        key = path.split("['")[-1].rstrip("']")
        d = BLOCK_SPLIT.get(key) if "blocks" in path else None
        return g if d is None else K.local_slice(g, d, mesh22.coords["model"], 2)
    row["composed"] = mp_lm_cell(
        A, C, L, lambda s: ComposedParallelLM(mesh=mesh22, schedule=s, n_microbatches=MP_MICRO,
                                              **lm_kw).init(torch.Generator().manual_seed(seed)),
        ids, labels, r["comp_ref"], cut)
    free_card()

    # (d) PipelinedGraph over the fused ResNet50 on stage=4
    mesh4 = make_mesh(MeshSpec(data=1, stage=4))
    rx, ry = r["rn_x"].cuda(), r["rn_y"].cuda()
    conf = resnet50(RN_HW, RN_HW, n_classes=RN_CLASSES, fused=True)
    row["resnet"] = {}
    for sched in ("gpipe", "1f1b"):
        pg = PipelinedGraph(conf, mesh4, n_microbatches=MP_RN_MICRO, schedule=sched,
                            device="cuda").init(torch.Generator().manual_seed(seed))
        before = mp_launches(A, C, L)
        loss = float(pg.step(rx, ry))  # the checked step, from the seed's weights
        launched = mp_since(A, C, L, before)
        state = {k: v.float().cpu() for k, v in flatten_tree(pg.state).items()}
        step_ms, wait_ms, peak = mp_timed_step(pg, lambda: pg.step(rx, ry))
        ref_state = r["rn_ref"]["state"]
        mine = {k: ref_state[k] for k in state}
        state_gap = max([float(((state[k] - mine[k]).abs().max()
                                / mine[k].abs().max().clamp_min(1.0))) for k in state] or [0.0])
        if not abs(loss - r["rn_ref"]["loss"]) <= RN_LOSS_RTOL * abs(r["rn_ref"]["loss"]):
            raise AssertionError(f"rank {rank} resnet {sched}: loss {loss} against the "
                                 f"sequential per-microbatch run's {r['rn_ref']['loss']}")
        if not state_gap <= RN_STATE_ATOL:
            raise AssertionError(f"rank {rank} resnet {sched}: BN state off by {state_gap}")
        row["resnet"][sched] = {"loss": loss, "ref_loss": r["rn_ref"]["loss"],
                                "state_gap": state_gap, "step_ms": step_ms,
                                "wait_ms": wait_ms, "peak_bytes": peak,
                                "stashed_microbatches": pg.last_peak_stash,
                                "vertices": len(pg.groups[pg.stage]), "launches": launched}
        del pg
        free_card()

    # (e) PipelinedNetwork over the char-RNN on data=2 x stage=2, masked
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    cx, cy, cm = r["ch_x"].cuda(), r["ch_y"].cuda(), r["ch_mask"].cuda()
    conf = text_generation_lstm(VOCAB, hidden=HIDDEN, seq_len=SEQ)
    row["charnn"] = {}
    for sched in ("gpipe", "1f1b"):
        pn = PipelinedNetwork(conf, mesh2, n_microbatches=MP_CH_MICRO,
                              stage_layers=[[0], [1, 2]], schedule=sched,
                              device="cuda").init(torch.Generator().manual_seed(seed))
        before = mp_launches(A, C, L)
        loss = float(pn.step(cx, cy, mask=cm))  # the checked step
        launched = mp_since(A, C, L, before)
        step_ms, wait_ms, _ = mp_timed_step(pn, lambda: pn.step(cx, cy, mask=cm))
        if not abs(loss - r["ch_ref"]) <= MP_CH_LOSS_RTOL * abs(r["ch_ref"]):
            raise AssertionError(f"rank {rank} charnn {sched}: loss {loss} against the "
                                 f"sequential run's {r['ch_ref']}")
        if launched["lstm_seq"] != MP_CH_MICRO:
            raise AssertionError(f"rank {rank} charnn {sched}: {launched['lstm_seq']} "
                                 f"lstm_seq launches, {MP_CH_MICRO} expected")
        row["charnn"][sched] = {"loss": loss, "ref_loss": r["ch_ref"], "step_ms": step_ms,
                                "wait_ms": wait_ms, "launches": launched}
        del pn
    free_card()

    # (f) ParallelInference over data=4 on the fused ResNet50, unpipelined
    net = make_resnet(seed)
    pi = ParallelInference(net, max_batch_size=MP_INFER_REQUESTS,
                           mesh=make_mesh(MeshSpec(data=MP_RANKS)))
    ix = r["inf_x"].cuda()
    before = mp_launches(A, C, L)
    got = np.asarray(pi.output(ix.cpu().numpy()))  # requests arrive from the host
    launched = mp_since(A, C, L, before)

    def output(rows):
        y = net.output(rows)
        y = next(iter(y.values())) if isinstance(y, dict) else y
        return y if isinstance(y, np.ndarray) else y.detach().cpu().numpy()
    per = pi.max_batch // MP_RANKS  # the rows each rank answers
    by_rank = np.concatenate([output(ix[i:i + per]) for i in range(0, ix.shape[0], per)])
    whole = output(ix)
    if got.shape != whole.shape:
        raise AssertionError(f"rank {rank}: split answers {got.shape}, {whole.shape} expected")
    row_gap = (np.abs(got - by_rank).max(1) / np.abs(by_rank).max(1)).max()
    if not row_gap <= MP_INFER_ROW_RTOL:
        raise AssertionError(f"rank {rank}: a split answer row off output() on its rank's rows "
                             f"by {row_gap} of its largest")
    gap = np.abs(got - whole).max(1)
    top2 = np.sort(whole, 1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * gap
    flips = int((decided & (got.argmax(1) != whole.argmax(1))).sum())
    if flips:
        raise AssertionError(f"rank {rank}: {flips} split answers' top class differs from "
                             "output() on the whole batch")
    row["inference"] = {"requests": int(ix.shape[0]), "row_gap_by_rank": float(row_gap),
                        "max_abs_err_whole": float(gap.max()),
                        "row_gap_whole": float((gap / np.abs(whole).max(1)).max()),
                        "top_class_decided": int(decided.sum()), "max_batch": pi.max_batch,
                        "launches": launched}
    del pi, net
    free_card()
    row["launches"] = mp_since(A, C, L, start)
    faulthandler.cancel_dump_traceback_later()
    return row


def mp_world1_grads(lm, ids, labels):
    """The world-1 step's loss and gradients (whole, by path) of an LM
    pipeline, on the host."""
    loss, grads = mp_lm_grads(lm, ids, labels)
    return {"loss": loss, "grads": {k: v.float().cpu() for k, v in grads.items()}}


def mp_references(seed):
    """What the ranks hold their cells to, computed here at world 1."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import (ComposedParallelLM, MeshSpec,
                                                   PipelineParallelLM, make_mesh)
    from deeplearning4j_tpu_torch.utils import dtypes
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    from deeplearning4j_tpu_torch.nn.layers.base import step_seed

    refs = {}
    # (a) the MoE LM's first fit step and its gradients, at a capacity at
    # which a block drops tokens
    rs = np.random.RandomState(seed + 11)
    mx, my = lm_data(rs, MP_MOE_BATCH)
    cap = MOE_CAPACITY
    while True:
        net = make_moe_lm(seed, cap)
        with dtypes.policy_precision():
            drops = moe_block_drops(net, mx)
        if sum(drops) or cap <= MP_CAPACITY_MIN:
            break
        del net
        cap = round(cap * MP_CAPACITY_STEP, 4)
    if not sum(drops):
        raise AssertionError(f"no MoE block drops a token down to capacity factor {cap}")
    refs["moe_capacity"], refs["moe_drops"] = cap, drops
    with dtypes.policy_precision():  # as every training step runs
        loss, _, grads = net.compute_gradients(net.params, net.state, mx, my)
    refs["moe_grad_loss"] = float(loss)
    refs["moe_grads"] = {k: v.float().cpu() for k, v in flatten_tree(grads).items()}
    del net, grads
    free_card()
    refs["moe_ref"] = dp_fit_step(seed, mx, my, lambda s: make_moe_lm(s, cap))
    refs["moe_x"], refs["moe_y"] = mx.cpu(), my.cpu()
    free_card()
    # the LM's gradients at world 1 for the TP + fsdp_stream cell, and the
    # noisy LM's with the step's seed (the same hashed draws)
    sx, sy = lm_data(np.random.RandomState(seed + 29), MP_STREAM_BATCH)
    for key, make in (("stream_ref", make_lm), ("noise_ref", make_noisy_lm)):
        net = make(seed)
        with dtypes.policy_precision():
            loss, _, grads = net.compute_gradients(net.params, net.state, sx, sy,
                                                   rng=step_seed(net.conf.seed, 0))
        refs[key] = {"loss": float(loss),
                     "grads": {k: v.float().cpu() for k, v in flatten_tree(grads).items()}}
        del net, grads
        free_card()
    refs["stream_x"], refs["stream_y"] = sx.cpu(), sy.cpu()
    # (b), (c) one unpipelined step of each LM on the whole batch at world 1
    x, y = lm_data(np.random.RandomState(seed + 13), MP_LM_BATCH)
    ids, labels = x[..., 0].long(), y.argmax(-1)
    work = WORK / "mp_nccl"
    work.mkdir(parents=True)
    dist.init_process_group("nccl", init_method=f"file://{work / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(MeshSpec())
        kw = dict(vocab_size=LM_VOCAB, n_layers=LM_LAYERS, d_model=LM_WIDTH, n_heads=LM_HEADS,
                  seq_len=LM_SEQ, n_microbatches=1, mesh=mesh, device="cuda")
        lm = PipelineParallelLM(**kw).init(torch.Generator().manual_seed(seed))
        if lm.num_params() != LM_PARAMS:
            raise AssertionError(f"PipelineParallelLM has {lm.num_params()} params")
        refs["lm_ref"] = mp_world1_grads(lm, ids, labels)
        del lm
        lm = ComposedParallelLM(**kw).init(torch.Generator().manual_seed(seed))
        refs["comp_ref"] = mp_world1_grads(lm, ids, labels)
        del lm
    finally:
        dist.destroy_process_group()
    refs["lm_ids"], refs["lm_labels"] = ids.cpu(), labels.cpu()
    free_card()
    # (d) the sequential per-microbatch run of the fused ResNet50 (state
    # threaded from microbatch k to k + 1, train-mode statistics)
    rx, ry = resnet_data(seed + 17, RN_BATCH)
    net = make_resnet(seed)
    mb = RN_BATCH // MP_RN_MICRO
    state, losses = net.state, []
    with torch.no_grad(), dtypes.policy_precision():
        for k in range(MP_RN_MICRO):
            loss, (state, _) = net.loss_fn(net.params, state, rx[k * mb:(k + 1) * mb],
                                           ry[k * mb:(k + 1) * mb], train=True)
            losses.append(float(loss))
    refs["rn_ref"] = {"loss": float(np.mean(losses)),
                      "state": {k: v.float().cpu() for k, v in flatten_tree(state).items()}}
    refs["rn_x"], refs["rn_y"] = rx.cpu(), ry.cpu()
    del net
    free_card()
    # (e) the char-RNN's masked loss on the whole batch (no batch statistics:
    # the sequential per-microbatch run's loss)
    crs = np.random.RandomState(seed + 19)
    cx, cy = charnn_data(crs, MP_CH_BATCH, SEQ)
    cm = torch.from_numpy((crs.rand(MP_CH_BATCH, SEQ) > 0.3).astype(np.float32)).cuda()
    cm[:, 0] = 1.0
    net = make_charnn(seed)
    with torch.no_grad(), dtypes.policy_precision():
        refs["ch_ref"] = float(net.loss_fn(net.params, net.state, cx, cy, train=True,
                                           mask=cm)[0])
    refs["ch_x"], refs["ch_y"], refs["ch_mask"] = cx.cpu(), cy.cpu(), cm.cpu()
    del net
    # (f) the requests
    refs["inf_x"] = resnet_data(seed + 23, MP_INFER_REQUESTS)[0].cpu()
    free_card()
    return refs


def mp_restore_world1(seed, ranks):
    """Cell (a)'s TP sharded checkpoint (data=2 x model=2) restored into a
    world-1 trainer over NCCL here: the parameters against the saving
    ranks' (per-leaf sums and sums of squares, float64), the iteration,
    one more finite step; save and restore wall times."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelTrainer, make_mesh
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    ckpt = WORK / "mp_ckpt"
    index = SC.read_index(ckpt)
    shard_bytes = sum(f.stat().st_size for f in ckpt.glob("shard-*.pt"))
    want = ranks[0]["tp_ep"]["ckpt_digest"]
    work = WORK / "mp_restore"
    work.mkdir(parents=True)
    dist.init_process_group("nccl", init_method=f"file://{work / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        net = make_moe_lm(seed, ranks[0]["tp_ep"]["capacity_factor"])
        tr = ParallelTrainer(net, make_mesh(MeshSpec())).adopt_net_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SC.restore_trainer(ckpt, tr)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        gap = 0.0
        for k, v in flatten_tree(tr.net.params).items():
            s1, s2 = float(v.double().sum()), float((v.double() ** 2).sum())
            gap = max(gap, abs(s1 - want[k][0]) / max(abs(want[k][0]), 1e-12),
                      abs(s2 - want[k][1]) / max(abs(want[k][1]), 1e-12))
        if not gap <= 1e-9 or tr.iteration != 1:
            raise AssertionError(f"restored TP checkpoint: digest gap {gap}, iteration "
                                 f"{tr.iteration}")
        x, y = lm_data(np.random.RandomState(seed + 11), MP_MOE_BATCH)
        loss = float(tr.step(x, y))
        if not np.isfinite(loss):
            raise AssertionError(f"the restored trainer's step gave {loss}")
        del tr, net
    finally:
        dist.destroy_process_group()
    free_card()
    return {"saved_by": f"data={index['world']} x model={index['model_world']}",
            "restored_at": "world 1", "bytes": shard_bytes,
            "save_s": [rk["tp_ep"]["ckpt_save_s"] for rk in ranks], "restore_s": restore_s,
            "digest_gap": gap, "next_loss": loss, "card": card_line()}


def phase_model_parallel(seed):
    t0 = time.perf_counter()
    refs = mp_references(seed)
    emit("model_parallel.references", moe_grad_loss=refs["moe_grad_loss"],
         lm_loss=refs["lm_ref"]["loss"], composed_loss=refs["comp_ref"]["loss"],
         resnet_loss=refs["rn_ref"]["loss"], charnn_loss=refs["ch_ref"],
         seconds=time.perf_counter() - t0, card=card_line())
    path = WORK / "mp_refs.pt"
    refs["ckpt"] = str(WORK / "mp_ckpt")
    torch.save(refs, path)
    del refs
    free_card()
    prep_s = time.perf_counter() - t0
    add_rank_cell("model_parallel", MP_RANKS, MP_TIMEOUT_S, dict(seed=seed, refs=str(path)),
                  lambda ranks, ranks_s: model_parallel_finish(seed, prep_s, ranks, ranks_s))


def model_parallel_finish(seed, prep_s, ranks, ranks_s):
    """The model_parallel phase after the spawn: the ranks' cells checked
    and printed, the TP checkpoint restored at world 1."""
    t0 = time.perf_counter()
    tp_ep = [{"rank": rk["rank"], **{k: v for k, v in rk["tp_ep"].items() if k != "ckpt_digest"}}
             for rk in ranks]
    if not any(sum(rk["drops"]) for rk in tp_ep):
        raise AssertionError("no MoE block dropped a token on the global batch")
    emit("model_parallel.tp_ep", mesh=f"data={MP_DATA} x model={MP_TP}", world=MP_RANKS,
         backend="gloo", batch=MP_MOE_BATCH, T=LM_SEQ, params=MOE_PARAMS, ranks=tp_ep,
         card=card_line())
    for cell, what in (("tp_stream", "tensor_parallel + fsdp_stream"),
                       ("tp_noise", f"tensor_parallel + weight noise (std {MP_NOISE_STD})")):
        emit(f"model_parallel.{cell}", what=what, mesh=f"data={MP_DATA} x model={MP_TP}",
             batch=MP_STREAM_BATCH, T=LM_SEQ, params=LM_PARAMS,
             ranks=[{"rank": rk["rank"], **rk[cell]} for rk in ranks], card=card_line())
    emit("model_parallel.tp_checkpoint", **mp_restore_world1(seed, ranks))
    for cell, mesh in (("pipeline_lm", "data=2 x stage=2"), ("composed", "stage=2 x model=2")):
        emit(f"model_parallel.{cell}", mesh=mesh, batch=MP_LM_BATCH, microbatches=MP_MICRO,
             T=LM_SEQ, params=LM_PARAMS, ranks=[{"rank": rk["rank"], **rk[cell]} for rk in ranks],
             card=card_line())
    conv = {k: sum(rk["resnet"][s]["launches"][k] for rk in ranks for s in ("gpipe", "1f1b"))
            for k in ("conv_mm_stats", "conv3x3_stats")}
    want = {"conv_mm_stats": 2 * 36 * MP_RN_MICRO, "conv3x3_stats": 2 * 16 * MP_RN_MICRO}
    if conv != want:
        raise AssertionError(f"pipelined ResNet50: conv launches {conv}, expected {want}")
    emit("model_parallel.resnet", mesh="stage=4", batch=RN_BATCH, microbatches=MP_RN_MICRO,
         params=RN_PARAMS, ranks=[{"rank": rk["rank"], **rk["resnet"]} for rk in ranks],
         conv_launches=conv, card=card_line())
    emit("model_parallel.charnn", mesh="data=2 x stage=2", batch=MP_CH_BATCH,
         microbatches=MP_CH_MICRO, T=SEQ, params=N_PARAMS,
         ranks=[{"rank": rk["rank"], **rk["charnn"]} for rk in ranks], card=card_line())
    emit("model_parallel.inference", mesh="data=4",
         ranks=[{"rank": rk["rank"], **rk["inference"]} for rk in ranks], card=card_line())
    launches = {k: sum(rk["launches"][k] for rk in ranks) for k in ranks[0]["launches"]}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the model-parallel paths never launched: {launches}")
    emit("model_parallel", seconds=prep_s + ranks_s + time.perf_counter() - t0,
         ranks_seconds=ranks_s, launches=launches, card=card_line())
    return {"ranks": ranks, "launches": launches}


# ---------------------------------------------------------------------------
# telemetry: the port's telemetry core on the card (registry, spans, traces,
# flight recorder, HBM gauges, the profile window)
# ---------------------------------------------------------------------------

def tel_lm_fit(net, x, y, steps):
    """``steps`` fit steps of the LM on one batch, on the host clock to a
    synchronize, with the host's waits on the card counted. Returns (ms a
    step, syncs)."""
    with counted_syncs() as box:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(((x, y) for _ in range(steps)))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
    return ms, box["n"]


def tel_profile_window(A, net, x, y):
    """One ``profile_round`` window around one StepDriver round of one
    dispatch: the trace's ``fit.step`` ranges, the flash kernels' device
    events (one a block, each launched inside the range), the trace's
    launches without a device event and the lag of device events behind
    their launches (``launch_check``), and ``top_ops``."""
    from deeplearning4j_tpu_torch.continuous.driver import StepDriver
    from deeplearning4j_tpu_torch.telemetry import profiling as TPR
    from deeplearning4j_tpu_torch.utils import dtypes
    from deeplearning4j_tpu_torch.utils import profiling as UP

    logdir = WORK / "tel_profile"
    drv = StepDriver(net, lambda: iter([(x, y, None)] * 2))
    drv.profile_round(2, str(logdir))
    flash0, bwd0 = A.launches, A.launches_bwd
    with dtypes.policy_precision():
        drv.run_round(1)   # not profiled
        drv.run_round(1)   # the window
        drv.sync()
    drv.close_source()
    doc = json.loads((logdir / TPR.TRACE_NAME).read_text())
    evs = doc["traceEvents"]
    cpu_ranges = [e for e in evs if e.get("name") == "fit.step" and e.get("ph") == "X"
                  and e.get("cat") != "gpu_user_annotation"]
    # the forward's kernels (the backward's, flash_bwd_*, launch 2 a block)
    kernels = [e for e in evs if e.get("cat") == "kernel" and "flash" in e.get("name", "")
               and "flash_bwd" not in e.get("name", "")]
    launch_ts = {e.get("args", {}).get("correlation"): e["ts"] for e in evs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "Launch" in e.get("name", "")}
    inside = [any(r["ts"] <= launch_ts.get(k.get("args", {}).get("correlation"), -1)
                  <= r["ts"] + r["dur"] for r in cpu_ranges) for k in kernels]
    check = UP.launch_check(doc)
    # the step's launches that the trace holds without their device events,
    # in ms from the step's start
    lost = [(t - r["ts"]) / 1e3 for r in cpu_ranges for t in check["missing_ts"]
            if r["ts"] <= t <= r["ts"] + r["dur"]]
    top = UP.top_ops(logdir, k=8)  # warns when launches lack their events
    flash_rank = next((i for i, r in enumerate(top) if "flash" in (r["expression"] or "")),
                      None)
    # every flash launch of the step is accounted for: by its device event,
    # launched inside the range, or as a launch the trace kept without one;
    # with no launch lost, all 6 device events are there
    if (len(cpu_ranges) != 1 or not kernels or not all(inside)
            or not len(kernels) <= LM_LAYERS <= len(kernels) + len(lost)):
        raise AssertionError(f"profile window: {len(cpu_ranges)} fit.step ranges, "
                             f"{len(kernels)} flash kernels ({sum(inside)} launched inside), "
                             f"{A.launches - flash0} launched; launches without a device "
                             f"event {check}")
    if flash_rank is None and not check["missing"]:
        raise AssertionError(f"top_ops' top 8 lists no flash kernel: "
                             f"{[r['expression'][:60] for r in top]}")
    return {"fit_step_ranges": len(cpu_ranges), "flash_kernels": len(kernels),
            "flash_launched_in_range": sum(inside), "complete": not check["missing"],
            "lost_in_step_ms": lost, "launch_check": {k: v for k, v in check.items()
                                                      if k != "missing_ts"},
            "dispatch_launches": A.launches - flash0,
            "dispatch_bwd_launches": A.launches_bwd - bwd0, "top_ops_flash_rank": flash_rank,
            "top_ops": [{"name": (r["expression"] or "")[:80], "us": r["total_self_us"],
                         "n": r["occurrences"]} for r in top]}


def tel_serve(L, seed):
    """A burst of TEL_REQUESTS requests to the served char-RNN with
    telemetry on: the request counter, the latency histogram and the
    completed traces each count every request."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.telemetry import tracectx

    net = make_charnn(seed)
    eng = ServingEngine(net, name="charnn_tel", input_spec=(SEQ, VOCAB), max_batch_size=64,
                        max_queue=TEL_REQUESTS, device="cuda").start()
    rs = np.random.RandomState(seed + 31)
    xs = np.eye(VOCAB, dtype=np.float32)[rs.randint(0, VOCAB, (TEL_REQUESTS, SEQ))]
    lstm0, fwd0 = L.launches, eng.stats()["forward"]["forwards"]
    try:
        t0 = time.perf_counter()
        futs = [eng.submit(x) for x in xs]
        outs = [f.get(timeout=120) for f in futs]
        burst_s = time.perf_counter() - t0
    finally:
        eng.stop()
    reg = TT.get_registry()
    served = reg.get("serving_model_requests_total").value(model="charnn_tel", outcome="served")
    hist = reg.get("serving_model_latency_seconds").count(model="charnn_tel")
    traced = sum(1 for f in futs if f.trace_id)
    forwards = eng.stats()["forward"]["forwards"] - fwd0
    launches = L.launches - lstm0
    if not (served == hist == traced == len(outs) == TEL_REQUESTS):
        raise AssertionError(f"served burst: counter {served}, histogram {hist}, traces "
                             f"{traced}, answers {len(outs)} of {TEL_REQUESTS}")
    if tracectx.open_trace_count() or launches != 2 * forwards:
        raise AssertionError(f"served burst: {tracectx.open_trace_count()} traces open, "
                             f"{launches} lstm_seq launches for {forwards} forwards")
    del eng, net
    free_card()
    return {"requests": TEL_REQUESTS, "served_counter": served, "latency_hist_count": hist,
            "completed_traces": traced, "ring_kept": len(tracectx.get_ring().snapshot().get(
                "serving.request", [])), "forwards": forwards, "lstm_seq_launches": launches,
            "burst_s": burst_s, "p50_ms": 1e3 * reg.get("serving_latency_p50_seconds").value(
                model="charnn_tel")}


def tel_watchdog(seed):
    """A NaN in the last of 4 char-RNN batches with the watchdog recording
    and telemetry on: one anomaly, one flight dump in $DL4J_TPU_FLIGHT_DIR."""
    from deeplearning4j_tpu_torch.telemetry import flight, health

    flight_dir = WORK / "flight"
    os.environ["DL4J_TPU_FLIGHT_DIR"] = str(flight_dir)
    net = make_charnn(seed)
    x, y = charnn_data(np.random.RandomState(seed + 37), 16, SEQ)
    bad = x.clone()
    bad[0, 0, 0] = float("nan")
    health.enable(policy="record")
    try:
        net.fit([(x, y), (x, y), (x, y), (bad, y)].__iter__())
        anomalies = health.get_monitor().summary()["nonfinite_steps"]
    finally:
        health.get_monitor().reset()
        os.environ.pop("DL4J_TPU_FLIGHT_DIR")
    dumps = sorted(flight_dir.glob("dl4j_tpu_flight_*.json"))
    if anomalies != 1 or len(dumps) != 1:
        raise AssertionError(f"watchdog: {anomalies} anomalies, {len(dumps)} flight dumps")
    doc = json.loads(dumps[0].read_text())
    del net
    free_card()
    return {"anomalies": anomalies, "flight_dumps": len(dumps), "reason": doc["reason"],
            "records": doc["n_records"], "recorder_dumps": len(flight.get_recorder().dumps)}


def phase_telemetry(A, L, seed):
    """The telemetry core on the card (see the module docstring): the LM's
    step with telemetry off and on, the registry's train series, one
    profile window, the served burst, the HBM gauges and the watchdog's
    flight dump."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.telemetry import devices

    t_phase = time.perf_counter()
    TT.reset()
    TT.disable()
    net = make_lm(seed)
    x, y = lm_data(np.random.RandomState(seed + 41), LM_BATCH)
    flash0, bwd0 = A.launches, A.launches_bwd
    tel_lm_fit(net, x, y, 2)  # warm-up
    rows = {"off": [], "on": []}
    for _ in range(TEL_ROUNDS):
        for mode in ("off", "on"):
            (TT.enable if mode == "on" else TT.disable)()
            TT.reset()
            rows[mode].append(tel_lm_fit(net, x, y, TEL_STEPS))
    reg = TT.get_registry()
    step_count = reg.get("train_step_seconds").count()
    iters = reg.get("train_iterations_total").value()
    score = reg.get("train_score").value()
    if step_count != TEL_STEPS or iters != TEL_STEPS or score != net.score_history[-1]:
        raise AssertionError(f"train series: {step_count} step observations, {iters} "
                             f"iterations, score {score} against {net.score_history[-1]}")
    ms = {m: statistics.median(r[0] for r in rows[m]) for m in rows}
    syncs = {m: [r[1] for r in rows[m]] for m in rows}
    if syncs["on"] != syncs["off"]:
        raise AssertionError(f"telemetry on added host syncs to the LM step: {syncs}")
    if not ms["on"] <= TEL_OVERHEAD * ms["off"]:
        raise AssertionError(f"telemetry on: {ms['on']} ms a step against {ms['off']} off")
    lm_launches, lm_bwd = A.launches - flash0, A.launches_bwd - bwd0
    if lm_bwd != lm_launches:
        raise AssertionError(f"telemetry LM steps: {lm_launches} flash launches, {lm_bwd} "
                             "of the backward")
    window = tel_profile_window(A, net, x, y)
    del net
    free_card()
    # the HBM gauges against the allocator's own counters
    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    polled = devices.poll_memory()
    summary = devices.memory_summary()["devices"]["cuda:0"]
    allocated, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    gauge = reg.get("device_bytes_in_use").value(device="cuda:0")
    del keep
    if not (polled["device_bytes_in_use"] == gauge == allocated == summary["bytes_in_use"]
            and summary["peak_bytes"] == peak):
        raise AssertionError(f"HBM gauges {polled}, {summary} against allocated {allocated}, "
                             f"peak {peak}")
    served = tel_serve(L, seed)
    watchdog = tel_watchdog(seed)
    TT.disable()
    TT.reset()
    out = {"lm": {"steps": TEL_STEPS, "rounds": TEL_ROUNDS, "step_ms_off": ms["off"],
                  "step_ms_on": ms["on"], "on_over_off": ms["on"] / ms["off"],
                  "step_ms_all": {m: [r[0] for r in rows[m]] for m in rows},
                  "host_syncs": syncs, "train_step_seconds_count": step_count,
                  "score_gauge": score, "flash_launches": lm_launches,
                  "flash_bwd_launches": lm_bwd,
                  "watchdog": "off"},
           "profile_window": window,
           "hbm": {"bytes_in_use": allocated, "gauge": gauge, "peak_bytes": peak,
                   "limit": summary["bytes_limit"], "reserved": summary["reserved_bytes"]},
           "serve": served, "watchdog": watchdog, "seconds": time.perf_counter() - t_phase,
           "card": card_line()}
    emit("telemetry", **out)
    return {"flash_launches": lm_launches + window["dispatch_launches"],
            "flash_bwd_launches": lm_bwd + window["dispatch_bwd_launches"],
            "lstm_seq_launches": served["lstm_seq_launches"]}


# ---------------------------------------------------------------------------
# operations: the goodput ledger, hot swap, metering, health, the SLO engine,
# the metrics history, demand-derived buckets and federation
# ---------------------------------------------------------------------------

def ops_goodput(C, seed):
    """(a) The fused ResNet50 (f32 policy) through ``StepDriver``: the same
    rounds with telemetry off, then on with the goodput ledger, a
    checkpoint between the timed rounds. Returns the goodput row."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.continuous.driver import StepDriver
    from deeplearning4j_tpu_torch.models import resnet50_flops_per_example
    from deeplearning4j_tpu_torch.telemetry import goodput
    from deeplearning4j_tpu_torch.utils import dtypes

    dtypes.f32_policy()
    net = make_resnet(seed)
    x, y = resnet_data(seed + 43, RN_BATCH * OPS_RN_BATCHES)
    i_name, o_name = net.conf.inputs[0], net.conf.outputs[0]
    items = [({i_name: x[j * RN_BATCH:(j + 1) * RN_BATCH]},
              {o_name: y[j * RN_BATCH:(j + 1) * RN_BATCH]}, None) for j in range(OPS_RN_BATCHES)]
    n_items = RN_WARMUP_STEPS + RN_TIMED_STEPS
    flops_step = 3 * resnet50_flops_per_example() * RN_BATCH
    peak = goodput.device_peak_flops()
    if peak is None:
        raise AssertionError(f"device_peak_flops() knows no {torch.cuda.get_device_name(0)!r}")
    rows = {}
    launches = {"conv_mm_stats": 0, "conv3x3_stats": 0}
    for mode in ("off", "on"):
        (TT.enable if mode == "on" else TT.disable)()
        TT.reset()
        drv = StepDriver(net, lambda: iter([items[i % OPS_RN_BATCHES] for i in range(n_items)]))
        if goodput.get_ledger().active != (mode == "on"):
            raise AssertionError(f"telemetry {mode}: the driver left the goodput window "
                                 f"{'closed' if mode == 'on' else 'open'}")
        with dtypes.policy_precision():
            drv.run_round(RN_WARMUP_STEPS)
            drv.sync()
            torch.cuda.synchronize()
            C.reset_launches()
            ledger = goodput.get_ledger()
            ledger.set_flops_per_step(flops_step)
            ledger.set_peak_flops(peak)
            t0 = time.perf_counter()
            ledger.start()
            syncs, ckpt = [], {}
            for half in range(2):  # two rounds, a checkpoint between them
                with counted_syncs() as box:
                    drv.run_round(RN_TIMED_STEPS // 2)
                    drv.sync()
                syncs.append(box["n"])
                if half == 0 and mode == "on":
                    tc = time.perf_counter()
                    drv.checkpoint(str(WORK / "ops_ckpt.zip"))
                    ckpt["host_s"] = time.perf_counter() - tc
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            snap = ledger.snapshot()
        drv.close_source()
        got = dict(C.launches)
        want = {"conv_mm_stats": 36 * RN_TIMED_STEPS, "conv3x3_stats": 16 * RN_TIMED_STEPS}
        if got != want:
            raise AssertionError(f"telemetry {mode}: conv kernels launched {got} times in "
                                 f"{RN_TIMED_STEPS} steps (expected {want}: 36 + 16 a step)")
        for k in launches:
            launches[k] += got[k]
        rows[mode] = {"wall_s": wall, "host_syncs": syncs, "snapshot": snap, **ckpt}
    on = rows["on"]
    snap = on["snapshot"]
    if rows["off"]["host_syncs"] != on["host_syncs"]:
        raise AssertionError(f"the goodput ledger changed the fit's host syncs: off "
                             f"{rows['off']['host_syncs']}, on {on['host_syncs']}")
    total = sum(snap["seconds"].values())
    if not (snap["active"] and snap["steps"] == RN_TIMED_STEPS
            and abs(total - snap["window_s"]) <= OPS_GOODPUT_RTOL * snap["window_s"]):
        raise AssertionError(f"goodput: {snap['steps']} steps, categories {total} s against a "
                             f"window of {snap['window_s']} s")
    if not abs(snap["seconds"]["checkpoint"] - on["host_s"]) <= OPS_GOODPUT_RTOL * on["host_s"]:
        raise AssertionError(f"goodput checkpoint {snap['seconds']['checkpoint']} s against "
                             f"{on['host_s']} s on the host clock")
    mfu_host = flops_step * RN_TIMED_STEPS / (on["wall_s"] * peak)
    if not (snap["mfu"] is not None and 0 < snap["mfu"] <= 1
            and abs(snap["mfu"] - mfu_host) <= OPS_GOODPUT_RTOL * mfu_host):
        raise AssertionError(f"goodput MFU {snap['mfu']} against {mfu_host} from the host clock")
    losses = net.score_history
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ResNet50 losses not finite: {losses}")
    del net, x, y, items, drv
    free_card()
    return {"params": RN_PARAMS, "batch": RN_BATCH, "steps": RN_TIMED_STEPS,
            "flops_per_step": flops_step, "peak_flops": peak, "goodput": snap,
            "categories_sum_s": total, "checkpoint_host_s": on["host_s"],
            "mfu_host_clock": mfu_host,
            # the steps alone, without the checkpoint: the off run's wall
            "mfu_steps_off": flops_step * RN_TIMED_STEPS / (rows["off"]["wall_s"] * peak),
            "wall_s": {m: r["wall_s"] for m, r in rows.items()},
            "host_syncs": {m: r["host_syncs"] for m, r in rows.items()},
            "conv_launches": launches}, launches


def ops_requests(seed):
    """(b)'s traffic: OPS_REQUESTS one-hot requests of OPS_MIN_SEQ..SEQ
    steps from tenants acme and beta, with OPS_PROBES ``origin="probe"``
    requests spread among them (tenant None)."""
    rs = np.random.RandomState(seed + 47)
    probe_at = set(rs.choice(OPS_REQUESTS + OPS_PROBES, OPS_PROBES, replace=False).tolist())
    reqs, n_org = [], 0
    for i in range(OPS_REQUESTS + OPS_PROBES):
        steps = int(rs.randint(OPS_MIN_SEQ, SEQ + 1))
        x = np.eye(VOCAB, dtype=np.float32)[rs.randint(0, VOCAB, steps)]
        if i in probe_at:
            reqs.append((x, {"origin": "probe"}))
        else:
            reqs.append((x, {"tenant": ("acme", "beta")[n_org % 2]}))
            n_org += 1
    return reqs


def ops_serving(L, seed, hist, eng_slo, parity):
    """(b) The char-RNN registered, OPS_REQUESTS + OPS_PROBES requests
    streamed, ``update_model`` to a second set of weights after
    OPS_SWAP_AT; the history, the default rules and the parity rules
    sampled every OPS_SAMPLE_EVERY submits. Returns (row, registry, the
    requested lengths, the lstm_seq launches)."""
    from deeplearning4j_tpu_torch.serving import ModelRegistry, metering

    nets = [make_charnn(seed), make_charnn(seed + 1)]
    reqs = ops_requests(seed)
    samples = []

    def sample():
        t = time.time()
        s = hist.sample_now(now=t)
        eng_slo.evaluate(s["metrics"], now=t)
        parity.evaluate(s["metrics"], now=t)
        samples.append(t)

    L.reset_launches()
    reg = ModelRegistry()
    engine = reg.register("charnn_ops", nets[0], input_spec=(SEQ, VOCAB), max_batch_size=64,
                          seq_buckets=(32, 64, 128), max_queue=4 * len(reqs), device="cuda")
    fwds = [engine._fwd]
    sample()
    futs = []
    t0 = time.perf_counter()
    for i, (x, kw) in enumerate(reqs):
        futs.append(reg.submit("charnn_ops", x, **kw))
        if i + 1 == OPS_SWAP_AT:
            t_swap = time.perf_counter()
            reg.update_model("charnn_ops", nets[1])
            swap_s = time.perf_counter() - t_swap
            fwds.append(engine._fwd)
        if (i + 1) % OPS_SAMPLE_EVERY == 0:
            sample()
    outs = [f.get(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    sample()
    stats = engine.stats()
    launches = L.launches
    forwards = sum(f.stats()["forwards"] for f in fwds)
    if stats["requests"]["swaps"] != 1 or stats["requests"]["errors"] \
            or stats["requests"]["shed_queue_full"] or stats["requests"]["shed_deadline"] \
            or stats["requests"]["served"] != len(reqs) or len(outs) != len(reqs):
        raise AssertionError(f"hot-swapped stream: {stats['requests']}, {len(outs)} answers "
                             f"of {len(reqs)}")
    if launches != 2 * forwards:
        raise AssertionError(f"lstm_seq launched {launches} times for {forwards} device "
                             "forwards of a 2-layer LSTM (expected 2 a forward)")
    # every answer against both nets' direct output on its row (after the
    # stream: these launches are not the path's)
    by_len = {}
    for i, (x, _) in enumerate(reqs):
        by_len.setdefault(x.shape[0], []).append(i)
    refs = [[None] * len(reqs) for _ in nets]
    for t, idx in by_len.items():
        xb = torch.from_numpy(np.stack([reqs[i][0] for i in idx])).cuda()
        for k, net in enumerate(nets):
            yb = net.output(xb).cpu().numpy()
            for j, i in enumerate(idx):
                refs[k][i] = yb[j]
    served_by, max_err, min_gap = [0, 0], 0.0, float("inf")
    for i, y in enumerate(outs):
        errs = [float(np.abs(y - r[i]).max()) for r in refs]
        min_gap = min(min_gap, float(np.abs(refs[0][i] - refs[1][i]).max()))
        ok = [e <= SERVE_ATOL for e in errs]
        if sum(ok) != 1:
            raise AssertionError(f"request {i}: answer {errs} from the two nets' outputs "
                                 f"(one within {SERVE_ATOL} expected)")
        served_by[ok.index(True)] += 1
        max_err = max(max_err, min(errs))
    if not all(served_by):
        raise AssertionError(f"answers by net {served_by}: the swap served nothing or everything")
    usage = metering.get_meter().usage()["models"]["charnn_ops"]
    tenants = {t: sum(1 for _, kw in reqs if kw.get("tenant") == t) for t in ("acme", "beta")}
    tenants[metering.NO_TENANT] = OPS_PROBES
    got = {t: v["rows"] for t, v in usage["tenants"].items()}
    if got != tenants or usage["rows"] != stats["requests"]["served"]:
        raise AssertionError(f"usage rows by tenant {got} against {tenants} served "
                             f"({usage['rows']} rows metered, {stats['requests']['served']} "
                             "served)")
    health = reg.health()["models"]["charnn_ops"]
    # no warm manifest given: every warm-up missed, ran (a capture) and was
    # written into its engine's own manifest, none served from one
    events = health["compile_cache_events"]
    if not (health["stats"]["requests"]["served"] == len(reqs)
            and isinstance(health["recompiles"], dict) and health["usage"] == usage
            and set(events) <= {"capture", "miss", "serialize"}
            and events.get("capture", 0) >= events.get("miss", 0)
            == events.get("serialize", 0) >= health["stats"]["aot"]["warmed"]):
        raise AssertionError(f"health(): {health}")
    lats = sorted(f.latency_s for f in futs)
    row = {"params": N_PARAMS, "requests": len(reqs), "probes": OPS_PROBES,
           "answers_by_net": served_by, "max_abs_err": max_err, "min_gap_between_nets": min_gap,
           "atol": SERVE_ATOL, "swaps": stats["requests"]["swaps"], "swap_s": swap_s,
           "device_forwards": forwards, "lstm_seq_launches": launches, "wall_s": wall,
           "p50_ms": 1e3 * float(np.percentile(lats, 50)),
           "p99_ms": 1e3 * float(np.percentile(lats, 99)),
           "usage_rows_by_tenant": got, "usage": {k: v for k, v in usage.items()
                                                  if k != "tenants"},
           "health_keys": sorted(health), "recompiles": health["recompiles"],
           "history_samples": len(samples)}
    del refs
    return row, reg, [x.shape[0] for x, _ in reqs], launches


def ops_slo_history_federation(seed, reg, hist, eng_slo, parity, lengths):
    """(c) On (b)'s registry: the default rules silent on (b), a flood that
    fires ``serving_shed_ratio`` (named in a flight dump), ``rate_over``
    against the SLO engine's delta rate, demand-derived edges, and
    federation with a dead member under the SLO engine."""
    import socket

    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.datasets.iterator import ShapeBuckets
    from deeplearning4j_tpu_torch.serving import ServingOverloaded
    from deeplearning4j_tpu_torch.telemetry import federate, flight, slo

    quiet = eng_slo.status()
    if quiet["firing"] or quiet["warning"] or quiet["evaluations"] < 3:
        raise AssertionError(f"default rules on healthy traffic: {quiet['firing']} firing, "
                             f"{quiet['warning']} warning in {quiet['evaluations']} evaluations")
    # rate_over against the engine's delta rate on the same samples
    rates = {}
    for r in parity.status()["rules"]:
        mine = hist.rate_over(r["metric"], r["window_s"], now=hist.samples()[-1]["t"])
        if r["value"] is None or mine is None or abs(mine - r["value"]) > 1e-9 * abs(r["value"]):
            raise AssertionError(f"{r['name']}: rate_over {mine} against the engine's "
                                 f"{r['value']}")
        rates[r["name"]] = {"rate_over": mine, "slo_engine": r["value"]}
    # demand-derived edges over (b)'s requested lengths
    grid = ShapeBuckets.from_demand([1, 2, 4, 8, 16, 32, 64], SEQ, history=hist)
    if grid.max_seq != SEQ or not all(grid.bucket_for(1, t) for t in lengths):
        raise AssertionError(f"from_demand grid {grid} does not cover the lengths requested")
    # the shed storm, in two bursts: a series born in an interval counts
    # from the next one (the delta discipline), so the first burst's sheds
    # open the shed series and the second's are judged
    flood = reg.register_like("charnn_ops", "charnn_flood", make_charnn(seed + OPS_FLOOD_SEED),
                              max_queue=OPS_FLOOD_QUEUE)
    rs = np.random.RandomState(seed + OPS_FLOOD_SEED)
    x = np.eye(VOCAB, dtype=np.float32)[rs.randint(0, VOCAB, SEQ)]
    shed = 0
    for _ in range(2):
        futs = []
        for _ in range(OPS_FLOOD // 2):
            try:
                futs.append(flood.submit(x))
            except ServingOverloaded:
                shed += 1
        for f in futs:
            f.get(timeout=300)
        t = time.time()
        s = hist.sample_now(now=t)
        st = eng_slo.evaluate(s["metrics"], now=t)
    if not shed > 0.2 * OPS_FLOOD or "serving_shed_ratio" not in st["firing"]:
        raise AssertionError(f"a flood shedding {shed} of {OPS_FLOOD} did not fire "
                             f"serving_shed_ratio: {st['firing']}, {st['warning']}")
    ratio = next(r["value"] for r in st["rules"] if r["name"] == "serving_shed_ratio")
    flight.get_recorder().note(step=0, wall_ms=0.0)
    doc = json.loads(pathlib.Path(flight.get_recorder().dump(
        "operations_shed_storm", path=str(WORK / "ops_flight.json"))).read_text())
    if "serving_shed_ratio" not in doc["slo"]["firing"]:
        raise AssertionError(f"the flight dump's slo section: {doc['slo']}")
    # federation: the local registry plus a closed localhost port
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    dead = f"http://127.0.0.1:{sock.getsockname()[1]}/metrics"
    sock.close()
    rule = slo.SloRule("served_rows_burn", "rate", "usage_rows_total", fire=1.0, window_s=60.0)
    fed_eng = slo.SloEngine(rules=[rule])
    states, fed_s = [], []
    for step in range(3):
        if step == 2:  # a real burn on the live member
            reg.submit("charnn_ops", np.stack([x[:OPS_MIN_SEQ]] * OPS_BURN_ROWS),
                       batched=True).get(timeout=300)
        tf = time.perf_counter()
        fed = federate.federate([("local", TT.get_registry().snapshot), ("dead", dead)],
                                timeout_s=OPS_FED_TIMEOUT_S)
        fed_s.append(time.perf_counter() - tf)
        states.append(fed_eng.evaluate(fed, now=time.time())["rules"][0]["state"])
        if fed["scrapes"] != {"ok": 1, "error": 1} or fed["members"]["dead"]["ok"]:
            raise AssertionError(f"federation: {fed['scrapes']}, {fed['members']}")
    counted = TT.series_map("federate_scrape_total").get("instance=dead|outcome=error")
    if states != ["ok", "ok", "firing"] or counted != 3 \
            or max(fed_s) > OPS_FED_TIMEOUT_S + 1.0:
        raise AssertionError(f"SLO over the federation: states {states} (ok, ok, firing "
                             f"expected), dead member counted {counted} times, scrapes "
                             f"{fed_s} s")
    return {"quiet": {"evaluations": quiet["evaluations"], "firing": quiet["firing"],
                      "warning": quiet["warning"]},
            "rate_parity": rates, "demand_edges": grid.seq.sizes(),
            "flood": {"submits": OPS_FLOOD, "shed": shed, "max_queue": OPS_FLOOD_QUEUE,
                      "shed_ratio": ratio, "firing": st["firing"],
                      "dump_slo_firing": doc["slo"]["firing"]},
            "federation": {"states": states, "dead_counted": counted, "seconds": fed_s,
                           "timeout_s": OPS_FED_TIMEOUT_S},
            "flood_forwards": flood._fwd.stats()["forwards"]}


def phase_operations(C, L, seed):
    """The operations tier on the card (see the module docstring): (a)
    goodput on the fused ResNet50, (b) hot swap, metering and health on
    the served char-RNN, (c) the SLO engine, the history, demand-derived
    buckets and federation on (b)'s registry."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.telemetry import history, slo
    from deeplearning4j_tpu_torch.utils import dtypes

    t_phase = time.perf_counter()
    try:
        goodput_row, conv = ops_goodput(C, seed)
    finally:
        dtypes.f32_policy()
    emit("operations.goodput", **goodput_row, card=card_line())
    TT.enable()
    TT.reset()
    hist = history.MetricsHistory()
    eng_slo = slo.get_engine()
    parity = slo.SloEngine(rules=[
        slo.SloRule("rows_all", "rate", "usage_rows_total", fire=1e18, window_s=3600.0),
        slo.SloRule("rows_short", "rate", "usage_rows_total", fire=1e18, window_s=0.5)])
    serve_row, reg, lengths, lstm = ops_serving(L, seed, hist, eng_slo, parity)
    emit("operations.serving", **serve_row, card=card_line())
    try:
        L.reset_launches()
        c_row = ops_slo_history_federation(seed, reg, hist, eng_slo, parity, lengths)
        lstm_c = L.launches
    finally:
        reg.stop()
        TT.disable()
        TT.reset()
    if lstm_c != 2 * (c_row["flood_forwards"] + 1):
        raise AssertionError(f"(c): lstm_seq launched {lstm_c} times for "
                             f"{c_row['flood_forwards']} + 1 forwards")
    emit("operations.slo", **c_row, lstm_seq_launches=lstm_c,
         seconds=time.perf_counter() - t_phase, card=card_line())
    free_card()
    return {"conv_launches": conv, "lstm_seq_launches": lstm + lstm_c}


# ---------------------------------------------------------------------------
# the compile-artifact tier: the tuner, the persistent cache, warm manifests
# ---------------------------------------------------------------------------

def ct_conv_cases():
    """{(kernel id, DB key shape): (kernel, stride, x shape, Cout)} over the
    fused ResNet50's conv calls at the smoke's batch: one call a DB key
    (a 3x3 at stride 2 keys as the stride-1 call of its output size, which
    stands for both)."""
    cases = {}
    for kernel, stride, shape, cout in resnet_conv_calls():
        b, h, w, cin = shape
        ho, wo = -(-h // stride[0]), -(-w // stride[1])
        key = (("conv_matmul", (b * ho * wo, cin, cout)) if kernel == (1, 1)
               else ("conv3x3", (b, ho, wo, cin, cout)))
        if key not in cases or stride == (1, 1):
            cases[key] = (kernel, stride, shape, cout)
    return cases


def ct_tune(T, seed):
    """(a) Tune every kernel at the main paths' shapes into a fresh DB: the
    ResNet50's conv keys in f32 and bf16, the char-RNN's LSTM at B=64 and
    B=1 (and H=1024 at B=64, where persistent meets step_cluster), and the
    LM's attention in f32 and bf16. Each candidate is timed as replays of
    a CUDA graph of its launches (device time, no host launch cost), and
    the default plan stays the winner unless the fastest beats it by more
    than the margin (either one's spread across windows, at least
    ``tune.MIN_GAIN`` of its time). Checks: the default plan is a valid
    candidate at every shape, every winner passed the gate, a winner other
    than the default beats it by more than the margin, no candidate
    raised, and ``tuning_db_total{tune}`` equals the shapes tuned."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch import tuning

    TT.reset()
    TT.enable()
    db = tuning.TuningDB()
    rows = []
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for (kid, shape), _call in sorted(ct_conv_cases().items()):
            if kid == "conv_matmul":
                rows.append(T.tune_conv_matmul(db, n=shape[0], cin=shape[1], cout=shape[2],
                                               dtype=dtype, iters=CT_ITERS, reps=CT_REPS))
            else:
                rows.append(T.tune_conv3x3(db, b=shape[0], hw=shape[1], cin=shape[3],
                                           cout=shape[4], dtype=dtype, iters=CT_ITERS,
                                           reps=CT_REPS))
    for t, b, h, dtype in CT_LSTM:
        rows.append(T.tune_lstm(db, t=t, b=b, hidden=h, dtype=dtype, iters=CT_ITERS,
                                reps=CT_REPS))
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(T.tune_attention(db, b=LM_BATCH, t=LM_SEQ, h=LM_HEADS,
                                     d=LM_WIDTH // LM_HEADS, dtype=dtype, iters=CT_ITERS,
                                     reps=CT_REPS))
    seconds = time.perf_counter() - t0
    for r in rows:
        emit("compile_tune.tune", kernel=r["kernel"], shape=r["shape"], dtype=r["dtype"],
             enumerated=r["enumerated"], pruned=r["pruned_reasons"],
             rejected_parity=r["rejected_parity"], timed=r["timed"],
             default=r["default_config"], default_ms=r["default_ms"], winner=r["winner"],
             winner_ms=r["winner_ms"], fastest=r["fastest"], fastest_ms=r["fastest_ms"],
             margin_ms=r["margin_ms"])
        if not r["default_valid"] or r["default_ms"] is None:
            raise AssertionError(f"tune {r['kernel']} {r['shape']} {r['dtype']}: the default "
                                 f"plan {r['default_config']} is not a timed valid candidate")
        if r["raised"]:
            raise AssertionError(f"tune {r['kernel']} {r['shape']} {r['dtype']}: candidates "
                                 f"raised {r['raised']}: static pruning let them through")
        if r["winner"] is None or r["winner_ms"] > r["default_ms"] or (
                r["winner"] != r["default_config"]
                and not r["default_ms"] - r["winner_ms"] > r["margin_ms"]):
            raise AssertionError(f"tune {r['kernel']} {r['shape']} {r['dtype']}: winner "
                                 f"{r['winner']} ({r['winner_ms']} ms) against the default's "
                                 f"{r['default_ms']} ms, margin {r['margin_ms']} ms")
    tunes = tuning.event_counts().get("tune", 0)
    if tunes != len(rows):
        raise AssertionError(f"tuning_db_total{{tune}} is {tunes} for {len(rows)} shapes tuned")
    TT.disable()
    TT.reset()
    by_kernel = {}
    for r in rows:
        k = by_kernel.setdefault(r["kernel"], {"shapes": 0, "enumerated": 0, "pruned": 0,
                                               "rejected_parity": 0, "timed": 0,
                                               "default_ms": 0.0, "winner_ms": 0.0,
                                               "winner_not_default": 0,
                                               "fastest_not_default": 0})
        k["shapes"] += 1
        k["enumerated"] += r["enumerated"]
        k["pruned"] += sum(r["pruned_reasons"].values())
        k["rejected_parity"] += r["rejected_parity"]
        k["timed"] += r["timed"]
        k["default_ms"] += r["default_ms"]
        k["winner_ms"] += r["winner_ms"]
        k["winner_not_default"] += r["winner"] != r["default_config"]
        k["fastest_not_default"] += r["fastest"] != r["default_config"]
    emit("compile_tune.tuned", shapes=len(rows), tune_events=tunes, entries=len(db),
         seconds=seconds, by_kernel=by_kernel, card=card_line())
    return db, rows


def ct_forward(A, C, L, fwd):
    """One forward (``fwd()``, its output) with the plans it resolved
    recorded: (output, ms of a second call, the recording, launches by
    library and variant in both calls)."""
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.utils import dtypes

    reset_all_launches()
    A.reset_launches()
    with _build.recording() as rec, torch.no_grad(), dtypes.policy_precision():
        y = fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    launched = {"conv_stats": {k: v for k, v in C.launches_by_variant.items() if v},
                "lstm_seq": {k: v for k, v in L.launches_by_variant.items() if v},
                "flash_attn": {k: v for k, v in A.launches_by_variant.items() if v}}
    return y, ms, rec, launched, dict(C.launches)


def ct_tuned_vs_default(A, C, L, db, seed):
    """(b) One forward each of the fused ResNet50 (f32, batch 64, train
    mode: the conv kernels), the LM (T 4096) and the served char-RNN (64 x
    128), without and with the DB bound. Checks: the outputs agree within
    SERVE_ATOL (softmax outputs; the plans change summation orders only);
    the tuned run launched exactly the variants of the plans it resolved;
    ``tuning_db_total{hit}`` equals the distinct plan keys resolved (the
    conv and LSTM plans, and attention's one verdict a shape), with no
    miss, whatever the launches."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch import tuning
    from deeplearning4j_tpu_torch.utils.serialization import params_from_numpy

    def resnet():
        net = make_resnet(seed)
        x, _ = resnet_data(seed, RN_BATCH)
        return net, lambda: net.apply_fn(net.params, net.state, x, train=True)[0]

    def lm():
        net = make_lm(seed)
        x, _ = lm_data(np.random.RandomState(seed), LM_BATCH)
        return net, lambda: net.apply_fn(net.params, net.state, x)[0]

    def charnn():
        net = make_charnn(seed)
        params_from_numpy(net, seeded_params(net, np.random.RandomState(SEED)))
        x = torch.from_numpy(charnn_numpy(seed, CT_CHARNN_ROWS)[0]).cuda()
        return net, lambda: net.apply_fn(net.params, net.state, x)[0]

    rows, launched_total = {}, {"conv_stats": 0, "lstm_seq": 0, "flash_attn": 0}
    conv_by_name = dict.fromkeys(C.launches, 0)
    for name, make, lib in (("resnet50", resnet, "conv_stats"), ("lm", lm, "flash_attn"),
                            ("charnn", charnn, "lstm_seq")):
        net, fwd = make()
        legs = {}
        for leg in ("default", "tuned"):
            tuning.set_db(db if leg == "tuned" else None)
            TT.reset()
            TT.enable()
            y, ms, rec, launched, by_name = ct_forward(A, C, L, fwd)
            events = tuning.event_counts()
            legs[leg] = {"y": y, "ms": ms, "rec": rec, "launched": launched,
                         "events": events, "verdicts": len(A._VERDICTS)}
            for k, v in by_name.items():
                conv_by_name[k] += v
            TT.disable()
        tuning.set_db(None)
        TT.reset()
        d, t = legs["default"], legs["tuned"]
        err = max((a.float() - b.float()).abs().max().item() for a, b in
                  zip(_leaves_of(d["y"]), _leaves_of(t["y"])))
        if not err <= SERVE_ATOL:
            raise AssertionError(f"(b) {name}: the tuned forward differs from the default "
                                 f"one by {err}")
        plans = t["rec"].plans
        keys = sum(1 for kernel, _ in plans if kernel != "flash_attn") + t["verdicts"]
        if t["events"].get("hit", 0) != keys or t["events"].get("miss", 0):
            raise AssertionError(f"(b) {name}: tuning_db_total {t['events']} for {keys} "
                                 "distinct plan keys")
        variants = {}
        for (kernel, _key), (_cfg, fields) in plans.items():
            variants.setdefault(kernel, set()).add(fields["variant"])
        for kernel, counts in t["launched"].items():
            if set(counts) != variants.get(kernel, set()):
                raise AssertionError(f"(b) {name}: {kernel} launched variants {counts}, "
                                     f"the resolved plans' are {variants.get(kernel)}")
        if not sum(d["launched"][lib].values()):
            raise AssertionError(f"(b) {name}: the default forward launched no {lib} kernel")
        for leg in (d, t):
            for kernel, counts in leg["launched"].items():
                launched_total[kernel] += sum(counts.values())
        rows[name] = {"default_ms": d["ms"], "tuned_ms": t["ms"], "max_abs_err": err,
                      "hits": t["events"].get("hit", 0), "distinct_plan_keys": keys,
                      "launches_tuned": t["launched"], "launches_default": d["launched"],
                      "plans_tuned": sorted({json.dumps(cfg, sort_keys=True)
                                             for cfg, _f in plans.values()})}
        emit("compile_tune.forward", model=name, **rows[name], card=card_line())
        del net, fwd, legs, d, t
        free_card()
    return rows, launched_total, conv_by_name


def _leaves_of(y):
    return list(y.values()) if isinstance(y, dict) else [y]


def ct_leg(zip_path, cache_dir, manifest=None):
    """One serve-CLI process on the serve phase's grid with
    ``--compile-cache``: (its stats JSON, the digest of its smoke answers,
    wall s)."""
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path",
           str(zip_path), "--max-batch", str(CT_MAX_BATCH), "--seq-buckets",
           ",".join(map(str, CT_SEQ_BUCKETS)), "--input-shape", f"{SEQ},{VOCAB}",
           "--smoke", str(CT_REQUESTS), "--compile-cache", str(cache_dir)]
    if manifest is not None:
        cmd += ["--warm-manifest", str(manifest)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve leg exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    stats = json.loads(proc.stdout[proc.stdout.index("{"):])
    return stats, stats["smoke_answers_sha256"], wall


def ct_restarts(L, seed, db):
    """(c) Cold, persistent and warm starts of the served full-width
    char-RNN in three serve-CLI processes: cold (an empty cache directory:
    nvcc builds lstm_seq.cu once), persistent (the cold leg's directory: no
    nvcc run), warm (another empty directory and a manifest this process
    saved by ``save_warm_manifest``: no nvcc run, a hit for every grid
    entry, no miss). The three legs' answers must be bitwise equal (the
    serve smoke's sha256 of its answers). Then,
    in this process: a manifest of another grid refused by
    ``update_model(manifest=)`` (grid_mismatch), and one saved under another
    DB's fingerprint missing every entry."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch import tuning
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ServingEngine
    from deeplearning4j_tpu_torch.utils.serialization import (load_model, params_from_numpy,
                                                             save_model)

    net = make_charnn(seed)
    params_from_numpy(net, seeded_params(net, np.random.RandomState(SEED)))
    zip_path = WORK / "ct_charnn.zip"
    save_model(net, zip_path)
    net = load_model(zip_path, device="cuda")
    grid = {"input_spec": (SEQ, VOCAB), "max_batch_size": CT_MAX_BATCH,
            "seq_buckets": CT_SEQ_BUCKETS, "device": "cuda"}
    tuning.set_db(None)
    eng = ServingEngine(net, name="ct", **grid)
    entries = eng.stats()["aot"]["warmed"]
    manifest = eng.save_warm_manifest(WORK / "ct_warm.zip")
    legs = {}
    for leg, cache, man in (("cold", "ct_cache_cold", None), ("persistent", "ct_cache_cold", None),
                            ("warm", "ct_cache_warm", manifest)):
        stats, answers, wall = ct_leg(zip_path, WORK / cache, man)
        cc = stats["compile_cache"]
        legs[leg] = {"answers": answers, "wall_s": wall, "aot": stats["aot"],
                     "kernel_builds": cc["kernel_builds"],
                     "kernel_build_seconds": cc["kernel_build_seconds"],
                     "events": cc["events"],
                     "time_to_first_request_ms": cc["time_to_first_request_ms"],
                     "forwards": stats["forward"]["forwards"]}
    cold, pers, warm = legs["cold"], legs["persistent"], legs["warm"]
    if cold["kernel_builds"] != {"lstm_seq.cu": 1}:
        raise AssertionError(f"(c) cold leg: nvcc runs {cold['kernel_builds']}, expected "
                             "lstm_seq.cu once")
    emit("compile_tune.nvcc", source="lstm_seq.cu",
         seconds=cold["kernel_build_seconds"]["lstm_seq.cu"], card=card_line())
    for leg in ("persistent", "warm"):
        if legs[leg]["kernel_builds"]:
            raise AssertionError(f"(c) {leg} leg ran nvcc: {legs[leg]['kernel_builds']}")
    if not (warm["aot"]["manifest_hits"] == warm["aot"]["warmed"] == entries
            and warm["aot"]["manifest_misses"] == 0
            and warm["events"].get("hit") == entries and not warm["events"].get("miss")):
        raise AssertionError(f"(c) warm leg: aot {warm['aot']}, events {warm['events']} for "
                             f"{entries} grid entries")
    for leg in ("persistent", "warm"):
        if legs[leg]["answers"] != cold["answers"]:
            raise AssertionError(f"(c) the {leg} leg's answers differ from the cold leg's")
    # another grid's manifest, refused by the registry's gate
    TT.reset()
    TT.enable()
    reg = ModelRegistry()
    try:
        reg.register("ct", net, start=False, **grid)
        other = ServingEngine(net, name="ct_other", **{**grid, "seq_buckets": (64, 128)})
        refused = False
        try:
            reg.update_model("ct", net, manifest=other.export_warm_manifest())
        except ValueError:
            refused = True
        counted = TT.get_registry().get("serving_bundle_rejected_total").value(
            model="ct", reason="grid_mismatch")
        if not refused or counted != 1:
            raise AssertionError(f"(c) another grid's manifest: refused {refused}, counted "
                                 f"{counted}")
        # a manifest saved under another DB's fingerprint misses every entry
        tuning.set_db(db)
        tuned_manifest = ServingEngine(net, name="ct_tuned", **grid).export_warm_manifest()
        tuning.set_db(None)
        TT.reset()
        TT.enable()
        stale = ServingEngine(net, name="ct_stale", warm_manifest=tuned_manifest, **grid)
        aot = stale.stats()["aot"]
        if aot["manifest_hits"] or aot["manifest_misses"] != entries:
            raise AssertionError(f"(c) a manifest saved under another DB: aot {aot}")
    finally:
        reg.stop()
        tuning.set_db(None)
        TT.disable()
        TT.reset()
    row = {"grid_entries": entries, "requests": CT_REQUESTS,
           **{f"{leg}_{k}": v[k] for leg, v in legs.items()
              for k in ("time_to_first_request_ms", "wall_s", "kernel_builds", "events")},
           "warm_aot": warm["aot"], "answers_bitwise_equal": True,
           "answers_sha256": cold["answers"],
           "manifest_bytes": os.path.getsize(manifest),
           "other_grid_refused": "grid_mismatch", "other_db_manifest": aot}
    emit("compile_tune.restarts", **row, card=card_line())
    return row, 2 * sum(v["forwards"] for v in legs.values())


def phase_compile_tune(A, C, L, seed):
    """The compile-artifact tier on the card: (a) the tuner at the main
    paths' shapes, (b) the tuned forwards against the default ones, (c)
    cold, persistent and warm serving starts (see the module docstring)."""
    from deeplearning4j_tpu_torch.tuning import tune as T

    t0 = time.perf_counter()
    db, tuned = ct_tune(T, seed)
    free_card()
    forwards, launched, conv = ct_tuned_vs_default(A, C, L, db, seed)
    restarts, leg_lstm = ct_restarts(L, seed, db)
    free_card()
    return {"tuned": tuned, "forwards": forwards, "restarts": restarts,
            "launches": launched, "conv_launches": conv, "leg_lstm_launches": leg_lstm,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# dashboard: the full-width char-RNN trained through the train verb's path
# with the dashboard attached, its routes, a K=4 capture under polling, the
# train/serve/fleet verbs as processes, the conv listener, the sklearn adapter
# ---------------------------------------------------------------------------

def dash_world1_group(work):
    """This process as the one rank of an NCCL group (the train verb's
    one-worker path)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{work / 'rendezvous'}", rank=0,
                            world_size=1)


def dash_fit(zip_path, x, y, listeners=()):
    """The train verb's in-process path on ``zip_path``: the restored net
    through ``DistributedMultiLayer`` over a world-1 ``SharedTrainingMaster``
    (batch DASH_BATCH a worker), with ``listeners``. Returns (net, the
    fit's per-step losses, seconds, host syncs, lstm_seq launches by
    variant, {"first_step_ms", "step_ms"}: the host clock from the fit's
    start to step 1's record, and a step over steps 2 on, read by the last
    listener at each step's record, which follows the fetch of that step's
    loss, so the records come one step period apart)."""
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener, TrainingListener

    class StepEnds(TrainingListener):
        def __init__(self):
            self.times = []

        def iteration_done(self, model, iteration, score, etl_time=0.0):
            self.times.append(time.perf_counter())
    from deeplearning4j_tpu_torch.ops import lstm_seq as L
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayer, MeshSpec,
                                                   SharedTrainingMaster, make_mesh)

    net = restore_checkpoint(str(zip_path), device="cuda")
    scores, ends = CollectScoresListener(), StepEnds()
    net.add_listener(scores, *listeners, ends)
    master = SharedTrainingMaster(make_mesh(MeshSpec(data=1)), batch_size_per_worker=DASH_BATCH,
                                  threshold=None)
    dm = DistributedMultiLayer(net, master)
    torch.cuda.synchronize()
    L.reset_launches()
    with counted_syncs() as syncs:
        t0 = time.perf_counter()
        dm.fit(x, y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if len(ends.times) != DASH_STEPS:
        raise AssertionError(f"{len(ends.times)} step records in a fit of {DASH_STEPS} steps")
    clock = {"first_step_ms": 1e3 * (ends.times[0] - t0),
             "step_ms": 1e3 * (ends.times[-1] - ends.times[0]) / (DASH_STEPS - 1)}
    return (net, [float(v) for v in scores.scores], secs, syncs["n"],
            {"total": L.launches, **{k: v for k, v in L.launches_by_variant.items() if v}},
            clock)


def dash_get(port, path, data=None):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=30) as r:
        body = r.read().decode()
        ctype = r.headers.get("Content-Type", "")
    if ctype == "application/json":
        return json.loads(body)
    if not (ctype.startswith(("text/html", "application/openmetrics-text")) and body):
        raise AssertionError(f"{path}: {ctype!r}, {len(body)} bytes")
    return body


def dash_routes(port, session, leaves):
    """GET every route of the UI server (and POST /remote); each answers
    JSON or HTML, the training routes with the run's session and its
    parameter ``leaves``."""
    import html

    out = {}
    for path in ("/", "/health", "/serving", "/slo", "/traces", "/traces?cluster=1",
                 "/traces?cluster=1&format=chrome", "/fleet", "/usage", "/query", "/metrics",
                 "/train/sessions", f"/train/overview?session={session}",
                 f"/train/model?session={session}", f"/train/model.html?session={session}",
                 f"/train/system?session={session}", f"/train/system.html?session={session}"):
        t0 = time.perf_counter()
        doc = dash_get(port, path)
        out[path] = {"ms": 1e3 * (time.perf_counter() - t0),
                     "kind": "json" if isinstance(doc, (dict, list)) else "text",
                     "bytes": len(json.dumps(doc)) if isinstance(doc, (dict, list)) else len(doc)}
        if path == "/train/sessions" and session not in doc:
            raise AssertionError(f"/train/sessions lacks {session}: {doc}")
        if path.startswith("/train/overview") and len(doc["score"]) != DASH_STEPS:
            raise AssertionError(f"/train/overview holds {len(doc['score'])} scores")
        if path.startswith("/train/model?") and set(doc) != leaves:
            raise AssertionError(f"/train/model holds {sorted(doc)}")
        if path.startswith("/train/system?") and \
                doc["hardware"].get("device_kind") != torch.cuda.get_device_name(0):
            raise AssertionError(f"/train/system hardware: {doc['hardware']}")
        if path.startswith("/train/model.html") and \
                not all(html.escape(k) in doc for k in leaves):
            raise AssertionError("/train/model.html lacks a parameter")
    ack = dash_get(port, "/remote", json.dumps({"type": "stats", "session": "remote",
                                                "iteration": 1, "score": 0.5}).encode())
    if ack != {"ok": True} or "remote" not in dash_get(port, "/train/sessions"):
        raise AssertionError(f"POST /remote: {ack}")
    out["POST /remote"] = {"kind": "json"}
    health = dash_get(port, "/health")
    if set(health) < {"status", "watchdog", "distributed", "memory", "compile_cache",
                      "goodput", "flight"} or not health["memory"]["devices"]:
        raise AssertionError(f"/health: {sorted(health)}")
    return out


def dash_inprocess(seed, work, x, y):
    """(a): the train verb's path in this process at world 1, with and
    without the StatsListener; every UI route; a K=4 fit under polling."""
    import threading

    from deeplearning4j_tpu_torch.nn import fused
    from deeplearning4j_tpu_torch.ops import lstm_seq as L
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener, UIServer
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    zip_path = work / "charnn.zip"
    from deeplearning4j_tpu_torch.utils.serialization import save_model
    save_model(make_charnn(seed), str(zip_path))
    free_card()
    dash_world1_group(work)
    storage = InMemoryStatsStorage()
    server = UIServer(port=0).attach(storage).start()
    try:
        plain, losses0, secs0, syncs0, launched0, clock0 = dash_fit(zip_path, x, y)
        probe = torch.from_numpy(x[:8]).cuda()
        before = L.launches
        reference = plain.output(probe).float().cpu()
        reference_launches = L.launches - before
        del plain
        free_card()
        listener = StatsListener(storage, frequency=1, session_id="dashboard")
        # the listener's one-time init record (the card's and the host's
        # names), timed alone: it falls in the first step
        post_init, post_init_s = listener._post_init, []

        def timed_post_init(model):
            t = time.perf_counter()
            post_init(model)
            post_init_s.append(time.perf_counter() - t)

        listener._post_init = timed_post_init
        net, losses, secs, syncs, launched, clock = dash_fit(zip_path, x, y, (listener,))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    recs = storage.get_records(session="dashboard", type_="stats")
    if [r["iteration"] for r in recs] != list(range(1, DASH_STEPS + 1)):
        raise AssertionError(f"records at iterations {[r['iteration'] for r in recs]}")
    if [r["score"] for r in recs] != losses or losses != losses0:
        raise AssertionError(f"record scores {[r['score'] for r in recs]}, the fit's "
                             f"{losses}, without the listener {losses0}")
    for lch in (launched0, launched):
        if lch != {"total": 2 * DASH_STEPS, "persistent": 2 * DASH_STEPS}:
            raise AssertionError(f"lstm_seq launches {lch} in {DASH_STEPS} steps")
    host = {k: np.linalg.norm(v.detach().double().cpu().numpy().ravel())
            for k, v in flatten_tree(net.params).items()}
    l2_rel = max(abs(recs[-1]["params"][k]["l2"] - v) / v for k, v in host.items())
    if set(recs[-1]["params"]) != set(host) or not l2_rel <= 1e-5:
        raise AssertionError(f"last record's l2 off the host copy's by {l2_rel} relative")
    extra_syncs = syncs - syncs0
    if extra_syncs != DASH_STEPS:
        raise AssertionError(f"the listener added {extra_syncs} host syncs in {DASH_STEPS} "
                             "records (1 a record expected)")
    if recs[-1]["system"].get("device_bytes_in_use", 0) <= 0:
        raise AssertionError(f"system record {recs[-1]['system']}")
    routes = dash_routes(server.port, "dashboard", set(host))
    # K=4: warm the engine (its capture), then a polled fit of replays
    reset_all_launches()
    net.fit(x, y, batch_size=DASH_BATCH, steps_per_dispatch=4)
    warm_launches = fused_launches()["lstm_seq"]
    engine = net._train_steps_fused[(4, False)]
    reset_all_launches()
    stop, polls, errors = threading.Event(), [0], []

    def poll():
        while not stop.is_set():
            try:
                dash_get(server.port, "/health")
                dash_get(server.port, "/train/overview?session=dashboard")
                polls[0] += 1
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(repr(e))
            time.sleep(0.005)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=DASH_BATCH, steps_per_dispatch=4)
        torch.cuda.synchronize()
        k_secs = time.perf_counter() - t0
    finally:
        stop.set()
        th.join(10)
    k_launches, replays = fused_launches()["lstm_seq"], dict(fused.replay_launches)
    if errors or polls[0] < 1:
        raise AssertionError(f"polls {polls[0]}, errors {errors[:3]}")
    if engine.captures != 1 or k_launches != 2 * DASH_STEPS or \
            replays.get("lstm_seq") != 2 * DASH_STEPS:
        raise AssertionError(f"K=4 under polling: captures {engine.captures}, lstm_seq "
                             f"{k_launches} ({replays} from replays) in {DASH_STEPS} steps")
    n_recs = len(storage.get_records(session="dashboard", type_="stats"))
    server.stop()
    row = {"steps": DASH_STEPS, "batch": DASH_BATCH, "params": N_PARAMS,
           "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_listener": clock["step_ms"], "step_ms_plain": clock0["step_ms"],
           "first_step_ms_listener": clock["first_step_ms"],
           "first_step_ms_plain": clock0["first_step_ms"],
           "post_init_ms": [1e3 * t for t in post_init_s],
           "fit_s_listener": secs, "fit_s_plain": secs0,
           "host_syncs_listener": syncs, "host_syncs_plain": syncs0,
           "host_syncs_a_record": extra_syncs / DASH_STEPS,
           "lstm_seq_launches": launched, "reference_lstm_seq_launches": reference_launches,
           "l2_max_rel_err": l2_rel,
           "records": n_recs, "routes": routes, "k4_captures": engine.captures,
           "k4_polls": polls[0], "k4_step_ms": 1e3 * k_secs / DASH_STEPS,
           "k4_lstm_seq_launches": k_launches, "k4_warm_lstm_seq_launches": warm_launches,
           "card": card_line()}
    emit("dashboard.train", **row)
    launches = launched0["total"] + reference_launches + launched["total"] + warm_launches \
        + k_launches
    del net
    free_card()
    return zip_path, reference, probe, losses, row, launches


def dash_train_verb(work, zip_path, reference, probe, losses):
    """(b) the train verb as a process on the charnn zip, its saved zip
    against the in-process run. Returns (the trained zip, the restored
    net, the lstm_seq launches of its check)."""
    from deeplearning4j_tpu_torch.models.zoo import restore_checkpoint

    out_zip = work / "trained.zip"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train", "--model-path",
         str(zip_path), "--data", str(work / "x.npy"), "--labels", str(work / "y.npy"),
         "--workers", "1", "--batch-size-per-worker", str(DASH_BATCH), "--ui-port", "0",
         "--model-output-path", str(out_zip), "--report-score"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    train_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train verb exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    loss = float(next(ln for ln in proc.stdout.splitlines()
                      if ln.startswith("final loss:")).split(":")[1])
    from deeplearning4j_tpu_torch.ops import lstm_seq as L

    trained = restore_checkpoint(str(out_zip), device="cuda")
    before = L.launches
    diff = float((trained.output(probe).float().cpu() - reference).abs().max())
    check_launches = L.launches - before
    if not (diff <= DASH_ATOL and abs(loss - losses[-1]) <= DASH_ATOL * max(1.0, abs(loss))):
        raise AssertionError(f"the train verb's zip differs from the in-process run by {diff}; "
                             f"final loss {loss} against {losses[-1]}")
    emit("dashboard.train_verb", rc=proc.returncode, seconds=train_s, final_loss=loss,
         in_process_loss=losses[-1], forward_max_abs_diff=diff, atol=DASH_ATOL,
         dashboard_line=next(ln for ln in proc.stdout.splitlines() if "dashboard:" in ln),
         card=card_line())
    return out_zip, trained, check_launches


def dash_serve_fleet(work, out_zip, trained, check_launches):
    """(c) serve --port and fleet --workers 2 on the trained zip as
    processes, side by side, their status routes read while they run."""
    import urllib.request

    from deeplearning4j_tpu_torch.serving import ServingEngine

    from deeplearning4j_tpu_torch.ops import lstm_seq as L

    # the workers' warm manifest, from an engine in this process
    before = L.launches
    engine = ServingEngine(trained, input_spec=(SEQ, VOCAB), buckets=list(DASH_BUCKETS),
                           device="cuda")
    manifest = engine.save_warm_manifest(str(work / "wm.zip"))
    engine.stop()
    here = check_launches + L.launches - before
    del trained, engine
    free_card()
    t0 = time.perf_counter()
    procs = {
        "serve": subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve", "--model-path",
             str(out_zip), "--port", "0", "--smoke", str(DASH_REQUESTS), "--max-batch",
             str(max(DASH_BUCKETS)), "--buckets", ",".join(map(str, DASH_BUCKETS))],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "fleet": subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "fleet", "--model-path",
             str(out_zip), "--workers", "2", "--warm-manifest", str(manifest),
             "--compile-cache", str(work / "kernel_cache"), "--port", "0",
             "--smoke", str(DASH_REQUESTS), "--max-batch", str(max(DASH_BUCKETS)),
             "--buckets", ",".join(map(str, DASH_BUCKETS))],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    status, outs = {}, {}
    try:
        for name, marker, path in (("serve", "serving status:", "/serving"),
                                   ("fleet", "fleet status:", "/fleet")):
            p, lines = procs[name], []
            for line in p.stdout:
                lines.append(line)
                if marker in line:
                    url = "http://" + line.split("http://", 1)[1].split()[0]
                    with urllib.request.urlopen(url, timeout=30) as r:
                        status[path] = json.loads(r.read().decode())
                    break
            else:
                raise AssertionError(f"{name}: no status line in\n{''.join(lines)}")
            rest, err = p.communicate(timeout=600)
            outs[name] = "".join(lines) + rest
            if p.returncode != 0:
                raise AssertionError(f"{name} exited {p.returncode}:\n{outs[name]}\n"
                                     f"{err[-4000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
    both_s = time.perf_counter() - t0
    serve = json.loads(outs["serve"][outs["serve"].index("{\n"):])
    if serve["requests"]["served"] != DASH_REQUESTS:
        raise AssertionError(f"serve --smoke answered {serve['requests']}")
    if "default" not in status["/serving"].get("models", {}):
        raise AssertionError(f"/serving: {status['/serving']}")
    fleet = json.loads(outs["fleet"][outs["fleet"].index("{\n"):])
    if fleet["answered"] != DASH_REQUESTS:
        raise AssertionError(f"fleet --smoke answered {fleet['answered']} of {DASH_REQUESTS}")
    if not status["/fleet"].get("active"):
        raise AssertionError(f"/fleet: {status['/fleet']}")
    workers = fleet["health"]["workers"]
    builds = {w: doc.get("kernel_builds") for w, doc in workers.items()}
    worker_launches = {w: doc["kernel_launches"]["lstm_seq"] for w, doc in workers.items()}
    if len(workers) != 2 or any(builds.values()) or \
            "fleet: 2 worker(s) ready" not in outs["fleet"] or ":cold" in outs["fleet"]:
        raise AssertionError(f"fleet workers: builds {builds}\n{outs['fleet'][:2000]}")
    if sum(worker_launches.values()) < 2 or any(v < 1 for v in worker_launches.values()):
        raise AssertionError(f"fleet workers' lstm_seq launches {worker_launches}")
    row = {"seconds_both": both_s, "requests": DASH_REQUESTS, "buckets": list(DASH_BUCKETS),
           "serve_served": serve["requests"]["served"], "serve_latency_ms": serve["latency_ms"],
           "fleet_answered": fleet["answered"], "fleet_router": fleet["router"],
           "fleet_ready_line": next(ln for ln in outs["fleet"].splitlines()
                                    if "worker(s) ready" in ln),
           "worker_kernel_builds": builds, "worker_lstm_seq_launches": worker_launches,
           "serving_route_models": sorted(status["/serving"]["models"]),
           "fleet_route_keys": sorted(status["/fleet"]), "lstm_seq_launches_here": here,
           "card": card_line()}
    emit("dashboard.serve_fleet", **row)
    return row


def dash_conv_listener(seed):
    """(d): LeNet (mnist's net, library convs) trained on the card with a
    ConvolutionalIterationListener: one grid per 4-D activation at each
    frequency step; the last equal to activations_to_grid of the final
    feed_forward on the same example."""
    from deeplearning4j_tpu_torch.ui import ConvolutionalIterationListener, activations_to_grid

    rs = np.random.RandomState(seed + 41)
    n = DASH_LENET_STEPS * MN_BATCH
    x = rs.rand(n, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, n)]
    net = mnist_net(seed)
    lst = ConvolutionalIterationListener(frequency=DASH_LENET_FREQ)
    net.add_listener(lst)
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=MN_BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acts = net.feed_forward(net.last_input[:1])
    layers = [i for i, a in enumerate(acts) if a.ndim == 4]
    its = sorted({it for it, _, _ in lst.history})
    if its != list(range(DASH_LENET_FREQ, DASH_LENET_STEPS + 1, DASH_LENET_FREQ)) or \
            len(lst.history) != len(its) * len(layers):
        raise AssertionError(f"conv listener: {[(it, li) for it, li, _ in lst.history]}")
    last = [(li, g) for it, li, g in lst.history if it == its[-1]]
    for li, g in last:
        want = activations_to_grid(acts[li].float().cpu().numpy())
        if not np.array_equal(g, want):
            raise AssertionError(f"layer {li}'s grid differs from activations_to_grid of the "
                                 f"final forward in {int((g != want).sum())} pixels")
    row = {"steps": DASH_LENET_STEPS, "frequency": DASH_LENET_FREQ, "layers_4d": layers,
           "grids": len(lst.history), "grid_shapes": {li: list(g.shape) for li, g in last},
           "fit_s": secs, "card": card_line()}
    emit("dashboard.conv_listener", **row)
    del net
    free_card()
    return row


def dash_classifier(seed):
    """(e): NeuralNetClassifier on the card over DASH_CLF_ROWS x 784 rows
    of 10 classes; predict is the argmax of the wrapped net's output."""
    import importlib.util

    from deeplearning4j_tpu_torch.mlpipeline import NeuralNetClassifier
    from deeplearning4j_tpu_torch.nn import layers as NL
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf.inputs import FeedForwardType
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig

    rs = np.random.RandomState(seed + 43)
    centers = rs.randn(10, 784).astype(np.float32)
    labels = rs.randint(0, 10, DASH_CLF_ROWS)
    X = centers[labels] + rs.randn(DASH_CLF_ROWS, 784).astype(np.float32)
    y = np.array([f"digit{i}" for i in range(10)])[labels]
    conf = NeuralNetConfig(seed=seed, updater=U.Adam(learning_rate=1e-3)).list(
        NL.DenseLayer(n_out=1000, activation="relu"),
        NL.OutputLayer(n_out=10, loss="mcxent"),
        input_type=FeedForwardType(784))
    clf = NeuralNetClassifier(conf=conf, epochs=2, batch_size=128, seed=seed, device="cuda")
    t0 = time.perf_counter()
    clf.fit(X, y)
    pred = clf.predict(X)
    secs = time.perf_counter() - t0
    want = clf.classes_[clf.net_.output(X).float().cpu().numpy().argmax(-1)]
    if not np.array_equal(pred, want):
        raise AssertionError("predict differs from the argmax of the wrapped net's output")
    if clf.net_.device.type != "cuda":
        raise AssertionError(f"the classifier's net is on {clf.net_.device}")
    acc = float((pred == y).mean())
    row = {"rows": DASH_CLF_ROWS, "features": 784, "classes": 10, "epochs": 2,
           "train_accuracy": acc, "fit_predict_s": secs,
           "sklearn": importlib.util.find_spec("sklearn") is not None, "card": card_line()}
    if not acc > 0.9:
        raise AssertionError(f"classifier accuracy {acc}")
    emit("dashboard.classifier", **row)
    del clf
    free_card()
    return row


def phase_dashboard(seed):
    """The dashboard phase's parts (a), (b), (d) and (e) (see the module
    docstring); ``phase_dashboard_processes`` runs (c) on what it returns."""
    t0 = time.perf_counter()
    work = WORK / "dashboard"
    work.mkdir(parents=True)
    x, y = charnn_numpy(seed + 61, DASH_ROWS)
    np.save(work / "x.npy", x)
    np.save(work / "y.npy", y)
    zip_path, reference, probe, losses, train, launches = dash_inprocess(seed, work, x, y)
    # the train verb's process runs while (d) and (e) run here
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        verb = pool.submit(dash_train_verb, work, zip_path, reference, probe, losses)
        conv = dash_conv_listener(seed)
        clf = dash_classifier(seed)
        out_zip, trained, check_launches = verb.result()
    return {"t0": t0, "work": work, "out_zip": out_zip, "trained": trained,
            "check_launches": check_launches, "train": train, "conv": conv, "classifier": clf,
            "lstm_seq_launches": launches}


def phase_dashboard_processes(part):
    """The dashboard phase's (c), the serve and fleet processes, on what
    ``phase_dashboard`` returned; then the phase's line."""
    procs = dash_serve_fleet(part.pop("work"), part.pop("out_zip"), part.pop("trained"),
                             part.pop("check_launches"))
    launches = part["lstm_seq_launches"] + procs["lstm_seq_launches_here"]
    emit("dashboard", seconds=time.perf_counter() - part.pop("t0"), lstm_seq_launches=launches,
         worker_lstm_seq_launches=procs["worker_lstm_seq_launches"], card=card_line())
    return {**part, "processes": procs, "lstm_seq_launches": launches,
            "worker_lstm_seq_launches": procs["worker_lstm_seq_launches"]}


# ---------------------------------------------------------------------------
# hostfleet: the elastic training fleet, 2 host processes sharing the card
# ---------------------------------------------------------------------------

def hf_job(workdir, *, world=2, kill=False, respawn=False, exchange="hostavg",
           serve_registry=False, seed_bundle=None, rolled_back=None):
    """One TrainingFleetSupervisor job at HF_* widths on the card, to its
    end: (result, {ready_s, respawn_s}). With ``kill``, host 1 is SIGKILLed
    mid-round 1, and ``rolled_back`` (an Event) is set once the next
    generation is ready, its rollback bundle written."""
    from deeplearning4j_tpu_torch.hostfleet import TrainingFleetSupervisor

    workdir.mkdir(parents=True, exist_ok=True)
    if seed_bundle is not None:
        shutil.copyfile(seed_bundle, workdir / "bundle.zip")
    sup = TrainingFleetSupervisor(
        world, workdir=str(workdir), total_rounds=HF_ROUNDS, features=HF_FEATURES,
        hidden=HF_HIDDEN, classes=HF_CLASSES, batch=HF_BATCH, seed=HF_SEED,
        gen_seed=HF_GEN_SEED, shard_params="zero1", exchange=exchange, respawn=respawn,
        round_timeout_s=HF_ROUND_TIMEOUT_S, spawn_timeout_s=300,
        round_sleep_s=HF_ROUND_SLEEP_S if kill else 0.0, serve_registry=serve_registry,
        device="cuda")

    def ready_after(t_start, gen):
        while True:
            st = sup.status()
            if st["done"]:
                return None
            if st["generation"] == gen and st["hosts"] and all(h["ready"] for h in st["hosts"]):
                return time.perf_counter() - t_start
            time.sleep(0.02)

    times = {}
    t0 = time.perf_counter()
    sup.start()
    try:
        times["ready_s"] = ready_after(t0, 0)
        if kill:
            sup.wait_for_round(0, timeout=300, host=0)
            t_kill = time.perf_counter()
            sup.kill_host(world - 1)
            times["respawn_s"] = ready_after(t_kill, 1)
            if rolled_back is not None:
                rolled_back.set()
        res = sup.wait(timeout=600)
    finally:
        sup.stop()
    times["job_s"] = time.perf_counter() - t0
    return res, times


def hf_summary(res, times):
    good = res["worker_goodput"]
    rounds = HF_ROUNDS
    return {"final_world": res["final_world"], "mode": res["mode"], "layout": res["layout"],
            "digests": res["digests"], "iterations": res["iterations"], "tally": res["tally"],
            "step_recompiles": res["step_recompiles"], **times,
            "round_ms": {p: 1e3 * g["window_s"] / rounds for p, g in good.items()},
            "exchange_ms": {p: 1e3 * g["seconds"]["exchange"] / rounds for p, g in good.items()},
            "bundle_s": {p: g["seconds"]["checkpoint"] / rounds for p, g in good.items()
                         if g["seconds"]["checkpoint"]},
            "generations": [{k: g[k] for k in ("generation", "world", "reason", "detail",
                                               "rollback_rounds", "resumed_from_round")}
                            for g in res["generations"]]}


def phase_hostfleet(seed):
    """The hostfleet phase (see the module docstring): (a)-(d) side by
    side, and (b)'s world-1 reference from its rollback bundle as soon as
    that bundle is written."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch import telemetry

    t0 = time.perf_counter()
    telemetry.enable()
    work = WORK / "hostfleet"
    rolled_back = threading.Event()

    def reference():
        if not rolled_back.wait(600):
            raise AssertionError("hostfleet (b): no rollback generation within 600 s")
        return hf_job(work / "reference", world=1,
                      seed_bundle=work / "kill" / "rollback_gen0.zip")

    with ThreadPoolExecutor(5) as pool:
        jobs = [pool.submit(hf_job, work / "clean", serve_registry=True),
                pool.submit(hf_job, work / "gspmd", exchange="gspmd"),
                pool.submit(hf_job, work / "kill", kill=True, rolled_back=rolled_back),
                pool.submit(hf_job, work / "respawn", kill=True, respawn=True),
                pool.submit(reference)]
        (clean, t_clean), (gspmd, t_gspmd), (killed, t_killed), (resp, t_resp), \
            (ref, t_ref) = (j.result() for j in jobs)
    gen0 = killed["generations"][0]
    if pathlib.Path(gen0["rollback_bundle"]) != work / "kill" / "rollback_gen0.zip":
        raise AssertionError(f"hostfleet (b): the rollback bundle is {gen0['rollback_bundle']}")
    checks = {
        "clean_hosts_agree": len(set(clean["digests"])) == 1 and clean["final_world"] == 2,
        "clean_probe_within_1e-6": clean["serving_probe_diff"] is not None
        and clean["serving_probe_diff"] <= 1e-6,
        "kill_world_1": killed["final_world"] == 1 and killed["tally"]["host_death"] == 1
        and killed["tally"]["rollback_rounds"] >= 1 and killed["iterations"] == [HF_ROUNDS],
        "kill_digest_equals_reference": killed["digests"][0] == ref["digests"][0],
        "respawn_world_2_equals_clean": resp["final_world"] == 2
        and resp["tally"]["respawn"] == 1 and set(resp["digests"]) == {clean["digests"][0]},
        "gspmd_hosts_agree": gspmd["mode"] == "gspmd" and len(set(gspmd["digests"])) == 1
        and gspmd["final_world"] == 2,
        "no_step_recompiles": all(r == 0 for res in (clean, gspmd, killed, resp, ref)
                                  for r in res["step_recompiles"]),
    }
    reg = telemetry.get_registry()
    gens = {ls.get("reason"): reg.get("hostfleet_generations_total").value(**ls)
            for ls in reg.get("hostfleet_generations_total").labelsets()}
    telemetry.disable()
    row = {"hosts": 2, "rounds": HF_ROUNDS, "features": HF_FEATURES, "hidden": HF_HIDDEN,
           "classes": HF_CLASSES, "batch": HF_BATCH, "device": "cuda:0 shared",
           "side_by_side": "(a)-(d) and (b)'s reference: up to 9 processes at once",
           "clean": hf_summary(clean, t_clean), "gspmd": hf_summary(gspmd, t_gspmd),
           "kill": hf_summary(killed, t_killed), "respawn": hf_summary(resp, t_resp),
           "reference": hf_summary(ref, t_ref),
           "serving_probe_diff": clean["serving_probe_diff"],
           "generations_total": gens, "checks": checks,
           "seconds": time.perf_counter() - t0, "card": card_line()}
    emit("hostfleet", **row)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"hostfleet: {failed}")
    shutil.rmtree(work, ignore_errors=True)
    return row


# ---------------------------------------------------------------------------
# continuous learning and the serving fleet: the char-RNN trained from a
# stream, served by a registry and by worker processes
# ---------------------------------------------------------------------------

def cont_stream_plan():
    """The indices of the stream's batches the chaos run trains on: every
    batch but the stale one, in order, less the K-step dispatch that holds
    the poisoned batch (rolled back whole)."""
    admitted = [i for i in range(CONT_BATCHES) if i != CONT_STALE]
    at = admitted.index(CONT_POISON)
    lost = admitted[at - at % CONT_K: at - at % CONT_K + CONT_K]
    return [i for i in admitted if i not in lost], lost


def cont_publisher(port, start=0, stall=None):
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.continuous.chaos", "--port", str(port),
           "--n", str(CONT_BATCHES), "--batch", str(CHARNN_BATCH), "--seq-len", str(SEQ),
           "--classes", str(VOCAB), "--gen-seed", str(CONT_GEN_SEED),
           "--poison", str(CONT_POISON), "--delay-index", str(CONT_STALE),
           "--delay-s", str(CONT_DELAY_S), "--interval-s", str(CONT_INTERVAL_S),
           "--start", str(start), "--device", "cuda"]
    if stall is not None:
        cmd += ["--stall-after", str(stall)]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def cont_step_check(seed, batches, first_snapshot):
    """The streaming run's first K-step dispatch (its snapshot after round
    1) against ``MultiLayerNetwork.fit`` of the same CONT_K batches one step
    a dispatch, under the charnn phase's f32 step tolerance (parameters
    atol CHARNN_PARAM_ATOL)."""
    from deeplearning4j_tpu_torch.utils.serialization import load_bundle
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    snap = load_bundle(first_snapshot, device="cuda").net
    ref = make_charnn(seed)
    ref.fit(iter(batches[:CONT_K]))
    if not snap.iteration == ref.iteration == CONT_K:
        raise AssertionError(f"step check: iterations {snap.iteration}, {ref.iteration}")
    param = max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(snap.params), tree_leaves(ref.params)))
    if not param <= CHARNN_PARAM_ATOL:
        raise AssertionError(f"step check: the K={CONT_K} dispatch against fit differs by "
                             f"{param} in the parameters")
    del snap, ref
    free_card()
    return {"steps": CONT_K, "max_abs_param_diff": param, "param_atol": CHARNN_PARAM_ATOL}


def cont_train(L, seed, batches, probe):
    """(a) and (b): the streaming run with its faults, the registry fed
    from every published snapshot while a client thread keeps asking it.
    Returns (row, the trainer's net, the first round's snapshot, the final
    snapshot, the registry)."""
    import threading

    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.continuous.trainer import (ContinuousTrainer,
                                                             StreamingTrainSource,
                                                             registry_updater)
    from deeplearning4j_tpu_torch.nn import fused
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.streaming.pubsub import NDArraySubscriber, StreamingBroker

    trained, lost = cont_stream_plan()
    net = make_charnn(seed)
    registry = ModelRegistry()
    registry.register("charnn", make_charnn(seed), buckets=[1, CONT_MAX_ROWS],
                      input_spec=(SEQ, VOCAB), device="cuda")
    # the client: one probe row at a time, every CONT_CLIENT_EVERY_S, from
    # the host as a user's request comes
    stop_client = threading.Event()
    futs = []
    row0 = probe[0].cpu().numpy()

    def client():
        while not stop_client.wait(CONT_CLIENT_EVERY_S):
            futs.append(registry.submit("charnn", row0))

    snaps, swap_checks, snap_s = [], [], []
    to_registry = registry_updater(registry, "charnn")
    first_snapshot = WORK / "cont_snap_round1.zip"

    def serve_update(path):
        to_registry(path)
        direct = net.output(probe).float()
        served = torch.as_tensor(registry.output("charnn", probe)).float().cuda()
        swap_checks.append((served - direct).abs().max().item())
        snaps.append(direct[0].cpu())
        if len(snaps) == 2:  # the snapshot after the first round
            shutil.copy(path, first_snapshot)

    TT.reset()  # the watchdog too: the trainer arms it with the raise policy
    TT.enable()
    broker = StreamingBroker(subscriber_buffer=CONT_BATCHES + 4).start()
    sub = NDArraySubscriber("train", port=broker.port, buffer=CONT_BATCHES + 4)
    source = StreamingTrainSource(sub, max_staleness_s=CONT_STALENESS_S,
                                  quiet_timeout_s=CONT_QUIET_S)
    trainer = ContinuousTrainer(net, source, snapshot_path=str(WORK / "cont_snap.zip"),
                                k=CONT_K, batch_size=CHARNN_BATCH, serve_update=serve_update,
                                ingest_retries=CONT_RETRIES, ingest_backoff_s=0.25)
    checkpoint = trainer.driver.checkpoint

    def timed_checkpoint(*a, **kw):
        t0 = time.perf_counter()
        try:
            return checkpoint(*a, **kw)
        finally:
            snap_s.append(time.perf_counter() - t0)
    trainer.driver.checkpoint = timed_checkpoint

    # the producer: stalls after CONT_STALL batches, is SIGKILLed once the
    # trainer has taken them and the stream has been quiet, and a
    # replacement resumes at CONT_STALL
    events, procs = {}, []

    def producer():
        first = cont_publisher(broker.port, stall=CONT_STALL)
        procs.append(first)
        line = first.stdout.readline()
        if json.loads(line) != {"stalled": CONT_STALL}:
            raise AssertionError(f"the first publisher said {line!r}")
        deadline = time.monotonic() + 600
        while source.admitted + source.stale_dropped < CONT_STALL:
            if time.monotonic() > deadline:
                raise AssertionError("the trainer never took the first publisher's batches")
            time.sleep(0.05)
        first.kill()  # SIGKILL: no close frames
        first.wait(timeout=30)
        events["killed_rc"] = first.returncode
        time.sleep(2.5 * CONT_QUIET_S)  # the stream goes quiet: counted retries
        procs.append(cont_publisher(broker.port, start=CONT_STALL))

    L.reset_launches()
    fused.reset_replay_launches()
    t_client = threading.Thread(target=client, daemon=True)
    t_prod = threading.Thread(target=producer, daemon=True)
    t_client.start()
    t_prod.start()
    try:
        # the stream is live before the trainer asks for it: the only quiet
        # spell is the producer's death
        deadline = time.monotonic() + 300
        while sub.queue.empty():
            if time.monotonic() > deadline or not t_prod.is_alive():
                raise AssertionError("the first publisher never published")
            time.sleep(0.02)
        t0 = time.perf_counter()
        summary = trainer.run(until_steps=len(trained))
        wall = time.perf_counter() - t0
    finally:
        stop_client.set()
        t_client.join(timeout=30)
        t_prod.join(timeout=60)
        sub.close()
        broker_dropped = broker.dropped_total()
        broker.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)
    launches = L.launches
    replays = dict(fused.replay_launches)
    answers = []
    for f in futs:  # every client request answered, none dropped
        answers.append(torch.as_tensor(f.get(timeout=60)).float().cpu())
    counters = {n: TT.series_map(n) for n in (
        "continuous_rounds_total", "continuous_rollback_total",
        "continuous_rolled_back_steps_total", "continuous_dropped_total",
        "continuous_snapshots_total", "continuous_serve_updates_total", "etl_retry_total",
        "stream_dropped_total")}
    retries = counters["etl_retry_total"]
    if summary["status"] != "target_steps" or net.iteration != len(trained):
        raise AssertionError(f"(a) the run ended {summary['status']} at iteration "
                             f"{net.iteration}, expected {len(trained)}")
    if not (summary["rollbacks"] == 1 and counters["continuous_rollback_total"]
            == {"reason=numerics": 1.0}
            and counters["continuous_rolled_back_steps_total"] == {"": float(CONT_K)}):
        raise AssertionError(f"(a) rollback: {summary['rollbacks']}, {counters}")
    if summary["stale_dropped"] != 1 or counters["continuous_dropped_total"] != {
            "reason=stale": 1.0} or summary["admitted"] != CONT_BATCHES - 1:
        raise AssertionError(f"(a) staleness: {summary}, {counters['continuous_dropped_total']}")
    if not (retries.get("outcome=retried", 0) >= 1 and retries.get("outcome=recovered") == 1
            and not retries.get("outcome=fatal")) or events.get("killed_rc") != -9:
        raise AssertionError(f"(a) producer death: retries {retries}, events {events}")
    if broker_dropped or sub.dropped or counters["stream_dropped_total"]:
        raise AssertionError(f"(a) the stream dropped batches: broker {broker_dropped}, "
                             f"subscriber {sub.dropped}")
    steps = len(trained) + CONT_K  # the rolled-back dispatch ran too
    if launches < 2 * steps or replays.get("lstm_seq", 0) != 2 * steps:
        raise AssertionError(f"(a) lstm_seq launched {launches} times ({replays} from replays) "
                             f"for {steps} steps: 2 a step from the K-step replays expected")
    if max(swap_checks) > SERVE_ATOL or len(swap_checks) != summary["snapshots_published"]:
        raise AssertionError(f"(b) served answers after a swap differ from the snapshot's "
                             f"forward by {max(swap_checks)} ({len(swap_checks)} checks)")
    # no request mixed: each answer is one snapshot's forward (the registry
    # starts on the round-0 snapshot's weights)
    ref_rows = torch.stack(snaps)
    nearest = [(ref_rows - a[0]).abs().amax(-1).min().item() for a in answers]
    # consecutive snapshots' answers apart (the final snapshot repeats the
    # last round's): how far a mixed answer would land from both
    gaps = [g for g in ((ref_rows[i] - ref_rows[i + 1]).abs().max().item()
                        for i in range(len(ref_rows) - 1)) if g > 0]
    if not answers or max(nearest) > SERVE_ATOL:
        raise AssertionError(f"(b) {len(answers)} client answers, the farthest "
                             f"{max(nearest, default=None)} from every snapshot's forward")
    final = WORK / "cont_snap_final.zip"
    shutil.copy(trainer.snapshot_path, final)
    row = {"batches": CONT_BATCHES, "k": CONT_K, "batch": CHARNN_BATCH, "seq": SEQ,
           "vocab": VOCAB, "rounds": summary["rounds"], "iteration": net.iteration,
           "steps_run": steps, "wall_s": wall, "steps_per_s": steps / wall,
           "snapshots": summary["snapshots_published"], "snapshot_s_mean": statistics.mean(snap_s),
           "snapshot_s_max": max(snap_s), "status": summary["status"],
           "rollbacks": summary["rollbacks"], "rolled_back_steps": CONT_K,
           "rolled_back_batches": lost, "stale_dropped": summary["stale_dropped"],
           "producer_retries": retries, "producer_killed_rc": events["killed_rc"],
           "captures": summary["captures"], "lstm_seq_launches": launches,
           "lstm_seq_launches_from_replays": replays.get("lstm_seq", 0),
           "registry_swaps": len(swap_checks), "swap_max_abs_err": max(swap_checks),
           "client_requests": len(futs), "client_answered": len(answers),
           "client_max_abs_err": max(nearest), "snapshot_min_gap": min(gaps),
           "serve_atol": SERVE_ATOL, "counters": counters}
    return row, net, first_snapshot, final, registry


def cont_clean(seed, batches, trained, want):
    """The chaos run's digest against a clean offline run on the card over
    the batches it kept."""
    from deeplearning4j_tpu_torch.continuous import chaos
    from deeplearning4j_tpu_torch.continuous.trainer import ContinuousTrainer

    clean = make_charnn(seed)
    t0 = time.perf_counter()
    ContinuousTrainer(clean, [batches[i] for i in trained],
                      snapshot_path=str(WORK / "cont_clean.zip"), k=CONT_K,
                      batch_size=CHARNN_BATCH, snapshot_every=10 ** 6).run()
    wall = time.perf_counter() - t0
    got = chaos.state_digest(clean)
    if got != want or clean.iteration != len(trained):
        raise AssertionError(f"(a) the rolled-back run's digest {want} differs from the clean "
                             f"run's {got} (iteration {clean.iteration})")
    del clean
    free_card()
    return {"digest": want, "clean_digest": got, "bit_equal": True, "clean_wall_s": wall}


def cont_fleet(seed, first_snapshot, final_net, final_snapshot, registry, pool):
    """(c): the fleet of CONT_WORKERS worker processes on the card."""
    from deeplearning4j_tpu_torch.continuous.trainer import fleet_updater
    from deeplearning4j_tpu_torch.fleet import FleetRouter, FleetSupervisor
    from deeplearning4j_tpu_torch.fleet.router import _http_json
    from deeplearning4j_tpu_torch.utils.serialization import load_bundle

    manifest = registry.engine("charnn").save_warm_manifest(WORK / "cont_wm.zip")
    registry.stop()
    rs = np.random.RandomState(seed + 31)
    sizes = rs.randint(1, CONT_MAX_ROWS + 1, size=CONT_REQUESTS)
    starts = rs.randint(0, len(pool) - CONT_MAX_ROWS, size=CONT_REQUESTS)
    snap_a = load_bundle(first_snapshot, device="cuda").net
    want = [snap_a.output(pool[s:s + n]).float().cpu() for s, n in zip(starts, sizes)]
    del snap_a
    sup = FleetSupervisor(CONT_WORKERS, model_path=str(first_snapshot), name="charnn",
                          buckets=[1, CONT_MAX_ROWS], warm_manifest=str(manifest),
                          compile_cache=str(WORK / "cont_kernel_cache"), device="cuda",
                          probe_interval_s=0.5, max_missed_probes=2, spawn_timeout_s=300)
    router = FleetRouter(name="charnn", max_queue=4096, max_dispatch_rows=CONT_MAX_ROWS,
                         max_inflight_rows=2 * CONT_MAX_ROWS, request_timeout_s=120.0)
    sup.attach(router)
    t0 = time.perf_counter()
    try:
        sup.start()
        start_s = time.perf_counter() - t0
        for wid, w in sup._workers.items():
            if not FleetSupervisor.replacement_is_warm(w.ready_doc) or \
                    not str(w.ready_doc.get("device", "")).startswith("cuda"):
                raise AssertionError(f"(c) worker {wid} did not start warm on the card: "
                                     f"{w.ready_doc}")
        # a closed loop of CONT_OUTSTANDING clients: the load the fleet
        # sustains, not a queue growing behind it
        rows = [pool[s:s + n].cpu().numpy() for s, n in zip(starts, sizes)]
        futs, errs = [], []
        t_sweep = time.perf_counter()
        for i, x in enumerate(rows):
            if i == CONT_KILL_AT:
                killed = sup.kill_worker("w0")
            if len(futs) - len(errs) >= CONT_OUTSTANDING:
                j = len(errs)
                errs.append((torch.as_tensor(futs[j].get(timeout=120)).float()
                             - want[j]).abs().max().item())
            futs.append(router.submit(x, batched=True))
        errs += [(torch.as_tensor(f.get(timeout=120)).float() - w).abs().max().item()
                 for f, w in zip(futs[len(errs):], want[len(errs):])]
        sweep_s = time.perf_counter() - t_sweep
        counts = router.stats()["requests"]
        lost = (counts["submitted"] - counts["served"] - counts["shed_queue_full"]
                - counts["shed_deadline"] - counts["shed_no_worker"] - counts["shed_worker"]
                - counts["errors"])
        if lost or counts["served"] != CONT_REQUESTS or max(errs) > SERVE_ATOL \
                or counts["failovers"] < 1:
            raise AssertionError(f"(c) the sweep across the kill: {counts}, max |err| "
                                 f"{max(errs)}")
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            evs = sup.status()["respawns"]
            if evs and evs[-1].get("spawn_s") is not None:
                break
            time.sleep(0.2)
        ev = sup.status()["respawns"][-1]
        if not (ev["worker_id"] == "w0" and ev["warm"] is True and ev["kernel_builds"] == {}):
            raise AssertionError(f"(c) the replacement did not start warm: {ev}")
        t1 = time.perf_counter()
        swaps = fleet_updater(sup)(str(final_snapshot))
        swap_s = time.perf_counter() - t1
        x = pool[:CONT_MAX_ROWS]
        direct = final_net.output(x).float().cpu()
        per_worker = {}
        for wid, addr in sup.addresses():
            code, doc = _http_json(addr + "/submit", {"rows": x.cpu().numpy().tolist()},
                                   timeout=120)
            err = (torch.tensor(doc["outputs"]) - direct).abs().max().item()
            _c, health = _http_json(addr + "/health", timeout=30)
            per_worker[wid] = {"code": code, "max_abs_err": err,
                               "lstm_seq_launches": health["kernel_launches"]["lstm_seq"],
                               "kernel_builds": health["kernel_builds"],
                               "swaps": health["swaps"], "pid": health["pid"]}
            if code != 200 or err > SERVE_ATOL or health["kernel_launches"]["lstm_seq"] <= 0 \
                    or health["kernel_builds"]:
                raise AssertionError(f"(c) worker {wid} after the swap: {per_worker[wid]}")
        st = router.stats()
    finally:
        router.stop()
        sup.stop()
    row = {"workers": CONT_WORKERS, "requests": CONT_REQUESTS, "rows": int(sizes.sum()),
           "max_rows": CONT_MAX_ROWS, "outstanding": CONT_OUTSTANDING, "start_s": start_s,
           "sweep_s": sweep_s, "rows_per_s": int(sizes.sum()) / sweep_s, "killed_pid": killed,
           "served": counts["served"], "failovers": counts["failovers"],
           "retries": counts["retries"], "lost": lost, "max_abs_err": max(errs),
           "latency_ms": st["latency_ms"], "respawn_s": ev["spawn_s"],
           "respawn_warm": ev["warm"], "respawn_kernel_builds": ev["kernel_builds"],
           "respawn_aot": ev["aot"], "swap_s": swap_s,
           "swap": {w: {k: d.get(k) for k in ("ok", "swaps")} for w, d in swaps.items()},
           "after_swap": per_worker, "serve_atol": SERVE_ATOL}
    return row


def cont_trainer_restart(L, seed, batches):
    """(d): a world-1 ParallelTrainer over the char-RNN, saved with its
    net's warm manifest and restored into a fresh trainer, whose first
    K-step dispatch runs no nvcc build and no plan lookup."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.nn import fused
    from deeplearning4j_tpu_torch.ops import _build, _plans
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer, make_mesh
    from deeplearning4j_tpu_torch.utils import compile_cache as cc
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as SC
    from deeplearning4j_tpu_torch.utils.trees import flatten_tree

    def xy(part):
        return (np.concatenate([batches[i][0] for i in part]),
                np.concatenate([batches[i][1] for i in part]))

    work = WORK / "cont_nccl"
    work.mkdir(parents=True)
    dist.init_process_group("nccl", init_method=f"file://{work / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        net = make_charnn(seed)
        tr = ParallelTrainer(net, mesh).adopt_net_state()
        cc.attach_manifest(net, cc.WarmManifest.for_net(net))
        x, y = xy(range(CONT_K))
        tr.fit(x, y, batch_size=CHARNN_BATCH, steps_per_dispatch=CONT_K)
        path = SC.save_trainer(WORK / "cont_trainer", tr, manifest=net._warm_manifest)
        saved = {k: v.clone() for k, v in flatten_tree(tr.sync_to_net().params).items()}
        del tr, net
        free_card()
        TT.reset()
        TT.enable()
        _plans.clear_all()
        _build.reset_counts()
        resolves = []
        originals = [(cache, cache._resolve) for cache in _plans._caches
                     if isinstance(cache, _plans.PlanCache)]

        def counted(resolve):
            def wrapper(db, key, *extra):
                resolves.append(key)  # a plan resolved, not seeded: a lookup
                return resolve(db, key, *extra)
            return wrapper
        for cache, resolve in originals:
            cache._resolve = counted(resolve)
        try:
            back = SC.restore_trainer(path, ParallelTrainer(make_charnn(seed + 1),
                                                            mesh).adopt_net_state())
            mine = flatten_tree(back.sync_to_net().params)
            if back.net._warm_manifest is None or \
                    not all(torch.equal(mine[k], saved[k]) for k in saved):
                raise AssertionError("(d) the restored trainer's parameters (or manifest) are "
                                     "not the saved ones")
            L.reset_launches()
            x, y = xy(range(CONT_K, 2 * CONT_K))
            t0 = time.perf_counter()
            back.fit(x, y, batch_size=CHARNN_BATCH, steps_per_dispatch=CONT_K)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = L.launches
        finally:
            for cache, resolve in originals:
                cache._resolve = resolve
        events = cc.event_counts()
        if _build.builds or resolves or events.get("miss") or events.get("hit") != 1 \
                or events.get("capture") != 1 \
                or launches != 2 * CONT_K * (fused.WARMUP_RUNS + 1):
            raise AssertionError(f"(d) the restored trainer's first dispatch: nvcc "
                                 f"{_build.builds}, plan lookups {resolves}, events {events}, "
                                 f"lstm_seq {launches}")
        row = {"k": CONT_K, "params_bitwise_equal": True, "nvcc_builds": dict(_build.builds),
               "plan_lookups": len(resolves), "events": events, "first_dispatch_s": first_s,
               # the capture's warm-up runs (WARMUP_RUNS x K steps) and the
               # first replay's K steps, 2 launches a step
               "lstm_seq_launches": launches,
               "manifest_entries": len(back.net._warm_manifest)}
        del back
    finally:
        TT.disable()
        TT.reset()
        dist.destroy_process_group()
    free_card()
    return row


def phase_continuous(L, seed):
    """Continuous learning and the serving fleet on the card (see the module
    docstring): (a) the streaming run with its faults and its digest against
    a clean run, (b) the registry fed from its snapshots, (c) the fleet of
    worker processes, (d) the trainer's instant restart."""
    from deeplearning4j_tpu_torch import telemetry as TT
    from deeplearning4j_tpu_torch.continuous import chaos

    t_phase = time.perf_counter()
    batches = chaos.gen_batches(CONT_GEN_SEED, CONT_BATCHES, batch=CHARNN_BATCH,
                                classes=VOCAB, seq_len=SEQ,
                                poison=(CONT_POISON,))
    trained, _lost = cont_stream_plan()
    probe_x, _ = charnn_data(np.random.RandomState(seed + 29), CONT_MAX_ROWS, SEQ)
    try:
        row, net, first, final, registry = cont_train(L, seed, batches, probe_x)
    finally:
        TT.disable()
        TT.reset()
    step = cont_step_check(seed, [batches[i] for i in trained], first)
    digest = cont_clean(seed, batches, trained, chaos.state_digest(net))
    emit("continuous.train", **row, step_check=step, **digest, card=card_line())
    pool, _ = charnn_data(np.random.RandomState(seed + 37), 4 * CONT_MAX_ROWS, SEQ)
    try:
        fleet = cont_fleet(seed, first, net, final, registry, pool)
    finally:
        registry.stop()
    emit("continuous.fleet", **fleet, card=card_line())
    del net
    free_card()
    restart = cont_trainer_restart(L, seed, batches)
    emit("continuous.trainer_restart", **restart, seconds=time.perf_counter() - t_phase,
         card=card_line())
    return {"lstm_seq_launches": row["lstm_seq_launches"] + restart["lstm_seq_launches"],
            "worker_lstm_seq_launches": {w: d["lstm_seq_launches"]
                                         for w, d in fleet["after_swap"].items()}}


def cuobjdump():
    """The toolkit's cuobjdump, or the copy Triton's package carries; None
    where neither exists."""
    import importlib.util

    found = shutil.which("cuobjdump")
    candidates = [found] if found else []
    candidates.append("/usr/local/cuda/bin/cuobjdump")
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(str(pathlib.Path(spec.origin).parent / "backends/nvidia/bin/cuobjdump"))
    return next((c for c in candidates if c and pathlib.Path(c).exists()), None)


def sass_counts(so, opcodes=("HGMMA", "HMMA")):
    """How many instructions of each of ``opcodes`` the library's SASS
    holds (one disassembly), or "not found" for each without a cuobjdump."""
    tool = cuobjdump()
    if tool is None:
        return dict.fromkeys(opcodes, "not found")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def build_all(build_fns):
    """Build every kernel library at once (one nvcc each, started together):
    ``build_fns`` are the wrappers' build functions."""
    from concurrent.futures import ThreadPoolExecutor

    def one(build):
        t0 = time.perf_counter()
        so = build()
        return so, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build_fns)) as pool:
        built = list(pool.map(one, build_fns))
    emit("build", seconds=time.perf_counter() - t0, libraries=[{
        "library": str(so.relative_to(ROOT)), "seconds": secs,
        "ptxas": [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
                  if "Used" in ln or "spill" in ln or "Compiling entry" in ln]}
        for so, secs in built])
    counted = [so for so, _ in built if so.name.startswith(("conv_stats", "flash_attn"))]
    with ThreadPoolExecutor(len(counted)) as pool:  # the disassemblies side by side
        for so, counts in zip(counted, pool.map(sass_counts, counted)):
            emit("build.sass", library=str(so.relative_to(ROOT)),
                 cuobjdump=cuobjdump() or "not found", **counts)


RANK_BODIES.update({"word2vec.mesh": w2v_mesh_rank, "sequence": sequence_rank,
                    "parallel": dp_rank, "model_parallel": mp_rank})

PHASES = ("kernels", "flash", "train", "conv", "resnet", "serve", "charnn", "zoo", "finetune",
          "fused", "word2vec", "mnist", "modelimport", "moe", "sequence", "parallel",
          "model_parallel", "telemetry", "operations", "compile_tune", "continuous",
          "dashboard", "hostfleet")


def main(argv=None):
    import argparse
    from concurrent.futures import ThreadPoolExecutor

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the training data and weights")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (a partial run prints no "
                         f"result lines); default all of {PHASES}")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phases {sorted(only - set(PHASES))}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.nn.layers import attention as TA
    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.ops import conv_stats as C
    from deeplearning4j_tpu_torch.ops import lstm_seq as L

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated
    card = card_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), card=card)
    # each phase's wall seconds, printed on a line of its own at the end
    marks = [("build", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    build_all([L.build, A.build, A.build_bwd, A.build_bwd_wgmma, C.build])

    mark("kernels")
    if "kernels" in only:
        with library_precision():
            timings, max_err_path = phase_kernels(L)
    mark("flash")
    if "flash" in only:
        with library_precision():
            flash_timings, flash_err, flash_bwd_err = phase_flash(A)
        phase_crossover(TA)
    mark("train")
    if "train" in only:
        train_rows = [phase_train(A, policy, args.seed) for policy in ("f32", "bf16")]
    mark("conv")
    if "conv" in only:
        with library_precision():
            conv_totals, conv_err = phase_conv(C)
    mark("resnet")
    if "resnet" in only:
        resnet_rows = {policy: phase_resnet(C, policy, args.seed) for policy in ("f32", "bf16")}
    mark("serve")
    if "serve" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            zip_path = WORK / "charnn.zip"
            served, net = phase_serve(L, zip_path)
            phase_profile(net)
            phase_cli(zip_path)
            serve_sanitized(L, net)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("charnn")
    if "charnn" in only:
        charnn_rows = {policy: phase_charnn(L, policy, args.seed) for policy in ("f32", "bf16")}
    mark("zoo")
    if "zoo" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            zoo_rows = phase_zoo(C, args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("finetune")
    if "finetune" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            ft_rows = phase_finetune(C, args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("fused")
    if "fused" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            fused_rows = phase_fused(args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    # the four rank cells (word2vec.mesh, sequence, parallel, model_parallel)
    # prepare in their phases and run in ONE spawn of 4 ranks at "ranks"
    shutil.rmtree(RANKS_WORK, ignore_errors=True)
    RANKS_WORK.mkdir()
    mark("word2vec")
    if "word2vec" in only:
        phase_word2vec(args.seed)
    mark("mnist")
    if "mnist" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            phase_mnist(args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("modelimport")
    if "modelimport" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            imported = phase_modelimport(L, C, args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("moe")
    if "moe" in only:
        moe_out = phase_moe(A, args.seed)
    # sequence, parallel and model_parallel share WORK until their ranks ran
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    try:
        mark("sequence")
        if "sequence" in only:
            phase_sequence(A, args.seed)
        mark("parallel")
        if "parallel" in only:
            phase_parallel(C, A, args.seed)
        mark("model_parallel")
        if "model_parallel" in only:
            phase_model_parallel(args.seed)
        mark("ranks")
        cells = run_rank_cells()
    finally:
        RANK_CELLS.clear()
        shutil.rmtree(WORK, ignore_errors=True)
        shutil.rmtree(RANKS_WORK, ignore_errors=True)
    seq_out, par_out, mp_out = (cells.get(k) for k in ("sequence", "parallel",
                                                        "model_parallel"))
    mark("telemetry")
    if "telemetry" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            tel_out = phase_telemetry(A, L, args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("operations")
    if "operations" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            ops_out = phase_operations(C, L, args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("compile_tune")
    if "compile_tune" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            ct_out = phase_compile_tune(A, C, L, args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("continuous")
    if "continuous" in only:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            cont_out = phase_continuous(L, args.seed)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    # the hostfleet phase runs beside the dashboard's processes, (c): one
    # window for the two
    mark("+".join(p for p in ("dashboard", "hostfleet") if p in only))
    if only & {"dashboard", "hostfleet"}:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir()
        try:
            with ThreadPoolExecutor(1) as pool:
                if "dashboard" in only:
                    dash_part = phase_dashboard(args.seed)
                fleet_job = pool.submit(phase_hostfleet, args.seed) \
                    if "hostfleet" in only else None
                if "dashboard" in only:
                    dash_out = phase_dashboard_processes(dash_part)
                if fleet_job is not None:
                    fleet_job.result()
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    mark("end")
    emit("phase_seconds", **{a[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])
                             if a[0] in ("build", "ranks") or set(a[0].split("+")) <= only})
    if only != set(PHASES):
        return

    path = next(r for r in timings if (r["B"], r["H"]) == (64, HIDDEN))
    fpath = flash_timings[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "lstm_seq", "route": "cuda", "source": "deeplearning4j_tpu_torch/csrc/lstm_seq.cu",
        "replaces": "deeplearning4j_tpu/ops/lstm_pallas.py:91; deeplearning4j_tpu/ops/lstm_pallas.py:132",
        # launches over the served path, the char-RNN's training paths
        # (timed steps, TBPTT, streaming), its timed K=4 dispatches (fused
        # phase) under both policies and the modelimport phase; the bwd_*
        # keys are lstm_seq_bwd's (PyTorch, no kernel yet) at B=64, f32
        # (and *_bf16), beside cuDNN's nn.LSTM backward
        "launches": served["lstm_seq_launches"] + sum(r["path_launches"]
                                                      for r in charnn_rows.values())
        + sum(fused_rows[("charnn", p)]["launches"]["lstm_seq"] for p in ("f32", "bf16"))
        + imported["lstm_seq_launches"] + mp_out["launches"]["lstm_seq"]
        + tel_out["lstm_seq_launches"] + ops_out["lstm_seq_launches"]
        + ct_out["launches"]["lstm_seq"] + cont_out["lstm_seq_launches"]
        + sum(cont_out["worker_lstm_seq_launches"].values()) + dash_out["lstm_seq_launches"]
        + sum(dash_out["worker_lstm_seq_launches"].values()),
        "launches_serve": served["lstm_seq_launches"],
        # the dashboard phase: in this process the train verb's path at world
        # 1 (8 steps with and 8 without the StatsListener, 2 a step), the
        # reference forward, the K=4 fits (the capture's warm-up and the
        # replays under polling); in each fleet worker its warm-ups and
        # answers, read from its /health (the train and serve verbs'
        # processes report none)
        "launches_dashboard": {"trainer": dash_out["lstm_seq_launches"],
                               "workers": dash_out["worker_lstm_seq_launches"]},
        # the continuous phase: in this process the streaming run's K=4
        # replays (the rolled-back dispatch's included), its snapshots'
        # forwards and the registry's warm-ups and answers, and the restored
        # trainer's first dispatch; in each fleet worker process its
        # warm-ups and answers, read from its /health
        "launches_continuous": {"trainer": cont_out["lstm_seq_launches"],
                                "workers": cont_out["worker_lstm_seq_launches"]},
        # the compile_tune phase: the char-RNN's default and tuned forwards
        # (two calls each), in this process; the tuner's candidate launches
        # and the three serve-CLI legs' are not counted here
        "launches_compile_tune": ct_out["launches"]["lstm_seq"],
        # the operations phase: the hot-swapped stream (both nets' warm-ups),
        # the flood engine's warm-up and flood, the burn batch
        "launches_operations": ops_out["lstm_seq_launches"],
        # the telemetry phase: the served burst with telemetry on
        "launches_telemetry": tel_out["lstm_seq_launches"],
        # the model_parallel phase: the char-RNN pipelined over 2 stages
        "launches_model_parallel": mp_out["launches"]["lstm_seq"],
        # the modelimport phase: the char-RNN restored from its DL4J zip and
        # served, the Keras imdb_lstm forward, the GravesLSTM fixture
        "launches_modelimport": imported["lstm_seq_launches"],
        # from CUDA-graph replays: the fused phase's timed K=4 dispatches
        "launches_fused": {p: fused_rows[("charnn", p)]["launches"]["lstm_seq"]
                           for p in ("f32", "bf16")},
        "launches_train": {p: r["path_launches"] for p, r in charnn_rows.items()},
        "max_abs_err": max_err_path, "ms": path["ms"],
        "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"], "device_ms": path["device_ms"],
        "library_device_ms": path["library_device_ms"],
        "launches_by_variant": served["lstm_seq_launches_by_variant"],
        **{f"bwd_{k}{sfx}": charnn_rows[p]["bwd"][k] for p, sfx in (("f32", ""), ("bf16", "_bf16"))
           for k in ("ms", "device_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "flash_attn", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attn.cu",
        "replaces": "deeplearning4j_tpu/ops/attention_pallas.py:175",
        # launches over the train phase's 10 timed f32 steps, the moe phase
        # (its timed steps under both policies, its K=4 replays, its served
        # forwards) and the sequence phase's ranks (ring and Ulysses)
        "launches": train_rows[0]["flash_launches"] + moe_out["flash_launches"]
        + seq_out["flash_launches"] + par_out["flash_launches"]
        + mp_out["launches"]["flash_attn"] + tel_out["flash_launches"]
        + ct_out["launches"]["flash_attn"],
        # the compile_tune phase: the LM's default and tuned forwards
        "launches_compile_tune": ct_out["launches"]["flash_attn"],
        # the telemetry phase: the LM's steps with telemetry off and on and
        # the profiled round
        "launches_telemetry": tel_out["flash_launches"],
        # the model_parallel phase's ranks: the TP+EP MoE step, the
        # pipelined and composed LMs (checks, references and timed steps)
        "launches_model_parallel": mp_out["launches"]["flash_attn"],
        "launches_train": train_rows[0]["flash_launches"],
        # the parallel phase's LM steps under fsdp and fsdp_stream, 4 ranks
        "launches_parallel": par_out["flash_launches"],
        "launches_moe": {"train": {p: r["flash_launches"] for p, r in moe_out["train"].items()},
                         "fused": moe_out["fused"]["flash_launches"],
                         "serve": moe_out["serve"]["flash_launches"]},
        "launches_sequence": seq_out["flash_launches"], "max_abs_err": flash_err,
        # flash_attention_block at one ring block's shape (B=2, T=4096, f32)
        "block_entry": {k: seq_out["timing"][torch.float32][k]
                        for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "bound_3xtf32_ms", "fwd_bwd_ms")},
        "block_entry_max_abs_err": seq_out["max_abs_err"],
        "ms": fpath["ms"], "plain_ms": fpath["plain_ms"], "bound_ms": fpath["bound_ms"],
        "bound_by": fpath["bound_by"], "library_ms": fpath["library_ms"],
        "device_ms": fpath["device_ms"], "library_device_ms": fpath["library_device_ms"],
        "bound_3xtf32_ms": fpath["bound_3xtf32_ms"],
        "launches_by_variant": train_rows[0]["flash_launches_by_variant"]}, {
        # the backward of every flash call above that trains: times at the
        # training path's shape (B=4, H=8, T=4096, D=64, causal), the bf16
        # ones as *_bf16; library_ms SDPA's backward alone (autograd over a
        # kept graph), TF32 off
        "name": "flash_attn_bwd", "route": "cuda",
        # the main path's variants (f32_3xtf32_wgmma, bf16_wgmma); the
        # mma.sync ones (D > 64, unaligned views) in the other source
        "source": "deeplearning4j_tpu_torch/csrc/flash_attn_bwd_wgmma.cu",
        "other_source": "deeplearning4j_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "deeplearning4j_tpu/ops/attention_pallas.py:321",
        # launches over the train phase's 10 timed steps under each policy,
        # the moe phase (timed steps under both policies, the K=4 replays,
        # the sync check's block), the sequence phase's ranks (ring blocks
        # and Ulysses), the parallel phase's fsdp and fsdp_stream LM steps,
        # the model_parallel phase's LMs and the telemetry phase's LM steps
        "launches": sum(r["flash_bwd_launches"] for r in train_rows)
        + moe_out["flash_bwd_launches"] + seq_out["flash_bwd_launches"]
        + par_out["flash_bwd_launches"] + mp_out["launches"]["flash_attn_bwd"]
        + tel_out["flash_bwd_launches"],
        "launches_train": {r["policy"]: r["flash_bwd_launches"] for r in train_rows},
        "launches_moe": {"train": {p: r["flash_bwd_launches"] for p, r in moe_out["train"].items()},
                         "fused": moe_out["fused"]["flash_bwd_launches"],
                         "sync": moe_out["sync"]["flash_bwd_launches"]},
        "launches_sequence": seq_out["flash_bwd_launches"],
        "launches_parallel": par_out["flash_bwd_launches"],
        "launches_model_parallel": mp_out["launches"]["flash_attn_bwd"],
        "launches_telemetry": tel_out["flash_bwd_launches"],
        "launches_by_variant": {
            vn: sum(r["flash_bwd_launches_by_variant"].get(vn, 0) for r in train_rows)
            for vn in A.BWD_VARIANTS},
        "max_abs_err": flash_bwd_err,
        "ms": fpath["bwd"]["ms"], "plain_ms": fpath["bwd"]["plain_ms"],
        "bound_ms": fpath["bwd"]["bound_ms"], "bound_by": fpath["bwd"]["bound_by"],
        "library_ms": fpath["bwd"]["library_ms"], "device_ms": fpath["bwd"]["device_ms"],
        "bound_3xtf32_ms": fpath["bwd"]["bound_3xtf32_ms"],
        # each pass alone on the card beside its bound, and the same times
        # of the earlier mma.sync design at this shape (by_variant)
        **{k: fpath["bwd"][k] for k in fpath["bwd"] if k.startswith(("dq_pass", "dkdv_pass"))},
        "variant": fpath["bwd"]["variant"], "by_variant": fpath["bwd"].get("by_variant"),
        **{f"{k}_bf16": flash_timings[torch.bfloat16]["bwd"].get(k)
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "dq_pass_device_ms", "dkdv_pass_device_ms", "variant", "by_variant")},
        "slices": fpath["bwd_slices"],
        # flash_attention_block's backward with the lse cotangent at one ring
        # block's shape (B=2, T=4096, not causal, f32)
        "block_entry": seq_out["timing"][torch.float32]["bwd"]}] + [{
        # per forward of the fused ResNet50 at batch 64 in f32 (the *_bf16
        # keys: in bf16): the sums over the kernel's calls; launches over the
        # 10 timed bf16_policy steps of the resnet phase, the 10 timed steps
        # of the remat'd ResNet50 under each policy (zoo phase), the last 10
        # timed fine-tune steps under each policy (finetune phase) and the 10
        # timed K=4 dispatches (40 steps, CUDA-graph replays) under each
        # policy (fused phase)
        "name": name, "route": "cuda", "source": "deeplearning4j_tpu_torch/csrc/conv_stats.cu",
        "replaces": f"deeplearning4j_tpu/ops/conv_pallas.py:{line}",
        "launches": resnet_rows["bf16"]["conv_launches"][name]
        + sum(zoo_rows[("remat", p)]["conv_launches"][name] for p in ("f32", "bf16"))
        + sum(ft_rows[p]["conv_launches"][name] for p in ("f32", "bf16"))
        + sum(fused_rows[("resnet", p)]["launches"][name] for p in ("f32", "bf16"))
        + par_out["conv_launches"][name] + mp_out["launches"][name]
        + ops_out["conv_launches"][name] + ct_out["conv_launches"][name],
        # the compile_tune phase: the ResNet50's default and tuned forwards
        "launches_compile_tune": ct_out["conv_launches"][name],
        "launches_resnet": resnet_rows["bf16"]["conv_launches"][name],
        # the operations phase: the goodput cell's timed StepDriver steps,
        # telemetry off and on (10 each)
        "launches_operations": ops_out["conv_launches"][name],
        # the model_parallel phase: the pipelined ResNet50's steps (the
        # split inference runs no conv-stats kernel)
        "launches_model_parallel": mp_out["launches"][name],
        # the parallel phase: world-1 timed steps of 3 layouts under both
        # policies and the K=4 replays, the 4 ranks' steps and master steps
        "launches_parallel": par_out["conv_launches"][name],
        "launches_fused": {p: fused_rows[("resnet", p)]["launches"][name]
                           for p in ("f32", "bf16")},
        "launches_remat": {p: zoo_rows[("remat", p)]["conv_launches"][name]
                           for p in ("f32", "bf16")},
        "launches_finetune": {p: ft_rows[p]["conv_launches"][name] for p in ("f32", "bf16")},
        "max_abs_err": conv_err,
        "ms": conv_totals[(name, "float32")]["ms"],
        "plain_ms": conv_totals[(name, "float32")]["plain_ms"],
        "bound_ms": conv_totals[(name, "float32")]["bound_ms"],
        "bound_by": conv_totals[(name, "float32")]["bound_by"],
        "library_ms": conv_totals[(name, "float32")]["library_ms"],
        "device_ms": conv_totals[(name, "float32")]["device_ms"],
        "library_device_ms": conv_totals[(name, "float32")]["library_device_ms"],
        **{f"{k}_bf16": conv_totals[(name, "bfloat16")][k]
           for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
                     "library_device_ms")}}
        for name, line in (("conv_mm_stats", 86), ("conv3x3_stats", 169))]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
