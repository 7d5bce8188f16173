#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, extraction, training and
evaluation paths on one GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs 1 GPU

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. environment: the card's name and power limit, the CUDA and Triton
   versions, nvcc's version; build the kernels from ``csrc/``;
2. every forward kernel against its plain PyTorch version on the card, at
   the serving shapes of the ``fhvae`` CLI defaults (T = 20, B = 2048, D =
   80, H = 128), with max abs error, tolerance and the time of each (CUDA
   events, after warm-up).
   The bf16 calls of the two LSTM forward entries must take the tensor-core
   form (``launches_tc``), the fp32 calls the FMA form; the tensor-core form
   is held pass by pass against the plain forward in the same pass structure
   (the layer-1 gates after pass A, tops, h2 and the residuals after the
   chain), two launches compared bitwise, its kernels timed per pass
   (torch.profiler), the FMA form in bf16 mode held to the same plain
   version and timed in turns with it, each through its own launcher (what
   every bf16 call took before the tensor-core form), then run with residuals on a ragged batch of 1000 rows, the
   training batch of 1024 and a mesh rank's 512, and on batches split in two
   against the whole (2048 rows, which take 32-row clusters, against 2 x 1024,
   which take 16-row ones, and 1024 against 2 x 512: equal bit for bit per
   row); both forms' error in each of tops, h2, h1, c1, c2 held to a share of
   the plain fp32-vs-bf16 gap of that output at one, two and three times the
   model's weight scale; the chain timed alone without its global traffic and without its
   products; ``torch.nn.LSTM`` (cuDNN) on the same function (the stack's
   weights mapped onto its gate layout, ``bias_hh`` zero, the input and the
   time-constant part joined at every step), held within the fp32 limit in
   fp32 with TF32 off, then timed in fp32 and in bf16 (fp16 where cuDNN
   does not run bf16), its kernels read to say that cuDNN ran;
2f. (part of 2) the discriminative forward (z2 width 16) against its plain
   version at the serving batch (2048 rows) and the training batch (1024)
   on tables of 4,620 and 281,241 rows with 7 padded rows and an index
   outside the table: ``log_qy`` and ``lse`` within the limit, two launches
   and the batch split in two (2048 against 2 x 1024, 1024 against 2 x 512)
   equal bit for bit, one launch counted per call; device time per kernel
   (torch.profiler) beside the calls back to back (CUDA events);
3. the slice: synthesize audio, write an fhvae experiment (config, MVN
   stats, a seeded port checkpoint with 4,620 table rows), start the port's
   ``serve`` on piped streams, send a ping, three encode requests, one
   malformed request and a shutdown, check every response, check that the
   three model kernel entries were launched during the requests, and hold the
   served latents against the same requests run through the plain versions
   on the card. Then the same again from a copy of the experiment whose
   config says ``extractor: "jax"``: the features are computed on the card
   through ``fused_logmel_frames``, which must have been launched; the
   card's features are held against the host extractor's and the served
   latents against the first run's;
3b. the port's CLI, ``extract`` over manifests of the served WAVs and
   ``preprocess`` of the synthetic corpus, each with ``--extractor jax`` on
   the card and with ``--extractor numpy``: manifests and frame counts
   equal, features within the stated limit;
2b. the three backward entries against their plain backward at the training
   shapes (B = 1024), in fp32 and bf16 operands, on the same residuals and
   cotangents, two launches compared bitwise. The bf16 calls must take the
   tensor-core form (``launches_tc``), the fp32 calls the FMA form; the
   tensor-core form's streams are held pass by pass against the plain
   backward in the same pass structure (gates after pass A, dgates after
   pass B), its kernels timed per pass (torch.profiler) beside the whole
   call (CUDA events), the FMA form in bf16 mode held to the same plain
   backward through its launcher, the reverse-time chain timed alone without its global
   traffic and without its products, and the bf16 forms run once more on a
   ragged batch of 1000 rows and on a mesh rank's 512 rows, each output held
   to the tolerance on its own, and both forms (bf16 and fp32 operands) on
   the batch split in two against the whole batch (per-row outputs equal bit
   for bit, summed outputs up to fp32 sum order); then the discriminative
   backward at 4,620 and 281,241 table rows with 7 padded
   rows, which must get exactly zero gradient; the LSTM backward of
   ``torch.nn.LSTM`` (autograd through a kept graph, to the input and every
   weight) as in phase 2, its weight gradients held to the plain fp32
   backward's;
2c. ``windowed_chunk_gather`` against its plain version at the dev MAP
   pass's shape (128 chunks of 16 windows, seg_len 20, stride 8, D 80) on a
   100,000-row store and on a store of TIMIT-train size, whose last chunks
   run into the staged slack: a copy, so equal bit for bit, and two
   launches equal;
2g. ``stage_gather`` at a hierarchical round's shape: 5,000 of 9,300
   sequences of 1,000-1,900 frames (D 80; a 4.32 GB float32 store in host
   memory, page-locked and mapped once, its registration timed), into a
   buffer of the K longest sequences' rows, in float32 and bfloat16: equal
   bit for bit to the host sub-pack restaged (``subset(materialize=True)``
   and ``copy_rows``, the path it replaces, timed beside it), to the copy
   engine's form (a ``copy_`` a sequence from the registered store, in
   bfloat16 into a float32 buffer cast on the card after; timed beside it
   as the library form, with the host's time to issue it) and between two
   launches, one launch counted a call; its time against the host link's
   peak (PCIe generation and width from nvidia-smi: the bound) and against
   one pinned ``copy_`` of the round's float32 bytes;
2d. ``fused_logmel_frames`` against its plain version at the serving batch's
   shape (32 utterances of 205 frames), a ragged N, one frame, silent frames
   (at the default floor and at one below them) and a 40-band bank; a
   rectangular window in place of the Hamming one must miss the limit; the
   three served batch sizes (1,640, 6,560 and 13,120 frames) timed against
   the plain version, which the kernel must beat at the first two, each tile
   height and the kernel's timing variants beside them (bits equal); voiced
   frames over noise at several levels, within the limit at
   ``DR_NOISE_DB``, where the plain chain with TF32 products must miss it;
   rows equal bit for bit whatever batch they came in;
2e. kernel #7, the sharded discriminative entry, in one process: the
   per-shard partials kernel launched once per shard with its row offset, the
   shards merged with the torch ops the entry itself uses, and the per-shard
   backward, for 2, 4 and 8 shards of a 4,620-row table (padded to 4,624 at
   8) and 4 shards of a 281,241-row one (padded to 281,244), against the
   plain versions of the single-table forward and backward on the whole
   unpadded table; padded rows must get exactly zero gradient, shards made
   only of padding (5 rows over 8 shards) must leave the result unchanged
   bit for bit, two launches of the partials must give the same bits, and
   the plain partials fed offset 0 must miss the limit; the forward's
   device time per kernel beside its calls back to back;
4. training: write a preprocessed feature corpus of 4,620 training and 400
   dev sequences; hold the first three train steps through the kernels
   against the same steps through the plain versions on the card, and the
   device-resident tier's first three steps against the host loader's (equal
   bit for bit), and the staged dev pass against itself (bit for bit) and
   the host's; then run the port's ``train`` CLI at its defaults (fhvae, batch
   1024, bf16 LSTM operands, ``--data-placement auto``, which stages the
   store and the dev split on the card) for 2 epochs and resume it for a
   third, checking that the data was device-resident, that the loss is
   finite and falls, that the resumed run continues the step count,
   that all seven kernel entries were launched and that every LSTM launch,
   forward and backward, took the tensor-core form (in the served requests
   and the mesh's ranks too); last, one
   epoch with
   ``--data-placement host``, whose train loss must equal the device run's
   epoch 0 and whose dev bound must agree with it;
4k. ``train --steps-per-dispatch 8``, each dispatch one CUDA graph replay
   of 8 whole train steps (``train/graphs.py``): Adam's bias corrections as
   device fp32 scalars divide as the host floats did, bit for bit; then
   phase 4's runs through the CLI at K = 8
   (2 epochs + 1 resumed on the device tier, 1 on the host loader: 133
   steps an epoch, 16 dispatches and 5 eager steps), whose every epoch's
   train loss, step count and dev metrics, and the epoch-2 checkpoint,
   must equal phase 4's bit for bit, whose resumed run continues the step
   count, whose device runs count the launches of phase 4's, and whose
   every LSTM launch took the tensor-core form;
4s. the streamed tier and compressed staging (``data/stream_store.py``,
   ``--transfer-dtype``). 4s-check, on phase 4's corpus with
   ``--device-store-max-bytes`` 96 MiB, over which ``auto`` streams the
   370 MB store in ~16 chunks of 24 MiB: one streamed epoch in each of
   float32, bfloat16 and int8 through the CLI against a host replay of the
   same schedule (windows cut by the numpy store gather; bfloat16 rounded
   by torch; int8 dequantized per chunk), bit for bit in train loss, dev
   bound and every tensor of the checkpoint, the bfloat16 run's dev MAP pass
   launching #8 on bf16 rows; K = 8 against K = 1 bit for bit and a
   resumed streamed run continuing the step count; bfloat16 and int8 on the
   device-resident tier, finite, their gaps from float32 logged. 4s-big,
   the CLI defaults over the default 4 GiB budget: a synthetic corpus of
   9,300 training sequences of 1,000-1,900 frames (4.32 GB in float32,
   just over the budget) and 400 dev ones, packed once
   (``--pack-cache-dir``, kept for 4h and 5h); two runs at K = 8 stopped
   by ``--max-steps`` 504 past their first chunk switch, with no placement
   flags (``auto`` must stream ~5 chunks of 1 GiB) and at
   ``--transfer-dtype bfloat16`` (staged whole), each finite. Every LSTM
   launch of the phase's train runs took the tensor-core form, and each of
   the seven train entries was launched;
4h. hierarchical rounds, ``train --hierarchical`` (``train/rounds.py``) at
   the CLI defaults, K = 5,000 sequences a round, on 4s-big's corpus (kept
   from phase 4s, else written), over the 4 GiB budget, so ``auto`` stages
   each round's sub-pack into one buffer of the K longest sequences' rows
   (2.684 GB): (a) K = 8, two rounds, which must say so, each round's table
   the MAP pass's (kernel #8, chunk skip 8, 79 batches of 2,048) with its
   Adam moments zeroed (K = 8 against K = 1 of a staged round, where a
   table or store bound anew under the captured graph would show, is 5h
   (b)'s check on an NCCL rank, and (e)'s on views); (b) the host loader at
   K = 8, whose first table is within ``TOL_HIER_TABLE`` of (a)'s and each
   epoch's train loss and dev bound within ``TOL_HIER_EPOCH``; (c)
   two-epoch rounds stopped by ``--max-steps`` in the round's second epoch
   and resumed, bit for bit against the run never stopped, with #8
   launched as often (no second MAP init); (d) bfloat16 staging, #8 on
   bf16 rows; (e) phase 4's corpus with 2,000-sequence rounds on the
   device tier (views of the staged store), K = 8 against K = 1 bit for
   bit. Each round of (a), (c) and (d) is one ``stage_gather`` launch from
   the memory-mapped pack held as a page-locked copy in memory. Every LSTM
   launch is tensor-core, and the seven train entries are launched;
4m. ``--model-type simple_fhvae``, the reference's own model, at the CLI
   defaults (input 20 x 80, H 128, z 16, batch 256) on phase 4's corpus:
   (a) the first three steps through #5/#6 against the plain versions
   (``TOL_TRAIN_LOSS``, ``TOL_TRAIN_UPDATE``); (b) two epochs at K = 1
   and at K = 8, bit for bit (the MLPs' cuBLAS products inside the
   captured graph); then at K = 8, since
   an eager step is host-bound: (c) one host-loader epoch, its train loss
   and dev bound within ``TOL_DEV_LB`` of the device tier's; (d) a run
   stopped by ``--max-steps`` at epoch 1, batch 50 and resumed, equal to
   (b)'s K = 8 run; (e) one streamed epoch at
   ``STREAM_BUDGET`` equal to its host replay; (f) ``eval`` and ``probe``
   of the best checkpoint (the bound within ``TOL_DEV_LB`` of the best
   epoch's) and three ``serve`` requests from its copy that says
   ``extractor: "jax"`` (#9); (g) ``import-checkpoint`` of a reference-schema
   ``.tar`` written here with ``torch.save`` from seeded weights, then a
   ``--finetune`` epoch from it. #1-#4 launch 0 times in its runs, #5, #6,
   #8 and #9 more;
4p. ``--epoch-plan device`` at the fhvae defaults on phase 4's corpus: (b)
   each epoch's plan derived on the card a permutation of the host plan's
   real rows with the padding at the tail, two epochs two orders, its time
   against the host's order, plan and upload; (a) two epochs at K = 8 equal
   to K = 1 bit for bit; (c) stopped at epoch 1, batch 50 at K = 8 and
   resumed in a new process, equal to (a)'s K = 1 run; (d) two
   2,000-sequence rounds on
   the device tier, K = 8 equal to K = 1; (e) the streamed tier prints the
   JAX package's note and trains the host plan's epoch (4s-check's fp32
   epoch, or its own);
4b. ``eval`` and ``probe`` of phase 4's experiment through the port's CLI
   (dev split, 400 sequences, batch 2048): the three forward kernel entries
   launched, every LSTM launch through the tensor-core form; the eval's dev
   bound equal to the best epoch's within ``TOL_DEV_LB``; each latent of
   ``latents.npz`` within ``TOL_BF16_OF_GAP`` of its own plain
   fp32-vs-bf16 gap from the same eval through the plain versions (the
   error against ``TOL_SERVED`` logged), and the same eval in fp32 operands
   through the kernels within ``TOL_FP32`` of the plain fp32 eval; the
   probe's JSON equal to the eval's; wall time and stages logged;
4q. the quality twin of ``misc/repro_quality.sh``: ``preprocess`` of 64
   synthetic speakers x 5 utterances, ``train`` (fhvae, 30 epochs, batch
   64, dev batch 256, seed 0), ``eval`` and ``probe`` through the port's
   CLI, each epoch's dev bound and ``val_log_qy`` logged beside the JAX
   package's committed run (one v5e chip) and held to limits taken from it:
   the dev bound rises by at least half the reference's rise, ends within
   10% of its epoch-29 value, ``val_log_qy`` ends in (-0.5, 0), and the z2
   speaker probe reaches 0.6 and z1's plus 0.1;
5. the mesh path, ``train --mesh d,m``, at the same width and on the same
   corpus. The machine has one card, so the four ranks of a ``2,2`` mesh
   share it (``--dist-backend gloo``); this script is their launcher
   (``parallel/launch.run_ranks``) and every rank runs the CLI with
   ``--distributed``. Inside the ranks: kernel #7's entry forward and
   backward through the real process groups against its plain version; the
   first three steps' loss and update against the single-device steps; the
   time of a step and of its all-reduces (four processes time-slicing one
   card: no multi-GPU throughput, and no scaling figure is derived); then one
   epoch through the CLI, whose train loss and dev bound must agree with the
   single-device epoch 0 and whose replicated parameters the loop itself
   holds equal bit for bit across the ranks; #7's forward and backward must
   have been launched once per step and rank, #6 and #8 never. The epoch's
   checkpoint is then resumed for one epoch by ``train --mesh 1,2`` (the CLI
   starts the two ranks itself) and on one device (phase 5k runs the
   one-rank NCCL epoch);
5t. the data tiers of the ``2,2`` mesh on phase 4's corpus, four gloo
   ranks on the card started once, each running every CLI run in turn
   with ``--distributed``: ``auto`` over a 256 MiB budget streams the 370
   MB store and with ``--shard-device-store`` stages it row-sharded (twice
   the budget), the lines rank 0 prints checked; row-sharded against
   replicated bit for bit on the device tier (20 steps) and on the streamed
   tier in float32 (a whole epoch in chunks of 24 MiB, its dev split staged)
   and int8 (40 steps), each pair crossing chunk switches; the row-sharded
   streamed epoch against the single-device streamed epoch
   (``TOL_MESH_EPOCH``, ``TOL_MESH_LOG_QY``); that run stopped by
   ``--max-steps`` one batch into a chunk and resumed, bit for bit against
   the run never stopped; per-rank link MB an epoch, ms/step and rank 0's
   waits at each chunk switch (``switch_waits()``); #7 launched once a
   step forward and backward on rank 0, #6 and #8 never, every LSTM launch
   tensor-core. The gloo runs of 5t, 5k (b), 5h (a) and 4o (d) share one
   launch of the four ranks (``gloo_mesh_runs``), each run counted alone;
   the script logs what each phase's runs took in it;
5k. ``--mesh d,m --steps-per-dispatch 8`` on phase 4's corpus. (a) One
   rank of ``--mesh 1,1 --distributed --dist-backend nccl``: 10 warm
   dispatches of 8 eager mesh steps under torch.profiler (host wall against
   device busy, the host calls of most self time), then a mesh bundle from
   the same start replayed as one CUDA graph a dispatch with its all-reduces
   inside (host wall, busy and idle share, ``cudaGraphLaunch`` calls, the
   NCCL kernels among the replayed ones by name, and #1-#4 and #7 counted by
   the profiler against the wrappers' launches), both states equal bit for
   bit; then an epoch through the CLI at K = 8 against K = 1 (metrics and
   every checkpoint array bit for bit; the K = 8 run says that it replays)
   and K = 1 against phase 4's epoch 0 (``TOL_MESH_EPOCH``), #7 once a
   step forward and backward; (b) ``--mesh 2,2`` on four gloo ranks on the
   card, started once, whose bundles run their steps eagerly (the runs say
   so), each pair bit for bit in its step checkpoint and loss sum: the
   device tier K = 8 against K = 1 (29 steps), row-sharded against
   replicated at K = 8, streamed fp32 K = 8 against K = 1 over the first
   three chunks of 24 MiB and one step more (a chunk whose batches do not
   fill its last dispatch), and a K = 8 run stopped at 13 steps and
   resumed to 29 against the run never stopped (loss sum to 1e-12);
5h. ``--mesh d,m --hierarchical``. (a) ``--mesh 2,2`` on the four gloo
   ranks, 2,000-sequence rounds on phase 4's corpus, runs stopped at 29
   steps: the device tier (views) K = 8 against K = 1, row-sharded against
   replicated, a K = 8 run stopped at 13 and resumed (re-entering its
   round) against the run never stopped, each bit for bit; the round tier
   at a budget under which the replicated sub-pack lowers K and the
   row-sharded one does not (the lines checked); the host loader within
   ``TOL_HIER_EPOCH`` of the device tier; #7 once a step, #6 and #8 never;
   each round of the round tier one ``stage_gather`` launch on rank 0.
   (b) One rank of ``--mesh 1,1 --distributed --dist-backend nccl`` at the
   CLI defaults (K = 5,000) on 4s-big's corpus (kept from 4s, else
   written), a round's sub-pack staged: a round entered by ``Rounds`` and
   its mesh bundle replayed, 10 warm dispatches under torch.profiler (#1-#4
   and #7 counted against the wrappers, ``cudaGraphLaunch`` calls, idle
   share); through the CLI K = 1 stopped at 200 steps against K = 8
   stopped there, bit for bit, then the K = 8 run resumed through its
   second round; every MAP init the rows pass (``device_map_pass_rows``,
   never #8, as in the JAX loop) and every round's table the whole table's
   rows on the rank with its moments zeroed, and each round the K = 8
   runs enter one ``stage_gather`` launch from the pack held as a
   page-locked copy in memory. 5k (a) and 5h (b) run in one
   process, started once (``nccl_mesh_runs``);
5n. (only when named: ``--only 5n``, on four cards) 5k (a) and 5h (b) on a
   ``2,2`` NCCL mesh, a card a rank, in one launch: the replayed graphs
   must hold NCCL kernels (a one-rank communicator launches none), every
   rank's bundle state its eager steps', the CLI epoch at K = 8 the K = 1
   epoch's bits; the hierarchical runs as in 5h (b), every rank holding its
   rows of each round's table; (e) ``--ckpt-backend orbax`` at K = 8
   stopped at step 50 and resumed through the epoch, its checkpoint and
   records equal to the K = 8 npz epoch's bit for bit, each rank's DCP file
   holding its own rows, and each rank's blocking ms per save of both
   backends (the npz one with its NCCL gather of the table);
4r. step checkpoints and mid-epoch resume at the CLI defaults on phase 4's
   corpus: runs stopped by
   ``--max-steps`` inside an epoch with ``--ckpt-every-steps 50`` (the
   stopped step must be the cap exactly, no checkpoint of that epoch
   written), resumed from their last step checkpoint with
   ``max_steps=0``, each held against the run that was never stopped in
   every checkpoint tensor, the dev metrics (bit for bit) and the train
   loss (1e-12 relative), no step checkpoint left: (a) the device tier, cap
   183 (epoch 1, batch 50), against phase 4's run, after a resume at the
   cap that must train nothing; (b) the same at K = 8 (the cap off a
   dispatch boundary, so the last dispatches clamp); (c) the host loader
   at K = 1 and 8, cap 70, against phase 4's host-loader epoch; (d) the
   streamed tier (fp32, 96 MiB, K = 8) with the cursor inside a chunk,
   whose resume must stage only the chunks not wholly behind it, against
   4s-check's K = 8 epoch; the NaN gate (lr 1e18: exit 2, no checkpoint).
   A mesh stopped and resumed is 5k (b)'s and 4o (d)'s check, in the
   shared gloo launch. Without phase 4s it runs its reference epoch
   itself. Logged:
   the wall time of each step-checkpoint save beside the card's name and
   power limit;
4o. ``--ckpt-backend orbax`` (``train/orbax_backend.py``: saves staged to
   the host and written on a thread through ``torch.distributed.checkpoint``)
   at the CLI defaults on the device tier at K = 8 on phase 4's corpus,
   after phase 4r: (a), (b) two epochs stopped by ``--max-steps 183`` with
   ``--ckpt-every-steps 50`` and resumed from the last step directory, every
   tensor of both epoch checkpoints and the records equal to phase 4's npz
   run bit for bit (``train_loss`` to 1e-12), no step directory left; (c)
   ``eval`` from the run's best pointer against ``eval`` of phase 4's npz
   checkpoint of that epoch, the dev bound and ``log_qy`` bit for bit; the
   host-clock ms the loop blocked on each save (the staging) and each flush's
   wait, then 4 saves of phase 4's epoch-1 state by each backend in turns
   (npz: the whole save; orbax: the staging; then its flush) and the MB each
   wrote; (d) in the shared launch of the four gloo ranks, ``--mesh 2,2`` at
   K = 8 stopped at 13 and resumed to 29 against the npz run to 29, bit for
   bit, each row shard of the table and its moments in the file of a rank
   of that shard (no gather), the directory loaded on one device equal to
   the npz run's whole tensors; #1-#6 launched (#7 on the mesh), every
   LSTM launch tensor-core;
4l. every single-device train flag, on phase 4's corpus with its dev split
   cut to its first 32 sequences (a legacy dev pass runs a forward per
   segment at batch 1), run last: first, ``plain_stack`` must not have
   been called by any earlier phase in this process (e); (a) ``--legacy
   --steps-per-epoch 300 --log-interval 100`` for 2 epochs at the fhvae
   defaults: the first three steps at batch 1 through kernels #1-#6
   against the plain versions (``TOL_TRAIN_LOSS``, ``TOL_TRAIN_UPDATE``),
   the progress lines and the ``_legacy`` run directory, a resume from
   epoch 0's checkpoint given ``--steps-per-dispatch 8`` (which legacy
   epochs ignore) equal to the K = 1 run never stopped bit for bit, ms/step
   of the eager batch-1 steps and the batch-1 dev passes' seconds; every
   LSTM launch in the tensor-core form; (b) ``--profile-dir`` for one epoch at
   K = 1 and at K = 8: the Chrome trace parses, and at K = 1 it names every
   kernel the epoch's wrappers launched (the trace's count printed beside
   the wrappers'); (c) ``--tensorboard --log-params --visdom`` for one epoch
   at K = 8: ``metrics.jsonl``, the event file and ``curves.svg`` where
   tensorboard and matplotlib are installed (else the line says so), and
   the gradient snapshot of epoch 0 through the kernels against the plain
   versions (``TOL_TRAIN_UPDATE`` of its norm); (d) one epoch at ``--z1-hus
   256 128 --z2-hus 256 128 --x-hus 256 128``: #1-#4 launched 0 times,
   #5/#6 launched, ``plain_stack`` called, the train loss within
   ``TOL_TRAIN_LOSS`` of the same epoch through the plain versions; one at
   H 256 for all three stacks: the FMA kernels launched, ``plain_stack``
   not called.

``python3 chip_smoke.py --only 2e,5`` runs the environment phase and the
phases named (while working on one; ``2`` includes ``2f``, ``4k``, ``4b``,
``4r`` and ``4o`` include ``4``); with no arguments all run.

The bf16 tolerances sit between the kernels' error and the gap between the
plain versions in fp32 and in bf16 operand mode, which each run measures: a
kernel that skipped the bf16 rounding would fail them, and the script raises
if that gap ever falls below a tolerance. It imports only the port, never
the JAX package.

The second-to-last line of stdout is a JSON object with one entry per
kernel entry. ``launches`` sums ``launches_by_path``: the counts of the
``extractor: "jax"`` serve run (``serve``), the numpy-extractor serve run
(``serve_numpy``), the CLI extraction (``preprocess``), the train runs
(``train``), phase 4k's train runs at K = 8 (``train_k8``), phase 4s's
runs on the streamed tier (``train_stream``: the sum over those seven runs,
each counted alone; its device-tier, host-loader and whole-bf16 runs are
not counted), phase 4h's hierarchical runs (``train_hier``: every CLI run
of the phase, each counted alone), phase 4m's simple_fhvae runs and served
requests (``train_simple``: each counted alone), phase 4p's runs in this
process (``train_plan``), the eval of phase 4b (``eval``), the mesh run's rank 0
(``mesh``: the ``2,2`` epoch), rank 0 of phase 5t's mesh runs
(``mesh_tiers``: all of them, each counted alone), phase 5k's NCCL epoch
at K = 8 (``mesh_k8``), phase 5h (b)'s K = 8 runs, stopped and resumed
(``mesh_hier``) and phase
4r's stopped and resumed runs in
this process (``train_resume``: every run of (a) to (d) and the NaN gate's;
the mesh's ranks are processes of their own) and phase 4l's ``--legacy``
runs (``train_legacy``: its two CLI runs of (a), each counted alone),
phase 4o's stopped and resumed orbax run (``train_orbax``),
each set to 0 just before its path and read just after. ``ms``
and ``plain_ms`` are the bf16-operand times of an LSTM entry's heaviest form,
and for ``windowed_chunk_gather``, ``fused_logmel_frames`` and the two
discriminative forward entries the device time per call by torch.profiler
(those two also carry ``events_ms``, the calls back to back by CUDA events,
and ``by_shape``, every shape they were timed at;
``windowed_chunk_gather`` carries ``by_dtype``, its bfloat16-row form's
numbers); ``bound_ms`` is the least time the card could
take for the same inputs (their bytes once over 3.35 TB/s, or the products'
operations over 989 TFLOP/s for bf16 operands and 67 TFLOP/s for fp32,
whichever is larger; ``bound_by`` says which; for ``stage_gather`` the
round's float32 bytes over the host link's peak); ``library_ms`` times the
one PyTorch call that computes the same function where there is one (a row
gather for ``windowed_chunk_gather``; ``torch.nn.LSTM`` for the four LSTM
entries, in ``library_dtype`` on ``library_route``, with
``library_fp32_ms`` and every form's in ``library_by_form``; for
``stage_gather`` the copy engine's ``copy_`` a sequence), else null.
The four LSTM entries and the four discriminative entries also carry ``passes_ms`` (device time per
kernel of a call); the LSTM entries ``chain_floor_ms``
(the chain of dependent steps without its global traffic), the two forward
entries ``fma_form_ms`` (the FMA form in bf16 mode, timed in turns with the
tensor-core form).
The line before it is
nvidia-smi's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import wave
from contextlib import contextmanager, nullcontext, redirect_stdout
from pathlib import Path

import numpy as np
import torch

T, B, D, H, Z = 20, 2048, 80, 128, 16
N_TABLE = 4620          # mu2 rows of the served experiment
N_LARGE = 281_241       # a LibriSpeech-scale table for the discriminative check
TOL_FP32 = 1e-4         # LSTM h2/tops, fp32 operands: only the sum order differs
TOL_BF16 = 6e-4         # LSTM h2/tops, bf16 operands: an fp32 sum-order change
                        # can flip one bf16 rounding of h (2^-9 relative); the
                        # plain fp32 and bf16 modes differ by more (1.2e-3 to
                        # 2.3e-3 at these shapes), checked in every run
TOL_BF16_OF_GAP = 0.6   # LSTM tops, h2, h1, c1, c2, bf16 operands, each on its
                        # own: the kernel's error against the plain bf16
                        # version over the plain fp32-vs-bf16 gap of the same
                        # output. The share does not follow the weight scale
                        # as the absolute error does: 0.03 to 0.40
                        # (tensor-core form) and 0.03 to 0.44 (FMA form) over
                        # weights of one to three times the model's init scale
                        # (NVIDIA H100 80GB HBM3, 700 W); a kernel that
                        # skipped a rounding would read about 1
TOL_LOG_QY = 1e-3       # log_qy at |logits| ~ 1e2: fp32 sum order over N rows
TOL_SERVED = 6e-4       # served latents, bf16 operand mode; below the plain
                        # fp32-vs-bf16 gap, checked in every run
B_TRAIN = 1024          # the fhvae CLI's training batch
TOL_BWD_FP32 = 1e-4     # LSTM backward, relative Frobenius norm per output:
                        # fp32 sums over T*B = 20,480 rows in another order
TOL_BWD_BF16 = 1e-3     # bf16 operands: a gate adjoint on a bf16 rounding
                        # boundary may round the other way under another
                        # fp32 sum order and move one row of the step before
                        # it; the plain fp32-vs-bf16 backward gap is larger
                        # (~3e-3 at the CPU tests' shapes), checked every run
TOL_LOG_QY_BWD = 1e-4   # dz2/dmu2, max error over max |ref|: fp32 sum order
N_DEV = 400             # dev sequences of the training corpus (TIMIT's dev)
TOL_TRAIN_LOSS = 1e-3   # first train steps, kernels vs plain versions (bf16
                        # operands), relative: a bf16 rounding flip per sum
                        # order moves the loss by far less
TOL_TRAIN_UPDATE = 0.1  # the same, |p_kernels - p_plain| over the norm of
                        # the 3-step update: Adam's first steps move each
                        # element by ~lr * sign(g), so an element whose
                        # gradient is within the kernels' error of zero may
                        # step the other way
TOL_DEV_LB = 1e-5       # dev bound, device vs host tier, relative: the device
                        # MAP table sums in fp32, the host's in fp64
SPB, SEG, SHIFT = 16, 20, 8   # the dev MAP pass's chunks: spb, seg_len, stride
TIMIT_FRAMES = 1_254_584      # frames of the training corpus below
SOURCES = {
    # the tensor-core form; fp32 operands and other widths: lstm2_fwd_fma.cu
    "lstm2_tm_proj": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_fwd.cu",
                      "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:675"),
    "lstm2_tm": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_fwd.cu",
                 "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:741"),
    "discriminative_log_qy": (
        "pytorch_scalablefhvae_tpu_torch/csrc/discriminative_fwd.cu",
        "pytorch_scalablefhvae_tpu/ops/discriminative.py:234"),
    "lstm2_tm_proj_bwd": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_bwd.cu",
                          "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:582"),
    "lstm2_tm_bwd": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_bwd.cu",
                     "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:374"),
    "discriminative_log_qy_bwd": (
        "pytorch_scalablefhvae_tpu_torch/csrc/discriminative_bwd.cu",
        "pytorch_scalablefhvae_tpu/ops/discriminative.py:189"),
    "windowed_chunk_gather": (
        "pytorch_scalablefhvae_tpu_torch/csrc/window_gather.cu",
        "pytorch_scalablefhvae_tpu/ops/window_gather_pallas.py:88"),
    "fused_logmel_frames": (
        "pytorch_scalablefhvae_tpu_torch/csrc/fbank_logmel.cu",
        "pytorch_scalablefhvae_tpu/ops/fbank_pallas.py:152"),
}
SOURCES["stage_gather"] = (
    "pytorch_scalablefhvae_tpu_torch/csrc/stage_gather.cu",
    "none: the JAX loop materialises each round on the host "
    "(pytorch_scalablefhvae_tpu/train/loop.py)")
SOURCES["discriminative_log_qy_sharded"] = (
    SOURCES["discriminative_log_qy"][0],
    "pytorch_scalablefhvae_tpu/ops/discriminative.py:288")
SOURCES["discriminative_log_qy_sharded_bwd"] = (
    SOURCES["discriminative_log_qy_bwd"][0],
    "pytorch_scalablefhvae_tpu/ops/discriminative.py:343")
TOL_SHARDED = 1e-4      # merged log_qy of the shards vs the plain single table,
                        # absolute; dz2/dmu2 relative Frobenius norm
MESH = (2, 2)           # phase 5: four ranks sharing the card
TOL_MESH_EPOCH = 1e-3   # epoch train loss and dev bound, mesh vs one device,
                        # relative: bf16 LSTM operands at another batch shape
TOL_MESH_LOG_QY = 2e-3  # the same epoch's dev log_qy, relative: the weight
                        # gradients of 2 x 512 rows sum in another fp32 order
                        # than those of 1024 (5e-7 relative), and 133 steps of
                        # bf16 operand flips carry that into this one metric
                        # (a log-softmax over the dev sequences at |logits|
                        # ~ 1e2): read 7.9e-4 with the FMA forward and
                        # 1.06e-3 with the tensor-core forward, whose rows are
                        # equal bit for bit on either batch split (phase 2
                        # holds that in every run). A variant of that kernel
                        # with one fp32 addition in another order read
                        # 1.85e-3: one reordered sum moves this metric by
                        # ~8e-4 (NVIDIA H100 80GB HBM3, 700 W)
N_FFT, N_BINS = 400, 201      # 25 ms at 16 kHz; n_fft // 2 + 1 DFT bins
N_SERVE_FRAMES = 32 * 205     # one serving batch: 32 utterances in the
                              # 32,768-sample bucket, 1 + 32768 // 160 frames
TOL_LOGMEL = 2e-4       # log-mel, kernel vs plain version, absolute: the limit
                        # the JAX package holds its TPU kernel to against its
                        # jnp mirror (the order of a 400-term fp32 sum)
LOGMEL_SHAPES = (8 * 205, N_SERVE_FRAMES, 32 * 410)  # frames of a request's
                        # last batch (8 utterances), a serving batch, and a
                        # batch of the 65,536-sample bucket
LOGMEL_PROBES = {"no DFT FMAs": 1, "one load a slice": 4, "no mel": 16}
                        # csrc/fbank_logmel.cu's timing variants of the
                        # entry's own form (its PROBE template parameter)
DR_NOISE_DB = 40.0      # voiced frames: noise this far below the tone
DR_SWEEP_DB = (-10.0, -5.0, 0.0, 5.0, 10.0, 20.0, 30.0, 40.0)
TOL_FEATS = 2e-3        # log-mel features, device chain (fp32 DFT by products)
                        # vs host extractor (float64 FFT), absolute and
                        # relative: the JAX package's own limit between its
                        # two extractors is 2e-2 where the bin carries energy;
                        # read 6.0e-4 (NVIDIA H100 80GB HBM3, 700 W)
TOL_SERVED_JAX = 2e-3   # served latents, extractor "jax" vs "numpy", absolute:
                        # the features differ by fp32 round-off (up to 6e-4 in
                        # the log-mel), which the bf16 operand rounding of the
                        # LSTMs can flip into one more bf16 step of h; read
                        # 3.6e-4 to 4.2e-4 (NVIDIA H100 80GB HBM3, 700 W)
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the rate for their operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tfloat32": 495e12}


def log(*parts) -> None:
    print(*parts, flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int, tries: int = 10) -> list:
    """Device time per call of each kind of device event (kernel, copy,
    set) that ``fn`` launches, from torch.profiler over ``iters`` calls:
    ``(name, ms per call, launches per call)``. Each call launches the
    same work, so every kind must have been recorded a whole number of
    times a call. The profiler loses events: most often the first launch
    of a session (19 of 20, in ten sessions in a row, with a warm-up step
    before the recorded one or without), so each session opens with two
    spin kernels that are not counted; at times most or all of a
    session's. A session that misses any of the calls' events is logged
    and taken again half a second later, up to ``tries`` sessions; then
    this raises. No other clock stands in."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.key]
        bad = [f"{e.key[:60]} x{e.count}" for e in events if e.count % iters]
        if events and not bad:
            return [(e.key, e.device_time_total / 1e3 / iters,
                     e.count // iters) for e in events]
        log(f"  torch.profiler recorded {len(events)} kinds of device event "
            f"over {iters} calls, these not a whole number a call: {bad}; "
            f"profiling again")
        time.sleep(0.5)
    raise RuntimeError(f"torch.profiler lost device events in {tries} "
                       f"sessions")


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call: the card's kernel time over ``iters`` calls,
    summed by torch.profiler (``device_events``), so the host's issue time
    between launches is left out (it bounds a call that takes microseconds
    on the card)."""
    return sum(ms for _, ms, _ in device_events(fn, iters))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in (nested) ``objs``, each counted once."""
    seen, total, todo = set(), 0, list(objs)
    while todo:
        o = todo.pop()
        if isinstance(o, torch.Tensor):
            if o.data_ptr() not in seen:
                seen.add(o.data_ptr())
                total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            todo.extend(o)
    return total


def bound(nbytes: float, flops: float, operands: str) -> dict:
    """The least time the card could take: every input read and every output
    written once at the memory rate, or the operations at the peak rate for
    their operand type, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[operands] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


# --------------------------------------------------------------- phase 1


def phase_environment() -> None:
    from pytorch_scalablefhvae_tpu_torch.ops import _build

    log("== phase 1: environment")
    log("gpu:", smi_name_power())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0),
        "count", torch.cuda.device_count())
    try:
        import triton
        log("triton", triton.__version__)
    except ImportError:
        log("triton: not installed")
    log(subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> {lib}")
    report = (lib.parent / "build.log")
    if report.is_file():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas:", line.strip())


# --------------------------------------------------------------- phase 2


def _uniform(g, shape, limit):
    return (torch.rand(shape, generator=g) * 2 - 1) * limit


def _stack(g, d_in):
    """A two-layer stack in the JAX layout, with the model's init scale."""
    cells = []
    for d in (d_in, H):
        w = _uniform(g, (d + H, 4 * H), (6.0 / (d + H + 4 * H)) ** 0.5)
        b = torch.zeros(4 * H)
        b[H:2 * H] = 1.0
        cells.append((w.cuda(), b.cuda()))
    return cells


def cudnn_lstm(cells, d_in: int, dtype) -> torch.nn.LSTM:
    """``torch.nn.LSTM`` (cuDNN) holding a two-layer stack of the JAX
    layout: the gate order i, f, g, o is PyTorch's too; a cell's ``w [d +
    H, 4H]`` splits into ``weight_ih = w[:d].T`` and ``weight_hh =
    w[d:].T``, its ``b`` is ``bias_ih`` and ``bias_hh`` is zero."""
    lstm = torch.nn.LSTM(d_in, H, num_layers=2).cuda()
    with torch.no_grad():
        for layer, (w, b) in enumerate(cells):
            d = d_in if layer == 0 else H
            getattr(lstm, f"weight_ih_l{layer}").copy_(w[:d].T)
            getattr(lstm, f"weight_hh_l{layer}").copy_(w[d:].T)
            getattr(lstm, f"bias_ih_l{layer}").copy_(b)
            getattr(lstm, f"bias_hh_l{layer}").zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()
    return lstm


def library_route(fn) -> tuple[str, list[str]]:
    """Which implementation a ``torch.nn.LSTM`` call ran, from the kernels
    it launched (torch.profiler): PyTorch's own cell loop launches
    ``lstm_cell_forward`` / ``lstm_cell_backward`` kernels, cuDNN does not.
    Returns the route and the call's three longest kernels' names."""
    events = sorted(device_events(fn, 2), key=lambda e: -e[1])
    names = [k for k, _, _ in events]
    route = "aten" if any("lstm_cell_" in k for k in names) else "cudnn"
    return route, [k[:70] for k in names[:3]]


def library_lstm(cells, inp: torch.Tensor, want32, g_out=None) -> dict:
    """One ``torch.nn.LSTM`` call computing an LSTM entry's function on
    ``inp [T, B, d_in]`` (its input and time-constant part joined), checked
    first in fp32 (TF32 off) against the plain fp32 outputs ``want32``,
    then timed (CUDA events) in fp32, bf16 and fp16; ``library_ms`` is the
    fastest half-precision call that ran on cuDNN (fp32's where none did).
    Without ``g_out`` the forward under ``no_grad`` (``want32``: tops, h2;
    max abs error); with ``g_out = (g_tops, g_h2)`` the backward alone,
    ``torch.autograd.grad`` through a kept graph, to the input and every
    weight (``want32``: the plain backward's dw1h, dw2x, dw2h, db2, relative
    Frobenius norm)."""
    def run(lstm, x):
        if g_out is None:
            def forward():
                with torch.no_grad():
                    return lstm(x)
            return forward
        x = x.detach().requires_grad_(True)
        out, (h, _) = lstm(x)
        outs = (out, h[1])
        params = [x, *lstm.parameters()]
        grads = tuple(g.to(x.dtype) for g in g_out)
        return lambda: torch.autograd.grad(outs, params, grads,
                                           retain_graph=True)

    # fp32 products stay fp32 (cuDNN would take TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lstm32 = cudnn_lstm(cells, inp.shape[2], torch.float32)
    call32 = run(lstm32, inp)
    got = call32()
    if g_out is None:
        err = max(max_err(got[0], want32[0]), max_err(got[1][0][1],
                                                       want32[1]))
        tol = TOL_FP32
    else:
        weights = dict(zip(("x", *(n for n, _ in lstm32.named_parameters())),
                           got))
        err = rel_norm([weights["weight_hh_l0"].T, weights["weight_ih_l1"].T,
                        weights["weight_hh_l1"].T, weights["bias_ih_l1"]],
                       want32)
        tol = TOL_BWD_FP32
    if not err <= tol:
        raise AssertionError(f"torch.nn.LSTM in fp32 computes another "
                             f"function: {err} > {tol}")
    ms32 = time_ms(call32)
    route32, kernels32 = library_route(call32)
    res = {"library_ms": ms32, "library_dtype": "float32",
           "library_route": route32, "library_fp32_ms": ms32,
           "library_fp32_err": err,
           "library_by_dtype": {"float32": {"ms": ms32, "route": route32,
                                            "kernels": kernels32}}}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[1]
        try:
            call = run(cudnn_lstm(cells, inp.shape[2], dtype), inp.to(dtype))
            call()
        except RuntimeError as e:
            log(f"  torch.nn.LSTM in {name}: refused ({str(e)[:120]})")
            continue
        ms = time_ms(call)
        route, kernels = library_route(call)
        res["library_by_dtype"][name] = {"ms": ms, "route": route,
                                         "kernels": kernels}
        if route == "cudnn" and (res["library_dtype"] == "float32"
                                 or ms < res["library_ms"]):
            res.update(library_ms=ms, library_dtype=name, library_route=route)
    for name, r in res["library_by_dtype"].items():
        log(f"  torch.nn.LSTM {'backward' if g_out else 'forward'} in "
            f"{name}: {r['ms']:.3f} ms on {r['route']}; longest kernels "
            f"{r['kernels']}")
    return res


def phase_kernels() -> dict:
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda

    log("== phase 2: kernels against their plain versions "
        f"(T={T} B={B} D={D} H={H})")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((T, B, D), generator=g).cuda()
    z2_stack, z1_stack, dec_stack = (_stack(g, D), _stack(g, D + Z),
                                     _stack(g, 2 * Z))
    z = torch.randn((B, Z), generator=g).cuda()
    xgc = z @ z1_stack[0][0][D:D + Z] + z1_stack[0][1]
    zc = torch.randn((B, 2 * Z), generator=g).cuda()
    xg_c = zc @ dec_stack[0][0][:2 * Z] + dec_stack[0][1]
    # torch.nn.LSTM's stack and input for each form: the input and the
    # time-constant part joined at every step
    library_cases = {
        "z2 encoder": (z2_stack, x),
        "z1 encoder, xgc tile": (z1_stack,
                                 torch.cat([x, z.expand(T, B, Z)], -1)),
        "decoder, const": (dec_stack, zc.expand(T, B, 2 * Z).contiguous()),
    }

    def raw(cells, xadd, x_=None):
        """The launchers' arguments: (x, xadd, T, w1x, w1h, w2x, w2h, b2)."""
        (w1, b1), (w2, b2) = cells
        if x_ is None:
            return (None, xadd, T, None, w1[-H:], w2[:H], w2[H:], b2)
        xadd = b1.reshape(1, -1) if xadd is None else xadd
        return (x_, xadd, T, w1[:D], w1[-H:], w2[:H], w2[H:], b2)

    def rows_of(args, lo, n):
        """The same call on batch rows [lo, lo + n)."""
        x_, xadd = args[:2]
        if x_ is not None:
            x_ = x_[:, lo:lo + n].contiguous()
        if xadd.shape[-2] != 1:
            xadd = xadd[..., lo:lo + n, :].contiguous()
        return (x_, xadd, *args[2:])

    # per form: the call, its inputs (for the bytes of the bound), the
    # multiply-adds of its products: per step and row 4H gate columns over a
    # depth of D + H (layer 1; H alone where the input's part is given) and
    # 2H (layer 2), and the launchers' arguments
    cases = {
        "lstm2_tm_proj": {
            "z2 encoder": (lambda fn, mm: fn(z2_stack, x, None, mm),
                           (z2_stack, x), D + 3 * H, raw(z2_stack, None, x)),
            "z1 encoder, xgc tile": (
                lambda fn, mm: fn(z1_stack, x, xgc, mm),
                ([(z1_stack[0][0][:D], z1_stack[0][0][D + Z:]), z1_stack[1]],
                 x, xgc), D + 3 * H, raw(z1_stack, xgc, x)),
        },
        "lstm2_tm": {
            "decoder, const": (
                lambda fn, mm: fn(dec_stack, xg_c, T, mm),
                ([dec_stack[0][0][2 * Z:], dec_stack[1]], xg_c), 3 * H,
                raw(dec_stack, xg_c)),
        },
    }
    results: dict = {}
    for name, forms in cases.items():
        kernel = getattr(lstm_cuda, name)
        plain = getattr(lstm_cuda, name + "_reference")
        for form, (call, inputs, depth, args) in forms.items():
            refs = {mm: call(plain, mm) for mm in ("float32", "bfloat16")}
            gap = max(max_err(a, b) for a, b in zip(refs["float32"],
                                                    refs["bfloat16"]))
            log(f"{name} [{form}]: plain fp32 vs plain bf16 operands differ "
                f"by {gap:.3e}")
            if not gap > TOL_BF16:
                raise AssertionError(
                    f"{name} [{form}]: the bf16 tolerance {TOL_BF16} would "
                    f"pass a kernel that skipped the bf16 rounding "
                    f"(fp32-vs-bf16 gap {gap})")
            ms_by_mode = {}
            for mm, tol in (("float32", TOL_FP32), ("bfloat16", TOL_BF16)):
                before = kernel.launches, kernel.launches_tc
                tops_k, h2_k = call(kernel, mm)
                tops_p, h2_p = refs[mm]
                torch.cuda.synchronize()
                took_tc = kernel.launches_tc - before[1]
                if kernel.launches - before[0] != 1 or took_tc != (
                        mm == "bfloat16"):
                    raise AssertionError(
                        f"{name} [{form}, {mm}]: bf16 operands at H {H} must "
                        f"take the tensor-core form, fp32 operands must not")
                err = max(max_err(tops_k, tops_p), max_err(h2_k, h2_p))
                ms = ms_by_mode[mm] = time_ms(lambda: call(kernel, mm))
                plain_ms = time_ms(lambda: call(plain, mm), iters=5)
                log(f"{name} [{form}, {mm}]: max_abs_err {err:.3e} "
                    f"(tol {tol:g}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
                if not err <= tol:
                    raise AssertionError(
                        f"{name} [{form}, {mm}] disagrees with its plain "
                        f"version: {err} > {tol}")
                if mm != "bfloat16":
                    continue
                # the serving mode
                check_forward_passes(lstm_cuda, name, form, args)
                # the FMA form in bf16 mode (what this call took before the
                # tensor-core form) and the tensor-core form, in turns, each
                # through its own launcher
                fma_out = lstm_cuda._forward_fma(kernel, *args, mm, True,
                                                 False)
                fma_err = max(max_err(fma_out[0], tops_p),
                              max_err(fma_out[1], h2_p))
                log(f"{name} [{form}, bfloat16] FMA form: max_abs_err "
                    f"{fma_err:.3e} (tol {tol:g})")
                if not fma_err <= tol:
                    raise AssertionError(
                        f"{name} [{form}]: the FMA form in bf16 mode "
                        f"disagrees with the plain version: {fma_err} > {tol}")
                turns = [time_ms(lambda: run(kernel, *args, mm, True, False))
                         for run in (lstm_cuda._forward_fma,
                                     lstm_cuda._forward_tc,
                                     lstm_cuda._forward_tc,
                                     lstm_cuda._forward_fma)]
                fma_ms = (turns[0] + turns[3]) / 2
                tc_ms = (turns[1] + turns[2]) / 2
                log(f"{name} [{form}, bfloat16] in turns: FMA form "
                    f"{turns[0]:.3f} / {turns[3]:.3f} ms, tensor-core form "
                    f"{turns[1]:.3f} / {turns[2]:.3f} ms: "
                    f"{fma_ms / tc_ms:.1f}x; fp32 operands (FMA form) "
                    f"{ms_by_mode['float32']:.3f} ms")
                if not (tc_ms < fma_ms and ms <= ms_by_mode["float32"]):
                    raise AssertionError(
                        f"{name} [{form}]: the tensor-core form is no faster "
                        f"than the FMA form in bf16 or than fp32 operands")
                per_pass = {"serving": kernel_times_ms(
                    lambda: call(kernel, mm)), "with residuals":
                    kernel_times_ms(lambda: lstm_cuda._forward_tc(
                        kernel, *args, mm, True, True))}
                for what, rows in per_pass.items():
                    log(f"{name} [{form}, bfloat16, {what}] device time per "
                        f"call by kernel (torch.profiler; ms, launches): "
                        + "; ".join(f"{k} {v[0]:.4f} x{v[1]:g}"
                                    for k, v in rows.items())
                        + f"; sum {sum(v[0] for v in rows.values()):.4f} ms")
                lib = library_lstm(*library_cases[form], refs["float32"])
                log(f"{name} [{form}] torch.nn.LSTM: fp32 (TF32 off) "
                    f"{lib['library_fp32_ms']:.3f} ms, max_abs_err against "
                    f"plain fp32 {lib['library_fp32_err']:.3e} (tol "
                    f"{TOL_FP32:g}); "
                    f"{lib['library_dtype']} {lib['library_ms']:.3f} ms on "
                    f"{lib['library_route']}; the kernel (bf16 operands) "
                    f"{ms:.3f} ms")
                prev = results.get(name)
                if prev is None or ms > prev["ms"]:  # keep the heaviest form
                    results[name] = {"max_abs_err": max(
                        err, prev["max_abs_err"] if prev else 0.0),
                        "ms": ms, "plain_ms": plain_ms, "form": form,
                        "fma_form_ms": fma_ms,
                        "passes_ms": {k: v[0] for k, v in
                                      per_pass["serving"].items()},
                        **bound(tensor_bytes(inputs, tops_k, h2_k),
                                2 * T * B * 4 * H * depth, "bfloat16"),
                        **lib,
                        "library_by_form": {
                            **(prev or {}).get("library_by_form", {}),
                            form: lib}}
                else:
                    prev["max_abs_err"] = max(prev["max_abs_err"], err)
                    prev["library_by_form"][form] = lib

    # other batches through the tensor-core form, with residuals: a ragged
    # one (1000 rows: the last 16-row cluster half empty), the training batch
    # and a mesh rank's (16-row clusters; the serving batch takes 32-row
    # ones), each held to the plain version
    for rows in (1000, B_TRAIN, B_TRAIN // MESH[0]):
        for name, forms in cases.items():
            for form, (_, _, _, args) in forms.items():
                part = rows_of(args, 0, rows)
                want = plain_forward(lstm_cuda, part, "bfloat16")
                got = lstm_cuda._forward_tc(getattr(lstm_cuda, name), *part,
                                            "bfloat16", True, True)
                torch.cuda.synchronize()
                errs = [max_err(a, b) for a, b in zip(got, want)]
                per = lstm_cuda._library(H, "bfloat16") \
                    .sfhvae_lstm2_fwd_cluster_rows(rows)
                log(f"{name} [{form}, bfloat16, B={rows}, {per}-row "
                    f"clusters]: max_abs_err tops {errs[0]:.3e}, h2 "
                    f"{errs[1]:.3e}, resid {errs[2]:.3e} (tol {TOL_BF16:g})")
                if not max(errs) <= TOL_BF16:
                    raise AssertionError(
                        f"{name} [{form}] at B={rows} disagrees with its "
                        f"plain version: {errs}")

    # The limit above is absolute, and the error is not: a bf16 flip of h
    # moves a gate by ulp(h) |w|, and c carries it on, so it grows with the
    # weights and the cells. What does not grow is its share of what the bf16
    # rounding itself does to that output on the same inputs (plain fp32
    # against plain bf16 operands): each of tops, h2, h1, c1, c2 is held to
    # that share on its own, at the model's weight scale and at two and three
    # times it, for both forms (the launchers called directly)
    for scale in (1.0, 2.0, 3.0):
        for name, forms in cases.items():
            entry = getattr(lstm_cuda, name)
            for form, (_, _, _, args) in forms.items():
                x_, xadd, steps, *ws, b2 = rows_of(args, 0, 1000)
                scaled = (x_, xadd, steps,
                          *(None if w is None else scale * w for w in ws), b2)
                want = forward_parts(plain_forward(lstm_cuda, scaled,
                                                   "bfloat16"))
                want32 = forward_parts(plain_forward(lstm_cuda, scaled,
                                                     "float32"))
                for which, run in (("tensor-core", lstm_cuda._forward_tc),
                                   ("FMA", lstm_cuda._forward_fma)):
                    got = forward_parts(run(entry, *scaled, "bfloat16", True,
                                            True))
                    torch.cuda.synchronize()
                    share = {k: (max_err(got[k], want[k]),
                                 max_err(want32[k], want[k])) for k in want}
                    log(f"{name} [{form}, bfloat16, B=1000, weights x "
                        f"{scale:g}, {which} form] max_abs_err / rounding "
                        f"gap: " + ", ".join(
                            f"{k} {e:.2e} / {gp:.2e} = {e / gp:.3f}"
                            for k, (e, gp) in share.items())
                        + f" (limit {TOL_BF16_OF_GAP:g} each)")
                    if not all(e <= TOL_BF16_OF_GAP * gp
                               for e, gp in share.values()):
                        raise AssertionError(
                            f"{name} [{form}, {which} form] at weights x "
                            f"{scale:g}: an output errs by more than "
                            f"{TOL_BF16_OF_GAP} of the rounding gap: {share}")

    # a batch split in two: a row's values must not depend on the rows it
    # shares a tile with, nor on the tile height (2048 rows take 32-row
    # clusters, 1024 and 512 rows 16-row ones)
    for rows in (B, B_TRAIN):
        half = rows // 2
        for name, forms in cases.items():
            for form, (_, _, _, args) in forms.items():
                entry = getattr(lstm_cuda, name)
                whole = lstm_cuda._forward_tc(
                    entry, *rows_of(args, 0, rows), "bfloat16", True, True)
                parts = [lstm_cuda._forward_tc(
                    entry, *rows_of(args, lo, half), "bfloat16", True, True)
                    for lo in (0, half)]
                torch.cuda.synchronize()
                equal = all(torch.equal(w, torch.cat([a, b], dim=-2))
                            for w, a, b in zip(whole, *parts))
                log(f"{name} [{form}, bfloat16] B {rows} against 2 x {half} "
                    f"rows: tops, h2 and resid equal bit for bit per row: "
                    f"{equal}")
                if not equal:
                    raise AssertionError(f"{name} [{form}]: the forward "
                                         f"depends on the batch split")

    # the chain alone (the decoder entry's call with residuals, random
    # per-step gates, zero weights): whole, without its global traffic (the
    # floor of the dependent phases: products, cells, exchange, barrier),
    # without the products too; at one step the prologue and one phase remain
    for rows in (B, B_TRAIN):
        chain = {}
        for what, probe in (("whole", 0), ("no global traffic", 1),
                            ("cells, exchange and barrier alone", 3)):
            for steps in (T, 1):
                chain[f"{what}, T {steps}"] = device_ms(
                    lstm_cuda.fwd_chain_probe(steps, rows, probe), iters=20)
        log(f"lstm2_fwd chain alone at B {rows} (device time by "
            f"torch.profiler, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in chain.items()))
        if rows == B:
            for name in cases:
                results[name]["chain_floor_ms"] = \
                    chain[f"no global traffic, T {T}"]
    return results


def phase_disc_forward() -> dict:
    """The discriminative forward (kernel #5) against its plain version at
    the serving batch (2048 rows) and the training batch (1024) on the served
    table (4,620 rows) and a LibriSpeech-scale one, with 7 padded rows and an
    index outside the table: error of ``log_qy`` and ``lse``, two launches
    and the batch split in two (equal bit for bit per row), one launch
    counted per call; device time per kernel (torch.profiler), the calls back
    to back (CUDA events), the plain version and the bound. Every shape is
    measured and logged before the checks raise."""
    from pytorch_scalablefhvae_tpu_torch.ops.discriminative import (
        _forward_kernel,
        _forward_plain,
        discriminative_log_qy,
        fwd_probe,
    )

    log("== phase 2f: the discriminative forward (kernel #5)")
    g = torch.Generator().manual_seed(5)
    pz2_logvar = float(np.log(0.5 ** 2))
    results: dict = {}
    by_shape: dict = {}
    failed = []
    for n in (N_TABLE, N_LARGE):
        num_real = n - 7                     # 7 padded rows
        mu2 = torch.randn((n, Z), generator=g)
        seq = torch.randint(0, num_real, (B,), generator=g)
        # z2 near its own sequence's mu2, as a trained encoder puts it
        z2 = (mu2[seq] + 0.5 * torch.randn((B, Z), generator=g)).cuda()
        seq[5] = n + 3                       # an index outside the table
        mu2, seq = mu2.cuda(), seq.cuda()
        for rows in (B, B_TRAIN):
            z, s = z2[:rows].contiguous(), seq[:rows].contiguous()

            def kernel(z=z, s=s):
                return _forward_kernel(z, mu2, s, pz2_logvar, num_real, True)

            before = discriminative_log_qy.launches
            got = kernel()
            counted = discriminative_log_qy.launches - before
            again = kernel()
            want = _forward_plain(z, mu2, s, pz2_logvar, num_real)
            half = rows // 2
            split = [_forward_kernel(z[lo:lo + half].contiguous(), mu2,
                                     s[lo:lo + half].contiguous(), pz2_logvar,
                                     num_real, True) for lo in (0, half)]
            torch.cuda.synchronize()
            err, lse_err = (max_err(a, b) for a, b in zip(got, want))
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            split_equal = all(torch.equal(torch.cat([p[i] for p in split]),
                                          got[i]) for i in (0, 1))
            passes = kernel_times_ms(kernel, iters=20)
            ms = sum(v[0] for v in passes.values())
            events_ms = time_ms(kernel)
            plain_ms = time_ms(lambda z=z, s=s: _forward_plain(
                z, mu2, s, pz2_logvar, num_real), iters=5)
            # B x N squared distances over Z (a subtract and a multiply-add
            # each, counted as 2 * B * N * Z), fp32 outside the tensor cores
            bnd = bound(tensor_bytes(z, mu2, s, got), 2 * rows * n * Z,
                        "float32")
            log(f"discriminative_log_qy [N={n}, B={rows}, 7 padded rows, 1 "
                f"index outside]: max_abs_err log_qy {err:.3e}, lse "
                f"{lse_err:.3e} (tol {TOL_LOG_QY:g}); bitwise repeat: "
                f"{repeat}; B {rows} against 2 x {half} rows, log_qy and lse "
                f"equal bit for bit: {split_equal}; launches counted per "
                f"call: {counted}; device time {ms:.4f} ms (torch.profiler; "
                f"by kernel: " + "; ".join(f"{k} {v[0]:.4f} x{v[1]:g}"
                                          for k, v in passes.items())
                + f"), back to back {events_ms:.4f} ms (CUDA events), plain "
                f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms by "
                f"{bnd['bound_by']}")
            if not (torch.isfinite(got[0]).all() and err <= TOL_LOG_QY
                    and lse_err <= TOL_LOG_QY and repeat and split_equal
                    and counted == 1):
                failed.append(f"N={n}, B={rows}")
            by_shape[f"N={n}, B={rows}"] = {
                "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
                "bound_ms": bnd["bound_ms"],
                "passes_ms": {k: v[0] for k, v in passes.items()}}
            if n == N_LARGE and rows == B:
                # what bounds the partials pass: the same launch with its
                # exps or its cross terms left out
                probes = {what: device_ms(fwd_probe(
                    z, mu2, s, pz2_logvar, num_real, probe), iters=10)
                    for what, probe in (("whole", 0), ("without the exps", 1),
                                        ("without the cross terms", 2))}
                log(f"discriminative_log_qy [N={n}, B={rows}] partials pass "
                    f"alone (device time by torch.profiler, ms): "
                    + ", ".join(f"{k} {v:.4f}" for k, v in probes.items()))
                by_shape[f"N={n}, B={rows}"]["partials_probe_ms"] = probes
            prev = results.get("discriminative_log_qy")
            if prev is None:  # the served experiment's table and batch
                results["discriminative_log_qy"] = {
                    "max_abs_err": err, "ms": ms, "events_ms": events_ms,
                    "plain_ms": plain_ms, "form": f"N={n}, B={rows}",
                    "passes_ms": by_shape[f"N={n}, B={rows}"]["passes_ms"],
                    **bnd}
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"], err)
            del got, again, want, split
        del mu2, z2
        torch.cuda.empty_cache()
    results["discriminative_log_qy"]["by_shape"] = by_shape
    if failed:
        raise AssertionError(
            f"discriminative_log_qy disagrees with its plain version, differs "
            f"between two launches or on a batch split, or was not counted "
            f"once per call at {failed}")
    return results


def rel_norm(got, want) -> float:
    """Largest relative Frobenius-norm difference over paired outputs."""
    return max(float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))
               for a, b in zip(got, want) if b is not None)


def abs_err(got, want) -> float:
    return max(max_err(a, b) for a, b in zip(got, want) if b is not None)


def rel_norms(got, want) -> list[float]:
    """Relative Frobenius-norm difference of each paired output."""
    return [rel_norm([a], [b]) for a, b in zip(got, want) if b is not None]


def kernel_times_ms(fn, iters: int = 10) -> dict:
    """Device time per call of each kernel ``fn`` launches (torch.profiler,
    ``device_events``), by kernel name, largest first."""
    rows: dict = {}
    for key, ms_call, per_call in device_events(fn, iters):
        if ms_call > 0:
            found = re.search(r"\w+_kernel", key)
            name = found.group(0) if found else key[:40]
            ms, n = rows.get(name, (0.0, 0))
            rows[name] = (ms + ms_call, n + per_call)
    return dict(sorted(rows.items(), key=lambda kv: -kv[1][0]))


def plain_forward(lstm_cuda, args, mm):
    """The plain forward with residuals on a launcher's arguments."""
    x_, xadd, steps, w1x, *rest = args
    if x_ is None:
        return lstm_cuda._tm_forward_plain(xadd, steps, *rest, mm,
                                           with_resid=True)
    return lstm_cuda._proj_forward_plain(x_, xadd, w1x, *rest, mm,
                                         with_resid=True)


def forward_parts(out) -> dict:
    """(tops, h2, resid) of a forward with residuals, each part by name."""
    tops, h2, resid = out
    h1, c1, c2 = resid.split(H, dim=-1)
    return {"tops": tops, "h2": h2, "h1": h1, "c1": c1, "c2": c2}


def check_forward_passes(lstm_cuda, name, form, args) -> None:
    """The tensor-core forward pass by pass against the plain forward in the
    same pass structure: the layer-1 gates after pass A (fp32; only the sum
    order differs), tops, h2 and the residuals after the chain; two launches
    compared bitwise."""
    entry = getattr(lstm_cuda, name)
    streams: dict = {}
    got = lstm_cuda._forward_kernel(entry, *args, "bfloat16", True, True,
                                    streams)
    again = lstm_cuda._forward_kernel(entry, *args, "bfloat16", True, True)
    want, want_streams = lstm_cuda.lstm2_fwd_passes_reference(*args,
                                                              "bfloat16")
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} [{form}]: two launches differ")
    xp_err = 0.0
    if args[0] is not None:
        xp_err = rel_norm([streams["xp"]], [want_streams["xp"]])
    errs = [max_err(a, b) for a, b in zip(got, want)]
    log(f"{name} [{form}, bfloat16] pass by pass: layer-1 gates after pass A "
        f"rel-norm err {xp_err:.3e} (tol {TOL_FP32:g}); after the chain "
        f"max_abs_err tops {errs[0]:.3e}, h2 {errs[1]:.3e}, resid "
        f"{errs[2]:.3e} (tol {TOL_BF16:g}); bitwise repeat ok")
    if not (xp_err <= TOL_FP32 and max(errs) <= TOL_BF16):
        raise AssertionError(f"{name} [{form}]: a pass disagrees with the "
                             f"plain pass: {xp_err}, {errs}")


def check_passes(lstm_cuda, name, form, run, passes_args, tol) -> None:
    """The tensor-core backward pass by pass against the plain backward in
    the same pass structure: the gates after pass A (fp32; only the sum order
    differs), the bf16 dgates streams after pass B against the plain dgates
    rounded to bf16."""
    streams: dict = {}
    run(lstm_cuda.__dict__[name], "bfloat16", streams=streams)
    _, want = lstm_cuda.lstm2_bwd_passes_reference(*passes_args, "bfloat16")
    torch.cuda.synchronize()
    errs = {}
    for key, limit in (("gates1", TOL_BWD_FP32), ("gates2", TOL_BWD_FP32),
                       ("dgates1", tol), ("dgates2", tol)):
        w = want[key]
        if key.startswith("d"):
            w = w.to(torch.bfloat16).float()
        errs[key] = rel_norm([streams[key]], [w])
        if not errs[key] <= limit:
            raise AssertionError(f"{name} [{form}]: stream {key} disagrees "
                                 f"with the plain pass: {errs[key]} > {limit}")
    log(f"{name} [{form}, bfloat16] pass by pass, rel-norm err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (gates tol {TOL_BWD_FP32:g}, dgates tol {tol:g})")


def phase_backward() -> dict:
    """The three backward entries against their plain backward on the card,
    at the training shapes, on the same residuals (from the plain forward)
    and cotangents; two launches compared bitwise."""
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda
    from pytorch_scalablefhvae_tpu_torch.ops.discriminative import (
        _forward_plain,
        discriminative_log_qy_bwd,
        discriminative_log_qy_bwd_reference,
    )

    log(f"== phase 2b: backward kernels against their plain versions "
        f"(T={T} B={B_TRAIN} D={D} H={H})")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((T, B_TRAIN, D), generator=g).cuda()
    z2_stack, z1_stack, dec_stack = (_stack(g, D), _stack(g, D + Z),
                                     _stack(g, 2 * Z))
    z = torch.randn((B_TRAIN, Z), generator=g).cuda()
    xgc = z @ z1_stack[0][0][D:D + Z] + z1_stack[0][1]
    zc = torch.randn((B_TRAIN, 2 * Z), generator=g).cuda()
    xg_c = zc @ dec_stack[0][0][:2 * Z] + dec_stack[0][1]
    g_tops = torch.randn((T, B_TRAIN, H), generator=g).cuda()
    g_h2 = torch.randn((B_TRAIN, H), generator=g).cuda()
    library_cases = {  # as in phase 2
        "z2 encoder": (z2_stack, x),
        "z1 encoder, xgc tile": (
            z1_stack, torch.cat([x, z.expand(T, B_TRAIN, Z)], -1)),
        "decoder, const": (dec_stack,
                           zc.expand(T, B_TRAIN, 2 * Z).contiguous()),
    }

    def split(cells):
        (w1, b1), (w2, b2) = cells
        return w1, b1, w1[-H:], w2[:H], w2[H:], b2

    def proj_case(cells, xgc_, rows=B_TRAIN, lo=0):
        w1, b1, w1h, w2x, w2h, b2 = split(cells)
        sl = slice(lo, lo + rows)
        xgc_ = b1.reshape(1, -1) if xgc_ is None else xgc_[sl]
        x_, gt, gh = x[:, sl].contiguous(), \
            g_tops[:, sl].contiguous(), g_h2[sl]
        fwd_in = (x_, xgc_, w1[:D], w1h, w2x, w2h, b2)

        def run(fn, mm, resid, **kw):
            tops, res = resid
            return fn(x_, xgc_, res, tops, *fwd_in[2:], gt, gh, mm, **kw)

        def passes_args(resid):
            tops, res = resid
            return (x_, xgc_, T, res, tops, *fwd_in[2:], gt, gh)
        # multiply-adds per step, row and gate column: the gates recomputed
        # (D + 3H deep), the adjoints through W2x, W2h, W1h (3H), the four
        # weight gradients (D + 3H) and dx (D)
        return (fwd_in, lstm_cuda._proj_forward_plain, run, 3 * D + 9 * H,
                passes_args)

    def dec_case(cells, rows=B_TRAIN, lo=0):
        w1, b1, w1h, w2x, w2h, b2 = split(cells)
        sl = slice(lo, lo + rows)
        xg_, gt, gh = xg_c[sl], g_tops[:, sl].contiguous(), g_h2[sl]
        fwd_in = (xg_, T, w1h, w2x, w2h, b2)

        def run(fn, mm, resid, **kw):
            tops, res = resid
            return fn(xg_, T, res, tops, w1h, w2x, w2h, b2, gt, gh, mm, **kw)

        def passes_args(resid):
            tops, res = resid
            return (None, xg_, T, res, tops, None, w1h, w2x, w2h, b2, gt, gh)
        # as above without an input product: 3H recomputed, 3H adjoints, 3H
        # of weight gradients
        return fwd_in, lstm_cuda._tm_forward_plain, run, 9 * H, passes_args

    def fma_form(entry):
        """The entry's signature on the FMA form's launcher."""
        lib = lstm_cuda._library(H, "bfloat16")
        if entry is lstm_cuda.lstm2_tm_proj_bwd:
            def fn(x_, xgc_, res, tops, w1x, w1h, w2x, w2h, b2, gt, gh, mm):
                return lstm_cuda._backward_fma(
                    lib, entry, x_, xgc_, T, x_.shape[1], D, H, res, tops,
                    w1x, w1h, w2x, w2h, b2, gt, gh, mm, True, None)
        else:
            def fn(xg_, steps, res, tops, w1h, w2x, w2h, b2, gt, gh, mm):
                out = lstm_cuda._backward_fma(
                    lib, entry, None, xg_, steps, xg_.shape[0], 0, H, res,
                    tops, None, w1h, w2x, w2h, b2, gt, gh, mm, False, None)
                return (out[1], *out[3:])
        return fn

    cases = {
        "lstm2_tm_proj_bwd": {"z2 encoder": proj_case(z2_stack, None),
                              "z1 encoder, xgc tile": proj_case(z1_stack,
                                                                xgc)},
        "lstm2_tm_bwd": {"decoder, const": dec_case(dec_stack)},
    }
    results: dict = {}
    for name, forms in cases.items():
        kernel = getattr(lstm_cuda, name)
        plain = getattr(lstm_cuda, name + "_reference")
        for form, (fwd_in, fwd_plain, run, depth, passes_args) in \
                forms.items():
            ms_by_mode = {}
            for mm, tol in (("float32", TOL_BWD_FP32),
                            ("bfloat16", TOL_BWD_BF16)):
                tops, _, res = fwd_plain(*fwd_in, mm, with_resid=True)
                resid = (tops, res)
                want = run(plain, mm, resid)
                if mm == "float32":
                    want32 = want
                before = kernel.launches, kernel.launches_tc
                got = run(kernel, mm, resid)
                again = run(kernel, mm, resid)
                torch.cuda.synchronize()
                took_tc = kernel.launches_tc - before[1]
                if kernel.launches - before[0] != 2 or took_tc != (
                        2 if mm == "bfloat16" else 0):
                    raise AssertionError(
                        f"{name} [{form}, {mm}]: {took_tc} of 2 launches took "
                        f"the tensor-core form; bf16 operands at H {H} must, "
                        f"fp32 operands must not")
                if not all(torch.equal(a, b) for a, b in zip(got, again)
                           if a is not None):
                    raise AssertionError(f"{name} [{form}, {mm}]: two "
                                         f"launches differ")
                err, aerr = rel_norm(got, want), abs_err(got, want)
                each = ", ".join(f"{e:.2e}" for e in rel_norms(got, want))
                gap = ""
                if mm == "bfloat16":
                    gap32 = rel_norm(run(plain, "float32", resid), want)
                    gap = f"; plain fp32 vs bf16 backward gap {gap32:.3e}"
                    if not gap32 > tol:
                        raise AssertionError(
                            f"{name} [{form}]: the bf16 tolerance {tol} "
                            f"would pass a kernel that rounded elsewhere "
                            f"(gap {gap32})")
                ms = ms_by_mode[mm] = time_ms(lambda: run(kernel, mm, resid))
                plain_ms = time_ms(lambda: run(plain, mm, resid), iters=3,
                                   warmup=1)
                log(f"{name} [{form}, {mm}]: rel-norm err {err:.3e} (tol "
                    f"{tol:g}; per output {each}), max_abs_err {aerr:.3e}"
                    f"{gap}; bitwise repeat ok; kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms")
                if not max(err, *rel_norms(got, want)) <= tol:
                    raise AssertionError(
                        f"{name} [{form}, {mm}] disagrees with its plain "
                        f"backward in an output: {each} > {tol}")
                if mm != "bfloat16":
                    continue
                # the FMA form in bf16 mode (what bf16 operands take at other
                # widths), through its launcher, against the same plain
                # backward
                each_fma = rel_norms(run(fma_form(kernel), mm, resid), want)
                log(f"{name} [{form}, bfloat16, FMA form]: rel-norm err per "
                    f"output " + ", ".join(f"{e:.2e}" for e in each_fma)
                    + f" (tol {tol:g} each)")
                if not max(each_fma) <= tol:
                    raise AssertionError(
                        f"{name} [{form}]: the FMA form in bf16 mode "
                        f"disagrees with its plain backward: {each_fma}")
                # the training mode
                check_passes(lstm_cuda, name, form,
                             lambda fn, mm_, **kw: run(fn, mm_, resid, **kw),
                             passes_args(resid), tol)
                log(f"{name} [{form}]: bf16 operands (tensor-core form) "
                    f"{ms:.3f} ms, fp32 operands (FMA form) "
                    f"{ms_by_mode['float32']:.3f} ms")
                if not ms <= ms_by_mode["float32"]:
                    raise AssertionError(
                        f"{name} [{form}]: the tensor-core form is no faster "
                        f"than fp32 operands through the FMA form")
                per_pass = kernel_times_ms(lambda: run(kernel, mm, resid))
                log(f"{name} [{form}, bfloat16] device time per call by "
                    f"kernel (torch.profiler; ms, launches): "
                    + "; ".join(f"{k} {v[0]:.4f} x{v[1]:g}"
                                for k, v in per_pass.items())
                    + f"; sum {sum(v[0] for v in per_pass.values()):.4f} ms "
                    f"against {ms:.3f} ms by CUDA events")
                lib = library_lstm(*library_cases[form], want32[-4:],
                                   g_out=(g_tops, g_h2))
                log(f"{name} [{form}] torch.nn.LSTM backward (autograd, "
                    f"to the input and every weight): fp32 (TF32 off) "
                    f"{lib['library_fp32_ms']:.3f} ms, dw1h, dw2x, dw2h, db2 "
                    f"against plain fp32 {lib['library_fp32_err']:.3e} "
                    f"(tol {TOL_BWD_FP32:g}); {lib['library_dtype']} "
                    f"{lib['library_ms']:.3f} ms on {lib['library_route']}; "
                    f"the kernel (bf16 operands) {ms:.3f} ms")
                prev = results.get(name)
                if prev is None or ms > prev["ms"]:  # keep the heaviest form
                    results[name] = {"max_abs_err": max(
                        aerr, prev["max_abs_err"] if prev else 0.0),
                        "ms": ms, "plain_ms": plain_ms, "form": form,
                        "passes_ms": {k: v[0] for k, v in per_pass.items()},
                        **bound(tensor_bytes(fwd_in, resid, g_tops, g_h2,
                                             got),
                                2 * T * B_TRAIN * 4 * H * depth,
                                "bfloat16"),
                        **lib,
                        "library_by_form": {
                            **(prev or {}).get("library_by_form", {}),
                            form: lib}}
                else:
                    prev["max_abs_err"] = max(prev["max_abs_err"], aerr)
                    prev["library_by_form"][form] = lib
            torch.cuda.empty_cache()

    # other batches, each output held to the tolerance on its own: a ragged
    # one (1000 rows, the last cluster of the chain half empty), and a mesh
    # rank's (512 rows: a 1024-row chunk of the weight gradients spans two
    # steps, and the gates kernel has fewer row tiles than blocks it could
    # fill)
    for rows in (1000, B_TRAIN // MESH[0]):
        others = {"lstm2_tm_proj_bwd": {
                      "z2 encoder": proj_case(z2_stack, None, rows=rows),
                      "z1 encoder, xgc tile": proj_case(z1_stack, xgc,
                                                        rows=rows)},
                  "lstm2_tm_bwd": {
                      "decoder, const": dec_case(dec_stack, rows=rows)}}
        for name, forms in others.items():
            kernel = getattr(lstm_cuda, name)
            for form, (fwd_in, fwd_plain, run, _, _) in forms.items():
                tops, _, res = fwd_plain(*fwd_in, "bfloat16", with_resid=True)
                want = run(getattr(lstm_cuda, name + "_reference"),
                           "bfloat16", (tops, res))
                before = kernel.launches_tc
                got = run(kernel, "bfloat16", (tops, res))
                torch.cuda.synchronize()
                each = rel_norms(got, want)
                log(f"{name} [{form}, bfloat16, B={rows}]: rel-norm err per "
                    f"output " + ", ".join(f"{e:.2e}" for e in each)
                    + f" (tol {TOL_BWD_BF16:g} each)")
                if not (max(each) <= TOL_BWD_BF16
                        and kernel.launches_tc == before + 1):
                    raise AssertionError(
                        f"{name} [{form}] at B={rows} disagrees with its "
                        f"plain backward in an output or left the "
                        f"tensor-core form: {each}")

    # a batch split over two data-parallel ranks: on the same residuals, the
    # outputs that hold a row per batch row must not depend on the split bit
    # for bit, and the outputs summed over rows only by fp32 sum order
    half = B_TRAIN // MESH[0]
    makers = {
        "lstm2_tm_proj_bwd [z2 encoder]":
            lambda **kw: proj_case(z2_stack, None, **kw),
        "lstm2_tm_proj_bwd [z1 encoder, xgc tile]":
            lambda **kw: proj_case(z1_stack, xgc, **kw),
        "lstm2_tm_bwd [decoder, const]":
            lambda **kw: dec_case(dec_stack, **kw)}
    for label, make in makers.items():
        kernel = getattr(lstm_cuda, label.split()[0])
        fwd_in, fwd_plain, run, _, _ = make()
        # bf16 operands take the tensor-core form, fp32 operands the FMA form
        for mm, which in (("bfloat16", "tensor-core"), ("float32", "FMA")):
            tops, _, res = fwd_plain(*fwd_in, mm, with_resid=True)
            full = run(kernel, mm, (tops, res))
            parts = [make(rows=half, lo=lo)[2](
                kernel, mm, (tops[:, lo:lo + half].contiguous(),
                             res[:, lo:lo + half].contiguous()))
                for lo in range(0, B_TRAIN, half)]
            torch.cuda.synchronize()
            rows_equal, sums = True, []
            for f, *ps in zip(full, *parts):
                if f is None:
                    continue
                if ps[0].shape == f.shape:
                    sums.append(rel_norm([sum(ps)], [f]))
                else:
                    dim = [a != b for a, b in zip(ps[0].shape,
                                                  f.shape)].index(True)
                    rows_equal &= torch.equal(torch.cat(ps, dim), f)
            log(f"{label}, {mm}, {which} form, B {B_TRAIN} against "
                f"{MESH[0]} x {half} rows: per-row outputs equal bit for "
                f"bit: {rows_equal}; summed outputs, rel-norm difference "
                + ", ".join(f"{e:.2e}" for e in sums)
                + f" (tol {TOL_BWD_FP32:g})")
            if not (rows_equal and max(sums) <= TOL_BWD_FP32):
                raise AssertionError(f"{label} [{which}]: the backward "
                                     f"depends on the batch split")

    # the reverse-time chain alone (pass B at B 1024): whole, without its
    # global traffic (the floor of the dependent steps: cell adjoints,
    # exchange, barriers, products), without the products too
    chain = {}
    for what, probe in (("whole", 0), ("no global traffic", 1),
                        ("cell adjoints, exchange and barriers alone", 3)):
        for steps in (T, 1):
            chain[f"{what}, T {steps}"] = device_ms(
                lstm_cuda.chain_probe(steps, B_TRAIN, probe), iters=20)
    log(f"lstm2_bwd chain (pass B) alone at B {B_TRAIN}, random gates "
        f"(device time by torch.profiler, ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in chain.items()))
    chain["no global traffic"] = chain[f"no global traffic, T {T}"]
    for name in ("lstm2_tm_proj_bwd", "lstm2_tm_bwd"):
        results[name]["chain_floor_ms"] = chain["no global traffic"]

    pz2_logvar = float(np.log(0.5 ** 2))
    for n in (N_TABLE, N_LARGE):
        num_real = n - 7                     # 7 padded rows
        mu2 = torch.randn((n, Z), generator=g)
        seq = torch.randint(0, num_real, (B_TRAIN,), generator=g)
        z2 = (mu2[seq] + 0.5 * torch.randn((B_TRAIN, Z), generator=g)).cuda()
        seq[5] = n + 3                       # an index outside the table
        mu2, seq = mu2.cuda(), seq.cuda()
        gq = torch.randn((B_TRAIN,), generator=g).cuda()
        _, lse = _forward_plain(z2, mu2, seq, pz2_logvar, num_real)
        args = (z2, mu2, seq, lse, gq, pz2_logvar, num_real)
        want = discriminative_log_qy_bwd_reference(*args)
        got = discriminative_log_qy_bwd(*args)
        again = discriminative_log_qy_bwd(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"discriminative_log_qy_bwd at N={n}: two "
                                 f"launches differ")
        err = max(max_err(a, b) / float(b.abs().max()) for a, b in
                  zip(got, want))
        aerr = abs_err(got, want)
        padded_zero = bool((got[1][num_real:] == 0).all()
                           and (want[1][num_real:] == 0).all())
        # dz2 rows do not depend on the batch split (the table's chunks
        # follow N alone): 1024 rows against 2 x 512, bit for bit
        half = B_TRAIN // MESH[0]
        parts = [[t[lo:lo + half].contiguous() for t in (z2, seq, lse, gq)]
                 for lo in range(0, B_TRAIN, half)]
        split = torch.cat([discriminative_log_qy_bwd(
            z, mu2, s, ls, gg, pz2_logvar, num_real)[0]
            for z, s, ls, gg in parts])
        split_equal = torch.equal(split, got[0])
        ms = time_ms(lambda: discriminative_log_qy_bwd(*args))
        plain_ms = time_ms(lambda: discriminative_log_qy_bwd_reference(*args),
                           iters=3, warmup=1)
        passes = kernel_times_ms(lambda: discriminative_log_qy_bwd(*args))
        # the logits recomputed, then dz2 and dmu2: three B x N x Z passes
        # of multiply-adds, fp32
        bnd = bound(tensor_bytes(args, got), 6 * B_TRAIN * n * Z, "float32")
        log(f"discriminative_log_qy_bwd [N={n}, 7 padded rows, 1 index "
            f"outside]: max err / max |ref| {err:.3e} (tol "
            f"{TOL_LOG_QY_BWD:g}), max_abs_err {aerr:.3e}, padded rows "
            f"exactly 0: {padded_zero}; bitwise repeat ok; dz2 of B "
            f"{B_TRAIN} against {MESH[0]} x {half} rows equal bit for bit: "
            f"{split_equal}; kernel {ms:.4f} ms (CUDA events), plain "
            f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms by "
            f"{bnd['bound_by']}; device time per call by kernel "
            f"(torch.profiler; ms, launches): "
            + "; ".join(f"{k} {v[0]:.4f} x{v[1]:g}" for k, v in passes.items()))
        if not (err <= TOL_LOG_QY_BWD and padded_zero and split_equal):
            raise AssertionError(
                f"discriminative_log_qy_bwd at N={n} disagrees with its plain "
                f"backward: {err} > {TOL_LOG_QY_BWD}, padded rows nonzero or "
                f"dz2 rows depend on the batch split")
        if n == N_TABLE:
            results["discriminative_log_qy_bwd"] = {
                "max_abs_err": aerr, "ms": ms, "plain_ms": plain_ms,
                "form": f"N={n}",
                "passes_ms": {k: v[0] for k, v in passes.items()}, **bnd}
        else:
            r = results["discriminative_log_qy_bwd"]
            r["max_abs_err"] = max(r["max_abs_err"], aerr)
        del mu2, want, got, again, parts, split
        torch.cuda.empty_cache()
    return results


def phase_gather() -> dict:
    """``windowed_chunk_gather`` against its plain version: one dev MAP
    batch (2048 windows in 128 chunks) on two stores; the last two chunks
    are the last sequence's (150 frames), the second of which runs into the
    staged slack and must read zeros there."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        STORE_TAIL_SLACK,
    )
    from pytorch_scalablefhvae_tpu_torch.ops.window_gather import (
        windowed_chunk_gather,
        windowed_chunk_gather_reference,
    )

    log(f"== phase 2c: windowed_chunk_gather against its plain version "
        f"(C=128 spb={SPB} seg_len={SEG} stride={SHIFT} D={D})")
    region = (SPB - 1) * SHIFT + SEG
    gen = torch.Generator(device="cuda").manual_seed(2)
    results: dict = {}
    for form, frames in (("100,000-row store", 100_000),
                         ("TIMIT-train-size store", TIMIT_FRAMES)):
        store = torch.zeros((frames + STORE_TAIL_SLACK, D), device="cuda")
        store[:frames] = torch.randn((frames, D), generator=gen,
                                     device="cuda")
        last = frames - 150
        starts = torch.cat([
            torch.randint(0, frames - region, (126,), generator=gen,
                          device="cuda").sort().values,
            torch.tensor([last, last + SPB * SHIFT], device="cuda")])

        def kernel():
            return windowed_chunk_gather(store, starts, SPB, SEG, SHIFT)

        def plain():
            return windowed_chunk_gather_reference(store, starts, SPB, SEG,
                                                   SHIFT)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = max_err(got, want)
        # windows 3.. of the last chunk start past the frames: all slack
        slack_zero = bool((got[-SPB + 3:] == 0).all())
        if not (torch.equal(got, want) and torch.equal(got, again)
                and slack_zero):
            raise AssertionError(
                f"windowed_chunk_gather [{form}] differs from its plain "
                f"version or between launches (max_abs_err {err}), or read "
                f"nonzero slack ({slack_zero})")
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        call_ms = time_ms(kernel, iters=100, warmup=5)
        plain_call_ms = time_ms(plain, iters=20)
        moved = 128 * (region + SPB * SEG) * D * 4
        # the one PyTorch call for the same function: a row gather by a
        # ready-made index (used nowhere in the port; it reads every window
        # row from the store again, and rows outside the store would need a
        # mask besides)
        idx = (starts[:, None, None]
               + SHIFT * torch.arange(SPB, device="cuda")[None, :, None]
               + torch.arange(SEG, device="cuda")[None, None, :]).reshape(-1)
        library_ms = device_ms(lambda: torch.index_select(store, 0, idx))
        log(f"windowed_chunk_gather [{form}]: equal to the plain version and "
            f"between two launches; slack rows read 0; device time per call "
            f"(profiler) kernel {ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s of "
            f"{moved / 1e6:.1f} MB read + written), plain {plain_ms:.4f} ms; "
            f"per call back to back (CUDA events, host issue included) "
            f"kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; "
            f"torch.index_select by a ready index {library_ms:.4f} ms")
        if not results:  # the dev MAP shape the report line keeps
            results["windowed_chunk_gather"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "form": f"C=128, {form}",
                **bound(moved + starts.numel() * 8, 0, "float32"),
                "library_ms": library_ms}
        if form.startswith("100,000"):
            results["windowed_chunk_gather"]["by_dtype"] = {
                "bfloat16": gather_bf16(store, starts)}
        del store, got, again, want
        torch.cuda.empty_cache()
    return results


def gather_bf16(store32, starts) -> dict:
    """``windowed_chunk_gather`` on the same store staged in bfloat16 (the
    dev split at ``--transfer-dtype bfloat16``): equal to its plain version
    bit for bit and between two launches, one ``launches_bf16`` counted a
    launch; its time beside plain and ``index_select``, its bound by bytes
    at 2 bytes an element."""
    from pytorch_scalablefhvae_tpu_torch.ops.window_gather import (
        windowed_chunk_gather,
        windowed_chunk_gather_reference,
    )

    store = store32.to(torch.bfloat16)
    region = (SPB - 1) * SHIFT + SEG

    def kernel():
        return windowed_chunk_gather(store, starts, SPB, SEG, SHIFT)

    def plain():
        return windowed_chunk_gather_reference(store, starts, SPB, SEG, SHIFT)

    before = windowed_chunk_gather.launches_bf16
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    counted = windowed_chunk_gather.launches_bf16 - before
    bits = got.view(torch.int16), want.view(torch.int16)
    if not (got.dtype == torch.bfloat16 and torch.equal(*bits)
            and torch.equal(got, again) and counted == 2):
        raise AssertionError(
            f"windowed_chunk_gather on bfloat16 rows differs from its plain "
            f"version or between launches, or counted {counted} of 2 "
            f"launches_bf16")
    err = max_err(got.float(), want.float())
    ms, plain_ms = device_ms(kernel), device_ms(plain)
    idx = (starts[:, None, None]
           + SHIFT * torch.arange(SPB, device="cuda")[None, :, None]
           + torch.arange(SEG, device="cuda")[None, None, :]).reshape(-1)
    library_ms = device_ms(lambda: torch.index_select(store, 0, idx))
    moved = 128 * (region + SPB * SEG) * D * 2
    log(f"windowed_chunk_gather [bfloat16 rows, 100,000-row store]: equal "
        f"to the plain version bit for bit and between two launches; device "
        f"time per call (profiler) kernel {ms:.4f} ms ({moved / ms / 1e6:.1f} "
        f"GB/s of {moved / 1e6:.1f} MB read + written), plain "
        f"{plain_ms:.4f} ms, torch.index_select by a ready index "
        f"{library_ms:.4f} ms; card {smi_name_power()}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(moved + starts.numel() * 8, 0, "bfloat16"),
            "library_ms": library_ms, "form": "C=128, bf16 rows"}


ROUND_SEQS, ROUND_STORE_SEQS = 5000, 9300  # 2g: the benchmark's rounds
ROUND_FRAMES = (1000, 1900)


def events_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn`` by CUDA events over ``iters`` calls
    back to back, after one."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PCIE_GT_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0}  # per lane


def link_peak() -> tuple[float, str]:
    """The host link's peak bytes a second one way, from the PCIe
    generation and width nvidia-smi reports as the link's most (128b/130b
    coding from generation 3, 8b/10b before), and how it was read; the
    H100 SXM data sheet's Gen5 x16 where nvidia-smi does not say."""
    try:
        gen, width = (int(v) for v in subprocess.run(
            ["nvidia-smi", "--query-gpu=pcie.link.gen.max,"
             "pcie.link.width.max", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.splitlines()[0].split(","))
        said = "nvidia-smi"
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        gen, width, said = 5, 16, "the data sheet (nvidia-smi gave none)"
    coding = 128 / 130 if gen >= 3 else 0.8
    return (PCIE_GT_S[gen] * 1e9 * width * coding / 8,
            f"PCIe Gen{gen} x{width}, from {said}")


def phase_stage_gather() -> dict:
    """``stage_gather`` at a round's shape against the path it replaces,
    the copy engine and the link's peak (the module docstring's 2g)."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        GATHER_PIECE_ROWS,
        STORE_TAIL_SLACK,
        RoundLayout,
        copy_rows,
        gather_runs,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.ops import stage_gather
    from pytorch_scalablefhvae_tpu_torch.train.rounds import round_keys

    log(f"== phase 2g: stage_gather at a round's shape ({ROUND_SEQS} of "
        f"{ROUND_STORE_SEQS} sequences of {ROUND_FRAMES[0]}-"
        f"{ROUND_FRAMES[1]} frames, D {D})")
    rng = np.random.default_rng(0)
    lens = rng.integers(ROUND_FRAMES[0], ROUND_FRAMES[1] + 1,
                        ROUND_STORE_SEQS)
    data = np.empty((int(lens.sum()), D), np.float32)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for lo in range(0, data.shape[0], 1 << 21):
        hi = min(lo + (1 << 21), data.shape[0])
        torch.from_numpy(data[lo:hi]).copy_(
            torch.randn((hi - lo, D), generator=gen, device="cuda"))
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    store = FeatureStore.from_arrays({
        f"s{i:05d}": data[o:o + n] for i, (o, n) in enumerate(zip(offsets,
                                                                  lens))})
    del data
    keys = round_keys(store.seq_keys, ROUND_SEQS, 3, 0)
    layout = RoundLayout(store, keys)
    ceiling = int(np.sort(lens)[-ROUND_SEQS:].sum()) + STORE_TAIL_SLACK
    t0 = time.perf_counter()
    host = stage_gather.host_store(store.data, torch.device("cuda"))
    register_s = time.perf_counter() - t0
    runs = torch.from_numpy(gather_runs(layout, piece=GATHER_PIECE_ROWS))
    runs = runs.cuda()
    # the copy engine's form: a copy_ a run (a sequence, adjacent ones
    # merged) from the registered store, bfloat16 cast on the card after
    seqs = gather_runs(layout).tolist()
    nbytes = layout.rows * D * 4
    peak, link = link_peak()
    peak_ms = 1e3 * nbytes / peak
    pinned = torch.empty((layout.rows, D), pin_memory=True)
    fn = stage_gather.stage_gather
    out: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.empty((ceiling, D), dtype=dtype, device="cuda")
        rows32 = buf if dtype == torch.float32 else torch.empty(
            (layout.rows, D), device="cuda")

        def kernel():
            fn(host, runs, buf)

        def engine():
            for src, dst, n in seqs:
                rows32[dst:dst + n].copy_(host.rows[src:src + n],
                                          non_blocking=True)
            if rows32 is not buf:
                buf[:layout.rows].copy_(rows32)

        before = fn.launches
        kernel()
        got = buf[:layout.rows].clone()
        kernel()
        torch.cuda.synchronize()
        counted = fn.launches - before
        again = torch.equal(buf[:layout.rows], got)
        buf.zero_()
        t0 = time.perf_counter()
        engine()
        issue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        engine_same = torch.equal(buf[:layout.rows], got)
        # the path it replaces: the host sub-pack, then its pageable copy
        old = torch.zeros_like(buf)
        host_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            sub = store.subset(keys, materialize=True)
            copy_rows(old, sub.data)
            torch.cuda.synchronize()
            host_s.append(time.perf_counter() - t0)
            del sub
        same = torch.equal(got.view(torch.int16),
                           old[:layout.rows].view(torch.int16))
        if not (same and again and engine_same and counted == 2):
            raise AssertionError(
                f"stage_gather [{dtype}] differs from the host sub-pack "
                f"restaged ({same}), between launches ({again}) or from the "
                f"copy engine's copies ({engine_same}), or counted "
                f"{counted} of 2 launches")
        ms = events_ms(kernel, 5)
        engine_ms = events_ms(engine, 5)
        flat = buf.view(-1)[:layout.rows * D]
        pinned_ms = events_ms(lambda: flat.copy_(pinned.view(-1),
                                                 non_blocking=True), 5) \
            if dtype == torch.float32 else out["float32"]["pinned_copy_ms"]
        old_ms = 1e3 * min(host_s)
        out[str(dtype).split(".")[1]] = {
            "ms": ms, "bound_ms": peak_ms, "library_ms": engine_ms,
            "library_issue_ms": issue_ms, "pinned_copy_ms": pinned_ms,
            "plain_ms": old_ms}
        log(f"stage_gather [{dtype}]: equal to the host sub-pack restaged "
            f"and to the copy engine's copies bit for bit, and between two "
            f"launches; {len(runs)} runs, {layout.rows} rows, "
            f"{nbytes / 1e9:.3f} GB read: kernel {ms:.2f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s read, {100 * peak_ms / ms:.1f}% "
            f"of the link's peak, {100 * pinned_ms / ms:.1f}% of the pinned "
            f"copy_); the link's peak {peak / 1e9:.2f} GB/s ({link}), "
            f"{peak_ms:.2f} ms; the copy engine, a copy_ a run of {len(seqs)}"
            f"{', then a cast on the card' if rows32 is not buf else ''}, "
            f"{engine_ms:.2f} ms ({100 * peak_ms / engine_ms:.1f}% of the "
            f"peak; the host issued its copies in {issue_ms:.1f} ms); one "
            f"pinned float32 copy_ of the same bytes {pinned_ms:.2f} ms "
            f"({nbytes / pinned_ms / 1e6:.1f} GB/s); host sub-pack + restage "
            f"{[round(1e3 * t, 1) for t in host_s]} ms; registration of the "
            f"{store.data.nbytes / 1e9:.2f} GB store {register_s:.3f} s; "
            f"card {smi_name_power()}")
        del buf, old, got, rows32
        torch.cuda.empty_cache()
    f32 = out["float32"]
    return {"stage_gather": {
        "max_abs_err": 0.0, "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": peak_ms, "bound_by": f"host link peak ({link})",
        "library_ms": f32["library_ms"], "register_s": register_s,
        "form": f"{ROUND_SEQS} sequences, {nbytes / 1e9:.2f} GB",
        "by_dtype": out}}


def voiced_frames(n: int, noise_db: float, seed: int = 4) -> torch.Tensor:
    """``n`` frames of a voiced sound as the served utterances hold it: a
    harmonic source (15 harmonics of an f0 of 85-255 Hz under a spectral
    tilt of 0.5-0.85, random phases; a new speaker each frame, as in
    ``write_corpus``) at a peak of 0.3, white noise ``noise_db`` below the
    tone's RMS, pre-emphasized by 0.97 as the extractor does. Made with
    numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(N_FFT + 1)[None, :] / 16000.0
    f0 = rng.uniform(85.0, 255.0, (n, 1))
    tilt = rng.uniform(0.5, 0.85, (n, 1))
    y = np.zeros((n, N_FFT + 1))
    for h in range(1, 16):
        y += tilt ** h * np.sin(2 * np.pi * f0 * h * t
                                + rng.uniform(0, 2 * np.pi, (n, 1)))
    y *= 0.3 / np.abs(y).max(axis=1, keepdims=True)
    rms = np.sqrt((y * y).mean(axis=1, keepdims=True))
    y += rms * 10.0 ** (-noise_db / 20.0) * rng.standard_normal(y.shape)
    frames = y[:, 1:] - 0.97 * y[:, :-1]
    return torch.from_numpy(frames.astype(np.float32)).cuda()


def logmel_bounds(n: int, fb_t: torch.Tensor, nbytes: int) -> dict:
    """The chain's bounds: in fp32 outside the tensor cores, and as 3xTF32
    (three TF32 products per fp32 product over the TF32 rate), both dense;
    ``bound_ms`` is the lower of the two. Beside them the bound of the form
    the kernel takes (``bound_form_ms``): the DFT in fp32, the mel product
    as 3xTF32 on the bank's nonzero weights only (the kernel skips the
    rest)."""
    dft = 2 * n * N_FFT * N_BINS * 2
    mel_dense = 2 * n * N_BINS * fb_t.shape[1]
    mel = 2 * n * int((fb_t != 0).sum())
    fp32 = bound(nbytes, dft + mel_dense, "float32")
    tf32x3 = bound(nbytes, 3 * (dft + mel_dense), "tfloat32")
    form_ops = (dft / PEAK_FLOPS["float32"]
                + 3 * mel / PEAK_FLOPS["tfloat32"]) * 1e3
    return {**min(fp32, tf32x3, key=lambda b: b["bound_ms"]),
            "bound_fp32_ms": fp32["bound_ms"],
            "bound_3xtf32_ms": tf32x3["bound_ms"],
            "bound_form_ms": max(form_ops, nbytes / HBM_BYTES_PER_S * 1e3),
            "flops": dft + mel_dense}


def tf32x3_logmel(frames, w, C, S, fb_t) -> torch.Tensor:
    """The chain with its DFT in the 3xTF32 form (the form not taken),
    emulated: each operand split as hi = tf32(x), lo = tf32(x - hi)
    (round to nearest, ties away, as ``cvt.rna``), lo.lo dropped; per
    8-sample step, as ``mma.sync.m16n8k8`` takes them, three products
    (lo.hi, hi.lo, hi.hi in that order) each summed over the step in
    float64, rounded to fp32 and added to an fp32 accumulator. The tensor
    core's own rounding inside a step is not modelled. The magnitude, mel
    product and log as plain."""

    def split(x):
        bits = x.contiguous().view(torch.int32)
        hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        rest = (x - hi).contiguous().view(torch.int32)
        return hi, ((rest + 0x1000) & ~0x1FFF).view(torch.float32)

    fh, fl = split(frames * w)
    out = []
    for basis in (C, S):
        bh, bl = split(basis)
        acc = torch.zeros((frames.shape[0], basis.shape[1]),
                          dtype=torch.float32, device=frames.device)
        for k in range(0, basis.shape[0], 8):
            a = (fh[:, k:k + 8].double(), fl[:, k:k + 8].double())
            b = (bh[k:k + 8].double(), bl[k:k + 8].double())
            for x, y in ((1, 0), (0, 1), (0, 0)):
                acc = acc + (a[x] @ b[y]).float()
        out.append(acc)
    mag = torch.sqrt(out[0] * out[0] + out[1] * out[1] + 1e-30)
    return torch.log((mag @ fb_t).clamp(min=1e-38)).clamp(min=-20.0)


def phase_logmel() -> dict:
    """``fused_logmel_frames`` against ``logmel_frames_reference`` on the
    card: the serving batch's shape, a ragged N, one frame, silent frames
    that reach the log floor (and a floor below them), and a 40-band bank.
    A rectangular window in place of the Hamming one must miss the limit.
    Then the three served shapes (N 1,640, 6,560, 13,120) timed against the
    plain version (the kernel must be faster at the first two), with every
    tile height and the timing variants (``LOGMEL_PROBES``) beside them,
    voiced frames over noise at several levels (the kernel within the limit
    at ``DR_NOISE_DB``, where the plain chain with TF32 products must miss
    it; a float64 chain and the emulated 3xTF32 DFT logged beside), and
    rows equal bit for bit whatever the batch they came in. Everything is
    measured and logged before the checks raise."""
    from pytorch_scalablefhvae_tpu_torch.features.dsp_torch import (
        _spectral_consts,
    )
    from pytorch_scalablefhvae_tpu_torch.ops import _build, fbank_cuda
    from pytorch_scalablefhvae_tpu_torch.ops.fbank_cuda import (
        fused_logmel_frames,
        logmel_frames_reference,
    )

    log(f"== phase 2d: fused_logmel_frames against its plain version "
        f"(n_fft={N_FFT} K={N_BINS} M={D})")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    results: dict = {}
    failed = []
    for form, n, n_mels, silent, floor in (
            ("serving batch", N_SERVE_FRAMES, D, 0, -20.0),
            ("ragged N", 1641, D, 0, -20.0),
            ("one frame", 1, D, 0, -20.0),
            ("silent frames", 300, D, 100, -20.0),
            ("silent frames, floor -50", 300, D, 100, -50.0),
            ("40 mel bands", 1000, 40, 0, -20.0)):
        w, C, S, _, fb_t = _spectral_consts(16000, N_FFT, N_FFT, "hamming",
                                            n_mels, "slaney", True, dev)
        # frames of a pre-emphasized speech-like signal: noise with a level
        # per frame over four decades
        frames = torch.randn((n, N_FFT), generator=gen, device="cuda") \
            * torch.logspace(-3, 1, max(n, 2), device="cuda")[:n, None]
        frames[:silent] = 0.0
        args = (frames, w, C, S, fb_t)
        got = fused_logmel_frames(*args, log_floor=floor)
        again = fused_logmel_frames(*args, log_floor=floor)
        want = logmel_frames_reference(*args, log_floor=floor)
        wrong = fused_logmel_frames(frames, torch.ones_like(w), C, S, fb_t,
                                    log_floor=floor)
        torch.cuda.synchronize()
        err, miss = max_err(got, want), max_err(wrong, want)
        floored = int((got == floor).sum())
        log(f"fused_logmel_frames [{form}, N={n}]: max_abs_err {err:.3e} (tol "
            f"{TOL_LOGMEL:g}); two launches equal: {torch.equal(got, again)}; "
            f"{floored} of {got.numel()} values at the floor {floor}; a "
            f"rectangular window misses by {miss:.3e}")
        if not (got.shape == (n, n_mels) and torch.isfinite(got).all()
                and torch.equal(got, again) and err <= TOL_LOGMEL):
            failed.append(f"{form}: disagrees with its plain version or "
                          f"between launches ({err} > {TOL_LOGMEL})")
        if silent and floor == -20.0 and not bool((got[:silent] == floor).all()):
            failed.append("silent frames did not reach the log floor")
        if silent and floor == -50.0 and floored:
            # a silent band sums to about 1e-17: above this floor
            failed.append("silent frames fell to a floor below them")
        if not miss > TOL_LOGMEL:
            failed.append(f"{form}: the limit {TOL_LOGMEL} would pass a "
                          f"kernel with the wrong window (it misses by {miss})")
        r = results.setdefault("fused_logmel_frames", {
            "max_abs_err": err, "form": f"N={n}, n_fft {N_FFT}, {n_mels} mels"})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # the served shapes, timed; voiced frames over noise, which the
    # rectangular-window check above cannot stand in for: there the
    # quiet bins sit far below the loud ones in the same frame
    w, C, S, _, fb_t = _spectral_consts(16000, N_FFT, N_FFT, "hamming", D,
                                        "slaney", True, dev)
    by_shape: dict = {}
    for n in LOGMEL_SHAPES:
        frames = voiced_frames(n, DR_NOISE_DB)
        args = (frames, w, C, S, fb_t)

        def kernel():
            return fused_logmel_frames(*args)

        def plain():
            return logmel_frames_reference(*args)

        ms, plain_ms = device_ms(kernel, iters=20), device_ms(plain, iters=20)
        call_ms, plain_call_ms = time_ms(kernel), time_ms(plain)
        got = kernel()
        b = logmel_bounds(n, fb_t, tensor_bytes(args, got))
        by_shape[f"N={n}"] = {
            "ms": ms, "plain_ms": plain_ms, "events_ms": call_ms,
            "plain_events_ms": plain_call_ms,
            **{k: b[k] for k in ("bound_ms", "bound_by", "bound_fp32_ms",
                                 "bound_3xtf32_ms", "bound_form_ms")}}
        # the same call at every tile height (bits equal: the sums do not
        # depend on it), for the choice logmel_geometry makes
        rows = fbank_cuda.logmel_rows(n, frames.device)
        by_rows = {}
        for r in (16, 32, 64):
            by_rows[r] = device_ms(
                lambda r=r: fbank_cuda._launch(*args, -20.0, r), iters=20)
            if not torch.equal(fbank_cuda._launch(*args, -20.0, r), got):
                failed.append(f"N={n}: tile height {r} gives other bits")
        by_shape[f"N={n}"]["tile_rows"] = rows
        by_shape[f"N={n}"]["by_tile_rows_ms"] = by_rows
        note = (f"; geometry takes {rows} rows a tile; by tile height "
                + ", ".join(f"{k}: {v:.4f}" for k, v in by_rows.items()))
        if n != max(LOGMEL_SHAPES):
            # what bounds the kernel: the entry's form at this tile height
            # without the DFT's FMAs, with one load a slice, without the
            # mel (timing variants, never launched by the entry)
            lib = _build.library()
            probe_out = torch.empty_like(got)

            def probe(bits):
                code = lib.sfhvae_fbank_logmel_probe(
                    *(t.data_ptr() for t in (*args, probe_out)), n, N_FFT,
                    N_BINS, D, -20.0, rows, bits,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(code, "fbank_logmel probe")

            probes = {name: device_ms(lambda p=bits: probe(p), iters=20)
                      for name, bits in LOGMEL_PROBES.items()}
            by_shape[f"N={n}"]["probe_ms"] = probes
            note += "; " + ", ".join(f"{k} {v:.4f}" for k, v in probes.items())
        log(f"fused_logmel_frames [N={n}, voiced frames]: device time per "
            f"call (profiler) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"back to back (CUDA events) kernel {call_ms:.4f} ms, plain "
            f"{plain_call_ms:.4f} ms; bound {b['bound_ms']:.4f} ms (the "
            f"lower of the chain in fp32, {b['bound_fp32_ms']:.4f} ms, and "
            f"as 3xTF32, {b['bound_3xtf32_ms']:.4f} ms; the form taken, fp32 "
            f"DFT and 3xTF32 mel on the bank's nonzeros, "
            f"{b['bound_form_ms']:.4f} ms; {b['flops'] / 1e9:.2f} GFLOP): "
            f"{b['flops'] / ms / 1e9:.1f} TFLOP/s" + note)
        if n != max(LOGMEL_SHAPES) and not ms < plain_ms:
            failed.append(f"N={n}: kernel {ms:.4f} ms, not below plain "
                          f"{plain_ms:.4f} ms")
        if n == N_SERVE_FRAMES:
            results["fused_logmel_frames"].update(
                ms=ms, plain_ms=plain_ms, events_ms=call_ms,
                form=f"N={n}, n_fft {N_FFT}, {D} mels, voiced frames",
                **{k: b[k] for k in ("bound_ms", "bound_by", "library_ms",
                                     "bound_fp32_ms", "bound_3xtf32_ms",
                                     "bound_form_ms")})
        if n == max(LOGMEL_SHAPES):
            # rows equal bit for bit whatever the batch: the largest batch
            # against its first half, the serving batch against 4 x 1,640
            half = kernel()[:N_SERVE_FRAMES]
            served = fused_logmel_frames(frames[:N_SERVE_FRAMES].contiguous(),
                                         w, C, S, fb_t)
            quarter = N_SERVE_FRAMES // 4
            parts = torch.cat([fused_logmel_frames(
                frames[i:i + quarter].contiguous(), w, C, S, fb_t)
                for i in range(0, N_SERVE_FRAMES, quarter)])
            split_equal = torch.equal(half, served) and torch.equal(parts,
                                                                   served)
            log(f"fused_logmel_frames: rows of N={n} against N="
                f"{N_SERVE_FRAMES}, and N={N_SERVE_FRAMES} against 4 x "
                f"{quarter}, equal bit for bit: {split_equal}")
            if not split_equal:
                failed.append("rows differ with the batch they came in")
        del frames, args, got
    results["fused_logmel_frames"]["by_shape"] = by_shape

    # voiced frames at several noise levels: the kernel's error, the
    # parent's fp32 one at DR_NOISE_DB (PERF.md), and the plain chain with
    # TF32 products, which the limit must catch there; a float64 chain and
    # the emulated 3xTF32 DFT beside them
    for db in DR_SWEEP_DB:
        frames = voiced_frames(N_SERVE_FRAMES, db)
        args = (frames, w, C, S, fb_t)
        got = fused_logmel_frames(*args)
        want = logmel_frames_reference(*args)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = logmel_frames_reference(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        # the plain chain's own error: against the same chain in float64
        f = frames.double() * w.double()
        re, im = f @ C.double(), f @ S.double()
        exact = torch.log((torch.sqrt(re * re + im * im + 1e-30)
                           @ fb_t.double()).clamp(min=1e-38)).clamp(min=-20.0)
        x3 = tf32x3_logmel(*args)
        torch.cuda.synchronize()
        err, tf32_err = max_err(got, want), max_err(tf32, want)
        log(f"fused_logmel_frames [voiced frames, noise {db:g} dB below the "
            f"tone, N={N_SERVE_FRAMES}]: max_abs_err {err:.3e}; the plain "
            f"chain with TF32 products {tf32_err:.3e} (tol {TOL_LOGMEL:g}); "
            f"float64 chain against plain {max_err(exact, want):.3e}, "
            f"against the kernel {max_err(exact, got):.3e}; the emulated "
            f"3xTF32 DFT against plain {max_err(x3, want):.3e}, against "
            f"float64 {max_err(x3, exact):.3e}")
        if db == DR_NOISE_DB:
            results["fused_logmel_frames"]["max_abs_err"] = max(
                results["fused_logmel_frames"]["max_abs_err"], err)
            results["fused_logmel_frames"]["dynamic_range_err"] = err
            if not err <= TOL_LOGMEL:
                failed.append(f"voiced frames at {db} dB: {err} > "
                              f"{TOL_LOGMEL}")
            if not tf32_err > TOL_LOGMEL:
                failed.append(f"voiced frames at {db} dB: the limit would "
                              f"pass TF32 products ({tf32_err})")
    if failed:
        raise AssertionError("fused_logmel_frames: " + "; ".join(failed))
    return results


def phase_sharded() -> dict:
    """Kernel #7 in one process: per-shard partials with offsets, merged as
    the entry merges them, and the per-shard backward, against the plain
    single-table forward and backward on the whole unpadded table."""
    from pytorch_scalablefhvae_tpu_torch.ops.discriminative import (
        _forward_plain,
        combine_shard_partials,
        discriminative_log_qy_bwd_reference,
        discriminative_log_qy_sharded_bwd,
        shard_partials,
        shard_partials_reference,
    )
    from pytorch_scalablefhvae_tpu_torch.parallel.mesh import padded_num_seqs

    log("== phase 2e: the sharded discriminative entry (kernel #7), shard by "
        "shard in one process")
    g = torch.Generator().manual_seed(4)
    pz2_logvar = float(np.log(0.5 ** 2))
    results: dict = {}
    by_shape: dict = {}   # the forward's times per case
    # (table rows, shards, batch rows); the last is the mesh path's shape:
    # a rank of the (2, 2) mesh scores 512 rows against 2,310 table rows
    for n, m, b in ((N_TABLE, 2, B_TRAIN), (N_TABLE, 4, B_TRAIN),
                    (N_TABLE, 8, B_TRAIN), (N_LARGE, 4, B_TRAIN),
                    (5, 8, B_TRAIN), (N_TABLE, MESH[1], B_TRAIN // MESH[0])):
        n_pad = padded_num_seqs(n, m)
        per = n_pad // m
        mu2 = torch.randn((n, Z), generator=g)
        seq = torch.randint(0, n, (b,), generator=g)
        z2 = (mu2[seq] + 0.5 * torch.randn((b, Z), generator=g)).cuda()
        seq[5] = n_pad + 3                   # an index outside the table
        gq = torch.randn((b,), generator=g).cuda()
        mu2, seq = mu2.cuda(), seq.cuda()
        padded = torch.zeros((n_pad, Z), device="cuda")
        padded[:n] = mu2
        shards = [padded[j * per:(j + 1) * per].contiguous()
                  for j in range(m)]

        def partials(fn, offsets):
            return [fn(z2, shards[j], seq, pz2_logvar, n, offsets[j])
                    for j in range(m)]

        offsets = [j * per for j in range(m)]
        parts = partials(shard_partials, offsets)
        got, lse = combine_shard_partials(parts)
        want, want_lse = _forward_plain(z2, mu2, seq, pz2_logvar, n)
        plain, _ = combine_shard_partials(partials(shard_partials_reference,
                                                   offsets))
        wrong, _ = combine_shard_partials(partials(shard_partials_reference,
                                                   [0] * m))
        torch.cuda.synchronize()
        err, lse_err = max_err(got, want), max_err(lse, want_lse)
        plain_err, miss = max_err(plain, want), max_err(wrong, want)
        # shards made only of padding: m = -1e30 exactly, and the merge
        # without them gives the same bits
        empty = [j for j in range(m) if offsets[j] >= n]
        if empty:
            real = [p_ for j, p_ in enumerate(parts) if j not in empty]
            same = all(torch.equal(a, b_) for a, b_ in
                       zip(combine_shard_partials(real), (got, lse)))
            floor = all(bool((parts[j][0] == -1e30).all()) for j in empty)
            log(f"  N={n}, m={m}: shards {empty} hold only padding; their m "
                f"is exactly -1e30: {floor}; the merge without them gives "
                f"the same bits: {same}")
            if not (same and floor):
                raise AssertionError("an all-padding shard changed the "
                                     "merged result")

        dz2 = torch.zeros_like(z2)
        dmu2 = []
        for j in range(m):
            dz2_j, dmu2_j = discriminative_log_qy_sharded_bwd(
                z2, shards[j], seq, lse, gq, pz2_logvar, n, offsets[j])
            dz2 += dz2_j
            dmu2.append(dmu2_j)
        dmu2 = torch.cat(dmu2)
        want_bwd = discriminative_log_qy_bwd_reference(
            z2, mu2, seq, want_lse, gq, pz2_logvar, n)
        torch.cuda.synchronize()
        bwd_err = rel_norm((dz2, dmu2[:n]), want_bwd)
        bwd_aerr = abs_err((dz2, dmu2[:n]), want_bwd)
        padded_zero = bool((dmu2[n:] == 0).all())

        def fwd_kernel():
            return shard_partials(z2, shards[0], seq, pz2_logvar, n, 0)

        def fwd_plain():
            return shard_partials_reference(z2, shards[0], seq, pz2_logvar,
                                            n, 0)

        def bwd_kernel():
            return discriminative_log_qy_sharded_bwd(
                z2, shards[0], seq, lse, gq, pz2_logvar, n, 0)

        def bwd_plain():
            return discriminative_log_qy_bwd_reference(
                z2, shards[0], seq, lse, gq, pz2_logvar, n, 0)

        first, second = fwd_kernel(), fwd_kernel()
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b_) for a, b_ in zip(first, second))
        ms, plain_ms = time_ms(fwd_kernel), time_ms(fwd_plain, iters=5)
        bms, bplain_ms = time_ms(bwd_kernel), time_ms(bwd_plain, iters=3,
                                                      warmup=1)
        # the card's own time: a call of a few microseconds is bounded by
        # the host's launch time when calls follow back to back
        on_card = [device_ms(f, iters=20) for f in
                   (fwd_kernel, fwd_plain, bwd_kernel, bwd_plain)]
        fwd_passes = kernel_times_ms(fwd_kernel, iters=20)
        bwd_passes = kernel_times_ms(bwd_kernel)
        fb = bound(tensor_bytes(z2, shards[0], seq, parts[0]),
                   2 * b * per * Z, "float32")
        bb = bound(tensor_bytes(z2, shards[0], seq, lse, gq, dz2, dmu2[:per]),
                   6 * b * per * Z, "float32")
        log(f"discriminative_log_qy_sharded [N={n} padded to {n_pad}, m={m}, "
            f"B={b}, 1 index outside]: merged log_qy max_abs_err {err:.3e}, "
            f"lse {lse_err:.3e} (tol {TOL_SHARDED:g}; the plain partials "
            f"merged the same way: {plain_err:.3e}; fed offset 0 they miss by "
            f"{miss:.3e}); backward rel-norm err {bwd_err:.3e} (tol "
            f"{TOL_SHARDED:g}), max_abs_err {bwd_aerr:.3e}, padded rows "
            f"exactly 0: {padded_zero}; one shard of {per} rows: forward "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{fb['bound_ms']:.5f} ms by {fb['bound_by']}; backward kernel "
            f"{bms:.4f} ms, plain {bplain_ms:.4f} ms, bound "
            f"{bb['bound_ms']:.5f} ms by {bb['bound_by']} (CUDA events, "
            f"calls back to back); device time per call by the profiler: "
            f"forward kernel {on_card[0]:.4f} ms, plain {on_card[1]:.4f} ms, "
            f"backward kernel {on_card[2]:.4f} ms, plain {on_card[3]:.4f} ms; "
            f"forward by kernel (ms, launches): "
            + "; ".join(f"{k} {v[0]:.4f} x{v[1]:g}"
                        for k, v in fwd_passes.items())
            + "; backward by kernel: "
            + "; ".join(f"{k} {v[0]:.4f} x{v[1]:g}"
                        for k, v in bwd_passes.items())
            + f"; forward partials bitwise repeat: {repeat}")
        if not (torch.isfinite(got).all() and err <= TOL_SHARDED
                and lse_err <= TOL_SHARDED * max(1.0, float(want_lse.abs().max()))
                and bwd_err <= TOL_SHARDED and padded_zero and repeat):
            raise AssertionError(
                f"the sharded entry at N={n}, m={m} disagrees with the plain "
                f"single table, or two launches of its partials differ")
        if m > 1 and n > m and not miss > TOL_SHARDED:
            raise AssertionError(
                f"N={n}, m={m}: the limit {TOL_SHARDED} would pass partials "
                f"that ignore the row offset (they miss by {miss})")
        form = f"one shard of {per} rows (N={n}, m={m}), B={b}"
        for name, e, t, pt, bd in (
                ("discriminative_log_qy_sharded", err, ms, plain_ms, fb),
                ("discriminative_log_qy_sharded_bwd", bwd_aerr, bms,
                 bplain_ms, bb)):
            prev = results.get(name, {"max_abs_err": 0.0})
            # the last case, the mesh path's shape, is the one reported
            results[name] = {"max_abs_err": max(prev["max_abs_err"], e),
                             "ms": t, "plain_ms": pt, "form": form, **bd}
        results["discriminative_log_qy_sharded"].update(
            ms=on_card[0], events_ms=ms, plain_ms=on_card[1],
            passes_ms={k: v[0] for k, v in fwd_passes.items()})
        by_shape[form] = {"ms": on_card[0], "events_ms": ms,
                          "plain_ms": on_card[1], "bound_ms": fb["bound_ms"],
                          "passes_ms": {k: v[0] for k, v in
                                        fwd_passes.items()}}
        results["discriminative_log_qy_sharded"]["by_shape"] = by_shape
        results["discriminative_log_qy_sharded_bwd"]["passes_ms"] = {
            k: v[0] for k, v in bwd_passes.items()}
        del mu2, padded, shards, parts, dmu2, want_bwd
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 3


@contextmanager
def plain_versions():
    """Route the model through the plain versions (for the reference runs);
    under autograd their Functions run the plain backward."""
    from pytorch_scalablefhvae_tpu_torch.ops import discriminative, lstm_cuda

    saved = (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
             discriminative.discriminative_log_qy)
    lstm_cuda.lstm2_tm_proj = lstm_cuda.lstm2_tm_proj_reference
    lstm_cuda.lstm2_tm = lstm_cuda.lstm2_tm_reference
    discriminative.discriminative_log_qy = \
        discriminative.discriminative_log_qy_reference
    try:
        yield
    finally:
        (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
         discriminative.discriminative_log_qy) = saved


def write_corpus(wav_dir: Path, speakers: int = 40, per_speaker: int = 5,
                 sr: int = 16000, seed: int = 0) -> list[np.ndarray]:
    """Voiced synthetic utterances of 1.0-1.4 s as 16-bit WAVs: a harmonic
    source per speaker (its own f0 and spectral tilt) plus noise. Returns
    the signals as the WAV reader decodes them."""
    rng = np.random.default_rng(seed)
    wav_dir.mkdir(parents=True)
    signals = []
    for s in range(speakers):
        f0, tilt = rng.uniform(85.0, 255.0), rng.uniform(0.5, 0.85)
        for u in range(per_speaker):
            t = np.arange(int(sr * rng.uniform(1.0, 1.4))) / sr
            y = sum(tilt ** h * np.sin(2 * np.pi * f0 * h * t
                                       + rng.uniform(0, 2 * np.pi))
                    for h in range(1, 16))
            y = 0.3 * y / np.abs(y).max() + 0.01 * rng.standard_normal(len(t))
            pcm = np.clip(np.round(y * 32767), -32768, 32767).astype("<i2")
            with wave.open(str(wav_dir / f"s{s:02d}_u{u}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(pcm.tobytes())
            signals.append(pcm.astype(np.float32) / 32768.0)
    return signals


def make_experiment(root: Path) -> tuple[Path, Path]:
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
    )
    from pytorch_scalablefhvae_tpu_torch.eval.encode import _featurize
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train.checkpoint import save_checkpoint

    wav_dir = root / "wav"
    signals = write_corpus(wav_dir)
    exp = root / "exp"
    exp.mkdir()
    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(exp / "mvn.json")),
        model=ModelConfig(model_type="fhvae"))
    cfg.save(exp / "config.json")
    feats = np.concatenate([_featurize(y, 16000, cfg.features)
                            for y in signals])
    (exp / "mvn.json").write_text(json.dumps({
        "mean": [feats.mean(0).tolist()], "std": [feats.std(0).tolist()]}))
    model = FHVAE.from_config(cfg.data.seg_len * cfg.features.n_mels,
                              cfg.model, N_TABLE, feat_dim=cfg.features.n_mels,
                              generator=torch.Generator().manual_seed(0))
    save_checkpoint(exp, model, model_type="fhvae",
                    model_params=model.model_params(), run_info="smoke",
                    epoch=0, best_epoch=0, best_val_lb=0.0, values={},
                    extra_meta={"num_seqs": N_TABLE,
                                "feat_dim": cfg.features.n_mels,
                                "seg_len": cfg.data.seg_len})
    log(f"experiment: {len(signals)} utterances, {len(feats)} frames, "
        f"table {N_TABLE} x {Z}")
    return exp, wav_dir


class Server:
    """The port's ``serve`` loop on a thread, talking over two pipes."""

    def __init__(self, exp: Path):
        from pytorch_scalablefhvae_tpu_torch.eval.serve import serve

        r_in, w_in = os.pipe()
        r_out, w_out = os.pipe()
        self._to = os.fdopen(w_in, "w", buffering=1)
        self._from = os.fdopen(r_out, "r")
        fin, fout = os.fdopen(r_in, "r"), os.fdopen(w_out, "w")
        self.rc: list = []

        def run():
            try:
                self.rc.append(serve(exp, batch_size=B, device="cuda",
                                     stdin=fin, stdout=fout))
            except BaseException as e:  # reported by close()
                self.rc.append(e)
            finally:
                fout.close()
                fin.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def read(self) -> dict:
        line = self._from.readline()
        if not line:
            raise RuntimeError(f"server closed its stdout: {self.rc}")
        return json.loads(line)

    def ask(self, text: str) -> tuple[dict, float]:
        t0 = time.perf_counter()
        self._to.write(text + "\n")
        resp = self.read()
        return resp, time.perf_counter() - t0

    def close(self) -> None:
        self._to.close()
        self._thread.join(timeout=60)
        self._from.close()
        if self._thread.is_alive() or self.rc != [0]:
            raise RuntimeError(f"server did not exit cleanly: {self.rc}")


def serve_entries():
    from pytorch_scalablefhvae_tpu_torch.ops import (
        discriminative,
        fbank_cuda,
        lstm_cuda,
    )

    return (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
            discriminative.discriminative_log_qy,
            fbank_cuda.fused_logmel_frames)


def serve_three(exp: Path, wav_dir: Path, out_dir: Path,
                model_type: str = "fhvae"):
    """Start the port's ``serve`` on ``exp``, a ``model_type`` experiment;
    a ping, three encode requests (the first writes its latents to
    ``out_dir``), a malformed request and a shutdown, each response checked.
    Returns the three responses, their times and the kernel launches counted
    during the three requests."""
    t0 = time.perf_counter()
    server = Server(exp)
    ready = server.read()
    log(f"server ready in {time.perf_counter() - t0:.2f} s: {ready}")
    if not (ready.get("ok") and ready.get("model_type") == model_type):
        raise AssertionError(f"bad ready line: {ready}")
    pong, _ = server.ask(json.dumps({"id": "p", "cmd": "ping"}))
    if not (pong.get("ok") and pong.get("batch_size") == B):
        raise AssertionError(f"bad ping response: {pong}")

    entries = serve_entries()
    reset_counts(entries)
    responses, seconds = [], []
    for i in range(3):
        req = {"id": f"r{i}", "inputs": [str(wav_dir)]}
        if i == 0:
            req["output_dir"] = str(out_dir)
        resp, dt = server.ask(json.dumps(req))
        responses.append(resp)
        seconds.append(dt)
    launches = {e.__name__: e.launches for e in entries}
    log(f"launches during the requests: {launches}; of the LSTM entries', "
        f"through the tensor-core form: {tensor_core_counts(entries)}")
    if model_type == "fhvae":
        check_tensor_core(launches, tensor_core_counts(entries),
                          "the requests")

    bad, _ = server.ask("{not json")
    bye, _ = server.ask(json.dumps({"id": "s", "cmd": "shutdown"}))
    server.close()
    if bad.get("ok") is not False or "error" not in bad:
        raise AssertionError(f"malformed request was not refused: {bad}")
    if not bye.get("bye"):
        raise AssertionError(f"bad shutdown response: {bye}")

    n_utts = len(list(wav_dir.glob("*.wav")))
    for i, resp in enumerate(responses):
        if not resp.get("ok"):
            raise AssertionError(f"request r{i} failed: {resp}")
        for key in ("mu2_map", "z1_seq_mean"):
            arr = np.asarray(resp[key], np.float32)
            if arr.shape != (n_utts, Z) or not np.isfinite(arr).all():
                raise AssertionError(
                    f"r{i} {key}: shape {arr.shape}, finite "
                    f"{np.isfinite(arr).all()}")
        if resp["segments"] < B or resp["utterances"] != n_utts:
            raise AssertionError(f"r{i}: {resp['segments']} segments, "
                                 f"{resp['utterances']} utterances")
        for key in ("mu2_map", "z1_seq_mean"):
            if resp[key] != responses[0][key]:
                raise AssertionError(f"r{i} {key} differs from r0")

    segs = responses[0]["segments"]
    p50 = float(np.median(seconds[1:]))
    log(f"requests: {segs} segments, {n_utts} utterances each; times "
        f"{[round(s, 4) for s in seconds]} s; warm p50 {p50:.4f} s, "
        f"{segs / p50:.1f} segments/s")
    for i, resp in enumerate(responses):
        st, fs = resp["seconds"], resp["features_seconds"]
        log(f"r{i} stages (host clock): audio read {fs['audio']:.4f} s + "
            f"features {fs['features']:.4f} s + MVN and segmenting "
            f"{fs['segments']:.4f} s = {st['features']:.4f} s, batches + "
            f"model + copies {st['latents']:.4f} s, summaries "
            f"{st['summaries']:.4f} s; the features stage's share of the "
            f"request {st['features'] / seconds[i]:.3f}, the extractor's "
            f"{fs['features'] / seconds[i]:.3f}")
    return responses, seconds, launches


def load_served(out_dir: Path) -> dict:
    with np.load(out_dir / "latents.npz") as z:
        return {k: z[k] for k in ("z1_mu", "z2_mu", "mu2_map", "z1_seq_mean")}


def by_utterance(out_dir: Path) -> dict:
    """The served latents in the order of the utterances' names: the host
    extractors keep the request's order, the batched one sorts by length, so
    two runs are compared utterance by utterance."""
    with np.load(out_dir / "latents.npz") as z:
        lat = {k: z[k] for k in ("z1_mu", "z2_mu", "mu2_map", "z1_seq_mean",
                                 "seq_idx")}
    names = json.loads((out_dir / "sequences.json").read_text())
    order = np.argsort(names)
    rows = np.concatenate([np.flatnonzero(lat["seq_idx"] == i) for i in order])
    return {"z1_mu": lat["z1_mu"][rows], "z2_mu": lat["z2_mu"][rows],
            "mu2_map": lat["mu2_map"][order],
            "z1_seq_mean": lat["z1_seq_mean"][order]}


def phase_serve(workdir: Path) -> dict:
    """The same three requests served twice: from an experiment whose config
    says ``extractor: "numpy"`` (features on the host) and from its copy that
    says ``"jax"`` (the batched chain on the card, through
    ``fused_logmel_frames``). Returns each run's launches."""
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.eval.encode import EncodeSession
    from pytorch_scalablefhvae_tpu_torch.features.dsp_torch import (
        featurize_signals,
    )
    from pytorch_scalablefhvae_tpu_torch.features.extract import generate_feat
    from pytorch_scalablefhvae_tpu_torch.utils.audio_io import read_audio

    log("== phase 3: sfhvae serve of the fhvae model on the card, extractor "
        "numpy (host features)")
    exp, wav_dir = make_experiment(workdir)
    _, _, launches = serve_three(exp, wav_dir, workdir / "served")
    for name, n in launches.items():
        if (n <= 0) != (name == "fused_logmel_frames"):
            raise AssertionError(
                f"extractor numpy: {name} was launched {n} times")

    # the same request through the plain versions on the card, in the
    # served bf16 operand mode and in fp32 (the gap the tolerance must be
    # below)
    session = EncodeSession(exp, batch_size=B, device="cuda")
    with plain_versions():
        ref = session.encode([str(wav_dir)], verbose=False)
        session.model.lstm_mm_dtype = "float32"
        ref32 = session.encode([str(wav_dir)], verbose=False)
    served = load_served(workdir / "served")
    errs = {k: float(np.abs(served[k] - ref[k]).max()) for k in served}
    gap = max(float(np.abs(ref32[k] - ref[k]).max()) for k in served)
    log(f"served latents vs plain versions on the card: {errs} "
        f"(tol {TOL_SERVED:g}); plain fp32 vs plain bf16 operands differ by "
        f"{gap:.3e}")
    if not gap > TOL_SERVED:
        raise AssertionError(
            f"the served tolerance {TOL_SERVED} would pass a kernel that "
            f"skipped the bf16 rounding (fp32-vs-bf16 gap {gap})")
    if not all(e <= TOL_SERVED for e in errs.values()):
        raise AssertionError(f"served latents disagree: {errs}")

    log("== phase 3, again: the same experiment with extractor jax (features "
        "on the card)")
    exp_jax = workdir / "exp_jax"
    shutil.copytree(exp, exp_jax)
    cfg = json.loads((exp / "config.json").read_text())
    cfg["features"]["extractor"] = "jax"
    ExperimentConfig.from_dict(cfg).save(exp_jax / "config.json")

    # the extractor alone first: the card's features against the host's
    signals = {p.stem: read_audio(p)[0] for p in sorted(wav_dir.glob("*.wav"))}
    on_card = featurize_signals(signals, 16000, device="cuda")
    worst = 0.0
    for k, y in signals.items():
        host = generate_feat("fbank", y, 16000)
        if on_card[k].shape != host.shape:
            raise AssertionError(f"{k}: {on_card[k].shape} frames on the "
                                 f"card, {host.shape} on the host")
        diff = np.abs(on_card[k] - host)
        worst = max(worst, float(diff.max()))
        if not (diff <= TOL_FEATS + TOL_FEATS * np.abs(host)).all():
            raise AssertionError(f"{k}: features differ by {diff.max()}")
    log(f"features of {len(signals)} utterances, card (fused kernel) vs host "
        f"extractor: frame counts equal, max abs difference {worst:.3e} (tol "
        f"{TOL_FEATS:g} absolute and relative)")

    _, _, launches_jax = serve_three(exp_jax, wav_dir, workdir / "served_jax")
    for name, n in launches_jax.items():
        if n <= 0:
            raise AssertionError(f"extractor jax: {name} was not launched by "
                                 f"the requests")
    served_jax = by_utterance(workdir / "served_jax")
    served = by_utterance(workdir / "served")
    errs = {k: float(np.abs(served_jax[k] - served[k]).max()) for k in served}
    log(f"served latents, extractor jax vs extractor numpy: {errs} (tol "
        f"{TOL_SERVED_JAX:g})")
    if not all(e <= TOL_SERVED_JAX for e in errs.values()):
        raise AssertionError(f"the two extractors' latents disagree: {errs}")
    return {"serve": launches_jax, "serve_numpy": launches}


def phase_preprocess(workdir: Path) -> dict:
    """The port's CLI with ``--extractor jax`` on the card against
    ``--extractor numpy``: ``extract`` over manifests of the served WAVs and
    ``preprocess`` of the synthetic corpus. Frame counts equal, values
    within ``TOL_FEATS``."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.ops.fbank_cuda import (
        fused_logmel_frames,
    )
    from pytorch_scalablefhvae_tpu_torch.utils.manifest import read_scp

    log("== phase 3b: sfhvae extract and preprocess, --extractor jax on the "
        "card against --extractor numpy")
    wavs = sorted((workdir / "wav").glob("*.wav"))
    splits = {"train": wavs[:160], "dev": wavs[160:180], "test": wavs[180:]}
    roots = {}
    for extractor in ("numpy", "jax"):
        roots[extractor] = workdir / f"extract_{extractor}"
        for split, files in splits.items():
            d = roots[extractor] / split
            d.mkdir(parents=True)
            (d / "wav.scp").write_text(
                "".join(f"{p.stem} {p}\n" for p in files))
    fused_logmel_frames.launches = 0
    seconds = {}
    for extractor, root in roots.items():
        t0 = time.perf_counter()
        run_cli(cli, ["extract", str(root), "--dataset", "synthetic",
                      "--extractor", extractor])
        seconds[extractor] = time.perf_counter() - t0
    pre = {}
    for extractor in ("numpy", "jax"):
        pre[extractor] = workdir / f"pre_{extractor}"
        run_cli(cli, ["preprocess", "--dataset", "synthetic", "--data-root",
                      str(pre[extractor]), "--synthetic-speakers", "8",
                      "--synthetic-utts", "4", "--extractor", extractor])
    launches = fused_logmel_frames.launches
    if launches <= 0:
        raise AssertionError("--extractor jax did not launch "
                             "fused_logmel_frames")

    worst, n_utts = 0.0, 0
    for a, b in ((roots["jax"], roots["numpy"]),
                 (pre["jax"] / "synthetic_np_fbank",
                  pre["numpy"] / "synthetic_np_fbank")):
        for split in splits:
            got_len = (a / split / "len.scp").read_text()
            if got_len != (b / split / "len.scp").read_text() or not got_len:
                raise AssertionError(f"{a.name}/{split}: len.scp differs "
                                     f"between the extractors")
            want = read_scp(b / split / "feats.scp")
            got = read_scp(a / split / "feats.scp")
            if list(got) != list(want):
                raise AssertionError(f"{a.name}/{split}: feats.scp order")
            for k in want:
                x, y = np.load(got[k]), np.load(want[k])
                diff = np.abs(x - y)
                worst = max(worst, float(diff.max()))
                n_utts += 1
                if x.shape != y.shape or \
                        not (diff <= TOL_FEATS + TOL_FEATS * np.abs(y)).all():
                    raise AssertionError(f"{k}: features differ by "
                                         f"{diff.max()}")
    log(f"extract + preprocess: {n_utts} utterances, manifests and frame "
        f"counts equal, max abs difference {worst:.3e} (tol {TOL_FEATS:g} "
        f"absolute and relative); extract of 200 utterances took "
        f"{seconds['jax']:.3f} s with --extractor jax (audio read and .npy "
        f"writes included, first call uploads the constants) and "
        f"{seconds['numpy']:.3f} s with --extractor numpy; "
        f"fused_logmel_frames launched {launches} times")
    return {"fused_logmel_frames": launches}


# --------------------------------------------------------------- phase 4


def write_feature_corpus(root: Path, seed: int = 0):
    """A preprocessed synthetic corpus where the port's ``train`` looks for
    one: per-utterance ``.npy`` features (80 mels, 150-350 frames, TIMIT's
    1.5-3.5 s at 100 frames/s) with ``feats.scp`` / ``len.scp``, 4,620
    training and 400 dev sequences (TIMIT's counts). Each sequence has its
    own offset (what z2 should find) over a slowly drifting frame content
    (what z1 should find) and noise. Returns the run's config."""
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import split_manifests

    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(root / "mvn.json"),
                        training_batch_size=B_TRAIN),
        model=ModelConfig(model_type="fhvae"))
    rng = np.random.default_rng(seed)
    frames = 0
    for split, n in (("train", N_TABLE), ("dev", N_DEV)):
        paths = split_manifests(cfg, root)[split]
        d = paths["feat_pth"].parent
        d.mkdir(parents=True)
        feats, lens = [], []
        for i, n_frames in enumerate(rng.integers(150, 351, n)):
            offset = 2.0 * rng.standard_normal((1, D))
            drift = np.cumsum(0.3 * rng.standard_normal((n_frames, D)), 0)
            x = (offset + drift + 0.5 * rng.standard_normal((n_frames, D))
                 ).astype(np.float32)
            key = f"{split}_{i:05d}"
            np.save(d / f"{key}.npy", x)
            feats.append(f"{key} {d / (key + '.npy')}\n")
            lens.append(f"{key} {n_frames}\n")
            frames += n_frames
        paths["feat_pth"].write_text("".join(feats))
        paths["len_pth"].write_text("".join(lens))
    log(f"feature corpus: {N_TABLE} train + {N_DEV} dev sequences, {frames} "
        f"frames of {D} mels")
    return cfg


def train_entries():
    from pytorch_scalablefhvae_tpu_torch.ops import (
        discriminative,
        lstm_cuda,
        window_gather,
    )

    return (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
            discriminative.discriminative_log_qy, lstm_cuda.lstm2_tm_proj_bwd,
            lstm_cuda.lstm2_tm_bwd, discriminative.discriminative_log_qy_bwd,
            window_gather.windowed_chunk_gather)


def reset_counts(entries) -> None:
    for e in entries:
        e.launches = 0
        for counter in ("launches_tc", "launches_bf16"):
            if hasattr(e, counter):
                setattr(e, counter, 0)


def tensor_core_counts(entries) -> dict:
    return {e.__name__: e.launches_tc for e in entries
            if hasattr(e, "launches_tc")}


def check_tensor_core(launches: dict, tc: dict, where: str) -> None:
    """Every LSTM launch, forward and backward, of a path at the CLI defaults
    (bf16 operands, H 128) must have taken the tensor-core form."""
    for name, n in tc.items():
        if n != launches[name] or n <= 0:
            raise AssertionError(
                f"{name}: {n} of {launches[name]} launches during {where} "
                f"took the tensor-core form")


def seeded_model(cfg, num_seqs: int = N_TABLE):
    """The model the CLI starts from (seed 0), on the card."""
    from pytorch_scalablefhvae_tpu_torch.models.base import build_model

    return build_model(cfg.model.model_type, cfg.data.seg_len * D, cfg.model,
                       num_seqs,
                       feat_dim=D,
                       generator=torch.Generator().manual_seed(0)).cuda()


def first_batches_and_model(cfg, root: Path, n: int):
    """The first ``n`` training batches of epoch 0 on the card, and the
    model the CLI would start from (seed 0)."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.loop import batch_tensors

    dev = torch.device("cuda")
    loader, _ = build_loaders(cfg, root, True)
    loader.set_epoch(0)
    batches = []
    for b in loader:
        batches.append(batch_tensors(b, dev))
        if len(batches) == n:
            break
    return batches, seeded_model(cfg)


def staged_epoch0(cfg, root: Path):
    """The training loader, its store staged on the card, and epoch 0's
    plan there: the device tier's view of the same batches."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    loader, _ = build_loaders(cfg, root, True)
    source = DeviceDataSource(loader.dataset.store, torch.device("cuda"))
    loader.set_epoch(0)
    plan, arrays = source.stage_epoch(loader.dataset, loader._order(),
                                      loader.batch_size)
    return loader, source, plan, arrays


def compare_first_steps(cfg, root: Path) -> None:
    """Three train steps from one initial state and the same noise, through
    the kernels and through the plain versions (whose autograd Functions run
    the plain backward) on the card."""
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        train_step,
    )

    batches, model = first_batches_and_model(cfg, root, 3)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for path in ("kernels", "plain"):
        state = create_train_state(copy.deepcopy(model))
        opt = make_optimizer(1e-3, 0.95, 0.999)
        with plain_versions() if path == "plain" else nullcontext():
            losses = [float(train_step(state, opt, *b, 10.0)["loss"])
                      for b in batches]
        runs[path] = (losses, {n: p.detach() for n, p in
                               state.model.named_parameters()})
    (lk, pk), (lp, pp) = runs["kernels"], runs["plain"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    upd_err = max(float((pk[n] - pp[n]).norm()
                        / (pp[n] - start[n]).norm().clamp_min(1e-30))
                  for n in start)
    log(f"first 3 steps, kernels vs plain on the card: losses {lk} vs {lp} "
        f"(max rel diff {loss_err:.3e}, tol {TOL_TRAIN_LOSS:g}); parameter "
        f"updates differ by {upd_err:.3e} of their norm (tol "
        f"{TOL_TRAIN_UPDATE:g})")
    if not (loss_err <= TOL_TRAIN_LOSS and upd_err <= TOL_TRAIN_UPDATE):
        raise AssertionError("the kernel path's first train steps disagree "
                             "with the plain versions'")


def compare_tiers_first_steps(cfg, root: Path) -> None:
    """Three train steps through the kernels from one initial state and the
    same noise, fed by the host loader and gathered from the staged store:
    the same batches, so the same bits."""
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        device_train_step,
    )
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        train_step,
    )

    batches, model = first_batches_and_model(cfg, root, 3)
    _, source, plan, arrays = staged_epoch0(cfg, root)
    runs = {}
    for tier in ("host", "device"):
        state = create_train_state(copy.deepcopy(model))
        opt = make_optimizer(1e-3, 0.95, 0.999)
        if tier == "host":
            losses = [float(train_step(state, opt, *b, 10.0)["loss"])
                      for b in batches]
        else:
            losses = [float(device_train_step(
                state, opt, source.data, arrays, i * B_TRAIN, plan.n_real,
                10.0, batch_size=B_TRAIN, seg_len=cfg.data.seg_len)["loss"])
                for i in range(3)]
        runs[tier] = (losses, state)
    (lh, sh), (ld, sd) = runs["host"], runs["device"]
    same = lh == ld and all(
        torch.equal(a, b) for a, b in zip(
            [*sh.params().values(), *sh.mu.values(), *sh.nu.values()],
            [*sd.params().values(), *sd.mu.values(), *sd.nu.values()]))
    log(f"first 3 steps, device tier vs host loader on the card (kernels): "
        f"losses {ld} vs {lh}; parameters and Adam moments equal bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("the device tier's first train steps differ "
                             "from the host loader's")
    del source, arrays
    torch.cuda.empty_cache()


def check_dev_pass(cfg, root: Path) -> None:
    """The staged dev split's pass at the seeded model (the chunked MAP pass
    through ``windowed_chunk_gather``, then the eval pass): two runs give
    the same bits, and it agrees with the host loader's dev pass."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.loop import (
        dev_pass,
        device_dev_pass,
        stage_split,
    )

    dev = torch.device("cuda")
    _, dev_loader = build_loaders(cfg, root, True)
    split = stage_split(dev_loader, dev)
    if split.chunked is None:
        raise AssertionError("the dev split's MAP pass is not the chunked one")
    model = seeded_model(cfg)
    runs, seconds = [], []
    for fn in (lambda: device_dev_pass(model, split, 10.0),
               lambda: device_dev_pass(model, split, 10.0),
               lambda: dev_pass(model, dev_loader, 10.0, dev)):
        t0 = time.perf_counter()
        runs.append(fn())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    a, b, host = runs
    err = max(abs(a[k] - host[k]) / abs(host[k]) for k in host)
    log(f"dev pass at the seeded model: staged split (chunked MAP) "
        f"{seconds[0]:.3f} / {seconds[1]:.3f} s, two runs equal bit for bit: "
        f"{a == b}; host loader {seconds[2]:.3f} s; largest relative "
        f"difference of a metric {err:.3e} (tol {TOL_DEV_LB:g}); LB "
        f"{a['lower_bound']!r} vs {host['lower_bound']!r}")
    if a != b or not err <= TOL_DEV_LB:
        raise AssertionError("the staged dev pass does not repeat or "
                             "disagrees with the host dev pass")
    del split
    torch.cuda.empty_cache()


class _Tee(io.TextIOBase):
    """Write to every stream given (a run's stdout, kept and shown)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def run_cli(cli, args) -> str:
    """Run the port's CLI; fails when it exits non-zero. Returns its stdout."""
    out = io.StringIO()
    with redirect_stdout(_Tee(sys.stdout, out)):
        rc = cli(args)
    if rc != 0:
        raise AssertionError(f"{args[0]} {' '.join(args[-4:])} exited {rc}")
    return out.getvalue()


def phase_train(workdir: Path, cfg) -> tuple[dict, dict]:
    """Returns the launches of the train runs and their metrics records:
    ``{"device": [epochs 0, 1, 2], "host": epoch 0}``."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    log("== phase 4: sfhvae train of the fhvae model on the card (CLI "
        "defaults, batch 1024)")
    root = workdir / "data"
    compare_first_steps(cfg, root)
    compare_tiers_first_steps(cfg, root)
    check_dev_pass(cfg, root)

    exp_root = workdir / "experiments"
    args = ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--mvn-path", cfg.data.mvn_path,
            "--exp-root", str(exp_root)]
    entries = train_entries()
    reset_counts(entries)
    t0 = time.perf_counter()
    out = run_cli(cli, args + ["--epochs", "2"])
    exp = exp_root / "synthetic_np_fbank" / "fhvae_e2_p10_a10.0"
    last = exp / "fhvae_synthetic_np_fbank_e1.npz"
    out += run_cli(cli, args + ["--continue-from", str(last),
                                "--resume-override", "epochs=3"])
    seconds = time.perf_counter() - t0
    launches = {e.__name__: e.launches for e in entries}
    log(f"launches during training (2 epochs + 1 resumed, dev passes "
        f"included): {launches}; of the LSTM entries', through the "
        f"tensor-core form: {tensor_core_counts(entries)}")
    check_tensor_core(launches, tensor_core_counts(entries), "training")
    for line in ("Training data device-resident", "Dev split device-resident"):
        if out.count(line) != 2:
            raise AssertionError(f"the default train runs did not log "
                                 f"{line!r} once each")

    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in recs]
    steps = [ckpt.read_checkpoint_meta(
        exp / f"fhvae_synthetic_np_fbank_e{e}.npz")["step"] for e in range(3)]
    for r in recs:
        log(f"epoch {r['epoch']}: train loss {r['train_loss']:.4f}, "
            f"{r['train_steps']} steps in {r['train_seconds']:.3f} s = "
            f"{r['train_steps'] / r['train_seconds']:.2f} steps/s, "
            f"{r['train_segments_per_sec']:.1f} segments/s, "
            f"{1e3 * r['train_seconds'] / r['train_steps']:.2f} ms/step; dev "
            f"LB {r['val_lower_bound']:.4f}, log_qy {r['val_log_qy']:.4f}")
    log(f"checkpoint steps {steps}; 3 epochs took {seconds:.1f} s "
        f"end to end (loading, dev passes and checkpoints included); card "
        f"{smi_name_power()}")
    if [r["epoch"] for r in recs] != [0, 1, 2]:
        raise AssertionError(f"epochs recorded: {[r['epoch'] for r in recs]}")
    if not (all(np.isfinite(losses)) and losses[1] < losses[0]
            and np.isfinite(recs[-1]["val_lower_bound"])):
        raise AssertionError(f"train losses {losses} are not finite and "
                             f"falling")
    n = recs[0]["train_steps"]
    if steps != [n, 2 * n, 3 * n]:
        raise AssertionError(f"the resumed run did not continue the step "
                             f"count: {steps}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by training")

    # one epoch from the host loader: the same batches, so the same loss
    host_root = workdir / "experiments_host"
    out = run_cli(cli, args[:-1] + [str(host_root), "--data-placement",
                                    "host", "--epochs", "1"])
    if "device-resident" in out:
        raise AssertionError("--data-placement host staged data on the card")
    host = json.loads((host_root / "synthetic_np_fbank" / "fhvae_e1_p10_a10.0"
                       / "metrics.jsonl").read_text().splitlines()[0])
    lb_err = abs(host["val_lower_bound"] - recs[0]["val_lower_bound"]) \
        / abs(host["val_lower_bound"])
    log(f"epoch 0, device tier vs host loader: train loss "
        f"{recs[0]['train_loss']!r} vs {host['train_loss']!r}; dev LB "
        f"{recs[0]['val_lower_bound']!r} vs {host['val_lower_bound']!r} "
        f"(relative difference {lb_err:.3e}, tol {TOL_DEV_LB:g}); segments/s "
        f"{recs[0]['train_segments_per_sec']:.1f} (device tier) vs "
        f"{host['train_segments_per_sec']:.1f} (host loader), card "
        f"{smi_name_power()}")
    if host["train_loss"] != recs[0]["train_loss"] or not lb_err <= TOL_DEV_LB:
        raise AssertionError("the host loader's epoch 0 disagrees with the "
                             "device tier's")
    return launches, {"device": recs, "host": host}


# -------------------------------------------------------------- phase 4k

K_DISPATCH = 8   # phase 4k's steps per dispatch: 133 steps = 16 x 8 + 5


def check_bias_division(model) -> bool:
    """Whether Adam's bias corrections as device fp32 operands (the form
    every step takes since the K-step bundle: on CUDA the fp32 rounding of
    the reciprocal, multiplied) give the bits of ``_foreach_div`` by the
    host floats, over the model's parameter shapes and counts 1 to 200 and
    three large ones; true division by the correction on the device is
    logged beside it."""
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        make_optimizer,
        unbias,
    )

    opt = make_optimizer(1e-3, 0.95, 0.999)
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = [torch.rand(p.shape, generator=g, device="cuda") * 1e-3
          for p in model.parameters()]
    counts = [*range(200), 999, 9_999, 123_455]
    ops = torch.from_numpy(np.concatenate(
        [opt.bias_corrections(c, device="cuda") for c in counts])).cuda()
    differ, divided = [], 0
    for row, c in enumerate(counts):
        for j, b in enumerate((opt.beta_one, opt.beta_two)):
            host = float(np.float32(1.0) - np.float32(b) ** np.int32(c + 1))
            want = torch._foreach_div(xs, host)
            if not all(torch.equal(a, w) for a, w in
                       zip(unbias(xs, ops[row, j]), want)):
                differ.append((c + 1, j))
            divided += not all(torch.equal(a, w) for a, w in zip(
                torch._foreach_div(xs, torch.tensor(np.float32(host),
                                                    device="cuda")), want))
    log(f"bias corrections as device fp32 operands vs the host floats "
        f"(_foreach_div over {len(xs)} parameter shapes, {len(counts)} "
        f"counts x 2): {len(differ)} differ {differ[:6]}; true division by "
        f"the correction on the device would differ in {divided}")
    return not differ


def profiled_dispatches(dispatch, k: int, trace: dict | None = None,
                        tries: int = 3) -> dict:
    """``dispatch(d)`` (dispatch ``d`` of ``k`` steps issued, its losses on
    the card returned) as the epoch runners drive it, the losses read one
    dispatch late: the first dispatch (eager) and the second (a bundle's
    capture and first replay) timed on the host clock, then 10 warm
    dispatches under torch.profiler: host wall, device busy, copies and
    kernels per step, and the LSTM chains the profiler saw; over the same
    10 dispatches the kernels by name (``names``), the ``cudaGraphLaunch``
    calls, the kernel wrappers' counts (``counted``: entry name -> launches)
    and the host calls of most self time (``host``: name, ms a step, calls a
    step). With ``trace`` (kernel name -> the entries that launch it), a
    window in which the profiler's count of a kernel is not the wrappers'
    (the profiler loses events, see :func:`device_events`) is logged and
    the next 10 dispatches profiled instead, up to ``tries`` windows; the
    caller's check reads the last. ``dispatches``: how many ran."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_scalablefhvae_tpu_torch.train.graphs import launch_counts

    t0 = time.perf_counter()
    dispatch(0).tolist()
    eager = (time.perf_counter() - t0) * 1e3 / k
    t0 = time.perf_counter()
    dispatch(1).tolist()
    capture = time.perf_counter() - t0
    for window in range(tries):
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pending = None
            for d in range(2 + 10 * window, 12 + 10 * window):
                loss = dispatch(d)
                if pending is not None:
                    pending.tolist()
                pending = loss
            pending.tolist()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / (10 * k)
        after = launch_counts()
        averages = prof.key_averages()
        events = [e for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.device_time_total > 0]
        kernels = [e for e in events
                   if not e.key.startswith(("Memcpy", "Memset"))]
        counted = {entry.__name__: after[(entry, c)] - n
                   for (entry, c), n in before.items()
                   if c == "launches" and after[(entry, c)] != n}
        missed = [(kernel, sum(e.count for e in kernels if kernel in e.key),
                   sum(counted.get(n, 0) for n in names))
                  for kernel, names in (trace or {}).items()]
        missed = [m for m in missed if m[1] != m[2]]
        if not missed:
            break
        log(f"  torch.profiler's kernel counts over 10 dispatches are not "
            f"the wrappers' (kernel, profiler, wrappers): {missed}; "
            f"profiling the next 10")
    busy = sum(e.device_time_total for e in events) / 1e3 / (10 * k)
    host = sorted((e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    return {"eager": eager, "capture": capture, "wall": wall, "busy": busy,
            "idle": 1 - busy / wall,
            "copies": sum(e.device_time_total for e in events
                          if e.key.startswith("Memcpy")) / 1e3 / (10 * k),
            "launches": sum(e.count for e in kernels) / (10 * k),
            "chains": sum(e.count for e in kernels
                          if "lstm2_fwd_chain" in e.key),
            "names": {e.key: e.count for e in kernels},
            "graph_launches": sum(e.count for e in averages
                                  if e.key == "cudaGraphLaunch"),
            "counted": counted,
            "host": [(e.key, e.self_cpu_time_total / 1e3 / (10 * k),
                      e.count / (10 * k)) for e in host],
            "host_by_kind": host_by_kind(averages, 10 * k),
            "dispatches": 12 + 10 * window}


def host_by_kind(averages, steps: int) -> dict:
    """Self host time a step (ms) of a profiler window's CPU events by
    kind: CUDA runtime calls that wait for the device (synchronize, event
    or stream waits, blocking copies) or only issue work (launches,
    asynchronous copies), the collectives' host side (``c10d``, NCCL),
    autograd's nodes, the other ATen operators and the rest."""
    kinds: dict = {}
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        key = e.key
        if key.startswith("cuda") and ("Synchronize" in key
                                       or "Wait" in key or key in (
                                           "cudaMemcpy", "cudaEventQuery")):
            kind = "runtime, waits"
        elif key.startswith("cuda"):
            kind = "runtime, issues"
        elif "nccl" in key.lower() or "c10d" in key or "comms" in key:
            kind = "collectives"
        elif "Backward" in key or key.endswith("Fn") or "autograd" in key:
            kind = "autograd"
        elif key.startswith("aten::"):
            kind = "aten"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + e.self_cpu_time_total / 1e3 \
            / steps
    return kinds


def phase_train_k8(workdir: Path, cfg, runs: dict) -> dict:
    """Phase 4k: ``train --steps-per-dispatch 8`` through the CLI on both
    tiers, equal bit for bit to phase 4's runs (``runs``); returns the
    launches of its train runs."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    log(f"== phase 4k: sfhvae train --steps-per-dispatch {K_DISPATCH} on the "
        f"card, each dispatch one CUDA graph replay of {K_DISPATCH} steps")
    root = workdir / "data"
    division_ok = check_bias_division(seeded_model(cfg))

    k8 = ["--steps-per-dispatch", str(K_DISPATCH)]
    args = ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--mvn-path", cfg.data.mvn_path,
            "--exp-root"]
    entries = train_entries()
    reset_counts(entries)
    exp_root = workdir / "experiments_k8"
    out = run_cli(cli, args + [str(exp_root), *k8, "--epochs", "2"])
    exp = exp_root / "synthetic_np_fbank" / "fhvae_e2_p10_a10.0"
    out += run_cli(cli, args + [str(exp_root), "--continue-from",
                                str(exp / "fhvae_synthetic_np_fbank_e1.npz"),
                                "--resume-override", "epochs=3"])
    device_launches = {e.__name__: e.launches for e in entries}
    host_root = workdir / "experiments_k8_host"
    out_host = run_cli(cli, args + [str(host_root), *k8, "--data-placement",
                                    "host", "--epochs", "1"])
    launches = {e.__name__: e.launches for e in entries}
    log(f"launches during the K = {K_DISPATCH} train runs (2 epochs + 1 "
        f"resumed on the device tier, then 1 on the host loader; dev passes "
        f"included): {launches}; of the LSTM entries', through the "
        f"tensor-core form: {tensor_core_counts(entries)}; device runs alone "
        f"{device_launches}, phase 4's {runs['launches']}")
    check_tensor_core(launches, tensor_core_counts(entries),
                      f"training at K = {K_DISPATCH}")
    graphed = f"{K_DISPATCH} steps per dispatch, replayed as one CUDA graph"
    if out.count(graphed) != 2 or out_host.count(graphed) != 1:
        raise AssertionError(f"the K = {K_DISPATCH} runs did not log "
                             f"{graphed!r} once each")
    if out.count("Training data device-resident") != 2 \
            or "device-resident" in out_host:
        raise AssertionError("the K-step runs did not take their tiers")
    if device_launches != runs["launches"]:
        raise AssertionError(
            f"the K = {K_DISPATCH} device runs counted other launches than "
            f"phase 4's K = 1 runs of the same epochs: {device_launches} vs "
            f"{runs['launches']}")

    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    host = json.loads((host_root / "synthetic_np_fbank" / "fhvae_e1_p10_a10.0"
                       / "metrics.jsonl").read_text().splitlines()[0])
    steps = [ckpt.read_checkpoint_meta(
        exp / f"fhvae_synthetic_np_fbank_e{e}.npz")["step"] for e in range(3)]
    keys = ("train_loss", "train_steps", "step", "val_loss",
            "val_lower_bound", "val_log_qy")
    differ = []
    for tier, got, want in [*(("device", a, b) for a, b in
                              zip(recs, runs["device"])),
                            ("host", host, runs["host"])]:
        log(f"{tier} tier epoch {got['epoch']}, K = {K_DISPATCH} vs K = 1: "
            f"train loss {got['train_loss']!r} vs {want['train_loss']!r}; "
            f"dev LB {got['val_lower_bound']!r} vs "
            f"{want['val_lower_bound']!r}; "
            f"{1e3 * got['train_seconds'] / got['train_steps']:.3f} vs "
            f"{1e3 * want['train_seconds'] / want['train_steps']:.3f} "
            f"ms/step, {got['train_segments_per_sec']:.1f} vs "
            f"{want['train_segments_per_sec']:.1f} segments/s")
        differ += [(tier, got["epoch"], key) for key in keys
                   if got[key] != want[key]]
    with np.load(exp / "fhvae_synthetic_np_fbank_e2.npz") as a, np.load(
            workdir / "experiments" / "synthetic_np_fbank" / "fhvae_e2_p10_a10.0"
            / "fhvae_synthetic_np_fbank_e2.npz") as b:
        arrays = [key for key in a.files if key in b.files]
        unequal = [key for key in arrays if not np.array_equal(a[key], b[key])]
    log(f"epoch 2 checkpoints, K = {K_DISPATCH} vs K = 1: {len(arrays)} "
        f"arrays, {len(unequal)} differ {unequal[:5]}; checkpoint steps "
        f"{steps}; card {smi_name_power()}")
    if differ or unequal or len(recs) != 3:
        raise AssertionError(f"the K = {K_DISPATCH} runs differ from K = 1: "
                             f"{differ} {unequal[:5]}")
    n = recs[0]["train_steps"]
    if steps != [n, 2 * n, 3 * n]:
        raise AssertionError(f"the resumed K = {K_DISPATCH} run did not "
                             f"continue the step count: {steps}")
    if not division_ok:
        raise AssertionError("the bias corrections as device scalars divide "
                             "to other bits than the host floats")
    return launches


# -------------------------------------------------------------- phase 4s

STREAM_BUDGET = 96 << 20   # 4s-check: phase 4's 370 MB store streams in
                           # chunks of a quarter of it, 24 MiB (~16)
BIG_SEQS = {"train": 9_300, "dev": 400}   # 4s-big's corpus: 4.320 GB of
                                          # training rows, over 4 GiB
BIG_FRAMES = (1000, 1901)  # frames a sequence: LibriSpeech's 10-19 s
                           # utterances at 100 frames a second
BIG_CAP = 504              # 4s-big's CLI runs: --max-steps, 63 dispatches
                           # of 8 of a ~1,750-step epoch, past the first
                           # switch of ~400-step chunks


def train_args(cfg, root: Path, exp_root: Path, *extra) -> list:
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--mvn-path", cfg.data.mvn_path,
            "--exp-root", str(exp_root), *extra]


def run_dir(exp_root: Path, epochs: int, model: str = "fhvae") -> Path:
    return exp_root / "synthetic_np_fbank" / f"{model}_e{epochs}_p10_a10.0"


def metrics_of(exp_root: Path, epochs: int = 1) -> list[dict]:
    return [json.loads(line) for line in
            (run_dir(exp_root, epochs) / "metrics.jsonl").read_text()
            .splitlines()]


def counted_run(counts: dict, name: str, run):
    """``run()``, one CLI run (or a stopped run and its resume), counted
    alone: the train entries' counts set to 0 just before it
    (:func:`reset_counts`) and read just after, and added to ``counts``
    (``launches``, ``tensor_core``: entry name -> launches; ``bf16``: #8's
    on bfloat16 rows; ``stage_gather``: the round staging gather's launches
    by run; ``runs``: the names of the runs counted). Returns what ``run``
    returns."""
    from pytorch_scalablefhvae_tpu_torch.ops import stage_gather, window_gather

    entries = train_entries()
    reset_counts(entries)
    stage_gather.stage_gather.launches = 0
    out = run()
    counts.setdefault("stage_gather", {})[name] = \
        stage_gather.stage_gather.launches
    for key, read in (("launches", {e.__name__: e.launches
                                    for e in entries}),
                      ("tensor_core", tensor_core_counts(entries))):
        total = counts.setdefault(key, {})
        for entry, n in read.items():
            total[entry] = total.get(entry, 0) + n
    counts["bf16"] = (counts.get("bf16", 0)
                      + window_gather.windowed_chunk_gather.launches_bf16)
    counts.setdefault("runs", []).append(name)
    return out


def stream_config(cfg, dtype: str = "float32", budget: int = STREAM_BUDGET):
    return cfg.replace(data=dataclasses.replace(
        cfg.data, transfer_dtype=dtype, device_store_max_bytes=budget))


def stream_replay(cfg, root: Path, dtype: str):
    """Epoch 0 of a streamed run at ``STREAM_BUDGET`` in ``dtype``, replayed
    from host batches: the run's stream schedule, windows cut by the numpy
    store gather (bfloat16: rounded by torch; int8: cut from each chunk's
    dequantized codes, ``quantize.dequantize``), padded as the host loader
    pads, one eager step a batch from the seeded model; then the dev pass
    as the run takes it (the split staged in ``dtype`` where it fits what
    the stream's three chunks leave of the budget). Returns ``(train loss,
    dev metrics, state, staged dev split or None)``."""
    from pytorch_scalablefhvae_tpu_torch.data.quantize import (
        dequantize,
        quantize_columns,
    )
    from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
        StreamingDeviceSource,
    )
    from pytorch_scalablefhvae_tpu_torch.train import loop
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        train_step,
    )

    cfg = stream_config(cfg, dtype)
    dev = torch.device("cuda")
    loader, dev_loader = build_loaders(cfg, root, True)
    ds, B = loader.dataset, loader.batch_size
    # the run's chunks and schedule (host side only: staged on the CPU)
    src = StreamingDeviceSource(ds, STREAM_BUDGET // 4, B,
                                torch.device("cpu"), dtype)
    state = create_train_state(seeded_model(cfg))
    opt = make_optimizer(cfg.optim.learning_rate, cfg.optim.beta_one,
                         cfg.optim.beta_two)
    alpha = cfg.optim.alpha_dis
    loss_sum, count, steps = 0.0, 0, 0
    loader.set_epoch(0)
    for spec, order in src.epoch_schedule(loop.stream_seed(loader, 0)):
        frames = ds.store.data[spec.frame_base:spec.frame_base
                               + spec.n_frames]
        if dtype == "int8":
            frames = dequantize(*quantize_columns(frames))
        for b0 in range(0, len(order), B):
            idx = order[b0:b0 + B]
            real = len(idx)
            idx = np.concatenate([idx, np.full(B - real, idx[0], idx.dtype)])
            seq = ds.seq_idx[idx]
            rel = ds.store.seq_starts[seq] + ds.starts[idx] - spec.frame_base
            feats = torch.from_numpy(np.ascontiguousarray(
                frames[rel[:, None] + np.arange(ds.seg_len)],
                dtype=np.float32))
            if dtype == "bfloat16":
                feats = feats.to(torch.bfloat16)
            weight = np.zeros(B, np.float32)
            weight[:real] = 1.0
            m = train_step(state, opt, feats.to(dev),
                           torch.from_numpy(seq.astype(np.int32)).to(dev),
                           torch.from_numpy(ds.nsegs[seq].astype(np.float32))
                           .to(dev), torch.from_numpy(weight).to(dev), alpha)
            loss_sum += float(m["loss"]) * real
            count += real
            steps += 1
    split = loop.stage_dev_tier(
        cfg, dev_loader, dev, 3 * src.chunk_rows * D * src.itemsize, False)
    val = (loop.device_dev_pass(state.model, split, alpha) if split
           else loop.dev_pass(state.model, dev_loader, alpha, dev))
    return loss_sum / max(count, 1), val, state, split, steps


def checkpoint_state(cfg, path: Path, num_seqs: int = N_TABLE):
    """A train state at the seeded model loaded from a checkpoint."""
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
    from pytorch_scalablefhvae_tpu_torch.train.step import create_train_state

    state = create_train_state(seeded_model(cfg, num_seqs))
    ckpt.load_train_state(path, state)
    return state


def states_differ(a, b) -> list:
    """The names of the tensors (parameters, Adam moments) that differ."""
    pa, pb = a.params(), b.params()
    return [f"{kind}.{n}" for n in pa
            for kind, x, y in (("param", pa[n], pb[n]),
                               ("adam_mu", a.mu[n], b.mu[n]),
                               ("adam_nu", a.nu[n], b.nu[n]))
            if not torch.equal(x, y)]


def stream_check(workdir: Path, cfg, counts: dict) -> None:
    """4s-check on phase 4's corpus at ``STREAM_BUDGET``: the streamed
    epoch against its host replay (float32, bfloat16, int8), K = 8 against
    K = 1, a resumed streamed run, and bfloat16 and int8 on the device
    tier against float32. The streamed runs' launches go into ``counts``
    (:func:`counted_run`); the device-tier runs are not counted."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.ops import window_gather

    root = workdir / "data"
    budget = ["--device-store-max-bytes", str(STREAM_BUDGET)]
    results = {}
    for dtype in ("float32", "bfloat16", "int8"):
        exp_root = workdir / f"stream_{dtype}"
        # at 1 byte an element the store (100.4 MB) fits the budget: int8
        # streams by the flag
        forced = ["--data-placement", "stream"] if dtype == "int8" else []
        out = counted_run(counts, f"4s-check {dtype}", lambda: run_cli(
            cli, train_args(cfg, root, exp_root, *budget, *forced,
                            "--transfer-dtype", dtype, "--epochs", "1")))
        bf16_launches = window_gather.windowed_chunk_gather.launches_bf16
        m = re.search(r"streams through the device \((\d+) chunks of "
                      r"([\d.]+) MB", out)
        if m is None or not (forced or "streaming it" in out):
            raise AssertionError(f"the {dtype} store did not stream over a "
                                 f"{STREAM_BUDGET} byte budget")
        rec, = metrics_of(exp_root)
        loss, val, state, split, steps = stream_replay(cfg, root, dtype)
        ckpt_state = checkpoint_state(
            cfg, run_dir(exp_root, 1) / "fhvae_synthetic_np_fbank_e0.npz")
        differ = states_differ(ckpt_state, state)
        log(f"4s-check {dtype}: {m[1]} chunks of {m[2]} MB; streamed epoch "
            f"train loss {rec['train_loss']!r} vs host replay {loss!r}, dev "
            f"LB {rec['val_lower_bound']!r} vs {val['lower_bound']!r} (dev "
            f"split {'staged' if split else 'on the host'}); {rec['train_steps']}"
            f" steps vs {steps}; checkpoint tensors differing from the "
            f"replay's: {len(differ)} {differ[:3]}; #8 on bf16 rows "
            f"launched {bf16_launches} times; "
            f"{1e3 * rec['train_seconds'] / rec['train_steps']:.3f} ms/step")
        if (rec["train_loss"] != loss or rec["val_lower_bound"]
                != val["lower_bound"] or differ or rec["train_steps"] != steps):
            raise AssertionError(f"the {dtype} streamed epoch differs from "
                                 f"its host replay")
        if (dtype == "bfloat16") != (bf16_launches > 0) or (
                dtype == "bfloat16" and split is None):
            raise AssertionError(f"the {dtype} run's dev MAP pass launched "
                                 f"#8 on bf16 rows {bf16_launches} times")
        results[dtype] = rec
        del state, ckpt_state, split
        torch.cuda.empty_cache()

    # K = 8 equals K = 1, and a resumed streamed run continues the count
    exp_k8 = workdir / "stream_k8"
    out = counted_run(counts, f"4s-check K = {K_DISPATCH}", lambda: run_cli(
        cli, train_args(cfg, root, exp_k8, *budget, "--steps-per-dispatch",
                        str(K_DISPATCH), "--epochs", "1")))
    counted_run(counts, "4s-check resumed", lambda: run_cli(cli, train_args(
        cfg, root, exp_k8, *budget, "--continue-from",
        str(run_dir(exp_k8, 1) / "fhvae_synthetic_np_fbank_e0.npz"),
        "--resume-override", "epochs=2")))
    k8 = metrics_of(exp_k8)
    keys = ("train_loss", "train_steps", "step", "val_loss",
            "val_lower_bound", "val_log_qy")
    differ = [k for k in keys if k8[0][k] != results["float32"][k]]
    with np.load(run_dir(exp_k8, 1) / "fhvae_synthetic_np_fbank_e0.npz") \
            as a, np.load(run_dir(workdir / "stream_float32", 1)
                          / "fhvae_synthetic_np_fbank_e0.npz") as b:
        unequal = [key for key in a.files if key in b.files
                   and a[key].dtype != object
                   and not np.array_equal(a[key], b[key])]
    steps = [r["step"] for r in k8]
    n = k8[0]["train_steps"]
    log(f"4s-check K = {K_DISPATCH} vs K = 1: train loss {k8[0]['train_loss']!r}"
        f" vs {results['float32']['train_loss']!r}, differing keys {differ}, "
        f"checkpoint arrays differing {unequal[:5]}; "
        f"{1e3 * k8[0]['train_seconds'] / n:.3f} ms/step; resumed run's "
        f"steps {steps}")
    if differ or unequal or "replayed as one CUDA graph" not in out:
        raise AssertionError(f"the streamed K = {K_DISPATCH} epoch differs "
                             f"from K = 1")
    if steps != [n, 2 * n]:
        raise AssertionError(f"the resumed streamed run did not continue the "
                             f"step count: {steps}")

    # bfloat16 and int8 on the device-resident tier, against float32
    device = {}
    for dtype in ("float32", "bfloat16", "int8"):
        exp_root = workdir / f"device_{dtype}"
        out = run_cli(cli, train_args(cfg, root, exp_root,
                                      "--data-placement", "device",
                                      "--transfer-dtype", dtype,
                                      "--epochs", "1"))
        if "Training data device-resident" not in out:
            raise AssertionError(f"--data-placement device did not stage the "
                                 f"{dtype} store")
        device[dtype], = metrics_of(exp_root)
    f32 = device["float32"]
    for dtype in ("bfloat16", "int8"):
        r = device[dtype]
        log(f"4s-check device tier {dtype}: train loss {r['train_loss']!r} "
            f"(float32 {f32['train_loss']!r}, relative gap "
            f"{abs(r['train_loss'] / f32['train_loss'] - 1):.3e}), dev LB "
            f"{r['val_lower_bound']!r} (float32 {f32['val_lower_bound']!r}, "
            f"gap {abs(r['val_lower_bound'] / f32['val_lower_bound'] - 1):.3e}"
            f"); {1e3 * r['train_seconds'] / r['train_steps']:.3f} ms/step")
        if not all(np.isfinite([r["train_loss"], r["val_lower_bound"]])):
            raise AssertionError(f"the {dtype} device-tier epoch is not "
                                 f"finite")


def big_config(root: Path):
    """The config of a run on 4s-big's corpus at ``root``."""
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(root / "mvn.json"),
                        training_batch_size=B_TRAIN),
        model=ModelConfig(model_type="fhvae"))


def write_big_corpus(root: Path, seed: int = 1):
    """4s-big's preprocessed corpus: ``BIG_SEQS`` sequences of
    ``BIG_FRAMES`` frames of float32 normals (80 mels) around a per-sequence
    offset, one array per sequence (no per-frame loops). Returns the run's
    config and the training store's bytes."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import split_manifests

    cfg = big_config(root)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    frames = {}
    for split, n in BIG_SEQS.items():
        paths = split_manifests(cfg, root)[split]
        d = paths["feat_pth"].parent
        d.mkdir(parents=True)
        lens = rng.integers(*BIG_FRAMES, n)
        feats, lines = [], []
        for i, n_frames in enumerate(lens):
            x = rng.standard_normal((n_frames, D), dtype=np.float32)
            x += 2.0 * rng.standard_normal((1, D), dtype=np.float32)
            key = f"{split}_{i:05d}"
            np.save(d / f"{key}.npy", x)
            feats.append(f"{key} {d / (key + '.npy')}\n")
            lines.append(f"{key} {n_frames}\n")
        paths["feat_pth"].write_text("".join(feats))
        paths["len_pth"].write_text("".join(lines))
        frames[split] = int(lens.sum())
    nbytes = frames["train"] * D * 4
    log(f"4s-big corpus: {BIG_SEQS['train']} train sequences, "
        f"{frames['train']} frames ({nbytes / 1e9:.3f} GB in float32), and "
        f"{BIG_SEQS['dev']} dev sequences ({frames['dev']} frames), written "
        f"in {time.perf_counter() - t0:.1f} s")
    return cfg, nbytes


def big_corpus(workdir: Path):
    """4s-big's corpus and the config of a run on it with the packed store
    cached beside it: phase 4s's when it kept it, else written here."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import split_manifests

    root, pack = workdir / "big", workdir / "big_pack"
    cfg = big_config(root)
    if split_manifests(cfg, root)["train"]["len_pth"].exists():
        log("4s-big's corpus reused")
    else:
        cfg, _ = write_big_corpus(root)
    return root, cfg.replace(data=dataclasses.replace(
        cfg.data, pack_cache_dir=str(pack)))


def stream_big(workdir: Path, counts: dict, keep: bool = False) -> None:
    """4s-big: the CLI defaults over the default budget on a corpus whose
    fp32 store is over it. Each run stopped by ``--max-steps BIG_CAP``, past
    its first chunk switch, at K = 8: no placement flags (``auto`` streams
    ~5 chunks of 1 GiB), and ``--transfer-dtype bfloat16`` (the store fits
    at 2 bytes, and is staged whole); each must say so and train a finite
    loss. The store is packed once (``--pack-cache-dir``, shared with phase
    4h) and memory-mapped by every later load. The streamed run's launches
    go into ``counts`` (:func:`counted_run`); the whole bfloat16 store's are
    not counted. ``keep``: leave the corpus and its pack for phase 4h."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    root, pack = workdir / "big", workdir / "big_pack"
    cfg, nbytes = write_big_corpus(root)
    if nbytes <= 4 << 30:
        raise AssertionError(f"the big corpus ({nbytes} bytes) is not over "
                             f"the default budget")
    k8 = ["--steps-per-dispatch", str(K_DISPATCH)]
    runs = {"stream, K = 8": k8,
            "bfloat16, K = 8": ["--transfer-dtype", "bfloat16", *k8]}
    want = {"stream, K = 8": "streaming it",
            "bfloat16, K = 8": "staging it whole"}
    for i, (name, flags) in enumerate(runs.items()):
        exp_root = workdir / f"big_{i}"
        args = train_args(cfg, root, exp_root, "--pack-cache-dir", str(pack),
                          *flags, "--epochs", "1", "--max-steps",
                          str(BIG_CAP))
        if name.startswith("stream"):
            text = counted_run(counts, f"4s-big {name}",
                               lambda: run_cli(cli, args))
        else:
            text = run_cli(cli, args)
        if want[name] not in text:
            raise AssertionError(f"4s-big {name}: auto did not log "
                                 f"{want[name]!r}")
        m = re.search(r"streams through the device \((\d+) chunks of "
                      r"([\d.]+) MB in float32", text)
        mid = ckpt.read_checkpoint_meta(
            step_checkpoints(run_dir(exp_root, 1))[-1])["mid_epoch"]
        steps, loss = int(mid["batches_done"]), \
            mid["loss_sum"] / mid["count_sum"]
        log(f"4s-big {name}: {steps} steps (--max-steps), "
            + (f"{m[1]} chunks of {m[2]} MB, " if m else "")
            + f"train loss {loss:.4f} over those steps")
        if steps != BIG_CAP or not np.isfinite(loss):
            raise AssertionError(f"4s-big {name}: {steps} steps, or the loss "
                                 f"is not finite")
        if name.startswith("stream") and not (m and 4 <= int(m[1]) <= 6):
            raise AssertionError("4s-big: auto did not stream about 5 chunks")
    if not keep:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(pack, ignore_errors=True)


def phase_stream(workdir: Path, cfg, keep_big: bool = False) -> dict:
    """Phase 4s: the streamed tier and compressed staging through the CLI;
    returns the launches of its runs on the streamed tier
    (``train_stream``), each counted alone (:func:`counted_run`).
    ``keep_big``: leave 4s-big's corpus for phase 4h."""
    log("== phase 4s: sfhvae train, the streamed tier (--data-placement "
        "auto over the budget) and --transfer-dtype bfloat16|int8")
    counts: dict = {}
    stream_check(workdir, cfg, counts)
    stream_big(workdir, counts, keep_big)
    launches = counts["launches"]
    log(f"launches during the phase's {len(counts['runs'])} streamed runs "
        f"({', '.join(counts['runs'])}), each counted from 0: {launches}; of "
        f"the LSTM entries', "
        f"through the tensor-core form: {counts['tensor_core']}; #8 on bf16 "
        f"rows: {counts['bf16']}")
    check_tensor_core(launches, counts["tensor_core"], "the streamed runs")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by phase 4s's "
                                 f"streamed runs")
    return launches


# -------------------------------------------------------------- phase 4h

def equal_runs(name: str, a: Path, b: Path, epochs: list,
               stem: str = "fhvae_synthetic_np_fbank") -> None:
    """Two runs' checkpoints of ``epochs`` and their records, bit for
    bit."""
    differ = {e: differing_arrays(a / f"{stem}_e{e}.npz",
                                  b / f"{stem}_e{e}.npz") for e in epochs}
    recs = [[r[k] for k in ("train_loss", "train_steps", "step", "val_loss",
                            "val_lower_bound", "val_log_qy")]
            for r in (*metrics_in(a), *metrics_in(b))]
    same = recs[:len(epochs)] == recs[len(epochs):]
    log(f"{name}: checkpoint arrays differing {differ}; records equal "
        f"{same}")
    if any(differ.values()) or not same:
        raise AssertionError(f"{name}: the runs differ")


HIER_K = 5000           # --num-hierarchical-sequences, the CLI default
HIER_SMALL_K = 2000     # 4h (e): rounds on phase 4's corpus
TOL_HIER_TABLE = 1e-6   # 4h (b): the first round's MAP table, round-staged
                        # (fp32 sums on the card) against the host loader's
                        # (fp64 sums), max error over max |table|: the z2
                        # means are the same bits, the sums' order differs;
                        # measured 1.89e-7 (TOL_DEV_LB's 1e-5 before it)
TOL_HIER_EPOCH = 5e-4   # 4h (b): each epoch's train loss and dev bound,
                        # relative: two tables 1.9e-7 apart grow through
                        # 877 steps a round to 1.5e-4-1.9e-4, measured
                        # (TOL_MESH_EPOCH's 1e-3 before it)
HIER_ROUND = re.compile(r"Round at epoch (\d+) \((\d+) sequences, [^)]*\): "
                        r"(.*)")


def round_lines(out: str) -> list[dict]:
    """The rounds a run entered, as ``Rounds.loader_for`` prints them:
    ``{"epoch", "k", "seconds": {stage: s}, "fresh"}``."""
    rounds = []
    for m in HIER_ROUND.finditer(out):
        stages = dict(part.rsplit(" ", 2)[:2] for part in m[3].split(", "))
        rounds.append({"epoch": int(m[1]), "k": int(m[2]),
                       "seconds": {k: float(v) for k, v in stages.items()},
                       "fresh": "re-entered" not in m[0]})
    return rounds


def traced_turnover(rounds, state) -> tuple:
    """Round 0's loader from ``rounds`` (a fresh turnover), and its seconds
    by stage from its spans, as the loop prints them (``draw``: the draw
    and the loader)."""
    from pytorch_scalablefhvae_tpu_torch.train import trace

    trace.take()
    with trace.recording():
        sub = rounds.loader_for(0, state, resumed=False, verbose=False)
    spans = trace.summary(trace.take()[0])
    stages = {name[len("turnover."):]: v[1] for name, v in spans.items()
              if name.startswith("turnover.") and name != "turnover.planner"}
    stages["draw"] += stages.pop("loader")
    return sub, stages


def phase_hier(workdir: Path, cfg) -> dict:
    """Phase 4h: ``train --hierarchical`` at the CLI defaults (K = 5,000) on
    4s-big's corpus, over the 4 GiB budget, so ``auto`` stages each round's
    sub-pack (reused when phase 4s left it, else written): (a) K = 8, two
    rounds (K = 8 against K = 1 of a staged round is 5h (b)'s check, on a
    mesh rank, and (e)'s here); (b) the host loader at K =
    8, within ``TOL_HIER_TABLE`` and ``TOL_HIER_EPOCH``; (c) two-epoch
    rounds, a run stopped by ``--max-steps`` in the round's second epoch
    and resumed, bit for bit, without a second MAP init; (d) bfloat16
    staging; (e) phase 4's corpus with 2,000-sequence rounds on the device
    tier (views), K = 8 against K = 1. Each round's table is checked to be
    the MAP pass's with its moments zeroed, and each staged MAP init to be
    kernel #8's chunk-skip pass. Returns the launches of the phase's runs
    (``train_hier``), each counted from 0 (:func:`counted_run`)."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.ops import window_gather
    from pytorch_scalablefhvae_tpu_torch.train import rounds
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    log("== phase 4h: sfhvae train --hierarchical (K = 5,000 sequences a "
        "round) at the CLI defaults, a corpus over the 4 GiB budget")
    t_phase = time.perf_counter()
    root, bcfg = big_corpus(workdir)
    pack = Path(bcfg.data.pack_cache_dir)
    gather = window_gather.windowed_chunk_gather
    k8 = ["--steps-per-dispatch", str(K_DISPATCH)]
    counts: dict = {}
    inits, swaps = [], []
    real_init, real_swap = rounds.Rounds.map_init, rounds.replace_mu2_table

    def map_init(self, state, ds):
        n, bf16 = gather.launches, gather.launches_bf16
        real_init(self, state, ds)
        inits.append({"tier": self.tier, "chunked": self.chunked,
                      "skip": self.skip, "batches": self.map_batches,
                      "launches": gather.launches - n,
                      "bf16": gather.launches_bf16 - bf16})

    def swap(state, table):
        real_swap(state, table)
        ok = (torch.equal(state.model.mu2_table, table)
              and not state.mu["mu2_table"].any()
              and not state.nu["mu2_table"].any())
        swaps.append((ok, table.cpu().numpy()))

    def hier_run(name: str, exp_root: Path, *flags, epochs: int = 2,
                 data: Path = root, run_cfg=bcfg,
                 cache=("--pack-cache-dir", str(pack))):
        """One counted CLI run (on the big corpus, its store memory-mapped
        from ``pack`` after the first): its output, records, and the MAP
        inits and table swaps it made."""
        n_init = len(inits)
        t0 = time.perf_counter()
        out = counted_run(counts, f"4h {name}", lambda: run_cli(
            cli, train_args(run_cfg, data, exp_root, "--hierarchical",
                            *cache, *flags, "--epochs", str(epochs))))
        wall = time.perf_counter() - t0
        recs = metrics_of(exp_root, epochs)
        log(f"4h {name}: " + "; ".join(
            f"epoch {r['epoch']} {r['train_steps']} steps, "
            f"{1e3 * r['train_seconds'] / r['train_steps']:.3f} ms/step, "
            f"{r['train_segments_per_sec']:.1f} segments/s, train loss "
            f"{r['train_loss']!r}, dev LB {r['val_lower_bound']!r}"
            for r in recs)
            + f"; rounds {round_lines(out)}; MAP inits {inits[n_init:]}; "
            f"#8 launches {gather.launches}; {wall:.1f} s with loading; card "
            f"{smi_name_power()}")
        for r in recs:
            if not np.isfinite([r["train_loss"], r["val_lower_bound"]]).all():
                raise AssertionError(f"4h {name}: epoch {r['epoch']} is not "
                                     f"finite")
        return out, recs, inits[n_init:], swaps[n_init:]

    def staged_inits(name: str, made: list, n: int, bf16: bool = False):
        ok = (len(made) == n and all(
            i["tier"] == "round" and i["chunked"] and i["skip"] == 8
            and i["launches"] == i["batches"] > 0
            and (i["bf16"] == i["launches"] if bf16 else i["bf16"] == 0)
            for i in made))
        if not ok:
            raise AssertionError(f"4h {name}: the MAP inits {made} are not "
                                 f"{n} chunk-skip passes through #8")

    rounds.Rounds.map_init, rounds.replace_mu2_table = map_init, swap
    try:
        # (a) round-staged, K = 8, two rounds
        exp_a = workdir / "hier_a"
        out, recs_a, made_a, swaps_a = hier_run("(a) round-staged, K = 8",
                                                exp_a, *k8)
        turn = round_lines(out)
        if "stage their subset device-resident" not in out or len(turn) != 2 \
                or not all(t["fresh"] and t["k"] == HIER_K for t in turn):
            raise AssertionError("4h (a): the run did not stage two rounds "
                                 "of 5,000 sequences")
        staged_inits("(a)", made_a, 2)
        if not all(ok for ok, _ in swaps_a):
            raise AssertionError("4h (a): a round's table is not the MAP "
                                 "pass's, or its moments were not zeroed")
        log(f"4h (a) turnovers, seconds by stage: "
            f"{[t['seconds'] for t in turn]}; card {smi_name_power()}")

        # (b) the host loader, K = 8
        exp_c = workdir / "hier_c"
        out, recs_c, made_c, swaps_c = hier_run(
            "(b) host loader, K = 8", exp_c, "--data-placement", "host", *k8)
        if "device-resident" in out or [i["tier"] for i in made_c] != \
                ["host", "host"]:
            raise AssertionError("4h (b): the host-loader run staged data")
        ref = swaps_a[0][1]
        table_err = float(np.abs(swaps_c[0][1] - ref).max()
                          / np.abs(ref).max())
        gaps = [max(abs(c[k] / a[k] - 1) for k in ("train_loss",
                                                   "val_lower_bound"))
                for a, c in zip(recs_a, recs_c)]
        log(f"4h (b) host loader vs (a) round-staged: first round's MAP "
            f"table, max error over max |table| {table_err:.3e} (tol "
            f"{TOL_HIER_TABLE:g}); per epoch, the larger relative gap of "
            f"train loss and dev LB {[f'{g:.3e}' for g in gaps]} (tol "
            f"{TOL_HIER_EPOCH:g})")
        if not (table_err <= TOL_HIER_TABLE
                and max(gaps) <= TOL_HIER_EPOCH):
            raise AssertionError("4h (b): the host loader's hierarchical "
                                 "run disagrees with the round-staged one")

        # (c) two-epoch rounds: stopped in the round's second epoch and
        # resumed, against the run never stopped
        two = [*k8, "--hierarchical-round-epochs", "2"]
        exp_d = workdir / "hier_d"
        _, recs_d, _, _ = hier_run("(c) two-epoch rounds, K = 8", exp_d, *two)
        whole = gather.launches
        cap = int(recs_d[0]["train_steps"]) + 2 * RESUME_EVERY + 3
        args = train_args(bcfg, root, workdir / "hier_d_cut", "--hierarchical",
                          "--pack-cache-dir", str(pack), *two, "--epochs",
                          "2")
        n_init = len(inits)
        out, mid = counted_run(counts, "4h (c) stopped and resumed",
                               lambda: kill_and_resume(
                                   cli, "4h (c)", root, args,
                                   run_dir(workdir / "hier_d_cut", 2), cap))
        cut = gather.launches
        re_entered = [t for t in round_lines(out) if not t["fresh"]]
        log(f"4h (c): the cursor at epoch {mid['epoch']}, batch "
            f"{mid['batches_done']}; the resume re-entered {re_entered}; #8 "
            f"launches, stopped and resumed {cut} vs the run never stopped "
            f"{whole}; MAP inits of the two {inits[n_init:]}")
        if mid["epoch"] != 1 or len(re_entered) != 1 or cut != whole \
                or len(inits) - n_init != 1:
            raise AssertionError("4h (c): the resume did not re-enter the "
                                 "round with its restored table")
        check_resumed("4h (c)", run_dir(workdir / "hier_d_cut", 2),
                      run_dir(exp_d, 2), [0, 1])

        # (d) bfloat16 staging
        out, recs_e, made_e, _ = hier_run(
            "(d) round-staged bfloat16, K = 8", workdir / "hier_e",
            "--data-placement", "stream", "--transfer-dtype", "bfloat16",
            *k8, epochs=1)
        staged_inits("(d)", made_e, 1, bf16=True)
        log(f"4h (d) bfloat16 vs (a)'s epoch 0 in float32: train loss "
            f"{recs_e[0]['train_loss']!r} vs {recs_a[0]['train_loss']!r} "
            f"(relative gap "
            f"{abs(recs_e[0]['train_loss'] / recs_a[0]['train_loss'] - 1):.3e}"
            f"), dev LB {recs_e[0]['val_lower_bound']!r} vs "
            f"{recs_a[0]['val_lower_bound']!r}")
        if "stage their subset device-resident" not in out:
            raise AssertionError("4h (d): the bfloat16 run did not stage "
                                 "its rounds")

        # (e) phase 4's corpus, 2,000-sequence rounds on the device tier
        small = ["--num-hierarchical-sequences", str(HIER_SMALL_K)]
        for k in (K_DISPATCH, 1):
            out, _, made_f, _ = hier_run(
                f"(e) device tier, {HIER_SMALL_K} a round, K = {k}",
                workdir / f"hier_f{k}", *small, "--steps-per-dispatch",
                str(k), epochs=1, data=workdir / "data", run_cfg=cfg,
                cache=())
            if "Training data device-resident" not in out or [
                    (i["tier"], i["launches"] > 0) for i in made_f] != [
                    ("device", True)]:
                raise AssertionError("4h (e): the rounds did not run on the "
                                     "device tier through #8")
        equal_runs(f"4h (e) K = {K_DISPATCH} vs K = 1",
                   run_dir(workdir / f"hier_f{K_DISPATCH}", 1),
                   run_dir(workdir / "hier_f1", 1), [0])
    finally:
        rounds.Rounds.map_init, rounds.replace_mu2_table = real_init, real_swap

    launches = counts["launches"]
    log(f"launches during the phase's {len(counts['runs'])} runs "
        f"({', '.join(counts['runs'])}), each counted from 0: {launches}; of "
        f"the LSTM entries', through the tensor-core form: "
        f"{counts['tensor_core']}; #8 on bf16 rows: {counts['bf16']}")
    check_tensor_core(launches, counts["tensor_core"], "phase 4h")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by phase 4h")
    # a launch a round entered on the round tier: (a) two rounds, (c) one
    # (of two epochs), its stopped run one and the resume one more (it
    # re-enters the round: staged again), (d) one; none on the host loader
    # or the device tier's views
    staged = counts["stage_gather"]
    log(f"4h stage_gather launches by run: {staged}")
    want = {"4h (a) round-staged, K = 8": 2, "4h (b) host loader, K = 8": 0,
            "4h (c) two-epoch rounds, K = 8": 1,
            "4h (c) stopped and resumed": 2,
            "4h (d) round-staged bfloat16, K = 8": 1}
    if any(staged[name] != n for name, n in want.items()) or any(
            n for name, n in staged.items() if "(e)" in name):
        raise AssertionError(f"4h: the rounds were not staged by one "
                             f"stage_gather launch each: {staged}")
    log(f"phase 4h took {time.perf_counter() - t_phase:.1f} s")
    return {**launches, "stage_gather": sum(staged.values())}


# -------------------------------------------------------------- phase 4m

SIMPLE_B = 256   # 4m: the CLI's training batch of simple_fhvae (cli/args.py)
SIMPLE = "simple_fhvae"
SIMPLE_STEM = f"{SIMPLE}_synthetic_np_fbank"


def simple_config(cfg):
    """Phase 4's run with ``--model-type simple_fhvae`` at the CLI's widths
    and its batch."""
    from pytorch_scalablefhvae_tpu_torch.config import ModelConfig

    return cfg.replace(model=ModelConfig(model_type=SIMPLE),
                       data=dataclasses.replace(
                           cfg.data, training_batch_size=SIMPLE_B))


def write_reference_tar(path: Path, seed: int = 0) -> dict:
    """A checkpoint in the reference's schema (utils.py:116-152) and its
    modules' names (simple_fhvae.py:8-37, 127-244) at the CLI's widths, its
    weights drawn from ``seed`` as torch's ``Linear`` draws them. Returns
    its ``state_dict``."""
    g = torch.Generator().manual_seed(seed)
    state = {}

    def linear(name: str, d_in: int, d_out: int) -> None:
        lim = 1.0 / np.sqrt(d_in)
        state[f"{name}.weight"] = (torch.rand((d_out, d_in), generator=g)
                                   * 2 - 1) * lim
        state[f"{name}.bias"] = (torch.rand(d_out, generator=g) * 2 - 1) * lim

    for mod, d_in in (("z1_pre_encoder", T * D + Z),
                      ("z2_pre_encoder", T * D), ("pre_decoder", 2 * Z)):
        linear(f"{mod}.fc1.linear", d_in, H)
        linear(f"{mod}.fc2.linear", H, H)
    for mod, dim in (("z1_gauss_layer", Z), ("z2_gauss_layer", Z),
                     ("dec_gauss_layer", T * D)):
        linear(f"{mod}.mulayer", H, dim)
        linear(f"{mod}.logvar_layer", H, dim)
    torch.save({"best_val_lb": -1500.0, "best_epoch": 3, "epoch": 5,
                "model_type": SIMPLE,
                "model_params": ([H, H], [H, H], Z, Z, [H, H]),
                "optimizer": {}, "state_dict": state, "summary_vals": {},
                "values": {"train_loss_results": [2.0e3, 1.8e3]}}, path)
    return state


def phase_simple(workdir: Path, cfg) -> dict:
    """Phase 4m: ``--model-type simple_fhvae``, the reference's own model,
    at the CLI defaults (batch 256) on phase 4's corpus. Returns the launches
    of its CLI runs and serve requests, each counted alone
    (``train_simple``)."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.ops import fbank_cuda
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    log(f"== phase 4m: sfhvae train, eval, probe, serve and "
        f"import-checkpoint of the simple_fhvae model on the card (CLI "
        f"defaults, batch {SIMPLE_B})")
    t_phase = time.perf_counter()
    root = workdir / "data"
    scfg = simple_config(cfg)
    counts: dict = {}

    def simple_run(name: str, exp_root: Path, *extra) -> str:
        return counted_run(counts, f"4m {name}", lambda: run_cli(
            cli, train_args(cfg, root, exp_root, "--model-type", SIMPLE,
                            *extra)))

    # (a) the first steps through #5/#6 against the plain versions
    compare_first_steps(scfg, root)

    # (b) two epochs at K = 1 and at K = 8
    runs = {}
    for k in (1, K_DISPATCH):
        out = simple_run(f"(b) K = {k}", workdir / f"simple_k{k}",
                         "--epochs", "2", "--steps-per-dispatch", str(k))
        runs[k] = run_dir(workdir / f"simple_k{k}", 2, SIMPLE)
        if "Training data device-resident" not in out or (
                k > 1 and "replayed as one CUDA graph" not in out):
            raise AssertionError(f"4m (b) K = {k} did not take the device "
                                 f"tier and its dispatch")
        for r in metrics_in(runs[k]):
            log(f"4m (b) K = {k} epoch {r['epoch']}: train loss "
                f"{r['train_loss']!r}, {r['train_steps']} steps, "
                f"{1e3 * r['train_seconds'] / r['train_steps']:.3f} ms/step, "
                f"{r['train_segments_per_sec']:.1f} segments/s, dev LB "
                f"{r['val_lower_bound']!r}")
    equal_runs(f"4m (b) K = {K_DISPATCH} vs K = 1", runs[K_DISPATCH],
               runs[1], [0, 1], SIMPLE_STEM)
    recs = metrics_in(runs[1])
    if not (np.isfinite([r["train_loss"] for r in recs]).all()
            and recs[1]["train_loss"] < recs[0]["train_loss"]):
        raise AssertionError("4m: the train loss is not finite and falling")
    n = int(recs[0]["train_steps"])

    # (c)-(g) run at K = 8, which (b) holds equal to K = 1: an eager step
    # is host-bound (PERF.md, section 5)
    k8 = ["--steps-per-dispatch", str(K_DISPATCH)]

    # (c) one epoch from the host loader
    simple_run("(c) host loader", workdir / "simple_host", "--epochs", "1",
               "--data-placement", "host", *k8)
    host, = metrics_in(run_dir(workdir / "simple_host", 1, SIMPLE))
    gaps = [abs(host[k] / recs[0][k] - 1) for k in ("train_loss",
                                                     "val_lower_bound")]
    log(f"4m (c) host loader vs device tier, epoch 0: train loss "
        f"{host['train_loss']!r} vs {recs[0]['train_loss']!r}, dev LB "
        f"{host['val_lower_bound']!r} vs {recs[0]['val_lower_bound']!r} "
        f"(relative gaps {gaps[0]:.3e}, {gaps[1]:.3e}; tol {TOL_DEV_LB:g})")
    if not max(gaps) <= TOL_DEV_LB:
        raise AssertionError("4m (c): the host loader's epoch disagrees")

    # (d) stopped inside epoch 1 and resumed
    exp_root = workdir / "simple_resume"
    counted_run(counts, "4m (d) stopped and resumed", lambda: kill_and_resume(
        cli, "4m (d)", root, train_args(cfg, root, exp_root, "--model-type",
                                        SIMPLE, "--epochs", "2", *k8),
        run_dir(exp_root, 2, SIMPLE), n + RESUME_EVERY, stem=SIMPLE_STEM))
    check_resumed("4m (d)", run_dir(exp_root, 2, SIMPLE), runs[K_DISPATCH],
                  [0, 1], stem=SIMPLE_STEM)

    # (e) one streamed epoch against its host replay
    exp_root = workdir / "simple_stream"
    out = simple_run("(e) streamed", exp_root, "--device-store-max-bytes",
                     str(STREAM_BUDGET), "--epochs", "1", *k8)
    if "streams through the device" not in out:
        raise AssertionError("4m (e) did not stream")
    rec, = metrics_in(run_dir(exp_root, 1, SIMPLE))
    loss, val, state, split, steps = stream_replay(scfg, root, "float32")
    differ = states_differ(checkpoint_state(scfg, run_dir(
        exp_root, 1, SIMPLE) / f"{SIMPLE_STEM}_e0.npz"), state)
    log(f"4m (e) streamed epoch vs its host replay: train loss "
        f"{rec['train_loss']!r} vs {loss!r}, dev LB {rec['val_lower_bound']!r}"
        f" vs {val['lower_bound']!r}, {rec['train_steps']} steps vs {steps}; "
        f"tensors differing {differ[:3]}; "
        f"{1e3 * rec['train_seconds'] / rec['train_steps']:.3f} ms/step")
    if (rec["train_loss"] != loss or rec["val_lower_bound"]
            != val["lower_bound"] or differ or rec["train_steps"] != steps):
        raise AssertionError("4m (e): the streamed epoch differs from its "
                             "host replay")
    del state, split
    torch.cuda.empty_cache()

    # (f) eval and probe of the best checkpoint, then three served requests
    # of the experiment's copy that says extractor "jax"
    t0 = time.perf_counter()
    out = counted_run(counts, "4m (f) eval", lambda: run_cli(cli, [
        "eval", str(runs[1]), "--set-name", "dev", "--data-root", str(root)]))
    eval_s = time.perf_counter() - t0
    probe = json.loads(run_cli(cli, ["probe", str(runs[1]), "--set-name",
                                     "dev", "--data-root", str(root)]))
    metrics = json.loads((runs[1] / "eval" / "dev" / "metrics.json")
                         .read_text())
    best = ckpt.read_checkpoint_meta(ckpt.find_best_checkpoint(runs[1]))
    lb = recs[best["best_epoch"]]["val_lower_bound"]
    lb_err = abs(metrics["lower_bound"] - lb) / abs(lb)
    log(f"4m (f) eval {eval_s:.3f} s, stages {eval_stages(out)}; dev LB "
        f"{metrics['lower_bound']!r} vs the best epoch's {lb!r} (relative "
        f"{lb_err:.3e}, tol {TOL_DEV_LB:g}); probe z2 "
        f"{probe['z2_speaker_probe']['test_acc']}, z1 "
        f"{probe['z1_speaker_probe']['test_acc']}")
    if not lb_err <= TOL_DEV_LB or probe != metrics["probes"]:
        raise AssertionError("4m (f): eval or probe disagree with training")
    wav_dir = workdir / "wav"
    if not wav_dir.exists():
        write_corpus(wav_dir)
    exp_jax = workdir / "simple_serve"
    shutil.copytree(runs[1], exp_jax, ignore=shutil.ignore_patterns("eval"))
    served_cfg = ExperimentConfig.load(exp_jax / "config.json")
    served_cfg.replace(features=dataclasses.replace(
        served_cfg.features, extractor="jax")).save(exp_jax / "config.json")
    responses, seconds, served = serve_three(
        exp_jax, wav_dir, workdir / "simple_served", model_type=SIMPLE)
    for name, c in served.items():
        counts["launches"][name] = counts["launches"].get(name, 0) + c
    counts["runs"].append("4m (f) serve")
    log(f"4m (f) served: {responses[0]['segments']} segments a request, "
        f"times {[round(t, 4) for t in seconds]} s; launches {served}")
    if served[fbank_cuda.fused_logmel_frames.__name__] <= 0:
        raise AssertionError("4m (f): #9 served no request")

    # (g) a reference .tar imported, then a finetune epoch from it
    tar = workdir / "simple_fhvae_reference_e5.tar"
    state_dict = write_reference_tar(tar)
    run_cli(cli, ["import-checkpoint", str(tar), str(workdir / "imported"),
                  "--num-seqs", str(N_TABLE)])
    npz = workdir / "imported" / "simple_fhvae_imported_e5.npz"
    with np.load(npz) as z:
        landed = (np.array_equal(z["z2_pre.layers.0.w"], state_dict[
            "z2_pre_encoder.fc1.linear.weight"].numpy().T)
                  and np.array_equal(z["dec_gauss.logvar.b"], state_dict[
                      "dec_gauss_layer.logvar_layer.bias"].numpy())
                  and not z["mu2_table"].any())
    exp_root = workdir / "simple_finetune"
    simple_run("(g) finetune", exp_root, "--epochs", "1", "--continue-from",
               str(npz), "--finetune", *k8)
    ft, = metrics_in(run_dir(exp_root, 1, SIMPLE))
    log(f"4m (g) import-checkpoint of a reference .tar: weights landed "
        f"transposed, the table zero: {landed}; finetune epoch train loss "
        f"{ft['train_loss']!r}, dev LB {ft['val_lower_bound']!r}, "
        f"{ft['train_steps']} steps")
    if not landed or not np.isfinite([ft["train_loss"],
                                      ft["val_lower_bound"]]).all():
        raise AssertionError("4m (g): the import or its finetune failed")

    launches = counts["launches"]
    log(f"launches during phase 4m's {len(counts['runs'])} runs "
        f"({', '.join(counts['runs'])}), each counted from 0: {launches}; "
        f"card {smi_name_power()}")
    for name, c in launches.items():
        lstm = name.startswith("lstm2")
        if (c > 0) == lstm:
            raise AssertionError(f"4m: {name} was launched {c} times")
    log(f"phase 4m took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -------------------------------------------------------------- phase 4p


def plan_check(cfg, root: Path) -> None:
    """4p (b): the device planner on phase 4's training set: each epoch's
    plan a permutation of the host plan's real rows, the padding at the
    tail, two epochs two orders; its time against the host upload it
    replaces (order, plan and copy to the card)."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
        DeviceEpochPlanner,
        build_epoch_plan,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    dev = torch.device("cuda")
    loader, _ = build_loaders(cfg, root, True)
    ds, rows = loader.dataset, loader.batch_size
    n_real = len(ds)
    source = DeviceDataSource(ds.store, dev)
    planner = DeviceEpochPlanner(source, cfg.train.seed, ds.seg_shift,
                                 n_real + (-n_real) % rows)
    planner.stage(ds)
    host = build_epoch_plan(ds, np.arange(n_real), rows)
    want = torch.sort(torch.from_numpy(host.seq_idx[:n_real].astype(np.int64)
                                       << 32 | host.abs_starts[:n_real]
                                       .astype(np.int64)).to(dev))[0]
    firsts = []
    for epoch in (0, 1):
        _, (seq, starts, _) = planner.plan(epoch, n_real, rows)
        keys = seq[:n_real] << 32 | starts[:n_real]
        if not (torch.equal(torch.sort(keys)[0], want)
                and not seq[n_real:].any() and not starts[n_real:].any()):
            raise AssertionError(f"4p (b): epoch {epoch}'s plan is not a "
                                 f"permutation with the padding at the tail")
        firsts.append(keys[:rows].clone())
    if torch.equal(*firsts):
        raise AssertionError("4p (b): two epochs planned one order")

    def planned():
        planner.plan(2, n_real, rows)
        torch.cuda.synchronize()

    def uploaded():
        loader.set_epoch(2)
        source.stage_epoch(ds, loader._order(), rows)
        torch.cuda.synchronize()

    walls = {}
    for name, fn in (("device plan", planned), ("host upload", uploaded)):
        fn()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        walls[name] = (time.perf_counter() - t0) * 1e2
    # CUDA events around calls back to back: a plan is ~20 small launches,
    # of which torch.profiler drops the first in a trace taken late in
    # this script
    plan_ms = time_ms(lambda: planner.plan(2, n_real, rows), 10)
    log(f"4p (b) {n_real} segments, {planner.n_rows} plan rows: both epochs "
        f"permutations of the host plan with the padding at the tail, their "
        f"orders differ; a plan derived on the card {walls['device plan']:.3f}"
        f" ms wall ({plan_ms:.3f} ms by CUDA events), the host's order, plan "
        f"and upload it replaces {walls['host upload']:.3f} ms wall; card "
        f"{smi_name_power()}")
    del source, planner
    torch.cuda.empty_cache()


def phase_plan(workdir: Path, cfg) -> dict:
    """Phase 4p: ``train --epoch-plan device`` at the fhvae CLI defaults on
    phase 4's corpus. Returns the launches of its runs in this process,
    each counted alone (``train_plan``)."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli

    log("== phase 4p: sfhvae train --epoch-plan device on the card (plans "
        "derived on the card from a seed)")
    t_phase = time.perf_counter()
    root = workdir / "data"
    flag = ["--epoch-plan", "device"]
    counts: dict = {}

    def plan_run(name: str, exp_root: Path, *extra) -> str:
        out = counted_run(counts, f"4p {name}", lambda: run_cli(
            cli, train_args(cfg, root, exp_root, *flag, *extra)))
        for r in metrics_in(next(exp_root.glob("synthetic_np_fbank/*"))):
            log(f"4p {name} epoch {r['epoch']}: train loss "
                f"{r['train_loss']!r}, {r['train_steps']} steps, "
                f"{1e3 * r['train_seconds'] / r['train_steps']:.3f} ms/step, "
                f"dev LB {r['val_lower_bound']!r}")
        return out

    plan_check(cfg, root)

    # (a) the device tier, K = 8 against K = 1 over two epochs
    for k in (1, K_DISPATCH):
        out = plan_run(f"(a) K = {k}", workdir / f"plan_k{k}", "--epochs",
                       "2", "--steps-per-dispatch", str(k))
        if "Epoch plans derive on the device" not in out:
            raise AssertionError(f"4p (a) K = {k} did not plan on the card")
    ref = run_dir(workdir / "plan_k1", 2)
    equal_runs(f"4p (a) K = {K_DISPATCH} vs K = 1",
               run_dir(workdir / f"plan_k{K_DISPATCH}", 2), ref, [0, 1])

    # (c) stopped inside epoch 1, resumed in a new process
    n = int(metrics_in(ref)[0]["train_steps"])
    exp_root = workdir / "plan_resume"
    exp = run_dir(exp_root, 2)
    plan_run("(c) stopped", exp_root, "--epochs", "2", "--ckpt-every-steps",
             str(RESUME_EVERY), "--max-steps", str(n + RESUME_EVERY),
             "--steps-per-dispatch", str(K_DISPATCH))
    last = step_checkpoints(exp)[-1]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_scalablefhvae_tpu_torch.cli.main",
         "train", "--dataset", "synthetic", "--preprocessed", "--data-root",
         str(root), "--continue-from", str(last), "--resume-override",
         "max_steps=0"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=900)
    log(f"4p (c) resumed from {last.name} in a new process: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; "
        f"{proc.stdout.strip().splitlines()[-3:]}")
    if proc.returncode != 0 or f"mid-epoch at batch {RESUME_EVERY}" \
            not in proc.stdout:
        raise AssertionError(f"4p (c): the resume failed: "
                             f"{proc.stderr[-2000:]}")
    check_resumed("4p (c)", exp, ref, [0, 1])

    # (d) two hierarchical rounds of 2,000 sequences, device tier
    small = ["--hierarchical", "--num-hierarchical-sequences",
             str(HIER_SMALL_K), "--epochs", "2"]
    for k in (1, K_DISPATCH):
        out = plan_run(f"(d) rounds, K = {k}", workdir / f"plan_hier{k}",
                       *small, "--steps-per-dispatch", str(k))
        if out.count(f"({HIER_SMALL_K} sequences, 1 epoch)") != 2 \
                or "Training data device-resident" not in out:
            raise AssertionError(f"4p (d) K = {k}: not two rounds on the "
                                 f"device tier")
    equal_runs(f"4p (d) rounds, K = {K_DISPATCH} vs K = 1",
               run_dir(workdir / f"plan_hier{K_DISPATCH}", 2),
               run_dir(workdir / "plan_hier1", 2), [0, 1])

    # (e) the streamed tier ignores the flag: the host plan's epoch
    stream = ["--device-store-max-bytes", str(STREAM_BUDGET),
              "--transfer-dtype", "float32", "--epochs", "1"]
    out = plan_run("(e) streamed", workdir / "plan_stream", *stream)
    note = "epoch_plan=device ignored: training data is chunk-streamed"
    ref = run_dir(workdir / "stream_float32", 1)
    if not (ref / "fhvae_synthetic_np_fbank_e0.npz").exists():
        run_cli(cli, train_args(cfg, root, workdir / "plan_stream_ref",
                                *stream))
        ref = run_dir(workdir / "plan_stream_ref", 1)
    if note not in out:
        raise AssertionError("4p (e): the streamed run printed no note")
    equal_runs("4p (e) streamed with the flag vs without",
               run_dir(workdir / "plan_stream", 1), ref, [0])

    launches = counts["launches"]
    log(f"launches during phase 4p's {len(counts['runs'])} runs in this "
        f"process ({', '.join(counts['runs'])}), each counted from 0: "
        f"{launches}; of the LSTM entries', through the tensor-core form: "
        f"{counts['tensor_core']}; card {smi_name_power()}")
    check_tensor_core(launches, counts["tensor_core"], "phase 4p")
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{name} was not launched by phase 4p")
    log(f"phase 4p took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -------------------------------------------------------------- phase 4b


def eval_stages(out: str) -> dict:
    """The stage times ``sfhvae eval`` prints (``Stages (s): k v, ...``)."""
    line = next(ln for ln in out.splitlines() if ln.startswith("Stages (s): "))
    return {k: float(v) for k, v in (
        part.rsplit(" ", 1) for part in line[len("Stages (s): "):]
        .split(", "))}


def phase_eval(workdir: Path) -> dict:
    """Phase 4b: ``eval`` and ``probe`` of phase 4's experiment (3 epochs,
    best checkpoint) on its dev split through the port's CLI. Returns the
    launches of the eval run."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.eval.evaluate import (
        evaluate_experiment,
    )
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    log(f"== phase 4b: sfhvae eval and probe of phase 4's experiment on the "
        f"card ({N_DEV} dev sequences, batch {B}, bf16 LSTM operands)")
    root = workdir / "data"
    exp = workdir / "experiments" / "synthetic_np_fbank" / "fhvae_e2_p10_a10.0"
    entries = train_entries()[:3]  # the three forward entries
    reset_counts(entries)
    t0 = time.perf_counter()
    out = run_cli(cli, ["eval", str(exp), "--set-name", "dev", "--data-root",
                        str(root)])
    eval_s = time.perf_counter() - t0
    launches = {e.__name__: e.launches for e in entries}
    log(f"launches during eval: {launches}; of the LSTM entries', through "
        f"the tensor-core form: {tensor_core_counts(entries)}")
    check_tensor_core(launches, tensor_core_counts(entries), "eval")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by eval")
    t0 = time.perf_counter()
    probe = json.loads(run_cli(cli, ["probe", str(exp), "--set-name", "dev",
                                     "--data-root", str(root)]))
    probe_s = time.perf_counter() - t0
    stages = eval_stages(out)
    log(f"eval wall time {eval_s:.3f} s (CLI, model load included); stages "
        f"(s): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
        + f"; probe CLI {probe_s:.3f} s (reads latents.npz); card "
        f"{smi_name_power()}")

    # the eval's bound is the best epoch's dev bound: same weights, split
    # and MAP estimate (the device tier's fp32 table sums against the host
    # loader's fp64, as phase 4 holds them)
    out_dir = exp / "eval" / "dev"
    metrics = json.loads((out_dir / "metrics.json").read_text())
    best = ckpt.read_checkpoint_meta(ckpt.find_best_checkpoint(exp))
    rec = next(json.loads(line) for line in
               (exp / "metrics.jsonl").read_text().splitlines()
               if json.loads(line)["epoch"] == best["best_epoch"])
    lb_err = abs(metrics["lower_bound"] - rec["val_lower_bound"]) \
        / abs(rec["val_lower_bound"])
    z1p, z2p = probe["z1_speaker_probe"], probe["z2_speaker_probe"]
    log(f"eval dev LB {metrics['lower_bound']!r}, log_qy "
        f"{metrics['log_qy']!r}; training's best epoch ({best['best_epoch']}) "
        f"dev LB {rec['val_lower_bound']!r} (relative difference "
        f"{lb_err:.3e}, tol {TOL_DEV_LB:g}); probe: {probe['num_speakers']} "
        f"speakers, z2 test acc {z2p['test_acc']}, z1 {z1p['test_acc']} "
        f"(chance {z2p['chance']:.4f})")
    if not lb_err <= TOL_DEV_LB:
        raise AssertionError("the eval's dev bound disagrees with the best "
                             "epoch's")
    if probe != metrics["probes"]:
        raise AssertionError("probe and eval report other probe results")

    # the same eval through the plain versions on the card, in the run's
    # bf16 operand mode and in fp32, and through the kernels in fp32. At
    # trained weights a bf16 rounding flip of h moves the latents by more
    # than at the random weights of phase 3 (the absolute error follows the
    # weight scale, phase 2), so each latent is held to a share of its own
    # plain fp32-vs-bf16 gap, as phase 2 holds the kernels' outputs, and the
    # fp32 eval, where no rounding can flip, to the fp32 limit
    exp32 = workdir / "exp_fp32"
    shutil.copytree(exp, exp32, ignore=shutil.ignore_patterns("eval"))
    cfg = json.loads((exp / "config.json").read_text())
    cfg["model"]["lstm_mm_dtype"] = "float32"
    ExperimentConfig.from_dict(cfg).save(exp32 / "config.json")
    evaluate_experiment(exp32, "dev", data_root=root,
                        output_dir=workdir / "eval_fp32", verbose=False)
    with plain_versions():
        for src, dst in ((exp, "eval_plain"), (exp32, "eval_plain32")):
            evaluate_experiment(src, "dev", data_root=root,
                                output_dir=workdir / dst, verbose=False)
    got, got32, ref, ref32 = (load_served(d) for d in (
        out_dir, workdir / "eval_fp32", workdir / "eval_plain",
        workdir / "eval_plain32"))
    errs = {k: float(np.abs(got[k] - ref[k]).max()) for k in got}
    gaps = {k: float(np.abs(ref32[k] - ref[k]).max()) for k in got}
    errs32 = {k: float(np.abs(got32[k] - ref32[k]).max()) for k in got}
    over = {k: int((np.abs(got[k] - ref[k]).max(-1) > TOL_SERVED).sum())
            for k in got}
    log("eval latents, bf16 operands, kernels vs plain versions on the card "
        "(max abs error / plain fp32-vs-bf16 gap): "
        + ", ".join(f"{k} {errs[k]:.3e} / {gaps[k]:.3e} = "
                    f"{errs[k] / gaps[k]:.3f}" for k in got)
        + f" (limit {TOL_BF16_OF_GAP:g} each); rows over the serving limit "
        f"{TOL_SERVED:g}: {over} of {len(got['z1_mu'])} segments and "
        f"{len(got['mu2_map'])} sequences; fp32 operands, kernels vs plain: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs32.items())
        + f" (tol {TOL_FP32:g})")
    if not all(errs[k] <= TOL_BF16_OF_GAP * gaps[k] for k in got):
        raise AssertionError(f"eval latents disagree with the plain "
                             f"versions: {errs} against gaps {gaps}")
    if not all(e <= TOL_FP32 for e in errs32.values()):
        raise AssertionError(f"fp32 eval latents disagree: {errs32}")
    return launches


# -------------------------------------------------------------- phase 4q


QUALITY_REF = Path(__file__).resolve().parent / "misc" / \
    "repro_quality_metrics.jsonl"   # the JAX package's run, one v5e chip
QUALITY_PROBES_REF = {"z2": 0.806, "z1": 0.629}   # PARITY.md, the same run
QUALITY_LB_BAND = 0.1   # epoch 29's dev bound within 10% of the reference's
QUALITY_LOG_QY = (-0.5, 0.0)   # epoch 29's val_log_qy, open interval
QUALITY_Z2_MIN, QUALITY_Z2_MARGIN = 0.6, 0.1   # z2 probe, and over z1's


def phase_quality(workdir: Path) -> None:
    """Phase 4q: ``misc/repro_quality.sh`` through the port on the card:
    ``preprocess`` of 64 synthetic speakers x 5 utterances, ``train``
    (fhvae, 30 epochs, patience 30, seed 0, batch 64, dev batch 256),
    ``eval`` and ``probe`` on dev, with the same flags. The dev bound's
    rise, its level at epoch 29, ``val_log_qy`` and the probes are held to
    limits taken from the JAX package's committed run."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli

    log("== phase 4q: the quality twin of misc/repro_quality.sh through the "
        "port on the card (64 speakers x 5 utterances, 30 epochs, batch 64)")
    ref = [json.loads(line) for line in QUALITY_REF.read_text().splitlines()]
    root = workdir / "quality"
    corpus = ["--synthetic-speakers", "64", "--synthetic-utts", "5"]
    t0 = time.perf_counter()
    run_cli(cli, ["preprocess", "--dataset", "synthetic", "--data-root",
                  str(root), *corpus])
    t_pre = time.perf_counter()
    run_cli(cli, ["train", "--dataset", "synthetic", "--preprocessed",
                  "--data-root", str(root), "--model-type", "fhvae",
                  "--epochs", "30", "--patience", "30", "--seed", "0",
                  *corpus, "--training-batch-size", "64",
                  "--dev-batch-size", "256", "--mvn-path",
                  str(root / "mvn.json"), "--exp-root",
                  str(root / "experiments")])
    t_train = time.perf_counter()
    exp = root / "experiments" / "synthetic_np_fbank" / "fhvae_e30_p30_a10.0"
    run_cli(cli, ["eval", str(exp), "--set-name", "dev", "--data-root",
                  str(root)])
    probe = json.loads(run_cli(cli, ["probe", str(exp), "--set-name", "dev",
                                     "--data-root", str(root)]))
    t_end = time.perf_counter()

    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    log("epoch: dev LB port / JAX v5e, val_log_qy port / JAX v5e")
    for r, q in zip(recs, ref):
        log(f"  {r['epoch']:2d}: {r['val_lower_bound']:.4f} / "
            f"{q['val_lower_bound']:.4f}, {r['val_log_qy']:.4f} / "
            f"{q['val_log_qy']:.4f}")
    z1 = probe["z1_speaker_probe"]["test_acc"]
    z2 = probe["z2_speaker_probe"]["test_acc"]
    log(f"dev speaker probe ({probe['num_speakers']} speakers, chance "
        f"{probe['z2_speaker_probe']['chance']:.4f}): z2 {z2!r} / "
        f"{QUALITY_PROBES_REF['z2']}, z1 {z1!r} / {QUALITY_PROBES_REF['z1']} "
        f"(port / JAX v5e)")
    log(f"phase 4q wall time {t_end - t0:.1f} s: preprocess "
        f"{t_pre - t0:.1f} s, train {t_train - t_pre:.1f} s (30 epochs, "
        f"{sum(r['train_steps'] for r in recs)} steps), eval and probe "
        f"{t_end - t_train:.1f} s; card {smi_name_power()}")

    if [r["epoch"] for r in recs] != list(range(30)):
        raise AssertionError(f"epochs recorded: {[r['epoch'] for r in recs]}")
    lb0, lb29 = recs[0]["val_lower_bound"], recs[29]["val_lower_bound"]
    ref0, ref29 = ref[0]["val_lower_bound"], ref[29]["val_lower_bound"]
    log_qy = recs[29]["val_log_qy"]
    checks = {
        f"dev LB rise {lb29 - lb0:.1f} >= half the reference's "
        f"{(ref29 - ref0) / 2:.1f}": lb29 - lb0 >= (ref29 - ref0) / 2,
        f"epoch 29 dev LB {lb29:.1f} within {QUALITY_LB_BAND:g} of "
        f"{ref29:.1f}": abs(lb29 - ref29) <= QUALITY_LB_BAND * abs(ref29),
        f"epoch 29 val_log_qy {log_qy:.4f} in {QUALITY_LOG_QY}":
            QUALITY_LOG_QY[0] < log_qy < QUALITY_LOG_QY[1],
        f"z2 probe {z2:.4f} >= {QUALITY_Z2_MIN} and >= z1 {z1:.4f} + "
        f"{QUALITY_Z2_MARGIN}": z2 >= QUALITY_Z2_MIN
            and z2 >= z1 + QUALITY_Z2_MARGIN,
    }
    for what, ok in checks.items():
        log(f"  {'ok' if ok else 'MISSED'}: {what}")
    if not all(checks.values()):
        raise AssertionError("the port's quality twin missed a limit")


# --------------------------------------------------------------- phase 5


def mesh_entries():
    from pytorch_scalablefhvae_tpu_torch.ops import discriminative

    return (*train_entries(), discriminative.discriminative_log_qy_sharded,
            discriminative.discriminative_log_qy_sharded_bwd)


def _timed_all_reduces(mesh_module):
    """Wrap ``torch.distributed.all_reduce`` (as the mesh calls it) with a
    pair of CUDA events and the host clock; returns ``(records, restore)``."""
    dist = mesh_module.dist
    real, records = dist.all_reduce, []

    def timed(t, *a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        out = real(t, *a, **kw)
        ev[1].record()
        records.append((ev, time.perf_counter() - t0, t.numel() * 4))
        return out

    dist.all_reduce = timed

    def restore():
        dist.all_reduce = real

    return records, restore


def _mesh_rank(workdir: str) -> int:
    """One rank of phase 5's ``2,2`` mesh (its process group is up)."""
    import torch.distributed as dist

    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.ops import discriminative as disc
    from pytorch_scalablefhvae_tpu_torch.parallel import mesh as mesh_module
    from pytorch_scalablefhvae_tpu_torch.parallel.sharded_step import (
        make_sharded_train_step,
    )
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
    )
    from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device

    work = Path(workdir)
    rank = dist.get_rank()
    dev = resolve_device(f"cuda:{torch.cuda.current_device()}")
    mesh = mesh_module.make_mesh(MESH, dev)

    def say(*parts):
        if rank == 0:
            log(*parts)

    def agree(ok: bool, what: str):
        """Raise on every rank when any rank saw a failure."""
        bad = torch.tensor([0.0 if ok else 1.0], device=dev)
        dist.all_reduce(bad)
        if float(bad):
            raise AssertionError(f"{what} (on {int(bad)} of the ranks)")

    # (a) the entry through the real groups against its plain version and
    # against the plain single table, on this rank's rows
    g = torch.Generator().manual_seed(5)
    pz2_logvar = float(np.log(0.5 ** 2))
    n_pad = mesh_module.padded_num_seqs(N_TABLE, MESH[1])
    table = torch.zeros((n_pad, Z))
    table[:N_TABLE] = torch.randn((N_TABLE, Z), generator=g)
    seq = torch.randint(0, N_TABLE, (B_TRAIN,), generator=g)
    z2 = table[seq] + 0.5 * torch.randn((B_TRAIN, Z), generator=g)
    gq = torch.randn((B_TRAIN,), generator=g)
    rows = mesh.local_rows(B_TRAIN)
    shard = table[mesh.table_rows(n_pad)].to(dev)
    outs = {}
    for name in ("discriminative_log_qy_sharded",
                 "discriminative_log_qy_sharded_reference"):
        z = z2[rows].to(dev).requires_grad_()
        t = shard.clone().requires_grad_()
        out = getattr(disc, name)(z, t, seq[rows].to(dev), pz2_logvar, mesh,
                                  N_TABLE)
        outs[name] = (out.detach(), *torch.autograd.grad(
            out, (z, t), gq[rows].to(dev)))
    whole = disc.discriminative_log_qy_reference(
        z2[rows].to(dev), table[:N_TABLE].to(dev), seq[rows].to(dev),
        pz2_logvar)
    got, want = outs.values()
    errs = (max_err(got[0], want[0]), max_err(got[0], whole),
            rel_norm(got[1:], want[1:]))
    say(f"kernel #7's entry through the process groups of the {MESH} mesh "
        f"(rank 0's view: 512 rows, shard of {shard.shape[0]}): log_qy "
        f"max_abs_err vs its plain version {errs[0]:.3e}, vs the plain "
        f"single table {errs[1]:.3e} (tol {TOL_SHARDED:g}); dz2, dmu2 "
        f"rel-norm err {errs[2]:.3e} (tol {TOL_SHARDED:g})")
    agree(all(e <= TOL_SHARDED for e in errs),
          "the sharded entry disagrees with its plain version")

    # (b) the first three steps against the single-device steps
    ref = torch.load(work / "single_steps.pt")
    cfg = ExperimentConfig.load(work / "config.json")
    model = mesh_module.shard_model(seeded_model(cfg).cpu(), mesh).to(dev)
    state = create_train_state(model)
    step = make_sharded_train_step(state, make_optimizer(1e-3, 0.95, 0.999),
                                   10.0, mesh)
    batches = [tuple(t.to(dev) for t in b) for b in ref["batches"]]
    for e in mesh_entries():
        e.launches = 0
    losses = [float(step(*b)["loss"]) for b in batches[:3]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    params = dict(model.named_parameters())
    params["mu2_table"], = mesh_module.gather_table_rows(
        mesh, params["mu2_table"])
    params["mu2_table"] = params["mu2_table"][:N_TABLE]
    upd_err = max(float(
        (params[n].detach().cpu() - ref["params"][n]).norm()
        / (ref["params"][n] - ref["start"][n]).norm().clamp_min(1e-30))
        for n in ref["start"])
    equal = mesh_module.replicas_equal(mesh, [
        p for n, p in model.named_parameters()
        if not mesh_module.is_sharded(n, p)])
    counts = {e.__name__: e.launches for e in mesh_entries()}
    say(f"first 3 steps on the {MESH} mesh vs one device: losses {losses} vs "
        f"{ref['losses']} (max rel diff {loss_err:.3e}, tol "
        f"{TOL_TRAIN_LOSS:g}); parameter updates differ by {upd_err:.3e} of "
        f"their norm (tol {TOL_TRAIN_UPDATE:g}); replicated parameters equal "
        f"bit for bit on the ranks: {equal}; rank 0's launches {counts}")
    agree(loss_err <= TOL_TRAIN_LOSS and upd_err <= TOL_TRAIN_UPDATE and equal
          and counts["discriminative_log_qy_sharded"] == 3
          and counts["discriminative_log_qy_sharded_bwd"] == 3
          and counts["discriminative_log_qy_bwd"] == 0,
          "the mesh's first train steps disagree with one device's")

    # (c) a step's time and its all-reduces: four processes time-slicing
    # one card, reported as such
    records, restore = _timed_all_reduces(mesh_module)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[3:]:
            step(*b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(batches[3:]) * 1e3
    finally:
        restore()
    n_steps = len(batches[3:])
    dev_ms = sum(a.elapsed_time(b) for (a, b), _, _ in records) / n_steps
    host_ms = sum(h for _, h, _ in records) / n_steps * 1e3
    biggest = max(nb for _, _, nb in records)
    say(f"{MESH} mesh, gloo, four processes time-slicing one card (no "
        f"multi-GPU throughput): {n_steps} steps at batch {B_TRAIN}, "
        f"{wall:.3f} ms/step host wall on rank 0; "
        f"{len(records) // n_steps} all-reduces per step take "
        f"{dev_ms:.3f} ms/step between CUDA events and {host_ms:.3f} ms/step "
        f"on the host clock; the largest moves {biggest / 1e6:.2f} MB")
    del state, model, step, batches
    torch.cuda.empty_cache()

    # (d) one epoch through the CLI, this process being a launched rank
    reset_counts(mesh_entries())
    args = json.loads((work / "train_args.json").read_text())
    rc = cli(args + ["--exp-root", str(work / "experiments_mesh"), "--mesh",
                     f"{MESH[0]},{MESH[1]}", "--distributed",
                     "--dist-backend", "gloo", "--epochs", "1"])
    (work / f"rank{rank}.json").write_text(json.dumps(
        {"rc": rc, "launches": {e.__name__: e.launches
                                for e in mesh_entries()},
         "launches_tc": tensor_core_counts(mesh_entries())}))
    return rc


def single_device_steps(cfg, root: Path, work: Path, n_cmp: int = 3,
                        n_more: int = 8) -> None:
    """The first ``n_cmp`` steps on one device through the kernels: their
    batches (and ``n_more`` more, for timing), losses and parameters, saved
    for the mesh's ranks to compare with."""
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        train_step,
    )

    batches, model = first_batches_and_model(cfg, root, n_cmp + n_more)
    start = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    state = create_train_state(model)
    opt = make_optimizer(1e-3, 0.95, 0.999)
    losses = [float(train_step(state, opt, *b, 10.0)["loss"])
              for b in batches[:n_cmp]]
    torch.save({"batches": [tuple(t.cpu() for t in b) for b in batches],
                "losses": losses, "start": start,
                "params": {n: p.detach().cpu()
                           for n, p in model.named_parameters()}},
               work / "single_steps.pt")
    cfg.save(work / "config.json")


def read_metrics(exp_root: Path, epochs: int) -> list[dict]:
    path = (exp_root / "synthetic_np_fbank" / f"fhvae_e{epochs}_p10_a10.0"
            / "metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def phase_mesh(workdir: Path, cfg, single_epoch0: dict | None) -> dict:
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.parallel.launch import run_ranks
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    log(f"== phase 5: sfhvae train --mesh {MESH[0]},{MESH[1]} --dist-backend "
        f"gloo: {MESH[0] * MESH[1]} ranks sharing the card, batch {B_TRAIN} "
        f"({B_TRAIN // MESH[0]} rows per rank), {N_TABLE} mu2 rows "
        f"({N_TABLE // MESH[1]} per rank)")
    root = workdir / "data"
    args = ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--mvn-path", cfg.data.mvn_path]
    (workdir / "train_args.json").write_text(json.dumps(args))
    if single_epoch0 is None:
        run_cli(cli, args + ["--exp-root", str(workdir / "experiments_one"),
                             "--epochs", "1"])
        single_epoch0 = read_metrics(workdir / "experiments_one", 1)[0]
    single_device_steps(cfg, root, workdir)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    world = MESH[0] * MESH[1]
    codes = run_ranks(_mesh_rank, world, (str(workdir),), backend="gloo",
                      device="cuda", timeout_s=120, join_timeout_s=600)
    log(f"the {world} ranks exited with {codes} after "
        f"{time.perf_counter() - t0:.1f} s")
    if codes != [0] * world:
        raise AssertionError(f"the mesh's ranks exited with {codes}")
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(world)]
    rec = read_metrics(workdir / "experiments_mesh", 1)[0]
    steps = int(rec["train_steps"])
    errs = {k: abs(rec[k] - single_epoch0[k]) / abs(single_epoch0[k])
            for k in ("train_loss", "val_lower_bound", "val_log_qy")}
    log(f"epoch 0 on the {MESH} mesh vs one device: train loss "
        f"{rec['train_loss']!r} vs {single_epoch0['train_loss']!r}, dev LB "
        f"{rec['val_lower_bound']!r} vs {single_epoch0['val_lower_bound']!r} "
        f"(relative differences {errs}, tol {TOL_MESH_EPOCH:g}, log_qy "
        f"{TOL_MESH_LOG_QY:g}); {steps} "
        f"steps in {rec['train_seconds']:.3f} s = "
        f"{1e3 * rec['train_seconds'] / steps:.2f} ms/step, "
        f"{rec['train_segments_per_sec']:.1f} segments/s with four processes "
        f"time-slicing one card (one process on it: "
        f"{single_epoch0['train_segments_per_sec']:.1f}); card "
        f"{smi_name_power()}")
    if not all(e <= (TOL_MESH_LOG_QY if k == "val_log_qy" else TOL_MESH_EPOCH)
               for k, e in errs.items()):
        raise AssertionError(f"the mesh's epoch disagrees with one device's: "
                             f"{errs}")
    for r, info in enumerate(ranks):
        c = info["launches"]
        log(f"rank {r} launches during the mesh epoch (dev pass included): "
            f"{c}; LSTM entries through the tensor-core form: "
            f"{info['launches_tc']}")
        check_tensor_core(c, info["launches_tc"], f"the mesh epoch, rank {r}")
        if not (c["discriminative_log_qy_sharded"] == steps
                and c["discriminative_log_qy_sharded_bwd"] == steps
                and c["discriminative_log_qy_bwd"] == 0
                and c["windowed_chunk_gather"] == 0
                and c["discriminative_log_qy"] > 0
                and min(c["lstm2_tm_proj"], c["lstm2_tm"],
                        c["lstm2_tm_proj_bwd"], c["lstm2_tm_bwd"]) > 0):
            raise AssertionError(
                f"rank {r}: kernel #7 must be launched once per step forward "
                f"and backward, #6 and #8 never, the others at least once")

    # (e) the checkpoint moves to another mesh and to one device
    exp = workdir / "experiments_mesh" / "synthetic_np_fbank" \
        / "fhvae_e1_p10_a10.0"
    first = exp / "fhvae_synthetic_np_fbank_e0.npz"
    with np.load(first) as z:
        rows = z["mu2_table"].shape[0], z["adam_mu.mu2_table"].shape[0]
    resumed = {}
    for shape in ((1, 2), (1, 1)):
        copy_dir = workdir / f"resume_{shape[0]}_{shape[1]}"
        shutil.copytree(exp, copy_dir)
        run_cli(cli, ["train", "--dataset", "synthetic", "--preprocessed",
                      "--data-root", str(root), "--dist-backend", "gloo",
                      "--continue-from", str(copy_dir / first.name),
                      "--resume-override", "epochs=2", "--resume-override",
                      f"mesh_shape={shape[0]},{shape[1]}"])
        rec1 = [json.loads(line) for line in
                (copy_dir / "metrics.jsonl").read_text().splitlines()][-1]
        meta = ckpt.read_checkpoint_meta(
            copy_dir / "fhvae_synthetic_np_fbank_e1.npz")
        resumed[shape] = rec1
        log(f"epoch 1 resumed from the {MESH} checkpoint on mesh {shape}: "
            f"train loss {rec1['train_loss']!r}, dev LB "
            f"{rec1['val_lower_bound']!r}, step {meta['step']}, "
            f"{1e3 * rec1['train_seconds'] / rec1['train_steps']:.2f} "
            f"ms/step")
        if not (rec1["epoch"] == 1 and meta["step"] == 2 * steps
                and np.isfinite(rec1["train_loss"])
                and rec1["train_loss"] < rec["train_loss"]):
            raise AssertionError(f"the resume on mesh {shape} did not "
                                 f"continue the run")
    a, b = resumed[(1, 2)], resumed[(1, 1)]
    gap = abs(a["train_loss"] - b["train_loss"]) / abs(b["train_loss"])
    log(f"the checkpoint holds {rows[0]} table rows and {rows[1]} moment "
        f"rows; the two resumed epochs' train losses differ by {gap:.3e} "
        f"relative (tol {TOL_MESH_EPOCH:g})")
    if rows != (N_TABLE, N_TABLE) or not gap <= TOL_MESH_EPOCH:
        raise AssertionError("the mesh checkpoint does not resume the same "
                             "on another mesh and on one device")

    return ranks[0]["launches"]


# ------------------------------------------------------------- phase 5t

TIERS_BUDGET = 256 << 20   # 5t: auto streams phase 4's 370 MB store; the
                           # budget x 2 row-sharded stages it whole
TIERS_CAP = 20             # 5t: steps of the auto run and the device pair
TIERS_INT8_CAP = 40        # 5t: steps of the int8 pair (~4 chunks of ~33)


def _mesh_runs_rank(workdir: str) -> int:
    """One rank of a ``2,2`` gloo mesh, started once for the gloo runs of
    phases 5t, 5k (b) and 5h (a) (:func:`gloo_mesh_runs`): every run of
    ``gloo_runs.json`` through the CLI in turn, and for each run this rank's
    launches (counted from 0 just before it and read just after), its wall
    seconds, the waits at each chunk switch of its streamed epochs
    (``switch_waits()``) and the seconds each checkpoint save and flush
    held the loop, into ``gloo_rank<r>.json``."""
    import torch.distributed as dist

    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.ops import stage_gather
    from pytorch_scalablefhvae_tpu_torch.train import loop

    work = Path(workdir)
    rank = dist.get_rank()
    runs = json.loads((work / "gloo_runs.json").read_text())
    real, current, waits = loop.run_stream_epoch, [None], {}

    def spy(state, optimizer, source, *args, **kw):
        try:
            return real(state, optimizer, source, *args, **kw)
        finally:
            waits.setdefault(current[0], []).append(source.switch_waits())

    out = {"texts": {}, "wall": {}, "launches": {}, "launches_tc": {},
           "saves": {}, "stage_gathers": {}}
    gather = stage_gather.stage_gather
    loop.run_stream_epoch = spy
    try:
        for name, args in runs.items():
            current[0] = name
            reset_counts(mesh_entries())
            gather.launches = 0
            t0 = time.perf_counter()
            with timed_saves(out["saves"].setdefault(name, [])):
                out["texts"][name] = run_cli(cli, args + [
                    "--distributed", "--dist-backend", "gloo"])
            out["wall"][name] = time.perf_counter() - t0
            out["launches"][name] = {e.__name__: e.launches
                                     for e in mesh_entries()}
            out["launches_tc"][name] = tensor_core_counts(mesh_entries())
            out["stage_gathers"][name] = gather.launches
    finally:
        loop.run_stream_epoch = real
    out["waits"] = waits
    (work / f"gloo_rank{rank}.json").write_text(json.dumps(out))
    return 0


def sum_counts(per_run: dict) -> dict:
    """Launch counts (entry name -> launches) added up over runs."""
    total: dict = {}
    for counts in per_run.values():
        for entry, n in counts.items():
            total[entry] = total.get(entry, 0) + n
    return total


def gloo_mesh_runs(workdir: Path, cfg, phases: list) -> dict:
    """Four gloo ranks sharing the card (``--mesh 2,2``), started once for
    the CLI runs of every mesh phase in ``phases`` (of 5t, 5k and 5h: the
    runs of :func:`tiers_runs`, :func:`mesh_k_runs` and
    :func:`hier_mesh_runs`, prepared first): each rank runs them all in
    turn (:func:`_mesh_runs_rank`). Returns, per phase, its preparation's
    context and what rank 0 saw of its runs (``texts``, ``wall``,
    ``launches``, ``launches_tc`` and ``waits``, keyed by the run's
    name)."""
    from pytorch_scalablefhvae_tpu_torch.ops import _build
    from pytorch_scalablefhvae_tpu_torch.parallel.launch import run_ranks

    prepare = {"5t": tiers_runs, "5k": mesh_k_runs, "5h": hier_mesh_runs,
               "4o": orbax_mesh_runs}
    t0 = time.perf_counter()
    prepared = {phase: prepare[phase](workdir, cfg) for phase in phases}
    parts = {phase: runs for phase, (runs, _) in prepared.items()}
    log(f"the gloo runs of phases {', '.join(phases)} prepared in "
        f"{time.perf_counter() - t0:.1f} s")
    work = workdir / "gloo"
    work.mkdir()
    runs = {f"{phase} {name}": argv for phase, named in parts.items()
            for name, argv in named.items()}
    (work / "gloo_runs.json").write_text(json.dumps(runs))
    _build.build()  # once, here: the ranks would each run nvcc otherwise
    world = MESH[0] * MESH[1]
    t0 = time.perf_counter()
    codes = run_ranks(_mesh_runs_rank, world, (str(work),), backend="gloo",
                      device="cuda", timeout_s=120, join_timeout_s=900)
    wall = time.perf_counter() - t0
    if codes != [0] * world:
        raise AssertionError(f"the gloo mesh's ranks exited with {codes}")
    info = json.loads((work / "gloo_rank0.json").read_text())
    out = {}
    for phase, named in parts.items():
        out[phase] = {key: {name: info[key][f"{phase} {name}"]
                            for name in named
                            if f"{phase} {name}" in info[key]}
                      for key in ("texts", "wall", "launches", "launches_tc",
                                  "waits", "saves", "stage_gathers")}
    by_phase = {phase: round(sum(o["wall"].values()), 1)
                for phase, o in out.items()}
    log(f"the {world} gloo ranks ran {len(runs)} CLI runs of phases "
        f"{', '.join(parts)} in one launch and exited with {codes} after "
        f"{wall:.1f} s: the runs took {by_phase} s by phase, the ranks' "
        f"start and exit {wall - sum(by_phase.values()):.1f} s; card "
        f"{smi_name_power()}")
    return {phase: (ctx, out[phase]) for phase, (_, ctx) in prepared.items()}


def mid_epoch(exp: Path, stop: int) -> dict:
    """The ``mid_epoch`` cursor of a run stopped at step ``stop`` of its
    first epoch."""
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    return ckpt.read_checkpoint_meta(
        exp / f"fhvae_synthetic_np_fbank_e0s{stop}.npz")["mid_epoch"]


def tiers_runs(workdir: Path, cfg):
    """Phase 5t's runs for :func:`gloo_mesh_runs` on phase 4's corpus
    (its packed store cached for every rank) and what the checks need."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    root, work = workdir / "data", workdir / "tiers"
    work.mkdir()
    pack = ["--pack-cache-dir", str(workdir / "tiers_pack")]
    t0 = time.perf_counter()
    cached = cfg.replace(data=dataclasses.replace(cfg.data,
                                                  pack_cache_dir=pack[1]))
    loader, _ = build_loaders(cached, root, True)
    nbytes = loader.dataset.store.data.nbytes
    del loader
    batches = stream_chunk_batches(cached, root)
    c = next(i for i, n in enumerate(batches) if i and n >= 2)
    stop = sum(batches[:c]) + 1
    log(f"5t: the packed stores cached in {time.perf_counter() - t0:.1f} s "
        f"({nbytes / 1e6:.1f} MB of training rows); epoch 0's chunks at "
        f"{STREAM_BUDGET // 4 >> 20} MiB take {batches} batches, the stopped "
        f"run stops one batch into chunk {c}, at step {stop}")
    chunk = ["--stream-chunk-bytes", str(STREAM_BUDGET // 4)]
    stream = ["--data-placement", "stream", *chunk]
    shard = "--shard-device-store"
    flags = {
        "auto": ["--device-store-max-bytes", str(TIERS_BUDGET),
                 "--max-steps", str(TIERS_CAP)],
        "auto sharded": ["--device-store-max-bytes", str(TIERS_BUDGET), shard,
                         "--max-steps", str(TIERS_CAP)],
        # the dev split on the host in both: no budget beside the store
        "device": ["--data-placement", "device", "--device-store-max-bytes",
                   str(nbytes), "--max-steps", str(TIERS_CAP)],
        "stream float32": stream,
        "stream float32 sharded": [*stream, shard],
        "stream int8": [*stream, "--transfer-dtype", "int8", "--max-steps",
                        str(TIERS_INT8_CAP)],
        "stream int8 sharded": [*stream, "--transfer-dtype", "int8", shard,
                                "--max-steps", str(TIERS_INT8_CAP)],
        "stopped": [*stream, shard, "--max-steps", str(stop)],
    }
    exp = {name: work / name.replace(" ", "_") for name in flags}
    mesh = ["--mesh", f"{MESH[0]},{MESH[1]}"]
    runs = {name: train_args(cfg, root, exp[name], *mesh, *pack, *f,
                             "--epochs", "1")
            for name, f in flags.items()}
    runs["resumed"] = ["train", "--dataset", "synthetic", "--preprocessed",
                       "--data-root", str(root), "--continue-from",
                       str(run_dir(exp["stopped"], 1)
                           / f"fhvae_synthetic_np_fbank_e0s{stop}.npz"),
                       "--resume-override", "max_steps=0"]
    return runs, {"exp": exp, "stop": stop, "pack": pack}


def phase_mesh_tiers(workdir: Path, cfg, ctx: dict, info: dict) -> dict:
    """Phase 5t: the data tiers of a ``2,2`` mesh (four gloo ranks sharing
    the card; the runs of :func:`tiers_runs`, run by
    :func:`gloo_mesh_runs`) on phase 4's corpus at the CLI defaults:
    ``auto`` over ``TIERS_BUDGET`` streams and with
    ``--shard-device-store`` stages the store row-sharded (the lines rank 0
    prints); sharded against replicated bit for bit on the device tier and
    on the streamed tier in float32 (a whole epoch, dev split staged) and
    int8 (chunks of ``STREAM_BUDGET // 4``); the sharded streamed epoch
    against the single-device streamed epoch; that run stopped by
    ``--max-steps`` inside a chunk and resumed, against the run never
    stopped. Returns rank 0's launches over the phase's mesh runs
    (``mesh_tiers``)."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli

    log(f"== phase 5t: sfhvae train --mesh {MESH[0]},{MESH[1]} "
        f"--dist-backend gloo on the data tiers: auto over the budget, "
        f"--shard-device-store, float32 and int8 streamed chunks (the runs "
        f"in the shared gloo launch: {sum(info['wall'].values()):.1f} s)")
    t_phase = time.perf_counter()
    root, work = workdir / "data", workdir / "tiers"
    exp, stop, pack = ctx["exp"], ctx["stop"], ctx["pack"]
    chunk = ["--stream-chunk-bytes", str(STREAM_BUDGET // 4)]
    stream = ["--data-placement", "stream", *chunk]

    # the single-device streamed epoch
    one = work / "one"
    t0 = time.perf_counter()
    run_cli(cli, train_args(cfg, root, one, *pack, *stream, "--epochs", "1"))
    one_rec, = metrics_of(one)
    log(f"5t: the single-device streamed epoch in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    texts, wall = info["texts"], info["wall"]

    # auto over the budget: streamed, and staged whole row-sharded
    mb = TIERS_BUDGET / 1e6
    want = {"auto": (f"over the device-store budget of {mb:.1f} MB; "
                     f"streaming it", "Training data streams through the "
                     "device"),
            "auto sharded": (f"within the device-store budget of "
                             f"{2 * mb:.1f} MB ({mb:.1f} MB a device x 2, "
                             f"row-sharded over the model axis); staging it "
                             f"whole", "MB staged, row-sharded)")}
    for name, lines in want.items():
        said = [line for line in texts[name].splitlines()
                if "data placement auto" in line or "Training data" in line]
        log(f"5t {name}, rank 0 said: {said}")
        if not all(w in texts[name] for w in lines):
            raise AssertionError(f"5t {name}: the tier lines {said} are not "
                                 f"{lines}")

    # sharded against replicated, bit for bit
    def same_steps(name: str, a: str, b: str, steps: int) -> None:
        differ = differing_arrays(
            run_dir(exp[a], 1) / f"fhvae_synthetic_np_fbank_e0s{steps}.npz",
            run_dir(exp[b], 1) / f"fhvae_synthetic_np_fbank_e0s{steps}.npz")
        ma, mb_ = mid_epoch(run_dir(exp[a], 1), steps), \
            mid_epoch(run_dir(exp[b], 1), steps)
        log(f"5t {name}, {steps} steps, sharded vs replicated: loss sums "
            f"{ma['loss_sum']!r} vs {mb_['loss_sum']!r}; checkpoint arrays "
            f"differing {differ}; {1e3 * ma['elapsed_s'] / steps:.2f} vs "
            f"{1e3 * mb_['elapsed_s'] / steps:.2f} ms/step")
        if differ or ma["loss_sum"] != mb_["loss_sum"]:
            raise AssertionError(f"5t {name}: sharded and replicated differ")

    same_steps("device tier", "auto sharded", "device", TIERS_CAP)
    equal_runs("5t streamed float32 epoch, sharded vs replicated",
               run_dir(exp["stream float32 sharded"], 1),
               run_dir(exp["stream float32"], 1), [0])
    same_steps("streamed int8", "stream int8 sharded", "stream int8",
               TIERS_INT8_CAP)
    for name in ("stream float32", "stream float32 sharded", "stream int8",
                 "stream int8 sharded"):
        m = re.search(r"\((\d+) chunks of ([\d.]+) MB in \w+, double-buffered"
                      r"[^;]*; ([\d.]+) MB over the link an epoch a rank",
                      texts[name])
        w = info["waits"][name][0]
        log(f"5t {name}: {m[1]} chunks of {m[2]} MB, {m[3]} MB over each "
            f"rank's link an epoch; at its {len(w)} chunk switches rank 0's "
            f"host waited {[round(h * 1e3, 3) for h, _ in w]} ms and its "
            f"compute stream {[ms and round(ms, 3) for _, ms in w]} ms; run "
            f"{wall[name]:.1f} s")

    # the sharded streamed epoch against one device's
    rec, = metrics_of(exp["stream float32 sharded"])
    errs = {k: abs(rec[k] - one_rec[k]) / abs(one_rec[k])
            for k in ("train_loss", "val_lower_bound", "val_log_qy")}
    log(f"5t: the streamed epoch on the {MESH} mesh, row-sharded, vs one "
        f"device: train loss {rec['train_loss']!r} vs "
        f"{one_rec['train_loss']!r}, dev LB {rec['val_lower_bound']!r} vs "
        f"{one_rec['val_lower_bound']!r} (relative differences {errs}, tol "
        f"{TOL_MESH_EPOCH:g}, log_qy {TOL_MESH_LOG_QY:g}); "
        f"{1e3 * rec['train_seconds'] / rec['train_steps']:.2f} ms/step "
        f"with four processes time-slicing one card (one process: "
        f"{1e3 * one_rec['train_seconds'] / one_rec['train_steps']:.2f}); "
        f"card {smi_name_power()}")
    if not all(e <= (TOL_MESH_LOG_QY if k == "val_log_qy" else TOL_MESH_EPOCH)
               for k, e in errs.items()):
        raise AssertionError(f"5t: the streamed mesh epoch disagrees with "
                             f"one device's: {errs}")

    # stopped inside a chunk and resumed, against the run never stopped
    stopped = run_dir(exp["stopped"], 1)
    left = step_checkpoints(stopped)
    if left:
        raise AssertionError(f"5t: step checkpoints outlived the epoch: "
                             f"{[p.name for p in left]}")
    check_resumed("5t streamed, row-sharded, stopped at step "
                  f"{stop} and resumed", stopped,
                  run_dir(exp["stream float32 sharded"], 1), [0])

    # rank 0's launches: #7 once a step, forward and backward
    steps = (3 * TIERS_CAP + 2 * TIERS_INT8_CAP
             + 3 * int(rec["train_steps"]))
    c, tc = sum_counts(info["launches"]), sum_counts(info["launches_tc"])
    log(f"5t: rank 0's launches over the phase's mesh runs ({steps} steps, "
        f"dev passes included), each run counted from 0: {c}; LSTM entries "
        f"through the tensor-core form: {tc}")
    check_tensor_core(c, tc, "phase 5t, rank 0")
    if not (c["discriminative_log_qy_sharded"] == steps
            and c["discriminative_log_qy_sharded_bwd"] == steps
            and c["discriminative_log_qy_bwd"] == 0
            and c["windowed_chunk_gather"] == 0
            and c["discriminative_log_qy"] > 0
            and min(c["lstm2_tm_proj"], c["lstm2_tm"],
                    c["lstm2_tm_proj_bwd"], c["lstm2_tm_bwd"]) > 0):
        raise AssertionError("5t: kernel #7 must be launched once per step "
                             "forward and backward, #6 and #8 never, the "
                             "others at least once")
    log(f"phase 5t took {time.perf_counter() - t_phase:.1f} s; card "
        f"{smi_name_power()}")
    return c


# ------------------------------------------------------------- phase 5k

MESH_K = 8          # 5k: steps per dispatch on a mesh
MESH_K_CAP = 29     # 5k (b): --max-steps of the device-tier pairs: three
                    # dispatches of 8, then 5 steps clamped to eager ones
MESH_K_STOP = 13    # 5k (b): the stopped run: a dispatch and 5 clamped
                    # steps; resumed to MESH_K_CAP in two dispatches
MESH_K_CHUNKS = 3   # 5k (b): the streamed pair runs this many chunks of
                    # epoch 0 and one step of the next
# 5k (a): the kernel that each call of an entry launches once in the
# tensor-core forms on a mesh step, and the entries that launch it
MESH_TRACE_KERNELS = {
    "lstm2_fwd_xproj_kernel": ("lstm2_tm_proj",),
    "lstm2_fwd_chain_kernel": ("lstm2_tm_proj", "lstm2_tm"),
    "lstm2_bwd_chain_kernel": ("lstm2_tm_proj_bwd", "lstm2_tm_bwd"),
    "disc_fwd_kernel": ("discriminative_log_qy_sharded",),
    "disc_bwd_fused_kernel": ("discriminative_log_qy_sharded_bwd",),
}


def _mesh_k_nccl_rank(workdir: str, data_root: str, shape: tuple) -> int:
    """A rank of an NCCL mesh of ``shape`` (phase 5k (a): one rank, ``1,1``;
    5n: ``2,2`` on four cards). First 12 dispatches of ``MESH_K`` steps on
    epoch 0's staged plan, eager on the mesh and replayed from a mesh
    bundle, each from the seeded model, the last 10 of each under
    torch.profiler (:func:`profiled_dispatches`), the two states compared
    bit for bit; then ``--epochs 1`` through the CLI at K = 1 and K =
    ``MESH_K``, each counted alone. Writes ``nccl_k_rank<r>.json``."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.parallel import mesh as mesh_module
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        PlanInputs,
        device_train_step,
    )
    from pytorch_scalablefhvae_tpu_torch.train.graphs import StepBundle
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
    )

    work, root = Path(workdir), Path(data_root)
    cfg = ExperimentConfig.load(work / "config.json")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_module.make_mesh(shape, dev)
    loader, source, plan, arrays = staged_epoch0(cfg, root)
    rows, seg_len, k = loader.batch_size, cfg.data.seg_len, MESH_K
    n_disp = plan.n_batches // k
    opt = make_optimizer(1e-3, 0.95, 0.999)
    states = [create_train_state(mesh_module.shard_model(seeded_model(cfg),
                                                         mesh))
              for _ in range(2)]

    def eager(d: int) -> torch.Tensor:
        return torch.stack([device_train_step(
            states[0], opt, source.data, arrays, ((d % n_disp) * k + i) * rows,
            plan.n_real, 10.0, batch_size=rows, seg_len=seg_len,
            mesh=mesh)["loss"] for i in range(k)])

    inputs = PlanInputs(source.data, rows, seg_len, mesh)
    inputs.load_plan(arrays, plan.n_real)
    bundle = StepBundle(states[1], opt, 10.0, k, inputs, dev, mesh)

    def replayed(d: int) -> torch.Tensor:
        inputs.set_base((d % n_disp) * k * rows)
        return bundle()["loss"].clone()

    out = {"eager": profiled_dispatches(eager, k),
           "replayed": profiled_dispatches(replayed, k, MESH_TRACE_KERNELS),
           "replays": bundle.replays, "backend": mesh.backend}
    for d in range(out["eager"]["dispatches"],
                   out["replayed"]["dispatches"]):
        eager(d)  # as many steps as the bundle took
    torch.cuda.synchronize()
    a, b = states
    out["differ"] = [n for n in a.params()
                     if not (torch.equal(a.params()[n], b.params()[n])
                             and torch.equal(a.mu[n], b.mu[n])
                             and torch.equal(a.nu[n], b.nu[n]))]
    out["steps"] = [a.step, b.step]
    del a, b, states, bundle, inputs, loader, source, arrays
    torch.cuda.empty_cache()

    args = json.loads((work / "train_args.json").read_text())
    for kk in (1, k):
        reset_counts(mesh_entries())
        out[f"text_k{kk}"] = run_cli(cli, args + [
            "--exp-root", str(work / f"nccl_k{kk}"), "--mesh",
            f"{shape[0]},{shape[1]}", "--distributed", "--dist-backend",
            "nccl", "--epochs", "1", "--steps-per-dispatch", str(kk)])
        out[f"launches_k{kk}"] = {e.__name__: e.launches
                                  for e in mesh_entries()}
        out[f"launches_tc_k{kk}"] = tensor_core_counts(mesh_entries())
    (work / f"nccl_k_rank{mesh.rank}.json").write_text(json.dumps(out))
    return 0


def _nccl_rank(jobs: str, shape: tuple) -> int:
    """A rank of an NCCL mesh of ``shape``, started once for every job of
    the JSON file ``jobs`` (``[kind, workdir, data_root]``: ``"k"``,
    :func:`_mesh_k_nccl_rank`; ``"hier"``, :func:`_mesh_hier_nccl_rank`;
    ``"orbax"``, :func:`_mesh_orbax_nccl_rank`), run in turn."""
    run = {"k": _mesh_k_nccl_rank, "hier": _mesh_hier_nccl_rank,
           "orbax": _mesh_orbax_nccl_rank}
    for kind, work, root in json.loads(Path(jobs).read_text()):
        code = run[kind](work, root, shape)
        torch.cuda.empty_cache()
        if code:
            return code
    return 0


def nccl_mesh_runs(workdir: Path, cfg, kinds: list, shape: tuple,
                   tag: str) -> dict:
    """The ranks of an NCCL mesh of ``shape``, a card each, started once
    for the jobs ``kinds`` (of ``"k"``: 5k (a) on phase 4's corpus,
    ``"hier"``: 5h (b) on 4s-big's, ``"orbax"``: 5n (e) on phase 4's);
    returns each job's work directory by kind, for
    :func:`check_nccl_k`, :func:`check_nccl_hier` and
    :func:`check_nccl_orbax`."""
    from pytorch_scalablefhvae_tpu_torch.parallel.launch import run_ranks
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    world = shape[0] * shape[1]
    cards = "cards" if world > 1 else "nccl"
    jobs, works = [], {}
    if {"k", "orbax"} & set(kinds):
        root, work, cached, _ = mesh_k_workdir(workdir, cfg, f"mesh_k_{cards}")
        build_loaders(cached, root, True)  # the pack, before the ranks
        works.update({k: work for k in ("k", "orbax") if k in kinds})
        jobs += [[k, str(work), str(root)] for k in ("k", "orbax")
                 if k in kinds]
    if "hier" in kinds:
        big_root, bcfg = big_corpus(workdir)
        build_loaders(bcfg, big_root, True)
        works["hier"] = workdir / f"mesh_hier_{cards}"
        prepare_nccl_hier(works["hier"], big_root, bcfg)
        jobs.insert(1 if "k" in kinds else 0,
                    ["hier", str(works["hier"]), str(big_root)])
    (workdir / f"nccl_jobs_{cards}.json").write_text(json.dumps(jobs))
    t0 = time.perf_counter()
    codes = run_ranks(_nccl_rank, world,
                      (str(workdir / f"nccl_jobs_{cards}.json"), shape),
                      backend="nccl", device="cuda", timeout_s=120,
                      join_timeout_s=900)
    log(f"{tag}: the {world} NCCL ranks ran {[j[0] for j in jobs]} in one "
        f"launch and exited with {codes} after "
        f"{time.perf_counter() - t0:.1f} s; card {smi_name_power()}")
    if codes != [0] * world:
        raise AssertionError(f"{tag}: the NCCL ranks exited with {codes}")
    return works


def check_nccl_k(work: Path, shape: tuple, tag: str,
                 single_epoch0: dict | None = None) -> dict:
    """What rank 0 of :func:`_mesh_k_nccl_rank`'s NCCL mesh of ``shape``
    saw: the eager step's host wall against device busy and its host time
    by kind; the replayed bundle's ms/step, busy and idle share,
    ``cudaGraphLaunch`` calls, the NCCL kernels among the replayed kernels
    and #1-#4 and #7 by the profiler against the wrappers; every rank's
    bundle state equal to its eager steps'; the CLI epoch at K =
    ``MESH_K`` against K = 1, bit for bit, #7 once a step forward and
    backward; K = 1 against the run without a mesh where it is given.
    Returns rank 0's record."""
    world = shape[0] * shape[1]
    ranks = [json.loads((work / f"nccl_k_rank{r}.json").read_text())
             for r in range(world)]
    info = ranks[0]
    pe, pr = info["eager"], info["replayed"]
    kinds = {k: round(v, 3) for k, v in sorted(
        pe["host_by_kind"].items(), key=lambda kv: -kv[1])}
    waits = [(n, round(ms, 3), round(c, 2)) for n, ms, c in pe["host"]]
    log(f"{tag} the eager NCCL mesh step {shape}, rank 0, 10 warm "
        f"dispatches of {MESH_K} steps at batch {B_TRAIN} (profiler on): "
        f"host wall {pe['wall']:.3f} ms/step against device busy "
        f"{pe['busy']:.3f} (idle share {pe['idle']:.3f}, "
        f"{pe['launches']:.1f} kernels a step); host self time by kind, ms "
        f"a step: {kinds}; host calls by self time (name, ms a step, calls "
        f"a step): {waits}")
    nccl = {n: c for n, c in pr["names"].items() if "nccl" in n.lower()}
    rows_ = []
    for kernel, names in MESH_TRACE_KERNELS.items():
        rows_.append((kernel, sum(c for n, c in pr["names"].items()
                                  if kernel in n),
                      sum(pr["counted"].get(n, 0) for n in names)))
    differ = {r: x["differ"] for r, x in enumerate(ranks) if x["differ"]}
    log(f"{tag} the mesh bundle replayed, backend {info['backend']}, "
        f"replays {info['replays']}: eager first dispatch {pr['eager']:.3f} "
        f"ms/step, capture and first replay {pr['capture']:.3f} s; 10 warm "
        f"replays: host wall {pr['wall']:.3f} ms/step, device busy "
        f"{pr['busy']:.3f} (idle share {pr['idle']:.3f}), "
        f"{pr['launches']:.1f} kernels a step, {pr['graph_launches']} "
        f"cudaGraphLaunch; NCCL kernels among the replayed kernels: {nccl}; "
        f"kernel (profiler count vs the wrappers' launches): "
        + ", ".join(f"{n} {t} vs {w}" for n, t, w in rows_)
        + f"; against the eager steps {pe['wall']:.3f} ms/step, busy "
        f"{pe['busy']:.3f}; rank states after {info['steps']} steps, bundle "
        f"vs eager, differing {differ}; card {smi_name_power()}")
    if not (info["replays"] and info["backend"] == "nccl"
            and pr["graph_launches"] == 10 and not differ
            and info["steps"][0] == info["steps"][1]
            and all(t == w > 0 for _, t, w in rows_)
            and (world == 1 or nccl)):
        raise AssertionError(f"{tag}: the NCCL mesh bundle did not replay "
                             f"one graph a dispatch through the kernels (and "
                             f"the collectives), or its state differs from "
                             f"the eager steps'")
    said = (f"{MESH_K} steps per dispatch, replayed as one CUDA graph "
            f"(NCCL all-reduces inside)")
    if said not in info[f"text_k{MESH_K}"]:
        raise AssertionError(f"{tag}: the K = {MESH_K} run did not say "
                             f"{said!r}")
    k1 = metrics_of(work / "nccl_k1")[0]
    k8 = metrics_of(work / f"nccl_k{MESH_K}")[0]
    log(f"{tag} CLI epoch on the NCCL mesh {shape}, K = {MESH_K} vs K = 1: "
        f"{k8['train_steps']} steps, train loss {k8['train_loss']!r} vs "
        f"{k1['train_loss']!r}; "
        f"{1e3 * k8['train_seconds'] / k8['train_steps']:.3f} vs "
        f"{1e3 * k1['train_seconds'] / k1['train_steps']:.3f} ms/step "
        f"(the K = {MESH_K} epoch's first dispatch eager, its second a "
        f"capture, its last {int(k8['train_steps']) % MESH_K} steps eager); "
        f"rank 0's launches K = {MESH_K} {info[f'launches_k{MESH_K}']}, K = "
        f"1 {info['launches_k1']}")
    equal_runs(f"{tag} NCCL mesh {shape}, K = {MESH_K} vs K = 1",
               run_dir(work / f"nccl_k{MESH_K}", 1),
               run_dir(work / "nccl_k1", 1), [0])
    steps = int(k1["train_steps"])
    for kk in (1, MESH_K):
        c = info[f"launches_k{kk}"]
        check_tensor_core(c, info[f"launches_tc_k{kk}"], f"{tag}, K = {kk}")
        if not (c["discriminative_log_qy_sharded"] == steps
                and c["discriminative_log_qy_sharded_bwd"] == steps
                and c["discriminative_log_qy_bwd"] == 0
                and c["windowed_chunk_gather"] == 0):
            raise AssertionError(f"{tag} K = {kk}: kernel #7 must be "
                                 f"launched once a step forward and "
                                 f"backward, #6 and #8 never: {c}")
    if single_epoch0 is not None:
        gap = abs(k1["train_loss"] - single_epoch0["train_loss"]) \
            / abs(single_epoch0["train_loss"])
        log(f"{tag} the NCCL mesh's epoch 0 train loss {k1['train_loss']!r} "
            f"differs from the run without a mesh by {gap:.3e} relative "
            f"(tol {TOL_MESH_EPOCH:g})")
        if not gap <= TOL_MESH_EPOCH:
            raise AssertionError(f"{tag}: the NCCL mesh's epoch disagrees "
                                 f"with the run without a mesh")
    return info


def mesh_k_workdir(workdir: Path, cfg, name: str):
    """A phase's directory, phase 4's config with the shared pack cache
    (saved there for the ranks) and the CLI's train arguments."""
    root, work = workdir / "data", workdir / name
    work.mkdir()
    pack = ["--pack-cache-dir", str(workdir / "tiers_pack")]
    cached = cfg.replace(data=dataclasses.replace(cfg.data,
                                                  pack_cache_dir=pack[1]))
    cached.save(work / "config.json")
    (work / "train_args.json").write_text(json.dumps([
        "train", "--dataset", "synthetic", "--preprocessed", "--data-root",
        str(root), "--mvn-path", cfg.data.mvn_path, *pack]))
    return root, work, cached, pack


def phase_mesh_k_cards(workdir: Path, cfg) -> dict:
    """Phase 5n (only when named, on four cards), one launch of a ``2,2``
    NCCL mesh, a card a rank (:func:`nccl_mesh_runs`): 5k (a)'s checks
    (:func:`check_nccl_k`), whose replayed graphs must hold the NCCL
    all-reduce kernels (a one-rank communicator launches none); then phase
    5h (b)'s hierarchical runs on the same mesh (:func:`check_nccl_hier`);
    then (e), ``--ckpt-backend orbax`` stopped and resumed
    (:func:`check_nccl_orbax`). Returns rank 0's launches of the K =
    ``MESH_K`` runs of each (``mesh_k8_cards``, ``mesh_hier_cards``,
    ``mesh_orbax_cards``)."""
    n = torch.cuda.device_count()
    log(f"== phase 5n: sfhvae train --mesh {MESH[0]},{MESH[1]} "
        f"--dist-backend nccl --steps-per-dispatch {MESH_K} on {n} cards, "
        f"then with --hierarchical")
    if n < MESH[0] * MESH[1]:
        raise AssertionError(f"5n needs {MESH[0] * MESH[1]} cards, found {n}")
    t_phase = time.perf_counter()
    works = nccl_mesh_runs(workdir, cfg, ["k", "hier", "orbax"], MESH, "5n")
    info = check_nccl_k(works["k"], MESH, "5n")
    hier = check_nccl_hier(works["hier"], MESH, "5n (hier)")
    orbax = check_nccl_orbax(works["orbax"], MESH, "5n (e)")
    log(f"phase 5n took {time.perf_counter() - t_phase:.1f} s; cards "
        f"{smi_name_power()}")
    return {"mesh_k8_cards": info[f"launches_k{MESH_K}"],
            "mesh_hier_cards": hier[f"launches_k{MESH_K}"],
            "mesh_orbax_cards": orbax}


def mesh_k_runs(workdir: Path, cfg):
    """Phase 5k (b)'s runs for :func:`gloo_mesh_runs` (``--mesh 2,2`` at K
    = ``MESH_K`` and 1 on phase 4's corpus) and what the checks need."""
    root, work, cached, pack = mesh_k_workdir(workdir, cfg, "mesh_k")
    batches = stream_chunk_batches(cached, root)[:MESH_K_CHUNKS]
    s_cap = sum(batches) + 1
    if all(n % MESH_K == 0 for n in batches):
        raise AssertionError(f"5k (b): no chunk of {batches} leaves a "
                             f"dispatch window to split")
    chunk = ["--stream-chunk-bytes", str(STREAM_BUDGET // 4)]
    device = ["--data-placement", "device"]
    kf = ("--steps-per-dispatch", str(MESH_K))
    flags = {
        "stopped": [*device, *kf, "--max-steps", str(MESH_K_STOP)],
        "device K1": [*device, "--max-steps", str(MESH_K_CAP)],
        "device K8": [*device, *kf, "--max-steps", str(MESH_K_CAP)],
        "device sharded K8": [*device, "--shard-device-store", *kf,
                              "--max-steps", str(MESH_K_CAP)],
        "stream K1": ["--data-placement", "stream", *chunk, "--max-steps",
                      str(s_cap)],
        "stream K8": ["--data-placement", "stream", *chunk, *kf,
                      "--max-steps", str(s_cap)],
    }
    exp = {name: work / name.replace(" ", "_") for name in flags}
    mesh = ["--mesh", f"{MESH[0]},{MESH[1]}"]
    runs = {name: train_args(cfg, root, exp[name], *mesh, *pack, *f,
                             "--epochs", "1")
            for name, f in flags.items()}
    runs["resumed"] = ["train", "--dataset", "synthetic", "--preprocessed",
                       "--data-root", str(root), "--continue-from",
                       str(run_dir(exp["stopped"], 1)
                           / f"fhvae_synthetic_np_fbank_e0s{MESH_K_STOP}.npz"),
                       "--resume-override", f"max_steps={MESH_K_CAP}"]
    return runs, {"exp": exp, "batches": batches, "s_cap": s_cap,
                  "root": root, "work": work}


def same_mid_steps(tag: str, a: Path, b: Path, steps: int,
                   loss_rtol: float = 0.0) -> dict:
    """Two runs stopped at step ``steps`` of their first epoch (run
    directories ``a``, ``b``): their step checkpoints bit for bit, their
    loss sums to ``loss_rtol`` (0: equal) and their counts equal. Returns
    ``a``'s cursor."""
    stem = f"fhvae_synthetic_np_fbank_e0s{steps}.npz"
    differ = differing_arrays(a / stem, b / stem)
    ma, mb_ = mid_epoch(a, steps), mid_epoch(b, steps)
    gap = abs(ma["loss_sum"] - mb_["loss_sum"]) / abs(mb_["loss_sum"])
    log(f"{tag}, {steps} steps: loss sums {ma['loss_sum']!r} vs "
        f"{mb_['loss_sum']!r} (relative gap {gap:.3e}, tol {loss_rtol:g}); "
        f"checkpoint arrays differing {differ}; "
        f"{1e3 * ma['elapsed_s'] / steps:.2f} vs "
        f"{1e3 * mb_['elapsed_s'] / steps:.2f} ms/step (rank 0's host "
        f"clock)")
    if differ or not gap <= loss_rtol or ma["count_sum"] != mb_["count_sum"]:
        raise AssertionError(f"{tag}: the runs differ")
    return ma


def phase_mesh_k(workdir: Path, cfg, single_epoch0: dict | None, ctx: dict,
                 info: dict, nccl: dict) -> dict:
    """Phase 5k: ``train --mesh d,m --steps-per-dispatch MESH_K`` on phase
    4's corpus. (a) One NCCL rank (``--mesh 1,1 --distributed``): where its
    eager step's time goes; a mesh bundle replayed as one CUDA graph
    against the same rank's eager steps (bits, ms/step, busy and idle
    share, the graph launches, the NCCL kernels and #1-#4 and #7 the
    profiler sees against the wrappers' counts); an epoch through the CLI
    at K = 8 against K = 1, bit for bit, and K = 1 against one device
    (:func:`check_nccl_k`; the rank is started once for this and 5h (b),
    :func:`nccl_mesh_runs`).
    (b) Four gloo ranks on the card (``--mesh 2,2``; the runs of
    :func:`mesh_k_runs`, run by :func:`gloo_mesh_runs`), whose bundles run
    eagerly: the device tier K = 8 against K = 1, row-sharded against
    replicated at K = 8, streamed K = 8 against K = 1 over chunks that
    split a dispatch window, and a K = 8 run stopped by ``--max-steps`` and
    resumed against the run never stopped, each bit for bit. Returns the
    NCCL K = 8 epoch's launches (``mesh_k8``)."""
    log(f"== phase 5k: sfhvae train --mesh d,m --steps-per-dispatch "
        f"{MESH_K}: one NCCL rank replays each dispatch as one CUDA graph; "
        f"{MESH[0] * MESH[1]} gloo ranks on the card run theirs eagerly (in "
        f"the shared gloo launch: {sum(info['wall'].values()):.1f} s)")
    t_phase = time.perf_counter()
    exp, root, work = ctx["exp"], ctx["root"], ctx["work"]

    # (a) one NCCL rank (in the shared NCCL launch)
    out = check_nccl_k(nccl["k"], (1, 1), "5k (a)", single_epoch0)

    # (b) four gloo ranks on the card
    texts = info["texts"]
    eager_line = (f"{MESH_K} steps per dispatch, run eagerly: gloo "
                  f"all-reduces pass through the host")
    if not all(eager_line in texts[n] for n in texts if "K8" in n):
        raise AssertionError(f"5k (b): the gloo runs did not say "
                             f"{eager_line!r}")

    def same_steps(name: str, a: str, b: str, steps: int,
                   loss_rtol: float = 0.0) -> None:
        same_mid_steps(f"5k (b) {name}", run_dir(exp[a], 1),
                       run_dir(exp[b], 1), steps, loss_rtol)

    same_steps(f"device tier, K = {MESH_K} vs K = 1", "device K8",
               "device K1", MESH_K_CAP)
    same_steps(f"device tier at K = {MESH_K}, row-sharded vs replicated",
               "device sharded K8", "device K8", MESH_K_CAP)
    log(f"5k (b) the streamed pair: epoch 0's first chunks take "
        f"{ctx['batches']} batches, the runs stop at step {ctx['s_cap']}")
    same_steps(f"streamed fp32, K = {MESH_K} vs K = 1", "stream K8",
               "stream K1", ctx["s_cap"])
    same_steps(f"device tier K = {MESH_K}, stopped at {MESH_K_STOP} and "
               f"resumed vs never stopped", "stopped", "device K8",
               MESH_K_CAP, loss_rtol=1e-12)
    log(f"phase 5k took {time.perf_counter() - t_phase:.1f} s; card "
        f"{smi_name_power()}")
    return out[f"launches_k{MESH_K}"]


# ------------------------------------------------------------- phase 5h

HIER_MESH_CAP = 29    # 5h (a): --max-steps of the gloo runs: three
                      # dispatches of 8, then 5 steps clamped to eager ones
HIER_MESH_CUT = 13    # 5h (a): the stopped run, resumed to HIER_MESH_CAP
HIER_MESH_STOP = 200  # 5h (b): the K = 1 run's cap and the K = 8 run's
                      # stop, 25 dispatches into the first round


def hier_mesh_runs(workdir: Path, cfg):
    """Phase 5h (a)'s runs for :func:`gloo_mesh_runs`: ``--mesh 2,2
    --hierarchical`` with ``HIER_SMALL_K``-sequence rounds on phase 4's
    corpus (its packed store cached for every rank), each stopped at
    ``HIER_MESH_CAP`` steps: the device tier (views) at K = 1 and K =
    ``MESH_K``, row-sharded at K = ``MESH_K``, a K = ``MESH_K`` run stopped
    at ``HIER_MESH_CUT`` and resumed; the round tier at a budget under
    which the replicated sub-pack reduces the round size and the
    row-sharded one does not; the host loader, its MAP init over every
    window (``--map-init-chunk-skip 1``) as the rows pass takes them.
    Returns them and what the checks need."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        STORE_TAIL_SLACK,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    root, work = workdir / "data", workdir / "mesh_hier"
    work.mkdir()
    pack = ["--pack-cache-dir", str(workdir / "tiers_pack")]
    cached = cfg.replace(data=dataclasses.replace(cfg.data,
                                                  pack_cache_dir=pack[1]))
    store = build_loaders(cached, root, True)[0].dataset.store
    nbytes = store.data.shape[0] * store.dim * 4
    need = int(np.sort(store.lens)[-HIER_SMALL_K:].sum()) + STORE_TAIL_SLACK
    # three quarters of the budget under the K longest sequences' rows, of
    # twice the budget (row-sharded on a model axis of 2) over them, and
    # twice the budget under the store, which auto then stages a round at
    # a time in both
    budget = need * store.dim * 4 * 2 // 3 * 11 // 10
    if not (budget * 3 // 4 < need * store.dim * 4 <= 2 * budget * 3 // 4
            and 2 * budget < nbytes):
        raise AssertionError(f"5h (a): no budget splits the round sizes "
                             f"({need} rows, a store of {nbytes} bytes)")
    kf = ["--steps-per-dispatch", str(MESH_K)]
    bud = ["--device-store-max-bytes", str(budget)]
    cap = ["--max-steps", str(HIER_MESH_CAP)]
    flags = {
        "device K1": cap,
        "device K8": [*kf, *cap],
        "device sharded K8": ["--shard-device-store", *kf, *cap],
        "stopped": [*kf, "--max-steps", str(HIER_MESH_CUT)],
        "round": [*bud, *kf, *cap],
        "round sharded": [*bud, "--shard-device-store", *kf, *cap],
        # every window in the host loader's MAP init too, as the rows
        # pass of the staged tiers takes them on a mesh (the host's default
        # is every 8th chunk of 16)
        "host": ["--data-placement", "host", "--map-init-chunk-skip", "1",
                 *kf, *cap],
    }
    exp = {name: work / name.replace(" ", "_") for name in flags}
    mesh = ["--mesh", f"{MESH[0]},{MESH[1]}", "--hierarchical",
            "--num-hierarchical-sequences", str(HIER_SMALL_K)]
    runs = {name: train_args(cfg, root, exp[name], *mesh, *pack, *f,
                             "--epochs", "1")
            for name, f in flags.items()}
    runs["resumed"] = ["train", "--dataset", "synthetic", "--preprocessed",
                       "--data-root", str(root), "--continue-from",
                       str(run_dir(exp["stopped"], 1) / f"fhvae_synthetic_"
                           f"np_fbank_e0s{HIER_MESH_CUT}.npz"),
                       "--resume-override", f"max_steps={HIER_MESH_CAP}"]
    return runs, {"exp": exp, "budget": budget, "need": need}


def _mesh_hier_nccl_rank(workdir: str, data_root: str, shape: tuple) -> int:
    """A rank of an NCCL mesh of ``shape`` (5h (b): one rank, ``1,1``; 5n:
    ``2,2`` on four cards) on 4s-big's corpus at the CLI defaults (K =
    ``HIER_K`` sequences a round, each round's sub-pack staged, the store
    being over the 4 GiB budget). First a round entered by ``Rounds`` on
    the mesh, and 12 dispatches of ``MESH_K`` steps of a mesh bundle on its
    staged sub-pack, the last 10 under torch.profiler
    (:func:`profiled_dispatches`); then through the CLI, two epochs a
    round each: K = 1 stopped at ``HIER_MESH_STOP``, and K = ``MESH_K``
    stopped there (its step checkpoint kept aside) and resumed through the
    second round, those two counted from 0. Every MAP init is recorded
    (pass, #8's launches) and every turnover's table checked against the
    whole table the pass returned. Writes ``hier_rank<r>.json``."""
    import shutil as sh

    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.ops import stage_gather, window_gather
    from pytorch_scalablefhvae_tpu_torch.parallel import mesh as mesh_module
    from pytorch_scalablefhvae_tpu_torch.train import rounds
    from pytorch_scalablefhvae_tpu_torch.train.device_step import PlanInputs
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.graphs import StepBundle
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
    )

    work, root = Path(workdir), Path(data_root)
    cfg = ExperimentConfig.load(work / "config.json")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_module.make_mesh(shape, dev)
    gather = window_gather.windowed_chunk_gather
    inits, swaps, passes = [], [], []
    real_init, real_swap = rounds.Rounds.map_init, rounds.replace_mu2_table
    real_rows = rounds.device_map_pass_rows

    def rows_pass(*args, **kw):
        passes.append(real_rows(*args, **kw))
        return passes[-1]

    def map_init(self, state, ds):
        n, t0 = gather.launches, time.perf_counter()
        real_init(self, state, ds)
        torch.cuda.synchronize()
        inits.append({"tier": self.tier, "chunked": self.chunked,
                      "rows_pass": bool(passes), "batches": self.map_batches,
                      "gather": gather.launches - n,
                      "s": time.perf_counter() - t0})
        passes.clear()

    def swap(state, table):
        real_swap(state, table)
        model = state.model
        swaps.append(bool(
            passes and table is passes[-1]
            and table.shape[0] == model.num_seqs_padded
            and torch.equal(model.mu2_table, mesh.table_shard(table))
            and not state.mu["mu2_table"].any()
            and not state.nu["mu2_table"].any()))

    rounds.Rounds.map_init, rounds.replace_mu2_table = map_init, swap
    rounds.device_map_pass_rows = rows_pass
    out = {}
    try:
        loader, _ = build_loaders(cfg, root, True)
        ds, B = loader.dataset, loader.batch_size
        k, ceiling = rounds.round_ceiling("auto", ds.store, HIER_K, 4 << 30,
                                          verbose=False, mesh=mesh)
        source = DeviceDataSource(ds.store.subset([], materialize=True), dev,
                                  pad_to_rows=ceiling, mesh=mesh)
        state = create_train_state(mesh_module.shard_model(
            seeded_model(cfg, k), mesh))
        opt = make_optimizer(1e-3, 0.95, 0.999)
        r = rounds.Rounds(cfg, loader, "round", source, k, dev, mesh=mesh)
        sub, turnover = traced_turnover(r, state)
        sub.set_epoch(0)
        plan, arrays = source.stage_epoch(sub.dataset, sub._order(), B,
                                          pad_rows=r.plan_rows)
        inputs = PlanInputs(source.data, B, ds.seg_len, mesh)
        inputs.load_plan(arrays, plan.n_real)
        bundle = StepBundle(state, opt, 10.0, MESH_K, inputs, dev, mesh)

        def replayed(d: int) -> torch.Tensor:
            inputs.set_base(d * MESH_K * B)
            return bundle()["loss"].clone()

        out["replayed"] = profiled_dispatches(replayed, MESH_K,
                                              MESH_TRACE_KERNELS)
        out["replays"], out["backend"] = bundle.replays, mesh.backend
        out["k"], out["turnover"] = k, turnover
        del r, sub, bundle, inputs, source, state, loader, arrays
        torch.cuda.empty_cache()

        args = json.loads((work / "train_args.json").read_text())
        mesh_flags = ["--mesh", f"{shape[0]},{shape[1]}", "--distributed",
                      "--dist-backend", "nccl", "--epochs", "2"]
        stem = f"fhvae_synthetic_np_fbank_e0s{HIER_MESH_STOP}"
        reset_counts(mesh_entries())
        out["text_k1"] = run_cli(cli, args + [
            "--exp-root", str(work / "k1"), *mesh_flags, "--max-steps",
            str(HIER_MESH_STOP)])
        out["launches_k1"] = {e.__name__: e.launches for e in mesh_entries()}
        reset_counts(mesh_entries())
        stage_gather.stage_gather.launches = 0
        exp8 = work / f"k{MESH_K}"
        out["text_k8"] = run_cli(cli, args + [
            "--exp-root", str(exp8), *mesh_flags, "--steps-per-dispatch",
            str(MESH_K), "--max-steps", str(HIER_MESH_STOP)])
        if mesh.rank == 0:  # the resume deletes it once epoch 0 is done
            for ext in (".npz", ".json"):
                sh.copy(run_dir(exp8, 2) / f"{stem}{ext}",
                        work / f"k{MESH_K}_{stem}{ext}")
        out["text_resumed"] = run_cli(cli, [
            "train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--continue-from",
            str(run_dir(exp8, 2) / f"{stem}.npz"), "--resume-override",
            "max_steps=0", "--distributed", "--dist-backend", "nccl"])
        out[f"launches_k{MESH_K}"] = {e.__name__: e.launches
                                      for e in mesh_entries()}
        out[f"launches_tc_k{MESH_K}"] = tensor_core_counts(mesh_entries())
        out[f"launches_k{MESH_K}"]["stage_gather"] = \
            stage_gather.stage_gather.launches
    finally:
        rounds.Rounds.map_init, rounds.replace_mu2_table = real_init, real_swap
        rounds.device_map_pass_rows = real_rows
    out["inits"], out["swaps"] = inits, swaps
    (work / f"hier_rank{mesh.rank}.json").write_text(json.dumps(out))
    return 0


def prepare_nccl_hier(work: Path, root: Path, cfg) -> None:
    """:func:`_mesh_hier_nccl_rank`'s work directory: 4s-big's corpus at
    ``root``, ``cfg`` its run config."""
    work.mkdir()
    cfg.save(work / "config.json")
    (work / "train_args.json").write_text(json.dumps([
        "train", "--dataset", "synthetic", "--preprocessed", "--data-root",
        str(root), "--mvn-path", cfg.data.mvn_path, "--pack-cache-dir",
        cfg.data.pack_cache_dir, "--hierarchical"]))


def check_nccl_hier(work: Path, shape: tuple, tag: str) -> dict:
    """What the ranks of :func:`_mesh_hier_nccl_rank`'s NCCL mesh of
    ``shape`` saw: every MAP init the rows pass (never #8) and every
    turnover's table the whole table's rows on every rank, its moments
    zeroed; the round's bundle replayed, #1-#4 and #7 by the profiler
    against the wrappers; the K = ``MESH_K`` run stopped at
    ``HIER_MESH_STOP`` against K = 1 there, bit for bit, then its two
    rounds; #7 once a step, #6 and #8 never. Returns rank 0's record."""
    world = shape[0] * shape[1]
    ranks = [json.loads((work / f"hier_rank{r}.json").read_text())
             for r in range(world)]
    info = ranks[0]
    bad = {r: (x["inits"], x["swaps"]) for r, x in enumerate(ranks)
           if not (len(x["inits"]) == len(x["swaps"]) == 4
                   and all(x["swaps"])
                   and all(i["rows_pass"] and not i["chunked"]
                           and i["gather"] == 0 for i in x["inits"]))}
    log(f"{tag} MAP inits on rank 0 (the profiled round's, the K = 1 "
        f"run's, two in the K = {MESH_K} runs): {info['inits']}; tables "
        f"equal to the rows "
        f"pass's whole table's rows with moments zeroed: {info['swaps']}; "
        f"ranks that differ {list(bad)}")
    if bad:
        raise AssertionError(f"{tag}: a round's MAP init is not the rows "
                             f"pass's, or a rank's table is not its rows of "
                             f"the whole table: {bad}")
    pr = info["replayed"]
    rows_ = [(kernel, sum(c for n, c in pr["names"].items() if kernel in n),
              sum(pr["counted"].get(n, 0) for n in names))
             for kernel, names in MESH_TRACE_KERNELS.items()]
    log(f"{tag} a {info['k']}-sequence round on the NCCL mesh {shape} "
        f"(turnover {info['turnover']}), its bundle replayed, backend "
        f"{info['backend']}: capture and first replay {pr['capture']:.3f} s; "
        f"10 warm replays: host wall {pr['wall']:.3f} ms/step, device busy "
        f"{pr['busy']:.3f} (idle share {pr['idle']:.3f}), "
        f"{pr['launches']:.1f} kernels a step, {pr['graph_launches']} "
        f"cudaGraphLaunch; kernel (profiler count vs the wrappers' "
        f"launches): " + ", ".join(f"{n} {t} vs {w}" for n, t, w in rows_)
        + f"; card {smi_name_power()}")
    if not (info["replays"] and info["backend"] == "nccl"
            and info["k"] == HIER_K and pr["graph_launches"] == 10
            and all(t == w > 0 for _, t, w in rows_)):
        raise AssertionError(f"{tag}: the round's mesh bundle did not replay "
                             f"one graph a dispatch through the kernels")
    said = (f"{MESH_K} steps per dispatch, replayed as one CUDA graph "
            f"(NCCL all-reduces inside)")
    turns = round_lines(info["text_k8"]) + round_lines(info["text_resumed"])
    if said not in info["text_k8"] or [
            (t["epoch"], t["k"], t["fresh"]) for t in turns] != [
            (0, HIER_K, True), (0, HIER_K, False), (1, HIER_K, True)]:
        raise AssertionError(f"{tag}: the K = {MESH_K} runs did not say "
                             f"{said!r} or did not enter their rounds "
                             f"{turns}")
    stem = f"fhvae_synthetic_np_fbank_e0s{HIER_MESH_STOP}"
    k1_dir = run_dir(work / "k1", 2)
    aside = work / "aside"
    aside.mkdir()
    for ext in (".npz", ".json"):
        shutil.copy(work / f"k{MESH_K}_{stem}{ext}", aside / f"{stem}{ext}")
    m8 = same_mid_steps(f"{tag} the round-staged run, K = {MESH_K} replayed "
                        f"vs K = 1", aside, k1_dir, HIER_MESH_STOP)
    m1 = mid_epoch(k1_dir, HIER_MESH_STOP)
    recs = metrics_of(work / f"k{MESH_K}", 2)
    log(f"{tag} CLI, two {HIER_K}-sequence rounds on the NCCL mesh {shape} "
        f"at K = {MESH_K}, stopped at {HIER_MESH_STOP} and resumed: " +
        "; ".join(f"epoch {r['epoch']} {r['train_steps']} steps, "
                  f"{1e3 * r['train_seconds'] / r['train_steps']:.3f} "
                  f"ms/step, train loss {r['train_loss']!r}, dev LB "
                  f"{r['val_lower_bound']!r}" for r in recs)
        + f"; the first {HIER_MESH_STOP} steps "
        f"{1e3 * m8['elapsed_s'] / HIER_MESH_STOP:.3f} ms/step at K = "
        f"{MESH_K} against {1e3 * m1['elapsed_s'] / HIER_MESH_STOP:.3f} at "
        f"K = 1; turnovers {[t['seconds'] for t in turns]}; rank 0's "
        f"launches K = {MESH_K} {info[f'launches_k{MESH_K}']}, K = 1 "
        f"{info['launches_k1']}; card {smi_name_power()}")
    steps, n_rounds = int(recs[-1]["step"]), len(turns)
    c = info[f"launches_k{MESH_K}"]
    check_tensor_core(c, info[f"launches_tc_k{MESH_K}"], f"{tag}, K = "
                      f"{MESH_K}")
    if not (len(recs) == 2
            and all(np.isfinite([r["train_loss"], r["val_lower_bound"]]).all()
                    for r in recs)
            and c["discriminative_log_qy_sharded"] == steps
            and c["discriminative_log_qy_sharded_bwd"] == steps
            and c["discriminative_log_qy_bwd"] == 0
            and c["windowed_chunk_gather"] == 0
            and min(c["lstm2_tm_proj"], c["lstm2_tm"],
                    c["lstm2_tm_proj_bwd"], c["lstm2_tm_bwd"]) > 0
            and c["stage_gather"] == n_rounds):
        raise AssertionError(f"{tag}: two finite epochs with kernel #7 once "
                             f"a step forward and backward, #6 and #8 never, "
                             f"#1-#4 launched, and a stage_gather launch a "
                             f"round entered ({n_rounds}): {c}")
    return info


def phase_mesh_hier(workdir: Path, cfg, ctx: dict, info: dict,
                    nccl: dict) -> dict:
    """Phase 5h: ``train --mesh d,m --hierarchical``. (a) Four gloo ranks
    on the card (``--mesh 2,2``; the runs of :func:`hier_mesh_runs`, run by
    :func:`gloo_mesh_runs`), ``HIER_SMALL_K``-sequence rounds on phase 4's
    corpus: the device tier at K = ``MESH_K`` against K = 1, row-sharded
    against replicated, a run stopped inside the round and resumed against
    the run never stopped, each bit for bit; the round tier, where the
    replicated sub-pack reduces the round size and the row-sharded one
    does not, each round one ``stage_gather`` launch from the pack held as
    a page-locked copy in memory; the host loader, its MAP init over every
    window as the rows
    pass's, within ``TOL_HIER_EPOCH`` of the device tier. (b) One NCCL rank (``--mesh 1,1 --distributed``) at the CLI
    defaults on 4s-big's corpus (:func:`check_nccl_hier`; the rank is
    started once for 5k (a) and this, :func:`nccl_mesh_runs`). Returns
    (b)'s K = ``MESH_K`` runs' launches (``mesh_hier``)."""
    log(f"== phase 5h: sfhvae train --mesh d,m --hierarchical: "
        f"{MESH[0] * MESH[1]} gloo ranks on the card with {HIER_SMALL_K}-"
        f"sequence rounds (in the shared gloo launch: "
        f"{sum(info['wall'].values()):.1f} s), then one NCCL rank at K = "
        f"{HIER_K}")
    t_phase = time.perf_counter()
    exp, texts = ctx["exp"], info["texts"]

    # (a) four gloo ranks
    def same_steps(name, a, b, steps=HIER_MESH_CAP, loss_rtol=0.0):
        return same_mid_steps(f"5h (a) {name}", run_dir(exp[a], 1),
                              run_dir(exp[b], 1), steps, loss_rtol)

    same_steps(f"device tier, K = {MESH_K} vs K = 1", "device K8",
               "device K1")
    same_steps(f"device tier at K = {MESH_K}, row-sharded vs replicated",
               "device sharded K8", "device K8")
    same_steps(f"device tier K = {MESH_K}, stopped at {HIER_MESH_CUT} and "
               f"resumed vs never stopped", "stopped", "device K8",
               loss_rtol=1e-12)
    staged = "stage their subset device-resident"
    reduced = f"Hierarchical round size reduced {HIER_SMALL_K} -> "
    said = {name: [line for line in texts[name].splitlines()
                   if "round" in line.lower()]
            for name in ("device K8", "round", "round sharded", "host",
                         "resumed")}
    log(f"5h (a) at a budget of {ctx['budget']} bytes a device (the K "
        f"longest sequences need {ctx['need']} rows), rank 0 said: {said}")
    lines = {name: round_lines(texts[name]) for name in texts}
    if not (reduced in texts["round"] and staged in texts["round"]
            and reduced not in texts["round sharded"]
            and staged in texts["round sharded"]
            and [t["k"] for t in lines["round sharded"]] == [HIER_SMALL_K]
            and [t["fresh"] for t in lines["resumed"]] == [False]
            and all([t["k"] for t in lines[n]] == [HIER_SMALL_K]
                    for n in ("device K1", "device K8", "host"))):
        raise AssertionError("5h (a): the rounds were not staged and sized "
                             "as the budget says, or the resume did not "
                             "re-enter its round")
    for name in ("round", "round sharded"):
        m = mid_epoch(run_dir(exp[name], 1), HIER_MESH_CAP)
        if not np.isfinite(m["loss_sum"]):
            raise AssertionError(f"5h (a) {name}: the loss is not finite")
    host, device = (mid_epoch(run_dir(exp[n], 1), HIER_MESH_CAP)
                    for n in ("host", "device K8"))
    gap = abs(host["loss_sum"] / device["loss_sum"] - 1)
    log(f"5h (a) host loader vs device tier, {HIER_MESH_CAP} steps: loss "
        f"sums {host['loss_sum']!r} vs {device['loss_sum']!r} (relative gap "
        f"{gap:.3e}, tol {TOL_HIER_EPOCH:g}); "
        f"{1e3 * host['elapsed_s'] / HIER_MESH_CAP:.2f} vs "
        f"{1e3 * device['elapsed_s'] / HIER_MESH_CAP:.2f} ms/step; runs' "
        f"wall seconds {{" + ", ".join(f"{n}: {w:.1f}" for n, w in
                                       info["wall"].items()) + "}")
    if not gap <= TOL_HIER_EPOCH:
        raise AssertionError("5h (a): the host loader disagrees with the "
                             "device tier")
    for name, c in info["launches"].items():
        steps = (HIER_MESH_CAP - HIER_MESH_CUT if name == "resumed"
                 else HIER_MESH_CUT if name == "stopped" else HIER_MESH_CAP)
        check_tensor_core(c, info["launches_tc"][name], f"5h (a) {name}")
        if not (c["discriminative_log_qy_sharded"] == steps
                and c["discriminative_log_qy_sharded_bwd"] == steps
                and c["discriminative_log_qy_bwd"] == 0
                and c["windowed_chunk_gather"] == 0
                and c["lstm2_tm_proj"] > 0):
            raise AssertionError(f"5h (a) {name}: #7 must be launched once "
                                 f"a step forward and backward, #6 and #8 "
                                 f"never: {c}")
    # the round tier's one round staged on rank 0, replicated and
    # row-sharded, by one gather; the views and the host loader stage
    # none
    staged = info["stage_gathers"]
    log(f"5h (a) rank 0's stage_gather launches by run: {staged}")
    if staged != {n: int(n in ("round", "round sharded")) for n in staged}:
        raise AssertionError(f"5h (a): the round tier's rounds were not "
                             f"staged by one stage_gather launch: {staged}")
    torch.cuda.empty_cache()

    # (b) one NCCL rank at the CLI defaults (in the shared NCCL launch)
    out = check_nccl_hier(nccl["hier"], (1, 1), "5h (b)")
    log(f"phase 5h took {time.perf_counter() - t_phase:.1f} s; card "
        f"{smi_name_power()}")
    return out[f"launches_k{MESH_K}"]


# -------------------------------------------------------------- phase 4r

RESUME_EVERY = 50    # phase 4r's --ckpt-every-steps
RESUME_CAP = 183     # (a), (b): 133 + 50, epoch 1 at batch 50; at K = 8 off
                     # a dispatch boundary, so the last dispatches clamp
HOST_CAP = 70        # (c): epoch 0 at batch 70


def checkpoint_arrays(path: Path) -> dict:
    """Every array of a checkpoint: an ``.npz`` file, or an ``.orbax``
    directory of ``torch.distributed.checkpoint`` read whole on the host."""
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    md = FileSystemReader(str(path)).read_metadata().state_dict_metadata
    out = {k: torch.empty(tuple(v.size), dtype=v.properties.dtype)
           for k, v in md.items()}
    dcp.load(out, storage_reader=FileSystemReader(str(path)), no_dist=True)
    return {k: v.numpy() for k, v in out.items()}


def differing_arrays(a: Path, b: Path) -> list:
    """The names of the arrays in which two checkpoints differ (either
    backend; the Adam count and the step by value)."""
    x, y = checkpoint_arrays(a), checkpoint_arrays(b)
    return [k for k in sorted(set(x) | set(y))
            if k not in x or k not in y or not np.array_equal(x[k], y[k])]


def step_checkpoints(exp: Path, ext: str = "npz") -> list[Path]:
    """The step checkpoints (``..._e<E>s<B>.<ext>``) in ``exp``, in
    ``(E, B)`` order."""
    found = [(tuple(map(int, m.groups())), p) for p in exp.glob(f"*.{ext}")
             if (m := re.search(rf"_e(\d+)s(\d+)\.{ext}$", p.name))]
    return [p for _, p in sorted(found)]


def record_gap(got: dict, want: dict) -> list:
    """The keys in which a resumed epoch's record differs from the
    uninterrupted run's: ``train_loss`` beyond 1e-12 relative (the pre-kill
    partials are added to the rest, another summation order), the rest at
    all."""
    gap = [k for k in ("epoch", "train_steps", "step", "val_loss",
                       "val_lower_bound", "val_log_qy") if got[k] != want[k]]
    if not (abs(got["train_loss"] - want["train_loss"])
            <= 1e-12 * abs(want["train_loss"])):
        gap.append("train_loss")
    return gap


def kill_and_resume(cli, name: str, root: Path, args: list, exp: Path,
                    cap: int, at_cap: bool = False,
                    stem: str = "fhvae_synthetic_np_fbank",
                    ext: str = "npz") -> tuple[str, dict]:
    """``args`` with ``--ckpt-every-steps RESUME_EVERY --max-steps cap``,
    then resumed from its last step checkpoint with ``max_steps=0``. The
    stopped run must have saved step ``cap`` exactly and no checkpoint of
    its last epoch; the resumed one must leave no step checkpoint. With
    ``at_cap``, first a resume with the saved cap, which must train nothing
    and change no file. ``ext`` is the checkpoints' (``orbax``: the
    ``--ckpt-backend orbax`` directories, whose step is read from the
    checkpoint itself). Returns the resumed run's output and the step
    checkpoint's ``mid_epoch``."""
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    resume = ["train", "--dataset", "synthetic", "--preprocessed",
              "--data-root", str(root), "--continue-from"]
    run_cli(cli, args + ["--ckpt-every-steps", str(RESUME_EVERY),
                         "--max-steps", str(cap)])
    last = step_checkpoints(exp, ext)[-1]
    meta = ckpt.read_checkpoint_meta(last)
    mid = meta["mid_epoch"]
    step = int(checkpoint_arrays(last)["step"])
    ended = exp / f"{stem}_e{mid['epoch']}.{ext}"
    log(f"{name}: stopped at step {step} (cap {cap}), epoch "
        f"{mid['epoch']} batch {mid['batches_done']}; step checkpoints "
        f"{[p.name for p in step_checkpoints(exp, ext)]}")
    if step != cap or ended.exists():
        raise AssertionError(f"{name}: the stopped run saved step "
                             f"{step} or its epoch checkpoint")
    if at_cap:
        before = {p.name: p.read_bytes() for p in exp.iterdir()}
        out = run_cli(cli, resume + [str(last)])
        after = {p.name: p.read_bytes() for p in exp.iterdir()}
        changed = [n for n in after if n != "config.json"
                   and after[n] != before.get(n)]
        log(f"{name}: resumed at the cap: {'nothing to train' in out}, "
            f"files changed {changed}")
        if "nothing to train" not in out or changed:
            raise AssertionError(f"{name}: a resume at the cap trained")
    out = run_cli(cli, resume + [str(last), "--resume-override",
                                 "max_steps=0"])
    if f"mid-epoch at batch {mid['batches_done']}" not in out:
        raise AssertionError(f"{name}: the resume did not re-enter epoch "
                             f"{mid['epoch']} at its cursor")
    left = [p.name for p in step_checkpoints(exp, ext)]
    if left or list(exp.glob("*_e*s[0-9]*.json")):
        raise AssertionError(f"{name}: step checkpoints outlived the epoch "
                             f"checkpoint: {left}")
    return out, mid


def check_resumed(name: str, exp: Path, ref: Path, epochs: list,
                  stem: str = "fhvae_synthetic_np_fbank",
                  ext: str = "npz") -> None:
    """The resumed run's checkpoint of the last epoch (``.<ext>``) and its
    records of ``epochs`` against the uninterrupted run's (``ref``, npz):
    every tensor and the dev metrics bit for bit, ``train_loss`` to
    1e-12."""
    last = max(epochs)
    ckpt_name = f"{stem}_e{last}.npz"
    differ = differing_arrays(exp / f"{stem}_e{last}.{ext}", ref / ckpt_name)
    got = {r["epoch"]: r for r in metrics_in(exp)}
    want = {r["epoch"]: r for r in metrics_in(ref)}
    gaps = {e: record_gap(got[e], want[e]) for e in epochs}
    log(f"{name}: resumed vs uninterrupted, {ckpt_name}: "
        f"{len(differ)} arrays differ {differ[:4]}; epoch {last} train loss "
        f"{got[last]['train_loss']!r} vs {want[last]['train_loss']!r}, dev "
        f"LB {got[last]['val_lower_bound']!r} vs "
        f"{want[last]['val_lower_bound']!r}, step {got[last]['step']}; "
        f"records differing {gaps}")
    if differ or any(gaps.values()):
        raise AssertionError(f"{name}: the resumed run differs from the "
                             f"uninterrupted one")


def metrics_in(exp: Path) -> list[dict]:
    return [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]


def stream_chunk_batches(cfg, root: Path) -> list[int]:
    """The batches of each chunk of epoch 0's stream schedule at
    ``STREAM_BUDGET`` (the schedule alone, on the host)."""
    from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
        StreamingDeviceSource,
    )
    from pytorch_scalablefhvae_tpu_torch.train import loop
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    loader, _ = build_loaders(stream_config(cfg), root, True)
    src = StreamingDeviceSource(loader.dataset, STREAM_BUDGET // 4,
                                loader.batch_size, torch.device("cpu"))
    loader.set_epoch(0)
    return [-(-len(order) // loader.batch_size) for _, order in
            src.epoch_schedule(loop.stream_seed(loader, 0))]


def phase_resume(workdir: Path, cfg) -> dict:
    """Phase 4r: runs killed at ``--max-steps`` in the middle of an epoch
    and resumed from their step checkpoints, each against the run that was
    never killed, on every tier and K; the NaN gate and a resume at the
    cap. Returns the launches of the phase's runs (``train_resume``)."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.train import loop

    log(f"== phase 4r: sfhvae train stopped by --max-steps mid-epoch, with "
        f"--ckpt-every-steps {RESUME_EVERY}, and resumed from its step "
        f"checkpoint; against the uninterrupted runs")
    root = workdir / "data"
    entries = train_entries()
    saves, real_save = [], loop.save_state

    def timed_save(*args, cursor=None, **kw):
        t0 = time.perf_counter()
        path = real_save(*args, cursor=cursor, **kw)
        if cursor is not None:
            saves.append((time.perf_counter() - t0, path.stat().st_size))
        return path

    loop.save_state = timed_save
    reset_counts(entries)
    t_phase = time.perf_counter()
    try:
        # (a), (b): the device tier at K = 1 and K = 8, against phase 4
        ref = run_dir(workdir / "experiments", 2)
        for tag, k in (("(a) device tier, K = 1", 1),
                       (f"(b) device tier, K = {K_DISPATCH}", K_DISPATCH)):
            exp_root = workdir / f"resume_device_k{k}"
            exp = run_dir(exp_root, 2)
            args = train_args(cfg, root, exp_root, "--epochs", "2",
                              "--steps-per-dispatch", str(k))
            kill_and_resume(cli, tag, root, args, exp, RESUME_CAP,
                            at_cap=k == 1)
            check_resumed(tag, exp, ref, [0, 1])

        # (c): the host loader at K = 1 and K = 8, against phase 4's epoch
        ref = workdir / "experiments_host" / "synthetic_np_fbank" \
            / "fhvae_e1_p10_a10.0"
        for k in (1, K_DISPATCH):
            tag = f"(c) host loader, K = {k}"
            exp_root = workdir / f"resume_host_k{k}"
            kill_and_resume(cli, tag, root, train_args(
                cfg, root, exp_root, "--data-placement", "host", "--epochs",
                "1", "--steps-per-dispatch", str(k)), run_dir(exp_root, 1),
                HOST_CAP)
            check_resumed(tag, run_dir(exp_root, 1), ref, [0])

        # (d): the streamed tier (fp32, 96 MiB, K = 8), the cursor inside a
        # chunk, against 4s-check's K = 8 epoch (run here without 4s)
        sizes = stream_chunk_batches(cfg, root)
        half = len(sizes) // 2
        cap = sum(sizes[:half]) + sizes[half] // 2
        budget = ["--device-store-max-bytes", str(STREAM_BUDGET),
                  "--steps-per-dispatch", str(K_DISPATCH), "--epochs", "1"]
        ref = run_dir(workdir / "stream_k8", 1)
        if not (ref / "fhvae_synthetic_np_fbank_e0.npz").exists():
            ref = run_dir(workdir / "resume_stream_ref", 1)
            run_cli(cli, train_args(cfg, root, workdir / "resume_stream_ref",
                                    *budget))
        tag = f"(d) streamed tier, fp32, K = {K_DISPATCH}"
        exp_root = workdir / "resume_stream"
        out, mid = kill_and_resume(cli, tag, root, train_args(
            cfg, root, exp_root, *budget), run_dir(exp_root, 1), cap)
        staged = f"staged {len(sizes) - half} of {len(sizes)} chunks"
        log(f"{tag}: chunks of {sizes} batches; the cursor, batch "
            f"{mid['batches_done']}, inside chunk {half} (batches "
            f"{sum(sizes[:half])}-{sum(sizes[:half + 1]) - 1}); the resumed "
            f"run logged {staged!r}: {staged in out}")
        if staged not in out or sizes[half] < 2:
            raise AssertionError(f"{tag}: the resumed run did not skip the "
                                 f"{half} chunks behind its cursor")
        check_resumed(tag, run_dir(exp_root, 1), ref, [0])

        # the NaN gate: the cap's save reads the bundle's losses first
        exp_root = workdir / "resume_nan"
        with redirect_stdout(_Tee(sys.stdout, io.StringIO())):
            rc = cli(train_args(cfg, root, exp_root, "--epochs", "1",
                                "--steps-per-dispatch", str(K_DISPATCH),
                                "--max-steps", str(K_DISPATCH),
                                "--learning-rate", "1e18"))
        written = sorted(p.name for p in exp_root.rglob("*_e*.npz"))
        log(f"the NaN gate, lr 1e18, --max-steps {K_DISPATCH} at K = "
            f"{K_DISPATCH}: exit {rc}, checkpoints written {written}")
        if rc != 2 or written:
            raise AssertionError("a diverged run exited 0 or saved a "
                                 "checkpoint")
    finally:
        loop.save_state = real_save
    launches = {e.__name__: e.launches for e in entries}
    tc = tensor_core_counts(entries)
    seconds = [t for t, _ in saves]
    log(f"launches during phase 4r's runs in this process, counted from 0: "
        f"{launches}; of the LSTM entries', through the tensor-core form: "
        f"{tc}; {len(saves)} step-checkpoint saves of "
        f"{saves[0][1] / 1e6:.2f} MB each (train state and Adam moments): "
        f"{1e3 * min(seconds):.1f}-{1e3 * max(seconds):.1f} ms, median "
        f"{1e3 * float(np.median(seconds)):.1f} ms; card {smi_name_power()}")
    check_tensor_core(launches, tc, "phase 4r")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by phase 4r")

    log(f"phase 4r took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -------------------------------------------------------------- phase 4o

ORBAX_SAVES = 4        # 4o, 5n (e): saves of one state by each backend, in
                       # turns (npz, orbax, orbax, npz, ...)
ORBAX_MESH_STOP = 50   # 5n (e): the NCCL orbax run's stop in its epoch


def dir_bytes(path: Path) -> int:
    """The bytes of a checkpoint file or of every file of a directory."""
    if path.is_file():
        return path.stat().st_size
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


@contextmanager
def timed_saves(record: list):
    """``train/loop.py``'s ``save_state`` and ``wait_for_saves`` timed on
    the host clock while inside: ``[kind, seconds, step checkpoint]``
    appended to ``record`` (kind ``"save"``: what the save blocked the
    loop; ``"flush"``: the wait for the async writes)."""
    from pytorch_scalablefhvae_tpu_torch.train import loop

    real_save, real_wait = loop.save_state, loop.wait_for_saves

    def save(*args, cursor=None, **kw):
        t0 = time.perf_counter()
        try:
            return real_save(*args, cursor=cursor, **kw)
        finally:
            record.append(["save", time.perf_counter() - t0,
                           cursor is not None])

    def wait():
        t0 = time.perf_counter()
        try:
            real_wait()
        finally:
            record.append(["flush", time.perf_counter() - t0, False])

    loop.save_state, loop.wait_for_saves = save, wait
    try:
        yield record
    finally:
        loop.save_state, loop.wait_for_saves = real_save, real_wait


def save_timings(state, config, exp_dir: Path) -> dict:
    """``ORBAX_SAVES`` step-checkpoint saves of ``state`` through
    ``train/loop.py`` ``save_state`` by each backend, in turns, after the
    card is idle: the host-clock seconds each blocks its caller (npz: the
    whole save, on a mesh with its gather of the table; orbax: the
    staging), then for orbax the wait of the flush right after it, and the
    MB each wrote. On a mesh every rank calls it."""
    from pytorch_scalablefhvae_tpu_torch.train import loop
    from pytorch_scalablefhvae_tpu_torch.train.metrics import MetricHistory

    out = {"npz": [], "orbax": [], "flush": [], "mb": {}}
    for i in range(ORBAX_SAVES):
        for backend in (("npz", "orbax") if i % 2 == 0 else ("orbax", "npz")):
            run_cfg = config.replace(train=dataclasses.replace(
                config.train, ckpt_backend=backend))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = loop.save_state(exp_dir, state, run_cfg, 0, 0, 0.0,
                                   MetricHistory(), {},
                                   cursor={"epoch": 0, "batches_done": i + 1})
            out[backend].append(time.perf_counter() - t0)
            if backend == "orbax":
                t0 = time.perf_counter()
                loop.wait_for_saves()
                out["flush"].append(time.perf_counter() - t0)
            if path.exists():  # on a mesh rank 0's files
                out["mb"][backend] = dir_bytes(path) / 1e6
    return out


def timed_line(record: list) -> str:
    """A :func:`timed_saves` record as one line: each save (``step`` for a
    step checkpoint, ``epoch`` else) and flush, in ms."""
    return ", ".join(
        f"{'flush' if kind == 'flush' else 'step' if mid else 'epoch'} "
        f"{1e3 * t:.2f}" for kind, t, mid in record)


def saves_line(t: dict) -> str:
    def ms(xs):
        return (f"median {1e3 * float(np.median(xs)):.2f} ms "
                f"({1e3 * min(xs):.2f}-{1e3 * max(xs):.2f})")

    return (f"{ORBAX_SAVES} saves each, the caller blocked: npz "
            f"{ms(t['npz'])} for {t['mb'].get('npz', float('nan')):.2f} MB, "
            f"orbax {ms(t['orbax'])} (staging) for "
            f"{t['mb'].get('orbax', float('nan')):.2f} MB, then its write "
            f"waited for by the flush {ms(t['flush'])}")


def dcp_row_shards(path: Path) -> dict:
    """The row shards of the mu2 table and its moments in an orbax
    directory: name -> sorted ``(first row, rank whose file holds it)``."""
    from torch.distributed.checkpoint import FileSystemReader

    found: dict = {}
    md = FileSystemReader(str(path)).read_metadata()
    for idx, info in md.storage_data.items():
        if idx.fqn.endswith("mu2_table"):
            rank = int(info.relative_path.split("_")[2])  # __<rank>_0.distcp
            found.setdefault(idx.fqn, []).append((int(idx.offset[0]), rank))
    return {k: sorted(v) for k, v in found.items()}


def check_row_shards(tag: str, path: Path, rows: int, m: int) -> None:
    """Each of the ``m`` row shards of the ``rows``-row table and of its
    moments written once, by a rank of that shard's model index."""
    shards = dcp_row_shards(path)
    per = rows // m
    log(f"{tag}: the table's and its moments' row shards in {path.name} "
        f"(first row, the rank whose file holds it): {shards}")
    want = {"mu2_table", "adam_mu.mu2_table", "adam_nu.mu2_table"}
    if set(shards) != want or not all(
            [r for r, _ in v] == [j * per for j in range(m)]
            and all(rank % m == r // per for r, rank in v)
            for v in shards.values()):
        raise AssertionError(f"{tag}: a rank wrote rows other than its own, "
                             f"or a shard is missing or written twice")


def orbax_mesh_runs(workdir: Path, cfg):
    """Phase 4o (d)'s runs for :func:`gloo_mesh_runs`: ``--mesh 2,2`` on
    the device tier at K = ``MESH_K``, the npz backend stopped at
    ``MESH_K_CAP`` and ``--ckpt-backend orbax`` stopped at ``MESH_K_STOP``
    and resumed to ``MESH_K_CAP``."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    root, work, cached, pack = mesh_k_workdir(workdir, cfg, "orbax_mesh")
    build_loaders(cached, root, True)  # the pack, before the ranks read it
    exp = {"npz": work / "npz", "orbax": work / "orbax"}
    flags = ["--mesh", f"{MESH[0]},{MESH[1]}", *pack, "--data-placement",
             "device", "--steps-per-dispatch", str(MESH_K), "--epochs", "1"]
    runs = {
        "npz": train_args(cfg, root, exp["npz"], *flags, "--max-steps",
                          str(MESH_K_CAP)),
        "orbax stopped": train_args(cfg, root, exp["orbax"], *flags,
                                    "--ckpt-backend", "orbax", "--max-steps",
                                    str(MESH_K_STOP)),
        "orbax resumed": [
            "train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--continue-from",
            str(run_dir(exp["orbax"], 1)
                / f"fhvae_synthetic_np_fbank_e0s{MESH_K_STOP}.orbax"),
            "--resume-override", f"max_steps={MESH_K_CAP}"],
    }
    return runs, {"exp": exp}


def _mesh_orbax_nccl_rank(workdir: str, data_root: str, shape: tuple) -> int:
    """A rank of 5n (e)'s NCCL mesh of ``shape``, after
    :func:`_mesh_k_nccl_rank` in the same launch: ``--ckpt-backend orbax``
    at K = ``MESH_K`` for an epoch, stopped at ``ORBAX_MESH_STOP`` and
    resumed to its end; then :func:`save_timings` of the resumed state on
    the mesh. Writes ``orbax_rank<r>.json``."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.parallel import mesh as mesh_module
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
    from pytorch_scalablefhvae_tpu_torch.train.step import create_train_state

    work, root = Path(workdir), Path(data_root)
    args = json.loads((work / "train_args.json").read_text())
    exp = run_dir(work / "orbax", 1)
    reset_counts(mesh_entries())
    out = {}
    with timed_saves([]) as out["record"]:
        out["text"] = run_cli(cli, args + [
            "--exp-root", str(work / "orbax"), "--mesh",
            f"{shape[0]},{shape[1]}", "--distributed", "--dist-backend",
            "nccl", "--epochs", "1", "--steps-per-dispatch", str(MESH_K),
            "--ckpt-backend", "orbax", "--max-steps", str(ORBAX_MESH_STOP)])
        out["text"] += run_cli(cli, [
            "train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--continue-from",
            str(exp / f"fhvae_synthetic_np_fbank_e0s{ORBAX_MESH_STOP}.orbax"),
            "--resume-override", "max_steps=0", "--distributed",
            "--dist-backend", "nccl"])
    out["launches"] = {e.__name__: e.launches for e in mesh_entries()}
    out["launches_tc"] = tensor_core_counts(mesh_entries())
    cfg = ExperimentConfig.load(exp / "config.json")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_module.make_mesh(shape, dev)
    state = create_train_state(mesh_module.shard_model(seeded_model(cfg),
                                                       mesh))
    ckpt.load_train_state(exp / "fhvae_synthetic_np_fbank_e0.orbax", state)
    out["saves"] = save_timings(state, cfg, work / "orbax_saves")
    (work / f"orbax_rank{mesh.rank}.json").write_text(json.dumps(out))
    return 0


def check_nccl_orbax(work: Path, shape: tuple, tag: str) -> dict:
    """5n (e): the NCCL orbax run stopped and resumed against the K =
    ``MESH_K`` npz epoch of :func:`_mesh_k_nccl_rank` (every tensor and
    record bit for bit, ``train_loss`` to 1e-12), each rank's file holding
    its own rows, no step directory left; each rank's save timings.
    Returns rank 0's launches."""
    world = shape[0] * shape[1]
    ranks = [json.loads((work / f"orbax_rank{r}.json").read_text())
             for r in range(world)]
    exp, ref = run_dir(work / "orbax", 1), run_dir(work / f"nccl_k{MESH_K}", 1)
    check_resumed(f"{tag} orbax stopped at {ORBAX_MESH_STOP} and resumed vs "
                  f"the npz epoch", exp, ref, [0], ext="orbax")
    rows = checkpoint_arrays(ref / "fhvae_synthetic_np_fbank_e0.npz")[
        "mu2_table"].shape[0]
    check_row_shards(tag, exp / "fhvae_synthetic_np_fbank_e0.orbax", rows,
                     shape[1])
    if step_checkpoints(exp, "orbax"):
        raise AssertionError(f"{tag}: a step directory outlived the epoch")
    for r, x in enumerate(ranks):
        log(f"{tag} rank {r}: the runs' saves and flushes (ms) "
            f"{timed_line(x['record'])}; the resumed state on the NCCL mesh "
            f"{shape}, {saves_line(x['saves'])}; card {smi_name_power()}")
    c = ranks[0]["launches"]
    check_tensor_core(c, ranks[0]["launches_tc"], tag)
    if not (c["discriminative_log_qy_sharded"] > 0
            and c["discriminative_log_qy_bwd"] == 0
            and c["windowed_chunk_gather"] == 0):
        raise AssertionError(f"{tag}: #7 must be launched, #6 and #8 never: "
                             f"{c}")
    return c


def phase_orbax(workdir: Path, cfg, ctx: dict | None = None,
                info: dict | None = None) -> dict:
    """Phase 4o: ``train --ckpt-backend orbax`` (``train/orbax_backend.py``:
    async saves on ``torch.distributed.checkpoint``) at the CLI defaults
    on the device tier at K = ``K_DISPATCH`` on phase 4's corpus. (a), (b)
    a two-epoch run stopped by ``--max-steps RESUME_CAP`` with
    ``--ckpt-every-steps RESUME_EVERY`` and resumed from its last step
    directory: every tensor of each epoch checkpoint equal to phase 4's npz
    run's (the run never stopped) and its records to phase 4's, no step
    directory left; (c) ``eval`` from its best pointer against ``eval`` of
    phase 4's npz checkpoint of the same epoch, the dev bound bit for bit;
    the host-clock ms the loop blocked per save and the flush waits, and
    :func:`save_timings` of both backends on one state; (d) in the shared
    gloo launch (:func:`orbax_mesh_runs`), ``--mesh 2,2`` stopped at
    ``MESH_K_STOP`` and resumed against the npz run to ``MESH_K_CAP``, bit
    for bit, each rank's file holding its own rows, the step directory
    loaded on one device equal to the npz run's whole table. Returns the
    launches of (a)/(b)'s runs (``train_orbax``)."""
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
    from pytorch_scalablefhvae_tpu_torch.train.step import create_train_state

    log(f"== phase 4o: sfhvae train --ckpt-backend orbax (async saves "
        f"through torch.distributed.checkpoint) at K = {K_DISPATCH}, "
        f"stopped and resumed; eval from its best pointer; a 2,2 mesh")
    t_phase = time.perf_counter()
    root, stem = workdir / "data", "fhvae_synthetic_np_fbank"
    ref = run_dir(workdir / "experiments", 2)
    entries = train_entries()
    reset_counts(entries)
    exp = run_dir(workdir / "orbax_k8", 2)
    with timed_saves([]) as record:
        kill_and_resume(cli, "4o (b)", root, train_args(
            cfg, root, workdir / "orbax_k8", "--epochs", "2",
            "--steps-per-dispatch", str(K_DISPATCH), "--ckpt-backend",
            "orbax"), exp, RESUME_CAP, ext="orbax")
    launches = {e.__name__: e.launches for e in entries}
    tc = tensor_core_counts(entries)
    log(f"launches during phase 4o's runs, counted from 0: {launches}; of "
        f"the LSTM entries', through the tensor-core form: {tc}")
    check_tensor_core(launches, tc, "phase 4o")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by phase 4o")
    differ = {e: differing_arrays(exp / f"{stem}_e{e}.orbax",
                                  ref / f"{stem}_e{e}.npz") for e in (0, 1)}
    log(f"4o (a) orbax against phase 4's npz run, arrays differing by epoch "
        f"checkpoint: {differ}")
    if any(differ.values()):
        raise AssertionError("4o (a): the orbax checkpoints differ from the "
                             "npz backend's")
    check_resumed(f"4o (b) stopped at {RESUME_CAP} and resumed", exp, ref,
                  [0, 1], ext="orbax")
    log(f"4o the loop blocked on each orbax save (the staging) and flush, "
        f"ms: {timed_line(record)}; "
        f"{dir_bytes(exp / f'{stem}_e1.orbax') / 1e6:.2f} MB a checkpoint; "
        f"card {smi_name_power()}")

    # (c) eval from the best pointer
    best = ckpt.find_best_checkpoint(exp)
    epoch = ckpt.read_checkpoint_meta(best)["epoch"]
    evals = {}
    for tag, d, extra in (("orbax", exp, []),
                          ("npz", ref, ["--step", str(epoch)])):
        out_dir = workdir / f"orbax_eval_{tag}"
        run_cli(cli, ["eval", str(d), "--set-name", "dev", "--data-root",
                      str(root), "--output-dir", str(out_dir), *extra])
        evals[tag] = json.loads((out_dir / "metrics.json").read_text())
    log(f"4o (c) eval from the orbax best pointer ({best.name}) against "
        f"phase 4's npz checkpoint of epoch {epoch}: dev LB "
        f"{evals['orbax']['lower_bound']!r} vs "
        f"{evals['npz']['lower_bound']!r}, log_qy "
        f"{evals['orbax']['log_qy']!r} vs {evals['npz']['log_qy']!r}")
    if best.suffix != ".orbax" or any(
            evals["orbax"][k] != evals["npz"][k]
            for k in ("lower_bound", "log_qy")):
        raise AssertionError("4o (c): the eval from the orbax pointer "
                             "differs from the npz checkpoint's")
    state = create_train_state(seeded_model(cfg))
    ckpt.load_train_state(ref / f"{stem}_e1.npz", state)
    t = save_timings(state, ExperimentConfig.load(ref / "config.json"),
                     workdir / "orbax_saves")
    log(f"4o one device, phase 4's epoch-1 state: {saves_line(t)}; card "
        f"{smi_name_power()}")
    del state
    torch.cuda.empty_cache()

    # (d) the 2,2 gloo mesh
    if ctx is not None:
        npz_dir = run_dir(ctx["exp"]["npz"], 1)
        orb_dir = run_dir(ctx["exp"]["orbax"], 1)
        name = f"{stem}_e0s{MESH_K_CAP}"
        differ = differing_arrays(orb_dir / f"{name}.orbax",
                                  npz_dir / f"{name}.npz")
        mo, mn = (ckpt.read_checkpoint_meta(d / f"{name}.json")["mid_epoch"]
                  for d in (orb_dir, npz_dir))
        gap = abs(mo["loss_sum"] / mn["loss_sum"] - 1)
        log(f"4o (d) --mesh {MESH[0]},{MESH[1]} gloo, orbax stopped at "
            f"{MESH_K_STOP} and resumed against npz, {MESH_K_CAP} steps: "
            f"arrays differing {differ}; loss sums {mo['loss_sum']!r} vs "
            f"{mn['loss_sum']!r} (relative gap {gap:.3e}, tol 1e-12); "
            f"runs' wall seconds {info['wall']}; rank 0's saves and flushes "
            f"by run (ms): " + "; ".join(f"{n}: {timed_line(v)}" for n, v
                                         in info["saves"].items()))
        if differ or not gap <= 1e-12 or mo["count_sum"] != mn["count_sum"]:
            raise AssertionError("4o (d): the orbax mesh run differs from "
                                 "the npz one")
        whole = checkpoint_arrays(npz_dir / f"{name}.npz")
        rows = whole["mu2_table"].shape[0]
        for path in (orb_dir / f"{stem}_e0s{MESH_K_STOP}.orbax",
                     orb_dir / f"{name}.orbax"):
            check_row_shards("4o (d)", path, rows, MESH[1])
        state = create_train_state(seeded_model(cfg))
        ckpt.load_train_state(orb_dir / f"{name}.orbax", state)
        got = {**state.model.state_dict(),
               **{f"adam_mu.{k}": v for k, v in state.mu.items()},
               **{f"adam_nu.{k}": v for k, v in state.nu.items()}}
        off = [k for k, v in got.items() if not np.array_equal(
            v.cpu().numpy(), whole[k][:N_TABLE] if k.endswith("mu2_table")
            else whole[k])]
        log(f"4o (d) the mesh's step directory loaded on one device: "
            f"{rows} saved table rows fitted to {N_TABLE}; tensors differing "
            f"from the npz run's whole ones: {off}")
        if off:
            raise AssertionError("4o (d): the mesh checkpoint does not load "
                                 "on one device to the npz run's tensors")
        for name, c in info["launches"].items():
            check_tensor_core(c, info["launches_tc"][name], f"4o (d) {name}")
            if not (c["discriminative_log_qy_sharded"] > 0
                    and c["discriminative_log_qy_bwd"] == 0
                    and c["windowed_chunk_gather"] == 0):
                raise AssertionError(f"4o (d) {name}: #7 must be launched, "
                                     f"#6 and #8 never: {c}")
        del state
        torch.cuda.empty_cache()
    log(f"phase 4o took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -------------------------------------------------------------- phase 4l

LEGACY_STEPS = 300   # 4l (a): --steps-per-epoch (the CLI's 5,000, cut)
LEGACY_LOG = 100     # 4l (a): --log-interval
N_DEV_CUT = 32       # 4l: dev sequences kept of phase 4's 400; a legacy dev
                     # pass runs a forward per segment at batch 1
LEGACY_RUN = f"fhvae_e{{}}_s{LEGACY_STEPS}_p10_a10.0_legacy"
UNEQUAL, WIDE = ("256", "128"), ("256", "256")   # 4l (d): the three stacks
PROGRESS_LINE = re.compile(r"^====> Train Epoch: (\d+) \[(\d+)/(\d+) "
                           r"\((\d+)%\)\]\tLoss: (\S+)$", re.M)
# 4l (b): the kernel that each call of an entry launches once in the
# tensor-core forms (the CLI defaults), and the entries that launch it
TRACE_KERNELS = {
    "lstm2_fwd_xproj_kernel": ("lstm2_tm_proj",),
    "lstm2_fwd_chain_kernel": ("lstm2_tm_proj", "lstm2_tm"),
    "lstm2_bwd_chain_kernel": ("lstm2_tm_proj_bwd", "lstm2_tm_bwd"),
    "disc_fwd_kernel": ("discriminative_log_qy",),
    "disc_bwd_fused_kernel": ("discriminative_log_qy_bwd",),
    "window_gather_kernel": ("windowed_chunk_gather",),
}


def cut_dev_corpus(cfg, root: Path, out: Path, n_dev: int) -> None:
    """Manifests under ``out`` for phase 4's features under ``root``: the
    whole training split, the first ``n_dev`` dev sequences."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import split_manifests

    src, dst = split_manifests(cfg, root), split_manifests(cfg, out)
    for split, keep in (("train", None), ("dev", n_dev)):
        for key in ("feat_pth", "len_pth"):
            lines = src[split][key].read_text().splitlines(keepends=True)
            dst[split][key].parent.mkdir(parents=True, exist_ok=True)
            dst[split][key].write_text("".join(lines[:keep]))


def plain_stack_calls() -> int:
    from pytorch_scalablefhvae_tpu_torch.models import fhvae

    return fhvae.plain_stack_calls


def trace_kernel_counts(path: Path) -> dict:
    """Kernel events of a Chrome trace by name, and its graph launches."""
    events = json.loads(path.read_text())["traceEvents"]
    counts: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    graphs = sum(1 for e in events if e.get("name") == "cudaGraphLaunch")
    return {"kernels": counts, "graph_launches": graphs}


@contextmanager
def counting_profiles(seen: list):
    """The train loop's ``epoch_profile`` wrapped to append, per profiled
    epoch, the train entries' launches inside it."""
    from pytorch_scalablefhvae_tpu_torch.train import loop

    real = loop.epoch_profile

    @contextmanager
    def counted(*args, **kw):
        entries = train_entries()
        before = {e.__name__: e.launches for e in entries}
        with real(*args, **kw) as prof:
            yield prof
            torch.cuda.synchronize()
        seen.append({e.__name__: e.launches - before[e.__name__]
                     for e in entries})

    loop.epoch_profile = counted
    try:
        yield
    finally:
        loop.epoch_profile = real


@contextmanager
def timed_dev_passes(seconds: list):
    """The train loop's host-loader ``dev_pass`` timed (synchronised wall
    seconds of each call appended to ``seconds``)."""
    from pytorch_scalablefhvae_tpu_torch.train import loop

    real = loop.dev_pass

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    loop.dev_pass = timed
    try:
        yield
    finally:
        loop.dev_pass = real


def snapshot_gap(cfg, root: Path, ckpt_path: Path) -> tuple:
    """4l (c): the ``--log-params`` gradient snapshot of ``ckpt_path``'s
    state on epoch 0's first batch, through the kernels and through the
    plain versions on the card: the gap over the snapshot's norm, the
    largest gap of one tensor over its own norm, and the launches of the
    kernels' snapshot."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.loop import batch_tensors
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        make_grad_step,
        snapshot_noise,
    )

    dev = torch.device("cuda")
    state = checkpoint_state(cfg, ckpt_path)
    loader = build_loaders(cfg, root, True)[0]
    loader.set_epoch(0)
    b = batch_tensors(next(iter(loader)), dev)
    noise = snapshot_noise(state, 0, b[0].shape[0], dev)
    grad_step = make_grad_step(10.0)
    entries = train_entries()
    reset_counts(entries)
    got = grad_step(state, *b, noise)
    torch.cuda.synchronize()
    launched = {e.__name__: e.launches for e in entries}
    with plain_versions():
        want = grad_step(state, *b, noise)
    num = sum(float((got[n] - want[n]).norm()) ** 2 for n in want)
    den = sum(float(want[n].norm()) ** 2 for n in want)
    worst = max(float((got[n] - want[n]).norm()
                      / want[n].norm().clamp_min(1e-30)) for n in want)
    return (num / den) ** 0.5, worst, launched


def phase_legacy(workdir: Path, cfg) -> dict:
    """Phase 4l: every single-device train flag on the card, on phase 4's
    corpus with its dev split cut to ``N_DEV_CUT`` sequences: (a)
    ``--legacy`` step epochs at batch 1; (b) ``--profile-dir`` at K = 1 and
    K = 8; (c) ``--tensorboard --log-params --visdom`` at K = 8; (d) the
    stacks the recurrence kernels do not take, and H 256 stacks, which they
    do. Returns the launches of (a)'s CLI runs, each counted alone
    (``train_legacy``)."""
    import importlib.util

    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    log(f"== phase 4l: --legacy at batch 1, --profile-dir, --tensorboard "
        f"--log-params --visdom, and other LSTM stacks on the card (phase "
        f"4's corpus, {N_DEV_CUT} of its {N_DEV} dev sequences)")
    t_phase = time.perf_counter()
    if plain_stack_calls():
        raise AssertionError(f"4l (e): an earlier phase ran plain_stack "
                             f"{plain_stack_calls()} times")
    log("4l (e): plain_stack was called 0 times by every earlier phase in "
        "this process")
    root = workdir / "data_4l"
    cut_dev_corpus(cfg, workdir / "data", root, N_DEV_CUT)
    lcfg = cfg.replace(train=dataclasses.replace(
        cfg.train, legacy=True, steps_per_epoch=LEGACY_STEPS,
        log_interval=LEGACY_LOG))
    legacy = ["--legacy", "--steps-per-epoch", str(LEGACY_STEPS),
              "--log-interval", str(LEGACY_LOG)]
    counts: dict = {}

    def legacy_run(name: str, exp_root: Path, *extra) -> str:
        return counted_run(counts, f"4l {name}", lambda: run_cli(
            cli, train_args(cfg, root, exp_root, *legacy, *extra)))

    # (a) --legacy at the fhvae defaults: the first B = 1 steps against the
    # plain versions, then two step epochs at K = 1 (their dev passes
    # timed) and the second again, resumed at K = 8
    compare_first_steps(lcfg, root)
    dev_s: list = []
    with timed_dev_passes(dev_s):
        out = legacy_run("(a) K = 1", workdir / "legacy_k1", "--epochs", "2")
    run = workdir / "legacy_k1" / "synthetic_np_fbank" / LEGACY_RUN.format(2)
    lines = [(int(e), int(s), int(n), float(v))
             for e, s, n, _, v in PROGRESS_LINE.findall(out)]
    want = [(e, i * LEGACY_LOG - 1) for e in (0, 1)
            for i in range(1, LEGACY_STEPS // LEGACY_LOG + 1)]
    if ([(e, s) for e, s, _, _ in lines] != want
            or not np.isfinite([v for *_, v in lines]).all()
            or "training from the host loader (--legacy)" not in out
            or "steps per dispatch" in out or not run.is_dir()):
        raise AssertionError(f"4l (a): progress lines {lines[:3]}..., the "
                             f"host loader or the run directory {run} "
                             f"missing")
    recs = metrics_in(run)
    if [r["train_steps"] for r in recs] != [LEGACY_STEPS] * 2 or \
            not np.isfinite([r["val_lower_bound"] for r in recs]).all():
        raise AssertionError(f"4l (a): records {recs}")
    for r in recs:
        log(f"4l (a) K = 1 epoch {r['epoch']}: train loss "
            f"{r['train_loss']!r}, {int(r['train_steps'])} steps of batch 1, "
            f"{1e3 * r['train_seconds'] / r['train_steps']:.3f} ms/step "
            f"(eager, B = 1); dev LB {r['val_lower_bound']!r}")
    log(f"4l (a) progress lines: {len(lines)}, e.g. "
        f"{out[out.index('====> Train Epoch'):].splitlines()[0]!r}")
    # epoch 1 again, resumed from epoch 0's checkpoint and given
    # --steps-per-dispatch 8, which legacy epochs ignore: the run never
    # stopped, at K = 1, bit for bit
    stem = "fhvae_synthetic_np_fbank"
    resumed = workdir / "legacy_resume" / LEGACY_RUN.format(2)
    resumed.mkdir(parents=True)
    for name in ("config.json", f"{stem}_e0.npz", f"{stem}_e0.json"):
        shutil.copy(run / name, resumed / name)
    out = legacy_run("(a) resumed at K = 8", workdir / "unused",
                     "--continue-from", str(resumed / f"{stem}_e0.npz"),
                     "--resume-override",
                     f"steps_per_dispatch={K_DISPATCH}")
    differ = differing_arrays(resumed / f"{stem}_e1.npz",
                              run / f"{stem}_e1.npz")
    gap = record_gap(metrics_in(resumed)[-1], recs[1])
    log(f"4l (a) resumed from epoch 0's checkpoint at --steps-per-dispatch "
        f"{K_DISPATCH} vs the run never stopped at K = 1, epoch 1: arrays "
        f"differing {differ}, record keys differing {gap}")
    if (differ or gap or "Resumed from" not in out
            or "steps per dispatch" in out):
        raise AssertionError("4l (a): the resumed legacy run differs")
    n_dev = len(build_loaders(lcfg, root, True)[1])
    log(f"4l (a) K = 1 dev passes at batch 1 ({n_dev} segments of "
        f"{N_DEV_CUT} sequences, MAP encode then scoring): "
        f"{', '.join(f'{t:.3f}' for t in dev_s)} s, "
        f"{1e3 * min(dev_s) / n_dev:.3f}-{1e3 * max(dev_s) / n_dev:.3f} ms "
        f"a segment; card {smi_name_power()}")
    if len(dev_s) != 2:
        raise AssertionError(f"4l (a): {len(dev_s)} dev passes timed")
    launches = counts["launches"]
    log(f"launches during phase 4l (a)'s {len(counts['runs'])} runs "
        f"({', '.join(counts['runs'])}), each counted from 0: {launches}; "
        f"of the LSTM entries', through the tensor-core form: "
        f"{counts['tensor_core']}")
    check_tensor_core(launches, counts["tensor_core"], "phase 4l (a)")
    for name, n in launches.items():
        if (n > 0) != (name != "windowed_chunk_gather"):
            raise AssertionError(f"4l (a): {name} launched {n} times")
    t_a = time.perf_counter() - t_phase

    # (b) --profile-dir: one epoch at K = 1 and one at K = 8
    t0 = time.perf_counter()
    for k in (1, K_DISPATCH):
        prof = workdir / f"profile_k{k}"
        seen: list = []
        with counting_profiles(seen):
            out = run_cli(cli, train_args(
                cfg, root, workdir / f"profiled_k{k}", "--epochs", "1",
                "--steps-per-dispatch", str(k), "--profile-dir", str(prof),
                "--profile-epoch", "3"))
        traces = list(prof.glob("*.pt.trace.json"))
        if len(traces) != 1 or len(seen) != 1 or \
                f"Wrote profiler trace to {prof}" not in out:
            raise AssertionError(f"4l (b) K = {k}: traces {traces}, "
                                 f"profiled epochs {len(seen)}")
        found = trace_kernel_counts(traces[0])
        rows = []
        for kernel, names in TRACE_KERNELS.items():
            wrappers = sum(seen[0][n] for n in names)
            in_trace = sum(c for name, c in found["kernels"].items()
                           if kernel in name)
            rows.append((kernel, in_trace, wrappers))
            if k == 1 and wrappers and not in_trace:
                raise AssertionError(f"4l (b): the K = 1 trace names no "
                                     f"{kernel} of {wrappers} calls")
        log(f"4l (b) --profile-dir at K = {k}: {traces[0].name} "
            f"({traces[0].stat().st_size / 1e6:.1f} MB), "
            f"{sum(found['kernels'].values())} kernel events, "
            f"{found['graph_launches']} cudaGraphLaunch; kernel (trace "
            f"count vs the wrappers' calls): "
            + ", ".join(f"{n} {t} vs {w}" for n, t, w in rows))
    t_b = time.perf_counter() - t0

    # (c) --tensorboard --log-params --visdom at K = 8
    t0 = time.perf_counter()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("tensorboard", "matplotlib")}
    for m, ok in have.items():
        if not ok:
            log(f"4l (c): {m} is not installed on this machine; its "
                f"output is not checked")
    tb = workdir / "tb"
    out = run_cli(cli, train_args(
        cfg, root, workdir / "observed", "--epochs", "1",
        "--steps-per-dispatch", str(K_DISPATCH), "--tensorboard",
        "--log-params", "--visdom", "--tb-log-dir", str(tb)))
    obs = workdir / "observed" / "synthetic_np_fbank" / "fhvae_e1_p10_a10.0"
    rec, = metrics_in(obs)
    events = list(tb.glob("events.out.tfevents.*"))
    svg = obs / "curves.svg"
    if (not np.isfinite(rec["train_loss"])
            or bool(events) != have["tensorboard"]
            or ("falling back to JSONL only" in out) == have["tensorboard"]
            or svg.is_file() != have["matplotlib"]):
        raise AssertionError(f"4l (c): record {rec}, event files {events}, "
                             f"curves {svg.is_file()}")
    rel, worst, snap = snapshot_gap(cfg, root, obs / f"{stem}_e0.npz")
    log(f"4l (c) gradient snapshot of epoch 0 (its first batch of "
        f"{B_TRAIN}), kernels vs plain on the card: {rel:.3e} of its norm "
        f"(tol {TOL_TRAIN_UPDATE:g}; the largest of one tensor "
        f"{worst:.3e}); launches {snap}; event files {len(events)}, "
        f"curves.svg {svg.is_file()}")
    if not rel <= TOL_TRAIN_UPDATE or not all(
            snap[n] > 0 for n in snap if n != "windowed_chunk_gather"):
        raise AssertionError("4l (c): the snapshot disagrees with plain")
    t_c = time.perf_counter() - t0

    # (d) one epoch each: unequal stacks (the plain route, #5/#6 alone) at
    # K = 8, against the same epoch through the plain versions; then H 256
    # stacks (the FMA kernels) at K = 1
    t0 = time.perf_counter()

    def stacks(widths):
        return [f for flag in ("--z1-hus", "--z2-hus", "--x-hus")
                for f in (flag, *widths)]

    stack_counts: dict = {}
    losses = {}
    for path in ("kernels", "plain"):
        before = plain_stack_calls()
        exp_root = workdir / f"stacks_{path}"
        with plain_versions() if path == "plain" else nullcontext():
            stack_counts[path] = {}
            counted_run(stack_counts[path], f"4l (d) {path}", lambda: run_cli(
                cli, train_args(cfg, root, exp_root, "--epochs", "1",
                                "--steps-per-dispatch", str(K_DISPATCH),
                                *stacks(UNEQUAL))))
        rec, = metrics_in(run_dir(exp_root, 1))
        losses[path] = (rec, plain_stack_calls() - before)
    (rk, calls), (rp, _) = losses["kernels"], losses["plain"]
    got = stack_counts["kernels"]["launches"]
    loss_gap = abs(rk["train_loss"] / rp["train_loss"] - 1)
    log(f"4l (d) stacks {'/'.join(UNEQUAL)}: launches {got}, plain_stack "
        f"{calls} calls; train loss {rk['train_loss']!r} vs "
        f"{rp['train_loss']!r} through the plain versions (relative "
        f"{loss_gap:.3e}, tol {TOL_TRAIN_LOSS:g}), "
        f"{1e3 * rk['train_seconds'] / rk['train_steps']:.3f} ms/step, dev "
        f"LB {rk['val_lower_bound']!r}")
    if (any(got[e.__name__] for e in train_entries()[:2] + train_entries()[3:5])
            or not got["discriminative_log_qy"]
            or not got["discriminative_log_qy_bwd"] or not calls
            or not np.isfinite(rk["train_loss"])
            or not loss_gap <= TOL_TRAIN_LOSS):
        raise AssertionError("4l (d): the unequal stacks' epoch")
    wide: dict = {}
    before = plain_stack_calls()
    counted_run(wide, "4l (d) H 256", lambda: run_cli(cli, train_args(
        cfg, root, workdir / "stacks_wide", "--epochs", "1",
        *stacks(WIDE))))
    rec, = metrics_in(run_dir(workdir / "stacks_wide", 1))
    log(f"4l (d) stacks {'/'.join(WIDE)}: launches {wide['launches']}, of "
        f"them tensor-core {wide['tensor_core']}; plain_stack "
        f"{plain_stack_calls() - before} calls; train loss "
        f"{rec['train_loss']!r}, "
        f"{1e3 * rec['train_seconds'] / rec['train_steps']:.3f} ms/step")
    lstm = [e.__name__ for e in (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
                                 lstm_cuda.lstm2_tm_proj_bwd,
                                 lstm_cuda.lstm2_tm_bwd)]
    if (plain_stack_calls() != before or not np.isfinite(rec["train_loss"])
            or not all(wide["launches"][n] > 0 for n in lstm)
            or any(wide["tensor_core"][n] for n in lstm)):
        raise AssertionError("4l (d): the H 256 stacks' epoch")
    t_d = time.perf_counter() - t0
    log(f"phase 4l took {time.perf_counter() - t_phase:.1f} s: (a) "
        f"{t_a:.1f}, (b) {t_b:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f}; card "
        f"{smi_name_power()}")
    return launches


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default=None,
                        help="comma-separated phases to run after phase 1 "
                             "(2, 2f, 2b, 2c, 2g, 2d, 2e, 3, 3b, 4, 4k, 4s, "
                             "4h, "
                             "4m, 4p, 4b, 4q, 5, 5t, 5k, 5h, 4r, 4o, 4l; 5n, "
                             "on four cards, only when named; 2 includes "
                             "2f, 4k, 4b, 4r and 4o need 4); default all but "
                             "5n")
    only = parser.parse_args(argv).only
    only = None if only is None else set(only.split(","))
    if only is not None and "2" in only:
        only.add("2f")
    if only is not None and {"4b", "4k", "4r", "4o"} & only:
        only.add("4")

    def on(phase: str) -> bool:
        # 5n needs four cards: it runs only when named
        return (only is None and phase != "5n") or (only is not None
                                                    and phase in only)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    seconds: dict = {}

    def timed(phase: str, fn, *args, **kw):
        """``fn(*args, **kw)``, its wall seconds kept under ``phase``."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            seconds[phase] = round(time.perf_counter() - t0, 1)

    timed("1", phase_environment)
    results: dict = {}
    for phase, fn in (("2", phase_kernels), ("2f", phase_disc_forward),
                      ("2b", phase_backward),
                      ("2c", phase_gather), ("2g", phase_stage_gather),
                      ("2d", phase_logmel),
                      ("2e", phase_sharded)):
        if on(phase):
            results.update(timed(phase, fn))
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    by_path: dict = {}
    try:
        if on("3"):
            by_path.update(timed("3", phase_serve, workdir))
        if on("3b"):
            if not on("3"):
                write_corpus(workdir / "wav")
            by_path["preprocess"] = timed("3b", phase_preprocess, workdir)
        if any(on(p) for p in ("4", "4s", "4h", "4m", "4p", "5", "5t",
                               "5k", "5h", "5n", "4o", "4l")):
            cfg = timed("corpus", write_feature_corpus, workdir / "data")
            log(f"corpus written in {seconds['corpus']:.1f} s")
        epoch0 = None
        if on("4"):
            by_path["train"], runs = timed("4", phase_train, workdir, cfg)
            epoch0 = runs["device"][0]
        if on("4k"):
            by_path["train_k8"] = timed(
                "4k", phase_train_k8, workdir, cfg,
                {**runs, "launches": by_path["train"]})
        if on("4s"):
            by_path["train_stream"] = timed("4s", phase_stream, workdir, cfg,
                                            keep_big=on("4h") or on("5h"))
        if on("4h"):
            by_path["train_hier"] = timed("4h", phase_hier, workdir, cfg)
        if on("4m"):
            by_path["train_simple"] = timed("4m", phase_simple, workdir, cfg)
        if on("4p"):
            by_path["train_plan"] = timed("4p", phase_plan, workdir, cfg)
        if on("4b"):
            by_path["eval"] = timed("4b", phase_eval, workdir)
        if on("4q"):
            timed("4q", phase_quality, workdir)
        if on("5"):
            by_path["mesh"] = timed("5", phase_mesh, workdir, cfg, epoch0)
        # the gloo runs of 5t, 5k (b), 5h (a) and 4o (d): four ranks
        # started once; the NCCL rank of 5k (a) and 5h (b): started once
        gloo = [p for p in ("5t", "5k", "5h", "4o") if on(p)]
        gloo = gloo and timed("5 gloo ranks", gloo_mesh_runs, workdir, cfg,
                              gloo)
        nccl = [k for p, k in (("5k", "k"), ("5h", "hier")) if on(p)]
        nccl = nccl and timed("5 nccl rank", nccl_mesh_runs, workdir, cfg,
                              nccl, (1, 1), "5k (a), 5h (b)")
        if on("5t"):
            by_path["mesh_tiers"] = timed("5t", phase_mesh_tiers, workdir,
                                          cfg, *gloo["5t"])
        if on("5k"):
            by_path["mesh_k8"] = timed("5k", phase_mesh_k, workdir, cfg,
                                       epoch0, *gloo["5k"], nccl)
        if on("5h"):
            by_path["mesh_hier"] = timed("5h", phase_mesh_hier, workdir, cfg,
                                         *gloo["5h"], nccl)
        if on("5n"):
            by_path.update(timed("5n", phase_mesh_k_cards, workdir, cfg))
        if on("4r"):
            by_path["train_resume"] = timed("4r", phase_resume, workdir, cfg)
        if on("4o"):
            by_path["train_orbax"] = timed("4o", phase_orbax, workdir, cfg,
                                           *gloo["4o"])
        if on("4l"):
            by_path["train_legacy"] = timed("4l", phase_legacy, workdir, cfg)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = []
    for name, r in results.items():
        source, replaces = SOURCES[name]
        counts = {path: c[name] for path, c in by_path.items() if name in c}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "form": r["form"],
            **{k: r[k] for k in ("fma_form_ms", "passes_ms", "chain_floor_ms",
                                 "events_ms", "by_shape", "bound_fp32_ms",
                                 "bound_3xtf32_ms", "bound_form_ms",
                                 "dynamic_range_err", "library_dtype",
                                 "library_route", "library_fp32_ms",
                                 "library_by_form", "by_dtype")
               if k in r}})
    if only is None:
        for k in kernels:
            if k["launches"] <= 0:
                raise AssertionError(f"{k['name']} was launched by no path")
    log(f"wall seconds by phase: {seconds}; {time.perf_counter() - t_start:.1f}"
        f" s in all; card {smi_name_power()}")
    print(smi_name_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
