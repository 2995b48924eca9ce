"""On-card smoke of the PyTorch/CUDA port (`tpu_dp_torch`): run from the
repository root on a machine with one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. header: the card (torch and ``nvidia-smi``); no CUDA → exit 1;
2. build: every kernel of the port (conv_block.cu, xent.cu, augment.cu),
   one nvcc per source, started together; each conv instance's registers,
   spills and static shared memory from the ptxas report, and the draw
   kernel's;
3. kernel vs plain, eval: the conv kernel's public wrappers against its
   plain PyTorch version on the card, at B=32 for the four ResNet-18 shapes
   x the three eval variants x f32/bf16 inputs (tolerance: one bf16 ulp at
   the output's magnitude), with CUDA-event times of the kernel
   (back-to-back launches through its C entry; ``wrapper_ms`` is one
   public-wrapper call per event pair), the plain version and one cuDNN
   conv of the same size (``library_ms``) beside the bound and the tile
   the kernel picked; then the same checks,
   untimed, at the serve ladder's other buckets (1, 2, 4, 8, 16), where
   tiles are only partly filled;
4. kernel vs plain, train, at the training batch B=128 for the four
   stages: the ``emit_stats`` conv (emit_z and residual on or off, f32; y
   within one ulp, stats within 1e-5 * sum|y| of the plain sums of the
   kernel's own y), and its stats fold three ways: bit-exact against
   ``ordered_stats_sum`` replayed on the card over the partial rows the
   same launch left in its scratch, and bit-identical across two launches,
   across three replays of a CUDA graph of one ``fused_conv_bn`` call and
   on a launch made while a large matmul runs on a side stream (blocks
   finish in another order); the fold's cost (``emit_stats`` time minus
   the stats-off time of the same shape, both through the C entry); the
   input-grad reuse (bf16 ct, flipped weight, no activation; one ulp), the
   autograd rule's five gradients against the plain version's autograd
   (max|g - g_plain| <= 2e-2 * max|g_plain|), and the xent kernels: per
   example forward and backward at C = 10 and 100 (f32 within 1e-6), the
   batch-mean variants at B = 1, 7, 128, 1000 (within 1e-6 of the plain
   versions, loss bit-identical across launches, gradient bit-identical to
   the per-example kernel + torch mean + MeanBackward route) and, untimed,
   labels outside [0, C) (the JAX kernels' logsumexp loss and softmax * ct
   gradient); ragged batches B = 1, 3, 127 at every stage (emit_stats: y
   one ulp, z equal, the same three fold checks; input-grad one ulp); the
   host microseconds of one wrapper call and of the C entry alone;
   each timed beside its bound, its plain version and one library call
   (cuDNN bf16 conv2d / conv2d_input, torch.sum, F.cross_entropy) — the
   convs by CUDA events over back-to-back launches, the microsecond xent
   kernels and sums by their device time under the profiler (an event
   loop would time the host's launch rate, which is also recorded);
5. serve: the full-width fused CIFAR ResNet-18 (f32, random weights and
   random BN statistics from a seed) behind `InferenceEngine` with
   buckets 1..32, each a CUDA graph captured at warmup, 200 Poisson
   requests of 1-4 images: audited books, the device class histogram
   equal to the handles' predictions, 0 retraces, the launch books (10
   per eager warm-up pass and per capture, the replays equal to the
   warm-up's plus the batches; 10 kernels by name per replay under the
   profiler), and bucket-32 logits equal to the same weights run unfused
   (cuDNN) within 1e-2 of their magnitude; the bucket-32 serve step as
   its graph against eager;
5b. serve_cluster: `ServeCluster` on phase 5's model: (a) two replicas
   sharing the card, each on its own stream, 400 Poisson requests at
   800/s in two SLO classes: books per class, both replicas serving, one
   capture per bucket per replica, the launch books, each replica's
   bucket-32 graph bit-identical to its eager step; (b) the CLI's chaos
   matrix (drain, hot swap, rejoin; the membership ledger, version
   stamps, ``obs timeline``), and in process the post-swap answers equal
   to an eager forward of the swapped weights; (c) failover of a replica
   whose programs raise; (d) a wedged replica quarantined and restored;
   (f) with two or more cards `tools/port_serve_multicard.py`;
6. train: `Trainer` on ``--preset=resnet18_cifar10 --model.fused_stages=all
   --model.fused_bwd=true --train.pallas_xent=true`` at full width (f32,
   batch 128, synthetic data), 30 steps and one eval: finite losses that
   fall, exactly 20 conv-kernel launches and 2 xent launches per step
   (and the same 20 + 2 by kernel name under the profiler, with no stats
   reduce kernel) and 10 per eval forward, the first 5 losses within
   0.05 of the same init and batches run unfused without kernels, a
   number for the accuracy; step time, device-busy share, top kernels and
   peak memory (its epoch save and final export go to a temporary
   directory);
7. data parallel (`tpu_dp_torch.parallel`), full width, f32, B=128 per
   rank, against one process on the concatenated batch (per-step global
   loss within 0.05, the fused bound of phase 6) with the ranks'
   parameters and buffers bit-identical and each rank's books per step
   (20 conv launches, 1 + 1 xent, 20 + 20 sync-BN pmeans, one metrics
   all-reduce, DDP's buckets): (a) two ranks on the one card through
   gloo on CUDA tensors (NCCL refuses two ranks on one card; a
   correctness run, its step time no DDP figure), each pair's rank 0
   with the comm attribution's window over updates [2, 4)
   (`_comm_report_checks`: source "host", every kind reconciled with the
   books, the sharded wire against `quant.wire_report`); (b) `Trainer` at world 1
   on NCCL through `initialize()` and the env contract, 30 steps and one
   eval, against the same run in one process (losses within 0.05, falling;
   books per update; eval count = test set), its step beside the one
   process's and, in turns on one model, the step with and without DDP's
   wrapper; the same run (cuDNN deterministic) with
   ``--obs.comm_profile_steps=10:20`` against it without: source
   "device", the window's conv and xent kernels by name equal to the
   books, the spin bracket left out, the NCCL kernels printed (none at
   one rank, each kind absent), the parameters bit for bit;
   (c) with two or more cards, NCCL with one rank per card (two, and every
   visible card), else ``ddp_nccl_multi_card: not run, 1 card visible``
   (and ``commprof_nccl_multi_card: not run``: the comm windows across
   cards are `tools/port_commprof_multicard.py`'s);
8. checkpoint (run between phases 6 and 7): the same fused full-width
   path, f32, cuDNN deterministic, B=128, 10 steps an epoch: 3 epochs
   uninterrupted; the same run interrupted at the start of epoch 3 and resumed by a fresh
   `Trainer` with ``--resume``: the restored state bit-identical to the
   interrupted run's and to the uninterrupted run's epoch-2 state, epoch
   3's losses, the final state and the eval bit-identical to the
   uninterrupted run's, 20 conv + 1 + 1 xent launches every step; the
   costs (the save's blocking ms on the training thread, its background
   write ms, the payload MB, a verified load, the first resumed step
   against a steady one); `InferenceEngine.from_checkpoint` of the
   epoch-3 save with buckets 1..32 and 50 Poisson requests (audited books,
   10 conv launches per captured forward x replays, bucket-32 logits
   bit-identical to the
   trained model's eval forward); the reference workload (`Net`, batch 4,
   ``python -m tpu_dp_torch.train`` with synthetic data, 200 steps an
   epoch, 2 epochs) as a subprocess on the card (exit 0, falling finite
   losses, ``Finished Training``, its final params loaded back), a
   card-vs-CPU `Net` forward and gradient from one seed within 1e-4 of
   max|.|, and 1 + 1 xent launches a step with ``--train.pallas_xent=
   true``; every save goes to a temporary directory;
9. windows (``train.steps_per_call``) and ``optim.grad_accum_steps``, run
   last: (f) the xent kernels' one-CTA route at [128, 10] within 1e-6 of
   the plain versions, the mean bit-identical across 100 launches and 3
   CUDA-graph replays, an empty kernel's device time (the launch floor),
   and both routes' device time by batch; on the fused full-width
   ResNet-18, f32, B=128, cuDNN deterministic: (a) 40 eager updates against
   windows of 10 (an eager warm-up window, then one capture replayed 3
   times) under ``--train.recompile_guard=raise`` (0 retraces, the window
   guard's cache size 1), per-update losses, final state (parameters, BN
   statistics, momentum) and eval bit-identical, the books per update
   from the captured counts × replays and per replay by kernel name under
   the profiler; (c)
   eager step ms against windowed ms per update, images/s by the fenced
   meter, device busy share and ops per update, host ms per window, the
   capture's ms and bytes (each timed over `WINDOW_TURNS`); at world 1
   on NCCL: (d) phase 7b's run with windows of 10, bit-identical to its
   eager run, and DDP's added ms per update both ways (`DDP_TURN_REPS`);
   (b) ``grad_accum_steps=2`` at B=64, eager against
   windowed, bit-identical, 2 × (20 + 1 + 1) launches and one DDP
   all-reduce set per update; (e) phase 8's interrupted and resumed run with
   windows of 5, bit-identical to the uninterrupted one;
10. ResNet-50 on synthetic CIFAR-100 (``--preset=resnet50_cifar100
   --model.fused_stages=all --model.fused_bwd=true
   --train.pallas_xent=true``, f32, B=128; every stride-1 bottleneck's
   3x3 on the conv kernel, 13 per forward): (a) ``resnet50_kernels``: the
   conv kernel at the four bottleneck shapes with f32 x from a cuDNN 1x1
   conv, no residual, no emit_z (eval and ``emit_stats`` variants, y one
   ulp, stats bit-exact with ``ordered_stats_sum`` and across launches,
   graph replays and a busy side stream; the input-grad, one ulp), each
   timed beside its bound, plain version and cuDNN bf16; the xent mean
   pair at [128, 100] on its multi-block route (1e-6, bit-identical over
   100 launches and 3 graph replays, device time beside
   ``F.cross_entropy``'s and the launch floor); (b) ``resnet50``:
   `Trainer` for 30 steps and one eval (finite losses, 13 + 13 conv and
   1 + 1 xent launches a step by counter and by kernel name, 13 per eval
   forward, the first 5 losses and all 30 within 0.05 of the unfused run
   without kernels, the eval count the test set, step ms, images/s, device busy
   share, top kernels, peak memory), its epoch save served by
   `InferenceEngine.from_checkpoint` (bucket-32 logits bit-identical to
   the trained model's), the same 30 steps with augmentation off (the
   loss falls), and phase 5's serve on the random-weight ResNet-50; (c)
   ``resnet50_windows``: phase 9's (a) and (c) with augmentation off, 40
   eager updates against windows of 10 bit-identical, losses falling,
   books per replay by kernel name, ms per update both ways (over fewer
   turns than phase 9, `R50_WINDOW_TURNS`), host ms per window, the
   capture's ms and bytes, and auto windows of 24; (d)
   ``resnet50_ddp``: phase 7b's run, 5 steps with augmentation off, within
   0.05 of one process, with its books;
11. ``sharded``: the sharded weight update (``--train.update_sharding=
   sharded``) on the fused full-width ResNet-18, f32 weights, B=128,
   cuDNN deterministic, at world 1 on NCCL through `initialize()` and the
   env contract (the exchange's collectives issued): (a) 30 updates and
   one eval per wire (f32, bf16, int8; unbucketed and at
   ``--train.bucket_mb=25``) against the replicated run: f32 bit-identical
   to it (losses, parameters, BN statistics, momentum), bf16 and int8
   finite and falling, their parameters after 6 updates within 4e-3 and
   6e-3 of f32's and not equal to them, ``quant_overflow`` 0; the books
   per update (10 + 10 conv, 1 + 1 xent; reduce-scatters, all-to-alls and
   all-gathers as the exchange plan says) by counter, and by kernel name
   under the profiler for one update, with its NCCL kernels; step ms;
   momentum and residual bytes per rank and the fit's peak memory; (b)
   windows of 10 against 40 eager updates for f32, bf16, int8 and int8 at
   25 MB (phase 9's checks and times), beside the replicated windows run
   without a group; (c) phase 8's interrupted and resumed run under int8
   at 25 MB, bit-identical to the uninterrupted one (residuals included);
   (d) ResNet-50 int8 at 25 MB, 10 updates: books and finite losses.
   (b) reuses (a)'s 30 eager updates per wire as its eager half and runs
   the windowed half at 30 updates, timing each wire over fewer turns
   than phase 9 (`SHARDED_B_TURNS`); its replicated windows are phase
   9a's record when phase 9 ran in the same call. ``seconds`` records
   each part's time, and (b)'s per wire its fits, books and timing.
   Phase 7a also runs the sharded update (f32 and int8) on its two gloo
   ranks, and prints ``not run`` with gloo's error if gloo refuses a
   collective on CUDA tensors; phase 7c adds sharded f32 and int8 at
   world 2 and every card;
12. ``resident``: the device-resident feed (``data.device_resident``) on
   ``--preset=resnet18_cifar10`` with the kernel knobs, augmentation on,
   f32, B=128, cuDNN deterministic, over a 50,000-image synthetic train
   set (the CIFAR-10 table, 153.8 MB): one epoch resident and streamed
   in windows of 24 and its first 96 updates eager, bit-identical (losses, parameters, BN statistics, momentum, eval;
   the eager pair's losses the windowed run's first 96) with the same
   books per update (10 + 10 conv, 1 + 1 xent); the windowed pair under ``update_sharding=sharded``
   f32 at NCCL world 1 (four windows); a resident run interrupted 240
   updates in and resumed, bit-identical; a re-staged table recaptures
   the window; the staging ms and table bytes, H2D bytes per window, host
   ms per window (the feed's placement and the window call), windowed ms
   per update in turns, epoch images/s, device busy share and each fit's
   added peak memory, beside the streamed feed's;
13. ``presets``: the kernels at ``bf16_cosine_gb4096``'s call pattern
   (``emit_stats`` with bf16 x at B=512 for every stage and variant of a
   train forward: y one bf16 ulp, stats bit-exact with
   ``ordered_stats_sum``; the input-grad at B=512, one ulp; the xent mean
   pair at [512, 10] on its multi-block route, 1e-6), each timed beside
   its bound, plain version and library call; ``--preset=
   bf16_cosine_gb4096`` with the kernel knobs (bf16 compute, f32
   parameters, per-card batch 512), 30 updates, eager and in windows of
   10, augmentation off: finite falling losses, windows bit-identical,
   books, every conv launch on bf16 x at B=512, step ms and images/s;
   ``--preset=resnet18_8chip_gb1024`` (per-card batch 128), 10 updates:
   books and finite losses;
14. ``resilience``: the main path's resilience defaults, on
   ``--preset=resnet18_cifar10`` with the kernel knobs, f32, B=128, the
   default resident feed, augmentation on, windows of 10, cuDNN
   deterministic: (a) the crop/flip draw kernel against its plain version
   bit for bit (100 step keys x row offsets 0 and 128 of a global 512 x
   accumulation keys; inside a CUDA graph over 3 replays), its device
   time beside an empty kernel's, the plain version's and its bound; (b)
   60 uninterrupted updates (the main path: books per update with one
   draw launch per update by counter; by kernel name per replay, recorded),
   and the windowed ms per update with augmentation on and off in turns;
   (c) a CLI subprocess (``python -m tpu_dp_torch.train`` with cuDNN
   deterministic, ``--resilience.snapshot_every_steps=10``) parked at its
   step-20 boundary by a delay fault and sent a real SIGTERM by this
   process: exit 143, ``preempted:`` printed, the step-20 snapshot
   committed and ``flightrec_r00000.json`` with the preemption's events;
   ``--resume`` in process bit-identical to the uninterrupted run (losses,
   parameters, statistics, momentum, eval); ``preempt:step=15`` in process
   and ``kill:step=11`` in a subprocess (exit 137), each resumed
   bit-identical; the snapshot's blocking ms and the epoch's ms per update
   with and without the cadence, in turns; (d) the sharded update at NCCL
   world 1: ``preempt:step=15``, its one snapshot and the resume,
   bit-identical to the uninterrupted sharded run;
15. ``guard``: the guard (``--guard.enabled=true``) on phase 14's path in
   one epoch of 30 updates, windows of 10, cuDNN deterministic: (a) the
   guarded run against the unguarded one: losses, state and eval bit for
   bit, the books unchanged by counter (20 conv + 1 + 1 xent + 1 draw an
   update) and by kernel name per replay (the conv and xent kernels equal
   to the books, guarded and not, at their most over up to three profiler
   sessions; the draw kernel's count recorded), nothing quarantined, one
   fence per window; (b) ``nan:step=13`` under ``action=skip``: steps 14-20
   quarantined (the frozen counter poisons the rest of the window) with
   their sample ranges, the device counter at batches less skips, the
   state bit for bit that of the unguarded run that never ran those
   batches; (c) ``spike:step=15`` under ``action=rollback`` with
   snapshots every 10: rolled back from 20 to 10 (tombstone, generation
   1) and finished on the clean run's state bit for bit; (d) ``action=
   halt`` through a CLI subprocess: ``diverged:``, exit 65; (e) three gloo
   ranks of the reference ``Net`` on the card (``--guard-worker``),
   ``sdc:step=3,rank=2`` with the audit every 2 steps: every rank halts
   naming rank 2 and ``conv1/bias``, the step-3 snapshot quarantined; the
   windowed ms per update and an epoch's ms per update guarded and not, in
   turns, and the guard's fence host ms per window;
16. ``obs``: the telemetry (``--train.obs``) on phase 15's path, the guard
   off, cuDNN deterministic: one epoch of 30 updates in windows of 10 at
   off, basic and full: the books identical by counter and by kernel
   name per replay, the parameters bit for bit,
   the host's synchronisations (`torch.cuda.set_sync_debug_mode` plus
   `Event.synchronize` calls, with their calling lines) over each fit and
   over one more epoch equal at basic and one more a window at full; at
   full one ``metrics.jsonl`` record per update, the ``obs.mfu`` gauge
   within 10% of the MFU of the window's CUDA-event time (the card's
   dense bf16 peak), the ``device`` span within 10% of that time, the
   memory gauges, a valid ``trace.perfetto.json``, one heartbeat a window
   and the promfiles; ``--train.profile_steps=10:20``: a CUDA-only Chrome
   trace holding the conv and xent kernels of the two windows in range
   and no other's, with the flight recorder's ``profile_start`` and
   ``profile_stop``; ``python -m tpu_dp_torch.obs`` over the full run's
   directory: ``timeline``, ``stragglers``, ``merge-trace`` and ``diff``
   against its own baseline exit 0 (against a tampered one 1), ``watch
   --replay`` 0 clean and 1 on a rule that must trip; an epoch's ms per
   update at each mode, in turns;
17. ``elastic``: the elastic shrink (``--resilience.elastic=true
   --resilience.elastic_verify_fingerprint=false``) on the main path (the
   preset with the kernel knobs, the default resident feed, augmentation
   on, f32, B=128 a rank): (a) three gloo ranks on ``cuda:0``
   (``--elastic-worker``; NCCL refuses two ranks on one card), 3,200
   images, one update a call, ``leave:step=2,rank=2``: rank 2 exits 143;
   the ledger holds epoch 0, the graceful plan (leavers [2], survivors
   [0, 1]), every check-in and ack, the departure and epoch 1 at world 2;
   the final snapshot's lineage is ``[[3, stop_step]]``; the samples the
   two epochs consumed, read from the ranks' index lists, equal what the
   record predicts (`ShardedSampler`, `elastic_resplit`), the drop the
   one ``drop_remainder`` predicts; the survivors' states bit-identical;
   their losses within ``DDP_LOSS_TOL`` of a one-process oracle on the
   card fed the global batches rebuilt from the record (every update
   through 20 after the regroup: all of (a)'s); every rank's
   books exact at both worlds (20 conv, 1 + 1 xent and one draw an
   update, 10 conv an eval forward); one regroup; the regroup's seconds
   and the ms per update at world 3 and 2; (b) with two or more cards,
   NCCL one rank a card, world 2 -> 1 by ``leave:`` on rank 1, windows of
   10 as CUDA graphs released before the old group goes and recaptured on
   the new one, the interrupted epoch alone (20,480 images), the same
   checks; else ``elastic_nccl_multi_card: not run, 1 card visible``;
   the rollback flavour (``--resilience.regroup_timeout_s=15``, the
   collection window; snapshots every 2 updates): (c) (a)'s ranks with
   ``kill:step=5,rank=2`` (``os._exit(137)``): rank 2 exits 137 and ranks
   0 and 1 exit 0; the plan rollback with rank 2 departed ("no quiesce
   check-in (timeout)"), no leaver and survivors [0, 1], no live rank
   departed; record 1 ``reason`` "rollback" at world 2; its resume the
   newest complete save at or before the kill (as the saves stood at the
   failure), lineage ``[[3, 4]]``; the samples consumed, counted from the
   resume point (the killed rank's from its own log of placements), equal
   the record's; survivors bit-identical; losses within ``DDP_LOSS_TOL``
   of the oracle through 20 updates after the regroup; books exact at the
   last boundary before the failure and at world 2 with the replay and
   the eval, the failed update's launches a prefix of one update; one
   regroup; rank 2's exit to each survivor's first update at world 2 on
   the wall clock, split into detection, the collection window, the
   barrier, re-form, rebuild, reload and replay, and the ms per update
   at world 3 and 2; (d) phase 15 (e)'s three gloo ranks of ``Net`` on
   the card, elastic, ``--train.pallas_xent=true``, the guard with the
   audit every 2 steps and ``sdc:step=3,rank=2``: rank 2 exits 143 with
   ``guard_evict`` in its flight recorder, record 1 "rollback" with a
   departure reason naming the SDC audit, its resume at or before step
   3, the quarantine log naming rank 2, the survivors bit-identical at
   world 2 after both epochs, the xent books exact; (e) with two or more
   cards (b)'s NCCL pair with ``kill:step=30,rank=1``: the survivor's
   window fence finds the wedged replay within its deadline (a third of
   the window), aborts the communicators, releases the graph, re-forms at
   world 1, recaptures its window and resumes from the newest complete
   snapshot, (c)'s checks; else ``elastic_rollback_nccl_multi_card: not
   run, 1 card visible``; the grow: (f) (a)'s ranks through the port's
   entry point (`run_elastic`) with ``relaunch:step=2,rank=2`` and
   snapshots every 2 updates: rank 2 departs as a leaver, rejoins in its
   own process (its kernels already built) and the world grows back;
   every rank exits 0; the ledger tells 3 -> 2 -> 3: record 1 "graceful"
   with sid 2 departed at world 2, record 2 "grow" with ``joined`` the
   token of rank 2's own request, members [0, 1, 2], ``service_sid`` 0
   and a commit verdict; rank 2's state right after its restore equals
   the grow snapshot it loaded, byte for byte; all three end
   bit-identical; the losses within ``DDP_LOSS_TOL`` of the one-process
   oracle fed the global batches rebuilt from the records alone (3 -> 2
   -> 3); each sample of each epoch once across the segments, as the
   records predict; every rank's books exact at every world (rank 2 after
   it rejoined too); two regroups; at ``train.obs=basic``, ``obsctl
   fleet --replay`` over its directory gives one ``fleet_step`` a step,
   each at the membership epoch and world the records give it, and
   ``obsctl timeline`` the departure before the rejoin; the grow's
   seconds split into the
   joiner's rebuild, its request up to the plan, the quiesce up to the
   final snapshot, the join-ready gate, the re-form and the joiner's
   reload, and the ms per update at worlds 3, 2 and 3; (g) two gloo ranks
   of ``Net`` with ``--train.pallas_xent=true`` and a 15 s gate, and a
   join request for sid 2 forged into the live generation that no process
   answers: both exit 0 after both epochs; record 1 "grow" admits sid 2,
   record 2 ``grow_aborted`` at [0, 1] with sid 2 departed "join handshake
   timeout (grow aborted)" and record 1's resume (its snapshot on disk),
   an abort verdict; nothing replayed; bit-identical; the xent books
   exact; the seconds the aborted grow cost; (h) with two or more cards
   (b)'s NCCL pair with ``relaunch:step=10,rank=1`` over two epochs,
   world 2 -> 1 -> 2, each world's windows captured again, (f)'s checks;
   else ``elastic_grow_nccl_multi_card: not run, 1 card visible``. Every
   rank process ends within ``ELASTIC_RANK_DEADLINE_S`` or the phase
   kills them all and fails naming the rank. (a), (d), (f) and (g) run
   beside (c): their ranks start once (c)'s rank 2 has exited, while
   (c)'s survivors wait out the window;
18. the kernels' JSON line, then ``{"ok": true, "device": {...}}``.

Phases 1-11 keep the streamed feed (``--data.device_resident=off``), so
their numbers stay comparable with earlier runs.

``python3 chip_smoke.py --only ddp_nccl_world1,ddp_nccl_multi_card`` runs
the header, the build and the named phases alone (a four-card machine's
multi-card check), without the kernels' line; ``--only
resnet50_kernels,resnet50,resnet50_windows,resnet50_ddp`` runs phase 10
alone, ``--only sharded`` phase 11, ``--only resident,presets`` phases
12 and 13, ``--only resilience`` phase 14, ``--only guard`` phase 15 and
``--only obs`` phase 16 and ``--only elastic`` phase 17.
``--ddp-worker SPEC`` is phase 7's rank process, ``--guard-worker SPEC``
phase 15's and ``--elastic-worker SPEC`` phase 17's.

Every by-name check of the launch books (phases 6, 9, 10, 11, 14, 15,
16) holds one rule (`_by_name_verdict`): each kernel's count, its most
over up to three profiler sessions of CUDA activity, equals the books,
and a count above them fails at once. Each session starts and ends with
spin kernels of `PROFILE_SPIN_CYCLES`, waited for and left out
(`PROFILE_LEAD_IN`): without them a session lost the records of the
first kernels it saw (`tools/port_profiler_loss.py`) and of the last
(`tools/port_profiler_drops.py`: the tail of a ResNet-50 window's
replay). The wrappers' counter books beside it are exact too.

Every timed case also prints ``bound_share`` (bound_ms / ms) and
``vs_library`` (ms / library_ms).

TF32 is off for every phase (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): f32 means f32 in the plain
version and in the unfused reference. The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
#: outside the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
#: 32-bit integer operations outside the tensor cores: half the f32 rate
#: (64 INT32 lanes an SM against 128 FP32; the data sheet lists no INT32
#: rate, so this is the architecture white paper's lane count at the same
#: clock).
PEAK_INT32_OPS = PEAK_F32_FLOPS / 2
PEAK_BYTES = 3.35e12
B = 32
#: the serve ladder's other buckets, checked against the plain version.
SMALL_BUCKETS = (1, 2, 4, 8, 16)
STAGES = ((32, 64), (16, 128), (8, 256), (4, 512))  # (H = W, C)
VARIANTS = ("plain", "emit_z", "emit_z+res")
#: one B=32 full-fused ResNet-18 forward: (stage, variant) per launch.
FORWARD_CALLS = ((0, "emit_z"), (0, "plain"), (0, "emit_z+res"),
                 (0, "plain"), (1, "emit_z"), (1, "plain"),
                 (2, "emit_z"), (2, "plain"), (3, "emit_z"), (3, "plain"))
KERNEL = "conv_block.fused_affine_relu_conv"
#: the training batch, and the variants of one train forward's 10
#: emit_stats launches (the same pattern as FORWARD_CALLS).
TRAIN_B = 128
TRAIN_VARIANTS = ("plain", "emit_z", "res", "emit_z+res")
#: ragged batches: the new tile's partly filled edges (untimed checks).
RAGGED_B = (1, 3, 127)
#: one train step's 10 input-grad launches, by stage.
INPUT_GRAD_STAGES = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3)
XENT_CLASSES = (10, 100)
#: batches of the xent batch-mean checks (C = 10; the last above the
#: one-CTA route's rows); timed at TRAIN_B.
XENT_MEAN_B = (1, 7, TRAIN_B, 1000, 4096)
TRAIN_STEPS = 30
#: phase 7: updates of the two-rank parity runs, their ranks, and the
#: schedule of the preset's first steps (cosine, 1 warmup step of 30).
DDP_STEPS = 5
DDP_WORLD = 2
DDP_SCHED = ("cosine", 0.1, 30, 1, 0.0)
#: phase 7a: the comm attribution's window over each pair's rank 0 (global
#: updates [2, 4): the second update holds DDP's bucket rebuild).
DDP_COMM_WINDOW = (2, 4)
#: phase 7b: the comm window over the world-1 DDP run's updates.
WORLD1_COMM_WINDOW = (10, 20)
#: the comm window across cards (`commprof_multi_card`): the preset with
#: the kernel knobs, B=128 a rank, windows of 10 as CUDA graphs, 40
#: updates; the window is the fourth graph window (DDP's 11 warm-up
#: updates run eagerly in the first two, the third is captured).
COMMPROF_MC_WINDOW = (31, 41)
COMMPROF_MC_UPDATES = 40
#: the fused bound of tests/test_models.py and PERF.md §2.
DDP_LOSS_TOL = 0.05
TRAIN_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
              "--model.fused_bwd=true", "--train.pallas_xent=true",
              "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
              f"--data.synthetic_train_size={TRAIN_STEPS * TRAIN_B}",
              f"--data.synthetic_test_size={2 * TRAIN_B}",
              "--train.epochs=1", "--train.log_every=10",
              "--data.device_resident=off"]
#: phase 8: the resume runs (B=128, 10 steps an epoch, 3 epochs; the
#: interrupted run stops before step 20, at the start of epoch 3), the
#: served requests and the reference workload's sizes.
CKPT_EPOCHS, CKPT_SPE = 3, 10
CKPT_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
             "--model.fused_bwd=true", "--train.pallas_xent=true",
             "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
             f"--data.synthetic_train_size={CKPT_SPE * TRAIN_B}",
             f"--data.synthetic_test_size={2 * TRAIN_B}",
             f"--train.epochs={CKPT_EPOCHS}", "--train.log_every=100",
             "--data.device_resident=off"]
CKPT_SERVE_REQUESTS = 50
REF_ARGS = ["--data.dataset=synthetic", "--data.synthetic_train_size=800",
            "--data.synthetic_test_size=200", "--train.epochs=2",
            "--train.log_every=50", "--data.device_resident=off"]
#: phase 10, ResNet-50 on synthetic CIFAR-100: its classes, the train
#: run's steps, the windows' updates and window, and the stage of each of
#: one forward's 13 kernel launches (every stride-1 bottleneck's 3x3).
R50_CLASSES = 100
R50_STEPS = 30
R50_WIN_UPDATES, R50_K = 40, 10
R50_FORWARD_STAGES = (0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3)
#: phase 11: the sharded update's wires (``train.collective_dtype``,
#: ``train.bucket_mb``), and the wire contract's bounds on the parameters
#: after 6 updates against f32 (tests/test_quant.py's ``WIRE_CONTRACT``).
SHARDED_WIRES = (("", 0.0), ("bf16", 0.0), ("int8", 0.0), ("", 25.0),
                 ("bf16", 25.0), ("int8", 25.0))
WIRE_TOL = {"bf16": 4e-3, "int8": 6e-3}
#: phase 12: the resident feed's run (the preset, augmentation on, a
#: synthetic train set of CIFAR-10's 50,000 images) and its window.
RES_K = 24
#: the eager pair's updates (the windowed pair runs the whole epoch of 390;
#: the eager one its first 96, a depth cut that keeps the phase inside the
#: whole call's time budget).
RES_EAGER_UPDATES = 96
RES_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            "--data.dataset=synthetic", "--data.synthetic_train_size=50000",
            f"--data.synthetic_test_size={2 * TRAIN_B}", "--train.epochs=1",
            "--train.log_every=100"]
#: phase 13: bf16_cosine_gb4096's per-card batch, its runs' updates and
#: window; resnet18_8chip_gb1024's updates.
P16_B, P16_UPDATES, P16_K = 512, 30, 10
P1024_UPDATES = 10
#: phase 14: the resilience path (the preset with the kernel knobs, the
#: default resident feed, augmentation on): windows of 10, 30 updates an
#: epoch, 2 epochs; the snapshot cadence of its preempted runs.
RESIL_K, RESIL_SPE, RESIL_EPOCHS, RESIL_EVERY = 10, 30, 2, 10
RESIL_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
              "--model.fused_bwd=true", "--train.pallas_xent=true",
              "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
              f"--data.synthetic_train_size={RESIL_SPE * TRAIN_B}",
              f"--data.synthetic_test_size={2 * TRAIN_B}",
              f"--train.epochs={RESIL_EPOCHS}", "--train.log_every=100",
              f"--train.steps_per_call={RESIL_K}"]
#: phase 15: the guarded main path (the preset with the kernel knobs, the
#: default resident feed, augmentation on): windows of 10, one epoch of 30
#: updates; the device seam's faults and the SDC ranks' Net run.
GUARD_K, GUARD_UPDATES = 10, 30
GUARD_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
              "--model.fused_bwd=true", "--train.pallas_xent=true",
              "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
              f"--data.synthetic_train_size={GUARD_UPDATES * TRAIN_B}",
              f"--data.synthetic_test_size={2 * TRAIN_B}",
              "--train.epochs=1", "--train.log_every=100",
              f"--train.steps_per_call={GUARD_K}"]
GUARD_NAN_STEP = 13
GUARD_SPIKE = ["--guard.action=rollback",
               "--resilience.snapshot_every_steps=10",
               "--resilience.fault=spike:step=15,scale=1e6",
               "--guard.spike_min_steps=4", "--guard.spike_window=16",
               "--guard.spike_z=12"]
#: phase 16: the telemetry on the main path (the preset with the kernel
#: knobs, the default resident feed, augmentation on, the guard off):
#: windows of 10, one epoch of 30 updates, at train.obs off, basic and
#: full; the profiler's step range (two windows, snapped outward).
OBS_K, OBS_UPDATES = 10, 30
OBS_MODES = ("off", "basic", "full")
OBS_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
            f"--data.synthetic_train_size={OBS_UPDATES * TRAIN_B}",
            f"--data.synthetic_test_size={2 * TRAIN_B}",
            "--train.epochs=1", "--train.log_every=100",
            f"--train.steps_per_call={OBS_K}"]
OBS_PROFILE = (10, 20)
#: phase 17: the graceful elastic shrink on the main path (the preset
#: with the kernel knobs, the default resident feed, augmentation on, f32,
#: B=128 a rank). (a) three gloo ranks on cuda:0, one update a call (the
#: windows run eager under gloo anyway), 8 updates an epoch at world 3:
#: rank 2 leaves after update 2, so the stop step falls inside epoch 1 and
#: the re-split tail (1,281 samples) does not divide over two ranks; (b)
#: NCCL, one rank a card, world 2 -> 1 by rank 1, windows of 10 (CUDA
#: graphs), the interrupted epoch alone (80 updates at world 2, so the
#: survivor runs the 3+ windows at world 1 that DDP's eager warm-up needs
#: before it captures).
ELASTIC_WORLD, ELASTIC_TRAIN, ELASTIC_K = 3, 3200, 2
ELASTIC_NCCL_TRAIN, ELASTIC_NCCL_WIN, ELASTIC_NCCL_K = 20480, 10, 10
#: the oracle's losses bind every update through this many after the
#: regroup (all of (a)'s); later updates only record their largest
#: difference: over a long run the one-process oracle drifts from the
#: ranks by rounding alone (the chaos of the fast-falling loss), while a
#: wrong batch schedule shows at once after the regroup, and the exact
#: coverage check is the schedule's proof.
ELASTIC_ORACLE_AFTER = 20
ELASTIC_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
                "--model.fused_bwd=true", "--train.pallas_xent=true",
                "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
                f"--data.synthetic_test_size={2 * TRAIN_B}",
                "--train.epochs=2", "--train.log_every=100",
                "--resilience.elastic=true",
                "--resilience.elastic_verify_fingerprint=false",
                "--resilience.elastic_coordinator_host=127.0.0.1",
                "--resilience.regroup_timeout_s=120",
                "--resilience.handle_signals=false"]
#: phase 17's rollback runs: (c) (a)'s three gloo ranks, rank 2 killed
#: (``os._exit(137)``) at its step-5 boundary, snapshots every 2 updates
#: (the newest complete one is step 4's), a 15 s collection window; (e)
#: (b)'s NCCL pair, rank 1 killed at the step-30 boundary (the third
#: window of 10), the survivor's window fence at a third of the window.
ELASTIC_KILL_K, ELASTIC_SNAP_EVERY, ELASTIC_WINDOW_S = 5, 2, 15
ELASTIC_NCCL_KILL_K = 30
#: every rank process of phase 17 ends within this, or the phase kills
#: the ranks it started and fails naming the one it waited for.
ELASTIC_RANK_DEADLINE_S = 480
#: (d): phase 15 (e)'s three gloo ranks of the reference Net on the card,
#: elastic, one update a call, 144 images (12 updates an epoch at world 3:
#: the audit at step 4 finds the flip, and the eviction's stop step, 7 to
#: 9 as the check-ins land, falls inside epoch 1), two epochs.
#: phase 17's grow runs: (f) (a)'s three gloo ranks, ``relaunch:`` on
#: rank 2 after update 2 (early in epoch 0), snapshots every 2 updates:
#: rank 2 departs, rejoins in its process through `run_elastic`, and the
#: world grows back to 3; (g) two gloo ranks of the reference Net on the
#: card, one update a call, a forged join request of sid 2 that no process
#: answers, a 15 s gate (``regroup_timeout_s``), every rank held 3 s at its
#: step-2 boundary so the request lands while they train; (h) (b)'s NCCL
#: pair, ``relaunch:`` on rank 1 at update 10, two epochs (the grown world
#: warms up and captures its windows again in the second).
ELASTIC_GROW_K = 2
ELASTIC_GROW_ABORT_ARGS = ["--data.dataset=synthetic",
                           "--data.synthetic_train_size=144",
                           "--data.synthetic_test_size=8",
                           "--data.batch_size=4", "--train.epochs=2",
                           "--train.log_every=100",
                           "--train.steps_per_call=1",
                           "--train.pallas_xent=true",
                           "--resilience.snapshot_every_steps=2",
                           "--resilience.snapshot_keep=0",
                           "--resilience.elastic=true",
                           "--resilience.elastic_verify_fingerprint=false",
                           "--resilience.elastic_coordinator_host=127.0.0.1",
                           f"--resilience.regroup_timeout_s="
                           f"{ELASTIC_WINDOW_S}",
                           "--resilience.handle_signals=false",
                           "--resilience.fault=delay:step=2,ms=3000"]
ELASTIC_SDC_ARGS = ["--data.dataset=synthetic",
                    "--data.synthetic_train_size=144",
                    "--data.synthetic_test_size=8", "--data.batch_size=4",
                    "--train.epochs=2", "--train.log_every=100",
                    "--train.steps_per_call=1", "--train.pallas_xent=true",
                    "--guard.enabled=true", "--guard.action=skip",
                    "--guard.sdc_every_steps=2", "--guard.spike_min_steps=64",
                    "--resilience.snapshot_every_steps=1",
                    "--resilience.elastic=true",
                    "--resilience.elastic_verify_fingerprint=false",
                    "--resilience.elastic_coordinator_host=127.0.0.1",
                    f"--resilience.regroup_timeout_s={ELASTIC_WINDOW_S}",
                    "--resilience.handle_signals=false",
                    "--resilience.fault=sdc:step=3,rank=2"]
GUARD_SDC_WORLD = 3
GUARD_SDC_ARGS = ["--data.dataset=synthetic",
                  "--data.synthetic_train_size=48",
                  "--data.synthetic_test_size=8", "--train.epochs=1",
                  "--train.log_every=100", "--train.eval_at_end=false",
                  "--resilience.handle_signals=false",
                  "--guard.enabled=true", "--guard.sdc_every_steps=2",
                  "--guard.sdc_action=halt",
                  "--resilience.snapshot_every_steps=1",
                  "--resilience.fault=sdc:step=3,rank=2"]


def bf16_ulp(mag: float) -> float:
    """One bf16 ulp at magnitude ``mag`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(mag)) - 7) if mag > 0 else 2.0 ** -133


def cuda_median_ms(fn, reps: int = 30, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_loop_ms(fn, n: int = 20, reps: int = 7, warm: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``n`` back-to-back
    calls, per call: for kernels short enough that one call per event
    pair would time the host."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def device_ms(fn, n: int = 20, sessions: int = 2) -> float:
    """Device time per call of ``fn``: the time of every device kernel its
    ``n`` calls launch, from the profiler, over ``n``. For microsecond
    kernels, where a CUDA-event loop times the host's launch rate. The
    profiler (CUDA activity alone) now and then loses device records and
    never adds any (`tools/port_profiler_loss.py`), so this is the largest
    reading of ``sessions`` sessions; while every session read nothing,
    up to two more run, and then it fails."""
    best = 0.0
    for i in range(sessions + 2):
        us = profile_forward(fn, n, cuda_only=True)["device_busy_us_per_call"]
        best = max(best, us)
        if best > 0 and i + 1 >= sessions:
            return best / 1e3
    raise RuntimeError("the profiler recorded no device time")


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """``(bound_ms, bound_by)``: the larger of bytes over HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def with_ratios(rec: dict) -> dict:
    """Adds ``bound_share`` (bound_ms / ms: the share of the card's least
    time the kernel reaches) and ``vs_library`` (ms / library_ms: above 1
    the kernel is slower than the one PyTorch call) where both exist."""
    if rec.get("ms") and rec.get("bound_ms") is not None:
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    if rec.get("ms") and rec.get("library_ms"):
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
    return rec


def phase_header(out):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from tpu_dp_torch.parallel.dist import describe

    out["card"] = smi
    out["describe"] = describe()
    print(f"[header] {json.dumps(out['describe'])}")
    print(f"[header] nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_build(out):
    from tpu_dp_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    out["build_s"] = round(time.perf_counter() - t0, 3)
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']} s "
              f"(cached={rec['cached']})")
    out["conv_instances"] = conv_instances(info["conv_block"]["log"])
    for inst in out["conv_instances"]:
        print("[build] " + json.dumps(inst))
    out["xent_ptxas"] = ptxas_lines(info["xent"]["log"], "xent_")
    for name, lines in out["xent_ptxas"].items():
        print(f"[build] {name}: {' | '.join(lines)}")
    out["augment_ptxas"] = ptxas_lines(info["augment"]["log"],
                                       "crop_flip_draws")
    for name, lines in out["augment_ptxas"].items():
        print(f"[build] {name}: {' | '.join(lines)}")
    spills = [i for i in out["conv_instances"] if i["spill_bytes"]]
    print(f"[build] total {out['build_s']} s; "
          f"{len(out['conv_instances'])} conv instances, "
          f"{len(spills)} with spills")


def ptxas_lines(log: str, key: str) -> dict:
    """ptxas's report lines (registers, stack frame, spills) of each entry
    function whose name holds ``key``."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if key in m.group(1) else None
            if cur:
                out[cur] = []
        elif cur and ("registers" in line or "stack frame" in line):
            out[cur].append(line.split("ptxas info    :")[-1].strip())
    return out


def conv_instances(log: str) -> list:
    """Registers, spills and static shared memory of each conv kernel
    instance, from the ptxas report (``-Xptxas -v``)."""
    import re

    insts, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = None
            if "conv_block_kernel" in m.group(1):
                t = re.search(r"conv_block_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                              m.group(1))
                cur = {"instance": m.group(1),
                       "dtype": "float32" if t and t.group(1) == "f"
                       else "bfloat16",
                       "bm": int(t.group(2)) if t else None,
                       "bn": int(t.group(3)) if t else None,
                       "spill_bytes": 0}
                insts.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return insts


def _case_inputs(gen, b, h, c, dtype, with_res):
    import torch

    dev = "cuda"
    x = torch.randn(b, h, h, c, generator=gen, device=dev).to(dtype)
    w = torch.randn(3, 3, c, c, generator=gen, device=dev) * math.sqrt(
        2.0 / (9 * c))
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    shift = 0.1 * torch.randn(c, generator=gen, device=dev)
    res = (torch.randn(b, h, h, c, generator=gen, device=dev).to(dtype)
           if with_res else None)
    return x, w, scale, shift, res


def _compare(cb, b, stage, dtype, variant, gen):
    """One kernel-vs-plain case through the public wrappers; returns the
    record and the inputs (the packed weight, as the model passes it)."""
    import torch

    h, c = STAGES[stage]
    emit = variant != "plain"
    x, w, scale, shift, res = _case_inputs(
        gen, b, h, c, dtype, variant == "emit_z+res")
    wk = cb.pack_weight(w)
    wrapper = (cb.fused_affine_relu_conv_emit if emit
               else cb.fused_affine_relu_conv)
    got = wrapper(x, wk, scale, shift, res)
    ref = cb.reference_affine_relu_conv(x, w, scale, shift, res, True, emit)
    torch.cuda.synchronize()
    gy, ry = (got[0], ref[0]) if emit else (got, ref)
    ry32, gy32 = ry.float(), gy.float()
    tol = bf16_ulp(ry32.abs().max().item())
    err = (gy32 - ry32).abs().max().item()
    rec = {
        "stage": stage, "shape": [b, h, h, c],
        "dtype": str(dtype).replace("torch.", ""),
        "variant": variant,
        "max_abs_err": err, "tol": tol,
        "bit_equal_share": (gy32 == ry32).float().mean().item(),
        "finite": bool(torch.isfinite(gy32).all()),
    }
    if emit:
        zerr = (got[1].float() - ref[1].float()).abs().max()
        rec["z_max_abs_err"] = zerr.item()
        rec["z_tol"] = bf16_ulp(ref[1].float().abs().max().item())
    rec["ok"] = (rec["finite"] and err <= tol
                 and rec.get("z_max_abs_err", 0.0) <= rec.get("z_tol", 1.0))
    return rec, (wrapper, x, w, wk, scale, shift, res, ref)


def phase_kernels(out):
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for stage, (h, c) in enumerate(STAGES):
            for variant in VARIANTS:
                emit = variant != "plain"
                rec, (wrapper, x, w, wk, scale, shift, res, ref) = _compare(
                    cb, B, stage, dtype, variant, gen)
                ok &= rec["ok"]
                z = ref[1] if emit else cb._reference_z(
                    x, scale, shift, res).to(dtype)
                zl = z.to(torch.bfloat16).permute(0, 3, 1, 2)
                wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                # Kernel time: back-to-back launches through the C entry,
                # as in phase 4. `wrapper_ms` is one public-wrapper call
                # per event pair, which also counts the wrapper's host
                # time whenever that exceeds the kernel's.
                launch, _ = _direct_conv(cb, x, wk, scale, shift, res, emit,
                                         False)
                rec["ms"] = cuda_loop_ms(launch)
                rec["wrapper_ms"] = cuda_median_ms(
                    lambda: wrapper(x, wk, scale, shift, res))
                rec["plain_ms"] = cuda_median_ms(
                    lambda: cb.reference_affine_relu_conv(
                        x, w, scale, shift, res, True, emit))
                rec["library_ms"] = cuda_loop_ms(
                    lambda: F.conv2d(zl, wl, padding=1))
                esize = x.element_size()
                n = B * h * h * c
                nbytes = (n * esize * (2 + emit + (res is not None))
                          + wk.numel() * 2 + 2 * c * 4)
                flops = 2.0 * B * h * h * 9 * c * c
                t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
                rec["bytes"], rec["flops"] = nbytes, flops
                rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                rec["tile"] = cb.tile_of(B, h, h, c)
                print("[kernel] " + json.dumps(with_ratios(rec)))
                cases.append(rec)
    # The serve ladder's smaller buckets: the same checks, untimed. At
    # stage 3 a 64-pixel tile holds four 4x4 images, so B=1 and B=2 leave
    # image slots of the last tile empty.
    small = []
    for b in SMALL_BUCKETS:
        for dtype in (torch.float32, torch.bfloat16):
            for stage in range(len(STAGES)):
                for variant in VARIANTS:
                    rec, _ = _compare(cb, b, stage, dtype, variant, gen)
                    ok &= rec["ok"]
                    if not rec["ok"]:
                        print("[kernel] FAILED " + json.dumps(rec))
                    small.append(rec)
        worst = max((r for r in small if r["shape"][0] == b),
                    key=lambda r: r["max_abs_err"] / r["tol"])
        print(f"[kernel] B={b}: {2 * len(STAGES) * len(VARIANTS)} "
              f"cases, worst max_abs_err {worst['max_abs_err']} "
              f"(tol {worst['tol']}, {worst['dtype']} stage "
              f"{worst['stage']} {worst['variant']})")
    out["kernel_cases"] = cases
    out["kernel_small_bucket_cases"] = small
    if not ok:
        raise AssertionError("conv kernel disagrees with its plain version")
    print(f"[kernel] all {len(cases)} B={B} cases and {len(small)} "
          f"small-bucket cases within one bf16 ulp")


def _direct_conv(cb, x, wk, scale, shift, res, emit_z, stats, act=True):
    """One launch of the conv kernel alone through its C entry, on buffers
    allocated once (no wrapper): for timing and, with ``stats``, to read
    the partial rows the launch leaves in its scratch. Returns ``(launch,
    scratch)``: scratch is None, or ``{"partials": the launch's [nbx, 2,
    C] block rows, "stats": [2, C]}``."""
    import torch

    from tpu_dp_torch.ops import _tickets

    b, h, w, c = x.shape
    y = torch.empty_like(x)
    z = torch.empty_like(x) if emit_z else None
    rows, n_tick = cb.stats_scratch(b, h, w, c)
    part = st = tick = scratch = None
    if stats:
        tile = cb.tile_of(b, h, w, c)
        part = torch.empty((rows, 2, c), device=x.device)
        st = torch.empty((2, c), device=x.device)
        tick = _tickets.tickets(x.device, n_tick)
        scratch = {"partials": part[:tile["blocks"] // (c // tile["bn"])],
                   "stats": st}
    conv = cb._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = (cb._DTYPES[x.dtype], res is not None, emit_z, act, stats,
            x.data_ptr(), wk.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            ptr(res), y.data_ptr(), ptr(z), ptr(part), ptr(st), ptr(tick),
            b, h, w, c, rows, n_tick, cb.STATS_GROUP, stream)

    def launch():
        if conv(*args) != 0:
            raise RuntimeError("conv_block launch failed")
    return launch, scratch


def _fold_checks(cb, x, wk, scale, shift, res, emit, st, big, side):
    """The stats fold of one ``emit_stats`` case whose wrapper call gave
    ``st``: bit-exact against `ordered_stats_sum` over the rows a launch
    through the C entry left in its scratch, and bit-identical over three
    replays of a CUDA graph of one wrapper call (captured on the stream
    ``side``) and on a wrapper call made while ``big @ big`` runs on
    ``side``. One side stream serves every case: cuBLAS keeps a workspace
    per stream for the life of the process."""
    import torch

    launch, scr = _direct_conv(cb, x, wk, scale, shift, res, emit, True)
    launch()
    torch.cuda.synchronize()
    rec = {"stats_eq_ordered_sum": bool(torch.equal(
               scr["stats"], cb.ordered_stats_sum(scr["partials"]))),
           "c_entry_eq_wrapper": bool(torch.equal(scr["stats"], st)),
           "partial_rows": scr["partials"].shape[0]}
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the stream's tickets, outside capture
        cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
    same = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        same.append(bool(torch.equal(out[-1], st)))
    rec["graph_replays_identical"] = all(same)
    del graph, out
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        busy = big @ big
    got = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)[-1]
    torch.cuda.synchronize()
    rec["side_stream_identical"] = bool(torch.equal(got, st))
    del busy
    rec["fold_ok"] = all(rec[k] for k in (
        "stats_eq_ordered_sum", "c_entry_eq_wrapper",
        "graph_replays_identical", "side_stream_identical"))
    return rec


def _grad_check(cb, x, w, scale, shift, res, gen):
    """The autograd rule's five gradients (fused_conv_bn, emit_z, residual,
    pallas_bwd) against autograd through the plain version."""
    import torch

    b, h, _, c = x.shape
    probes = [torch.randn(x.shape, generator=gen, device="cuda"),
              torch.randn(x.shape, generator=gen, device="cuda"),
              torch.randn(2, c, generator=gen, device="cuda") / (b * h * h)]
    grads = []
    for fn in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, w, scale, shift, res)]
        if fn == "kernel":
            out = cb.fused_conv_bn(*leaves, pallas_bwd=True, emit_z=True)
        else:
            out = cb.reference_affine_relu_conv(*leaves, emit_z=True,
                                                emit_stats=True)
        sum((o * p).sum() for o, p in zip(out, probes)).backward()
        grads.append([t.grad for t in leaves])
    errs = {}
    for name, g, r in zip(("x", "w", "scale", "shift", "res"), *grads):
        errs[name] = ((g - r).abs().max() / r.abs().max()).item()
    return errs


def _ragged_cases(cb, gen, big, side):
    """Untimed emit_stats (emit_z + residual, f32) and input-grad (bf16)
    cases at the ragged batches, every stage: the tile's partly filled
    edges. y within one ulp, z equal, stats bit-identical over two
    launches, the fold's checks (`_fold_checks`) and within 1e-5 * sum|y|
    of the plain sums of the kernel's own y; input-grad within one ulp."""
    import torch

    recs = []
    for b in RAGGED_B:
        for stage, (h, c) in enumerate(STAGES):
            x, w, scale, shift, res = _case_inputs(gen, b, h, c,
                                                   torch.float32, True)
            got = cb.fused_conv_bn(x, w, scale, shift, res, emit_z=True)
            again = cb.fused_conv_bn(x, w, scale, shift, res, emit_z=True)
            ref = cb.reference_affine_relu_conv(x, w, scale, shift, res,
                                                emit_z=True, emit_stats=True)
            ct = torch.randn(b, h, h, c, generator=gen,
                             device="cuda").to(torch.bfloat16)
            wf = cb.flip_packed(w)
            one = torch.ones(c, device="cuda")
            zero = torch.zeros(c, device="cuda")
            dz = cb._run(ct, wf, one, zero, None, False, False,
                         role="input_grad")
            dzr = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                                activate=False)
            torch.cuda.synchronize()
            y, st = got[0], got[-1]
            yabs = torch.stack([y.abs().sum((0, 1, 2)),
                                (y * y).sum((0, 1, 2))])
            rec = {"kind": "ragged", "stage": stage, "shape": [b, h, h, c],
                   "tile": cb.tile_of(b, h, h, c),
                   "max_abs_err": (y - ref[0]).abs().max().item(),
                   "tol": bf16_ulp(ref[0].abs().max().item()),
                   "z_equal": bool(torch.equal(got[1], ref[1])),
                   "stats_rel_err": ((st - cb._stats_of(y)).abs()
                                     / yabs.clamp(min=1e-30)).max().item(),
                   "stats_bit_identical": bool(torch.equal(st, again[-1])),
                   "input_grad_max_abs_err":
                       (dz.float() - dzr.float()).abs().max().item(),
                   "input_grad_tol": bf16_ulp(dzr.float().abs().max().item())}
            rec.update(_fold_checks(cb, x, cb.pack_weight(w), scale, shift,
                                    res, True, st, big, side))
            rec["ok"] = (rec["max_abs_err"] <= rec["tol"] and rec["z_equal"]
                         and rec["stats_rel_err"] <= 1e-5
                         and rec["stats_bit_identical"] and rec["fold_ok"]
                         and rec["input_grad_max_abs_err"]
                         <= rec["input_grad_tol"])
            print("[ragged] " + json.dumps(rec))
            recs.append(rec)
    return recs


def _host_us(fn, n: int = 50) -> float:
    """Median host microseconds of one call of ``fn`` (no synchronise: the
    time the caller's thread spends to enqueue it)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_train_kernels(out):
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(1)
    # Side-stream load for the fold's concurrency check: ~1 ms of bf16
    # tensor-core work on every SM.
    big = torch.randn(8192, 8192, generator=gen, device="cuda").to(
        torch.bfloat16)
    side = torch.cuda.Stream()
    cases, ok = [], True
    for stage, (h, c) in enumerate(STAGES):
        n = TRAIN_B * h * h * c
        flops = 2.0 * TRAIN_B * h * h * 9 * c * c
        for variant in TRAIN_VARIANTS:
            emit, with_res = "emit_z" in variant, "res" in variant
            x, w, scale, shift, res = _case_inputs(
                gen, TRAIN_B, h, c, torch.float32, with_res)
            wk = cb.pack_weight(w)
            got = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
            again = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
            ref = cb.reference_affine_relu_conv(x, w, scale, shift, res,
                                                emit_z=emit, emit_stats=True)
            torch.cuda.synchronize()
            y, st = got[0], got[-1]
            tol = bf16_ulp(ref[0].abs().max().item())
            own = cb._stats_of(y)
            yabs = torch.stack([y.abs().sum((0, 1, 2)),
                                (y * y).sum((0, 1, 2))])
            rec = {
                "kind": "emit_stats", "stage": stage,
                "shape": [TRAIN_B, h, h, c], "variant": variant,
                "max_abs_err": (y - ref[0]).abs().max().item(), "tol": tol,
                "stats_rel_err": ((st - own).abs() / yabs).max().item(),
                "stats_bit_identical": bool(torch.equal(st, again[-1])),
                "y_bit_identical": bool(torch.equal(y, again[0])),
                "tile": cb.tile_of(TRAIN_B, h, h, c),
            }
            if emit:
                rec["z_equal"] = bool(torch.equal(got[1], ref[1]))
            rec.update(_fold_checks(cb, x, wk, scale, shift, res, emit, st,
                                    big, side))
            rec["ok"] = (rec["max_abs_err"] <= tol
                         and rec["stats_rel_err"] <= 1e-5
                         and rec["stats_bit_identical"]
                         and rec["y_bit_identical"]
                         and rec.get("z_equal", True) and rec["fold_ok"])
            launch, scratch = _direct_conv(cb, x, wk, scale, shift, res,
                                           emit, True)
            off, _ = _direct_conv(cb, x, wk, scale, shift, res, emit, False)
            zl = ref[1] if emit else cb._reference_z(x, scale, shift, res)
            zl = zl.to(torch.bfloat16).permute(0, 3, 1, 2)
            wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            # The fold's cost: the same launch with stats on and off, in
            # turns (on, off, on, off), the faster of each pair.
            on1, off1 = cuda_loop_ms(launch), cuda_loop_ms(off)
            on2, off2 = cuda_loop_ms(launch), cuda_loop_ms(off)
            rec["ms"], rec["nostats_ms"] = min(on1, on2), min(off1, off2)
            rec["fold_ms"] = rec["ms"] - rec["nostats_ms"]
            rec["plain_ms"] = cuda_median_ms(
                lambda: cb.reference_affine_relu_conv(
                    x, w, scale, shift, res, emit_z=emit, emit_stats=True),
                reps=10)
            rec["library_ms"] = cuda_loop_ms(
                lambda: F.conv2d(zl, wl, padding=1))
            nbytes = (n * 4 * (2 + emit + with_res) + wk.numel() * 2
                      + 2 * c * 4 + 2 * c * 4)
            rec["bytes"], rec["flops"] = nbytes, flops
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
            ok &= rec["ok"]
            print("[train-kernel] " + json.dumps(with_ratios(rec)))
            cases.append(rec)
        # The stats fold of this stage (its cost per variant is in the
        # emit_stats records): the sum it replaces, on the last case's
        # partial rows, timed as the plain version and the library call.
        partials = scratch["partials"]
        launch()
        torch.cuda.synchronize()
        nb = partials.shape[0]
        plain_sum = partials.sum(0)
        rbytes = partials.numel() * 4 + 2 * c * 4
        rec = {"kind": "stats_fold", "stage": stage, "partials": [nb, 2, c],
               "groups": -(-nb // cb.STATS_GROUP),
               "max_abs_err": (scratch["stats"] - cb.ordered_stats_sum(
                   partials)).abs().max().item(),
               "vs_sum_max_rel_err": ((scratch["stats"] - plain_sum).abs()
                                      / partials.abs().sum(0).clamp(
                                          min=1e-30)).max().item(),
               "fold_ms_by_variant": {r["variant"]: r["fold_ms"]
                                      for r in cases
                                      if r["kind"] == "emit_stats"
                                      and r["stage"] == stage},
               "plain_ms": device_ms(lambda: partials.sum(dim=0)),
               "library_ms": device_ms(lambda: torch.sum(partials, 0)),
               "bytes": rbytes, "flops": partials.numel()}
        rec["ok"] = (rec["max_abs_err"] == 0.0
                     and rec["vs_sum_max_rel_err"] <= 1e-6)
        rec["bound_ms"], rec["bound_by"] = bound(
            rbytes, partials.numel(), PEAK_F32_FLOPS)
        ok &= rec["ok"]
        print("[train-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
        # The input-grad reuse: bf16 ct, flipped weight, no activation.
        ct = torch.randn(TRAIN_B, h, h, c, generator=gen,
                         device="cuda").to(torch.bfloat16)
        w = torch.randn(3, 3, c, c, generator=gen, device="cuda") * 0.05
        wf = cb.flip_packed(w)
        one = torch.ones(c, device="cuda")
        zero = torch.zeros(c, device="cuda")
        dz = cb._run(ct, wf, one, zero, None, False, False,
                     role="input_grad")
        ref = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                            activate=False)
        torch.cuda.synchronize()
        tol = bf16_ulp(ref.float().abs().max().item())
        err = (dz.float() - ref.float()).abs().max().item()
        launch, _ = _direct_conv(cb, ct, wf, one, zero, None, False, False,
                                 act=False)
        ctl = ct.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        nbytes = n * 2 * 2 + wf.numel() * 2
        rec = {"kind": "input_grad", "stage": stage,
               "shape": [TRAIN_B, h, h, c], "max_abs_err": err, "tol": tol,
               "tile": cb.tile_of(TRAIN_B, h, h, c),
               "ok": err <= tol, "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       ct, wf, one, zero, activate=False), reps=10),
               "library_ms": cuda_loop_ms(
                   lambda: torch.nn.grad.conv2d_input(
                       ctl.shape, wl, ctl, padding=1)),
               "bytes": nbytes, "flops": flops}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        ok &= rec["ok"]
        print("[train-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
        # The autograd rule against the plain version's autograd.
        x, w, scale, shift, res = _case_inputs(
            gen, TRAIN_B, h, c, torch.float32, True)
        errs = _grad_check(cb, x, w, scale, shift, res, gen)
        rec = {"kind": "grads", "stage": stage, "shape": [TRAIN_B, h, h, c],
               "normalized_err": errs, "tol": 2e-2,
               "ok": max(errs.values()) <= 2e-2}
        ok &= rec["ok"]
        print("[train-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
    ragged = _ragged_cases(cb, gen, big, side)
    del big, side
    ok &= all(r["ok"] for r in ragged)
    out["ragged_cases"] = ragged
    print(f"[ragged] {len(ragged)} cases at B={list(RAGGED_B)}: "
          f"{'all ok' if all(r['ok'] for r in ragged) else 'FAILED'}")
    # Host cost of one call: the public wrapper (checks, allocation, the
    # one launch) and the C entry alone, stage 3.
    h, c = STAGES[3]
    x, w, scale, shift, res = _case_inputs(gen, TRAIN_B, h, c,
                                           torch.float32, False)
    wk = cb.pack_weight(w)
    launch, _ = _direct_conv(cb, x, wk, scale, shift, res, False, True)
    out["host_us"] = {
        "fused_conv_bn_wrapper": _host_us(
            lambda: cb.fused_conv_bn(x, wk, scale, shift)),
        "conv_c_entry": _host_us(launch),
        "shape": [TRAIN_B, h, h, c]}
    print("[host] " + json.dumps(out["host_us"]))
    for c in XENT_CLASSES:
        logits = 3.0 * torch.randn(TRAIN_B, c, generator=gen, device="cuda")
        labels = torch.randint(0, c, (TRAIN_B,), generator=gen,
                               device="cuda")
        ct = torch.rand(TRAIN_B, generator=gen, device="cuda") + 0.5
        loss, d = tx._fwd(logits, labels), tx._bwd(logits, labels, ct)
        rl, rd = tx._plain_fwd(logits, labels), tx._plain_bwd(logits, labels,
                                                             ct)
        torch.cuda.synchronize()
        lref = logits.clone().requires_grad_()
        nbytes = TRAIN_B * c * 4 + TRAIN_B * 8
        for kind, got, ref, kern, plain, lib, nb in (
                ("xent_fwd", loss, rl, lambda: tx._fwd(logits, labels),
                 lambda: tx._plain_fwd(logits, labels),
                 lambda: F.cross_entropy(logits, labels, reduction="none"),
                 nbytes + TRAIN_B * 4),
                ("xent_bwd", d, rd, lambda: tx._bwd(logits, labels, ct),
                 lambda: tx._plain_bwd(logits, labels, ct),
                 lambda: torch.autograd.grad(
                     F.cross_entropy(lref, labels, reduction="none"), lref,
                     ct), nbytes + TRAIN_B * 4 + TRAIN_B * c * 4)):
            err = ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max()
            rec = {"kind": kind, "shape": [TRAIN_B, c],
                   "max_abs_err": (got - ref).abs().max().item(),
                   "max_rel_err": err.item(),
                   "ok": bool(torch.allclose(got, ref, rtol=1e-6,
                                             atol=1e-6)),
                   "ms": device_ms(kern), "launch_loop_ms": cuda_loop_ms(kern),
                   "plain_ms": device_ms(plain), "library_ms": device_ms(lib),
                   "bytes": nb}
            # ~10 operations per element (exp, max, add, divide), f32.
            rec["bound_ms"], rec["bound_by"] = bound(
                nb, 10.0 * TRAIN_B * c, PEAK_F32_FLOPS)
            ok &= rec["ok"]
            print("[train-kernel] " + json.dumps(with_ratios(rec)))
            cases.append(rec)
    # The batch mean, the training loss: one launch each way. Timed at
    # the training batch, beside the route it replaces (per-example kernel
    # + torch mean; MeanBackward's scale + per-example backward kernel).
    for b in XENT_MEAN_B:
        c = XENT_CLASSES[0]
        logits = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
        labels = torch.randint(0, c, (b,), generator=gen, device="cuda")
        ct = torch.tensor(1.7, device="cuda")
        loss, again = tx._fwd(logits, labels, True), tx._fwd(logits, labels,
                                                             True)
        d = tx._bwd(logits, labels, ct, mean=True)
        rl = tx._plain_fwd(logits, labels).mean()
        rd = tx._plain_bwd(logits, labels, (ct / b).expand(b))
        old = logits.clone().requires_grad_()
        tx.softmax_xent(old, labels).mean().backward(ct)
        torch.cuda.synchronize()
        lref = logits.clone().requires_grad_()
        nbytes = b * c * 4 + b * 8 + 4
        fwd = {"kind": "xent_mean_fwd", "shape": [b, c],
               "max_abs_err": (loss - rl).abs().item(),
               "max_rel_err": ((loss - rl).abs() / rl.abs()).item(),
               "bit_identical_across_launches": bool(torch.equal(loss,
                                                                 again)),
               "bytes": nbytes}
        fwd["ok"] = (fwd["max_rel_err"] <= 1e-6
                     and fwd["bit_identical_across_launches"])
        bwd = {"kind": "xent_mean_bwd", "shape": [b, c],
               "max_abs_err": (d - rd).abs().max().item(),
               "max_rel_err": ((d - rd).abs().max()
                               / rd.abs().max()).item(),
               "bit_identical_to_mean_backward_route": bool(
                   torch.equal(d, old.grad)),
               "bytes": nbytes + b * c * 4}
        bwd["ok"] = (bwd["max_rel_err"] <= 1e-6
                     and bwd["bit_identical_to_mean_backward_route"])
        for rec in (fwd, bwd):
            # ~10 operations per element (exp, max, add, divide), f32.
            rec["bound_ms"], rec["bound_by"] = bound(
                rec["bytes"], 10.0 * b * c, PEAK_F32_FLOPS)
        if b == TRAIN_B:
            fwd.update({
                "ms": device_ms(lambda: tx._fwd(logits, labels, True)),
                "launch_loop_ms": cuda_loop_ms(
                    lambda: tx._fwd(logits, labels, True)),
                "old_route_ms": device_ms(
                    lambda: tx._fwd(logits, labels).mean()),
                "plain_ms": device_ms(
                    lambda: tx._plain_fwd(logits, labels).mean()),
                "library_ms": device_ms(
                    lambda: F.cross_entropy(logits, labels))})
            bwd.update({
                "ms": device_ms(lambda: tx._bwd(logits, labels, ct, True)),
                "launch_loop_ms": cuda_loop_ms(
                    lambda: tx._bwd(logits, labels, ct, True)),
                "old_route_ms": device_ms(
                    lambda: tx._bwd(logits, labels, ct.expand(b) / b)),
                "plain_ms": device_ms(lambda: tx._plain_bwd(
                    logits, labels, (ct / b).expand(b))),
                "library_ms": device_ms(lambda: torch.autograd.grad(
                    F.cross_entropy(lref, labels), lref, ct))})
        for rec in (fwd, bwd):
            ok &= rec["ok"]
            print("[train-kernel] " + json.dumps(with_ratios(rec)))
            cases.append(rec)
    # Labels outside [0, C), untimed: both kernels give the JAX kernels'
    # values (loss = the row's logsumexp, gradient = softmax * ct), as the
    # plain versions do.
    logits = 3.0 * torch.randn(4, 10, generator=gen, device="cuda")
    labels = torch.tensor([0, 10, -1, 9], device="cuda")
    ct = torch.rand(4, generator=gen, device="cuda") + 0.5
    loss, d = tx._fwd(logits, labels), tx._bwd(logits, labels, ct)
    rl, rd = tx._plain_fwd(logits, labels), tx._plain_bwd(logits, labels, ct)
    lse = torch.logsumexp(logits, dim=-1)
    soft = torch.softmax(logits, dim=-1) * ct[:, None]
    torch.cuda.synchronize()
    rec = {"kind": "xent_out_of_range_labels", "labels": [0, 10, -1, 9],
           "loss_max_abs_err": (loss - rl).abs().max().item(),
           "grad_max_abs_err": (d - rd).abs().max().item(),
           "loss_vs_logsumexp": (loss[1:3] - lse[1:3]).abs().max().item(),
           "grad_vs_softmax_ct": (d[1:3] - soft[1:3]).abs().max().item(),
           "finite": bool(torch.isfinite(loss).all()
                          and torch.isfinite(d).all())}
    rec["ok"] = (rec["finite"] and rec["loss_max_abs_err"] <= 1e-5
                 and rec["grad_max_abs_err"] <= 1e-6
                 and rec["loss_vs_logsumexp"] <= 1e-5
                 and rec["grad_vs_softmax_ct"] <= 1e-6)
    ok &= rec["ok"]
    print("[train-kernel] " + json.dumps(with_ratios(rec)))
    out["xent_out_of_range"] = rec
    out["train_kernel_cases"] = cases
    if not ok:
        raise AssertionError("a train kernel disagrees with its plain "
                             "version")
    print(f"[train-kernel] all {len(cases)} cases within tolerance; stats "
          f"bit-exact with ordered_stats_sum and bit-identical across "
          f"launches, graph replays and a busy side stream")


#: spin kernels launched at the start of a by-name session, before the
#: calls it counts, and again at its end, after them (`profile_forward`'s
#: ``lead_in`` and ``lead_out``), each spinning `PROFILE_SPIN_CYCLES`
#: (about a quarter of a millisecond at the H100's clock): the package's
#: bracket, which the trainer's own profiler sessions open and close with
#: too (`tpu_dp_torch.utils.profiling`).
from tpu_dp_torch.utils.profiling import (  # noqa: E402
    PROFILE_LEAD_IN,
    PROFILE_SPIN_CYCLES,
)


def profile_forward(fn, n: int = 5, cuda_only: bool = False,
                    keep_all: bool = False, lead_in: int = 0,
                    lead_out: int = 0, spin_cycles: int = 100,
                    keep_order: bool = False) -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the wall time they took. ``cuda_only``
    traces the CUDA activity alone; ``keep_all`` also returns every
    kernel's record under ``all``. ``lead_in`` spin kernels run first in
    the session, waited for and left out of every figure: a session loses
    the records of the first kernels it sees, more of them the more
    sessions the process has opened (`tools/port_profiler_loss.py`);
    ``lead_out`` spin kernels run last, after the counted calls are waited
    for, left out the same way; each spin lasts ``spin_cycles`` clock
    cycles. ``keep_order`` also returns the counted kernels' names in the
    order they started, under ``order``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([] if cuda_only
                                      else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(spin_cycles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        for _ in range(lead_out):
            torch.cuda._sleep(spin_cycles)
        torch.cuda.synchronize()
    spun = lead_in or lead_out
    kernels = {}
    for ev in prof.key_averages():
        # Device-side events only: a CPU op (aten::conv2d) also carries
        # the device time of the kernels it launched.
        if (str(getattr(ev, "device_type", "")) != "DeviceType.CUDA"
                or (spun and "spin_kernel" in ev.key)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            kernels[ev.key] = {"us_per_call": dev_us / n,
                               "count_per_call": ev.count / n}
    busy_us = sum(k["us_per_call"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us_per_call"])
               [:12])
    # The port's own kernels, by name: their device time per launch, which
    # for microsecond kernels a host-side loop cannot see.
    ours = {k: v for k, v in kernels.items()
            if any(s in k for s in ("conv_block_kernel", "xent_",
                                    "crop_flip_draws"))}
    return {"wall_us_per_call": wall_us / n, "device_busy_us_per_call":
            busy_us, "device_busy_share": busy_us * n / wall_us,
            "kernel_launches_per_call": sum(
                k["count_per_call"] for k in kernels.values()),
            "top": top, "ours": ours, "kernel_names": sorted(kernels),
            **({"all": kernels} if keep_all else {}),
            **({"order": [ev.key for ev in sorted(
                (ev for ev in prof.events()
                 if str(getattr(ev, "device_type", "")) == "DeviceType.CUDA"
                 and ev.key in kernels), key=lambda ev: ev.time_range.start)]}
               if keep_order else {})}


def _randomize_bn(model, gen):
    import torch

    from tpu_dp_torch.models.resnet import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


class _Recorder:
    """Engine proxy that keeps every handle `run_load` submits."""

    def __init__(self, engine):
        self._engine, self.handles = engine, []

    def submit(self, *a, **kw):
        h = self._engine.submit(*a, **kw)
        self.handles.append(h)
        return h

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _serve_run(name: str, num_classes: int, per_forward: int,
               card: str) -> dict:
    """The fused full-width ``name`` (f32, random weights and BN statistics
    from seed 0) behind `InferenceEngine` with buckets 1..32, 200 Poisson
    requests of 1-4 images at 400/s: its record, with ``checks`` (audited
    books, the device class histogram equal to the handles' predictions,
    ``per_forward`` kernel launches per captured forward x replays
    (`_serve_graph_books`) and per replay by name, bucket-32 logits equal to
    the same weights run unfused on cuDNN within 1e-2 of their
    magnitude)."""
    import numpy as np
    import torch

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.serve import InferenceEngine, run_load
    from tpu_dp_torch.train.step import _maybe_normalize

    gen = torch.Generator().manual_seed(0)
    model = build_model(name, num_filters=64, num_classes=num_classes,
                        fused_stages=(0, 1, 2, 3), generator=gen)
    _randomize_bn(model, gen)
    plain = build_model(name, num_filters=64, num_classes=num_classes)
    plain.load_state_dict(model.state_dict())
    plain = plain.to("cuda").eval()

    engine = InferenceEngine(model, device="cuda",
                             buckets=(1, 2, 4, 8, 16, 32), slo_ms=250.0)
    cb.reset_launches()
    engine.start()  # warms and captures every bucket on the dispatch thread
    warm = engine.replica.warmup_ms
    rec = _Recorder(engine)
    try:
        report = run_load(rec, n_requests=200, pattern="poisson",
                          rate_rps=400.0, sizes=(1, 2, 3, 4), seed=0)
    finally:
        engine.stop()
    launches = cb.launches
    books = _serve_graph_books([engine.replica], per_forward, launches,
                               report["batches"])
    forwards = books["forwards_ran"]

    truth = report["ground_truth"]
    dev = report["device_stats"]
    hist = np.zeros(engine.num_classes, np.int64)
    for h in rec.handles:
        if h.ok:
            np.add.at(hist, np.asarray(h.predictions, np.int64), 1)
    checks = {
        "consistent": report["consistent"],
        "served_eq_images": dev["served"] == truth["images_served"],
        "completed_eq_submitted": truth["completed"] == truth["submitted"],
        "histogram_eq_handles": dev["class_counts"] == hist.tolist(),
        f"launches_eq_{per_forward}_per_captured_forward_x_replays":
            books["ok"],
        "no_retraces": report["retraces"] == 0,
    }
    # The served forwards by kernel name: replays of the bucket-32 graph
    # (its weights zeroed: the books count nothing), under the profiler.
    r = engine.replica
    r._dev[32]["weight"].zero_()
    prog = r._program(32)
    named_ok, named = _profiled_books(
        lambda: prog(r._stats, r._dev[32]),
        {"conv_block_kernel": per_forward})
    checks[f"replay_runs_{per_forward}_kernels_by_name"] = named_ok
    # Bucket 32's serve step, graph against eager, on the same buffers.
    step32 = r._step(32)
    graph_ms = cuda_median_ms(lambda: prog(r._stats, r._dev[32]), reps=20)
    eager_ms = cuda_median_ms(lambda: step32(r._stats, r._dev[32]), reps=20)

    # Bucket-32 parity: the fused model (kernel) vs the same weights run
    # unfused on cuDNN, on one seeded batch.
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(
        rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        x = _maybe_normalize(imgs)
        got = engine.model(x)
        ref = plain(x)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        checks["logits_shape"] = tuple(got.shape) == (32, num_classes)
        checks["logits_finite"] = bool(torch.isfinite(got).all())
        checks["logits_match_unfused"] = err <= 1e-2 * scale
        fwd_ms = cuda_median_ms(lambda: engine.model(x), reps=20)
        plain_fwd_ms = cuda_median_ms(lambda: plain(x), reps=20)
        breakdown = profile_forward(lambda: engine.model(x))

    lat = report["latency_ms"] or {}
    return {
        "model": name, "num_classes": num_classes,
        "checks": checks, "launches": launches, "forwards": forwards,
        "launches_ran": books["ran"], "graph_books": books,
        "profiled_by_name": named[-1],
        "b32_serve_step_graph_ms": graph_ms,
        "b32_serve_step_eager_ms": eager_ms,
        "warmup_ms": warm, "batches": report["batches"],
        "bucket_counts": report["bucket_counts"],
        "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms"),
        "p99_ms": lat.get("p99_ms"),
        "images_served": truth["images_served"],
        "wall_s": report["load"]["wall_s"],
        "images_per_s": truth["images_served"] / report["load"]["wall_s"],
        "spans": report["spans"],
        "logits_max_abs_err": err, "logits_max_abs": scale,
        "b32_forward_ms": fwd_ms, "b32_unfused_forward_ms": plain_fwd_ms,
        "b32_images_per_s": 32 / (fwd_ms / 1e3),
        "b32_profile": breakdown,
        "card": card,
    }


def _serve_graph_books(replicas, per_forward, counted, batches,
                       role="eval") -> dict:
    """The served forwards' launch books under the bucket graphs: each
    replica's warmup runs every bucket's step once eagerly, captures it
    (the wrappers count at capture only) and replays it once, and every
    batch is one replay. ``ok``: ``counted`` (the wrappers' count) equals
    ``per_forward`` x (eager warm-up passes + captures), one capture per
    bucket holding ``per_forward`` launches of ``role``, and the replays
    equal the warm-up's plus ``batches``; ``ran``: the launches that ran,
    ``per_forward`` x (eager passes + replays)."""
    eager = sum(len(r.warmup_ms) for r in replicas)
    graphs = [g for r in replicas for g in r.graph_books().values()]
    captures = sum(g["captures"] for g in graphs)
    replays = sum(g["replays"] for g in graphs)
    return {"eager_warmup": eager, "captures": captures, "replays": replays,
            "forwards_ran": eager + replays,
            "ran": per_forward * (eager + replays),
            "ok": (counted == per_forward * (eager + captures)
                   and captures == eager == len(graphs)
                   and all(g["captured"].get(f"conv.{role}") == per_forward
                           for g in graphs)
                   and replays == eager + batches)}


def _print_serve(tag: str, rec: dict) -> None:
    lat, breakdown = rec, rec["b32_profile"]
    print(f"[{tag}] " + json.dumps(rec))
    print(f"[{tag}] {rec['card']}: {rec['model']} p50 {lat['p50_ms']} ms, "
          f"p95 {lat['p95_ms']} ms, "
          f"{rec['images_per_s']:.1f} images/s offered-load "
          f"(200 Poisson requests at 400/s); bucket-32 forward "
          f"{rec['b32_forward_ms']:.3f} ms = {rec['b32_images_per_s']:.0f} "
          f"images/s; bucket-32 serve step as its graph "
          f"{rec['b32_serve_step_graph_ms']:.3f} ms, eager "
          f"{rec['b32_serve_step_eager_ms']:.3f} ms")
    print(f"[{tag}] bucket-32 forward under the profiler: "
          f"{breakdown['wall_us_per_call']:.1f} us wall, device busy "
          f"{breakdown['device_busy_us_per_call']:.1f} us "
          f"({100 * breakdown['device_busy_share']:.1f}%), "
          f"{breakdown['kernel_launches_per_call']:.0f} device ops")


def phase_serve(out):
    out["serve"] = _serve_run("resnet18", 10, 10, out["card"])
    _print_serve("serve", out["serve"])
    failed = [k for k, v in out["serve"]["checks"].items() if not v]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")


#: phase 5b (a): two replicas on the one card, their load, classes and
#: class SLOs; (b) and (d): the CLI's chaos scenario and its quarantine.
CLUSTER_REQUESTS, CLUSTER_RATE = 400, 800.0
CLUSTER_CLASS_MIX, CLUSTER_CLASS_SLO = (0.6, 0.4), {0: 250.0, 1: 800.0}
CHAOS_ARGS = ["--requests", "300", "--pattern", "burst", "--burst", "10",
              "--rate-rps", "500", "--sizes", "1,2", "--class-mix",
              "0.7,0.3", "--class-slo-ms", "250,800"]
CHAOS_EVENTS = {"drain": (50, 1), "swap": 120, "rejoin": (200, 1)}
#: (d): Poisson at 60/s, so the load (~5 s) outlasts replica 1's 3 s
#: wedge: the health loop restores a replica while it still runs.
QUARANTINE_ARGS = ["--requests", "300", "--pattern", "poisson",
                   "--rate-rps", "60", "--sizes", "1,2",
                   "--fault", "delay:step=5,ms=3000,rank=1",
                   "--stale-after-s", "1"]


def _serve_model(name: str = "resnet18", num_classes: int = 10, seed=0):
    """Phase 5's served model: the fused full-width ``name`` (f32), random
    weights and random BN statistics from ``seed``, on the CPU."""
    import torch

    from tpu_dp_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    model = build_model(name, num_filters=64, num_classes=num_classes,
                        fused_stages=(0, 1, 2, 3), generator=gen)
    _randomize_bn(model, gen)
    return model


def _start_serve_cli(log: str, *argv):
    """``python -m tpu_dp_torch.serve ARGV`` as a user runs it on the
    card, started in the background, its output into ``log``."""
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("TPU_DP_FAULT", None)
    with open(log, "w", encoding="utf-8") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "tpu_dp_torch.serve", *argv], cwd=HERE,
            env=env, stdout=f, stderr=subprocess.STDOUT)


def _finish_serve_cli(proc, log: str) -> tuple[int, str]:
    """(exit code, output tail) of a `_start_serve_cli` run."""
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    with open(log, encoding="utf-8", errors="replace") as f:
        return rc, f.read()[-3000:]


def _flight_events(run_dir: str) -> list:
    """The flight recorder's events dumped under ``run_dir``/obs."""
    path = os.path.join(run_dir, "obs", "flightrec_r00000.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f).get("events", [])


def _cluster_a(out, card) -> tuple[dict, dict]:
    """5b (a): phase 5's model behind two replicas sharing the card."""
    import numpy as np
    import torch

    from tpu_dp_torch.obs.counters import Counters
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.serve import ServeCluster, run_load

    cluster = ServeCluster(
        _serve_model(), replicas=2, devices=["cuda:0"] * 2,
        buckets=(1, 2, 4, 8, 16, 32), slo_ms=250.0,
        class_slo_ms=CLUSTER_CLASS_SLO, registry=Counters(),
        model_name="resnet18")
    cb.reset_launches()
    cluster.start()  # replica by replica: eager pass + capture per bucket
    rec = _Recorder(cluster)
    try:
        report = run_load(rec, n_requests=CLUSTER_REQUESTS,
                          pattern="poisson", rate_rps=CLUSTER_RATE,
                          sizes=(1, 2, 3, 4), seed=0,
                          class_mix=CLUSTER_CLASS_MIX,
                          class_slo_ms=CLUSTER_CLASS_SLO)
    finally:
        cluster.stop()
    launches = cb.launches
    books = _serve_graph_books(cluster.replicas, 10, launches,
                               report["batches"])
    truth, dev = report["ground_truth"], report["device_stats"]
    hist = np.zeros(cluster.num_classes, np.int64)
    for h in rec.handles:
        if h.ok:
            np.add.at(hist, np.asarray(h.predictions, np.int64), 1)
    guards = cluster.guard_stats()
    checks = {
        "consistent": report["consistent"],
        "completed_eq_submitted": truth["completed"] == truth["submitted"],
        "served_eq_images": dev["served"] == truth["images_served"],
        "histogram_eq_handles": dev["class_counts"] == hist.tolist(),
        "both_replicas_served": all(
            r["batches"] > 0 for r in report["replicas"].values()),
        "no_retraces": report["retraces"] == 0,
        "one_capture_per_bucket_per_replica": len(guards) == 12 and all(
            g["cache_size"] == 1 and g["retraces"] == 0 for g in guards),
        "launches_eq_10_per_captured_forward_x_replays": books["ok"],
    }
    # Each replica: its bucket-32 graph against its eager step on one
    # seeded batch (weights 0: the books count nothing), bit for bit, and
    # its replays by kernel name.
    imgs = np.random.default_rng(1).integers(0, 256, (32, 32, 32, 3),
                                             dtype=np.uint8)
    per = {}
    for r in cluster.replicas:
        with torch.cuda.stream(r.stream):
            batch = r._place_batch(32, imgs, np.zeros(32, np.float32))
            _, g = r._program(32)(r._stats, batch)
            got = {k: v.clone() for k, v in g.items()}
            _, e = r._step(32)(r._stats, batch)
            r.stream.synchronize()
        prog = r._program(32)
        named_ok, named = _profiled_books(
            lambda: prog(r._stats, r._dev[32]), {"conv_block_kernel": 10})
        per[r.sid] = {
            "graph_eq_eager": all(torch.equal(got[k], e[k]) for k in got),
            "by_name": named_ok, "profiled": named[-1]}
    checks["b32_graph_bit_identical_to_eager"] = all(
        v["graph_eq_eager"] for v in per.values())
    checks["replays_run_10_kernels_by_name"] = all(
        v["by_name"] for v in per.values())
    lat = report["latency_ms"] or {}
    wall = report["load"]["wall_s"]
    rec_a = {
        "card": card, "replicas": report["replicas"],
        "devices": [str(r.device) for r in cluster.replicas],
        "batches": report["batches"], "bucket_counts":
            report["bucket_counts"], "classes": report["classes"],
        "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms"),
        "p99_ms": lat.get("p99_ms"),
        "images_served": truth["images_served"], "wall_s": wall,
        "images_per_s": truth["images_served"] / wall,
        "spans": report["spans"], "launches": launches,
        "graph_books": books, "guards": guards,
        "warmup_ms": {r.sid: r.warmup_ms for r in cluster.replicas},
        "capture_ms": {r.sid: {b: g.capture_ms for b, g in
                               sorted(r._programs.items())}
                       for r in cluster.replicas},
        "per_replica_b32": per,
        "device_util": report["device_util"],
    }
    return checks, rec_a


def _chaos_cli(run_dir: str) -> list:
    """5b (b)'s CLI arguments: the chaos matrix (drain replica 1, hot
    swap, rejoin) through ``--run-dir``."""
    (d_at, d_sid), (r_at, r_sid) = (CHAOS_EVENTS["drain"],
                                    CHAOS_EVENTS["rejoin"])
    return ["--device", "cuda", "--replicas", "2", "--run-dir", run_dir,
            *CHAOS_ARGS, "--drain-at", f"{d_at}:{d_sid}",
            "--swap-at", str(CHAOS_EVENTS["swap"]),
            "--rejoin-at", f"{r_at}:{r_sid}",
            "--out", os.path.join(run_dir, "report.json")]


def _chaos_cli_checks(run_dir: str, rc: int, tail: str) -> tuple[dict, dict]:
    """5b (b), the CLI's half: exit 0, an ok verdict, 0 retraces, the
    membership ledger (initial, replica 1's departure, its rejoin), every
    dispatch after a replica's swap stamped version 2, ``obs timeline``
    showing drain → swap → rejoin."""
    d_sid = CHAOS_EVENTS["drain"][1]
    checks = {"cli_exit_0": rc == 0}
    rec = {"cli_rc": rc}
    if rc != 0:
        rec["cli_tail"] = tail
    try:
        with open(os.path.join(run_dir, "report.json"),
                  encoding="utf-8") as f:
            rep = json.load(f)
        led = os.path.join(run_dir, "membership", "serve")
        epochs = []
        for n in sorted(os.listdir(led)):
            if n.startswith("epoch_"):
                with open(os.path.join(led, n), encoding="utf-8") as f:
                    epochs.append(json.load(f))
        events = _flight_events(run_dir)
    except (OSError, ValueError) as e:
        rec["unreadable"] = repr(e)
        rep, epochs, events = {}, [], []
    # Each replica's dispatches before its own swap event carry version
    # 1, every one after it version 2 (the recorder keeps them in order).
    swapped = {}
    for i, e in enumerate(events):
        if e.get("kind") == "model_swap" and e.get("replica", -1) >= 0:
            swapped.setdefault(e["replica"], i)
    dispatches = [(i, e) for i, e in enumerate(events)
                  if e.get("kind") == "serve_dispatch"]
    stamps_ok = sorted(swapped) == [0, 1] and bool(dispatches) and all(
        e.get("version") == (2 if i > swapped.get(e.get("replica"), i)
                             else 1)
        for i, e in dispatches)
    trc, tl = _obsctl("timeline", run_dir)
    order = [k for k in ("replica_drain", "model_swap", "replica_rejoin")
             if k in tl]
    checks.update({
        "cli_verdict_ok": (rep.get("verdict") or {}).get("ok") is True,
        "cli_no_retraces": rep.get("retraces") == 0,
        "membership_initial_depart_rejoin":
            [e.get("members") for e in epochs] == [[0, 1], [0], [0, 1]]
            and epochs[1].get("departed", [{}])[0].get("sid") == d_sid
            and epochs[2].get("reason") == "serve_rejoin",
        "dispatches_after_swap_stamped_2": stamps_ok,
        "timeline_exit_0": trc == 0,
        "timeline_drain_swap_rejoin": order == [
            "replica_drain", "model_swap", "replica_rejoin"]
            and tl.index("replica_drain") < tl.index("model_swap")
            < tl.index("replica_rejoin"),
    })
    rec.update({"report_replicas": rep.get("replicas"),
                "served_by_version": (rep.get("ground_truth") or {}).get(
                    "served_by_version"),
                "membership": [{k: e.get(k) for k in (
                    "epoch", "members", "reason", "departed")}
                    for e in epochs],
                "swapped_at_batch": swapped, "timeline_rc": trc})
    return checks, rec


def _chaos_inproc() -> tuple[dict, dict]:
    """5b (b) in process: the CLI's script on a cluster whose answers are
    kept, held against an eager forward of the weights each was stamped
    with."""
    import numpy as np
    import torch

    from tpu_dp_torch.obs.counters import Counters
    from tpu_dp_torch.serve import ServeCluster, run_load

    (d_at, d_sid), (r_at, r_sid) = (CHAOS_EVENTS["drain"],
                                    CHAOS_EVENTS["rejoin"])
    checks, rec = {}, {}
    model, new = _serve_model(), _serve_model(seed=1)
    cluster = ServeCluster(model, replicas=2, devices=["cuda:0"] * 2,
                           buckets=(1, 2, 4, 8, 16, 32), slo_ms=250.0,
                           class_slo_ms=CLUSTER_CLASS_SLO,
                           registry=Counters())
    sent = []

    class _Keep(_Recorder):
        def submit(self, images, *a, **kw):
            h = super().submit(images, *a, **kw)
            sent.append((np.asarray(images), h))
            return h

    def rejoin():
        deadline = time.monotonic() + 5.0
        while (cluster.replicas[r_sid].status != "left"
               and time.monotonic() < deadline):
            time.sleep(0.02)
        cluster.rejoin(r_sid)

    cluster.start()
    try:
        report = run_load(
            _Keep(cluster), n_requests=300, pattern="burst", burst=10,
            rate_rps=500.0, sizes=(1, 2), seed=0, class_mix=(0.7, 0.3),
            class_slo_ms=CLUSTER_CLASS_SLO,
            events=[(d_at, "drain", lambda: cluster.drain(d_sid)),
                    (CHAOS_EVENTS["swap"], "swap",
                     lambda: cluster.swap_model(new.state_dict())),
                    (r_at, "rejoin", rejoin)])
    finally:
        cluster.stop()
    from tpu_dp_torch.train.step import _maybe_normalize

    # Each version's answered images through an eager forward of that
    # version's weights (and of the other's), 32 at a time.
    served = {1: ([], []), 2: ([], [])}
    for images, h in sent:
        if h.ok:
            served[h.model_version][0].append(images)
            served[h.model_version][1].append(np.asarray(h.predictions))
    fresh = {1: model.to("cuda").eval(), 2: new.to("cuda").eval()}
    agree = {1: [0, 0], 2: [0, 0]}
    other = [0, 0]
    with torch.inference_mode():
        for v, (imgs, preds) in served.items():
            if not imgs:
                continue
            x, want = np.concatenate(imgs), np.concatenate(preds)
            for mv, m in fresh.items():
                got = np.concatenate([torch.argmax(m(_maybe_normalize(
                    torch.from_numpy(x[i:i + 32]).cuda())), -1).cpu().numpy()
                    for i in range(0, len(x), 32)])
                same = int((got == want).sum())
                if mv == v:
                    agree[v] = [same, len(want)]
                else:
                    other[0] += same
                    other[1] += len(want)
    checks.update({
        "inproc_consistent": report["consistent"],
        "inproc_no_retraces": report["retraces"] == 0,
        "inproc_both_versions_served": agree[1][1] > 0 and agree[2][1] > 0,
        # The graphs after the swap serve the new weights (the kernel's
        # packed weights refreshed in place): every served prediction is
        # the eager forward's of the version stamped on it, and not the
        # other version's.
        "post_swap_predictions_eq_eager_new_weights":
            agree[2][0] == agree[2][1],
        "pre_swap_predictions_eq_eager_old_weights":
            agree[1][0] == agree[1][1],
        "predictions_differ_between_versions":
            other[0] / max(1, other[1]) < 0.5,
    })
    rec.update({"inproc_agree": agree, "inproc_other_version": other,
                "inproc_served_by_version":
                    report["ground_truth"].get("served_by_version")})
    return checks, rec


def _cluster_c(out) -> tuple[dict, dict]:
    """5b (c): replica 1's bucket programs raise at its 5th batch."""
    from tpu_dp_torch.obs.counters import Counters
    from tpu_dp_torch.serve import ServeCluster, run_load

    reg = Counters()
    cluster = ServeCluster(_serve_model(), replicas=2,
                           devices=["cuda:0"] * 2,
                           buckets=(1, 2, 4, 8, 16, 32), slo_ms=5000.0,
                           registry=reg, max_retries=1)
    cluster.start()
    dying = cluster.replicas[1]
    calls = [0]

    class Dying:
        """One of replica 1's bucket graphs, raising from the replica's
        5th batch on; its other attributes are the graph's, so the
        replica's guards and books stay."""

        def __init__(self, real):
            self.real = real

        def __call__(self, *a, **k):
            calls[0] += 1
            if calls[0] >= 5:
                raise RuntimeError("injected replica death")
            return self.real(*a, **k)

        def __getattr__(self, item):
            return getattr(self.real, item)

    for prog in dying._programs.values():
        prog._fn = Dying(prog._fn)
    report = run_load(cluster, n_requests=200, pattern="poisson",
                      rate_rps=400.0, sizes=(1, 2, 3, 4), seed=2)
    try:
        cluster.stop()
        stop_ok = True
    except RuntimeError:
        stop_ok = False
    truth = report["ground_truth"]
    shed = truth["shed_by_reason"]
    checks = {
        "replica_1_dead": report["replicas"]["1"]["status"] == "dead",
        "replica_errors_name_1": [e["sid"] for e in
                                  report["replica_errors"]] == [1],
        "retried_or_shed_typed":
            report["counters"].get("serve.failover.retried", 0)
            + shed.get("replica_failed", 0) >= 1
            and set(shed) <= {"replica_failed"},
        "consistent": report["consistent"],
        "served_eq_images": report["device_stats"]["served"]
        == truth["images_served"],
        "all_accounted": truth["completed"] + truth["shed"] == 200
        and truth["unresolved"] == 0,
        "stop_does_not_raise": stop_ok,
    }
    return checks, {"replicas": report["replicas"],
                    "replica_errors": report["replica_errors"],
                    "retried": report["counters"].get(
                        "serve.failover.retried", 0),
                    "shed_by_reason": shed}


def _quarantine_cli_checks(run_dir: str, rc: int,
                           tail: str) -> tuple[dict, dict]:
    """5b (d): replica 1 wedged 3 s in its 5th batch (`QUARANTINE_ARGS`
    through the CLI): quarantined, then restored, exact books."""
    try:
        with open(os.path.join(run_dir, "report.json"),
                  encoding="utf-8") as f:
            rep = json.load(f)
        events = _flight_events(run_dir)
    except (OSError, ValueError) as e:
        rep, events = {}, []
        tail += repr(e)
    kinds = [e.get("kind") for e in events if e.get("replica") == 1]
    q = kinds.index("replica_quarantined") if (
        "replica_quarantined" in kinds) else None
    r = kinds.index("replica_restored") if (
        "replica_restored" in kinds) else None
    truth = rep.get("ground_truth") or {}
    checks = {
        "cli_exit_0": rc == 0,
        "verdict_ok": (rep.get("verdict") or {}).get("ok") is True,
        "quarantined_then_restored": q is not None and r is not None
        and q < r,
        "books_exact": rep.get("consistent") is True
        and truth.get("completed") == truth.get("accepted")
        and (rep.get("device_stats") or {}).get("served")
        == truth.get("images_served"),
    }
    out_rec = {"cli_rc": rc, "replicas": rep.get("replicas"),
               "quarantine_events": [e for e in events if e.get("kind") in (
                   "replica_quarantined", "replica_restored")]}
    if rc != 0:
        out_rec["cli_tail"] = tail
    return checks, out_rec


def phase_serve_cluster(out):
    """5b: the self-healing serving tier (`ServeCluster`) on phase 5's
    model (fused full-width ResNet-18, f32, random weights and BN
    statistics from seed 0), every bucket a CUDA graph: (a) two replicas
    sharing the card, each on its own stream, behind one queue (400
    Poisson requests of 1-4 images at 800/s, classes 0.6/0.4 with SLOs
    250/800 ms): audited books overall and per class, the summed device
    books equal to the images served and the handles' predictions, both
    replicas serving, 0 retraces with one capture per bucket per
    replica, the launch books (captured x replays, and by name), and each
    replica's bucket-32 graph bit-identical to its eager step; (b) the
    CLI's chaos matrix (drain replica 1, hot swap, rejoin): exit 0, the
    membership ledger, version stamps, ``obs timeline`` showing drain →
    swap → rejoin, and in process the post-swap answers equal to an eager
    forward of the swapped weights; (c) failover: replica 1's programs
    raise at its 5th batch — retried on replica 0 or shed typed, exact
    books, ``stop()`` does not raise; (d) quarantine: replica 1 wedged 3 s
    (``delay:``), quarantined then restored, exact books; (f) with two or
    more cards, `tools/port_serve_multicard.py`. (a) runs alone (it is
    timed); the CLI runs of (b) and (d) then run beside (b)'s in-process
    half and (c), which check answers and books only. (e), the training
    windows' guard, is in phase 9."""
    import torch

    card = out["card"]
    checks, rec = {}, {"card": card}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_")

    def part(tag, fn, key=None):
        t = time.perf_counter()
        c, r = fn()
        r["seconds"] = time.perf_counter() - t
        rec[key or tag] = r
        checks.update({f"{tag}_{k}": v for k, v in c.items()})
        print(f"[serve_cluster] ({key or tag}) " + json.dumps(
            {"checks": c, "seconds": r["seconds"]}))

    procs = {}
    try:
        t0 = time.perf_counter()
        part("a", lambda: _cluster_a(out, card))
        runs = {"b": os.path.join(tmp.name, "chaos"),
                "d": os.path.join(tmp.name, "quarantine")}
        argv = {"b": _chaos_cli(runs["b"]),
                "d": ["--device", "cuda", "--replicas", "2", "--run-dir",
                      runs["d"], *QUARANTINE_ARGS, "--out",
                      os.path.join(runs["d"], "report.json")]}
        procs = {k: _start_serve_cli(f"{runs[k]}.log", *argv[k])
                 for k in runs}
        part("b", _chaos_inproc, key="b_inproc")
        part("c", lambda: _cluster_c(out))
        for tag, checker in (("b", _chaos_cli_checks),
                             ("d", _quarantine_cli_checks)):
            rc, tail = _finish_serve_cli(procs[tag], f"{runs[tag]}.log")
            part(tag, lambda: checker(runs[tag], rc, tail))
        if torch.cuda.device_count() >= 2:
            p = subprocess.run(
                [sys.executable, os.path.join(HERE, "tools",
                                              "port_serve_multicard.py")],
                cwd=HERE, capture_output=True, text=True, timeout=900)
            rec["f"] = {"rc": p.returncode, "tail": p.stdout[-3000:]
                        + p.stderr[-2000:]}
            checks["f_multi_card_exit_0"] = p.returncode == 0
            print(p.stdout[-3000:])
        else:
            print("serve_cluster_multi_card: not run, 1 card visible")
        rec["seconds"] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    rec["checks"] = checks
    out["serve_cluster"] = rec
    a, single = rec["a"], out.get("serve") or {}
    print(f"[serve_cluster] {card}: 2 replicas on one card "
          f"({CLUSTER_REQUESTS} Poisson requests at {CLUSTER_RATE:.0f}/s): "
          f"p50 {a['p50_ms']} ms, p95 {a['p95_ms']} ms, "
          f"{a['images_per_s']:.1f} images/s; by class " + json.dumps(
              {c: {k: v[k] for k in ("p50_ms", "p95_ms", "attainment")}
               for c, v in a["classes"].items()})
          + f"; phase 5's one replica (200 at 400/s): p50 "
          f"{single.get('p50_ms')} ms, p95 {single.get('p95_ms')} ms, "
          f"{single.get('images_per_s') or 0:.1f} images/s")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        print("[serve_cluster] " + json.dumps(
            {k: rec[k] for k in ("b", "b_inproc", "c", "d") if k in rec},
            default=str)[-6000:])
        raise AssertionError(f"serve_cluster checks failed: {failed}")


def phase_train(out):
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import augment as aug_ops
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.train.trainer import Trainer

    # The epoch save and the final export go to a temporary directory.
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    args = TRAIN_ARGS + [f"--train.ckpt_dir={ckpt.name}"]
    trainer = Trainer(parse_cli(args), device="cuda")
    steps, evals = len(trainer.train_pipe), len(trainer.test_pipe)
    held = torch.cuda.memory_allocated()  # by the earlier phases
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    tx.reset_launches()
    aug_ops.reset_launches()
    result = trainer.fit()
    torch.cuda.synchronize()
    ckpt.cleanup()
    counts = {"conv": dict(cb.launches_by_role), "conv_total": cb.launches,
              "xent": dict(tx.launches), "augment": aug_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = trainer.step_losses
    acc = result["eval"]["accuracy"]
    checks = {
        "steps": steps == TRAIN_STEPS and len(losses) == steps,
        "losses_finite": all(math.isfinite(v) for v in losses),
        "loss_falls": statistics.mean(losses[-5:])
        < statistics.mean(losses[:5]),
        "conv_stats_10_per_step": counts["conv"]["stats"] == 10 * steps,
        "conv_input_grad_10_per_step":
            counts["conv"]["input_grad"] == 10 * steps,
        "conv_eval_10_per_eval_forward":
            counts["conv"]["eval"] == 10 * evals,
        "xent_1_and_1_per_step":
            counts["xent"] == {"forward": steps, "backward": steps},
        "augment_1_per_step": counts["augment"] == steps,
        "accuracy_is_number": isinstance(acc, float) and math.isfinite(acc),
    }
    # The same init, batches, augmentation and schedule, unfused and
    # without kernels (cuDNN convs, cross_entropy_loss, TF32 off).
    ref = Trainer(parse_cli(args + [
        "--model.fused_stages=", "--model.fused_bwd=false",
        "--train.pallas_xent=false"]), device="cuda")
    before = (cb.launches, dict(tx.launches), aug_ops.launches)
    ref.train_pipe.set_epoch(0)
    ref_losses = []
    for batch in ref.train_pipe:
        ref_losses.append(ref.train_step(ref.state, batch)["loss"])
        if len(ref_losses) == 5:
            break
    ref_losses = torch.stack(ref_losses).tolist()
    diffs = [abs(a - b) for a, b in zip(losses[:5], ref_losses)]
    checks["first5_track_unfused"] = max(diffs) <= 0.05
    # The reference draws with the same kernel (the augmentation is not
    # what it stands in for); only the conv and xent kernels stay idle.
    checks["reference_runs_no_kernel"] = before[:2] == (cb.launches,
                                                        dict(tx.launches))

    batch = next(iter(trainer.train_pipe))
    step_ms = cuda_median_ms(lambda: trainer.train_step(trainer.state, batch),
                             reps=20)
    ref_step_ms = cuda_median_ms(lambda: ref.train_step(ref.state, batch),
                                 reps=10)
    # The same books by kernel name on the device: 20 conv launches, 1 + 1
    # xent launches, one draw and no stats-reduce kernel per step (it is
    # folded into the conv launch), under the by-name rule
    # (`_by_name_verdict`); the step's profile beside it.
    books = {"conv_block_kernel": 20, "xent_fwd": 1, "xent_bwd": 1,
             "crop_flip_draws": 1}
    step = lambda: trainer.train_step(trainer.state, batch)  # noqa: E731
    ok, sessions = _profiled_books(step, books, names=True)
    by_name = sessions[-1]["most"]
    checks["profiled_20_conv_1_1_xent_1_draw_per_step"] = ok
    checks["no_stats_reduce_kernel"] = not any(
        "stats_reduce" in n for s in sessions
        for n in s.get("kernel_names", ()))
    breakdown = profile_forward(step)
    out["train"] = {
        "checks": checks, "steps": steps, "eval_forwards": evals,
        "launches": counts, "profiled_launches_per_step": by_name,
        "profiled_sessions": [{k: v for k, v in s.items()
                               if k != "kernel_names"} for s in sessions],
        "losses": losses, "unfused_losses": ref_losses,
        "first5_max_abs_diff": max(diffs), "eval": result["eval"],
        "fit_wall_s": result["wall_time_s"],
        "fit_images_per_s": result["images_per_sec"],
        "step_ms": step_ms, "images_per_s": TRAIN_B / (step_ms / 1e3),
        "unfused_step_ms": ref_step_ms,
        "peak_memory_bytes": peak, "held_before_fit_bytes": held,
        "step_profile": breakdown,
        "card": out["card"],
    }
    print("[train] " + json.dumps(out["train"]))
    print(f"[train] {out['card']}: {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, eval accuracy {acc:.4f}; step "
          f"{step_ms:.3f} ms = {TRAIN_B / (step_ms / 1e3):.0f} images/s "
          f"(unfused, no kernels: {ref_step_ms:.3f} ms); device busy "
          f"{100 * breakdown['device_busy_share']:.1f}% of "
          f"{breakdown['wall_us_per_call']:.1f} us under the profiler, "
          f"{breakdown['kernel_launches_per_call']:.0f} device ops per "
          f"step; peak memory {peak / 2**20:.1f} MiB")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")


class _Stop(Exception):
    """Phase 8's simulated interruption."""


def _ckpt_trainer(ckpt_dir, extra=(), stop_at=None):
    """A phase-8 `Trainer` whose train step records, per step, the
    kernel launches (the wrappers' counters, set to 0 just before the
    step and read just after) and the step's wall ms (synchronized); with
    ``stop_at`` the step before global step ``stop_at`` raises `_Stop`."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.train.trainer import Trainer

    trainer = Trainer(parse_cli(CKPT_ARGS + [f"--train.ckpt_dir={ckpt_dir}",
                                             *extra]), device="cuda")
    real = trainer.train_step
    trainer.books, trainer.step_ms = [], []

    def step(state, batch):
        if stop_at is not None and state.step == stop_at:
            raise _Stop
        torch.cuda.synchronize()
        cb.reset_launches()
        tx.reset_launches()
        t0 = time.perf_counter()
        m = real(state, batch)
        torch.cuda.synchronize()
        trainer.step_ms.append(1e3 * (time.perf_counter() - t0))
        trainer.books.append({"conv": dict(cb.launches_by_role),
                              "xent": dict(tx.launches)})
        return m

    trainer.train_step = step
    return trainer


def _flat_state(trainer) -> dict:
    from tpu_dp_torch.checkpoint import _walk_state_dict, state_dict_of

    return dict(_walk_state_dict(state_dict_of(trainer.state)))


def _same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _books_ok(books) -> bool:
    return all(b == {"conv": {"eval": 0, "stats": 10, "input_grad": 10},
                     "xent": {"forward": 1, "backward": 1}} for b in books)


def phase_checkpoint(out):
    """8: checkpoints on the card. (a) the fused full-width main path, f32,
    cuDNN deterministic: 3 epochs uninterrupted; the same run interrupted
    at the start of epoch 3, then resumed by a fresh `Trainer` with
    ``--resume``: the restored state equals the interrupted run's (and the
    uninterrupted run's epoch-2 state) bit for bit, epoch 3's losses, the
    final state and the eval equal the uninterrupted run's, 20 conv + 1 + 1
    xent launches each step; (b) the save's blocking and background ms,
    the payload, a verified load and the first resumed step against a
    steady one; (c) `InferenceEngine.from_checkpoint` of the epoch-3 save:
    audited books, 10 conv launches per captured forward x replays,
    bucket-32 logits equal to the trained model's eval forward; (d) the
    reference workload (`Net`, batch 4) through ``python -m
    tpu_dp_torch.train`` on the card, its final params loaded back, a
    card-vs-CPU `Net` forward and gradient within 1e-4 of max|.|, and
    1 + 1 xent launches a step with ``--train.pallas_xent=true``."""
    import tempfile

    import numpy as np
    import torch

    from tpu_dp_torch import checkpoint as ck
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.serve import InferenceEngine, run_load
    from tpu_dp_torch.train.step import _maybe_normalize
    from tpu_dp_torch.train.trainer import Trainer

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    checks, rec = {}, {"card": out["card"]}
    stop = (CKPT_EPOCHS - 1) * CKPT_SPE
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            # (a) uninterrupted; the state at the end of epoch 2 kept.
            full = _ckpt_trainer(os.path.join(tmp, "full"))
            epoch2 = {}
            real_epoch = full.train_epoch

            def train_epoch(epoch, start_step=0):
                stats = real_epoch(epoch, start_step)
                if epoch == CKPT_EPOCHS - 2:
                    epoch2.update(_flat_state(full))
                return stats

            full.train_epoch = train_epoch
            res_full = full.fit()
            part = _ckpt_trainer(os.path.join(tmp, "part"), stop_at=stop)
            try:
                part.fit()
            except _Stop:
                pass
            part.ckpt_mgr.wait()
            at_stop = _flat_state(part)
            resumed = _ckpt_trainer(os.path.join(tmp, "part"), ["--resume"])
            restored = _flat_state(resumed)
            res_resumed = resumed.fit()
            torch.cuda.synchronize()
            # Each run's newest epoch save: the epoch-3 saves waited for
            # the epoch-2 write still in flight, if any (wait_ms).
            saves = {"full_epoch_3": full.ckpt_mgr.last_save,
                     "interrupted_epoch_2": part.ckpt_mgr.last_save,
                     "resumed_epoch_3": resumed.ckpt_mgr.last_save}
            checks.update({
                "resumed_at_epoch_3": (resumed.start_epoch,
                                       resumed.start_step) == (2, 0),
                "restored_eq_interrupted_state": _same_state(restored,
                                                             at_stop),
                "restored_step": int(restored["step"]) == stop,
                "interrupted_eq_uninterrupted_epoch_2": _same_state(
                    at_stop, epoch2),
                "epoch_3_losses_bit_identical": resumed.step_losses
                == full.step_losses[stop:],
                "final_state_bit_identical": _same_state(
                    _flat_state(resumed), _flat_state(full)),
                "eval_identical": res_resumed["eval"] == res_full["eval"],
                "books_20_conv_1_1_xent_every_step": _books_ok(
                    full.books + part.books + resumed.books)
                and len(resumed.books) == CKPT_SPE,
                "losses_finite": all(math.isfinite(v)
                                     for v in full.step_losses),
            })
            # (b) costs: the save that blocks the training thread, its
            # background write, a verified load into a fresh state.
            step_dir = ck.CheckpointManager(
                os.path.join(tmp, "full")).latest_dir()
            target = _ckpt_trainer(os.path.join(tmp, "probe")).state
            torch.cuda.synchronize()
            load_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                ck.load_checkpoint(step_dir, target)
                torch.cuda.synchronize()
                load_ms.append(1e3 * (time.perf_counter() - t0))
            steady = statistics.median(full.step_ms[2:])
            rec.update({
                "saves": saves,
                "payload_mb": saves["full_epoch_3"]["payload_bytes"] / 1e6,
                "load_verified_ms": load_ms,
                "first_step_ms_fresh": full.step_ms[0],
                "first_resumed_step_ms": resumed.step_ms[0],
                "steady_step_ms": steady,
                "steady_step_ms_resumed": statistics.median(
                    resumed.step_ms[2:]),
                "losses_full": full.step_losses,
                "losses_resumed": resumed.step_losses,
                "eval": res_full["eval"],
            })

            # (c) serve the epoch-3 save: the model rebuilt from its meta.
            engine = InferenceEngine.from_checkpoint(
                step_dir, device="cuda", buckets=(1, 2, 4, 8, 16, 32),
                slo_ms=250.0)
            cb.reset_launches()
            engine.start()
            rq = _Recorder(engine)
            try:
                report = run_load(rq, n_requests=CKPT_SERVE_REQUESTS,
                                  pattern="poisson", rate_rps=400.0,
                                  sizes=(1, 2, 3, 4), seed=3)
            finally:
                engine.stop()
            served_launches = cb.launches_by_role["eval"]
            books = _serve_graph_books([engine.replica], 10,
                                       served_launches, report["batches"])
            forwards = books["forwards_ran"]
            truth, dev = report["ground_truth"], report["device_stats"]
            imgs = torch.from_numpy(np.random.default_rng(4).integers(
                0, 256, (32, 32, 32, 3), dtype=np.uint8)).cuda()
            full.model.eval()
            with torch.inference_mode():
                x = _maybe_normalize(imgs)
                served = engine.model(x)
                trained = full.model(x)
            checks.update({
                "serve_consistent": report["consistent"],
                "serve_served_eq_images":
                    dev["served"] == truth["images_served"],
                "serve_10_launches_per_captured_forward_x_replays":
                    books["ok"],
                "serve_no_retraces": report["retraces"] == 0,
                "serve_b32_logits_bit_identical_to_trained": torch.equal(
                    served, trained),
            })
            rec["serve"] = {"batches": report["batches"],
                            "forwards": forwards,
                            "conv_launches": served_launches,
                            "graph_books": books,
                            "p50_ms": (report["latency_ms"] or {}).get(
                                "p50_ms"),
                            "images_served": truth["images_served"]}
            del engine, full, part, resumed, target

            # (d) the reference workload, the system's default command.
            ref_dir = os.path.join(tmp, "ref")
            run = subprocess.run(
                [sys.executable, "-m", "tpu_dp_torch.train", *REF_ARGS,
                 f"--train.ckpt_dir={ref_dir}"], cwd=HERE,
                capture_output=True, text=True, timeout=600)
            lines = run.stdout.strip().splitlines()
            step_losses = [float(ln.rpartition(":")[2]) for ln in lines
                           if ln.startswith("[")]
            summary = json.loads(lines[-1]) if run.returncode == 0 else {}
            net = ck.load_params(os.path.join(ref_dir, "final_params.msgpack"),
                                 build_model("net"))
            checks.update({
                "reference_exit_0": run.returncode == 0,
                "reference_losses_finite_and_fall": bool(step_losses)
                and all(math.isfinite(v) for v in step_losses)
                and statistics.mean(step_losses[-2:])
                < statistics.mean(step_losses[:2]),
                "reference_finished": "Finished Training" in lines
                and any(ln.startswith("Accuracy of the network on the 200")
                        for ln in lines),
                "reference_model_net": summary.get("model") == "net",
                "reference_final_params_load": sum(
                    p.numel() for p in net.parameters()) == 62006,
            })
            rec["reference"] = {"returncode": run.returncode,
                                "step_losses": step_losses,
                                "summary": summary,
                                "stderr_tail": run.stderr[-2000:]}
            # Card vs CPU, one seeded Net, forward and gradient.
            gen = torch.Generator().manual_seed(0)
            cpu = build_model("net", generator=gen)
            card = build_model("net").cuda()
            card.load_state_dict(cpu.state_dict())
            rng = np.random.default_rng(5)
            xb = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(
                np.float32))
            yb = torch.from_numpy(rng.integers(0, 10, 4))
            errs = {}
            for name, m in (("cpu", cpu), ("card", card)):
                where = next(m.parameters()).device
                logits = m(xb.to(where))
                torch.nn.functional.cross_entropy(
                    logits, yb.to(where)).backward()
                errs[name] = [logits.detach().cpu()] + [
                    p.grad.cpu() for p in m.parameters()]
            rel = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(errs["card"], errs["cpu"]))
            checks["net_card_vs_cpu_within_1e-4"] = rel <= 1e-4
            rec["net_card_vs_cpu_rel_err"] = rel
            # --train.pallas_xent=true: 1 + 1 xent launches each step.
            from tpu_dp_torch.config import parse_cli
            from tpu_dp_torch.ops import xent as tx

            xt = Trainer(parse_cli(REF_ARGS + [
                "--train.epochs=1", "--train.pallas_xent=true",
                "--train.eval_at_end=false",
                f"--train.ckpt_dir={os.path.join(tmp, 'ref_xent')}"]),
                device="cuda")
            tx.reset_launches()
            xt.fit()
            torch.cuda.synchronize()
            n = len(xt.train_pipe)
            checks["reference_xent_1_and_1_per_step"] = dict(
                tx.launches) == {"forward": n, "backward": n}
            rec["reference_xent_launches"] = dict(tx.launches)
            rec["reference_xent_steps"] = n
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
    rec["checks"] = checks
    out["checkpoint"] = rec
    print("[checkpoint] " + json.dumps(rec, default=str))
    last = saves["full_epoch_3"]
    print(f"[checkpoint] {out['card']}: ResNet-18 save "
          f"{rec['payload_mb']:.1f} MB, blocking the training thread "
          f"{last['blocking_ms']:.1f} ms (of which snapshot "
          f"{last['snapshot_ms']:.1f} ms, waiting for the previous write "
          f"{last['wait_ms']:.1f} ms), background write "
          f"{last['write_ms']:.1f} ms; verified load "
          f"{statistics.median(load_ms):.1f} ms; first resumed step "
          f"{rec['first_resumed_step_ms']:.2f} ms vs steady "
          f"{rec['steady_step_ms']:.2f} ms (fresh run's first step "
          f"{rec['first_step_ms_fresh']:.2f} ms)")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"checkpoint checks failed: {failed}")


def _ddp_batches(world: int):
    """The parity runs' global batches: ``DDP_STEPS`` of ``world *
    TRAIN_B`` uint8 images and labels, from seed 7 (rank r trains on rows
    ``[r*TRAIN_B, (r+1)*TRAIN_B)``)."""
    import numpy as np

    rng = np.random.default_rng(7)
    n = world * TRAIN_B
    return (rng.integers(0, 256, (DDP_STEPS, n, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, (DDP_STEPS, n)).astype(np.int64))


def _ddp_train(ctx, world: int, profile: bool = False,
               wire: str | None = None, comm_dir: str | None = None) -> dict:
    """``DDP_STEPS`` fused full-width updates (f32, the slice's kernels)
    from the seed-0 init on this rank's rows of `_ddp_batches`: per-step
    global losses, the books of each step (kernel launches by the
    wrappers' counters, the collectives by `collectives.counts`) and its
    CUDA-event time. ``ctx`` None: one process on the whole batch, no
    group. ``profile``: then 5 more steps on the last batch under the
    profiler (CUDA activity alone): wall and device-busy time per step and
    the NCCL kernels' share. ``wire`` ("" f32, "bf16", "int8"): the
    sharded update over the group instead of DDP, with the exchange's
    collectives per update it should issue (``exchange_books``).
    ``comm_dir`` (rank 0): the comm attribution's window over updates
    `DDP_COMM_WINDOW` (`_comm_window`), its report under ``comm_report``."""
    import torch

    import torch.distributed as dist

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.parallel import collectives, quant
    from tpu_dp_torch.train.optim import make_sgd, shard_optimizer
    from tpu_dp_torch.train.schedule import make_schedule
    from tpu_dp_torch.train.step import (
        TrainState,
        data_parallel,
        make_train_step,
    )

    dev = torch.device("cuda", 0) if ctx is None else ctx.device
    group = None if ctx is None else ctx.process_group
    model = build_model(
        "resnet18", num_filters=64, num_classes=10,
        fused_stages=(0, 1, 2, 3), fused_bwd=True, process_group=group,
        generator=torch.Generator().manual_seed(0)).to(dev)
    exchange = None
    if wire is None:
        runs = model if ctx is None else data_parallel(model, ctx)
        opt = make_sgd(model, 0.9, 5e-4)
    else:
        runs = model
        opt = shard_optimizer(model, world, ctx.rank, dist.group.WORLD,
                              0.9, 5e-4, codec=quant.make_wire_codec(wire))
        exchange = _exchange_books(opt, 1)
    step = make_train_step(runs, opt, make_schedule(*DDP_SCHED),
                           use_pallas_xent=True, device=dev,
                           process_group=group)
    state = TrainState(step=0, model=model, optimizer=opt)
    images, labels = _ddp_batches(world)
    rows = (slice(None) if ctx is None
            else slice(ctx.rank * TRAIN_B, (ctx.rank + 1) * TRAIN_B))
    losses, books, ms = [], [], []
    # The books reset every update: the comm window's run from the start.
    ran = dict.fromkeys(collectives.books(), 0)
    comm = None
    if comm_dir is not None and ctx is not None and ctx.rank == 0:
        comm = _comm_window(ctx, world, opt if wire is not None else None,
                            wire, comm_dir, lambda: {
                                k: ran[k] + v for k, v in
                                collectives.books().items()})
    for i, (img, lab) in enumerate(zip(images, labels)):
        batch = {"image": torch.from_numpy(img[rows]).to(dev),
                 "label": torch.from_numpy(lab[rows]).to(dev)}
        torch.cuda.synchronize(dev)
        cb.reset_launches()
        tx.reset_launches()
        for k, v in collectives.books().items():
            ran[k] += v
        collectives.reset_counts()
        if comm is not None:
            comm["profiler"].on_window_start(i + 1, 1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        m = step(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        books.append({"conv": dict(cb.launches_by_role),
                      "xent": dict(tx.launches), **collectives.counts})
        if comm is not None:
            comm["profiler"].on_step(i + 1)
    prof = None
    if profile:
        p = profile_forward(lambda: step(state, batch), cuda_only=True,
                            keep_all=True)
        prof = {k: p[k] for k in ("wall_us_per_call",
                                  "device_busy_us_per_call",
                                  "kernel_launches_per_call")}
        prof["nccl"] = {k: v for k, v in p["all"].items()
                        if "nccl" in k.lower()}
    report = None
    if comm is not None:
        comm["profiler"].close()
        report = comm["read"]()
    return {"losses": losses, "books": books, "step_ms": ms, "profile": prof,
            "device": str(next(model.parameters()).device),
            "exchange_books": exchange, "comm_report": report,
            "state": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}}


def _comm_report_checks(rep, wire, world) -> dict:
    """Phase 7a's checks of a pair's comm report (rank 0's window over
    `DDP_COMM_WINDOW`): written and read back; source "host" (gloo's
    collectives are CPU ops); the window's updates; every kind the books
    say ran reconciled exactly (all-reduce: DDP's buckets, or the
    metrics' under the sharded update; sync-BN's pmeans; DDP's bucket
    rebuild at update 2; reduce-scatter, all-gather and, under int8,
    all-to-all), no kind seen that the books lack; the sharded wire held
    against `quant.wire_report`; comm time measured and an overlap
    share."""
    if rep is None:
        return {"comm_report_written": False}
    recon = rep.get("reconciliation") or {}
    by = recon.get("by_kind") or {}
    want = {"all-reduce"} | (set() if wire is None else
                             {"reduce-scatter", "all-gather"}
                             | ({"all-to-all"} if wire == "int8" else set()))
    ran = {k for k, v in by.items() if v["expected"]}
    a, b = DDP_COMM_WINDOW
    checks = {
        "comm_report_written": True,
        "comm_source_host": rep["source"] == "host",
        "comm_window_steps": (rep["start_step"], rep["end_step"],
                              rep["steps"], rep["world"]) == (a, b, b - a,
                                                              world),
        "comm_reconciled_every_kind": recon.get("ok") is True
        and all(v["ok"] is True for v in by.values())
        and want <= ran <= want | {"broadcast"},
        "comm_ms_positive": rep["comm_ms"] > 0,
        "comm_overlap_frac_measured": rep["overlap_frac"] is not None}
    if wire is not None:
        checks["comm_wire_reconciled"] = (
            (rep.get("wire") or {}).get("reconciliation") or {}).get(
                "ok") is True
    return checks


def _comm_window(ctx, world, opt, wire, trace_dir, books_fn) -> dict:
    """The port's comm attribution driven by hand over a training loop's
    updates `DDP_COMM_WINDOW` (``profiler``: call its ``on_window_start``
    before update i + 1 and ``on_step`` after it): its trace under
    ``trace_dir``, its expected collectives from ``books_fn`` (the
    cumulative `collectives.books`), the sharded exchange's wire held
    against `quant.wire_report` (``opt``, the sharded optimizer, else
    None). ``read()``: the window's ``comm_report.json``, written with
    `write_comm_report` and read back with `read_comm_report`, or None
    when the window published nothing (a failed parse)."""
    import torch

    from tpu_dp_torch.obs import chips
    from tpu_dp_torch.obs.commprof import (
        CommProfiler,
        read_comm_report,
        write_comm_report,
    )
    from tpu_dp_torch.parallel import quant
    from tpu_dp_torch.utils.profiling import ChromeTrace

    gloo, cuda = ctx.backend == "gloo", ctx.device.type == "cuda"
    tracer = ChromeTrace(rank=ctx.rank, cuda=cuda, cpu=gloo)
    path = os.path.join(trace_dir, "comm_report.json")
    wire_report = None if opt is None else quant.wire_report(
        opt.leaves, world, getattr(opt.codec, "block_size",
                                   quant.DEFAULT_BLOCK_SIZE))
    profiler = CommProfiler(
        trace_dir, ("range", *DDP_COMM_WINDOW), devices=1, world=world,
        books_fn=books_fn, source="host" if gloo else "device",
        wire_report=wire_report, wire_dtype=wire or "",
        link_gbs=chips.link_gbs(torch.cuda.get_device_name(ctx.device))
        if cuda else None,
        publish=lambda rep, *_: write_comm_report(path, rep),
        start_fn=tracer.start, stop_fn=tracer.stop)
    return {"profiler": profiler,
            "read": lambda: read_comm_report(path) if os.path.exists(path)
            else None}


def ddp_worker(spec_path: str) -> int:
    """One rank of phase 7's two-rank runs (``chip_smoke.py --ddp-worker
    SPEC``): joins the group SPEC names, runs `_ddp_train`, and saves what
    it recorded to ``SPEC["out"]`` (``torch.save``)."""
    sys.path.insert(0, HERE)
    import torch

    from tpu_dp_torch.parallel.dist import initialize, shutdown

    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = initialize(backend=spec["backend"], init_method=spec["init"],
                     world_size=spec["world"], rank=spec["rank"],
                     device=spec["device"], timeout_s=300)
    try:
        rec = _ddp_train(ctx, spec["world"], spec["profile"],
                         spec.get("wire"), spec.get("comm_dir"))
        rec["backend"] = ctx.backend
        torch.save(rec, spec["out"])
    finally:
        shutdown()
    return 0


def _start_ddp_ranks(world: int, backend, devices, profile: bool,
                     wire: str | None = None, comm: bool = False) -> tuple:
    """Start ``world`` ranks of `ddp_worker` as processes of this script,
    rank r on ``devices[r]``, in a rendezvous directory of their own (so
    several groups may run at once); `_ddp_ranks` collects them. With
    ``comm`` rank 0 runs the comm attribution's window."""
    import shutil

    work = os.path.join(HERE, "build", "ddp_smoke",
                        f"{os.getpid()}-{wire}-{world}-{backend}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    for rank in range(world):
        spec = {"rank": rank, "world": world, "backend": backend,
                "device": devices[rank], "profile": profile,
                "wire": wire,
                "comm_dir": os.path.join(work, "commprof") if comm
                else None,
                "init": "file://" + os.path.join(work, "rendezvous"),
                "out": os.path.join(work, f"rank{rank}.pt")}
        path = os.path.join(work, f"spec{rank}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-worker",
             path], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return work, procs


def _ddp_ranks(world: int, backend, devices, profile: bool,
               wire: str | None = None, started=None) -> list:
    """Each rank's record of ``world`` ranks of `ddp_worker` (``started``:
    `_start_ddp_ranks`' handle of the same ranks, else started here)."""
    import shutil

    import torch

    work, procs = started or _start_ddp_ranks(world, backend, devices,
                                              profile, wire)
    try:
        recs = []
        for rank, p in enumerate(procs):
            log, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"ddp rank {rank} exited "
                                     f"{p.returncode}:\n{log[-4000:]}")
            recs.append(torch.load(os.path.join(work, f"rank{rank}.pt")))
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)


def _ddp_parity(out, key: str, world: int, backend, devices,
                profile: bool = False, wire: str | None = None,
                started=None, ref=None, comm_checked: bool = False) -> dict:
    """``world`` ranks against one process on the concatenated batch:
    per-step global loss within ``DDP_LOSS_TOL``, parameters and buffers
    bit-identical across the ranks, and each rank's books per step: 20
    conv launches (10 ``emit_stats``, 10 input-grad), 1 + 1 xent, 20 + 20
    sync-BN pmeans, one metrics all-reduce, DDP's buckets (printed); with
    ``wire`` the sharded update instead of DDP, its exchange's
    reduce-scatters, all-to-alls and all-gather as planned and no DDP
    bucket. ``comm_checked``: the ranks ran rank 0's comm window, and its
    report is held to `_comm_report_checks`."""
    import torch

    ranks = _ddp_ranks(world, backend, devices, profile, wire, started)
    ref = ref or _ddp_train(None, world)
    diffs = [max(abs(a - b) for a, b in zip(r["losses"], ref["losses"]))
             for r in ranks]
    same = all(torch.equal(ranks[0]["state"][k], r["state"][k])
               for r in ranks[1:] for k in ranks[0]["state"])
    want = {"conv": {"eval": 0, "stats": 10, "input_grad": 10},
            "xent": {"forward": 1, "backward": 1}, "pmean_forward": 20,
            "pmean_backward": 20, "psum": 1}
    if wire is None:
        books_ok = all({k: b[k] for k in want} == want
                       and b["ddp_buckets"] >= 1
                       for r in ranks for b in r["books"])
    else:
        books_ok = all({k: b[k] for k in want} == want
                       and b["ddp_buckets"] == 0
                       and all(b[k] == v for k, v in
                               r["exchange_books"].items())
                       for r in ranks for b in r["books"])
    comm = ranks[0].get("comm_report")
    rec = {
        "world": world, "wire": wire, "comm_report": comm,
        "backend": [r["backend"] for r in ranks],
        "devices": [r["device"] for r in ranks],
        "losses": [r["losses"] for r in ranks],
        "concatenated_losses": ref["losses"], "max_abs_diff": max(diffs),
        "books_per_step": ranks[0]["books"],
        "ddp_buckets_per_step": [b["ddp_buckets"] for b in
                                 ranks[0]["books"]],
        # Steps 2.. (the first builds cuDNN plans and DDP's buckets).
        "step_ms_median": [statistics.median(r["step_ms"][1:])
                           for r in ranks],
        "concatenated_step_ms_median": statistics.median(ref["step_ms"][1:]),
        "profile": [r["profile"] for r in ranks],
        "checks": {
            "losses_within_tol": max(diffs) <= DDP_LOSS_TOL,
            "losses_finite": all(math.isfinite(v) for r in ranks
                                 for v in r["losses"]),
            "ranks_bit_identical": same,
            "books_20_conv_1_1_xent_20_20_pmean": books_ok,
            "backend_as_asked": all(r["backend"] == (backend or "nccl")
                                    for r in ranks),
            "on_the_card": all(r["device"].startswith("cuda")
                               for r in ranks),
        },
        "card": out["card"],
    }
    if comm_checked:
        rec["checks"].update(_comm_report_checks(comm, wire, world))
        rec["checks"]["comm_window_on_rank_0_alone"] = not any(
            r["comm_report"] for r in ranks[1:])
    step = rec["step_ms_median"][0]
    rec["global_images_per_s"] = world * TRAIN_B / (step / 1e3)
    out[key] = rec
    print(f"[{key}] " + json.dumps(rec))
    print(f"[{key}] {out['card']}: {world} ranks ({rec['backend'][0]}"
          + ("" if wire is None else f", sharded {wire or 'f32'}") + ") on "
          f"{rec['devices']}, B={TRAIN_B} per rank: losses "
          f"{[round(v, 4) for v in rec['losses'][0]]} vs concatenated "
          f"B={world * TRAIN_B} {[round(v, 4) for v in ref['losses']]} "
          f"(max diff {max(diffs):.3g}); ranks bit-identical: {same}; DDP "
          f"buckets per step {rec['ddp_buckets_per_step']}; step "
          f"{step:.3f} ms")
    if comm is not None:
        print(f"[{key}] comm window {comm['start_step']}:{comm['end_step']}"
              f" on rank 0 ({comm['source']}): comm {comm['comm_ms']} ms "
              f"an update, exposed {comm['exposed_comm_ms']}, overlap "
              f"{comm['overlap_frac']}, compute {comm['compute_ms']}; "
              f"collectives an update " + json.dumps(
                  {k: v["per_step"] for k, v in comm["by_kind"].items()})
              + f"; reconciled {comm['reconciliation']['ok']}, wire "
              + json.dumps((comm.get("wire") or {}).get("reconciliation")))
    failed = [k for k, v in rec["checks"].items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec, ranks[0]["state"]


def phase_ddp_gloo_one_card(out):
    """7a: two ranks on the one card through gloo on CUDA tensors (NCCL
    refuses two ranks on one card). A correctness run: gloo copies every
    all-reduce through the host, so its step time is no DDP figure. Its
    three pairs of ranks (DDP, sharded f32, sharded int8) run at once."""
    print("[ddp_gloo_one_card] backend gloo, asked for explicitly: two "
          "ranks share cuda:0")
    cards = ["cuda:0"] * DDP_WORLD
    started = {wire: _start_ddp_ranks(DDP_WORLD, "gloo", cards, False, wire,
                                      comm=True)
               for wire in (None, "", "int8")}
    try:
        _ddp_gloo_pairs(out, cards, started)
    finally:
        import shutil

        for work, procs in started.values():  # a failed pair's partners
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
            shutil.rmtree(work, ignore_errors=True)


def _ddp_gloo_pairs(out, cards, started) -> None:
    ref = _ddp_train(None, DDP_WORLD)  # the three pairs' one yardstick
    _ddp_parity(out, "ddp_gloo_one_card", DDP_WORLD, "gloo", cards,
                started=started[None], ref=ref, comm_checked=True)
    # The sharded update on the same two ranks. gloo may not implement a
    # reduce-scatter or an all-to-all of CUDA tensors: then the run is
    # reported as not run, with gloo's error (nothing stages through the
    # host instead).
    for wire in ("", "int8"):
        key = f"ddp_gloo_one_card_sharded_{wire or 'f32'}"
        try:
            _ddp_parity(out, key, DDP_WORLD, "gloo", cards, wire=wire,
                        started=started[wire], ref=ref, comm_checked=True)
        except AssertionError as e:
            if "exited" not in str(e):
                raise
            err = [ln for ln in str(e).splitlines() if "Error" in ln
                   or "not supported" in ln or "unsupported" in ln]
            out[key] = {"run": False, "error": err[-3:] or str(e)[-600:]}
            print(f"[{key}] not run: gloo refused the sharded update on "
                  f"CUDA tensors: {out[key]['error']}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _nccl_world1_env(**extra):
    """One NCCL rank's env contract (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT at a free port, and ``extra``) around a
    block; after it the group is shut down and the env restored."""
    from tpu_dp_torch.parallel.dist import shutdown

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           **extra}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _world1_vs_one_process(out, key, args, steps, convs, turns=False):
    """Phase 7b for one model: `Trainer` at world 1 on NCCL through
    `initialize()` and the env contract against the same run in one
    process without a group (``args``: the CLI arguments, ``steps``
    updates and one eval): per-step losses within 0.05 of it, finite and
    falling; the books per update (``convs`` + ``convs`` conv and 1 + 1
    xent launches, ``convs`` a eval forward, DDP's buckets, and no sync-BN
    all-reduce, which world 1 does not issue); the eval count the test
    set; both steps' ms and the DDP step's device ops and busy share
    (CUDA activity alone under the profiler). With ``turns``, also the
    step without and with DDP's wrapper in turns on the same model and
    batch (plain, DDP, DDP, plain): what DDP adds, in ms and device ops.
    Records ``out[key]``."""
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import make_train_step
    from tpu_dp_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_world1_")
    try:
        one = Trainer(parse_cli(args + [
            f"--train.ckpt_dir={os.path.join(tmp.name, 'one')}"]),
            device="cuda")
        one.fit()
        batch = next(iter(one.train_pipe))
        one_ms = cuda_median_ms(lambda: one.train_step(one.state, batch),
                                reps=20)
        with _nccl_world1_env():
            trainer = Trainer(parse_cli(args + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'ddp')}"]))
            ctx = trainer.ctx
            result, ran = _fit_books(trainer)

            def step():
                return trainer.train_step(trainer.state, batch)

            step_ms = cuda_median_ms(step, reps=20)
            prof = profile_forward(step, cuda_only=True, keep_all=True)
            ab = {}
            for name in ("plain", "ddp", "ddp", "plain") if turns else ():
                fn = make_train_step(
                    trainer.ddp if name == "ddp" else trainer.model,
                    trainer.optimizer, trainer.schedule,
                    use_pallas_xent=True, device=trainer.device)
                ms = cuda_median_ms(lambda: fn(trainer.state, batch), reps=20)
                ops = profile_forward(lambda: fn(trainer.state, batch),
                                      cuda_only=True)[
                    "kernel_launches_per_call"]
                ab.setdefault(name, []).append({"step_ms": ms,
                                                "device_ops_per_step": ops})
    finally:
        tmp.cleanup()
    losses, ev = trainer.step_losses, result["eval"]
    diffs = [abs(a - b) for a, b in zip(losses, one.step_losses)]
    h = max(1, min(5, len(losses) // 2))
    rec = {
        "backend": ctx.backend, "world": ctx.world, "device": str(ctx.device),
        "steps": len(losses), "losses": losses,
        "single_losses": one.step_losses, "max_abs_diff": max(diffs),
        "eval": ev, "books": ran,
        "pmeans_per_update": {k: ran[k] / len(losses)
                              for k in ("pmean_forward", "pmean_backward")},
        "ddp_buckets_per_update": ran["ddp_buckets"] / len(losses),
        "step_ms": step_ms, "single_process_step_ms": one_ms,
        "ddp_added_ms": step_ms - one_ms,
        "device_ops_per_step": prof["kernel_launches_per_call"],
        "device_busy_share": prof["device_busy_share"],
        "nccl_kernels": {k: v for k, v in prof["all"].items()
                         if "nccl" in k.lower()},
        "plain_vs_ddp_in_turns": ab,
        "fit_images_per_s": result["images_per_sec"], "card": out["card"],
    }
    rec["checks"] = {
        "nccl_world_1": (ctx.backend, ctx.world) == ("nccl", 1)
        and ctx.device.type == "cuda",
        "steps": len(losses) == steps == len(one.step_losses),
        "losses_finite": all(math.isfinite(v) for v in losses),
        "loss_falls": statistics.mean(losses[-h:])
        < statistics.mean(losses[:h]),
        "losses_track_one_process": max(diffs) <= DDP_LOSS_TOL,
        "eval_count_is_test_set": ev["count"] == len(trainer.test_ds),
        "books": _per_update_ok(ran, steps, len(trainer.test_pipe),
                                convs=convs),
        "ddp_buckets_reduced": ran["ddp_buckets"] >= steps,
        "world_1_issues_no_sync_bn":
            ran["pmean_forward"] == ran["pmean_backward"] == 0,
    }
    out[key] = rec
    print(f"[{key}] " + json.dumps(rec))
    print(f"[{key}] {out['card']}: NCCL world 1 via initialize() and the "
          f"env contract: loss {losses[0]:.4f} -> {losses[-1]:.4f} (one "
          f"process within {max(diffs):.3g}), eval {ev['count']} images, "
          f"step {step_ms:.3f} ms (one process {one_ms:.3f}); "
          f"{prof['kernel_launches_per_call']:.0f} device ops per step"
          + ("; in turns, plain vs DDP: " + json.dumps(ab) if turns else ""))
    del one, trainer, batch
    failed = [k for k, v in rec["checks"].items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def phase_ddp_nccl_world1(out):
    """7b: DDP's machinery on the card: `_world1_vs_one_process` on the
    fused full-width ResNet-18, 30 steps and one eval, with the plain and
    DDP steps in turns; then the comm attribution's window over it
    (`_world1_comm_window`)."""
    _world1_vs_one_process(out, "ddp_nccl_world1", TRAIN_ARGS, TRAIN_STEPS,
                           convs=10, turns=True)
    _world1_comm_window(out)


def commprof_multi_card(out, world: int, wire: str | None,
                        timeout_s: float = 600) -> dict:
    """The comm attribution across ``world`` cards, one NCCL rank a card:
    ``python -m torch.distributed.run --standalone --nproc_per_node=WORLD
    -m tpu_dp_torch.train`` on the preset with the kernel knobs, windows
    of 10 as CUDA graphs, ``--obs.comm_profile_steps`` over
    `COMMPROF_MC_WINDOW`; ``wire`` None replicated (DDP), "" or "int8"
    the sharded update. Rank 0's report: source "device", the window's
    10 updates at this world, every collective kind reconciled exactly
    with the books (none absent across cards), the sharded wire held
    against `quant.wire_report`, ``wire_gbs`` and ``ici_util`` (against
    the card's NVLink rate) for every kind that moved bytes, the overlap
    share recorded. The run's log goes to ``chiprun_out/``."""
    import shutil

    name = "replicated" if wire is None else (wire or "f32")
    key = f"commprof_nccl_world{world}_{name}"
    work = os.path.join(HERE, "build", "commprof_mc", key)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    a, b = COMMPROF_MC_WINDOW
    args = [
        "--preset=resnet18_cifar10", "--model.fused_stages=all",
        "--model.fused_bwd=true", "--train.pallas_xent=true",
        "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
        f"--data.synthetic_train_size="
        f"{COMMPROF_MC_UPDATES * world * TRAIN_B}",
        "--train.epochs=1", "--train.eval_at_end=false",
        "--train.steps_per_call=10", f"--obs.comm_profile_steps={a}:{b}",
        f"--train.ckpt_dir={os.path.join(work, 'ck')}"]
    if wire is not None:
        args += _sharded_args(wire, 0)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={world}", "-m", "tpu_dp_torch.train", *args],
        cwd=HERE, capture_output=True, text=True, timeout=timeout_s)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"{key}.log"), "w",
              encoding="utf-8") as f:
        f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    path = os.path.join(work, "ck", "obs", "comm_report.json")
    rep = None
    if p.returncode == 0 and os.path.exists(path):
        from tpu_dp_torch.obs.commprof import read_comm_report

        rep = read_comm_report(path)
    checks = {"exit_0": p.returncode == 0, "report_written": rep is not None}
    if rep is not None:
        recon = rep.get("reconciliation") or {}
        by = recon.get("by_kind") or {}
        moved = {k: v for k, v in rep["by_kind"].items()
                 if v.get("wire_bytes_per_step")}
        want = {"all-reduce"} | (set() if wire is None else
                                 {"reduce-scatter", "all-gather"}
                                 | ({"all-to-all"} if wire == "int8"
                                    else set()))
        checks.update({
            "source_device": rep["source"] == "device",
            "window": (rep["start_step"], rep["end_step"], rep["steps"],
                       rep["world"]) == (a, b, b - a, world),
            "reconciled_every_kind": recon.get("ok") is True
            and all(v["ok"] is True for v in by.values())
            and want <= {k for k, v in by.items() if v["expected"]},
            "wire_gbs_and_link_share": bool(moved) and all(
                "wire_gbs" in v and "ici_util" in v for v in moved.values()),
            "overlap_recorded": rep["overlap_frac"] is not None})
        if wire is not None:
            checks["wire_reconciled"] = ((rep.get("wire") or {}).get(
                "reconciliation") or {}).get("ok") is True
    rec = {"world": world, "wire": name, "report": rep, "checks": checks,
           "seconds": seconds, "card": out.get("card")}
    out[key] = rec
    print(f"[{key}] " + json.dumps(rec))
    if rep is not None:
        print(f"[{key}] {out.get('card')}: comm {rep['comm_ms']} ms an "
              f"update, exposed {rep['exposed_comm_ms']}, overlap "
              f"{rep['overlap_frac']}, compute {rep['compute_ms']}; "
              + json.dumps({k: {f: v.get(f) for f in
                                ("per_step", "dur_ms_per_step",
                                 "wire_bytes_per_step", "wire_gbs",
                                 "ici_util")}
                            for k, v in rep["by_kind"].items()}))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        print(p.stderr[-3000:])
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def _world1_comm_window(out) -> dict:
    """7b's comm window: the same `Trainer` at NCCL world 1 (cuDNN
    deterministic) fitted with ``--obs.comm_profile_steps`` over
    `WORLD1_COMM_WINDOW` and without it. The report's source is "device"
    (CUDA kernels); the window's conv and xent kernels by name equal the
    books of its updates, with the session's spin bracket counted apart
    (up to 2 x `PROFILE_LEAD_IN`: the spins at the session's edges are
    where its lost records fall, 127 in one of three calls); the NCCL
    kernels found, by name and count an
    update, are printed (none at one rank: NCCL runs a one-rank
    collective as a device-to-device copy, and the report gives each kind
    absent with that reason, never ok and never failed); the flight
    recorder holds the window without a parse error; the parameters
    after the run are bit-identical to the unprofiled run's."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.obs import flightrec, kineto
    from tpu_dp_torch.obs.commprof import read_comm_report
    from tpu_dp_torch.train.trainer import Trainer

    a, b = WORLD1_COMM_WINDOW
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_commprof_")
    states, ran = {}, {}
    try:
        for window in (False, True):
            flightrec.recorder.reset()
            with _nccl_world1_env():
                t = Trainer(parse_cli(TRAIN_ARGS + [
                    f"--train.ckpt_dir={os.path.join(tmp.name, str(window))}"]
                    + ([f"--obs.comm_profile_steps={a}:{b}"] if window
                       else [])))
                _, ran[window] = _fit_books(t)
                states[window] = _flat_state(t)
            if window:
                rep = read_comm_report(t.obs_dir / "comm_report.json")
                summary = kineto.summarize(rep["trace_dir"], "device")
                events = [e for e in flightrec.recorder.events()
                          if e["kind"] == "comm_profile"]
            del t
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    steps = b - a
    want = {"conv_block_kernel": 20 * steps, "xent_fwd": steps,
            "xent_bwd": steps}
    ops = {r["name"]: r["count"] for r in summary["ops"]}
    got = {k: sum(n for name, n in ops.items() if k in name.lower())
           for k in want}
    nccl = {r["name"]: r["count"] / steps for r in summary["ops"]
            if r["category"] == "comm"}
    by = rep["reconciliation"]["by_kind"]
    rec = {"window": [a, b], "report": rep, "kernels_by_name": got,
           "books_in_window": want, "nccl_kernels_per_update": nccl,
           "spins_left_out": summary["skipped"].get("spin", 0),
           "card": out["card"]}
    rec["checks"] = checks = {
        "source_device": rep["source"] == "device",
        "window_steps": (rep["start_step"], rep["end_step"], rep["steps"],
                         rep["world"]) == (a, b, steps, 1),
        "kernels_by_name_equal_books": got == want,
        "books_per_update": _per_update_ok(ran[True], TRAIN_STEPS, 2)
        and ran[True] == ran[False],
        # The bracket's spins absorb the records a session loses at its
        # edges: some of them may be gone, none may count as compute.
        "spin_bracket_left_out": 0 < rec["spins_left_out"]
        <= 2 * PROFILE_LEAD_IN,
        # At one rank NCCL launches no kernel: every booked kind absent
        # with its reason; any kind that did run reconciled.
        "reconciliation_compares_what_runs":
            rep["reconciliation"]["ok"] is not False
            and all(v["ok"] is True or (v["ok"] is None and v.get("absent")
                                        and not v["observed_raw"])
                    for v in by.values()),
        "flightrec_window_without_error": len(events) == 1
        and "error" not in events[0],
        "params_bit_identical_to_unprofiled":
            _same_state(states[True], states[False]),
    }
    out["ddp_nccl_world1_commprof"] = rec
    print("[ddp_nccl_world1_commprof] " + json.dumps(rec))
    print(f"[ddp_nccl_world1_commprof] {out['card']}: window [{a}, {b}) "
          f"at NCCL world 1, source {rep['source']}: kernels by name {got} "
          f"(books {want}), {rec['spins_left_out']} spins left out; NCCL "
          f"kernels an update {nccl or 'none'}; kinds "
          + json.dumps({k: v.get("absent") or v["ok"] for k, v in by.items()})
          + f"; comm {rep['comm_ms']} ms an update, compute "
          f"{rep['compute_ms']}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"ddp_nccl_world1_commprof checks failed: "
                             f"{failed}")
    return rec


def phase_ddp_nccl_multi_card(out):
    """7c: NCCL, one rank per card, when two or more cards are visible:
    the same parity against the concatenated batch, and global images/s
    (with every visible card too, when there are more than two), for DDP
    and for the sharded update in f32 and int8."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"ddp_nccl_multi_card: not run, {n} card visible")
        out["ddp_nccl_multi_card"] = {"run": False, "cards": n}
        print(f"commprof_nccl_multi_card: not run, {n} card visible "
              f"(tools/port_commprof_multicard.py)")
        out["commprof_nccl_multi_card"] = {"run": False, "cards": n}
        return
    recs, sharded, vs_ddp = {}, {}, {}
    for world in sorted({2, n}):
        devs = [f"cuda:{r}" for r in range(world)]
        recs[world], ddp_state = _ddp_parity(
            out, f"ddp_nccl_world{world}", world, None, devs, profile=True)
        for wire in ("", "int8"):
            name = wire or "f32"
            sharded[(world, name)], state = _ddp_parity(
                out, f"ddp_nccl_world{world}_sharded_{name}", world, None,
                devs, profile=True, wire=wire)
            if not wire:
                # Sharded f32 against DDP, recorded, not required: phase 7
                # leaves cuDNN's nondeterministic algorithms on, so two
                # runs may part from the third update on whatever order
                # NCCL's reduce-scatter sums in.
                vs_ddp[world] = {
                    "losses_bit_identical": sharded[(world, name)]["losses"]
                    == recs[world]["losses"],
                    "max_abs_diff_state": max(
                        float((state[k].double() - ddp_state[k].double())
                              .abs().max()) for k in state)}
    one = out.get("ddp_nccl_world1", {}).get("step_ms")
    out["ddp_nccl_multi_card"] = {
        "run": True, "cards": n,
        "global_images_per_s": {w: r["global_images_per_s"]
                                for w, r in recs.items()},
        "sharded_global_images_per_s": {
            f"{w}_{name}": r["global_images_per_s"]
            for (w, name), r in sharded.items()},
        "sharded_f32_vs_ddp": vs_ddp,
        "world1_images_per_s": None if one is None else TRAIN_B / (one / 1e3),
    }
    print("[ddp_nccl_multi_card] " + json.dumps(out["ddp_nccl_multi_card"]))


def _first_window(pipe, k):
    """The first ``(n, pool)`` of ``pipe.windows(k)``, its prefetcher
    stopped."""
    it = pipe.windows(k)
    try:
        return next(it)
    finally:
        it.close()


def _fit_books(trainer) -> tuple[dict, dict]:
    """``trainer.fit()`` with every book set to 0 just before; returns the
    result and the launches and collectives that RAN (`_ran_books`)."""
    _reset_books()
    result = trainer.fit()
    return result, _ran_books(trainer)


def _per_update_ok(ran, updates, evals, accum=1, convs=10) -> bool:
    """The launches that ran equal ``updates`` updates' books: 2 x
    ``convs`` conv (``convs`` ``emit_stats`` + ``convs`` input-grad; 10 in
    ResNet-18, 13 in ResNet-50) and 1 + 1 xent per microbatch, ``convs``
    conv per eval forward."""
    want = {"conv.stats": convs * accum * updates,
            "conv.input_grad": convs * accum * updates,
            "xent.forward": accum * updates,
            "xent.backward": accum * updates, "conv.eval": convs * evals}
    return all(ran[k] == v for k, v in want.items())


def _profiled_books(fn, books, n=2, tries=3, names=False):
    """Kernels by name per call of ``fn`` under the profiler (CUDA activity
    alone), in up to ``tries`` sessions while a count falls below
    ``books``; returns the by-name rule's verdict (`_by_name_verdict`) and
    the sessions (each kernel's name with ``names``), the last one also
    carrying the verdict's ``most`` and ``records_short``."""
    sessions = []
    for _ in range(tries):
        p = profile_forward(fn, n, cuda_only=True, keep_all=True,
                            lead_in=PROFILE_LEAD_IN,
                            lead_out=PROFILE_LEAD_IN,
                            spin_cycles=PROFILE_SPIN_CYCLES)
        by_name = {k: sum(v["count_per_call"] for name, v in p["all"].items()
                          if k in name.lower()) for k in books}
        sessions.append({"by_name": by_name,
                         "nccl_per_call": sum(
                             v["count_per_call"] for name, v in
                             p["all"].items() if "nccl" in name.lower()),
                         "device_ops_per_call": p["kernel_launches_per_call"],
                         "device_busy_share": p["device_busy_share"],
                         "wall_us_per_call": p["wall_us_per_call"],
                         "device_busy_us_per_call":
                             p["device_busy_us_per_call"],
                         **({"kernel_names": p["kernel_names"]} if names
                            else {})})
        if by_name == books or any(by_name[k] > v for k, v in books.items()):
            break
    ok, most, short = _by_name_verdict(sessions, books, n)
    # The verdict's counts ride on the last session's record.
    sessions[-1].update(most=most, records_short=short)
    return ok, sessions


def _by_name_verdict(sessions, books, n):
    """The by-name books' rule, the same in every phase: each kernel's count
    is its most over the sessions of ``n`` calls, and must equal the books;
    a session counting above them fails at once. A session opened late in
    a long process lost the records of the first kernels it saw (the loss
    grew with the sessions the process had opened: `tools/port_profiler_
    loss.py`), and a session over long graph replays those of the last
    (`tools/port_profiler_drops.py`); every by-name session now starts and
    ends with `PROFILE_LEAD_IN` spin kernels of `PROFILE_SPIN_CYCLES`,
    waited for and left out, which those tools measured to remove the
    loss. Returns ``(ok, most, records short per kernel)``."""
    runs = [s["by_name"] for s in sessions]
    most = {k: max(r[k] for r in runs) for k in books}
    short = {k: round(n * (books[k] - most[k])) for k in books}
    ok = (not any(r[k] > books[k] for r in runs for k in books)
          and all(v == 0 for v in short.values()))
    return ok, most, short


def _xent_mean_parity(lg, lb, ct) -> dict:
    """The batch-mean xent pair on logits ``lg``, labels ``lb`` and the
    scalar cotangent ``ct``: relative errors against the plain versions,
    and whether loss and gradient are bit-identical across 100 launches
    and across 3 replays of a CUDA graph of forward + backward (captured
    on a side stream that ran the pair once before, outside the capture,
    where its ticket counters are made)."""
    import torch

    from tpu_dp_torch.ops import xent as tx

    b = lg.shape[0]
    loss, d = tx._fwd(lg, lb, True), tx._bwd(lg, lb, ct, True)
    losses = [tx._fwd(lg, lb, True) for _ in range(100)]
    grads = [tx._bwd(lg, lb, ct, True) for _ in range(100)]
    rl = tx._plain_fwd(lg, lb).mean()
    rd = tx._plain_bwd(lg, lb, (ct / b).expand(b))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tx._fwd(lg, lb, True)
        tx._bwd(lg, lb, ct, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        g_loss = tx._fwd(lg, lb, True)
        g_d = tx._bwd(lg, lb, ct, True)
    replays = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(torch.equal(g_loss, loss) and torch.equal(g_d, d))
    torch.cuda.synchronize()
    return {"shape": list(lg.shape),
            "fwd_abs_err": (loss - rl).abs().item(),
            "bwd_abs_err": (d - rd).abs().max().item(),
            "fwd_rel_err": ((loss - rl).abs() / rl.abs()).item(),
            "bwd_rel_err": ((d - rd).abs().max() / rd.abs().max()).item(),
            "fwd_bit_identical_100_launches": all(torch.equal(v, loss)
                                                  for v in losses),
            "bwd_bit_identical_100_launches": all(torch.equal(v, d)
                                                  for v in grads),
            "graph_replays_bit_identical": replays}


def _launch_floor(threads_b: int):
    """An empty kernel on one block of the one-CTA xent launch's size at
    ``threads_b`` rows: the least any launch costs on the device."""
    import ctypes

    import torch

    from tpu_dp_torch.ops import _build

    empty = _build.load("xent").tpu_dp_empty_kernel
    empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int

    def floor():
        if empty(threads_b, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty kernel launch failed")
    return floor


def _windows_xent(out, rec, checks):
    """9(f): the xent kernels' one-CTA route at [128, 10]: within 1e-6 of
    the plain versions, the mean bit-identical across 100 launches and 3
    replays of a CUDA graph of forward + backward, the launch floor (an
    empty kernel's device time), and forward and backward device time by
    batch on both routes (the one-CTA threshold)."""
    import torch

    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(9)
    b, c = TRAIN_B, XENT_CLASSES[0]
    lg = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
    lb = torch.randint(0, c, (b,), generator=gen, device="cuda")
    ct = torch.tensor(1.3, device="cuda")
    x = _xent_mean_parity(lg, lb, ct)
    replays = x["graph_replays_bit_identical"]
    # One block of the one-CTA launches' size at [128, 10].
    floor = _launch_floor(b)
    x.update({"floor_ms": device_ms(floor),
              "floor_launch_loop_ms": cuda_loop_ms(floor),
              "fwd_ms": device_ms(lambda: tx._fwd(lg, lb, True)),
              "bwd_ms": device_ms(lambda: tx._bwd(lg, lb, ct, True))})
    sweep = {}
    saved = tx.ONE_CTA_MAX_ROWS
    try:
        for nb in XENT_SWEEP_B:
            lgb = 3.0 * torch.randn(nb, c, generator=gen, device="cuda")
            lbb = torch.randint(0, c, (nb,), generator=gen, device="cuda")
            row = {}
            for route, limit in (("one_cta", 1 << 30), ("multi_block", 0)):
                tx.ONE_CTA_MAX_ROWS = limit
                row[route] = {
                    "fwd_ms": device_ms(lambda: tx._fwd(lgb, lbb, True)),
                    "bwd_ms": device_ms(lambda: tx._bwd(lgb, lbb, ct,
                                                        True))}
            sweep[nb] = row
    finally:
        tx.ONE_CTA_MAX_ROWS = saved
    x["by_batch"] = sweep
    # The ticket counters refuse to be made inside a capture (a fresh
    # stream has none yet).
    from tpu_dp_torch.ops import _tickets

    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(),
                              stream=torch.cuda.Stream()):
            _tickets.tickets(torch.device("cuda", 0), 1)
        x["tickets_refused_inside_capture"] = False
    except RuntimeError as e:
        x["tickets_refused_inside_capture"] = (
            "inside a CUDA graph capture" in str(e))
    rec["xent"] = x
    out["xent_floor_ms"] = x["floor_ms"]
    checks.update({
        "xent_one_cta_within_1e-6": x["fwd_rel_err"] <= 1e-6
        and x["bwd_rel_err"] <= 1e-6,
        "xent_mean_bit_identical_100_launches":
            x["fwd_bit_identical_100_launches"]
            and x["bwd_bit_identical_100_launches"],
        "xent_bit_identical_3_graph_replays": all(replays),
        "tickets_refused_inside_capture":
            x["tickets_refused_inside_capture"],
    })
    print("[windows] xent " + json.dumps(x))


def _win_args(updates, batch=TRAIN_B, k=1, extra=()):
    return ["--preset=resnet18_cifar10", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            "--data.dataset=synthetic", f"--data.batch_size={batch}",
            f"--data.synthetic_train_size={updates * TRAIN_B}",
            f"--data.synthetic_test_size={2 * TRAIN_B}",
            "--train.epochs=1", "--train.log_every=10",
            f"--train.steps_per_call={k}", "--data.device_resident=off",
            *extra]


#: the timed turns of `_windows_vs_eager`: profiled eager updates, CUDA-
#: event reps of the eager update and of the window, host-timed windows,
#: metered eager updates and windows. Phase 9 (a) times with these (cut
#: from 5, 10, 4, 4, 12, 5 to pay for phase 17's grow; its checks and
#: books unchanged); phase 11 (b) times each of its four wires with fewer,
#: and takes the eager update's profile and ms from (a)'s run of the same
#: trainer.
WINDOW_TURNS = {"eager_prof": 2, "eager_reps": 5, "win_reps": 2,
                "host": 2, "meter_eager": 5, "meter_win": 3}
#: phase 9 (d)'s turns (each way once, plain then DDP; cut from plain,
#: DDP, DDP, plain) and CUDA-event reps of an update in each, eager and
#: windowed (cut from 20 and 8), and (b)'s; (f)'s batches of the xent
#: routes' timing sweep (cut from 128, 256, 512, 1024, 4096).
DDP_TURNS = ("plain_eager", "ddp_eager", "plain_windowed", "ddp_windowed")
DDP_TURN_REPS = (10, 4)
ACCUM_REPS = (5, 3)
XENT_SWEEP_B = (128, 256, 4096)
SHARDED_B_TURNS = {"eager_prof": 0, "eager_reps": 0, "win_reps": 2,
                   "host": 2, "meter_eager": 3, "meter_win": 3}
#: phase 10 (c)'s turns: a ResNet-50 window is 10 updates of ~77 ms, so
#: fewer turns keep its timing to seconds (its checks and books unchanged).
R50_WINDOW_TURNS = {"eager_prof": 2, "eager_reps": 4, "win_reps": 2,
                    "host": 2, "meter_eager": 4, "meter_win": 3}


def _windows_vs_eager(out, args, k, updates, convs, where, eager=None,
                      turns=WINDOW_TURNS, eager_timing=None):
    """Phase 9's (a) and (c) for one model, cuDNN deterministic set by the
    caller: ``updates`` eager updates against windows of ``k`` from the
    same init (``args(n, k)``: the CLI arguments of ``n`` updates in
    windows of ``k``; saves under ``where``; ``eager``: the eager run's
    ``(trainer, fit result, books, flat state after the fit)`` when the
    caller already ran it on ``args(updates, 1)``): one eager warm-up window,
    then one capture replayed; per-update losses, final state (parameters,
    BN statistics, momentum) and eval bit-identical, losses finite and
    falling, the books per update (``convs`` + ``convs`` conv, 1 + 1 xent)
    from the captured counts x replays and per replay by kernel name under
    the profiler; then speed in the same call: eager step ms against
    windowed ms per update (CUDA events over whole windows), images/s by
    the fenced meter, device busy share and ops per update, host ms per
    window, the capture's ms and the bytes it holds, peak memory, each
    timed over ``turns`` (`WINDOW_TURNS`; ``eager_timing``, ``{"step_ms",
    "profile"}``: the eager update's, already measured by the caller);
    ``rec["seconds"]`` splits the call's own time into the fits, the
    by-name books and the timing. Returns ``(checks, rec)``."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer
    from tpu_dp_torch.utils.meter import ThroughputMeter

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    peak0 = torch.cuda.max_memory_allocated()
    win = Trainer(parse_cli(args(updates, k) + [
        f"--train.ckpt_dir={os.path.join(where, 'win')}"]), device="cuda")
    res_w, ran_w = _fit_books(win)
    peak_w = torch.cuda.max_memory_allocated()
    if eager is None:
        eager = Trainer(parse_cli(args(updates, 1) + [
            f"--train.ckpt_dir={os.path.join(where, 'eager')}"]),
            device="cuda")
        res_e, ran_e = _fit_books(eager)
        eager_state = _flat_state(eager)
    else:
        eager, res_e, ran_e, eager_state = eager
    ms = win.multi_step
    evals = len(win.test_pipe)
    losses = win.step_losses
    checks = {
        "windowed": ms is not None and ms.graph is not None
        and ms.eager_windows == 1 and ms.replays == updates // k - 1,
        "losses_bit_identical": losses == eager.step_losses
        and len(losses) == updates,
        "state_bit_identical": _same_state(_flat_state(win), eager_state),
        "eval_identical": res_w["eval"] == res_e["eval"],
        "losses_finite_and_fall": all(math.isfinite(v) for v in losses)
        and statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
        "books_windowed": _per_update_ok(ran_w, updates, evals, convs=convs),
        "books_eager": _per_update_ok(ran_e, updates, evals, convs=convs),
        "captured_is_one_window": ms.captured is not None and {
            n: ms.captured[n] for n in ("conv.stats", "conv.input_grad",
                                        "xent.forward", "xent.backward")}
        == {"conv.stats": convs * k, "conv.input_grad": convs * k,
            "xent.forward": k, "xent.backward": k},
    }
    rec = {"losses": losses, "eval": res_w["eval"], "ran_windowed": ran_w,
           "ran_eager": ran_e, "captured": dict(ms.captured),
           "replays": ms.replays, "eager_windows": ms.eager_windows,
           "window_guard": (win._window_guard.stats()
                            if win._window_guard is not None else None)}
    # Books per replay by kernel name, and speed, same models.
    _, pool = _first_window(win.train_pipe, k)
    batch = next(iter(eager.train_pipe))
    t_books = time.perf_counter()
    ok, sessions = _profiled_books(
        lambda: win.multi_step(win.state, pool),
        {"conv_block_kernel": 2 * convs * k, "xent_fwd": k, "xent_bwd": k})
    checks["profiled_books_per_replay"] = ok
    t_timing = time.perf_counter()
    if eager_timing is None:
        eager_prof = profile_forward(
            lambda: eager.train_step(eager.state, batch),
            turns["eager_prof"], cuda_only=True)
        eager_ms = cuda_median_ms(
            lambda: eager.train_step(eager.state, batch),
            reps=turns["eager_reps"])
    else:
        eager_prof, eager_ms = (eager_timing["profile"],
                                eager_timing["step_ms"])
    win_prof = sessions[-1]
    win_ms = cuda_median_ms(lambda: win.multi_step(win.state, pool),
                            reps=turns["win_reps"], warm=1) / k
    host = []
    for _ in range(turns["host"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win.multi_step(win.state, pool)
        host.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    meters = {}
    for name, fn, n, imgs in (
            ("eager", lambda: eager.train_step(eager.state, batch),
             turns["meter_eager"], TRAIN_B),
            ("windowed", lambda: win.multi_step(win.state, pool),
             turns["meter_win"], k * TRAIN_B)):
        meter = ThroughputMeter(warmup_steps=2, device="cuda")
        for _ in range(n):
            fn()
            meter.step(imgs)
        meter.mark()
        meters[name] = meter.images_per_sec
    rec.update({
        "eager_step_ms": eager_ms, "windowed_ms_per_update": win_ms,
        "images_per_s_meter": meters,
        "fit_images_per_s": {"eager": res_e["images_per_sec"],
                             "windowed": res_w["images_per_sec"]},
        "eager_device_busy_share": eager_prof["device_busy_share"],
        "eager_device_ops_per_update": eager_prof["kernel_launches_per_call"],
        "windowed_device_busy_share": win_prof["device_busy_share"],
        "windowed_device_ops_per_update": win_prof["device_ops_per_call"] / k,
        "windowed_device_busy_us_per_update":
            win_prof["device_busy_us_per_call"] / k,
        "eager_device_busy_us_per_update":
            eager_prof["device_busy_us_per_call"],
        "host_ms_per_window": statistics.median(host),
        "host_ms_per_window_all": host,
        "capture_ms": ms.capture_ms, "capture_bytes": ms.capture_bytes,
        "max_memory_allocated_before_fit": peak0,
        "max_memory_allocated_after_windowed_fit": peak_w,
        "profiled_sessions": sessions,
        "turns": dict(turns),
        "seconds": {"fits": t_books - t_start,
                    "books_by_name": t_timing - t_books,
                    "timing": time.perf_counter() - t_timing},
    })
    ms.close()
    return checks, rec


def _print_windows(tag, card, k, c, extra=""):
    print(f"[{tag}] {card}: windows of {k}: eager step "
          f"{c['eager_step_ms']:.3f} ms, windowed "
          f"{c['windowed_ms_per_update']:.3f} ms per update; images/s "
          f"{json.dumps(c['images_per_s_meter'])}; device busy "
          f"{100 * c['eager_device_busy_share']:.1f}% eager, "
          f"{100 * c['windowed_device_busy_share']:.1f}% windowed; ops per "
          f"update {c['eager_device_ops_per_update']:.0f} / "
          f"{c['windowed_device_ops_per_update']:.0f}; host "
          f"{c['host_ms_per_window']:.3f} ms per window; capture "
          f"{c['capture_ms']:.1f} ms holding "
          f"{c['capture_bytes'] / 2**20:.1f} MiB" + extra)


def phase_windows(out):
    """9: ``train.steps_per_call`` as CUDA-graph windows, and
    ``optim.grad_accum_steps``, on the fused full-width ResNet-18 (Train
    configuration, f32, B=128, cuDNN deterministic): (f) the xent kernels'
    one-CTA route; (a) 40 eager updates against windows of 10 (one eager
    warm-up window, then one capture replayed 3 times) from the same init:
    per-update losses, final parameters, BN statistics, momentum and the
    eval bit-identical, the books per update from the captured counts ×
    replays, and by kernel name under the profiler per replay; (c) speed in
    the same call: eager step ms and windowed ms per update (CUDA events
    over whole windows), images/s by the fenced meter, device busy share
    and ops per update under the profiler, host ms per window, capture ms
    and the bytes it holds; then at world 1 on NCCL through `initialize()`
    and the env contract: (d) phase 7b's `Trainer` with windows of 10
    against its eager run, bit-identical, and DDP's added ms per update
    eager and windowed; (b) ``grad_accum_steps=2`` at B=64, eager against
    windowed, bit-identical, 2 × (20 + 1 + 1) launches and one DDP
    all-reduce set per update; (e) phase 8's interrupted and resumed run
    with windows of 5, bit-identical to the uninterrupted one."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import make_multi_step, make_train_step
    from tpu_dp_torch.train.trainer import Trainer

    k, updates = 10, 40
    checks, rec = {}, {"card": out["card"], "k": k}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_windows_")
    try:
        _windows_xent(out, rec, checks)
        # (a) parity and books, one card, no group, the windows under
        # the recompile guard at raise (phase 5b (e)); (c) speed.
        from tpu_dp_torch.obs.counters import counters as obs_counters

        retraces0 = obs_counters.get("recompile.retraces", 0)
        a_checks, rec["a"] = _windows_vs_eager(
            out, lambda n, kk: _win_args(
                n, k=kk, extra=("--train.recompile_guard=raise",)),
            k, updates, 10, tmp.name)
        checks.update({"a_" + n: v for n, v in a_checks.items()})
        guard = rec["a"]["window_guard"] or {}
        checks.update({
            "a_guard_raise_no_retraces": guard.get("retraces") == 0
            and obs_counters.get("recompile.retraces", 0) == retraces0,
            "a_guard_cache_size_1": guard.get("cache_size") == 1,
        })
        print("[windows] (c) " + json.dumps(
            {n: v for n, v in rec["a"].items() if n not in (
                "losses", "ran_windowed", "ran_eager", "captured")}))
        # (d) and (b): world 1 on NCCL through initialize() and the env
        # contract (the env var before the group, as the Trainer sets it).
        with _nccl_world1_env(TORCH_NCCL_ASYNC_ERROR_HANDLING="0"):
            dw = Trainer(parse_cli(TRAIN_ARGS + [
                "--train.steps_per_call=10",
                f"--train.ckpt_dir={os.path.join(tmp.name, 'dw')}"]))
            res_dw, ran_dw = _fit_books(dw)
            de = Trainer(parse_cli(TRAIN_ARGS + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'de')}"]))
            res_de, ran_de = _fit_books(de)
            steps = len(de.train_pipe)
            dms = dw.multi_step
            buckets = dms.captured["ddp_buckets"] // k
            checks.update({
                "d_nccl_world_1": (dw.ctx.backend, dw.ctx.world) == (
                    "nccl", 1),
                "d_windowed": dms.graph is not None and dms.replays >= 1,
                "d_losses_bit_identical": dw.step_losses == de.step_losses,
                "d_state_bit_identical": _same_state(_flat_state(dw),
                                                     _flat_state(de)),
                "d_eval_identical": res_dw["eval"] == res_de["eval"],
                # DDP's first update reduces in its first bucket layout;
                # the windowed run reduces as often as the eager one, and
                # a replay as many buckets per update as the capture saw.
                "d_books": _per_update_ok(ran_dw, steps, len(dw.test_pipe))
                and ran_dw["ddp_buckets"] == ran_de["ddp_buckets"]
                and buckets >= 1 and dms.captured["ddp_buckets"]
                == buckets * k,
            })
            _, dpool = _first_window(dw.train_pipe, k)
            dbatch = next(iter(de.train_pipe))
            dbooks = {"conv_block_kernel": 20 * k, "xent_fwd": k,
                      "xent_bwd": k}
            ok, dsessions = _profiled_books(
                lambda: dw.multi_step(dw.state, dpool), dbooks)
            # NCCL's one-rank all-reduce in place may launch no kernel at
            # all; where it does, one per bucket per update.
            checks["d_profiled_books_per_replay"] = ok and dsessions[-1][
                "nccl_per_call"] in (0, buckets * k)
            # DDP's cost per update, eager and windowed, in turns on one
            # model (`DDP_TURNS`): the same step without the wrapper, per
            # step and in its own windows.
            plain = make_train_step(dw.model, dw.optimizer, dw.schedule,
                                    use_pallas_xent=True, device=dw.device)
            plain_win = make_multi_step(plain, k)
            calls = {
                "plain_eager": (lambda: plain(dw.state, dbatch), 1),
                "ddp_eager": (lambda: dw.train_step(dw.state, dbatch), 1),
                "plain_windowed": (lambda: plain_win(dw.state, dpool), k),
                "ddp_windowed": (lambda: dw.multi_step(dw.state, dpool), k)}
            turns = {}
            for name in DDP_TURNS:
                fn, per = calls[name]
                turns.setdefault(name, []).append(
                    cuda_median_ms(fn, reps=DDP_TURN_REPS[per > 1]) / per)
            de_ms, dw_ms = min(turns["ddp_eager"]), min(turns["ddp_windowed"])
            rec["d"] = {"losses": dw.step_losses, "eval": res_dw["eval"],
                        "ran_windowed": ran_dw, "buckets_per_update": buckets,
                        "replays": dms.replays,
                        "eager_windows": dms.eager_windows,
                        "ms_per_update_in_turns": turns,
                        "ddp_eager_step_ms": de_ms,
                        "ddp_windowed_ms_per_update": dw_ms,
                        "ddp_added_ms_eager":
                            de_ms - min(turns["plain_eager"]),
                        "ddp_added_ms_windowed":
                            dw_ms - min(turns["plain_windowed"]),
                        "profiled_sessions": dsessions}
            print("[windows] (d) " + json.dumps(rec["d"]))
            dw.multi_step.close()
            plain_win.close()
            del dw, de, dpool, dbatch, plain, plain_win, calls
            # (b) accumulation: 2 microbatches of 64 per update.
            acc = ["--optim.grad_accum_steps=2"]
            aw = Trainer(parse_cli(_win_args(30, 64, k, acc) + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'aw')}"]))
            res_aw, ran_aw = _fit_books(aw)
            ae = Trainer(parse_cli(_win_args(30, 64, 1, acc) + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'ae')}"]))
            res_ae, ran_ae = _fit_books(ae)
            n_up = len(ae.train_pipe)
            checks.update({
                "b_updates": n_up == 30 and aw.global_batch_size == 128,
                "b_windowed": aw.multi_step.graph is not None,
                "b_losses_bit_identical": aw.step_losses == ae.step_losses,
                "b_state_bit_identical": _same_state(_flat_state(aw),
                                                     _flat_state(ae)),
                # One gradient all-reduce set per update: as many bucket
                # all-reduces as (d)'s 30 updates of one microbatch.
                "b_books": _per_update_ok(ran_aw, n_up, len(aw.test_pipe),
                                          accum=2)
                and _per_update_ok(ran_ae, n_up, len(ae.test_pipe), accum=2)
                and ran_aw["ddp_buckets"] == ran_ae["ddp_buckets"]
                == ran_de["ddp_buckets"]
                and aw.multi_step.captured["ddp_buckets"] == buckets * k,
            })
            _, apool = _first_window(aw.train_pipe, k)
            abatch = next(iter(ae.train_pipe))
            rec["b"] = {"losses": aw.step_losses, "ran_windowed": ran_aw,
                        "ran_eager": ran_ae, "eval": res_aw["eval"],
                        "eager_ms_per_update": cuda_median_ms(
                            lambda: ae.train_step(ae.state, abatch),
                            reps=ACCUM_REPS[0]),
                        "windowed_ms_per_update": cuda_median_ms(
                            lambda: aw.multi_step(aw.state, apool),
                            reps=ACCUM_REPS[1]) / k}
            print("[windows] (b) " + json.dumps(
                {n: rec["b"][n] for n in ("eager_ms_per_update",
                                          "windowed_ms_per_update")}))
            for t in (aw, ae):
                if t.multi_step is not None:
                    t.multi_step.close()
            del aw, ae, apool, abatch
        # (e) phase 8's interrupted and resumed run, windows of 5.
        ck_args = CKPT_ARGS + ["--train.steps_per_call=5"]
        runs = {}
        for name in ("full", "part", "resumed"):
            extra = ["--resume"] if name == "resumed" else []
            where = os.path.join(tmp.name, "e_full" if name == "full"
                                 else "e_part")
            t = Trainer(parse_cli(ck_args + extra + [
                f"--train.ckpt_dir={where}"]), device="cuda")
            if name == "part":
                real = t.train_epoch

                def train_epoch(epoch, start_step=0, _real=real):
                    if epoch == CKPT_EPOCHS - 1:
                        raise _Stop
                    return _real(epoch, start_step)

                t.train_epoch = train_epoch
            try:
                res, ran = _fit_books(t)
            except _Stop:
                t.ckpt_mgr.wait()
                res, ran = None, None
            runs[name] = (t, res, ran)
        full, part, resumed = (runs[n][0] for n in ("full", "part",
                                                    "resumed"))
        stop = (CKPT_EPOCHS - 1) * CKPT_SPE
        checks.update({
            "e_resumed_at_epoch_3": (resumed.start_epoch,
                                     resumed.start_step) == (2, 0),
            "e_epoch_3_losses_bit_identical":
                resumed.step_losses == full.step_losses[stop:],
            "e_final_state_bit_identical": _same_state(
                _flat_state(resumed), _flat_state(full)),
            "e_eval_identical": runs["resumed"][1]["eval"]
            == runs["full"][1]["eval"],
            "e_windowed": full.multi_step.graph is not None
            and resumed.multi_step.graph is not None,
            "e_books": _per_update_ok(runs["full"][2], CKPT_EPOCHS * CKPT_SPE,
                                      len(full.test_pipe))
            and _per_update_ok(runs["resumed"][2], CKPT_SPE,
                               len(resumed.test_pipe)),
        })
        rec["e"] = {"losses_full": full.step_losses,
                    "losses_resumed": resumed.step_losses,
                    "ran_full": runs["full"][2],
                    "ran_resumed": runs["resumed"][2]}
        del runs, full, part, resumed
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["windows"] = rec
    _print_windows("windows", out["card"], k, rec["a"],
                   f"; DDP added {rec['d']['ddp_added_ms_eager']:.3f} ms "
                   f"eager, {rec['d']['ddp_added_ms_windowed']:.3f} ms "
                   "windowed")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"windows checks failed: {failed}")


def _r50_args(tmp, updates=R50_STEPS, k=1, extra=()):
    """The ResNet-50 preset with the slice's kernel knobs on synthetic
    CIFAR-100 (a data root without files), B=128, ``updates`` steps in one
    epoch, windows of ``k``."""
    return ["--preset=resnet50_cifar100", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            f"--data.root={os.path.join(tmp, 'no_cifar_files')}",
            f"--data.batch_size={TRAIN_B}",
            f"--data.synthetic_train_size={updates * TRAIN_B}",
            f"--data.synthetic_test_size={2 * TRAIN_B}",
            "--train.epochs=1", "--train.log_every=10",
            f"--train.steps_per_call={k}", "--data.device_resident=off",
            *extra]


def _bottleneck_input(gen, b, h, c):
    """What a ResNet-50 bottleneck hands the kernel: the f32 output of a
    cuDNN 1x1 conv (4c -> c channels) of a post-ReLU activation, NHWC."""
    import torch
    import torch.nn.functional as F

    a = torch.relu(torch.randn(b, 4 * c, h, h, generator=gen,
                               device="cuda")).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(c, 4 * c, 1, 1, generator=gen, device="cuda") * (
        math.sqrt(2.0 / c))
    return F.conv2d(a, w).permute(0, 2, 3, 1).contiguous()


def phase_resnet50_kernels(out):
    """10a: the kernels at ResNet-50's call pattern, B=128: the conv
    kernel at the four bottleneck shapes with f32 x from a 1x1 conv, no
    residual, no emit_z: the eval variant (y within one ulp) and
    ``emit_stats`` (y within one ulp, stats bit-exact with
    `ordered_stats_sum`, bit-identical across launches, graph replays and
    a busy side stream), the input-grad (one ulp); each timed by CUDA
    events through its C entry beside its bound, its plain version and
    cuDNN bf16 (``conv2d`` / ``conv2d_input``). Then the xent mean pair at
    [128, 100], the multi-block route: within 1e-6 of the plain versions,
    bit-identical across 100 launches and 3 graph replays, device time
    beside ``F.cross_entropy``'s and the launch floor."""
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(10)
    big = torch.randn(8192, 8192, generator=gen, device="cuda").to(
        torch.bfloat16)
    side = torch.cuda.Stream()
    cases, ok = [], True
    for stage, (h, c) in enumerate(STAGES):
        n = TRAIN_B * h * h * c
        flops = 2.0 * TRAIN_B * h * h * 9 * c * c
        x = _bottleneck_input(gen, TRAIN_B, h, c)
        _, w, scale, shift, _ = _case_inputs(gen, 1, h, c, torch.float32,
                                             False)
        wk = cb.pack_weight(w)
        z = cb._reference_z(x, scale, shift).to(torch.bfloat16)
        zl = z.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        library = cuda_loop_ms(lambda: F.conv2d(zl, wl, padding=1))
        # Eval (serve and eval forwards).
        y = cb.fused_affine_relu_conv(x, wk, scale, shift)
        ref = cb.reference_affine_relu_conv(x, w, scale, shift)
        torch.cuda.synchronize()
        launch, _ = _direct_conv(cb, x, wk, scale, shift, None, False, False)
        nbytes = n * 4 * 2 + wk.numel() * 2 + 2 * c * 4
        rec = {"kind": "r50_eval", "stage": stage,
               "shape": [TRAIN_B, h, h, c], "x_dtype": "float32",
               "max_abs_err": (y - ref).abs().max().item(),
               "tol": bf16_ulp(ref.abs().max().item()),
               "tile": cb.tile_of(TRAIN_B, h, h, c),
               "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(x, w, scale, shift),
                   reps=10),
               "library_ms": library, "bytes": nbytes, "flops": flops}
        rec["ok"] = (bool(torch.isfinite(y).all())
                     and rec["max_abs_err"] <= rec["tol"])
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        cases.append(with_ratios(rec))
        # emit_stats (train forwards).
        got = cb.fused_conv_bn(x, wk, scale, shift)
        again = cb.fused_conv_bn(x, wk, scale, shift)
        ref = cb.reference_affine_relu_conv(x, w, scale, shift,
                                            emit_stats=True)
        torch.cuda.synchronize()
        y, st = got
        yabs = torch.stack([y.abs().sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
        launch, _ = _direct_conv(cb, x, wk, scale, shift, None, False, True)
        nbytes += 2 * c * 4
        rec = {"kind": "r50_emit_stats", "stage": stage,
               "shape": [TRAIN_B, h, h, c], "x_dtype": "float32",
               "max_abs_err": (y - ref[0]).abs().max().item(),
               "tol": bf16_ulp(ref[0].abs().max().item()),
               "stats_rel_err": ((st - cb._stats_of(y)).abs()
                                 / yabs).max().item(),
               "stats_bit_identical": bool(torch.equal(st, again[-1])),
               "y_bit_identical": bool(torch.equal(y, again[0])),
               "tile": cb.tile_of(TRAIN_B, h, h, c),
               "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       x, w, scale, shift, emit_stats=True), reps=10),
               "library_ms": library, "bytes": nbytes, "flops": flops}
        rec.update(_fold_checks(cb, x, wk, scale, shift, None, False, st,
                                big, side))
        rec["ok"] = (rec["max_abs_err"] <= rec["tol"]
                     and rec["stats_rel_err"] <= 1e-5
                     and rec["stats_bit_identical"]
                     and rec["y_bit_identical"] and rec["fold_ok"])
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        cases.append(with_ratios(rec))
        # The input-grad (the backward of every train step).
        ct = torch.randn(TRAIN_B, h, h, c, generator=gen,
                         device="cuda").to(torch.bfloat16)
        wf = cb.flip_packed(w)
        one = torch.ones(c, device="cuda")
        zero = torch.zeros(c, device="cuda")
        dz = cb._run(ct, wf, one, zero, None, False, False,
                     role="input_grad")
        ref = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                            activate=False)
        torch.cuda.synchronize()
        launch, _ = _direct_conv(cb, ct, wf, one, zero, None, False, False,
                                 act=False)
        ctl = ct.permute(0, 3, 1, 2)
        wl2 = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        nbytes = n * 2 * 2 + wf.numel() * 2
        rec = {"kind": "r50_input_grad", "stage": stage,
               "shape": [TRAIN_B, h, h, c],
               "max_abs_err": (dz.float() - ref.float()).abs().max().item(),
               "tol": bf16_ulp(ref.float().abs().max().item()),
               "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       ct, wf, one, zero, activate=False), reps=10),
               "library_ms": cuda_loop_ms(
                   lambda: torch.nn.grad.conv2d_input(
                       ctl.shape, wl2, ctl, padding=1)),
               "bytes": nbytes, "flops": flops}
        rec["ok"] = rec["max_abs_err"] <= rec["tol"]
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        cases.append(with_ratios(rec))
        for r in cases[-3:]:
            ok &= r["ok"]
            print("[resnet50-kernel] " + json.dumps(r))
    del big, side
    # The xent mean pair at [128, 100]: the multi-block route.
    b, c = TRAIN_B, R50_CLASSES
    lg = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
    lb = torch.randint(0, c, (b,), generator=gen, device="cuda")
    ct = torch.tensor(1.3, device="cuda")
    x = _xent_mean_parity(lg, lb, ct)
    lref = lg.clone().requires_grad_()
    floor = _launch_floor(b)
    nbytes = b * c * 4 + b * 8 + 4
    x.update({
        "route": "one_cta" if tx._one_cta(b, c) else "multi_block",
        "fwd_ms": device_ms(lambda: tx._fwd(lg, lb, True)),
        "bwd_ms": device_ms(lambda: tx._bwd(lg, lb, ct, True)),
        "fwd_plain_ms": device_ms(lambda: tx._plain_fwd(lg, lb).mean()),
        "bwd_plain_ms": device_ms(lambda: tx._plain_bwd(
            lg, lb, (ct / b).expand(b))),
        "fwd_library_ms": device_ms(lambda: F.cross_entropy(lg, lb)),
        "bwd_library_ms": device_ms(lambda: torch.autograd.grad(
            F.cross_entropy(lref, lb), lref, ct)),
        "floor_ms": device_ms(floor), "fwd_bytes": nbytes,
        "bwd_bytes": nbytes + b * c * 4})
    # ~10 operations per element (exp, max, add, divide), f32.
    for d in ("fwd", "bwd"):
        x[f"{d}_bound_ms"], x[f"{d}_bound_by"] = bound(
            x[f"{d}_bytes"], 10.0 * b * c, PEAK_F32_FLOPS)
    x["ok"] = (x["route"] == "multi_block" and x["fwd_rel_err"] <= 1e-6
               and x["bwd_rel_err"] <= 1e-6
               and x["fwd_bit_identical_100_launches"]
               and x["bwd_bit_identical_100_launches"]
               and all(x["graph_replays_bit_identical"]))
    ok &= x["ok"]
    print("[resnet50-kernel] xent " + json.dumps(x))
    out["resnet50_kernels"] = {"conv": cases, "xent": x,
                               "card": out["card"]}
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "ResNet-50's call pattern")
    print(f"[resnet50-kernel] {out['card']}: all {len(cases)} conv cases "
          f"within one bf16 ulp, stats bit-exact with ordered_stats_sum; "
          f"xent [128, 100] ({x['route']}) forward {1e3 * x['fwd_ms']:.2f} "
          f"us, backward {1e3 * x['bwd_ms']:.2f} us, floor "
          f"{1e3 * x['floor_ms']:.2f} us")


def phase_resnet50(out):
    """10b: ResNet-50 on synthetic CIFAR-100 (``--preset=resnet50_cifar100
    --model.fused_stages=all --model.fused_bwd=true
    --train.pallas_xent=true``, f32, B=128): `Trainer` for 30 steps and
    one eval (finite losses; 13 + 13 conv and 1 + 1 xent launches a step
    by the wrappers' counters and by kernel name under the profiler, 13
    per eval forward; the first 5 losses, and all 30, within 0.05 of the
    same init and batches run unfused without kernels; the eval
    count the test set; step ms, images/s, device busy share, ops, top
    kernels, peak memory); its epoch save served by
    `InferenceEngine.from_checkpoint` (buckets 1..32, 50 Poisson requests:
    audited books, 13 conv launches a forward, bucket-32 logits
    bit-identical to the trained model's eval forward, cuDNN
    deterministic); the same 30 steps with augmentation off, whose loss
    falls (with the preset's augmentation the synthetic set's loss rises
    over the 30 warm-up steps, fused and unfused alike); and the
    random-weight ResNet-50 behind the engine (phase 5's traffic and
    checks, 13 launches a forward)."""
    import numpy as np
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.serve import InferenceEngine, run_load
    from tpu_dp_torch.train.step import _maybe_normalize
    from tpu_dp_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_r50_")
    try:
        ckpt = os.path.join(tmp.name, "train")
        args = _r50_args(tmp.name, extra=[f"--train.ckpt_dir={ckpt}"])
        trainer = Trainer(parse_cli(args), device="cuda")
        steps, evals = len(trainer.train_pipe), len(trainer.test_pipe)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cb.reset_launches()
        tx.reset_launches()
        result = trainer.fit()
        torch.cuda.synchronize()
        trainer.ckpt_mgr.wait()
        counts = {"conv": dict(cb.launches_by_role),
                  "conv_total": cb.launches, "xent": dict(tx.launches)}
        peak = torch.cuda.max_memory_allocated()
        losses = trainer.step_losses
        ev = result["eval"]
        checks = {
            "synthetic_cifar100": trainer.train_ds.synthetic
            and trainer.train_ds.num_classes == R50_CLASSES
            and trainer.model.num_classes == R50_CLASSES,
            "xent_multi_block_route": not tx._one_cta(TRAIN_B, R50_CLASSES),
            "steps": steps == R50_STEPS and len(losses) == steps,
            "losses_finite": all(math.isfinite(v) for v in losses),
            "conv_stats_13_per_step": counts["conv"]["stats"] == 13 * steps,
            "conv_input_grad_13_per_step":
                counts["conv"]["input_grad"] == 13 * steps,
            "conv_eval_13_per_eval_forward":
                counts["conv"]["eval"] == 13 * evals,
            "xent_1_and_1_per_step":
                counts["xent"] == {"forward": steps, "backward": steps},
            "eval_count_is_test_set": ev["count"] == len(trainer.test_ds),
        }
        # The epoch save, served, before the trained model takes another
        # step (cuDNN deterministic: the same algorithms for the served
        # and the trained forward).
        det = (torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            engine = InferenceEngine.from_checkpoint(
                ckpt, device="cuda", buckets=(1, 2, 4, 8, 16, 32),
                slo_ms=250.0)
            cb.reset_launches()
            engine.start()
            try:
                report = run_load(engine, n_requests=CKPT_SERVE_REQUESTS,
                                  pattern="poisson", rate_rps=400.0,
                                  sizes=(1, 2, 3, 4), seed=3)
            finally:
                engine.stop()
            served_launches = cb.launches
            books = _serve_graph_books([engine.replica], 13,
                                       served_launches, report["batches"])
            forwards = books["forwards_ran"]
            imgs = torch.from_numpy(np.random.default_rng(4).integers(
                0, 256, (32, 32, 32, 3), dtype=np.uint8)).cuda()
            trainer.model.eval()
            with torch.inference_mode():
                x = _maybe_normalize(imgs)
                served = engine.model(x)
                trained = trainer.model(x)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = det
        truth, dev = report["ground_truth"], report["device_stats"]
        checks.update({
            "serve_ckpt_resnet50_100_classes":
                engine.num_classes == R50_CLASSES
                and type(engine.model.BottleneckBlock_0).__name__
                == "BottleneckBlock",
            "serve_ckpt_consistent": report["consistent"],
            "serve_ckpt_served_eq_images":
                dev["served"] == truth["images_served"],
            "serve_ckpt_13_launches_per_captured_forward_x_replays":
                books["ok"],
            "serve_ckpt_no_retraces": report["retraces"] == 0,
            "serve_ckpt_b32_logits_bit_identical_to_trained":
                torch.equal(served, trained),
        })
        serve_ckpt = {"batches": report["batches"], "forwards": forwards,
                      "conv_launches": served_launches,
                      "launches_ran": books["ran"],
                      "p50_ms": (report["latency_ms"] or {}).get("p50_ms"),
                      "images_served": truth["images_served"],
                      "b32_max_abs_diff":
                          (served - trained).abs().max().item()}
        del engine
        # The same init, batches, augmentation and schedule, unfused and
        # without kernels (cuDNN convs, cross_entropy_loss, TF32 off).
        ref = Trainer(parse_cli(args + [
            "--model.fused_stages=", "--model.fused_bwd=false",
            "--train.pallas_xent=false"]), device="cuda")
        before = (cb.launches, dict(tx.launches))
        ref.train_pipe.set_epoch(0)
        ref_losses = torch.stack([ref.train_step(ref.state, batch)["loss"]
                                  for batch in ref.train_pipe]).tolist()
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
        checks["first5_track_unfused"] = max(diffs[:5]) <= DDP_LOSS_TOL
        # All 30: the warm-up lr moves little in 5 steps, and a run that
        # stopped updating would stay near its first losses while the
        # unfused run's climb by about 0.4 under the preset's augmentation.
        checks["all_steps_track_unfused"] = max(diffs) <= DDP_LOSS_TOL
        checks["reference_runs_no_kernel"] = before == (cb.launches,
                                                        dict(tx.launches))
        # Augmentation off: the loss falls within the 30 steps.
        noaug = Trainer(parse_cli(_r50_args(tmp.name, extra=[
            "--data.augment=false",
            f"--train.ckpt_dir={os.path.join(tmp.name, 'noaug')}"])),
            device="cuda")
        noaug_result = noaug.fit()
        nl = noaug.step_losses
        checks["augment_off_losses_finite_and_fall"] = (
            len(nl) == R50_STEPS and all(math.isfinite(v) for v in nl)
            and statistics.mean(nl[-5:]) < statistics.mean(nl[:5]))
        batch = next(iter(trainer.train_pipe))
        trainer.model.train()
        step = lambda: trainer.train_step(trainer.state, batch)  # noqa: E731
        step_ms = cuda_median_ms(step, reps=20)
        ref_step_ms = cuda_median_ms(lambda: ref.train_step(ref.state,
                                                            batch), reps=10)
        ok, sessions = _profiled_books(
            step, {"conv_block_kernel": 26, "xent_fwd": 1, "xent_bwd": 1})
        checks["profiled_26_conv_1_1_xent_per_step"] = ok
        prof = profile_forward(step, 5, cuda_only=True)
        checks["no_stats_reduce_kernel"] = not any(
            "stats_reduce" in n for n in prof["kernel_names"])
        rec = {
            "steps": steps, "eval_forwards": evals, "launches": counts,
            "losses": losses, "unfused_losses": ref_losses,
            "first5_max_abs_diff": max(diffs[:5]),
            "all_steps_max_abs_diff": max(diffs), "eval": ev,
            "augment_off_losses": nl,
            "augment_off_eval": noaug_result["eval"],
            "fit_wall_s": result["wall_time_s"],
            "fit_images_per_s_meter": result["images_per_sec"],
            "step_ms": step_ms, "images_per_s": TRAIN_B / (step_ms / 1e3),
            "unfused_step_ms": ref_step_ms,
            "device_busy_share": prof["device_busy_share"],
            "device_busy_us_per_step": prof["device_busy_us_per_call"],
            "device_ops_per_step": prof["kernel_launches_per_call"],
            "top_kernels": prof["top"], "profiled_sessions": sessions,
            "peak_memory_bytes": peak, "held_before_fit_bytes": held,
            "serve_ckpt": serve_ckpt, "card": out["card"]}
        print(f"[resnet50] {out['card']}: {steps} steps, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (unfused within "
              f"{max(diffs[:5]):.4f} over 5 steps, {max(diffs):.4f} over "
              f"{steps}; augmentation off {nl[0]:.4f} -> {nl[-1]:.4f}), "
              f"eval {ev['count']} images accuracy {ev['accuracy']:.4f}; "
              f"step {step_ms:.3f} ms = {rec['images_per_s']:.0f} images/s "
              f"(fit's meter {result['images_per_sec']:.1f}; unfused, no "
              f"kernels: {ref_step_ms:.3f} ms); device busy "
              f"{100 * prof['device_busy_share']:.1f}%, "
              f"{prof['kernel_launches_per_call']:.0f} device ops a step; "
              f"peak memory {peak / 2**20:.1f} MiB")
        del trainer, ref, noaug
    finally:
        tmp.cleanup()
    # The random-weight ResNet-50 behind the engine (phase 5's traffic).
    rec["serve"] = _serve_run("resnet50", R50_CLASSES, 13, out["card"])
    _print_serve("resnet50-serve", rec["serve"])
    checks.update({f"serve_{k}": v for k, v in rec["serve"]["checks"].items()})
    rec["checks"] = checks
    out["resnet50"] = rec
    print("[resnet50] " + json.dumps(rec, default=str))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resnet50 checks failed: {failed}")


def phase_resnet50_windows(out):
    """10c: ResNet-50 windows, phase 9's (a) and (c) (`_windows_vs_eager`)
    with augmentation off, under cuDNN deterministic: 40 eager updates
    against ``--train.steps_per_call=10`` (the xent mean at [128, 100] on
    its multi-block route, ticket counters and all, inside the graph),
    13 + 13 conv launches an update; and ``--train.steps_per_call=0``
    (auto: windows of 24) over 48 updates, which must fit."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    k, updates = R50_K, R50_WIN_UPDATES
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_r50_win_")
    noaug = ["--data.augment=false"]
    try:
        checks, rec = _windows_vs_eager(
            out, lambda n, kk: _r50_args(tmp.name, n, kk, noaug), k,
            updates, 13, tmp.name, turns=R50_WINDOW_TURNS)
        rec.update({"card": out["card"], "k": k})
        # Auto windows: min(24, steps per epoch) = 24 over 48 updates.
        torch.cuda.reset_peak_memory_stats()
        auto = Trainer(parse_cli(_r50_args(tmp.name, 48, 0, noaug) + [
            f"--train.ckpt_dir={os.path.join(tmp.name, 'auto')}"]),
            device="cuda")
        res_a, ran_a = _fit_books(auto)
        am = auto.multi_step
        checks.update({
            "auto_windows_of_24": auto.steps_per_call == 24
            and am.graph is not None and am.replays == 1,
            "auto_books": _per_update_ok(ran_a, 48, len(auto.test_pipe),
                                         convs=13),
            "auto_losses_finite": all(math.isfinite(v)
                                      for v in auto.step_losses),
        })
        rec["auto"] = {"k": auto.steps_per_call,
                       "capture_ms": am.capture_ms,
                       "capture_bytes": am.capture_bytes,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                       "eval": res_a["eval"]}
        am.close()
        del auto, am
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["resnet50_windows"] = rec
    print("[resnet50-windows] " + json.dumps(rec, default=str))
    _print_windows("resnet50-windows", out["card"], k, rec,
                   f"; windows of 24: capture "
                   f"{rec['auto']['capture_bytes'] / 2**20:.1f} MiB, peak "
                   f"{rec['auto']['peak_memory_bytes'] / 2**20:.1f} MiB")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resnet50 windows checks failed: {failed}")


def phase_resnet50_ddp(out):
    """10d: ResNet-50 data-parallel in phase 7b's form
    (`_world1_vs_one_process`): 5 steps with augmentation off, 13 + 13
    conv launches an update."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_r50_ddp_")
    try:
        _world1_vs_one_process(
            out, "resnet50_ddp",
            _r50_args(tmp.name, DDP_STEPS, extra=["--data.augment=false"]),
            DDP_STEPS, convs=13)
    finally:
        tmp.cleanup()


def _exchange_books(opt, updates: int) -> dict[str, int]:
    """The sharded update's collectives for ``updates`` updates of the
    optimizer ``opt``'s exchange plan: a reduce-scatter per f32/bf16
    exchange, two all-to-alls (payload, scales) per int8 one, one
    all-gather of the parameters."""
    q = sum(ex.quantizes for ex in opt.exchanges)
    return {"reduce_scatter": (len(opt.exchanges) - q) * updates,
            "all_to_all": 2 * q * updates, "all_gather": updates}


def _sharded_args(wire: str, bucket_mb: float) -> list[str]:
    return (["--train.update_sharding=sharded"]
            + ([f"--train.collective_dtype={wire}"] if wire else [])
            + ([f"--train.bucket_mb={bucket_mb:g}"] if bucket_mb else []))


def _wire_name(wire: str, bucket_mb: float) -> str:
    return (wire or "f32") + (f"@{bucket_mb:g}MB" if bucket_mb else "")


def _same_values(a: dict, b: dict) -> bool:
    """`_same_state` up to the momentum's layout (a replicated save keeps
    each leaf's shape, a sharded one at world 1 the same values flat)."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].size == b[k].size
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _sharded_fit(args, where, snapshot_at=6):
    """A `Trainer` on ``args`` run to the end with its books
    (`_fit_books`); its parameters just before update ``snapshot_at``,
    its state at the fit's end (before the by-name sessions, whose count
    of updates varies), one update's books by kernel name and step ms
    after."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    began = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = Trainer(parse_cli(args + [f"--train.ckpt_dir={where}"]))
    snap = {}
    real = t.train_step

    def step(state, batch):
        if state.step == snapshot_at:
            snap.update({k: p.detach().clone() for k, p in
                         t.model.named_parameters()})
        return real(state, batch)

    t.train_step = step
    res, ran = _fit_books(t)
    fit_s = time.perf_counter() - began
    fit_state = _flat_state(t)
    # What this run added at its peak (earlier runs' trainers stay).
    peak = torch.cuda.max_memory_allocated() - before
    batch = next(iter(t.train_pipe))
    began = time.perf_counter()
    ok, sessions = _profiled_books(
        lambda: real(t.state, batch),
        {"conv_block_kernel": 20, "xent_fwd": 1, "xent_bwd": 1})
    profiled_s = time.perf_counter() - began
    rec = {"t": t, "res": res, "ran": ran, "params6": snap,
           "fit_state": fit_state, "profiled_ok": ok,
           "profiled": sessions[-1], "peak_memory_bytes": peak,
           "step_ms": cuda_median_ms(lambda: real(t.state, batch), reps=10),
           "seconds": {"fit": fit_s, "profiled": profiled_s,
                       "sessions": len(sessions)}}
    return rec


def phase_sharded(out):
    """11: the sharded weight update on the card (see the module
    docstring): (a) each wire's 30 updates against the replicated run,
    books and memory, (b) windows of 10 under each wire beside the
    replicated windows, (c) an int8 resume, (d) ResNet-50 int8."""
    import torch

    from tpu_dp_torch.compat import leaf_sizes
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.parallel import collectives, quant
    from tpu_dp_torch.train.trainer import Trainer

    k, updates = 10, 40
    checks, rec = {}, {"card": out["card"], "k": k}
    # Seconds of each part, for the call's time budget.
    stage_s, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stage_s[name], last[0] = now - last[0], now

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_")
    try:
        # (b, replicated) windows without a group: phase 9a's run, reused
        # when phase 9 ran in this call.
        if "a" in out.get("windows", {}):
            rec["windows_replicated"] = out["windows"]["a"]
        else:
            _, rec["windows_replicated"] = _windows_vs_eager(
                out, lambda n, kk: _win_args(n, k=kk), k, updates, 10,
                os.path.join(tmp.name, "wr"))
        with _nccl_world1_env(TORCH_NCCL_ASYNC_ERROR_HANDLING="0"):
            # (a) 30 updates per wire against the replicated (DDP) run.
            runs = {"replicated": _sharded_fit(
                TRAIN_ARGS, os.path.join(tmp.name, "a_rep"))}
            for wire, mb in SHARDED_WIRES:
                runs[(wire, mb)] = _sharded_fit(
                    TRAIN_ARGS + _sharded_args(wire, mb),
                    os.path.join(tmp.name, f"a_{wire}_{mb:g}"))
            rep = runs["replicated"]
            f32 = {mb: runs[("", mb)] for mb in (0.0, 25.0)}
            a = {}
            for (wire, mb), r in ((key, v) for key, v in runs.items()
                                  if key != "replicated"):
                t, name = r["t"], _wire_name(wire, mb)
                losses = t.step_losses
                opt = t.optimizer
                hist = r["res"]["history"][-1]
                c = {"nccl_world_1": (t.ctx.backend, t.ctx.world) == (
                        "nccl", 1) and opt.group is not None,
                     "losses_finite_and_fall": all(
                         math.isfinite(v) for v in losses)
                     and statistics.mean(losses[-5:])
                     < statistics.mean(losses[:5]),
                     "books": _per_update_ok(r["ran"], TRAIN_STEPS,
                                             len(t.test_pipe))
                     and all(r["ran"][n] == v for n, v in _exchange_books(
                         opt, TRAIN_STEPS).items())
                     and r["ran"]["ddp_buckets"] == r["ran"]["psum"] == 0,
                     "profiled_books": r["profiled_ok"]}
                if not wire:
                    c["bit_identical_to_replicated"] = (
                        losses == rep["t"].step_losses
                        and _same_values(r["fit_state"], rep["fit_state"]))
                else:
                    ref = f32[mb]["params6"]
                    diff = max(float((r["params6"][n] - ref[n]).abs().max())
                               for n in ref)
                    c["within_wire_contract_after_6"] = diff <= WIRE_TOL[wire]
                    c["not_f32"] = diff > 0
                    if wire == "int8":
                        c["quant_overflow_0"] = hist["quant_overflow"] == 0
                mom = (opt.momentum_shard.numel()
                       * opt.momentum_shard.element_size())
                res_bytes = sum(v.numel() * v.element_size()
                                for v in opt.residual_rows.values())
                a[name] = {
                    "losses": losses, "eval": r["res"]["eval"],
                    "ran": r["ran"], "exchanges": len(opt.exchanges),
                    "quant": {n: hist.get(n) for n in ("quant_overflow",
                                                       "quant_clip")},
                    "max_abs_diff_after_6": None if not wire else diff,
                    "step_ms": r["step_ms"],
                    "profiled_per_update": r["profiled"],
                    "momentum_bytes_per_rank": mom,
                    "residual_bytes_per_rank": res_bytes,
                    "peak_memory_bytes": r["peak_memory_bytes"],
                    "seconds": r["seconds"], "checks": c}
                checks.update({f"a_{name}_{n}": v for n, v in c.items()})
            leaves = leaf_sizes(rep["t"].model.named_parameters())
            rec["a"] = {
                "replicated": {"losses": rep["t"].step_losses,
                               "step_ms": rep["step_ms"],
                               "profiled_per_update": rep["profiled"],
                               "momentum_bytes_per_rank": 4 * sum(
                                   n for _, n in leaves),
                               "peak_memory_bytes": rep["peak_memory_bytes"]},
                **a,
                # Counted from the layout (not measured): what a rank of a
                # larger group holds.
                "momentum_bytes_per_rank_by_world": {
                    w: 4 * sum(collectives.shard_size(n, w)
                               for _, n in leaves) for w in (1, 2, 4, 8)},
                "int8_residual_bytes_per_rank_by_world": {
                    w: 4 * sum(v.shape[1] for v in quant.init_residuals(
                        leaves, w).values()) for w in (1, 2, 4, 8)},
                "wire_report_world_4": quant.wire_report(leaves, 4)}
            print("[sharded] (a) " + json.dumps(
                {n: {m: v[m] for m in ("step_ms", "max_abs_diff_after_6",
                                       "quant", "exchanges",
                                       "momentum_bytes_per_rank",
                                       "residual_bytes_per_rank",
                                       "peak_memory_bytes")}
                 for n, v in a.items()}))
            del rep, f32
            lap("a")
            # (b) windows of 10 against eager, per wire: (a)'s 30 eager
            # updates are the eager half (the same arguments).
            rec["b"] = {}
            for wire, mb in (("", 0.0), ("bf16", 0.0), ("int8", 0.0),
                             ("int8", 25.0)):
                name = _wire_name(wire, mb)
                extra = _sharded_args(wire, mb)
                r = runs.pop((wire, mb))
                w_checks, w_rec = _windows_vs_eager(
                    out, lambda n, kk, e=extra: _win_args(n, k=kk, extra=e),
                    k, TRAIN_STEPS, 10, os.path.join(tmp.name, f"b_{name}"),
                    eager=(r["t"], r["res"], r["ran"], r["fit_state"]),
                    turns=SHARDED_B_TURNS, eager_timing={
                        "step_ms": r["step_ms"], "profile": {
                            "device_busy_share":
                                r["profiled"]["device_busy_share"],
                            "kernel_launches_per_call":
                                r["profiled"]["device_ops_per_call"],
                            "device_busy_us_per_call":
                                r["profiled"]["device_busy_us_per_call"]}})
                del r
                checks.update({f"b_{name}_{n}": v
                               for n, v in w_checks.items()})
                rec["b"][name] = {n: v for n, v in w_rec.items()
                                  if n not in ("ran_eager",)}
                print(f"[sharded] (b) {name}: " + json.dumps(
                    {n: w_rec[n] for n in ("eager_step_ms",
                                           "windowed_ms_per_update",
                                           "images_per_s_meter",
                                           "capture_bytes", "seconds")}))
            del runs
            lap("b")
            # (c) phase 8's interrupted and resumed run under int8 at 25 MB.
            ck_args = CKPT_ARGS + _sharded_args("int8", 25.0)
            cruns = {}
            for name in ("full", "part", "resumed"):
                extra = ["--resume"] if name == "resumed" else []
                where = os.path.join(tmp.name, "c_full" if name == "full"
                                     else "c_part")
                t = Trainer(parse_cli(ck_args + extra + [
                    f"--train.ckpt_dir={where}"]))
                if name == "part":
                    real = t.train_epoch

                    def train_epoch(epoch, start_step=0, _real=real):
                        if epoch == CKPT_EPOCHS - 1:
                            raise _Stop
                        return _real(epoch, start_step)

                    t.train_epoch = train_epoch
                try:
                    res, ran = _fit_books(t)
                except _Stop:
                    t.ckpt_mgr.wait()
                    res, ran = None, None
                cruns[name] = (t, res, ran)
            full, resumed = cruns["full"][0], cruns["resumed"][0]
            stop = (CKPT_EPOCHS - 1) * CKPT_SPE
            fstate = _flat_state(full)
            checks.update({
                "c_resumed_at_epoch_3": (resumed.start_epoch,
                                         resumed.start_step) == (2, 0),
                "c_epoch_3_losses_bit_identical":
                    resumed.step_losses == full.step_losses[stop:],
                "c_final_state_bit_identical": _same_state(
                    _flat_state(resumed), fstate),
                "c_residuals_saved": any(n.startswith("residuals/")
                                         for n in fstate),
                "c_eval_identical": cruns["resumed"][1]["eval"]
                == cruns["full"][1]["eval"],
            })
            rec["c"] = {"losses_full": full.step_losses,
                        "losses_resumed": resumed.step_losses}
            del cruns, full, resumed
            lap("c")
            # (d) ResNet-50, int8 at 25 MB, 10 updates.
            r50 = Trainer(parse_cli(_r50_args(
                tmp.name, 10, extra=["--data.augment=false"]
                + _sharded_args("int8", 25.0)
                + [f"--train.ckpt_dir={os.path.join(tmp.name, 'd')}"])))
            res50, ran50 = _fit_books(r50)
            checks.update({
                "d_r50_losses_finite": len(r50.step_losses) == 10 and all(
                    math.isfinite(v) for v in r50.step_losses),
                "d_r50_books": _per_update_ok(ran50, 10, len(r50.test_pipe),
                                              convs=13)
                and all(ran50[n] == v for n, v in _exchange_books(
                    r50.optimizer, 10).items()),
                "d_r50_exchanges_4_buckets": len(r50.optimizer.exchanges)
                == 4})
            rec["d"] = {"losses": r50.step_losses, "ran": ran50,
                        "exchanges": [ex.quantizes for ex in
                                      r50.optimizer.exchanges],
                        "quant": {n: res50["history"][-1].get(n) for n in
                                  ("quant_overflow", "quant_clip")}}
            del r50
            lap("d")
            rec["seconds"] = stage_s
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["sharded"] = rec
    b = rec["b"]
    print(f"[sharded] seconds {json.dumps(rec['seconds'])}; per fit "
          + json.dumps({n: v["seconds"] for n, v in rec["a"].items()
                        if isinstance(v, dict) and "seconds" in v}))
    print(f"[sharded] {out['card']}: eager step / windowed ms per update: "
          f"replicated {rec['windows_replicated']['eager_step_ms']:.3f} / "
          f"{rec['windows_replicated']['windowed_ms_per_update']:.3f}; "
          + "; ".join(f"{n} {v['eager_step_ms']:.3f} / "
                      f"{v['windowed_ms_per_update']:.3f}"
                      for n, v in b.items()))
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"sharded checks failed: {failed}")


@contextlib.contextmanager
def _shared_datasets():
    """Each synthetic set made once for the `Trainer`s built inside the
    block: a 50,000-image set takes seconds of host work per build, and
    the trainers only read it."""
    from tpu_dp_torch.train import trainer as trainer_mod

    real, made = trainer_mod.load_dataset, {}

    def load(*args, **kwargs):
        key = json.dumps([args, sorted(kwargs.items())], default=str)
        if key not in made:
            made[key] = real(*args, **kwargs)
        return made[key]

    trainer_mod.load_dataset = load
    try:
        yield
    finally:
        trainer_mod.load_dataset = real


def _res_args(feed, k, extra=()):
    return RES_ARGS + [f"--data.device_resident={feed}",
                       f"--train.steps_per_call={k}", *extra]


def _feed_run(args, where, updates=None):
    """A `Trainer` on ``args`` (saves under ``where``) fit once with its
    books (`_fit_books`), its losses, the device memory its fit added at
    its peak, and its staging: the first touch of `resident_train`,
    synchronized. ``updates``: a one-update-a-call run stops before update
    ``updates`` + 1 (no eval; ``res`` None)."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    t = Trainer(parse_cli(args + [f"--train.ckpt_dir={where}"]))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = t.resident_train
    torch.cuda.synchronize()
    stage_ms = 1e3 * (time.perf_counter() - t0) if table is not None else None
    if updates is None:
        res, ran = _fit_books(t)
        losses = t.step_losses
    else:
        real, seen = t.train_step, []

        def step(state, batch):
            if state.step == updates:
                raise _Stop
            m = real(state, batch)
            seen.append(m["loss"])
            return m

        t.train_step = step
        res = None
        try:
            _fit_books(t)
        except _Stop:
            pass
        ran = _ran_books(t)
        losses = torch.stack(seen).tolist()
    return {"t": t, "res": res, "ran": ran, "stage_ms": stage_ms,
            "losses": losses,
            "peak_added_bytes": torch.cuda.max_memory_allocated() - before,
            "state": _flat_state(t)}


def _placed_bytes(item) -> int:
    ts = [item] if not isinstance(item, dict) else list(item.values())
    return sum(t.numel() * t.element_size() for t in ts)


def phase_resident(out):
    """12: the device-resident feed (``data.device_resident``) on the
    fused full-width ResNet-18 (`RES_ARGS`: the preset, augmentation on,
    f32, B=128, a 50,000-image synthetic train set, the real CIFAR-10
    table's 153.8 MB), cuDNN deterministic. One epoch (390 updates)
    resident and streamed in windows of 24, and its first 96 updates
    eager: losses, parameters, BN statistics, momentum and the eval
    bit-identical (the eager pair's losses the windowed run's first 96),
    the same launch books per update (10 + 10 conv, 1 + 1 xent); the same
    pair in four
    windows under ``update_sharding=sharded`` f32 at NCCL world 1; a
    resident run interrupted 240 updates in (a snapshot-kind save) and
    resumed in windows re-formed from there, bit-identical to the
    uninterrupted run;
    a call with a re-staged table recaptures the window. Printed: staging
    ms and table bytes, H2D bytes per window, the feed's and the step
    call's host ms per window, windowed ms per update in turns, epoch
    images/s, device busy share, each fit's added peak memory."""
    import torch

    from tpu_dp_torch.checkpoint import CheckpointManager
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import _table_key
    from tpu_dp_torch.train.trainer import Trainer

    k = RES_K
    checks, rec = {}, {"card": out["card"], "k": k}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_resident_")
    try:
        with _shared_datasets():
            # The windowed pair over the whole epoch; the eager pair over
            # its first RES_EAGER_UPDATES updates (one a call), whose
            # losses are the windowed run's first ones bit for bit.
            runs = {}
            for feed in ("on", "off"):
                for kk in (k, 1):
                    runs[(feed, kk)] = _feed_run(
                        _res_args(feed, kk),
                        os.path.join(tmp.name, f"{feed}{kk}"),
                        updates=None if kk > 1 else RES_EAGER_UPDATES)
            rw, sw = runs[("on", k)]["t"], runs[("off", k)]["t"]
            updates, evals = len(rw.train_pipe), len(rw.test_pipe)
            table = rw.resident_train
            ref = runs[("on", k)]
            for (feed, kk), r in runs.items():
                tag = f"{'resident' if feed == 'on' else 'streamed'}_{kk}"
                n = updates if kk > 1 else RES_EAGER_UPDATES
                pair = ref if kk > 1 else runs[("on", 1)]
                checks[f"{tag}_feed"] = ((r["t"].resident_train is not None)
                                         == (feed == "on"))
                checks[f"{tag}_books"] = _per_update_ok(
                    r["ran"], n, evals if kk > 1 else 0)
                checks[f"{tag}_losses_bit_identical"] = (
                    r["losses"] == ref["losses"][:n])
                checks[f"{tag}_state_bit_identical"] = _same_state(
                    r["state"], pair["state"])
                if kk > 1:
                    checks[f"{tag}_eval_identical"] = (r["res"]["eval"]
                                                       == ref["res"]["eval"])
            losses = rw.step_losses
            checks.update({
                "epoch_is_390_updates": updates == 390
                and len(losses) == updates,
                "table_is_the_cifar10_size": rw.train_pipe.dataset_bytes()
                == 153_800_000,
                "windowed": rw.multi_step.graph is not None
                and sw.multi_step.graph is not None,
                "losses_finite": all(math.isfinite(v) for v in losses),
            })
            # Speed, in one call: windowed ms per update in turns
            # (streamed, resident, resident, streamed), host ms per call
            # of the window, the feed's host ms to place one window.
            _, idx = next(iter(rw.train_pipe.index_windows(k)))
            _, pool = _first_window(sw.train_pipe, k)
            calls = {"resident": lambda: rw.multi_step(rw.state, table, idx),
                     "streamed": lambda: sw.multi_step(sw.state, pool)}
            turns = {}
            for name in ("streamed", "resident", "resident", "streamed"):
                turns.setdefault(name, []).append(
                    cuda_median_ms(calls[name], reps=3, warm=1) / k)
            host, feed_ms, busy = {}, {}, {}
            take = rw.train_pipe.sampler.shard_indices()[:k * TRAIN_B]
            place = {
                "resident": lambda: rw.train_pipe._place_indices(take, k),
                "streamed": lambda: sw.train_pipe._place(
                    take, None, (k, TRAIN_B))}
            for name, fn in calls.items():
                ts = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    ts.append(1e3 * (time.perf_counter() - t0))
                host[name] = statistics.median(ts)
                fs = []
                for _ in range(7):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    place[name]()
                    torch.cuda.synchronize()
                    fs.append(1e3 * (time.perf_counter() - t0))
                feed_ms[name] = statistics.median(fs)
                busy[name] = profile_forward(fn, 2, cuda_only=True)[
                    "device_busy_share"]
            # A re-staged table (another address) releases the graph and
            # captures anew.
            clone = {n: t.clone() for n, t in table.items()}
            rw.multi_step(rw.state, clone, idx)
            torch.cuda.synchronize()
            checks["restaged_table_recaptures"] = (
                rw.multi_step.graph is not None
                and rw.multi_step._captured_key == _table_key(clone))
            del clone
            rec.update({
                "updates": updates, "losses": losses,
                "eval": ref["res"]["eval"],
                "ran": {f"{f}_{kk}": r["ran"] for (f, kk), r in runs.items()},
                "staging_ms": ref["stage_ms"],
                "table_device_bytes": sum(t.numel() * t.element_size()
                                          for t in table.values()),
                "table_host_bytes": rw.train_pipe.dataset_bytes(),
                "h2d_bytes_per_window": {"resident": _placed_bytes(idx),
                                         "streamed": _placed_bytes(pool)},
                "windowed_ms_per_update_in_turns": turns,
                "windowed_ms_per_update": {n: min(v)
                                           for n, v in turns.items()},
                "host_ms_per_window_call": host,
                "feed_host_ms_per_window": feed_ms,
                "device_busy_share_windowed": busy,
                "epoch_images_per_s": {
                    f"{'resident' if f == 'on' else 'streamed'}_windowed":
                        r["res"]["images_per_sec"]
                    for (f, kk), r in runs.items() if kk > 1},
                "fit_peak_added_bytes": {
                    f"{'resident' if f == 'on' else 'streamed'}_{kk}":
                        r["peak_added_bytes"] for (f, kk), r in runs.items()},
                "capture_ms": rw.multi_step.capture_ms,
            })
            for r in runs.values():
                if r["t"].multi_step is not None:
                    r["t"].multi_step.close()
            del runs, rw, sw, table, idx, pool, calls, place
            # A mid-epoch resident resume: interrupted before update 240
            # (a snapshot-kind save there), resumed in windows re-formed
            # from it; against the uninterrupted resident windowed run
            # (its losses, state and eval as its fit left them).
            stop = 10 * k
            full = {"losses": list(ref["t"].step_losses),
                    "state": ref["state"], "eval": ref["res"]["eval"]}
            del ref
            where = os.path.join(tmp.name, "part")
            part = Trainer(parse_cli(_res_args("on", k) + [
                f"--train.ckpt_dir={where}"]))
            # The hook wraps what the loop calls for a window: the
            # program under the window's `RecompileGuard`.
            guard = part._window_guard
            real = guard._fn

            def window(state, table, idx):
                if state.step == stop:
                    raise _Stop
                return real(state, table, idx)

            guard._fn = window
            try:
                part.fit()
            except _Stop:
                part.ckpt_mgr.wait()
            cfg = part.cfg
            CheckpointManager(part.snapshot_dir, async_save=False).save(
                part.state, {"kind": "snapshot", "epoch": 0,
                             "steps_done": stop, "config": cfg.to_dict(),
                             "seed": cfg.train.seed})
            real.close()
            resumed = Trainer(parse_cli(_res_args("on", k) + [
                f"--train.ckpt_dir={where}", "--resume"]))
            res_r, ran_r = _fit_books(resumed)
            checks.update({
                "resume_at_update_240": (resumed.start_epoch,
                                         resumed.start_step) == (0, stop),
                "resume_losses_bit_identical":
                    resumed.step_losses == full["losses"][stop:],
                "resume_state_bit_identical": _same_state(
                    _flat_state(resumed), full["state"]),
                "resume_eval_identical": res_r["eval"] == full["eval"],
                "resume_books": _per_update_ok(
                    ran_r, updates - stop, len(resumed.test_pipe)),
            })
            resumed.multi_step.close()
            del full, part, resumed, real
            # The sharded update (f32) at NCCL world 1, both feeds.
            with _nccl_world1_env(TORCH_NCCL_ASYNC_ERROR_HANDLING="0"):
                # Four windows (96 updates) of the same run.
                sh = {feed: _feed_run(
                    _res_args(feed, k, ["--train.update_sharding=sharded",
                                        "--data.synthetic_train_size="
                                        f"{4 * k * TRAIN_B}"]),
                    os.path.join(tmp.name, f"sharded_{feed}"))
                    for feed in ("on", "off")}
                sh_updates = len(sh["on"]["t"].train_pipe)
                a, b = sh["on"], sh["off"]
                checks.update({
                    "sharded_nccl_world_1": (a["t"].ctx.backend,
                                             a["t"].ctx.world) == ("nccl", 1)
                    and a["t"].sharded,
                    "sharded_feeds": a["t"].resident_train is not None
                    and b["t"].resident_train is None,
                    "sharded_losses_bit_identical":
                        a["t"].step_losses == b["t"].step_losses,
                    "sharded_state_bit_identical": _same_state(a["state"],
                                                               b["state"]),
                    "sharded_books": sh_updates == 4 * k
                    and _per_update_ok(a["ran"], sh_updates, evals)
                    and _per_update_ok(b["ran"], sh_updates, evals)
                    and {n: a["ran"][n] for n in ("reduce_scatter",
                                                  "all_gather")}
                    == {n: b["ran"][n] for n in ("reduce_scatter",
                                                 "all_gather")},
                })
                rec["sharded"] = {
                    "ran": {f: r["ran"] for f, r in sh.items()},
                    "epoch_images_per_s": {f: r["res"]["images_per_sec"]
                                           for f, r in sh.items()}}
                for r in sh.values():
                    r["t"].multi_step.close()
                del sh, a, b
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["resident"] = rec
    print("[resident] " + json.dumps({n: v for n, v in rec.items()
                                      if n not in ("losses", "ran")}))
    w = rec["windowed_ms_per_update"]
    ips = rec["epoch_images_per_s"]
    print(f"[resident] {out['card']}: table {rec['table_device_bytes']} B "
          f"staged in {rec['staging_ms']:.1f} ms; H2D per window "
          f"{rec['h2d_bytes_per_window']['resident']} B resident, "
          f"{rec['h2d_bytes_per_window']['streamed']} B streamed; windowed "
          f"{w['resident']:.3f} / {w['streamed']:.3f} ms per update "
          f"(resident / streamed); epoch images/s "
          f"{json.dumps(ips)}")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resident checks failed: {failed}")


def _preset_args(name, updates, batch, k, extra=()):
    """``--preset=name`` with the slice's kernel knobs on synthetic data:
    ``updates`` updates of the preset's per-card ``batch`` in one epoch,
    windows of ``k``."""
    return [f"--preset={name}", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            "--data.dataset=synthetic",
            f"--data.synthetic_train_size={updates * batch}",
            f"--data.synthetic_test_size={2 * batch}", "--train.epochs=1",
            "--train.log_every=10", f"--train.steps_per_call={k}", *extra]


def _p16_kernel_cases(out) -> list:
    """The kernels at ``bf16_cosine_gb4096``'s call pattern: the
    ``emit_stats`` conv with bf16 x at B=512 for every (stage, variant) of
    a train forward (y and z within one bf16 ulp, stats within 1e-5 of the
    plain sums of the kernel's own y and bit-exact with `ordered_stats_sum`,
    across launches, graph replays and a busy side stream), the input-grad
    at B=512 for every stage (one ulp), and the xent mean pair at [512,
    10] on its multi-block route (1e-6, bit-identical over 100 launches and
    3 replays); each timed beside its bound, its plain version and the
    library call (cuDNN bf16 conv2d / conv2d_input, F.cross_entropy)."""
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(13)
    big = torch.randn(8192, 8192, generator=gen, device="cuda").to(
        torch.bfloat16)
    side = torch.cuda.Stream()
    b, cases = P16_B, []
    for stage, variant in dict.fromkeys(FORWARD_CALLS):
        h, c = STAGES[stage]
        emit, with_res = "emit_z" in variant, "res" in variant
        x, w, scale, shift, res = _case_inputs(gen, b, h, c, torch.bfloat16,
                                               with_res)
        wk = cb.pack_weight(w)
        got = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
        again = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
        ref = cb.reference_affine_relu_conv(x, w, scale, shift, res,
                                            emit_z=emit, emit_stats=True)
        torch.cuda.synchronize()
        y, st = got[0], got[-1]
        yf = y.float()
        own = cb._stats_of(y)
        yabs = torch.stack([yf.abs().sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
        rec = {"kind": "p16_emit_stats", "stage": stage, "variant": variant,
               "shape": [b, h, h, c], "dtype": "bfloat16",
               "max_abs_err": (yf - ref[0].float()).abs().max().item(),
               "tol": bf16_ulp(ref[0].float().abs().max().item()),
               "stats_rel_err": ((st - own).abs() / yabs).max().item(),
               "stats_bit_identical": bool(torch.equal(st, again[-1])),
               "y_bit_identical": bool(torch.equal(y, again[0])),
               "tile": cb.tile_of(b, h, h, c)}
        if emit:
            rec["z_max_abs_err"] = (got[1].float()
                                    - ref[1].float()).abs().max().item()
            rec["z_tol"] = bf16_ulp(ref[1].float().abs().max().item())
        rec.update(_fold_checks(cb, x, wk, scale, shift, res, emit, st, big,
                                side))
        rec["ok"] = (rec["max_abs_err"] <= rec["tol"]
                     and rec.get("z_max_abs_err", 0.0) <= rec.get("z_tol",
                                                                  1.0)
                     and rec["stats_rel_err"] <= 1e-5
                     and rec["stats_bit_identical"] and rec["y_bit_identical"]
                     and rec["fold_ok"])
        launch, _ = _direct_conv(cb, x, wk, scale, shift, res, emit, True)
        zl = cb._reference_z(x, scale, shift, res).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        rec["ms"] = cuda_loop_ms(launch)
        rec["plain_ms"] = cuda_median_ms(
            lambda: cb.reference_affine_relu_conv(
                x, w, scale, shift, res, emit_z=emit, emit_stats=True),
            reps=5)
        rec["library_ms"] = cuda_loop_ms(lambda: F.conv2d(zl, wl, padding=1))
        n = b * h * h * c
        rec["bytes"] = (n * 2 * (2 + emit + with_res) + wk.numel() * 2
                        + 4 * c * 4)
        rec["flops"] = 2.0 * b * h * h * 9 * c * c
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"])
        print("[presets-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
    for stage, (h, c) in enumerate(STAGES):
        ct = torch.randn(b, h, h, c, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randn(3, 3, c, c, generator=gen, device="cuda") * 0.05
        wf = cb.flip_packed(w)
        one = torch.ones(c, device="cuda")
        zero = torch.zeros(c, device="cuda")
        dz = cb._run(ct, wf, one, zero, None, False, False,
                     role="input_grad")
        ref = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                            activate=False)
        again = cb._run(ct, wf, one, zero, None, False, False,
                        role="input_grad")
        torch.cuda.synchronize()
        launch, _ = _direct_conv(cb, ct, wf, one, zero, None, False, False,
                                 act=False)
        ctl = ct.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        rec = {"kind": "p16_input_grad", "stage": stage,
               "shape": [b, h, h, c],
               "max_abs_err": (dz.float() - ref.float()).abs().max().item(),
               "tol": bf16_ulp(ref.float().abs().max().item()),
               "bit_identical": bool(torch.equal(dz, again)),
               "tile": cb.tile_of(b, h, h, c), "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       ct, wf, one, zero, activate=False), reps=5),
               "library_ms": cuda_loop_ms(
                   lambda: torch.nn.grad.conv2d_input(
                       ctl.shape, wl, ctl, padding=1)),
               "bytes": b * h * h * c * 2 * 2 + wf.numel() * 2,
               "flops": 2.0 * b * h * h * 9 * c * c}
        rec["ok"] = rec["max_abs_err"] <= rec["tol"] and rec["bit_identical"]
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"])
        print("[presets-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
    del big, side
    c = XENT_CLASSES[0]
    lg = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
    lb = torch.randint(0, c, (b,), generator=gen, device="cuda")
    ct = torch.tensor(1.3, device="cuda")
    x = _xent_mean_parity(lg, lb, ct)
    lref = lg.clone().requires_grad_()
    nbytes = b * c * 4 + b * 8 + 4
    x.update({
        "route": "one_cta" if b <= tx.ONE_CTA_MAX_ROWS else "multi_block",
        "floor_ms": out.get("xent_floor_ms"),
        "fwd_ms": device_ms(lambda: tx._fwd(lg, lb, True)),
        "bwd_ms": device_ms(lambda: tx._bwd(lg, lb, ct, True)),
        "fwd_plain_ms": device_ms(lambda: tx._plain_fwd(lg, lb).mean()),
        "bwd_plain_ms": device_ms(lambda: tx._plain_bwd(
            lg, lb, (ct / b).expand(b))),
        "fwd_library_ms": device_ms(lambda: F.cross_entropy(lg, lb)),
        "bwd_library_ms": device_ms(lambda: torch.autograd.grad(
            F.cross_entropy(lref, lb), lref, ct))})
    for d, nb in (("fwd", nbytes), ("bwd", nbytes + b * c * 4)):
        # ~10 operations per element (exp, max, add, divide), f32.
        x[f"{d}_bound_ms"], x[f"{d}_bound_by"] = bound(
            nb, 10.0 * b * c, PEAK_F32_FLOPS)
    x["ok"] = (x["route"] == "multi_block" and x["fwd_rel_err"] <= 1e-6
               and x["bwd_rel_err"] <= 1e-6
               and x["fwd_bit_identical_100_launches"]
               and x["bwd_bit_identical_100_launches"]
               and all(x["graph_replays_bit_identical"]))
    x["kind"] = "p16_xent"
    print("[presets-kernel] " + json.dumps(x))
    cases.append(x)
    return cases


def _kernel_inputs_of_one_update(trainer, batch) -> list:
    """``(role, dtype, B)`` of every conv kernel launch of one eager update
    of ``trainer`` on ``batch`` (a spy on the launch)."""
    from tpu_dp_torch.ops import conv_block as cb

    real, seen = cb._launch, []

    def spy(x, *a):  # `_run` passes the role last, by position
        seen.append((a[-1], str(x.dtype).replace("torch.", ""), x.shape[0]))
        return real(x, *a)

    cb._launch = spy
    try:
        trainer.train_step(trainer.state, batch)
    finally:
        cb._launch = real
    return seen


def phase_presets(out):
    """13: the last two presets on the card, cuDNN deterministic: (a) the
    kernels at ``bf16_cosine_gb4096``'s call pattern (`_p16_kernel_cases`);
    (b) ``--preset=bf16_cosine_gb4096`` (bf16 compute, per-card batch 512,
    lr 1.6 with its warm-up) with the kernel knobs, 30 updates, eager and
    in windows of 10, augmentation off: losses finite and falling, windows
    bit-identical to eager (losses, state, eval), the books per update,
    every conv launch of an update on bf16 x at B=512, parameters f32; its
    eager step ms and windowed ms per update, images/s, device busy share;
    (c) ``--preset=resnet18_8chip_gb1024`` (per-card batch 128, lr 0.4),
    10 updates: books, finite losses."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import gather_batch
    from tpu_dp_torch.train.trainer import Trainer

    checks, rec = {}, {"card": out["card"]}
    cases = _p16_kernel_cases(out)
    rec["kernel_cases"] = cases
    checks["kernel_cases_within_tolerance"] = all(r["ok"] for r in cases)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_presets_")
    try:
        runs = {}
        for kk in (1, P16_K):
            t = Trainer(parse_cli(_preset_args(
                "bf16_cosine_gb4096", P16_UPDATES, P16_B, kk,
                ["--data.augment=false",
                 f"--train.ckpt_dir={os.path.join(tmp.name, str(kk))}"])))
            runs[kk] = (t, *_fit_books(t))
        (e, res_e, ran_e), (w, res_w, ran_w) = runs[1], runs[P16_K]
        evals = len(e.test_pipe)
        losses = e.step_losses
        checks.update({
            "bf16_model_f32_parameters": e.model.dtype == torch.bfloat16
            and all(p.dtype == torch.float32 for p in e.model.parameters()),
            "per_card_batch_512": e.cfg.data.batch_size == P16_B
            and e.global_batch_size == P16_B and e.cfg.optim.lr == 1.6,
            "resident_feed": e.resident_train is not None,
            "updates": len(losses) == P16_UPDATES,
            "losses_finite_and_fall": all(math.isfinite(v) for v in losses)
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
            "windows_losses_bit_identical": w.step_losses == losses,
            "windows_state_bit_identical": _same_state(_flat_state(w),
                                                       _flat_state(e)),
            "windows_eval_identical": res_w["eval"] == res_e["eval"],
            "windowed": w.multi_step.graph is not None,
            "books_eager": _per_update_ok(ran_e, P16_UPDATES, evals),
            "books_windowed": _per_update_ok(ran_w, P16_UPDATES, evals),
        })
        _, idx = next(iter(e.train_pipe.index_windows(1)))
        batch = gather_batch(e.resident_train, idx[0])
        seen = _kernel_inputs_of_one_update(e, batch)
        checks["kernel_sees_bf16_x_at_b512"] = len(seen) == 20 and all(
            (dt, nb) == ("bfloat16", P16_B) for _, dt, nb in seen) and sorted(
            r for r, _, _ in seen) == ["input_grad"] * 10 + ["stats"] * 10
        _, widx = next(iter(w.train_pipe.index_windows(P16_K)))
        table = w.resident_train
        step_ms = cuda_median_ms(lambda: e.train_step(e.state, batch),
                                 reps=10)
        win_ms = cuda_median_ms(
            lambda: w.multi_step(w.state, table, widx), reps=4) / P16_K
        busy = {"eager": profile_forward(
                    lambda: e.train_step(e.state, batch), 3,
                    cuda_only=True)["device_busy_share"],
                "windowed": profile_forward(
                    lambda: w.multi_step(w.state, table, widx), 1,
                    cuda_only=True)["device_busy_share"]}
        rec["gb4096"] = {
            "losses": losses, "eval": res_e["eval"], "ran_eager": ran_e,
            "ran_windowed": ran_w, "kernel_inputs_one_update": seen,
            "eager_step_ms": step_ms, "windowed_ms_per_update": win_ms,
            "images_per_s": {"eager": P16_B / (step_ms / 1e3),
                             "windowed": P16_B / (win_ms / 1e3)},
            "fit_images_per_s": {"eager": res_e["images_per_sec"],
                                 "windowed": res_w["images_per_sec"]},
            "device_busy_share": busy}
        # The main path's launches: the eager run's (the preset's
        # steps_per_call), set to 0 just before it and read just after.
        rec["launches"] = ran_e
        w.multi_step.close()
        del runs, e, w, batch, table, widx
        t = Trainer(parse_cli(_preset_args(
            "resnet18_8chip_gb1024", P1024_UPDATES, TRAIN_B, 1,
            [f"--train.ckpt_dir={os.path.join(tmp.name, 'gb1024')}"])))
        res, ran = _fit_books(t)
        checks.update({
            "gb1024_per_card_batch_128": t.cfg.data.batch_size == TRAIN_B
            and t.cfg.optim.lr == 0.4 and t.cfg.model.bf16 is False,
            "gb1024_losses_finite": len(t.step_losses) == P1024_UPDATES
            and all(math.isfinite(v) for v in t.step_losses),
            "gb1024_books": _per_update_ok(ran, P1024_UPDATES,
                                           len(t.test_pipe)),
        })
        rec["gb1024"] = {"losses": t.step_losses, "eval": res["eval"],
                         "ran": ran,
                         "fit_images_per_s": res["images_per_sec"]}
        del t
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["presets"] = rec
    g = rec["gb4096"]
    print("[presets] " + json.dumps({n: v for n, v in rec.items()
                                     if n != "kernel_cases"}))
    print(f"[presets] {out['card']}: bf16_cosine_gb4096 at B={P16_B}: loss "
          f"{g['losses'][0]:.4f} -> {g['losses'][-1]:.4f}; eager step "
          f"{g['eager_step_ms']:.3f} ms, windowed "
          f"{g['windowed_ms_per_update']:.3f} ms per update; images/s "
          f"{json.dumps(g['images_per_s'])}; device busy "
          f"{json.dumps(g['device_busy_share'])}")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"presets checks failed: {failed}")


def _int_ops_of_draws(n: int) -> int:
    """Integer operations of one draw call for ``n`` rows (counted from
    the kernel's source, not measured): ten threefry2x32 blocks a row
    (fold_in, two splits of two keys, the two randint words at two
    columns, the flip), ~120 32-bit operations each (20 rounds of add,
    rotate, xor, and the key schedule), plus ~30 for the span arithmetic
    and the float compare."""
    return n * (10 * 120 + 30)


def _augment_kernel_cases(rec: dict, checks: dict) -> None:
    """14 (a): the draw kernel against its plain version, bit for bit, at
    the train step's 128 rows: 100 step keys x row offsets 0 and 128 of a
    global 512 x accumulation keys ``step·2 + i`` (the plain version on
    the card for the first 4 keys, on the CPU for the rest); inside a CUDA
    graph over 3 replays with the step changed between them."""
    import torch

    from tpu_dp_torch.data import augment as aug
    from tpu_dp_torch.ops import augment as aug_ops

    seed, n = 1, TRAIN_B
    step = torch.zeros((), dtype=torch.int64, device="cuda")
    mismatches, worst = 0, 0
    for s in range(100):
        step.fill_(s)
        for row0, a, i in ((0, 1, 0), (n, 1, 0), (0, 2, 0), (n, 2, 1)):
            got = aug_ops.crop_flip_draws(step, n, seed, row0, 4 * n, a, i)
            # The plain version's integer arithmetic is exact on either
            # device: on the CPU for 96 of the keys (cheaper: a call is
            # ~1,700 launches on the card), on the card for the first 4.
            key = step * a + i if s < 4 else torch.tensor(s * a + i)
            want = aug.crop_flip_draws(key, n, seed, row0, 4 * n)
            diff = max(int((got[0].cpu() - want[0].cpu()).abs().max()),
                       int((got[1].cpu().int() - want[1].cpu().int())
                           .abs().max()))
            mismatches += diff != 0
            worst = max(worst, diff)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        aug_ops.crop_flip_draws(step, n, seed)
        with torch.cuda.graph(graph, stream=stream):
            captured = aug_ops.crop_flip_draws(step, n, seed)
    replays_equal = True
    for s in (7, 8, 9):
        step.fill_(s)
        graph.replay()
        want = aug.crop_flip_draws(step, n, seed)
        replays_equal &= (torch.equal(captured[0], want[0])
                          and torch.equal(captured[1], want[1]))
    graph.reset()
    rec["augment"] = {"rows": n, "calls_compared": 400,
                      "mismatching_calls": mismatches,
                      "max_abs_err": float(worst),
                      "graph_replays_equal": replays_equal}
    checks.update({"a_kernel_equals_plain_400_calls": mismatches == 0,
                   "a_kernel_equals_plain_under_3_replays": replays_equal})


def _graph_launch_ms(fn, launches: int = 200) -> float:
    """Device ms per call of ``fn`` from CUDA events around replays of one
    CUDA graph of ``launches`` back-to-back calls: no host launch in the
    way and no profiler record to lose; each call's share of the graph's
    node-to-node gap is included."""
    import torch

    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
    torch.cuda.synchronize()
    ms = cuda_median_ms(graph.replay, reps=7, warm=2) / launches
    graph.reset()
    return ms


def _augment_kernel_times(rec: dict) -> None:
    """14 (a), timed on a quiet card: the draw kernel's device time beside
    an empty kernel's (the launch floor), both per launch in a graph of
    200 (and under the profiler, which loses records late in a long
    call), the plain version's time and the bound."""
    import torch

    from tpu_dp_torch.data import augment as aug
    from tpu_dp_torch.ops import augment as aug_ops

    seed, n = 1, TRAIN_B
    step = torch.full((), 3, dtype=torch.int64, device="cuda")
    launch = (lambda: aug_ops.crop_flip_draws(step, n, seed))
    floor = _launch_floor(n)
    nbytes = 8 + n * (2 * 8 + 1)
    bound_ms, bound_by = bound(nbytes, _int_ops_of_draws(n),
                               PEAK_INT32_OPS)
    rec["augment"] = with_ratios({
        **rec["augment"], "ms": _graph_launch_ms(launch),
        "floor_ms": _graph_launch_ms(floor),
        "profiler_ms": device_ms(launch), "profiler_floor_ms":
            device_ms(floor),
        "plain_ms": cuda_median_ms(
            lambda: aug.crop_flip_draws(step, n, seed), reps=10),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "int_ops": _int_ops_of_draws(n), "library_ms": None,
        "wrapper_host_us": _host_us(launch)})
    print("[resilience] (a) " + json.dumps(rec["augment"]))


#: the flag-setting CLI with cuDNN deterministic (the resume checks are
#: bit for bit, and the CLI leaves cuDNN's choice to it).
_CLI_DETERMINISTIC = (
    "import runpy, sys, torch; "
    "torch.backends.cudnn.deterministic = True; "
    "torch.backends.cudnn.benchmark = False; "
    "sys.argv = ['tpu_dp_torch.train'] + sys.argv[1:]; "
    "runpy.run_module('tpu_dp_torch.train', run_name='__main__')")


def _train_cli(args):
    """``python -m tpu_dp_torch.train`` on ``args`` (cuDNN deterministic)
    as a subprocess on the card."""
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("TPU_DP_FAULT", None)
    return subprocess.Popen(
        [sys.executable, "-c", _CLI_DETERMINISTIC, *args], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _sigterm_at(proc, path, timeout_s=600.0):
    """A thread that sends ``proc`` a SIGTERM once ``path`` exists (or it
    ended, or the timeout passed); returns the started thread."""
    import signal
    import threading

    def watch():
        deadline = time.monotonic() + timeout_s
        while (time.monotonic() < deadline and proc.poll() is None
               and not os.path.exists(path)):
            time.sleep(0.02)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    return t


def _resil_args(where, *extra):
    return RESIL_ARGS + [f"--train.ckpt_dir={where}", *extra]


def _resumed_ok(resumed, full: tuple, start_step) -> dict:
    """The resumed run against the uninterrupted one's ``(losses, flat
    state)`` right after its fit: its start, its losses (the tail from
    ``start_step``) and its final state."""
    losses, state = full
    return {"start": resumed.start_epoch * RESIL_SPE + resumed.start_step
            == start_step,
            "losses_bit_identical":
                resumed.step_losses == losses[start_step:],
            "state_bit_identical": _same_state(_flat_state(resumed), state)}


def _fit_resumed(where, *extra):
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    t = Trainer(parse_cli(_resil_args(where, "--resume", *extra)))
    start = t.state.step
    res = t.fit()
    return t, res, start


def _window_ms(t) -> float:
    """CUDA-event ms per update of one resident window of ``t``."""
    it = t.train_pipe.index_windows(RESIL_K)
    try:
        _, idx = next(it)
    finally:
        it.close()
    table = t.resident_train
    return cuda_median_ms(lambda: t.multi_step(t.state, table, idx),
                          reps=8) / RESIL_K


def _epoch_ms(t) -> float:
    """Host ms per update of one more epoch of ``t`` (fenced)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train_epoch(0)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / RESIL_SPE


def _preempted_in_process(args) -> bool:
    """Fit a `Trainer` on ``args`` (a ``preempt:`` fault): True when it
    raised `PreemptedError`."""
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.resilience import PreemptedError
    from tpu_dp_torch.train.trainer import Trainer

    t = Trainer(parse_cli(args))
    try:
        t.fit()
        return False
    except PreemptedError:
        return True
    finally:
        t.multi_step.close()


def phase_resilience(out):
    """14: the main path's resilience defaults on the card (see the module
    docstring): (a) the draw kernel, (b) the main path with its books and
    the windowed update with augmentation on and off, (c) preempt and
    resume (a real SIGTERM to a CLI subprocess, ``preempt:step=K`` in
    process, ``kill:step=K`` in a subprocess), each resumed bit-identical,
    with the cadence's cost, (d) the sharded update at NCCL world 1. The
    two CLI subprocesses run beside the in-process work; every timing is
    taken after they ended."""
    import torch

    from tpu_dp_torch.checkpoint import read_meta
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.obs import flightrec
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.train.trainer import Trainer

    checks, rec = {}, {"card": out["card"], "k": RESIL_K}
    out["resilience"] = rec  # filled in place: kept when a check fails
    rec["checks"] = checks
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_resilience_")
    where = lambda name: os.path.join(tmp.name, name)  # noqa: E731
    every = f"--resilience.snapshot_every_steps={RESIL_EVERY}"
    procs = []
    try:
        # (c) a real SIGTERM mid-epoch to a CLI subprocess: a delay fault
        # parks it at the boundary of its step-20 snapshot, a watcher
        # signals it there, it exits 143 at that boundary; and a
        # kill:step=11 subprocess (the boundary at 20, after that
        # boundary's snapshot was handed to the writer): exit 137.
        sig_dir, kill_dir = where("sigterm"), where("kill")
        t0 = time.perf_counter()
        sig = _train_cli(_resil_args(
            sig_dir, every, "--resilience.fault=delay:step=20,ms=2000"))
        procs.append(sig)
        watcher = _sigterm_at(sig, os.path.join(
            sig_dir, "snapshots", "step_0000000020", "meta.json"))
        kill = _train_cli(_resil_args(kill_dir, every,
                                      "--resilience.fault=kill:step=11"))
        procs.append(kill)
        _augment_kernel_cases(rec, checks)
        # (b) the uninterrupted run (augmentation on, no cadence): the main
        # path, its books read right after the fit.
        full = Trainer(parse_cli(_resil_args(where("full"))))
        res_full, ran = _fit_books(full)
        # Its trajectory, before the timing below trains it further.
        ref = (list(full.step_losses), _flat_state(full))
        updates = RESIL_EPOCHS * RESIL_SPE
        rec["launches"] = ran
        rec["eval"] = res_full["eval"]
        checks.update({
            "b_resident_windows": full.multi_step is not None
            and full.resident_train is not None,
            "b_losses_finite": all(math.isfinite(v)
                                   for v in full.step_losses),
            "b_books_per_update": _per_update_ok(ran, updates,
                                                 len(full.test_pipe)),
            "b_augment_1_launch_per_update": ran["augment"] == updates})
        # The same books by kernel name per replay, under the by-name rule
        # (`_by_name_verdict`).
        it = full.train_pipe.index_windows(RESIL_K)
        _, idx = next(it)
        it.close()
        table = full.resident_train
        ok, sessions = _profiled_books(
            lambda: full.multi_step(full.state, table, idx),
            {"conv_block_kernel": 20 * RESIL_K, "xent_fwd": RESIL_K,
             "xent_bwd": RESIL_K, "crop_flip_draws": RESIL_K})
        rec["profiled_per_replay"] = {"matches_books": ok,
                                      "sessions": sessions}
        checks["b_books_by_kernel_name"] = ok
        # preempt:step=15 in process (SIGTERM to self; the boundary at 20),
        # resumed with the cadence on (timed below).
        pre_dir = where("preempt")
        checks["c_preempt_step_raised"] = _preempted_in_process(
            _resil_args(pre_dir, every, "--resilience.fault=preempt:step=15"))
        resumed_p, _, start_p = _fit_resumed(pre_dir, every)
        checks["c_preempt_step_resumed_at_20"] = start_p == 20
        checks.update({f"c_preempt_step_resumed_{k}": v for k, v in
                       _resumed_ok(resumed_p, ref, 20).items()})
        # (d) the sharded update at NCCL world 1: one snapshot (the final
        # one of preempt:step=15) and its resume against the run without.
        shard = ["--train.update_sharding=sharded", "--train.epochs=1"]
        with _nccl_world1_env(TORCH_NCCL_ASYNC_ERROR_HANDLING="0"):
            sfull = Trainer(parse_cli(_resil_args(where("s_full"), *shard)))
            sfull.fit()
            s_preempted = _preempted_in_process(_resil_args(
                where("s_run"), *shard, "--resilience.fault=preempt:step=15"))
            snaps = sorted(os.listdir(where("s_run/snapshots")))
            sres, _, s_start = _fit_resumed(where("s_run"), *shard)
            checks.update({
                "d_nccl_world_1_sharded": (sres.ctx.backend, sres.ctx.world,
                                           sres.sharded) == ("nccl", 1,
                                                             True),
                "d_preempted_one_snapshot": s_preempted
                and snaps == ["latest", "step_0000000020"],
                "d_resumed_at_20": s_start == 20})
            checks.update({f"d_resumed_{k}": v for k, v in _resumed_ok(
                sres, (sfull.step_losses, _flat_state(sfull)), 20).items()})
            for t in (sres, sfull):
                t.multi_step.close()
            del sres, sfull
        # The augmentation-off twin of the main path (timed below).
        off = Trainer(parse_cli(_resil_args(where("off"),
                                            "--data.augment=false",
                                            "--train.epochs=1")))
        off.fit()
        # The subprocesses' results, and their resumes in process.
        log, _ = sig.communicate(timeout=600)
        watcher.join(timeout=60)
        klog, _ = kill.communicate(timeout=600)
        rec["subprocesses_wall_s"] = time.perf_counter() - t0
        dump_path = os.path.join(sig_dir, "obs", "flightrec_r00000.json")
        dump = (flightrec.read_dump(dump_path)
                if os.path.exists(dump_path) else {"events": [],
                                                   "reason": ""})
        kinds = [e["kind"] for e in dump["events"]]
        snap20 = os.path.join(sig_dir, "snapshots", "step_0000000020")
        meta = read_meta(snap20) if os.path.exists(snap20) else {}
        checks.update({
            "c_sigterm_exit_143": sig.returncode == 143,
            "c_sigterm_prints_preempted": "preempted: preempted at epoch 0"
            in log,
            "c_sigterm_snapshot_committed": meta.get("kind") == "snapshot"
            and meta.get("steps_done") == 20,
            "c_sigterm_flightrec": "PreemptedError" in dump["reason"]
            and "preempt_signal" in kinds and "preempt_exit" in kinds
            and kinds[-1:] == ["exit"]})
        resumed, res, _ = _fit_resumed(sig_dir)
        checks.update({f"c_sigterm_resumed_{k}": v for k, v in
                       _resumed_ok(resumed, ref, 20).items()})
        checks["c_sigterm_resumed_eval"] = res["eval"] == res_full["eval"]
        rec["sigterm"] = {"rc": sig.returncode, "flightrec_kinds": kinds,
                          "log_tail": log[-1500:],
                          "resumed_from": resumed.resumed_from}
        resumed.multi_step.close()
        del resumed
        resumed_k, _, start_k = _fit_resumed(kill_dir)
        checks.update({"c_kill_exit_137": kill.returncode == 137,
                       "c_kill_resumed_from_snapshot": start_k in (10, 20)
                       and "snapshots" in str(resumed_k.resumed_from)})
        checks.update({f"c_kill_resumed_{k}": v for k, v in
                       _resumed_ok(resumed_k, ref, start_k).items()})
        rec["kill"] = {"rc": kill.returncode, "resumed_at": start_k,
                       "log_tail": klog[-800:]}
        resumed_k.multi_step.close()
        del resumed_k
        # Timed on a quiet card. (a) The kernel; (b) the main path's books
        # per replay by kernel name, and the windowed update with
        # augmentation on and off, in turns.
        _augment_kernel_times(rec)
        on_ms, off_ms = [], []
        for t, acc in ((full, on_ms), (off, off_ms), (off, off_ms),
                       (full, on_ms)):
            acc.append(_window_ms(t))
        rec["windowed_ms_per_update"] = {"augment_on": on_ms,
                                         "augment_off": off_ms}
        off.multi_step.close()
        del off
        # (c) the cadence's cost: the snapshot's blocking ms (the copy's
        # enqueue and the handoff, which joins the previous write) and the
        # ms per update of an epoch with and without it, in turns.
        w0, s0 = counters.get("snapshot.writes"), counters.get(
            "snapshot.write_s")
        cad, plain = [], []
        for t, acc in ((full, plain), (resumed_p, cad), (resumed_p, cad),
                       (full, plain)):
            acc.append(_epoch_ms(t))
        resumed_p.snap_mgr.wait()
        w1, s1 = counters.get("snapshot.writes"), counters.get(
            "snapshot.write_s")
        rec["cadence"] = {
            "every": RESIL_EVERY, "epoch_ms_per_update_with": cad,
            "epoch_ms_per_update_without": plain,
            "snapshots_timed": w1 - w0,
            "blocking_ms_mean": 1e3 * (s1 - s0) / max(1.0, w1 - w0),
            "last_blocking_ms": resumed_p.snap_mgr.last_blocking_ms,
            "snapshot_bytes": sum(v.nbytes for v in _flat_state(
                resumed_p).values())}
        checks["c_cadence_snapshots_taken"] = w1 - w0 == 2 * (
            RESIL_SPE // RESIL_EVERY)
        print(f"[resilience] (c) {out['card']}: cadence every "
              f"{RESIL_EVERY}: " + json.dumps(rec["cadence"]))
        for t in (resumed_p, full):
            t.multi_step.close()
        del resumed_p, full
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    a = rec["augment"]
    print(f"[resilience] {out['card']}: draw kernel {1e3 * a['ms']:.2f} us "
          f"(launch floor {1e3 * a['floor_ms']:.2f} us, plain "
          f"{a['plain_ms']:.3f} ms); windowed ms per update on/off "
          f"{rec['windowed_ms_per_update']}; snapshot blocking "
          f"{rec['cadence']['blocking_ms_mean']:.3f} ms; subprocesses "
          f"{rec['subprocesses_wall_s']:.1f} s")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resilience checks failed: {failed}")


def _guard_args(where, *extra):
    return GUARD_ARGS + [f"--train.ckpt_dir={where}", *extra]


def _guard_oracle(args, drop):
    """The unguarded main path, one update a call, whose updates of the
    batches ``drop`` (0-based, in feed order) never run: the guard's
    never-saw-it oracle (the update counter does not move for them)."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    t = Trainer(parse_cli(args + ["--train.steps_per_call=1"]))
    real, seen = t.train_step, [0]

    def step(state, batch):
        seen[0] += 1
        if seen[0] - 1 in drop:
            zero = torch.zeros((), device=t.device)
            return {"loss": zero, "correct": zero.long(),
                    "count": t.step_body.count(batch["label"])}
        return real(state, batch)

    t.train_step = step
    t.fit()
    return t


def guard_worker(spec_path: str) -> int:
    """One rank of phase 15's SDC audit (``chip_smoke.py --guard-worker
    SPEC``): joins the gloo group SPEC names on ``cuda:0`` (NCCL refuses
    two ranks on one card; the checksums are gathered on the host
    anyway), fits the port's `Trainer` on ``SPEC["args"]`` and writes
    whether and how it halted to ``SPEC["out"]`` (JSON)."""
    sys.path.insert(0, HERE)
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.parallel.dist import initialize, shutdown
    from tpu_dp_torch.resilience import DivergedError
    from tpu_dp_torch.train.trainer import Trainer

    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(backend="gloo", init_method=spec["init"],
               world_size=spec["world"], rank=spec["rank"], device="cuda:0",
               timeout_s=300)
    rec = {"rank": spec["rank"], "diverged": None}
    try:
        t = Trainer(parse_cli(spec["args"]), device="cuda:0")
        try:
            t.fit()
        except DivergedError as e:
            rec["diverged"] = str(e)
        rec.update(host_step=t._host_step, device=str(t.device),
                   backend=t.ctx.backend, world=t.ctx.world,
                   counters={k: v for k, v in counters.snapshot().items()
                             if k.startswith("guard.")})
    finally:
        shutdown()
    with open(spec["out"], "w", encoding="utf-8") as f:
        json.dump(rec, f)
    return 0


def _start_guard_ranks(work: str) -> list:
    """`guard_worker` ranks of the SDC audit, started (rendezvous and
    records in ``work``, also their ckpt_dir)."""
    os.makedirs(work, exist_ok=True)
    procs = []
    for rank in range(GUARD_SDC_WORLD):
        spec = {"rank": rank, "world": GUARD_SDC_WORLD,
                "init": "file://" + os.path.join(work, "rendezvous"),
                "args": GUARD_SDC_ARGS + [
                    f"--train.ckpt_dir={os.path.join(work, 'ck')}",
                    f"--obs.run_dir={os.path.join(work, 'obs')}"],
                "out": os.path.join(work, f"rank{rank}.json")}
        path = os.path.join(work, f"spec{rank}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        env.pop("TPU_DP_FAULT", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--guard-worker",
             path], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _guard_epoch_ms(t) -> float:
    """Host ms per update of one more epoch of ``t`` (fenced): the guard's
    per-window fetch included when it is on."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train_epoch(0)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / GUARD_UPDATES


def phase_guard(out):
    """15: the guard on the main path (module docstring): (a) guarded
    against unguarded, bit for bit, with the books and the costs; (b)
    ``nan:step=13`` skipped against the never-saw-it oracle; (c) a spike
    rolled back to the step-10 snapshot; (d) a halt through the CLI,
    exit 65; (e) the SDC audit of three gloo ranks on the card naming
    rank 2. The CLI and the ranks run beside the in-process work; every
    timing is taken after they ended."""
    import torch

    from tpu_dp_torch.checkpoint import QUARANTINED_MARKER
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.resilience import QuarantineLog
    from tpu_dp_torch.train.trainer import Trainer

    checks, rec = {}, {"card": out["card"], "k": GUARD_K,
                       "updates": GUARD_UPDATES}
    out["guard"] = rec  # filled in place: kept when a check fails
    rec["checks"] = checks
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_guard_")
    where = lambda name: os.path.join(tmp.name, name)  # noqa: E731
    on_flag = "--guard.enabled=true"
    procs = []
    try:
        # (d) the halt through the CLI: nan:step=5 poisons the rest of the
        # first window; its boundary halts. (e) the SDC ranks.
        t0 = time.perf_counter()
        halt = _train_cli(_guard_args(where("halt"), on_flag,
                                      "--guard.action=halt",
                                      "--resilience.fault=nan:step=5"))
        procs.append(halt)
        sdc_procs = _start_guard_ranks(where("sdc"))
        procs += sdc_procs
        # (a) unguarded, then guarded: the main path, its books read right
        # after each fit.
        off = Trainer(parse_cli(_guard_args(where("off"))))
        res_off, ran_off = _fit_books(off)
        ref = (list(off.step_losses), _flat_state(off))
        on = Trainer(parse_cli(_guard_args(where("on"), on_flag)))
        fences0 = counters.get("guard.fences")
        res_on, ran_on = _fit_books(on)
        keys = ("conv.stats", "conv.input_grad", "conv.eval", "xent.forward",
                "xent.backward", "augment")
        rec["launches"] = {"on": {k: ran_on[k] for k in keys},
                           "off": {k: ran_off[k] for k in keys}}
        fit_fences = counters.get("guard.fences") - fences0
        checks.update({
            "a_windows_captured": on.multi_step.graph is not None
            and off.multi_step.graph is not None
            and on.resident_train is not None,
            "a_losses_bit_identical": on.step_losses == ref[0],
            "a_state_bit_identical": _same_state(_flat_state(on), ref[1]),
            "a_eval_equal": res_on["eval"] == res_off["eval"],
            "a_books_unchanged_by_counter":
                rec["launches"]["on"] == rec["launches"]["off"],
            "a_books_per_update": _per_update_ok(ran_on, GUARD_UPDATES,
                                                 len(on.test_pipe))
            and ran_on["augment"] == GUARD_UPDATES,
            "a_nothing_quarantined": not QuarantineLog(
                on.quarantine_path).read(),
            "a_one_fence_per_window": fit_fences
            == GUARD_UPDATES // GUARD_K})
        # The books by kernel name per replay, guarded and not. The
        # profiler loses records late in a long call and never adds any,
        # so each kernel's count is its most over the sessions: the conv
        # and xent kernels' equal to the books, guarded and not. The draw
        # kernel's is recorded: late in a full call the profiler reads 19
        # of a replay pair's 20 draw records in every session (phase 14).
        it = on.train_pipe.index_windows(GUARD_K)
        _, idx = next(it)
        it.close()
        want = {"conv_block_kernel": 20 * GUARD_K, "xent_fwd": GUARD_K,
                "xent_bwd": GUARD_K, "crop_flip_draws": GUARD_K}
        by_name = {}
        for tag, t in (("on", on), ("off", off)):
            table = t.resident_train
            ok, sessions = _profiled_books(
                lambda: t.multi_step(t.state, table, idx), want)
            by_name[tag] = {"matches_books": ok, "sessions": sessions,
                            "most": sessions[-1]["most"]}
        rec["profiled_per_replay"] = by_name
        checks["a_books_by_kernel_name"] = all(
            v["matches_books"] for v in by_name.values())
        # (b) nan:step=13 under action=skip: the counter freezes at 13, so
        # the rest of that window is quarantined too (disarmed at its
        # boundary, 20); then the never-saw-it oracle.
        nan = Trainer(parse_cli(_guard_args(
            where("nan"), on_flag,
            f"--resilience.fault=nan:step={GUARD_NAN_STEP}")))
        nan.fit()
        quarantined = [r for r in QuarantineLog(nan.quarantine_path).read()
                       if r["kind"] == "quarantine"]
        drop = {r["step"] - 1 for r in quarantined}
        window = range(GUARD_NAN_STEP + 1, 2 * GUARD_K + 1)
        rec["nan"] = {"quarantined_steps": [r["step"] for r in quarantined],
                      "reasons": sorted({r["reason"] for r in quarantined}),
                      "device_counter": int(nan.step_body.step_t),
                      "host_step": nan._host_step}
        checks.update({
            "b_quarantined_rest_of_window": [r["step"] for r in quarantined]
            == list(window),
            "b_sample_ranges": all(
                r["sample_range"] == [(r["step"] - 1) * TRAIN_B,
                                      r["step"] * TRAIN_B]
                for r in quarantined),
            "b_device_counter_is_batches_less_skips":
                int(nan.step_body.step_t) == nan.state.step
                == GUARD_UPDATES - len(window)
                and nan._host_step == GUARD_UPDATES})
        oracle = _guard_oracle(_guard_args(where("oracle")), drop)
        checks["b_state_bit_identical_to_oracle"] = _same_state(
            _flat_state(nan), _flat_state(oracle))
        for t in (nan, oracle):
            if t.multi_step is not None:
                t.multi_step.close()
        del nan, oracle
        # (c) spike:step=15 under action=rollback with snapshots every 10:
        # detected at the boundary at 20, rolled back to the step-10
        # snapshot, replayed to the end: the clean run's state.
        sp = Trainer(parse_cli(_guard_args(where("spike"), on_flag,
                                           *GUARD_SPIKE)))
        sp.fit()
        recs = QuarantineLog(sp.quarantine_path).read()
        tombs = [r for r in recs if r["kind"] == "tombstone"]
        rec["spike"] = {"records": [{k: r.get(k) for k in (
            "kind", "step", "from_step", "to_step", "rollback_generation",
            "field")} for r in recs], "generation": sp._rollback_gen}
        checks.update({
            "c_rolled_back_20_to_10": [(r["from_step"], r["to_step"])
                                       for r in tombs] == [(20, 10)]
            and sp._rollback_gen == 1,
            "c_finished": sp.state.step == sp._host_step == GUARD_UPDATES,
            "c_replay_equals_clean_run": _same_state(_flat_state(sp),
                                                     ref[1])})
        sp.multi_step.close()
        del sp
        # (d), (e): the subprocesses.
        hlog, _ = halt.communicate(timeout=600)
        rec["halt"] = {"rc": halt.returncode, "log_tail": hlog[-1200:]}
        checks.update({"d_halt_exit_65": halt.returncode == 65,
                       "d_halt_prints_diverged": "diverged: guard halt: "
                       "non-finite update" in hlog})
        ranks = []
        for rank, p in enumerate(sdc_procs):
            log, _ = p.communicate(timeout=600)
            path = where(f"sdc/rank{rank}.json")
            got = {"rc": p.returncode, "log_tail": log[-1500:]}
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    got.update(json.load(f))
            ranks.append(got)
        rec["subprocesses_wall_s"] = time.perf_counter() - t0
        qrecs = QuarantineLog(where("sdc/ck/quarantine.jsonl")).read()
        sdc = [r for r in qrecs if r["kind"] == "sdc"]
        snaps = where("sdc/ck/snapshots")
        marked = sorted(d for d in os.listdir(snaps) if os.path.exists(
            os.path.join(snaps, d, QUARANTINED_MARKER))) if os.path.isdir(
            snaps) else []
        rec["sdc"] = {"ranks": ranks, "records": sdc,
                      "quarantined_saves": marked}
        checks.update({
            "e_ranks_on_the_card_under_gloo": all(
                r.get("rc") == 0 and r.get("device") == "cuda:0"
                and r.get("backend") == "gloo"
                and r.get("world") == GUARD_SDC_WORLD for r in ranks),
            "e_every_rank_halted": all(
                "suspect rank(s) [2]" in (r.get("diverged") or "")
                for r in ranks),
            "e_names_rank_2_and_the_leaf": bool(sdc)
            and sdc[0]["suspects"] == [2]
            and sdc[0]["leaves"].get("2") == ["conv1/bias"],
            "e_saves_after_last_clean_audit_quarantined":
                marked == ["step_0000000003"]})
        # Timed on a quiet card: the windowed update guarded and not, and
        # an epoch's ms per update with the guard's fetch, in turns.
        win = {"on": [], "off": []}
        for tag, t in (("on", on), ("off", off), ("off", off), ("on", on)):
            it = t.train_pipe.index_windows(GUARD_K)
            _, idx = next(it)
            it.close()
            table = t.resident_train
            win[tag].append(cuda_median_ms(
                lambda: t.multi_step(t.state, table, idx), reps=5,
                warm=2) / GUARD_K)
        rec["windowed_ms_per_update"] = win
        f0, s0 = counters.get("guard.fences"), counters.get("guard.fence_s")
        epoch = {"on": [], "off": []}
        for tag, t in (("on", on), ("off", off), ("off", off), ("on", on)):
            epoch[tag].append(_guard_epoch_ms(t))
        rec["epoch_ms_per_update"] = epoch
        fences = counters.get("guard.fences") - f0
        rec["fence_ms_timed"] = {
            "windows": fences, "mean": 1e3 * (counters.get("guard.fence_s")
                                              - s0) / max(1.0, fences)}
        for t in (on, off):
            t.multi_step.close()
        del on, off
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    fence = rec["fence_ms_timed"]
    print(f"[guard] {out['card']}: windowed ms per update on/off "
          f"{rec['windowed_ms_per_update']}; epoch ms per update on/off "
          f"{rec['epoch_ms_per_update']}; fence host ms per window "
          f"{fence['mean']:.3f} (mean of {fence['windows']:g}); nan "
          f"{rec['nan']}; subprocesses {rec['subprocesses_wall_s']:.1f} s")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"guard checks failed: {failed}")


@contextlib.contextmanager
def _counted_syncs():
    """Count the host's synchronisations with the card in the block: the
    calls `torch.cuda.set_sync_debug_mode("warn")` reports (fetches,
    stream and device synchronizes) and `torch.cuda.Event.synchronize`
    calls, which that mode does not see. Fills the yielded dict's
    ``debug`` and ``event``, and ``sites``: how many of them each calling
    line of the port (or of this script) made, innermost first. Only the
    mode's own warning counts: the first switch to "warn" in a process
    also warns, once, that the mode is a prototype."""
    import traceback
    import warnings

    import torch

    got = {"debug": 0, "event": 0, "sites": {}}
    real = torch.cuda.Event.synchronize

    def site():
        frames = [f for f in traceback.extract_stack()[:-2]
                  if "tpu_dp_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        key = " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                         for f in frames[::-1][:3])
        got["sites"][key] = got["sites"].get(key, 0) + 1

    def counted(self):
        got["event"] += 1
        site()
        return real(self)

    def seen(message, *args, **kwargs):
        if "called a synchronizing cuda operation" in str(message).lower():
            got["debug"] += 1
            site()

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.Event.synchronize = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield got
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            torch.cuda.Event.synchronize = real


def _obs_epoch_ms(t) -> float:
    """Host ms per update of one more epoch of ``t`` (fenced): the
    telemetry's per-window work included at its mode."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train_epoch(0)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / OBS_UPDATES


def _obsctl(*argv) -> tuple[int, str]:
    """``python -m tpu_dp_torch.obs ARGV`` as a user runs it: (exit code,
    standard output)."""
    p = subprocess.run([sys.executable, "-m", "tpu_dp_torch.obs", *argv],
                       cwd=HERE, capture_output=True, text=True, timeout=300)
    if p.returncode not in (0, 1):
        print(f"[obsctl] {' '.join(argv[:2])}: rc {p.returncode}: "
              f"{p.stderr[-1500:]}")
    return p.returncode, p.stdout


def _obsctl_checks(run_dir: str, work: str) -> dict:
    """Phase 16's post-hoc tools over a run directory: ``timeline``,
    ``stragglers``, ``merge-trace`` and ``diff`` against a baseline minted
    from the same run exit 0 (and ``diff`` against a baseline whose p95
    step time is a tenth of the run's exits 1); ``watch --replay`` exits 0
    on a rule the run keeps and 1 on a rule it must trip. (The off-mode
    run mints no baseline: it records no efficiency signal, and ``diff``
    refuses to certify on nothing, exit 2.)"""
    os.makedirs(work, exist_ok=True)
    base, tampered = (os.path.join(work, n)
                      for n in ("base.json", "tampered.json"))
    rc, res = {}, {}
    rc["timeline"], t = _obsctl("timeline", run_dir, "--json")
    rc["stragglers"], st = _obsctl("stragglers", run_dir, "--json")
    rc["merge_trace"], _ = _obsctl("merge-trace", run_dir, "-o",
                                   os.path.join(work, "merged.json"))
    rc["write_baseline"], _ = _obsctl("diff", run_dir, "--write-baseline",
                                      base)
    rc["diff"], d = _obsctl("diff", run_dir, "--baseline", base, "--json")
    if os.path.exists(base):
        with open(base, encoding="utf-8") as f:
            payload = json.load(f)
        if payload.get("p95_ms"):
            payload["p95_ms"] /= 10
        with open(tampered, "w", encoding="utf-8") as f:
            json.dump(payload, f)
    rc["diff_tampered"], _ = _obsctl("diff", run_dir, "--baseline", tampered)
    rc["watch_clean"], _ = _obsctl("watch", run_dir, "--replay", "--rule",
                                   "goodput<0.0001")
    rc["watch_trips"], w = _obsctl("watch", run_dir, "--replay", "--rule",
                                   "goodput<2")
    try:
        res["timeline_events"] = len(json.loads(t)["events"])
        res["stragglers"] = json.loads(st)["stragglers"]
        res["diff_checks"] = {c["signal"]: c["verdict"]
                              for c in json.loads(d)["checks"]}
    except (ValueError, KeyError):
        res["unreadable"] = True
    want = {"diff_tampered": 1, "watch_trips": 1}
    return {"rcs": rc, **res, "watch_trips_output": w[-600:], "checks": {
        k: v == want.get(k, 0) for k, v in rc.items()}
        | {"outputs_read": "unreadable" not in res
           and res["timeline_events"] > 0}}


def phase_obs(out):
    """16: the telemetry on the main path (module docstring): the same run
    at train.obs off, basic and full (books, parameters, host
    synchronisations, the artifacts, MFU and the device span against CUDA
    events), the profiler's step range by kernel name, and the cost of
    each mode per update, in turns."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.obs import costs, flightrec
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.obs.export import validate_trace
    from tpu_dp_torch.obs.health import HeartbeatWriter
    from tpu_dp_torch.obs.promfile import parse_promfile
    from tpu_dp_torch.train.trainer import Trainer

    checks, rec = {}, {"card": out["card"], "k": OBS_K,
                       "updates": OBS_UPDATES}
    out["obs"] = rec  # filled in place: kept when a check fails
    rec["checks"] = checks
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    where = lambda name: os.path.join(tmp.name, name)  # noqa: E731
    runs, keys = {}, ("conv.stats", "conv.input_grad", "conv.eval",
                      "xent.forward", "xent.backward", "augment")
    try:
        for mode in OBS_MODES:
            t = Trainer(parse_cli(OBS_ARGS + [
                f"--train.ckpt_dir={where(mode)}", f"--train.obs={mode}",
                f"--obs.prom_path={where(mode + '.prom')}"]))
            with _counted_syncs() as syncs:
                _, ran = _fit_books(t)
            runs[mode] = {"t": t, "ran": {k: ran[k] for k in keys},
                          "syncs": syncs, "state": _flat_state(t),
                          "mfu": counters.get("obs.mfu", None),
                          "mem": {k: v for k, v in counters.snapshot()
                                  .items() if k.startswith("device.mem")}}
        windows = OBS_UPDATES // OBS_K
        rec["launches"] = {m: r["ran"] for m, r in runs.items()}
        rec["syncs_per_fit"] = {m: r["syncs"] for m, r in runs.items()}
        off, basic, full = (runs[m] for m in OBS_MODES)
        fit = {m: r["syncs"]["debug"] + r["syncs"]["event"]
               for m, r in runs.items()}
        # Where a fit's syncs differ from off's, by calling line.
        ref = off["syncs"]["sites"]
        rec["sync_sites_vs_off"] = {
            m: {k: n - ref.get(k, 0) for k, n in runs[m]["syncs"]["sites"]
                .items() if n != ref.get(k, 0)}
            | {k: -n for k, n in ref.items()
               if k not in runs[m]["syncs"]["sites"]}
            for m in ("basic", "full")}
        checks.update({
            "fit_basic_adds_no_sync": fit["basic"] == fit["off"],
            "fit_full_adds_one_sync_a_window": fit["full"] == fit["off"]
            + windows and full["syncs"]["event"] == windows,
            "windows_captured": all(r["t"].multi_step.graph is not None
                                    and r["t"].resident_train is not None
                                    for r in runs.values()),
            "books_unchanged_by_counter": off["ran"] == basic["ran"]
            == full["ran"],
            "books_per_update": _per_update_ok(
                off["ran"], OBS_UPDATES, len(off["t"].test_pipe))
            and off["ran"]["augment"] == OBS_UPDATES,
            "state_bit_identical": _same_state(basic["state"], off["state"])
            and _same_state(full["state"], off["state"])})
        # The books by kernel name per replay, in every mode, over two
        # replays a session, under the by-name rule (`_by_name_verdict`).
        want = {"conv_block_kernel": 20 * OBS_K, "xent_fwd": OBS_K,
                "xent_bwd": OBS_K}
        by_name, short, verdicts = {}, {}, {}
        for mode, r in runs.items():
            t = r["t"]
            it = t.train_pipe.index_windows(OBS_K)
            _, idx = next(it)
            it.close()
            table = t.resident_train
            verdicts[mode], sessions = _profiled_books(
                lambda: t.multi_step(t.state, table, idx), want)
            by_name[mode] = sessions[-1]["most"]
            short[mode] = sessions[-1]["records_short"]
        rec["profiled_per_replay"] = by_name
        rec["profiled_records_short"] = short
        checks["books_by_kernel_name"] = all(verdicts.values())
        # The artifacts of the full run, and basic's.
        t = full["t"]
        recs = [json.loads(line) for line in
                open(t.metrics_path, encoding="utf-8")]
        per_update = [r for r in recs if "spans" in r and "epoch" not in r]
        with open(t.obs_dir / "trace.perfetto.json", encoding="utf-8") as f:
            trace = json.load(f)
        beats = open(t.obs_dir / "heartbeat_r00000.jsonl",
                     encoding="utf-8").read().splitlines()
        proms = {m: parse_promfile(open(where(m + ".prom"),
                                        encoding="utf-8").read())
                 for m in ("basic", "full")}
        total_mem = torch.cuda.get_device_properties(0).total_memory
        mem = full["mem"]
        checks.update({
            "full_one_record_per_update": [r["step"] for r in per_update]
            == list(range(1, OBS_UPDATES + 1)),
            "basic_records_no_h2d_or_device": all(
                set(r["spans"]) == {"data_wait", "dispatch"}
                for r in map(json.loads, open(basic["t"].metrics_path,
                                              encoding="utf-8"))
                if "spans" in r),
            "promfiles_parse": all("tpu_dp_obs_step_time_ms" in p
                                   for p in proms.values())
            and "tpu_dp_obs_mfu" in proms["full"],
            "perfetto_trace_valid": validate_trace(trace) == []
            and len([e for e in trace["traceEvents"] if e["ph"] == "X"
                     and e["name"] == "device"]) == OBS_UPDATES,
            "one_beat_per_window": len(beats) == windows,
            "memory_gauges": 0 < mem.get("device.mem_in_use_bytes", 0)
            < total_mem and mem.get("device.mem_limit_bytes.0") == total_mem})
        rec["memory_gauges"] = mem
        # MFU and the device span against the card's own CUDA-event time
        # of the window the run replayed.
        it = t.train_pipe.index_windows(OBS_K)
        _, idx = next(it)
        it.close()
        table = t.resident_train
        event_ms = cuda_median_ms(lambda: t.multi_step(t.state, table, idx),
                                  reps=5, warm=2) / OBS_K
        cost = costs.registry.get("resident_loop[w10]")
        peak = costs.peak_flops(torch.cuda.get_device_name(0))
        mine = (None if cost is None or peak is None else
                cost.flops_per_step_per_chip / (event_ms / 1e3) / peak)
        last = per_update[-OBS_K:]
        device_ms = statistics.median(r["spans"]["device"] for r in last)
        rec.update(event_ms_per_update=event_ms, mfu_gauge=full["mfu"],
                   mfu_cuda_events=mine, peak_flops=peak,
                   flops_per_step=None if cost is None
                   else cost.flops_per_step_per_chip,
                   device_span_ms_per_update=device_ms,
                   spans_last_window={k: statistics.median(
                       r["spans"][k] for r in last)
                       for k in last[0]["spans"]},
                   mfu_basic_dispatch_rate=basic["mfu"])
        checks.update({
            "mfu_in_0_1": full["mfu"] is not None and 0 < full["mfu"] <= 1,
            "mfu_within_10pct_of_cuda_events": mine is not None
            and full["mfu"] is not None
            and abs(full["mfu"] - mine) <= 0.1 * mine,
            "device_span_within_10pct": abs(device_ms - event_ms)
            <= 0.1 * event_ms})
        # The profiler's step range: armed before the window holding step
        # 10, stopped after the one holding step 19; the Chrome trace
        # holds those two windows' kernels and no other's.
        a, b = OBS_PROFILE
        prof_dir = where("profile")
        flightrec.recorder.reset()
        pt = Trainer(parse_cli(OBS_ARGS + [
            f"--train.ckpt_dir={where('prof_ck')}",
            f"--train.profile_steps={a}:{b}",
            f"--train.profile_dir={prof_dir}"]))
        pt.fit()
        with open(os.path.join(prof_dir, "trace_r00000.json"),
                  encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("ph") == "X"
                   and e.get("cat") == "kernel"]
        in_range = 2 * OBS_K  # windows [1, 10] and [11, 20]
        got = {k: sum(1 for n in kernels if k in n.lower()) for k in want}
        span = {k: v * in_range // OBS_K for k, v in want.items()}
        kinds = [e["kind"] for e in flightrec.recorder.events()]
        rec["profile"] = {"range": OBS_PROFILE, "kernels": got,
                          "books_in_range": span,
                          "cuda_only": not any(e.get("cat") == "cpu_op"
                                               for e in events)}
        checks.update({
            "profile_kernels_in_range_only": all(
                0.98 * span[k] <= got[k] <= span[k] for k in want),
            "profile_cuda_activity_only": rec["profile"]["cuda_only"],
            "profile_flightrec_events": kinds.count("profile_start")
            == kinds.count("profile_stop") == 1})
        pt.multi_step.close()
        del pt
        # The post-hoc tools over the full run's directory.
        rec["obsctl"] = _obsctl_checks(where("full"), where("obsctl"))
        checks.update({f"obsctl_{k}": v
                       for k, v in rec["obsctl"]["checks"].items()})
        # The cost of each mode per update, in turns on a quiet card: an
        # epoch of 30 updates fenced at its end. fit closed the heartbeat
        # writers: the timed epochs beat into fresh ones.
        for mode in ("basic", "full"):
            t = runs[mode]["t"]
            t.heartbeat = HeartbeatWriter(t.obs_dir / "timed", rank=0)
        # The host's synchronisations over one more epoch's windows (and
        # its one closing fetch) at each mode.
        syncs = {}
        for mode in OBS_MODES:
            t = runs[mode]["t"]
            torch.cuda.synchronize()
            with _counted_syncs() as syncs[mode]:
                t.train_epoch(0)
            torch.cuda.synchronize()
        rec["syncs"] = syncs
        total = {m: v["debug"] + v["event"] for m, v in syncs.items()}
        checks.update({
            "basic_adds_no_sync": total["basic"] == total["off"],
            "full_adds_one_sync_a_window": total["full"] == total["off"]
            + windows and syncs["full"]["event"] == windows})
        # Three turns a mode, each mode's median: one stalled epoch (a
        # shared host) does not make the cost.
        epoch = {m: [] for m in OBS_MODES}
        for mode in OBS_MODES + OBS_MODES[::-1] + OBS_MODES:
            epoch[mode].append(_obs_epoch_ms(runs[mode]["t"]))
        rec["epoch_ms_per_update"] = epoch
        mid = {m: statistics.median(v) for m, v in epoch.items()}
        rec["full_cost_ms_per_update"] = mid["full"] - mid["off"]
        rec["basic_cost_ms_per_update"] = mid["basic"] - mid["off"]
        for r in runs.values():
            if r["t"].heartbeat is not None:
                r["t"].heartbeat.close()
            r["t"].multi_step.close()
            del r["t"]
        runs.clear()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    syncs = {m: s["debug"] + s["event"] for m, s in rec["syncs"].items()}
    fit = {m: s["debug"] + s["event"] for m, s in rec["syncs_per_fit"].items()}
    print(f"[obs] host syncs per fit off/basic/full {fit}; by calling line "
          f"against off's {json.dumps(rec['sync_sites_vs_off'])}")
    print(f"[obs] {out['card']}: host syncs per epoch off/basic/full {syncs} "
          f"(Event.synchronize {[s['event'] for s in rec['syncs'].values()]}"
          f"); MFU gauge {rec['mfu_gauge']} vs CUDA events "
          f"{rec['mfu_cuda_events']} (event ms per update "
          f"{rec['event_ms_per_update']:.3f}, device span "
          f"{rec['device_span_ms_per_update']:.3f}); epoch ms per update "
          f"{rec['epoch_ms_per_update']}; full costs "
          f"{rec['full_cost_ms_per_update']:.3f} ms per update, basic "
          f"{rec['basic_cost_ms_per_update']:.3f}; profile "
          f"{rec['profile']['kernels']}; obsctl exit codes "
          f"{json.dumps(rec['obsctl']['rcs'])}")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"obs checks failed: {failed}")


def _ran_books(trainer) -> dict:
    """The launches and collectives that ran since the last reset: the
    wrappers' counts, which tick at capture, less the capture's own ticks,
    plus the captured window's books once per replay (`MultiStep`)."""
    import torch

    from tpu_dp_torch.train.step import launch_books

    torch.cuda.synchronize()
    ran = launch_books()
    ms = trainer.multi_step
    if ms is not None and getattr(ms, "captured", None) is not None:
        for k, v in ms.captured.items():
            ran[k] += v * (ms.replays - 1)
    return ran


def _reset_books() -> None:
    from tpu_dp_torch.ops import augment as aug_ops
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.parallel import collectives

    cb.reset_launches()
    tx.reset_launches()
    aug_ops.reset_launches()
    collectives.reset_counts()


def elastic_worker(spec_path: str) -> int:
    """One rank of phase 17 (``chip_smoke.py --elastic-worker SPEC``): joins
    the gloo group SPEC names on ``cuda:0`` (NCCL refuses two ranks on one
    card), or reads the launcher's env contract (NCCL, one rank a card),
    and fits the port's elastic `Trainer` on ``SPEC["args"]``. Records
    every index list its feed placed, the books before the regroup and
    after it (set to 0 just before the fit and at the regroup), the
    boundaries' clock, the membership record, the losses and a digest of
    its state; writes them to ``SPEC["out"]`` and exits 143 as the leaver
    (after its departure), 0 as a survivor."""
    import hashlib

    import faulthandler
    import signal

    entered = time.time()
    # The phase's deadline asks a stuck rank for its stacks (`_await_ranks`).
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    sys.path.insert(0, HERE)
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.data.pipeline import DataPipeline
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.parallel.dist import initialize, shutdown
    from tpu_dp_torch.resilience import PreemptedError
    from tpu_dp_torch.train.hooks import StepHook
    from tpu_dp_torch.train.trainer import Trainer

    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    if spec.get("grow"):
        spec["started"] = spec.get("started", entered)
        return _elastic_grow_worker(spec)
    rollback = spec.get("rollback", False)

    class Boundaries(StepHook):
        """The host clock (and the wall clock) and world at every window
        boundary; in a rollback run also the books there (the last
        boundary before a failure closes the world's whole updates)."""

        def __init__(self, trainer):
            super().__init__(trainer)
            self.marks = []
            self.books = None

        def on_step_end(self, ev):
            self.marks.append((time.perf_counter(), self.tr._host_step,
                               self.tr.ctx.world, time.time()))
            if rollback:
                if self.tr._peer_fence is not None:
                    self.tr._peer_fence.drain()  # bounded, before the sync
                self.books = (self.tr._host_step, dict(_ran_books(self.tr)))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = None
    if spec["backend"] == "gloo":
        device = "cuda:0"
        initialize(backend="gloo", init_method=spec["init"],
                   world_size=spec["world"], rank=spec["rank"],
                   device=device, timeout_s=300)
    taken, taken_mark = [], []
    place = DataPipeline._place_indices

    def recorded(self, take, n):
        taken.append([int(self.sampler.epoch), take.tolist()])
        if rollback:
            # A rank that is killed leaves no record: its placements go to
            # a file as they happen.
            with open(spec["out"] + ".taken", "a", encoding="utf-8") as f:
                f.write(json.dumps(taken[-1]) + "\n")
        return place(self, take, n)

    DataPipeline._place_indices = recorded
    rec = {"rank": spec["rank"], "preempted": None, "books": {},
           "wall": {"started": spec["started"], "entered": entered,
                    "imported": time.time()}}
    wall = rec["wall"]

    def stamped(name, fn):
        # The wall clock (comparable across the ranks) at entry and exit.
        def call(*a, **kw):
            wall.setdefault(name + "_start", time.time())
            try:
                return fn(*a, **kw)
            finally:
                wall.setdefault(name + "_end", time.time())
        return call

    if rollback:
        from tpu_dp_torch.resilience.faultinject import FaultInjector

        fire = FaultInjector._fire

        def fire_stamped(self, plan, global_step):
            if plan.kind == "kill":
                # The victim's exit, on the wall clock, before os._exit.
                with open(spec["out"] + ".exit", "w", encoding="utf-8") as f:
                    json.dump({"t": time.time(), "step": global_step}, f)
            return fire(self, plan, global_step)

        FaultInjector._fire = fire_stamped
    t = None
    try:
        _reset_books()
        wall["trainer_start"] = time.time()
        t = Trainer(parse_cli(spec["args"]), device=device)
        wall["trainer_built"] = time.time()
        clock = Boundaries(t)
        t._hooks.insert(-1, clock)
        regroup = t._execute_regroup

        def books_then_regroup(sig):
            taken_mark.append(len(taken))
            if rollback:
                # The saves complete at the failure (the writes in flight
                # joined, as the regroup does first): the newest one at or
                # before the kill is the resume the record must name.
                from tpu_dp_torch.resilience import find_candidates

                t._join_writes()
                rec["candidates"] = [
                    [str(d), int(st)] for d, st in find_candidates(
                        t.cfg.train.ckpt_dir, t.snapshot_dir)]
                # The books at the last boundary (whole updates), and what
                # the failed update launched after it.
                step, booked = clock.books
                now = _ran_books(t)
                rec["books"]["before"] = booked
                rec["books"]["partial"] = {k: now[k] - booked.get(k, 0)
                                           for k in now}
                rec["updates_before"] = step
                rec["failed_at_step"] = t._host_step
            else:
                rec["books"]["before"] = _ran_books(t)
                rec["updates_before"] = t._host_step
            _reset_books()
            return regroup(sig)

        t._execute_regroup = stamped("regroup", books_then_regroup)
        if rollback:
            t._elastic_rollback = stamped("caught", t._elastic_rollback)
            t._load_rollback_state = stamped("reload", t._load_rollback_state)
            el = t.elastic
            el.quiesce_blocking = stamped("collect", el.quiesce_blocking)
            el.reinitialize = stamped("reform", el.reinitialize)
        t0 = time.perf_counter()
        try:
            result = t.fit()
            rec["eval"] = result.get("eval")
            rec["books"]["after"] = _ran_books(t)
        except PreemptedError as e:
            rec["preempted"] = str(e)
            rec["books"]["before"] = _ran_books(t)
            rec["updates_before"] = t._host_step
        rec["fit_s"] = time.perf_counter() - t0
        wall["fit_end"] = time.time()
        h = hashlib.sha256()
        for x in t._replica_tensors():
            h.update(x.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        rec.update(
            sid=t.stable_rank, new_rank=t.ctx.rank, world=t.ctx.world,
            backend=t.ctx.backend, device=str(t.device),
            record=t.elastic.record.to_json(), host_step=t._host_step,
            losses=list(t.step_losses), digest=h.hexdigest(),
            test_batches=len(t.test_pipe), marks=clock.marks,
            captured=getattr(t.multi_step, "captured", None) is not None,
            counters={k: v for k, v in counters.snapshot().items()
                      if k.startswith(("elastic.", "guard."))}, taken=taken,
            taken_before=taken_mark[0] if taken_mark else len(taken))
    finally:
        if t is not None and t.multi_step is not None:
            t.multi_step.close()
        t = None
        shutdown()
    wall["shut_down"] = time.time()
    with open(spec["out"], "w", encoding="utf-8") as f:
        json.dump(rec, f)
    return PreemptedError.exit_code if rec["preempted"] else 0


def _elastic_grow_worker(spec: dict) -> int:
    """One rank of phase 17's grow runs ((f), (g), (h); the spec's
    ``"grow"``): the port's entry point `run_elastic` on ``SPEC["args"]``,
    so that a fired ``relaunch:`` rejoins in this process. Records, across
    both incarnations of a rejoining rank: the index lists its feed
    placed, the books of each world's segment (set to 0 before the fit,
    at every regroup and after the join), the boundaries' clock, wall
    stamps of the grow's steps (departure, request, plan, final snapshot,
    gate, re-form, reload, join), whether the joiner's state right after
    its restore equals the snapshot it loaded, the final record, the
    losses and a digest of the final state; exits 0."""
    import hashlib

    import numpy as np
    import torch

    import tpu_dp_torch.resilience.elastic as el
    import tpu_dp_torch.train.trainer as trainer_mod
    from tpu_dp_torch import checkpoint as ckpt_lib
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.data.pipeline import DataPipeline
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.parallel.dist import initialize, shutdown
    from tpu_dp_torch.train.hooks import StepHook

    taken, marks, events, segments = [], [], [], []
    rec = {"rank": spec["rank"], "wall": {"started": spec["started"],
                                          "imported": time.time()}}

    def event(name):
        events.append([name, time.time()])

    def wrap(cls, attr, name, when=None):
        real = getattr(cls, attr)

        def call(*a, **kw):
            on = when is None or when(*a, **kw)
            if on:
                event(name + "_start")
            out = real(*a, **kw)
            if on:
                event(name + "_end")
            return out
        setattr(cls, attr, call)

    place = DataPipeline._place_indices

    def recorded(self, take, n):
        taken.append([int(self.sampler.epoch), take.tolist()])
        return place(self, take, n)

    DataPipeline._place_indices = recorded
    quiesce_step = el.ElasticCoordinator.quiesce_step

    def quiesce(self, *a, **kw):
        plan = quiesce_step(self, *a, **kw)
        if plan is not None and plan.flavor == "grow":
            event("grow_plan")
        return plan

    el.ElasticCoordinator.quiesce_step = quiesce
    wrap(el.ElasticCoordinator, "ack_and_await_quiesced", "snapshot_acked",
         when=lambda self, plan: plan.flavor == "grow")
    wrap(el.ElasticCoordinator, "reinitialize", "reform")
    wrap(el.MembershipLedger, "publish_join", "request")
    wrap(el.MembershipLedger, "confirm_join_ready", "join_ready")
    wrap(trainer_mod.Trainer, "_grow_gate", "gate")
    wrap(trainer_mod.Trainer, "_complete_join", "join_barrier")

    class Boundaries(StepHook):
        def on_step_end(self, ev):
            marks.append((time.perf_counter(), self.tr._host_step,
                          self.tr.ctx.world, time.time()))

    def close_segment(t, evals=0):
        segments.append({"world": t.ctx.world, "from": seg_from[0],
                         "to": t._host_step, "evals": evals,
                         "books": dict(_ran_books(t))})
        _reset_books()

    seg_from = [0]

    class Instrumented(trainer_mod.Trainer):
        """The port's Trainer with the phase's clock, books and stamps."""

        def __init__(self, cfg, device=None):
            super().__init__(cfg, device=device)
            self._hooks.insert(-1, Boundaries(self))
            if self._join is not None:
                # The joiner's books start at its admission.
                _reset_books()
                seg_from[0] = self._host_step

        def _adopt_join_resume(self, record):
            event("reload_start")
            super()._adopt_join_resume(record)
            event("reload_end")
            snap = (record.resume or {}).get("snapshot_dir")
            raw, _ = ckpt_lib.read_checkpoint(snap)
            want = dict(ckpt_lib._walk_state_dict(raw))
            mine = dict(ckpt_lib._walk_state_dict(
                ckpt_lib.state_dict_of(self.state)))
            rec["adopted_snapshot"] = snap
            rec["adopted_equals_snapshot"] = mine.keys() == want.keys() \
                and all(np.asarray(mine[k]).tobytes()
                        == np.asarray(want[k]).tobytes() for k in want)

        def _execute_regroup(self, sig):
            close_segment(self)
            t0 = time.perf_counter()
            out = super()._execute_regroup(sig)
            rec.setdefault("regroup_s", []).append(time.perf_counter() - t0)
            seg_from[0] = self._host_step
            return out

        def fit(self):
            try:
                return super().fit()
            except trainer_mod.PreemptedError:
                close_segment(self)
                rec["departed_at"] = self._host_step
                event("departed")
                raise

    trainer_mod.Trainer = Instrumented
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = None
    if spec["backend"] == "gloo":
        device = "cuda:0"
        initialize(backend="gloo", init_method=spec["init"],
                   world_size=spec["world"], rank=spec["rank"],
                   device=device, timeout_s=300)
    t = None
    try:
        _reset_books()
        cfg = parse_cli(spec["args"])
        t0 = time.perf_counter()
        t, result = trainer_mod.run_elastic(cfg, device=device)
        rec["fit_s"] = time.perf_counter() - t0
        rec["eval"] = result.get("eval")
        close_segment(t, evals=len(t.test_pipe))
        h = hashlib.sha256()
        for x in t._replica_tensors():
            h.update(x.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        rec.update(
            sid=t.stable_rank, new_rank=t.ctx.rank, world=t.ctx.world,
            backend=t.ctx.backend, record=t.elastic.record.to_json(),
            host_step=t._host_step, losses=list(t.step_losses),
            digest=h.hexdigest(), marks=marks, events=events,
            segments=segments, taken=taken,
            captured=getattr(t.multi_step, "captured", None) is not None,
            counters={k: v for k, v in counters.snapshot().items()
                      if k.startswith("elastic.")})
    finally:
        if t is not None and t.multi_step is not None:
            t.multi_step.close()
        t = None
        shutdown()
    rec["wall"]["shut_down"] = time.time()
    with open(spec["out"], "w", encoding="utf-8") as f:
        json.dump(rec, f)
    return 0


def _start_elastic_ranks(work: str, backend: str, world: int,
                         args: list, rollback: bool = False,
                         grow: bool = False) -> list:
    """`elastic_worker` ranks, started: gloo ranks on cuda:0 meeting
    through a ``file://`` rendezvous in ``work``, or NCCL ranks on cards
    0..world-1 through the env contract at a free loopback port."""
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    port = _free_port()
    procs = []
    for rank in range(world):
        spec = {"rank": rank, "world": world, "backend": backend,
                "init": "file://" + os.path.join(work, "rendezvous"),
                "args": args + [f"--train.ckpt_dir={work}/ck"],
                "out": os.path.join(work, f"rank{rank}.json"),
                "rollback": rollback, "grow": grow, "started": time.time()}
        path = os.path.join(work, f"spec{rank}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        env.pop("TPU_DP_FAULT", None)
        if backend == "nccl":
            env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--elastic-worker",
             path], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _elastic_oracle(args, record: dict, world0: int, epochs: int):
    """The one-process oracle of a run with one regroup (`record`)."""
    return _elastic_chain_oracle(args, [record], world0, epochs)


def _elastic_chain_oracle(args, records: list, world0: int, epochs: int):
    """The one-process oracle of an elastic run on the card: the global
    batches rebuilt from the published records alone (``records``: every
    record after epoch 0, in order), each one update of a port `Trainer`
    alone from the same seed, its schedule switched at each regroup to the
    one the members rebuilt and its draws those of the whole global batch.
    For each dataset epoch the newest record whose resume names it gives
    the epoch's whole consumption lineage (segment i: its updates at its
    world on `elastic_resplit` of the segments before it, the first on
    `ShardedSampler`), the rest runs re-split at that record's world; an
    epoch no regroup touched runs at the world current when it started.
    Returns the per-update losses and, per epoch, the indices consumed."""
    import numpy as np
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.data.augment import make_augment_fn
    from tpu_dp_torch.data.sampler import ShardedSampler, elastic_resplit
    from tpu_dp_torch.train.schedule import lr_table, make_schedule
    from tpu_dp_torch.train.trainer import Trainer

    t = Trainer(parse_cli(args + ["--train.steps_per_call=1"]),
                device="cuda:0")
    cfg, body = t.cfg, t.step_body
    n_ex, b = len(t.train_ds), cfg.data.batch_size

    def streams(epoch, prior, world):
        if prior:
            return [elastic_resplit(n_ex, True, cfg.train.seed, epoch, b,
                                    prior, world, r) for r in range(world)]
        out = []
        for r in range(world):
            smp = ShardedSampler(n_ex, world, r, shuffle=True,
                                 seed=cfg.train.seed)
            smp.set_epoch(epoch)
            out.append(smp.shard_indices())
        return out

    def segments(epoch):
        touching = [r for r in records
                    if int((r.get("resume") or {}).get("epoch", -1)) == epoch]
        if touching:
            lineage = [[int(w), int(n)]
                       for w, n in touching[-1]["resume"]["lineage"]]
            return ([(lineage[:i], w, n) for i, (w, n) in enumerate(lineage)]
                    + [(lineage, int(touching[-1]["world"]), None)])
        world = world0
        for r in records:
            if int((r.get("resume") or {}).get("epoch", 10**9)) < epoch:
                world = int(r["world"])
        return [([], world, None)]

    def use_world(world):
        spe = (-(-n_ex // world)) // b
        sched = make_schedule(cfg.optim.schedule, cfg.optim.lr,
                              spe * cfg.train.epochs,
                              int(cfg.optim.warmup_epochs * spe),
                              cfg.optim.final_lr)
        body.schedule, body.lr_table = sched, lr_table(sched, t.device)

    body.augment_fn = make_augment_fn(cfg.train.seed + 1)
    losses, consumed = [], {}
    images = torch.from_numpy(t.train_ds.images)
    labels = torch.from_numpy(t.train_ds.labels).long()
    for epoch in range(epochs):
        for prior, world, steps in segments(epoch):
            use_world(world)
            ss = streams(epoch, prior, world)
            n = min(len(x) for x in ss) // b if steps is None else steps
            for k in range(n):
                sel = np.concatenate([x[k * b:(k + 1) * b] for x in ss])
                consumed.setdefault(epoch, []).extend(sel.tolist())
                m = t.train_step(t.state, {
                    "image": images[sel].to(t.device),
                    "label": labels[sel].to(t.device)})
                losses.append(m["loss"])
    return torch.stack(losses).tolist(), consumed


def _start_elastic(key: str, backend: str, world: int, args: list,
                   rollback: bool = False, grow: bool = False) -> dict:
    """One run's `elastic_worker` ranks, started, with the run's deadline
    (`ELASTIC_RANK_DEADLINE_S`)."""
    work = os.path.join(HERE, "build", "elastic_smoke",
                        f"{os.getpid()}-{key}")
    return {"key": key, "work": work, "t0": time.perf_counter(),
            "deadline": time.monotonic() + ELASTIC_RANK_DEADLINE_S,
            "procs": _start_elastic_ranks(work, backend, world, args,
                                          rollback=rollback, grow=grow)}


def _await_started(started: dict) -> list[str]:
    return _await_ranks(started["procs"], started["key"], max(
        1.0, started["deadline"] - time.monotonic()))


def _elastic_run(out, started: dict, backend: str, world: int,
                 victim: int, args: list) -> dict:
    """One graceful shrink of phase 17, its ranks started (`_start_elastic`
    on ``args``), and its checks (module docstring)."""
    key, work, procs = started["key"], started["work"], started["procs"]
    logs = _await_started(started)
    ranks_s = time.perf_counter() - started["t0"]
    rcs = [p.returncode for p in procs]
    want_rc = [143 if r == victim else 0 for r in range(world)]
    if rcs != want_rc:
        for rank, log in enumerate(logs):
            print(f"[{key}] rank {rank} rc {rcs[rank]}:\n{log[-3000:]}")
        raise AssertionError(f"{key}: exit codes {rcs}, want {want_rc}")
    res = {}
    for rank in range(world):
        with open(os.path.join(work, f"rank{rank}.json"),
                  encoding="utf-8") as f:
            res[rank] = json.load(f)
    survivors = [r for r in range(world) if r != victim]
    a = res[survivors[0]]
    record = a["record"]
    stop = int(record["resume"]["global_step"])
    gen = os.path.join(work, "ck", "membership")
    gen = os.path.join(gen, os.listdir(gen)[0])
    names = set(os.listdir(gen))
    with open(os.path.join(gen, "plan_e0001.json"), encoding="utf-8") as f:
        plan = json.load(f)
    with open(os.path.join(work, "ck", "snapshots", f"step_{stop:010d}",
                           "meta.json"), encoding="utf-8") as f:
        snap = json.load(f)
    # The books of every rank at both worlds (set to 0 before the fit and
    # at the regroup): per update 20 conv, 1 + 1 xent and one draw; 10 conv
    # an eval forward (the survivors' eval at the end).
    books_ok = {}
    for r, x in res.items():
        segs = [(x["books"]["before"], x["updates_before"], 0)]
        if r != victim:
            segs.append((x["books"]["after"],
                         x["host_step"] - x["updates_before"],
                         x["test_batches"]))
        books_ok[r] = x["updates_before"] == stop and all(
            _books_exact(got, u, ev) for got, u, ev in segs)
    epochs = int([a for a in args if a.startswith("--train.epochs=")][-1]
                 .split("=")[1])
    oracle, consumed = _elastic_oracle(
        [x for x in args if not x.startswith("--resilience.")]
        + [f"--train.ckpt_dir={work}/oracle"], record, world, epochs)
    diffs = [abs(p - q) for p, q in zip(a["losses"], oracle)]
    bound = diffs[:stop + ELASTIC_ORACLE_AFTER]
    # Coverage per epoch, read from the ranks' index lists, against the
    # record's prediction.
    took: dict = {}
    for x in res.values():
        for epoch, idx in x["taken"]:
            took.setdefault(epoch, []).extend(idx)
    n_ex = next(int(v.split("=")[1]) for v in args
                if v.startswith("--data.synthetic_train_size="))
    coverage = {e: {"consumed": len(took.get(e, [])),
                    "distinct": len(set(took.get(e, []))),
                    "dropped": n_ex - len(set(took.get(e, []))),
                    "predicted_dropped": n_ex - len(set(consumed[e]))}
                for e in consumed}

    def rates(x, w):
        # Host ms per update between boundaries (the first one of each
        # world left out): the update's time where each update waits on
        # the group (gloo's collectives on CUDA tensors, (a)); under
        # captured windows, (b), the host's dispatch rate.
        m = [(t, s) for t, s, ww, *_ in x["marks"] if ww == w]
        per = [1e3 * (t1 - t0_) / (s1 - s0) for (t0_, s0), (t1, s1)
               in zip(m[1:], m[2:]) if s1 > s0]
        return statistics.median(per) if per else None

    checks = {
        "exit_codes": rcs == want_rc,
        "ledger_files": {"epoch_0000.json", "plan_e0001.json",
                         f"left_r{victim:05d}.json", "epoch_0001.json"}
        | {f"q_e0001_r{r:05d}.json" for r in range(world)}
        | {f"q_e0001_r{r:05d}.done" for r in range(world)} <= names,
        "plan_graceful": plan["flavor"] == "graceful"
        and plan["leavers"] == [victim] and plan["survivors"] == survivors,
        "record_world": record["epoch"] == 1
        and record["members"] == survivors and record["world"] == world - 1,
        "lineage": snap["membership"]["lineage"] == [[world, stop]]
        and record["resume"]["lineage"] == [[world, stop]],
        "stop_inside_epoch_1": 0 < stop < (-(-n_ex // world)) // TRAIN_B,
        "dense_ranks": [res[s]["new_rank"] for s in survivors]
        == list(range(world - 1))
        and all(res[s]["world"] == world - 1 for s in survivors),
        "backend_kept": all(res[s]["backend"] == backend for s in survivors),
        "survivors_bit_identical": len({res[s]["digest"]
                                        for s in survivors}) == 1,
        "losses_track_oracle": len(a["losses"]) == len(oracle)
        and max(bound) <= DDP_LOSS_TOL,
        "losses_finite": all(math.isfinite(v) for v in a["losses"]),
        "coverage_equals_record": all(
            sorted(took.get(e, [])) == sorted(consumed[e])
            for e in consumed),
        "drop_as_predicted": all(c["dropped"] == c["predicted_dropped"]
                                 for c in coverage.values()),
        "books_per_rank_at_both_worlds": all(books_ok.values()),
        "regroups_1": all(res[s]["counters"].get("elastic.regroups") == 1
                          for s in survivors),
    }
    rec = {"checks": checks, "rcs": rcs, "stop_step": stop,
           "record": record, "plan": plan, "coverage": coverage,
           "losses": a["losses"], "oracle_losses": oracle,
           "max_loss_diff": max(diffs) if diffs else None,
           "max_loss_diff_bound": max(bound) if bound else None,
           "regroup_s": {s: res[s]["counters"].get("elastic.regroup_s")
                         for s in survivors},
           "ms_per_update": {f"world_{world}": rates(a, world),
                             f"world_{world - 1}": rates(a, world - 1)},
           "books": {r: x["books"] for r, x in res.items()},
           "fit_s": {r: x["fit_s"] for r, x in res.items()},
           "rank_s": {r: _rank_seconds(x) for r, x in res.items()},
           "ranks_s": ranks_s, "captured": a.get("captured")}
    out["elastic"][key] = rec
    print(f"[{key}] " + json.dumps({k: v for k, v in rec.items()
                                    if k not in ("losses", "oracle_losses",
                                                 "record")}))
    print(f"[{key}] {backend} world {world} -> {world - 1} (rank {victim} "
          f"left at update {stop}): regroup "
          f"{max(rec['regroup_s'].values()):.2f} s, ms per update "
          f"{rec['ms_per_update']}, ranks {ranks_s:.1f} s")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def _await_ranks(procs, key: str, deadline_s: float | None = None
                 ) -> list[str]:
    """Every rank's log, each rank within ``deadline_s`` of the call; past
    it every rank still running dumps its threads' stacks (SIGUSR1, the
    worker's `faulthandler`), is killed, and the phase fails naming the
    rank it waited for. The logs go to ``chiprun_out/<key>_rank<r>.log``
    either way."""
    import signal

    if deadline_s is None:
        deadline_s = ELASTIC_RANK_DEADLINE_S
    deadline = time.monotonic() + deadline_s
    logs, late = [], None
    try:
        for rank, p in enumerate(procs):
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                late = rank
                break
    finally:
        running = [p for p in procs if p.poll() is None]
        for p in running:
            p.send_signal(signal.SIGUSR1)
        if running:
            time.sleep(3)
        for p in running:
            p.kill()
        for p in procs[len(logs):]:
            logs.append(p.communicate(timeout=30)[0])
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    for rank, log in enumerate(logs):
        with open(os.path.join(HERE, "chiprun_out",
                               f"elastic_{key}_rank{rank}.log"), "w",
                  encoding="utf-8") as f:
            f.write(log)
    if late is not None:
        print(f"[{key}] rank {late}, its log's end:\n{logs[late][-6000:]}")
        raise AssertionError(f"{key}: rank {late} did not finish within "
                             f"{deadline_s:g} s; every rank killed")
    return logs


def _rank_seconds(x: dict) -> dict:
    """Where a rank process's wall time went, from its stamps: start-up
    (the interpreter and imports), the `Trainer` built, the fit, the
    teardown (its group shut down)."""
    w = x["wall"]
    return {"start_up": w["imported"] - w["started"],
            "trainer": w["trainer_built"] - w["trainer_start"],
            "fit": w["fit_end"] - w["trainer_built"],
            "teardown": w["shut_down"] - w["fit_end"]}


def _books_exact(got: dict, updates: int, evals: int, convs: int = 10,
                 draws: int = 1) -> bool:
    """``got`` is the books of ``updates`` whole updates and ``evals``
    eval forwards: ``convs`` + ``convs`` conv, 1 + 1 xent and ``draws``
    draws an update, ``convs`` conv an eval forward."""
    return (got.get("conv.stats", 0) == convs * updates
            and got.get("conv.input_grad", 0) == convs * updates
            and got.get("xent.forward", 0) == updates
            and got.get("xent.backward", 0) == updates
            and got.get("augment", 0) == draws * updates
            and got.get("conv.eval", 0) == convs * evals)


def _resumed_coverage(res: dict, resume: dict, b: int) -> dict:
    """Per epoch, the indices every rank's feed consumed (``res``: rank ->
    its placements, and how many came before the regroup), counted from
    the resume point: before the regroup only the resumed segment's first
    ``steps_done`` updates of each rank (those after it were thrown away
    and replayed), then everything after the regroup."""
    import numpy as np

    kept = int(resume["lineage"][0][1]) if resume["lineage"] else 0
    interrupted = int(resume["epoch"])
    took: dict = {}
    for x in res.values():
        before, after = x["taken"][:x["taken_before"]], \
            x["taken"][x["taken_before"]:]
        mine: dict = {}
        for epoch, idx in before:
            mine.setdefault(epoch, []).extend(np.ravel(idx).tolist())
        for epoch, idx in mine.items():
            took.setdefault(epoch, []).extend(
                idx[:kept * b] if epoch == interrupted else idx)
        for epoch, idx in after:
            took.setdefault(epoch, []).extend(np.ravel(idx).tolist())
    return took


def _elastic_rollback_run(out, key: str, backend: str, world: int,
                          victim: int, kill_step: int, args: list,
                          eager: bool = True, on_exit=None) -> dict:
    """One rollback of phase 17 ((c), (e)) and its checks (module
    docstring): ``kill:step=kill_step`` on ``victim``; ``eager``: one
    update a call (the failed update's launches are then checked to be a
    prefix of one update; a window's replay has no per-update books).
    ``on_exit`` is called once the victim has exited, while the survivors
    wait out the collection window."""
    started = _start_elastic(key, backend, world, args + [
        f"--resilience.snapshot_every_steps={ELASTIC_SNAP_EVERY}",
        f"--resilience.regroup_timeout_s={ELASTIC_WINDOW_S}",
        f"--resilience.fault=kill:step={kill_step},rank={victim}"],
        rollback=True)
    work, procs, t0 = started["work"], started["procs"], started["t0"]
    if on_exit is not None:
        exit_path = os.path.join(work, f"rank{victim}.json.exit")
        deadline = time.monotonic() + ELASTIC_RANK_DEADLINE_S
        while not os.path.exists(exit_path):
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                break  # the ranks' own checks below name what went wrong
            time.sleep(0.05)
        else:
            on_exit()
    logs = _await_started(started)
    ranks_s = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    want_rc = [137 if r == victim else 0 for r in range(world)]
    if rcs != want_rc:
        for rank, log in enumerate(logs):
            print(f"[{key}] rank {rank} rc {rcs[rank]}:\n{log[-3000:]}")
        raise AssertionError(f"{key}: exit codes {rcs}, want {want_rc}")
    survivors = [r for r in range(world) if r != victim]
    res = {}
    for rank in survivors:
        with open(os.path.join(work, f"rank{rank}.json"),
                  encoding="utf-8") as f:
            res[rank] = json.load(f)
    with open(os.path.join(work, f"rank{victim}.json.exit"),
              encoding="utf-8") as f:
        exit_rec = json.load(f)
    a = res[survivors[0]]
    record = a["record"]
    resume = record["resume"]
    start = int(resume["global_step"])
    gen = os.path.join(work, "ck", "membership")
    gen = os.path.join(gen, os.listdir(gen)[0])
    with open(os.path.join(gen, "plan_e0001.json"), encoding="utf-8") as f:
        plan = json.load(f)
    # The newest complete save at or before the kill, as the saves stood
    # at the failure.
    cands = [(d, st) for d, st in a["candidates"] if st <= exit_rec["step"]]
    epochs = int([v for v in args if v.startswith("--train.epochs=")][-1]
                 .split("=")[1])
    n_ex = next(int(v.split("=")[1]) for v in args
                if v.startswith("--data.synthetic_train_size="))
    b = TRAIN_B
    oracle, consumed = _elastic_oracle(
        [x for x in args if not x.startswith("--resilience.")]
        + [f"--train.ckpt_dir={work}/oracle"], record, world, epochs)
    diffs = [abs(p - q) for p, q in zip(a["losses"], oracle)]
    bound = diffs[:start + ELASTIC_ORACLE_AFTER]
    with open(os.path.join(work, f"rank{victim}.json.taken"),
              encoding="utf-8") as f:
        victim_taken = [json.loads(line) for line in f]
    took = _resumed_coverage(
        {**res, victim: {"taken": victim_taken,
                         "taken_before": len(victim_taken)}}, resume, b)
    # The books: whole updates at the last boundary before the failure,
    # then the failed update's launches (a prefix of one update: its draw,
    # before the first collective failed), then the replay and the rest
    # at the new world with the final eval.
    books_ok, partial_ok = {}, {}
    for r in survivors:
        x = res[r]
        bk = x["books"]
        books_ok[r] = (
            x["updates_before"] == exit_rec["step"]
            and _books_exact(bk["before"], x["updates_before"], 0)
            and _books_exact(bk["after"], x["host_step"] - start,
                             x["test_batches"]))
        one = {"conv.stats": 10, "conv.input_grad": 10, "xent.forward": 1,
               "xent.backward": 1, "augment": 1, "conv.eval": 0}
        partial_ok[r] = not eager or all(
            0 <= bk["partial"].get(k, 0) <= v for k, v in one.items())
    w = {r: res[r]["wall"] for r in survivors}
    t_exit = exit_rec["t"]

    def first_at(x, world_, step=0):
        got = [m[3] for m in x["marks"] if m[2] == world_ and m[1] > step]
        return got[0] if got else None

    split = {}
    for r in survivors:
        x, ww = res[r], w[r]
        first2 = first_at(x, world - 1)
        replayed = first_at(x, world - 1, x["failed_at_step"] - 1)
        split[r] = {
            "detection_s": ww["caught_start"] - t_exit,
            "collection_s": ww["collect_end"] - ww["collect_start"],
            "barrier_s": ww["regroup_start"] - ww["collect_end"],
            "reform_s": ww["reform_end"] - ww["regroup_start"],
            "rebuild_s": ww["reload_start"] - ww["reform_end"],
            "reload_s": ww["reload_end"] - ww["reload_start"],
            "regroup_s": ww["regroup_end"] - ww["regroup_start"],
            "replay_s": replayed - ww["regroup_end"] if replayed else None,
            "exit_to_first_update_s": first2 - t_exit if first2 else None}

    def rates(x, world_):
        m = [(t, st) for t, st, ww, *_ in x["marks"] if ww == world_]
        per = [1e3 * (t1 - t0_) / (s1 - s0) for (t0_, s0), (t1, s1)
               in zip(m[1:], m[2:]) if s1 > s0]
        return statistics.median(per) if per else None

    checks = {
        "exit_codes": rcs == want_rc,
        "plan_rollback_timeout": plan["flavor"] == "rollback"
        and plan["departed"] == [{"sid": victim,
                                  "reason": "no quiesce check-in (timeout)"}]
        and plan["leavers"] == [] and plan["survivors"] == survivors,
        "no_live_rank_departed": [d["sid"] for d in record["departed"]]
        == [victim],
        "record_rollback_world": record["epoch"] == 1
        and record["reason"] == "rollback"
        and record["members"] == survivors and record["world"] == world - 1,
        "resume_newest_complete_snapshot": bool(cands)
        and resume["snapshot_dir"] == cands[0][0]
        and all(x["candidates"] == a["candidates"] for x in res.values())
        and resume["lineage"] == [[world, start]]
        and 0 < start <= exit_rec["step"],
        "dense_ranks": [res[s]["new_rank"] for s in survivors]
        == list(range(world - 1))
        and all(res[s]["world"] == world - 1 for s in survivors),
        "backend_kept": all(res[s]["backend"] == backend for s in survivors),
        "survivors_bit_identical": len({res[s]["digest"]
                                        for s in survivors}) == 1,
        "losses_track_oracle": len(a["losses"]) == len(oracle)
        and max(bound) <= DDP_LOSS_TOL,
        "losses_finite": all(math.isfinite(v) for v in a["losses"]),
        "coverage_from_resume_equals_record": all(
            sorted(took.get(e, [])) == sorted(consumed[e])
            for e in consumed),
        "books_per_rank_at_both_worlds_replay_included":
            all(books_ok.values()),
        "failed_update_books_a_prefix": all(partial_ok.values()),
        "regroups_1": all(res[s]["counters"].get("elastic.regroups") == 1
                          for s in survivors),
    }
    rec = {"checks": checks, "rcs": rcs, "kill_step": exit_rec["step"],
           "resume_step": start, "record": record, "plan": plan,
           "losses": a["losses"], "oracle_losses": oracle,
           "max_loss_diff": max(diffs) if diffs else None,
           "max_loss_diff_bound": max(bound) if bound else None,
           "split_s": split,
           "ms_per_update": {f"world_{world}": rates(a, world),
                             f"world_{world - 1}": rates(a, world - 1)},
           "books": {r: x["books"] for r, x in res.items()},
           "fit_s": {r: x["fit_s"] for r, x in res.items()},
           "rank_s": {r: _rank_seconds(x) for r, x in res.items()},
           "ranks_s": ranks_s, "captured": a.get("captured"),
           "coverage": {e: {"consumed": len(took.get(e, [])),
                            "predicted": len(consumed[e]),
                            "dropped": n_ex - len(set(took.get(e, [])))}
                        for e in consumed}}
    out["elastic"][key] = rec
    print(f"[{key}] " + json.dumps({k: v for k, v in rec.items()
                                    if k not in ("losses", "oracle_losses",
                                                 "record")}))
    s0 = split[survivors[0]]
    print(f"[{key}] {backend} world {world} -> {world - 1} (rank {victim} "
          f"killed at update {exit_rec['step']}, resumed at {start}): "
          f"exit -> first update at world {world - 1} "
          f"{s0['exit_to_first_update_s']:.2f} s (detection "
          f"{s0['detection_s']:.2f}, window {s0['collection_s']:.2f}, "
          f"re-form {s0['reform_s']:.2f}, rebuild {s0['rebuild_s']:.2f}, "
          f"reload {s0['reload_s']:.2f}, "
          f"replay {s0['replay_s'] or 0:.2f}); ms per update "
          f"{rec['ms_per_update']}; ranks {ranks_s:.1f} s")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def _elastic_sdc_run(out, started: dict) -> dict:
    """(d): the guard's SDC eviction through the ledger on three gloo ranks
    of Net on the card, started (`_start_elastic` on `ELASTIC_SDC_ARGS`),
    and its checks (module docstring)."""
    from tpu_dp_torch.resilience import QuarantineLog

    world, victim = 3, 2
    key, work, procs = started["key"], started["work"], started["procs"]
    logs = _await_started(started)
    ranks_s = time.perf_counter() - started["t0"]
    rcs = [p.returncode for p in procs]
    want_rc = [143 if r == victim else 0 for r in range(world)]
    if rcs != want_rc:
        for rank, log in enumerate(logs):
            print(f"[{key}] rank {rank} rc {rcs[rank]}:\n{log[-3000:]}")
        raise AssertionError(f"{key}: exit codes {rcs}, want {want_rc}")
    res = {}
    for rank in range(world):
        with open(os.path.join(work, f"rank{rank}.json"),
                  encoding="utf-8") as f:
            res[rank] = json.load(f)
    survivors = [0, 1]
    a = res[0]
    record = a["record"]
    ck = os.path.join(work, "ck")
    with open(os.path.join(ck, "obs", f"flightrec_r{victim:05d}.json"),
              encoding="utf-8") as f:
        black_box = json.load(f)
    sdc = [r for r in QuarantineLog(os.path.join(ck, "quarantine.jsonl"))
           .read() if r["kind"] == "sdc"]
    start = int(record["resume"]["global_step"])
    books_ok = {}
    for r, x in res.items():
        bk = x["books"]
        segs = [(bk["before"], x["updates_before"])]
        if r != victim:
            segs.append((bk["after"], x["host_step"] - start))
        books_ok[r] = all(_books_exact(got, u, 0, convs=0, draws=0)
                          for got, u in segs)
    checks = {
        "exit_codes": rcs == want_rc,
        "evicted_with_guard_evict": "elastic departure"
        in (res[victim]["preempted"] or "") and any(
            e["kind"] == "guard_evict" for e in black_box["events"]),
        "record_rollback_sdc": record["epoch"] == 1
        and record["reason"] == "rollback"
        and record["members"] == survivors
        and [d["sid"] for d in record["departed"]] == [victim]
        and "sdc" in record["departed"][0]["reason"].lower(),
        "resume_predates_the_flip": int(record["resume"]["lineage"][0][1])
        <= 3,
        "quarantine_names_rank_2": bool(sdc) and sdc[0]["suspects"]
        == [victim],
        "survivors_bit_identical_finish": len({res[s]["digest"]
                                               for s in survivors}) == 1
        and all(res[s]["world"] == 2 and res[s]["preempted"] is None
                for s in survivors),
        "xent_books_exact": all(books_ok.values()),
        "audit_counted": all(res[s]["counters"].get(
            "guard.sdc_mismatches", 0) >= 1 for s in survivors),
    }
    rec = {"checks": checks, "rcs": rcs, "record": record,
           "quarantine": sdc, "books": {r: x["books"] for r, x in res.items()},
           "fit_s": {r: x["fit_s"] for r, x in res.items()},
           "rank_s": {r: _rank_seconds(x) for r, x in res.items()},
           "regroup_s": {s: res[s]["counters"].get("elastic.regroup_s")
                         for s in survivors},
           "ranks_s": ranks_s}
    out["elastic"][key] = rec
    print(f"[{key}] " + json.dumps({k: v for k, v in rec.items()
                                    if k != "record"}))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        for rank, log in enumerate(logs):
            print(f"[{key}] rank {rank}:\n{log[-2000:]}")
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def _ledger_records(work: str) -> tuple[str, list]:
    """The run's generation directory and its records, in order."""
    gen = os.path.join(work, "ck", "membership")
    gen = os.path.join(gen, os.listdir(gen)[0])
    recs = []
    for name in sorted(os.listdir(gen)):
        if name.startswith("epoch_") and name.endswith(".json"):
            with open(os.path.join(gen, name), encoding="utf-8") as f:
                recs.append(json.load(f))
    return gen, recs


def _last_event(x: dict, name: str):
    got = [t for n, t in x["events"] if n == name]
    return got[-1] if got else None


def _segment_books_exact(x: dict, convs: int = 10, draws: int = 1) -> bool:
    """Every world's segment of a rank (`_elastic_grow_worker`) holds the
    books of its updates and evals exactly."""
    return bool(x["segments"]) and all(
        _books_exact(sg["books"], sg["to"] - sg["from"], sg["evals"],
                     convs=convs, draws=draws) for sg in x["segments"])


def _elastic_grow_run(out, started: dict, backend: str, world: int,
                      victim: int, args: list, fleet: bool = False) -> dict:
    """(f) and (h): one relaunch of phase 17, its ranks started
    (`_start_elastic` on ``args`` with ``grow``), and its checks (module
    docstring); with ``fleet`` (the ranks beat, ``train.obs=basic``) the
    post-hoc tools over its run directory too (`_fleet_checks`)."""
    key, work, procs = started["key"], started["work"], started["procs"]
    logs = _await_started(started)
    ranks_s = time.perf_counter() - started["t0"]
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        for rank, log in enumerate(logs):
            print(f"[{key}] rank {rank} rc {rcs[rank]}:\n{log[-3000:]}")
        raise AssertionError(f"{key}: exit codes {rcs}, want all 0")
    res = {}
    for rank in range(world):
        with open(os.path.join(work, f"rank{rank}.json"),
                  encoding="utf-8") as f:
            res[rank] = json.load(f)
    gen, records = _ledger_records(work)
    shrink, grow = (records + [{}, {}])[1:3]
    with open(os.path.join(gen, f"join_e0002_r{victim:05d}.json"),
              encoding="utf-8") as f:
        request = json.load(f)
    with open(os.path.join(gen, "grow_verdict_e0002.json"),
              encoding="utf-8") as f:
        verdict = json.load(f)
    a, j = res[0], res[victim]
    epochs = int([v for v in args if v.startswith("--train.epochs=")][-1]
                 .split("=")[1])
    n_ex = next(int(v.split("=")[1]) for v in args
                if v.startswith("--data.synthetic_train_size="))
    oracle, consumed = _elastic_chain_oracle(
        [x for x in args if not x.startswith("--resilience.")]
        + [f"--train.ckpt_dir={work}/oracle"], records[1:], world, epochs)
    diffs = [abs(p - q) for p, q in zip(a["losses"], oracle)]
    stop = int(grow.get("resume", {}).get("global_step", 0))
    bound = diffs[:stop + ELASTIC_ORACLE_AFTER]
    took: dict = {}
    for x in res.values():
        for epoch, idx in x["taken"]:
            took.setdefault(epoch, []).extend(idx)
    worlds = {r: [sg["world"] for sg in x["segments"]]
              for r, x in res.items()}
    incumbents = [r for r in range(world) if r != victim]

    def stretch_rates(x):
        out_, cur, w0 = [], [], None
        for t, st, ww, *_ in x["marks"]:
            if w0 is not None and ww != w0:
                out_.append((w0, cur))
                cur = []
            w0 = ww
            cur.append((t, st))
        out_.append((w0, cur))
        return [{"world": w, "ms_per_update": statistics.median(
            [1e3 * (t1 - t0_) / (s1 - s0) for (t0_, s0), (t1, s1)
             in zip(c[1:], c[2:]) if s1 > s0] or [float("nan")])}
            for w, c in out_]

    split = {
        "joiner_rebuild_s": _last_event(j, "request_start")
        - _last_event(j, "departed"),
        "request_to_plan_s": _last_event(a, "grow_plan")
        - _last_event(j, "request_start"),
        "quiesce_to_snapshot_s": _last_event(a, "snapshot_acked_start")
        - _last_event(a, "grow_plan"),
        "join_ready_gate_s": _last_event(a, "gate_end")
        - _last_event(a, "gate_start"),
        "reform_s": _last_event(a, "reform_end")
        - _last_event(a, "reform_start"),
        "joiner_reload_s": _last_event(j, "reload_end")
        - _last_event(j, "reload_start"),
        "departure_to_joined_s": _last_event(j, "join_barrier_end")
        - _last_event(j, "departed")}
    checks = {
        "exit_codes": rcs == [0] * world,
        "records_shrink_then_grow": [r.get("world") for r in records]
        == [world, world - 1, world],
        "record_1_graceful": shrink.get("reason") == "graceful"
        and [d["sid"] for d in shrink.get("departed", [])] == [victim],
        "record_2_grow_echoes_token": grow.get("reason") == "grow"
        and grow.get("joined") == [{"sid": victim,
                                    "token": request["token"]}]
        and grow.get("members") == list(range(world))
        and grow.get("service_sid") == 0 and verdict["commit"] is True,
        "joiner_state_equals_snapshot": j.get("adopted_equals_snapshot")
        is True and j.get("adopted_snapshot")
        == grow.get("resume", {}).get("snapshot_dir"),
        "all_bit_identical": len({x["digest"] for x in res.values()}) == 1
        and all(x["world"] == world and x["record"] == grow
                for x in res.values()),
        "losses_track_oracle": len(a["losses"]) == len(oracle)
        and bool(bound) and max(bound) <= DDP_LOSS_TOL,
        "losses_finite": all(math.isfinite(v) for v in a["losses"]),
        "coverage_equals_records": all(
            sorted(took.get(e, [])) == sorted(consumed[e])
            for e in consumed) and all(
            len(set(took.get(e, []))) == len(took.get(e, []))
            for e in consumed),
        "books_per_rank_at_every_world": all(
            _segment_books_exact(x) for x in res.values())
        and all(worlds[r] == [world, world - 1, world] for r in incumbents)
        and worlds[victim] == [world, world],
        "regroups_2": all(res[r]["counters"].get("elastic.regroups") == 2
                          for r in incumbents)
        and j["counters"].get("elastic.joins") == 1,
    }
    fleet_rec = None
    if fleet:
        fleet_rec = _fleet_checks(os.path.join(work, "ck"), records,
                                  a.get("host_step"))
        checks.update({f"obsctl_{k}": v
                       for k, v in fleet_rec["checks"].items()})
    rec = {"checks": checks, "rcs": rcs, "records": records,
           "losses": a["losses"], "oracle_losses": oracle,
           "max_loss_diff": max(diffs) if diffs else None,
           "max_loss_diff_bound": max(bound) if bound else None,
           "grow_split_s": split,
           "regroup_s": {r: x.get("regroup_s") for r, x in res.items()},
           "ms_per_update": stretch_rates(a),
           "coverage": {e: {"consumed": len(took.get(e, [])),
                            "distinct": len(set(took.get(e, []))),
                            "dropped": n_ex - len(set(took.get(e, [])))}
                        for e in consumed},
           "segments": {r: x["segments"] for r, x in res.items()},
           "fit_s": {r: x["fit_s"] for r, x in res.items()},
           "ranks_s": ranks_s, "captured": a.get("captured"),
           "obsctl": fleet_rec}
    out["elastic"][key] = rec
    print(f"[{key}] " + json.dumps({k: v for k, v in rec.items()
                                    if k not in ("losses", "oracle_losses",
                                                 "records", "segments")}))
    print(f"[{key}] {backend} world {world} -> {world - 1} -> {world} "
          f"(rank {victim} relaunched at update {j.get('departed_at')}, "
          f"rejoined at {stop}): " + ", ".join(
              f"{k} {v:.2f}" for k, v in split.items())
          + f"; ms per update {rec['ms_per_update']}; ranks {ranks_s:.1f} s")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def _fleet_checks(ck: str, records: list, last_step) -> dict:
    """(f)'s run directory through ``python -m tpu_dp_torch.obs``:
    ``fleet --replay`` writes ``fleet_step`` records that cover each
    global step once across the regroups (through ``last_step``, when the
    rank said), each stamped with the membership epoch the ledger's
    records give it (the newest whose resume step is below it) at that
    epoch's world; ``timeline`` shows the departure and the rejoin."""
    path = os.path.join(os.path.dirname(ck), "fleet.jsonl")
    if os.path.exists(path):
        os.remove(path)  # the stream appends
    rc_f, _ = _obsctl("fleet", ck, "--replay", "-o", path)
    rc_t, tl = _obsctl("timeline", ck, "--json")
    steps = []
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            steps = [r for r in map(json.loads, f)
                     if r.get("kind") == "fleet_step"]
    starts = [(int(r["epoch"]), int((r.get("resume") or {}).get(
        "global_step", 0)), int(r["world"])) for r in records]

    def epoch_of(step):
        return max(s for s in starts if s[1] < step)

    try:
        kinds = [e["kind"] for e in json.loads(tl)["events"]]
    except (ValueError, KeyError):
        kinds = []
    nums = [r["step"] for r in steps]
    checks = {
        "fleet_exit_0": rc_f == 0, "timeline_exit_0": rc_t == 0,
        "fleet_each_step_once": bool(nums)
        and nums == list(range(1, len(nums) + 1))
        and (last_step is None or nums[-1] == last_step),
        "fleet_membership_epochs_follow_ledger": all(
            (r["me"], r["world"]) == (epoch_of(r["step"])[0],
                                      epoch_of(r["step"])[2])
            for r in steps)
        and {r["me"] for r in steps} == {s[0] for s in starts},
        "timeline_departure_then_rejoin": "elastic_departure" in kinds
        and "elastic_join" in kinds and kinds.index("elastic_departure")
        < kinds.index("elastic_join")}
    per_epoch = {}
    for r in steps:
        per_epoch.setdefault(r["me"], []).append(r["step"])
    rec = {"checks": checks, "fleet_rc": rc_f, "timeline_rc": rc_t,
           "steps_by_membership_epoch": {
               e: [v[0], v[-1]] for e, v in per_epoch.items()},
           "skew_ratio_max": max((r["skew_ratio"] for r in steps
                                  if r.get("skew_ratio") is not None),
                                 default=None)}
    print("[elastic_grow_gloo_one_card] obsctl " + json.dumps(rec))
    return rec


def _forge_join_when_live(work: str, sid: int, stop, deadline_s: float):
    """Publish a valid join request for ``sid`` into the run's generation
    once its epoch-0 record exists (no process answers it): the joiner
    that never comes. Returns the thread doing it."""
    import threading

    from tpu_dp_torch.resilience.elastic import MembershipLedger

    def forge():
        root = os.path.join(work, "ck", "membership")
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and not stop.is_set():
            gens = sorted(os.listdir(root)) if os.path.isdir(root) else []
            if gens and os.path.exists(os.path.join(root, gens[0],
                                                    "epoch_0000.json")):
                MembershipLedger(os.path.join(root, gens[0]), sid) \
                    .publish_join(1, sid, token="ghost-token",
                                  generation=gens[0])
                return
            time.sleep(0.05)

    th = threading.Thread(target=forge, daemon=True)
    th.start()
    return th


def _elastic_grow_aborted_run(out, started: dict) -> dict:
    """(g): two gloo ranks of Net on the card and a joiner that never
    comes, started (`_start_elastic` on `ELASTIC_GROW_ABORT_ARGS` with
    ``grow``, the forged request beside), and its checks (module
    docstring)."""
    key, work, procs = started["key"], started["work"], started["procs"]
    logs = _await_started(started)
    ranks_s = time.perf_counter() - started["t0"]
    rcs = [p.returncode for p in procs]
    if rcs != [0, 0]:
        for rank, log in enumerate(logs):
            print(f"[{key}] rank {rank} rc {rcs[rank]}:\n{log[-3000:]}")
        raise AssertionError(f"{key}: exit codes {rcs}, want [0, 0]")
    res = {}
    for rank in range(2):
        with open(os.path.join(work, f"rank{rank}.json"),
                  encoding="utf-8") as f:
            res[rank] = json.load(f)
    gen, records = _ledger_records(work)
    grow, back = (records + [{}, {}])[1:3]
    snap = (back.get("resume") or {}).get("snapshot_dir") or ""
    with open(os.path.join(gen, "grow_verdict_e0001.json"),
              encoding="utf-8") as f:
        verdict = json.load(f)
    a = res[0]
    updates = 2 * (144 // (2 * 4))  # two epochs of 18 updates at world 2
    aborted_s = {r: x.get("regroup_s") for r, x in res.items()}
    gate = {r: (_last_event(x, "gate_end") or 0)
            - (_last_event(x, "gate_start") or 0) for r, x in res.items()}
    checks = {
        "exit_codes": rcs == [0, 0],
        "record_1_grow_admits_sid_2": grow.get("reason") == "grow"
        and grow.get("joined") == [{"sid": 2, "token": "ghost-token"}]
        and grow.get("members") == [0, 1, 2],
        "record_2_grow_aborted": back.get("reason") == "grow_aborted"
        and back.get("members") == [0, 1] and back.get("departed") == [
            {"sid": 2, "reason": "join handshake timeout (grow aborted)"}]
        and verdict["commit"] is False,
        "resume_is_the_grow_snapshot": back.get("resume") == grow.get(
            "resume") and os.path.exists(os.path.join(snap,
                                                      "state.msgpack")),
        "nothing_replayed_both_epochs": all(
            x["host_step"] == len(x["losses"]) == updates
            and x["world"] == 2 and x["record"] == back
            for x in res.values()),
        "bit_identical": len({x["digest"] for x in res.values()}) == 1,
        "xent_books_exact": all(_segment_books_exact(x, convs=0, draws=0)
                                for x in res.values()),
        "one_regroup": all(x["counters"].get("elastic.regroups") == 1
                           for x in res.values()),
    }
    rec = {"checks": checks, "rcs": rcs, "records": records,
           "aborted_grow_s": aborted_s, "gate_s": gate,
           "window_s": ELASTIC_WINDOW_S,
           "segments": {r: x["segments"] for r, x in res.items()},
           "fit_s": {r: x["fit_s"] for r, x in res.items()},
           "ranks_s": ranks_s}
    out["elastic"][key] = rec
    print(f"[{key}] " + json.dumps({k: v for k, v in rec.items()
                                    if k not in ("records", "segments")}))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        for rank, log in enumerate(logs):
            print(f"[{key}] rank {rank}:\n{log[-2000:]}")
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def phase_elastic(out):
    """17: elastic world size on the main path (module docstring): (a) the
    graceful shrink of three gloo ranks on the one card, rank 2 leaving;
    (b) NCCL across two cards, rank 1 leaving, windows of 10 as CUDA graphs
    released and recaptured, when two or more cards are visible; (c) the
    rollback of (a)'s ranks, rank 2 killed; (d) the guard's SDC eviction
    of three Net ranks; (e) (b)'s rollback, rank 1 killed, when two or
    more cards are visible; (f) the grow: (a)'s ranks, rank 2 relaunched
    in its process (`run_elastic`), 3 -> 2 -> 3; (g) the aborted grow of
    two Net ranks, a joiner that never comes; (h) (b)'s NCCL pair grown
    back, 2 -> 1 -> 2, when two or more cards are visible. (a), (d), (f)
    and (g) run beside (c): their ranks start once (c)'s rank 2 has
    exited, while (c)'s survivors wait out the collection window (their
    times are taken on a shared card)."""
    import threading

    import torch

    out["elastic"] = {"card": out["card"]}
    seconds = out["elastic"]["seconds"] = {}
    gloo_args = ELASTIC_ARGS + [
        f"--data.synthetic_train_size={ELASTIC_TRAIN}",
        "--train.steps_per_call=1"]
    leave_args = gloo_args + [
        f"--resilience.fault=leave:step={ELASTIC_K},rank=2"]
    grow_args = gloo_args + [
        f"--resilience.snapshot_every_steps={ELASTIC_SNAP_EVERY}",
        "--resilience.snapshot_keep=0",
        f"--resilience.fault=relaunch:step={ELASTIC_GROW_K},rank=2",
        "--train.obs=basic"]
    t0, beside, stop = time.perf_counter(), {}, threading.Event()

    def start_beside():
        beside["a"] = _start_elastic("elastic_gloo_one_card", "gloo",
                                     ELASTIC_WORLD, leave_args)
        beside["d"] = _start_elastic("elastic_sdc_evict", "gloo", 3,
                                     ELASTIC_SDC_ARGS)
        beside["f"] = _start_elastic("elastic_grow_gloo_one_card", "gloo",
                                     ELASTIC_WORLD, grow_args, grow=True)
        beside["g"] = _start_elastic("elastic_grow_aborted", "gloo", 2,
                                     ELASTIC_GROW_ABORT_ARGS, grow=True)
        _forge_join_when_live(beside["g"]["work"], 2, stop,
                              ELASTIC_RANK_DEADLINE_S)

    try:
        _elastic_rollback_run(out, "elastic_rollback_gloo_one_card", "gloo",
                              ELASTIC_WORLD, 2, ELASTIC_KILL_K, gloo_args,
                              on_exit=start_beside)
        seconds["c"] = time.perf_counter() - t0
        if not beside:
            raise AssertionError("elastic_gloo_one_card, elastic_sdc_evict, "
                                 "elastic_grow_*: not started (rank 2 of "
                                 "elastic_rollback_gloo_one_card never "
                                 "exited)")
        _elastic_run(out, beside["a"], "gloo", ELASTIC_WORLD, 2, leave_args)
        seconds["a"] = time.perf_counter() - beside["a"]["t0"]
        _elastic_sdc_run(out, beside["d"])
        seconds["d"] = time.perf_counter() - beside["d"]["t0"]
        _elastic_grow_run(out, beside["f"], "gloo", ELASTIC_WORLD, 2,
                          grow_args, fleet=True)
        seconds["f"] = time.perf_counter() - beside["f"]["t0"]
        _elastic_grow_aborted_run(out, beside["g"])
        seconds["g"] = time.perf_counter() - beside["g"]["t0"]
    finally:
        stop.set()
        for p in (p for run in beside.values() for p in run["procs"]):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    seconds["a_c_d_f_g"] = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    nccl_args = ELASTIC_ARGS + [
        f"--data.synthetic_train_size={ELASTIC_NCCL_TRAIN}",
        f"--train.steps_per_call={ELASTIC_NCCL_WIN}", "--train.epochs=1"]
    t0 = time.perf_counter()
    if cards < 2:
        out["elastic"]["elastic_nccl_multi_card"] = "not run"
        print(f"elastic_nccl_multi_card: not run, {cards} card visible")
    else:
        leave = nccl_args + [
            f"--resilience.fault=leave:step={ELASTIC_NCCL_K},rank=1"]
        rec = _elastic_run(out, _start_elastic(
            "elastic_nccl_multi_card", "nccl", 2, leave), "nccl", 2, 1, leave)
        if not rec["captured"]:
            raise AssertionError("elastic_nccl_multi_card: the survivor's "
                                 "windows were not recaptured as a CUDA "
                                 "graph")
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cards < 2:
        out["elastic"]["elastic_rollback_nccl_multi_card"] = "not run"
        print(f"elastic_rollback_nccl_multi_card: not run, {cards} card "
              f"visible")
    else:
        rec = _elastic_rollback_run(
            out, "elastic_rollback_nccl_multi_card", "nccl", 2, 1,
            ELASTIC_NCCL_KILL_K, nccl_args, eager=False)
        if not rec["captured"]:
            raise AssertionError("elastic_rollback_nccl_multi_card: the "
                                 "survivor's windows were not recaptured "
                                 "as a CUDA graph")
    seconds["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cards < 2:
        out["elastic"]["elastic_grow_nccl_multi_card"] = "not run"
        print(f"elastic_grow_nccl_multi_card: not run, {cards} card "
              f"visible")
    else:
        grow = ELASTIC_ARGS + [
            f"--data.synthetic_train_size={ELASTIC_NCCL_TRAIN}",
            f"--train.steps_per_call={ELASTIC_NCCL_WIN}",
            f"--resilience.snapshot_every_steps={ELASTIC_NCCL_WIN}",
            "--resilience.snapshot_keep=0",
            f"--resilience.fault=relaunch:step={ELASTIC_NCCL_K},rank=1"]
        rec = _elastic_grow_run(out, _start_elastic(
            "elastic_grow_nccl_multi_card", "nccl", 2, grow, grow=True),
            "nccl", 2, 1, grow)
        if not rec["captured"]:
            raise AssertionError("elastic_grow_nccl_multi_card: the grown "
                                 "world's windows were not captured as a "
                                 "CUDA graph")
    seconds["h"] = time.perf_counter() - t0
    print(f"[elastic] seconds {json.dumps(seconds)}")


def _summed(name, source, replaces, launches, recs, peak=PEAK_BF16_FLOPS,
            launches_ran=None):
    """One kernels-line entry whose times sum ``recs`` (one per launch of
    a step or forward). ``launches_ran``: where served forwards replay
    bucket graphs, the launches that ran (``launches`` counts a graph's
    at its capture only)."""
    total = {k: sum(r[k] for r in recs)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    if all("wrapper_ms" in r for r in recs):
        total["wrapper_ms"] = sum(r["wrapper_ms"] for r in recs)
    t_bytes = sum(r["bytes"] for r in recs) / PEAK_BYTES
    t_ops = sum(r["flops"] for r in recs) / peak
    return with_ratios({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        **({} if launches_ran is None else {"launches_ran": launches_ran}),
        "max_abs_err": max(r["max_abs_err"] for r in recs), **total,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})


def kernels_line(out):
    cases = {(r["stage"], r["variant"]): r for r in out["kernel_cases"]
             if r["dtype"] == "float32"}
    train = out["train"]["launches"]
    src = "tpu_dp_torch/ops/csrc/"
    # Times sum the 10 calls of one B=32 f32 forward; launches are the
    # serve path's forwards plus the train path's eval forwards (eager):
    # counted by the wrappers (a bucket graph's at its capture) and as
    # ran (its replays too).
    eval_entry = _summed(KERNEL, src + "conv_block.cu",
                         "tpu_dp/ops/conv_block.py:113",
                         out["serve"]["launches"] + train["conv"]["eval"],
                         [cases[c] for c in FORWARD_CALLS],
                         launches_ran=out["serve"]["launches_ran"]
                         + train["conv"]["eval"])
    eval_entry["max_abs_err"] = max(
        r["max_abs_err"] for r in out["kernel_cases"]
        + out["kernel_small_bucket_cases"])
    tk = out["train_kernel_cases"]
    stats = {(r["stage"], r["variant"]): r for r in tk
             if r["kind"] == "emit_stats"}
    by_stage = {kind: {r["stage"]: r for r in tk if r["kind"] == kind}
                for kind in ("stats_fold", "input_grad")}
    # The fold's cost per launch of one forward: its stage's sum record
    # (plain, library, bound) with the measured emit_stats - stats-off time
    # of that launch's variant.
    fold = [{**by_stage["stats_fold"][st], "ms": stats[(st, v)]["fold_ms"]}
            for st, v in FORWARD_CALLS]
    xent = {(r["kind"], r["shape"][0]): r for r in tk
            if r["kind"].startswith("xent_mean")}
    entries = [
        eval_entry,
        # Sums over the 10 launches of one B=128 train forward / step.
        _summed("conv_block.fused_conv_bn (emit_stats)", src + "conv_block.cu",
                "tpu_dp/ops/conv_block.py:153", train["conv"]["stats"],
                [stats[c] for c in FORWARD_CALLS]),
        _summed("conv_block input-grad (pallas_bwd)", src + "conv_block.cu",
                "tpu_dp/ops/conv_block.py:418", train["conv"]["input_grad"],
                [by_stage["input_grad"][s] for s in INPUT_GRAD_STAGES]),
        # Runs inside each emit_stats launch: its launches are theirs.
        _summed("conv_block.fused_conv_bn stats fold (folded epilogue)",
                src + "conv_block.cu", "tpu_dp/ops/conv_block.py:167",
                train["conv"]["stats"], fold, PEAK_F32_FLOPS),
    ]
    for kind, name, line, key in (
            ("xent_mean_fwd", "xent.mean_softmax_xent forward (mean)", 71,
             "forward"),
            ("xent_mean_bwd", "xent.mean_softmax_xent backward (mean)", 82,
             "backward")):
        r = xent[(kind, TRAIN_B)]  # the main path's [128, 10]
        every = [x for x in tk if x["kind"] in (kind, kind.replace("_mean",
                                                                   ""))]
        entries.append(with_ratios({
            "name": name, "route": "cuda", "source": src + "xent.cu",
            "replaces": f"tpu_dp/ops/xent.py:{line}",
            "launches": train["xent"][key],
            "max_abs_err": max(x["max_abs_err"] for x in every),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # An empty kernel's device time: the floor of any launch.
            "floor_ms": out.get("xent_floor_ms")}))
    # ResNet-50 (phase 10): the same kernels at its call pattern, times
    # summed over the 13 launches of one B=128 forward or step.
    r50, rk = out["resnet50"], out["resnet50_kernels"]
    by = {(r["kind"], r["stage"]): r for r in rk["conv"]}
    conv = r50["launches"]["conv"]
    for kind, name, line, launches, ran in (
            ("r50_eval", "conv_block.fused_affine_relu_conv (ResNet-50, f32 "
             "x, no residual)", 113, r50["serve"]["launches"]
             + r50["serve_ckpt"]["conv_launches"] + conv["eval"],
             r50["serve"]["launches_ran"]
             + r50["serve_ckpt"]["launches_ran"] + conv["eval"]),
            ("r50_emit_stats", "conv_block.fused_conv_bn (emit_stats, "
             "ResNet-50)", 153, conv["stats"], None),
            ("r50_input_grad", "conv_block input-grad (pallas_bwd, "
             "ResNet-50)", 418, conv["input_grad"], None)):
        entries.append(_summed(name, src + "conv_block.cu",
                               f"tpu_dp/ops/conv_block.py:{line}", launches,
                               [by[(kind, st)] for st in R50_FORWARD_STAGES],
                               launches_ran=ran))
    x = rk["xent"]
    for d, name, line, key in (
            ("fwd", "xent.mean_softmax_xent forward (mean, [128, 100], "
             "multi-block)", 71, "forward"),
            ("bwd", "xent.mean_softmax_xent backward (mean, [128, 100], "
             "multi-block)", 82, "backward")):
        entries.append(with_ratios({
            "name": name, "route": "cuda", "source": src + "xent.cu",
            "replaces": f"tpu_dp/ops/xent.py:{line}",
            "launches": r50["launches"]["xent"][key],
            "max_abs_err": x[f"{d}_abs_err"], "ms": x[f"{d}_ms"],
            "plain_ms": x[f"{d}_plain_ms"], "bound_ms": x[f"{d}_bound_ms"],
            "bound_by": x[f"{d}_bound_by"],
            "library_ms": x[f"{d}_library_ms"], "floor_ms": x["floor_ms"]}))
    # bf16_cosine_gb4096 (phase 13): bf16 x at B=512, times summed over
    # one forward's / one step's 10 launches; xent at [512, 10].
    p = out["presets"]
    pk, ran = p["kernel_cases"], p["launches"]
    stats16 = {(r["stage"], r["variant"]): r for r in pk
               if r["kind"] == "p16_emit_stats"}
    grad16 = {r["stage"]: r for r in pk if r["kind"] == "p16_input_grad"}
    entries += [
        _summed("conv_block.fused_conv_bn (emit_stats, bf16 x, B=512)",
                src + "conv_block.cu", "tpu_dp/ops/conv_block.py:153",
                ran["conv.stats"], [stats16[c] for c in FORWARD_CALLS]),
        _summed("conv_block input-grad (pallas_bwd, bf16, B=512)",
                src + "conv_block.cu", "tpu_dp/ops/conv_block.py:418",
                ran["conv.input_grad"],
                [grad16[s] for s in INPUT_GRAD_STAGES])]
    x = next(r for r in pk if r["kind"] == "p16_xent")
    for d, name, line, key in (
            ("fwd", "xent.mean_softmax_xent forward (mean, [512, 10], "
             "multi-block)", 71, "forward"),
            ("bwd", "xent.mean_softmax_xent backward (mean, [512, 10], "
             "multi-block)", 82, "backward")):
        entries.append(with_ratios({
            "name": name, "route": "cuda", "source": src + "xent.cu",
            "replaces": f"tpu_dp/ops/xent.py:{line}",
            "launches": ran[f"xent.{key}"],
            "max_abs_err": x[f"{d}_abs_err"], "ms": x[f"{d}_ms"],
            "plain_ms": x[f"{d}_plain_ms"], "bound_ms": x[f"{d}_bound_ms"],
            "bound_by": x[f"{d}_bound_by"],
            "library_ms": x[f"{d}_library_ms"], "floor_ms": x["floor_ms"]}))
    # The crop/flip draws (phase 14): the kernel that replaces the JAX
    # package's jax.random XLA ops, not a TPU kernel; its launches are the
    # resilience path's uninterrupted run (one per update, on the
    # captured windows).
    r = out["resilience"]
    a = r["augment"]
    entries.append(with_ratios({
        "name": "augment.crop_flip_draws (jax.random's crop and flip draws)",
        "route": "cuda", "source": src + "augment.cu",
        "replaces": "tpu_dp/data/augment.py:30-36",
        "launches": r["launches"]["augment"],
        "max_abs_err": a["max_abs_err"], "ms": a["ms"],
        "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": None,
        "floor_ms": a["floor_ms"]}))
    return {"kernels": entries}


PHASES = (phase_header, phase_build, phase_kernels, phase_train_kernels,
          phase_serve, phase_serve_cluster, phase_train, phase_checkpoint,
          phase_ddp_gloo_one_card, phase_ddp_nccl_world1,
          phase_ddp_nccl_multi_card, phase_windows,
          phase_resnet50_kernels, phase_resnet50, phase_resnet50_windows,
          phase_resnet50_ddp, phase_sharded, phase_resident, phase_presets,
          phase_resilience, phase_guard, phase_obs, phase_elastic)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--ddp-worker"]:
        return ddp_worker(argv[1])
    if argv[:1] == ["--guard-worker"]:
        return guard_worker(argv[1])
    if argv[:1] == ["--elastic-worker"]:
        return elastic_worker(argv[1])
    # ``--only a,b``: header, build and the named phases (e.g. the
    # multi-card phase alone on a four-card machine); no kernels line.
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = set(argv[1].split(","))
        known = {p.__name__.removeprefix("phase_") for p in PHASES}
        if not only <= known:
            raise SystemExit(f"chip_smoke: unknown phases {only - known}")
    elif argv:
        raise SystemExit(f"chip_smoke: unexpected arguments {argv}")
    sys.path.insert(0, HERE)
    import torch  # fails here, not mid-phase, if missing

    out: dict = {"allocated_bytes_before": {}, "phase_s": {}}
    try:
        for phase in PHASES:
            name = phase.__name__.removeprefix("phase_")
            if only is not None and name not in only | {"header", "build"}:
                continue
            if torch.cuda.is_available():
                out["allocated_bytes_before"][phase.__name__] = (
                    torch.cuda.memory_allocated())
            t0 = time.perf_counter()
            phase(out)
            out["phase_s"][name] = time.perf_counter() - t0
        line = None if only is not None else kernels_line(out)
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        _save(out)
        return 1
    _save(out)
    print(out["card"])
    if line is not None:
        out["kernels"] = line["kernels"]
        _save(out)
        print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _save(out) -> None:
    try:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
                  "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1, default=str)
    except OSError as e:
        print(f"chip_smoke: could not save the record: {e}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
