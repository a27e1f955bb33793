"""Chip smoke test of the PyTorch/CUDA port (ompi_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and carried on):

1. build   — nvcc builds every kernel source under
             ompi_tpu_torch/kernels/csrc (one nvcc per source, all
             started together) and prints ptxas' registers, shared
             memory and spills per kernel, then the card's name and
             power limit.
2. kernels — each kernel against its plain PyTorch version on the same
             card inputs.  K1 stacked_reduce over every (dtype, op)
             pair the kernel takes, replicate and scatter mode, N in
             {2, 3, 8}, ragged and misaligned lengths, NaN inputs for
             MAX/MIN; K2 stacked_copy for alltoall and allgather; K3
             fused_batch over every pair K1 takes, N in {2, 3, 8},
             ragged slots, bcast entries, NaN, a group of 300 slots
             split over several launches, a combined dispatch's table
             of 128 slots in one launch and its refusal of 129, and a
             mixed batch of several groups; K4
             index_gather and K5 index_scatter over the five element
             widths with vector, indexed and contiguous index vectors,
             and K5 in run mode (stride 2 at 4099 and 2**20 elements,
             blocks of 16-byte words, a falling stride, a 3-d subarray,
             a contiguous span, 64 runs) and index mode (65 runs, a
             permutation of 2**16 and 2**20 of 2**21 destinations, a
             scattered third, one element), packed and out at element
             offsets 0
             and 1, out filled with a sentinel byte: every gap byte
             unchanged, each case in its plan's mode, and a table
             altered past its bounds refused before launch;
             K6 mesh_fold over every pair K1 takes, N in {2, 3, 8}, in
             rank order, the segring order and segrd's tree; K2's peer
             mode (alltoall destination, clipped gather, column
             segment) and K7 slot_pack (zeroed slots, odd widths,
             mixes of sources skewed from their destinations by 0, 1,
             2, 4, 8 and 12 bytes with empty and zero slots, 64 and 65
             slots); K8 rma_copy at unaligned heads and tails and at
             every destination shift 0-15 against source offsets 0 and
             3 (sizes 1, 15, 16, 17, 31, 4096 + 13, 65536 + 13, each
             source span ending at its tensor's last byte), K9
             rma_acc over every window wire dtype and every op it takes
             (REPLACE and NO_OP included), plain and fetch, at starts
             0, isz, 1, 4, 16 - isz and 17 bytes, s and old one element
             off, and K10 rma_cas's value cases (signed zeros, NaN, complex
             parts, bool bytes), each byte for byte.
             Tolerance: exact (max abs error 0, NaN where the plain
             version has NaN) — each pair computes the same fold in the
             same order and accumulation type, or moves the same bytes.
             K11 digest over every int and uint width and float16/32/64
             under every fold it takes, at 0, 1, 2**17+3 elements and
             8 MiB, a mixed table of 32 operands in one launch, and the
             value cases (uint8 wrap, -1 as unsigned, NaN, +-inf, -0.0):
             INTSUM, MAX and MIN exact, FSUM within 1e-12 relative of
             the plain version (which sums in another order) and
             bit-identical across two launches; the same values at
             every element offset 0..V-1 of a larger buffer give
             identical bits under every fold, every dtype; two replays
             of a captured graph (new values each) and an eager call
             against the plain version.  K12 driver_step
             against driver_step_plain for float32, float64, int32,
             float16 and bfloat16, R in {2, 8}, N in {8, 1024, 2**21,
             37 R}, one launch a call, and its refusal of N % R != 0;
             K2 peer with null sources (a 2*3-slot table with PROC_NULL
             at either end): exact, zeros in the null blocks.  K6 and
             K2 peer over destination tables (one launch a card): K6
             over every pair K1 takes, N in {2, 3, 8}, rank order,
             segring and segrd's tree, tables of 1 and 8 jobs and of
             70 (two launches) for one pair a dtype, job lengths that
             are not whole tiles, outputs congruent with their inputs
             and one element off; K2 peer gathers into 1, 8 and 70
             destinations (full and clipped), PROC_NULL sources,
             sources and outputs aligned and one element off, an
             alltoall table, a column segment, 130 destinations (two
             launches): each exact and bit-identical across two
             launches, each table's launch count checked.
3. main    — the port's main path through its user entry points:
             run_ranks(8, fn, device_map=cuda:0) -> comm.allreduce_arr
             (SUM float32: 1 MiB a rank in one dispatch, below
             coll_pipeline_min_bytes; 8 MiB and 128 MiB through the plan
             tier, 2**21+3 elements padded to 9 segments, and 8 MiB
             with coll_plan_enable=0 through the pipelined segments),
             reduce_scatter_arr (MAX float64, 8 MiB), alltoall_arr
             (float32: 1 MiB in one dispatch, 8 MiB in 8 segments),
             allgather_arr /
             bcast_arr / ppermute_arr (1 MiB), a fused flush of 32
             iallreduce_arr of 64 KiB, the interleaved batch of
             tests/test_coll_fusion.py, and BASELINE config 5:
             device_pack through a stride-2 vector, reduce_scatter MAX
             float64, device_unpack into a stride-2 receive layout
             (every K5 launch in run mode: the layout is one run).
             Every result is checked against a plain computation on
             the card, the provider of every call driven must be
             coll/hbm (coll/nbc for the nonblocking ones), and the
             kernels' launch counts (zeroed just before) are read
             between barriers around each case: each must launch
             exactly the kernels it is built on, as often as its tier
             says.
3b. mesh   — the mesh tier (coll/tpu) through the same entry points:
             run_ranks(8, fn, device_map=logical_devices(cuda:0)), 8
             logical devices of card 0 — allreduce SUM f32 1 MiB (single
             dispatch), 8 MiB and 128 MiB (plan, native), 8 MiB as a
             segring plan, a segrd plan and 8 pipelined segments, PROD
             int32 8 MiB, reduce_scatter MAX f64 8 MiB, alltoall 8 MiB
             (sega2a) and 1 MiB, bcast 8 MiB (segbcast), allgather and
             ppermute 1 MiB, a fused flush of 32 x 64 KiB, and a 1 MiB
             allreduce with each rank on a side stream of its own
             behind a sleeping kernel (the stream fence); launch counts
             (K6, K2 peer: one a card a body; K7 one a rank) checked
             case by case, every result exact
             against its plain computation, every rank's bytes the
             same, every provider coll/tpu.  With two or more cards the
             same cases run again one rank a card.
3c. rma    — one-sided RMA (osc) on the same 8 logical devices:
             the rma_counter and halo_stencil workloads under the device
             window (numpy and card-tensor origins, osc_device_dma 1 and
             0) and under --mca osc pt2pt with host numpy buffers, byte-
             identical; a side-stream case (each origin written behind a
             sleeping kernel on a stream of its own); launch counts exact
             a run (K8 a put or get with dma 0 only, K9 an accumulate,
             K10 a CAS).  With two or more cards, again one rank a card.
3d. integrity — the SDC plane armed at 1-in-1 on both tiers (8 ranks
             on card 0, then 8 logical devices of it): injected
             (device_sdc:1, victim rank 1, sdc_period 1) allreduce SUM
             f32 1 MiB, 8 MiB plan and 8 MiB pipelined, MAX int32, bcast
             from the victim, reduce_scatter SUM, allgather int32,
             alltoall int32 1 MiB and 8 MiB (segments) and the fused
             batch of tests/test_integrity.py — every result its
             analytic value byte for byte, convictions exactly rank 1,
             mismatches = retries = the checked meetings; clean (the
             same mix plus float16 SUM and an unchecked bfloat16 SUM) —
             no mismatch.  Launch counts exact case by case: a checked
             meeting is N K11 gate launches, one verify launch a
             device that holds outputs to check and, injected, one
             bisect launch a device and the body twice (a mesh body:
             one K6 / K2 peer launch a card).  With two or
             more cards the same cases run again one rank a card.
3e. halo   — the halo path on 8 logical devices of card 0 (the mesh
             tier), then on 8 ranks co-located on it (coll/hbm): the
             sendrecv_arr ring at 8 MiB f32, a sender that overwrites
             its tensor right after send_arr, a sender on a side stream
             behind a sleeping kernel, byte and object messages
             interleaved; on Create_cart([2, 4], periods=[True, True])
             shift_arr along both dims both ways and
             neighbor_allgather_arr at 8 MiB f32; on Create_cart([2, 2,
             2]) without periods neighbor_allgather_arr at 1 MiB int32
             (PROC_NULL blocks zero); Neighbor_allgather and
             Neighbor_alltoall on host numpy.  Every result exact
             against a plain computation; 8 K2 peer launches a
             neighbor_allgather_arr call, nothing else launches.  With
             two or more cards, again one rank a card (send_arr's peer
             copy over NVLink).
3f. entry  — entry()'s fn at (8, 1024) and (8, 2**21) float32, exact
             against driver_step_plain, one K12 launch a call;
             dryrun_multichip(8)'s step at the reference's shapes and
             at 8 MiB shards (cols 2**19) on 8 logical devices of the
             card, then the MPI part: every rank's value exact at the
             reference's shapes and within the float SUM band of a
             float64 computation at full width; K6 and K2 peer launch
             counts exactly as PERF.md predicts (8 + 10 and 8 + 24).
4. timing  — each kernel at the main path's shapes: its device time
             (CUDA events around a replayed CUDA graph of many calls)
             and its time a call (events around eager calls, host
             launch cost included) beside its bound (bytes / 3.35
             TB/s), its plain version and one PyTorch library call of
             the same function.  A mesh row is one collective's grouped
             launch (one a card); two rows time the body alone (one
             1 MiB stripe of 8 inputs, 8 stripes of 1 MiB into one
             output), and two B16's step at cols 2**19 (its K6 and its
             K2 peer launches); K7 also on a ragged mix (32 slots of
             64 KiB + 20 B), K9 also at target_disp 1 (w 4 bytes off
             16) and on the main path's 8 int32 (launch-bound), K8
             also at byte skews 1 and 4 (dst + 1, dst + 4), K11 also on
             a float32 view 4 bytes into its buffer and on uint8, K5
             also on the whole 2**20-element config 5 result (run mode)
             and on 2**17 random destinations in a 2**18 span (index
             mode).  The cross-session combined dispatches of phase 8:
             K3 over 2 x 32 slots of 64 KiB at N = 8 in one launch
             (B4m), K6 over two sessions' 2 MiB group buffers as jobs
             of one table and K2 peer over the stripes of the 4 MiB
             end-to-end vector (B10m).
5. e2e     — host clock, slowest rank: comm.allreduce_arr at 8 ranks x
             8 MiB float32 (the headline); a fused batch of 32
             iallreduce_arr of 64 KiB with one wait against the same
             32 blocking allreduce_arr calls; config 5's pack,
             reduce_scatter and unpack; the mesh allreduce of 8 MiB on
             8 logical devices (the tier's host cost on one card); the
             RMA ladder of benchmarks/probe_rma.py on 4 logical devices
             with card-tensor origins (put and get at 64 KiB, 1 MiB and
             4 MiB, the accumulate rate, fetch_and_op latency), both
             lowerings; the headline with the integrity plane armed at
             1-in-1 against unarmed, in turns; the 8 MiB sendrecv_arr
             ring and neighbor_allgather_arr on both tiers.
6. trace   — the span tracer and the critical-path profiler
             (trace_enable 1, trace_phase_enable 1, trace_sample_auto
             0; per-rank dumps under build/trace/): the headline
             (comm.allreduce_arr SUM, 8 ranks x 8 MiB float32, 20
             chained ops after 3 warm-up ones) traced on its own route
             (the plan tier: 1 K1 an op) and with coll_plan_enable 0 (8
             segments: 8 K1 an op), each in turns with the untraced
             headline (untraced, traced, traced, untraced) so the
             trace's own cost shows: critpath on the dumps — the median
             µs of each phase (rendezvous, pack, dispatch, execute,
             unpack) in an allreduce_arr call and its share of the
             calls' time, coverage (asserted >= 0.90 on the segmented
             route, printed on the plan route), the gating verdicts and
             the dispatch-tax table.  Traced results byte-identical to
             untraced ones, launch counts exactly the route's.  The
             traced plan headline again with the obs scrape tick on
             (obs_scrape_interval_ms at its default, 100) and off (0),
             in turns (on, off, off, on): its cost.  Then one
             armed integrity gate (1-in-1) on the plan route with the
             same split, and the straggler: ft_inject delay of 40 ms at
             every deposit of one rank on the segmented route —
             critpath must name that rank and the rendezvous as gating,
             with an arrival skew of at least 20 ms, and the stitched
             Chrome trace must carry flow arrows.
7. shmem   — the OpenSHMEM layer (ompi_tpu_torch.shmem) on 8 PEs, 8
             logical devices of the card, shmem_memheap_size 64 MiB a
             PE (512 MiB of heap on the card), in the manner of the OSU
             OpenSHMEM micro-benchmarks (osu_oshm_put, osu_oshm_get,
             osu_oshm_atomics), messages up to 4 MiB.  7a: every
             workload of ompi_tpu_torch/testing/shmem.py (the ring with
             wait_until, fetch-inc tickets with collect, CAS and swap,
             the ticket lock's mutual exclusion, strided iput/iget,
             scoll, the bulk put/get ladder) on the host heap (--mca osc
             pt2pt) and on the device heap under osc_device_dma 1 and 0:
             ctx.device on every PE, the device runs byte-identical to
             the host run, K9 and K10 launch counts exact, K8 none with
             dma 1 and at least the deterministic puts and gets with dma
             0.  7b: the card reports a copying runtime; a pool of pinned
             stages round trips 8 B, 64 KiB, 1 MiB and 4 MiB equal to
             the pageable path (each stage asserted pinned, the pool's
             allocation count flat after the warm-up); the window's
             numpy puts and gets at those sizes exact, the race case
             (two puts, origins overwritten before the fence) intact,
             and the plan's ragged 2**21 + 3 allreduce again (composed
             on the card, one K1).
             7c (printed): µs an op of shmem.put and get at the four
             sizes, atomic_fetch_add ops/s, the ring's µs a hop and the
             lock's µs a critical section, both lowerings, host clock,
             slowest PE.  With two or more cards 7a runs again one PE a
             card.  7a's launches join the kernels line's counts.
8. sessions — two resident sessions (testing.sessions.run_sessions:
             thread worlds of 8 ranks in cid bands 1 and 2) flushing
             fused batches of 32 iallreduce_arr SUM of 64 KiB float32,
             every rank of both behind one barrier before each flush.
             8a on the card (coll/hbm), 8b on its 8 logical devices
             (the mesh tier): the solo runs, window 0, then the window
             open (200 ms): every output byte-identical to its solo
             run; launches exact (a combined dispatch: one K3 a group;
             one K6 and one K2 peer a card, K7 one a rank); the
             dvm_xsession pvars and the per-band fused_batches exact;
             the bands' cids disjoint.  Then 8a's join limit: 5
             sessions, one flush each, the window open: at most 4 a
             combined dispatch (one K3 launch holds 128 slots at 8
             ranks), the fifth in a window of its own, one K3 launch a
             dispatch, outputs byte-identical to the solo runs.
             8c: phase 3d's injected mode
             again on both tiers with the flight recorder: ft_inject
             and sdc_* events equal the integrity pvars' moves, each
             with the reference's fields, the ring's dump loads in
             traceview.  8d (printed): host clock, slowest rank, us a
             collective of two sessions x 20 flushes at windows 0, 200
             and 1000 us in turns (A B C A B C), and the combined K3
             against two solo launches (device and a call).  8a/8b's
             launches join the kernels line's counts.
9. hier    — the hierarchical allreduce tier on the card's 8 logical
             devices in two slices of 4 (coll_hier_enable 1,
             coll_hier_slice_size 4).  9a: allreduce_arr at 8 and 128
             MiB of f32 SUM, i32 SUM and f32 MAX, and the ragged 2**21
             + 3 f32 SUM: an op is each slice's intra plan (one K6 and
             one K2 peer launch a card) and its segbcast of the total
             (one K2 peer launch a card a segment), launch counts exact
             case by case; coll_hier_ops moves by 8 an op (one a rank);
             each leader records one D2H, host allreduce and H2D span
             an op (phase tracing on), both stages pinned, and no other
             rank any; every rank's bytes the same and the plain
             version's on the CPU byte for byte; against the flat mesh
             allreduce of the same inputs (the tier off), ints and MAX
             byte for byte and float SUM within 4*N*2^-24 of
             sum(|x_i|).  9b: node 0 (ranks 0 and 1) held degraded by
             the health plane: slice 0's leader is rank 2, the bytes
             unchanged.  9c: ft_inject rdv_sever wedges rank 5 short of
             its first deposit on coll/hbm (8 ranks on the card) and on
             the mesh: the hang doctor's capture
             (testing.sessions.doctor_capture), built once the other 7
             have arrived, names rank 5 absent, and poisoning the world
             unwinds every rank within 5 s.  9d (printed): host_slow on
             node 1 (ranks 4-7, 18 ms a deposit) against clean, A B B A,
             us an op.  9e (printed): the tier against the flat mesh
             allreduce at 8 MiB, A B B A, us an op, with the leader
             hop's D2H, host allreduce and H2D host time, and one pinned
             8 MiB copy each way.  9a's launches join the kernels
             line's counts.
10. ft      — fault tolerance (ompi_tpu_torch/ft, cr) at the headline's
             width, 8 ranks x 8 MiB float32, 12 allreduce_arr SUM steps.
             10a on the card (coll/hbm, K1), 10b on its 8 logical
             devices (the mesh tier, K6 + K2 peer): rank 3 dies
             (ulfm.kill_now) at step 5, the survivors catch
             PROC_FAILED / REVOKED, shrink and finish on 7 (a mesh of 7:
             not a power of two); every survivor's last output equals a
             fresh 7-rank world's byte for byte, and the run's launches
             are exactly 5 ops of a fresh 8-rank world plus 7 of a
             7-rank one.  10c: cr_buddy_degree 1, a buddy checkpoint of
             {"i", "acc"} every step (acc 8 MiB on the card), rank 1
             dies at step 5 right after its checkpoint, run_ranks
             starts its replacement on the same card, which rejoins and
             restores its tensor there from its partner's copy: every
             rank's acc equals the fault-free run's byte for byte, the
             launches equal it.  10d: the counter workload (tensor
             origins) on the 7 survivors of a kill on the 8 logical
             devices equals a fresh 7-rank world's, K9 35 and K10 7.
             10e: the finish race, 50 worlds (half coll/hbm, half the
             mesh), rank 0 dying right after each 1 MiB allreduce: no
             survivor raises (1 K1, or 1 K6 + 1 K2 peer, a meeting).
             10f (printed, host clock, slowest rank, with the card's
             name and power limit): kill to the last survivor's raise,
             shrink us, step us on 8 and on 7 ranks; rejoin us,
             restore ms, a buddy checkpoint's ms and its D2H, CRC and
             ring exchange alone; the ulfm/respawn/buddy pvars.  The
             phase's launches join the kernels line's counts.

11. procs   — the process world (ompi_tpu_torch/tools/mpirun.py, the app
             shells of tools/hostrun.py, btl shm and tcp, B14's process
             half), each job a ``python -m ompi_tpu_torch.tools.mpirun``
             subprocess with --timeout, run after the build so the
             shells load the built kernels.  11a: ``-np 8
             --ranks-per-proc all`` running examples/device_allreduce.py
             at 8 MiB float32, 20 chained allreduce_arr: one shell, coll/
             hbm, exactly one K1 an op, the bytes within the float SUM
             band of a float64 sum; its us an op beside phase 5's.  11b:
             ``-np 8 --ranks-per-proc 4``, two shells on the card, the
             rank program ``procs`` of this file: each shell's 4-rank
             sub-communicator allreduce_arr 8 MiB (K1, SUB_OPS times),
             the sub leaders' host Allreduce of the partial across the
             shells, the world's allreduce_arr of a card tensor (staged
             through pinned stages), and rank 0's send_arr of 48 MiB of
             torch.arange to rank 4, overwritten right after the call:
             exact on arrival, max_staged_bytes <= (depth + 2) x chunk;
             each shell's K1 launches equal its sub ops, no K6 or K2;
             once with the default btl (shm between the shells) and
             once with ``btl self,tcp``; us of the pull (and GB/s),
             the staged world allreduce and the leaders' host allreduce,
             host clock, slowest rank; one pinned 4 MiB copy each way
             timed with CUDA events bounds the pull.  11c: abort_test.py
             under -np 3 exits 42 with MPI_Abort on stderr; a rank-
             thread raising in a two-shell job ends it non-zero before
             its timeout.  The shells' K1 launches join the kernels
             line's counts.  ``--cards`` runs 11b with ``-np 2C
             --ranks-per-proc C`` (C cards: the mesh tier inside each
             shell, one K6 and one K2 peer a card an op).

12. nodes   — the multi-node launcher (tools/plm.py, tools/tpud.py, the
             oob channel, rmaps, the daemons' KV proxies), each job an
             mpirun subprocess as in phase 11.  12a: phase 11a's
             headline through the PLM: ``-np 8 --hosts localhost:8
             --ranks-per-proc all``, one daemon and one shell on coll/
             hbm, exactly one K1 an op plus the check op; its us an op
             beside 11a's.  12b: ``-np 8 --simulate-nodes 2x4
             --ranks-per-proc all`` running examples/hier_allreduce.py
             at 8 MiB float32 a rank: each node's shell holds 4 rank-
             threads on 4 logical devices of the card, its node comm on
             the mesh tier (exactly one K6 and one K2 peer an op, plus
             the check op's), the leaders' 8 MiB Allreduce over tcp
             between the nodes, the node Bcast; the result within the
             float SUM band; us an op and of each step (slowest
             leader), and the seconds from the launch to
             DAEMONS_REPORTED and to the job's first collectives.  12c:
             examples/devp2p_big.py, a 256 MiB card tensor send_arr ->
             recv_arr across ``--simulate-nodes 2`` (btl/tcp): exact,
             the sender's overwrite never reaching the receiver,
             max_staged_bytes <= (depth + 2) x chunk; GB/s against the
             bound of its two pinned copies.  12d: abort_test.py across
             ``--simulate-nodes 2x2`` exits 42 with MPI_Abort; seconds
             to DAEMONS_REPORTED.  The K1, K6 and K2 peer launches join
             the kernels line's counts.  ``--cards`` runs 12b with one
             card a simulated device (``-np 2H --simulate-nodes 2xH``,
             H = half the cards).

13. pool    — the resident pool (ompi_tpu_torch/tools/dvm.py) as two
             subprocesses, ``python -m ompi_tpu_torch.tools.dvm --np 8
             --devices auto`` (their own CUDA contexts; the second with
             ``--batch-window-us 800000``), driven through the port's
             DvmClient; each pool sees the script's card alone
             (CUDA_VISIBLE_DEVICES), so every session rank is on it
             (coll/hbm) and runs
             examples/dvm_session.py (a rep: iallreduce_arr SUM int32,
             MAX float32, ibcast_arr: one fused batch, 2 K3; a blocking
             allreduce_arr of 64 float32: 1 K1).  13a: a session of 4
             twice (digests equal to each other and to a plain-torch
             digest of the same formula), a warm attach and 200 reps
             (µs a collective inside the session), two sessions at once
             with the window shut; on the second pool a solo run, then
             two sessions at once with the window open: one combined K3
             a group (dvm_xsession_batches +1, _collectives +6); the
             K3/K1 launches of each step read from the pool's metrics
             RPC, exact; no kernel library loaded after the first run.
             13b: ``mpirun --dvm URI -np 4`` examples/device_allreduce.py
             exits 0, exact, 4 K1 (rank 0's line and the pool's
             metrics).  13c: a session whose program raises returns
             non-zero and launches nothing; the next session prints the
             solo digest with 2 K3 + 1 K1.
             13d: halt drains each pool, whose process exits 0.  The
             pools' K3 and K1 launches join the kernels line's counts;
             on a failure the pools' stderr tails are printed and both
             are killed.
14. fleet  — the resident pool's fleet of host failure domains
             (phase_fleet's docstring).
15. ckpt   — the tiered checkpoint engine and live recovery.  15a: 8
             rank-threads on the card (coll/hbm), each an 8 MiB float32
             card tensor and a small numpy leaf; six steps of
             allreduce_arr (K1) + cr.ckpt.checkpoint (a filesystem
             epoch every call, cr_fs_interval 1); right after the
             sixth, its drain still pending, every rank overwrites its
             tensor in place; flush; a fresh world restores from the
             filesystem epoch onto the card: sha256 equal to the bytes
             before the overwrite, and to plain torch's sum; K1 exactly
             6, nothing else.  The enqueue, drain (the flight
             recorder's req_drain events) and commit times and the
             bytes written.  15b: an io_partial epoch on top: the
             restore falls back to 15a's epoch, its digest.  15c:
             ``mpirun -np 3 --simulate-nodes 3x1 --ranks-per-proc 1
             --ckpt-dir --mca errmgr_base_policy recover
             examples/ft_prog.py --device auto``, sim1's daemon killed
             after step 3: exit 0, rank 1 re-routed off sim1, no
             relaunch, every rank's Barrier + Allreduce right after
             the epoch reset, ``final step=10 acc=[330.0, ...]`` and
             the card digest of plain torch's [330.0] * 4.
16. proto  — the pml's protocols.  16a: 8 rank-threads on the card
             (coll/hbm) with pml_monitoring_enable, 20 allreduce_arr
             SUM of 8 MiB float32: every rank's sent_filtered_msgs 20
             and sent_filtered_bytes 20 x 8388608 to each other rank
             (count_offload at the rendezvous), user rows 0, K1 exactly
             20, the result in the float SUM band of plain torch's sum;
             then 20 chained ops timed with monitoring on, off, off, on
             (host µs an op).  16b: 2 rank-threads on the card with
             pml_vprotocol pessimist: after a first send_arr received
             as usual (timed: the cold one), rank 0 send_arrs an 8 MiB
             card tensor (the log's snapshot: a queued D2H into a
             pinned stage; log_bytes grows by 8388608) and
             checkpoint_locals; rank 1 checkpoint_locals
             before receiving; the cut is simulated (the message
             dropped, wanted back); rank 0 overwrites its source and
             replays: rank 1's tensor, on the card, has plain torch's
             digest of the pre-overwrite bytes; log_bytes printed.
             16c: ``mpirun -np 2 --mca pml_vprotocol pessimist
             examples/vproto_prog.py --device auto --mib 48`` with
             VPROTO_CRASH=1 (rank 1 dies after both snapshots: exit
             non-zero), then ``--restart``: exit 0, ``vproto ok`` and
             the 48 MiB chunked pull's card digest equal to plain
             torch's; examples/vproto_big_prog.py over shm, run beside
             those two jobs: ``vproto big ok``.  16d: ``mpirun -np 2 --ranks-per-proc all
             examples/device_allreduce.py --bytes 8388608 --iters 20``
             with pml_monitoring_dump_path: the internal-traffic matrix
             (mon_filtered_size.mat, and each rank's .prof line exact)
             holds 21 offloaded deposits of 8 MiB + 16 bytes of host
             Allreduce to the peer; the user matrices are empty.
17. inter  — intercommunicators, dpm and the in-box collectives.
             17a: 8 rank-threads on the card, 20 steps of
             allreduce_arr 8 MiB f32 SUM (K1), a host Allreduce of one
             float64 and a host Bcast of 64 int64 through coll/sm,
             allgather_arr 1 MiB f32 (K2) and a Barrier, all on one
             rendezvous: K1 exactly 20, K2 exactly 20, sm the
             allreduce provider, K1 in the float SUM band, K2 and the
             host results byte for byte numpy's; then the host µs of an
             8 B and an 8 MiB host Allreduce through sm against
             ``--mca coll ^sm`` (tuned), A B B A.  17b: the same ranks
             in two groups of 4, create_intercomm over the world; inter
             Allreduce, Bcast from ROOT and Alltoall of host arrays
             held to the reference's semantics; merge(), then 2
             allreduce_arr 8 MiB f32 on the merged comm: K1 exactly 2,
             in the band.  17e: examples/ring_attention.py's run on 4
             rank-threads on the card, 2048 tokens a rank, head width
             128, f32: full attention on the card at rtol 2e-4 / atol
             2e-5; its ms, warm and the first call.  Then three jobs
             side by side — 17c:
             ``mpirun -np 2 examples/spawn_parent.py --device auto
             --mib 8`` (2 parents spawn 2 workers; the reference's
             lines; merge(), the staged allreduce_arr across the 4
             process ranks: every rank's tensor on cuda, its digest
             plain torch's), 17d: ``mpirun -np 4
             examples/collseg_prog.py`` (the reference program's checks,
             every rank's seeded digest numpy's, coll_seg_native_ops >
             0 and python_ops 0), 17f: ``mpirun -np 4 --ranks-per-proc
             all examples/halo_stencil.py`` (the reference's four
             lines; the device halo's sendrecv_arr on the card) — and
             17d's timing: ``collseg_prog.py --bench 8 10 --ab``, an
             8 MiB f64 host Allreduce between the 4 process ranks
             through seg and through the tuned p2p route that ``--mca
             coll ^seg`` selects, A B B A in one job.
18. flat   — the flat MPI_* surface (ompi_tpu_torch.mpi, mpit,
             attrs, errhandler, memchecker), through
             ompi_tpu_torch.testing.flat's rank programs.  18a: 8
             rank-threads on the card take the world from
             MPI_COMM_WORLD(), attach an attribute whose keyval copies
             (the copy function runs once a rank), MPI_Comm_dup, set
             MPI_ERRORS_RETURN on the duplicate, with
             pml_monitoring_enable on; 20 allreduce_arr 8 MiB f32 SUM on
             it between MPI_T pvar sessions: K1 exactly 20, in the float
             SUM band; coll_plan_builds 8 and coll_plan_hits 152 (read
             between Barriers), and each rank's
             pml_monitoring_filtered_count / _size 20 and 20 x 8 MiB to
             each other rank (16a's counts); then MPI_Allreduce and
             PMPI_Allreduce of 8 B and 8 MiB int64 host buffers through
             coll/sm, byte for byte numpy's.  18b: opal_memchecker_enable
             on, 2 rank-threads: an 8 MiB f32 card tensor by
             send_arr / recv_arr keeps plain torch's digest; an 8 MiB
             MPI_Isend changed before MPI_Wait raises the memchecker's
             error naming the request; a posted MPI_Irecv reads 0xCB.
             18c: a duplicate with a handler from
             MPI_Comm_create_errhandler: an MPI_Bcast with its root out
             of range calls it once a rank with MPI_ERR_OTHER (the
             reference's class) and raises; the next allreduce_arr on
             that comm launches K1 once, in the band; MPI_Comm_free runs
             the attribute's delete function.  Phase 18's launches join
             the kernels line.

The last three lines are the kernels JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.  Exits non-zero without a
result when no CUDA card is present.  ``python3 chip_smoke.py --cards``
on a host with two or more cards builds the kernels and runs only the
one-rank-a-card branch (K8's shift cases with the source on a peer
card, then the mesh, RMA, integrity and halo phases and the SHMEM
workloads over peer access, and with four or more cards phase 9 in
slices of two: 9a, 9b, 9c on the mesh, 9d and 9e, and phase 10's
shrink on the mesh across the cards (10b's checks) and 10d), then
11b one rank a card in two shells and 12b one card a simulated device.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types

import torch

MIB = 1 << 20
NRANKS = 8
SEED = 1234
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
COLD_BYTES = 256 * MIB     # over five times the H100's 50 MB L2
CSRC = "ompi_tpu_torch/kernels/csrc/"
FUSED_MIB = 1 / 16      # 64 KiB: coll_device_fusion_threshold
FUSED_OPS = 32          # coll_device_fusion_max_ops
RAGGED = (1 << 21) + 3  # elements: 9 plan segments of 1 MiB float32
CONFIG5_N = 1 << 20     # config 5: packed float64 elements a rank


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def _ptxas_summary(report: str):
    """One (kernel, properties) pair per compiled kernel from
    nvcc -Xptxas -v output."""
    names, props = [], []
    cur = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            names.append(cur)
            props.append({"stack": int(m.group(1)),
                          "spill_st": int(m.group(2)),
                          "spill_ld": int(m.group(3))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and names and names[-1] == cur:
            props[-1]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            props[-1]["smem"] = int(sm.group(1)) if sm else 0
    demangled = names
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and names:
        res = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0:
            demangled = res.stdout.splitlines()
    return list(zip(demangled, props))


def phase_build() -> None:
    from ompi_tpu_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{len(reports)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        rows = _ptxas_summary(rep)
        if not rows:
            raise RuntimeError(f"no ptxas report for {name}:\n{rep}")
        for kname, p in rows:
            log(f"[ptxas] {kname}: {p.get('regs', '?')} regs, "
                f"{p.get('smem', '?')} B smem, stack {p['stack']} B, "
                f"spill {p['spill_st']}/{p['spill_ld']} B")
    log(f"[card] {card_line()}")


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64,
          torch.int8, torch.uint8, torch.int32, torch.int64, torch.bool,
          torch.int16, torch.uint16, torch.uint32, torch.uint64,
          torch.complex64, torch.complex128]
OPS = ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_LAND",
       "MPI_BAND", "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR"]


def make_shard(g: torch.Generator, n: int, dtype, opname: str,
               dev) -> torch.Tensor:
    """One rank's shard, made on the card from generator ``g``."""
    if dtype == torch.bool:
        return torch.randint(0, 2, (n,), generator=g, device=dev).bool()
    if dtype.is_floating_point:
        if opname == "MPI_PROD":
            x = 1.0 + 0.1 * torch.randn(n, generator=g, device=dev)
        else:
            x = torch.randn(n, generator=g, device=dev)
        if opname in ("MPI_MAX", "MPI_MIN") and n > 3:
            x[torch.randint(0, n, (max(1, n // 97),), generator=g,
                            device=dev)] = float("nan")
        return x.to(dtype)
    if dtype.is_complex:
        z = torch.randn(n, generator=g, device=dev, dtype=dtype)
        return 1.0 + 0.1 * z if opname == "MPI_PROD" else z
    info = torch.iinfo(dtype)
    lo, hi = (-3, 4) if opname == "MPI_PROD" and dtype.is_signed \
        else (0, 4) if opname == "MPI_PROD" else (info.min, info.max)
    if opname in ("MPI_LAND", "MPI_LOR", "MPI_LXOR"):
        lo, hi = (0, 3)  # plenty of zeros
    return torch.randint(max(lo, -2 ** 62), min(hi, 2 ** 62), (n,),
                         generator=g, device=dev, dtype=torch.int64
                         ).to(dtype)


def _err(a: torch.Tensor, b: torch.Tensor):
    """(max abs error, max rel error, NaN positions agree)."""
    if a.dtype == torch.bool:
        a, b = a.to(torch.int8), b.to(torch.int8)
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if a.dtype == torch.uint64:  # the difference of the bits: 0 iff equal
        a, b = a.view(torch.int64), b.view(torch.int64)
    if a.dtype.is_floating_point:
        a64, b64 = a.double(), b.double()
        nan_ok = bool(torch.equal(torch.isnan(a64), torch.isnan(b64)))
        fin = ~torch.isnan(a64) & ~torch.isnan(b64)
        d = (a64 - b64).abs()[fin]
        r = d / b64.abs()[fin].clamp_min(1e-300)
    else:
        nan_ok = True
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().double()
        r = d / b.to(torch.int64).abs().double().clamp_min(1)
    if d.numel() == 0:
        return 0.0, 0.0, nan_ok
    return float(d.max()), float(r.max()), nan_ok


def _held(outs, refs, what: str):
    worst = (0.0, 0.0)
    for o, r in zip(outs, refs):
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"{what}: shape/dtype {o.shape} "
                                 f"{o.dtype} vs {r.shape} {r.dtype}")
        a, rel, nan_ok = _err(o, r)
        if a != 0.0 or not nan_ok:
            raise AssertionError(f"{what}: kernel differs from plain "
                                 f"version (max abs {a}, NaN match "
                                 f"{nan_ok})")
        worst = (max(worst[0], a), max(worst[1], rel))
    return worst


def phase_kernels(dev) -> None:
    from ompi_tpu_torch.kernels import stacked
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ncases = 0
    for dtype in DTYPES:
        for opname in OPS:
            if not stacked.reduce_supported(dtype, opname):
                continue
            worst = (0.0, 0.0)
            for n in (2, 3, 8):
                # ragged lengths, and a misaligned view (one element
                # in) that forces the scalar path
                for length, offset in ((1, 0), (1003, 0), (4096 * n, 0),
                                       (37 * n, 1), (1029 * n, 0)):
                    xs = [make_shard(g, length + offset, dtype, opname,
                                     dev)[offset:] for _ in range(n)]
                    for scatter in (False, True):
                        if scatter and length % n:
                            continue
                        outs = stacked.stacked_reduce(xs, opname, scatter)
                        refs = stacked.stacked_reduce_plain(xs, opname,
                                                            scatter)
                        w = _held(outs, refs, f"K1 {dtype} {opname} n={n} "
                                  f"len={length} scatter={scatter}")
                        worst = (max(worst[0], w[0]), max(worst[1], w[1]))
                        ncases += 1
            log(f"[K1] {str(dtype)[6:]:>8} {opname:<9} max_abs {worst[0]} "
                f"max_rel {worst[1]}")
    torch.cuda.synchronize()
    for kind in ("alltoall", "allgather"):
        worst = (0.0, 0.0)
        for dtype in (torch.float32, torch.float64, torch.int8,
                      torch.bfloat16, torch.bool):
            for n in (2, 3, 8):
                for i, shape in enumerate(((n,), (7 * n,), (1024 * n, 3),
                                           (5 * n, 2, 3), (4096 * n + n,),
                                           (4096 * n, 2))):
                    off = i % 2  # odd cases misaligned: narrower widths
                    numel = int(torch.Size(shape).numel())
                    xs = [make_shard(g, numel + off, dtype, "MPI_SUM",
                                     dev)[off:].reshape(shape)
                          for _ in range(n)]
                    outs = stacked.stacked_copy(xs, kind)
                    refs = stacked.stacked_copy_plain(xs, kind)
                    w = _held(outs, refs, f"K2 {kind} {dtype} n={n} {shape}")
                    worst = (max(worst[0], w[0]), max(worst[1], w[1]))
                    ncases += 1
        log(f"[K2] {kind:<9} max_abs {worst[0]} max_rel {worst[1]}")
    torch.cuda.synchronize()
    ncases += (_kernels_fused(dev, g) + _kernels_index(dev, g)
               + _kernels_mesh(dev, g) + _kernels_tables(dev, g)
               + _kernels_rma(dev, g))
    log(f"[kernels] {ncases} cases held against the plain versions, "
        "tolerance exact")
    ncases = _kernels_digest(dev, g)
    log(f"[kernels] K11: {ncases} cases held against the plain version: "
        "INTSUM, MAX and MIN exact, FSUM within 1e-12 relative and "
        "bit-identical across two launches")
    ncases = _kernels_entry(dev, g)
    log(f"[kernels] K12 and K2 peer with null sources: {ncases} cases "
        "held against the plain versions, tolerance exact")


DIGEST_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.uint16,
                 torch.int32, torch.uint32, torch.int64, torch.uint64,
                 torch.float16, torch.float32, torch.float64]


def _digest_held(xs, codes, what: str) -> None:
    """K11 on one table against its plain version: INTSUM, MAX and MIN
    exact, FSUM within 1e-12 relative (both sum in float64, in other
    orders), and the kernel bit-identical across two launches."""
    from ompi_tpu_torch.kernels import digest as k11
    got = k11.digest(xs, codes)
    again = k11.digest(xs, codes)
    if not torch.equal(got, again):
        raise AssertionError(f"K11 {what}: two launches differ")
    _digest_agree(got, xs, codes, what)


def _digest_agree(got, xs, codes, what: str) -> None:
    """K11's results ``got`` for one table against the plain version:
    INTSUM, MAX and MIN exact, FSUM within 1e-12 relative."""
    from ompi_tpu_torch.kernels import digest as k11
    want = k11.digest_plain(xs, codes)
    for x, c, a, b in zip(xs, codes, got.tolist(), want.tolist()):
        av, bv = k11.decode(a, c, x.dtype), k11.decode(b, c, x.dtype)
        if av != av and bv != bv:
            continue
        if c == k11.F_FSUM and abs(bv) != float("inf"):
            ok = abs(av - bv) <= 1e-12 * max(abs(av), abs(bv))
        else:
            ok = av == bv
        if not ok:
            raise AssertionError(f"K11 {what}: {x.dtype} n={x.numel()} "
                                 f"fold {c}: kernel {av}, plain {bv}")


def _kernels_digest(dev, g) -> int:
    """K11 against its plain version: every int and uint width and
    float16/32/64 under every fold it takes, at 0, 1, 2**17 + 3
    elements and 8 MiB (make_shard's values: the full integer range,
    NaN in the float operands at and above 2**17); a mixed-length table
    of 32 operands in one launch; the value cases (uint8 200 + 100,
    -1 as unsigned, NaN, +-inf, -0.0)."""
    from ompi_tpu_torch.kernels import digest as k11
    ncases = 0
    for dtype in DIGEST_DTYPES:
        fl = dtype.is_floating_point
        codes = ((k11.F_FSUM, k11.F_MAX, k11.F_MIN) if fl
                 else (k11.F_INTSUM, k11.F_MAX, k11.F_MIN))
        isz = torch.empty((), dtype=dtype).element_size()
        for n in (0, 1, (1 << 17) + 3, 8 * MIB // isz):
            x = make_shard(g, n, dtype, "MPI_MAX", dev)
            for c in codes:
                _digest_held([x], [c], f"{dtype} n={n} fold {c}")
                ncases += 1
            if fl and n > 3:  # the same without NaN: a finite FSUM
                y = torch.nan_to_num(x, nan=1.5)
                _digest_held([y], [k11.F_FSUM], f"{dtype} n={n} finite")
                ncases += 1
        log(f"[K11] {str(dtype)[6:]:>8} exact (FSUM within 1e-12)")
    xs, cs = [], []
    for i in range(32):
        dtype = DIGEST_DTYPES[i % len(DIGEST_DTYPES)]
        fl = dtype.is_floating_point
        n = [0, 1, 7, 1000, 4099, 65536 + 5, 300001][i % 7]
        xs.append(make_shard(g, n, dtype, "MPI_SUM", dev))
        cs.append([k11.F_FSUM if fl else k11.F_INTSUM, k11.F_MAX,
                   k11.F_MIN][i % 3])
    from ompi_tpu_torch.kernels.digest import digest as k11_launch
    before = k11_launch.launches.value
    _digest_held(xs, cs, "a mixed table of 32")
    if k11_launch.launches.value - before != 2:  # two launches, one each
        raise AssertionError("K11: a 32-operand table is not one launch")
    ncases += 1
    t = torch.tensor
    vals = [
        (t([200], dtype=torch.uint8, device=dev), k11.F_INTSUM, 200),
        (t([200, 100], dtype=torch.uint8, device=dev), k11.F_INTSUM, 300),
        (t([-1], dtype=torch.int32, device=dev), k11.F_INTSUM, 0xFFFFFFFF),
        (t([-1, -1], dtype=torch.int64, device=dev), k11.F_INTSUM,
         (1 << 64) - 2),
        (t([-1, 5], dtype=torch.int8, device=dev), k11.F_MIN, -1),
        (t([250, 3], dtype=torch.uint8, device=dev), k11.F_MAX, 250),
        (t([1.0, float("nan"), 2.0], device=dev), k11.F_MAX, float("nan")),
        (t([1.0, float("-inf")], device=dev), k11.F_MIN, float("-inf")),
        (t([float("inf"), 1.0], dtype=torch.float16, device=dev),
         k11.F_FSUM, float("inf")),
        (t([-0.0, -0.0], device=dev), k11.F_FSUM, 0.0),
        (t([-0.0], dtype=torch.float64, device=dev), k11.F_MAX, 0.0),
    ]
    for x, c, v in vals:
        _digest_held([x], [c], f"value case {x.tolist()} fold {c}")
        got = k11.decode(k11.digest([x], [c]).tolist()[0], c, x.dtype)
        if not (got == v or (got != got and v != v)):
            raise AssertionError(f"K11 value case {x.tolist()} fold {c}: "
                                 f"{got}, expected {v}")
        ncases += 1
    torch.cuda.synchronize()
    return ncases + _kernels_digest_offsets(dev, g) + _kernels_digest_graph(
        dev, g)


def _kernels_digest_offsets(dev, g) -> int:
    """K11's bits do not depend on the address: the same values at every
    element offset 0..V-1 inside a larger buffer (V = 16 / size; offset
    0 is 16-byte aligned, the rest load element by element) give
    identical bits under every fold the dtype takes — FSUM on finite
    floats, INTSUM on every integer width, MAX and MIN (NaN among the
    floats) on both — each also against the plain version, at 1, V + 1
    and 2**17 + 3 elements (several blocks), and 8 MiB + 3 elements of
    float32 (512 blocks)."""
    from ompi_tpu_torch.kernels import digest as k11
    ncases = 0
    for dtype in DIGEST_DTYPES:
        fl = dtype.is_floating_point
        isz = torch.empty((), dtype=dtype).element_size()
        v = 16 // isz
        sizes = [1, v + 1, (1 << 17) + 3]
        if dtype == torch.float32:
            sizes.append(8 * MIB // isz + 3)
        for n in sizes:
            x = make_shard(g, n, dtype, "MPI_MAX", dev)
            cases = [(x, c) for c in (k11.F_MAX, k11.F_MIN)]
            cases.append((torch.nan_to_num(x, nan=1.5), k11.F_FSUM) if fl
                         else (x, k11.F_INTSUM))
            for vals, c in cases:
                buf = torch.empty(n + v, dtype=dtype, device=dev)
                if buf.data_ptr() % 16:
                    raise AssertionError("K11: a fresh buffer is not "
                                         "16-byte aligned")
                first = None
                for off in range(v):
                    view = buf[off:off + n]
                    view.copy_(vals)
                    got = k11.digest([view], [c])
                    _digest_agree(got, [view], [c], f"{dtype} n={n} "
                                  f"fold {c} at element {off}")
                    if first is None:
                        first = got
                    elif not torch.equal(got, first):
                        raise AssertionError(
                            f"K11 {dtype} n={n} fold {c}: element offset "
                            f"{off} gives other bits than offset 0")
                    ncases += 1
        log(f"[K11] {str(dtype)[6:]:>8} identical bits at element offsets "
            f"0..{v - 1}")
    torch.cuda.synchronize()
    return ncases


def _kernels_digest_graph(dev, g) -> int:
    """K11 captured in a CUDA graph (a table of multi-block operands:
    FSUM, INTSUM, MAX, and one view off 16 bytes), replayed twice with
    other values in the operands each time, then called eagerly: each
    result against the plain version (the done counters, reset by each
    operand's finishing block, serve every replay with no memset)."""
    from ompi_tpu_torch.kernels import digest as k11
    xs = [torch.empty(n, dtype=dt, device=dev)[off:] for n, dt, off in (
        ((1 << 20) + 7, torch.float32, 0), ((1 << 19) + 1, torch.int32, 0),
        ((1 << 18) + 5, torch.float64, 1), ((1 << 20) + 3, torch.uint8, 3))]
    codes = [k11.F_FSUM, k11.F_INTSUM, k11.F_MAX, k11.F_INTSUM]

    def refill():
        for x in xs:
            x.copy_(make_shard(g, x.numel(), x.dtype, "MPI_SUM", dev))

    refill()
    k11.digest(xs, codes)  # load the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = k11.digest(xs, codes)
    for r in range(2):
        refill()
        graph.replay()
        torch.cuda.synchronize()
        _digest_agree(got.clone(), xs, codes, f"graph replay {r}")
    _digest_agree(k11.digest(xs, codes), xs, codes, "eager after replays")
    torch.cuda.synchronize()
    del graph
    log("[K11] two graph replays (new values each) and an eager call "
        "agree with the plain version")
    return 3


def _held_slots(outs, refs, what: str):
    worst = (0.0, 0.0)
    for o, r in zip(outs, refs):
        w = _held(o, r, what)
        worst = (max(worst[0], w[0]), max(worst[1], w[1]))
    return worst


def _kernels_fused(dev, g) -> int:
    """K3 against its plain version: every pair K1 takes, N = 2, 3, 8,
    ragged slots (1 to 5000 elements, one misaligned), bcast entries in
    the SUM groups, NaN for float MAX/MIN (make_shard); a group of 300
    slots at N = 8, which the wrapper splits over several launches; a
    combined dispatch's table of 128 slots in one launch, and its
    refusal of 129 (split=False); and one mixed batch of several
    groups through coll/fusion's grouping (_hbm_slot_outs)."""
    from ompi_tpu_torch.coll import fusion
    from ompi_tpu_torch.kernels import fused, stacked
    ncases = 0
    for dtype in DTYPES:
        for opname in OPS:
            if not stacked.reduce_supported(dtype, opname):
                continue
            worst = (0.0, 0.0)
            for n in (2, 3, 8):
                slots = []
                for i, (length, off) in enumerate(
                        ((1, 0), (7, 0), (1024, 0), (1025, 1), (5000, 0))):
                    xs = [make_shard(g, length + off, dtype, opname,
                                     dev)[off:] for _ in range(n)]
                    slots.append((xs, None))
                    if opname == "MPI_SUM" and i % 2:
                        xs = [make_shard(g, length, dtype, opname, dev)
                              for _ in range(n)]
                        slots.append((xs, i % n))
                w = _held_slots(fused.fused_batch(slots, opname),
                                fused.fused_batch_plain(slots, opname),
                                f"K3 {dtype} {opname} n={n}")
                worst = (max(worst[0], w[0]), max(worst[1], w[1]))
                ncases += 1
            log(f"[K3] {str(dtype)[6:]:>8} {opname:<9} max_abs {worst[0]} "
                f"max_rel {worst[1]}")
    nbig = 300
    slots = [([make_shard(g, 300 + k, torch.float32, "MPI_MAX", dev)
               for _ in range(NRANKS)], None) for k in range(nbig)]
    c0 = fused.fused_batch.launches.value
    got = fused.fused_batch(slots, "MPI_MAX")
    parts = fused.fused_batch.launches.value - c0
    _held_slots(got, fused.fused_batch_plain(slots, "MPI_MAX"),
                f"K3 {nbig}-slot group")
    if parts != -(-nbig // fused.per_launch(NRANKS)):
        raise AssertionError(f"K3 {nbig}-slot group took {parts} launches")
    # a combined dispatch's table: one launch up to per_launch slots,
    # a ValueError past it (nothing launched, nothing split)
    per = fused.per_launch(NRANKS)
    c0 = fused.fused_batch.launches.value
    got = fused.fused_batch(slots[:per], "MPI_MAX", split=False)
    _held_slots(got, fused.fused_batch_plain(slots[:per], "MPI_MAX"),
                f"K3 combined table of {per} slots")
    try:
        fused.fused_batch(slots[:per + 1], "MPI_MAX", split=False)
        raise AssertionError("K3 took a combined table past one launch")
    except ValueError:
        pass
    if fused.fused_batch.launches.value - c0 != 1:
        raise AssertionError("K3's combined table is not one launch")
    ncases += 2
    # a mixed batch: the interleaved signature of test_coll_fusion plus
    # a second float32 MAX and a bool LOR slot, several groups
    sig = (("allreduce", (16,), torch.int32, "MPI_SUM"),
           ("allreduce", (8,), torch.float32, "MPI_MAX"),
           ("bcast", (5,), torch.int32, 1),
           ("allreduce", (1,), torch.int32, "MPI_PROD"),
           ("allreduce", (4099,), torch.float32, "MPI_MAX"),
           ("allreduce", (33,), torch.bool, "MPI_LOR"))
    args = [[make_shard(g, shape[0], dt,
                        "MPI_SUM" if kind == "bcast" else op, dev)
             for kind, shape, dt, op in sig] for _ in range(NRANKS)]
    outs = fusion._hbm_slot_outs(NRANKS, sig, args)
    for i, (kind, _shape, _dt, extra) in enumerate(sig):
        xs = [args[r][i] for r in range(NRANKS)]
        ref = [xs[extra].clone()] * NRANKS if kind == "bcast" \
            else stacked.stacked_reduce_plain(xs, extra)
        _held([outs[r][i] for r in range(NRANKS)], ref,
              f"K3 mixed batch slot {i}")
    ncases += 1
    torch.cuda.synchronize()
    return ncases


SCATTER_DTYPES = (torch.int8, torch.float16, torch.float32, torch.float64,
                  torch.complex128)  # the five element widths


def _scatter_layouts(rng):
    """K5's layouts: name -> (index vector, span of out, the mode its
    plan must name)."""
    import numpy as np
    from ompi_tpu_torch.kernels import index
    words = np.concatenate([np.arange(32) + 48 * k for k in range(70)])
    cube = (np.arange(3)[:, None, None] * 120 + np.arange(4)[None, :, None]
            * 12 + np.arange(8)[None, None, :] + 147).reshape(-1)
    blocks = np.concatenate([np.arange(8 + j % 2) + 40 * j
                             for j in range(index.MAX_RUNS + 1)])  # a run each
    return {
        "stride2": (np.arange(0, 2 * 4099, 2), 2 * 4099 + 1, "runs"),
        # a grid of many waves
        "stride2_large": (np.arange(0, 2 << 20, 2), (2 << 20) + 1, "runs"),
        "blocks_of_words": (words, 70 * 48, "runs"),
        "falling": (np.arange(3 * 5000, 0, -3), 3 * 5000 + 1, "runs"),
        "subarray_3d": (cube, 720, "runs"),
        "contiguous": (np.arange(5, 70005), 70010, "runs"),
        "64_runs": (blocks[:-8], 40 * index.MAX_RUNS, "runs"),
        "65_runs": (blocks, 40 * index.MAX_RUNS + 9, "index"),
        "permutation": (rng.permutation(1 << 16), 1 << 16, "index"),
        "permutation_large": (rng.permutation(1 << 21)[:1 << 20], 1 << 21,
                              "index"),
        "scattered_third": (rng.permutation(3 * 4099)[:4099], 3 * 4099,
                            "index"),
        "one_element": (np.array([3]), 5, "index"),
    }


def _kernels_index(dev, g) -> int:
    """K4 and K5 against their plain versions.  K4: element widths 1, 2,
    4, 8 and 16 bytes; vector (stride 2), indexed (a permutation of a
    third of the buffer) and contiguous index vectors; aligned and
    ragged lengths.  K5 at every width on run-mode layouts (stride 2 at
    4099 and 2**20 elements, blocks of whole 16-byte words, a falling
    stride, a 3-d subarray, a contiguous span, 64 runs) and index-mode
    ones (65 runs, a permutation of 2**16 and one of 2**20 of 2**21
    destinations, a scattered third, one element), the packed stream and
    ``out`` each at element offsets 0 and 1 into their buffers, ``out``
    filled with a sentinel byte: byte for byte against
    index_scatter_plain (and run mode against index_scatter_runs_plain),
    every gap byte unchanged, one launch a call in the mode its plan
    names; and a table altered past the vector's bounds refused before
    it launches."""
    import numpy as np
    from ompi_tpu_torch.kernels import index
    rng = np.random.default_rng(SEED)
    ncases = 0
    for dtype in SCATTER_DTYPES:
        for nbuf in (7, 4099, 1 << 16):
            src = make_shard(g, nbuf, dtype, "MPI_SUM", dev)
            for idx in (np.arange(0, nbuf, 2),
                        rng.permutation(nbuf)[:max(1, nbuf // 3)],
                        np.arange(nbuf)):
                iv = index.IndexVector(idx, dev)
                got = index.index_gather(src, iv)
                _held([got], [index.index_gather_plain(src, iv)],
                      f"K4 {dtype} {nbuf}")
                a = torch.zeros_like(src)
                b = torch.zeros_like(src)
                index.index_scatter(got, iv, a)
                index.index_scatter_plain(got, iv, b)
                _held([a], [b], f"K5 {dtype} {nbuf}")
                ncases += 2
        log(f"[K4/K5] {str(dtype)[6:]:>10} exact")
    modes = {"runs": 0, "index": 0}
    for name, (idx, span, mode) in _scatter_layouts(rng).items():
        for dtype in SCATTER_DTYPES:
            iv = index.IndexVector(idx, dev)
            if iv.mode != mode:
                raise AssertionError(f"K5 {name}: plan names {iv.mode}, "
                                     f"expected {mode}")
            w = torch.empty((), dtype=dtype).element_size()
            raw = make_shard(g, iv.n + 1, dtype, "MPI_SUM", dev)
            gaps = torch.ones(span, dtype=torch.bool, device=dev)
            gaps[iv.tensor] = False
            for poff in (0, 1):
                packed = raw[poff:poff + iv.n]
                for off in (0, 1):
                    buf = torch.full(((span + 2) * w,), 0xA5,
                                     dtype=torch.uint8, device=dev)
                    want = buf.clone()
                    out = buf.view(dtype)[off:off + span]
                    index.index_scatter_plain(
                        packed, iv, want.view(dtype)[off:off + span])
                    refs = [want]
                    if mode == "runs":
                        other = buf.clone()
                        index.index_scatter_runs_plain(
                            packed, iv, other.view(dtype)[off:off + span])
                        refs.append(other)
                    n0 = index.index_scatter.launches.value
                    r0 = index.index_scatter.run_launches.value
                    index.index_scatter(packed, iv, out)
                    took = (index.index_scatter.launches.value - n0,
                            index.index_scatter.run_launches.value - r0)
                    if took != (1, int(mode == "runs")):
                        raise AssertionError(f"K5 {name} {dtype}: "
                                             f"launches {took} in {mode} "
                                             "mode")
                    what = f"K5 {mode} {name} {dtype} packed+{poff} out+{off}"
                    for ref in refs:
                        _held([buf], [ref], what)
                    cells = buf.view(span + 2, w)
                    kept = torch.cat([cells[:off], cells[off:off + span][gaps],
                                      cells[off + span:]])
                    if not bool((kept == 0xA5).all()):
                        raise AssertionError(f"{what}: a gap byte changed")
                    ncases += 1
        modes[mode] += 1
    iv = index.IndexVector(np.arange(0, 64, 2), dev)
    iv.runs = iv.runs.copy()
    iv.runs[0, index.DST] = 1  # its last element would land on 64
    out = torch.zeros(64, dtype=torch.float64, device=dev)
    try:
        index.index_scatter(torch.ones(32, dtype=torch.float64, device=dev),
                            iv, out)
    except RuntimeError:
        pass
    else:
        raise AssertionError("K5: a table past its bounds was launched")
    torch.cuda.synchronize()
    if bool(out.any()):
        raise AssertionError("K5: a refused table wrote")
    log(f"[K5] {modes['runs']} run-mode and {modes['index']} index-mode "
        "layouts x 5 widths x packed and out at element offsets 0, 1: "
        "exact, gap bytes unchanged, each in its plan's mode; a table past "
        "its bounds refused before launch")
    torch.cuda.synchronize()
    return ncases + 1


# ---------------------------------------------------------------------------
# 3. the main path
# ---------------------------------------------------------------------------

def rank_input(rank: int, nbytes: int, dtype, dev, salt: int):
    return rank_elems(rank, nbytes // torch.empty((), dtype=dtype
                                                  ).element_size(),
                      dtype, dev, salt)


def rank_elems(rank: int, n: int, dtype, dev, salt: int):
    g = torch.Generator(device=dev)
    g.manual_seed(SEED * 1000 + salt * 100 + rank)
    return torch.randn(n, generator=g, device=dev, dtype=dtype)


def interleaved_inputs(rank: int, dev):
    """The canonical fused batch of tests/test_coll_fusion.py:33-54:
    int32 SUM, float32 MAX, int32 bcast (root 1), int32 scalar PROD."""
    a = torch.arange(16, dtype=torch.int32, device=dev) * (rank + 1)
    b = torch.ones(8, device=dev) * (rank + 1)
    b[0] = -rank
    c = torch.full((5,), rank * 3 + 1, dtype=torch.int32, device=dev)
    d = torch.tensor(rank + 2, dtype=torch.int32, device=dev)
    return a, b, c, d


def config5_raw(rank: int, dev):
    """Config 5's strided send buffer: 2 * CONFIG5_N float64, the even
    elements this rank's data, the odd ones filler (-1)."""
    raw = torch.full((CONFIG5_N, 2), -1.0, dtype=torch.float64, device=dev)
    raw[:, 0] = rank_elems(rank, CONFIG5_N, torch.float64, dev, 9)
    return raw.reshape(-1)


def config5(comm, raw, dt):
    """BASELINE config 5 through the port's entry points: pack the
    stride-2 vector on the card, reduce_scatter MAX the packed stream,
    unpack the result into a stride-2 receive layout (in place)."""
    from ompi_tpu_torch.datatype import device as ddev
    from ompi_tpu_torch.op.op import MAX
    vec = dt.vector(CONFIG5_N, 1, 2, dt.DOUBLE).commit()
    packed = ddev.device_pack(vec, 1, raw)
    res = comm.reduce_scatter_arr(packed, MAX)
    m = CONFIG5_N // comm.size
    rvec = dt.vector(m, 1, 2, dt.DOUBLE).commit()
    recv = torch.full((2 * m,), -5.0, dtype=torch.float64, device=raw.device)
    return ddev.device_unpack(rvec, 1, res, recv)


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from ompi_tpu_torch.kernels import digest, entry, fused, index, mesh, \
        rma, stacked
    return {"digest": digest.digest.launches,
            "driver_step": entry.driver_step.launches,
            "stacked_reduce": stacked.stacked_reduce.launches,
            "stacked_copy": stacked.stacked_copy.launches,
            "fused_batch": fused.fused_batch.launches,
            "index_gather": index.index_gather.launches,
            "index_scatter": index.index_scatter.launches,
            "mesh_fold": mesh.mesh_fold.launches,
            "peer_copy": stacked.peer_copy.launches,
            "slot_pack": mesh.slot_pack.launches,
            "rma_copy": rma.rma_copy.launches,
            "rma_acc": rma.rma_acc.launches,
            "rma_cas": rma.rma_cas.launches}


def drive(plan, device_map, nranks: int, tier: str, what: str):
    """Run ``plan``'s cases in order on ``nranks`` rank threads through
    the port's entry points.  Every collective entry point driven must
    be provided by ``tier`` (coll/nbc for the nonblocking ones; a case
    whose entry point is None is point-to-point).  Every counter is
    zeroed just before the run; each case's launches are read between
    barriers around it and must be exactly its expected counts (every
    other kernel: 0).  Returns (results by rank, total launches, the
    launches of each case)."""
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.testing import run_ranks
    counters = launch_counters()
    per_call = {}

    def snapshot():
        return {k: c.value for k, c in counters.items()}

    def fn(comm):
        for _, fname, _, _, _ in plan:
            if fname is None:  # point-to-point: no collective provider
                continue
            want = "nbc" if fname.startswith("i") else tier
            if comm.coll.providers[fname] != want:
                raise AssertionError(f"{fname} is provided by "
                                     f"{comm.coll.providers[fname]}")
        out = {}
        comm.Barrier()
        prev = snapshot() if comm.rank == 0 else None
        comm.Barrier()
        for key, _, _, call, knobs in plan:
            if comm.rank == 0:
                saved = {k: registry.get(k) for k in knobs}
                for k, v in knobs.items():
                    registry.set(k, v)
            comm.Barrier()
            out[key] = call(comm)
            # the last arriver counts its launches before any member
            # leaves the meeting, so after this barrier the count is
            # final; the next barrier keeps the next call out until
            # rank 0 has read it
            comm.Barrier()
            if comm.rank == 0:
                cur = snapshot()
                per_call[key] = {k: cur[k] - prev[k] for k in cur}
                prev = cur
                for k, v in saved.items():
                    registry.set(k, v)
            comm.Barrier()
        torch.cuda.synchronize()
        return out

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    res = run_ranks(nranks, fn, device_map=device_map, timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = snapshot()
    log(f"[{tier}] {what}: {len(plan)} cases in {wall:.3f} s, "
        f"launches {launches}")
    for key, fname, want, _, knobs in plan:
        want = {k: want.get(k, 0) for k in counters}
        log(f"[{tier}] {key} ({fname or 'p2p'}"
            f"{', ' + str(knobs) if knobs else ''}"
            f"): launches {per_call[key]}")
        if per_call[key] != want:
            raise AssertionError(f"{key}: launches {per_call[key]}, "
                                 f"expected {want}")
    total = {k: sum(w.get(k, 0) for _, _, w, _, _ in plan)
             for k in counters}
    if launches != total:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{total}")
    return res, launches, per_call


def phase_main(dev) -> dict:
    from ompi_tpu_torch.datatype import engine as dt
    from ompi_tpu_torch.op.op import MAX, PROD, SUM

    f32, f64 = torch.float32, torch.float64
    nfused = int(FUSED_MIB * MIB) // 4

    def fused32(c):
        qs = [c.iallreduce_arr(rank_elems(c.rank, nfused, f32, dev,
                                          50 + k), SUM)
              for k in range(FUSED_OPS)]
        qs[0].wait()  # the 32nd enqueue already flushed the batch
        return [q.result for q in qs]

    def interleaved(c):
        a, b, cc, d = interleaved_inputs(c.rank, dev)
        qs = [c.iallreduce_arr(a, SUM), c.iallreduce_arr(b, MAX),
              c.ibcast_arr(cc, 1), c.iallreduce_arr(d, PROD)]
        for q in qs:
            q.wait()
        return [q.result for q in qs]

    # (result key, the entry point's vtable name, kernels it must
    # launch, call, knobs set around it)
    plan = [
        ("ar1", "allreduce_arr", {"stacked_reduce": 1},
         lambda c: c.allreduce_arr(rank_input(c.rank, MIB, f32, dev, 12),
                                   SUM), {}),
        ("a2a1", "alltoall_arr", {"stacked_copy": 1},
         lambda c: c.alltoall_arr(rank_input(c.rank, MIB, f32, dev, 13)),
         {}),
        ("ar8", "allreduce_arr", {"stacked_reduce": 1},
         lambda c: c.allreduce_arr(rank_input(c.rank, 8 * MIB, f32, dev, 1),
                                   SUM), {}),
        ("ar128", "allreduce_arr", {"stacked_reduce": 1},
         lambda c: c.allreduce_arr(
             rank_input(c.rank, 128 * MIB, f32, dev, 2), SUM), {}),
        ("ar_ragged", "allreduce_arr", {"stacked_reduce": 1},
         lambda c: c.allreduce_arr(rank_elems(c.rank, RAGGED, f32, dev, 11),
                                   SUM), {}),
        ("ar8_seg", "allreduce_arr", {"stacked_reduce": 8},
         lambda c: c.allreduce_arr(rank_input(c.rank, 8 * MIB, f32, dev, 1),
                                   SUM), {"coll_plan_enable": False}),
        ("rs8", "reduce_scatter_block_arr", {"stacked_reduce": 1},
         lambda c: c.reduce_scatter_arr(
             rank_input(c.rank, 8 * MIB, f64, dev, 3), MAX), {}),
        ("a2a8", "alltoall_arr", {"stacked_copy": 8},
         lambda c: c.alltoall_arr(rank_input(c.rank, 8 * MIB, f32, dev, 4)),
         {}),
        ("ag1", "allgather_arr", {"stacked_copy": 1},
         lambda c: c.allgather_arr(rank_input(c.rank, MIB, f32, dev, 5)), {}),
        ("bc1", "bcast_arr", {},
         lambda c: c.bcast_arr(rank_input(c.rank, MIB, f32, dev, 6),
                               root=3), {}),
        ("pp1", "ppermute_arr", {},
         lambda c: c.ppermute_arr(
             rank_input(c.rank, MIB, f32, dev, 7),
             [(i, (i + 1) % c.size) for i in range(c.size - 1)]), {}),
        ("fused32", "iallreduce_arr", {"fused_batch": 1}, fused32, {}),
        ("fused_mixed", "ibcast_arr", {"fused_batch": 3}, interleaved, {}),
        ("config5", "reduce_scatter_block_arr",
         {"index_gather": NRANKS, "stacked_reduce": 1,
          "index_scatter": NRANKS},
         lambda c: config5(c, config5_raw(c.rank, dev), dt), {}),
    ]
    from ompi_tpu_torch.kernels import index
    runs = index.index_scatter.run_launches
    runs.reset()
    res, launches, per_call = drive(plan, lambda r: dev, NRANKS, "hbm",
                                    f"8 ranks on {dev}")
    # config 5's receive layout, vector(m, 1, 2, DOUBLE), is one run:
    # every K5 launch of the main path reads no index
    if runs.value != launches["index_scatter"]:
        raise AssertionError(f"K5: {runs.value} of "
                             f"{launches['index_scatter']} launches in run "
                             "mode on the main path")
    log(f"[main] K5: all {runs.value} launches of config 5's unpack in run "
        "mode")
    check_main(dev, res)
    return launches, per_call


def check_main(dev, res) -> None:
    """Every main-path result against a plain computation on the card
    (exact), and the float SUM against an independent float64 sum."""
    from ompi_tpu_torch.kernels.index import (IndexVector,
                                              index_gather_plain)
    from ompi_tpu_torch.kernels.stacked import (stacked_copy_plain,
                                                stacked_reduce_plain)
    import numpy as np

    def inputs(nbytes, dtype, salt):
        return [rank_input(r, nbytes, dtype, dev, salt)
                for r in range(NRANKS)]

    def check(key, refs, what):
        worst = _held([res[r][key] for r in range(NRANKS)], refs, what)
        log(f"[main] {what}: exact against the plain computation "
            f"(max abs {worst[0]})")

    check("ar1", stacked_reduce_plain(inputs(MIB, torch.float32, 12),
                                      "MPI_SUM"),
          "allreduce SUM f32 1 MiB (single dispatch)")
    check("a2a1", stacked_copy_plain(inputs(MIB, torch.float32, 13),
                                     "alltoall"),
          "alltoall f32 1 MiB (single dispatch)")
    ar8 = stacked_reduce_plain(inputs(8 * MIB, torch.float32, 1), "MPI_SUM")
    check("ar8", ar8, "allreduce SUM f32 8 MiB (plan)")
    check("ar8_seg", ar8, "allreduce SUM f32 8 MiB (8 pipelined segments)")
    check("ar128", stacked_reduce_plain(inputs(128 * MIB, torch.float32, 2),
                                        "MPI_SUM"),
          "allreduce SUM f32 128 MiB (plan)")
    check("ar_ragged", stacked_reduce_plain(
        [rank_elems(r, RAGGED, torch.float32, dev, 11)
         for r in range(NRANKS)], "MPI_SUM"),
        f"allreduce SUM f32 {RAGGED} elements (plan, 9 padded segments)")
    check("rs8", stacked_reduce_plain(inputs(8 * MIB, torch.float64, 3),
                                      "MPI_MAX", scatter=True),
          "reduce_scatter MAX f64 8 MiB")
    check("a2a8", stacked_copy_plain(inputs(8 * MIB, torch.float32, 4),
                                     "alltoall"),
          "alltoall f32 8 MiB (8 segments)")
    check("ag1", stacked_copy_plain(inputs(MIB, torch.float32, 5),
                                    "allgather"), "allgather f32 1 MiB")
    bc = inputs(MIB, torch.float32, 6)[3]
    check("bc1", [bc] * NRANKS, "bcast f32 1 MiB root 3")
    pp = inputs(MIB, torch.float32, 7)
    check("pp1", [torch.zeros_like(pp[0])] + pp[:NRANKS - 1],
          "ppermute f32 1 MiB open ring")
    nfused = int(FUSED_MIB * MIB) // 4
    worst = 0.0
    for k in range(FUSED_OPS):
        xs = [rank_elems(r, nfused, torch.float32, dev, 50 + k)
              for r in range(NRANKS)]
        worst = max(worst, _held([res[r]["fused32"][k]
                                  for r in range(NRANKS)],
                                 stacked_reduce_plain(xs, "MPI_SUM"),
                                 f"fused slot {k}")[0])
    log(f"[main] fused flush of {FUSED_OPS} iallreduce SUM f32 64 KiB: "
        f"exact against the plain computation (max abs {worst})")
    ins = [interleaved_inputs(r, dev) for r in range(NRANKS)]
    refs = [stacked_reduce_plain([i[0] for i in ins], "MPI_SUM"),
            stacked_reduce_plain([i[1] for i in ins], "MPI_MAX"),
            [ins[1][2]] * NRANKS,
            stacked_reduce_plain([i[3] for i in ins], "MPI_PROD")]
    for j, ref in enumerate(refs):
        _held([res[r]["fused_mixed"][j] for r in range(NRANKS)], ref,
              f"interleaved batch slot {j}")
    log("[main] interleaved fused batch (int32 SUM, f32 MAX, int32 bcast, "
        "int32 scalar PROD): exact against the plain computation")
    # config 5, plain: gather the even elements, fold with MAX, stripe,
    # scatter each stripe into a stride-2 layout
    even = IndexVector(np.arange(0, 2 * CONFIG5_N, 2), dev)
    packed = [index_gather_plain(config5_raw(r, dev), even)
              for r in range(NRANKS)]
    stripes = stacked_reduce_plain(packed, "MPI_MAX", scatter=True)
    want = []
    for s in stripes:
        recv = torch.full((2 * s.numel(),), -5.0, dtype=torch.float64,
                          device=dev)
        recv[0::2] = s
        want.append(recv)
    check("config5", want, "config 5: device_pack -> reduce_scatter MAX "
          "f64 -> device_unpack")
    # the reduced values themselves, against an independent reference:
    # float64 sum of the float32 inputs, within the float32 band
    xs = inputs(8 * MIB, torch.float32, 1)
    exact = torch.stack([x.double() for x in xs]).sum(0)
    absum = torch.stack([x.double().abs() for x in xs]).sum(0)
    band = 4 * NRANKS * 2.0 ** -24
    for key in ("ar8", "ar8_seg"):
        bad = ((res[0][key].double() - exact).abs() > band * absum).sum()
        if int(bad) or not torch.isfinite(res[0][key]).all():
            raise AssertionError(f"{key}: allreduce SUM outside the "
                                 f"float32 band at {int(bad)} elements")
    log(f"[main] allreduce SUM f32 8 MiB within 4*N*2^-24 of the float64 "
        f"sum; providers hbm / nbc; results finite")


# ---------------------------------------------------------------------------
# 3b. the mesh tier (coll/tpu)
# ---------------------------------------------------------------------------

RING_SEG = MIB // 4  # coll_seg_size in float32 / int32 elements


def mesh_input(rank: int, nbytes: int, dtype, devs, salt: int):
    """Rank ``rank``'s input, made on the first mesh device from a seed
    and placed on the rank's own device."""
    n = nbytes // torch.empty((), dtype=dtype).element_size()
    g = torch.Generator(device=devs[0])
    g.manual_seed(SEED * 1000 + salt * 100 + rank)
    if dtype == torch.int32:
        x = torch.randint(-3, 4, (n,), generator=g, device=devs[0],
                          dtype=torch.int32)
    else:
        x = torch.randn(n, generator=g, device=devs[0], dtype=dtype)
    return x.to(devs[rank])


def mesh_cases(devs):
    """(key, entry point, launches, call, knobs) of the mesh phase at
    N = len(devs) ranks on C = len(set(devs)) cards: each allreduce is
    one K6 and one K2 peer launch a card (a segment, for the pipelined
    tier), reduce_scatter one K6 a card, alltoall / allgather /
    segbcast one K2 peer launch a card (a segment), ppermute peer
    copies, the fused flush one K7 a rank and one allreduce."""
    from ompi_tpu_torch.op.op import MAX, PROD, SUM
    n, nc = len(devs), len(set(devs))
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    nfused = int(FUSED_MIB * MIB) // 4
    red = {"mesh_fold": nc, "peer_copy": nc}
    segs = 8 * MIB // (RING_SEG * 4)

    def inp(c, nbytes, dtype, salt):
        return mesh_input(c.rank, nbytes, dtype, devs, salt)

    def fused32(c):
        qs = [c.iallreduce_arr(mesh_input(c.rank, nfused * 4, f32, devs,
                                          50 + k), SUM)
              for k in range(FUSED_OPS)]
        qs[0].wait()  # the 32nd enqueue already flushed the batch
        return [q.result for q in qs]

    def side(c):
        # each rank on a side stream of its own, its deposit held back
        # by a sleeping kernel and its output read on that stream: a
        # fence that ordered the launches after the wrong stream, or
        # the rank's reads before the wrong done event, reads stale
        # bytes here (one shared stream would hide it)
        dev = devs[c.rank]
        if dev.type != "cuda":
            return c.allreduce_arr(inp(c, MIB, f32, 31) + 1.0, SUM) * 2.0
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            x = inp(c, MIB, f32, 31)
            torch.cuda._sleep(1 << 22)
            return c.allreduce_arr(x + 1.0, SUM) * 2.0

    return [
        ("m_ar1", "allreduce_arr", red,
         lambda c: c.allreduce_arr(inp(c, MIB, f32, 21), SUM), {}),
        ("m_ar8", "allreduce_arr", red,
         lambda c: c.allreduce_arr(inp(c, 8 * MIB, f32, 22), SUM), {}),
        ("m_ar128", "allreduce_arr", red,
         lambda c: c.allreduce_arr(inp(c, 128 * MIB, f32, 23), SUM), {}),
        ("m_ar8_ring", "allreduce_arr", red,
         lambda c: c.allreduce_arr(inp(c, 8 * MIB, f32, 22), SUM),
         {"coll_plan_native_reduce": False}),
        ("m_ar8_rd", "allreduce_arr", red,
         lambda c: c.allreduce_arr(inp(c, 8 * MIB, f32, 22), SUM),
         {"coll_plan_native_reduce": False,
          "coll_pipeline_rd_max_bytes": 16 * MIB}),
        ("m_ar8_seg", "allreduce_arr",
         {"mesh_fold": segs * nc, "peer_copy": segs * nc},
         lambda c: c.allreduce_arr(inp(c, 8 * MIB, f32, 22), SUM),
         {"coll_plan_enable": False}),
        ("m_prod8", "allreduce_arr", red,
         lambda c: c.allreduce_arr(inp(c, 8 * MIB, i32, 24), PROD), {}),
        ("m_rs8", "reduce_scatter_block_arr", {"mesh_fold": nc},
         lambda c: c.reduce_scatter_arr(inp(c, 8 * MIB, f64, 25), MAX), {}),
        ("m_a2a8", "alltoall_arr", {"peer_copy": segs * nc},
         lambda c: c.alltoall_arr(inp(c, 8 * MIB, f32, 26)), {}),
        ("m_a2a1", "alltoall_arr", {"peer_copy": nc},
         lambda c: c.alltoall_arr(inp(c, MIB, f32, 27)), {}),
        ("m_bc8", "bcast_arr", {"peer_copy": segs * nc},
         lambda c: c.bcast_arr(inp(c, 8 * MIB, f32, 28),
                               root=min(3, n - 1)), {}),
        ("m_ag1", "allgather_arr", {"peer_copy": nc},
         lambda c: c.allgather_arr(inp(c, MIB, f32, 29)), {}),
        ("m_pp1", "ppermute_arr", {},
         lambda c: c.ppermute_arr(inp(c, MIB, f32, 30),
                                  [(i, (i + 1) % n) for i in range(n)]),
         {}),
        ("m_fused32", "iallreduce_arr",
         {"slot_pack": n, "mesh_fold": nc, "peer_copy": nc}, fused32, {}),
        ("m_side", "allreduce_arr", red, side, {}),
    ]


def phase_mesh(devs, what: str):
    """The mesh tier through the port's entry points: N = len(devs)
    rank threads, rank r on devs[r] (a LogicalDevice of card 0, or card
    r), every entry point provided by coll/tpu; launch counts checked
    case by case, every result held against its plain computation and
    every rank's bytes against rank 0's."""
    from ompi_tpu_torch.runtime.state import LogicalDevice
    cards = [d.device if isinstance(d, LogicalDevice) else d for d in devs]
    res, launches, per_call = drive(mesh_cases(cards), lambda r: devs[r],
                                    len(devs), "tpu", what)
    check_mesh(cards, res)
    return launches, per_call


def check_mesh(devs, res) -> None:
    from ompi_tpu_torch.kernels.mesh import mesh_fold_plain
    from ompi_tpu_torch.kernels.stacked import (stacked_copy_plain,
                                                stacked_reduce_plain,
                                                tree_plain)
    n = len(devs)
    home = devs[0]

    def inputs(nbytes, dtype, salt):
        return [mesh_input(r, nbytes, dtype, devs, salt).to(home)
                for r in range(n)]

    def check(key, refs, what, replicated=True):
        outs = [res[r][key] for r in range(n)]
        for r, o in enumerate(outs):
            if o.is_cuda and o.device != devs[r]:
                raise AssertionError(f"{key}: rank {r}'s output lies on "
                                     f"{o.device}, not {devs[r]}")
        outs = [o.to(home) for o in outs]
        worst = _held(outs, refs, what)
        if replicated and not all(torch.equal(o.view(torch.uint8),
                                              outs[0].view(torch.uint8))
                                  for o in outs):
            raise AssertionError(f"{key}: ranks disagree")
        same = ", every rank the same bytes" if replicated else ""
        log(f"[tpu] {what}: exact against the plain computation (max abs "
            f"{worst[0]}){same}")

    x1 = inputs(MIB, torch.float32, 21)
    check("m_ar1", stacked_reduce_plain(x1, "MPI_SUM"),
          "allreduce SUM f32 1 MiB (single dispatch, rank order)")
    x8 = inputs(8 * MIB, torch.float32, 22)
    check("m_ar8", stacked_reduce_plain(x8, "MPI_SUM"),
          "allreduce SUM f32 8 MiB (plan, native: rank order)")
    x128 = inputs(128 * MIB, torch.float32, 23)
    check("m_ar128", stacked_reduce_plain(x128, "MPI_SUM"),
          "allreduce SUM f32 128 MiB (plan, native: rank order)")
    del x128
    ring = ("ring", RING_SEG, RING_SEG // n)
    n8 = x8[0].numel()
    want = mesh_fold_plain(x8, 0, n8, "MPI_SUM", ring)
    check("m_ar8_ring", [want] * n,
          "allreduce SUM f32 8 MiB (plan, segring order)")
    check("m_ar8_seg", [want] * n,
          "allreduce SUM f32 8 MiB (8 pipelined segring segments)")
    tree = tree_plain(x8, "MPI_SUM") if n & (n - 1) == 0 else want
    check("m_ar8_rd", [tree] * n,
          "allreduce SUM f32 8 MiB (plan, segrd tree)")
    xp = inputs(8 * MIB, torch.int32, 24)
    check("m_prod8", [mesh_fold_plain(xp, 0, n8, "MPI_PROD", ring)] * n,
          "allreduce PROD int32 8 MiB (plan, segring order)")
    check("m_rs8", stacked_reduce_plain(inputs(8 * MIB, torch.float64, 25),
                                        "MPI_MAX", scatter=True),
          "reduce_scatter MAX f64 8 MiB", replicated=False)
    check("m_a2a8", stacked_copy_plain(inputs(8 * MIB, torch.float32, 26),
                                       "alltoall"),
          "alltoall f32 8 MiB (8 sega2a segments)", replicated=False)
    check("m_a2a1", stacked_copy_plain(inputs(MIB, torch.float32, 27),
                                       "alltoall"),
          "alltoall f32 1 MiB (single dispatch)", replicated=False)
    check("m_bc8", [inputs(8 * MIB, torch.float32, 28)[min(3, n - 1)]] * n,
          "bcast f32 8 MiB (8 segbcast segments)")
    check("m_ag1", stacked_copy_plain(inputs(MIB, torch.float32, 29),
                                      "allgather"), "allgather f32 1 MiB")
    pp = inputs(MIB, torch.float32, 30)
    check("m_pp1", [pp[-1]] + pp[:-1], "ppermute f32 1 MiB ring",
          replicated=False)
    nf = int(FUSED_MIB * MIB) // 4
    for k in range(FUSED_OPS):
        xs = inputs(nf * 4, torch.float32, 50 + k)
        outs = [res[r]["m_fused32"][k].to(home) for r in range(n)]
        _held(outs, stacked_reduce_plain(xs, "MPI_SUM"), f"fused slot {k}")
        if not all(torch.equal(o, outs[0]) for o in outs):
            raise AssertionError(f"fused slot {k}: ranks disagree")
    log(f"[tpu] fused flush of {FUSED_OPS} iallreduce SUM f32 64 KiB: "
        "exact against the plain computation, every rank the same bytes")
    side = stacked_reduce_plain([x + 1.0 for x in inputs(MIB, torch.float32,
                                                          31)], "MPI_SUM")
    check("m_side", [2.0 * y for y in side],
          "allreduce SUM f32 1 MiB, each rank on a side stream behind a "
          "sleeping kernel")
    # the reduced values themselves, against an independent reference
    exact = torch.stack([x.double() for x in x8]).sum(0)
    absum = torch.stack([x.double().abs() for x in x8]).sum(0)
    band = 4 * n * 2.0 ** -24
    for key in ("m_ar8", "m_ar8_ring", "m_ar8_rd", "m_ar8_seg"):
        got = res[0][key].to(home).double()
        bad = ((got - exact).abs() > band * absum).sum()
        if int(bad) or not torch.isfinite(got).all():
            raise AssertionError(f"{key}: allreduce SUM outside the "
                                 f"float32 band at {int(bad)} elements")
    log(f"[tpu] allreduce SUM f32 8 MiB (native, segring, segrd, "
        f"segments) within 4*N*2^-24 of the float64 sum; results finite")


def _kernels_mesh(dev, g) -> int:
    """K6 against its plain version over every pair K1 takes, N = 2, 3,
    8, in rank order, the segring order and (N a power of two) segrd's
    tree, over a whole buffer and a misaligned stripe (NaN for float
    MAX/MIN from make_shard); K2 peer mode for an alltoall destination,
    a clipped gather and a column segment; K7 with zeroed slots and
    odd widths.  Tolerance: exact."""
    from ompi_tpu_torch.kernels import mesh, stacked
    ncases = 0
    for dtype in DTYPES:
        for opname in OPS:
            if not stacked.reduce_supported(dtype, opname):
                continue
            worst = (0.0, 0.0)
            for n in (2, 3, 8):
                seg = 64 * n
                xs = [make_shard(g, 3 * seg + 5, dtype, opname, dev)
                      for _ in range(n)]
                orders = ["rank", ("ring", seg, seg // n)]
                if n & (n - 1) == 0:
                    orders.append("tree")
                for order in orders:
                    for lo, length in ((0, 3 * seg + 5), (3, 50)):
                        out = torch.empty(length, dtype=dtype, device=dev)
                        mesh.mesh_fold(xs, out, lo, opname, order)
                        w = _held([out], [mesh.mesh_fold_plain(
                            xs, lo, length, opname, order)],
                            f"K6 {dtype} {opname} n={n} {order} lo={lo}")
                        worst = (max(worst[0], w[0]), max(worst[1], w[1]))
                        ncases += 1
            log(f"[K6] {str(dtype)[6:]:>8} {opname:<9} max_abs {worst[0]}")
    torch.cuda.synchronize()
    for dtype in (torch.float32, torch.float64, torch.int8, torch.bfloat16,
                  torch.bool):
        for n in (2, 3, 8):
            b = 1031
            xs = [make_shard(g, n * b, dtype, "MPI_SUM", dev)
                  for _ in range(n)]
            for kw in ({"block": b, "src_stride": b, "dst": n - 1},
                       {"block": n * b, "limit": (n - 1) * n * b + 5},
                       {"block": 7, "src_stride": b, "dst": 1, "src_off": 3,
                        "out_stride": b, "out_off": 3}):
                a = torch.zeros(n * n * b, dtype=dtype, device=dev)
                c = a.clone()
                stacked.peer_copy(xs, a, **kw)
                stacked.peer_copy_plain(xs, c, **kw)
                _held([a], [c], f"K2 peer {dtype} n={n} {kw}")
                ncases += 1
            slots = [x[:k] for x, k in zip(xs * 3, (5, 1024, 0, 333, 1))]
            for zero in ([False] * len(slots), [True, False, True, False,
                                                True]):
                _held([mesh.slot_pack(slots, zero)],
                      [mesh.slot_pack_plain(slots, zero)],
                      f"K7 {dtype} n={n}")
                ncases += 1
        log(f"[K2 peer/K7] {str(dtype)[6:]:>8} exact")
    torch.cuda.synchronize()
    return ncases + _kernels_pack(dev, g)


PACK_SKEWS = (0, 1, 2, 4, 8, 12)  # source against destination, bytes mod 16
PACK_SIZES = (0, 1, 3, 15, 16, 17, 49, 16385, 70001)  # elements


def _pack_mix(g, dev, dtype, nslots: int):
    """``nslots`` slots of ``dtype`` (sizes cycling over PACK_SIZES)
    whose sources are skewed from their packed destinations by each
    skew of PACK_SKEWS the element size divides, in turn: slot i is a
    view into an allocation of its own that starts where its bytes sit
    that many bytes before their packed offset, modulo 16."""
    isz = torch.empty((), dtype=dtype).element_size()
    skews = [k for k in PACK_SKEWS if k % isz == 0]
    slots, off = [], 0
    for i in range(nslots):
        n = PACK_SIZES[i % len(PACK_SIZES)]
        a = (off - skews[i % len(skews)]) % 16 // isz
        slots.append(make_shard(g, n + 16, dtype, "MPI_SUM", dev)[a:a + n])
        off += n * isz
    return slots


def _kernels_pack(dev, g) -> int:
    """K7 over slot mixes whose sources are skewed from their
    destinations by 0, 1, 2, 4, 8 and 12 bytes (each the dtype's size
    divides), with empty slots, slots of 1 to 49 elements and of more
    than one block, zero slots (every third), and 64 and 65 slots (one
    launch and two), each mix's launch count checked; and 32 and 65
    slots of one size (64 KiB + 20 B), whose blocks find their slot by
    a division: exact."""
    from ompi_tpu_torch.kernels import mesh
    ncases = 0
    for dtype in (torch.uint8, torch.int16, torch.float32, torch.float64,
                  torch.complex128):
        for nslots in (9, 27, 64, 65):
            slots = _pack_mix(g, dev, dtype, nslots)
            for zero in ([False] * nslots, [i % 3 == 1 for i in range(nslots)]):
                before = mesh.slot_pack.launches.value
                got = mesh.slot_pack(slots, zero)
                torch.cuda.synchronize()
                n = mesh.slot_pack.launches.value - before
                if n != -(-nslots // mesh.MAX_SLOTS):
                    raise AssertionError(f"K7 {dtype} {nslots} slots: {n} "
                                         "launches")
                _held([got], [mesh.slot_pack_plain(slots, zero)],
                      f"K7 {dtype} {nslots} skewed slots zero={any(zero)}")
                ncases += 1
    for nslots in (32, 65):  # one size a slot: ``each`` blocks a slot
        slots = [make_shard(g, 16385, torch.float32, "MPI_SUM", dev)
                 for _ in range(nslots)]
        for zero in ([False] * nslots, [i % 3 == 1 for i in range(nslots)]):
            _held([mesh.slot_pack(slots, zero)],
                  [mesh.slot_pack_plain(slots, zero)],
                  f"K7 {nslots} slots of 16385 f32 zero={any(zero)}")
            ncases += 1
    log(f"[K7] skewed slot mixes exact ({ncases} cases: skews "
        f"{PACK_SKEWS} bytes, empty and zero slots, 64 and 65 slots, "
        "slots of one size)")
    return ncases


def _same_launches(run, start: torch.Tensor, what: str) -> torch.Tensor:
    """``run(buf)`` writes a grouped launch's outputs into ``buf``; two
    runs into two copies of one starting buffer must leave the same
    bytes (bit-identical across two launches).  Returns the first."""
    a, b = start.clone(), start.clone()
    run(a)
    run(b)
    if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
        raise AssertionError(f"{what}: two launches wrote different bytes")
    return a


def _kernels_tables(dev, g) -> int:
    """K6 and K2 peer over destination tables, each against its plain
    version (exact) and bit-identical across two launches.  K6: every
    pair K1 takes, N in {2, 3, 8}, rank order, the segring order and
    (N a power of two) segrd's tree, tables of 1 and 8 jobs, and of 70
    (two launches: 64 + 6) for one pair of each dtype; job lengths that
    are not whole tiles (a 3-tile-and-5 job, 1, 17, a tile less one,
    ...), outputs congruent with their inputs (bulk body with head and
    tail) and one element off (the edge path).  K2 peer: gathers into
    1, 8 and 70 destinations, full and clipped, with PROC_NULL sources
    at either end, sources and outputs aligned and one element off
    (congruent with a head, and not), an alltoall table and a column
    segment; 130 destinations split over two launches."""
    from ompi_tpu_torch.kernels import mesh, stacked
    ncases = 0
    folds = mesh.mesh_fold.launches
    copies = stacked.peer_copy.launches

    def fold_case(xs, k, shift, opname, order, full, what):
        nonlocal ncases
        isz = xs[0].element_size()
        v, te = 16 // isz, mesh.FOLD_TILE // isz
        total = xs[0].numel()
        lens = [3 * te + 5, 1, te, 2 * v + 3, 17, te - 1, 5 * v]
        spec, off = [], 0
        for q in range(k):
            ln = lens[q % len(lens)]
            lo = (q * 131) % (total - ln + 1)
            off += (lo + shift - off) % v  # out congruent (or one off)
            spec.append((lo, ln, off))
            off += ln
        start = torch.zeros(off + v, dtype=xs[0].dtype, device=dev)

        def run(buf):
            before = folds.value
            mesh.mesh_fold_many(xs, [(buf[o:o + ln], lo)
                                     for lo, ln, o in spec], opname, order)
            if folds.value - before != -(-k // mesh.MAX_JOBS):
                raise AssertionError(f"{what}: {folds.value - before} "
                                     "launches")
        got = _same_launches(run, start, what)
        want = start.clone()
        for lo, ln, o in spec:
            want[o:o + ln] = full[lo:lo + ln]
        _held([got], [want], what)
        ncases += 1

    for dtype in DTYPES:
        isz = torch.empty((), dtype=dtype).element_size()
        total = 4 * (mesh.FOLD_TILE // isz) + 9
        first_pair = True
        for opname in OPS:
            if not stacked.reduce_supported(dtype, opname):
                continue
            for n in (2, 3, 8):
                xs = [make_shard(g, total, dtype, opname, dev)
                      for _ in range(n)]
                orders = ["rank", ("ring", 64 * n, 64)]
                if n & (n - 1) == 0:
                    orders.append("tree")
                for order in orders:
                    full = mesh.mesh_fold_plain(xs, 0, total, opname, order)
                    for k in (1, 8) + ((70,) if first_pair else ()):
                        for shift in (0, 1):
                            fold_case(xs, k, shift, opname, order, full,
                                      f"K6 table {dtype} {opname} n={n} "
                                      f"{order} jobs={k} shift={shift}")
            first_pair = False
        log(f"[K6 tables] {str(dtype)[6:]:>8} exact, two launches the same "
            "bytes")
    torch.cuda.synchronize()

    def copy_case(srcs, dt, nd, kw, shift, what, span):
        nonlocal ncases
        start = torch.full((nd * (span + 16) + 16,), 3, dtype=dt,
                           device=dev)
        offs = [q * (span + 16) + shift for q in range(nd)]

        def run(buf):
            before = copies.value
            stacked.peer_copy_many(srcs, [buf[o:o + span] for o in offs],
                                   **kw)
            if copies.value - before != -(-nd // stacked.MAX_PTRS):
                raise AssertionError(f"{what}: {copies.value - before} "
                                     "launches")
        got = _same_launches(run, start, what)
        want = start.clone()
        stacked.peer_copy_many_plain(srcs, [want[o:o + span] for o in offs],
                                     **kw)
        _held([got], [want], what)
        ncases += 1

    for dtype in (torch.float32, torch.float64, torch.int8, torch.bfloat16,
                  torch.bool, torch.complex128):
        isz = torch.empty((), dtype=dtype).element_size()
        b = 2 * (stacked.COPY_TILE // isz) + 7  # two tiles and 7
        for n in (2, 3, 8):
            for ss in (0, 1):
                xs = [make_shard(g, n * b + 8 + ss, dtype, "MPI_SUM",
                                 dev)[ss:] for _ in range(n)]
                nulls = [None] + xs[1:-1] + [None]
                for so in (0, 1):
                    tag = f"K2 peer {dtype} n={n} src+{ss} out+{so}"
                    for srcs, label in ((xs, "gather"), (nulls, "nulls")):
                        for nd in (1, 8, 70):
                            for kw in ({"block": b},
                                       {"block": b, "limit": (n - 1) * b + 5}):
                                copy_case(srcs, dtype, nd, kw, so,
                                          f"{tag} {label} "
                                          f"dsts={nd} {kw}", n * b)
                    copy_case(xs, dtype, n, {"block": b, "src_stride": b},
                              so, f"{tag} alltoall", n * b)
                    copy_case(xs, dtype, n, {"block": 7, "src_stride": b,
                                      "src_off": 3, "out_stride": b,
                                      "out_off": 3}, so,
                              f"{tag} column segment", n * b)
        log(f"[K2 peer tables] {str(dtype)[6:]:>8} exact, two launches the "
            "same bytes")
    xs = [make_shard(g, 1000, torch.int32, "MPI_SUM", dev) for _ in range(3)]
    copy_case(xs, torch.int32, 130, {"block": 333}, 0,
              "K2 peer 130 destinations", 999)
    torch.cuda.synchronize()
    return ncases


def _kernels_entry(dev, g) -> int:
    """K12 driver_step against driver_step_plain for float32, float64,
    int32, float16 and bfloat16, R in {2, 8}, N in {8, 1024, 2**21 and
    an odd multiple of R} (one launch a call); its refusal of N % R !=
    0 on the card; and K2 peer with null sources: a 2*3-slot table with
    PROC_NULL at either end, zeros in the null blocks.  Exact."""
    from ompi_tpu_torch.kernels import entry, stacked
    ncases = 0
    for dtype in (torch.float32, torch.float64, torch.int32,
                  torch.float16, torch.bfloat16):
        worst = 0.0
        for r in (2, 8):
            for n in (8, 1024, 1 << 21, 37 * r):
                if dtype == torch.int32:
                    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (r, n),
                                      generator=g, device=dev,
                                      dtype=torch.int32)
                else:
                    x = torch.randn(r, n, generator=g, device=dev
                                    ).to(dtype)
                before = entry.driver_step.launches.value
                got = entry.driver_step(x)
                if entry.driver_step.launches.value != before + 1:
                    raise AssertionError("K12: not one launch a call")
                w = _held(list(got), list(entry.driver_step_plain(x)),
                          f"K12 {dtype} R={r} N={n}")
                worst = max(worst, w[0])
                ncases += 1
        log(f"[K12] {str(dtype)[6:]:>8} max_abs {worst}")
    try:
        entry.driver_step(torch.ones(8, 1020, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("K12 took N % R != 0")
    torch.cuda.synchronize()
    for dtype in (torch.float32, torch.int32, torch.int8, torch.float64):
        for b in (1 << 18, 1031):
            xs = [make_shard(g, b, dtype, "MPI_SUM", dev) for _ in range(4)]
            srcs = [None, xs[0], xs[1], xs[2], xs[3], None]
            a = torch.full((6 * b,), 3, dtype=dtype, device=dev)
            c = a.clone()
            before = stacked.peer_copy.launches.value
            stacked.peer_copy(srcs, a, b)
            if stacked.peer_copy.launches.value != before + 1:
                raise AssertionError("K2 peer: not one launch a table")
            stacked.peer_copy_plain(srcs, c, b)
            _held([a], [c], f"K2 peer null sources {dtype} block {b}")
            if a[:b].any() or a[-b:].any():
                raise AssertionError("K2 peer: a null block is not zero")
            ncases += 1
    log("[K2 peer] null sources (PROC_NULL at either end of a 2*3-slot "
        "table) exact, zeros in the null blocks")
    torch.cuda.synchronize()
    return ncases


RMA_DTYPES = [torch.uint8, torch.int8, torch.int16, torch.uint16,
              torch.int32, torch.uint32, torch.int64, torch.uint64,
              torch.float32, torch.float64, torch.complex64,
              torch.complex128, torch.bool]
RMA_OPS = OPS + ["MPI_REPLACE", "MPI_NO_OP"]


def rma_values(g: torch.Generator, n: int, dtype, dev) -> torch.Tensor:
    """n elements of a window wire dtype, made on the card from ``g``:
    real floats with NaN, signed zeros and infinities sprinkled in, bool
    as raw bytes 0, 1 and 2 (a 2 must read as true)."""
    if dtype == torch.bool:
        return torch.randint(0, 3, (n,), generator=g, device=dev,
                             dtype=torch.uint8).view(torch.bool)
    if dtype.is_floating_point:
        x = torch.randn(n, generator=g, device=dev, dtype=dtype)
        if n > 8:
            idx = torch.randint(0, n, (max(4, n // 50),), generator=g,
                                device=dev)
            special = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                                    -float("inf")], dtype=dtype, device=dev)
            x[idx] = special[torch.randint(0, 5, idx.shape, generator=g,
                                           device=dev)]
        return x
    if dtype.is_complex:
        return torch.randn(n, generator=g, device=dev, dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -2 ** 62), min(info.max, 2 ** 62),
                         (n,), generator=g, device=dev,
                         dtype=torch.int64).to(dtype)


def _same_bytes(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8)):
        raise AssertionError(f"{what}: kernel bytes differ from the plain "
                             "version's")


def _cas_cases(dtype):
    """(window value, compare, new, swaps) of K10's value cases."""
    nan, inf = float("nan"), float("inf")
    if dtype.is_complex:
        return [(1 + 2j, 1 + 2j, 3 - 1j, True), (1 + 2j, 1 - 2j, 5j, False),
                (complex(-0.0, 0.0), complex(0.0, -0.0), 7 + 0j, True),
                (complex(nan, 0.0), complex(nan, 0.0), 1 + 0j, False)]
    if dtype.is_floating_point:
        return [(-0.0, 0.0, 5.0, True), (nan, nan, 5.0, False),
                (1.5, 1.5, -inf, True), (1.5, 2.5, 7.0, False)]
    if dtype == torch.bool:
        return [(2, True, False, True), (0, False, True, True),
                (1, False, False, False)]
    top = min(torch.iinfo(dtype).max, 2 ** 62)
    return [(5, 5, top, True), (5, 6, 1, False), (top, top, 0, True)]


COPY_SIZES = (1, 15, 16, 17, 31, 4096 + 13, 65536 + 13)  # bytes


def _kernels_copy_shifts(dst_dev, src_dev, g) -> int:
    """K8 at every destination shift 0-15 against source offsets 0 and
    3, at sizes across the head, body and tail edges (COPY_SIZES): each
    source a fresh allocation of offset + n bytes, so that its span
    starts at the tensor's first byte (offset 0) and always ends at its
    last, and the aligned source words the kernel reads reach past the
    span on both sides.  The launch runs on the destination's card; the
    source may lie on a peer card.  Exact, byte for byte, the whole
    destination buffer against the plain version's."""
    from ompi_tpu_torch.kernels import rma
    ncases = 0
    for n in COPY_SIZES:
        for s_off in (0, 3):
            src = torch.randint(0, 256, (s_off + n,), generator=g,
                                device=g.device, dtype=torch.uint8
                                ).to(src_dev)
            for d_off in range(16):
                base = torch.randint(0, 256, (n + 32,), generator=g,
                                     device=g.device, dtype=torch.uint8
                                     ).to(dst_dev)
                a, b = base.clone(), base.clone()
                rma.rma_copy(a, d_off, src, s_off, n)
                rma.rma_copy_plain(b, d_off, src.to(dst_dev), s_off, n)
                _same_bytes(a, b, f"K8 n={n} dst+{d_off} src+{s_off} "
                            f"({src_dev} -> {dst_dev})")
                ncases += 1
    torch.cuda.synchronize()
    return ncases


def _kernels_rma(dev, g) -> int:
    """K8 at unaligned heads and tails and at every destination shift
    (``_kernels_copy_shifts``); K9 over every wire dtype and every op
    it takes (REPLACE and NO_OP included), plain and fetch, at aligned
    and misaligned byte offsets; K10's value cases (signed zeros, NaN,
    complex parts, bool bytes) at aligned and misaligned offsets.
    Tolerance: exact, byte for byte; K10 also against the expected
    swap."""
    from ompi_tpu_torch.kernels import rma
    ncases = 0
    for n in (1, 15, 16, 17, 1000, 65536 + 13):
        src = torch.randint(0, 256, (n + 16,), generator=g, device=dev,
                            dtype=torch.uint8)
        for d_off in (0, 1, 7, 16):
            for s_off in (0, 3, 16):
                base = torch.randint(0, 256, (n + 32,), generator=g,
                                     device=dev, dtype=torch.uint8)
                a, b = base.clone(), base.clone()
                rma.rma_copy(a, d_off, src, s_off, n)
                rma.rma_copy_plain(b, d_off, src, s_off, n)
                _same_bytes(a, b, f"K8 n={n} dst+{d_off} src+{s_off}")
                ncases += 1
    shifts = _kernels_copy_shifts(dev, dev, g)
    ncases += shifts
    log("[K8] rma_copy exact (unaligned heads and tails; every "
        "destination shift 0-15 against source offsets 0 and 3 at "
        f"{len(COPY_SIZES)} sizes, {shifts} of the {ncases} cases)")
    for dtype in RMA_DTYPES:
        isz = torch.empty((), dtype=dtype).element_size()
        v = 16 // isz
        ops = [o for o in RMA_OPS if rma.acc_supported(dtype, o)]
        # (count, start byte, s and old element offsets): the first five
        # as before; then every start of 0, isz, 1, 4, 16 - isz, 17 at
        # max(1, V - 1), V + 1 and 1029 elements, s and old in turn one
        # element off their allocation's 16-byte-aligned start
        cases = [(c, st, 0, 0) for c, st in ((1, 0), (1, 3), (1029, 0),
                                             (1029, isz + 1),
                                             (4096 * 8 + 5, 16))]
        for k, start in enumerate(sorted({0, isz, 1, 4, 16 - isz, 17})):
            for j, count in enumerate((max(1, v - 1), v + 1, 1029)):
                cases.append((count, start, (k + j) % 2, (k + j + 1) % 2))
        for opname in ops:
            for count, start, s_off, o_off in cases:
                nb = count * isz
                w0 = torch.randint(0, 256, (start + nb + 5,), generator=g,
                                   device=dev, dtype=torch.uint8)
                w0[start:start + nb] = rma_values(g, count, dtype,
                                                  dev).view(torch.uint8)
                s = rma_values(g, count + s_off, dtype, dev)[s_off:]
                for fetch in (False, True):
                    wk, wp = w0.clone(), w0.clone()
                    ok = torch.empty(count + o_off, dtype=dtype,
                                     device=dev)[o_off:] if fetch else None
                    op_ = torch.empty(count, dtype=dtype, device=dev) \
                        if fetch else None
                    rma.rma_acc(wk, start, s, opname, ok)
                    rma.rma_acc_plain(wp, start, s, opname, op_)
                    what = (f"K9 {dtype} {opname} count={count} "
                            f"start={start} s+{s_off} old+{o_off} "
                            f"fetch={fetch}")
                    _same_bytes(wk, wp, what)
                    if fetch:
                        _same_bytes(ok, op_, what + " (old)")
                        _same_bytes(ok, w0[start:start + nb], what + " old")
                    ncases += 1
        log(f"[K9] {str(dtype)[6:]:>10} {len(ops)} ops exact, plain and "
            f"fetch, {len(cases)} (count, start, s, old) cases each")
    torch.cuda.synchronize()
    for dtype in RMA_DTYPES:
        isz = torch.empty((), dtype=dtype).element_size()
        for wv, cv, nv, swaps in _cas_cases(dtype):
            for start in (0, 1):
                w0 = torch.randint(0, 256, (start + isz + 3,), generator=g,
                                   device=dev, dtype=torch.uint8)
                if dtype == torch.bool:
                    elem = torch.tensor([wv], dtype=torch.uint8, device=dev)
                else:
                    elem = torch.tensor([wv], dtype=dtype,
                                        device=dev).view(torch.uint8)
                w0[start:start + isz] = elem.view(torch.uint8)
                c = torch.tensor([cv], dtype=dtype, device=dev)
                nw = torch.tensor([nv], dtype=dtype, device=dev)
                wk, wp = w0.clone(), w0.clone()
                ok = torch.empty(1, dtype=dtype, device=dev)
                op_ = torch.empty(1, dtype=dtype, device=dev)
                rma.rma_cas(wk, start, c, nw, ok)
                rma.rma_cas_plain(wp, start, c, nw, op_)
                what = f"K10 {dtype} {wv!r} vs {cv!r} start={start}"
                _same_bytes(wk, wp, what)
                _same_bytes(ok, op_, what + " (old)")
                _same_bytes(ok, w0[start:start + isz], what + " old")
                want = nw.view(torch.uint8) if swaps else elem
                _same_bytes(wk[start:start + isz], want, what + " swap")
                ncases += 1
    log("[K10] rma_cas exact, every wire dtype, value cases (signed zeros, "
        "NaN, complex parts, bool bytes) aligned and misaligned")
    torch.cuda.synchronize()
    return ncases


def rma_side(comm):
    """Each rank writes its origin on a side stream of its own behind a
    sleeping kernel, puts it to its right neighbour and, after a fence,
    get_accumulates it there into a card-tensor result: the window's
    stream must wait for the write, and the result must be read after
    the op (one shared stream would hide a missing wait)."""
    from ompi_tpu_torch import osc
    from ompi_tpu_torch.op.op import SUM
    n, dev = 1 << 20, comm.device
    right = (comm.rank + 1) % comm.size
    win = osc.allocate(comm, 4 * n, disp_unit=4, name="side")
    win.fence()
    side = torch.cuda.stream(torch.cuda.Stream(dev)) \
        if dev.type == "cuda" else contextlib.nullcontext()
    with side:
        x = torch.zeros(n, dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            torch.cuda._sleep(1 << 22)
        x += comm.rank + 1
        win.put(x, right)
        win.fence()
        got = win.memory.view(torch.float32)
        comm.Barrier()  # every rank has read before any writes again
        res = torch.empty(n, dtype=torch.float32, device=dev)
        win.get_accumulate(x, res, right, op=SUM)
        win.fence()
        after = win.memory.view(torch.float32)
        left = (comm.rank - 1) % comm.size + 1
        ok = (bool((got == left).all()), bool((res == comm.rank + 1).all()),
              bool((after == 2 * left).all()))
    win.free()
    return {"component": type(win).__name__, "ok": ok}


def phase_rma(devs, what: str):
    """One-sided RMA through the port's entry points (osc.allocate,
    put/get/accumulate/fetch_and_op/compare_and_swap, fence, lock,
    flush): N = len(devs) rank threads, rank r on devs[r].  The
    rma_counter and halo_stencil workloads under the device window
    with numpy and with card-tensor origins, in both lowerings
    (osc_device_dma 1 and 0), and under --mca osc pt2pt with host
    numpy buffers; then the side-stream case in both lowerings.  Every
    counter is zeroed just before each run and read just after; each
    run must launch exactly: a put or get, one K8 with dma 0 and none
    with dma 1; an accumulate, get_accumulate or fetch_and_op, one K9;
    a CAS, one K10.  Every workload's bytes must be the pt2pt run's
    (and, for the halo, the expected halo)."""
    from ompi_tpu_torch import osc
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.op import op as ops
    # registers osc_device_dma
    from ompi_tpu_torch.osc import device as _  # noqa: F401
    from ompi_tpu_torch.testing import run_ranks
    from ompi_tpu_torch.testing.rma import (Buffers, counter_workload,
                                            expected_halo, halo_workload)
    n = len(devs)
    counters = launch_counters()
    per_call, total = {}, {k: 0 for k in counters}

    def run(key, fn, dma, pt2pt, want, kind):
        saved = (registry.get("osc_device_dma"), registry.get("osc"))
        registry.set("osc_device_dma", saved[0] if dma is None else dma)
        registry.set("osc", "pt2pt" if pt2pt else "")
        try:
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            res = run_ranks(n, fn, device_map=lambda r: devs[r], timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: c.value for k, c in counters.items()}
        finally:
            registry.set("osc_device_dma", saved[0])
            registry.set("osc", saved[1])
        want = {k: want.get(k, 0) for k in counters}
        log(f"[rma] {what}: {key} in {wall:.3f} s, launches "
            f"{ {k: v for k, v in got.items() if v} }")
        if got != want:
            raise AssertionError(f"{key}: launches {got}, expected {want}")
        if any(r["component"] != kind for r in res):
            raise AssertionError(f"{key}: windows "
                                 f"{[r['component'] for r in res]}, not "
                                 f"{kind}")
        per_call[key] = got
        for k in total:
            total[k] += got[k]
        return res

    for wl in ("rma_counter", "halo_stencil"):
        def make(bufs, _wl=wl):
            return counter_workload(osc, ops, bufs) \
                if _wl == "rma_counter" else halo_workload(osc, bufs)
        ref = run(f"{wl}_pt2pt", make(Buffers(False)), None, True, {},
                  "Window")
        for tensors in (False, True):
            for dma in (1, 0):
                # a rank: counter 1 put + 2 gets, 5 fetch_and_op, 1 CAS;
                # halo 2 puts
                want = ({"rma_copy": 3 * n * (1 - dma), "rma_acc": 5 * n,
                         "rma_cas": n} if wl == "rma_counter"
                        else {"rma_copy": 2 * n * (1 - dma)})
                key = f"{wl}_{'tensor' if tensors else 'numpy'}_dma{dma}"
                res = run(key, make(Buffers(tensors)), dma, False, want,
                          "DeviceWindow")
                for r in range(n):
                    a = {k: v for k, v in res[r].items() if k != "component"}
                    b = {k: v for k, v in ref[r].items() if k != "component"}
                    if a != b:
                        raise AssertionError(f"{key}: rank {r}'s bytes "
                                             "differ from the pt2pt run's")
        if wl == "halo_stencil":
            for r in range(n):
                if ref[r]["halo"] != expected_halo(r, n):
                    raise AssertionError(f"halo of rank {r} is wrong")
        log(f"[rma] {what}: {wl} byte-identical across pt2pt (numpy) and "
            "the device window (numpy and card-tensor origins, dma 1 and 0)")
    for dma in (1, 0):
        res = run(f"side_stream_dma{dma}", rma_side, dma, False,
                  {"rma_copy": n * (1 - dma), "rma_acc": n}, "DeviceWindow")
        if not all(all(r["ok"]) for r in res):
            raise AssertionError(f"side-stream case, dma {dma}: "
                                 f"{[r['ok'] for r in res]}")
    log(f"[rma] {what}: side-stream origins arrive whole, results read "
        "after the op (dma 1 and 0)")
    return total, per_call


# ---------------------------------------------------------------------------
# 3d. the integrity (SDC) plane on both tiers
# ---------------------------------------------------------------------------

IG_ARM = {"integrity_enable": 1, "integrity_sample": 1,
          "integrity_sample_auto": 0}
IG_INJECT = {"ft_inject_plan": "device_sdc:1", "ft_inject_victim_rank": "1",
             "ft_inject_sdc_period": 1}
IG_PVARS = ("integrity_checks", "integrity_mismatches",
            "integrity_convictions", "integrity_retry_ops")


def _mesh_folds(n: int, devs, itemsize: int) -> int:
    """K6 launches of one mesh allreduce of n elements over members on
    ``devs``: one a card that holds a member whose stripe is not
    empty."""
    from ompi_tpu_torch.coll.device import _stripe_elems
    m = _stripe_elems(n, len(devs), itemsize)
    return len({devs[d] for d in range(len(devs)) if d * m < n})


def integrity_cases(devs, tier: str, injected: bool):
    """The integrity phase at N = len(devs) ranks (``devs``: each rank's
    torch device): the cases, as (key, entry point, launches, call,
    knobs, analytic result of rank r), and the number of checked
    meetings.  Every value is exact, so each result is analytic; the
    victim's (rank 1's) values are chosen so that its flip (bit 6 of
    the middle element's top byte) moves every digest out of its band:
    float32 (r+1)/16 becomes ~1e37, int32 gains 2**30, 17.0 drops to
    ~1e-38.

    Launches: a checked meeting is N K11 gate launches, one verify
    launch a device that holds outputs to check (rank 0's output, or
    for reduce_scatter and alltoall every rank's) and, injected, one
    bisect launch a device that holds deposits; injected, each body
    runs twice (the retry).  Segments are meetings of their own.  A
    mesh body is one K6 / K2 peer launch a card."""
    from ompi_tpu_torch.op.op import MAX, SUM
    n = len(devs)
    ndev = len(set(devs))
    f32, f16, i32 = torch.float32, torch.float16, torch.int32
    mesh = tier == "tpu"
    body = 2 if injected else 1
    segs = 8
    meetings = [0]
    e1, e8 = MIB // 4, 8 * MIB // 4  # float32 / int32 elements

    def full(c, n_el, v, dtype):
        return torch.full((n_el,), v, dtype=dtype, device=devs[c.rank])

    def want_full(n_el, v, dtype):
        return lambda r: torch.full((n_el,), v, dtype=dtype, device=devs[r])

    def red(k=1):
        if mesh:
            return {"mesh_fold": body * k * ndev,
                    "peer_copy": body * k * ndev}
        return {"stacked_reduce": body * k}

    def with_digest(d, k=1, every_out=False):
        meetings[0] += k
        per = n + (ndev if every_out else 1) + (ndev if injected else 0)
        return dict(d, digest=per * k)

    tot = n * (n + 1) // 2  # sum of r + 1
    cases = [
        ("ar1", "allreduce_arr", with_digest(red()),
         lambda c: c.allreduce_arr(full(c, e1, (c.rank + 1) / 16, f32), SUM),
         {}, want_full(e1, tot / 16, f32)),
        ("ar8", "allreduce_arr", with_digest(red()),
         lambda c: c.allreduce_arr(full(c, e8, (c.rank + 1) / 16, f32), SUM),
         {}, want_full(e8, tot / 16, f32)),
        ("ar8_seg", "allreduce_arr", with_digest(red(segs), segs),
         lambda c: c.allreduce_arr(full(c, e8, (c.rank + 1) / 16, f32), SUM),
         {"coll_plan_enable": False}, want_full(e8, tot / 16, f32)),
        ("max", "allreduce_arr", with_digest(red()),
         lambda c: c.allreduce_arr(full(c, e1, (c.rank + 1) * 100, i32), MAX),
         {}, want_full(e1, n * 100, i32)),
        ("bc", "bcast_arr", with_digest({}),
         lambda c: c.bcast_arr(full(c, e1, c.rank * 10 + 7, f32), root=1),
         {}, want_full(e1, 17.0, f32)),
        ("rs", "reduce_scatter_block_arr", with_digest(
            {"mesh_fold": body * ndev} if mesh else {"stacked_reduce": body},
            every_out=True),
         lambda c: c.reduce_scatter_arr(
             full(c, e1, (c.rank + 1) / 16, f32), SUM),
         {}, want_full(e1 // n, tot / 16, f32)),
        ("ag", "allgather_arr", with_digest(
            {"peer_copy": body * ndev} if mesh else {"stacked_copy": body}),
         lambda c: c.allgather_arr(full(c, e1, c.rank + 1, i32)), {},
         lambda r: torch.arange(1, n + 1, dtype=i32, device=devs[r])
         .repeat_interleave(e1)),
        ("a2a1", "alltoall_arr", with_digest(
            {"peer_copy": body * ndev} if mesh else {"stacked_copy": body},
            every_out=True),
         lambda c: c.alltoall_arr(full(c, e1, c.rank + 1, i32)), {},
         lambda r: torch.arange(1, n + 1, dtype=i32, device=devs[r])
         .repeat_interleave(e1 // n)),
        ("a2a8", "alltoall_arr", with_digest(
            {"peer_copy": body * segs * ndev} if mesh
            else {"stacked_copy": body * segs}, segs, every_out=True),
         lambda c: c.alltoall_arr(full(c, e8, c.rank + 1, i32)), {},
         lambda r: torch.arange(1, n + 1, dtype=i32, device=devs[r])
         .repeat_interleave(e8 // n)),
    ]

    def fused(c):
        r = c.rank
        qs = [c.iallreduce_arr(full(c, 16, r + 1, f32), SUM),
              c.iallreduce_arr(full(c, 4, (r + 1) * 10, i32), MAX),
              c.ibcast_arr(full(c, 8, r * 2 + 3, i32), 1)]
        for q in qs:
            q.wait()
        return [q.result for q in qs]

    # groups (SUM f32 16), (MAX i32 4), (SUM i32 8: the bcast)
    if mesh:
        folds = sum(_mesh_folds(k, devs, 4) for k in (16, 4, 8))
        fl = {"slot_pack": 3 * n, "mesh_fold": body * folds,
              "peer_copy": body * 3 * ndev}
    else:
        fl = {"fused_batch": body * 3}
    cases.append(("fused", "ibcast_arr", with_digest(fl), fused, {},
                  lambda r: [torch.full((16,), float(tot), device=devs[r]),
                             torch.full((4,), n * 10, dtype=i32,
                                        device=devs[r]),
                             torch.full((8,), 5, dtype=i32, device=devs[r])]))
    if not injected:
        cases.append((
            "f16", "allreduce_arr", with_digest(red()),
            lambda c: c.allreduce_arr(full(c, e1 * 2, (c.rank + 1) / 16, f16),
                                      SUM),
            {}, want_full(e1 * 2, tot / 16, f16)))
        # bfloat16 is unchecked (the reference never checks it): no K11
        cases.append((
            "bf16", "allreduce_arr", red(),
            lambda c: c.allreduce_arr(full(c, e1 * 2, (c.rank + 1) / 16,
                                           torch.bfloat16), SUM),
            {}, want_full(e1 * 2, tot / 16, torch.bfloat16)))
    return cases, meetings[0]


def phase_integrity(devs, tier: str, what: str, modes=(True, False)):
    """The integrity plane through the port's entry points, armed at
    1-in-1 (integrity_sample 1, integrity_sample_auto 0), on N =
    len(devs) rank threads of ``tier``.  Injected (ft_inject_plan
    device_sdc:1, victim rank 1, sdc_period 1: rank 1 flips its operand
    at every meeting): every result must be its analytic value byte for
    byte, the convictions exactly rank 1, mismatches = retries =
    convictions = the checked meetings.  Clean (no plan; the same mix
    plus a float16 SUM and an unchecked bfloat16 SUM): zero mismatches,
    checks > 0.  Launch counts (K11 included) exact, case by case.
    ``modes``: the runs to make (True injected, False clean)."""
    from ompi_tpu_torch import ft_inject  # noqa: F401  (registers knobs)
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.obs import integrity as ig
    n = len(devs)
    launches, per_call = {}, {}
    for injected in modes:
        knobs = dict(IG_ARM, **(IG_INJECT if injected else
                                {"ft_inject_plan": ""}))
        saved = {k: registry.get(k) for k in knobs}
        for k, v in knobs.items():
            registry.set(k, v)
        ig.reset()
        base = {k: registry._pvars[k].read() for k in IG_PVARS}
        label = "injected" if injected else "clean"
        plan, meetings = integrity_cases(
            [d.device if hasattr(d, "slot") else d for d in devs], tier,
            injected)
        try:
            res, got, calls = drive([c[:5] for c in plan], lambda r: devs[r],
                                    n, tier, f"integrity {label}, {what}")
        finally:
            for k, v in saved.items():
                registry.set(k, v)
            ig.refresh()
        pv = {k: registry._pvars[k].read() - base[k] for k in IG_PVARS}
        convicted = sorted({r["rank"] for r in ig.convicted_snapshot()})
        ig.reset()
        for key, _, _, _, _, want in plan:
            for r in range(n):
                outs, wants = res[r][key], want(r)
                if isinstance(outs, torch.Tensor):
                    outs, wants = [outs], [wants]
                for o, w in zip(outs, wants):
                    if o.dtype != w.dtype or o.shape != w.shape or \
                            not torch.equal(o.view(torch.uint8),
                                            w.view(torch.uint8)):
                        raise AssertionError(
                            f"integrity {label} {tier} {key}: rank {r}'s "
                            "result is not its analytic value")
        if injected:
            if convicted != [1] or not (
                    pv["integrity_mismatches"] == pv["integrity_retry_ops"]
                    == pv["integrity_convictions"] == meetings):
                raise AssertionError(f"integrity injected {tier}: convicted "
                                     f"{convicted}, pvars {pv}, {meetings} "
                                     "checked meetings")
        elif pv["integrity_mismatches"] or convicted \
                or pv["integrity_checks"] != n * meetings:
            raise AssertionError(f"integrity clean {tier}: pvars {pv}, "
                                 f"convicted {convicted}")
        log(f"[integrity] {what}, {label}: {len(plan)} cases, every result "
            f"its analytic value, convicted {convicted}, pvars {pv}, K11 "
            f"launches {got['digest']}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        per_call.update({f"ig_{tier}_{label}_{k}": v
                         for k, v in calls.items()})
    return launches, per_call


# ---------------------------------------------------------------------------
# 3e. the halo path: device p2p, cartesian topologies, neighbour gathers
# ---------------------------------------------------------------------------

def halo_grids(n: int):
    """(periodic 2-D grid, open grid) of the halo phase at n ranks:
    [2, n // 2] periodic and dims_create(n, 3) without periods
    ([2, 4] and [2, 2, 2] at 8 ranks)."""
    from ompi_tpu_torch.topo import dims_create
    return [2, n // 2], dims_create(n, 3)


def halo_cases(devs):
    """(key, entry point, launches, call, knobs) of the halo phase at
    N = len(devs) ranks, rank r on devs[r]: the sendrecv_arr ring at 8
    MiB f32, the reuse and side-stream cases, byte and object messages
    interleaved, shift_arr along both dims of the periodic grid both
    ways and neighbor_allgather_arr on it at 8 MiB f32 (one K2 peer
    launch a member), neighbor_allgather_arr on the open grid at 1 MiB
    int32 (PROC_NULL blocks zero), and the host neighbour
    collectives (None: no collective provider to check)."""
    import numpy as np
    n = len(devs)
    f32, i32 = torch.float32, torch.int32
    grid, open_grid = halo_grids(n)

    def inp(c, nbytes, dtype, salt):
        return mesh_input(c.rank, nbytes, dtype, devs, salt)

    def ring(c):
        return c.sendrecv_arr(inp(c, 8 * MIB, f32, 41), (c.rank + 1) % n,
                              (c.rank - 1) % n, tag=41)

    def reuse(c):
        # the sender overwrites its tensor right after send_arr: what
        # arrives is the bytes of the send
        x = inp(c, MIB, f32, 42)
        c.send_arr(x, (c.rank + 1) % n, tag=42)
        x.fill_(-1.0)
        return c.recv_arr((c.rank - 1) % n, tag=42), x

    def side(c):
        # the sender writes x on a side stream of its own behind a
        # sleeping kernel, then sends from that stream; the receiver
        # reads on its own current stream: only the payload's event
        # orders the read after the copy
        dev = devs[c.rank]
        if dev.type == "cuda":
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                torch.cuda._sleep(1 << 22)
                x = inp(c, MIB, f32, 43) * 3.0
                c.send_arr(x, (c.rank + 1) % n, tag=43)
        else:
            c.send_arr(inp(c, MIB, f32, 43) * 3.0, (c.rank + 1) % n, tag=43)
        return c.recv_arr((c.rank - 1) % n, tag=43) + 1.0

    def mixed(c):
        peer = c.rank ^ 1
        if c.rank % 2 == 0:
            c.Send(np.array([7 + c.rank], np.int64), peer, tag=44)
            c.send_arr(inp(c, MIB, f32, 44), peer, tag=44)
            c.Send(np.array([8 + c.rank], np.int64), peer, tag=44)
            return None
        y = np.empty(1, np.int64)
        c.Recv(y, peer, tag=44)
        a = int(y[0])
        arr = c.recv_arr(peer, tag=44)
        c.Recv(y, peer, tag=44)
        return a, arr, int(y[0])

    def shifts(c):
        cart = c.Create_cart(grid, periods=[True, True])
        x = inp(c, 8 * MIB, f32, 45)
        return [cart.shift_arr(x, d, s) for d in (0, 1) for s in (1, -1)]

    def nbr(c):
        cart = c.Create_cart(grid, periods=[True, True])
        return cart.neighbor_allgather_arr(inp(c, 8 * MIB, f32, 46))

    def nbr_open(c):
        cart = c.Create_cart(open_grid)
        return cart.neighbor_allgather_arr(inp(c, MIB, i32, 47))

    def host(c):
        cart = c.Create_cart(grid, periods=[True, True])
        s = np.arange(3, dtype=np.int64) + 10 * c.rank
        r = np.zeros(12, dtype=np.int64)
        cart.Neighbor_allgather(s, r)
        s2 = np.arange(4, dtype=np.int64) + 100 * c.rank
        r2 = np.zeros(4, dtype=np.int64)
        cart.Neighbor_alltoall(s2, r2)
        return r, r2

    return [
        ("h_ring8", None, {}, ring, {}),
        ("h_reuse", None, {}, reuse, {}),
        ("h_side", None, {}, side, {}),
        ("h_mixed", None, {}, mixed, {}),
        ("h_shift8", "ppermute_arr", {}, shifts, {}),
        ("h_nbr8", "neighbor_allgather_arr", {"peer_copy": n}, nbr, {}),
        ("h_nbr_open", "neighbor_allgather_arr", {"peer_copy": n},
         nbr_open, {}),
        ("h_host", None, {}, host, {}),
    ]


def phase_halo(devs, tier: str, what: str):
    """The halo path through the port's entry points: N = len(devs)
    rank threads, rank r on devs[r] (a LogicalDevice of card 0: the
    mesh tier; card 0 itself: coll/hbm; or card r); launch counts
    checked case by case, every result exact against a plain
    computation."""
    from ompi_tpu_torch.runtime.state import LogicalDevice
    cards = [d.device if isinstance(d, LogicalDevice) else d for d in devs]
    res, launches, per_call = drive(halo_cases(cards), lambda r: devs[r],
                                    len(devs),
                                    tier, what)
    check_halo(cards, res, tier)
    return launches, {f"{k}_{tier}": v for k, v in per_call.items()}


def check_halo(devs, res, tier: str) -> None:
    import numpy as np
    from ompi_tpu_torch.pml.request import PROC_NULL
    from ompi_tpu_torch.topo import CartTopo
    n = len(devs)
    home = devs[0]
    grid, open_grid = halo_grids(n)

    def inputs(nbytes, dtype, salt):
        return [mesh_input(r, nbytes, dtype, devs, salt).to(home)
                for r in range(n)]

    def same(key, got, want, r):
        if got.is_cuda and got.device != devs[r]:
            raise AssertionError(f"{key}: rank {r}'s result lies on "
                                 f"{got.device}, not {devs[r]}")
        _held([got.to(home)], [want], f"{key} rank {r}")

    x8 = inputs(8 * MIB, torch.float32, 41)
    for r in range(n):
        same("h_ring8", res[r]["h_ring8"], x8[(r - 1) % n], r)
    x1 = inputs(MIB, torch.float32, 42)
    for r in range(n):
        got, mine = res[r]["h_reuse"]
        same("h_reuse", got, x1[(r - 1) % n], r)
        if not bool((mine == -1.0).all()):
            raise AssertionError("h_reuse: the sender's overwrite missed")
    xs = inputs(MIB, torch.float32, 43)
    for r in range(n):
        same("h_side", res[r]["h_side"], xs[(r - 1) % n] * 3.0 + 1.0, r)
    xm = inputs(MIB, torch.float32, 44)
    for r in range(1, n, 2):
        a, arr, b = res[r]["h_mixed"]
        if (a, b) != (7 + r - 1, 8 + r - 1):
            raise AssertionError(f"h_mixed: rank {r} got bytes {a}, {b}")
        same("h_mixed", arr, xm[r - 1], r)
    t = CartTopo(grid, [True, True], 0)
    x8 = inputs(8 * MIB, torch.float32, 45)
    for r in range(n):
        k = 0
        for d in (0, 1):
            for s in (1, -1):
                src = t.shift(d, s, r)[0]
                same(f"h_shift8 dim {d} disp {s}", res[r]["h_shift8"][k],
                     x8[src], r)
                k += 1
    for key, g, periods, nbytes, dtype, salt in (
            ("h_nbr8", grid, [True, True], 8 * MIB, torch.float32, 46),
            ("h_nbr_open", open_grid, [False] * 3, MIB, torch.int32, 47)):
        t = CartTopo(g, periods, 0)
        xg = inputs(nbytes, dtype, salt)
        for r in range(n):
            want = torch.stack([torch.zeros_like(xg[0]) if s == PROC_NULL
                                else xg[s] for s in t.neighbors(r)])
            same(key, res[r][key], want, r)
    t = CartTopo(grid, [True, True], 0)
    for r in range(n):
        r1, r2 = res[r]["h_host"]
        want1 = np.concatenate([np.arange(3) + 10 * s
                                for s in t.neighbors(r)])
        nb = t.neighbors(r)
        # neighbour j sends me its block for the mirrored direction,
        # j ^ 1; a neighbour listed twice (a periodic dim of 2) pairs
        # its blocks with mine in order (MPI-3 pairing by order)
        want2 = np.array([100 * s + (j ^ 1 if nb[j] != nb[j ^ 1] else j)
                          for j, s in enumerate(nb)])
        if not (np.array_equal(r1, want1) and np.array_equal(r2, want2)):
            raise AssertionError(f"h_host: rank {r} got {r1}, {r2}")
    log(f"[halo {tier}] sendrecv_arr ring 8 MiB f32, reuse after send, "
        "side-stream sender, bytes and objects interleaved, shift_arr "
        f"on {grid} both dims both ways, neighbor_allgather_arr on "
        f"{grid} (8 MiB f32) and {open_grid} open (1 MiB int32, PROC_NULL "
        "blocks zero), Neighbor_allgather / Neighbor_alltoall on host "
        "numpy: every result exact against its plain computation")


# ---------------------------------------------------------------------------
# 3f. the driver's entry points
# ---------------------------------------------------------------------------

ENTRY_N = 1 << 21       # K12's full width: an (8, 2**21) float32 stack
DRYRUN_COLS = 1 << 19   # the dry run's full width: 8 MiB (4, 2**19) shards


def _dryrun_want(n: int, cols: int, dev):
    """Each rank's (step value, the sum of its magnitudes) in float64
    on the card, from a plain statement of the reference's ``step``
    (__graft_entry__.py:106-119), and each rank's MPI value
    (:141-156)."""
    dp, sp = (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)
    gx = torch.arange(dp * sp * dp * cols, dtype=torch.float64,
                      device=dev).reshape(dp, sp, dp, cols)  # [i, j] shard
    g = gx.sum(0)                               # (sp, dp, cols)
    rs = dp * g                                 # rs[j, i]: rank (i, j)
    steps, mpis = [], []
    for r in range(n):
        i, j = divmod(r, sp)
        a2a = gx[:, j, i]                       # (dp, cols)
        ag = rs[(j - 1) % sp]                   # (dp, cols)
        terms = (a2a.sum(), ag.sum(), rs[j, i].sum())
        steps.append((float(sum(terms)),
                      float(a2a.abs().sum() + ag.abs().sum()
                            + rs[j, i].abs().sum())))
        sr = sum(q + 1 for q in range(n) if q % 2 == r % 2)
        mpis.append(float(sr + n * (n + 1) // 2 + 1 + (r - 1) % n + 1))
    return steps, mpis


def phase_entry(dev):
    """entry()'s fn at (8, 1024) and (8, 2**21) float32, exact against
    driver_step_plain, one K12 launch a call; dryrun_multichip(8) at the
    reference's shapes and the same step at DRYRUN_COLS on 8 logical
    devices of the card.  Every counter is zeroed just before each run
    and read just after; every rank's value is exact against a float64
    statement at the reference's shapes and within the float SUM band
    at full width.  Returns (launches, per-case launches)."""
    import math
    from ompi_tpu_torch import entry
    from ompi_tpu_torch.kernels.entry import driver_step_plain
    counters = launch_counters()

    def snap():
        return {k: c.value for k, c in counters.items()}

    per_call = {}
    fn, (x,) = entry.entry()
    if x.device != dev or x.shape != (8, 1024):
        raise AssertionError(f"entry(): example on {x.device}, {x.shape}")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    big = torch.randn(8, ENTRY_N, generator=g, device=dev)
    for key, arg in (("f_entry", x * torch.arange(1024, device=dev)),
                     ("f_entry_big", big)):
        for c in counters.values():
            c.reset()
        got = fn(arg)
        torch.cuda.synchronize()
        per_call[key] = snap()
        want = {k: int(k == "driver_step") for k in counters}
        if per_call[key] != want:
            raise AssertionError(f"{key}: launches {per_call[key]}")
        _held(list(got), list(driver_step_plain(arg)),
              f"{key} {tuple(arg.shape)}")
        if not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"{key}: non-finite output")
        log(f"[entry] entry() fn at {tuple(arg.shape)} f32: one K12 launch, "
            "exact against driver_step_plain, finite")
    # one K6 / K2 peer launch a card a body: each dp comm's allreduce 1
    # + 1, reduce_scatter 1, alltoall 1 (8 sega2a segments at full
    # width), allgather 1; the MPI part's allreduce 1 + 1,
    # reduce_scatter 1, alltoall 1 and the two half-world allreduces
    expect = {8: {"mesh_fold": 8, "peer_copy": 10},
              DRYRUN_COLS: {"mesh_fold": 8, "peer_copy": 24}}
    for cols in (8, DRYRUN_COLS):
        key = "f_dryrun" if cols == 8 else "f_dryrun_big"
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        res = entry._dryrun_body(NRANKS, cols=cols, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_call[key] = snap()
        want = {k: expect[cols].get(k, 0) for k in counters}
        if per_call[key] != want:
            raise AssertionError(f"{key}: launches {per_call[key]}, "
                                 f"expected {want}")
        steps, mpis = _dryrun_want(NRANKS, cols, dev)
        dp = NRANKS // 2
        band = 4 * (dp + math.ceil(math.log2(2 * dp * cols)) + 2) * 2.0 ** -24
        worst = 0.0
        for r, ((step, mpi), (w, mag)) in enumerate(zip(res, steps)):
            if mpi != mpis[r]:
                raise AssertionError(f"{key}: rank {r} MPI value {mpi}, "
                                     f"expected {mpis[r]}")
            err = abs(step - w)
            if (cols == 8 and err) or err > band * mag:
                raise AssertionError(f"{key}: rank {r} step {step}, "
                                     f"expected {w} (band {band * mag})")
            worst = max(worst, err / mag if mag else 0.0)
        log(f"[entry] dryrun step on 8 logical devices at cols={cols}: "
            f"{wall:.3f} s, launches K6 {per_call[key]['mesh_fold']} K2 peer "
            f"{per_call[key]['peer_copy']} as predicted; every rank's step "
            + ("exact" if cols == 8 else
               f"within the float SUM band (worst {worst:.3g} of the "
               f"magnitudes, band {band:.3g})")
            + " against float64, MPI part exact")
    launches = {k: sum(pc[k] for pc in per_call.values()) for k in counters}
    return launches, per_call


# ---------------------------------------------------------------------------
# 4. timing
# ---------------------------------------------------------------------------

def _flat(x) -> list:
    """The tensors of a kernel's result (a tensor, or nested lists)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _flat(y)]


def time_ms(fn, iters: int, nsets: int = 1):
    """(device ms, call ms) of one call of ``fn(i)`` after a warm-up;
    call number i uses input set i % nsets.  call ms: CUDA events
    around ``iters`` eager back-to-back calls, so the host's launch
    cost (Python wrapper, checks, allocation from the caching
    allocator) is in it when the device outruns the host.  device ms:
    the same ``iters`` calls captured once in a CUDA graph and replayed
    between CUDA events, which leaves the device's own time; every
    captured call's outputs stay alive until the replay ends, so no two
    calls share an output buffer."""
    for i in range(3):
        fn(i % nsets)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i % nsets)
    b.record()
    b.synchronize()
    call = a.elapsed_time(b) / iters
    keep = []
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            keep.append(fn(i % nsets))
    g.replay()
    torch.cuda.synchronize()
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    dev = a.elapsed_time(b) / iters
    del g
    keep.clear()
    return dev, call


def phase_timing(dev, launches: dict, per_call: dict) -> list:
    """``launches``: each kernel's count over the main path's run;
    ``per_call``: the counts of each of its collectives.

    Every row is timed cold: the calls of one timing rotate through as
    many input sets as make their footprint (bytes read and written a
    call, times the sets) at least COLD_BYTES, five times the card's
    50 MB L2, and each call writes an output of its own, so a call
    finds neither its inputs nor its outputs in L2, as the main path's
    launches find most of theirs (each reads a payload written well
    before it).  The kernel's time on one input set replayed, where L2
    holds what fits, is printed beside it as ``warm_ms``."""
    import numpy as np
    from ompi_tpu_torch.kernels import fused, index, stacked
    rows = []

    def row(name, kernel, call, replaces, bytes_moved, make, k_fn, p_fn,
            lib_fn, iters, source="stacked.cu", nsets=None, comp_fn=None):
        # comp_fn: a composition of several PyTorch calls computing the
        # same function where no one call does; timed as composition_ms
        # the error, on input sets of their own (K5 writes in place)
        got = [t.clone() for t in _flat(k_fn(make(0)))]
        a, _, _ = max((_err(o, r) for o, r in zip(
            got, _flat(p_fn(make(0))))), key=lambda t: t[0])
        del got
        if nsets is None:
            nsets = max(1, -(-COLD_BYTES // bytes_moved))
        sets = [make(i) for i in range(nsets)]
        warm, _ = time_ms(lambda i: k_fn(sets[0]), iters)
        k_ms, k_call = time_ms(lambda i: k_fn(sets[i]),
                               max(iters, nsets), nsets)
        p_ms, p_call = time_ms(lambda i: p_fn(sets[i]),
                               max(3, iters // 4, nsets), nsets)
        l_ms = l_call = None  # no one PyTorch call computes it
        if lib_fn is not None:
            l_ms, l_call = time_ms(lambda i: lib_fn(sets[i]),
                                   max(iters, nsets), nsets)
        c_ms = None
        if comp_fn is not None:
            c_ms, _ = time_ms(lambda i: comp_fn(sets[i]),
                              max(iters, nsets), nsets)
        del sets
        bound = bytes_moved / HBM_BYTES_PER_S * 1e3
        per = per_call[call][kernel] if call else None
        rows.append({"name": name, "route": "cuda", "source": CSRC + source,
                     "replaces": replaces, "launches": launches[kernel],
                     "max_abs_err": a, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": l_ms, "call_ms": k_call,
                     "warm_ms": warm, "input_sets": nsets,
                     "launches_per_call": per})
        if c_ms is not None:
            rows[-1]["composition_ms"] = c_ms
        lib = "none" if l_ms is None else f"{l_ms:.4f} ms ({l_call:.4f})"
        where = f"{per} launch(es) in the main path's {call}" if call \
            else "not a main-path shape"
        log(f"[time] {name}: kernel {k_ms:.4f} ms device cold over "
            f"{nsets} input set(s) ({k_call:.4f} ms a call; warm "
            f"{warm:.4f}), bound {bound:.6f} ms ({bound / k_ms * 100:.1f}% "
            f"of bound), plain {p_ms:.4f} ms ({p_call:.4f}), library "
            f"{lib}{'' if c_ms is None else f', composition {c_ms:.4f} ms'}"
            f", {where}")

    n = NRANKS

    def ranks(nbytes, dtype, salt):
        return lambda i: [rank_input(r, nbytes, dtype, dev, salt + 100 * i)
                          for r in range(n)]

    for mib, iters in ((8, 50), (128, 8)):
        row(f"stacked_reduce:allreduce_sum_f32_{mib}MiB", "stacked_reduce",
            f"ar{mib}", "ompi_tpu/coll/device.py:1389", 2 * n * mib * MIB,
            ranks(mib * MIB, torch.float32, 10 + mib),
            lambda xs: stacked.stacked_reduce(xs, "MPI_SUM"),
            lambda xs: stacked.stacked_reduce_plain(xs, "MPI_SUM"),
            lambda xs: torch.stack(xs).sum(0), iters)
    row("stacked_reduce:reduce_scatter_max_f64_8MiB", "stacked_reduce", "rs8",
        "ompi_tpu/coll/device.py:1400", (n + 1) * 8 * MIB,
        ranks(8 * MIB, torch.float64, 30),
        lambda xs: stacked.stacked_reduce(xs, "MPI_MAX", scatter=True),
        lambda xs: stacked.stacked_reduce_plain(xs, "MPI_MAX", scatter=True),
        lambda xs: torch.stack(xs).amax(0), 50)
    row("stacked_copy:allgather_f32_1MiB", "stacked_copy", "ag1",
        "ompi_tpu/coll/device.py:1418", (n + n * n) * MIB,
        ranks(MIB, torch.float32, 32),
        lambda xs: stacked.stacked_copy(xs, "allgather"),
        lambda xs: stacked.stacked_copy_plain(xs, "allgather"),
        lambda xs: torch.cat(list(xs) * n), 100)
    # 1 MiB a rank: the single dispatch below coll_pipeline_min_bytes,
    # and the segment shape of the pipelined tiers (an 8 MiB alltoall
    # runs as 8 of them)
    m = MIB // 4 // n
    row("stacked_reduce:allreduce_sum_f32_1MiB", "stacked_reduce",
        "ar8_seg", "ompi_tpu/coll/device.py:1389", 2 * n * MIB,
        ranks(MIB, torch.float32, 33),
        lambda xs: stacked.stacked_reduce(xs, "MPI_SUM"),
        lambda xs: stacked.stacked_reduce_plain(xs, "MPI_SUM"),
        lambda xs: torch.stack(xs).sum(0), 100)
    row("stacked_copy:alltoall_f32_1MiB", "stacked_copy", "a2a8",
        "ompi_tpu/coll/device.py:1421", 2 * n * MIB,
        ranks(MIB, torch.float32, 34),
        lambda xs: stacked.stacked_copy(xs, "alltoall"),
        lambda xs: stacked.stacked_copy_plain(xs, "alltoall"),
        lambda xs: torch.stack(xs).view(n, n, m).transpose(0, 1).contiguous(),
        100)
    # K3 at the fused flush of the main path: 32 slots of 64 KiB
    nf = int(FUSED_MIB * MIB) // 4
    row(f"fused_batch:{FUSED_OPS}x64KiB_sum_f32", "fused_batch", "fused32",
        "ompi_tpu/coll/fusion.py:335", 2 * n * FUSED_OPS * nf * 4,
        lambda i: [([rank_elems(r, nf, torch.float32, dev, 60 + k + 40 * i)
                     for r in range(n)], None) for k in range(FUSED_OPS)],
        lambda slots: fused.fused_batch(slots, "MPI_SUM"),
        lambda slots: fused.fused_batch_plain(slots, "MPI_SUM"),
        lambda slots: [torch.stack(xs).sum(0) for xs, _ in slots], 100,
        source="fused.cu")
    # B4m: the cross-session combined dispatch of phase 8a, both
    # sessions' 2 x 32 slots of 64 KiB in one K3 launch
    row(f"fused_batch:combined_2x{FUSED_OPS}x64KiB_sum_f32", "fused_batch",
        None, "ompi_tpu/coll/fusion.py:371", 2 * 2 * n * FUSED_OPS * nf * 4,
        lambda i: [([rank_elems(r, nf, torch.float32, dev, 160 + k + 70 * i)
                     for r in range(n)], None) for k in range(2 * FUSED_OPS)],
        lambda slots: fused.fused_batch(slots, "MPI_SUM", split=False),
        lambda slots: fused.fused_batch_plain(slots, "MPI_SUM"),
        lambda slots: [torch.stack(xs).sum(0) for xs, _ in slots], 100,
        source="fused.cu")
    # K4 and K5 at config 5's shapes: gather the even elements of a
    # 2 * CONFIG5_N float64 buffer; scatter a CONFIG5_N / N stripe into
    # a stride-2 receive layout.  Bytes: the index vector, the packed
    # stream, and the whole span of the strided side.
    span = 2 * CONFIG5_N * 8
    row("index_gather:config5_pack_f64_8MiB", "index_gather", "config5",
        "ompi_tpu/datatype/device.py:67", CONFIG5_N * 8 * 2 + span,
        lambda i: (config5_raw(i % n, dev), index.IndexVector(
            np.arange(0, 2 * CONFIG5_N, 2), dev)),
        lambda s: index.index_gather(*s),
        lambda s: index.index_gather_plain(*s),
        lambda s: torch.index_select(s[0], 0, s[1].tensor), 100,
        source="index.cu")
    mm = CONFIG5_N // n

    def stripe(i):
        return (rank_elems(i % n, mm, torch.float64, dev, 61),
                index.IndexVector(np.arange(0, 2 * mm, 2), dev),
                torch.zeros(2 * mm, dtype=torch.float64, device=dev))

    def whole(i):  # the whole 2**20-element result, into a 16 MiB span
        return (rank_elems(i % n, CONFIG5_N, torch.float64, dev, 62),
                index.IndexVector(np.arange(0, 2 * CONFIG5_N, 2), dev),
                torch.zeros(2 * CONFIG5_N, dtype=torch.float64, device=dev))

    def perm(i):  # 2**17 distinct random destinations in a 2**18 span
        return (rank_elems(i % n, mm, torch.float64, dev, 63),
                index.IndexVector(np.random.default_rng(SEED + i)
                                  .permutation(2 * mm)[:mm], dev),
                torch.zeros(2 * mm, dtype=torch.float64, device=dev))

    # a K5 row's bytes are what its mode must move: packed + span in
    # run mode (no index is read), index + packed + span in index mode
    for name, make, nel, mode in (
            ("config5_unpack_f64_1MiB", stripe, mm, "runs"),
            ("config5_unpack_f64_8MiB", whole, CONFIG5_N, "runs"),
            ("perm_f64_1MiB", perm, mm, "index")):
        if make(0)[1].mode != mode:
            raise AssertionError(f"index_scatter:{name} plans "
                                 f"{make(0)[1].mode}, expected {mode}")
        row(f"index_scatter:{name}", "index_scatter",
            "config5" if nel == mm and mode == "runs" else None,
            "ompi_tpu/datatype/device.py:86",
            nel * 8 * (mode == "index") + nel * 8 + 2 * nel * 8,
            make,
            lambda s: index.index_scatter(*s),
            lambda s: index.index_scatter_plain(*s),
            lambda s: s[2].index_copy_(0, s[1].tensor, s[0]), 100,
            source="index.cu")
    # the mesh tier on 8 logical devices of the card, at its main-path
    # shapes: one collective's launch a row (one a card, over a table of
    # every member's destination)
    from ompi_tpu_torch.coll.device import _stripe_elems
    from ompi_tpu_torch.kernels import mesh
    n8 = 8 * MIB // 4
    ms = _stripe_elems(n8, n, 4)

    def folds(order, nel=n8):
        st = _stripe_elems(nel, n, 4)

        def jobs():
            return [(torch.empty(min(st, nel - d * st), device=dev), d * st)
                    for d in range(n) if d * st < nel]
        return (lambda xs: mesh.mesh_fold_many(xs, jobs(), "MPI_SUM", order),
                lambda xs: mesh.mesh_fold_many_plain(xs, jobs(), "MPI_SUM",
                                                     order))

    for label, call, order, replaces in (
            ("rank_order", "m_ar8", "rank", "ompi_tpu/coll/device.py:997"),
            ("segring", "m_ar8_ring", ("ring", RING_SEG, RING_SEG // n),
             "ompi_tpu/coll/pipeline.py:192")):
        k_fn, p_fn = folds(order)
        row(f"mesh_fold:allreduce_sum_f32_8MiB_{label}", "mesh_fold", call,
            replaces, (n + 1) * 8 * MIB, ranks(8 * MIB, torch.float32, 70),
            k_fn, p_fn, lambda xs: torch.stack(xs).sum(0), 50,
            source="mesh.cu")
    # B9's own row: the native mesh plan's K6 launch at 128 MiB; B10's:
    # the fused mesh batch's K6 launch over the 32 x 64 KiB slots K7
    # packed (2 MiB a rank)
    for label, call, replaces, mib, iters in (
            ("plan_allreduce_sum_f32_128MiB_rank_order", "m_ar128",
             "ompi_tpu/coll/plan.py:257", 128, 8),
            (f"fused_{FUSED_OPS}x64KiB_sum_f32_rank_order", "m_fused32",
             "ompi_tpu/coll/fusion.py:257", FUSED_OPS * FUSED_MIB, 100)):
        nbytes = int(mib * MIB)
        k_fn, p_fn = folds("rank", nbytes // 4)
        row(f"mesh_fold:{label}", "mesh_fold", call, replaces,
            (n + 1) * nbytes, ranks(nbytes, torch.float32, 74),
            k_fn, p_fn, lambda xs: torch.stack(xs).sum(0), iters,
            source="mesh.cu")
    # B10m: phase 8b's combined dispatch — K6 over both sessions' group
    # buffers (2 MiB a rank a session) as jobs of one table, then K2
    # peer gathering the stripes of the 4 MiB end-to-end vector
    nb = int(FUSED_OPS * FUSED_MIB * MIB) // 4
    xl = 2 * nb
    xst = _stripe_elems(xl, n, 4)

    def xjobs():
        jobs = []
        for d in range(n):
            lo0, hi0 = d * xst, min((d + 1) * xst, xl)
            buf = torch.empty(xst, device=dev)
            for p in range(2):
                lo, hi = max(lo0, p * nb), min(hi0, (p + 1) * nb)
                if lo < hi:
                    jobs.append((buf[lo - lo0:hi - lo0], lo - p * nb, p))
        return jobs

    row(f"mesh_fold:combined_2x{FUSED_OPS}x64KiB_sum_f32", "mesh_fold", None,
        "ompi_tpu/coll/fusion.py:310", (n + 1) * 2 * nb * 4,
        lambda i: [[rank_elems(r, nb, torch.float32, dev, 170 + 10 * p + 40 * i)
                    for r in range(n)] for p in range(2)],
        lambda sets: mesh.mesh_fold_many(sets, xjobs(), "MPI_SUM",
                                         split=False),
        lambda sets: [mesh.mesh_fold_plain(sets[p], lo, o.numel(), "MPI_SUM")
                      for o, lo, p in xjobs()],
        lambda sets: [torch.stack(xs).sum(0) for xs in sets], 100,
        source="mesh.cu")
    # the body without the grouping: the one launch a card of one rank a
    # card, folding one 1 MiB stripe of 8 inputs
    n1 = MIB // 4
    row("mesh_fold:one_stripe_1MiB_8_inputs_f32", "mesh_fold", None,
        "ompi_tpu/coll/device.py:997", (n + 1) * MIB,
        ranks(MIB, torch.float32, 75),
        lambda xs: mesh.mesh_fold(xs, torch.empty(n1, device=dev), 0,
                                  "MPI_SUM"),
        lambda xs: mesh.mesh_fold_plain(xs, 0, n1, "MPI_SUM"),
        lambda xs: torch.stack(xs).sum(0), 100, source="mesh.cu")

    def gathers(f, nel, block, count):
        return lambda st: f(st, [torch.empty(nel, device=dev)
                                 for _ in range(count)], block, limit=nel)

    row("peer_copy:allgather_stripes_f32_8MiB", "peer_copy", "m_ar8",
        "ompi_tpu/coll/device.py:997", (n + 1) * 8 * MIB,
        lambda i: [rank_elems(r, ms, torch.float32, dev, 71 + 10 * i)
                   for r in range(n)],
        gathers(stacked.peer_copy_many, n8, ms, n),
        gathers(stacked.peer_copy_many_plain, n8, ms, n),
        lambda st: torch.cat(list(st) * n), 50)
    row(f"peer_copy:combined_2x{FUSED_OPS}x64KiB_stripes_f32", "peer_copy",
        None, "ompi_tpu/coll/fusion.py:310", (n + 1) * xl * 4,
        lambda i: [rank_elems(r, xst, torch.float32, dev, 178 + 10 * i)
                   for r in range(n)],
        gathers(stacked.peer_copy_many, xl, xst, n),
        gathers(stacked.peer_copy_many_plain, xl, xst, n),
        lambda st: torch.cat(list(st) * n), 100)
    row("peer_copy:gather_8_stripes_1MiB_one_output_f32", "peer_copy", None,
        "ompi_tpu/coll/device.py:997", 2 * n * MIB,
        lambda i: [rank_elems(r, n1, torch.float32, dev, 76 + 10 * i)
                   for r in range(n)],
        gathers(stacked.peer_copy_many, n * n1, n1, 1),
        gathers(stacked.peer_copy_many_plain, n * n1, n1, 1),
        lambda st: torch.cat(list(st)), 100)
    b1 = MIB // 4 // n
    row("peer_copy:alltoall_f32_1MiB", "peer_copy", "m_a2a1",
        "ompi_tpu/coll/device.py:997", 2 * n * MIB,
        ranks(MIB, torch.float32, 72),
        lambda xs: stacked.peer_copy_many(
            xs, [torch.empty_like(xs[0]) for _ in range(n)], b1,
            src_stride=b1),
        lambda xs: stacked.peer_copy_many_plain(
            xs, [torch.empty_like(xs[0]) for _ in range(n)], b1,
            src_stride=b1),
        lambda xs: torch.stack(xs).view(n, n, b1).transpose(0, 1).contiguous(),
        100)
    # B16 at its own shapes: the K6 and the K2 peer launches of one
    # dryrun_multichip(8) step at cols 2**19 (two dp communicators of 4
    # members, 8 MiB (4, cols) shards): each dp comm's allreduce (a K6
    # fold and a K2 peer gather), reduce_scatter (K6), alltoall (8
    # sega2a segments, K2 peer) and allgather (K2 peer), as the mesh
    # bodies issue them; the sp ring's shift is a copy and is left out
    dp, cols = NRANKS // 2, DRYRUN_COLS
    ne = dp * cols
    md = _stripe_elems(ne, dp, 4)
    w = max(1, (MIB // 4) // dp)  # sega2a columns a segment

    def dry_set(i):
        out = []
        for c in range(2):
            xs = [rank_elems(4 * c + r, ne, torch.float32, dev, 77 + 10 * i)
                  for r in range(dp)]
            segs = [[x.view(dp, cols)[:, lo:lo + w].contiguous().view(-1)
                     for x in xs] for lo in range(0, cols, w)]
            stripes = [rank_elems(4 * c + r, md, torch.float32, dev,
                                  78 + 10 * i) for r in range(dp)]
            rs = [rank_elems(4 * c + r, ne // dp, torch.float32, dev,
                             79 + 10 * i) for r in range(dp)]
            out.append((xs, segs, stripes, rs))
        return out

    def dry_folds(fold):
        def run(st):
            got = []
            for xs, _, _, _ in st:
                jobs = [(torch.empty(min(md, ne - d * md), device=dev), d * md)
                        for d in range(dp) if d * md < ne]
                got += fold(xs, jobs, "MPI_SUM")
                got += fold(xs, [(torch.empty(ne // dp, device=dev),
                                  d * (ne // dp)) for d in range(dp)],
                            "MPI_SUM")
            return got
        return run

    def dry_copies(copy):
        def run(st):
            got = []
            for _, segs, stripes, rs in st:
                got += copy(stripes, [torch.empty(ne, device=dev)
                                      for _ in range(dp)], md, limit=ne)
                a2a = [torch.empty(ne, device=dev) for _ in range(dp)]
                for k, lo in enumerate(range(0, cols, w)):
                    copy(segs[k], a2a, w, src_stride=w, out_stride=cols,
                         out_off=lo)
                got += a2a
                got += copy(rs[1:] + rs[:1], [torch.empty(ne, device=dev)
                                              for _ in range(dp)], ne // dp)
            return got
        return run

    mb = ne * 4  # bytes a shard
    row("mesh_fold:dryrun_step_cols2^19", "mesh_fold", "f_dryrun_big",
        "__graft_entry__.py:106", 2 * 2 * (dp * mb + mb), dry_set,
        dry_folds(mesh.mesh_fold_many), dry_folds(mesh.mesh_fold_many_plain),
        None, 20, source="mesh.cu")
    row("peer_copy:dryrun_step_cols2^19", "peer_copy", "f_dryrun_big",
        "__graft_entry__.py:106", 2 * ((mb + dp * mb) + 2 * dp * mb
                                       + (mb + dp * mb)), dry_set,
        dry_copies(stacked.peer_copy_many),
        dry_copies(stacked.peer_copy_many_plain), None, 20)
    row(f"slot_pack:{FUSED_OPS}x64KiB_f32_one_rank", "slot_pack", "m_fused32",
        "ompi_tpu/coll/fusion.py:231", 2 * FUSED_OPS * nf * 4,
        lambda i: [rank_elems(0, nf, torch.float32, dev, 73 + k + 40 * i)
                   for k in range(FUSED_OPS)],
        lambda xs: mesh.slot_pack(xs), lambda xs: mesh.slot_pack_plain(xs),
        lambda xs: torch.cat(xs), 100, source="mesh.cu")
    # the ragged mix: every slot 64 KiB + 20 B (16385 float32), so the
    # packed offsets skew from the sources by 4, 8 and 12 bytes in turn
    row(f"slot_pack:{FUSED_OPS}x(64KiB+20B)_f32_one_rank", "slot_pack", None,
        "ompi_tpu/coll/fusion.py:231", 2 * FUSED_OPS * (nf + 5) * 4,
        lambda i: [rank_elems(0, nf + 5, torch.float32, dev,
                              74 + k + 40 * i) for k in range(FUSED_OPS)],
        lambda xs: mesh.slot_pack(xs), lambda xs: mesh.slot_pack_plain(xs),
        lambda xs: torch.cat(xs), 100, source="mesh.cu")
    # the RMA kernels: a 64 MiB put into a shard (K8), a 64 MiB float32
    # accumulate, plain and fetch (K9), and one int64 compare-and-swap
    # (K10: one thread, bound by its launch; one input set)
    from ompi_tpu_torch.kernels import rma
    nb = 64 * MIB
    nf = nb // 4

    def bytes_in(i, salt):
        return rank_input(i % n, nb, torch.float32, dev,
                          salt).view(torch.uint8)

    row("rma_copy:put_64MiB", "rma_copy", "halo_stencil_tensor_dma0",
        "ompi_tpu/osc/device.py:181", 2 * nb,
        lambda i: (torch.empty(nb, dtype=torch.uint8, device=dev),
                   bytes_in(i, 80)),
        lambda st: rma.rma_copy(st[0], 0, st[1], 0, nb),
        lambda st: rma.rma_copy_plain(st[0], 0, st[1], 0, nb),
        lambda st: st[0].copy_(st[1]), 50, source="rma.cu")
    # the same put at a byte skew (a window of disp_unit 1): dst 1 and 4
    # bytes into the shard, src aligned; the library call on the same
    # uint8 views
    for skew in (1, 4):
        row(f"rma_copy:put_64MiB_skew{skew}", "rma_copy", None,
            "ompi_tpu/osc/device.py:181", 2 * nb,
            lambda i: (torch.empty(nb + 16, dtype=torch.uint8, device=dev),
                       bytes_in(i, 80)),
            lambda st, k=skew: rma.rma_copy(st[0], k, st[1], 0, nb)[k:k + nb],
            lambda st, k=skew: rma.rma_copy_plain(st[0], k, st[1], 0,
                                                  nb)[k:k + nb],
            lambda st, k=skew: st[0][k:k + nb].copy_(st[1]), 50,
            source="rma.cu")
    row("rma_acc:sum_f32_64MiB", "rma_acc", "rma_counter_tensor_dma1",
        "ompi_tpu/osc/device.py:220", 3 * nb,
        lambda i: (bytes_in(i, 81).clone(), rank_input(i % n, nb,
                                                       torch.float32, dev,
                                                       82)),
        lambda st: rma.rma_acc(st[0], 0, st[1], "MPI_SUM")
        or st[0].view(torch.float32),
        lambda st: rma.rma_acc_plain(st[0], 0, st[1], "MPI_SUM")
        or st[0].view(torch.float32),
        lambda st: torch.add(st[1], st[0].view(torch.float32),
                             out=st[0].view(torch.float32)), 50,
        source="rma.cu")
    row("rma_acc:fetch_sum_f32_64MiB", "rma_acc", "rma_counter_tensor_dma1",
        "ompi_tpu/osc/device.py:220", 4 * nb,
        lambda i: (bytes_in(i, 83).clone(), rank_input(i % n, nb,
                                                       torch.float32, dev,
                                                       84),
                   torch.empty(nf, dtype=torch.float32, device=dev)),
        lambda st: rma.rma_acc(st[0], 0, st[1], "MPI_SUM", st[2])
        or [st[0].view(torch.float32), st[2]],
        lambda st: rma.rma_acc_plain(st[0], 0, st[1], "MPI_SUM", st[2])
        or [st[0].view(torch.float32), st[2]],
        None, 50, source="rma.cu")
    # a window accumulate at target_disp 1: w one float32 into the
    # shard (4 bytes off 16), s aligned; the library call on the same
    # views
    row("rma_acc:sum_f32_64MiB_disp1", "rma_acc", None,
        "ompi_tpu/osc/device.py:220", 3 * nb,
        lambda i: (torch.cat([bytes_in(i, 85)[:4], bytes_in(i, 86)]),
                   rank_input(i % n, nb, torch.float32, dev, 87)),
        lambda st: rma.rma_acc(st[0], 4, st[1], "MPI_SUM")
        or st[0][4:].view(torch.float32),
        lambda st: rma.rma_acc_plain(st[0], 4, st[1], "MPI_SUM")
        or st[0][4:].view(torch.float32),
        lambda st: torch.add(st[1], st[0][4:].view(torch.float32),
                             out=st[0][4:].view(torch.float32)), 50,
        source="rma.cu")

    # the main path's accumulate: 8 int32, bound by its launch
    def acc8_set(i):
        gi = torch.Generator(device=dev)
        gi.manual_seed(SEED * 1000 + 88 * 100 + i)
        return tuple(torch.randint(-2 ** 31, 2 ** 31 - 1, (8,), generator=gi,
                                   device=dev, dtype=torch.int32)
                     for _ in range(2))

    row("rma_acc:sum_i32_8elem", "rma_acc", "rma_counter_tensor_dma1",
        "ompi_tpu/osc/device.py:220", 3 * 8 * 4, acc8_set,
        lambda st: rma.rma_acc(st[0], 0, st[1], "MPI_SUM") or st[0],
        lambda st: rma.rma_acc_plain(st[0], 0, st[1], "MPI_SUM") or st[0],
        lambda st: torch.add(st[1], st[0], out=st[0]), 200, source="rma.cu",
        nsets=1)

    def cas_set(i):
        w = torch.zeros(2, dtype=torch.int64, device=dev)
        return (w.view(torch.uint8), torch.zeros(1, dtype=torch.int64,
                                                 device=dev),
                torch.full((1,), 7, dtype=torch.int64, device=dev),
                torch.empty(1, dtype=torch.int64, device=dev))

    row("rma_cas:int64", "rma_cas", "rma_counter_tensor_dma1",
        "ompi_tpu/osc/device.py:259", 5 * 8, cas_set,
        lambda st: rma.rma_cas(st[0], 0, *st[1:]) or [st[0], st[3]],
        lambda st: rma.rma_cas_plain(st[0], 0, *st[1:]) or [st[0], st[3]],
        None, 200, source="rma.cu", nsets=1)
    # K11: a gate's claim over one 8 MiB (and one 128 MiB) operand, and
    # a verify's table of 8 outputs of 1 MiB.  Float results are
    # compared as float64 (their 8 bytes viewed so), integer ones as
    # int64.  The bound is the operand bytes (and 8 a result).
    from ompi_tpu_torch.kernels import digest as k11

    def dig(code, as_float):
        def run(f, xs):
            r = f(xs, [code] * len(xs))
            return r.view(torch.float64) if as_float else r
        return (lambda xs: run(k11.digest, xs),
                lambda xs: run(k11.digest_plain, xs))

    def ints(i, nbytes, salt, dtype=torch.int32):
        gi = torch.Generator(device=dev)
        gi.manual_seed(SEED * 1000 + salt * 100 + i)
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (nbytes // 4,),
                             generator=gi, device=dev,
                             dtype=torch.int32).view(dtype)

    def off4(i):  # an 8 MiB float32 operand 4 bytes into its buffer
        b = torch.empty(2 * MIB + 4, dtype=torch.float32, device=dev)
        b[1:2 * MIB + 1] = rank_input(i % n, 8 * MIB, torch.float32, dev,
                                      96 + 10 * i)
        return [b[1:2 * MIB + 1]]

    for label, call, code, as_float, mib, make, lib_fn, iters in (
            ("gate_fsum_f32_8MiB", "ig_hbm_injected_ar8", k11.F_FSUM, True, 8,
             lambda i: [rank_input(i % n, 8 * MIB, torch.float32, dev,
                                   91 + 10 * i)],
             lambda xs: torch.sum(xs[0], dtype=torch.float64), 50),
            ("gate_fsum_f32_128MiB", None, k11.F_FSUM, True, 128,
             lambda i: [rank_input(i % n, 128 * MIB, torch.float32, dev,
                                   92 + 10 * i)],
             lambda xs: torch.sum(xs[0], dtype=torch.float64), 8),
            ("verify_intsum_i32_8MiB", "ig_hbm_injected_ag", k11.F_INTSUM,
             False, 8, lambda i: [ints(i, 8 * MIB, 93)],
             lambda xs: torch.sum(xs[0], dtype=torch.int64), 50),
            ("gate_max_f32_8MiB", None, k11.F_MAX, True, 8,
             lambda i: [rank_input(i % n, 8 * MIB, torch.float32, dev,
                                   94 + 10 * i)],
             lambda xs: torch.amax(xs[0]), 50),
            ("verify_table_8x1MiB_intsum_i32", "ig_hbm_injected_a2a1",
             k11.F_INTSUM, False, 8,
             lambda i: [ints(8 * i + r, MIB, 95) for r in range(n)],
             None, 50),
            ("gate_fsum_f32_8MiB_off4", None, k11.F_FSUM, True, 8, off4,
             lambda xs: torch.sum(xs[0], dtype=torch.float64), 50),
            ("verify_intsum_u8_8MiB", None, k11.F_INTSUM, False, 8,
             lambda i: [ints(i, 8 * MIB, 97, torch.uint8)],
             lambda xs: torch.sum(xs[0], dtype=torch.int64), 50)):
        k_fn, p_fn = dig(code, as_float)
        nops = len(make(0))
        row(f"digest:{label}", "digest", call, "ompi_tpu/obs/integrity.py:234",
            mib * MIB + 8 * nops, make, k_fn, p_fn, lib_fn, iters,
            source="digest.cu")
    # K12 at the driver's full width: an (8, 2**21) float32 stack; it
    # reads x and writes out and rs.  No one PyTorch call computes the
    # step: the composition of the reference's ops is timed beside it.
    from ompi_tpu_torch.kernels import entry as k12
    ne = ENTRY_N // n

    def stack_set(i):
        gi = torch.Generator(device=dev)
        gi.manual_seed(SEED * 1000 + 97 * 100 + i)
        return torch.randn(n, ENTRY_N, generator=gi, device=dev)

    def composition(x):
        s = x.sum(0)
        return s, s + x.view(n, n, ne).transpose(0, 1).reshape(n, -1)

    row("driver_step:f32_8x2097152", "driver_step", "f_entry_big",
        "__graft_entry__.py:17", (2 * n * ENTRY_N + ENTRY_N) * 4, stack_set,
        k12.driver_step, k12.driver_step_plain, None, 50, source="entry.cu",
        comp_fn=composition)
    # one member's K2 peer launch of the neighbour gather on the 2x4
    # periodic grid at 8 MiB float32: member 0's sources 4, 4, 3, 1 (a
    # periodic dim of 2 lists one neighbour twice: three inputs, each
    # read once, and four output blocks)
    from ompi_tpu_torch.topo import CartTopo
    nbrs = CartTopo(halo_grids(n)[0], [True, True], 0).neighbors(0)

    def gather(xs):
        return stacked.peer_copy([xs[s] for s in nbrs],
                                 torch.empty(len(nbrs) * n8, device=dev), n8)

    def gather_plain(xs):
        return stacked.peer_copy_plain(
            [xs[s] for s in nbrs], torch.empty(len(nbrs) * n8, device=dev),
            n8)

    row("peer_copy:neighbor_gather_2x4_f32_8MiB_one_member", "peer_copy",
        "h_nbr8_tpu", "ompi_tpu/topo/neighbor.py:160",
        (len(set(nbrs)) + len(nbrs)) * 8 * MIB,
        ranks(8 * MIB, torch.float32, 98), gather,
        gather_plain, lambda xs: torch.stack([xs[s] for s in nbrs]), 50)
    return rows


def chained_allreduce(dev, nbytes: int, iters: int):
    """A rank program: ``iters`` chained comm.allreduce_arr SUM calls
    of ``nbytes`` float32 (each rank feeds its output back in) after a
    warm-up, host clock from a barrier to torch.cuda.synchronize();
    returns the seconds.  ``dev``: the inputs' device, or a list of one
    a rank."""
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        d = dev[comm.rank] if isinstance(dev, list) else dev
        x = rank_input(comm.rank, nbytes, torch.float32, d, 40) * 1e-6
        for _ in range(3):
            x = comm.allreduce_arr(x, SUM) * 0.125
        torch.cuda.synchronize()
        comm.Barrier()
        t0 = time.perf_counter()
        y = x
        for _ in range(iters):
            y = comm.allreduce_arr(y, SUM)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        comm.Barrier()
        if not torch.isfinite(y).all():
            raise AssertionError("chained allreduce went non-finite")
        return dt
    return fn


def phase_e2e(dev, kernel_ms: float) -> list:
    """Host clock around chained comm.allreduce_arr calls ending in
    torch.cuda.synchronize().  ``kernel_ms`` is the stacked kernel's
    device time at this shape, for the device's busy share of an op.
    The first run is the headline; then the large-message tier off and
    on in turns (off, off, on), so the plan tier's cost shows against
    the single dispatch in one process.  Returns the plan tier's us an
    op by run (the headline's)."""
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.testing import run_ranks
    nbytes, iters = 8 * MIB, 20
    fn = chained_allreduce(dev, nbytes, iters)
    saved = registry.get("coll_pipeline_enable")
    runs = {True: [], False: []}
    try:
        for tier in (True, False, False, True):
            registry.set("coll_pipeline_enable", tier)
            dts = run_ranks(NRANKS, fn, device_map=lambda r: dev,
                            timeout=600)
            runs[tier].append(max(dts) / iters * 1e6)
    finally:
        registry.set("coll_pipeline_enable", saved)
    us = runs[True][0]
    busbw = 2 * (NRANKS - 1) / NRANKS * nbytes / (us * 1e-6) / 1e9
    log(f"[e2e] osu_allreduce busbw 8 ranks x 8 MiB float32: "
        f"{us:.1f} us/op (slowest rank, {iters} chained ops), "
        f"busbw {busbw:.2f} GB/s; the kernel's device time is "
        f"{kernel_ms * 1e3 / us * 100:.1f}% of an op (device idle "
        f"{100 - kernel_ms * 1e3 / us * 100:.1f}%)")
    log(f"[e2e] the same, us/op by run: plan tier on "
        f"{[round(u, 1) for u in runs[True]]}, off (single dispatch) "
        f"{[round(u, 1) for u in runs[False]]}")
    return runs[True]


class _HostTimer:
    """Adds the host time of every call of ``mod.name`` (any thread)
    while active; restores the function on exit.  A wrapped kernel
    wrapper keeps its launch counter."""

    def __init__(self, mod, name) -> None:
        self.mod, self.name, self.total, self.calls = mod, name, 0.0, 0
        self._lock = threading.Lock()

    def __enter__(self):
        orig = self.orig = getattr(self.mod, self.name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                with self._lock:
                    self.total += time.perf_counter() - t0
                    self.calls += 1
        if hasattr(orig, "launches"):
            timed.launches = orig.launches
        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def phase_e2e_fused(dev, k3_ms: float) -> None:
    """A fused batch of FUSED_OPS iallreduce_arr of 64 KiB with one
    wait against the same FUSED_OPS blocking allreduce_arr calls: host
    clock around ``iters`` rounds ending in torch.cuda.synchronize(),
    slowest rank, microseconds per collective."""
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.testing import run_ranks
    nf, iters = int(FUSED_MIB * MIB) // 4, 20

    def fn(comm):
        xs = [rank_elems(comm.rank, nf, torch.float32, dev, 70 + k)
              for k in range(FUSED_OPS)]
        out = {}
        for mode in ("fused", "blocking", "fused", "blocking"):
            comm.Barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                if mode == "fused":
                    qs = [comm.iallreduce_arr(x, SUM) for x in xs]
                    qs[-1].wait()
                    ys = [q.result for q in qs]
                else:
                    ys = [comm.allreduce_arr(x, SUM) for x in xs]
            torch.cuda.synchronize()
            out[mode] = time.perf_counter() - t0  # the second run counts
            if not all(torch.isfinite(y).all() for y in ys):
                raise AssertionError(f"{mode} results not finite")
        comm.Barrier()
        return out

    res = run_ranks(NRANKS, fn, device_map=lambda r: dev, timeout=600)
    per = {m: max(r[m] for r in res) / (iters * FUSED_OPS) * 1e6
           for m in ("fused", "blocking")}
    batch_us = per["fused"] * FUSED_OPS
    log(f"[e2e] {FUSED_OPS} x 64 KiB float32 allreduce SUM at 8 ranks: "
        f"fused {per['fused']:.2f} us a collective ({batch_us:.1f} us a "
        f"batch, one wait), blocking {per['blocking']:.2f} us a "
        f"collective: {per['blocking'] / per['fused']:.2f}x (slowest "
        f"rank, {iters} rounds); K3's device time is "
        f"{k3_ms * 1e3 / batch_us * 100:.1f}% of a batch")

    # where a fused batch's host time goes: host timers around the
    # last arriver's body (grouping + K3's wrapper and launch), K3's
    # wrapper alone, each rank's meeting and each rank's enqueues
    from ompi_tpu_torch.coll import device, fusion
    from ompi_tpu_torch.kernels import fused

    def probe(comm):
        ys = [rank_elems(comm.rank, nf, torch.float32, dev, 70 + k)
              for k in range(FUSED_OPS)]
        for _ in range(iters):
            qs = [comm.iallreduce_arr(x, SUM) for x in ys]
            qs[-1].wait()
        torch.cuda.synchronize()
        return True

    with _HostTimer(fusion, "_hbm_slot_outs") as body, \
            _HostTimer(fused, "fused_batch") as wrap, \
            _HostTimer(device, "meet") as meet, \
            _HostTimer(fusion._FusionEngine, "enqueue") as enq:
        run_ranks(NRANKS, probe, device_map=lambda r: dev, timeout=600)
    slots = [([rank_elems(r, nf, torch.float32, dev, 80 + k)
               for r in range(NRANKS)], None) for k in range(FUSED_OPS)]
    for _ in range(3):
        fused.fused_batch(slots, "MPI_SUM")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fused.fused_batch(slots, "MPI_SUM")
    torch.cuda.synchronize()
    alone = (time.perf_counter() - t0) / iters * 1e3
    log(f"[e2e] a fused batch's host time, ms a batch: last arriver's "
        f"body {body.total / iters * 1e3:.3f} (K3 wrapper and launch "
        f"{wrap.total / iters * 1e3:.3f}; alone on an idle host "
        f"{alone:.3f}), inside meet {meet.total / iters / NRANKS * 1e3:.3f}"
        f" a rank, in the {FUSED_OPS} enqueues (flush included) "
        f"{enq.total / iters / NRANKS * 1e3:.3f} a rank")


def phase_e2e_config5(dev) -> None:
    """BASELINE config 5 end to end: device_pack + reduce_scatter MAX
    float64 + device_unpack at 8 ranks, CONFIG5_N packed elements a
    rank; host clock around ``iters`` rounds ending in
    torch.cuda.synchronize(), slowest rank."""
    from ompi_tpu_torch.datatype import device as ddev
    from ompi_tpu_torch.datatype import engine as dt
    from ompi_tpu_torch.op.op import MAX
    from ompi_tpu_torch.testing import run_ranks
    iters = 20

    def fn(comm):
        raw = config5_raw(comm.rank, dev)
        vec = dt.vector(CONFIG5_N, 1, 2, dt.DOUBLE).commit()
        m = CONFIG5_N // comm.size
        rvec = dt.vector(m, 1, 2, dt.DOUBLE).commit()
        recv = torch.zeros(2 * m, dtype=torch.float64, device=dev)
        for _ in range(3):
            ddev.device_unpack(rvec, 1, comm.reduce_scatter_arr(
                ddev.device_pack(vec, 1, raw), MAX), recv)
        torch.cuda.synchronize()
        comm.Barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            ddev.device_unpack(rvec, 1, comm.reduce_scatter_arr(
                ddev.device_pack(vec, 1, raw), MAX), recv)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        comm.Barrier()
        if not torch.isfinite(recv).all():
            raise AssertionError("config 5 went non-finite")
        return dt_s

    dts = run_ranks(NRANKS, fn, device_map=lambda r: dev, timeout=600)
    us = max(dts) / iters * 1e6
    log(f"[e2e] config 5 (device_pack stride-2 vector -> reduce_scatter "
        f"MAX float64 -> device_unpack), 8 ranks x {CONFIG5_N} packed "
        f"elements: {us:.1f} us an op (slowest rank, {iters} ops)")


def phase_e2e_mesh(dev, kernel_ms: float) -> None:
    """The 8 MiB float32 allreduce on 8 logical devices of the card (the
    mesh tier's plan path): host clock around chained calls ending in
    torch.cuda.synchronize(), slowest rank.  On one card this is the
    tier's host cost, not a multi-card speed.  ``kernel_ms``: the
    device time of its K6 and K2 peer launches."""
    from ompi_tpu_torch.testing import logical_devices, run_ranks
    nbytes, iters = 8 * MIB, 20
    dts = run_ranks(NRANKS, chained_allreduce(dev, nbytes, iters),
                    device_map=logical_devices(dev), timeout=600)
    us = max(dts) / iters * 1e6
    log(f"[e2e] mesh allreduce 8 logical devices x 8 MiB float32 on one "
        f"card: {us:.1f} us/op (slowest rank, {iters} chained ops; host "
        f"cost, not a multi-card speed); its K6 + K2 peer device time is "
        f"{kernel_ms * 1e3 / us * 100:.1f}% of an op")


def phase_e2e_integrity(dev, gate_ms: float) -> None:
    """The headline (8 ranks x 8 MiB float32 allreduce_arr on coll/hbm,
    the plan tier) with the integrity plane armed at 1-in-1
    (integrity_sample 1, integrity_sample_auto 0) against unarmed, in
    turns (unarmed, armed, armed, unarmed) in this one process: host
    clock, slowest rank, us an op.  ``gate_ms``: K11's device time for
    one 8 MiB claim; an armed op adds 8 of them, one verify launch of
    the same size and the host's share of the check."""
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.obs import integrity as ig
    from ompi_tpu_torch.testing import run_ranks
    nbytes, iters = 8 * MIB, 20
    fn = chained_allreduce(dev, nbytes, iters)
    knobs = dict(IG_ARM, ft_inject_plan="")
    saved = {k: registry.get(k) for k in knobs}
    runs = {True: [], False: []}
    checks = registry._pvars["integrity_checks"]
    try:
        for k, v in knobs.items():
            registry.set(k, v)
        for arm in (False, True, True, False):
            registry.set("integrity_enable", int(arm))
            c0 = checks.read()
            dts = run_ranks(NRANKS, fn, device_map=lambda r: dev,
                            timeout=600)
            runs[arm].append(max(dts) / iters * 1e6)
            if arm and checks.read() - c0 != NRANKS * (iters + 3):
                raise AssertionError("armed run: not every op checked")
        # where an armed op's host time goes: host timers around every
        # rank's gate (the clone and the claim's K11 launch) and the
        # executing rank's check (the body, the verify's K11 launch and
        # its D2H, the comparison)
        registry.set("integrity_enable", 1)
        with _HostTimer(ig, "gate") as gate, \
                _HostTimer(ig, "_run_checked") as check, \
                _HostTimer(ig, "_digests") as reads:
            run_ranks(NRANKS, fn, device_map=lambda r: dev, timeout=600)
        # one gate alone on this thread, no rank threads about: its own
        # host cost (the clone and the claim's K11 launch)
        x = rank_input(0, nbytes, torch.float32, dev, 41)
        ck = ig.spec_static("allreduce", "MPI_SUM", x)
        probe = types.SimpleNamespace(rank=0)
        for _ in range(3):
            ig.gate(probe, x, None, ck)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            ig.gate(probe, x, None, ck)
        alone = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            registry.set(k, v)
        ig.refresh()
    ops = iters + 3
    off = sorted(runs[False])
    on = sorted(runs[True])
    log(f"[e2e] an armed op's host time, us an op: the {NRANKS} gates "
        f"{gate.total / ops * 1e6:.1f} (summed over the rank threads; one "
        f"gate alone on an idle host {alone:.1f}), "
        f"the executing rank's check {check.total / ops * 1e6:.1f} (of "
        f"which the verify's K11 launch and its D2H "
        f"{reads.total / ops * 1e6:.1f}; the body the rest)")
    log(f"[e2e] headline allreduce 8 ranks x 8 MiB float32, integrity "
        f"armed at 1-in-1 against unarmed (unarmed, armed, armed, "
        f"unarmed): unarmed {[round(u, 1) for u in runs[False]]} us/op, "
        f"armed {[round(u, 1) for u in runs[True]]} us/op (slowest rank, "
        f"{iters} chained ops); armed over unarmed, best of each "
        f"{(on[0] / off[0] - 1) * 100:.1f}%; K11 an armed op 9 launches, "
        f"~{9 * gate_ms * 1e3:.1f} us of device time [{card_line()}]")


def phase_e2e_rma(dev) -> None:
    """benchmarks/probe_rma.py's ladder on the device window, with
    card-tensor origins, 4 ranks on 4 logical devices of the card: rank
    0 puts to and gets from rank 1 under a shared lock, windows of 32
    ops closed by flush, the median of 3 (µs an op, GB/s, and the
    share of a put spent before the flush, enqueueing); the accumulate
    rate (8 x int32 SUM, 200 ops and a flush); fetch_and_op latency
    (int64 SUM into a numpy result, the median of 64).  Both lowerings,
    then dma 1 again with 2 ranks.  Host clock; on one card these are
    host costs, not NVLink numbers."""
    from ompi_tpu_torch import osc
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.osc import device as _  # noqa: F401
    from ompi_tpu_torch.testing import logical_devices, run_ranks
    import numpy as np
    sizes, reps = (64 << 10, MIB, 4 * MIB), 32

    def fn(comm):
        out = {}
        for nb in sizes:
            win = osc.allocate(comm, nb, name="probe")
            if comm.rank == 0:
                blob = rank_input(0, nb, torch.float32, comm.device,
                                  90).view(torch.uint8)
                back = torch.empty_like(blob)
                win.lock(1, osc.LOCK_SHARED)
                for _ in range(2):
                    win.put(blob, 1)
                    win.flush(1)
                ps, gs, enq = [], [], []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        win.put(blob, 1)
                    enq.append((time.perf_counter() - t0) / reps)
                    win.flush(1)
                    ps.append((time.perf_counter() - t0) / reps)
                win.get(back, 1)
                win.flush(1)
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        win.get(back, 1)
                    win.flush(1)
                    gs.append((time.perf_counter() - t0) / reps)
                win.unlock(1)
                if not torch.equal(back, blob):
                    raise AssertionError(f"{nb} B round trip corrupt")
                out[nb] = (float(np.median(ps)) * 1e6,
                           float(np.median(gs)) * 1e6,
                           float(np.median(enq)) * 1e6)
            comm.Barrier()
            win.free()
        win = osc.allocate(comm, 64, disp_unit=8, name="acc")
        if comm.rank == 0:
            one = torch.ones(8, dtype=torch.int32, device=comm.device)
            res = np.empty(1, dtype=np.int64)
            win.lock(1, osc.LOCK_SHARED)
            for _ in range(4):
                win.accumulate(one, 1, disp=0, op=SUM)
            win.flush(1)
            t0 = time.perf_counter()
            for _ in range(200):
                win.accumulate(one, 1, disp=0, op=SUM)
            win.flush(1)
            out["acc_kops"] = 0.2 / (time.perf_counter() - t0)
            for _ in range(4):
                win.fetch_and_op(1, res, 1, disp=4, op=SUM)
            fs = []
            for _ in range(64):
                t0 = time.perf_counter()
                win.fetch_and_op(1, res, 1, disp=4, op=SUM)
                fs.append(time.perf_counter() - t0)
            out["fao_us"] = float(np.median(fs)) * 1e6
            if int(res[0]) != 67:
                raise AssertionError(f"fetch_and_op ticket {res[0]} != 67")
            win.unlock(1)
        comm.Barrier()
        win.free()
        return out

    card = card_line()
    saved = registry.get("osc_device_dma")
    try:
        # the last run: 2 ranks, so two rank threads idle in the
        # progress loop fewer than with 4 (what they cost the origin)
        for dma, nranks in ((1, 4), (0, 4), (1, 2)):
            registry.set("osc_device_dma", dma)
            r = run_ranks(nranks, fn, device_map=logical_devices(dev),
                          timeout=600)[0]
            for nb in sizes:
                pu, gu, eu = r[nb]
                log(f"[e2e] rma dma {dma}, {nranks} ranks, {nb >> 10} KiB "
                    f"(card-tensor origin, logical devices of one card; "
                    f"host cost, not NVLink): put {pu:.1f} us an op "
                    f"({nb / (pu * 1e-6) / 1e9:.3f} GB/s; enqueue "
                    f"{eu:.1f} us of it), get {gu:.1f} us an op "
                    f"({nb / (gu * 1e-6) / 1e9:.3f} GB/s) [{card}]")
            log(f"[e2e] rma dma {dma}, {nranks} ranks: accumulate 8 x "
                f"int32 SUM {r['acc_kops']:.2f} kops/s (200 ops and a "
                f"flush); fetch_and_op int64 SUM {r['fao_us']:.1f} us "
                f"(median of 64, numpy result) [{card}]")
    finally:
        registry.set("osc_device_dma", saved)


def phase_e2e_halo(dev) -> None:
    """The halo path's host cost on one card, both tiers (8 logical
    devices: the mesh tier; 8 ranks co-located: coll/hbm): the 8 MiB
    float32 sendrecv_arr ring and neighbor_allgather_arr on the 2x4
    periodic grid at 8 MiB, host clock around ``iters`` chained ops
    ending in torch.cuda.synchronize(), slowest rank, microseconds an
    op.  Not targets: they record the host's share."""
    from ompi_tpu_torch.testing import logical_devices, run_ranks
    iters, n = 20, NRANKS
    grid = halo_grids(n)[0]

    def fn(comm):
        cart = comm.Create_cart(grid, periods=[True, True])
        x = rank_input(comm.rank, 8 * MIB, torch.float32, dev, 48)
        out = {}
        for what in ("ring", "nbr"):
            def op(y):
                if what == "ring":
                    return cart.sendrecv_arr(y, (cart.rank + 1) % n,
                                             (cart.rank - 1) % n, tag=48)
                return cart.neighbor_allgather_arr(y)[0]
            for _ in range(3):
                op(x)
            torch.cuda.synchronize()
            cart.Barrier()
            t0 = time.perf_counter()
            y = x
            for _ in range(iters):
                y = op(y)
            torch.cuda.synchronize()
            out[what] = time.perf_counter() - t0
            cart.Barrier()
        return out

    card = card_line()
    for tier, dm in (("mesh, 8 logical devices", logical_devices(dev)),
                     ("hbm, 8 ranks co-located", lambda r: dev)):
        dts = run_ranks(n, fn, device_map=dm, timeout=600)
        ring = max(d["ring"] for d in dts) / iters * 1e6
        nbr = max(d["nbr"] for d in dts) / iters * 1e6
        log(f"[e2e] halo ({tier}, one card): sendrecv_arr ring 8 MiB "
            f"f32 {ring:.1f} us an op; neighbor_allgather_arr {grid} "
            f"periodic 8 MiB f32 {nbr:.1f} us an op (slowest rank, {iters} "
            f"chained ops; host clock: the host's share, not a target) "
            f"[{card}]")


# ---------------------------------------------------------------------------
# 6. trace: the per-phase split of the headline
# ---------------------------------------------------------------------------

TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "trace")
TRACE_ON = {"trace_enable": 1, "trace_phase_enable": 1,
            "trace_sample_auto": 0, "trace_buffer_events": 1 << 16}
TRACE_WARM = 3          # warm-up calls a rank before the timed ones
LABELS = ("rendezvous", "pack", "dispatch", "execute", "unpack",
          "compile")
STRAGGLER = 3           # the rank the delay injector holds
STRAGGLE = {"ft_inject_plan": "delay:1.0", "ft_inject_skip": 0,
            "ft_inject_delay_ms": 40}
SEGMENTS = {"coll_plan_enable": 0}


def traced_headline(dev, iters: int):
    """The headline's rank program, returning (seconds of ``iters``
    chained calls, sha256 of this rank's last output).  Under
    ``STRAGGLE`` the injector stays armed on STRAGGLER alone."""
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        if comm.rank != STRAGGLER:
            comm.state.extra["coll_delay_inj"] = False
        x = rank_input(comm.rank, 8 * MIB, torch.float32, dev, 40) * 1e-6
        for _ in range(TRACE_WARM):
            x = comm.allreduce_arr(x, SUM) * 0.125
        torch.cuda.synchronize()
        comm.Barrier()
        t0 = time.perf_counter()
        y = x
        for _ in range(iters):
            y = comm.allreduce_arr(y, SUM)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        comm.Barrier()
        if not torch.isfinite(y).all():
            raise AssertionError("traced headline went non-finite")
        return dt, hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    return fn


def trace_run(dev, knobs: dict, name, iters: int = 20):
    """One 8-rank world of ``traced_headline`` under ``knobs``, traced
    into TRACE_DIR/<name> when ``name`` is not None.  Every launch
    counter is zeroed just before the world and read just after.
    Returns (µs an op, slowest rank; the output's digest; launches;
    the dumps or None)."""
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.obs import integrity as ig
    from ompi_tpu_torch.testing import run_ranks
    from ompi_tpu_torch.tools import traceview
    knobs = dict(knobs)
    if name is not None:
        out = os.path.join(TRACE_DIR, name)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        knobs.update(TRACE_ON, trace_dump_path=out)
    saved = {k: registry.get(k) for k in knobs}
    counters = launch_counters()
    try:
        for k, v in knobs.items():
            registry.set(k, v)
        for c in counters.values():
            c.reset()
        res = run_ranks(NRANKS, traced_headline(dev, iters),
                        device_map=lambda r: dev, timeout=600)
        torch.cuda.synchronize()
        launches = {k: c.value for k, c in counters.items() if c.value}
    finally:
        for k, v in saved.items():
            registry.set(k, v)
        ig.refresh()
    if len({d for _, d in res}) != 1:
        raise AssertionError(f"{name}: the ranks' results differ")
    us = max(dt for dt, _ in res) / iters * 1e6
    dumps = None
    if name is not None:
        dumps = traceview.load_dumps([os.path.join(out, "trace-r*.json")])
        if len(dumps) != NRANKS or len(traceview.embedded_offsets(
                dumps)) != NRANKS:
            raise AssertionError(f"{name}: {len(dumps)} dumps, or no "
                                 "embedded clock offsets")
    return us, res[0][1], launches, dumps


def phase_split(dumps) -> dict:
    """Where the headline's time goes, from the dumps.  An op is one
    allreduce_arr call on every rank, correlated by its (cid, seq); the
    first TRACE_WARM ops are skipped.  For each op and label, the phase
    spans inside each rank's call window, clipped to it: the op's
    value is the largest rank's (dispatch and execute run on one rank,
    the meeting's trigger), and the label's share is its time summed
    over ranks and ops over the calls' summed time — a decomposition
    of the rank threads' time in the call, with the rest unattributed.
    Returns the median call µs, the median op µs (first entry to last
    exit), per label (median µs an op, share) and the unattributed
    share."""
    from ompi_tpu_torch.tools import critpath, traceview
    events = traceview.corrected_events(
        dumps, traceview.embedded_offsets(dumps))
    idx = critpath.phase_index(events)
    ops = {}
    for e in events:
        if e["ph"] == "X" and e["cat"] == "coll" \
                and e["name"] == "allreduce_arr":
            ops.setdefault((e["args"]["cid"], e["args"]["seq"]),
                           []).append(e)
    timed = [ops[k] for k in sorted(ops)][TRACE_WARM:]
    if not timed or any(len(op) != NRANKS for op in timed):
        raise AssertionError("allreduce_arr spans missing from the dumps")
    per = {lab: [] for lab in LABELS}
    summed = {lab: 0.0 for lab in LABELS}
    calls, walls, total = [], [], 0.0
    for op in timed:
        walls.append(max(c["ts"] + c["dur"] for c in op)
                     - min(c["ts"] for c in op))
        most = {lab: 0.0 for lab in LABELS}
        for call in op:
            calls.append(call["dur"])
            total += call["dur"]
            got = {}
            for e in critpath.contained_phases(call, idx):
                lab = critpath.PHASE_OF[e["name"]]
                got[lab] = got.get(lab, 0.0) + \
                    critpath._clipped_phase_us(call, [e])
            for lab, us in got.items():
                us = min(us, call["dur"])
                summed[lab] += us
                most[lab] = max(most[lab], us)
        for lab in LABELS:
            per[lab].append(most[lab])
    out = {"ops": len(timed), "call_us": critpath._median(calls),
           "op_us": critpath._median(walls)}
    for lab in LABELS:
        out[lab] = (critpath._median(per[lab]), summed[lab] / total)
    out["unattributed"] = 1.0 - sum(summed.values()) / total
    return out


#: the spans that nest inside an allreduce_arr call, innermost first:
#: a stretch of a call outside every phase is charged to the innermost
#: one that holds it
NESTED = ("meet", "seg_meet", "plan_exec", "pipeline_allreduce")


def phase_gaps(dumps) -> dict:
    """Where the unattributed time of the timed allreduce_arr calls
    lies: each call's window less the union of its rank's phase spans,
    each stretch charged to the innermost span of NESTED around it (a
    meeting's stretch also by its place: before its first phase, between
    two, after its last), or to the call itself.  Returns the share of
    the calls' summed time of each place."""
    from ompi_tpu_torch.tools import critpath, traceview
    events = traceview.corrected_events(
        dumps, traceview.embedded_offsets(dumps))
    spans = {}
    for e in events:
        if e["ph"] == "X":
            spans.setdefault(e["rank"], []).append(e)
    out, total = {}, 0.0
    for rank, lst in spans.items():
        calls = sorted((e for e in lst if e["cat"] == "coll"
                        and e["name"] == "allreduce_arr"),
                       key=lambda e: e["ts"])[TRACE_WARM:]
        phases = sorted((e for e in lst if e["name"] in critpath.PHASE_OF),
                        key=lambda e: e["ts"])
        outer = [e for e in lst if e["name"] in NESTED]
        for call in calls:
            lo, hi = call["ts"], call["ts"] + call["dur"]
            total += hi - lo
            cut, t = [], lo
            for ph in phases:
                a, b = max(ph["ts"], lo), min(ph["ts"] + ph["dur"], hi)
                if b <= a:
                    continue
                if a > t:
                    cut.append((t, a))
                t = max(t, b)
            if t < hi:
                cut.append((t, hi))
            for a, b in cut:
                mid = 0.5 * (a + b)
                place = "call"
                for name in NESTED:
                    box = next((e for e in outer if e["name"] == name
                                and e["ts"] <= mid <= e["ts"] + e["dur"]),
                               None)
                    if box is None:
                        continue
                    place = name
                    if name in ("meet", "seg_meet"):
                        inside = [p for p in phases if box["ts"] <= p["ts"]
                                  <= box["ts"] + box["dur"]]
                        if not inside or mid < inside[0]["ts"]:
                            place += " before its first phase"
                        elif mid > max(p["ts"] + p["dur"] for p in inside):
                            place += " after its last phase"
                        else:
                            place += " between phases"
                    break
                out[place] = out.get(place, 0.0) + (b - a)
    return {k: v / total for k, v in sorted(out.items(),
                                            key=lambda kv: -kv[1])}


def _log_split(what: str, split: dict, doc: dict, gaps: dict) -> None:
    log(f"[trace] {what}: {split['ops']} ops, median {split['op_us']:.1f}"
        f" us an op (first entry to last exit), {split['call_us']:.1f} us "
        f"a call; median us an op (share of the calls' summed time): "
        + ", ".join(f"{lab} {split[lab][0]:.1f} ({split[lab][1] * 100:.1f}"
                    f"%)" for lab in LABELS) +
        f"; unattributed {split['unattributed'] * 100:.1f}%")
    log(f"[trace] {what}: critpath coverage {doc['coverage']:.4f} of "
        f"{doc['ops']} op spans, {doc['multi_rank_ops']} multi-rank ops, "
        f"arrival skew us {doc['skew_us']}, gating "
        f"{dict(list(doc['gating'].items())[:4])}")
    for ctx, row in doc["tax"].items():
        log(f"[trace] {what}: dispatch tax {ctx}: " + "  ".join(
            f"{ph}={us}" for ph, us in row.items()))
    log(f"[trace] {what}: the unattributed time by place, share of the "
        f"calls' summed time: " + ", ".join(
            f"{k} {v * 100:.1f}%" for k, v in gaps.items()))


def phase_trace(dev) -> None:
    """Phase 6: the traced headline on both routes, each in turns with
    the untraced one, the armed gate, and the straggler."""
    from ompi_tpu_torch.tools import critpath, traceview
    card = card_line()
    for route, knobs, k1 in (("plan", {}, 1), ("segments", SEGMENTS, 8)):
        want = {"stacked_reduce": k1 * (TRACE_WARM + 20)}
        runs = {False: [], True: []}
        digests, split, doc = set(), None, None
        for traced in (False, True, True, False):
            us, dig, launches, dumps = trace_run(
                dev, knobs, f"headline_{route}" if traced else None)
            runs[traced].append(us)
            digests.add(dig)
            if launches != want:
                raise AssertionError(
                    f"{route}, traced {traced}: launches {launches}, "
                    f"expected {want}")
            if dumps is not None:
                split, gaps = phase_split(dumps), phase_gaps(dumps)
                doc = critpath.analyze(dumps,
                                       traceview.embedded_offsets(dumps))
        _log_split(f"headline, {route} route", split, doc, gaps)
        if len(digests) != 1:
            raise AssertionError(f"{route}: traced and untraced results "
                                 "differ")
        if route == "segments" and doc["coverage"] < 0.90:
            raise AssertionError(f"segmented route: coverage "
                                 f"{doc['coverage']} < 0.90")
        off, on = sorted(runs[False]), sorted(runs[True])
        log(f"[trace] headline 8 ranks x 8 MiB float32, {route} route "
            f"(untraced, traced, traced, untraced): untraced "
            f"{[round(u, 1) for u in runs[False]]} us/op, traced "
            f"{[round(u, 1) for u in runs[True]]} us/op (slowest rank, "
            f"20 chained ops); traced over untraced, best of each "
            f"{(on[0] / off[0] - 1) * 100:.1f}%; results byte-identical; "
            f"launches {want} a run [{card}]")
    # the scrape tick's cost: the traced headline, plan route, with the
    # obs scraper on the progress tick (obs_scrape_interval_ms at its
    # default) and off (0), in turns
    scrape = {True: [], False: []}
    for on in (True, False, False, True):
        us, _, launches, _ = trace_run(
            dev, {} if on else {"obs_scrape_interval_ms": 0}, "scrape")
        if launches != {"stacked_reduce": TRACE_WARM + 20}:
            raise AssertionError(f"scrape {on}: launches {launches}")
        scrape[on].append(us)
    log(f"[trace] scrape tick, traced headline, plan route (on, off, off, "
        f"on): on {[round(u, 1) for u in scrape[True]]} us/op, off "
        f"{[round(u, 1) for u in scrape[False]]} us/op; on over off, best "
        f"of each {(min(scrape[True]) / min(scrape[False]) - 1) * 100:.1f}%"
        f" [{card}]")
    # one armed integrity gate at 1-in-1: N gate + 1 verify K11 a call
    us, _, launches, dumps = trace_run(
        dev, dict(IG_ARM, ft_inject_plan=""), "integrity_armed")
    want = {"stacked_reduce": TRACE_WARM + 20,
            "digest": (NRANKS + 1) * (TRACE_WARM + 20)}
    if launches != want:
        raise AssertionError(f"armed: launches {launches}, expected {want}")
    doc = critpath.analyze(dumps, traceview.embedded_offsets(dumps))
    _log_split("headline, plan route, integrity armed at 1-in-1",
               phase_split(dumps), doc, phase_gaps(dumps))
    log(f"[trace] armed headline traced: {us:.1f} us/op [{card}]")
    # the straggler: 40 ms at every deposit of one rank, segmented route
    us, _, launches, dumps = trace_run(
        dev, dict(SEGMENTS, **STRAGGLE), "straggler", iters=3)
    if launches != {"stacked_reduce": 8 * (TRACE_WARM + 3)}:
        raise AssertionError(f"straggler: launches {launches}")
    offsets = traceview.embedded_offsets(dumps)
    doc = critpath.analyze(dumps, offsets, min_skew_us=20000.0)
    gating = doc["gating"]
    top = next(iter(gating), None)
    held = sum(v for k, v in gating.items()
               if k.startswith(f"r{STRAGGLER}:"))
    if top != f"r{STRAGGLER}:rendezvous" or \
            held <= sum(gating.values()) / 2:
        raise AssertionError(f"straggler not named gating: {gating}")
    if doc["skew_us"]["max"] < 20000.0:
        raise AssertionError(f"straggler skew {doc['skew_us']}")
    stitched = critpath.stitched_chrome_trace(dumps, offsets)
    path = os.path.join(TRACE_DIR, "straggler", "stitched.json")
    with open(path, "w") as fh:
        json.dump(stitched, fh)
    phs = {e.get("ph") for e in stitched["traceEvents"]}
    if not {"s", "f"} <= phs:
        raise AssertionError("stitched trace without flow arrows")
    log(f"[trace] straggler (rank {STRAGGLER} held 40 ms at every "
        f"deposit, segmented route): gating {gating}, arrival skew us "
        f"{doc['skew_us']}; flow arrows in {path} "
        f"({sum(1 for e in stitched['traceEvents'] if e.get('ph') == 's')}"
        f" arrows)")


# ---------------------------------------------------------------------------
# 7. shmem: the OpenSHMEM heap on the device window, host staging
# ---------------------------------------------------------------------------

SHMEM_HEAP = 64 * MIB   # shmem_memheap_size a PE: 512 MiB of heap on 8 PEs
SHMEM_SIZES = (8, 64 << 10, MIB, 4 * MIB)  # osu_oshm_put/get's ladder, cut
SHMEM_REPS = 20         # ops a size, laps, lock sections a PE in 7c


def pinned(stage) -> bool:
    """Whether a host stage is page-locked memory."""
    return isinstance(stage, torch.Tensor) and stage.is_pinned()


@contextlib.contextmanager
def _knobs(**kv):
    """The MCA variables ``kv`` set around the body (never inside a
    rank), restored after."""
    from ompi_tpu_torch.mca.params import registry
    saved = {k: registry.get(k) for k in kv}
    try:
        for k, v in kv.items():
            registry.set(k, v)
        yield
    finally:
        for k, v in saved.items():
            registry.set(k, v)


def phase_shmem_workloads(devs, what: str) -> dict:
    """7a: every workload of ompi_tpu_torch.testing.shmem (ring, atomics
    with tickets, CAS and swap, the lock's mutual exclusion, strided
    iput/iget, scoll, the bulk put/get ladder up to 4 MiB) on N =
    len(devs) PEs, PE r on devs[r], through ``ShmemCtx`` at
    ``shmem_memheap_size`` SHMEM_HEAP: on the host heap (--mca osc
    pt2pt, numpy), then on the device heap under osc_device_dma 1 and
    0 — ``ctx.device`` on every PE, every PE's bytes the host run's,
    and the counts zeroed just before each run and read just after: K9
    and K10 exactly ``testing.shmem.launches``, K8 none with dma 1 and
    at least its count with dma 0 (exactly, where the workload polls
    nothing).  Returns the launches of the device runs."""
    from ompi_tpu_torch import shmem
    # registers osc_device_dma
    from ompi_tpu_torch.osc import device as _  # noqa: F401
    from ompi_tpu_torch.testing import run_ranks
    from ompi_tpu_torch.testing import shmem as wl
    n = len(devs)
    counters = launch_counters()
    total = {k: 0 for k in counters}
    with _knobs(shmem_memheap_size=SHMEM_HEAP):
        for name, fn in wl.WORKLOADS.items():
            runs = {}
            for key, dma, osc in (("host", None, "pt2pt"), ("dma1", 1, ""),
                                  ("dma0", 0, "")):
                knobs = {"osc": osc}
                if dma is not None:
                    knobs["osc_device_dma"] = dma
                with _knobs(**knobs):
                    for c in counters.values():
                        c.reset()
                    t0 = time.perf_counter()
                    res = run_ranks(n, wl.pe_program(shmem, fn),
                                    device_map=lambda r: devs[r],
                                    timeout=600)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    got = {k: c.value for k, c in counters.items()}
                if [r["device"] for r in res] != [key != "host"] * n:
                    raise AssertionError(f"{name} {key}: ctx.device "
                                         f"{[r['device'] for r in res]}")
                runs[key] = [{k: v for k, v in r.items() if k != "device"}
                             for r in res]
                want = wl.launches(name, n) if key != "host" else {}
                exact = {k: want.get(k, 0) for k in counters
                         if k != "rma_copy"}
                k8 = got["rma_copy"]
                k8_ok = (k8 == 0 if key != "dma0" else
                         k8 == want["rma_copy"] if name not in ("ring", "lock")
                         else k8 >= want["rma_copy"])
                log(f"[shmem] {what}: {name} {key} heap in {wall:.3f} s, "
                    f"launches { {k: v for k, v in got.items() if v} }")
                if not k8_ok or {k: got[k] for k in exact} != exact:
                    raise AssertionError(
                        f"{name} {key}: launches {got}, expected K9/K10 "
                        f"{exact} and K8 {want.get('rma_copy', 0)} "
                        f"({'at least' if key == 'dma0' else 'none'})")
                if key != "host":
                    for k in total:
                        total[k] += got[k]
            for key in ("dma1", "dma0"):
                if runs[key] != runs["host"]:
                    raise AssertionError(f"{name}: the device heap's bytes "
                                         f"({key}) differ from the host "
                                         "heap's")
            log(f"[shmem] {what}: {name} byte-identical on the host heap "
                "and the device heap (dma 1 and 0)")
    return total


def phase_shmem_staging(dev) -> None:
    """7b: host staging on the card.  ``runtime_zero_copy`` says the
    card copies; a MirrorPool of pinned stages for the card, NRANKS
    stages in use at once, round trips seeded bytes at SHMEM_SIZES
    (stage -> card by a queued copy, card -> stage, each waited for)
    equal to the pageable path's (``torch.from_numpy(x).to``),
    every stage pinned and the pool's allocation count flat from the
    warm-up on.  Then the device window's numpy-origin puts and
    numpy-result gets at SHMEM_SIZES on 8 logical devices, every PE to
    its right neighbour, each closed by a flush and checked byte for
    byte; the race case (put A, at once put B, overwrite both before
    the fence: the original bytes land); and the plan tier's ragged
    2**21 + 3 allreduce of phase 3 again, exact and one K1 launch."""
    import numpy as np

    from ompi_tpu_torch import osc
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.osc import device as _  # noqa: F401
    from ompi_tpu_torch.runtime import staging
    from ompi_tpu_torch.runtime.state import LogicalDevice
    from ompi_tpu_torch.testing import run_ranks
    from ompi_tpu_torch.kernels.stacked import stacked_reduce_plain
    zc = staging.runtime_zero_copy(dev)
    log(f"[shmem] runtime_zero_copy({dev}) = {zc}; the CPU's "
        f"{staging.runtime_zero_copy('cpu')}")
    if zc:
        raise AssertionError("the card reported a zero-copy runtime")
    big = SHMEM_SIZES[-1]
    rounds = 4
    pool = staging.MirrorPool(max_buffers=NRANKS, device=dev)
    for st in [pool.take(big) for _ in range(NRANKS)]:
        pool.park(st)
    allocs, ok = [pool.allocs], True
    for rnd in range(rounds):
        for nb in SHMEM_SIZES:
            data = [np.random.default_rng(SEED + 100 * r + nb + rnd).integers(
                0, 256, nb, dtype=np.uint8) for r in range(NRANKS)]
            ups = [pool.take(nb) for _ in range(NRANKS)]
            cards = []
            for st, x in zip(ups, data):
                np.copyto(np.asarray(st), x)
                cards.append(torch.empty(nb, dtype=torch.uint8, device=dev))
                cards[-1].copy_(torch.as_tensor(st), non_blocking=True)
            torch.cuda.synchronize()
            ok &= all(pinned(st) for st in ups)
            for st in ups:
                pool.park(st)
            downs = [pool.take(nb) for _ in range(NRANKS)]
            for st, c in zip(downs, cards):
                torch.as_tensor(st).copy_(c, non_blocking=True)
            torch.cuda.synchronize()
            for st, c, x in zip(downs, cards, data):
                ok &= (np.asarray(st).tobytes() == x.tobytes() and torch.equal(
                    c, torch.from_numpy(x).to(dev)))
            ok &= all(pinned(st) for st in downs)
            for st in downs:
                pool.park(st)
        allocs.append(pool.allocs)
    log(f"[shmem] staging: pinned round trips at {SHMEM_SIZES} B, "
        f"{NRANKS} stages at once, equal to the pageable path and every "
        f"stage pinned: {ok}; the pool's allocations after the warm-up "
        f"and each round {allocs}")
    if not ok:
        raise AssertionError("a pinned round trip was wrong or a stage "
                             "was not pinned")
    if len(set(allocs)) != 1:
        raise AssertionError(f"the pool grew after the warm-up: {allocs}")

    def fn(comm):
        me, n = comm.rank, comm.size
        right, left = (me + 1) % n, (me - 1) % n
        win = osc.allocate(comm, 2 * big, name="staging")
        ok = True
        win.lock(right, osc.LOCK_SHARED)
        for nb in SHMEM_SIZES:
            data = np.random.default_rng(SEED + 100 * me + nb).integers(
                0, 256, nb, dtype=np.uint8)
            win.put(data, right)
            win.flush(right)
            back = np.empty(nb, dtype=np.uint8)
            win.get(back, right)
            ok &= back.tobytes() == data.tobytes()
        win.unlock(right)
        win.fence()
        a = np.full(big, 1 + me, dtype=np.uint8)
        b = np.full(big, 101 + me, dtype=np.uint8)
        win.put(a, right, disp=0)
        win.put(b, right, disp=big)
        a[:] = 0
        b[:] = 0
        win.fence()
        mem = win.memory.cpu().numpy()
        race = bool((mem[:big] == 1 + left).all()
                    and (mem[big:] == 101 + left).all())
        comm.Barrier()
        win.free()
        return ok, race

    res = run_ranks(NRANKS, fn, device_map=lambda r: LogicalDevice(dev, r),
                    timeout=600)
    log(f"[shmem] window, 8 PEs: numpy puts and gets at {SHMEM_SIZES} B "
        f"exact: {all(r[0] for r in res)}; race case intact: "
        f"{all(r[1] for r in res)}")
    if not all(r[0] for r in res):
        raise AssertionError("a numpy put or get on the window was wrong")
    if not all(r[1] for r in res):
        raise AssertionError("a put's origin was read after it returned")
    plan = [("ar_ragged", "allreduce_arr", {"stacked_reduce": 1},
             lambda c: c.allreduce_arr(
                 rank_elems(c.rank, RAGGED, torch.float32, dev, 11), SUM),
             {})]
    out, _, _ = drive(plan, lambda r: dev, NRANKS, "hbm",
                      f"8 ranks on {dev}, the ragged plan after staging")
    _held([out[r]["ar_ragged"] for r in range(NRANKS)],
          stacked_reduce_plain([rank_elems(r, RAGGED, torch.float32, dev, 11)
                                for r in range(NRANKS)], "MPI_SUM"),
          "allreduce SUM f32 ragged (plan)")
    log(f"[shmem] the plan's ragged {RAGGED}-element allreduce composes on "
        "the card: exact, one K1 launch")


def phase_e2e_shmem(dev) -> None:
    """7c: host clock, slowest PE, 8 PEs on logical devices of the card
    at shmem_memheap_size SHMEM_HEAP, both lowerings (printed, not
    asserted): µs an op of shmem.put and shmem.get (numpy, every PE to
    its right neighbour, SHMEM_REPS ops a size) at SHMEM_SIZES;
    atomic_fetch_add ops/s of PE 0 alone on PE 1; the ring's µs a hop
    (SHMEM_REPS laps of a token); the ticket lock's µs a critical
    section (every PE SHMEM_REPS sections, all contending)."""
    import numpy as np

    from ompi_tpu_torch import shmem
    from ompi_tpu_torch.osc import device as _  # noqa: F401
    from ompi_tpu_torch.testing import logical_devices, run_ranks
    reps = SHMEM_REPS

    def fn(comm):
        me, n = comm.rank, comm.size
        right = (me + 1) % n
        ctx = shmem.ShmemCtx(comm)
        out = {}
        for nb in SHMEM_SIZES:
            blk = ctx.malloc(nb, np.uint8)
            data = np.full(nb, me, dtype=np.uint8)
            ctx.put(blk, data, right)
            ctx.get(blk, right)
            ctx.barrier_all()
            t0 = time.perf_counter()
            for _ in range(reps):
                ctx.put(blk, data, right)
            ctx.quiet()
            tp = time.perf_counter() - t0
            ctx.barrier_all()
            t0 = time.perf_counter()
            for _ in range(reps):
                got = ctx.get(blk, right)
            tg = time.perf_counter() - t0
            if got[0] != me:
                raise AssertionError(f"PE {me}: get of {nb} B read {got[0]}")
            out[nb] = (tp / reps * 1e6, tg / reps * 1e6)
            ctx.barrier_all()
            ctx.free(blk)
        ctr = ctx.malloc(1, np.int64)
        ctx._write_sym(ctr, np.zeros(1, np.int64))
        ctx.barrier_all()
        if me == 0:
            for _ in range(4):
                ctx.atomic_fetch_add(ctr, 0, 1, 1)
            t0 = time.perf_counter()
            for _ in range(10 * reps):
                ctx.atomic_fetch_add(ctr, 0, 1, 1)
            out["fadd_ops"] = 10 * reps / (time.perf_counter() - t0)
        ctx.barrier_all()
        flag = ctx.malloc(1, np.int64)
        ctx._write_sym(flag, np.full(1, -1, np.int64))
        ctx.barrier_all()
        t0 = time.perf_counter()
        for lap in range(reps):
            base = 1000 * lap
            if me == 0:
                ctx.p(flag, 0, base, right)
            ctx.wait_until(flag, 0, "ge", base + (n - 1 if me == 0 else 0))
            if me != 0:
                ctx.p(flag, 0, int(flag.local[0]) + 1, right)
        out["hop_us"] = (time.perf_counter() - t0) / (reps * n) * 1e6
        ctx.barrier_all()
        lk = ctx.malloc(1, np.int64)
        cnt = ctx.malloc(1, np.int64)
        ctx._write_sym(lk, np.zeros(1, np.int64))
        ctx._write_sym(cnt, np.zeros(1, np.int64))
        ctx.barrier_all()
        t0 = time.perf_counter()
        for _ in range(reps):
            ctx.set_lock(lk)
            ctx.p(cnt, 0, int(ctx.g(cnt, 0, 0)) + 1, 0)
            ctx.clear_lock(lk)
        ctx.barrier_all()
        out["lock_s"] = time.perf_counter() - t0
        if me == 0 and int(ctx.g(cnt, 0, 0)) != n * reps:
            raise AssertionError("lost updates under the lock")
        ctx.finalize()
        return out

    card = card_line()
    for dma in (1, 0):
        with _knobs(osc_device_dma=dma, shmem_memheap_size=SHMEM_HEAP):
            res = run_ranks(NRANKS, fn, device_map=logical_devices(dev),
                            timeout=900)
        for nb in SHMEM_SIZES:
            pu = max(r[nb][0] for r in res)
            gu = max(r[nb][1] for r in res)
            log(f"[e2e] shmem dma {dma}, 8 PEs, {nb} B (numpy, every PE to "
                f"its right neighbour; logical devices of one card, host "
                f"cost): put {pu:.1f} us an op ({nb / (pu * 1e-6) / 1e9:.4f} "
                f"GB/s a PE), get {gu:.1f} us an op "
                f"({nb / (gu * 1e-6) / 1e9:.4f} GB/s a PE) [{card}]")
        hop = max(r["hop_us"] for r in res)
        lock_us = max(r["lock_s"] for r in res) / (NRANKS * reps) * 1e6
        log(f"[e2e] shmem dma {dma}, 8 PEs: atomic_fetch_add "
            f"{res[0]['fadd_ops']:.1f} ops/s (PE 0 alone on PE 1); ring "
            f"{hop:.1f} us a hop ({reps} laps); lock {lock_us:.1f} us a "
            f"critical section ({NRANKS} PEs x {reps}, contended) [{card}]")


def phase_shmem(dev) -> dict:
    """Phase 7: 7a on 8 logical devices of the card, 7b, 7c; returns
    7a's launches."""
    from ompi_tpu_torch.runtime.state import LogicalDevice
    launches = phase_shmem_workloads(
        [LogicalDevice(dev, r) for r in range(NRANKS)],
        f"8 logical devices on {dev}")
    phase_shmem_staging(dev)
    phase_e2e_shmem(dev)
    return launches


# ---------------------------------------------------------------------------
# 8. sessions: cross-session fused batches (B4m, B10m) and their plane
# ---------------------------------------------------------------------------

XS_WINDOW_US = 200_000   # 8a/8b's window: long against the host's jitter
XS_FLUSHES = 2           # flushes a session in 8a/8b
XS_WINDOWS = (0, 200, 1000)  # 8d's windows (us), timed in turns
XS_TIMED = 20            # flushes a session in a timed run of 8d
XS_COUNTED = ("fused_batch", "mesh_fold", "peer_copy", "slot_pack")


def xs_program(nflush: int, barrier, timed: bool = False):
    """fn(comm) of a resident session: ``nflush`` fused flushes of
    FUSED_OPS iallreduce_arr SUM of 64 KiB float32, inputs seeded by
    (session band, rank, flush, slot); every rank of every session
    passes ``barrier`` (a threading.Barrier) before each flush, or once
    before the timed loop.  Returns each flush's outputs (cloned: they
    are views of the combined dispatch's buffers), the world's and a
    dup's cid, and, timed, the seconds of the loop (ending in a
    synchronize)."""
    from ompi_tpu_torch.op.op import SUM
    nf = int(FUSED_MIB * MIB) // 4

    def fn(comm):
        s = comm.state.cid_band
        dev = comm.state.device
        xs = [[rank_elems(comm.rank, nf, torch.float32, dev,
                          1000 * s + 50 * (f % 4) + k)
               for k in range(FUSED_OPS)] for f in range(min(nflush, 4))]
        torch.cuda.synchronize()
        outs = []
        if timed:
            barrier.wait()
            t0 = time.perf_counter()
        for f in range(nflush):
            if not timed:
                barrier.wait()
            qs = [comm.iallreduce_arr(x, SUM) for x in xs[f % 4]]
            comm.flush_arr()
            if not timed:
                outs.append([q.result.clone() for q in qs])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0 if timed else None
        return {"outs": outs, "cids": (comm.cid, comm.dup().cid),
                "s": took}
    return fn


def xs_counts():
    """The counters phase 8 reads: the kernels' launches, the
    cross-session pvars, and fused_batches in bands 1 and 2 and in
    all."""
    from ompi_tpu_torch.coll import fusion
    c = launch_counters()
    return dict({k: c[k].value for k in XS_COUNTED},
                xb=fusion._pv_xbatches.read(), xc=fusion._pv_xcolls.read(),
                b1=fusion._pv_batches.read_band(1),
                b2=fusion._pv_batches.read_band(2),
                fb=fusion._pv_batches.read())


def xs_run(device_map, window_us, nflush: int, solo: bool = False,
           k: int = 2):
    """``k`` sessions of NRANKS ranks: at once through run_sessions
    (window ``window_us``), or one after the other (``solo``: window
    closed, hint 0, each in its own band).  The launch counters are
    set to 0 just before and read just after.  Returns (results, the
    counters' moves)."""
    import threading
    from ompi_tpu_torch.testing import run_ranks
    from ompi_tpu_torch.testing.sessions import run_sessions
    for c in launch_counters().values():
        c.reset()
    c0 = xs_counts()
    if solo:
        with _knobs(dvm_batch_window_us=0):
            res = [run_ranks(NRANKS, xs_program(nflush,
                                                threading.Barrier(NRANKS)),
                             device_map=device_map, cid_band=s + 1,
                             timeout=600) for s in range(k)]
    else:
        res = run_sessions(k, NRANKS, xs_program(
            nflush, threading.Barrier(k * NRANKS)), device_map=device_map,
            window_us=window_us, timeout=600)
    torch.cuda.synchronize()
    c1 = xs_counts()
    return res, {k: c1[k] - c0[k] for k in c0}


def phase_sessions_path(dev, tier: str) -> dict:
    """8a (hbm: 8 ranks of each session on the card) or 8b (mesh: 8
    logical devices of it): the solo runs, then window 0, then the
    window open.  Every session's outputs equal its solo run's byte for
    byte; the launches, the cross-session pvars and the per-band
    fused_batches exact; the bands' cids disjoint.  Returns the open
    window's launches."""
    from ompi_tpu_torch.comm.communicator import SESSION_CID_STRIDE
    from ompi_tpu_torch.runtime.state import LogicalDevice
    if tier == "hbm":
        dmap, what = (lambda r: dev), f"8 ranks a session on {dev}"
    else:
        dmap = lambda r: LogicalDevice(dev, r)  # noqa: E731
        what = f"8 logical devices of {dev}"
    F, n = XS_FLUSHES, NRANKS
    solo, _ = xs_run(dmap, 0, F, solo=True)
    # expected launches a flush pair: hbm one K3 a session (one group),
    # combined one; mesh one K7 a rank, one K6 and one K2 peer a card a
    # session, combined one
    pack = {"slot_pack": 2 * n * F} if tier != "hbm" else {}
    kern = ("fused_batch",) if tier == "hbm" else ("mesh_fold", "peer_copy")
    want = {0: dict(pack, **{k: 2 * F for k in kern}, xb=0, xc=0),
            XS_WINDOW_US: dict(pack, **{k: F for k in kern}, xb=F,
                               xc=F * 2 * FUSED_OPS)}
    launches = {}
    for window in (0, XS_WINDOW_US):
        res, got = xs_run(dmap, window, F)
        for s in range(2):
            for r in range(n):
                for f in range(F):
                    for a, b in zip(res[s][r]["outs"][f],
                                    solo[s][r]["outs"][f]):
                        if not torch.equal(a.view(torch.uint8),
                                           b.view(torch.uint8)):
                            raise AssertionError(
                                f"8{'a' if tier == 'hbm' else 'b'} window "
                                f"{window}: session {s + 1} rank {r} flush "
                                f"{f} differs from its solo run")
        for k, v in want[window].items():
            if got[k] != v:
                raise AssertionError(f"sessions {tier} window {window}: "
                                     f"{k} {got[k]}, expected {v}")
        for k in XS_COUNTED:
            if k not in want[window] and got[k]:
                raise AssertionError(f"sessions {tier}: {k} launched "
                                     f"{got[k]} times")
        if not (got["b1"] == got["b2"] == n * F
                and got["fb"] == got["b1"] + got["b2"]):
            raise AssertionError(f"sessions {tier}: fused_batches bands "
                                 f"{got['b1']}, {got['b2']}, all {got['fb']}")
        cids = [{c for r in res[s] for c in r["cids"]} for s in range(2)]
        if cids[0] & cids[1] or not all(
                (s + 1) * SESSION_CID_STRIDE <= c < (s + 2) *
                SESSION_CID_STRIDE for s in range(2) for c in cids[s]):
            raise AssertionError(f"sessions {tier}: cids {cids}")
        log(f"[sessions] {tier}, 2 sessions x {F} flushes of {FUSED_OPS} x "
            f"64 KiB, {what}, window {window} us: outputs equal the solo "
            f"runs byte for byte; launches "
            f"{ {k: got[k] for k in XS_COUNTED if got[k]} }, "
            f"xsession_batches {got['xb']}, xsession_collectives "
            f"{got['xc']}, fused_batches bands 1/2 {got['b1']}/{got['b2']}"
            f" (all {got['fb']}), cids {sorted(min(c) for c in cids)}")
        if window:
            launches = {k: got[k] for k in XS_COUNTED}
    return launches


XS_MANY = 5   # sessions of 8a's join limit: one more than a K3 launch holds


def phase_sessions_limit(dev) -> None:
    """8a, the join limit: XS_MANY sessions of 8 ranks on the card, one
    flush each, the window open.  One K3 launch holds 4 sessions' 32
    slots at 8 ranks, so a batch that would pass it leads a window of
    its own: every dispatch is one K3 launch (a combined one carrying
    at most 4 sessions), nothing raises, and every session's outputs
    equal its solo run's byte for byte."""
    from ompi_tpu_torch.kernels import fused
    k, n = XS_MANY, NRANKS
    per = fused.per_launch(n) // FUSED_OPS
    dmap = lambda r: dev  # noqa: E731
    solo, _ = xs_run(dmap, 0, 1, solo=True, k=k)
    res, got = xs_run(dmap, XS_WINDOW_US, 1, k=k)
    for s in range(k):
        for r in range(n):
            for a, b in zip(res[s][r]["outs"][0], solo[s][r]["outs"][0]):
                if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                    raise AssertionError(
                        f"8a limit: session {s + 1} rank {r} differs from "
                        "its solo run")
    combined = got["xc"] // FUSED_OPS   # sessions that rode a combined one
    alone = k - combined
    if not (got["xb"] >= 1 and combined <= per * got["xb"]
            and got["fused_batch"] == got["xb"] + alone):
        raise AssertionError(f"8a limit: {got['xb']} combined dispatches "
                             f"carrying {combined} sessions, {alone} alone, "
                             f"{got['fused_batch']} K3 launches")
    log(f"[sessions] hbm join limit, {k} sessions x 1 flush of {FUSED_OPS} "
        f"x 64 KiB, 8 ranks a session on {dev}, window {XS_WINDOW_US} us: "
        f"{got['xb']} combined dispatches carrying {combined} sessions "
        f"(at most {per} a launch), {alone} alone, {got['fused_batch']} K3 "
        "launches (one a dispatch), outputs equal the solo runs byte for "
        "byte")


def phase_sessions_flight(dev) -> None:
    """8c: the flight recorder under phase 3d's injected device_sdc
    (its injected mode again, both tiers): the sdc_* events equal the
    integrity pvars' moves, the ft_inject events those flips and one a
    Barrier meeting of the victim, every event carries the
    reference's fields, and the ring's trace dump loads in the port's
    traceview."""
    from ompi_tpu_torch import obs
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.obs import integrity  # noqa: F401  (its pvars)
    from ompi_tpu_torch.runtime.state import LogicalDevice
    from ompi_tpu_torch.tools import traceview
    rec = obs.recorder()
    for tier, devs, what in (
            ("hbm", [dev] * NRANKS, f"8 ranks on {dev}"),
            ("tpu", [LogicalDevice(dev, r) for r in range(NRANKS)],
             f"8 logical devices on {dev}")):
        h0 = rec.recorded
        base = {k: registry._pvars[k].read() for k in IG_PVARS}
        phase_integrity(devs, tier, f"8c flight recorder, {what}",
                        modes=(True,))
        nev = rec.recorded - h0
        if nev > rec.cap:
            raise AssertionError(f"8c: {nev} events overran the ring of "
                                 f"{rec.cap}")
        pv = {k: registry._pvars[k].read() - base[k] for k in IG_PVARS}
        evs = rec.snapshot(last=nev)
        count = {nm: sum(e["name"] == nm for e in evs) for nm in (
            "ft_inject", "sdc_mismatch", "sdc_convict", "sdc_retry")}
        # the victim flips at every meeting, and drive()'s Barriers
        # (2 + 3 a case) meet at the same rendezvous through coll/sm:
        # a flip of their None deposit is recorded and changes nothing
        plan, _ = integrity_cases(
            [d.device if hasattr(d, "slot") else d for d in devs], tier,
            True)
        want = {"ft_inject": pv["integrity_mismatches"] + 2 + 3 * len(plan),
                "sdc_mismatch": pv["integrity_mismatches"],
                "sdc_convict": pv["integrity_convictions"],
                "sdc_retry": pv["integrity_retry_ops"]}
        if count != want or not count["sdc_mismatch"] or \
                sum(count.values()) != nev:
            raise AssertionError(f"8c {tier}: events {count}, pvars {pv}")
        for e in evs:
            i = obs.EVENT_NAMES.index(e["name"])
            if tuple(e["args"]) != tuple(f.rstrip("$") for f in
                                         obs.EVENT_FIELDS[i]):
                raise AssertionError(f"8c: event {e} lacks its fields")
            if e["name"] == "sdc_convict" and e["args"]["rank"] != 1:
                raise AssertionError(f"8c: conviction of {e['args']}")
        path = os.path.join(TRACE_DIR, f"flight-{tier}.json")
        os.makedirs(TRACE_DIR, exist_ok=True)
        if rec.persist(path) != path:
            raise AssertionError(f"8c: the ring did not persist to {path}")
        doc = traceview.chrome_trace(traceview.load_dumps([path]), [])
        names = {e.get("name") for e in doc["traceEvents"]}
        if not set(count) <= names:
            raise AssertionError(f"8c: traceview lost events: {names}")
        log(f"[sessions] 8c flight recorder, {what}: {count}: sdc_* = "
            f"the integrity pvars' moves {pv}, ft_inject those flips + "
            f"the victim's {2 + 3 * len(plan)} Barrier meetings; every "
            f"event has its fields; "
            f"{path} loads in traceview ({len(doc['traceEvents'])} "
            "trace events)")


def phase_sessions_timing(dev) -> None:
    """8d: host clock, slowest rank of either session, us a collective:
    two sessions x XS_TIMED flushes of FUSED_OPS x 64 KiB on the card
    (hbm), windows XS_WINDOWS in turns (A B C A B C); and the combined
    K3 launch (2 x FUSED_OPS slots) against two solo launches, device
    time (CUDA graph replay) and time a call."""
    import threading
    from ompi_tpu_torch.coll import fusion
    from ompi_tpu_torch.kernels import fused
    from ompi_tpu_torch.testing.sessions import run_sessions
    per = {w: [] for w in XS_WINDOWS}
    comb = {w: [] for w in XS_WINDOWS}
    for turn in range(2):
        for w in XS_WINDOWS:
            xb0 = fusion._pv_xbatches.read()
            res = run_sessions(2, NRANKS, xs_program(
                XS_TIMED, threading.Barrier(2 * NRANKS), timed=True),
                device_map=lambda r: dev, window_us=w, timeout=600)
            slow = max(r["s"] for ss in res for r in ss)
            per[w].append(slow / (XS_TIMED * FUSED_OPS) * 1e6)
            comb[w].append(fusion._pv_xbatches.read() - xb0)
    for w in XS_WINDOWS:
        log(f"[sessions] 8d window {w} us: "
            f"{', '.join(f'{u:.2f}' for u in per[w])} us a collective "
            f"(two sessions x {XS_TIMED} flushes of {FUSED_OPS} x 64 KiB, "
            f"slowest rank, turns A B C A B C), combined dispatches "
            f"{comb[w]} of {XS_TIMED}")
    nf = int(FUSED_MIB * MIB) // 4
    slots = [([rank_elems(r, nf, torch.float32, dev, 90 + k)
               for r in range(NRANKS)], None) for k in range(2 * FUSED_OPS)]
    a, b = slots[:FUSED_OPS], slots[FUSED_OPS:]
    c_ms, c_call = time_ms(
        lambda i: fused.fused_batch(slots, "MPI_SUM", split=False), 100)
    s_ms, s_call = time_ms(lambda i: (fused.fused_batch(a, "MPI_SUM"),
                                      fused.fused_batch(b, "MPI_SUM")), 100)
    bound = 2 * NRANKS * 2 * FUSED_OPS * nf * 4 / HBM_BYTES_PER_S * 1e3
    log(f"[sessions] 8d K3 combined ({2 * FUSED_OPS} slots x 8 ranks, one "
        f"launch): {c_ms:.4f} ms device ({c_call:.4f} a call), two solo "
        f"launches of {FUSED_OPS}: {s_ms:.4f} ms device ({s_call:.4f} a "
        f"call); bound {bound:.4f} ms (warm: one input set)")


def phase_sessions(dev) -> dict:
    """Phase 8: 8a, 8b (their launches, the path's count), 8c, 8d."""
    launches = phase_sessions_path(dev, "hbm")
    for k, v in phase_sessions_path(dev, "tpu").items():
        launches[k] = launches.get(k, 0) + v
    phase_sessions_limit(dev)
    phase_sessions_flight(dev)
    phase_sessions_timing(dev)
    return launches


# ---------------------------------------------------------------------------
# 9. hier: the hierarchical allreduce tier, its leader hop, the health
#    plane's reroute, the hang doctor and the gray-failure injectors
# ---------------------------------------------------------------------------

HIER_SIZES = (8 * MIB, 128 * MIB)
HIER_OPS = (("f32_sum", torch.float32, "MPI_SUM"),
            ("i32_sum", torch.int32, "MPI_SUM"),
            ("f32_max", torch.float32, "MPI_MAX"))
HIER_TIMED = 10   # chained ops a timed run of 9d and 9e
HIER_SLOW = {"ft_inject_plan": "host_slow", "ft_inject_victim_host": 1,
             "ft_inject_host_slow_factor": 10, "ft_inject_delay_ms": 2}
HIER_SEVER = {"ft_inject_plan": "rdv_sever:1",
              "coll_device_rendezvous_timeout": 60.0}


def hier_knobs(sl: int, on: bool = True):
    """The tier's knobs around a world (never inside a rank: a comm
    caches its eligibility): on, slices of ``sl`` consecutive ranks;
    phase tracing on (``TRACE_ON``), so the leader hop's steps are
    counted and timed from their spans."""
    return _knobs(coll_hier_enable=on, coll_hier_slice_size=sl, **TRACE_ON)


HOP = ("ph_hop_d2h", "ph_hop_host", "ph_hop_h2d")


def hop_spans(tr, since: int = 0):
    """The leader hop's phase spans ``tr`` recorded after its event
    ``since``, oldest first: (name, nbytes, pinned (None for the host
    step), seconds)."""
    new = tr.cursor - since
    if new > tr.capacity:
        raise AssertionError("the trace ring wrapped under the leader hop")
    evs = tr.snapshot()[-new:] if new > 0 else []
    return [(e["name"], e["args"]["nbytes"], e["args"].get("pinned"),
             e["dur"]) for e in evs if e["name"] in HOP]


def hop_want(nbytes: int, card: bool):
    """A leader's hop spans for one op of ``nbytes``, without their
    times: its D2H and H2D through pinned stages on a card (numpy
    stages on the CPU), the host allreduce between."""
    p = int(card)
    return [("ph_hop_d2h", nbytes, p), ("ph_hop_host", nbytes, None),
            ("ph_hop_h2d", nbytes, p)]


def _with_hop(call):
    """``call`` as a case that returns (its result, the leader-hop
    spans this rank recorded in it, without their times)."""
    def run(comm):
        tr = comm.state.tracer
        n0 = tr.cursor
        out = call(comm)
        return out, [s[:3] for s in hop_spans(tr, n0)]
    return run


def hier_cases(cards, sl: int):
    """(key, entry point, launches, call, knobs, (nbytes, dtype, op,
    salt)) of 9a: allreduce_arr at 8 and 128 MiB of f32 SUM, i32 SUM and
    f32 MAX, and the ragged 2**21 + 3 f32 SUM, on N = len(cards) ranks
    in slices of ``sl``.  An op is, in each slice, the intra comm's
    plan (one K6 and one K2 peer a card) and its segbcast of the total
    (one K2 peer launch a card a segment of coll_seg_size)."""
    from ompi_tpu_torch.op import op as mpi_op
    n = len(cards)
    slices, c = n // sl, len(set(cards[:sl]))
    out = []
    sizes = [(f"{nb // MIB}MiB", nb, HIER_OPS) for nb in HIER_SIZES] + \
        [("ragged", RAGGED * 4, HIER_OPS[:1])]
    salt = 60
    for tag, nb, ops in sizes:
        for name, dt, opname in ops:
            segs = -(-nb // MIB)
            want = {"mesh_fold": slices * c,
                    "peer_copy": slices * c * (1 + segs)}
            op = getattr(mpi_op, opname[4:])
            out.append((f"h_{name}_{tag}", "allreduce_arr", want,
                        lambda comm, nb=nb, dt=dt, op=op, salt=salt:
                        comm.allreduce_arr(mesh_input(comm.rank, nb, dt,
                                                      cards, salt), op),
                        {}, (nb, dt, opname, salt)))
            salt += 1
    return out


def _hier_want(cards, sl: int, nb: int, dt, opname: str, salt: int):
    """The plain version of one hier op on the CPU: every slice's left
    fold in rank order (the intra plan's native order), then the two
    slice results folded (the leaders' host allreduce: one op of two
    operands)."""
    from ompi_tpu_torch.kernels.stacked import fold_plain
    n = len(cards)
    xs = [mesh_input(r, nb, dt, cards, salt).cpu() for r in range(n)]
    parts = [fold_plain(xs[lo:lo + sl], opname) for lo in range(0, n, sl)]
    return xs, fold_plain(parts, opname)


def phase_hier_path(devs, sl: int, what: str) -> dict:
    """9a: the tier through comm.allreduce_arr on N = len(devs) ranks in
    slices of ``sl``, then the same cases with the tier off (the flat
    mesh allreduce).  Every entry point is coll/tpu, every case's K6
    and K2 peer launches exact; coll_hier_ops moves by N an op (one a
    rank), none with the tier off; each leader (the first rank of a
    slice) records exactly one D2H, host allreduce and H2D span an op,
    the payload's bytes through stages pinned on a card, and no other
    rank any; every rank's bytes the same and equal, byte for
    byte, to the plain version on the CPU; against the flat route,
    ints and MAX byte for byte and float SUM within 4*N*2^-24 of
    sum(|x_i|).  Returns the tier's launches."""
    from ompi_tpu_torch.coll import pipeline
    from ompi_tpu_torch.runtime.state import LogicalDevice
    n = len(devs)
    cards = [d.device if isinstance(d, LogicalDevice) else d for d in devs]
    card = cards[0].type == "cuda"
    cases = hier_cases(cards, sl)
    plan = [(k, f, w, _with_hop(call), kn) for k, f, w, call, kn, _ in cases]
    h0 = pipeline.pv_hier.read()
    with hier_knobs(sl):
        res, launches, _ = drive(plan, lambda r: devs[r], n, "tpu",
                                 f"hier, {what}, slices of {sl}")
    ops = pipeline.pv_hier.read() - h0
    with hier_knobs(sl, on=False):
        flat, _, _ = drive(_flat_plan(cases, cards), lambda r: devs[r], n,
                           "tpu", f"flat (hier off), {what}")
    if ops != n * len(cases) or pipeline.pv_hier.read() - h0 != ops:
        raise AssertionError(f"hier: coll_hier_ops moved {ops}, expected "
                             f"{n * len(cases)} ({n} ranks x "
                             f"{len(cases)} ops)")
    for key, _, _, _, _, (nb, dt, opname, salt) in cases:
        for r in range(n):
            spans = res[r][key][1]
            if spans != (hop_want(nb, card) if r % sl == 0 else []):
                raise AssertionError(f"hier {key}: rank {r}'s leader hop "
                                     f"{spans}")
        xs, want = _hier_want(cards, sl, nb, dt, opname, salt)
        outs = [res[r][key][0].cpu() for r in range(n)]
        for r, o in enumerate(outs):
            if o.dtype != want.dtype or o.shape != want.shape or \
                    not torch.equal(o.view(torch.uint8),
                                    want.view(torch.uint8)):
                raise AssertionError(f"hier {key}: rank {r} differs from "
                                     "the plain version on the CPU")
        f = flat[0][key].cpu()
        if opname == "MPI_SUM" and dt.is_floating_point:
            absum = torch.stack([x.double().abs() for x in xs]).sum(0)
            bad = int(((want.double() - f.double()).abs()
                       > 4 * n * 2.0 ** -24 * absum).sum())
            if bad or not torch.isfinite(want).all():
                raise AssertionError(f"hier {key}: {bad} elements outside "
                                     "the float SUM band of the flat route")
            how = "within 4*N*2^-24 of the flat route"
        else:
            if not torch.equal(f.view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"hier {key}: differs from the flat "
                                     "route")
            how = "the flat route's bytes"
        log(f"[hier] {key}, {what}: every rank the plain version's bytes "
            f"on the CPU, {how}")
        del xs, want, outs
    log(f"[hier] {what}, slices of {sl}: coll_hier_ops {ops} "
        f"({len(cases)} ops x {n} ranks); leader hop: ranks "
        f"{list(range(0, n, sl))} one D2H, host allreduce and H2D an op, "
        f"the payload's bytes (pinned stages: {card}), no other rank; "
        f"launches {launches}")
    return launches


def _flat_plan(cases, cards):
    """9a's cases for the flat mesh allreduce: one K6 and one K2 peer a
    card an op."""
    c = len(set(cards))
    return [(k, f, {"mesh_fold": c, "peer_copy": c}, call, kn)
            for k, f, _, call, kn, _ in cases]


def phase_hier_reroute(devs, sl: int, what: str) -> None:
    """9b: each rank's node id is rank // (sl // 2), node 0 held
    degraded by the health plane's mask: slice 0's first half is on it,
    so its leader is rank sl // 2 (the other slices keep their first
    rank); the leader hop runs on those ranks' threads, the launches
    are 9a's, and the result is the plain version's bytes (the healthy
    fleet's)."""
    from ompi_tpu_torch.coll import pipeline
    from ompi_tpu_torch.obs import health
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.runtime.state import LogicalDevice
    from ompi_tpu_torch.testing import run_ranks
    n = len(devs)
    cards = [d.device if isinstance(d, LogicalDevice) else d for d in devs]
    half = max(1, sl // 2)
    nb, salt = 8 * MIB, 90

    def fn(comm):
        comm.state.rte.node_id = comm.rank // half
        x = mesh_input(comm.rank, nb, torch.int32, cards, salt)
        comm.Barrier()
        out = comm.allreduce_arr(x, SUM)
        torch.cuda.synchronize()
        intra, lead = pipeline._hier_plan(comm)
        hop = [sp[:3] for sp in hop_spans(comm.state.tracer)]
        return intra.group[0], lead is not None, out, hop

    counters = launch_counters()
    for c in counters.values():
        c.reset()
    health.set_degraded_mask(1)
    try:
        with hier_knobs(sl):
            res = run_ranks(n, fn, device_map=lambda r: devs[r],
                            timeout=600)
    finally:
        health.set_degraded_mask(0)
    got = {k: c.value for k, c in counters.items() if c.value}
    c = len(set(cards[:sl]))
    segs = -(-nb // MIB)
    want_l = {"mesh_fold": n // sl * c,
              "peer_copy": n // sl * c * (1 + segs)}
    leaders = [half] + list(range(sl, n, sl))
    want_lead = [(leaders[r // sl], r in leaders) for r in range(n)]
    _, want = _hier_want(cards, sl, nb, torch.int32, "MPI_SUM", salt)
    hops = [h for _, _, _, h in res]
    want_hops = [hop_want(nb, cards[0].type == "cuda") if r in leaders
                 else [] for r in range(n)]
    if [(a, b) for a, b, _, _ in res] != want_lead or got != want_l or \
            hops != want_hops:
        raise AssertionError(f"hier reroute: leaders "
                             f"{[(a, b) for a, b, _, _ in res]}, expected "
                             f"{want_lead}; launches {got}; hop {hops}")
    for r, (_, _, o, _) in enumerate(res):
        if not torch.equal(o.cpu(), want):
            raise AssertionError(f"hier reroute: rank {r} differs from "
                                 "the plain version")
    log(f"[hier] 9b reroute, {what}: node 0 degraded, slice leaders "
        f"{leaders} (the leader hop's spans on those ranks alone), "
        f"launches {got}, i32 SUM 8 MiB the plain version's bytes")


def phase_hier_wedge(devs, tier: str, what: str) -> None:
    """9c: ft_inject rdv_sever wedges rank N - 3 (5 of 8) short of its
    first deposit (a 1 MiB allreduce_arr f32 SUM, one meeting); a
    watcher thread builds the hang doctor's capture once the other
    N - 1 have arrived (testing.sessions.doctor_capture): its
    rendezvous row and the verdict name that rank absent and the
    others waiting; then poisoning
    the world unwinds every rank, the wedged one included, within 5 s
    (the rendezvous timeout is 60 s)."""
    from ompi_tpu_torch.obs import health
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.runtime.state import LogicalDevice
    from ompi_tpu_torch.testing import RankError, run_ranks, sessions
    from ompi_tpu_torch.tools import doctor
    n = len(devs)
    cards = [d.device if isinstance(d, LogicalDevice) else d for d in devs]
    victim = n - 3
    held, got = {}, {}

    def fn(comm):
        if comm.rank == 0:
            held["world"] = comm.state.rte.world
        x = mesh_input(comm.rank, MIB, torch.float32, cards, 95)
        return comm.allreduce_arr(x, SUM)

    hp = health.HealthPlane(1, expect_beat_ns=100_000_000,
                            floor_grace_ns=1_000_000_000)

    def watcher():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            w = held.get("world")
            if w is not None:
                with w.shared_lock:
                    rvs = [v for k, v in w.shared.items()
                           if isinstance(k, tuple) and k[0] == "coll_rv"]
                if any(rv.snapshot()["count"] == n - 1 for rv in rvs):
                    t0 = time.monotonic()
                    got["doc"] = sessions.doctor_capture(
                        w, sid=9, run_ms=0, health=hp)
                    got["capture_s"] = time.monotonic() - t0
                    got["t"] = time.monotonic()
                    sessions.poison(w, 3, "hang doctor")
                    return
            time.sleep(0.01)

    th = threading.Thread(target=watcher, daemon=True)
    with _knobs(**HIER_SEVER, ft_inject_victim_rank=str(victim)):
        th.start()
        try:
            run_ranks(n, fn, device_map=lambda r: devs[r], timeout=300)
        except RankError as e:
            if "aborted" not in str(e):
                raise
        else:
            raise AssertionError("hier wedge: the wedged world returned")
        unwound = time.monotonic()
    th.join(10)
    doc = got.get("doc")
    if doc is None:
        raise AssertionError("hier wedge: no capture was built")
    rvs = doc["rendezvous"]
    lines = doctor.verdict(doc)
    text = "\n".join(lines)
    want_wait = ",".join(str(r) for r in range(n) if r != victim)
    if len(rvs) != 1 or rvs[0]["absent"] != [victim] or \
            f"ABSENT ranks [{victim}]" not in text or \
            f"waiting ranks [{want_wait}]" not in text or \
            unwound - got["t"] > 5.0 or \
            len(doc["stacks"]) != n:
        raise AssertionError(f"hier wedge {tier}: rendezvous {rvs}, "
                             f"verdict {lines}, unwound in "
                             f"{unwound - got['t']:.3f} s, "
                             f"{len(doc['stacks'])} stacks")
    log(f"[hier] 9c rdv_sever wedge, {tier}, {what}: capture in "
        f"{got['capture_s'] * 1e3:.1f} ms ({len(doc['stacks'])} stacks, "
        f"{len(doc['events'])} flight events); verdict: "
        f"{[ln.strip() for ln in lines if 'ABSENT' in ln]}; the poisoned "
        f"world unwound in {unwound - got['t']:.3f} s")


def _hier_chained(cards, sl: int, iters: int):
    """A rank program for 9d/9e: node id rank // sl, then
    ``chained_allreduce``'s 8 MiB float32 chain; returns (seconds,
    whether this rank holds a host_slow injector, the leader hop's
    spans of the ``iters`` timed ops where tracing is on)."""
    inner = chained_allreduce(cards, 8 * MIB, iters)

    def fn(comm):
        comm.state.rte.node_id = comm.rank // sl
        dt = inner(comm)
        tr = comm.state.tracer
        hop = hop_spans(tr)[-3 * iters:] if tr is not None else []
        return dt, bool(comm.state.extra.get("coll_slow_inj")), hop
    return fn


def phase_hier_timing(devs, sl: int, what: str) -> None:
    """9d: host_slow on node 1 (ranks sl..2sl-1) against clean, A B B A,
    µs an op of the tier at 8 MiB (slowest rank); only node 1's ranks
    hold an injector.  9e: the tier against the flat mesh allreduce,
    A B B A, µs an op, with the leader hop's host time split by its
    phase spans into its D2H (the copy and the wait on its event), the
    host allreduce (the leaders' p2p over btl/inproc, the other
    leader's wait included) and its H2D (enqueue), a leader's mean over
    the timed ops; and one 8 MiB copy each way between a pinned stage
    and the card, CUDA events around 20.  Every turn of 9d and 9e runs
    with phase tracing on (``hier_knobs``)."""
    from ompi_tpu_torch.testing import run_ranks
    from ompi_tpu_torch.runtime.state import LogicalDevice
    n = len(devs)
    cards = [d.device if isinstance(d, LogicalDevice) else d for d in devs]
    dev = cards[0]
    fn = _hier_chained(cards, sl, HIER_TIMED)
    runs = {False: [], True: []}
    with hier_knobs(sl):
        for slow in (False, True, True, False):
            with _knobs(**(HIER_SLOW if slow else {"ft_inject_plan": ""})):
                res = run_ranks(n, fn, device_map=lambda r: devs[r],
                                timeout=600)
            inj = [f for _, f, _ in res]
            if inj != [slow and r // sl == 1 for r in range(n)]:
                raise AssertionError(f"host_slow: injectors on {inj}")
            runs[slow].append(max(dt for dt, _, _ in res) / HIER_TIMED * 1e6)
    stall = HIER_SLOW["ft_inject_delay_ms"] * (
        HIER_SLOW["ft_inject_host_slow_factor"] - 1)
    log(f"[hier] 9d host_slow, {what}: node 1's ranks stall {stall} ms a "
        f"deposit; us an op clean {[round(u, 1) for u in runs[False]]}, "
        f"slow {[round(u, 1) for u in runs[True]]} (turns A B B A, slowest "
        f"rank, {HIER_TIMED} chained ops of 8 MiB f32 SUM)")
    runs = {True: [], False: []}
    split = []
    for on in (True, False, False, True):
        with hier_knobs(sl, on=on):
            res = run_ranks(n, fn, device_map=lambda r: devs[r],
                            timeout=600)
        runs[on].append(max(dt for dt, _, _ in res) / HIER_TIMED * 1e6)
        hops = [h for _, _, h in res]
        want = [HOP * HIER_TIMED if on and r % sl == 0 else ()
                for r in range(n)]
        if [tuple(sp[0] for sp in h) for h in hops] != want:
            raise AssertionError(f"9e: leader hop spans {hops}")
        if on:
            split.append([sum(sp[3] for h in hops for sp in h
                              if sp[0] == name) / (n // sl * HIER_TIMED)
                          * 1e6 for name in HOP])
    log(f"[hier] 9e hier against flat, {what}, 8 MiB f32 SUM: us an op "
        f"hier {[round(u, 1) for u in runs[True]]}, flat "
        f"{[round(u, 1) for u in runs[False]]} (turns A B B A, slowest "
        f"rank, {HIER_TIMED} chained ops)")
    for i, (a, b, c) in enumerate(split):
        log(f"[hier] 9e leader hop, hier run {i + 1}: D2H {a:.1f} us, host "
            f"allreduce {b:.1f} us, H2D enqueue {c:.1f} us a leader an op")
    if dev.type == "cuda":
        ms = pinned_copy_ms(dev, 8 * MIB)
        log(f"[hier] 9e pinned 8 MiB copies: D2H {ms[0]:.4f} ms "
            f"({8 * MIB / ms[0] / 1e6:.2f} GB/s), H2D {ms[1]:.4f} ms "
            f"({8 * MIB / ms[1] / 1e6:.2f} GB/s), CUDA events around 20")


def pinned_copy_ms(dev, nbytes: int, reps: int = 20):
    """(D2H ms, H2D ms) of one ``nbytes`` copy between the card and a
    pinned stage: CUDA events around ``reps`` queued copies."""
    from ompi_tpu_torch.runtime import staging
    y = torch.randn(nbytes // 4, device=dev)
    st = staging.aligned_empty(nbytes, dev)
    if not pinned(st):
        raise AssertionError("the stage is not pinned")
    sv = st.view(torch.float32)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ms = []
    for copy in (lambda: sv.copy_(y, non_blocking=True),
                 lambda: y.copy_(sv, non_blocking=True)):
        copy()
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            copy()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b) / reps)
    return ms


def phase_hier(dev) -> dict:
    """Phase 9 on one card's 8 logical devices, slices of 4: 9a (its
    launches, the path's count), 9b, 9c on both tiers, 9d, 9e."""
    from ompi_tpu_torch.runtime.state import LogicalDevice
    devs = [LogicalDevice(dev, r) for r in range(NRANKS)]
    what = f"8 logical devices of {dev}"
    launches = phase_hier_path(devs, 4, what)
    phase_hier_reroute(devs, 4, what)
    phase_hier_wedge([dev] * NRANKS, "hbm", f"8 ranks on {dev}")
    phase_hier_wedge(devs, "tpu", what)
    phase_hier_timing(devs, 4, what)
    return launches


# ---------------------------------------------------------------------------
# 10. fault tolerance: ULFM, respawn, buddy checkpoints
# ---------------------------------------------------------------------------

FT_N = 1 << 21        # elements: the headline's 8 MiB float32 a rank
FT_STEPS = 12         # allreduce steps a run
FT_KILL_STEP = 5      # the step at which the victim dies
FT_VICTIM = 3         # 10a, 10b and 10d's victim
FT_RESPAWNED = 1      # 10c's victim
FT_RACE = 50          # 10e's meetings, one world each
FT_RACE_N = 1 << 18   # 10e's allreduce: 1 MiB float32
FT_CODES = (75, 76, 77)  # MPI_ERR_PROC_FAILED, _PENDING, MPI_ERR_REVOKED


def _card(d):
    """The torch device of a device_map entry (a LogicalDevice's card)."""
    return getattr(d, "device", d)


def ft_input(rank: int, step: int, dev):
    """Rank ``rank``'s operand at ``step``: 8 MiB float32 from the seed
    (a function of the rank in the comm the step runs on, so the
    survivors' steps after a shrink are a fresh world's)."""
    return rank_elems(rank, FT_N, torch.float32, dev, 50 + step)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte identity (``b`` brought to ``a``'s card: one rank a card
    compares outputs of different cards)."""
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.reshape(-1).view(torch.uint8),
                    b.to(a.device).reshape(-1).view(torch.uint8))


def ft_fresh(devs):
    """A fault-free run of FT_STEPS allreduce_arr SUM steps; returns
    each rank's last output."""
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        d = _card(devs[comm.rank])
        for step in range(FT_STEPS):
            out = comm.allreduce_arr(ft_input(comm.rank, step, d), SUM)
        torch.cuda.synchronize()
        return out
    return fn


def ft_shrink_program(devs, times: dict):
    """10a/10b's rank program: FT_STEPS allreduce_arr SUM steps; rank
    FT_VICTIM dies (``kill_now``) at FT_KILL_STEP; each survivor
    catches the ULFM error, shrinks and finishes on the survivors.
    Returns (its last output, the size of the comm it finished on, the
    host time of its raise, its shrink's seconds, (comm size, seconds)
    of each completed step)."""
    from ompi_tpu_torch import errhandler as eh
    from ompi_tpu_torch.ft import ulfm
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        d = _card(devs[comm.rank])
        work, out, step = comm, None, 0
        raised = shrink_s = None
        steps = []
        while step < FT_STEPS:
            if work is comm and comm.rank == FT_VICTIM and \
                    step == FT_KILL_STEP:
                times["kill"] = time.perf_counter()
                ulfm.kill_now(comm.state)
            x = ft_input(work.rank, step, d)
            torch.cuda.synchronize()
            try:
                t0 = time.perf_counter()
                out = work.allreduce_arr(x, SUM)
                torch.cuda.synchronize()
                steps.append((work.size, time.perf_counter() - t0))
                step += 1
            except eh.MPIException as e:
                raised = time.perf_counter()
                if e.code not in FT_CODES:
                    raise
                t0 = time.perf_counter()
                work = work.shrink(name="survivors")
                shrink_s = time.perf_counter() - t0
        return out, work.size, raised, shrink_s, steps
    return fn


def _ft_counted(launches: dict) -> dict:
    """The kernels that launched, for the log."""
    return {k: v for k, v in launches.items() if v}


def _ft_launch_run(fn, n: int, device_map, **kw):
    """run_ranks with every kernel counter zeroed just before and read
    just after: (results, launches)."""
    from ompi_tpu_torch.testing import run_ranks
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    res = run_ranks(n, fn, device_map=device_map, timeout=600, **kw)
    torch.cuda.synchronize()
    return res, {k: c.value for k, c in counters.items()}


def _per_op(launches: dict, nops: int, what: str) -> dict:
    if any(v % nops for v in launches.values()):
        raise AssertionError(f"{what}: launches {launches} are not a "
                             f"multiple of its {nops} ops")
    return {k: v // nops for k, v in launches.items()}


def phase_ft_shrink(devs, tier: str, what: str) -> dict:
    """10a (coll/hbm, every rank on the card) or 10b (the mesh tier,
    logical devices of the card; 7 survivors, not a power of two):
    the ULFM run against fault-free runs of N and N - 1 ranks on the
    same kernels.  Every survivor finishes on N - 1 ranks with the
    fresh (N - 1)-rank world's bytes; the run's launches are exactly
    FT_KILL_STEP ops of the N-rank world plus FT_STEPS - FT_KILL_STEP
    of the (N - 1)-rank one (the meeting the victim never joined
    launches nothing).  Returns (the run's launches, timings)."""
    n = len(devs)
    times = {}
    fresh_n, ln = _ft_launch_run(ft_fresh(devs), n, lambda r: devs[r])
    fresh_m, lm = _ft_launch_run(ft_fresh(devs[:n - 1]), n - 1,
                                 lambda r: devs[r])
    per_n = _per_op(ln, FT_STEPS, f"{tier} fresh {n}")
    per_m = _per_op(lm, FT_STEPS, f"{tier} fresh {n - 1}")
    res, launches = _ft_launch_run(ft_shrink_program(devs, times), n,
                                   lambda r: devs[r], allow_failures=True)
    want = {k: FT_KILL_STEP * per_n[k]
            + (FT_STEPS - FT_KILL_STEP) * per_m[k] for k in launches}
    if launches != want:
        raise AssertionError(f"{tier} ULFM run: launches {launches}, "
                             f"expected {want}")
    if res[FT_VICTIM] is not None:
        raise AssertionError(f"{tier}: the victim survived")
    live = [r for r in res if r is not None]
    for i, (out, size, _, _, _) in enumerate(live):
        if size != n - 1 or not _same(out, fresh_m[i]):
            raise AssertionError(f"{tier}: survivor {i} (size {size}) "
                                 "differs from the fresh world's bytes")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{tier}: survivor {i} non-finite")
    if any(not _same(fresh_n[0], o) for o in fresh_n) or \
            any(not _same(fresh_m[0], o) for o in fresh_m):
        raise AssertionError(f"{tier}: a fresh world's ranks differ")
    detect = max(r[2] for r in live) - times["kill"]
    shrink = max(r[3] for r in live)
    before = max(sum(t for s, t in r[4] if s == n) /
                 max(1, sum(1 for s, _ in r[4] if s == n)) for r in live)
    after = max(sum(t for s, t in r[4] if s == n - 1) /
                max(1, sum(1 for s, _ in r[4] if s == n - 1))
                for r in live)
    log(f"[ft] 10{'a' if tier == 'hbm' else 'b'} ULFM on {tier}, {what}: "
        f"rank {FT_VICTIM} killed at step {FT_KILL_STEP}; {n - 1} "
        f"survivors shrank and finished {FT_STEPS} steps of 8 MiB f32 SUM "
        f"with the fresh {n - 1}-rank world's bytes; launches "
        f"{_ft_counted(launches)} = {FT_KILL_STEP} x {_ft_counted(per_n)} "
        f"+ {FT_STEPS - FT_KILL_STEP} x {_ft_counted(per_m)}")
    return launches, {"detect_ms": detect * 1e3, "shrink_us": shrink * 1e6,
                      "step_before_us": before * 1e6,
                      "step_after_us": after * 1e6}


def ft_respawn_program(devs, victims: dict):
    """10c's rank program: FT_STEPS steps, each a buddy checkpoint of
    {"i", "acc"} (acc an 8 MiB float32 tensor on the rank's card) then
    acc += allreduce_arr(step input); ``victims`` maps rank -> the step
    at which its ORIGINAL incarnation dies.  A survivor catching the
    ULFM error and a replacement alike rejoin and restore.  Returns
    (acc, [checkpoint seconds], [rejoin seconds], [restore seconds],
    the D2H, CRC and ring exchange seconds of one more 8 MiB
    snapshot)."""
    import zlib
    import numpy as np
    from ompi_tpu_torch import errhandler as eh
    from ompi_tpu_torch.cr import buddy, shard
    from ompi_tpu_torch.ft import respawn, ulfm
    from ompi_tpu_torch.op.op import SUM

    def recover(comm, rec):
        t0 = time.perf_counter()
        comm = respawn.rejoin(comm)
        t1 = time.perf_counter()
        st = buddy.restore(comm)
        rec[1].append(t1 - t0)
        rec[2].append(time.perf_counter() - t1)
        return comm, int(st["i"]), st["acc"]

    def fn(comm):
        state = comm.state
        d = _card(devs[comm.rank])
        rec = ([], [], [])
        joining = respawn.joining(state)
        if joining:
            comm, i, acc = recover(comm, rec)
            if acc.device != torch.device(d) and d.type == "cuda":
                raise AssertionError(f"restored onto {acc.device}")
        else:
            i, acc = 0, torch.zeros(FT_N, device=d)
        killed = False
        while i < FT_STEPS:
            try:
                t0 = time.perf_counter()
                buddy.checkpoint(comm, {"i": i, "acc": acc})
                rec[0].append(time.perf_counter() - t0)
                if not joining and not killed and \
                        victims.get(comm.rank) == i:
                    killed = True
                    ulfm.kill_now(state)
                acc = acc + comm.allreduce_arr(ft_input(comm.rank, i, d),
                                               SUM)
                i += 1
            except eh.MPIException as e:
                if e.code not in FT_CODES:
                    raise
                comm, i, acc = recover(comm, rec)
        torch.cuda.synchronize()
        # one more checkpoint's parts on their own: the D2H into the
        # pinned stage, the host CRC and the ring's two Sendrecvs
        t0 = time.perf_counter()
        host = shard.host_bytes(*shard.snapshot(acc))
        t1 = time.perf_counter()
        zlib.crc32(host)
        t2 = time.perf_counter()
        blob = np.frombuffer(shard.dumps({"i": i, "acc": acc}),
                             dtype=np.uint8)
        rbuf = np.empty_like(blob)
        nb, pn = np.array([blob.size], dtype=np.int64), np.zeros(1, np.int64)
        comm.Barrier()
        t3 = time.perf_counter()
        comm.Sendrecv(nb, (comm.rank + 1) % comm.size, 7,
                      pn, (comm.rank - 1) % comm.size, 7)
        comm.Sendrecv(blob, (comm.rank + 1) % comm.size, 8,
                      rbuf, (comm.rank - 1) % comm.size, 8)
        t4 = time.perf_counter()
        return acc, rec, (t1 - t0, t2 - t1, t4 - t3)
    return fn


def phase_ft_respawn(devs, what: str):
    """10c: 8 ranks, cr_buddy_degree 1, a buddy checkpoint of
    {"i", "acc"} every step (acc 8 MiB on the card); rank FT_RESPAWNED
    dies at FT_KILL_STEP right after its checkpoint; its replacement
    (run_ranks' new thread on the dead rank's device) rejoins and
    restores onto that device from its partner's copy, the survivors
    rejoin and restore: every rank's final acc equals the fault-free
    run's byte for byte, and the launches equal it (the restored run
    repeats no completed step).  Returns (launches, timings)."""
    n = len(devs)
    with _knobs(cr_buddy_degree=1):
        clean, lc = _ft_launch_run(ft_respawn_program(devs, {}), n,
                                   lambda r: devs[r])
        faulty, lf = _ft_launch_run(
            ft_respawn_program(devs, {FT_RESPAWNED: FT_KILL_STEP}), n,
            lambda r: devs[r], respawn=True)
    if lf != lc:
        raise AssertionError(f"respawn: launches {lf}, the fault-free "
                             f"run's {lc}")
    for r in range(n):
        if faulty[r] is None or not _same(faulty[r][0], clean[r][0]):
            raise AssertionError(f"respawn: rank {r} differs from the "
                                 "fault-free run")
        if not torch.isfinite(clean[r][0]).all():
            raise AssertionError(f"respawn: rank {r} non-finite")
    rejoins = [t for r in faulty for t in r[1][1]]
    if len(rejoins) != n:
        raise AssertionError(f"respawn: {len(rejoins)} rejoins, "
                             f"expected {n}")
    ckpt = max(sum(r[1][0]) / len(r[1][0]) for r in clean)
    parts = [max(r[2][k] for r in clean) for k in range(3)]
    log(f"[ft] 10c respawn, {what}: rank {FT_RESPAWNED} killed at step "
        f"{FT_KILL_STEP}, replaced and restored from its buddy onto "
        f"{_card(devs[FT_RESPAWNED])}; every rank's acc equals the "
        f"fault-free run's bytes; launches {_ft_counted(lf)} (the "
        "fault-free run's)")
    return lf, {"rejoin_us": max(rejoins) * 1e6,
                "restore_ms": max(t for r in faulty for t in r[1][2]) * 1e3,
                "ckpt_ms": ckpt * 1e3, "d2h_ms": parts[0] * 1e3,
                "crc_ms": parts[1] * 1e3, "exchange_ms": parts[2] * 1e3}


def phase_ft_window(devs, what: str) -> dict:
    """10d: the counter workload (testing.rma, tensor origins on the
    card) on the survivors of a kill, after a shrink, against a fresh
    (N - 1)-rank world: byte for byte, every launch count equal (K9
    rma_acc 5 a rank, K10 rma_cas 1 a rank; the Barrier loop before
    the shrink launches nothing).  Returns the run's launches."""
    from ompi_tpu_torch import errhandler as eh
    from ompi_tpu_torch import osc
    from ompi_tpu_torch.ft import ulfm
    from ompi_tpu_torch.op import op as ops
    from ompi_tpu_torch.testing.rma import Buffers, counter_workload
    n = len(devs)
    wl = counter_workload(osc, ops, Buffers(True))

    def chaos(comm):
        comm.agree(True)  # a sync point that cannot half-complete
        if comm.rank == FT_VICTIM:
            ulfm.kill_now(comm.state)
        work = comm
        while work is comm:
            try:
                work.Barrier()
            except eh.MPIException as e:
                if e.code not in FT_CODES:
                    raise
                work = work.shrink(name="survivors")
        return wl(work)

    fresh, lw = _ft_launch_run(wl, n - 1, lambda r: devs[r])
    got, lg = _ft_launch_run(chaos, n, lambda r: devs[r],
                             allow_failures=True)
    if lg != lw or lw["rma_acc"] != 5 * (n - 1) or \
            lw["rma_cas"] != n - 1:
        raise AssertionError(f"window across a shrink: launches {lg}, a "
                             f"fresh world's {lw}")
    live = [g for g in got if g is not None]
    if got[FT_VICTIM] is not None or live != fresh:
        raise AssertionError("window across a shrink: survivors differ "
                             "from a fresh world's bytes")
    if {g["component"] for g in live} != {"DeviceWindow"}:
        raise AssertionError("window across a shrink: not a device window")
    log(f"[ft] 10d counter workload on the {n - 1} survivors, {what}: the "
        f"fresh {n - 1}-rank world's bytes; launches {_ft_counted(lg)}")
    return lg


def phase_ft_race(dev) -> dict:
    """10e: the finish race.  FT_RACE worlds of 8 ranks, alternately on
    the card (coll/hbm) and on its 8 logical devices (the mesh tier):
    one 1 MiB allreduce_arr SUM, then rank 0 dies right after leaving
    the meeting; no survivor may raise for the op that completed (each
    returns the sum).  Launches: 1 K1 a coll/hbm meeting, 1 K6 + 1 K2
    peer a mesh one.  Returns the launches."""
    from ompi_tpu_torch.ft import ulfm
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.runtime.state import LogicalDevice

    def fn(comm):
        x = torch.full((FT_RACE_N,), comm.rank + 1.0,
                       device=comm.state.device)
        out = comm.allreduce_arr(x, SUM)
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        return float(out[-1])

    total = {}
    want_sum = float(NRANKS * (NRANKS + 1) // 2)
    for i in range(FT_RACE):
        mesh = i % 2 == 1
        devs = ([LogicalDevice(dev, r) for r in range(NRANKS)] if mesh
                else [dev] * NRANKS)
        res, ln = _ft_launch_run(fn, NRANKS, lambda r: devs[r],
                                 allow_failures=True)
        want = ({"mesh_fold": 1, "peer_copy": 1} if mesh
                else {"stacked_reduce": 1})
        if res != [None] + [want_sum] * (NRANKS - 1) or \
                _ft_counted(ln) != want:
            raise AssertionError(f"finish race, meeting {i}: results {res}"
                                 f", launches {_ft_counted(ln)}")
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v
    log(f"[ft] 10e finish race: {FT_RACE} meetings (half coll/hbm, half "
        f"the mesh), rank 0 dying right after each: no survivor raised; "
        f"launches {_ft_counted(total)}")
    return total


def phase_ft(dev) -> dict:
    """Phase 10 on one card: 10a (coll/hbm), 10b (the mesh tier on 8
    logical devices), 10c (respawn + buddy on coll/hbm), 10d (the
    device window across a shrink), 10e (the finish race), 10f (the
    timings, printed with the card's name and power limit).  Returns
    the phase's launches (they join the kernels line)."""
    from ompi_tpu_torch.cr import buddy
    from ompi_tpu_torch.ft import respawn, ulfm
    from ompi_tpu_torch.runtime.state import LogicalDevice
    hbm = [dev] * NRANKS
    mesh = [LogicalDevice(dev, r) for r in range(NRANKS)]
    total = {}

    def add(ln):
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v

    la, ta = phase_ft_shrink(hbm, "hbm", f"8 ranks on {dev}")
    lb, tb = phase_ft_shrink(mesh, "tpu", f"8 logical devices of {dev}")
    lc, tc = phase_ft_respawn(hbm, f"8 ranks on {dev}")
    ld = phase_ft_window(mesh, f"8 logical devices of {dev}")
    le = phase_ft_race(dev)
    for ln in (la, lb, lc, ld, le):
        add(ln)
    card = card_line()
    for k, t in (("10a coll/hbm", ta), ("10b mesh", tb)):
        log(f"[ft] 10f {k}: kill to the last survivor's raise "
            f"{t['detect_ms']:.3f} ms; shrink {t['shrink_us']:.1f} us "
            f"(slowest rank); step {t['step_before_us']:.1f} us on 8 "
            f"ranks, {t['step_after_us']:.1f} us on 7 (slowest rank's "
            f"mean, 8 MiB f32 SUM, host clock) [{card}]")
    log(f"[ft] 10f 10c respawn: rejoin {tc['rejoin_us']:.1f} us, restore "
        f"{tc['restore_ms']:.3f} ms (slowest rank); buddy checkpoint of "
        f"8 MiB a rank {tc['ckpt_ms']:.3f} ms (slowest rank's mean); its "
        f"parts alone: D2H into the pinned stage {tc['d2h_ms']:.3f} ms, "
        f"CRC {tc['crc_ms']:.3f} ms, the ring's two Sendrecvs "
        f"{tc['exchange_ms']:.3f} ms (slowest rank) [{card}]")
    log(f"[ft] 10f pvars: ulfm_shrink_rebuild_us "
        f"{ulfm._pv_shrink_us.read()}, respawn_rejoin_us "
        f"{respawn._pv_rejoin_us.read()}, cr_buddy_replicate_us "
        f"{buddy._pv_us.read():.1f} (process high-water marks) [{card}]")
    return total


def phase_ft_cards(cards) -> None:
    """Phase 10 one rank a card, with four or more: 10a/10b's ULFM run
    on the mesh across cards (N cards -> N - 1 survivors) and 10d."""
    what = f"{len(cards)} cards, one rank each"
    phase_ft_shrink(cards, "tpu", what)
    phase_ft_window(cards, what)


def phase_cards() -> None:
    """One rank a card, on a host with two or more: the mesh, RMA,
    integrity and halo phases and the SHMEM workloads (7a) again, where
    every cross-device read or write goes over peer access (NVLink) —
    send_arr's copy too — and a verify digests each card's outputs on
    that card; a one-card host never takes this branch."""
    nc = min(NRANKS, torch.cuda.device_count())
    cards = [torch.device("cuda", r) for r in range(nc)]
    g = torch.Generator(device=cards[0])
    g.manual_seed(SEED)
    ncases = sum(_kernels_copy_shifts(d, s, g) for d, s in
                 ((cards[0], cards[1]), (cards[1], cards[0])))
    log(f"[K8] rma_copy exact with the source on a peer card ({ncases} "
        "cases: every destination shift, both directions)")
    phase_mesh(cards, f"{nc} cards, one rank each")
    phase_rma(cards, f"{nc} cards, one rank each")
    phase_integrity(cards, "tpu", f"{nc} cards, one rank each")
    phase_halo(cards, "tpu", f"{nc} cards, one rank each")
    phase_shmem_workloads(cards, f"{nc} cards, one PE each")
    if nc >= 4:  # two slices of two ranks at least
        what = f"{nc} cards, one rank each"
        phase_hier_path(cards, 2, what)
        phase_hier_reroute(cards, 2, what)
        phase_hier_wedge(cards, "tpu", what)
        phase_hier_timing(cards, 2, what)
        phase_ft_cards(cards)


# ---------------------------------------------------------------------------
# 11. the process world: mpirun, app shells, B14's process half
# ---------------------------------------------------------------------------

PROC_MIB = 8        # the headline's width: 8 MiB float32 a rank
PULL_MIB = 48       # the cross-process send_arr of 11b
PROC_ITERS = 20     # 11a's chained allreduce_arr calls
SUB_OPS = 3         # 11b's sub-communicator allreduce_arr ops a shell
PROC_REPS = 3       # 11b's timed repetitions (host allreduce, staged
#                     world allreduce, pull)
PROC_JOB_S = 240    # mpirun --timeout of each job (the subprocess gets
#                     60 s more)


def _sync(dev) -> None:
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _in_band(y: torch.Tensor, ref: torch.Tensor, nterms: int,
             what: str) -> float:
    """The float SUM band: |y - sum x_i| <= N * 2**-24 * sum |x_i|
    element by element, ``ref`` = (sum x_i, sum |x_i|) in float64 over
    the N terms.  Returns the largest error."""
    err = (y.double() - ref[0]).abs()
    bad = err > nterms * 2.0 ** -24 * ref[1]
    if not torch.isfinite(y).all() or bool(bad.any()):
        raise AssertionError(f"{what}: outside the float SUM band "
                             f"(max error {float(err.max())})")
    return float(err.max())


def _sum_ref(ranks, n: int, dev, salt: int):
    """(sum x_r, sum |x_r|) in float64 over ``ranks``' rank_elems."""
    tot = torch.zeros(n, dtype=torch.float64, device=dev)
    mag = torch.zeros(n, dtype=torch.float64, device=dev)
    for r in ranks:
        x = rank_elems(r, n, torch.float32, dev, salt).double()
        tot += x
        mag += x.abs()
    return tot, mag


def rank_program_procs(mib: int, pull_mib: int, devarg=None) -> int:
    """11b's rank program, run by every rank-thread of every app shell
    (``chip_smoke.py --rank-program procs MIB PULL_MIB`` under mpirun)
    or by every process rank (``... procs MIB PULL_MIB auto|cpu``:
    rank r on card r % count, or on the CPU; each process is then a
    "shell" of one rank).  In a shell of several ranks, the shell's
    sub-communicator allreduce_arr on the device tier and the leaders'
    host Allreduce of the partial across the shells; with process
    ranks every rank leads, with its own tensor as its partial.  Then
    the world's allreduce_arr of a card tensor (staged through pinned
    stages: the world spans processes) and rank 0's send_arr of
    PULL_MIB of torch.arange to rank size // 2, the first rank of the
    other shell (B14's process half), overwritten right after the
    call.  The lowest rank of each shell prints one ``PROCS`` JSON
    line: its launch counts, the btl that carries its traffic to the
    other shell's lowest rank, the checks, and the timings (host
    clock, slowest rank)."""
    import numpy as np

    import ompi_tpu_torch
    from ompi_tpu_torch.btl import tpu
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.op.op import MAX, SUM
    from ompi_tpu_torch.runtime import staging
    dev = None
    if devarg == "cpu":
        dev = torch.device("cpu")
    elif devarg == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError("11b: --rank-program procs auto needs a "
                               "CUDA card")
        dev = torch.device("cuda", int(os.environ["TPUMPI_RANK"])
                           % torch.cuda.device_count())
    comm = ompi_tpu_torch.init(device=dev)
    rank, size, dev = comm.rank, comm.size, comm.device
    world = getattr(comm.state.rte, "world", None)
    base, nl = (world.rank_base, world.nlocal) if world is not None \
        else (rank, 1)
    shell = list(range(base, base + nl))
    n = mib * MIB // 4
    dst = size // 2
    other = comm.state.pml.endpoints[dst if base == 0 else 0]
    out = {"shell": base, "ranks": nl, "device": str(dev),
           "btl": other.btl.name}

    def slowest(dt: float) -> float:
        a = np.array([dt])
        r = np.empty_like(a)
        comm.Allreduce(a, r, MAX)
        return float(r[0])

    # (1) the shell's ranks: the device tier (K1 on coll/hbm; the mesh
    # tier with one rank a card)
    x = rank_elems(rank, n, torch.float32, dev, 71)
    y, lead, err_sub = x, comm, 0.0
    if nl > 1:
        sub = comm.split(rank // nl)
        lead = comm.split(0 if sub.rank == 0 else 1)
        for _ in range(SUB_OPS):
            y = sub.allreduce_arr(x, SUM)
        err_sub = _in_band(y, _sum_ref(shell, n, dev, 71), nl,
                           "11b sub-communicator allreduce_arr")
        out["sub_provider"] = sub.coll.providers["allreduce_arr"]
    # (2) the leaders' host allreduce of the partial, across the shells
    lead_us = []
    if rank == base:
        stage = staging.aligned_empty(n * 4, dev)
        staging.d2h(y, stage)
        buf = staging.host_view(stage).view(np.float32)
        tot = np.empty_like(buf)
        lead.Allreduce(buf, tot, SUM)
        ref = _sum_ref(range(size), n, dev, 71)
        out["leaders_max_err"] = _in_band(
            torch.from_numpy(tot).to(dev), ref, size,
            "11b leaders' host allreduce")
        for _ in range(PROC_REPS):
            lead.Barrier()
            t0 = time.perf_counter()
            lead.Allreduce(buf, tot, SUM)
            dt = np.array([time.perf_counter() - t0])
            worst = np.empty_like(dt)
            lead.Allreduce(dt, worst, MAX)
            lead_us.append(float(worst[0]) * 1e6)
    out["leaders_us"] = lead_us
    # (3) the world's allreduce_arr of a card tensor: HostArrModule,
    # staged through pinned stages (the world spans processes)
    w = comm.allreduce_arr(x, SUM)
    out["world_provider"] = comm.coll.providers["allreduce_arr"]
    out["world_max_err"] = _in_band(w, _sum_ref(range(size), n, dev, 71),
                                    size, "11b staged world allreduce_arr")
    out["world_us"] = []
    for _ in range(PROC_REPS):
        _sync(dev)
        comm.Barrier()
        t0 = time.perf_counter()
        w = comm.allreduce_arr(x, SUM)
        _sync(dev)
        out["world_us"].append(slowest(time.perf_counter() - t0) * 1e6)
    # (4) B14's process half: rank 0 -> the other shell's first rank
    m = pull_mib * MIB // 4
    want = torch.arange(m, dtype=torch.float32, device=dev) \
        if rank in (0, dst) else None
    out["pull_us"], exact = [], True
    for _ in range(PROC_REPS):
        dt = 0.0
        if rank == 0:
            big = want.clone()
            _sync(dev)
        comm.Barrier()
        if rank == 0:
            eng = tpu._engine(comm.state)
            t0 = time.perf_counter()
            comm.send_arr(big, dst, tag=11)
            big.fill_(-1.0)  # after the call: must not reach dst
            while eng.pending or eng._inflight:
                comm.state.progress.progress()
                comm.state.progress.idle_tick()
            dt = time.perf_counter() - t0
        elif rank == dst:
            t0 = time.perf_counter()
            got = comm.recv_arr(0, tag=11)
            _sync(dev)
            dt = time.perf_counter() - t0
            exact &= bool(torch.equal(got, want)) and \
                got.device == want.device
            del got
        out["pull_us"].append(slowest(dt) * 1e6)
    if rank == dst:
        out["pull_exact"] = exact
    if rank == 0:
        eng = tpu._engine(comm.state)
        out["max_staged_bytes"] = eng.max_staged_bytes
        out["staged_bound"] = (registry.get("btl_tpu_pipeline_depth")
                               + 2) * registry.get("btl_tpu_chunk_bytes")
    _sync(dev)
    comm.Barrier()
    if rank == base:
        # the traffic to the other shell went where the endpoint said
        # at the start (no failover)
        if other.btl.name != out["btl"]:
            out["btl"] += f" -> {other.btl.name}"
        out["launches"] = {k: c.value for k, c in launch_counters().items()}
        out["sub_ops"] = SUB_OPS if nl > 1 else 0
        out["sub_max_err"] = err_sub
        sys.stdout.write("PROCS " + json.dumps(out) + "\n")
        sys.stdout.flush()
    comm.Barrier()
    ompi_tpu_torch.finalize()
    return 0


def rank_program_fail() -> int:
    """11c's failing job: rank 1 raises, the others wait in an
    Allreduce that can never complete."""
    import numpy as np

    import ompi_tpu_torch
    from ompi_tpu_torch.op.op import SUM
    comm = ompi_tpu_torch.init()
    if comm.rank == 1:
        raise RuntimeError("boom on rank 1")
    x = np.zeros(1, np.int32)
    comm.Allreduce(x, x.copy(), SUM)
    ompi_tpu_torch.finalize()
    return 0


RANK_PROGRAMS = {"procs": lambda a: rank_program_procs(int(a[0]),
                                                      int(a[1]), *a[2:]),
                 "fail": lambda a: rank_program_fail()}


def mpirun_job(np_: int, rpp, args, devices: str = "auto", mca=(),
               extra=(), stamps=None):
    """Run ``args`` (a program and its arguments) under ``python -m
    ompi_tpu_torch.tools.mpirun`` from this checkout, with --timeout on
    the job and a subprocess timeout past it (``extra``: more mpirun
    options); the whole process group is killed if that runs out.
    Returns (exit code, stdout, stderr, seconds).  ``stamps``, a dict,
    receives the wall clock at the launch ("t0") and the seconds from
    the launch to each stderr line of a ``--verbose state`` transition,
    keyed by the transition ("MAP -> LAUNCH_DAEMONS", ...)."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun",
           "-np", str(np_), "--timeout", str(PROC_JOB_S), *extra]
    if rpp is not None:
        cmd += ["--ranks-per-proc", str(rpp), "--devices", devices]
    for k, v in mca:
        cmd += ["--mca", k, str(v)]
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    if stamps is not None:
        stamps["t0"] = time.time()
    p = subprocess.Popen(cmd + list(args), cwd=root, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    errs, outs = [], []

    def read_err():
        for line in p.stderr:
            errs.append(line)
            if stamps is not None and "[mpirun:hnp:state]" in line:
                key = line.split("]", 1)[1].split("(")[0].strip()
                stamps.setdefault(key, time.perf_counter() - t0)

    readers = [threading.Thread(target=read_err, daemon=True),
               threading.Thread(target=lambda: outs.extend(p.stdout),
                                daemon=True)]
    for t in readers:
        t.start()
    try:
        p.wait(timeout=PROC_JOB_S + 60)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        for t in readers:
            t.join(timeout=10)
        raise AssertionError(f"mpirun {args} outlived its timeout:\n"
                             f"{''.join(errs)[-3000:]}")
    for t in readers:
        t.join(timeout=60)
    return p.returncode, "".join(outs), "".join(errs), \
        time.perf_counter() - t0


def _json_lines(out: str, prefix: str = ""):
    return [json.loads(ln[len(prefix):]) for ln in out.splitlines()
            if ln.startswith(prefix + "{")]


def phase_procs_headline(devices: str, headline_us):
    """11a: the headline under the launcher — ``-np 8
    --ranks-per-proc all``, examples/device_allreduce.py at 8 MiB
    float32, PROC_ITERS chained allreduce_arr calls: one shell, its
    provider coll/hbm, exactly one K1 launch an op (plus the check op),
    the bytes within the band.  Returns the shell's K1 launches and its
    us an op."""
    prog = os.path.join("ompi_tpu_torch", "examples", "device_allreduce.py")
    rc, out, err, secs = mpirun_job(
        NRANKS, "all", [prog, "--bytes", str(PROC_MIB * MIB), "--iters",
                        str(PROC_ITERS)], devices)
    if rc != 0:
        raise AssertionError(f"11a: mpirun exited {rc}:\n{err[-3000:]}")
    docs = _json_lines(out)
    if len(docs) != 1 or docs[0]["ranks"] != NRANKS:
        raise AssertionError(f"11a: expected one shell line of "
                             f"{NRANKS} ranks, got {docs}")
    d = docs[0]
    card = devices == "auto"
    if d["provider"] != "hbm" or (card and (
            d["k1"] != PROC_ITERS or d["k1_total"] != PROC_ITERS + 1)):
        raise AssertionError(f"11a: provider {d['provider']}, K1 {d['k1']} "
                             f"over {PROC_ITERS} ops, {d['k1_total']} in "
                             f"all (expected {PROC_ITERS} and "
                             f"{PROC_ITERS + 1} on coll/hbm)")
    us = d["us_per_op"]
    busbw = 2 * (NRANKS - 1) / NRANKS * PROC_MIB * MIB / (us * 1e-6) / 1e9
    log(f"[procs] 11a headline under mpirun -np 8 --ranks-per-proc all "
        f"({d['device']}): {us:.1f} us/op, busbw {busbw:.2f} GB/s "
        f"(slowest rank, {PROC_ITERS} chained ops; in-process phase 5 "
        f"{[round(u, 1) for u in headline_us]}); K1 {d['k1']} over the "
        f"ops, {d['k1_total']} in the job; bytes within the band (max "
        f"error {d['max_err']:.3g}); job {secs:.1f} s")
    return d["k1_total"], us


def phase_procs_shells(devices: str, ncards: int, btl,
                       pair: bool = False) -> int:
    """11b on one layout and one btl selection: two app shells of
    NRANKS // 2 ranks (or, with ``ncards``, of ncards ranks each owning
    a card), or (``pair``) two process ranks, both on card 0 (rank r on
    card r % count); the rank program ``procs``.  Checks the btl that
    carries the traffic between the two halves — tcp between app
    shells, each a node of its own as in the reference (mpirun gives
    each its TPUMPI_NODE); shm between process ranks of the one host,
    unless ``btl`` names tcp alone — every shell's counts (the
    sub-communicator ops on the device tier: K1 each on one card, one
    K6 and one K2 peer a card each on the mesh; nothing else, and
    nothing at all for process ranks), the bytes, the pull's exact
    arrival and its staging bound.  Returns the shells' K1 launches."""
    prog = [os.path.abspath(__file__), "--rank-program", "procs",
            str(PROC_MIB), str(PULL_MIB)]
    if pair:
        np_, rpp, layout = 2, None, "2 process ranks"
        prog.append("auto" if devices == "auto" else "cpu")
    else:
        np_ = 2 * ncards if ncards else NRANKS
        rpp, layout = np_ // 2, f"{np_} ranks in 2 app shells"
    half = np_ // 2
    carrier = "shm" if pair and btl is None else "tcp"
    mca = [("btl", btl)] if btl else []
    rc, out, err, secs = mpirun_job(np_, rpp, prog, devices, mca)
    what = f"11b {layout}, btl {btl or 'default'}"
    if rc != 0:
        raise AssertionError(f"{what}: mpirun exited {rc}:\n{err[-4000:]}")
    docs = sorted(_json_lines(out, "PROCS "), key=lambda d: d["shell"])
    if [d["shell"] for d in docs] != [0, half]:
        raise AssertionError(f"{what}: shell lines {docs}")
    card = devices == "auto"
    k1 = 0
    for d in docs:
        if d["btl"] != carrier:
            raise AssertionError(f"{what}: shell {d['shell']}'s traffic "
                                 f"to the other half went over "
                                 f"{d['btl']}, expected {carrier}")
        la = d["launches"]
        if pair:
            want = {}
        elif ncards:
            want = {"mesh_fold": SUB_OPS * ncards,
                    "peer_copy": SUB_OPS * ncards}
        else:
            want = {"stacked_reduce": SUB_OPS}
        want = {k: want.get(k, 0) if card else 0 for k in la}
        if la != want:
            raise AssertionError(f"{what}: shell {d['shell']} launches "
                                 f"{la}, expected {want}")
        sub = None if pair else ("tpu" if ncards else "hbm")
        if d["world_provider"] != "arr_host" or \
                d.get("sub_provider") != sub:
            raise AssertionError(f"{what}: providers sub "
                                 f"{d.get('sub_provider')}, world "
                                 f"{d['world_provider']}")
        k1 += la["stacked_reduce"]
    s, r = docs[0], docs[1]
    if not r.get("pull_exact"):
        raise AssertionError(f"{what}: the {PULL_MIB} MiB pull was not "
                             "exact (or the sender's overwrite reached it)")
    if not 0 < s["max_staged_bytes"] <= s["staged_bound"]:
        raise AssertionError(f"{what}: max_staged_bytes "
                             f"{s['max_staged_bytes']} over the bound "
                             f"{s['staged_bound']}")
    nb = PULL_MIB * MIB
    shells = "" if pair else (
        f"launches a shell "
        f"{[d['launches']['stacked_reduce'] for d in docs]} K1, "
        f"{[d['launches']['mesh_fold'] for d in docs]} K6, "
        f"{[d['launches']['peer_copy'] for d in docs]} K2 peer over "
        f"{SUB_OPS} sub ops (error {s['sub_max_err']:.3g}); ")
    log(f"[procs] {what} ({s['device']}), {carrier} between the halves: "
        f"pull of {PULL_MIB} MiB float32 rank 0 -> {half}: us "
        f"{[round(u, 1) for u in s['pull_us']]} (GB/s "
        f"{[round(nb / (u * 1e-6) / 1e9, 3) for u in s['pull_us']]}), "
        f"exact, max_staged_bytes {s['max_staged_bytes']} <= "
        f"{s['staged_bound']}; staged world allreduce_arr {PROC_MIB} MiB "
        f"us {[round(u, 1) for u in s['world_us']]}; the "
        f"{'ranks' if pair else 'leaders'}' {PROC_MIB} MiB host "
        f"Allreduce us {[round(u, 1) for u in s['leaders_us']]}; "
        f"{shells}errors leaders {s['leaders_max_err']:.3g}, world "
        f"{s['world_max_err']:.3g}; job {secs:.1f} s")
    return k1


def phase_procs_failures(devices: str) -> None:
    """11c: abort_test.py under -np 3 exits 42 with MPI_Abort on
    stderr; a rank-thread raising in a two-shell job ends the job
    non-zero before its timeout."""
    prog = os.path.join("ompi_tpu_torch", "examples", "abort_test.py")
    rc, out, err, secs = mpirun_job(3, None, [prog])
    if rc != 42 or "MPI_Abort" not in err or "should not reach" in out:
        raise AssertionError(f"11c abort: exit {rc}:\n{err[-2000:]}")
    rc2, _, err2, secs2 = mpirun_job(
        4, 2, [os.path.abspath(__file__), "--rank-program", "fail"],
        devices)
    if rc2 in (0, 124) or "boom on rank 1" not in err2:
        raise AssertionError(f"11c failing rank: exit {rc2}:\n"
                             f"{err2[-2000:]}")
    log(f"[procs] 11c abort_test -np 3: exit {rc}, MPI_Abort on stderr "
        f"({secs:.1f} s); a raising rank-thread in 2 shells: exit {rc2} "
        f"({secs2:.1f} s, job timeout {PROC_JOB_S} s)")


def phase_procs(dev, headline_us, devices: str = "auto"):
    """Phase 11 on one card: 11a; 11b across two app shells (tcp), and
    between two process ranks over shm and over tcp; 11c; and the
    pinned copy rates that bound the pull; the phase's time.  Returns
    the shells' K1 launches (they join the kernels line) and 11a's us
    an op."""
    t0 = time.perf_counter()
    k1, us_11a = phase_procs_headline(devices, headline_us)
    k1 += phase_procs_shells(devices, 0, None)
    for btl in (None, "self,tcp"):
        k1 += phase_procs_shells(devices, 0, btl, pair=True)
    phase_procs_failures(devices)
    if devices == "auto":
        d2h, h2d = pinned_copy_ms(dev, 4 * MIB)
        nb = PULL_MIB * MIB
        bound_ms = nb / (4 * MIB / d2h) + nb / (4 * MIB / h2d)
        log(f"[procs] pinned 4 MiB copies (the pull's chunk): D2H "
            f"{d2h:.4f} ms ({4 * MIB / d2h / 1e6:.2f} GB/s), H2D "
            f"{h2d:.4f} ms ({4 * MIB / h2d / 1e6:.2f} GB/s); the {PULL_MIB} "
            f"MiB pull's bound on its two copies {bound_ms:.3f} ms "
            f"({nb / bound_ms / 1e6:.2f} GB/s)")
    log(f"[procs] phase 11: {time.perf_counter() - t0:.1f} s, the shells' "
        f"K1 launches {k1}")
    return k1, us_11a


# ---------------------------------------------------------------------------
# 12. the multi-node launcher: the PLM, tpud daemons, simulated nodes
# ---------------------------------------------------------------------------

NODE_ITERS = 20     # 12b's timed hierarchical allreduce ops
BIG_MIB = 256       # 12c's send_arr across two simulated nodes


def _daemons_reported(stamps: dict, what: str) -> float:
    if "LAUNCH_DAEMONS -> DAEMONS_REPORTED" not in stamps:
        raise AssertionError(f"{what}: no DAEMONS_REPORTED transition "
                             f"in the state trace ({sorted(stamps)})")
    return stamps["LAUNCH_DAEMONS -> DAEMONS_REPORTED"]


def phase_nodes_headline(devices: str, us_11a) -> int:
    """12a: 11a's job through the PLM (``--hosts localhost:8``): one
    daemon, one shell, coll/hbm, one K1 an op plus the check op, the
    bytes within the band.  Returns the shell's K1 launches."""
    prog = os.path.join("ompi_tpu_torch", "examples", "device_allreduce.py")
    stamps = {}
    rc, out, err, secs = mpirun_job(
        NRANKS, "all", [prog, "--bytes", str(PROC_MIB * MIB), "--iters",
                        str(PROC_ITERS)], devices,
        extra=("--hosts", f"localhost:{NRANKS}", "--verbose", "state"),
        stamps=stamps)
    if rc != 0:
        raise AssertionError(f"12a: mpirun exited {rc}:\n{err[-3000:]}")
    docs = _json_lines(out)
    if len(docs) != 1 or docs[0]["ranks"] != NRANKS:
        raise AssertionError(f"12a: expected one shell line of {NRANKS} "
                             f"ranks, got {docs}")
    d = docs[0]
    card = devices == "auto"
    if d["provider"] != "hbm" or (card and (
            d["k1"] != PROC_ITERS or d["k1_total"] != PROC_ITERS + 1)):
        raise AssertionError(f"12a: provider {d['provider']}, K1 {d['k1']} "
                             f"over {PROC_ITERS} ops, {d['k1_total']} in "
                             f"all (expected {PROC_ITERS} and "
                             f"{PROC_ITERS + 1} on coll/hbm)")
    reported = _daemons_reported(stamps, "12a")
    log(f"[nodes] 12a headline through the PLM, -np 8 --hosts "
        f"localhost:8 --ranks-per-proc all ({d['device']}): "
        f"{d['us_per_op']:.1f} us/op (slowest rank, {PROC_ITERS} chained "
        f"ops; 11a in this run {us_11a:.1f}); K1 {d['k1']} over the ops, "
        f"{d['k1_total']} in the job; max error {d['max_err']:.3g}; "
        f"DAEMONS_REPORTED at {reported:.2f} s; job {secs:.1f} s")
    return d["k1_total"]


def phase_nodes_hier(devices: str, ncards: int = 0) -> dict:
    """12b: examples/hier_allreduce.py at 8 MiB float32 a rank on two
    simulated nodes of NRANKS // 2 ranks, each on that many logical
    devices of card 0 (or, with ``ncards``, of ncards // 2 ranks each
    owning a card): one line a node, its node comm on the mesh tier,
    exactly one K6 and one K2 peer a card an op (the check op's too),
    no K1; the result within the float SUM band (the program checks
    it); each step's us.  Returns the nodes' launches."""
    half = ncards // 2 if ncards else NRANKS // 2
    np_ = 2 * half
    prog = os.path.join("ompi_tpu_torch", "examples", "hier_allreduce.py")
    stamps = {}
    rc, out, err, secs = mpirun_job(
        np_, "all", [prog, "--bytes", str(PROC_MIB * MIB), "--iters",
                     str(NODE_ITERS)], devices,
        extra=("--simulate-nodes", f"2x{half}", "--verbose", "state"),
        stamps=stamps)
    what = f"12b {np_} ranks on 2 simulated nodes" + (
        ", one card a device" if ncards else "")
    if rc != 0:
        raise AssertionError(f"{what}: mpirun exited {rc}:\n{err[-4000:]}")
    docs = sorted(_json_lines(out), key=lambda d: d["node"])
    if [d["node"] for d in docs] != [0, 1]:
        raise AssertionError(f"{what}: node lines {docs}")
    cards = half if ncards else 1
    card = devices == "auto"
    total = {"stacked_reduce": 0, "mesh_fold": 0, "peer_copy": 0}
    for d in docs:
        want = {"mesh_fold": NODE_ITERS * cards,
                "peer_copy": NODE_ITERS * cards, "stacked_reduce": 0}
        want_all = {k: v + v // NODE_ITERS for k, v in want.items()}
        if not card:
            want = want_all = dict.fromkeys(want, 0)
        if d["node_provider"] != "tpu" or d["ranks"] != half or \
                d["launches"] != want or d["launches_total"] != want_all:
            raise AssertionError(f"{what}: node {d['node']}: provider "
                                 f"{d['node_provider']}, launches "
                                 f"{d['launches']} of {d['launches_total']}"
                                 f" (expected {want} of {want_all} on the "
                                 f"mesh tier)")
        for k in total:
            total[k] += d["launches_total"][k]
    d = docs[0]
    reported = _daemons_reported(stamps, what)
    first = min(x["unix_first_collective"] for x in docs) - stamps["t0"]
    first_ar = min(x["unix_first_allreduce"] for x in docs) - stamps["t0"]
    nb = PROC_MIB * MIB
    log(f"[nodes] {what} ({d['device']}), hier_allreduce {PROC_MIB} MiB "
        f"float32 a rank: {d['us_per_op']:.1f} us/op (slowest leader, "
        f"{NODE_ITERS} ops): node allreduce_arr "
        f"{d['us_node_allreduce']:.1f} us, leaders' tcp Allreduce "
        f"{d['us_leaders_allreduce']:.1f} us "
        f"({nb / (d['us_leaders_allreduce'] * 1e-6) / 1e9:.3f} GB/s of "
        f"the partial), node Bcast {d['us_node_bcast']:.1f} us; launches "
        f"a node {[x['launches'] for x in docs]} over the ops, "
        f"{[x['launches_total'] for x in docs]} in all; max error "
        f"{max(x['max_err'] for x in docs):.3g}; from the launch: "
        f"DAEMONS_REPORTED {reported:.2f} s, the first collectives "
        f"{first:.2f} s, the first hierarchical allreduce {first_ar:.2f} "
        f"s; job {secs:.1f} s")
    return total


def phase_nodes_big(dev, devices: str) -> None:
    """12c: BIG_MIB MiB of torch.arange on the card, send_arr ->
    recv_arr across two simulated nodes (process ranks, btl/tcp):
    exact, the sender's overwrite never reaching the receiver, its
    staging within (depth + 2) chunks; GB/s beside the bound of the
    pull's two pinned copies (one D2H, one H2D)."""
    prog = os.path.join("ompi_tpu_torch", "examples", "devp2p_big.py")
    rc, out, err, secs = mpirun_job(
        2, None, [prog, "--mb", str(BIG_MIB), "--device",
                  "auto" if devices == "auto" else "cpu"],
        extra=("--simulate-nodes", "2"))
    if rc != 0:
        raise AssertionError(f"12c: mpirun exited {rc}:\n{err[-3000:]}")
    docs = {d["rank"]: d for d in _json_lines(out)}
    s, r = docs[0], docs[1]
    if s["btl"] != "tcp" or r["btl"] != "tcp" or not r.get("exact") \
            or not 0 < s["staged"] <= s["bound"]:
        raise AssertionError(f"12c: sender {s}, receiver {r}")
    nb = BIG_MIB * MIB
    sec = max(s["seconds"], r["seconds"])
    bound = ""
    if devices == "auto":
        d2h, h2d = pinned_copy_ms(dev, 4 * MIB)
        bound_ms = nb / (4 * MIB / d2h) + nb / (4 * MIB / h2d)
        bound = (f"; the bound of its two pinned copies {bound_ms:.2f} ms "
                 f"({nb / bound_ms / 1e6:.2f} GB/s; 4 MiB D2H {d2h:.4f} "
                 f"ms, H2D {h2d:.4f} ms)")
    log(f"[nodes] 12c {BIG_MIB} MiB send_arr -> recv_arr across 2 simulated "
        f"nodes ({s['device']}, tcp): exact, {s['chunks']} chunks, "
        f"max_staged_bytes {s['staged']} <= {s['bound']}; sender "
        f"{s['seconds'] * 1e3:.1f} ms, receiver {r['seconds'] * 1e3:.1f} "
        f"ms, {nb / sec / 1e9:.3f} GB/s{bound}; job {secs:.1f} s")


def phase_nodes_abort() -> None:
    """12d: abort_test.py across ``--simulate-nodes 2x2`` exits 42 with
    MPI_Abort on stderr; the seconds from the launch to
    DAEMONS_REPORTED."""
    prog = os.path.join("ompi_tpu_torch", "examples", "abort_test.py")
    stamps = {}
    rc, out, err, secs = mpirun_job(
        4, None, [prog], extra=("--simulate-nodes", "2x2", "--verbose",
                                "state"), stamps=stamps)
    if rc != 42 or "MPI_Abort" not in err or "should not reach" in out:
        raise AssertionError(f"12d abort: exit {rc}:\n{err[-2000:]}")
    log(f"[nodes] 12d abort_test -np 4 --simulate-nodes 2x2: exit {rc}, "
        f"MPI_Abort on stderr; DAEMONS_REPORTED "
        f"{_daemons_reported(stamps, '12d'):.2f} s, job {secs:.1f} s")


def phase_nodes(dev, us_11a: float, devices: str = "auto") -> dict:
    """Phase 12 on one card: 12a, 12b, 12c, 12d; the phase's time.
    Returns the K1, K6 and K2 peer launches (they join the kernels
    line)."""
    t0 = time.perf_counter()
    launches = phase_nodes_hier(devices)
    launches["stacked_reduce"] += phase_nodes_headline(devices, us_11a)
    phase_nodes_big(dev, devices)
    phase_nodes_abort()
    log(f"[nodes] phase 12: {time.perf_counter() - t0:.1f} s, launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# 13. the resident pool: tools/dvm.py, its sessions, mpirun --dvm
# ---------------------------------------------------------------------------

POOL_NP = 8             # the pool's rank capacity (--np)
POOL_SESSION = 4        # ranks a session: two sessions fill the pool
POOL_WINDOW_US = 800_000  # 13a's open window, the reference test's
POOL_REPS = 200         # reps of the timed run: 4 collectives a rep
POOL_T = 120            # seconds: each RPC, wait and job of the phase
POOL_PROG = os.path.join("ompi_tpu_torch", "examples", "dvm_session.py")
POOL_SOLO = []          # phase 13's solo DIGEST, for phase 14 to match


class _PoolProc:
    """``python -m ompi_tpu_torch.tools.dvm`` as a subprocess of its own
    (its own CUDA context; this script's stdio untouched): stdout to
    /dev/null, stderr to a file whose tail a failure prints.  ``kill``
    ends it (and anything it started) whatever state it is in."""

    def __init__(self, tmp: str, name: str, devices: str,
                 window_us: int = 0, dev=None, hosts: int = 1,
                 mca=None) -> None:
        root = os.path.dirname(os.path.abspath(__file__))
        self.uri = os.path.join(tmp, f"{name}.uri")
        self.err_path = os.path.join(tmp, f"{name}.err")
        cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.dvm",
               "--np", str(POOL_NP), "--devices", devices,
               "--uri-file", self.uri]
        if window_us:
            cmd += ["--batch-window-us", str(window_us)]
        if hosts > 1:
            cmd += ["--hosts", str(hosts)]
        env = dict(os.environ)
        for k, v in (mca or {}).items():
            env[f"TPUMPI_MCA_{k}"] = str(v)
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        if dev is not None and dev.type == "cuda":
            # the pool sees this card alone, so every session rank
            # (card r % count) lands on it: coll/hbm, the path whose
            # counts the phase derives — never the mesh tier
            seen = env.get("CUDA_VISIBLE_DEVICES")
            env["CUDA_VISIBLE_DEVICES"] = (
                seen.split(",")[dev.index or 0].strip() if seen
                else str(dev.index or 0))
        self._err = open(self.err_path, "w")
        self.t0 = time.perf_counter()
        self.p = subprocess.Popen(cmd, cwd=root, env=env,
                                  stdout=subprocess.DEVNULL,
                                  stderr=self._err, start_new_session=True)
        self.ready_s = None

    def wait_ready(self) -> float:
        deadline = time.monotonic() + POOL_T
        while not os.path.exists(self.uri):
            if self.p.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"pool {self.uri} never came up (exit "
                    f"{self.p.poll()}):\n{self.tail()}")
            time.sleep(0.02)
        self.ready_s = time.perf_counter() - self.t0
        return self.ready_s

    def tail(self) -> str:
        self._err.flush()
        with open(self.err_path) as f:
            return f.read()[-3000:]

    def halt(self) -> int:
        from ompi_tpu_torch.tools.dvm import DvmClient
        with DvmClient(self.uri) as c:
            if not c.halt().get("ok"):
                raise AssertionError(f"pool {self.uri}: halt refused")
        return self.p.wait(timeout=POOL_T)

    def kill(self) -> None:
        import signal
        if self.p.poll() is None:
            try:
                os.killpg(self.p.pid, signal.SIGKILL)
            except OSError:
                pass
            self.p.wait(timeout=POOL_T)
        self._err.close()


def pool_digest(dev, np_: int, reps: int) -> str:
    """The DIGEST of examples/dvm_session.py on ``np_`` ranks, ``reps``
    reps, computed here with plain torch on ``dev`` from the same
    formula (rank 0's result bytes of each collective of a rep)."""
    r = torch.arange(np_, device=dev, dtype=torch.int32)[:, None]
    a = (torch.arange(32, dtype=torch.int32, device=dev) * (r + 1)).sum(
        0, dtype=torch.int32)
    b = (r + 1).float().expand(np_, 16).clone()
    b[:, 0] = (-r[:, 0]).float()  # an integer 0 for rank 0, never -0.0
    b = b.max(0).values
    c = torch.full((7,), (1 % np_) * 3 + 1, dtype=torch.int32, device=dev)
    d = (r + 1).float().expand(np_, 64).sum(0)
    rep = b"".join(t.cpu().numpy().tobytes() for t in (a, b, c, d))
    return hashlib.sha256(rep * reps).hexdigest()


def _pool_lines(stdout: str, kind: str, tag: str):
    out = []
    for line in stdout.splitlines():
        parts = line.split(" ", 2)
        if len(parts) == 3 and parts[0] == kind and parts[1] == tag:
            out.append(parts[2])
    return out


def _pool_digest_of(resp: dict, tag: str, what: str) -> str:
    if resp.get("code") != 0:
        raise AssertionError(f"{what}: exit {resp.get('code')}:\n"
                             f"{resp.get('stderr', '')[-3000:]}")
    got = _pool_lines(resp["stdout"], "DIGEST", tag)
    if len(got) != 1:
        raise AssertionError(f"{what}: no single DIGEST line in "
                             f"{resp['stdout']!r}")
    return got[0]


def _pool_counts(c) -> dict:
    m = c.metrics(events=0, prometheus=False)
    n = dict(m["launches"])
    # a pool that ran no device collective yet has not registered them
    n["xsession_batches"] = m["pvars"].get("dvm_xsession_batches", 0)
    n["xsession_collectives"] = m["pvars"].get(
        "dvm_xsession_collectives", 0)
    n["libs"] = m["kernel_libs"]
    return n


def _pool_moved(a: dict, b: dict) -> dict:
    keys = ("fused_batch", "stacked_reduce", "xsession_batches",
            "xsession_collectives")
    return {k: b.get(k, 0) - a.get(k, 0) for k in keys}


def pool_pair(uri: str, tag: str):
    """Two sessions of POOL_SESSION ranks attached first (the pool
    reports 2 resident before either program dispatches), both running
    the mix at once, then detached.  Returns (responses, wall s)."""
    from ompi_tpu_torch.tools.dvm import DvmClient
    cs = [DvmClient(uri), DvmClient(uri)]
    res = [None, None]
    try:
        sids = [c.attach(POOL_SESSION, timeout=POOL_T)["sid"] for c in cs]

        def runner(i):
            res[i] = cs[i].run(sids[i], POOL_PROG, [tag, "1", "report"],
                               timeout=POOL_T)

        ths = [threading.Thread(target=runner, args=(i,)) for i in (0, 1)]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=POOL_T)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in ths) or None in res:
            raise AssertionError(f"{tag}: a concurrent run never returned")
        for c, sid in zip(cs, sids):
            c.detach(sid)
    finally:
        for c in cs:
            c.close()
    return res, wall


def _pool_want(card: bool, k3: int, k1: int, xb: int = 0, xc: int = 0):
    return {"fused_batch": k3 if card else 0,
            "stacked_reduce": k1 if card else 0,
            "xsession_batches": xb, "xsession_collectives": xc}


def _pool_check(moved: dict, want: dict, what: str) -> None:
    if moved != want:
        raise AssertionError(f"{what}: the pool's counts moved {moved}, "
                             f"expected {want} (K3 one a (op, dtype) group "
                             f"a batch: 2 a rep; a combined dispatch 2 for "
                             f"both sessions; K1 one a blocking allreduce)")


def phase_pool(dev, devices: str = "auto") -> dict:
    """Phase 13: the resident pool on the card.  Two pool subprocesses
    (``--np 8 --devices auto``; the second with ``--batch-window-us
    800000``) driven through the port's DvmClient.  13a: one session of
    4 runs examples/dvm_session.py twice (digests equal, and equal to
    the plain-torch digest of the same formula), a warm attach runs it
    POOL_REPS times (µs a collective), two sessions of 4 run it at
    once with the window shut; on the second pool a solo run, then two
    sessions at once with the window open — their fused batches ride
    one combined K3 launch a group.  Each run's K3 / K1 launches and
    dvm_xsession moves (the pool's metrics) exact.  13b: ``mpirun --dvm
    URI -np 4`` examples/device_allreduce.py exits 0, exact, its K1
    launches exact.  13c: a session whose program raises returns
    non-zero and launches nothing; a session attached right after
    prints the solo digest, its launches exact.  Each pool sees only
    ``dev`` (the counts are derived for every rank on one card).  13d: halt drains each pool and
    its process exits 0.  Returns the pools' K3 and K1 launches over
    their lives (they join the kernels line)."""
    import tempfile

    from ompi_tpu_torch.tools.dvm import DvmClient
    t_phase = time.perf_counter()
    card = devices == "auto"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pool_")
    pa = _PoolProc(tmp, "shut", devices, dev=dev)
    pb = _PoolProc(tmp, "open", devices, POOL_WINDOW_US, dev=dev)
    total = {"fused_batch": 0, "stacked_reduce": 0}
    ok = False
    try:
        ready = (pa.wait_ready(), pb.wait_ready())
        want1 = pool_digest(dev, POOL_SESSION, 1)
        # 13a, pool A: solo twice, warm attach, the timed run
        with DvmClient(pa.uri) as c:
            t0 = time.perf_counter()
            sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]
            cold_ms = (time.perf_counter() - t0) * 1e3
            n0 = _pool_counts(c)
            walls, digs = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                r = c.run(sid, POOL_PROG, ["solo", "1", "report"],
                          timeout=POOL_T)
                walls.append((time.perf_counter() - t0) * 1e3)
                digs.append(_pool_digest_of(r, "solo", "13a solo"))
            n1 = _pool_counts(c)
            if digs != [want1, want1]:
                raise AssertionError(f"13a solo digests {digs}, the plain "
                                     f"torch digest {want1}")
            POOL_SOLO[:] = digs[:1]
            _pool_check(_pool_moved(n0, n1), _pool_want(card, 4, 2),
                        "13a two solo runs")
            c.detach(sid)
            t0 = time.perf_counter()
            sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]
            warm_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            r = c.run(sid, POOL_PROG, ["timed", str(POOL_REPS), "report"],
                      timeout=POOL_T)
            timed_s = time.perf_counter() - t0
            dig = _pool_digest_of(r, "timed", "13a timed")
            if dig != pool_digest(dev, POOL_SESSION, POOL_REPS):
                raise AssertionError(f"13a timed run: digest {dig}")
            rep = json.loads(_pool_lines(r["stdout"], "REPORT", "timed")[0])
            n2 = _pool_counts(c)
            _pool_check(_pool_moved(n1, n2),
                        _pool_want(card, 2 * POOL_REPS, POOL_REPS),
                        "13a timed run")
            c.detach(sid)
        # 13a, pool A: two sessions at once, the window shut
        res, pair_s = pool_pair(pa.uri, "shut")
        with DvmClient(pa.uri) as c:
            n3 = _pool_counts(c)
        digs = [_pool_digest_of(x, "shut", "13a shut pair") for x in res]
        if digs != [want1, want1]:
            raise AssertionError(f"13a shut pair digests {digs}")
        _pool_check(_pool_moved(n2, n3), _pool_want(card, 4, 2),
                    "13a two sessions, window shut")
        if n3["libs"] != n1["libs"]:
            raise AssertionError(f"13a: later sessions loaded kernel "
                                 f"libraries ({n1['libs']} -> "
                                 f"{n3['libs']})")
        # 13b: mpirun --dvm
        rc, out, err, mp_s = mpirun_job(
            POOL_SESSION, None,
            [os.path.join("ompi_tpu_torch", "examples",
                          "device_allreduce.py")], extra=("--dvm", pa.uri))
        oks = sorted(ln for ln in out.splitlines() if ln.endswith(" ok"))
        if rc != 0 or "coll_allreduce_arr_provider=hbm" not in out or \
                oks != [f"rank {i} ok" for i in range(POOL_SESSION)]:
            raise AssertionError(f"13b mpirun --dvm: exit {rc}:\n{out}\n"
                                 f"{err[-3000:]}")
        k1_line = [ln for ln in out.splitlines()
                   if ln.startswith("coll_hbm_k1_launches=")]
        # rank 0's own count: allreduce_arr, reduce_scatter_arr and the
        # two halves' allreduce_arr, one K1 each on the card
        if k1_line != [f"coll_hbm_k1_launches={4 if card else 0}"]:
            raise AssertionError(f"13b mpirun --dvm: {k1_line}, expected "
                                 f"{4 if card else 0} K1 launches")
        with DvmClient(pa.uri) as c:
            nb = _pool_counts(c)
        _pool_check(_pool_moved(n3, nb), _pool_want(card, 0, 4),
                    "13b mpirun --dvm device_allreduce.py")
        # 13c: a failing session, then a session that must still work
        bad = os.path.join(tmp, "boom.py")
        with open(bad, "w") as f:
            f.write("import ompi_tpu_torch\n"
                    "comm = ompi_tpu_torch.init()\n"
                    "raise RuntimeError('boom rank %d' % comm.rank)\n")
        with DvmClient(pa.uri) as c:
            sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]
            rb = c.run(sid, bad, timeout=POOL_T)
            if rb.get("code") == 0 or "boom" not in rb.get("stderr", ""):
                raise AssertionError(f"13c: the failing session returned "
                                     f"{rb.get('code')}")
            c.detach(sid)
            nc = _pool_counts(c)
            _pool_check(_pool_moved(nb, nc), _pool_want(card, 0, 0),
                        "13c the failing session (no collective)")
            sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]
            r = c.run(sid, POOL_PROG, ["after"], timeout=POOL_T)
            if _pool_digest_of(r, "after", "13c") != want1:
                raise AssertionError("13c: the session after the failing "
                                     "one printed another digest")
            c.detach(sid)
            na = _pool_counts(c)
            _pool_check(_pool_moved(nc, na), _pool_want(card, 2, 1),
                        "13c the session after the failing one")
        # 13d, pool A
        t0 = time.perf_counter()
        rc_a = pa.halt()
        halt_a_ms = (time.perf_counter() - t0) * 1e3
        if rc_a != 0:
            raise AssertionError(f"13d: pool A exited {rc_a}:\n{pa.tail()}")
        # 13a, pool B: solo, then two sessions with the window open
        with DvmClient(pb.uri) as c:
            sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]
            m0 = _pool_counts(c)
            r = c.run(sid, POOL_PROG, ["open", "1", "report"],
                      timeout=POOL_T)
            if _pool_digest_of(r, "open", "13a open solo") != want1:
                raise AssertionError("13a: pool B's solo digest differs")
            m1 = _pool_counts(c)
            _pool_check(_pool_moved(m0, m1), _pool_want(card, 2, 1),
                        "13a pool B solo (one session: window unused)")
            c.detach(sid)
        res, open_s = pool_pair(pb.uri, "open")
        with DvmClient(pb.uri) as c:
            m2 = _pool_counts(c)
        digs = [_pool_digest_of(x, "open", "13a open pair") for x in res]
        if digs != [want1, want1]:
            raise AssertionError(f"13a open pair digests {digs}")
        moved = _pool_moved(m1, m2)
        if moved["xsession_batches"] < 1:
            raise AssertionError(f"13a: no combined dispatch with the "
                                 f"window open ({moved})")
        _pool_check(moved, _pool_want(card, 2, 2, 1, 6),
                    "13a two sessions, window open (one combined K3 a "
                    "group)")
        t0 = time.perf_counter()
        rc_b = pb.halt()
        halt_b_ms = (time.perf_counter() - t0) * 1e3
        if rc_b != 0:
            raise AssertionError(f"13d: pool B exited {rc_b}:\n{pb.tail()}")
        for n in (na, m2):
            total["fused_batch"] += n.get("fused_batch", 0)
            total["stacked_reduce"] += n.get("stacked_reduce", 0)
        ok = True
    finally:
        if not ok:
            for pp in (pa, pb):
                log(f"[pool] stderr tail of {pp.uri}:\n{pp.tail()}")
        pa.kill()
        pb.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[pool] {card_line()}")
    log(f"[pool] 13a pool up in {ready[0]:.2f} / {ready[1]:.2f} s (two "
        f"pools started together, --np {POOL_NP} --devices {devices}); "
        f"attach of {POOL_SESSION} ranks: cold {cold_ms:.1f} ms, warm "
        f"{warm_ms:.1f} ms; a solo run {walls[0]:.1f} then {walls[1]:.1f} "
        f"ms (client wall); the timed run of {POOL_REPS} reps "
        f"{timed_s * 1e3:.1f} ms, {rep['us_per_coll']:.1f} us a collective "
        f"inside the session (rank 0, {4 * POOL_REPS} collectives); two "
        f"sessions at once {pair_s * 1e3:.1f} ms with the window shut, "
        f"{open_s * 1e3:.1f} ms with it open ({POOL_WINDOW_US} us); every "
        f"DIGEST {want1[:16]}... = the plain torch digest")
    log(f"[pool] 13a launches (pool metrics): two solo runs "
        f"{_pool_moved(n0, n1)}, timed {_pool_moved(n1, n2)}, pair shut "
        f"{_pool_moved(n2, n3)}, pool B solo {_pool_moved(m0, m1)}, pair "
        f"open {moved}; rank 0's REPORT of the open pair "
        f"{[_pool_lines(x['stdout'], 'REPORT', 'open')[0] for x in res]}; "
        f"kernel libraries loaded {n3['libs']}")
    log(f"[pool] 13b mpirun --dvm -np {POOL_SESSION} device_allreduce.py: "
        f"exit 0, {k1_line}, pool moved {_pool_moved(n3, nb)}, job "
        f"{mp_s:.1f} s; 13c failing session exit {rb.get('code')}, moved "
        f"{_pool_moved(nb, nc)}; the next session's digest the solo one, "
        f"moved {_pool_moved(nc, na)}; 13d "
        f"halt: pool A {halt_a_ms:.0f} ms, pool B {halt_b_ms:.0f} ms, both "
        f"exit 0; pools' launches over their lives {total}; phase 13 "
        f"{secs:.1f} s")
    return total


FLEET_HOSTS = 2         # host failure domains of the fleet's pools
FLEET_REPS = 50         # reps of 14a's timed run: 4 collectives a rep
FLEET_STEPS = 12        # fleet_host.py's steps (a pass)
FLEET_HOLD = 3          # 14b: the step at which host 1 dies
FLEET_CKPT_STEPS = 10   # fleet_ckpt.py's steps
FLEET_CKPT_HOLD = 4     # 14c: the step at which host 1 dies
FLEET_MIB = 8           # the card tensor a rank of fleet_host/ulfm_procs
# 14b's kill point: pool A's host_kill fault fires at its Nth served op
# (the agents' beats are not counted).  The ops before it: the two
# agents' registrations, 17 ops of 14a and 6 of 14b (see phase_fleet,
# which checks the count before it sends op N)
FLEET_KILL_OP = 2 + 17 + 6 + 1
HOST_PROG = os.path.join("ompi_tpu_torch", "examples", "fleet_host.py")
CKPT_PROG = os.path.join("ompi_tpu_torch", "examples", "fleet_ckpt.py")


class _Agent:
    """``python -m ompi_tpu_torch.tools.tpud --fleet URI --host H``: one
    host agent (no torch), stderr to a file whose tail a failure
    prints."""

    def __init__(self, tmp: str, uri: str, host: int, n: int = 0) -> None:
        root = os.path.dirname(os.path.abspath(__file__))
        self.err_path = os.path.join(tmp, f"agent{host}.{n}.err")
        env = dict(os.environ)
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        self._err = open(self.err_path, "w")
        self.t0 = time.perf_counter()
        self.p = subprocess.Popen(
            [sys.executable, "-m", "ompi_tpu_torch.tools.tpud", "--fleet",
             uri, "--host", str(host)], cwd=root, env=env,
            stdout=subprocess.DEVNULL, stderr=self._err,
            start_new_session=True)

    def wait_registered(self) -> float:
        """Seconds from the agent's start to its registration."""
        deadline = time.monotonic() + POOL_T
        while "registered with fleet" not in self.text():
            if self.p.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"agent {self.err_path} never "
                                     f"registered (exit {self.p.poll()})")
            time.sleep(0.01)
        return time.perf_counter() - self.t0

    def text(self) -> str:
        self._err.flush()
        with open(self.err_path) as f:
            return f.read()

    def kill(self) -> None:
        import signal
        if self.p.poll() is None:
            try:
                os.killpg(self.p.pid, signal.SIGKILL)
            except OSError:
                pass
            self.p.wait(timeout=POOL_T)
        self._err.close()


def _tail40(text: str) -> str:
    return "\n".join(text.splitlines()[-40:])


def fleet_host_digest(np_: int, steps: int) -> str:
    """examples/fleet_host.py's DIGEST on ``np_`` ranks (or survivors),
    from its formula with numpy: the sum over the steps of each step's
    allreduced contribution."""
    import numpy as np
    vec = np.zeros(32, np.float64)
    for step in range(steps):
        vec = vec + float((step + 1) * sum(range(1, np_ + 1)))
    return hashlib.sha256(vec.tobytes()).hexdigest()


def phase_fleet(dev, devices: str = "auto") -> dict:
    """Phase 14: the resident pool's fleet of host failure domains and
    ULFM / respawn for process ranks.  Two pool subprocesses (``--np 8
    --hosts 2``): A with the batch window open, its ``host_kill`` fault
    armed at op FLEET_KILL_OP and two ``tpud --fleet`` agents; C with
    ``mpi_ft_ulfm=0``.  14a: a session of 4 spans both domains
    (proctable hdom [0, 0, 1, 1]; stats quiet) and prints phase 13's
    solo digest; a timed run of FLEET_REPS reps; two sessions at once
    share one K3 a group.  14b: a session of 4 runs fleet_host.py, host
    1 dies at its hold step through the host_kill fault (the op count
    is checked first), the survivors shrink once and print the digest
    and card digest of a two-rank run; respawn_host(1) gives mttr_ms >
    0, a new agent registers, and a new session of 4 prints 14a's
    digest.  14c (pool C): fleet_ckpt.py's run killed at its hold step
    and replayed: exit 0, preempted, resumed at the hold step, the
    baseline digest.  14d: mpirun's ulfm and respawn policies over 4
    process ranks (ulfm_procs.py, respawn_procs.py), at once.  14e:
    halts; every agent but the killed one exits 0, and no journal is
    left.  Every sub-phase's K3 / K1 launches (the pools' metrics)
    exact.  Returns the pools' launches over their lives."""
    import tempfile

    from ompi_tpu_torch.tools.dvm import DvmClient

    class _OpClient(DvmClient):
        """A client of pool A counting the ops it sends (14b's kill
        point is an op count)."""
        sent = [0]

        def _rpc(self, msg, *a, **k):
            _OpClient.sent[0] += 1
            return super()._rpc(msg, *a, **k)

        def run(self, *a, **k):  # one op, sent without _rpc
            _OpClient.sent[0] += 1
            return super().run(*a, **k)

    t_phase = time.perf_counter()
    card = devices == "auto"
    choice = "auto" if card else "cpu"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    pa = _PoolProc(tmp, "fleet", devices, POOL_WINDOW_US, dev=dev,
                   hosts=FLEET_HOSTS,
                   mca={"ft_inject_plan": f"host_kill:{FLEET_KILL_OP}",
                        "ft_inject_victim_host": 1})
    pc = _PoolProc(tmp, "replay", devices, dev=dev, hosts=FLEET_HOSTS,
                   mca={"mpi_ft_ulfm": 0})
    agents = []
    stage = "14a pools up"
    total = {"fused_batch": 0, "stacked_reduce": 0}
    ok = False
    want1 = pool_digest(dev, POOL_SESSION, 1)
    try:
        ready = (pa.wait_ready(), pc.wait_ready())
        agents = [_Agent(tmp, pa.uri, h) for h in range(FLEET_HOSTS)]
        reg_s = [a.wait_registered() for a in agents]
        # 14a: a session across both domains
        stage = "14a session across both host domains"
        c = _OpClient(pa.uri)
        t0 = time.perf_counter()
        sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]       # 1
        cold_ms = (time.perf_counter() - t0) * 1e3
        with open(pa.uri + ".proctable.json") as f:
            hdom = [e["hdom"] for e in json.load(f) if "hdom" in e]
        st = c.stats()                                             # 2
        if hdom != [0, 0, 1, 1] or st["hosts"] != 2 or any(
                st[k] for k in ("hosts_lost", "hosts_degraded",
                                "hosts_quarantined", "hosts_rehydrating")):
            raise AssertionError(f"14a: hdom {hdom}, stats {st}")
        n0 = _pool_counts(c)                                       # 3
        r = c.run(sid, POOL_PROG, ["fleet"], timeout=POOL_T)       # 4
        dig = _pool_digest_of(r, "fleet", "14a solo")
        if dig != want1 or (POOL_SOLO and dig != POOL_SOLO[0]):
            raise AssertionError(f"14a: digest {dig}, the plain torch "
                                 f"digest {want1}, phase 13's {POOL_SOLO}")
        n1 = _pool_counts(c)                                       # 5
        _pool_check(_pool_moved(n0, n1), _pool_want(card, 2, 1),
                    "14a solo run across both domains")
        c.detach(sid)                                              # 6
        t0 = time.perf_counter()
        sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]       # 7
        warm_ms = (time.perf_counter() - t0) * 1e3
        r = c.run(sid, POOL_PROG, ["ftimed", str(FLEET_REPS), "report"],
                  timeout=POOL_T)                                  # 8
        if _pool_digest_of(r, "ftimed", "14a timed") != pool_digest(
                dev, POOL_SESSION, FLEET_REPS):
            raise AssertionError("14a timed run: digest differs")
        rep = json.loads(_pool_lines(r["stdout"], "REPORT", "ftimed")[0])
        n2 = _pool_counts(c)                                       # 9
        _pool_check(_pool_moved(n1, n2),
                    _pool_want(card, 2 * FLEET_REPS, FLEET_REPS),
                    "14a timed run")
        c.detach(sid)                                              # 10
        stage = "14a two sessions, window open"
        cs = [_OpClient(pa.uri), _OpClient(pa.uri)]
        sids = [x.attach(POOL_SESSION, timeout=POOL_T)["sid"]
                for x in cs]                                       # 12
        res = [None, None]

        def runner(i):
            res[i] = cs[i].run(sids[i], POOL_PROG, ["fpair"],
                               timeout=POOL_T)

        ths = [threading.Thread(target=runner, args=(i,)) for i in (0, 1)]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=POOL_T)
        pair_s = time.perf_counter() - t0
        if None in res:
            raise AssertionError("14a: a concurrent run never returned")
        for x, s_ in zip(cs, sids):                                # 14
            x.detach(s_)
            x.close()
        digs = [_pool_digest_of(x, "fpair", "14a pair") for x in res]
        n3 = _pool_counts(c)                                       # 17
        if digs != [want1, want1]:
            raise AssertionError(f"14a pair digests {digs}")
        _pool_check(_pool_moved(n2, n3), _pool_want(card, 2, 2, 1, 6),
                    "14a two sessions, window open (one combined K3 a "
                    "group)")
        # 14b: a host kill under ULFM
        stage = "14b two-rank run of the formula"
        t0 = time.perf_counter()
        sid = c.attach(2, timeout=POOL_T)["sid"]                   # 18
        warm2_ms = (time.perf_counter() - t0) * 1e3
        fargs = [str(FLEET_STEPS), "--device", choice, "--mib",
                 str(FLEET_MIB)]
        r2 = c.run(sid, HOST_PROG, ["two"] + fargs, timeout=POOL_T)  # 19
        n4 = _pool_counts(c)                                       # 20
        c.detach(sid)                                              # 21
        if r2.get("code") != 0:
            raise AssertionError(f"14b two-rank run: exit {r2.get('code')}"
                                 f":\n{r2.get('stderr', '')[-3000:]}")
        two = _pool_lines(r2["stdout"], "DIGEST", "two")
        two = two[0] if len(set(two)) == 1 and len(two) == 2 else None
        two_card = {x.split()[1] for x in _pool_lines(r2["stdout"], "CARD",
                                                      "two")}
        if two != fleet_host_digest(2, FLEET_STEPS) or len(two_card) != 1:
            raise AssertionError(f"14b two-rank run: {r2['stdout']}")
        _pool_check(_pool_moved(n3, n4), _pool_want(card, 0, 1),
                    "14b two-rank run (one K1: the card tensor)")
        stage = "14b host kill under ULFM"
        sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]       # 22
        hold = os.path.join(tmp, "hold14b")
        res = {}

        def killed_run():
            res["r"] = c.run(sid, HOST_PROG, ["sa"] + fargs + [
                "--hold", str(FLEET_HOLD), hold], timeout=POOL_T)  # 23

        th = threading.Thread(target=killed_run)
        th.start()
        deadline = time.monotonic() + POOL_T
        while not os.path.exists(hold):
            if not th.is_alive() or time.monotonic() > deadline:
                raise AssertionError(f"14b: fleet_host.py never reached its "
                                     f"hold step: {res}")
            time.sleep(0.005)
        if 2 + _OpClient.sent[0] != FLEET_KILL_OP - 1:
            raise AssertionError(f"14b: pool A served {2 + _OpClient.sent[0]}"
                                 f" counted ops before the kill op, not "
                                 f"{FLEET_KILL_OP - 1}")
        ck = _OpClient(pa.uri)
        st = ck.stats()                                            # 24: kill
        th.join(timeout=POOL_T)
        if th.is_alive() or st["hosts_lost"] != 1 \
                or st["hosts_rehydrating"] != 1:
            raise AssertionError(f"14b: stats at the kill op {st}")
        r = res["r"]
        if r.get("code") != 0:
            raise AssertionError(f"14b: exit {r.get('code')}:\n"
                                 f"{r.get('stderr', '')[-3000:]}")
        shrinks = sorted(_pool_lines(r["stdout"], "SHRINKS", "sa"))
        digs = _pool_lines(r["stdout"], "DIGEST", "sa")
        cards = {x.split()[1] for x in _pool_lines(r["stdout"], "CARD",
                                                   "sa")}
        if shrinks != ["0 1", "1 1"] or digs != [two, two] \
                or cards != two_card:
            raise AssertionError(f"14b survivors: {r['stdout']}")
        if agents[1].p.wait(timeout=POOL_T) != -9:
            raise AssertionError("14b: host 1's agent was not SIGKILLed")
        n5 = _pool_counts(ck)
        _pool_check(_pool_moved(n4, n5), _pool_want(card, 0, 1),
                    "14b killed run (one K1 on the survivors' comm of 2)")
        ev = ck.metrics(events=512, prometheus=False)["events"]
        lost_ts = [e["ts"] for e in ev if e["name"] == "host_lost"]
        shrink_ts = [e["ts"] for e in ev if e["name"] == "ulfm_shrink"]
        if len(lost_ts) != 1 or len(shrink_ts) != 2:
            raise AssertionError(f"14b: {len(lost_ts)} host_lost and "
                                 f"{len(shrink_ts)} ulfm_shrink events")
        shrink_ms = (max(shrink_ts) - lost_ts[0]) * 1e3
        mttr = ck.respawn_host(1)["mttr_ms"]
        agents.append(_Agent(tmp, pa.uri, 1, 1))
        reg_s.append(agents[-1].wait_registered())
        st = ck.stats()
        if mttr <= 0 or st["hosts_rehydrating"] or st["hosts_lost"]:
            raise AssertionError(f"14b respawn: mttr {mttr}, stats {st}")
        c.detach(sid)
        stage = "14b a new session after the respawn"
        sid = c.attach(POOL_SESSION, timeout=POOL_T)["sid"]
        r = c.run(sid, POOL_PROG, ["fleet"], timeout=POOL_T)
        if _pool_digest_of(r, "fleet", "14b after respawn") != want1:
            raise AssertionError("14b: the session after the respawn "
                                 "printed another digest")
        n6 = _pool_counts(c)
        _pool_check(_pool_moved(n5, n6), _pool_want(card, 2, 1),
                    "14b the session after the respawn")
        c.detach(sid)
        c.close()
        ck.close()
        # 14c: the replay arm on pool C
        stage = "14c replay arm"
        cargs = [str(FLEET_CKPT_STEPS), "--device", choice]
        with DvmClient(pc.uri) as c3, DvmClient(pc.uri) as c4:
            m0 = _pool_counts(c3)
            sid = c3.attach(2, timeout=POOL_T)["sid"]
            rb = c3.run(sid, CKPT_PROG,
                        ["hb", os.path.join(tmp, "store_a")] + cargs,
                        timeout=POOL_T)
            c3.detach(sid)
            base = _pool_digest_of(rb, "hb", "14c baseline")
            if base != fleet_host_digest(2, FLEET_CKPT_STEPS):
                raise AssertionError(f"14c baseline digest {base}")
            sid = c3.attach(2, timeout=POOL_T)["sid"]
            hold = os.path.join(tmp, "hold14c")
            res = {}

            def replayed():
                t0 = time.perf_counter()
                res["r"] = c3.run(sid, CKPT_PROG, [
                    "hb", os.path.join(tmp, "store_v")] + cargs + [
                    "--hold", str(FLEET_CKPT_HOLD), hold], timeout=POOL_T)
                res["s"] = time.perf_counter() - t0

            th = threading.Thread(target=replayed)
            th.start()
            deadline = time.monotonic() + POOL_T
            while not os.path.exists(hold):
                if not th.is_alive() or time.monotonic() > deadline:
                    raise AssertionError(f"14c: never reached the hold "
                                         f"step: {res}")
                time.sleep(0.005)
            c4.kill_host(1)
            mttr_c = c4.respawn_host(1)["mttr_ms"]
            th.join(timeout=POOL_T)
            r = res["r"]
            if th.is_alive() or r.get("code") != 0 \
                    or r.get("preempted", 0) < 1 \
                    or _pool_lines(r["stdout"], "STEPS", "hb") != [
                        str(FLEET_CKPT_HOLD)] \
                    or _pool_digest_of(r, "hb", "14c replay") != base \
                    or _pool_lines(r["stdout"], "CARD", "hb") != \
                    _pool_lines(rb["stdout"], "CARD", "hb"):
                raise AssertionError(f"14c replay: {r}")
            c3.detach(sid)
            m1 = _pool_counts(c3)
            _pool_check(_pool_moved(m0, m1), _pool_want(card, 0, 2),
                        "14c (one K1 a completed run: the card digest)")
        # 14d: ULFM and respawn for process ranks, both jobs at once
        stage = "14d process ranks"
        jobs = {}
        kill = [("ft_inject_plan", "rank_kill"),
                ("ft_inject_victim_rank", "1"), ("ft_inject_after", "0.8")]
        specs = {
            "ulfm": ([("errmgr_base_policy", "ulfm")] + kill,
                     [os.path.join("ompi_tpu_torch", "examples",
                                   "ulfm_procs.py"), "--device", choice,
                      "--mib", str(FLEET_MIB)]),
            "respawn": ([("errmgr_base_policy", "respawn"),
                         ("cr_buddy_degree", "1")] + kill,
                        [os.path.join("ompi_tpu_torch", "examples",
                                      "respawn_procs.py"), "--device",
                         choice])}

        def job(name):
            mca, args = specs[name]
            jobs[name] = mpirun_job(4, None, args, mca=mca,
                                    extra=("--devices", devices))

        ths = [threading.Thread(target=job, args=(n,)) for n in specs]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=PROC_JOB_S + 60)
        for name in specs:
            if name not in jobs or jobs[name][0] != 0:
                raise AssertionError(f"14d {name}: {jobs.get(name)}")
        out = jobs["ulfm"][1]
        lines = [x for x in out.splitlines() if x.startswith("rank=")]
        cards = {x.split()[2] for x in out.splitlines()
                 if x.startswith("CARD ")}
        if len(lines) != 3 or not all("size=3" in x and "sum=6.0" in x
                                      for x in lines) or len(cards) != 1:
            raise AssertionError(f"14d ulfm: {out}")
        out = jobs["respawn"][1]
        lines = [x for x in out.splitlines() if x.startswith("rank=")]
        cards = {x.split()[2] for x in out.splitlines()
                 if x.startswith("CARD ")}
        if len(lines) != 4 or not all("size=4" in x for x in lines) \
                or len({x.split("digest=")[1] for x in lines}) != 1 \
                or sum("joined=1" in x for x in lines) != 1 \
                or len(cards) != 1:
            raise AssertionError(f"14d respawn: {out}")
        # 14e: halts, agents, journals
        stage = "14e halts"
        for pp in (pa, pc):
            rc = pp.halt()
            if rc != 0:
                raise AssertionError(f"14e: pool {pp.uri} exited {rc}")
        codes = [a.p.wait(timeout=POOL_T) for a in agents]
        if codes != [0, -9, 0]:
            raise AssertionError(f"14e: agents exited {codes} (host 1's "
                                 f"first agent was killed with its host)")
        left = [f for f in os.listdir(tmp) if ".journal" in f]
        if left:
            raise AssertionError(f"14e: journals left on disk: {left}")
        for n in (n6, m1):
            total["fused_batch"] += n.get("fused_batch", 0)
            total["stacked_reduce"] += n.get("stacked_reduce", 0)
        ok = True
    finally:
        if not ok:
            log(f"[fleet] FAILED in {stage}")
            for pp in (pa, pc):
                log(f"[fleet] stderr tail of {pp.uri}:\n"
                    f"{_tail40(pp.tail())}")
            for a in agents:
                log(f"[fleet] stderr tail of {a.err_path}:\n"
                    f"{_tail40(a.text())}")
        pa.kill()
        pc.kill()
        for a in agents:
            a.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[fleet] {card_line()}")
    log(f"[fleet] 14a pools up in {ready[0]:.2f} / {ready[1]:.2f} s (--np "
        f"{POOL_NP} --hosts {FLEET_HOSTS} --devices {devices}, started "
        f"together); agents registered {[round(x, 3) for x in reg_s]} s "
        f"after their start; attach of {POOL_SESSION} ranks across both "
        f"domains: cold {cold_ms:.1f} ms, warm {warm_ms:.1f} ms (of 2: "
        f"{warm2_ms:.1f} ms); the timed run of {FLEET_REPS} reps "
        f"{rep['us_per_coll']:.1f} us a collective inside the session; "
        f"two sessions at once {pair_s * 1e3:.1f} ms with the window open; "
        f"DIGEST {want1[:16]}... = the plain torch digest"
        f"{' = phase 13' if POOL_SOLO else ''}")
    log(f"[fleet] 14a launches (pool metrics): solo "
        f"{_pool_moved(n0, n1)}, timed {_pool_moved(n1, n2)}, pair "
        f"{_pool_moved(n2, n3)}")
    log(f"[fleet] 14b host 1 killed at pool op {FLEET_KILL_OP} "
        f"(fleet_host.py step {FLEET_HOLD}): survivors 0 and 1 shrank once, "
        f"{shrink_ms:.1f} ms from the host_lost record to the last shrink; "
        f"digest = the two-rank run's {two[:16]}..., card digests equal; "
        f"launches two-rank {_pool_moved(n3, n4)}, killed run "
        f"{_pool_moved(n4, n5)}, after respawn {_pool_moved(n5, n6)}; "
        f"mttr_ms {mttr}")
    log(f"[fleet] 14c replay arm: exit 0, preempted "
        f"{r.get('preempted')}, resumed at step {FLEET_CKPT_HOLD}, the "
        f"baseline digest; run wall {res['s'] * 1e3:.1f} ms, mttr_ms "
        f"{mttr_c}; launches {_pool_moved(m0, m1)}")
    log(f"[fleet] 14d process ranks: ulfm job {jobs['ulfm'][3]:.1f} s, "
        f"respawn job {jobs['respawn'][3]:.1f} s (run at once), both exit "
        f"0; 14e pools and agents halted, no journal left; pools' "
        f"launches over their lives {total}; phase 14 {secs:.1f} s")
    return total


CKPT_MIB = 8          # 15a: the float32 card tensor a rank checkpoints
CKPT_STEPS = 6        # 15a: allreduce_arr + checkpoint steps
CKPT_KILL_STEP = 3    # 15c: sim1's daemon dies after this step's line
CKPT_JOB_S = 120      # 15c: mpirun --timeout of the live-recovery job


def ckpt_input(rank: int, step: int, dev, n: int) -> torch.Tensor:
    """15a's step input: small integers in float32, so every sum is
    exact in any order."""
    return ((torch.arange(n, device=dev) % 97) + 3 * rank + step).float()


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def ckpt_program(dev, store: str, n: int):
    """15a's rank program: CKPT_STEPS steps of ``t = t +
    allreduce_arr(input)`` then a tiered checkpoint of {"step", "t",
    "small"}; right after the last checkpoint the tensor is cloned and
    overwritten in place, its epoch's drain still pending; flush.
    Returns (shards pending at the overwrite, the pre-overwrite digest,
    enqueue seconds, the flush's seconds)."""
    import numpy as np
    from ompi_tpu_torch.cr import ckpt
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        t = torch.zeros(n, dtype=torch.float32, device=dev)
        small = np.arange(16, dtype=np.int64) * (comm.rank + 1)
        enq = []
        for step in range(CKPT_STEPS):
            t = t + comm.allreduce_arr(ckpt_input(comm.rank, step, dev, n),
                                       SUM)
            t0 = time.perf_counter()
            ckpt.checkpoint(comm, {"step": step + 1, "t": t,
                                   "small": small}, store_dir=store)
            enq.append(time.perf_counter() - t0)
        pending = len(ckpt._engine(comm.state).pending.queue)
        keep = t.clone()     # stream-ordered after the snapshot's copy
        t.fill_(-1.0)        # the application writes on, in place
        t0 = time.perf_counter()
        ckpt.flush(comm)
        commit = time.perf_counter() - t0
        return pending, _sha(keep), enq, commit
    return fn


def ckpt_restore_program(store: str):
    def fn(comm):
        from ompi_tpu_torch.cr import ckpt
        out = ckpt.restore(comm, store_dir=store)
        return (out["step"], str(out["t"].device), _sha(out["t"]),
                out["small"].tolist())
    return fn


def ckpt_torn_program(dev, store: str, n: int):
    """15b: one more epoch, written under io_partial (a truncated shard
    a rank: committed, but its CRCs fail at restore)."""
    def fn(comm):
        import numpy as np
        from ompi_tpu_torch.cr import ckpt
        ckpt.checkpoint(comm, {"step": 99,
                               "t": ckpt_input(comm.rank, 99, dev, n),
                               "small": np.zeros(16, dtype=np.int64)},
                        store_dir=store)
        return ckpt.flush(comm)
    return fn


def phase_ckpt_engine(dev) -> dict:
    """15a and 15b (see the module docstring).  Returns 15a's
    launches."""
    import tempfile
    from ompi_tpu_torch import obs
    from ompi_tpu_torch.cr import ckpt
    n = CKPT_MIB * MIB // 4
    hbm = lambda r: dev  # noqa: E731
    store = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        rec = obs.recorder()
        seen, b0 = rec.recorded, ckpt._pv_bytes.read()
        res, launches = _ft_launch_run(ckpt_program(dev, store, n), NRANKS,
                                       hbm)
        drains = [e["args"]["us"] for e in rec.snapshot(
            last=rec.recorded - seen) if e["name"] == "req_drain"]
        written = ckpt._pv_bytes.read() - b0
        if launches != {**{k: 0 for k in launches},
                        "stacked_reduce": CKPT_STEPS}:
            raise AssertionError(f"15a launches {_ft_counted(launches)}, "
                                 f"expected stacked_reduce {CKPT_STEPS}")
        if any(p < 1 for p, _, _, _ in res):
            raise AssertionError(f"15a: the overwrite came after the "
                                 f"drain ({[p for p, _, _, _ in res]} "
                                 "shards pending)")
        want = res[0][1]
        plain = torch.zeros(n, dtype=torch.float32, device=dev)
        for step in range(CKPT_STEPS):
            plain = plain + sum(ckpt_input(r, step, dev, n)
                                for r in range(NRANKS))
        if any(r[1] != want for r in res) or want != _sha(plain):
            raise AssertionError("15a: the checkpointed tensor differs "
                                 "from plain torch's sum")
        back = _ft_launch_run(ckpt_restore_program(store), NRANKS, hbm)[0]
        for r, (step, where, dig, small) in enumerate(back):
            if (step, where, dig) != (CKPT_STEPS, str(dev), res[r][1]) \
                    or small != [k * (r + 1) for k in range(16)]:
                raise AssertionError(f"15a restore, rank {r}: step {step} "
                                     f"on {where}, digest {dig[:16]}...")
        if len(drains) != NRANKS * CKPT_STEPS:
            raise AssertionError(f"15a: {len(drains)} req_drain events")
        enq = [t for r in res for t in r[2]]
        card = card_line()
        log(f"[ckpt] 15a 8 ranks on {dev}, {CKPT_MIB} MiB f32 a rank, "
            f"{CKPT_STEPS} steps: the tensor overwritten in place with "
            f"{min(p for p, _, _, _ in res)}-{max(p for p, _, _, _ in res)} "
            f"shards of its epoch still draining; restored in a fresh "
            f"world onto {dev}, every rank's digest the pre-overwrite one "
            f"(= plain torch's sum, {want[:16]}...); launches "
            f"{_ft_counted(launches)}, exact")
        log(f"[ckpt] 15a enqueue {sum(enq) / len(enq) * 1e3:.3f} ms mean, "
            f"{max(enq) * 1e3:.3f} ms max (app-visible, a checkpoint "
            f"call); drain {sorted(drains)[len(drains) // 2] / 1e3:.3f} ms "
            f"median, {max(drains) / 1e3:.3f} ms max (req_drain, enqueue to "
            f"the last shard written, a rank an epoch); commit (flush) "
            f"{max(r[3] for r in res) * 1e3:.3f} ms (slowest rank); "
            f"{written} bytes written in {CKPT_STEPS} epochs [{card}]")
        # 15b: a torn epoch on top falls back to 15a's
        fb0 = ckpt._pv_crc_fb.read()
        with _knobs(ft_inject_plan="io_partial:1.0", ft_inject_skip=0):
            torn = _ft_launch_run(ckpt_torn_program(dev, store, n), NRANKS,
                                  hbm)[0]
        if torn != [CKPT_STEPS] * NRANKS:
            raise AssertionError(f"15b: the torn epoch committed as {torn}")
        back = _ft_launch_run(ckpt_restore_program(store), NRANKS, hbm)[0]
        if [b[:3] for b in back] != [(CKPT_STEPS, str(dev), r[1])
                                     for r in res] \
                or ckpt._pv_crc_fb.read() - fb0 != NRANKS:
            raise AssertionError(f"15b: restored {[b[:2] for b in back]}, "
                                 f"crc fallbacks "
                                 f"{ckpt._pv_crc_fb.read() - fb0}")
        log(f"[ckpt] 15b epoch {CKPT_STEPS} written under io_partial "
            f"(committed, a truncated shard a rank): the restore fell back "
            f"to epoch {CKPT_STEPS - 1}, 15a's digest, {NRANKS} CRC "
            f"fallbacks")
        return launches
    finally:
        shutil.rmtree(store, ignore_errors=True)


def phase_ckpt_recover(dev, devices: str = "auto") -> None:
    """15c (see the module docstring).  sim1's daemon is found through
    the launcher's own records: ``--verbose state`` names each daemon's
    pid as it registers."""
    import signal
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    store = tempfile.mkdtemp(prefix="chip-smoke-ft-")
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun", "-np", "3",
           "--simulate-nodes", "3x1", "--ranks-per-proc", "1",
           "--ckpt-dir", store, "--timeout", str(CKPT_JOB_S),
           "--verbose", "state", "--mca", "errmgr_base_policy", "recover",
           os.path.join("ompi_tpu_torch", "examples", "ft_prog.py"),
           "--device", devices]
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    errs, outs, stamp = [], [], {}

    def read_err():
        for line in p.stderr:
            errs.append(line)
            if "re-routing ranks" in line:
                stamp.setdefault("route", time.perf_counter())

    reader = threading.Thread(target=read_err, daemon=True)
    reader.start()
    try:
        for line in p.stdout:
            outs.append(line)
            if f"ft: step {CKPT_KILL_STEP} done" in line:
                break
        pids = [m.group(1) for m in (
            re.search(r"daemon sim1 \(node \d+\) registered, pid (\d+)",
                      e) for e in list(errs)) if m]
        if len(pids) != 1:
            raise AssertionError(f"15c: sim1's daemon pid {pids}:\n"
                                 f"{''.join(errs)[-3000:]}")
        os.kill(int(pids[0]), signal.SIGKILL)
        stamp["kill"] = time.perf_counter()
        outs += p.stdout.readlines()
        p.wait(timeout=CKPT_JOB_S + 60)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        raise AssertionError(f"15c outlived its timeout:\n"
                             f"{''.join(errs)[-3000:]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        shutil.rmtree(store, ignore_errors=True)
    end = time.perf_counter()
    reader.join(timeout=30)
    out, err = "".join(outs), "".join(errs)
    want = [330.0] * 4
    plain = _sha(torch.full((4,), 330.0, dtype=torch.float64, device=dev))
    node = re.search(r"rank 1 on node (\w+)", out)
    cards = [ln.split()[1] for ln in out.splitlines()
             if ln.startswith("CARD ")]
    final = [ln for ln in out.splitlines() if ln.startswith("final ")]
    if p.returncode != 0 \
            or "recovering in place: re-routing ranks [1]" not in err \
            or "relaunching from snapshot" in err \
            or not node or node.group(1) == "sim1" \
            or final != [f"final step=10 acc={want}"] \
            or cards != [plain] or "route" not in stamp \
            or any(f"rank {r}: world ok after recovery (3 ranks)" not in out
                   for r in range(3)):
        raise AssertionError(f"15c: exit {p.returncode}\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    log(f"[ckpt] 15c mpirun -np 3 --simulate-nodes 3x1 recover policy, "
        f"ft_prog.py --device {devices}: sim1's daemon killed after step "
        f"{CKPT_KILL_STEP}; rank 1 re-routed to {node.group(1)}, every rank "
        f"met in a Barrier + Allreduce after the epoch reset; {final[0]}, "
        f"card digest = plain torch's {plain[:16]}...; kill to re-route "
        f"{stamp['route'] - stamp['kill']:.3f} s, kill to the job's end "
        f"{end - stamp['kill']:.3f} s, job {end - t0:.1f} s [{card_line()}]")


def phase_ckpt(dev, devices: str = "auto") -> dict:
    """Phase 15: 15a-15b (phase_ckpt_engine), 15c (phase_ckpt_recover).
    Returns 15a's launches (they join the kernels line)."""
    t0 = time.perf_counter()
    launches = phase_ckpt_engine(dev)
    phase_ckpt_recover(dev, devices)
    log(f"[ckpt] phase 15 {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 16. the pml's protocols: monitoring, vprotocol's sender log, Bsend
# ---------------------------------------------------------------------------

PROTO_N = 20          # 16a: monitored allreduce_arr ops
PROTO_MIB = 8         # 16a's and 16b's float32 card tensor a rank
PROTO_TIMED = 20      # 16a: chained ops a timed run (on, off, off, on)
PROTO_PULL_MIB = 48   # 16c: the send_arr through the chunked pull
PROTO_ITERS = 20      # 16d: device_allreduce.py's chained ops
VPROTO_PROG = os.path.join("ompi_tpu_torch", "examples", "vproto_prog.py")
VBIG_PROG = os.path.join("ompi_tpu_torch", "examples", "vproto_big_prog.py")
DEVAR_PROG = os.path.join("ompi_tpu_torch", "examples",
                          "device_allreduce.py")


def proto_values(n: int, dev) -> torch.Tensor:
    """vproto_prog.py's ``card_values``: small integers in float32."""
    i = torch.arange(n, dtype=torch.int64, device=dev)
    return ((i * 2654435761) % 1000003).to(torch.float32)


def proto_monitored(dev, n: int):
    """16a's rank program: PROTO_N allreduce_arr SUM of the rank's
    8 MiB float32 input, its monitoring rows read just before and just
    after; returns (the rows it added, the last output)."""
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        x = rank_elems(comm.rank, n, torch.float32, dev, 60)
        torch.cuda.synchronize()
        before = comm.state.pml.matrix_rows()
        for _ in range(PROTO_N):
            y = comm.allreduce_arr(x, SUM)
        after = comm.state.pml.matrix_rows()
        torch.cuda.synchronize()
        return {k: [b - a for a, b in zip(before[k], after[k])]
                for k in after}, y
    return fn


def phase_proto_monitoring(dev) -> dict:
    """16a (see the module docstring).  Returns its launches."""
    from ompi_tpu_torch.pml import monitoring
    n = PROTO_MIB * MIB // 4
    hbm = lambda r: dev  # noqa: E731
    with _knobs(pml_monitoring_enable=1):
        res, launches = _ft_launch_run(proto_monitored(dev, n), NRANKS, hbm)
    want = {**{k: 0 for k in launches}, "stacked_reduce": PROTO_N}
    if launches != want:
        raise AssertionError(f"16a launches {_ft_counted(launches)}, "
                             f"expected stacked_reduce {PROTO_N}")
    ref = _sum_ref(range(NRANKS), n, dev, 60)
    err = max(_in_band(y, ref, NRANKS, f"16a rank {r}")
              for r, (_, y) in enumerate(res))
    for r, (rows, _) in enumerate(res):
        other = [0 if p == r else 1 for p in range(NRANKS)]
        if rows["sent_filtered_msgs"] != [PROTO_N * o for o in other] or \
                rows["sent_filtered_bytes"] != [
                    PROTO_N * 4 * n * o for o in other] or \
                any(rows[k] != [0] * NRANKS for k in (
                    "sent_msgs", "sent_bytes", "recv_msgs", "recv_bytes")):
            raise AssertionError(f"16a rank {r}'s monitoring rows {rows}")
    # host µs an op, monitoring on and off in turns (A B B A)
    us = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        with _knobs(pml_monitoring_enable=int(mode == "on")):
            def fn(comm, _inner=chained_allreduce(dev, 4 * n, PROTO_TIMED)):
                mon = isinstance(comm.state.pml, monitoring.MonitoringPml)
                if mon != (mode == "on"):
                    raise AssertionError(f"16a: monitoring {mode} but the "
                                         f"pml is {type(comm.state.pml)}")
                return _inner(comm)
            dts, _ = _ft_launch_run(fn, NRANKS, hbm)
        us[mode].append(max(dts) / PROTO_TIMED * 1e6)
    card = card_line()
    log(f"[proto] 16a 8 ranks on {dev}, {PROTO_MIB} MiB f32 allreduce_arr "
        f"SUM x {PROTO_N} with pml_monitoring_enable: every rank's "
        f"sent_filtered_msgs {PROTO_N} and sent_filtered_bytes "
        f"{PROTO_N * 4 * n} to each of the 7 others, user rows 0; launches "
        f"{_ft_counted(launches)}, exact; max error {err:.3e} (in the "
        f"float SUM band)")
    log(f"[proto] 16a host us an op ({PROTO_TIMED} chained ops, slowest "
        f"rank, A B B A): monitoring on {us['on'][0]:.1f} / "
        f"{us['on'][1]:.1f}, off {us['off'][0]:.1f} / {us['off'][1]:.1f}; "
        f"mean on {sum(us['on']) / 2:.1f}, off {sum(us['off']) / 2:.1f} "
        f"[{card}]")
    return launches


def proto_vlog_program(dev, n: int, store: str):
    """16b's rank program (see the module docstring).  Rank 0 returns
    (the bytes the measured send_arr added to log_bytes, whether its
    snapshot's stage is pinned, the first (cold) send_arr's seconds,
    the measured (warm) one's, checkpoint_local's and replay's); rank
    1 (its received tensor's device, its digest)."""
    def fn(comm):
        from ompi_tpu_torch import cr
        from ompi_tpu_torch.pml import vprotocol
        v = vprotocol.find(comm.state.pml)
        base = v._base
        if comm.rank == 0:
            # a first send_arr, received as usual: the cold one (the
            # log's first pinned stage, the process's first events)
            x = proto_values(n, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comm.send_arr(x, 1, tag=15)
            cold = time.perf_counter() - t0
            comm.Barrier()          # rank 1 received it
            before = v.log_bytes
            t0 = time.perf_counter()
            comm.send_arr(x, 1, tag=16)
            t1 = time.perf_counter()
            logged = v.log_bytes - before
            snap = [e[4] for es in v.log.values() for e in es
                    if e[3] == "obj"][-1]
            comm.Barrier()          # the message reached rank 1
            cr.checkpoint_local(comm, {"phase": 1}, store_dir=store)
            t2 = time.perf_counter()
            comm.Barrier()          # rank 1 has cut
            x.fill_(-1.0)           # the sender writes on
            t3 = time.perf_counter()
            v.replay()
            t4 = time.perf_counter()
            comm.Barrier()
            return (logged, pinned(snap.stage), cold, t1 - t0, t2 - t1,
                    t4 - t3)
        if _sha(comm.recv_arr(0, tag=15)) != _sha(proto_values(n, dev)):
            raise AssertionError("16b: the first send_arr's bytes differ")
        comm.Barrier()
        # parked in a Barrier while rank 0 sends (a spinning wait here
        # would hold the GIL against the timed send_arr); the message
        # precedes rank 0's Barrier message on the channel
        comm.Barrier()

        def mine():
            return [m for m in base._unexpected.get(comm.cid, [])
                    if m.tag == 16 and m.src == 0]
        while not mine():
            comm.state.progress.progress()
        # the snapshot is taken before the receive: the message is
        # in this rank's unexpected queue, so it is a replay want
        cr.checkpoint_local(comm, {"phase": 1}, store_dir=store)
        # the restart's cut, simulated: drop the unconsumed message
        drop = mine()
        base._unexpected[comm.cid] = [
            m for m in base._unexpected[comm.cid] if m not in drop]
        v.cr_restore_vlog(v.cr_capture_vlog())
        base._replay_want = {(comm.cid, m.src, m.seq) for m in drop}
        comm.Barrier()
        comm.Barrier()
        y = comm.recv_arr(0, tag=16)
        return str(y.device), _sha(y)
    return fn


def phase_proto_vlog(dev) -> dict:
    """16b (see the module docstring).  Returns its launches (none)."""
    import tempfile
    n = PROTO_MIB * MIB // 4
    store = tempfile.mkdtemp(prefix="chip-smoke-vlog-")
    try:
        with _knobs(pml_vprotocol="pessimist"):
            res, launches = _ft_launch_run(proto_vlog_program(dev, n, store),
                                           2, lambda r: dev)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    (logged, pinned, cold_s, send_s, ckpt_s, replay_s), (where, got) = res
    plain = _sha(proto_values(n, dev))
    if (where, got) != (str(dev), plain) or pinned != (dev.type == "cuda") \
            or logged != 4 * n or any(launches.values()):
        raise AssertionError(f"16b: received on {where}, digest {got[:16]} "
                             f"(plain {plain[:16]}), pinned {pinned}, "
                             f"log_bytes {logged}, launches "
                             f"{_ft_counted(launches)}")
    log(f"[proto] 16b 2 ranks on {dev}, pml_vprotocol pessimist: rank 0 "
        f"send_arr {PROTO_MIB} MiB f32 (log_bytes {logged}, its snapshot's "
        f"stage pinned: {pinned}), checkpoint_local; rank 1 checkpoint_local before "
        f"receiving, the cut simulated; rank 0 overwrote its source and "
        f"replayed: rank 1's tensor on {where}, digest = plain torch's "
        f"{plain[:16]}...; send_arr {send_s * 1e3:.3f} ms (the first, "
        f"cold: {cold_s * 1e3:.3f} ms), checkpoint_local "
        f"{ckpt_s * 1e3:.3f} ms, replay {replay_s * 1e3:.3f} ms; no launch "
        f"[{card_line()}]")
    return launches


def phase_proto_jobs(dev, devices: str = "auto") -> None:
    """16c and 16d (see the module docstring)."""
    import tempfile
    root = tempfile.mkdtemp(prefix="chip-smoke-proto-")
    try:
        store = os.path.join(root, "store")
        mca = (("pml_vprotocol", "pessimist"),)
        args = (VPROTO_PROG, "--device", devices, "--mib",
                str(PROTO_PULL_MIB))
        # the host-only 12 MiB replay over shm runs beside the crash
        # and restart jobs (its own job, session and KV server)
        big = {}

        def run_big():
            try:
                big["r"] = mpirun_job(2, None, (VBIG_PROG,), mca=mca)
            except BaseException as e:  # noqa: BLE001 (raised below)
                big["e"] = e
        beside = threading.Thread(target=run_big)
        beside.start()
        os.environ["VPROTO_CRASH"] = "1"
        try:
            rc1, out1, err1, s1 = mpirun_job(
                2, None, args, mca=mca, extra=("--ckpt-dir", store))
        finally:
            del os.environ["VPROTO_CRASH"]
        rc2, out2, err2, s2 = mpirun_job(2, None, args, mca=mca,
                                         extra=("--restart", store))
        # the program's --mib is in MiB whatever this script's MIB is
        plain = _sha(proto_values(PROTO_PULL_MIB << 18, dev))
        if rc1 == 0 or "vproto ok" in out1 or rc2 != 0 \
                or "vproto ok" not in out2 \
                or f"CARD {plain}" not in out2:
            raise AssertionError(f"16c: crash run exit {rc1}, restart exit "
                                 f"{rc2}\n{out2[-1500:]}\n{err1[-1500:]}\n"
                                 f"{err2[-2000:]}")
        beside.join()
        if "e" in big:
            raise big["e"]
        rc3, out3, err3, s3 = big["r"]
        if rc3 != 0 or "vproto big ok" not in out3:
            raise AssertionError(f"16c big: exit {rc3}\n{err3[-2000:]}")
        log(f"[proto] 16c mpirun -np 2 vproto_prog.py --device {devices} "
            f"--mib {PROTO_PULL_MIB}: rank 1 crashed after both snapshots "
            f"(exit {rc1}, {s1:.1f} s); --restart exit 0 in {s2:.1f} s, the "
            f"{PROTO_PULL_MIB} MiB chunked pull replayed from the lenient "
            f"capture, card digest = plain torch's {plain[:16]}...; "
            f"vproto_big_prog.py over shm, beside them: vproto big ok "
            f"({s3:.1f} s)")
        # 16d: the finalize-time traffic matrices of a monitored job
        prefix = os.path.join(root, "mon")
        nbytes = PROTO_MIB * MIB
        rc4, out4, err4, s4 = mpirun_job(
            2, "all", (DEVAR_PROG, "--bytes", str(nbytes), "--iters",
                       str(PROTO_ITERS)), devices=devices,
            mca=(("pml_monitoring_enable", 1),
                 ("pml_monitoring_dump_path", prefix)))
        # offloaded: one allreduce_arr + PROTO_ITERS chained ones, the
        # deposit's bytes to the peer each; on the pml: the program's
        # two host Allreduce of one float64 (8 bytes each) and its
        # three Barriers (0 bytes)
        want = (1 + PROTO_ITERS) * nbytes + 2 * 8
        rows = [json.loads(ln) for ln in out4.splitlines()
                if ln.startswith("{")]

        def mat(name):
            with open(f"{prefix}{name}.mat") as fh:
                return [[float(v) for v in ln.split()] for ln in fh]
        profs = []
        for r in range(2):
            with open(f"{prefix}_filtered.{r}.prof") as fh:
                profs.append(fh.read().split())
        if rc4 != 0 or len(rows) != 1 or \
                (devices == "auto" and rows[0]["k1_total"] !=
                 1 + PROTO_ITERS) or \
                profs != [["0", "1", str(PROTO_ITERS + 6), str(want)],
                          ["1", "0", str(PROTO_ITERS + 6), str(want)]] or \
                mat("_filtered_size") != [[0.0, float(f"{want:g}")],
                                          [float(f"{want:g}"), 0.0]] or \
                mat("_size") != []:
            raise AssertionError(f"16d: exit {rc4}, {rows}, {profs}\n"
                                 f"{err4[-2000:]}")
        log(f"[proto] 16d mpirun -np 2 --ranks-per-proc all "
            f"device_allreduce.py --bytes {nbytes} --iters {PROTO_ITERS} "
            f"with pml_monitoring_dump_path: mon_filtered_size.mat "
            f"[[0, {want:g}], [{want:g}, 0]] = {1 + PROTO_ITERS} offloaded "
            f"deposits of {nbytes} B + 16 B of host Allreduce, the .prof "
            f"lines exact ({want}); user matrices empty; K1 "
            f"{rows[0]['k1_total']}; {rows[0]['us_per_op']:.1f} us an op "
            f"monitored ({s4:.1f} s job)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_proto(dev, devices: str = "auto") -> dict:
    """Phase 16: 16a (phase_proto_monitoring), 16b (phase_proto_vlog),
    16c-16d (phase_proto_jobs).  Returns 16a's launches (they join the
    kernels line)."""
    t0 = time.perf_counter()
    launches = phase_proto_monitoring(dev)
    phase_proto_vlog(dev)
    phase_proto_jobs(dev, devices)
    log(f"[proto] phase 16 {time.perf_counter() - t0:.1f} s")
    return launches


INTER_STEPS = 20       # 17a: training steps of the interleave
INTER_MIB = 8          # 17a/17b/17c: the allreduce_arr's float32 MiB
INTER_AG_MIB = 1       # 17a: the allgather_arr's float32 MiB a rank
INTER_BCAST = 64       # 17a: int64 elements of the host Bcast
INTER_MERGED_OPS = 2   # 17b: allreduce_arr ops on the merged comm
INTER_REPS = (200, 5)  # 17a: timed host Allreduce ops of 8 B, of 8 MiB
SEG_REPS = 10          # 17d: timed host Allreduce ops a job
SEG_NP = 4             # 17d: process ranks
RA_TOKENS, RA_DIM = 2048, 128  # 17e: tokens a rank, head width
SPAWN_PROG = os.path.join("ompi_tpu_torch", "examples", "spawn_parent.py")
SEG_PROG = os.path.join("ompi_tpu_torch", "examples", "collseg_prog.py")
HALO_PROG = os.path.join("ompi_tpu_torch", "examples", "halo_stencil.py")


def inter_step_program(dev, n: int, nag: int):
    """17a's rank program: INTER_STEPS steps of allreduce_arr (K1), a
    host Allreduce of the loss (one float64) and a host Bcast of 64
    int64 through sm, allgather_arr (K2) and a Barrier.  Returns (the
    sm provider of allreduce, step 0's and the last step's K1 output,
    the last K2 output, every step's loss sum and bcast)."""
    import numpy as np
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        x = rank_elems(comm.rank, n, torch.float32, dev, 70)
        a = rank_elems(comm.rank, nag, torch.float32, dev, 71)
        losses, bcasts, first = [], [], None
        for s in range(INTER_STEPS):
            y = comm.allreduce_arr(x, SUM)
            if first is None:
                first = y
            g = np.random.default_rng(SEED + 97 * s + comm.rank)
            tot = np.empty(1)
            comm.Allreduce(np.array([g.standard_normal()]), tot, SUM)
            b = g.integers(0, 1 << 40, INTER_BCAST) if comm.rank == 0 \
                else np.zeros(INTER_BCAST, np.int64)
            comm.Bcast(b, root=0)
            z = comm.allgather_arr(a)
            comm.Barrier()
            losses.append(tot)
            bcasts.append(b)
        _sync(dev)
        return comm.coll.providers["allreduce"], first, y, z, losses, bcasts
    return fn


def inter_host_timed(nbytes: int, reps: int):
    """A rank program: ``reps`` host Allreduce SUM of ``nbytes`` (one
    float64 at 8 B, else float32) from a Barrier; returns (the
    allreduce provider, seconds)."""
    import numpy as np
    from ompi_tpu_torch.op.op import SUM

    def fn(comm):
        x = np.full(1, comm.rank + 0.5) if nbytes == 8 else \
            np.full(nbytes // 4, comm.rank + 0.5, np.float32)
        r = np.empty_like(x)
        comm.Allreduce(x, r, SUM)
        comm.Barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            comm.Allreduce(x, r, SUM)
        dt = time.perf_counter() - t0
        if r[0] != sum(k + 0.5 for k in range(comm.size)):
            raise AssertionError(f"17a timed Allreduce: {r[0]}")
        return comm.coll.providers["allreduce"], dt
    return fn


def phase_inter_step(dev) -> dict:
    """17a (see the module docstring).  Returns its launches."""
    import numpy as np
    n, nag = INTER_MIB * MIB // 4, INTER_AG_MIB * MIB // 4
    res, launches = _ft_launch_run(inter_step_program(dev, n, nag), NRANKS,
                                   lambda r: dev)
    want = {**{k: 0 for k in launches}, "stacked_reduce": INTER_STEPS,
            "stacked_copy": INTER_STEPS}
    if launches != want:
        raise AssertionError(f"17a launches {_ft_counted(launches)}, "
                             f"expected K1 {INTER_STEPS}, K2 {INTER_STEPS}")
    ref = _sum_ref(range(NRANKS), n, dev, 70)
    gather = torch.cat([rank_elems(r, nag, torch.float32, dev, 71)
                        for r in range(NRANKS)])
    err = 0.0
    for r, (prov, first, y, z, losses, bcasts) in enumerate(res):
        if prov != "sm":
            raise AssertionError(f"17a rank {r}: allreduce by {prov}")
        err = max(err, _in_band(first, ref, NRANKS, f"17a rank {r}"))
        if _sha(y) != _sha(res[0][2]) or _sha(z) != _sha(gather):
            raise AssertionError(f"17a rank {r}: K1 or K2 output differs")
        for s in range(INTER_STEPS):
            gs = [np.random.default_rng(SEED + 97 * s + k)
                  for k in range(NRANKS)]
            acc = np.array([gs[0].standard_normal()])
            for g in gs[1:]:
                acc = acc + g.standard_normal()  # sm's rank-order fold
            if losses[s].tobytes() != acc.tobytes() or \
                    bcasts[s].tobytes() != gs[0].integers(
                        0, 1 << 40, INTER_BCAST).tobytes():
                raise AssertionError(f"17a rank {r} step {s}: host "
                                     "results differ from numpy's")
    log(f"[inter] 17a 8 ranks on {dev}, {INTER_STEPS} steps of "
        f"allreduce_arr {INTER_MIB} MiB f32 SUM + host Allreduce (1 f64) "
        f"+ host Bcast ({INTER_BCAST} i64) through sm + allgather_arr "
        f"{INTER_AG_MIB} MiB f32 + Barrier, one rendezvous: allreduce by "
        f"sm; launches {_ft_counted(launches)}, exact; K1 in the float "
        f"SUM band (max error {err:.3e}), K2 and the host results byte "
        f"for byte")
    from ompi_tpu_torch.testing import run_ranks
    us = {}
    for nbytes, reps in zip((8, 8 * MIB), INTER_REPS):
        for mode in ("sm", "^sm", "^sm", "sm"):
            with _knobs(coll="" if mode == "sm" else "^sm"):
                out = run_ranks(NRANKS, inter_host_timed(nbytes, reps),
                                device_map=lambda r: dev, timeout=600)
            want_p = "sm" if mode == "sm" else "tuned"
            if any(p != want_p for p, _ in out):
                raise AssertionError(f"17a timed {mode}: providers "
                                     f"{[p for p, _ in out]}")
            us.setdefault((nbytes, mode), []).append(
                max(t for _, t in out) / reps * 1e6)
    log(f"[inter] 17a host us a host Allreduce, 8 ranks, slowest rank, "
        f"A B B A: 8 B (1 f64) sm {us[(8, 'sm')][0]:.1f} / "
        f"{us[(8, 'sm')][1]:.1f}, tuned {us[(8, '^sm')][0]:.1f} / "
        f"{us[(8, '^sm')][1]:.1f}; {INTER_MIB} MiB f32 sm "
        f"{us[(8 * MIB, 'sm')][0]:.1f} / {us[(8 * MIB, 'sm')][1]:.1f}, "
        f"tuned {us[(8 * MIB, '^sm')][0]:.1f} / "
        f"{us[(8 * MIB, '^sm')][1]:.1f} [{card_line()}]")
    return launches


def inter_program(dev, n: int):
    """17b's rank program: two groups of 4, an intercomm over the
    world, inter Allreduce, a rooted Bcast and Alltoall of host
    arrays, then merge() and INTER_MERGED_OPS allreduce_arr on the
    merged comm.  Returns (the host results, the merged comm's outputs,
    its allreduce_arr provider, its rank)."""
    import numpy as np
    from ompi_tpu_torch.comm.intercomm import ROOT
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.pml.request import PROC_NULL

    def fn(comm):
        half = comm.size // 2
        low = comm.rank < half
        local = comm.split(0 if low else 1)
        inter = local.create_intercomm(0, comm, half if low else 0,
                                       tag=17)
        s = np.random.default_rng(SEED + 17 + comm.rank).integers(
            0, 1 << 30, 16)
        r = np.empty_like(s)
        inter.Allreduce(s, r, SUM)
        b = np.arange(32, dtype=np.float64) * 0.5 if comm.rank == 0 \
            else np.zeros(32)
        if low:
            inter.Bcast(b, root=ROOT if comm.rank == 0 else PROC_NULL)
        else:
            inter.Bcast(b, root=0)
        sb = np.array([comm.rank * 100 + i for i in range(inter.remote_size)],
                      np.int64)
        rb = np.empty_like(sb)
        inter.Alltoall(sb, rb)
        merged = inter.merge(high=not low)
        x = rank_elems(merged.rank, n, torch.float32, dev, 72)
        ys = [merged.allreduce_arr(x, SUM) for _ in range(INTER_MERGED_OPS)]
        _sync(dev)
        return ((r, b, rb), ys, merged.coll.providers["allreduce_arr"],
                merged.rank)
    return fn


def phase_inter_comm(dev) -> dict:
    """17b (see the module docstring).  Returns its launches."""
    import numpy as np
    n = INTER_MIB * MIB // 4
    res, launches = _ft_launch_run(inter_program(dev, n), NRANKS,
                                   lambda r: dev)
    want = {**{k: 0 for k in launches}, "stacked_reduce": INTER_MERGED_OPS}
    if launches != want:
        raise AssertionError(f"17b launches {_ft_counted(launches)}, "
                             f"expected K1 {INTER_MERGED_OPS}")
    half = NRANKS // 2
    draws = [np.random.default_rng(SEED + 17 + k).integers(0, 1 << 30, 16)
             for k in range(NRANKS)]
    ref = _sum_ref(range(NRANKS), n, dev, 72)
    err = 0.0
    for k, ((r, b, rb), ys, prov, mrank) in enumerate(res):
        low = k < half
        other = range(half, NRANKS) if low else range(half)
        local = k if low else k - half
        if r.tobytes() != np.sum([draws[o] for o in other],
                                 axis=0).tobytes():
            raise AssertionError(f"17b rank {k}: inter Allreduce {r}")
        if not low and b.tobytes() != (np.arange(32) * 0.5).tobytes():
            raise AssertionError(f"17b rank {k}: inter Bcast {b}")
        if rb.tolist() != [o * 100 + local for o in other]:
            raise AssertionError(f"17b rank {k}: inter Alltoall {rb}")
        if prov != "hbm" or mrank != k:
            raise AssertionError(f"17b rank {k}: merged rank {mrank}, "
                                 f"allreduce_arr by {prov}")
        for y in ys:
            err = max(err, _in_band(y, ref, NRANKS, f"17b rank {k}"))
    log(f"[inter] 17b 8 ranks on {dev}: two groups of 4, "
        f"create_intercomm over the world, inter Allreduce (16 i64 SUM: "
        f"the other group's sum), Bcast from ROOT, Alltoall, each the "
        f"reference's semantics; merge(): allreduce_arr {INTER_MIB} MiB "
        f"f32 SUM x {INTER_MERGED_OPS} by hbm, launches "
        f"{_ft_counted(launches)}, exact, max error {err:.3e} (in the "
        f"float SUM band)")
    return launches


def phase_inter_jobs(dev, devices: str = "auto") -> None:
    """17c, 17d and 17f (see the module docstring): the three checked
    jobs run side by side, then 17d's timed job alone."""
    jobs = {
        "17c": (2, None, (SPAWN_PROG, "--device", devices, "--mib",
                          str(INTER_MIB)), {"devices": devices}),
        "17d": (SEG_NP, None, (SEG_PROG,), {}),
        "17f": (4, "all", (HALO_PROG,), {"devices": devices}),
    }
    got = {}

    def run(key):
        np_, rpp, args, kw = jobs[key]
        try:
            got[key] = mpirun_job(np_, rpp, args, **kw)
        except BaseException as e:  # noqa: BLE001 (raised below)
            got[key] = e
    threads = [threading.Thread(target=run, args=(k,)) for k in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, v in got.items():
        if isinstance(v, BaseException):
            raise v
    # 17c: parents and spawned workers on the card, the merged comm's
    # staged allreduce_arr; every rank's digest plain torch's
    from ompi_tpu_torch.examples.spawn_worker import card_values
    from ompi_tpu_torch.testing import collseg_digest
    rc, out, err, s_c = got["17c"]
    n = INTER_MIB << 18
    plain = _sha(sum(card_values(r, n, dev) for r in range(4)))
    kind = "cuda" if devices == "auto" else "cpu"
    cards = sorted(ln for ln in out.splitlines() if ln.startswith("CARD"))
    lines = out.splitlines()
    if rc != 0 or cards != [f"CARD rank={r} device={kind} {plain}"
                            for r in range(4)] or \
            sum("merged size 4 total 204.0" in ln for ln in lines) != 2 or \
            any(f"worker {w}: merged rank {2 + w}/4" not in lines
                for w in range(2)):
        raise AssertionError(f"17c: exit {rc}\n{out[-2000:]}\n{err[-2000:]}")
    log(f"[inter] 17c mpirun -np 2 spawn_parent.py --device {devices} "
        f"--mib {INTER_MIB}: 2 parents spawned 2 workers (exit 0, "
        f"{s_c:.1f} s), the reference's lines (merged size 4 total "
        f"204.0; worker w: merged rank 2+w/4); merge(), allreduce_arr "
        f"{INTER_MIB} MiB f32 across the 4 process ranks (staged): every "
        f"rank's tensor on {kind}, digest = plain torch's {plain[:16]}...")
    # 17d: the segment program's checks and its native path
    rc, out, err, s_d = got["17d"]
    want = collseg_digest(SEG_NP)
    pv = [dict(kv.split("=") for kv in ln.split()[1:])
          for ln in out.splitlines() if ln.startswith("SEGPVAR")]
    digests = sorted(ln for ln in out.splitlines()
                     if ln.startswith("SEGDIGEST"))
    if rc != 0 or "collseg ok" not in out or "collseg chunked ok" not in out \
            or digests != [f"SEGDIGEST rank={r} {want}"
                           for r in range(SEG_NP)] \
            or len(pv) != SEG_NP or any(
                int(p["native"]) <= 0 or int(p["python"]) != 0 for p in pv):
        raise AssertionError(f"17d: exit {rc}, {pv}\n{out[-1500:]}\n"
                             f"{err[-2000:]}")
    log(f"[inter] 17d mpirun -np {SEG_NP} collseg_prog.py: collseg ok, "
        f"collseg chunked ok (the reference program's checks), every "
        f"rank's seeded SUM/MAX/BXOR/Bcast/Allgather digest = numpy's "
        f"{want[:16]}...; coll_seg_native_ops {pv[0]['native']}, "
        f"python_ops 0 on every rank ({s_d:.1f} s)")
    # 17f: the halo on rank-threads of one shell, the device halo on
    # the card (the program asserts sendrecv_arr's tensor is there)
    rc, out, err, s_f = got["17f"]
    halo = [f"rank {r} coords [{r // 2}, {r % 2}] halo-mean 1.50 "
            f"interior-mean {float(r):.2f}" for r in range(4)]
    if rc != 0 or any(h not in out for h in halo) or \
            out.count("halo-mean") != 4:
        raise AssertionError(f"17f: exit {rc}\n{out[-1500:]}\n{err[-2000:]}")
    log(f"[inter] 17f mpirun -np 4 --ranks-per-proc all --devices "
        f"{devices} halo_stencil.py: the reference's four lines, the "
        f"device halo's sendrecv_arr on {kind} ({s_f:.1f} s)")
    # 17d timed: 8 MiB f64 host Allreduce, seg against the p2p route
    # ``--mca coll ^seg`` selects (coll/tuned), A B B A in one job
    rc, out, err, _ = mpirun_job(
        SEG_NP, None, (SEG_PROG, "--bench", "8", str(SEG_REPS), "--ab"))
    rows = _json_lines(out)
    if rc != 0 or len(rows) != 1 or rows[0]["provider"] != "seg" \
            or not rows[0]["exact"] or len(rows[0]["us_tuned"]) != 2:
        raise AssertionError(f"17d timed: exit {rc}, {rows}\n"
                             f"{err[-2000:]}")
    seg_us, tuned_us = rows[0]["us_comm"], rows[0]["us_tuned"]
    log(f"[inter] 17d host us an 8 MiB f64 Allreduce SUM between "
        f"{SEG_NP} process ranks ({SEG_REPS} ops a run, slowest rank, one "
        f"job, A B B A): seg {seg_us[0]:.1f} / {seg_us[1]:.1f}, the "
        f"tuned p2p route of --mca coll ^seg {tuned_us[0]:.1f} / "
        f"{tuned_us[1]:.1f} [{card_line()}]")


def phase_inter_attention(devices: str = "auto") -> None:
    """17e (see the module docstring)."""
    from ompi_tpu_torch.examples import ring_attention
    outs, err, cold, warm = ring_attention.run(devices, 4, RA_TOKENS,
                                               RA_DIM)
    kind = "cuda" if devices == "auto" else "cpu"
    if any(o.device.type != kind or o.dtype != torch.float32 or
           o.shape != (RA_TOKENS, RA_DIM) for o in outs):
        raise AssertionError(f"17e: outputs {[o.device for o in outs]}")
    log(f"[inter] 17e ring_attention.py --device {devices} --tokens "
        f"{RA_TOKENS} --dim {RA_DIM}: 4 rank-threads on {outs[0].device}, "
        f"f32, full attention at rtol {ring_attention.RTOL} / atol "
        f"{ring_attention.ATOL} (max error {err:.3e}); {warm:.3f} ms, "
        f"slowest rank (the first call {cold:.3f} ms) [{card_line()}]")


def phase_inter(dev, devices: str = "auto") -> dict:
    """Phase 17: 17a (phase_inter_step), 17b (phase_inter_comm), 17e
    (phase_inter_attention), 17c/17d/17f (phase_inter_jobs).  Returns
    17a's and 17b's launches (they join the kernels line)."""
    t0 = time.perf_counter()
    la = phase_inter_step(dev)
    lb = phase_inter_comm(dev)
    phase_inter_attention(devices)
    phase_inter_jobs(dev, devices)
    log(f"[inter] phase 17 {time.perf_counter() - t0:.1f} s")
    return {k: la[k] + lb[k] for k in la}


FLAT_N = 20            # 18a: allreduce_arr ops on the duplicate
FLAT_MIB = 8           # 18a/18b/18c: the float32 card tensor a rank
FLAT_HOST = (8, 8 * MIB)  # 18a: bytes of the host (P)MPI_Allreduce
FLAT_CHECK_MIB = 8     # 18b: the host MPI_Isend / MPI_Irecv (rendezvous)


def _flat_ref(n: int, dev):
    """(sum x_r, sum |x_r|) in float64 over testing.flat's inputs."""
    from ompi_tpu_torch.testing import flat
    xs = [flat.values(r, n, dev).double() for r in range(NRANKS)]
    return sum(xs), sum(x.abs() for x in xs)


def phase_flat_headline(dev) -> dict:
    """18a (see the module docstring).  Returns its launches."""
    from ompi_tpu_torch.testing import flat
    n = FLAT_MIB * MIB // 4
    with _knobs(pml_monitoring_enable=1):
        res, launches = _ft_launch_run(
            flat.headline(dev, n, FLAT_N, FLAT_HOST), NRANKS,
            lambda r: dev)
    want = {**{k: 0 for k in launches}, "stacked_reduce": FLAT_N}
    if launches != want:
        raise AssertionError(f"18a launches {_ft_counted(launches)}, "
                             f"expected K1 {FLAT_N}")
    ref = _flat_ref(n, dev)
    err = 0.0
    for r, out in enumerate(res):
        other = [0 if p == r else 1 for p in range(NRANKS)]
        want_pv = {"pml_monitoring_filtered_count": [FLAT_N * o
                                                     for o in other],
                   "pml_monitoring_filtered_size": [FLAT_N * 4 * n * o
                                                    for o in other],
                   "coll_plan_builds": NRANKS,
                   "coll_plan_hits": NRANKS * (FLAT_N - 1)}
        if out["copies"] != [r] or out["attr"] != (True, r + 1) or \
                not out["errhandler"]:
            raise AssertionError(f"18a rank {r}: copy calls "
                                 f"{out['copies']}, attribute "
                                 f"{out['attr']}, errhandler "
                                 f"{out['errhandler']}")
        if out["pvars"] != want_pv:
            raise AssertionError(f"18a rank {r}: MPI_T deltas "
                                 f"{out['pvars']}, expected {want_pv}")
        err = max(err, _in_band(out["y"], ref, NRANKS, f"18a rank {r}"))
        if out["host_provider"] != "sm" or any(
                a != flat.host_sum(NRANKS, nb) or b != a
                for (a, b), nb in zip(out["host"], FLAT_HOST)):
            raise AssertionError(f"18a rank {r}: host (P)MPI_Allreduce "
                                 f"by {out['host_provider']} differs "
                                 "from numpy's")
    log(f"[flat] 18a 8 ranks on {dev} through MPI handles: "
        f"MPI_COMM_WORLD(), a copying attribute (1 copy a rank), "
        f"MPI_Comm_dup, MPI_ERRORS_RETURN, pml_monitoring_enable; "
        f"allreduce_arr {FLAT_MIB} MiB f32 SUM x {FLAT_N}: launches "
        f"{_ft_counted(launches)}, exact; MPI_T deltas a rank: "
        f"coll_plan_builds {NRANKS}, coll_plan_hits "
        f"{NRANKS * (FLAT_N - 1)}, filtered_count {FLAT_N} and "
        f"filtered_size {FLAT_N * 4 * n} to each of the 7 others (16a's "
        f"counts); max error {err:.3e} (in the float SUM band); "
        f"MPI_Allreduce and PMPI_Allreduce of {FLAT_HOST[0]} B and "
        f"{FLAT_HOST[1]} B i64 by sm, byte for byte numpy's")
    return launches


def phase_flat_memcheck(dev) -> dict:
    """18b (see the module docstring).  Returns its launches."""
    from ompi_tpu_torch.testing import flat
    n = FLAT_MIB * MIB // 4
    with _knobs(opal_memchecker_enable=1):
        res, launches = _ft_launch_run(
            flat.memcheck(dev, n, FLAT_CHECK_MIB * MIB), 2, lambda r: dev)
    (err, sent), (kind, got, posted, done) = res
    if kind != dev.type or got != sent or \
            sent != flat.digest(flat.values(0, n, dev)):
        raise AssertionError(f"18b send_arr: a {kind} tensor of digest "
                             f"{got}, sent {sent}")
    if not (err or "").startswith("memchecker: send buffer of rendezvous "
                                  "send req "):
        raise AssertionError(f"18b MPI_Isend's changed buffer: {err!r}")
    if posted != b"\xcb" or done != b"\x00":
        raise AssertionError(f"18b MPI_Irecv: posted {posted!r}, "
                             f"received {done!r}")
    log(f"[flat] 18b 2 ranks on {dev}, opal_memchecker_enable 1: "
        f"send_arr {FLAT_MIB} MiB f32 card tensor, plain torch's digest; "
        f"MPI_Isend {FLAT_CHECK_MIB} MiB changed before MPI_Wait: "
        f"{err.split(' was ')[0]!r} raised; the posted MPI_Irecv read "
        f"0xCB; launches {_ft_counted(launches)}")
    return launches


def phase_flat_errhandler(dev) -> dict:
    """18c (see the module docstring).  Returns its launches."""
    from ompi_tpu_torch import errhandler
    from ompi_tpu_torch.testing import flat
    n = FLAT_MIB * MIB // 4
    res, launches = _ft_launch_run(flat.errhandlers(dev, n), NRANKS,
                                   lambda r: dev)
    want = {**{k: 0 for k in launches}, "stacked_reduce": 1}
    if launches != want:
        raise AssertionError(f"18c launches {_ft_counted(launches)}, "
                             "expected K1 1")
    ref = _flat_ref(n, dev)
    err = 0.0
    for r, (calls, raised, y, deleted) in enumerate(res):
        if calls != [(True, errhandler.ERR_OTHER)] or raised is None \
                or deleted != [100 + r]:
            raise AssertionError(f"18c rank {r}: handler calls {calls}, "
                                 f"raised {raised}, delete calls "
                                 f"{deleted}")
        err = max(err, _in_band(y, ref, NRANKS, f"18c rank {r}"))
    log(f"[flat] 18c 8 ranks on {dev}: MPI_Bcast with root out of range "
        f"on a duplicate with a user errhandler: 1 call a rank with "
        f"MPI_ERR_OTHER ({errhandler.ERR_OTHER}), the error raised; the "
        f"next allreduce_arr {FLAT_MIB} MiB f32 SUM: launches "
        f"{_ft_counted(launches)}, exact, max error {err:.3e} (in the "
        f"float SUM band); MPI_Comm_free ran the delete function once a "
        f"rank")
    return launches


def phase_flat(dev) -> dict:
    """Phase 18: 18a (phase_flat_headline), 18b (phase_flat_memcheck),
    18c (phase_flat_errhandler).  Returns their launches (they join the
    kernels line)."""
    t0 = time.perf_counter()
    la = phase_flat_headline(dev)
    lb = phase_flat_memcheck(dev)
    lc = phase_flat_errhandler(dev)
    log(f"[flat] phase 18 {time.perf_counter() - t0:.1f} s")
    return {k: la[k] + lb[k] + lc[k] for k in la}


def main(argv) -> int:
    """``--cards``: build, then the one-rank-a-card branch alone (for a
    host with two or more cards); no argument: every phase.
    ``--rank-program NAME ARGS``: a rank program of phase 11, run by
    the rank-threads of an app shell under mpirun."""
    if argv[:1] == ["--rank-program"]:
        return RANK_PROGRAMS[argv[1]](argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    phase_build()
    from ompi_tpu_torch import obs
    from ompi_tpu_torch.mca.params import registry
    # the flight recorder's ring (sized at its first use, the first
    # world's init): room for every event of phase 8c's injected runs
    registry.set("obs_events_ring", 4096)
    obs.recorder()
    if argv == ["--cards"]:
        if torch.cuda.device_count() < 2:
            print("chip_smoke: --cards needs two or more cards",
                  file=sys.stderr)
            return 2
        phase_cards()
        phase_procs_shells("auto", torch.cuda.device_count(), None)
        phase_nodes_hier("auto", torch.cuda.device_count() // 2 * 2)
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    phase_kernels(dev)
    launches, per_call = phase_main(dev)
    from ompi_tpu_torch.runtime.state import LogicalDevice
    m_launches, m_per_call = phase_mesh(
        [LogicalDevice(dev, r) for r in range(NRANKS)],
        f"8 logical devices on {dev}")
    launches = {k: launches[k] + m_launches[k] for k in launches}
    per_call.update(m_per_call)
    r_launches, r_per_call = phase_rma(
        [LogicalDevice(dev, r) for r in range(NRANKS)],
        f"8 logical devices on {dev}")
    launches = {k: launches[k] + r_launches[k] for k in launches}
    per_call.update(r_per_call)
    for tier, devs, what in (
            ("hbm", [dev] * NRANKS, f"8 ranks on {dev}"),
            ("tpu", [LogicalDevice(dev, r) for r in range(NRANKS)],
             f"8 logical devices on {dev}")):
        i_launches, i_per_call = phase_integrity(devs, tier, what)
        launches = {k: launches[k] + i_launches[k] for k in launches}
        per_call.update(i_per_call)
    for tier, devs, what in (
            ("tpu", [LogicalDevice(dev, r) for r in range(NRANKS)],
             f"8 logical devices on {dev}"),
            ("hbm", [dev] * NRANKS, f"8 ranks on {dev}")):
        h_launches, h_per_call = phase_halo(devs, tier, what)
        launches = {k: launches[k] + h_launches[k] for k in launches}
        per_call.update(h_per_call)
    e_launches, e_per_call = phase_entry(dev)
    launches = {k: launches[k] + e_launches[k] for k in launches}
    per_call.update(e_per_call)
    if torch.cuda.device_count() >= 2:
        phase_cards()
    rows = phase_timing(dev, launches, per_call)
    headline_us = phase_e2e(dev, rows[0]["ms"])
    phase_e2e_fused(dev, next(r["ms"] for r in rows
                              if r["name"].startswith("fused_batch")))
    phase_e2e_config5(dev)
    phase_e2e_mesh(dev, sum(r["ms"] for r in rows if r["name"] in (
        "mesh_fold:allreduce_sum_f32_8MiB_rank_order",
        "peer_copy:allgather_stripes_f32_8MiB")))
    phase_e2e_rma(dev)
    phase_e2e_integrity(dev, next(r["ms"] for r in rows
                                  if r["name"] == "digest:gate_fsum_f32_8MiB"))
    phase_e2e_halo(dev)
    phase_trace(dev)
    s_launches = phase_shmem(dev)
    for r in rows:  # phase 7a's launches join the main path's counts
        r["launches"] += s_launches[r["name"].split(":")[0]]
    x_launches = phase_sessions(dev)
    for r in rows:  # and phase 8a/8b's, the combined dispatches'
        k = r["name"].split(":")[0]
        r["launches"] += x_launches.get(k, 0)
        if ":combined_" in r["name"]:
            r["launches_per_call"] = x_launches[k] // XS_FLUSHES
    h_launches = phase_hier(dev)
    for r in rows:  # and phase 9a's, the hierarchical tier's
        r["launches"] += h_launches.get(r["name"].split(":")[0], 0)
    f_launches = phase_ft(dev)
    for r in rows:  # and phase 10's, the fault-tolerance runs'
        r["launches"] += f_launches.get(r["name"].split(":")[0], 0)
    p_k1, us_11a = phase_procs(dev, headline_us)
    for r in rows:  # and phase 11's, the app shells' (K1 only)
        if r["name"].split(":")[0] == "stacked_reduce":
            r["launches"] += p_k1
    n_launches = phase_nodes(dev, us_11a)
    for r in rows:  # and phase 12's, the daemons' shells'
        r["launches"] += n_launches.get(r["name"].split(":")[0], 0)
    q_launches = phase_pool(dev)
    for r in rows:  # and phase 13's, the resident pools' sessions'
        r["launches"] += q_launches.get(r["name"].split(":")[0], 0)
    f_launches = phase_fleet(dev)
    for r in rows:  # and phase 14's, the fleet's sessions'
        r["launches"] += f_launches.get(r["name"].split(":")[0], 0)
    c_launches = phase_ckpt(dev)
    for r in rows:  # and phase 15's, the checkpointed steps'
        r["launches"] += c_launches.get(r["name"].split(":")[0], 0)
    m_launches = phase_proto(dev)
    for r in rows:  # and phase 16a's, the monitored headline's
        r["launches"] += m_launches.get(r["name"].split(":")[0], 0)
    i_launches = phase_inter(dev)
    for r in rows:  # and phase 17a/17b's, the interleaved steps'
        r["launches"] += i_launches.get(r["name"].split(":")[0], 0)
    l_launches = phase_flat(dev)
    for r in rows:  # and phase 18's, the flat surface's
        r["launches"] += l_launches.get(r["name"].split(":")[0], 0)
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
