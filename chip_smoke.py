#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's WER paths (code-capacity,
phenomenological, phenomenological space-time and circuit-level) on one
NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

On the card every WordErrorRate replays a captured CUDA graph of one
megabatch (parallel/shots.py), its tier ladders conditional nodes
(utils/device.py device_cond): one host read per megabatch.  The main-path
phases run it under torch.cuda.set_sync_debug_mode("error") from the first
replay to each megabatch read (parallel/shots.py check_syncs) and print
their host reads per megabatch, the capture's warm-up, capture and
instantiate seconds, its node count and the phase's peak device memory;
phases 5, 6, 16, 25 (both modes), 28-30 and 32-34 and 36 must read the
host once a megabatch and never for a tier (decode_device.host_reads and
bp_decode_two_phase.host_reads stay 0), and each holds one megabatch of its
graph (a fresh key) against the same megabatch run eagerly
(_kernels.force_eager).  Launch counts count the replays' launches.

Phases (any failure raises and the script exits non-zero):
  1. the card (nvidia-smi name and power limit); TF32 off for every matmul
  2. build all nine kernel sources from qldpc_fault_tolerance_tpu_torch/csrc
     (one nvcc per source, started together; graph_cond.cu holds the
     conditional-node capture, no TPU kernel)
  3. kernel 1 (min-sum BP) against its plain PyTorch version on the card:
     hgp_34_n625 hx, B=4096, syndromes of p=0.05 errors, max_iter 50; its
     layout (shots per block, threads, blocks, resident blocks per SM from
     the card's occupancy, shared memory per block)
  4. kernel 2 (GF(2) elimination) against its plain version: B=256 shots
     BP failed in phase 3, permuted by their posteriors, and B=512 (phase
     6's straggler tier); each timed, with its layout (threads per shot,
     blocks, resident blocks per SM, shared memory)
  5. main path, BP: CodeSimulator_DataError WER on hgp_34_n625, BP-50,
     depolarizing p=0.01, 16 batches of 4096 (default decoders: on the card
     the two-phase head and tail run in the bf16 head); its failures and
     min weight pinned (MINSUM_RUNS, as phases 6, 16, 17, 22 and 26); a
     target_failures run of its simulator stops where the eager loop stops,
     with the eager loop's failures and shots
  6. main path, BPOSD: the same code, BP-50 + OSD-E order 10, p=0.05,
     8 batches of 2048
  7. anchors: zero failures at p=0; one BPOSD batch with every kernel
     replaced by its plain version gives the same failures and min weight;
     64 shots (no head engages: float32 on both) and 256 shots (the card's
     bf16 head against the CPU running the same head's plain version)
     decoded on the CPU and on the card agree
  8. a "kernels" JSON line, printed after phase 39: for all eleven kernels
     the main-path launches (phase 26 for kernel 1, phase 6 for kernel 2,
     phase 5 for the bf16 head, phase 12 for B3 and B4, phase 16 for B7 and
     B8, phase 17 for B10, phase 21 for B6, phase 25 for B5's bf16 and int8
     modes), error against the plain version, times, bound; the bf16 head
     has a second entry for the v1 tag's route (it replaces the dense
     one-hot B9 too), with phase 22's launches; and one entry for each
     device-memory, transform and check-state mode of phase 27, with its
     launches in phases 28-30 and 33 (kernel 1's check-state mode, bp_minsum_checks,
     with phase 33's numbers: the one phenomenological main path that
     launches it); and the min-sum kernels' wide instances at phase 36's
     shapes, kernel 1's in its check-state mode on h1
     (bp_minsum_wide_checks) and, fixed, in its 32-bit-plane mode
     (bp_minsum_wide_device_planes, which no main path launches now), and
     the bf16 head's in shared memory on h2 (bp_minsum_bf16_wide), with
     phase 36's launches;
     and B6's and B5's wide instances (bp_int8_wide at h2's shape,
     fused_decode_wide and fused_decode_int8_wide on phase 38's code),
     with phase 38's launches; and kernel 1's sector mode
     (bp_minsum_sectors) with phase 53's numbers and launches
  9. kernel B3 (counter-PRNG sampler) against its plain version: hgp_34_n625,
     p=0.01, B=4096 with and without the error words, and a ragged B=4000;
     every word bit-exact
 10. kernel B4 (residual check) against its plain version: the corrections
     are BPDecoder decodes of phase 9's syndromes; X, Z and Total
 11. (kernel B5, the whole-pipeline fused decode, is held against its plain
     versions in phase 24, in both message modes)
 12. main path, fused engines: CodeSimulator_DataError(fused_sampler=True)
     BP-50 p=0.01, 16 batches of 4096, then fused_sampler="v2" with the same
     seed (bf16 messages: its failures within 4 combined binomial standard
     errors of v1's), then v1 with BPOSD (OSD-E order 10) at p=0.05, 4
     batches of 2048
 13. anchors: v2 at p=0 gives no failure; one v1 and one v2 batch with every
     kernel replaced by its plain version give the kernel path's failures
     and min weight
 14. kernels B7 (full elimination, fcap 0 and 10) and B10 (per-column
     elimination) against their plain versions on phase 4's 256 and 512
     shots: every output bit-exact, the reduced matrix whole; timed, with
     their layouts
 15. kernel B8 (OSD-CS sweep) on phase 4's 256 shots (f=325, w=10: 371
     candidates per shot): the launch that builds its planes from the
     reduced matrix (the main path's) against cs_planes then
     cs_sweep_plain, and the launch over given planes against
     cs_sweep_plain; cost and index bit-exact; timed, with the PyTorch
     plane pass and sweep the main path no longer runs
 16. main path, BPOSD-CS: BP-50 + OSD-CS order 10, p=0.05, 8 batches of 2048
 17. main path, the per-column route: phase 6's OSD-E run (same seed and
     batches) with QLDPC_OSD_ELIM=pallas_percol; its failures and min weight
     must equal phase 6's
 18. anchors: OSD-CS at p=0 gives no failure; one OSD-CS batch with every
     kernel replaced by its plain version gives the kernel path's failures
     and min weight
 19. kernel B6 (int8 min-sum) against its plain version on phase 3's
     syndromes: the head at tile 256 without early exit, and a compacted
     tail of 1024 rows (stragglers of a 3-iteration int8 head and zero
     sentinel rows) at tile 512 with early exit; every output bit-exact
 20. the bf16 head (B1's bf16 mode, which serves the v1 tag in place of
     the dense one-hot B9) against its plain version minsum_dense_plain on
     the same syndromes: the head at tile 256 without early exit, 50
     iterations, and a compacted tail of 1024 rows (stragglers of a
     3-iteration head and zero sentinel rows) with early exit; every
     output bit-exact; the layouts; then both min-sum kernels at the main
     path's two shapes (a 3-iteration head over 4096 shots at p=0.01 and
     its compacted tail of 256 rows, 50 iterations with early exit, which
     phase 5 launches 32 + 32 times), timed, and at phase 3/20's shapes and
     these on hgp_34_n1225 and n1600, every output bit-exact
 21. main path, int8: phase 5's run with BPDecoder(quantize="int8"); its
     WER within int8_parity_tolerance of phase 5's
 22. main path, v1: phase 5's run with BPDecoder(bp_kernel="v1"); the same
     kernel as phase 5, so its failures and min weight equal phase 5's
     unless a head gate differs between the tags (then it names the gate
     and holds the failures within 4 combined binomial standard errors)
 23. anchors: int8 and v1 at p=0 give no failure; one int8 and one v1
     batch with every kernel replaced by its plain version give the kernel
     path's failures and min weight; a fused-v1 batch with int8 decoders
 24. kernel B5 in both modes against its plain versions: hgp_34_n625,
     B=4096, p=0.01 and 0.05, bf16 and int8 at block_w 8 and 1; count, min
     weight and every shot's converged flag and iterations identical; each
     mode timed by profiler device time at p=0.01, with its bound; the
     bf16 mode's layout
 25. main path, fused v2 in both modes: CodeSimulator_DataError(
     fused_sampler="v2") BP-50 p=0.01, 16 batches of 4096, with float
     BPDecoders (bf16) and with BPDecoder(quantize="int8"); only the fused
     kernel launches; bf16 failures within 4 binomial standard errors of
     phase 12's v1, int8 WER within int8_parity_tolerance of bf16, both
     modes' failures and min weight pinned (BF16_RUNS, INT8_RUNS); one batch
     of each with every kernel replaced by its plain version gives the
     kernel path's failures and min weight
 26. main path, float32: phase 5's run with BPDecoder(bp_kernel="xla"),
     kernel 1 (min-sum, float32 messages) in head and tail
 27. the modes the card takes where one shot does not fit a block's
     shared memory, against their plain versions: the elimination on
     [H|I] of hgp_34_n1600 (768 x 2368, 233,816 B a shot) at 256, 512 and
     2048 shots (phase 30's tier), the blocked routes in the transform mode
     the layout picks (the shot's 768 x 768 row transform in shared memory)
     and, fixed, in the device-memory mode, the per-column route in the
     device-memory mode; each launch counted in its mode; the transform
     walk's word operations (ops/osd_device.py transform_work) beside the
     matrix walk's (elimination_work), the smaller bounding the transform
     rows;
     kernel 1 and the bf16 head on three copies of that [H|I] (2304 x
     7104, ~300 KB of messages a shot) in the check-state mode the layout
     picks (one record per check and the totals in shared memory, the
     16-bit planes staged), and, fixed, with the lanes in a device scratch
     (the 16-bit planes staged) and with 32-bit planes in device memory;
     kernel 1 on eleven copies (67,584 edges: 32-bit planes, and records
     beyond a block); every output bit-exact; each mode timed, and against
     the shared-memory mode at a shape all run (hgp_34_n1600's H), the
     modes fixed by _kernels.force_memory (the elimination's transform
     mode there too)
 28. main path, the phenomenological engine (the Threshold notebook's
     cell, as the JAX package's sweeps build it): CodeSimulator_Phenon on
     hgp_34_n625, decoder 1 BP (max_iter N/30, min-sum 0.625) on [H|I],
     decoder 2 BP + OSD-E order 10 (N/10) on H, eval_p 0.02 (p = 0.03
     depolarizing, q = 0.02 syndrome flips), 9 rounds, 8 batches of 2048;
     shots/s and host reads per batch; failures and min weight pinned
     (PHENOM_RUNS)
 29. main path, the Single-Shot notebook's decoder 1: FirstMin BP (N/5
     restarts, 0.9) with phase 28's decoder 2, 11 rounds, eval_p 0.01 (at
     the notebook's 0.02 every shot fails), 1 batch of 2048; pinned
 30. main path, BP + OSD-0 on both decoders at hgp_34_n1600 (the
     phenomenological BP+OSD-0 configuration of BASELINE.json): decoder 1's
     elimination on [H|I] takes the transform mode (no device-memory
     launch), its min-sum
     decodes shared memory (no check-state or device-memory launch
     counted); eval_p 0.02, 9 rounds, 2 batches of 2048; pinned
 31. anchors: p = q = 0 gives no failure; one phase-28 batch with every
     kernel replaced by its plain version, and with packed=False, gives the
     kernel path's failures and min weight; so does one phase-30 batch of
     PHENOM31_ROUNDS rounds (kernel 1, the bf16 head and the elimination's
     transform mode at phase 30's shapes: the rounds are depth, each
     round's decodes the same) with every kernel replaced; fused_sampler="v2" on six
     copies of hgp_34_n625 (n = 3750, which the fused kernel cannot take)
     runs as fused v1, its fallback counted, with v1's failures
 32. main path, the phenomenological space-time engine (the JAX package's
     sweep/family_spacetime.py _phenl_wer cell): CodeSimulator_Phenon_SpaceTime
     on hgp_34_n625, decoder 1 the space-time BP window decoder
     (ST_BP_Decoder_Class(30, min-sum, 0.625), windows of num_rep 3 slices
     of [H|I]: 900 x 2775), decoder 2 BP + OSD-E order 10 on H, eval_p
     ST_P (p = 3/2 eval_p depolarizing, q = eval_p), 13 cycles (5 rounds:
     4 windows and the final round), 8 batches of 2048; the window
     decoder's program and layout; pinned (ST_RUNS)
 33. phase 32's cell with windows of 8 slices (2400 x 7400, beyond a
     block's shared memory: the min-sum kernels' check-state mode, and no
     device-memory mode) at eval_p ST33_P, 17 cycles (3 rounds), 2 batches
     of 2048; pinned; kernel 1 in the check-state mode on window histories
     of that matrix at each launch its ladder can make (2048 shots at the
     head's, the deepened head's and the full max_iter; the big straggler
     tier), every output bit-exact with the plain version
 34. main path, the circuit-level engine (the JAX package's
     sweep/family.py _circuit_wer cell with SpaceTimeDecodingDemo's CX-only
     noise): CodeSimulator_Circuit on hgp_34_n625, coloration schedule,
     p_CX = CIRCUIT_P, 6 cycles, decoder 1 BP (N/30) on [H|I] per round,
     decoder 2 BP + OSD-E order 10 on H, 4 batches of 2048; the circuit's
     qubits, measurements, detectors and noise ops; pinned (CIRCUIT_RUNS)
 35. anchors: p = q = 0 gives no failure in both engines; one batch of
     phases 32, 33 and 34 with every kernel replaced by its plain version
     gives the kernel path's failures and min weight; the card's
     FrameSampler fed the CPU's uniforms gives the CPU's detectors and
     observables, bit for bit
 36. main path, the circuit-level space-time engine (the JAX package's
     flagship, SpaceTimeDecodingDemo's cell): CodeSimulator_Circuit_SpaceTime
     on hgp_34_n625, CX-only noise at p_CX = CIRCUIT_P, coloration schedule,
     windows of num_rep 3, 13 cycles, decoder 1
     ST_BP_Decoder_Circuit_Class(1, min-sum, 0.625) on the detector error
     model's window matrix h1, decoder 2 ST_BPOSD_Decoder_Circuit_Class(1,
     min-sum, 0.625, osd_e, 10) on h2, 4 batches of 2048 in one captured
     megabatch; the DEM is built in a second process from the start of the
     run (its seconds printed, with the shapes and row weights of h1 and
     h2); the memory mode of each decode from the launch counters (kernel 1
     on h1 in its check-state mode, no device-memory mode, the bf16 head on
     h2 in shared memory, both the wide instances for row weights above
     32), each held bit for bit against its plain version at its main-path
     shapes, and kernel 1's 32-bit-plane device-memory mode, fixed, on the
     stragglers' tier; pinned (CIRCUIT_RUNS); a noiseless anchor (the
     sampler's probabilities zeroed) fails no shot
 37. the streaming drivers: CircuitStreamDriver over phase 36's engine,
     its carry after each of the 4 windows and its final decode equal to
     phase 36's window scan on the same detectors, bit for bit;
     PhenomStreamDriver over phase 32's engine, 4 windows and the final
     round equal to its run_batch on one key; then 100 replayed steps of
     each under torch.cuda.set_sync_debug_mode("error") (no host read), with
     their steps per second
 38. the repaired row-weight limits (ROADMAP §C): B6 on phase 36's h2 (row
     weight 40) at 2048 shots and at the decoder's tile, and
     BPDecoder(h2, quantize="int8") decoding them; B6 and B5 in both modes
     on hgp(ones(3, 37), ones(3, 5)) (hx rows 40, hz rows 8); each wide
     instance bit-exact with its plain version, counted, timed with its
     bound; on that code fused_sampler="v2" in both modes (no fallback to
     v1 counted) and the int8 two-phase decode, each equal seed for seed
     to the same run on the plain versions; the min-sum kernels' times in
     this run, all in the non-aligned barrier form
 39. the sweep layer (sweep/): CodeFamily([hgp_34_n225, hgp_34_n625],
     BP, BP + OSD-E 10).EvalThreshold("data", "Total") over 12 cells of
     SWEEP_SHOTS shots and the fit: p_c with its bootstrap CI from the run
     ledger; one "phenl" and one "circuit" "Z" EvalWER cell on hgp_34_n625,
     the cells of phases 28 and 34, whose failures must equal their pins;
     a mid-cell resume (phase 5's simulator stopped after 2 of 4
     megabatches, resumed from its CellProgress on the same captured graph:
     the unbroken run's counts); CodeFamily_SpaceTime's phenl branch at
     phase 32's cell, pinned; the threshold runs fused=False (the serial
     loop)
 40. the fused sweep path (sweep/fused.py): phase 39's threshold with
     fused="auto", every cell's (failures, shots) and p_c equal to phase
     39's, one captured graph a bucket, at most one host read a megabatch,
     no fallback cell, bf16 head and elimination launched; each bucket's
     megabatches, graph nodes, build and capture seconds and peak memory;
     the n625 bucket alone with its capture and replayed (shots/s); one
     fused megabatch (n225, one batch a cell) equal to itself with every
     kernel replaced by its plain version
 41. rare-event estimation (rare/): WeightedWordErrorRate at zero tilt on
     phase 5's simulator equal to WordErrorRate (failures, shots, min
     weight; s1 and w1 the uniform limit), with its capture and replayed;
     eval_rare_grid of RARE_P on hgp_34_n625 with BP (max_iter N/12.5),
     each rung tilted to RARE_TILT times its channel, one weighted fused
     bucket equal rung by rung to the serial WeightedWordErrorRate (counts
     exact, moments to 1e-6); each rung's WER, rse and ESS

 42. the shot mesh (parallel/shots.py): phase 5's run on
     shot_mesh(["cuda:0", "cuda:0"]) (two replicas, one captured graph a
     logical device), MESH42_BATCHES x 4096 shots a logical device: its
     (failures, min weight, shots) equal to its degrade_mesh() replay on
     one device, its failure rate within 4 binomial sigma of phase 5's;
     graphs, nodes, host reads a megabatch per device, peak memory per
     device; the same with fused_sampler="v2", pinned in MESH_RUNS and
     equal to its replay, and a small v2 run equal to the same mesh on the
     CPU through the plain versions (built in the second process beside
     the earlier phases); with two cards or more, shot_mesh() over every
     card against its replay, shots/s in all and a card
 43. phase 40's threshold on the 2-entry mesh (CodeFamily(mesh=),
     fused="auto") at MESH43_SCALE times its shots a cell: every cell's
     failure rate within 4 sigma of phase 40's (a two-proportion z), its
     p_c printed beside phase 40's and its bootstrap CI, one graph a
     device a bucket; phase 40's
     n625 bucket alone on the mesh, shots per cell twice phase 40's for the
     same lane-batches, counts equal to its degrade_mesh() replay
 44. a sweep grid across two processes: two workers on the card form a
     gloo group (nccl, one card a rank, with two cards or more) and run
     CodeFamily.EvalWER(shard_across_processes=True) on GRID44_P of
     hgp_34_n225; each ran only its own cells and the merged grid equals
     the single-process grid; each worker has a timeout
 45. decode-as-a-service on the card (serve/): sessions n625_a/b/c
     (hgp_34_n625 hx, BP-50 min-sum, p_data SERVE_FAMILY_P: one bucket
     family, so their rounds fuse), n225 (hgp_34_n225, BP-50) and n625_osd
     (BP-50 + OSD-E order 10, p 0.05) on the bucket ladder 32-4096, every
     bucket captured before serving (ContinuousBatcher.warm: each session's
     ladder, the family's fused lanes 2-3 to max_batch_shots 4096), the
     captures counted and timed; a TCP server and four pipelined tenant
     clients (three on the packed codec, one on JSON) send SERVE_REQUESTS
     requests of 32-1024 shots (sizes and syndromes from the seed, errors
     at each session's p); gates: every request answered once with its
     dispatched round's rows, every round equal to the offline
     decode_device of the same rows padded into the same buckets, fused
     dispatches > 0 and a 3-lane fused round equal to each member's
     program, no capture during the storm, one host read a dispatch (no
     tier read), and the bf16 head, kernel 1 and kernel 2 launched from
     the served path; printed: requests/s, served shots/s, latency p50 and
     p99, dispatches, rounds, padded fraction, fused dispatches and
     fallbacks, the dispatcher's replay time per session, graph nodes per
     bucket, capture seconds, peak memory, and how many shots of each
     session differ when the same rows are regrouped in reverse order;
     then SERVE_V2_REQUESTS requests with all four tenants on the packed
     codec (the JSON tenant's cost), every round bit-exact
 46. recovery: a second storm with an injected transient fault at the
     serve_dispatch and serve_fused_dispatch sites, a device_restart
     enactment (reset_device_state) and a heal of n225 from another
     thread, under a fast retry policy and the HealthProbe; every request
     answered once and bit-exact as in phase 45, every session healed and
     its graphs recaptured, then a third storm on the recaptured graphs,
     bit-exact; the ops plane's /metrics and /healthz answer
 47. the fleet (serve/router.py LocalFleet, serve/fleet.py): phase 45's
     sessions and bucket ladder on two in-process hosts, each host's
     batcher warmed, FLEET_REQUESTS requests of 32-1024 shots from four
     pipelined tenants through the router; a seeded host_kill at
     fleet_host_tick (after FLEET_KILL_AFTER collected answers) kills the
     owner of n625_osd's family, the gateway's deadman alone hands its
     families off; gates: every request answered once (at most one round
     on each host, the answer the survivor's where it has one), every
     round of both hosts == the offline decode_device of its padded rows
     on that host's state, serve.host_kills == 1, a replayed journal
     answer == the original; printed: requests/s, served shots/s, p50 /
     p99 before and after the kill, the handoff's gate-to-promote
     seconds, captures after the kill, the first adopted answer's
     latency, the dead host's released programs, device memory at the
     kill and peaks before and after
 48. the fault path, each part with an injected fault: (a) the data
     engine at p 0.01, FAULT48_BATCHES x 2048, with fused_sampler="v2"
     and packed: a transient fault at wer.data outliving its one retry
     steps the engine's one rung (fused_v2->fused_pallas, within 4
     binomial sigma of the v2 run and equal to the fault-free fused v1
     engine; packed->dense, bit for bit the packed run), and a second
     fault outliving the retries raises from the exhausted ladder (no
     rung leaves the card's kernels); (b) phase 42's mesh with
     mesh_device_loss at mesh_dispatch: one mesh_replan, counts equal to
     phase 42's run; (c) BP + OSD-E 10 at p 0.05 on 2048 shots: a
     transient fault in the device OSD stage raises from decode_batch (no
     host fallback); the same batch through the host C++ OSD
     (device_osd=False) equals _osd_numpy on FAULT48_ORACLE_SHOTS shots
     and the device OSD except float-tied candidates (at most
     FAULT48_TIE_SHARE of the BP-failed shots), its ms a shot with the
     CPU's model; (d) phase 34's circuit engine with decoder 2 on the
     host OSD (device_osd=False) within 4 binomial sigma of phase 34's
     run.  Every other phase steps no rung and replans no mesh.
 49. telemetry on the card (utils/telemetry.py device_tele_vec): one
     megabatch (key KEY49) of phases 5 (the bf16 head), 6 (BPOSD-E: B2),
     16 (OSD-CS: B7, B8), 25's v2 bf16 (B5's aux) and 28 (phenom,
     PHENOM49_ROUNDS rounds) and one fused bucket of phase 40
     (hgp_34_n225, one batch a cell), each through its telemetry-on graph
     under check_syncs: failures and min weight equal the telemetry-off
     run, one host read a megabatch, and the published counters
     (bp.shots, bp.converged, the bp.iterations histogram and sum,
     osd.device_shots == the BP-failed shots, the compaction tiers,
     osd.cs_candidates / cs_chunks) equal a host recount (numpy) of the
     same megabatch's decode aux run eagerly (_kernels.force_eager);
     printed: the counters, the mean iterations, the histogram
 50. the waterfall (utils/profiling.py): phase 5's run under
     profile_session, its graph captured again: results equal profiling
     off, the waterfall's stages (launch, host sync, gap) sum to the
     wall, the recorded graph cost's node count equals the capture's; a
     torch.profiler trace of one replay, summed by parse_trace, names the
     bp_minsum kernels phase 5 launches; the card's gates (smem_gates)
 51. warm restart from disk (utils/progcache.py's disk half): a process
     started beside phases 49-50 serves phase 45's n625 sessions
     (WARM51_SESSIONS, buckets WARM51_BUCKETS) with progcache.configure
     (dir) and stores their states and programs; a second fresh process
     from that directory serves the same rows: disk hits for every
     (session, bucket) and each state, no decoder state rebuilt, one
     recapture a bucket, every answer bit-exact with the first process;
     then, in this process, a truncated artifact is one load error,
     rebuilt and replaced
 52. the reference notebooks on the card through the port's
     compat.install(device="cuda"): (a) SpaceTimeDecodingDemo's import
     cell without matplotlib and networkx, then its cells 2-4 verbatim
     (hgp(ring_code(3), ring_code(3)), CodeSimulator_Circuit_SpaceTime
     with ST_BP_Decoder_Circuit and ST_BPOSD_Decoder_Circuit OSD-E 10,
     WordErrorRate(num_samples=10000)) and cell 5 (GenFaultHyperGraph);
     its rate printed beside the JAX package's executed output and the
     reference's, and its (failures, shots) equal to the port's direct
     engine built without the shims, bit for bit; (b) Single-Shot's
     cells 2-3 verbatim (the author's pickle paths through
     load_object_compat to codes_lib_tpu/; 4 codes x 4 p x 1000 runs,
     BPOSD OSD-E 10, max_iter N/10), the
     n625 cell at the first p equal to the direct CodeSimulator_DataError
     bit for bit; kernel 1 / the bf16 head and kernel 2 launched, no rung
     stepped; its launches join the kernels line's bp_minsum,
     bp_minsum_bf16 and osd_elim entries
 53. kernel 1's sector mode, the fused X/Z decode and the sweep monitor:
     (a) bp_minsum(sectors=) on hgp_34_n625's hz (+) hx (600 x 1250, two
     sectors), B53 syndromes of p=P53A errors, IT53 iterations: every
     output bit-exact against its plain version and against two kernel-1
     launches on hz and hx alone; its layout, the ms of one sector-mode
     launch against the two launches, the bound (both sectors'
     operations); (b) run_batch of CodeSimulator_DataError(fuse_sectors=
     True) on hgp_34_n625, BP-50 float32 (bp_kernel="xla": the pair takes
     no head), p=0.01, RUN53_BATCHES batches of RUN53_BATCH == the same
     run_batch without the pair, shot for shot; the sector mode's
     launches and the shots/s of both, and of the default decoders
     (bf16 head), with which fuse_sectors warns and builds no pair; (c) the sweep monitor on a fused
     EvalWER over hgp_34_n225 and n625 at MON53_P, MON53_SHOTS a cell,
     with a run ledger and telemetry on, two injected faults at the n625
     bucket's launch under a retry policy: one packed->dense rung, exactly
     one ladder_degrade anomaly naming the bucket's cells, each labelled
     with the rung, one substrate_mismatch, cell_progress events from both
     buckets, no other anomaly, every rate equal to the monitor-off run;
     then n625 at STALL53_P raises one stalled_convergence

The last line of standard output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
PKG = "qldpc_fault_tolerance_tpu_torch"
CODE = ROOT / "codes_lib_tpu" / "hgp_34_n625.npz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# H100 SXM 32-bit integer issue rate: 64 INT32 lanes per SM per clock, 132
# SMs, 1980 MHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit integer operations that one counter draw needs, counted from
# csrc/counter_gf2.cuh: 1 add of the qubit's counter word (the shot's word
# c0 + k0 is once per lane), the 20 rounds' add, rotate and xor less the last
# round's rotate and xor of x1 (dead: only x0 is returned), 9 adds of the key
# injections (the injected k + i depend on the key only), and the cut's 3
# compares and 2 logic ops
DRAW_OPS = 1 + (20 * 3 - 2) + 9 + (3 + 2)
SEED = 20261016
# (failures, min weight) of phases 21 and 25's int8 runs at SEED: the int8
# function's results, which a change to its kernels must keep
# (scripts/ab_int8_body.py gives them for two checkouts side by side)
INT8_RUNS = {"21": (212, 3), "25": (231, 3)}
# (failures, min weight) of phases 5, 22 and 26 (BP) and 6, 16 and 17 (BP +
# OSD, the deepened head) at SEED: the bf16 head's and kernel 1's results,
# which a change to the min-sum kernels must keep
# (scripts/ab_minsum_body.py gives them for two checkouts side by side)
# (phase 16 moved from (923, 6) when OSD-CS's planes took one stated
# summation order: 11 shots of its 16 sweeps change winner, each between two
# candidates of equal cost, which float32 rounding ordered; CHANGES.md names
# them, scripts/ab_cs_sweep.py --ties finds them)
MINSUM_RUNS = {"5": (187, 2), "22": (187, 2), "26": (184, 2), "6": (941, 6),
               "16": (924, 6), "17": (941, 6)}
# (failures, min weight) of phase 25's bf16 run at SEED: B5 bf16's results,
# which a change to its kernel must keep (scripts/ab_minsum_body.py gives
# them for two checkouts side by side)
BF16_RUNS = {"25": (216, 2)}
# (failures, min weight) of phases 28, 29 and 30's phenomenological runs at
# SEED: the phenom engine's results on the card, which a change to it or to
# its kernels must keep
PHENOM_RUNS = {"28": (8604, 6), "29": (777, 6), "30": (2781, 8)}
# (failures, min weight) of phases 32 and 33 (the phenomenological
# space-time engine), 34 and 36 (the circuit engines, whose weight slot is
# N) at
# SEED: their results on the card, which a change to them or to their
# kernels must keep
ST_RUNS = {"32": (8560, 6), "33": (1344, 6)}
CIRCUIT_RUNS = {"34": (236, 625), "36": (429, 625)}
# the phases that must read the host once a megabatch and never for a tier
SYNC_FREE = ("5", "6", "16", "25", "28", "29", "30", "32", "33", "34", "36")
# phase 36's cell: windows of ST36_REP cycles, ST36_CYCLES cycles in all
ST36_REP, ST36_CYCLES = 3, 13
# phase 37's replayed steps of each stream driver
STREAM_STEPS = 100
# phase 39's data threshold: EvalThreshold's estimate (its p-grid is
# logspace(0.4 est, 0.8 est, 6): 0.056..0.112, across the hgp_34 family's
# BPOSD-E crossing) and the shots of each of its 12 cells
SWEEP_EST, SWEEP_SHOTS = 0.14, 4 * 2048
# the key of the graph-against-eager megabatches and the target_failures run
GRAPH_KEY = (12, SEED)
# phases 28 and 31's eval_p (the Threshold notebook's phenomenological
# cell: p = 3/2 eval_p depolarizing, q = eval_p syndrome flips)
PHENOM_P = 0.02
# phases 32, 33 and 35's eval_p (the space-time cell of
# sweep/family_spacetime.py: p = 3/2 eval_p, q = eval_p) and phases 34-35's
# CX error rate p (SpaceTimeDecodingDemo's CX-only circuit noise)
ST_P = 0.01
CIRCUIT_P = 0.002
# phase 33's eval_p: with windows of 8 slices every shot fails at ST_P (128
# of 128 shots on the CPU); at 0.005 about a third do
ST33_P = 0.005
# phase 29's eval_p: at the Single-Shot notebook's 0.02 its FirstMin
# decoder 1 leaves every shot of 11 rounds failed; at 0.01 about 38% fail,
# so the pin still tells how well the path decodes
PHENOM29_P = 0.01
# the rounds of phase 31's phase-30 batch (phase 30 runs 9): each round
# decodes the same shapes, so two (one decoder-1 round, the final decoder 2)
# hold every kernel of the path against its plain version at a fraction of
# the plain run's minutes
PHENOM31_ROUNDS = 2
# phases 4 and 14 hold the elimination's three modes at these shots: 256,
# and the 512-shot straggler tier of phase 6's batches of 2048
ELIM_SHOTS = (256, 512)
# phase 27 holds the elimination's transform and device-memory modes on
# [H|I] of hgp_34_n1600 at these shots: its launch layouts at 256 and 512,
# and the 2048-shot tier that phase 30's decoder 1 launches
ELIM27_SHOTS = (256, 512, 2048)


# phases 42-44: the shot mesh.  Phase 42's key, its batches a logical
# device (phase 5's 16 batches split over the 2-entry mesh), the
# (failures, min weight) of its fused v2 run at MESH42_BATCHES x 4096 shots
# a device (the plain versions' result on the CPU, which the kernels give
# bit for bit), and the small run that the CPU repeats beside the card
# (MESH42_SMALL batches of 1024 shots a device)
# the plain PyTorch version of each kernel launch: the function its wrapper
# runs under _kernels.force_plain(), which every "== plain" check here uses
# (qldpc_fault_tolerance_tpu_torch/analysis/rules_kernels.py holds each
# wrapper to it)
PLAIN_VERSIONS = {
    "bp_minsum": "minsum_plain", "bp_minsum_bf16": "minsum_dense_plain",
    "bp_int8": "minsum_int8_plain", "gf2_sample": "sample_syndrome_plain",
    "gf2_residual": "residual_check_plain",
    "fused_decode": "fused_decode_plain",
    "fused_decode_int8": "fused_decode_plain",
    "osd_elim": "eliminate_plain", "osd_elim_full": "eliminate_plain",
    "osd_elim_percol": "eliminate_percol_plain",
    "cs_sweep": "cs_sweep_plain", "cs_sweep_rows": "cs_sweep_rows_plain",
    "bp_minsum_sectors": "minsum_plain"}
MESH42_KEY, MESH42_BATCHES, MESH42_SMALL = (42, SEED), 8, 1
MESH_RUNS = {"42 v2": (195, 2)}
# phase 43's mesh threshold runs MESH43_SCALE times phase 40's shots a
# cell, so its p_c's spread is about half of phase 40's
MESH43_SCALE = 4
# phase 44's grid across two processes: hgp_34_n225, these p, these shots
GRID44_P, GRID44_SHOTS = (0.02, 0.04, 0.06, 0.08), 2 * 2048
# a worker of phase 44 that has not finished by then is killed
GRID44_TIMEOUT = 300
# phases 45-46: the served storm.  Sessions n625_a/b/c (one bucket family,
# so their rounds fuse), n225 and n625_osd; request sizes drawn in
# SERVE_SIZES; the batcher's targets; every wait bounded by SERVE_TIMEOUT_S
SERVE_FAMILY_P = (0.01, 0.013, 0.016)
SERVE_N225_P = 0.01
SERVE_OSD_P = 0.05
SERVE_REQUESTS = 400
SERVE_V2_REQUESTS = 200
SERVE_RECOVERY_REQUESTS = 120
SERVE_AFTER_REQUESTS = 40
SERVE_SIZES = (32, 1024)
SERVE_MAX_BATCH = 4096
SERVE_MAX_WAIT_S = 0.002
SERVE_TIMEOUT_S = 300
SERVE_FUSED_ROWS = 1000
# phase 47: the fleet storm's requests, the chaos tick (collected answers)
# at which the host_kill fires, the gateway's scrape interval and deadman
# window on the card
FLEET_REQUESTS = 200
FLEET_KILL_AFTER = 60
FLEET_INTERVAL_S, FLEET_DOWN_AFTER_S = 0.1, 1.0
# phase 48: the data engine's ladder run (batches of 2048 at p 0.01, key
# FAULT48_KEY), the host OSD's oracle shots, and the share of BP-failed
# shots whose host (float64) and device (float32) OSD-E answers may differ
# on a float-tied candidate
FAULT48_KEY, FAULT48_BATCHES = (48, SEED), 4
FAULT48_ORACLE_SHOTS = 16
FAULT48_TIE_SHARE = 0.05
# phases 49-51: the key of phase 49's megabatches (and phase 50's run),
# the rounds of phase 49's phenom megabatch (phase 28 runs 9), phase 51's
# sessions (phase 45's n625 ones: name -> p), buckets, and the bound on
# each of its processes
KEY49 = (49, SEED)
PHENOM49_ROUNDS = 3
WARM51_SESSIONS = {"n625_a": 0.01, "n625_b": 0.013, "n625_c": 0.016,
                   "n625_osd": 0.05}
WARM51_BUCKETS = (256, 1024)
WARM51_TIMEOUT = 300


_T0 = time.time()


def circuit_st_sim(code, p: float, device, **kw):
    """Phase 36's engine without its decoders: CodeSimulator_Circuit_
    SpaceTime on ``code`` with SpaceTimeDecodingDemo's CX-only noise at
    ``p``, coloration schedule, windows of ST36_REP, ST36_CYCLES cycles."""
    from qldpc_fault_tolerance_tpu_torch.sim import \
        CodeSimulator_Circuit_SpaceTime

    return CodeSimulator_Circuit_SpaceTime(
        code=code, p=p, num_cycles=ST36_CYCLES, num_rep=ST36_REP,
        error_params={"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": p,
                      "p_idling_gate": 0},
        circuit_type="coloration", device=device, **kw)


def build_dem(root: str, code_path: str, p: float):
    """Phase 36's decoding graphs, built on the CPU (in a second process,
    while the card runs the earlier phases): (circuit_graph, h1_space_cor,
    seconds)."""
    sys.path.insert(0, root)
    from qldpc_fault_tolerance_tpu_torch.codes import load_code

    t = time.time()
    sim = circuit_st_sim(load_code(code_path), p, "cpu")
    sim._generate_circuit_graph()
    return sim.circuit_graph, sim.h1_space_cor, time.time() - t


def mesh42_cpu(root: str, code_path: str):
    """Phase 42's small fused v2 run on the CPU (in a second process, while
    the card runs the earlier phases): the 2-entry mesh through the plain
    versions, MESH42_SMALL batches of 1024 shots a device.  Returns
    (failures, min weight, shots, seconds)."""
    sys.path.insert(0, root)
    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.parallel import shot_mesh

    t = time.time()
    sim = mesh42_sim(load_code(code_path), "cpu", shot_mesh(["cpu"] * 2),
                     1024, "v2")
    sim.WordErrorRate(2 * MESH42_SMALL * 1024, key=MESH42_KEY)
    return (sim.last_failures, sim.min_logical_weight, sim.last_shots,
            time.time() - t)


def mesh42_sim(code, device, mesh, batch: int, fused=False):
    """Phase 42's engine: phase 5's (BP-50, p = 0.01, seed SEED) on
    ``mesh``."""
    import numpy as np

    from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

    p = 0.01
    probs = np.full(code.N, 2 * p / 3)
    return CodeSimulator_DataError(
        code=code, decoder_x=BPDecoder(code.hz, probs, 50, device=device),
        decoder_z=BPDecoder(code.hx, probs, 50, device=device),
        pauli_error_probs=[p / 3] * 3, seed=SEED, batch_size=batch,
        scan_chunk=8, fused_sampler=fused, device=device, mesh=mesh)


# phase 44's worker: one rank of a two-process grid (its argv: the port,
# the rank, the store's port and the backend)
GRID44_WORKER = r"""
import json, sys, time
root, rank, port, backend = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
import torch
import torch.distributed as dist
t0 = time.time()
dev = torch.device("cuda", rank if backend == "nccl" else 0)
torch.cuda.set_device(dev)
dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
from qldpc_fault_tolerance_tpu_torch.utils.observability import timings
spec = json.loads(sys.argv[5])
bp = BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)
fam = CodeFamily([load_code(spec["code"])], bp, bp, batch_size=2048,
                 seed=spec["seed"], device=dev)
t1 = time.time()
wer = fam.EvalWER("data", "Total", spec["p"], spec["shots"], if_plot=False,
                  shard_across_processes=True)
t2 = time.time()
print("RESULT" + json.dumps({
    "wer": wer.tolist(), "cells": timings().get("cell:data", {}).get(
        "count", 0), "device": str(dev), "start_s": t1 - t0,
    "grid_s": t2 - t1}), flush=True)
dist.destroy_process_group()
"""


def no_rungs(tag: str) -> None:
    """Fail if a degradation rung or a mesh replan (a ``mesh_replan`` rung)
    happened since the last ``clear_rungs`` (a phase that injected no
    fault must step none)."""
    from qldpc_fault_tolerance_tpu_torch.utils.resilience import \
        DegradationLadder

    if DegradationLadder.taken:
        raise AssertionError(
            f"phase {tag} injected no fault but stepped rungs "
            f"{dict(DegradationLadder.taken)}")


def clear_rungs() -> dict:
    """The rungs stepped since the last call, then zeroed."""
    from qldpc_fault_tolerance_tpu_torch.utils.resilience import \
        DegradationLadder

    out = dict(DegradationLadder.taken)
    DegradationLadder.taken.clear()
    return out


def cpu_model() -> str:
    """The host CPU's model as ``lscpu`` names it (x86 and Arm alike), and
    the machine's architecture."""
    import platform

    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.startswith("Model name")), "model not named")
    except (OSError, subprocess.SubprocessError):
        name = "lscpu failed"
    return f"{name} ({platform.machine()})"


def log(msg: str) -> None:
    """``msg`` with the seconds since the script started."""
    print(f"{msg} [{time.time() - _T0:.1f} s]", flush=True)


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def once_ms(fn):
    """``fn()`` and its device time, one call timed between CUDA events (no
    warm-up: for a plain version whose code has run before)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def in_mode(memory: str, fn):
    """``fn()`` with the min-sum and elimination kernels launched in
    ``memory`` (_kernels.MEMORY_MODES) instead of their layouts' pick."""
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels

    with _kernels.force_memory(memory):
        return fn()


def device_ms(fn, reps: int, kernel: str, tries: int = 5) -> float:
    """Mean device time per call of the kernels whose name holds ``kernel``,
    from torch.profiler over ``reps`` calls after one warm-up.  A profiler
    session now and then records the host's calls and none of the card's
    kernels (seen on the first session of a process, and once in three
    sessions in a row), so such a session is repeated, ``tries`` times at
    most; after that the calls are timed between CUDA events instead, and
    the log says so: around back-to-back calls of a kernel this short,
    events time the host's launch cost too, an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages()
                       if kernel in e.key)
        if total_us > 0:
            return total_us / reps / 1e3
    ms = event_ms(fn, reps)
    log(f"(the profiler recorded no device time for {kernel} in {tries} "
        f"sessions: {ms:.4f} ms between CUDA events, launch cost included)")
    return ms


def all_kernels_ms(fn, reps: int) -> float:
    """Mean device time per call of every kernel ``fn`` launches, from
    torch.profiler over ``reps`` calls after one warm-up (the kernels' own
    time, without the host's gaps between launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / reps / 1e3


def layout_text(bk, dev, B: int, m: int, n: int, bf16: bool) -> str:
    """The launch of csrc/bp_minsum.cu for B shots of an (m, n) code of
    row weight 7 and column weight 4 (ops/bp_kernel.py card_minsum_layout),
    with the card's resident blocks per SM."""
    lay = bk.card_minsum_layout(dev, B, m, n, 7, 4, bf16)
    return (f"{lay.lanes} shots x {lay.threads // lay.lanes} threads per "
            f"block, {lay.grid} blocks, {lay.resident} resident per SM, "
            f"{lay.smem_bytes} B shared memory")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bp_bound_ms(graph, B: int, iters_total: int | None,
                sector_work=None) -> tuple[float, str]:
    """Least time for the min-sum decode of these inputs: bytes of reading
    the syndromes, LLRs and graph once and writing the four outputs once,
    against the operations the decode does (per shot-iteration 11 per edge
    — 8 in the check pass, 2 in the variable pass, 1 in the parity pass —
    and 2 per variable) over ``iters_total`` shot-iterations.  The sector
    mode on a block-diagonal graph gives ``sector_work`` instead, one
    (shot-iterations, edges, variables) a sector, and writes its converged
    flags and iterations once a (shot, sector) item."""
    m, rw = graph.chk_nbr.shape
    n, cw = graph.var_nbr.shape
    outs = 1 if sector_work is None else len(sector_work)
    if sector_work is None:
        sector_work = [(iters_total, int(graph.chk_mask.sum()), n)]
    nbytes = (m * B + 4 * n + 5 * m * rw + 9 * n * cw      # inputs
              + n * B + 4 * n * B + outs * B + 4 * outs * B)  # outputs
    ops = sum(it * (11 * e + 2 * v) for it, e, v in sector_work)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# Operations of one int8 min-sum shot-iteration (csrc/bp_int8.cu's
# algorithm, each step counted once): per edge 7 integer operations (the
# check update's abs, compare, two selects and sign on raw int8 magnitudes;
# the scatter's add; the parity xor) and 20 float32 operations (c2v: select,
# convert, two multiplies, sign; its |c| and max; its quantization: divide,
# two clamps, round; the gather's convert, fused multiply-add and compare;
# the new v2c's |v| and max; its quantization: 4); per variable 4 float32
# operations (convert, fused multiply-add, bf16 rounding, compare).
INT8_EDGE_INT_OPS, INT8_EDGE_FP_OPS, INT8_VAR_FP_OPS = 7, 20, 4


def int8_bound_ms(sgraph, B: int, shot_iters: int) -> tuple[float, str]:
    """Least time for B6 on these inputs: syndromes, LLRs and index planes
    read once, the four outputs written once, against the operations of
    ``shot_iters`` shot-iterations (every shot of a tile iterates while its
    tile does: the scales need them all)."""
    rw, m, n = sgraph.rw, sgraph.m, sgraph.n
    edges = int((sgraph.mask > 0).sum())
    nbytes = (m * B + 4 * n + 8 * rw * m + 4 * sgraph.var_edge.numel()
              + n * B + 4 * n * B + B + 4 * B)
    return roofline_ms(nbytes, shot_iters * INT8_EDGE_INT_OPS * edges,
                       shot_iters * (INT8_EDGE_FP_OPS * edges
                                     + INT8_VAR_FP_OPS * n))


def int8_shot_iters(iters, block_b: int, head_iters: int,
                    early_stop: bool) -> int:
    """Shot-iterations B6 runs: each tile of ``block_b`` shots iterates to
    head_iters, or with early exit until its slowest shot converges."""
    if not early_stop:
        return iters.numel() * head_iters
    return int(iters.reshape(-1, block_b).amax(dim=1).sum()) * block_b


def message_bytes(graph) -> int:
    """Message bytes one live shot-iteration of the min-sum algorithm moves:
    16 per edge (v2c read and c2v write in the check pass, c2v read and v2c
    write in the variable pass), 1 per edge for the parity pass's hard
    decisions, 5 per variable (posterior and hard decision written) and 2
    per check (the syndrome read twice) — in device memory unless a kernel
    keeps the messages on chip."""
    m = graph.chk_nbr.shape[0]
    n = graph.var_nbr.shape[0]
    edges = int(graph.chk_mask.sum())
    return 17 * edges + 5 * n + 2 * m


def elim_bound_ms(n: int, m: int, B: int, out_words: int,
                  word_ops: int) -> tuple[float, str]:
    """Least time for an elimination of these inputs: bytes of the
    permutation (int64), the syndromes and the column-packed H read once and
    the ``out_words`` int32 words per shot that the kernel writes written
    once, against the word operations the column-by-column elimination
    needs (``elimination_work``, at the float32 scalar rate)."""
    nbytes = 8 * B * n + 4 * B * m + 4 * n * (-(-m // 32)) + 4 * B * out_words
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, word_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def elim_layout_text(tod, dev, B: int, m: int, n: int, fcap: int,
                     mode: str) -> str:
    """The launch of csrc/osd_elim.cu for B shots (ops/osd_device.py
    card_elim_layout), with the card's resident blocks per SM."""
    lay = tod.card_elim_layout(dev, B, m, n, fcap, mode)
    return (f"{mode}: {lay.threads} threads per shot, {lay.grid} blocks, "
            f"{lay.resident} resident per SM, {lay.smem_bytes} B shared memory")


def sweep_rows_bound_ms(x, w: int) -> tuple[float, str]:
    """Least time for B8 with its planes on these inputs (ops/osd_cs_device
    SweepInputs): per shot the words of its r* pivot rows that hold a free
    column, the pivot rows' indices and signed costs, the free columns'
    costs and positions (int64) and the base read once, cost and index
    written once, against the float32 adds the planes need (one per set
    bit of T at a free column, one per pivot row with both of a pair's
    bits set, the free columns' costs) and the sweep's 2 per weight-1
    candidate and 5 per pair."""
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod

    r, B = x.pr.shape
    f = x.free_perm.shape[0]
    npairs = w * (w - 1) // 2
    words = torch.zeros((x.packed.shape[0], B), dtype=torch.bool,
                        device=x.free_perm.device)
    words.scatter_(0, x.free_perm >> 5, True)
    t = tod._reduced_bits(tod.pivot_rows(x.packed, x.pr), x.free_perm)
    pairs = [(a, b) for a in range(w) for b in range(a + 1, w)]
    both = sum(int((t[a] & t[b]).sum()) for a, b in pairs)
    nbytes = (4 * r * int(words.sum()) + 8 * r * B + 12 * f * B + 4 * B
              + 8 * B)
    fp_ops = int(t.sum()) + both + f * B + B * (2 * f + 5 * npairs)
    return roofline_ms(nbytes, 0, fp_ops)


def sweep_bound_ms(f: int, w: int, B: int) -> tuple[float, str]:
    """Least time for B8: dplane, the w*(w-1)/2 rows of xflat that the
    pairs read and the base read once, cost and index written once, against
    2 float32 operations per weight-1 candidate (add, compare) and 5 per
    pair (two adds, a multiply, a subtract, a compare)."""
    nbytes = 4 * B * (f + w * (w - 1) // 2 + 1) + 8 * B
    return roofline_ms(nbytes, 0, B * (2 * f + 5 * (w * (w - 1) // 2)))


def roofline_ms(nbytes: float, int_ops: float,
                fp_ops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations over
    their type's peak rate (integer and float32 times added)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT32_OPS_PER_S + fp_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def logical_failures(spec, key, B: int, corx_p, corz_p) -> int:
    """Shots of batch ``key`` whose residual under the packed corrections
    fails a logical check in either sector (plain PyTorch)."""
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
    from qldpc_fault_tolerance_tpu_torch.ops.gf2_packed import (
        packed_parity_apply,
        unpack_shots,
    )

    exp, ezp, _, _ = gk.sample_syndrome_plain(spec, key, B)
    fx = packed_parity_apply(spec.lz_nbr, spec.lz_mask, exp ^ corx_p)
    fz = packed_parity_apply(spec.lx_nbr, spec.lx_mask, ezp ^ corz_p)
    return int(unpack_shots(torch.cat([fx, fz], dim=1), B).any(dim=1).sum())


def adjacency_stats(nbr, mask) -> tuple[int, int]:
    """(bytes of an int32 neighbour table and its bool mask, nonzeros)."""
    return 5 * nbr.numel(), int(mask.sum())


def sample_bound_ms(spec, B: int, emit_errors: bool) -> tuple[float, str]:
    """Least time for B3: the adjacencies of hx and hz read once, the packed
    words written once, against one draw per (shot, qubit) and one XOR per
    check nonzero per word."""
    W, n = -(-B // 32), spec.n
    (bx, ex), (bz, ez) = (adjacency_stats(spec.hx_nbr, spec.hx_mask),
                          adjacency_stats(spec.hz_nbr, spec.hz_mask))
    mx, mz = spec.hx_nbr.shape[0], spec.hz_nbr.shape[0]
    nbytes = bx + bz + 4 * W * (mx + mz + (2 * n if emit_errors else 0))
    return roofline_ms(nbytes, B * n * DRAW_OPS + W * (ex + ez))


def residual_bound_ms(spec, B: int, logical_failures: int) -> tuple[float, str]:
    """Least time for B4: the corrections and the four adjacencies read
    once, the (W, 2) partials written once, against one draw per (shot,
    qubit), the XOR of each correction word, one XOR per check nonzero per
    word, and the weights of the shots that fail a logical check (2
    operations per qubit per sector: extract the shot's bit, add)."""
    W, n = -(-B // 32), spec.n
    adj = [adjacency_stats(getattr(spec, f"{a}_nbr"), getattr(spec, f"{a}_mask"))
           for a in ("hx", "hz", "lx", "lz")]
    nbytes = 8 * W * n + sum(b for b, _ in adj) + 8 * W
    ops = (B * n * DRAW_OPS + 2 * W * n + W * sum(e for _, e in adj)
           + 4 * n * logical_failures)
    return roofline_ms(nbytes, ops)


# Float32 operations of one bf16 min-sum shot-iteration (csrc/minsum_body.cuh
# with Bf16Msg, each step counted once): per edge 13 (the check pass's 8 as
# kernel 1's; the scatter's bf16 rounding of c2v and its add; the new v2c's
# subtract and bf16 rounding; the parity's compare) and per variable 3 (the
# add onto the channel LLR, the bf16 rounding of the total, the hard
# decision's compare).
BF16_EDGE_FP_OPS, BF16_VAR_FP_OPS = 13, 3


def fused_bound_ms(spec, B: int, shot_iters_z: int, shot_iters_x: int,
                   quantize) -> tuple[float, str]:
    """Least time for B5 in one message mode: the 16-bit planes (or int8
    index planes), the four check adjacencies and the LLRs read once, the per-shot
    flags and the partials written once, against the integer work of the
    draws (DRAW_OPS each, one per (shot, qubit): the function needs each
    error once, though the int8 mode draws it again for the residual
    checks), both syndromes and the residual checks (one operation per
    nonzero per shot) and the residual XOR (1 per qubit per sector per
    shot), and the decodes' shot-iterations: BF16_* operations per edge and
    per variable, or B6's INT8_* counts."""
    base = spec.base
    n = base.n
    adj = [adjacency_stats(getattr(base, f"{a}_nbr"), getattr(base, f"{a}_mask"))
           for a in ("hx", "hz", "lx", "lz")]
    graphs = (spec.sparse_z, spec.sparse_x)
    if quantize is None:  # the 16-bit planes: check slots, edges and slots
        g_bytes = sum(2 * g.chk_idx.numel() + 3 * g.var_edge.numel()
                      for g in graphs)
    else:
        g_bytes = sum(8 * g.chk_idx.numel() + 4 * g.var_edge.numel() for g in graphs)
    edges = [int((g.mask > 0).sum()) for g in graphs]
    nbytes = (g_bytes + sum(b for b, _ in adj) + 8 * n + 10 * B
              + 8 * (-(-B // 8)))
    (_, e_hx), (_, e_hz), (_, e_lx), (_, e_lz) = adj
    int_ops = B * (n * DRAW_OPS + 2 * (e_hx + e_hz) + e_lx + e_lz + 2 * n)
    fp_ops = 0
    for si, e in ((shot_iters_z, edges[0]), (shot_iters_x, edges[1])):
        if quantize is None:
            fp_ops += si * (BF16_EDGE_FP_OPS * e + BF16_VAR_FP_OPS * n)
        else:
            int_ops += si * INT8_EDGE_INT_OPS * e
            fp_ops += si * (INT8_EDGE_FP_OPS * e + INT8_VAR_FP_OPS * n)
    return roofline_ms(nbytes, int_ops, fp_ops)


# phase 41's rare-event grid: three sub-threshold rungs of hgp_34_n625
# (eval_p, the channel 3/2 eval_p), each tilted to twice its channel's
# total rate, and the shots of each rung
RARE_P, RARE_TILT, RARE_SHOTS = (0.004, 0.008, 0.016), 2.0, 8 * 2048


def fused_and_rare_phases(ctx) -> dict:
    """Phases 40 and 41 (module docstring) on ``ctx.dev``: ``ctx`` holds
    phase 39's codes, decoder classes, threshold (``pc``, its ledger
    record ``rec``) and helpers (``counted``, ``ledger_run``), phase 5's
    simulator, the batch size and the shots.  Returns their launches
    ``{"40": ..., "41": ...}``."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.parallel.shots import check_syncs
    from qldpc_fault_tolerance_tpu_torch.rare import (
        eval_rare_grid,
        tilt_channel,
    )
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError
    from qldpc_fault_tolerance_tpu_torch.sim import common as simc
    from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
    from qldpc_fault_tolerance_tpu_torch.sweep.fused import eval_cells_fused
    from qldpc_fault_tolerance_tpu_torch.utils import telemetry

    dev = ctx.dev
    cuda = dev.type == "cuda"

    def start():
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        return time.time()

    def stop(t0):
        if cuda:
            torch.cuda.synchronize(dev)
        return time.time() - t0

    def peak():
        return (torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda
                else float("nan"))

    def need(names, launches, tag):
        for name in names:
            if cuda and launches[name] <= 0:
                raise AssertionError(f"phase {tag} launched no {name}")

    # 40. phase 39's threshold on the fused path (fused="auto", the
    # default): one bucket a code, one graph a bucket
    t_new = time.time()
    fam = CodeFamily(ctx.codes, ctx.dec1, ctx.dec2, batch_size=ctx.batch,
                     seed=ctx.seed, device=dev)
    telemetry.reset()
    telemetry.enable()
    try:
        t0 = start()
        with check_syncs():
            pc, rec, launches40 = ctx.ledger_run(
                lambda tmp: fam.EvalThreshold(
                    "data", "Total", "extrapolation", ctx.est, ctx.shots,
                    ledger=tmp, fused="auto"))
        wall = stop(t0)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    buckets = list(eval_cells_fused.buckets)

    def cells_of(record):
        return [(c["cell"]["code"], round(c["cell"]["p"], 12),
                 c["failures"], c["shots"]) for c in record["cells"]]

    cells = cells_of(rec)
    if cells != cells_of(ctx.rec) or pc != ctx.pc:
        raise AssertionError(f"phase 40: fused cells {cells}, p_c {pc}; "
                             f"phase 39's {cells_of(ctx.rec)}, {ctx.pc}")
    if snap.get("sweep.fused_fallback_cells", {}).get("value", 0) \
            or snap["sweep.fused_cells"]["value"] != len(cells) \
            or len(buckets) != len(ctx.codes):
        raise AssertionError(f"phase 40: fused counters {snap}, buckets "
                             f"{buckets}")
    for b in buckets:
        if (cuda and b["graphs"] != 1) or b["host_reads"] > b["megabatches"]:
            raise AssertionError(f"phase 40 bucket {b}: one captured graph "
                                 f"and one host read a megabatch at most")
    need(("bp_minsum_bf16", "osd_elim"), launches40, "40")
    shots40 = sum(c[3] for c in cells)
    log(f"[40] CodeFamily.EvalThreshold(fused='auto'): {len(cells)} cells "
        f"== phase 39's (failures, shots) cell by cell, p_c {pc:.6f} == "
        f"phase 39's; {wall:.2f} s ({shots40 / wall:.1f} shots/s with the "
        f"builds and captures; phase 39's serial loop {ctx.wall39:.2f} s); "
        "buckets " + "; ".join(
            f"{b['cells']} cells, {b['megabatches']} megabatch(es), "
            f"{b['host_reads']} host read(s), {b['graphs']} graph(s) of "
            f"{b['nodes']} nodes, build {b['build_s']:.2f} s, capture "
            f"{b['capture_s'] or 0:.2f} s, peak "
            f"{b.get('peak_gib', float('nan')):.2f} GiB" for b in buckets)
        + f"; launches {launches40}")

    # one bucket (the last code's cells) launched twice: with its capture,
    # then replayed; both runs equal phase 40's cells
    ci = len(ctx.codes) - 1
    code = ctx.codes[ci]
    p_list = sorted({c["cell"]["p"] for c in rec["cells"]})
    bucket = [(i, ci, code, p) for i, p in enumerate(p_list)]
    want = [c[2:] for c in cells[-len(p_list):]]
    prog = fam._data_bucket_program(bucket, "Total", ctx.shots)
    times = []
    for _ in range(2):
        t0 = start()
        with check_syncs():
            failures, shots, _ = simc.fused_cell_finish(
                simc.fused_cell_launch(prog)[0])
        times.append(stop(t0))
        if [(int(f), int(n)) for f, n in zip(failures, shots)] != want:
            raise AssertionError(f"phase 40 bucket run {failures} {shots} "
                                 f"!= the threshold's {want}")
    n_shots = int(np.sum(shots))
    log(f"[40] {code.name or code.N} bucket of {len(p_list)} cells alone: "
        f"{n_shots} shots, {n_shots / times[0]:.1f} shots/s with its "
        f"capture ({times[0]:.2f} s), {n_shots / times[1]:.1f} replayed "
        f"({times[1]:.3f} s), graph {prog.driver.graph_stats}, peak "
        f"{peak():.2f} GiB")
    prog.release()

    # one fused megabatch (one batch a cell) equal to itself with every
    # kernel replaced by its plain version
    bucket0 = [(i, 0, ctx.codes[0], p) for i, p in enumerate(p_list)]
    runs = []
    for plain in (False, True):
        prog = fam._data_bucket_program(bucket0, "Total", ctx.batch)
        with (_kernels.force_plain() if plain else check_syncs()):
            runs.append(tuple(tuple(int(x) for x in a) for a in
                              simc.fused_cell_finish(
                                  simc.fused_cell_launch(prog)[0])))
        prog.release()
    if runs[0] != runs[1]:
        raise AssertionError(f"phase 40 fused megabatch: kernels {runs[0]}, "
                             f"plain {runs[1]}")
    log(f"[40] one fused megabatch ({len(p_list)} lanes x 1 batch of "
        f"{ctx.batch} on {ctx.codes[0].name or ctx.codes[0].N}): (failures, "
        f"shots, min_w) {runs[0]} == with every kernel replaced by its "
        f"plain version")
    log(f"phase 40 took {time.time() - t_new:.1f} s")

    # 41. rare-event estimation: WeightedWordErrorRate at zero tilt on
    # phase 5's simulator, then a weighted fused rung ladder
    t_new = time.time()
    sim5 = ctx.sim5
    n5 = ctx.shots5
    out = []
    for key in ((41, ctx.seed), (42, ctx.seed)):
        t0 = start()
        with check_syncs():
            sim5.min_logical_weight = sim5.N
            sim5.WeightedWordErrorRate(n5, key=key)
        out.append((sim5.last_weighted, stop(t0), sim5.last_host_reads))
    ws, wall_w, reads_w = out[0]
    with check_syncs():
        sim5.min_logical_weight = sim5.N
        sim5.WordErrorRate(n5, key=(41, ctx.seed))
    direct = (sim5.last_failures, sim5.last_shots, sim5.min_logical_weight)
    if (ws.failures, ws.shots, ws.min_w) != direct or ws.s1 != ws.failures \
            or ws.w1 != ws.shots or ws.s2 != ws.failures:
        raise AssertionError(f"phase 41 zero tilt: {ws} != WordErrorRate's "
                             f"{direct}")
    log(f"[41] WeightedWordErrorRate at zero tilt on phase 5's simulator: "
        f"(failures, shots, min_w) {direct} == WordErrorRate's, s1 = "
        f"{ws.s1} and w1 = {ws.w1} (the uniform limit); {n5 / wall_w:.1f} "
        f"shots/s with its capture ({wall_w:.2f} s), {n5 / out[1][1]:.1f} "
        f"replayed ({out[1][1]:.3f} s), {reads_w} host read(s), peak "
        f"{peak():.2f} GiB")

    code = ctx.codes[-1]
    tilts = [RARE_TILT * 1.5 * p for p in RARE_P]
    t0 = start()
    with check_syncs():
        points, launches41 = ctx.counted(lambda: eval_rare_grid(
            code, ctx.rare_class, RARE_P, ctx.rare_shots, q_total=tilts,
            batch_size=ctx.batch, seed=ctx.seed, device=dev))
    wall_r = stop(t0)
    peak_r = peak()
    need(("bp_minsum_bf16",), launches41, "41")
    for p, q, pt in zip(RARE_P, tilts, points):
        p_ch = p * 3 / 2
        sim = CodeSimulator_DataError(
            code=code,
            decoder_x=ctx.rare_class.GetDecoder({"h": code.hz, "p_data": p}),
            decoder_z=ctx.rare_class.GetDecoder({"h": code.hx, "p_data": p}),
            pauli_error_probs=[p_ch / 3] * 3, batch_size=ctx.batch,
            seed=ctx.seed, device=dev)
        with check_syncs():
            sim.WeightedWordErrorRate(
                ctx.rare_shots,
                tilt_probs=tilt_channel(sim.channel_probs, q))
        a, b = sim.last_weighted, pt["stats"]
        if (a.failures, a.shots, a.min_w) != (b.failures, b.shots, b.min_w) \
                or not np.allclose([b.s1, b.s2, b.w1, b.w2],
                                   [a.s1, a.s2, a.w1, a.w2], rtol=1e-6,
                                   atol=0):
            raise AssertionError(f"phase 41 rung p={p}: fused {b} != serial "
                                 f"{a}")
        if not (np.isfinite(pt["wer"]) and b.failures > 0):
            raise AssertionError(f"phase 41 rung p={p}: {pt}")
        simc.release_graphs(sim)
    log(f"[41] eval_rare_grid on {code.name or code.N} with BP "
        f"({ctx.rare_class.decoder_default_params}), {len(RARE_P)} rungs "
        f"of {ctx.rare_shots} shots, fused weighted == serial "
        f"WeightedWordErrorRate rung by rung (counts exact, moments to "
        f"1e-6): " + "; ".join(
            f"eval_p {p} tilt {q:.4f}: WER {pt['wer']:.4e} +- "
            f"{pt['wer_eb']:.2e}, rse {pt['rse']}, ESS {pt['ess']:.1f}, "
            f"{pt['stats'].failures} raw failures"
            for p, q, pt in zip(RARE_P, tilts, points))
        + f"; {wall_r:.2f} s for the ladder "
        f"({len(RARE_P) * ctx.rare_shots / wall_r:.1f} shots/s with its "
        f"capture), peak {peak_r:.2f} GiB; launches {launches41}")
    log(f"phase 41 took {time.time() - t_new:.1f} s")
    return {"40": launches40, "41": launches41}


def mesh_phases(ctx) -> dict:
    """Phases 42-44 (module docstring) on ``ctx.dev``: ``ctx`` holds the
    hgp_34_n625 code, phase 39's codes, decoder classes and fit, phase
    5's run, the helpers (``counted``, ``ledger_run``) and the future of
    phase 42's CPU run.  Returns their launches."""
    import socket

    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
    from qldpc_fault_tolerance_tpu_torch.parallel import shot_mesh
    from qldpc_fault_tolerance_tpu_torch.parallel.shots import check_syncs
    from qldpc_fault_tolerance_tpu_torch.sim import common as simc
    from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
    from qldpc_fault_tolerance_tpu_torch.sweep.fused import eval_cells_fused

    dev = ctx.dev
    n_cards = torch.cuda.device_count()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    def reset(devices):
        for d in dict.fromkeys(devices):
            torch.cuda.reset_peak_memory_stats(d)

    def peaks(devices) -> str:
        return ", ".join(
            f"{d} {torch.cuda.max_memory_allocated(d) / 2 ** 30:.2f} GiB"
            for d in dict.fromkeys(devices))

    def graphs(sim) -> int:
        return sum(len(drv._graphs) for _, rep in sim._mesh_replicas.values()
                   for drv in rep._drivers.values())

    def per_device(sim) -> str:
        return "; ".join(
            f"{r['device']}: {r['megabatches']} megabatch(es), "
            f"{r['host_reads'] / r['megabatches']:.0f} host read(s) a "
            f"megabatch, graph of " + (
                f"{r['graph']['nodes']} nodes" if r["graph"] else "(cached)")
            for r in sim.last_mesh)

    def run(sim, shots, key=MESH42_KEY):
        with check_syncs():
            sim.min_logical_weight = sim.N
            sim.WordErrorRate(shots, key=key)
        return sim.last_failures, sim.min_logical_weight, sim.last_shots

    def replay_of(make, shots, key=MESH42_KEY):
        sim = make()
        sim.degrade_mesh()
        return run(sim, shots, key)

    # 42. phase 5's run on a 2-entry mesh on one card, then its replay
    t_new = time.time()
    mesh2 = shot_mesh([dev, dev])
    shots42 = mesh2.size * MESH42_BATCHES * 4096
    sim42 = mesh42_sim(ctx.code, dev, mesh2, 4096)
    reset(mesh2.devices)
    (got42, wall42), launches42 = ctx.counted(
        lambda: timed(lambda: run(sim42, shots42)))
    text42, peak42 = per_device(sim42), peaks(mesh2.devices)
    _, wall42r = timed(lambda: run(sim42, shots42, key=(43, SEED)))
    want42 = replay_of(lambda: mesh42_sim(ctx.code, dev, mesh2, 4096),
                       shots42)
    if got42 != want42 or got42[2] != shots42:
        raise AssertionError(f"phase 42: mesh {got42} != its replay "
                             f"{want42}")
    if launches42["bp_minsum_bf16"] <= 0:
        raise AssertionError(f"phase 42 launched no bf16 head: {launches42}")
    f5, f42 = ctx.run5[0] / ctx.shots5, got42[0] / shots42
    sigma42 = (f5 * (1 - f5) / ctx.shots5 + f42 * (1 - f42) / shots42) ** 0.5
    if abs(f42 - f5) > 4 * sigma42:
        raise AssertionError(f"phase 42: failures {got42[0]}/{shots42} "
                             f"outside 4 sigma of phase 5's {ctx.run5[0]}/"
                             f"{ctx.shots5}")
    log(f"[42] phase 5's run on shot_mesh([{dev}, {dev}]) ({MESH42_BATCHES} "
        f"x 4096 shots a logical device): (failures, min_w, shots) {got42} "
        f"== its degrade_mesh() replay on one device; failure rate "
        f"{f42:.4e} vs phase 5's {f5:.4e}: |diff| {abs(f42 - f5):.3e} <= 4 "
        f"sigma {4 * sigma42:.3e}; {shots42 / wall42:.1f} shots/s with the "
        f"captures ({wall42:.2f} s), {shots42 / wall42r:.1f} replayed "
        f"({wall42r:.3f} s); {graphs(sim42)} graphs; {text42}; peak "
        f"{peak42}; launches {launches42}")

    # the fused v2 counter-PRNG engine on the same mesh: pinned, its
    # replay, and a small run equal to the CPU's through the plain versions
    simv = mesh42_sim(ctx.code, dev, mesh2, 4096, "v2")
    (gotv, wallv), launches42v = ctx.counted(
        lambda: timed(lambda: run(simv, shots42)))
    wantv = replay_of(lambda: mesh42_sim(ctx.code, dev, mesh2, 4096, "v2"),
                      shots42)
    if gotv != wantv or gotv[:2] != MESH_RUNS["42 v2"]:
        raise AssertionError(f"phase 42 v2: mesh {gotv}, replay {wantv}, "
                             f"pinned {MESH_RUNS['42 v2']}")
    if launches42v["fused_decode"] <= 0:
        raise AssertionError(f"phase 42 v2 launched no fused decode: "
                             f"{launches42v}")
    small = run(mesh42_sim(ctx.code, dev, mesh2, 1024, "v2"),
                2 * MESH42_SMALL * 1024)
    cpu = ctx.cpu42.result()
    if small != tuple(cpu[:3]):
        raise AssertionError(f"phase 42 v2: card {small} != CPU {cpu}")
    log(f"[42] fused_sampler='v2' on the same mesh: (failures, min_w, "
        f"shots) {gotv} == its replay == pinned {MESH_RUNS['42 v2']}; "
        f"{shots42 / wallv:.1f} shots/s with the captures ({wallv:.2f} s); "
        f"{MESH42_SMALL} x 1024 shots a device {small} == the CPU's plain "
        f"versions ({cpu[3]:.1f} s there); launches {launches42v}")

    if n_cards >= 2:
        mesh_n = shot_mesh()
        shots_n = n_cards * MESH42_BATCHES * 4096
        sim_n = mesh42_sim(ctx.code, dev, mesh_n, 4096)
        reset(mesh_n.devices)
        got_n, wall_n = timed(lambda: run(sim_n, shots_n))
        _, wall_nr = timed(lambda: run(sim_n, shots_n, key=(43, SEED)))
        want_n = replay_of(lambda: mesh42_sim(ctx.code, dev, mesh_n, 4096),
                           shots_n)
        if got_n != want_n:
            raise AssertionError(f"phase 42 on {n_cards} cards: {got_n} != "
                                 f"its replay {want_n}")
        log(f"[42] shot_mesh() over {n_cards} cards: {got_n} == its replay "
            f"on {dev}; {shots_n / wall_nr:.1f} shots/s in all, "
            f"{shots_n / n_cards / wall_nr:.1f} a card, replayed "
            f"({wall_nr:.3f} s; {shots_n / wall_n:.1f} with the captures); "
            f"{per_device(sim_n)}; peak {peaks(mesh_n.devices)}")
    else:
        log("[42] one card: the mesh over every card is not run")
    log(f"phase 42 took {time.time() - t_new:.1f} s")

    # 43. phase 40's threshold on the 2-entry mesh, then its n625 bucket
    # alone and its replay
    t_new = time.time()
    fam = CodeFamily(ctx.codes, ctx.dec1, ctx.dec2, batch_size=2048,
                     seed=SEED, device=dev, mesh=mesh2)
    shots43 = MESH43_SCALE * SWEEP_SHOTS
    reset(mesh2.devices)
    (pc43, rec43, launches43), wall43 = timed(lambda: ctx.ledger_run(
        lambda tmp: fam.EvalThreshold("data", "Total", "extrapolation",
                                      SWEEP_EST, shots43, ledger=tmp,
                                      fused="auto")))
    buckets = list(eval_cells_fused.buckets)
    lo, hi = ctx.fit["pc_ci"]
    def by_cell(record):
        return {(c["cell"]["code"], round(c["cell"]["p"], 12)): c
                for c in record["cells"]}

    cells40, cells43 = by_cell(ctx.rec), by_cell(rec43)
    if cells43.keys() != cells40.keys() or any(
            cells43[k]["shots"] != MESH43_SCALE * cells40[k]["shots"]
            for k in cells40):
        raise AssertionError(f"phase 43 cells' shots {rec43['cells']}")
    # every cell's failure rate against phase 40's: a two-proportion z on
    # the pooled rate.  (p_c itself is no test here: phase 40's top n625
    # cell failed all its shots, which the WER transform maps to 1, and the
    # extrapolation fit follows that one cell; its bootstrap replicates
    # all keep it at 1, so its CI does not cover a grid where the cell
    # does not saturate.)
    zs = []
    for a, b in ((cells40[k], cells43[k]) for k in cells40):
        pool = (a["failures"] + b["failures"]) / (a["shots"] + b["shots"])
        var = pool * (1 - pool) * (1 / a["shots"] + 1 / b["shots"])
        diff = b["failures"] / b["shots"] - a["failures"] / a["shots"]
        zs.append(diff / var ** 0.5 if var > 0 else 0.0)
    if max(abs(z) for z in zs) > 4:
        raise AssertionError(f"phase 43: cells' failure rates against "
                             f"phase 40's, z {zs}")
    if dev.type == "cuda" and any(b["graphs"] != mesh2.size
                                  for b in buckets):
        raise AssertionError(f"phase 43 buckets {buckets}: one graph a "
                             f"device")
    log(f"[43] the threshold on the mesh ({MESH43_SCALE} x phase 40's "
        f"shots a cell): every cell's failure rate within 4 sigma of "
        f"phase 40's (z {', '.join(f'{z:+.2f}' for z in zs)}); p_c "
        f"{pc43:.5f} against phase 40's {ctx.fit['p_c']:.5f}, bootstrap "
        f"CI [{lo:.5f}, {hi:.5f}]: "
        + ("inside" if lo <= pc43 <= hi else "outside") + "; cells "
        + "; ".join(f"{c['cell']['code']} p={c['cell']['p']:.4f} "
                    f"{c['failures']}/{c['shots']} WER {c['wer']:.4e}"
                    for c in rec43["cells"])
        + f"; {wall43:.2f} s "
        f"({sum(c['shots'] for c in rec43['cells']) / wall43:.1f} shots/s "
        "with the builds and captures); buckets " + "; ".join(
            f"{b['cells']} cells, {b['megabatches']} megabatches, "
            f"{b['host_reads']} host reads, {b['graphs']} graphs of "
            f"{b['nodes']} nodes, peak {b.get('peak_gib_devices')}"
            for b in buckets) + f"; launches {launches43}")

    ci = len(ctx.codes) - 1
    p_list = sorted({c["cell"]["p"] for c in ctx.rec["cells"]})
    bucket = [(i, ci, ctx.codes[ci], p) for i, p in enumerate(p_list)]
    runs43 = []
    for degraded in (False, True):
        prog = fam._data_bucket_program(bucket, "Total", 2 * SWEEP_SHOTS,
                                        mesh2)
        if degraded:
            prog.driver.degrade_mesh()
        with check_syncs():
            host, wall = timed(lambda prog=prog: simc.fused_cell_finish(
                simc.fused_cell_launch(prog)[0]))
        runs43.append((tuple(tuple(int(x) for x in a) for a in host), wall,
                       prog.n_batches, len(prog.driver._graphs)))
        prog.release()
    (cells43, wall_m, n_b, g_m), (cells43r, wall_r, _, g_r) = runs43
    want_shots = tuple(2 * cells40[(ctx.codes[ci].name, round(p, 12))][
        "shots"] for p in p_list)
    if cells43 != cells43r or cells43[1] != want_shots \
            or set(cells43[1]) != {n_b * 2048 * mesh2.size}:
        raise AssertionError(f"phase 43 bucket: mesh {cells43}, replay "
                             f"{cells43r}, phase 40's shots x 2 "
                             f"{want_shots}")
    n43 = sum(cells43[1])
    log(f"[43] {ctx.codes[ci].name or ctx.codes[ci].N} bucket of "
        f"{len(p_list)} cells on the mesh: {n_b} lane-batches of 2048 x "
        f"{mesh2.size} a cell, shots {cells43[1]} (phase 40's x 2), "
        f"failures {cells43[0]}, min_w {cells43[2]} == its degrade_mesh() "
        f"replay; {n43 / wall_m:.1f} shots/s with its {g_m} captures "
        f"({wall_m:.2f} s), replay {n43 / wall_r:.1f} ({wall_r:.2f} s, "
        f"{g_r} graph)")
    log(f"phase 43 took {time.time() - t_new:.1f} s")

    # 44. a sweep grid across two processes
    t_new = time.time()
    backend = "nccl" if n_cards >= 2 else "gloo"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    n225 = str(ROOT / "codes_lib_tpu" / "hgp_34_n225.npz")
    spec = json.dumps({"code": n225, "seed": SEED, "p": list(GRID44_P),
                       "shots": GRID44_SHOTS})
    procs = [subprocess.Popen(
        [sys.executable, "-c", GRID44_WORKER, str(ROOT), str(rank),
         str(port), backend, spec], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        bp = BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)
        want44 = CodeFamily([load_code(n225)], bp, bp, batch_size=2048,
                            seed=SEED, device=dev).EvalWER(
            "data", "Total", list(GRID44_P), GRID44_SHOTS, if_plot=False,
            fused=False)
        results = []
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=GRID44_TIMEOUT)
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RESULT")]
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"phase 44 rank {rank} exited "
                                     f"{proc.returncode}: {err[-3000:]}")
            results.append(json.loads(lines[-1][len("RESULT"):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    cells44 = [r["cells"] for r in results]
    if cells44 != [2, 2] or any(
            not np.array_equal(np.asarray(r["wer"]), want44)
            for r in results):
        raise AssertionError(f"phase 44: ranks {results} vs the single "
                             f"process's grid {want44.tolist()}")
    log(f"[44] CodeFamily.EvalWER(shard_across_processes=True) over "
        f"{backend} in two processes ({', '.join(r['device'] for r in results)}"
        f"): {len(GRID44_P)} cells of hgp_34_n225, {cells44} run by ranks 0 "
        f"and 1, the merged grid {want44.tolist()} == the single process's; "
        + "; ".join(f"rank {i}: start {r['start_s']:.1f} s, grid "
                    f"{r['grid_s']:.2f} s" for i, r in enumerate(results)))
    log(f"phase 44 took {time.time() - t_new:.1f} s")
    return {"42": launches42, "42 v2": launches42v, "43": launches43,
            "got42": got42}


def recording_batcher():
    """``ContinuousBatcher`` recording each dispatched round (its session,
    rows in dispatch order, buckets and corrections) and which round and
    rows answered each request (phases 45-47)."""
    import threading

    import numpy as np

    from qldpc_fault_tolerance_tpu_torch.serve import ContinuousBatcher

    class Recorder(ContinuousBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rec_lock = threading.Lock()
            self.answered = {}
            self.rounds = []

        def _finish_batch(self, session_name, batch, out, *a, **kw):
            with self.rec_lock:
                lo = 0
                for r in batch:
                    self.answered.setdefault(r.request_id, []).append(
                        (len(self.rounds), lo, lo + r.shots))
                    lo += r.shots
                self.rounds.append({
                    "name": session_name,
                    "lanes": kw.get("fused_lanes", 0),
                    "rows": np.concatenate([r.syndromes for r in batch]),
                    "buckets": tuple(out.buckets),
                    "cor": np.array(out.corrections),
                    "conv": (None if out.converged is None
                             else np.array(out.converged)),
                    "shots": out.shots, "padded": out.padded_shots,
                    "timings": out.timings})
            return super()._finish_batch(session_name, batch, out, *a, **kw)

    return Recorder


def serve_phases(ctx) -> dict:
    """Phases 45-46 (module docstring): a served request storm on the card
    and its recovery.  ``ctx``: ``dev``, ``counted`` (the launch-count
    wrapper) and ``code`` (hgp_34_n625).  Returns phase 45's launches."""
    import contextlib
    import threading
    import urllib.request

    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BP_Decoder_Class,
        BPOSD_Decoder_Class,
        decode_device,
    )
    from qldpc_fault_tolerance_tpu_torch.decoders import bp_decoders
    from qldpc_fault_tolerance_tpu_torch.serve import (
        ContinuousBatcher,
        DecodeClient,
        DecodeSession,
        HealthProbe,
        start_ops_thread,
        start_server_thread,
    )
    from qldpc_fault_tolerance_tpu_torch.utils import (
        faultinject,
        resilience,
        telemetry,
    )
    from qldpc_fault_tolerance_tpu_torch.utils.device import device_cond

    dev = ctx.dev
    t_new = time.time()
    hx625 = ctx.code.hx
    hx225 = load_code(str(ROOT / "codes_lib_tpu" / "hgp_34_n225.npz")).hx
    n625, n225 = hx625.shape[1], hx225.shape[1]
    bp625 = BP_Decoder_Class(n625 / 50, "minimum_sum", 0.625, device=dev)
    bp225 = BP_Decoder_Class(n225 / 50, "minimum_sum", 0.625, device=dev)
    osd625 = BPOSD_Decoder_Class(n625 / 50, "minimum_sum", 0.625, "osd_e", 10,
                                 device=dev)
    specs = {f"n625_{k}": (bp625, hx625, p)
             for k, p in zip("abc", SERVE_FAMILY_P)}
    specs["n225"] = (bp225, hx225, SERVE_N225_P)
    specs["n625_osd"] = (osd625, hx625, SERVE_OSD_P)
    sessions = {name: DecodeSession(name, decoder_class=cls,
                                    params={"h": h, "p_data": p})
                for name, (cls, h, p) in specs.items()}

    Recorder = recording_batcher()

    bat = Recorder(sessions, max_batch_shots=SERVE_MAX_BATCH,
                   max_wait_s=SERVE_MAX_WAIT_S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    caps0 = telemetry.compile_stats()
    t = time.time()
    bat.warm()  # every session's ladder, the fused lanes to max_batch_shots
    warm_s = time.time() - t
    caps1 = telemetry.compile_stats()
    group = bat._fused_group("n625_a")
    if group is None:
        raise AssertionError("phase 45: the n625 sessions form no fused group")
    n_warm = caps1["cuda.graph_captures"] - caps0["cuda.graph_captures"]
    nodes = {name: {b: p.nodes for (b, _s), p in sorted(s.programs().items())}
             for name, s in sessions.items()}
    log(f"[45] warmed {len(sessions)} sessions x {len(sessions['n225'].buckets)} "
        f"buckets and the n625 family's fused lanes 2-3 in {warm_s:.1f} s: "
        f"{n_warm} captures, "
        f"{caps1['cuda.graph_captures.seconds'] - caps0['cuda.graph_captures.seconds']:.2f}"
        f" s of capture; graph nodes per bucket {nodes}; fused "
        f"{ {k: p.nodes for k, p in sorted(group.programs().items())} }; "
        f"kernel variants "
        f"{ {n: s.bucket_variants for n, s in sessions.items()} }")

    rng = np.random.default_rng(SEED + 45)

    h_t = {name: np.ascontiguousarray(h.T, np.float32)
           for name, (_c, h, _p) in specs.items()}

    def storm(n_requests, fault_plan=None, during=None,
              codecs=(2, 2, 2, 1)):
        """``n_requests`` requests over four pipelined tenant clients (on
        ``codecs``: three packed, one JSON by default); returns (results
        by request id, {id: (session, syndromes)}, wall seconds)."""
        names = sorted(sessions)
        reqs = []
        for i in range(n_requests):
            name = names[i % len(names)]
            _cls, h, p = specs[name]
            k = int(rng.integers(SERVE_SIZES[0], SERVE_SIZES[1] + 1))
            err = (rng.random((k, h.shape[1])) < p).astype(np.float32)
            # float32 BLAS: the sums stay exact far below 2**24
            synd = (err @ h_t[name]).astype(np.int64) % 2
            reqs.append((i % 4, name, synd.astype(np.uint8)))
        clients = [DecodeClient(*handle.address, tenant=f"tenant{j}",
                                codec=codecs[j], timeout=SERVE_TIMEOUT_S)
                   for j in range(4)]
        sent = {}
        results = {}
        errors = []

        def drive(j):
            futs = [(name, synd, clients[j].submit(name, synd))
                    for tenant, name, synd in reqs if tenant == j]
            for name, synd, fut in futs:
                try:
                    res = fut.result(timeout=SERVE_TIMEOUT_S)
                except Exception as exc:  # noqa: BLE001 — gated below
                    errors.append(f"{type(exc).__name__}: {exc}")
                    continue
                sent[res.request_id] = (name, synd)
                results[res.request_id] = res

        t0 = time.perf_counter()
        threads = [threading.Thread(target=drive, args=(j,)) for j in range(4)]
        try:
            with (faultinject.active_plan(fault_plan) if fault_plan
                  else contextlib.nullcontext()):
                for th in threads:
                    th.start()
                if during is not None:
                    during()
                for th in threads:
                    th.join(timeout=SERVE_TIMEOUT_S)
        finally:
            wall = time.perf_counter() - t0
            for cli in clients:
                cli.close()
        if errors or any(th.is_alive() for th in threads) \
                or len(results) != n_requests:
            raise AssertionError(f"storm: {len(results)} of {n_requests} "
                                 f"answered; errors {errors[:5]}")
        return results, sent, wall

    def offline(name, rows, buckets, sess=None):
        """``decode_device`` of ``rows`` chunked past the top bucket, each
        chunk padded into its bucket, eagerly, with session ``name``'s
        state (or ``sess``'s)."""
        sess = sessions[name] if sess is None else sess
        top = sess.buckets[-1]
        out = []
        for i, bucket in enumerate(buckets):
            chunk = rows[i * top:(i + 1) * top]
            pad = np.zeros((bucket, rows.shape[1]), np.uint8)
            pad[:chunk.shape[0]] = chunk
            cor, _aux = decode_device(sess.static, sess.state,
                                      torch.from_numpy(pad).to(dev))
            out.append(cor.cpu().numpy()[:chunk.shape[0]])
        return np.concatenate(out)

    def check_bitexact(results, sent, tag, first_round):
        """Every answer is its round's rows, answered once, and every
        round since ``first_round`` equals the offline ``decode_device``
        of the same rows padded into the same buckets."""
        for rid, res in results.items():
            answered = bat.answered.get(rid, [])
            if len(answered) != 1:
                raise AssertionError(f"[{tag}] request {rid} answered "
                                     f"{len(answered)} times")
            i, lo, hi = answered[0]
            rnd = bat.rounds[i]
            if rnd["name"] != sent[rid][0] \
                    or not np.array_equal(rnd["rows"][lo:hi], sent[rid][1]) \
                    or not np.array_equal(rnd["cor"][lo:hi], res.corrections):
                raise AssertionError(f"[{tag}] request {rid}: the answer is "
                                     f"not its dispatched round's")
        rounds = bat.rounds[first_round:]
        for rnd in rounds:
            got = offline(rnd["name"], rnd["rows"], rnd["buckets"])
            if not np.array_equal(got, rnd["cor"]):
                bad = int((got != rnd["cor"]).any(axis=1).sum())
                raise AssertionError(
                    f"[{tag}] {rnd['name']} round at buckets "
                    f"{rnd['buckets']}: {bad} served shots differ from the "
                    f"offline decode of the same padded rows")
        return sum(r["shots"] for r in rounds), len(rounds)

    def regrouped(first_round, names):
        """Shots of sessions ``names`` whose served correction differs
        from the offline decode of the same session's rows at the same
        bucket regrouped in reverse order (other neighbours, other tier
        counts), by session, with how many of them BP had not converged
        (the OSD stage decided them)."""
        groups = {}
        for rnd in bat.rounds[first_round:]:
            if len(rnd["buckets"]) == 1 and rnd["name"] in names:
                groups.setdefault((rnd["name"], rnd["buckets"][0]),
                                  []).append(rnd)
        diff = {}
        for (name, bucket), rnds in groups.items():
            rows = np.concatenate([r["rows"] for r in rnds])[::-1]
            want = np.concatenate([r["cor"] for r in rnds])[::-1]
            conv = np.concatenate([r["conv"] for r in rnds])[::-1]
            n_chunks = -(-rows.shape[0] // bucket)
            got = np.concatenate([
                offline(name, rows[i * bucket:(i + 1) * bucket], (bucket,))
                for i in range(n_chunks)])
            bad = (got != want).any(axis=1)
            n_bad, n_osd = diff.get(name, (0, 0))
            diff[name] = (n_bad + int(bad.sum()),
                          n_osd + int((bad & ~conv).sum()))
        return diff

    def program_reads():
        return (sum(s.host_reads for s in sessions.values())
                + sum(p.host_reads for p in group.programs().values()))

    # 45. the storm
    handle = start_server_thread(bat)
    reads0, tier0 = program_reads(), (decode_device.host_reads,
                                      device_cond.host_reads)
    fused0, rounds0 = bat.fused_dispatches, len(bat.rounds)
    caps0 = telemetry.compile_stats()["cuda.graph_captures"]
    compiles0 = sum(s.compiles for s in sessions.values()) + group.compiles
    (results, sent, wall), launches45 = ctx.counted(
        lambda: storm(SERVE_REQUESTS))
    caps = telemetry.compile_stats()["cuda.graph_captures"] - caps0
    compiles = (sum(s.compiles for s in sessions.values()) + group.compiles
                - compiles0)
    rounds = bat.rounds[rounds0:]
    fused = bat.fused_dispatches - fused0
    solo = sum(1 for r in rounds if not r["lanes"])
    dispatches = solo + fused
    # a round past the top bucket runs in chunks, a read each
    want_reads = fused + sum(len(r["buckets"]) for r in rounds
                             if not r["lanes"])
    # device_decode: replay to host read, once per dispatch (a fused
    # dispatch's lanes share one timings dict)
    stage = {}
    for r in rounds:
        stage[id(r["timings"])] = r["timings"]
    replay_s = sum(t["device_decode"] for t in stage.values())
    pad_s = sum(t["pad"] + t["slice"] for t in stage.values())
    by_session = {}
    for r in rounds:
        row = by_session.setdefault(r["name"], [0, 0, 0.0])
        row[0] += 1
        row[1] += r["shots"]
        row[2] += r["timings"]["device_decode"] / max(1, r["lanes"])
    reads = program_reads() - reads0
    tier = (decode_device.host_reads - tier0[0],
            device_cond.host_reads - tier0[1])
    health = bat.health()
    lat = np.sort([r.latency_s for r in results.values()])
    shots = sum(r.corrections.shape[0] for r in results.values())
    real = sum(r["shots"] for r in rounds)
    padded = sum(r["padded"] for r in rounds)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[45] {SERVE_REQUESTS} requests ({shots} shots) from 4 tenants "
        f"(codec 2 x3, JSON x1) in {wall:.3f} s: {SERVE_REQUESTS / wall:.1f} "
        f"requests/s, {shots / wall:.1f} served shots/s, latency p50 "
        f"{1e3 * lat[len(lat) // 2]:.2f} ms p99 "
        f"{1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.2f} ms; "
        f"{dispatches} dispatches ({fused} fused, {solo} per session; "
        f"{len(rounds)} session rounds, "
        f"{SERVE_REQUESTS / len(rounds):.2f} requests a round), fused "
        f"fallbacks {health['fused']['fallbacks']}, padded fraction "
        f"{1 - real / padded:.4f}; dispatcher time in replay + read "
        f"{replay_s:.3f} s, pad + slice {pad_s:.3f} s; per session "
        f"(rounds, shots, replay s, a fused dispatch's split over its "
        f"lanes) { {k: (a, b, round(c, 3)) for k, (a, b, c) in sorted(by_session.items())} }"
        f"; host reads "
        f"{reads} (tier reads {tier}); "
        f"captures during the storm {caps}; peak memory {peak:.2f} GiB; "
        f"launches {launches45}")
    checked, n_rounds = check_bitexact(results, sent, "45", rounds0)
    log(f"[45] every answer is its round's, and every round == the offline "
        f"decode_device of the same rows padded into the same buckets "
        f"({checked} shots in {n_rounds} rounds); the same rows regrouped "
        f"by session and bucket in reverse order: shots differing (of "
        f"them BP-failed) "
        f"{regrouped(rounds0, ('n625_a', 'n625_osd'))}")
    if health["completed"] < SERVE_REQUESTS or health["failed"]:
        raise AssertionError(f"phase 45 health {health}")
    if fused <= 0:
        raise AssertionError("phase 45: no fused dispatch")
    if caps or compiles:
        raise AssertionError(f"phase 45: {caps} captures ({compiles} "
                             f"programs built) during the storm")
    if reads != want_reads or (dev.type == "cuda" and tier != (0, 0)):
        raise AssertionError(f"phase 45: {reads} host reads (tier reads "
                             f"{tier}) for {dispatches} dispatches, "
                             f"{want_reads} chunks")
    for name in ("bp_minsum_bf16", "bp_minsum", "osd_elim"):
        if launches45[name] <= 0:
            raise AssertionError(f"phase 45: {name} never launched")
    # fused == per session: one 3-lane round against each member's program
    parts = [(i, (rng.random((SERVE_FUSED_ROWS, n625)) < p).astype(np.uint8)
              @ hx625.T % 2) for i, p in enumerate(SERVE_FAMILY_P)]
    parts = [(i, s.astype(np.uint8)) for i, s in parts]
    outs = group.decode(parts)
    for (i, synd), out in zip(parts, outs):
        own = group.sessions[i].decode(synd)
        if not np.array_equal(out.corrections, own.corrections) \
                or not np.array_equal(out.converged, own.converged):
            raise AssertionError(f"phase 45: fused lane {i} != "
                                 f"{group.sessions[i].name}'s program")
    log(f"[45] a 3-lane fused round of {SERVE_FUSED_ROWS} shots a lane == "
        f"each member's own program")
    no_rungs("45")
    # the same traffic without the JSON tenant: what its codec costs
    rounds_v2 = len(bat.rounds)
    results, sent, wall = storm(SERVE_V2_REQUESTS, codecs=(2, 2, 2, 2))
    checked, _ = check_bitexact(results, sent, "45 v2", rounds_v2)
    lat = np.sort([r.latency_s for r in results.values()])
    replay_v2 = sum({id(r["timings"]): r["timings"]["device_decode"]
                     for r in bat.rounds[rounds_v2:]}.values())
    log(f"[45] {SERVE_V2_REQUESTS} requests ({checked} shots) from 4 "
        f"tenants all on codec 2 in {wall:.3f} s: "
        f"{SERVE_V2_REQUESTS / wall:.1f} requests/s, {checked / wall:.1f} "
        f"served shots/s, latency p50 {1e3 * lat[len(lat) // 2]:.2f} ms "
        f"p99 {1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.2f} ms; "
        f"dispatcher time in replay + read {replay_v2:.3f} s; every "
        f"round bit-exact; phase 45 took {time.time() - t_new:.1f} s")

    # 46. recovery mid-storm: a heal, an injected transient fault, a
    # device restart; the probe heals and recaptures in the background
    t_new = time.time()
    prev_policy = resilience.current_policy()
    resilience.set_default_policy(resilience.RetryPolicy(
        max_attempts=4, base_delay=0.01, max_delay=0.05, reset_caches=False,
        seed=SEED))
    probe = HealthProbe(bat, interval_s=0.1)
    ops = start_ops_thread(bat, probe=probe)
    epoch0 = resilience.device_epoch()
    heals0 = {n: s.heals for n, s in sessions.items()}
    caps0 = telemetry.compile_stats()["cuda.graph_captures"]
    built0 = sum(s.compiles for s in sessions.values())
    rounds46 = len(bat.rounds)
    plan = faultinject.FaultPlan([
        faultinject.Fault(site="serve_dispatch", kind="raise", after=1),
        faultinject.Fault(site="serve_dispatch", kind="device_restart",
                          after=3),
        faultinject.Fault(site="serve_fused_dispatch", kind="raise",
                          after=1)], seed=SEED)
    healed = []

    def heal_midway():
        time.sleep(0.2)
        healed.append(sessions["n225"].heal("phase46"))

    telemetry.enable()
    try:
        results, sent, wall = storm(SERVE_RECOVERY_REQUESTS, plan,
                                    during=heal_midway)
        probe.stop()
        probe.probe_once()  # what the loop left pending
        metrics = urllib.request.urlopen(
            f"http://{ops.address[0]}:{ops.address[1]}/metrics",
            timeout=10).read().decode()
        healthz = urllib.request.urlopen(
            f"http://{ops.address[0]}:{ops.address[1]}/healthz",
            timeout=10).status
    finally:
        probe.stop()
        ops.stop()
        telemetry.disable()
        resilience.set_default_policy(prev_policy)
    caps = telemetry.compile_stats()["cuda.graph_captures"] - caps0
    built = sum(s.compiles for s in sessions.values()) - built0
    heals = {n: s.heals - heals0[n] for n, s in sessions.items()}
    fired = {s: plan.hits(s) for s in ("serve_dispatch",
                                       "serve_fused_dispatch")}
    checked, _ = check_bitexact(results, sent, "46", rounds46)
    rounds_after = len(bat.rounds)
    after, sent_after, _ = storm(SERVE_AFTER_REQUESTS)
    checked_after, _ = check_bitexact(after, sent_after, "46 after",
                                      rounds_after)
    log(f"[46] {SERVE_RECOVERY_REQUESTS} requests in {wall:.3f} s across a "
        f"heal of n225 ({healed}), an injected transient fault and a "
        f"device_restart (site hits {fired}; device epoch "
        f"{epoch0} -> {resilience.device_epoch()}): every request "
        f"answered once, {checked} shots == the offline decode at their "
        f"buckets; heals {heals}, {built} programs rebuilt, {caps} "
        f"captures; then "
        f"{SERVE_AFTER_REQUESTS} requests on the recaptured graphs, "
        f"{checked_after} shots bit-exact; /metrics {len(metrics)} bytes, "
        f"/healthz {healthz}")
    if resilience.device_epoch() == epoch0 or built <= 0 \
            or (dev.type == "cuda" and caps < built) \
            or not all(heals.values()) or healthz != 200 \
            or "qldpc_serve_requests" not in metrics:
        raise AssertionError(f"phase 46: epoch {resilience.device_epoch()}, "
                             f"{built} programs rebuilt, {caps} captures, "
                             f"heals {heals}, /healthz {healthz}")
    handle.stop(drain=True, timeout=SERVE_TIMEOUT_S)
    log(f"[46] rungs stepped by the injected faults: {clear_rungs()}")
    log(f"phase 46 took {time.time() - t_new:.1f} s")
    return launches45, SimpleNamespace(Recorder=Recorder, specs=specs,
                                       rng=rng, h_t=h_t, offline=offline)


def fleet_phase(ctx, kit) -> dict:
    """Phase 47 (module docstring): phase 45's sessions behind a two-host
    ``LocalFleet`` on the card, a storm through its router and a seeded
    ``host_kill`` of the host that owns n625_osd's family, handed off by
    the gateway's deadman.  ``ctx``: ``dev``; ``kit``: phase 45's
    recording batcher class, session specs, request generator and offline
    decode.  Returns what it measured."""
    import logging
    import threading
    from unittest import mock

    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.serve import (
        DecodeClient,
        DecodeSession,
        LocalFleet,
    )
    from qldpc_fault_tolerance_tpu_torch.serve import scheduler as sched
    from qldpc_fault_tolerance_tpu_torch.serve.session import family_digest
    from qldpc_fault_tolerance_tpu_torch.utils import (
        faultinject,
        resilience,
        telemetry,
    )

    dev = ctx.dev
    t_new = time.time()
    specs, rng = kit.specs, kit.rng

    def factory():
        return {name: DecodeSession(name, decoder_class=cls,
                                    params={"h": h, "p_data": p})
                for name, (cls, h, p) in specs.items()}

    def counter(name):
        return telemetry.snapshot().get(name, {}).get("value", 0)

    prev_policy = resilience.current_policy()
    resilience.set_default_policy(resilience.RetryPolicy(
        max_attempts=4, base_delay=0.01, max_delay=0.05, reset_caches=False,
        seed=SEED))
    telemetry.enable()
    # a killed host's sockets die under writes in flight: asyncio warns
    # once a write, which is the chaos working, not a fault
    asyncio_log = logging.getLogger("asyncio")
    asyncio_level = asyncio_log.level
    asyncio_log.setLevel(logging.ERROR)
    kills0 = counter("serve.host_kills")
    caps0 = telemetry.compile_stats()
    t = time.time()
    # every host's batcher records its rounds (phase 45's recorder)
    stopped = False
    with mock.patch.object(sched, "ContinuousBatcher", kit.Recorder):
        fleet = LocalFleet(factory, n_hosts=2, interval_s=FLEET_INTERVAL_S,
                           down_after_s=FLEET_DOWN_AFTER_S, batcher_kwargs={
                               "max_batch_shots": SERVE_MAX_BATCH,
                               "max_wait_s": SERVE_MAX_WAIT_S})
    try:
        for label in fleet.labels:
            fleet.batchers[label].warm()
        caps1 = telemetry.compile_stats()
        warm_s = time.time() - t
        fam = f"fam-{family_digest(fleet.sessions['h0']['n625_osd'].family)}"
        placement = fleet.router.placement()
        victim, survivor = (placement[fam]["owner"],
                            placement[fam]["successor"])
        victim_fams = sorted(f for f, pl in placement.items()
                             if pl["owner"] == victim)
        victim_names = {n for f in victim_fams
                        for n in fleet.router.families.get(f, [])}
        log(f"[47] LocalFleet of 2 hosts on {dev}, phase 45's sessions and "
            f"bucket ladder, built and warmed in {warm_s:.1f} s: "
            f"{caps1['cuda.graph_captures'] - caps0['cuda.graph_captures']}"
            f" captures, {caps1['cuda.graph_captures.seconds'] - caps0['cuda.graph_captures.seconds']:.2f}"
            f" s; placement {placement}; the kill aims at {victim} (owner "
            f"of n625_osd's family {fam})")
        cuda = dev.type == "cuda"

        def memory(fn):
            return fn(dev) if cuda else 0

        memory(torch.cuda.synchronize)
        memory(torch.cuda.reset_peak_memory_stats)
        kill = {}
        orig_kill = fleet.kill

        def timed_kill(label):
            kill["peak_before"] = memory(torch.cuda.max_memory_allocated)
            kill["alloc_before"] = memory(torch.cuda.memory_allocated)
            kill["t"] = time.perf_counter()
            kill["caps"] = telemetry.compile_stats()
            out = orig_kill(label)
            memory(torch.cuda.synchronize)
            kill["alloc_after"] = memory(torch.cuda.memory_allocated)
            memory(torch.cuda.reset_peak_memory_stats)
            return out

        fleet.kill = timed_kill
        names = sorted(specs)
        reqs = []
        for i in range(FLEET_REQUESTS):
            name = names[i % len(names)]
            _cls, h, p = specs[name]
            k = int(rng.integers(SERVE_SIZES[0], SERVE_SIZES[1] + 1))
            err = (rng.random((k, h.shape[1])) < p).astype(np.float32)
            synd = (err @ kit.h_t[name]).astype(np.int64) % 2
            reqs.append((i % 4, name, synd.astype(np.uint8)))
        clients = [DecodeClient(*fleet.address, tenant=f"tenant{j}", codec=2,
                                reconnect=True, timeout=SERVE_TIMEOUT_S)
                   for j in range(4)]
        results, errors, lock = {}, [], threading.Lock()

        def drive(j):
            futs = [(name, synd, clients[j].submit(name, synd))
                    for tenant, name, synd in reqs if tenant == j]
            for name, synd, fut in futs:
                try:
                    res = fut.result(timeout=SERVE_TIMEOUT_S)
                except Exception as exc:  # noqa: BLE001 — gated below
                    errors.append(f"{type(exc).__name__}: {exc}")
                    continue
                with lock:
                    results[res.request_id] = (name, synd, res,
                                               time.perf_counter())
                fleet.chaos_tick()

        plan = faultinject.FaultPlan([faultinject.Fault(
            site="fleet_host_tick", kind="host_kill",
            after=FLEET_KILL_AFTER, target=fam)], seed=SEED)
        threads = [threading.Thread(target=drive, args=(j,))
                   for j in range(4)]
        t0 = time.perf_counter()
        try:
            with plan.active():
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=SERVE_TIMEOUT_S)
        finally:
            wall = time.perf_counter() - t0
            for cli in clients:
                cli.close()
        caps2 = telemetry.compile_stats()
        peak_after = memory(torch.cuda.max_memory_allocated)
        if errors or any(th.is_alive() for th in threads) \
                or len(results) != FLEET_REQUESTS or "t" not in kill:
            raise AssertionError(f"phase 47: {len(results)} of "
                                 f"{FLEET_REQUESTS} answered, kill "
                                 f"{sorted(kill)}; errors {errors[:5]}")
        kills = counter("serve.host_kills") - kills0
        report = fleet.router.handoff_report()
        if kills != 1 or fleet.router.down != {victim} \
                or fam not in report or report[fam]["to"] != survivor:
            raise AssertionError(f"phase 47: host kills {kills}, down "
                                 f"{fleet.router.down}, handoffs {report}")
        recs = {label: fleet.batchers[label] for label in fleet.labels}
        # a replayed answer equals the original: an answer the survivor
        # imported from the dead host's journal, asked again
        with recs[survivor]._cv:
            imported = [(key, res) for key, res
                        in recs[survivor]._answered.items()
                        if res.request_id in recs[victim].answered
                        and res.request_id not in recs[survivor].answered]
        if not imported:
            raise AssertionError("phase 47: the survivor imported no entry "
                                 "of the dead host's journal")
        (tenant, sess_name, idem), entry = imported[0]
        i, lo, hi = recs[victim].answered[entry.request_id][0]
        original = recs[victim].rounds[i]["cor"][lo:hi]
        width = fleet.sessions[survivor][sess_name].syndrome_width
        again = recs[survivor].submit(
            sess_name, np.zeros((1, width), np.uint8), tenant=tenant,
            idem=idem).result(timeout=SERVE_TIMEOUT_S)
        if not (np.array_equal(again.corrections, original) and
                np.array_equal(entry.corrections, original)):
            raise AssertionError("phase 47: a replayed answer differs from "
                                 "the original")
        # the checks below read only the recorded rounds and the sessions'
        # states: stop the fleet first, so its replication threads do not
        # contend for the interpreter
        fleet.stop()
        stopped = True
        t_stopped = time.perf_counter()
        # every accepted request answered once: on the survivor at most
        # one round answered it, on the dead host at most one, and the
        # client holds the survivor's answer where it has one (else the
        # dead host's, served before the kill or replayed from its
        # imported journal)
        # a request resubmitted after the kill carries a fresh wire id (and
        # its idempotency key): find each request's rounds by its rows
        index = {}
        for label, rec in recs.items():
            for hits in rec.answered.values():
                for i, lo, hi in hits:
                    rnd = rec.rounds[i]
                    key = (rnd["name"], rnd["rows"][lo:hi].tobytes())
                    index.setdefault(key, {lb: [] for lb in recs})[
                        label].append((i, lo, hi))
        replayed, fresh_after = 0, []
        for rid, (name, synd, res, done) in results.items():
            hits = index.get((name, synd.tobytes()),
                             {lb: [] for lb in recs})
            if len(hits[survivor]) > 1 or len(hits[victim]) > 1 \
                    or not (hits[survivor] or hits[victim]):
                raise AssertionError(f"phase 47: request {rid} answered by "
                                     f"rounds {hits}")
            label = survivor if hits[survivor] else victim
            i, lo, hi = hits[label][0]
            rnd = recs[label].rounds[i]
            if rnd["name"] != name or not np.array_equal(
                    rnd["rows"][lo:hi], synd) or not np.array_equal(
                    rnd["cor"][lo:hi], res.corrections):
                raise AssertionError(f"phase 47: request {rid}'s answer is "
                                     f"not its round's on {label}")
            if label == victim and done > kill["t"]:
                replayed += 1
            if label == survivor and done > kill["t"] \
                    and name in victim_names:
                fresh_after.append((done, res.latency_s))
        t_matched = time.perf_counter()
        # every round of every host == the offline decode of its padded
        # rows on that host's session state
        n_rounds, n_shots = 0, 0
        for label, rec in recs.items():
            for rnd in rec.rounds:
                got = kit.offline(rnd["name"], rnd["rows"], rnd["buckets"],
                                  sess=fleet.sessions[label][rnd["name"]])
                if not np.array_equal(got, rnd["cor"]):
                    bad = int((got != rnd["cor"]).any(axis=1).sum())
                    raise AssertionError(
                        f"phase 47: {label} {rnd['name']} round at buckets "
                        f"{rnd['buckets']}: {bad} served shots differ from "
                        f"the offline decode of the same padded rows")
                n_rounds += 1
                n_shots += rnd["shots"]
        t_checked = time.perf_counter()

        before = [r.latency_s for (_n, _s, r, d) in results.values()
                  if d <= kill["t"]]
        after = [r.latency_s for (_n, _s, r, d) in results.values()
                 if d > kill["t"]]
        shots = sum(r.corrections.shape[0]
                    for (_n, _s, r, _d) in results.values())
        durs = fleet.router.handoff_durations()
        first = min(fresh_after)[1] if fresh_after else float("nan")

        def pct(v, q):
            v = np.sort(v)
            return 1e3 * v[min(len(v) - 1, int(q * len(v)))] if len(v) \
                else float("nan")

        out = {"req_s": FLEET_REQUESTS / wall, "shots_s": shots / wall,
               "handoff_s": durs, "kills": kills}
        log(f"[47] {FLEET_REQUESTS} requests ({shots} shots) from 4 "
            f"pipelined tenants through the router in {wall:.3f} s: "
            f"{out['req_s']:.1f} requests/s, {out['shots_s']:.1f} served "
            f"shots/s; latency before the kill p50 {pct(before, 0.5):.2f} "
            f"ms p99 {pct(before, 0.99):.2f} ms ({len(before)} requests), "
            f"after p50 {pct(after, 0.5):.2f} ms p99 {pct(after, 0.99):.2f}"
            f" ms ({len(after)}); host_kill of {victim} at "
            f"{kill['t'] - t0:.3f} s into the storm (serve.host_kills "
            f"{kills}), handed off by the deadman: families {victim_fams} "
            f"-> {survivor}, gate to promote {[round(d, 4) for d in durs]} "
            f"s; captures from the kill to the storm's end "
            f"{caps2['cuda.graph_captures'] - kill['caps']['cuda.graph_captures']}"
            f" ({caps2['cuda.graph_captures.seconds'] - kill['caps']['cuda.graph_captures.seconds']:.3f}"
            f" s); the first adopted answer's latency {1e3 * first:.2f} ms; "
            f"{fleet.released.get(victim, 0)} programs released with the "
            f"dead host; device memory allocated {kill['alloc_before'] / 2**30:.2f}"
            f" -> {kill['alloc_after'] / 2**30:.2f} GiB at the kill, peak "
            f"before {kill['peak_before'] / 2**30:.2f} GiB, after "
            f"{peak_after / 2**30:.2f} GiB; answers replayed from the "
            f"imported journal or served before the kill "
            f"{replayed}; every request answered once, every round of both "
            f"hosts ({n_rounds} rounds, {n_shots} shots) == the offline "
            f"decode of its padded rows; a replayed answer == the original "
            f"(checks after the fleet stopped: matching "
            f"{t_matched - t_stopped:.1f} s, offline decodes "
            f"{t_checked - t_matched:.1f} s)")
    finally:
        if not stopped:
            fleet.stop()
        telemetry.disable()
        resilience.set_default_policy(prev_policy)
        asyncio_log.setLevel(asyncio_level)
    taken = clear_rungs()
    if "mesh_replan" in taken or any("->" in k for k in taken):
        raise AssertionError(f"phase 47 stepped engine rungs {taken}")
    log(f"phase 47 took {time.time() - t_new:.1f} s (rungs {taken})")
    return out


def fault_phases(ctx) -> dict:
    """Phase 48 (module docstring): the fault path on the card.  ``ctx``:
    ``dev``, ``code`` (hgp_34_n625), phase 42's uninterrupted mesh run
    (``got42``), ``circuit_sim`` (phase 34's engine factory), phase 34's
    run and the BP + OSD-E 10 host decoder class.  Returns what it
    measured."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BPDecoder,
        BPOSD_Decoder,
    )
    from qldpc_fault_tolerance_tpu_torch.decoders import osd as tosd
    from qldpc_fault_tolerance_tpu_torch.parallel import shot_mesh
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError
    from qldpc_fault_tolerance_tpu_torch.utils import (
        faultinject,
        resilience,
        telemetry,
    )

    dev, code = ctx.dev, ctx.code
    n = code.N
    t_new = time.time()
    out = {}

    def within(a, b, shots_a, shots_b, k=4.0):
        fa, fb = a / shots_a, b / shots_b
        sigma = (fa * (1 - fa) / shots_a + fb * (1 - fb) / shots_b) ** 0.5
        return abs(fa - fb) <= k * sigma, abs(fa - fb), k * sigma

    # (a) the data engine's ladder: fused v2 and packed at p 0.01; one
    # injected transient fault outliving its one retry's budget
    # (degrade_after 1) steps the engine's one rung, then a fault outliving
    # both attempts finds the ladder exhausted and raises
    p, shots = 0.01, FAULT48_BATCHES * 2048
    probs = np.full(n, 2 * p / 3)

    def data_sim(fused):
        return CodeSimulator_DataError(
            code=code, decoder_x=BPDecoder(code.hz, probs, 50, device=dev),
            decoder_z=BPDecoder(code.hx, probs, 50, device=dev),
            pauli_error_probs=[p / 3] * 3, seed=SEED, batch_size=2048,
            scan_chunk=FAULT48_BATCHES, fused_sampler=fused, device=dev)

    def wer_run(sim):
        sim.min_logical_weight = sim.N
        sim.WordErrorRate(shots, key=FAULT48_KEY)
        return sim.last_failures, sim.min_logical_weight

    ref = {tag: wer_run(data_sim(fused))
           for tag, fused in (("v2", "v2"), ("v1", True), ("packed", False))}
    no_rungs("48 (a) references")
    policy = resilience.RetryPolicy(max_attempts=2, base_delay=0.0,
                                    jitter=0.0, reset_caches=False,
                                    degrade_after=1)

    def faulted(sim, count):
        plan = faultinject.FaultPlan([faultinject.Fault(
            site="wer.data", kind="raise", count=count)], seed=SEED)
        with resilience.policy_override(policy), plan.active():
            return wer_run(sim), plan.hits("wer.data")

    # (engine, its rung, the fault-free engine it must equal bit for bit,
    # the engine above it, whether JAX promises the step bit-exact)
    expect = [("v2", "fused_v2->fused_pallas", "v1", "v2", False),
              (False, "packed->dense", "packed", "packed", True)]
    steps = []
    for fused, rung, same_as, above, exact in expect:
        sim = data_sim(fused)
        t = time.time()
        got, hits = faulted(sim, 1)
        dt = time.time() - t
        taken = clear_rungs()
        if taken != {rung: 1} or hits != 2:
            raise AssertionError(f"phase 48 (a): expected {rung}, stepped "
                                 f"{taken} (site hits {hits})")
        ok, diff, bound = within(got[0], ref[above][0], shots, shots)
        if exact and got != ref[above]:
            raise AssertionError(f"phase 48 (a) {rung}: {got} != the rung "
                                 f"above's {ref[above]}")
        if not ok or got != ref[same_as]:
            raise AssertionError(f"phase 48 (a) {rung}: {got} vs above "
                                 f"{ref[above]} (|diff| {diff:.3e}, 4 sigma "
                                 f"{bound:.3e}), its engine {ref[same_as]}")
        try:
            faulted(sim, 2)
        except faultinject.InjectedFault as exc:
            raised = type(exc).__name__
        else:
            raise AssertionError(f"phase 48 (a): a fault past {rung} did "
                                 f"not raise")
        taken = clear_rungs()
        if taken:
            raise AssertionError(f"phase 48 (a): past {rung} the exhausted "
                                 f"ladder stepped {taken}")
        steps.append((rung, got, dt))
        log(f"[48a] fused_sampler={fused!r}: an injected transient fault at "
            f"wer.data -> rung {rung}: (failures, min_w) {got} in {dt:.2f} "
            f"s; the rung above {ref[above]} "
            f"({'bit-exact' if exact else 'within 4 sigma'}"
            f"{'' if exact else f': |diff| {diff:.3e} <= {bound:.3e}'}); "
            f"== the fault-free {same_as} engine; a second fault outliving "
            f"both attempts raised {raised} from the exhausted ladder, no "
            f"rung stepped")
    out["a"] = steps

    # (b) phase 42's mesh (one megabatch a device), a device lost at its
    # dispatch: one mesh_replan, the counts of phase 42's run
    mesh2 = shot_mesh([dev, dev])
    shots42 = mesh2.size * MESH42_BATCHES * 4096
    sim42 = mesh42_sim(code, dev, mesh2, 4096)
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="mesh_dispatch", kind="mesh_device_loss")], seed=SEED)
    telemetry.enable()
    replans0 = telemetry.snapshot().get("mesh.replans", {}).get("value", 0)
    t = time.time()
    try:
        with plan.active():
            sim42.min_logical_weight = sim42.N
            sim42.WordErrorRate(shots42, key=MESH42_KEY)
        replans = (telemetry.snapshot().get("mesh.replans", {}).get(
            "value", 0) - replans0)
    finally:
        telemetry.disable()
    dt = time.time() - t
    got = (sim42.last_failures, sim42.min_logical_weight, sim42.last_shots)
    taken = clear_rungs()
    if got != tuple(ctx.got42) or replans != 1 \
            or taken != {"mesh_replan": 1}:
        raise AssertionError(f"phase 48 (b): {got} vs phase 42's "
                             f"{ctx.got42}, replans {replans}, rungs {taken}")
    out["b"] = (got, dt)
    log(f"[48b] mesh_device_loss at mesh_dispatch ("
        f"{plan.hits('mesh_dispatch')} hit) on shot_mesh([{dev}, {dev}]): "
        f"mesh.replans {replans}, the cell rerun on the replay runner "
        f"({plan.hits('mesh_replay_dispatch')} replay dispatches): "
        f"(failures, min_w, shots) {got} == phase 42's uninterrupted run, "
        f"{dt:.2f} s")

    # (c) BP + OSD-E 10 at p 0.05: a transient fault in the device OSD
    # stage raises (no host fallback); the same batch on the host C++ OSD
    p = 0.05
    probs = np.full(n, 2 * p / 3)
    rng = np.random.default_rng(SEED + 48)
    err = (rng.random((2048, n)) < 2 * p / 3).astype(np.uint8)
    synd = (err @ code.hx.T % 2).astype(np.uint8)
    dec = BPOSD_Decoder(code.hx, probs, 50, osd_method="osd_e", osd_order=10,
                        device=dev)
    t = time.time()
    dev_out = dec.decode_batch(synd)
    dev_s = time.time() - t
    no_rungs("48 (c) device OSD")

    def faulty(_syndromes):
        raise resilience.TransientFault("injected device-OSD fault")

    dec.decode_batch_device = faulty
    osd_n0 = tosd.osd_postprocess.shots
    try:
        dec.decode_batch(synd)
    except resilience.TransientFault:
        pass
    else:
        raise AssertionError("phase 48 (c): the device-OSD fault did not "
                             "raise")
    del dec.decode_batch_device
    taken = clear_rungs()
    if taken or tosd.osd_postprocess.shots != osd_n0:
        raise AssertionError(f"phase 48 (c): the faulted device decode "
                             f"stepped {taken}, host OSD shots "
                             f"{tosd.osd_postprocess.shots - osd_n0}")
    hdec = BPOSD_Decoder(code.hx, probs, 50, osd_method="osd_e",
                         osd_order=10, device=dev, device_osd=False)
    osd_s0, osd_n0 = tosd.osd_postprocess.seconds, tosd.osd_postprocess.shots
    t = time.time()
    host_out = hdec.decode_batch(synd)
    host_s = time.time() - t
    osd_s = tosd.osd_postprocess.seconds - osd_s0
    osd_n = tosd.osd_postprocess.shots - osd_n0
    no_rungs("48 (c) host OSD")
    if osd_n <= 0:
        raise AssertionError("phase 48 (c): the host OSD decoded no shot")
    if not np.array_equal(host_out @ code.hx.T % 2, synd):
        raise AssertionError("phase 48 (c): a host OSD correction misses "
                             "its syndrome")
    # the host C++ == its plain version (numpy) on BP's outputs
    aux = hdec.bp_batch_device(torch.from_numpy(synd))._asdict()
    conv = aux["converged"].cpu().numpy()
    failed = np.nonzero(~conv)[0]
    idx = failed[:FAULT48_ORACLE_SHOTS]
    post = aux["posterior_llr"].cpu().numpy().astype(np.float64)
    cost = tosd._channel_cost(probs)
    plain = tosd._osd_numpy(code.hx.astype(np.uint8), synd[idx], post[idx],
                            cost, tosd.METHODS["osd_e"], 10)
    if not np.array_equal(plain, host_out[idx]):
        raise AssertionError("phase 48 (c): the host C++ OSD differs from "
                             "_osd_numpy")
    # host (float64 costs) against the device (float32): they may differ
    # only on a float-tied candidate
    differ = np.nonzero((host_out != dev_out).any(axis=1))[0]
    for i in differ:
        c_host = float(cost[host_out[i] == 1].sum())
        c_dev = float(cost[dev_out[i] == 1].sum())
        if c_host > c_dev + 1e-9 or c_dev - c_host > 1e-4 * max(1.0, c_host):
            raise AssertionError(f"phase 48 (c) shot {i}: host cost "
                                 f"{c_host!r}, device cost {c_dev!r}: not a "
                                 f"float tie")
    if len(differ) > FAULT48_TIE_SHARE * len(failed):
        raise AssertionError(f"phase 48 (c): {len(differ)} of {len(failed)} "
                             f"BP-failed shots differ, above the "
                             f"{FAULT48_TIE_SHARE:.0%} bound")
    cpu = cpu_model()
    out["c"] = {"differ": len(differ), "failed": len(failed),
                "ms_per_shot": 1e3 * osd_s / osd_n}
    log(f"[48c] BPOSD-E 10 at p {p}, 2048 shots ({len(failed)} BP-failed): "
        f"an injected transient fault in the device OSD stage raised from "
        f"decode_batch (no rung, no host OSD shot); the same batch with "
        f"device_osd=False: the host C++ OSD decoded {osd_n} shots in "
        f"{osd_s:.3f} s ({1e3 * osd_s / osd_n:.3f} ms a shot on {cpu}, "
        f"{os.cpu_count()} CPUs); the batch {host_s:.3f} s against "
        f"{dev_s:.3f} s on the device; == _osd_numpy on {len(idx)} shots "
        f"bit for bit; {len(differ)} shots differ from the device OSD, "
        f"each a float-tied candidate (bound "
        f"{FAULT48_TIE_SHARE:.0%} of the BP-failed shots)")

    # (d) phase 34's circuit engine with a host-OSD decoder 2
    sim34h, _ = ctx.circuit_sim(CIRCUIT_P, 2048, SEED, osd=ctx.osd_host)
    osd_n0 = tosd.osd_postprocess.shots
    t = time.time()
    sim34h.WordErrorRate(4 * 2048)
    dt = time.time() - t
    ok, diff, bound = within(sim34h.last_failures, ctx.run34[0],
                             sim34h.last_shots, 4 * 2048)
    no_rungs("48 (d)")
    if not ok or tosd.osd_postprocess.shots == osd_n0:
        raise AssertionError(f"phase 48 (d): host-OSD circuit "
                             f"{sim34h.last_failures} vs phase 34's "
                             f"{ctx.run34[0]} (|diff| {diff:.3e}, 4 sigma "
                             f"{bound:.3e})")
    out["d"] = (sim34h.last_failures, dt)
    log(f"[48d] phase 34's circuit engine with decoder 2 on the host OSD "
        f"(device_osd=False, the windowed loop): {sim34h.last_failures} / "
        f"{sim34h.last_shots} failures against phase 34's "
        f"{ctx.run34[0]} (|diff| {diff:.3e} <= 4 sigma {bound:.3e}), "
        f"{tosd.osd_postprocess.shots - osd_n0} shots through the host OSD, "
        f"{sim34h.last_shots / dt:.1f} shots/s ({dt:.2f} s)")
    log(f"phase 48 took {time.time() - t_new:.1f} s")
    return out


# phase 51's worker: one process serving phase 45's n625 sessions from a
# program cache directory (its argv: the checkout, the directory, the
# rows' file and the answers' file)
WARM51_WORKER = r"""
import json, sys, time
t0 = time.time()
root, cache, rows_path, out_path = sys.argv[1:5]
sys.path.insert(0, root)
import numpy as np
import torch
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import (BP_Decoder_Class,
                                                      BPOSD_Decoder_Class)
from qldpc_fault_tolerance_tpu_torch.serve import DecodeSession
from qldpc_fault_tolerance_tpu_torch.utils import progcache, telemetry
spec = json.loads(sys.argv[5])
dev = torch.device(spec["device"])
progcache.configure(cache)
telemetry.enable()
hx = load_code(spec["code"]).hx
n = hx.shape[1]
bp = BP_Decoder_Class(n / 50, "minimum_sum", 0.625, device=dev)
osd = BPOSD_Decoder_Class(n / 50, "minimum_sum", 0.625, "osd_e", 10,
                          device=dev)
t1 = time.time()
sessions = {name: DecodeSession(name, decoder_class=osd if name.endswith(
                "osd") else bp, params={"h": hx, "p_data": p},
                buckets=tuple(spec["buckets"]))
            for name, p in spec["sessions"].items()}
for s in sessions.values():
    s.warm()
t2 = time.time()
rows = np.load(rows_path)
out = {}
for name, s in sessions.items():
    for b in spec["buckets"]:
        key = f"{name}/{b}"
        out[key] = s.decode(rows[key]).corrections
t3 = time.time()
np.savez(out_path, **out)
snap = telemetry.snapshot()
print("RESULT" + json.dumps({
    "stats": progcache.stats(),
    "builds": snap.get("serve.session.builds", {}).get("value", 0),
    "state_loads": snap.get("serve.session.state_loads", {}).get("value", 0),
    "sources": {k: s.state_source for k, s in sessions.items()},
    "compiles": {k: s.compiles for k, s in sessions.items()},
    "loads": {k: s.loads for k, s in sessions.items()},
    "start_s": t1 - t0, "sessions_s": t2 - t1, "decode_s": t3 - t2}),
    flush=True)
"""


def host_recount(pairs) -> dict:
    """The counters of a run's decodes recounted on the host from their aux
    (numpy, one decode at a time): shots, converged, OSD-routed shots, the
    iteration histogram and sum over converged shots, the compaction tier
    of each OSD decode and the OSD-CS sweep's candidates and chunks."""
    import numpy as np

    from qldpc_fault_tolerance_tpu_torch.decoders.bp_decoders import \
        osd_compaction_tiers
    from qldpc_fault_tolerance_tpu_torch.ops.osd_cs_device import \
        cs_sweep_shape
    from qldpc_fault_tolerance_tpu_torch.utils.telemetry import ITER_BUCKETS

    out = {"bp.shots": 0, "bp.converged": 0, "osd.device_shots": 0,
           "osd.tier_none": 0, "osd.tier_compacted": 0, "osd.tier_full": 0,
           "osd.cs_candidates": 0, "osd.cs_chunks": 0, "sum": 0,
           "hist": np.zeros(len(ITER_BUCKETS) + 1, np.int64)}
    for static, aux in pairs:
        if aux.get("converged") is None:
            continue
        conv = aux["converged"].cpu().numpy().astype(bool)
        its = aux["iterations"].cpu().numpy().astype(np.int64)
        out["bp.shots"] += conv.size
        out["bp.converged"] += int(conv.sum())
        out["sum"] += int(its[conv].sum())
        out["hist"] += np.bincount(np.searchsorted(ITER_BUCKETS, its[conv]),
                                   minlength=len(ITER_BUCKETS) + 1)
        if static[0] != "bposd_dev":
            continue
        bad = int((~conv).sum())
        out["osd.device_shots"] += bad
        caps = osd_compaction_tiers(conv.size)
        tier = ("none" if bad == 0 else "compacted"
                if any(bad <= c for c in caps) else "full")
        out[f"osd.tier_{tier}"] += 1
        if len(static) > 6 and static[6] == "osd_cs":
            n_cand, n_chunks = cs_sweep_shape(*static[2:5])
            out["osd.cs_candidates"] += n_cand * bad
            out["osd.cs_chunks"] += n_chunks * (bad > 0)
    return out


def published(snap) -> dict:
    """The same counters as the registry published them."""
    import numpy as np

    from qldpc_fault_tolerance_tpu_torch.utils.telemetry import ITER_BUCKETS

    out = {k: snap.get(k, {}).get("value", 0) for k in (
        "bp.shots", "bp.converged", "osd.device_shots", "osd.tier_none",
        "osd.tier_compacted", "osd.tier_full", "osd.cs_candidates",
        "osd.cs_chunks")}
    hist = snap.get("bp.iterations", {})
    out["sum"] = int(hist.get("sum", 0))
    out["hist"] = np.asarray(hist.get("counts",
                                      [0] * (len(ITER_BUCKETS) + 1)))
    return out


def telemetry_phases(ctx) -> None:
    """Phases 49 and 50 (module docstring) on ``ctx.dev``: ``ctx`` holds
    the engines of phases 5, 6, 16, 25 (bf16) and 28, phase 39's codes,
    decoder classes and ledger record."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.parallel.shots import check_syncs
    from qldpc_fault_tolerance_tpu_torch.sim import common as simc
    from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
    from qldpc_fault_tolerance_tpu_torch.utils import profiling, telemetry

    dev = ctx.dev
    t_new = time.time()

    def same(tag, got, want):
        bad = {k: (got[k], want[k]) for k in want
               if not np.array_equal(np.asarray(got[k]), np.asarray(want[k]))}
        if bad:
            raise AssertionError(f"phase 49 {tag}: published != host "
                                 f"recount {bad}")

    def text(c):
        mean = c["sum"] / max(int(c["hist"].sum()), 1)
        return (f"bp.shots {c['bp.shots']}, bp.converged "
                f"{c['bp.converged']}, mean iterations {mean:.4f}, "
                f"histogram {c['hist'].tolist()}, osd.device_shots "
                f"{c['osd.device_shots']}, tiers "
                f"({c['osd.tier_none']}, {c['osd.tier_compacted']}, "
                f"{c['osd.tier_full']}), cs ({c['osd.cs_candidates']}, "
                f"{c['osd.cs_chunks']})")

    def run_engine(tag, sim, osd, run):
        """``run(sim)`` (one megabatch) through the telemetry-on graph under
        check_syncs, then eagerly with telemetry off inside a collector of
        every decode's aux: results equal, the published counters equal
        the host recount."""
        telemetry.reset()
        telemetry.enable()
        try:
            sim.min_logical_weight = sim.N
            t0 = time.time()
            with check_syncs():
                run(sim)
            dt = time.time() - t0
            got = (sim.last_failures, sim.min_logical_weight)
            reads = sim.last_host_reads / sim.last_megabatches
            pub = published(telemetry.snapshot())
        finally:
            telemetry.disable()
        sim.min_logical_weight = sim.N
        with _kernels.force_eager(), telemetry.collect_device_aux() as aux:
            run(sim)
        off = (sim.last_failures, sim.min_logical_weight)
        if got != off or reads != 1:
            raise AssertionError(f"phase 49 {tag}: telemetry on {got}, off "
                                 f"{off}; {reads} host reads a megabatch")
        want = host_recount(aux)
        same(tag, pub, want)
        if osd and pub["osd.device_shots"] != \
                pub["bp.shots"] - pub["bp.converged"]:
            raise AssertionError(f"phase 49 {tag}: osd.device_shots "
                                 f"{pub['osd.device_shots']} != BP-failed "
                                 "shots")
        log(f"[49] {tag}: (failures, min_w) {got} == telemetry off; 1 host "
            f"read a megabatch ({sim.last_megabatches}); published == host "
            f"recount of the eager megabatch: {text(pub)}; {dt:.2f} s with "
            f"the capture")

    # 49. telemetry on the card
    runs = (("5 BP (bf16 head)", ctx.sim5, False,
             lambda s: s.WordErrorRate(8 * s.batch_size, key=KEY49)),
            ("6 BPOSD-E", ctx.sim6, True,
             lambda s: s.WordErrorRate(8 * s.batch_size, key=KEY49)),
            ("16 BPOSD-CS", ctx.sim16, True,
             lambda s: s.WordErrorRate(8 * s.batch_size, key=KEY49)),
            ("25 v2 bf16 (B5 aux)", ctx.sim25, False,
             lambda s: s.WordErrorRate(8 * s.batch_size, key=KEY49)),
            (f"28 phenom ({PHENOM49_ROUNDS} rounds)", ctx.sim28, True,
             lambda s: s.WordErrorRate(PHENOM49_ROUNDS, 8 * s.batch_size,
                                       key=KEY49)))
    for tag, sim, osd, run in runs:
        run_engine(tag, sim, osd, run)
        simc.release_graphs(sim)

    # one fused bucket of phase 40 (hgp_34_n225, every p of the
    # threshold's grid, one batch a cell)
    fam = CodeFamily(ctx.codes[:1], ctx.dec1, ctx.dec2, batch_size=ctx.batch,
                     seed=SEED, device=dev)
    p_list = sorted({c["cell"]["p"] for c in ctx.rec["cells"]})
    bucket = [(i, 0, ctx.codes[0], p) for i, p in enumerate(p_list)]
    telemetry.reset()
    telemetry.enable()
    try:
        prog = fam._data_bucket_program(bucket, "Total", ctx.batch)
        with check_syncs():
            got = simc.fused_cell_finish(simc.fused_cell_launch(prog)[0],
                                         tele=prog.tele)
        pub = published(telemetry.snapshot())
        reads, tele_on = prog.driver.host_reads, prog.tele
    finally:
        telemetry.disable()
        prog.release()
    prog = fam._data_bucket_program(bucket, "Total", ctx.batch)
    with _kernels.force_eager(), telemetry.collect_device_aux() as aux:
        off = simc.fused_cell_finish(simc.fused_cell_launch(prog)[0])
    prog.release()
    if not tele_on or prog.tele or reads != 1 or any(
            not np.array_equal(a, b) for a, b in zip(got, off)):
        raise AssertionError(f"phase 49 fused bucket: on {got}, off {off}, "
                             f"{reads} host reads")
    same("40 fused bucket", pub, host_recount(aux))
    log(f"[49] 40 fused bucket ({len(p_list)} cells x 1 batch of "
        f"{ctx.batch}, hgp_34_n225): (failures, shots, min_w) == telemetry "
        f"off; 1 host read; published == host recount: {text(pub)}")
    log(f"phase 49 took {time.time() - t_new:.1f} s")

    # 50. the waterfall: phase 5's run under profile_session
    t_new = time.time()
    sim5 = ctx.sim5
    shots50 = 16 * sim5.batch_size

    def run5():
        sim5.min_logical_weight = sim5.N
        with check_syncs():
            sim5.WordErrorRate(shots50, key=KEY49)
        return sim5.last_failures, sim5.min_logical_weight

    off = run5()  # profiling off: captures phase 5's graph again
    nodes_off = sim5.last_graph["nodes"]
    simc.release_graphs(sim5)
    with profiling.profile_session():
        with profiling.engine_scope("phase50") as acct:
            t0 = time.perf_counter()
            on = run5()
            wf = acct.waterfall(time.perf_counter() - t0)
        costs = profiling.program_costs()
    graph5 = sim5.last_graph
    (label, cost), = costs.items()
    st = wf["stages"]
    total = st["dispatch_launch_s"] + st["host_sync_s"] + st["host_gap_s"]
    if on != off or abs(total - wf["wall_s"]) > 5e-6 \
            or len({cost["nodes"], graph5["nodes"], nodes_off}) != 1 \
            or wf["n_dispatches"] != 2 or wf["n_syncs"] != 2:
        raise AssertionError(f"phase 50: profiling on {on}, off {off}; "
                             f"waterfall {wf}; cost {cost}; graph {graph5}")
    replay_s = wf["wall_s"] - graph5["warmup_s"] - graph5["capture_s"] \
        - graph5["instantiate_s"]
    util = profiling.derive_utilization(cost, 8 * sim5.batch_size,
                                        shots50 / replay_s)
    log(f"[50] phase 5's run under profile_session: (failures, min_w) {on} "
        f"== profiling off; waterfall {wf} (stages sum to the wall); graph "
        f"{label}: {cost['nodes']} nodes == the capture's, pool "
        f"{cost['pool_bytes'] / 2 ** 20:.1f} MiB, {cost['launches']} "
        f"launches captured ({cost['costed_launches']} costed: "
        f"{cost['ops']:.4g} ops, {cost['bytes_accessed']:.4g} B at max_iter); "
        f"rates against {profiling.device_peaks(dev)['name']}'s peaks {util}")
    # a torch.profiler trace of one replay, summed per kernel
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "replay.json")
        sim5.WordErrorRate(8 * sim5.batch_size, key=KEY49)  # warm
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            sim5.WordErrorRate(8 * sim5.batch_size, key=KEY49)
            torch.cuda.synchronize(dev)
        prof.export_chrome_trace(trace)
        summary = profiling.parse_trace(trace)
    names = [k for k in summary["kernels"] if "bp_minsum" in k]
    if not names:
        raise AssertionError(f"phase 50: the trace of one replay names no "
                             f"bp_minsum kernel: {summary}")
    log(f"[50] torch.profiler trace of one replay: device "
        f"{summary['device_s'] * 1e3:.3f} ms, kernels "
        + "; ".join(f"{k[:60]} {v * 1e3:.3f} ms"
                    for k, v in list(summary["kernels"].items())[:6]))
    gates = profiling.smem_gates(4096, *ctx.code.hx.shape,
                                 int(ctx.code.hx.sum(1).max()),
                                 int(ctx.code.hx.sum(0).max()), device=dev)
    log(f"[50] the card's gates at phase 5's shape: "
        + "; ".join(f"{k} {v['memory']} {v['threads']} threads "
                    f"{v['smem_bytes']} B {v['resident']} resident"
                    for k, v in gates["kernels"].items()))
    log(f"phase 50 took {time.time() - t_new:.1f} s")


def warm_restart_start(ctx):
    """Phase 51's first process (module docstring), started in the
    background: returns ``(process, directory, files)``."""
    import numpy as np

    tmp = tempfile.mkdtemp(prefix="qldpc_p51_")
    rng = np.random.default_rng(SEED + 51)
    hx = ctx.code.hx
    rows = {}
    for name, p in WARM51_SESSIONS.items():
        for b in WARM51_BUCKETS:
            k = b - 3  # padded to the bucket
            err = (rng.random((k, hx.shape[1])) < p).astype(np.float32)
            rows[f"{name}/{b}"] = ((err @ hx.T.astype(np.float32))
                                   .astype(np.int64) % 2).astype(np.uint8)
    files = {"rows": os.path.join(tmp, "rows.npz"),
             "cache": os.path.join(tmp, "cache"),
             "out1": os.path.join(tmp, "out1.npz"),
             "out2": os.path.join(tmp, "out2.npz")}
    np.savez(files["rows"], **rows)
    files["device"] = str(ctx.dev)
    proc = warm51_process(files, "out1")
    return proc, tmp, files


def warm51_process(files, out):
    spec = json.dumps({"code": str(CODE), "sessions": WARM51_SESSIONS,
                       "buckets": list(WARM51_BUCKETS),
                       "device": files["device"]})
    return subprocess.Popen(
        [sys.executable, "-c", WARM51_WORKER, str(ROOT), files["cache"],
         files["rows"], files[out], spec], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def warm51_result(proc, tag):
    try:
        out, err = proc.communicate(timeout=WARM51_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"phase 51 {tag} process timed out")
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 51 {tag} process failed "
                             f"({proc.returncode}): {err[-3000:]}")
    return json.loads(lines[-1][len("RESULT"):])


def warm_restart_phase(ctx, started) -> None:
    """Phase 51 (module docstring): the first process's results, a second
    fresh process from its directory, then a truncated artifact in this
    process."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
    from qldpc_fault_tolerance_tpu_torch.serve import DecodeSession
    from qldpc_fault_tolerance_tpu_torch.utils import progcache

    t_new = time.time()
    proc, tmp, files = started
    try:
        first = warm51_result(proc, "first")
        proc = warm51_process(files, "out2")
        second = warm51_result(proc, "second")
        n_prog = len(WARM51_SESSIONS) * len(WARM51_BUCKETS)
        n_sess = len(WARM51_SESSIONS)
        s1, s2 = first["stats"], second["stats"]
        a1, a2 = np.load(files["out1"]), np.load(files["out2"])
        same = all(np.array_equal(a1[k], a2[k]) for k in a1.files)
        if (s1["misses"], s1["stores"]) != (n_prog, n_prog + n_sess) \
                or s2["disk_hits"] != n_prog + n_sess \
                or s2["recaptures"] != n_prog or s2["misses"] != 0 \
                or second["builds"] != 0 \
                or set(second["sources"].values()) != {"disk"} \
                or any(second["compiles"].values()) \
                or sum(second["loads"].values()) != n_prog or not same:
            raise AssertionError(f"phase 51: first {first}, second {second}, "
                                 f"answers equal {same}")
        log(f"[51] warm restart from disk: first process {n_prog} programs "
            f"built and stored with {n_sess} states ({first['stats']}; "
            f"start {first['start_s']:.1f} s, sessions "
            f"{first['sessions_s']:.2f} s); a fresh process: disk hits "
            f"{s2['disk_hits']} (every (session, bucket) and each state), "
            f"decoder states rebuilt {second['builds']}, recaptures "
            f"{s2['recaptures']} (one a bucket), sessions "
            f"{second['sessions_s']:.2f} s against the first's "
            f"{first['sessions_s']:.2f} s; every answer bit-exact")
        # a truncated artifact in this process: a load error, rebuilt and
        # replaced
        name, b = "n625_a", WARM51_BUCKETS[0]
        progcache.configure(files["cache"])
        try:
            bp = BP_Decoder_Class(ctx.code.N / 50, "minimum_sum", 0.625,
                                  device=ctx.dev)
            probe = DecodeSession(name, decoder_class=bp,
                                  params={"h": ctx.code.hx,
                                          "p_data": WARM51_SESSIONS[name]},
                                  buckets=(b,))
            key = progcache.cache_key("serve.session", probe._prog_parts(
                probe.static, probe.state, probe.syndrome_width, b, False,
                probe._digest))
            path = os.path.join(files["cache"], key[:2],
                                key + progcache.ARTIFACT_SUFFIX)
            with open(path, "rb") as fh:
                head = fh.read(64)
            with open(path, "wb") as fh:
                fh.write(head)
            s0 = progcache.stats()
            got = probe.decode(np.load(files["rows"])[f"{name}/{b}"]
                               ).corrections
            s3 = progcache.stats()
            valid = torch.load(path, weights_only=False)["schema"] == 1
            if s3["load_errors"] != s0["load_errors"] + 1 \
                    or s3["stores"] != s0["stores"] + 1 or not valid \
                    or not np.array_equal(got, a1[f"{name}/{b}"]):
                raise AssertionError(f"phase 51 truncated artifact: {s0} -> "
                                     f"{s3}, replaced {valid}")
        finally:
            progcache.configure(None)
        log(f"[51] a truncated artifact ({name}, bucket {b}): one load "
            f"error, rebuilt and replaced (stores +1), its answers "
            f"bit-exact")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 51 took {time.time() - t_new:.1f} s")


# phase 52: the reference notebooks, their cells run unmodified through
# compat.install(device=...)
EXECUTED = ROOT / "examples" / "executed"
ST_NB = EXECUTED / "SpaceTimeDecodingDemo.executed.ipynb"
SS_NB = EXECUTED / "Single-Shot-checkpoint.executed.ipynb"
# SpaceTimeDecodingDemo cell 4's output as the JAX package's compat layer
# executed it, and the reference's own saved output (10k samples,
# scripts/run_reference_notebook.py)
ST52_JAX_OUT = 0.0002528
ST52_REFERENCE_OUT = 0.000193


def notebook_phase(ctx) -> dict:
    """Phase 52 (module docstring); returns its launches."""
    import warnings

    import numpy as np

    import qldpc_fault_tolerance_tpu_torch.compat as compat
    from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, ring_code
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BPOSD_Decoder,
        ST_BP_Decoder_Circuit,
        ST_BPOSD_Decoder_Circuit,
    )
    from qldpc_fault_tolerance_tpu_torch.sim import (
        CodeSimulator_Circuit_SpaceTime,
        CodeSimulator_DataError,
    )

    t_new = time.time()
    compat.install(device=ctx.dev)

    # (a) SpaceTimeDecodingDemo: cells 2-4 verbatim, then cell 5
    cells = compat.notebook_cells(ST_NB)
    ns: dict = {}
    exec(compat.notebook_header(cells), ns)
    exec(cells[2], ns)
    exec(cells[3], ns)
    ta = time.time()
    (wer_a, runs_a), launches_a = ctx.counted(
        lambda: compat.run_cell(cells[4], ns))
    ta = time.time() - ta
    sim_a = ns["circuit_simulator"]
    if len(runs_a) != 1 or runs_a[0] != (sim_a.last_failures,
                                         sim_a.last_shots):
        raise AssertionError(f"phase 52 (a): runs {runs_a}")
    exec(cells[5], ns)
    if not (len(ns["H_list"]) == len(ns["L_list"])
            == len(ns["channel_prob_list"]) > 0):
        raise AssertionError("phase 52 (a): cell 5 built no fault hypergraph")
    # the port's direct engine, built without the shims, the same seed
    code = hgp(ring_code(3), ring_code(3))
    p = 1e-3
    ep = {"p_i": 0 * p, "p_state_p": 0 * p, "p_m": 0 * p, "p_CX": 1 * p,
          "p_idling_gate": 0 * p}
    direct = CodeSimulator_Circuit_SpaceTime(
        code=code, p=p, num_cycles=13, num_rep=3, error_params=ep,
        eval_logical_type="Z", circuit_type="coloration",
        rand_scheduling_seed=1, device=ctx.dev)
    direct._generate_circuit()
    direct._generate_circuit_graph()
    g = direct.circuit_graph
    kw = dict(max_iter=int(code.N / 10), bp_method="minimum_sum",
              ms_scaling_factor=0.625, device=ctx.dev)
    direct.decoder1_z = ST_BP_Decoder_Circuit(
        h=g["h1"], channel_probs=g["channel_ps1"], **kw)
    direct.decoder2_z = ST_BPOSD_Decoder_Circuit(
        h=g["h2"], channel_probs=g["channel_ps2"], osd_method="osd_e",
        osd_order=10, **kw)
    wer_direct = direct.WordErrorRate(num_samples=10000)[0]
    if (direct.last_failures, direct.last_shots) != runs_a[0] \
            or wer_direct != wer_a:
        raise AssertionError(
            f"phase 52 (a): compat {runs_a[0]} wer {wer_a}, direct "
            f"{(direct.last_failures, direct.last_shots)} wer {wer_direct}")
    log(f"[52] (a) SpaceTimeDecodingDemo cells 2-5 through "
        f"compat.install(): hgp(ring_code(3), ring_code(3)) [[{code.N},"
        f"{code.K}]], 13 cycles, p_CX 1e-3, BP + BPOSD-E 10: WER per cycle "
        f"{wer_a:.7f} ({runs_a[0][0]} failures in {runs_a[0][1]} shots; "
        f"the JAX package's executed output {ST52_JAX_OUT}, the reference's "
        f"{ST52_REFERENCE_OUT}); == the direct engine bit for bit; cell 4 "
        f"{ta:.1f} s; launches "
        f"{ {k: v for k, v in launches_a.items() if v} }; "
        f"{len(ns['H_list'])} fault "
        f"hypergraphs from cell 5")

    # (b) Single-Shot: cells 2 and 3 verbatim (the author's paths through
    # load_object_compat)
    cells = compat.notebook_cells(SS_NB)
    ns = {}
    exec(compat.notebook_header(cells), ns)
    with warnings.catch_warnings(record=True) as subs:
        warnings.simplefilter("always")
        exec(cells[2], ns)
    tb = time.time()
    (_, runs_b), launches_b = ctx.counted(
        lambda: compat.run_cell(cells[3], ns))
    tb = time.time() - tb
    n_codes, n_p = len(ns["eval_code_list"]), len(ns["eval_p_list"])
    if len(runs_b) != n_codes * n_p or len(ns["eval_wer_list"]) != len(runs_b):
        raise AssertionError(f"phase 52 (b): {len(runs_b)} runs for "
                             f"{n_codes} codes x {n_p} p")
    # one cell, n625 at the first p, against the direct engine
    code = load_code(str(CODE))
    p = ns["eval_p_list"][0]
    probs = [p / 3, p / 3, p / 3]
    px, pz = probs[0] + probs[1], probs[1] + probs[2]
    kw = dict(max_iter=int(code.N / 10), bp_method="minimum_sum",
              ms_scaling_factor=0.625, osd_method="osd_e", osd_order=10,
              device=ctx.dev)
    direct = CodeSimulator_DataError(
        code=code,
        decoder_x=BPOSD_Decoder(h=code.hz, channel_probs=px * np.ones(code.N),
                                **kw),
        decoder_z=BPOSD_Decoder(h=code.hx, channel_probs=pz * np.ones(code.N),
                                **kw),
        pauli_error_probs=probs, device=ctx.dev)
    wer_direct = direct.WordErrorRate(1000)[0]
    i625 = [c.N for c in ns["eval_code_list"]].index(625) * n_p
    if (direct.last_failures, direct.last_shots) != runs_b[i625] \
            or wer_direct != ns["eval_wer_list"][i625]:
        raise AssertionError(
            f"phase 52 (b): compat {runs_b[i625]} wer "
            f"{ns['eval_wer_list'][i625]}, direct "
            f"{(direct.last_failures, direct.last_shots)} wer {wer_direct}")
    grid = np.reshape(np.array(ns["eval_wer_list"]), (n_codes, n_p))
    log(f"[52] (b) Single-Shot cells 2-3 through compat.install(): "
        f"{len([w for w in subs if 'substituting' in str(w.message)])} "
        f"author pickles substituted from codes_lib_tpu/; "
        f"{n_codes} codes x {n_p} p x 1000 runs, BPOSD-E 10, max_iter N/10"
        f"; cell 3 {tb:.1f} s (the JAX package's executed cell: 150.4 s); "
        f"p {[round(float(q), 5) for q in ns['eval_p_list']]}; WER "
        + "; ".join(f"[[{c.N},{c.K}]] "
                    + ", ".join(f"{w:.5f}" for w in row)
                    for c, row in zip(ns["eval_code_list"], grid))
        + f"; n625 at p {float(p):.5f} == the direct engine bit for bit "
        f"({runs_b[i625][0]} failures in {runs_b[i625][1]} shots); "
        f"launches { {k: v for k, v in launches_b.items() if v} }")

    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    head = launches["bp_minsum"] + launches["bp_minsum_bf16"]
    if head <= 0 or launches["osd_elim"] <= 0 \
            or launches_a["bp_minsum"] + launches_a["bp_minsum_bf16"] <= 0:
        raise AssertionError(f"phase 52 launched no kernel 1 / head or no "
                             f"elimination: (a) {launches_a}, (b) "
                             f"{launches_b}")
    no_rungs("52")
    log(f"phase 52 took {time.time() - t_new:.1f} s")
    return launches


# phase 53: kernel 1's sector mode on hz (+) hx of hgp_34_n625 (B53 shots of
# p = P53A errors, IT53 iterations), the fused X/Z decode of run_batch
# (RUN53_BATCHES batches of RUN53_BATCH at p = 0.01, BP-50), and the sweep
# monitor on a fused grid (MON53_P on hgp_34_n225 and n625, MON53_SHOTS a
# cell) with one bucket's rung stepped, then one cell at STALL53_P
B53, P53A, IT53 = 4096, 0.05, 50
RUN53_BATCH, RUN53_BATCHES = 4096, 8
MON53_P, MON53_SHOTS, STALL53_P = [0.01, 0.02, 0.03], 2048, 0.2


def sector_phase(ctx) -> dict:
    """Phase 53 (module docstring) on ``ctx.dev`` with ``ctx.code``
    (hgp_34_n625) and ``ctx.counted``; returns the kernels line's entry
    values of the sector mode."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BP_Decoder_Class,
        BPDecoder,
        BPOSD_Decoder_Class,
    )
    from qldpc_fault_tolerance_tpu_torch.decoders.bp_decoders import \
        FusedBPPair
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
    from qldpc_fault_tolerance_tpu_torch.ops.prng import prng_key
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError
    from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
    from qldpc_fault_tolerance_tpu_torch.utils import (
        diagnostics,
        faultinject,
        resilience,
        telemetry,
    )

    t_new = time.time()
    dev, code = ctx.dev, ctx.code
    hz, hx = code.hz, code.hx
    (ma, na), (mb, nb) = hz.shape, hx.shape
    h = np.zeros((ma + mb, na + nb), np.uint8)
    h[:ma, :na], h[ma:, na:] = hz, hx
    sectors = ((ma, mb), (na, nb))

    # (a) the sector mode against its plain version and two kernel-1
    # launches
    rng = np.random.default_rng(SEED + 53)
    q = 2 * P53A / 3
    synd_a, synd_b = (torch.from_numpy(
        ((rng.random((B53, hm.shape[1])) < q).astype(np.uint8) @ hm.T % 2)
        .astype(np.uint8)).to(dev) for hm in (hz, hx))
    synd = torch.cat([synd_a, synd_b], dim=1)
    graph = tbp.build_tanner_graph(h, dev)
    g_a, g_b = tbp.build_tanner_graph(hz, dev), tbp.build_tanner_graph(hx, dev)
    llr_a = tbp.llr_from_probs(np.full(na, q), dev)
    llr_b = tbp.llr_from_probs(np.full(nb, q), dev)
    llr = torch.cat([llr_a, llr_b])

    def run_sec():
        return bk.bp_minsum(graph, synd, llr, max_iter=IT53,
                            ms_scaling_factor=0.625, sectors=sectors)

    def run_two():
        return (bk.bp_minsum(g_a, synd_a, llr_a, max_iter=IT53,
                             ms_scaling_factor=0.625),
                bk.bp_minsum(g_b, synd_b, llr_b, max_iter=IT53,
                             ms_scaling_factor=0.625))

    sec = run_sec()
    with _kernels.force_plain():
        plain = run_sec()
    ka, kb = run_two()
    two = (torch.cat([ka[0], kb[0]], 1), ka[1] & kb[1],
           torch.cat([ka[2], kb[2]], 1), torch.maximum(ka[3], kb[3]))
    torch.cuda.synchronize()
    names = ("error", "converged", "posterior", "iterations")
    for name, a, b, c in zip(names, sec, plain, two):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"phase 53 sector mode {name}: kernel, "
                                 f"plain and two kernel-1 launches differ")
    sec_err = float((sec[2] - plain[2]).abs().max())
    sec_ms = event_ms(run_sec, 10)
    two_ms = event_ms(run_two, 10)
    with _kernels.force_plain():
        sec_plain_ms = event_ms(run_sec, 2)
    work = [(int(ka[3].sum()), int(g_a.chk_mask.sum()), na),
            (int(kb[3].sum()), int(g_b.chk_mask.sum()), nb)]
    sec_bound, sec_by = bp_bound_ms(graph, B53, None, sector_work=work)
    m2, rw2 = graph.chk_nbr.shape
    n2, cw2 = graph.var_nbr.shape
    lay = bk.card_minsum_layout(dev, 2 * B53, m2, n2, rw2, cw2, False,
                                rows=max(ma, mb, na, nb), sectors=True)
    lay1 = bk.card_minsum_layout(dev, B53, ma, na, rw2, cw2, False)
    log(f"[53] sector mode on hz (+) hx ({m2} x {n2}, sectors {sectors}), "
        f"{B53} shots of p={P53A} errors, {IT53} iterations: error, "
        f"converged, posterior, iterations == plain == two kernel-1 "
        f"launches (posterior max |diff| {sec_err}); converged "
        f"{float(sec[1].float().mean()):.4f}; one sector-mode launch "
        f"{sec_ms:.3f} ms against {two_ms:.3f} ms for the two launches, "
        f"plain {sec_plain_ms:.3f} ms, bound {sec_bound:.4f} ms ({sec_by}, "
        f"shot-iterations {work[0][0]} + {work[1][0]}); layout "
        f"{lay.lanes} items x {lay.threads // lay.lanes} threads per block, "
        f"{lay.grid} blocks, {lay.resident} resident per SM, "
        f"{lay.smem_bytes} B shared memory (one sector alone: {lay1.lanes} "
        f"shots x {lay1.threads // lay1.lanes} threads, {lay1.smem_bytes} "
        f"B)")

    # (b) the engine: run_batch with the fused pair == without it, per shot
    probs = np.full(code.N, 2 * 0.01 / 3)
    dx, dz = (BPDecoder(hm, probs, 50, bp_kernel="xla", device=dev)
              for hm in (hz, hx))
    if not FusedBPPair.compatible(dx, dz):
        raise AssertionError("phase 53: the float32 decoders do not fuse")
    sims = {fuse: CodeSimulator_DataError(
        code=code, decoder_x=dx, decoder_z=dz,
        pauli_error_probs=[0.01 / 3] * 3, seed=SEED,
        batch_size=RUN53_BATCH, device=dev, fuse_sectors=fuse)
        for fuse in (True, False)}
    if sims[True]._fused is None or sims[False]._fused is not None:
        raise AssertionError("phase 53: fuse_sectors did not build the pair")
    keys = [prng_key(SEED + 5300 + i) for i in range(RUN53_BATCHES)]

    def batches(sim):
        return [sim.run_batch(k) for k in keys]

    flags, walls, launches = {}, {}, {}
    for fuse in (True, False):
        batches(sims[fuse])  # warm
        torch.cuda.synchronize()
        t = time.time()
        flags[fuse], launches[fuse] = ctx.counted(
            lambda fuse=fuse: batches(sims[fuse]))
        walls[fuse] = time.time() - t
    if any(not np.array_equal(a, b)
           for a, b in zip(flags[True], flags[False])):
        raise AssertionError("phase 53: fused run_batch != unfused, per shot")
    if launches[True]["bp_minsum_sectors"] <= 0 \
            or launches[False]["bp_minsum_sectors"] \
            or launches[True]["bp_minsum"]:
        raise AssertionError(f"phase 53 launches: fused {launches[True]}, "
                             f"unfused {launches[False]}")
    shots53 = RUN53_BATCH * RUN53_BATCHES
    fails53 = int(sum(f.sum() for f in flags[True]))
    log(f"[53] run_batch of CodeSimulator_DataError(fuse_sectors=True) on "
        f"hgp_34_n625, BP-50 float32, p=0.01: {RUN53_BATCHES} batches of "
        f"{RUN53_BATCH}, {fails53} failures, == without the pair shot for "
        f"shot; {shots53 / walls[True]:.1f} shots/s fused "
        f"({launches[True]['bp_minsum_sectors']} sector-mode launches) "
        f"against {shots53 / walls[False]:.1f} unfused "
        f"({launches[False]['bp_minsum']} kernel-1 launches)")
    # the default decoders carry the bf16 head, which the pair refuses:
    # fuse_sectors warns and changes nothing; their shots/s is what a
    # user who does not pass bp_kernel="xla" gets
    dflt = [BPDecoder(hm, probs, 50, device=dev) for hm in (hz, hx)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim_d = CodeSimulator_DataError(
            code=code, decoder_x=dflt[0], decoder_z=dflt[1],
            pauli_error_probs=[0.01 / 3] * 3, seed=SEED,
            batch_size=RUN53_BATCH, device=dev, fuse_sectors=True)
    if sim_d._fused is not None or not any(
            "builds no FusedBPPair" in str(w.message) for w in caught):
        raise AssertionError("phase 53: fuse_sectors with the bf16-head "
                             "decoders built a pair or did not warn")
    batches(sim_d)  # warm
    torch.cuda.synchronize()
    t = time.time()
    flags_d, launches_d = ctx.counted(lambda: batches(sim_d))
    wall_d = time.time() - t
    if launches_d["bp_minsum_bf16"] <= 0 or launches_d["bp_minsum_sectors"]:
        raise AssertionError(f"phase 53 default decoders' launches "
                             f"{launches_d}")
    log(f"[53] the default decoders (bf16 head; fuse_sectors warns, builds "
        f"no pair): {int(sum(f.sum() for f in flags_d))} failures, "
        f"{shots53 / wall_d:.1f} shots/s unfused "
        f"({launches_d['bp_minsum_bf16']} bf16-head launches); fused "
        f"float32 / default = {wall_d / walls[True]:.3f}")

    # (c) the sweep monitor on a fused grid: one bucket's rung stepped by
    # two injected faults, then a cell above threshold
    codes = [load_code(str(ROOT / "codes_lib_tpu" / f"hgp_34_{t}.npz"))
             for t in ("n225", "n625")]
    fam = CodeFamily(codes, BP_Decoder_Class(30, "minimum_sum", 0.625,
                                             device=dev),
                     BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e",
                                         10, device=dev),
                     batch_size=2048, seed=SEED, device=dev)
    clear_rungs()
    plain_wer = fam.EvalWER("data", "Total", MON53_P, MON53_SHOTS,
                            if_plot=False, fused="auto")
    sink = telemetry.MemorySink()
    telemetry.reset()
    telemetry.enable()
    telemetry.add_sink(sink)
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="fused_cells_launch", kind="raise", after=1, count=2)])
    policy = resilience.RetryPolicy(max_attempts=4, base_delay=0.0,
                                    degrade_after=2, reset_caches=False)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with resilience.policy_override(policy), plan.active():
                mon_wer = fam.EvalWER("data", "Total", MON53_P, MON53_SHOTS,
                                      if_plot=False, fused="auto",
                                      ledger=tmp)
            (rec,) = diagnostics.load_ledger(tmp)
        with tempfile.TemporaryDirectory() as tmp:
            CodeFamily(codes[1:], fam.decoder1_class, fam.decoder2_class,
                       batch_size=2048, seed=SEED, device=dev).EvalWER(
                "data", "Total", [STALL53_P], MON53_SHOTS, if_plot=False,
                fused="auto", ledger=tmp)
            (rec_stall,) = diagnostics.load_ledger(tmp)
    finally:
        telemetry.remove_sink(sink)
        telemetry.disable()
    rungs = clear_rungs()
    kinds = [a["anomaly"] for a in rec["anomalies"]]
    ladder = [a for a in rec["anomalies"] if a["anomaly"] == "ladder_degrade"]
    # the grid's cells in order: n225's, then n625's
    n625 = [c["cell"] for c in rec["cells"][len(MON53_P):]]
    tags = [rec["cells"][0]["cell"]["code"], n625[0]["code"]]
    progress = {tuple(sorted({c.get("code") for c in e["cells"]}))
                for e in sink.records if e["kind"] == "cell_progress"}
    if not np.array_equal(np.asarray(mon_wer), np.asarray(plain_wer)):
        raise AssertionError(f"phase 53: the monitored rates {mon_wer} != "
                             f"the monitor-off run's {plain_wer}")
    if rungs != {"packed->dense": 1} or len(ladder) != 1 \
            or ladder[0]["cells"] != n625 \
            or ladder[0]["rungs"] != ["packed->dense"]:
        raise AssertionError(f"phase 53: rungs {rungs}, ladder anomalies "
                             f"{ladder}, n625 cells {n625}")
    for c in rec["cells"]:
        want = "packed->dense" if c["cell"] in n625 else None
        if c.get("substrate") != want:
            raise AssertionError(f"phase 53: cell {c['cell']} labelled "
                                 f"{c.get('substrate')}, not {want}")
    if sorted(kinds) != ["ladder_degrade", "substrate_mismatch"]:
        raise AssertionError(f"phase 53: anomalies {rec['anomalies']}")
    if progress != {(tags[0],), (tags[1],)}:
        raise AssertionError(f"phase 53: cell_progress events of {progress}")
    stall = [a for a in rec_stall["anomalies"]
             if a["anomaly"] == "stalled_convergence"]
    if len(stall) != 1:
        raise AssertionError(f"phase 53: the cell at p={STALL53_P}: "
                             f"anomalies {rec_stall['anomalies']}")
    log(f"[53] sweep monitor on the fused grid {MON53_P} x (n225, n625), "
        f"{MON53_SHOTS} shots a cell, two faults at the n625 bucket's "
        f"launch: rungs {rungs}; anomalies {kinds} (ladder_degrade names "
        f"the {len(n625)} n625 cells, each labelled packed->dense); "
        f"cell_progress from the buckets {sorted(progress)}; no stall or "
        f"drift; rates == the monitor-off run; the cell at p={STALL53_P}: "
        f"stalled_convergence, converged fraction "
        f"{stall[0]['converged_fraction']} of {stall[0]['shots']} BP shots")
    log(f"phase 53 took {time.time() - t_new:.1f} s")
    return {"launches": launches[True]["bp_minsum_sectors"],
            "max_abs_err": sec_err, "ms": sec_ms, "plain_ms": sec_plain_ms,
            "bound_ms": sec_bound, "bound_by": sec_by}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir() or not CODE.exists():
        print(f"chip_smoke: run from a checkout holding {PKG}/ and "
              f"codes_lib_tpu/", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # phase 36's detector error model: pure host work, built beside the
    # card's phases
    dem_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        dem_job = dem_pool.submit(build_dem, str(ROOT), str(CODE), CIRCUIT_P)
        cpu42_job = dem_pool.submit(mesh42_cpu, str(ROOT), str(CODE))
        return run_phases(dem_job, cpu42_job)
    finally:
        dem_pool.shutdown(wait=True, cancel_futures=True)
        stop_children()


def child_pids() -> list:
    """The pids of this process's live children (read from /proc)."""
    me, pids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        # the fields after the parenthesised command: state, then ppid
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            pids.append(int(entry))
    return pids


def stop_children() -> None:
    """Stop every process the script started that still runs: the
    resource tracker that the spawn pool's queues started (it outlives its
    parent by the moment it takes to read end-of-file), and any child that
    a failed phase left behind."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if hasattr(tracker, "_stop"):
        tracker._stop()
    for pid in child_pids():
        print(f"chip_smoke: stopping a leftover child process {pid}",
              file=sys.stderr)
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    left = child_pids()
    if left:
        raise RuntimeError(f"child processes {left} outlived their stop")


def thread_report() -> str:
    """The threads other than the main one that are still alive, each
    with the function it is in."""
    import threading

    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        if t is threading.main_thread():
            continue
        f = frames.get(t.ident)
        where = (f"{Path(f.f_code.co_filename).name}:{f.f_lineno} "
                 f"{f.f_code.co_name}" if f is not None else "?")
        out.append(f"{t.name} ({'daemon' if t.daemon else 'not daemon'}, "
                   f"in {where})")
    return "; ".join(out) or "none"


def run_phases(dem_job, cpu42_job) -> int:
    """Phases 1-53 (module docstring); ``dem_job`` the future of phase
    36's decoding graphs, ``cpu42_job`` that of phase 42's CPU run."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.codes.gf2 import block_diag
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BPDecoder,
        BPOSD_Decoder,
        decode_device,
    )
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
    from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
    from qldpc_fault_tolerance_tpu_torch.ops.gf2_packed import pack_shots, unpack_shots
    from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs
    from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
    from qldpc_fault_tolerance_tpu_torch.ops.bp_kernel import bp_minsum
    from qldpc_fault_tolerance_tpu_torch.parallel.shots import check_syncs
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError
    from qldpc_fault_tolerance_tpu_torch.sim.common import wer_single_shot

    t_start = time.time()
    dev = torch.device("cuda", 0)
    graph_stats = {}  # phase tag -> what its graph run measured

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.time()
    libs = _kernels.build_all()
    log(f"[2] built {sorted(libs)} in {time.time() - t0:.2f} s; each launch "
        f"is held against its plain version {PLAIN_VERSIONS}")

    code = load_code(str(CODE))
    hx = code.hx
    m, n = hx.shape
    rng = np.random.default_rng(SEED)

    # 3. kernel 1 vs its plain version
    B1, p1, it1, scale = 4096, 0.05, 50, 0.625
    err = (rng.random((B1, n)) < 2 * p1 / 3).astype(np.uint8)
    synd = torch.from_numpy((err @ hx.T % 2).astype(np.uint8)).to(dev)
    graph = tbp.build_tanner_graph(hx, dev)
    llr0 = tbp.llr_from_probs(np.full(n, 2 * p1 / 3), dev)

    def run_k1():
        return bp_minsum(graph, synd, llr0, max_iter=it1, ms_scaling_factor=scale)

    k1 = run_k1()
    with _kernels.force_plain():
        p1_out = run_k1()
    torch.cuda.synchronize()
    for name, a, b in zip(("error", "converged", "iterations"),
                          (k1[0], k1[1], k1[3]), (p1_out[0], p1_out[1], p1_out[3])):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel 1 {name} differs from the plain version")
    k1_err = float((k1[2] - p1_out[2]).abs().max())
    if k1_err > 0.0:  # tolerance 0: built with -fmad=false, same op order
        raise AssertionError(f"kernel 1 posterior differs by {k1_err}")
    k1_ms = event_ms(run_k1, 10)
    with _kernels.force_plain():
        k1_plain_ms = event_ms(run_k1, 2)
    shot_iters = int(k1[3].sum())
    k1_bound, k1_by = bp_bound_ms(graph, B1, shot_iters)
    msg_bytes = shot_iters * message_bytes(graph)
    log(f"[3] kernel 1 == plain (posterior max |diff| {k1_err}); converged "
        f"{float(k1[1].float().mean()):.4f}; kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms ({k1_by}); "
        f"{shot_iters} shot-iterations move {msg_bytes / 1e9:.4f} GB of "
        f"messages; layout {layout_text(bk, dev, B1, m, n, False)}")

    # 4. kernel 2 vs its plain version, at 256 shots and at the main path's
    # 512-shot straggler tier
    plan = tod.build_osd_plan(hx, np.full(n, 2 * p1 / 3), device=dev)
    r_star = plan.rank
    w = min(10, n - r_star)
    bad = torch.nonzero(~k1[1]).flatten()[:max(ELIM_SHOTS)]
    if bad.numel() < max(ELIM_SHOTS):
        raise AssertionError(f"only {bad.numel()} BP failures in phase 3")
    h01 = tod._unpack_rows(plan.packed, n)
    elim_in = {}  # shots: (perm, syndromes, packed rows for the work count)
    for B2 in ELIM_SHOTS:
        perm = torch.sort(k1[2][bad[:B2]], dim=1, stable=True).indices
        elim_in[B2] = (perm, synd[bad[:B2]].to(torch.int32).t().contiguous(),
                       tod._permute_and_pack(h01, perm))
    k2_err, k2_times = 0, {}
    for B2, (perm, synd2, packed) in elim_in.items():
        def run_k2(perm=perm, synd2=synd2):
            return tod.osd_elim(plan.packed, perm, synd2, n=n, r_star=r_star,
                                fcap=w)

        k2 = run_k2()
        with _kernels.force_plain():
            p2_out = run_k2()
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(k2, p2_out))
        if err != 0:  # tolerance 0: integer words
            raise AssertionError(f"kernel 2 differs from the plain version "
                                 f"at {B2} shots")
        k2_err = max(k2_err, err)
        with _kernels.force_plain():
            plain_ms = event_ms(run_k2, 1)
        work = tod.elimination_work(packed, synd2, n=n, r_star=r_star, fcap=w)
        # written: the syndrome, the pivots, the free panel and w free
        # positions
        bound = elim_bound_ms(n, m, B2, m + 2 * r_star + m + w, work)
        k2_times[B2] = (event_ms(run_k2, 20), plain_ms) + bound
        log(f"[4] kernel 2 == plain at {B2} shots (all five outputs "
            f"bit-exact); rank {r_star}, fcap {w}, word ops {work}; kernel "
            f"{k2_times[B2][0]:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
            f"layout {elim_layout_text(tod, dev, B2, m, n, w, 'skip')}")
    k2_ms, k2_plain_ms, k2_bound, k2_by = k2_times[256]

    def simulator(decoder_cls, p, batch, seed, **kw):
        probs = np.full(n, 2 * p / 3)
        dx = decoder_cls(code.hz, probs, 50, device=dev, **kw)
        dz = decoder_cls(code.hx, probs, 50, device=dev, **kw)
        return CodeSimulator_DataError(
            code=code, decoder_x=dx, decoder_z=dz,
            pauli_error_probs=[p / 3] * 3, seed=seed, batch_size=batch,
            scan_chunk=8, device=dev)

    def graph_run(tag, sim, run):
        """``run(sim)`` through its captured graph under check_syncs: the
        host reads and the capture's cost logged and held (phases in
        SYNC_FREE); returns (result, wall s, replay wall s, text)."""
        reads0 = (tbp.bp_decode_two_phase.host_reads, decode_device.host_reads)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        with check_syncs():
            out = run(sim)
        dt = time.time() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        reads = (tbp.bp_decode_two_phase.host_reads - reads0[0],
                 decode_device.host_reads - reads0[1])
        g = sim.last_graph
        per_mb = sim.last_host_reads / sim.last_megabatches
        setup = g["warmup_s"] + g["capture_s"] + g["instantiate_s"] \
            if g is not None else 0.0
        if tag.split()[0] in SYNC_FREE and (per_mb != 1 or reads != (0, 0)):
            raise AssertionError(
                f"phase {tag}: {per_mb} host reads per megabatch, tier "
                f"reads (two-phase, OSD) {reads}")
        text = (f"host reads: {per_mb:.3f} per megabatch "
                f"({sim.last_megabatches} megabatches), tier reads two-phase "
                f"{reads[0]}, OSD {reads[1]}; graph: " + (
                    "none (replayed a cached capture)" if g is None else
                    f"warm-up {g['warmup_s']:.3f} s, capture "
                    f"{g['capture_s']:.3f} s, instantiate "
                    f"{g['instantiate_s']:.3f} s, {g['nodes']} nodes")
                + f"; peak device memory {peak:.1f} MiB")
        graph_stats[tag] = {"per_megabatch": per_mb, "peak_mib": peak,
                            "wall_s": dt, "replay_s": dt - setup,
                            "shots": sim.last_shots, **(g or {})}
        return out, dt, dt - setup, text

    def graph_vs_eager(tag, sim, n_batches, rounds=None):
        """One megabatch of the phase's graph (``sim``'s, ``n_batches``
        batches a run) on a fresh key against the same megabatch run
        eagerly: (failures, min weight) equal.  After the phase's counted
        run, so its launches count in no phase."""
        shots = min(n_batches, 8) * sim.batch_size
        got = []
        for ctx in (check_syncs, _kernels.force_eager):
            sim.min_logical_weight = sim.N
            with ctx():
                if rounds is None:
                    sim.WordErrorRate(shots, key=GRAPH_KEY)
                else:
                    sim.WordErrorRate(rounds, shots, key=GRAPH_KEY)
            got.append((sim.last_failures, sim.min_logical_weight))
        if got[0] != got[1]:
            raise AssertionError(f"phase {tag}: one megabatch, graph "
                                 f"{got[0]} vs eager {got[1]}")
        log(f"[{tag}] one megabatch ({sim.last_shots} shots), graph == eager "
            f"(failures, min_w) {got[0]}")

    def wer_phase(tag, sim, n_batches):
        (wer, eb), dt, dt_replay, text = graph_run(
            tag, sim, lambda s: s.WordErrorRate(n_batches * s.batch_size))
        run = (sim.last_failures, sim.min_logical_weight)
        log(f"[{tag}] failures {sim.last_failures} shots {sim.last_shots} "
            f"WER {wer:.6e} +- {eb:.3e} min_w {sim.min_logical_weight} "
            f"{sim.last_shots / dt_replay:.1f} shots/s replayed "
            f"({dt_replay:.3f} s; {sim.last_shots / dt:.1f} with the capture, "
            f"{dt:.2f} s); {text}")
        return run

    counters = {"gf2_sample": (gk.sample_syndrome, "launches"),
                "gf2_residual": (gk.residual_check_stats, "launches"),
                "fused_decode": (gk.fused_decode_stats, "launches"),
                "fused_decode_int8": (gk.fused_decode_stats, "int8_launches"),
                "bp_minsum": (bp_minsum, "launches"),
                "bp_minsum_sectors": (bp_minsum, "sector_launches"),
                "osd_elim": (tod.osd_elim, "launches"),
                "osd_elim_full": (tod.osd_elim, "full_launches"),
                "osd_elim_percol": (tod.osd_elim_percol, "launches"),
                "cs_sweep": (tcs.cs_sweep, "launches"),
                "cs_sweep_rows": (tcs.cs_sweep_rows, "launches"),
                "bp_int8": (bk.bp_head_int8, "launches"),
                "bp_minsum_bf16": (bk.bp_head_bf16, "launches"),
                # launches of the device-memory modes (among the above)
                "osd_elim_device": (tod.osd_elim, "device_launches"),
                "osd_elim_full_device": (tod.osd_elim, "full_device_launches"),
                "osd_elim_percol_device": (tod.osd_elim_percol,
                                           "device_launches"),
                # launches of the elimination's transform mode (among the
                # above)
                "osd_elim_transform": (tod.osd_elim, "transform_launches"),
                "osd_elim_full_transform": (tod.osd_elim,
                                            "full_transform_launches"),
                "bp_minsum_device": (bp_minsum, "device_launches"),
                "bp_minsum_device_planes": (bp_minsum,
                                            "device_planes_launches"),
                "bp_minsum_bf16_device": (bk.bp_head_bf16, "device_launches"),
                "bp_minsum_bf16_device_planes": (bk.bp_head_bf16,
                                                 "device_planes_launches"),
                # launches of the check-state mode (among the above)
                "bp_minsum_checks": (bp_minsum, "checks_launches"),
                "bp_minsum_bf16_checks": (bk.bp_head_bf16, "checks_launches"),
                # launches of the wide instances (row weights 33-64)
                "bp_minsum_wide": (bp_minsum, "wide_launches"),
                "bp_minsum_bf16_wide": (bk.bp_head_bf16, "wide_launches"),
                "bp_int8_wide": (bk.bp_head_int8, "wide_launches"),
                "fused_decode_wide": (gk.fused_decode_stats, "wide_launches"),
                "fused_decode_int8_wide": (gk.fused_decode_stats,
                                           "int8_wide_launches")}

    def fold_counts():
        """Add the replays' launches, counted on the device, to the
        counters (a read outside any timed run)."""
        _kernels.fold_launch_counts(dev, _kernels.launch_counts(dev).tolist())

    def counted(fn):
        """Every launch count set to 0, ``fn`` run, the counts read; returns
        ``fn()``'s result and the counts."""
        fold_counts()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        out = fn()
        fold_counts()
        return out, {name: getattr(obj, attr)
                     for name, (obj, attr) in counters.items()}

    # 5-6. the main path, counts reset just before each run, read just after
    sim5 = simulator(BPDecoder, 0.01, 4096, SEED)
    run5, launches_5 = counted(lambda: wer_phase("5 BP p=0.01", sim5, 16))
    sim6 = simulator(BPOSD_Decoder, 0.05, 2048, SEED, osd_method="osd_e",
                     osd_order=10)
    run6, launches_6 = counted(lambda: wer_phase("6 BPOSD p=0.05", sim6, 8))
    graph_vs_eager("5", sim5, 16)
    graph_vs_eager("6", sim6, 8)
    log(f"[5] launches {launches_5}; decoders' program "
        f"{sim5.decoder_z.kernel_variant}\n[6] launches {launches_6}")
    for tag, run in (("5", run5), ("6", run6)):
        if tuple(run) != MINSUM_RUNS[tag]:
            raise AssertionError(f"phase {tag} (failures, min_w) {run} != "
                                 f"{MINSUM_RUNS[tag]}")
    for name, count in (("bp_minsum_bf16", launches_5["bp_minsum_bf16"]),
                        ("bp_minsum_bf16", launches_6["bp_minsum_bf16"]),
                        ("osd_elim", launches_6["osd_elim"])):
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # phase 5's simulator with target_failures: the graph's double-buffered
    # drain stops at the eager loop's megabatch with its counts
    stops = []
    for ctx in (check_syncs, _kernels.force_eager):
        with ctx():
            sim5.WordErrorRate(16 * 4096, key=GRAPH_KEY, target_failures=50)
        stops.append((sim5.last_failures, sim5.last_shots))
    if stops[0] != stops[1] or stops[0][1] >= 16 * 4096:
        raise AssertionError(f"target_failures: graph {stops[0]}, eager "
                             f"{stops[1]}")
    log(f"[5] target_failures=50: graph == eager (failures, shots) "
        f"{stops[0]} of {16 * 4096} shots")

    # 7. anchors
    sim0 = simulator(BPOSD_Decoder, 0.0, 2048, SEED, osd_method="osd_e",
                     osd_order=10)
    sim0.WordErrorRate(2 * 2048)
    if sim0.last_failures != 0:
        raise AssertionError(f"{sim0.last_failures} failures at p=0")
    log(f"[7] p=0: 0 failures in {sim0.last_shots} shots")
    sim_k = simulator(BPOSD_Decoder, 0.05, 2048, SEED + 1, osd_method="osd_e",
                      osd_order=10)
    sim_p = simulator(BPOSD_Decoder, 0.05, 2048, SEED + 1, osd_method="osd_e",
                      osd_order=10)
    sim_k.WordErrorRate(2048)
    t = time.time()
    with _kernels.force_plain():
        sim_p.WordErrorRate(2048)
    dt_plain = time.time() - t
    if (sim_k.last_failures, sim_k.min_logical_weight) != (
            sim_p.last_failures, sim_p.min_logical_weight):
        raise AssertionError(
            f"kernel path {sim_k.last_failures}/{sim_k.min_logical_weight} vs "
            f"plain path {sim_p.last_failures}/{sim_p.min_logical_weight}")
    log(f"[7] one BPOSD batch, kernels vs plain on the card: failures "
        f"{sim_k.last_failures} == {sim_p.last_failures}, min_w "
        f"{sim_k.min_logical_weight} == {sim_p.min_logical_weight} "
        f"(plain path {dt_plain:.2f} s)")
    Bs = 64
    e_small = (rng.random((Bs, n)) < 2 * p1 / 3).astype(np.uint8)
    s_small = (e_small @ hx.T % 2).astype(np.uint8)
    probs = np.full(n, 2 * p1 / 3)
    out_gpu = BPOSD_Decoder(hx, probs, 50, device=dev).decode_batch(s_small)
    out_cpu = BPOSD_Decoder(hx, probs, 50, device="cpu").decode_batch(s_small)
    if not ((out_gpu @ hx.T % 2) == s_small).all():
        raise AssertionError("card BPOSD corrections miss their syndromes")
    cost = np.log((1 - probs) / probs)
    same = (out_gpu == out_cpu).all(axis=1)
    tied = np.abs(out_gpu @ cost - out_cpu @ cost) < 1e-4
    if not (same | tied).all():
        raise AssertionError("card and CPU BPOSD disagree beyond cost ties")
    log(f"[7] {Bs} BPOSD shots, card vs CPU: {int(same.sum())} identical, "
        f"{int((~same & tied).sum())} cost-tied, all syndrome-consistent")
    # 256 shots: the card's bf16 head engages; a default CPU decoder decodes
    # in float32, so the CPU runs the same head's plain version, passed in
    Bh = 256
    e_head = (rng.random((Bh, n)) < 2 * p1 / 3).astype(np.uint8)
    s_head = torch.from_numpy((e_head @ hx.T % 2).astype(np.uint8))
    card_dec = BPOSD_Decoder(hx, probs, 50, device=dev)
    cpu_dec = BPOSD_Decoder(hx, probs, 50, device="cpu")
    head = card_dec.device_state["pallas"]
    cpu_state = dict(cpu_dec.device_state,
                     pallas=type(head)(*(t.cpu() for t in head)))
    before = bk.bp_head_bf16.launches
    out_gpu, aux_gpu = card_dec.decode_batch_device(s_head)
    if bk.bp_head_bf16.launches == before:
        raise AssertionError("the card's 256-shot decode missed the bf16 head")
    out_cpu, aux_cpu = decode_device(card_dec.device_static, cpu_state, s_head)
    for field in ("converged", "iterations", "posterior_llr"):
        if not torch.equal(aux_gpu[field].cpu(), aux_cpu[field]):
            raise AssertionError(f"card and CPU bf16 BP {field} differ")
    out_gpu, out_cpu = out_gpu.cpu().numpy(), out_cpu.numpy()
    same = (out_gpu == out_cpu).all(axis=1)
    tied = np.abs(out_gpu @ cost - out_cpu @ cost) < 1e-4
    if not (same | tied).all() or not (
            (out_gpu @ hx.T % 2) == s_head.numpy()).all():
        raise AssertionError("card and CPU BPOSD with the bf16 head disagree")
    log(f"[7] {Bh} BPOSD shots through the bf16 head, card vs CPU plain: BP "
        f"outputs bit-exact (converged {float(aux_gpu['converged'].float().mean()):.4f}); "
        f"{int(same.sum())} identical, {int((~same & tied).sum())} cost-tied")

    # 9. kernel B3 vs its plain version
    key = gk.fold_in(gk.split_key(gk.prng_key(SEED))[1], 0)
    p9, B9 = 0.01, 4096
    spec = gk.build_fused_spec(code.hx, code.hz, code.lx, code.lz,
                               [p9 / 3] * 3, dev)
    b3_err = 0
    for B, emit in ((B9, True), (B9, False), (4000, True)):
        k = gk.sample_syndrome(spec, key, B, emit_errors=emit)
        pl = gk.sample_syndrome_plain(spec, key, B, emit_errors=emit)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k, pl))
        if len(k) != len(pl) or err:  # tolerance 0: integer words
            raise AssertionError(f"B3 differs from its plain version at B={B}, "
                                 f"emit_errors={emit}")
        b3_err = max(b3_err, err)
    sxp, szp = gk.sample_syndrome(spec, key, B9, emit_errors=False)

    def run_b3():
        return gk.sample_syndrome(spec, key, B9, emit_errors=False)

    b3_ms = device_ms(run_b3, 20, "gf2_sample_kernel")
    b3_plain_ms = event_ms(lambda: gk.sample_syndrome_plain(
        spec, key, B9, emit_errors=False), 5)
    b3_bound, b3_by = sample_bound_ms(spec, B9, emit_errors=False)
    log(f"[9] B3 == plain (every word, B=4096 with and without errors, "
        f"B=4000); kernel {b3_ms:.4f} ms (profiler device time), plain "
        f"{b3_plain_ms:.3f} ms, bound {b3_bound:.4f} ms ({b3_by}), syndromes "
        f"only")

    # 10. kernel B4 vs its plain version, corrections from BP decodes
    probs9 = np.full(n, 2 * p9 / 3)
    cor_x, _ = BPDecoder(code.hz, probs9, 50, device=dev).decode_batch_device(
        unpack_shots(sxp, B9))
    cor_z, _ = BPDecoder(code.hx, probs9, 50, device=dev).decode_batch_device(
        unpack_shots(szp, B9))
    corx_p = pack_shots(cor_x).contiguous()
    corz_p = pack_shots(cor_z).contiguous()
    b4_err = 0
    for ev in ("X", "Z", "Total"):
        k = gk.residual_check_stats(spec, key, B9, corx_p, corz_p, ev)
        pl = gk.residual_check_plain(spec, key, B9, corx_p, corz_p, ev)
        k, pl = [int(x) for x in k], [int(x) for x in pl]
        if k != pl:  # tolerance 0: integer counts
            raise AssertionError(f"B4 {ev}: kernel {k} vs plain {pl}")
        b4_err = max(b4_err, *(abs(a - b) for a, b in zip(k, pl)))
        log(f"[10] B4 == plain, {ev}: failures {k[0]}, min_w {k[1]}")

    def run_b4():
        return gk.residual_check_stats(spec, key, B9, corx_p, corz_p, "Total")

    b4_ms = device_ms(run_b4, 20, "gf2_residual_kernel")
    b4_plain_ms = event_ms(lambda: gk.residual_check_plain(
        spec, key, B9, corx_p, corz_p, "Total"), 5)
    lf4 = logical_failures(spec, key, B9, corx_p, corz_p)
    b4_bound, b4_by = residual_bound_ms(spec, B9, lf4)
    log(f"[10] B4 kernel {b4_ms:.4f} ms (profiler device time), plain "
        f"{b4_plain_ms:.3f} ms, bound {b4_bound:.4f} ms ({b4_by}; "
        f"{lf4} logical failures)")

    # 12. main path, fused engines: counts reset just before each run, read
    # just after
    def fused_sim(decoder_cls, p, batch, fused, **kw):
        probs = np.full(n, 2 * p / 3)
        dx = decoder_cls(code.hz, probs, 50, device=dev, **kw)
        dz = decoder_cls(code.hx, probs, 50, device=dev, **kw)
        return CodeSimulator_DataError(
            code=code, decoder_x=dx, decoder_z=dz,
            pauli_error_probs=[p / 3] * 3, seed=SEED, batch_size=batch,
            scan_chunk=8, fused_sampler=fused, device=dev)

    fused_launches = {}
    runs = {}
    for tag, make, n_batches, needs in (
            ("v1 BP p=0.01", lambda: fused_sim(BPDecoder, 0.01, 4096, True),
             16, ("gf2_sample", "gf2_residual", "bp_minsum_bf16")),
            ("v2 BP p=0.01", lambda: fused_sim(BPDecoder, 0.01, 4096, "v2"),
             16, ("fused_decode",)),
            ("v1 BPOSD p=0.05", lambda: fused_sim(
                BPOSD_Decoder, 0.05, 2048, True, osd_method="osd_e",
                osd_order=10), 4,
             ("gf2_sample", "gf2_residual", "bp_minsum_bf16", "osd_elim"))):
        sim = make()
        _, launches = counted(lambda: wer_phase(f"12 {tag}", sim, n_batches))
        log(f"[12 {tag}] launches {launches}")
        for name in needs:
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on {tag}")
        for name, count in launches.items():
            fused_launches[name] = fused_launches.get(name, 0) + count
        runs[tag] = (sim.last_failures, sim.min_logical_weight)
    # v2 decodes with bf16 messages, v1 with float32 (the JAX package's
    # engines differ the same way): the same errors, failures within 4
    # combined binomial standard errors
    shots12 = 16 * 4096
    f1, f2 = (runs[t][0] / shots12 for t in ("v1 BP p=0.01", "v2 BP p=0.01"))
    sigma12 = ((f1 * (1 - f1) + f2 * (1 - f2)) / shots12) ** 0.5
    log(f"[12] v2 (bf16) failures {runs['v2 BP p=0.01'][0]} vs v1 (float32) "
        f"{runs['v1 BP p=0.01'][0]}: |diff| {abs(f2 - f1):.3e} of the shots "
        f"<= 4 sigma {4 * sigma12:.3e}")
    if abs(f2 - f1) > 4 * sigma12:
        raise AssertionError("fused v2 failures outside 4 binomial sigma of v1")

    # 13. anchors
    sim0 = fused_sim(BPDecoder, 0.0, 4096, "v2")
    sim0.WordErrorRate(2 * 4096)
    if sim0.last_failures != 0:
        raise AssertionError(f"v2: {sim0.last_failures} failures at p=0")
    log(f"[13] v2 p=0: 0 failures in {sim0.last_shots} shots")
    for fused in (True, "v2"):
        sim_k = fused_sim(BPDecoder, 0.05, 4096, fused)
        sim_p = fused_sim(BPDecoder, 0.05, 4096, fused)
        sim_k.WordErrorRate(4096)
        with _kernels.force_plain():
            sim_p.WordErrorRate(4096)
        got = [(s.last_failures, s.min_logical_weight) for s in (sim_k, sim_p)]
        if got[0] != got[1]:
            raise AssertionError(f"fused {fused}: kernel path {got[0]} vs "
                                 f"plain path {got[1]}")
        log(f"[13] fused {fused}, one p=0.05 batch: kernel path == plain path "
            f"(failures, min_w) {got[0]}")

    # 14. kernels B7 (fcap 0 and 10) and B10 vs their plain versions on
    # phase 4's shots, 256 and 512
    b7_err = b10_err = 0
    b7_times, b10_times = {}, {}
    for B2, (perm, synd2, packed) in elim_in.items():
        for fcap in (0, w):
            k = tod.osd_elim(plan.packed, perm, synd2, n=n, r_star=r_star,
                             fcap=fcap, full=True)
            with _kernels.force_plain():
                pl = tod.osd_elim(plan.packed, perm, synd2, n=n, r_star=r_star,
                                  fcap=fcap, full=True)
            torch.cuda.synchronize()
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(k, pl))
            if len(k) != 6 or err:  # tolerance 0: integer words
                raise AssertionError(f"B7 differs from its plain version at "
                                     f"fcap={fcap}, {B2} shots")
            b7_err = max(b7_err, err)
            if fcap == 0:
                b7_out = k

        def run_b7(perm=perm, synd2=synd2):
            return tod.osd_elim(plan.packed, perm, synd2, n=n, r_star=r_star,
                                fcap=0, full=True)

        def run_b10(perm=perm, synd2=synd2):
            return tod.osd_elim_percol(plan.packed, perm, synd2, n=n,
                                       r_star=r_star)

        k10 = run_b10()
        with _kernels.force_plain():
            p10 = run_b10()
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k10, p10))
        if err:
            raise AssertionError(f"B10 differs from its plain version at {B2} "
                                 f"shots")
        b10_err = max(b10_err, err)
        # the per-column route's pivots and reduced pivot rows are the full
        # blocked route's
        if not (torch.equal(k10[1], b7_out[1]) and torch.equal(k10[2], b7_out[2])
                and torch.equal(tod.pivot_rows(k10[4], k10[1]),
                                tod.pivot_rows(b7_out[5], b7_out[1]))):
            raise AssertionError("B10 pivots or pivot rows differ from B7's")
        rows_agree = torch.equal(k10[4], b7_out[5])
        with _kernels.force_plain():
            plain_ms = event_ms(run_b7, 1), event_ms(run_b10, 1)
        # both walk the same columns with no free panel: the same word
        # operations; B7 writes the syndrome, the pivots and the matrix, B10
        # those and r* pivot flags
        work0 = tod.elimination_work(packed, synd2, n=n, r_star=r_star, fcap=0)
        W = packed.shape[0]
        b7_times[B2] = (event_ms(run_b7, 20), plain_ms[0]) + \
            elim_bound_ms(n, m, B2, m + 2 * r_star + W * m, work0)
        b10_times[B2] = (event_ms(run_b10, 20), plain_ms[1]) + \
            elim_bound_ms(n, m, B2, m + 3 * r_star + W * m, work0)
        log(f"[14] {B2} shots: B7 == plain (fcap 0 and {w}: six outputs, the "
            f"matrix whole); B10 == plain (five outputs, the matrix whole); B10 "
            f"pivots and pivot rows == B7's, non-pivot rows "
            f"{'agree' if rows_agree else 'differ'}; {work0} word ops each; B7 "
            f"{b7_times[B2][0]:.4f} ms, plain {plain_ms[0]:.3f} ms, bound "
            f"{b7_times[B2][2]:.4f} ms ({b7_times[B2][3]}); B10 "
            f"{b10_times[B2][0]:.4f} ms, plain {plain_ms[1]:.3f} ms, bound "
            f"{b10_times[B2][2]:.4f} ms ({b10_times[B2][3]}); layouts "
            f"{elim_layout_text(tod, dev, B2, m, n, 0, 'full')} "
            f"and {elim_layout_text(tod, dev, B2, m, n, 0, 'percol')}")
    b7_ms, b7_plain_ms, b7_bound, b7_by = b7_times[256]
    b10_ms, b10_plain_ms, b10_bound, b10_by = b10_times[256]

    # 15. kernel B8 on those shots: the launch that builds its planes (the
    # main path's) and the launch over given planes, each against its plain
    # version
    order = 10
    cfg = (n, r_star, order, tcs.cs_pat_chunk(n, r_star, order), "pallas")
    B2 = 256
    _, x = tcs.sweep_inputs(cfg, plan.packed, plan.cost, synd[bad[:B2]],
                            k1[2][bad[:B2]], device=dev)
    f_cs, w_cs = x.free_perm.shape[0], min(order, n - r_star)
    rows_args = (x.packed, x.pr, x.signed_piv, x.cost_free, x.free_perm, x.base)
    sweep_kw = dict(n=n, w=w_cs, pat_chunk=cfg[3])

    def run_b8():
        return tcs.cs_sweep_rows(*rows_args, **sweep_kw)

    def run_b8_plain():
        return tcs.cs_sweep_rows_plain(*rows_args, **sweep_kw)

    k8, p8 = run_b8(), run_b8_plain()
    torch.cuda.synchronize()
    b8_err = float((k8[0] - p8[0]).abs().max())
    if b8_err or not torch.equal(k8[1], p8[1]):  # tolerance 0
        raise AssertionError("B8 with its planes differs from its plain version")
    dplane, xflat = tcs.cs_planes(tod.pivot_rows(x.packed, x.pr), x.signed_piv,
                                  x.cost_free, x.free_perm, n, w_cs)

    def run_b8_given():
        return tcs.cs_sweep(dplane, xflat, x.base, w=w_cs, pat_chunk=cfg[3])

    kg, pg = run_b8_given(), tcs.cs_sweep_plain(dplane, xflat, x.base, w=w_cs,
                                                pat_chunk=cfg[3])
    torch.cuda.synchronize()
    if float((kg[0] - pg[0]).abs().max()) or not torch.equal(kg[1], pg[1]):
        raise AssertionError("B8 over given planes differs from its plain "
                             "version")
    if not torch.equal(kg[1], k8[1]):
        raise AssertionError("B8's two launches pick different winners")
    b8_ms = device_ms(run_b8, 20, "cs_sweep_rows_kernel")
    b8_given_ms = device_ms(run_b8_given, 20, "cs_sweep_kernel")
    b8_plain_ms = event_ms(run_b8_plain, 2)
    # the library yardstick: what the port ran before B8 built its planes,
    # as PyTorch calls only: the pivot rows gathered, each packed word's
    # bit planes times the signed costs summed by torch.sum, then the TPU
    # formulation of the sweep as two cuBLAS products (selector planes times
    # the per-shot planes) and torch.argmin
    e1t, e2t, *_ = tcs._cs_plane(f_cs, w_cs, 1)
    e1t, e2t = torch.from_numpy(e1t).to(dev), torch.from_numpy(e2t).to(dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)[None, :, None]

    def run_b8_library():
        rows = tod.pivot_rows(x.packed, x.pr)
        W, r8, B8 = rows.shape
        bits = ((rows[:, :, None, :] >> shifts) & 1).to(torch.float32)
        dcost = (bits * x.signed_piv[None, :, None, :]).sum(dim=1)
        d = dcost.reshape(W * 32, B8)[:n].gather(0, x.free_perm) + x.cost_free
        tw = bits.reshape(W, r8, 32, B8).permute(0, 2, 1, 3).reshape(
            W * 32, r8, B8)[:n].gather(0, x.free_perm[:w_cs, None, :].expand(
                w_cs, r8, B8))
        xf = torch.einsum("arb,rb,crb->acb", tw, x.signed_piv, tw).reshape(
            w_cs * w_cs, B8)
        costs = (e1t @ d).add_(x.base).sub_(2.0 * (e2t @ xf))
        return costs.argmin(dim=0)

    lib_idx = run_b8_library()
    b8_library_ms = event_ms(run_b8_library, 5)
    b8_bound, b8_by = sweep_rows_bound_ms(x, w_cs)
    b8_given_bound, _ = sweep_bound_ms(f_cs, w_cs, B2)
    log(f"[15] B8 with its planes == plain (cost and index, f={f_cs}, "
        f"w={w_cs}, {tcs.cs_sweep_shape(n, r_star, order)[0]} candidates, "
        f"{int((k8[1] > 0).sum())} of {B2} shots flip); kernel {b8_ms:.4f} "
        f"ms (profiler device time), plain {b8_plain_ms:.3f} ms, the "
        f"PyTorch pass and sweep it replaces {b8_library_ms:.4f} ms (index "
        f"agrees on {int((lib_idx == k8[1]).sum())} shots), bound "
        f"{b8_bound:.5f} ms ({b8_by}); B8 over given planes == plain, "
        f"{b8_given_ms:.4f} ms, bound {b8_given_bound:.5f} ms")

    # 16. main path, BPOSD-CS; 17. main path, the per-column route on phase
    # 6's run; counts reset just before each run, read just after
    sim16 = simulator(BPOSD_Decoder, 0.05, 2048, SEED, osd_method="osd_cs",
                      osd_order=10)
    run16, launches_16 = counted(lambda: wer_phase("16 BPOSD-CS p=0.05", sim16, 8))
    log(f"[16] launches {launches_16}")
    graph_vs_eager("16", sim16, 8)
    saved_elim = os.environ.get("QLDPC_OSD_ELIM")
    os.environ["QLDPC_OSD_ELIM"] = "pallas_percol"
    try:  # the route is read when the decoders are built
        sim17 = simulator(BPOSD_Decoder, 0.05, 2048, SEED, osd_method="osd_e",
                          osd_order=10)
    finally:
        if saved_elim is None:
            del os.environ["QLDPC_OSD_ELIM"]
        else:
            os.environ["QLDPC_OSD_ELIM"] = saved_elim
    run17, launches_17 = counted(
        lambda: wer_phase("17 BPOSD percol p=0.05", sim17, 8))
    log(f"[17] launches {launches_17}")
    for name, count in (("bp_minsum_bf16", launches_16["bp_minsum_bf16"]),
                        ("osd_elim_full", launches_16["osd_elim_full"]),
                        ("cs_sweep_rows", launches_16["cs_sweep_rows"]),
                        ("osd_elim_percol", launches_17["osd_elim_percol"])):
        if count <= 0:
            raise AssertionError(f"{name} never launched on its main path")
    if launches_17["osd_elim"] or launches_16["osd_elim"]:
        raise AssertionError("the blocked OSD-E kernel ran off its route")
    if launches_16["cs_sweep"]:
        raise AssertionError("BPOSD-CS swept given planes: the plane pass ran")
    if run17 != run6:
        raise AssertionError(f"per-column route {run17} != blocked route "
                             f"{run6} (failures, min_w)")
    for tag, run in (("16", run16), ("17", run17)):
        if tuple(run) != MINSUM_RUNS[tag]:
            raise AssertionError(f"phase {tag} (failures, min_w) {run} != "
                                 f"{MINSUM_RUNS[tag]}")
    log(f"[17] per-column route == blocked route: failures, min_w {run6}")

    # 18. anchors
    sim0 = simulator(BPOSD_Decoder, 0.0, 2048, SEED, osd_method="osd_cs",
                     osd_order=10)
    sim0.WordErrorRate(2 * 2048)
    if sim0.last_failures != 0:
        raise AssertionError(f"OSD-CS: {sim0.last_failures} failures at p=0")
    log(f"[18] OSD-CS p=0: 0 failures in {sim0.last_shots} shots")
    sims = [simulator(BPOSD_Decoder, 0.05, 2048, SEED + 1, osd_method="osd_cs",
                      osd_order=10) for _ in range(2)]
    sims[0].WordErrorRate(2048)
    t = time.time()
    with _kernels.force_plain():
        sims[1].WordErrorRate(2048)
    dt_plain = time.time() - t
    got = [(s.last_failures, s.min_logical_weight) for s in sims]
    if got[0] != got[1]:
        raise AssertionError(f"OSD-CS kernel path {got[0]} vs plain path "
                             f"{got[1]}")
    log(f"[18] one OSD-CS batch, kernels vs plain on the card: (failures, "
        f"min_w) {got[0]} == {got[1]} (plain path {dt_plain:.2f} s)")

    def bits_equal(name, a, b) -> float:
        """Outputs compared bit for bit (floats by their bit patterns);
        returns the largest absolute difference, 0.0 when they agree."""
        for field, x, y in zip(("error", "converged", "posterior",
                                "iterations"), a, b):
            xb, yb = x, y
            if x.dtype == torch.float32:
                xb = x.contiguous().view(torch.int32)
                yb = y.contiguous().view(torch.int32)
            if not torch.equal(xb, yb):
                raise AssertionError(f"{name} {field} differs from the plain "
                                     f"version")
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))

    # 19. kernel B6 vs its plain version on phase 3's syndromes
    graph_host = tbp.build_tanner_graph_host(hx)
    sg = bk.build_sparse_head(graph_host, dev)
    kw6 = dict(ms_scaling_factor=scale)

    def run_b6():
        return bk.bp_head_int8(sg, synd, llr0, head_iters=it1, block_b=256,
                               **kw6)

    k6 = run_b6()
    with _kernels.force_plain():
        p6 = run_b6()
    torch.cuda.synchronize()
    b6_err = bits_equal("B6 head", k6, p6)  # tolerance 0: integer messages, fixed
    # float order, -fmad=false with explicit fused multiply-adds
    head3 = bk.bp_head_int8(sg, synd, llr0, head_iters=3, block_b=256, **kw6)
    strag = torch.nonzero(~head3[1]).flatten()[:768]
    tail_rows = torch.cat([synd[strag], synd.new_zeros((1024 - strag.numel(), m))])

    def run_b6_tail():
        return bk.bp_head_int8(sg, tail_rows, llr0, head_iters=it1,
                               block_b=512, early_stop=True, **kw6)

    k6t = run_b6_tail()
    with _kernels.force_plain():
        p6t = run_b6_tail()
    torch.cuda.synchronize()
    b6_err = max(b6_err, bits_equal("B6 tail", k6t, p6t))
    b6_ms, b6_tail_ms = event_ms(run_b6, 5), event_ms(run_b6_tail, 5)
    with _kernels.force_plain():
        b6_plain_ms = event_ms(run_b6, 1)
    b6_iters = int8_shot_iters(k6[3], 256, it1, False)
    b6_bound, b6_by = int8_bound_ms(sg, B1, b6_iters)
    b6t_bound, _ = int8_bound_ms(sg, 1024, int8_shot_iters(k6t[3], 512, it1, True))
    log(f"[19] B6 == plain (head at tile 256, 50 iterations: converged "
        f"{float(k6[1].float().mean()):.4f}; tail of {strag.numel()} "
        f"stragglers + {1024 - strag.numel()} sentinel rows at tile 512 with "
        f"early exit: converged {float(k6t[1].float().mean()):.4f}); head "
        f"{b6_ms:.3f} ms, plain {b6_plain_ms:.3f} ms, bound {b6_bound:.4f} ms "
        f"({b6_by}; {b6_iters} shot-iterations); tail {b6_tail_ms:.3f} ms, "
        f"bound {b6t_bound:.4f} ms; layout (shots per block, blocks per "
        f"cluster) {bk.int8_layout(256, 7, m, n)} / "
        f"{bk.int8_layout(512, 7, m, n)}")

    # 20. the bf16 head vs its plain version on the same syndromes: the head
    # at the v2 gate's tile without early exit, then a compacted tail with
    # early exit, as phase 19 runs B6
    sgh = bk.build_sparse_head(graph_host, dev)

    def run_bf16():
        return bk.bp_head_bf16(sgh, synd, llr0, head_iters=it1, **kw6)

    kb = run_bf16()
    torch.cuda.synchronize()
    with _kernels.force_plain():
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        pb = run_bf16()
        t1.record()
        torch.cuda.synchronize()
        bf16_plain_ms = t0.elapsed_time(t1)
    # tolerance 0: the plain version's operation order, -fmad=false
    bf16_err = bits_equal("bf16 head", kb, pb)
    head3b = bk.bp_head_bf16(sgh, synd, llr0, head_iters=3, **kw6)
    stragb = torch.nonzero(~head3b[1]).flatten()[:768]
    tail_b = torch.cat([synd[stragb], synd.new_zeros((1024 - stragb.numel(), m))])

    def run_bf16_tail():
        return bk.bp_head_bf16(sgh, tail_b, llr0, head_iters=it1,
                               early_stop=True, **kw6)

    kbt = run_bf16_tail()
    with _kernels.force_plain():
        pbt = run_bf16_tail()
    torch.cuda.synchronize()
    bf16_err = max(bf16_err, bits_equal("bf16 head tail", kbt, pbt))
    bf16_ms, bf16_tail_ms = event_ms(run_bf16, 5), event_ms(run_bf16_tail, 5)
    bf16_dev_ms = device_ms(run_bf16, 5, "bp_minsum_kernel")
    bf16_iters = int(kb[3].sum())
    bf16_bound, bf16_by = bp_bound_ms(graph, B1, bf16_iters)
    log(f"[20] bf16 head == plain (head at tile 256, 50 iterations: converged "
        f"{float(kb[1].float().mean()):.4f}, {bf16_iters} shot-iterations; "
        f"tail of {stragb.numel()} stragglers + {1024 - stragb.numel()} "
        f"sentinel rows with early exit: converged "
        f"{float(kbt[1].float().mean()):.4f}); head {bf16_ms:.3f} ms by events, "
        f"{bf16_dev_ms:.3f} ms profiler device time, plain {bf16_plain_ms:.3f} "
        f"ms (one call), bound {bf16_bound:.4f} ms ({bf16_by}; kernel 1's "
        f"operation count); tail {bf16_tail_ms:.3f} ms; layout: head "
        f"{layout_text(bk, dev, B1, m, n, True)}; tail "
        f"{layout_text(bk, dev, 1024, m, n, True)}")

    # the main path's two shapes (phase 5 launches the bf16 head 32 + 32
    # times, phase 26 kernel 1): a 3-iteration head over 4096 shots at
    # p=0.01 and its compacted tail, the stragglers and zero rows to 256,
    # 50 iterations with early exit; then phase 3/20's shapes and these on
    # the larger codes; every output bit-exact with its plain version
    def minsum_shapes(h, head_graph, tanner):
        mh, nh = h.shape
        out = {}
        for tag, p, rows, iters in (("", p1, 1024, it1), ("main ", 0.01, 256, 3)):
            rng_s = np.random.default_rng(SEED)
            e = (rng_s.random((B1, nh)) < 2 * p / 3).astype(np.uint8)
            s = torch.from_numpy((e @ h.T % 2).astype(np.uint8)).to(dev)
            l = tbp.llr_from_probs(np.full(nh, 2 * p / 3), dev)
            first = bk.bp_head_bf16(head_graph, s, l, head_iters=3, **kw6)
            st = torch.nonzero(~first[1]).flatten()[:rows - rows // 4]
            tl = torch.cat([s[st], s.new_zeros((rows - st.numel(), mh))])
            for shape, rows_s, its in ((f"{tag}head", s, iters),
                                       (f"{tag}tail", tl, it1)):
                out[f"bf16 {shape}"] = (lambda r=rows_s, l=l, i=its: bk.bp_head_bf16(
                    head_graph, r, l, head_iters=i, early_stop=True, **kw6))
                out[f"kernel 1 {shape}"] = (lambda r=rows_s, l=l, i=its: bp_minsum(
                    tanner, r, l, max_iter=i, ms_scaling_factor=scale))
        return out

    main_ms = {}
    for name in ("hgp_34_n625", "hgp_34_n1225", "hgp_34_n1600"):
        h = hx if name == "hgp_34_n625" else load_code(
            str(ROOT / "codes_lib_tpu" / f"{name}.npz")).hx
        runs20 = minsum_shapes(h, bk.build_sparse_head(
            tbp.build_tanner_graph_host(h), dev), tbp.build_tanner_graph(h, dev))
        for shape, fn in runs20.items():
            if name == "hgp_34_n625" and shape in ("bf16 head", "bf16 tail",
                                                   "kernel 1 head"):
                continue  # held and timed above
            kr = fn()
            with _kernels.force_plain():
                pr = fn()
            torch.cuda.synchronize()
            err20 = bits_equal(f"{shape} {name}", kr, pr)
            if shape.startswith("bf16"):
                bf16_err = max(bf16_err, err20)
            else:
                k1_err = max(k1_err, err20)
            if name == "hgp_34_n625" and shape.startswith(("bf16 main",
                                                           "kernel 1 main")):
                main_ms[shape] = device_ms(fn, 10, "bp_minsum_kernel")
        log(f"[20] {name}: kernel 1 and the bf16 head == plain at phase 3/20's "
            f"head and tail and the main path's head and tail")
    log(f"[20] main path at hgp_34_n625 (profiler device time): bf16 head "
        f"{main_ms['bf16 main head']:.4f} ms ({layout_text(bk, dev, B1, m, n, True)}), "
        f"tail {main_ms['bf16 main tail']:.4f} ms "
        f"({layout_text(bk, dev, 256, m, n, True)}); kernel 1 head "
        f"{main_ms['kernel 1 main head']:.4f} ms, tail "
        f"{main_ms['kernel 1 main tail']:.4f} ms")

    # 21-22. main path, int8 and v1: phase 5's run, counts reset just before
    # each, read just after
    shots5 = 16 * 4096
    wer5 = wer_single_shot(run5[0], shots5, code.K)[0]
    sim21 = simulator(BPDecoder, 0.01, 4096, SEED, quantize="int8")
    run21, launches_21 = counted(lambda: wer_phase("21 BP int8 p=0.01",
                                                   sim21, 16))
    wer21 = wer_single_shot(run21[0], shots5, code.K)[0]
    tol21 = bk.int8_parity_tolerance(wer5, shots5)
    log(f"[21] launches {launches_21}; int8 WER {wer21:.6e} vs phase 5 "
        f"{wer5:.6e}: |diff| {abs(wer21 - wer5):.3e} <= tolerance "
        f"{tol21:.3e}; B6 {launches_21['bp_int8']} launches, float32 kernel "
        f"1 {launches_21['bp_minsum']}")
    if abs(wer21 - wer5) > tol21:
        raise AssertionError("int8 WER outside int8_parity_tolerance")
    if tuple(run21) != INT8_RUNS["21"]:
        raise AssertionError(f"int8 (failures, min_w) {run21} != "
                             f"{INT8_RUNS['21']}")
    sim22 = simulator(BPDecoder, 0.01, 4096, SEED, bp_kernel="v1")
    run22, launches_22 = counted(lambda: wer_phase("22 BP v1 p=0.01",
                                                   sim22, 16))
    log(f"[22] launches {launches_22}; v1 (failures, min_w) {run22} vs phase "
        f"5's {run5}; bf16 head {launches_22['bp_minsum_bf16']} launches, "
        f"float32 kernel 1 {launches_22['bp_minsum']}")
    if tuple(run22) != MINSUM_RUNS["22"]:
        raise AssertionError(f"v1 (failures, min_w) {run22} != "
                             f"{MINSUM_RUNS['22']}")
    for name, count in (("bp_int8", launches_21["bp_int8"]),
                        ("bp_minsum_bf16", launches_22["bp_minsum_bf16"])):
        if count <= 0:
            raise AssertionError(f"{name} never launched on its main path")
    if launches_21["bp_minsum_bf16"] or launches_22["bp_int8"]:
        raise AssertionError("a head kernel ran off its route")
    if run22 != run5:
        # both tags run the bf16 head: only a gate that sends one tag's
        # batch or tail to float32 and not the other's can part them
        heads = (sim5.decoder_z.device_state["pallas"],
                 sim22.decoder_z.device_state["pallas"])
        # the head's gate at the batch (tile 256), the tails' at their
        # capacities (tile up to 512)
        gates = [cap for cap, want in ((4096, 256), (256, 512), (1024, 512))
                 if len({h.max_block_b(cap, want=want) > 0 for h in heads}) > 1]
        f5, f22 = run5[0] / shots5, run22[0] / shots5
        sigma22 = ((f5 * (1 - f5) + f22 * (1 - f22)) / shots5) ** 0.5
        log(f"[22] v1 differs from phase 5: the tile gate at capacities "
            f"{gates} admits one tag's head and not the other's; |diff| "
            f"{abs(f22 - f5):.3e} of the shots <= 4 sigma {4 * sigma22:.3e}")
        if not gates or abs(f22 - f5) > 4 * sigma22:
            raise AssertionError("v1 and v2 differ beyond their gates")
    else:
        log("[22] v1 == phase 5 (v2): one kernel, the same gates")

    # 23. anchors
    for tag, kw in (("int8", {"quantize": "int8"}), ("v1", {"bp_kernel": "v1"})):
        sim0 = simulator(BPDecoder, 0.0, 4096, SEED, **kw)
        sim0.WordErrorRate(2 * 4096)
        if sim0.last_failures != 0:
            raise AssertionError(f"{tag}: {sim0.last_failures} failures at p=0")
        sims = [simulator(BPDecoder, 0.01, 4096, SEED + 1, **kw)
                for _ in range(2)]
        sims[0].WordErrorRate(4096)
        with _kernels.force_plain():
            sims[1].WordErrorRate(4096)
        got = [(x.last_failures, x.min_logical_weight) for x in sims]
        if got[0] != got[1]:
            raise AssertionError(f"{tag} kernel path {got[0]} vs plain path "
                                 f"{got[1]}")
        log(f"[23] {tag}: p=0 gives 0 failures in {sim0.last_shots} shots; "
            f"one p=0.01 batch, kernels vs plain on the card: (failures, "
            f"min_w) {got[0]} == {got[1]}")
    sim23 = fused_sim(BPDecoder, 0.01, 4096, True, quantize="int8")
    run23, launches_23 = counted(lambda: sim23.WordErrorRate(4096))
    if launches_23["bp_int8"] <= 0 or launches_23["gf2_sample"] <= 0:
        raise AssertionError("fused v1 with int8 decoders missed a kernel")
    log(f"[23] fused v1 with int8 decoders: {sim23.last_failures} failures "
        f"in {sim23.last_shots} shots; launches {launches_23}")

    # 24. kernel B5 in both modes vs its plain versions, on the main path's
    # code and batch
    def fused_vs_plain(tag, fspec, B, **kw):
        """B5 and its plain version on one batch: count, min weight and
        every shot's flags identical (tolerance 0: integer outputs of a
        decode built with -fmad=false in the plain version's operation
        order); returns the kernel's outputs and the largest absolute
        difference over count, min weight and both sectors' converged
        flags and iterations."""
        k = gk.fused_decode_stats(fspec, key, B, **kw)
        pl = gk.fused_decode_plain(fspec, key, B, **kw)
        torch.cuda.synchronize()
        err = max(abs(int(k[0]) - int(pl[0])), abs(int(k[1]) - int(pl[1])))
        for sector, a, b in (("x", k[2], pl[2]), ("z", k[3], pl[3])):
            for field in ("converged", "iterations"):
                d = int((a[field].long() - b[field].long()).abs().max())
                err = max(err, d)
                if d:
                    raise AssertionError(f"B5 {tag} {sector} {field} differ "
                                         f"from plain by up to {d}")
        if err:
            raise AssertionError(f"B5 {tag} count/min_w {int(k[0])}/{int(k[1])} "
                                 f"vs plain {int(pl[0])}/{int(pl[1])}")
        return k, float(err)

    B24, it24 = 4096, 50
    modes24 = (("bf16", None, None), ("int8 w8", "int8", 8),
               ("int8 w1", "int8", 1))
    b5, b5_err = {}, {}
    for p24 in (0.01, 0.05):
        llr24 = tbp.llr_from_probs(np.full(n, 2 * p24 / 3), dev)
        spec24 = gk.build_fused_decode_spec(code.hx, code.hz, code.lx, code.lz,
                                            [p24 / 3] * 3, llr24, llr24, dev)
        for tag, q, bw in modes24:
            kw24 = dict(eval_type="Total", max_iter_z=it24, max_iter_x=it24,
                        ms_scaling_factor=scale, quantize=q, block_w=bw)
            k, err = fused_vs_plain(f"{tag} p={p24}", spec24, B24, **kw24)
            mode = "bf16" if q is None else "int8"
            b5_err[mode] = max(b5_err.get(mode, 0.0), err)

            def run_b5():
                return gk.fused_decode_stats(spec24, key, B24, **kw24)

            kname = "fused_decode_kernel" if q is None else "fused_decode_int8_kernel"
            ms = device_ms(run_b5, 10, kname)
            if q is None:  # shots leave the loop one by one
                si = [int(a["iterations"].sum()) for a in (k[3], k[2])]
            else:  # a tile's shots iterate while the tile does
                si = [int8_shot_iters(a["iterations"], bw * 32, it24, True)
                      for a in (k[3], k[2])]
            bound, by = fused_bound_ms(spec24, B24, *si, q)
            waves = ""
            if q is None:
                lay = gk.card_fused_layout(spec24, B24)
                waves = (f"; layout {lay.lanes} shots x "
                         f"{lay.threads // lay.lanes} threads per block, "
                         f"{lay.grid} blocks, {lay.resident} resident per SM, "
                         f"{lay.smem_bytes} B shared memory")
            else:
                active = gk.fused_int8_active_clusters(spec24, bw)
                tiles = B24 // (bw * 32)
                waves = (f"; {tiles} tiles, {active} clusters at once: "
                         f"{-(-tiles // active)} wave(s)")
            b5[tag, p24] = entry = dict(ms=ms, bound=bound, by=by)
            plain = ""
            if p24 == 0.01 and bw != 1:  # the kernels line's modes
                entry["plain_ms"] = event_ms(lambda: gk.fused_decode_plain(
                    spec24, key, B24, **kw24), 1)
                plain = f", plain {entry['plain_ms']:.3f} ms"
            log(f"[24] B5 {tag} p={p24} == plain (count {int(k[0])}, min_w "
                f"{int(k[1])}, converged z "
                f"{float(k[3]['converged'].float().mean()):.4f} x "
                f"{float(k[2]['converged'].float().mean()):.4f}, "
                f"shot-iterations z {si[0]} x {si[1]}); kernel {ms:.3f} ms "
                f"(profiler device time){plain}, bound {bound:.4f} ms "
                f"({by}){waves}")

    # 25. main path, fused v2 in both modes; counts reset just before each
    # run, read just after
    shots25 = 16 * 4096
    sim25 = fused_sim(BPDecoder, 0.01, 4096, "v2")
    run25, launches_25 = counted(lambda: wer_phase("25 v2 bf16 p=0.01", sim25, 16))
    sim25q = fused_sim(BPDecoder, 0.01, 4096, "v2", quantize="int8")
    run25q, launches_25q = counted(lambda: wer_phase("25 v2 int8 p=0.01",
                                                     sim25q, 16))
    log(f"[25] launches bf16 {launches_25}; int8 {launches_25q}")
    graph_vs_eager("25 bf16", sim25, 16)
    graph_vs_eager("25 int8", sim25q, 16)
    for name, launches in (("fused_decode", launches_25),
                           ("fused_decode_int8", launches_25q)):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on its main path")
        if any(count for other, count in launches.items() if other != name):
            raise AssertionError(f"v2 launched kernels besides {name}: "
                                 f"{launches}")
    f1, fb = runs["v1 BP p=0.01"][0] / shots25, run25[0] / shots25
    sigma25 = ((f1 * (1 - f1) + fb * (1 - fb)) / shots25) ** 0.5
    wer_b = wer_single_shot(run25[0], shots25, code.K)[0]
    wer_q = wer_single_shot(run25q[0], shots25, code.K)[0]
    tol25 = bk.int8_parity_tolerance(wer_b, shots25)
    log(f"[25] bf16 failures {run25[0]} vs phase 12's v1 {runs['v1 BP p=0.01'][0]}: "
        f"|diff| {abs(fb - f1):.3e} of the shots <= 4 sigma {4 * sigma25:.3e}; "
        f"int8 WER {wer_q:.6e} vs bf16 {wer_b:.6e}: |diff| "
        f"{abs(wer_q - wer_b):.3e} <= tolerance {tol25:.3e}")
    if abs(fb - f1) > 4 * sigma25:
        raise AssertionError("v2 bf16 failures outside 4 binomial sigma of v1")
    if abs(wer_q - wer_b) > tol25:
        raise AssertionError("v2 int8 WER outside int8_parity_tolerance")
    if tuple(run25q) != INT8_RUNS["25"]:
        raise AssertionError(f"v2 int8 (failures, min_w) {run25q} != "
                             f"{INT8_RUNS['25']}")
    if tuple(run25) != BF16_RUNS["25"]:
        raise AssertionError(f"v2 bf16 (failures, min_w) {run25} != "
                             f"{BF16_RUNS['25']}")
    for tag, kw in (("bf16", {}), ("int8", {"quantize": "int8"})):
        sims = [fused_sim(BPDecoder, 0.01, 4096, "v2", **kw) for _ in range(2)]
        sims[0].WordErrorRate(4096)
        with _kernels.force_plain():
            sims[1].WordErrorRate(4096)
        got = [(x.last_failures, x.min_logical_weight) for x in sims]
        if got[0] != got[1]:
            raise AssertionError(f"v2 {tag} kernel path {got[0]} vs plain "
                                 f"path {got[1]}")
        log(f"[25] v2 {tag}, one p=0.01 batch: kernel path == plain path "
            f"(failures, min_w) {got[0]}")

    # 26. main path, float32 min-sum: phase 5's run with kernel 1 in head and
    # tail; counts reset just before, read just after
    sim26 = simulator(BPDecoder, 0.01, 4096, SEED, bp_kernel="xla")
    run26, launches_26 = counted(lambda: wer_phase("26 BP xla p=0.01",
                                                   sim26, 16))
    f5, f26 = run5[0] / shots5, run26[0] / shots5
    sigma26 = ((f5 * (1 - f5) + f26 * (1 - f26)) / shots5) ** 0.5
    log(f"[26] launches {launches_26}; float32 failures {run26[0]} vs bf16 "
        f"(phase 5) {run5[0]}: |diff| {abs(f26 - f5):.3e} of the shots <= 4 "
        f"sigma {4 * sigma26:.3e}")
    if launches_26["bp_minsum"] <= 0 or launches_26["bp_minsum_bf16"]:
        raise AssertionError("bp_kernel='xla' missed kernel 1 or ran the head")
    if abs(f26 - f5) > 4 * sigma26:
        raise AssertionError("float32 and bf16 failures beyond 4 binomial sigma")
    if tuple(run26) != MINSUM_RUNS["26"]:
        raise AssertionError(f"float32 (failures, min_w) {run26} != "
                             f"{MINSUM_RUNS['26']}")

    # 27. the transform, device-memory and check-state modes against their
    # plain versions, at shapes whose one shot does not fit a block's
    # shared memory
    with np.load(ROOT / "codes_lib_tpu" / "hgp_34_n1600.npz") as z16:
        h16 = z16["hx"].astype(np.uint8)
    ext16 = np.hstack([h16, np.eye(h16.shape[0], dtype=np.uint8)])
    me, ne = ext16.shape
    rng27 = np.random.default_rng(SEED + 27)

    def synd_of(h, B, p):
        e = (rng27.random((B, h.shape[1])) < p).astype(np.uint8)
        return torch.from_numpy((e @ h.T % 2).astype(np.uint8)).to(dev)

    def elim_case(h, B, p):
        """The three elimination modes' runs on B shots of ``h``, permuted
        by their kernel-1 posteriors: {name: (run, out words, fcap, mode)},
        the packed rows, the syndromes, the rank, the permutation and each
        column's rows (ops/osd_device.py col_rows)."""
        mh, nh = h.shape
        sy = synd_of(h, B, p)
        g = tbp.build_tanner_graph(h, dev)
        post = bp_minsum(g, sy, tbp.llr_from_probs(np.full(nh, p), dev),
                         max_iter=20)[2]
        pm = torch.sort(post, dim=1, stable=True).indices
        pl = tod.build_osd_plan(h, np.full(nh, p), device=dev)
        rs, s32 = pl.rank, sy.to(torch.int32).t().contiguous()
        wf = min(10, nh - rs)
        pk = tod._permute_and_pack(tod._unpack_rows(pl.packed, nh), pm)
        Wh = pk.shape[0]
        runs = {
            "osd_elim": (lambda: tod.osd_elim(
                pl.packed, pm, s32, n=nh, r_star=rs, fcap=wf),
                mh + 2 * rs + mh + wf, wf, "skip"),
            "osd_elim_full": (lambda: tod.osd_elim(
                pl.packed, pm, s32, n=nh, r_star=rs, fcap=0, full=True),
                mh + 2 * rs + Wh * mh, 0, "full"),
            "osd_elim_percol": (lambda: tod.osd_elim_percol(
                pl.packed, pm, s32, n=nh, r_star=rs),
                mh + 3 * rs + Wh * mh, 0, "percol")}
        return (runs, pk, s32, rs, pm,
                tod.col_rows(tod._unpack_rows(pl.packed, nh)))

    def ints_equal(name, a, b) -> float:
        err = max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))
        if err:  # tolerance 0: integer words
            raise AssertionError(f"{name} differs from its plain version")
        return float(err)

    dmem = {}  # modes past shared memory: name -> their kernels-line numbers
    elim_counts = ("device_launches", "full_device_launches",
                   "transform_launches", "full_transform_launches")

    def elim_launched():
        return ([getattr(tod.osd_elim, a) for a in elim_counts]
                + [tod.osd_elim_percol.device_launches])

    for B27 in ELIM27_SHOTS:
        runs27, pk27, s27, r27, pm27, rows27 = elim_case(ext16, B27, 0.03)
        for name, (run, words, fc, mode) in runs27.items():
            # the layout's pick: the transform mode for the blocked routes,
            # the device-memory mode for the per-column one; the blocked
            # routes' device-memory mode fixed beside it
            picked = "device" if mode == "percol" else "transform"
            lay = tod.card_elim_layout(dev, B27, me, ne, fc, mode)
            if lay.memory != picked:
                raise AssertionError(f"{name}: [H|I] of hgp_34_n1600 took "
                                     f"the {lay.memory} mode, not {picked}")
            with _kernels.force_plain():
                pl27, plain_ms = once_ms(run)
            work = tod.elimination_work(pk27, s27, n=ne, r_star=r27, fcap=fc)
            for mem in (picked, "device") if mode != "percol" else (picked,):
                fixed = "auto" if mem == picked else mem
                before = elim_launched()
                k = run() if fixed == "auto" else in_mode(mem, run)
                grown = [a - b for a, b in zip(elim_launched(), before)]
                slot = (("full_" if mode == "full" else "") + mem
                        + "_launches")
                if mode == "percol":
                    want = [0, 0, 0, 0, 1]
                else:
                    want = [int(a == slot) for a in elim_counts] + [0]
                if grown != want:
                    raise AssertionError(f"{name} in {mem}: launches counted "
                                         f"{grown}, not {want}")
                err = ints_equal(f"{name} ({mem}, {B27} shots)", k, pl27)
                bound_work, t_work = work, None
                if mem == "transform" and B27 == ELIM27_SHOTS[-1]:
                    # the smaller of the two walks' counts bounds the mode
                    t_work = tod.transform_work(rows27, pm27, s27,
                                                r_star=r27, fcap=fc,
                                                full=mode == "full")
                    bound_work = min(work, t_work)
                bound, by = elim_bound_ms(ne, me, B27, words, bound_work)
                lay = tod.card_elim_layout(dev, B27, me, ne, fc, mode, mem,
                                           cw=int(rows27.shape[1]))
                ms = in_mode(mem, lambda: event_ms(run, 10))
                log(f"[27] {name} {mem} == plain on [H|I] of hgp_34_n1600 "
                    f"({me}x{ne}, {tod.elim_smem_bytes(me, ne)} B a shot in "
                    f"shared memory), {B27} shots; {lay.smem_bytes} B shared "
                    f"+ {lay.scratch_bytes} B scratch a shot, {lay.threads} "
                    f"threads, {lay.resident} resident per SM; {ms:.4f} ms, "
                    f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}); "
                    f"word ops: matrix walk {work}"
                    + (f", transform walk {t_work}" if t_work else ""))
                if B27 == ELIM27_SHOTS[-1]:  # the tier phase 30 launches
                    dmem[f"{name}_{mem}"] = {
                        "err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound": bound, "by": by, "source": "osd_elim.cu",
                        "replaces": {"osd_elim": "osd_device.py:547",
                                     "osd_elim_full": "osd_device.py:632",
                                     "osd_elim_percol": "osd_device.py:343"
                                     }[name]}
    # every mode at a shape all run: hgp_34_n1600's H, 256 shots
    B27 = ELIM27_SHOTS[0]
    runs16 = elim_case(h16, B27, 0.05)[0]
    for name, (run, _, _, mode) in runs16.items():
        mems = ("shared", "device") + (() if mode == "percol"
                                       else ("transform",))
        ref = in_mode("shared", run)
        times = {}
        for mem in mems:
            ints_equal(f"{name} {mem} vs shared memory", in_mode(mem, run),
                       ref)
            times[mem] = in_mode(mem, lambda: event_ms(run, 10))
        for mem in mems[1:]:
            dmem[f"{name}_{mem}"]["vs_shared"] = (times["shared"], times[mem])
        log(f"[27] {name} on hgp_34_n1600 H, {B27} shots: "
            + ", ".join(f"{mem} {t:.4f} ms" for mem, t in times.items())
            + " (outputs equal)")

    # the min-sum kernels on three copies of [H|I] (2304 x 7104, ~300 KB a
    # shot), in the mode the layout picks (the check-state mode, its 16-bit
    # planes staged) and in the device-memory modes, fixed, and kernel 1 on
    # eleven copies (67,584 edges: 32-bit planes, records beyond a block)
    stack3 = block_diag(ext16, 3)
    g3 = tbp.build_tanner_graph(stack3, dev)
    head3 = bk.build_sparse_head(tbp.build_tanner_graph_host(stack3), dev)
    B27m, it27 = 256, 50
    synd3 = synd_of(stack3, B27m, 0.02)
    llr3 = tbp.llr_from_probs(np.full(stack3.shape[1], 0.02), dev)
    m3, n3 = stack3.shape
    minsum27 = {
        "bp_minsum": (lambda: bp_minsum(g3, synd3, llr3, max_iter=it27),
                      False),
        "bp_minsum_bf16": (lambda: bk.bp_head_bf16(
            head3, synd3, llr3, head_iters=it27), True)}
    for name, (run, bf) in minsum27.items():
        counter = bp_minsum if name == "bp_minsum" else bk.bp_head_bf16
        for mem in ("checks", "device", "device_planes"):
            # "checks" is the layout's own pick for the stack; the other
            # modes are fixed
            pick = "auto" if mem == "checks" else mem
            lay = bk.card_minsum_layout(dev, B27m, m3, n3, 8, 4, bf,
                                        memory=pick)
            if lay.memory != mem:
                raise AssertionError(f"{name}: the three-copy stack took "
                                     f"{lay.memory}, not {mem}")
            before = getattr(counter, f"{mem}_launches")
            k = run() if pick == "auto" else in_mode(mem, run)
            if getattr(counter, f"{mem}_launches") != before + 1:
                raise AssertionError(f"{name}: no {mem} launch counted")
            with _kernels.force_plain():
                pl27, plain_ms = once_ms(run)
            err = bits_equal(f"{name} ({mem})", k, pl27)
            bound, by = bp_bound_ms(g3, B27m, int(k[3].sum()))
            key = f"{name}_{mem}"
            dmem[key] = {"err": err,
                         "ms": in_mode(mem, lambda: event_ms(run, 5)),
                         "plain_ms": plain_ms, "bound": bound, "by": by,
                         "source": "bp_minsum.cu",
                         "replaces": "bp_pallas.py:740"}
            log(f"[27] {name} {mem} == plain on three copies of [H|I] "
                f"({m3}x{n3}, {bk.minsum_smem_bytes(1, m3, n3, 8, 4, bf)} B a "
                f"shot), {B27m} shots, {it27} iterations; {lay.lanes} shots x "
                f"{lay.threads // lay.lanes} threads, {lay.grid} blocks, "
                f"{lay.smem_bytes} B shared, {lay.lane_bytes} B scratch a "
                f"lane, planes {lay.planes}; {dmem[key]['ms']:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    stack11 = block_diag(ext16, 11)
    g11 = tbp.build_tanner_graph(stack11, dev)
    synd11 = synd_of(stack11, 64, 0.02)
    llr11 = tbp.llr_from_probs(np.full(stack11.shape[1], 0.02), dev)
    before = bp_minsum.device_planes_launches
    k = bp_minsum(g11, synd11, llr11, max_iter=20)
    with _kernels.force_plain():
        pl27 = bp_minsum(g11, synd11, llr11, max_iter=20)
    torch.cuda.synchronize()
    bits_equal("bp_minsum on 67,584 edges", k, pl27)
    if bp_minsum.device_planes_launches != before + 1 or bk.planes16(
            *stack11.shape, 8):
        raise AssertionError("eleven copies of [H|I] missed the 32-bit planes")
    log(f"[27] bp_minsum device_planes == plain on eleven copies of [H|I] "
        f"({stack11.shape[0]}x{stack11.shape[1]}, "
        f"{int(g11.chk_mask.sum())} edges: 32-bit planes; "
        f"{bk.minsum_checks_bytes(1, *stack11.shape, 8, 4, 'global32')} B "
        f"of check records a shot, beyond a block), 64 shots")
    # every min-sum mode at a shape all run: hgp_34_n1600's H, 4096 shots
    g16 = tbp.build_tanner_graph(h16, dev)
    head16 = bk.build_sparse_head(tbp.build_tanner_graph_host(h16), dev)
    synd16 = synd_of(h16, 4096, 0.05)
    llr16 = tbp.llr_from_probs(np.full(h16.shape[1], 0.05), dev)
    for name, run in (
            ("bp_minsum", lambda: bp_minsum(g16, synd16, llr16, max_iter=50)),
            ("bp_minsum_bf16", lambda: bk.bp_head_bf16(
                head16, synd16, llr16, head_iters=50))):
        ref = in_mode("shared", run)
        times = {}
        for mem in _kernels.MEMORY_MODES:
            bits_equal(f"{name} {mem} vs shared", in_mode(mem, run), ref)
            times[mem] = in_mode(mem, lambda: event_ms(run, 5))
        for mem in ("checks", "device", "device_planes"):
            dmem[f"{name}_{mem}"]["vs_shared"] = (times["shared"], times[mem])
        log(f"[27] {name} on hgp_34_n1600 H, 4096 shots, 50 iterations: "
            + ", ".join(f"{mem} {t:.3f} ms" for mem, t in times.items())
            + " (outputs equal)")

    # 28-30. the phenomenological engine's main paths: counts reset just
    # before each run, read just after
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BP_Decoder_Class,
        BPOSD_Decoder_Class,
        FirstMinBP_Decoder_Class,
    )
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_Phenon

    def ext(h):
        return np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])

    def phenom_sim(pcode, cls1, cls2, eval_p, batch, seed, **kw):
        """CodeSimulator_Phenon as the JAX package's sweeps build a
        phenomenological cell (sweep/family.py _phenl_sim): p = 3/2 eval_p,
        q = eval_p, decoder 1 on [H|I], decoder 2 on H."""
        p_data, q = eval_p, eval_p
        d1 = [cls1.GetDecoder({"h": ext(h), "p_data": p_data, "p_syndrome": q})
              for h in (pcode.hz, pcode.hx)]
        d2 = [cls2.GetDecoder({"h": h, "p_data": p_data})
              for h in (pcode.hz, pcode.hx)]
        return CodeSimulator_Phenon(
            code=pcode, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
            decoder2_z=d2[1], pauli_error_probs=[eval_p / 2] * 3, q=q,
            seed=seed, batch_size=batch, scan_chunk=8, device=dev, **kw)

    def phenom_phase(tag, sim, rounds, n_batches, unit="rounds"):
        (wer, eb), dt, dt_replay, text = graph_run(
            tag, sim, lambda s: s.WordErrorRate(rounds,
                                                n_batches * s.batch_size))
        run = (sim.last_failures, sim.min_logical_weight)
        log(f"[{tag}] failures {sim.last_failures} shots {sim.last_shots} "
            f"{unit} {rounds} WER/cycle {wer:.6e} +- {eb:.3e} min_w "
            f"{sim.min_logical_weight} {sim.last_shots / dt_replay:.1f} "
            f"shots/s replayed ({dt_replay:.3f} s; "
            f"{sim.last_shots / dt:.1f} with the capture, {dt:.2f} s); "
            f"{text}")
        return run

    def pinned(tag, run, runs=PHENOM_RUNS):
        if tuple(run) != runs[tag]:
            raise AssertionError(f"phase {tag} (failures, min_w) {run} != "
                                 f"{runs[tag]}")

    bp30 = BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)
    osd_e10 = BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                                  device=dev)
    sim28 = phenom_sim(code, bp30, osd_e10, PHENOM_P, 2048, SEED)
    run28, launches_28 = counted(lambda: phenom_phase(
        f"28 phenom BP/BPOSD-E n625 eval_p={PHENOM_P}", sim28, 9, 8))
    log(f"[28] launches {launches_28}")
    graph_vs_eager("28", sim28, 8, rounds=9)
    if run28[0] < 50:
        raise AssertionError(f"phase 28 counted {run28[0]} failures (< 50)")
    for name in ("bp_minsum_bf16", "osd_elim"):
        if launches_28[name] <= 0:
            raise AssertionError(f"{name} never launched in phase 28")
    pinned("28", run28)

    sim29 = phenom_sim(code, FirstMinBP_Decoder_Class(
        5, "minimum_sum", 0.9, device=dev), osd_e10, PHENOM29_P, 2048, SEED)
    run29, launches_29 = counted(lambda: phenom_phase(
        f"29 phenom FirstMin/BPOSD-E n625 eval_p={PHENOM29_P}", sim29, 11,
        1))
    log(f"[29] launches {launches_29}")
    graph_vs_eager("29", sim29, 1, rounds=11)
    if launches_29["osd_elim"] <= 0:
        raise AssertionError("osd_elim never launched in phase 29")
    pinned("29", run29)

    with np.load(ROOT / "codes_lib_tpu" / "hgp_34_n1600.npz") as z16:
        code16 = SimpleNamespace(N=int(z16["hx"].shape[1]),
                                 K=int(z16["lx"].shape[0]),
                                 **{k: z16[k].astype(np.uint8)
                                    for k in ("hx", "hz", "lx", "lz")})
    osd0 = [BPOSD_Decoder_Class(ratio, "minimum_sum", 0.625, "osd_0", 0,
                                device=dev) for ratio in (30, 10)]
    sim30 = phenom_sim(code16, osd0[0], osd0[1], 0.02, 2048, SEED)
    run30, launches_30 = counted(lambda: phenom_phase(
        "30 phenom BPOSD-0/BPOSD-0 n1600 eval_p=0.02", sim30, 9, 2))
    log(f"[30] launches {launches_30}; the elimination's transform mode "
        f"{launches_30['osd_elim_transform']} of {launches_30['osd_elim']} "
        f"launches, its device-memory mode "
        f"{launches_30['osd_elim_device']}")
    if launches_30["osd_elim_transform"] <= 0:
        raise AssertionError("phase 30 never took the elimination's "
                             "transform mode")
    if launches_30["osd_elim_device"] or launches_30["osd_elim_full_device"]:
        raise AssertionError("phase 30 took the elimination's device-memory "
                             "mode")
    # its min-sum decodes ([H|I] and H of hgp_34_n1600) fit shared memory:
    # neither the check-state mode nor a device-memory mode
    minsum30 = {k: launches_30[k] for k in dmem if k.startswith("bp_minsum")}
    log(f"[30] min-sum memory modes from the launch counters: {minsum30}")
    if sum(minsum30.values()):
        raise AssertionError(f"phase 30's min-sum decodes left shared "
                             f"memory: {minsum30}")
    pinned("30", run30)
    graph_vs_eager("30", sim30, 2, rounds=9)

    # 31. anchors
    sim31 = phenom_sim(code, bp30, osd_e10, 0.0, 2048, SEED)
    sim31.WordErrorRate(9, 2 * 2048)
    if sim31.last_failures != 0:
        raise AssertionError(f"{sim31.last_failures} failures at p = q = 0")
    key31 = (7, SEED)
    got31 = []
    for plain in (False, True):
        s = phenom_sim(code, bp30, osd_e10, PHENOM_P, 2048, SEED)
        if plain:
            with _kernels.force_plain():
                s.WordErrorRate(9, 2048, key=key31)
        else:
            s.WordErrorRate(9, 2048, key=key31)
        got31.append((s.last_failures, s.min_logical_weight))
    s = phenom_sim(code, bp30, osd_e10, PHENOM_P, 2048, SEED, packed=False)
    s.WordErrorRate(9, 2048, key=key31)
    got31.append((s.last_failures, s.min_logical_weight))
    if got31[1] != got31[0] or got31[2] != got31[0]:
        raise AssertionError(f"phase 28 batch: kernels {got31[0]}, plain "
                             f"{got31[1]}, packed=False {got31[2]}")
    log(f"[31] p = q = 0: 0 failures in {sim31.last_shots} shots; one phase "
        f"28 batch: kernel path == plain path == packed=False "
        f"(failures, min_w) {got31[0]}")
    # one phase-30 batch: kernel 1 and the bf16 head on [H|I] of
    # hgp_34_n1600 and the elimination's transform mode at the 2048-shot
    # tier, against the same batch with every kernel replaced by its plain
    # version
    s = phenom_sim(code16, osd0[0], osd0[1], 0.02, 2048, SEED)
    _, l30 = counted(lambda: s.WordErrorRate(PHENOM31_ROUNDS, 2048,
                                             key=key31))
    got30 = [(s.last_failures, s.min_logical_weight)]
    if min(l30["bp_minsum_bf16"], l30["bp_minsum"],
           l30["osd_elim_transform"]) <= 0 or l30["osd_elim_device"]:
        raise AssertionError(f"the phase 30 batch missed a kernel: {l30}")
    s = phenom_sim(code16, osd0[0], osd0[1], 0.02, 2048, SEED)
    t = time.time()
    with _kernels.force_plain():
        s.WordErrorRate(PHENOM31_ROUNDS, 2048, key=key31)
    got30.append((s.last_failures, s.min_logical_weight))
    if got30[1] != got30[0]:
        raise AssertionError(f"phase 30 batch: kernels {got30[0]}, plain "
                             f"{got30[1]}")
    log(f"[31] one phase 30 batch of {PHENOM31_ROUNDS} rounds (launches "
        f"{l30}): kernel path == plain "
        f"path (failures, min_w) {got30[0]} (plain {time.time() - t:.1f} s)")
    # fused v2 on six copies of hgp_34_n625 (n = 3750: one fused shot needs
    # more than a block's shared memory) runs as fused v1, counted
    with np.load(CODE) as z6:
        code6 = SimpleNamespace(**{k: block_diag(z6[k], 6)
                                   for k in ("hx", "hz", "lx", "lz")})
    code6.N, code6.K = code6.hx.shape[1], code6.lx.shape[0]
    probs6 = np.full(code6.N, 0.01 * 2 / 3)
    fused6 = []
    for fused in ("v2", True):
        before = CodeSimulator_DataError.fused_fallbacks
        s = CodeSimulator_DataError(
            code=code6, decoder_x=BPDecoder(code6.hz, probs6, 50, device=dev),
            decoder_z=BPDecoder(code6.hx, probs6, 50, device=dev),
            pauli_error_probs=[0.01 / 3] * 3, seed=SEED, batch_size=4096,
            fused_sampler=fused, device=dev)
        fell = CodeSimulator_DataError.fused_fallbacks - before
        if fell != (fused == "v2") or s._fused_sampler is not True:
            raise AssertionError(f"fused_sampler={fused!r} on six copies of "
                                 f"hgp_34_n625: fallback {fell}")
        _, fl = counted(lambda s=s: s.WordErrorRate(2 * 4096))
        if fl["fused_decode"] or fl["gf2_sample"] <= 0:
            raise AssertionError(f"the fallback ran {fl}")
        fused6.append((s.last_failures, s.min_logical_weight))
    if fused6[0] != fused6[1]:
        raise AssertionError(f"fused v2 fallback {fused6[0]} != v1 {fused6[1]}")
    log(f"[31] fused_sampler='v2' on six copies of hgp_34_n625 (n=3750) ran "
        f"as fused v1 (fused_fallbacks +1; no fused_decode launch): "
        f"(failures, min_w) {fused6[0]} == v1's")

    # 32-35. the phenomenological space-time engine and the circuit-level
    # engine on hgp_34_n625: counts reset just before each run, read just
    # after
    from qldpc_fault_tolerance_tpu_torch.circuits import FrameSampler
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        ST_BP_Decoder_Class,
        kernel_variant,
    )
    from qldpc_fault_tolerance_tpu_torch.sim import (
        CodeSimulator_Circuit,
        CodeSimulator_Phenon_SpaceTime,
    )

    t_new = time.time()
    st_bp30 = ST_BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)

    def st_sim(num_rep, eval_p, batch, seed):
        """CodeSimulator_Phenon_SpaceTime as the JAX package's sweeps build
        a cell (sweep/family_spacetime.py _phenl_wer): p = 3/2 eval_p, q =
        eval_p, decoder 1 the space-time BP window decoder over num_rep
        slices of [H|I], decoder 2 BP + OSD-E 10 on H."""
        d1 = [st_bp30.GetDecoder({"h": h, "p_data": eval_p,
                                  "p_syndrome": eval_p, "num_rep": num_rep})
              for h in (code.hz, code.hx)]
        d2 = [osd_e10.GetDecoder({"h": h, "p_data": eval_p})
              for h in (code.hz, code.hx)]
        return CodeSimulator_Phenon_SpaceTime(
            code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
            decoder2_z=d2[1], pauli_error_probs=[eval_p / 2] * 3, q=eval_p,
            num_rep=num_rep, seed=seed, batch_size=batch, scan_chunk=8,
            device=dev)

    def window_text(dec, B: int) -> str:
        """A window decoder's matrix, BP program and the min-sum layout the
        card takes for it at B shots."""
        h = dec.ST_h
        rw, cw = int(h.sum(1).max()), int(h.sum(0).max())
        variant = kernel_variant(dec.device_static, dec.device_state, B)
        lay = bk.card_minsum_layout(dev, B, *h.shape, rw, cw,
                                    variant != "xla_twin")
        return (f"{h.shape[0]}x{h.shape[1]} (row weight {rw}, column weight "
                f"{cw}), head tag {dec.device_static[4][5]}, kernel_variant "
                f"{variant}; at {B} shots {lay.memory} memory, {lay.lanes} "
                f"shots x {lay.threads // lay.lanes} threads per block, "
                f"{lay.grid} blocks, {lay.smem_bytes} B shared memory")

    def b1_b2_launched(tag, launches):
        if launches["bp_minsum_bf16"] + launches["bp_minsum"] <= 0:
            raise AssertionError(f"no min-sum kernel launched in phase {tag}")
        if launches["osd_elim"] <= 0:
            raise AssertionError(f"osd_elim never launched in phase {tag}")

    # 32. the space-time engine's main path: windows of 3
    sim32 = st_sim(3, ST_P, 2048, SEED)
    log(f"[32] window decoder {window_text(sim32.decoder1_z, 2048)}")
    run32, launches_32 = counted(lambda: phenom_phase(
        f"32 phenom space-time BP-ST/BPOSD-E n625 num_rep 3 eval_p={ST_P}",
        sim32, 13, 8, unit="cycles"))
    log(f"[32] launches {launches_32}")
    graph_vs_eager("32", sim32, 8, rounds=13)
    b1_b2_launched("32", launches_32)
    pinned("32", run32, ST_RUNS)

    # 33. a window beyond shared memory: windows of 8
    sim33 = st_sim(8, ST33_P, 2048, SEED)
    log(f"[33] window decoder {window_text(sim33.decoder1_z, 2048)}")
    run33, launches_33 = counted(lambda: phenom_phase(
        f"33 phenom space-time BP-ST/BPOSD-E n625 num_rep 8 eval_p={ST33_P}",
        sim33, 17, 2, unit="cycles"))
    dmem33 = {k: launches_33[k] for k in dmem}
    log(f"[33] launches {launches_33}; check-state and device-memory modes "
        f"{dmem33}")
    if launches_33["bp_minsum_checks"] <= 0 or (
            launches_33["bp_minsum_device"]
            + launches_33["bp_minsum_device_planes"]):
        raise AssertionError("phase 33's window decode did not take the "
                             "check-state mode alone")
    graph_vs_eager("33", sim33, 2, rounds=17)
    b1_b2_launched("33", launches_33)
    pinned("33", run33, ST_RUNS)
    # kernel 1 in the check-state mode at phase 33's shapes, held against
    # its plain version on window histories drawn from the window decoder's
    # own channel (ST_h e, e ~ its tiled [p_data x n | p_synd x m]), at
    # every launch the ladder can make there: the head and the deepened
    # head over the full batch, the big straggler tier (the deepened
    # head's unconverged shots) and the full-batch decode at max_iter; the
    # kernels line's bp_minsum_checks entry takes the full decode's numbers
    # and the largest error of the four
    dec33 = sim33.decoder1_z
    g33, llr33 = dec33.device_state["graph"], dec33.device_state["llr0"]
    it33, msf33 = dec33.device_static[4][1], dec33.device_static[4][3]
    gen33 = torch.Generator(device=dev).manual_seed(SEED)
    h33 = torch.as_tensor(dec33.ST_h, dtype=torch.float32, device=dev)
    e33 = torch.rand((2048, h33.shape[1]), generator=gen33,
                     device=dev) < torch.sigmoid(-llr33)
    synd33 = torch.remainder(e33.float() @ h33.t(), 2).to(torch.uint8)
    head2_33 = tbp.two_phase_head2_iters(tbp.TWO_PHASE_HEAD_ITERS, it33)
    conv33 = bp_minsum(g33, synd33, llr33, max_iter=head2_33,
                       ms_scaling_factor=msf33)[1]
    cap33 = 2048 // tbp.TWO_PHASE_TAIL_DIV * tbp.TWO_PHASE_BIG_TIER_MULT
    tail33 = synd33[torch.nonzero_static(~conv33, size=cap33,
                                         fill_value=0).flatten()]
    k1_33 = {}
    for name, iters, synd in (
            ("head", tbp.TWO_PHASE_HEAD_ITERS, synd33),
            ("deepened head", head2_33, synd33),
            ("straggler tier", it33, tail33), ("full decode", it33, synd33)):
        def run(synd=synd, iters=iters):
            return bp_minsum(g33, synd, llr33, max_iter=iters,
                             ms_scaling_factor=msf33)
        before = bp_minsum.checks_launches
        k = run()
        if bp_minsum.checks_launches != before + 1:
            raise AssertionError(f"phase 33's {name} launch took no "
                                 f"check-state mode")
        with _kernels.force_plain():
            pl33, plain_ms = once_ms(run)
        err = bits_equal(f"bp_minsum check state, phase 33 {name}", k, pl33)
        B = synd.shape[0]
        bound, by = bp_bound_ms(g33, B, int(k[3].sum()))
        k1_33[name] = {"err": err, "ms": event_ms(run, 5),
                       "plain_ms": plain_ms, "bound": bound, "by": by}
        log(f"[33] bp_minsum check state == plain on a window history "
            f"({h33.shape[0]}x{h33.shape[1]}), {name}: {B} shots, max_iter "
            f"{iters}, {int((~k[1]).sum())} unconverged; "
            f"{k1_33[name]['ms']:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound:.4f} ms ({by})")
    dmem["bp_minsum_checks"].update(
        k1_33["full decode"], err=max(d["err"] for d in k1_33.values()))

    # 34. the circuit engine's main path
    def circuit_sim(p, batch, seed, osd=None):
        """CodeSimulator_Circuit as the JAX package's sweeps build a cell
        (sweep/family.py _circuit_wer, SpaceTimeDecodingDemo's CX-only
        error parameters): decoder 1 BP on [H|I], decoder 2 BP + OSD-E 10
        on H, eval_logical_type "Z", 6 cycles, coloration schedule; a fresh
        code object (an "X" engine swaps it in place)."""
        ccode = load_code(str(CODE))
        d1 = bp30.GetDecoder({"h": ext(ccode.hx), "p_data": p,
                              "p_syndrome": p})
        d2 = (osd or osd_e10).GetDecoder({"h": ccode.hx, "p_data": p})
        sim = CodeSimulator_Circuit(
            code=ccode, decoder1_z=d1, decoder2_z=d2, p=p, num_cycles=6,
            error_params={"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": p,
                          "p_idling_gate": 0},
            eval_logical_type="Z", circuit_type="coloration", seed=seed,
            batch_size=batch, scan_chunk=4, device=dev)
        t = time.time()
        sim._generate_circuit()
        return sim, time.time() - t

    sim34, build34 = circuit_sim(CIRCUIT_P, 2048, SEED)
    fs = sim34._sampler
    log(f"[34] circuit built in {build34:.2f} s: {fs.num_qubits} qubits, "
        f"{fs.num_measurements} measurements, {fs.num_detectors} detectors, "
        f"{fs.num_observables} observables, {fs.num_noise_ops} noise ops "
        f"({sum(len(seg.ops) for seg in fs.compiled.segments)} ops in "
        f"{len(fs.compiled.segments)} segments); decoder 1 "
        f"{sim34.decoder1_z.kernel_variant}")
    run34, launches_34 = counted(lambda: wer_phase(
        f"34 circuit BP/BPOSD-E n625 p={CIRCUIT_P} 6 cycles", sim34, 4))
    log(f"[34] launches {launches_34}")
    graph_vs_eager("34", sim34, 4)
    b1_b2_launched("34", launches_34)
    pinned("34", run34, CIRCUIT_RUNS)

    # 35. anchors
    s = st_sim(3, 0.0, 2048, SEED)
    s.WordErrorRate(13, 2048)
    s0, _ = circuit_sim(0.0, 2048, SEED)
    s0.WordErrorRate(2048)
    if (s.last_failures, s0.last_failures) != (0, 0):
        raise AssertionError(f"at p = q = 0: space-time {s.last_failures}, "
                             f"circuit {s0.last_failures} failures")
    key35 = (7, SEED)
    got35 = {}
    dmem35 = 0
    for tag, sim, run in (("32", sim32, lambda s: s.WordErrorRate(
            13, 2048, key=key35)), ("33", sim33, lambda s: s.WordErrorRate(
                17, 2048, key=key35)), ("34", sim34, lambda s: s.WordErrorRate(
                    2048, key=key35))):
        for ctx in (_kernels.force_eager, _kernels.force_plain):
            sim.min_logical_weight = sim.N
            before = bp_minsum.checks_launches
            t = time.time()
            with ctx():
                run(sim)
            got35[tag, ctx.__name__] = (sim.last_failures,
                                        sim.min_logical_weight,
                                        round(time.time() - t, 1))
            if tag == "33" and ctx is _kernels.force_eager:
                dmem35 = bp_minsum.checks_launches - before
        kern, plain = got35[tag, "force_eager"], got35[tag, "force_plain"]
        if kern[:2] != plain[:2]:
            raise AssertionError(f"one phase {tag} batch: kernels {kern}, "
                                 f"plain {plain}")
    if dmem35 <= 0:
        raise AssertionError("phase 33's batch with the kernels took no "
                             "check-state mode")
    # the card's sampler and the CPU's, fed the same uniforms
    planes = {}
    gen35 = torch.Generator().manual_seed(SEED)

    def cpu_uniform(si, it, nid, shape):
        planes[si, it, nid] = torch.rand(shape, generator=gen35)
        return planes[si, it, nid]

    want35 = FrameSampler(sim34.circuit, device="cpu").sample_with(
        cpu_uniform, 256)
    got_s = sim34._sampler.sample_with(
        lambda si, it, nid, shape: planes[si, it, nid].to(dev), 256)
    for a, b in zip(got_s, want35):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("the card's FrameSampler differs from the "
                                 "CPU's on the same uniforms")
    log(f"[35] p = q = 0: 0 failures (space-time, circuit); one batch with "
        f"the kernels (eager) and with every kernel plain, (failures, min_w,"
        f" s): 32 {got35['32', 'force_eager']} == "
        f"{got35['32', 'force_plain']}, 33 {got35['33', 'force_eager']} == "
        f"{got35['33', 'force_plain']} (kernel 1 in the check-state mode, "
        f"{dmem35} launches), 34 {got35['34', 'force_eager']} == "
        f"{got35['34', 'force_plain']}; the card's FrameSampler == the CPU's "
        f"on {len(planes)} uniform planes, 256 shots: detectors "
        f"{tuple(want35[0].shape)}, {int(want35[0].sum())} set")
    log(f"phases 32-35 took {time.time() - t_new:.1f} s")

    # 36. the circuit-level space-time engine, the JAX package's flagship
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        ST_BP_Decoder_Circuit_Class,
        ST_BPOSD_Decoder_Circuit_Class,
    )
    from qldpc_fault_tolerance_tpu_torch.sim import (
        CircuitStreamDriver,
        PhenomStreamDriver,
        st_round_counts,
    )

    t_new = time.time()
    code36 = load_code(str(CODE))  # a fresh object: "X" swaps in place
    sim36 = circuit_st_sim(code36, CIRCUIT_P, dev, seed=SEED,
                           batch_size=2048, scan_chunk=4)
    sim36._generate_circuit()
    g36, space36, dem_s = dem_job.result()
    sim36.circuit_graph, sim36.h1_space_cor = g36, space36
    log(f"[36] waited {time.time() - t_new:.1f} s for the detector error "
        f"model, built in {dem_s:.1f} s in a second process beside the "
        f"earlier phases")
    shapes36 = {}
    for name in ("h1", "h2"):
        h = g36[name]
        ps = np.asarray(g36["channel_ps" + name[1]])
        shapes36[name] = (*h.shape, int(h.sum(1).max()), int(h.sum(0).max()))
        log(f"[36] {name}: {h.shape[0]} x {h.shape[1]}, row weight max "
            f"{shapes36[name][2]} (mean {h.sum(1).mean():.1f}), column "
            f"weight max {shapes36[name][3]}, {int(h.sum())} edges, priors "
            f"{ps.min():.3g}..{ps.max():.3g}")
    log(f"[36] h1_space_cor {space36.shape[0]} x {space36.shape[1]}; "
        f"circuit: {sim36.detector_sampler.num_detectors} detectors, "
        f"{sim36.detector_sampler.num_noise_ops} noise ops")
    if shapes36["h1"][2] <= 32 or shapes36["h2"][2] <= 32:
        raise AssertionError("phase 36's window matrices have no row wider "
                             "than 32")
    st1 = ST_BP_Decoder_Circuit_Class(1, "minimum_sum", 0.625, device=dev)
    st2 = ST_BPOSD_Decoder_Circuit_Class(1, "minimum_sum", 0.625, "osd_e", 10,
                                         device=dev)
    for k, cls in (("1", st1), ("2", st2)):
        setattr(sim36, f"decoder{k}_z", cls.GetDecoder(
            {"h": g36["h" + k], "code_h": code36.hx,
             "channel_probs": g36["channel_ps" + k]}))
    for k, dec in (("1", sim36.decoder1_z), ("2", sim36.decoder2_z)):
        m_k, n_k, rw_k, cw_k = shapes36["h" + k]
        variant = kernel_variant(dec.device_static, dec.device_state, 2048)
        lay = bk.card_minsum_layout(dev, 2048, m_k, n_k, rw_k, cw_k,
                                    variant != "xla_twin")
        log(f"[36] decoder {k}: kernel_variant {variant}, max_iter "
            f"{dec.max_iter}; at 2048 shots {lay.memory} memory, "
            f"{lay.lanes} shots x {lay.threads // lay.lanes} threads per "
            f"block, {lay.grid} blocks, {lay.smem_bytes} B shared memory")
    run36, launches_36 = counted(lambda: wer_phase(
        f"36 circuit space-time BP/BPOSD-E n625 p={CIRCUIT_P} "
        f"{ST36_CYCLES} cycles num_rep {ST36_REP}", sim36, 4))
    log(f"[36] launches {launches_36}")
    modes36 = {k: launches_36[k] for k in (
        "bp_minsum", "bp_minsum_checks", "bp_minsum_device",
        "bp_minsum_device_planes", "bp_minsum_wide", "bp_minsum_bf16",
        "bp_minsum_bf16_checks", "bp_minsum_bf16_device",
        "bp_minsum_bf16_device_planes", "bp_minsum_bf16_wide")}
    log(f"[36] memory modes from the launch counters: {modes36}")
    for k in ("bp_minsum_checks", "bp_minsum_wide", "bp_minsum_bf16_wide",
              "osd_elim"):
        if launches_36[k] <= 0:
            raise AssertionError(f"phase 36 launched no {k}")
    if launches_36["bp_minsum_device"] + launches_36[
            "bp_minsum_device_planes"]:
        raise AssertionError("phase 36's kernel 1 took a device-memory mode")
    if launches_36["bp_minsum_bf16_checks"] + launches_36[
            "bp_minsum_bf16_device"] + launches_36[
            "bp_minsum_bf16_device_planes"]:
        raise AssertionError("phase 36's bf16 head left shared memory")
    graph_vs_eager("36", sim36, 4)
    pinned("36", run36, CIRCUIT_RUNS)
    # the noiseless anchor: the sampler's probabilities zeroed
    noisy36 = sim36.detector_sampler
    sim36.detector_sampler = noisy36.without_noise()
    with _kernels.force_eager():
        sim36.WordErrorRate(2048, key=GRAPH_KEY)
    sim36.detector_sampler = noisy36
    if sim36.last_failures != 0:
        raise AssertionError(f"phase 36 noiseless: {sim36.last_failures} "
                             f"failures")
    # the two decodes' kernels at their main-path shapes, against their
    # plain versions: kernel 1 on window 1's detectors at each launch of
    # decoder 1's ladder (the head; the deepened head where the head leaves
    # more stragglers than the big tier holds; the stragglers' tier at
    # max_iter, padded with zero syndromes as the ladder pads it), the
    # bf16 head on the final syndromes (the head and the deepened head)
    dets36, obs36 = noisy36.sample((36, SEED), 2048)
    m36 = sim36.num_checks
    hist36 = dets36.reshape(2048, ST36_CYCLES, m36)
    windows36 = hist36[:, :sim36.num_rounds * ST36_REP].reshape(
        2048, sim36.num_rounds, ST36_REP * m36)
    with _kernels.force_eager():
        carries36 = [(torch.zeros((2048, m36), dtype=torch.uint8,
                                  device=dev),
                      torch.zeros((2048, sim36.num_logicals),
                                  dtype=torch.uint8, device=dev))]
        for j in range(sim36.num_rounds):
            carries36.append(sim36._window_commit(carries36[-1],
                                                  windows36[:, j])[0])
        scan36 = sim36._final_decode(carries36[-1], hist36[:, -1])
    d1, d2 = sim36.decoder1_z, sim36.decoder2_z
    g1, llr1 = d1.device_state["graph"], d1.device_state["llr0"]
    g2, llr2 = d2.device_state["graph"], d2.device_state["llr0"]
    head2 = d2.device_state["pallas"]
    syn1 = windows36[:, 0].contiguous()
    tiers36 = (2048 // tbp.TWO_PHASE_TAIL_DIV,
               2048 // tbp.TWO_PHASE_TAIL_DIV * tbp.TWO_PHASE_BIG_TIER_MULT)
    deep1 = tbp.two_phase_head2_iters(tbp.TWO_PHASE_HEAD_ITERS, d1.max_iter)
    deep2 = tbp.two_phase_head2_iters(tbp.TWO_PHASE_HEAD_ITERS, d2.max_iter)
    cases1 = [("head", tbp.TWO_PHASE_HEAD_ITERS, syn1)]
    conv1 = bp_minsum(g1, syn1, llr1, max_iter=cases1[0][1])[1]
    tier36 = next((c for c in tiers36 if int((~conv1).sum()) <= c), None)
    if tier36 is None:
        cases1.append(("deepened head", deep1, syn1))
        conv1 = bp_minsum(g1, syn1, llr1, max_iter=deep1)[1]
        tier36 = tiers36[-1] if int((~conv1).sum()) <= tiers36[-1] else 2048
    n_bad36 = int((~conv1).sum())
    syn1_ext = torch.cat([syn1, syn1.new_zeros((1, syn1.shape[1]))])
    cases1.append((f"stragglers ({n_bad36} in a tier of {tier36})",
                   d1.max_iter, syn1_ext[torch.nonzero_static(
                       ~conv1, size=tier36, fill_value=2048).flatten()]))
    wide36 = {}
    plain36 = {}  # kernel 1's plain outputs and times, by case
    for kname, graph_k, fn, counter, attr, cases in (
            ("bp_minsum_wide_checks", g1,
             lambda synd, iters: bp_minsum(g1, synd, llr1, max_iter=iters,
                                           ms_scaling_factor=0.625),
             bp_minsum, "checks_launches", cases1),
            # the parent's mode, fixed, on the stragglers' tier alone
            ("bp_minsum_wide_device_planes", g1,
             lambda synd, iters: in_mode("device_planes", lambda: bp_minsum(
                 g1, synd, llr1, max_iter=iters, ms_scaling_factor=0.625)),
             bp_minsum, "device_planes_launches", cases1[-1:]),
            ("bp_minsum_bf16_wide", g2,
             lambda synd, iters: bk.bp_head_bf16(
                 head2, synd, llr2, head_iters=iters,
                 ms_scaling_factor=0.625),
             bk.bp_head_bf16, "launches",
             [("head", tbp.TWO_PHASE_HEAD_ITERS, scan36[1]),
              ("deepened head", deep2, scan36[1])])):
        rows = {}
        for case, iters, synd in cases:
            def run(synd=synd, iters=iters, fn=fn):
                return fn(synd, iters)
            def modes(attr=attr, counter=counter):
                """The launch counts of ``attr``, of the wide instance, and
                of every other memory mode but the shared one."""
                return (getattr(counter, attr), counter.wide_launches,
                        sum(getattr(counter, a) for a in (
                            "checks_launches", "device_launches",
                            "device_planes_launches") if a != attr))
            before = modes()
            k = run()
            after = modes()
            if after[:2] != (before[0] + 1, before[1] + 1) or (
                    after[2] != before[2]):
                raise AssertionError(f"phase 36 {kname} {case}: launch "
                                     f"counts {before} -> {after}")
            if kname == "bp_minsum_wide_device_planes":
                pl, plain_ms = plain36[case]
            else:
                with _kernels.force_plain():
                    pl, plain_ms = once_ms(run)
                if counter is bp_minsum:
                    plain36[case] = (pl, plain_ms)
            err = bits_equal(f"phase 36 {kname} {case}", k, pl)
            bound, by = bp_bound_ms(graph_k, synd.shape[0], int(k[3].sum()))
            rows[case] = {"err": err, "ms": event_ms(run, 3),
                          "plain_ms": plain_ms, "bound": bound, "by": by}
            log(f"[36] {kname} == plain, {case}: {synd.shape[0]} shots, "
                f"max_iter {iters}, {int((~k[1]).sum())} unconverged; "
                f"{rows[case]['ms']:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound:.4f} ms ({by})")
        # the kernels line takes the full batch's last launch of the
        # ladder (the stragglers' tier for the device-memory mode) and the
        # largest error of the cases
        full = [c for c, _, synd in cases
                if synd.shape[0] == 2048 or len(cases) == 1][-1]
        wide36[kname] = dict(rows[full],
                             err=max(r["err"] for r in rows.values()))
    log(f"phase 36 took {time.time() - t_new:.1f} s")

    # 37. the streaming drivers
    t_new = time.time()
    drv = CircuitStreamDriver(sim36, 2048)
    for j in range(sim36.num_rounds):
        drv.step(windows36[:, j])
        for a, b in zip(drv.carry, carries36[j + 1]):
            if not torch.equal(a, b):
                raise AssertionError(f"phase 37: the circuit driver's carry "
                                     f"after window {j + 1} differs from "
                                     f"phase 36's window scan")
    got37 = drv.finalize(hist36[:, -1])
    for name, a, b in zip(("logical correction", "final syndrome",
                           "final correction"), got37, scan36):
        if not torch.equal(a, b):
            raise AssertionError(f"phase 37: the circuit driver's {name} "
                                 f"differs from phase 36's window scan")
    flags37 = sim36._check(obs36, *got37)
    stream37 = {"circuit": drv._step.graph_stats}

    def steps_per_s(step):
        torch.cuda.synchronize()
        t = time.time()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(STREAM_STEPS):
                step(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return STREAM_STEPS / (time.time() - t)

    rate_c = steps_per_s(lambda i: drv.step(
        windows36[:, i % sim36.num_rounds]))
    phen = PhenomStreamDriver(sim32, 2048)
    key37 = (37, SEED)
    want37 = sim32.run_batch(key37, st_round_counts(ST36_CYCLES, 3)[0])
    phen.reset(key37)
    for _ in range(st_round_counts(ST36_CYCLES, 3)[0] - 1):
        phen.step()
    got_p = phen.finalize()
    if not np.array_equal(got_p, want37):
        raise AssertionError("phase 37: the phenom driver's flags differ "
                             "from phase 32's run_batch")
    stream37["phenom"] = phen._step.graph_stats
    rate_p = steps_per_s(lambda i: phen.step())
    for name, st in stream37.items():
        if st is None:
            raise AssertionError(f"phase 37: the {name} driver captured no "
                                 f"step")
    log(f"[37] circuit driver == phase 36's window scan on 2048 shots "
        f"(carry after each of {sim36.num_rounds} windows, final decode; "
        f"{int(flags37.sum())} failures); phenom driver == phase 32's "
        f"run_batch on one key ({int(want37.sum())} failures of 2048); "
        f"{STREAM_STEPS} replayed steps each with no host read: circuit "
        f"{rate_c:.1f} steps/s ({2048 * rate_c:.0f} shot-windows/s), "
        f"phenom {rate_p:.1f} steps/s ({2048 * rate_p:.0f} "
        f"shot-windows/s); captures {stream37}")
    log(f"phase 37 took {time.time() - t_new:.1f} s")

    # 38. the repaired row-weight limits (ROADMAP §C): B6 on phase 36's h2
    # (row weight 40) and B6 and both B5 modes on a hypergraph product whose
    # rows reach 40, each bit-exact with its plain version; the main paths
    # that launch them
    from qldpc_fault_tolerance_tpu_torch.codes import hgp

    t_new = time.time()
    wide38 = {}  # the wide instances' kernels-line numbers

    def int8_vs_plain(tag, head, synd, llr, iters, block_b):
        """B6's wide instance and its plain version on one batch (bit for
        bit); its time, plain time and bound."""
        def run():
            return bk.bp_head_int8(head, synd, llr, head_iters=iters,
                                   block_b=block_b, ms_scaling_factor=scale)

        before = (bk.bp_head_int8.launches, bk.bp_head_int8.wide_launches)
        k = run()
        torch.cuda.synchronize()
        after = (bk.bp_head_int8.launches, bk.bp_head_int8.wide_launches)
        if after != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"B6 {tag}: launch counts {before} -> "
                                 f"{after}")
        with _kernels.force_plain():
            pl, plain_ms = once_ms(run)
        err = bits_equal(f"B6 {tag}", k, pl)
        bound, by = int8_bound_ms(head, synd.shape[0], int8_shot_iters(
            k[3], block_b, iters, False))
        row = {"err": err, "ms": event_ms(run, 3), "plain_ms": plain_ms,
               "bound": bound, "by": by}
        log(f"[38] B6 wide == plain, {tag}: rw {head.rw}, {synd.shape[0]} "
            f"shots, tile {block_b} {bk.int8_layout(block_b, head.rw, head.m, head.n)} "
            f"(shots per block, blocks per cluster), {iters} iterations, "
            f"converged {float(k[1].float().mean()):.4f}; {row['ms']:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")
        return row

    h2_38, ps2_38 = g36["h2"], np.asarray(g36["channel_ps2"])
    head38 = bk.build_sparse_head(tbp.build_tanner_graph_host(h2_38), dev)
    llr38 = tbp.llr_from_probs(ps2_38, dev)
    tile38 = head38.max_block_b(2048, want=tbp.HEAD_BLOCK)
    wide38["h2"] = int8_vs_plain("phase 36's h2, its final syndromes",
                                 head38, scan36[1], llr38, deep2, tile38)
    # the decoder that raised on the card before: BPDecoder(h2, int8)
    dec38 = BPDecoder(h2_38, ps2_38, 50, quantize="int8", device=dev)
    _, l38h2 = counted(lambda: dec38.decode_batch_device(scan36[1]))
    if l38h2["bp_int8_wide"] <= 0:
        raise AssertionError(f"BPDecoder(h2, quantize='int8') launched no "
                             f"wide B6: {l38h2}")
    log(f"[38] BPDecoder(h2, quantize='int8') decodes 2048 shots on the "
        f"card: launches {l38h2}")

    # hgp of the all-ones 3 x 37 and 3 x 5 matrices: hx rows 37 + 3 = 40,
    # hz rows 5 + 3 = 8, n = 194
    code38 = hgp(np.ones((3, 37), np.uint8), np.ones((3, 5), np.uint8),
                 name="hgp_ones37x5")
    rw38 = (int(code38.hx.sum(1).max()), int(code38.hz.sum(1).max()))
    p38, n38 = 0.005, code38.N
    # B6's batch at four times the run's rate, so its shots iterate
    e38 = (rng.random((2048, n38)) < 8 * p38 / 3).astype(np.uint8)
    synd38 = torch.from_numpy((e38 @ code38.hx.T % 2).astype(np.uint8)).to(dev)
    probs38 = np.full(n38, 2 * p38 / 3)
    head38w = bk.build_sparse_head(tbp.build_tanner_graph_host(code38.hx), dev)
    wide38["hx"] = int8_vs_plain(
        f"{code38.name} hx", head38w, synd38,
        tbp.llr_from_probs(probs38, dev), 50, tbp.HEAD_BLOCK)
    llr38w = tbp.llr_from_probs(probs38, dev)
    spec38 = gk.build_fused_decode_spec(code38.hx, code38.hz, code38.lx,
                                        code38.lz, [p38 / 3] * 3, llr38w,
                                        llr38w, dev)
    key38 = gk.fold_in(gk.split_key(gk.prng_key(SEED))[1], 38)
    for tag, q in (("bf16", None), ("int8", "int8")):
        bw38 = gk.fused_decode_block_w(spec38, 4096, quantize=q)
        kw38 = dict(eval_type="Total", max_iter_z=50, max_iter_x=50,
                    ms_scaling_factor=scale, quantize=q, block_w=bw38)
        attr = "wide_launches" if q is None else "int8_wide_launches"
        before = getattr(gk.fused_decode_stats, attr)
        k = gk.fused_decode_stats(spec38, key38, 4096, **kw38)
        pl = gk.fused_decode_plain(spec38, key38, 4096, **kw38)
        torch.cuda.synchronize()
        if getattr(gk.fused_decode_stats, attr) != before + 1:
            raise AssertionError(f"B5 {tag} on {code38.name}: no wide launch")
        if (int(k[0]), int(k[1])) != (int(pl[0]), int(pl[1])) or not all(
                torch.equal(a[f], b[f]) for a, b in ((k[2], pl[2]),
                                                     (k[3], pl[3]))
                for f in ("converged", "iterations")):
            raise AssertionError(f"B5 {tag} on {code38.name} differs from "
                                 f"its plain version")

        def run_b5w(kw38=kw38):
            return gk.fused_decode_stats(spec38, key38, 4096, **kw38)

        ms = device_ms(run_b5w, 5, "fused_decode_kernel" if q is None
                       else "fused_decode_int8_kernel")
        _, plain_ms = once_ms(lambda: gk.fused_decode_plain(
            spec38, key38, 4096, **kw38))
        if q is None:
            si = [int(a["iterations"].sum()) for a in (k[3], k[2])]
        else:
            si = [int8_shot_iters(a["iterations"], bw38 * 32, 50, True)
                  for a in (k[3], k[2])]
        bound, by = fused_bound_ms(spec38, 4096, *si, q)
        wide38["b5 " + tag] = {"err": 0.0, "ms": ms, "plain_ms": plain_ms,
                               "bound": bound, "by": by}
        log(f"[38] B5 {tag} wide == plain on {code38.name} (rows {rw38}): "
            f"4096 shots, block_w {bw38}, count {int(k[0])}, min_w "
            f"{int(k[1])}; kernel {ms:.3f} ms (profiler device time), plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")

    # the main paths on that code: fused v2 in both modes (no fallback to
    # v1) and the int8 two-phase decode (B6's head), each equal seed for
    # seed to the same run on the plain versions
    def sim38(fused, **kw):
        return CodeSimulator_DataError(
            code=code38,
            decoder_x=BPDecoder(code38.hz, probs38, 50, device=dev, **kw),
            decoder_z=BPDecoder(code38.hx, probs38, 50, device=dev, **kw),
            pauli_error_probs=[p38 / 3] * 3, seed=SEED, batch_size=4096,
            scan_chunk=2, fused_sampler=fused, device=dev)

    launches_38 = {}
    for tag, fused, kw, name in (
            ("v2 bf16", "v2", {}, "fused_decode_wide"),
            ("v2 int8", "v2", {"quantize": "int8"}, "fused_decode_int8_wide"),
            ("int8", False, {"quantize": "int8"}, "bp_int8_wide")):
        fallbacks = CodeSimulator_DataError.fused_fallbacks
        s_k = sim38(fused, **kw)
        if CodeSimulator_DataError.fused_fallbacks != fallbacks or (
                fused and s_k._fused_sampler != "v2"):
            raise AssertionError(f"phase 38 {tag}: fused v2 fell back to v1")
        run_k, launches = counted(lambda s_k=s_k, tag=tag: wer_phase(
            f"38 {tag} {code38.name} p={p38}", s_k, 2))
        launches_38[name] = launches[name]
        if launches[name] <= 0:
            raise AssertionError(f"phase 38 {tag} launched no {name}: "
                                 f"{launches}")
        s_p = sim38(fused, **kw)
        with _kernels.force_plain():
            s_p.WordErrorRate(2 * 4096)
        if tuple(run_k) != (s_p.last_failures, s_p.min_logical_weight):
            raise AssertionError(f"phase 38 {tag}: kernels {run_k}, plain "
                                 f"({s_p.last_failures}, "
                                 f"{s_p.min_logical_weight})")
        log(f"[38] {tag} on {code38.name}: (failures, min_w) {run_k} == the "
            f"plain versions' seed for seed; fused fallbacks unchanged "
            f"({fallbacks}); launches {launches}")
    log(f"[38] barrier form: every min-sum instance non-aligned "
        f"(barrier.sync / barrier.red); this run's times: kernel 1 kMem 0 "
        f"{k1_ms:.3f} ms (phase 3), bf16 head kMem 0 {bf16_ms:.3f} ms (phase "
        f"20), kernel 1 kMem 1 {dmem['bp_minsum_device']['ms']:.3f} ms "
        f"(phase 27), bf16 head kMem 1 "
        f"{dmem['bp_minsum_bf16_device']['ms']:.3f} ms (phase 27), kernel 1 "
        f"kMem 3 {dmem['bp_minsum_checks']['ms']:.3f} ms (phase 33), B5 bf16 "
        f"{b5['bf16', 0.01]['ms']:.3f} ms (phase 24); scripts/ab_minsum_body.py "
        f"--parent DIR times them against another checkout")
    log(f"phase 38 took {time.time() - t_new:.1f} s")

    # 39. the sweep layer at full width: a data threshold over hgp_34_n225
    # and n625 (12 cells and the fit), one phenl and one circuit cell (the
    # cells of phases 28 and 34, pinned), a mid-cell resume, and the
    # space-time family's phenl branch (phase 32's cell, pinned)
    import tempfile

    from qldpc_fault_tolerance_tpu_torch.sweep import (
        CodeFamily,
        CodeFamily_SpaceTime,
    )
    from qldpc_fault_tolerance_tpu_torch.utils import diagnostics
    from qldpc_fault_tolerance_tpu_torch.utils.checkpoint import (
        CellProgress,
        SweepCheckpoint,
    )

    t_new = time.time()
    # phases 1-38 keep every simulator's and stream driver's captured
    # graphs (~44 GiB reserved by now); phase 39 builds an engine a cell,
    # so all but phase 5's (the resume below replays it) are released
    import gc

    from qldpc_fault_tolerance_tpu_torch.parallel.shots import (
        CapturedStep,
        MegabatchDriver,
    )

    held39 = (torch.cuda.memory_allocated() / 2 ** 30,
              torch.cuda.memory_reserved() / 2 ** 30)
    keep39 = {id(d) for d in sim5._drivers.values()}
    for obj in gc.get_objects():
        if isinstance(obj, MegabatchDriver) and id(obj) not in keep39:
            obj._graphs.clear()
        elif isinstance(obj, CapturedStep):
            obj._graph = None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[39] the earlier phases' graphs released: allocated / reserved "
        f"{held39[0]:.1f} / {held39[1]:.1f} -> "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} / "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB on the card")

    def ledger_run(fn):
        """``fn(ledger dir)`` under a run ledger in a temporary directory;
        returns its result, the ledger record and the launches."""
        with tempfile.TemporaryDirectory() as tmp:
            out, launches = counted(lambda: fn(tmp))
            (rec,) = diagnostics.load_ledger(tmp)
        return out, rec, launches

    codes39 = [load_code(str(ROOT / "codes_lib_tpu" / f"hgp_34_{t}.npz"))
               for t in ("n225", "n625")]
    fam39 = CodeFamily(codes39, bp30, osd_e10, batch_size=2048, seed=SEED,
                       device=dev)
    t39 = time.time()
    with check_syncs():
        pc39, rec39, launches_39 = ledger_run(lambda tmp: fam39.EvalThreshold(
            "data", "Total", "extrapolation", SWEEP_EST, SWEEP_SHOTS,
            ledger=tmp, fused=False))
    dt39 = time.time() - t39
    torch.cuda.empty_cache()
    log(f"[39] after the threshold's 12 cells: allocated / reserved "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} / "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB")
    fit39 = [f for f in rec39["fits"] if f["fit"] == "threshold"][0]
    cells39 = rec39["cells"]
    if len(cells39) != 12 or not rec39["complete"] or "pc_ci" not in fit39 \
            or not np.isfinite(pc39) or pc39 != fit39["p_c"]:
        raise AssertionError(f"phase 39 threshold: {len(cells39)} cells, "
                             f"p_c {pc39}, fit {fit39}")
    for name in ("bp_minsum_bf16", "osd_elim"):
        if launches_39[name] <= 0:
            raise AssertionError(f"phase 39's sweep launched no {name}")
    log("[39] CodeFamily([hgp_34_n225, hgp_34_n625], BP/BPOSD-E 10)."
        f"EvalThreshold('data', 'Total', est {SWEEP_EST}): {len(cells39)} "
        f"cells of {SWEEP_SHOTS} shots in {dt39:.1f} s ("
        + "; ".join(f"{c['cell']['code']} p={c['cell']['p']:.4f} "
                    f"{c['failures']}/{c['shots']} WER {c['wer']:.4e}"
                    for c in cells39)
        + f"); p_c {pc39:.5f}, bootstrap 95% CI [{fit39['pc_ci'][0]:.5f}, "
        f"{fit39['pc_ci'][1]:.5f}] ({fit39['bootstrap']} replicates), "
        f"d_eff {[round(d, 3) for d in fit39['d_per_code']]}; launches "
        f"{launches_39}")

    fam39n = CodeFamily([load_code(str(CODE))], bp30, osd_e10,
                        batch_size=2048, seed=SEED, device=dev)
    for tag, noise, kw, want in (
            ("phenl", "phenl", dict(eval_p_list=[PHENOM_P],
                                    num_samples=8 * 2048, num_cycles=9),
             PHENOM_RUNS["28"][0]),
            ("circuit Z", "circuit", dict(
                eval_p_list=[CIRCUIT_P], num_samples=4 * 2048, num_cycles=6,
                circuit_error_params={"p_i": 0, "p_state_p": 0, "p_m": 0,
                                      "p_CX": 1, "p_idling_gate": 0}),
             CIRCUIT_RUNS["34"][0])):
        t = time.time()
        wer, rec, launches = ledger_run(lambda tmp, noise=noise, kw=kw: (
            fam39n.EvalWER(noise, "Z" if noise == "circuit" else "Total",
                           if_plot=False, ledger=tmp, **kw)))
        (cell,) = rec["cells"]
        if cell["failures"] != want:
            raise AssertionError(f"phase 39 {tag} cell: {cell['failures']} "
                                 f"failures, its engine's phase pins {want}")
        log(f"[39] CodeFamily.EvalWER {tag} cell on hgp_34_n625: WER "
            f"{float(wer[0, 0]):.6e}, {cell['failures']}/{cell['shots']} == "
            f"the engine's pinned run, {time.time() - t:.1f} s")

    # a mid-cell resume on phase 5's simulator: the run stopped after two
    # of four megabatches (its cursor saved), then resumed from its
    # CellProgress on the same captured graph (no capture again), under
    # check_syncs: the unbroken run's counts, bit for bit
    class _Stop(Exception):
        pass

    class StoppingProgress(CellProgress):
        def save(self, *args, **kwargs):
            super().save(*args, **kwargs)
            if self._saves == 2:
                raise _Stop

    key39, shots39 = (39, SEED), 32 * 4096
    with tempfile.TemporaryDirectory() as tmp:
        ck39 = SweepCheckpoint(os.path.join(tmp, "sweep.jsonl"))
        cell_key = {"code": "hgp_34_n625", "noise": "data", "p": 0.01}
        runs39 = []
        with check_syncs():
            sim5.min_logical_weight = sim5.N
            sim5.WordErrorRate(shots39, key=key39)
            runs39.append((sim5.last_failures, sim5.last_shots,
                           sim5.min_logical_weight, sim5.last_megabatches))
            driver39 = sim5._driver(8)
            graphs39 = {k: id(v) for k, v in driver39._graphs.items()}
            sim5.min_logical_weight = sim5.N
            try:
                sim5.WordErrorRate(shots39, key=key39,
                                   progress=StoppingProgress(ck39, cell_key))
                raise AssertionError("phase 39: the run was not stopped")
            except _Stop:
                pass
            state39 = SweepCheckpoint(ck39.path).get_progress(cell_key)
            sim5.min_logical_weight = sim5.N
            sim5.WordErrorRate(shots39, key=key39, progress=CellProgress(
                SweepCheckpoint(ck39.path), cell_key))
            runs39.append((sim5.last_failures, sim5.last_shots,
                           sim5.min_logical_weight, sim5.last_megabatches))
    if runs39[1][:3] != runs39[0][:3] or runs39[1][3] != 2 or \
            state39["batches_done"] != 16 or graphs39 != {
                k: id(v) for k, v in driver39._graphs.items()}:
        raise AssertionError(f"phase 39 resume: unbroken {runs39[0]}, "
                             f"resumed {runs39[1]} from {state39}")
    log(f"[39] mid-cell resume: stopped after 2 of 4 megabatches "
        f"(cursor: {state39['batches_done']} batches, {state39['failures']} "
        f"failures), resumed on the same captured graph: (failures, shots, "
        f"min_w) {runs39[1][:3]} == the unbroken run's {runs39[0][:3]}")

    fam39st = CodeFamily_SpaceTime([load_code(str(CODE))], st_bp30, osd_e10,
                                   batch_size=2048, seed=SEED, device=dev)
    t = time.time()
    (wer39st, p39st), rec, launches = ledger_run(lambda tmp: fam39st.EvalWER(
        "phenl", "Total", [ST_P], 8 * 2048, num_cycles=ST36_CYCLES,
        num_rep=3, if_plot=False, ledger=tmp))
    (cell,) = rec["cells"]
    if cell["failures"] != ST_RUNS["32"][0] or list(p39st[0]) != [ST_P]:
        raise AssertionError(f"phase 39 space-time phenl cell: "
                             f"{cell['failures']} failures, phase 32 pins "
                             f"{ST_RUNS['32'][0]}")
    log(f"[39] CodeFamily_SpaceTime.EvalWER phenl cell (phase 32's): WER "
        f"{float(wer39st[0][0]):.6e}, {cell['failures']}/{cell['shots']} == "
        f"phase 32's pinned run, {time.time() - t:.1f} s; launches "
        f"{launches}")
    log(f"phase 39 took {time.time() - t_new:.1f} s")

    # 40-41. the fused sweep path and rare-event estimation
    fused_and_rare_phases(SimpleNamespace(
        dev=dev, codes=codes39, dec1=bp30, dec2=osd_e10, batch=2048,
        seed=SEED, est=SWEEP_EST, shots=SWEEP_SHOTS, pc=pc39, rec=rec39,
        wall39=dt39, counted=counted, ledger_run=ledger_run, sim5=sim5,
        shots5=16 * 4096, rare_shots=RARE_SHOTS,
        rare_class=BP_Decoder_Class(12.5, "minimum_sum", 0.625,
                                    device=dev)))

    # 42-44. the shot mesh and a grid across processes
    mesh42 = mesh_phases(SimpleNamespace(
        dev=dev, code=code, codes=codes39, dec1=bp30, dec2=osd_e10,
        fit=fit39, rec=rec39, counted=counted, ledger_run=ledger_run,
        run5=run5, shots5=16 * 4096, cpu42=cpu42_job))
    # phases 1-44 injected no fault
    no_rungs("1-44")

    # 45-46. decode-as-a-service on the card
    launches_45, serve_kit = serve_phases(SimpleNamespace(
        dev=dev, code=code, counted=counted))

    # 47. the fleet on the card, a host killed mid-storm
    fleet_phase(SimpleNamespace(dev=dev), serve_kit)

    # 48. the fault path: the data engine's ladder, the mesh's replan, a
    # device-OSD fault, the host OSD, and phase 34's engine on it
    fault_phases(SimpleNamespace(
        dev=dev, code=code, got42=mesh42["got42"], circuit_sim=circuit_sim,
        run34=run34, osd_host=BPOSD_Decoder_Class(
            10, "minimum_sum", 0.625, "osd_e", 10, device=dev,
            device_osd=False)))

    # 49-51. what a run tells its operator: telemetry on the card, the
    # waterfall, a warm restart from disk (its first process started now,
    # beside phases 49-50)
    started51 = warm_restart_start(SimpleNamespace(dev=dev, code=code))
    try:
        telemetry_phases(SimpleNamespace(
            dev=dev, code=code, sim5=sim5, sim6=sim6, sim16=sim16,
            sim25=sim25, sim28=sim28, codes=codes39, dec1=bp30,
            dec2=osd_e10, batch=2048, rec=rec39))
    except BaseException:
        started51[0].kill()
        started51[0].communicate()
        shutil.rmtree(started51[1], ignore_errors=True)
        raise
    warm_restart_phase(SimpleNamespace(dev=dev, code=code), started51)
    no_rungs("49-51")

    # 52. the reference notebooks on the card through compat.install()
    launches_52 = notebook_phase(SimpleNamespace(dev=dev, counted=counted))

    # 53. kernel 1's sector mode, the fused X/Z decode, the sweep monitor
    sec53 = sector_phase(SimpleNamespace(dev=dev, code=code,
                                         counted=counted))

    # the kernels line
    kernels = [
        {"name": "bp_minsum", "route": "cuda",
         "source": f"{PKG}/csrc/bp_minsum.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740",
         "launches": (launches_26["bp_minsum"] + launches_45["bp_minsum"]
                     + launches_52["bp_minsum"]),
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        # kernel 1's sector mode (JAX bp_decode(sectors=)), phase 53
        {"name": "bp_minsum_sectors", "route": "cuda",
         "source": f"{PKG}/csrc/bp_minsum.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740",
         **sec53, "library_ms": None},
        {"name": "osd_elim", "route": "cuda",
         "source": f"{PKG}/csrc/osd_elim.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/osd_device.py:547",
         "launches": (launches_6["osd_elim"] + launches_45["osd_elim"]
                     + launches_52["osd_elim"]),
         "max_abs_err": float(k2_err),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "gf2_sample", "route": "cuda",
         "source": f"{PKG}/csrc/gf2_sample.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:242",
         "launches": fused_launches["gf2_sample"],
         "max_abs_err": float(b3_err),
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": None},
        {"name": "gf2_residual", "route": "cuda",
         "source": f"{PKG}/csrc/gf2_residual.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:330",
         "launches": fused_launches["gf2_residual"],
         "max_abs_err": float(b4_err),
         "ms": b4_ms, "plain_ms": b4_plain_ms, "bound_ms": b4_bound,
         "bound_by": b4_by, "library_ms": None},
        {"name": "fused_decode", "route": "cuda",
         "source": f"{PKG}/csrc/fused_decode.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:628",
         "launches": launches_25["fused_decode"],
         "max_abs_err": b5_err["bf16"],
         "ms": b5["bf16", 0.01]["ms"], "plain_ms": b5["bf16", 0.01]["plain_ms"],
         "bound_ms": b5["bf16", 0.01]["bound"],
         "bound_by": b5["bf16", 0.01]["by"], "library_ms": None},
        {"name": "fused_decode_int8", "route": "cuda",
         "source": f"{PKG}/csrc/fused_decode_int8.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/gf2_pallas.py:628",
         "launches": launches_25q["fused_decode_int8"],
         "max_abs_err": b5_err["int8"],
         "ms": b5["int8 w8", 0.01]["ms"],
         "plain_ms": b5["int8 w8", 0.01]["plain_ms"],
         "bound_ms": b5["int8 w8", 0.01]["bound"],
         "bound_by": b5["int8 w8", 0.01]["by"], "library_ms": None},
        {"name": "osd_elim_full", "route": "cuda",
         "source": f"{PKG}/csrc/osd_elim.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/osd_device.py:632",
         "launches": launches_16["osd_elim_full"],
         "max_abs_err": float(b7_err),
         "ms": b7_ms, "plain_ms": b7_plain_ms, "bound_ms": b7_bound,
         "bound_by": b7_by, "library_ms": None},
        # B8 as the main path runs it: its planes built in the kernel
        {"name": "cs_sweep", "route": "cuda",
         "source": f"{PKG}/csrc/cs_sweep.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/osd_cs_device.py:215",
         "launches": launches_16["cs_sweep_rows"], "max_abs_err": b8_err,
         "ms": b8_ms, "plain_ms": b8_plain_ms, "bound_ms": b8_bound,
         "bound_by": b8_by, "library_ms": b8_library_ms},
        {"name": "osd_elim_percol", "route": "cuda",
         "source": f"{PKG}/csrc/osd_elim.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/osd_device.py:343",
         "launches": launches_17["osd_elim_percol"],
         "max_abs_err": float(b10_err),
         "ms": b10_ms, "plain_ms": b10_plain_ms, "bound_ms": b10_bound,
         "bound_by": b10_by, "library_ms": None},
        {"name": "bp_int8", "route": "cuda",
         "source": f"{PKG}/csrc/bp_int8.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740",
         "launches": launches_21["bp_int8"], "max_abs_err": b6_err,
         "ms": b6_ms, "plain_ms": b6_plain_ms, "bound_ms": b6_bound,
         "bound_by": b6_by, "library_ms": None},
        {"name": "bp_minsum_bf16", "route": "cuda",
         "source": f"{PKG}/csrc/bp_minsum.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740",
         "launches": (launches_5["bp_minsum_bf16"]
                     + launches_45["bp_minsum_bf16"]
                     + launches_52["bp_minsum_bf16"]),
         "max_abs_err": bf16_err,
         "ms": bf16_ms, "plain_ms": bf16_plain_ms, "bound_ms": bf16_bound,
         "bound_by": bf16_by, "library_ms": None},
        # the v1 tag's route: the same kernel over a PallasHeadGraph
        {"name": "bp_minsum_bf16_v1", "route": "cuda",
         "source": f"{PKG}/csrc/bp_minsum.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/bp_pallas.py:335",
         "launches": launches_22["bp_minsum_bf16"], "max_abs_err": bf16_err,
         "ms": bf16_ms, "plain_ms": bf16_plain_ms, "bound_ms": bf16_bound,
         "bound_by": bf16_by, "library_ms": None},
    ]
    # the wide instances at phase 36's shapes, with their launches there
    for key, name in (
            ("bp_minsum_wide_checks", "bp_minsum_checks"),
            ("bp_minsum_wide_device_planes", "bp_minsum_device_planes"),
            ("bp_minsum_bf16_wide", "bp_minsum_bf16_wide")):
        d = wide36[key]
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"{PKG}/csrc/bp_minsum.cu",
            "replaces": "qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740",
            "launches": launches_36[name], "max_abs_err": d["err"],
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound"],
            "bound_by": d["by"], "library_ms": None})
    # the wide instances of B6 and B5 (phase 38): B6 at phase 36's h2, B5 on
    # phase 38's code, with their launches on phase 38's main paths
    for key, d, source, replaces in (
            ("bp_int8_wide", wide38["h2"], "bp_int8.cu", "bp_pallas.py:740"),
            ("fused_decode_wide", wide38["b5 bf16"], "fused_decode.cu",
             "gf2_pallas.py:628"),
            ("fused_decode_int8_wide", wide38["b5 int8"],
             "fused_decode_int8.cu", "gf2_pallas.py:628")):
        kernels.append({
            "name": key, "route": "cuda", "source": f"{PKG}/csrc/{source}",
            "replaces": f"qldpc_fault_tolerance_tpu/ops/{replaces}",
            "launches": launches_38[key], "max_abs_err": d["err"],
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound"],
            "bound_by": d["by"], "library_ms": None})
    # the device-memory and transform modes (phase 27; kernel 1's
    # check-state mode from phase 33), with their launches on the
    # phenomenological main paths (phases 28-30, 33)
    for key, d in dmem.items():
        kernels.append({
            "name": key, "route": "cuda", "source": f"{PKG}/csrc/{d['source']}",
            "replaces": f"qldpc_fault_tolerance_tpu/ops/{d['replaces']}",
            "launches": sum(run[key] for run in (
                launches_28, launches_29, launches_30, launches_33)),
            "max_abs_err": d["err"], "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound"], "bound_by": d["by"], "library_ms": None})
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import traceback

    try:
        rc = main()
    except BaseException:  # noqa: BLE001 - reported, then a non-zero exit
        traceback.print_exc()
        rc = 1
    print(f"chip_smoke: threads alive at the end: {thread_report()}",
          file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    # every child process is reaped by now; leave without the interpreter's
    # finalisation, so that no daemon thread of the serve stack still parked
    # in the CUDA runtime can hold up or abort the exit
    os._exit(rc)
