"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `libgrape_lite_tpu_torch/csrc/*.cu`,
holds each against its plain PyTorch version on the card at the shapes
of the main path (an RMAT-20 graph, the generator and seeds of bench.py:
2^20 vertices, edge factor 16, undirected, seed 7; uniform(0.1, 10)
float32 weights from seed 11; RMAT-18 and a directed RMAT-16 from the
same generator for the bitmap LCCs), then drives the main path through
the port's own entry points:

  1. kernel phases: gather_reduce (float sum, min with weights, max;
     int32 sum, min and max) and strict_tile at RMAT-20, each against its
     plain version -- min/max bit-equal, sum within 1e-5 of each row's
     sum of |terms|, strict_tile rerun bit-identical -- and the row
     AND-popcount (`intersect`) at the RMAT-18 bitmap LCC's shapes,
     indexed and dense forms, integer-equal; with kernel, plain, library
     (strict_tile: the faster of index_add_ and segment_reduce, both
     printed) and bound times, each device pass of a call (torch.profiler)
     and gather_reduce's launch facts (items per block and thread, shared
     memory, registers, carve-out); then the adversarial shapes:
     gather_reduce and strict_tile each on a star (one row of 2^22
     edges), a stack with an edgeless fragment, a degree-1 chain and
     RMAT-20 stacked at fnum 4 with unaligned pad gaps (gather_reduce:
     every kind; each sum rerun bit-identical), and the AND-popcount on
     the oe pairs shuffled, one hub row in 10^5 pairs, rows of 37 and 3
     words and an empty pair list;
  2. PageRank, 10 rounds, `Worker.query`, SpMV mode auto and strict:
     launch counts, finite ranks summing to 1, agreement with a run on
     the plain versions, bitwise-identical rerun, MTEPS;
  3. SSSP from vertex 0: bit-equal to the plain-version run, one
     gather_reduce launch per round, MTEPS;
  4. BFS from vertex 0, WCC, CDLP (10 rounds) and `lcc` (LCCBeta) on
     RMAT-20, `lcc_bitmap` on RMAT-18 and `lcc_directed` on the directed
     RMAT-16, each through `Worker.query`: launch counts, bit-equal to a
     run on the plain versions, rounds, query seconds (best of 3 after a
     warm-up), MTEPS for BFS, WCC (2|E| / s) and CDLP (2|E| x rounds / s);
  5. the app variants on RMAT-20 through `Worker.query`: sssp_msg,
     sssp_delta and sssp_auto, bfs_msg, bfs_opt and bfs_auto from vertex
     0, wcc_opt, wcc_auto, pagerank_auto (10 rounds) and cdlp_opt (10
     rounds), each with step 4's checks (and equal loop counters:
     overflow retries, settled capacity, bucket advances, push / pull
     rounds), the gather-reduce kernel launched and no other kernel, and
     its values against its base app's (bit-equal; pagerank_auto within
     1e-4 relative); bfs_opt must both push and pull.  Then
     `sssp_select`'s probe on RMAT-20 (picks sssp) and on a seeded 512 x
     512 grid (262,144 vertices, the seed-11 weights; picks sssp_delta,
     bit-equal to the dense sssp there): pick, reason, probe and query
     seconds;
  5b. the apps beyond the LDBC six through `Worker.query`: on RMAT-20
     kcore (k 16), core_decomposition, pagerank_local (10 rounds), bc,
     khop (k 2 and 3) and common_neighbors from vertex 0 and kclique
     (k 3), each with step 4's checks against its plain-version run
     (integers bit-equal, bc and pagerank_local within 1e-4 relative)
     and cross-checks with no plain code in them: kcore = core numbers
     >= 16, khop = BFS depths masked, the Brandes identity for bc (and
     finite path counts), the vertex count as pagerank_local's mass, the
     triangle identity for common_neighbors, kclique k 3 = a third of
     LCCBeta's credits; on RMAT-18 triangle_count (two AND-popcount
     launches, counts = LCCBeta's credits); kclique k 4 on the device and
     KCliqueDevice(5) on the undirected RMAT-16 (RMAT-18's oriented
     degree is past hub_cap); the device clique apps at k 4 and 5
     against the host recursion on RMAT-11;
  6. torch.profiler over one query each of PageRank (auto and strict),
     BFS, CDLP, lcc_bitmap, lcc, core_decomposition, sssp_delta and
     bfs_opt: device busy time, idle share, top kernels; for
     core_decomposition, sssp_delta and bfs_opt also the host loop's
     iterations and the query's host synchronisations (CUDA's
     sync-debug mode);
  7. p2p-31 PageRank, SSSP, BFS, WCC, CDLP, lcc, lcc_bitmap and every
     variant name with a golden through `run_app` at fnum 1 and 4
     against the golden files (pagerank_directed and pagerank_auto also
     directed, against p2p-31-PR-directed); then the eleven names beyond
     them: triangle_count against the LCC golden, the others against
     the cross-checks of 5b;
  8. the load options (`[load]`): RMAT-20 written once as a TSV file
     (`src dst w` lines, the seed-11 weights to 4 decimals) and loaded
     through `LoadGraph` on the native parser, each stage's host seconds
     (parse, vertex map, CSR build, placement, serialize, deserialize)
     and the garc file's size; PageRank (10 rounds) and SSSP from 0 on
     the deserialized fragment bit-equal to the fresh load; `--rebalance`
     at fnum 4 of an RMAT-18 TSV with PARTITION_STATS' skew before and
     after and SSSP by oid equal to the fnum 1 load's; p2p-31 with `--string_id` through
     `run_app` (SSSP, WCC, CDLP files identical to the integer load's) and
     every partitioner x idxer at fnum 4 against the SSSP golden;
  9. the spgemm LCC backend (`[spgemm]`) on RMAT-18: the host plan's
     seconds and geometry (items, items per edge, bitmap bytes), the
     credit pass's device time beside K3's, `triangle_count` and
     `lcc_bitmap` under GRAPE_LCC_BACKEND=spgemm bit-equal to the
     intersect backend (K3) with both backends' query seconds, and
     `auto`'s decision with its modeled seconds;
     then the rate profile (`[calib]`, ops/calibration.py): `calibrate`
     in a child process sweeps K1, K2, K3 and the spgemm pass on the card
     and fits the profile (`--out`, `--samples-out`): its rates, accepted
     regressors, condition, residual and drift per surface; `--check` on
     the recorded samples exits 0, a profile with a 20x slower op rate
     exits 2, a schema-broken one exits 2; a second sweep (another seed)
     gated against the fitted profile; the live harvest of a serving
     session (more than 0 samples); `query_wall_s` against the measured
     SSSP and PageRank walls; and the three consumers under
     GRAPE_RATE_PROFILE=<fitted>: spgemm's `auto` on RMAT-18, the
     partition ledger on RMAT-20 at fnum 4, an admission record;
  10. the GNN sampler (`[sampler]`): an AppendOnlyEdgecutFragment over
     RMAT-20's edges in both directions, 65,536 seeds at fanouts 4-5 for
     random, edge_weight and top_k (seeds per second), checked on the
     device (every pick a neighbour of its parent, a weighted pick never
     repeating a CSR slot, -1 for rows without neighbours, a rerun with
     the seed bit-equal) and top_k against a CPU run; then 1% more edges,
     the rebuild's seconds and the same samples again;
  11. graph mutation and the dynamic-graph runtime (`[dyn]`): on RMAT-20
     (built with its edge list) 2,048 seeded additive edges (uniform(0.1,
     10) weights, seed 13) ride the delta overlay under the default
     RepackPolicy; sssp, bfs (from 0), wcc, wcc_opt and khop k 2 over
     base + overlay, each bit-equal to a cold query on the repacked graph
     (RepackPolicy threshold 0) with one K1 launch (the base pull) and
     one `overlay_fold` launch a round, seconds beside the base graph's;
     sssp_auto, bfs_auto and wcc_auto refused over the overlay, then
     after `fold_now` bit-equal to the repacked cold query;
     `query_incremental` for sssp, bfs and wcc seeded from the base
     results, over the overlay and over the repack, bit-equal to cold
     (seeded and cold rounds and seconds); 2,048 removals of existing
     edges forcing a repack, the incremental query falling back cold;
     `overlay_fold` alone (vp rows, 4,096 slots, min with weights; 8
     lanes; BFS's int32 hop; a star of 4,096 slots in one row; x, w and
     the pull result mixing -0.0 and +0.0) against its plain version,
     the former K1 path (gather_reduce over the overlay's CSR, then
     torch.minimum) and `scatter_reduce_` amin (the library call), each
     bit-equal (with -0.0: the K1 path), with kernel, plain, K1 path,
     library and bound times.  On the 512 x 512 grid one
     shortcut edge far from the source, repacked, then `query_incremental`
     for sssp and bfs: fewer rounds than cold, bit-equal.  The
     MutationContext shortcut SSSP (tests/test_mutation_context.py) on
     the card; `run_app` with `--delta_efile` (p2p-31's mutable base and
     delta) at fnum 1 and 4 for sssp, bfs, pagerank, wcc, cdlp, lcc and
     lcc_bitmap against the p2p-31 goldens;
  11b. the serving runtime (`[serve]`): K1 with a lane axis
     (`gather_reduce_lanes`) alone on RMAT-20 at k 1, 2, 3, 8 and 32
     lanes in the kinds min with weights, float sum and int32 min,
     against its plain version (min bit-equal, sum within 1e-5 of each
     row's sum of |terms|) and bit-equal to k single gather_reduce calls,
     with kernel, plain, library (the CSR product with x as [N, k]; for
     min the fastest of segment_reduce over the [E, k] candidates and
     scatter_reduce_ amin over [E, k] and [k, E]), bound and k x single
     times, each case's device passes (printed beside the earlier
     design's recorded time, LANES_BEFORE_MS, which stays out of the
     kernels line) and the lane kernel's ptxas registers and spills;
     `spmv.pull` of 65 lanes (two calls) bit-equal to 65 single
     calls; then
     `Worker.query_batch` of 8 seed-17 sources among vertices with edges
     for sssp (plus one absent id), bfs, khop (k 2), common_neighbors and
     personalized pagerank (10 rounds), every lane's values and rounds
     bit-equal to its sequential `Worker.query` with one lane launch a
     round, and a wcc batch through per-lane states; a `ServeSession` of
     64 sssp queries at max_batch 1 and 8 (bit-equal; qps, p50, p99), the
     async pump at W 1 and 4 byte-identical to the synchronous loop, and
     again with the [dyn] adds ingested every 8 queries; the `serve` CLI
     on p2p-31 at fnum 1 and 4 (16 queries, --inflight 1 and 4 with equal
     --dump_results, a --delta_stream run); a profile of one 8-lane sssp
     batch;
  11c. the serving fleet and its autopilot (`[fleet]`, `[autopilot]`): a
     replica of the RMAT-20 fragment (`replicate_fragment`, its host
     seconds and priced `fragment_bytes`); 64 seed-17 queries, sssp and
     bfs in turns, at max_batch 8 with the [dyn] adds ingested in chunks
     every 16 queries by `run_fleet_script`, on one ServeSession, on a
     FleetRouter of 2 replicas, on 2 with replica 0 drained before query
     32, and through a FleetManager with a tenant an app -- every query
     bit-equal across the four, none dropped, the fence equal to the
     ingests, each replica of the router launching the lane K1 and the
     overlay fold (qps, p50 and p99 a replica and in all, the drain's and
     the catch-up's seconds); eviction at full size: two tenants on the
     fragment and its replica under a budget of 1.5x one tenant's price,
     alternating groups of 8 sssp queries (evictions and re-admissions
     recorded, PLAN_STATS and the worker builds flat, results bit-equal
     to a never-evicted session; each re-admission's `restore_device`
     seconds and each eviction's drop in `memory_allocated()` beside its
     price); the serve CLI's `--replicas 2 --drain_at 8 --tenants by_app`
     (with a --delta_stream) and `--autopilot` paths on p2p-31 at fnum 1
     and 4, each --dump_results equal to the plain run's; then the
     autopilot (`cli.serve_autopilot_stream`): min 1, max 2 replicas, a
     256-entry result cache, 128 sssp queries over 64 sources arriving
     through the feeder at half the max_batch 8 session's measured qps,
     x4 from arrival 64 -- a scale-up recorded, every result (cache hits
     too) bit-equal to one session, none dropped (the scale-up's seconds,
     the replica count over time, hits and misses);
  11d. observability (`[obs]`): PageRank (auto, 10 rounds) and SSSP
     from 0 on RMAT-20 through `Worker.query` with obs/ armed as `run_app
     --trace --metrics` arms it, against the same query disarmed:
     bit-equal values, one `query`, one `peval` and `rounds` `superstep`
     spans whose `active` args are the votes a `--profile` run logs,
     `grape_supersteps_total` = rounds + 1, the same host syncs (CUDA's
     sync-debug mode), the wall of each (median of 5) and the spans'
     summed `device_wait_us` beside the query's device busy time
     (torch.profiler); a 16-query 8-lane sssp session on RMAT-20 with
     the [dyn] adds ingested every 8, armed, byte-identical to disarmed
     and launching the lane K1 and the overlay fold, then a deadline
     storm (queries with 0-ms deadlines) that writes a postmortem
     bundle, rendered and joined to the trace by `postmortem --trace`;
     on p2p-31 `run_app --trace --metrics --profile` (its per-round
     lines), `serve` with --trace, --metrics and --metrics_port 0 (one
     scrape over 127.0.0.1 holding every name the JAX exporter gives
     such a run, one serve_query span a query, dumps equal to the
     disarmed run's) and `serve --replicas 2 --trace` (fleet_pump spans
     on both replicas);
  11e. fault tolerance (`[ft]`): PageRank (auto, 10 rounds) and SSSP from
     0 on RMAT-20 through `Worker.query(checkpoint_every=2, ...)`: results
     bit-equal to the unchecked query, the wall of each (median of 3),
     the bytes a snapshot, `checkpoint_save` (what the loop pays: the
     wait for the previous write and the pinned copies' enqueue) against
     `checkpoint_write` (the writer thread) from the spans, equal host
     syncs with and without checkpoints; `kill@4,mode=raise` then
     `Worker.resume` bit-equal; `corrupt@6,kill@7,mode=raise` then resume
     falling back to round 4, bit-equal; then
     `libgrape_lite_tpu_torch/scripts/fault_drill.py --apps sssp
     --corrupt` on p2p-31 on the card (the killed child exits 17, the
     resumed files byte-identical);
  11f. the guards (`[guard]`): sssp, pagerank and wcc on RMAT-20 under
     `guard="halt"` with no fault (no breach, a probe a round, bit-equal),
     and under `corrupt_carry@4` with `guard="rollback"` and
     `checkpoint_every=2` (detected in round 4, one rollback, the result
     bit-equal to the fault-free one); the guarded and unguarded walls
     (median of 3) and the host syncs the probes add;
  11g. guarded serving (`[guard] serve`): 8 seed-17 sssp sources on
     RMAT-20 as one batch under `guard="halt"` with no fault, bit-equal
     to the unguarded batch and to the 8 sequential queries, one lane K1
     launch a round, the host syncs the unguarded batch's plus one a
     chunk boundary; `corrupt_carry@4` (ft/faults.py) on one lane
     breaching that lane alone, the 7 others bit-equal; the same breach in
     the middle batch of an async pump at W 4, the other two batches
     bit-equal; the guarded and unguarded batch walls (median of 3) and
     the probe's host ms a chunk boundary; `serve --guard halt` on p2p-31
     at fnum 1 and 4 with `--replicas 2 --tenants by_app`, its
     --dump_results equal to the unguarded run's; then
     `scripts/fault_drill.py --postmortem` in a child process (exit 0,
     every breach bundle's rows joined to the trace);
  11h. the 2-D vertex cut (`[vc]`): RMAT-20's edge list as
     ImmutableVertexcutFragments at fnum 4 and 16 (k 2 and 4;
     symmetrised and weighted for sssp_vc, bfs_vc and wcc_vc, raw for
     pagerank_vc and pagerank_vc_rep), each build's host seconds and
     `tile_stats` (pad waste, tile skew); each app through `Worker.query`
     bit-equal by oid to its 1-D twin on RMAT-20 (PageRank within 1e-4
     relative), its K1 launches counted (one a tile pull), its seconds
     and MTEPS beside the twin's; each tile pull's K1 call against its
     plain version on the query's own carry (min bit-equal, sums within
     1e-5 of each row's sum of |terms|) with kernel, plain and bound ms;
     at k 2 an 8-lane sssp_vc session bit-equal to its sequential
     queries (one lane K1 launch a round), a checkpointed sssp_vc
     (`checkpoint_every=2`, `kill@4`) resumed bit-equal, and
     `fragment_bytes` equal to the placed tensors' bytes; a profile of
     one sssp_vc query at k 2 and 4; on p2p-31 `run_app --vc` pagerank and
     GRAPE_PARTITION=2d sssp, bfs and wcc at fnum 1 and 4 against the
     goldens, and a `--delta_efile` run recording its decline;
  11i. grape-lint (`[lint]`, analysis/): `lint --json` in a child process
     (the AST rules over the port's tree: exit 0, the per-rule counts),
     then `lint --artifact --json` in another (A3: the sssp / bfs x
     fused / guarded / batched / incremental matrix through
     `Worker.query`, `query(guard="halt")`, `query_batch` and
     `query_incremental` on the card, warmed once, then every cell at 0
     build events -- no kernel library loaded, no strict plan built, no
     device cache filled; the child's K1 and lane K1 launches
     counted); then, as a measurement, the host syncs of the async
     pump's dispatch stage (`_fill`, launches held) on a warmed window of
     4 over 32 sssp queries on p2p-31 at max_batch 8 (CUDA's sync-debug
     mode), a batch, the results byte-identical to the warm pass;
  11j. exchange and overlap (`[pipeline]`): RMAT-20's edge list as a
     1-D edge cut at fnum 4 under the hash partitioner (a random
     partition); the mirror plan's bytes against the gather's; SSSP,
     BFS, WCC from vertex 0 and CDLP (10 rounds) under GRAPE_EXCHANGE
     gather and mirror, each serial (GRAPE_PIPELINE=0) and pipelined
     (force) after a warm-up, 3 repeats each bit-equal to the serial
     result with the launch counts zeroed before and read after every
     run: K1 once a round serial, twice pipelined (CDLP's mode fold
     launches none), equal host syncs a query (CUDA's sync-debug mode),
     the median wall of each; the boundary / interior split; the split
     K1 CSRs and the mirror pull's remapped columns against their plain
     versions (bit-equal, kernel / plain / library / bound ms); sssp_vc
     at k 2 and 4 the same way on [vc]'s tiles (run there, reported
     here), its two phase CSRs against their plain versions; one
     profiled pipelined SSSP query (the kickoff's device events on a
     second CUDA stream, their overlap with the K1 passes); the truth
     meter (`obs/truth.py`) over one armed pipelined SSSP per exchange
     mode: the modeled hidden µs a round, the measured round, the
     claim_frac; PageRank under GRAPE_PIPELINE=1 and force, declined
     with its reason;
  11k. the multi-process runtime (`[dist]`): (a) a one-rank NCCL group
     in this process (`CommSpec.init_distributed`) over [pipeline]'s
     RMAT-20 fnum-4 fragment: sssp, bfs, wcc (each bit-equal) and
     pagerank (within 1e-4) through the distributed StepContext against
     the same queries single-process, with equal rounds, K1 launches and
     host syncs (CUDA's sync-debug mode), the collectives and all_gather
     bytes a round, the NCCL activity of one profiled query, walls
     (median of 3); K1 on rank 1's [2, vp + 1] slab of that stack (min+w
     bit-equal, sum within 1e-5 of each row's sum of |terms|) reading a
     gathered x, with kernel, plain, library and bound ms; (b) gangs of
     two CLI children on the one card under GRAPE_DIST_BACKEND=gloo
     (`--coordinator --num_processes 2 --process_id`): p2p-31 at fnum 4
     for the four apps, their files equal to the one-process CLI's
     (PageRank within 1e-4) and the goldens, rank 1 writing none; then
     RMAT-20 SSSP and PageRank at fnum 4 (hash partitioner) beside a
     one-process child of each, with their query walls and host syncs a
     round; every child loads the parent's kernel libraries (a build
     fails the phase) and launches K1; NCCL across two cards, run only
     where this run sees two (never under the one card it keeps);
     (c) under a one-rank NCCL group again: SSSP and PageRank
     checkpointed every 2 rounds through ShardedCheckpointManager and a
     kill@4 under the breach vote resumed, each bit-equal (PageRank within
     1e-4) with equal rounds and K1 launches; a save's ms against the
     single-file CheckpointManager's and the bytes a snapshot;
     `guard="halt"` with the vote armed against the unvoted one-process
     guarded query (the vote's host µs a round, equal host syncs, walls);
     the kill@4 lineage resharded onto an RMAT-20 fnum-2 hash cut (built
     beside (b)'s children) bit-equal to a cold fnum-2 query; (d) at once
     as children: `fault_drill.py --kill_rank --apps sssp --device cuda`
     on p2p-31 (exit 0, its `ft_drill` line: byte-identical, a complete
     merged trace, cross-rank flows, a verified incident bundle), RMAT-20
     SSSP at fnum 4 over two gloo ranks (the garc cache of (b)) with
     kill_rank@4:1, and a cold one-process fnum-2 child; then this
     process resumes the two-rank lineage onto fnum 2, its files equal to
     the cold child's, with the restore's ms; (e) the rest of the LDBC six
     across ranks: (e1) under (a)'s group CDLP (10 rounds), lcc and
     PageRank strict on its fragment and lcc_bitmap on RMAT-18 at fnum 4
     (segmented cut), each bit-equal to the one-process query with equal
     rounds and K1 / K2 / K3 launches, the ring shifts and collectives a
     query; (e2) beside (b)'s gangs: cdlp, lcc and lcc_bitmap gangs on
     p2p-31 at fnum 4 (lcc_bitmap's K3 ring crossing ranks, two K3 passes
     a ring step), files equal to one process's and the goldens (cdlp
     and lcc run at RMAT-20 in (e1) only); (e3) K2 on rank 1's [2, Ep]
     slab (within 1e-5 of each row's sum of |terms|, rerun bit-identical)
     and K3 at ring step 1 on rank 1 (integer-equal), with kernel, plain,
     library and bound ms; (f) the dynamic graph and the K1 library apps
     across ranks: (f1) under (a)'s group on its fragment, [dyn]'s 2,048
     seed-13 adds ingested on the one-process and the group's fragment
     (the ranks' digest exchange), SSSP, BFS and WCC over the overlay
     bit-equal to one process with equal rounds, K1 and overlay_fold
     launches, then `query_incremental` seeded from the base results,
     equal to the cold overlay query in fewer rounds; kcore (k 16),
     core_decomposition, pagerank_local (10 rounds), khop (k 2),
     common_neighbors and bc from 0, each bit-equal with equal rounds and
     launches, walls beside one process's; (f2) beside (b)'s children:
     two gloo ranks and a one-process child, each running `run_app` on
     p2p-31 at fnum 4 for the --delta_efile loads of sssp, bfs, wcc and
     pagerank (the goldens: base and delta make p2p-31) and the six apps,
     files byte-equal (PageRank within 1e-4), equal rounds, K1 on every
     rank; (f3) `overlay_fold` on rank 1's [2, capacity] slot planes of
     the (f1) overlay reading the gathered x, bit-equal to its plain
     version, the former K1 path and `scatter_reduce_`, rerun
     bit-identical, with kernel, plain, library and bound ms; (g) the
     edge-cut variants across ranks: (g1) under (a)'s group on its
     fragment, sssp_auto, bfs_auto, wcc_auto, pagerank_auto and cdlp_opt
     (10 rounds each), sssp_msg, bfs_msg, sssp_delta, bfs_opt and wcc_opt
     from 0, each bit-equal to one process with equal rounds, launches
     and host-loop decisions (retries, buckets, push / pull rounds, the
     settled capacity), its host syncs and collectives a round, walls
     beside one process's; (g2) beside (b)'s children: two gloo ranks
     and a one-process child, each running `run_app` on p2p-31 at fnum 4
     once a class, `sssp_select` under GRAPE_SSSP_PROBE_CAP=1 (it picks
     sssp_delta) and the --delta_efile loads of sssp_auto and
     sssp_delta, files byte-equal (PageRank within 1e-4) and on the
     goldens, equal rounds and decisions, K1 on every rank; (g3) K1 on
     rank 1's [2, fnum * vp + 1] push-CSR slab of (a)'s stack reading a
     gathered x, min+w (sssp_auto's) bit-equal and sum (pagerank_auto's)
     within 1e-5 of each row's sum of |terms|, each rerun bit-identical,
     with kernel, plain, library and bound ms; (h) the counting apps
     across ranks: (h1) under (a)'s group triangle_count on (e1)'s
     RMAT-18 fnum-4 cut, kclique k 3 on (a)'s fragment, kclique k 4
     and lcc_directed on RMAT-16 at fnum 4 (directed for lcc_directed)
     and lcc_bitmap under GRAPE_LCC_BACKEND=spgemm on RMAT-14 at fnum 4,
     each bit-equal to one process with equal K3 launches and equal
     global counts; (h2) beside (b)'s children: two gloo ranks and a
     one-process child, each running `run_app` on p2p-31 at fnum 4 for
     triangle_count, lcc_directed, kclique k 3, 4, 5 and 7 (the host
     recursion), lcc_bitmap and triangle_count under spgemm, lcc_opt
     under auto (the three processes share one plan cache) and
     triangle_count under `--guard halt`, files byte-equal, the lcc
     values on the golden, equal counts, K3 on every rank where the
     one-process run launches it; (h3) K3 at ring step 1 on rank 1 of a
     two-rank RMAT-16 directed fnum-4 cut (the slab's NB rows against
     rank 0's visiting OUT block), integer-equal to its plain version,
     with kernel, plain and bound ms;
  12. the rate probe (`python -m libgrape_lite_tpu_torch.scripts.cuda_probe`,
     the JAX package's scripts/pallas_probe.py) through its own entry point
     at e_log 22 (16 MiB planes, L2-resident) and 26 (256 MiB planes, past
     L2), launch counts zeroed before and read after; then each of its four
     kernels (stream, lane_gather_t128, sublane_gather at S = 8, 64, 512,
     8192, cumsum_lanes) against its plain version on the same inputs --
     bit-equal, cumsum within 1e-5 of the prefix sum of |a| -- with plain,
     library (torch.add, torch.gather, torch.cumsum) and bound times beside
     the entry point's kernel times, and the sublane table's placement
     (shared where it fits a block's shared memory, column slices past
     that).  Where a case's bytes fit the 50 MB
     L2 (every case at e_log 22) it has no bound: the HBM rate is no
     floor for bytes served from L2.

Before the build, a `[caps]` line per capability says whether this nvcc
builds the four primitives of the JAX package's lowering probe
(`ops/caps.py`; compiled only); a missing one is named in any build
failure and fails the run after the build.

Prints the card's name and power limit, a `[time]` line with the
seconds from `main`'s start to its result, one `{"kernels": [...]}` line,
and as its last line `{"ok": true, "device": {...}}`.  Exits non-zero,
printing no result, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import warnings
from unittest import mock

import numpy as np
import torch

from libgrape_lite_tpu_torch.ops.calibration import default_profile

HERE = os.path.dirname(os.path.abspath(__file__))
# the bound column's rates: the default rate profile, one H100 SXM's data
# sheet (HBM3; float32 outside the tensor cores)
HBM_BYTES_PER_S = default_profile().hbm_bps
FP32_OPS_PER_S = default_profile().ops_per_s
SCALE, EDGE_FACTOR = 20, 16
BITMAP_SCALE = 18  # lcc_bitmap: two (2^18)^2-bit bitmaps, 8 GiB each
# [load]'s `--rebalance` at fnum 4 reads an RMAT-18 TSV: at RMAT-20 the
# rebalanced load alone took 57.8-87.0 host s of the script's limit
REBALANCE_SCALE = 18
DIRECTED_SCALE = 16  # lcc_directed, the secondary path
PR_ROUNDS = 10
CDLP_ROUNDS = 10
INT32_MAX = 2**31 - 1
# sums: |kernel - plain| <= SUM_TOL * sum|terms| per row, with the plain
# version evaluated in float64 on the same float32 inputs.  (The float32
# plain version adds in atomic order on the card; at RMAT-20's hub rows
# its own rounding reached 1.48e-5 of sum|terms| on an H100.)
SUM_TOL = 1e-5
GRID_SIDE = 512  # sssp_select's high-diameter graph: 262,144 vertices
# the app variants on RMAT-20, and the base app each is held against
VARIANTS = ("sssp_msg", "sssp_delta", "sssp_auto", "bfs_msg", "bfs_opt",
            "bfs_auto", "wcc_opt", "wcc_auto", "pagerank_auto", "cdlp_opt")
BASE_QUERIES = {"sssp": {"source": 0}, "bfs": {"source": 0}, "wcc": {},
                "pagerank": {"delta": 0.85, "max_round": PR_ROUNDS},
                "cdlp": {"max_round": CDLP_ROUNDS}}
# every variant name with a p2p-31 golden, run through run_app
GOLDEN_VARIANTS = (
    "sssp_select", "sssp_auto", "sssp_opt", "sssp_delta", "sssp_msg",
    "bfs_auto", "bfs_opt", "bfs_msg", "wcc_auto", "wcc_opt",
    "pagerank_auto", "pagerank_parallel", "pagerank_opt", "pagerank_push",
    "pagerank_push_opt", "pagerank_directed", "cdlp_opt", "cdlp_opt_ud",
    "cdlp_opt_ud_dense")
APP_COUNTERS = ("retries", "final_capacity", "buckets", "push_rounds",
                "pull_rounds", "levels", "total_cliques", "used_device_kernel")
KCORE_K = 16  # kcore's k on RMAT-20
KHOP_KS = (2, 3)
# kclique k = 4 on the device needs the oriented D within hub_cap (320):
# at edge factor 16 RMAT-16's D is 261, RMAT-18's 416 (the host recursion)
KCLIQUE4_SCALE = 16
KCLIQUE5_SCALE = 16  # KCliqueDevice(5), called directly (D past its cap)
KCLIQUE_CHECK_SCALE = 11  # device k = 4, 5 against the host recursion
CN_SOURCE = 10316  # p2p-31's vertex in the most triangles (17)
# the [dyn] phase: seeded additive edges on RMAT-20 (2,048 undirected adds
# fill 2 x 2,048 = 4,096 overlay slots, the default capacity), the apps
# over the overlay, the auto apps refused, incremental queries, and the
# grid's shortcut (row, column) pair far from the source (0, 0)
DYN_ADDS = 2048
DYN_SEED = 13
DYN_KHOP_K = 2
DYN_APPS = (("sssp", {"source": 0}), ("bfs", {"source": 0}), ("wcc", {}),
            ("wcc_opt", {}), ("khop", {"source": 0}))
DYN_AUTO = (("sssp_auto", {"source": 0}), ("bfs_auto", {"source": 0}),
            ("wcc_auto", {}))
DYN_INC = ("sssp", "bfs", "wcc")
DYN_SHORTCUT_SPAN = 11  # the grid's shortcut: (s - 12, s - 12) to the corner
DYN_GOLDEN = ("sssp", "bfs", "pagerank", "wcc", "cdlp", "lcc", "lcc_bitmap")
# the [serve] phase: K1 with a lane axis at each lane count; batches of
# SERVE_BATCH seed-17 sources among vertices with edges (sssp adds one
# absent id); a session of SERVE_QUERIES sssp queries at max_batch 1 and
# SERVE_BATCH, the async pump at each window, then the [dyn] adds
# ingested every SERVE_INGEST_EVERY queries; the serve CLI on p2p-31
# (one lane is K1's single call; 2 and 3 lanes run lane groups of 2 and
# 4, 8 and 32 groups of 8; a batch of SERVE_WIDE lanes is split by pull)
SERVE_LANES = (1, 2, 3, 8, 32)
# kernel_ms of the lane K1's earlier design (scalar lane gathers staged
# through shared memory), by (lanes, kind), as recorded in PERF.md (the
# lane K1 findings, run BB: this script on an NVIDIA H100 80GB HBM3 at
# 700 W): printed beside each case's time as a recorded figure, never
# put in the kernels line, which holds only this run's measurements
LANES_BEFORE_MS = {
    (1, "min+w"): 0.2511, (1, "sum"): 0.2040, (1, "int32 min"): 0.2083,
    (2, "min+w"): 0.4048, (2, "sum"): 0.3643, (2, "int32 min"): 0.3709,
    (3, "min+w"): 0.5654, (3, "sum"): 0.5343, (3, "int32 min"): 0.5550,
    (8, "min+w"): 1.2461, (8, "sum"): 1.2082, (8, "int32 min"): 1.2576,
    (32, "min+w"): 6.0477, (32, "sum"): 5.9872, (32, "int32 min"): 6.1534,
}
SERVE_WIDE = 65
SERVE_SEED = 17
SERVE_BATCH = 8
SERVE_APPS = (("sssp", {}), ("bfs", {}), ("khop", {}),
              ("common_neighbors", {}),
              ("pagerank", {"max_round": PR_ROUNDS}), ("wcc", {}))
SERVE_GENERIC_LANES = 4  # wcc: identical lanes, run as per-lane states
ABSENT_ID = 1 << 40  # no vertex has this id
SERVE_QUERIES = 64
SERVE_INGEST_EVERY = 8
SERVE_WINDOWS = (1, 4)
SERVE_CLI_QUERIES = 16
SERVE_CLI_ADDS = 64
FLEET_QUERIES = 64  # alternating sssp and bfs from seed-17 sources
FLEET_INGEST_EVERY = 16
FLEET_DRAIN_AT = 32
EVICT_GROUPS = 6  # tenants a, b, a, b, ...: each switch evicts the other
EVICT_GROUP = 8  # sssp queries a group
AUTOPILOT_SOURCES = 128
AUTOPILOT_QUERIES = 2 * AUTOPILOT_SOURCES  # each source twice
AUTOPILOT_CACHE = 256
AUTOPILOT_WARM = 32  # sources asked twice in turn before the step
AUTOPILOT_STEP_AT = 2 * AUTOPILOT_WARM  # arrival index of the rate step
# the step's factor: half the session's qps becomes 4x it, held for the
# 192 misses after the step, so the queue stays over up_queue_depth for
# many reads (64 misses at x4 kept it there for 2-4 reads, against the
# scaler's window of 3)
AUTOPILOT_STEP_X = 8
AUTOPILOT_CLI_CACHE = 64
CALIB_SCALES, CALIB_EFS = "16,18", "4,16"  # the calibrate sweep's graphs
CALIB_SEEDS = (7, 8)  # the fit's sweep, the second sweep's
CALIB_REPEATS = 5
CALIB_OPS_SLOWDOWN = 20.0  # the corrupted profile's op rate, divided
PROBE_E_LOGS = (22, 26)  # rate probe: 16 MiB planes (in L2), 256 MiB (HBM)
# the rate probe's kernels: wrapper, its cases (the headline first), the
# line of the Pallas call it replaces in scripts/pallas_probe.py
PROBE_KERNELS = (
    ("stream", ("vpu_stream",), 70),
    ("lane_gather_t128", ("lane_gather_t128",), 93),
    ("sublane_gather", ("sublane_gather_S8192", "sublane_gather_S512",
                        "sublane_gather_S64", "sublane_gather_S8"), 126),
    ("cumsum_lanes", ("cumsum_lanes",), 152),
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rmat_edges(scale: int, edge_factor: int, seed: int = 7):
    """bench.py's vectorised RMAT (a=0.57, b=0.19, c=0.19, d=0.05), the
    rate sweep's generator."""
    from libgrape_lite_tpu_torch.ops.calibration import rmat_edges as rmat

    return rmat(scale, edge_factor, seed)


def rmat_fragment(scale: int, device, directed: bool = False,
                  retain: bool = False):
    """The weighted RMAT fragment (fnum 1) through the port's builder."""
    n, src, dst = rmat_edges(scale, EDGE_FACTOR)
    return edge_fragment(n, src, dst, device, directed, retain)


def grid_fragment(side: int, device, retain: bool = False):
    """A side x side grid (4-neighbour, undirected; vertex r * side + c),
    weighted as the RMAT graphs are: a high-diameter graph."""
    ids = np.arange(side * side, dtype=np.int64).reshape(side, side)
    src = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    dst = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    return edge_fragment(side * side, src, dst, device, False, retain)


def edge_fragment(n: int, src, dst, device, directed: bool,
                  retain: bool = False):
    """Vertices 0..n-1 and the edges src -> dst with uniform(0.1, 10)
    float32 weights from seed 11, through the port's builder with
    bench.py's vertex map: segmented partitioner, hashmap idxer.
    `retain` keeps the edge list, so the fragment can be mutated (a
    rebuild keeps the segmented partitioner)."""
    from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
    from libgrape_lite_tpu_torch.fragment.loader import LoadGraphSpec
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.utils.id_parser import IdParser
    from libgrape_lite_tpu_torch.vertex_map.idxer import HashMapIdxer
    from libgrape_lite_tpu_torch.vertex_map.partitioner import (
        SegmentedPartitioner,
    )
    from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

    oids = np.arange(n, dtype=np.int64)
    vm = VertexMap(SegmentedPartitioner(1, oids), [HashMapIdxer(oids)],
                   IdParser(1, n))
    w = np.random.default_rng(11).uniform(0.1, 10.0, len(src)).astype(
        np.float32)
    frag = ShardedEdgecutFragment.build(
        CommSpec(fnum=1, device=device), vm, src, dst, w, directed=directed,
        retain_edge_list=retain)
    frag.load_spec = LoadGraphSpec(directed=directed,
                                   partitioner_type="segment")
    return frag, (1 if directed else 2) * len(src)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def device_passes(fn, device, calls: int = 5) -> dict:
    """Device milliseconds per call of each kernel that `fn` launches,
    from torch.profiler over `calls` calls after a warm-up (a wrapper
    whose call runs several passes shows each)."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        return {}  # a CPU rehearsal: no device passes
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)  # see profile_call: the window's edges
        for _ in range(calls):
            fn()
        sync(device)
        time.sleep(PROFILE_PAD_S)
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.removeprefix("void ").replace(
                "(anonymous namespace)::", "")
            name = re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return {k: v / calls for k, v in sorted(out.items())}


def passes_text(passes: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in passes.items())


# ---- phase 1: each kernel against its plain version ---------------------

def check_sum(got, want64, sabs64, what: str) -> float:
    """|got - want| <= SUM_TOL * sum|terms| per row; returns max |err|."""
    err = (got.double() - want64).abs()
    worst = float((err / sabs64.clamp(min=1e-300)).max())
    check(bool((err <= SUM_TOL * sabs64).all()),
          f"{what} off by {worst:.3e} of sum|terms|")
    return float(err.max())


def kernel_phases(frag, device, reps: int) -> dict:
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    ie = frag.dev.ie
    indptr, nbr = ie.indptr, ie.edge_nbr
    fnum, vp = frag.fnum, frag.vp
    n = fnum * vp
    e_real = int(indptr[:, -1].sum())
    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.rand(n, generator=gen).to(device)
    dist = torch.where(torch.rand(n, generator=gen) < 0.3,
                       torch.tensor(float("inf")),
                       torch.rand(n, generator=gen) * 50).to(device)
    w = torch.where(ie.edge_mask, ie.edge_w,
                    torch.tensor(float("inf"), device=device))
    rows_bytes = 4 * fnum * (vp + 1) + 4 * n + 4 * n  # indptr, x, y
    out = {}

    # library yardsticks, built once outside the timed calls
    check(fnum == 1, "the kernel phases run on a single fragment")
    deg = (indptr[0, 1:] - indptr[0, :-1]).to(torch.int64)
    flat_nbr = nbr[0, :e_real]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        csr = torch.sparse_csr_tensor(
            indptr[0].to(torch.int64), flat_nbr.to(torch.int64),
            torch.ones(e_real, device=device), size=(vp, n),
            check_invariants=False)

    def library(kind, xin, win):
        """One PyTorch call computing the same function: a sparse CSR
        product for sum, segment_reduce over the gathered candidates
        (gathered outside the timed call) for min / max."""
        if kind == "sum":
            return lambda: csr @ xin
        cand = xin[flat_nbr] + (win[0, :e_real] if win is not None else 0)
        init = float("inf") if kind == "min" else float("-inf")
        return lambda: torch.segment_reduce(cand, kind, lengths=deg,
                                            unsafe=True, initial=init)

    cases = [("sum", x, None), ("min", dist, w), ("max", x, None)]
    for kind, xin, win in cases:
        got = spmv.gather_reduce(indptr, nbr, win, xin, kind)
        sync(device)
        if kind == "sum":
            max_err = check_sum(
                got,
                spmv.gather_reduce_plain(indptr, nbr, None, xin.double(),
                                         "sum"),
                spmv.gather_reduce_plain(indptr, nbr, None,
                                         xin.double().abs(), "sum"),
                "gather_reduce sum")
        else:
            want = spmv.gather_reduce_plain(indptr, nbr, win, xin, kind)
            check(torch.equal(got, want), f"gather_reduce {kind} not "
                  "bit-equal to its plain version")
            max_err = 0.0
        ms = time_ms(lambda: spmv.gather_reduce(indptr, nbr, win, xin, kind),
                     device, reps)
        plain_ms = time_ms(
            lambda: spmv.gather_reduce_plain(indptr, nbr, win, xin, kind),
            device, max(3, reps // 4), warmup=1)
        lib_ms = time_ms(library(kind, xin, win), device, reps)
        nbytes = 4 * e_real * (2 if win is not None else 1) + rows_bytes
        ops = e_real * (2 if win is not None else 1)
        b_ms, b_by = bound(nbytes, ops)
        cfg = spmv.gather_config(kind, weighted=win is not None)
        passes = device_passes(
            lambda: spmv.gather_reduce(indptr, nbr, win, xin, kind), device)
        out[f"gather_reduce[{kind}]"] = dict(
            max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, edges=e_real, config=cfg,
            passes_ms=passes)
        print(f"[kernel] gather_reduce {kind}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) edges={e_real} "
              f"max_abs_err={max_err:.3e}", flush=True)
        print(f"[kernel]   merge path: items_per_block="
              f"{cfg['items_per_block']} items_per_thread="
              f"{cfg['items_per_thread']} threads={cfg['threads']} "
              f"smem_per_block={cfg['smem_bytes']} B registers="
              f"{cfg['registers']} blocks_per_sm={cfg['blocks_per_sm']} "
              f"carveout={cfg['carveout_pct']}%; device ms a call: "
              f"{passes_text(passes)}", flush=True)

    # strict_tile at the main path's strict plan (PageRank, mode strict)
    plan = spmv.plan_for_app(frag, vp, torch.float32, mode="strict")
    check(plan is not None, "no strict plan for the RMAT fragment")
    row_lo = torch.from_numpy(plan[0]).to(device)
    tile, rmax = plan[1], plan[2]
    values = torch.where(ie.edge_mask, x[nbr], torch.zeros((), device=device))
    got = spmv.spmv_strict(values, ie.edge_src, row_lo, vp, tile, rmax)
    want = spmv.spmv_strict_plain(values.double(), ie.edge_src, row_lo, vp,
                                  tile, rmax)
    sabs = spmv.spmv_strict_plain(values.double().abs(), ie.edge_src, row_lo,
                                  vp, tile, rmax)
    strict_err = check_sum(got, want, sabs, "strict_tile")
    check(torch.equal(got, spmv.spmv_strict(values, ie.edge_src, row_lo, vp,
                                            tile, rmax)),
          "strict_tile rerun not bit-identical")
    ep = values.shape[1]
    src_long = ie.edge_src.reshape(-1).to(torch.int64)
    acc = torch.zeros(fnum * (vp + 1), device=device)
    flat_values = values.reshape(-1)
    # segment_reduce over the sorted edges: one segment a row, pads last
    offsets = torch.cat([src_long.new_zeros(1), torch.bincount(
        src_long, minlength=vp + 1).cumsum(0)])

    libraries = {
        "index_add_": lambda: acc.zero_().index_add_(0, src_long,
                                                     flat_values),
        "segment_reduce": lambda: torch.segment_reduce(
            flat_values, "sum", offsets=offsets, unsafe=True),
    }
    ms = time_ms(lambda: spmv.spmv_strict(values, ie.edge_src, row_lo, vp,
                                          tile, rmax), device, reps)
    plain_ms = time_ms(lambda: spmv.spmv_strict_plain(
        values, ie.edge_src, row_lo, vp, tile, rmax), device,
        max(3, reps // 4), warmup=1)
    lib_all = {k: time_ms(call, device, reps) for k, call in libraries.items()}
    lib_name = min(lib_all, key=lib_all.get)
    lib_ms = lib_all[lib_name]
    nbytes = 8 * fnum * ep + 4 * row_lo.numel() + 4 * n  # values, src, y
    b_ms, b_by = bound(nbytes, fnum * ep)
    passes = device_passes(lambda: spmv.spmv_strict(
        values, ie.edge_src, row_lo, vp, tile, rmax), device)
    out["strict_tile"] = dict(
        max_abs_err=strict_err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, library=lib_name, library_all_ms=lib_all,
        bound_ms=b_ms, bound_by=b_by, edges=fnum * ep,
        tiles=row_lo.shape[1], rmax=rmax,
        worthwhile=spmv.strict_worthwhile(rmax, tile), passes_ms=passes)
    print(f"[kernel] strict_tile: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} ({lib_name}; "
          + " ".join(f"{k}={v:.4f}" for k, v in lib_all.items())
          + f") bound_ms={b_ms:.4f} ({b_by}) tiles={row_lo.shape[1]} "
          f"tile={tile} rmax={rmax} "
          f"worthwhile={spmv.strict_worthwhile(rmax, tile)} "
          f"max_abs_err={strict_err:.3e} rerun bit-identical", flush=True)
    print(f"[kernel]   strict tiles: {len(passes)} device passes a call, "
          f"ms each: {passes_text(passes)}", flush=True)
    return out


def int_gather_phase(frag, device, reps: int) -> dict:
    """int32 gather_reduce at the main path's shapes, each bit-equal to the
    plain version: sum over an alive bitmap (70% ones; kcore's and
    core_decomposition's neighbour counts), min / max over labels with a
    30% INT32_MAX sentinel share (BFS depths, WCC labels).  Library: one
    scatter_reduce_ over pre-gathered candidates (for sum also index_add_,
    the faster of the two counts)."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    ie = frag.dev.ie
    indptr, nbr = ie.indptr, ie.edge_nbr
    vp, n = frag.vp, frag.fnum * frag.vp
    check(frag.fnum == 1, "the kernel phases run on a single fragment")
    e_real = int(indptr[:, -1].sum())
    gen = torch.Generator(device="cpu").manual_seed(5)
    labels = torch.randint(0, n, (n,), generator=gen, dtype=torch.int32)
    labels = torch.where(torch.rand(n, generator=gen) < 0.3,
                         torch.tensor(INT32_MAX, dtype=torch.int32),
                         labels).to(device)
    alive = (torch.rand(n, generator=gen) < 0.7).to(torch.int32).to(device)
    # library yardstick: one scatter_reduce_ over pre-gathered candidates
    deg = (indptr[0, 1:] - indptr[0, :-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(vp, device=device), deg)
    idx = nbr[0, :e_real].to(torch.int64)
    acc = torch.empty(vp, dtype=torch.int32, device=device)
    out = {}
    for kind, x, ident in (("sum", alive, 0), ("min", labels, INT32_MAX),
                           ("max", labels, -INT32_MAX - 1)):
        got = spmv.gather_reduce(indptr, nbr, None, x, kind)
        want = spmv.gather_reduce_plain(indptr, nbr, None, x, kind)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"int32 gather_reduce {kind} not bit-equal to its plain version")
        check(torch.equal(got, spmv.gather_reduce(indptr, nbr, None, x, kind)),
              f"int32 gather_reduce {kind} rerun not bit-identical")
        ms = time_ms(lambda: spmv.gather_reduce(indptr, nbr, None, x, kind),
                     device, reps)
        plain_ms = time_ms(lambda: spmv.gather_reduce_plain(
            indptr, nbr, None, x, kind), device, max(3, reps // 4), warmup=1)
        cand = x[idx]
        op = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
        libraries = {"scatter_reduce_": lambda: acc.fill_(ident)
                     .scatter_reduce_(0, rows, cand, op)}
        if kind == "sum":
            libraries["index_add_"] = lambda: acc.zero_().index_add_(
                0, rows, cand)
        lib_all = {k: time_ms(c, device, reps) for k, c in libraries.items()}
        lib_name = min(lib_all, key=lib_all.get)
        nbytes = 4 * e_real + 4 * (vp + 1) + 4 * n + 4 * vp  # nbr, indptr, x, y
        b_ms, b_by = bound(nbytes, e_real)
        cfg = spmv.gather_config(kind, int32=True)
        out[kind] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_all[lib_name], library=lib_name,
                         library_all_ms=lib_all, bound_ms=b_ms, bound_by=b_by,
                         config=cfg)
        print(f"[kernel] gather_reduce {kind} int32: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_all[lib_name]:.4f} "
              f"({lib_name}; "
              + " ".join(f"{k}={v:.4f}" for k, v in lib_all.items())
              + f") bound_ms={b_ms:.4f} ({b_by}) edges={e_real} bit-equal, "
              f"rerun bit-identical registers={cfg['registers']} "
              f"blocks_per_sm={cfg['blocks_per_sm']} "
              f"carveout={cfg['carveout_pct']}%", flush=True)
    return out


def intersect_phase(frag, device, reps: int) -> dict:
    """The row AND-popcount at the bitmap LCC's shapes: the two indexed
    calls of an `lcc_bitmap` query (bitmaps and kept pairs from
    `LCC.pair_operands`), each integer-equal to the plain version, and
    the dense form on the first 4096 pairs of the oe call gathered into
    [4096, words] operands, the chunk the JAX callers hand their kernel,
    which must also equal the indexed call's first 4096 counts.  The bound counts each
    distinct bitmap row the call reads once (plus indices and output);
    the operations are an AND, a popcount and an add per word and pair,
    rated at the published float32 rate outside the tensor cores (no
    32-bit integer rate is published beside it)."""
    from libgrape_lite_tpu_torch.models import LCC
    from libgrape_lite_tpu_torch.ops import intersect
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    bplus, bminus, (v, u), (w, t) = LCC().pair_operands(frag.dev)
    words = bplus.shape[1]
    row_bytes = 4 * words
    chunk = min(4096, u.numel())
    calls = {
        "oe": (bplus, u, bplus, v),  # apex and middle credits
        "ie": (bplus, t, bminus, w),  # far-end credits
        "dense": (bplus[u[:chunk].long()], None, bplus[v[:chunk].long()],
                  None),
    }
    out, counts = {}, {}
    for name, (a, ia, b, ib) in calls.items():
        got = intersect.row_and_popcount_indexed(a, ia, b, ib)
        want = intersect.row_and_popcount_plain(a, ia, b, ib)
        sync(device)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"intersect {name} not integer-equal to its plain version")
        counts[name] = got
        pairs = got.numel()
        ms = time_ms(lambda: intersect.row_and_popcount_indexed(a, ia, b, ib),
                     device, reps, warmup=1, batch=2)
        plain_ms = time_ms(lambda: intersect.row_and_popcount_plain(
            a, ia, b, ib), device, 1, warmup=0, batch=1)
        if ia is None:
            distinct = 2 * pairs
        elif a is b:
            distinct = int(torch.unique(torch.cat([ia, ib])).numel())
        else:
            distinct = (int(torch.unique(ia).numel())
                        + int(torch.unique(ib).numel()))
        idx_bytes = 0 if ia is None else 8 * pairs
        nbytes = distinct * row_bytes + idx_bytes + 4 * pairs
        b_ms, b_by = bound(nbytes, 3 * pairs * words)
        passes = device_passes(
            lambda: intersect.row_and_popcount_indexed(a, ia, b, ib), device,
            calls=2)
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         pairs=pairs, words=words, distinct_rows=distinct,
                         gathered_gb=2 * pairs * row_bytes / 1e9,
                         total=int(got.sum()), passes_ms=passes)
        print(f"[kernel] intersect {name}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms=none bound_ms={b_ms:.4f} "
              f"({b_by}) pairs={pairs} words={words} distinct_rows={distinct} "
              f"gathered_gb={2 * pairs * row_bytes / 1e9:.1f} "
              f"popcount_total={int(got.sum())} integer-equal", flush=True)
        print(f"[kernel]   device ms a call: {passes_text(passes)}",
              flush=True)
    check(torch.equal(counts["dense"], counts["oe"][:chunk]),
          "intersect dense form differs from the indexed form")
    return out


def stacked_phase(device) -> None:
    """Both kernels on a stack of 4 fragments (p2p-31, fnum 4): one
    launch covers every fragment through per-fragment offsets."""
    from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec

    data = os.path.join(HERE, "dataset")
    frag = LoadGraph(os.path.join(data, "p2p-31.e"),
                     os.path.join(data, "p2p-31.v"),
                     CommSpec(fnum=4, device=device),
                     LoadGraphSpec(directed=True, weighted=True))
    ie = frag.dev.ie
    gen = torch.Generator(device="cpu").manual_seed(4)
    x = torch.rand(frag.fnum * frag.vp, generator=gen).to(device)
    for kind, w in (("sum", None), ("min", ie.edge_w), ("max", ie.edge_w)):
        got = spmv.gather_reduce(ie.indptr, ie.edge_nbr, w, x, kind)
        if kind == "sum":
            check_sum(got,
                      spmv.gather_reduce_plain(ie.indptr, ie.edge_nbr, None,
                                               x.double(), "sum"),
                      spmv.gather_reduce_plain(ie.indptr, ie.edge_nbr, None,
                                               x.double().abs(), "sum"),
                      "gather_reduce sum (fnum 4)")
        else:
            want = spmv.gather_reduce_plain(ie.indptr, ie.edge_nbr, w, x, kind)
            check(torch.equal(got, want),
                  f"gather_reduce {kind} (fnum 4) not bit-equal")
    row_lo, tile, rmax = spmv.plan_for_app(frag, frag.vp, torch.float32,
                                           mode="strict")
    row_lo = torch.from_numpy(row_lo).to(device)
    values = torch.where(ie.edge_mask, x[ie.edge_nbr],
                         torch.zeros((), device=device))
    got = spmv.spmv_strict(values, ie.edge_src, row_lo, frag.vp, tile, rmax)
    check_sum(got,
              spmv.spmv_strict_plain(values.double(), ie.edge_src, row_lo,
                                     frag.vp, tile, rmax),
              spmv.spmv_strict_plain(values.double().abs(), ie.edge_src,
                                     row_lo, frag.vp, tile, rmax),
              "strict_tile (fnum 4)")
    sync(device)
    print(f"[stacked] p2p-31 directed fnum=4 vp={frag.vp} "
          f"ep={ie.edge_nbr.shape[1]} tiles={row_lo.shape[1]} rmax={rmax}: "
          "gather_reduce sum/min/max and strict_tile ok", flush=True)


# ---- adversarial shapes: K1 schedule and K3 skipping edge cases ---------

def stack_csr(indptr, nbr, w, fnum: int, pad: int):
    """Cut a flat CSR over N rows (device tensors) into `fnum` fragments
    of vp = ceil(N / fnum) rows, each padded to a common ep = max real
    edges + `pad`: pads (nbr 0, w 0) sit in a gap after every fragment."""
    n = indptr.numel() - 1
    vp = -(-n // fnum)
    ind = torch.cat([indptr.long(), indptr[-1:].long().expand(fnum * vp - n)])
    cuts = ind[::vp].tolist()  # fnum + 1 fragment bounds
    ep = max(b - a for a, b in zip(cuts, cuts[1:])) + pad
    ip = torch.stack([ind[f * vp:(f + 1) * vp + 1] - cuts[f]
                      for f in range(fnum)]).to(torch.int32)
    nb = nbr.new_zeros(fnum, ep)
    ww = None if w is None else w.new_zeros(fnum, ep)
    for f in range(fnum):
        a, b = cuts[f], cuts[f + 1]
        nb[f, :b - a] = nbr[a:b]
        if ww is not None:
            ww[f, :b - a] = w[a:b]
    return ip.contiguous(), nb, ww


def k1_shape_checks(name, indptr, nbr, w, device, reps: int) -> dict:
    """Every kind of gather_reduce on one CSR against its plain version
    (sum within SUM_TOL of each row's sum|terms|, with and without
    weights; min, max and int32 sum / min / max bit-equal), each float
    sum rerun bit-identical; kernel and plain times of the unweighted
    sum."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    n = indptr.shape[0] * (indptr.shape[1] - 1)
    edges = int(indptr[:, -1].sum())
    gen = torch.Generator(device="cpu").manual_seed(6)
    x = (torch.rand(n, generator=gen) * 2 - 1).to(device)
    labels = torch.randint(-INT32_MAX - 1, INT32_MAX, (n,), generator=gen,
                           dtype=torch.int32).to(device)
    for win in (None, w):
        got = spmv.gather_reduce(indptr, nbr, win, x, "sum")
        wd = None if win is None else win.double()
        check_sum(got,
                  spmv.gather_reduce_plain(indptr, nbr, wd, x.double(), "sum"),
                  spmv.gather_reduce_plain(
                      indptr, nbr, None if wd is None else wd.abs(),
                      x.double().abs(), "sum"),
                  f"{name}: gather_reduce sum (w={win is not None})")
        check(torch.equal(got, spmv.gather_reduce(indptr, nbr, win, x,
                                                  "sum")),
              f"{name}: gather_reduce sum rerun not bit-identical")
    for kind, xin, win in (("min", x, w), ("max", x, None),
                           ("sum", labels & 1, None), ("min", labels, None),
                           ("max", labels, None)):
        got = spmv.gather_reduce(indptr, nbr, win, xin, kind)
        check(torch.equal(got, spmv.gather_reduce_plain(indptr, nbr, win,
                                                        xin, kind)),
              f"{name}: gather_reduce {kind} {xin.dtype} not bit-equal")
    ms = time_ms(lambda: spmv.gather_reduce(indptr, nbr, None, x, "sum"),
                 device, reps)
    plain_ms = time_ms(lambda: spmv.gather_reduce_plain(indptr, nbr, None, x,
                                                        "sum"),
                       device, 3, warmup=1)
    print(f"[shape] k1 {name}: fnum={indptr.shape[0]} "
          f"vp={indptr.shape[1] - 1} ep={nbr.shape[1]} edges={edges} "
          f"sum kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}; sum, sum+w "
          "within 1e-5 sum|terms| and rerun bit-identical; min+w, max, "
          "int32 sum/min/max bit-equal", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, edges=edges)


def k1_shapes_phase(frag, device, reps: int = 10) -> dict:
    """gather_reduce on the shapes that break a row-per-warp or a
    merge-path schedule: a star (one row of 2^22 edges, 2^22 rows of one
    edge), a stack whose second fragment has no edges, a degree-1 chain,
    and RMAT-20 stacked at fnum 4 with an unaligned pad gap after each
    fragment."""
    gen = torch.Generator(device="cpu").manual_seed(8)
    out = {}
    leaves = 1 << 22
    ind = torch.arange(-1, leaves + 1, dtype=torch.int32)
    ind[0] = 0
    ind[1:] += leaves  # row 0: edges [0, 2^22); row i: one edge
    nbr = torch.cat([torch.arange(1, leaves + 1, dtype=torch.int32),
                     torch.zeros(leaves, dtype=torch.int32)])
    w = torch.rand(2 * leaves, generator=gen) + 0.5
    out["star"] = k1_shape_checks(
        "star", *stack_csr(ind.to(device), nbr.to(device), w.to(device), 1,
                           0), device, reps)

    vp = 1 << 16
    deg = torch.randint(0, 8, (vp,), generator=gen)
    ind = torch.cat([torch.zeros(1, dtype=torch.int64), deg.cumsum(0)])
    nbr = torch.randint(0, 2 * vp, (int(ind[-1]),), generator=gen,
                        dtype=torch.int32)
    ip, nb, ww = stack_csr(
        ind.to(torch.int32).to(device), nbr.to(device),
        (torch.rand(nbr.numel(), generator=gen) + 0.5).to(device), 1, 5)
    ip = torch.cat([ip, torch.zeros_like(ip)])  # fragment 1: no edges
    out["empty_fragment"] = k1_shape_checks(
        "empty_fragment", ip, torch.cat([nb, torch.zeros_like(nb)]),
        torch.cat([ww, torch.zeros_like(ww)]), device, reps)

    n = 1 << 20
    ind = torch.cat([torch.zeros(1, dtype=torch.int32),
                     torch.arange(n, dtype=torch.int32)])  # row 0 empty
    nbr = torch.arange(n - 1, dtype=torch.int32)  # row r <- r - 1
    out["chain"] = k1_shape_checks(
        "chain", *stack_csr(ind.to(device), nbr.to(device),
                            (torch.rand(n - 1, generator=gen) + 0.5)
                            .to(device), 1, 0), device, reps)

    ie = frag.dev.ie
    e_real = int(ie.indptr[0, -1])
    out["rmat_fnum4"] = k1_shape_checks(
        f"rmat{SCALE}_fnum4", *stack_csr(ie.indptr[0], ie.edge_nbr[0, :e_real],
                                         ie.edge_w[0, :e_real], 4, 1037),
        device, reps)
    return out


def stack_strict(src, vals, n: int, fnum: int, pad: int, device):
    """Cut row-sorted edges (src in [0, n), numpy) into `fnum` fragments
    of vp = ceil(n / fnum) rows, each padded to a common ep = max real
    edges + `pad` with pads (src = vp, value 7.7: pads credit nothing),
    and plan them as `plan_for_app` does (per-fragment `plan_tiles`, the
    widest rmax).  Returns (values, edge_src, row_lo, vp, rmax)."""
    from libgrape_lite_tpu_torch.ops import spmv

    vp = -(-n // fnum)
    cuts = np.searchsorted(src, np.arange(fnum + 1) * vp)
    ep = int(np.diff(cuts).max()) + pad
    values = np.full((fnum, ep), 7.7, np.float32)
    edge_src = np.full((fnum, ep), vp, np.int32)
    for f in range(fnum):
        a, b = cuts[f], cuts[f + 1]
        values[f, :b - a] = vals[a:b]
        edge_src[f, :b - a] = src[a:b] - f * vp
    plans = [spmv.plan_tiles(s_f, spmv.STRICT_TILE, vp) for s_f in edge_src]
    row_lo = np.stack([p[0] for p in plans])
    return (torch.from_numpy(values).to(device),
            torch.from_numpy(edge_src).to(device),
            torch.from_numpy(row_lo).to(device), vp,
            max(p[1] for p in plans))


def k2_shapes_phase(frag, device, reps: int = 10) -> dict:
    """strict_tile on the shapes that break a tile schedule: a star (one
    row of 2^22 edges over 2,048 tiles, then 2^22 rows of one edge), a
    stack whose second fragment has no edges, a degree-1 chain (every
    edge its own row) and RMAT-20 stacked at fnum 4 with a pad gap after
    each fragment; ep is a multiple of the tile only for the star.  Each
    within SUM_TOL of each row's sum|terms| against spmv_strict_plain in
    float64, rerun bit-identical; kernel, plain and per-pass times."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    rng = np.random.default_rng(10)
    shapes = {}
    leaves = 1 << 22
    src = np.concatenate([np.zeros(leaves, np.int64),
                          np.arange(1, leaves + 1)])
    shapes["star"] = (src, leaves + 1, 1, 0)
    n = 1 << 16
    src = np.repeat(np.arange(n), rng.integers(0, 8, n))
    shapes["empty_fragment"] = (src, 2 * n, 2, 5)  # rows n.. have none
    n = 1 << 20
    shapes["chain"] = (np.arange(1, n), n, 1, 0)  # row 0 empty
    ie = frag.dev.ie
    e_real = int(ie.indptr[0, -1])
    shapes[f"rmat{SCALE}_fnum4"] = (
        ie.edge_src[0, :e_real].cpu().numpy().astype(np.int64), frag.vp, 4,
        1037)
    out = {}
    for name, (src, rows, fnum, pad) in shapes.items():
        vals = (rng.random(len(src)) * 2 - 1).astype(np.float32)
        values, edge_src, row_lo, vp, rmax = stack_strict(
            src, vals, rows, fnum, pad, device)
        tile = spmv.STRICT_TILE
        args = (values, edge_src, row_lo, vp, tile, rmax)
        got = spmv.spmv_strict(*args)
        check_sum(got,
                  spmv.spmv_strict_plain(values.double(), *args[1:]),
                  spmv.spmv_strict_plain(values.double().abs(), *args[1:]),
                  f"{name}: strict_tile")
        check(torch.equal(got, spmv.spmv_strict(*args)),
              f"{name}: strict_tile rerun not bit-identical")
        ms = time_ms(lambda: spmv.spmv_strict(*args), device, reps)
        plain_ms = time_ms(lambda: spmv.spmv_strict_plain(*args), device, 3,
                           warmup=1)
        passes = device_passes(lambda: spmv.spmv_strict(*args), device,
                               calls=3)
        ep = values.shape[1]
        out[name] = dict(ms=ms, plain_ms=plain_ms, edges=len(src),
                         passes_ms=passes)
        print(f"[shape] k2 {name}: fnum={fnum} vp={vp} ep={ep} "
              f"ep%tile={ep % tile} tiles={row_lo.shape[1]} rmax={rmax} "
              f"edges={len(src)} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}; "
              f"within 1e-5 sum|terms|, rerun bit-identical; device ms a "
              f"call: {passes_text(passes)}", flush=True)
    return out


def k3_shapes_phase(frag, device, reps: int = 3) -> dict:
    """The row AND-popcount on pair lists that break an ordered-pairs
    schedule: the oe pairs of the RMAT-18 bitmap LCC shuffled, one hub
    row in 10^5 pairs, rows of 37 and 3 words (words % 4 != 0) and an
    empty pair list; integer-equal to the plain version."""
    from libgrape_lite_tpu_torch.models import LCC
    from libgrape_lite_tpu_torch.ops import intersect
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    bplus, _, (v, u), _ = LCC().pair_operands(frag.dev)
    gen = torch.Generator(device="cpu").manual_seed(9)
    perm = torch.randperm(u.numel(), generator=gen).to(device)
    hub = int(torch.bincount(v.long()).argmax())  # most kept edges
    m = 100_000
    hub_ia = torch.full((m,), hub, dtype=torch.int32, device=device)
    hub_ib = torch.randint(0, bplus.shape[0], (m,), generator=gen,
                           dtype=torch.int32).to(device)
    cases = {
        "oe_shuffled": (bplus, u[perm].contiguous(), bplus,
                        v[perm].contiguous()),
        "hub_1e5": (bplus, hub_ib, bplus, hub_ia),
    }
    for words in (37, 3):
        rows = 4096
        bits = torch.rand(rows, words * 32, generator=gen) < 0.02
        weights = (1 << torch.arange(32, dtype=torch.int64))
        packed = (bits.view(rows, words, 32).long() * weights).sum(-1)
        bm = torch.where(packed >= 1 << 31, packed - (1 << 32),
                         packed).to(torch.int32).to(device)
        ia = torch.randint(0, rows, (50_000,), generator=gen,
                           dtype=torch.int32).to(device)
        ib = torch.randint(0, rows, (50_000,), generator=gen,
                           dtype=torch.int32).to(device)
        cases[f"words{words}"] = (bm, ia, bm[1:].contiguous(),
                                  (ib % (rows - 1)).contiguous())
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    cases["n0"] = (bplus, empty, bplus, empty)
    out = {}
    for name, (a, ia, b, ib) in cases.items():
        got = intersect.row_and_popcount_indexed(a, ia, b, ib)
        want = intersect.row_and_popcount_plain(a, ia, b, ib)
        sync(device)
        check(got.dtype == torch.int32 and got.shape == want.shape
              and torch.equal(got, want),
              f"intersect {name} not integer-equal to its plain version")
        ms = time_ms(lambda: intersect.row_and_popcount_indexed(a, ia, b, ib),
                     device, reps, warmup=1, batch=2)
        out[name] = dict(ms=ms, pairs=got.numel())
        print(f"[shape] k3 {name}: pairs={got.numel()} words={a.shape[1]} "
              f"kernel_ms={ms:.4f} total={int(got.sum())} integer-equal",
              flush=True)
    check(torch.equal(
        intersect.row_and_popcount_indexed(bplus, u, bplus, v)[perm],
        intersect.row_and_popcount_indexed(*cases["oe_shuffled"])),
        "intersect oe_shuffled is not the oe counts permuted")
    return out


# ---- phases 2-3: the main path through Worker.query ---------------------

def reset_launch_counts() -> None:
    from libgrape_lite_tpu_torch.ops import intersect, spmv

    spmv.reset_launch_counts()
    intersect.reset_launch_counts()


def launch_counts() -> dict:
    from libgrape_lite_tpu_torch.ops import intersect, spmv

    return {"gather_reduce": spmv.gather_reduce.launches,
            "gather_reduce_lanes": spmv.gather_reduce_lanes.launches,
            "overlay_fold": spmv.overlay_fold.launches,
            "strict_tile": spmv.spmv_strict.launches,
            "intersect": intersect.row_and_popcount_indexed.launches}


@contextlib.contextmanager
def plain_versions():
    """Route the apps' kernel calls to the plain versions (comparison runs
    only; the wrappers themselves never fall back), and prove afterwards
    that no kernel was launched meanwhile."""
    from libgrape_lite_tpu_torch.ops import intersect, spmv

    reset_launch_counts()
    with mock.patch.multiple(
            spmv, gather_reduce=spmv.gather_reduce_plain,
            gather_reduce_lanes=spmv.gather_reduce_lanes_plain,
            overlay_fold=spmv.overlay_fold_plain,
            spmv_strict=spmv.spmv_strict_plain), \
            mock.patch.object(intersect, "row_and_popcount_indexed",
                              intersect.row_and_popcount_plain):
        yield
    check(not any(launch_counts().values()),
          "a kernel was launched during the plain-version run")


def run_query(frag, app, device, **kw):
    from libgrape_lite_tpu_torch.worker.worker import Worker

    wk = Worker(app, frag)
    sync(device)
    t0 = time.perf_counter()
    wk.query(**kw)
    sync(device)
    return wk, time.perf_counter() - t0


def timed_counted(fn, device):
    """`fn()` -> Worker, once to warm up, once with the launch counts
    zeroed just before and read just after, twice more for the best of
    3 seconds (host clock, synchronised)."""
    def run():
        sync(device)
        t0 = time.perf_counter()
        wk = fn()
        sync(device)
        return wk, time.perf_counter() - t0

    run()
    reset_launch_counts()
    wk, secs = run()
    counts = launch_counts()
    return wk, counts, min([secs] + [run()[1] for _ in range(2)])


def counted(frag, app_factory, device, kw):
    """Drive one main-path query with the launch counts zeroed just
    before and read just after; then time two more runs (best of 3)."""
    return timed_counted(
        lambda: run_query(frag, app_factory(), device, **kw)[0], device)


def pagerank_phase(frag, e_sym, device, mode) -> dict:
    from libgrape_lite_tpu_torch.models import PageRank

    kw = {"delta": 0.85, "max_round": PR_ROUNDS}
    wk, counts, best = counted(
        frag, lambda: PageRank(spmv_mode=mode), device, kw)
    ranks = wk.result_values()
    used = "strict_tile" if wk.app._spmv_tile else "gather_reduce"
    if mode == "strict":
        check(used == "strict_tile", "mode strict did not take the strict plan")
    check(counts[used] >= PR_ROUNDS, f"PageRank {mode}: {used} launched "
          f"{counts[used]} times in {PR_ROUNDS} rounds")
    check(wk.rounds == PR_ROUNDS, f"PageRank ran {wk.rounds} rounds")
    check(bool(np.isfinite(ranks).all() and (ranks >= 0).all()),
          "PageRank ranks not finite and >= 0")
    mass = float(ranks.astype(np.float64).sum())
    check(abs(mass - 1.0) <= 1e-3, f"PageRank mass {mass} != 1 within 1e-3")
    rerun = run_query(frag, PageRank(spmv_mode=mode), device, **kw)[0]
    check(np.array_equal(rerun.result_values(), ranks),
          f"PageRank {mode} rerun not bitwise identical")
    with plain_versions():
        plain = run_query(frag, PageRank(spmv_mode=mode), device, **kw)[0]
    ref = plain.result_values()
    rel = float(np.max(np.abs(ranks - ref) / np.maximum(np.abs(ref), 1e-30)))
    check(rel <= 1e-4, f"PageRank {mode} vs plain versions: rel err {rel:.3e}")
    mteps = e_sym * wk.rounds / best / 1e6
    print(f"[pagerank] mode={mode} kernel={used} rounds={wk.rounds} "
          f"seconds={best:.4f} mteps={mteps:.1f} mass={mass:.6f} "
          f"rel_err_vs_plain={rel:.3e} launches={counts}", flush=True)
    return dict(counts=counts, seconds=best, mteps=mteps, kernel=used)


def sssp_phase(frag, e_sym, device) -> dict:
    from libgrape_lite_tpu_torch.models import SSSP

    wk, counts, best = counted(frag, SSSP, device, {"source": 0})
    dist = wk.result_values()
    check(counts["gather_reduce"] == wk.rounds,
          f"SSSP: {counts['gather_reduce']} gather_reduce launches in "
          f"{wk.rounds} rounds")
    with plain_versions():
        plain = run_query(frag, SSSP(), device, source=0)[0]
    check(plain.rounds == wk.rounds, "SSSP rounds differ from the plain run")
    check(np.array_equal(plain.result_values(), dist),
          "SSSP not bit-equal to the plain-version run")
    reached = int(np.isfinite(dist).sum())
    mteps = e_sym / best / 1e6
    print(f"[sssp] rounds={wk.rounds} seconds={best:.4f} mteps={mteps:.1f} "
          f"reached={reached} launches={counts}", flush=True)
    return dict(counts=counts, seconds=best, mteps=mteps, rounds=wk.rounds)


def app_counters(app) -> dict:
    """The host loop's counters of an exchange app (overflow retries,
    settled capacity, bucket advances, push / pull rounds)."""
    return {k: getattr(app, k) for k in APP_COUNTERS if hasattr(app, k)}


def app_phase(name, frag, app_factory, device, kw, edges=None,
              passes=1, rtol=0.0) -> dict:
    """One app through `Worker.query`: launch counts of a counted run,
    query seconds (best of 3 after a warm-up), values and equal rounds
    (and loop counters) against a run on the plain versions -- bit-equal,
    or within `rtol` relative for float sums -- and MTEPS = edges *
    passes / seconds when `edges` is given (passes "rounds": one full
    pull a round)."""
    wk, counts, best = counted(frag, app_factory, device, kw)
    values = wk.result_values()
    with plain_versions():
        plain = run_query(frag, app_factory(), device, **kw)[0]
    check(plain.rounds == wk.rounds,
          f"{name}: {wk.rounds} rounds, {plain.rounds} on the plain versions")
    counters = app_counters(wk.app)
    check(app_counters(plain.app) == counters,
          f"{name}: counters {counters}, {app_counters(plain.app)} on the "
          "plain versions")
    ref = plain.result_values()
    if rtol:
        rel = float(np.max(np.abs(values - ref)
                           / np.maximum(np.abs(ref), 1e-30)))
        check(rel <= rtol, f"{name} vs plain versions: rel err {rel:.3e}")
        agree = f"within {rtol:g} of plain (rel err {rel:.3e})"
    else:
        check(np.array_equal(ref, values),
              f"{name} not bit-equal to the plain-version run")
        agree = "bit-equal to plain"
    if passes == "rounds":
        passes = wk.rounds
    mteps = None if edges is None else edges * passes / best / 1e6
    print(f"[app] {name} rounds={wk.rounds} seconds={best:.4f} mteps="
          f"{'n/a' if mteps is None else f'{mteps:.1f}'} "
          + "".join(f"{k}={v} " for k, v in counters.items())
          + f"launches={counts} {agree}", flush=True)
    return dict(values=values, counts=counts, seconds=best,
                rounds=wk.rounds, mteps=mteps, **counters)


def ldbc_phases(frag, e_sym, frag18, frag16, device) -> dict:
    """BFS, WCC, CDLP and lcc (LCCBeta) on RMAT-20, lcc_bitmap on RMAT-18,
    lcc_directed on the directed RMAT-16, with each app's own checks."""
    from libgrape_lite_tpu_torch.models import (
        BFS, CDLP, LCC, WCC, LCCBeta, LCCDirected,
    )

    inner = frag.host_inner_mask()
    out = {}
    r = out["bfs"] = app_phase("bfs", frag, BFS, device, {"source": 0},
                               e_sym)
    depth = r["values"]
    check(r["counts"]["gather_reduce"] == r["rounds"],
          "BFS: one gather_reduce launch per round")
    reached = depth[inner] < np.iinfo(np.int64).max
    check(depth.min() == 0 and int(depth[inner][reached].max()) == r["rounds"]
          - 1, "BFS depths do not run from 0 to rounds - 1")
    r["reached"] = int(reached.sum())

    r = out["wcc"] = app_phase("wcc", frag, WCC, device, {}, e_sym)
    check(r["counts"]["gather_reduce"] == r["rounds"],
          "WCC: one gather_reduce launch per round (undirected)")
    comp = r["values"][inner]
    r["components"] = int(np.unique(comp).size)
    # each component is labelled by its smallest member oid
    check(bool((comp <= frag.host_oids[inner]).all()),
          "WCC label above its vertex's own oid")

    r = out["cdlp"] = app_phase("cdlp", frag, CDLP, device,
                                {"max_round": CDLP_ROUNDS}, e_sym,
                                passes=CDLP_ROUNDS)
    check(r["rounds"] == CDLP_ROUNDS - 1, "CDLP round count")
    check(bool(np.isin(r["values"][inner], frag.host_oids[inner]).all()),
          "CDLP label outside the vertex ids")
    r["communities"] = int(np.unique(r["values"][inner]).size)

    def lcc_ok(name, values, mask):
        check(bool(np.isfinite(values).all() and (values >= 0).all()
                   and (values[mask] <= 1).all()),
              f"{name}: lcc outside [0, 1]")

    r = out["lcc"] = app_phase("lcc", frag, LCCBeta, device, {})
    lcc_ok("lcc", r["values"], inner)

    r = out["lcc_bitmap"] = app_phase("lcc_bitmap", frag18, LCC, device, {})
    check(r["counts"]["intersect"] == 2, "lcc_bitmap: two intersect launches "
          "per query")
    lcc_ok("lcc_bitmap", r["values"], frag18.host_inner_mask())
    beta = run_query(frag18, LCCBeta(), device)[0].result_values()
    check(np.array_equal(beta, r["values"]),
          "lcc_bitmap and lcc (LCCBeta) differ on RMAT-18")

    r = out["lcc_directed"] = app_phase("lcc_directed", frag16, LCCDirected,
                                        device, {})
    check(r["counts"]["intersect"] == 1, "lcc_directed: one intersect launch "
          "per query")
    lcc_ok("lcc_directed", r["values"], frag16.host_inner_mask())
    for res in out.values():
        del res["values"]
    return out


def variants_phase(frag, e_sym, device) -> dict:
    """The app variants on RMAT-20 through `Worker.query`, each with
    `app_phase`'s checks (launch counts, bit-equal to a run on the plain
    versions with equal rounds and loop counters, best-of-3 seconds,
    MTEPS as for its base app), the gather-reduce kernel launched and no
    other kernel, and its values against its base app's on the same
    graph: bit-equal for the SSSP, BFS and WCC forms and `cdlp_opt`,
    1e-4 relative for `pagerank_auto` (also against its plain-version
    run, as `pagerank_phase` holds PageRank)."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    base = {}
    for b, kw in BASE_QUERIES.items():
        base[b] = run_query(frag, APP_REGISTRY[b](), device,
                            **kw)[0].result_values()
    out = {}
    for name in VARIANTS:
        b = name.split("_")[0]
        passes = {"pagerank": PR_ROUNDS, "cdlp": CDLP_ROUNDS}.get(b, 1)
        r = out[name] = app_phase(name, frag, APP_REGISTRY[name], device,
                                  BASE_QUERIES[b], e_sym, passes,
                                  rtol=1e-4 if b == "pagerank" else 0.0)
        counts = r["counts"]
        check(counts["gather_reduce"] > 0
              and counts["strict_tile"] == counts["intersect"] == 0,
              f"{name}: launches {counts}; the gather-reduce kernel only")
        got, want = r.pop("values"), base[b]
        if b == "pagerank":
            rel = float(np.max(np.abs(got - want)
                               / np.maximum(np.abs(want), 1e-30)))
            check(rel <= 1e-4, f"{name} vs pagerank: rel err {rel:.3e}")
        else:
            check(np.array_equal(got, want), f"{name} differs from {b} in "
                  f"{int((got != want).sum())} vertices")
        if name == "bfs_opt":
            check(r["push_rounds"] > 0 and r["pull_rounds"] > 0,
                  "bfs_opt did not both push and pull")
    return out


def select_phase(frag, grid, device) -> dict:
    """`sssp_select`'s probe and pick, then the picked app through
    `Worker.query` from vertex 0: RMAT-20 converges inside the cap (64
    levels) and takes the dense pull; the grid, whose frontier outlives
    the cap, takes the near/far buckets, bit-equal to the dense pull
    there (timed beside it)."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY, SSSP
    from libgrape_lite_tpu_torch.models.sssp_select import (
        select_sssp_variant,
    )

    out = {}
    for label, g, want in ((f"rmat{SCALE}", frag, "sssp"),
                           (f"grid{GRID_SIDE}", grid, "sssp_delta")):
        t0 = time.perf_counter()
        picked, reason = select_sssp_variant(g, 0)
        probe_s = time.perf_counter() - t0
        check(picked == want, f"sssp_select on {label} picked {picked} "
              f"({reason}), expected {want}")
        wk, counts, best = counted(g, APP_REGISTRY[picked], device,
                                   {"source": 0})
        check(counts["gather_reduce"] > 0,
              f"sssp_select on {label}: no gather_reduce launch")
        dense, _, dense_s = counted(g, SSSP, device, {"source": 0})
        check(np.array_equal(wk.result_values(), dense.result_values()),
              f"sssp_select on {label}: {picked} differs from sssp")
        out[label] = dict(picked=picked, probe_seconds=probe_s,
                          seconds=best, rounds=wk.rounds,
                          dense_seconds=dense_s, dense_rounds=dense.rounds,
                          **app_counters(wk.app))
        print(f"[select] {label}: picked={picked} reason={reason!r} "
              f"probe_seconds={probe_s:.4f} query_seconds={best:.4f} "
              f"rounds={wk.rounds} "
              + "".join(f"{k}={v} " for k, v in app_counters(wk.app).items())
              + f"launches={counts}; dense sssp seconds={dense_s:.4f} "
              f"rounds={dense.rounds}, bit-equal", flush=True)
    return out


# ---- the apps beyond the LDBC six ---------------------------------------

def loops_and_neighbours(frag):
    """(pids with a self loop, {pid: set of neighbour pids}) from the host
    CSRs; neighbours only for the rows asked for via the returned getter."""
    loops = []
    for f, c in enumerate(frag.host_oe):
        e = c.num_edges
        src = f * frag.vp + c.edge_src[:e].astype(np.int64)
        loops.append(src[src == c.edge_nbr[:e]])
    loops = set(np.concatenate(loops).tolist())

    def neighbours(pid):
        c = frag.host_oe[pid // frag.vp]
        lo, hi = c.indptr[pid % frag.vp], c.indptr[pid % frag.vp + 1]
        return set(c.edge_nbr[lo:hi].tolist())
    return loops, neighbours


def cn_identity_ok(frag, source_pid: int, cn, tri_source: int) -> bool:
    """A common_neighbors result against the source's triangle count u:
    the sum of cn(v) over the neighbours v != u of u is 2 T(u), plus
    |N(u) - {u}| when u has a self loop, plus one for each such neighbour
    with a self loop (cn(v) = |N(u) & N(v)| counts u and v themselves
    there)."""
    loops, neighbours = loops_and_neighbours(frag)
    near = neighbours(source_pid) - {source_pid}
    flat = np.asarray(cn).reshape(-1)
    got = int(flat[sorted(near)].sum())
    want = (2 * tri_source + (source_pid in loops) * len(near)
            + len(near & loops))
    return got == want


def brandes_identity(delta, depth, source_pid: int):
    """(sum of delta(v) over v != s, sum of depth(t) - 1 over the reached
    t != s): equal for single-source dependencies, since each shortest
    s-t path has depth(t) - 1 interior vertices."""
    d = np.asarray(delta, dtype=np.float64).reshape(-1).copy()
    d[source_pid] = 0.0
    dep = np.asarray(depth).reshape(-1)
    reached = (dep >= 1) & (dep < np.iinfo(np.int64).max)
    return float(d.sum()), float((dep[reached] - 1).sum())


def more_apps_phase(frag, e_sym, device) -> dict:
    """The apps beyond the LDBC six on RMAT-20 through `Worker.query`,
    each with `app_phase`'s checks (launch counts; against its run on the
    plain versions: integers bit-equal, `bc` and `pagerank_local` within
    1e-4 relative, PageRank's rule; equal rounds and counters) and the
    cross-checks with no plain code in them: kcore(16) is
    core_decomposition's core >= 16; khop(k) is BFS's depth masked to
    <= k; bc's dependencies satisfy the Brandes identity against BFS's
    depths and its path counts stay finite; pagerank_local's ranks sum to
    the vertex count (an undirected graph keeps the mass); the
    common-neighbour counts satisfy the triangle identity against
    LCCBeta's credit at the source; kclique k = 3's total is a third of
    LCCBeta's credits."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY, BFS, LCCBeta

    inner = frag.host_inner_mask()
    out = {}
    r = out["kcore"] = app_phase("kcore", frag, APP_REGISTRY["kcore"], device,
                                 {"k": KCORE_K}, e_sym, "rounds")
    r = out["core_decomposition"] = app_phase(
        "core_decomposition", frag, APP_REGISTRY["core_decomposition"],
        device, {}, e_sym, "rounds")
    core = r["values"]
    check(np.array_equal(out["kcore"]["values"],
                         (core >= KCORE_K).astype(np.int64)),
          f"kcore({KCORE_K}) differs from core_decomposition's core >= "
          f"{KCORE_K}")
    r["max_core"] = int(core.max())
    print(f"[app]   kcore({KCORE_K}) = core_decomposition core >= {KCORE_K}: "
          f"{int(out['kcore']['values'].sum())} members, max core "
          f"{r['max_core']}", flush=True)

    r = out["pagerank_local"] = app_phase(
        "pagerank_local", frag, APP_REGISTRY["pagerank_local"], device,
        {"delta": 0.85, "max_round": PR_ROUNDS}, e_sym, "rounds", rtol=1e-4)
    mass = float(r["values"].astype(np.float64)[inner].sum())
    n_inner = int(inner.sum())
    check(abs(mass - n_inner) <= 1e-4 * n_inner,
          f"pagerank_local mass {mass} != {n_inner} vertices")
    print(f"[app]   pagerank_local mass={mass:.3f} vertices={n_inner}",
          flush=True)

    depth = run_query(frag, BFS(), device, source=0)[0].result_values()
    src = int(frag.oid_to_pid(np.array([0]))[0])
    r = out["bc"] = app_phase("bc", frag, APP_REGISTRY["bc"], device,
                              {"source": 0}, e_sym, rtol=1e-4)
    wk = run_query(frag, APP_REGISTRY["bc"](), device, source=0)[0]
    pn = wk._result_state["pn"]
    r["pn_max"] = float(pn.max())
    r["pn_finite"] = bool(torch.isfinite(pn).all())
    got, want = brandes_identity(r["values"], depth, src)
    check(abs(got - want) <= 1e-4 * want,
          f"bc: sum of dependencies {got} != {want}")
    print(f"[app]   bc levels={wk.app.levels} pn_max={r['pn_max']:.6e} "
          f"pn_finite={r['pn_finite']} (float32; exact below 2^24) "
          f"sum_delta={got:.6e} brandes={want:.6e}", flush=True)
    check(r["pn_finite"], "bc: a float32 path count overflowed")

    for k in KHOP_KS:
        r = out[f"khop_{k}"] = app_phase(
            f"khop k={k}", frag, lambda k=k: APP_REGISTRY["khop"](k=k),
            device, {"source": 0}, e_sym)
        check(np.array_equal(r["values"], np.where(depth <= k, depth, -1)),
              f"khop({k}) differs from BFS's depths masked to <= {k}")
    print(f"[app]   khop k={KHOP_KS} = bfs depths masked to <= k", flush=True)

    credits = LCCBeta().triangles(frag.dev, None).cpu().numpy()
    r = out["common_neighbors"] = app_phase(
        "common_neighbors", frag, APP_REGISTRY["common_neighbors"], device,
        {"source": 0}, e_sym)
    check(cn_identity_ok(frag, src, r["values"], int(credits.reshape(-1)[src])),
          "common_neighbors: the triangle identity at the source fails")

    r = out["kclique_3"] = app_phase("kclique k=3", frag,
                                     APP_REGISTRY["kclique"], device,
                                     {"k": 3})
    check(r["used_device_kernel"] and 3 * r["total_cliques"]
          == int(credits.astype(np.int64).sum()),
          f"kclique k=3: {r['total_cliques']} triangles, LCCBeta credits "
          f"{int(credits.astype(np.int64).sum())} (3 per triangle)")
    print(f"[app]   common_neighbors: triangle identity at the source ok; "
          f"kclique k=3 total={r['total_cliques']} = LCCBeta credits / 3",
          flush=True)
    for name, res in out.items():
        if not name.startswith("kclique"):
            check(res["counts"]["gather_reduce"] > 0,
                  f"{name} did not launch gather_reduce")
        del res["values"]
    return out


def clique_phases(frag18, device) -> dict:
    """triangle_count on RMAT-18 (lcc_bitmap's cut: a bitmap at RMAT-20 is
    128 GiB) with its two AND-popcount launches and per-vertex counts
    equal to LCCBeta's credits; kclique k = 4 on the device on the
    undirected RMAT-16 (KClique4Device: its oriented D fits hub_cap,
    RMAT-18's does not); KCliqueDevice(5) on the same graph, called
    directly (D past general_cap(5)); and on RMAT-11 the device apps at
    k = 4 and 5 against the host recursion, per apex."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY, KClique, LCCBeta
    from libgrape_lite_tpu_torch.models.kclique_device import KCliqueDevice

    out = {}
    r = out["triangle_count"] = app_phase(
        f"triangle_count rmat{BITMAP_SCALE}", frag18,
        APP_REGISTRY["triangle_count"], device, {})
    check(r["counts"]["intersect"] == 2, "triangle_count: two intersect "
          "launches per query")
    credits = LCCBeta().triangles(frag18.dev, None).cpu().numpy()
    inner = frag18.host_inner_mask()
    check(np.array_equal(r["values"], np.where(inner, credits, 0)),
          "triangle_count differs from LCCBeta's credits")
    print(f"[app]   triangle_count = LCCBeta credits: "
          f"{int(r['values'].sum()) // 3} triangles", flush=True)

    t0 = time.perf_counter()
    frag16, _ = rmat_fragment(KCLIQUE4_SCALE, device)
    dmax = {KCLIQUE4_SCALE: KClique._oriented_dmax(frag16),
            BITMAP_SCALE: KClique._oriented_dmax(frag18)}
    print(f"[app] kclique oriented D: "
          + " ".join(f"rmat{k}={v}" for k, v in dmax.items())
          + f" (hub_cap {KClique.hub_cap}, general_cap(5) "
          f"{KClique().general_cap(5)}); host_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    r = out["kclique_4"] = app_phase(
        f"kclique k=4 rmat{KCLIQUE4_SCALE}", frag16, APP_REGISTRY["kclique"],
        device, {"k": 4})
    check(r["used_device_kernel"], "kclique k=4 did not take the device app")
    # no kernel and no plain version behind it: two runs, the second
    # timed and bit-equal to the first
    reset_launch_counts()
    first = run_query(frag16, KCliqueDevice(5), device)[0].result_values()
    wk, secs = run_query(frag16, KCliqueDevice(5), device)
    check(np.array_equal(wk.result_values(), first),
          "KCliqueDevice(5) rerun differs")
    out["kclique_5"] = dict(values=first, seconds=secs, rounds=wk.rounds,
                            counts=launch_counts(),
                            total_cliques=int(first.sum()))
    print(f"[app] KCliqueDevice(5) rmat{KCLIQUE5_SCALE} seconds={secs:.4f} "
          f"total_cliques={int(first.sum())} rerun bit-equal", flush=True)

    small, _ = rmat_fragment(KCLIQUE_CHECK_SCALE, device)
    for k in (4, 5):
        dev_app, host_app = KClique(), KClique()
        host_app.hub_cap = host_app._GENERAL_WORK_BUDGET = 0
        t0 = time.perf_counter()
        dev_w = run_query(small, dev_app, device, k=k)[0]
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_w = run_query(small, host_app, device, k=k)[0]
        host_s = time.perf_counter() - t0
        check(dev_app.used_device_kernel and not host_app.used_device_kernel
              and np.array_equal(dev_w.result_values(),
                                 host_w.result_values()),
              f"kclique k={k} rmat{KCLIQUE_CHECK_SCALE}: device and host "
              "recursion differ")
        print(f"[app]   kclique k={k} rmat{KCLIQUE_CHECK_SCALE}: device "
              f"= host recursion per apex, total={dev_app.total_cliques} "
              f"device_s={dev_s:.3f} host_s={host_s:.3f}", flush=True)
    for res in out.values():
        del res["values"]
    return out


def more_golden_phase(device) -> None:
    """The eleven names on p2p-31 through `run_app` at fnum 1 and 4.
    triangle_count against the LCC golden (lcc d(d - 1) / 2 rounds to
    the count, d the degree with multiplicity); the others against their
    cross-checks: kcore (k 4) = core_decomposition's core >= 4; khop (k 2,
    source 6) = the BFS golden masked to <= 2; kclique (k 3) total =
    triangle_count's global count; bc (source 6) and staged_bc,
    staged_bc_bfs (source 0) by the Brandes identity against the BFS
    golden and a bfs run from 0 (p2p-31 has no vertex 0: nothing is
    reached, every dependency 0); pagerank_local and its alias sum to
    the vertex count; common_neighbors (source CN_SOURCE) by the
    triangle identity against triangle_count there."""
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app

    data = os.path.join(HERE, "dataset")

    def load(name):
        with open(os.path.join(data, name)) as fh:
            return {int(a): float(b) for a, b in
                    (line.split() for line in fh.read().strip().splitlines())}

    lcc_gold, bfs_gold = load("p2p-31-LCC"), load("p2p-31-BFS")
    for fnum in (1, 4):
        def run(app, **flags):
            wk = run_app(QueryArgs(
                application=app, efile=os.path.join(data, "p2p-31.e"),
                vfile=os.path.join(data, "p2p-31.v"), fnum=fnum,
                device=device, **flags))
            frag = wk.fragment
            inner = frag.host_inner_mask()
            vals = wk.result_values()
            by_oid = dict(zip(frag.host_oids[inner].tolist(),
                              vals[inner].tolist()))
            return wk, vals, by_oid

        def ok(app, what):
            print(f"[golden] {app} fnum={fnum} rounds={runs[app][0].rounds}"
                  f" {what} ok", flush=True)

        runs = {}
        runs["triangle_count"] = run("triangle_count")
        wk, vals, tri = runs["triangle_count"]
        deg = wk.fragment.dev.out_degree.cpu().numpy()
        inner = wk.fragment.host_inner_mask()
        d = dict(zip(wk.fragment.host_oids[inner].tolist(),
                     deg[inner].astype(np.int64).tolist()))
        bad = [o for o, t in tri.items()
               if t != np.rint(lcc_gold[o] * d[o] * (d[o] - 1) / 2)]
        check(not bad, f"triangle_count fnum {fnum}: {len(bad)} vertices "
              "off the LCC golden")
        ok("triangle_count", f"lcc golden ({wk.app.global_triangles} "
           "triangles)")
        runs["kclique"] = run("kclique")
        check(runs["kclique"][0].app.total_cliques
              == wk.app.global_triangles, f"kclique fnum {fnum}: total "
              "differs from triangle_count's")
        ok("kclique", "total = triangle_count")

        runs["core_decomposition"] = run("core_decomposition")
        runs["kcore"] = run("kcore", kcore_k=4)
        core = runs["core_decomposition"][2]
        check(all(v == (core[o] >= 4) for o, v in runs["kcore"][2].items()),
              f"kcore fnum {fnum}: differs from core_decomposition >= 4")
        ok("core_decomposition", "(cross-check of kcore)")
        ok("kcore", "= core_decomposition >= 4")

        runs["khop"] = run("khop", khop_k=2, bfs_source=6)
        check(all(v == (bfs_gold[o] if bfs_gold[o] <= 2 else -1)
                  for o, v in runs["khop"][2].items()),
              f"khop fnum {fnum}: differs from the BFS golden masked")
        ok("khop", "= BFS golden masked to <= 2")

        bfs0 = run("bfs", bfs_source=0)
        for app, flags, depth in (("bc", {"bc_source": 6}, bfs_gold),
                                  ("staged_bc", {}, bfs0[2]),
                                  ("staged_bc_bfs", {}, bfs0[2])):
            runs[app] = wk, vals, by_oid = run(app, **flags)
            source = flags.get("bc_source", 0)
            oids = [o for o in by_oid if o != source]
            got = float(sum(by_oid[o] for o in oids))
            reach = [depth[o] for o in oids if 1 <= depth[o] < 2**62]
            want = float(sum(x - 1 for x in reach))
            check(abs(got - want) <= 1e-4 * max(want, 1.0),
                  f"{app} fnum {fnum}: sum of dependencies {got} != {want}")
            ok(app, f"Brandes identity ({got:.6e} = {want:.6e})")

        for app in ("pagerank_local", "pagerank_local_parallel"):
            runs[app] = run(app)
            mass = float(sum(runs[app][2].values()))
            n = len(runs[app][2])
            check(abs(mass - n) <= 1e-4 * n,
                  f"{app} fnum {fnum}: mass {mass} != {n}")
            ok(app, f"mass {mass:.4f} = {n} vertices")

        wk, vals, _ = runs["common_neighbors"] = run("common_neighbors",
                                                     cn_source=CN_SOURCE)
        frag = wk.fragment
        src = int(frag.oid_to_pid(np.array([CN_SOURCE]))[0])
        tri_src = int(runs["triangle_count"][1].reshape(-1)[src])
        check(tri_src > 0 and cn_identity_ok(frag, src, vals, tri_src),
              f"common_neighbors fnum {fnum}: the triangle identity fails")
        ok("common_neighbors",
           f"triangle identity (T({CN_SOURCE}) = {tri_src})")
        check(len(runs) == 11, f"{len(runs)} of the 11 names ran")


def host_syncs(frag, app_factory, device, kw) -> int:
    """Host synchronisations inside one `Worker.query`."""
    from libgrape_lite_tpu_torch.worker.worker import Worker

    return call_syncs(lambda: Worker(app_factory(), frag).query(**kw), device)


def profile_phase(label, frag, app_factory, device, kw) -> dict:
    """Where the time goes in one query: device time by kernel from
    torch.profiler, against the query's wall clock.  Every profiled app
    has run before (its phase's warm-up), so nothing is compiled or
    built here."""
    return profile_call(
        f"{label} query",
        lambda: run_query(frag, app_factory(), device, **kw)[1])


PROFILE_PAD_S = 0.05  # host time kept around `fn` inside the profiled step
PROFILE_ATTEMPTS = 5  # profiled runs of `fn` until one trace is complete


def profile_once(fn, pad_s: float):
    """One torch.profiler step over `fn()`: (wall s, {kernel name: (us,
    count)}, the wrapper launches the counters saw, lead_ms, tail_ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "clears events"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.append(
                         list(p.events()))) as prof:
            warm = torch.zeros(1 << 16, device="cuda")
            for _ in range(32):
                warm.add_(1)
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(pad_s)
            before = launch_counts()
            secs = fn()
            after = launch_counts()
            time.sleep(pad_s)
            prof.step()
    check(len(kept) == 1, f"[profile] {len(kept)} kept steps")
    by_name, spans, step = {}, [], None
    for ev in kept[0]:
        if ev.name.startswith("ProfilerStep"):
            # the step's range, on the host and as a device annotation
            if ev.device_type == torch.autograd.DeviceType.CPU:
                step = ev.time_range
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            t, c = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (t + ev.time_range.elapsed_us(), c + 1)
            spans.append(ev.time_range)
    lead_ms = tail_ms = None
    if step is not None and spans:
        lead_ms = (min(r.start for r in spans) - step.start) / 1e3
        tail_ms = (step.end - max(r.end for r in spans)) / 1e3
    launched = {k: after[k] - before[k] for k in after}
    return secs, by_name, launched, lead_ms, tail_ms


def trace_passes(by_name, launched) -> dict:
    """{pass: (events in the trace, events the launches make)} for the
    spmv kernels, whose wrappers launch a fixed set of passes a call."""
    k1 = launched["gather_reduce"] + launched["gather_reduce_lanes"]
    want = {"merge_partition": k1, "merge_gather": k1,
            "carry_fold": k1 + launched["strict_tile"],
            "strict_segments": launched["strict_tile"],
            "overlay_fold": launched["overlay_fold"]}
    return {p: (sum(c for name, (_, c) in by_name.items() if p in name), n)
            for p, n in want.items()}


def profile_call(label, fn, pad_s: float = PROFILE_PAD_S) -> dict:
    """torch.profiler over `fn()`, which returns its own wall seconds.
    A trace can miss kernels: the profiler drops one whose device
    timestamps, put on the host clock, fall outside the profiled window
    (a BFS trace whose first kernel sat 0.37 ms before the window held 3
    of its 6 K1 calls), so a warm-up step goes first and the kept step
    holds `pad_s` of host time before and after `fn`; and late in a long
    process traces lost kernels inside the window as well (sssp_vc 6 of
    8 K1 calls, 50 ms from either edge).  A trace is complete when it
    holds every pass of every spmv launch the counters saw; `fn` runs up
    to PROFILE_ATTEMPTS times for one, and if none is, no idle share is
    given.  `lead_ms` and `tail_ms` are the gaps between the step's
    edges and its first and last device events."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        secs, by_name, launched, lead_ms, tail_ms = profile_once(fn, pad_s)
        passes = trace_passes(by_name, launched)
        complete = all(seen == want for seen, want in passes.values())
        if complete:
            break
    k1 = launched["gather_reduce"] + launched["gather_reduce_lanes"]
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    wall_ms = secs * 1e3
    idle = 1 - busy_ms / wall_ms if complete else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    missing = {p: f"{seen}/{want}" for p, (seen, want) in passes.items()
               if seen != want}
    print(f"[profile] {label}: wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} idle_share={share_text(idle)} "
          f"kernels={len(by_name)} k1_launches={k1} trace "
          + ("complete" if complete else f"INCOMPLETE {missing}")
          + f" attempts={attempt} lead_ms={lead_ms} tail_ms={tail_ms} "
          f"pad_s={pad_s}", flush=True)
    for name, (t, c) in top:
        print(f"[profile]   {t / 1e3:9.3f} ms  x{c:<5d} {name[:90]}",
              flush=True)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=idle,
                trace_complete=complete, attempts=attempt, k1_launches=k1,
                lead_ms=lead_ms, tail_ms=tail_ms,
                top=[(n[:90], t / 1e3, c) for n, (t, c) in top])


def share_text(share) -> str:
    return "not measured" if share is None else f"{share:.3f}"


def profile_phases(frag, frag18, device) -> None:
    from libgrape_lite_tpu_torch.models import (
        APP_REGISTRY, BFS, CDLP, LCC, LCCBeta, PageRank,
    )

    profile_phase("pagerank auto", frag, PageRank, device,
                  {"delta": 0.85, "max_round": PR_ROUNDS})
    profile_phase("pagerank strict", frag,
                  lambda: PageRank(spmv_mode="strict"), device,
                  {"delta": 0.85, "max_round": PR_ROUNDS})
    profile_phase("bfs", frag, BFS, device, {"source": 0})
    profile_phase("cdlp", frag, CDLP, device, {"max_round": CDLP_ROUNDS})
    profile_phase(f"lcc_bitmap rmat{BITMAP_SCALE}", frag18, LCC, device, {})
    profile_phase("lcc", frag, LCCBeta, device, {})
    r = profile_phase("core_decomposition", frag,
                      APP_REGISTRY["core_decomposition"], device, {})
    rounds = run_query(frag, APP_REGISTRY["core_decomposition"](),
                       device)[0].rounds
    syncs = host_syncs(frag, APP_REGISTRY["core_decomposition"], device, {})
    print(f"[profile]   core_decomposition: rounds={rounds} "
          f"host_syncs={syncs} ({syncs / max(rounds, 1):.2f} per round) "
          f"idle_share={share_text(r['idle_share'])}",
          flush=True)
    for name in ("sssp_delta", "bfs_opt"):
        app = APP_REGISTRY[name]
        r = profile_phase(name, frag, app, device, {"source": 0})
        wk = run_query(frag, app(), device, source=0)[0]
        counters = app_counters(wk.app)
        # an overflow doubles the capacity inside its round: no iteration
        loops = wk.rounds + counters.get("buckets", 0)
        syncs = host_syncs(frag, app, device, {"source": 0})
        print(f"[profile]   {name}: rounds={wk.rounds} "
              + "".join(f"{k}={v} " for k, v in counters.items())
              + f"loop_iterations={loops} host_syncs={syncs} "
              f"({syncs / max(loops, 1):.2f} per iteration) idle_share="
              f"{share_text(r['idle_share'])}", flush=True)


# ---- phase 7: goldens through run_app ----------------------------------

GOLDENS = {"sssp": ("p2p-31-SSSP", {"sssp_source": 6}),
           "bfs": ("p2p-31-BFS", {"bfs_source": 6}),
           "wcc": ("p2p-31-WCC", {}), "pagerank": ("p2p-31-PR", {}),
           "cdlp": ("p2p-31-CDLP", {"cdlp_mr": CDLP_ROUNDS}),
           "lcc": ("p2p-31-LCC", {})}


def result_dict(text: str) -> dict:
    """`oid value` lines -> {oid: value text}."""
    return dict(line.split() for line in text.strip().splitlines())


def check_golden(app: str, got: dict, want: dict, what: str) -> None:
    """`got` against a golden file's `want` by the repo's rules: WCC the
    same partition under some relabelling (wcc_check.cc), PageRank and
    the LCCs 1e-4 relative (eps_check.cc; a zero stays zero), the rest
    exact."""
    check(got.keys() == want.keys(), f"{what}: vertex sets")
    g = np.array([float(want[k]) for k in want])
    r = np.array([float(got[k]) for k in want])
    if app.startswith("wcc"):
        pairs = {(want[k], got[k]) for k in want}
        ok = np.array([len(pairs) == len({w for w, _ in pairs})
                       == len({x for _, x in pairs})])
    elif app.startswith(("pagerank", "lcc")):
        ok = np.where(g == 0, np.abs(r) < 1e-12,
                      np.abs(r - g) <= 1e-4 * np.abs(g))
    else:  # exact
        ok = (r == g) | (np.isinf(r) & np.isinf(g))
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} vertices off the "
          "golden file")


def golden_phase(device, names=None, efile: str = "p2p-31.e",
                 delta_efile: str = "", tag: str = "golden",
                 extra_args: dict | None = None) -> None:
    """`run_app` at fnum 1 and 4 against the p2p-31 goldens, for every
    app name with a golden (or `names`); `delta_efile` loads `efile`
    through LoadGraphAndMutate with that edit file; `extra_args` go to
    every run's QueryArgs."""
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app
    from libgrape_lite_tpu_torch.worker.worker import format_result_lines

    data = os.path.join(HERE, "dataset")

    load = result_dict
    goldens = GOLDENS
    if names is None:
        apps = [(app, *goldens[app.split("_")[0]])
                for app in ("pagerank", "sssp", "bfs", "wcc", "cdlp", "lcc",
                            "lcc_bitmap") + GOLDEN_VARIANTS]
        apps += [(app, "p2p-31-PR-directed", {"directed": True})
                 for app in ("pagerank_directed", "pagerank_auto")]
    else:
        apps = [(app, *goldens[app.split("_")[0]]) for app in names]
    if delta_efile:
        delta_efile = os.path.join(data, delta_efile)
    for app, golden, extra in apps:
        with open(os.path.join(data, golden)) as fh:
            want = load(fh.read())
        for fnum in (1, 4):
            wk = run_app(QueryArgs(
                application=app, efile=os.path.join(data, efile),
                vfile=os.path.join(data, "p2p-31.v"), fnum=fnum,
                device=device, delta_efile=delta_efile, **extra,
                **(extra_args or {})))
            vals = wk.result_values()
            frag = wk.fragment
            got = load("".join(
                format_result_lines(frag.inner_oids(f),
                                    vals[f, :frag.inner_vertices_num(f)],
                                    wk.app.result_format)
                for f in range(frag.fnum)))
            check_golden(app, got, want, f"{app} fnum {fnum}")
            print(f"[{tag}] {app}{' directed' if extra.get('directed') else ''}"
                  f" fnum={fnum} rounds={wk.rounds} ok", flush=True)


# ---- phases 9-11: the load options, the spgemm backend, the sampler -------

def int_text(a: np.ndarray):
    """Right-aligned ASCII digits [n, width] of a non-negative int64 array,
    the unused leading positions 0 (dropped when a line is packed)."""
    a = np.asarray(a, dtype=np.int64)
    width = len(str(int(a.max()))) if len(a) else 1
    out = np.zeros((len(a), width), dtype=np.uint8)
    x = a.copy()
    lens = np.ones(len(a), dtype=np.int64)
    for p in range(1, width):
        lens += a >= 10 ** p
    for j in range(width - 1, -1, -1):
        out[:, j] = 48 + x % 10
        x //= 10
    out[np.arange(width)[None, :] < (width - lens)[:, None]] = 0
    return out


def write_tsv(path: str, fields: list) -> int:
    """Lines of space-separated fields (each an [n, w] uint8 byte matrix,
    0 = no byte), written in one go; returns the file's bytes."""
    n = len(fields[0])
    sep = np.full((n, 1), 32, dtype=np.uint8)
    parts = []
    for f in fields:
        parts += [f, sep]
    parts[-1] = np.full((n, 1), 10, dtype=np.uint8)  # newline
    rows = np.concatenate(parts, axis=1)
    blob = rows[rows != 0].tobytes()
    with open(path, "wb") as fh:
        fh.write(blob)
    return len(blob)


def weight_text(w: np.ndarray) -> np.ndarray:
    """'%.4f' of non-negative weights below 100, as a byte matrix."""
    wi = np.rint(np.asarray(w, dtype=np.float64) * 1e4).astype(np.int64)
    frac = int_text(wi % 10000 + 10000)[:, 1:]  # four digits, zero-padded
    return np.concatenate(
        [int_text(wi // 10000), np.full((len(w), 1), 46, np.uint8), frac],
        axis=1)


def rmat_tsv(scale: int, directory: str):
    """RMAT-`scale` (bench.py's generator, seed 7) with the seed-11
    weights as `src dst w` lines, and the vertex file 0..n-1."""
    n, src, dst = rmat_edges(scale, EDGE_FACTOR)
    w = np.random.default_rng(11).uniform(0.1, 10.0, len(src)).astype(
        np.float32)
    efile = os.path.join(directory, f"rmat{scale}.e")
    vfile = os.path.join(directory, f"rmat{scale}.v")
    nbytes = write_tsv(efile, [int_text(src), int_text(dst), weight_text(w)])
    write_tsv(vfile, [int_text(np.arange(n))])
    return efile, vfile, len(src), nbytes


_SHARED_TSV: dict = {}


def shared_rmat_tsv(scale: int) -> tuple:
    """`rmat_tsv(scale, ...)` written once a run into a temp directory
    removed at exit (the [load] and [dist] phases read the same file):
    (efile, vfile, lines, bytes, seconds the first write took)."""
    if scale not in _SHARED_TSV:
        import atexit
        import shutil
        import tempfile

        d = tempfile.mkdtemp(prefix="grape-rmat-tsv-")
        atexit.register(shutil.rmtree, d, True)
        t0 = time.perf_counter()
        out = rmat_tsv(scale, d)
        _SHARED_TSV[scale] = (*out, time.perf_counter() - t0)
    return _SHARED_TSV[scale]


def query_values(frag, app, device, **kw):
    """(values [fnum, vp] numpy, launch counts, seconds) of one query."""
    reset_launch_counts()
    wk, secs = run_query(frag, app, device, **kw)
    return wk.result_values(), launch_counts(), secs


def by_oid(frag, vals) -> dict:
    inner = frag.host_inner_mask()
    return dict(zip(frag.host_oids[inner].tolist(), vals[inner].tolist()))


def load_phase(device, scale: int = SCALE) -> dict:
    """`LoadGraph` of an RMAT TSV through the native parser, every stage
    timed; the garc cache round trip; `--rebalance` at fnum 4; string ids
    and every partitioner x idxer on p2p-31."""
    import tempfile

    from libgrape_lite_tpu_torch.fragment import loader
    from libgrape_lite_tpu_torch.fragment.partition import PARTITION_STATS
    from libgrape_lite_tpu_torch.io import line_parser, native
    from libgrape_lite_tpu_torch.models import SSSP, PageRank
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app

    out = {"counts": dict.fromkeys(launch_counts(), 0)}

    def add(counts):
        for k, v in counts.items():
            out["counts"][k] += v

    with tempfile.TemporaryDirectory() as tmp:
        efile, vfile, edges, nbytes, tsv_s = shared_rmat_tsv(scale)
        print(f"[load] rmat{scale} tsv: {edges} lines, {nbytes} bytes, "
              f"written in {tsv_s:.2f} s", flush=True)
        check(native.available(),
              f"native loader did not build: {native.UNAVAILABLE_REASON}")
        spec = loader.LoadGraphSpec(serialize=True,
                                    serialization_prefix=os.path.join(
                                        tmp, "garc"))
        before = dict(line_parser.PARSE_COUNTS)
        fresh = loader.LoadGraph(efile, vfile, CommSpec(1, device), spec)
        stages = dict(loader.LOAD_SECONDS)
        check(line_parser.PARSE_COUNTS["native"] == before["native"] + 2
              and line_parser.PARSE_COUNTS["numpy"] == before["numpy"],
              f"the native parser did not parse the load: "
              f"{line_parser.PARSE_COUNTS}")
        cache, _ = loader._cache_dir(efile, vfile, spec, 1)
        garc = os.path.getsize(os.path.join(cache, "frag.garc"))
        spec.serialize, spec.deserialize = False, True
        cached = loader.LoadGraph(efile, vfile, CommSpec(1, device), spec)
        stages["deserialize"] = loader.LOAD_SECONDS["deserialize"]
        print("[load] parser native; host seconds: " + " ".join(
            f"{k}={v:.3f}" for k, v in stages.items())
            + f"; garc {garc} bytes ({garc / nbytes:.3f} of the tsv); "
            f"vp={fresh.vp} ep={fresh.dev.oe.edge_nbr.shape[1]}", flush=True)
        check(fresh.dev.total_enum == edges, "edge count off after load")
        for name, app, kw in (("pagerank", PageRank,
                               {"delta": 0.85, "max_round": PR_ROUNDS}),
                              ("sssp", SSSP, {"source": 0})):
            a, counts, secs_a = query_values(fresh, app(), device, **kw)
            add(counts)
            b, counts, secs_b = query_values(cached, app(), device, **kw)
            add(counts)
            check(counts["gather_reduce"] > 0,
                  f"{name} on the deserialized fragment launched no K1")
            check(np.array_equal(a, b, equal_nan=True),
                  f"{name}: deserialized fragment differs from the load")
            print(f"[load] {name} on deserialized == fresh load: bit-equal "
                  f"(query s {secs_a:.4f} / {secs_b:.4f}; K1 launches "
                  f"{counts['gather_reduce']})", flush=True)
        out.update(stages=stages, garc_bytes=garc, tsv_bytes=nbytes)
        del cached

        # --rebalance at fnum 4 (an RMAT-REBALANCE_SCALE TSV): skew before
        # and after, the same SSSP by oid as the fnum 1 load of the same
        # file
        del fresh
        efile_r, vfile_r, _, _ = rmat_tsv(REBALANCE_SCALE, tmp)
        one = loader.LoadGraph(efile_r, vfile_r, CommSpec(1, device),
                               loader.LoadGraphSpec())
        vals1, counts, _ = query_values(one, SSSP(), device, source=0)
        add(counts)
        fresh_sssp = by_oid(one, vals1)
        del one
        PARTITION_STATS.pop("rebalance", None)
        t0 = time.perf_counter()
        frag4 = loader.LoadGraph(efile_r, vfile_r, CommSpec(4, device),
                                 loader.LoadGraphSpec(rebalance=True))
        load_s = time.perf_counter() - t0
        vals, counts, secs = query_values(frag4, SSSP(), device, source=0)
        add(counts)
        print(f"[load] rmat{REBALANCE_SCALE} fnum 4 rebalance=True: load s "
              f"{load_s:.2f} ep={frag4.dev.oe.edge_nbr.shape[1]} sssp s "
              f"{secs:.4f}", flush=True)
        st = PARTITION_STATS["rebalance"]
        print(f"[load] PARTITION_STATS rebalance: {json.dumps(st)}",
              flush=True)
        check(st["after"]["skew"] < st["before"]["skew"],
              "rebalance did not lower the skew")
        out["rebalance"] = st
        check(by_oid(frag4, vals) == fresh_sssp,
              "SSSP by oid differs with --rebalance at fnum 4")
        print(f"[load] rmat{REBALANCE_SCALE} sssp by oid with --rebalance "
              "at fnum 4 == the fnum 1 load: equal", flush=True)
        del frag4

        # p2p-31: string ids, and every partitioner x idxer at fnum 4
        data = os.path.join(HERE, "dataset")
        pe, pv = os.path.join(data, "p2p-31.e"), os.path.join(data,
                                                              "p2p-31.v")
        for app, extra in (("sssp", {"sssp_source": "6"}), ("wcc", {}),
                           ("cdlp", {"cdlp_mr": CDLP_ROUNDS})):
            texts = []
            for string_id in (False, True):
                prefix = os.path.join(tmp, f"{app}-{string_id}")
                wk = run_app(QueryArgs(
                    application=app, efile=pe, vfile=pv, fnum=4,
                    device=device, out_prefix=prefix, string_id=string_id,
                    **extra))
                check(wk.fragment.is_string_keyed() == string_id,
                      "string_id did not key the graph by strings")
                texts.append([open(os.path.join(prefix, f"result_frag_{f}"))
                              .read() for f in range(4)])
            check(texts[0] == texts[1],
                  f"{app}: --string_id output differs from the int load")
            print(f"[load] p2p-31 {app} --string_id == int load "
                  "(files identical)", flush=True)
        with open(os.path.join(data, "p2p-31-SSSP")) as fh:
            golden = {int(k): float(v) for k, v in  # float("infinity")
                      (line.split() for line in fh if line.strip())}
        for part in ("hash", "map", "segment"):
            for idx in ("hashmap", "sorted_array", "pthash", "local"):
                wk = run_app(QueryArgs(
                    application="sssp", efile=pe, vfile=pv, fnum=4,
                    device=device, sssp_source=6, partitioner_type=part,
                    idxer_type=idx))
                check(by_oid(wk.fragment, wk.result_values()) == golden,
                      f"sssp {part} x {idx} fnum 4 off the golden")
        print("[load] p2p-31 sssp golden: every partitioner x idxer at "
              "fnum 4 ok", flush=True)
    return out


def spgemm_phase(frag, device, scale: int = BITMAP_SCALE) -> dict:
    """`lcc_bitmap` and `triangle_count` under GRAPE_LCC_BACKEND=spgemm
    against the intersect backend (K3) on the same fragment; the plan's
    host seconds and geometry, the credit pass's device time and what
    `auto` decides."""
    from libgrape_lite_tpu_torch.models import LCC, TriangleCount
    from libgrape_lite_tpu_torch.ops import spgemm_pack as sp

    from libgrape_lite_tpu_torch.utils.timing import time_ms

    out = {"counts": dict.fromkeys(launch_counts(), 0)}
    t0 = time.perf_counter()
    disp = sp.resolve_spgemm_dispatch(frag)  # memoized: the queries reuse it
    plan_s = time.perf_counter() - t0
    plan = disp.plan
    st = plan.stats
    bm_bytes = int(plan.host_streams["bm"].nbytes)
    print(f"[spgemm] rmat{scale}: plan host s {plan_s:.2f} items={plan.items} "
          f"items/edge={st['items_per_edge']} mask_edges={plan.mask_edges} "
          f"n_ktiles={plan.n_ktiles} words={plan.words} rows={st['rowspace']} "
          f"bitmap bytes={bm_bytes} "
          f"p_pad={plan.p_pad}", flush=True)
    streams = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in disp.state_entries().items()}
    sync(device)

    # device ms of the credit pass (host-clock ms in a CPU rehearsal)
    credit_ms = time_ms(lambda: disp.credits(streams), device, samples=3,
                        batch=1, warmup=1)
    del streams
    results = {}
    for backend in ("intersect", "spgemm"):
        os.environ["GRAPE_LCC_BACKEND"] = backend
        try:
            for name, app in (("triangle_count", TriangleCount),
                              ("lcc_bitmap", LCC)):
                vals, counts, secs = query_values(frag, app(), device)
                _, _, secs2 = query_values(frag, app(), device)
                for k, v in counts.items():
                    out["counts"][k] += v
                results[backend, name] = (vals, min(secs, secs2), counts)
            tri = results[backend, "triangle_count"][0]
            print(f"[spgemm] {backend}: triangle_count s "
                  f"{results[backend, 'triangle_count'][1]:.4f} lcc_bitmap s "
                  f"{results[backend, 'lcc_bitmap'][1]:.4f} "
                  f"triangles={int(tri[frag.host_inner_mask()].sum() // 3)} "
                  f"launches {results[backend, 'lcc_bitmap'][2]}", flush=True)
        finally:
            os.environ.pop("GRAPE_LCC_BACKEND", None)
    check(results["intersect", "triangle_count"][2]["intersect"] > 0,
          "the intersect backend did not launch K3")
    for name in ("triangle_count", "lcc_bitmap"):
        check(np.array_equal(results["spgemm", name][0],
                             results["intersect", name][0]),
              f"{name}: spgemm differs from the intersect backend (K3)")
    print("[spgemm] per-vertex triangle counts and lcc: spgemm == intersect "
          "(K3), bit-equal", flush=True)
    os.environ["GRAPE_LCC_BACKEND"] = "auto"
    try:
        app = TriangleCount()
        query_values(frag, app, device)
    finally:
        os.environ.pop("GRAPE_LCC_BACKEND", None)
    dec = sp.SPGEMM_STATS["decisions"][-1]
    measured = {b: results[b, "triangle_count"][1]
                for b in ("intersect", "spgemm")}
    print(f"[spgemm] auto -> {dec['backend']}: modeled spgemm "
          f"{dec['t_spgemm_s']:.6f} s / intersect {dec['t_intersect_s']:.6f} s"
          f" ({dec['profile']}); measured query spgemm "
          f"{measured['spgemm']:.4f} s / intersect {measured['intersect']:.4f}"
          f" s; credit pass {credit_ms} ms", flush=True)
    check(dec["mode"] == "auto" and dec["backend"] == app.lcc_backend,
          "auto's decision was not recorded")
    out.update(plan_s=plan_s, items=plan.items,
               items_per_edge=st["items_per_edge"], bitmap_bytes=bm_bytes,
               credit_ms=credit_ms, query_s=measured,
               lcc_bitmap_s={b: results[b, "lcc_bitmap"][1]
                             for b in ("intersect", "spgemm")},
               auto=dec)
    return out


def calibrate_cli(args, device) -> tuple:
    """`python -m libgrape_lite_tpu_torch.cli calibrate <args> --json` in a
    child process: (exit code, its JSON record or None, its stderr)."""
    r = subprocess.run(
        [sys.executable, "-m", "libgrape_lite_tpu_torch.cli", "calibrate",
         *args, "--device", str(device), "--json"], cwd=HERE,
        capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    return r.returncode, json.loads(lines[-1]) if lines else None, r.stderr


def drift_text(surfaces: dict) -> str:
    return " ".join(f"{k}={e['drift_pct']:g}%" for k, e in
                    sorted(surfaces.items()))


def calib_harvest_phase(frag, prof, device) -> dict:
    """GRAPE_CALIBRATE_HARVEST=1 over a warm serving session on RMAT-20:
    4 sssp and 2 bfs queries one at a time, then 8 sssp sources in one
    batch; the harvested samples and their drift under `prof`."""
    from libgrape_lite_tpu_torch.ops import calibration as calib
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    src = serve_sources(frag, SERVE_BATCH)
    singles = [("sssp", {"source": s}) for s in src[:4]]
    singles += [("bfs", {"source": s}) for s in src[4:6]]
    batch = [("sssp", {"source": s}) for s in src]
    sessions = [(ServeSession(frag, policy=BatchPolicy(max_batch=1)),
                 singles),
                (ServeSession(frag, policy=BatchPolicy(max_batch=SERVE_BATCH)),
                 batch)]
    for sess, stream in sessions:  # warm: workers built, pools cached
        sess.serve(stream)
    calib.reset_harvest()
    os.environ[calib.HARVEST_ENV] = "1"
    try:
        reset_launch_counts()
        for sess, stream in sessions:
            res = sess.serve(stream)
            check(all(r.ok for r in res), "a harvested query failed")
        counts = launch_counts()
        got = calib.harvested_samples()
    finally:
        os.environ.pop(calib.HARVEST_ENV, None)
        calib.reset_harvest()
    check(len(got) == len(singles) + 1,
          f"harvested {len(got)} samples of {len(singles) + 1} dispatches")
    rep = calib.drift_report(prof, got)
    return dict(counts=counts, harvested=len(got), drift_pct=rep["drift_pct"],
                walls_ms=[round(s["wall_s"] * 1e3, 4) for s in got],
                modeled_ms=[round(prof.wall_s(s) * 1e3, 4) for s in got])


def calib_phase(frag, frag18, spgemm, device) -> dict:
    """The rate profile on the card: fit, gates, second sweep, harvest,
    `query_wall_s` against measured walls and the consumers under the
    fitted profile.  A CalibrationError raised here ends the run."""
    import tempfile

    from libgrape_lite_tpu_torch.autopilot.admission import (
        AdmissionConfig,
        AdmissionController,
        query_wall_s,
    )
    from libgrape_lite_tpu_torch.autopilot.signals import AUTOPILOT_STATS
    from libgrape_lite_tpu_torch.fragment.partition import resolve_partition
    from libgrape_lite_tpu_torch.models import SSSP, PageRank
    from libgrape_lite_tpu_torch.obs.slo import SLO_STATS
    from libgrape_lite_tpu_torch.ops import calibration as calib
    from libgrape_lite_tpu_torch.ops import spgemm_pack as sp

    t_phase = time.perf_counter()
    out = {}
    sweep = ["--scales", CALIB_SCALES, "--ef", CALIB_EFS, "--repeats",
             str(CALIB_REPEATS)]
    torch.cuda.empty_cache()  # room for the child's sweep
    with tempfile.TemporaryDirectory() as tmp:
        rates = os.path.join(tmp, "rates.json")
        samples = os.path.join(tmp, "samples.json")
        t0 = time.perf_counter()
        rc, rec, err = calibrate_cli(sweep + [
            "--seed", str(CALIB_SEEDS[0]), "--out", rates,
            "--samples-out", samples], device)
        fit_s = time.perf_counter() - t0
        check(rc == 0 and rec is not None,
              f"calibrate exited {rc}: {err[-3000:]}")
        blk = rec["calibration"]
        print(f"[calib] fit ({fit_s:.1f} s, child process): "
              f"{blk['profile']} source={blk['source']} "
              f"samples={blk['samples']} regressors={'+'.join(blk['regressors'])}"
              f" cond={blk['cond']:.4g} residual={blk['residual_pct']:g}% "
              f"drift={blk['drift_pct']:g}% unfitted={blk['unfitted']}",
              flush=True)
        r = blk["rates"]
        print(f"[calib] rates: ops_per_s={r['ops_per_s']:.6g} "
              f"gather_per_s={r['gather_per_s']:.6g} hbm_bps={r['hbm_bps']:.6g}"
              f" dispatch_overhead_s={r['dispatch_overhead_s']:.6g} "
              f"hbm_capacity_bytes={r['hbm_capacity_bytes']}", flush=True)
        for note in blk["fallback_notes"]:
            print(f"[calib]   refused step: {note}", flush=True)
        print(f"[calib] drift per surface: {drift_text(blk['surfaces'])}; "
              f"held out: {drift_text(blk['held_out'])}", flush=True)
        check(blk["fitted"] and blk["drift_ok"], "the fit failed its gate")

        rc, rec, err = calibrate_cli(["--check", "--samples", samples,
                                      "--profile", rates], device)
        check(rc == 0, f"--check on the recorded samples exited {rc}: "
              f"{err[-2000:]}")
        d = json.load(open(rates))
        bad = os.path.join(tmp, "rates_bad.json")
        d["ops_per_s"] /= CALIB_OPS_SLOWDOWN
        with open(bad, "w") as f:
            json.dump(d, f)
        rc_bad, rec_bad, _ = calibrate_cli(["--check", "--samples", samples,
                                            "--profile", bad], device)
        check(rc_bad == 2 and not rec_bad["calibration"]["drift_ok"],
              f"the corrupted profile exited {rc_bad}")
        d["ops_per_s"] = True
        with open(bad, "w") as f:
            json.dump(d, f)
        rc_broken, _, err = calibrate_cli(["--check", "--samples", samples,
                                           "--profile", bad], device)
        check(rc_broken == 2 and "bool" in err,
              f"the schema-broken profile exited {rc_broken}")
        print(f"[calib] --check recorded samples: exit 0; ops_per_s / "
              f"{CALIB_OPS_SLOWDOWN:g}: exit 2 (drift "
              f"{rec_bad['calibration']['drift_pct']:g}%); a bool rate: "
              "exit 2", flush=True)

        t0 = time.perf_counter()
        rc2, rec2, err = calibrate_cli(sweep + [
            "--check", "--profile", rates, "--seed", str(CALIB_SEEDS[1])],
            device)
        check(rec2 is not None, f"the second sweep printed nothing: "
              f"{err[-2000:]}")
        blk2 = rec2["calibration"]
        print(f"[calib] second sweep (seed {CALIB_SEEDS[1]}, "
              f"{time.perf_counter() - t0:.1f} s) under the fitted profile: "
              f"exit {rc2}, drift {blk2['drift_pct']:g}% "
              f"({drift_text(blk2['surfaces'])}; held out: "
              f"{drift_text(blk2['held_out'])})", flush=True)

        prof = calib.load_profile(rates)
        harvest = calib_harvest_phase(frag, prof, device)
        print(f"[calib] harvest: {harvest['harvested']} samples from a "
              f"serving session, drift {harvest['drift_pct']:g}% under the "
              f"fitted profile; walls ms {harvest['walls_ms']} modeled "
              f"{harvest['modeled_ms']} launches {harvest['counts']}",
              flush=True)

        priced = {}
        for name, factory, kw, weighted in (
                ("sssp", SSSP, {"source": 0}, True),
                ("pagerank", PageRank, {"delta": 0.85,
                                        "max_round": PR_ROUNDS}, False)):
            wk, counts, secs = counted(frag, factory, device, kw)
            priced[name] = dict(
                counts=counts, rounds=wk.rounds, measured_s=secs,
                fitted_s=query_wall_s(frag, wk.rounds, profile=prof,
                                      weighted=weighted),
                datasheet_s=query_wall_s(frag, wk.rounds,
                                         profile=calib.default_profile(),
                                         weighted=weighted))
            q = priced[name]
            print(f"[calib] query_wall_s {name} RMAT-20 ({wk.rounds} rounds):"
                  f" fitted {q['fitted_s']:.6f} s, data sheet "
                  f"{q['datasheet_s']:.6f} s, measured {secs:.6f} s "
                  f"(x{secs / q['fitted_s']:.3f} the fitted price)",
                  flush=True)

        burn = SLO_STATS.get("burn_by_key")
        os.environ[calib.PROFILE_ENV] = rates
        os.environ["GRAPE_LCC_BACKEND"] = "auto"
        try:
            app = sp.resolve_lcc_backend("triangle_count", frag18)
            dec = sp.SPGEMM_STATS["decisions"][-1]
            check(dec["profile"] == prof.label() and dec["backend"] == app,
                  "spgemm auto did not record the fitted profile")
            q = spgemm["query_s"]
            print(f"[calib] spgemm auto rmat{BITMAP_SCALE} under "
                  f"{dec['profile']}: {dec['backend']} (modeled spgemm "
                  f"{dec['t_spgemm_s']:.6f} s / intersect "
                  f"{dec['t_intersect_s']:.6f} s; data sheet: "
                  f"{spgemm['auto']['backend']}); measured triangle_count "
                  f"spgemm {q['spgemm']:.4f} s / intersect "
                  f"{q['intersect']:.4f} s", flush=True)
            src, dst = frag.edge_list[0], frag.edge_list[1]
            part = resolve_partition("sssp", 4, src, dst,
                                     np.arange(frag.dev.total_vnum),
                                     mode="auto")
            check(part["profile"] == prof.label(),
                  "the partition record does not carry the fitted label")
            c1, c2 = part["costs"]["1d"], part["costs"]["2d"]
            print(f"[calib] partition auto sssp RMAT-20 fnum 4 under "
                  f"{part['profile']}: engaged={part['engaged']} 1-D "
                  f"compute {c1.get('t_compute_s', 0):.4e} s, "
                  f"{c1['exchange_bytes']} exchange B; 2-D "
                  f"{c2.get('t_compute_s', 0):.4e} s, "
                  f"{c2['exchange_bytes']} B; reason: "
                  f"{part.get('reason', 'both terms win')}", flush=True)
            wall = query_wall_s(frag)
            SLO_STATS["burn_by_key"] = {**(burn or {}), "tenant:calib": 1.5}
            ctl = AdmissionController(
                config=AdmissionConfig(max_cost_s=wall / 2), fragment=frag)
            req = type("Req", (), {"tenant": "calib", "app_key": "sssp",
                                   "max_rounds": None})()
            verdict = ctl.review(req)
            adm = AUTOPILOT_STATS["decisions"][-1]
            check(verdict == "shed" and adm["profile"] == prof.label(),
                  "the admission record does not carry the fitted label")
            print(f"[calib] admission under {adm['profile']}: query_wall_s "
                  f"{wall:.6f} s (16 rounds); a tenant at burn 1.5 with "
                  f"max_cost_s {wall / 2:.6f}: {verdict}", flush=True)
        finally:
            os.environ.pop(calib.PROFILE_ENV, None)
            os.environ.pop("GRAPE_LCC_BACKEND", None)
            SLO_STATS["burn_by_key"] = burn
    counts = dict.fromkeys(launch_counts(), 0)
    for rec_ in [harvest] + list(priced.values()):
        for k, v in rec_["counts"].items():
            counts[k] += v
    out.update(
        counts=counts, seconds=time.perf_counter() - t_phase, fit=blk,
        second_sweep=dict(exit=rc2, drift_pct=blk2["drift_pct"],
                          surfaces=blk2["surfaces"], held_out=blk2["held_out"]),
        harvest={k: v for k, v in harvest.items() if k != "counts"},
        query_wall={k: {f: x for f, x in v.items() if f != "counts"}
                    for k, v in priced.items()},
        spgemm_auto=dec, partition={k: part.get(k) for k in (
            "engaged", "reason", "costs", "profile")},
        admission=adm)
    print(f"[time] calib {out['seconds']:.1f} s", flush=True)
    return out


def sampler_checks(frag, seeds, hops, fanouts, weighted_pick: bool):
    """On the device: every pick that is not -1 is a neighbour of its
    parent, never more often in one sample group than the row holds it
    (a weighted pick takes each CSR slot at most once), and a parent
    without neighbours (the isolated seeds among them) gives -1."""
    indptr, nbr, _ = frag.device_csr()
    n = indptr.numel() - 1
    dev = nbr.device
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (indptr[1:] - indptr[:-1]).long())
    keys = src * n + nbr.long()  # sorted: rows by src, nbrs ascending
    parents = torch.as_tensor(seeds, device=dev).long()
    for h, k in zip(hops, fanouts):
        par = parents.reshape(-1).repeat_interleave(k)
        pick = h.reshape(-1).long()
        ok = pick >= 0
        live = par < n
        deg = torch.zeros_like(par)
        deg[live] = (indptr[par[live] + 1] - indptr[par[live]]).long()
        check(bool((pick[deg == 0] == -1).all()),
              "a parent without neighbours gave a sample")
        q = par[ok] * n + pick[ok]
        lo = torch.searchsorted(keys, q)
        hi = torch.searchsorted(keys, q, right=True)
        check(bool((hi > lo).all()), "a sample is not a neighbour of its "
              "parent")
        if weighted_pick:
            group = torch.arange(par.numel(), device=dev) // k
            gkey = torch.stack([group[ok], pick[ok]], 1)
            _, inv, cnt = torch.unique(gkey, dim=0, return_inverse=True,
                                       return_counts=True)
            check(bool((cnt[inv] <= hi - lo).all()),
                  "a weighted pick repeated a CSR slot")
        parents = torch.where(pick >= 0, pick, n)


class CsrSnapshot:
    """A fixed (indptr, nbr, w) for `GraphSampler`, e.g. a CPU copy."""

    def __init__(self, csr):
        self._csr = csr

    def device_csr(self):
        return self._csr


def sampler_phase(device, scale: int = SCALE, seeds_n: int = 65536,
                  cpu_seeds: int = 4096) -> dict:
    """The GNN sampler on RMAT-`scale` (both directions, as run_sampler
    loads an undirected graph), 4-5 fanouts from `seeds_n` seeds per
    strategy, then a 1% extend and its rebuild."""
    from libgrape_lite_tpu_torch.sampler import (
        AppendOnlyEdgecutFragment,
        GraphSampler,
    )

    fanouts = (4, 5)
    n, src, dst = rmat_edges(scale, EDGE_FACTOR)
    w = np.random.default_rng(11).uniform(0.1, 10.0, len(src)).astype(
        np.float32)
    t0 = time.perf_counter()
    frag = AppendOnlyEdgecutFragment(
        n, np.concatenate([src, dst]), np.concatenate([dst, src]),
        np.concatenate([w, w]), device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(13)
    seeds = rng.integers(0, n, seeds_n)
    indptr = frag.device_csr()[0].cpu().numpy()
    isolated = np.flatnonzero(indptr[1:] == indptr[:-1])[:64]
    seeds[:len(isolated)] = isolated
    print(f"[sampler] rmat{scale}: {frag.num_edges} edge slots, build s "
          f"{build_s:.2f}, {len(isolated)} isolated seeds", flush=True)
    out = {"build_s": build_s}

    def run(tag):
        rates = {}
        for strategy in ("random", "edge_weight", "top_k"):
            sampler = GraphSampler(frag, strategy)
            sampler.sample(seeds[:1024], fanouts, seed=1)  # warm-up
            sync(device)
            t0 = time.perf_counter()
            hops = sampler.sample(seeds, fanouts, seed=5)
            sync(device)
            secs = time.perf_counter() - t0
            again = sampler.sample(seeds, fanouts, seed=5)
            check(all(torch.equal(a, b) for a, b in zip(hops, again)),
                  f"{strategy}: two runs with one seed differ")
            sampler_checks(frag, seeds, hops, fanouts,
                           strategy != "random")
            rates[strategy] = seeds_n / secs
            print(f"[sampler] {tag} {strategy}: {seeds_n} seeds x "
                  f"{'-'.join(map(str, fanouts))} in {secs:.4f} s = "
                  f"{seeds_n / secs:.0f} seeds/s; neighbour, slot and "
                  "isolated-row checks ok; rerun bit-equal", flush=True)
        return rates

    out["rates"] = run("base")
    # top_k on the card == top_k on the CPU (a subset of seeds)
    cpu = CsrSnapshot(tuple(None if t is None else t.cpu()
                            for t in frag.device_csr()))
    sub = seeds[:cpu_seeds]
    got = GraphSampler(frag, "top_k").sample(sub, fanouts)
    want = GraphSampler(cpu, "top_k").sample(sub, fanouts)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
          "top_k on the card differs from the CPU run")
    print(f"[sampler] top_k ({cpu_seeds} seeds): card == cpu, bit-equal",
          flush=True)
    del cpu
    # 1% more edges, both directions, then the rebuild
    m = len(src) // 100
    es, ed = rng.integers(0, n, (2, m))
    t0 = time.perf_counter()
    frag.extend(np.concatenate([es, ed]), np.concatenate([ed, es]),
                np.ones(2 * m, np.float32))
    frag.flush()
    sync(device)
    rebuild_s = time.perf_counter() - t0
    print(f"[sampler] extend +{2 * m} edge slots (1%): extend + rebuild s "
          f"{rebuild_s:.2f}, now {frag.num_edges}", flush=True)
    out["rebuild_s"] = rebuild_s
    out["rates_after_extend"] = run("after extend")
    return out


# ---- phase 11: graph mutation and the dynamic-graph runtime -------------

def dyn_factory(name: str):
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    if name == "khop":
        return lambda: APP_REGISTRY[name](k=DYN_KHOP_K)
    return APP_REGISTRY[name]


def same_values(a, b, what: str) -> None:
    """Bit-equal per-vertex results on the same vertex layout."""
    check(a.fragment.vp == b.fragment.vp and np.array_equal(
        a.fragment.host_oids, b.fragment.host_oids), f"{what}: layouts differ")
    check(np.array_equal(a.result_values(), b.result_values()),
          f"{what}: not bit-equal")


def overlay_planes(ent: dict, device) -> dict:
    """An overlay's ie planes (`DeltaOverlay.entries`) on the device,
    without their prefix: src, nbr, w, mask."""
    return {k.removeprefix("dyn_ie_"): torch.from_numpy(v).to(device)
            for k, v in ent.items()}


def star_planes(fnum: int, vp: int, cap: int, device) -> dict:
    """Every slot of an overlay of `cap` slots in one row (row vp // 2 of
    fragment 0), neighbours and uniform(0.1, 10) weights from seed 19."""
    rng = np.random.default_rng(19)
    src = np.full((fnum, cap), vp, np.int32)
    nbr = np.zeros((fnum, cap), np.int32)
    w = np.zeros((fnum, cap), np.float32)
    mask = np.zeros((fnum, cap), bool)
    src[0], mask[0] = vp // 2, True
    nbr[0] = rng.integers(0, fnum * vp, cap)
    w[0] = rng.uniform(0.1, 10.0, cap)
    return {k: torch.from_numpy(v).to(device) for k, v in dict(
        src=src, nbr=nbr, w=w, mask=mask).items()}


def overlay_csr(pl: dict, vp: int) -> torch.Tensor:
    """The CSR [fnum, vp + 1] of an overlay's sorted `src` plane (each
    fragment's real slots come first, so it indexes the nbr / w planes):
    the former K1 path's view of the overlay."""
    fnum = pl["src"].shape[0]
    fids = torch.arange(fnum, device=pl["src"].device).unsqueeze(1)
    rows = (fids * vp + pl["src"])[pl["mask"]].long()
    deg = torch.bincount(rows, minlength=fnum * vp).view(fnum, vp)
    indptr = torch.zeros((fnum, vp + 1), dtype=torch.int32,
                         device=pl["src"].device)
    indptr[:, 1:] = deg.cumsum(1)
    return indptr


def overlay_fold_case(name, pl, x, relaxed, device, reps: int,
                      plus_one: bool = False, weighted: bool = True,
                      signed_zeros: bool = False) -> dict:
    """One overlay fold case: `overlay_fold` into a copy of `relaxed`
    against its plain version, the former K1 path (`gather_reduce`, or
    the lane form, over the CSR of the sorted `src` plane, built outside
    the timed call, then BFS's hop and `torch.minimum`) and the library
    call (`scatter_reduce_` amin of the real slots' candidates, gathered
    outside the timed call, into a copy of `relaxed`), each bit-equal --
    sign bits of zeros included; with `signed_zeros` the library call's
    match is reported, not required (scatter_reduce_ picks between -0.0
    and +0.0 its own way); then kernel, plain, K1 path, library and
    bound times."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    w = pl["w"] if weighted else None
    args = (pl["src"], pl["nbr"], w, pl["mask"], x)
    fnum, cap = pl["src"].shape
    vp = relaxed.shape[-1]
    lanes = x.shape[0] if x.dim() == 2 else 1
    slots = int(pl["mask"].sum())
    indptr = overlay_csr(pl, vp)

    def kernel(dest=None):
        return spmv.overlay_fold(relaxed.clone() if dest is None else dest,
                                 *args, plus_one)

    def k1_path():
        extra = spmv.pull(indptr, pl["nbr"], w, x, "min")
        if plus_one:
            extra = torch.where(extra != INT32_MAX, extra + 1, extra)
        return torch.minimum(relaxed, extra)

    fids = torch.arange(fnum, device=device).unsqueeze(1).expand_as(pl["nbr"])
    rows = (fids * vp + pl["src"])[pl["mask"]].long()
    cand = x[..., pl["nbr"][pl["mask"]].long()]
    if w is not None:
        cand = cand + w[pl["mask"]]
    if plus_one:
        cand = torch.where(cand != INT32_MAX, cand + 1, cand)
    cand = cand.reshape(lanes, -1)
    rows_l = (rows + torch.arange(lanes, device=device).unsqueeze(1)
              * (fnum * vp)).reshape(-1)

    def library(dest=None):
        dest = relaxed.clone() if dest is None else dest
        dest.view(-1).scatter_reduce_(0, rows_l, cand.reshape(-1), "amin",
                                      include_self=True)
        return dest

    got = kernel()
    sync(device)

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    agree = {}
    for other, what in ((spmv.overlay_fold_plain(relaxed.clone(), *args,
                                                 plus_one), "plain version"),
                        (k1_path(), "former K1 path"),
                        (library(), "library call")):
        agree[what] = torch.equal(bits(got), bits(other))
        # signed zeros: the plain version orders them as the kernel does
        # (-0.0 below +0.0); scatter_reduce_ picks between them its own way
        check(agree[what] or (signed_zeros and what == "library call"),
              f"overlay_fold {name} not bit-equal to its {what}")
    dest = relaxed.clone()
    ms = time_ms(lambda: kernel(dest), device, reps)
    plain_ms = time_ms(lambda: spmv.overlay_fold_plain(dest, *args, plus_one),
                       device, max(3, reps // 4), warmup=1)
    k1_ms = time_ms(k1_path, device, reps)
    lib_ms = time_ms(lambda: library(dest), device, reps)
    # per real slot its src, nbr, (w,) gathered x, and its row read and
    # written; the mask of every slot
    per_slot = 4 + 4 + (4 if w is not None else 0) + 4 * lanes * 3
    b_ms, b_by = bound(slots * per_slot + fnum * cap, lanes * slots * 2)
    print(f"[dyn] overlay_fold {name}: lanes={lanes} rows={fnum * vp} "
          f"slots={slots} capacity={cap} kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} k1_path_ms={k1_ms:.4f} library_ms={lib_ms:.4f} "
          f"(scatter_reduce_ amin) bound_ms={b_ms:.6f} ({b_by}) bit-equal "
          f"to: {', '.join(k for k, v in agree.items() if v)} (one device "
          "pass a call)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, k1_path_ms=k1_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=0.0, slots=slots, rows=fnum * vp, lanes=lanes,
                bit_equal_to=[k for k, v in agree.items() if v])


def overlay_kernel_phase(overlay, device, reps: int) -> dict:
    """The overlay fold (`overlay_fold`) alone at the [dyn] overlay's
    shape (vp rows, its real slots of 4,096; SSSP's min with weights) on
    a pull result with +inf rows; SERVE_BATCH lanes of it; BFS's int32
    hop; a star (all 4,096 slots in one row); and -0.0 -- x, weights and
    the pull result mixing -0.0 and +0.0 on the same rows.  Each through
    `overlay_fold_case` (bit-equal to the plain version, the former K1
    path and `scatter_reduce_`, timed)."""
    pl = overlay_planes(overlay.entries("ie", np.float32), device)
    fnum, vp = overlay.fnum, overlay.vp
    n = fnum * vp
    gen = torch.Generator(device="cpu").manual_seed(3)

    def floats(*shape):
        return torch.where(torch.rand(*shape, generator=gen) < 0.3,
                           torch.tensor(float("inf")),
                           torch.rand(*shape, generator=gen) * 50).to(device)

    out = {}
    out["min+w"] = overlay_fold_case("min+w", pl, floats(n), floats(fnum, vp),
                                     device, reps)
    out[f"k{SERVE_BATCH} min+w"] = overlay_fold_case(
        f"k={SERVE_BATCH} min+w", pl, floats(SERVE_BATCH, n),
        floats(SERVE_BATCH, fnum, vp), device, reps)
    depth = torch.where(torch.rand(n, generator=gen) < 0.3,
                        torch.tensor(INT32_MAX, dtype=torch.int32),
                        torch.randint(0, 64, (n,), generator=gen,
                                      dtype=torch.int32)).to(device)
    pulled = torch.where(depth != INT32_MAX, depth + 1, depth)
    out["int32 min +1"] = overlay_fold_case(
        "int32 min +1 (bfs)", pl, depth, pulled.view(fnum, vp), device, reps,
        plus_one=True, weighted=False)
    star = star_planes(fnum, vp, pl["src"].shape[1], device)
    out["star min+w"] = overlay_fold_case("star min+w", star, floats(n),
                                          floats(fnum, vp), device, reps)
    # -0.0: x and w take +-0.0 (and small values) on the star row and the
    # real slots, the pull result +-0.0 on the folded rows
    signs = lambda *shape: torch.where(torch.rand(*shape, generator=gen)
                                       < 0.5, -0.0, 0.0)
    zpl = dict(pl, w=torch.where(pl["mask"], signs(*pl["w"].shape).to(device),
                                 pl["w"]))
    xz = torch.where(torch.rand(n, generator=gen) < 0.5, signs(n),
                     torch.rand(n, generator=gen)).to(device)
    rz = torch.where(torch.rand(fnum, vp, generator=gen) < 0.5,
                     signs(fnum, vp), torch.tensor(float("inf"))).to(device)
    out["-0.0"] = overlay_fold_case("-0.0", zpl, xz, rz, device, reps,
                                    signed_zeros=True)
    return out


def dyn_rmat_phase(frag, device) -> dict:
    """RMAT-20 (built with its edge list): 2,048 seeded additive edges
    ride the overlay under the default RepackPolicy; the overlay apps
    against a cold query on the repacked graph, the auto apps refused
    then run after fold_now, query_incremental seeded from the base
    results, a non-additive batch falling back cold, and the overlay's
    K1 call alone."""
    from libgrape_lite_tpu_torch.dyn import DynGraph, RepackPolicy
    from libgrape_lite_tpu_torch.worker.worker import Worker

    out = {"runs": {}}
    adds, rng = dyn_adds(frag)

    base = {}
    for name, kw in DYN_APPS:
        base[name] = counted(frag, dyn_factory(name), device, kw)
        out["runs"][f"dyn {name} base"] = dict(counts=base[name][1],
                                               seconds=base[name][2])

    # the reference: the same batch folded into a rebuilt CSR
    t0 = time.perf_counter()
    ref = DynGraph(frag, RepackPolicy(threshold=0.0))
    rep = ref.ingest(adds)
    repack_s = time.perf_counter() - t0
    check(rep["mode"] == "repack", f"threshold 0 gave {rep['mode']}")
    repacked = ref.fragment
    check(repacked.total_edges_num == frag.total_edges_num + DYN_ADDS,
          "the repack lost edges")
    print(f"[dyn] rmat{SCALE}: {DYN_ADDS} adds folded by a repack "
          f"(threshold 0) in {repack_s:.3f} host s", flush=True)
    cold = {name: counted(repacked, dyn_factory(name), device, kw)
            for name, kw in DYN_APPS}

    t0 = time.perf_counter()
    dg = DynGraph(frag, RepackPolicy())
    rep = dg.ingest(adds)
    overlay_s = time.perf_counter() - t0
    check(rep["mode"] == "overlay", f"default policy gave {rep['mode']} "
          f"({rep['reason']}), expected overlay")
    check(dg.fragment is frag and dg.overlay_count == DYN_ADDS,
          "the overlay is not attached to the base fragment")
    overlay = frag.dyn_overlay
    print(f"[dyn] ingest: mode={rep['mode']} delta_ratio="
          f"{rep['delta_ratio']:.6f} reason={rep['reason']!r} overlay "
          f"build {overlay_s:.3f} host s (slots "
          f"{int(frag.dyn_overlay.ie.mask.sum())} of "
          f"{frag.dyn_overlay.capacity})", flush=True)
    for name, kw in DYN_APPS:
        wk, counts, secs = counted(frag, dyn_factory(name), device, kw)
        cwk, _, csecs = cold[name]
        same_values(wk, cwk, f"{name} over the overlay vs the repack")
        check(wk.rounds == cwk.rounds, f"{name}: {wk.rounds} rounds over "
              f"the overlay, {cwk.rounds} on the repack")
        check(counts["gather_reduce"] == wk.rounds
              and counts["overlay_fold"] == wk.rounds,
              f"{name} over the overlay: {counts} in {wk.rounds} rounds "
              "(one K1 and one overlay fold a round expected)")
        bsecs = base[name][2]
        out["runs"][f"dyn {name} overlay"] = dict(
            counts=counts, seconds=secs, rounds=wk.rounds,
            base_seconds=bsecs, repacked_seconds=csecs)
        print(f"[dyn] {name} overlay: rounds={wk.rounds} seconds={secs:.4f}"
              f" (base graph {bsecs:.4f}, repacked {csecs:.4f}) launches="
              f"{counts} bit-equal to the repacked cold query", flush=True)

    for name, kw in DYN_AUTO:
        try:
            Worker(dyn_factory(name)(), frag).query(**kw)
        except ValueError as e:
            check("no dyn-overlay contract" in str(e), f"{name}: {e}")
        else:
            check(False, f"{name} ran over the overlay")

    # incremental IncEval seeded from the base results: over the overlay
    # and over the repacked graph, each against the cold repacked query
    for name, kw in DYN_APPS:
        if name not in DYN_INC:
            continue
        prev = base[name][0]._result_state  # the base graph's fixed point
        for label, g, kws in (("overlay", frag, {}),
                              ("repack", repacked, {"prev_fragment": frag})):
            def inc(g=g, kws=kws):
                wk = Worker(dyn_factory(name)(), g)
                wk.query_incremental(prev, rep["delta"], **kws, **kw)
                return wk
            wk, counts, secs = timed_counted(inc, device)
            cwk, _, csecs = cold[name]
            check(wk.inc_report["mode"] == "seeded",
                  f"{name} incremental over the {label}: {wk.inc_report}")
            same_values(wk, cwk, f"{name} incremental over the {label}")
            out["runs"][f"dyn {name} incremental {label}"] = dict(
                counts=counts, seconds=secs, rounds=wk.rounds,
                cold_rounds=cwk.rounds, cold_seconds=csecs)
            print(f"[dyn] {name} query_incremental over the {label}: "
                  f"seeded rounds={wk.rounds} seconds={secs:.4f} (cold "
                  f"rounds={cwk.rounds} seconds={csecs:.4f}) launches="
                  f"{counts} bit-equal to cold", flush=True)

    t0 = time.perf_counter()
    dg.fold_now()
    fold_s = time.perf_counter() - t0
    check(dg.overlay_count == 0 and dg.fragment is not frag,
          "fold_now left staged edges")
    for name, kw in DYN_AUTO:
        wk, counts, secs = counted(dg.fragment, dyn_factory(name), device,
                                   kw)
        same_values(wk, cold[name.removesuffix("_auto")][0],
                    f"{name} after fold_now")
        check(counts["gather_reduce"] > 0, f"{name}: no K1 launch")
        out["runs"][f"dyn {name} folded"] = dict(counts=counts,
                                                 seconds=secs)
        print(f"[dyn] {name}: refused over the overlay (no dyn-overlay "
              f"contract); after fold_now ({fold_s:.3f} host s) rounds="
              f"{wk.rounds} seconds={secs:.4f} launches={counts} "
              "bit-equal to the repacked cold query", flush=True)

    # a non-additive batch: removals of existing edges force a repack,
    # and the incremental query falls back cold
    e_src, e_dst, _ = frag.edge_list
    pick = rng.choice(len(e_src), DYN_ADDS, replace=False)
    removals = [("d", int(e_src[i]), int(e_dst[i])) for i in pick]
    prev = cold["sssp"][0]._result_state
    t0 = time.perf_counter()
    rep2 = dg.ingest(removals)
    remove_s = time.perf_counter() - t0
    check(rep2["mode"] == "repack" and "non-additive" in rep2["reason"],
          f"removals: {rep2['mode']} ({rep2['reason']})")
    kw = dict(DYN_APPS)["sssp"]
    wk = Worker(dyn_factory("sssp")(), dg.fragment)
    wk.query_incremental(prev, rep2["delta"], prev_fragment=repacked, **kw)
    check(wk.inc_report["mode"] == "cold" and wk.inc_stats["cold"] == 1,
          f"removals: incremental {wk.inc_report}")
    cwk = Worker(dyn_factory("sssp")(), dg.fragment)
    cwk.query(**kw)
    same_values(wk, cwk, "sssp after removals")
    print(f"[dyn] {DYN_ADDS} removals: mode={rep2['mode']} reason="
          f"{rep2['reason']!r} repack {remove_s:.3f} host s; edges "
          f"{dg.fragment.total_edges_num}; sssp query_incremental fell "
          f"back cold ({wk.inc_report['reason']!r}), inc_stats="
          f"{wk.inc_stats}, equal to a cold query", flush=True)

    kern = overlay_kernel_phase(overlay, device, reps=30)
    frag.dyn_overlay = None  # the base fragment leaves the runtime
    out.update(repack_seconds=repack_s, fold_seconds=fold_s,
               remove_seconds=remove_s, overlay_seconds=overlay_s,
               kernel=kern)
    return out


def dyn_grid_phase(grid, device) -> dict:
    """The 512 x 512 grid, where the incremental query pays off: one
    shortcut edge far from the source (from (500, 500) to the far corner
    (511, 511), weight 0.1), repacked, then query_incremental
    for sssp and bfs seeded from the base results, bit-equal to cold."""
    from libgrape_lite_tpu_torch.dyn import DynGraph, RepackPolicy
    from libgrape_lite_tpu_torch.worker.worker import Worker

    side = int(round(grid.dev.total_vnum ** 0.5))
    a, b = side - 1 - DYN_SHORTCUT_SPAN, side - 1
    shortcut = ("a", a * side + a, b * side + b, 0.1)
    out = {"runs": {}}
    prev = {}
    for name in ("sssp", "bfs"):
        wk = Worker(dyn_factory(name)(), grid)
        wk.query(source=0)
        prev[name] = wk._result_state
    dg = DynGraph(grid, RepackPolicy(threshold=0.0))
    t0 = time.perf_counter()
    rep = dg.ingest([shortcut])
    repack_s = time.perf_counter() - t0
    check(rep["mode"] == "repack", f"grid shortcut: {rep['mode']}")
    for name in ("sssp", "bfs"):
        def inc(name=name):
            wk = Worker(dyn_factory(name)(), dg.fragment)
            wk.query_incremental(prev[name], rep["delta"],
                                 prev_fragment=grid, source=0)
            return wk

        wk, counts, secs = timed_counted(inc, device)
        cwk, _, csecs = counted(dg.fragment, dyn_factory(name), device,
                                {"source": 0})
        check(wk.inc_report["mode"] == "seeded", f"grid {name}: "
              f"{wk.inc_report}")
        same_values(wk, cwk, f"grid {name} incremental")
        check(wk.rounds < cwk.rounds, f"grid {name}: seeded {wk.rounds} "
              f"rounds, cold {cwk.rounds}")
        out["runs"][f"dyn grid {name} incremental"] = dict(
            counts=counts, seconds=secs, rounds=wk.rounds,
            cold_rounds=cwk.rounds, cold_seconds=csecs)
        print(f"[dyn] grid{side} {name} query_incremental after the "
              f"shortcut {shortcut[1]}-{shortcut[2]}: seeded rounds="
              f"{wk.rounds} seconds={secs:.4f} (cold rounds={cwk.rounds} "
              f"seconds={csecs:.4f}) launches={counts} bit-equal to cold; "
              f"repack {repack_s:.3f} host s", flush=True)
    grid.dyn_overlay = None
    out["repack_seconds"] = repack_s
    return out


def mutation_context_phase(device) -> dict:
    """tests/test_mutation_context.py's app on the card: SSSP over the
    chain 0-1-...-9 adds vertex 100 and the edges 0-100, 100-9 (0.5 each)
    after round 2; the worker rebuilds the fragment between rounds."""
    from libgrape_lite_tpu_torch.fragment.mutation import (
        BasicFragmentMutator,
    )
    from libgrape_lite_tpu_torch.models import SSSP

    class SSSPWithShortcut(SSSP):
        fired = False

        def collect_mutations(self, frag, host_state, rounds):
            if self.fired or rounds != 2:
                return None
            self.fired = True
            m = BasicFragmentMutator()
            m.AddVertex(100)
            m.AddEdge(0, 100, 0.5)
            m.AddEdge(100, 9, 0.5)
            return m

    frag = chain_fragment(10, 2, device)
    reset_launch_counts()
    wk, _ = run_query(frag, SSSPWithShortcut(), device, source=0)
    counts = launch_counts()
    got = by_oid(wk.fragment, wk.result_values())
    check(wk.fragment is not frag and wk.fragment.device == frag.device,
          "MutationContext: the fragment was not rebuilt on its device")
    check(got[9] == 1.0 and got[100] == 0.5 and got[5] == 5.0,
          f"MutationContext shortcut: {got}")
    check(counts["gather_reduce"] == wk.rounds, "MutationContext: "
          f"{counts['gather_reduce']} K1 launches in {wk.rounds} rounds")
    print(f"[dyn] MutationContext shortcut sssp on the chain (fnum 2): "
          f"rounds={wk.rounds} dist(9)={got[9]} dist(100)={got[100]} "
          f"dist(5)={got[5]} launches={counts}", flush=True)
    return {"counts": counts, "rounds": wk.rounds}


def chain_fragment(n: int, fnum: int, device):
    """The path 0-1-...-(n-1), unit weights, map partitioner, mutable."""
    from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.vertex_map.partitioner import (
        MapPartitioner,
    )
    from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

    oids = np.arange(n, dtype=np.int64)
    return ShardedEdgecutFragment.build(
        CommSpec(fnum=fnum, device=device),
        VertexMap.build(oids, MapPartitioner(fnum, oids)),
        np.arange(n - 1), np.arange(1, n), np.ones(n - 1), directed=False,
        retain_edge_list=True)


def dyn_phases(frag, grid, device) -> dict:
    out = dyn_rmat_phase(frag, device)
    grid_out = dyn_grid_phase(grid, device)
    out["runs"].update(grid_out.pop("runs"))
    out["grid_repack_seconds"] = grid_out["repack_seconds"]
    out["runs"]["dyn mutation_context"] = mutation_context_phase(device)
    reset_launch_counts()
    golden_phase(device, names=DYN_GOLDEN, efile="p2p-31.e.mutable_base",
                 delta_efile="p2p-31.e.mutable_delta", tag="dyn golden")
    out["runs"]["dyn --delta_efile goldens"] = {"counts": launch_counts()}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the repacked fragments are gone
    return out


# ---- phase 11b: the serving runtime ([serve]) ---------------------------

def dyn_adds(frag):
    """The [dyn] phase's DYN_ADDS seeded additive edges (seed DYN_SEED,
    uniform(0.1, 10) weights) among the fragment's vertices, and the
    generator after them (the phase draws its removals from it)."""
    n = frag.dev.total_vnum
    rng = np.random.default_rng(DYN_SEED)
    src, dst = rng.integers(0, n, DYN_ADDS), rng.integers(0, n, DYN_ADDS)
    wts = rng.uniform(0.1, 10.0, DYN_ADDS)
    return ([("a", int(a), int(b), float(x))
             for a, b, x in zip(src, dst, wts)], rng)


def serve_sources(frag, count: int) -> list:
    """`count` distinct seed-SERVE_SEED query sources (oids) among the
    vertices with in-edges."""
    cands = np.nonzero(frag.host_ie[0].degree[:frag.inner_vertices_num(0)]
                       > 0)[0]
    pids = np.random.default_rng(SERVE_SEED).choice(cands, count,
                                                    replace=False)
    return [int(o) for o in frag.pid_to_oid(pids)]


def lanes_kernel_phase(frag, device, reps: int) -> dict:
    """K1 with a lane axis (`gather_reduce_lanes`) at RMAT-20's shapes,
    k lanes of x, in the serving apps' kinds: min with weights (SSSP),
    float sum (personalized PageRank) and int32 min (BFS, k-hop).  Each
    against its plain version (min bit-equal, sum within SUM_TOL of each
    row's sum of |terms|) and bit-equal to k single `gather_reduce`
    calls, in every kind; kernel, plain, library, bound and k x single
    times.  Library: the sparse CSR product with x as [N, k] for sum;
    for min the fastest of `segment_reduce` over the [E, k] candidates
    (float only) and `scatter_reduce_` amin over [E, k] and [k, E], each
    checked equal.  Then `spmv.pull` of SERVE_WIDE lanes, which splits
    them into calls the kernel takes, bit-equal to single calls."""
    from libgrape_lite_tpu_torch.ops import _build, spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    ie = frag.dev.ie
    indptr, nbr = ie.indptr, ie.edge_nbr
    fnum, vp = frag.fnum, frag.vp
    n = fnum * vp
    check(fnum == 1, "the lane kernel phase runs on a single fragment")
    for line in ptxas_lines(_build.BUILD_LOG.get("spmv", "")):
        if line.startswith("merge_gather_lanes_kernel"):
            print(f"[serve]   ptxas {line}", flush=True)
    e_real = int(indptr[:, -1].sum())
    w = torch.where(ie.edge_mask, ie.edge_w,
                    torch.tensor(float("inf"), device=device))
    deg = (indptr[0, 1:] - indptr[0, :-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(vp, device=device), deg)
    flat_nbr = nbr[0, :e_real].to(torch.int64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        csr = torch.sparse_csr_tensor(
            indptr[0].to(torch.int64), flat_nbr,
            torch.ones(e_real, device=device), size=(vp, n),
            check_invariants=False)
    gen = torch.Generator(device="cpu").manual_seed(5)
    out = {}
    for k in SERVE_LANES:
        far = torch.rand(k, n, generator=gen) < 0.3
        cases = {
            "min+w": (torch.where(far, torch.tensor(float("inf")),
                                  torch.rand(k, n, generator=gen) * 50),
                      w, "min"),
            "sum": (torch.rand(k, n, generator=gen), None, "sum"),
            "int32 min": (torch.where(
                far, torch.tensor(INT32_MAX, dtype=torch.int32),
                torch.randint(0, 64, (k, n), generator=gen,
                              dtype=torch.int32)), None, "min"),
        }
        for name, (x, win, kind) in cases.items():
            x = x.to(device)
            got = spmv.gather_reduce_lanes(indptr, nbr, win, x, kind)
            sync(device)
            singles = torch.stack([spmv.gather_reduce(indptr, nbr, win, x[b],
                                                      kind)
                                   for b in range(k)])
            check(torch.equal(got, singles), f"gather_reduce_lanes {name} "
                  f"k={k} not bit-equal to {k} single gather_reduce calls")
            if kind == "sum":
                max_err = check_sum(
                    got, spmv.gather_reduce_lanes_plain(
                        indptr, nbr, None, x.double(), "sum"),
                    spmv.gather_reduce_lanes_plain(
                        indptr, nbr, None, x.double().abs(), "sum"),
                    f"gather_reduce_lanes sum k={k}")
            else:
                check(torch.equal(got, spmv.gather_reduce_lanes_plain(
                    indptr, nbr, win, x, kind)),
                    f"gather_reduce_lanes {name} k={k} not bit-equal to "
                    "its plain version")
                max_err = 0.0
            if kind == "sum":
                xt = x.T.contiguous()

                def library():
                    return csr @ xt
                lib_name = "sparse_csr_tensor @ x[N, k]"
            else:
                # the candidates gathered outside the timed calls
                cand = x[:, flat_nbr]
                if win is not None:
                    cand = cand + win[0, :e_real]
                cand_ek = cand.T.contiguous()
                ident = identity_of(kind, x.dtype)
                libraries = {
                    "scatter_reduce_ amin over [k, E]": lambda: torch.full(
                        (k, vp), ident, dtype=x.dtype,
                        device=device).scatter_reduce_(
                        1, rows.expand(k, e_real), cand, "amin",
                        include_self=True),
                    "scatter_reduce_ amin over [E, k]": lambda: torch.full(
                        (vp, k), ident, dtype=x.dtype,
                        device=device).scatter_reduce_(
                        0, rows[:, None].expand(e_real, k), cand_ek, "amin",
                        include_self=True).T,
                }
                if x.is_floating_point():
                    # one lane: over [E], as K1's own row times it
                    seg_in = cand_ek if k > 1 else cand[0]
                    libraries["segment_reduce min over [E, k]"] = (
                        lambda: torch.segment_reduce(
                            seg_in, "min", lengths=deg, unsafe=True,
                            initial=ident).reshape(vp, k).T)
                for lname, call in libraries.items():
                    check(torch.equal(call().reshape(k, 1, vp), got),
                          f"lane library call {lname} disagrees ({name}, "
                          f"k={k})")
            ms = time_ms(lambda: spmv.gather_reduce_lanes(indptr, nbr, win, x,
                                                          kind),
                         device, reps)
            single_ms = time_ms(lambda: spmv.gather_reduce(indptr, nbr, win,
                                                           x[0], kind),
                                device, reps)
            plain_ms = time_ms(lambda: spmv.gather_reduce_lanes_plain(
                indptr, nbr, win, x, kind), device, 3, batch=1, warmup=1)
            if kind == "sum":
                lib_ms = time_ms(library, device, reps)
            else:
                lib_all = {lname: time_ms(call, device, reps)
                           for lname, call in libraries.items()}
                lib_name = min(lib_all, key=lib_all.get)
                lib_ms = lib_all[lib_name]
            wb = 2 if win is not None else 1
            b_ms, b_by = bound(4 * fnum * (vp + 1) + 4 * e_real * wb
                               + 2 * 4 * k * n, k * e_real * wb)
            rec = dict(lanes=k, kind=name, ms=ms, single_ms=single_ms,
                       k_x_single_ms=k * single_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library=lib_name, bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=max_err, edges=e_real)
            if kind != "sum":
                rec["library_all_ms"] = lib_all
            rec["passes_ms"] = device_passes(
                lambda: spmv.gather_reduce_lanes(indptr, nbr, win, x, kind),
                device)
            if k == SERVE_BATCH:
                rec["config"] = spmv.gather_config(
                    kind, weighted=win is not None,
                    int32=x.dtype == torch.int32, lanes=True)
            out[f"k{k} {name}"] = rec
            lib_text = (" ".join(f"{ln}={t:.4f}" for ln, t in lib_all.items())
                        if kind != "sum" else "")
            print(f"[serve] K1 lanes k={k} {name}: kernel_ms={ms:.4f} "
                  f"(earlier design, recorded in PERF.md: "
                  f"{LANES_BEFORE_MS.get((k, name))}) "
                  f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} ({lib_name}; {lib_text}) "
                  f"single_ms="
                  f"{single_ms:.4f} k_x_single_ms={k * single_ms:.4f} "
                  f"max_abs_err={max_err:.3e}; bit-equal to {k} single "
                  "calls", flush=True)
            cfg = rec.get("config")
            cfg_text = (f"smem_per_block={cfg['smem_bytes']} B registers="
                        f"{cfg['registers']} blocks_per_sm="
                        f"{cfg['blocks_per_sm']} carveout="
                        f"{cfg['carveout_pct']}%; " if cfg else "")
            print(f"[serve]   lane kernel k={k} {name}: {cfg_text}device ms "
                  f"a call: {passes_text(rec['passes_ms']) or 'not measured'}",
                  flush=True)
    # a batch wider than one call takes: pull splits it (64 + 1 lanes)
    x = torch.where(torch.rand(SERVE_WIDE, n, generator=gen) < 0.3,
                    torch.tensor(float("inf")),
                    torch.rand(SERVE_WIDE, n, generator=gen) * 50).to(device)
    before = (spmv.gather_reduce_lanes.launches, spmv.gather_reduce.launches)
    got = spmv.pull(indptr, nbr, w, x, "min")
    calls = (spmv.gather_reduce_lanes.launches - before[0],
             spmv.gather_reduce.launches - before[1])
    check(calls == (1, 1), f"pull of {SERVE_WIDE} lanes made {calls} "
          "(lane, single) calls, (1, 1) expected")
    for b in range(SERVE_WIDE):
        check(torch.equal(got[b], spmv.gather_reduce(indptr, nbr, w, x[b],
                                                     "min")),
              f"pull of {SERVE_WIDE} lanes: lane {b} not bit-equal to its "
              "single call")
    out[f"k{SERVE_WIDE} min+w pull"] = dict(lanes=SERVE_WIDE, calls=calls,
                                            max_abs_err=0.0)
    print(f"[serve] K1 lanes k={SERVE_WIDE} min+w through spmv.pull: "
          f"{calls[0]} lane call + {calls[1]} single call; every lane "
          "bit-equal to its single call", flush=True)
    return out


def identity_of(kind: str, dtype):
    if kind == "sum":
        return 0
    if dtype == torch.int32:
        return INT32_MAX if kind == "min" else -INT32_MAX - 1
    return float("inf") if kind == "min" else float("-inf")


def serve_factory(name: str):
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    if name == "khop":
        return lambda: APP_REGISTRY[name](k=DYN_KHOP_K)
    return APP_REGISTRY[name]


def serve_batch_phase(frag, device) -> dict:
    """`Worker.query_batch` on RMAT-20: SERVE_BATCH seed-SERVE_SEED
    sources each for sssp (plus one absent id), bfs, khop (k 2),
    common_neighbors and personalized pagerank; every lane's values and
    rounds bit-equal to its sequential `Worker.query`, one K1 lane launch
    a round and no single launch; wcc (no native lanes) through the
    per-lane states, its launches k times the sequential query's."""
    from libgrape_lite_tpu_torch.worker.worker import Worker

    sources = serve_sources(frag, SERVE_BATCH)
    out = {}
    for name, extra in SERVE_APPS:
        factory = serve_factory(name)
        lanes = [dict(extra, source=s) for s in sources]
        if name == "sssp":
            lanes.append(dict(extra, source=ABSENT_ID))
        if name == "wcc":
            lanes = [dict(extra) for _ in range(SERVE_GENERIC_LANES)]
        run_query(frag, factory(), device, **lanes[0])  # warm-up
        seq, seq_counts = [], None
        for a in lanes:
            reset_launch_counts()
            wk, secs = run_query(frag, factory(), device, **a)
            seq_counts = seq_counts or launch_counts()
            seq.append((wk.result_values(), wk.rounds, secs))

        def batch():
            wk = Worker(factory(), frag)
            wk.query_batch(lanes)
            return wk

        wk, counts, secs = timed_counted(batch, device)
        for b, (vals, rounds, _) in enumerate(seq):
            check(int(wk.batch_rounds[b]) == rounds,
                  f"batched {name} lane {b}: {int(wk.batch_rounds[b])} "
                  f"rounds, sequential {rounds}")
            check(np.array_equal(wk.batch_result_values(b), vals),
                  f"batched {name} lane {b} not bit-equal to its "
                  "sequential query")
        rounds = int(wk.batch_rounds.max())
        if name == "wcc":
            check(counts["gather_reduce_lanes"] == 0
                  and counts["gather_reduce"]
                  == len(lanes) * seq_counts["gather_reduce"],
                  f"batched wcc launches {counts}, sequential {seq_counts}")
        else:
            check(counts["gather_reduce_lanes"] == rounds
                  and counts["gather_reduce"] == 0,
                  f"batched {name}: {counts} in {rounds} rounds (one K1 "
                  "lane launch a round expected)")
        seq_s = sum(s for _, _, s in seq)
        out[f"serve batch {name}"] = dict(
            counts=counts, lanes=len(lanes), seconds=secs,
            sequential_seconds=seq_s, rounds=[int(r) for r in
                                              wk.batch_rounds])
        print(f"[serve] batch {name}: lanes={len(lanes)} rounds="
              f"{[int(r) for r in wk.batch_rounds]} batch_s={secs:.4f} "
              f"sequential_s={seq_s:.4f} (sum of {len(lanes)}) launches: "
              f"K1 lanes {counts['gather_reduce_lanes']}, K1 single "
              f"{counts['gather_reduce']}; every lane bit-equal to its "
              "sequential query", flush=True)
    return out


def same_results(a, b, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} results against {len(b)}")
    for x, y in zip(a, b):
        check(x.ok and y.ok, f"{what}: a query failed ({x.error or y.error})")
        check(x.app_key == y.app_key and x.rounds == y.rounds,
              f"{what}: results out of order or rounds differ")
        check(x.values.tobytes() == y.values.tobytes(),
              f"{what}: values not byte-identical")


def serve_session_phase(frag, device) -> dict:
    """`ServeSession` on RMAT-20: SERVE_QUERIES sssp queries at
    max_batch 1 and SERVE_BATCH (bit-equal), the async pump at each of
    SERVE_WINDOWS against the synchronous loop (byte-identical, in
    order), then again with the [dyn] adds ingested in chunks every
    SERVE_INGEST_EVERY queries (sync, W 1 and W 4 identical).  Each
    session serves the queries once before the measured pass."""
    from libgrape_lite_tpu_torch.cli import serve_with_ingest
    from libgrape_lite_tpu_torch.dyn import RepackPolicy
    from libgrape_lite_tpu_torch.serve import (
        PUMP_STATS,
        BatchPolicy,
        ServeSession,
    )
    from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

    stream = [("sssp", {"source": s})
              for s in serve_sources(frag, SERVE_QUERIES)]
    out = {"runs": {}}

    def serve(max_batch, window=None, dyn=False):
        sess = ServeSession(
            frag, policy=BatchPolicy(max_batch=max_batch),
            dyn=RepackPolicy() if dyn else None)
        # a resident session is warm: its workers built, its streams'
        # memory cached (a first pass runs on cold allocator pools)
        warm = sess.async_pump(window=window) if window else None
        for app, args in stream:
            sess.submit(app, args)
        if warm:
            warm.drain()
            warm.close()
        else:
            sess.drain()
        pump = sess.async_pump(window=window) if window else None
        warm_hist = dict(sess.queue.batch_hist)
        PUMP_STATS.reset()
        reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        reqs = [sess.submit(app, args) for app, args in stream]
        if dyn:
            res = serve_with_ingest(sess, pump, reqs, dyn_adds(frag)[0],
                                    SERVE_INGEST_EVERY)
        else:
            res = pump.drain() if pump else sess.drain()
        sync(device)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        frag.dyn_overlay = None  # the next run starts from the base graph
        lat = latency_summary_ms([r.latency_s for r in res])
        rec = dict(counts=counts, seconds=wall, qps=len(res) / wall,
                   p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
                   batch_hist={k: v - warm_hist.get(k, 0) for k, v in
                               sess.queue.batch_hist.items()},
                   stats=dict(sess.stats))
        if pump:
            rec["pump"] = dict(pump.stats, launch_cap=pump.launch_cap,
                               **PUMP_STATS.snapshot())
        tag = (f"max_batch={max_batch}" + (f" W={window}" if window else
                                           " sync")
               + (" ingest" if dyn else ""))
        print(f"[serve] session {tag}: queries={len(res)} qps="
              f"{rec['qps']:.1f} p50_ms={lat['p50_ms']} p99_ms="
              f"{lat['p99_ms']} batch_hist={rec['batch_hist']} launches="
              f"{counts}" + (f" pump={rec['pump']}" if pump else "")
              + (f" overlay_applies={sess.stats['overlay_applies']} "
                 f"repacks={sess.stats['repacks']}" if dyn else ""),
              flush=True)
        out["runs"][f"serve session {tag}"] = rec
        return res, rec

    one, _ = serve(1)
    batched, rec = serve(SERVE_BATCH)
    same_results(one, batched, f"max_batch 1 against {SERVE_BATCH}")
    check(rec["counts"]["gather_reduce_lanes"] > 0,
          "the batched session launched no K1 lane call")
    for window in SERVE_WINDOWS:
        res, rec = serve(SERVE_BATCH, window)
        same_results(batched, res, f"the pump at W={window}")
    check(rec["pump"]["max_inflight"] > 1
          and rec["pump"]["overlapped_harvests"] >= 1,
          f"the W={SERVE_WINDOWS[-1]} window never overlapped: "
          f"{rec['pump']}")
    ref, rec = serve(SERVE_BATCH, dyn=True)
    check(rec["stats"]["overlay_applies"] > 0,
          "the ingest never rode the overlay")
    check(rec["counts"]["overlay_fold"] > 0,
          "the session with ingest launched no overlay fold")
    for window in SERVE_WINDOWS:
        res, _ = serve(SERVE_BATCH, window, dyn=True)
        same_results(ref, res, f"the pump at W={window} with ingest")
    return out


def serve_cli_phase(device) -> dict:
    """`python -m libgrape_lite_tpu_torch.cli serve` (in this process) on
    p2p-31 at fnum 1 and 4: SERVE_CLI_QUERIES queries at max_batch
    SERVE_BATCH, --inflight 1 and 4 with equal --dump_results files and
    the summary line parsed; then with a --delta_stream of seeded adds."""
    import io
    import tempfile

    from libgrape_lite_tpu_torch import cli

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        oids = np.loadtxt(os.path.join(HERE, "dataset", "p2p-31.v"),
                          dtype=np.int64, usecols=0)
        rng = np.random.default_rng(DYN_SEED)
        ends = rng.choice(oids, (SERVE_CLI_ADDS, 2))
        delta = os.path.join(tmp, "adds.txt")
        with open(delta, "w") as f:
            for (a, b), x in zip(ends, rng.uniform(0.1, 10.0,
                                                   SERVE_CLI_ADDS)):
                f.write(f"a {a} {b} {x:.4f}\n")
        for fnum in (1, 4):
            for extra in ([], ["--delta_stream", delta]):
                dumps, recs = [], []
                for window in SERVE_WINDOWS:
                    dump = os.path.join(tmp, f"dump{fnum}_{window}.txt")
                    buf = io.StringIO()
                    reset_launch_counts()
                    with contextlib.redirect_stdout(buf):
                        rc = cli.main([
                            "serve", "--efile",
                            os.path.join(HERE, "dataset", "p2p-31.e"),
                            "--vfile",
                            os.path.join(HERE, "dataset", "p2p-31.v"),
                            "--fnum", str(fnum), "--num_queries",
                            str(SERVE_CLI_QUERIES), "--max_batch",
                            str(SERVE_BATCH), "--inflight", str(window),
                            "--dump_results", dump, "--device", device,
                            *extra])
                    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
                    check(rc == 0 and rec["ok"] == SERVE_CLI_QUERIES,
                          f"serve CLI fnum {fnum} W {window}: {rec}")
                    check(not extra or rec["dyn"]["ingested"] > 0,
                          "the CLI's delta stream ingested nothing")
                    with open(dump) as f:
                        dumps.append(f.read())
                    recs.append(rec)
                    out[f"serve cli fnum{fnum} W{window}"
                        + (" delta" if extra else "")] = dict(
                        counts=launch_counts(), qps=rec["qps"],
                        p50_ms=rec["p50_ms"], p99_ms=rec["p99_ms"])
                check(len(set(dumps)) == 1, f"serve CLI fnum {fnum}: "
                      "--dump_results differ across --inflight")
                print(f"[serve] cli fnum={fnum}"
                      + (" --delta_stream" if extra else "")
                      + ": " + " ".join(
                          f"W{r['inflight']}: qps={r['qps']} p50_ms="
                          f"{r['p50_ms']} p99_ms={r['p99_ms']} batch_hist="
                          f"{r['batch_hist']}" for r in recs)
                      + (f" dyn={recs[-1]['dyn']}" if extra else "")
                      + "; dump files equal", flush=True)
    return out


def serve_profile(frag, device) -> dict:
    """Where the time goes in one SERVE_BATCH-lane sssp batch."""
    from libgrape_lite_tpu_torch.models import SSSP
    from libgrape_lite_tpu_torch.worker.worker import Worker

    lanes = [{"source": s} for s in serve_sources(frag, SERVE_BATCH)]

    def batch():
        wk = Worker(SSSP(), frag)
        sync(device)
        t0 = time.perf_counter()
        wk.query_batch(lanes)
        sync(device)
        return time.perf_counter() - t0

    batch()  # warm-up
    return profile_call(f"serve sssp batch of {SERVE_BATCH}", batch)


def serve_phases(frag, device) -> dict:
    out = {"kernel": lanes_kernel_phase(frag, device, reps=10)}
    out["runs"] = serve_batch_phase(frag, device)
    out["runs"].update(serve_session_phase(frag, device)["runs"])
    out["runs"].update(serve_cli_phase(device))
    if torch.device(device).type == "cuda":
        out["profile"] = serve_profile(frag, device)
    return out


# ---- phase 11c: the serving fleet and its autopilot ([fleet], [autopilot])

def fleet_stream(frag) -> list:
    """FLEET_QUERIES seed-17 sources (`serve_sources`), sssp and bfs in
    turns."""
    return [("sssp" if i % 2 == 0 else "bfs", {"source": s})
            for i, s in enumerate(serve_sources(frag, FLEET_QUERIES))]


def timed_replica(frag, device):
    """`replicate_fragment(frag)` (a rebuild from the edge list) and its
    host seconds."""
    from libgrape_lite_tpu_torch.fragment.mutation import replicate_fragment

    sync(device)
    t0 = time.perf_counter()
    rep = replicate_fragment(frag)
    sync(device)
    return rep, time.perf_counter() - t0


def count_by_replica(router) -> dict:
    """Launch counts by replica, taken around each replica's pump drain:
    `run_fleet_script` does all device work in drains, replica after
    replica, each joined before the next starts."""
    per = {r.idx: dict.fromkeys(launch_counts(), 0)
           for r in router.replicas}
    for r in router.replicas:
        def drain(inner=r.pump.drain, idx=r.idx):
            before = launch_counts()
            out = inner()
            after = launch_counts()
            for k in per[idx]:
                per[idx][k] += after[k] - before[k]
            return out

        r.pump.drain = drain
    return per


def fleet_drill_phase(frag, rep, device) -> dict:
    """The fleet drill on RMAT-20: FLEET_QUERIES queries (sssp and bfs in
    turns) at max_batch SERVE_BATCH with the [dyn] adds ingested in
    chunks every FLEET_INGEST_EVERY queries by `run_fleet_script`, four
    ways: (a) one bare ServeSession, (b) a FleetRouter over `frag` and
    its replica `rep`, (c) the same with replica 0 drained before query
    FLEET_DRAIN_AT, (d) a FleetManager with a tenant a app over (b)'s
    router.  Every query bit-equal across the four, none dropped, the
    fence equal to the ingests, and in (b) each replica launching the
    lane K1 and the overlay fold."""
    from libgrape_lite_tpu_torch.dyn import RepackPolicy
    from libgrape_lite_tpu_torch.fleet import (
        FLEET_STATS,
        FleetBudget,
        FleetManager,
        FleetRouter,
        run_fleet_script,
    )
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession
    from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

    stream = fleet_stream(frag)
    adds = dyn_adds(frag)[0]
    n_ingests = -(-FLEET_QUERIES // FLEET_INGEST_EVERY)
    out = {"runs": {}}

    def drill(tag, replicas, drain_at=None, tenants=False):
        FLEET_STATS.reset()
        sessions = [ServeSession(f, policy=BatchPolicy(max_batch=SERVE_BATCH),
                                 dyn=RepackPolicy())
                    for f in (frag, rep)[:replicas]]
        router = FleetRouter(sessions) if replicas > 1 else None
        target = router or sessions[0]
        manager = tenant_of = None
        if tenants:
            manager = FleetManager(FleetBudget(device=device))
            for app in sorted({app for app, _ in stream}):
                manager.add_tenant(app, target)
            tenant_of = lambda i, app: app  # noqa: E731
        per = count_by_replica(router) if router else None
        reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        reqs = run_fleet_script(
            target, stream, manager=manager, tenant_of=tenant_of,
            delta_ops=adds, ingest_every=FLEET_INGEST_EVERY,
            drain_at=drain_at)
        sync(device)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        for f in (frag, rep):
            f.dyn_overlay = None  # the next run starts from the base graph
        results = [q.result for q in reqs]
        dropped = sum(r is None for r in results)
        check(dropped == 0, f"fleet {tag}: {dropped} queries dropped")
        check(all(r.ok for r in results), f"fleet {tag}: a query failed: "
              f"{[r.error for r in results if not r.ok][:1]}")
        lat = latency_summary_ms([r.latency_s for r in results])
        rec = dict(counts=counts, seconds=wall,
                   qps=len(results) / wall, p50_ms=lat["p50_ms"],
                   p99_ms=lat["p99_ms"], fleet=FLEET_STATS.snapshot(),
                   repacks=sum(s.stats["repacks"] for s in sessions))
        if router is not None:
            check(router.fence == n_ingests,
                  f"fleet {tag}: fence {router.fence}, {n_ingests} ingests")
            rec["replicas"] = {
                f"r{idx}": dict(router.replicas[idx].summary(wall),
                                counts=per[idx])
                for idx in per}
            rec["events"] = [dict(e) for e in FLEET_STATS.events
                             if e["kind"] in ("drain", "rejoin")]
        if manager is not None:
            rec["tenants"] = manager.snapshot()["tenants"]
        print(f"[fleet] {tag}: queries={len(results)} qps={rec['qps']:.1f} "
              f"p50_ms={lat['p50_ms']} p99_ms={lat['p99_ms']} launches="
              f"{counts} fleet={rec['fleet']}"
              + "".join(f" {k}: served={v['served']} qps={v.get('qps')} "
                        f"p50_ms={v['p50_ms']} p99_ms={v['p99_ms']} "
                        f"launches={v['counts']}"
                        for k, v in rec.get("replicas", {}).items())
              + "".join(f" {e['kind']}: wall_s={e['wall_s']}"
                        for e in rec.get("events", [])), flush=True)
        out["runs"][f"fleet {tag}"] = rec
        return results, rec

    ref, _ = drill("R1 session", 1)
    for tag, kw in (("R2", {}), (f"R2 drain_at={FLEET_DRAIN_AT}",
                                 {"drain_at": FLEET_DRAIN_AT}),
                    ("R2 tenants=by_app", {"tenants": True})):
        res, rec = drill(tag, 2, **kw)
        same_results(ref, res, f"fleet {tag} against one session")
        if tag == "R2":
            for name, r in rec["replicas"].items():
                for k in ("gather_reduce_lanes", "overlay_fold"):
                    check(r["counts"][k] > 0,
                          f"fleet R2: replica {name} launched no {k}")
        if "drain" in tag:
            kinds = [e["kind"] for e in rec["events"]]
            check(kinds == ["drain", "rejoin"], f"fleet {tag}: {kinds}")
    return out


def fleet_evict_phase(frag, rep, ref, sources, device) -> dict:
    """Eviction at full size: tenants a (`frag`) and b (`rep`), a session
    each, under a budget of 1.5x one tenant's priced footprint, served
    in EVICT_GROUPS alternating groups of EVICT_GROUP sssp queries: each
    switch evicts the other tenant.  Gates: evictions and re-admissions
    recorded, PLAN_STATS and the worker builds flat across them, every
    result bit-equal to a never-evicted session's (`ref`).  Prints each
    re-admission's `restore_device` seconds and each eviction's drop in
    `torch.cuda.memory_allocated()` beside its priced bytes."""
    from libgrape_lite_tpu_torch.fleet import (
        FLEET_STATS,
        FleetBudget,
        FleetManager,
        session_footprint,
    )
    from libgrape_lite_tpu_torch.fragment.edgecut import DEVICE_CACHES
    from libgrape_lite_tpu_torch.ops.spmv import plan_stats
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    FLEET_STATS.reset()
    # the push CSRs earlier phases cached on `frag` go first, so the two
    # tenants price alike
    for cache in DEVICE_CACHES:
        cache.pop(frag, None)
    policy = BatchPolicy(max_batch=SERVE_BATCH)
    sessions = {"a": ServeSession(frag, policy=policy),
                "b": ServeSession(rep, policy=policy)}
    price = max(session_footprint(s).total for s in sessions.values())
    mgr = FleetManager(FleetBudget(capacity_bytes=int(1.5 * price)))
    for name, sess in sessions.items():
        mgr.add_tenant(name, sess)
    evictions, restores = [], []
    on_card = torch.device(device).type == "cuda"

    def evict_cb(victim, inner=mgr._evict_cb):
        sync(device)
        before = torch.cuda.memory_allocated() if on_card else 0
        inner(victim)
        sync(device)
        after = torch.cuda.memory_allocated() if on_card else 0
        evictions.append({"name": victim, "drop_bytes": before - after})

    mgr._evict_cb = evict_cb
    for name, sess in sessions.items():
        def restore(inner=sess.restore_device, name=name):
            sync(device)
            t0 = time.perf_counter()
            placed = inner()
            sync(device)
            if placed:
                restores.append({"name": name,
                                 "seconds": time.perf_counter() - t0})
            return placed

        sess.restore_device = restore
    reset_launch_counts()
    plans = None
    t0 = time.perf_counter()
    for g in range(EVICT_GROUPS):
        name = "ab"[g % 2]
        group = sources[g * EVICT_GROUP:(g + 1) * EVICT_GROUP]
        tickets = [mgr.submit(name, "sssp", {"source": s}) for s in group]
        mgr.drain()
        for s, t in zip(group, tickets):
            check(t.done and t.result.ok, f"evict: tenant {name} query "
                  f"failed: {t.result.error if t.result else 'dropped'}")
            check(t.result.values.tobytes() == ref[s].tobytes(),
                  f"evict: tenant {name} source {s} not bit-equal to the "
                  "never-evicted session")
        if g == 1:
            plans = plan_stats()  # both tenants warm
    wall = time.perf_counter() - t0
    counts = launch_counts()
    frag.restore_device()  # later phases use `frag`
    priced = [e for e in FLEET_STATS.events if e["kind"] == "evict"]
    check(len(priced) == len(evictions) > 0,
          f"evict: {len(evictions)} releases, {len(priced)} recorded")
    for ev, p in zip(evictions, priced):
        ev["priced_bytes"] = p["freed_bytes"]
    readmits = sum(1 for e in FLEET_STATS.events
                   if e["kind"] == "tenant_readmit")
    check(FLEET_STATS.evictions > 0 and readmits > 0 and restores,
          f"evict: evictions {FLEET_STATS.evictions}, re-admits {readmits}")
    check(plan_stats() == plans, f"evict: PLAN_STATS moved across the "
          f"re-admissions: {plans} -> {plan_stats()}")
    for name, sess in sessions.items():
        check(sess.cache_stats()["runner"]["misses"] == 1,
              f"evict: tenant {name} built a worker again")
    rec = dict(counts=counts, seconds=wall, capacity=int(1.5 * price),
               tenant_price_bytes=price, evictions=evictions,
               restores=restores, readmits=readmits,
               fleet=FLEET_STATS.snapshot())
    print(f"[fleet] evict: capacity={rec['capacity']} tenant_price_bytes="
          f"{price} groups={EVICT_GROUPS}x{EVICT_GROUP} evictions="
          f"{FLEET_STATS.evictions} readmits={readmits} plan_stats flat="
          f"{plans}; " + " ".join(
              f"evict {e['name']}: drop={e['drop_bytes']} priced="
              f"{e['priced_bytes']} "
              f"({e['drop_bytes'] / e['priced_bytes']:.3f})"
              for e in evictions) + "; " + " ".join(
              f"restore {r['name']}: {r['seconds']:.4f} s" for r in restores)
          + f"; launches={counts}", flush=True)
    return {"fleet evict": rec}


def autopilot_phase(frag, session_qps, device) -> dict:
    """The autopilot on RMAT-20 (the CLI's `serve_autopilot_stream`):
    min 1, max 2 replicas, a result cache of AUTOPILOT_CACHE entries,
    AUTOPILOT_QUERIES sssp queries over AUTOPILOT_SOURCES sources -- the
    first AUTOPILOT_WARM twice in turn, then the others twice each in a
    row -- arriving through the feeder at half `session_qps` (the
    max_batch SERVE_BATCH session's measured qps), x AUTOPILOT_STEP_X
    from arrival AUTOPILOT_STEP_AT.  Gates: a scale-up recorded, every
    result (cache hits too) bit-equal to one plain session's, none
    dropped.  Each tick's queue depth a routable replica is kept: the
    line shows the deepest and the longest run of reads over
    `up_queue_depth`, the scaler's overload signal."""
    from libgrape_lite_tpu_torch.autopilot import (
        AUTOPILOT_STATS,
        Autoscaler,
        ResultCache,
        ScalerConfig,
    )
    from libgrape_lite_tpu_torch.cli import serve_autopilot_stream
    from libgrape_lite_tpu_torch.fleet import (
        FLEET_STATS,
        FleetBudget,
        FleetRouter,
    )
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession
    from libgrape_lite_tpu_torch.serve.queue import latency_summary_ms

    FLEET_STATS.reset()
    AUTOPILOT_STATS.reset()
    policy = BatchPolicy(max_batch=SERVE_BATCH)

    def make_session(f):
        return ServeSession(f, policy=policy)

    sources = serve_sources(frag, AUTOPILOT_SOURCES)
    sess = make_session(frag)
    reqs = [sess.submit("sssp", {"source": s}) for s in sources]
    sess.drain()
    ref = {s: q.result.values for s, q in zip(sources, reqs)}
    del sess, reqs
    router = FleetRouter([make_session(frag)])
    cache = ResultCache(capacity=AUTOPILOT_CACHE)
    router.attach_cache(cache)
    cfg = ScalerConfig(min_replicas=1, max_replicas=2)
    ap = Autoscaler(router, cfg, session_factory=make_session,
                    budget=FleetBudget(device=device))
    warm, rest = sources[:AUTOPILOT_WARM], sources[AUTOPILOT_WARM:]
    order = warm + warm + [s for s in rest for _ in (0, 1)]
    stream = [{"app": "sssp", "args": {"source": s}, "max_rounds": None}
              for s in order]
    rate = (f"{session_qps / 2:.1f}:{AUTOPILOT_STEP_X}x@"
            f"{AUTOPILOT_STEP_AT}")
    timeline, acts, depths = [], [], []

    def act(d, inner=ap.act):
        ta = time.perf_counter()
        taken = inner(d)
        acts.append({"action": taken.action, "reason": taken.reason,
                     "at_s": round(ta - t0, 4),
                     "seconds": time.perf_counter() - ta})
        return taken

    def tick(inner=ap.tick):
        d = inner()
        sig = ap.reader.recent[-1]
        depths.append(sig.queue_depth / max(1, sig.replicas))
        n = sum(1 for r in router.replicas if r.routable)
        if not timeline or timeline[-1][1] != n:
            timeline.append((round(time.perf_counter() - t0, 4), n))
        return d

    ap.act, ap.tick = act, tick
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    reqs = serve_autopilot_stream(router, ap, stream, rate)
    sync(device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    results = [q.result for q in reqs]
    check(len(results) == AUTOPILOT_QUERIES
          and all(r is not None for r in results),
          f"autopilot: {len(results)} results for {AUTOPILOT_QUERIES}")
    for item, r in zip(stream, results):
        s = item["args"]["source"]
        check(r.ok, f"autopilot: source {s} failed: {r.error}")
        check(r.values.tobytes() == ref[s].tobytes(),
              f"autopilot: source {s} not bit-equal to one session")
    snap = AUTOPILOT_STATS.snapshot()
    run = over_run = 0
    for dep in depths:
        run = run + 1 if dep > cfg.up_queue_depth else 0
        over_run = max(over_run, run)
    lat = latency_summary_ms([r.latency_s for r in results])
    rec = dict(counts=counts, seconds=wall, qps=len(results) / wall,
               p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"], rate=rate,
               replicas_over_time=timeline,
               acts=[a for a in acts if a["action"] != "hold"],
               cache=cache.snapshot(),
               router=router.summary(wall), fleet=FLEET_STATS.snapshot(),
               max_depth=max(depths, default=0), over_depth_run=over_run,
               **{k: snap[k] for k in ("ticks", "scale_ups", "scale_downs",
                                       "holds", "cache_hits",
                                       "cache_misses")})
    print(f"[autopilot] rmat{SCALE}: queries={len(results)} rate={rate} "
          f"qps={rec['qps']:.1f} p50_ms={lat['p50_ms']} p99_ms="
          f"{lat['p99_ms']} scale_ups={snap['scale_ups']} scale_downs="
          f"{snap['scale_downs']} ticks={snap['ticks']} max_depth="
          f"{rec['max_depth']:g} reads_over_{cfg.up_queue_depth}="
          f"{over_run} (window {cfg.window}) acts="
          f"{rec['acts']} replicas_over_time={timeline} cache="
          f"{rec['cache']} launches={counts}", flush=True)
    check(snap["scale_ups"] >= 1, "autopilot: no scale-up recorded "
          f"(ticks {snap['ticks']}, holds {snap['holds']}, deepest queue "
          f"{rec['max_depth']:g} a replica, {over_run} reads in a row over "
          f"{cfg.up_queue_depth})")
    return {"autopilot": rec}


def fleet_cli_phase(device) -> dict:
    """The serve CLI's fleet and autopilot paths on p2p-31 at fnum 1 and
    4: `--replicas 2 --drain_at 8 --tenants by_app` with a --delta_stream
    of SERVE_CLI_ADDS seeded adds, `--autopilot --min_replicas 1
    --max_replicas 2 --cache_entries 64` (the JAX CLI refuses it a delta
    stream, and so does this one), each --dump_results equal to the plain
    run's."""
    import io
    import tempfile

    from libgrape_lite_tpu_torch import cli

    out = {}

    def run(argv, tag):
        buf = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["serve", "--efile",
                           os.path.join(HERE, "dataset", "p2p-31.e"),
                           "--vfile", os.path.join(HERE, "dataset", "p2p-31.v"),
                           "--num_queries", str(SERVE_CLI_QUERIES),
                           "--max_batch", str(SERVE_BATCH),
                           "--device", device, *argv])
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and rec["ok"] == SERVE_CLI_QUERIES, f"{tag}: {rec}")
        out[tag] = dict(counts=launch_counts(), qps=rec["qps"],
                        p50_ms=rec["p50_ms"], p99_ms=rec["p99_ms"])
        return rec

    with tempfile.TemporaryDirectory() as tmp:
        oids = np.loadtxt(os.path.join(HERE, "dataset", "p2p-31.v"),
                          dtype=np.int64, usecols=0)
        rng = np.random.default_rng(DYN_SEED)
        ends = rng.choice(oids, (SERVE_CLI_ADDS, 2))
        delta = os.path.join(tmp, "adds.txt")
        with open(delta, "w") as f:
            for (a, b), x in zip(ends, rng.uniform(0.1, 10.0,
                                                   SERVE_CLI_ADDS)):
                f.write(f"a {a} {b} {x:.4f}\n")

        def dump(name):
            with open(os.path.join(tmp, name)) as f:
                return f.read()

        for fnum in (1, 4):
            f = ["--fnum", str(fnum)]
            d = ["--delta_stream", delta]
            run([*f, *d, "--dump_results", os.path.join(tmp, "p.txt")],
                f"fleet cli fnum{fnum} plain delta")
            rec = run([*f, *d, "--replicas", "2", "--drain_at", "8",
                       "--tenants", "by_app", "--dump_results",
                       os.path.join(tmp, "f.txt")],
                      f"fleet cli fnum{fnum} replicas")
            check(dump("p.txt") == dump("f.txt"), f"fleet CLI fnum {fnum}: "
                  "--dump_results differ from the plain run")
            check(rec["fleet"]["dropped"] == 0
                  and rec["fleet"]["drains"] == 1
                  and rec["fleet"]["rejoins"] == 1,
                  f"fleet CLI fnum {fnum}: {rec['fleet']}")
            run([*f, "--dump_results", os.path.join(tmp, "p2.txt")],
                f"fleet cli fnum{fnum} plain")
            ap = run([*f, "--autopilot", "--min_replicas", "1",
                      "--max_replicas", "2", "--cache_entries",
                      str(AUTOPILOT_CLI_CACHE), "--dump_results",
                      os.path.join(tmp, "a.txt")],
                     f"autopilot cli fnum{fnum}")
            check(dump("p2.txt") == dump("a.txt"), f"autopilot CLI fnum "
                  f"{fnum}: --dump_results differ from the plain run")
            print(f"[fleet] cli fnum={fnum}: --replicas 2 --drain_at 8 "
                  f"--tenants by_app --delta_stream: dump equal, fleet="
                  f"{ {k: rec['fleet'][k] for k in ('fence', 'drains', 'rejoins', 'dropped')} } "
                  f"qps={rec['qps']}; --autopilot: dump equal, autopilot="
                  f"{ {k: ap['autopilot'][k] for k in ('ticks', 'scale_ups', 'cache_hits', 'cache_misses')} } "
                  f"qps={ap['qps']}", flush=True)
        with contextlib.redirect_stderr(io.StringIO()):
            try:
                cli.main(["serve", "--efile",
                          os.path.join(HERE, "dataset", "p2p-31.e"),
                          "--autopilot", "--delta_stream", delta,
                          "--device", device])
                refused = False
            except SystemExit as e:
                refused = e.code not in (0, None)
        check(refused, "the autopilot CLI took a --delta_stream")
    return out


def fleet_phases(frag, session_qps, device) -> dict:
    """[fleet] and [autopilot]: replicas of the RMAT-20 fragment, the
    fleet drill, eviction at full size, the autopilot drill and the CLI
    paths; seconds of each half."""
    from libgrape_lite_tpu_torch.fleet import fragment_bytes
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    t0 = time.perf_counter()
    rep, rep_s = timed_replica(frag, device)
    print(f"[fleet] rmat{SCALE} replica: build_host_s={rep_s:.2f} "
          f"fragment_bytes={fragment_bytes(rep)} (original "
          f"{fragment_bytes(frag)})", flush=True)
    out = {"replica_build_s": rep_s, "fragment_bytes": fragment_bytes(rep)}
    runs = fleet_drill_phase(frag, rep, device)["runs"]
    sources = serve_sources(frag, FLEET_QUERIES)
    sess = ServeSession(frag, policy=BatchPolicy(max_batch=SERVE_BATCH))
    reqs = [sess.submit("sssp", {"source": s}) for s in sources]
    sess.drain()
    ref = {s: q.result.values for s, q in zip(sources, reqs)}
    del sess, reqs
    runs.update(fleet_evict_phase(frag, rep, ref, sources, device))
    runs.update(fleet_cli_phase(device))
    del rep
    out["fleet_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs.update(autopilot_phase(frag, session_qps, device))
    out["autopilot_seconds"] = time.perf_counter() - t0
    print(f"[time] fleet {out['fleet_seconds']:.1f} s, autopilot "
          f"{out['autopilot_seconds']:.1f} s", flush=True)
    out["runs"] = runs
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---- phase 11d: observability ([obs]) -----------------------------------

def obs_reset() -> None:
    """Disarm obs/ and forget its sinks (every [obs] run starts clean)."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.obs import exporter
    from libgrape_lite_tpu_torch.obs.recorder import RECORDER

    exporter.stop_exporter()
    RECORDER.set_sink(None)
    obs.reset()


def host_spans(events, name: str) -> list:
    """The `name` spans on host rows (not the per-fragment, lane or
    replica mirrors)."""
    from libgrape_lite_tpu_torch.obs.events import FRAG_TID_BASE

    return [e for e in events if e.get("ph") == "X" and e["name"] == name
            and e["tid"] < FRAG_TID_BASE]


def profiled_votes(frag, app_factory, device, kw):
    """One disarmed `Worker.query` at vlog level 1 (`run_app --profile`):
    the per-round lines it logs and the votes they report, PEval first."""
    import io

    from libgrape_lite_tpu_torch.utils import logging as glog

    buf = io.StringIO()
    old = glog.vlog_level()
    glog.set_vlog_level(1)
    try:
        with contextlib.redirect_stderr(buf):
            wk = run_query(frag, app_factory(), device, **kw)[0]
    finally:
        glog.set_vlog_level(old)
    lines = [ln for ln in buf.getvalue().splitlines()
             if "PEval: " in ln or "IncEval round " in ln]
    votes = [int(ln.rsplit("active=", 1)[1]) for ln in lines]
    return wk, lines, votes


def obs_query_phase(label, frag, app_factory, device, kw, tmp) -> dict:
    """One main-path query armed (trace and metrics files, as `run_app
    --trace --metrics` arms them) against the same query disarmed:
    bit-equal values, one `query` span, one `peval` and `rounds`
    `superstep` spans whose `active` args are the votes the profiled run
    logs, `grape_supersteps_total` = rounds + 1, equal host syncs; the
    wall of each, median of 5 (interleaved, each armed run re-armed
    fresh), beside the wall armed with no file sink (`in_memory`) and
    the seconds of one flush into the file sinks, which every armed
    query ends with; and the spans' summed `device_wait_us` beside the
    query's device busy time from torch.profiler."""
    from libgrape_lite_tpu_torch import obs

    obs_reset()
    plain, lines, votes = profiled_votes(frag, app_factory, device, kw)
    want = plain.result_values()
    syncs_plain = host_syncs(frag, app_factory, device, kw)
    trace = os.path.join(tmp, f"{label}.json")
    metrics = os.path.join(tmp, f"{label}_metrics")
    obs.configure(trace_path=trace, metrics_path=metrics)
    reset_launch_counts()
    wk = run_query(frag, app_factory(), device, **kw)[0]
    counts = launch_counts()
    obs.flush()
    check(np.array_equal(wk.result_values(), want),
          f"[obs] {label}: armed values not bit-equal to disarmed")
    check(wk.rounds == plain.rounds, f"[obs] {label}: rounds differ")
    events = obs.load_trace(trace)
    q, pe, st = (host_spans(events, n) for n in ("query", "peval",
                                                   "superstep"))
    check(len(q) == 1 and len(pe) == 1 and len(st) == wk.rounds,
          f"[obs] {label}: {len(q)} query, {len(pe)} peval, {len(st)} "
          f"superstep spans for {wk.rounds} rounds")
    active = [e["args"]["active"] for e in pe + st]
    check(active == votes, f"[obs] {label}: span votes {active[:8]} differ "
          f"from the profiled run's {votes[:8]}")
    check([e["args"]["round"] for e in st] == list(range(1, wk.rounds + 1)),
          f"[obs] {label}: superstep rounds out of order")
    with open(metrics + ".json") as f:
        snap = json.load(f)
    check(snap["grape_supersteps_total"]["value"] == wk.rounds + 1,
          f"[obs] {label}: grape_supersteps_total "
          f"{snap['grape_supersteps_total']['value']} != {wk.rounds + 1}")
    check(snap["grape_active_per_round"]["values"] == votes,
          f"[obs] {label}: the active series differs from the votes")
    obs.configure(in_memory=True)
    syncs_armed = host_syncs(frag, app_factory, device, kw)
    check(syncs_armed == syncs_plain, f"[obs] {label}: host syncs armed "
          f"{syncs_armed} != disarmed {syncs_plain}")
    walls = {"disarmed": [], "armed": [], "in_memory": []}
    for i in range(5):
        obs_reset()
        walls["disarmed"].append(run_query(frag, app_factory(), device,
                                           **kw)[1])
        obs.configure(in_memory=True)
        walls["in_memory"].append(run_query(frag, app_factory(), device,
                                            **kw)[1])
        obs.configure(trace_path=os.path.join(tmp, f"{label}_{i}.json"),
                      metrics_path=os.path.join(tmp, f"{label}_{i}_m"))
        walls["armed"].append(run_query(frag, app_factory(), device,
                                        **kw)[1])
    t0 = time.perf_counter()
    obs.flush()  # the sinks again, as the last armed query left them
    flush_ms = (time.perf_counter() - t0) * 1e3
    med = {k: float(np.median(v)) for k, v in walls.items()}
    obs.configure(in_memory=True)

    def armed_query():
        obs.configure(in_memory=True)  # a new history each attempt
        return run_query(frag, app_factory(), device, **kw)[1]

    prof = (profile_call(f"{label} armed query", armed_query)
            if torch.device(device).type == "cuda" else None)
    ev = obs.history()
    waits = [e["args"]["device_wait_us"] for e in
             host_spans(ev, "peval") + host_spans(ev, "superstep")]
    wait_ms = sum(waits) / 1e3
    obs_reset()
    print(f"[obs] {label}: rounds={wk.rounds} spans query=1 peval=1 "
          f"superstep={len(st)} active=votes supersteps_total="
          f"{wk.rounds + 1} host_syncs armed={syncs_armed} disarmed="
          f"{syncs_plain} wall_ms median of 5 armed="
          f"{med['armed'] * 1e3:.3f} disarmed={med['disarmed'] * 1e3:.3f} "
          f"(x{med['armed'] / med['disarmed']:.3f}) in_memory="
          f"{med['in_memory'] * 1e3:.3f} flush_ms={flush_ms:.3f} "
          f"device_wait_ms="
          f"{wait_ms:.3f}" + (f" device_busy_ms={prof['device_busy_ms']:.3f}"
                              if prof else "") + " bit-equal", flush=True)
    print(f"[obs]   {label} --profile: {lines[0]} ... {lines[-1]} "
          f"({len(lines)} lines)", flush=True)
    return dict(counts=counts, rounds=wk.rounds, host_syncs=syncs_armed,
                wall_ms_armed=med["armed"] * 1e3,
                wall_ms_disarmed=med["disarmed"] * 1e3,
                wall_ms_in_memory=med["in_memory"] * 1e3, flush_ms=flush_ms,
                device_wait_ms=wait_ms,
                device_busy_ms=prof["device_busy_ms"] if prof else None)


def obs_session_phase(frag, device, tmp) -> dict:
    """An 8-lane sssp `ServeSession` on RMAT-20 with the [dyn] adds
    ingested every SERVE_INGEST_EVERY queries, armed, against the same
    session disarmed (byte-identical results; the lane K1 and the
    overlay fold launched); then a deadline storm through the same
    session's queue -- queries with 0-ms deadlines -- with the recorder's
    sink set, and `postmortem <bundle> --trace <trace>`, which must join
    the bundle's serve_query rows to the trace's."""
    import io

    from libgrape_lite_tpu_torch import cli, obs
    from libgrape_lite_tpu_torch.dyn import RepackPolicy
    from libgrape_lite_tpu_torch.obs.recorder import (
        DEADLINE_STORM_THRESHOLD,
        RECORDER,
    )
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    stream = [("sssp", {"source": s})
              for s in serve_sources(frag, SERVE_CLI_QUERIES)]
    adds = dyn_adds(frag)[0]

    def serve():
        sess = ServeSession(frag, policy=BatchPolicy(max_batch=SERVE_BATCH),
                            dyn=RepackPolicy())
        reqs = [sess.submit(a, kw) for a, kw in stream]
        res = cli.serve_with_ingest(sess, None, reqs, adds,
                                    SERVE_INGEST_EVERY)
        return sess, res

    obs_reset()
    _, plain = serve()
    frag.dyn_overlay = None
    trace = os.path.join(tmp, "serve.json")
    sink = os.path.join(tmp, "postmortem")
    obs.configure(trace_path=trace, metrics_path=os.path.join(tmp, "serve_m"))
    RECORDER.set_sink(sink)
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    sess, armed = serve()
    sync(device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    same_results(plain, armed, "[obs] the armed session")
    check(counts["gather_reduce_lanes"] > 0 and counts["overlay_fold"] > 0,
          f"[obs] the armed session launched {counts}")
    storm = [sess.submit("sssp", {"source": s}, deadline_s=0.0)
             for s in range(DEADLINE_STORM_THRESHOLD)]
    sess.drain()
    frag.dyn_overlay = None
    check(all(q.result is not None and not q.result.ok
              and q.result.error["reason"] == "deadline_expired"
              for q in storm), "[obs] the 0-ms deadlines did not expire")
    obs.flush()
    bundles = sorted(os.listdir(sink))
    check(len(bundles) == 1 and "deadline_storm" in bundles[0],
          f"[obs] the deadline storm wrote {bundles}")
    rows = host_spans(obs.load_trace(trace), "serve_batch")
    queries = [e for e in obs.load_trace(trace)
               if e.get("ph") == "X" and e["name"] == "serve_query"]
    check(len(queries) == len(stream), f"[obs] {len(queries)} serve_query "
          f"spans for {len(stream)} queries")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["postmortem", os.path.join(sink, bundles[0]),
                       "--trace", trace])
    report = buf.getvalue().strip().splitlines()
    check(rc == 0, f"[obs] postmortem --trace exited {rc}: {report[-1:]}")
    print(f"[obs] session rmat{SCALE} max_batch={SERVE_BATCH} ingest every "
          f"{SERVE_INGEST_EVERY}: queries={len(armed)} serve_batch="
          f"{len(rows)} serve_query={len(queries)} wall_s={wall:.4f} "
          f"launches={counts} byte-identical to disarmed", flush=True)
    print(f"[obs]   deadline storm: {len(storm)} expired, bundle "
          f"{bundles[0]}; postmortem: {report[0]} | {report[-1]}",
          flush=True)
    obs_reset()
    return {"obs session": dict(counts=counts, seconds=wall,
                                queries=len(armed))}


# the names the JAX package's exporter gives an armed 16-query sssp serve
# run (tests/test_torch_telemetry.py holds the port's scrape to the JAX
# one on the CPU)
OBS_SCRAPE_NAMES = (
    "grape_graph_edges", "grape_graph_vertices", "grape_queries_total",
    "grape_query_rounds", "grape_serve_admission_wait_seconds_bucket",
    "grape_serve_admission_wait_seconds_count",
    "grape_serve_admission_wait_seconds_sum", "grape_stats_pump_engaged",
    "grape_stats_recorder_dropped", "grape_stats_recorder_dumps",
    "grape_stats_recorder_recorded", "grape_stats_recorder_triggers",
    "grape_stats_registry", "grape_stats_slo_breaches",
    "grape_stats_slo_budget_frac", "grape_stats_slo_max_burn",
    "grape_stats_slo_observed", "grape_supersteps_total",
)


def obs_cli_phase(device, tmp) -> dict:
    """The CLI's obs flags on p2p-31: `run_app --trace --metrics
    --profile` (its per-round lines, spans and metrics); `serve` of
    SERVE_CLI_QUERIES sssp queries at max_batch SERVE_BATCH with
    --trace, --metrics and --metrics_port 0 (the endpoint scraped once
    over 127.0.0.1 for every name of OBS_SCRAPE_NAMES; one serve_query
    span a query; --dump_results equal to the disarmed run's); and
    `--replicas 2` armed (fleet_pump spans on both replicas)."""
    import io
    import urllib.request

    from libgrape_lite_tpu_torch import cli, obs
    from libgrape_lite_tpu_torch.obs import exporter
    from libgrape_lite_tpu_torch.utils import logging as glog

    out = {}
    p2p = ["--efile", os.path.join(HERE, "dataset", "p2p-31.e"),
           "--vfile", os.path.join(HERE, "dataset", "p2p-31.v")]
    obs_reset()
    trace = os.path.join(tmp, "run_app.json")
    err = io.StringIO()
    old = glog.vlog_level()
    reset_launch_counts()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(["--application", "sssp", *p2p, "--sssp_source",
                           "6", "--device", device, "--trace", trace,
                           "--metrics", os.path.join(tmp, "run_app_m"),
                           "--profile"])
    finally:
        glog.set_vlog_level(old)
    out["obs run_app"] = dict(counts=launch_counts())
    lines = [ln for ln in err.getvalue().splitlines()
             if "PEval: " in ln or "IncEval round " in ln]
    rounds = len(host_spans(obs.load_trace(trace), "superstep"))
    check(rc == 0 and rounds > 0 and len(lines) == rounds + 1,
          f"[obs] run_app --profile: rc {rc}, {len(lines)} lines for "
          f"{rounds} rounds")
    print(f"[obs] run_app sssp p2p-31 --trace --metrics --profile: "
          f"rounds={rounds} lines={len(lines)}: {lines[0]} | {lines[1]} "
          f"... {lines[-1]}", flush=True)

    def serve(extra, dump):
        buf = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["serve", *p2p, "--num_queries",
                           str(SERVE_CLI_QUERIES), "--max_batch",
                           str(SERVE_BATCH), "--dump_results", dump,
                           "--device", device, *extra])
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and rec["ok"] == SERVE_CLI_QUERIES,
              f"[obs] serve {extra}: {rec}")
        with open(dump) as f:
            return f.read(), launch_counts()

    obs_reset()
    plain, _ = serve([], os.path.join(tmp, "plain.txt"))
    trace = os.path.join(tmp, "serve_cli.json")
    armed, counts = serve(["--trace", trace, "--metrics",
                           os.path.join(tmp, "serve_cli_m"),
                           "--metrics_port", "0"],
                          os.path.join(tmp, "armed.txt"))
    out["obs serve cli"] = dict(counts=counts)
    exp = exporter.get_exporter()
    check(exp is not None and exp.url.startswith("http://127.0.0.1:"),
          "[obs] --metrics_port 0 started no exporter on 127.0.0.1")
    with urllib.request.urlopen(exp.url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    names = {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
             if ln and not ln.startswith("#")}
    missing = sorted(set(OBS_SCRAPE_NAMES) - names)
    check(not missing, f"[obs] the scrape lacks {missing}")
    queries = [e for e in obs.load_trace(trace)
               if e.get("ph") == "X" and e["name"] == "serve_query"]
    check(len(queries) == SERVE_CLI_QUERIES,
          f"[obs] {len(queries)} serve_query spans")
    check(armed == plain, "[obs] serve --trace --dump_results differ from "
          "the disarmed run's")
    print(f"[obs] serve p2p-31 {SERVE_CLI_QUERIES} sssp max_batch="
          f"{SERVE_BATCH} --trace --metrics --metrics_port 0: scraped "
          f"{exp.url}/metrics ({len(names)} names, all "
          f"{len(OBS_SCRAPE_NAMES)} of the JAX exporter's), serve_query="
          f"{len(queries)}, dumps equal to disarmed", flush=True)
    obs_reset()
    plain, _ = serve(["--replicas", "2"], os.path.join(tmp, "plain2.txt"))
    trace = os.path.join(tmp, "fleet_cli.json")
    armed, counts = serve(["--replicas", "2", "--trace", trace],
                          os.path.join(tmp, "armed2.txt"))
    out["obs fleet cli"] = dict(counts=counts)
    pumps = [e for e in obs.load_trace(trace)
             if e.get("ph") == "X" and e["name"] == "fleet_pump"]
    reps = sorted({e["args"]["replica"] for e in pumps})
    check(reps == [0, 1], f"[obs] fleet_pump spans on replicas {reps}")
    check(armed == plain, "[obs] serve --replicas 2 --trace dumps differ")
    print(f"[obs] serve --replicas 2 --trace: fleet_pump={len(pumps)} on "
          f"replicas {reps}, dumps equal to disarmed", flush=True)
    obs_reset()
    return out


def obs_phases(frag, device) -> dict:
    """[obs]: the main path armed (PageRank auto and SSSP on RMAT-20, the
    8-lane session with ingest, the deadline storm and its postmortem)
    and the CLI's obs flags on p2p-31; seconds in all."""
    import tempfile

    from libgrape_lite_tpu_torch.models import SSSP, PageRank

    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs["obs pagerank auto"] = obs_query_phase(
            "pagerank", frag, lambda: PageRank(spmv_mode="auto"), device,
            {"delta": 0.85, "max_round": PR_ROUNDS}, tmp)
        runs["obs sssp"] = obs_query_phase("sssp", frag, SSSP, device,
                                           {"source": 0}, tmp)
        runs.update(obs_session_phase(frag, device, tmp))
        runs.update(obs_cli_phase(device, tmp))
    secs = time.perf_counter() - t0
    print(f"[time] obs {secs:.1f} s", flush=True)
    return {"seconds": secs, "runs": runs}


# ---- phase 7e: fault tolerance and the guards ----

FT_EVERY = 2  # checkpoint cadence of the [ft] and [guard] runs
FT_KILL = "kill@4,mode=raise"
FT_CORRUPT = "corrupt@6,kill@7,mode=raise"  # resume falls back to round 4
GUARD_CORRUPT_AT = 4


def ft_apps():
    from libgrape_lite_tpu_torch.models import SSSP, PageRank

    return (("pagerank", lambda: PageRank(spmv_mode="auto"),
             {"delta": 0.85, "max_round": PR_ROUNDS}),
            ("sssp", SSSP, {"source": 0}))


def same_bits(wk, want, what: str) -> None:
    got = wk.result_values()
    check(got.dtype == want.dtype and got.tobytes() == want.tobytes(),
          f"{what}: not bit-equal to the plain query")


def span_ms(events, name: str) -> list:
    return [e["dur"] / 1e3 for e in events
            if e.get("ph") == "X" and e["name"] == name]


def killed_then_resumed(frag, factory, device, kw, spec, ckdir):
    """Run `kw` with checkpoints under the raise-mode fault `spec`, then
    `Worker.resume` from its lineage (armed in memory, to read the
    `resume` instant's round).  Returns (worker, checkpoint rounds left
    by the kill, the round resumed from)."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.ft.checkpoint import list_checkpoints
    from libgrape_lite_tpu_torch.ft.faults import FaultPlan, InjectedFault
    from libgrape_lite_tpu_torch.worker.worker import Worker

    try:
        Worker(factory(), frag).query(
            checkpoint_every=FT_EVERY, checkpoint_dir=ckdir,
            fault_plan=FaultPlan.from_spec(spec), **kw)
    except InjectedFault:
        pass
    else:
        check(False, f"[ft] {spec}: the query was not killed")
    left = [r for r, _ in list_checkpoints(ckdir)]
    obs_reset()
    obs.configure(in_memory=True)
    wk = Worker(factory(), frag)
    wk.resume(ckdir)
    sync(device)
    resumed = [e["args"]["round"] for e in obs.history()
               if e["name"] == "resume"]
    obs_reset()
    return wk, left, resumed[0] if resumed else None


def ft_query_phase(label, frag, factory, device, kw, tmp) -> dict:
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.ft.checkpoint import list_checkpoints

    obs_reset()
    plain = run_query(frag, factory(), device, **kw)[0]
    want = plain.result_values()
    ckdir = os.path.join(tmp, label, "ck")
    ck_kw = dict(kw, checkpoint_every=FT_EVERY, checkpoint_dir=ckdir)
    reset_launch_counts()
    wk = run_query(frag, factory(), device, **ck_kw)[0]
    counts = launch_counts()
    same_bits(wk, want, f"[ft] {label} checkpoint_every {FT_EVERY}")
    steps = list_checkpoints(ckdir)
    check(len(steps) == 2, f"[ft] {label}: {len(steps)} checkpoints kept")
    snap_bytes = os.path.getsize(os.path.join(steps[-1][1], "state.npz"))
    walls = {"plain": [], "checkpointed": []}
    for _ in range(3):
        walls["plain"].append(run_query(frag, factory(), device, **kw)[1])
        walls["checkpointed"].append(
            run_query(frag, factory(), device, **ck_kw)[1])
    med = {k: float(np.median(v)) * 1e3 for k, v in walls.items()}
    obs.configure(in_memory=True)
    run_query(frag, factory(), device, **ck_kw)
    ev = obs.history()
    obs_reset()
    save, write = span_ms(ev, "checkpoint_save"), span_ms(ev,
                                                          "checkpoint_write")
    check(len(save) == len(write) == wk.rounds // FT_EVERY + 1,
          f"[ft] {label}: {len(save)} saves, {len(write)} writes")
    host_syncs(frag, factory, device, kw)  # a first-use sync, if any
    syncs_plain = host_syncs(frag, factory, device, kw)
    syncs_ck = host_syncs(frag, factory, device, ck_kw)
    check(syncs_ck == syncs_plain, f"[ft] {label}: host syncs with "
          f"checkpoints {syncs_ck} != without {syncs_plain}")
    wk_k, left_k, from_k = killed_then_resumed(
        frag, factory, device, kw, FT_KILL, os.path.join(tmp, label, "kill"))
    same_bits(wk_k, want, f"[ft] {label} {FT_KILL} then resume")
    check(wk_k.rounds == plain.rounds and from_k == 4,
          f"[ft] {label}: resumed from {from_k}, rounds {wk_k.rounds}")
    kc, left_c, from_c = killed_then_resumed(
        frag, factory, device, kw, FT_CORRUPT,
        os.path.join(tmp, label, "corrupt"))
    same_bits(kc, want, f"[ft] {label} {FT_CORRUPT} then resume")
    check(left_c == [4, 6] and from_c == 4,
          f"[ft] {label}: {FT_CORRUPT} left {left_c}, resumed from "
          f"{from_c} (want 4)")
    print(f"[ft] {label}: rounds={wk.rounds} checkpoint_every={FT_EVERY} "
          f"snapshots={len(save)} bytes_a_snapshot={snap_bytes} wall_ms "
          f"median of 3 checkpointed={med['checkpointed']:.3f} plain="
          f"{med['plain']:.3f} (x{med['checkpointed'] / med['plain']:.3f}) "
          f"checkpoint_save_ms mean={np.mean(save):.3f} max="
          f"{max(save):.3f} checkpoint_write_ms mean={np.mean(write):.3f} "
          f"max={max(write):.3f} host_syncs={syncs_ck}={syncs_plain} "
          f"bit-equal; {FT_KILL}: kept {left_k}, resumed from {from_k}, "
          f"bit-equal; {FT_CORRUPT}: kept {left_c}, resumed from {from_c}, "
          f"bit-equal", flush=True)
    return dict(counts=counts, rounds=wk.rounds, snapshot_bytes=snap_bytes,
                wall_ms_checkpointed=med["checkpointed"],
                wall_ms_plain=med["plain"],
                checkpoint_save_ms=float(np.mean(save)),
                checkpoint_write_ms=float(np.mean(write)),
                host_syncs=syncs_ck, resumed_from=from_k,
                corrupt_resumed_from=from_c)


def ft_drill_phase(device, tmp) -> dict:
    """The port's fault drill through the CLI on p2p-31, on the card."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "libgrape_lite_tpu_torch.scripts.fault_drill",
         "--apps", "sssp", "--corrupt", "--device", device,
         "--workdir", os.path.join(tmp, "drill")],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    out = r.stdout + r.stderr
    check(r.returncode == 0 and "fault_drill: PASS" in r.stdout,
          f"[ft] fault_drill --apps sssp --corrupt failed (rc "
          f"{r.returncode}):\n{out[-3000:]}")
    check("(exit 17;" in r.stdout and "corrupted), resumed" in r.stdout,
          f"[ft] fault_drill: no exit-17 kill and corrupt fallback in\n"
          f"{r.stdout[-2000:]}")
    line = [ln for ln in r.stdout.splitlines() if "PASS:" in ln][-1]
    print(f"[ft] cli drill p2p-31 fnum 2 ({secs:.1f} s): {line}", flush=True)
    return dict(counts={}, seconds=secs)


def ft_phases(frag, device) -> dict:
    """[ft]: checkpoints, kill/resume and the corrupt-shard fallback on
    RMAT-20, then the CLI drill on p2p-31; seconds in all."""
    import tempfile

    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, factory, kw in ft_apps():
            runs[f"ft {label}"] = ft_query_phase(label, frag, factory,
                                                 device, kw, tmp)
        runs["ft cli drill"] = ft_drill_phase(device, tmp)
    secs = time.perf_counter() - t0
    return {"seconds": secs, "runs": runs}


def guard_query_phase(label, frag, factory, device, kw, tmp) -> dict:
    from libgrape_lite_tpu_torch.ft.faults import FaultPlan
    from libgrape_lite_tpu_torch.worker.worker import Worker

    plain = run_query(frag, factory(), device, **kw)[0]
    want = plain.result_values()
    g_kw = dict(kw, guard="halt")
    reset_launch_counts()
    wk = run_query(frag, factory(), device, **g_kw)[0]
    counts = launch_counts()
    rep = wk.guard_report
    same_bits(wk, want, f"[guard] {label} halt")
    check(not rep["breaches"] and rep["probes"] == plain.rounds + 1,
          f"[guard] {label} halt with no fault: breaches "
          f"{[b['verdict'] for b in rep['breaches']]}, probes "
          f"{rep['probes']}")
    heal = Worker(factory(), frag)
    sync(device)
    t0 = time.perf_counter()
    heal.query(checkpoint_every=FT_EVERY,
               checkpoint_dir=os.path.join(tmp, label),
               guard="rollback",
               fault_plan=FaultPlan(corrupt_carry_at=GUARD_CORRUPT_AT), **kw)
    sync(device)
    heal_s = time.perf_counter() - t0
    hrep = heal.guard_report
    same_bits(heal, want, f"[guard] {label} corrupt_carry@"
              f"{GUARD_CORRUPT_AT} rollback")
    check(hrep["rollbacks"] == 1 and len(hrep["breaches"]) == 1
          and hrep["breaches"][0]["round"] == GUARD_CORRUPT_AT
          and heal.rounds == plain.rounds,
          f"[guard] {label}: rollbacks {hrep['rollbacks']}, breaches at "
          f"{[b['round'] for b in hrep['breaches']]}, rounds {heal.rounds}")
    failed = sorted(hrep["breaches"][0]["verdict"]["failed"])
    walls = {"plain": [], "guarded": []}
    for _ in range(3):
        walls["plain"].append(run_query(frag, factory(), device, **kw)[1])
        walls["guarded"].append(run_query(frag, factory(), device,
                                          **g_kw)[1])
    med = {k: float(np.median(v)) * 1e3 for k, v in walls.items()}
    host_syncs(frag, factory, device, kw)  # a first-use sync, if any
    syncs_plain = host_syncs(frag, factory, device, kw)
    syncs_g = host_syncs(frag, factory, device, g_kw)
    check(syncs_g == syncs_plain + rep["probes"]
          or torch.device(device).type != "cuda",  # no syncs counted
          f"[guard] {label}: {syncs_g - syncs_plain} host syncs for "
          f"{rep['probes']} probes (one read a probe)")
    extra = ""
    if label == "pagerank":
        rank = wk._result_state["rank"]
        extra = (f" mass_err={abs(float(rank.double().sum()) - 1.0):.3e} "
                 f"(mass_rtol {factory().mass_rtol:g})")
    print(f"[guard] {label}: rounds={wk.rounds} halt no fault: probes="
          f"{rep['probes']} breaches=0 bit-equal{extra}; corrupt_carry@"
          f"{GUARD_CORRUPT_AT} rollback: breach at "
          f"{hrep['breaches'][0]['round']} {failed}, rollbacks=1, "
          f"{heal_s * 1e3:.3f} ms, bit-equal; wall_ms median of 3 guarded="
          f"{med['guarded']:.3f} plain={med['plain']:.3f} (x"
          f"{med['guarded'] / med['plain']:.3f}) host_syncs guarded="
          f"{syncs_g} plain={syncs_plain} (+{syncs_g - syncs_plain} for "
          f"{rep['probes']} probes)", flush=True)
    return dict(counts=counts, rounds=wk.rounds, probes=rep["probes"],
                wall_ms_guarded=med["guarded"], wall_ms_plain=med["plain"],
                host_syncs_guarded=syncs_g, host_syncs_plain=syncs_plain,
                heal_ms=heal_s * 1e3, failed=failed)


def guard_phases(frag, device) -> dict:
    """[guard]: sssp, pagerank and wcc on RMAT-20 guarded (halt, no fault)
    and self-healing (corrupt_carry under rollback); seconds in all."""
    import tempfile

    from libgrape_lite_tpu_torch.models import WCC

    t0 = time.perf_counter()
    runs = {}
    apps = ft_apps() + (("wcc", WCC, {}),)
    with tempfile.TemporaryDirectory() as tmp:
        for label, factory, kw in apps:
            runs[f"guard {label}"] = guard_query_phase(
                label, frag, factory, device, kw, tmp)
    secs = time.perf_counter() - t0
    return {"seconds": secs, "runs": runs}


# ---- phase 11g: guarded serving -------------------------------------------

GUARD_POISON_LANE = 3  # the lane corrupt_carry poisons in [guard] serve
GUARD_PUMP_WINDOW = 4


def call_syncs(fn, device) -> int:
    """Run `fn()` and count its host synchronisations, as CUDA's
    sync-debug mode reports them (0 off the card: no sync-debug mode)."""
    if torch.device(device).type != "cuda":
        fn()
        return 0
    sync(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def p2p_stream(tmp) -> str:
    """A 16-query sssp and bfs stream over p2p-31 sources."""
    path = os.path.join(tmp, "guard_stream.txt")
    with open(path, "w") as f:
        for s in (6, 17, 3, 42, 11, 12, 13, 14):
            f.write(f"sssp {s}\nbfs {s}\n")
    return path


def guard_serve_cli_phase(device, tmp) -> dict:
    """`serve --guard halt --replicas 2 --tenants by_app` on p2p-31 at
    fnum 1 and 4 against the unguarded single-session run, then the
    postmortem drill in a child process."""
    import io

    from libgrape_lite_tpu_torch import cli

    stream = p2p_stream(tmp)
    data = os.path.join(HERE, "dataset")
    out = {}
    for fnum in (1, 4):
        dumps = []
        for extra in ([], ["--guard", "halt", "--replicas", "2",
                           "--tenants", "by_app"]):
            dump = os.path.join(tmp, f"g{fnum}_{len(extra)}.txt")
            buf = io.StringIO()
            reset_launch_counts()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["serve", "--efile",
                               os.path.join(data, "p2p-31.e"), "--vfile",
                               os.path.join(data, "p2p-31.v"), "--fnum",
                               str(fnum), "--stream", stream, "--max_batch",
                               str(SERVE_BATCH), "--dump_results", dump,
                               "--device", device, *extra])
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            check(rc == 0 and rec["failed"] == 0,
                  f"[guard] serve cli fnum {fnum} {extra}: {rec}")
            with open(dump) as f:
                dumps.append(f.read())
            out[f"guard serve cli fnum{fnum}"
                + (" guarded" if extra else "")] = dict(
                counts=launch_counts(), qps=rec["qps"])
        check(dumps[0] == dumps[1], f"[guard] serve cli fnum {fnum}: "
              "--guard halt fleet dumps differ from the unguarded run")
        print(f"[guard] serve cli fnum={fnum}: --guard halt --replicas 2 "
              "--tenants by_app --dump_results equal to the unguarded run",
              flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "libgrape_lite_tpu_torch.scripts.fault_drill",
         "--postmortem", "--device", device, "--workdir",
         os.path.join(tmp, "pm_drill")],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(r.returncode == 0 and "[postmortem] PASS" in r.stdout,
          f"[guard] fault_drill --postmortem failed (rc {r.returncode}):\n"
          f"{(r.stdout + r.stderr)[-3000:]}")
    line = [ln for ln in r.stdout.splitlines() if "PASS:" in ln][-1]
    print(f"[guard] postmortem drill ({secs:.1f} s): {line}", flush=True)
    out["guard serve postmortem drill"] = dict(counts={}, seconds=secs)
    return out


def guard_serve_phase(frag, device) -> dict:
    """[guard] serve: a guarded 8-lane sssp batch on RMAT-20 against the
    unguarded batch and the sequential queries, one poisoned lane alone
    and mid-window, the syncs and walls; then the CLI and the drill."""
    import tempfile

    from libgrape_lite_tpu_torch.ft.faults import FaultPlan
    from libgrape_lite_tpu_torch.guard.config import GuardConfig
    from libgrape_lite_tpu_torch.models import SSSP
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession
    from libgrape_lite_tpu_torch.serve import batch as sb
    from libgrape_lite_tpu_torch.worker.worker import Worker

    t_phase = time.perf_counter()
    lanes = [{"source": s} for s in serve_sources(frag, SERVE_BATCH)]
    seq = []
    for a in lanes:
        wk = run_query(frag, SSSP(), device, **a)[0]
        seq.append((wk.result_values(), wk.rounds))

    def batch(guard=None, hook=None):
        wk = Worker(SSSP(), frag)
        if hook is None:
            wk.query_batch(lanes, guard=guard)
        else:
            sb.run_guarded_batch(wk, lanes, 0, GuardConfig.resolve(guard),
                                 chunk_hook=hook)
        return wk

    wk_u, counts_u, _ = timed_counted(batch, device)
    wk_g, counts_g, _ = timed_counted(lambda: batch("halt"), device)
    rounds = int(wk_g.batch_rounds.max())
    check(wk_g.batch_breaches == [None] * len(lanes),
          f"[guard] serve: a clean batch breached {wk_g.batch_breaches}")
    for b, (vals, r) in enumerate(seq):
        got = wk_g.batch_result_values(b)
        check(int(wk_g.batch_rounds[b]) == r and np.array_equal(got, vals)
              and np.array_equal(got, wk_u.batch_result_values(b)),
              f"[guard] serve: guarded lane {b} not bit-equal to the "
              "unguarded batch and its sequential query")
    check(counts_g["gather_reduce_lanes"] == rounds
          and counts_g["gather_reduce"] == 0,
          f"[guard] serve: {counts_g} in {rounds} rounds (one lane K1 "
          "launch a round)")
    walls = {"plain": [], "guarded": []}
    for _ in range(3):
        for key, g in (("plain", None), ("guarded", "halt")):
            sync(device)
            t0 = time.perf_counter()
            batch(g)
            sync(device)
            walls[key].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) * 1e3 for k, v in walls.items()}
    before = dict(sb.GUARDED_BATCH_STATS)
    batch("halt")
    bounds = sb.GUARDED_BATCH_STATS["boundaries"] - before["boundaries"]
    probe_ms = ((sb.GUARDED_BATCH_STATS["probe_s"] - before["probe_s"])
                / max(bounds, 1) * 1e3)
    call_syncs(batch, device)  # a first-use sync, if any
    syncs_u = call_syncs(batch, device)
    syncs_g = call_syncs(lambda: batch("halt"), device)
    check(bounds == rounds + 1 and (syncs_g == syncs_u + bounds
                                    or torch.device(device).type != "cuda"),
          f"[guard] serve: {syncs_g} host syncs guarded, {syncs_u} "
          f"unguarded, for {bounds} chunk boundaries (one read a "
          "boundary, not a lane)")

    # corrupt_carry@4 on one lane
    reset_launch_counts()
    wk_c = batch("halt", hook=sb.lane_fault_hook(
        FaultPlan(corrupt_carry_at=GUARD_CORRUPT_AT), GUARD_POISON_LANE))
    counts_c = launch_counts()
    br = wk_c.batch_breaches
    check([b for b in range(len(lanes)) if br[b] is not None]
          == [GUARD_POISON_LANE]
          and br[GUARD_POISON_LANE]["verdict"]["kind"] == "invariant"
          and br[GUARD_POISON_LANE]["round"] == GUARD_CORRUPT_AT,
          f"[guard] serve: corrupt_carry@{GUARD_CORRUPT_AT} on lane "
          f"{GUARD_POISON_LANE} breached {br}")
    for b, (vals, _) in enumerate(seq):
        if b != GUARD_POISON_LANE:
            check(np.array_equal(wk_c.batch_result_values(b), vals),
                  f"[guard] serve: lane {b} perturbed by lane "
                  f"{GUARD_POISON_LANE}'s breach")
    check(counts_c["gather_reduce_lanes"] == int(wk_c.batch_rounds.max()),
          f"[guard] serve: poisoned batch {counts_c} (one lane K1 launch "
          "a round, the frozen lane's pull discarded)")

    # the same breach in the middle batch of a W 4 window
    orig = sb.guarded_lane_loop

    def poisoned(app, frag_, state, eph, mr, k, cfg, chunk_hook=None):
        return orig(app, frag_, state, eph, mr, k, cfg,
                    chunk_hook=sb.lane_fault_hook(
                        FaultPlan(corrupt_carry_at=GUARD_CORRUPT_AT),
                        GUARD_POISON_LANE))

    with mock.patch.object(sb, "guarded_lane_loop", poisoned):
        sess = ServeSession(frag, apps={"sssp": SSSP},
                            policy=BatchPolicy(max_batch=SERVE_BATCH))
        pump = sess.async_pump(window=GUARD_PUMP_WINDOW)
        head = [sess.submit("sssp", a) for a in lanes]
        mid = [sess.submit("sssp", a, guard="halt") for a in lanes]
        tail = [sess.submit("sssp", a) for a in reversed(lanes)]
        reset_launch_counts()
        pump.drain()
        counts_p = launch_counts()
    want = [v for v, _ in seq]
    check(pump.stats["max_inflight"] >= 3,
          f"[guard] serve pump: window held {pump.stats['max_inflight']}")
    check(not mid[GUARD_POISON_LANE].result.ok
          and mid[GUARD_POISON_LANE].result.error["round"]
          == GUARD_CORRUPT_AT,
          "[guard] serve pump: the poisoned lane did not fail with its "
          "bundle")
    for reqs, vals in ((head, want), (mid, want), (tail, want[::-1])):
        for b, (req, v) in enumerate(zip(reqs, vals)):
            if reqs is mid and b == GUARD_POISON_LANE:
                continue
            check(req.result.ok and np.array_equal(req.result.values, v),
                  f"[guard] serve pump W{GUARD_PUMP_WINDOW}: a query next "
                  "to the breach is not bit-equal")
    print(f"[guard] serve rmat{SCALE} {len(lanes)} sssp lanes: rounds="
          f"{rounds} halt no fault bit-equal (unguarded batch and sequential)"
          f"; wall_ms median of 3 guarded={med['guarded']:.3f} unguarded="
          f"{med['plain']:.3f} (x{med['guarded'] / med['plain']:.3f}); "
          f"probe_ms a chunk boundary={probe_ms:.3f} ({bounds} boundaries)"
          f"; host_syncs guarded={syncs_g} unguarded={syncs_u} "
          f"(+{syncs_g - syncs_u}); lane K1 launches="
          f"{counts_g['gather_reduce_lanes']}; corrupt_carry@"
          f"{GUARD_CORRUPT_AT} lane "
          f"{GUARD_POISON_LANE}: breach alone "
          f"{sorted(br[GUARD_POISON_LANE]['verdict']['failed'])}, 7 lanes "
          f"bit-equal; pump W{GUARD_PUMP_WINDOW} mid-window breach isolated "
          f"(max_inflight {pump.stats['max_inflight']})", flush=True)
    runs = {"guard serve batch": dict(
        counts=counts_g, rounds=rounds, wall_ms_guarded=med["guarded"],
        wall_ms_plain=med["plain"], probe_ms=probe_ms, boundaries=bounds,
        host_syncs_guarded=syncs_g, host_syncs_plain=syncs_u),
        "guard serve poisoned": dict(counts=counts_c),
        "guard serve pump": dict(counts=counts_p)}
    with tempfile.TemporaryDirectory() as tmp:
        runs.update(guard_serve_cli_phase(device, tmp))
    return {"seconds": time.perf_counter() - t_phase, "runs": runs}


# ---- phase 11h: the 2-D vertex cut -----------------------------------------

VC_FNUMS = (4, 16)  # k 2 and 4
VC_APPS = (("sssp", {"source": 0}), ("bfs", {"source": 0}), ("wcc", {}))


def vc_by_oid(wk, n: int) -> np.ndarray:
    """A vertex-cut result by oid 0..n-1 (the masters' rows in order)."""
    vals = wk.result_values()
    frag = wk.fragment
    out = np.concatenate([vals[f, :frag.inner_vertices_num(f)]
                          for f in range(frag.fnum)])
    check(len(out) == n, "vertex-cut masters do not cover the vertices")
    return out


def vc_k1_case(label, side, w, x, kind, device) -> dict:
    """One tile pull's K1 call against its plain version on `x`.  The
    bound counts what the kernel must move once: indptr, nbr (and w) a
    edge, x once, y once.  Library: one PyTorch call of the same function,
    as the 1-D K1 rows take it: a sparse CSR product for the sum,
    segment_reduce (f32) or scatter_reduce_ (int32) over the candidates,
    gathered outside the timed call, for the min."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    got = spmv.gather_reduce(side.indptr, side.nbr, w, x, kind)
    if kind == "sum":
        want = spmv.gather_reduce_plain(side.indptr, side.nbr, None,
                                        x.double(), "sum")
        sabs = spmv.gather_reduce_plain(side.indptr, side.nbr, None,
                                        x.abs().double(), "sum")
        err = check_sum(got, want, sabs, f"[vc] {label} K1 sum")
    else:
        want = spmv.gather_reduce_plain(side.indptr, side.nbr, w, x, kind)
        check(torch.equal(got, want), f"[vc] {label} K1 {kind} not "
              "bit-equal to its plain version")
        err = 0.0
    edges = int(side.indptr[0, -1])
    rows = side.indptr.shape[1] - 1
    per_edge = 2 if w is not None else 1
    nbytes = (side.indptr.nbytes + 4 * per_edge * edges
              + x.numel() * x.element_size() + rows * x.element_size())
    b_ms, b_by = bound(nbytes, per_edge * edges)
    ip = side.indptr[0].to(torch.int64)
    idx = side.nbr[0, :edges].to(torch.int64)
    if kind == "sum":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "beta state"
            csr = torch.sparse_csr_tensor(
                ip, idx, torch.ones(edges, dtype=x.dtype, device=x.device),
                size=(rows, x.numel()), check_invariants=False)
        library = lambda: csr @ x  # noqa: E731
    else:
        cand = x[idx] + (w[0, :edges] if w is not None else 0)
        if x.is_floating_point():
            deg = ip[1:] - ip[:-1]
            library = lambda: torch.segment_reduce(  # noqa: E731
                cand, "min", lengths=deg, unsafe=True,
                initial=float("inf"))
        else:
            seg = torch.repeat_interleave(
                torch.arange(rows, device=x.device), ip[1:] - ip[:-1])
            acc = torch.empty(rows, dtype=x.dtype, device=x.device)
            library = lambda: acc.fill_(INT32_MAX).scatter_reduce_(  # noqa
                0, seg, cand, "amin")
    ms = time_ms(lambda: spmv.gather_reduce(side.indptr, side.nbr, w, x,
                                            kind), device, 10)
    plain_ms = time_ms(lambda: spmv.gather_reduce_plain(
        side.indptr, side.nbr, w, x, kind), device, 3, batch=1)
    lib_ms = time_ms(library, device, 10)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, edges=edges, rows=rows)


def vc_build(fnum, src, dst, w, n, sym, device):
    from libgrape_lite_tpu_torch.fragment.vertexcut import (
        ImmutableVertexcutFragment,
    )
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec

    sync(device)
    t0 = time.perf_counter()
    f = ImmutableVertexcutFragment.build(
        CommSpec(fnum=fnum, device=device), np.arange(n, dtype=np.int64),
        src, dst, w, edata_dtype=np.float32, directed=False,
        symmetrize=sym)
    sync(device)
    secs = time.perf_counter() - t0
    st = f.tile_stats()
    print(f"[vc] build rmat{SCALE} k={f.k} {'symmetrised' if sym else 'raw'}"
          f": host_s={secs:.2f} vc={f.vc} edges="
          f"{sum(t['edges'] for t in st['per_tile'])} max_tile_edges="
          f"{st['max_tile_edges']} tile_skew={st['tile_skew']} "
          f"pad_waste_frac={st['pad_waste_frac']} (a [k^2, Ep] COO stack; "
          "the card holds the concatenated CSR)", flush=True)
    return f, secs, st


def vc_app_runs(k, fs, fr, frag, e_sym, n, device) -> dict:
    """sssp_vc, bfs_vc, wcc_vc on the symmetrised tiles and pagerank_vc,
    pagerank_vc_rep on the raw ones against the 1-D twins on `frag`."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY, PageRank

    out, cases = {}, {}
    for name, kw in VC_APPS:
        wk2, counts, secs2 = counted(fs, APP_REGISTRY[name + "_vc"], device,
                                     kw)
        wk1, _, secs1 = counted(frag, APP_REGISTRY[name], device, kw)
        one = wk1.result_values()[0, :n]
        check(np.array_equal(vc_by_oid(wk2, n), one)
              and wk2.rounds == wk1.rounds,
              f"[vc] {name}_vc k {k} not bit-equal to the 1-D {name}")
        check(counts["gather_reduce"] == wk2.rounds > 0,
              f"[vc] {name}_vc k {k}: {counts} in {wk2.rounds} rounds (one "
              "K1 launch a tile pull)")
        x = wk2._result_state[wk2.app.state_key]
        w = fs.dev.ie.w.to(x.dtype) if name == "sssp" else None
        cases[f"{name}_vc k{k}"] = vc_k1_case(f"{name}_vc k{k}", fs.dev.ie,
                                              w, x, "min", device)
        out[f"vc {name} k{k}"] = dict(
            counts=counts, rounds=wk2.rounds, seconds=secs2,
            mteps=e_sym / secs2 / 1e6, twin_seconds=secs1,
            twin_mteps=e_sym / secs1 / 1e6)
        print(f"[vc] {name}_vc k={k}: rounds={wk2.rounds} seconds="
              f"{secs2:.4f} mteps={e_sym / secs2 / 1e6:.1f} beside 1-D "
              f"{name} seconds={secs1:.4f} mteps={e_sym / secs1 / 1e6:.1f}; "
              f"bit-equal by oid; K1 launches={counts['gather_reduce']}",
              flush=True)
    kw = {"max_round": PR_ROUNDS}
    wk1, _, secs1 = counted(frag, PageRank, device, kw)
    one = wk1.result_values()[0, :n].astype(np.float64)
    for name in ("pagerank_vc", "pagerank_vc_rep"):
        wk2, counts, secs2 = counted(fr, APP_REGISTRY[name], device, kw)
        got = vc_by_oid(wk2, n).astype(np.float64)
        nz = one != 0
        rel = float((np.abs(got - one)[nz] / np.abs(one[nz])).max())
        check(rel <= 1e-4 and np.isfinite(got).all(),
              f"[vc] {name} k {k}: {rel:.3e} relative off 1-D pagerank")
        check(counts["gather_reduce"] == 2 * wk2.rounds > 0,
              f"[vc] {name} k {k}: {counts} in {wk2.rounds} rounds (two "
              "K1 launches a round)")
        out[f"vc {name} k{k}"] = dict(
            counts=counts, rounds=wk2.rounds, seconds=secs2,
            mteps=e_sym * wk2.rounds / secs2 / 1e6, twin_seconds=secs1,
            twin_mteps=e_sym * wk1.rounds / secs1 / 1e6, max_rel_err=rel)
        print(f"[vc] {name} k={k}: rounds={wk2.rounds} seconds={secs2:.4f}"
              f" mteps={e_sym * wk2.rounds / secs2 / 1e6:.1f} beside 1-D "
              f"pagerank seconds={secs1:.4f} mteps="
              f"{e_sym * wk1.rounds / secs1 / 1e6:.1f}; max_rel_err={rel:.3e}"
              f"; K1 launches={counts['gather_reduce']}", flush=True)
        if name == "pagerank_vc":
            rank = wk2._result_state["rank_col"]
            for side in ("ie", "oe"):
                cases[f"pagerank_vc {side} k{k}"] = vc_k1_case(
                    f"pagerank_vc {side} k{k}", getattr(fr.dev, side),
                    None, rank, "sum", device)
    for label, c in cases.items():
        print(f"[vc] K1 {label}: edges={c['edges']} rows={c['rows']} "
              f"max_abs_err={c['max_abs_err']:.3e} ms={c['ms']:.4f} "
              f"plain_ms={c['plain_ms']:.4f} library_ms="
              f"{c['library_ms']:.4f} bound_ms={c['bound_ms']:.4f} "
              f"({c['bound_by']})", flush=True)
    return out, cases


def vc_k2_extras(fs, frag, n, device, tmp) -> dict:
    """At k 2: the 8-lane sssp_vc session, kill and resume, the bytes."""
    from libgrape_lite_tpu_torch.fleet.budget import fragment_bytes
    from libgrape_lite_tpu_torch.models import SSSPVC2D
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    out = {}
    sources = serve_sources(frag, SERVE_BATCH)
    seq = [run_query(fs, SSSPVC2D(), device, source=s)[0].result_values()
           for s in sources]
    sess = ServeSession(fs, apps={"sssp_vc": SSSPVC2D},
                        policy=BatchPolicy(max_batch=SERVE_BATCH))
    sess.serve([("sssp_vc", {"source": sources[0]})] * 2)  # warm-up
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    res = sess.serve([("sssp_vc", {"source": s}) for s in sources])
    sync(device)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    check(all(r.ok and np.array_equal(r.values, v)
              for r, v in zip(res, seq)),
          "[vc] the 8-lane sssp_vc session is not bit-equal to its "
          "sequential queries")
    rounds = max(r.rounds for r in res)
    check(counts["gather_reduce_lanes"] == rounds
          and counts["gather_reduce"] == 0,
          f"[vc] sssp_vc session: {counts} in {rounds} rounds (one lane K1 "
          "launch a round)")
    out["vc sssp session k2"] = dict(counts=counts, seconds=secs,
                                     rounds=rounds)
    ref = seq[0]
    wk, left, resumed = killed_then_resumed(
        fs, SSSPVC2D, device, {"source": sources[0]}, FT_KILL,
        os.path.join(tmp, "vc_ck"))
    check(np.array_equal(wk.result_values(), ref) and left == [2, 4],
          f"[vc] sssp_vc kill@4 resume: checkpoints {left}, resumed from "
          f"{resumed}, not bit-equal")
    placed = [t for t in (fs.dev.ie.indptr, fs.dev.ie.nbr, fs.dev.ie.w,
                          fs.dev.vmask) if t is not None]
    if fs.dev.oe is not None:
        placed += [fs.dev.oe.indptr, fs.dev.oe.nbr, fs.dev.oe.w]
    priced = fragment_bytes(fs)
    check(priced == sum(t.nbytes for t in placed),
          f"[vc] fragment_bytes {priced} != the placed tensors' "
          f"{sum(t.nbytes for t in placed)}")
    sess.release_device()
    sync(device)
    m0 = torch.cuda.memory_allocated() if device == "cuda" else 0
    t0 = time.perf_counter()
    sess.restore_device()
    sync(device)
    restore_s = time.perf_counter() - t0
    grew = (torch.cuda.memory_allocated() if device == "cuda" else 0) - m0
    again = sess.serve([("sssp_vc", {"source": sources[0]})])
    check(again[0].ok and np.array_equal(again[0].values, ref),
          "[vc] sssp_vc after release and restore not bit-equal")
    print(f"[vc] k=2 session of {SERVE_BATCH} sssp_vc lanes: {secs:.4f} s, "
          f"{rounds} rounds, lane K1 launches="
          f"{counts['gather_reduce_lanes']}, bit-equal to sequential; "
          f"kill@4 resumed from round {resumed} bit-equal; fragment_bytes="
          f"{priced} = placed tensors; restore_device {restore_s:.3f} s, "
          f"memory_allocated +{grew}", flush=True)
    out["vc sssp resume k2"] = dict(counts={}, resumed_from=resumed)
    out["vc bytes k2"] = dict(counts={}, fragment_bytes=priced,
                              restore_s=restore_s, allocated_delta=grew)
    return out


def vc_cli_phase(device) -> None:
    """p2p-31 through `run_app`: --vc pagerank and GRAPE_PARTITION=2d
    sssp, bfs and wcc against the goldens; a delta run's decline."""
    from libgrape_lite_tpu_torch.fragment.partition import PARTITION_STATS
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app

    golden_phase(device, names=["pagerank"], tag="vc --vc",
                 extra_args={"vc": True})
    data = os.path.join(HERE, "dataset")
    with mock.patch.dict(os.environ, {"GRAPE_PARTITION": "2d"}):
        golden_phase(device, names=["sssp", "bfs", "wcc"],
                     tag="vc GRAPE_PARTITION=2d")
        check(PARTITION_STATS["last_decision"]["engaged"],
              "[vc] GRAPE_PARTITION=2d did not engage the vertex cut")
        wk = run_app(QueryArgs(
            application="bfs", bfs_source=6,
            efile=os.path.join(data, "p2p-31.e.mutable_base"),
            vfile=os.path.join(data, "p2p-31.v"), fnum=4, device=device,
            delta_efile=os.path.join(data, "p2p-31.e.mutable_delta")))
        d = PARTITION_STATS["last_decision"]
        check(not d["engaged"] and "delta-mutation" in d["reason"]
              and wk.app.mesh_kind == "frag",
              f"[vc] a --delta_efile run under GRAPE_PARTITION=2d: {d}")
    print(f"[vc] --delta_efile under GRAPE_PARTITION=2d: declined, "
          f"\"{d['reason']}\"; ran 1-D", flush=True)


def vc_phases(frag, e_sym, device) -> dict:
    """[vc]: the vertex cut at k 2 and 4 on RMAT-20, then p2p-31."""
    import tempfile

    t_phase = time.perf_counter()
    src, dst, w = frag.edge_list
    n = frag.dev.total_vnum
    runs, cases, builds, keep = {}, {}, {}, {}
    pipe = {"runs": {}, "k1": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for fnum in VC_FNUMS:
            fs, s_sym, st = vc_build(fnum, src, dst, w, n, True, device)
            fr, s_raw, _ = vc_build(fnum, src, dst, None, n, False, device)
            k = fs.k
            builds[f"k{k}"] = dict(host_s_sym=s_sym, host_s_raw=s_raw,
                                   tile_skew=st["tile_skew"],
                                   pad_waste_frac=st["pad_waste_frac"],
                                   max_tile_edges=st["max_tile_edges"])
            r, c = vc_app_runs(k, fs, fr, frag, e_sym, n, device)
            runs.update(r)
            cases.update(c)
            if k == 2:
                runs.update(vc_k2_extras(fs, frag, n, device, tmp))
            got = pipe_vc_runs(fs, device)  # reported in [pipeline]
            pipe["runs"].update(got["runs"])
            pipe["k1"].update(got["k1"])
            from libgrape_lite_tpu_torch.models import SSSPVC2D

            runs[f"vc sssp profile k{k}"] = dict(counts={}, **profile_call(
                f"[vc] sssp_vc k={k}",
                lambda: run_query(fs, SSSPVC2D(), device, source=0)[1]))
            if k == 2:  # [dist] (i) runs them under a process group
                keep = {"sym": fs, "raw": fr}
            del fs, fr
    vc_cli_phase(device)
    return {"seconds": time.perf_counter() - t_phase, "runs": runs,
            "k1": cases, "builds": builds, "pipeline": pipe, "frags": keep}


# ---- phase 7j: exchange and overlap (the pipelined superstep) ----------

PIPE_FNUM = 4
PIPE_REPEATS = 3
PIPE_APPS = (("sssp", {"source": 0}), ("bfs", {"source": 0}), ("wcc", {}),
             ("cdlp", {"max_round": CDLP_ROUNDS}))
PIPE_K1 = {"sssp": (1, 2), "bfs": (1, 2), "wcc": (1, 2), "cdlp": (0, 0),
           "sssp_vc": (1, 2)}  # K1 launches a round: serial, pipelined


@contextlib.contextmanager
def env_set(**kv):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pipe_fragment(frag, device, fnum: int = PIPE_FNUM):
    """RMAT-20's edge list as a 1-D edge cut at fnum 4 (or `fnum`) under
    the hash partitioner (a random partition: nearly every vertex with an
    edge is read by another fragment)."""
    from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.vertex_map.partitioner import HashPartitioner
    from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

    src, dst, w = frag.edge_list
    oids = np.arange(frag.dev.total_vnum, dtype=np.int64)
    sync(device)
    t0 = time.perf_counter()
    f4 = ShardedEdgecutFragment.build(
        CommSpec(fnum=fnum, device=device),
        VertexMap.build(oids, HashPartitioner(fnum)), src, dst, w,
        directed=False)
    sync(device)
    return f4, time.perf_counter() - t0


def pipe_k1_case(label, indptr, nbr, w, x, device) -> dict:
    """One split K1 CSR of a pipelined round (stacked [fnum, vp + 1],
    the other part's rows empty, columns into the splice table) against
    its plain version on `x`, kind min.  Library: segment_reduce (float)
    or scatter_reduce_ (int32) over the candidates, gathered outside the
    timed call."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    got = spmv.gather_reduce(indptr, nbr, w, x, "min")
    want = spmv.gather_reduce_plain(indptr, nbr, w, x, "min")
    check(torch.equal(got, want), f"[pipeline] K1 {label} not bit-equal "
          "to its plain version")
    fnum, rows = indptr.shape[0], indptr.shape[1] - 1
    ip = indptr.to(torch.int64)
    real = (torch.arange(nbr.shape[1], device=x.device).unsqueeze(0)
            < ip[:, -1:])
    edges = int(real.sum())
    per_edge = 2 if w is not None else 1
    nbytes = (indptr.nbytes + 4 * per_edge * edges
              + x.numel() * x.element_size() + fnum * rows * x.element_size())
    b_ms, b_by = bound(nbytes, per_edge * edges)
    cand = x[nbr[real].to(torch.int64)] + (w[real] if w is not None else 0)
    deg = (ip[:, 1:] - ip[:, :-1]).reshape(-1)
    if x.is_floating_point():
        library = lambda: torch.segment_reduce(  # noqa: E731
            cand, "min", lengths=deg, unsafe=True, initial=float("inf"))
    else:
        seg = torch.repeat_interleave(
            torch.arange(fnum * rows, device=x.device), deg)
        acc = torch.empty(fnum * rows, dtype=x.dtype, device=x.device)
        library = lambda: acc.fill_(INT32_MAX).scatter_reduce_(  # noqa
            0, seg, cand, "amin")
    ms = time_ms(lambda: spmv.gather_reduce(indptr, nbr, w, x, "min"),
                 device, 10)
    plain_ms = time_ms(lambda: spmv.gather_reduce_plain(
        indptr, nbr, w, x, "min"), device, 3, batch=1)
    lib_ms = time_ms(library, device, 10)
    out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, edges=edges,
               rows=fnum * rows)
    print(f"[pipeline] K1 {label}: edges={edges} rows={fnum * rows} "
          f"bit-equal ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
    return out


def pipe_runs(label, frag, factory, kw, device, k1) -> tuple:
    """One app on `frag` serial (GRAPE_PIPELINE=0) and pipelined (force)
    under the ambient GRAPE_EXCHANGE: each after a warm-up, PIPE_REPEATS
    times with the launch counts zeroed before and read after each run,
    every repeat bit-equal to the first serial result and its K1
    launches a round checked; the host syncs of one query each (CUDA's
    sync-debug mode), equal.  Returns (record, the pipelined app of the
    last run)."""
    from libgrape_lite_tpu_torch.worker.worker import Worker

    rec, ref, app = {}, None, None
    for mode, pipe in (("serial", "0"), ("pipelined", "force")):
        with env_set(GRAPE_PIPELINE=pipe):
            run_query(frag, factory(), device, **kw)  # warm: plans, caches
            walls = []
            for rep in range(PIPE_REPEATS):
                app = factory()
                reset_launch_counts()
                wk, secs = run_query(frag, app, device, **kw)
                counts = launch_counts()
                walls.append(secs)
                vals = wk.result_values()
                if ref is None:
                    ref, rounds = vals, wk.rounds
                check(np.array_equal(vals, ref) and wk.rounds == rounds,
                      f"[pipeline] {label} {mode} not bit-equal to serial")
                check((app._pipeline is not None) == (pipe == "force"),
                      f"[pipeline] {label}: {mode} run resolved "
                      f"{app._pipeline!r}")
                want = k1[pipe == "force"] * rounds
                check(counts["gather_reduce"] == want,
                      f"[pipeline] {label} {mode} repeat {rep}: "
                      f"{counts['gather_reduce']} K1 launches in {rounds} "
                      f"rounds, want {want}")
            syncs = call_syncs(lambda: Worker(factory(), frag).query(**kw),
                               device)
            rec[mode] = dict(median_s=float(np.median(walls)),
                             walls_s=walls, syncs=syncs, k1=want)
    check(rec["serial"]["syncs"] == rec["pipelined"]["syncs"],
          f"[pipeline] {label}: host syncs {rec['serial']['syncs']} serial "
          f"vs {rec['pipelined']['syncs']} pipelined")
    rec.update(counts=counts, rounds=rounds,
               plan_uid=app._pipeline.uid,
               hidden_us_per_round=app._pipeline.hidden_us_per_round(),
               speedup=rec["serial"]["median_s"]
               / rec["pipelined"]["median_s"])
    print(f"[pipeline] {label}: rounds={rounds} bit-equal x{PIPE_REPEATS} "
          f"serial_s={rec['serial']['median_s']:.4f} pipelined_s="
          f"{rec['pipelined']['median_s']:.4f} (median of {PIPE_REPEATS}) "
          f"K1/round={k1[0]} vs {k1[1]} host_syncs={rec['serial']['syncs']}"
          f" vs {rec['pipelined']['syncs']} plan={app._pipeline.uid} "
          f"modeled_hidden_us_per_round="
          f"{rec['hidden_us_per_round']}", flush=True)
    return rec, app


def kickoff_overlap(events) -> dict:
    """A pipelined query's device events by CUDA stream (a torch.profiler
    Chrome trace): the stream running K1 and the other streams (the
    kickoff's), the K1 passes and partitions, the kickoff events, the µs
    they overlap K1 passes, and for each kickoff how long after it ended
    on the card the host made its next kernel launch, the interior K1's
    partition (`launch_lags_us`; from the kickoff's own correlation id
    and the host's launch records, so a trace that drops K1 passes still
    gives it; empty when the trace holds no launch records)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launches = sorted((e for e in events if e.get("ph") == "X"
                       and e.get("cat") == "cuda_runtime"
                       and "correlation" in e.get("args", {})),
                      key=lambda e: e["ts"])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in launches}
    kernel_ts = [e["ts"] for e in launches if "LaunchKernel" in e["name"]]
    streams = {}
    for e in dev:
        streams.setdefault(e.get("args", {}).get("stream", e.get("tid")),
                           []).append(e)
    k1_names = ("merge_partition", "merge_gather", "carry_fold")
    main = [s for s, evs in streams.items()
            if any(any(n in e["name"] for n in k1_names) for e in evs)]
    check(len(main) == 1, f"[pipeline] trace: K1 on streams {main}")
    side = [s for s in streams if s != main[0]]
    check(len(side) >= 1, "[pipeline] trace: no kickoff on a second stream")
    k1 = [e for e in streams[main[0]]
          if any(n in e["name"] for n in k1_names)]
    kicks = [e for s in side for e in streams[s]]
    kick = [(e["ts"], e["ts"] + e["dur"]) for e in kicks]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in k1]
    lags = []
    for e in kicks:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        nxt = [k for k in kernel_ts if t is not None and k > t]
        if nxt:
            lags.append(nxt[0] - (e["ts"] + e["dur"]))
    return dict(
        main=main[0], side=side, k1_passes=len(k1),
        k1_partitions=sum("merge_partition" in e["name"] for e in k1),
        kickoff_events=len(kick),
        overlap_us=sum(max(0.0, min(a1, b1) - max(a0, b0))
                       for a0, a1 in kick for b0, b1 in spans),
        overlapping=sum(any(min(a1, b1) > max(a0, b0) for b0, b1 in spans)
                        for a0, a1 in kick),
        launch_lags_us=lags,
        names=sorted({e["name"][:40] for e in kicks}))


def pipe_trace_once(frag, device, path: str):
    """One profiled pipelined SSSP query (device activity only, so the
    profiler adds no host time to each op), PROFILE_PAD_S of host time
    kept around it after a warm-up step, as `profile_once` does:
    (worker, wall s, `kickoff_overlap` of its trace)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from libgrape_lite_tpu_torch.models import SSSP

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "clears events"
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         path)) as prof:
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            wk, secs = run_query(frag, SSSP(), device, source=0)
            time.sleep(PROFILE_PAD_S)
            prof.step()
    with open(path) as fh:
        return wk, secs, kickoff_overlap(json.load(fh)["traceEvents"])


def pipe_trace_phase(frag, device) -> dict:
    """PIPE_REPEATS profiled pipelined SSSP queries (gather exchange),
    each traced alone: its device events by CUDA stream
    (`kickoff_overlap`): the kickoff on a second stream (checked), the
    kickoffs that overlap a K1 pass, and the host's lag in launching the
    interior K1 after the kickoff.  On one card the kickoff is a copy of
    a few µs, so it overlaps the interior K1 only when the host has
    launched both before the boundary K1 ends on the card (a negative
    lag); the overlap is reported, not required.  Each query reruns, up
    to PROFILE_ATTEMPTS times, until its trace holds every kickoff and
    every K1 partition (the profiler drops events, `profile_call`)."""
    import tempfile

    from libgrape_lite_tpu_torch.models import SSSP

    traces = []
    with env_set(GRAPE_PIPELINE="force", GRAPE_EXCHANGE="gather"), \
            tempfile.TemporaryDirectory() as t:
        run_query(frag, SSSP(), device, source=0)  # warm
        for trace in range(PIPE_REPEATS):
            for attempt in range(1, PROFILE_ATTEMPTS + 1):
                wk, secs, got = pipe_trace_once(
                    frag, device, os.path.join(t, f"trace{trace}.json"))
                complete = (got["kickoff_events"] == wk.rounds
                            and got["k1_partitions"] == 2 * wk.rounds)
                if complete:
                    break
            lags = got.pop("launch_lags_us")
            lag = float(np.median(lags)) if lags else None
            print(f"[pipeline] trace {trace} sssp fnum={PIPE_FNUM} gather: "
                  f"rounds={wk.rounds} wall_s={secs:.4f} main_stream="
                  f"{got['main']} k1_passes={got['k1_passes']} "
                  f"k1_partitions={got['k1_partitions']} side_streams="
                  f"{got['side']} kickoff_events={got['kickoff_events']} "
                  f"({', '.join(got.pop('names'))}) trace "
                  f"{'complete' if complete else 'INCOMPLETE'} attempts="
                  f"{attempt} overlapping_k1={got['overlapping']} "
                  f"overlap_us={got['overlap_us']:.1f}; the host's next "
                  f"launch (the interior K1's partition) a median "
                  f"{'missing' if lag is None else f'{lag:.1f}'} us after "
                  f"the kickoff ended on the card ({len(lags)} of "
                  f"{got['kickoff_events']} kickoffs; negative: launched "
                  f"before it ended)", flush=True)
            traces.append(dict(got, rounds=wk.rounds, wall_s=secs,
                               trace_complete=complete, attempts=attempt,
                               interior_launch_after_kickoff_us=lag))
    kicks = sum(r["kickoff_events"] for r in traces)
    over = sum(r["overlapping"] for r in traces)
    print(f"[pipeline] trace: {over} of {kicks} kickoffs overlap a K1 pass "
          f"in {len(traces)} traces", flush=True)
    return dict(counts={}, rounds=traces[0]["rounds"], traces=traces,
                kickoff_events=kicks, overlapping=over)


def pipe_truth_phase(frag, device) -> dict:
    """The overlap truth meter (obs/truth.py) over one armed pipelined
    SSSP query per exchange mode: the modeled hidden µs a round beside
    the measured round (median superstep device wait), its claim_frac."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.models import SSSP
    from libgrape_lite_tpu_torch.obs import truth

    out = {}
    for exchange in ("gather", "mirror"):
        with env_set(GRAPE_PIPELINE="force", GRAPE_EXCHANGE=exchange):
            run_query(frag, SSSP(), device, source=0)  # warm
            obs_reset()
            obs.configure(in_memory=True)
            try:
                run_query(frag, SSSP(), device, source=0)
                rep = truth.truth_report(obs.history())
            finally:
                obs_reset()
        check(rep["queries"] == 1 and rep["joined"] == 1,
              f"[pipeline] truth {exchange}: {rep['queries']} queries, "
              f"{rep['joined']} joined")
        row = rep["rows"][0]
        out[exchange] = dict(truth.block_brief(rep), ok=rep["ok"])
        print(f"[pipeline] truth sssp {exchange}: plan={row['plan_uid']} "
              f"modeled_hidden_us_per_round="
              f"{row['modeled_hidden_us_per_round']} measured_round_us="
              f"{row['measured_round_us']:.1f} (median of "
              f"{row['rounds_measured']} superstep device waits) claim_frac="
              f"{row['claim_frac']} ok={row['ok']}", flush=True)
    return out


def pipe_vc_runs(fs, device) -> dict:
    """sssp_vc serial against pipelined on the [vc] phase's symmetrised
    tiles (`pipe_runs`), and its two phase K1 CSRs against their plain
    versions on a seeded carry; reported in [pipeline]."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    rec, app = pipe_runs(f"sssp_vc k{fs.k}", fs, APP_REGISTRY["sssp_vc"],
                         {"source": 0}, device, PIPE_K1["sssp_vc"])
    ent = app._pipeline.host_entries
    x = torch.rand(fs.k * fs.vc, generator=torch.Generator().manual_seed(5)
                   ).to(device)
    cases = {f"sssp_vc k{fs.k} {ph}": pipe_k1_case(
        f"sssp_vc k{fs.k} phase {ph[1]}", ent[f"pl_{ph}_indptr"],
        ent[f"pl_{ph}_nbr"], ent[f"pl_{ph}_w"], x, device)
        for ph in ("p0", "p1")}
    return {"runs": {f"pipeline sssp_vc k{fs.k}": rec}, "k1": cases}


def pipeline_phase(frag, vc_pipe, device) -> dict:
    """[pipeline]: exchange and overlap on RMAT-20 at fnum 4 -- SSSP, BFS,
    WCC and CDLP serial against pipelined under GRAPE_EXCHANGE gather and
    mirror, the split K1 CSRs against their plain versions, one profiled
    pipelined query, the truth meter, and PageRank's decline; with
    `vc_pipe`, sssp_vc at k 2 and 4 (`pipe_vc_runs`, run inside [vc] on
    its tiles)."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY, PageRank
    from libgrape_lite_tpu_torch.parallel import mirror
    from libgrape_lite_tpu_torch.parallel.pipeline import PIPELINE_STATS

    t_phase = time.perf_counter()
    call_syncs(lambda: None, device)  # the debug mode warns at first use
    f4, host_s = pipe_fragment(frag, device)
    plan = mirror.build_mirror_plan(f4, "ie")
    print(f"[pipeline] rmat{SCALE} fnum={PIPE_FNUM}: build host_s="
          f"{host_s:.2f} vp={f4.vp} mirror m={plan.m} bytes_mirror="
          f"{plan.bytes_mirror} bytes_all_gather={plan.bytes_all_gather} "
          f"(ratio {plan.bytes_mirror / plan.bytes_all_gather:.3f})",
          flush=True)
    runs, cases, apps = {}, {}, {}
    for exchange in ("gather", "mirror"):
        with env_set(GRAPE_EXCHANGE=exchange):
            for name, kw in PIPE_APPS:
                rec, app = pipe_runs(f"{name} {exchange}", f4,
                                     APP_REGISTRY[name], kw, device,
                                     PIPE_K1[name])
                rec["exchange_mode"] = app._pipeline.mode
                check(rec["exchange_mode"] == (
                    "gather" if name == "cdlp" else exchange),
                      f"[pipeline] {name} ran the {app._pipeline.mode} "
                      "exchange")
                runs[f"pipeline {name} {exchange}"] = rec
                apps[(name, exchange)] = app
    st = apps[("sssp", "gather")]._pipeline.stats["totals"]
    print(f"[pipeline] split ie: boundary_vertices="
          f"{st['boundary_vertices']} interior_vertices="
          f"{st['interior_vertices']} boundary_edges={st['boundary_edges']} "
          f"interior_edges={st['interior_edges']} modeled_hidden_frac="
          f"{apps[('sssp', 'gather')]._pipeline.span_brief()['modeled_hidden_frac']}",
          flush=True)
    # the split K1 CSRs (and the mirror columns) at the shapes the round
    # gives them, on a table spliced from the converged distances
    for exchange in ("gather", "mirror"):
        app = apps[("sssp", exchange)]
        with env_set(GRAPE_EXCHANGE=exchange, GRAPE_PIPELINE="force"):
            st = app.init_state(f4, source=0)
            wk = run_query(f4, app, device, source=0)[0]
        from libgrape_lite_tpu_torch.app.base import StepContext

        dist = wk._result_state["dist"]
        ctx = StepContext(PIPE_FNUM)
        table = app._pipeline.splice(dist, app._pipeline.exchange(
            ctx, dist, st))
        for part in ("b", "i"):
            cases[f"sssp {exchange} {part}"] = pipe_k1_case(
                f"sssp {exchange} {'boundary' if part == 'b' else 'interior'}",
                st[f"pl_{part}_indptr"], st[f"pl_{part}_nbr"],
                st[f"pl_{part}_w"], table, device)
        if exchange == "mirror":
            cases["sssp mirror pull"] = pipe_k1_case(
                "sssp mirror pull (serial round)", f4.dev.ie.indptr,
                st["mx_nbr"], st["wf_eff"],
                ctx.gather_lanes(ctx.exchange_mirrors(dist, st["mx_send"])),
                device)
    # the vertex cut's two phase pulls ran inside [vc], on its tiles
    runs.update(vc_pipe["runs"])
    cases.update(vc_pipe["k1"])
    runs["pipeline trace sssp"] = pipe_trace_phase(f4, device)
    truth_rec = pipe_truth_phase(f4, device)
    for pipe in ("1", "force"):
        with env_set(GRAPE_PIPELINE=pipe, GRAPE_PIPELINE_MIN_BYTES="1"):
            app = PageRank()
            app.init_state(f4, max_round=PR_ROUNDS)
        reason = PIPELINE_STATS["last_decision"]["reason"]
        check(app._pipeline is None and (
            "sum fold" in reason or "strict-tile" in reason),
              f"[pipeline] PageRank under GRAPE_PIPELINE={pipe}: {reason!r}")
        print(f"[pipeline] pagerank GRAPE_PIPELINE={pipe}: declined "
              f"({reason})", flush=True)
    # auto on one card: the gather and the serial round, with the reason
    # (the JAX gates would take both here: 8 MiB of gathered state)
    for name, kw in PIPE_APPS[:3]:
        with env_set(GRAPE_EXCHANGE="auto", GRAPE_PIPELINE="auto"):
            app = APP_REGISTRY[name]()
            st = app.init_state(f4, **kw)
        xr = mirror.LAST_EXCHANGE_DECISION["reason"]
        pr = PIPELINE_STATS["last_decision"]["reason"]
        check(app._pipeline is None
              and not any(k.startswith("mx_") for k in st)
              and xr.startswith("one CUDA device")
              and pr.startswith("one CUDA device"),
              f"[pipeline] {name} under auto: exchange {xr!r}, pipeline "
              f"{pr!r}")
        print(f"[pipeline] {name} GRAPE_EXCHANGE=auto GRAPE_PIPELINE=auto: "
              f"gather, serial ({pr})", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"[time] pipeline {secs:.1f} s", flush=True)
    return {"seconds": secs, "runs": runs, "k1": cases, "truth": truth_rec,
            "bytes": {"mirror": plan.bytes_mirror,
                      "gather": plan.bytes_all_gather, "m": plan.m},
            "frag": f4}


# ---- phase 11k: the multi-process runtime ([dist]) ------------------------

DIST_APPS = (("sssp", {"source": 0}), ("bfs", {"source": 0}), ("wcc", {}),
             ("pagerank", {"max_round": PR_ROUNDS}))
DIST_CLI = {"sssp": ["--sssp_source", "6"], "bfs": ["--bfs_source", "6"],
            "wcc": [], "pagerank": ["--pr_mr", str(PR_ROUNDS)]}
DIST_FNUMS = (4,)  # p2p-31 gangs of two ranks (fnum 2: the CPU tests)
DIST_REPEATS = 3
DIST_PR_RTOL = 1e-4
DIST_CHILD_TIMEOUT_S = 300
DIST_TIMEOUT_S = "120"  # GRAPE_DIST_TIMEOUT_S of every group of the phase
# [dist] (e): the rest of the LDBC six across ranks.  (e1) at world 1 on
# the RMAT-20 fnum-4 fragment, and lcc_bitmap on RMAT-18 at fnum 4 cut by
# the segmented partitioner: a hash cut's fragments pass 2^16 vertices,
# so vp doubles and each (fnum vp)^2 / 8-byte bitmap would be 32 GiB;
# (e2) two-rank gloo CLI gangs of these apps on p2p-31 (the RMAT-20 cdlp
# and lcc gangs were cut for time: (e1) runs both at RMAT-20)
# (e1) on the RMAT-20 fnum-4 fragment: (label, registry name, app
# constructor arguments, query arguments)
DIST_E_APPS = (("cdlp", "cdlp", {}, {"max_round": CDLP_ROUNDS}),
               ("lcc", "lcc", {}, {}),
               ("pagerank strict", "pagerank", {"spmv_mode": "strict"},
                {"max_round": PR_ROUNDS}))
DIST_E_CLI = {"cdlp": ["--cdlp_mr", str(CDLP_ROUNDS)], "lcc": [],
              "lcc_bitmap": []}
# the apps that launch no kernel of the port: CDLP's mode fold and
# LCCBeta's merge pass run in PyTorch (the JAX package runs them in XLA)
DIST_KERNEL_FREE = ("cdlp", "lcc")
# [dist] (f): the dynamic graph and the K1 library apps across ranks.
# (f1) under (a)'s one-rank group on the RMAT-20 fnum-4 fragment: the
# overlay apps over [dyn]'s 2,048 seed-13 adds and their seeded
# incremental queries, then the six K1 library apps: (label, registry
# name, app constructor arguments, query arguments)
DIST_F_DYN = (("sssp", {"source": 0}), ("bfs", {"source": 0}), ("wcc", {}))
DIST_F_APPS = (("kcore", "kcore", {}, {"k": KCORE_K}),
               ("core_decomposition", "core_decomposition", {}, {}),
               ("pagerank_local", "pagerank_local", {},
                {"delta": 0.85, "max_round": PR_ROUNDS}),
               ("khop k=2", "khop", {"k": 2}, {"source": 0}),
               ("common_neighbors", "common_neighbors", {}, {"source": 0}),
               ("bc", "bc", {}, {"source": 0}))
# (f2) two gloo ranks on the card and a one-process reference, each one
# child running these `run_app` calls on p2p-31 at fnum 4: the delta
# loads of the LDBC four and the six apps (QueryArgs fields a job)
DIST_F_DELTA = ("sssp", "bfs", "wcc", "pagerank")
DIST_F_JOB_ARGS = {"sssp": {"sssp_source": 6}, "bfs": {"bfs_source": 6},
                   "wcc": {}, "pagerank": {"pr_mr": PR_ROUNDS},
                   "kcore": {"kcore_k": 4}, "core_decomposition": {},
                   "pagerank_local": {"pr_mr": PR_ROUNDS},
                   "khop": {"khop_k": 2, "bfs_source": 6},
                   "common_neighbors": {"cn_source": CN_SOURCE},
                   "bc": {"bc_source": 6}}
DIST_F_SLAB_RANK = 1  # (f3): the overlay fold on this rank's slab
# [dist] (g): the edge-cut variants across ranks.  (g1) under (a)'s
# one-rank group on the RMAT-20 fnum-4 fragment: (registry name, query
# arguments), one a class
DIST_G_APPS = (("sssp_auto", {"source": 0}), ("bfs_auto", {"source": 0}),
               ("wcc_auto", {}), ("pagerank_auto", {"max_round": PR_ROUNDS}),
               ("cdlp_opt", {"max_round": CDLP_ROUNDS}),
               ("sssp_msg", {"source": 0}), ("bfs_msg", {"source": 0}),
               ("sssp_delta", {"source": 0}), ("bfs_opt", {"source": 0}),
               ("wcc_opt", {}))
# (g2) two gloo ranks on the card and a one-process reference, each one
# child running these `run_app` calls on p2p-31 at fnum 4 (QueryArgs
# fields a job; sssp_select under GRAPE_SSSP_PROBE_CAP=1 picks
# sssp_delta), then the delta loads of DIST_G_DELTA; each app's golden
# family
DIST_G_JOB_ARGS = {"sssp_auto": {"sssp_source": 6},
                   "bfs_auto": {"bfs_source": 6}, "wcc_auto": {},
                   "pagerank_auto": {"pr_mr": PR_ROUNDS},
                   "cdlp_opt": {"cdlp_mr": CDLP_ROUNDS},
                   "sssp_msg": {"sssp_source": 6},
                   "bfs_msg": {"bfs_source": 6},
                   "sssp_delta": {"sssp_source": 6},
                   "bfs_opt": {"bfs_source": 6}, "wcc_opt": {},
                   "sssp_select": {"sssp_source": 6}}
DIST_G_DELTA = ("sssp_auto", "sssp_delta")
DIST_G_FAMILY = {app: app.split("_")[0] for app in DIST_G_JOB_ARGS}
# [dist] (h): the counting apps across ranks.  (h1) under (a)'s one-rank
# group: kclique k 3 on its RMAT-20 fnum-4 fragment, then on RMAT-16 at
# fnum 4 (kclique k 4's scale, and lcc_directed's on a directed cut) and
# lcc_bitmap under spgemm on RMAT-14 at fnum 4 ([calib]'s spgemm scale:
# its host plan takes seconds where RMAT-18's took 40.5)
DIST_H_SPGEMM_SCALE = 14
# (h2) two gloo ranks on the card and a one-process reference, each one
# child running these `run_app` calls on p2p-31 at fnum 4 (QueryArgs
# fields a job; `_env` holds a job's environment, its plan cache shared
# by the three children)
DIST_H_HOST_K = 7  # p2p-31's oriented D (14) is past general_cap(7) (13)
DIST_H_JOB_ARGS = {
    "triangle_count": {}, "lcc_directed": {"directed": True},
    **{f"kclique k{k}": {"application": "kclique", "kclique_k": k}
       for k in (3, 4, 5, DIST_H_HOST_K)},
    "spgemm lcc_bitmap": {"application": "lcc_bitmap",
                          "_env": {"GRAPE_LCC_BACKEND": "spgemm"}},
    "spgemm triangle_count": {"application": "triangle_count",
                              "_env": {"GRAPE_LCC_BACKEND": "spgemm"}},
    "auto lcc_opt": {"application": "lcc_opt",
                     "_env": {"GRAPE_LCC_BACKEND": "auto",
                              "GRAPE_PACK_PLAN_CACHE": "{tmp}/h2_plans"}},
    "guard triangle_count": {"application": "triangle_count",
                             "guard": "halt"},
}
# the jobs that launch K3 on every rank; the golden family of each job
# held to one (the LCCs)
DIST_H_K3 = ("triangle_count", "lcc_directed", "guard triangle_count")
DIST_H_FAMILY = {"spgemm lcc_bitmap": "lcc", "auto lcc_opt": "lcc"}

# [dist] (i): the vertex cut and the pipelined round across ranks.  (i1)
# under (a)'s one-rank group: the vertex-cut apps on [vc]'s RMAT-20 k 2
# tiles (sssp, bfs, wcc symmetrised; pagerank raw), and GRAPE_PIPELINE=force
# sssp, bfs, wcc on the RMAT-20 fnum-4 fragment under gather and mirror
DIST_I_VC = (("sssp_vc", "sym", {"source": 0}), ("bfs_vc", "sym",
                                                   {"source": 0}),
             ("wcc_vc", "sym", {}),
             ("pagerank_vc", "raw", {"max_round": PR_ROUNDS}))
DIST_I_PIPE = (("sssp", {"source": 0}), ("bfs", {"source": 0}),
               ("wcc", {}))
# (i2) gloo gangs of two and four ranks on the card and a one-process
# reference each, `run_app` calls on p2p-31 at fnum 4 (k 2): --vc
# pagerank, GRAPE_PARTITION=2d sssp / bfs / wcc, GRAPE_PIPELINE=force
# sssp / wcc under gather and mirror; each job's golden family
DIST_I_JOBS = {
    "vc pagerank": {"application": "pagerank", "vc": True,
                    "pr_mr": PR_ROUNDS},
    **{f"2d {app}": {"application": app, **args,
                     "_env": {"GRAPE_PARTITION": "2d"}}
       for app, args in (("sssp", {"sssp_source": 6}),
                         ("bfs", {"bfs_source": 6}), ("wcc", {}))},
    **{f"pipe-{mode} {app}": {"application": app, **args,
                              "_env": {"GRAPE_PIPELINE": "force",
                                       "GRAPE_EXCHANGE": mode}}
       for mode in ("gather", "mirror")
       for app, args in (("sssp", {"sssp_source": 6}), ("wcc", {}))},
}
DIST_I_FAMILY = {name: name.split(" ")[-1] for name in DIST_I_JOBS}
DIST_I_WORLDS = (2, 4)
# (i3): K1 on rank 1's tile slab of the RMAT-20 k 2 cut at world 4 (one
# tile) and on rank 1's boundary split CSR of the RMAT-20 fnum-4 stack at
# world 2
DIST_I_TILE = (4, 1)
DIST_I_SPLIT = (2, 1)

# A child of the port's CLI: `cli.main` with the given flags, its one
# query timed (synchronised) and its host syncs counted (CUDA's sync-debug
# mode) with the launch and collective counts zeroed before it; the record
# is printed as one `[dist-child]` JSON line, with the kernel libraries
# this process had to build (none: the parent built them).
DIST_CHILD = r"""
import json, sys, time, warnings
import torch
from libgrape_lite_tpu_torch import cli
from libgrape_lite_tpu_torch.fragment import loader
from libgrape_lite_tpu_torch.ops import _build, intersect, spmv
from libgrape_lite_tpu_torch.worker import worker as W

rec = {}
query = W.Worker.query
CUDA = torch.cuda.is_available()


def sync():
    if CUDA:
        torch.cuda.synchronize()


def debug_mode(mode):
    if CUDA:
        torch.cuda.set_sync_debug_mode(mode)


debug_mode("warn")  # warns once at first use
debug_mode("default")


def timed_query(self, *a, **kw):
    sync()
    spmv.reset_launch_counts()
    intersect.reset_launch_counts()
    spec = self.fragment.comm_spec
    spec.reset_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = query(self, *a, **kw)
        finally:
            debug_mode("default")
        sync()
        rec["query_s"] = time.perf_counter() - t0
    rec.update(rounds=self.rounds, k1=spmv.gather_reduce.launches,
               k2=spmv.spmv_strict.launches,
               k3=intersect.row_and_popcount_indexed.launches,
               syncs=sum("synchroniz" in str(w.message) for w in caught),
               dist=dict(spec.stats), transport=spec.transport)
    return out


W.Worker.query = timed_query
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
rec.update(rc=rc, main_s=time.perf_counter() - t0,
           built=sorted(_build.BUILD_LOG), load=sorted(loader.LOAD_SECONDS))
print("[dist-child] " + json.dumps(rec), flush=True)
sys.exit(rc)
"""


# An (f2) or (g2) child: `run_app` for each job (name -> QueryArgs
# fields) on one CommSpec -- a process group when the world is above 1,
# else one process -- with the launch counts zeroed before each call and
# read after; one `[dist-f-child]` JSON line with every job's rounds, K1
# launches, seconds, host-loop decisions and app class, and the kernel
# libraries this process built.
DIST_F_CHILD = r"""
import json, os, sys, time
import torch
from libgrape_lite_tpu_torch.ops import _build, intersect, spmv
from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
from libgrape_lite_tpu_torch.runner import QueryArgs, run_app
from libgrape_lite_tpu_torch.worker.worker import host_loop_stats

COUNTERS = ("global_triangles", "total_cliques", "used_device_kernel",
            "lcc_backend")
jobs, coordinator = json.loads(sys.argv[1]), sys.argv[2]
world, rank, fnum, device = (int(sys.argv[3]), int(sys.argv[4]),
                             int(sys.argv[5]), sys.argv[6])
spec = (CommSpec.init_distributed(coordinator, world, rank, fnum=fnum,
                                  device=device)
        if world > 1 else CommSpec(fnum=fnum, device=device))
recs = {}
for name, kw in jobs.items():
    env = kw.pop("_env", {})  # the job's environment, restored after it
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    spmv.reset_launch_counts()
    intersect.reset_launch_counts()
    t0 = time.perf_counter()
    wk = run_app(QueryArgs(**kw), comm_spec=spec)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    recs[name] = dict(rounds=wk.rounds, k1=spmv.gather_reduce.launches,
                      k3=intersect.row_and_popcount_indexed.launches,
                      seconds=time.perf_counter() - t0,
                      host=host_loop_stats(wk.app),
                      app=type(wk.app).__name__,
                      counters={k: getattr(wk.app, k) for k in COUNTERS
                                if hasattr(wk.app, k)})
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
print("[dist-f-child] " + json.dumps(dict(
    recs=recs, built=sorted(_build.BUILD_LOG), transport=spec.transport)),
    flush=True)
spec.close()
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_fragment(f4, spec):
    """`f4`'s host fragment placed under `spec` (every rank's load builds
    the same host arrays; this process places its slab)."""
    from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment

    return ShardedEdgecutFragment(
        spec, f4.host_oe, f4.host_ie, f4.host_oids, f4.host_ivnum,
        f4.directed, f4.dev.total_vnum, f4.dev.total_enum)


def same_or_close(got: np.ndarray, want: np.ndarray, rtol: float,
                  what: str) -> float:
    """Bit-equal for rtol 0, else within rtol of |want| (a zero stays a
    zero); returns the max relative error."""
    if rtol == 0:
        check(got.dtype == want.dtype and got.tobytes() == want.tobytes(),
              f"{what}: not bit-equal to one process")
        return 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
    ok = np.where(w == 0, np.abs(g) < 1e-12, rel <= rtol)
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} values off one "
          f"process by more than {rtol:g}")
    return float(np.where(w == 0, 0.0, rel).max())


def nccl_trace(fn, device) -> dict:
    """NCCL activity in one profiled call of `fn`: host-side process-group
    ops and device kernels / copies whose name holds `nccl`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        sync(device)
    host = dev = 0
    names = set()
    for ev in prof.events():
        if "nccl" not in ev.name.lower():
            continue
        names.add(ev.name.split("(")[0][:60])
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev += 1
        else:
            host += 1
    return {"host_ops": host, "device_events": dev, "names": sorted(names)}


def dist_world1_phase(f4, device, vcf=None) -> dict:
    """(a) A one-rank NCCL group in this process over RMAT-20 at fnum 4
    (the [pipeline] cell): sssp, bfs, wcc and pagerank through the
    distributed StepContext against the same queries single-process --
    bit-equal (PageRank within 1e-4), the same rounds, K1 launches and
    host syncs; the collectives a round, the all_gather bytes a round,
    the NCCL activity of one traced query, walls (median of 3)."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY
    from libgrape_lite_tpu_torch.parallel import comm_spec as cs

    with env_set(GRAPE_DIST_TIMEOUT_S=DIST_TIMEOUT_S):
        spec = cs.CommSpec.init_distributed(
            f"127.0.0.1:{free_port()}", 1, 0, fnum=PIPE_FNUM,
            device=device)
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    check(spec.transport == want, f"[dist] world 1 came up as {spec!r}")
    print(f"[dist] world 1: {spec!r}", flush=True)
    runs = {}
    try:
        f4d = dist_fragment(f4, spec)
        call_syncs(lambda: None, device)  # the debug mode warns at first use
        for name, kw in DIST_APPS:
            factory = APP_REGISTRY[name]
            one, _ = run_query(f4, factory(), device, **kw)  # warm-ups
            run_query(f4d, factory(), device, **kw)
            reset_launch_counts()
            one, _ = run_query(f4, factory(), device, **kw)
            k1_one = launch_counts()["gather_reduce"]
            reset_launch_counts()
            spec.reset_stats()
            wk, _ = run_query(f4d, factory(), device, **kw)
            counts = launch_counts()
            stats = dict(spec.stats)
            rounds = wk.rounds
            check(rounds == one.rounds, f"[dist] {name}: {rounds} rounds "
                  f"against {one.rounds} single-process")
            check(counts["gather_reduce"] == k1_one > 0,
                  f"[dist] {name}: K1 launched {counts['gather_reduce']} "
                  f"times against {k1_one} single-process")
            rtol = DIST_PR_RTOL if name == "pagerank" else 0
            got, want = wk.result_values(), one.result_values()
            err = same_or_close(got, want, rtol, f"[dist] {name} world 1")
            bit_equal = got.tobytes() == want.tobytes()
            syncs = host_syncs(f4d, factory, device, kw)
            syncs_one = host_syncs(f4, factory, device, kw)
            check(syncs == syncs_one, f"[dist] {name}: {syncs} host syncs "
                  f"in a query against {syncs_one} single-process")
            walls = [run_query(f4d, factory(), device, **kw)[1]
                     for _ in range(DIST_REPEATS)]
            walls_one = [run_query(f4, factory(), device, **kw)[1]
                         for _ in range(DIST_REPEATS)]
            trace = nccl_trace(lambda: run_query(f4d, factory(), device,
                                                 **kw), device)
            per = max(rounds, 1)
            rec = dict(
                counts=counts, rounds=rounds, bit_equal=bit_equal,
                max_rel_err=err, syncs=syncs, syncs_single=syncs_one,
                syncs_per_round=syncs / per,
                collectives_per_round=stats["calls"] / per,
                all_gather_bytes_per_round=stats["all_gather_bytes"] / per,
                all_reduce_per_round=stats["all_reduce"] / per,
                wall_s=float(np.median(walls)),
                wall_single_s=float(np.median(walls_one)),
                nccl_host_ops_per_round=trace["host_ops"] / per,
                nccl_device_events_per_round=trace["device_events"] / per,
                nccl_names=trace["names"])
            runs[f"dist world1 {name}"] = rec
            print(f"[dist] world 1 {spec.transport} {name}: rounds={rounds} "
                  f"{'bit-equal' if bit_equal else f'max_rel_err={err:.3e}'}"
                  f" K1={counts['gather_reduce']} syncs={syncs} "
                  f"(single {syncs_one}) collectives/round="
                  f"{rec['collectives_per_round']:.2f} all_gather "
                  f"B/round={rec['all_gather_bytes_per_round']:.0f} nccl "
                  f"host ops/round={rec['nccl_host_ops_per_round']:.2f} "
                  f"device events/round="
                  f"{rec['nccl_device_events_per_round']:.2f} "
                  f"{trace['names']} wall_s={rec['wall_s']:.4f} "
                  f"single_s={rec['wall_single_s']:.4f}", flush=True)
        e = dist_e1_phase(f4, f4d, spec, device)
        runs.update(e["runs"])
        t_f = time.perf_counter()
        f = dist_f1_phase(f4, f4d, spec, device)
        runs.update(f["runs"])
        f_s = time.perf_counter() - t_f
        t_g = time.perf_counter()
        runs.update(dist_g1_phase(f4, f4d, spec, device))
        g_s = time.perf_counter() - t_g
        k1 = dist_k1_phase(f4, f4d, device)
        k1.update(dist_g3_cases(f4, device))
        t_h = time.perf_counter()
        h = dist_h1_phase(f4, f4d, spec, device)
        runs.update(h["runs"])
        h_s = time.perf_counter() - t_h
        t_i = time.perf_counter()
        runs.update(dist_i1_phase(vcf, f4d, spec, device))
        k1.update(dist_i3_cases(vcf, f4, device))
        i_s = time.perf_counter() - t_i
    finally:
        spec.close()
    return {"runs": runs, "k1": k1, "k2": e["k2"],
            "k3": {**e["k3"], **h["k3"]}, "overlay_fold": f["overlay_fold"],
            "f1_seconds": f_s, "g1_seconds": g_s, "h1_seconds": h_s,
            "i1_seconds": i_s}


def bitmap_fragment4(device, scale: int = BITMAP_SCALE,
                     directed: bool = False):
    """RMAT-18 (lcc_bitmap's scale, or `scale`; the [kernel] phase's
    generator and weights) at fnum 4 under the segmented partitioner:
    four fragments of 2^16 vertices, vp 2^16, so each bitmap is (2^18)^2
    / 8 bytes = 8 GiB as at fnum 1."""
    from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.vertex_map.partitioner import (
        SegmentedPartitioner,
    )
    from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

    n, src, dst = rmat_edges(scale, EDGE_FACTOR)
    oids = np.arange(n, dtype=np.int64)
    w = np.random.default_rng(11).uniform(0.1, 10.0, len(src)).astype(
        np.float32)
    t0 = time.perf_counter()
    f = ShardedEdgecutFragment.build(
        CommSpec(fnum=PIPE_FNUM, device=device),
        VertexMap.build(oids, SegmentedPartitioner(PIPE_FNUM, oids)), src,
        dst, w, directed=directed)
    sync(device)
    return f, time.perf_counter() - t0


def dist_e1_case(label, frag, fragd, spec, factory, kw, device,
                 tag: str = "(e1)", warm_dist: bool = False,
                 attrs: tuple = ()) -> dict:
    """One (e1) (or `tag`) query under the world-1 group against the same
    query in one process: bit-equal, the same rounds and the same K1 /
    overlay fold / K2 / K3 launches, and the same app attributes `attrs`
    after the result (the counting apps' global counts); the ring shifts
    and collectives of the query from `CommSpec.stats`.  `warm_dist`
    warms the group's fragment too (its per-fragment caches:
    common_neighbors' CSR)."""
    run_query(frag, factory(), device, **kw)  # warm-up
    if warm_dist:
        run_query(fragd, factory(), device, **kw)
    reset_launch_counts()
    one, wall_one = run_query(frag, factory(), device, **kw)
    counts_one = launch_counts()
    reset_launch_counts()
    spec.reset_stats()
    wk, wall = run_query(fragd, factory(), device, **kw)
    counts = launch_counts()
    stats = dict(spec.stats)
    check(wk.rounds == one.rounds, f"[dist] {tag} {label}: {wk.rounds} "
          f"rounds against {one.rounds} single-process")
    check(counts == counts_one, f"[dist] {tag} {label}: launches {counts} "
          f"against {counts_one} single-process")
    same_or_close(wk.result_values(), one.result_values(), 0,
                  f"[dist] {tag} {label} world 1")
    got = {a: getattr(wk.app, a) for a in attrs}
    want = {a: getattr(one.app, a) for a in attrs}
    check(got == want, f"[dist] {tag} {label}: {got} against {want} "
          "single-process")
    per = max(wk.rounds, 1)
    rec = dict(counts=counts, rounds=wk.rounds, bit_equal=True, **got,
               wall_s=wall, wall_single_s=wall_one,
               ring_shifts=stats["ring"], ring_bytes=stats["ring_bytes"],
               collectives_per_round=stats["calls"] / per,
               all_gather_bytes_per_round=stats["all_gather_bytes"] / per)
    print(f"[dist] {tag} world 1 {spec.transport} {label}: rounds="
          f"{wk.rounds} bit-equal launches={counts} (single-process "
          f"equal) ring shifts={stats['ring']} collectives/round="
          f"{rec['collectives_per_round']:.2f} all_gather B/round="
          f"{rec['all_gather_bytes_per_round']:.0f} wall_s={wall:.4f} "
          f"single_s={wall_one:.4f}"
          + "".join(f" {a}={v}" for a, v in got.items()), flush=True)
    return rec


def dist_e1_phase(f4, f4d, spec, device) -> dict:
    """(e1) the rest of the LDBC six under the one-rank group: CDLP, lcc
    and PageRank strict on the RMAT-20 fnum-4 fragment, lcc_bitmap on
    RMAT-18 at fnum 4; then (e3) K2 and K3 on rank 1's slab of a
    two-rank group against their plain versions."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    runs = {}
    for label, name, ctor, kw in DIST_E_APPS:
        cls = APP_REGISTRY[name]
        runs[f"dist world1 {label}"] = dist_e1_case(
            label, f4, f4d, spec, lambda: cls(**ctor), kw, device)
    check(runs["dist world1 pagerank strict"]["counts"]["strict_tile"] > 0,
          "[dist] (e1) PageRank strict launched no K2")
    f18, f18_s = bitmap_fragment4(device)
    print(f"[dist] (e1) RMAT-{BITMAP_SCALE} fnum {PIPE_FNUM} segmented cut "
          f"built in {f18_s:.2f} s (vp {f18.vp})", flush=True)
    f18d = dist_fragment(f18, spec)
    rec = runs["dist world1 lcc_bitmap"] = dist_e1_case(
        "lcc_bitmap", f18, f18d, spec, APP_REGISTRY["lcc_bitmap"], {},
        device)
    check(rec["counts"]["intersect"] > 0,
          "[dist] (e1) lcc_bitmap launched no K3")
    # (h1)'s triangle_count on the same cut, before it is dropped
    rec = runs["dist world1 triangle_count"] = dist_e1_case(
        "triangle_count", f18, f18d, spec, APP_REGISTRY["triangle_count"],
        {}, device, tag="(h1)", attrs=("global_triangles",))
    check(rec["counts"]["intersect"] > 0,
          "[dist] (h1) triangle_count launched no K3")
    del f18d
    k2 = dist_k2_slab_case(f4, device)
    k3 = dist_k3_slab_cases(f18, device)
    del f18
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the gangs' children share the card
    return {"runs": runs, "k2": k2, "k3": k3}


def dist_h1_phase(f4, f4d, spec, device) -> dict:
    """(h1) the counting apps under the one-rank group, each against the
    same query in one process (bit-equal, equal K3 launches and global
    counts): kclique k 3 on (a)'s RMAT-20 fnum-4 fragment, kclique k 4 on
    RMAT-16 at fnum 4, lcc_directed on RMAT-16 directed at fnum 4 and
    lcc_bitmap under GRAPE_LCC_BACKEND=spgemm on RMAT-14 at fnum 4 (the
    two fragments' plans through one plan cache), each fragment warmed
    first (its nested worker, its plan); then (h3) K3 at ring step 1 on
    rank 1 of the directed cut."""
    import tempfile

    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    kclique = APP_REGISTRY["kclique"]
    counters = ("total_cliques", "used_device_kernel")
    runs = {"dist world1 kclique k3": dist_e1_case(
        "kclique k3", f4, f4d, spec, kclique, {"k": 3}, device, tag="(h1)",
        warm_dist=True, attrs=counters)}
    built = {}
    for label, scale, directed in (("rmat16", KCLIQUE4_SCALE, False),
                                   ("rmat16 directed", DIRECTED_SCALE, True),
                                   ("rmat14", DIST_H_SPGEMM_SCALE, False)):
        f, secs = bitmap_fragment4(device, scale, directed)
        built[label] = (f, dist_fragment(f, spec))
        print(f"[dist] (h1) RMAT-{scale} fnum {PIPE_FNUM} segmented cut"
              f"{' directed' if directed else ''} built in {secs:.2f} s "
              f"(vp {f.vp})", flush=True)
    f16, f16d = built.pop("rmat16")
    runs["dist world1 kclique k4"] = dist_e1_case(
        "kclique k4", f16, f16d, spec, kclique, {"k": 4}, device,
        tag="(h1)", warm_dist=True, attrs=counters)
    check(runs["dist world1 kclique k4"]["used_device_kernel"],
          "[dist] (h1) kclique k4 left the device path")
    del f16, f16d
    f16, f16d = built.pop("rmat16 directed")
    rec = runs["dist world1 lcc_directed"] = dist_e1_case(
        "lcc_directed", f16, f16d, spec, APP_REGISTRY["lcc_directed"], {},
        device, tag="(h1)")
    check(rec["counts"]["intersect"] > 0,
          "[dist] (h1) lcc_directed launched no K3")
    k3 = dist_h3_case(f16, device)
    del f16d
    f14, f14d = built.pop("rmat14")
    with tempfile.TemporaryDirectory(prefix="grape-h1-plans-") as plans, \
            env_set(GRAPE_LCC_BACKEND="spgemm", GRAPE_PACK_PLAN_CACHE=plans):
        runs["dist world1 spgemm lcc_bitmap"] = dist_e1_case(
            "spgemm lcc_bitmap", f14, f14d, spec, APP_REGISTRY["lcc_bitmap"],
            {}, device, tag="(h1)", warm_dist=True,
            attrs=("lcc_backend",))
    check(runs["dist world1 spgemm lcc_bitmap"]["lcc_backend"] == "spgemm",
          "[dist] (h1) lcc_bitmap did not run the spgemm backend")
    return {"runs": runs, "k3": k3}


def dist_h3_case(f16, device) -> dict:
    """(h3) K3 at ring step 1 on rank 1 of a two-rank group over the
    RMAT-16 directed fnum-4 cut: LCCDirected's NB rows of rank 1's slab
    against rank 0's visiting OUT block, the pairs whose v is rank 1's
    and whose u is rank 0's -- integer-equal to its plain version.
    Bound, time and plain time as (e3)'s."""
    from libgrape_lite_tpu_torch.models import LCCDirected
    from libgrape_lite_tpu_torch.ops import intersect
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    nb, out_bm, (v, u) = LCCDirected().pair_operands(f16.dev)
    rows = (PIPE_FNUM // 2) * f16.vp
    sel = (v >= rows) & (u < rows)
    a, ia, b, ib = nb[rows:], v[sel] - rows, out_bm[:rows], u[sel]
    got = intersect.row_and_popcount_indexed(a, ia, b, ib)
    want = intersect.row_and_popcount_plain(a, ia, b, ib)
    sync(device)
    check(torch.equal(got, want), "[dist] (h3) K3 rank-1 OUT ring step not "
          "integer-equal to its plain version")
    pairs, words = got.numel(), a.shape[1]
    ms = time_ms(lambda: intersect.row_and_popcount_indexed(a, ia, b, ib),
                 device, 5, warmup=1, batch=2)
    plain_ms = time_ms(lambda: intersect.row_and_popcount_plain(
        a, ia, b, ib), device, 1, warmup=0, batch=1)
    distinct = int(torch.unique(ia).numel()) + int(torch.unique(ib).numel())
    b_ms, b_by = bound(distinct * 4 * words + 12 * pairs, 3 * pairs * words)
    print(f"[kernel] intersect rank-1 ring step 1 lcc_directed OUT: "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=none "
          f"bound_ms={b_ms:.4f} ({b_by}) pairs={pairs} words={words} "
          f"distinct_rows={distinct} popcount_total={int(got.sum())} "
          "integer-equal", flush=True)
    return {"rank1 ring step 1 lcc_directed": dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, pairs=pairs, words=words,
        distinct_rows=distinct, total=int(got.sum()))}


def dist_k2_slab_case(f4, device) -> dict:
    """(e3) K2 on rank 1's [2, Ep] slab of the RMAT-20 fnum-4 stack with
    the slab's rows of the strict plan (PageRank's pull across two
    ranks), against its plain version: within SUM_TOL of each row's sum
    of |terms|, rerun bit-identical.  Bound: values, rows and y once, an
    add an edge slot.  Library: the faster of index_add_ and
    segment_reduce over the slab's edges."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    lo, hi = PIPE_FNUM // 2, PIPE_FNUM
    fl, vp = hi - lo, f4.vp
    plan = spmv.plan_for_app(f4, vp, torch.float32, mode="strict")
    check(plan is not None, "[dist] K2: no strict plan for RMAT-20 fnum 4")
    row_lo = torch.from_numpy(np.ascontiguousarray(plan[0][lo:hi])).to(
        device)
    tile, rmax = plan[1], plan[2]
    ie = f4.dev.ie
    gen = torch.Generator(device="cpu").manual_seed(6)
    x = torch.rand(f4.fnum * vp, generator=gen).to(device)
    src = ie.edge_src[lo:hi].contiguous()
    values = torch.where(ie.edge_mask[lo:hi], x[ie.edge_nbr[lo:hi]],
                         torch.zeros((), device=x.device)).contiguous()

    def call():
        return spmv.spmv_strict(values, src, row_lo, vp, tile, rmax)

    got = call()
    err = check_sum(got, spmv.spmv_strict_plain(values.double(), src, row_lo,
                                                vp, tile, rmax),
                    spmv.spmv_strict_plain(values.double().abs(), src,
                                           row_lo, vp, tile, rmax),
                    "[dist] K2 rank-1 slab")
    check(torch.equal(got, call()),
          "[dist] K2 rank-1 slab rerun not bit-identical")
    ep = values.shape[1]
    src_long = src.reshape(-1).to(torch.int64)
    flat = values.reshape(-1)
    acc = torch.zeros(fl * (vp + 1), device=x.device)
    rows = src_long + torch.arange(fl, device=x.device).repeat_interleave(
        ep) * (vp + 1)  # each fragment's rows, pads on its row vp
    offsets = torch.cat([rows.new_zeros(1), torch.bincount(
        rows, minlength=fl * (vp + 1)).cumsum(0)])
    libraries = {
        "index_add_": lambda: acc.zero_().index_add_(0, rows, flat),
        "segment_reduce": lambda: torch.segment_reduce(
            flat, "sum", offsets=offsets, unsafe=True),
    }
    ms = time_ms(call, device, 10)
    plain_ms = time_ms(lambda: spmv.spmv_strict_plain(
        values, src, row_lo, vp, tile, rmax), device, 3, warmup=1, batch=1)
    lib_all = {k: time_ms(fn, device, 10) for k, fn in libraries.items()}
    lib_name = min(lib_all, key=lib_all.get)
    b_ms, b_by = bound(8 * fl * ep + 4 * row_lo.numel() + 4 * fl * vp,
                       fl * ep)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_all[lib_name], library=lib_name,
               library_all_ms=lib_all, bound_ms=b_ms, bound_by=b_by,
               edges=fl * ep, tiles=row_lo.shape[1], rows=fl * vp)
    print(f"[kernel] strict_tile rank-1 slab [{fl}, {ep}]: kernel_ms="
          f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{lib_all[lib_name]:.4f} ({lib_name}; "
          + " ".join(f"{k}={v:.4f}" for k, v in lib_all.items())
          + f") bound_ms={b_ms:.4f} ({b_by}) tiles={row_lo.shape[1]} "
          f"max_abs_err={err:.3e} rerun bit-identical", flush=True)
    return {"rank1 slab": out}


def dist_k3_slab_cases(f18, device) -> dict:
    """(e3) K3 at ring step 1 on rank 1 of a two-rank group over the
    RMAT-18 fnum-4 cut: its slab's N+ / N- rows against rank 0's visiting
    N+ block, the pairs whose row is rank 1's and whose neighbour is rank
    0's -- each pass integer-equal to its plain version.  Bound: each
    distinct row read once, the indices and the counts; an AND, a
    popcount and an add a word and pair.  No PyTorch call counts
    popcounts (library none)."""
    from libgrape_lite_tpu_torch.models import LCC
    from libgrape_lite_tpu_torch.ops import intersect
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    bplus, bminus, (v, u), (w, t) = LCC().pair_operands(f18.dev)
    rows = (PIPE_FNUM // 2) * f18.vp
    visiting = bplus[:rows]  # rank 0's block, after one shift
    oe = (v >= rows) & (u < rows)
    ie = (w >= rows) & (t < rows)
    calls = {"oe": (visiting, u[oe], bplus[rows:], v[oe] - rows),
             "ie": (visiting, t[ie], bminus[rows:], w[ie] - rows)}
    words = bplus.shape[1]
    out = {}
    for name, (a, ia, b, ib) in calls.items():
        got = intersect.row_and_popcount_indexed(a, ia, b, ib)
        want = intersect.row_and_popcount_plain(a, ia, b, ib)
        sync(device)
        check(torch.equal(got, want), f"[dist] K3 rank-1 slab {name} not "
              "integer-equal to its plain version")
        pairs = got.numel()
        ms = time_ms(lambda: intersect.row_and_popcount_indexed(a, ia, b, ib),
                     device, 5, warmup=1, batch=2)
        plain_ms = time_ms(lambda: intersect.row_and_popcount_plain(
            a, ia, b, ib), device, 1, warmup=0, batch=1)
        distinct = (int(torch.unique(ia).numel())
                    + int(torch.unique(ib).numel()))
        b_ms, b_by = bound(distinct * 4 * words + 12 * pairs,
                           3 * pairs * words)
        out[f"rank1 ring step 1 {name}"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by, pairs=pairs, words=words,
            distinct_rows=distinct, total=int(got.sum()))
        print(f"[kernel] intersect rank-1 ring step 1 {name}: kernel_ms="
              f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms=none bound_ms="
              f"{b_ms:.4f} ({b_by}) pairs={pairs} words={words} "
              f"distinct_rows={distinct} popcount_total={int(got.sum())} "
              "integer-equal", flush=True)
    return out


def dist_k1_case(label, indptr, nbr, w, x, kind, device) -> dict:
    """K1 on a rank's slab CSR ([fl, vp + 1], global pid columns) reading
    the gathered x, against its plain version: min bit-equal, sum within
    1e-5 of each row's sum of |terms|; bound: indptr, the edges' columns
    (and weights), x and y each once.  Library: `sparse_csr_tensor @ x`
    for the sum, segment_reduce over the candidates (gathered outside the
    timed call) for min."""
    from libgrape_lite_tpu_torch.ops import spmv
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    got = spmv.gather_reduce(indptr, nbr, w, x, kind)
    if kind == "sum":
        err = check_sum(
            got, spmv.gather_reduce_plain(indptr, nbr, w, x.double(), "sum"),
            spmv.gather_reduce_plain(indptr, nbr, w, x.double().abs(),
                                     "sum"), f"[dist] K1 {label}")
    else:
        check(torch.equal(got, spmv.gather_reduce_plain(indptr, nbr, w, x,
                                                        kind)),
              f"[dist] K1 {label} not bit-equal to its plain version")
        err = 0.0
    fl, rows = indptr.shape[0], indptr.shape[1] - 1
    ip = indptr.to(torch.int64)
    real = (torch.arange(nbr.shape[1], device=x.device).unsqueeze(0)
            < ip[:, -1:])
    edges = int(real.sum())
    per_edge = 2 if w is not None else 1
    nbytes = (indptr.nbytes + 4 * per_edge * edges
              + x.numel() * x.element_size() + fl * rows * x.element_size())
    b_ms, b_by = bound(nbytes, per_edge * edges)
    cols = nbr[real].to(torch.int64)
    deg = (ip[:, 1:] - ip[:, :-1]).reshape(-1)
    if kind == "sum":
        flat_ip = torch.cat([deg.new_zeros(1), deg.cumsum(0)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "beta state"
            csr = torch.sparse_csr_tensor(
                flat_ip, cols, torch.ones(edges, device=x.device),
                size=(fl * rows, x.numel()), check_invariants=False)
        library = lambda: csr @ x  # noqa: E731
    else:
        cand = x[cols] + (w[real] if w is not None else 0)
        library = lambda: torch.segment_reduce(  # noqa: E731
            cand, "min", lengths=deg, unsafe=True, initial=float("inf"))
    ms = time_ms(lambda: spmv.gather_reduce(indptr, nbr, w, x, kind),
                 device, 10)
    plain_ms = time_ms(lambda: spmv.gather_reduce_plain(
        indptr, nbr, w, x, kind), device, 3, batch=1)
    lib_ms = time_ms(library, device, 10)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, edges=edges,
               rows=fl * rows)
    print(f"[kernel] gather_reduce {label}: kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}) edges={edges} rows={fl * rows} max_abs_err={err:.3e}",
          flush=True)
    return out


def dist_k1_phase(f4, f4d, device) -> dict:
    """K1 on rank 1's [2, vp + 1] slab of the RMAT-20 fnum-4 stack (a
    two-rank group's), min+w and sum, reading a gathered [fnum * vp]
    x."""
    lo, hi = PIPE_FNUM // 2, PIPE_FNUM
    ie = f4.dev.ie
    indptr = ie.indptr[lo:hi].contiguous()
    nbr = ie.edge_nbr[lo:hi].contiguous()
    w = torch.where(ie.edge_mask[lo:hi], ie.edge_w[lo:hi].float(),
                    torch.tensor(float("inf"), device=ie.edge_w.device))
    n = f4.fnum * f4.vp
    gen = torch.Generator(device="cpu").manual_seed(5)
    x = torch.rand(n, generator=gen).to(device)
    dist = torch.where(torch.rand(n, generator=gen) < 0.3,
                       torch.tensor(float("inf")),
                       torch.rand(n, generator=gen) * 50).to(device)
    return {"rank1 slab min+w": dist_k1_case(
                "rank-1 slab [2, vp+1] min+w", indptr, nbr, w.contiguous(),
                dist, "min", device),
            "rank1 slab sum": dist_k1_case(
                "rank-1 slab [2, vp+1] sum", indptr, nbr, None, x, "sum",
                device)}


def dist_f1_phase(f4, f4d, spec, device) -> dict:
    """(f1) under the world-1 group on the RMAT-20 fnum-4 fragment:
    [dyn]'s 2,048 seed-13 adds staged through `DynGraph.ingest` on the
    one-process fragment and on the group's (the apply's digest exchange
    at world 1), SSSP, BFS and WCC over the overlay bit-equal to one
    process with equal rounds, K1 and overlay_fold launches (one each a
    round), then `query_incremental` seeded from each one's base result,
    equal to the cold overlay query in fewer rounds; then the six K1
    library apps, each bit-equal to one process with equal rounds and
    launches.  The overlays are detached at the end; (f3) reads the
    one-process overlay first."""
    from libgrape_lite_tpu_torch.dyn import DynGraph, RepackPolicy
    from libgrape_lite_tpu_torch.models import APP_REGISTRY
    from libgrape_lite_tpu_torch.worker.worker import Worker

    runs = {}
    adds, _ = dyn_adds(f4)
    prev = {name: tuple(run_query(f, dyn_factory(name)(), device, **kw)[0]
                        ._result_state for f in (f4, f4d))
            for name, kw in DIST_F_DYN}  # the base fixed points
    t0 = time.perf_counter()
    reps = [DynGraph(f, RepackPolicy()).ingest(adds) for f in (f4, f4d)]
    ingest_s = time.perf_counter() - t0
    check(all(r["mode"] == "overlay" for r in reps),
          f"[dist] (f1) ingest: {[(r['mode'], r['reason']) for r in reps]}")
    slots = f4.dyn_overlay.placed("ie", np.float32, "", device,
                                  slab=(0, f4.fnum))["mask"].sum(dim=1)
    print(f"[dist] (f1) rmat{SCALE} fnum {PIPE_FNUM}: {DYN_ADDS} adds "
          f"ingested as overlays on one process and on the world-1 group in "
          f"{ingest_s:.3f} host s (slots a fragment {slots.tolist()} of "
          f"{f4.dyn_overlay.capacity})", flush=True)
    try:
        f3 = dist_f3_case(f4, device)
        for name, kw in DIST_F_DYN:
            rec = runs[f"dist world1 overlay {name}"] = dist_e1_case(
                f"overlay {name}", f4, f4d, spec, dyn_factory(name), kw,
                device, tag="(f1)")
            c = rec["counts"]
            check(c["gather_reduce"] == c["overlay_fold"] == rec["rounds"]
                  > 0, f"[dist] (f1) overlay {name}: launches {c} in "
                  f"{rec['rounds']} rounds (one K1 and one fold a round)")
            cold = run_query(f4d, dyn_factory(name)(), device, **kw)[0]
            got = {}
            for label, f, p in (("one process", f4, prev[name][0]),
                                ("world 1", f4d, prev[name][1])):
                sync(device)
                reset_launch_counts()
                t1 = time.perf_counter()
                wk = Worker(dyn_factory(name)(), f)
                wk.query_incremental(p, reps[0]["delta"], **kw)
                sync(device)
                got[label] = (wk, time.perf_counter() - t1, launch_counts())
            (w1, s1, _), (wd, sd, cd) = got["one process"], got["world 1"]
            check(wd.inc_report["mode"] == "seeded"
                  and wd.rounds == w1.rounds < cold.rounds,
                  f"[dist] (f1) {name} incremental: {wd.inc_report}, "
                  f"rounds {wd.rounds} (one process {w1.rounds}, cold "
                  f"{cold.rounds})")
            same_or_close(wd.result_values(), cold.result_values(), 0,
                          f"[dist] (f1) {name} incremental against cold")
            same_or_close(wd.result_values(), w1.result_values(), 0,
                          f"[dist] (f1) {name} incremental world 1")
            check(cd["overlay_fold"] == wd.rounds,
                  f"[dist] (f1) {name} incremental: launches {cd}")
            runs[f"dist world1 incremental {name}"] = dict(
                counts=cd, rounds=wd.rounds, cold_rounds=cold.rounds,
                wall_s=sd, wall_single_s=s1)
            print(f"[dist] (f1) world 1 {spec.transport} {name} "
                  f"query_incremental over the overlay: seeded rounds="
                  f"{wd.rounds} (one process {w1.rounds}, cold "
                  f"{cold.rounds}) bit-equal to cold launches={cd} "
                  f"wall_s={sd:.4f} single_s={s1:.4f}", flush=True)
    finally:
        f4.dyn_overlay = f4d.dyn_overlay = None  # back to the plain graph
    for label, name, ctor, kw in DIST_F_APPS:
        cls = APP_REGISTRY[name]
        rec = runs[f"dist world1 {label}"] = dist_e1_case(
            label, f4, f4d, spec, lambda cls=cls, ctor=ctor: cls(**ctor), kw,
            device, tag="(f1)", warm_dist=name == "common_neighbors")
        check(rec["counts"]["gather_reduce"] > 0,
              f"[dist] (f1) {label} launched no K1")
    return {"runs": runs, "overlay_fold": f3}


def decisions_text(decided: dict) -> str:
    """A host loop's decisions past its rounds, as " k=v ..." ("" for a
    superstep app)."""
    return "".join(f" {k}={v}" for k, v in decided.items() if k != "rounds")


def dist_g1_case(name, frag, fragd, spec, kw, device) -> dict:
    """One (g1) query under the world-1 group against the same query in
    one process: bit-equal, the same rounds, launches and host-loop
    decisions (an exchange app's retries, buckets, push / pull rounds and
    settled capacity); the host syncs and collectives a round; the walls
    (both fragments warmed first: their push CSRs and dest_degree)."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY
    from libgrape_lite_tpu_torch.worker.worker import host_loop_stats

    factory = APP_REGISTRY[name]
    run_query(frag, factory(), device, **kw)  # warm-ups
    run_query(fragd, factory(), device, **kw)
    reset_launch_counts()
    one, wall_one = run_query(frag, factory(), device, **kw)
    counts_one = launch_counts()
    reset_launch_counts()
    spec.reset_stats()
    wk, wall = run_query(fragd, factory(), device, **kw)
    counts = launch_counts()
    stats = dict(spec.stats)
    decided, decided_one = host_loop_stats(wk.app), host_loop_stats(one.app)
    check(wk.rounds == one.rounds and decided == decided_one,
          f"[dist] (g1) {name}: {wk.rounds} rounds {decided} against "
          f"{one.rounds} {decided_one} single-process")
    check(counts == counts_one and counts["gather_reduce"] > 0,
          f"[dist] (g1) {name}: launches {counts} against {counts_one} "
          "single-process")
    same_or_close(wk.result_values(), one.result_values(), 0,
                  f"[dist] (g1) {name} world 1")
    syncs = host_syncs(fragd, factory, device, kw)
    syncs_one = host_syncs(frag, factory, device, kw)
    check(syncs == syncs_one, f"[dist] (g1) {name}: {syncs} host syncs in "
          f"a query against {syncs_one} single-process")
    per = max(wk.rounds, 1)
    rec = dict(counts=counts, rounds=wk.rounds, host=decided,
               bit_equal=True, wall_s=wall, wall_single_s=wall_one,
               syncs=syncs, syncs_single=syncs_one,
               syncs_per_round=syncs / per,
               collectives_per_round=stats["calls"] / per,
               all_gather_per_round=stats["all_gather"] / per,
               all_to_all_per_round=stats["all_to_all"] / per,
               bytes_per_round=stats["bytes"] / per)
    print(f"[dist] (g1) world 1 {spec.transport} {name}: rounds="
          f"{wk.rounds}{decisions_text(decided)} bit-equal launches="
          f"{counts} (single-process equal) syncs={syncs} "
          f"({rec['syncs_per_round']:.2f} a round; single {syncs_one}) "
          f"collectives/round={rec['collectives_per_round']:.2f}"
          f" (all_gather {rec['all_gather_per_round']:.2f}, all_to_all "
          f"{rec['all_to_all_per_round']:.2f}) B/round="
          f"{rec['bytes_per_round']:.0f} wall_s={wall:.4f} single_s="
          f"{wall_one:.4f}", flush=True)
    return rec


def dist_g1_phase(f4, f4d, spec, device) -> dict:
    """(g1) the edge-cut variants under the world-1 group on the RMAT-20
    fnum-4 fragment, one query a class against one process."""
    return {f"dist world1 {name}": dist_g1_case(name, f4, f4d, spec, kw,
                                                device)
            for name, kw in DIST_G_APPS}


def dist_g3_cases(f4, device) -> dict:
    """(g3) K1 on rank 1's [2, fnum * vp + 1] push-CSR slab of the RMAT-20
    fnum-4 stack (the rows `push_csr` builds on rank 1 of a two-rank
    group: destination pids, source pids as columns) reading a gathered
    [fnum * vp] x: min+w (sssp_auto's push) and f32 sum
    (pagerank_auto's), against the plain version, each rerun
    bit-identical."""
    from libgrape_lite_tpu_torch.models.auto_apps import push_csr
    from libgrape_lite_tpu_torch.ops import spmv

    lo, hi = PIPE_FNUM // 2, PIPE_FNUM
    n = f4.fnum * f4.vp
    gen = torch.Generator(device="cpu").manual_seed(11)
    x = torch.rand(n, generator=gen).to(device)
    dist = torch.where(torch.rand(n, generator=gen) < 0.3,
                       torch.tensor(float("inf")),
                       torch.rand(n, generator=gen) * 50).to(device)
    out = {}
    for label, csr, xs, kind in (
            ("min+w", push_csr(f4, "oe", torch.float32), dist, "min"),
            ("sum", push_csr(f4, "oe"), x, "sum")):
        indptr, nbr, w = (None if t is None else t[lo:hi].contiguous()
                          for t in csr)
        out[f"rank1 push-CSR slab {label}"] = dist_k1_case(
            f"rank-1 push-CSR slab [2, fnum*vp+1] {label}", indptr, nbr, w,
            xs, kind, device)
        runs = [spmv.gather_reduce(indptr, nbr, w, xs, kind)
                for _ in range(2)]
        sync(device)
        check(torch.equal(runs[0].view(torch.int32),
                          runs[1].view(torch.int32)),
              f"[dist] (g3) K1 push-CSR slab {label}: a rerun differs")
    return out


def dist_f3_case(f4, device) -> dict:
    """(f3) the overlay fold on rank DIST_F_SLAB_RANK's [2, capacity]
    slot planes of the RMAT-20 fnum-4 stack's overlay (the planes a rank
    of a two-rank group places, `DeltaOverlay.placed(slab=...)`), folding
    a gathered [fnum * vp] x into a [2, vp] pull result: bit-equal to its
    plain version, the former K1 path and `scatter_reduce_` amin, and to
    itself on a rerun; timed beside its bound, plain and library ms."""
    from libgrape_lite_tpu_torch.ops import spmv

    fl = f4.fnum // 2
    lo = DIST_F_SLAB_RANK * fl
    pl = f4.dyn_overlay.placed("ie", np.float32, "", device, slab=(lo, fl))
    n = f4.fnum * f4.vp
    gen = torch.Generator(device="cpu").manual_seed(7)

    def floats(*shape):
        return torch.where(torch.rand(*shape, generator=gen) < 0.3,
                           torch.tensor(float("inf")),
                           torch.rand(*shape, generator=gen) * 50).to(device)

    x, relaxed = floats(n), floats(fl, f4.vp)
    out = overlay_fold_case(f"rank-{DIST_F_SLAB_RANK} slab [{fl}, "
                            f"{pl['src'].shape[1]}] min+w", pl, x, relaxed,
                            device, reps=30)
    runs = [spmv.overlay_fold(relaxed.clone(), pl["src"], pl["nbr"],
                              pl["w"], pl["mask"], x) for _ in range(2)]
    sync(device)
    check(torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32)),
          "[dist] (f3) overlay_fold on the slab: a rerun differs")
    print(f"[kernel] overlay_fold rank-{DIST_F_SLAB_RANK} slab [{fl}, "
          f"{pl['src'].shape[1]}] (fid_lo {lo}, x [{n}] gathered): "
          f"kernel_ms={out['ms']:.4f} plain_ms={out['plain_ms']:.4f} "
          f"library_ms={out['library_ms']:.4f} (scatter_reduce_ amin) "
          f"bound_ms={out['bound_ms']:.6f} ({out['bound_by']}) slots="
          f"{out['slots']} rows={out['rows']} max_abs_err=0 (bit-equal to "
          f"{', '.join(out['bit_equal_to'])}; rerun bit-identical)",
          flush=True)
    return {f"rank{DIST_F_SLAB_RANK} slab min+w": out}


def p2p_query_fields(device) -> tuple:
    """(plain, delta): the QueryArgs fields of a `run_app` job on p2p-31
    at fnum 4, and of its delta load (the mutable base and delta)."""
    data = os.path.join(HERE, "dataset")
    plain = dict(efile=os.path.join(data, "p2p-31.e"),
                 vfile=os.path.join(data, "p2p-31.v"), fnum=PIPE_FNUM,
                 device=torch.device(device).type)
    delta = dict(plain, efile=os.path.join(data, "p2p-31.e.mutable_base"),
                 delta_efile=os.path.join(data, "p2p-31.e.mutable_delta"))
    return plain, delta


def f2_jobs(prefix, device) -> dict:
    """(f2)'s jobs: the delta loads of DIST_F_DELTA, then the six apps."""
    plain, delta = p2p_query_fields(device)
    out = {f"delta {app}": dict(delta, application=app,
                                out_prefix=f"{prefix}_delta_{app}",
                                **DIST_F_JOB_ARGS[app])
           for app in DIST_F_DELTA}
    out.update({app: dict(plain, application=app,
                          out_prefix=f"{prefix}_{app}", **args)
                for app, args in DIST_F_JOB_ARGS.items()
                if app not in DIST_F_DELTA})
    return out


def g2_jobs(prefix, device) -> dict:
    """(g2)'s jobs: each class once, sssp_select, then the delta loads of
    DIST_G_DELTA."""
    plain, delta = p2p_query_fields(device)
    out = {app: dict(plain, application=app, out_prefix=f"{prefix}_{app}",
                     **args) for app, args in DIST_G_JOB_ARGS.items()}
    out.update({f"delta {app}": dict(delta, application=app,
                                     out_prefix=f"{prefix}_delta_{app}",
                                     **DIST_G_JOB_ARGS[app])
                for app in DIST_G_DELTA})
    return out


def h2_jobs(prefix, device) -> dict:
    """(h2)'s jobs: DIST_H_JOB_ARGS, the `auto` job's plan cache beside
    the results (one directory for the three children)."""
    plain, _ = p2p_query_fields(device)
    out = {}
    for name, args in DIST_H_JOB_ARGS.items():
        args = dict(args)
        env = {k: v.format(tmp=os.path.dirname(prefix))
               for k, v in args.pop("_env", {}).items()}
        out[name] = dict(plain, application=args.pop("application", name),
                         out_prefix=f"{prefix}_{name.replace(' ', '_')}",
                         **args, **({"_env": env} if env else {}))
    return out


def h2_checks(runs: dict, tmp: str) -> None:
    """(h2)'s own checks: kclique k 3-5 on the device apps and k 7 on the
    host recursion; the spgemm jobs on that backend; the three children
    took one `auto` decision and left one plan file, no temporary."""
    for k in (3, 4, 5, DIST_H_HOST_K):
        rec = runs[f"dist gloo (h2) kclique k{k}"]
        check(rec["counters"]["used_device_kernel"] == (k != DIST_H_HOST_K),
              f"[dist] (h2) kclique k{k}: {rec['counters']}")
    for job in ("spgemm lcc_bitmap", "spgemm triangle_count"):
        check(runs[f"dist gloo (h2) {job}"]["counters"]["lcc_backend"]
              == "spgemm", f"[dist] (h2) {job} did not run spgemm")
    pick = runs["dist gloo (h2) auto lcc_opt"]["counters"]["lcc_backend"]
    plans = sorted(os.listdir(os.path.join(tmp, "h2_plans"))) \
        if os.path.isdir(os.path.join(tmp, "h2_plans")) else []
    check(len(plans) == (pick == "spgemm")
          and all(p.endswith(".npz") for p in plans),
          f"[dist] (h2) auto picked {pick}; plan cache holds {plans}")
    print(f"[dist] (h2) auto lcc_opt: {pick} on both ranks and in one "
          f"process; plan cache {plans}", flush=True)


def run_app_children_start(tag, jobs, tmp, device, env=None,
                           world: int = 2) -> dict:
    """(f2), (g2), (h2) or (i2) started: `world` gloo ranks on the card
    and a one-process reference, each a child running DIST_F_CHILD's
    `run_app` calls (`jobs(prefix, device)`) on p2p-31 at fnum 4;
    `run_app_children_finish` waits for them and checks."""
    dev = torch.device(device).type
    port = free_port()
    base = os.path.join(tmp, tag)
    argv = [[sys.executable, "-c", DIST_F_CHILD, json.dumps(jobs(
        f"{base}_gang" + (f"_r{r}" if r else ""), device)),
        f"127.0.0.1:{port}", str(world), str(r), str(PIPE_FNUM), dev]
        for r in range(world)]
    argv.append([sys.executable, "-c", DIST_F_CHILD,
                 json.dumps(jobs(f"{base}_one", device)), "", "1", "0",
                 str(PIPE_FNUM), dev])
    return {"procs": start_children(argv, {"GRAPE_DIST_BACKEND": "gloo",
                                           **(env or {})}),
            "t0": time.perf_counter(), "jobs": jobs("", device), "tmp": tmp,
            "tag": tag, "world": world}


def run_app_children_finish(started, device, family=None,
                            golden_all=False, kernel=None) -> dict:
    """(f2), (g2), (h2) or (i2) checked: every gang job's files equal the
    one-process child's (the PageRanks within 1e-4), the delta loads
    (every job with `golden_all`, and every job `family` names) the
    p2p-31 goldens, no rank but 0 wrote, every rank ran one process's
    rounds, host-loop decisions, app class and counters (global
    triangles, cliques, the LCC backend), every rank launched K1 in
    every job (or the kernel `kernel(job)` names: "k1", "k3" or None) on
    the card, and no child built a kernel library.  `family` maps an app
    to the golden and tolerance it is held to (itself by default)."""
    tag, world = started["tag"], started["world"]
    what = f"[dist] ({tag})"
    outs = wait_children(started["procs"],
                         started["t0"] + DIST_CHILD_TIMEOUT_S)
    children_s = time.perf_counter() - started["t0"]
    recs = []
    for r, (rc, so, se) in enumerate(outs):
        line = [ln for ln in so.splitlines()
                if ln.startswith("[dist-f-child] ")]
        check(rc == 0 and line, f"{what} child {r}: exit {rc}: "
              f"{se[-3000:]}")
        recs.append(json.loads(line[-1][len("[dist-f-child] "):]))
    gang, one = recs[:world], recs[world]
    check(all(not rec["built"] for rec in recs),
          f"{what} children built {[rec['built'] for rec in recs]}")
    check([rec["transport"] for rec in recs]
          == ["gloo-staged" if torch.device(device).type == "cuda"
              else "gloo"] * world + ["local"],
          f"{what} transports {[rec['transport'] for rec in recs]}")
    tmp, data = started["tmp"], os.path.join(HERE, "dataset")
    runs = {}
    for name in started["jobs"]:
        app = name.removeprefix("delta ")
        fam = (family or {}).get(app, app)
        sfx = name.replace(" ", "_")
        check(not any(os.path.exists(os.path.join(
            tmp, f"{tag}_gang_r{r}_{sfx}")) for r in range(1, world)),
              f"{what} {name}: a rank but 0 wrote result files")
        got = read_results(os.path.join(tmp, f"{tag}_gang_{sfx}"), PIPE_FNUM)
        err = compare_files(fam, got, read_results(
            os.path.join(tmp, f"{tag}_one_{sfx}"), PIPE_FNUM),
            f"{what} {name}")
        golden = name.startswith("delta ") or golden_all or (
            kernel is not None and fam != app)
        if golden:
            check_golden(fam, result_dict(got), result_dict(open(
                os.path.join(data, GOLDENS[fam][0])).read()),
                f"{what} {name}")
        rs = [rec["recs"][name] for rec in gang]
        mine = one["recs"][name]
        for key in ("rounds", "host", "app", "counters"):
            check(all(x[key] == mine[key] for x in rs),
                  f"{what} {name}: {key} {[x[key] for x in rs]} against "
                  f"{mine[key]} one process")
        k1, k3 = [x["k1"] for x in rs], [x["k3"] for x in rs]
        need = "k1" if kernel is None else kernel(name)
        if need is not None:
            got = [x[need] for x in rs]
            check(min(got) > 0 or torch.device(device).type != "cuda",
                  f"{what} {name}: {need.upper()} launches {got} a rank")
        runs[f"dist gloo ({tag}) {name}"] = dict(
            counts={"gather_reduce": sum(k1), "intersect": sum(k3)},
            rounds=rs[0]["rounds"], host=rs[0]["host"], app=rs[0]["app"],
            counters=rs[0]["counters"], max_rel_err=err, k1_per_rank=k1,
            k3_per_rank=k3, seconds=[x["seconds"] for x in rs],
            seconds_one=mine["seconds"])
        same = ("byte-equal" if fam != "pagerank"
                else f"max_rel_err={err:.3e}")
        print(f"{what} gloo {world} ranks p2p-31 fnum {PIPE_FNUM} {name} "
              f"({rs[0]['app']}): rounds={rs[0]['rounds']}"
              f"{decisions_text(rs[0]['host'])} {same} to one process"
              f"{', goldens ok' if golden else ''} "
              + "".join(f"{k}={v} " for k, v in rs[0]["counters"].items())
              + f"K1/rank={k1} K3/rank={k3} run_app_s="
              f"{[round(x['seconds'], 3) for x in rs]} (one process "
              f"{mine['seconds']:.3f})", flush=True)
    print(f"{what} children: {world + 1} processes, {len(started['jobs'])} "
          f"run_app calls each, in {children_s:.1f} s (beside (b)'s)",
          flush=True)
    return {"runs": runs, "children_s": children_s}


def dist_children(jobs: dict, env_extra: dict, device,
                  kernel_free=(), during=None) -> dict:
    """Run every job (name -> argv list of CLI flags per rank) at once as
    children of the port's CLI (`DIST_CHILD`), each under the subprocess
    timeout; `during()`, when given, runs in this process meanwhile;
    returns name -> the ranks' `[dist-child]` records.  A child that
    fails, builds a kernel library or launches no kernel (K1, K2 or K3;
    jobs named in `kernel_free` launch none) fails the phase."""
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1",
               GRAPE_DIST_TIMEOUT_S=DIST_TIMEOUT_S, **env_extra)
    procs = {name: [subprocess.Popen(
        [sys.executable, "-c", DIST_CHILD, *argv], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in ranks] for name, ranks in jobs.items()}
    out, failed = {}, []
    if during is not None:
        try:
            during()
        except BaseException:
            for ranks in procs.values():
                for p in ranks:
                    p.kill()
                    p.communicate()
            raise
    deadline = time.perf_counter() + DIST_CHILD_TIMEOUT_S
    try:
        for name, ranks in procs.items():
            recs = []
            for r, p in enumerate(ranks):
                try:
                    so, se = p.communicate(
                        timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    failed.append(f"{name} rank {r}: past "
                                  f"{DIST_CHILD_TIMEOUT_S} s")
                    continue
                line = [ln for ln in so.splitlines()
                        if ln.startswith("[dist-child] ")]
                if p.returncode != 0 or not line:
                    failed.append(f"{name} rank {r}: exit {p.returncode}: "
                                  f"{se[-2000:]}")
                    continue
                recs.append(json.loads(line[-1][len("[dist-child] "):]))
            out[name] = recs
    finally:
        for ranks in procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    check(not failed, "[dist] children failed: " + " | ".join(failed))
    for name, recs in out.items():
        for r, rec in enumerate(recs):
            check(not rec["built"], f"[dist] {name} rank {r} built "
                  f"{rec['built']}: the children use the parent's kernels")
            # (off the card the children run the plain versions)
            check(rec["k1"] + rec["k2"] + rec["k3"] > 0
                  or name in kernel_free
                  or torch.device(device).type != "cuda",
                  f"[dist] {name} rank {r} launched no kernel")
    return out


def read_results(prefix: str, fnum: int) -> str:
    return "".join(open(os.path.join(prefix, f"result_frag_{f}")).read()
                   for f in range(fnum))


def compare_files(app: str, got: str, want: str, what: str) -> float:
    """A gang's result text against one process's: byte for byte, or for
    PageRank within 1e-4 relative by oid."""
    if app != "pagerank":
        check(got == want, f"{what}: result files differ from one "
              "process's")
        return 0.0
    g, w = result_dict(got), result_dict(want)
    check(g.keys() == w.keys(), f"{what}: vertex sets")
    keys = list(w)
    return same_or_close(np.array([float(g[k]) for k in keys]),
                         np.array([float(w[k]) for k in keys]),
                         DIST_PR_RTOL, what)


def dist_gang_phase(tag: str, env_extra: dict, transport: str, tmp: str,
                    rmat: bool, device, beside_rmat=None) -> dict:
    """CLI gangs of two ranks (`env_extra` picks the transport): on
    p2p-31 at fnum 4 for the four apps, then (`rmat`) RMAT-20 SSSP
    and PageRank at fnum 4 (hash partitioner) beside a one-process CLI
    child of each; every gang's files equal one process's (PageRank
    within 1e-4), the p2p-31 ones the goldens, and only rank 0 writes.
    With `rmat`, (e2) too: cdlp, lcc and lcc_bitmap on p2p-31 at fnum 4
    (lcc_bitmap's K3 ring crossing ranks), the ring shifts a query from
    the children's `CommSpec.stats`.  The one-process references of the
    p2p-31 gangs run in this process while the children do;
    `beside_rmat()`, when given, starts more children beside the RMAT-20
    gangs (its result returns under "beside")."""
    from libgrape_lite_tpu_torch import cli

    data = os.path.join(HERE, "dataset")
    p2p = ["--efile", os.path.join(data, "p2p-31.e"),
           "--vfile", os.path.join(data, "p2p-31.v"),
           "--device", torch.device(device).type]

    def gang(flags, prefix, world=2):
        port = free_port()
        return [flags + ["--out_prefix", prefix if r == 0
                         else f"{prefix}_r{r}",
                         "--coordinator", f"127.0.0.1:{port}",
                         "--num_processes", str(world), "--process_id",
                         str(r)] for r in range(world)]

    def err_text(app, err):
        return "byte-equal" if app != "pagerank" else f"max_rel_err={err:.3e}"

    jobs = {}
    for app in DIST_CLI:
        for fnum in DIST_FNUMS:
            flags = ["--application", app, *DIST_CLI[app], *p2p, "--fnum",
                     str(fnum)]
            jobs[f"p2p {app} fnum {fnum}"] = gang(
                flags, os.path.join(tmp, f"{tag}_{app}_{fnum}"))
    rmat_apps = {"sssp": ["--application", "sssp", "--sssp_source", "0"],
                 "pagerank": ["--application", "pagerank", "--pr_mr",
                              str(PR_ROUNDS)]}
    e_apps = DIST_E_CLI if rmat else {}
    free = set()  # jobs that launch no kernel
    for app in e_apps:
        name = f"p2p {app} fnum {PIPE_FNUM}"
        jobs[name] = gang(["--application", app, *DIST_E_CLI[app], *p2p,
                           "--fnum", str(PIPE_FNUM)],
                          os.path.join(tmp, f"{tag}_{app}_{PIPE_FNUM}"))
        if app in DIST_KERNEL_FREE:
            free.add(name)
    if rmat:
        # the one-process RMAT children load the TSV and write the garc
        # cache beside the p2p-31 gangs; the RMAT gangs then read it
        efile, vfile, _, _, tsv_s = shared_rmat_tsv(SCALE)
        flags_r = ["--efile", efile, "--vfile", vfile, "--fnum",
                   str(PIPE_FNUM), "--partitioner_type", "hash",
                   "--serialization_prefix", os.path.join(tmp, "garc"),
                   "--device", torch.device(device).type]
        for app, flags in rmat_apps.items():
            jobs[f"rmat{SCALE} {app} one process"] = [
                flags + flags_r + ["--serialize", "--out_prefix",
                                   os.path.join(tmp, f"one_rmat_{app}")]]
    def references():
        """The one-process CLI files the p2p-31 gangs are held to."""
        for app in DIST_CLI:
            for fnum in DIST_FNUMS:
                one = os.path.join(tmp, f"one_{app}_{fnum}")
                if not os.path.exists(one):
                    cli.main(["--application", app, *DIST_CLI[app], *p2p,
                              "--fnum", str(fnum), "--out_prefix", one])
        for app in e_apps:
            cli.main(["--application", app, *DIST_E_CLI[app], *p2p,
                      "--fnum", str(PIPE_FNUM), "--out_prefix",
                      os.path.join(tmp, f"one_{app}_{PIPE_FNUM}")])

    t0 = time.perf_counter()
    recs = dist_children(jobs, env_extra, device, free, during=references)
    children_s = time.perf_counter() - t0
    nproc = sum(len(v) for v in jobs.values())
    runs = {}
    for app in DIST_CLI:
        want_g = result_dict(open(os.path.join(data, GOLDENS[app][0])).read())
        for fnum in DIST_FNUMS:
            name = f"p2p {app} fnum {fnum}"
            one = os.path.join(tmp, f"one_{app}_{fnum}")
            prefix = os.path.join(tmp, f"{tag}_{app}_{fnum}")
            check(not os.path.exists(prefix + "_r1"),
                  f"[dist] {tag} {name}: rank 1 wrote result files")
            got = read_results(prefix, fnum)
            err = compare_files(app, got, read_results(one, fnum),
                                f"[dist] {tag} {name}")
            check_golden(app, result_dict(got), want_g,
                         f"[dist] {tag} {name}")
            rs = recs[name]
            check(all(r["transport"] == transport for r in rs),
                  f"[dist] {name}: transport {[r['transport'] for r in rs]}")
            check(len({r["rounds"] for r in rs}) == 1,
                  f"[dist] {name}: ranks ran different rounds")
            runs[f"dist {tag} {name}"] = dict(
                counts={"gather_reduce": sum(r["k1"] for r in rs)},
                rounds=rs[0]["rounds"], max_rel_err=err,
                k1_per_rank=[r["k1"] for r in rs],
                query_s=[r["query_s"] for r in rs],
                syncs=[r["syncs"] for r in rs],
                collectives=rs[0]["dist"]["calls"],
                staged=rs[0]["dist"]["staged"])
            print(f"[dist] {tag} 2 ranks {name}: rounds={rs[0]['rounds']} "
                  f"{err_text(app, err)} goldens ok K1/rank="
                  f"{[r['k1'] for r in rs]} query_s="
                  f"{[round(r['query_s'], 4) for r in rs]} syncs="
                  f"{[r['syncs'] for r in rs]} collectives="
                  f"{rs[0]['dist']['calls']} (staged "
                  f"{rs[0]['dist']['staged']})", flush=True)
    runs.update(e2_p2p_checks(tag, e_apps, recs, tmp, device))
    beside = None
    if rmat:
        jobs = {f"rmat{SCALE} {app}": gang(
            flags + flags_r + ["--deserialize"],
            os.path.join(tmp, f"{tag}_rmat_{app}"))
            for app, flags in rmat_apps.items()}
        if beside_rmat is not None:
            beside = beside_rmat()
        t0 = time.perf_counter()
        recs.update(dist_children(jobs, env_extra, device, free))
        children_s += time.perf_counter() - t0
        nproc += sum(len(v) for v in jobs.values())
        for app in rmat_apps:
            name = f"rmat{SCALE} {app}"
            rs, (one,) = recs[name], recs[f"{name} one process"]
            got = read_results(os.path.join(tmp, f"{tag}_rmat_{app}"),
                               PIPE_FNUM)
            err = compare_files(app, got, read_results(
                os.path.join(tmp, f"one_rmat_{app}"), PIPE_FNUM),
                f"[dist] {tag} {name}")
            check(all(r["rounds"] == one["rounds"] for r in rs),
                  f"[dist] {name}: rounds {[r['rounds'] for r in rs]} "
                  f"against {one['rounds']} one process")
            check("serialize" in one["load"]
                  and all("deserialize" in r["load"] for r in rs),
                  f"[dist] {name}: the one process's load "
                  f"{one['load']}, the gang's {[r['load'] for r in rs]}")
            per = max(one["rounds"], 1)
            r = runs[f"dist {tag} {name}"] = dict(
                counts={"gather_reduce": sum(x["k1"] for x in rs)},
                rounds=one["rounds"], max_rel_err=err,
                query_s=[x["query_s"] for x in rs],
                query_one_s=one["query_s"],
                syncs_per_round=[x["syncs"] / per for x in rs],
                syncs_per_round_one=one["syncs"] / per,
                collectives_per_round=rs[0]["dist"]["calls"] / per,
                staged_per_round=rs[0]["dist"]["staged"] / per,
                all_gather_bytes_per_round=rs[0]["dist"]["all_gather_bytes"]
                / per, ring_shifts=rs[0]["dist"]["ring"],
                ring_bytes=rs[0]["dist"]["ring_bytes"],
                main_s=[x["main_s"] for x in rs],
                main_one_s=one["main_s"])
            print(f"[dist] {tag} 2 ranks {name} fnum {PIPE_FNUM}: rounds="
                  f"{one['rounds']} {err_text(app, err)} query_s="
                  f"{[round(x, 4) for x in r['query_s']]} (one process "
                  f"{one['query_s']:.4f}) syncs/round="
                  f"{[round(x, 2) for x in r['syncs_per_round']]} (one "
                  f"process {r['syncs_per_round_one']:.2f}) collectives/"
                  f"round={r['collectives_per_round']:.2f} all_gather "
                  f"B/round={r['all_gather_bytes_per_round']:.0f} ring "
                  f"shifts={r['ring_shifts']} ({r['ring_bytes']} B) main_s="
                  f"{[round(x, 1) for x in r['main_s']]} (one process "
                  f"{one['main_s']:.1f}; rmat{SCALE} TSV written in "
                  f"{tsv_s:.1f} s)", flush=True)
    print(f"[dist] {tag} children: {nproc} processes in {children_s:.1f} s",
          flush=True)
    return {"runs": runs, "children_s": children_s, "beside": beside}


#: ring shifts of a two-rank query: lcc_bitmap shifts its N+ block once,
#: lcc its ELL block and row lengths once each, cdlp has no ring
E_RING_SHIFTS = {"cdlp": 0, "lcc": 2, "lcc_bitmap": 1}


def e2_p2p_checks(tag, apps, recs, tmp, device) -> dict:
    """(e2)'s p2p-31 gangs against one process's CLI files (byte-equal;
    written meanwhile, `dist_gang_phase`) and the goldens, with equal
    rounds on both ranks, the ring shifts and bytes of a query and, for
    lcc_bitmap on the card, K3's two passes a ring step on each rank."""
    data = os.path.join(HERE, "dataset")
    runs = {}
    for app in apps:
        name = f"p2p {app} fnum {PIPE_FNUM}"
        one = os.path.join(tmp, f"one_{app}_{PIPE_FNUM}")
        prefix = os.path.join(tmp, f"{tag}_{app}_{PIPE_FNUM}")
        check(not os.path.exists(prefix + "_r1"),
              f"[dist] {tag} {name}: rank 1 wrote result files")
        got = read_results(prefix, PIPE_FNUM)
        compare_files(app, got, read_results(one, PIPE_FNUM),
                      f"[dist] {tag} {name}")
        golden = "lcc" if app == "lcc_bitmap" else app
        check_golden(golden, result_dict(got), result_dict(open(
            os.path.join(data, GOLDENS[golden][0])).read()),
            f"[dist] {tag} {name}")
        rs = recs[name]
        check(len({r["rounds"] for r in rs}) == 1,
              f"[dist] {name}: ranks ran different rounds")
        rings = [r["dist"]["ring"] for r in rs]
        check(rings == [E_RING_SHIFTS[app]] * len(rs),
              f"[dist] {name}: ring shifts {rings}")
        k3 = [r["k3"] for r in rs]
        check(app != "lcc_bitmap" or torch.device(device).type != "cuda"
              or k3 == [4] * len(rs),
              f"[dist] {name}: K3 launched {k3} times a rank, not twice "
              "a ring step")
        runs[f"dist {tag} {name}"] = dict(
            counts={"gather_reduce": sum(r["k1"] for r in rs),
                    "strict_tile": sum(r["k2"] for r in rs),
                    "intersect": sum(k3)},
            rounds=rs[0]["rounds"], k3_per_rank=k3,
            query_s=[r["query_s"] for r in rs],
            syncs=[r["syncs"] for r in rs],
            collectives=rs[0]["dist"]["calls"],
            staged=rs[0]["dist"]["staged"], ring_shifts=rings[0],
            ring_bytes=rs[0]["dist"]["ring_bytes"])
        print(f"[dist] (e2) {tag} 2 ranks {name}: rounds={rs[0]['rounds']} "
              f"byte-equal to one process, goldens ok K3/rank={k3} "
              f"ring shifts={rings[0]} ({rs[0]['dist']['ring_bytes']} B) "
              f"query_s={[round(r['query_s'], 4) for r in rs]} syncs="
              f"{[r['syncs'] for r in rs]} collectives="
              f"{rs[0]['dist']['calls']} (staged {rs[0]['dist']['staged']})",
              flush=True)
    return runs


# [dist] (c) and (d): state and control across ranks -- sharded two-phase
# checkpoints, the reshard restore, the breach vote, the gang's telemetry
DIST_FT_EVERY = 2  # checkpoint_every of the phase's lineages
DIST_KILL_AT = 4  # the superstep a kill fires after
DIST_FT_APPS = (("sssp", {"source": 0}), ("pagerank", {"max_round": PR_ROUNDS}))


@contextlib.contextmanager
def timed_votes():
    """Count and time every `BreachVote.round_vote` of the block on the
    host clock (the vote's share of a round)."""
    from libgrape_lite_tpu_torch.guard import vote

    orig = vote.BreachVote.round_vote
    rec = {"calls": 0, "s": 0.0}

    def timed(self, rounds, err=None):
        t0 = time.perf_counter()
        try:
            return orig(self, rounds, err)
        finally:
            rec["calls"] += 1
            rec["s"] += time.perf_counter() - t0

    vote.BreachVote.round_vote = timed
    try:
        yield rec
    finally:
        vote.BreachVote.round_vote = orig


def newest_meta(ckdir: str) -> tuple:
    from libgrape_lite_tpu_torch.ft.checkpoint import (
        list_checkpoints,
        read_meta,
    )

    steps = list_checkpoints(ckdir)
    check(bool(steps), f"[dist] no complete checkpoint under {ckdir}")
    return steps[-1][1], read_meta(steps[-1][1])


def dist_ft_app(name, kw, f4, f4d, factory, device, tmp) -> dict:
    """(c) for one app: the sharded lineage of a checkpointed query on the
    one-rank group, its resume, the save against the single-file
    manager's, and the guarded query with the vote armed against the
    unvoted one (one process)."""
    import shutil

    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.ft.faults import FaultPlan, InjectedFault
    from libgrape_lite_tpu_torch.worker.worker import Worker

    rtol = DIST_PR_RTOL if name == "pagerank" else 0
    reset_launch_counts()
    one = run_query(f4, factory(), device, **kw)[0]
    k1_one = launch_counts()["gather_reduce"]
    want = one.result_values()
    ck_kw = dict(kw, checkpoint_every=DIST_FT_EVERY)
    ck_s = os.path.join(tmp, f"c_{name}")
    reset_launch_counts()
    wk = run_query(f4d, factory(), device, checkpoint_dir=ck_s, **ck_kw)[0]
    counts = launch_counts()
    check(wk.rounds == one.rounds and counts["gather_reduce"] == k1_one > 0,
          f"[dist] (c) {name} sharded: rounds {wk.rounds} / "
          f"{one.rounds}, K1 {counts['gather_reduce']} / {k1_one}")
    err = same_or_close(wk.result_values(), want, rtol,
                        f"[dist] (c) {name} checkpointed")
    path, meta = newest_meta(ck_s)
    check(meta.get("layout") == "sharded" and meta.get("ranks") == 1,
          f"[dist] (c) {name}: lineage {meta.get('layout')} ranks "
          f"{meta.get('ranks')}")
    snap = os.path.getsize(os.path.join(path, "rank_0.npz"))
    # killed at superstep 4 under the vote (raise mode), then resumed
    ck_k = os.path.join(tmp, f"c_{name}_kill")
    try:
        Worker(factory(), f4d).query(
            checkpoint_dir=ck_k, fault_plan=FaultPlan(
                kill_at_superstep=DIST_KILL_AT, mode="raise"), **ck_kw)
        check(False, f"[dist] (c) {name}: kill@{DIST_KILL_AT} under the "
              "vote did not raise")
    except InjectedFault as e:
        incident = getattr(e, "gang_incident", None)
    check(bool(incident) and newest_meta(ck_k)[1]["rounds"] == DIST_KILL_AT,
          f"[dist] (c) {name} kill@{DIST_KILL_AT}: incident {incident}")
    # the reshard's copy, as the kill left it (the resume below extends
    # the lineage)
    shutil.copytree(ck_k, ck_k + "_at_kill")
    reset_launch_counts()
    rs = Worker(factory(), f4d)
    rs.resume(ck_k)
    sync(device)
    r_counts = launch_counts()
    err_r = same_or_close(rs.result_values(), want, rtol,
                          f"[dist] (c) {name} resume")
    check(rs.rounds == one.rounds and r_counts["gather_reduce"] > 0,
          f"[dist] (c) {name} resume: rounds {rs.rounds}, K1 {r_counts}")
    # a save: the sharded manager (stage, vote, commit, vote) against the
    # single-file one (the copies' enqueue; its write in a thread)
    obs.configure(in_memory=True)
    run_query(f4d, factory(), device, checkpoint_dir=ck_s + "_t", **ck_kw)
    run_query(f4, factory(), device, checkpoint_dir=ck_s + "_1", **ck_kw)
    ev = obs.history()
    obs_reset()
    save_sh = span_ms(ev, "checkpoint_save_sharded")
    save_1, write_1 = span_ms(ev, "checkpoint_save"), span_ms(
        ev, "checkpoint_write")
    check(len(save_sh) == len(save_1) == len(write_1) > 0,
          f"[dist] (c) {name}: {len(save_sh)} sharded saves, "
          f"{len(save_1)} single-file")
    snap_1 = os.path.getsize(os.path.join(newest_meta(ck_s + "_1")[0],
                                          "state.npz"))
    # the guard with the vote armed (the group) against without (one
    # process): the vote's host time and host syncs a round
    g_kw = dict(kw, guard="halt")
    run_query(f4d, factory(), device, **g_kw)  # warm-up
    reset_launch_counts()
    with timed_votes() as vt:
        gv = run_query(f4d, factory(), device, **g_kw)[0]
    g_counts = launch_counts()
    check(vt["calls"] == gv.rounds + 1 and not gv.guard_report["breaches"],
          f"[dist] (c) {name} guarded: {vt['calls']} votes in "
          f"{gv.rounds} rounds, breaches {gv.guard_report['breaches']}")
    err_g = same_or_close(gv.result_values(), want, rtol,
                          f"[dist] (c) {name} guarded")
    walls = {"voted": [], "unvoted": []}
    for _ in range(DIST_REPEATS):
        walls["voted"].append(run_query(f4d, factory(), device, **g_kw)[1])
        walls["unvoted"].append(run_query(f4, factory(), device, **g_kw)[1])
    med = {k: float(np.median(v)) * 1e3 for k, v in walls.items()}
    syncs_v = host_syncs(f4d, factory, device, g_kw)
    syncs_u = host_syncs(f4, factory, device, g_kw)
    check(syncs_v == syncs_u, f"[dist] (c) {name}: {syncs_v} host syncs "
          f"voted against {syncs_u} unvoted")
    per = gv.rounds + 1
    rec = dict(counts={"gather_reduce": counts["gather_reduce"]
                       + r_counts["gather_reduce"]
                       + g_counts["gather_reduce"]},
               rounds=wk.rounds, k1=counts["gather_reduce"], k1_single=k1_one,
               max_rel_err=max(err, err_r, err_g),
               save_sharded_ms=float(np.mean(save_sh)),
               save_single_ms=float(np.mean(save_1)),
               write_single_ms=float(np.mean(write_1)),
               bytes_sharded=snap, bytes_single=snap_1,
               vote_us_per_round=vt["s"] / vt["calls"] * 1e6,
               wall_voted_ms=med["voted"], wall_unvoted_ms=med["unvoted"],
               syncs_per_round=syncs_v / per,
               syncs_unvoted_per_round=syncs_u / per)
    print(f"[dist] (c) world 1 {name}: rounds={wk.rounds} K1={k1_one} "
          f"(single {k1_one}) sharded checkpoint_every {DIST_FT_EVERY}, "
          f"kill@{DIST_KILL_AT} under the vote (incident {incident}) and "
          f"resume {'bit-equal' if rtol == 0 else f'max_rel_err={err:.3e}'}"
          f"; save ms sharded={rec['save_sharded_ms']:.3f} single-file="
          f"{rec['save_single_ms']:.3f} (write "
          f"{rec['write_single_ms']:.3f}) bytes a snapshot {snap} "
          f"({snap_1}); guard halt voted: vote_us/round="
          f"{rec['vote_us_per_round']:.1f} ({vt['calls']} votes) wall_ms "
          f"voted={med['voted']:.3f} unvoted={med['unvoted']:.3f} "
          f"syncs/round={rec['syncs_per_round']:.2f} (unvoted "
          f"{rec['syncs_unvoted_per_round']:.2f})", flush=True)
    return rec


def dist_ft_world1_phase(f4, f2, device, tmp) -> dict:
    """(c) NCCL at world 1 in this process over [pipeline]'s RMAT-20
    fnum-4 fragment: SSSP and PageRank checkpointed through
    ShardedCheckpointManager, resumed, guarded under the vote; then a
    kill@4 under the vote and its lineage resharded onto the fnum-2
    fragment `f2`, bit-equal to a cold fnum-2 query."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.models import APP_REGISTRY, SSSP
    from libgrape_lite_tpu_torch.parallel import comm_spec as cs
    from libgrape_lite_tpu_torch.worker.worker import Worker

    with env_set(GRAPE_DIST_TIMEOUT_S=DIST_TIMEOUT_S):
        spec = cs.CommSpec.init_distributed(
            f"127.0.0.1:{free_port()}", 1, 0, fnum=PIPE_FNUM, device=device)
    runs = {}
    try:
        f4d = dist_fragment(f4, spec)
        for name, kw in DIST_FT_APPS:
            runs[f"dist ft world1 {name}"] = dist_ft_app(
                name, kw, f4, f4d, APP_REGISTRY[name], device, tmp)
        ck = os.path.join(tmp, "c_sssp_kill_at_kill")  # dist_ft_app's
        run_query(f2, SSSP(), device, source=0)  # warm-up
        cold = run_query(f2, SSSP(), device, source=0)[0]
        obs.configure(in_memory=True)
        reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        rw = Worker(SSSP(), f2)
        rw.resume(ck)
        sync(device)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        restore = span_ms(obs.history(), "checkpoint_restore_resharded")
        obs_reset()
        check(len(restore) == 1 and counts["gather_reduce"] > 0,
              f"[dist] (c) reshard: {len(restore)} restores, K1 {counts}")
        same_or_close(rw.result_values(), cold.result_values(), 0,
                      "[dist] (c) reshard fnum 4 -> 2")
        runs["dist ft world1 reshard sssp"] = dict(
            counts=counts, rounds=rw.rounds, cold_rounds=cold.rounds,
            restore_ms=restore[0], resume_wall_s=wall)
        print(f"[dist] (c) the kill@{DIST_KILL_AT} lineage resharded fnum "
              f"{PIPE_FNUM} -> "
              f"{f2.fnum}: restore_ms={restore[0]:.3f} resume_wall_s="
              f"{wall:.4f} rounds={rw.rounds} (cold {cold.rounds}) K1="
              f"{counts['gather_reduce']} bit-equal to the cold fnum-2 "
              "query", flush=True)
    finally:
        spec.close()
    return runs


def start_children(argvs, env_extra) -> list:
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1",
               GRAPE_DIST_TIMEOUT_S=DIST_TIMEOUT_S, **env_extra)
    return [subprocess.Popen(argv, cwd=HERE, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for argv in argvs]


def wait_children(procs, deadline) -> list:
    """Every child's (rc, stdout, stderr); a child past `deadline` (the
    host clock) is killed with the rest, rc None."""
    out = []
    try:
        for p in procs:
            try:
                so, se = p.communicate(
                    timeout=max(1.0, deadline - time.perf_counter()))
                out.append((p.returncode, so, se))
            except subprocess.TimeoutExpired:
                out.append((None, "", "past the phase's deadline"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def dist_d_load(tmp, device) -> list:
    """(d)'s CLI load flags: RMAT-20's TSV under the hash partitioner with
    the phase's garc cache, SSSP from 0."""
    efile, vfile = shared_rmat_tsv(SCALE)[:2]
    return ["--efile", efile, "--vfile", vfile, "--partitioner_type",
            "hash", "--serialization_prefix", os.path.join(tmp, "garc"),
            "--device", torch.device(device).type, "--application", "sssp",
            "--sssp_source", "0"]


def dist_d_start(tmp, device) -> dict:
    """(d)'s children that need nothing of (b) or (c), started beside
    (b)'s: the cold one-process fnum-2 child (its TSV load writes the
    fnum-2 cache) and `fault_drill.py --kill_rank --apps sssp` on
    p2p-31."""
    dev = torch.device(device).type
    cold = start_children([[sys.executable, "-c", DIST_CHILD,
                            *dist_d_load(tmp, device), "--fnum", "2",
                            "--serialize", "--out_prefix",
                            os.path.join(tmp, "d_cold")]], {})
    drill = start_children([[
        sys.executable, "-m", "libgrape_lite_tpu_torch.scripts.fault_drill",
        "--kill_rank", "--apps", "sssp", "--device", dev, "--workdir",
        os.path.join(tmp, "d_drill")]], {})
    return {"cold": cold, "drill": drill, "t0": time.perf_counter()}


def dist_d_gang_start(tmp, device) -> dict:
    """(d)'s RMAT-20 SSSP gang at fnum 4 over two gloo ranks (hash
    partitioner, the garc cache (b)'s one-process child wrote) with
    kill_rank@4:1 and a sharded lineage, started beside (b)'s RMAT-20
    gangs."""
    ck = os.path.join(tmp, "d_ck")
    port = free_port()
    gang = start_children([
        [sys.executable, "-c", DIST_CHILD, *dist_d_load(tmp, device),
         "--fnum", str(PIPE_FNUM), "--deserialize", "--checkpoint_every",
         str(DIST_FT_EVERY), "--checkpoint_dir", ck, "--out_prefix",
         os.path.join(tmp, "d_gang"), "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(r)]
        for r in range(2)], {"GRAPE_DIST_BACKEND": "gloo",
                             "GRAPE_FT_FAULTS": f"kill_rank@{DIST_KILL_AT}:1"})
    return {"gang": gang, "t0": time.perf_counter()}


def dist_ft_gang_phase(tmp, device, early, killed) -> dict:
    """(d) `killed`'s RMAT-20 kill_rank@4:1 gang (`dist_d_gang_start`)
    and `early`'s children (`dist_d_start`: `fault_drill.py --kill_rank
    --apps sssp` on p2p-31 and a cold one-process fnum-2 child writing
    the fnum-2 cache) waited for and checked.  Then one process (this
    one) resumes the two-rank lineage onto fnum 2, bit-equal to the cold
    query."""
    from libgrape_lite_tpu_torch import obs
    from libgrape_lite_tpu_torch.ft.faults import DEFAULT_KILL_EXIT_CODE
    from libgrape_lite_tpu_torch.runner import QueryArgs, run_app

    dev = torch.device(device).type
    load = dist_d_load(tmp, device)
    efile, vfile = load[1], load[3]
    garc = os.path.join(tmp, "garc")
    ck = os.path.join(tmp, "d_ck")
    deadline = killed["t0"] + DIST_CHILD_TIMEOUT_S
    g = wait_children(killed["gang"], deadline)
    gang_s = time.perf_counter() - killed["t0"]
    c = wait_children(early["cold"], deadline)
    (rc, so, se), = wait_children(early["drill"], deadline)
    children_s = time.perf_counter() - early["t0"]
    check(g[1][0] == DEFAULT_KILL_EXIT_CODE and g[0][0] not in (0, None),
          f"[dist] (d) rmat{SCALE} kill_rank@{DIST_KILL_AT}:1: rank rcs "
          f"{[x[0] for x in g]}\n{g[0][2][-2000:]}\n{g[1][2][-2000:]}")
    _, meta = newest_meta(ck)
    check(meta["rounds"] == DIST_KILL_AT and meta["ranks"] == 2
          and meta["layout"] == "sharded",
          f"[dist] (d) lineage: rounds {meta['rounds']} ranks "
          f"{meta.get('ranks')} {meta.get('layout')}")
    check(c[0][0] == 0, f"[dist] (d) cold fnum-2 child: rc {c[0][0]}\n"
          f"{c[0][2][-2000:]}")
    cold_rec = json.loads([ln for ln in c[0][1].splitlines()
                           if ln.startswith("[dist-child] ")][-1][13:])
    check(rc == 0 and "fault_drill: PASS" in so,
          f"[dist] (d) fault_drill --kill_rank: rc {rc}\n{so[-3000:]}"
          f"\n{se[-2000:]}")
    ft_line = [ln for ln in so.splitlines() if '"ft_drill"' in ln][-1]
    fd = json.loads(ft_line)["ft_drill"]
    check(fd["byte_identical"] and fd["gang_trace_complete"]
          and fd["gang_cross_rank_flows"] >= 1 and fd["gang_bundle_verified"],
          f"[dist] (d) ft_drill record {fd}")
    print(f"[dist] (d) fault_drill --kill_rank --apps sssp --device {dev} "
          f"(p2p-31, gloo on one card): {ft_line}", flush=True)
    # one process resumes the two-rank lineage onto fnum 2
    obs.configure(in_memory=True)
    reset_launch_counts()
    sync(device)
    t1 = time.perf_counter()
    wk = run_app(QueryArgs(
        application="sssp", efile=efile, vfile=vfile, fnum=2,
        partitioner_type="hash", serialization_prefix=garc,
        deserialize=True, resume=True, checkpoint_dir=ck,
        out_prefix=os.path.join(tmp, "d_res"), device=device))
    sync(device)
    wall = time.perf_counter() - t1
    counts = launch_counts()
    restore = span_ms(obs.history(), "checkpoint_restore_resharded")
    obs_reset()
    check(len(restore) == 1 and counts["gather_reduce"] > 0,
          f"[dist] (d) resume: {len(restore)} reshards, K1 {counts}")
    check(read_results(os.path.join(tmp, "d_res"), 2)
          == read_results(os.path.join(tmp, "d_cold"), 2),
          "[dist] (d) the resharded resume's files differ from the cold "
          "fnum-2 query's")
    print(f"[dist] (d) rmat{SCALE} sssp fnum {PIPE_FNUM} 2 gloo ranks "
          f"kill_rank@{DIST_KILL_AT}:1 (rank rcs {[x[0] for x in g]}, gang "
          f"{gang_s:.1f} s from its start beside (b)'s rmat{SCALE} gangs "
          f"to its wait): one process resumed the 2-rank lineage onto "
          f"fnum 2 byte-equal to the cold query (rounds {wk.rounds}, cold "
          f"{cold_rec['rounds']}, K1 {counts['gather_reduce']}); "
          f"restore_ms={restore[0]:.3f} run_app_s={wall:.3f} (the garc "
          f"load included); children {children_s:.1f} s", flush=True)
    return {"dist ft gang rmat sssp resume": dict(
                counts=counts, rounds=wk.rounds,
                cold_rounds=cold_rec["rounds"], restore_ms=restore[0],
                run_app_s=wall, gang_s=gang_s, children_s=children_s),
            "dist ft drill": dict(counts={}, ft_drill=fd)}


def i2_jobs(prefix, device) -> dict:
    """(i2)'s jobs: DIST_I_JOBS on p2p-31 at fnum 4 (k 2)."""
    plain, _ = p2p_query_fields(device)
    out = {}
    for name, args in DIST_I_JOBS.items():
        args = dict(args)
        env = args.pop("_env", {})
        sfx = name.replace(" ", "_")
        out[name] = dict(plain, out_prefix=f"{prefix}_{sfx}", **args,
                         **({"_env": env} if env else {}))
    return out


def vc_under(frag, spec):
    """A one-process vertex-cut fragment placed under `spec` (a world-1
    group: the same tiles, the grid's collectives through the group)."""
    import copy

    fd = copy.copy(frag)
    fd.comm_spec = spec
    fd.grid = spec.vc_grid(frag.k)
    return fd


def dist_i1_phase(vcf, f4d, spec, device) -> dict:
    """(i1) under (a)'s one-rank group: the vertex-cut apps on [vc]'s
    RMAT-20 k 2 tiles against the same queries in one process --
    bit-equal (PageRank within 1e-4), the same rounds and K1 launches --
    and GRAPE_PIPELINE=force sssp, bfs, wcc on the RMAT-20 fnum-4
    fragment under the group, under gather and mirror, against their
    serial rounds (`pipe_runs`: bit-equal, equal host syncs); the
    collectives and bytes a round, the walls (median of 3)."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    runs = {}
    for name, side, kw in DIST_I_VC:
        factory = APP_REGISTRY[name]
        one_f = vcf[side]
        fd = vc_under(one_f, spec)
        run_query(one_f, factory(), device, **kw)  # warm-ups
        run_query(fd, factory(), device, **kw)
        reset_launch_counts()
        one, _ = run_query(one_f, factory(), device, **kw)
        k1_one = launch_counts()["gather_reduce"]
        reset_launch_counts()
        spec.reset_stats()
        wk, _ = run_query(fd, factory(), device, **kw)
        counts = launch_counts()
        stats = dict(spec.stats)
        check(wk.rounds == one.rounds, f"[dist] (i1) {name}: {wk.rounds} "
              f"rounds against {one.rounds} in one process")
        check(counts["gather_reduce"] == k1_one and (
            k1_one > 0 or torch.device(device).type != "cuda"),
              f"[dist] (i1) {name}: K1 {counts['gather_reduce']} against "
              f"{k1_one} in one process")
        rtol = DIST_PR_RTOL if name.startswith("pagerank") else 0
        got, want = wk.result_values(), one.result_values()
        err = same_or_close(got, want, rtol, f"[dist] (i1) {name}")
        walls = [run_query(fd, factory(), device, **kw)[1]
                 for _ in range(DIST_REPEATS)]
        walls_one = [run_query(one_f, factory(), device, **kw)[1]
                     for _ in range(DIST_REPEATS)]
        per = max(wk.rounds, 1)
        rec = dict(counts=counts, rounds=wk.rounds,
                   bit_equal=got.tobytes() == want.tobytes(),
                   max_rel_err=err, collectives=stats["calls"],
                   collectives_per_round=stats["calls"] / per,
                   bytes_per_round=stats["bytes"] / per,
                   vc_reduce=stats["vc_reduce"],
                   vc_transpose=stats["vc_transpose"],
                   all_gather=stats["all_gather"],
                   wall_s=float(np.median(walls)),
                   wall_single_s=float(np.median(walls_one)))
        check(stats["all_gather"] == 0, f"[dist] (i1) {name}: "
              f"{stats['all_gather']} all_gathers in a vertex-cut query")
        runs[f"dist world1 (i1) {name}"] = rec
        same = ("bit-equal" if rec["bit_equal"]
                else f"max_rel_err={err:.3e}")
        print(f"[dist] (i1) world 1 {spec.transport} {name} RMAT-{SCALE} "
              f"k {one_f.k}: rounds={wk.rounds} {same} "
              f"K1={counts['gather_reduce']} (one process {k1_one}) "
              f"collectives/round={rec['collectives_per_round']:.2f} "
              f"B/round={rec['bytes_per_round']:.0f} wall_s="
              f"{rec['wall_s']:.4f} single_s={rec['wall_single_s']:.4f}",
              flush=True)
    for mode in ("gather", "mirror"):
        with env_set(GRAPE_EXCHANGE=mode):
            for name, kw in DIST_I_PIPE:
                factory = APP_REGISTRY[name]
                rec, _ = pipe_runs(f"(i1) world 1 {mode} {name}", f4d,
                                   factory, kw, device, PIPE_K1[name])
                with env_set(GRAPE_PIPELINE="force"):
                    spec.reset_stats()
                    wk, _ = run_query(f4d, factory(), device, **kw)
                    stats = dict(spec.stats)
                per = max(wk.rounds, 1)
                rec.update(collectives_per_round=stats["calls"] / per,
                           bytes_per_round=stats["bytes"] / per)
                runs[f"dist world1 (i1) pipelined {mode} {name}"] = rec
                print(f"[dist] (i1) world 1 {spec.transport} pipelined "
                      f"{mode} {name}: collectives/round="
                      f"{rec['collectives_per_round']:.2f} B/round="
                      f"{rec['bytes_per_round']:.0f} serial_s="
                      f"{rec['serial']['median_s']:.4f} pipelined_s="
                      f"{rec['pipelined']['median_s']:.4f}", flush=True)
    return runs


def dist_i3_cases(vcf, f4, device) -> dict:
    """(i3) K1 on rank 1's tile slab of the RMAT-20 k 2 cut at world 4
    (one tile's CSR rows, neighbours into its row chunk: min+w and sum),
    and on rank 1's boundary split CSR of the RMAT-20 fnum-4 stack at
    world 2 (min+w, columns into the slab's splice table), each against
    its plain version."""
    import copy

    from libgrape_lite_tpu_torch.fragment.vertexcut import VCDeviceCSR
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec, VCGrid
    from libgrape_lite_tpu_torch.parallel.pipeline import resolve_pipeline

    world, rank = DIST_I_TILE
    fs = copy.copy(vcf["sym"])
    fs.grid = VCGrid(fs.k, world, rank)
    fs._host_csrs = {k: v for k, v in fs._host_csrs.items()
                     if not k.startswith("slab_")}
    cat = fs._slab_csr("ie")
    side = VCDeviceCSR(*(torch.from_numpy(np.ascontiguousarray(a)).reshape(
        1, -1).to(device) for a in (cat.indptr, cat.edge_nbr)), None)
    w = torch.from_numpy(cat.edge_w).reshape(1, -1).to(device)
    gen = torch.Generator(device="cpu").manual_seed(5)
    n = fs.grid.nr * fs.vc
    x = torch.rand(n, generator=gen).to(device)
    dist = torch.where(torch.rand(n, generator=gen) < 0.3,
                       torch.tensor(float("inf")),
                       torch.rand(n, generator=gen) * 50).to(device)
    out = {}
    for kind, xx, ww in (("min+w", dist, w), ("sum", x, None)):
        label = (f"rank-{rank} tile slab (world {world}, k {fs.k}) "
                 f"{kind}")
        rec = vc_k1_case(label, side, ww, xx, kind.split("+")[0], device)
        out[f"(i3) tile slab {kind}"] = rec
        print(f"[dist] (i3) K1 {label}: edges={rec['edges']} "
              f"rows={rec['rows']} ms={rec['ms']:.4f} plain_ms="
              f"{rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})",
              flush=True)
    world, rank = DIST_I_SPLIT
    fd = dist_fragment(f4, CommSpec(f4.fnum, device, rank=rank, world=world))
    with env_set(GRAPE_PIPELINE="force"):
        plan = resolve_pipeline(fd, app_name="SSSP", key="dist",
                                with_weights=True, w_dtype=torch.float32)
    check(plan is not None, "[dist] (i3) no pipeline plan on the slab")
    ent = plan.host_entries
    n = fd.fl * fd.vp + fd.fnum * fd.vp  # the splice: live slab, gathered
    xs = torch.where(torch.rand(n, generator=gen) < 0.3,
                     torch.tensor(float("inf")),
                     torch.rand(n, generator=gen) * 50).to(device)
    out["(i3) split boundary min+w"] = pipe_k1_case(
        f"(i3) rank-{rank} boundary split CSR (world {world}) min+w",
        ent["pl_b_indptr"], ent["pl_b_nbr"], ent["pl_b_w"], xs, device)
    return out


def dist_phases(f4, device, frag=None, vcf=None) -> dict:
    """[dist]: the multi-process runtime on the card -- (a) NCCL at world
    1 in this process with K1 on a rank's slab CSR, (e1) CDLP, lcc,
    PageRank strict and lcc_bitmap under the same group and (e3) K2 and
    K3 on rank 1's slab, (f1) the overlay, incremental queries and the
    six K1 library apps under the same group and (f3) the overlay fold on
    rank 1's slab, (g1) the edge-cut variants under the same group and
    (g3) K1 on rank 1's push-CSR slab, (b) two ranks over gloo on one
    card with (e2)'s gangs of cdlp, lcc and lcc_bitmap, (f2)'s delta
    loads and six apps and (g2)'s variants beside them, NCCL across two
    cards where this run sees them;
    (c) sharded checkpoints, resume, the vote and the reshard under the
    world-1 group, (d) the kill-rank drill and an RMAT-20 kill and
    reshard with two gloo ranks (`frag`: RMAT-20 with its edge list, for
    (c)'s fnum-2 target); (i1) the vertex cut on [vc]'s k 2 tiles (`vcf`)
    and the pipelined round under the world-1 group, (i3) K1 on a rank's
    tile slab and split CSR, (i2) gloo gangs of two and four ranks of the
    vertex cut, GRAPE_PARTITION=2d and the pipelined round beside (b)'s
    children."""
    import tempfile
    import threading

    t_phase = time.perf_counter()
    w1 = dist_world1_phase(f4, device, vcf)
    # (c)'s fnum-2 target is built while (b)'s children run
    built = {}

    def build_f2():
        built["f2"] = pipe_fragment(frag, device, fnum=2)

    f2_thread = threading.Thread(target=build_f2, name="grape-f2-build")
    f2_thread.start()
    with tempfile.TemporaryDirectory(prefix="grape-dist-") as tmp:
        staged = torch.device(device).type == "cuda"
        # (f2), (g2) and (d)'s drill and cold child beside (b)'s children
        f2_gangs = run_app_children_start("f2", f2_jobs, tmp, device)
        g2_gangs = run_app_children_start(
            "g2", g2_jobs, tmp, device, {"GRAPE_SSSP_PROBE_CAP": "1"})
        h2_gangs = run_app_children_start("h2", h2_jobs, tmp, device)
        i2_gangs = [run_app_children_start(f"i2w{w}", i2_jobs, tmp, device,
                                           world=w) for w in DIST_I_WORLDS]
        d_early = dist_d_start(tmp, device)
        gl = dist_gang_phase("gloo", {"GRAPE_DIST_BACKEND": "gloo"},
                             "gloo-staged" if staged else "gloo", tmp,
                             rmat=True, device=device,
                             beside_rmat=lambda: dist_d_gang_start(
                                 tmp, device))
        f2g = run_app_children_finish(f2_gangs, device)
        g2g = run_app_children_finish(g2_gangs, device, DIST_G_FAMILY,
                                      golden_all=True)
        check(g2g["runs"]["dist gloo (g2) sssp_select"]["app"]
              == "SSSPDelta", "[dist] (g2) sssp_select did not pick "
              "sssp_delta under GRAPE_SSSP_PROBE_CAP=1")
        h2g = run_app_children_finish(
            h2_gangs, device, DIST_H_FAMILY,
            kernel=lambda job: "k3" if job in DIST_H_K3 else None)
        h2_checks(h2g["runs"], tmp)
        i2g = [run_app_children_finish(g, device, DIST_I_FAMILY,
                                       golden_all=True) for g in i2_gangs]
        f2_thread.join()
        nccl = {"runs": {}}
        if staged and torch.cuda.device_count() >= 2:
            nccl = dist_gang_phase("nccl", {}, "nccl", tmp, rmat=False,
                                   device=device)
        else:
            print("[dist] nccl world 2: not run, 1 card", flush=True)
        t_ft = time.perf_counter()
        f2, f2_s = built.pop("f2")
        print(f"[dist] (c) RMAT-{SCALE} fnum 2 hash cut built in "
              f"{f2_s:.2f} s (beside (b)'s children)", flush=True)
        c = dist_ft_world1_phase(f4, f2, device, tmp)
        del f2
        d = dist_ft_gang_phase(tmp, device, d_early, gl["beside"])
        ft_s = time.perf_counter() - t_ft
    secs = time.perf_counter() - t_phase
    print(f"[time] dist {secs:.1f} s (state and control across ranks "
          f"{ft_s:.1f} s; (f1) {w1['f1_seconds']:.1f} s, (f2)'s children "
          f"{f2g['children_s']:.1f} s beside (b)'s; (g1) "
          f"{w1['g1_seconds']:.1f} s, (g2)'s children "
          f"{g2g['children_s']:.1f} s beside (b)'s; (h1) + (h3) "
          f"{w1['h1_seconds']:.1f} s, (h2)'s children "
          f"{h2g['children_s']:.1f} s beside (b)'s; (i1) + (i3) "
          f"{w1['i1_seconds']:.1f} s, (i2)'s children "
          f"{max(g['children_s'] for g in i2g):.1f} s beside (b)'s)",
          flush=True)
    return {"seconds": secs, "ft_seconds": ft_s,
            "f1_seconds": w1["f1_seconds"],
            "f2_children_seconds": f2g["children_s"],
            "g1_seconds": w1["g1_seconds"],
            "g2_children_seconds": g2g["children_s"],
            "h1_seconds": w1["h1_seconds"],
            "h2_children_seconds": h2g["children_s"],
            "i1_seconds": w1["i1_seconds"],
            "i2_children_seconds": [g["children_s"] for g in i2g],
            "runs": {**w1["runs"], **gl["runs"], **f2g["runs"],
                     **g2g["runs"], **h2g["runs"],
                     **{k: v for g in i2g for k, v in g["runs"].items()},
                     **nccl["runs"], **c, **d},
            "k1": w1["k1"], "k2": w1["k2"], "k3": w1["k3"],
            "overlay_fold": w1["overlay_fold"],
            "nccl_world2": "run" if nccl["runs"] else "not run, 1 card"}


# ---- phase 8: the rate probe (and the capability probe, run first) ----

LINT_WINDOW = 4  # the pump's window in the dispatch-stage sync count
LINT_QUERIES = 32  # sssp queries over p2p-31 a pass: LINT_WINDOW batches
LINT_BATCH = 8


def lint_cli(args) -> tuple:
    """`lint <args> --json` (cli.py::lint_main) in a child process, its
    kernel launches counted there: (exit code, its JSON record or None,
    the child's launch counts, its stderr)."""
    code = (
        "import json, sys\n"
        "from libgrape_lite_tpu_torch.cli import lint_main\n"
        "from libgrape_lite_tpu_torch.ops import intersect, spmv\n"
        f"rc = lint_main({list(args) + ['--json']!r})\n"
        "print('[launches] ' + json.dumps({\n"
        "    'gather_reduce': spmv.gather_reduce.launches,\n"
        "    'gather_reduce_lanes': spmv.gather_reduce_lanes.launches,\n"
        "    'overlay_fold': spmv.overlay_fold.launches,\n"
        "    'strict_tile': spmv.spmv_strict.launches,\n"
        "    'intersect': intersect.row_and_popcount_indexed.launches}),\n"
        "    file=sys.stderr)\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                       capture_output=True, text=True, timeout=300)
    lines = r.stdout.strip().splitlines()
    counts = {}
    for line in r.stderr.splitlines():
        if line.startswith("[launches] "):
            counts = json.loads(line[len("[launches] "):])
    return (r.returncode, json.loads(lines[-1]) if lines else None, counts,
            r.stderr)


def dispatch_syncs_phase(device) -> dict:
    """Host syncs of the async pump's dispatch stage (`_fill`: pop,
    `_dispatch_stage`, `Worker.query_batch_prepare`) on a warmed window of
    LINT_WINDOW over LINT_QUERIES sssp queries on p2p-31, from CUDA's
    sync-debug mode.  Launches are held for the count (a launched batch's
    round loop runs in its own thread and reads its votes), then the
    window drains and every result is byte-identical to the warm pass."""
    from libgrape_lite_tpu_torch.fragment.loader import LoadGraph, LoadGraphSpec
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    data = os.path.join(HERE, "dataset")
    frag = LoadGraph(os.path.join(data, "p2p-31.e"),
                     os.path.join(data, "p2p-31.v"),
                     CommSpec(fnum=1, device=device),
                     LoadGraphSpec(weighted=True))
    stream = [("sssp", {"source": s})
              for s in serve_sources(frag, LINT_QUERIES)]
    sess = ServeSession(frag, policy=BatchPolicy(max_batch=LINT_BATCH))
    pump = sess.async_pump(window=LINT_WINDOW)
    for app, args in stream:
        sess.submit(app, args)
    warm = pump.drain()
    reset_launch_counts()
    for app, args in stream:
        sess.submit(app, args)
    dispatched = pump.stats["dispatched"]
    held = pump._launch_next
    pump._launch_next = lambda: None
    try:
        syncs = call_syncs(lambda: pump._fill(force=True), device)
    finally:
        pump._launch_next = held
    batches = pump.stats["dispatched"] - dispatched
    res = pump.drain()
    counts = launch_counts()
    pump.close()
    check(batches == LINT_WINDOW,
          f"the measured fill dispatched {batches} batches, want "
          f"{LINT_WINDOW}")
    same_results(warm, res, "the pump after the sync count")
    check(counts["gather_reduce_lanes"] > 0,
          "the measured window launched no K1 lane call")
    rec = dict(counts=counts, syncs=syncs, batches=batches,
               syncs_per_batch=syncs / batches, window=LINT_WINDOW,
               queries=len(res))
    print(f"[lint] dispatch stage: p2p-31 sssp, W={LINT_WINDOW}, "
          f"{len(res)} queries at max_batch {LINT_BATCH}: {syncs} host "
          f"syncs in _fill over {batches} dispatched batches = "
          f"{rec['syncs_per_batch']:.2f} a batch (launches held; "
          f"launches={counts})", flush=True)
    return rec


def lint_phase(device) -> dict:
    """grape-lint on the card (`[lint]`): `lint --json` (the AST rules over
    the port's tree: exit 0, the per-rule counts) and `lint --artifact
    --json` (A3: the warm sssp / bfs matrix through `Worker.query`,
    `query(guard="halt")`, `query_batch` and `query_incremental` on the
    card, every warmed cell at 0 build events) in child processes; then
    the dispatch stage's host syncs a batch (a measurement, not a gate)."""
    from libgrape_lite_tpu_torch import analysis

    t0 = time.perf_counter()
    out = {"runs": {}}
    rc, rec, _, err = lint_cli([])
    check(rc == 0 and rec is not None,
          f"lint exit {rc}: {err.strip()[-2000:]}")
    check(analysis.validate_lint_report(rec) == [],
          f"lint record off its schema: {analysis.validate_lint_report(rec)}")
    per_rule = {r: rec["counts"].get(r, 0) for r in analysis.RULES
                if r.startswith("R")}
    print(f"[lint] ast: exit {rc}, per-rule counts {per_rule}, suppressed "
          f"{rec['suppressed']}, stale {len(rec['stale'])}", flush=True)
    rc, rec, counts, err = lint_cli(["--artifact", "--device", str(device)])
    check(rc == 0 and rec is not None,
          f"lint --artifact exit {rc}: {err.strip()[-2000:]}")
    check(analysis.validate_lint_report(rec) == [],
          f"lint --artifact record off its schema: "
          f"{analysis.validate_lint_report(rec)}")
    audit = rec["artifact"]["build_audit"]
    check(audit["device"].startswith("cuda"),
          f"A3 ran on {audit['device']}, not the card")
    check(len(audit["cells"]) == 8, f"A3 ran {len(audit['cells'])} cells")
    for cell in audit["cells"]:
        print(f"[lint] A3 {cell['app']} {cell['mode']}: builds "
              f"{cell['builds']} {cell['events']}", flush=True)
        check(cell["builds"] == 0,
              f"A3: warmed {cell['app']} {cell['mode']} built "
              f"{cell['events']}")
    check(counts.get("gather_reduce", 0) > 0
          and counts.get("gather_reduce_lanes", 0) > 0,
          f"the A3 matrix did not launch K1 and the lane K1: {counts}")
    print(f"[lint] artifact: exit {rc}, {len(audit['cells'])} cells, "
          f"unexpected builds {audit['unexpected_builds']}, launches "
          f"{counts}", flush=True)
    out["runs"]["lint artifact"] = dict(counts=counts, per_rule=per_rule,
                                        cells=audit["cells"])
    out["runs"]["lint dispatch"] = dispatch_syncs_phase(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def caps_phase():
    """Which primitives this nvcc builds for sm_90a (compiled, never
    launched); any that fails prints the compiler's message.  `main`
    hands the missing ones to the build, whose failure names them, and
    then fails the run."""
    from libgrape_lite_tpu_torch.ops import caps as caps_mod

    caps = caps_mod.cuda_build_caps()
    for name in caps_mod.CAPABILITIES:
        print(f"[caps] {name}: {'ok' if caps[name] else 'fail'}", flush=True)
        if not caps[name]:
            for line in caps.log[name].splitlines():
                print(f"[caps]   {line}", flush=True)
    print(f"[caps] {len(caps)} probes (nvcc sm_90a, compiled only): "
          f"{caps.seconds:.2f} s", flush=True)
    return caps


def probe_phase(device, e_log: int) -> dict:
    """The rate probe at 2^e_log elements: its entry point run once with
    the launch counts zeroed just before and read just after (the kernel
    times are that run's), then each kernel against its plain version on
    the same inputs, with plain, library and bound times."""
    from libgrape_lite_tpu_torch.ops import probe
    from libgrape_lite_tpu_torch.scripts import cuda_probe
    from libgrape_lite_tpu_torch.utils.timing import time_ms

    probe.reset_launch_counts()
    recs = {r["case"]: r for r in cuda_probe.main(
        ["--e_log", str(e_log), "--device", str(device)])}
    counts = probe.launch_counts()
    check(tuple(recs) == cuda_probe.CASES, f"probe cases {list(recs)}")
    for name, n in counts.items():
        check(n > 0, f"probe e_log {e_log}: {name} was never launched")

    inp = cuda_probe.make_inputs(e_log, device)
    a, idx, tab128 = inp["a"], inp["idx"], inp["tab128"]
    idx64 = idx.long()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    one = torch.ones((), device=device)  # 1 + 2a in one elementwise call
    # case -> (kernel, plain, library); bit-equal unless cumsum
    calls = {
        "vpu_stream": (lambda: probe.stream(a),
                       lambda: probe.stream_plain(a),
                       lambda: torch.add(one, a, alpha=2.0)),
        "lane_gather_t128": (
            lambda: probe.lane_gather_t128(tab128, idx),
            lambda: probe.lane_gather_t128_plain(tab128, idx),
            lambda: torch.gather(tab128.expand(idx.shape), 1, idx64)),
        "cumsum_lanes": (lambda: probe.cumsum_lanes(a),
                         lambda: probe.cumsum_lanes_plain(a),
                         lambda: torch.cumsum(a, 1)),
    }
    for s, (tab, ix) in inp["sublane"].items():
        ix64 = ix.long()
        calls[f"sublane_gather_S{s}"] = (
            lambda tab=tab, ix=ix: probe.sublane_gather(tab, ix)[0],
            lambda tab=tab, ix=ix: probe.sublane_gather_plain(tab, ix),
            lambda tab=tab, ix64=ix64: torch.gather(tab, 0, ix64))
    out = {}
    for case, (kernel, plain, library) in calls.items():
        rec = recs[case]
        got, want = kernel(), plain()
        sync(device)
        if case == "cumsum_lanes":
            prefix_abs = torch.cumsum(a.double().abs(), 1)
            for ref, what in ((want, "plain version"),
                              (library(), "torch.cumsum")):
                err = (got.double() - ref.double()).abs()
                check(bool((err <= probe.CUMSUM_TOL * prefix_abs).all()),
                      f"probe cumsum_lanes vs {what}: off by "
                      f"{float((err / prefix_abs.clamp(min=1e-30)).max()):.3e}"
                      " of the prefix sum of |a|")
            max_err, rule = float((got - want).abs().max()), "1e-5 prefix|a|"
        else:
            check(torch.equal(got, want), f"probe {case} (e_log {e_log}) not "
                  "bit-equal to its plain version")
            check(torch.equal(got, library()),
                  f"probe {case} differs from the library call")
            max_err, rule = 0.0, "bit-equal"
        if case.startswith("sublane_gather"):
            s = int(case.rsplit("S", 1)[1])
            # whole table in shared memory; else column slices
            want_at = "shared" if s * 512 <= optin else "sliced"
            check(rec["placement"] == want_at, f"probe {case}: table read "
                  f"from {rec['placement']}, expected {want_at}")
        plain_ms = time_ms(plain, device, 5)
        lib_ms = time_ms(library, device, 5)
        ops = 2 * rec["elements"] if case == "vpu_stream" else rec["elements"]
        if rec["fits_l2"]:
            b_ms, b_by = None, "l2-resident: no HBM floor"
        else:
            b_ms, b_by = bound(rec["bytes"], ops)
        out[case] = dict(max_abs_err=max_err, ms=rec["ms"], plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         gb_s=rec["gb_s"], fits_l2=rec["fits_l2"],
                         placement=rec.get("placement"))
        b_txt = "none" if b_ms is None else f"{b_ms:.4f}"
        print(f"[probe] e_log={e_log} {case}: kernel_ms={rec['ms']:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_txt} ({b_by}) gb_s={rec['gb_s']:.1f} "
              f"fits_l2={rec['fits_l2']}"
              + (f" placement={rec['placement']}" if "placement" in rec
                 else "")
              + f" {rule} max_abs_err={max_err:.3e}", flush=True)
    mv = recs["dense_matvec_8192_f32"]
    b_ms, b_by = bound(mv["bytes"], 2 * mv["elements"])
    print(f"[probe] e_log={e_log} dense_matvec_8192_f32 (torch.mv, full "
          f"f32): ms={mv['ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"gb_s={mv['gb_s']:.1f}", flush=True)
    print(f"[probe] e_log={e_log} launches={counts}", flush=True)
    return dict(cases=out, counts=counts)


def probe_entries(probes: dict) -> list:
    """One `kernels` entry per probe kernel: the headline numbers are the
    first case at the largest e_log, every case at every size beside."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    top = max(probes)
    entries = []
    for wrapper, cases, line in PROBE_KERNELS:
        head = probes[top]["cases"][cases[0]]
        entries.append(dict(
            name=f"probe_{wrapper}", route="cuda",
            source="libgrape_lite_tpu_torch/csrc/probe.cu",
            replaces=f"scripts/pallas_probe.py:{line}",
            launches=sum(p["counts"][wrapper] for p in probes.values()),
            **{k: head[k] for k in keys}, headline=f"e_log {top} {cases[0]}",
            cases={f"e_log {e} {c}": p["cases"][c]
                   for e, p in probes.items() for c in cases}))
    return entries


def ptxas_lines(log: str) -> list:
    """nvcc -Xptxas -v per kernel: '<kernel><template args>: registers,
    shared memory; stack, spill stores and loads' (mangled template
    arguments, e.g. IfLi0ELb0EE = <float, 0, false>)."""
    out, kernel, spills = [], "?", ""
    for line in log.splitlines():
        entry = re.search(r"entry function '\w*?\d+([a-z][a-z_]*_kernel)"
                          r"(I\w*?EE)?", line)
        if entry:
            kernel, spills = entry.group(1) + (entry.group(2) or ""), ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "ptxas info" in line and "Used" in line:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def main() -> int:
    t_main = time.perf_counter()
    # the smoke drives one card: expose only the first visible one
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from libgrape_lite_tpu_torch.ops import _build

    device = "cuda"
    check(torch.cuda.device_count() == 1, "more than one card visible")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    card = card_line()
    print(card, flush=True)

    caps = caps_phase()

    t0 = time.perf_counter()
    secs = _build.build_all(missing_caps=caps.missing())
    for name, s in secs.items():
        print(f"[build] {name}.cu -> {_build.lib_path(name).name} "
              f"sm_90a: {s:.2f} s", flush=True)
        for line in ptxas_lines(_build.BUILD_LOG.get(name, "")):
            print(f"[build]   {line}", flush=True)
    print(f"[build] total {time.perf_counter() - t0:.2f} s", flush=True)
    check(not caps.missing(), f"nvcc does not build {caps.missing()}")

    t0 = time.perf_counter()
    frag, e_sym = rmat_fragment(SCALE, device, retain=True)
    deg = frag.host_ie[0].degree
    print(f"[graph] rmat{SCALE}: vertices={frag.dev.total_vnum} "
          f"in_edge_slots={e_sym} ep={frag.dev.ie.edge_nbr.shape[1]} "
          f"max_in_degree={int(deg.max())} isolated={int((deg == 0).sum())} "
          f"host_prep_s={time.perf_counter() - t0:.2f}", flush=True)

    kern = kernel_phases(frag, device, reps=30)
    kern_i32 = int_gather_phase(frag, device, reps=30)
    stacked_phase(device)
    k1_shapes_phase(frag, device)
    k2_shapes = k2_shapes_phase(frag, device)

    t0 = time.perf_counter()
    frag18, _ = rmat_fragment(BITMAP_SCALE, device)
    frag16, e16 = rmat_fragment(DIRECTED_SCALE, device, directed=True)
    print(f"[graph] rmat{BITMAP_SCALE} undirected, rmat{DIRECTED_SCALE} "
          f"directed ({e16} edges): host_prep_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    k3 = intersect_phase(frag18, device, reps=5)
    k3_shapes_phase(frag18, device)

    pr_auto = pagerank_phase(frag, e_sym, device, "auto")
    pr_strict = pagerank_phase(frag, e_sym, device, "strict")
    ss = sssp_phase(frag, e_sym, device)
    ldbc = ldbc_phases(frag, e_sym, frag18, frag16, device)
    variants = variants_phase(frag, e_sym, device)
    more = more_apps_phase(frag, e_sym, device)
    cliques = clique_phases(frag18, device)
    load = load_phase(device)
    spgemm = spgemm_phase(frag18, device)
    print(f"[spgemm] rmat{BITMAP_SCALE} credit pass {spgemm['credit_ms']:.4f} "
          f"ms beside K3 intersect oe {k3['oe']['ms']:.4f} + ie "
          f"{k3['ie']['ms']:.4f} ms (kernel phase, same graph)", flush=True)
    calib = calib_phase(frag, frag18, spgemm, device)
    sampler = sampler_phase(device)
    t0 = time.perf_counter()
    grid, grid_edges = grid_fragment(GRID_SIDE, device, retain=True)
    print(f"[graph] grid{GRID_SIDE}: vertices={grid.dev.total_vnum} "
          f"in_edge_slots={grid_edges} host_prep_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    select = select_phase(frag, grid, device)
    profile_phases(frag, frag18, device)
    golden_phase(device)
    more_golden_phase(device)
    dyn = dyn_phases(frag, grid, device)
    serve = serve_phases(frag, device)
    fleet = fleet_phases(
        frag, serve["runs"][f"serve session max_batch={SERVE_BATCH} sync"]
        ["qps"], device)
    observ = obs_phases(frag, device)
    ft = ft_phases(frag, device)
    grd = guard_phases(frag, device)
    print(f"[time] ft {ft['seconds']:.1f} s, guard {grd['seconds']:.1f} s",
          flush=True)
    gsrv = guard_serve_phase(frag, device)
    vc = vc_phases(frag, e_sym, device)
    print(f"[time] guard serve {gsrv['seconds']:.1f} s, vc "
          f"{vc['seconds']:.1f} s", flush=True)
    lint = lint_phase(device)
    print(f"[time] lint {lint['seconds']:.1f} s", flush=True)
    pipe = pipeline_phase(frag, vc["pipeline"], device)
    dist = dist_phases(pipe.pop("frag"), device, frag, vc.pop("frags"))
    probes = {e_log: probe_phase(device, e_log) for e_log in PROBE_E_LOGS}

    by_app = {"pagerank auto": pr_auto, "pagerank strict": pr_strict,
              "sssp": ss, **ldbc, **variants, **more, **cliques,
              "load": load, "spgemm": spgemm, "calib": calib, **dyn["runs"],
              **serve["runs"], **fleet["runs"], **observ["runs"],
              **ft["runs"], **grd["runs"], **gsrv["runs"], **vc["runs"],
              **lint["runs"], **pipe["runs"], **dist["runs"]}
    runs = list(by_app.values())
    launches = {k: sum(r["counts"].get(k, 0) for r in runs)
                for k in ("gather_reduce", "gather_reduce_lanes",
                          "overlay_fold", "strict_tile", "intersect")}
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the main path")
    for app in ("bfs", "wcc"):
        check(ldbc[app]["counts"]["gather_reduce"] > 0,
              f"{app} did not launch gather_reduce")
    for app in ("lcc_bitmap", "lcc_directed"):
        check(ldbc[app]["counts"]["intersect"] > 0,
              f"{app} did not launch intersect")
    check(cliques["triangle_count"]["counts"]["intersect"] > 0,
          "triangle_count did not launch intersect")
    gr = kern["gather_reduce[sum]"]
    gl = serve["kernel"][f"k{SERVE_BATCH} min+w"]
    st = kern["strict_tile"]
    ov = dyn["kernel"]["min+w"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        dict(name="gather_reduce", route="cuda",
             source="libgrape_lite_tpu_torch/csrc/spmv.cu",
             replaces="libgrape_lite_tpu/ops/spmv_pack.py:1954",
             launches=launches["gather_reduce"],
             **{k: gr[k] for k in keys},
             launches_by_app={app: r["counts"].get("gather_reduce", 0)
                              for app, r in by_app.items()},
             launches_vc={app: r["counts"].get("gather_reduce", 0)
                          for app, r in vc["runs"].items()
                          if r["counts"].get("gather_reduce")},
             vc_cases=vc["k1"],
             pipeline_cases=pipe["k1"],
             launches_pipeline={app: r["counts"].get("gather_reduce", 0)
                                for app, r in pipe["runs"].items()},
             dist_cases=dist["k1"],
             launches_dist={app: r["counts"].get("gather_reduce", 0)
                            for app, r in dist["runs"].items()},
             max_abs_err_all_kinds=max(
                 kern[f"gather_reduce[{k}]"]["max_abs_err"]
                 for k in ("sum", "min", "max")),
             ms_min=kern["gather_reduce[min]"]["ms"],
             ms_max=kern["gather_reduce[max]"]["ms"],
             config=gr["config"], passes_ms=gr["passes_ms"],
             device_passes_per_call=len(gr["passes_ms"]),
             **{f"{k}_int32_{kind}": kern_i32[kind][k]
                for kind in ("sum", "min", "max")
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             library_int32_sum=kern_i32["sum"]["library"],
             library_all_ms_int32_sum=kern_i32["sum"]["library_all_ms"]),
        dict(name="gather_reduce_lanes", route="cuda",
             source="libgrape_lite_tpu_torch/csrc/spmv.cu",
             replaces="libgrape_lite_tpu/ops/spmv_pack.py:1954",
             launches=launches["gather_reduce_lanes"],
             **{k: gl[k] for k in keys}, lanes=SERVE_BATCH, kind="min+w",
             library=gl["library"],
             launches_by_app={app: r["counts"]["gather_reduce_lanes"]
                              for app, r in {**serve["runs"],
                                             **fleet["runs"],
                                             **observ["runs"],
                                             **gsrv["runs"],
                                             **vc["runs"],
                                             **lint["runs"]}.items()
                              if "gather_reduce_lanes" in r["counts"]},
             max_abs_err_all=max(r["max_abs_err"]
                                 for r in serve["kernel"].values()),
             cases={k: {f: v for f, v in r.items() if f != "config"}
                    for k, r in serve["kernel"].items()},
             config=gl["config"], passes_ms=gl["passes_ms"]),
        dict(name="overlay_fold", route="cuda",
             source="libgrape_lite_tpu_torch/csrc/spmv.cu",
             replaces="libgrape_lite_tpu/ops/spmv_pack.py:1954",
             replaces_note="K1's use on the delta overlay; the JAX package "
             "folds it with an XLA segment min (libgrape_lite_tpu/app/"
             "base.py:351)",
             launches=launches["overlay_fold"], **{k: ov[k] for k in keys},
             kind="min+w", library="scatter_reduce_ amin",
             k1_path_ms=ov["k1_path_ms"], slots=ov["slots"], rows=ov["rows"],
             launches_by_app={app: r["counts"]["overlay_fold"]
                              for app, r in by_app.items()
                              if r["counts"].get("overlay_fold")},
             cases=dyn["kernel"],
             dist_cases=dist["overlay_fold"],
             launches_dist={app: r["counts"].get("overlay_fold", 0)
                            for app, r in dist["runs"].items()
                            if r["counts"].get("overlay_fold")}),
        dict(name="strict_tile", route="cuda",
             source="libgrape_lite_tpu_torch/csrc/spmv.cu",
             replaces="libgrape_lite_tpu/ops/spmv.py:128",
             launches=launches["strict_tile"], **{k: st[k] for k in keys},
             device_passes_per_call=len(st["passes_ms"]),
             library=st["library"], library_all_ms=st["library_all_ms"],
             passes_ms=st["passes_ms"], shapes=k2_shapes,
             dist_cases=dist["k2"],
             launches_dist={app: r["counts"].get("strict_tile", 0)
                            for app, r in dist["runs"].items()
                            if r["counts"].get("strict_tile")}),
        dict(name="intersect", route="cuda",
             source="libgrape_lite_tpu_torch/csrc/intersect.cu",
             replaces="libgrape_lite_tpu/ops/pallas_kernels.py:48",
             launches=launches["intersect"],
             **{k: k3["oe"][k] for k in keys},
             **{f"{k}_{name}": k3[name][k] for name in ("ie", "dense")
                for k in ("ms", "plain_ms", "bound_ms")},
             passes_ms={name: k3[name]["passes_ms"] for name in k3},
             dist_cases=dist["k3"],
             launches_dist={app: r["counts"].get("intersect", 0)
                            for app, r in dist["runs"].items()
                            if r["counts"].get("intersect")}),
    ]
    kernels += probe_entries(probes)
    kernels.append(dict(
        name="caps", route="cuda",
        source="libgrape_lite_tpu_torch/csrc/caps",
        replaces="libgrape_lite_tpu/ops/pallas_kernels.py:128",
        launches=0, compile_only=True, max_abs_err=None, ms=None,
        plain_ms=None, bound_ms=None, bound_by=None, library_ms=None,
        built=dict(caps), seconds=caps.seconds))
    print(f"[time] chip_smoke main: {time.perf_counter() - t_main:.1f} s "
          "(build, every phase and check)", flush=True)
    print(json.dumps({
        "card": card,
        "pagerank_mteps": {"auto": pr_auto["mteps"],
                           "strict": pr_strict["mteps"]},
        "sssp_mteps": ss["mteps"], "sssp_rounds": ss["rounds"],
        "ldbc": {app: {k: r[k] for k in ("rounds", "seconds", "mteps")}
                 for app, r in ldbc.items()},
        "variants": {app: {k: v for k, v in r.items() if k != "counts"}
                     for app, r in variants.items()},
        "more_apps": {app: {k: v for k, v in r.items() if k != "counts"}
                      for app, r in {**more, **cliques}.items()},
        "sssp_select": select,
        "load": {k: v for k, v in load.items() if k != "counts"},
        "spgemm": {k: v for k, v in spgemm.items() if k != "counts"},
        "calib": {k: v for k, v in calib.items() if k != "counts"},
        "sampler": sampler,
        "dyn": {k: v for k, v in dyn.items() if k != "runs"}
        | {"runs": {k: {f: x for f, x in r.items() if f != "counts"}
                    for k, r in dyn["runs"].items()}},
        "serve": {k: {f: x for f, x in r.items() if f != "counts"}
                  for k, r in serve["runs"].items()}
        | {"profile": serve.get("profile")},
        "fleet": {k: v for k, v in fleet.items() if k != "runs"}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in fleet["runs"].items() if not k.startswith("autopilot")},
        "autopilot": {k: {f: x for f, x in r.items() if f != "counts"}
                      for k, r in fleet["runs"].items()
                      if k.startswith("autopilot")},
        "obs": {"seconds": observ["seconds"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in observ["runs"].items()},
        "ft": {"seconds": ft["seconds"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in ft["runs"].items()},
        "guard": {"seconds": grd["seconds"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in grd["runs"].items()},
        "guard_serve": {"seconds": gsrv["seconds"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in gsrv["runs"].items()},
        "vc": {"seconds": vc["seconds"], "builds": vc["builds"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in vc["runs"].items()},
        "lint": {"seconds": lint["seconds"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in lint["runs"].items()},
        "pipeline": {"seconds": pipe["seconds"], "bytes": pipe["bytes"],
                     "truth": pipe["truth"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in pipe["runs"].items()},
        "dist": {"seconds": dist["seconds"],
                 "nccl_world2": dist["nccl_world2"]}
        | {k: {f: x for f, x in r.items() if f != "counts"}
           for k, r in dist["runs"].items()},
    }), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
