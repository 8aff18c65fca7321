#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  It imports nothing of JAX
and nothing of the JAX package.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), the torch / CUDA
   versions, and the builds of the kernels from
   ``src/repro_torch/csrc/`` (``deliver_fused.cu``, ``isect.cu``,
   ``segsum.cu``, ``flash.cu`` and ``flash_bwd.cu``, one ``nvcc`` each,
   started together, timed), with ``ptxas``'s registers, spills and
   shared memory for each ``flash`` and ``flash_bwd`` template and each
   ``segsum`` kernel; a spill in a ``flash_bwd`` tensor-core kernel, or
   a ``wgmma`` "Performance Loss" line in its log, fails;
2. kernel vs plain: on both delivery layouts of the DBLP regime at full
   scale, and on a bucket-padded v->he layout (a tenth of the
   incidences dead, so some hyperedges have live degree 0; every class
   padded to twice its rows, so half the slots are dead), the leaf
   kernel (``deliver_leaf_cuda``, one launch over every class) against
   ``deliver_fused_classes(..., lowering="plain")``, and every class
   through a one-class plan (``deliver_fused_cuda``) against
   ``deliver_fused_plain``, for sum/min/max/prod/or, float32 and int32,
   D = 1 and 4, with no activity, int32 activity and (the leaf) bool
   activity.  Bitwise for min/max/or/prod and integer-valued payloads;
   ``rtol = atol = 1e-5`` for random float sums (the plain version run
   in float64);
3. the main path: ``Engine(device="cuda").run`` with
   ``delivery="pallas_fused"`` against ``delivery="xla"`` — PageRank-30
   (1e-5 relative), SSSP from vertex 0 (bitwise, equal activity stats)
   and connected components (bitwise) — and the kernel's launch count
   over each fused run: exactly one per leaf and direction, pairs x
   (fwd leaves + bwd leaves);
4. timings (CUDA events, L2 flushed before each run, warm-up, median of
   20; beside them the device time of 20 flushed calls queued back to
   back, less the flushes, which leaves out the host's share of a
   call): per class and direction the kernel through a one-class plan and
   its plain version beside the memory bound; per leaf the one launch
   against the sum of its class bounds, its plain version and the
   port's ``xla`` delivery of the same leaf; end-to-end PageRank-30 and
   SSSP wall time, fused vs ``xla``;
5. intersection kernels vs plain, bitwise, on the Apache regime at full
   scale (the bitset index built by the port's ``build_index`` on the
   card): ``isect_fused_cuda`` (K3b) on 4,194,304 uniform pairs, as many
   Zipf-skewed pairs, self pairs and the census's own sampled triples
   (its three pair batches and its triple batch); ``isect_cuda`` (K3a)
   on the gathered uniform pairs and on the whole index; both on a
   random ``[78,080, 101]`` bitset with bit 31 set in many words; and
   the run cache's cases (alternating ids, runs across the 32-pair
   chunks, runs of one, P = 33 and 1, triples) at W = 1, 3, 101, 104,
   200 and on an unaligned base;
6. the analytics path: ``Engine(device="cuda").analyze(AnalyticsSpec(hg))``
   on Apache at full scale must resolve to bitset / bipartite / local /
   sample with the reference's reasons, launch K3a once and K3b four
   times, and give the census (counts, CI, triples seen) bit for bit as
   the ``merge`` path does; ``pair_intersections`` on the uniform pairs,
   bitset vs merge; an exact census on DBLP at scale 0.003 (where
   ``auto`` resolves to exact + bitset) against the ``clique``
   representation; a tiny exact census against a python-set oracle.
   Timings: per census batch the kernel, its plain version and the
   bound (CUDA events, L2 flushed, median of 20), the L2 row traffic a
   kernel without the run cache would read beside the L2 read rate
   measured on the table, and ``analyze``'s wall time split into host
   preprocessing, intersection calls and classification;
7. segment sum on the DBLP incidences at full scale (2,838,951 into
   782,659 hyperedges): ``segment_sum_mxu`` unsorted (K2a, the
   generator's order) and ``sorted_dst=True`` (K2b, ``sorted_by_dst``'s
   order) on float32 D = 1 and 64 and bfloat16 D = 64, launches counted,
   each against its plain version (float32 with
   ``tests/test_kernels.py``'s tolerance, bfloat16 within two bf16
   steps); K2b bitwise equal over two runs; K2a on shuffled ids; one
   segment taking every edge, an E that is no multiple of ``block_e``,
   ids outside ``[0, N)`` dropped, E = 0 giving zeros without a launch;
   K2b on Apache's vertex side (``make_dataset("apache", 1.0)``'s
   432,872 incidences sorted by vertex into 3,316 rows, the longest
   6,465 edges; float32 D = 64), repeatable.  Timings: kernel, plain
   version and ``index_add_`` into float32 beside the byte bound (CUDA
   events, L2 flushed, median of 20); K2a on shuffled ids (its sum over
   the three configs is the kernel line's ``shuffled_ms``); K2a and K2b
   on the one segment and K2b on Apache's vertex side, beside
   ``index_add_`` and the bound (the K2b line's ``phase7_one_segment_*``
   and ``phase7_skew_*`` keys);
8. attention through ``flash_attention`` (K4: bfloat16 on the tensor
   cores, float32 on the FMA units) at llama3.2-1b's width (32 heads of
   64): bfloat16 causal S = 32,768 (``prefill_32k``'s length, one
   sequence of its batch), float32 causal S = 4,096, bfloat16
   bidirectional S = 4,096, causal S = 32,040 (no multiple of the key
   tiles: partial last key and query tiles); at gemma3-12b's (16 heads
   of 256), bfloat16 causal S = 8,192; and at command-r-plus-104b's (96
   heads of 128), bfloat16 causal S = 8,192.  Launches counted; each
   against its plain version, elementwise (float32 2e-5, bfloat16 rtol
   1e-2 atol 5e-3) and per row relative to the row's largest value
   (float32 1e-4, bfloat16 2e-2), a limit that two planted faults (a
   dropped key tile, late denominators 5% high) must exceed; the first
   case bitwise equal over two runs.  Timings: kernel, plain version and
   ``scaled_dot_product_attention`` beside the larger of the byte bound
   and the operation bound (flops over the tensor-core or float32 FMA
   rate, exps over the MUFU rate; median of 3), the kernel's share of
   its bound and its TFLOP/s;
9. compile-once serving on DBLP at full scale through
   ``Engine(delivery="pallas_fused").compile``, each path's K1 launches
   counted from 0 and read after it (one per leaf and pair, every one
   replayed from the path's CUDA graph; PageRank-30: 90): compiled
   PageRank-30 against ``Engine.run`` (1e-5 relative), compiled SSSP
   from three sources (bitwise, equal stats) and components (bitwise),
   ``run_batch`` of 64 SSSP sources against 64 ``run(query=)`` calls
   (bitwise, equal stats, ``supersteps_executed`` the slowest query's)
   and of 8 personalized-walk seeds (1e-5 relative); second calls are
   cache hits with no new capture; no Result carries ``degraded_from``;
   a failing K1 launch raises from ``run`` (no plain twin on the card)
   and leaves no cache entry; the 64-query entry's bytes (its tensors
   and graph pool) against what the card allocated around its build,
   and the cache within its byte bound.
   Timings: compiled against ``Engine.run`` wall for PageRank-30 and
   SSSP (medians of 5, with dispatch, device wait and host syncs), the
   batch's queries/s against 64 sequential ``run(query=)`` calls and
   ``Engine.run``, and K1 at D = 1, 8 and 64 on the bucket-padded
   layout (call and device time) against ``deliver_leaf_plain``
   (bitwise), the port's ``xla`` lowering of the same leaf (bitwise;
   the K1 line's ``d8_library_ms`` / ``d64_library_ms``) and its byte
   bound, beside the per-query activity pass the batched path runs
   before it;
10. the card's delivery term: one delivery pair (v->he, then he->v),
   float32 sum, through ``deliver``'s ``xla`` lowering and the fused K1
   leaf, on DBLP at scales 0.002, 0.01, 0.05, 0.25 and 1.0 (5,660 to
   2,838,951 incidences) and D = 1, 2, 8, 16 and 64, each pair checked
   (1e-5) and timed (L2 flushed, median of 20); the grid is printed
   with ``select_delivery``'s pick as ``Engine.resolve`` makes it (rows
   over 64 bytes are contested: it times one pair on each lowering
   itself, and the times are logged), which must be the faster path at
   every point unless the two are within 10% (logged), and the traffic
   model's calibration record (``obs.delivery_calibration``);
11. the clique representation on DBLP at full scale: ``to_graph``
   (33,490,568 symmetric edges, timed), ``Engine(representation=
   "clique").run(vertex_pagerank_spec(hg))`` with K2's launches counted
   from 0 and read after it (K2b once an iteration: 30; K2a none: the
   out-weights take ``index_add_``, which measured faster there),
   ``graph_pagerank`` against its plain version (1e-5 relative), K2b
   bitwise equal over 31 calls with one set of offsets, ``auto``
   resolving bipartite on DBLP and clique on Fig. 1 (agreeing with the
   plain version there), and a traced ``explain`` + ``run`` whose
   winners are the run's and whose ``engine.run`` spans carry
   ``device_wait_s``.  Timings: the clique run (``to_graph`` included)
   beside the bipartite fused run of the same spec and
   ``graph_pagerank`` alone (host wall through a synchronize, median of
   3); K2b per iteration and K2a on the out-weights against their plain
   versions, ``index_add_`` and the byte bound;
12. fault-tolerant serving on DBLP at full scale through
   ``Engine(delivery="pallas_fused")``: (a) PageRank-30 with
   ``checkpoint_every=7`` bitwise equal to the run without; killed by
   ``checkpoint.chunk`` (``nth=2``, fatal) after pair 14; a fresh Engine
   resuming from pair 14, bitwise equal (values and activity trace),
   with K1's launches counted from 0 (the 16 resumed pairs: 48) and the
   snapshots' save and restore seconds; the same for SSSP from 0, which
   halts early (the trace padded), and once through ``Engine.compile``
   (``_run_checkpointed``); (b) ``Frontend`` over compiled SSSP and PPR
   (12 iterations, buckets 8 and 16 captured by ``warm`` before
   ``start``), 256 requests of a seeded trace (60% SSSP, sources
   uniform): every request resolves, no capture after ``warm``, 16
   sampled results against sequential ``run(query=)`` (SSSP bitwise,
   PPR 1e-5 relative); requests/s, queue-wait and execute p50/p99, flush
   reasons, bucket occupancy, the cache, K1's launches a flush, and the
   resilient front-end against ``resilience=False`` on the same trace;
   (c) the same trace under ``execute`` every 7 (transient),
   ``serve.flush`` nth 3 (transient) and ``serve.worker`` nth 2: every
   request resolves (futures waited with a timeout) with its fault-free
   value or a typed ``FaultError``, every rule fires; (d) ``execute``
   always, fatal: 4 requests resolve typed, none degrades to ``xla``;
   (e) ``python -m repro_torch.launch.serve_hypergraph --regime dblp
   --scale 1.0 --requests 200 --verify 8`` in a subprocess exits 0 and
   verifies 8;
13. the replica pool on one card, DBLP at full scale, phase 12's trace:
   (a) the parent warms SSSP and PPR (unbatched, buckets 8 and 16) into
   a fresh ``DiskExecutableCache`` (6 records written) and
   ``retrace_smoke`` on the card finds nothing; the parent's sequential
   compiled runs of every request are the oracle; (b) a ``Router`` over
   2 ``ProcessReplica``s booting ``require_no_retrace=True`` from the
   records (each: seconds to ready, records read, captures at boot,
   ``torch.cuda.memory_reserved`` and ``nvidia-smi``'s memory per
   process), the trace replayed: requests/s beside phase 12(b)'s
   single-process ``Frontend``, every value agreeing with the oracle
   (SSSP bitwise, PPR 1e-5 relative) and reaching the router as numpy,
   no capture in a replica after its warm, K1's launches a flush in
   each replica; (c) the trace again with ``kill -9`` of replica 0
   mid-replay: every request resolves (a value equal to the oracle's,
   or ``ReplicaLost`` / ``FrontendClosed``, at most ``MAX_FAILOVERS``),
   in_flight = pending = 0, a death and a respawn, which boots from the
   records with the sentinel armed (seconds from the kill to ready);
   (d) a pool under a seeded ``replica.hang``: the missed-heartbeat
   detector declares the hung replica dead and every request resolves;
   (e) ``python -m repro_torch.launch.serve_hypergraph --replicas 2
   --cache-dir <tmp> --warm --verify 8`` under a seeded
   ``replica.crash`` exits 0, verifies 8 and fires the plan.

14. the distributed backends on one card: an NCCL group of world size
   1 (``launch.mesh.init_local_group``; one card gives one rank, since
   NCCL refuses two ranks on one device) and ``make_host_mesh(1)``;
   (a) ``Engine(plan=random_vertex_cut, mesh=).run`` of phase 3's
   PageRank-30, SSSP and components under ``replicated`` and
   ``sharded`` with ``pallas_fused``, against phase 3's local runs
   (PageRank 1e-5 relative, the others bitwise with equal activity),
   K1's launches counted (one per leaf and pair), walls beside the
   local run's (median of 3, in turns); (b) K1 on the four shard layouts
   of a P = 4 ``random_vertex_cut`` plan (``build_shard_delivery``, one
   process): each against its plain version (min bitwise, float32 sum
   within 1e-5 of float64), the four partials combined equal to the
   whole-graph delivery, each shard's leaf time beside the whole
   graph's; (c) ``Engine(mesh=).analyze`` on phase 6's Apache census,
   resolved ``sharded``, field for field phase 6's, K3a / K3b launches
   counted; (d) ``Engine(mesh=, plan=).compile`` on both backends:
   PageRank-30 ``run`` against ``Engine.run`` (1e-5 relative) and
   ``run_batch`` of 8 SSSP sources against ``Engine.run`` (bitwise),
   each replayed from a CUDA graph captured with its collectives,
   queries/s; the group is destroyed at the end;
15. the static analysis on the card (``repro_torch.analysis``): (a) the
   card's shared memory per block without and with the opt-in equals
   ``shapes``' 49,152 and 232,448; (b) every entry function's static
   shared memory in phase 1's ``ptxas -v`` output of all five sources
   equals the model's (read from the sources' ``__shared__`` arrays per
   template instantiation), and each kernel's largest static and worst
   dynamic bytes are logged beside its limit; (c) each kernel once at
   the worst geometry its budget admits (K1 with span ``_MAX_SPAN``,
   K2a at ``block_n`` 4,096 and at the widest tile, K2b at the largest
   ``block_e`` for bfloat16 D = 8, K3a at its widest rings, K4 at head
   dim 256 in both types) against its plain version, bitwise on integer
   payloads, phase 8's tolerance for K4; (d) ``python -m
   repro_torch.analysis --device cuda --passes
   lint,digest,shapes,retrace`` exits 0;
16. the LM serving path (``repro_torch.launch.serve``) at llama3.2-1b's
   full width (16 layers, d_model 2,048, 32 heads over 8 KV heads of 64,
   1,235,814,400 float32 weights from seed 0): (a) K4 with K/V of 8
   heads for 32 query heads (the KV-head index) against ``flash_plain``
   at B = 4, S = 4,096 and 4,000, bfloat16 and float32, phase 8's
   tolerances, each failing two planted mapping faults (KV heads tiled
   as h % KvH; KV group 1 zeroed), and at S = 4,096 the kernel, its
   plain version and ``scaled_dot_product_attention(enable_gqa=True)``
   timed beside the bound, with the layout copies between the model's
   ``[B, S, H, hd]`` and K4's ``[B, H, S, hd]`` timed apart; (b) the
   launcher's ``--no-smoke --batch 4 --prompt-len 4096 --gen 16`` through
   ``serve.generate``: exactly 16 K4 launches a prefill and none a
   decode step, prefill ms and tokens/s, decode ms a step with the
   bfloat16 casts kept and with every weight cast each call, and a
   prefill's and a decode step's card busy time, idle share and kernels
   under ``torch.profiler``; (c) the
   prefill's last logits through K4 against the plain route (the
   script's hook swaps ``flash_plain`` in), within 5e-2 of the largest
   magnitude, K4's distance from the float32 prefill at most twice the
   plain route's, and float32 ``serve_step`` over 32 tokens reproducing
   float32 ``prefill`` within 2e-4 at ``highest`` matmul precision; (d)
   one timed prefill at ``prefill_32k``'s S = 32,768, its batch of 32 cut
   to 1; (e) the five LM ``smoke()`` configs (gemma's chunked local
   layers, command-r's parallel block, qwen3's and llama4's MoE on the
   global and the grouped dispatch) on the card, K4 route against plain
   route in float32 (1e-4) and bfloat16 (2e-2 where no router), with
   greedy decode; peak memory;
17. the LM training path (``repro_torch.launch.train``'s ``build``,
   ``make_step`` and ``synthetic_batch``) at llama3.2-1b's full width:
   (a) ``train_4k`` with its global batch of 256 cut to 8 (8 x 4,096
   tokens in 2 micro-batches, float32 masters and AdamW moments, layer
   remat), 3 steps with ``flash_plain`` and ``flash_plain_backward``
   made to raise (the script's hook): ms and tokens/s a step, loss,
   ``grad_norm``, ``lr``, exactly 64 K4 forward launches (16 layers x
   forward and remat x 2 micro-batches) and 32 backward calls a step,
   finite, the third loss below the first + 0.5, peak memory; (b) one
   step under ``torch.profiler``: card busy, idle share, the top
   kernels, and the shares of K4's forward, its backward, the matmuls
   and the optimizer (CUDA events around ``adamw_update``); (c) K4's
   forward lse against ``flash_plain``'s (float32 1e-5, bfloat16 1e-3,
   of 1 + |lse|), then K4's backward kernels (``flash_bwd.cu``) against
   ``flash_plain_backward`` of the plain forward's output and lse
   at B 4, H 32, KvH 8, S 4,096, D 64 in bfloat16 (2e-2 of each
   tensor's largest magnitude; the tensor-core route) and at smaller
   float32 (1e-4) and bfloat16 shapes (D 8, 36, 64, 128, 256, ragged S;
   each case's route logged), two runs bitwise equal, timed beside the
   bound, the plain version and
   ``scaled_dot_product_attention(enable_gqa=True)``'s backward, and no
   slower than ``BWD_MAX_MS``; (d) the
   five LM ``smoke()`` configs 2 steps each on the card, llama3.2-1b
   smoke's float32 gradients through K4 against the plain route (1e-4 of
   each leaf's largest magnitude), a checkpoint round trip bitwise, and
   a run cut at step 2 of 4 and resumed against the straight run
   (bitwise if two straight runs are, else within their difference);
   (e) ``python -m repro_torch.launch.train --smoke --steps 4
   --ckpt-every 2``, then with ``--steps 6 --resume``, which resumes at
   step 4 and trains steps 4 and 5.
18. the GNN side (``repro_torch.models.gnn`` through
   ``make_train_step``; every float message sum is ``mp_segment_sum`` on
   K2a): (a) gat-cora on ``full_graph_sm`` (2,708 nodes, 10,556 edges,
   1,433 features), PNA, NequIP and MACE on ``molecule`` (128 molecules
   of 30 nodes and 64 edges; positions, species and per-molecule
   energies for the equivariant ones), each at its ``CONFIG`` from seed
   0: 3 AdamW steps, finite losses, the third below the first + 0.5,
   ms a step (median of steps 1-2), peak memory and K2a's launches a
   step (> 0, the same each step); the forward and every gradient on the
   K2a route against the plain route (the script's hook swaps
   ``segsum_plain`` in) within 1e-4 of each tensor's largest magnitude,
   NequIP's ``forces`` too, each route also against the same call in
   float64 (the scatter's route), where float32 cannot meet 1e-4 K2a
   no further from float64 than twice the plain route; K2a against
   ``index_add_`` at the message shapes of those models (in turns); (b) gat-cora on ``ogb_products``
   (2,449,029 nodes, 61,859,140 random edges drawn on the card, d_in
   100, 47 classes, as ``launch/tasks.py``'s ``_gnn_model_cfg``), the
   edges cut by 5% a try only while the step does not fit the card
   (printed as ``reduced``): a step's ms and peak memory, 4 K2a
   launches, the step on K2a and on ``index_add_`` in turns, and K2a's
   calls at its four shapes alone beside the byte bound and
   ``index_add_`` (layer 1's ``[E, 64]`` also beside its plain version);
   (c) ``launch.gnn_sharded.make_edge_sharded_step`` in an NCCL group of
   one against the plain step for gat-cora, NequIP and MACE at (a)'s
   shapes (parameters within 5e-4, the loss within 5e-4 of max(1,
   |loss|)), the ``all_reduce`` calls a step counted.
19. the recsys side at bert4rec's ``CONFIG`` (a 1,000,448 x 64 float32
   item table, 2 blocks, 2 heads of 32, S = 200, from seed 0; every
   attention is ``models.attention.bidirectional_attention``: K4 with
   ``causal=False`` on the FMA tiles): (a) ``train_batch``'s
   ``loss_sampled`` (20 masked positions, 8,192 shared negatives) through
   ``make_train_step`` with ``AdamWConfig()``, its batch of 65,536 halved
   while a step does not fit (printed as ``reduced``), 3 steps with the
   plain attention versions made to raise: ms a step, sequences/s, peak
   memory, exactly 2 K4 forward and 2 backward launches a step, finite
   losses, the third below the first + 0.5, and one step under
   ``torch.profiler``; (b) ``serve_p99`` (512 sequences, ``serve_score``
   + top-100 over the catalog, median of 5), all of ``serve_bulk``
   (262,144 in chunks of 4,096, each its own top-100; its first rows
   against ``serve_p99``'s) and ``retrieval_cand`` (1 x 1,000,000
   candidates + top-100; the scores the full catalog's at the
   candidates within 1e-5); (c) on (a)'s weights and its first 1,024
   sequences, ``encode`` (1e-5) and one step's gradients (1e-4 of each
   leaf's largest magnitude) through K4 against the plain route
   (``naive_attention(causal=False)``), or K4 within twice the plain
   route's distance from a float64 call; K4 alone at [512 and (a)'s
   batch, 2, 200, 32], forward and backward against the plain version,
   timed beside the bound, ``scaled_dot_product_attention`` and the plain
   version; (d) ``sparse.embedding_bag`` over the table with bags = (a)'s
   sequences: one K2a launch a sum call, sum, mean and max against their
   plain versions (1e-4 of the largest magnitude), K2a on the gathered
   rows against ``index_add_`` (in turns) and its plain version beside
   the byte bound.
20. the dry-run (``repro_torch.launch.dryrun``: each cell traced at full
   size on fake tensors over a fake world of 512 ranks, priced on the
   H100's peaks, on the host): (a) ``--mesh single --out`` and ``--mesh
   multi --no-roofline`` in two subprocesses side by side, over the
   cells of ``DRYRUN_ARCHS`` x ``DRYRUN_SHAPES`` (the JAX package's
   smoke test's three cells and one cell of every other shape kind;
   ``--all`` takes longer than the phase's five minutes, on the MoE
   trains above all), and beside them a third, ``--mesh single
   --no-roofline --out`` over ``MOE_ARCH`` x ``DRYRUN_MOE_SHAPES`` (phase
   22 (c) reads its rows): each exits 0,
   every cell not skipped ``ok``, the table and the seconds printed; (b)
   the cells phases 16-19 ran, at their cuts (printed as ``reduced``),
   built on a 1 x 1 mesh over an NCCL group of one and traced: the
   llama3.2-1b prefill of 4 x 4,096, its ``train_4k`` step of 8 x 4,096
   in 2 micro-batches, gat-cora's ``full_graph_sm`` and PNA, NequIP and
   MACE's ``molecule`` steps, BERT4Rec's ``train_batch`` step at (19
   a)'s batch and ``serve_p99``; each then runs once more on the card
   (one warm call, one measured) with the phase's own inputs, and its
   line holds the phase's measured time (and its peak where the phase
   kept one per cell), the roofline's ``step_time_s`` and its share of
   that time, ``useful_ratio``, the predicted arguments, temp and
   outputs, and the card's ``max_memory_allocated`` over the call less
   what was held before its inputs were made; predicted and measured
   peaks more than 2x apart either way fail; (c) the traces launch no
   kernel and allocate nothing on the card: K4's, its backward's and
   K2a's launch counts and ``torch.cuda.memory_allocated()`` are the
   same after them as before.
21. the dense LM partitioned by DTensor placements (``launch.tasks``'
   partitioned cells) over a (data 1, model 1) mesh
   (``launch.mesh.make_mesh``) on an NCCL group of one: (a) llama3.2-1b
   at full width on phase 17's weights and batches (``train_4k`` cut to
   8 x 4,096 in 2 micro-batches) through ``build_task``'s partitioned
   step, 3 steps in turns with phase 17's plain step on a second state
   from the same seed, ``flash_plain`` / ``flash_plain_backward`` made
   to raise: exactly 64 K4 forward launches and 32 backward calls a
   partitioned step, the first step's loss within 1e-5, ``grad_norm``
   within 1e-4 and every parameter within 1e-4 of its leaf's largest
   magnitude of the plain step's, both routes' ms a step, the
   partitioned step's peak memory over what was held; (b) a
   partitioned prefill of 4 x 4,096 on phase 16's weights and prompts
   and 16 partitioned decode steps fed the plain route's greedy ids: 16
   K4 launches a prefill and none a decode step, logits within 1e-5 of
   the largest magnitude of the unpartitioned route's and every greedy
   id the same, both routes timed in turns and profiled (idle share, kernels a call); (c) phase
   20 (a)'s llama3.2-1b rows partitioned with collectives, and on this
   1 x 1 mesh each llama3.2-1b cell of phase 20 (b) traced partitioned
   within 1% of the FLOPs of its global trace, both traces timed.
22. the MoE LM partitioned by DTensor placements over a (data 1, model
   1) mesh on an NCCL group of one, qwen3-moe-235b-a22b at its full
   width (d_model 4,096, 64 heads over 4 KV heads of 128, 128 experts
   top-8 of d_ff 1,536, vocab 151,936, 32 dispatch groups) with its 94
   layers cut (printed as ``reduced``), random weights from seed 0,
   ``flash_plain`` / ``flash_plain_backward`` made to raise: (a) at 2
   layers, a partitioned prefill of 4 x 4,096 (16,384 tokens: 32 groups
   of 512, capacity 48) and 16 partitioned decode steps (the global
   route) fed the plain route's greedy ids: 2 K4 launches a prefill and
   none a decode step, logits within 1e-5 of the largest magnitude of
   the plain route's (or of what two plain prefills differ by) and
   every greedy id the same, both routes timed in turns and profiled
   (idle share, kernels a call); (b) at 1 layer, the ``train_4k`` step
   cut to 4 x 4,096 in 2 micro-batches (8,192 tokens each: 32 groups
   of 256, capacity 24) with float32 masters and AdamW, the plain step
   first (its updated leaves kept on the host: two states do not fit),
   then the partitioned step on a state rebuilt from the same seed: 4
   K4 forward and 2 backward launches a step, loss within 1e-5,
   ``grad_norm`` within 1e-4 and every parameter within 1e-4 of its
   leaf's largest magnitude of the plain step's, each route's second
   step timed, peaks over what was held; (c) phase 20 (a)'s MoE rows
   partitioned with collectives, and (a)'s and (b)'s cells traced
   partitioned on this 1 x 1 mesh within 1% of the FLOPs of their
   global traces.
23. BERT4Rec's cells partitioned by DTensor placements (the item table
   over ``model``, vocab-parallel lookups, K4 on each rank's own rows)
   over a (data 1, model 1) mesh on an NCCL group of one, at published
   width with random weights from seed 0, ``flash_plain`` /
   ``flash_plain_backward`` made to raise: (a) the ``train_batch`` step
   at phase 19 (a)'s batch, 3 steps in turns with phase 19's plain step
   on a second state from the same seed: 2 K4 forward and 2 backward
   launches a partitioned step, loss, ``grad_norm`` and every parameter
   bitwise the plain step's after each step, both routes' ms a step,
   the partitioned step's peak over what was held; (b) ``serve_p99``
   (512 sequences, the top-100 of each device's own rows under
   ``local_map``) and ``retrieval_cand`` (1 x 1,000,000 candidates, one
   top-100 over the gathered scores): scores and top-100 values and ids
   bitwise the plain route's, both routes timed in turns; (c) (a)'s and
   (b)'s cells traced partitioned on this 1 x 1 mesh within 1e-6 of the
   FLOPs of their global traces.
24. The GNN ``pjit`` cells partitioned by DTensor placements (edges and
   node rows over the flattened axes, node rows all-gathered for the
   gathers, K2a on each rank's own edges reduce-scattered to its rows)
   over a (data 1, model 1) mesh on an NCCL group of one: (a) gat-cora
   on ``full_graph_sm`` and PNA, NequIP and MACE on ``molecule``, each
   at its ``CONFIG`` from random weights of seed 0, ``GNN_STEPS`` steps
   in turns with the plain step on a second state from the same seed
   (the task's ``AdamWConfig()``): loss, ``grad_norm`` and every
   parameter within ``GNN_SHARD_TOL`` of the plain step's after each
   step (K2a's atomics move the last bits between runs), K2a launches a
   partitioned step equal to the plain step's (4 / 13 / 75 / 30), both
   routes' ms and the partitioned step's peak; (b) gat-cora on
   ``ogb_products`` at phase 18 (b)'s edge cut (cut further by 5% a
   try while the partitioned step does not fit, printed as
   ``reduced``), both routes in turns, their ms and peaks; (c) (a)'s
   and (b)'s cells traced partitioned on this 1 x 1 mesh within 1e-6
   of the FLOPs of their global traces.

Prints the kernel line (JSON; every entry carries phase 15's
``smem_static`` / ``smem_dynamic_worst``; K1's carries phase 9's compiled
launches and times, phase 12's ``phase12_*`` serving keys, phase
13's ``phase13_*`` pool keys and phase 14's ``dist_*`` keys; the isect
entries carry phase 14's ``dist_census_launches``; K2b's, phase 11's launches and numbers at the
clique's shapes, with phase 7's as ``phase7_*``; K2a's, phase 18's (its
launches over one step of each GNN; its times at gat-cora's layer-1
messages on ``ogb_products``) with the rest of phase 18 as ``gnn_*``,
phase 24's as ``gnn_mesh_*``, phase 19's bag pooling as ``bag_*``, phase 7's as ``phase7_*`` and the
clique out-weights' as ``out_w_*``; K4's, phase 8's, with phase 16's as
``lm_*``, phase 17's as ``train_*``, its backward's as ``bwd_*``,
phase 19's as ``recsys_*``, phase 21's as ``mesh_*``, phase 22's as
``moe_*`` and phase 23's as ``recsys_mesh_*``) and, last, the
device line
(JSON).  Exits non-zero, printing no result, when there is no card.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
# __popc results per clock per SM for compute capability 9.0: 16 (CUDA
# C++ Programming Guide, "Arithmetic Instructions", throughput table,
# row "population count").  Times the SMs and the max SM clock.
POPC_PER_CLOCK_PER_SM = 16
N_TIMED = 20
N_WARM = 3
N_PAIRS = 4_194_304
PLAIN_TILE = 1 << 18             # pairs per step of the plain version
# Reasons the reference's cost models give on Apache at full scale.
APACHE_DESIGN = {
    "kernel": ("bitset", "vocabulary small: word lanes beat sort-merge"),
    "representation": ("bipartite", "dual expansion exceeds edge budget: "
                       "derive intersections from the incidence"),
    "backend": ("local", "no mesh available"),
    "mode": ("sample", "overlap graph too large: sample linked pairs"),
}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def same_bits(a, b):
    """Bitwise equality, NaN positions included."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        na, nb = a.isnan(), b.isnan()
        if not torch.equal(na, nb):
            return False
        a = torch.where(na, torch.zeros_like(a), a).view(torch.int32)
        b = torch.where(nb, torch.zeros_like(b), b).view(torch.int32)
    return torch.equal(a, b)


def time_cuda(fn, flush, n_timed=N_TIMED, n_warm=N_WARM):
    """Median ms of ``fn()`` over ``n_timed`` runs, each after an L2
    flush, timed with CUDA events around the call alone."""
    import torch

    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_timed):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_two(fn_a, fn_b, flush, n_timed=N_TIMED, n_warm=N_WARM):
    """Median ms of ``fn_a()`` and of ``fn_b()``, timed in turns (a, b,
    a, b, ...) so that both meet the same state of the host, each after
    an L2 flush and from an idle card: the timer starts once the flush
    is done, so the host's dispatch counts in full.  (``time_cuda``
    starts it behind the flush, which hides up to the flush's ~80 us of
    a call's dispatch: a call of many small launches looks faster than
    it runs in a loop.)  The port's ``time_in_turns``, with which
    ``select_delivery`` times a contested point, so that phase 10's
    check and the pick measure alike."""
    from repro_torch.core.executor import time_in_turns

    return time_in_turns(fn_a, fn_b, flush.device, flush=flush,
                         turns=n_timed, warm=n_warm)


def time_device(fn, flush, n=N_TIMED):
    """Mean device ms of ``fn()`` after an L2 flush, without the host's
    share: ``n`` flushes and calls queued back to back (the flush gives
    the host a head start, so the card never waits on it), less the same
    ``n`` flushes alone, over ``n``."""
    import torch

    def queued(call):
        for _ in range(N_WARM):
            flush.zero_()
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            flush.zero_()
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return (queued(fn) - queued(lambda: None)) / n


def payloads(rng, n_src, d, dtype_name, monoid):
    """(payload, exact) pairs for one kernel check: host numpy, seeded."""
    import numpy as np

    shape = (n_src, d)
    if dtype_name == "int32":
        full = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
        if monoid == "or":
            return [(rng.integers(0, 2, shape).astype(np.int32), True)]
        return [(full.astype(np.int32), True)]
    if monoid == "sum":
        return [
            (rng.integers(-8, 9, shape).astype(np.float32), True),
            (rng.standard_normal(shape).astype(np.float32), False),
        ]
    if monoid == "prod":
        return [(rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape,
                            p=[0.45, 0.1, 0.45]), True)]
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 1e-3] = np.nan
    return [(x, True)]


def check_kernel(layouts, rng):
    """Phase 2: every layout, the leaf kernel (one launch over every
    class, ``deliver_leaf_cuda``) against ``deliver_fused_classes(...,
    lowering="plain")``, and every class through a one-class plan
    (``deliver_fused_cuda``) against ``deliver_fused_plain`` (for random
    float sums run in float64 and rounded to float32)."""
    import torch

    from repro_torch.kernels.deliver.fused import (
        deliver_fused_classes,
        deliver_fused_cuda,
        deliver_fused_plain,
        deliver_leaf_cuda,
    )
    from repro_torch.sparse.segment import MONOIDS

    dev = layouts[0][1].device
    n_checks, max_err = 0, 0.0
    cases = [("float32", m) for m in ("sum", "min", "max", "prod")]
    cases += [("int32", m) for m in ("sum", "min", "max", "prod", "or")]

    def same(tag, got, want, exact):
        nonlocal n_checks, max_err
        torch.cuda.synchronize()
        if exact:
            if not same_bits(got, want):
                fail(f"kernel != plain (bitwise) {tag}")
        else:
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                fail(f"kernel !~ plain {tag}: max abs err {err}")
        n_checks += 1

    for direction, lay in layouts:
        n_src = lay.n_src
        for d in (1, 4):
            for dtype_name, monoid in cases:
                kernel_monoid = "max" if monoid == "or" else monoid
                for payload, exact in payloads(rng, n_src, d, dtype_name,
                                               monoid):
                    msgs = torch.as_tensor(payload, device=dev)
                    ident = MONOIDS[kernel_monoid].identity(msgs.dtype)
                    msgs_aug = torch.cat([
                        msgs, torch.full((1, d), ident, dtype=msgs.dtype,
                                         device=dev)]).contiguous()
                    # Random float sums: the plain version runs in float64
                    # and is rounded once, so that its own float32 atomics
                    # (an order that changes from run to run) do not move
                    # the reference by as much as the tolerance.
                    ref_aug = msgs_aug if exact else msgs_aug.double()
                    live = torch.as_tensor(rng.random(n_src) < 0.7,
                                           device=dev)
                    act = torch.cat([live.to(torch.int32),
                                     torch.ones(1, dtype=torch.int32,
                                                device=dev)])
                    # The leaf: no activity, int32 activity, bool activity.
                    for act_aug, active in ((None, None), (act, act[:-1]),
                                            (act, live)):
                        got = deliver_leaf_cuda(msgs, active, lay,
                                                kernel_monoid)
                        want = deliver_fused_classes(
                            ref_aug, act_aug, lay, kernel_monoid,
                            lowering="plain").to(msgs.dtype)
                        if monoid == "or":
                            got, want = got > 0, want > 0
                        same((direction, "leaf", monoid, dtype_name, d,
                              None if active is None else active.dtype),
                             got, want, exact)
                    for act_aug in (None, act):
                        for c in range(lay.n_classes):
                            args = (msgs_aug, act_aug, lay.class_src[c],
                                    lay.class_dst[c], lay.class_bounds[c],
                                    lay.class_rows[c], kernel_monoid)
                            kw = dict(block_n=lay.block_n,
                                      block_e=lay.class_block_e[c])
                            got = deliver_fused_cuda(*args, **kw)
                            want = deliver_fused_plain(
                                ref_aug, *args[1:], **kw).to(msgs.dtype)
                            if monoid == "or":
                                got, want = got > 0, want > 0
                            same((direction, c, monoid, dtype_name, d,
                                  act_aug is not None), got, want, exact)
    return n_checks, max_err


def padded_layout(hg, rng):
    """The DBLP v->he layout with a tenth of the incidences masked dead
    (so some hyperedges have live degree 0) and every class's rows
    padded to twice the bucket (dead slots)."""
    import numpy as np

    from repro_torch.kernels.deliver import build_delivery_layout

    mask = (rng.random(hg.nnz) < 0.9).astype(np.int32)
    args = (hg.src, hg.dst, mask, hg.n_vertices, hg.n_hyperedges)
    rows = build_delivery_layout(*args).class_rows
    return build_delivery_layout(
        *args, class_rows_pad=tuple(2 * r for r in rows), device=hg.device)


def leaf_counts(spec):
    """Message leaves per direction: the vertex program's message on the
    initial state (fwd) and the hyperedge-bound message shape, which is
    ``initial_msg``'s (bwd)."""
    import torch

    from repro_torch.core.api import constant_initial_msg, tree_leaves

    hg = spec.hg0
    ids = torch.arange(hg.n_vertices, dtype=torch.int32, device=hg.device)
    msg0 = constant_initial_msg(spec.initial_msg, hg.n_vertices, hg.device)
    step = torch.zeros((), dtype=torch.int32, device=hg.device)
    out = spec.v_program.procedure(step, ids, hg.v_attr, msg0, hg.degrees())
    return len(tree_leaves(out.msg)), len(tree_leaves(spec.initial_msg))


def run_fused_counted(eng, spec):
    """One fused run with the launch counter zeroed just before and read
    just after; checks it against one launch per leaf and direction."""
    from repro_torch.kernels.deliver.fused import deliver_fused_cuda

    eng._delivery_layouts(spec.hg0)  # built before counting
    n_fwd, n_bwd = leaf_counts(spec)
    deliver_fused_cuda.launches = 0
    res = eng.run(spec, delivery="pallas_fused")
    launches = deliver_fused_cuda.launches
    pairs = res.decision["measured"]["pairs_run"]
    log(f"  {spec.name}: fused launches {launches} = {pairs} pairs x "
        f"({n_fwd} fwd leaves + {n_bwd} bwd leaves), one launch per leaf")
    if launches != pairs * (n_fwd + n_bwd) or launches == 0:
        fail(f"{spec.name}: {launches} launches, expected one per leaf: "
             f"{pairs * (n_fwd + n_bwd)}")
    return res, launches


def build_kernels():
    """Phase 1: one ``nvcc`` per kernel source, all started together;
    returns each build's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.deliver.fused import _kernel_lib as fused_lib
    from repro_torch.kernels.flash.flash import _bwd_lib as flash_bwd_lib
    from repro_torch.kernels.flash.flash import _kernel_lib as flash_lib
    from repro_torch.kernels.isect.isect import _kernel_lib as isect_lib
    from repro_torch.kernels.segsum.segsum import _kernel_lib as segsum_lib

    sources = {"deliver_fused": ("deliver_fused.cu",),
               "isect": ("isect.cu",), "segsum": ("segsum.cu",),
               "flash": ("flash.cu",), "flash_bwd": ("flash_bwd.cu",)}

    def one(item):
        t0 = time.perf_counter()
        _nvcc.build(*item)
        return item[0], time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        seconds = dict(pool.map(one, sources.items()))
    for load in (fused_lib, isect_lib, segsum_lib, flash_lib, flash_bwd_lib):
        load()
    return seconds


def ptxas_summary(text):
    """(kernel, registers, spill store bytes, spill load bytes, smem
    bytes) per entry function in ``nvcc -Xptxas -v`` output; the flash
    templates named by their parameters."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          name)
            f = re.search(r"flash_kernelI(\w)Li(\d+)E", name)
            k = re.search(r"(k2a_[a-z]+)(I.*?Li(\d+)E)?", name)
            b = re.search(r"k2b_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                          name)
            w = re.search(r"(flash_bwd_[a-z]+)I(f|13__nv_bfloat16)"
                          r"(?:Li(\d+)ELi(\d+)E)?", name)
            bw = re.search(r"(flash_bwd_[a-z]+)_wgmmaILi(\d+)E", name)
            tb = re.search(r"(flash_bwd_[a-z]+)_tf32ILi(\d+)ELi(\d+)E", name)
            tf = re.search(r"flash_tf32_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                           name)
            if tb:
                name = (f"{tb.group(1)} float32 tf32 DP={tb.group(2)}, "
                        f"{tb.group(3)} block(s) per SM")
            elif tf:
                name = (f"float32 tf32 DP={tf.group(1)} BK={tf.group(2)}, "
                        f"{tf.group(3)} block(s) per SM")
            elif bw:
                name = f"{bw.group(1)} bf16 wgmma DP={bw.group(2)}"
            elif t:
                name = (f"bf16 wgmma DP={t.group(1)} BK={t.group(2)}, "
                        f"{t.group(3)} block(s) per SM")
            elif f:
                name = f"float32 fma NJ={f.group(2)}"
            elif k:
                dtype = "bf16" if "bfloat16" in name else "float32"
                name = k.group(1) + (f" {dtype} VEC={k.group(3)}"
                                     if k.group(3) else "")
            elif w:
                dtype = "float32" if w.group(2) == "f" else "bf16"
                name = f"{w.group(1)} {dtype}" + (
                    f" R={w.group(3)} NJ={w.group(4)}" if w.group(3) else "")
            elif b:
                dtype = "float32" if b.group(1) == "f" else "bf16"
                name = (f"k2b {dtype} "
                        f"{'narrow D' if b.group(3) == '1' else 'wide VEC'}"
                        f"={b.group(2)}")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spill,
                         int(m.group(2) or 0)))
            name, spill = None, (0, 0)
    return rows


def time_delivery(hg, fwd, bwd, flush):
    """Phase 4's kernel timings: per class the one-class launch, per leaf
    the one launch against the sum of its class bounds, its plain
    version and the ``xla`` lowering.  Returns the K1 entry's numbers,
    summed over the two leaves."""
    import torch

    from repro_torch.core import Program, deliver
    from repro_torch.kernels.deliver import fused

    dev = hg.dst.device
    sum_prog = Program(procedure=None, combiner="sum")
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0}
    log("phase 4: float32 sum, D=1, no activity (PageRank's v->he leaf); "
        "L2 flushed before each run; median of 20")
    for name, lay, src, dst, n_dst in (
            ("fwd", fwd, hg.src, hg.dst, hg.n_hyperedges),
            ("bwd", bwd, hg.dst, hg.src, hg.n_vertices)):
        msgs = torch.rand(lay.n_src, 1, device=dev)
        msgs_aug = torch.cat([msgs, torch.zeros(1, 1, device=dev)])
        leaf_bound = 0.0
        for c in range(lay.n_classes):
            args = (msgs_aug, None, lay.class_src[c], lay.class_dst[c],
                    lay.class_bounds[c], lay.class_rows[c], "sum")
            kw = dict(block_n=lay.block_n, block_e=lay.class_block_e[c])
            k_ms = time_cuda(lambda: fused.deliver_fused_cuda(*args, **kw),
                             flush)
            k_dev = time_device(
                lambda: fused.deliver_fused_cuda(*args, **kw), flush)
            p_ms = time_cuda(lambda: fused.deliver_fused_plain(*args, **kw),
                             flush)
            lanes = int(lay.class_src[c].shape[0])
            rows = lay.class_rows[c]
            real = lay.class_dst[c] < rows
            nnz_c = int(real.sum())
            msg_rows = int(torch.unique(lay.class_src[c][real]).numel())
            # Each input read once, each output written once: the src and
            # dst index streams, the tile table, the message rows the
            # class references, the output rows (all 4-byte words).  The
            # same count whatever runs it: one class or a whole leaf.
            n_bytes = 4 * (2 * lanes + lay.class_bounds[c].numel()
                           + msg_rows + rows)
            bound = max(n_bytes / HBM_BYTES_PER_S, nnz_c / FP32_OPS_PER_S)
            leaf_bound += bound * 1e3
            span = fused.class_span(lanes, rows, lay.block_n)
            log(f"  {name} class {c} (width {lay.class_widths[c]}, rows "
                f"{rows}, lanes {lanes}, blocks {-(-rows // span)} of "
                f"{span} rows): one-class launch {k_ms * 1e3:.1f} us "
                f"(device {k_dev * 1e3:.1f} us), "
                f"plain {p_ms * 1e3:.1f} us, bound {bound * 1e6:.1f} us "
                f"({n_bytes / 1e6:.2f} MB, {nnz_c} real lanes, {msg_rows} "
                f"message rows)")
        msgs_1d = msgs[:, 0].contiguous()
        f_ms = time_cuda(
            lambda: fused.deliver_leaf_cuda(msgs, None, lay, "sum"), flush)
        f_dev = time_device(
            lambda: fused.deliver_leaf_cuda(msgs, None, lay, "sum"), flush)
        p_ms = time_cuda(
            lambda: fused.deliver_fused_classes(msgs_aug, None, lay, "sum",
                                                lowering="plain"), flush)
        x_ms = time_cuda(
            lambda: deliver(msgs_1d, None, src, dst, n_dst, sum_prog), flush)
        totals["ms"] += f_ms
        totals["plain_ms"] += p_ms
        totals["bound_ms"] += leaf_bound
        totals["library_ms"] += x_ms
        log(f"  {name} leaf: fused delivery, one launch (all classes, rows "
            f"written to their destinations) {f_ms * 1e3:.1f} us (device "
            f"{f_dev * 1e3:.1f} us) against the sum of its class bounds "
            f"{leaf_bound * 1e3:.1f} us ({leaf_bound / f_ms:.1%}; of the "
            f"device time {leaf_bound / f_dev:.1%}); plain (per class + "
            f"inv_perm "
            f"gather) {p_ms * 1e3:.1f} us; xla lowering (index_select "
            f"gather + where + scatter_reduce: stock calls, not one) "
            f"{x_ms * 1e3:.1f} us")

    return totals


def card_ids(x, dev):
    import numpy as np
    import torch

    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32),
                           device=dev)


def census_batches(triples, dev):
    """The four intersection batches of one census over ``[T, 3]``
    triples (as ``triple_profiles`` sends them)."""
    a, b, c = (card_ids(triples[:, i], dev) for i in range(3))
    return {"census a&b": (a, b), "census b&c": (b, c),
            "census c&a": (c, a), "census a&b&c": (a, b, c)}


def check_isect(bits, rng, dev, batches):
    """Phase 5: every batch through K3b and the pre-gathered pairs
    through K3a, against the plain versions, bitwise.  Returns (checks,
    max abs err, the uniform pairs as host arrays)."""
    import numpy as np
    import torch

    from repro_torch.kernels.isect import (
        isect_cuda,
        isect_fused_cuda,
        isect_fused_plain,
        isect_plain,
    )

    n_checks, max_err = 0, 0

    def same(tag, got, want):
        nonlocal n_checks, max_err
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != torch.int32:
            fail(f"isect {tag}: shape/dtype {tuple(got.shape)} {got.dtype}")
        err = int((got.to(torch.int64) - want).abs().max()) if len(got) else 0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"isect kernel != plain (bitwise) on {tag}: max abs err "
                 f"{err}")
        n_checks += 1

    e, w = bits.shape
    host_uni = [rng.integers(0, e, N_PAIRS) for _ in range(2)]
    perm = rng.permutation(e)
    cases = dict(batches)
    cases["uniform"] = tuple(card_ids(x, dev) for x in host_uni)
    cases["zipf"] = tuple(
        card_ids(perm[(rng.zipf(1.2, N_PAIRS) - 1) % e], dev)
        for _ in range(2))
    ids = card_ids(np.arange(e), dev)
    cases["self"] = (ids, ids)
    wide = rng.integers(-2**31, 2**31, (e, 101), dtype=np.int64)
    wide[rng.random(wide.shape) < 0.05] = -1
    wide = card_ids(wide, dev)
    for name, table in ((f"W={w}", bits), ("random W=101", wide)):
        for case, abc in cases.items():
            if table is wide and case not in ("uniform", "self"):
                continue
            got = isect_fused_cuda(table, *abc)
            want = isect_fused_plain(table, *abc, tile=PLAIN_TILE)
            same(f"K3b {name} {case} ({len(abc[0])})", got, want)
        ua, ub = (table.index_select(0, x) for x in cases["uniform"])
        same(f"K3a {name} uniform", isect_cuda(ua, ub),
             isect_plain(ua, ub, tile=PLAIN_TILE))
        same(f"K3a {name} whole table", isect_cuda(table, table),
             isect_plain(table, table, tile=PLAIN_TILE))
        del ua, ub
    card = isect_cuda(bits, bits)
    if not torch.equal(isect_fused_cuda(bits, ids, ids), card):
        fail("self pairs do not give |e|")

    # The run cache: id shapes that stress it, at every width class of
    # the kernel (one word, words, the census's int4 row, the loop past
    # 128 words) and on an unaligned base (the word path at W = 104).
    for w_case in (1, 3, 101, 104, 200, "104 unaligned"):
        w_r = 104 if w_case == "104 unaligned" else w_case
        words = rng.integers(-2**31, 2**31, (5000 * w_r + 1,),
                             dtype=np.int64)
        words[rng.random(words.shape) < 0.05] = -1
        flat = card_ids(words, dev)
        table = (flat[1:] if w_case == "104 unaligned"
                 else flat[:-1]).view(5000, w_r)
        if (w_case == "104 unaligned") != (table.data_ptr() % 16 != 0):
            fail("the unaligned case is not unaligned")
        for case, abc in run_cases(rng, 5000).items():
            abc = tuple(card_ids(x, dev) for x in abc)
            same(f"K3b W={w_case} {case} ({len(abc[0])})",
                 isect_fused_cuda(table, *abc),
                 isect_fused_plain(table, *abc, tile=PLAIN_TILE))
            if len(abc) == 2:
                ua, ub = (table.index_select(0, x) for x in abc)
                same(f"K3a W={w_case} {case}", isect_cuda(ua, ub),
                     isect_plain(ua, ub, tile=PLAIN_TILE))
    return n_checks, max_err, host_uni


def run_cases(rng, e):
    """Id streams (host arrays) that stress the kernel's run cache:
    alternating ids, runs that cross the 32-pair chunks and the blocks'
    turns (lengths around 32 and 256, and long ones), P no multiple of
    32, runs of one, and triples mixing a long run with changing ids."""
    import numpy as np

    def runs(lengths, p):
        return np.repeat(rng.integers(0, e, len(lengths)), lengths)[:p]

    p = 300_007
    long_runs = rng.choice([1, 31, 32, 33, 255, 256, 257, 5000], 4 * p // 32)
    alt = np.tile(rng.integers(0, e, 2), p // 2 + 1)[:p]
    ones = rng.integers(0, e, p)
    a = runs(long_runs, p)
    return {
        "alternating": (alt, np.roll(alt, 1)),
        "runs across chunks": (a, runs(long_runs[::-1], p)),
        "run of one vs runs": (ones, a),
        "P=33": (a[:33], ones[:33]),
        "P=1": (a[:1], ones[:1]),
        "triples: runs, alternating, ones": (a, alt, ones),
        "triples: same run": (a, a, a),
    }


def l2_read_rate(bits):
    """Bytes/s of a repeated streaming read of ``bits`` from L2: one
    ``torch.sum`` over the table read 16 times (a stride-0 view), warm,
    median of 20.  A torch reduction's rate: a floor on the card's L2
    read rate, not its peak."""
    import torch

    flat = bits.view(torch.float32).reshape(1, -1)
    reads = flat.expand(16, -1)
    for _ in range(3):
        reads.sum(dim=1)
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        reads.sum(dim=1)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    rate = 16 * bits.numel() * 4 / (statistics.median(times) * 1e-3)
    log(f"  L2 read rate: torch.sum over the {bits.numel() * 4 / 1e6:.1f} "
        f"MB table read 16 times, warm: {rate / 1e12:.3f} TB/s")
    return rate


def isect_bound(p, n_ids, w, unique_rows, popc_rate):
    """(bytes s, popcount s): the id streams, the output and the
    distinct rows read once, over the memory rate; P x W popcounts over
    the card's popcount rate."""
    n_bytes = 4 * p * n_ids + 4 * p + 4 * w * unique_rows
    return n_bytes / HBM_BYTES_PER_S, p * w / popc_rate


def time_isect(bits, batches, flush, popc_rate):
    """Per census batch: K3b, its plain version and the bound; then K3a
    on the whole index (the cardinalities the census reads).  Returns
    the two kernels' entries of the kernel line (launches filled in by
    the caller)."""
    import torch

    from repro_torch.kernels.isect import (
        isect_cuda,
        isect_fused_cuda,
        isect_fused_plain,
        isect_plain,
    )

    e, w = bits.shape
    fused = {"ms": 0.0, "plain_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0}
    l2_rate = l2_read_rate(bits)
    for name, abc in batches.items():
        k_ms = time_cuda(lambda: isect_fused_cuda(bits, *abc), flush)
        p_ms = time_cuda(
            lambda: isect_fused_plain(bits, *abc, tile=PLAIN_TILE), flush)
        p = len(abc[0])
        rows = int(torch.unique(torch.cat(abc)).numel())
        b_s, o_s = isect_bound(p, len(abc), w, rows, popc_rate)
        fused["ms"] += k_ms
        fused["plain_ms"] += p_ms
        fused["bytes_s"] += b_s
        fused["ops_s"] += o_s
        # What a kernel without the run cache reads from L2: every id's
        # row, every pair (not the bound: the rows come from L2).
        l2_bytes = p * len(abc) * w * 4
        log(f"  K3b {name}: P={p} W={w} rows={rows}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{max(b_s, o_s) * 1e3:.4f} ms (bytes {b_s * 1e3:.4f} ms, "
            f"popcounts {o_s * 1e3:.4f} ms); {p * w / (k_ms * 1e-3):.4g} "
            f"popcounts/s; L2 row traffic uncached {l2_bytes / 1e9:.2f} GB "
            f"= {l2_bytes / l2_rate * 1e3:.4f} ms at the measured L2 rate")
    k_ms = time_cuda(lambda: isect_cuda(bits, bits), flush)
    k_dev = time_device(lambda: isect_cuda(bits, bits), flush)
    p_ms = time_cuda(lambda: isect_plain(bits, bits, tile=PLAIN_TILE),
                     flush)
    # a and b are the same [E, W] table: one input, read once.
    b_s = (4 * e * w + 4 * e) / HBM_BYTES_PER_S
    o_s = e * w / popc_rate
    log(f"  K3a whole index (cardinalities): E={e} W={w}: kernel "
        f"{k_ms:.4f} ms (device {k_dev:.4f} ms), plain {p_ms:.4f} ms, bound "
        f"{max(b_s, o_s) * 1e3:.4f} ms (bytes {b_s * 1e3:.4f} ms, "
        f"popcounts {o_s * 1e3:.4f} ms)")
    entries = {
        "isect": {"ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": max(b_s, o_s) * 1e3,
                  "bound_by": "bytes" if b_s >= o_s else "operations"},
        "isect_fused": {
            "ms": fused["ms"], "plain_ms": fused["plain_ms"],
            "bound_ms": max(fused["bytes_s"], fused["ops_s"]) * 1e3,
            "bound_by": ("bytes" if fused["bytes_s"] >= fused["ops_s"]
                         else "operations"),
        },
    }
    return entries


def log_measured(label, res):
    m = res.decision["measured"]
    other = (m["wall_s"] - m["preprocess_s"] - m["intersect_s"]
             - m["classify_s"])
    log(f"  {label}: wall {m['wall_s']:.3f} s = preprocess "
        f"{m['preprocess_s']:.3f} s + intersect {m['intersect_s']:.3f} s "
        f"({m['intersect_calls']} calls) + classify {m['classify_s']:.3f} "
        f"s + other {other:.3f} s")


def same_census(a, b, fields):
    import numpy as np

    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))) for f in fields)


def brute_force_census(hg):
    """The O(E^3) python-set oracle of ``tests/test_motifs.py``."""
    import itertools

    import numpy as np

    from repro_torch.motifs import CLASS_OF_PATTERN, N_HMOTIF_CLASSES

    src, dst = hg.src.cpu().numpy(), hg.dst.cpu().numpy()
    sets = [set(src[dst == e].tolist()) for e in range(hg.n_hyperedges)]
    counts = np.zeros(N_HMOTIF_CLASSES, np.int64)
    for a, b, c in itertools.combinations(range(hg.n_hyperedges), 3):
        sa, sb, sc = sets[a], sets[b], sets[c]
        if bool(sa & sb) + bool(sb & sc) + bool(sc & sa) < 2:
            continue
        regions = [sa - sb - sc, sb - sa - sc, (sa & sb) - sc,
                   sc - sa - sb, (sa & sc) - sb, (sb & sc) - sa,
                   sa & sb & sc]
        cls = CLASS_OF_PATTERN[sum((len(r) > 0) << i
                                   for i, r in enumerate(regions))]
        if cls >= 0:
            counts[cls] += 1
    return counts


def intersections_vs_plain(dev, rng, scale=1.0):
    """Phase 5 on the Apache regime at ``scale``: the bitset index, the
    census's own sampled triples, and every kernel-vs-plain check."""
    from repro_torch.core import AnalyticsSpec
    from repro_torch.data import make_dataset
    from repro_torch.motifs import (
        build_index,
        build_overlap_graph,
        overlap_pairs_with_counts,
        sample_triples,
    )

    t0 = time.perf_counter()
    hg_a = make_dataset("apache", scale, seed=0, device=dev)
    index = build_index(hg_a, "bitset")
    bits = index.data
    t_idx = time.perf_counter() - t0
    pairs, n_shared = overlap_pairs_with_counts(hg_a)
    og = build_overlap_graph(hg_a, pairs)
    t_og = time.perf_counter() - t0 - t_idx
    _, triples = sample_triples(og, AnalyticsSpec(hg_a).n_samples,
                                hg_a.n_hyperedges, seed=0)
    t_tri = time.perf_counter() - t0 - t_idx - t_og
    log(f"apache: |V|={hg_a.n_vertices} |E|={hg_a.n_hyperedges} "
        f"nnz={hg_a.nnz}; bitset index {tuple(bits.shape)} "
        f"({index.nbytes} bytes, {t_idx:.1f} s); {len(pairs)} overlap "
        f"pairs, overlap graph in {t_og:.1f} s; {len(triples)} sampled "
        f"triples in {t_tri:.1f} s")
    del pairs, n_shared, og
    batches = census_batches(triples, dev)
    n_isect, isect_err, host_uni = check_isect(bits, rng, dev, batches)
    log(f"phase 5: {n_isect} intersection kernel-vs-plain checks bitwise "
        f"equal in {time.perf_counter() - t0:.1f} s")

    return hg_a, bits, triples, batches, isect_err, host_uni


def analytics_path(dev, hg_a, triples, batches, host_uni):
    """Phase 6: ``Engine.analyze`` on the Apache hypergraph (the main
    path, launches counted), against the merge path, plus the exact
    census checks.  Returns the K3a and K3b launches of the main run."""
    import numpy as np

    from repro_torch.core import AnalyticsSpec, Engine
    from repro_torch.data import make_dataset, powerlaw_hypergraph
    from repro_torch.kernels.isect import isect_cuda, isect_fused_cuda
    from repro_torch.motifs import N_HMOTIF_CLASSES

    t0 = time.perf_counter()
    aeng = Engine(device=dev)
    spec = AnalyticsSpec(hg_a)
    isect_cuda.launches = 0
    isect_fused_cuda.launches = 0
    res = aeng.analyze(spec)
    k3a_launches = isect_cuda.launches
    k3b_launches = isect_fused_cuda.launches
    got = {"kernel": res.kernel, "representation": res.representation,
           "backend": res.backend, "mode": res.mode}
    for axis, (value, reason) in APACHE_DESIGN.items():
        if got[axis] != value or res.decision[axis]["reason"] != reason:
            fail(f"apache analyze {axis}: {got[axis]} "
                 f"({res.decision[axis]['reason']!r}), expected {value}")
    log(f"  design point {got}")
    for axis in APACHE_DESIGN:
        log(f"    {axis}: " + ", ".join(
            f"{k}={v}" for k, v in res.decision[axis].items()))
    log(f"  launches in analyze: K3a {k3a_launches} (cardinalities), K3b "
        f"{k3b_launches} (3 pair batches + 1 triple batch)")
    if (k3a_launches, k3b_launches) != (1, 4):
        fail(f"analyze launched K3a {k3a_launches} and K3b {k3b_launches} "
             "times, expected 1 and 4")
    est = res.value
    if len(triples) != len(batches["census a&b"][0]) or (
            est.n_triples_seen > len(triples)):
        fail("the census's triples are not the ones phase 5 checked")
    if est.counts.shape != (N_HMOTIF_CLASSES,) or not (
            np.isfinite(est.counts).all() and (est.ci_low <= est.counts).all()
            and (est.counts <= est.ci_high).all() and est.total > 0):
        fail("census estimate is not finite, positive and inside its CI")
    log_measured("analyze (bitset)", res)
    res_m = aeng.analyze(spec, intersect_kernel="merge")
    log_measured("analyze (merge)", res_m)
    fields = ("counts", "ci_low", "ci_high", "n_triples_seen", "n_pairs")
    if res_m.kernel != "merge" or not same_census(est, res_m.value, fields):
        fail("apache census: bitset != merge")
    log(f"  census bitset == merge, bitwise: {est.n_triples_seen} triples "
        f"of {est.n_samples} samples over {est.n_pairs} linked pairs, "
        f"total ~{est.total:.6g}")

    ptask = AnalyticsSpec(hg_a, task="pair_intersections",
                          pairs=tuple(host_uni))
    pk = aeng.analyze(ptask, representation="bipartite")
    pm = aeng.analyze(ptask, representation="bipartite",
                      intersect_kernel="merge")
    if pk.kernel != "bitset" or not np.array_equal(pk.value[1],
                                                   pm.value[1]):
        fail("pair_intersections: bitset != merge")
    log(f"  pair_intersections on {N_PAIRS} uniform pairs: bitset == "
        f"merge (intersect {pk.decision['measured']['intersect_s']:.3f} s "
        f"vs {pm.decision['measured']['intersect_s']:.3f} s)")

    hg_x = make_dataset("dblp", 0.003, seed=0, device=dev)
    ex = aeng.analyze(AnalyticsSpec(hg_x))
    if (ex.mode, ex.kernel) != ("exact", "bitset"):
        fail(f"dblp 0.003 resolved to {ex.mode}/{ex.kernel}")
    ex_c = aeng.analyze(AnalyticsSpec(hg_x), representation="clique")
    ex_m = aeng.analyze(AnalyticsSpec(hg_x), intersect_kernel="merge")
    cf = ("counts", "n_triples", "n_duplicate_triples", "n_pairs")
    if not (same_census(ex.value, ex_c.value, cf)
            and same_census(ex.value, ex_m.value, cf)):
        fail("exact census: bipartite/clique/merge disagree")
    log(f"  exact census, dblp 0.003 (|V|={hg_x.n_vertices} "
        f"|E|={hg_x.n_hyperedges}, W={(hg_x.n_vertices + 31) // 32}): "
        f"{ex.mode}/{ex.kernel}/{ex.representation}; "
        f"{ex.value.n_triples} triples over {ex.value.n_pairs} pairs, "
        f"equal under clique and merge")
    tiny = powerlaw_hypergraph(40, 36, mean_cardinality=4, seed=7,
                               device=dev)
    tc = aeng.analyze(AnalyticsSpec(tiny, mode="exact"),
                      intersect_kernel="bitset", representation="bipartite")
    if not np.array_equal(tc.value.counts, brute_force_census(tiny)):
        fail("tiny exact census != python-set oracle")
    log(f"  tiny exact census == python-set oracle ({tc.value.n_triples} "
        f"triples)")
    log(f"phase 6: analytics path agrees in {time.perf_counter() - t0:.1f} "
        "s")

    return k3a_launches, k3b_launches, est


def card_rates():
    """(SMs, max SM clock in Hz) of card 0, from torch and nvidia-smi."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]) * 1e6
    return sms, clock


def segsum_tol(e, n, dtype):
    """(rtol, atol) of a segment sum against its plain version.  float32:
    ``tests/test_kernels.py``'s (rtol 1e-5, an atol that grows with the
    square root of a segment's depth, ~e/n addends).  bfloat16: both sum
    in float32 and round once, so they differ by at most one bf16 step
    of the value (2**-7 of it): rtol is two steps, atol a floor for the
    values near 0."""
    import torch

    if dtype == torch.bfloat16:
        return 2.0 ** -6, 2.0 ** -10
    return 1e-5, 1e-4 * max(1.0, (e / n) ** 0.5 / 3.0)


def check_close(tag, got, want, rtol, atol):
    """Fails unless ``got`` is within tolerance of ``want`` (float32
    compare); returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{tag}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
             f"{want.dtype}")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        fail(f"{tag}: max abs err {err} over rtol {rtol} atol {atol}")
    return err


def segsum_phase(hg, flush):
    """Phase 7: K2a and K2b through ``segment_sum_mxu`` on the DBLP
    incidences at full scale (the main path, launches counted), each
    against its plain version, the edge cases, and the timings.  Returns
    the two kernels' entries of the kernel line."""
    import torch

    from repro_torch.kernels.segsum import (
        csr_row_offsets,
        segment_sum_mxu,
        segsum_cuda,
        segsum_plain,
        segsum_sorted_cuda,
        segsum_sorted_plain,
    )
    from repro_torch.roofline.analysis import segsum_work

    t0 = time.perf_counter()
    dev = hg.dst.device
    n, e = hg.n_hyperedges, hg.nnz
    gen = torch.Generator(device=dev).manual_seed(7)
    dst = hg.dst.contiguous()                       # the generator's order
    order = torch.sort(dst, stable=True).indices    # as sorted_by_dst()
    dst_s = hg.sorted_by_dst().dst.contiguous()
    if not torch.equal(dst_s, dst[order]):
        fail("sorted_by_dst() is not the stable sort of dst")
    off = csr_row_offsets(dst_s, n)
    configs = []
    for dtype, d in ((torch.float32, 1), (torch.float32, 64),
                     (torch.bfloat16, 64)):
        msgs = torch.randn(e, d, generator=gen, device=dev).to(dtype)
        configs.append((dtype, d, msgs, msgs[order].contiguous()))

    # -- the main path: the entry point, unsorted and sorted ------------------
    segsum_cuda.launches = 0
    segsum_sorted_cuda.launches = 0
    outs = [(segment_sum_mxu(m, dst, n),
             segment_sum_mxu(m_s, dst_s, n, sorted_dst=True))
            for _, _, m, m_s in configs]
    launches = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    if launches != (len(configs), len(configs)):
        fail(f"segment_sum_mxu launched K2a/K2b {launches} times, expected "
             f"{len(configs)} each")
    log(f"  main path: {len(configs)} configs x (unsorted, sorted) through "
        f"segment_sum_mxu: K2a {launches[0]} launches, K2b {launches[1]}")

    err = {"segsum": 0.0, "segsum_sorted": 0.0}
    perm = torch.randperm(e, generator=gen, device=dev)
    dst_p = dst[perm].contiguous()
    for (dtype, d, m, m_s), (got, got_s) in zip(configs, outs):
        rtol, atol = segsum_tol(e, n, dtype)
        tag = f"{str(dtype)[6:]} D={d}"
        err["segsum"] = max(err["segsum"], check_close(
            f"K2a {tag}", got, segsum_plain(m, dst, n), rtol, atol))
        err["segsum_sorted"] = max(err["segsum_sorted"], check_close(
            f"K2b {tag}", got_s, segsum_sorted_plain(m_s, off, n), rtol,
            atol))
        if not same_bits(got_s, segsum_sorted_cuda(m_s, off, n)):
            fail(f"K2b {tag}: two runs differ")
        m_p = m[perm].contiguous()
        err["segsum"] = max(err["segsum"], check_close(
            f"K2a {tag} shuffled", segsum_cuda(m_p, dst_p, n),
            segsum_plain(m_p, dst_p, n), rtol, atol))
        check_close(f"K2a vs K2b {tag}", got, got_s, rtol, atol)

    # -- edge cases ----------------------------------------------------------
    # One segment takes every edge: integer-valued messages, so that
    # every order of the 2.8 M additions gives the same float32 bits.
    m_int = torch.randint(-8, 9, (e, 64), generator=gen, device=dev).float()
    zeros = torch.zeros_like(dst)
    want = segsum_plain(m_int, zeros, 3)
    for sorted_dst in (False, True):
        if not same_bits(segment_sum_mxu(m_int, zeros, 3,
                                         sorted_dst=sorted_dst), want):
            fail(f"one segment (sorted={sorted_dst}) != plain, bitwise")
    m1 = configs[1][2]                              # float32, D = 64
    cut = 512 * 1000 + 77                           # not a block_e multiple
    rtol, atol = segsum_tol(cut, n, torch.float32)
    check_close("E not a block_e multiple (K2a)",
                segment_sum_mxu(m1[:cut], dst[:cut], n),
                segsum_plain(m1[:cut], dst[:cut], n), rtol, atol)
    check_close("E not a block_e multiple (K2b)",
                segment_sum_mxu(configs[1][3][:cut], dst_s[:cut], n,
                                sorted_dst=True),
                segsum_plain(configs[1][3][:cut], dst_s[:cut], n), rtol,
                atol)
    rtol, atol = segsum_tol(e, n, torch.float32)
    bad = dst.clone()
    hit = torch.rand(e, generator=gen, device=dev) < 0.01
    bad[hit] = torch.tensor([-1, n, n + 5, 2**31 - 1], dtype=torch.int32,
                            device=dev)[torch.randint(
                                4, (int(hit.sum()),), generator=gen,
                                device=dev)]
    keep = ~hit
    check_close("ids outside [0, N) dropped (K2a)",
                segment_sum_mxu(m1, bad, n),
                segsum_plain(m1[keep], dst[keep], n), rtol, atol)
    pad = lambda x, lo, hi: torch.cat([lo, x, hi])
    bad_s = pad(dst_s, torch.full((100,), -3, dtype=torch.int32, device=dev),
                torch.tensor([n] * 100 + [2**31 - 1] * 5, dtype=torch.int32,
                             device=dev))
    m_pad = pad(configs[1][3], torch.ones(100, 64, device=dev),
                torch.ones(105, 64, device=dev))
    check_close("ids outside [0, N) dropped (K2b)",
                segment_sum_mxu(m_pad, bad_s, n, sorted_dst=True),
                segsum_plain(configs[1][3], dst_s, n), rtol, atol)
    before = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    for sorted_dst in (False, True):
        z = segment_sum_mxu(m1[:0], dst[:0], n, sorted_dst=sorted_dst)
        if z.shape != (n, 64) or z.any():
            fail("E = 0 does not give zeros")
    if (segsum_cuda.launches, segsum_sorted_cuda.launches) != before:
        fail("E = 0 launched a kernel")
    # Apache's vertex side: rows of every length up to 6,465 edges.
    from repro_torch.data import make_dataset

    hg_a = make_dataset("apache", 1.0, seed=0, device=dev)
    v_s = torch.sort(hg_a.src, stable=True).values.contiguous()
    n_v = hg_a.n_vertices
    m_v = torch.randn(v_s.numel(), 64, generator=gen, device=dev)
    off_v = csr_row_offsets(v_s, n_v)
    longest = int(off_v.diff().max())
    got_v = segment_sum_mxu(m_v, v_s, n_v, sorted_dst=True)
    rtol, atol = segsum_tol(v_s.numel(), n_v, torch.float32)
    err["segsum_sorted"] = max(err["segsum_sorted"], check_close(
        "K2b Apache vertex side", got_v, segsum_plain(m_v, v_s, n_v), rtol,
        atol))
    if not same_bits(got_v, segsum_sorted_cuda(m_v, off_v, n_v)):
        fail("K2b Apache vertex side: two runs differ")
    del hg_a
    log(f"phase 7: K2a/K2b checks passed (max abs err K2a "
        f"{err['segsum']:.3g}, K2b {err['segsum_sorted']:.3g}; K2b bitwise "
        f"repeatable; one segment, E = {cut}, dropped ids, E = 0, Apache "
        f"vertex side: {v_s.numel()} edges into {n_v} rows, the longest "
        f"{longest}) in {time.perf_counter() - t0:.1f} s")

    # -- timings -------------------------------------------------------------
    t0 = time.perf_counter()
    entries = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0}
               for name in ("segsum", "segsum_sorted")}
    entries["segsum"]["shuffled_ms"] = 0.0
    # The library call computes K2's function: float32 sums (bf16
    # messages cast by ``.float()``), rounded to the type of msgs; for
    # float32 both casts are no-ops.
    index_add_f32 = lambda m, ids, d, dtype: torch.zeros(
        n, d, dtype=torch.float32, device=dev).index_add_(
            0, ids, m.float()).to(dtype)
    for dtype, d, m, m_s in configs:
        size = m.element_size()
        # Bytes each form must move: the messages read, the rows written,
        # and K2a's ids or K2b's offsets read (K2b never reads the ids).
        rows_bytes = e * d * size + n * d * size
        runs = {
            "segsum": (lambda: segsum_cuda(m, dst, n),
                       lambda: segsum_plain(m, dst, n),
                       lambda: index_add_f32(m, dst, d, dtype),
                       segsum_work(e, n, d, size)[1]),
            "segsum_sorted": (lambda: segsum_sorted_cuda(m_s, off, n),
                              lambda: segsum_sorted_plain(m_s, off, n),
                              lambda: index_add_f32(m_s, dst_s, d, dtype),
                              rows_bytes + 4 * (n + 1)),
        }
        for name, (kernel, plain, library, n_bytes) in runs.items():
            k_ms = time_cuda(kernel, flush)
            p_ms = time_cuda(plain, flush)
            l_ms = time_cuda(library, flush)
            b_s, o_s = n_bytes / HBM_BYTES_PER_S, e * d / FP32_OPS_PER_S
            ent = entries[name]
            for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                             ("library_ms", l_ms), ("bytes_s", b_s),
                             ("ops_s", o_s)):
                ent[key] += val
            log(f"  {'K2a' if name == 'segsum' else 'K2b'} "
                f"{str(dtype)[6:]} D={d}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
                f"{max(b_s, o_s) * 1e3:.4f} ms ({n_bytes / 1e6:.1f} MB)")
        m_p = m[perm].contiguous()
        p_ms = time_cuda(lambda: segsum_cuda(m_p, dst_p, n), flush)
        e_ms = time_cuda(lambda: segment_sum_mxu(m_s, dst_s, n,
                                                 sorted_dst=True), flush)
        del m_p
        entries["segsum"]["shuffled_ms"] += p_ms
        log(f"    K2a on shuffled ids {p_ms:.4f} ms; "
            f"segment_sum_mxu(sorted_dst=True) with its check and offsets "
            f"{e_ms:.4f} ms")
    # One tile (K2a) or one row (K2b) takes every edge: K2a's work items
    # and K2b's blocks meet in their combine trees, which must not
    # serialise on one block.  Apache's vertex side: a row of 6,465
    # edges beside rows of about 130.
    off_1 = csr_row_offsets(zeros, 3)
    l_ms = time_cuda(lambda: torch.zeros(3, 64, device=dev).index_add_(
        0, zeros, m_int), flush)
    rows_1 = e * 64 * 4 + 3 * 64 * 4
    for name, kernel, n_bytes in (
            ("K2a", lambda: segsum_cuda(m_int, zeros, 3), rows_1 + 4 * e),
            ("K2b", lambda: segsum_sorted_cuda(m_int, off_1, 3),
             rows_1 + 4 * 4)):
        k_ms = time_cuda(kernel, flush)
        bound_1 = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"  {name} one segment (E = {e} into row 0 of 3, float32 D=64): "
            f"kernel {k_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
            f"{bound_1:.4f} ms")
    entries["segsum_sorted"].update(one_segment_ms=k_ms,
                                    one_segment_library_ms=l_ms,
                                    one_segment_bound_ms=bound_1)
    del m_int
    e_v = v_s.numel()
    k_ms = time_cuda(lambda: segsum_sorted_cuda(m_v, off_v, n_v), flush)
    l_ms = time_cuda(lambda: torch.zeros(n_v, 64, device=dev).index_add_(
        0, v_s, m_v), flush)
    bound_v = ((e_v * 64 * 4 + n_v * 64 * 4 + 4 * (n_v + 1))
               / HBM_BYTES_PER_S * 1e3)
    log(f"  K2b Apache vertex side (E = {e_v} into {n_v} rows, float32 "
        f"D=64): kernel {k_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
        f"{bound_v:.4f} ms")
    entries["segsum_sorted"].update(skew_ms=k_ms, skew_library_ms=l_ms,
                                    skew_bound_ms=bound_v)
    for ent in entries.values():
        b_s, o_s = ent.pop("bytes_s"), ent.pop("ops_s")
        ent["bound_ms"] = max(b_s, o_s) * 1e3
        ent["bound_by"] = "bytes" if b_s >= o_s else "operations"
    log(f"phase 7: timed in {time.perf_counter() - t0:.1f} s (L2 flushed, "
        f"median of {N_TIMED}; index_add_ into float32 of msgs.float(), "
        f"cast to the type of msgs)")
    for name, launched in zip(entries, launches):
        entries[name]["launches"] = launched
        entries[name]["max_abs_err"] = err[name]
    return entries


# (label, dtype, causal, B, H, S, D): llama3.2-1b's attention width
# (32 heads of 64), gemma3-12b's (16 heads of 256) and
# command-r-plus-104b's (96 heads of 128): one case for each of the
# bfloat16 kernel's head-dim templates.
FLASH_CASES = (
    ("llama3.2-1b prefill_32k, one sequence", "bfloat16", True, 1, 32,
     32768, 64),
    ("llama3.2-1b float32", "float32", True, 1, 32, 4096, 64),
    ("llama3.2-1b bidirectional", "bfloat16", False, 1, 32, 4096, 64),
    ("gemma3-12b", "bfloat16", True, 1, 16, 8192, 256),
    # 32,040 is no multiple of the kernels' 64- or 128-key tiles or the
    # JAX wrapper's 128: the last key and query tiles are partial.
    ("llama3.2-1b S=32040 (partial tiles)", "bfloat16", True, 1, 32, 32040,
     64),
    ("command-r-plus-104b", "bfloat16", True, 1, 96, 8192, 128),
)
FLASH_REPEAT_CASE = 0  # the bfloat16 case checked bitwise over two runs
# Limits of K4 against its plain version.  Elementwise (rtol, atol): f32
# as tests/test_kernels.py; bf16 from the readings (one bf16 step, the
# outputs of late rows about 1/sqrt(row) in size).  Per row, the largest
# error over the row's largest value (ROW_REL): a correct bf16 kernel is
# within about one step of the row's top (2**-7); a dropped key tile or
# a late row's denominator off by a few percent reads above the limit
# (both planted below).
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 5e-3)}
FLASH_ROW_REL = {"float32": 1e-4, "bfloat16": 2e-2}
TENSOR_FLOPS_PER_CLOCK_PER_SM = 4096   # dense bf16: 989.4 TFLOP/s at
                                       # 1830 MHz on 132 SMs
FMA_FLOPS_PER_CLOCK_PER_SM = 256       # float32: 128 FMA lanes
TF32_FLOPS_PER_CLOCK_PER_SM = 2048     # dense TF32: 494.7 TFLOP/s at
                                       # 1830 MHz on 132 SMs
EX2_PER_CLOCK_PER_SM = 16              # MUFU


def route_rate(route):
    """Flops a clock per SM of a K4 route's products: bf16 on the tensor
    cores (``wgmma``), float32 in three TF32 passes on them (``tf32``:
    each float32 flop costs three), float32 on the FMA units (``fma``)."""
    return {"wgmma": TENSOR_FLOPS_PER_CLOCK_PER_SM,
            "tf32": TF32_FLOPS_PER_CLOCK_PER_SM / 3,
            "fma": FMA_FLOPS_PER_CLOCK_PER_SM}[route]


def flash_pairs(causal, b, h, s):
    """(query, key) pairs one attention call keeps: causal keeps
    S (S + 1) / 2 of the S^2 (``roofline.analysis.flash_pairs``)."""
    from repro_torch.roofline.analysis import flash_pairs as pairs

    return pairs(causal, b, h, s, s)


def flash_bound(dtype, causal, b, h, s, d, sms, clock, route=None):
    """(bytes s, operations s) of one attention call: q, k, v, out once
    over the memory rate; the larger of its flops (4 D per pair kept)
    over the rate of ``route`` (``route_rate``; by default the one
    ``flash_plan`` gives the call: bf16 on the tensor cores, float32 in
    three TF32 passes there or on the FMA units) and its exps over the
    MUFU rate.  The work is ``roofline.analysis.flash_work``'s."""
    import torch

    from repro_torch.kernels.flash import flash_plan
    from repro_torch.roofline.analysis import flash_work

    pairs = flash_pairs(causal, b, h, s)
    size = torch.tensor([], dtype=dtype).element_size()
    flops, nbytes = flash_work(b, h, h, s, s, d, size, causal)
    per_clock = route_rate(route or flash_plan(d, dtype).kernel)
    flops_s = flops / (per_clock * sms * clock)
    exps_s = pairs / (EX2_PER_CLOCK_PER_SM * sms * clock)
    return nbytes / HBM_BYTES_PER_S, max(flops_s, exps_s)


def row_rel_err(got, want):
    """Max over rows of max |got - want| / max |want| along the last
    axis: the error in units of each row's own size."""
    g, w = got.float(), want.float()
    top = w.abs().amax(dim=-1).clamp_min(1e-30)
    return ((g - w).abs().amax(dim=-1) / top).max().item()


def drop_key_tile(x, start, width=64):
    """``x [B, H, S, D]`` without keys ``[start, start + width)``."""
    import torch

    return torch.cat([x[:, :, :start], x[:, :, start + width:]], dim=2)


def flash_phase(dev, flush, sms, clock):
    """Phase 8: K4 through ``flash_attention`` at the attention widths of
    llama3.2-1b and gemma3-12b (the main path, launches counted), each
    against its plain version, and the timings.  Returns the kernel's
    entry of the kernel line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import (
        flash_attention,
        flash_cuda,
        flash_plain,
        flash_plan,
    )

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(8)
    inputs = []
    for _, dtype_name, _, b, h, s, d in FLASH_CASES:
        dtype = getattr(torch, dtype_name)
        inputs.append(tuple(torch.randn(b, h, s, d, generator=gen,
                                        device=dev).to(dtype)
                            for _ in range(3)))
    flash_cuda.launches = 0
    outs = [flash_attention(*qkv, causal=case[2])
            for case, qkv in zip(FLASH_CASES, inputs)]
    launches = flash_cuda.launches
    if launches != len(FLASH_CASES):
        fail(f"flash_attention launched K4 {launches} times, expected "
             f"{len(FLASH_CASES)}")
    log(f"  main path: {len(FLASH_CASES)} flash_attention calls, K4 "
        f"{launches} launches")
    case = FLASH_CASES[FLASH_REPEAT_CASE]
    again = flash_cuda(*inputs[FLASH_REPEAT_CASE], causal=case[2])
    torch.cuda.synchronize()
    if not same_bits(again.view(torch.int16), outs[FLASH_REPEAT_CASE].view(
            torch.int16)):
        fail(f"K4 {case[0]}: two runs differ in their bits")
    log(f"  {case[0]}: bitwise equal over two runs")
    del again
    plain = lambda qkv, causal: flash_plain(*qkv, causal=causal,
                                            block_q=4096, block_k=4096)
    max_err = 0.0
    for case, qkv, got in zip(FLASH_CASES, inputs, outs):
        label, dtype_name, causal = case[:3]
        rtol, atol = FLASH_TOL[dtype_name]
        bound = FLASH_ROW_REL[dtype_name]
        want = plain(qkv, causal)
        err = check_close(f"K4 {label}", got, want, rtol, atol)
        rel = row_rel_err(got, want)
        if rel > bound:
            fail(f"K4 {label}: row-relative error {rel:.3g} over {bound}")
        max_err = max(max_err, err)
        if not torch.isfinite(got).all():
            fail(f"K4 {label}: non-finite output")
        # Planted faults, which the row-relative limit must see: a key
        # tile dropped from the middle (for causal, read on the last
        # query, which attends to every key), and the later half of the
        # rows' denominators 5% high.
        q, k, v = qkv
        s = k.shape[2]
        cut = [drop_key_tile(x, s // 2) for x in (k, v)]
        if causal:
            planted = [(want[:, :, -1:], flash_plain(
                q[:, :, -1:], *cut, causal=False, block_k=4096))]
        else:
            planted = [(want, plain((q, *cut), False))]
        half = want[:, :, s // 2:]
        planted.append((half, (half.float() / 1.05).to(half.dtype)))
        faults = [row_rel_err(f, w) for w, f in planted]
        if min(faults) <= bound:
            fail(f"K4 {label}: a planted fault reads {min(faults):.3g}, "
                 f"within the limit {bound}")
        lib = F.scaled_dot_product_attention(*qkv, is_causal=causal)
        lib_err = (got.float() - lib.float()).abs().max().item()
        log(f"  {label}: K4 == plain within rtol {rtol} atol {atol} (max "
            f"abs err {err:.3g}); row-relative {rel:.3g} of {bound} (planted"
            f" dropped key tile {faults[0]:.3g}, denominator 5% high "
            f"{faults[1]:.3g}); {lib_err:.3g} from "
            f"scaled_dot_product_attention")
        del want, planted, cut
    del outs
    log(f"phase 8: K4 checks passed in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ent = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bytes_s = ops_s = 0.0
    for case, qkv in zip(FLASH_CASES, inputs):
        label, dtype_name, causal, b, h, s, d = case
        reps = dict(n_timed=3, n_warm=1)
        k_ms = time_cuda(lambda: flash_cuda(*qkv, causal=causal), flush,
                         **reps)
        p_ms = time_cuda(lambda: plain(qkv, causal), flush, **reps)
        l_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            *qkv, is_causal=causal), flush, **reps)
        dtype = getattr(torch, dtype_name)
        route = flash_plan(d, dtype).kernel
        b_s, o_s = flash_bound(dtype, causal, b, h, s, d, sms, clock)
        for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms)):
            ent[key] += val
        bytes_s += b_s
        ops_s += o_s
        mask = "causal" if causal else "bidirectional"
        kind = "bytes" if b_s >= o_s else "operations"
        bound_ms = max(b_s, o_s) * 1e3
        tflops = 4 * d * flash_pairs(causal, b, h, s) / (k_ms * 1e-3) / 1e12
        both = ""
        if dtype == torch.float32:
            both = "; float32 bounds: " + ", ".join(
                f"{r} {ms:.4f} ms ({ms / k_ms:.1%})" for r, ms in (
                    (r, max(flash_bound(dtype, causal, b, h, s, d, sms,
                                        clock, route=r)) * 1e3)
                    for r in ("fma", "tf32")))
        log(f"  {label} ({dtype_name}, {mask}, B={b} H={h} S={s} D={d}, "
            f"route {route}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"sdpa {l_ms:.4f} ms, bound {bound_ms:.4f} ms ({kind}); "
            f"{bound_ms / k_ms:.1%} of the bound, {tflops:.1f} TFLOP/s, "
            f"{k_ms / l_ms:.2f}x sdpa{both}")
    log(f"phase 8: timed in {time.perf_counter() - t0:.1f} s (median of 3;"
        f" {sms} SMs at {clock / 1e6:.0f} MHz)")
    ent["bound_ms"] = max(bytes_s, ops_s) * 1e3
    ent["bound_by"] = "bytes" if bytes_s >= ops_s else "operations"
    ent["launches"] = launches
    ent["max_abs_err"] = max_err
    return ent


SERVE_SOURCES = (0, 17, 424242)  # phase 9: compiled SSSP vs Engine.run
SERVE_BATCH = 64                 # SSSP sources in one run_batch
PPR_BATCH = 8                    # personalized-walk seeds in one run_batch
N_WALL = 5                       # medians of 5 for the walls


def rel_err(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def wall_ms(call, n=N_WALL):
    """Median host wall (ms) of ``call()`` through a synchronize, and
    the last call's Result."""
    import torch

    times, res = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), res


def leaf_bound_ms(lay, d):
    """The byte bound of one leaf at width ``d`` (float32): each class's
    index streams and tile table, the slot map and zero-degree list, the
    rows of the senders its live lanes name, and every output row, once
    each, at 3.35 TB/s."""
    import torch

    idx, senders = 0, []
    for c in range(lay.n_classes):
        real = lay.class_dst[c] < lay.class_rows[c]
        senders.append(lay.class_src[c][real])
        idx += 2 * int(lay.class_src[c].shape[0])
        idx += int(lay.class_bounds[c].numel())
    n_msg = int(torch.unique(torch.cat(senders)).numel())
    n_bytes = 4 * (idx + lay.n_dst + n_msg * d + lay.n_dst * d)
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_bytes


def serving_phase(hg, flush):
    """Phase 9: compile-once serving on DBLP at full scale through
    ``Engine(delivery="pallas_fused").compile``: each path's K1 launches
    counted from 0 and read after, its results held against
    ``Engine.run`` (or sequential ``run(query=)``), the cache's hits and
    captures checked, and the walls, queries/s and K1 at wide messages
    timed.  Returns the K1 entry's compiled-path keys."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (
        connected_components_spec,
        pagerank_spec,
        random_walk_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import Engine, Program, deliver
    from repro_torch.kernels.deliver import fused
    from repro_torch.kernels.deliver import _mask_per_query
    from repro_torch.sparse.segment import MONOIDS

    dev = hg.dst.device
    eng = Engine(device=dev, delivery="pallas_fused", collect_stats=True)
    served = []

    def counted(tag, call, leaves):
        """One compiled call with K1's counter zeroed just before and
        read just after: one launch per leaf and pair, all replayed."""
        fused.deliver_fused_cuda.launches = 0
        res = call()
        torch.cuda.synchronize()
        launches = fused.deliver_fused_cuda.launches
        m = res.decision["measured"]
        served.append(res)
        if not m["graph"]:
            fail(f"{tag}: no CUDA graph replayed")
        if launches == 0 or launches != m["pairs_run"] * leaves:
            fail(f"{tag}: {launches} K1 launches, expected "
                 f"{m['pairs_run']} pairs x {leaves} leaves")
        return res, launches

    def no_new_capture(tag, traces):
        stats = eng.cache_stats()
        if stats["traces"] != traces:
            fail(f"{tag}: {stats['traces'] - traces} new captures on a "
                 "cache hit")

    # -- PageRank-30 -----------------------------------------------------------
    pr = pagerank_spec(hg, iters=30)
    c_pr = eng.compile(pr)
    t0 = time.perf_counter()
    c_pr.run()
    t_first = time.perf_counter() - t0
    traces, hits = eng.cache_stats()["traces"], eng.cache_stats()["hits"]
    pr_c, pr_launches = counted("pagerank-30", c_pr.run, 3)
    if eng.cache_stats()["hits"] != hits + 1:
        fail("pagerank-30: the second call was no cache hit")
    no_new_capture("pagerank-30", traces)
    pr_r = eng.run(pr)
    rel = max(rel_err(a, b) for a, b in zip(pr_c.value, pr_r.value))
    if not rel <= 1e-5:
        fail(f"compiled pagerank vs Engine.run relative error {rel}")
    log(f"  pagerank-30: first call {t_first:.2f} s (padded layouts, leaf "
        f"plans, warm-up pair, capture); then a cache hit, no new capture, "
        f"{pr_launches} K1 launches replayed ({pr_c.decision['measured']['pairs_run']} "
        f"pairs x 3 leaves); vs Engine.run max relative error {rel:.3g}")

    # -- SSSP from several sources, components --------------------------------
    sp = shortest_paths_spec(hg, 0)
    c_sp = eng.compile(sp)
    c_sp.run()
    traces = eng.cache_stats()["traces"]
    for s in SERVE_SOURCES:
        got, _ = counted(f"sssp from {s}", lambda: c_sp.run(query=s), 2)
        want = eng.run(shortest_paths_spec(hg, s))
        for a, b in zip(got.value, want.value):
            if not same_bits(a, b):
                fail(f"compiled sssp from {s} != Engine.run")
        for a, b in zip(got.superstep_stats, want.superstep_stats):
            if not torch.equal(a, b):
                fail(f"compiled sssp from {s}: activity stats differ")
        log(f"  sssp from {s}: bitwise, equal stats, "
            f"{got.decision['measured']['pairs_run']} pairs, "
            f"{got.decision['measured']['host_syncs']} host syncs")
    no_new_capture("sssp", traces)
    cc = connected_components_spec(hg)
    c_cc = eng.compile(cc)
    c_cc.run()
    cc_c, _ = counted("components", c_cc.run, 2)
    cc_r = eng.run(cc)
    for a, b in zip(cc_c.value, cc_r.value):
        if not same_bits(a, b):
            fail("compiled components != Engine.run")
    log(f"  components: bitwise, "
        f"{cc_c.decision['measured']['pairs_run']} pairs")

    # -- run_batch: 64 SSSP sources, 8 PPR seeds -------------------------------
    rng = np.random.default_rng(9)
    sources = rng.integers(0, hg.n_vertices, SERVE_BATCH).astype(np.int32)
    sources[0] = 0
    # The batched entry's memory: what the cache counts for it, against
    # what the card allocated and reserved around its build (the
    # padded structure and layouts exist already; the result is freed).
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated(dev)
    reserved0 = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    c_sp.run_batch(sources)
    t_first_b = time.perf_counter() - t0
    torch.cuda.synchronize()
    alloc_mb = (torch.cuda.memory_allocated(dev) - alloc0) / 2**20
    reserved_mb = (torch.cuda.memory_reserved(dev) - reserved0) / 2**20
    batch_exe = next(reversed(eng._exec_cache.values()))
    entry_mb = batch_exe.nbytes / 2**20
    pool_mb = batch_exe.pool_bytes / 2**20
    log(f"  sssp x{SERVE_BATCH} entry: {entry_mb:.1f} MB counted by the "
        f"cache (graph pool {pool_mb:.1f} MB); around its build the card "
        f"allocated {alloc_mb:+.1f} MB and reserved {reserved_mb:+.1f} MB")
    if not 0 < batch_exe.nbytes <= eng.cache_stats()["capacity_bytes"]:
        fail(f"sssp x{SERVE_BATCH} entry counts {batch_exe.nbytes} bytes")
    traces = eng.cache_stats()["traces"]
    batch, b_launches = counted(f"sssp x{SERVE_BATCH}", lambda: c_sp.run_batch(sources),
                                2)
    no_new_capture("sssp x64", traces)
    slowest = 0
    for i, s in enumerate(sources):
        one = c_sp.run(query=int(s))
        served.append(one)
        for a, b in zip(one.value, batch.value):
            if not same_bits(a, b[i]):
                fail(f"run_batch sssp row {i} (source {s}) != run(query=)")
        for a, b in zip(one.superstep_stats, batch.superstep_stats):
            if not torch.equal(a, b[i]):
                fail(f"run_batch sssp row {i}: activity stats differ")
        slowest = max(slowest, one.decision["measured"]["pairs_run"])
    if batch.supersteps_executed != slowest:
        fail(f"run_batch sssp ran {batch.supersteps_executed} pairs, the "
             f"slowest query {slowest}")
    reached = int(torch.isfinite(batch.value[0]).sum())
    log(f"  sssp x{SERVE_BATCH}: first call {t_first_b:.2f} s; bitwise "
        f"against {SERVE_BATCH} run(query=) calls, equal stats, "
        f"{batch.supersteps_executed} pairs (the slowest query's), "
        f"{b_launches} K1 launches at D = {SERVE_BATCH}, {reached} "
        f"(vertex, source) pairs reached")

    rw = random_walk_spec(hg, iters=30)
    c_rw = eng.compile(rw)
    seeds = rng.integers(0, hg.n_vertices, PPR_BATCH).astype(np.int32)
    c_rw.run_batch(seeds)
    ppr, _ = counted(f"ppr x{PPR_BATCH}", lambda: c_rw.run_batch(seeds), 2)
    ppr_rel = 0.0
    for i, s in enumerate(seeds):
        one = c_rw.run(query=int(s))
        served.append(one)
        ppr_rel = max(ppr_rel, rel_err(ppr.value[i], one.value))
        mass = float(one.value.sum())
        if not abs(mass - 1.0) < 1e-3 or not torch.isfinite(one.value).all():
            fail(f"ppr seed {s}: mass {mass}")
    if not ppr_rel <= 1e-5:
        fail(f"run_batch ppr vs run(query=) relative error {ppr_rel}")
    log(f"  ppr x{PPR_BATCH}: vs {PPR_BATCH} run(query=) calls max "
        f"relative error {ppr_rel:.3g}")
    for res in served:
        if "degraded_from" in res.decision:
            fail(f"a {res.config.delivery} Result degraded from "
                 f"{res.decision['degraded_from']}")

    # -- a K1 launch failure surfaces: no plain twin serves the card ----------
    class Failing:
        @staticmethod
        def deliver_fused_launch(*args):
            return 1

    entries = eng.cache_stats()["entries"]
    real_lib = fused._kernel_lib
    fused._kernel_lib = lambda: Failing
    try:
        eng.compile(pagerank_spec(hg, iters=2)).run()
    except RuntimeError as err:
        raised = str(err)
    else:
        raised = None
    finally:
        fused._kernel_lib = real_lib
    if raised is None or "launch failed" not in raised:
        fail(f"a failing K1 launch did not raise from run(): {raised}")
    if eng.cache_stats()["entries"] != entries:
        fail("the failed build left a cache entry")
    log(f"  a failing K1 launch raised from run() ({raised!r}); no cache "
        f"entry left")

    # -- timings ----------------------------------------------------------------
    log(f"  timings (host wall through a synchronize, median of {N_WALL}):")
    walls = {}
    for label, compiled, one_shot in (
            ("pagerank-30", c_pr.run, lambda: eng.run(pr)),
            ("sssp from 0", lambda: c_sp.run(query=0), lambda: eng.run(sp))):
        c_ms, c_res = wall_ms(compiled)
        r_ms, r_res = wall_ms(one_shot)
        walls[label] = (c_ms, r_ms)
        cm, rm = c_res.decision["measured"], r_res.decision["measured"]
        log(f"    {label}: compiled {c_ms:.3f} ms (dispatch "
            f"{cm['dispatch_s'] * 1e3:.3f}, device wait "
            f"{cm['device_wait_s'] * 1e3:.3f}, {cm['host_syncs']} host "
            f"syncs) vs Engine.run {r_ms:.3f} ms (dispatch "
            f"{rm['dispatch_s'] * 1e3:.3f}, device wait "
            f"{rm['device_wait_s'] * 1e3:.3f}, {rm['host_syncs']} host "
            f"syncs): {r_ms / c_ms:.2f}x")
    b_ms, _ = wall_ms(lambda: c_sp.run_batch(sources), 3)
    t0 = time.perf_counter()
    for s in sources:
        c_sp.run(query=int(s))
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for s in sources[:16]:
        eng.run(shortest_paths_spec(hg, int(s)))
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3 / 16 * SERVE_BATCH
    log(f"    sssp x{SERVE_BATCH}: run_batch {b_ms:.2f} ms "
        f"({SERVE_BATCH / b_ms * 1e3:.1f} queries/s, median of 3) vs "
        f"{SERVE_BATCH} sequential run(query=) {seq_ms:.2f} ms "
        f"({SERVE_BATCH / seq_ms * 1e3:.1f} queries/s) vs Engine.run "
        f"{run_ms:.2f} ms ({SERVE_BATCH / run_ms * 1e3:.1f} queries/s, 16 "
        f"timed)")

    # -- K1 at wide messages on the bucket-padded layout ----------------------
    prep = c_sp._prepared(None, rebind=True)
    fwd, hgp = prep.delivery[0], prep.hgp
    min_prog = Program(procedure=None, combiner="min")
    log(f"  K1 on the bucket-padded v->he layout (n_src {fwd.n_src}, n_dst "
        f"{fwd.n_dst}, {fused.leaf_plan(fwd).zero_dst.numel()} zero-degree "
        f"destinations), float32 min, no activity; L2 flushed, median of "
        f"{N_TIMED}:")
    wide = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for d in (1, 8, SERVE_BATCH):
        msgs = torch.randint(-1000, 1000, (fwd.n_src, d), device=dev,
                             generator=gen).float()
        got = fused.deliver_leaf_cuda(msgs, None, fwd, "min")
        want = fused.deliver_leaf_plain(msgs, None, fwd, "min")
        if not same_bits(got, want):
            fail(f"K1 at D = {d} != deliver_leaf_plain")
        k_ms = time_cuda(
            lambda: fused.deliver_leaf_cuda(msgs, None, fwd, "min"), flush)
        k_dev = time_device(
            lambda: fused.deliver_leaf_cuda(msgs, None, fwd, "min"), flush)
        p_ms = time_cuda(
            lambda: fused.deliver_leaf_plain(msgs, None, fwd, "min"), flush)
        # The port's xla lowering of the same leaf: gather, mask the
        # padding lanes, segment min.
        x_leaf = lambda: deliver(msgs, None, hgp.src, hgp.dst, fwd.n_dst,
                                 min_prog, e_mask=hgp.e_mask)
        if not same_bits(x_leaf(), want):
            fail(f"xla leaf at D = {d} != deliver_leaf_plain")
        x_ms = time_cuda(x_leaf, flush)
        bound, n_bytes = leaf_bound_ms(fwd, d)
        wide[d] = (k_ms, p_ms, bound, k_dev, x_ms)
        line = (f"    D = {d}: {k_ms * 1e3:.1f} us (device "
                f"{k_dev * 1e3:.1f} us), plain "
                f"{p_ms * 1e3:.1f} us, xla {x_ms * 1e3:.1f} us, bound "
                f"{bound * 1e3:.1f} us "
                f"({n_bytes / 1e6:.1f} MB; {bound / k_ms:.1%} of it, of "
                f"the device time {bound / k_dev:.1%})")
        if d > 1:
            act = torch.rand(fwd.n_src, d, device=dev, generator=gen) < 0.5
            m_ms = time_cuda(lambda: _mask_per_query(msgs, act,
                                                     MONOIDS["min"]), flush)
            line += (f"; the per-query activity pass before it "
                     f"{m_ms * 1e3:.1f} us")
        log(line)
        del msgs
    stats = eng.cache_stats()
    sizes = ", ".join(
        f"{m['algorithm']}/{m['batch_pad'] or 1} {m['bytes'] / 2**20:.1f}"
        for m in stats["entry_shapes"])
    log(f"  cache: {stats['entries']} entries, {stats['traces']} captures, "
        f"{stats['hits']} hits, {stats['bytes'] / 2**20:.1f} MB held of "
        f"{stats['capacity_bytes'] / 2**20:.0f} MB (MB each: {sizes})")
    if stats["bytes"] > stats["capacity_bytes"]:
        fail("the executable cache holds more than its byte bound")
    return {
        "compiled_launches": pr_launches,
        "compiled_pagerank_ms": walls["pagerank-30"][0],
        "one_shot_pagerank_ms": walls["pagerank-30"][1],
        "compiled_sssp_ms": walls["sssp from 0"][0],
        "one_shot_sssp_ms": walls["sssp from 0"][1],
        "batch64_qps": SERVE_BATCH / b_ms * 1e3,
        "sequential64_qps": SERVE_BATCH / seq_ms * 1e3,
        "d8_ms": wide[8][0], "d8_device_ms": wide[8][3],
        "d8_bound_ms": wide[8][2], "d8_library_ms": wide[8][4],
        "d64_ms": wide[SERVE_BATCH][0],
        "d64_device_ms": wide[SERVE_BATCH][3],
        "d64_plain_ms": wide[SERVE_BATCH][1],
        "d64_bound_ms": wide[SERVE_BATCH][2],
        "d64_library_ms": wide[SERVE_BATCH][4],
    }


DELIVERY_SCALES = (0.002, 0.01, 0.05, 0.25, 1.0)  # phase 10: DBLP sizes
DELIVERY_WIDTHS = (1, 2, 8, 16, 64)               # float32 columns
DELIVERY_BAND = 0.10  # a point this close to the crossover only logs


def delivery_probe(hg, d):
    """A monoid spec whose messages are ``d`` float32 columns: what
    ``select_delivery`` reads to price one delivery pair at width d."""
    import torch

    from repro_torch.algorithms import AlgorithmSpec
    from repro_torch.core import Program

    prog = Program(procedure=None, combiner="sum")
    return AlgorithmSpec(
        hg0=hg, initial_msg=torch.zeros(d) if d > 1 else torch.zeros(()),
        v_program=prog, he_program=prog, max_iters=1,
        extract=lambda out: out, name=f"probe[D={d}]")


def delivery_grid(hg_full, flush):
    """Phase 10: one delivery pair (v->he, then he->v), float32 sum, no
    activity, through the port's ``xla`` lowering (``deliver`` with no
    layout: gather, mask, segment reduce) and the fused K1 leaf
    (``deliver`` with the Engine's layouts), on DBLP at
    ``DELIVERY_SCALES`` and ``DELIVERY_WIDTHS``: each checked against the
    other (1e-5), timed in turns (``time_two``: L2 flushed, from an
    idle card, median of 20), and priced by ``select_delivery`` as
    ``Engine.resolve`` runs it (at a contested point, rows over 64 bytes,
    it times one pair on each lowering itself: its times are logged).
    Beside them, ``loop_ms``: a pair's share of 20 pairs queued back to
    back, as a superstep loop runs them (informational).  Returns the
    grid's records."""
    import torch

    from repro_torch.core import Engine, Program, deliver
    from repro_torch.data import make_dataset
    from repro_torch.obs import delivery_traffic_pair

    dev = hg_full.dst.device
    prog = Program(procedure=None, combiner="sum")
    gen = torch.Generator(device=dev).manual_seed(11)
    records = []
    log("phase 10: one delivery pair (fwd + bwd), float32 sum, no "
        "activity; xla (gather + mask + segment reduce) vs the fused K1 "
        f"leaf; in turns, L2 flushed, from an idle card, median of "
        f"{N_TIMED}; loop: a pair's share of {N_TIMED} back to back; ms")
    log("  scale      nnz   D   xla_ms  fused_ms  xla/fused  auto          "
        "xla_loop fused_loop")
    for scale in DELIVERY_SCALES:
        hg = (hg_full if scale == 1.0
              else make_dataset("dblp", scale, seed=0, device=dev))
        eng = Engine(device=dev)
        fwd, bwd = eng._delivery_layouts(hg)
        nv, ne = hg.n_vertices, hg.n_hyperedges
        for d in DELIVERY_WIDTHS:
            shape = (lambda n: (n,)) if d == 1 else (lambda n: (n, d))
            m_v = torch.rand(shape(nv), generator=gen, device=dev)
            m_he = torch.rand(shape(ne), generator=gen, device=dev)

            def pair(fused):
                out_he = deliver(m_v, None, hg.src, hg.dst, ne, prog,
                                 layout=fwd if fused else None)
                out_v = deliver(m_he, None, hg.dst, hg.src, nv, prog,
                                layout=bwd if fused else None)
                return out_he, out_v

            for a, b in zip(pair(True), pair(False)):
                check_close(f"delivery pair scale {scale} D={d}", a, b,
                            1e-5, 1e-5)
            x_ms, f_ms = time_two(lambda: pair(False), lambda: pair(True),
                                  flush)
            loop = {}
            for fused in (False, True):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(N_TIMED):
                    pair(fused)
                end.record()
                end.synchronize()
                loop[fused] = start.elapsed_time(end) / N_TIMED
            resolved, _, decision = eng.resolve(delivery_probe(hg, d))
            pick, why = resolved.delivery, decision["delivery"]
            traffic = delivery_traffic_pair((fwd, bwd), 4.0 * d)
            records.append({
                "scale": scale, "nnz": hg.nnz, "d": d, "xla_ms": x_ms,
                "fused_ms": f_ms, "xla_loop_ms": loop[False],
                "fused_loop_ms": loop[True], "auto_picks": pick,
                "reason": why["reason"],
                "measured_ms": why.get("measured_ms"),
                "model_traffic_ratio": (traffic["reference_total_bytes"]
                                        / traffic["total_bytes"]),
                "fused_speedup": x_ms / f_ms,
            })
            log(f"  {scale:<6} {hg.nnz:>9} {d:>3} {x_ms:8.4f} {f_ms:9.4f} "
                f"{x_ms / f_ms:10.3f}  {pick:<12}  {loop[False]:7.4f} "
                f"{loop[True]:8.4f}" + (
                    f"  (auto measured xla {why['measured_ms']['xla']:.4f}, "
                    f"fused {why['measured_ms']['pallas_fused']:.4f})"
                    if "measured_ms" in why else ""))
            del m_v, m_he
        del fwd, bwd, eng
    return records


def check_delivery_term(records):
    """Phase 10's check: at every grid point ``select_delivery`` picks the
    faster path, unless the two are within ``DELIVERY_BAND`` of each
    other (logged).  Also the calibration record of the traffic model
    (``obs.delivery_calibration``)."""
    from repro_torch.obs import delivery_calibration

    wrong = []
    for r in records:
        faster = "pallas_fused" if r["fused_ms"] < r["xla_ms"] else "xla"
        gap = (abs(r["fused_ms"] - r["xla_ms"])
               / min(r["fused_ms"], r["xla_ms"]))
        if r["auto_picks"] == faster:
            continue
        point = (f"scale {r['scale']} D={r['d']}: auto picks "
                 f"{r['auto_picks']}, {faster} is faster by {gap:.1%}")
        if gap <= DELIVERY_BAND:
            log(f"  within {DELIVERY_BAND:.0%} of the crossover: {point}")
        else:
            wrong.append(point)
    cal = delivery_calibration({f"{r['scale']}/D={r['d']}": r
                                for r in records})["summary"]
    log(f"  traffic model vs measured speedup over {cal['regimes']} "
        f"points: mean |log2 residual| {cal['mean_abs_residual_log2']:.3f}, "
        f"max {cal['max_abs_residual_log2']:.3f}, suggested scale "
        f"{cal['suggested_model_scale']:.3f}; auto agrees with the "
        f"faster path at {cal['decision_accuracy']:.0%} of the points")
    if wrong:
        fail("select_delivery picks the slower path: " + "; ".join(wrong))


def graph_pagerank_plain(g, iters=30, alpha=0.15):
    """``graph_pagerank``'s plain version: both sums by ``index_add_``
    over the edges in their own order (the JAX package's
    ``segment_sum``)."""
    import torch

    from repro_torch.kernels.segsum import segsum_plain

    nv = g.n_vertices
    w = g.e_attr.float()
    out_w = segsum_plain(w[:, None], g.src, nv)[:, 0].clamp(min=1e-12)
    rank = torch.ones(nv, dtype=torch.float32, device=w.device)
    for _ in range(iters):
        contrib = (rank / out_w)[g.src] * w
        rank = alpha + (1.0 - alpha) * segsum_plain(contrib[:, None],
                                                    g.dst, nv)[:, 0]
    return rank


CLIQUE_EDGES = 33_490_568  # DBLP's symmetrized expansion (numpy, seed 0)
FIG1_EDGES = [[0, 1], [0, 1, 2, 3], [0, 3, 4], [2, 3]]


def clique_phase(hg, flush):
    """Phase 11: the clique representation on DBLP at full scale:
    ``to_graph``, ``graph_pagerank`` (K2b once an iteration; its
    out-weights by ``index_add_``, which measured faster than K2a there)
    against its plain version, K2 launches counted over
    ``Engine(representation="clique").run``, K2b repeated bitwise, the
    two design points timed, K2b and K2a against ``index_add_`` at the
    clique's shapes, ``resolve`` on DBLP and on Fig. 1, and a traced
    ``explain`` + ``run``.  Returns K2b's entry of the kernel line at
    the clique's shapes and K2a's numbers there."""
    import torch

    from repro_torch.algorithms import graph_pagerank, vertex_pagerank_spec
    from repro_torch.core import Engine, HyperGraph, to_graph
    from repro_torch.kernels.segsum import (
        csr_row_offsets,
        segsum_cuda,
        segsum_plain,
        segsum_sorted_cuda,
        segsum_sorted_plain,
    )
    from repro_torch.obs import Tracer

    dev = hg.dst.device
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    g = to_graph(hg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_edges = int(g.src.numel())
    log(f"  to_graph: {n_edges} symmetric edges in {build_s:.2f} s")
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    if n_edges != CLIQUE_EDGES:
        fail(f"to_graph gave {n_edges} edges, expected {CLIQUE_EDGES}")

    spec = vertex_pagerank_spec(hg, iters=30)
    clique = Engine(device=dev, representation="clique")
    segsum_cuda.launches = segsum_sorted_cuda.launches = 0
    res = clique.run(spec)
    torch.cuda.synchronize()
    launches = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    log(f"  {at()} Engine(representation='clique').run("
        f"vertex_pagerank_spec): K2a {launches[0]} launches, K2b "
        f"{launches[1]}")
    if launches != (0, 30):
        fail(f"the clique run launched K2a/K2b {launches} times, expected "
             "(0, 30)")
    want = graph_pagerank_plain(g)
    rank = graph_pagerank(g)
    rel = rel_err(rank, want)
    rel_run = rel_err(res.value, want)
    log(f"  {at()} graph_pagerank vs plain: max relative error "
        f"{rel:.3g}; the Engine run's {rel_run:.3g}")
    if not (rel <= 1e-5 and rel_run <= 1e-5):
        fail(f"graph_pagerank vs plain relative error {rel}, {rel_run}")
    if (res.value.shape != (hg.n_vertices,)
            or not torch.isfinite(res.value).all()
            or (res.value <= 0).any()):
        fail("clique ranks are not finite, positive, of shape [n]")

    # The per-iteration sum's inputs, as graph_pagerank builds them.
    nv = g.n_vertices
    w = g.e_attr
    order = torch.sort(g.dst, stable=True).indices
    dst_s = g.dst[order]
    off = csr_row_offsets(dst_s, nv)
    contrib = (torch.rand(nv, device=dev)[g.src[order]] * w[order])[:, None]
    first = segsum_sorted_cuda(contrib, off, nv)
    for i in range(30):
        if not same_bits(segsum_sorted_cuda(contrib, off, nv), first):
            fail(f"K2b call {i + 2} of 31 with one set of offsets differs")
    rtol, atol = segsum_tol(n_edges, nv, torch.float32)
    k2b_err = check_close("K2b at the clique shape", first,
                          segsum_sorted_plain(contrib, off, nv), rtol, atol)
    w2 = w[:, None].contiguous()
    k2a_err = check_close("K2a out_w", segsum_cuda(w2, g.src, nv),
                          segsum_plain(w2, g.src, nv), rtol, atol)
    log(f"  {at()} K2b: 31 calls with one set of offsets, bitwise equal")

    # -- resolve: bipartite on DBLP, clique on Fig. 1 -------------------------
    rep = Engine(device=dev).resolve(spec)[0].representation
    if rep != "bipartite":
        fail(f"auto resolves {rep} on DBLP, expected bipartite")
    fig1 = HyperGraph.from_hyperedge_lists(FIG1_EDGES, n_vertices=5,
                                           device=dev)
    s1 = vertex_pagerank_spec(fig1, iters=8)
    r1 = Engine(device=dev).run(s1)
    rel1 = rel_err(r1.value, graph_pagerank_plain(to_graph(fig1), 8))
    log(f"  {at()} auto: {rep} on DBLP, {r1.representation} on Fig. 1 "
        f"(vs plain "
        f"{rel1:.3g})")
    if r1.representation != "clique" or not rel1 <= 1e-5:
        fail(f"Fig. 1: {r1.representation}, relative error {rel1}")

    # -- a traced explain + run on the card ----------------------------------
    tr = Tracer()
    traced = Engine(device=dev, tracer=tr)
    ex = traced.explain(spec)
    res_t = traced.run(spec)
    for axis, field in (("representation", "representation"),
                        ("backend", "backend"), ("delivery", "delivery")):
        if ex["axes"][axis]["winner"] != getattr(res_t.config, field):
            fail(f"explain's {axis} winner {ex['axes'][axis]['winner']} != "
                 f"run's {getattr(res_t.config, field)}")
    if ex["config"] != res_t.config:
        fail("explain's config != run's")
    runs = [sp for sp in tr.spans() if sp.name == "engine.run"]
    if not runs or any("device_wait_s" not in sp.args for sp in runs):
        fail("engine.run spans without device_wait_s")
    d_in = ex["axes"]["delivery"]["inputs"]
    log(f"  {at()} traced explain + run: winners {res_t.representation} / "
        f"{res_t.backend} / {res_t.config.delivery} ({d_in['lowering']}, "
        f"{ex['axes']['delivery']['reason']}); spans "
        f"{sorted({sp.name for sp in tr.spans()})}, engine.run device wait "
        f"{runs[-1].args['device_wait_s'] * 1e3:.3f} ms")

    # -- timings --------------------------------------------------------------
    bip = Engine(device=dev, representation="bipartite",
                 delivery="pallas_fused")
    bip.run(spec)  # layouts built, warm
    c_ms, _ = wall_ms(lambda: clique.run(spec), 3)
    b_ms, _ = wall_ms(lambda: bip.run(spec), 3)
    p_ms, _ = wall_ms(lambda: graph_pagerank(g), 3)
    log(f"  {at()} vertex PageRank-30 (host wall through a synchronize, "
        f"median of "
        f"3): clique {c_ms:.1f} ms (to_graph included; graph_pagerank "
        f"alone {p_ms:.2f} ms) vs bipartite fused {b_ms:.2f} ms")
    e = n_edges
    entries = {}
    for name, kernel, plain, library, n_bytes in (
            ("segsum", lambda: segsum_cuda(w2, g.src, nv),
             lambda: segsum_plain(w2, g.src, nv),
             lambda: torch.zeros(nv, 1, device=dev).index_add_(0, g.src, w2),
             4 * (2 * e + nv)),
            ("segsum_sorted", lambda: segsum_sorted_cuda(contrib, off, nv),
             lambda: segsum_sorted_plain(contrib, off, nv),
             lambda: torch.zeros(nv, 1, device=dev).index_add_(
                 0, dst_s, contrib),
             4 * (e + nv + nv + 1))):
        k_ms = time_cuda(kernel, flush)
        p_k = time_cuda(plain, flush)
        l_ms = time_cuda(library, flush)
        b_s, o_s = n_bytes / HBM_BYTES_PER_S, e / FP32_OPS_PER_S
        entries[name] = {
            "ms": k_ms, "plain_ms": p_k, "library_ms": l_ms,
            "bound_ms": max(b_s, o_s) * 1e3,
            "bound_by": "bytes" if b_s >= o_s else "operations",
            "launches": launches[0 if name == "segsum" else 1],
            "max_abs_err": k2a_err if name == "segsum" else k2b_err,
        }
        log(f"  {'K2a out_w' if name == 'segsum' else 'K2b per iteration'} "
            f"(E = {e} into {nv} rows, float32 D=1): kernel {k_ms:.4f} ms, "
            f"plain {p_k:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
            f"{max(b_s, o_s) * 1e3:.4f} ms; the kernel is "
            f"{'faster' if k_ms < l_ms else 'SLOWER'} than index_add_")
    entries["segsum_sorted"].update(
        clique_ms=c_ms, bipartite_ms=b_ms, graph_pagerank_ms=p_ms,
        to_graph_s=build_s,
        caller="algorithms/graph_pagerank.py: the sum by destination, "
               "once an iteration (Engine clique run)")
    log(f"  {at()} phase 11 timings done")
    return entries


SERVE_REQUESTS = 256      # phase 12: the front-end's trace
SERVE_MIX = 0.6           # its SSSP share (the launcher's default)
SERVE_MAX_BATCH = 16      # the launcher's default bucket
SERVE_ITERS = 12          # the launcher's superstep budget
SERVE_SAMPLE = 16         # served results held against sequential runs
FUTURE_TIMEOUT_S = 300    # no future may take longer to resolve
FAULT_PLAN = {"rules": [
    {"point": "execute", "trigger": "every", "n": 7, "error": "transient"},
    {"point": "serve.flush", "trigger": "nth", "n": 3, "error": "transient"},
    {"point": "serve.worker", "trigger": "nth", "n": 2},
]}


def checkpoint_case(tag, spec, leaves, root, compiled=False):
    """Phase 12 (a), one spec on DBLP through ``pallas_fused``: the run
    with ``checkpoint_every=7`` bitwise equal to the run without; a run
    killed by ``checkpoint.chunk`` (``nth=2``, fatal) after pair 14; a
    fresh Engine resuming from pair 14, bitwise equal (values and
    trace), its K1 launches counted from 0 (the resumed pairs only).
    ``compiled``: all through ``Engine.compile(spec)`` (the
    ``_run_checkpointed`` route).  Returns the resumed run's launches and
    the save and restore seconds."""
    import torch

    from repro_torch.core import Engine, tree_leaves
    from repro_torch.faults import FaultInjector, InjectedFault
    from repro_torch.kernels.deliver import fused
    from repro_torch.obs import Tracer

    dev = spec.hg0.device
    tracer = Tracer()

    def engine(**kw):
        return Engine(device=dev, delivery="pallas_fused",
                      collect_stats=True, tracer=tracer, **kw)

    def run(eng, **kw):
        if compiled:
            return eng.compile(spec, **kw).run()
        return eng.run(spec, **kw)

    def same(got, want, what):
        for a, b in zip(tree_leaves(got.value), tree_leaves(want.value)):
            if a.device.type != "cuda" or not same_bits(a, b):
                fail(f"{tag}: {what} values differ from the uninterrupted run")
        for a, b in zip(got.superstep_stats, want.superstep_stats):
            if not torch.equal(a, b):
                fail(f"{tag}: {what} activity trace differs")

    base = run(engine())
    same(run(engine(), checkpoint_every=7,
             checkpoint_dir=f"{root}/whole"), base, "checkpointed")
    plan = {"rules": [{"point": "checkpoint.chunk", "trigger": "nth",
                       "n": 2, "error": "fatal"}]}
    try:
        run(engine(fault_injector=FaultInjector.from_json(plan)),
            checkpoint_every=7, checkpoint_dir=f"{root}/killed")
    except InjectedFault:
        pass
    else:
        fail(f"{tag}: checkpoint.chunk nth=2 did not kill the run")
    if not os.path.isdir(f"{root}/killed/step_00000014"):
        fail(f"{tag}: no snapshot of pair 14 survived the kill")
    fused.deliver_fused_cuda.launches = 0
    res = run(engine(), checkpoint_every=7, checkpoint_dir=f"{root}/killed")
    torch.cuda.synchronize()
    launches = fused.deliver_fused_cuda.launches
    same(res, base, "resumed")
    spans = tracer.spans()
    saves = [s.dur_s for s in spans if s.name == "faults.checkpoint_save"]
    restores = [s.dur_s for s in spans
                if s.name == "faults.checkpoint_restore"]
    if len(restores) != 1:
        fail(f"{tag}: {len(restores)} restores, expected 1")
    if compiled:
        if res.decision.get("checkpointed", {}).get("every") != 7:
            fail(f"{tag}: the compiled run did not take _run_checkpointed")
        pairs = (launches // leaves if launches else 0)
    else:
        m = res.decision["measured"]
        if m["resumed_from"] != 14:
            fail(f"{tag}: resumed from pair {m['resumed_from']}, not 14")
        pairs = m["pairs_run"]
        if launches != pairs * leaves:
            fail(f"{tag}: {launches} K1 launches resuming, expected "
                 f"{pairs} pairs x {leaves} leaves")
    log(f"  {tag}: checkpointed every 7 bitwise; killed after pair 14; "
        f"resumed bitwise (values and trace), {launches} K1 launches "
        f"({pairs} pairs resumed); {len(saves)} saves, "
        f"{statistics.median(saves) * 1e3:.1f} ms median, "
        f"{max(saves) * 1e3:.1f} max; restore "
        f"{restores[0] * 1e3:.1f} ms")
    return launches, statistics.median(saves), restores[0]


def replay(fe, trace, timeout=FUTURE_TIMEOUT_S):
    """Submit the whole trace, then wait for each future (with a
    timeout: a hang fails the phase).  Returns the outcomes (a
    ``ServedResult`` or the typed error) and the wall seconds."""
    import concurrent.futures

    from repro_torch.faults import FaultError

    t0 = time.perf_counter()
    out = []
    try:
        fe.start()
        futs = [fe.submit(key, query=q) for key, q in trace]
        for (key, q), f in zip(trace, futs):
            try:
                out.append(f.result(timeout=timeout))
            except concurrent.futures.TimeoutError:
                fail(f"request {key} {q} did not resolve in {timeout} s")
            except FaultError as err:
                out.append(err)
    finally:
        fe.close()
    return out, time.perf_counter() - t0


def fault_serving_phase(hg):
    """Phase 12: fault-tolerant serving on DBLP at full scale (see the
    module docstring).  Returns K1's phase-12 keys for the kernel line."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.algorithms import (
        pagerank_spec,
        random_walk_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import Engine
    from repro_torch.faults import FaultError, FaultInjector, InjectedFault
    from repro_torch.kernels.deliver import fused
    from repro_torch.launch.serve_hypergraph import (
        agrees,
        batch_buckets,
        make_trace,
    )
    from repro_torch.serve import Frontend, warm

    dev = hg.dst.device
    # -- (a) checkpoint/resume --------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        pr_launches, pr_save, pr_restore = checkpoint_case(
            "pagerank-30", pagerank_spec(hg, iters=30), 3, f"{root}/pr")
        checkpoint_case("sssp from 0 (halts early)",
                        shortest_paths_spec(hg, 0), 2, f"{root}/sp")
        checkpoint_case("compiled pagerank-30", pagerank_spec(hg, iters=30),
                        3, f"{root}/cpr", compiled=True)
    if pr_launches != 16 * 3:
        fail(f"pagerank-30 resumed with {pr_launches} K1 launches, not 48")
    log(f"  (a) {time.perf_counter() - t0:.1f} s")

    # -- (b) the front-end, fault-free -----------------------------------------
    t0 = time.perf_counter()
    eng = Engine(device=dev, delivery="pallas_fused")
    specs = {"sssp": shortest_paths_spec(hg, source=0,
                                         max_iters=SERVE_ITERS),
             "ppr": random_walk_spec(hg, iters=SERVE_ITERS)}
    compiled = {key: eng.compile(spec) for key, spec in specs.items()}

    def frontend(**kw):
        fe = Frontend(eng, max_batch=SERVE_MAX_BATCH, max_delay_ms=5.0, **kw)
        for key, c in compiled.items():
            fe.register(key, c)
        return fe

    buckets = batch_buckets(SERVE_MAX_BATCH)
    report = warm(eng, list(compiled.values()), batch_sizes=buckets,
                  queries=[0, 0])
    captures = eng.cache_stats()["traces"]
    log(f"  warm: {report['traces']} captures in {report['boot_s']:.2f} s "
        f"(buckets {buckets}, both paths, and each unbatched)")
    rng, trace = make_trace(hg.n_vertices, SERVE_REQUESTS, SERVE_MIX, 0)
    fe = frontend()
    fused.deliver_fused_cuda.launches = 0
    clean, wall = replay(fe, trace)
    launches = fused.deliver_fused_cuda.launches
    errors = [r for r in clean if isinstance(r, Exception)]
    if errors:
        fail(f"{len(errors)} fault-free requests failed: {errors[0]!r}")
    if eng.cache_stats()["traces"] != captures:
        fail("the worker captured after warm")
    st = fe.stats()
    flushes = sum(st["flush_reasons"].values())
    pick = rng.choice(len(trace), size=SERVE_SAMPLE, replace=False)
    for i in pick:
        key, q = trace[i]
        if not agrees(key, clean[i].value, compiled[key].run(query=q).value):
            fail(f"served {key} {q} != sequential compiled run")
    qps = len(trace) / wall
    log(f"  (b) {len(trace)} requests ({sum(k == 'sssp' for k, _ in trace)} "
        f"sssp) in {wall:.3f} s: {qps:.1f} requests/s; queue wait p50 "
        f"{st['queue_wait']['p50_s'] * 1e3:.2f} ms p99 "
        f"{st['queue_wait']['p99_s'] * 1e3:.2f} ms, execute p50 "
        f"{st['execute']['p50_s'] * 1e3:.2f} ms p99 "
        f"{st['execute']['p99_s'] * 1e3:.2f} ms; flushes "
        f"{st['flush_reasons']}; {launches} K1 launches "
        f"({launches / flushes:.1f} a flush); {SERVE_SAMPLE} sampled "
        f"results agree with sequential runs (sssp bitwise, ppr 1e-5)")
    for bucket, occ in st["buckets"].items():
        log(f"    bucket {bucket}: {occ['flushes']} flushes, occupancy "
            f"{occ['mean_occupancy']:.2f}")
    cs = eng.cache_stats()
    log(f"    cache: {cs['entries']} entries, {cs['traces']} captures (none "
        f"after warm), {cs['hits']} hits, {cs['misses']} misses, "
        f"{cs['bytes'] / 2**20:.1f} MB")
    # The resilient default against resilience=False on the same trace,
    # in turns (the reference's "<2% fault-free overhead", measured).
    walls = {True: [], False: []}
    for resilient in (False, True, True, False):
        _, w = replay(frontend(resilience=resilient), trace)
        walls[resilient].append(w)
    on, off = min(walls[True]), min(walls[False])
    log(f"    fault-free overhead: resilient {on * 1e3:.1f} ms vs "
        f"resilience=False {off * 1e3:.1f} ms (best of 2 each): "
        f"{(on / off - 1) * 100:+.1f}%")
    log(f"  (b) {time.perf_counter() - t0:.1f} s")

    # -- (c) the same trace under faults ---------------------------------------
    inj = FaultInjector.from_json(FAULT_PLAN)
    eng.fault_injector = inj
    faulted, f_wall = replay(frontend(), trace)
    eng.fault_injector = None
    typed = 0
    for i, (r, ok) in enumerate(zip(faulted, clean)):
        if isinstance(r, Exception):
            if not isinstance(r, FaultError):
                fail(f"request {i} resolved untyped: {r!r}")
            typed += 1
        elif not agrees(trace[i][0], r.value, ok.value):
            fail(f"request {i} under faults != its fault-free value")
    snap = inj.snapshot()
    log(f"  (c) {len(trace)} requests under {len(FAULT_PLAN['rules'])} "
        f"rules in {f_wall:.3f} s: {len(trace) - typed} served (equal to "
        f"the fault-free values), {typed} typed errors; "
        + ", ".join(f"{p} calls {snap['calls'][p]} fired "
                    f"{snap['fired'].get(p, 0)}" for p in sorted(
                        snap["calls"])))
    if snap["never_fired"]:
        fail(f"plan points that never fired: {snap['never_fired']}")

    # -- (d) a fatal fault on the card ------------------------------------------
    degraded0 = eng.metrics.counter("faults.delivery_degraded").value
    eng.fault_injector = FaultInjector.from_json({"rules": [
        {"point": "execute", "trigger": "always", "error": "fatal"}]})
    fatal, _ = replay(frontend(), [("sssp", q) for q in (0, 1, 2, 3)])
    eng.fault_injector = None
    for r in fatal:
        if not isinstance(r, FaultError):
            fail(f"a fatal execute fault was served: {r!r}")
        if not isinstance(r, InjectedFault) and not isinstance(
                r.__cause__, InjectedFault):
            fail(f"a fatal execute fault resolved as {r!r}")
    if eng.metrics.counter("faults.delivery_degraded").value != degraded0:
        fail("a request degraded to the xla twin on the card")
    log(f"  (d) fatal execute fault: 4 of 4 requests resolved typed "
        f"({type(fatal[0]).__name__} from "
        f"{type(fatal[0].__cause__ or fatal[0]).__name__}), 0 degrades")
    del fe, compiled, eng
    torch.cuda.empty_cache()

    # -- (e) the launcher ----------------------------------------------------------
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_hypergraph",
         "--regime", "dblp", "--scale", "1.0", "--requests", "200",
         "--verify", "8"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    for line in proc.stdout.splitlines():
        log(f"    | {line}")
    if proc.returncode != 0 or "verified 8" not in proc.stdout:
        fail(f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"  (e) launcher verified 8 of 8 in {time.perf_counter() - t0:.1f} s")
    return {"phase12_serve_launches": launches,
            "phase12_serve_flushes": flushes,
            "phase12_launches_per_flush": launches / flushes,
            "phase12_requests_per_s": qps,
            "phase12_resume_launches": pr_launches,
            "phase12_checkpoint_save_s": pr_save,
            "phase12_checkpoint_restore_s": pr_restore}


POOL_REPLICAS = 2          # phase 13: replica processes on the one card
POOL_HEARTBEAT_MS = 2000.0  # the launcher's default heartbeat timeout
POOL_BOOT_TIMEOUT_S = 300  # no boot may take longer
HANG_REQUESTS = 48         # phase 13 (d): the head of the trace
# Seeded so that the first instance hangs at its 6th request and the
# second at none of its first 120 (prob draws per instance: seed +
# 1009 x spawn order); (e)'s crashes the first at its 21st request and
# the second at none of its first 250.
HANG_PLAN = {"rules": [{"point": "replica.hang", "trigger": "prob",
                        "p": 0.05, "seed": 1559}]}
CRASH_PLAN = {"rules": [{"point": "replica.crash", "trigger": "prob",
                         "p": 0.02, "seed": 83}]}
LAUNCH_POOL_SCALE = 1.0    # phase 13 (e): the launcher's --scale


def smi_memory():
    """``{pid: MiB}`` of the card's compute processes (``nvidia-smi``)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True)
    out = {}
    for line in proc.stdout.splitlines():
        pid, used = (x.strip() for x in line.split(","))
        if pid.isdigit() and used.isdigit():
            out[int(pid)] = int(used)
    return out


def start_pool(store, plan=None):
    """A ``Router`` over ``POOL_REPLICAS`` replica processes on the card,
    each armed with ``plan``; returns it, every handle it spawns (a
    list that grows with respawns) and the reasons of its deaths."""
    import dataclasses
    import itertools

    import torch

    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import ProcessReplica, ReplicaConfig, Router

    total = torch.cuda.get_device_properties(0).total_memory
    cfg = ReplicaConfig(
        builder="repro_torch.launch.serve_hypergraph:build_paths",
        kwargs={"regime": "dblp", "scale": 1.0, "seed": 0,
                "iters": SERVE_ITERS},
        cache_dir=store, max_batch=SERVE_MAX_BATCH, max_delay_ms=5.0,
        fault_plan=json.dumps(plan) if plan else None,
        require_no_retrace=True, device="cuda",
        exec_cache_bytes=total // 4 // POOL_REPLICAS)
    spawned, order = [], itertools.count()

    def factory(index):
        spawned.append(ProcessReplica(index, dataclasses.replace(
            cfg, seed_offset=1009 * next(order))))
        return spawned[-1]

    router = Router(factory, POOL_REPLICAS,
                    heartbeat_timeout_ms=POOL_HEARTBEAT_MS,
                    max_in_flight=2 * SERVE_MAX_BATCH,
                    registry=MetricsRegistry())
    deaths = []
    mark_dead = router._mark_dead

    def noted(slot, now, why, resolutions):
        deaths.append((slot.index, why))
        return mark_dead(slot, now, why, resolutions)

    router._mark_dead = noted
    return router.start(), spawned, deaths


def close_pool(router, spawned):
    router.close()
    for handle in spawned:
        handle.stop(force=True)


def wait_ready(router, slots, t0, timeout=POOL_BOOT_TIMEOUT_S):
    """Seconds from ``t0`` until each of ``slots`` answered ``ready``;
    fails on a boot error, a death while waiting, or the timeout."""
    seen = {}
    deadline = time.monotonic() + timeout
    deaths = router.stats()["deaths"]
    while len(seen) < len(slots):
        st = router.stats()
        for p in st["per_replica"]:
            if p["index"] in slots and p["state"] == "ready":
                seen.setdefault(p["index"], time.perf_counter() - t0)
        fatal = [s.fatal for s in router.slots if s.fatal]
        if fatal or st["deaths"] > deaths:
            fail(f"a replica failed to boot: {fatal or st['per_replica']}")
        if time.monotonic() > deadline:
            fail(f"replicas {sorted(set(slots) - set(seen))} not ready "
                 f"in {timeout} s")
        time.sleep(0.02)
    return [seen[i] for i in slots]


def pool_replay(router, trace, on_submitted=None,
                timeout=FUTURE_TIMEOUT_S):
    """Submit the whole trace to the router, call ``on_submitted``, then
    wait for each future (with a timeout: a hang fails the phase).
    Returns the outcomes (a ``ServedResult`` or the typed error) and the
    wall seconds."""
    import concurrent.futures

    from repro_torch.faults import FaultError

    t0 = time.perf_counter()
    futs = [router.submit(key, query=q) for key, q in trace]
    if on_submitted is not None:
        on_submitted()
    out = []
    for (key, q), f in zip(trace, futs):
        try:
            out.append(f.result(timeout=timeout))
        except concurrent.futures.TimeoutError:
            fail(f"request {key} {q} did not resolve in {timeout} s")
        except FaultError as err:
            out.append(err)
    return out, time.perf_counter() - t0


def check_served(tag, trace, out, oracle, allowed=()):
    """Every outcome is a value that agrees with the sequential run
    (SSSP bitwise, PPR 1e-5 relative) and reached the router as numpy,
    or one of the ``allowed`` typed errors.  Returns the errors."""
    import numpy as np

    from repro_torch.core import tree_leaves
    from repro_torch.launch.serve_hypergraph import agrees

    errors = []
    for (key, q), r in zip(trace, out):
        if isinstance(r, Exception):
            if not isinstance(r, allowed):
                fail(f"{tag}: request {key} {q} resolved as {r!r}")
            errors.append(r)
            continue
        leaves = tree_leaves(r.value)
        if not all(isinstance(x, np.ndarray) for x in leaves):
            fail(f"{tag}: {key} {q} reached the router as "
                 f"{[type(x).__name__ for x in leaves]}, not numpy")
        if not agrees(key, r.value, oracle[(key, q)]):
            fail(f"{tag}: served {key} {q} != the sequential compiled run")
    return errors


def check_drained(tag, router):
    st = router.stats()
    if st["in_flight"] or st["pending"]:
        fail(f"{tag}: ROUTER LEAK: in_flight={st['in_flight']} "
             f"pending={st['pending']} after drain")
    return st


def pool_phase(hg, single_qps):
    """Phase 13: the replica pool on one card, DBLP at full scale (see
    the module docstring).  Returns K1's phase-13 keys."""
    import tempfile

    import torch

    from repro_torch.algorithms import random_walk_spec, shortest_paths_spec
    from repro_torch.analysis import retrace_smoke
    from repro_torch.core import Engine
    from repro_torch.faults import FrontendClosed, ReplicaLost
    from repro_torch.launch.serve_hypergraph import batch_buckets, make_trace
    from repro_torch.serve import MAX_FAILOVERS, DiskExecutableCache, warm

    dev = hg.dst.device
    specs = {"sssp": shortest_paths_spec(hg, source=0,
                                         max_iters=SERVE_ITERS),
             "ppr": random_walk_spec(hg, iters=SERVE_ITERS)}
    store_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    store = store_dir.name
    # -- (a) the store --------------------------------------------------------
    t0 = time.perf_counter()
    parent = Engine(device=dev,
                    disk_cache=DiskExecutableCache(store, device=dev))
    report = warm(parent, list(specs.values()),
                  batch_sizes=batch_buckets(SERVE_MAX_BATCH), queries=[0, 0])
    disk = parent.disk_cache.stats()
    if report["compiled"] != 6 or disk["disk_stores"] != 6:
        fail(f"the parent's warm recorded {disk['disk_stores']} of 6")
    findings = retrace_smoke(device=dev)
    if findings:
        fail("retrace_smoke: " + "; ".join(f.format() for f in findings))
    compiled = {key: parent.compile(spec) for key, spec in specs.items()}
    _, trace = make_trace(hg.n_vertices, SERVE_REQUESTS, SERVE_MIX, 0)
    t1 = time.perf_counter()
    oracle = {}
    for key, q in trace:
        if (key, q) not in oracle:
            oracle[(key, q)] = compiled[key].run(query=q).value
    torch.cuda.synchronize()
    log(f"  (a) the parent warmed {report['traces']} captures in "
        f"{report['boot_s']:.2f} s and wrote {disk['disk_stores']} records "
        f"({disk['dir']}); retrace_smoke on the card: no findings; "
        f"{len(oracle)} sequential compiled runs (the oracle) in "
        f"{time.perf_counter() - t1:.2f} s; (a) "
        f"{time.perf_counter() - t0:.1f} s")

    # -- (b) the pool ---------------------------------------------------------
    t0 = time.perf_counter()
    router, spawned, deaths = start_pool(store)
    try:
        boots = wait_ready(router, list(range(POOL_REPLICAS)), t0)
        smi = smi_memory()
        per = router.stats()["per_replica"]
        for p, ready_s in zip(per, boots):
            b = p["boot"]
            if b["from_disk"] != 6 or b["compiled"] != 0:
                fail(f"replica {p['index']} booted {b['from_disk']} of 6 "
                     "paths from records")
            log(f"  (b) replica {p['index']} (pid {b['pid']}): ready "
                f"{ready_s:.2f} s after spawn (warm {b['boot_s']:.2f} s), "
                f"{b['warm_records']} records read, {b['traces']} captures "
                f"at boot, {b['memory_reserved'] / 2**20:.0f} MiB reserved "
                f"by torch")
        log(f"    nvidia-smi compute apps, MiB by pid (the host's pids: one "
            f"line may hold every process of this container): {smi}")
        out, wall = pool_replay(router, trace)
        check_served("(b)", trace, out, oracle)
        qps = len(trace) / wall
        time.sleep(0.3)                               # a fresh heartbeat
        per = router.stats()["per_replica"]
        per_flush = []
        for p in per:
            hb, b = p["replica_counts"], p["boot"]
            if hb["traces"] != b["engine_traces"]:
                fail(f"replica {p['index']} captured after warm "
                     f"({b['engine_traces']} -> {hb['traces']})")
            launched = (hb["kernel_launches"]["deliver_fused"]
                        - b["kernel_launches"]["deliver_fused"])
            per_flush.append(launched / max(hb["flushes"], 1))
            log(f"    replica {p['index']}: served {p['served']}, "
                f"{hb['flushes']} flushes, {launched} K1 launches "
                f"({per_flush[-1]:.1f} a flush), no capture after warm")
        log(f"  (b) {len(trace)} requests through {POOL_REPLICAS} replicas "
            f"in {wall:.3f} s: {qps:.1f} requests/s aggregate, against "
            f"{single_qps:.1f} for phase 12's single-process Frontend; "
            f"every value agrees with the sequential runs; (b) "
            f"{time.perf_counter() - t0:.1f} s")

        # -- (c) kill -9 mid-replay ---------------------------------------------
        t0 = time.perf_counter()
        victim = router.slots[0].handle
        served0 = router.stats()["per_replica"][0]["served"]
        killed = []

        def kill():
            deadline = time.monotonic() + 30
            while (router.stats()["per_replica"][0]["served"] < served0 + 16
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            os.kill(victim.pid, 9)
            killed.append(time.perf_counter())

        out, wall = pool_replay(router, trace, on_submitted=kill)
        lost = check_served("(c)", trace, out, oracle,
                            (ReplicaLost, FrontendClosed))
        if len(lost) > MAX_FAILOVERS:
            fail(f"(c) {len(lost)} requests lost, more than "
                 f"MAX_FAILOVERS = {MAX_FAILOVERS}")
        st = check_drained("(c)", router)
        if st["deaths"] < 1 or st["respawns"] < 1:
            fail(f"(c) deaths {st['deaths']}, respawns {st['respawns']}")
        respawn_s = wait_ready(router, [0], killed[0])[0]
        reborn = router.stats()["per_replica"][0]["boot"]
        if reborn["pid"] == victim.pid or reborn["warm_records"] <= 0 \
                or reborn["from_disk"] != 6:
            fail(f"(c) the respawn did not boot from the records: {reborn}")
        if victim.process.exitcode != -9:
            fail(f"(c) the victim exited {victim.process.exitcode}")
        log(f"  (c) kill -9 of replica 0 (pid {victim.pid}) mid-replay: "
            f"{len(trace) - len(lost)} served (equal to the sequential "
            f"runs), {len(lost)} typed; deaths {st['deaths']} "
            f"({deaths}), respawns {st['respawns']}, failovers "
            f"{st['failovers']}, in_flight = pending = 0; the respawn "
            f"(pid {reborn['pid']}) was ready {respawn_s:.2f} s after the "
            f"kill (warm {reborn['boot_s']:.2f} s), "
            f"{reborn['warm_records']} records read, sentinel armed; (c) "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        close_pool(router, spawned)

    # -- (d) a hang ---------------------------------------------------------------
    t0 = time.perf_counter()
    router, spawned, deaths = start_pool(store, HANG_PLAN)
    try:
        wait_ready(router, list(range(POOL_REPLICAS)), t0)
        hang_trace = trace[:HANG_REQUESTS]
        out, wall = pool_replay(router, hang_trace)
        lost = check_served("(d)", hang_trace, out, oracle,
                            (ReplicaLost, FrontendClosed))
        st = check_drained("(d)", router)
        hung = spawned[0]
        if (hung.faults or {}).get("fired", {}).get("replica.hang") != 1:
            fail(f"(d) replica.hang did not fire in replica 0: {hung.faults}")
        if (0, "missed heartbeats") not in deaths:
            fail(f"(d) the hung replica's death: {deaths}")
        log(f"  (d) replica.hang in replica 0: declared dead by the "
            f"heartbeat detector ({deaths}); {len(hang_trace) - len(lost)} "
            f"of {len(hang_trace)} served (equal to the sequential runs), "
            f"{len(lost)} typed, failovers {st['failovers']}, in {wall:.2f} "
            f"s; (d) {time.perf_counter() - t0:.1f} s")
    finally:
        close_pool(router, spawned)
    del parent, compiled, oracle
    torch.cuda.empty_cache()
    store_dir.cleanup()

    # -- (e) the launcher -----------------------------------------------------------
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_hypergraph",
             "--regime", "dblp", "--scale", str(LAUNCH_POOL_SCALE),
             "--replicas", str(POOL_REPLICAS), "--cache-dir", tmp,
             "--warm", "--verify", "8", "--log-every-s", "1000",
             "--fault-plan", json.dumps(CRASH_PLAN)],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    for line in proc.stdout.splitlines():
        log(f"    | {line}")
    if proc.returncode != 0 or "verified 8" not in proc.stdout \
            or "never fired: none" not in proc.stdout:
        fail(f"the pool launcher exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    log(f"  (e) the launcher's pool under replica.crash verified 8 of 8 in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"phase13_pool_requests_per_s": qps,
            "phase13_single_requests_per_s": single_qps,
            "phase13_launches_per_flush": per_flush,
            "phase13_boot_s": boots,
            "phase13_respawn_boot_s": respawn_s}


DIST_SOURCES = (0, 17, 4242, 99999, 424242, 500000, 777777, 899392)
DIST_TURNS = 3          # phase 14's walls: median of 3, in turns


def _k1_counted(run):
    """``run()`` with K1's launch counter zeroed just before and read
    just after: ``(result, launches)``."""
    from repro_torch.kernels.deliver.fused import deliver_fused_cuda

    deliver_fused_cuda.launches = 0
    res = run()
    return res, deliver_fused_cuda.launches


def distributed_phase(hg, fwd, local3, hg_a, census, flush):
    """Phase 14: the distributed backends on one card (world size 1, an
    NCCL group: NCCL takes one rank per device).  ``local3``: phase 3's
    ``(label, spec, local fused Result)``; ``fwd``: DBLP's whole-graph
    v->he layout; ``census``: phase 6's local Apache census.  Returns
    K1's and the isect kernels' ``dist_*`` keys."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.algorithms import shortest_paths_spec
    from repro_torch.core import AnalyticsSpec, Engine
    from repro_torch.core.distributed import build_shard_delivery
    from repro_torch.kernels.deliver import (
        deliver_leaf_cuda,
        deliver_leaf_plain,
    )
    from repro_torch.kernels.isect import isect_cuda, isect_fused_cuda
    from repro_torch.launch.mesh import init_local_group, make_host_mesh
    from repro_torch.partition import partition

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    dev = hg.device
    store = tempfile.mkdtemp(prefix="chip-smoke-group-")
    init_local_group(0, 1, store, "cuda")
    k1, k3 = {}, {}
    try:
        mesh = make_host_mesh(1)
        log(f"  {dist.get_backend()} group of world size 1 on "
            f"{torch.cuda.get_device_name(0)}, {mesh}")
        # (a) Engine.run under both backends against phase 3's local runs.
        plan = partition("random_vertex_cut", hg, 1)
        eng = Engine(plan=plan, mesh=mesh, device=dev,
                     delivery="pallas_fused", collect_stats=True)
        local = Engine(device=dev, delivery="pallas_fused",
                       collect_stats=True)
        launches, walls = {}, {}
        for label, spec, ref in local3:
            n_fwd, n_bwd = leaf_counts(spec)
            for backend in ("replicated", "sharded"):
                eng.run(spec, backend=backend)  # the shard layouts, built
                res, n = _k1_counted(lambda: eng.run(spec, backend=backend))
                pairs = res.decision["measured"]["pairs_run"]
                if res.backend != backend or res.partition != plan.name:
                    fail(f"phase 14 {label}: ran {res.backend} / "
                         f"{res.partition}")
                if n == 0 or n != pairs * (n_fwd + n_bwd):
                    fail(f"phase 14 {label} {backend}: {n} K1 launches "
                         f"over {pairs} pairs, expected one per leaf")
                if label == "pagerank-30":
                    err = max(rel_err(a, b)
                              for a, b in zip(res.value, ref.value))
                    if not err <= 1e-5:
                        fail(f"phase 14 {label} {backend}: relative error "
                             f"{err} against the local run")
                elif not all(same_bits(a, b)
                             for a, b in zip(res.value, ref.value)):
                    fail(f"phase 14 {label} {backend} != the local run")
                if not all(torch.equal(a, b) for a, b in zip(
                        res.superstep_stats, ref.superstep_stats)):
                    fail(f"phase 14 {label} {backend}: activity differs")
                launches[f"{backend}_{label}"] = n
            times = {"local": [], "replicated": [], "sharded": []}
            for _ in range(DIST_TURNS):
                for key in times:
                    kw = {} if key == "local" else {"backend": key}
                    run_eng = local if key == "local" else eng
                    times[key].append(run_eng.run(spec, **kw).decision[
                        "measured"]["wall_s"] * 1e3)
            walls[label] = {k: statistics.median(v)
                            for k, v in times.items()}
            log(f"  (a) {label}: replicated / sharded == local "
                + ("(1e-5 relative)" if label == "pagerank-30"
                   else "(bitwise)")
                + f", equal activity; K1 launches {launches[f'replicated_{label}']}"
                f" / {launches[f'sharded_{label}']} ({n_fwd + n_bwd} a "
                f"pair); wall {walls[label]['replicated']:.2f} / "
                f"{walls[label]['sharded']:.2f} ms vs local "
                f"{walls[label]['local']:.2f} ms (median of {DIST_TURNS}, "
                "in turns)")
        k1.update(dist_launches=launches, dist_wall_ms=walls)
        log(f"  {at()} (a) done")

        # (b) K1 on the four shard layouts of a P = 4 plan, one process.
        plan4 = partition("random_vertex_cut", hg, 4)
        nv, ne = hg.n_vertices, hg.n_hyperedges
        nv_pad, ne_pad = -(-nv // 4) * 4, -(-ne // 4) * 4
        t0 = time.perf_counter()
        shards = build_shard_delivery(plan4.shard_src, plan4.shard_dst,
                                      plan4.shard_mask, nv_pad, ne_pad,
                                      device=dev)
        t_build = time.perf_counter() - t0
        rng = np.random.default_rng(14)
        msgs = torch.as_tensor(rng.standard_normal((nv_pad, 1)).astype(
            np.float32), device=dev)
        ints = torch.as_tensor(rng.integers(-2**20, 2**20, (nv_pad, 1))
                               .astype(np.int32), device=dev)
        whole_sum = deliver_leaf_cuda(msgs[:nv], None, fwd, "sum")
        whole_min = deliver_leaf_cuda(ints[:nv], None, fwd, "min")
        tot_sum = tot_min = None
        shard_ms, shard_bound, max_err = [], [], 0.0
        for p, (lay, _) in enumerate(shards):
            k_sum = deliver_leaf_cuda(msgs, None, lay, "sum")
            want = deliver_leaf_plain(msgs.double(), None, lay, "sum")
            max_err = max(max_err, (k_sum.double() - want).abs().max().item())
            if not torch.allclose(k_sum.double(), want, rtol=1e-5, atol=1e-5):
                fail(f"phase 14: K1 sum on shard {p} != plain")
            k_min = deliver_leaf_cuda(ints, None, lay, "min")
            if not torch.equal(k_min, deliver_leaf_plain(ints, None, lay,
                                                         "min")):
                fail(f"phase 14: K1 min on shard {p} != plain")
            tot_sum = k_sum if tot_sum is None else tot_sum + k_sum
            tot_min = k_min if tot_min is None else torch.minimum(tot_min,
                                                                  k_min)
            shard_ms.append(time_cuda(
                lambda: deliver_leaf_cuda(msgs, None, lay, "sum"), flush))
            shard_bound.append(leaf_bound_ms(lay, 1)[0])
        if not torch.equal(tot_min[:ne], whole_min):
            fail("phase 14: the shards' K1 min, combined, != the local "
                 "delivery")
        if not torch.allclose(tot_sum[:ne], whole_sum, rtol=1e-5, atol=1e-5):
            fail("phase 14: the shards' K1 sum, combined, != the local "
                 "delivery")
        whole_ms = time_cuda(
            lambda: deliver_leaf_cuda(msgs[:nv], None, fwd, "sum"), flush)
        log(f"  (b) K1 on random_vertex_cut's 4 shard layouts (built in "
            f"{t_build:.1f} s; v->he, D = 1): min bitwise and sum within "
            f"{max_err:.3g} of float64 on each; combined == the local "
            f"delivery (min bitwise, sum 1e-5); leaf ms per shard "
            + ", ".join(f"{t:.4f} (bound {b:.4f})"
                        for t, b in zip(shard_ms, shard_bound))
            + f" vs whole graph {whole_ms:.4f} (bound "
            f"{leaf_bound_ms(fwd, 1)[0]:.4f}); L2 flushed, median of "
            f"{N_TIMED}")
        k1.update(dist_shard_leaf_ms=shard_ms,
                  dist_shard_leaf_bound_ms=shard_bound,
                  dist_whole_leaf_ms=whole_ms, dist_shard_max_abs_err=max_err)
        del shards
        log(f"  {at()} (b) done")

        # (c) the sharded census on phase 6's Apache hypergraph.
        isect_cuda.launches = 0
        isect_fused_cuda.launches = 0
        res = Engine(mesh=mesh, device=dev).analyze(AnalyticsSpec(hg_a))
        k3 = {"isect": isect_cuda.launches,
              "isect_fused": isect_fused_cuda.launches}
        why = res.decision["backend"]["reason"]
        if res.backend != "sharded" or why != (
                "mesh available: tile hyperedge-pair blocks across it"):
            fail(f"phase 14 analyze resolved {res.backend} ({why})")
        fields = ("counts", "ci_low", "ci_high", "n_triples_seen", "n_pairs")
        if not same_census(res.value, census, fields):
            fail("phase 14: the sharded census != phase 6's local census")
        if 0 in k3.values():
            fail(f"phase 14: the sharded census launched {k3}")
        m = res.decision["measured"]
        log(f"  (c) sharded census on apache == phase 6's, field for field; "
            f"K3a {k3['isect']}, K3b {k3['isect_fused']} launches; "
            f"analyze {m['wall_s']:.1f} s (intersect {m['intersect_s']:.3f} "
            "s)")
        log(f"  {at()} (c) done")

        # (d) compile-once serving on both backends.
        label, pr, pr_ref = local3[0]
        sp = local3[1][1]
        graphs, qps = {}, {}
        for backend in ("replicated", "sharded"):
            comp = eng.compile(pr, backend=backend)
            comp.run()
            got, n = _k1_counted(comp.run)
            one = eng.run(pr, backend=backend)
            err = max(rel_err(a, b) for a, b in zip(got.value, one.value))
            if not err <= 1e-5 or n == 0:
                fail(f"phase 14 compiled {label} {backend}: relative error "
                     f"{err}, {n} K1 launches")
            comp_s = eng.compile(sp, backend=backend)
            comp_s.run_batch(np.asarray(DIST_SOURCES))
            t0 = time.perf_counter()
            batch = comp_s.run_batch(np.asarray(DIST_SOURCES))
            torch.cuda.synchronize()
            qps[backend] = len(DIST_SOURCES) / (time.perf_counter() - t0)
            for i, q in enumerate(DIST_SOURCES):
                want = eng.run(shortest_paths_spec(hg, q), backend=backend)
                if not all(same_bits(a[i], b)
                           for a, b in zip(batch.value, want.value)):
                    fail(f"phase 14 run_batch {backend} source {q} != "
                         "Engine.run")
            graphs[backend] = (got.decision["measured"]["graph"],
                               batch.decision["measured"]["graph"])
            if not all(graphs[backend]):
                fail(f"phase 14: no CUDA graph captured on {backend}")
            log(f"  (d) compiled {label} {backend} == Engine.run (1e-5 "
                f"relative; {n} K1 launches replayed); run_batch of "
                f"{len(DIST_SOURCES)} SSSP sources == Engine.run (bitwise), "
                f"{qps[backend]:.1f} queries/s warm; CUDA graph captured "
                "with its collectives")
        k1.update(dist_compiled_graph=graphs, dist_batch_qps=qps)
    finally:
        dist.destroy_process_group()
    log(f"  {at()} phase 14 done")
    return k1, k3


# Phase 16: the LM serving path at llama3.2-1b's full width.
LM_ARCH = "llama3.2-1b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 4096, 16   # (b): the launcher's run
LM_LONG = 32768        # (d): prefill_32k's sequence; its batch 32 cut to 1
LM_F32_PROMPT = 32     # (c): decode against prefill in float32
LM_SMOKE_BATCH, LM_SMOKE_PROMPT = 4, 128    # (e): 512 tokens, grouped MoE
# (c) the prefill's last logits, K4 route against the plain route, bf16,
# as a share of the plain logits' largest magnitude.  Each bf16 route
# sits about 2e-2 from the float32 prefill on these random weights (the
# plain route 0.0199, K4 0.0220 on an H100; PERF.md §6): bf16 through 16
# layers, not the kernel.  Two routes that far from one answer may
# differ by their sum (~4e-2), so the limit is 5e-2, and K4 is also held
# to at most twice the plain route's distance from float32.
LM_ROUTE_TOL = 5e-2
LM_DECODE_TOL = 2e-4   # tests/test_models_lm.py::test_prefill_matches_decode
# (e) float32, K4 route against the plain route, of the largest magnitude:
# K4's float32 kernel is within phase 8's 2e-5 of its plain version.
LM_SMOKE_F32_TOL = 1e-4
# (a) K4's GQA form at the model's attention shapes: (dtype, S).
GQA_CASES = (("bfloat16", 4096), ("float32", 4096), ("bfloat16", 4000),
             ("float32", 4000))


def gqa_bound(dtype, b, h, kvh, s, d, sms, clock):
    """(bytes s, operations s) of one causal GQA call: q and out with H
    heads, k and v with KvH, once each (``roofline.analysis.flash_work``);
    the operations as phase 8's."""
    import torch

    from repro_torch.roofline.analysis import flash_work

    size = torch.tensor([], dtype=dtype).element_size()
    _, ops_s = flash_bound(dtype, True, b, h, s, d, sms, clock)
    _, nbytes = flash_work(b, h, kvh, s, s, d, size, True)
    return nbytes / HBM_BYTES_PER_S, ops_s


def plain_route(q, k, v, causal=True):
    """The attention route's plain version: ``flash_plain`` in whole
    4,096-row blocks (the smoke swaps it in for the kernel in (c), (e))."""
    from repro_torch.kernels.flash import flash_plain

    return flash_plain(q, k, v, causal=causal, block_q=4096, block_k=4096)


def with_plain_route(fn):
    """``fn()`` with ``models.attention``'s K4 route on the plain version
    (a hook of this script; the program has no switch)."""
    from repro_torch.models import attention

    kernel = attention.flash_attention
    attention.flash_attention = plain_route
    try:
        return fn()
    finally:
        attention.flash_attention = kernel


def profiled(call, n):
    """(wall ms, busy device ms, kernels a call, [(kernel, device ms)])
    of ``call`` over ``n`` calls under ``torch.profiler`` (CUDA rows
    only: a host op's row repeats its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = [(ev.key, ev.self_device_time_total / 1e3 / n, ev.count / n)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return (wall, sum(r[1] for r in rows), sum(r[2] for r in rows),
            [(k, ms) for k, ms, _ in rows])


def gqa_checks(dev, flush, sms, clock):
    """Phase 16 (a): K4 with K/V of fewer heads against ``flash_plain``
    at llama3.2-1b's shapes, with two planted mapping faults, and the
    timings at the prefill's shape.  Returns the ``lm_*`` timing keys
    and the max abs error."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import flash_cuda

    b, h, kvh, d = LM_BATCH, 32, 8, 64
    rep = h // kvh
    gen = torch.Generator(device=dev).manual_seed(16)
    keys, max_err = {}, 0.0
    for dtype_name, s in GQA_CASES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(b, kvh, s, d, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        got = flash_cuda(q, k, v, causal=True)
        want = plain_route(q, k, v)
        label = f"K4 GQA {dtype_name} B={b} H={h} KvH={kvh} S={s} D={d}"
        rtol, atol = FLASH_TOL[dtype_name]
        bound = FLASH_ROW_REL[dtype_name]
        err = check_close(label, got, want, rtol, atol)
        rel = row_rel_err(got, want)
        if rel > bound or not torch.isfinite(got).all():
            fail(f"{label}: row-relative error {rel:.3g} over {bound}")
        max_err = max(max_err, err)
        # Planted: the heads' KV mapped as h % KvH (tiled, not grouped),
        # and KV head group 1 zeroed; only a wrong KV-head index shows so.
        kz, vz = k.clone(), v.clone()
        kz[:, 1] = 0
        vz[:, 1] = 0
        faults = [row_rel_err(plain_route(q, k.repeat(1, rep, 1, 1),
                                          v.repeat(1, rep, 1, 1)), want),
                  row_rel_err(plain_route(q, kz, vz), want)]
        if min(faults) <= bound:
            fail(f"{label}: a planted mapping fault reads {min(faults):.3g}"
                 f", within the limit {bound}")
        log(f"  (a) {label}: == plain within rtol {rtol} atol {atol} (max "
            f"abs err {err:.3g}); row-relative {rel:.3g} of {bound} "
            f"(planted tiled KV mapping {faults[0]:.3g}, KV group 1 "
            f"zeroed {faults[1]:.3g})")
        del kz, vz, want
        if s != LM_PROMPT:
            continue
        reps = dict(n_timed=5, n_warm=1)
        k_ms = time_cuda(lambda: flash_cuda(q, k, v, causal=True), flush,
                         **reps)
        p_ms = time_cuda(lambda: plain_route(q, k, v), flush, n_timed=3,
                         n_warm=1)
        try:
            l_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), flush, **reps)
            lib = "sdpa enable_gqa"
        except TypeError:
            kx, vx = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
            l_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, kx, vx, is_causal=True), flush, **reps)
            lib = "sdpa on expanded K/V"
        # The model's layout [B, S, H, hd] and its copies into K4's.
        qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def transposes():
            tq, tk, tv = (x.transpose(1, 2).contiguous()
                          for x in (qm, km, vm))
            return tq.transpose(1, 2).reshape(b, s, h * d)

        t_ms = time_cuda(transposes, flush, **reps)
        b_s, o_s = gqa_bound(dtype, b, h, kvh, s, d, sms, clock)
        bound_ms = max(b_s, o_s) * 1e3
        tflops = 4 * d * flash_pairs(True, b, h, s) / (k_ms * 1e-3) / 1e12
        log(f"  (a) timed {dtype_name} at the prefill's shape: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, {lib} {l_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({'bytes' if b_s >= o_s else 'operations'}"
            f"); {bound_ms / k_ms:.1%} of the bound, {tflops:.1f} TFLOP/s; "
            f"the layout copies q, k, v in and out back {t_ms:.4f} ms")
        if dtype == torch.bfloat16:
            keys.update(lm_ms=k_ms, lm_plain_ms=p_ms, lm_library_ms=l_ms,
                        lm_library=lib, lm_bound_ms=bound_ms,
                        lm_bound_by="bytes" if b_s >= o_s else "operations",
                        lm_transpose_ms=t_ms)
        else:
            keys.update(lm_f32_ms=k_ms, lm_f32_library_ms=l_ms,
                        lm_f32_bound_ms=bound_ms)
        del q, k, v, got, qm, km, vm
    return keys, max_err


def lm_arch_ids(arch_ids):
    """The LM family's ids among ``configs.ARCH_IDS`` (which also holds
    the GNN ones)."""
    from repro_torch.configs import get_config

    return [a for a in arch_ids if get_config(a, smoke=True).family == "lm"]


def lm_phase(dev, flush, sms, clock, smi):
    """Phase 16: the LM serving path (``repro_torch.launch.serve``) at
    llama3.2-1b's full width; see the module docstring.  Returns K4's
    ``lm_*`` keys for the kernel line."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.launch import serve
    from repro_torch.models.layers import release_casts
    from repro_torch.models.transformer import (
        forward,
        init_cache,
        param_count,
        prefill,
        serve_step,
    )

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    torch.cuda.reset_peak_memory_stats(dev)
    if torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmuls are not at 'highest' precision (TF32 would "
             "enter the float32 checks)")
    keys, max_err = gqa_checks(dev, flush, sms, clock)
    log(f"  {at()} (a) done")

    # (b) the launcher's path: prefill 4 x 4096, then 15 greedy steps.
    with torch.no_grad():
        cfg, params = serve.build(LM_ARCH, smoke=False, seed=0, device=dev)
        n_params = sum(p.numel() for p in params.parameters())
        if n_params != param_count(cfg):
            fail(f"{n_params} weights, param_count {param_count(cfg)}")
        prompts = serve.make_prompts(cfg, LM_BATCH, LM_PROMPT, device=dev)
        serve.generate(params, cfg, prompts, 2)   # the casts, once
        flash_cuda.launches = 0
        last, cache = prefill(params, cfg, prompts)
        torch.cuda.synchronize()
        per_prefill = flash_cuda.launches
        tok = torch.argmax(last, dim=-1)
        full = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
        for key in full:
            full[key][:, :, :LM_PROMPT].copy_(cache[key])
        flash_cuda.launches = 0
        serve_step(params, cfg, full, tok, LM_PROMPT)
        torch.cuda.synchronize()
        per_step = flash_cuda.launches
        if per_prefill != cfg.n_layers or per_step != 0:
            fail(f"K4 launched {per_prefill} times a prefill (expected "
                 f"{cfg.n_layers}) and {per_step} a decode step (expected 0)")
        flash_cuda.launches = 0
        ids, walls = serve.generate(params, cfg, prompts, LM_GEN)
        torch.cuda.synchronize()
        if flash_cuda.launches != cfg.n_layers:
            fail(f"generate launched K4 {flash_cuda.launches} times")
        if tuple(ids.shape) != (LM_BATCH, LM_GEN) or not bool(
                ((ids >= 0) & (ids < cfg.vocab)).all()):
            fail(f"generated ids of shape {tuple(ids.shape)} out of range")
        if not torch.isfinite(last).all():
            fail("non-finite prefill logits")
        log(f"  {at()} (b) {LM_ARCH} --no-smoke: {n_params:,} weights "
            f"(float32, seed 0), prefill {LM_BATCH} x {LM_PROMPT}, "
            f"{LM_GEN - 1} greedy steps; K4 {per_prefill} launches a "
            f"prefill, {per_step} a decode step; generate's walls: "
            f"prefill {walls['prefill_s'] * 1e3:.1f} ms, decode "
            f"{walls['decode_s'] * 1e3:.1f} ms for {walls['steps']} steps")
        prefill_ms = time_cuda(lambda: prefill(params, cfg, prompts), flush,
                               n_timed=3, n_warm=1)
        step_ms = time_cuda(lambda: serve_step(params, cfg, full, tok,
                                               LM_PROMPT), flush, n_timed=5,
                            n_warm=1)

        def uncached_step():
            release_casts(params)
            serve_step(params, cfg, full, tok, LM_PROMPT)

        cast_ms = time_cuda(uncached_step, flush, n_timed=3, n_warm=1)
        serve_step(params, cfg, full, tok, LM_PROMPT)  # casts kept again
        tokens_s = LM_BATCH * LM_PROMPT / (prefill_ms * 1e-3)
        log(f"  (b) prefill {prefill_ms:.2f} ms ({tokens_s:,.0f} tokens/s); "
            f"decode {step_ms:.3f} ms a step with the bf16 casts kept, "
            f"{cast_ms:.3f} ms casting each weight a call (median of 5 / 3, "
            f"L2 flushed) [{smi}]")
        idle = {}
        for label, call, n in (
                ("prefill", lambda: prefill(params, cfg, prompts), 2),
                ("decode step", lambda: serve_step(params, cfg, full, tok,
                                                   LM_PROMPT), 10)):
            wall, busy, n_k, rows = profiled(call, n)
            idle[label] = 1.0 - busy / wall
            top = "; ".join(f"{k[:48]} {ms:.3f}" for k, ms in rows[:4])
            log(f"  (b) {label} under torch.profiler: wall {wall:.3f} ms, "
                f"card busy {busy:.3f} ms, idle {idle[label]:.1%}, "
                f"{n_k:.0f} kernels a call; top: {top}")
        del full

        # (c) the K4 route against the plain route, then float32 decode
        # against float32 prefill.
        plain_last, _ = with_plain_route(lambda: prefill(params, cfg,
                                                         prompts))
        top = plain_last.float().abs().max()
        route_err = ((last.float() - plain_last.float()).abs().max()
                     / top).item()
        # Each bf16 route's distance from the float32 prefill (K4's
        # float32 kernel, within 2e-5 of its plain version): the scale
        # on which the two bf16 routes may differ.
        cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        ref32, _ = prefill(params, cfg32, prompts)
        top32 = ref32.abs().max()
        k4_32 = ((last.float() - ref32).abs().max() / top32).item()
        plain_32 = ((plain_last.float() - ref32).abs().max() / top32).item()
        if not (route_err <= LM_ROUTE_TOL and k4_32 <= 2 * plain_32):
            fail(f"prefill logits, K4 route vs plain: {route_err:.3g} of the "
                 f"largest magnitude (limit {LM_ROUTE_TOL}); from float32 "
                 f"K4 {k4_32:.3g}, plain {plain_32:.3g}")
        del plain_last, cache, ref32
        toks = prompts[:2, :LM_F32_PROMPT]
        last32, _ = prefill(params, cfg32, toks)
        c32 = init_cache(cfg32, 2, LM_F32_PROMPT, dtype=torch.float32,
                         device=dev)
        for t in range(LM_F32_PROMPT):
            step32, c32 = serve_step(params, cfg32, c32, toks[:, t], t)
        dec_err = (step32 - last32).abs().max().item()
        if not torch.allclose(step32, last32, rtol=LM_DECODE_TOL,
                              atol=LM_DECODE_TOL):
            fail(f"float32 decode vs prefill: max abs err {dec_err:.3g} over "
                 f"rtol = atol = {LM_DECODE_TOL}")
        log(f"  {at()} (c) K4 route == plain route within {route_err:.3g} of "
            f"the logits' largest magnitude (limit {LM_ROUTE_TOL}); from the "
            f"float32 prefill: K4 route {k4_32:.3g}, plain route "
            f"{plain_32:.3g} (K4 within twice the plain's); float32 "
            f"decode == prefill over {LM_F32_PROMPT} tokens, max abs err "
            f"{dec_err:.3g} (limit {LM_DECODE_TOL}; float32 matmul "
            f"precision {torch.get_float32_matmul_precision()})")
        del c32

        # (d) one prefill at prefill_32k's sequence length, batch 1.
        long = serve.make_prompts(cfg, 1, LM_LONG, device=dev)
        flash_cuda.launches = 0
        long_last, _ = prefill(params, cfg, long)
        torch.cuda.synchronize()
        if flash_cuda.launches != cfg.n_layers or not torch.isfinite(
                long_last).all():
            fail(f"32k prefill: {flash_cuda.launches} K4 launches, finite "
                 f"{bool(torch.isfinite(long_last).all())}")
        long_ms = time_cuda(lambda: prefill(params, cfg, long), flush,
                            n_timed=3, n_warm=0)
        log(f"  {at()} (d) prefill 1 x {LM_LONG} (prefill_32k's length; its "
            f"batch of 32 cut to 1 for the phase's time): {long_ms:.1f} ms, "
            f"{LM_LONG / (long_ms * 1e-3):,.0f} tokens/s, K4 "
            f"{cfg.n_layers} launches")
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        del params, long, long_last, last
        torch.cuda.empty_cache()

        # (e) the five smoke configs on the card, K4 route vs plain route.
        for arch in lm_arch_ids(ARCH_IDS):
            scfg, sparams = serve.build(arch, smoke=True, seed=0, device=dev)
            stoks = serve.make_prompts(scfg, LM_SMOKE_BATCH,
                                       LM_SMOKE_PROMPT, device=dev)
            variants = [("", scfg)]
            if scfg.moe is not None:
                variants.append((" grouped", dataclasses.replace(
                    scfg, moe=dataclasses.replace(scfg.moe, n_groups=4))))
            n_global = sum(not scfg.kind(i)[0] for i in range(scfg.n_layers))
            notes = []
            for tag, vcfg in variants:
                c32 = dataclasses.replace(vcfg, compute_dtype=torch.float32)
                flash_cuda.launches = 0
                k4_logits, _ = forward(sparams, c32, stoks)
                torch.cuda.synchronize()
                if flash_cuda.launches != n_global:
                    fail(f"{arch}{tag}: {flash_cuda.launches} K4 launches, "
                         f"expected {n_global}")
                pl_logits, _ = with_plain_route(
                    lambda: forward(sparams, c32, stoks))
                err = ((k4_logits - pl_logits).abs().max()
                       / pl_logits.abs().max()).item()
                if not err <= LM_SMOKE_F32_TOL:
                    fail(f"{arch}{tag} float32 K4 vs plain route: {err:.3g}")
                k4_last, _ = prefill(sparams, vcfg, stoks)
                pl_last, _ = with_plain_route(
                    lambda: prefill(sparams, vcfg, stoks))
                bf_err = ((k4_last.float() - pl_last.float()).abs().max()
                          / pl_last.float().abs().max()).item()
                if scfg.moe is None and not bf_err <= LM_ROUTE_TOL:
                    fail(f"{arch} bf16 prefill K4 vs plain route: "
                         f"{bf_err:.3g}")
                ids, _ = serve.generate(sparams, vcfg, stoks, 4)
                if not (torch.isfinite(k4_last).all() and bool(
                        ((ids >= 0) & (ids < vcfg.vocab)).all())):
                    fail(f"{arch}{tag}: non-finite logits or ids out of range")
                notes.append(f"{tag.strip() or 'global' if scfg.moe else 'dense'}"
                             f" f32 {err:.2g}, bf16 {bf_err:.2g}")
            log(f"  (e) {arch} smoke on the card: K4 {n_global} launches a "
                f"forward; route vs plain " + "; ".join(notes))
            del sparams
    log(f"  {at()} phase 16 done; peak memory {peak:.0f} MiB [{smi}]")
    keys.update(lm_launches_prefill=per_prefill, lm_launches_decode=per_step,
                lm_max_abs_err=max_err, lm_prefill_ms=prefill_ms,
                lm_prefill_tokens_per_s=tokens_s, lm_decode_ms=step_ms,
                lm_decode_cast_each_call_ms=cast_ms,
                lm_prefill_32k_ms=long_ms, lm_route_rel_err=route_err,
                lm_route_f32_rel_err=k4_32, lm_plain_f32_rel_err=plain_32,
                lm_f32_decode_abs_err=dec_err, lm_peak_mib=peak,
                lm_prefill_idle_share=idle["prefill"],
                lm_decode_idle_share=idle["decode step"])
    return keys


# Phase 17: the LM training path at llama3.2-1b's full width.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 8, 4096, 2   # train_4k, batch 256 cut
TRAIN_STEPS = 3
TRAIN_FWD_PER_STEP = 64   # 16 layers x (forward + remat) x 2 micro-batches
TRAIN_BWD_PER_STEP = 32   # 16 layers x 2 micro-batches
TRAIN_LOSS_RISE = 0.5     # tests/test_models_lm.py: loss 3 < loss 1 + 0.5
SMOKE_BATCH, SMOKE_SEQ, SMOKE_STEPS = 4, 64, 2    # (d)
BWD_FULL = (4, 32, 8, 4096, 64)   # (c): B, H, KvH, S, D of the model
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of each tensor's max
BWD_MAX_MS = 10.0  # (c) at BWD_FULL: 5x under the FMA tiles' 49.1 ms
# (c) K4's row lse against flash_plain's: |err| <= tol (1 + |plain|), the
# card test test_cuda_flash_lse_equals_plain's rtol = atol.
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# (c) smaller shapes: (dtype, B, H, KvH, S, D), D 8 / 36 / 64 / 128 / 256
# and S ragged against the 64-, 128- and 32-row tiles; bfloat16 D 8, 64
# and 128 take the tensor-core route, D 36 and 256 the FMA one; float32 D
# 8 and 64 the three-pass TF32 route, D 128 and 256 the FMA one.
BWD_CASES = (("float32", 2, 8, 2, 333, 8), ("float32", 1, 4, 4, 257, 128),
             ("float32", 1, 4, 1, 130, 256), ("float32", 2, 8, 2, 1000, 64),
             ("bfloat16", 2, 8, 2, 333, 8), ("bfloat16", 1, 4, 4, 257, 128),
             ("bfloat16", 1, 4, 1, 130, 256), ("bfloat16", 2, 8, 2, 1000, 64),
             ("bfloat16", 1, 32, 8, 390, 128), ("bfloat16", 1, 4, 2, 200, 36))
SMOKE_GRAD_TOL = 1e-4     # (d) K4 route vs plain route, float32 gradients


def plain_versions_raise():
    """A context in which ``flash_plain`` and ``flash_plain_backward``
    raise wherever they are called from (a hook of this script: the
    program has no switch), so that a run shows no plain version ran."""
    import contextlib

    import repro_torch.kernels.flash as pkg
    from repro_torch.kernels.flash import flash

    def refuse(*a, **k):
        raise AssertionError("a plain attention version ran on the card")

    @contextlib.contextmanager
    def ctx():
        saved = {(m, n): getattr(m, n) for m in (flash, pkg)
                 for n in ("flash_plain", "flash_plain_backward")}
        for m, n in saved:
            setattr(m, n, refuse)
        try:
            yield
        finally:
            for (m, n), fn in saved.items():
                setattr(m, n, fn)

    return ctx()


def optimizer_events():
    """A context that wraps ``train.step``'s ``adamw_update`` in CUDA
    events; yields the list of (start, end) pairs it records."""
    import contextlib

    import torch

    from repro_torch.train import step as step_mod

    @contextlib.contextmanager
    def ctx():
        real, pairs = step_mod.adamw_update, []

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*a, **k)
            end.record()
            pairs.append((start, end))
            return out

        step_mod.adamw_update = timed
        try:
            yield pairs
        finally:
            step_mod.adamw_update = real

    return ctx()


def bwd_bound(dtype, b, h, kvh, s, d, sms, clock, causal=True, route=None):
    """(bytes s, operations s) of one backward call (causal unless
    ``causal=False``): q, o, dO, dQ with H heads and k, v, dK, dV with
    KvH once each, the lse; its operations 2.5 x the forward's 4 D per
    kept pair (five products against the forward's two) over the rate
    of ``route`` (by default ``flash_bwd_plan``'s), or its exps (one a
    pair) over the MUFU's, whichever is larger.  The work is
    ``roofline.analysis.flash_bwd_work``'s."""
    import torch

    from repro_torch.kernels.flash import flash_bwd_plan
    from repro_torch.roofline.analysis import flash_bwd_work

    size = torch.tensor([], dtype=dtype).element_size()
    pairs = flash_pairs(causal, b, h, s)
    flops, nbytes = flash_bwd_work(b, h, kvh, s, s, d, size, causal)
    per_clock = route_rate(route or flash_bwd_plan(d, dtype).kernel)
    flops_s = flops / (per_clock * sms * clock)
    exps_s = pairs / (EX2_PER_CLOCK_PER_SM * sms * clock)
    return nbytes / HBM_BYTES_PER_S, max(flops_s, exps_s)


def bwd_inputs(gen, dev, dtype, b, h, kvh, s, d, causal=True):
    """q, k, v, K4's output and row lse (``causal`` unless told
    otherwise), and a dO, on the card."""
    import torch

    from repro_torch.kernels.flash import flash_cuda

    q = (torch.randn(b, h, s, d, generator=gen, device=dev) * 0.3).to(dtype)
    k = (torch.randn(b, kvh, s, d, generator=gen, device=dev) * 0.3).to(
        dtype)
    v = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(dtype)
    out, lse = flash_cuda(q, k, v, causal=causal, return_lse=True)
    dout = torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)
    return q, k, v, out, lse, dout


def lse_against_plain(label, dtype_name, args, **blocks):
    """K4's row log-sum-exp in ``args`` (from ``bwd_inputs``) against
    ``flash_plain``'s on the same q, k, v, within ``LSE_TOL``.  Returns
    the plain version's ``(out, lse)``, which the plain backward is then
    given, and the largest absolute lse error."""
    import torch

    from repro_torch.kernels.flash import flash_plain

    q, k, v, _, lse, _ = args
    p_out, p_lse = flash_plain(q, k, v, causal=True, return_lse=True,
                               **blocks)
    err = (lse - p_lse).abs()
    tol = LSE_TOL[dtype_name]
    if not torch.isfinite(lse).all() or bool(
            (err > tol * (1 + p_lse.abs())).any()):
        fail(f"{label}: K4's lse differs from flash_plain's by up to "
             f"{err.max().item():.3g}, over {tol} (1 + |lse|)")
    return p_out, p_lse, err.max().item()


def rel_max(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def bwd_checks(dev, flush, sms, clock):
    """Phase 17 (c): K4's backward kernels against
    ``flash_plain_backward``: at llama3.2-1b's attention shape in bf16
    (2e-2 of each tensor's largest magnitude), at smaller shapes in both
    types (float32 1e-4), bitwise over two runs; the time at the model's
    shape beside the bound, the plain version and SDPA's backward with
    ``enable_gqa``.  In every case K4's forward lse is first held against
    ``flash_plain``'s (``LSE_TOL``), and the plain backward takes the
    plain forward's output and lse, so each comparison covers K4's
    forward lse and the backward together.  Returns the ``bwd_*``
    keys."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import (
        flash_backward_cuda,
        flash_bwd_plan,
        flash_plain_backward,
    )

    gen = torch.Generator(device=dev).manual_seed(17)
    notes, lse_errs = [], {"float32": 0.0, "bfloat16": 0.0}
    for dtype_name, b, h, kvh, s, d in BWD_CASES:
        dtype = getattr(torch, dtype_name)
        label = f"K4 backward {dtype_name} B={b} H={h} KvH={kvh} S={s} D={d}"
        args = bwd_inputs(gen, dev, dtype, b, h, kvh, s, d)
        p_out, p_lse, lse_err = lse_against_plain(label, dtype_name, args)
        lse_errs[dtype_name] = max(lse_errs[dtype_name], lse_err)
        got = flash_backward_cuda(*args, causal=True)
        q, k, v, _, _, dout = args
        want = flash_plain_backward(q, k, v, p_out, p_lse, dout, causal=True)
        torch.cuda.synchronize()
        errs = [rel_max(g, w) for g, w in zip(got, want)]
        if max(errs) > BWD_TOL[dtype_name] or not all(
                torch.isfinite(g).all() for g in got):
            fail(f"{label}: dQ, dK, dV {errs} of the largest magnitude over "
                 f"{BWD_TOL[dtype_name]}")
        short = "f32" if dtype == torch.float32 else "bf16"
        route = flash_bwd_plan(d, dtype).kernel
        notes.append(f"{short} D={d} S={s} H:KvH={h}:{kvh} {route} "
                     f"{max(errs):.2g}")
    log(f"  (c) K4 forward lse == plain (float32 within "
        f"{LSE_TOL['float32']} (1 + |lse|), largest error "
        f"{lse_errs['float32']:.3g}; bf16 {LSE_TOL['bfloat16']}, "
        f"{lse_errs['bfloat16']:.3g}); K4 backward == plain backward of "
        f"the plain forward (of each tensor's largest magnitude; float32 "
        f"limit {BWD_TOL['float32']}, bf16 {BWD_TOL['bfloat16']}): "
        + "; ".join(notes))

    b, h, kvh, s, d = BWD_FULL
    dtype = torch.bfloat16
    route = flash_bwd_plan(d, dtype).kernel
    label = f"K4 backward bf16 B={b} H={h} KvH={kvh} S={s} D={d} ({route})"
    blocks = dict(block_q=1024, block_k=1024)
    args = bwd_inputs(gen, dev, dtype, b, h, kvh, s, d)
    p_out, p_lse, full_lse_err = lse_against_plain(label, "bfloat16", args,
                                                   **blocks)
    got = flash_backward_cuda(*args, causal=True)
    again = flash_backward_cuda(*args, causal=True)
    q, k, v, _, _, dout = args
    want = flash_plain_backward(q, k, v, p_out, p_lse, dout, causal=True,
                                **blocks)
    del p_out, p_lse
    torch.cuda.synchronize()
    errs = [rel_max(g, w) for g, w in zip(got, want)]
    if max(errs) > BWD_TOL["bfloat16"]:
        fail(f"{label}: dQ, dK, dV {errs} over {BWD_TOL['bfloat16']}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{label}: two runs differ")
    max_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    del got, again, want
    reps = dict(n_timed=5, n_warm=1)
    k_ms = time_cuda(lambda: flash_backward_cuda(*args, causal=True), flush,
                     **reps)
    p_ms = time_cuda(lambda: flash_plain_backward(*args, causal=True,
                                                  **blocks),
                     flush, n_timed=2, n_warm=1)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    try:
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        lib = "sdpa enable_gqa backward"
    except TypeError:
        ks, vs = (x.detach().repeat_interleave(h // kvh, 1).requires_grad_()
                  for x in (k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib = "sdpa backward on expanded K/V"
    l_ms = time_cuda(lambda: torch.autograd.grad(
        o, (qs, ks, vs), dout, retain_graph=True), flush, **reps)
    if k_ms > BWD_MAX_MS:
        fail(f"{label}: {k_ms:.4f} ms a call, over {BWD_MAX_MS} ms")
    b_s, o_s = bwd_bound(dtype, b, h, kvh, s, d, sms, clock)
    bound_ms = max(b_s, o_s) * 1e3
    by = "bytes" if b_s >= o_s else "operations"
    tflops = 2.5 * 4 * d * flash_pairs(True, b, h, s) / (k_ms * 1e-3) / 1e12
    log(f"  (c) {label}: forward lse == plain within {full_lse_err:.3g} "
        f"(limit {LSE_TOL['bfloat16']} (1 + |lse|)); == plain backward of "
        f"the plain forward within {max(errs):.3g} of the largest "
        f"magnitude (dQ {errs[0]:.3g}, dK {errs[1]:.3g}, dV {errs[2]:.3g}; "
        f"max abs err {max_err:.3g}), two runs bitwise equal; kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, {lib} {l_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by}); {bound_ms / k_ms:.1%} of the bound, "
        f"{tflops:.1f} TFLOP/s (2.5 x the forward's products)")
    del args, qs, ks, vs, o
    return {"bwd_ms": k_ms, "bwd_plain_ms": p_ms, "bwd_library_ms": l_ms,
            "bwd_library": lib, "bwd_bound_ms": bound_ms, "bwd_bound_by": by,
            "bwd_max_abs_err": max_err, "bwd_rel_err": max(errs),
            "bwd_lse_max_abs_err": full_lse_err,
            "bwd_lse_max_abs_err_small": lse_errs, "bwd_route": route}


def smoke_training(dev):
    """Phase 17 (d): each LM ``smoke()`` config takes two steps on the
    card; llama3.2-1b smoke's float32 gradients through the K4 route
    against the plain route; a checkpoint round trip; a run cut at step
    2 of 4 and resumed against the straight run.  Returns notes."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels.flash import flash_backward_cuda, flash_cuda
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train import restore_checkpoint, save_checkpoint
    from repro_torch.train.tree import leaves

    def run(arch, lo, hi, state=None):
        cfg, fresh = ltrain.build(arch, smoke=True, seed=0, device=dev)
        state = fresh if state is None else state
        step_fn = ltrain.make_step(cfg, total_steps=4)
        losses = []
        for i in range(lo, hi):
            state, m = step_fn(state, ltrain.synthetic_batch(
                cfg.vocab, SMOKE_BATCH, SMOKE_SEQ, i, 0, dev))
            losses.append(m["loss"])
        return cfg, state, torch.stack(losses).tolist()

    notes = []
    for arch in lm_arch_ids(ARCH_IDS):
        flash_cuda.launches = flash_backward_cuda.launches = 0
        cfg, _, losses = run(arch, 0, SMOKE_STEPS)
        torch.cuda.synchronize()
        n_global = sum(not cfg.kind(i)[0] for i in range(cfg.n_layers))
        if flash_backward_cuda.launches != n_global * SMOKE_STEPS:
            fail(f"{arch} smoke: {flash_backward_cuda.launches} backward "
                 f"launches in {SMOKE_STEPS} steps, expected "
                 f"{n_global * SMOKE_STEPS}")
        if not (all(map(math.isfinite, losses))
                and losses[-1] < losses[0] + TRAIN_LOSS_RISE):
            fail(f"{arch} smoke: losses {losses}")
        notes.append(f"{arch} {losses[0]:.3f} -> {losses[-1]:.3f}")
    log(f"  (d) {SMOKE_STEPS} steps of {SMOKE_BATCH} x {SMOKE_SEQ} on the "
        "card, each smoke config (loss first -> last): " + "; ".join(notes))

    # float32 gradients, K4 route against the plain route.
    cfg, state = ltrain.build(LM_ARCH, smoke=True, seed=0, device=dev)
    c32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    batch = ltrain.synthetic_batch(cfg.vocab, SMOKE_BATCH, SMOKE_SEQ, 0, 0,
                                   dev)
    grads = []
    for route in (lambda f: f(), with_plain_route):
        for p in state.params.parameters():
            p.grad = None
        route(lambda: loss_fn(state.params, c32, batch).backward())
        grads.append([p.grad.clone() for p in state.params.parameters()])
    g_err = max(rel_max(a, b) for a, b in zip(*grads))
    if not g_err <= SMOKE_GRAD_TOL:
        fail(f"{LM_ARCH} smoke float32 gradients, K4 vs plain route: "
             f"{g_err:.3g} of a leaf's largest magnitude")
    del grads

    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, 0, state)
        back, _ = restore_checkpoint(path, state)
        if not all(torch.equal(a, b) for a, b in zip(leaves(state),
                                                      leaves(back))):
            fail("checkpoint round trip is not bitwise")
        _, straight, _ = run(LM_ARCH, 0, 4)
        _, again, _ = run(LM_ARCH, 0, 4)
        _, half, _ = run(LM_ARCH, 0, 2)
        path = save_checkpoint(tmp, 2, half)
        del half
        like = ltrain.build(LM_ARCH, smoke=True, seed=1, device=dev)[1]
        resumed_from, at = restore_checkpoint(path, like)
        _, resumed, _ = run(LM_ARCH, at, 4, resumed_from)

    def diff(a, b):
        return max((x.float() - y.float()).abs().max().item()
                   for x, y in zip(leaves(a), leaves(b)))

    own, res = diff(straight, again), diff(straight, resumed)
    how = "bitwise" if own == 0.0 else f"within the straight runs' {own:.3g}"
    if res > own:
        fail(f"resumed run differs from the straight run by {res:.3g}; "
             f"two straight runs by {own:.3g}")
    log(f"  (d) {LM_ARCH} smoke float32: gradients through K4 == plain "
        f"route within {g_err:.3g} of each leaf's largest magnitude (limit "
        f"{SMOKE_GRAD_TOL}); checkpoint round trip bitwise; cut at step 2 "
        f"of 4 and resumed == the straight run {how} (max abs diff "
        f"{res:.3g})")
    return {"train_smoke_grad_rel_err": g_err,
            "train_resume_bitwise": own == 0.0}


def train_phase(dev, flush, sms, clock, smi):
    """Phase 17: the LM training path (``repro_torch.launch.train``'s
    functions) at llama3.2-1b's full width; see the module docstring.
    Returns K4's ``train_*`` and ``bwd_*`` keys for the kernel line."""
    import torch

    from repro_torch.kernels.flash import flash_backward_cuda, flash_cuda
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import param_count

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) three steps of 8 x 4,096 tokens, two micro-batches each.
    cfg, state = ltrain.build(LM_ARCH, smoke=False, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    if n_params != param_count(cfg) or not cfg.remat:
        fail(f"{n_params} weights (param_count {param_count(cfg)}), remat "
             f"{cfg.remat}")
    step_fn = ltrain.make_step(cfg, total_steps=TRAIN_STEPS,
                               accum_steps=TRAIN_ACCUM)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rows, fwd, bwd = [], [], []
    with plain_versions_raise():
        for i in range(TRAIN_STEPS):
            batch = ltrain.synthetic_batch(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                           i, 0, dev)
            torch.cuda.synchronize()
            flash_cuda.launches = flash_backward_cuda.launches = 0
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            fwd.append(flash_cuda.launches)
            bwd.append(flash_backward_cuda.launches)
            loss, gnorm, lr = torch.stack(
                [m["loss"], m["grad_norm"], m["lr"]]).tolist()
            rows.append((ms, loss, gnorm, lr))
            log(f"  (a) step {i}: {ms:.1f} ms, {tokens / (ms * 1e-3):,.0f} "
                f"tokens/s, loss {loss:.4f}, grad_norm {gnorm:.4f}, lr "
                f"{lr:.3e}; K4 {fwd[-1]} forward launches, "
                f"{bwd[-1]} backward")
    losses = [r[1] for r in rows]
    if not all(math.isfinite(x) for r in rows for x in r[1:3]):
        fail(f"non-finite loss or grad_norm: {rows}")
    if not losses[-1] < losses[0] + TRAIN_LOSS_RISE:
        fail(f"loss {losses[-1]} after {TRAIN_STEPS} steps, first "
             f"{losses[0]}")
    if fwd != [TRAIN_FWD_PER_STEP] * TRAIN_STEPS or bwd != [
            TRAIN_BWD_PER_STEP] * TRAIN_STEPS:
        fail(f"K4 forward launches {fwd} (expected {TRAIN_FWD_PER_STEP} a "
             f"step), backward {bwd} (expected {TRAIN_BWD_PER_STEP})")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    step_ms = statistics.median(r[0] for r in rows[1:])
    log(f"  {at()} (a) {LM_ARCH} full width, {n_params:,} float32 weights "
        f"(seed 0), AdamW, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
        f"{TRAIN_ACCUM} micro-batches, layer remat; no plain attention "
        f"ran; step {step_ms:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}), "
        f"{tokens / (step_ms * 1e-3):,.0f} tokens/s; peak memory "
        f"{peak:.0f} MiB [{smi}]")

    # (b) one step under torch.profiler.
    batch = ltrain.synthetic_batch(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                   TRAIN_STEPS, 0, dev)
    with optimizer_events() as opt_ev:
        wall, busy, n_k, kern = profiled(lambda: step_fn(state, batch), 1)
    opt_ms = sum(s.elapsed_time(e) for s, e in opt_ev)

    def share(*words):
        return sum(ms for k, ms in kern
                   if any(w in k.lower() for w in words)) / busy

    shares = {"K4 forward": share("flash_wgmma", "flash_kernel",
                                  "flash_tf32"),
              "K4 backward": share("flash_bwd"),
              "matmuls": share("gemm", "nvjet", "xmma", "cutlass"),
              "optimizer": opt_ms / busy}
    idle = 1.0 - busy / wall
    top = "; ".join(f"{k[:40]} {ms:.1f}" for k, ms in kern[:6])
    log(f"  {at()} (b) one step under torch.profiler: wall {wall:.1f} ms, "
        f"card busy {busy:.1f} ms, idle {idle:.1%}, {n_k:,.0f} kernels; "
        "shares of busy: "
        + ", ".join(f"{k} {v:.1%}" for k, v in shares.items())
        + f" (optimizer {opt_ms:.1f} ms by CUDA events); top: {top}")
    del state, batch, kern, step_fn
    torch.cuda.empty_cache()

    # (c) the backward kernels against their plain version, and timed.
    keys = bwd_checks(dev, flush, sms, clock)
    log(f"  {at()} (c) done")

    # (d) the smoke configs on the card; checkpoint and resume.
    keys.update(smoke_training(dev))
    log(f"  {at()} (d) done")

    # (e) the launcher for 4 steps, then resumed from its step-4
    # checkpoint for steps 4-5 (it prints step 5, the last, and saves 6).
    import tempfile

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p)}
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                LM_ARCH, "--smoke", "--ckpt-dir", tmp, "--ckpt-every", "2"]
        outs = []
        for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
            proc = subprocess.run(argv + extra, cwd=ROOT, env=env,
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                fail(f"launch.train {' '.join(extra)} exited "
                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            outs.append(proc.stdout.strip().splitlines())
    resumed = outs[1]
    if not resumed or not (resumed[0].startswith("resumed from ")
                           and resumed[0].endswith(" at step 4")) or (
            not any(x.startswith("step     5 loss ") for x in resumed)
            or not any(x.startswith("checkpoint -> ")
                       and x.endswith("step_00000006") for x in resumed)
            or outs[0][-1] != "done" or resumed[-1] != "done"):
        fail(f"launch.train's lines: {outs}")
    log(f"  {at()} (e) python -m repro_torch.launch.train --smoke --steps 4 "
        f"--ckpt-every 2: exit 0 ({outs[0][-2]}); --steps 6 --resume: exit "
        f"0, '{resumed[0]}', then '{resumed[1]}'")
    keys.update(train_launches_fwd_per_step=fwd[-1],
                train_launches_bwd_per_step=bwd[-1], train_step_ms=step_ms,
                train_steps_ms=[r[0] for r in rows],
                train_tokens_per_s=tokens / (step_ms * 1e-3),
                train_losses=losses, train_peak_mib=peak,
                train_idle_share=idle, train_profiled_wall_ms=wall,
                train_busy_ms=busy, train_optimizer_ms=opt_ms,
                **{f"train_share_{k.replace(' ', '_').lower()}": v
                   for k, v in shares.items()})
    log(f"  {at()} phase 17 done")
    return keys


# Phase 18: the GNN side (gat-cora, pna, nequip, mace) at published width.
GNN_STEPS = 3
GNN_LOSS_RISE = 0.5       # phase 17's rule: loss 3 < loss 1 + 0.5
GNN_ROUTE_TOL = 1e-4      # K2a route vs plain route, of each tensor's max
# tests/test_gnn_sharded.py's bound; for the loss, of max(1, |loss|): at
# the published widths an energy MSE reaches ~1.7e4, where float32's
# spacing is ~2e-3 and K2a's order moves the last bits (PERF.md §6).
GNN_SHARD_TOL = 5e-4
# lr 1e-4: at the published widths a first step of 1e-3 throws MACE's
# loss up (78.5 -> 6,712 on 16 molecules, on the CPU); 1e-4 lowers
# all four.
GNN_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=GNN_STEPS)
MOLECULES, MOLECULE_NODES, MOLECULE_EDGES = 128, 30, 64
OGB_NODES, OGB_EDGES, OGB_FEAT, OGB_CLASSES = 2_449_029, 61_859_140, 100, 47
OGB_CUT = 0.95            # (b): E cut by 5% a try while the step does not fit
OGB_CUTS = 8              # (b): at most this many cuts
OGB_TIMED = 5             # (b): medians of 5 for the largest K2a calls


def k2_route(rows_fn):
    """A context in which ``SegmentSumFn`` sums with ``rows_fn(msgs, dst,
    n)`` in place of ``segment_sum_mxu`` (K2a): a hook of this script
    (the program has no switch)."""
    import contextlib

    from repro_torch.kernels.segsum import ops

    @contextlib.contextmanager
    def ctx():
        saved = ops.segment_sum_mxu
        ops.segment_sum_mxu = rows_fn
        try:
            yield
        finally:
            ops.segment_sum_mxu = saved

    return ctx()


def index_add_rows(msgs, dst, n):
    """The library's one call for K2a's function: ``index_add_`` into
    float32 (every id in range, as in the GNN graphs here)."""
    import torch

    out = torch.zeros(n, msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, dst.long(), msgs.float()).to(msgs.dtype)


def plain_rows(msgs, dst, n):
    from repro_torch.kernels.segsum import segsum_plain

    return segsum_plain(msgs, dst, n)


def k2a_bound_ms(e, n, d, itemsize=4):
    """K2a's byte bound: messages and ids read once, the output written
    once (``roofline.analysis.segsum_work``), at the card's memory
    rate."""
    from repro_torch.roofline.analysis import segsum_work

    return segsum_work(e, n, d, itemsize)[1] / HBM_BYTES_PER_S * 1e3


def tree_rel(got, want, floor_share=1e-7):
    """Largest error of a list of tensors against another, each as a
    share of its own largest magnitude, that floored at ``floor_share``
    of the whole list's (a gradient that vanishes by symmetry is float
    noise in both)."""
    scale = max(float(w.abs().max()) for w in want if w.numel())
    worst = 0.0
    for g, w in zip(got, want):
        if w.numel():
            den = max(float(w.abs().max()), floor_share * scale, 1e-30)
            worst = max(worst, float((g.double() - w.double()).abs().max())
                        / den)
    return worst


def step_profile(call):
    """One step under ``torch.profiler`` (``profiled``): wall and busy ms,
    the idle share, K2a's share of busy time (its ``k2a_*`` kernels) and
    the top kernels by device time."""
    wall, busy, n_kernels, rows = profiled(call, 1)
    k2a = sum(ms for name, ms in rows if "k2a_" in name)
    return dict(prof_wall_ms=wall, prof_busy_ms=busy,
                prof_idle=1 - busy / wall, prof_kernels=n_kernels,
                prof_k2a_ms=k2a, prof_top=[(k[:60], ms) for k, ms in rows[:6]])


def log_profile(label, prof):
    log(f"  {label} profiled step: wall {prof['prof_wall_ms']:.2f} ms, busy "
        f"{prof['prof_busy_ms']:.2f} (idle {prof['prof_idle']:.1%}), "
        f"{prof['prof_kernels']:.0f} kernels, K2a {prof['prof_k2a_ms']:.3f} "
        f"ms; top: " + "; ".join(f"{k} {ms:.3f}"
                                   for k, ms in prof["prof_top"]))


def gnn_inputs(arch, dev, seed=0):
    """``(module, config, graph)`` of ``arch`` at its ``CONFIG`` on the
    shape it is published for: gat-cora on ``full_graph_sm`` (Cora's
    2,708 nodes and 10,556 edges), the rest on ``molecule`` (128
    molecules of 30 nodes and 64 edges), the equivariant ones with
    positions, species and a per-molecule energy target."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.gnn import equivariant, gat, pna, random_graph

    spec = get_config(arch)
    cfg = spec.model
    if arch == "gat-cora":
        dims = spec.shape("full_graph_sm").dims
        g = random_graph(dims["n_nodes"], dims["n_edges"],
                         d_feat=dims["d_feat"], n_classes=dims["n_classes"],
                         seed=seed, device=dev)
        return gat, cfg, g
    dims = spec.shape("molecule").dims
    if (dims["n_nodes"], dims["n_edges"], dims["batch"]) != (
            MOLECULE_NODES, MOLECULE_EDGES, MOLECULES):
        fail(f"molecule shape {dims}")
    n, e = MOLECULES * MOLECULE_NODES, MOLECULES * MOLECULE_EDGES
    if arch == "pna":
        return pna, cfg, random_graph(
            n, e, d_feat=dims["d_feat"], n_classes=dims["n_classes"],
            n_graphs=MOLECULES, seed=seed, device=dev)
    g = random_graph(n, e, with_positions=True, n_species=cfg.n_species,
                     n_graphs=MOLECULES, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return equivariant, cfg, dataclasses.replace(
        g, labels=torch.randn(MOLECULES, generator=gen, device=dev))


def float64_tree(tree):
    """A float64 copy of a parameter tree (no gradient history)."""
    if isinstance(tree, dict):
        return {k: float64_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [float64_tree(v) for v in tree]
    return tree.detach().double()


def float64_graph(g):
    """``g`` with its float arrays in float64."""
    import dataclasses

    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).double()
        for f in dataclasses.fields(g)
        if hasattr(getattr(g, f.name), "is_floating_point")
        and getattr(g, f.name).is_floating_point()})


def route_check(label, k2a, plain, f64):
    """K2a's route against the plain route within ``GNN_ROUTE_TOL`` of
    each tensor's largest magnitude; where float32 itself cannot meet
    that (the plain route strays that far from the float64 call), K2a
    within twice the plain route's distance from float64 instead (phase
    16's rule for K4).  Returns the three distances."""
    r = dict(k2a_plain=tree_rel(k2a, plain), k2a_f64=tree_rel(k2a, f64),
             plain_f64=tree_rel(plain, f64))
    if not (r["k2a_plain"] <= GNN_ROUTE_TOL
            or r["k2a_f64"] <= 2 * r["plain_f64"]):
        fail(f"phase 18 {label}: K2a route vs plain {r['k2a_plain']:.3g}, "
             f"vs float64 {r['k2a_f64']:.3g} (plain {r['plain_f64']:.3g})")
    return r


def gnn_grads(mod, cfg, g, params):
    """(forward output, loss, gradients in leaf order) of one call."""
    import torch

    from repro_torch.train.tree import leaves

    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    loss = mod.loss_fn(params, cfg, g)
    loss.backward()
    grads = [p.grad.detach().clone() if p.grad is not None
             else torch.zeros_like(p) for p in ps]
    with torch.no_grad():
        out = mod.forward(params, cfg, g)
    for p in ps:
        p.grad = None
    return out, loss.detach(), grads


def gnn_models(dev):
    """Phase 18 (a): each GNN at its ``CONFIG`` on its published shape."""
    import torch

    from repro_torch.kernels.segsum import segsum_cuda
    from repro_torch.models.gnn import equivariant
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import leaves

    rows = {}
    for arch in ("gat-cora", "pna", "nequip", "mace"):
        mod, cfg, g = gnn_inputs(arch, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = init_train_state(mod.init_params(gen, cfg))
        n_params = sum(p.numel() for p in leaves(state.params))
        step = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b),
                               AdamWConfig(**GNN_OPT))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, ms, launches = [], [], []
        for _ in range(GNN_STEPS):
            segsum_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, g)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(segsum_cuda.launches)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        prof = step_profile(lambda: step(state, g))
        if not all(math.isfinite(x) for x in losses):
            fail(f"phase 18 {arch}: losses {losses}")
        if not losses[-1] < losses[0] + GNN_LOSS_RISE:
            fail(f"phase 18 {arch}: loss 3 {losses[-1]} not below loss 1 "
                 f"{losses[0]} + {GNN_LOSS_RISE}")
        if min(launches) == 0 or len(set(launches)) != 1:
            fail(f"phase 18 {arch}: K2a launches a step {launches}")
        step_ms = statistics.median(ms[1:])

        # The K2a route against the plain route (forward, gradients,
        # NequIP's forces), each also against the same call in float64
        # (the scatter's route: K2a sums float32 / bfloat16 only).
        params = state.params
        params64 = float64_tree(params)
        g64 = float64_graph(g)
        out_k, _, grads_k = gnn_grads(mod, cfg, g, params)
        with k2_route(plain_rows):
            out_p, _, grads_p = gnn_grads(mod, cfg, g, params)
        out_d, _, grads_d = gnn_grads(mod, cfg, g64, params64)
        checks = {"forward": ([out_k], [out_p], [out_d]),
                  "gradients": (grads_k, grads_p, grads_d)}
        if arch == "nequip":
            f_k = equivariant.forces(params, cfg, g)
            with k2_route(plain_rows):
                f_p = equivariant.forces(params, cfg, g)
            checks["forces"] = ([f_k], [f_p],
                                [equivariant.forces(params64, cfg, g64)])
        row = dict(params=n_params, step_ms=step_ms, steps_ms=ms,
                   peak_mib=peak, k2a_launches=launches[0], losses=losses,
                   nodes=g.n_nodes, edges=int(g.edge_src.shape[0]), **prof)
        for what, (k, p, d) in checks.items():
            row[f"{what}_route"] = route_check(f"{arch} {what}", k, p, d)
        log(f"  (a) {arch} ({n_params:,} weights; {g.n_nodes} nodes, "
            f"{row['edges']} edges): step {step_ms:.2f} ms (steps "
            f"{', '.join(f'{x:.2f}' for x in ms)}), peak {peak:.0f} MiB, "
            f"{launches[0]} K2a launches a step, losses "
            f"{', '.join(f'{x:.4g}' for x in losses)}; K2a route vs plain "
            "(vs float64: K2a, plain): " + "; ".join(
                f"{what} {r['k2a_plain']:.3g} ({r['k2a_f64']:.3g}, "
                f"{r['plain_f64']:.3g})"
                for what, r in ((w[:-6], row[w]) for w in row
                                if w.endswith("_route"))))
        log_profile(f"(a) {arch}", prof)
        rows[arch] = row
        del state, params, grads_k, grads_p, g
    return rows


def ogb_graph(dev, n, e, gen):
    """gat-cora's ``ogb_products`` cell on the card: ``n`` nodes, ``e``
    random edges (int32, drawn on the card), ``OGB_FEAT`` features,
    ``OGB_CLASSES`` labels."""
    import torch

    from repro_torch.models.gnn import GraphBatch

    src = torch.randint(0, n, (e,), generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=gen, device=dev,
                        dtype=torch.int32)
    return GraphBatch(
        edge_src=src, edge_dst=dst,
        edge_mask=torch.ones(e, device=dev), n_nodes=n,
        node_feat=torch.randn(n, OGB_FEAT, generator=gen, device=dev),
        node_mask=torch.ones(n, device=dev),
        labels=torch.randint(0, OGB_CLASSES, (n,), generator=gen,
                             device=dev, dtype=torch.int32))


def ogb_memory_gb(e, n):
    """A reckoning of the step's peak bytes (GB) before running: layer
    1's saved gather ``h[src]`` and its gradient's two [E, 8, 8] float32
    temporaries, about seven [E, 8] tensors kept by the softmax chain,
    layer 2's saved [E, 1, 47] gather, K2a's scratch at D = 64
    (``k2a_geometry``) and the node side."""
    from repro_torch.kernels.segsum.segsum import k2a_geometry

    geo = k2a_geometry(e, n, 64, 4, 128, 512)
    scratch = 4 * (geo.int_words + geo.partial_floats)
    return (3 * e * 64 * 4 + 7 * e * 8 * 4 + e * 47 * 4 + scratch
            + n * (OGB_FEAT + 8 * 64) * 4) / 1e9


def ogb_step(dev, flush, e):
    """Phase 18 (b) at ``e`` edges: one warm step on K2a, then the step on
    K2a and on ``index_add_`` in turns (index_add_, K2a, K2a,
    index_add_), then the K2a calls of its shapes alone.  Raises
    ``torch.cuda.OutOfMemoryError`` when the card cannot hold it."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.segsum import segsum_cuda, segsum_plain
    from repro_torch.models.gnn import gat
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step

    spec = get_config("gat-cora")
    # launch/tasks.py's _gnn_model_cfg: the shape's feature and class dims.
    cfg = dataclasses.replace(spec.model, d_in=OGB_FEAT,
                              n_classes=OGB_CLASSES)
    n = OGB_NODES
    gen = torch.Generator(device=dev).manual_seed(0)
    g = ogb_graph(dev, n, e, gen)
    state = init_train_state(gat.init_params(gen, cfg))
    step = make_train_step(lambda p, b: gat.loss_fn(p, cfg, b),
                           AdamWConfig(**GNN_OPT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, g)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, float(m["loss"])

    segsum_cuda.launches = 0
    first_ms, loss0 = timed()
    launches = segsum_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    walls = {"k2a": [], "index_add": []}
    for route in ("index_add", "k2a", "k2a", "index_add"):
        if route == "k2a":
            walls[route].append(timed()[0])
        else:
            with k2_route(index_add_rows):
                walls[route].append(timed()[0])
    if not math.isfinite(loss0) or launches != 4:
        fail(f"phase 18 (b): loss {loss0}, {launches} K2a launches a step "
             "(expected 4: two per layer)")
    prof = step_profile(lambda: step(state, g))
    del state, step

    # K2a's calls at the step's shapes, alone: layer 1's [E, 8 x 8]
    # messages and [E, 8] softmax denominators, layer 2's [E, 47] and
    # [E, 1].  The layer-1 messages are the kernel line's numbers.
    calls = {}
    for label, d in (("msg1", 64), ("msg2", 47), ("den1", 8), ("den2", 1)):
        msgs = torch.randn(e, d, generator=gen, device=dev)
        k_ms = time_cuda(lambda: segsum_cuda(msgs, g.edge_dst, n), flush,
                         n_timed=OGB_TIMED)
        l_ms = time_cuda(lambda: index_add_rows(msgs, g.edge_dst, n), flush,
                         n_timed=OGB_TIMED)
        calls[label] = dict(d=d, ms=k_ms, library_ms=l_ms,
                            bound_ms=k2a_bound_ms(e, n, d))
        if label == "msg1":
            got = segsum_cuda(msgs, g.edge_dst, n)
            want = segsum_plain(msgs, g.edge_dst, n)
            calls[label]["max_abs_err"] = float((got - want).abs().max())
            del got, want
            torch.cuda.empty_cache()
            calls[label]["plain_ms"] = time_cuda(
                lambda: segsum_plain(msgs, g.edge_dst, n), flush,
                n_timed=OGB_TIMED)
        del msgs
        torch.cuda.empty_cache()
    return dict(edges=e, nodes=n, first_ms=first_ms, loss=loss0,
                k2a_launches=launches, peak_gib=peak,
                k2a_step_ms=statistics.median(walls["k2a"]),
                index_add_step_ms=statistics.median(walls["index_add"]),
                k2a_steps_ms=walls["k2a"],
                index_add_steps_ms=walls["index_add"], calls=calls, **prof)


def gnn_ogb(dev, flush):
    """Phase 18 (b): gat-cora on ``ogb_products``, its edges cut by 5% a
    try, only while the card cannot hold the step."""
    import gc

    import torch

    from repro_torch.configs import get_config

    dims = get_config("gat-cora").shape("ogb_products").dims
    if (dims["n_nodes"], dims["n_edges"], dims["d_feat"],
            dims["n_classes"]) != (OGB_NODES, OGB_EDGES, OGB_FEAT,
                                   OGB_CLASSES):
        fail(f"ogb_products shape {dims}")
    e, reduced = OGB_EDGES, None
    log(f"  (b) gat-cora on ogb_products: {OGB_NODES:,} nodes, {e:,} edges, "
        f"d_in {OGB_FEAT}, {OGB_CLASSES} classes; reckoned peak "
        f"{ogb_memory_gb(e, OGB_NODES):.1f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}")
    for _ in range(OGB_CUTS + 1):
        try:
            res = ogb_step(dev, flush, e)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        gc.collect()
        torch.cuda.empty_cache()
        e = int(e * OGB_CUT)
        reduced = f"n_edges {OGB_EDGES:,} -> {e:,}: the step did not fit"
        log(f"  (b) out of memory; cutting to {e:,} edges")
    else:
        fail("phase 18 (b): no edge count tried fits the card")
    res["reduced"] = reduced
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (b) {res['edges']:,} edges: first step {res['first_ms']:.1f} ms, "
        f"loss {res['loss']:.4f}, peak {res['peak_gib']:.2f} GiB, "
        f"{res['k2a_launches']} K2a launches a step; step with K2a "
        f"{res['k2a_step_ms']:.1f} ms ({', '.join(f'{x:.1f}' for x in res['k2a_steps_ms'])}) "
        f"against index_add_ {res['index_add_step_ms']:.1f} ms "
        f"({', '.join(f'{x:.1f}' for x in res['index_add_steps_ms'])}), "
        f"in turns; reduced: {reduced}")
    log_profile("(b)", res)
    for label, c in res["calls"].items():
        log(f"  (b) K2a [{res['edges']:,}, {c['d']}] -> [{res['nodes']:,}, "
            f"{c['d']}] ({label}): {c['ms']:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ({c['bound_ms'] / c['ms']:.1%}), "
            f"index_add_ {c['library_ms']:.4f}"
            + (f", plain {c['plain_ms']:.4f}, max abs err "
               f"{c['max_abs_err']:.3g}" if "plain_ms" in c else ""))
    return res


def gnn_shapes(dev, flush):
    """K2a against ``index_add_`` at (a)'s message shapes: the evidence a
    width floor would need (PERF.md §6)."""
    import torch

    from repro_torch.kernels.segsum import segsum_cuda

    gen = torch.Generator(device=dev).manual_seed(3)
    mol_n, mol_e = MOLECULES * MOLECULE_NODES, MOLECULES * MOLECULE_EDGES
    out = []
    for label, e, n, d in (("gat full_graph_sm msg1", 10556, 2708, 64),
                           ("gat full_graph_sm msg2", 10556, 2708, 7),
                           ("gat full_graph_sm den1", 10556, 2708, 8),
                           ("pna molecule msg", mol_e, mol_n, 75),
                           ("molecule deg", mol_e, mol_n, 1),
                           ("nequip l=0", mol_e, mol_n, 32),
                           ("nequip l=2", mol_e, mol_n, 160),
                           ("mace l=0", mol_e, mol_n, 128),
                           ("mace l=2", mol_e, mol_n, 640)):
        dst = torch.randint(0, n, (e,), generator=gen, device=dev,
                            dtype=torch.int32)
        msgs = torch.randn(e, d, generator=gen, device=dev)
        k_ms, l_ms = time_two(lambda: segsum_cuda(msgs, dst, n),
                              lambda: index_add_rows(msgs, dst, n), flush)
        out.append(dict(label=label, e=e, n=n, d=d, ms=k_ms, library_ms=l_ms,
                        bound_ms=k2a_bound_ms(e, n, d)))
        log(f"  (a) K2a [{e}, {d}] -> [{n}, {d}] ({label}): {k_ms:.4f} ms "
            f"against index_add_ {l_ms:.4f} (in turns, from an idle card), "
            f"bound {out[-1]['bound_ms']:.5f}")
    return out


def gnn_sharded(dev):
    """Phase 18 (c): the edge-sharded step at world size 1 (an NCCL group
    of one) against the plain step, from the same state: gat-cora,
    NequIP and MACE at (a)'s shapes; the collectives a step."""
    import copy
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.gnn_sharded import make_edge_sharded_step
    from repro_torch.launch.mesh import init_local_group
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import leaves

    store = tempfile.mkdtemp(prefix="chip-smoke-gnn-group-")
    init_local_group(0, 1, store, dev.type)
    res = {}
    real = dist.all_reduce
    try:
        log(f"  (c) {dist.get_backend()} group of world size 1")
        for arch in ("gat-cora", "nequip", "mace"):
            mod, cfg, g = gnn_inputs(arch, dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            params = mod.init_params(gen, cfg)
            plain = init_train_state(copy.deepcopy(params))
            sharded = init_train_state(params)
            opt = AdamWConfig(**GNN_OPT)
            plain, m_p = make_train_step(
                lambda p, b: mod.loss_fn(p, cfg, b), opt)(plain, g)
            count = [0]

            def counted(*a, **k):
                count[0] += 1
                return real(*a, **k)

            dist.all_reduce = counted
            try:
                sharded, m_s = make_edge_sharded_step(mod, cfg, None, opt)(
                    sharded, g)
                torch.cuda.synchronize()
            finally:
                dist.all_reduce = real
            dl = abs(float(m_p["loss"]) - float(m_s["loss"])) / max(
                1.0, abs(float(m_p["loss"])))
            dp = max(float((a - b).detach().abs().max()) for a, b in
                     zip(leaves(plain.params), leaves(sharded.params)))
            if not (dl < GNN_SHARD_TOL and dp < GNN_SHARD_TOL):
                fail(f"phase 18 (c) {arch}: sharded vs plain loss {dl}, "
                     f"params {dp}")
            res[arch] = dict(loss_diff=dl, param_diff=dp,
                             collectives=count[0])
            log(f"  (c) {arch}: sharded step = plain step (loss within "
                f"{dl:.3g} of max(1, |loss|), parameters within {dp:.3g}); "
                f"{count[0]} "
                "all_reduce calls a step")
    finally:
        dist.destroy_process_group()
    return res


def gnn_phase(dev, flush, smi):
    """Phase 18: the GNN side.  Returns K2a's entry (its main keys at the
    GNN's largest shape, ``gnn_*`` beside them)."""
    import torch

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    log(f"  card: {smi}; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        "allocated on entry")
    models = gnn_models(dev)
    log(f"  {at()} (a) done")
    shapes = gnn_shapes(dev, flush)
    log(f"  {at()} (a) shapes done")
    ogb = gnn_ogb(dev, flush)
    log(f"  {at()} (b) done")
    sharded = gnn_sharded(dev)
    log(f"  {at()} (c) done")
    torch.cuda.empty_cache()
    msg1 = ogb["calls"]["msg1"]
    launches = sum(r["k2a_launches"] for r in models.values())
    return {
        "launches": launches,
        "max_abs_err": msg1["max_abs_err"],
        "ms": msg1["ms"],
        "plain_ms": msg1["plain_ms"],
        "bound_ms": msg1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": msg1["library_ms"],
        "gnn_card": smi,
        "gnn_models": models,
        "gnn_shapes": shapes,
        "gnn_ogb": {k: v for k, v in ogb.items() if k != "calls"},
        "gnn_ogb_calls": ogb["calls"],
        "gnn_reduced": ogb["reduced"],
        "gnn_sharded": sharded,
    }


# Phase 19: the recsys side (bert4rec) at its published width.
RECSYS_BATCH = 65_536     # train_batch's batch, halved while a step does not fit
RECSYS_MASKED = 20        # launch/tasks.py: n_masked
RECSYS_NEG = 8_192        # launch/tasks.py: n_neg (shared negatives)
RECSYS_STEPS = 3
RECSYS_LOSS_RISE = 0.5    # phase 17's rule: loss 3 < loss 1 + 0.5
RECSYS_TOPK = 100
RECSYS_CHUNK = 4_096      # serve_bulk rows a chunk, each with its own top-k
RECSYS_ROUTE_BATCH = 1_024  # (c): the training batch's first sequences
RECSYS_HIDDEN_TOL = 1e-5  # (c) encode, K4 route vs plain, of the largest
RECSYS_GRAD_TOL = 1e-4    # (c) gradients, of each leaf's largest magnitude
RETRIEVAL_TOL = 1e-5      # tests/test_recsys.py: rtol = atol
BAG_TOL = 1e-4            # (d) of the output's largest magnitude
RECSYS_TIMED = 5          # medians of 5


def recsys_batch(cfg, b, gen, dev):
    """A cloze batch of ``b`` sequences on the card: items in ``[1,
    n_items]`` after a PAD prefix of 0-99 positions, ``RECSYS_MASKED``
    distinct masked positions a row among the items (set to MASK, their
    items the labels) and ``RECSYS_NEG`` shared negatives."""
    import torch

    s = cfg.max_seq
    items = torch.randint(1, cfg.n_items + 1, (b, s), generator=gen,
                          device=dev, dtype=torch.int32)
    pad = torch.randint(0, 100, (b, 1), generator=gen, device=dev)
    at = torch.arange(s, device=dev)[None]
    items = torch.where(at < pad, 0, items)
    # distinct positions among the items: the largest of random keys
    keys = torch.rand(b, s, generator=gen, device=dev).masked_fill(
        at < pad, -1.0)
    pos = keys.topk(RECSYS_MASKED, dim=1).indices.to(torch.int32)
    labels = items.gather(1, pos.long())
    items = items.scatter(1, pos.long(), cfg.mask_id)
    neg = torch.randint(1, cfg.n_items + 1, (RECSYS_NEG,), generator=gen,
                        device=dev, dtype=torch.int32)
    return {"items": items, "masked_pos": pos, "labels": labels,
            "negatives": neg}


def recsys_params(cfg, dev):
    """BERT4Rec's float32 weights from seed 0, drawn on the card."""
    import torch

    from repro_torch.models.recsys import bert4rec

    return bert4rec.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)


def with_naive_attention(fn):
    """``fn()`` with ``models.attention.bidirectional_attention`` on
    ``naive_attention(causal=False)``, the reference's plain form (a hook
    of this script; the program has no switch)."""
    from repro_torch.models import attention

    kernel = attention.bidirectional_attention
    attention.bidirectional_attention = (
        lambda q, k, v: attention.naive_attention(q, k, v, causal=False))
    try:
        return fn()
    finally:
        attention.bidirectional_attention = kernel


def float64_route(fn):
    """``fn()`` with BERT4Rec's layer norms and attention in the type of
    their input (the program's run in float32, its plain attention's
    softmax too): a float64 call is then float64 through the encoder (a
    hook of this script; the program has no switch)."""
    import torch

    from repro_torch.models import attention
    from repro_torch.models.recsys import bert4rec

    def layernorm(params, x, eps=1e-6):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return ((x - mean) * torch.rsqrt(var + eps) * params["scale"]
                + params["bias"])

    def attend(q, k, v):
        scores = torch.einsum("bshd,bthd->bhst", q, k) / q.shape[-1] ** 0.5
        return torch.einsum("bhst,bthd->bshd", scores.softmax(dim=-1), v)

    saved = bert4rec.layernorm, attention.bidirectional_attention
    bert4rec.layernorm, attention.bidirectional_attention = layernorm, attend
    try:
        return fn()
    finally:
        bert4rec.layernorm, attention.bidirectional_attention = saved


def recsys_step_at(dev, cfg, b):
    """(a) at batch ``b``: 3 AdamW steps of ``loss_sampled`` (the port's
    ``make_train_step`` with ``AdamWConfig()``, as ``launch/tasks.py``
    composes the step; ``accum_steps`` 1, since micro-batching would cut
    the shared negatives too), then one step under ``torch.profiler``.
    Raises ``torch.cuda.OutOfMemoryError`` when the card cannot hold
    it."""
    import torch

    from repro_torch.kernels.flash import flash_backward_cuda, flash_cuda
    from repro_torch.models.recsys import bert4rec
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step

    gen = torch.Generator(device=dev).manual_seed(1)
    batch = recsys_batch(cfg, b, gen, dev)
    state = init_train_state(recsys_params(cfg, dev))
    step = make_train_step(lambda p, x: bert4rec.loss_sampled(p, cfg, x),
                           AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms, launches = [], [], []
    with plain_versions_raise():
        for _ in range(RECSYS_STEPS):
            f0, b0 = flash_cuda.launches, flash_backward_cuda.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append((flash_cuda.launches - f0,
                             flash_backward_cuda.launches - b0))
            losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    wall, busy, n_kernels, rows = profiled(lambda: step(state, batch), 1)
    k4 = sum(t for name, t in rows if "flash" in name)
    return dict(
        batch=b, state=state, data=batch, losses=losses, steps_ms=ms,
        step_ms=statistics.median(ms[1:]), launches=launches, peak_gib=peak,
        prof_wall_ms=wall, prof_busy_ms=busy, prof_idle=1 - busy / wall,
        prof_kernels=n_kernels, prof_k4_ms=k4,
        prof_top=[(k[:60], t) for k, t in rows[:6]])


def recsys_train(dev, cfg):
    """Phase 19 (a): ``train_batch`` halved from 65,536 while a step does
    not fit the card."""
    import gc

    import torch

    b, reduced = RECSYS_BATCH, None
    while True:
        try:
            res = recsys_step_at(dev, cfg, b)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        gc.collect()
        torch.cuda.empty_cache()
        if b <= 512:
            fail("phase 19 (a): no training batch down to 512 fits the card")
        log(f"  (a) batch {b:,}: out of memory; halving")
        b //= 2
        reduced = (f"train_batch {RECSYS_BATCH:,} -> {b:,} sequences: the "
                   "step did not fit one card")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 19 (a): losses {losses}")
    if not losses[-1] < losses[0] + RECSYS_LOSS_RISE:
        fail(f"phase 19 (a): loss 3 {losses[-1]} not below loss 1 "
             f"{losses[0]} + {RECSYS_LOSS_RISE}")
    if set(res["launches"]) != {(2, 2)}:
        fail(f"phase 19 (a): K4 launches a step {res['launches']} "
             "(expected 2 forward and 2 backward: one a block)")
    res["reduced"] = reduced
    res["seq_per_s"] = b / (res["step_ms"] * 1e-3)
    log(f"  (a) train_batch at {b:,} x {cfg.max_seq} ({RECSYS_MASKED} masked "
        f"positions, {RECSYS_NEG:,} shared negatives): step "
        f"{res['step_ms']:.1f} ms (steps "
        f"{', '.join(f'{x:.1f}' for x in res['steps_ms'])}), "
        f"{res['seq_per_s']:,.0f} sequences/s, peak {res['peak_gib']:.2f} "
        f"GiB, K4 launches a step (forward, backward) {res['launches'][0]}, "
        f"losses {', '.join(f'{x:.5g}' for x in losses)}; reduced: {reduced}")
    log(f"  (a) profiled step: wall {res['prof_wall_ms']:.2f} ms, busy "
        f"{res['prof_busy_ms']:.2f} (idle {res['prof_idle']:.1%}), "
        f"{res['prof_kernels']:.0f} kernels, K4 {res['prof_k4_ms']:.3f} ms; "
        "top: " + "; ".join(f"{k} {t:.3f}" for k, t in res["prof_top"]))
    return res


def recsys_serve(dev, cfg, params, flush):
    """Phase 19 (b): ``serve_p99`` (512 sequences), all of ``serve_bulk``
    (262,144, in chunks of ``RECSYS_CHUNK``) and ``retrieval_cand`` (one
    sequence against 1,000,000 candidates), each ``serve_score`` or
    ``retrieval_score`` + ``torch.topk(100)``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.models.recsys import bert4rec

    shapes = get_config("bert4rec").shapes
    p99, bulk = (shapes[n].dims["batch"] for n in ("serve_p99",
                                                   "serve_bulk"))
    n_cand = shapes["retrieval_cand"].dims["n_candidates"]
    gen = torch.Generator(device=dev).manual_seed(2)
    items = recsys_batch(cfg, bulk, gen, dev)["items"]

    def serve(x):
        return torch.topk(bert4rec.serve_score(params, cfg, x), RECSYS_TOPK)

    out = {}
    with torch.no_grad(), plain_versions_raise():
        f0 = flash_cuda.launches
        p_vals, p_idx = serve(items[:p99])
        out["serve_p99_launches"] = flash_cuda.launches - f0
        out["serve_p99_ms"] = time_cuda(lambda: serve(items[:p99]), flush,
                                        n_timed=RECSYS_TIMED, n_warm=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vals = torch.empty(bulk, RECSYS_TOPK, device=dev)
        idx = torch.empty(bulk, RECSYS_TOPK, dtype=torch.int64, device=dev)
        for c0 in range(0, bulk, RECSYS_CHUNK):
            vals[c0:c0 + RECSYS_CHUNK], idx[c0:c0 + RECSYS_CHUNK] = serve(
                items[c0:c0 + RECSYS_CHUNK])
        end.record()
        end.synchronize()
        out["serve_bulk_wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["serve_bulk_ms"] = start.elapsed_time(end)
        out["serve_bulk_rows_per_s"] = bulk / (out["serve_bulk_ms"] * 1e-3)
        if not (torch.isfinite(vals).all() and bool((idx >= 0).all())
                and bool((idx < cfg.vocab).all())):
            fail("phase 19 (b): serve_bulk's top-100 is not finite and in "
                 "the catalog")
        # A row's top-100 depends on its row alone: the first chunk's
        # first 512 rows are serve_p99's.
        out["serve_chunk_rel"] = rel_max(vals[:p99], p_vals)
        if out["serve_chunk_rel"] > RETRIEVAL_TOL:
            fail(f"phase 19 (b): serve_bulk's first rows differ from "
                 f"serve_p99's by {out['serve_chunk_rel']:.3g}")
        del vals, idx, p_vals, p_idx

        one = items[:1]
        cand = torch.randint(1, cfg.n_items + 1, (n_cand,), generator=gen,
                             device=dev, dtype=torch.int32)

        def retrieve():
            return torch.topk(bert4rec.retrieval_score(params, cfg, one,
                                                       cand), RECSYS_TOPK)

        r_vals, r_idx = retrieve()
        out["retrieval_ms"] = time_cuda(retrieve, flush,
                                        n_timed=RECSYS_TIMED, n_warm=1)
        sub = bert4rec.retrieval_score(params, cfg, one, cand)
        full = bert4rec.serve_score(params, cfg, one)[0]
        want = full[cand.long()]
        ok = torch.allclose(sub, want, rtol=RETRIEVAL_TOL, atol=RETRIEVAL_TOL)
        out["retrieval_max_abs_err"] = float((sub - want).abs().max())
        if not ok or not torch.equal(r_vals, sub[r_idx]):
            fail(f"phase 19 (b): retrieval scores differ from the full "
                 f"catalog's by {out['retrieval_max_abs_err']:.3g} (rtol = "
                 f"atol = {RETRIEVAL_TOL})")
    del items
    log(f"  (b) serve_p99: {p99} sequences, serve_score + top-{RECSYS_TOPK} "
        f"over {cfg.vocab:,} items ({p99 * cfg.vocab * 4 / 1e9:.2f} GB of "
        f"scores): {out['serve_p99_ms']:.3f} ms (median of {RECSYS_TIMED}, "
        f"L2 flushed), {out['serve_p99_launches']} K4 launches a call")
    log(f"  (b) serve_bulk: {bulk:,} sequences in chunks of {RECSYS_CHUNK:,} "
        f"({RECSYS_CHUNK * cfg.vocab * 4 / 1e9:.1f} GB of scores a chunk), "
        f"each with its own top-{RECSYS_TOPK}: {out['serve_bulk_ms']:.1f} ms "
        f"on the card ({out['serve_bulk_wall_ms']:.1f} ms wall), "
        f"{out['serve_bulk_rows_per_s']:,.0f} rows/s; its first {p99} rows' "
        f"top-100 within {out['serve_chunk_rel']:.3g} of serve_p99's")
    log(f"  (b) retrieval_cand: 1 sequence x {n_cand:,} candidates + "
        f"top-{RECSYS_TOPK}: {out['retrieval_ms']:.3f} ms; scores == the "
        f"full catalog's at the candidates within "
        f"{out['retrieval_max_abs_err']:.3g}")
    return out


def recsys_grads(cfg, params, batch):
    """(loss, gradients in leaf order) of ``loss_sampled``."""
    import torch

    from repro_torch.models.recsys import bert4rec
    from repro_torch.train.tree import leaves

    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    loss = bert4rec.loss_sampled(params, cfg, batch)
    loss.backward()
    grads = [p.grad.detach().clone() for p in ps]
    for p in ps:
        p.grad = None
    return loss.detach(), grads


def recsys_routes(dev, cfg, params, data):
    """Phase 19 (c), first half: on the training state's weights and the
    first ``RECSYS_ROUTE_BATCH`` sequences of (a)'s batch, ``encode``'s
    hidden states and one step's gradients through K4 against the plain
    route (``naive_attention(causal=False)``), each also against the
    same call in float64 (``float64_route``; the sampled logits are
    float32 in every route, as in the reference)."""
    import torch

    from repro_torch.models.recsys import bert4rec

    batch = {k: (v[:RECSYS_ROUTE_BATCH] if k != "negatives" else v)
             for k, v in data.items()}
    params64 = float64_tree(params)
    with torch.no_grad():
        h_k = bert4rec.encode(params, cfg, batch["items"])
        h_p = with_naive_attention(
            lambda: bert4rec.encode(params, cfg, batch["items"]))
        h_d = float64_route(
            lambda: bert4rec.encode(params64, cfg, batch["items"]))
    loss_k, g_k = recsys_grads(cfg, params, batch)
    loss_p, g_p = with_naive_attention(
        lambda: recsys_grads(cfg, params, batch))
    loss_d, g_d = float64_route(lambda: recsys_grads(cfg, params64, batch))
    out = {}
    for what, k, p, d, tol in (("hidden", [h_k], [h_p], [h_d],
                                RECSYS_HIDDEN_TOL),
                               ("gradients", g_k, g_p, g_d,
                                RECSYS_GRAD_TOL)):
        r = dict(k4_plain=tree_rel(k, p), k4_f64=tree_rel(k, d),
                 plain_f64=tree_rel(p, d))
        if not (r["k4_plain"] <= tol or r["k4_f64"] <= 2 * r["plain_f64"]):
            fail(f"phase 19 (c) {what}: K4 route vs plain {r['k4_plain']:.3g}"
                 f" (limit {tol}), vs float64 {r['k4_f64']:.3g} (plain "
                 f"{r['plain_f64']:.3g})")
        out[what] = r
    out["loss"] = (float(loss_k), float(loss_p), float(loss_d))
    log(f"  (c) K4 route vs plain route (naive_attention) on the trained "
        f"weights, {RECSYS_ROUTE_BATCH} sequences: encode "
        f"{out['hidden']['k4_plain']:.3g} of the largest magnitude (limit "
        f"{RECSYS_HIDDEN_TOL}; vs float64: K4 {out['hidden']['k4_f64']:.3g}, "
        f"plain {out['hidden']['plain_f64']:.3g}); gradients "
        f"{out['gradients']['k4_plain']:.3g} of each leaf's largest (limit "
        f"{RECSYS_GRAD_TOL}; vs float64: K4 "
        f"{out['gradients']['k4_f64']:.3g}, plain "
        f"{out['gradients']['plain_f64']:.3g}); losses K4 {out['loss'][0]:.7g}"
        f", plain {out['loss'][1]:.7g}, float64 {out['loss'][2]:.7g}")
    del params64, g_k, g_p, g_d, h_k, h_p, h_d
    return out


def recsys_k4(dev, flush, sms, clock, train_b):
    """Phase 19 (c), second half: K4 alone at ``[B, 2, 200, 32]`` float32,
    bidirectional, for ``serve_p99``'s 512 and the training batch:
    forward and backward against the plain version (``flash_plain`` /
    ``flash_plain_backward``: forward 2e-5, backward 1e-4 of each
    tensor's largest magnitude), timed beside the bound, the plain
    version and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import (
        flash_backward_cuda,
        flash_bwd_plan,
        flash_cuda,
        flash_plain,
        flash_plain_backward,
        flash_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(19)
    h, s, d = 2, 200, 32
    out = {}
    for label, b in (("p99", 512), ("train", train_b)):
        args = bwd_inputs(gen, dev, torch.float32, b, h, h, s, d,
                          causal=False)
        q, k, v, o, lse, dout = args
        p_o, p_lse = flash_plain(q, k, v, causal=False, return_lse=True)
        fwd_err = rel_max(o, p_o)
        got = flash_backward_cuda(*args, causal=False)
        want = flash_plain_backward(q, k, v, p_o, p_lse, dout, causal=False)
        torch.cuda.synchronize()
        bwd_err = max(rel_max(g, w) for g, w in zip(got, want))
        if fwd_err > 2e-5 or bwd_err > BWD_TOL["float32"]:
            fail(f"phase 19 (c) K4 float32 bidirectional B={b}: forward "
                 f"{fwd_err:.3g}, backward {bwd_err:.3g} of the largest "
                 "magnitude")
        max_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        del got, want, p_o, p_lse
        reps = dict(n_timed=RECSYS_TIMED, n_warm=1)
        f_ms = time_cuda(lambda: flash_cuda(q, k, v, causal=False), flush,
                         **reps)
        fp_ms = time_cuda(lambda: flash_plain(q, k, v, causal=False), flush,
                          n_timed=2, n_warm=1)
        fl_ms = time_cuda(lambda: F.scaled_dot_product_attention(q, k, v),
                          flush, **reps)
        b_ms = time_cuda(lambda: flash_backward_cuda(*args, causal=False),
                         flush, **reps)
        bp_ms = time_cuda(lambda: flash_plain_backward(*args, causal=False),
                          flush, n_timed=2, n_warm=1)
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        so = F.scaled_dot_product_attention(qs, ks, vs)
        bl_ms = time_cuda(lambda: torch.autograd.grad(
            so, (qs, ks, vs), dout, retain_graph=True), flush, **reps)
        fb, fo = flash_bound(torch.float32, False, b, h, s, d, sms, clock)
        bb, bo = bwd_bound(torch.float32, b, h, h, s, d, sms, clock,
                           causal=False)
        row = dict(b=b, fwd_ms=f_ms, fwd_plain_ms=fp_ms, fwd_sdpa_ms=fl_ms,
                   fwd_route=flash_plan(d, torch.float32).kernel,
                   fwd_bound_ms=max(fb, fo) * 1e3,
                   fwd_bound_by="bytes" if fb >= fo else "operations",
                   bwd_ms=b_ms, bwd_plain_ms=bp_ms, bwd_sdpa_ms=bl_ms,
                   bwd_route=flash_bwd_plan(d, torch.float32).kernel,
                   bwd_bound_ms=max(bb, bo) * 1e3,
                   bwd_bound_by="bytes" if bb >= bo else "operations",
                   fwd_rel_err=fwd_err, bwd_rel_err=bwd_err,
                   bwd_max_abs_err=max_err)
        # Both float32 bounds: the FMA units' and three TF32 passes'.
        for r in ("fma", "tf32"):
            row[f"fwd_bound_{r}_ms"] = max(flash_bound(
                torch.float32, False, b, h, s, d, sms, clock, route=r)) * 1e3
            row[f"bwd_bound_{r}_ms"] = max(bwd_bound(
                torch.float32, b, h, h, s, d, sms, clock, causal=False,
                route=r)) * 1e3
        out[label] = row

        def shares(w, ms):
            return ", ".join(f"{r} {row[f'{w}_bound_{r}_ms']:.4f} "
                             f"({row[f'{w}_bound_{r}_ms'] / ms:.1%})"
                             for r in ("fma", "tf32"))

        log(f"  (c) K4 float32 bidirectional [{b}, {h}, {s}, {d}]: == plain "
            f"(forward {fwd_err:.3g}, backward {bwd_err:.3g} of the largest "
            f"magnitude); forward (route {row['fwd_route']}) {f_ms:.4f} ms "
            f"(bound {row['fwd_bound_ms']:.4f}, {row['fwd_bound_by']}; "
            f"{row['fwd_bound_ms'] / f_ms:.1%}; float32 bounds "
            f"{shares('fwd', f_ms)}), sdpa {fl_ms:.4f}, plain {fp_ms:.4f}; "
            f"backward (route {row['bwd_route']}) {b_ms:.4f} ms (bound "
            f"{row['bwd_bound_ms']:.4f}, {row['bwd_bound_by']}; "
            f"{row['bwd_bound_ms'] / b_ms:.1%}; float32 bounds "
            f"{shares('bwd', b_ms)}), sdpa backward {bl_ms:.4f}, plain "
            f"{bp_ms:.4f}")
        del args, q, k, v, o, lse, dout, qs, ks, vs, so
        torch.cuda.empty_cache()
    return out


def bag_plain(table, idx, bags, n, mode):
    """``embedding_bag``'s plain version: the rows by ``index_select``,
    then ``index_add_`` (sum, and over ``bincount``'s counts for mean) or
    ``scatter_reduce`` amax (max, an empty bag 0)."""
    import torch

    rows = table.index_select(0, idx.long())
    ids = bags.long()
    if mode == "max":
        out = torch.full((n, rows.shape[1]), -math.inf, device=rows.device)
        out.scatter_reduce_(0, ids[:, None].expand_as(rows), rows, "amax")
        return torch.where(torch.isfinite(out), out, 0.0)
    out = torch.zeros(n, rows.shape[1], device=rows.device).index_add_(
        0, ids, rows)
    if mode == "mean":
        out /= torch.bincount(ids, minlength=n).clamp(min=1)[:, None]
    return out


def recsys_bags(dev, flush, table, items):
    """Phase 19 (d): ``embedding_bag`` over the item table with bags = (a)'s
    item sequences.  ``sum``: K2a's launches a call, the call's ms, and
    K2a on the gathered rows against ``index_add_`` (in turns) and its
    plain version, beside the byte bound; ``sum``, ``mean`` and ``max``
    against ``bag_plain`` within ``BAG_TOL`` of the output's largest
    magnitude."""
    import torch

    from repro_torch.kernels.segsum import segsum_cuda, segsum_plain
    from repro_torch.sparse import embedding_bag

    b, s = items.shape
    idx = items.reshape(-1)
    bags = torch.arange(b, device=dev, dtype=torch.int32).repeat_interleave(s)
    e, d = idx.numel(), table.shape[1]
    out = {}
    with torch.no_grad():
        segsum_cuda.launches = 0
        got = embedding_bag(table, idx, bags, b, mode="sum")
        torch.cuda.synchronize()
        out["bag_launches"] = segsum_cuda.launches
        if out["bag_launches"] != 1:
            fail(f"phase 19 (d): {out['bag_launches']} K2a launches for one "
                 "embedding_bag(mode='sum') call")
        errs = {}
        for mode in ("sum", "mean", "max"):
            if mode != "sum":
                got = embedding_bag(table, idx, bags, b, mode=mode)
            want = bag_plain(table, idx, bags, b, mode)
            errs[mode] = rel_max(got, want)
            if errs[mode] > BAG_TOL or got.shape != (b, d):
                fail(f"phase 19 (d) embedding_bag {mode}: {errs[mode]:.3g} "
                     f"of the output's largest magnitude (limit {BAG_TOL})")
            if mode == "sum":
                out["bag_max_abs_err"] = float((got - want).abs().max())
        del got, want
        reps = dict(n_timed=RECSYS_TIMED, n_warm=1)
        out["bag_call_ms"] = time_cuda(
            lambda: embedding_bag(table, idx, bags, b, mode="sum"), flush,
            **reps)
        rows = table.index_select(0, idx.long())
        out["bag_ms"], out["bag_library_ms"] = time_two(
            lambda: segsum_cuda(rows, bags, b),
            lambda: index_add_rows(rows, bags, b), flush, **reps)
        out["bag_plain_ms"] = time_cuda(lambda: segsum_plain(rows, bags, b),
                                        flush, **reps)
        out["bag_bound_ms"] = k2a_bound_ms(e, b, d)
        out["bag_bound_by"] = "bytes"
        out["bag_rel_err"] = errs
        del rows
    log(f"  (d) embedding_bag over the {table.shape[0]:,} x {d} table, bags "
        f"= (a)'s {b:,} sequences ({e:,} ids, {e * d * 4 / 1e6:.0f} MB of "
        f"rows): {out['bag_launches']} K2a launch a sum call; sum, mean, "
        f"max == plain within {errs['sum']:.3g}, {errs['mean']:.3g}, "
        f"{errs['max']:.3g} of the largest magnitude; the call "
        f"{out['bag_call_ms']:.4f} ms; K2a on the rows {out['bag_ms']:.4f} "
        f"ms against index_add_ {out['bag_library_ms']:.4f} (in turns), "
        f"plain {out['bag_plain_ms']:.4f}, bound {out['bag_bound_ms']:.4f} "
        f"(bytes; {out['bag_bound_ms'] / out['bag_ms']:.1%})")
    return out


def recsys_phase(dev, flush, sms, clock, smi):
    """Phase 19: the recsys side at BERT4Rec's ``CONFIG``.  Returns (K4's
    ``recsys_*`` keys, K2a's ``bag_*`` keys)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.train.tree import leaves

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    cfg = get_config("bert4rec").model
    log(f"  card: {smi}; bert4rec: {cfg.vocab:,} x {cfg.embed_dim} item "
        f"table, {cfg.n_blocks} blocks, {cfg.n_heads} heads of "
        f"{cfg.embed_dim // cfg.n_heads}, S = {cfg.max_seq}, float32 from "
        f"seed 0")
    train = recsys_train(dev, cfg)
    log(f"  {at()} (a) done")
    state, data = train.pop("state"), train.pop("data")
    params = state.params
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for p in leaves(params):
        p.requires_grad_(False)
    serve = recsys_serve(dev, cfg, params, flush)
    log(f"  {at()} (b) done")
    routes = recsys_routes(dev, cfg, params, data)
    k4 = recsys_k4(dev, flush, sms, clock, train["batch"])
    log(f"  {at()} (c) done")
    bags = recsys_bags(dev, flush, params["item_embed"].detach(),
                       data["items"])
    log(f"  {at()} (d) done")
    reduced = [train["reduced"],
               f"serve_bulk in chunks of {RECSYS_CHUNK:,} rows, each with "
               "its own top-100 (a row's top-100 depends on its row alone)"]
    log("  reduced: " + "; ".join(r for r in reduced if r))
    del params, data
    gc.collect()
    torch.cuda.empty_cache()
    recsys = {
        "recsys_card": smi,
        "recsys_reduced": [r for r in reduced if r],
        "recsys_train_batch": train["batch"],
        "recsys_step_ms": train["step_ms"],
        "recsys_steps_ms": train["steps_ms"],
        "recsys_seq_per_s": train["seq_per_s"],
        "recsys_peak_gib": train["peak_gib"],
        "recsys_losses": train["losses"],
        "recsys_launches_step": {"forward": train["launches"][0][0],
                                 "backward": train["launches"][0][1]},
        "recsys_prof": {k: train[k] for k in (
            "prof_wall_ms", "prof_busy_ms", "prof_idle", "prof_kernels",
            "prof_k4_ms", "prof_top")},
        "recsys_serve_p99_launches": serve["serve_p99_launches"],
        **{f"recsys_{k}": v for k, v in serve.items()
           if k != "serve_p99_launches"},
        "recsys_routes": routes,
    }
    for label, row in k4.items():
        recsys.update({f"recsys_{label}_{k}": v for k, v in row.items()})
    return recsys, bags



# Phase 20: the dry-run, and its roofline held against phases 16-19.
# (a)'s cells: the JAX package's dry-run smoke test's three
# (tests/test_dryrun_smoke.py) and one of every other shape kind; the
# launcher's filter takes the product of --arch and --shape.
DRYRUN_ARCHS = ("llama3.2-1b", "gat-cora", "bert4rec")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "molecule",
                 "train_batch", "serve_p99", "retrieval_cand")
# (a)'s MoE cells (phase 22 (c) reads them): full size on the single
# pod's mesh (its global and its grouped route), in a third subprocess
# beside the two (~30 s of trace on an H100 machine's host; both meshes
# took 92.7 s; PERF.md §6).
DRYRUN_MOE_SHAPES = ("prefill_32k", "decode_32k")
DRYRUN_TIMEOUT_S = 300     # (a): each subprocess
MEMORY_RATIO_MAX = 2.0     # (b): predicted against measured peak, either way


def dryrun_subprocesses(smi):
    """Phase 20 (a): the dry-run CLI over ``DRYRUN_ARCHS`` x
    ``DRYRUN_SHAPES`` on both meshes, and ``MOE_ARCH`` x
    ``DRYRUN_MOE_SHAPES`` on the single one, in three subprocesses side
    by side.
    Returns the single mesh's rows and the MoE rows."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-dryrun-")
    out, moe_out = (os.path.join(tmp, f"{name}.json")
                    for name in ("single", "moe"))
    cells = [a for arch in DRYRUN_ARCHS for a in ("--arch", arch)] + [
        a for shape in DRYRUN_SHAPES for a in ("--shape", shape)]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    run = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    base = run + cells
    moe_cells = ["--arch", MOE_ARCH] + [
        a for shape in DRYRUN_MOE_SHAPES for a in ("--shape", shape)]
    t0 = time.perf_counter()
    procs = {
        "single": subprocess.Popen(base + ["--mesh", "single", "--out", out],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True,
                                   env=env, cwd=ROOT),
        "multi": subprocess.Popen(base + ["--mesh", "multi", "--no-roofline"],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=env, cwd=ROOT),
        "single (MoE)": subprocess.Popen(
            run + moe_cells + ["--mesh", "single", "--no-roofline",
                               "--out", moe_out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT),
    }
    results = {}
    try:
        for kind, proc in procs.items():
            stdout, stderr = proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter()
                                                     - t0)))
            results[kind] = (proc.returncode, stdout, stderr,
                             time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for kind, (rc, stdout, stderr, secs) in results.items():
        lines = [ln for ln in stdout.splitlines() if ln.startswith("[")]
        for ln in lines:
            log(f"  (a) {ln}")
        bad = [ln for ln in lines if not ln.startswith(("[ok", "[skipped"))]
        log(f"  (a) --mesh {kind}: exit {rc}, {len(lines)} cells, done "
            f"after {secs:.1f} s [{smi}]")
        if rc != 0 or bad or not lines:
            fail(f"phase 20 (a) --mesh {kind}: exit {rc}, {bad}: "
                 f"{stderr[-2000:]}")
    with open(out) as f, open(moe_out) as g:
        return json.load(f), json.load(g)


def cut_shape(spec, name, **dims):
    """``spec``'s shape ``name`` with ``dims`` replaced (a cell's cut)."""
    import dataclasses

    shape = spec.shape(name)
    return dataclasses.replace(shape, dims={**shape.dims, **dims})


def card_cells(dev, flash_entry, gnn_entry):
    """Phase 20 (b)'s cells: ``(label, arch, shape spec, reduced, run,
    phase ms, phase peak MiB or None)``; ``run()`` makes the cell's
    inputs as its phase does and returns a call of one step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch import train as ltrain
    from repro_torch.models.recsys import bert4rec
    from repro_torch.models.transformer import prefill
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step

    lm = get_config(LM_ARCH)
    b4r = get_config("bert4rec")
    recsys_b = flash_entry["recsys_train_batch"]

    def prefill_run():
        cfg, params = serve.build(LM_ARCH, smoke=False, seed=0, device=dev)
        prompts = serve.make_prompts(cfg, LM_BATCH, LM_PROMPT, device=dev)

        def call():
            with torch.no_grad():
                return prefill(params, cfg, prompts)
        return call

    def train_run():
        cfg, state = ltrain.build(LM_ARCH, smoke=False, seed=0, device=dev)
        step = ltrain.make_step(cfg, total_steps=TRAIN_STEPS,
                                accum_steps=TRAIN_ACCUM)
        batch = ltrain.synthetic_batch(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, 0,
                                       0, dev)
        return lambda: step(state, batch)

    def gnn_run(arch):
        def run():
            mod, cfg, g = gnn_inputs(arch, dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            state = init_train_state(mod.init_params(gen, cfg))
            step = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b),
                                   AdamWConfig(**GNN_OPT))
            return lambda: step(state, g)
        return run

    def recsys_train_run():
        cfg = b4r.model
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = recsys_batch(cfg, recsys_b, gen, dev)
        state = init_train_state(recsys_params(cfg, dev))
        step = make_train_step(lambda p, x: bert4rec.loss_sampled(p, cfg, x),
                               AdamWConfig())
        return lambda: step(state, batch)

    def recsys_serve_run():
        cfg = b4r.model
        params = recsys_params(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        items = recsys_batch(cfg, b4r.shape("serve_p99").dims["batch"], gen,
                             dev)["items"]

        def call():
            with torch.no_grad():
                return torch.topk(bert4rec.serve_score(params, cfg, items),
                                  RECSYS_TOPK)
        return call

    models = gnn_entry["gnn_models"]
    cells = [
        ("llama3.2-1b:prefill", LM_ARCH,
         cut_shape(lm, "prefill_32k", seq_len=LM_PROMPT,
                   global_batch=LM_BATCH),
         f"prefill_32k's 32 x 32,768 -> {LM_BATCH} x {LM_PROMPT:,} "
         "(phase 16 (b))", prefill_run, flash_entry["lm_prefill_ms"], None),
        ("llama3.2-1b:train_4k", LM_ARCH,
         cut_shape(lm, "train_4k", seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH, accum_steps=TRAIN_ACCUM),
         f"train_4k's 256 x 4,096 in 8 micro-batches -> {TRAIN_BATCH} x "
         f"{TRAIN_SEQ:,} in {TRAIN_ACCUM} (phase 17 (a))", train_run,
         flash_entry["train_step_ms"], flash_entry["train_peak_mib"]),
    ]
    for arch, shape in (("gat-cora", "full_graph_sm"), ("pna", "molecule"),
                        ("nequip", "molecule"), ("mace", "molecule")):
        cells.append((f"{arch}:{shape}", arch, get_config(arch).shape(shape),
                      "", gnn_run(arch), models[arch]["step_ms"],
                      models[arch]["peak_mib"]))
    cells += [
        ("bert4rec:train_batch", "bert4rec",
         cut_shape(b4r, "train_batch", batch=recsys_b),
         f"train_batch's 65,536 -> {recsys_b:,} sequences (phase 19 (a))",
         recsys_train_run, flash_entry["recsys_step_ms"],
         flash_entry["recsys_peak_gib"] * 1024),
        ("bert4rec:serve_p99", "bert4rec", b4r.shape("serve_p99"), "",
         recsys_serve_run, flash_entry["recsys_serve_p99_ms"], None),
    ]
    return cells


def dryrun_phase(dev, flash_entry, gnn_entry, smi):
    """Phase 20: the dry-run's subprocesses (a), then the roofline of the
    cells phases 16-19 ran against the card (b), and the traces' silence
    on the card (c).  Returns the rows of (a) and (b) for the log."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash_backward_cuda, flash_cuda
    from repro_torch.kernels.segsum import segsum_cuda
    from repro_torch.launch.mesh import init_local_group
    from repro_torch.launch.tasks import build_task
    from repro_torch.roofline.analysis import analyze_task

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    rows, moe_rows = dryrun_subprocesses(smi)
    log(f"  {at()} (a) done")

    # (b) the predictions: each cell traced in this process on a 1 x 1
    # mesh over an NCCL group of one.
    store = tempfile.mkdtemp(prefix="chip-smoke-dryrun-group-")
    init_local_group(0, 1, store, "cuda")
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        torch.cuda.synchronize()
        counts = lambda: (flash_cuda.launches, flash_backward_cuda.launches,
                          segsum_cuda.launches, torch.cuda.memory_allocated())
        before = counts()
        cells = card_cells(dev, flash_entry, gnn_entry)
        preds = {}
        for label, arch, shape, reduced, _, _, _ in cells:
            task = build_task(get_config(arch), shape, mesh)
            rep = analyze_task(task)
            preds[label] = (task.trace(), task.memory_per_device(), rep)
            del task
        torch.cuda.synchronize()
        after = counts()
    finally:
        dist.destroy_process_group()
    log(f"  {at()} (b) {len(preds)} cells traced on a 1 x 1 mesh")
    # (c) nothing ran on the card.
    log(f"  (c) K4 forward / backward / K2a launches and bytes allocated "
        f"before the traces {before}, after {after}")
    if after != before:
        fail(f"phase 20 (c): the dry-run touched the card: {before} -> "
             f"{after}")

    # (b) the measurements: each cell once more on the card.
    out = []
    for label, arch, shape, reduced, run, phase_ms, phase_mib in cells:
        trace, mem, rep = preds[label]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        call = run()
        call()                                   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        own_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - held
        del call
        pred_peak = trace.peak_bytes
        ratio = pred_peak / peak
        row = dict(cell=label, reduced=reduced, phase_ms=phase_ms,
                   phase_peak_mib=phase_mib, own_ms=own_ms,
                   step_time_s=rep.step_time_s, dominant=rep.dominant,
                   share=rep.step_time_s * 1e3 / phase_ms,
                   useful_ratio=rep.useful_ratio,
                   roofline_fraction=rep.roofline_fraction,
                   argument_gb=mem["argument"] / 1e9,
                   temp_gb=mem["temp"] / 1e9, output_gb=mem["output"] / 1e9,
                   predicted_peak_gb=pred_peak / 1e9,
                   measured_peak_gb=peak / 1e9, memory_ratio=ratio,
                   flops=trace.flops, bytes=trace.bytes,
                   trace_s=trace.seconds)
        out.append(row)
        log(f"  (b) {label}{' reduced: ' + reduced if reduced else ''}: "
            f"phase {phase_ms:.2f} ms"
            + (f" (peak {phase_mib:.0f} MiB)" if phase_mib else "")
            + f", here {own_ms:.2f} ms; roofline {rep.step_time_s * 1e3:.3f} "
            f"ms ({rep.dominant}), {row['share']:.1%} of the phase's; "
            f"useful_ratio {rep.useful_ratio:.3f}; predicted args "
            f"{row['argument_gb']:.3f} + temp {row['temp_gb']:.3f} + out "
            f"{row['output_gb']:.3f} = peak {row['predicted_peak_gb']:.3f} "
            f"GB, measured {row['measured_peak_gb']:.3f} GB (ratio "
            f"{ratio:.2f}); traced in {trace.seconds:.1f} s [{smi}]")
        if not 1 / MEMORY_RATIO_MAX <= ratio <= MEMORY_RATIO_MAX:
            fail(f"phase 20 (b) {label}: predicted peak "
                 f"{pred_peak / 1e9:.3f} GB, measured {peak / 1e9:.3f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {at()} phase 20 done")
    return {"dryrun_card": smi, "dryrun_single": rows,
            "dryrun_moe": moe_rows, "dryrun_cells": out}


# Phase 21: the dense LM partitioned by DTensor placements on the card.
MESH_LOSS_TOL = 1e-5      # (a): of the plain step's loss
MESH_GNORM_TOL = 1e-4     # (a): of its grad_norm
MESH_PARAM_TOL = 1e-4     # (a): of each leaf's largest magnitude
MESH_FLOPS_TOL = 1e-2     # (c): per-device FLOPs against the global trace
# (b): the partitioned logits against the unpartitioned route's, of the
# largest magnitude.  On the 1 x 1 mesh both run the same kernels on the
# same inputs (measured equal), so a wrong cache write or position shows.
MESH_LOGITS_TOL = 1e-5


def whole(x):
    """A DTensor gathered (on one rank: its local tensor), else ``x``."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def mesh_train(dev, mesh, spec, smi):
    """Phase 21 (a): the partitioned train step beside phase 17's plain
    step, in turns, on two states from the same seed."""
    import torch

    from repro_torch.kernels.flash import flash_backward_cuda, flash_cuda
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.tasks import build_task, distribute_tree
    from repro_torch.train.tree import leaves

    task = build_task(spec, cut_shape(
        spec, "train_4k", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        accum_steps=TRAIN_ACCUM), mesh)
    if not (task.partitioned and task.per_device):
        fail(f"phase 21 (a): {task.name} is not partitioned")
    cfg, plain = ltrain.build(LM_ARCH, smoke=False, seed=0, device=dev)
    _, fresh = ltrain.build(LM_ARCH, smoke=False, seed=0, device=dev)
    state = distribute_tree(fresh, task.placements[0], mesh)
    del fresh
    plain_step = ltrain.make_step(cfg, total_steps=TRAIN_STEPS,
                                  accum_steps=TRAIN_ACCUM)
    rows, fwd, bwd, peak = [], [], [], 0
    errs = {}
    with plain_versions_raise():
        for i in range(TRAIN_STEPS):
            batch = ltrain.synthetic_batch(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                           i, 0, dev)
            d_batch = distribute_tree(batch, task.placements[1], mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain, pm = plain_step(plain, batch)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            flash_cuda.launches = flash_backward_cuda.launches = 0
            t0 = time.perf_counter()
            state, m = task.fn(state, d_batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            fwd.append(flash_cuda.launches)
            bwd.append(flash_backward_cuda.launches)
            peak = max(peak, torch.cuda.max_memory_allocated(dev) - held)
            got = torch.stack([whole(m[k]) for k in ("loss", "grad_norm",
                                                     "lr")]).tolist()
            want = torch.stack([pm[k] for k in ("loss", "grad_norm",
                                                "lr")]).tolist()
            rows.append((ms, plain_ms, got, want))
            if i == 0:
                errs = {
                    "loss": abs(got[0] - want[0]) / abs(want[0]),
                    "grad_norm": abs(got[1] - want[1]) / abs(want[1]),
                    "params": max(rel_max(whole(a), b) for a, b in zip(
                        leaves(state.params), leaves(plain.params)))}
            log(f"  (a) step {i}: partitioned {ms:.1f} ms, plain {plain_ms:.1f}"
                f" ms; loss {got[0]:.6f} / {want[0]:.6f}, grad_norm "
                f"{got[1]:.6f} / {want[1]:.6f}; K4 {fwd[-1]} forward "
                f"launches, {bwd[-1]} backward")
    if fwd != [TRAIN_FWD_PER_STEP] * TRAIN_STEPS or bwd != [
            TRAIN_BWD_PER_STEP] * TRAIN_STEPS:
        fail(f"phase 21 (a): K4 forward launches {fwd} (expected "
             f"{TRAIN_FWD_PER_STEP} a step), backward {bwd} (expected "
             f"{TRAIN_BWD_PER_STEP})")
    if not (errs["loss"] <= MESH_LOSS_TOL
            and errs["grad_norm"] <= MESH_GNORM_TOL
            and errs["params"] <= MESH_PARAM_TOL):
        fail(f"phase 21 (a): the partitioned step against the plain one: "
             f"{errs} (limits {MESH_LOSS_TOL}, {MESH_GNORM_TOL}, "
             f"{MESH_PARAM_TOL})")
    if not all(math.isfinite(x) for r in rows for x in r[2][:2]):
        fail(f"phase 21 (a): non-finite metrics {rows}")
    step_ms = statistics.median(r[0] for r in rows[1:])
    plain_ms = statistics.median(r[1] for r in rows[1:])
    log(f"  (a) {LM_ARCH} full width partitioned over {mesh}: step "
        f"{step_ms:.1f} ms against the plain step's {plain_ms:.1f} ms "
        f"(medians of steps 1-{TRAIN_STEPS - 1}, in turns); first step "
        f"against the plain one: loss {errs['loss']:.3g}, grad_norm "
        f"{errs['grad_norm']:.3g}, parameters {errs['params']:.3g} of a "
        f"leaf's largest magnitude; peak {peak / 2**20:.0f} MiB over the "
        f"{held / 2**20:.0f} MiB held (both states); no plain attention "
        f"ran [{smi}]")
    del state, plain, batch, d_batch
    torch.cuda.empty_cache()
    return {"mesh_train_launches_fwd_per_step": fwd[-1],
            "mesh_train_launches_bwd_per_step": bwd[-1],
            "mesh_train_step_ms": step_ms,
            "mesh_train_plain_step_ms": plain_ms,
            "mesh_train_steps_ms": [r[0] for r in rows],
            "mesh_train_plain_steps_ms": [r[1] for r in rows],
            "mesh_train_loss_rel_err": errs["loss"],
            "mesh_train_grad_norm_rel_err": errs["grad_norm"],
            "mesh_train_param_rel_err": errs["params"],
            "mesh_train_peak_mib": peak / 2**20,
            "mesh_train_held_mib": held / 2**20}


def mesh_serve(dev, mesh, spec, flush, smi):
    """Phase 21 (b): the partitioned prefill and decode beside the
    unpartitioned route, on phase 16's weights and prompts."""
    import torch

    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.launch import serve
    from repro_torch.launch.tasks import build_task, distribute_tree
    from repro_torch.models.transformer import init_cache, prefill, serve_step

    cfg, params = serve.build(LM_ARCH, smoke=False, seed=0, device=dev)
    prompts = serve.make_prompts(cfg, LM_BATCH, LM_PROMPT, device=dev)
    pre = build_task(spec, cut_shape(spec, "prefill_32k", seq_len=LM_PROMPT,
                                     global_batch=LM_BATCH), mesh)
    dec = build_task(spec, cut_shape(spec, "decode_32k",
                                     seq_len=LM_PROMPT + LM_GEN,
                                     global_batch=LM_BATCH), mesh)
    if not (pre.partitioned and dec.partitioned):
        fail("phase 21 (b): the serving cells are not partitioned")
    with torch.no_grad(), plain_versions_raise():
        d_params, d_prompts = pre.distribute((params, prompts))
        last, cache = prefill(params, cfg, prompts)
        flash_cuda.launches = 0
        d_last, d_cache = pre.fn(d_params, d_prompts)
        torch.cuda.synchronize()
        per_prefill = flash_cuda.launches
        pre_err = rel_max(whole(d_last), last)
        ids_differ = int((whole(d_last).argmax(-1) != last.argmax(-1)).sum())
        full = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
        d_full = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
        for key in full:
            full[key][:, :, :LM_PROMPT].copy_(cache[key])
            d_full[key][:, :, :LM_PROMPT].copy_(whole(d_cache[key]))
        del cache, d_cache
        d_full = distribute_tree(d_full, dec.placements[1], mesh)
        tok = torch.argmax(last, dim=-1)

        def d_args(t, pos):
            return (distribute_tree(t, dec.placements[2], mesh),
                    distribute_tree(torch.tensor(pos, dtype=torch.int32,
                                                 device=dev),
                                    dec.placements[3], mesh))

        per_step, dec_err = [], 0.0
        for i in range(LM_GEN):
            lg, full = serve_step(params, cfg, full, tok, LM_PROMPT + i)
            flash_cuda.launches = 0
            d_lg, d_full = dec.fn(d_params, d_full, *d_args(
                tok, LM_PROMPT + i))
            torch.cuda.synchronize()
            per_step.append(flash_cuda.launches)
            dec_err = max(dec_err, rel_max(whole(d_lg), lg))
            tok = torch.argmax(lg, dim=-1)
            ids_differ += int((whole(d_lg).argmax(-1) != tok).sum())
        if per_prefill != cfg.n_layers or any(per_step):
            fail(f"phase 21 (b): K4 launched {per_prefill} times a "
                 f"partitioned prefill (expected {cfg.n_layers}) and "
                 f"{per_step} a decode step (expected none)")
        if not (pre_err <= MESH_LOGITS_TOL and dec_err <= MESH_LOGITS_TOL
                and ids_differ == 0 and torch.isfinite(whole(d_last)).all()):
            fail(f"phase 21 (b): partitioned logits against the "
                 f"unpartitioned route: prefill {pre_err:.3g}, decode "
                 f"{dec_err:.3g} of the largest magnitude (limit "
                 f"{MESH_LOGITS_TOL}); {ids_differ} greedy ids differ")
        pre_ms, d_pre_ms = time_two(
            lambda: prefill(params, cfg, prompts),
            lambda: pre.fn(d_params, d_prompts), flush, n_timed=3, n_warm=1)
        step_args = d_args(tok, LM_PROMPT)
        step_ms, d_step_ms = time_two(
            lambda: serve_step(params, cfg, full, tok, LM_PROMPT),
            lambda: dec.fn(d_params, d_full, *step_args), flush,
            n_timed=5, n_warm=1)
        prof = {}
        for label, call, n in (
                ("prefill", lambda: pre.fn(d_params, d_prompts), 2),
                ("decode step", lambda: dec.fn(d_params, d_full,
                                               *step_args), 10),
                ("plain decode step", lambda: serve_step(
                    params, cfg, full, tok, LM_PROMPT), 10)):
            wall, busy, n_k, _ = profiled(call, n)
            prof[label] = (wall, 1.0 - busy / wall, n_k)
            log(f"  (b) {label} under torch.profiler: wall {wall:.3f} ms, "
                f"idle {1.0 - busy / wall:.1%}, {n_k:.0f} kernels a call")
    log(f"  (b) partitioned prefill {LM_BATCH} x {LM_PROMPT}: K4 "
        f"{per_prefill} launches, logits within {pre_err:.3g} of the "
        f"unpartitioned route's; {LM_GEN} decode steps: K4 "
        f"{sum(per_step)} launches, logits within {dec_err:.3g} (limit "
        f"{MESH_LOGITS_TOL}), every greedy id the same; prefill {d_pre_ms:.2f} ms against "
        f"{pre_ms:.2f} ms unpartitioned, decode {d_step_ms:.3f} ms a step "
        f"against {step_ms:.3f} ms (in turns, L2 flushed) [{smi}]")
    del params, d_params, full, d_full, prompts, d_prompts
    torch.cuda.empty_cache()
    return {"mesh_launches_prefill": per_prefill,
            "mesh_launches_decode": max(per_step),
            "mesh_prefill_rel_err": pre_err, "mesh_decode_rel_err": dec_err,
            "mesh_ids_differ": ids_differ,
            "mesh_prefill_ms": d_pre_ms, "mesh_plain_prefill_ms": pre_ms,
            "mesh_decode_ms": d_step_ms, "mesh_plain_decode_ms": step_ms,
            "mesh_prefill_idle_share": prof["prefill"][1],
            "mesh_decode_idle_share": prof["decode step"][1],
            "mesh_decode_kernels": prof["decode step"][2],
            "mesh_plain_decode_kernels": prof["plain decode step"][2],
            "mesh_plain_decode_idle_share": prof["plain decode step"][1]}


def mesh_traces(mesh, spec, dryrun_rows):
    """Phase 21 (c): phase 20 (a)'s LM rows partitioned, and each
    llama3.2-1b cell of phase 20 (b) on this 1 x 1 mesh traced
    partitioned within ``MESH_FLOPS_TOL`` of its global trace."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.tasks import build_task

    lm_rows = [r for r in dryrun_rows if r["cell"].startswith(LM_ARCH)
               and r["status"] == "ok"]
    for r in lm_rows:
        counts = r["collective_counts"]
        if not (r["partitioned"] and counts and sum(counts.values()) > 0
                and r["memory"]["temp_gb"] is not None):
            fail(f"phase 21 (c): phase 20 (a)'s row {r['cell']} is not "
                 f"partitioned with collectives: {r}")
    log(f"  (c) phase 20 (a): {len(lm_rows)} {LM_ARCH} rows partitioned, "
        "collectives " + "; ".join(
            f"{r['cell']} " + ", ".join(
                f"{k} {n}" for k, n in r["collective_counts"].items() if n)
            for r in lm_rows))
    out = {}
    for label, shape in (
            ("prefill", cut_shape(spec, "prefill_32k", seq_len=LM_PROMPT,
                                  global_batch=LM_BATCH)),
            ("train", cut_shape(spec, "train_4k", seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH,
                                accum_steps=TRAIN_ACCUM))):
        part = build_task(spec, shape, mesh).trace()
        glob = build_task(spec, shape, mesh_shape(mesh)).trace()
        ratio = part.flops / glob.flops
        if not abs(ratio - 1) <= MESH_FLOPS_TOL:
            fail(f"phase 21 (c) {label}: per-device FLOPs {part.flops:.6g}, "
                 f"global trace {glob.flops:.6g}")
        log(f"  (c) {LM_ARCH} {label} on {mesh}: per-device FLOPs "
            f"{part.flops:.6g} = {ratio:.6f} x the global trace's; traced in "
            f"{part.seconds:.1f} s ({part.n_ops} ops) against "
            f"{glob.seconds:.1f} s ({glob.n_ops} ops) unpartitioned")
        out.update({f"mesh_{label}_flops_ratio": ratio,
                    f"mesh_{label}_trace_s": part.seconds,
                    f"mesh_{label}_global_trace_s": glob.seconds})
    return out


def mesh_phase(dev, flush, smi, dryrun_rows):
    """Phase 21: the dense LM partitioned by DTensor placements on a
    1 x 1 mesh over an NCCL group of one; returns K4's ``mesh_*`` keys."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_local_group, make_mesh

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    spec = get_config(LM_ARCH)
    init_local_group(0, 1, tempfile.mkdtemp(prefix="chip-smoke-mesh-"),
                     "cuda")
    try:
        mesh = make_mesh((1, 1))
        keys = mesh_train(dev, mesh, spec, smi)
        log(f"  {at()} (a) done")
        keys.update(mesh_serve(dev, mesh, spec, flush, smi))
        log(f"  {at()} (b) done")
        keys.update(mesh_traces(mesh, spec, dryrun_rows))
        log(f"  {at()} phase 21 done")
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return keys


# Phase 22: the MoE LM partitioned by DTensor placements on the card.
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_SERVE_LAYERS = 2      # (a): of the model's 94, printed as reduced
MOE_TRAIN_LAYERS = 1      # (b)
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 4096, 16       # (a)
MOE_TRAIN_BATCH, MOE_TRAIN_ACCUM = 4, 2            # (b): train_4k's 256
MOE_TRAIN_FWD = 4          # (b) 1 layer x (forward + remat) x 2 micro-batches
MOE_TRAIN_BWD = 2          # (b) 1 layer x 2 micro-batches
# (a), (b): the partitioned route against the plain one; on the 1 x 1
# mesh both run the same kernels on the same inputs (the combine adds
# each token's slots in a fixed order: no atomics), so a limit is
# widened only to what two plain runs themselves differ by.
MOE_LOGITS_TOL = 1e-5     # of the largest magnitude
MOE_LOSS_TOL = 1e-5
MOE_GNORM_TOL = 1e-4
MOE_PARAM_TOL = 1e-4      # of each leaf's largest magnitude


def moe_spec(layers):
    """``MOE_ARCH``'s full-width spec at depth ``layers``."""
    import dataclasses

    from repro_torch.configs import get_config

    spec = get_config(MOE_ARCH)
    return dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, n_layers=layers))


def moe_params(cfg, dev):
    """Random float32 weights of ``cfg`` from seed 0 on ``dev``."""
    import torch

    from repro_torch.models.transformer import init_params

    return init_params(torch.Generator(device=dev).manual_seed(0), cfg)


def moe_serve(dev, mesh, flush, smi):
    """Phase 22 (a): the partitioned prefill and decode beside the plain
    route on the same weights, at depth ``MOE_SERVE_LAYERS``."""
    import torch

    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.launch import serve
    from repro_torch.launch.tasks import build_task, distribute_tree
    from repro_torch.models.moe import capacity, n_groups
    from repro_torch.models.transformer import init_cache, prefill, serve_step

    spec = moe_spec(MOE_SERVE_LAYERS)
    cfg = spec.model
    params = moe_params(cfg, dev)
    prompts = serve.make_prompts(cfg, MOE_BATCH, MOE_PROMPT, device=dev)
    pre = build_task(spec, cut_shape(spec, "prefill_32k", seq_len=MOE_PROMPT,
                                     global_batch=MOE_BATCH), mesh)
    dec = build_task(spec, cut_shape(spec, "decode_32k",
                                     seq_len=MOE_PROMPT + MOE_GEN,
                                     global_batch=MOE_BATCH), mesh)
    if not (pre.partitioned and dec.partitioned):
        fail("phase 22 (a): the serving cells are not partitioned")
    t = MOE_BATCH * MOE_PROMPT
    g = n_groups(cfg.moe, t)
    route = (f"prefill {t} tokens in {g} groups of {t // g} (capacity "
             f"{capacity(cfg.moe, t // g)}), a decode step's {MOE_BATCH} "
             f"tokens in {n_groups(cfg.moe, MOE_BATCH)} (capacity "
             f"{capacity(cfg.moe, MOE_BATCH)})")
    with torch.no_grad(), plain_versions_raise():
        d_params, d_prompts = pre.distribute((params, prompts))
        last, cache = prefill(params, cfg, prompts)
        again, _ = prefill(params, cfg, prompts)
        plain_spread = rel_max(again, last)
        del again
        flash_cuda.launches = 0
        d_last, d_cache = pre.fn(d_params, d_prompts)
        torch.cuda.synchronize()
        per_prefill = flash_cuda.launches
        pre_err = rel_max(whole(d_last), last)
        ids_differ = int((whole(d_last).argmax(-1) != last.argmax(-1)).sum())
        full = init_cache(cfg, MOE_BATCH, MOE_PROMPT + MOE_GEN, device=dev)
        d_full = init_cache(cfg, MOE_BATCH, MOE_PROMPT + MOE_GEN, device=dev)
        for key in full:
            full[key][:, :, :MOE_PROMPT].copy_(cache[key])
            d_full[key][:, :, :MOE_PROMPT].copy_(whole(d_cache[key]))
        del cache, d_cache
        d_full = distribute_tree(d_full, dec.placements[1], mesh)
        tok = torch.argmax(last, dim=-1)

        def d_args(tk, pos):
            return (distribute_tree(tk, dec.placements[2], mesh),
                    distribute_tree(torch.tensor(pos, dtype=torch.int32,
                                                 device=dev),
                                    dec.placements[3], mesh))

        per_step, dec_err = [], 0.0
        for i in range(MOE_GEN):
            lg, full = serve_step(params, cfg, full, tok, MOE_PROMPT + i)
            flash_cuda.launches = 0
            d_lg, d_full = dec.fn(d_params, d_full, *d_args(
                tok, MOE_PROMPT + i))
            torch.cuda.synchronize()
            per_step.append(flash_cuda.launches)
            dec_err = max(dec_err, rel_max(whole(d_lg), lg))
            tok = torch.argmax(lg, dim=-1)
            ids_differ += int((whole(d_lg).argmax(-1) != tok).sum())
        limit = max(MOE_LOGITS_TOL, plain_spread)
        if per_prefill != cfg.n_layers or any(per_step):
            fail(f"phase 22 (a): K4 launched {per_prefill} times a "
                 f"partitioned prefill (expected {cfg.n_layers}) and "
                 f"{per_step} a decode step (expected none)")
        if not (pre_err <= limit and dec_err <= limit and ids_differ == 0
                and torch.isfinite(whole(d_last)).all()):
            fail(f"phase 22 (a): partitioned logits against the plain "
                 f"route: prefill {pre_err:.3g}, decode {dec_err:.3g} of the "
                 f"largest magnitude (limit {limit:.3g}); {ids_differ} "
                 "greedy ids differ")
        pre_ms, d_pre_ms = time_two(
            lambda: prefill(params, cfg, prompts),
            lambda: pre.fn(d_params, d_prompts), flush, n_timed=3, n_warm=1)
        step_args = d_args(tok, MOE_PROMPT)
        step_ms, d_step_ms = time_two(
            lambda: serve_step(params, cfg, full, tok, MOE_PROMPT),
            lambda: dec.fn(d_params, d_full, *step_args), flush,
            n_timed=5, n_warm=1)
        prof = {}
        for label, call, n in (
                ("prefill", lambda: pre.fn(d_params, d_prompts), 1),
                ("plain prefill", lambda: prefill(params, cfg, prompts), 1),
                ("decode step", lambda: dec.fn(d_params, d_full,
                                               *step_args), 5),
                ("plain decode step", lambda: serve_step(
                    params, cfg, full, tok, MOE_PROMPT), 5)):
            wall, busy, n_k, rows = profiled(call, n)
            prof[label] = (wall, 1.0 - busy / wall, n_k)
            log(f"  (a) {label} under torch.profiler: wall {wall:.3f} ms, "
                f"idle {1.0 - busy / wall:.1%}, {n_k:.0f} kernels a call; "
                "most device time: " + "; ".join(
                    f"{name[:60]} {ms:.3f} ms" for name, ms in rows[:4]))
        peak = torch.cuda.max_memory_allocated(dev)
    log(f"  (a) {MOE_ARCH} reduced: {cfg.n_layers} of 94 layers, full width "
        f"(d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV "
        f"of {cfg.head_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
        f"of d_ff {cfg.moe.d_ff}, vocab {cfg.vocab}); {route}")
    log(f"  (a) partitioned prefill {MOE_BATCH} x {MOE_PROMPT}: K4 "
        f"{per_prefill} launches, logits within {pre_err:.3g} of the plain "
        f"route's (two plain runs {plain_spread:.3g}); {MOE_GEN} decode "
        f"steps: K4 {sum(per_step)} launches, logits within {dec_err:.3g} "
        f"(limit {limit:.3g}), every greedy id the same; prefill "
        f"{d_pre_ms:.2f} ms against {pre_ms:.2f} ms plain, decode "
        f"{d_step_ms:.3f} ms a step against {step_ms:.3f} ms (in turns, L2 "
        f"flushed); peak {peak / 2**30:.1f} GiB [{smi}]")
    del params, d_params, full, d_full, prompts, d_prompts
    torch.cuda.empty_cache()
    return {"moe_launches_prefill": per_prefill,
            "moe_launches_decode": max(per_step),
            "moe_prefill_rel_err": pre_err, "moe_decode_rel_err": dec_err,
            "moe_plain_spread": plain_spread, "moe_ids_differ": ids_differ,
            "moe_prefill_ms": d_pre_ms, "moe_plain_prefill_ms": pre_ms,
            "moe_decode_ms": d_step_ms, "moe_plain_decode_ms": step_ms,
            "moe_prefill_idle_share": prof["prefill"][1],
            "moe_plain_prefill_idle_share": prof["plain prefill"][1],
            "moe_prefill_kernels": prof["prefill"][2],
            "moe_decode_idle_share": prof["decode step"][1],
            "moe_plain_decode_idle_share": prof["plain decode step"][1],
            "moe_decode_kernels": prof["decode step"][2],
            "moe_plain_decode_kernels": prof["plain decode step"][2],
            "moe_serve_peak_gib": peak / 2**30}


def moe_train(dev, mesh, smi):
    """Phase 22 (b): the partitioned ``train_4k`` step at depth
    ``MOE_TRAIN_LAYERS`` beside the plain step.  Two states do not fit:
    the plain step runs first from seed 0 and its updated leaves wait on
    the host; the partitioned step then runs on a state rebuilt from the
    same seed.  Each route's second step is its timed one."""
    import gc

    import torch

    from repro_torch.kernels.flash import flash_backward_cuda, flash_cuda
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.tasks import build_task, distribute_tree
    from repro_torch.models.moe import capacity, n_groups
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves

    spec = moe_spec(MOE_TRAIN_LAYERS)
    cfg = spec.model
    task = build_task(spec, cut_shape(
        spec, "train_4k", seq_len=TRAIN_SEQ, global_batch=MOE_TRAIN_BATCH,
        accum_steps=MOE_TRAIN_ACCUM), mesh)
    if not (task.partitioned and task.per_device):
        fail(f"phase 22 (b): {task.name} is not partitioned")
    t = MOE_TRAIN_BATCH * TRAIN_SEQ // MOE_TRAIN_ACCUM
    g = n_groups(cfg.moe, t)
    plain_step = make_train_step(lambda p, b: loss_fn(p, cfg, b),
                                 AdamWConfig(), MOE_TRAIN_ACCUM)
    batches = [ltrain.synthetic_batch(cfg.vocab, MOE_TRAIN_BATCH, TRAIN_SEQ,
                                      i, 0, dev) for i in range(2)]

    def run(step, state, batch):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        flash_cuda.launches = flash_backward_cuda.launches = 0
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return state, m, ms, (flash_cuda.launches,
                              flash_backward_cuda.launches), (
            torch.cuda.max_memory_allocated(dev) - held, held)

    rows = {}
    with plain_versions_raise():
        state = init_train_state(moe_params(cfg, dev))
        state, pm, ms0, _, _ = run(plain_step, state, batches[0])
        want = [p.detach().to("cpu", copy=True)
                for p in leaves(state.params)]
        metrics = torch.stack([pm[k] for k in ("loss", "grad_norm",
                                               "lr")]).tolist()
        state, _, ms1, counts, (peak, held) = run(plain_step, state,
                                                  batches[1])
        rows["plain"] = (ms0, ms1, counts, peak, held)
        del state, pm
        gc.collect()
        torch.cuda.empty_cache()
        state = distribute_tree(init_train_state(moe_params(cfg, dev)),
                                task.placements[0], mesh)
        d_batches = [distribute_tree(b, task.placements[1], mesh)
                     for b in batches]
        state, m, ms0, counts0, _ = run(task.fn, state, d_batches[0])
        got = torch.stack([whole(m[k]) for k in ("loss", "grad_norm",
                                                 "lr")]).tolist()
        errs = {"loss": abs(got[0] - metrics[0]) / abs(metrics[0]),
                "grad_norm": abs(got[1] - metrics[1]) / abs(metrics[1]),
                "params": max(rel_max(whole(a), b.to(dev)) for a, b in zip(
                    leaves(state.params), want))}
        del want
        state, _, ms1, counts, (peak, held) = run(task.fn, state,
                                                  d_batches[1])
        rows["partitioned"] = (ms0, ms1, counts, peak, held)
        wall, busy, _, kernels = profiled(
            lambda: task.fn(state, d_batches[1]), 1)
    if counts0 != (MOE_TRAIN_FWD, MOE_TRAIN_BWD) or counts != counts0:
        fail(f"phase 22 (b): K4 forward / backward launches a partitioned "
             f"step {counts0}, {counts} (expected {MOE_TRAIN_FWD}, "
             f"{MOE_TRAIN_BWD})")
    if not (errs["loss"] <= MOE_LOSS_TOL and errs["grad_norm"]
            <= MOE_GNORM_TOL and errs["params"] <= MOE_PARAM_TOL
            and all(math.isfinite(x) for x in got[:2])):
        fail(f"phase 22 (b): the partitioned step against the plain one: "
             f"{errs} (limits {MOE_LOSS_TOL}, {MOE_GNORM_TOL}, "
             f"{MOE_PARAM_TOL}); metrics {got} / {metrics}")
    log(f"  (b) a partitioned step under torch.profiler: wall {wall:.1f} ms, "
        f"idle {1.0 - busy / wall:.1%}; most device time: " + "; ".join(
            f"{name[:60]} {ms:.1f} ms" for name, ms in kernels[:5]))
    for route, (ms0, ms1, counts, peak, held) in rows.items():
        log(f"  (b) {route} step: {ms0:.1f} ms first, {ms1:.1f} ms second; "
            f"K4 {counts[0]} forward launches, {counts[1]} backward; peak "
            f"{peak / 2**30:.2f} GiB over the {held / 2**30:.2f} GiB held")
    log(f"  (b) {MOE_ARCH} reduced: {cfg.n_layers} of 94 layers, train_4k's "
        f"256 x {TRAIN_SEQ} in 8 micro-batches -> {MOE_TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {MOE_TRAIN_ACCUM} ({t} tokens each: {g} groups of "
        f"{t // g}, capacity {capacity(cfg.moe, t // g)}); first step against "
        f"the plain one: loss {errs['loss']:.3g}, grad_norm "
        f"{errs['grad_norm']:.3g}, parameters {errs['params']:.3g} of a "
        f"leaf's largest magnitude; no plain attention ran [{smi}]")
    del state, d_batches, batches
    gc.collect()
    torch.cuda.empty_cache()
    part, plain = rows["partitioned"], rows["plain"]
    return {"moe_train_launches_fwd_per_step": counts[0],
            "moe_train_launches_bwd_per_step": counts[1],
            "moe_train_step_ms": part[1], "moe_train_plain_step_ms": plain[1],
            "moe_train_first_step_ms": part[0],
            "moe_train_plain_first_step_ms": plain[0],
            "moe_train_loss_rel_err": errs["loss"],
            "moe_train_grad_norm_rel_err": errs["grad_norm"],
            "moe_train_param_rel_err": errs["params"],
            "moe_train_idle_share": 1.0 - busy / wall,
            "moe_train_peak_gib": part[3] / 2**30,
            "moe_train_plain_peak_gib": plain[3] / 2**30,
            "moe_train_held_gib": part[4] / 2**30}


def moe_traces(mesh, moe_rows):
    """Phase 22 (c): phase 20 (a)'s MoE rows partitioned with
    collectives, and (a)'s and (b)'s cells traced partitioned on this
    1 x 1 mesh within ``MESH_FLOPS_TOL`` of their global traces."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.tasks import build_task

    ok = [r for r in moe_rows if r["status"] == "ok"]
    for r in ok:
        counts = r["collective_counts"]
        if not (r["partitioned"] and counts and sum(counts.values()) > 0
                and r["memory"]["temp_gb"] is not None):
            fail(f"phase 22 (c): phase 20 (a)'s row {r['cell']} is not "
                 f"partitioned with collectives: {r}")
    if not ok:
        fail("phase 22 (c): phase 20 (a) has no MoE row")
    log(f"  (c) phase 20 (a): {len(ok)} {MOE_ARCH} rows partitioned, "
        "collectives " + "; ".join(
            f"{r['cell']}@{r['mesh']} " + ", ".join(
                f"{k} {n}" for k, n in r["collective_counts"].items() if n)
            for r in ok))
    serve_spec, train_spec = (moe_spec(MOE_SERVE_LAYERS),
                              moe_spec(MOE_TRAIN_LAYERS))
    out = {}
    for label, spec, shape in (
            ("prefill", serve_spec, cut_shape(
                serve_spec, "prefill_32k", seq_len=MOE_PROMPT,
                global_batch=MOE_BATCH)),
            ("decode", serve_spec, cut_shape(
                serve_spec, "decode_32k", seq_len=MOE_PROMPT + MOE_GEN,
                global_batch=MOE_BATCH)),
            ("train", train_spec, cut_shape(
                train_spec, "train_4k", seq_len=TRAIN_SEQ,
                global_batch=MOE_TRAIN_BATCH, accum_steps=MOE_TRAIN_ACCUM))):
        part = build_task(spec, shape, mesh).trace()
        glob = build_task(spec, shape, mesh_shape(mesh)).trace()
        ratio = part.flops / glob.flops
        if not abs(ratio - 1) <= MESH_FLOPS_TOL:
            fail(f"phase 22 (c) {label}: per-device FLOPs {part.flops:.6g}, "
                 f"global trace {glob.flops:.6g}")
        log(f"  (c) {MOE_ARCH} {label} on {mesh}: per-device FLOPs "
            f"{part.flops:.6g} = {ratio:.6f} x the global trace's; traced in "
            f"{part.seconds:.1f} s ({part.n_ops} ops) against "
            f"{glob.seconds:.1f} s ({glob.n_ops} ops) unpartitioned")
        out.update({f"moe_{label}_flops_ratio": ratio,
                    f"moe_{label}_trace_s": part.seconds,
                    f"moe_{label}_global_trace_s": glob.seconds})
    return out


def moe_phase(dev, flush, smi, moe_rows):
    """Phase 22: the MoE LM partitioned by DTensor placements on a
    1 x 1 mesh over an NCCL group of one; returns K4's ``moe_*`` keys."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_local_group, make_mesh

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    init_local_group(0, 1, tempfile.mkdtemp(prefix="chip-smoke-moe-"),
                     "cuda")
    try:
        mesh = make_mesh((1, 1))
        keys = moe_serve(dev, mesh, flush, smi)
        log(f"  {at()} (a) done")
        keys.update(moe_train(dev, mesh, smi))
        log(f"  {at()} (b) done")
        keys.update(moe_traces(mesh, moe_rows))
        log(f"  {at()} phase 22 done")
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return keys


# Phase 23: BERT4Rec's cells partitioned by DTensor placements on the card.
RECSYS_MESH_TIMED = 5     # (b): pairs in turns, medians


def recsys_mesh_train(dev, mesh, spec, b, smi):
    """Phase 23 (a): the partitioned ``train_batch`` step at phase 19
    (a)'s batch beside phase 19's plain step, in turns, on two states
    from the same seed and one batch: loss, ``grad_norm`` and every
    parameter bitwise the plain step's after each step, 2 K4 forward
    and 2 backward launches a partitioned step."""
    import torch

    from repro_torch.kernels.flash import flash_backward_cuda, flash_cuda
    from repro_torch.launch.tasks import build_task, distribute_tree
    from repro_torch.models.recsys import bert4rec
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import leaves

    cfg = spec.model
    task = build_task(spec, cut_shape(spec, "train_batch", batch=b), mesh)
    if not (task.partitioned and task.per_device):
        fail(f"phase 23 (a): {task.name} is not partitioned")
    batch = recsys_batch(cfg, b, torch.Generator(device=dev).manual_seed(1),
                         dev)
    plain = init_train_state(recsys_params(cfg, dev))
    state = distribute_tree(init_train_state(recsys_params(cfg, dev)),
                            task.placements[0], mesh)
    d_batch = distribute_tree(batch, task.placements[1], mesh)
    plain_step = make_train_step(
        lambda p, x: bert4rec.loss_sampled(p, cfg, x), AdamWConfig())
    rows, launches, differ, peak = [], [], [], 0
    with plain_versions_raise():
        for i in range(RECSYS_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain, pm = plain_step(plain, batch)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            flash_cuda.launches = flash_backward_cuda.launches = 0
            t0 = time.perf_counter()
            state, m = task.fn(state, d_batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches.append((flash_cuda.launches,
                             flash_backward_cuda.launches))
            peak = max(peak, torch.cuda.max_memory_allocated(dev) - held)
            differ.append([k for k in ("loss", "grad_norm", "lr")
                           if not same_bits(whole(m[k]), pm[k])]
                          + [f"parameter {j}" for j, (a, p) in enumerate(
                              zip(leaves(state.params), leaves(plain.params)))
                             if not same_bits(whole(a), p)])
            rows.append((ms, plain_ms, float(whole(m["loss"])),
                         float(pm["loss"])))
            log(f"  (a) step {i}: partitioned {ms:.1f} ms, plain "
                f"{plain_ms:.1f} ms; loss {rows[-1][2]:.7g} / "
                f"{rows[-1][3]:.7g}; K4 launches {launches[-1]}; not "
                f"bitwise: {differ[-1] or 'none'}")
    if set(launches) != {(2, 2)}:
        fail(f"phase 23 (a): K4 launches a partitioned step {launches} "
             "(expected 2 forward and 2 backward: one a block)")
    if any(differ):
        fail(f"phase 23 (a): the partitioned step is not bitwise the plain "
             f"one's: {differ}")
    if not all(math.isfinite(r[2]) for r in rows):
        fail(f"phase 23 (a): losses {rows}")
    step_ms = statistics.median(r[0] for r in rows[1:])
    plain_ms = statistics.median(r[1] for r in rows[1:])
    log(f"  (a) bert4rec train_batch at {b:,} x {cfg.max_seq} partitioned "
        f"over {mesh}: step {step_ms:.1f} ms against the plain step's "
        f"{plain_ms:.1f} ms (medians of steps 1-{RECSYS_STEPS - 1}, in "
        f"turns); loss, grad_norm and every parameter bitwise the plain "
        f"step's after each of {RECSYS_STEPS} steps; peak {peak / 2**30:.2f}"
        f" GiB over the {held / 2**30:.2f} GiB held (both states); no "
        f"plain attention ran [{smi}]")
    del state, plain, batch, d_batch
    torch.cuda.empty_cache()
    return {"recsys_mesh_train_batch": b,
            "recsys_mesh_launches_fwd_per_step": launches[-1][0],
            "recsys_mesh_launches_bwd_per_step": launches[-1][1],
            "recsys_mesh_step_ms": step_ms,
            "recsys_mesh_plain_step_ms": plain_ms,
            "recsys_mesh_steps_ms": [r[0] for r in rows],
            "recsys_mesh_plain_steps_ms": [r[1] for r in rows],
            "recsys_mesh_losses": [r[2] for r in rows],
            "recsys_mesh_peak_gib": peak / 2**30,
            "recsys_mesh_held_gib": held / 2**30}


def recsys_mesh_serve(dev, mesh, spec, flush, smi):
    """Phase 23 (b): the partitioned ``serve_p99`` (512 sequences, the
    top-100 of each device's own rows) and ``retrieval_cand`` (one
    sequence against 1,000,000 candidates, the table over ``model``)
    beside phase 19's plain route: the scores and the top-100 values and
    ids bitwise, both routes timed in turns."""
    import torch

    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.launch.tasks import build_task
    from repro_torch.models.recsys import bert4rec

    cfg = spec.model
    p99 = spec.shape("serve_p99").dims["batch"]
    n_cand = spec.shape("retrieval_cand").dims["n_candidates"]
    serve = build_task(spec, spec.shape("serve_p99"), mesh)
    retrieve = build_task(spec, spec.shape("retrieval_cand"), mesh)
    if not (serve.partitioned and retrieve.partitioned):
        fail("phase 23 (b): the serving cells are not partitioned")
    params = recsys_params(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    items = recsys_batch(cfg, p99, gen, dev)["items"]
    cand = torch.randint(1, cfg.n_items + 1, (n_cand,), generator=gen,
                         device=dev, dtype=torch.int32)
    out, differ = {}, []
    with torch.no_grad(), plain_versions_raise():
        d_params, d_items = serve.distribute((params, items))
        r_params, r_one, r_cand = retrieve.distribute((params, items[:1],
                                                       cand))

        def plain_serve():
            return torch.topk(bert4rec.serve_score(params, cfg, items),
                              RECSYS_TOPK)

        def plain_retrieve():
            return torch.topk(bert4rec.retrieval_score(params, cfg,
                                                       items[:1], cand),
                              RECSYS_TOPK)

        for label, plain, part, scores in (
                ("serve_p99", plain_serve,
                 lambda: serve.fn(d_params, d_items),
                 lambda p, x: bert4rec.serve_score(p, cfg, x)),
                ("retrieval", plain_retrieve,
                 lambda: retrieve.fn(r_params, r_one, r_cand), None)):
            want = plain()
            flash_cuda.launches = 0
            got = part()
            torch.cuda.synchronize()
            out[f"{label}_launches"] = flash_cuda.launches
            if not (same_bits(whole(got[0]), want[0])
                    and same_bits(whole(got[1]), want[1])):
                differ.append(f"{label} top-{RECSYS_TOPK}")
            if scores is not None and not same_bits(
                    whole(scores(d_params, d_items)),
                    scores(params, items)):
                differ.append(f"{label} scores")
            out[f"{label}_ms"], out[f"{label}_plain_ms"] = time_two(
                part, plain, flush, n_timed=RECSYS_MESH_TIMED, n_warm=1)
        r_scores = bert4rec.retrieval_score(r_params, cfg, r_one, r_cand)
        if not same_bits(whole(r_scores),
                         bert4rec.retrieval_score(params, cfg, items[:1],
                                                  cand)):
            differ.append("retrieval scores")
        del r_scores
    if differ:
        fail(f"phase 23 (b): not bitwise the plain route's: {differ}")
    if out["serve_p99_launches"] != cfg.n_blocks or out[
            "retrieval_launches"] != cfg.n_blocks:
        fail(f"phase 23 (b): K4 launches a call {out} (expected "
             f"{cfg.n_blocks}: one a block)")
    log(f"  (b) serve_p99 partitioned ({p99} sequences over the mesh's "
        f"every axis, each device's own rows' top-{RECSYS_TOPK}): "
        f"{out['serve_p99_ms']:.3f} ms against the plain route's "
        f"{out['serve_p99_plain_ms']:.3f} ms; retrieval_cand ({n_cand:,} "
        f"candidates, the table over 'model'): {out['retrieval_ms']:.3f} ms "
        f"against {out['retrieval_plain_ms']:.3f} ms (medians of "
        f"{RECSYS_MESH_TIMED}, in turns, L2 flushed); scores and top-"
        f"{RECSYS_TOPK} values and ids bitwise the plain route's; K4 "
        f"{out['serve_p99_launches']} launches a call [{smi}]")
    del params, d_params, r_params, items, d_items
    torch.cuda.empty_cache()
    return {f"recsys_mesh_{k}": v for k, v in out.items()}


def recsys_mesh_traces(mesh, spec, b):
    """Phase 23 (c): (a)'s and (b)'s cells traced partitioned on this
    1 x 1 mesh, their per-device FLOPs within 1e-6 of their global
    traces'."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.tasks import build_task

    out = {}
    for label, shape in (("train", cut_shape(spec, "train_batch", batch=b)),
                         ("serve_p99", spec.shape("serve_p99")),
                         ("retrieval", spec.shape("retrieval_cand"))):
        part = build_task(spec, shape, mesh).trace()
        glob = build_task(spec, shape, mesh_shape(mesh)).trace()
        ratio = part.flops / glob.flops
        if not abs(ratio - 1) <= 1e-6:
            fail(f"phase 23 (c) {label}: per-device FLOPs {part.flops:.9g}, "
                 f"global trace {glob.flops:.9g}")
        log(f"  (c) bert4rec {label} on {mesh}: per-device FLOPs "
            f"{part.flops:.9g} = {ratio:.9f} x the global trace's; "
            f"collectives {len(part.collectives)}; traced in "
            f"{part.seconds:.1f} s ({part.n_ops} ops) against "
            f"{glob.seconds:.1f} s ({glob.n_ops} ops) unpartitioned")
        out.update({f"recsys_mesh_{label}_flops_ratio": ratio,
                    f"recsys_mesh_{label}_trace_s": part.seconds})
    return out


def recsys_mesh_phase(dev, flush, smi, train_b):
    """Phase 23: BERT4Rec's cells partitioned by DTensor placements on a
    1 x 1 mesh over an NCCL group of one, at published width; returns
    K4's ``recsys_mesh_*`` keys."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_local_group, make_mesh

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    spec = get_config("bert4rec")
    init_local_group(0, 1, tempfile.mkdtemp(prefix="chip-smoke-recsys-"),
                     "cuda")
    try:
        mesh = make_mesh((1, 1))
        keys = recsys_mesh_train(dev, mesh, spec, train_b, smi)
        log(f"  {at()} (a) done")
        keys.update(recsys_mesh_serve(dev, mesh, spec, flush, smi))
        log(f"  {at()} (b) done")
        keys.update(recsys_mesh_traces(mesh, spec, train_b))
        log(f"  {at()} phase 23 done")
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    keys["recsys_mesh_card"] = smi
    return keys


# Phase 24: the GNN pjit cells partitioned by DTensor placements on the
# card.
GNN_MESH_CELLS = (("gat-cora", "full_graph_sm"), ("pna", "molecule"),
                  ("nequip", "molecule"), ("mace", "molecule"))


def gnn_mesh_close(tag, metrics, plain_metrics, state, plain):
    """``(loss, grad_norm, parameters)`` errors of the partitioned steps
    against the plain ones (step by step; the loss of max(1, |loss|),
    ``grad_norm`` and each parameter of its own largest magnitude, the
    parameters after the last step of both); fails past
    ``GNN_SHARD_TOL``."""
    from repro_torch.train.tree import leaves

    loss = grad_norm = 0.0
    for m, pm in zip(metrics, plain_metrics, strict=True):
        want = float(pm["loss"])
        loss = max(loss, abs(float(whole(m["loss"])) - want)
                   / max(1.0, abs(want)))
        grad_norm = max(grad_norm, abs(float(whole(m["grad_norm"]))
                                       - float(pm["grad_norm"]))
                        / max(float(pm["grad_norm"]), 1e-30))
    errs = (loss, grad_norm, max(rel_max(whole(a), b) for a, b in zip(
        leaves(state.params), leaves(plain.params))))
    if not (all(math.isfinite(e) for e in errs)
            and max(errs) <= GNN_SHARD_TOL):
        fail(f"phase 24 {tag}: partitioned vs plain (loss, grad_norm, "
             f"parameters) {errs}, limit {GNN_SHARD_TOL}")
    return errs


def gnn_mesh_step(dev, task, mod, cfg, g, params_fn, timed_order):
    """The partitioned step of ``task`` and the plain step on two states
    from ``params_fn()``, in the order ``timed_order`` gives ("plain" /
    "mesh", as many of each): each step's ms, K2a launches and peak
    over what was held, and the partitioned steps' errors against the
    plain steps (``gnn_mesh_close``)."""
    import torch

    from repro_torch.kernels.segsum import segsum_cuda
    from repro_torch.launch.tasks import distribute_tree
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step

    plain = init_train_state(params_fn())
    state = distribute_tree(init_train_state(params_fn()),
                            task.placements[0], task.mesh)
    d_graph = distribute_tree(g, task.placements[1], task.mesh)
    # the task's own optimizer (``launch.tasks``: ``AdamWConfig()``)
    plain_step = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b),
                                 AdamWConfig())
    out = {"plain": [], "mesh": [], "launches": [], "plain_launches": [],
           "peak": 0, "plain_peak": 0}
    metrics = {"plain": [], "mesh": []}
    for route in timed_order:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        segsum_cuda.launches = 0
        t0 = time.perf_counter()
        if route == "plain":
            plain, m = plain_step(plain, g)
        else:
            state, m = task.fn(state, d_graph)
        torch.cuda.synchronize()
        out[route].append((time.perf_counter() - t0) * 1e3)
        metrics[route].append(m)
        key = "" if route == "mesh" else "plain_"
        out[key + "launches"].append(segsum_cuda.launches)
        out[key + "peak"] = max(out[key + "peak"],
                                torch.cuda.max_memory_allocated(dev) - held)
        out["held"] = held
    out["errs"] = gnn_mesh_close(task.name, metrics["mesh"],
                                 metrics["plain"], state, plain)
    out["loss"] = float(whole(metrics["mesh"][-1]["loss"]))
    del state, plain, d_graph
    return out


def gnn_mesh_models(dev, mesh, smi):
    """Phase 24 (a): each GNN at its ``CONFIG`` on its published shape,
    ``GNN_STEPS`` partitioned steps in turns with the plain step, from
    the same weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.tasks import build_task

    rows = {}
    for arch, shape in GNN_MESH_CELLS:
        spec = get_config(arch)
        task = build_task(spec, spec.shape(shape), mesh)
        if not (task.partitioned and task.per_device):
            fail(f"phase 24 (a): {task.name} is not partitioned")
        mod, cfg, g = gnn_inputs(arch, dev)
        res = gnn_mesh_step(
            dev, task, mod, cfg, g,
            lambda: mod.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg),
            ("plain", "mesh") * GNN_STEPS)
        if set(res["launches"]) != set(res["plain_launches"]) or len(
                set(res["launches"])) != 1 or res["launches"][0] == 0:
            fail(f"phase 24 (a) {arch}: K2a launches a partitioned step "
                 f"{res['launches']}, plain {res['plain_launches']}")
        worst = res["errs"]
        row = dict(cell=task.name, launches=res["launches"][0],
                   step_ms=statistics.median(res["mesh"][1:]),
                   plain_ms=statistics.median(res["plain"][1:]),
                   steps_ms=res["mesh"], plain_steps_ms=res["plain"],
                   loss_err=worst[0], grad_norm_err=worst[1],
                   param_err=worst[2], peak_mib=res["peak"] / 2**20,
                   plain_peak_mib=res["plain_peak"] / 2**20,
                   held_mib=res["held"] / 2**20)
        rows[arch] = row
        log(f"  (a) {task.name} partitioned over {mesh}: step "
            f"{row['step_ms']:.2f} ms against the plain step's "
            f"{row['plain_ms']:.2f} ms (medians of steps 1-{GNN_STEPS - 1},"
            f" in turns); {row['launches']} K2a launches a step, as the "
            f"plain step's; against the plain steps: loss {worst[0]:.3g}, "
            f"grad_norm {worst[1]:.3g} (worst of {GNN_STEPS}), parameters "
            f"{worst[2]:.3g} after the last; peak {row['peak_mib']:.0f} MiB "
            f"(plain {row['plain_peak_mib']:.0f}) over the "
            f"{row['held_mib']:.0f} MiB held [{smi}]")
        del g
        torch.cuda.empty_cache()
    return rows


def gnn_mesh_ogb(dev, mesh, smi, edges):
    """Phase 24 (b): gat-cora on ``ogb_products`` at ``edges`` (phase 18
    (b)'s cut), cut by 5% a try while the partitioned step does not
    fit: three steps of each route in turns (plain, partitioned,
    partitioned, plain, plain, partitioned), the first of each warm."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.tasks import build_task
    from repro_torch.models.gnn import gat

    spec = get_config("gat-cora")
    cfg = dataclasses.replace(spec.model, d_in=OGB_FEAT,
                              n_classes=OGB_CLASSES)
    e, reduced = edges, None
    if edges != OGB_EDGES:
        reduced = f"n_edges {OGB_EDGES:,} -> {edges:,} (phase 18 (b)'s cut)"
    for _ in range(OGB_CUTS + 1):
        try:
            task = build_task(spec, cut_shape(spec, "ogb_products",
                                              n_edges=e), mesh)
            gen = torch.Generator(device=dev).manual_seed(0)
            g = ogb_graph(dev, OGB_NODES, e, gen)
            res = gnn_mesh_step(
                dev, task, gat, cfg, g,
                lambda: gat.init_params(
                    torch.Generator(device=dev).manual_seed(1), cfg),
                ("plain", "mesh", "mesh", "plain", "plain", "mesh"))
            break
        except torch.cuda.OutOfMemoryError:
            pass
        g = None
        gc.collect()
        torch.cuda.empty_cache()
        e = int(e * OGB_CUT)
        reduced = (f"n_edges {OGB_EDGES:,} -> {e:,}: the partitioned step "
                   "did not fit")
        log(f"  (b) out of memory; cutting to {e:,} edges")
    else:
        fail("phase 24 (b): no edge count tried fits the card")
    if set(res["launches"]) != {4} or set(res["plain_launches"]) != {4}:
        fail(f"phase 24 (b): K2a launches a step {res['launches']}, plain "
             f"{res['plain_launches']} (expected 4: two per layer)")
    out = dict(edges=e, nodes=OGB_NODES, reduced=reduced,
               step_ms=statistics.median(res["mesh"][1:]),
               plain_ms=statistics.median(res["plain"][1:]),
               steps_ms=res["mesh"], plain_steps_ms=res["plain"],
               loss=res["loss"], peak_gib=res["peak"] / 2**30,
               plain_peak_gib=res["plain_peak"] / 2**30,
               held_gib=res["held"] / 2**30,
               worst_err=max(res["errs"]))
    log(f"  (b) gat-cora on ogb_products, {e:,} edges, partitioned over "
        f"{mesh}: step {out['step_ms']:.1f} ms against the plain step's "
        f"{out['plain_ms']:.1f} ms (medians of the last two of each, in "
        f"turns); loss {out['loss']:.5f}, worst error against the plain "
        f"step {out['worst_err']:.3g}; 4 K2a launches a step; peak "
        f"{out['peak_gib']:.2f} GiB (plain {out['plain_peak_gib']:.2f}) "
        f"over the {out['held_gib']:.2f} GiB held; reduced: {reduced} "
        f"[{smi}]")
    del g, task
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gnn_mesh_traces(mesh, edges):
    """Phase 24 (c): (a)'s and (b)'s cells traced partitioned on this 1 x
    1 mesh, their per-device FLOPs within 1e-6 of their global
    traces'."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.tasks import build_task

    out = {}
    cells = GNN_MESH_CELLS + (("gat-cora", "ogb_products"),)
    for arch, name in cells:
        spec = get_config(arch)
        shape = (cut_shape(spec, name, n_edges=edges)
                 if name == "ogb_products" else spec.shape(name))
        part = build_task(spec, shape, mesh).trace()
        glob = build_task(spec, shape, mesh_shape(mesh)).trace()
        ratio = part.flops / glob.flops
        if not abs(ratio - 1) <= 1e-6:
            fail(f"phase 24 (c) {arch}:{name}: per-device FLOPs "
                 f"{part.flops:.9g}, global trace {glob.flops:.9g}")
        log(f"  (c) {arch}:{name} on {mesh}: per-device FLOPs "
            f"{part.flops:.9g} = {ratio:.9f} x the global trace's; "
            f"collectives {len(part.collectives)}; traced in "
            f"{part.seconds:.1f} s ({part.n_ops} ops) against "
            f"{glob.seconds:.1f} s ({glob.n_ops} ops) unpartitioned")
        out[f"{arch}:{name}"] = dict(flops_ratio=ratio,
                                     collectives=len(part.collectives),
                                     trace_s=part.seconds)
    return out


def gnn_mesh_phase(dev, smi, ogb_edges):
    """Phase 24: the GNN ``pjit`` cells partitioned by DTensor placements
    on a 1 x 1 mesh over an NCCL group of one, at each ``CONFIG``;
    returns K2a's ``gnn_mesh_*`` keys."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_local_group, make_mesh

    t_phase = time.perf_counter()
    at = lambda: f"[{time.perf_counter() - t_phase:.1f} s]"
    init_local_group(0, 1, tempfile.mkdtemp(prefix="chip-smoke-gnn-mesh-"),
                     "cuda")
    try:
        mesh = make_mesh((1, 1))
        models = gnn_mesh_models(dev, mesh, smi)
        log(f"  {at()} (a) done")
        ogb = gnn_mesh_ogb(dev, mesh, smi, ogb_edges)
        log(f"  {at()} (b) done")
        traces = gnn_mesh_traces(mesh, ogb["edges"])
        log(f"  {at()} phase 24 done")
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return {"gnn_mesh_models": models, "gnn_mesh_ogb": ogb,
            "gnn_mesh_traces": traces,
            "gnn_mesh_launches": {a: r["launches"]
                                  for a, r in models.items()},
            "gnn_mesh_card": smi}


KERNEL_SOURCES = (("deliver_fused", "deliver_fused.cu"),
                  ("isect", "isect.cu"), ("segsum", "segsum.cu"),
                  ("flash", "flash.cu"), ("flash_bwd", "flash_bwd.cu"))
ANALYSIS_TIMEOUT_S = 600   # phase 15 (d): the CLI's whole run


def analysis_phase(dev):
    """Phase 15: the static analysis on the card.  (a) the card's
    shared memory per block, with and without the opt-in, against
    ``repro_torch.analysis.shapes``' constants; (b) every entry
    function's static shared memory from phase 1's ``ptxas -v`` against
    the model's, for all five sources; (c) each kernel at the worst
    geometry its budget admits (``shapes.worst_launches``) against its
    plain version: bitwise on integer payloads (K1, K2a, K2b, K3a),
    phase 8's tolerance for K4; (d) ``python -m repro_torch.analysis
    --device cuda --passes lint,digest,shapes,retrace`` in a subprocess,
    which must exit 0.  Returns per kernel id the model's largest static
    and worst dynamic bytes."""
    import torch

    from repro_torch.analysis import shapes
    from repro_torch.kernels import _nvcc

    limits = shapes.device_limits(dev)
    want = (shapes.DEFAULT_BYTES, shapes.OPTIN_BYTES)
    log(f"  (a) shared memory a block: {limits[0]} bytes, {limits[1]} "
        f"opted in (model {want[0]}, {want[1]})")
    if limits != want:
        fail(f"device shared memory limits {limits} != model {want}")

    logs = {src: _nvcc.build_log(name, (src,))
            for name, src in KERNEL_SOURCES}
    bad = shapes.check_ptxas(logs)
    if bad:
        fail("ptxas static shared memory != model: " + "; ".join(
            f.scope + ": " + f.message for f in bad))
    n_entries = sum(len(shapes.ptxas_static_smem(t)) for t in logs.values())
    log(f"  (b) ptxas static shared memory equals the model for all "
        f"{n_entries} entry functions")
    rows = shapes.instantiations()
    budget = {}
    for kid in ("K1", "K2a", "K2b", "K3a", "K3b", "K4"):
        mine = [r for r in rows if r.kernel == kid]
        worst = max(mine, key=lambda r: r.total / r.limit)
        budget[kid] = {"smem_static": max(r.static for r in mine),
                       "smem_dynamic_worst": max(r.dynamic for r in mine)}
        log(f"  {kid}: static up to {budget[kid]['smem_static']} B, worst "
            f"dynamic {budget[kid]['smem_dynamic_worst']} B; closest to "
            f"its limit: {worst.entry} {worst.static} + {worst.dynamic} = "
            f"{worst.total} of {worst.limit} B "
            f"({worst.limit - worst.total} to spare; {worst.where})")
    if shapes.check_budgets(rows):
        fail("a kernel's shared memory exceeds its limit")

    for kid, label, kernel, plain in shapes.worst_launches(dev):
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        tag = f"phase 15 {kid} {label}"
        if kid == "K4":
            rtol, atol = FLASH_TOL[str(got.dtype).removeprefix("torch.")]
            err = check_close(tag, got, ref, rtol, atol)
            log(f"  (c) {kid} {label}: max abs err {err:.3g} (rtol {rtol}, "
                f"atol {atol})")
        else:
            if got.shape != ref.shape or got.dtype != ref.dtype or (
                    not torch.equal(got, ref)):
                fail(f"{tag}: kernel != plain")
            log(f"  (c) {kid} {label}: bitwise equal to the plain version")

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cuda",
         "--passes", "lint,digest,shapes,retrace"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=ANALYSIS_TIMEOUT_S)
    for line in proc.stdout.splitlines()[-8:]:
        log(f"    {line}")
    if proc.returncode != 0:
        fail(f"python -m repro_torch.analysis exited {proc.returncode}: "
             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    log(f"  (d) python -m repro_torch.analysis --device cuda: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return budget


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.algorithms import (
        connected_components_spec,
        pagerank_spec,
        shortest_paths_spec,
    )
    from repro_torch.core import Engine
    from repro_torch.data import make_dataset
    from repro_torch.kernels.deliver import fused

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build_kernels()
    log(f"phase 1: built " + ", ".join(
        f"{k} in {v:.1f} s" for k, v in built.items())
        + f" (together {time.perf_counter() - t0:.1f} s)")
    from repro_torch.kernels import _nvcc

    flash_log = _nvcc.build_log("flash", ("flash.cu",))
    for name, regs, st, ld, smem in ptxas_summary(flash_log):
        log(f"  ptxas flash {name}: {regs} registers, spills {st} B stored "
            f"/ {ld} B loaded, {smem} B static smem")
        if "tf32" in name and st + ld > 0:
            fail(f"ptxas: {name} spills ({st} B stored, {ld} B loaded)")
    for line in flash_log.splitlines():
        if "wgmma" in line and "Performance Loss" in line:
            log(f"  ptxas: {line.strip()}")
            if "tf32" in line:
                fail(f"ptxas, flash: {line.strip()}")
    bwd_log = _nvcc.build_log("flash_bwd", ("flash_bwd.cu",))
    for name, regs, st, ld, smem in ptxas_summary(bwd_log):
        log(f"  ptxas flash_bwd {name}: {regs} registers, spills {st} B "
            f"stored / {ld} B loaded, {smem} B static smem")
        if ("wgmma" in name or "tf32" in name) and st + ld > 0:
            fail(f"ptxas: {name} spills ({st} B stored, {ld} B loaded)")
    for line in bwd_log.splitlines():
        if "wgmma" in line and "Performance Loss" in line:
            fail(f"ptxas, flash_bwd: {line.strip()}")
    for name, regs, st, ld, smem in ptxas_summary(
            _nvcc.build_log("segsum", ("segsum.cu",))):
        log(f"  ptxas segsum {name}: {regs} registers, spills {st} B "
            f"stored / {ld} B loaded, {smem} B static smem")

    # -- phase 2: kernel vs plain at DBLP scale --------------------------------
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    hg = make_dataset("dblp", 1.0, seed=0, device=dev)
    t_gen = time.perf_counter() - t0
    eng = Engine(device=dev, collect_stats=True)
    t0 = time.perf_counter()
    fwd, bwd = eng._delivery_layouts(hg)
    t_lay = time.perf_counter() - t0
    log(f"dblp: |V|={hg.n_vertices} |E|={hg.n_hyperedges} nnz={hg.nnz} "
        f"(generated {t_gen:.1f} s, layouts {t_lay:.1f} s)")
    for name, lay in (("fwd", fwd), ("bwd", bwd)):
        log(f"  {name}: widths {lay.class_widths} rows {lay.class_rows} "
            f"lanes {tuple(int(a.shape[0]) for a in lay.class_src)} "
            f"max_blocks {lay.class_max_blocks} block_e {lay.class_block_e}")
    rng = np.random.default_rng(0)
    padded = padded_layout(hg, rng)
    p_plan = fused.leaf_plan(padded)
    log(f"  fwd padded: widths {padded.class_widths} rows "
        f"{padded.class_rows}; {int((p_plan.slot_dst < 0).sum())} dead "
        f"slots, {p_plan.zero_dst.numel()} zero-degree destinations")
    for name, lay in (("fwd", fwd), ("bwd", bwd)):
        plan = fused.leaf_plan(lay)
        log(f"  {name} leaf plan: classes in launch order {plan.order}, "
            f"spans {plan.spans} rows, blocks {plan.blocks} "
            f"({sum(plan.blocks)} in one launch), "
            f"{plan.zero_dst.numel()} zero-degree destinations")
    t0 = time.perf_counter()
    n_checks, max_err = check_kernel(
        (("fwd", fwd), ("bwd", bwd), ("fwd padded", padded)), rng)
    del padded, p_plan
    log(f"phase 2: {n_checks} kernel-vs-plain checks passed "
        f"(max abs err on random float sums {max_err:.3g}) in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 3: the main path ------------------------------------------------
    t0 = time.perf_counter()
    pr = pagerank_spec(hg, iters=30)
    pr_f, pr_launches = run_fused_counted(eng, pr)
    pr_x = eng.run(pr, delivery="xla")
    rel = 0.0
    for a, b in zip(pr_f.value, pr_x.value):
        rel = max(rel, ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item())
    log(f"  pagerank-30: fused vs xla max relative error {rel:.3g}")
    if not rel <= 1e-5:
        fail(f"pagerank fused vs xla relative error {rel}")

    sp = shortest_paths_spec(hg, 0)
    sp_f, _ = run_fused_counted(eng, sp)
    sp_x = eng.run(sp, delivery="xla")
    for a, b in zip(sp_f.value, sp_x.value):
        if not same_bits(a, b):
            fail("sssp fused != xla")
    for a, b in zip(sp_f.superstep_stats, sp_x.superstep_stats):
        if not torch.equal(a, b):
            fail("sssp activity stats differ")
    reached = int(torch.isfinite(sp_f.value[0]).sum())
    log(f"  sssp: bitwise, {sp_f.decision['measured']['supersteps']} "
        f"supersteps, {reached} vertices reached")

    cc = connected_components_spec(hg)
    cc_f, _ = run_fused_counted(eng, cc)
    cc_x = eng.run(cc, delivery="xla")
    for a, b in zip(cc_f.value, cc_x.value):
        if not same_bits(a, b):
            fail("connected components fused != xla")
    n_comp = int(torch.unique(cc_f.value[0]).numel())
    log(f"  components: bitwise, {n_comp} components, "
        f"{cc_f.decision['measured']['supersteps']} supersteps, "
        f"{cc_f.decision['measured']['host_syncs']} host syncs")
    for v, n in zip(pr_f.value, (hg.n_vertices, hg.n_hyperedges)):
        if v.shape != (n,) or not torch.isfinite(v).all() or (v <= 0).any():
            fail("pagerank ranks are not finite, positive, of shape [n]")
    if any(v.isnan().any() for v in sp_f.value):
        fail("NaN in sssp distances")
    log(f"phase 3: main path agrees in {time.perf_counter() - t0:.1f} s")

    # -- phase 4: timings ------------------------------------------------------
    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    totals = time_delivery(hg, fwd, bwd, flush)

    walls = {}
    for label, spec in (("pagerank-30", pr), ("sssp", sp)):
        for delivery in ("pallas_fused", "xla"):
            eng.run(spec, delivery=delivery)  # warm-up
            m = eng.run(spec, delivery=delivery).decision["measured"]
            walls[(label, delivery)] = m
            log(f"  e2e {label} {delivery}: wall {m['wall_s'] * 1e3:.1f} "
                f"ms (dispatch {m['dispatch_s'] * 1e3:.1f} ms, device wait "
                f"{m['device_wait_s'] * 1e3:.1f} ms), {m['pairs_run']} "
                f"pairs, {m['host_syncs']} host syncs")
    log(f"phase 4: timed in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    # hg stays for phase 7; fwd and phase 3's fused runs, for phase 14.
    local3 = (("pagerank-30", pr, pr_f), ("sssp", sp, sp_f),
              ("components", cc, cc_f))
    del bwd, eng, pr, sp, cc, pr_x, sp_x, cc_x

    # -- phase 5: intersection kernels vs plain at Apache scale ---------------
    hg_a, bits, triples, batches, isect_err, host_uni = (
        intersections_vs_plain(dev, rng))

    # -- phase 6: the analytics path -------------------------------------------
    k3a_launches, k3b_launches, census = analytics_path(
        dev, hg_a, triples, batches, host_uni)

    # -- timings of the intersection kernels -----------------------------------
    t0 = time.perf_counter()
    sms, clock = card_rates()
    popc_rate = sms * POPC_PER_CLOCK_PER_SM * clock
    log(f"timings: {sms} SMs x {POPC_PER_CLOCK_PER_SM} popc/clock x "
        f"{clock / 1e6:.0f} MHz = {popc_rate:.4g} popcounts/s; L2 flushed "
        "before each run; median of 20")
    isect_entries = time_isect(bits, batches, flush, popc_rate)
    log(f"timings: done in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 7: segment sum (K2a, K2b) at DBLP scale -------------------------
    t0 = time.perf_counter()
    segsum_entries = segsum_phase(hg, flush)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s in all")

    # -- phase 8: attention (K4) at llama3.2-1b and gemma3-12b widths -----------
    t0 = time.perf_counter()
    flash_entry = flash_phase(dev, flush, sms, clock)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 9: compile-once serving (CUDA graphs through K1) ----------------
    t0 = time.perf_counter()
    log("phase 9: Engine(delivery='pallas_fused').compile on dblp at full "
        "scale")
    serving = serving_phase(hg, flush)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 10: the card's delivery term ---------------------------------
    t0 = time.perf_counter()
    check_delivery_term(delivery_grid(hg, flush))
    log(f"phase 10: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 11: the clique representation (K2a, K2b) -----------------------
    t0 = time.perf_counter()
    log("phase 11: the clique representation on dblp at full scale")
    clique_entries = clique_phase(hg, flush)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 12: fault-tolerant serving (checkpoints, the front-end) ---------
    t0 = time.perf_counter()
    log("phase 12: fault-tolerant serving on dblp at full scale")
    serve_tier = fault_serving_phase(hg)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 13: the replica pool (store, router, kill -9, hang) ------------
    t0 = time.perf_counter()
    log(f"phase 13: {POOL_REPLICAS} replica processes on one card, dblp at "
        "full scale")
    pool = pool_phase(hg, serve_tier["phase12_requests_per_s"])
    log(f"phase 13: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 14: the distributed backends (world size 1, NCCL) --------------
    t0 = time.perf_counter()
    log("phase 14: the distributed backends on one card, dblp and apache at "
        "full scale")
    dist_k1, dist_k3 = distributed_phase(hg, fwd, local3, hg_a, census, flush)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 15: the static analysis on the card ----------------------------
    t0 = time.perf_counter()
    log("phase 15: shared-memory budgets against the card and ptxas, the "
        "worst geometries, the analysis CLI")
    smem = analysis_phase(dev)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 16: the LM serving path at llama3.2-1b's full width --------------
    t0 = time.perf_counter()
    log("phase 16: the LM serving path (repro_torch.launch.serve) at "
        "llama3.2-1b's full width")
    flash_entry.update(lm_phase(dev, flush, sms, clock, smi))
    log(f"phase 16: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 17: the LM training path at llama3.2-1b's full width -----------
    t0 = time.perf_counter()
    log("phase 17: the LM training path (repro_torch.launch.train) at "
        "llama3.2-1b's full width, K4's backward kernels")
    flash_entry.update(train_phase(dev, flush, sms, clock, smi))
    log(f"phase 17: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 18: the GNN side (K2a as mp_segment_sum's kernel) -------------
    # Its (b) sizes gat-cora's graph by what the card can hold: the
    # hypergraph phases' inputs go first.
    del hg, fwd, local3, hg_a, bits, triples, batches, census
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 18: gat-cora, pna, nequip and mace at their published widths, "
        "gat-cora on ogb_products, the edge-sharded step")
    gnn_entry = gnn_phase(dev, flush, smi)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 19: the recsys side (K4 bidirectional, embedding_bag on K2a) --
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 19: bert4rec training, serving and retrieval at its published "
        "width; K4 bidirectional in float32, embedding_bag on K2a")
    recsys_entry, bag_entry = recsys_phase(dev, flush, sms, clock, smi)
    flash_entry.update(recsys_entry)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 20: the dry-run and its roofline against phases 16-19 ----------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 20: the dry-run (fake tensors, a fake world of 512) and its "
        "roofline against the cells of phases 16-19")
    dryrun = dryrun_phase(dev, flash_entry, gnn_entry, smi)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 21: the dense LM partitioned by DTensor placements ------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 21: llama3.2-1b's train step, prefill and decode partitioned "
        "over a (data 1, model 1) mesh on an NCCL group of one")
    flash_entry.update(mesh_phase(dev, flush, smi, dryrun["dryrun_single"]))
    log(f"phase 21: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 22: the MoE LM partitioned by DTensor placements --------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 22: qwen3-moe-235b-a22b's prefill, decode and train step "
        "partitioned over a (data 1, model 1) mesh on an NCCL group of one")
    flash_entry.update(moe_phase(dev, flush, smi, dryrun["dryrun_moe"]))
    log(f"phase 22: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 23: BERT4Rec partitioned by DTensor placements ---------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 23: bert4rec's train step, serving and retrieval partitioned "
        "over a (data 1, model 1) mesh on an NCCL group of one")
    flash_entry.update(recsys_mesh_phase(dev, flush, smi,
                                         flash_entry["recsys_train_batch"]))
    log(f"phase 23: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 24: the GNN pjit cells partitioned by DTensor placements -----
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 24: gat-cora, pna, nequip and mace's pjit cells partitioned "
        "over a (data 1, model 1) mesh on an NCCL group of one")
    gnn_entry.update(gnn_mesh_phase(dev, smi, gnn_entry["gnn_ogb"]["edges"]))
    log(f"phase 24: {time.perf_counter() - t0:.1f} s in all; total "
        f"{time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "deliver_fused",
        "route": "cuda",
        "source": "src/repro_torch/csrc/deliver_fused.cu",
        "replaces": "src/repro/kernels/deliver/fused.py:126",
        "launches": pr_launches,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        **serving,
        **serve_tier,
        **pool,
        **dist_k1,
        **smem["K1"],
    }]
    for name, replaces, launches in (
            ("isect", "src/repro/kernels/isect/isect.py:63", k3a_launches),
            ("isect_fused", "src/repro/kernels/isect/isect.py:115",
             k3b_launches)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/isect.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": float(isect_err),
            **isect_entries[name],
            "library_ms": None,  # torch has no popcount op
            "dist_census_launches": dist_k3[name],
            **smem["K3a" if name == "isect" else "K3b"],
        })
    # K2b's numbers are at its caller's shapes (phase 11: the clique
    # PageRank), K2a's at its caller's (phase 18: the GNN side, the
    # largest call gat-cora's layer-1 messages on ogb_products); phase
    # 7's, at the DBLP incidences, follow as phase7_*, with K2a's at the
    # clique out-weights as out_w_*.
    for name, caller in (("segsum_sorted", clique_entries["segsum_sorted"]),
                         ("segsum", gnn_entry)):
        seven = segsum_entries[name]
        segsum_entries[name] = {
            **{f"phase7_{key}": val for key, val in seven.items()},
            **caller}
    segsum_entries["segsum"].update(
        {f"out_w_{key}": clique_entries["segsum"][key]
         for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        caller="models.gnn through sparse.mp_segment_sum (phase 18), "
               "sparse.embedding_bag's sum (phase 19, bag_*); index_add_ "
               "measured faster for graph_pagerank's out-weights",
        **bag_entry)
    for name, kid, source, replaces, entry in (
            ("segsum", "K2a", "segsum.cu", "segsum/segsum.py:125",
             segsum_entries["segsum"]),
            ("segsum_sorted", "K2b", "segsum.cu", "segsum/segsum.py:157",
             segsum_entries["segsum_sorted"]),
            ("flash", "K4", "flash.cu", "flash/flash.py:93", flash_entry)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": entry["launches"],
            "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"],
            **smem[kid],
        })
    next(k for k in kernels if k["name"] == "flash").update(
        {key: val for key, val in flash_entry.items()
         if key.startswith(("lm_", "train_", "bwd_", "recsys_", "mesh_",
                            "moe_"))},
        bwd_source="src/repro_torch/csrc/flash_bwd.cu",
        bwd_replaces="none: the JAX package differentiates its stock-op "
                     "attention")
    for name in ("segsum", "segsum_sorted"):
        next(k for k in kernels if k["name"] == name).update(
            {key: val for key, val in segsum_entries[name].items()
             if key.startswith(("phase7_", "out_w_", "shuffled_",
                                "one_segment_", "skew_", "gnn_", "bag_"))
             or key in (
                 "caller", "clique_ms", "bipartite_ms",
                 "graph_pagerank_ms", "to_graph_s")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
