#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpu_stencil_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every hand-written kernel and every lab variant from
``tpu_stencil_torch/ops/csrc/`` (one ``nvcc`` per library, all started
together, into ``build/kernels/``, with the stream's host ``crc32c``
library beside them), points the autotune cache at
``build/chip_smoke/autotune.json``, then runs these phases, each printing
one JSON line. The build's line holds each library's ``-Xptxas -v``
registers and spills, and from ``cuobjdump -sass`` of L1: the
``mxu_rows_*`` instances must hold ``HMMA`` (bf16) or ``IMMA`` (int8)
and no ``FFMA`` or ``IDP4A``, and every chain held in registers must
grow by at least an instruction an element and operation from 8 to 16
(no chain folded). The phases that pin launch counts name ``--backend pallas``
(K1 at its default geometry); ``autotune_path`` drives the default
``auto``/``autotune`` resolution.

1. ``device`` — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, SM count and L2 size.
2. ``divide`` — the torch-ops float32 divide on the card is correctly
   rounded over every accumulator of the box and edge plans.
3. ``k1`` — K1 ``stencil_fused`` against its plain version, byte for byte,
   in every tile body (``swar``: gaussian, gaussian5, identity; ``acc16``:
   gaussian7, box; ``int32``: edge, direct16), each in grey and RGB at
   the main path's width (1920) and at widths whose flat row is not a
   multiple of 16 lanes (grey 1917, RGB 1921), 2520 rows (a ragged last
   tile row and column), x9; gaussian RGB 1920x2520 also x{1,7,8,40};
   ``iterate_frames`` on 3 frames of 256x320 RGB x9 per body (the gap
   rows); after each launch the body the library ran must be the one
   ``cuda_stencil.fused_body`` names (``regs`` for gaussian and
   gaussian5), or the shared tile's where a launch forces a tile height
   or is a single rep on a grid of fewer ``regs`` blocks than SMs
   (the launch's ``cuda_stencil.K1Launch``).
   K1's register body alone: gaussian and gaussian5, grey and RGB,
   aligned and ragged widths, single launches at fuse 1, 7 and 8, x1, x9
   and x100, the frames layout; serve-bucket canvases (a 64x64 and four
   256x256 RGB frames, a 384x2048 grey one) at fuse 1 in the shared tile
   and at fuse 8 in ``regs``; every launch counted under the body its
   ``K1Launch`` names (``cuda_stencil.body_launch_counts``), no
   instance using local memory;
   then its ms a rep against ``swar`` at 1920x2520 RGB and 1920x5040 grey
   x100 (taking turns, and the kernels' device time), with each launch's
   registers, local memory and blocks per SM. K1's direct body
   ``regs_direct`` alone: a direct 3x3 plan for each of its instances
   (edge and three built ones: asymmetric on the divide path and dyadic,
   and one whose divisor no multiply-high passes), grey and RGB, aligned
   and ragged widths, fuse 1, 7 and 8 and x9; edge x100 at 1920x5040 RGB
   (the edge cell) and 1920x2520 grey; serve's canvases at fuse 1 and 8,
   and at fuse 1 under a forced tile height (``int32``); every launch
   counted by body; each register
   instance's registers and local memory from ``cudaFuncGetAttributes``
   (none, at most 128 registers, 2 blocks an SM); edge at fuse 1 on
   serve's canvases and larger frames in ``regs_direct`` against
   ``int32``, device us a launch. Plus small images against
   the NumPy golden model, and the no-fallback check: with the libraries'
   builds forced to fail, ``iterate`` raises ``KernelBuildError`` and launches
   nothing under the default schedule and under ``deep``, and the
   torch-ops path is not called.
4. ``k2`` — K2 ``stencil_resident`` through ``iterate``/``iterate_frames``
   with ``schedule='deep'`` against its plain version, byte for byte, each
   case run three times in a row with every run compared (one K2 launch
   and no other each, the body it ran ``tile_body``'s): every body, grey
   and RGB at widths 1920, 1917 and 1921, 2520 rows, x9; gaussian RGB
   1920x2520 at the rep counts around K2's reps per sync F (1, F-1, F,
   F+1, 7, 40); 3 frames of 256x320 RGB x9 per body; and one shape each
   side of the feasibility line (1920 wide RGB, the tallest K2 takes and
   one just past it), the far side running K1 at the deep depth.
5. ``main_path`` — the CLI on a seeded 1920x2520 RGB raw file, x40,
   default schedule and ``--schedule deep``: cold, as the CLI's entry
   point in a fresh process, and warm, as ``tpu_stencil_torch.cli.main``
   in this process with the launch counters set to 0 just before each run
   and read just after. Each run's window launches (its ``--time`` line
   and JobResult) must be those of the rep schedule (K1: 5; K2: 1), its
   warm-up must have launched each
   kernel instance once before the window, and the counters must read the
   two together; each cold window (the JobResult's, at full precision)
   must be at most twice the warm one or within 1 ms of it; the bytes
   written must equal the torch-ops path on the card.
6. ``k3`` — K3 ``stencil_valid`` against its plain version, byte for
   byte, on the ghost-extended tiles of every shard position of a 2x2
   grid (corner, edge and interior global origins) over seeded 1920x2520
   and 1918x2520 images (the second gives shards of odd width), grey and
   RGB, at fuse 1 and 8, in every tile body (the filters of ``k1``), the
   body that ran checked against ``tile_body``.
7. ``sharded_path`` — the sharded runner on ``devices=[cuda:0] * R*C`` at
   1920x2520 RGB gaussian x40 for meshes 1x1, 2x2, 1x4 and 4x1, each
   byte-equal to K1's ``iterate`` and to the torch-ops path, with
   ``(reps // fuse + reps % fuse) * R*C`` K3 launches; the indivisible
   1921x2519 RGB image at 2x2 x9 (the pad mask, fuse 1) and gaussian5 at
   2x2 x9; the CLI with ``--mesh 1x1``, cold and warm (the cold window
   held to the warm one as in ``main_path``); and
   ``driver.run_job`` with mesh 2x2 over ``[cuda:0] * 4`` writing the
   file.
8. ``l2`` — L2 ``stencil_lab``: every exact variant (``current``,
   ``pair``, ``acc16``, ``swar``, ``tile``) against its plain version and against
   K1's bytes at 1920x2520 RGB gaussian, fuse 8 at 32 rows and fuse 4 at
   64 rows, plus gaussian5 and grey; the host's shared-memory model
   against the library's own; then the kernel lab tool
   (``tpu_stencil_torch.tools.kernel_lab``) over its whole table with the
   launch counter set to 0 just before, and the timing table of all
   variants and ablations (ms per rep x40, interleaved, median of 7, L2
   flushed) with ``current / shipped``: ``current`` is K1 as it was before
   its tile was redesigned (the baseline), ``shipped`` K1 as it is; the
   table also holds ``deep`` (K2 as shipped) and ``band`` (the lab's form
   of K2 with the image held in shared memory).
9. ``l1`` — L1 ``op_chain``: every case at a chain of 3 (where no case's
   output is constant, which is checked) and at both timed chains, 8 and
   16, against its plain version (byte-equal; ``mul_add_f32`` and
   ``mxu_rows_bf16`` within 1), through the op cost tool
   (``tpu_stencil_torch.tools.op_cost``), which then gives us per op-pass
   per case beside its bound; then every case at every chain again at a
   ragged width (318 lanes; ``vadd4_u8`` 316, whole words; ``shfl*``
   288, whole warps), with input and output views offset by one byte,
   and at a short tile that takes the row-neighbour cases to their
   shared-memory forms and the lane rolls below a warp; the host's launch
   model (form, blocks, threads, shared memory) against the library's at
   each of those tiles; and each case's resident blocks per SM at the
   tool's tile (the library's occupancy query), at least 2 wherever
   shared memory is used.
10. ``autotune_path`` — ``python -m tpu_stencil_torch IMG 1920 2520 40
   rgb --backend autotune --time`` in a fresh process with an empty cache
   file: it measures, writes the cache and reports the verdict, and its
   bytes equal the torch-ops path; a second run (``cli.main`` here) makes
   zero probes by the autotuner's own counter and launches what the
   verdict says; the same through ``run_job`` on a 2x2 mesh over
   ``[cuda:0] * 4``; then ``bh_fuse_ab`` and a ``--quick`` benchmark
   sweep run to the end with every row exact.
11. ``job_hardened`` — the hardened, observable job at 1920x2520 RGB
   gaussian x40, every run byte-equal to the torch-ops path and holding
   its launches and ``resilience_fallbacks_total`` (0 wherever nothing
   was injected): ``--faults compile:raise=oom --schedule deep`` demoting
   ``pallas[deep]`` to ``pallas`` (K1's launches only, the counter at 1);
   ``--checkpoint-every 10`` killed by ``compute:rep=25`` and resumed
   (the window launches only the 20 remaining reps), through the CLI and
   through ``run_job`` on a 2x2 mesh of this card (K3); ``--fallback-backend
   cpu`` refused on a card job; K1 and K2 launches refused by the card
   (cudaError_t 701, injected in the wrappers) failing the job typed, K2
   demoted to K1 and never to the torch ops; a forced build
   failure through ``run_job`` (``KernelBuildError``, nothing launched, no
   demotion); ``--trace`` (40
   ``iterate.rep`` spans) and a traced 2x2 ``run_job`` with the runner's
   ``sharded.halo_exchange`` and ``sharded.interior_compute`` probes,
   then the split they give (median of 7) beside the untraced runner's
   ms per chunk; ``--breakdown --schedule deep`` (K2, the kernel
   instance with the card's registers and blocks per SM, the memory line
   from ``torch.cuda.memory_stats``); ``--metrics-text`` under
   ``--dispatch-timeout 60`` (an exact round-trip with the device-memory
   gauges, and its window held to the same job's without the watchdog as
   ``main_path`` holds cold to warm); ``--profile`` (the ``torch.profiler`` trace names
   a K1 kernel, ``stencil_fused_*``).
12. ``overlap_path`` — the overlap schedules (``--overlap``) on 2x2 over
   ``[cuda:0] * 4`` at 1920x2520 RGB gaussian x40 (tile 1260x960, g = 8
   at fuse 8): ``auto`` on an empty cache file measures one probe bundle
   and a second runner none, with the same verdict; ``driver.run_job``
   under ``off``, ``fused-split``, ``edge`` and ``auto``, each byte-equal
   to torch ops and K1 (so to ``off``), its window launching K3 1, 5 or 9
   times per tile per chunk (20 / 100 / 180) and its warm-up one chunk of
   each; the two split modes cold, in a fresh process, held to the warm
   window as ``main_path`` holds them; grey (8-lane border pieces); the
   runner under each split mode making no ``torch.cat``, no
   ``.contiguous()`` and no torch-ops call around K3; each mode's ms per
   rep and ``auto``'s, taking turns (``auto`` at most 1.5x ``off``); each
   mode's probe spans (median of 5); the
   ``torch.profiler`` streams of a split run (busy time, time busy at
   once, the device's idle share); K3 on strided thin windows (the left
   and top bands, grey and RGB, 16-byte aligned and unaligned origins,
   written into a rectangle of a larger output) against its plain
   version, and the RGB left band's time (event-timed and device) beside
   its bound.
13. ``witness`` — ``integrity.witness.device_witness`` re-executes the
   40-rep job through torch ops on the card (one ``padded_step`` per rep,
   no hand kernel launched) and equals K1's, K2's and the 2x2 K3 runner's
   outputs; a flipped byte of K1's output is caught; at a probe size the
   NumPy golden agrees with K1 and catches a flip; two samplers with one
   seed pick alike.
14. ``multiprocess`` — two processes on this card (a gloo group, every
   strip between them staged through pinned host buffers), at 1920x2520
   RGB gaussian x40, every output byte-equal to K1 and every subprocess
   within its own time limit: (a) ``python -m torch.distributed.run
   --standalone --nproc-per-node 2 -m tpu_stencil_torch ... --mesh 2x1``
   and ``1x2`` with ``--time``, equal to the same mesh in one process,
   each rank's ``launches=`` showing K3's 5; (b) 2 ranks x 2 tiles (2x2)
   through ``run_job`` under ``off`` (cold, then warm, held as
   ``main_path`` holds them), ``fused-split``, ``edge``, ``auto`` and grey
   ``off``, every rank reporting the same mode and K3 launches of its
   pieces, then per rank the exchange probe of one chunk, the bytes it
   stages and the runner's ms per rep, beside the same 2x2 in one
   process; (c) divergent argv (rank 1 asks for 7 reps and another
   output) running rank 0's job; (d) ``--checkpoint-every 10`` killed at
   rep 25 on both ranks, resumed from rep 20; (e) ``--trace``: one merged
   file with both ranks' ``pid`` values and 40 ``iterate.rep`` spans each;
   (f) rank 1 stalled before its first send under ``--dispatch-timeout
   5``: rank 0 raises ``CollectiveTimeout``.
15. ``stream_path`` — the streaming engine (``python -m tpu_stencil_torch
   stream``) on a seeded clip of 1920x2520 frames x40 gaussian (464 MB RGB
   and 77 MB grey under ``build/chip_smoke/stream``, removed at the end):
   16 frames file to file at depth 2, RGB and grey, through the CLI
   (``--backend pallas``: K1 5 launches a frame plus the warm-up's one;
   ``--schedule deep``: K2 one a frame plus one), the fan
   ``--mesh-frames 2`` over ``[cuda:0] * 2`` (K1, and K2 under
   ``--dispatch-timeout 60``), ``run_job --frames 16`` on one device and
   over ``[cuda:0] * 2`` (the batch axis), every output byte-equal to the
   torch-ops path and every run's launches counted from 0; a
   ``compute`` fault at frame 9 under ``--checkpoint-every 4`` restarts
   the engine once and finishes byte-equal; a torn staging buffer
   (``integrity.corrupt_ingest``) fails with rc 1 and
   ``ChecksumMismatch``; then 32 frames to a null sink at depths 1, 2 and
   4, taking turns, median of 3: wall and steady-state frames/s, the
   stage histograms per frame, the CRC32C of a frame, the modelled bound,
   and from a ``torch.profiler`` trace of a depth-2 run the time an H2D
   copy and K1 were busy at once and the device's idle share.
16. ``shard_stream_path`` — the spatially sharded stream and the temporal
   pipeline on virtual meshes of this card (``[cuda:0] * k``), 1920x2520
   x40 gaussian, ``--backend pallas``: 16 frames file to file at depth 2
   with ``--shard-frames 2x2`` under ``--overlap edge`` and ``off`` and
   1x2 on grey frames, each byte-equal to the torch-ops path and to the
   same clip streamed on one device, K3's launches equal to the runner's
   schedule; 32 frames to a null sink at depths 1 and 2 under both modes
   and through 2 and 4 stages (median of 3, taking turns; stage seconds
   per shard); 8 frames of
   7680x4320 RGB under 2x2 ``off`` against torch ops, with frames/s;
   ``--pipe-stages 2`` and ``4`` (16 frames), reps 3 with K 4, 2 frames
   with K 4 and ``--mesh-frames 2 --pipe-stages 2 --shard-frames 2x1``
   over ``[cuda:0] * 8``, each byte-equal to one device; a compute fault
   restarting the pipeline from its checkpoint; a resume under another
   stage count raising ``MeshCursorMismatch``; ``--shard-frames 0`` and
   ``--pipe-stages 0`` printing measured verdicts, then zero probe frames
   from the warm cache; a profiled 8-frame depth-2 2x2 run (shard H2D
   and K3 busy at once, the device's idle share); the phase's seconds.
17. ``serve_path`` — the serving engine (``StencilServer``) on the card:
   ten mixed requests to a parked server under ``--backend pallas``
   (the 1920x2520 RGB x40 frame of the main path and a 2500x1900 one,
   one batch of the 3072x2048 bucket; a 1x1 image; 3100x40 grey, above
   the ladder's top edge; box, edge, gaussian7, gaussian5; reps 0, 1, 9,
   40; two frames of one small bucket), each byte-equal to
   ``driver.run_job --backend xla`` on the card, K1's launches equal to
   the sum over the batches of their reps and no K2, a repeated key a
   cache hit; the same under ``xla`` with no launch; the two big frames
   under ``overlap`` ``off`` (K1) and ``edge`` on the visible card (1x1)
   and on ``[cuda:0] * 4`` (2x2), K3's launches the runner's schedule;
   ``serve --self-test`` in a fresh process; the closed-loop load run
   (``serve --requests 64 --concurrency 8 --shapes 1920x2520 --channels
   3 --reps 40 --backend pallas --verify golden --stats-json
   --perf-log``, in this process, its K1 launches counted: 40 a batch)
   with 64 completed, no fallback and 0 verify failures (the golden
   checks frames up to 4096 pixels, as in the JAX package: none at this
   size), and ``perf check`` reading back the record it wrote; then the
   same 64 seeded requests twice through ``loadgen.run`` on one server,
   a cold pass and a warm one, every one of the 128 results kept and
   held against torch ops on the card (``device_witness``), K1's
   launches 40 a batch: each pass's throughput, client p50 and p99
   latency and mean ``batch_hbm_gbps``; the card's idle share over a
   profiled warm 16-request run; the pinned slots the cold pass
   allocated, one of each key timed; a ``submit_group`` of 4 as one
   batch; the witness (torch ops on the card) on six requests, no
   mismatch.
18. ``net_path`` — the network tier (``NetFrontend``: the HTTP front end,
   the router, the replica fleet) on the card through real sockets on
   port 0, ``--backend pallas``, seeded 1920x2520 RGB frames x40
   gaussian, every result byte-equal to torch ops on the card: (1) one
   replica (one per visible card), a ``POST /v1/blur`` with an
   ``X-Content-Crc32c`` claim, its ``X-Result-Crc32c`` stamp verified,
   K1 launching 40 and ``padded_step`` never called; (2) the ten mixed
   requests of ``serve_path`` one at a time, one batch each, K1 launching
   their reps' sum; (3) with ``--result-cache-mb 256``, eight identical
   requests to a parked replica answering one ``X-Cache: miss`` and seven
   ``collapsed`` for one request's 40 launches, then a repeat ``hit``
   with none; (4) two replicas on ``[cuda:0] * 2``, every result
   witnessed, ``integrity.corrupt_result`` armed on replica 1 alone:
   three corrupted results quarantine it and drop the cache entries it
   produced (``/statusz``), replica 0 serves the same requests exactly,
   and the prober (24x32 grey x2: two K1 launches a probe, held against
   the NumPy golden) re-admits replica 1 after two clean probes, K1's
   launches those of the served requests plus the probes'; (5) under
   load, ``POST /debug/prof?seconds=0.5`` spooling a trace that names
   a K1 kernel (``stencil_fused_*``; the device's idle share over it),
   ``/debug/timeseries`` rates above 0, ``/metrics`` an exact round trip,
   ``/debug/capacity`` naming the H100's host link, ``/admin/warmstate``
   answering the program-cache keys (never a binary); (6) ``python -m
   tpu_stencil_torch net
   --port 0 --backend pallas`` in a fresh process: 64 closed-loop
   requests of 1920x2520 RGB x40 from 8 clients through
   ``loadgen.HttpTarget`` (``--verify crc``, golden on, and every result
   held against torch ops), twice: a cold pass, then the same requests
   warm, requests/s, p50 and p99 of each printed beside ``serve_path``'s
   warm in-process pass, a profiled run (the idle share), then SIGTERM:
   a clean drain and rc 0; (7) with the kernel
   builds forced to fail, a typed 500 naming ``KernelBuildError``, no
   launch, no torch-ops call.
19. ``fed_ctrl_path`` — the federation and the control plane, real sockets
   on port 0, seeded 1920x2520 RGB frames x40 gaussian, every result
   byte-equal to torch ops on the card: (1) a ``FedFrontend`` in this
   process over two ``NetFrontend`` members on ``[cuda:0]`` each (hedging
   off): one request with a CRC claim (stamp verified, K1 40,
   ``padded_step`` never called), the ten mixed requests (K1 their reps'
   sum), the first body again landing on the same member by digest
   affinity and answering from its result cache with no launch; (2)
   ``net.corrupt_body`` on a member 200 (``forward_bad_payload_total`` 1,
   rerouted, exact bytes, K1 80), ``POST /admin/drain`` of one member
   under 8 clients (16 requests, none dropped), hedging on with
   ``net.accept`` stalling the first request's member 3 s (the hedge leg
   answers exact bytes, K1 = 40 x the legs that completed on a member);
   (3) ``python -m tpu_stencil_torch fed --port 0`` and ``python -m
   tpu_stencil_torch ctrl --fed URL --min-hosts 2 --max-hosts 3`` in fresh
   processes, the members on the card by default: the 64-request load of
   ``net_path`` through the fed (``loadgen.HttpTarget``, CRC and golden
   checks), cold then warm, requests/s, p50 and p99 printed beside
   ``net_path``'s HTTP warm pass; the fed makes no CUDA context (the
   card's memory in use grows under 256 MiB as it starts and serves its
   endpoints; ``nvidia-smi --query-compute-apps`` does not give a
   container's pids), every member has the CUDA driver mapped, and the
   card's memory a member takes; kill -9 of a member under 8 clients
   (every answer exact bytes or a typed 429/503/504), the ctrl reporting
   the dead host, deciding REPLACE, the replacement registering and
   serving; SIGTERM of the ctrl (every member drained, rc 0) and of the
   fed (rc 0); (4) warm start: a
   joiner launched ``--warm-from`` a warm member answers its first request
   byte-equal with ``fleet_cache_misses_total`` 0 and
   ``fleet_ctrl_warmstart_imported_total`` >= 1, its latency printed
   beside a cold joiner's first request; an envelope with an altered
   kernel fingerprint degrades every entry as ``version_skew`` and the
   joiner still serves exact bytes; (5) with the kernel builds forced to
   fail in the member, the member's typed 500 naming ``KernelBuildError``
   reaches the client through the fed's verdict taxonomy (503
   ``HostUnavailable`` naming ``http_500 (KernelBuildError)``), nothing
   launched, no torch-ops call.
20. ``times`` — ms per rep at 1920x2520 RGB gaussian x40, each the median
   of 7 runs after a warm-up (CUDA events, L2 flushed before each run):
   the three job kernels (K3 alone on the one ext tile of a 1x1 mesh at
   fuse 8), L2's ``current`` body, one L1 launch (``add_i32``, chain of
   8, beside ``runtime.roofline.op_chain_bound_ms``),
   one ``mxu_rows_bf16`` launch (chain of 8) beside one batched bf16
   ``torch.matmul`` of the band matrix by the tiles' rows (timed only),
   the whole 2x2 sharded runner under ``pallas`` and under ``auto``
   taking turns (``auto`` must not chunk shallower nor take 1.5x the
   time), their plain versions, the torch-ops path, and one depthwise
   float32 ``F.conv2d`` rep (TF32 off) as the library yardstick, which
   the port never calls; and each kernel's bound. Then K2's A/B, taking
   turns: K2 as shipped against K1 and against the lab's ``band`` form,
   with each form's launch (tile, reps per sync, threads, blocks per SM,
   grid) and its shared memory held against the host model. Then the tile
   redesign's A/B, every set taking turns: K1 and K3's ext tile against
   the lab's ``current`` (the baseline) and ``swar`` on gaussian; K1 and K2
   against ``current`` on gaussian5, gaussian7 and box, K1 and K2 on
   edge, with K1's direct body ``regs_direct`` against the shared tile's
   ``int32`` (a forced tile height); each with the plain version, and
   beside each filter its library call (depthwise ``F.conv2d``,
   ``padding=k//2``) and its bound; 4 frames
   as one tall launch against 1 frame; and each body's resident blocks per
   SM at 32x8 (the library's occupancy query).
21. ``place_overlap`` — the model's placement of a pinned host input, at
   each job cell's shape and filter (1920x2520 RGB gaussian, 1920x5040
   grey gaussian, 1920x5040 RGB edge) x100: 8 ``forward`` calls from a
   ring of 4 pinned inputs, each input overwritten with 0xFF as soon as
   its call returns, every output byte-equal to the blocking placement's
   (a pageable input) and to the plain version's; K1's launches and reps
   by body alike on both paths; ``blur.placement_counts`` at 8
   ``overlapped`` and 4 ``blocking``; one ``torch.profiler`` capture
   (the device's activities) of four pairs, the blocking placement of a
   pinned input and then the overlapped one, in which an overlapped call
   issues its first K1 launch while its H2D copy runs (the stream's
   query at that launch; never so on the blocking path) and each
   overlapped call's first K1 kernel follows its copy closer than the
   blocking call's; then ms a job of
   the two placements taking turns, each job fetched into a pinned
   buffer and waited for.
22. ``mesh_replay`` — ``ShardedRunner.run_host`` on 1920x5040 grey
   gaussian x100 over a 2x2 mesh (four cards where the machine has them,
   else the one card named four times): the first call captures the job
   as one graph over the cards, and 8 calls from a ring of 4 pinned tile
   grids, each overwritten with 0xFF as soon as its call returns, replay
   it; every output, fetched by ``fetch_into`` (two results held at once
   among them), byte-equal to the eager chunks' (``put``/``run``/
   ``fetch``) and to K1 on the whole image; a call under a
   ``torch.profiler`` runs the chunks, not the replay, and equals them
   too; then ms a job of the eager pinned placement and the replay
   taking turns, each job fetched into a pinned tile grid and waited
   for. ``halo_fill``'s launch counter is set to 0 just before the phase
   and read after it (``fill_launches``, equal to the ``fills`` that
   ``halo.fill_counts()`` gained).
23. ``halo_fill`` — the ghost rings of the mesh cell's 2x2 grid of
   2520x960 grey tiles (on the cards of ``mesh_replay``), filled from
   the slab's piece tables at depths 8 (a chunk of 8 reps) and 1 (a
   single-rep tail): one launch of ``halo_fill`` a tile against
   ``fill_plain`` (a ``copy_`` a piece) on slabs of the same tiles, every
   byte of both buffers equal, and every ring equal to ``halo_exchange``'s
   ghost-extended tile; then the card's ms of one fill of the grid (CUDA
   events around each card's launches, the slowest card, median of
   rounds) for the kernel and for ``fill_plain``, beside the bound of the
   ring's bytes over the link they cross.

Then the ``{"kernels": [...]}`` line (for K1, K2 and K3 ``launches`` are
the main path's timed window's and ``warmup_launches`` its warm-up's; K1
and K2 add ``stream_launches``, those of the 16-frame stream and of the
2-lane fan in ``stream_path``; K3
adds its window launches and ms per rep under each overlap mode, the
``auto`` verdict and its thin-window time, and ``shard_stream_launches``,
those of the sharded streams in ``shard_stream_path``; K1 and K3 add
``serve_launches``, those of the serving engine in ``serve_path``; K1
adds ``net_launches``, those of the network tier in ``net_path``, and
``fed_launches``, those of the federation in ``fed_ctrl_path``; L2
adds ``tile_ms``, its body ``tile`` (K1's shipped tile) from phase
``l2``'s table beside ``current``, the baseline; ``halo_fill``'s
``launches`` are those of phase ``mesh_replay``, its ``ms``, ``bound_ms``
and ``library_ms`` phase ``halo_fill``'s at depth 8), the ``nvidia-smi``
name/power-limit line, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that line; without a CUDA device the script exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# The bounds (bytes over the card's memory rate, operations over its int32
# and float32 rates) come from tpu_stencil_torch.runtime.roofline, which
# the lab, the sweep and the autotuner's reports read as well.

MAIN_W, MAIN_H, MAIN_C, MAIN_REPS = 1920, 2520, 3, 40
FRAMES_SHAPE = (3, 320, 256, 3)
ODD_W, ODD_H = 1921, 2519  # indivisible by a 2x2 grid: the pad mask
MESHES = ((1, 1), (2, 2), (1, 4), (4, 1))
NO_LAUNCHES = {"stencil_fused": 0, "stencil_resident": 0, "stencil_valid": 0}
# What every K1 kernel's name holds: stencil_fused_kernel<k, body> (the
# shared tile's bodies) and stencil_fused_regs_kernel<k, C> (its own).
K1_NAME = "stencil_fused"
PALLAS = ["--backend", "pallas"]  # pins K1/K2/K3 at the default geometry
LAB_EXACT = ("current", "pair", "acc16", "swar", "tile")
# The filters that hold each tile body of K1 and K3.
BODY_FILTERS = {"swar": ("gaussian", "gaussian5", "identity"),
                "acc16": ("gaussian7", "box"),
                "int32": ("edge", "direct16")}
# Widths whose flat row (W * C) is not a multiple of 16 lanes, per C.
RAGGED_W = {1: 1917, 3: 1921}
# Runs of each K2 case in a row, every one compared: a stale read of
# another block's bytes shows as a rare difference between runs.
K2_REPEATS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed ({r.returncode}): {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def seeded(shape, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def plan_of(name: str):
    """The plan of a named filter; 'direct16' is a non-separable filter
    with a power-of-two divisor (a direct-int plan that shifts)."""
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import lowering

    if name == "direct16":
        return lowering.plan_filter(filters.from_numpy(
            np.array([[1, 1, 1], [1, 8, 1], [1, 1, 1]]), 16))
    return lowering.plan_filter(filters.get_filter(name))


def launches(**counts) -> dict:
    return {**NO_LAUNCHES, **counts}


def flat_plain(img: torch.Tensor, plan, reps: int) -> torch.Tensor:
    """The plain version of ``reps`` reps of an (H, W[, C]) image."""
    from tpu_stencil_torch.ops import cuda_stencil

    c = img.shape[2] if img.dim() == 3 else 1
    x2 = img.reshape(img.shape[0], -1)
    return cuda_stencil.stencil_fused_plain(x2, plan, c, reps).reshape(img.shape)


def check_body(kernel: str, plan, name: str, want: str = None) -> str:
    """The body ``kernel``'s library ran last must be the plan's (K1's
    ``fused_body``, K2's and K3's ``tile_body``; ``want`` where a launch
    forced another); returns it."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    if want is None:
        want = (cs.fused_body(plan) if kernel == "stencil_fused"
                else cs.tile_body(plan))
    ran = cs.ran_body(kernel)
    require(ran == want, f"{kernel} {name}: ran body {ran}, expected "
            f"{want}")
    return ran


def last_body(plan, rows: int, wc: int, c: int, reps: int, dev) -> str:
    """The body the last launch of a ``reps``-rep K1 loop on a flat
    (rows, wc) image runs (its ``cuda_stencil.K1Launch``)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    return cs.rep_loop(plan, rows, wc, c, None, None, None,
                       dev).launches(reps)[-1].body


def main_fuse(plan, dev) -> int:
    """K1's fused depth on the main path's 1920x2520 RGB image."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    return cs.rep_loop(plan, MAIN_H, MAIN_W * MAIN_C, MAIN_C, None, None,
                       None, dev).fuse


def phase_k1(dev) -> dict:
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops.stencil import reference_stencil_numpy
    from tpu_stencil_torch import filters

    worst, cases = 0, []

    def case(label, got, want, plan, name, body=None):
        nonlocal worst
        ran = check_body("stencil_fused", plan, name, body)
        err = max_err(got, want)
        worst = max(worst, err)
        cases.append({"case": label, "body": ran, "err": err})

    rgb = seeded((MAIN_H, MAIN_W, 3), 1, dev)
    g = plan_of("gaussian")
    # One launch of the wrapper at the main path's shapes, fused and single,
    # in K1's own body and at a forced tile height (the shared tile).
    x2 = rgb.reshape(MAIN_H, -1)
    bh = cs.DEFAULT_BLOCK_H
    for depth in (main_fuse(g, dev), 1):
        want = cs.stencil_fused_plain(x2, g, 3, depth)
        case(f"wrapper rgb gaussian fuse={depth}",
             cs.stencil_fused(x2, g, 3, depth), want, g, "gaussian")
        case(f"wrapper rgb gaussian fuse={depth} block_h={bh}",
             cs.stencil_fused(x2, g, 3, depth, block_h=bh), want, g,
             "gaussian", cs.tile_body(g))
    for reps in (1, 7, 8, 40):
        case(f"{tuple(rgb.shape)} gaussian x{reps}", cs.iterate(rgb, reps, g),
             flat_plain(rgb, g, reps), g, "gaussian")
    # Every body, grey and RGB, aligned and ragged widths, x9.
    for body, names in BODY_FILTERS.items():
        for c in (1, 3):
            for w in (MAIN_W, RAGGED_W[c]):
                shape = (MAIN_H, w, c) if c > 1 else (MAIN_H, w)
                img = seeded(shape, 2 + w + c, dev)
                for name in names:
                    p = plan_of(name)
                    require(cs.tile_body(p) == body,
                            f"{name} runs {cs.tile_body(p)}, not {body}")
                    case(f"{shape} {name} x9", cs.iterate(img, 9, p),
                         flat_plain(img, p, 9), p, name)
        # The frames layout (gap rows re-zeroed every rep).
        frames = seeded(FRAMES_SHAPE, 3, dev)
        p = plan_of(names[0])
        n, fh, fw, fc = FRAMES_SHAPE
        case(f"frames {FRAMES_SHAPE} {names[0]} x9",
             cs.iterate_frames(frames, 9, p),
             torch.stack([flat_plain(f, p, 9) for f in frames]), p, names[0],
             last_body(p, cs.frames_rows(p, fh, n), fw * fc, fc, 9, dev))
    regs = phase_k1_regs(dev, case)
    direct = phase_k1_direct(dev, case)
    # Small images against the pure-NumPy golden model (K1 and K2).
    small = np.random.default_rng(4).integers(0, 256, (21, 17, 3), np.uint8)
    for name in ("gaussian", "box", "edge", "gaussian5"):
        want = reference_stencil_numpy(small, filters.get_filter(name), 3)
        for sched in (None, "deep"):
            got = cs.iterate(torch.from_numpy(small).to(dev), 3, plan_of(name),
                             schedule=sched).cpu().numpy()
            err = int(np.abs(got.astype(int) - want.astype(int)).max())
            worst = max(worst, err)
            cases.append({"case": f"golden {name} x3 schedule={sched}",
                          "err": err})
    torch.cuda.synchronize()
    bad = [c for c in cases if c["err"]]
    require(not bad, f"K1 disagrees with its plain version: {bad}")
    return {"phase": "k1", "ok": True, "cases": len(cases),
            "max_abs_err": worst, "regs": regs, "regs_direct": direct,
            "no_fallback": check_no_fallback(dev)}


def phase_k1_regs(dev, case) -> dict:
    """K1's register body: gaussian and gaussian5, grey and RGB, aligned
    and ragged widths, single launches at fuse 1, 7 and 8, the rep loop
    x1, x9 and x100 and the frames layout x9, serve-bucket canvases at
    fuse 1 (the shared tile) and 8 (``regs``), each through ``case``;
    every launch counted under the body its ``K1Launch`` names; no instance
    spilling; then its ms a rep and the shared tile's at the cells' two
    shapes x100."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    cs.reset_launch_counts()
    swar_launches = 0
    for name in ("gaussian", "gaussian5"):
        p = plan_of(name)
        for c in (1, 3):
            for w in (MAIN_W, RAGGED_W[c]):
                shape = (MAIN_H, w, c) if c > 1 else (MAIN_H, w)
                img = seeded(shape, 20 + w + c, dev)
                x = img.reshape(MAIN_H, -1)
                for depth in (1, 7, 8):
                    case(f"regs {shape} {name} fuse={depth}",
                         cs.stencil_fused(x, p, c, depth),
                         cs.stencil_fused_plain(x, p, c, depth), p, name)
                for reps in (1, 9, 100):
                    case(f"regs {shape} {name} x{reps}",
                         cs.iterate(img, reps, p), flat_plain(img, p, reps),
                         p, name)
            fshape = FRAMES_SHAPE if c == 3 else FRAMES_SHAPE[:3]
            frames = seeded(fshape, 23 + c, dev)
            rows = cs.frames_rows(p, fshape[1], fshape[0])
            body = last_body(p, rows, fshape[2] * c, c, 9, dev)
            swar_launches += body == "swar"
            case(f"regs frames {fshape} {name} x9",
                 cs.iterate_frames(frames, 9, p),
                 torch.stack([flat_plain(f, p, 9) for f in frames]), p, name,
                 body)
        # Serve's canvases in the frames layout: a single rep leaves most
        # SMs idle in regs and runs the shared tile; 8 reps run regs.
        for c, n, fh, fw in ((3, 1, 64, 64), (3, 4, 256, 256),
                             (1, 1, 384, 2048)):
            rows, wc = cs.frames_rows(p, fh, n), fw * c
            x = seeded((rows, wc), 25 + rows + wc, dev)
            frame = (cs.frames_stride(p, fh), fh)
            for depth, body in ((1, "swar"), (8, "regs")):
                require(cs.k1_launch(p, rows, wc, c, depth, None,
                                     cs.sm_count(dev)).body == body,
                        f"{name} {rows}x{wc} fuse={depth}: not {body}")
                swar_launches += body == "swar"
                case(f"canvas {n}x{fh}x{fw}x{c} {name} fuse={depth}",
                     cs.stencil_fused(x, p, c, depth, rows - p.halo, frame),
                     cs.stencil_fused_plain(x, p, c, depth, rows - p.halo,
                                            frame), p, name, body)
    launched = cs.launch_counts()["stencil_fused"]
    bodies = cs.body_launch_counts()
    require(launched > 0 and swar_launches > 0 and bodies == {
        "regs": launched - swar_launches, "swar": swar_launches},
            f"K1's launches by body {bodies}, of {launched} ({swar_launches} "
            f"in the shared tile expected)")
    # Every instance of the body spills nothing: no local memory.
    from tpu_stencil_torch.ops import _build

    inst = {k: v for k, v in _build.ptxas_instances(
        _build.build_log("stencil_fused")).items() if len(k) == 3}
    require(len(inst) == len(cs.REGS_KS) * len(cs.REGS_CHANNELS),
            f"regs instances in the build log: {sorted(inst)}")
    for k, v in inst.items():
        require(v.get("spill", "").startswith("0 bytes stack frame, 0 bytes "
                                              "spill stores, 0 bytes spill "
                                              "loads"),
                f"regs instance {k} uses local memory: {v}")
    return {"launches": launched, "body_launches": bodies,
            "instances": {f"k{k} C{c}": v for (k, _, c), v in inst.items()},
            "ab": regs_ab(dev)}


# Direct 3x3 plans that cover every instance of K1's direct body (channels x
# finish) and a dyadic plan: name -> (taps, divisor).
DIRECT_PLANS = {
    "edge": ([[1, 4, 1], [4, 8, 4], [1, 4, 1]], 28),
    "asym17": ([[1, 2, 0], [3, 4, 1], [0, 3, 2]], 17),
    "asym16": ([[1, 2, 0], [3, 4, 1], [0, 3, 2]], 16),           # dyadic
    # 253 / this divisor rounds up to 9.0 in float32: no multiply-high
    # passes, so the body divides per field with __fdiv_rn
    "fdiv": ([[1, 4, 1], [4, 8, 4], [1, 4, 1]], 28.111112594604492),
}


def direct_plan(name: str):
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import lowering

    taps, d = DIRECT_PLANS[name]
    return lowering.plan_filter(filters.from_numpy(np.array(taps), d))


def phase_k1_direct(dev, case) -> dict:
    """K1's direct body ``regs_direct``: every instance's plan
    (``DIRECT_PLANS``), grey and RGB, aligned and ragged widths, single
    launches at fuse 1, 7 and 8 and the rep loop x9; edge x100 at the edge
    cell's 1920x5040 RGB and at 1920x2520 grey; serve's canvases at fuse 1
    and 8 (``regs_direct``: the SM rule is ``regs``' alone) and at fuse 1
    under a forced tile height (the shared tile's ``int32``); each through
    ``case``, every launch counted under the body its ``K1Launch`` names;
    then each register instance's registers and local memory from the card
    (``cudaFuncGetAttributes``) and its blocks per SM: no local memory, 2
    blocks an SM; and :func:`direct_canvas_ab`'s times."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    cs.reset_launch_counts()
    int32_launches = 0
    for name in DIRECT_PLANS:
        p = direct_plan(name)
        require(cs.fused_body(p) == "regs_direct",
                f"{name} runs {cs.fused_body(p)}, not regs_direct")
        for c in (1, 3):
            for w in (MAIN_W, RAGGED_W[c]):
                shape = (MAIN_H, w, c) if c > 1 else (MAIN_H, w)
                img = seeded(shape, 40 + w + c, dev)
                x = img.reshape(MAIN_H, -1)
                for depth in (1, 7, 8):
                    case(f"direct {shape} {name} fuse={depth}",
                         cs.stencil_fused(x, p, c, depth),
                         cs.stencil_fused_plain(x, p, c, depth), p, name)
                case(f"direct {shape} {name} x9", cs.iterate(img, 9, p),
                     flat_plain(img, p, 9), p, name)
    e = direct_plan("edge")
    for shape in ((2 * MAIN_H, MAIN_W, 3), (MAIN_H, MAIN_W)):
        img = seeded(shape, 45, dev)
        case(f"direct {shape} edge x100", cs.iterate(img, 100, e),
             flat_plain(img, e, 100), e, "edge")
    for c, n, fh, fw in ((3, 1, 64, 64), (3, 4, 256, 256),
                         (1, 1, 384, 2048)):
        rows, wc = cs.frames_rows(e, fh, n), fw * c
        x = seeded((rows, wc), 46 + rows + wc, dev)
        frame = (cs.frames_stride(e, fh), fh)
        for depth, bh in ((1, None), (8, None), (1, cs.DEFAULT_BLOCK_H)):
            body = "regs_direct" if bh is None else "int32"
            require(cs.k1_launch(e, rows, wc, c, depth, bh,
                                 cs.sm_count(dev)).body == body,
                    f"edge {rows}x{wc} fuse={depth}: not {body}")
            int32_launches += body == "int32"
            case(f"canvas {n}x{fh}x{fw}x{c} edge fuse={depth} block_h={bh}",
                 cs.stencil_fused(x, e, c, depth, rows - e.halo, frame, bh),
                 cs.stencil_fused_plain(x, e, c, depth, rows - e.halo,
                                        frame), e, "edge", body)
    launched = cs.launch_counts()["stencil_fused"]
    bodies = cs.body_launch_counts()
    require(bodies == {"regs_direct": launched - int32_launches,
                       "int32": int32_launches},
            f"K1's launches by body {bodies}, of {launched} "
            f"({int32_launches} in int32 expected)")
    # Every register instance from the card: no local memory, at most 128
    # registers (2 blocks of 256 threads an SM).
    instances = {}
    plans = [(f"regs {n}", plan_of(n)) for n in ("gaussian", "gaussian5")]
    plans += [(f"regs_direct {n}", direct_plan(n)) for n in DIRECT_PLANS]
    for label, p in plans:
        for c in (1, 3):
            rec = cs.k1_launch(p, MAIN_H, MAIN_W * c, c, cs.DEFAULT_FUSE,
                               None, cs.sm_count(dev))
            a = cs.instance_attributes(p, c, rec)
            a["blocks_per_sm"] = cs.blocks_per_sm(
                "stencil_fused", p, rec.tile_h, rec.fuse, c, rec.body,
                rec.tile_w)
            require(a["local_bytes"] == 0 and a["registers"] <= 128
                    and a["blocks_per_sm"] == 2,
                    f"{label} C{c}: {a}")
            instances[f"{label} C{c}"] = a
    return {"launches": launched, "body_launches": bodies,
            "instances": instances, "canvas_ab": direct_canvas_ab(dev)}


def direct_canvas_ab(dev, launches: int = 20) -> dict:
    """Edge at fuse 1, one launch on the frames canvas of each of serve's
    canvases (a 64^2 RGB frame, four 256^2 RGB frames, a 384x2048 grey
    frame) and of larger frames on both sides of the SM rule (1024^2,
    1536^2, 2048^2 RGB): device us a launch (``launches`` back to back on
    the card's clock, median of 7) in ``regs_direct`` and in the shared
    tile's ``int32`` (each launched from a ``cuda_stencil.K1Launch`` of
    that body through K1's launcher), each held to the plain version, the
    regs grid's blocks, and the body ``k1_launch`` picks."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.tools import _harness

    e = direct_plan("edge")
    sms = cs.sm_count(dev)
    out = {}
    for c, n, fh, fw in ((3, 1, 64, 64), (3, 4, 256, 256), (1, 1, 384, 2048),
                         (3, 1, 1024, 1024), (3, 1, 1536, 1536),
                         (3, 1, 2048, 2048)):
        rows, wc = cs.frames_rows(e, fh, n), fw * c
        x = seeded((rows, wc), 47 + rows + wc, dev)
        y = torch.empty_like(x)
        frame = (cs.frames_stride(e, fh), fh)
        want = cs.stencil_fused_plain(x, e, c, 1, rows - e.halo, frame)
        # a forced tile height builds the shared tile's record
        forced = {body: cs.k1_launch(e, rows, wc, c, 1, bh, sms)
                  for body, bh in (("regs_direct", None),
                                   ("int32", cs.DEFAULT_BLOCK_H))}
        require(all(r.body == b for b, r in forced.items()),
                f"canvas {n}x{fh}x{fw}x{c}: records {forced}")
        row = {"blocks": cs.regs_grid(e, c, 1, rows, wc),
               "picked": cs.k1_launch(e, rows, wc, c, 1, None, sms).body}
        lib = cs._fused_lib()
        for body in ("regs_direct", "int32"):
            def go(_, launch=forced[body]):
                for _ in range(launches):
                    cs._launch_k1(lib, x, y, launch, c, rows - e.halo, frame)
            run = _harness.device_timed(go, dev)
            row[f"{body}_us"] = statistics.median(
                run(1) for _ in range(7)) * 1e6 / launches
            cs.reset_launch_counts()
            go(1)
            require(cs.body_launch_counts() == {body: launches}
                    and torch.equal(y, want),
                    f"canvas {n}x{fh}x{fw}x{c} in {body}: "
                    f"{cs.body_launch_counts()}, {max_err(y, want)}")
        row["regs_direct_over_int32"] = row["regs_direct_us"] / row["int32_us"]
        out[f"{n}x{fh}x{fw}x{c}"] = row
    return out


def regs_ab(dev) -> dict:
    """K1 in its register body against the shared tile (``swar``, forced by
    a tile height) at the cells' shapes (1920x2520 RGB, 1920x5040 grey),
    gaussian x100: ms a rep taking turns (CUDA events, L2 flushed, median
    of 7: host issue included), the kernels' ms a rep on the card's clock
    (``tools._harness.device_timed``: the launches queued behind a sleep
    kernel; median of 7) and their launches, and each launch's instance:
    registers a thread, local memory, blocks per SM."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.tools import _harness

    g = plan_of("gaussian")
    out = {}
    for label, shape in (("rgb2520", (MAIN_H, MAIN_W, 3)),
                         ("grey5040", (2 * MAIN_H, MAIN_W))):
        img = seeded(shape, 31, dev)
        c = shape[2] if len(shape) == 3 else 1
        fns = {"regs": lambda: cs.iterate(img, 100, g),
               "swar": lambda: cs.iterate(img, 100, g,
                                          block_h=cs.DEFAULT_BLOCK_H)}
        row = {f"{k}_ms_per_rep": v / 100
               for k, v in interleaved_ms(fns, dev).items()}
        for name, fn in fns.items():
            run = _harness.device_timed(lambda n, fn=fn: fn(), dev)
            row[f"{name}_device_ms_per_rep"] = statistics.median(
                run(1) for _ in range(7)) * 1e3 / 100
            cs.reset_launch_counts()
            fn()
            row[f"{name}_launches"] = cs.body_launch_counts()
        for name, bh in (("regs", None), ("swar", cs.DEFAULT_BLOCK_H)):
            for fz in (cs.DEFAULT_FUSE, 1):
                rec = cs.describe_launch("stencil_fused", g, shape[0],
                                         shape[1] * c, c, bh, fz, dev)
                require(rec["body"] == name, f"{label}: {rec}")
                row[f"{name}_f{fz}"] = {
                    k: rec.get(k) for k in ("block_h", "tile_w", "grid",
                                            "threads", "smem_bytes",
                                            "registers", "spill",
                                            "blocks_per_sm")}
        row["regs_over_swar_device"] = (row["regs_device_ms_per_rep"]
                                        / row["swar_device_ms_per_rep"])
        out[label] = row
    return out


@contextlib.contextmanager
def failing_builds():
    """The kernel libraries fail to build inside the block (nvcc replaced
    by ``false``, an empty build directory), and the torch-ops path
    records its calls instead of running; yields that list of calls."""
    import tempfile

    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import lowering

    saved = (_build.nvcc_path, _build.BUILD_DIR, dict(_build._LOADED),
             lowering.iterate)
    called = []
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        _build.nvcc_path = lambda: "false"
        _build.BUILD_DIR = Path(tmp)
        _build._LOADED.clear()
        lowering.iterate = lambda *a, **k: called.append(a)
        try:
            yield called
        finally:
            (_build.nvcc_path, _build.BUILD_DIR, loaded,
             lowering.iterate) = saved
            _build._LOADED.clear()
            _build._LOADED.update(loaded)


@contextlib.contextmanager
def refused_launches(code: int):
    """Every K1 and K2 launch inside the block is refused by the card with
    cudaError_t ``code`` (raised as the wrappers raise a failed launch,
    before anything runs), and the torch-ops path records its calls
    instead of running; yields (torch-ops calls, kernels asked for)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    saved = (cs.stencil_fused, cs.stencil_resident, lowering.iterate)
    called, tried = [], []

    def refuse(name):
        def launch(*a, **k):
            tried.append(name)
            raise cs.KernelLaunchError(
                f"{name} launch failed: cudaError_t {code} (refused)", code)
        launch.launches = 0  # the counter launch_counts() reads
        return launch

    cs.stencil_fused = refuse("stencil_fused")
    cs.stencil_resident = refuse("stencil_resident")
    lowering.iterate = lambda *a, **k: called.append(a)
    try:
        yield called, tried
    finally:
        cs.stencil_fused, cs.stencil_resident, lowering.iterate = saved


def check_no_fallback(dev) -> dict:
    """With the kernel libraries failing to build, ``iterate`` on a card
    tensor must raise KernelBuildError, launch nothing and not call the
    torch-ops path, under the default schedule (K1) and under 'deep'
    (K2)."""
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs

    g = plan_of("gaussian")
    img = seeded((64, 48, 3), 13, dev)
    raised = {}
    with failing_builds() as called:
        cs.reset_launch_counts()
        for sched in (None, "deep"):
            try:
                cs.iterate(img, 9, g, schedule=sched)
            except _build.KernelBuildError as e:
                raised[str(sched)] = str(e).splitlines()[0]
    counts = cs.launch_counts()
    require(len(raised) == 2, f"a failed build did not raise: {raised}")
    require(counts == NO_LAUNCHES and not called,
            f"a failed build fell back: launches {counts}, torch ops "
            f"called {len(called)} times")
    return {"body": cs.tile_body(g), "raised": raised, "launches": counts}


def phase_divide(dev) -> dict:
    """The torch-ops paths' float32 divide on the card, against NumPy's
    correctly rounded divide, over every accumulator the box (/9) and edge
    (/28) plans can produce. Division by a host scalar is counted beside it
    (PyTorch multiplies by the reciprocal there); the port never uses it."""
    from tpu_stencil_torch.ops import lowering

    out = {}
    for d in (9.0, 28.0):
        acc = np.arange(0, 255 * int(d) + 1, dtype=np.float32)
        want = acc / np.float32(d)
        t = torch.from_numpy(acc).to(dev)
        port = lowering.divide_f32(t, d).cpu().numpy()
        host = (t / d).cpu().numpy()
        out[str(int(d))] = {"values": int(acc.size),
                            "port_mismatches": int((port != want).sum()),
                            "host_scalar_mismatches": int((host != want).sum())}
        require(out[str(int(d))]["port_mismatches"] == 0,
                f"divide_f32 by {d} is not correctly rounded on the card")
    return {"phase": "divide", "ok": True, "divisors": out}


def k2_fuse(dev) -> int:
    """K2's reps per grid sync at the main path's shape on this card."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    return cs.resident_launch_shape(plan_of("gaussian"), MAIN_H,
                                    MAIN_W * MAIN_C, MAIN_C, dev)["fuse"]


def feasibility_line(plan, w: int, c: int, dev) -> tuple:
    """(rows, rows + 2): the tallest even row count of a w-wide image that
    K2 takes on this card, and one just past it."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    lo, hi = MAIN_H // 2, 10 * MAIN_H  # lo rows fit, hi rows do not
    require(cs.resident_feasible(plan, 2 * lo, w * c, c, dev)
            and not cs.resident_feasible(plan, 2 * hi, w * c, c, dev),
            "the feasibility line is not between the search bounds")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if cs.resident_feasible(plan, 2 * mid, w * c, c, dev):
            lo = mid
        else:
            hi = mid
    return 2 * lo, 2 * hi


def phase_k2(dev) -> dict:
    """K2 through ``iterate``/``iterate_frames`` with ``schedule='deep'``
    against its plain version, byte for byte, each case run K2_REPEATS
    times in a row and every repeat compared (a stale read of another
    block's bytes would show as a rare difference): one K2 launch and no
    other per run, and the body it ran is ``tile_body``'s. Every body,
    grey and RGB at widths 1920, 1917 and 1921 x9; gaussian RGB at the
    rep counts around K2's reps per sync; 3 frames per body; and one shape
    each side of the feasibility line, the far side running K1 at the deep
    depth."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    fuse = k2_fuse(dev)
    worst, cases = 0, []

    def case(label, run, want, plan, name):
        nonlocal worst
        errs = []
        for _ in range(K2_REPEATS):
            cs.reset_launch_counts()
            got = run()
            counts = cs.launch_counts()
            require(counts == launches(stencil_resident=1),
                    f"deep {label}: launches {counts}")
            check_body("stencil_resident", plan, name)
            errs.append(max_err(got, want))
        worst = max(worst, *errs)
        cases.append({"case": label, "body": cs.tile_body(plan),
                      "errs": errs})

    g = plan_of("gaussian")
    rgb = seeded((MAIN_H, MAIN_W, 3), 1, dev)
    x2 = rgb.reshape(MAIN_H, -1)
    require(cs.resident_feasible(g, MAIN_H, MAIN_W * 3, 3, dev),
            "K2 must be feasible at 1920x2520 RGB")
    out = cs.stencil_resident(x2, g, 3, MAIN_REPS)
    wrapper_err = max_err(out, cs.stencil_resident_plain(x2, g, 3, MAIN_REPS))
    for reps in sorted({1, max(1, fuse - 1), fuse, fuse + 1, 7, MAIN_REPS}):
        case(f"{tuple(rgb.shape)} gaussian x{reps}",
             lambda reps=reps: cs.iterate(rgb, reps, g, schedule="deep"),
             flat_plain(rgb, g, reps), g, "gaussian")
    for body, names in BODY_FILTERS.items():
        for c in (1, 3):
            for w in (MAIN_W, RAGGED_W[1], RAGGED_W[3]):
                shape = (MAIN_H, w, c) if c > 1 else (MAIN_H, w)
                img = seeded(shape, 2 + w + c, dev)
                for name in names:
                    p = plan_of(name)
                    case(f"{shape} {name} x9",
                         lambda img=img, p=p: cs.iterate(img, 9, p,
                                                         schedule="deep"),
                         flat_plain(img, p, 9), p, name)
        frames = seeded(FRAMES_SHAPE, 3, dev)
        p = plan_of(names[0])
        case(f"frames {FRAMES_SHAPE} {names[0]} x9",
             lambda p=p: cs.iterate_frames(frames, 9, p, schedule="deep"),
             torch.stack([flat_plain(f, p, 9) for f in frames]), p, names[0])
    torch.cuda.synchronize()
    bad = [c for c in cases if any(c["errs"])]
    require(not bad and wrapper_err == 0,
            f"K2 disagrees with its plain version: {bad} (wrapper "
            f"{wrapper_err})")
    # The feasibility line: just inside runs K2, just past runs K1 at the
    # deep depth.
    near, far = feasibility_line(g, MAIN_W, 3, dev)
    line = {}
    for rows in (near, far):
        img = seeded((rows, MAIN_W, 3), 5, dev)
        fits = cs.resident_feasible(g, rows, MAIN_W * 3, 3, dev)
        loop = cs.rep_loop(g, rows, MAIN_W * 3, 3, None, None, "deep", dev)
        geo = ((None, None) if loop.fused is None
               else (loop.fused.tile_h, loop.fuse))
        cs.reset_launch_counts()
        got = cs.iterate(img, 8, g, schedule="deep")
        counts = cs.launch_counts()
        expect = (launches(stencil_resident=1) if fits else
                  launches(stencil_fused=len(cs.launch_schedule(8, geo[1]))))
        require(fits == (rows == near) and counts == expect,
                f"deep at {rows}x{MAIN_W} RGB (feasible {fits}): launches "
                f"{counts}, expected {expect}")
        err = max_err(got, flat_plain(img, g, 8))
        require(err == 0, f"deep at {rows}x{MAIN_W} RGB disagrees ({err})")
        line["inside" if fits else "past"] = {
            "shape": [rows, MAIN_W, 3], "reps": 8, "geometry": list(geo),
            "launches": counts, "max_abs_err": err}
    return {"phase": "k2", "ok": True, "cases": len(cases),
            "repeats": K2_REPEATS, "max_abs_err": max(worst, wrapper_err),
            "fuse": fuse, "bodies": sorted({c["body"] for c in cases}),
            "feasibility_line": line}


def parse_launches(report: str) -> dict:
    """The launch counts of a ``--time`` line's ``launches=`` field."""
    field = report.rsplit("launches=", 1)[1].split()[0]
    return {k: int(v) for k, v in (kv.split(":") for kv in field.split(","))}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in NO_LAUNCHES}


def cli_record(lines, res: dict, counts: dict, probed: bool = False) -> dict:
    """One CLI run: its ``Execution time`` and ``--time`` lines, the
    JobResult's windows and launches (``window``: the timed window's, as
    the ``--time`` line reports them; ``warmup``: the warm-up's before
    it), and ``counts``, every launch the wrappers counted in the run,
    which must be the two together (and, ``probed``, the autotuner's
    probes besides)."""
    for line in lines:
        print(line, flush=True)
    report = next((ln for ln in lines if ln.startswith("total (incl.")), "")
    rec = {"time_line": next(ln for ln in lines
                             if ln.startswith("Execution time:")),
           "report": report, "lines": lines,
           "window": res["launches"], "warmup": res["warmup_launches"],
           "counts": counts, "compute_seconds": res["compute_seconds"],
           "total_seconds": res["total_seconds"]}
    require(not report or parse_launches(report) == rec["window"],
            f"--time line {report} != the window's launches {rec['window']}")
    both = add_counts(rec["window"], rec["warmup"])
    require(all(counts[k] >= both[k] for k in both) if probed
            else counts == both,
            f"launches counted {counts} != window {rec['window']} + "
            f"warm-up {rec['warmup']}{' + probes' if probed else ''}")
    secs = rec["compute_seconds"]
    require(np.isfinite(secs) and secs > 0, f"bad compute window {secs}")
    return rec


def result_fields(res) -> dict:
    return {"compute_seconds": res.compute_seconds,
            "total_seconds": res.total_seconds, "launches": res.launches,
            "warmup_launches": res.warmup_launches}


def run_cli(args, expect_rc: int = 0) -> dict:
    """cli.main in this process, with the launch counters set to 0 just
    before it and read just after, and its JobResult kept
    (:func:`cli_record`)."""
    from tpu_stencil_torch import cli, driver
    from tpu_stencil_torch.ops import cuda_stencil as cs

    buf = io.StringIO()
    real = driver.run_job
    box = {}

    def keep(*a, **k):
        box["res"] = real(*a, **k)
        return box["res"]

    driver.run_job = keep
    cs.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
    finally:
        driver.run_job = real
    counts = cs.launch_counts()
    require(rc == expect_rc, f"cli.main{tuple(args)} returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    return cli_record(lines, result_fields(box["res"]), counts)


# ``python -m tpu_stencil_torch`` as a user runs it, plus one last line:
# the JobResult's windows and launches at full precision, and the
# process's launch counters.
COLD = """import json, sys
from tpu_stencil_torch import cli, driver
from tpu_stencil_torch.ops import cuda_stencil as cs
real, box = driver.run_job, {}
def keep(*a, **k):
    box["res"] = real(*a, **k)
    return box["res"]
driver.run_job = keep
rc = cli.main(sys.argv[1:])
r = box["res"]
print(json.dumps({"compute_seconds": r.compute_seconds,
                  "total_seconds": r.total_seconds, "launches": r.launches,
                  "warmup_launches": r.warmup_launches,
                  "counts": cs.launch_counts()}))
sys.exit(rc)
"""


def run_cli_cold(args, env=None, probed: bool = False) -> dict:
    """``python -m tpu_stencil_torch``'s entry point in a fresh process:
    a job in a process that has launched nothing yet (module load,
    shared-memory attributes, the allocator's first blocks), whose
    warm-up must keep that out of its window (:func:`cli_record`)."""
    r = subprocess.run([sys.executable, "-c", COLD, *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=env)
    require(r.returncode == 0,
            f"python -m tpu_stencil_torch exited {r.returncode}: {r.stderr}")
    lines = r.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    return cli_record(lines[:-1], res, res["counts"], probed)


def require_cold_near_warm(label: str, cold: float, warm: float) -> float:
    """The warm-up keeps first use out of the window: a cold window is at
    most twice the warm one, or within 1 ms of it, whichever allows more.
    Returns the bound."""
    bound = max(2.0 * warm, warm + 1e-3)
    require(cold <= bound, f"{label}: cold window {cold!r} s > {bound!r} s "
            f"(warm {warm!r} s): first use inside the window")
    return bound


def main_raw() -> tuple:
    """The seeded 1920x2520 RGB raw file of the main path: (path, image)."""
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "waterfall_1920_2520.raw"
    img = np.random.default_rng(6).integers(
        0, 256, (MAIN_H, MAIN_W, MAIN_C), np.uint8)
    img.tofile(src)
    return src, img


def phase_main_path(dev) -> dict:
    """The reference job through the CLI, default schedule (K1) and
    ``--schedule deep`` (K2): once in a fresh process (cold: the job a
    user runs) and once in this process with the launch counters set to 0
    just before and read just after (warm: the kernels were launched by
    the earlier phases)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    src, img = main_raw()
    g = plan_of("gaussian")
    want = lowering.iterate(torch.from_numpy(img).to(dev), MAIN_REPS,
                            g).cpu().numpy()
    fuse = main_fuse(g, dev)
    base = [str(src), str(MAIN_W), str(MAIN_H), str(MAIN_REPS), "rgb",
            "--time", *PALLAS]
    out = {}
    for label, extra, expect, warm, body in (
        ("default", [], launches(
            stencil_fused=MAIN_REPS // fuse + MAIN_REPS % fuse),
         launches(stencil_fused=len(set(cs.launch_schedule(MAIN_REPS,
                                                           fuse)))),
         cs.fused_body(g)),
        ("deep", ["--schedule", "deep"], launches(stencil_resident=1),
         launches(stencil_resident=1), cs.tile_body(g)),
    ):
        for temp, runner in (("cold", run_cli_cold), ("warm", run_cli)):
            dst = WORK / f"blur_{label}_{temp}.raw"
            r = runner(base + extra + ["--output", str(dst)])
            require(r["window"] == expect and r["warmup"] == warm,
                    f"main path {label} {temp}: launches {r['window']} + "
                    f"warm-up {r['warmup']}, expected {expect} + {warm}")
            require(f" body={body}" in r["report"],
                    f"main path {label} {temp} must report body={body}: "
                    f"{r['report']}")
            got = np.fromfile(dst, np.uint8).reshape(img.shape)
            err = int(np.abs(got.astype(int) - want.astype(int)).max())
            require(err == 0,
                    f"main path {label} {temp} disagrees with torch ops ({err})")
            out[f"{label}_{temp}"] = {
                "launches": r["counts"], "window_launches": r["window"],
                "warmup_launches": r["warmup"], "max_abs_err": err,
                "compute_seconds": r["compute_seconds"],
                "total_seconds": r["total_seconds"],
                "time_line": r["time_line"], "report": r["report"]}
        out[f"{label}_cold_bound_s"] = require_cold_near_warm(
            f"main path {label}", out[f"{label}_cold"]["compute_seconds"],
            out[f"{label}_warm"]["compute_seconds"])
    return {"phase": "main_path", "ok": True, "shape": list(img.shape),
            "reps": MAIN_REPS, "runs": out}


def ext_tile(img: torch.Tensor, i: int, j: int, grid, g: int) -> torch.Tensor:
    """The flat ghost-extended tile (i, j) of ``img`` (H, W[, C]) on an R x C
    grid with ``g`` ghosts per side, zeros past the image: what the zero
    boundary halo exchange hands K3."""
    th, tw = img.shape[0] // grid[0], img.shape[1] // grid[1]
    pad = [0, 0] * (img.dim() - 2) + [g, g, g, g]
    ext = torch.nn.functional.pad(img, pad)[
        i * th:(i + 1) * th + 2 * g, j * tw:(j + 1) * tw + 2 * g]
    return ext.contiguous().reshape(th + 2 * g, -1)


def phase_k3(dev) -> dict:
    """K3 against its plain version at every shard position of a 2x2 grid
    (corner, edge and interior origins all occur: each tile has two image
    edges and two neighbour edges), at the sharded path's shapes and at a
    width whose shards are odd, in every tile body."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    grid = (2, 2)
    worst, cases = 0, []
    for w in (MAIN_W, MAIN_W - 2):  # 1918: shards 959 pixels wide
        for c in (1, 3):
            shape = (MAIN_H, w, c) if c > 1 else (MAIN_H, w)
            img = seeded(shape, 11 + w + c, dev)
            th, tw = MAIN_H // grid[0], w // grid[1]
            glob = (MAIN_H, w * c)
            for body, names in BODY_FILTERS.items():
                for name in names:
                    p = plan_of(name)
                    for fuse in (1, 8):
                        for i in range(grid[0]):
                            for j in range(grid[1]):
                                ext = ext_tile(img, i, j, grid, fuse * p.halo)
                                got = cs.valid_fused(ext, p, fuse, c, i * th,
                                                     j * tw * c, glob)
                                check_body("stencil_valid", p, name)
                                want = cs.stencil_valid_plain(
                                    ext, p, c, fuse, i * th, j * tw * c, glob)
                                err = max_err(got, want)
                                worst = max(worst, err)
                                cases.append({
                                    "case": f"{name} {shape} fuse={fuse} "
                                            f"tile=({i},{j})",
                                    "body": body, "err": err})
    torch.cuda.synchronize()
    bad = [c for c in cases if c["err"]]
    require(not bad, f"K3 disagrees with its plain version: {bad}")
    return {"phase": "k3", "ok": True, "cases": len(cases),
            "max_abs_err": worst}


def run_runner(img: np.ndarray, name: str, reps: int, mesh, dev) -> tuple:
    """The sharded runner over ``[dev] * R*C``, counters set to 0 just
    before ``run`` and read just after. Returns (output, counts, fuse)."""
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    c = img.shape[2] if img.ndim == 3 else 1
    runner = ShardedRunner(IteratedConv2D(name, backend="pallas", device=dev),
                           img.shape[:2], c, mesh_shape=mesh,
                           devices=[dev] * (mesh[0] * mesh[1]))
    require(runner.backend == "pallas", f"sharded {name} ran {runner.backend}")
    tiles = runner.put(img)
    runner.prepare()
    cs.reset_launch_counts()
    out = runner.run(tiles, reps)
    torch.cuda.synchronize()
    counts = cs.launch_counts()
    return runner.fetch(out), counts, runner.fuse


def phase_sharded_path(dev) -> dict:
    """The sharded path: the runner at every mesh against K1 and the
    torch-ops path, the pad mask, a wide halo, the CLI with --mesh 1x1
    (cold and warm) and run_job over a 2x2 mesh on one card."""
    from tpu_stencil_torch import config, driver
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    src, img = main_raw()
    g = plan_of("gaussian")
    img_dev = torch.from_numpy(img).to(dev)
    want = lowering.iterate(img_dev, MAIN_REPS, g).cpu().numpy()
    k1 = cs.iterate(img_dev, MAIN_REPS, g).cpu().numpy()
    require(np.array_equal(k1, want), "K1 disagrees with torch ops")
    out = {}
    for mesh in MESHES:
        n = mesh[0] * mesh[1]
        got, counts, fuse = run_runner(img, "gaussian", MAIN_REPS, mesh, dev)
        expect = launches(stencil_valid=(MAIN_REPS // fuse + MAIN_REPS % fuse)
                          * n)
        require(counts == expect,
                f"mesh {mesh}: launches {counts}, expected {expect}")
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"mesh {mesh} disagrees with K1 / torch ops ({err})")
        out[f"{mesh[0]}x{mesh[1]}"] = {"fuse": fuse, "launches": counts,
                                      "max_abs_err": err}
    odd = np.random.default_rng(8).integers(0, 256, (ODD_H, ODD_W, 3),
                                            np.uint8)
    for label, im, name, reps, fuse_want in (
            ("mask_1921x2519", odd, "gaussian", 9, 1),
            ("gaussian5", img, "gaussian5", 9, None)):
        got, counts, fuse = run_runner(im, name, reps, (2, 2), dev)
        require(fuse_want is None or fuse == fuse_want,
                f"{label}: fuse {fuse}, expected {fuse_want}")
        expect = launches(stencil_valid=(reps // fuse + reps % fuse) * 4)
        require(counts == expect, f"{label}: launches {counts}, expected "
                f"{expect}")
        ref = lowering.iterate(torch.from_numpy(im).to(dev), reps,
                               plan_of(name)).cpu().numpy()
        err = int(np.abs(got.astype(int) - ref.astype(int)).max())
        require(err == 0, f"{label} disagrees with torch ops ({err})")
        out[label] = {"mesh": [2, 2], "reps": reps, "fuse": fuse,
                      "launches": counts, "max_abs_err": err}
    base = [str(src), str(MAIN_W), str(MAIN_H), str(MAIN_REPS), "rgb",
            "--time", "--mesh", "1x1", *PALLAS]
    expect = launches(stencil_valid=MAIN_REPS // cs.DEFAULT_FUSE
                      + MAIN_REPS % cs.DEFAULT_FUSE)
    for temp, runner in (("cold", run_cli_cold), ("warm", run_cli)):
        dst = WORK / f"blur_mesh1x1_{temp}.raw"
        r = runner(base + ["--output", str(dst)])
        require(r["window"] == expect
                and r["warmup"] == launches(stencil_valid=1),
                f"--mesh 1x1 {temp}: launches {r['window']} + warm-up "
                f"{r['warmup']}, expected {expect} + one K3 chunk")
        require("mesh=(1, 1)" in r["report"]
                and f" body={cs.tile_body(g)}" in r["report"],
                f"--mesh 1x1 {temp}: {r['report']}")
        got = np.fromfile(dst, np.uint8).reshape(img.shape)
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"--mesh 1x1 {temp} disagrees with torch ops ({err})")
        out[f"cli_mesh1x1_{temp}"] = {
            "launches": r["counts"], "window_launches": r["window"],
            "warmup_launches": r["warmup"], "max_abs_err": err,
            "compute_seconds": r["compute_seconds"],
            "total_seconds": r["total_seconds"], "report": r["report"]}
    out["cli_mesh1x1_cold_bound_s"] = require_cold_near_warm(
        "--mesh 1x1", out["cli_mesh1x1_cold"]["compute_seconds"],
        out["cli_mesh1x1_warm"]["compute_seconds"])
    dst = WORK / "blur_mesh2x2_run_job.raw"
    cfg = config.JobConfig(image=str(src), width=MAIN_W, height=MAIN_H,
                           repetitions=MAIN_REPS,
                           image_type=config.ImageType.RGB, mesh_shape=(2, 2),
                           backend="pallas", output=str(dst))
    res = driver.run_job(cfg, devices=[dev] * 4)
    expect = launches(stencil_valid=5 * 4)
    require(res.launches == expect and res.mesh_shape == (2, 2)
            and res.body == cs.tile_body(g),
            f"run_job 2x2: launches {res.launches} mesh {res.mesh_shape} "
            f"body {res.body}")
    got = np.fromfile(dst, np.uint8).reshape(img.shape)
    err = int(np.abs(got.astype(int) - want.astype(int)).max())
    require(err == 0, f"run_job 2x2 disagrees with torch ops ({err})")
    out["run_job_mesh2x2"] = {"launches": res.launches, "max_abs_err": err,
                              "body": res.body,
                              "compute_seconds": res.compute_seconds}
    worst = max(v["max_abs_err"] for v in out.values()
                if isinstance(v, dict))
    return {"phase": "sharded_path", "ok": True, "shape": list(img.shape),
            "reps": MAIN_REPS, "max_abs_err": worst, "runs": out}


def bound_ms_per_rep(plan, n_elems: int, reps: int, n_bytes: int = None):
    from tpu_stencil_torch.runtime import roofline

    return roofline.bound_ms_per_rep(plan, n_elems, reps, n_bytes)


def time_ms(fn, dev, runs: int = 7) -> float:
    """Median ms of ``fn`` over ``runs`` after a warm-up, CUDA events,
    with the L2 flushed (a 256 MB write) before each run."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def interleaved_ms(fns: dict, dev, runs: int = 7) -> dict:
    """Median ms of every ``name -> fn`` over ``runs`` rounds, the
    candidates taking turns within each round (CUDA events, L2 flushed
    before each timed run), after one warm-up each."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(v) for name, v in times.items()}


def library_conv2d_ms(img: torch.Tensor, plan, dev) -> float:
    """The library yardstick of one rep of ``plan``: one depthwise float32
    ``F.conv2d`` (TF32 off, ``padding=k//2``) with the plan's taps over its
    divisor, planar layout prepared outside the window. Timed only; the
    port never calls it."""
    torch.backends.cudnn.allow_tf32 = False
    c = img.shape[2]
    xf = img.permute(2, 0, 1)[None].to(torch.float32).contiguous()
    w = (torch.tensor(plan.taps, dtype=torch.float32, device=dev)
         / plan.divisor).expand(c, 1, plan.k, plan.k).contiguous()
    return time_ms(lambda: torch.nn.functional.conv2d(
        xf, w, padding=plan.k // 2, groups=c), dev)


# K2's design choices timed beside it: its tile (rows x reps per sync) and
# the band form's reps per sync.
K2_ALTERNATIVES = ("deep_b32_f8", "deep_b40_f8", "deep_b48_f8",
                   "deep_b56_f8", "deep_b64_f8", "deep_b48_f12",
                   "deep_b64_f16", "band_f1", "band_f2", "band_f4")


def resident_ab(img: torch.Tensor, dev) -> dict:
    """K2 as shipped against K1 (the default schedule), the kernel lab's
    ``band`` form of K2, and the alternatives K2's design chose between
    (:data:`K2_ALTERNATIVES`, through the kernel lab's variants, each
    checked exact), all on gaussian and taking turns (ms per rep x40,
    median of 7, L2 flushed); each K2 form's launch (tile, reps per sync,
    threads, blocks per SM, grid) and its shared memory, the library's own
    against the host model."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import kernel_lab

    g = plan_of("gaussian")
    n, wc = MAIN_REPS, MAIN_W * MAIN_C
    fns = {"k1": lambda: cs.iterate(img, n, g),
           "k2": lambda: cs.iterate(img, n, g, schedule="deep"),
           "band": lambda: lab.band_iterate(img, n, g)}
    want = flat_plain(img, g, n)
    for name in K2_ALTERNATIVES:
        fn = kernel_lab.variant_fn(name, g, img)[0]
        err = max_err(fn(n), want)
        require(err == 0, f"{name} disagrees with its plain version ({err})")
        fns[name] = lambda fn=fn: fn(n)
    row = {k: v / n for k, v in interleaved_ms(fns, dev).items()}
    row["k2_over_k1"] = row["k2"] / row["k1"]
    row["band_over_k2"] = row["band"] / row["k2"]
    row["k2_launch"] = cs.resident_launch_shape(g, MAIN_H, wc, MAIN_C, dev)
    row["band_launch"] = lab.band_launch_shape(g, MAIN_H, wc, MAIN_C, dev)
    bh, fz = cs.resident_geometry(g, MAIN_H, wc, MAIN_C,
                                  cs.device_caps(dev)[1])
    require(cs.resident_kernel_smem_bytes(g, MAIN_H, wc, MAIN_C, dev)
            == cs.tile_smem_bytes(g, bh, fz, MAIN_C)
            == row["k2_launch"]["smem_bytes"],
            "K2: the host's shared-memory model disagrees with the library's")
    require(lab.band_kernel_smem_bytes(g, MAIN_H, wc, MAIN_C)
            == row["band_launch"]["smem_bytes"],
            "band: the host's shared-memory model disagrees with the "
            "library's")
    return row


def phase_l2(dev) -> dict:
    """L2 against its plain versions and K1, the lab tool, the timing
    table."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import kernel_lab

    rgb = seeded((MAIN_H, MAIN_W, 3), 21, dev)
    grey = seeded((MAIN_H, MAIN_W), 22, dev)
    worst, cases = 0, []
    for img, fname, geos in ((rgb, "gaussian", ((32, 8), (64, 4), (32, 1))),
                             (rgb, "gaussian5", ((32, 8),)),
                             (grey, "gaussian", ((32, 8),))):
        plan = plan_of(fname)
        c = img.shape[2] if img.dim() == 3 else 1
        x2 = img.reshape(img.shape[0], -1)
        for bh, fz in geos:
            bh, fz = cs.effective_geometry(plan, MAIN_H, c, bh, fz)
            k1 = cs.stencil_fused(x2, plan, c, fz, block_h=bh)
            for name in LAB_EXACT:
                v = lab.parse_variant(name)
                require(lab.variant_supported(v, plan),
                        f"lab variant {name} must run {fname}")
                got = lab.stencil_lab(x2, plan, c, fz, v, block_h=bh)
                err = max(max_err(got, lab.stencil_lab_plain(x2, plan, c, fz,
                                                             v)),
                          max_err(got, k1))
                model = lab.lab_smem_bytes(v, plan, bh, fz, c)
                kern = lab.kernel_smem_bytes(v, plan, bh, fz, c)
                require(model == kern, f"{name} {bh}x{fz}: the host's shared-"
                        f"memory model says {model}, the library {kern}")
                worst = max(worst, err)
                cases.append({"case": f"{fname} C={c} {name} {bh}x{fz}",
                              "err": err})
        # the whole rep loop, fused launches and single-rep remainders
        k1 = cs.iterate(img, 9, plan)
        for name in LAB_EXACT:
            err = max_err(lab.lab_iterate(img, 9, plan,
                                          lab.parse_variant(name)), k1)
            worst = max(worst, err)
            cases.append({"case": f"{fname} C={c} {name} x9", "err": err})
    torch.cuda.synchronize()
    bad = [c for c in cases if c["err"]]
    require(not bad, f"L2 disagrees with its plain version or K1: {bad}")
    # The tool, as a user runs it (in this process: the counter is read).
    buf = io.StringIO()
    lab.reset_launch_counts()
    tool = kernel_lab.run_lab([], dev, reps=400, rounds=1, out=buf)
    tool_launches = lab.launch_counts()["stencil_lab"]
    for line in buf.getvalue().strip().splitlines():
        print(line, flush=True)
    inexact = [n for n, r in tool.items() if r["exact"] is False]
    require(not inexact, f"kernel_lab: not exact: {inexact}")
    require(tool_launches > 0, "kernel_lab launched stencil_lab no time")
    # The timing table: every variant of the tool's table, x40, within
    # this one call, taking turns.
    g = plan_of("gaussian")
    fns = {n: (lambda f=kernel_lab.variant_fn(n, g, rgb)[0]: f(MAIN_REPS))
           for n in kernel_lab.DEFAULT_VARIANTS}
    table = {n: t / MAIN_REPS for n, t in interleaved_ms(fns, dev).items()}
    return {"phase": "l2", "ok": True, "cases": len(cases),
            "max_abs_err": worst, "tool_launches": tool_launches,
            "tool_us_per_rep": {n: r["us_per_rep"] for n, r in tool.items()},
            "ms_per_rep_x40": table,
            "current_over_shipped": table["current"] / table["shipped"]}


L1_GRID = 16  # tiles of each of phase l1's extra checks


def l1_tiles(case: str) -> list:
    """(label, in_block, block, wc) of phase l1's checks of ``case``: the
    tool's tile (its launch model and occupancy; its values are the
    tool's own checks), a ragged width (whole words for ``vadd4_u8``,
    whole warps for ``shfl*``), the tool's tile behind views offset by one
    byte, and a short tile (the row-neighbour cases' shared-memory forms,
    lane rolls below a warp; the band products storing rows past 144)."""
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import op_cost

    ib, b, wc, _ = op_cost.tile_for(case)
    ragged = {"vadd4_u8": 316, "shfl1_add_i32": 288,
              "shfl3_add_i32": 288}.get(case, 318)
    if case.startswith("mxu_rows"):
        short = (160, 150, 72)
    else:
        short = (max(40, 20 + 16 * lab.ROW_SHRINK.get(case, 0)), 20,
                 32 if case.startswith("shfl") else 20)
    return [("tool", ib, b, wc), ("ragged", ib, b, ragged),
            ("unaligned", ib, b, wc), ("short", *short)]


def l1_checks(dev) -> dict:
    """Every L1 case at every built chain on :func:`l1_tiles`' tiles
    against its plain version; the host's launch model against the
    library's; resident blocks per SM at the tool's tile."""
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import op_cost

    keys = ("form", "blocks", "threads", "smem_bytes")
    worst, flat, n_checks, per_sm, forms = 0, [], 0, {}, {}
    for ci, case in enumerate(lab.CASES):
        tol = op_cost.TOLERANCE.get(case, 0)
        for label, ib, b, wc in l1_tiles(case):
            grid = op_cost.tile_for(case)[3] if label == "tool" else L1_GRID
            for n in lab.BUILT_N_OPS:
                model = lab.op_chain_shape(case, n, ib, b, wc, grid)
                kern = lab.op_chain_kernel_shape(case, n, ib, b, wc, grid)
                require({k: model[k] for k in keys}
                        == {k: kern[k] for k in keys}
                        and lab.op_chain_kernel_smem_bytes(case, n, ib, b, wc)
                        == lab.op_chain_smem_bytes(case, n, ib, b, wc),
                        f"{case} n={n} {label} {ib}x{wc}: the host's launch "
                        f"model {model} disagrees with the library's {kern}")
                if label == "tool":
                    per_sm.setdefault(case, {})[n] = kern["blocks_per_sm"]
                    forms[case] = kern["form"]
                    require(not kern["smem_bytes"]
                            or kern["blocks_per_sm"] >= 2,
                            f"{case} n={n}: {kern['blocks_per_sm']} block(s) "
                            f"per SM with {kern['smem_bytes']} B of shared "
                            "memory")
                    continue
                x = seeded((grid * ib, wc), 100 + ci, dev)
                out = None
                if label == "unaligned":
                    buf = torch.empty(x.numel() + 1, dtype=torch.uint8,
                                      device=dev)
                    x = buf[1:].view(x.shape).copy_(x)
                    obuf = torch.empty(grid * b * wc + 1, dtype=torch.uint8,
                                       device=dev)
                    out = obuf[1:].view(grid * b, wc)
                    require(x.data_ptr() % 2 == 1 and out.data_ptr() % 2 == 1,
                            "the unaligned views are aligned")
                got = lab.op_chain(x, case, n, ib, b, out=out)
                want = lab.op_chain_plain(x, case, n, ib, b)
                err = max_err(got, want)
                require(err <= tol, f"L1 {case} n={n} {label} {ib}x{b}x{wc}: "
                        f"max |kernel - plain| {err} > {tol}")
                if n == lab.CHECK_N_OPS and bool(want.min() == want.max()):
                    flat.append(f"{case} {label}")
                worst = max(worst, err)
                n_checks += 1
    torch.cuda.synchronize()
    require(not flat, f"L1: the check chain's output is constant for {flat}")
    return {"checks": n_checks, "max_abs_err": worst, "forms": forms,
            "blocks_per_sm": per_sm,
            "tiles": {c: l1_tiles(c)[1:] for c in ("add_i32", "vadd4_u8",
                                                   "shfl1_add_i32",
                                                   "mis_slice_add_i32",
                                                   "mxu_rows_bf16")}}


def phase_l1(dev) -> dict:
    """L1 against its plain version at the check chain (3: no case's
    output is constant there) and at both timed chains through the op
    cost tool, whose table it then prints; then :func:`l1_checks`."""
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import op_cost

    t0 = time.perf_counter()
    buf = io.StringIO()
    lab.reset_launch_counts()
    res = op_cost.run_cases([], dev, reps=100, rounds=3, out=buf)
    tool_launches = lab.launch_counts()["op_chain"]
    torch.cuda.synchronize()
    for line in buf.getvalue().strip().splitlines():
        print(line, flush=True)
    bad = {n: r["max_abs_err"] for n, r in res.items() if not r["exact"]}
    require(not bad, f"L1 disagrees with its plain version: {bad}")
    require(len(res) == len(lab.CASES), "op_cost skipped a case")
    flat = [n for n, r in res.items() if not r["check_varies"]]
    require(not flat, f"L1: the check chain's output is constant for {flat}: "
            "the comparison there could not tell a wrong kernel")
    require(tool_launches > 0, "op_cost launched op_chain no time")
    tool_s = time.perf_counter() - t0
    more = l1_checks(dev)
    return {"phase": "l1", "ok": True,
            "cases": len(lab.BUILT_N_OPS) * len(res),
            "chains": list(lab.BUILT_N_OPS),
            "max_abs_err": max(max(r["max_abs_err"] for r in res.values()),
                               more["max_abs_err"]),
            "tolerance": "0; 1 for mul_add_f32 and mxu_rows_bf16 (float32 "
                         "products)",
            "max_abs_err_by_case": {n: r["max_abs_err"]
                                    for n, r in res.items()},
            "tool_launches": tool_launches,
            "us_per_op_pass": {n: r["us_per_op_pass"] for n, r in res.items()},
            "bound_us_per_op_pass": {n: r["bound_us_per_op_pass"]
                                     for n, r in res.items()},
            "chain_us": {n: r["chain_us"] for n, r in res.items()},
            "more": more, "seconds": {"tool": tool_s,
                                      "all": time.perf_counter() - t0}}


def probe_split(img: np.ndarray, dev, repeats: int = 7) -> dict:
    """The 2x2 runner's time split by its trace probes: ``repeats`` runs of
    ``ShardedRunner.trace_phase_probes`` (one chunk's exchange alone, one
    chunk's K3 on the four tiles alone), median ms of each, beside the
    untraced runner's ms per chunk (the median of ``repeats`` runs of the
    whole rep loop over its chunk count)."""
    from tpu_stencil_torch import obs
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    runner = ShardedRunner(IteratedConv2D("gaussian", backend="pallas",
                                          device=dev), img.shape[:2],
                           img.shape[2], mesh_shape=(2, 2),
                           devices=[dev] * 4)
    tiles = runner.put(img)
    runner.prepare()
    torch.cuda.synchronize()
    runner.warmup(tiles, runner.warm_reps([MAIN_REPS]))
    torch.cuda.synchronize()
    obs.reset()
    obs.enable()
    try:
        for _ in range(repeats):
            runner.trace_phase_probes(tiles)
        spans = obs.get_tracer().spans()
    finally:
        obs.reset()
    per = {}
    for name in ("sharded.halo_exchange", "sharded.interior_compute"):
        per[name] = statistics.median(
            1e3 * r.seconds for r in spans if r.name == name)
    chunks = len(cs.launch_schedule(MAIN_REPS, runner.fuse))
    whole = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(tiles, MAIN_REPS)
        torch.cuda.synchronize()
        whole.append(1e3 * (time.perf_counter() - t0) / chunks)
    return {"fuse": runner.fuse, "chunks": chunks,
            "exchange_ms_per_chunk": per["sharded.halo_exchange"],
            "k3_ms_per_chunk": per["sharded.interior_compute"],
            "runner_ms_per_chunk": statistics.median(whole),
            "repeats": repeats}


def phase_job_hardened(dev) -> dict:
    """The hardened, observable job at 1920x2520 RGB gaussian x40 on the
    card, every run byte-equal to the torch-ops path, the launch counters
    set to 0 just before each and read just after: the fallback ladder
    under an injected ``compile`` OOM; a checkpointed run killed at rep 25
    and resumed, through the CLI and through ``run_job`` on a 2x2 mesh of
    this card; a forced build failure; ``--trace`` (and the 2x2 runner's
    exchange/compute probes); ``--breakdown`` under ``deep``;
    ``--metrics-text`` under the dispatch watchdog; ``--profile``."""
    from tpu_stencil_torch import config, driver, obs
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering
    from tpu_stencil_torch.resilience import errors, faults

    src, img = main_raw()
    g = plan_of("gaussian")
    want = lowering.iterate(torch.from_numpy(img).to(dev), MAIN_REPS,
                            g).cpu().numpy()
    fuse = main_fuse(g, dev)
    k1_window = launches(stencil_fused=len(cs.launch_schedule(MAIN_REPS,
                                                              fuse)))
    base = [str(src), str(MAIN_W), str(MAIN_H), str(MAIN_REPS), "rgb",
            "--time", *PALLAS]
    out = {}

    def check_file(dst, label) -> int:
        got = np.fromfile(dst, np.uint8).reshape(img.shape)
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"{label} disagrees with torch ops ({err})")
        return err

    def fallbacks() -> int:
        return obs.snapshot()["counters"].get("resilience_fallbacks_total", 0)

    def keep(label, r, err, **extra):
        out[label] = {"window_launches": r["window"],
                      "warmup_launches": r["warmup"],
                      "launches": r["counts"], "max_abs_err": err,
                      "compute_seconds": r["compute_seconds"],
                      "total_seconds": r["total_seconds"],
                      "report": r["report"], **extra}
        return out[label]

    def cli(label, extra, window, warm, injected=0):
        obs.reset()
        faults.reset()
        dst = WORK / f"blur_hard_{label}.raw"
        r = run_cli(base + extra + ["--output", str(dst)])
        require(r["window"] == window and r["warmup"] == warm,
                f"{label}: launches {r['window']} + warm-up {r['warmup']}, "
                f"expected {window} + {warm}")
        require(fallbacks() == injected,
                f"{label}: resilience_fallbacks_total {fallbacks()}, "
                f"expected {injected}")
        return r, check_file(dst, label)

    # The ladder: an injected OOM at the warm-up of pallas[deep] demotes
    # to pallas (K1 at its default geometry), once, loudly.
    r, err = cli("ladder", ["--schedule", "deep", "--faults",
                            "compile:raise=oom"], k1_window,
                 launches(stencil_fused=1), injected=1)
    require("schedule=fused" in r["report"], f"ladder: {r['report']}")
    keep("ladder_deep_to_pallas", r, err, fallbacks=1)

    # Checkpoint every 10, killed at rep 25, resumed from rep 20: the
    # window launches cover only the 20 remaining reps.
    obs.reset()
    dst = WORK / "blur_hard_ckpt.raw"
    argv = base + ["--checkpoint-every", "10", "--output", str(dst)]
    try:
        run_cli(argv + ["--faults", "compute:rep=25"])
        killed = None
    except errors.InjectedFault as e:
        killed = (e.point, e.index)
    faults.reset()
    require(killed == ("compute", 25), f"checkpoint run not killed: {killed}")
    meta = json.loads(Path(str(dst) + ".ckpt.json").read_text())
    require(meta["rep"] == 20, f"checkpoint at rep {meta['rep']}, not 20")
    obs.reset()
    r = run_cli(argv + ["--resume"])
    chunk = cs.launch_schedule(10, fuse)
    require(r["window"] == launches(stencil_fused=2 * len(chunk))
            and 2 * sum(chunk) == MAIN_REPS - 20,
            f"resume: launches {r['window']} for 20 remaining reps")
    require(fallbacks() == 0, "resume demoted")
    require(not Path(str(dst) + ".ckpt.json").exists(),
            "the checkpoint outlived the finished job")
    keep("checkpoint_resume", r, check_file(dst, "checkpoint resume"),
         resumed_from=meta["rep"])

    # The same on a 2x2 mesh of this card, through run_job.
    dst = WORK / "blur_hard_ckpt_mesh.raw"
    cfg = config.JobConfig(image=str(src), width=MAIN_W, height=MAIN_H,
                           repetitions=MAIN_REPS,
                           image_type=config.ImageType.RGB,
                           mesh_shape=(2, 2), backend="pallas",
                           output=str(dst))
    obs.reset()
    faults.configure("compute:rep=25")
    try:
        driver.run_job(cfg, devices=[dev] * 4, checkpoint_every=10)
        killed = None
    except errors.InjectedFault as e:
        killed = (e.point, e.index)
    faults.reset()
    require(killed == ("compute", 25), f"mesh run not killed: {killed}")
    meta = json.loads(Path(str(dst) + ".ckpt.json").read_text())
    require(meta["rep"] == 20 and meta["data"].endswith(".r20"),
            f"mesh checkpoint {meta}")
    cs.reset_launch_counts()
    res = driver.run_job(cfg, devices=[dev] * 4, checkpoint_every=10,
                         resume=True)
    counts = cs.launch_counts()
    chunk = cs.launch_schedule(10, res.fuse or cs.DEFAULT_FUSE)
    want_window = launches(stencil_valid=2 * len(chunk) * 4)
    require(res.launches == want_window
            and counts == add_counts(res.launches, res.warmup_launches),
            f"mesh resume: launches {res.launches} + warm-up "
            f"{res.warmup_launches}, counted {counts}, expected window "
            f"{want_window}")
    require(fallbacks() == 0, "mesh resume demoted")
    out["checkpoint_resume_mesh2x2"] = {
        "window_launches": res.launches,
        "warmup_launches": res.warmup_launches, "launches": counts,
        "max_abs_err": check_file(dst, "mesh checkpoint resume"),
        "compute_seconds": res.compute_seconds,
        "total_seconds": res.total_seconds, "resumed_from": 20}

    # A card job never leaves the card: the CPU rung is refused outright.
    cs.reset_launch_counts()
    refused = None
    try:
        driver.run_job(config.JobConfig(
            image=str(src), width=MAIN_W, height=MAIN_H,
            repetitions=MAIN_REPS, image_type=config.ImageType.RGB,
            backend="pallas", fallback_backend="cpu",
            output=str(WORK / "blur_hard_cpu_rung.raw")), devices=[dev])
    except ValueError as e:
        refused = str(e)
    require(refused is not None and cs.launch_counts() == NO_LAUNCHES,
            f"--fallback-backend cpu on the card: {refused}, launches "
            f"{cs.launch_counts()}")
    out["cpu_rung_refused"] = {"raised": refused}

    # A launch the card refuses for lack of resources (cudaError_t 701)
    # fails the job typed: K2's is demoted to K1 (counted), K1's raises;
    # the torch ops are never called.
    for sched, demoted, asked in (
            (None, 0, ["stencil_fused"]),
            ("deep", 1, ["stencil_resident", "stencil_fused"])):
        obs.reset()
        lcfg = config.JobConfig(image=str(src), width=MAIN_W, height=MAIN_H,
                                repetitions=MAIN_REPS,
                                image_type=config.ImageType.RGB,
                                backend="pallas", schedule=sched,
                                output=str(WORK / "blur_hard_refused.raw"))
        code = None
        with refused_launches(701) as (called, tried):
            try:
                driver.run_job(lcfg, devices=[dev])
            except cs.KernelLaunchError as e:
                code = e.code
        require(code == 701 and not called and tried == asked
                and fallbacks() == demoted,
                f"refused launch ({sched}): raised {code}, torch ops "
                f"{len(called)}, kernels asked {tried}, fallbacks "
                f"{fallbacks()}")
        out[f"launch_refused_{sched or 'fused'}"] = {
            "raised_code": code, "kernels_asked": tried,
            "fallbacks": demoted, "torch_ops_calls": 0}

    # A kernel that does not build fails the job: no launch, no demotion,
    # no torch ops.
    obs.reset()
    bcfg = config.JobConfig(image=str(src), width=MAIN_W, height=MAIN_H,
                            repetitions=MAIN_REPS,
                            image_type=config.ImageType.RGB,
                            backend="pallas", schedule="deep",
                            output=str(WORK / "blur_hard_nobuild.raw"))
    raised = None
    with failing_builds() as called:
        cs.reset_launch_counts()
        try:
            driver.run_job(bcfg, devices=[dev])
        except _build.KernelBuildError as e:
            raised = str(e).splitlines()[0]
    counts = cs.launch_counts()
    require(raised is not None, "a failed build did not fail the job")
    require(counts == NO_LAUNCHES and not called and fallbacks() == 0,
            f"a failed build was demoted: launches {counts}, torch ops "
            f"{len(called)}, fallbacks {fallbacks()}")
    out["build_failure"] = {"raised": raised, "launches": counts,
                            "fallbacks": 0}

    # --trace: one fenced launch per rep, 40 iterate.rep spans.
    trace = WORK / "hard_trace.json"
    r, err = cli("trace", ["--trace", str(trace)],
                 launches(stencil_fused=MAIN_REPS),
                 launches(stencil_fused=1))
    evs = [e for e in json.loads(trace.read_text())["traceEvents"]
           if e.get("ph") == "X"]
    rep_us = [e["dur"] for e in evs if e["name"] == "iterate.rep"]
    require(len(rep_us) == MAIN_REPS, f"trace has {len(rep_us)} iterate.rep")
    keep("trace", r, err, iterate_rep_us_median=statistics.median(rep_us),
         iterate_rep_us_sum=sum(rep_us))
    # The sharded probes in a traced run_job on the 2x2 mesh, then the
    # split they give, taken several times.
    obs.reset()
    obs.enable()
    try:
        cs.reset_launch_counts()
        res = driver.run_job(config.JobConfig(
            image=str(src), width=MAIN_W, height=MAIN_H,
            repetitions=MAIN_REPS, image_type=config.ImageType.RGB,
            mesh_shape=(2, 2), backend="pallas",
            output=str(WORK / "blur_hard_trace_mesh.raw")),
            devices=[dev] * 4)
        spans = obs.get_tracer().spans()
    finally:
        obs.reset()
    probes = {n: [1e3 * sp.seconds for sp in spans if sp.name == n]
              for n in ("sharded.halo_exchange", "sharded.interior_compute",
                        "iterate.rep")}
    require(len(probes["sharded.halo_exchange"]) == 1
            and len(probes["sharded.interior_compute"]) == 1
            and len(probes["iterate.rep"]) == MAIN_REPS,
            f"traced 2x2 run spans: { {k: len(v) for k, v in probes.items()} }")
    require(res.launches == launches(stencil_valid=MAIN_REPS * 4),
            f"traced 2x2 window launches {res.launches}")
    check_file(WORK / "blur_hard_trace_mesh.raw", "traced 2x2")
    split = probe_split(img, dev)
    print(f"2x2 runner on one card: exchange "
          f"{probes['sharded.halo_exchange'][0]:.4f} ms, K3 "
          f"{probes['sharded.interior_compute'][0]:.4f} ms per chunk of "
          f"{split['fuse']} reps (traced run_job); medians of "
          f"{split['repeats']}: exchange {split['exchange_ms_per_chunk']:.4f}"
          f" ms, K3 {split['k3_ms_per_chunk']:.4f} ms, whole runner "
          f"{split['runner_ms_per_chunk']:.4f} ms per chunk", flush=True)
    out["trace_mesh2x2"] = {
        "exchange_ms": probes["sharded.halo_exchange"][0],
        "k3_ms": probes["sharded.interior_compute"][0],
        "compute_seconds": res.compute_seconds,
        "total_seconds": res.total_seconds, "window_launches": res.launches,
        "warmup_launches": res.warmup_launches, "probe_split": split}

    # --breakdown under deep: K2 launched one rep at a time, the kernel
    # instance with the card's registers and occupancy, the memory line.
    r, err = cli("breakdown", ["--schedule", "deep", "--breakdown"],
                 launches(stencil_resident=MAIN_REPS),
                 launches(stencil_resident=1))
    text = "\n".join(r["lines"])
    mem = next((ln for ln in r["lines"]
                if ln.startswith("device memory: bytes_in_use=")), None)
    inst = next((ln for ln in r["lines"]
                 if ln.strip().startswith("stencil_resident body=")), "")
    require(mem is not None, f"--breakdown printed no memory line:\n{text}")
    require("regs=-" not in inst and "blocks/SM=-" not in inst and inst,
            f"--breakdown instance without the card's numbers: {inst!r}")
    keep("breakdown_deep", r, err, memory_line=mem, instance=inst.strip())

    # --metrics-text under the dispatch watchdog (its first use in this
    # process): an exact round-trip with the device-memory gauges, and a
    # window held to the same job's without the watchdog, as main_path
    # holds a cold window to a warm one.
    plain, _ = cli("no_watchdog", [], k1_window, launches(stencil_fused=1))
    mpath = WORK / "hard_metrics.txt"
    r, err = cli("metrics", ["--metrics-text", str(mpath),
                             "--dispatch-timeout", "60"], k1_window,
                 launches(stencil_fused=1))
    watchdog_bound = require_cold_near_warm(
        "--dispatch-timeout 60", r["compute_seconds"],
        plain["compute_seconds"])
    text = mpath.read_text()
    snap = obs.exposition.parse_text(text, prefix="tpu_stencil_driver")
    require(snap == obs.snapshot(), "--metrics-text does not round-trip")
    require(text.endswith(obs.exposition.render_text(
        snap, prefix="tpu_stencil_driver")),
            "--metrics-text is not the snapshot's exact text")
    require("device_bytes_in_use" in snap["gauges"],
            f"no device-memory gauges: {sorted(snap['gauges'])}")
    keep("metrics_text", r, err, metrics=len(text.splitlines()),
         device_peak_bytes_in_use=snap["gauges"][
             "device_peak_bytes_in_use"]["value"],
         no_watchdog_compute_seconds=plain["compute_seconds"],
         watchdog_bound_s=watchdog_bound)

    # --profile: the torch.profiler trace of the window names the kernel.
    pdir = WORK / "hard_profile"
    if pdir.exists():
        for f in pdir.iterdir():
            f.unlink()
    r, err = cli("profile", ["--profile", str(pdir)], k1_window,
                 launches(stencil_fused=1))
    (ptrace,) = list(pdir.glob("trace_*.json"))
    pevs = json.loads(ptrace.read_text())["traceEvents"]
    kern = [e for e in pevs if K1_NAME in str(e.get("name"))
            and e.get("ph") == "X"]
    require(len(kern) >= 1, f"--profile trace {ptrace} names no K1 "
            "kernel")
    keep("profile", r, err, kernel_events=len(kern),
         kernel_us=sum(e.get("dur", 0) for e in kern),
         kernel_name=kern[0]["name"])
    obs.reset()
    faults.reset()
    return {"phase": "job_hardened", "ok": True, "shape": list(img.shape),
            "reps": MAIN_REPS, "runs": out}


def verdict_launches(report: str, rows: int, reps: int) -> dict:
    """The launches a ``--time`` line's verdict implies for a single
    device job (backend, schedule and any reported geometry)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    if "backend=pallas" not in report:
        return launches()
    fields = dict(kv.split("=", 1) for kv in report.split() if "=" in kv)
    if fields.get("schedule") == "deep" and "block_h" not in fields:
        return launches(stencil_resident=1)
    fz = int(fields["fuse"]) if "fuse" in fields else cs.rep_loop(
        plan_of("gaussian"), rows, MAIN_W * MAIN_C, MAIN_C, None, None, None,
        None).fuse
    return launches(stencil_fused=len(cs.launch_schedule(reps, fz)))


def phase_autotune_path(dev) -> dict:
    """``--backend autotune`` end to end: cold (measures, writes the
    cache), warm (zero probes, launches the verdict), a 2x2 mesh, then the
    geometry sweep and the quick benchmark sweep."""
    from tpu_stencil_torch import config, driver
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering
    from tpu_stencil_torch.runtime import autotune, bench_sweep
    from tpu_stencil_torch.tools import bh_fuse_ab

    src, img = main_raw()
    g = plan_of("gaussian")
    want = lowering.iterate(torch.from_numpy(img).to(dev), MAIN_REPS,
                            g).cpu().numpy()
    cache = Path(os.environ[autotune.ENV_CACHE])
    cache.unlink(missing_ok=True)
    base = [str(src), str(MAIN_W), str(MAIN_H), str(MAIN_REPS), "rgb",
            "--time", "--backend", "autotune"]
    out = {}

    def check_file(dst, label):
        got = np.fromfile(dst, np.uint8).reshape(img.shape)
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"{label} disagrees with torch ops ({err})")
        return err

    # Cold: a fresh process, an empty cache file.
    dst = WORK / "blur_autotune_cold.raw"
    r = run_cli_cold(base + ["--output", str(dst)], env=dict(os.environ),
                     probed=True)
    report = r["report"]
    probes = int(report.rsplit("tune_probes=", 1)[1].split()[0])
    require(probes > 0, f"cold autotune made no probe: {report}")
    require(cache.exists(), "cold autotune wrote no cache file")
    entry = autotune.cached_entry(g, (MAIN_H, MAIN_W), MAIN_C, dev)
    require(entry is not None, "the cache holds no entry for the job")
    expect = verdict_launches(report, MAIN_H, MAIN_REPS)
    require(r["window"] == expect, f"cold autotune: launches {r['window']}, "
            f"the verdict implies {expect}")
    out["cold"] = {"report": report, "probes": probes,
                   "launches": r["window"], "warmup_launches": r["warmup"],
                   "max_abs_err": check_file(dst, "cold autotune"),
                   "compute_seconds": r["compute_seconds"],
                   "total_seconds": r["total_seconds"], "verdict": entry}
    # Warm: zero probes by the autotuner's counter, the verdict launched.
    dst = WORK / "blur_autotune_warm.raw"
    before = autotune.probe_count
    r = run_cli(base + ["--output", str(dst)])
    report = r["report"]
    require(autotune.probe_count == before and "tune_probes=0" in report,
            f"warm autotune probed: {report}")
    require(r["window"] == expect, f"warm autotune: launches {r['window']}, "
            f"the verdict implies {expect}")
    tuned = [v for v in (entry["backend"], entry["schedule"]) if v]
    require(all(f"={v}" in report for v in tuned),
            f"warm autotune reports {report}, the cache says {entry}")
    out["warm"] = {"report": report, "probes": 0, "launches": r["window"],
                   "warmup_launches": r["warmup"],
                   "max_abs_err": check_file(dst, "warm autotune"),
                   "compute_seconds": r["compute_seconds"],
                   "total_seconds": r["total_seconds"]}
    # A 2x2 mesh of four tiles on this card: tuned against the tile.
    for label in ("mesh2x2_cold", "mesh2x2_warm"):
        dst = WORK / f"blur_autotune_{label}.raw"
        cfg = config.JobConfig(image=str(src), width=MAIN_W, height=MAIN_H,
                               repetitions=MAIN_REPS,
                               image_type=config.ImageType.RGB,
                               mesh_shape=(2, 2), backend="autotune",
                               output=str(dst))
        cs.reset_launch_counts()
        res = driver.run_job(cfg, devices=[dev] * 4)
        require((res.tune_probes > 0) == (label == "mesh2x2_cold"),
                f"{label}: {res.tune_probes} probes")
        fz = res.fuse if res.fuse is not None else cs.DEFAULT_FUSE
        expect4 = launches() if res.backend != "pallas" else launches(
            stencil_valid=len(cs.launch_schedule(MAIN_REPS, fz)) * 4)
        require(res.launches == expect4 and res.mesh_shape == (2, 2),
                f"{label}: launches {res.launches}, the verdict implies "
                f"{expect4}")
        out[label] = {"backend": res.backend, "schedule": res.schedule,
                      "block_h": res.block_h, "fuse": res.fuse,
                      "probes": res.tune_probes, "launches": res.launches,
                      "max_abs_err": check_file(dst, label),
                      "compute_seconds": res.compute_seconds}
    # The geometry sweep and the quick benchmark sweep, to the end.
    buf = io.StringIO()
    rows = bh_fuse_ab.run_sweep(
        bh_fuse_ab.parse_candidates([], g, MAIN_C), dev, reps=400, rounds=3,
        out=buf)
    for line in buf.getvalue().strip().splitlines():
        print(line, flush=True)
    require(all(r["exact"] for r in rows), f"bh_fuse_ab not exact: {rows}")
    out["bh_fuse_ab"] = [{k: r[k] for k in ("block_h", "fuse", "us_per_rep",
                                            "forty_us_per_rep", "exact")}
                         for r in rows]
    sweep = bench_sweep.run_sweep(quick=True, device=dev,
                                  backends=["xla", "pallas", "auto"])
    print(bench_sweep.emit_markdown(sweep), flush=True)
    require(all(r["exact"] for r in sweep),
            f"bench_sweep rows not exact: {[r for r in sweep if not r['exact']]}")
    out["bench_sweep_quick"] = sweep
    return {"phase": "autotune_path", "ok": True, "runs": out}


# The expected K3 launches per tile per chunk of each resolved overlap
# mode (the monolithic chunk, the split's five pieces, the pipeline's
# nine), at tiles with a ghost-free interior.
PIECES = {"off": 1, "split": 5, "fused-split": 5, "edge": 9}
OVERLAP_MODES = ("off", "fused-split", "edge")

# run_job over a 2x2 mesh of one card in a fresh process (the CLI's
# --mesh 2x2 needs four visible cards); prints the JobResult's fields and
# the process's launch counters as its last line.
COLD_JOB = """import json, sys, torch
from tpu_stencil_torch import config, driver
from tpu_stencil_torch.ops import cuda_stencil as cs
a = json.loads(sys.argv[1])
dev = torch.device(a["device"])
cfg = config.JobConfig(image=a["src"], width=a["w"], height=a["h"],
                       repetitions=a["reps"],
                       image_type=config.ImageType(a["type"]),
                       mesh_shape=(2, 2), backend="pallas",
                       overlap=a["overlap"], output=a["dst"])
r = driver.run_job(cfg, devices=[dev] * 4)
print(json.dumps({"compute_seconds": r.compute_seconds,
                  "total_seconds": r.total_seconds, "launches": r.launches,
                  "warmup_launches": r.warmup_launches,
                  "overlap": r.overlap, "counts": cs.launch_counts()}))
"""


def mesh_job(src, w: int, h: int, image_type: str, mode: str, dst, dev,
             cold: bool = False) -> dict:
    """``driver.run_job`` at 2x2 over ``[dev] * 4`` with ``--overlap
    mode``: in a fresh process (``cold``) or here, with the launch
    counters set to 0 just before and read just after."""
    from tpu_stencil_torch import config, driver
    from tpu_stencil_torch.ops import cuda_stencil as cs

    args = {"src": str(src), "w": w, "h": h, "reps": MAIN_REPS,
            "type": image_type, "overlap": mode, "dst": str(dst),
            "device": str(dev)}
    if cold:
        r = subprocess.run([sys.executable, "-c", COLD_JOB, json.dumps(args)],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        require(r.returncode == 0, f"cold run_job {mode} exited "
                f"{r.returncode}: {r.stderr}")
        return json.loads(r.stdout.strip().splitlines()[-1])
    cfg = config.JobConfig(image=str(src), width=w, height=h,
                           repetitions=MAIN_REPS,
                           image_type=config.ImageType(image_type),
                           mesh_shape=(2, 2), backend="pallas",
                           overlap=mode, output=str(dst))
    cs.reset_launch_counts()
    res = driver.run_job(cfg, devices=[dev] * 4)
    return {**result_fields(res), "overlap": res.overlap,
            "counts": cs.launch_counts()}


def overlap_runner(img: np.ndarray, mode: str, dev):
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    c = img.shape[2] if img.ndim == 3 else 1
    return ShardedRunner(IteratedConv2D("gaussian", backend="pallas",
                                        device=dev), img.shape[:2], c,
                         mesh_shape=(2, 2), devices=[dev] * 4, overlap=mode)


@contextlib.contextmanager
def no_copies_around_k3():
    """Count, inside the block, every ``torch.cat``, every
    ``Tensor.contiguous`` and every torch-ops stencil call
    (``lowering.valid_step``/``valid_window``/``padded_step``, K3's plain
    version): an overlap chunk on the card makes none."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    counted = {}
    saved = []

    def patch(owner, name):
        fn = getattr(owner, name)
        saved.append((owner, name, fn))
        counted[name] = 0

        def wrapped(*a, **k):
            counted[name] += 1
            return fn(*a, **k)
        setattr(owner, name, wrapped)

    for owner, name in ((torch, "cat"), (torch.Tensor, "contiguous"),
                        (lowering, "valid_step"), (lowering, "valid_window"),
                        (lowering, "padded_step"),
                        (cs, "stencil_valid_plain")):
        patch(owner, name)
    try:
        yield counted
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def device_events(trace_path: str) -> list:
    """The kernels, copies and memsets of a ``torch.profiler`` Chrome
    trace: (stream, name, start µs, end µs)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(str((e.get("args") or {}).get("stream", e.get("tid"))),
             e.get("name", ""), e["ts"], e["ts"] + e["dur"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset")]


def stream_concurrency(trace_path: str) -> dict:
    """From a ``torch.profiler`` Chrome trace: the device streams that ran
    kernels or copies, each one's busy time and count, the time any and
    the time two or more were busy at once, and the span from the first
    start to the last end (µs); the device's idle share of that span."""
    evs = device_events(trace_path)
    busy, count = {}, {}
    edges = []
    for s, _, a, b in evs:
        busy[s] = busy.get(s, 0.0) + (b - a)
        count[s] = count.get(s, 0) + 1
        edges += [(a, 1), (b, -1)]
    edges.sort()
    depth, last, together, any_busy = 0, None, 0.0, 0.0
    for t, step in edges:
        if last is not None:
            if depth >= 2:
                together += t - last
            if depth >= 1:
                any_busy += t - last
        depth += step
        last = t
    span = (edges[-1][0] - edges[0][0]) if edges else 0.0
    return {"streams": len(busy), "busy_us": busy, "kernels": count,
            "concurrent_us": together, "any_busy_us": any_busy,
            "span_us": span,
            "idle_share": 1.0 - any_busy / span if span else None}


def thin_windows(dev) -> dict:
    """K3 on strided thin windows against its plain version at the 2x2
    tile of the main path, fuse 8 (g = 8): the left band (the tile's rows,
    g*C output lanes) and the top band (g output rows) of a slab-sized
    buffer, grey (an 8-lane border) and RGB, at a 16-byte aligned and an
    unaligned origin, written into a rectangle of a larger output at an
    unaligned origin whose other bytes must stay as they were; global
    origins at the image's corner and inside it. Then the RGB left band's
    time against its bound and its plain version's."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    g = plan_of("gaussian")
    fuse = cs.DEFAULT_FUSE
    d = fuse * g.halo
    th, tw = MAIN_H // 2, MAIN_W // 2
    cases, worst = [], 0
    timed = None
    for c in (1, 3):
        dc = d * c
        glob = (MAIN_H, MAIN_W * c)
        big = seeded((th + 2 * d, tw * c + 2 * dc + 16), 31 + c, dev)
        for band in ("left", "top"):
            for lane0 in (0, 5):
                if band == "left":
                    win = big[:, lane0:lane0 + 3 * dc]
                    rows, lanes = th, dc
                else:
                    win = big[0:3 * d, lane0:lane0 + tw * c + 2 * dc]
                    rows, lanes = d, tw * c
                for row0, col0 in ((0, 0), (th, tw * c)):
                    out_big = torch.full((rows + 4, lanes + 40), 77,
                                         dtype=torch.uint8, device=dev)
                    rect = out_big[2:2 + rows, 3 + lane0:3 + lane0 + lanes]
                    cs.valid_fused(win, g, fuse, c, row0, col0, glob,
                                   out=rect)
                    want = cs.stencil_valid_plain(win, g, c, fuse, row0,
                                                  col0, glob)
                    torch.cuda.synchronize()
                    err = max_err(rect, want)
                    outside = out_big.clone()
                    outside[2:2 + rows, 3 + lane0:3 + lane0 + lanes] = 77
                    kept = bool((outside == 77).all().item())
                    worst = max(worst, err)
                    cases.append({
                        "case": f"C={c} {band} lane0={lane0} origin="
                                f"({row0},{col0}) out={rows}x{lanes}",
                        "pitch": [win.stride(0), rect.stride(0)],
                        "err": err, "outside_kept": kept})
                    if c == 3 and band == "left" and lane0 == 0 and row0:
                        timed = (win, rect, row0, col0, glob)
    bad = [x for x in cases if x["err"] or not x["outside_kept"]]
    require(not bad, f"K3 on a window disagrees with its plain version: {bad}")
    win, rect, row0, col0, glob = timed
    # Event-timed, one launch: what the runner pays per piece, host issue
    # included (the card waits for it); the kernel's own device time from
    # the profiler over 20 launches.
    ms = time_ms(lambda: cs.valid_fused(win, g, fuse, 3, row0, col0, glob,
                                        out=rect), dev)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            cs.valid_fused(win, g, fuse, 3, row0, col0, glob, out=rect)
        torch.cuda.synchronize()
    path = str(WORK / "thin_window_trace.json")
    prof.export_chrome_trace(path)
    durs = [b - a for _, name, a, b in device_events(path)
            if "stencil_valid_kernel" in name]
    # The profiler may miss a launch at the edge of its window.
    require(len(durs) >= 10, f"profiled {len(durs)} of 20 K3 window "
            f"launches")
    plain = time_ms(lambda: cs.stencil_valid_plain(win, g, 3, fuse, row0,
                                                   col0, glob), dev)
    bound, by = bound_ms_per_rep(g, rect.numel(), fuse,
                                 n_bytes=win.numel() + rect.numel())
    return {"cases": cases, "max_abs_err": worst,
            "left_band_rgb": {
                "window": list(win.shape), "out": list(rect.shape),
                "ms": ms, "device_ms": statistics.median(durs) / 1e3,
                "device_launches_profiled": len(durs),
                "plain_ms": plain, "bound_ms": bound * fuse,
                "bound_by": by,
                "unit": "ms per launch, fuse 8, 1260x24 lanes out"}}


def phase_overlap_path(dev) -> dict:
    """The overlap schedules on 2x2 over ``[cuda:0] * 4`` at the main
    path's size (1920x2520 RGB gaussian x40, tile 1260x960, g = 8 at
    fuse 8), each run byte-equal to ``off``, to K1 and to torch ops."""
    from tpu_stencil_torch import obs
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering
    from tpu_stencil_torch.runtime import autotune

    src, img = main_raw()
    g = plan_of("gaussian")
    img_dev = torch.from_numpy(img).to(dev)
    want = lowering.iterate(img_dev, MAIN_REPS, g).cpu().numpy()
    k1 = cs.iterate(img_dev, MAIN_REPS, g).cpu().numpy()
    require(np.array_equal(k1, want), "K1 disagrees with torch ops")
    out = {}
    saved_cache = os.environ[autotune.ENV_CACHE]
    cache = WORK / "overlap_autotune.json"
    cache.unlink(missing_ok=True)
    os.environ[autotune.ENV_CACHE] = str(cache)
    try:
        chunks = len(cs.launch_schedule(MAIN_REPS, cs.DEFAULT_FUSE))
        # 1. The auto verdict: one probe bundle on a cold cache, none warm.
        before = autotune.overlap_probe_count
        r_auto = overlap_runner(img, "auto", dev)
        probes_cold = autotune.overlap_probe_count - before
        r_again = overlap_runner(img, "auto", dev)
        probes_warm = autotune.overlap_probe_count - before - probes_cold
        require(probes_cold == 1 and probes_warm == 0
                and r_again.overlap == r_auto.overlap,
                f"auto: {probes_cold} probes cold, {probes_warm} warm, "
                f"{r_auto.overlap} then {r_again.overlap}")
        entry = json.loads(cache.read_text())["entries"]
        out["auto"] = {"verdict": r_auto.overlap, "probes_cold": probes_cold,
                       "probes_warm": probes_warm,
                       "cache_entry": list(entry.values())[0]}
        # 2. Each mode through run_job (warm, in this process), and auto
        # on the warm cache, against torch ops and K1; its window's K3
        # launches those of its pieces; its warm-up one chunk of each.
        for mode in OVERLAP_MODES + ("auto",):
            dst = WORK / f"blur_overlap_{mode}.raw"
            r = mesh_job(src, MAIN_W, MAIN_H, "rgb", mode, dst, dev)
            ran = r_auto.overlap if mode == "auto" else mode
            expect = launches(stencil_valid=PIECES[ran] * 4 * chunks)
            warm = launches(stencil_valid=PIECES[ran] * 4)
            require(r["overlap"] == ran and r["launches"] == expect
                    and r["warmup_launches"] == warm
                    and r["counts"] == add_counts(expect, warm),
                    f"overlap {mode}: ran {r['overlap']}, launches "
                    f"{r['launches']} + warm-up {r['warmup_launches']} "
                    f"(counted {r['counts']}), expected {expect} + {warm}")
            got = np.fromfile(dst, np.uint8).reshape(img.shape)
            err = int(np.abs(got.astype(int) - want.astype(int)).max())
            require(err == 0, f"overlap {mode} disagrees with torch ops / "
                    f"K1 / off ({err})")
            out[f"job_{mode}"] = {**r, "max_abs_err": err,
                                  "k3_per_chunk": PIECES[ran] * 4}
        # 3. Cold (a fresh process) near warm under the two split modes.
        for mode in ("fused-split", "edge"):
            dst = WORK / f"blur_overlap_{mode}_cold.raw"
            r = mesh_job(src, MAIN_W, MAIN_H, "rgb", mode, dst, dev,
                         cold=True)
            got = np.fromfile(dst, np.uint8).reshape(img.shape)
            require(np.array_equal(got, want) and r["overlap"] == mode
                    and r["launches"] == out[f"job_{mode}"]["launches"],
                    f"cold {mode}: {r}")
            out[f"job_{mode}_cold"] = r
            out[f"{mode}_cold_bound_s"] = require_cold_near_warm(
                f"overlap {mode}", r["compute_seconds"],
                out[f"job_{mode}"]["compute_seconds"])
        # 4. A grey image: 8-lane border pieces at fuse 8.
        gsrc = WORK / "waterfall_grey.raw"
        grey = np.ascontiguousarray(img[..., 0])
        grey.tofile(gsrc)
        gwant = lowering.iterate(torch.from_numpy(grey).to(dev), MAIN_REPS,
                                 g).cpu().numpy()
        for mode in ("fused-split", "edge"):
            dst = WORK / f"blur_overlap_grey_{mode}.raw"
            r = mesh_job(gsrc, MAIN_W, MAIN_H, "grey", mode, dst, dev)
            got = np.fromfile(dst, np.uint8).reshape(grey.shape)
            require(np.array_equal(got, gwant) and r["launches"] == launches(
                stencil_valid=PIECES[mode] * 4 * chunks),
                f"grey {mode}: {r['launches']}, equal "
                f"{np.array_equal(got, gwant)}")
            out[f"grey_{mode}"] = {"launches": r["launches"],
                                   "max_abs_err": 0}
        # 5. No torch-ops call, no band copy, no stitch around K3.
        runners = {m: overlap_runner(img, m, dev) for m in OVERLAP_MODES}
        tiles = runners["off"].put(img)
        for mode in ("fused-split", "edge"):
            r = runners[mode]
            r.prepare()
            r.warmup(tiles, r.warm_reps([MAIN_REPS]))
            torch.cuda.synchronize()
            with no_copies_around_k3() as counted:
                cs.reset_launch_counts()
                res = r.run(tiles, MAIN_REPS)
                torch.cuda.synchronize()
                counts = cs.launch_counts()
            require(not any(counted.values()) and counts == launches(
                stencil_valid=PIECES[mode] * 4 * chunks),
                f"{mode}: around K3 {counted}, launches {counts}")
            require(np.array_equal(r.fetch(res), want), f"{mode} runner")
            out[f"no_copies_{mode}"] = {"counted": counted,
                                        "launches": counts}
        # 6. ms per rep of each mode's runner and of auto's, taking turns:
        # auto must not take a measured loss (1.5x off at most, as the
        # times phase holds the backend verdict).
        timed = {**runners, "auto": r_again}
        per = interleaved_ms({m: (lambda r=r: r.run(tiles, MAIN_REPS))
                              for m, r in timed.items()}, dev)
        out["ms_per_rep"] = {m: t / MAIN_REPS for m, t in per.items()}
        require(per["auto"] <= 1.5 * per["off"],
                f"auto ({r_auto.overlap}) takes {per['auto']} ms, off "
                f"{per['off']} ms")
        # 7. The probes of each mode (median of 5 traced runs).
        probes = {}
        for mode, r in runners.items():
            obs.reset()
            obs.enable()
            try:
                for _ in range(5):
                    r.trace_phase_probes(tiles)
                spans = obs.get_tracer().spans()
            finally:
                obs.reset()
            names = sorted({s.name for s in spans} - {"sharded.probe_compile"})
            probes[mode] = {n: statistics.median(
                1e3 * s.seconds for s in spans if s.name == n) for n in names}
        out["probes_ms"] = probes
        # 8. Whether the side stream overlaps: the profiler's streams.
        from torch.profiler import ProfilerActivity, profile

        streams = {}
        for mode in ("fused-split", "edge"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runners[mode].run(tiles, MAIN_REPS)
                torch.cuda.synchronize()
            path = str(WORK / f"overlap_{mode}_trace.json")
            prof.export_chrome_trace(path)
            streams[mode] = stream_concurrency(path)
        out["streams"] = streams
        out["thin_windows"] = thin_windows(dev)
    finally:
        os.environ[autotune.ENV_CACHE] = saved_cache
    return {"phase": "overlap_path", "ok": True, "shape": list(img.shape),
            "reps": MAIN_REPS, "mesh": [2, 2], "runs": out}


# One rank of a job of several processes on this card, started by
# mp_workers with the environment torch.distributed.run sets (RANK,
# WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK); prints one JSON line.
# "jobs": driver.run_job over [dev] * 2 per rank (2x2 in all) for each
# job, then the runner alone (its exchange probe, the bytes one chunk
# stages, ms per rep), then cli.main with this rank's argv; "stall": rank
# 1 sleeps before its first send of the window, and rank 0 reports the
# CollectiveTimeout it raised.
MP_WORKER = """import contextlib, io, json, os, statistics, sys, time
import torch
from tpu_stencil_torch import config, driver
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.parallel import distributed, sharded
from tpu_stencil_torch.resilience.errors import CollectiveTimeout
a = json.loads(sys.argv[1])
rank = int(os.environ["RANK"])
dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                   % torch.cuda.device_count())
distributed.initialize(timeout_s=a.get("timeout", 0.0))
out = {"rank": rank, "device": str(dev)}

def job(j):
    cfg = config.JobConfig(image=j["src"], width=a["w"], height=a["h"],
                           repetitions=a["reps"],
                           image_type=config.ImageType(j.get("type", "rgb")),
                           mesh_shape=(2, 2), backend="pallas",
                           overlap=j.get("overlap", "off"), output=j["dst"],
                           dispatch_timeout_s=a.get("timeout", 0.0))
    cs.reset_launch_counts()
    return driver.run_job(cfg, devices=[dev] * 2)

def timed(fn, n):
    ts = []
    for _ in range(n):
        distributed.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3

if a["mode"] == "stall":
    if rank == 1:
        warm, run, armed = (sharded.ShardedRunner.warmup,
                            sharded.ShardedRunner.run, [])
        def warmup(self, *x):
            r = warm(self, *x)
            armed.append(1)
            return r
        def stalled(self, *x):
            if armed:
                time.sleep(a["stall"])
            return run(self, *x)
        sharded.ShardedRunner.warmup = warmup
        sharded.ShardedRunner.run = stalled
    t0 = time.perf_counter()
    try:
        job(a["jobs"][0])
        out["timeout"] = None
    except CollectiveTimeout as e:
        out.update(timeout=type(e).__name__, label=e.label,
                   seconds=e.seconds, edges=e.edges)
    out["elapsed_s"] = time.perf_counter() - t0
else:
    for j in a["jobs"]:
        r = job(j)
        out[j["name"]] = {"compute_seconds": r.compute_seconds,
                          "total_seconds": r.total_seconds,
                          "launches": r.launches,
                          "warmup_launches": r.warmup_launches,
                          "overlap": r.overlap, "counts": cs.launch_counts()}
    runner = sharded.ShardedRunner(
        IteratedConv2D("gaussian", backend="pallas", device=dev),
        (a["h"], a["w"]), 3, mesh_shape=(2, 2), devices=[dev] * 2,
        timeout_s=60.0)
    tiles = distributed.read_sharded(a["jobs"][0]["src"], a["h"], a["w"],
                                     3, runner.mesh)
    runner.prepare()
    exchange, compute = runner._phase_probes()
    pair = exchange(tiles)
    before = runner.peers.bytes_staged
    exchange(tiles)
    out["staged_bytes_per_chunk"] = runner.peers.bytes_staged - before
    out["exchange_ms_per_chunk"] = timed(lambda: exchange(tiles), 21)
    out["k3_ms_per_chunk"] = timed(lambda: compute(pair), 21)
    runner.run(tiles, a["reps"])
    out["runner_ms_per_rep"] = timed(lambda: runner.run(tiles, a["reps"]),
                                     7) / a["reps"]
    out["fuse"] = runner.fuse
    out["tiles_here"] = len(runner.devices)
    from tpu_stencil_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli_rc"] = cli.main(a["argv"][rank])
    out["cli_lines"] = buf.getvalue().splitlines()
print(json.dumps(out), flush=True)
os._exit(0)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mp_workers(args: dict, n: int = 2, timeout: float = 300,
               first_only: bool = False) -> list:
    """``n`` ranks of :data:`MP_WORKER` on this card (each its own
    process, the environment torch.distributed.run would give it), each
    within ``timeout`` s; returns each rank's JSON line. A rank that fails
    or times out fails the smoke. ``first_only``: wait for rank 0, then
    kill the others (a stalled rank)."""
    port = str(free_port())
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MP_WORKER, json.dumps(args)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    res = []
    try:
        for r, p in enumerate(procs[:1] if first_only else procs):
            try:
                so, se = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"{args['mode']} rank {r} ran past {timeout} s")
            require(p.returncode == 0, f"{args['mode']} rank {r} exited "
                    f"{p.returncode}: {se[-3000:]}")
            res.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


def torchrun(args, timeout: float = 300, expect_ok: bool = True) -> dict:
    """``python -m torch.distributed.run --standalone --nproc-per-node 2
    -m tpu_stencil_torch ARGS`` as a user runs it: returns its exit code
    and each rank's lines (``--tee 3`` prefixes them ``[defaultR]:``)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "--log-dir", str(WORK / "torchrun"),
           "--tee", "3", "-m", "tpu_stencil_torch", *map(str, args)]
    try:
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"torchrun {args} ran past {timeout} s")
    ranks = {0: [], 1: []}
    for line in r.stdout.splitlines():
        for k in ranks:
            tag = f"[default{k}]:"
            if line.startswith(tag):
                ranks[k].append(line[len(tag):])
    require((r.returncode == 0) == expect_ok,
            f"torchrun {args} exited {r.returncode}: {r.stderr[-3000:]}")
    return {"rc": r.returncode, "ranks": ranks}


def rank_report(lines) -> dict:
    """A rank's ``Execution time`` and ``--time`` lines."""
    time_line = next(ln for ln in lines if ln.startswith("Execution time:"))
    report = next((ln for ln in lines if ln.startswith("total (incl.")), "")
    return {"window_s": float(time_line.split()[2]),
            "total_s": (float(report.split()[3]) if report else None),
            "launches": parse_launches(report) if report else None,
            "report": report}


def one_process_runner(src, dev) -> dict:
    """The 2x2 runner over ``[dev] * 4`` in this process, timed as each
    rank of :data:`MP_WORKER` times its own: one chunk's exchange probe
    and the 40-rep loop, host clock to a synchronize, median of 21 / 7."""
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.parallel import distributed
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    runner = ShardedRunner(IteratedConv2D("gaussian", backend="pallas",
                                          device=dev),
                           (MAIN_H, MAIN_W), MAIN_C, mesh_shape=(2, 2),
                           devices=[dev] * 4)
    tiles = distributed.read_sharded(str(src), MAIN_H, MAIN_W, MAIN_C,
                                     runner.mesh)
    exchange, compute = runner._phase_probes()
    pair = exchange(tiles)

    def timed(fn, n):
        fn()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3

    return {"exchange_ms_per_chunk": timed(lambda: exchange(tiles), 21),
            "k3_ms_per_chunk": timed(lambda: compute(pair), 21),
            "runner_ms_per_rep": timed(lambda: runner.run(tiles, MAIN_REPS),
                                       7) / MAIN_REPS}


def phase_multiprocess(dev) -> dict:
    """Two processes on this card (gloo, strips staged through pinned host
    buffers), at 1920x2520 RGB gaussian x40 (a)-(f) as the module
    docstring lists them; every output byte-equal to K1 and to the same
    job in one process."""
    from tpu_stencil_torch import config, driver
    from tpu_stencil_torch.ops import cuda_stencil as cs

    src, img = main_raw()
    g = plan_of("gaussian")
    k1 = cs.iterate(torch.from_numpy(img).to(dev), MAIN_REPS, g).cpu().numpy()
    fuse = cs.DEFAULT_FUSE
    chunks = len(cs.launch_schedule(MAIN_REPS, fuse))
    out = {}

    def same(path, want=k1, what=""):
        got = np.fromfile(path, np.uint8).reshape(want.shape)
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"multiprocess {what}: {err} off K1")
        return err

    def one_process(mesh, dst, image=src, image_type="rgb"):
        cfg = config.JobConfig(image=str(image), width=MAIN_W, height=MAIN_H,
                               repetitions=MAIN_REPS,
                               image_type=config.ImageType(image_type),
                               mesh_shape=mesh, backend="pallas",
                               output=str(dst))
        r = driver.run_job(cfg, devices=[dev] * (mesh[0] * mesh[1]))
        return r.compute_seconds

    base = [src, MAIN_W, MAIN_H, MAIN_REPS, "rgb", *PALLAS]
    # (a) The CLI with two ranks, one tile each, --mesh 2x1 and 1x2.
    for mesh in ("2x1", "1x2"):
        dst = WORK / f"blur_mp_{mesh}.raw"
        one = WORK / f"blur_mp_{mesh}_one.raw"
        shape = tuple(int(v) for v in mesh.split("x"))
        t_one = one_process(shape, one)
        r = torchrun(base + ["--mesh", mesh, "--time", "--output", dst])
        reps = {k: rank_report(v) for k, v in r["ranks"].items()}
        for k, rep in reps.items():
            require(rep["launches"] == launches(stencil_valid=chunks),
                    f"--mesh {mesh} rank {k}: launches {rep['launches']}")
        same(dst, what=f"--mesh {mesh}")
        require(np.array_equal(np.fromfile(dst, np.uint8),
                               np.fromfile(one, np.uint8)),
                f"--mesh {mesh}: two processes != one process")
        out[f"cli_{mesh}"] = {"ranks": reps, "one_process_window_s": t_one,
                              "max_abs_err": 0}
    # (b) 2 ranks x 2 tiles (2x2) through run_job under each overlap
    # mode, off twice (cold, then warm) and grey; then the runner alone.
    gsrc = WORK / "waterfall_grey.raw"
    grey = np.ascontiguousarray(img[..., 0])
    grey.tofile(gsrc)
    gk1 = cs.iterate(torch.from_numpy(grey).to(dev), MAIN_REPS,
                     g).cpu().numpy()
    jobs = [{"name": "off_cold", "overlap": "off"},
            {"name": "off", "overlap": "off"},
            {"name": "fused-split", "overlap": "fused-split"},
            {"name": "edge", "overlap": "edge"},
            {"name": "auto", "overlap": "auto"},
            {"name": "grey_off", "overlap": "off", "type": "grey"}]
    for j in jobs:
        j["src"] = str(gsrc if j.get("type") == "grey" else src)
        j["dst"] = str(WORK / f"blur_mp_{j['name']}.raw")
    # (c) rides on the same ranks: divergent argv (rank 1 asks for other
    # reps and another output) runs rank 0's job.
    div = WORK / "blur_mp_divergent.raw"
    wrong = WORK / "blur_mp_divergent_wrong.raw"
    wrong.unlink(missing_ok=True)
    cli_base = [str(src), str(MAIN_W), str(MAIN_H)]
    argv = [cli_base + [str(MAIN_REPS), "rgb", *PALLAS, "--mesh", "2x1",
                        "--output", str(div)],
            cli_base + ["7", "rgb", *PALLAS, "--mesh", "2x1", "--output",
                        str(wrong)]]
    cache = WORK / "mp_autotune.json"
    cache.unlink(missing_ok=True)
    saved = os.environ.get("TPU_STENCIL_TORCH_AUTOTUNE_CACHE")
    os.environ["TPU_STENCIL_TORCH_AUTOTUNE_CACHE"] = str(cache)
    try:
        ranks = mp_workers({"mode": "jobs", "w": MAIN_W, "h": MAIN_H,
                            "reps": MAIN_REPS, "jobs": jobs, "argv": argv})
    finally:
        if saved is not None:
            os.environ["TPU_STENCIL_TORCH_AUTOTUNE_CACHE"] = saved
    for j in jobs:
        same(j["dst"], gk1 if j.get("type") == "grey" else k1, j["name"])
        ran = [r[j["name"]]["overlap"] for r in ranks]
        require(len(set(ran)) == 1, f"{j['name']}: ranks ran {ran}")
        want = launches(stencil_valid=PIECES[ran[0]] * 2 * chunks)
        for r in ranks:
            require(r[j["name"]]["launches"] == want,
                    f"{j['name']} rank {r['rank']}: launches "
                    f"{r[j['name']]['launches']}, expected {want}")
    for r in ranks:
        r["off_cold_bound_s"] = require_cold_near_warm(
            f"multiprocess off rank {r['rank']}",
            r["off_cold"]["compute_seconds"], r["off"]["compute_seconds"])
    out["jobs"] = ranks
    require([x["cli_rc"] for x in ranks] == [0, 0] and not wrong.exists(),
            f"divergent argv: {[x['cli_rc'] for x in ranks]}, "
            f"{wrong.exists()}")
    same(div, what="divergent argv")
    out["divergent_argv"] = {"rcs": [0, 0], "rank1_output_written": False}
    # The same 2x2 in one process, timed as the ranks time theirs.
    one = WORK / "blur_mp_one_2x2.raw"
    out["one_process_2x2_window_s"] = one_process((2, 2), one)
    out["one_process_2x2"] = one_process_runner(src, dev)
    # (d) --checkpoint-every 10, killed at rep 25 on both ranks, resumed.
    dst = WORK / "blur_mp_ckpt.raw"
    ck = base + ["--mesh", "2x1", "--checkpoint-every", "10", "--output",
                 dst]
    killed = torchrun(ck + ["--faults", "compute:rep=25"], expect_ok=False)
    meta = json.loads(Path(f"{dst}.ckpt.json").read_text())
    require(meta["rep"] == 20, f"checkpoint at rep {meta['rep']}, not 20")
    resumed = torchrun(ck + ["--resume", "--time"])
    same(dst, what="checkpoint resume")
    left = [p.name for p in WORK.iterdir() if p.name.startswith(
        "blur_mp_ckpt.raw.ckpt")]
    require(not left, f"checkpoint artifacts left: {left}")
    out["checkpoint"] = {"killed_rc": killed["rc"], "resumed_from": 20,
                         "ranks": {k: rank_report(v) for k, v in
                                   resumed["ranks"].items()}}
    # (e) --trace: one merged file, both ranks' pids and iterate.rep spans.
    trace = WORK / "mp_trace.json"
    trace.unlink(missing_ok=True)
    dst = WORK / "blur_mp_trace.raw"
    torchrun(base + ["--mesh", "2x1", "--trace", trace, "--output", dst])
    same(dst, what="--trace")
    ev = json.loads(trace.read_text())["traceEvents"]
    per_pid = {p: sum(1 for e in ev if e.get("ph") == "X" and e["pid"] == p
                      and e["name"] == "iterate.rep") for p in (0, 1)}
    require(per_pid == {0: MAIN_REPS, 1: MAIN_REPS}
            and {e["pid"] for e in ev} == {0, 1},
            f"merged trace: iterate.rep spans per pid {per_pid}")
    out["trace"] = {"iterate_rep_spans_per_pid": per_pid,
                    "events": len(ev)}
    # (f) A rank stalled before its first send: the other raises
    # CollectiveTimeout within --dispatch-timeout 5.
    r = mp_workers({"mode": "stall", "w": MAIN_W, "h": MAIN_H,
                    "reps": MAIN_REPS, "timeout": 5.0, "stall": 120,
                    "jobs": [{"src": str(src),
                              "dst": str(WORK / "blur_mp_stall.raw")}]},
                   first_only=True, timeout=120)[0]
    require(r["timeout"] == "CollectiveTimeout" and r["seconds"] == 5.0
            and r["elapsed_s"] < 60, f"stalled peer: {r}")
    out["stall"] = r
    return {"phase": "multiprocess", "ok": True, "shape": list(img.shape),
            "reps": MAIN_REPS, "transport": "gloo, pinned host staging",
            "runs": out}


def phase_witness(dev) -> dict:
    """The witness re-executes the 40-rep job through torch ops on the card
    (one ``padded_step`` per rep, no hand kernel) and must equal K1's, K2's
    and the 2x2 K3 runner's outputs; one flipped byte of K1's output is
    caught; at a probe size the NumPy golden agrees with K1 and catches a
    flip too."""
    from tpu_stencil_torch.integrity import witness
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    _, img = main_raw()
    g = plan_of("gaussian")
    img_dev = torch.from_numpy(img).to(dev)
    outs = {"stencil_fused": cs.iterate(img_dev, MAIN_REPS, g),
            "stencil_resident": cs.iterate(img_dev, MAIN_REPS, g,
                                           schedule="deep")}
    r = overlap_runner(img, "off", dev)
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    outs["stencil_valid_2x2"] = r.fetch(r.run(r.put(img), MAIN_REPS))
    seen = []
    real = lowering.padded_step

    def spy(x, *a, **k):
        seen.append(x.device.type)
        return real(x, *a, **k)

    lowering.padded_step = spy
    cs.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        wit = witness.device_witness(img, "gaussian", MAIN_REPS, device=dev)
        secs = time.perf_counter() - t0
    finally:
        lowering.padded_step = real
    counts = cs.launch_counts()
    require(counts == NO_LAUNCHES, f"the witness launched {counts}")
    require(len(seen) == MAIN_REPS and set(seen) == {"cuda"},
            f"the witness ran {len(seen)} steps on {set(seen)}")
    equal = {k: bool(np.array_equal(wit, v)) for k, v in outs.items()}
    require(all(equal.values()), f"witness disagrees: {equal}")
    flipped = outs["stencil_fused"].copy()
    flipped[MAIN_H // 2, MAIN_W // 3, 1] ^= 0x01
    caught = not np.array_equal(wit, flipped)
    require(caught, "a flipped byte of K1's output went unnoticed")
    small = img[:24, :32].copy()
    k1_small = cs.iterate(torch.from_numpy(small).to(dev), 5,
                          g).cpu().numpy()
    golden_ok = witness.golden_witness(small, "gaussian", 5, k1_small)
    k1_small[3, 4, 2] ^= 0x80
    golden_caught = not witness.golden_witness(small, "gaussian", 5,
                                               k1_small)
    require(golden_ok and golden_caught,
            f"golden: agrees {golden_ok}, caught a flip {golden_caught}")
    a = witness.WitnessSampler(witness.DEFAULT_RATE, seed=7)
    b = witness.WitnessSampler(witness.DEFAULT_RATE, seed=7)
    require([a.pick() for _ in range(4096)] == [b.pick() for _ in
                                                range(4096)],
            "two samplers with one seed picked differently")
    return {"phase": "witness", "ok": True, "reps": MAIN_REPS,
            "equal": equal, "flip_caught": caught,
            "golden_agrees": golden_ok, "golden_flip_caught": golden_caught,
            "witness_launches": counts, "witness_devices": sorted(set(seen)),
            "witness_seconds": secs}


STREAM_FRAMES, STREAM_TIMED_FRAMES = 16, 32
STREAM_DEPTHS = (1, 2, 4)
STREAM_ROUNDS = 3


def stream_clip() -> Path:
    """A seeded clip of 32 frames of 1920x2520 RGB (464 MB) and of 16 grey
    frames, raw, under ``WORK/stream``; removed at the end of the phase."""
    d = WORK / "stream"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(9)
    rng.integers(0, 256, (STREAM_TIMED_FRAMES, MAIN_H, MAIN_W, MAIN_C),
                 np.uint8).tofile(d / "clip_rgb.raw")
    rng.integers(0, 256, (STREAM_FRAMES, MAIN_H, MAIN_W),
                 np.uint8).tofile(d / "clip_grey.raw")
    return d


def run_stream_cli(args, expect_rc: int = 0) -> dict:
    """``python -m tpu_stencil_torch stream ...`` as ``cli.main`` in this
    process, with the launch counters set to 0 just before it and read
    just after; its StreamResult, stdout and stderr kept."""
    from tpu_stencil_torch import cli
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.stream import engine

    out, err = io.StringIO(), io.StringIO()
    real = engine.run_stream
    box = {}

    def keep(*a, **k):
        box["res"] = real(*a, **k)
        return box["res"]

    engine.run_stream = keep
    cs.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["stream", *map(str, args)])
    finally:
        engine.run_stream = real
    counts = cs.launch_counts()
    print(out.getvalue().strip(), flush=True)
    require(rc == expect_rc, f"stream {args} returned {rc} (expected "
            f"{expect_rc}): {err.getvalue()[-2000:]}")
    return {"rc": rc, "counts": counts, "res": box.get("res"),
            "stdout": out.getvalue(), "stderr": err.getvalue()}


def counted(fn):
    """``fn()`` with the launch counters set to 0 just before and read just
    after: (its value, the counts)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    cs.reset_launch_counts()
    value = fn()
    return value, cs.launch_counts()


def copy_kernel_overlap(trace_path: str, kernel: str) -> dict:
    """From a ``torch.profiler`` Chrome trace: the time during which a
    host-to-device copy and a ``kernel`` launch were busy at once (µs),
    their counts, and the streams each ran on."""
    evs = device_events(trace_path)
    copies = [(s, a, b) for s, n, a, b in evs if "HtoD" in n]
    kerns = [(s, a, b) for s, n, a, b in evs if kernel in n]
    both = sum(max(0.0, min(b1, b2) - max(a1, a2))
               for _, a1, b1 in copies for _, a2, b2 in kerns)
    return {"h2d_copies": len(copies), "kernels": len(kerns),
            "copy_streams": sorted({s for s, _, _ in copies}),
            "kernel_streams": sorted({s for s, _, _ in kerns}),
            "copy_and_kernel_us": both}


class ClockSink:
    """A null sink that keeps the time of each write: the steady-state
    rate of a stream is (n - 1) frames over the first to the last write,
    without the engine's bootstrap."""

    retryable_writes = True

    def __init__(self) -> None:
        self.times = []

    def write(self, index, frame) -> None:
        self.times.append(time.perf_counter())

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def steady_fps(self) -> float:
        t = self.times
        return (len(t) - 1) / (t[-1] - t[0]) if len(t) > 1 else 0.0


def phase_stream_path(dev) -> dict:
    """The streaming engine at 1920x2520 x40 gaussian, on a seeded clip.

    Bytes: 16 frames, file to file, depth 2, RGB and grey: the stream
    through the CLI (``--backend pallas``: K1, 5 launches a frame plus the
    warm-up's one; ``--schedule deep``: K2, one a frame plus one), the fan
    ``--mesh-frames 2`` over ``[cuda:0] * 2`` (``run_stream``; K1 and, under
    ``--dispatch-timeout 60``, K2's two cooperative grids on one card),
    ``run_job --frames 16`` on one device (K1's tall layout) and over
    ``[cuda:0] * 2`` (the batch axis), every output equal to the torch-ops
    path (``run_job --frames 16 --backend xla``). Resume:
    ``--checkpoint-every 4`` with a ``compute`` fault at frame 9 restarts
    the engine once and finishes byte-equal. Torn buffer:
    ``integrity.corrupt_ingest`` at frame 3 fails the CLI with rc 1 naming
    ``ChecksumMismatch``. Throughput: 32 frames to a null sink at depths
    1, 2 and 4, taking turns, median of 3 (wall and steady-state
    frames/s, the stage histograms per frame), the CRC32C of one frame,
    the modelled bound, and a ``torch.profiler`` trace of an 8-frame
    depth-2 run: H2D copies and K1 busy at once, the device's idle share."""
    from tpu_stencil_torch import config, driver, obs
    from tpu_stencil_torch.integrity import checksum
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.runtime import roofline
    from tpu_stencil_torch.stream import engine

    d = stream_clip()
    n = STREAM_FRAMES
    fuse = main_fuse(plan_of("gaussian"), dev)
    per_frame = len(cs.launch_schedule(MAIN_REPS, fuse))
    warm = len(set(cs.launch_schedule(MAIN_REPS, fuse)))
    runs, errs = {}, {}

    def frames_file(path, itype):
        shape = (n, MAIN_H, MAIN_W) + ((MAIN_C,) if itype == "rgb" else ())
        got = np.fromfile(path, np.uint8)
        require(got.size == int(np.prod(shape)),
                f"{path}: {got.size} bytes, expected {int(np.prod(shape))}")
        os.unlink(path)
        return got.reshape(shape)

    def job(src, itype, backend, devices, dst):
        cfg = config.JobConfig(str(src), MAIN_W, MAIN_H, MAIN_REPS,
                               config.ImageType(itype), frames=n,
                               backend=backend, output=str(dst))
        return driver.run_job(cfg, devices=devices)

    for itype in ("rgb", "grey"):
        src = d / f"clip_{itype}.raw"
        res, _ = counted(lambda: job(src, itype, "xla", [dev],
                                     d / "want.raw"))
        want = frames_file(d / "want.raw", itype)
        cases = {}
        res, counts = counted(lambda: job(src, itype, "pallas", [dev],
                                          d / "o.raw"))
        cases["job_frames"] = (frames_file(d / "o.raw", itype), counts,
                               add_counts(res.launches,
                                          res.warmup_launches),
                               launches(stencil_fused=per_frame + warm))
        res, counts = counted(lambda: job(src, itype, "pallas", [dev, dev],
                                          d / "o.raw"))
        cases["job_frames_batch2"] = (
            frames_file(d / "o.raw", itype), counts,
            add_counts(res.launches, res.warmup_launches),
            launches(stencil_fused=2 * (per_frame + warm)))
        base = [src, MAIN_W, MAIN_H, MAIN_REPS, itype, "--frames", n,
                "--output", d / "o.raw", *PALLAS]
        r = run_stream_cli(base)
        cases["stream"] = (frames_file(d / "o.raw", itype), r["counts"],
                           r["counts"],
                           launches(stencil_fused=n * per_frame + warm))
        runs[f"stream_{itype}"] = {
            "launches": r["counts"], "frames_per_second":
            r["res"].frames_per_second, "stage_seconds":
            r["res"].stage_seconds, "report": r["stdout"].splitlines()[0]}
        r = run_stream_cli(base + ["--schedule", "deep"])
        cases["stream_deep"] = (frames_file(d / "o.raw", itype),
                                r["counts"], r["counts"],
                                launches(stencil_resident=n + 1))
        require(r["res"].schedule == "deep", "--schedule deep ran "
                f"{r['res'].schedule}")
        runs[f"stream_deep_{itype}"] = {"launches": r["counts"]}
        for sched, expect in ((None, launches(stencil_fused=n * per_frame)),
                              ("deep", launches(stencil_resident=n))):
            cfg = config.StreamConfig(
                str(src), MAIN_W, MAIN_H, MAIN_REPS, config.ImageType(itype),
                backend="pallas", schedule=sched, frames=n,
                output=str(d / "o.raw"), mesh_frames=2,
                dispatch_timeout_s=60.0)
            t0 = time.perf_counter()
            res, counts = counted(lambda: engine.run_stream(
                cfg, devices=[dev, dev]))
            label = f"mesh2{'_deep' if sched else ''}"
            cases[label] = (frames_file(d / "o.raw", itype), counts, counts,
                            expect)
            require(res.per_device_frames == [n // 2, n // 2],
                    f"{label}: per-device frames {res.per_device_frames}")
            runs[f"{label}_{itype}"] = {
                "launches": counts, "seconds": time.perf_counter() - t0,
                "per_device_frames": res.per_device_frames}
        for label, (got, counts, seen, expect) in cases.items():
            err = int(np.abs(got.astype(np.int16)
                             - want.astype(np.int16)).max())
            errs[f"{label}_{itype}"] = err
            require(err == 0, f"stream_path {label} {itype} disagrees with "
                    f"torch ops ({err})")
            require(seen == expect and counts == expect,
                    f"stream_path {label} {itype}: launches {counts} "
                    f"(result {seen}), expected {expect}")
        del want, cases

    # Resume: killed by a compute fault at frame 9, restarted from the
    # frame-8 checkpoint.
    src = d / "clip_rgb.raw"
    r = run_stream_cli([src, MAIN_W, MAIN_H, MAIN_REPS, "rgb", "--frames",
                        n, "--output", d / "o.raw", *PALLAS,
                        "--checkpoint-every", 4, "--faults",
                        "compute:frame=9"])
    require(r["res"].restarts == 1 and "engine restarted 1x" in r["stdout"],
            f"resume: {r['res'].restarts} restarts: {r['stdout']}")
    resumed = frames_file(d / "o.raw", "rgb")
    res, _ = counted(lambda: job(src, "rgb", "pallas", [dev], d / "o.raw"))
    want = frames_file(d / "o.raw", "rgb")
    errs["resume"] = int(np.abs(resumed.astype(np.int16)
                                - want.astype(np.int16)).max())
    require(errs["resume"] == 0, "the resumed stream disagrees with run_job")
    runs["resume"] = {"restarts": r["res"].restarts,
                      "skipped": r["res"].skipped,
                      "frames": r["res"].frames, "launches": r["counts"]}
    del resumed, want

    # A torn staging buffer fails typed, non-zero.
    r = run_stream_cli([src, MAIN_W, MAIN_H, MAIN_REPS, "rgb", "--frames",
                        n, "--output", d / "o.raw", *PALLAS, "--faults",
                        "integrity.corrupt_ingest:frame=3"], expect_rc=1)
    require("ChecksumMismatch" in r["stderr"], f"torn buffer: {r['stderr']}")
    runs["torn_buffer"] = {"rc": r["rc"], "stderr":
                           r["stderr"].strip().splitlines()[-1]}
    (d / "o.raw").unlink(missing_ok=True)

    # Throughput: 32 frames to a null sink, depths taking turns.
    fb = MAIN_H * MAIN_W * MAIN_C
    slot = torch.empty(fb, dtype=torch.uint8, pin_memory=True)
    slot.numpy()[:] = np.fromfile(src, np.uint8, count=fb)
    crc_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        checksum.crc32c(slot.numpy())
        crc_ms.append((time.perf_counter() - t0) * 1e3)
    samples = {k: [] for k in STREAM_DEPTHS}
    for _ in range(STREAM_ROUNDS):
        for depth in STREAM_DEPTHS:
            cfg = config.StreamConfig(
                str(src), MAIN_W, MAIN_H, MAIN_REPS, config.ImageType.RGB,
                backend="pallas", frames=STREAM_TIMED_FRAMES,
                output="null", pipeline_depth=depth)
            obs.reset()
            sink = ClockSink()
            res = engine.run_stream(cfg, devices=[dev], sink=sink)
            hist = obs.snapshot()["histograms"]
            samples[depth].append({
                "wall_fps": res.frames_per_second,
                "steady_fps": sink.steady_fps(),
                "stage_s_per_frame": {
                    s: hist[f"stream_{s}_seconds"]["mean"]
                    for s in ("read", "h2d", "compute", "d2h", "write")}})
    obs.reset()
    throughput = {}
    for depth, rows in samples.items():
        med = lambda k: statistics.median(r[k] for r in rows)  # noqa: E731
        throughput[f"depth{depth}"] = {
            "wall_fps": med("wall_fps"), "steady_fps": med("steady_fps"),
            "stage_s_per_frame": {
                s: statistics.median(r["stage_s_per_frame"][s] for r in rows)
                for s in rows[0]["stage_s_per_frame"]},
            "runs": rows,
            "modeled_fps": roofline.stream_frames_per_second(
                fb, MAIN_REPS, "pallas", "gaussian", MAIN_H,
                pipeline_depth=depth, w_img=MAIN_W, channels=MAIN_C,
                device=dev)}

    # The profiler's view of a depth-2 run: copies beside K1.
    from torch.profiler import ProfilerActivity, profile

    cfg = config.StreamConfig(
        str(src), MAIN_W, MAIN_H, MAIN_REPS, config.ImageType.RGB,
        backend="pallas", frames=8, output="null", pipeline_depth=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run_stream(cfg, devices=[dev], sink=ClockSink())
        torch.cuda.synchronize()
    path = str(WORK / "stream_trace.json")
    prof.export_chrome_trace(path)
    profiled = {**copy_kernel_overlap(path, K1_NAME),
                **{k: v for k, v in stream_concurrency(path).items()
                   if k in ("streams", "concurrent_us", "any_busy_us",
                            "span_us", "idle_share")}}
    os.unlink(path)
    import shutil

    shutil.rmtree(d)
    return {"phase": "stream_path", "ok": True, "frames": n,
            "shape": [MAIN_H, MAIN_W, MAIN_C], "reps": MAIN_REPS,
            "max_abs_err": max(errs.values()), "errs": errs,
            "k1_launches_per_frame": per_frame, "runs": runs,
            "crc": {"implementation": checksum.implementation(),
                    "ms_per_frame_pass": statistics.median(crc_ms),
                    "passes_per_frame": 2},
            "throughput": throughput, "profile_depth2": profiled,
            "modeled_stage_s": roofline.stream_stage_seconds(
                fb, MAIN_REPS, "pallas", "gaussian", MAIN_H, w_img=MAIN_W,
                channels=MAIN_C, device=dev)}


BIG_W, BIG_H, BIG_FRAMES = 7680, 4320, 8  # 99.5 MB an RGB frame


def phase_shard_stream_path(dev) -> dict:
    """The spatially sharded stream and the temporal pipeline on virtual
    meshes of this card, 1920x2520 x40 gaussian, ``--backend pallas``.

    Bytes: 16 frames file to file at depth 2 with ``--shard-frames 2x2``
    over ``[cuda:0] * 4`` under ``--overlap edge`` (the default) and
    ``off``, and 1x2 on grey frames, each equal to the torch-ops path
    (``run_job --frames 16 --backend xla``) and to the same clip streamed
    on one device, K3's launches on each run equal to the runner's
    schedule (frames x launches a frame + the warm-up's) and no K1 or K2
    launch. Throughput: 32 frames to a null sink at depths 1 and 2 under
    both modes and through ``--pipe-stages 2`` and ``4`` at depth 2,
    taking turns, median of 3, with the stage seconds per shard. The
    larger frame: 8 frames of 7680x4320 RGB under 2x2 ``off``
    against torch ops, with frames/s. The pipeline (torch-ops stages):
    ``--pipe-stages 2`` and ``4`` over ``[cuda:0] * K`` on 16 frames,
    reps 3 with K 4, 2 frames with K 4, and ``--mesh-frames 2
    --pipe-stages 2 --shard-frames 2x1`` over ``[cuda:0] * 8``, each equal
    to one device's output; a compute fault at frame 9 restarts the
    pipeline once from its checkpoint, and a resume under another stage
    count raises ``MeshCursorMismatch``. Auto: ``--shard-frames 0`` and
    ``--pipe-stages 0`` over ``[cuda:0] * 4`` print their measured
    verdicts, and a second call pays no probe frame. The profiler: an
    8-frame depth-2 2x2 run, the time a shard's H2D and K3 were busy at
    once, the device's idle share."""
    from tpu_stencil_torch import config, driver, obs
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering
    from tpu_stencil_torch.parallel import pipeline
    from tpu_stencil_torch.parallel import sharded as psharded
    from tpu_stencil_torch.resilience import faults
    from tpu_stencil_torch.runtime import checkpoint as ckpt
    from tpu_stencil_torch.runtime import roofline
    from tpu_stencil_torch.stream import engine
    from tpu_stencil_torch.stream import sharded as shardstream

    t_phase = time.perf_counter()
    d = stream_clip()
    n = STREAM_FRAMES
    plan = plan_of("gaussian")
    runs, errs = {}, {}

    def frames_file(path, itype, frames=n, h=MAIN_H, w=MAIN_W):
        shape = (frames, h, w) + ((MAIN_C,) if itype == "rgb" else ())
        got = np.fromfile(path, np.uint8)
        require(got.size == int(np.prod(shape)),
                f"{path}: {got.size} bytes, expected {int(np.prod(shape))}")
        os.unlink(path)
        return got.reshape(shape)

    def scfg(itype, reps=MAIN_REPS, src=None, **kw):
        kw.setdefault("frames", n)
        kw.setdefault("output", str(d / "o.raw"))
        return config.StreamConfig(
            str(src or d / f"clip_{itype}.raw"), MAIN_W, MAIN_H, reps,
            config.ImageType(itype), backend="pallas", **kw)

    def check(label, got, want):
        err = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        errs[label] = err
        require(err == 0, f"shard_stream_path {label} disagrees ({err})")

    def k3_schedule(ch, mesh, overlap, frames):
        # The runner the stream ran: the shared cache's (a hit).
        model = IteratedConv2D("gaussian", backend="pallas", device=dev)
        runner = psharded.shared_runner(
            model, (MAIN_H, MAIN_W), ch, mesh_shape=mesh,
            devices=[dev] * (mesh[0] * mesh[1]), overlap=overlap)
        per = sum(x["launches"] for x in runner.describe_launches(
            cs.launch_schedule(MAIN_REPS, runner.fuse)))
        warm = sum(x["launches"] for x in runner.describe_launches(
            runner.warm_reps([MAIN_REPS])))
        return frames * per + warm, per, warm, runner.fuse

    wants, ones = {}, {}
    for itype in ("rgb", "grey"):
        src = d / f"clip_{itype}.raw"
        cfg = config.JobConfig(str(src), MAIN_W, MAIN_H, MAIN_REPS,
                               config.ImageType(itype), frames=n,
                               backend="xla", output=str(d / "want.raw"))
        driver.run_job(cfg, devices=[dev])
        wants[itype] = frames_file(d / "want.raw", itype)
        res, counts = counted(lambda: engine.run_stream(scfg(itype),
                                                        devices=[dev]))
        ones[itype] = frames_file(d / "o.raw", itype)
        check(f"one_device_{itype}", ones[itype], wants[itype])

    # The sharded stream, file to file, K3's launches against the schedule.
    for label, itype, mesh, overlap in (
            ("shard2x2_edge", "rgb", (2, 2), "edge"),
            ("shard2x2_off", "rgb", (2, 2), "off"),
            ("shard1x2_grey", "grey", (1, 2), "edge")):
        k = mesh[0] * mesh[1]
        cfg = scfg(itype, shard_frames=mesh, overlap=overlap)
        t0 = time.perf_counter()
        res, counts = counted(lambda: engine.run_stream(cfg,
                                                        devices=[dev] * k))
        secs = time.perf_counter() - t0
        got = frames_file(d / "o.raw", itype)
        check(label, got, wants[itype])
        check(label + "_vs_one_device", got, ones[itype])
        expect, per, warm, fuse = k3_schedule(1 if itype == "grey" else 3,
                                              mesh, overlap, n)
        require(counts == launches(stencil_valid=expect),
                f"{label}: launches {counts}, expected K3 {expect} "
                f"({n} x {per} + {warm})")
        require(res.shard_frames == mesh and res.n_devices == k
                and res.backend == "pallas",
                f"{label}: ran {res.shard_frames} on {res.n_devices} "
                f"({res.backend})")
        runs[label] = {"launches": counts, "k3_per_frame": per,
                       "k3_warmup": warm, "fuse": fuse, "seconds": secs,
                       "frames_per_second": res.frames_per_second}
        del got

    # Throughput: 32 frames to a null sink, the 2x2 modes and depths and
    # the pipeline's stage counts taking turns.
    fb = MAIN_H * MAIN_W * MAIN_C
    arms = {f"{m}_depth{dp}": (dict(shard_frames=(2, 2), overlap=m,
                                    pipeline_depth=dp), 4)
            for m in ("off", "edge") for dp in (1, 2)}
    arms.update({f"pipe{k}_depth2": (dict(pipe_stages=k), k) for k in (2, 4)})
    samples = {a: [] for a in arms}
    for _ in range(STREAM_ROUNDS):
        for label, (kw, k) in arms.items():
            cfg = scfg("rgb", frames=STREAM_TIMED_FRAMES, output="null", **kw)
            obs.reset()
            sink = ClockSink()
            res = engine.run_stream(cfg, devices=[dev] * k, sink=sink)
            hist = obs.snapshot()["histograms"]
            samples[label].append({
                "wall_fps": res.frames_per_second,
                "steady_fps": sink.steady_fps(),
                "stage_s": {s: hist[f"stream_{s}_seconds"]["mean"]
                            for s in ("read", "h2d", "compute", "d2h",
                                      "write")}})
    obs.reset()
    throughput = {}
    for label, rows in samples.items():
        kw = arms[label][0]
        throughput[label] = {
            "steady_fps": statistics.median(r["steady_fps"] for r in rows),
            "wall_fps": statistics.median(r["wall_fps"] for r in rows),
            # A shard's h2d and d2h: seconds per shard (one span each); a
            # pipeline's compute: from a frame's feed to its finish.
            "stage_s": {s: statistics.median(r["stage_s"][s] for r in rows)
                        for s in rows[0]["stage_s"]},
            "runs": rows,
            "modeled_fps": (
                roofline.sharded_stream_frames_per_second(
                    fb, MAIN_REPS, "pallas", "gaussian", MAIN_H, MAIN_W,
                    MAIN_C, (2, 2), pipeline_depth=kw["pipeline_depth"],
                    one_card=True) if "shard_frames" in kw
                else roofline.pipeline_stream_frames_per_second(
                    fb, MAIN_REPS, "xla", "gaussian", MAIN_H,
                    kw["pipe_stages"], frames=STREAM_TIMED_FRAMES,
                    one_card=True))}

    # The larger frame: 8 frames of 7680x4320 RGB, 2x2 off.
    big = d / "clip_big.raw"
    clip = np.random.default_rng(10).integers(
        0, 256, (BIG_FRAMES, BIG_H, BIG_W, MAIN_C), np.uint8)
    clip.tofile(big)
    cfg = config.StreamConfig(
        str(big), BIG_W, BIG_H, MAIN_REPS, config.ImageType.RGB,
        backend="pallas", frames=BIG_FRAMES, output=str(d / "o.raw"),
        shard_frames=(2, 2), overlap="off")
    res, counts = counted(lambda: engine.run_stream(cfg, devices=[dev] * 4))
    got = frames_file(d / "o.raw", "rgb", BIG_FRAMES, BIG_H, BIG_W)
    big_err = 0
    for i in range(BIG_FRAMES):
        want = lowering.iterate(torch.from_numpy(clip[i]).to(dev),
                                MAIN_REPS, plan).cpu().numpy()
        big_err = max(big_err, int(np.abs(got[i].astype(np.int16)
                                          - want.astype(np.int16)).max()))
    errs["big_8k"] = big_err
    require(big_err == 0, f"7680x4320 sharded stream disagrees ({big_err})")
    sink = ClockSink()
    res2 = engine.run_stream(dataclasses.replace(cfg, output="null"),
                             devices=[dev] * 4, sink=sink)
    runs["big_8k"] = {"frame_bytes": cfg.frame_bytes, "launches": counts,
                      "wall_fps_file": res.frames_per_second,
                      "wall_fps_null": res2.frames_per_second,
                      "steady_fps_null": sink.steady_fps(),
                      "stage_seconds_file": res.stage_seconds}
    del clip, got
    big.unlink()

    # The temporal pipeline, byte for byte against one device.
    def pipe_run(label, want, devices, reps=MAIN_REPS, **kw):
        frames = kw.get("frames", n)
        cfg = scfg("rgb", reps=reps, **kw)
        t0 = time.perf_counter()
        res, counts = counted(lambda: engine.run_stream(cfg,
                                                        devices=devices))
        got = frames_file(d / "o.raw", "rgb", frames)
        check(label, got, want)
        require(counts == NO_LAUNCHES, f"{label}: the torch-ops stages "
                f"launched {counts}")
        runs[label] = {"seconds": time.perf_counter() - t0,
                       "frames_per_second": res.frames_per_second,
                       "pipe_stages": res.pipe_stages,
                       "n_devices": res.n_devices, "backend": res.backend,
                       "restarts": res.restarts,
                       "stage_seconds": res.stage_seconds}
        return res

    for k in (2, 4):
        res = pipe_run(f"pipe{k}", ones["rgb"], [dev] * k, pipe_stages=k)
        require(res.pipe_stages == k and res.backend == "xla",
                f"pipe{k}: ran {res.pipe_stages} ({res.backend})")
    rgb = np.fromfile(d / "clip_rgb.raw", np.uint8, count=4 * fb).reshape(
        4, MAIN_H, MAIN_W, MAIN_C)
    want3 = np.stack([lowering.iterate(torch.from_numpy(f).to(dev), 3,
                                       plan).cpu().numpy() for f in rgb])
    pipe_run("pipe4_reps3", want3, [dev] * 4, reps=3, frames=4,
             pipe_stages=4)
    pipe_run("pipe4_frames2", ones["rgb"][:2], [dev] * 4, frames=2,
             pipe_stages=4)
    res = pipe_run("mesh2_pipe2_shard2x1", ones["rgb"], [dev] * 8,
                   mesh_frames=2, pipe_stages=2, shard_frames=(2, 1),
                   shard_min_pixels=1)
    require(res.n_devices == 8 and res.per_device_frames == [n // 2] * 2,
            f"three axes: {res.n_devices} devices, "
            f"{res.per_device_frames}")
    faults.configure("compute:frame=9")
    try:
        res = pipe_run("pipe2_resume", ones["rgb"], [dev] * 2,
                       pipe_stages=2, checkpoint_every=4)
    finally:
        faults.clear()
    require(res.restarts == 1, f"pipe resume: {res.restarts} restarts")
    cfg = scfg("rgb", pipe_stages=2, checkpoint_every=4)
    ckpt.save_stream_progress(cfg, 4, pipe_stages=2)
    open(cfg.output_path, "wb").write(ones["rgb"][:4].tobytes())
    try:
        engine.run_stream(dataclasses.replace(cfg, pipe_stages=4),
                          devices=[dev] * 4, resume=True)
        mismatch = None
    except ckpt.MeshCursorMismatch as e:
        mismatch = str(e)
    require(mismatch is not None, "a resume under 4 stages of a 2-stage "
            "sidecar did not raise MeshCursorMismatch")
    runs["resume_other_topology"] = {"raised": "MeshCursorMismatch",
                                     "message": mismatch}
    ckpt.clear_stream_progress(cfg)
    (d / "o.raw").unlink(missing_ok=True)

    # Auto: measured verdicts, then the warm cache (no probe frame).
    probes = {"shard": 0, "pipe": 0}
    real = (shardstream.measure_shard_ab, pipeline.measure_pipeline_ab)

    def count_shard(*a, **k):
        probes["shard"] += 1
        return real[0](*a, **k)

    def count_pipe(*a, **k):
        probes["pipe"] += 1
        return real[1](*a, **k)

    shardstream.measure_shard_ab = count_shard
    pipeline.measure_pipeline_ab = count_pipe
    try:
        for knob, kw in (("shard", {"shard_frames": (0, 0)}),
                         ("pipe", {"pipe_stages": 0})):
            for call in ("cold", "warm"):
                before = dict(probes)
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    res = engine.run_stream(scfg("rgb", **kw),
                                            devices=[dev] * 4)
                check(f"auto_{knob}_{call}",
                      frames_file(d / "o.raw", "rgb"), ones["rgb"])
                lines = [ln for ln in err.getvalue().splitlines()
                         if "auto" in ln]
                print("\n".join(lines), flush=True)
                paid = probes[knob] - before[knob]
                if call == "cold":
                    require(paid == 1 and any("measured" in ln
                                              for ln in lines),
                            f"auto {knob}: no measured verdict: {lines}")
                else:
                    require(paid == 0 and any("warm cache" in ln
                                              for ln in lines),
                            f"auto {knob}: the warm call probed: {lines}")
                runs[f"auto_{knob}_{call}"] = {
                    "verdict": lines, "probes": paid,
                    "shard_frames": res.shard_frames,
                    "pipe_stages": res.pipe_stages}
    finally:
        shardstream.measure_shard_ab, pipeline.measure_pipeline_ab = real

    # The profiler's view of a depth-2 2x2 run: shard copies beside K3.
    from torch.profiler import ProfilerActivity, profile

    cfg = scfg("rgb", frames=8, output="null", shard_frames=(2, 2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run_stream(cfg, devices=[dev] * 4, sink=ClockSink())
        torch.cuda.synchronize()
    path = str(WORK / "shard_stream_trace.json")
    prof.export_chrome_trace(path)
    profiled = {**copy_kernel_overlap(path, "stencil_valid_kernel"),
                **{k: v for k, v in stream_concurrency(path).items()
                   if k in ("streams", "concurrent_us", "any_busy_us",
                            "span_us", "idle_share")}}
    os.unlink(path)
    import shutil

    shutil.rmtree(d)
    return {"phase": "shard_stream_path", "ok": True, "frames": n,
            "shape": [MAIN_H, MAIN_W, MAIN_C], "reps": MAIN_REPS,
            "max_abs_err": max(errs.values()), "errs": errs, "runs": runs,
            "throughput": throughput, "profile_depth2": profiled,
            "modeled_stage_s": roofline.sharded_stream_stage_seconds(
                MAIN_REPS, "pallas", "gaussian", MAIN_H, MAIN_W, MAIN_C,
                (2, 2), one_card=True),
            "seconds": time.perf_counter() - t_phase}


# The serve phase's requests: (height, width, channels, filter, reps).
# The main image (bucket 3072x2048 RGB, 18.9 MB a frame) and a second
# frame of its bucket (one batch of two), a 1x1 image, a request above
# the ladder's top edge (3100 rows -> 6144), several filters, grey and
# RGB, reps 0, 1, 9 and 40; the last two share a key (one batch).
SERVE_CASES = (
    (MAIN_H, MAIN_W, MAIN_C, "gaussian", MAIN_REPS),
    (2500, 1900, 3, "gaussian", MAIN_REPS),
    (1, 1, 1, "gaussian", 1),
    (3100, 40, 1, "gaussian", 9),
    (300, 200, 3, "box", 9),
    (240, 320, 1, "edge", 1),
    (300, 200, 3, "gaussian7", 9),
    (120, 90, 3, "gaussian5", 0),
    (64, 48, 3, "gaussian", 9),
    (60, 40, 3, "gaussian", 9),
)


def serve_images(cases) -> list:
    out = []
    for i, (h, w, c, _, _) in enumerate(cases):
        shape = (h, w) if c == 1 else (h, w, c)
        out.append(np.random.default_rng(100 + i).integers(
            0, 256, shape, np.uint8))
    return out


def serve_reference(img: np.ndarray, name: str, reps: int, dev,
                    i: int) -> np.ndarray:
    """The port's ``driver.run_job --backend xla`` on the card for one
    request (the torch-ops path, file to file)."""
    from tpu_stencil_torch import config, driver

    src = WORK / f"serve_req{i}.raw"
    dst = WORK / f"serve_req{i}_xla.raw"
    img.tofile(src)
    kind = config.ImageType.RGB if img.ndim == 3 else config.ImageType.GREY
    driver.run_job(config.JobConfig(
        str(src), img.shape[1], img.shape[0], reps, kind, filter_name=name,
        backend="xla", output=str(dst)), devices=[dev])
    got = np.fromfile(dst, np.uint8).reshape(img.shape)
    src.unlink()
    dst.unlink()
    return got


def serve_batches(cases, edges, max_batch: int) -> list:
    """The batches a parked server forms from ``cases`` submitted in
    order, then started: FIFO by key, up to ``max_batch`` a batch, as
    ``StencilServer._take_batch_locked`` takes them. Returns the reps of
    each batch."""
    from tpu_stencil_torch.serve import bucketing

    keys = [(n, bucketing.bucket_shape(h, w, edges), c, r)
            for h, w, c, n, r in cases]
    pending, out = list(keys), []
    while pending:
        key = pending[0]
        same = [k for k in pending if k == key][:max_batch]
        for k in same:
            pending.remove(k)
        out.append(key[3])
    return out


# The load run: 64 requests of ``--shapes 1920x2520`` (H x W: the main
# image's pixels with its sides swapped), RGB, x40.
LOAD_REQUESTS, LOAD_H, LOAD_W = 64, 1920, 2520


class Captured:
    """A loadgen target that hands every request to ``server`` and keeps
    each (image, future), so a run's results are checked after it."""

    def __init__(self, server) -> None:
        self.server, self.taken = server, []

    def submit(self, image, reps, **kw):
        fut = self.server.submit(image, reps, **kw)
        self.taken.append((image, fut))
        return fut

    def submit_retrying(self, image, reps, **kw):
        fut = self.server.submit_retrying(image, reps, **kw)
        self.taken.append((image, fut))
        return fut

    def stats(self) -> dict:
        return self.server.stats()


def nearest_rank(sorted_vals, p: float) -> float:
    """The nearest-rank percentile the serve registry reports."""
    k = min(len(sorted_vals) - 1,
            max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def serve_load_pass(server, label: str, load_kw: dict, images: list,
                    want: list) -> dict:
    """One closed-loop ``loadgen.run`` over ``server`` (``load_kw``, with
    ``per_request``) whose requests are ``images``: every result held
    against ``want`` after the pass. Returns the pass's numbers: client
    latency percentiles, and batch means from the registry's deltas."""
    from tpu_stencil_torch.serve import loadgen

    n = len(images)
    index = {img[0, :16].tobytes(): i for i, img in enumerate(images)}
    require(len(index) == n, "load images share a prefix")
    target = Captured(server)
    h0 = server.stats()["histograms"]
    b0 = server.stats()["counters"]["batches_total"]
    rep = loadgen.run(target, **load_kw)
    st = server.stats()
    require(rep["completed"] == n and len(target.taken) == n
            and st["counters"]["failed_total"] == 0,
            f"serve {label} pass: {rep['completed']} completed, "
            f"{len(target.taken)} taken")
    seen, err = set(), 0
    for image, fut in target.taken:
        i = index.get(image[0, :16].tobytes())
        require(i is not None and i not in seen
                and np.array_equal(image, images[i]),
                f"serve {label} pass: an unknown or repeated request")
        seen.add(i)
        got = fut.result(timeout=0)
        require(got.shape == want[i].shape,
                f"serve {label} pass: request {i} shape {got.shape}")
        if not np.array_equal(got, want[i]):
            err = max(err, int(np.abs(got.astype(int)
                                      - want[i].astype(int)).max()))
    require(err == 0, f"serve {label} pass: max abs err {err} against "
            "torch ops on the card")
    lat = sorted(r["latency_s"] for r in rep["per_request"])

    def delta_mean(name):
        h1, h = st["histograms"][name], h0.get(name, {})
        k = h1["count"] - h.get("count", 0)
        return (h1["sum"] - h.get("sum", 0.0)) / k if k else None

    return {"throughput_rps": rep["throughput_rps"],
            "wall_seconds": rep["wall_seconds"],
            "p50_s": nearest_rank(lat, 50), "p99_s": nearest_rank(lat, 99),
            "batches": st["counters"]["batches_total"] - b0,
            "batch_size_mean": delta_mean("batch_size"),
            "batch_latency_mean_s": delta_mean("batch_latency_seconds"),
            "batch_hbm_gbps_mean": delta_mean("batch_hbm_gbps"),
            "arena_alloc_total": st["counters"]["arena_canvas_alloc_total"],
            "arena_reuse_total": st["counters"]["arena_canvas_reuse_total"],
            "verified": len(seen), "max_abs_err": err}


def serve_run(cfg, images, cases, dev, devices=None) -> tuple:
    """Every request submitted to a parked server, which is then started,
    with the launch counters set to 0 just before the start and read
    after the last result: (results, stats, launches)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.serve import StencilServer

    server = StencilServer(cfg, start=False, device=dev, devices=devices)
    try:
        futs = [server.submit(img, c[4], filter_name=c[3])
                for img, c in zip(images, cases)]
        cs.reset_launch_counts()
        server.start()
        got = [f.result(timeout=300) for f in futs]
        torch.cuda.synchronize()
        counts = cs.launch_counts()
        stats = server.stats()
    finally:
        require(server.close(timeout=60), "the server did not drain")
    return got, stats, counts


def phase_serve_path(dev) -> dict:
    """Phase ``serve_path``: the serving engine on the card (see the
    module docstring)."""
    from tpu_stencil_torch.config import ServeConfig
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.parallel import sharded as psharded
    from tpu_stencil_torch.integrity import witness
    from tpu_stencil_torch.serve import GroupItem, StencilServer, bucketing
    from tpu_stencil_torch.serve import cli as serve_cli
    from tpu_stencil_torch.serve import engine as serve_engine
    from tpu_stencil_torch.serve import loadgen

    t_phase = time.perf_counter()
    WORK.mkdir(parents=True, exist_ok=True)
    out = {}
    laps, t_lap = {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    images = serve_images(SERVE_CASES)
    want = [serve_reference(img, c[3], c[4], dev, i)
            for i, (img, c) in enumerate(zip(images, SERVE_CASES))]

    def same(got, label):
        errs = [int(np.abs(g.astype(int) - w.astype(int)).max())
                if g.shape == w.shape and g.size else 0
                for g, w in zip(got, want)]
        require(all(g.shape == w.shape and g.dtype == np.uint8
                    for g, w in zip(got, want)) and max(errs) == 0,
                f"{label}: max abs err {max(errs)} against run_job xla")
        return max(errs)

    lap("references")
    # 1. The bucket route through K1: one single-rep launch per rep per
    # batch, no K2, a repeated key a cache hit.
    edges = bucketing.DEFAULT_EDGES
    batch_reps = serve_batches(SERVE_CASES, edges, 8)
    cfg = ServeConfig(backend="pallas", max_batch=8)
    got, stats, counts = serve_run(cfg, images, SERVE_CASES, dev)
    err = same(got, "serve pallas")
    c = stats["counters"]
    expect = launches(stencil_fused=sum(batch_reps))
    require(counts == expect and c["batches_total"] == len(batch_reps),
            f"serve pallas: launches {counts}, batches {c['batches_total']};"
            f" expected {expect} over {len(batch_reps)} batches")
    # A repeated key: a cache hit. Introspection armed: one record for
    # the key, the K1 instance with the card's registers and occupancy;
    # the memory sampler's gauges in the server's registry.
    from tpu_stencil_torch import obs

    obs.introspect.enable()
    try:
        with StencilServer(cfg, device=dev) as server:
            for _ in range(2):
                server.submit(images[-1],
                              SERVE_CASES[-1][4]).result(timeout=300)
            rstats = server.stats()
            recs = server.introspection()
    finally:
        obs.introspect.disable()
    hits = rstats["counters"]["cache_hits_total"]
    require(hits >= 1, f"a repeated key made {hits} cache hits")
    require(len(recs) == 1 and recs[0]["available"]
            and recs[0]["kernels"][0]["kernel"] == "stencil_fused",
            f"serve introspection: {recs}")
    require("device_bytes_in_use" in rstats["gauges"],
            f"no device memory gauge: {sorted(rstats['gauges'])}")
    out["pallas"] = {"launches": counts, "batches": c["batches_total"],
                     "batch_reps": batch_reps, "cache_hits": hits,
                     "max_abs_err": err, "instance": recs[0]["kernels"][0],
                     "batch_hbm_gbps": stats["histograms"]["batch_hbm_gbps"]}
    lap("pallas")
    # 2. The same requests under xla: torch ops, no kernel launch.
    got, stats, counts = serve_run(
        ServeConfig(backend="xla", max_batch=8), images, SERVE_CASES, dev)
    out["xla"] = {"launches": counts, "max_abs_err": same(got, "serve xla")}
    require(counts == NO_LAUNCHES, f"serve xla launched {counts}")
    lap("xla")
    # 3. Sharded routing of the two 1920-wide frames (shard_min_pixels
    # below them): "off" keeps them on the bucket route (K1); "edge"
    # sends them through the runner over the visible card (a 1x1 mesh)
    # and over [dev] * 4 (2x2). K3's launches are the runner's schedule.
    big = [0, 1]
    bcases = [SERVE_CASES[i] for i in big]
    bimgs = [images[i] for i in big]
    bwant = [want[i] for i in big]
    sharded = {}
    for label, overlap, devices in (("off", "off", None),
                                    ("edge_1x1", "edge", None),
                                    ("edge_2x2", "edge", [dev] * 4)):
        psharded.clear_runner_cache()
        scfg = ServeConfig(backend="pallas", max_batch=8, overlap=overlap,
                           shard_min_pixels=1 << 20)
        got, stats, counts = serve_run(scfg, bimgs, bcases, dev, devices)
        require(all(np.array_equal(g, w) for g, w in zip(got, bwant)),
                f"serve sharded {label}: bytes differ from the bucket route")
        c = stats["counters"]
        if overlap == "off":
            expect = launches(stencil_fused=MAIN_REPS)  # one batch of two
            require(c["sharded_requests_total"] == 0,
                    "overlap off routed a request to the mesh")
            sharded[label] = {"launches": counts}
        else:
            runner = psharded.shared_runner(
                IteratedConv2D("gaussian", backend="pallas", device=dev),
                (MAIN_H, MAIN_W), MAIN_C,
                devices=devices or [dev], overlap=overlap)
            tiles = runner.mesh_shape[0] * runner.mesh_shape[1]
            chunks = MAIN_REPS // runner.fuse + MAIN_REPS % runner.fuse
            # Both frames: the main one and the 2500x1900 one, each its
            # own runner of the same mesh and schedule.
            expect = launches(
                stencil_valid=2 * PIECES[runner.overlap] * tiles * chunks)
            require(c["sharded_requests_total"] == 2,
                    f"{label}: {c['sharded_requests_total']} sharded")
            sharded[label] = {"launches": counts, "mesh": runner.mesh_shape,
                              "overlap": runner.overlap,
                              "fuse": runner.fuse}
        require(counts == expect,
                f"serve sharded {label}: launches {counts}, expected "
                f"{expect}")
    psharded.clear_runner_cache()
    out["sharded"] = sharded
    lap("sharded")
    # 4. --self-test in a fresh process, as a user runs it.
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_stencil_torch", "serve", "--self-test"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    require(proc.returncode == 0 and "serve self-test OK" in proc.stdout,
            f"serve --self-test rc {proc.returncode}: {proc.stderr[-2000:]}")
    out["self_test"] = proc.stdout.strip().splitlines()[-1]
    lap("self_test")
    # 5. The closed-loop load run at the reference's size. (a) As a user
    # runs it: the CLI in this process (its K1 launches counted), then the
    # sentry reading back the record it wrote. Its ``--verify golden``
    # checks frames of at most loadgen.GOLDEN_MAX_PIXELS, as in the JAX
    # package: none at this size, so (b) holds the bytes.
    stats_json = WORK / "serve_stats.json"
    history = WORK / "serve_perf_history.jsonl"
    history.unlink(missing_ok=True)
    load_args = ["--requests", str(LOAD_REQUESTS), "--concurrency", "8",
                 "--shapes", f"{LOAD_H}x{LOAD_W}", "--channels",
                 str(MAIN_C), "--reps", str(MAIN_REPS), "--backend",
                 "pallas", "--verify", "golden", "--stats-json",
                 str(stats_json), "--perf-log", str(history)]
    obs.reset()
    buf = io.StringIO()
    cs.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(load_args)
    counts = cs.launch_counts()
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        print(ln, flush=True)
    require(rc == 0, f"serve load run returned {rc}")
    report = json.loads(stats_json.read_text())
    c = report["stats"]["counters"]
    fallbacks = obs.snapshot()["counters"].get("resilience_fallbacks_total",
                                               0)
    require(report["verify_failures_total"] == 0
            and c["completed_total"] == LOAD_REQUESTS
            and c["failed_total"] == 0
            and report["rejected"] == 0 and fallbacks == 0,
            f"serve load run: {c}, verify failures "
            f"{report['verify_failures_total']}, fallbacks {fallbacks}")
    require(counts == launches(stencil_fused=MAIN_REPS * c["batches_total"]),
            f"serve load run: launches {counts} over {c['batches_total']} "
            "batches")
    metric = f"serve.p50_s.closed.c8.reps{MAIN_REPS}"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_stencil_torch", "perf", "check",
         "--history", str(history), "--metric", metric,
         "--value", repr(report["p50_s"]), "--shape", f"{LOAD_H}x{LOAD_W}",
         "--backend", "pallas", "--platform", "gpu", "--json"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    require(proc.returncode == 0 and verdict["n_history"] == 1,
            f"perf check read {verdict} (rc {proc.returncode})")
    load = {"cli": {
        "throughput_rps": report["throughput_rps"],
        "p50_s": report["p50_s"], "p99_s": report["p99_s"],
        "wall_seconds": report["wall_seconds"],
        "batches": c["batches_total"],
        "batch_hbm_gbps": report["stats"]["histograms"]["batch_hbm_gbps"],
        "launches": counts, "perf_check": verdict["status"]}}
    lap("load_cli")
    # (b) The same seeded requests twice through loadgen.run on one
    # server built as the CLI builds it: a cold pass (programs built and
    # pinned slots allocated on first use); then every batch bucket's
    # ring of slots filled (three groups of nb, nb = 1, 2, 4, 8); then a
    # warm pass, which allocates nothing. Every result is kept and held,
    # after its pass, against torch ops on the card, so a pinned slot's
    # canvas and output, each rewritten many times a pass, are checked
    # under the load run's own timing.
    import concurrent.futures

    limages = loadgen.synth_requests(LOAD_REQUESTS, [(LOAD_H, LOAD_W)],
                                     [MAIN_C], 0)
    lwant = [witness.device_witness(img, "gaussian", MAIN_REPS, device=dev)
             for img in limages]
    lap("load_references")
    load_kw = dict(mode="closed", requests=LOAD_REQUESTS, concurrency=8,
                   reps=MAIN_REPS, shapes=[(LOAD_H, LOAD_W)],
                   channels=[MAIN_C], seed=0, per_request=True)

    from torch.profiler import ProfilerActivity, profile

    def ring_sizes(server) -> dict:
        return {k: len(e["slots"])
                for k, e in server._arena._rings.items()}

    cs.reset_launch_counts()
    with StencilServer(ServeConfig(backend="pallas"), device=dev) as server:
        cold = serve_load_pass(server, "cold", load_kw, limages, lwant)
        cold_rings = ring_sizes(server)
        lap("load_cold_pass")
        b0 = server.stats()["counters"]["batches_total"]
        ring = server.cfg.pipeline_depth + 1
        for nb in (1, 2, 4, 8):
            for _ in range(ring):
                items = [GroupItem(image=img,
                                   future=concurrent.futures.Future(),
                                   t_submit=time.perf_counter())
                         for img in limages[:nb]]
                server.submit_group(items, MAIN_REPS)
                require(all(np.array_equal(it.future.result(timeout=300),
                                           lwant[i])
                            for i, it in enumerate(items)),
                        f"serve ring fill: a group of {nb} differs")
        fill_batches = server.stats()["counters"]["batches_total"] - b0
        a0 = server.stats()["counters"]["arena_canvas_alloc_total"]
        lap("load_ring_fill")
        warm = serve_load_pass(server, "warm", load_kw, limages, lwant)
        require(warm["arena_alloc_total"] == a0,
                f"serve warm pass allocated "
                f"{warm['arena_alloc_total'] - a0} pinned slots")
        lap("load_warm_pass")
        torch.cuda.synchronize()
        pcounts = cs.launch_counts()
        nbatch = cold["batches"] + fill_batches + warm["batches"]
        require(pcounts == launches(stencil_fused=MAIN_REPS * nbatch),
                f"serve load passes: launches {pcounts} over {nbatch} "
                "batches")
        # The card's idle share over a profiled warm closed-loop run of 16
        # requests (a run of its own: the profiler's cost stays out of the
        # numbers above).
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loadgen.run(server, **dict(load_kw, requests=16,
                                       per_request=False))
            torch.cuda.synchronize()
        lap("load_profiled")
        # The cold pass's pinned allocations: one slot of each key timed
        # here, times the slots the cold pass gave the key.
        alloc_ms, alloc_bytes = 0.0, 0
        for key, n in cold_rings.items():
            nb, _bh, bw, ch, stride = key
            shape = (nb, stride, bw) + ((ch,) if ch > 1 else ())
            t = time.perf_counter()
            slot = serve_engine._Slot(shape, True)
            alloc_ms += 1e3 * (time.perf_counter() - t) * n
            alloc_bytes += slot.nbytes * n
            del slot
        lap("load_alloc_timing")
    trace = str(WORK / "serve_trace.json")
    prof.export_chrome_trace(trace)
    load.update(cold=cold, warm=warm, launches=pcounts,
                ring_fill_batches=fill_batches,
                profiled=stream_concurrency(trace),
                pinned_alloc={"cold_slots": sum(cold_rings.values()),
                              "ms": alloc_ms, "bytes": alloc_bytes,
                              "cold_wall_share":
                                  alloc_ms / 1e3 / cold["wall_seconds"]})
    out["load"] = load
    for label, r in (("cold", cold), ("warm", warm)):
        print(f"serve load {label}: throughput_rps={r['throughput_rps']} "
              f"p50_s={r['p50_s']} p99_s={r['p99_s']} "
              f"batch_hbm_gbps_mean={r['batch_hbm_gbps_mean']} "
              f"verified={r['verified']}", flush=True)
    print(f"serve load: idle_share={load['profiled']['idle_share']} "
          f"cold pinned slots={sum(cold_rings.values())} "
          f"alloc_ms={alloc_ms} cold_wall_share="
          f"{load['pinned_alloc']['cold_wall_share']}", flush=True)
    lap("load_report")
    # 6. submit_group of 4: one stacked batch; the witness on a few
    # requests (torch ops on the card against K1, launching no kernel: K1
    # launches only the served batches' 9 + 9 + 40): no mismatch.
    gcfg = ServeConfig(backend="pallas", max_batch=8, witness_rate=1.0)
    gimgs = serve_images([(240, 320, 3, "gaussian", 9)] * 4)
    cs.reset_launch_counts()
    with StencilServer(gcfg, device=dev) as server:
        verdicts = []
        server.on_witness = verdicts.append
        server.submit(gimgs[0], 9).result(timeout=300)  # the key warm
        b0 = server.stats()["counters"]["batches_total"]
        now = time.perf_counter()
        items = [GroupItem(image=g, future=concurrent.futures.Future(),
                           t_submit=now) for g in gimgs]
        server.submit_group(items, 9)
        ggot = [it.future.result(timeout=300) for it in items]
        big_got = server.submit(images[0], MAIN_REPS).result(timeout=300)
        deadline = time.perf_counter() + 120
        while len(verdicts) < 6 and time.perf_counter() < deadline:
            time.sleep(0.05)
        gstats = server.stats()["counters"]
    torch.cuda.synchronize()
    gcounts = cs.launch_counts()
    require(gcounts == launches(stencil_fused=9 + 9 + MAIN_REPS),
            f"group and witness: launches {gcounts}")
    gwant = [serve_reference(g, "gaussian", 9, dev, 90 + i)
             for i, g in enumerate(gimgs)]
    require(gstats["batches_total"] == b0 + 2
            and all(np.array_equal(a, b) for a, b in zip(ggot, gwant))
            and np.array_equal(big_got, want[0]),
            f"submit_group: batches {gstats['batches_total']} after {b0}")
    require(verdicts == [True] * 6
            and gstats["integrity_witness_mismatch_total"] == 0,
            f"witness verdicts {verdicts}, {gstats}")
    out["group"] = {"batches": gstats["batches_total"] - b0,
                    "launches": gcounts,
                    "witness_total": gstats["integrity_witness_total"],
                    "witness_mismatch":
                        gstats["integrity_witness_mismatch_total"]}
    lap("group_witness")
    return {"phase": "serve_path", "ok": True,
            "seconds": time.perf_counter() - t_phase, "laps": laps,
            "max_abs_err": max(out["pallas"]["max_abs_err"],
                               out["xla"]["max_abs_err"]),
            "runs": out}


# -- the network tier (phase net_path) ---------------------------------

NET_WORK = WORK / "net"
# The mixed requests' reps, one batch each when posted one at a time.
NET_MIXED_REPS = sum(c[4] for c in SERVE_CASES)


def http_post(url: str, img: np.ndarray, reps: int, filter_name=None,
              headers=None, timeout: float = 300.0) -> tuple:
    """One ``POST /v1/blur``: (status, body, response headers)."""
    import urllib.error
    import urllib.request

    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    hdr = {"X-Width": str(w), "X-Height": str(h), "X-Reps": str(reps),
           "X-Channels": str(c)}
    if filter_name:
        hdr["X-Filter"] = filter_name
    hdr.update(headers or {})
    req = urllib.request.Request(url + "/v1/blur", data=img.tobytes(),
                                 headers=hdr, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def http_call(url: str, path: str, post: bool = False,
              timeout: float = 120.0) -> tuple:
    """One GET (or an empty POST) of ``path``: (status, body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=b"" if post else None,
                                 method="POST" if post else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_json(url: str, path: str, post: bool = False,
              timeout: float = 120.0) -> dict:
    status, body = http_call(url, path, post, timeout)
    require(status == 200, f"{path}: HTTP {status} {body[:300]!r}")
    return json.loads(body)


def net_frontend(devices=None, start_workers: bool = True, **kw):
    """A started ``NetFrontend`` under ``--backend pallas`` on port 0, its
    flight recorder and profiler spools under build/chip_smoke/net;
    ``devices`` None: every visible card, as the CLI gives them."""
    from tpu_stencil_torch.config import NetConfig
    from tpu_stencil_torch.net import NetFrontend

    cfg = dict(port=0, backend="pallas",
               flightrec_dir=str(NET_WORK / "flightrec"),
               prof_dir=str(NET_WORK / "profspool"))
    cfg.update(kw)
    return NetFrontend(NetConfig(**cfg), start_workers=start_workers,
                       devices=devices).start()


@contextlib.contextmanager
def counted_padded_step():
    """The torch-ops rep (``lowering.padded_step``) records its calls
    inside the block; yields the list of calls."""
    from tpu_stencil_torch.ops import lowering

    orig, calls = lowering.padded_step, []

    def step(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    lowering.padded_step = step
    try:
        yield calls
    finally:
        lowering.padded_step = orig


def wait_until(pred, timeout: float = 60.0, what: str = "") -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        require(time.perf_counter() < deadline, f"timed out: {what}")
        time.sleep(0.02)


def net_counter(fe, name: str) -> float:
    return fe.metrics_snapshot()["counters"].get(name, 0)


def prof_capture(url: str, seconds: float, load_fn) -> dict:
    """``POST /debug/prof?seconds=`` while ``load_fn`` keeps the tier busy
    on a thread; the spooled trace fetched back over ``GET /debug/prof/``
    into build/chip_smoke/net: its K1 event count and the device's idle
    share over it (:func:`stream_concurrency`)."""
    import threading

    stop = threading.Event()
    errors = []

    def load():
        try:
            while not stop.is_set():
                load_fn()
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    time.sleep(0.3)  # the load is running when the capture starts
    try:
        # A process's first capture also starts the profiler, which has
        # taken tens of seconds on the card: a long wait, not a failure.
        run = http_json(url, f"/debug/prof?seconds={seconds}", post=True,
                        timeout=400.0)
    finally:
        stop.set()
        t.join(timeout=300)
    require(not errors and not t.is_alive(), f"profiled load: {errors}")
    paths = [f["path"] for f in run["files"]]
    require(len(paths) == 1, f"profiler capture files {run['files']}")
    status, data = http_call(url, f"/debug/prof/{paths[0]}")
    require(status == 200, f"GET /debug/prof/{paths[0]}: {status}")
    trace = NET_WORK / f"{run['run']}.json"
    trace.write_bytes(data)
    index = http_json(url, "/debug/prof")
    require(any(r["run"] == run["run"] for r in index["runs"]),
            f"/debug/prof does not list {run['run']}")
    names = [e[1] for e in device_events(str(trace))]
    k1 = sum(K1_NAME in n for n in names)
    return {"run": run["run"], "seconds": run["seconds"], "bytes": len(data),
            "device_events": len(names), "k1_events": k1,
            **stream_concurrency(str(trace))}


def phase_net_path(dev, serve_warm: dict) -> dict:
    """Phase ``net_path``: the network tier (``NetFrontend``: HTTP front
    end, router, replica fleet) on the card, through real sockets on port
    0 (see the module docstring)."""
    import concurrent.futures
    import signal
    import threading

    from tpu_stencil_torch import obs
    from tpu_stencil_torch.integrity import checksum, witness
    from tpu_stencil_torch.obs import exposition
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.resilience import faults
    from tpu_stencil_torch.runtime import roofline
    from tpu_stencil_torch.serve import loadgen

    t_phase = time.perf_counter()
    NET_WORK.mkdir(parents=True, exist_ok=True)
    out, laps, t_lap = {}, {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    img = np.random.default_rng(200).integers(
        0, 256, (MAIN_H, MAIN_W, MAIN_C), np.uint8)
    want = witness.device_witness(img, "gaussian", MAIN_REPS, device=dev)
    mixed = serve_images(SERVE_CASES)
    mixed_want = [witness.device_witness(m, c[3], c[4], device=dev)
                  for m, c in zip(mixed, SERVE_CASES)]
    lap("references")

    # 1. One replica on the card (the default: one per device), one
    # request with an X-Content-Crc32c claim: byte-equal to torch ops,
    # the response's stamp verifies, K1 launches 40 (one batch), and the
    # torch-ops rep is never called. 2. The ten mixed requests one at a
    # time: one batch each, K1 launches their reps' sum.
    fe = net_frontend(witness_rate=0.0, sample_interval_s=0.2)
    try:
        require(len(fe.fleet) == 1 and fe.fleet.devices == [dev],
                f"net default fleet {fe.fleet.devices}")
        claim = {checksum.CRC_HEADER: str(checksum.crc32c(img))}
        with counted_padded_step() as steps:
            cs.reset_launch_counts()
            status, body, hdr = http_post(fe.url, img, MAIN_REPS,
                                          headers=claim)
            torch.cuda.synchronize()
            counts = cs.launch_counts()
        require(status == 200, f"net POST: {status} {body[:300]!r}")
        require(body == want.tobytes(), "net POST: bytes differ from "
                "torch ops on the card")
        require(checksum.stamp_matches(hdr.get(checksum.RESULT_HEADER),
                                       body), "net POST: stamp mismatch")
        require(counts == launches(stencil_fused=MAIN_REPS) and not steps,
                f"net POST: launches {counts}, padded_step {len(steps)}")
        out["one_request"] = {"launches": counts,
                              "stamp": hdr[checksum.RESULT_HEADER]}
        lap("one_request")
        b0 = net_counter(fe, "fleet_batches_total")
        with counted_padded_step() as steps:
            cs.reset_launch_counts()
            for i, (m, c) in enumerate(zip(mixed, SERVE_CASES)):
                status, body, _ = http_post(fe.url, m, c[4],
                                            filter_name=c[3])
                require(status == 200 and body == mixed_want[i].tobytes(),
                        f"net mixed request {i} ({c}): {status}")
            torch.cuda.synchronize()
            counts = cs.launch_counts()
        batches = net_counter(fe, "fleet_batches_total") - b0
        require(counts == launches(stencil_fused=NET_MIXED_REPS)
                and batches == len(SERVE_CASES) and not steps,
                f"net mixed: launches {counts} over {batches} batches, "
                f"padded_step {len(steps)}")
        out["mixed_requests"] = {"launches": counts, "batches": batches}
        lap("mixed")

        # 5. Observability under load: a profiler capture naming K1, the
        # time series' rates, the exposition's exact round trip, the
        # capacity payload's link.
        prof = prof_capture(fe.url, 0.5, lambda: http_post(
            fe.url, img, MAIN_REPS))
        require(prof["k1_events"] > 0, f"the capture names no K1 "
                f"kernel: {prof}")
        ts = http_json(fe.url, "/debug/timeseries?window=30")
        rate = ts["counters"]["responses_2xx_total"]["rate_per_s"]
        hrate = ts["histograms"]["request_latency_seconds"]["rate_per_s"]
        require(rate > 0 and hrate > 0, f"timeseries rates {rate} {hrate}")
        status, text = http_call(fe.url, "/metrics")
        text = text.decode()
        snap = exposition.parse_text(text, prefix="tpu_stencil_net")
        require(status == 200 and exposition.render_text(
            snap, prefix="tpu_stencil_net") == text
            and snap["counters"]["fleet_completed_total"] >= 11,
            "/metrics does not round-trip")
        cap = http_json(fe.url, "/debug/capacity")
        link = roofline.H100_PCIE_BYTES_PER_S / 1e9
        require(cap["bandwidth"]["roofline_gbps"] == link,
                f"/debug/capacity link {cap['bandwidth']}")
        warm = http_json(fe.url, "/admin/warmstate")
        require(warm["entries"] and not warm.get("unsupported")
                and all(set(e) == {"key"} for e in warm["entries"]),
                f"/admin/warmstate {warm}")
        out["observability"] = {
            "profile": prof, "timeseries_2xx_rate_per_s": rate,
            "timeseries_latency_rate_per_s": hrate,
            "metrics_lines": len(text.splitlines()),
            "capacity_bandwidth": cap["bandwidth"]}
        lap("observability")
    finally:
        fe.close()

    # 3. The result cache: eight identical requests to a parked replica,
    # one leader and seven collapsed, launching one request's K1; then a
    # repeat answers from the cache with no launch.
    img2 = np.random.default_rng(201).integers(
        0, 256, (MAIN_H, MAIN_W, MAIN_C), np.uint8)
    want2 = witness.device_witness(img2, "gaussian", MAIN_REPS, device=dev)
    fe = net_frontend(result_cache_mb=256.0, start_workers=False)
    try:
        results = [None] * 8

        def post(i):
            results[i] = http_post(fe.url, img2, MAIN_REPS)

        pool = concurrent.futures.ThreadPoolExecutor(8)
        futs = [pool.submit(post, i) for i in range(8)]
        wait_until(lambda: net_counter(fe, "singleflight_leaders_total") == 1
                   and net_counter(fe, "singleflight_collapsed_total") == 7,
                   what="eight identical requests joined one flight")
        cs.reset_launch_counts()
        fe.fleet.start_workers()
        for f in futs:
            f.result(timeout=300)
        pool.shutdown()
        torch.cuda.synchronize()
        counts = cs.launch_counts()
        xc = sorted(r[2].get("X-Cache") for r in results)
        require(all(r[0] == 200 and r[1] == want2.tobytes()
                    for r in results)
                and xc == ["collapsed"] * 7 + ["miss"]
                and counts == launches(stencil_fused=MAIN_REPS),
                f"net collapse: X-Cache {xc}, launches {counts}")
        cs.reset_launch_counts()
        status, body, hdr = http_post(fe.url, img2, MAIN_REPS)
        torch.cuda.synchronize()
        hit_counts = cs.launch_counts()
        require(status == 200 and hdr.get("X-Cache") == "hit"
                and body == want2.tobytes() and hit_counts == NO_LAUNCHES
                and checksum.stamp_matches(
                    hdr.get(checksum.RESULT_HEADER), body),
                f"net cache hit: {hdr.get('X-Cache')}, launches "
                f"{hit_counts}")
        out["cache"] = {"collapse_launches": counts, "x_cache": xc,
                        "hit_launches": hit_counts,
                        "stats": fe.cache.stats()}
        lap("cache")
    finally:
        fe.close()

    # 4. Two replicas on one card, every result witnessed, replica 1
    # corrupting its results (integrity.corrupt_result armed on it alone,
    # three times). Replica 0 is parked holding one request, so
    # least-outstanding placement sends the next requests to replica 1:
    # three witness mismatches quarantine it and drop the cache entries it
    # produced; replica 0, started, then serves exact bytes (the cache
    # misses); the prober (two K1 reps a probe against the NumPy golden)
    # re-admits replica 1 after --readmit-after clean probes.
    quarantine = {}
    faults.configure("integrity.corrupt_result:times=3")
    try:
        fe = net_frontend(devices=[dev, dev], start_workers=False,
                          witness_rate=1.0, warm_fleet=False,
                          result_cache_mb=256.0, quarantine_after=3,
                          readmit_after=2, probe_interval_s=1.0)
    finally:
        faults.clear()
    try:
        fe.fleet.replicas[0]._fault_corrupt_result = None
        fe.fleet.replicas[1].start()
        cs.reset_launch_counts()
        holder = np.random.default_rng(210).integers(
            0, 256, (MAIN_H, MAIN_W, MAIN_C), np.uint8)
        pool = concurrent.futures.ThreadPoolExecutor(1)
        held = pool.submit(http_post, fe.url, holder, MAIN_REPS)
        wait_until(lambda: fe.router.outstanding() == {0: 1, 1: 0},
                   what="the held request on replica 0")
        bad = [np.random.default_rng(220 + i).integers(
            0, 256, (MAIN_H, MAIN_W, MAIN_C), np.uint8) for i in range(3)]
        bad_want = [witness.device_witness(b, "gaussian", MAIN_REPS,
                                           device=dev) for b in bad]
        for b, w in zip(bad, bad_want):
            status, body, hdr = http_post(fe.url, b, MAIN_REPS)
            require(status == 200 and hdr["X-Replica"] == "1"
                    and hdr["X-Cache"] == "miss" and body != w.tobytes(),
                    f"net quarantine: a corrupted request came back "
                    f"{status} from replica {hdr.get('X-Replica')}")
        wait_until(lambda: fe.quarantine.is_quarantined(1),
                   what="replica 1 quarantined")
        st = http_json(fe.url, "/statusz")
        cstats = fe.cache.stats()
        c = fe.metrics_snapshot()["counters"]
        kept_out = (c["cache_invalidations_witness_mismatch_total"]
                    + c["result_cache_admission_refused_total"])
        require(list(st["quarantine"]["quarantined"]) == ["1"]
                and 1 not in cstats["replicas_indexed"] and kept_out == 3
                and c["fleet_integrity_witness_mismatch_total"] == 3,
                f"net quarantine: {st['quarantine']}, cache {cstats}, "
                f"{kept_out} entries dropped or refused")
        quarantine["quarantined"] = st["quarantine"]
        fe.fleet.replicas[0].start()
        status, body, hdr = held.result(timeout=300)
        pool.shutdown()
        require(status == 200 and hdr["X-Replica"] == "0"
                and body == witness.device_witness(
                    holder, "gaussian", MAIN_REPS, device=dev).tobytes(),
                "net quarantine: the held request")
        for b, w in zip(bad, bad_want):
            status, body, hdr = http_post(fe.url, b, MAIN_REPS)
            require(status == 200 and hdr["X-Replica"] == "0"
                    and hdr["X-Cache"] == "miss" and body == w.tobytes(),
                    f"net quarantine: after the trip, replica "
                    f"{hdr.get('X-Replica')} X-Cache {hdr.get('X-Cache')}")
        wait_until(lambda: not fe.quarantine.is_quarantined(1),
                   timeout=120, what="replica 1 re-admitted")
        st = http_json(fe.url, "/statusz")
        require(st["quarantine"]["quarantined"] == {},
                f"net re-admission: {st['quarantine']}")
        quarantine["readmitted"] = st["quarantine"]
    finally:
        fe.close()
    torch.cuda.synchronize()
    counts = cs.launch_counts()
    c = fe.metrics_snapshot()["counters"]
    probes = c["integrity_probes_total"]
    served = 1 + 3 + 3  # the held request, three corrupted, three exact
    require(c["integrity_readmits_total"] == 1
            and c.get("integrity_probe_failures_total", 0) == 0 and probes >= 2
            and counts == launches(stencil_fused=served * MAIN_REPS
                                   + probes * 2),
            f"net quarantine: launches {counts}, probes {probes}, {c}")
    quarantine.update(launches=counts, probes=probes,
                      probe_k1_launches=2 * probes,
                      quarantines=c["integrity_quarantines_total"],
                      readmits=c["integrity_readmits_total"])
    out["quarantine"] = quarantine
    lap("quarantine")

    # 6. The CLI in a fresh process: 64 closed-loop requests from 8
    # clients through loadgen.HttpTarget (its CRC check and the golden
    # check on; the golden checks frames up to 4096 pixels, none here,
    # so every result is also held against torch ops on the card), a
    # profiled run, then SIGTERM: a clean drain and rc 0.
    limages = loadgen.synth_requests(LOAD_REQUESTS, [(LOAD_H, LOAD_W)],
                                     [MAIN_C], 0)
    lwant = [witness.device_witness(m, "gaussian", MAIN_REPS, device=dev)
             for m in limages]
    index = {m[0, :16].tobytes(): i for i, m in enumerate(limages)}
    lap("load_references")
    err_log = NET_WORK / "cli_stderr.log"
    with open(err_log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_stencil_torch", "net", "--port",
             "0", "--backend", "pallas", "--drain-timeout", "60",
             "--flightrec-dir", str(NET_WORK / "cli_flightrec"),
             "--prof-dir", str(NET_WORK / "cli_profspool")],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT)
    lines = []

    def read_stdout():
        for ln in proc.stdout:
            lines.append(ln)

    reader = threading.Thread(target=read_stdout, daemon=True)
    reader.start()
    try:
        wait_until(lambda: lines or proc.poll() is not None, timeout=300,
                   what="the net CLI's serving line")
        require(lines and "net: serving on http://" in lines[0],
                f"net CLI: {lines} {err_log.read_text()[-2000:]}")
        url = lines[0].split()[3]
        def http_pass(label):
            """The 64 requests through loadgen.HttpTarget, every result
            then held against torch ops on the card."""
            target = Captured(loadgen.HttpTarget(url, verify="crc"))
            try:
                rep = loadgen.run(target, mode="closed",
                                  requests=LOAD_REQUESTS, concurrency=8,
                                  reps=MAIN_REPS, shapes=[(LOAD_H, LOAD_W)],
                                  channels=[MAIN_C], seed=0,
                                  verify="golden", per_request=True)
            finally:
                target.server.close()
            require(rep["completed"] == LOAD_REQUESTS
                    and rep["verify_failures_total"] == 0,
                    f"net CLI {label}: {rep['completed']} completed, "
                    f"{rep['verify_failures_total']} verify failures")
            err = 0
            for image, fut in target.taken:
                got = fut.result(timeout=0)
                i = index[image[0, :16].tobytes()]
                if not np.array_equal(got, lwant[i]):
                    err = max(err, int(np.abs(
                        got.astype(int) - lwant[i].astype(int)).max()))
            require(err == 0 and len(target.taken) == LOAD_REQUESTS,
                    f"net CLI {label}: max abs err {err}")
            lat = sorted(r["latency_s"] for r in rep["per_request"])
            return {"throughput_rps": rep["throughput_rps"],
                    "p50_s": nearest_rank(lat, 50),
                    "p99_s": nearest_rank(lat, 99),
                    "wall_seconds": rep["wall_seconds"],
                    "verified": len(target.taken), "max_abs_err": err}

        # A cold pass (a fresh server: programs built, pinned slots
        # allocated), then the same requests warm: the pass held beside
        # serve_path's warm in-process pass.
        cold = http_pass("cold pass")
        cli = dict(http_pass("warm pass"), cold=cold)
        err = max(cold["max_abs_err"], cli["max_abs_err"])
        lap("cli_load")
        # The profiled run: 8 clients posting the load's first 8 images in
        # a closed loop while the capture runs.
        with concurrent.futures.ThreadPoolExecutor(8) as clients:
            cli["profile"] = prof_capture(url, 1.0, lambda: list(
                clients.map(lambda m: http_post(url, m, MAIN_REPS),
                            limages[:8])))
        lap("cli_profile")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=30)
        require(rc == 0 and any("drained 1 replica(s) cleanly" in ln
                                for ln in lines),
                f"net CLI drain: rc {rc}, {lines[-3:]}, "
                f"{err_log.read_text()[-2000:]}")
        cli["rc"], cli["drain"] = rc, [ln.strip() for ln in lines
                                       if "drain" in ln]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    out["cli"] = cli
    print(f"net load cold (HTTP, CLI process): throughput_rps="
          f"{cold['throughput_rps']} p50_s={cold['p50_s']} p99_s="
          f"{cold['p99_s']} verified={cold['verified']}", flush=True)
    print(f"net load warm (HTTP, CLI process): throughput_rps="
          f"{cli['throughput_rps']} p50_s={cli['p50_s']} p99_s="
          f"{cli['p99_s']} idle_share={cli['profile']['idle_share']} "
          f"verified={cli['verified']}", flush=True)
    print(f"serve load warm (in process, serve_path): throughput_rps="
          f"{serve_warm['throughput_rps']} p50_s={serve_warm['p50_s']} "
          f"p99_s={serve_warm['p99_s']}", flush=True)
    lap("cli_drain")

    # 7. No fallback: with the kernel builds failing, a request answers a
    # typed 500 naming KernelBuildError; nothing launches and neither
    # torch-ops path is called.
    with failing_builds() as called, counted_padded_step() as steps:
        fe = net_frontend()
        try:
            cs.reset_launch_counts()
            status, body, _ = http_post(fe.url, mixed[-1],
                                        SERVE_CASES[-1][4])
            torch.cuda.synchronize()
            counts = cs.launch_counts()
        finally:
            fe.close()
    require(status == 500 and b"KernelBuildError" in body
            and counts == NO_LAUNCHES and not called and not steps,
            f"net no-fallback: {status} {body[:300]!r}, launches {counts}, "
            f"torch ops {len(called)} + {len(steps)}")
    out["no_fallback"] = {"status": status,
                          "body": body.decode(errors="replace").strip(),
                          "launches": counts}
    lap("no_fallback")
    k1 = {k: out[k]["launches"]["stencil_fused"]
          for k in ("one_request", "mixed_requests")}
    k1.update(cache_collapse=out["cache"]["collapse_launches"][
        "stencil_fused"], cache_hit=out["cache"]["hit_launches"][
        "stencil_fused"], quarantine=quarantine["launches"][
        "stencil_fused"], probes=quarantine["probe_k1_launches"])
    return {"phase": "net_path", "ok": True,
            "seconds": time.perf_counter() - t_phase, "laps": laps,
            "k1_launches": k1, "max_abs_err": max(err, 0), "runs": out,
            "http_vs_in_process": {
                "http_rps": cli["throughput_rps"],
                "in_process_warm_rps": serve_warm["throughput_rps"],
                "http_p99_s": cli["p99_s"],
                "in_process_warm_p99_s": serve_warm["p99_s"]}}


# -- federation and the control plane (phase fed_ctrl_path) -------------

FED_WORK = WORK / "fed"


def fed_frontend(members, **kw):
    """A started port ``FedFrontend`` on port 0 over ``members`` (URLs),
    its flight-recorder spool under build/chip_smoke/fed."""
    from tpu_stencil_torch.config import FedConfig
    from tpu_stencil_torch.fed import FedFrontend

    cfg = dict(port=0, members=tuple(members), heartbeat_interval_s=1.0,
               flightrec_dir=str(FED_WORK / "flightrec"))
    cfg.update(kw)
    return FedFrontend(FedConfig(**cfg)).start()


def compute_apps() -> str:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` as it prints
    it. In a container its pids are not this namespace's, so it is kept
    as an observation; the checks read the card's memory instead."""
    r = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else r.stderr.strip()


def card_memory_mib() -> int:
    """The card's memory in use, MiB, all processes together."""
    return int(nvidia_smi("memory.used").split()[0])


def maps_libcuda(pid: int) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda.so" in f.read()


def child_pids(ppid: int) -> list:
    """The pids whose parent is ``ppid`` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == ppid:
            out.append(int(d))
    return sorted(out)


def net_metric(url: str, name: str):
    """One counter of a net tier's ``/metrics`` text (None when absent)."""
    from tpu_stencil_torch.obs import exposition

    status, text = http_call(url, "/metrics")
    require(status == 200, f"{url}/metrics: {status}")
    return exposition.parse_text(
        text.decode(), prefix="tpu_stencil_net")["counters"].get(name)


class Proc:
    """A subprocess with its stdout lines collected on a thread (stderr to
    a file under build/chip_smoke/fed)."""

    def __init__(self, name: str, argv: list) -> None:
        import threading

        self.name = name
        self.err_path = FED_WORK / f"{name}_stderr.log"
        self.lines = []
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                         stderr=err, text=True, cwd=ROOT)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for ln in self.proc.stdout:
            self.lines.append(ln)

    def wait_line(self, needle: str, timeout: float = 300.0) -> str:
        wait_until(lambda: any(needle in ln for ln in self.lines)
                   or self.proc.poll() is not None, timeout=timeout,
                   what=f"{self.name}: {needle!r}")
        hits = [ln for ln in self.lines if needle in ln]
        require(hits, f"{self.name} exited rc {self.proc.poll()} before "
                f"{needle!r}: {self.lines[-5:]} "
                f"{self.err_path.read_text()[-2000:]}")
        return hits[0]

    def stop(self, sig, timeout: float = 180.0) -> int:
        self.proc.send_signal(sig)
        rc = self.proc.wait(timeout=timeout)
        self._reader.join(timeout=30)
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def phase_fed_ctrl_path(dev, net_cli: dict) -> dict:
    """Phase ``fed_ctrl_path``: the federation (``fed``) and the control
    plane (``ctrl``) over ``net`` members serving K1 on the card (see the
    module docstring)."""
    import concurrent.futures
    import signal
    import threading

    from tpu_stencil_torch.ctrl.actuator import SubprocessProvider
    from tpu_stencil_torch.fed import host_id_for
    from tpu_stencil_torch.integrity import checksum, witness
    from tpu_stencil_torch.net.http import STALL_ENV
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.resilience import faults
    from tpu_stencil_torch.serve import loadgen

    t_phase = time.perf_counter()
    FED_WORK.mkdir(parents=True, exist_ok=True)
    out, laps, t_lap = {}, {}, [t_phase]
    smi = nvidia_smi("name,power.limit")

    def lap(name):
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    def reset():
        cs.reset_launch_counts()

    def counted():
        torch.cuda.synchronize()
        return cs.launch_counts()

    def frame(seed):
        return np.random.default_rng(seed).integers(
            0, 256, (MAIN_H, MAIN_W, MAIN_C), np.uint8)

    def ref(img, name="gaussian", reps=MAIN_REPS):
        return witness.device_witness(img, name, reps, device=dev).tobytes()

    def members(n, **kw):
        kw = dict(dict(witness_rate=0.0, probe_interval_s=0.0,
                       result_cache_mb=256.0), **kw)
        return [net_frontend(devices=[dev], **kw) for _ in range(n)]

    def close_all(*fes):
        for fe in fes:
            fe.close()

    img = frame(300)
    want = ref(img)
    mixed = serve_images(SERVE_CASES)
    mixed_want = [ref(m, c[3], c[4]) for m, c in zip(mixed, SERVE_CASES)]
    lap("references")

    # 1. The fed in this process over two in-process members on [cuda:0]
    # each, hedge off (a cold member's first forward would outlive the
    # trigger and run K1 twice).
    m1, m2 = members(2)
    fed = fed_frontend([m1.url, m2.url], hedge=False)
    try:
        claim = {checksum.CRC_HEADER: str(checksum.crc32c(img))}
        with counted_padded_step() as steps:
            reset()
            status, body, hdr = http_post(fed.url, img, MAIN_REPS,
                                          headers=claim)
            counts = counted()
        require(status == 200 and body == want
                and checksum.stamp_matches(
                    hdr.get(checksum.RESULT_HEADER), body),
                f"fed POST: {status} {body[:300]!r}, bytes or stamp differ")
        require(counts == launches(stencil_fused=MAIN_REPS) and not steps,
                f"fed POST: launches {counts}, padded_step {len(steps)}")
        first_member = hdr["X-Fed-Member"]
        out["one_request"] = {"launches": counts, "member": first_member,
                              "stamp": hdr[checksum.RESULT_HEADER]}
        with counted_padded_step() as steps:
            reset()
            for i, (m, c) in enumerate(zip(mixed, SERVE_CASES)):
                status, body, _ = http_post(fed.url, m, c[4],
                                            filter_name=c[3])
                require(status == 200 and body == mixed_want[i],
                        f"fed mixed request {i} ({c}): {status}")
            counts = counted()
        require(counts == launches(stencil_fused=NET_MIXED_REPS)
                and not steps,
                f"fed mixed: launches {counts}, padded_step {len(steps)}")
        out["mixed_requests"] = {"launches": counts}
        # The same body again: digest affinity lands it on the same
        # member, whose result cache answers with no launch.
        reset()
        status, body, hdr = http_post(fed.url, img, MAIN_REPS)
        counts = counted()
        require(status == 200 and body == want
                and hdr["X-Fed-Member"] == first_member
                and hdr.get("X-Cache") == "hit" and counts == NO_LAUNCHES,
                f"fed affinity: member {hdr.get('X-Fed-Member')} (first "
                f"{first_member}), X-Cache {hdr.get('X-Cache')}, launches "
                f"{counts}")
        c = fed.registry.snapshot()["counters"]
        require(c["member_cache_hit_total"] == 1
                and c["affinity_routed_total"] >= 12,
                f"fed affinity counters {c}")
        out["affinity_hit"] = {"launches": counts,
                               "member": hdr["X-Fed-Member"]}
        lap("in_process")

        # 2a. net.corrupt_body on one member 200: the fed catches the bad
        # payload, reroutes, and the client gets exact bytes. Both legs
        # ran K1 (the corruption is on the wire).
        img2 = frame(301)
        want2 = ref(img2)
        faults.configure("net.corrupt_body:times=1")
        try:
            m1.fault_corrupt_body = faults.site("net.corrupt_body")
            m2.fault_corrupt_body = faults.site("net.corrupt_body")
            reset()
            status, body, hdr = http_post(fed.url, img2, MAIN_REPS)
            counts = counted()
        finally:
            faults.clear()
            m1.fault_corrupt_body = m2.fault_corrupt_body = None
        c = fed.registry.snapshot()["counters"]
        require(status == 200 and body == want2
                and c["forward_bad_payload_total"] == 1
                and c["reroutes_total"] == 1
                and counts == launches(stencil_fused=2 * MAIN_REPS),
                f"fed corrupt body: {status}, {c}, launches {counts}")
        out["corrupt_body"] = {"launches": counts,
                               "bad_payload": c["forward_bad_payload_total"],
                               "reroutes": c["reroutes_total"]}
        lap("corrupt_body")

        # 2b. A rolling drain of one member under 8 clients: no request
        # dropped, every answer exact.
        load = [frame(310 + i) for i in range(16)]
        load_want = [ref(m) for m in load]
        results = [None] * len(load)

        def post(i):
            results[i] = http_post(fed.url, load[i], MAIN_REPS)

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(post, i) for i in range(len(load))]
            wait_until(lambda: sum(r is not None for r in results) >= 4,
                       what="answers before the drain")
            drain = http_json(fed.url, f"/admin/drain?host="
                              f"{host_id_for(m1.url)}", post=True)
            for f in futs:
                f.result(timeout=300)
        bad = [i for i, r in enumerate(results)
               if r[0] != 200 or r[1] != load_want[i]]
        require(not bad and drain["member_response"]["draining"] is True
                and m1.admin_drain_requested.is_set(),
                f"fed member drain: requests {bad} not exact "
                f"({[results[i][0] for i in bad]}), {drain}")
        out["member_drain"] = {
            "requests": len(load), "dropped": 0,
            "members": sorted({r[2]["X-Fed-Member"] for r in results}),
            "draining_reroutes": fed.registry.counter(
                "draining_reroutes_total").value}
        lap("member_drain")
    finally:
        close_all(fed, m1, m2)

    # 2c. Hedging on, net.accept stalling the first request's member for
    # 3 s: the hedge leg on the other member answers exact bytes. The
    # stalled leg reaches its member after the stall (and runs K1 if its
    # body arrived whole): K1 = 40 x the legs that completed on a member.
    os.environ[STALL_ENV] = "3"
    faults.configure("net.accept:at=0:raise=TimeoutError")
    try:
        h1, h2 = members(2, result_cache_mb=0.0)
    finally:
        faults.clear()
    fed = fed_frontend([h1.url, h2.url], hedge=True, hedge_min_s=0.5)
    try:
        img3 = frame(302)
        want3 = ref(img3)
        c0 = [net_counter(h, "fleet_completed_total") for h in (h1, h2)]
        reset()
        status, body, hdr = http_post(fed.url, img3, MAIN_REPS)
        require(status == 200 and body == want3
                and hdr["X-Fed-Hedged"] == "1",
                f"fed hedge: {status}, hedged {hdr.get('X-Fed-Hedged')}")
        # The stalled handler wakes and reads what reached it of its body
        # (a whole one runs K1); then nothing is left in flight.
        time.sleep(3 + 1.0)
        wait_until(lambda: all(sum(h.router.outstanding().values()) == 0
                               for h in (h1, h2)), timeout=120,
                   what="both hedge legs settled on their members")
        counts = counted()
        legs = int(sum(net_counter(h, "fleet_completed_total") - c
                       for h, c in zip((h1, h2), c0)))
        c = fed.registry.snapshot()["counters"]
        require(c["hedges_total"] == 1 and c["hedge_wins_total"] == 1
                and legs in (1, 2)
                and counts == launches(stencil_fused=legs * MAIN_REPS),
                f"fed hedge: {c}, legs {legs}, launches {counts}")
        out["hedge"] = {"launches": counts, "legs_on_members": legs,
                        "hedges": c["hedges_total"],
                        "hedge_wins": c["hedge_wins_total"],
                        "hedge_cancelled": c["hedge_cancelled_total"]}
    finally:
        os.environ.pop(STALL_ENV, None)
        close_all(fed, h1, h2)
    lap("hedge")

    # 3. Fresh processes: the fed CLI, then the ctrl CLI launching two
    # members on the card (no --member-platform), the 64-request load
    # through the fed, kill -9 of a member under load, the replacement,
    # SIGTERM of the ctrl and of the fed.
    limages = loadgen.synth_requests(LOAD_REQUESTS, [(LOAD_H, LOAD_W)],
                                     [MAIN_C], 0)
    lwant = [witness.device_witness(m, "gaussian", MAIN_REPS, device=dev)
             for m in limages]
    index = {m[0, :16].tobytes(): i for i, m in enumerate(limages)}
    lap("load_references")
    # A CUDA context costs hundreds of MiB of the card: the card's memory
    # in use before and after the fed starts says whether it made one.
    torch.cuda.synchronize()
    mem0 = card_memory_mib()
    fedp = Proc("fed_cli", [
        sys.executable, "-m", "tpu_stencil_torch", "fed", "--port", "0",
        "--flightrec-dir", str(FED_WORK / "cli_flightrec"),
        "--heartbeat-interval", "0.5", "--drain-timeout", "120"])
    ctrl = None
    cli = {}
    try:
        url = fedp.wait_line("fed: serving on http://", 120).split()[3]
        for path in ("/healthz", "/statusz", "/metrics", "/debug/capacity"):
            require(http_call(url, path)[0] == 200, f"fed {path}")
        mem1 = card_memory_mib()
        cli["card_memory_mib"] = {"before_fed": mem0, "fed_up": mem1}
        cli["fed_maps_libcuda"] = maps_libcuda(fedp.proc.pid)
        require(mem1 - mem0 < 256, f"the fed process took {mem1 - mem0} "
                f"MiB of the card: a CUDA context")
        ctrl = Proc("ctrl_cli", [
            sys.executable, "-m", "tpu_stencil_torch", "ctrl", "--fed", url,
            "--min-hosts", "2", "--max-hosts", "3", "--poll-interval", "0.5",
            "--launch-timeout", "300", "--drain-timeout", "120"])
        wait_until(lambda: sum(
            m["state"] == "healthy"
            for m in http_json(url, "/statusz")["members"]) == 2,
            timeout=300, what="the ctrl's two members registered")
        lap("ctrl_up")

        def fed_pass(label):
            target = Captured(loadgen.HttpTarget(url, verify="crc"))
            try:
                rep = loadgen.run(target, mode="closed",
                                  requests=LOAD_REQUESTS, concurrency=8,
                                  reps=MAIN_REPS, shapes=[(LOAD_H, LOAD_W)],
                                  channels=[MAIN_C], seed=0,
                                  verify="golden", per_request=True)
            finally:
                target.server.close()
            require(rep["completed"] == LOAD_REQUESTS
                    and rep["verify_failures_total"] == 0,
                    f"fed CLI {label}: {rep['completed']} completed, "
                    f"{rep['verify_failures_total']} verify failures")
            err = 0
            for image, fut in target.taken:
                got = fut.result(timeout=0)
                i = index[image[0, :16].tobytes()]
                if not np.array_equal(got, lwant[i]):
                    err = max(err, int(np.abs(
                        got.astype(int) - lwant[i].astype(int)).max()))
            require(err == 0 and len(target.taken) == LOAD_REQUESTS,
                    f"fed CLI {label}: max abs err {err}")
            lat = sorted(r["latency_s"] for r in rep["per_request"])
            return {"throughput_rps": rep["throughput_rps"],
                    "p50_s": nearest_rank(lat, 50),
                    "p99_s": nearest_rank(lat, 99),
                    "wall_seconds": rep["wall_seconds"],
                    "verified": len(target.taken), "max_abs_err": err}

        cold = fed_pass("cold pass")
        warm = fed_pass("warm pass")
        fc = http_json(url, "/statusz")["net"]["counters"]
        cli["load"] = {"cold": cold, "warm": warm,
                       "hedges": fc.get("hedges_total", 0),
                       "reroutes": fc.get("reroutes_total", 0),
                       "breaker_opens": fc.get("breaker_open_total", 0)}
        lap("fed_load")

        # Each member holds a CUDA context (the planner may have scaled
        # out to a third under the load); the fed still holds none.
        member_pids = child_pids(ctrl.proc.pid)
        require(len(member_pids) >= 2, f"ctrl children {member_pids}")
        require(all(maps_libcuda(p) for p in member_pids),
                f"members without the CUDA driver mapped: {member_pids}")
        mem2 = card_memory_mib()
        cli["card_memory_mib"].update(
            members_up=mem2, members=len(member_pids),
            per_member=(mem2 - mem1) / len(member_pids))
        cli["compute_apps"] = compute_apps()

        # kill -9 one member under load: every request exact or typed.
        before = {m["host_id"] for m in http_json(url, "/statusz")["members"]
                  if m["state"] == "healthy"}
        answers = []
        lock = threading.Lock()

        def client(k):
            for j in range(4):
                i = (8 * j + k) % LOAD_REQUESTS
                status, body, _h = http_post(url, limages[i], MAIN_REPS)
                with lock:
                    answers.append((i, status, body))

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(client, k) for k in range(8)]
            wait_until(lambda: len(answers) >= 6, timeout=120,
                       what="answers before the kill")
            victim = member_pids[0]
            os.kill(victim, signal.SIGKILL)
            for f in futs:
                f.result(timeout=300)
        typed = {429, 503, 504}
        wrong = [(i, s) for i, s, b in answers
                 if not (s == 200 and b == lwant[i].tobytes()
                         or s in typed and b"trace_id" in b)]
        require(len(answers) == 32 and not wrong,
                f"fed kill -9: {len(answers)} answers, wrong {wrong[:5]}")
        ctrl.wait_line("died without a drain", 120)
        ctrl.wait_line("ctrl: replace x1", 120)
        wait_until(lambda: {
            m["host_id"] for m in http_json(url, "/statusz")["members"]
            if m["state"] == "healthy"} - before, timeout=300,
            what="the replacement registered")
        members_now = http_json(url, "/statusz")["members"]
        new = {m["host_id"] for m in members_now
               if m["state"] == "healthy"} - before
        served = None
        for seed in range(400, 440):
            probe = frame(seed)
            status, body, hdr = http_post(url, probe, MAIN_REPS)
            require(status == 200 and body == ref(probe),
                    f"fed after the replacement: {status}")
            if hdr["X-Fed-Member"] in new:
                served = hdr["X-Fed-Member"]
                break
        require(served is not None, f"the replacement {new} never served")
        cli["kill9"] = {
            "answers": len(answers),
            "statuses": {str(s): sum(1 for _i, t, _b in answers if t == s)
                         for s in sorted({t for _i, t, _b in answers})},
            "evicted": [m["host_id"] for m in members_now
                        if m["state"] == "evicted"],
            "replacement": served,
            "ctrl_lines": [ln.strip() for ln in ctrl.lines
                           if "died" in ln or "replace" in ln]}
        lap("kill9")

        # SIGTERM the ctrl: every owned member drains, then exits rc 0.
        owned = child_pids(ctrl.proc.pid)
        rc = ctrl.stop(signal.SIGTERM, 300)
        require(rc == 0 and any("owned host(s) cleanly" in ln
                                for ln in ctrl.lines),
                f"ctrl SIGTERM: rc {rc}, {ctrl.lines[-4:]}, "
                f"{ctrl.err_path.read_text()[-2000:]}")
        require(not any(os.path.exists(f"/proc/{p}") for p in owned),
                f"members still running after the ctrl's drain: {owned}")
        cli["ctrl_rc"] = rc
        cli["ctrl_drain"] = [ln.strip() for ln in ctrl.lines
                             if "drain" in ln]
        rc = fedp.stop(signal.SIGTERM, 120)
        require(rc == 0, f"fed SIGTERM: rc {rc}, {fedp.lines[-3:]}")
        cli["fed_rc"] = rc
        lap("sigterm")
    finally:
        if ctrl is not None:
            for p in child_pids(ctrl.proc.pid):
                try:
                    os.kill(p, signal.SIGKILL)
                except OSError:
                    pass
            ctrl.kill()
        fedp.kill()
    out["cli"] = cli
    w = cli["load"]["warm"]
    print(f"fed load warm (HTTP through the fed CLI, "
          f"{cli['card_memory_mib']['members']} ctrl members on one "
          f"card, {smi}): throughput_rps={w['throughput_rps']} "
          f"p50_s={w['p50_s']} p99_s={w['p99_s']} hedges="
          f"{cli['load']['hedges']}", flush=True)
    print(f"net load warm (HTTP, net CLI, net_path, {smi}): throughput_rps="
          f"{net_cli['throughput_rps']} p50_s={net_cli['p50_s']} "
          f"p99_s={net_cli['p99_s']}", flush=True)

    # 4. Warm start on the card: a warm in-process member serves the
    # main frame; a joiner launched --warm-from it answers its first
    # request from a warm program cache; a cold joiner does not.
    warm = net_frontend(devices=[dev], witness_rate=0.0)
    try:
        status, warm_body, _h = http_post(warm.url, img, MAIN_REPS)
        require(status == 200 and warm_body == want, "warm member")
        env = http_json(warm.url, "/admin/warmstate")
        require(env["platform"] == dev.type and env["entries"]
                and all(set(e) == {"key"} for e in env["entries"]),
                f"warm envelope {env}")
        firsts = {}
        for label, warm_from in (("warm", warm.url), ("cold", None)):
            prov = SubprocessProvider(
                warm_from=warm_from, launch_timeout_s=300,
                drain_timeout_s=120, extra_args=("--backend", "pallas"))
            handle = prov.launch()
            try:
                t0 = time.perf_counter()
                status, body, _h = http_post(handle.url, img, MAIN_REPS)
                first_s = time.perf_counter() - t0
                require(status == 200 and body == warm_body,
                        f"{label} joiner's first request: {status}")
                firsts[label] = {
                    "first_request_s": first_s,
                    "imported": net_metric(
                        handle.url, "fleet_ctrl_warmstart_imported_total"),
                    "fallbacks": net_metric(
                        handle.url, "fleet_ctrl_warmstart_fallbacks_total"),
                    "cache_misses": net_metric(handle.url,
                                           "fleet_cache_misses_total"),
                    "cache_hits": net_metric(handle.url,
                                         "fleet_cache_hits_total")}
                require(prov.stop(handle, 120), f"{label} joiner drain")
                handle = None
            finally:
                if handle is not None:
                    prov.kill(handle)
        f = firsts["warm"]
        require(f["imported"] >= 1 and not f["fallbacks"]
                and f["cache_misses"] == 0 and f["cache_hits"] >= 1,
                f"warm joiner {f}")
        require(firsts["cold"]["cache_misses"] == 1, f"cold {firsts}")
        # An envelope whose kernel fingerprint was altered: every entry
        # degrades as version_skew, and the joiner serves exact bytes.
        n = len(env["entries"])
        joiner = net_frontend(devices=[dev], witness_rate=0.0)
        try:
            summary = joiner.fleet.warmstate_import(
                dict(env, kernels="0" * 12))
            status, body, _h = http_post(joiner.url, img, MAIN_REPS)
            c = joiner.metrics_snapshot()["counters"]
            require(summary["imported"] == 0
                    and summary["replicas"][0]["reasons"]
                    == {"version_skew": n}
                    and c["fleet_ctrl_warmstart_fallbacks_total"] == n
                    and status == 200 and body == want
                    and c["fleet_cache_misses_total"] == 1,
                    f"skewed envelope: {summary}, {status}, {c}")
        finally:
            joiner.close()
        out["warmstart"] = dict(firsts, skewed={
            "entries": n, "reasons": summary["replicas"][0]["reasons"]})
    finally:
        warm.close()
    print(f"warm start first request ({smi}): warm joiner "
          f"first_request_s={firsts['warm']['first_request_s']} "
          f"(imported {firsts['warm']['imported']}), cold joiner "
          f"first_request_s={firsts['cold']['first_request_s']}",
          flush=True)
    lap("warmstart")

    # 5. No fallback: the member's kernels cannot build, so it answers a
    # typed 500 naming KernelBuildError; the fed carries it as the JAX
    # fed carries a member 5xx (breaker charged, reroute, then 503
    # HostUnavailable naming http_500 and the member's error). Nothing
    # launches and neither torch-ops path runs.
    with failing_builds() as called, counted_padded_step() as steps:
        (m,) = members(1, result_cache_mb=0.0)
        fed = fed_frontend([m.url], hedge=False, reoffer_s=0.0)
        try:
            reset()
            status, body, _h = http_post(fed.url, mixed[-1],
                                         SERVE_CASES[-1][4])
            counts = counted()
            member_500 = net_counter(m, "responses_5xx_total")
            fed_5xx = fed.registry.counter("forward_http_5xx_total").value
        finally:
            close_all(fed, m)
    require(status == 503 and b"HostUnavailable" in body
            and b"http_500 (KernelBuildError)" in body
            and member_500 == 1 and fed_5xx == 1
            and counts == NO_LAUNCHES and not called and not steps,
            f"fed no-fallback: {status} {body[:300]!r}, member 5xx "
            f"{member_500}, launches {counts}, torch ops {len(called)} + "
            f"{len(steps)}")
    out["no_fallback"] = {"status": status, "member_status": 500,
                          "body": body.decode(errors="replace").strip(),
                          "launches": counts}
    lap("no_fallback")
    k1 = {k: out[k]["launches"]["stencil_fused"]
          for k in ("one_request", "mixed_requests", "affinity_hit",
                    "corrupt_body", "hedge", "no_fallback")}
    return {"phase": "fed_ctrl_path", "ok": True, "card": smi,
            "seconds": time.perf_counter() - t_phase, "laps": laps,
            "k1_launches": k1, "runs": out,
            "max_abs_err": max(cli["load"]["cold"]["max_abs_err"],
                               cli["load"]["warm"]["max_abs_err"]),
            "fed_vs_net_http": {
                "fed_rps": w["throughput_rps"], "fed_p50_s": w["p50_s"],
                "fed_p99_s": w["p99_s"],
                "net_rps": net_cli["throughput_rps"],
                "net_p50_s": net_cli["p50_s"],
                "net_p99_s": net_cli["p99_s"]}}


def phase_times(dev) -> dict:
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    g = plan_of("gaussian")
    img = seeded((MAIN_H, MAIN_W, MAIN_C), 7, dev)
    x2 = img.reshape(MAIN_H, -1)
    n = MAIN_REPS
    r = {
        "stencil_fused_ms": time_ms(lambda: cs.iterate(img, n, g), dev) / n,
        "stencil_resident_ms": time_ms(
            lambda: cs.iterate(img, n, g, schedule="deep"), dev) / n,
        "plain_ms": time_ms(
            lambda: cs.stencil_fused_plain(x2, g, MAIN_C, n), dev) / n,
        "torch_ops_ms": time_ms(lambda: lowering.iterate(img, n, g), dev) / n,
    }
    # K3 alone: the one ext tile of a 1x1 mesh at fuse 8, per rep.
    fz = cs.DEFAULT_FUSE
    ext = ext_tile(img, 0, 0, (1, 1), fz * g.halo)
    glob = (MAIN_H, MAIN_W * MAIN_C)
    r["stencil_valid_ms"] = time_ms(
        lambda: cs.valid_fused(ext, g, fz, MAIN_C, 0, 0, glob), dev) / fz
    r["stencil_valid_plain_ms"] = time_ms(
        lambda: cs.stencil_valid_plain(ext, g, MAIN_C, fz, 0, 0, glob),
        dev) / fz
    r["stencil_valid_bound_ms"], r["stencil_valid_bound_by"] = (
        bound_ms_per_rep(g, MAIN_H * MAIN_W * MAIN_C, fz,
                         n_bytes=ext.numel() + MAIN_H * MAIN_W * MAIN_C))
    # The whole 2x2 sharded runner on one card: K3 plus the exchange.
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    runner = ShardedRunner(
        IteratedConv2D("gaussian", backend="pallas", device=dev),
        (MAIN_H, MAIN_W), MAIN_C, mesh_shape=(2, 2), devices=[dev] * 4)
    tiles = runner.put(img.cpu().numpy())
    # The same runner under `auto` (the default backend), whose verdict
    # phase autotune_path left in the cache: it must not chunk shallower
    # than `pallas` at its defaults, since every chunk costs an exchange,
    # and the two windows are timed taking turns.
    tuned = ShardedRunner(
        IteratedConv2D("gaussian", backend="auto", device=dev),
        (MAIN_H, MAIN_W), MAIN_C, mesh_shape=(2, 2), devices=[dev] * 4)
    require(tuned.backend == "pallas" and tuned.fuse >= runner.fuse,
            f"sharded auto runs {tuned.backend} at fuse {tuned.fuse}, pallas "
            f"at its defaults fuse {runner.fuse}")
    both = interleaved_ms({"pallas": lambda: runner.run(tiles, n),
                           "auto": lambda: tuned.run(tiles, n)}, dev)
    r["sharded_2x2_ms"] = both["pallas"] / n
    r["sharded_2x2_auto_ms"] = both["auto"] / n
    r["sharded_2x2_auto_fuse"] = tuned.fuse
    require(both["auto"] <= 1.5 * both["pallas"],
            f"sharded 2x2 under auto takes {both['auto']} ms, under pallas "
            f"{both['pallas']} ms")
    r["library_conv2d_ms"] = library_conv2d_ms(img, g, dev)
    bound, by = bound_ms_per_rep(g, MAIN_H * MAIN_W * MAIN_C, n)
    r["bound_ms"], r["bound_by"] = bound, by
    # L2: the lab's `current` body through the same rep loop, and its
    # plain version (K1's function).
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.runtime import roofline
    from tpu_stencil_torch.tools import op_cost

    cur = lab.parse_variant("current")
    r["stencil_lab_ms"] = time_ms(
        lambda: lab.lab_iterate(img, n, g, cur), dev) / n
    r["stencil_lab_plain_ms"] = time_ms(
        lambda: lab.stencil_lab_plain(x2, g, MAIN_C, n, cur), dev) / n
    # L1: one launch of add_i32 with a chain of 8 on the tool's tiles,
    # beside its bound (the stored rows read once and written once,
    # against one int32 add per stored element and operation).
    ib, b, wc, grid = op_cost.tile_for("add_i32")
    xt = seeded((grid * ib, wc), 9, dev)
    ot = torch.empty((grid * b, wc), dtype=torch.uint8, device=dev)
    r["op_chain_ms"] = time_ms(
        lambda: lab.op_chain(xt, "add_i32", 8, ib, b, out=ot), dev)
    r["op_chain_plain_ms"] = time_ms(
        lambda: lab.op_chain_plain(xt, "add_i32", 8, ib, b), dev)
    r["op_chain_bound_ms"], r["op_chain_bound_by"] = (
        roofline.op_chain_bound_ms("add_i32", 8, ib, b, wc, grid))
    r["op_chain_unit"] = (f"ms per launch, add_i32 chain of 8, {grid} tiles "
                          f"of {ib}x{wc}, {b} rows of each stored")
    # The band product on tensor cores: one launch of mxu_rows_bf16 (a
    # chain of 8), and as its yardstick one batched bf16 torch.matmul of
    # the band matrix by the tiles' first 144 rows (one operation; timed
    # only, the port never calls it).
    ib, b, wc, grid = op_cost.tile_for("mxu_rows_bf16")
    xm = seeded((grid * ib, wc), 10, dev)
    om = torch.empty((grid * b, wc), dtype=torch.uint8, device=dev)
    r["mxu_rows_bf16_ms"] = time_ms(
        lambda: lab.op_chain(xm, "mxu_rows_bf16", 8, ib, b, out=om), dev)
    band = lab.band_matrix().to(dev, torch.bfloat16)
    xb = xm.reshape(grid, ib, wc)[:, :lab.BAND].to(torch.bfloat16)
    r["mxu_rows_bf16_library_ms"] = time_ms(lambda: torch.matmul(band, xb),
                                            dev)
    r["mxu_rows_bf16_bound_ms"], _ = roofline.op_chain_bound_ms(
        "mxu_rows_bf16", 8, ib, b, wc, grid)
    r["mxu_rows_bf16_unit"] = (f"ms per launch, chain of 8, {grid} tiles of "
                               f"{ib}x{wc}; library: one operation")
    r["resident_ab"] = resident_ab(img, dev)
    r["tile_ab"] = tile_ab(img, dev)
    r["clocks_power"] = nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")
    return {"phase": "times", "unit": "ms per rep",
            "shape": [MAIN_H, MAIN_W, MAIN_C], "reps": n, "filter": "gaussian",
            **r}


def tile_ab(img: torch.Tensor, dev) -> dict:
    """The tile redesign's A/B in this call, every set taking turns (ms per
    rep x40, median of 7, L2 flushed): K1 and K3's ext tile (fuse 8)
    against the lab's ``current`` (K1 before the redesign) and ``swar``
    on gaussian; K1 against ``current`` per body filter, and on edge K1's
    direct body against the shared tile's int32 body; 4 frames as one
    tall launch against 1 frame (per frame and rep); and each body's
    resident blocks per SM at 32x8."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lab

    n = MAIN_REPS
    x2 = img.reshape(MAIN_H, -1)
    cur, swar = lab.parse_variant("current"), lab.parse_variant("swar")
    out = {}
    for name in ("gaussian", "gaussian5", "gaussian7", "box", "edge"):
        p = plan_of(name)
        fns = {"k1": lambda p=p: cs.iterate(img, n, p),
               "k2": lambda p=p: cs.iterate(img, n, p, schedule="deep"),
               "plain": lambda p=p: cs.stencil_fused_plain(x2, p, MAIN_C, n)}
        if name == "gaussian":
            fz = cs.DEFAULT_FUSE
            ext = ext_tile(img, 0, 0, (1, 1), fz * p.halo)
            glob = (MAIN_H, MAIN_W * MAIN_C)
            # the ext tile's 8 reps, scaled to the 40 of the other rows
            fns["k3_ext"] = lambda: [cs.valid_fused(ext, p, fz, MAIN_C, 0, 0,
                                                    glob)
                                     for _ in range(n // fz)]
        if name == "edge":
            # K1's direct body against the shared tile's int32 body, which
            # a forced tile height runs
            fns["k1_int32"] = lambda p=p: cs.iterate(
                img, n, p, block_h=cs.DEFAULT_BLOCK_H)
        if lab.variant_supported(cur, p):
            fns["lab_current"] = lambda p=p: lab.lab_iterate(img, n, p, cur)
        if lab.variant_supported(swar, p):
            fns["lab_swar"] = lambda p=p: lab.lab_iterate(img, n, p, swar)
        row = {k: v / n for k, v in interleaved_ms(fns, dev).items()}
        row["k2_over_k1"] = row["k2"] / row["k1"]
        if "k1_int32" in row:
            row["k1_over_int32"] = row["k1"] / row["k1_int32"]
        if "lab_current" in row:
            row["k1_over_current"] = row["k1"] / row["lab_current"]
        if "k3_ext" in row:
            row["k3_over_current"] = row["k3_ext"] / row["lab_current"]
        row["library_conv2d"] = library_conv2d_ms(img, p, dev)
        row["bound"], row["bound_by"] = bound_ms_per_rep(
            p, MAIN_H * MAIN_W * MAIN_C, n)
        out[name] = {"body": cs.tile_body(p), "k1_body": cs.fused_body(p),
                     **row}
    g = plan_of("gaussian")
    frames = seeded((4, MAIN_H, MAIN_W, MAIN_C), 14, dev)
    both = interleaved_ms({"one": lambda: cs.iterate(img, n, g),
                           "four": lambda: cs.iterate_frames(frames, n, g)},
                          dev)
    out["frames"] = {"one_frame_ms": both["one"] / n,
                     "four_frames_per_frame_ms": both["four"] / (4 * n),
                     "ratio": both["four"] / (4 * both["one"])}
    occ = {}
    for body, name in (("swar", "gaussian"), ("acc16", "gaussian7"),
                       ("int32", "edge")):
        p = plan_of(name)
        shared = cs.rep_loop(p, MAIN_H, MAIN_W * MAIN_C, MAIN_C,
                             cs.DEFAULT_BLOCK_H, None, None, dev).fused
        bh, fz = shared.tile_h, shared.fuse
        occ[body] = {"filter": name, "block_h": bh, "fuse": fz,
                     "smem_bytes": cs.kernel_smem_bytes("stencil_fused", p,
                                                        bh, fz, MAIN_C),
                     "k1_blocks_per_sm": cs.blocks_per_sm(
                         "stencil_fused", p, bh, fz, MAIN_C),
                     "k3_blocks_per_sm": cs.blocks_per_sm(
                         "stencil_valid", p, bh, fz, MAIN_C)}
        require(occ[body]["smem_bytes"] == cs.tile_smem_bytes(p, bh, fz,
                                                              MAIN_C),
                f"{body}: the host's shared-memory model disagrees with the "
                "library's")
    out["blocks_per_sm"] = occ
    return out


def tile_instances(log: str) -> dict:
    """Registers and spills of every (filter size, body) instance of a tile
    kernel, from its ``-Xptxas -v`` build log: ``"k3 swar" -> {...}``
    (k0: the filter size read at run time), K1's register body by channel
    count: ``"k3 regs C3"``."""
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs

    return {" ".join([f"k{key[0]}", cs.K1_BODIES[key[1]]]
                     + [f"C{c}" for c in key[2:]]): v
            for key, v in _build.ptxas_instances(log).items()}


def op_chain_sass(lib: str) -> dict:
    """Opcode counts of every ``op_chain_kernel<case, N>`` instance in the
    SASS of the L1 library ``lib`` (``cuobjdump -sass``): (case id, N) ->
    {opcode: count}, the opcode without its modifiers."""
    import re
    import shutil
    from collections import Counter

    from tpu_stencil_torch.ops import _build

    exe = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).with_name("cuobjdump"))
    sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    inst, key = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = re.search(r"op_chain_kernelILi(\d+)ELi(\d+)E", ln)
            key = (int(m.group(1)), int(m.group(2))) if m else None
            if key:
                inst[key] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", ln)
        if key and m:
            toks = m.group(1).split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if toks:
                inst[key][toks[0].split(".")[0]] += 1
    return inst


def check_op_chain_sass(inst: dict) -> dict:
    """The band products run on tensor cores (``HMMA`` in every
    ``mxu_rows_bf16`` instance, ``IMMA`` in every ``mxu_rows_i8`` one, and
    no ``FFMA`` or ``IDP`` (dp4a) loop in either), and no chain held in
    registers is folded: from a chain of 8 to 16 an instance grows by at
    least one instruction per value a thread holds and operation."""
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import op_cost

    out = {}
    for case, (cid, _) in lab.CASES.items():
        counts = {n: inst.get((cid, n)) for n in lab.BUILT_N_OPS}
        require(all(counts.values()),
                f"op_chain SASS: an instance of {case} is missing")
        total = {n: sum(c.values()) for n, c in counts.items()}
        if case.startswith("mxu_rows"):
            mma = "HMMA" if case == "mxu_rows_bf16" else "IMMA"
            for n, c in counts.items():
                require(c[mma] > 0 and not c["FFMA"] and not c["IDP"],
                        f"{case}<{n}>: {mma} {c[mma]}, FFMA {c['FFMA']}, "
                        f"IDP {c['IDP']} in its SASS")
            out[case] = {"instructions": total, mma: counts[8][mma]}
            continue
        ib, b, _, _ = op_cost.tile_for(case)
        form = lab.op_chain_form(case, ib, b)
        held = {"flat": {"vadd4_u8": 4, "vadd2_i16": 8}.get(case, 16),
                "cols": lab.OP_REG_BLOCK, "strips": lab.OP_STRIP,
                "lanes": lab.OP_STRIP}.get(form)
        if held:
            require(total[16] - total[8] >= 8 * held
                    and total[8] - total[3] >= 5 * held,
                    f"{case}: {total} instructions at chains 3, 8, 16: a "
                    "chain held in registers was folded")
        out[case] = {"instructions": total}
    return out


# The job cells' shapes and filters: (label, (H, W[, C]), filter).
PLACE_CELLS = (("rgb2520", (2520, 1920, 3), "gaussian"),
               ("grey5040", (5040, 1920), "gaussian"),
               ("rgb5040edge", (5040, 1920, 3), "edge"))
PLACE_REPS, PLACE_RING, PLACE_CALLS = 100, 4, 8
# Profiled (blocking, overlapped) pairs a cell. Grey's 0.22 ms copy is
# about as long as the host's prelude to the first launch, so a single
# call's launch lands after the copy about one time in four.
PLACE_PROFILED = 4


def copy_then_k1(prof) -> list:
    """Per host-to-card copy of a capture, in order, on the device's
    clock: the copy's µs and the µs from its end to the start of the
    first ``stencil_fused*`` kernel after it (a launch queued behind the
    copy starts on its heels; one issued after it waits for the host)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    copies = sorted((e.start_ns(), e.end_ns()) for e in events
                    if "HtoD" in e.name())
    k1 = sorted(e.start_ns() for e in events if K1_NAME in e.name())
    return [{"copy_us": (c1 - c0) / 1e3,
             "copy_end_to_k1_start_us": (next(k for k in k1 if k >= c0)
                                         - c1) / 1e3}
            for c0, c1 in copies]


def phase_place_overlap(dev) -> dict:
    """``IteratedConv2D.forward`` on a ring of pinned inputs (the job
    cells' placement, overlapped: the copy non-blocking, K1's launches
    behind it, its event waited for before return) at each job cell's
    shape and filter, x100: each input overwritten with 0xFF as soon as
    its call returns, every output byte-equal to the blocking placement's
    (a pageable input) and to the plain version's; K1's launches and reps
    by body alike on both paths; ``placement_counts`` moving by one a
    call on each path; at each call's first K1 launch, whether the
    stream still runs the copy (``stream.query()``: never on the
    blocking path). Then profiled pairs (the blocking placement of a
    pinned input, then the overlapped one), four times: an overlapped
    call's first K1 launch is issued while its copy runs, and each
    overlapped call's first K1 kernel follows its copy closer than the
    blocking call's. Then ms a job, the
    two placements of one pinned ring taking turns, each job fetched into
    a pinned buffer and waited for (the job cells' loop)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    stream = torch.cuda.current_stream(dev)
    armed = []
    launch_k1 = cs._launch_k1

    def first_launch(*args, **kw):  # the copy in flight at a first launch?
        if armed:
            probe.in_flight.append(not stream.query())
            armed.clear()
        return launch_k1(*args, **kw)

    def probe(fn, x):
        armed.append(True)
        return fn(x)

    probe.in_flight = []
    out = {}
    cs._launch_k1 = first_launch
    try:
        for label, shape, name in PLACE_CELLS:
            out[label] = place_overlap_cell(dev, label, shape, name, probe)
    finally:
        cs._launch_k1 = launch_k1
    missed = [label for label, r in out.items() if not any(
        d["copy_in_flight"] for d in r["profiled"]["overlapped"])]
    require(not missed, f"place_overlap {missed}: every profiled "
            f"overlapped call issued its first K1 launch after its copy "
            f"ended: {out}")
    return {"phase": "place_overlap", "ok": True, "cells": out}


MESH_REPLAY_SHAPE, MESH_REPLAY_REPS, MESH_REPLAY_CALLS = (5040, 1920), 100, 8


def phase_mesh_replay() -> dict:
    """``ShardedRunner.run_host`` replaying its captured job (the mesh
    cell's path) against the eager chunks; see the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import halo_fill
    from tpu_stencil_torch.parallel import halo
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    halo_fill.launch.launches = 0
    fills = halo.fill_counts()["fills"]
    n = torch.cuda.device_count()
    devices = [torch.device("cuda", k % n) for k in range(4)]
    h, w = MESH_REPLAY_SHAPE
    reps = MESH_REPLAY_REPS
    model = IteratedConv2D("gaussian", backend="pallas", device=devices[0])
    runner = ShardedRunner(model, (h, w), 1, mesh_shape=(2, 2),
                           devices=devices)
    runner.prepare()
    rng = np.random.default_rng(26)
    src = [rng.integers(0, 256, (h, w), np.uint8) for _ in range(4)]
    ring = [runner.host_tiles(a, pin=True) for a in src]
    outs = [runner.host_tiles(pin=True) for _ in range(4)]
    require(runner._replayable(ring[0]),
            f"mesh_replay: the runner does not replay on {devices}")
    eager = [runner.fetch(runner.run(runner.put(a), reps)) for a in src]
    k1 = [cs.iterate(torch.from_numpy(a).to(devices[0]), reps,
                     model.plan).cpu().numpy() for a in src]
    require(all(np.array_equal(e, k) for e, k in zip(eager, k1)),
            "mesh_replay: the eager chunks disagree with K1")

    def stitched(grid):
        return np.concatenate([np.concatenate([t.numpy() for t in row], 1)
                               for row in grid], 0)[:h, :w]

    t0 = time.perf_counter()
    runner.fetch_into(runner.run_host(ring[0], reps), outs[0])
    capture_s = time.perf_counter() - t0
    rep = runner._replays[reps]
    errs = []
    for k in range(MESH_REPLAY_CALLS):
        slot = k % 4
        for t, a in zip((t for row in ring[slot] for t in row),
                        (t for row in runner.host_tiles(src[slot])
                         for t in row)):
            t.copy_(a)
        y = runner.run_host(ring[slot], reps)
        for t in (t for row in ring[slot] for t in row):
            t.fill_(0xFF)  # the caller's tiles, free on return
        if k == 2:  # two results held at once
            y2 = runner.run_host(runner.host_tiles(src[3], pin=True), reps)
            runner.fetch_into(y2, outs[3])
            errs.append(int(not np.array_equal(stitched(outs[3]), eager[3])))
        runner.fetch_into(y, outs[slot])
        errs.append(int(not np.array_equal(stitched(outs[slot]),
                                           eager[slot])))
    require(not any(errs), f"mesh_replay: replays differ from the eager "
            f"chunks: {errs}")
    for t, a in zip(ring, src):
        for x, b in zip((x for row in t for x in row),
                        (x for row in runner.host_tiles(a) for x in row)):
            x.copy_(b)

    with profile(activities=[ProfilerActivity.CUDA]):
        profiled_replays = runner._replayable(ring[0])
        runner.fetch_into(runner.run_host(ring[1], reps), outs[1])
    require(not profiled_replays and np.array_equal(stitched(outs[1]),
                                                    eager[1]),
            "mesh_replay: a profiled call replayed, or its chunks differ")

    ms = {"eager": [], "replay": []}
    paths = {"eager": lambda g: runner._place_and_run(g, reps),
             "replay": lambda g: runner.run_host(g, reps)}
    for _ in range(5):
        for p, fn in paths.items():
            t0 = time.perf_counter()
            for k in range(40):
                runner.fetch_into(fn(ring[k % 4]), outs[k % 4])
            ms[p].append((time.perf_counter() - t0) * 1e3 / 40)
    fill_launches = halo_fill.launch.launches
    fills = halo.fill_counts()["fills"] - fills
    # every eager job (the chunks, the replay's warm-up run and its
    # capture) fills four rings a chunk; replays launch nothing from the
    # host
    a_job = 4 * len(cs.launch_schedule(reps, runner.fuse))
    require(fill_launches == fills and fill_launches > 0
            and fill_launches % a_job == 0,
            f"mesh_replay: {fill_launches} halo_fill launches, {fills} "
            f"fills counted")
    return {"phase": "mesh_replay", "ok": True,
            "devices": [str(d) for d in devices],
            "peer": {f"{a}-{b}": torch.cuda.can_device_access_peer(a, b)
                     for a in range(n) for b in range(n) if a != b},
            "capture_s": capture_s, "graph_launches": rep.launches,
            "fill_launches": fill_launches,
            "calls": MESH_REPLAY_CALLS + 1,
            "job_ms": {p: statistics.median(v) for p, v in ms.items()},
            "job_ms_rounds": ms,
            "memory_allocated": [torch.cuda.max_memory_allocated(k)
                                 for k in range(n)]}


HALO_FILL_DEPTHS, HALO_FILL_ROUNDS = (8, 1), 50


def phase_halo_fill() -> dict:
    """``halo_fill`` on the mesh cell's tiles against ``fill_plain`` and
    the strip exchange; see the module docstring."""
    from tpu_stencil_torch.ops import halo_fill
    from tpu_stencil_torch.parallel import fill, halo
    from tpu_stencil_torch.runtime import roofline

    n = torch.cuda.device_count()
    devices = [torch.device("cuda", k % n) for k in range(4)]
    h, w = MESH_REPLAY_SHAPE
    rng = np.random.default_rng(27)
    tiles = [[torch.from_numpy(rng.integers(0, 256, (h // 2, w // 2),
                                            np.uint8)).to(devices[2 * i + j])
              for j in range(2)] for i in range(2)]
    cards = [[t.device for t in row] for row in tiles]
    used = list(dict.fromkeys(devices))

    def sync():
        for d in used:
            torch.cuda.synchronize(d)

    def fill_ms(fn, st, d):
        """The slowest card's ms of one fill of every ring, CUDA events
        around each card's launches, median of the rounds."""
        by_card = {c: [(i, j) for i, j in st.slab.local_tiles()
                       if cards[i][j] == c] for c in used}
        rounds = []
        for _ in range(HALO_FILL_ROUNDS + 1):
            evs = {}
            for c, idx in by_card.items():
                with torch.cuda.device(c):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for i, j in idx:
                        fn(st.table(i, j, d))
                    b.record()
                evs[c] = (a, b)
            sync()
            rounds.append(max(a.elapsed_time(b) for a, b in evs.values()))
        return statistics.median(rounds[1:])

    out = {}
    for d in HALO_FILL_DEPTHS:
        kern = fill._State(tiles, max(HALO_FILL_DEPTHS), cards)
        plain = fill._State(tiles, max(HALO_FILL_DEPTHS), cards)
        tables = [(kern.table(i, j, d), plain.table(i, j, d))
                  for i, j in kern.slab.local_tiles()]
        for k, p in tables:
            halo_fill.launch(k)
            halo_fill.fill_plain(p)
        sync()
        bad = sum(int((a.cpu() != b.cpu()).sum()) for a, b in
                  zip(kern.slab.buffers, plain.slab.buffers))
        strips = halo.halo_exchange(tiles, d)
        sync()
        bad_strips = sum(
            int((kern.slab.ext(i, j, d).cpu() != strips[i][j].cpu()).sum())
            for i, j in kern.slab.local_tiles())
        require(bad == 0 and bad_strips == 0,
                f"halo_fill: depth {d}: {bad} bytes differ from fill_plain, "
                f"{bad_strips} from halo_exchange")
        # the ring's bytes, read once and written once, on the busiest
        # card over the link its pieces cross (a copy on one card)
        ring = {c: 0 for c in used}
        for (k, _), (i, j) in zip(tables, kern.slab.local_tiles()):
            ring[cards[i][j]] += k.nbytes
        bound = max(ring.values()) / roofline.device_link_bytes_per_s(
            len(used) == 1) * 1e3
        out[d] = {"ms": fill_ms(halo_fill.launch, kern, d),
                  "library_ms": fill_ms(halo_fill.fill_plain, plain, d),
                  "bound_ms": bound, "max_abs_err": 0,
                  "pieces": sum(len(k) for k, _ in tables),
                  "peer_pieces": sum(k.peer_pieces for k, _ in tables),
                  "ring_bytes": sum(ring.values())}
    return {"phase": "halo_fill", "ok": True,
            "devices": [str(d) for d in devices],
            "tile": [h // 2, w // 2], "depths": out}


def place_overlap_cell(dev, label, shape, name, probe) -> dict:
    """:func:`phase_place_overlap` at one cell's shape and filter;
    ``probe(fn, x)`` runs ``fn(x)`` and appends to ``probe.in_flight``
    whether the copy still ran at the call's first K1 launch."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_stencil_torch.models import blur
    from tpu_stencil_torch.ops import cuda_stencil as cs

    def moved(fn, x):
        before = cs.body_launch_counts(), cs.body_rep_counts()
        y = probe(fn, x)
        after = cs.body_launch_counts(), cs.body_rep_counts()
        return y, [blur._delta(b, a) for b, a in zip(before, after)]

    plan = plan_of(name)
    model = blur.IteratedConv2D(name, backend="pallas", device=dev)
    model.prepare(shape[:2], shape[2] if len(shape) == 3 else 1)
    rng = np.random.default_rng(25)
    src = [rng.integers(0, 256, shape, np.uint8) for _ in range(PLACE_RING)]
    ring = [torch.from_numpy(a).pin_memory() for a in src]
    model(ring[0], PLACE_REPS)  # the kernels built and warmed
    want = [flat_plain(torch.from_numpy(a).to(dev), plan, PLACE_REPS).cpu()
            for a in src]
    placed = blur.placement_counts()

    def run(x):
        return model(x, PLACE_REPS)

    blocking, per_call = [], []
    for a in src:
        y, by_body = moved(run, torch.from_numpy(a))
        blocking.append(y.cpu())
        per_call.append(by_body)
    blocking_in_flight = probe.in_flight[-PLACE_RING:]
    ys, over_calls = [], []
    for k in range(PLACE_CALLS):
        slot = k % PLACE_RING
        ring[slot].copy_(torch.from_numpy(src[slot]))
        y, by_body = moved(run, ring[slot])
        ring[slot].fill_(0xFF)  # the caller's buffer, free on return
        over_calls.append(by_body)
        ys.append((slot, y))
    over_in_flight = probe.in_flight[-PLACE_CALLS:]
    counts = blur._delta(placed, blur.placement_counts())
    require(counts == {"overlapped": PLACE_CALLS, "blocking": PLACE_RING},
            f"place_overlap {label}: placements {counts}")
    require(all(over_calls[k] == per_call[k % PLACE_RING]
                for k in range(PLACE_CALLS)),
            f"place_overlap {label}: K1's launches by body {over_calls} "
            f"against the blocking path's {per_call}")
    require(not any(blocking_in_flight),
            f"place_overlap {label}: a blocking copy still ran at its "
            f"call's first launch: {blocking_in_flight}")
    blocking_errs = [max_err(b, w) for b, w in zip(blocking, want)]
    got = [(slot, y.cpu()) for slot, y in ys]
    errs = [max(max_err(y, want[slot]), max_err(y, blocking[slot]))
            for slot, y in got]
    require(max(blocking_errs) == 0 and max(errs) == 0,
            f"place_overlap {label}: max abs err {errs} overlapped, "
            f"{blocking_errs} blocking, against the plain version")

    # Profiled pairs: the blocking placement of a pinned input (the
    # model's sequence before the overlap), then the overlapped one. The
    # device's activities alone, so the host runs at its untraced pace.
    for t, a in zip(ring, src):
        t.copy_(torch.from_numpy(a))
    paths = {"blocking": lambda x: model.run_on(model._place(x), PLACE_REPS),
             "overlapped": run}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PLACE_PROFILED):
            for fn, x in zip(paths.values(), ring):
                probe(fn, x)
                torch.cuda.synchronize()
    seen = copy_then_k1(prof)
    require(len(seen) == 2 * PLACE_PROFILED,
            f"place_overlap {label}: {len(seen)} H2D copies profiled for "
            f"{2 * PLACE_PROFILED} calls")
    for d, flag in zip(seen, probe.in_flight[-2 * PLACE_PROFILED:]):
        d["copy_in_flight"] = flag
    profiled = {p: seen[i::2] for i, p in enumerate(paths)}
    require(all(o["copy_end_to_k1_start_us"] < b["copy_end_to_k1_start_us"]
                for b, o in zip(*profiled.values())),
            f"place_overlap {label}: K1 followed an overlapped copy no "
            f"closer than the blocking one: {profiled}")

    # ms a job, the two placements of one pinned ring taking turns.
    fetched = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
               for _ in range(PLACE_RING)]
    stream = torch.cuda.current_stream(dev)
    ms = {p: [] for p in paths}
    for _ in range(5):
        for p, fn in paths.items():
            t0 = time.perf_counter()
            for k in range(100):
                fetched[k % PLACE_RING].copy_(fn(ring[k % PLACE_RING]),
                                              non_blocking=True)
                stream.synchronize()
            ms[p].append((time.perf_counter() - t0) * 10)
    return {"shape": list(shape), "filter": name, "reps": PLACE_REPS,
            "calls": PLACE_CALLS, "max_abs_err": max(errs),
            "placements": counts, "k1_bodies_per_call": per_call[0],
            "copy_in_flight_at_first_launch": sum(over_in_flight),
            "profiled": profiled,
            "job_ms": {p: statistics.median(v) for p, v in ms.items()},
            "job_ms_rounds": ms}


def run(dev: torch.device) -> None:
    """Every phase on ``dev``; raises on any failure."""
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(dev)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "sms": props.multi_processor_count,
          "l2_bytes": int(props.L2_cache_size)})

    # The autotune cache of this run: a file of its own, empty at start.
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.runtime import autotune
    from tpu_stencil_torch.tools import kernel_lab

    WORK.mkdir(parents=True, exist_ok=True)
    os.environ[autotune.ENV_CACHE] = str(WORK / "autotune.json")
    (WORK / "autotune.json").unlink(missing_ok=True)

    # Every library this script launches, one nvcc each, all together.
    t0 = time.perf_counter()
    variants = [lab.parse_variant(n) for n in kernel_lab.DEFAULT_VARIANTS
                if n not in kernel_lab.SPECIAL + tuple(kernel_lab.K2_FORMS)]
    targets = [*_build.JOB_KERNELS, "halo_fill", "op_chain",
               *lab.lab_targets(variants), lab.BAND_TARGET, "crc32c"]
    built = _build.build(targets)

    def label(t):
        return t if isinstance(t, str) else f"{t[0]}[{' '.join(t[1])}]"

    def log_of(t):
        return _build.build_log(t) if isinstance(t, str) else _build.build_log(*t)

    libs = {label(t): str(p) for t, p in built.items()}
    tiles = ("stencil_fused", "stencil_resident", "stencil_valid",
             lab.BAND_TARGET)
    ptxas = {label(t): [ln.strip() for ln in log_of(t).splitlines()
                        if "registers" in ln or "spill" in ln][:6]
             for t in built if t not in ("op_chain", "crc32c")
             and t not in tiles}
    for t in tiles:
        ptxas[label(t)] = tile_instances(log_of(t))
    spills = [ln for t in built for ln in log_of(t).splitlines()
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    sass = check_op_chain_sass(op_chain_sass(libs["op_chain"]))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs, "ptxas": ptxas, "lines_with_spills": spills,
          "op_chain_sass": sass})

    emit(phase_divide(dev))
    k1 = phase_k1(dev)
    emit(k1)
    k2 = phase_k2(dev)
    emit(k2)
    main_path = phase_main_path(dev)
    emit(main_path)
    k3 = phase_k3(dev)
    emit(k3)
    sharded_path = phase_sharded_path(dev)
    emit(sharded_path)
    l2 = phase_l2(dev)
    emit(l2)
    l1 = phase_l1(dev)
    emit(l1)
    autotune_path = phase_autotune_path(dev)
    emit(autotune_path)
    emit(phase_job_hardened(dev))
    overlap_path = phase_overlap_path(dev)
    emit(overlap_path)
    emit(phase_witness(dev))
    multiprocess = phase_multiprocess(dev)
    emit(multiprocess)
    stream_path = phase_stream_path(dev)
    emit(stream_path)
    shard_stream = phase_shard_stream_path(dev)
    emit(shard_stream)
    serve_path = phase_serve_path(dev)
    emit(serve_path)
    serve_runs = serve_path["runs"]
    net_path = phase_net_path(dev, serve_runs["load"]["warm"])
    emit(net_path)
    fed_ctrl = phase_fed_ctrl_path(dev, net_path["runs"]["cli"])
    emit(fed_ctrl)
    times = phase_times(dev)
    emit(times)
    emit(phase_place_overlap(dev))
    mesh_replay = phase_mesh_replay()
    emit(mesh_replay)
    fills = phase_halo_fill()
    emit(fills)

    runs = main_path["runs"]
    common = {"route": "cuda", "plain_ms": times["plain_ms"],
              "bound_ms": times["bound_ms"],
              "bound_by": times["bound_by"],
              "library_ms": times["library_conv2d_ms"], "ok": True,
              "unit": "ms per rep, 1920x2520 RGB gaussian x40"}
    emit({"kernels": [
        {"name": "stencil_fused",
         "source": "tpu_stencil_torch/ops/csrc/stencil_fused.cu",
         "replaces": "tpu_stencil/ops/pallas_stencil.py:757",
         "launches": runs["default_warm"]["window_launches"]["stencil_fused"],
         "warmup_launches": runs["default_warm"]["warmup_launches"]["stencil_fused"],
         "max_abs_err": max(k1["max_abs_err"],
                            runs["default_warm"]["max_abs_err"],
                            runs["default_cold"]["max_abs_err"],
                            serve_path["max_abs_err"],
                            net_path["max_abs_err"],
                            fed_ctrl["max_abs_err"]),
         "ms": times["stencil_fused_ms"], **common,
         "body": times["tile_ab"]["gaussian"]["k1_body"],
         "regs_ab": k1["regs"]["ab"],
         # The stream of 16 frames through the CLI (5 a frame + the
         # warm-up's), the fan of 2 lanes on this card, the batch axis.
         "stream_launches": {
             k: stream_path["runs"][k]["launches"]["stencil_fused"]
             for k in ("stream_rgb", "mesh2_rgb")},
         # The serving engine: one single-rep launch per rep per bucket
         # batch (the ten mixed requests, the two big frames under
         # overlap off, the 64-request load run).
         "serve_launches": {
             "mixed_requests": serve_runs["pallas"]["launches"][
                 "stencil_fused"],
             "overlap_off": serve_runs["sharded"]["off"]["launches"][
                 "stencil_fused"],
             "load_run": serve_runs["load"]["cli"]["launches"][
                 "stencil_fused"],
             "load_passes": serve_runs["load"]["launches"][
                 "stencil_fused"]},
         # The network tier: one request, the ten mixed requests one at a
         # time, the collapsed misses and a cache hit, the quarantine run
         # (served requests and the prober's two reps a probe).
         "net_launches": net_path["k1_launches"],
         # The federation over two in-process members: one request, the
         # ten mixed requests, an affinity cache hit, a corrupted body
         # rerouted (two legs), a hedged request (40 a leg that ran on a
         # member), the no-fallback request (none).
         "fed_launches": fed_ctrl["k1_launches"]},
        {"name": "stencil_resident",
         "source": "tpu_stencil_torch/ops/csrc/stencil_resident.cu",
         "replaces": "tpu_stencil/ops/pallas_stencil.py:1079",
         "launches": runs["deep_warm"]["window_launches"]["stencil_resident"],
         "warmup_launches": runs["deep_warm"]["warmup_launches"]["stencil_resident"],
         "max_abs_err": max(k2["max_abs_err"], runs["deep_warm"]["max_abs_err"],
                            runs["deep_cold"]["max_abs_err"]),
         "ms": times["stencil_resident_ms"], **common,
         "body": times["tile_ab"]["gaussian"]["body"],
         "k2_over_k1_same_call": times["resident_ab"]["k2_over_k1"],
         "stream_launches": {
             k: stream_path["runs"][k]["launches"]["stencil_resident"]
             for k in ("stream_deep_rgb", "mesh2_deep_rgb")}},
        {"name": "stencil_valid",
         "source": "tpu_stencil_torch/ops/csrc/stencil_valid.cu",
         "replaces": "tpu_stencil/ops/pallas_stencil.py:909",
         "launches": sharded_path["runs"]["cli_mesh1x1_warm"][
             "window_launches"]["stencil_valid"],
         "warmup_launches": sharded_path["runs"]["cli_mesh1x1_warm"][
             "warmup_launches"]["stencil_valid"],
         "max_abs_err": max(k3["max_abs_err"], sharded_path["max_abs_err"],
                            overlap_path["runs"]["thin_windows"][
                                "max_abs_err"],
                            shard_stream["max_abs_err"]),
         "ms": times["stencil_valid_ms"],
         **common, "plain_ms": times["stencil_valid_plain_ms"],
         "bound_ms": times["stencil_valid_bound_ms"],
         "bound_by": times["stencil_valid_bound_by"],
         "body": times["tile_ab"]["gaussian"]["body"],
         # K3 under each overlap mode on the 2x2 job (window launches,
         # ms per rep of the runner), and K3 on one thin border window.
         "overlap_launches": {
             m: overlap_path["runs"][f"job_{m}"]["launches"]["stencil_valid"]
             for m in OVERLAP_MODES + ("auto",)},
         "overlap_auto": overlap_path["runs"]["auto"]["verdict"],
         "overlap_ms_per_rep": overlap_path["runs"]["ms_per_rep"],
         "window": overlap_path["runs"]["thin_windows"]["left_band_rgb"],
         # K3 on each rank of two processes (--mesh 2x1, one tile each).
         "launches_per_rank_2proc": {
             k: v["launches"]["stencil_valid"] for k, v in
             multiprocess["runs"]["cli_2x1"]["ranks"].items()},
         # K3 on the sharded stream of 16 frames (frames x a frame's
         # launches + the warm-up's), and on 8 frames of 7680x4320.
         "shard_stream_launches": {
             k: shard_stream["runs"][k]["launches"]["stencil_valid"]
             for k in ("shard2x2_edge", "shard2x2_off", "shard1x2_grey",
                       "big_8k")},
         # The serving engine's sharded route: the two big frames under
         # edge on the visible card (1x1) and on [cuda:0] * 4 (2x2).
         "serve_launches": {
             k: serve_runs["sharded"][k]["launches"]["stencil_valid"]
             for k in ("edge_1x1", "edge_2x2")}},
        # L2 and L1 run on the tools' path, not the job's: their launches
        # are those of the tool runs in phases l2 and l1, with no warm-up.
        {"name": "stencil_lab",
         "source": "tpu_stencil_torch/ops/csrc/stencil_lab.cu",
         "replaces": "tools/kernel_lab.py:254",
         "launches": l2["tool_launches"], "warmup_launches": 0,
         "max_abs_err": l2["max_abs_err"],
         "ms": times["stencil_lab_ms"],
         **common, "plain_ms": times["stencil_lab_plain_ms"],
         # body `tile` (K1's shipped tile, the redesign) and K1 itself,
         # from phase l2's interleaved table; `current` is the baseline
         "tile_ms": l2["ms_per_rep_x40"]["tile"],
         "shipped_ms": l2["ms_per_rep_x40"]["shipped"],
         "unit": "ms per rep, 1920x2520 RGB gaussian x40, body `current` "
                 "(tile_ms: body `tile`)"},
        {"name": "op_chain",
         "source": "tpu_stencil_torch/ops/csrc/op_chain.cu",
         "replaces": "tools/op_cost.py:31",
         "launches": l1["tool_launches"], "warmup_launches": 0,
         "max_abs_err": l1["max_abs_err"],
         "ms": times["op_chain_ms"], "route": "cuda", "ok": True,
         "plain_ms": times["op_chain_plain_ms"],
         "bound_ms": times["op_chain_bound_ms"],
         "bound_by": times["op_chain_bound_by"],
         "library_ms": None, "unit": times["op_chain_unit"],
         "blocks_per_sm": {c: v[8] for c, v in
                           l1["more"]["blocks_per_sm"].items()},
         "mxu_rows_bf16": {
             "ms": times["mxu_rows_bf16_ms"],
             "bound_ms": times["mxu_rows_bf16_bound_ms"],
             "us_per_op_pass": l1["us_per_op_pass"]["mxu_rows_bf16"],
             "bound_us_per_op_pass": l1["bound_us_per_op_pass"][
                 "mxu_rows_bf16"],
             "library_ms": times["mxu_rows_bf16_library_ms"],
             "unit": times["mxu_rows_bf16_unit"]}},
        # The mesh's ghost rings: the launches of the mesh cell's path
        # (phase mesh_replay), the times of one fill of the 2x2 grid's
        # rings at depth 8 (phase halo_fill), the library a copy_ a piece.
        {"name": "halo_fill",
         "source": "tpu_stencil_torch/ops/csrc/halo_fill.cu",
         "replaces": "tpu_stencil/parallel/halo.py:91",
         "launches": mesh_replay["fill_launches"], "warmup_launches": 0,
         "max_abs_err": max(v["max_abs_err"]
                            for v in fills["depths"].values()),
         "route": "cuda", "ok": True,
         "ms": fills["depths"][8]["ms"],
         "bound_ms": fills["depths"][8]["bound_ms"], "bound_by": "bytes",
         "library_ms": fills["depths"][8]["library_ms"],
         "tail_ms": fills["depths"][1]["ms"],
         "unit": "ms per fill of a 2x2 grid of 2520x960 grey tiles' "
                 "rings, depth 8, slowest card (tail_ms: depth 1)"},
    ]})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
