#!/usr/bin/env python3
"""Chip smoke test of lodestar_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero); each prints
its wall time on a line of its own:

1. card: name and power limit (nvidia-smi), torch and CUDA versions, and
   the nvcc build of the sixteen kernels from this checkout's sources;
2. kernels: the kernel registry (``ops/library_fuse.kernel_entry_points``,
   the path of the library kernel ``library_fq2_mul``, as the JAX
   registry is its instance's) run once at its example shapes with every
   launch counter set to 0 just before, each entry bitwise equal to its
   plain version and every kernel launched; then each CUDA kernel against
   its plain PyTorch version on the card, on seeded inputs at the shapes
   its path gives it (fold at 1,024 rows, canon at 512, 1,280 and the
   ladder predicate's 5,120, mul at 128,
   256, 384, 512 and 3,584, fq2sqr at the final exponentiation's 9 and the
   htc's 256 and 512, fq2pow16mul at the square root's 256 and at 512,
   fq2mul at the htc's 256 and 1,024 and the Miller loop's 2,322, pow16mul
   at the inversions' 256 and 512, each of these six also at 2,560, the
   ladder kernels at 512 rows, lad2 and lad3 also at 2,560, the tower
   kernels at 1 row and at the most rows the XLA-graph path gives them at
   bucket 128, the library kernel at 4 rows and at the tower Fq2 product's
   1,548), three inputs a shape — bitwise, tolerance zero, since both are
   exact integer arithmetic; the cooperative kernels (lad1, lad2, lad3,
   fq2pow16mul, tower_fq6_mul and tower_fq12_mul one block per row,
   fq2mul, pow16mul, mul, fq2sqr, fold, canon, tower_fq2_mul,
   tower_fq2_sqr and library_fq2_mul several rows a block: every row
   kernel) also at 1, 37 and 513 rows and on inputs at the digit bounds,
   each logged with its block's layout and shared-memory bytes.
   Times are device times: 20 calls captured in one CUDA graph, the
   replays timed by CUDA events, so the host's cost of issuing a launch
   is outside the window (it is printed beside them as ``issue_ms``, 20
   eager calls between events).

2b. graphs: the verifier's per-bucket CUDA graphs
   (``crypto/bls/bucket_program.py``) of the fused program in both modes
   at bucket 128 (the cuda-marked tests hold both programs' at bucket 4;
   the XLA-graph program's capture costs 20-30 s a
   mode at any bucket: phase 6 makes and holds its full-device graph at
   128 the same way, phase 11 its split graph at 16): each bucket's
   ``warmup`` (the eager run, the
   capture and the instantiation seconds, the device memory it reserved,
   the port kernels' launches a replay); then a valid batch of the phase's
   sets through the eager ops entry and through the graph, every launch
   counter 0 before each: the outputs (f's digits and ok, or the verdict)
   and the verdicts bitwise equal, every kernel launched as often; and a
   valid and a corrupted batch in flight at once, read in reverse order:
   False, then True.  Its verifiers, their graphs made, carry phases 3-5
   and 11; phases 6, 10 and 12 warm theirs up first: every per-card batch
   of those phases is a replay.

Phases 3-10 measure the full-device mode (``host_final_exp=False``: the
final exponentiation on the card), as before the split dispatch was
ported; phases 11-12 the split default.  The launch counts of a replayed
batch are its graph's capture record, added by each replay; the row
histograms of phases 3, 6 and 11 are read from that record.

3. fused slice: 128 real signature sets (interop keys, the port's own
   oracle) through ``TorchBlsVerifier.verify_signature_sets`` at bucket
   128 with every launch counter set to 0 just before: the valid batch
   verifies, every fused-path kernel launched; then a corrupted
   signature, a signature outside G2 and 100 live sets in bucket 128 give
   False, False, True; one more valid batch whose launches of fq2mul,
   pow16mul, mul, fq2sqr, fold and canon are logged as a histogram of their row
   counts; the batch-128 example inputs verify through
   ``verify_signature_sets_fused``; the card's Miller product at bucket 4
   equals the CPU plain run's canonically, digit for digit (the CPU runs
   of phases 3, 6 and 9 are made in the host processes while the card
   works on the earlier phases);
4. fused times: three batches of 128 fresh signatures (new messages, so
   no signature is in the verifier's point cache; the public keys are, as
   on a node), each timed as pack then device dispatch (a replay) to the
   verdict on the host clock; the best batch gives sets/s;
5. fused profile: one more fresh batch's replay under
   ``torch.profiler``: the device time of the port's kernels and of
   PyTorch's glue kernels, and the device's idle share over that dispatch;
   then the ladder stretch of an eager run of that batch through the ops
   entry (the 128 iterations of ``point_mul_bits_ladder`` between two
   marker kernels): the host's wall across it, the device's span and busy
   time in it, its idle share; then the host's cost of one eager launch
   with the card idle and busy;
6. XLA slice: the full-device graph at bucket 128 made and held as in
   phase 2b (its warmup, the replay against the eager run, two batches
   in flight); then the same four batches through
   ``TorchBlsVerifier(fused=False)`` (the XLA-graph program,
   ``ops/batch_verify``) with every launch counter set to 0 just before
   the valid one: True, False, False, True, and each tower kernel
   launched; one more valid batch whose tower_fq2_mul, tower_fq2_sqr and
   tower_fq12_mul launches are logged as a histogram of their row counts;
   the card's bucket-4 Miller product equals the CPU plain run's
   canonically (the XLA path's digits depend on the order of the glue, so
   the comparison is on the canonical residues);
7. XLA times and profile: phases 4 and 5 for the XLA-graph program
   (profiled with device activity only: a replay makes about 630,000
   launches);
8. ring: the ring hop kernel alone against ``copy_`` at chunks of 0-40,
   600, 1,027 and 4,099 floats, pointers 0, 4, 8 and 12 bytes past a
   16-byte boundary; then
   (``ops/ring_gather``) against its plain
   version, bitwise, as a whole all-gather and as a one-hop permute, at 2
   and 4 logical shards on card 0 and on a (6, 2, 50) GT partial and a
   (2,) verdict-bits chunk, three seeded inputs each; the device time of
   one hop at both shapes (the bits at an odd, 8-byte aligned slot) beside
   ``copy_`` of the same slots, ``Tensor.copy_`` of a chunk and an empty
   kernel of one block, the hop's eager issue time, one whole gather; with two or more
   cards visible, the same across min(count, 4) cards (peer access);
9. sharded slice, every batch a replay of the verifier's per-bucket
   ``MeshProgram`` (a CUDA graph per shard, one for the combine):
   ``warmup_sharded`` of ``TorchBlsVerifier(devices=[cuda:0] * n,
   sharded=True, sharded_min_batch=256)`` at 256 over 2 and 4 shards, in
   the full-device and the split mode, of the ring combine over 2, and of
   the XLA-graph flavour at bucket 16 over 2 shards in both modes (the
   full run: the full-device mode only, the split one in
   ``--sharded-only``; each program's eager run, capture and instantiation seconds, device memory
   and launches a replay); each program's replay against the eager
   ``ShardedProgram`` on one batch (256 valid, 150 live over 4 shards, 16
   valid), every launch counter 0 before each: outputs bitwise equal,
   every kernel and the ring hop launched as often; then, every launch
   counter 0 just before, 256 valid sets verify, the ring kernel and
   every fused kernel launched; a corrupted signature, a signature outside
   G2 in shard 1 give False; 150 live sets over 4 shards (shard 3 all
   padding) give True; a valid and a corrupted batch in flight, read in
   reverse: False, True; the XLA-graph flavour, every launch counter 0
   just before, gives True / False, every tower kernel and the ring
   kernel launched; the shards' bucket-8 Miller partials, all-gathered,
   are bitwise equal on every shard, and the sharded Miller product
   equals the CPU plain run canonically; with two or more cards, the
   program made, held and valid and corrupted batches on cuda:0 and
   cuda:1;
10. sharded times: three fresh batches of 256 through the sharded tier's
    replays (pack + dispatch, sets/s, each shard's enqueue wall), one profiled
    dispatch (the union of the device's busy intervals), the same sets
    through one card as two chunks of 128; with two or more cards, the
    same across 2 (and 4) cards and the scaling efficiency;
11. split: ``TorchBlsVerifier()``, the split default (the device Miller
    product, the host C final exponentiation), on the four batches of
    phase 3 (True, False, False, True) with every launch counter set to 0
    just before the valid one, each fused kernel launched; three fresh
    batches of 128, each split into pack, device Miller product (enqueue
    plus the sync on the event after the copies of ok and f to the host),
    read of f's host copy and host final exponentiation, and sets/s beside
    phase 4's; one more batch of 128 whose fq2mul, pow16mul, mul, fq2sqr,
    fold and canon launches are logged as a histogram of their row counts
    (its graph's record); one batch's dispatch
    under ``torch.profiler`` (as phase 5), the device's idle share over
    the best device Miller product; the XLA-graph split at bucket 16
    (valid, corrupted; its kernels but the Fq6 product, which only the
    final exponentiation runs, launched; the row counts of the valid
    batch's tower_fq2_mul, tower_fq2_sqr and tower_fq12_mul launches; its
    graph made at bucket 16 first and held as phase 2b holds the fused
    program's); the sharded split at bucket 256, through phase 9's split
    programs, over 2 logical shards
    (valid, corrupted, a signature outside G2 in shard 1, one fresh timed
    batch) and over 4 (150 live sets: shard 3 all padding); with two or
    more cards, the sharded split across cuda:0 and cuda:1;
12. pool: ``BlsBatchPool(TorchBlsVerifier(), pipeline_depth=2,
    flush_threshold=128, max_buffer_wait=0.02)``, the verifier's
    ``warmup()`` of every bucket first (its seconds, the device memory it
    reserved, each graph's eager run, capture and instantiation seconds),
    given 512 fresh sets at
    once as 256 gossip jobs of 1-3 sets and one 64-set job at
    block-proposal priority, every launch counter set to 0 just before:
    every verdict True, each fused kernel launched, sets/s, batches
    flushed, the in-flight peak and the share of the wall in which two
    batches' host spans (pack start to verdict read) were open; then 4
    jobs, one holding a corrupted set, after which exactly that job is
    False; then a job past its deadline is dropped with
    ``VerificationDroppedError``; then a pool over
    ``TorchBlsVerifier(devices=[cuda:0] * 2, sharded=True)`` (``sharded_active``: the
    merge cap grows to 2 x 128; its mesh program at 256 made by
    ``warmup_sharded``) given phase 9's 256 sets as gossip jobs,
    whose merged batch rides the sharded tier, every verdict True, and two
    128-set jobs, one holding a corrupted set, which give True, False.
13. health: the verifier's health, quarantine and requeue, faults
    injected through the port's fault plane (``chaos.CHAOS``; a real
    CUDA error would poison the context every executor of the card
    shares, so none is provoked), bundles in a temporary directory.  On
    ``TorchBlsVerifier(devices=[cuda:0] * 2, quarantine_threshold=1,
    quarantine_backoff_s=0.5)``, its fused split graph at bucket 128 made
    first: two plain batches, one on each executor (a batch's launches
    and wall); a ``device.loss`` on executor ``cuda:0`` (armed from the plan's
    JSON, as ``LODESTAR_TPU_CHAOS_PLAN`` carries it) with every launch
    counter at 0: phase 3's valid batch is requeued to ``cuda:0#1`` and
    gives True, ``batches_requeued`` 1, ``bls.requeue`` from ``cuda:0`` in
    the journal, ``cuda:0`` quarantined with its ``quarantine-cuda:0``
    bundle, every fused kernel launched twice one batch's count; three
    batches dispatched at once during the quarantine all land on
    ``cuda:0#1``; after the
    backoff a probe batch re-admits ``cuda:0`` (``probing`` and
    ``readmitted`` in the journal); one batch in flight on each executor
    at once, their outputs bitwise equal; a corrupted batch lost and
    requeued gives False.  On one executor a loss raises
    ``DeviceLostError`` with every slot and in-flight entry freed, and the
    next batch verifies; a 0.5 s ``device.wedge`` under a 0.2 s watchdog
    (``RECORDER.start_watchdog``) leaves one stall bundle whose manifest
    lists the stalled batch and the health section.  A pool over two
    executors with a loss armed once gives every job True with no per-job
    retry.  Logged: a requeued batch's wall against a plain one's, the
    probe batch's wall, the time to re-admission and the phase's wall.
14. store: the library built in phase 1 saved to a temporary durable
    store (``aot/store.py``), then three fresh processes at once: one with
    nvcc off its PATH and CUDA_HOME pointing at an empty directory,
    ``TorchBlsVerifier(load_only=True, aot_store=...)``, loads it from the
    store (ledger kind ``aot_load``), warms bucket 4 and verifies a valid
    and a corrupted batch (True, False), starting no nvcc; one on an empty
    store raises ``AotStoreMiss`` before any batch; one allowed to build
    (into an empty build directory), on a copy of the store whose payload
    ``chaos.corrupt_file`` corrupted, journals ``aot.corrupt``,
    quarantines it, rebuilds with nvcc, saves again and verifies the same
    two batches; logged: the store's load seconds against the nvcc
    build's, the compile ledger's summary, and three starts, each from a
    verifier's construction to its first verdict at bucket 4: cold (the
    rebuilding process, nvcc), aot (the ``load_only`` process, the stored
    library) and warm (this process, the library from its memo).
15. observatory: the port's own entry (``cli.py``): ``add_bls_flags``
    parsed with ``--bls-buckets 128 --bls-warmup blocking --torch-profile
    <tmp> --profile-window 2 --telemetry-interval-s 0.2 --forensics-dir
    <tmp>`` (and ``--trace-dump``), ``configure_tracing``, ``make_pool``
    (``make_verifier``: the split fused ``TorchBlsVerifier`` on ``cuda:0``,
    its warmup under ``run_window(label="warmup")``) with a metrics
    registry that keeps what is reported to it, ``configure_forensics``
    (``RECORDER.install()``, then ``configure_observatory``: the sampler
    over the verifier's executors, the two-flush window armed); the 256
    sets of phase 9 as 1-3-set gossip jobs plus one 64-set block job, then
    one 128-set job: every verdict True; the window finishes without an
    error, its merged trace passes ``tools/check_trace`` with device
    evidence and names the ten fused kernels, every batch of the window
    has device events inside its dispatch window (not the dispatch-wall
    fallback); the sampler's ``cuda:0`` row holds memory in use, the
    card's total memory as its limit and a busy ratio above 0; the pool's
    dispatches, batch-size sum and end-to-end count equal its batches,
    sets and jobs; a pool set to shed (a job past its deadline, threshold
    1) writes one ``overload`` bundle with per-lane counts and a
    configured ``profile.json``; SIGUSR2 writes a bundle and the run goes
    on.  Logged: each batch's six-way breakdown, the window's device
    events, skew and offset, the export's timebase (how far the first
    kernel lies from the window's start, the clock map's error at it),
    the sampler's and the capture's overhead ratios, and the 128-set
    batch's wall inside the window beside the same batch's outside it.
16. analysis: ``lodestar_tpu_torch.analysis.run_all(device="cuda")``, every
    layer of the port's static analysis (``python -m
    lodestar_tpu_torch.analysis --device cuda``): the AST lint and metrics
    coverage, the test-cost census, the lock audit, the bound proofs over
    the plain versions and the kernel headers' obligations (the g++ audit
    build), the device programs' traces at bucket 128 on the card (host
    syncs, wide dtypes, the sharded pieces, no matrix product), the ring's
    hop plan, the host walks of every cooperative body, the sixteen
    kernels' launch resources (``cudaFuncGetAttributes`` against the
    launch configuration: no spill, the block's threads, shared memory
    within the card's opt-in limit) and ``compute-sanitizer``'s
    racecheck, synccheck and memcheck over a child that launches each
    kernel once at 37 rows (its version logged; a toolkit without it, or
    one that refuses the device, is logged as such and the child runs
    alone).  Zero violations, or the run fails.  The known violations,
    the ladder kernels' spill held at its measured bytes, are logged as
    open, apart from the count.  Logged per kernel: registers, local and
    shared bytes, and each tool's result.  In the full run it runs in a
    host process of the pool beside phase 9 (bitwise checks; its seconds
    are only logged) and ends before phase 10 times anything.
17. chain: the beacon chain through the card's verifier.  A split fused
    ``TorchBlsVerifier`` on ``cuda:0`` at buckets 4, 16 and 128, its graphs
    warmed first; ``DevChain`` (minimal preset, 128 interop validators,
    Altair at epoch 1, Bellatrix at epoch 2, pre-merge) runs 50 slots
    through the port's ``BlsBatchPool``: every block's signature sets one
    job on the block-proposal lane, one batch.  It must reach Bellatrix
    with justified epoch >= 4, finalized epoch >= 3 and >= 50 dispatches,
    and give the head, head state root and checkpoints of the same 50
    slots run meanwhile in a host process over ``FastBlsVerifier`` (and
    its batches' set counts).  Range sync: slots 1-16 replayed on a fresh
    chain by ``process_chain_segment`` are one batch, import 16 blocks and
    reach the producer's block 16; with block 9's signature replaced by
    block 10's, the replay imports 8 blocks and raises ``BlockError``.
    Logged: blocks/s of the chain and of the segment, per block the state
    transition, the pool wait and the verifier's stage seconds, the
    buckets used, each bucket graph's launch record, and the ten fused
    kernels' launches over the chain and over the two segment replays
    (``launches_by_path``'s ``chain`` and ``segment``).
18. network: the node's network face, every pool on one split fused
    ``TorchBlsVerifier`` on ``cuda:0`` at buckets 4, 16 and 128, warmed
    first; 128 interop validators, minimal preset, phase0.  18a: node A
    runs 20 slots alone over the host's C verifier, node B (its pool on
    the card) connects over the loopback, handshakes, pings, reads A's
    metadata and range-syncs to A's head (``RangeSync.run_to_head``, one
    pool job a segment): B's head must be A's, synced.  18b: three nodes
    in the line A-B-C (validators 0-42, 43-85, 86-127), manual clocks, 26
    slots; every block and every single-bit attestation crosses the wire
    (``GossipHandlers.on_attestation`` -> the gossip lane of each node's
    pool): every slot's head must agree across the nodes, every node's
    attestation pool must hold every vote, every foreign vote must verify,
    justification must advance, and the heads and final checkpoints must
    equal the same sim run meanwhile in a host process over
    ``FastBlsVerifier``.  18c: ``python -m lodestar_tpu_torch.cli dev``
    (128 validators, ``--slots 0``) as a child process on card 0; once its
    REST head passes slot 40, ``... beacon --connect`` as another; over
    REST the beacon node must report synced, its head header must be the
    dev node's of that root, each must have one connected peer, nonzero
    pack, device and final-exponentiation seconds, its card executor
    healthy and (where ``prometheus_client`` is installed) the gossip,
    req/resp, sync and API metric families; both stop on SIGINT with exit
    code 0 and no traceback.  Logged: range sync's blocks/s, segments and
    buckets; the sim's slots/s, per node the gossip attestations verified
    and their receipt-to-verdict wait (p50, p95), the pool's batches by
    lane and bucket, per block the pool wait and the state transition; the
    children's warmup, the dev node's blocks/s, the beacon node's range
    sync, each REST route's latency; the ten fused kernels' launches over
    18a and 18b (``launches_by_path``'s ``range_sync`` and ``gossip``).
19. validator: the validator client, the node's pool on one split fused
    ``TorchBlsVerifier`` on ``cuda:0`` at buckets 4, 16 and 128, warmed
    first.  19a: a node (``DevChain``'s chain over the interop genesis of
    128 validators, minimal preset, Altair at epoch 1, Bellatrix at 2,
    pre-merge, a manual clock set to each slot, no producer of its own)
    behind ``RestApiServer`` with ``GossipHandlers`` on the loopback; the
    port's ``ValidatorClient`` with keys 0-127, a ``SlashingProtection``
    persisted to a file and a ``ChainHeaderTracker`` drives 24 slots of
    duties over HTTP (proposals, attestations, aggregates, sync messages
    and contributions, signed under three fork versions); then ``python -m
    lodestar_tpu_torch.flare self-slash-proposer`` and
    ``self-slash-attester`` for one index each, and slot 25, whose block
    must carry both slashings.  The same run goes on in a host process
    over ``FastBlsVerifier``: every slot's head, the checkpoints and each
    Altair block's sync participation (above zero) must equal the host
    run's, every validator's vote must be in a block, both indices must be
    slashed in the head state, and a second vote for a signed slot with
    another root must raise ``SlashingError`` before a signature leaves
    the store.  19b: the port's ``LightClient`` bootstraps over REST from
    the first Altair block and follows the node's updates; its optimistic
    and finalized headers must equal the host run's.  19c: the README's
    validator flow as child processes: ``account create`` and ``account
    list``; ``init`` writes an rc file and ``beacon --config`` (128
    validators, no fork flags) starts from it on card 0; ``validator
    --interop-indices 0..127 --slashing-protection-db F`` drives it; once
    the node's head passes slot 8 both stop on SIGINT with exit code 0 and
    no traceback, the head block must carry attestations, the node nonzero
    pack, device and final-exponentiation seconds and a healthy card
    executor, and ``F`` must be EIP-3076 interchange JSON that
    ``SlashingProtection`` imports.  Logged: slots/s, the pool's batches by
    lane and bucket, per slot the pool wait of the block and of the
    duties, the children's logs in ``chiprun_out/chip_smoke_validator_cli/``,
    and the ten fused kernels' launches over 19a (``launches_by_path``'s
    ``validator``).  The full run runs 19c in a thread beside phase 9 (as
    phase 16), so its rates there are taken beside phase 9.
20. operations: the port's harnesses in ``lodestar_tpu_torch/tools/``.
    20a: ``firehose.run_firehose`` on the card's split fused pool
    (``firehose.card_verifier``: buckets 4, 16 and 128, warmed first; the
    firehose's real sets, interop keys reused), an at-SLO window (150
    sets/s for 10 s) and an overload window (2,000 sets/s for 5 s, a
    400 ms storm-lane deadline), each over a pool of its own
    (``firehose.make_pool``, backpressure at 512 pending sets): both with
    0 unaccounted sets, 0 stranded futures and every verified job True,
    the overload run with intake shedding above 0 and the pool's pending
    sets (read at every tick) within the bound backpressure sets
    (``pending_sets_bound``).  Logged: achieved sets/s, queue wait and
    end-to-end p50 / p99 overall, per lane and per duty, batches by lane
    and bucket, the fused kernels' launches over both windows
    (``launches_by_path``'s ``firehose``).  20b: ``python -m
    lodestar_tpu_torch.tools.chaos_campaign --json`` (the card is its
    default) in a
    child: device_loss, device_wedge, compile_fault and sharded_loss on
    the card's graphs (two executors of card 0 at bucket 4, the tier over
    2 logical shards at bucket 4), the other four classes on the host;
    every scenario holds with 0 verdicts lost, every bundle it names
    passes the port's ``inspect_bundle`` here too; logged: time to
    quarantine, to recover, the recovery ratio, and the launches the
    child counted over the campaign's batches, its verifiers' warmups
    left out (``chaos``, the ring hop's too).  20c: the prewarm farm
    (``tools/prewarm``) fills an empty store for buckets 4 and 16 in a
    child; a second, running while the first holds the farm lock, exits
    3; ``--verify`` exits 0; a child with nvcc off its PATH loads the
    library from that store under ``load_only``, warms bucket 4 and
    verifies a valid and a corrupted batch (True, False) starting no
    nvcc.  The children's output is in ``chiprun_out/chip_smoke_ops/``.
    The full run runs 20c in a thread beside phase 9 (as 19c), 20b after
    phase 10, alone (its recovery ratio compares two rates), and 20a
    after phase 19, alone.
21. run ledger, at the end of every mode: this run's record
    (``observatory/run_ledger.make_record``: mode, the phases it runs,
    exit code, the card's name and power limit, torch and CUDA, each
    phase's wall seconds and ``LEDGER_METRICS``, the tripwire metrics of
    the phases the mode runs, read from the phases' figures: phase 11's
    split sets/s and device Miller product, phase 12's pool sets/s, phase
    10's sharded sets/s and its ratio to one card as 2 x 128, phase 14's
    cold, aot and warm starts, phase 17's and 18a's blocks/s, 20a's
    achieved sets/s at the SLO) written to ``chiprun_out/runs/``;
    then the deltas against the newest earlier record of the same card,
    ``perf_report``'s one-line summary (regressions, plateaus, gaps) and
    ``tier1_budget`` over ``.jax_cache/tier1_timings.json`` ("none"
    without one).  A flagged regression is reported, not fatal.  A run
    that fails in a phase writes its record (rc 1, null where no phase
    gave a figure) and then fails as before; a run whose phases passed
    but left a metric null fails here, its record rc 1.  The deltas compare with the
    records in this checkout's ``chiprun_out/runs/``;
    ``python -m lodestar_tpu_torch.tools.perf_report --runs GLOB`` reads
    records gathered from several checkouts.

Signatures are made by a pool of host processes (each signs in the
port's C library, ``native/fastbls``), which also run the CPU references
and phase 17's host chain, phase 18's host sim and phase 19's host run;
the pool is closed before the end.

The last lines: the paths side by side, the whole run's wall, the
``kernels`` JSON object, phase 21's lines, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --sharded-only
    python3 chip_smoke.py --split-only
    python3 chip_smoke.py --fused-only
    python3 chip_smoke.py --store-only
    python3 chip_smoke.py --observatory-only
    python3 chip_smoke.py --analysis-only
    python3 chip_smoke.py --chain-only
    python3 chip_smoke.py --network-only
    python3 chip_smoke.py --validator-only
    python3 chip_smoke.py --ops-only

run phases 1 and 8-10 alone (on a machine with several cards, for the
cross-card legs), phases 1, 2, 2b and 11-13, phases 1-5, 2b, 11 and 12 (every
path that runs the fused G2 ladder: a checkout's kernels against
another's), phases 1 and 14, phases 1 and 15 (signing its 256 sets
itself), phases 1 and 16, phases 1 and 17, phases 1 and 18, phases 1
and 19, or phases 1 and 20, each then phase 21, and end with ``{"phases": ...}``, the card line
and ``{"ok": true, "device": {...}}`` without the ``kernels`` object.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import ctypes
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the cooperative kernels, and their seeded inputs within their contracts
# and at the digit bounds
from lodestar_tpu_torch.analysis.kernel_audit import COOP, LOOSE_TOP, edge_inputs, kernel_inputs

# H100 SXM peaks (NVIDIA data sheet; at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# NVLink between the cards of one host: 900 GB/s, 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9
# int32 multiply-add on the CUDA cores: 64 lanes per SM per clock (half the
# fp32 lanes) x 132 SMs x 1.98 GHz, 2 operations each = half of the
# 67 TFLOP/s fp32 rate
INT32_OPS_PER_S = 33.5e12

SEED = 20261016
REPO = os.path.dirname(os.path.abspath(__file__))
BUCKET = 128  # the node's MAX_SIGNATURE_SETS_PER_JOB
SHARDED_BUCKET = 256  # the sharded tier's default smallest bucket (the largest)
RING_SHAPES = ((6, 2, 50), (2,))  # a GT partial, the two verdict bits
RING_SHARDS = (2, 4)
# the hop alone: chunk lengths (floats; 0-40, and three that take more than
# one block or more than one item a thread) and pointer offsets (bytes
# past a 16-byte boundary) it is held against copy_ at
HOP_LENGTHS = (*range(41), 600, 1027, 4099)
HOP_OFFSETS = (0, 4, 8, 12)
# seeded inputs each kernel is held against its plain version on, per shape
# (a miscompiled build can be wrong on a few rows in thousands)
CHECKS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fresh_dir(path: str) -> str:
    """``path`` emptied of an earlier run's files (a phase whose state
    lives there starts from nothing on every run of the checkout)."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# each phase's wall seconds, by name, as it ended (the run's record keeps them)
PHASE_SECONDS = {}


class Phase:
    """Logs a phase's wall time on a line of its own when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            PHASE_SECONDS[self.name] = time.perf_counter() - self.t0
            log(f"phase {self.name}: {PHASE_SECONDS[self.name]:.1f} s wall")


# -- operation counts (int32 multiply-adds a row; carries and adds are not
#    counted, so the bound below is a lower bound) ---------------------------


def _fold(w: int, bits: int) -> int:
    extra = max(1, -(-(bits - 8) // 8))
    return (w + extra - 49) * 50


_MUL = 2500 + _fold(99, 22)  # same fold width for bits 16/17/18
_LOADF = _fold(50, 22)
_SMALL = _fold(50, 13)  # add / sub / doubling folds (one extra column)
_F2MUL = 3 * _MUL + 2 * _SMALL
_F2SQR = 2 * _MUL + 2 * _SMALL
# the tower kernels fold every add and subtract on its own
_TF2MUL = 3 * _MUL + 5 * _SMALL
_TF2 = 2 * _SMALL  # one folded Fq2 add or subtract
_TF6MUL = 6 * _TF2MUL + 6 * _TF2 + 11 * _TF2
_TF12MUL = 3 * _TF6MUL + 6 * _TF2 + 10 * _TF2
MACS_PER_ROW = {
    "mul": 2 * _LOADF + _MUL,
    "fq2mul": 4 * _LOADF + _F2MUL,
    "fq2sqr": 2 * _LOADF + _F2SQR,
    "pow16mul": 2 * _LOADF + 5 * _MUL,
    "fq2pow16mul": 4 * _LOADF + 4 * _F2SQR + _F2MUL,
    "fold": _LOADF,
    "canon": _LOADF + 4 * 6 + 3 * 48,
    "lad1": 12 * _LOADF + 6 * _F2SQR + 2 * _F2MUL,
    "lad2": 8 * _LOADF + 4 * _F2MUL + 2 * (3 * _F2SQR + 18 * _SMALL),
    "lad3": 4 * _LOADF + 9 * _F2MUL + 3 * _F2SQR + 32 * _SMALL,
    "tower_fq2_mul": _TF2MUL,
    "tower_fq2_sqr": 2 * _MUL + 3 * _SMALL,
    "tower_fq6_mul": _TF6MUL,
    "tower_fq12_mul": _TF12MUL,
    # the JAX limbs algorithm: three products, two strict sums (carry at
    # bound 24, 52 columns) and two subtractions (53 columns) folded
    "library_fq2_mul": 3 * _MUL + 2 * _fold(50, 24) + 2 * _fold(51, 24),
}
# rows each kernel is held and timed at: the shapes its path gives it at
# bucket 128 (the last is the one the kernels line reports).  The XLA-graph
# path's largest: the Fq2 product in fq12_sqr (12 lanes x 129 pairs), the
# Fq2 square in hash-to-G2 (2 draws x 128), the Fq12 product in the Miller
# loop (129 pairs); the Fq6 product runs only in the final exponentiation.
SHAPES = {
    "lad1": (512,), "lad2": (2560, 512), "lad3": (2560, 512),
    # the square root's 256 (2 draws x 128) first; 2,560 kept last, so the
    # kernels line reports the shape of earlier runs
    "fq2pow16mul": (2 * BUCKET, 512, 2560),
    # the htc's 256 and 1,024 (Fq2 values of 2 draws x 128 lane-stacked 1 and
    # 4 deep) and the Miller loop's most, 18 lanes x 129 pairs
    "fq2mul": (2 * BUCKET, 8 * BUCKET, 18 * (BUCKET + 1), 2560),
    # the windowed inversions' and the Legendre scan's 256 and 512
    "pow16mul": (2 * BUCKET, 4 * BUCKET, 2560),
    # a split batch's most frequent (128 to 512 rows, 592 of 602 launches)
    # and its largest, 3,584
    "mul": (BUCKET, 2 * BUCKET, 3 * BUCKET, 4 * BUCKET, 28 * BUCKET, 2560),
    # the full-device final exponentiation's 9 (the nine Fq2 squares of a
    # cyclotomic square, 326 launches) and the htc's 256 and 512
    "fq2sqr": (9, 2 * BUCKET, 4 * BUCKET, 2560),
    # the final exponentiation's 1, the most frequent (128 to 387 rows,
    # 2,392 of a full-device batch's 2,800 launches) and fq12_sqr's 1,548
    "tower_fq2_mul": (1, BUCKET, 2 * BUCKET, 3 * BUCKET, 12 * (BUCKET + 1)),
    "tower_fq2_sqr": (1, 2 * BUCKET),
    "tower_fq6_mul": (1,),
    # the final exponentiation's 1 (175 of its 250 launches) and the Miller
    # loop's 129
    "tower_fq12_mul": (1, BUCKET + 1),
    # the registry's B = 4, and the tower Fq2 product's largest shape
    "library_fq2_mul": (4, 12 * (BUCKET + 1)),
    # its 3 launches a batch, at 1,024 rows
    "fold": (8 * BUCKET,),
    # 6 launches at 512 rows, 3 at 1,280 and the ladder's stacked predicate,
    # 5 values x 512 rows x 2 components, 128 of its 138 launches (last)
    "canon": (4 * BUCKET, 10 * BUCKET, 40 * BUCKET),
}
# the cooperative kernels (COOP), every row kernel (one warp per Fq step;
# one row a block, or several for fq2mul, pow16mul, mul, fq2sqr, fold, canon,
# tower_fq2_mul, tower_fq2_sqr and library_fq2_mul): also held at these row
# counts (a single row; a partial last block for every rows-a-block count;
# one past the ladder's 512) and on inputs at the digit bounds, untimed
COOP_CHECK_ROWS = (1, 37, 513)
# the kernels whose launches' row counts phases 3 and 11 log as a histogram
ROW_HISTOGRAM = ("fq2mul", "pow16mul", "mul", "fq2sqr", "fold", "canon")
# the same on the XLA-graph paths (phase 6 and the split XLA run of 11)
TOWER_HISTOGRAM = ("tower_fq2_mul", "tower_fq2_sqr", "tower_fq12_mul")
FUSED = ("mul", "fq2mul", "fq2sqr", "pow16mul", "fq2pow16mul", "fold", "canon",
         "lad1", "lad2", "lad3")
TOWER = ("tower_fq2_mul", "tower_fq2_sqr", "tower_fq6_mul", "tower_fq12_mul")
LIBRARY = ("library_fq2_mul",)
# the split XLA-graph path's kernels: the Fq6 product runs only in the
# final exponentiation, which the split dispatch leaves to the host
XLA_SPLIT = ("tower_fq2_mul", "tower_fq2_sqr", "tower_fq12_mul")
SPLIT_XLA_BUCKET = 16  # the XLA-graph split's verdicts, at a bucket that keeps the run short
XLA_SHARDED_BUCKET = 16  # the sharded XLA-graph flavour's, over 2 shards (8 lanes each)
# the buckets phase 2b holds the fused program's graphs at (the cuda-marked
# tests hold both programs' at bucket 4)
GRAPH_BUCKETS = (BUCKET,)
# (fused, host_final_exp) of the fused program's two per-card programs, which
# phase 2b holds; the XLA-graph program's capture costs ~20-30 s a mode at
# any bucket: phase 6 makes and holds the full-device one at 128, phase 11
# the split one at 16
PROGRAMS = ((True, False), (True, True))
POOL_SETS = 512  # gossip sets phase 12 submits at once
POOL_BLOCK_SETS = 64  # the block-proposal job's sets


def bound(kernel, rows: int):
    """(bound_ms, bound_by): the larger of the bytes over HBM and the
    multiply-adds over the int32 rate, for ``rows`` rows."""
    width = int(np.prod(kernel.tail))
    nbytes = 4 * rows * width * (kernel.n_in + kernel.n_out)
    ops = 2 * MACS_PER_ROW[kernel.name] * rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of fn: reps calls captured in one CUDA graph,
    replayed and timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def issue_ms(fn, reps: int = 20) -> float:
    """Time of one eager call of fn by CUDA events over reps calls: for a
    short kernel, the rate at which the host issues launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 2: every kernel against its plain version -------------------------


# canon's inputs at the edges of its branches (canon_edge_rows)
CANON_EDGES = ("loose-max", "zero", "p-1", "p", "p+1", "2p-1", "2p", "3p-1", "carry-chain")


def _loose(digits: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The same value in loose digits: digit i takes b * 256 from digit
    i + 1, b drawn up to what both digits allow."""
    x = digits.astype(np.int64).copy()
    for i in range(len(x) - 1):
        x[i] += 256 * (b := int(rng.integers(0, min(x[i + 1], (LOOSE_TOP - x[i]) // 256) + 1)))
        x[i + 1] -= b
    return x


def canon_edge_rows(case: str, seed: int) -> torch.Tensor:
    """Loose (rows, 50) inputs of canon at one edge of its branches, from a
    seed: every digit at the loose bound 2^22 - 1 (and at random ones near
    it); zero; the values p - 1 .. 3p - 1 around the conditional
    subtractions, strict and in seeded loose digits; a run of 255 digits
    up to digit 48 above one digit of 256 at seeded places, a propagate
    chain of up to 48 digits through the fold's carry passes and the
    51-digit ripple after them."""
    from lodestar_tpu_torch.crypto.bls.fields import P
    from lodestar_tpu_torch.ops import limbs as fl

    rng = np.random.default_rng(seed)
    if case == "loose-max":
        rows = [np.full(50, LOOSE_TOP)] + [LOOSE_TOP - rng.integers(0, 256, 50) for _ in range(3)]
    elif case == "zero":
        rows = [np.zeros(50, np.int64)] * 2
    elif case == "carry-chain":
        rows = []
        for start in (0, *rng.integers(1, 40, 3)):
            row = np.zeros(50, np.int64)
            row[:start] = rng.integers(0, 256, start)
            row[start], row[start + 1:49] = 256, 255
            rows.append(row)
    else:
        k, d = {"p-1": (1, -1), "p": (1, 0), "p+1": (1, 1), "2p-1": (2, -1), "2p": (2, 0),
                "3p-1": (3, -1)}[case]
        strict = fl.int_to_limbs(k * P + d).astype(np.int64)
        rows = [strict] + [_loose(strict, rng) for _ in range(3)]
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def run_registry(dev, card: str) -> dict:
    """The library kernel's path: every entry of the kernel registry run
    once on the card at its example shapes, every launch counter 0 just
    before; returns each counter's count just after, and fails if a
    kernel was launched no time or an entry differs from its plain
    version."""
    from lodestar_tpu_torch.ops import fused_core
    from lodestar_tpu_torch.ops.library_fuse import kernel_entry_points

    rng = np.random.default_rng(SEED + 20)
    entries = kernel_entry_points()
    inputs = {}
    for name, e in entries.items():
        k = fused_core.KERNELS.get(name)
        if k is not None:
            inputs[name] = kernel_inputs(k, e["args"][0][0], rng, dev)
        else:
            inputs[name] = [torch.from_numpy(rng.standard_normal(a).astype(np.float32)).to(dev)
                            for a in e["args"]]
    sync_all()
    fused_core.reset_launch_counts()
    outs = {name: e["fn"](*inputs[name]) for name, e in entries.items()}
    sync_all()
    launches = {name: k.launches for name, k in fused_core.COUNTED.items()}
    for name, e in entries.items():
        want = e["plain"](*inputs[name])
        if not all(torch.equal(g, w) for g, w in zip(outs[name], want)):
            raise AssertionError(f"registry: entry {name} differs from its plain version")
    idle = [name for name in entries if launches[name] == 0]
    if idle:
        raise AssertionError(f"registry: kernels never launched: {idle}")
    log(f"registry: {len(entries)} entries at their example shapes, each bitwise equal to "
        f"its plain version; launches {json.dumps(launches)} [{card}]")
    return launches


def held_against_plain(k, ins, what: str) -> float:
    """Launch kernel k on ins and fail unless it equals its plain version
    bitwise with semi-strict digits; returns max |kernel - plain| (0)."""
    got = k.launch(*ins)
    torch.cuda.synchronize()
    want = k.plain(*ins)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    semi = max(float(g.max()) for g in got)
    if err != 0.0 or semi > 256:
        raise AssertionError(f"kernel {k.name} {what}: max |kernel - plain| = {err}, "
                             f"max digit {semi}")
    return err


def check_coop(k, rng, dev, card: str) -> None:
    """A redesigned kernel at the row counts of COOP_CHECK_ROWS and, on
    inputs at the digit bounds, also at its timed shapes, CHECKS seeds
    each."""
    from lodestar_tpu_torch.ops.kernels import _build

    for rows in COOP_CHECK_ROWS:
        for _ in range(CHECKS):
            held_against_plain(k, kernel_inputs(k, rows, rng, dev), f"at {rows} rows")
    for rows in COOP_CHECK_ROWS + SHAPES[k.name]:
        for _ in range(CHECKS):
            held_against_plain(k, edge_inputs(k, rows, rng, dev),
                               f"at {rows} rows, inputs at the bounds")
    if k.name == "canon":
        for i, case in enumerate(CANON_EDGES):
            held_against_plain(k, [canon_edge_rows(case, i).to(dev)], f"at the edge {case}")
    # an older checkout's one-thread kernels (a comparison run) have no size
    lib = _build.load()
    smem = getattr(lib, f"smem_bytes_{k.name}", None)
    rows_per_block = getattr(lib, f"rows_per_block_{k.name}", lambda: 1)
    threads = getattr(lib, f"threads_per_block_{k.name}", None)
    layout = (f"{rows_per_block()} row(s) a block" + (f" of {threads()} threads" if threads else "")
              + f", {smem()} B of dynamic shared memory a block" if smem
              else "one thread per row")
    edges = f", and at its branch edges {CANON_EDGES}" if k.name == "canon" else ""
    log(f"kernel {k.name}: bitwise equal to plain at {COOP_CHECK_ROWS} rows and, inputs at "
        f"the digit bounds, at {COOP_CHECK_ROWS + SHAPES[k.name]} rows, {CHECKS} seeds each"
        f"{edges}; "
        f"{layout} [{card}]")


def check_kernels(dev, card: str):
    from lodestar_tpu_torch.ops import fused_ladder, library_fuse, tower_kernels  # noqa: F401
    from lodestar_tpu_torch.ops.fused_core import KERNELS

    rng = np.random.default_rng(SEED)
    results = {}
    for name, k in KERNELS.items():
        if name in COOP:
            check_coop(k, rng, dev, card)
        by_rows = {}
        for rows in SHAPES[name]:
            err = 0.0
            for _ in range(CHECKS):
                ins = kernel_inputs(k, rows, rng, dev)
                err = max(err, held_against_plain(k, ins, f"at {rows} rows"))
            ms = graph_ms(lambda: k.launch(*ins))
            plain_ms = graph_ms(lambda: k.plain(*ins), reps=3)
            issue = issue_ms(lambda: k.launch(*ins))
            b_ms, b_by = bound(k, rows)
            log(f"kernel {name} rows={rows}: bitwise equal to plain; device {ms:.4f} ms "
                f"(plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by}; "
                f"eager issue {issue:.4f} ms) [{card}]")
            by_rows[rows] = dict(ms=ms, bound_ms=b_ms)
            results[name] = dict(rows=rows, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by, issue_ms=issue, by_rows=by_rows)
    return results


# -- the batches -------------------------------------------------------------


def make_keys(n: int):
    """The first n interop secret keys and their public keys, read back from
    their compressed bytes as a node's validator registry holds them (so
    the verifier's point cache can key them)."""
    from lodestar_tpu_torch.crypto.bls import PublicKey, interop_secret_key

    sks = [interop_secret_key(i) for i in range(n)]
    return [(sk, PublicKey.from_bytes(sk.to_public_key().to_bytes())) for sk in sks]


def _sign(job) -> bytes:
    i, msg = job
    from lodestar_tpu_torch.crypto.bls import interop_secret_key

    return interop_secret_key(i).sign(msg).to_bytes()


def make_sets(pool, keys, tag: bytes):
    """One valid single-key signature set per key, over messages that
    ``tag`` makes new; the signing spread over ``pool``."""
    from lodestar_tpu_torch.crypto.bls import SingleSignatureSet

    msgs = [b"chip smoke %s %d" % (tag, i) for i in range(len(keys))]
    sigs = pool.map(_sign, list(enumerate(msgs)), chunksize=8)
    return [SingleSignatureSet(pubkey=pk, signing_root=m, signature=sig)
            for (_sk, pk), m, sig in zip(keys, msgs, sigs)]


def cpu_reference(what: str):
    """A CPU plain run the card is held against, in a host process beside
    the card's phases: the canonical digits of the Miller product of the
    example inputs and the verdict bits, for the fused program at bucket 4
    (phase 3), the XLA-graph program at bucket 4 (phase 6) or the fused
    sharded entry over 2 CPU shards at bucket 8 (phase 9)."""
    torch.set_num_threads(1)
    from lodestar_tpu_torch.ops import batch_verify, fused_core, fused_verify, limbs
    from lodestar_tpu_torch.ops.sharded_verify import miller_product_sharded

    if what == "xla":
        f, ok = batch_verify.miller_product_kernel(
            *batch_verify.from_packed(batch_verify.example_inputs(4), "cpu"))
        return limbs.fp_reduce_full(f).numpy(), bool(ok)
    if what == "fused":
        f, ok = fused_verify.miller_product_fused(
            *fused_verify.from_packed(fused_verify.example_inputs(4), "cpu"))
    else:
        f, ok = miller_product_sharded(["cpu"] * 2, fused=True)(*fused_verify.example_inputs(8))
        f = fused_core.lv(f)
    return fused_core.f_canon(f).numpy(), bool(ok)


def non_subgroup_signature() -> bytes:
    """A point on E2 outside G2: the SSWU + isogeny image of one field draw,
    before cofactor clearing."""
    from lodestar_tpu_torch.crypto.bls.curve import g2_subgroup_check, g2_to_bytes
    from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_field_fq2, map_to_curve_g2

    pt = map_to_curve_g2(hash_to_field_fq2(b"outside the subgroup", 2)[0])
    if g2_subgroup_check(pt):
        raise AssertionError("expected a point outside G2")
    return g2_to_bytes(pt)


def check_verdicts(verifier, sets, path: str, kernels) -> dict:
    """The four batches through ``verifier``: valid, one corrupted
    signature, one signature outside G2, 100 live sets in the bucket ->
    True, False, False, True.  Every launch counter is 0 just before the
    valid batch; returns every counter's count just after it, and fails if
    one of ``kernels`` (the path's) was launched no time."""
    from lodestar_tpu_torch.ops import fused_core

    fused_core.reset_launch_counts()
    t0 = time.perf_counter()
    ok = verifier.verify_signature_sets(sets)
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in fused_core.COUNTED.items()}
    log(f"{path} slice: valid batch of {len(sets)} -> {ok} (first run {first_s:.3f} s); "
        f"launches per batch {json.dumps(launches)}")
    if ok is not True:
        raise AssertionError(f"{path}: a valid batch of {len(sets)} sets did not verify")
    idle = [name for name in kernels if launches[name] == 0]
    if idle:
        raise AssertionError(f"{path}: kernels never launched on the path: {idle}")

    bad = list(sets)
    bad[5] = dataclasses.replace(bad[5], signature=sets[6].signature)
    got = verifier.verify_signature_sets(bad)
    log(f"{path} slice: one corrupted signature -> {got}")
    if got is not False:
        raise AssertionError(f"{path}: a corrupted batch verified")

    bad = list(sets)
    bad[9] = dataclasses.replace(bad[9], signature=non_subgroup_signature())
    got = verifier.verify_signature_sets(bad)
    log(f"{path} slice: one signature outside G2 -> {got}")
    if got is not False:
        raise AssertionError(f"{path}: a batch with a non-subgroup signature verified")

    got = verifier.verify_signature_sets(sets[:100])
    log(f"{path} slice: 100 live sets in bucket {BUCKET} -> {got}")
    if got is not True:
        raise AssertionError(f"{path}: a padded batch of 100 valid sets did not verify")
    return launches


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def time_batches(verifier, fresh, path: str, card: str, after=None):
    """Phase 4 / 7 / 10: each fresh batch packed then dispatched to the
    verdict on the host clock; returns (sets/s of the best, its dispatch
    seconds).  ``after()``, when given, adds to each batch's line."""
    cache = verifier.point_cache
    packs, dispatches = [], []
    for r, batch in enumerate(fresh):
        sync_all()
        hits, misses = cache.hits, cache.misses
        t0 = time.perf_counter()
        packed = verifier.pack(batch)
        t1 = time.perf_counter()
        ok = verifier.dispatch(packed).result()
        sync_all()
        t2 = time.perf_counter()
        log(f"{path} times: batch {r} pack: point cache {cache.hits - hits} hits, "
            f"{cache.misses - misses} misses" + (f"; {after()}" if after else ""))
        if not ok:
            raise AssertionError(f"{path}: timed batch {r} did not verify")
        packs.append(t1 - t0)
        dispatches.append(t2 - t1)
    walls = [p + d for p, d in zip(packs, dispatches)]
    best = min(range(len(walls)), key=walls.__getitem__)
    rate = len(fresh[best]) / walls[best]
    log(f"{path} times: batch of {len(fresh[best])} fresh signatures, best of {len(walls)}: "
        f"{walls[best]} s = {rate} sets/s (pack {packs[best]} s + device dispatch "
        f"{dispatches[best]} s); all packs {packs}, dispatches {dispatches} [{card}]")
    return rate, dispatches[best]


def profile_dispatch(packed, verifier, dispatch_s: float, card: str, kernels, path: str,
                     activities) -> float:
    """Phase 5 / 7: one dispatch under torch.profiler.  The port's kernels
    and PyTorch's glue kernels run on one stream and do not overlap, so the
    device is idle for the wall time their summed device time leaves: over
    the profiled wall, which the profiler stretches, and over
    ``dispatch_s``, the best unprofiled dispatch.  Returns the latter."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        ok = verifier.dispatch(packed).result()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        raise AssertionError(f"{path}: the profiled batch did not verify")
    ours = {f"{name}_k" for name in kernels}
    per_kernel, glue_ms, glue_launches = {}, 0.0, 0
    for ev in prof.key_averages():
        dev_us = ev.device_time_total
        if dev_us <= 0 or ev.key.startswith(("cuda", "aten::")):
            continue
        name = ev.key.split("(")[0]
        if name in ours:  # summed over every entry under the name
            entry = per_kernel.setdefault(name, {"device_ms": 0.0, "launches": 0})
            entry["device_ms"] += dev_us / 1e3
            entry["launches"] += ev.count
        else:
            glue_ms += dev_us / 1e3
            glue_launches += ev.count
    if set(per_kernel) != ours:
        raise AssertionError(f"{path}: the profiler saw no device time for "
                             f"{sorted(ours - set(per_kernel))}")
    ours_ms = sum(v["device_ms"] for v in per_kernel.values())
    busy_ms = ours_ms + glue_ms
    idle = 1.0 - busy_ms / (dispatch_s * 1e3)
    log(f"{path} profile: " + json.dumps({
        "card": card, "wall_ms": wall_ms, "port_kernels_device_ms": ours_ms,
        "glue_kernels_device_ms": glue_ms, "glue_kernel_launches": glue_launches,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "unprofiled_dispatch_ms": dispatch_s * 1e3,
        "device_idle_share_unprofiled": idle,
        "per_kernel": per_kernel}))
    return idle


def ladder_stretch(packed, dev, card: str) -> dict:
    """The merged G2 ladder's stretch of one eager run of the full-device
    fused program (``verify_signature_sets_fused``, the ops entry: the
    verifier replays a graph, whose host side this cannot bracket): the 128
    iterations of ``point_mul_bits_ladder``, bracketed by two marker
    kernels (``torch.cuda._sleep``, which nothing else launches): the host's
    wall across the call (its enqueue), the device's span from the end of
    the first marker to the start of the second and the device busy time
    of the kernels and copies between them, from one profiled run; the
    host wall and the span by CUDA events of one unprofiled run.  The
    stretch is device-bound when the device is busy through its span while
    the host finishes issuing well before the span ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lodestar_tpu_torch.ops import fused_verify

    def dispatch():
        args = fused_verify.from_packed(packed, dev)
        return bool(fused_verify.verify_signature_sets_fused(*args))

    inner = fused_verify.point_mul_bits_ladder
    seen = {}

    def marked(*args, **kwargs):
        torch.cuda._sleep(1)
        seen["e0"].record()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        seen["host_ms"] = (time.perf_counter() - t0) * 1e3
        seen["e1"].record()
        torch.cuda._sleep(1)
        return out

    runs = {}
    fused_verify.point_mul_bits_ladder = marked
    try:
        for profiled in (False, True):
            seen.update(e0=torch.cuda.Event(enable_timing=True),
                        e1=torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    ok = dispatch()
                    torch.cuda.synchronize()
            else:
                ok = dispatch()
                torch.cuda.synchronize()
            if not ok:
                raise AssertionError("ladder stretch: the batch did not verify")
            runs[profiled] = dict(host_ms=seen["host_ms"],
                                  span_ms=seen["e0"].elapsed_time(seen["e1"]))
    finally:
        fused_verify.point_mul_bits_ladder = inner
    evs = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    marks = [i for i, ev in enumerate(evs) if "spin_kernel" in ev.name]
    if len(marks) != 2:
        raise AssertionError(f"ladder stretch: expected 2 marker kernels, saw {len(marks)}")
    inside = evs[marks[0] + 1:marks[1]]
    span_ms = (evs[marks[1]].time_range.start - evs[marks[0]].time_range.end) / 1e3
    busy = sum(ev.time_range.end - ev.time_range.start for ev in inside) / 1e3
    ours = sum(ev.time_range.end - ev.time_range.start for ev in inside
               if ev.name.split("(")[0] in {f"{n}_k" for n in FUSED}) / 1e3
    out = {"card": card, "host_wall_ms": runs[False]["host_ms"],
           "device_span_ms": runs[False]["span_ms"],
           "profiled_host_wall_ms": runs[True]["host_ms"],
           "profiled_device_span_ms": span_ms, "device_busy_ms": busy,
           "port_kernels_device_ms": ours, "device_ops_in_window": len(inside),
           "device_idle_share_of_span": 1.0 - busy / span_ms}
    log("fused ladder stretch: " + json.dumps(out))
    return out


def launch_cost(dev, card: str, n: int = 500) -> dict:
    """Host microseconds of one eager launch, a 64-element ``add_`` and the
    fold kernel on one row through its wrapper, n in a row, with the card
    idle (each launch finds the card done with the last) and with the card
    busy (all n queued behind a marker kernel that outlasts their issue):
    whether the host's issue cost depends on the card's state.  A dispatch
    that the host's launches bound leaves the card idle more as its kernels
    get faster."""
    from lodestar_tpu_torch.ops.fused_core import KERNELS

    x = torch.zeros(64, device=dev)
    row = torch.zeros((1, 50), device=dev)
    ops = {"add_": lambda: x.add_(1), "fold": lambda: KERNELS["fold"](row)}
    out = {"card": card, "launches": n}
    stream = torch.cuda.current_stream(dev)
    for name, op in ops.items():
        for state in ("idle", "busy"):
            op()
            torch.cuda.synchronize()
            if state == "busy":
                torch.cuda._sleep(1_000_000_000)  # about 0.5 s of the card's clock
            t0 = time.perf_counter()
            for _ in range(n):
                op()
            out[f"{name}_{state}_us"] = (time.perf_counter() - t0) / n * 1e6
            if state == "busy" and stream.query():
                raise AssertionError("launch cost: the marker ended before the launches did")
            torch.cuda.synchronize()
    log("launch cost: " + json.dumps(out))
    return out


# -- phase 2b: the verifier's per-bucket graphs -------------------------------


def program_name(fused: bool, host_final_exp: bool) -> str:
    return f"{'fused' if fused else 'xla'} {'split' if host_final_exp else 'full-device'}"


def verdict_of(outs, host_final_exp: bool) -> bool:
    """A program's verdict from its outputs on the host: (f's digits, ok)
    through the C final exponentiation, or the device's verdict."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import fq12_blob
    from lodestar_tpu_torch.native import fastbls

    if not host_final_exp:
        return bool(outs[0])
    return bool(outs[1]) and fastbls.final_exp_is_one(fq12_blob(outs[0].cpu().numpy()))


def replay_against_eager(verifier, packed, dev, what: str) -> bool:
    """One packed batch through the eager ops entry (every counter 0 just
    before) and through the verifier's graph at its bucket (the same):
    fails unless the outputs (f's digits and ok, or the verdict) are
    bitwise equal and every kernel was launched as often; returns the
    verdict."""
    from lodestar_tpu_torch.crypto.bls.bucket_program import _tensors
    from lodestar_tpu_torch.ops import fused_core
    from lodestar_tpu_torch.ops.fused_verify import from_packed

    program = verifier.programs[(dev, packed[0].shape[0], verifier.fused,
                                 verifier.host_final_exp)]
    sync_all()
    fused_core.reset_launch_counts()
    want = [t.cpu() for t in _tensors(verifier._entry()(*from_packed(packed, dev)))]
    sync_all()
    eager = {name: k.launches for name, k in fused_core.COUNTED.items()}
    fused_core.reset_launch_counts()
    got, ready = program.run(packed)
    ready.synchronize()
    replayed = {name: k.launches for name, k in fused_core.COUNTED.items()}
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    verdicts = tuple(verdict_of(outs, verifier.host_final_exp) for outs in (got, want))
    log(f"graphs: {what}: replay against eager, outputs bitwise equal {same}, verdicts "
        f"{verdicts}, launches equal {replayed == eager} ({sum(eager.values())} launches)")
    if not same or replayed != eager or verdicts[0] != verdicts[1]:
        raise AssertionError(f"graphs: {what}: the replay differs from the eager run "
                             f"(launches {replayed} against {eager})")
    return verdicts[0]


def warm_graph(verifier, dev, b: int, name: str, card: str) -> dict:
    """Makes ``verifier``'s graph at bucket ``b`` and logs its warmup (its
    eager run, capture and instantiation seconds, the device memory it
    reserved); returns those numbers."""
    sync_all()
    before = torch.cuda.memory_reserved(dev)
    seconds = verifier.warmup((b,))
    sync_all()
    held = torch.cuda.memory_reserved(dev) - before
    program = verifier.programs[(dev, b, verifier.fused, verifier.host_final_exp)]
    nodes = sum(n for h in program.launch_rows.values() for n in h.values())
    log(f"graphs: {name} bucket {b}: warmup {seconds:.3f} s (eager run "
        f"{program.seconds['eager']:.3f} s, capture {program.seconds['capture']:.3f} "
        f"s, instantiation {program.seconds['instantiate']:.3f} s), device memory "
        f"reserved +{held} B, {nodes} port kernel launches a replay [{card}]")
    return dict(warmup_s=seconds, **program.seconds, reserved_bytes=held,
                kernel_launches=nodes)


def hold_graph(verifier, dev, valid, bad, what: str) -> None:
    """A valid packed batch replayed against the eager ops entry (bitwise,
    every launch count equal), then two batches in flight, valid and
    corrupted, read in reverse order."""
    if replay_against_eager(verifier, valid, dev, what) is not True:
        raise AssertionError(f"graphs: {what}: a valid batch failed")
    first, second = verifier.dispatch(valid), verifier.dispatch(bad)
    got = (second.result(), first.result())
    log(f"graphs: {what}: two batches in flight, valid then corrupted, "
        f"read in reverse order -> {got}")
    if got != (False, True):
        raise AssertionError(f"graphs: {what}: the batches in flight gave {got}")


def run_graphs(dev, card: str, sets) -> dict:
    """Phase 2b: for the fused program in both modes (``PROGRAMS``), the
    verifier's graphs at GRAPH_BUCKETS: the warmup of each (its eager run,
    capture and instantiation seconds, the device memory it reserved);
    then, every graph made (they share the card's pool), at each bucket a
    valid batch replayed against the eager ops entry
    (bitwise, every launch count equal) and two batches in flight, valid
    and corrupted, read in reverse order.  Returns the warmed verifiers by
    (fused, host_final_exp), for the later phases."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    packer = TorchBlsVerifier(device=dev, rng=np.random.default_rng(SEED + 40))
    batches = {}
    for b in GRAPH_BUCKETS:
        bad = list(sets[:b])
        bad[1] = dataclasses.replace(bad[1], signature=sets[2].signature)
        batches[b] = (packer.pack(sets[:b]), packer.pack(bad))
    verifiers, summary = {}, {}
    with Phase("2b graphs"):
        for fused, host_final_exp in PROGRAMS:
            name = program_name(fused, host_final_exp)
            # the later phases' verifiers (phase 11's is the default one)
            v = (TorchBlsVerifier() if host_final_exp else
                 TorchBlsVerifier(device=dev, host_final_exp=False,
                                  rng=np.random.default_rng(SEED)))
            for b in GRAPH_BUCKETS:
                summary[f"{name} b{b}"] = warm_graph(v, dev, b, name, card)
            for b in GRAPH_BUCKETS:
                hold_graph(v, dev, *batches[b], f"{name} bucket {b}")
            verifiers[(fused, host_final_exp)] = v
        log("graphs: " + json.dumps({"card": card, "memory_reserved_bytes":
                                     torch.cuda.memory_reserved(dev), "programs": summary}))
    return verifiers


# -- phases 3-5: the fused path ----------------------------------------------


def run_fused(dev, card: str, pool, keys, sets, verifier, cpu_ref):
    """Phases 3-5 through ``verifier``, phase 2b's full-device fused one
    (its graph at bucket 128 made)."""
    from torch.profiler import ProfilerActivity

    from lodestar_tpu_torch.ops import fused_core, fused_verify

    with Phase("3 fused slice"):
        launches = check_verdicts(verifier, sets, "fused", FUSED)
        launch_rows(verifier, sets, ROW_HISTOGRAM, "fused")

        args = fused_verify.from_packed(fused_verify.example_inputs(BUCKET), dev)
        got = bool(fused_verify.verify_signature_sets_fused(*args))
        log(f"fused slice: example_inputs({BUCKET}) through verify_signature_sets_fused -> {got}")
        if got is not True:
            raise AssertionError("the batch-128 example inputs did not verify")

        # the card against the CPU plain versions on a small input (the CPU
        # run made in a host process beside the card's phases)
        small = fused_verify.example_inputs(4)
        f_gpu, ok_gpu = fused_verify.miller_product_fused(*fused_verify.from_packed(small, dev))
        f_cpu, ok_cpu = cpu_ref["fused"].get()
        same = np.array_equal(fused_core.f_canon(f_gpu).cpu().numpy(), f_cpu)
        log(f"fused slice: bucket-4 Miller product, card vs CPU plain: canonical f equal {same}, "
            f"ok {bool(ok_gpu)} / {ok_cpu}")
        if not (same and bool(ok_gpu) and ok_cpu):
            raise AssertionError("the card's Miller product differs from the CPU plain run")

    # fresh signatures; the public keys stay in the point cache, as on a node
    with Phase("4 fused times"):
        fresh = [make_sets(pool, keys, b"timed %d" % r) for r in range(4)]
        rate, dispatch_s = time_batches(verifier, fresh[:3], "fused", card)
    with Phase("5 fused profile"):
        packed = verifier.pack(fresh[3])
        idle = profile_dispatch(packed, verifier, dispatch_s, card, FUSED,
                                "fused", [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        ladder_stretch(packed, dev, card)
        launch_cost(dev, card)
    return launches, rate, idle


# -- phases 6-7: the XLA-graph path -------------------------------------------


def run_xla(dev, card: str, pool, keys, sets, cpu_ref):
    """Phases 6-7 through a full-device XLA-graph verifier.  Phase 6 first
    makes its graph at bucket 128 and holds it as phase 2b holds the fused
    program's, so that the counted batch is a replay."""
    from torch.profiler import ProfilerActivity

    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops import batch_verify, limbs

    with Phase("6 XLA slice"):
        verifier = TorchBlsVerifier(device=dev, fused=False, host_final_exp=False,
                                    rng=np.random.default_rng(SEED + 1))
        name = program_name(False, False)
        warm_graph(verifier, dev, BUCKET, name, card)
        bad = list(sets)
        bad[1] = dataclasses.replace(bad[1], signature=sets[2].signature)
        hold_graph(verifier, dev, verifier.pack(sets), verifier.pack(bad),
                   f"{name} bucket {BUCKET}")
        launches = check_verdicts(verifier, sets, "xla", TOWER)
        launch_rows(verifier, sets, TOWER_HISTOGRAM, "xla")

        small = batch_verify.example_inputs(4)
        f_gpu, ok_gpu = batch_verify.miller_product_kernel(*batch_verify.from_packed(small, dev))
        f_cpu, ok_cpu = cpu_ref["xla"].get()
        same = np.array_equal(limbs.fp_reduce_full(f_gpu).cpu().numpy(), f_cpu)
        log(f"xla slice: bucket-4 Miller product, card vs CPU plain: canonical f equal {same}, "
            f"ok {bool(ok_gpu)} / {ok_cpu}")
        if not (same and bool(ok_gpu) and ok_cpu):
            raise AssertionError("the card's XLA-path Miller product differs from the CPU run")

    with Phase("7 XLA times and profile"):
        fresh = [make_sets(pool, keys, b"xla timed %d" % r) for r in range(4)]
        rate, dispatch_s = time_batches(verifier, fresh[:3], "xla", card)
        idle = profile_dispatch(verifier.pack(fresh[3]), verifier, dispatch_s, card, TOWER,
                                "xla", [ProfilerActivity.CUDA])
    return launches, rate, idle

# -- phase 8: the ring hop kernel ---------------------------------------------


def ring_bound(chunk_bytes: int, cross_card: bool):
    """(bound_ms, "bytes") of one hop: the chunk read and written once on
    one card, or sent once over one NVLink direction."""
    if cross_card:
        return chunk_bytes / NVLINK_BYTES_PER_S * 1e3, "bytes"
    return 2 * chunk_bytes / HBM_BYTES_PER_S * 1e3, "bytes"


def events_ms(streams, fn, reps: int = 20) -> float:
    """Eager time of fn over ``streams`` (every stream forked from and
    joined back into the first), by CUDA events on the first stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    sync_all()
    start.record(streams[0])
    for st in streams[1:]:
        st.wait_event(start)
    for _ in range(reps):
        fn()
    for st in streams[1:]:
        streams[0].wait_stream(st)
    end.record(streams[0])
    sync_all()
    return start.elapsed_time(end) / reps


def check_ring(devices, rng: np.random.Generator, card: str, label: str) -> dict:
    """The ring kernel against its plain version on ``devices`` (one shard
    each; a card may repeat), gather and permute, each ring shape; then its
    times at the (6, 2, 50) chunk."""
    from lodestar_tpu_torch.ops import ring_gather as rg

    n = len(devices)
    streams = [torch.cuda.Stream(device=d) for d in devices]
    err = 0.0
    for shape in RING_SHAPES:
        for _ in range(CHECKS):
            chunks = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(d)
                      for d in devices]
            sync_all()
            got = rg.ring_all_gather(chunks, streams=streams)
            got_p = rg.ring_permute(chunks, streams=streams)
            sync_all()
            want = rg.ring_all_gather_plain(chunks, [torch.empty_like(g) for g in got])
            want_p = rg.ring_permute_plain(chunks)
            for g, w in zip(got + got_p, want + want_p):
                if g.device != w.device or not torch.equal(g, w):
                    raise AssertionError(f"ring {label} n={n} {shape}: kernel differs from plain")
                err = max(err, float((g - w).abs().max()))
    # times at both ring shapes: the GT partial's slot 0 (16-byte aligned)
    # and the verdict bits' slot 1 (8-byte aligned), beside copy_ of the
    # same slots, Tensor.copy_ of a chunk and an empty kernel of one block
    from lodestar_tpu_torch.ops.kernels import _build

    cur = torch.cuda.current_stream(devices[0])
    cross = devices[0] != devices[1 % n]
    lib = _build.load()
    by_shape = {}
    with torch.cuda.device(devices[0]):
        timer = (lambda fn: events_ms([cur], fn)) if cross else graph_ms
        # (an older checkout's library, in a comparison run, has no empty kernel)
        empty = timer(lambda: lib.launch_empty(ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))) if hasattr(lib, "launch_empty") else None
        for shape, slot in zip(RING_SHAPES, (0, 1)):
            chunks = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(d)
                      for d in devices]
            out = [torch.empty((n,) + shape, device=d) for d in devices]
            src, dst = out[0][slot], out[1][slot]
            hop = timer(lambda: rg.launch_hop(src, dst, torch.cuda.current_stream()))
            issue = issue_ms(lambda: rg.launch_hop(src, dst, torch.cuda.current_stream()))
            plain = timer(lambda: dst.copy_(src))
            lib_dst = torch.empty(shape, device=devices[1 % n])
            library = timer(lambda: lib_dst.copy_(chunks[0]))
            b_ms, b_by = ring_bound(4 * int(np.prod(shape)), cross)
            by_shape[str(shape)] = dict(slot=slot, ms=hop, issue_ms=issue, plain_ms=plain,
                                        library_ms=library, bound_ms=b_ms, bound_by=b_by)
            if slot == 0:
                gt_chunks, gt_out = chunks, out
    gt = by_shape[str(RING_SHAPES[0])]
    gather = events_ms(streams, lambda: rg.ring_all_gather(gt_chunks, gt_out, streams))
    plain_gather = events_ms([cur], lambda: rg.ring_all_gather_plain(gt_chunks, gt_out))
    launches = n * n  # n seeds and n (n - 1) hops
    log(f"ring {label} n={n}: gather and permute bitwise equal to plain on {RING_SHAPES}, "
        f"{CHECKS} inputs each; one hop, device ms by shape (slot): "
        + "; ".join(f"{k} ({v['slot']}) {v['ms']:.5f} (eager issue {v['issue_ms']:.5f}, plain "
                    f"copy_ {v['plain_ms']:.5f}, Tensor.copy_ {v['library_ms']:.5f}, bound "
                    f"{v['bound_ms']:.3g} by {v['bound_by']})" for k, v in by_shape.items())
        + f"; an empty kernel of one block {'not in this build' if empty is None else f'{empty:.5f} ms'}"
        f"; one gather of {RING_SHAPES[0]} "
        f"chunks {launches} launches, {gather:.5f} ms eager over {n} streams (plain "
        f"{plain_gather:.5f} ms eager) [{card}]")
    return dict(n=n, max_abs_err=err, ms=gt["ms"], plain_ms=gt["plain_ms"],
                library_ms=gt["library_ms"], bound_ms=gt["bound_ms"], bound_by=gt["bound_by"],
                issue_ms=gt["issue_ms"], empty_ms=empty, by_shape=by_shape, gather_ms=gather,
                plain_gather_ms=plain_gather, launches_per_gather=launches)


def check_hop_offsets(dev, rng: np.random.Generator, card: str, lib=None) -> None:
    """The hop alone against copy_ at chunks of HOP_LENGTHS floats whose
    pointers lie HOP_OFFSETS bytes past a 16-byte boundary (the float4 path
    and the scalar one; an odd slot of the verdict-bits stack is 8-byte
    aligned), nothing written outside the chunk; ``lib``: another build of
    the kernels than the port's."""
    from lodestar_tpu_torch.ops.kernels import _build

    lib = lib or _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    width = max(HOP_LENGTHS) + 8
    for so in HOP_OFFSETS:
        for do in HOP_OFFSETS:
            src = torch.from_numpy(rng.standard_normal(width).astype(np.float32)).to(dev)
            for n in HOP_LENGTHS:
                dst = torch.full((width,), -7.0, device=dev)
                want = dst.clone()
                a, b = (-src.data_ptr() % 16 + so) // 4, (-dst.data_ptr() % 16 + do) // 4
                rc = lib.launch_ring_hop(src.data_ptr() + 4 * a, dst.data_ptr() + 4 * b, n, stream)
                if rc != 0:
                    raise RuntimeError(f"ring hop: launch failed: cudaError {rc}")
                want[b:b + n].copy_(src[a:a + n])
                if not torch.equal(dst, want):
                    raise AssertionError(f"ring hop: {n} floats at offsets {so} -> {do} bytes "
                                         "differ from copy_")
    log(f"ring hop: bitwise equal to copy_ at chunks of 0-40, 600, 1,027 and 4,099 floats at "
        f"source and destination offsets {HOP_OFFSETS} bytes past a 16-byte boundary [{card}]")


def run_ring(dev, card: str) -> dict:
    rng = np.random.default_rng(SEED + 2)
    with Phase("8 ring"):
        check_hop_offsets(dev, rng, card)
        results = {n: check_ring([dev] * n, rng, card, "logical") for n in RING_SHARDS}
        count = torch.cuda.device_count()
        if count >= 2:
            cards = [torch.device("cuda", i) for i in range(min(count, 4))]
            native = {f"{a.index}->{b.index}": torch.cuda.can_device_access_peer(a.index, b.index)
                      for a in cards for b in cards if a != b}
            log(f"ring across {len(cards)} cards: peer access native {json.dumps(native)}")
            results["cards"] = check_ring(cards, rng, card, "cards")
        else:
            log("ring across cards: did not run, 1 card visible")
    return results


# -- phases 9-10: the sharded tier ---------------------------------------------


def busy_ms(prof) -> dict:
    """Per card, the union of the device's busy intervals in a profile
    (kernels and copies on every stream; overlapping intervals count once)."""
    from torch.autograd import DeviceType

    spans = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            spans.setdefault(ev.device_index, []).append((ev.time_range.start, ev.time_range.end))
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    out = {}
    for index, card_spans in sorted(spans.items()):
        card_spans.sort()
        total, (cur_s, cur_e) = 0.0, card_spans[0]
        for s0, e0 in card_spans[1:]:
            if s0 > cur_e:
                total += cur_e - cur_s
                cur_s, cur_e = s0, e0
            else:
                cur_e = max(cur_e, e0)
        out[index] = (total + cur_e - cur_s) / 1e3
    return out


def expect(verifier, sets, want, what: str) -> None:
    """Verify ``sets``; fail unless the verdict is ``want``."""
    t0 = time.perf_counter()
    got = verifier.verify_signature_sets(sets)
    log(f"sharded slice: {what} -> {got} ({time.perf_counter() - t0:.1f} s)")
    if got is not want:
        raise AssertionError(f"sharded: {what} gave {got}, expected {want}")


def mesh_program(verifier, bucket: int):
    return verifier.mesh_programs[("mesh", bucket, verifier.fused, verifier.host_final_exp)]


def warm_mesh(verifier, bucket: int, what: str, card: str) -> dict:
    """``warmup_sharded`` of ``verifier`` at ``bucket``; logs the program's
    eager run, capture and instantiation seconds (summed over its graphs:
    one per shard, one for the combine), the device memory it reserved and
    the port kernels' launches a replay; returns those numbers."""
    sync_all()
    before = torch.cuda.memory_reserved()
    seconds = verifier.warmup_sharded((bucket,))
    sync_all()
    program = mesh_program(verifier, bucket)
    nodes = sum(n for h in program.launch_rows.values() for n in h.values())
    out = dict(warmup_s=seconds, **program.seconds, graphs=len(program.graphs),
               reserved_bytes=torch.cuda.memory_reserved() - before, kernel_launches=nodes)
    log(f"mesh graphs: {what} bucket {bucket}: warmup_sharded {seconds:.3f} s ("
        f"{len(program.graphs)} graphs: eager run {program.seconds['eager']:.3f} s, capture "
        f"{program.seconds['capture']:.3f} s, instantiation {program.seconds['instantiate']:.3f} "
        f"s), device memory reserved +{out['reserved_bytes']} B, {nodes} port kernel launches "
        f"a replay [{card}]")
    return out


def replay_mesh_against_eager(verifier, packed, what: str, split_ref=None):
    """One packed batch through the eager ``ShardedProgram`` over the
    verifier's shards (every counter 0 just before) and through the
    verifier's ``MeshProgram`` at its bucket (the same): fails unless the
    outputs (f's digits and ok, or the verdict) are bitwise equal and every
    kernel, the ring hop included, was launched as often.  ``split_ref``,
    for a full-device verifier: the eager split entry's run of the same
    batch over the same shards (its program, outputs and launches), whose
    ``final_verdict`` is the full entry's tail, so that the eager tier runs
    once for both modes.  Returns (the verdict, this eager split run's
    reference, or None)."""
    from lodestar_tpu_torch.crypto.bls.bucket_program import _tensors
    from lodestar_tpu_torch.ops import fused_core, sharded_verify

    entry = (sharded_verify.miller_product_sharded if verifier.host_final_exp
             else sharded_verify.verify_signature_sets_sharded)
    program = mesh_program(verifier, packed[0].shape[0])
    sync_all()
    fused_core.reset_launch_counts()
    if split_ref is None:
        eager = entry(verifier.devices, verifier.fused, verifier.sharded_combine)
        outs = eager(*packed)
        before = {}
    else:
        eager, (f, ok), before = split_ref
        outs = sharded_verify.final_verdict(eager.mesh, verifier.fused, f, ok)
    want = [t.cpu() for t in _tensors(outs)]
    sync_all()
    eager_launches = {name: k.launches + before.get(name, 0)
                      for name, k in fused_core.COUNTED.items()}
    fused_core.reset_launch_counts()
    got, ready = program.run(packed)
    ready.synchronize()
    replayed = {name: k.launches for name, k in fused_core.COUNTED.items()}
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    verdicts = tuple(verdict_of(outs, verifier.host_final_exp) for outs in (got, want))
    log(f"mesh graphs: {what}: replay against the eager ShardedProgram, outputs bitwise equal "
        f"{same}, verdicts {verdicts}, launches equal {replayed == eager_launches} "
        f"({sum(eager_launches.values())} launches, ring_hop {replayed['ring_hop']})")
    if not same or replayed != eager_launches or verdicts[0] != verdicts[1]:
        raise AssertionError(f"mesh graphs: {what}: the replay differs from the eager run "
                             f"(launches {replayed} against {eager_launches})")
    ref = (eager, outs, eager_launches) if verifier.host_final_exp else None
    return verdicts[0], ref


def hold_mesh(verifier, packed, what: str, want: bool = True, split_ref=None):
    """``replay_mesh_against_eager``; fails unless the verdict is ``want``;
    returns the eager split run's reference (None in the full mode)."""
    got, ref = replay_mesh_against_eager(verifier, packed, what, split_ref)
    if got is not want:
        raise AssertionError(f"mesh graphs: {what}: the verdict is not {want}")
    return ref


def in_flight(verifier, valid, bad, what: str) -> None:
    """A valid and a corrupted batch in flight at once, read in reverse."""
    first, second = verifier.dispatch(valid), verifier.dispatch(bad)
    got = (second.result(), first.result())
    log(f"sharded slice: {what}: two batches in flight, valid then corrupted, read in "
        f"reverse order -> {got}")
    if got != (False, True):
        raise AssertionError(f"sharded: {what}: the batches in flight gave {got}")


def corrupt(sets, i: int, j: int):
    bad = list(sets)
    bad[i] = dataclasses.replace(bad[i], signature=sets[j].signature)
    return bad


def run_sharded(dev, card: str, sets, cpu_ref, xla_modes=(True, False)):
    """Phase 9: every sharded batch a replay of the verifier's per-bucket
    ``MeshProgram``.  ``xla_modes``: the XLA-graph flavour's modes, each a
    ``host_final_exp`` (the full run keeps only the full-device one, whose
    launches are counted).  Returns (the full-device fused verifier over 2
    shards, its counted batch's launches, the XLA-graph flavour's, the
    split verifiers over 2 and 4 shards for phase 11)."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops import fused_core, fused_verify
    from lodestar_tpu_torch.ops.ring_gather import ring_all_gather
    from lodestar_tpu_torch.ops.sharded_verify import Mesh, miller_product_sharded

    fused = FUSED + ("ring_hop",)
    logical = [dev, dev]

    def tier(devices, seed, **kw):
        kw.setdefault("sharded_min_batch", SHARDED_BUCKET)
        kw.setdefault("host_final_exp", False)
        return TorchBlsVerifier(devices=devices, sharded=True,
                                rng=np.random.default_rng(SEED + seed), **kw)

    with Phase("9 sharded slice"):
        verifier = tier(logical, 3)
        four = tier([dev] * 4, 4)
        summary = {}
        for name, v in (("fused full-device, 2 shards", verifier),
                        ("fused full-device, 4 shards", four)):
            summary[name] = warm_mesh(v, SHARDED_BUCKET, name, card)
        valid = verifier.pack(sets)
        live150 = four.pack(sets[:150])
        hold_mesh(verifier, valid, "fused full-device, 2 shards, 256 valid")
        hold_mesh(four, live150, "fused full-device, 4 shards, 150 live (shard 3 all padding)")

        fused_core.reset_launch_counts()
        t0 = time.perf_counter()
        ok = verifier.verify_signature_sets(sets)
        first_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in fused_core.COUNTED.items()}
        log(f"sharded slice: valid batch of {len(sets)} over {verifier.mesh_devices} logical "
            f"shards -> {ok} (a replay, {first_s:.3f} s, sharded batches "
            f"{verifier.sharded_batches}); launches per batch {json.dumps(launches)}")
        if ok is not True or verifier.sharded_batches != 1:
            raise AssertionError("sharded: a valid batch of 256 did not verify on the mesh")
        idle = [name for name in fused if launches[name] == 0]
        if idle:
            raise AssertionError(f"sharded: kernels never launched on the path: {idle}")
        expect(verifier, corrupt(sets, 5, 6), False, "one corrupted signature")
        outside = list(sets)
        outside[130] = dataclasses.replace(outside[130], signature=non_subgroup_signature())
        expect(verifier, outside, False, "a signature outside G2 in shard 1")
        expect(four, sets[:150], True,
               "150 live sets at bucket 256 over 4 shards (shard 3 all padding)")
        in_flight(verifier, valid, verifier.pack(corrupt(sets, 200, 201)), "fused, 2 shards")
        if four.sharded_batches != 1 or verifier.sharded_batches != 5:
            raise AssertionError("sharded: a batch of 256 did not ride the mesh")

        # the split mode (phase 11 verifies through these)
        split2 = tier(logical, 31, host_final_exp=True)
        split4 = tier([dev] * 4, 33, host_final_exp=True)
        for name, v, packed in (("fused split, 2 shards", split2, valid),
                                ("fused split, 4 shards", split4, live150)):
            summary[name] = warm_mesh(v, SHARDED_BUCKET, name, card)
            hold_mesh(v, packed, name)

        ring = tier(logical, 5, sharded_combine="ring")
        summary["fused full-device ring, 2 shards"] = warm_mesh(ring, SHARDED_BUCKET,
                                                                "ring combine", card)
        hold_mesh(ring, valid, "ring combine, 2 shards, 256 valid")

        # the XLA-graph flavour at bucket 16 over 2 shards, in each of
        # ``xla_modes``: the split mode's eager run is the full mode's
        # reference too (its final exponentiation added), the eager tier
        # costing ~20-30 s a run
        small, bad16 = sets[:XLA_SHARDED_BUCKET], corrupt(sets[:XLA_SHARDED_BUCKET], 3, 4)
        xla_launches, ref, packed16 = None, None, verifier.pack(small)
        for host_final_exp in xla_modes:
            name = f"xla {'split' if host_final_exp else 'full-device'}, 2 shards"
            xla = tier(logical, 6 + 30 * host_final_exp, fused=False,
                       sharded_min_batch=XLA_SHARDED_BUCKET, host_final_exp=host_final_exp)
            summary[name] = warm_mesh(xla, XLA_SHARDED_BUCKET, name, card)
            ref = hold_mesh(xla, packed16, name, split_ref=ref)
            if not host_final_exp:
                fused_core.reset_launch_counts()
                expect(xla, small, True, f"XLA-graph flavour, bucket {XLA_SHARDED_BUCKET}, valid")
                xla_launches = {name: k.launches for name, k in fused_core.COUNTED.items()}
                log(f"sharded slice: XLA-graph flavour launches per batch "
                    f"{json.dumps(xla_launches)}")
                idle = [n for n in TOWER + ("ring_hop",) if xla_launches[n] == 0]
                if idle:
                    raise AssertionError(f"sharded XLA-graph: kernels never launched on the "
                                         f"path: {idle}")
            expect(xla, bad16, False, f"{name}, bucket {XLA_SHARDED_BUCKET}, corrupted")
            if xla.sharded_batches != 1 + (not host_final_exp):
                raise AssertionError("sharded: the XLA-graph batches did not ride the mesh")
        log("mesh graphs: " + json.dumps({"card": card, "programs": summary}))

        # the gathered partials on every shard, and the card against the CPU
        t0 = time.perf_counter()
        small = fused_verify.example_inputs(8)
        mesh = Mesh(logical)
        parts = mesh.map(lambda s, sl: fused_verify.miller_product_parts(
            *fused_verify.from_packed(sl, mesh.devices[s]))[0].a.contiguous(), mesh.split(small))
        stacks = ring_all_gather(parts, streams=mesh.streams)
        sync_all()
        same_reps = all(torch.equal(st, torch.stack(parts)) for st in stacks)
        f_gpu, ok_gpu = miller_product_sharded(logical, fused=True)(*small)
        f_cpu, ok_cpu = cpu_ref["sharded"].get()
        same = np.array_equal(fused_core.f_canon(fused_core.lv(f_gpu)).cpu().numpy(), f_cpu)
        log(f"sharded slice: bucket-8 Miller partials all-gathered, every shard's stack "
            f"bitwise equal {same_reps}; the sharded product, card vs CPU plain (run beside "
            f"the card's phases in a host process): canonical f equal {same}, ok "
            f"{bool(ok_gpu)} / {ok_cpu} ({time.perf_counter() - t0:.1f} s)")
        if not (same and same_reps and bool(ok_gpu) and ok_cpu):
            raise AssertionError("sharded: the card's Miller product differs from the CPU run")

        count = torch.cuda.device_count()
        if count >= 2:
            cards = [torch.device("cuda", i) for i in range(2)]
            two = tier(cards, 7)
            warm_mesh(two, SHARDED_BUCKET, "fused full-device, cuda:0 and cuda:1", card)
            hold_mesh(two, two.pack(sets), "fused full-device, cuda:0 and cuda:1, 256 valid")
            expect(two, sets, True, "valid batch on cuda:0 and cuda:1")
            expect(two, corrupt(sets, 200, 201), False, "corrupted batch on cuda:0 and cuda:1")
        else:
            log("sharded slice: the cross-card batches did not run, 1 card visible")
    return verifier, launches, xla_launches, {2: split2, 4: split4}


def profile_sharded(verifier, packed, dispatch_s: float, card: str, path: str) -> float:
    """One dispatch under torch.profiler (device activity): each card's
    busy time is the union of its intervals, as the shards' streams
    overlap.  Returns the mean over the cards of the idle share of the
    best unprofiled dispatch."""
    from torch.profiler import ProfilerActivity, profile

    sync_all()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = verifier.dispatch(packed).result()
        sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        raise AssertionError(f"{path}: the profiled batch did not verify")
    busy = busy_ms(prof)
    idle = {i: 1.0 - b / (dispatch_s * 1e3) for i, b in busy.items()}
    log(f"{path} profile: " + json.dumps({
        "card": card, "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": {i: 1.0 - b / wall_ms for i, b in busy.items()},
        "unprofiled_dispatch_ms": dispatch_s * 1e3,
        "device_idle_share_unprofiled": idle}))
    return sum(idle.values()) / len(idle)


def time_single_card(dev, fresh, warm, card: str) -> float:
    """The same fresh batches of 256 through one card as two chunks of
    128, packed and dispatched one after the other, both verdicts read at
    the end (the public keys cached first); returns the best sets/s."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    single = TorchBlsVerifier(device=dev, rng=np.random.default_rng(SEED + 8),
                              host_final_exp=False)
    single.warmup((BUCKET,))
    for half in (warm[:BUCKET], warm[BUCKET:]):
        single.pack(half)
    walls = []
    for batch in fresh:
        sync_all()
        t0 = time.perf_counter()
        verdicts = [single.dispatch(single.pack(half)) for half in (batch[:BUCKET], batch[BUCKET:])]
        ok = all([v.result() for v in verdicts])
        sync_all()
        walls.append(time.perf_counter() - t0)
        if not ok:
            raise AssertionError("single card: a timed batch did not verify")
    rate = len(fresh[0]) / min(walls)
    log(f"single-card times: {len(fresh[0])} fresh sets as 2 x {BUCKET}, best of {len(walls)}: "
        f"{min(walls)} s = {rate} sets/s; all walls {walls} [{card}]")
    return rate


def run_sharded_times(dev, card: str, verifier, pool, keys, sets) -> dict:
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    out = {}
    with Phase("10 sharded times"):
        fresh = [make_sets(pool, keys, b"sharded timed %d" % r) for r in range(4)]
        walls = lambda: f"shard enqueue walls {verifier.shard_enqueue_walls} s"  # noqa: E731
        rate, dispatch_s = time_batches(verifier, fresh[:3], "sharded", card, after=walls)
        idle = profile_sharded(verifier, verifier.pack(fresh[3]), dispatch_s, card, "sharded")
        single = time_single_card(dev, fresh[:3], sets, card)
        out["logical2"] = dict(rate=rate, idle=idle, single=single)
        log(f"sharded times: 2 logical shards on one card {rate} sets/s, one card as 2 x "
            f"{BUCKET} {single} sets/s, ratio {rate / single} [{card}]")
        count = torch.cuda.device_count()
        for k in (2, 4):
            if count < k:
                log(f"sharded times: {k} cards did not run, {count} visible")
                continue
            cards = [torch.device("cuda", i) for i in range(k)]
            v = TorchBlsVerifier(devices=cards, sharded=True,
                                 rng=np.random.default_rng(SEED + 9 + k), host_final_exp=False)
            v.pack(sets)  # the public keys cached, as on a node
            r_k, d_k = time_batches(v, fresh[:3], f"sharded {k} cards", card,
                                    after=lambda: f"shard enqueue walls {v.shard_enqueue_walls} s")
            idle_k = profile_sharded(v, v.pack(fresh[3]), d_k, card, f"sharded {k} cards")
            eff = r_k / (k * single)
            log(f"sharded times: {k} cards {r_k} sets/s, scaling efficiency {eff} "
                f"(over {k} x the one-card rate) [{card}]")
            out[f"cards{k}"] = dict(rate=r_k, idle=idle_k, efficiency=eff)
    return out


# -- phases 11-12: the split dispatch and the pool -----------------------------


def time_split(verifier, fresh, card: str):
    """Each fresh batch packed, its device Miller product enqueued, the
    event after the copies of ok and f to the host waited on (the sync),
    f's host copy read and finished by the host C final exponentiation,
    on the host clock (the last three from the verifier's stage clocks);
    returns (sets/s of the best batch, its stages)."""
    rows = []
    for r, batch in enumerate(fresh):
        sync_all()
        before = dict(verifier.stage_seconds)
        t0 = time.perf_counter()
        packed = verifier.pack(batch)
        t1 = time.perf_counter()
        pending = verifier.dispatch(packed)
        t2 = time.perf_counter()
        ok = pending.result()
        t3 = time.perf_counter()
        if ok is not True:
            raise AssertionError(f"split: timed batch {r} did not verify")
        st = {k: verifier.stage_seconds[k] - before[k] for k in ("sync", "readback", "final_exp")}
        rows.append(dict(wall=t3 - t0, pack=t1 - t0, enqueue=t2 - t1, sync_ok=st["sync"],
                         device_miller=t2 - t1 + st["sync"], readback=st["readback"],
                         host_final_exp=st["final_exp"]))
        log(f"split times: batch {r} " + json.dumps(rows[-1]))
    best = min(rows, key=lambda x: x["wall"])
    rate = len(fresh[0]) / best["wall"]
    log(f"split times: batch of {len(fresh[0])} fresh signatures, best of {len(rows)}: "
        f"{best['wall']} s = {rate} sets/s (pack {best['pack']} s, device Miller product "
        f"{best['device_miller']} s = enqueue {best['enqueue']} s + sync on ok "
        f"{best['sync_ok']} s, readback {best['readback']} s, host final exponentiation "
        f"{best['host_final_exp']} s) [{card}]")
    return rate, best


def launch_rows(verifier, sets, names, path: str) -> dict:
    """One batch through ``verifier`` (a replay of its program at the
    batch's bucket), and the row count of each launch of kernels ``names``
    in it, from the record its capture made (a replay calls no wrapper);
    logs and returns {name: {rows: launches}}."""
    if verifier.verify_signature_sets(sets) is not True:
        raise AssertionError(f"{path} launch rows: the batch did not verify")
    program = verifier.programs[(verifier.device, verifier._bucket(len(sets)), verifier.fused,
                                 verifier.host_final_exp)]
    hist = {name: dict(sorted(program.launch_rows.get(name, {}).items())) for name in names}
    log(f"{path} launch rows (rows: launches) of a batch of {len(sets)}, from its graph's "
        "capture: " + json.dumps(hist))
    return hist


def run_split(dev, card: str, pool, keys, sets, sets256, verifiers, tiers=None) -> dict:
    """Phase 11 through phase 2b's split verifier, the default one (the
    fused program, its graph at bucket 128 made), an XLA-graph one (its
    graph made and held here at bucket SPLIT_XLA_BUCKET) and the sharded
    split verifiers over 2 and 4 shards (``tiers``, phase 9's, their
    programs made; made here when phase 9 did not run)."""
    from torch.profiler import ProfilerActivity

    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops import fused_core

    out = {}
    with Phase("11 split"):
        verifier = verifiers[(True, True)]
        if verifier.device != dev or not verifier.host_final_exp:
            raise AssertionError(f"split: the default verifier is {verifier.device}, "
                                 f"host_final_exp={verifier.host_final_exp}")
        out["launches"] = check_verdicts(verifier, sets, "split", FUSED)
        out["launch_rows"] = launch_rows(verifier, sets, ROW_HISTOGRAM, "split")
        fresh = [make_sets(pool, keys[:BUCKET], b"split timed %d" % r) for r in range(3)]
        out["rate"], out["stages"] = time_split(verifier, fresh, card)
        # the device's idle share over the best device Miller product
        out["idle"] = profile_dispatch(verifier.pack(fresh[0]), verifier,
                                       out["stages"]["device_miller"], card, FUSED, "split",
                                       [ProfilerActivity.CPU, ProfilerActivity.CUDA])

        xla = TorchBlsVerifier(fused=False, rng=np.random.default_rng(SEED + 30))
        name = program_name(False, True)
        warm_graph(xla, dev, SPLIT_XLA_BUCKET, name, card)
        small = sets[:SPLIT_XLA_BUCKET]
        hold_graph(xla, dev, xla.pack(small), xla.pack(corrupt(small, 1, 2)),
                   f"{name} bucket {SPLIT_XLA_BUCKET}")
        launch_rows(xla, small, TOWER_HISTOGRAM, "split xla")
        fused_core.reset_launch_counts()
        t0 = time.perf_counter()
        got = xla.verify_signature_sets(small)
        launches = {name: k.launches for name, k in fused_core.COUNTED.items()}
        log(f"split xla: valid batch of {len(small)} -> {got} ({time.perf_counter() - t0:.1f} s); "
            f"launches per batch {json.dumps(launches)}")
        idle = [name for name in XLA_SPLIT if launches[name] == 0]
        if got is not True or idle:
            raise AssertionError(f"split xla: verdict {got}, kernels never launched {idle}")
        out["xla_launches"] = launches
        bad = list(small)
        bad[3] = dataclasses.replace(bad[3], signature=sets[4].signature)
        got = xla.verify_signature_sets(bad)
        log(f"split xla: one corrupted signature -> {got}")
        if got is not False:
            raise AssertionError("split xla: a corrupted batch verified")

        if tiers is None:
            tiers = {}
            for n, seed in ((2, 31), (4, 33)):
                tiers[n] = TorchBlsVerifier(devices=[dev] * n, sharded=True,
                                            sharded_min_batch=SHARDED_BUCKET,
                                            rng=np.random.default_rng(SEED + seed))
                warm_mesh(tiers[n], SHARDED_BUCKET, f"fused split, {n} shards", card)
        mesh, four = tiers[2], tiers[4]
        riding = (mesh.sharded_batches, four.sharded_batches)
        fused_core.reset_launch_counts()
        expect(mesh, sets256, True, "split, 2 logical shards, valid batch of 256")
        launches = {name: k.launches for name, k in fused_core.COUNTED.items()}
        idle = [name for name in FUSED + ("ring_hop",) if launches[name] == 0]
        if idle or mesh.sharded_batches != 1:
            raise AssertionError(f"split sharded: kernels never launched {idle}, "
                                 f"sharded batches {mesh.sharded_batches}")
        out["sharded_launches"] = launches
        bad = list(sets256)
        bad[200] = dataclasses.replace(bad[200], signature=sets256[201].signature)
        expect(mesh, bad, False, "split, 2 logical shards, one corrupted signature")
        outside = list(sets256)
        outside[130] = dataclasses.replace(outside[130], signature=non_subgroup_signature())
        finished = mesh.host_final_exps
        expect(mesh, outside, False, "split, 2 logical shards, a signature outside G2 in shard 1")
        if mesh.host_final_exps != finished:
            raise AssertionError("split sharded: the host final exponentiation ran although "
                                 "the combined ok bits were False")
        expect(four, sets256[:150], True,
               "split, 150 live sets at bucket 256 over 4 shards (shard 3 all padding)")
        if (mesh.sharded_batches - riding[0], four.sharded_batches - riding[1]) != (3, 1):
            raise AssertionError("split sharded: a batch of 256 did not ride the mesh")
        timed = make_sets(pool, keys, b"split sharded timed")
        mesh_rate, mesh_stages = time_split(mesh, [timed], card)
        out["sharded_rate"], out["sharded_stages"] = mesh_rate, mesh_stages
        log(f"split sharded: {mesh_rate} sets/s at bucket {SHARDED_BUCKET} over 2 logical "
            f"shards, enqueue walls {mesh.shard_enqueue_walls} s [{card}]")
        if torch.cuda.device_count() >= 2:
            cards = [torch.device("cuda", i) for i in range(2)]
            two = TorchBlsVerifier(devices=cards, sharded=True,
                                   rng=np.random.default_rng(SEED + 32))
            expect(two, sets256, True, "split, valid batch on cuda:0 and cuda:1")
            expect(two, bad, False, "split, corrupted batch on cuda:0 and cuda:1")
        else:
            log("split sharded: the cross-card batches did not run, 1 card visible")
    return out


def overlap_share(spans, k: int = 2) -> float:
    """The share of the wall from the first span's start to the last's end
    in which at least k spans were open."""
    edges = sorted([(t0, 1) for t0, _ in spans] + [(t1, -1) for _, t1 in spans])
    wall = edges[-1][0] - edges[0][0]
    open_, covered, last = 0, 0.0, edges[0][0]
    for t, d in edges:
        if open_ >= k:
            covered += t - last
        open_ += d
        last = t
    return covered / wall if wall > 0 else 0.0


async def _pool_rounds(pool, gossip, block, retry_jobs, late):
    from lodestar_tpu_torch.crypto.bls.verifier import (
        SignatureSetPriority,
        VerificationDroppedError,
    )

    t0 = time.perf_counter()
    results = await asyncio.gather(
        *[pool.verify_signature_sets(job) for job in gossip],
        pool.verify_signature_sets(block, priority=SignatureSetPriority.BLOCK_PROPOSAL))
    wall = time.perf_counter() - t0
    spans = list(pool.batch_spans)
    t1 = time.perf_counter()
    retried = await asyncio.gather(*[pool.verify_signature_sets(job) for job in retry_jobs])
    retry_wall = time.perf_counter() - t1
    try:
        await pool.verify_signature_sets(late, deadline=time.monotonic() - 1.0)
        dropped = None
    except VerificationDroppedError as e:
        dropped = e.reason
    return results, wall, spans, retried, retry_wall, dropped


def gossip_jobs(sets):
    """Gossip-sized jobs of 1, 2, 3, 2, 1, 2, 3, ... sets."""
    jobs, i = [], 0
    while i < len(sets):
        size = (1, 2, 3, 2)[len(jobs) % 4]
        jobs.append(sets[i:i + size])
        i += size
    return jobs


async def _verify_all(pool, jobs):
    return await asyncio.gather(*[pool.verify_signature_sets(job) for job in jobs])


def run_pool_sharded(dev, card: str, sets256) -> dict:
    """A pool over 2 logical shards of the card: with the tier active the
    merge cap is 2 x BUCKET, so the gossip jobs of 256 sets merge into
    batches that ride the sharded tier; two 128-set jobs, one holding a
    corrupted set, ride it merged and are then retried one by one."""
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    mesh = TorchBlsVerifier(devices=[dev, dev], sharded=True, sharded_min_batch=SHARDED_BUCKET,
                            rng=np.random.default_rng(SEED + 34))
    mesh.warmup((BUCKET,))  # the retried 128-set jobs ride the card's graph
    mesh.warmup_sharded((SHARDED_BUCKET,))  # the merged batches ride the mesh's
    bls = BlsBatchPool(mesh, pipeline_depth=2, flush_threshold=BUCKET, max_buffer_wait=0.02)
    if not mesh.sharded_active or bls._flush_window()[1] != 2 * BUCKET:
        raise AssertionError(f"pool sharded: tier active {mesh.sharded_active}, merge cap "
                             f"{bls._flush_window()[1]}")
    jobs = gossip_jobs(sets256)
    t0 = time.perf_counter()
    results = asyncio.run(_verify_all(bls, jobs))
    wall = time.perf_counter() - t0
    riding, batches = mesh.sharded_batches, len(bls.batch_spans)
    bad = list(sets256[BUCKET:])
    bad[-1] = dataclasses.replace(bad[-1], signature=sets256[0].signature)
    retried = asyncio.run(_verify_all(bls, [sets256[:BUCKET], bad]))
    bls.close()
    mesh.close()
    log(f"pool sharded: {len(jobs)} gossip jobs ({len(sets256)} sets) over 2 logical shards "
        f"-> all True {all(r is True for r in results)} in {wall} s, "
        f"{batches} batches, sharded batches {riding}; two {BUCKET}-set jobs, the second "
        f"holding a corrupted set -> {retried} (sharded batches "
        f"{mesh.sharded_batches}, batch retries {bls.batch_retries}) [{card}]")
    if not all(r is True for r in results) or len(results) != len(jobs) or riding < 1:
        raise AssertionError("pool sharded: the gossip jobs did not all verify on the tier")
    if retried != [True, False] or bls.batch_retries != 1 or mesh.sharded_batches <= riding:
        raise AssertionError("pool sharded: the merged batch with a corrupted set did not "
                             "ride the tier and isolate its job")
    return dict(wall=wall, batches=batches, sharded_batches=riding)


def run_pool(dev, card: str, pool, keys, sets256) -> dict:
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops import fused_core

    with Phase("12 pool"):
        verifier = TorchBlsVerifier()
        sync_all()
        before = torch.cuda.memory_reserved(dev)
        seconds = verifier.warmup()
        log(f"pool: warmup of buckets {verifier.buckets} {seconds:.3f} s, device memory "
            f"reserved +{torch.cuda.memory_reserved(dev) - before} B "
            + json.dumps({b: p.seconds for (_, b, _, _), p in verifier.programs.items()}))
        fresh = (make_sets(pool, keys, b"pool 0") + make_sets(pool, keys, b"pool 1"))[:POOL_SETS]
        block = make_sets(pool, keys[:POOL_BLOCK_SETS], b"pool block")
        verifier.pack(fresh[:BUCKET])  # the public keys cached, as on a node
        verifier.pack(fresh[BUCKET:2 * BUCKET])
        gossip = gossip_jobs(fresh)
        retry_sets = make_sets(pool, keys[:8], b"pool retry")
        retry_sets[5] = dataclasses.replace(retry_sets[5], signature=retry_sets[6].signature)
        retry_jobs = [retry_sets[j:j + 2] for j in range(0, 8, 2)]  # job 2 holds the bad set
        bls = BlsBatchPool(verifier, pipeline_depth=2, flush_threshold=BUCKET,
                           max_buffer_wait=0.02)
        sync_all()
        fused_core.reset_launch_counts()
        results, wall, first, retried, retry_wall, dropped = asyncio.run(
            _pool_rounds(bls, gossip, block, retry_jobs, fresh[:2]))
        bls.close()
        n_sets = len(fresh) + len(block)
        launches = {name: k.launches for name, k in fused_core.COUNTED.items()}
        share = overlap_share(first)
        rate = n_sets / wall
        log(f"pool: {len(gossip)} gossip jobs ({len(fresh)} sets) and one block-proposal job "
            f"({len(block)} sets) -> all True {all(r is True for r in results)}; {rate} sets/s "
            f"({wall} s), {len(first)} batches flushed, inflight peak {bls.inflight_peak}, "
            f"two batches' host spans (pack start to verdict) open {share} of the wall; "
            f"launches {json.dumps(launches)} [{card}]")
        if not all(r is True for r in results) or len(results) != len(gossip) + 1:
            raise AssertionError("pool: a valid job did not verify")
        idle = [name for name in FUSED if launches[name] == 0]
        if idle:
            raise AssertionError(f"pool: kernels never launched on the path: {idle}")
        log(f"pool: retry round, 4 jobs, job 2 holds a corrupted set -> {retried} "
            f"({retry_wall} s, batch retries {bls.batch_retries})")
        if retried != [True, True, False, True] or bls.batch_retries != 1:
            raise AssertionError("pool: the retry round did not isolate the corrupted job")
        log(f"pool: a job past its deadline -> dropped ({dropped}); dropped sets "
            f"{dict((f'{r}/{ln}', n) for (r, ln), n in bls.dropped_sets.items())}")
        if dropped != "deadline":
            raise AssertionError("pool: an expired job was not dropped")
        run_pool_sharded(dev, card, sets256)
    return dict(rate=rate, batches=len(first), inflight_peak=bls.inflight_peak,
                overlap_share=share, launches=launches)



# -- phase 13: health, quarantine and requeue ----------------------------------

HEALTH_BACKOFF_S = 0.5  # phase 13's quarantine backoff
WEDGE_S = 0.5  # the injected wedge
WATCHDOG_S = 0.2  # the watchdog's deadline, inside the wedge


def _journal_since(seq0: int, kind: str):
    from lodestar_tpu_torch.forensics import JOURNAL

    return [e for e in JOURNAL.events() if e["seq"] >= seq0 and e["kind"] == kind]


def _timed_batch(verifier, packed):
    """One packed batch, dispatch to verdict on the host clock: (verdict,
    the executor it landed on, seconds)."""
    sync_all()
    t0 = time.perf_counter()
    pending = verifier.dispatch(packed)
    ok = pending.result()
    return ok, pending.device, time.perf_counter() - t0


def _bundles(base: str, prefix: str):
    """(directory, manifest) of each complete bundle under ``base`` whose
    name starts with ``bundle-<prefix>``."""
    out = []
    for name in sorted(os.listdir(base)):
        path = os.path.join(base, name)
        if name.startswith("bundle-" + prefix) and os.path.exists(
                os.path.join(path, "manifest.json")):
            with open(os.path.join(path, "manifest.json")) as f:
                out.append((path, json.load(f)))
    return out


def health_requeue(dev, card: str, sets) -> dict:
    """Phase 13, steps 1-2: on two executors of the card, two plain
    batches, a loss on ``cuda:0`` requeued (every fused kernel launched
    twice a batch's count), its quarantine bundle, three batches on the
    other executor, the probe that re-admits ``cuda:0``, two batches in
    flight on the two executors bitwise equal, and a corrupted batch
    lost and requeued."""
    from lodestar_tpu_torch.chaos import CHAOS, PLAN_ENV, FaultPlan, install_from_env
    from lodestar_tpu_torch.crypto.bls.torch_verifier import (
        HEALTHY,
        PROBING,
        QUARANTINED,
        TorchBlsVerifier,
    )
    from lodestar_tpu_torch.forensics import JOURNAL, RECORDER
    from lodestar_tpu_torch.ops import fused_core

    first, second = str(dev), f"{dev}#1"
    v = TorchBlsVerifier(devices=[dev, dev], quarantine_threshold=1,
                         quarantine_backoff_s=HEALTH_BACKOFF_S,
                         rng=np.random.default_rng(SEED + 50))
    RECORDER.configure(verifier=v)
    warm = v.warmup((BUCKET,))
    bad = list(sets)
    bad[1] = dataclasses.replace(bad[1], signature=sets[2].signature)
    valid, corrupted = v.pack(sets), v.pack(bad)
    # two plain batches, one on each executor: a batch's launches and wall
    walls, plain = [], None
    for want in (first, second):
        fused_core.reset_launch_counts()
        ok, landed, seconds = _timed_batch(v, valid)
        plain = plain or {name: k.launches for name, k in fused_core.COUNTED.items()}
        walls.append(seconds)
        if ok is not True or landed != want:
            raise AssertionError(f"health: a plain batch landed on {landed} -> {ok}")
    plain_s = min(walls)
    seq0 = JOURNAL.seq
    # 1. a loss on cuda:0, armed as a node would arm it, from the plan's JSON;
    # the placement's cursor is back at cuda:0
    plan = FaultPlan(SEED).add("device.loss", match={"device": first}, count=1)
    if not install_from_env({PLAN_ENV: plan.to_json()}):
        raise AssertionError("health: the fault plan did not arm")
    sync_all()
    fused_core.reset_launch_counts()
    ok, _, requeued_s = _timed_batch(v, valid)
    lost = {name: k.launches for name, k in fused_core.COUNTED.items()}
    CHAOS.disarm()
    landed = [e["device"] for e in _journal_since(seq0, "bls.dispatch")]
    requeues = _journal_since(seq0, "bls.requeue")
    state = v.executor_health()[first]["state"]
    bundles = [m for _, m in _bundles(RECORDER.dir, "quarantine-")
               if m["reason"] == f"quarantine-{first}"]
    log(f"health: a valid batch of {len(sets)} lost on {first} -> {ok} after its requeue "
        f"(dispatched on {landed}; {requeued_s} s dispatch to verdict, a plain batch "
        f"{walls} s); batches_requeued {v.batches_requeued}, journal bls.requeue from "
        f"{[e['from_device'] for e in requeues]}, {first} {state}, quarantine bundles "
        f"{len(bundles)} (files {bundles[0]['files'] if bundles else None})")
    if (ok is not True or landed != [first, second] or v.batches_requeued != 1
            or [e["from_device"] for e in requeues] != [first] or state != QUARANTINED
            or len(bundles) != 1):
        raise AssertionError("health: the lost batch was not requeued, or cuda:0 not "
                             "quarantined with its bundle")
    twice = {name: (lost[name], plain[name]) for name in FUSED}
    log(f"health: launches of the lost and requeued batch against one batch's "
        f"{json.dumps(twice)}")
    bad_counts = [n for n, (a, b) in twice.items() if b == 0 or a != 2 * b]
    if bad_counts:
        raise AssertionError(f"health: the lost batch's launches are not twice one batch's "
                             f"for {bad_counts}")
    # 2. three batches dispatched at once during the quarantine: all on cuda:0#1
    during = [v.dispatch(valid) for _ in range(3)]
    placed = [p.device for p in during]
    got = [p.result() for p in during]
    log(f"health: three batches during {first}'s quarantine -> on {placed}, {got}")
    if placed != [second] * 3 or got != [True] * 3:
        raise AssertionError("health: a batch landed on the quarantined executor")
    t_quarantined = time.perf_counter()
    time.sleep((v.executor_health()[first]["readmission_in_s"] or 0.0) + 0.01)
    probe_s, tries = None, 0
    while v.executor_health()[first]["state"] != HEALTHY and tries < 3:
        tries += 1
        ok, landed, seconds = _timed_batch(v, valid)
        if ok is not True:
            raise AssertionError("health: a batch after the backoff did not verify")
        if landed == first:
            probe_s = seconds
    readmitted_s = time.perf_counter() - t_quarantined
    health = [e for e in _journal_since(seq0, "bls.health") if e["device"] == first]
    states = [e["state"] for e in health]
    readmitted = any(e.get("readmitted") for e in health)
    log(f"health: after the {HEALTH_BACKOFF_S} s backoff, {tries} batch(es) to the probe on "
        f"{first} ({probe_s} s dispatch to verdict), {first} "
        f"{v.executor_health()[first]['state']} {readmitted_s} s after the quarantined "
        f"batches; {first}'s journal states {states}, readmitted {readmitted}")
    if probe_s is None or PROBING not in states or not readmitted:
        raise AssertionError("health: cuda:0 was not probed and re-admitted")
    # two batches in flight on the two executors, one graph: bitwise equal
    a, b = v.dispatch(valid), v.dispatch(valid)
    pair = (a.result(), b.result())
    same = torch.equal(a._f, b._f) and torch.equal(a._ok, b._ok)  # the pinned host copies
    log(f"health: one batch in flight on {a.device} and on {b.device} at once -> {pair}, "
        f"outputs bitwise equal {same}")
    if not same or pair != (True, True) or {a.device, b.device} != {first, second}:
        raise AssertionError("health: the two executors' replays of one graph differ")
    # a corrupted batch lost on whichever executor takes it
    CHAOS.install(FaultPlan(SEED + 1).add("device.loss", count=1))
    got, landed, bad_s = _timed_batch(v, corrupted)
    CHAOS.disarm()
    log(f"health: a corrupted batch lost on {landed} and requeued -> {got} ({bad_s} s); "
        f"batches_requeued {v.batches_requeued}")
    if got is not False or v.batches_requeued != 2:
        raise AssertionError("health: the lost corrupted batch did not give False")
    v.close()
    return dict(warmup_s=warm, requeued_s=requeued_s, plain_s=plain_s,
                extra_s=requeued_s - plain_s, probe_s=probe_s, readmitted_s=readmitted_s)


def health_one_executor(dev, card: str, sets) -> dict:
    """Phase 13, steps 3-4: on one executor a loss raises with the slot
    and the in-flight entry freed; a wedge under the watchdog leaves a
    stall bundle that lists the executors' health."""
    from lodestar_tpu_torch.chaos import CHAOS, DeviceLostError, FaultPlan
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.forensics import INFLIGHT, RECORDER

    v = TorchBlsVerifier(device=dev, rng=np.random.default_rng(SEED + 51))
    RECORDER.configure(verifier=v)
    v.warmup((BUCKET,))
    valid = v.pack(sets)
    CHAOS.install(FaultPlan(SEED + 2).add("device.loss", count=1))
    try:
        v.dispatch(valid).result()
        raised = None
    except DeviceLostError as e:
        raised = type(e).__name__
    CHAOS.disarm()
    slots, entries = v.device_inflight(), len(INFLIGHT)
    ok, _, _ = _timed_batch(v, valid)
    log(f"health: one executor, a loss -> raised {raised}; slots {slots}, in-flight "
        f"entries {entries}; the next batch -> {ok}")
    if raised != "DeviceLostError" or any(slots.values()) or entries or ok is not True:
        raise AssertionError("health: a loss with no survivor did not raise cleanly")
    RECORDER.start_watchdog(WATCHDOG_S)
    CHAOS.install(FaultPlan(SEED + 3).add("device.wedge", wedge_s=WEDGE_S, count=1))
    t0 = time.perf_counter()
    try:
        v.dispatch(valid).result()
        raised = None
    except DeviceLostError as e:
        raised = type(e).__name__
    wedge_s = time.perf_counter() - t0
    CHAOS.disarm()
    RECORDER.stop_watchdog()
    stalls = _bundles(RECORDER.dir, "watchdog")
    listed = False
    if stalls:
        path, manifest = stalls[-1]
        with open(os.path.join(path, "inflight.json")) as f:
            section = json.load(f)["verifier"]
        listed = ("inflight.json" in manifest["files"] and str(dev) in section["health"]
                  and [e["device"] for e in manifest["stalled"]] == [str(dev)])
    ok, _, _ = _timed_batch(v, valid)
    log(f"health: a {WEDGE_S} s wedge under a {WATCHDOG_S} s watchdog -> raised {raised} "
        f"after {wedge_s} s, {len(stalls)} stall bundle(s), manifest lists the health "
        f"section and the stalled batch {listed}; the next batch -> {ok}")
    if raised != "DeviceLostError" or len(stalls) != 1 or not listed or ok is not True:
        raise AssertionError("health: the wedge left no stall bundle with the health section")
    v.close()
    return dict(wedge_s=wedge_s)


def health_pool(dev, card: str, sets) -> dict:
    """Phase 13, step 5: a pool over two executors with a loss armed once
    gives every job's verdict without a per-job retry."""
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.chaos import CHAOS, FaultPlan
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    v = TorchBlsVerifier(devices=[dev, dev], quarantine_threshold=1,
                         quarantine_backoff_s=HEALTH_BACKOFF_S,
                         rng=np.random.default_rng(SEED + 52))
    v.warmup((BUCKET,))
    v.pack(sets)  # the public keys cached, as on a node
    jobs = gossip_jobs(sets)
    bls = BlsBatchPool(v, pipeline_depth=2, flush_threshold=BUCKET, max_buffer_wait=0.02)
    CHAOS.install(FaultPlan(SEED + 4).add("device.loss", count=1))
    t0 = time.perf_counter()
    results = asyncio.run(_verify_all(bls, jobs))
    wall = time.perf_counter() - t0
    CHAOS.disarm()
    bls.close()
    log(f"health: a pool over 2 executors, a loss armed once: {len(jobs)} jobs -> all True "
        f"{all(r is True for r in results)} in {wall} s, {len(bls.batch_spans)} batches, "
        f"batches_requeued {v.batches_requeued}, batch retries {bls.batch_retries} [{card}]")
    if (not all(r is True for r in results) or len(results) != len(jobs)
            or v.batches_requeued != 1 or bls.batch_retries != 0):
        raise AssertionError("health: the pool's lost batch was not saved by its requeue")
    v.close()
    return dict(pool_wall=wall)


def run_health(dev, card: str, sets, sets256) -> dict:
    """Phase 13: health, quarantine and requeue on the card, faults
    injected through the port's fault plane (no real device error: a
    sticky CUDA error would poison the context every executor of the card
    shares), bundles written to a temporary directory removed after."""
    import shutil
    import tempfile

    from lodestar_tpu_torch.chaos import CHAOS
    from lodestar_tpu_torch.forensics import RECORDER

    base = tempfile.mkdtemp(prefix="chip-smoke-forensics-")
    RECORDER.configure(forensics_dir=base)
    try:
        with Phase("13 health"):
            t0 = time.perf_counter()
            out = health_requeue(dev, card, sets)
            out.update(health_one_executor(dev, card, sets))
            out.update(health_pool(dev, card, sets256[:BUCKET]))
            out["wall"] = time.perf_counter() - t0
            log(f"health: requeued batch {out['requeued_s']} s against a plain one "
                f"{out['plain_s']} s (extra {out['extra_s']} s); probe batch "
                f"{out['probe_s']} s, re-admitted {out['readmitted_s']} s after the "
                f"quarantined batches; phase {out['wall']} s [{card}]")
    finally:
        CHAOS.disarm()
        RECORDER.stop_watchdog()
        RECORDER.verifier = None
        shutil.rmtree(base, ignore_errors=True)
    return out


def main(argv) -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure", file=sys.stderr)
        return 2
    mode = {(): "all", ("--sharded-only",): "sharded", ("--split-only",): "split",
            ("--fused-only",): "fused", ("--store-only",): "store",
            ("--observatory-only",): "observatory",
            ("--analysis-only",): "analysis", ("--chain-only",): "chain",
            ("--network-only",): "network", ("--validator-only",): "validator",
            ("--ops-only",): "ops"}.get(tuple(argv))
    if mode is None:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    card = card_line()
    # the phases' figures, filled as each phase returns; every mode ends
    # in phase 21, a failed run too (its record, then its error)
    figures = {}
    try:
        run_phases(mode, card, figures, t_start)
    except BaseException:
        run_ledger_phase(mode, 1, card, figures)
        raise
    run_ledger_phase(mode, 0, card, figures)
    return ok_lines(card, None if mode == "all" else MODE_PHASES[mode])


#: the phases each mode runs, as a ``-only`` mode's ``{"phases": ...}``
#: line prints them
MODE_PHASES = {"all": "1-21", "sharded": "1, 8-10, 21", "split": "1, 2, 2b, 11-13, 21",
               "fused": "1-5, 2b, 11, 12, 21", "store": "1, 14, 21",
               "observatory": "1, 15, 21", "analysis": "1, 16, 21", "chain": "1, 17, 21",
               "network": "1, 18, 21", "validator": "1, 19, 21", "ops": "1, 20, 21"}


def run_phases(mode: str, card: str, figures: dict, t_start: float) -> None:
    """Phases 1-20 of ``mode``, each phase's figures kept in ``figures``;
    the full run ends in the ``kernels`` line."""
    from lodestar_tpu_torch.ops import fused_ladder, library_fuse, tower_kernels  # noqa: F401
    from lodestar_tpu_torch.ops import ring_gather
    from lodestar_tpu_torch.ops.fused_core import KERNELS
    from lodestar_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; {torch.cuda.device_count()} card(s) visible")
    with Phase("1 build"):
        t0 = time.perf_counter()
        _build.load()
        build = dict(kind=_build.build_kind, seconds=_build.build_seconds)
        log(f"build: nvcc sm_90a library {_build.library_path()} in "
            f"{time.perf_counter() - t0:.1f} s ({build['kind']})")

    if mode == "analysis":
        run_analysis(card)
        log(f"whole run: {time.perf_counter() - t_start:.1f} s wall")
        return
    keys = make_keys(SHARDED_BUCKET)
    procs = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        # the CPU plain runs the card is held against, made beside the
        # card's phases in the host processes
        cpu_ref = {what: pool.apply_async(cpu_reference, (what,))
                   for what, modes in (("fused", ("all", "fused")), ("xla", ("all",)),
                                       ("sharded", ("all", "sharded"))) if mode in modes}
        if mode == "store":
            figures["store"] = run_store(dev, card, make_sets(pool, keys[:STORE_BUCKET], b"store"),
                                         build)
        if mode == "observatory":
            run_observatory(dev, card, pool, keys)
        if mode == "chain":
            figures["chain"] = run_chain(dev, card, pool)
        if mode == "network":
            figures["network"] = run_network(dev, card, pool)
        if mode == "validator":
            run_validator_phase(dev, card, pool)
        if mode == "ops":
            figures["firehose"] = run_firehose_phase(dev, card)
            run_chaos(card)
            run_prewarm(card)
        if mode not in ("sharded", "store", "observatory", "chain", "network", "validator",
                        "ops"):
            with Phase("2 kernels"):
                registry_launches = run_registry(dev, card)
                results = check_kernels(dev, card)
            t0 = time.perf_counter()
            sets = make_sets(pool, keys[:BUCKET], b"slice")
            log(f"slice: built {BUCKET} signature sets in {procs} host processes in "
                f"{time.perf_counter() - t0:.1f} s")
            verifiers = run_graphs(dev, card, sets)
        if mode in ("all", "fused"):
            fused_launches, fused_rate, fused_idle = run_fused(dev, card, pool, keys[:BUCKET], sets,
                                                               verifiers[(True, False)], cpu_ref)
        if mode == "all":
            xla_launches, xla_rate, xla_idle = run_xla(dev, card, pool, keys[:BUCKET], sets,
                                                       cpu_ref)
            log(f"paths at bucket {BUCKET}: fused {fused_rate} sets/s, device idle {fused_idle} "
                f"of the dispatch; xla {xla_rate} sets/s, device idle {xla_idle} of the "
                f"dispatch [{card}]")
        if mode in ("all", "sharded"):
            ring = run_ring(dev, card)
        if mode not in ("store", "observatory", "chain", "network", "validator", "ops"):
            t0 = time.perf_counter()
            sets256 = make_sets(pool, keys, b"sharded slice")
            log(f"sharded slice: built {len(sets256)} signature sets in {procs} host processes "
                f"in {time.perf_counter() - t0:.1f} s")
        tiers = None
        if mode in ("all", "sharded"):
            # the full run's phase 16 runs in a host process of the pool
            # beside phase 9, whose checks are bitwise and whose seconds are
            # only logged; it ends before phase 10 times anything
            analysis = pool.apply_async(analysis_in_child, (card,)) if mode == "all" else None
            # so does phase 19c, the validator flow's child processes, whose
            # checks are exit codes, REST answers and files; its rates are
            # logged as taken beside phase 9.  The full run leaves the
            # XLA-graph flavour's split-mode mesh capture to --sharded-only
            cli19 = (concurrent.futures.ThreadPoolExecutor(1).submit(
                run_cli_validator, os.path.join(REPO, "chiprun_out", "chip_smoke_validator_cli"))
                if mode == "all" else None)
            # and phase 20c, the prewarm farm in child processes, whose
            # checks are exit codes, verdicts and files
            prewarm20 = (concurrent.futures.ThreadPoolExecutor(1).submit(run_prewarm, card)
                         if mode == "all" else None)
            verifier, sharded_launches, sharded_xla_launches, tiers = run_sharded(
                dev, card, sets256, cpu_ref,
                xla_modes=(False,) if mode == "all" else (True, False))
            if analysis is not None:
                t0 = time.perf_counter()
                audit = analysis.get(timeout=1200)
                log(f"phase 16 beside phase 9: waited {time.perf_counter() - t0:.1f} s for it "
                    f"after phase 9")
                t0 = time.perf_counter()
                cli19 = cli19.result(timeout=1200)
                log(f"phase 19c beside phase 9: waited {time.perf_counter() - t0:.1f} s for it "
                    f"after phase 9")
                t0 = time.perf_counter()
                prewarm20.result(timeout=1200)
                log(f"phase 20c beside phase 9: waited {time.perf_counter() - t0:.1f} s for it "
                    f"after phase 9")
            times = figures["sharded_times"] = run_sharded_times(dev, card, verifier, pool, keys,
                                                                  sets256)
            log(f"paths: sharded over 2 logical shards {times['logical2']['rate']} sets/s at "
                f"bucket {SHARDED_BUCKET} (device idle {times['logical2']['idle']}), one card as "
                f"2 x {BUCKET} {times['logical2']['single']} sets/s; cross-card "
                f"{json.dumps({k: v for k, v in times.items() if k != 'logical2'})} [{card}]")
            chaos20 = run_chaos(card) if mode == "all" else None
        if mode not in ("sharded", "store", "observatory", "chain", "network", "validator",
                        "ops"):
            split = figures["split"] = run_split(dev, card, pool, keys, sets, sets256, verifiers,
                                                 tiers)
            pooled = figures["pool"] = run_pool(dev, card, pool, keys, sets256)
            full = f"{fused_rate} sets/s" if mode in ("all", "fused") else "not run"
            log(f"paths at bucket {BUCKET}: split {split['rate']} sets/s, device idle "
                f"{split['idle']} of the device Miller product, beside the full-device "
                f"{full} (phase 4); split sharded {split['sharded_rate']} sets/s at bucket "
                f"{SHARDED_BUCKET}; pool {pooled['rate']} sets/s, {pooled['batches']} batches, "
                f"inflight peak {pooled['inflight_peak']}, two host spans open "
                f"{pooled['overlap_share']} of the wall [{card}]")
        if mode in ("all", "split"):
            run_health(dev, card, sets, sets256)
        if mode == "all":
            figures["store"] = run_store(dev, card, sets, build)
            run_observatory(dev, card, pool, keys, sets256)
            chain = figures["chain"] = run_chain(dev, card, pool)
            network = figures["network"] = run_network(dev, card, pool)
            validator = run_validator_phase(dev, card, pool, cli=cli19)
            firehose20 = figures["firehose"] = run_firehose_phase(dev, card)
    log(f"whole run: {time.perf_counter() - t_start:.1f} s wall")
    if mode != "all":
        return

    def by_path(name):
        return {"registry": registry_launches[name], "fused": fused_launches[name],
                "xla": xla_launches[name], "sharded": sharded_launches[name],
                "sharded_xla": sharded_xla_launches[name],
                "split": split["launches"][name], "split_xla": split["xla_launches"][name],
                "split_sharded": split["sharded_launches"][name],
                "pool": pooled["launches"][name],
                "chain": chain["chain"]["launches"].get(name, 0),
                "segment": chain["segment"]["launches"].get(name, 0),
                "gossip": network["gossip"]["launches"].get(name, 0),
                "range_sync": network["range_sync"]["launches"].get(name, 0),
                "validator": validator["validator"]["launches"].get(name, 0),
                "firehose": firehose20["launches"].get(name, 0),
                "chaos": chaos20["launches"].get(name, 0)}

    # each kernel's launches from its own path: the fused kernels' phase 3,
    # the tower kernels' phase 6, the library kernel's registry run, the
    # ring hop's phase 9
    main_path = {**{n: fused_launches for n in FUSED}, **{n: xla_launches for n in TOWER},
                 **{n: registry_launches for n in LIBRARY}, "ring_hop": sharded_launches}
    line = []
    for name, k in KERNELS.items():
        r = results[name]
        line.append({
            "name": name,
            "route": "cuda",
            "cooperative": name in COOP,
            "source": "lodestar_tpu_torch/ops/kernels/" + _build.LAUNCHERS[name],
            "replaces": k.replaces,
            "launches": main_path[name][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "rows": r["rows"],
            "issue_ms": r["issue_ms"],
            "by_rows": r["by_rows"],
            "launches_by_path": by_path(name),
            **audit["kernels"][name],
        })
    hop = ring[2]
    line.append({
        "name": "ring_hop",
        "route": "cuda",
        "source": "lodestar_tpu_torch/ops/kernels/" + _build.LAUNCHERS["ring_hop"],
        "replaces": ring_gather.RING_HOP.replaces,
        "launches": main_path["ring_hop"]["ring_hop"],
        "max_abs_err": max(r["max_abs_err"] for r in ring.values()),
        "ms": hop["ms"],
        "plain_ms": hop["plain_ms"],
        "bound_ms": hop["bound_ms"],
        "bound_by": hop["bound_by"],
        "library_ms": hop["library_ms"],
        "issue_ms": hop["issue_ms"],
        "empty_ms": hop["empty_ms"],
        "by_shape": hop["by_shape"],
        "chunk_bytes": 4 * int(np.prod(RING_SHAPES[0])),
        "gather_ms": {str(k): v["gather_ms"] for k, v in ring.items()},
        "launches_by_path": by_path("ring_hop"),
        **audit["kernels"]["ring_hop"],
    })
    print(json.dumps({"kernels": line}))


def git_commit():
    """``git rev-parse HEAD`` of the checkout, or None outside a git
    repository."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


#: each tripwire metric chip_smoke measures: the phase that measures it, the
#: entry of the phases' figures that phase returns, and the metric in it
LEDGER_METRICS = {
    "bls_sig_sets_per_s_per_chip": ("11", "split", lambda f: f["rate"]),
    "dispatch_ms": ("11", "split", lambda f: f["stages"]["device_miller"] * 1e3),
    "bls_sig_sets_per_s": ("12", "pool", lambda f: f["rate"]),
    "bls_sig_sets_per_s_sharded": ("10", "sharded_times", lambda f: f["logical2"]["rate"]),
    "scaling_efficiency_sharded": ("10", "sharded_times",
                                   lambda f: f["logical2"]["rate"] / f["logical2"]["single"]),
    "cold_start_cold_s": ("14", "store", lambda f: f["cold_s"]),
    "cold_start_aot_s": ("14", "store", lambda f: f["aot_s"]),
    "cold_start_warm_s": ("14", "store", lambda f: f["warm_s"]),
    "dev_chain_blocks_per_s": ("17", "chain", lambda f: f["chain"]["blocks_per_s"]),
    "range_sync_blocks_per_s": ("18a", "network", lambda f: f["range_sync"]["blocks_per_s"]),
    "sustained_sets_per_s_at_slo": ("20a", "firehose",
                                    lambda f: f["slo"]["achieved_sets_per_s"]),
}


def runs_phase(phases: str, phase: str) -> bool:
    """Whether ``phases`` (a ``MODE_PHASES`` entry, "1, 8-10, 21") holds
    ``phase`` ("10"; "18a" is a part of 18)."""
    n = int(phase.rstrip("abc"))
    for part in phases.split(", "):
        lo, _, hi = part.partition("-")
        if part == phase or (lo.isdigit() and int(lo) <= n <= int(hi or lo)):
            return True
    return False


def ledger_metrics(mode: str, figures: dict) -> dict:
    """The ``LEDGER_METRICS`` of the phases ``mode`` runs, read from the
    phases' figures: None where a phase returned none (it failed or never
    ran)."""
    return {name: None if figures.get(entry) is None else float(read(figures[entry]))
            for name, (phase, entry, read) in LEDGER_METRICS.items()
            if runs_phase(MODE_PHASES[mode], phase)}


def run_ledger_phase(mode: str, rc: int, card: str, figures: dict) -> str:
    """Phase 21: this run's record (``observatory/run_ledger.make_record``
    over the phases' figures) written to ``chiprun_out/runs/``; then, for
    a run whose phases all passed, the deltas against the newest earlier
    record of the same card, ``perf_report``'s summary over the records,
    and ``tier1_budget`` over the checkout's tier-1 ledger.  A flagged
    regression is reported, not fatal; the phase fails where the ledger
    raises, or where a run whose phases all passed left a metric without
    a value.  Returns the record's path."""
    from lodestar_tpu_torch.observatory import COMPILE_LEDGER, run_ledger
    from lodestar_tpu_torch.tools import perf_report, tier1_budget

    with Phase("21 run ledger"):
        earlier = perf_report.run_paths(perf_report.DEFAULT_RUNS, REPO)
        metrics = ledger_metrics(mode, figures)
        missing = [] if rc else sorted(name for name, v in metrics.items() if v is None)
        rc = rc or int(bool(missing))
        record = run_ledger.make_record(mode, rc, card, metrics, MODE_PHASES[mode], PHASE_SECONDS,
                                        commit=git_commit(), torch_version=torch.__version__,
                                        cuda_version=torch.version.cuda)
        path = run_ledger.write_record(record, os.path.join(REPO, run_ledger.RUNS_DIR))
        log(f"run ledger: wrote {os.path.relpath(path, REPO)} (mode {mode}, rc {rc}): "
            + json.dumps(record["metrics"]))
        if missing:
            raise AssertionError(f"run ledger: the phases passed but left no value for "
                                 f"{missing}")
        if rc:
            return path
        deltas = run_ledger.deltas_vs_previous(earlier, record["metrics"], card)
        same_card = [r for r in run_ledger.load_series(earlier) if run_ledger.run_card(r) == card]
        log(f"run ledger: deltas against the newest earlier record of this card "
            f"({len(same_card)} earlier of {len(earlier)}): " + json.dumps(deltas))
        regressed = sorted(name for name, d in deltas.items() if d.get("regressed"))
        log(f"run ledger: regressed against the previous record (reported, not fatal): "
            f"{', '.join(regressed) or 'none'} [{card}]")
        report = run_ledger.analyze(earlier + [path], compile_ledger=COMPILE_LEDGER.path,
                                    tier1=os.path.join(REPO, tier1_budget.TIER1_LEDGER))
        log(perf_report.summary_line(report))
        budget = tier1_budget.analyze(REPO)
        log(tier1_budget.render(budget) if budget["runs"] or budget["partial_runs"]
            else f"tier-1 budget: none (no {tier1_budget.TIER1_LEDGER} in this checkout)")
    return path


def ok_lines(card: str, phases: str = None) -> int:
    """The last lines of every mode: the phases a ``-only`` mode ran, the
    card's name and power limit, and the contract's last line."""
    if phases is not None:
        print(json.dumps({"phases": phases}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

# -- phase 17: the beacon chain on the card --------------------------------------------

CHAIN_VALIDATORS = 128  # 4 committees x 4 members x 8 slots: every minimal committee full
CHAIN_SLOTS = 6 * 8 + 2  # six epochs and two slots: Altair at epoch 1, Bellatrix at 2
SEGMENT_SLOTS = 16  # the range-sync segment, slots 1-16 of the chain
BAD_BLOCK = 8  # the segment's block whose signature phase 17 alters (slot 9)
CHAIN_BUCKETS = (4, 16, 128)  # a block's job (2-7 sets), the segment's (~100)


def chain_config(n_validators: int = CHAIN_VALIDATORS):
    """tests/test_fork_transition.py's schedule, pre-merge."""
    from lodestar_tpu_torch.config.chain_config import ChainConfig

    return ChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                       MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=n_validators,
                       ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=2)


def chain_outcome(chain) -> dict:
    """What two runs of one chain must agree on: the head, its state's
    root, the justified and finalized checkpoints, the fork."""
    from lodestar_tpu_torch.state_transition.upgrade import state_fork_name, state_types

    state = chain.head_state()
    return dict(head=chain.head_root.hex(),
                state_root=state_types(chain.p, state).BeaconState.hash_tree_root(state).hex(),
                justified=[int(state.current_justified_checkpoint.epoch),
                           bytes(state.current_justified_checkpoint.root).hex()],
                finalized=[int(state.finalized_checkpoint.epoch),
                           bytes(state.finalized_checkpoint.root).hex()],
                fork=str(state_fork_name(state).value))


async def drive_chain(dev, n_slots: int) -> list:
    """``DevChain.run``'s loop, keeping each slot's block root."""
    roots = []
    for slot in range(1, n_slots + 1):
        roots.append(await dev.advance_slot(slot))
        await dev.chain.prepare_scheduler.prepare(slot + 1)
    return roots


class RecordingFast:
    """The host C verifier, recording each batch's set count."""

    def __init__(self):
        from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier

        self.base, self.batches = FastBlsVerifier(), []

    def verify_signature_sets(self, sets):
        self.batches.append(len(sets))
        return self.base.verify_signature_sets(sets)


def host_chain() -> dict:
    """Phase 17's chain on the host, in a pool process: the same slots over
    the port's ``FastBlsVerifier`` (C), for the card's run to equal."""
    torch.set_num_threads(1)
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.node.dev_chain import DevChain
    from lodestar_tpu_torch.params import MINIMAL

    async def run():
        verifier = RecordingFast()
        pool = BlsBatchPool(verifier, max_buffer_wait=0.005)
        dev = DevChain(MINIMAL, chain_config(), CHAIN_VALIDATORS, pool)
        t0 = time.perf_counter()
        await drive_chain(dev, CHAIN_SLOTS)
        wall = time.perf_counter() - t0
        pool.close()
        return dict(chain_outcome(dev.chain), wall=wall, batches=verifier.batches)

    return asyncio.run(run())


def chain_launches(names) -> dict:
    from lodestar_tpu_torch.ops import fused_core

    return {name: fused_core.COUNTED[name].launches for name in names}


def run_chain(dev, card: str, pool) -> dict:
    """Phase 17: ``DevChain``'s block import and range sync through the
    port's ``BlsBatchPool`` over the card's split fused verifier, held
    against the same chain on the host; each fused kernel's launches over
    the chain and over the two segment imports."""
    from lodestar_tpu_torch.chain.beacon_chain import BlockError
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.node.dev_chain import DevChain
    from lodestar_tpu_torch.ops import fused_core
    from lodestar_tpu_torch.params import MINIMAL
    from lodestar_tpu_torch.ssz import Fields

    out = {}
    with Phase("17 chain"):
        host = pool.apply_async(host_chain)
        verifier = TorchBlsVerifier(device=dev, buckets=CHAIN_BUCKETS,
                                    rng=np.random.default_rng(SEED + 170))
        if not (verifier.fused and verifier.host_final_exp):
            raise AssertionError("chain: the verifier is not the split fused default")
        warm = verifier.warmup()
        log(f"chain: split fused graphs at buckets {CHAIN_BUCKETS} warmed in {warm:.2f} s")

        # every block's job, its bucket, and the chain's wait on it
        jobs = []
        enqueue = verifier.verify_signature_sets_async

        def recording(sets, deadline=None):
            jobs.append(len(sets))
            return enqueue(sets, deadline=deadline)

        verifier.verify_signature_sets_async = recording

        async def card_chain():
            metrics = TallyMetrics()
            bls = BlsBatchPool(verifier, max_buffer_wait=0.005)
            chain_dev = DevChain(MINIMAL, chain_config(), CHAIN_VALIDATORS, bls, metrics=metrics)
            waits = []
            timed_block_waits(chain_dev.chain, waits)
            stages0, d0 = dict(verifier.stage_seconds), verifier.dispatches
            fused_core.reset_launch_counts()
            sync_all()
            t0 = time.perf_counter()
            roots = await drive_chain(chain_dev, CHAIN_SLOTS)
            wall = time.perf_counter() - t0
            launches = chain_launches(FUSED)
            bls.close()
            stages = {k: verifier.stage_seconds[k] - stages0.get(k, 0.0)
                      for k in verifier.stage_seconds if k != "warmup"}
            return chain_dev, roots, dict(
                wall=wall, blocks_per_s=CHAIN_SLOTS / wall, dispatches=verifier.dispatches - d0,
                state_transition_s=metrics.state_transition_seconds.sum / CHAIN_SLOTS,
                block_processing_s=metrics.block_processing_seconds.sum / CHAIN_SLOTS,
                epoch_transition_s=metrics.epoch_transition_seconds.sum,
                pool_wait_s=sum(waits) / len(waits),
                stage_seconds_per_block={k: v / CHAIN_SLOTS for k, v in stages.items()},
                launches=launches)

        chain_dev, roots, run = asyncio.run(card_chain())
        got = chain_outcome(chain_dev.chain)
        buckets = {}
        for n in jobs:
            buckets[verifier._bucket(n)] = buckets.get(verifier._bucket(n), 0) + 1
        run.update(got, jobs=len(jobs), sets=sum(jobs), buckets=buckets,
                   set_counts=sorted(set(jobs)))
        log("chain: " + json.dumps({k: v for k, v in run.items() if k != "launches"}))
        log(f"chain: {CHAIN_SLOTS} slots at {CHAIN_VALIDATORS} validators in {run['wall']:.2f} s "
            f"= {run['blocks_per_s']:.3f} blocks/s; per block: state transition "
            f"{run['state_transition_s']:.4f} s, pool wait {run['pool_wait_s']:.4f} s, "
            f"import {run['block_processing_s']:.4f} s; buckets {buckets} [{card}]")
        if (got["fork"] != "bellatrix" or got["justified"][0] < 4 or got["finalized"][0] < 3
                or run["dispatches"] < CHAIN_SLOTS):
            raise AssertionError(f"chain: fork {got['fork']}, justified {got['justified'][0]}, "
                                 f"finalized {got['finalized'][0]}, dispatches "
                                 f"{run['dispatches']}")
        idle = [name for name in FUSED if run["launches"][name] == 0]
        if idle:
            raise AssertionError(f"chain: kernels never launched {idle}")
        for bucket in CHAIN_BUCKETS:
            program = verifier.programs[(verifier.device, bucket, True, True)]
            log(f"chain: bucket {bucket} graph's launch record (rows: launches) "
                + json.dumps({n: dict(sorted(program.launch_rows.get(n, {}).items()))
                              for n in FUSED}))

        # the host's run of the same slots (C verifier, a pool process)
        ref = host.get(timeout=900)
        log(f"chain: host run {ref['wall']:.2f} s = {CHAIN_SLOTS / ref['wall']:.3f} blocks/s "
            f"(FastBlsVerifier in a pool process), {len(ref['batches'])} batches")
        if {k: ref[k] for k in got} != got:
            raise AssertionError(f"chain: the card's chain {got} is not the host's "
                                 f"{ {k: ref[k] for k in got} }")
        if ref["batches"] != jobs:
            raise AssertionError(f"chain: the host's batches {ref['batches']} are not the "
                                 f"card's {jobs}")
        out["chain"] = run

        # range sync: slots 1-16 replayed on fresh chains
        seg = [chain_dev.chain.get_block_by_root(r) for r in roots[:SEGMENT_SLOTS]]

        async def replay(blocks):
            bls = BlsBatchPool(verifier, max_buffer_wait=0.005)
            consumer = DevChain(MINIMAL, chain_config(), CHAIN_VALIDATORS, bls)
            d0, n0, j0 = verifier.dispatches, verifier.sets_verified, len(jobs)
            t0 = time.perf_counter()
            error, n = None, None
            try:
                n = await consumer.chain.process_chain_segment(blocks)
            except BlockError as e:
                error = str(e)
            wall = time.perf_counter() - t0
            bls.close()
            imported = sum(consumer.chain.fork_choice.has_block(r) for r in roots[:SEGMENT_SLOTS])
            return dict(n=n, imported=imported, error=error, wall=wall,
                        dispatches=verifier.dispatches - d0, jobs=jobs[j0:],
                        sets_verified=verifier.sets_verified - n0,
                        head=consumer.chain.head_root.hex())

        fused_core.reset_launch_counts()
        good = asyncio.run(replay(seg))
        good["blocks_per_s"] = SEGMENT_SLOTS / good["wall"]
        log("segment: " + json.dumps(good))
        if (good["n"] != SEGMENT_SLOTS or good["dispatches"] != 1 or good["error"]
                or good["head"] != roots[SEGMENT_SLOTS - 1].hex()):
            raise AssertionError(f"segment: {good}")
        log(f"segment: {SEGMENT_SLOTS} blocks in one batch of {good['jobs'][0]} sets, "
            f"{good['wall']:.2f} s = {good['blocks_per_s']:.3f} blocks/s [{card}]")
        bad = list(seg)
        bad[BAD_BLOCK] = Fields(message=seg[BAD_BLOCK].message,
                                signature=bytes(seg[BAD_BLOCK + 1].signature))
        altered = asyncio.run(replay(bad))
        log("segment, block 9's signature altered: " + json.dumps(altered))
        if altered["error"] is None or altered["imported"] != BAD_BLOCK:
            raise AssertionError(f"segment: the altered segment gave {altered}")
        out["segment"] = dict(good=good, altered=altered, launches=chain_launches(FUSED))
        idle = [name for name in FUSED if out["segment"]["launches"][name] == 0]
        if idle:
            raise AssertionError(f"segment: kernels never launched {idle}")
        log("chain: launches over the chain " + json.dumps(run["launches"])
            + "; over the two segments " + json.dumps(out["segment"]["launches"]))
        verifier.close()
    return out


# -- phase 18: the node's network face on the card -------------------------------------

NET_VALIDATORS = 128  # the chain phase's size: every minimal committee full
NET_SYNC_SLOTS = 2 * 8 + 4  # tests/test_network_sync.py's two epochs and four slots
NET_SIM_SLOTS = 3 * 8 + 2  # tests/test_sim_multinode.py's: justification from epoch 2
NET_BUCKETS = CHAIN_BUCKETS  # a gossip batch (1-16 sets), a block's job, a segment's
NET_SIM_SPLIT = 3  # the line A-B-C, the validators split in three
NET_WAIT_S = 120.0  # bound on every wait for a message to cross the loopback
CLI_DEV_HEAD = 40  # the dev child's head slot at which the beacon child starts


def net_config(n_validators: int):
    """The sims' schedule: phase0 throughout (their attestations are
    phase0 single-bit ones)."""
    from lodestar_tpu_torch.config.chain_config import ChainConfig

    return ChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                       MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=n_validators,
                       ALTAIR_FORK_EPOCH=2**64 - 1, BELLATRIX_FORK_EPOCH=2**64 - 1)


def sim_split(n_validators: int):
    """The validators of the three nodes: 0-42, 43-85, 86-127 at 128."""
    edges = [-(-i * n_validators // NET_SIM_SPLIT) for i in range(NET_SIM_SPLIT + 1)]
    return [range(edges[i], edges[i + 1]) for i in range(NET_SIM_SPLIT)]


def percentiles(xs) -> dict:
    if not xs:
        return dict(n=0, p50=None, p95=None)
    a = np.sort(np.asarray(xs, float))
    return dict(n=len(a), p50=float(np.percentile(a, 50)), p95=float(np.percentile(a, 95)))


class PoolBatches:
    """A pool's merged batches: each batch's lanes and set count, read
    where the pool drains its queue."""

    def __init__(self, pool):
        from lodestar_tpu_torch.crypto.bls.verifier import SignatureSetPriority

        self.batches = []
        drain = pool._queue.drain_batch

        def recording(*a, **kw):
            drained = drain(*a, **kw)
            if drained:
                lanes = sorted({SignatureSetPriority(d[3]).name.lower() for d in drained})
                self.batches.append(("+".join(lanes), sum(len(d[0]) for d in drained)))
            return drained

        pool._queue.drain_batch = recording

    def by_lane_and_bucket(self, bucket_of) -> dict:
        out = {}
        for lanes, n in self.batches:
            key = f"{lanes}@{bucket_of(n)}"
            out[key] = out.get(key, 0) + 1
        return out


def timed_block_waits(chain, waits) -> None:
    """Each block's (or segment's) wait on the pool, appended to ``waits``."""
    verify = chain._verify_block_sets

    async def timed(sets):
        t0 = time.perf_counter()
        try:
            return await verify(sets)
        finally:
            waits.append(time.perf_counter() - t0)

    chain._verify_block_sets = timed


async def wait_until(pred, what: str, timeout: float = NET_WAIT_S) -> float:
    """Poll ``pred`` until it holds; raises after ``timeout`` seconds.
    Returns the seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"network: {what} not reached in {timeout:.0f} s")
        await asyncio.sleep(0.01)
    return time.perf_counter() - t0


async def sync_pair(verifier, n_validators: int = NET_VALIDATORS,
                    n_slots: int = NET_SYNC_SLOTS, on_start=None) -> dict:
    """18a (tests/test_network_sync.py's first case): node A runs
    ``n_slots`` alone over the host's C verifier; node B, whose pool runs
    ``verifier``, connects over the loopback, handshakes, pings, reads
    A's metadata and range-syncs to A's head.  ``on_start`` is called just
    before B's sync (phase 18 zeroes the launch counts there)."""
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.chain.handlers import GossipHandlers
    from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier
    from lodestar_tpu_torch.network import Network
    from lodestar_tpu_torch.node.dev_chain import DevChain
    from lodestar_tpu_torch.params import MINIMAL
    from lodestar_tpu_torch.sync import RangeSync, SyncState

    cfg = net_config(n_validators)
    pool_a = BlsBatchPool(FastBlsVerifier(), max_buffer_wait=0.005)
    pool_b = BlsBatchPool(verifier, max_buffer_wait=0.005)
    batches = PoolBatches(pool_b)
    a = DevChain(MINIMAL, cfg, n_validators, pool_a)
    b = DevChain(MINIMAL, cfg, n_validators, pool_b)
    t0 = time.perf_counter()
    await a.run(n_slots)
    produce_s = time.perf_counter() - t0
    net_a = Network(MINIMAL, a.chain, GossipHandlers(a.chain))
    net_b = Network(MINIMAL, b.chain, GossipHandlers(b.chain))
    try:
        port = await net_a.listen(0)
        peer = await asyncio.wait_for(net_b.connect("127.0.0.1", port), NET_WAIT_S)
        if peer.status is None or peer.status.head_slot != a.chain.head_state().slot:
            raise AssertionError(f"sync: handshake gave {peer.status}")
        if await asyncio.wait_for(peer.reqresp.ping(7), NET_WAIT_S) != 7:
            raise AssertionError("sync: ping")
        md = await asyncio.wait_for(peer.reqresp.metadata(), NET_WAIT_S)
        waits = []
        timed_block_waits(b.chain, waits)
        sync = RangeSync(MINIMAL, b.chain, net_b.peer_manager)
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        imported = await asyncio.wait_for(sync.run_to_head(), 10 * NET_WAIT_S)
        wall = time.perf_counter() - t0
    finally:
        await net_b.close()
        await net_a.close()
        pool_a.close()
        pool_b.close()
    out = dict(slots=n_slots, produce_s=produce_s, imported=imported, wall=wall,
               blocks_per_s=imported / wall if wall else None, metadata_seq=int(md.seq_number),
               synced=sync.state == SyncState.synced, head=b.chain.head_root.hex(),
               want_head=a.chain.head_root.hex(), segments=len(waits),
               segment_wait_s=waits, batches=batches.batches)
    if not out["synced"] or imported != n_slots or out["head"] != out["want_head"]:
        raise AssertionError(f"sync: {out}")
    return out


class SimNode:
    """A node of the three-node sim: its own validators, pool, dev chain
    (a manual clock) and network; every gossip attestation's wait from
    receipt to verdict and every block's pool wait are kept."""

    def __init__(self, index: int, owned, n_validators: int, verifier, metrics=None):
        from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
        from lodestar_tpu_torch.chain.handlers import GossipHandlers
        from lodestar_tpu_torch.network import Network
        from lodestar_tpu_torch.node.dev_chain import DevChain
        from lodestar_tpu_torch.params import MINIMAL

        self.index, self.owned = index, set(owned)
        self.pool = BlsBatchPool(verifier, max_buffer_wait=0.01)
        self.batches = PoolBatches(self.pool)
        self.metrics = metrics
        self.dev = DevChain(MINIMAL, net_config(n_validators), n_validators, self.pool,
                            metrics=metrics)
        self.chain = self.dev.chain
        self.handlers = GossipHandlers(self.chain)
        self.att_waits, self.att_failed, self.block_waits, self.own_votes = [], 0, [], 0
        on_attestation = self.handlers.on_attestation

        async def timed(attestation, subnet=None):
            t0 = time.perf_counter()
            try:
                out = await on_attestation(attestation, subnet)
            except BaseException:
                self.att_failed += 1
                raise
            self.att_waits.append(time.perf_counter() - t0)
            return out

        self.handlers.on_attestation = timed
        timed_block_waits(self.chain, self.block_waits)
        self.net = Network(MINIMAL, self.chain, self.handlers)

    async def close(self):
        await self.net.close()
        self.pool.close()


def attest_subset(node: SimNode, slot: int):
    """Single-bit attestations of the node's own validators at ``slot``
    (tests/test_sim_multinode.py's ``_attest_subset``): [(attestation,
    subnet)]."""
    from lodestar_tpu_torch.params import DOMAIN_BEACON_ATTESTER, MINIMAL
    from lodestar_tpu_torch.params.presets import ATTESTATION_SUBNET_COUNT
    from lodestar_tpu_torch.ssz import Fields
    from lodestar_tpu_torch.state_transition import (
        clone_state, compute_epoch_at_slot, compute_start_slot_at_epoch, process_slots)
    from lodestar_tpu_torch.state_transition.domain import compute_signing_root, get_domain
    from lodestar_tpu_torch.types import get_types

    t = get_types(MINIMAL).phase0
    head_root = node.chain.head_root
    state = clone_state(MINIMAL, node.chain.head_state())
    ctx = process_slots(MINIMAL, node.chain.cfg, state, max(slot, state.slot))
    epoch = compute_epoch_at_slot(MINIMAL, slot)
    boundary_slot = compute_start_slot_at_epoch(MINIMAL, epoch)
    if boundary_slot >= state.slot:
        target_root = head_root
    else:
        target_root = bytes(state.block_roots[boundary_slot % MINIMAL.SLOTS_PER_HISTORICAL_ROOT])
    domain = get_domain(MINIMAL, state, DOMAIN_BEACON_ATTESTER, epoch)
    committees = ctx.get_committee_count_per_slot(epoch)
    out = []
    for index in range(committees):
        committee = ctx.get_beacon_committee(slot, index)
        data = Fields(slot=slot, index=index, beacon_block_root=head_root,
                      source=state.current_justified_checkpoint,
                      target=Fields(epoch=epoch, root=target_root))
        root = compute_signing_root(MINIMAL, t.AttestationData, data, domain)
        subnet = (committees * (slot % MINIMAL.SLOTS_PER_EPOCH) + index) % ATTESTATION_SUBNET_COUNT
        for pos, vi in enumerate(committee):
            if int(vi) not in node.owned:
                continue
            bits = [False] * len(committee)
            bits[pos] = True
            out.append((Fields(aggregation_bits=bits, data=data,
                               signature=node.dev.keys[int(vi)].sign(root).to_bytes()), subnet))
    return out


def pool_votes(node: SimNode, slot: int) -> int:
    return sum(len(g.bits_and_sigs)
               for g in node.chain.att_pool._by_slot.get(slot, {}).values())


async def three_node_sim(verifiers, n_validators: int = NET_VALIDATORS,
                         n_slots: int = NET_SIM_SLOTS, metrics=None, on_start=None) -> dict:
    """18b (tests/test_sim_multinode.py's three nodes): the line A-B-C,
    every block and every single-bit attestation over the wire, each
    node's pool over ``verifiers[i]`` (one verifier may serve all three),
    manual clocks.  Every slot's head must agree across the nodes and every
    node's attestation pool must hold every vote of the slot; each wait is
    bounded.  ``metrics``: a registry per node (or None)."""
    from lodestar_tpu_torch.params import MINIMAL
    from lodestar_tpu_torch.ssz import Fields
    from lodestar_tpu_torch.state_transition import (
        clone_state, compute_epoch_at_slot, process_slots)

    split = sim_split(n_validators)
    nodes = [SimNode(i, split[i], n_validators, verifiers[i],
                     metrics=metrics[i] if metrics else None) for i in range(NET_SIM_SPLIT)]
    try:
        p0 = await nodes[0].net.listen(0)
        p1 = await nodes[1].net.listen(0)
        await asyncio.wait_for(nodes[1].net.connect("127.0.0.1", p0), NET_WAIT_S)
        await asyncio.wait_for(nodes[2].net.connect("127.0.0.1", p1), NET_WAIT_S)
        if on_start is not None:
            on_start()
        heads, votes, head_wait, vote_wait = [], 0, [], []
        t0 = time.perf_counter()
        for slot in range(1, n_slots + 1):
            for n in nodes:
                n.dev.clock.set_slot(slot)
            state = clone_state(MINIMAL, nodes[0].chain.head_state())
            ctx = process_slots(MINIMAL, nodes[0].chain.cfg, state, slot)
            proposer = ctx.get_beacon_proposer(slot)
            owner = next(n for n in nodes if proposer in n.owned)
            att_slot = slot - MINIMAL.MIN_ATTESTATION_INCLUSION_DELAY
            aggs = []
            if att_slot >= 1:
                for data_root in list(owner.chain.att_pool._by_slot.get(att_slot, {})):
                    agg = owner.chain.att_pool.get_aggregate(att_slot, data_root)
                    if agg is not None:
                        aggs.append(agg)
            epoch = compute_epoch_at_slot(MINIMAL, slot)
            randao = owner.dev._sign_randao(state, proposer, epoch)
            block, _ = owner.chain.produce_block(slot, randao,
                                                 attestations=aggs[:MINIMAL.MAX_ATTESTATIONS])
            signed = Fields(message=block, signature=owner.dev._sign_block(state, block, proposer))
            root = await owner.chain.process_block(signed)
            await owner.net.publish_block(signed)
            head_wait.append(await wait_until(
                lambda: all(n.chain.head_root == root for n in nodes),
                f"every node's head at slot {slot}"))
            heads.append(root.hex())
            expected = 0
            for n in nodes:
                for att, subnet in attest_subset(n, slot):
                    n.chain.att_pool.add(att)
                    await n.net.publish_attestation(att, subnet=subnet)
                    n.own_votes += 1
                    expected += 1
            votes += expected
            vote_wait.append(await wait_until(
                lambda: all(pool_votes(n, slot) >= expected for n in nodes),
                f"every node's pool holding the {expected} votes of slot {slot}"))
        wall = time.perf_counter() - t0
    finally:
        for n in nodes:
            await n.close()
    outcomes = [dict(head=n.chain.head_root.hex(),
                     justified=[int(n.chain.head_state().current_justified_checkpoint.epoch),
                                bytes(n.chain.head_state().current_justified_checkpoint.root).hex()],
                     finalized=[int(n.chain.head_state().finalized_checkpoint.epoch),
                                bytes(n.chain.head_state().finalized_checkpoint.root).hex()])
                for n in nodes]
    if any(o != outcomes[0] for o in outcomes) or outcomes[0]["justified"][0] < 1:
        raise AssertionError(f"sim: the nodes end at {outcomes}")
    for n in nodes:
        # every vote of the other two nodes crossed the wire and verified
        if n.att_failed or len(n.att_waits) != votes - n.own_votes:
            raise AssertionError(f"sim: node {n.index} validated {len(n.att_waits)} gossip "
                                 f"attestations ({n.att_failed} failed) of "
                                 f"{votes - n.own_votes}")
    per_node = []
    for n in nodes:
        per_node.append(dict(
            validators=[min(n.owned), max(n.owned)], own_votes=n.own_votes,
            att_validated=len(n.att_waits),
            att_failed=n.att_failed, att_wait_s=percentiles(n.att_waits),
            blocks=len(n.block_waits), block_pool_wait_s=percentiles(n.block_waits),
            batches=n.batches.batches,
            state_transition_s=(n.metrics.state_transition_seconds.sum
                                / max(1, n.metrics.state_transition_seconds.count))
            if n.metrics is not None else None))
    return dict(outcome=outcomes[0], heads=heads, slots=n_slots, votes=votes, wall=wall,
                slots_per_s=n_slots / wall, head_wait_s=percentiles(head_wait),
                vote_wait_s=percentiles(vote_wait), nodes=per_node)


def host_sim(n_validators: int = NET_VALIDATORS, n_slots: int = NET_SIM_SLOTS) -> dict:
    """18b on the host, in a pool process: the same sim over the port's
    ``FastBlsVerifier`` (C) for the card's run to equal."""
    torch.set_num_threads(1)
    from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier

    verifier = FastBlsVerifier()
    return asyncio.run(three_node_sim([verifier] * NET_SIM_SPLIT, n_validators, n_slots))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rest_get(port: int, path: str, timeout: float = 30.0):
    """GET a child's REST route: (status, body bytes, seconds)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def rest_json(port: int, path: str) -> dict:
    status, body, _ = rest_get(port, path)
    if status != 200:
        raise AssertionError(f"cli: GET {path} on port {port} gave {status}: {body[:200]!r}")
    return json.loads(body)


def poll_rest(port: int, path: str, pred, what: str, timeout: float, proc) -> dict:
    """Poll a child's route until ``pred(json)`` holds; raises when the
    child exits or ``timeout`` passes."""
    import urllib.error

    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"cli: the child exited ({proc.returncode}) before {what}")
        try:
            doc = rest_json(port, path)
            if pred(doc):
                return doc
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"cli: {what} not reached in {timeout:.0f} s")
        time.sleep(0.2)


def log_seconds(path: str, needle: str):
    """The time of the first stderr log line holding ``needle`` (the
    command's text format: ``YYYY-MM-DD HH:MM:SS,mmm LEVEL ...``)."""
    import datetime

    with open(path, errors="replace") as f:
        for line in f:
            if needle in line:
                stamp = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
                return stamp.timestamp(), line.rstrip()
    return None, None


CLI_FAMILIES = ("lodestar_peers", "lodestar_gossip_", "lodestar_reqresp_",
                "lodestar_range_sync_", "lodestar_api_")


def cli_child(cmd: str, flags, out_dir: str, name: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "lodestar_tpu_torch.cli", cmd, *flags]
    log(f"cli: starting {name}: {' '.join(argv[1:])}")
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=open(os.path.join(out_dir, f"{name}.out"), "w"),
                   stderr=open(os.path.join(out_dir, f"{name}.err"), "w"))


def check_node_routes(port: int, name: str, peers: int, card: bool = True) -> dict:
    """The checks of 18c on one child's REST: one connected peer, the
    verifier's stages, the card's executor healthy (``card``; a host
    verifier has neither), the new metric families (when the child can
    expose them); each route's latency."""
    ms = {}
    for path in ("/eth/v1/node/syncing", "/eth/v1/node/peer_count", "/eth/v1/lodestar/bls_stages",
                 "/eth/v1/lodestar/health", "/eth/v1/lodestar/observatory", "/metrics",
                 "/eth/v1/beacon/headers/head"):
        status, body, dt = rest_get(port, path)
        ms[path] = round(dt * 1e3, 3)
        if status not in (200, 206):
            raise AssertionError(f"cli: {name} {path} gave {status}: {body[:200]!r}")
    count = rest_json(port, "/eth/v1/node/peer_count")["data"]
    if int(count["connected"]) != peers:
        raise AssertionError(f"cli: {name} has {count} peers, expected {peers} connected")
    stages = rest_json(port, "/eth/v1/lodestar/bls_stages")["data"]
    st = stages["stage_seconds"]
    health = rest_json(port, "/eth/v1/lodestar/health")["data"]
    execs = health.get("executors") or {}
    if card:
        if stages["verifier"] != "TorchBlsVerifier" or not (
                st.get("pack", 0) > 0 and st.get("dispatch", 0) + st.get("sync", 0) > 0
                and st.get("final_exp", 0) > 0):
            raise AssertionError(f"cli: {name} bls_stages {stages}")
        if not execs or any(h.get("state") != "healthy" for h in execs.values()):
            raise AssertionError(f"cli: {name} executors {execs}")
    elif stages["verifier"] != "FastBlsVerifier" or execs:
        raise AssertionError(f"cli: {name} bls_stages {stages}, executors {execs}")
    status, body, _ = rest_get(port, "/metrics")
    text = body.decode(errors="replace")
    try:
        import prometheus_client  # noqa: F401
        have_prom = True
    except ImportError:
        have_prom = False
    if have_prom:
        missing = [f for f in CLI_FAMILIES if f not in text]
        if missing:
            raise AssertionError(f"cli: {name} /metrics lacks {missing}")
    observatory = rest_json(port, "/eth/v1/lodestar/observatory")["data"]
    return dict(route_ms=ms, stages=st, executors=execs, dispatches=stages["dispatches"],
                sets_verified=stages["sets_verified"], metrics_checked=have_prom,
                metrics_bytes=len(body), compile_ledger=observatory["compile_ledger"]["by_entry"])


def run_cli_pair(out_dir: str, validators: int = NET_VALIDATORS, dev_head: int = CLI_DEV_HEAD,
                 host: bool = False, timeout: float = 600) -> dict:
    """18c: the README's two-node sync with the port's commands, each a
    child process on card 0 serving REST (``host``: both on
    ``--bls-verifier native``, the CPU rehearsal's).  Each wait is bounded
    by ``timeout`` seconds."""
    import signal

    os.makedirs(out_dir, exist_ok=True)
    p2p, rest_dev, rest_beacon, p2p_beacon = (free_port() for _ in range(4))
    common = ["--validators", str(validators), "--bls-buckets",
              ",".join(map(str, NET_BUCKETS)), "--bls-warmup", "blocking", "--metrics"]
    if host:
        common += ["--bls-verifier", "native"]
    out = {}
    t_dev = time.perf_counter()
    dev_proc = cli_child("dev", ["--slots", "0", "--listen-port", str(p2p), "--rest-port",
                                 str(rest_dev), *common], out_dir, "dev")
    beacon_proc = None
    try:
        poll_rest(rest_dev, "/eth/v1/node/syncing", lambda d: True, "the dev node's REST",
                  timeout, dev_proc)
        out["dev_rest_up_s"] = time.perf_counter() - t_dev
        h0 = int(rest_json(rest_dev, "/eth/v1/node/syncing")["data"]["head_slot"])
        t0 = time.perf_counter()
        doc = poll_rest(rest_dev, "/eth/v1/node/syncing",
                        lambda d: int(d["data"]["head_slot"]) > dev_head,
                        f"the dev node's head past slot {dev_head}", timeout, dev_proc)
        h1 = int(doc["data"]["head_slot"])
        out["dev_blocks_per_s"] = (h1 - h0) / (time.perf_counter() - t0)
        t_beacon = time.perf_counter()
        beacon_proc = cli_child("beacon", ["--connect", f"127.0.0.1:{p2p}", "--listen-port",
                                           str(p2p_beacon), "--rest-port", str(rest_beacon),
                                           *common], out_dir, "beacon")
        err = os.path.join(out_dir, "beacon.err")
        deadline = time.perf_counter() + timeout
        while log_seconds(err, "synced ")[0] is None:
            if beacon_proc.poll() is not None:
                raise AssertionError(f"cli: the beacon child exited ({beacon_proc.returncode})")
            if time.perf_counter() > deadline:
                raise AssertionError(f"cli: the beacon child did not sync in {timeout:.0f} s")
            time.sleep(0.2)
        out["beacon_synced_after_s"] = time.perf_counter() - t_beacon
        t_up, up_line = log_seconds(err, "beacon node: p2p port")
        t_sync, sync_line = log_seconds(err, "synced ")
        n_synced = int(sync_line.split("synced ")[1].split()[0])
        out["beacon_range_sync"] = dict(blocks=n_synced, seconds=t_sync - t_up,
                                        blocks_per_s=n_synced / (t_sync - t_up))
        for name, path in (("dev", os.path.join(out_dir, "dev.err")), ("beacon", err)):
            _, warm = log_seconds(path, "bls warmup:")
            out[f"{name}_warmup_line"] = warm
        syncing = rest_json(rest_beacon, "/eth/v1/node/syncing")["data"]
        if syncing["is_syncing"]:
            raise AssertionError(f"cli: the beacon node reports syncing {syncing}")
        head = rest_json(rest_beacon, "/eth/v1/beacon/headers/head")["data"]
        slot = int(head["header"]["message"]["slot"])
        # the dev chain has one producer: its block of that root is its
        # block of that slot
        dev_at = rest_json(rest_dev, f"/eth/v1/beacon/headers/{head['root']}")["data"]
        if dev_at["header"] != head["header"] or slot < dev_head:
            raise AssertionError(f"cli: the beacon node's head {head} is not the dev node's "
                                 f"{dev_at}")
        out["beacon_head"] = dict(slot=slot, root=head["root"])
        out["dev"] = check_node_routes(rest_dev, "dev", 1, card=not host)
        out["beacon"] = check_node_routes(rest_beacon, "beacon", 1, card=not host)
    finally:
        for proc in (beacon_proc, dev_proc):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        codes = {}
        for name, proc in (("beacon", beacon_proc), ("dev", dev_proc)):
            if proc is not None:
                try:
                    codes[name] = proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    codes[name] = proc.wait()
        out["exit_codes"] = codes
    for name in codes:
        with open(os.path.join(out_dir, f"{name}.err"), errors="replace") as f:
            text = f.read()
        if "Traceback" in text or codes[name] != 0:
            raise AssertionError(f"cli: the {name} child exited {codes[name]}; stderr tail "
                                 f"{text[-2000:]}")
    with open(os.path.join(out_dir, "dev.out")) as f:
        out["dev_final"] = json.loads(f.read().strip().splitlines()[-1])
    return out


def run_network(dev, card: str, pool) -> dict:
    """Phase 18: the node's network face with every pool on the card's
    split fused verifier: range sync over the wire (18a), three nodes over
    gossip held against the host's run of the same sim (18b), and the
    ``dev`` / ``beacon`` commands as child processes (18c)."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops import fused_core

    out = {}
    with Phase("18 network"):
        host = pool.apply_async(host_sim)
        verifier = TorchBlsVerifier(device=dev, buckets=NET_BUCKETS,
                                    rng=np.random.default_rng(SEED + 180))
        if not (verifier.fused and verifier.host_final_exp):
            raise AssertionError("network: the verifier is not the split fused default")
        warm = verifier.warmup()
        log(f"network: split fused graphs at buckets {NET_BUCKETS} warmed in {warm:.2f} s")

        def zero():
            fused_core.reset_launch_counts()
            sync_all()

        # 18a: range sync over the wire
        d0, stages0 = verifier.dispatches, dict(verifier.stage_seconds)
        rs = asyncio.run(sync_pair(verifier, on_start=zero))
        rs["launches"] = chain_launches(FUSED)
        rs["dispatches"] = verifier.dispatches - d0
        rs["stage_seconds"] = {k: verifier.stage_seconds[k] - stages0.get(k, 0.0)
                               for k in verifier.stage_seconds if k != "warmup"}
        rs["buckets"] = {}
        for _, n in rs["batches"]:
            b = verifier._bucket(n)
            rs["buckets"][b] = rs["buckets"].get(b, 0) + 1
        log("range sync: " + json.dumps({k: v for k, v in rs.items() if k != "launches"}))
        log(f"range sync: {rs['imported']} blocks at {NET_VALIDATORS} validators over the "
            f"loopback in {rs['wall']:.3f} s = {rs['blocks_per_s']:.3f} blocks/s, "
            f"{rs['segments']} segments, buckets {rs['buckets']} [{card}]")
        idle = [name for name in FUSED if rs["launches"][name] == 0]
        if idle:
            raise AssertionError(f"range sync: kernels never launched {idle}")
        out["range_sync"] = rs

        # 18b: three nodes over gossip, one verifier for the three pools
        metrics = [TallyMetrics() for _ in range(NET_SIM_SPLIT)]
        d0, stages0 = verifier.dispatches, dict(verifier.stage_seconds)
        sim = asyncio.run(three_node_sim([verifier] * NET_SIM_SPLIT, metrics=metrics,
                                         on_start=zero))
        sim["launches"] = chain_launches(FUSED)
        sim["dispatches"] = verifier.dispatches - d0
        sim["stage_seconds"] = {k: verifier.stage_seconds[k] - stages0.get(k, 0.0)
                                for k in verifier.stage_seconds if k != "warmup"}
        for node in sim["nodes"]:
            by = {}
            for lanes, n in node["batches"]:
                key = f"{lanes}@{verifier._bucket(n)}"
                by[key] = by.get(key, 0) + 1
            node["batches_by_lane_and_bucket"] = by
            node["batch_count"] = len(node.pop("batches"))
        log("gossip sim: " + json.dumps({k: v for k, v in sim.items()
                                         if k not in ("launches", "heads")}))
        log(f"gossip sim: {sim['slots']} slots, {sim['votes']} single-bit attestations over "
            f"three nodes in {sim['wall']:.3f} s = {sim['slots_per_s']:.3f} slots/s; "
            f"justified {sim['outcome']['justified'][0]}, finalized "
            f"{sim['outcome']['finalized'][0]} [{card}]")
        idle = [name for name in FUSED if sim["launches"][name] == 0]
        if idle:
            raise AssertionError(f"gossip sim: kernels never launched {idle}")
        ref = host.get(timeout=900)
        log(f"gossip sim: host run {ref['wall']:.3f} s = {ref['slots_per_s']:.3f} slots/s "
            f"(FastBlsVerifier in a pool process)")
        if ref["outcome"] != sim["outcome"] or ref["heads"] != sim["heads"]:
            raise AssertionError(f"gossip sim: the card's outcome {sim['outcome']} is not the "
                                 f"host's {ref['outcome']}")
        out["gossip"] = sim
        log("network: launches over range sync " + json.dumps(rs["launches"])
            + "; over the gossip sim " + json.dumps(sim["launches"]))
        verifier.close()

        # 18c: the commands
        torch.cuda.empty_cache()
        cli = run_cli_pair(os.path.join(REPO, "chiprun_out", "chip_smoke_cli"))
        log("cli: " + json.dumps(cli))
        log(f"cli: dev node {cli['dev_blocks_per_s']:.3f} blocks/s; beacon node range-synced "
            f"{cli['beacon_range_sync']['blocks']} blocks at "
            f"{cli['beacon_range_sync']['blocks_per_s']:.3f} blocks/s; heads equal at slot "
            f"{cli['beacon_head']['slot']} [{card}]")
        out["cli"] = cli
    return out


# -- phase 19: the validator client on the card ----------------------------------------

VAL_VALIDATORS = 128  # the chain phase's size: every minimal committee full
VAL_SLOTS = 3 * 8  # epochs 0-2: phase0, Altair, Bellatrix, so three fork versions
VAL_BUCKETS = CHAIN_BUCKETS  # a duty's job (1-2 sets), a block's (2-10)
VAL_HEAD_WAIT_S = 2.0  # the validator command's wait for the head: a third of a slot
VAL_CLI_HEAD = 8  # the node's head slot at which 19c stops its children


class PoolWaits:
    """Each job's wait on a pool, summed by slot: the block's (the
    block-proposal lane) and the duties' (every other lane)."""

    def __init__(self, pool):
        from lodestar_tpu_torch.crypto.bls.verifier import SignatureSetPriority

        self.slot, self.by_slot = 0, {}
        verify = pool.verify_signature_sets

        async def timed(sets, batchable=True, priority=None, deadline=None):
            t0 = time.perf_counter()
            try:
                return await verify(sets, batchable=batchable, priority=priority,
                                    deadline=deadline)
            finally:
                kind = "block" if priority == SignatureSetPriority.BLOCK_PROPOSAL else "duties"
                row = self.by_slot.setdefault(self.slot, dict(block_s=0.0, block_jobs=0,
                                                              duties_s=0.0, duty_jobs=0))
                row[f"{kind}_s"] += time.perf_counter() - t0
                row["block_jobs" if kind == "block" else "duty_jobs"] += 1

        pool.verify_signature_sets = timed


def included_votes(chain, duties, last_slot: int) -> dict:
    """The attester duties of slots 1..``last_slot`` whose vote is in a
    block of the head's chain: {"duties": n, "included": n, "missing": [...]}."""
    seen = set()
    root = chain.head_root
    while True:
        block = chain.get_block_by_root(root)
        if block is None or int(block.message.slot) == 0:
            break
        for att in block.message.body.attestations:
            for pos, bit in enumerate(att.aggregation_bits):
                if bit:
                    seen.add((int(att.data.slot), int(att.data.index), pos))
        root = bytes(block.message.parent_root)
    want = [(int(d["slot"]), int(d["committee_index"]), int(d["validator_committee_index"]),
             int(d["validator_index"]))
            for epoch_duties in duties.values() for d in epoch_duties
            if 1 <= int(d["slot"]) <= last_slot]
    missing = sorted(w[3] for w in want if w[:3] not in seen)
    return dict(duties=len(want), included=len(want) - len(missing), missing=missing[:16])


async def flare_child(port: int, *argv) -> float:
    """``python -m lodestar_tpu_torch.flare <argv> --server ...`` as a
    child, awaited without blocking the node's loop; returns its seconds."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "lodestar_tpu_torch.flare", *argv,
        "--server", f"http://127.0.0.1:{port}", cwd=REPO, env=env,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    out, err = await asyncio.wait_for(proc.communicate(), NET_WAIT_S)
    if proc.returncode != 0:
        raise AssertionError(f"validator: flare {argv} exited {proc.returncode}: "
                             f"{err.decode(errors='replace')[-2000:]}")
    return time.perf_counter() - t0


def header_of(header) -> dict:
    return dict(slot=int(header.slot), state_root=bytes(header.state_root).hex(),
                body_root=bytes(header.body_root).hex())


async def validator_duties(verifier, n_validators: int = VAL_VALIDATORS,
                           n_slots: int = VAL_SLOTS, protection_path: str = None,
                           on_start=None, on_end=None) -> dict:
    """19a and 19b: a node (``DevChain``'s chain over the interop genesis,
    a manual clock set to each slot, no producer of its own) behind the
    REST API with its gossip handlers and light-client server, its pool
    over ``verifier``; the port's ``ValidatorClient`` with every key
    drives ``n_slots`` slots of duties over HTTP, then ``flare`` slashes a
    proposer and an attester and one more slot's block carries both; then
    the port's ``LightClient`` bootstraps from the first Altair block and
    follows the node's updates.  ``on_start`` / ``on_end`` are called just
    before the first slot and just after the last one."""
    from lodestar_tpu_torch.api import ApiClient, RestApiServer
    from lodestar_tpu_torch.api.serde import from_json
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.chain.handlers import GossipHandlers
    from lodestar_tpu_torch.chain.light_client import LightClientServer
    from lodestar_tpu_torch.crypto.bls.api import interop_secret_key
    from lodestar_tpu_torch.light_client import LightClient
    from lodestar_tpu_torch.node.dev_chain import DevChain
    from lodestar_tpu_torch.params import MINIMAL
    from lodestar_tpu_torch.ssz import Fields
    from lodestar_tpu_torch.validator import (
        ChainHeaderTracker, SlashingError, SlashingProtection, ValidatorClient, ValidatorStore)

    cfg = chain_config(n_validators)
    per_epoch = MINIMAL.SLOTS_PER_EPOCH
    bls = BlsBatchPool(verifier, max_buffer_wait=0.005)
    batches, waits = PoolBatches(bls), PoolWaits(bls)
    node = DevChain(MINIMAL, cfg, n_validators, bls)
    chain = node.chain
    lc_server = LightClientServer(MINIMAL, chain)
    rest = RestApiServer(MINIMAL, chain)
    rest.gossip_handlers = GossipHandlers(chain)
    rest.light_client_server = lc_server
    port = await rest.listen(0)
    api = ApiClient("127.0.0.1", port)
    gvr = bytes(chain.genesis_state.genesis_validators_root)
    protection = SlashingProtection(persist_path=protection_path)
    # the interop keys are published: the variable-time ladder, as the
    # command's --dev-signing
    store = ValidatorStore(MINIMAL, cfg, {i: interop_secret_key(i) for i in range(n_validators)},
                           protection, genesis_validators_root=gvr, dev_signing=True)
    signed = [0]
    sign = store._sign

    def counted(index, root):
        signed[0] += 1
        return sign(index, root)

    store._sign = counted
    vc = ValidatorClient(MINIMAL, cfg, store, api)
    tracker = ChainHeaderTracker(api)
    tracker.start()
    vc.header_tracker = tracker
    heads, slot_s = [], []
    try:
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        for slot in range(1, n_slots + 1):
            t_slot = time.perf_counter()
            waits.slot = slot
            node.clock.set_slot(slot)
            await vc.run_slot(slot, head_wait_s=VAL_HEAD_WAIT_S)
            heads.append(chain.head_root.hex())
            slot_s.append(time.perf_counter() - t_slot)
        wall = time.perf_counter() - t0
        if on_end is not None:
            on_end()
        if len(set(heads)) != n_slots:
            raise AssertionError(f"validator: {len(set(heads))} heads in {n_slots} slots")

        # a second vote for a signed slot with another root: refused
        # before any signature leaves the store
        duty = vc._attester_duties[(n_slots - 1) // per_epoch][0]
        resp = await api.get(f"/eth/v1/validator/attestation_data?slot={duty['slot']}"
                             f"&committee_index={duty['committee_index']}")
        data = from_json(resp["data"])
        data.beacon_block_root = b"\x5a" * 32
        n_signed = signed[0]
        try:
            store.sign_attestation(int(duty["validator_index"]), data)
            refused = False
        except SlashingError:
            refused = signed[0] == n_signed

        # flare slashes a proposer and an attester that do not propose the
        # next slot, whose block must carry both slashings
        last = n_slots + 1
        epoch = last // per_epoch
        proposer = int(next(d["validator_index"] for d in (await api.get(
            f"/eth/v1/validator/duties/proposer/{epoch}"))["data"] if int(d["slot"]) == last))
        slashed = [i for i in range(n_validators) if i != proposer][:2]
        fork_epoch = (n_slots - 1) // per_epoch
        flare_s = [
            await flare_child(port, "self-slash-proposer", "--index-start", str(slashed[0]),
                              "--count", "1", "--slot", str(fork_epoch * per_epoch)),
            await flare_child(port, "self-slash-attester", "--index-start", str(slashed[1]),
                              "--count", "1", "--epoch", str(fork_epoch))]
        waits.slot = last
        node.clock.set_slot(last)
        await vc.run_slot(last, head_wait_s=VAL_HEAD_WAIT_S)
        heads.append(chain.head_root.hex())
        body = chain.get_block_by_root(chain.head_root).message.body
        state = chain.head_state()
        slashings = dict(proposer=len(body.proposer_slashings),
                         attester=len(body.attester_slashings),
                         slashed=[bool(state.validators[i].slashed) for i in slashed],
                         indices=slashed, flare_s=flare_s)
        if int(state.slot) != last or slashings["proposer"] != 1 or \
                slashings["attester"] != 1 or not all(slashings["slashed"]):
            raise AssertionError(f"validator: slot {last}'s block and state gave {slashings}")

        # every validator's vote in a block; each Altair block's sync
        # aggregate (the first one's signs the phase0 slot before it)
        votes = included_votes(chain, vc._attester_duties, n_slots)
        sync_bits = {}
        root = chain.head_root
        while True:
            block = chain.get_block_by_root(root).message
            if int(block.slot) <= per_epoch:
                break
            sync_bits[int(block.slot)] = sum(block.body.sync_aggregate.sync_committee_bits)
            root = bytes(block.parent_root)
        sync_bits = dict(sorted(sync_bits.items()))

        # 19b: the light client over the node's REST
        boot_root = heads[per_epoch - 1]
        boot = await api.get(f"/eth/v1/beacon/light_client/bootstrap/0x{boot_root}")
        lc = LightClient(MINIMAL, cfg, from_json(boot["data"]), gvr)
        ups = await api.get("/eth/v1/beacon/light_client/updates?start_period=0&count=4")
        for u in ups["data"]:
            lc.process_update(from_json(u))
        for route, process in (("finality_update", lc.process_finality_update),
                               ("optimistic_update", lc.process_optimistic_update)):
            status, body, _ = await asyncio.to_thread(
                rest_get, port, f"/eth/v1/beacon/light_client/{route}")
            if status == 200:
                process(from_json(json.loads(body)["data"]))
        light = dict(bootstrap_slot=per_epoch, updates=len(ups["data"]),
                     optimistic=header_of(lc.optimistic_header),
                     finalized=header_of(lc.finalized_header))
    finally:
        await tracker.stop()
        protection.close()
        await rest.close()
        bls.close()
    interchange = None
    if protection_path:
        with open(protection_path) as f:
            raw = f.read()
        back = SlashingProtection()
        back.import_json(raw)
        doc = json.loads(raw)
        interchange = dict(bytes=len(raw), validators=len(doc["data"]),
                           version=doc["metadata"]["interchange_format_version"])
    per_slot = [dict(slot=k, **v) for k, v in sorted(waits.by_slot.items())]
    return dict(outcome=chain_outcome(chain), heads=heads, slots=n_slots, wall=wall,
                slots_per_s=n_slots / wall, slot_s=slot_s, pool_waits=per_slot,
                batches=batches.batches, votes=votes, sync_bits=sync_bits,
                slashings=slashings, refused=refused, light=light,
                attested_on_event=vc.attested_on_event, head_events=tracker.events_seen,
                interchange=interchange)


def host_validator(n_validators: int = VAL_VALIDATORS, n_slots: int = VAL_SLOTS) -> dict:
    """19a and 19b on the host, in a pool process: the same run over the
    port's ``FastBlsVerifier`` (C) for the card's run to equal."""
    torch.set_num_threads(1)
    from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier

    return asyncio.run(validator_duties(FastBlsVerifier(), n_validators, n_slots))


def check_validator_run(got: dict, ref: dict, n_validators: int = VAL_VALIDATORS) -> None:
    """What 19a and 19b must show, and what they must share with the host
    run: every slot's head, the checkpoints, every vote, each Altair
    block's sync participation, both slashings, the refused double vote
    and the light client's headers."""
    if got["heads"] != ref["heads"] or got["outcome"] != ref["outcome"]:
        raise AssertionError(f"validator: the card's chain {got['outcome']} is not the host's "
                             f"{ref['outcome']}")
    if got["votes"]["missing"] or got["votes"]["duties"] < n_validators:
        raise AssertionError(f"validator: votes {got['votes']}")
    if got["sync_bits"] != ref["sync_bits"] or not all(got["sync_bits"].values()):
        raise AssertionError(f"validator: sync participation {got['sync_bits']} against the "
                             f"host's {ref['sync_bits']}")
    if got["slashings"]["indices"] != ref["slashings"]["indices"] or not got["refused"]:
        raise AssertionError(f"validator: slashings {got['slashings']}, double vote refused "
                             f"{got['refused']}")
    if got["light"] != ref["light"] or got["light"]["optimistic"]["slot"] <= 0:
        raise AssertionError(f"validator: light client {got['light']} against the host's "
                             f"{ref['light']}")


def run_cli_validator(out_dir: str, validators: int = VAL_VALIDATORS,
                      head: int = VAL_CLI_HEAD, host: bool = False,
                      timeout: float = 600) -> dict:
    """19c, the README's validator flow with the port's commands as child
    processes: ``account create`` and ``account list``; ``init`` writes an
    rc file, and ``beacon --config`` (no fork flags) starts from it on
    card 0 (``host``: ``--bls-verifier native``); ``validator`` drives it
    over REST with every interop key until the node's head passes ``head``;
    both stop on SIGINT.  Each wait is bounded by ``timeout`` seconds."""
    import signal

    from lodestar_tpu_torch.db.beacon import _fork_tagged_block_codec
    from lodestar_tpu_torch.params import MINIMAL
    from lodestar_tpu_torch.validator import SlashingProtection

    fresh_dir(out_dir)  # exactly --count keystores, an empty protection database
    out = {}
    password = os.path.join(out_dir, "password.txt")
    with open(password, "w") as f:
        f.write("correct horse battery staple\n")
    keystores = os.path.join(out_dir, "keystores")
    for name, flags in (("account_create", ["create", "--count", "2", "--kdf", "pbkdf2",
                                            "--out-dir", keystores, "--password-file", password]),
                        ("account_list", ["list", "--keystores-dir", keystores])):
        proc = cli_child("account", flags, out_dir, name)
        if proc.wait(timeout=timeout) != 0:
            raise AssertionError(f"cli: account {flags[0]} exited {proc.returncode}")
    with open(os.path.join(out_dir, "account_list.out")) as f:
        listed = sorted(line.split()[0][2:] for line in f if line.strip())
    files = sorted(n for n in os.listdir(keystores) if n.endswith(".json"))
    pubkeys = sorted(json.load(open(os.path.join(keystores, n)))["pubkey"] for n in files)
    if len(files) != 2 or listed != pubkeys:
        raise AssertionError(f"cli: account list gave {listed} for the keystores {pubkeys}")
    out["accounts"] = pubkeys

    rc = os.path.join(out_dir, "rc.json")
    p2p, rest = free_port(), free_port()
    flags = ["--validators", str(validators), "--bls-buckets", ",".join(map(str, VAL_BUCKETS)),
             "--bls-warmup", "blocking", "--metrics", "--listen-port", str(p2p), "--rest-port",
             str(rest), "--out", rc]
    if host:
        flags += ["--bls-verifier", "native"]
    proc = cli_child("init", flags, out_dir, "init")
    if proc.wait(timeout=timeout) != 0:
        raise AssertionError(f"cli: init exited {proc.returncode}")
    with open(rc) as f:
        out["rc"] = {k: v for k, v in json.load(f).items()
                     if k in ("validators", "bls_buckets", "rest_port", "bls_verifier")}
    protection = os.path.join(out_dir, "slashing_protection.json")
    beacon_proc = vc_proc = None
    t0 = time.perf_counter()
    try:
        beacon_proc = cli_child("beacon", ["--config", rc], out_dir, "beacon")
        poll_rest(rest, "/eth/v1/node/syncing", lambda d: True, "the beacon node's REST",
                  timeout, beacon_proc)
        out["beacon_rest_up_s"] = time.perf_counter() - t0
        # the rc file's validator count: the last interop validator exists
        rest_json(rest, f"/eth/v1/beacon/states/head/validators/{validators - 1}")
        t1 = time.perf_counter()
        vc_proc = cli_child("validator", ["--beacon-url", f"http://127.0.0.1:{rest}",
                                          "--interop-indices", f"0..{validators - 1}",
                                          "--slashing-protection-db", protection],
                            out_dir, "validator")
        doc = poll_rest(rest, "/eth/v1/node/syncing",
                        lambda d: int(d["data"]["head_slot"]) > head,
                        f"the beacon node's head past slot {head}", timeout, beacon_proc)
        wall = time.perf_counter() - t1
        if vc_proc.poll() is not None:
            raise AssertionError(f"cli: the validator child exited ({vc_proc.returncode})")
        out["head_slot"] = int(doc["data"]["head_slot"])
        out["validator_slots_per_s"] = out["head_slot"] / wall
        status, raw, _ = rest_get(rest, "/eth/v2/beacon/blocks/head")  # fork-tagged SSZ
        if status != 200:
            raise AssertionError(f"cli: GET the head block gave {status}")
        block = _fork_tagged_block_codec(MINIMAL)[1](raw).message
        out["head_attestations"] = len(block.body.attestations)
        if not out["head_attestations"]:
            raise AssertionError(f"cli: the head block at slot {block.slot} holds no "
                                 f"attestations")
        out["beacon"] = check_node_routes(rest, "beacon", 0, card=not host)
    finally:
        for p in (vc_proc, beacon_proc):
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGINT)
        codes = {}
        for name, p in (("validator", vc_proc), ("beacon", beacon_proc)):
            if p is not None:
                try:
                    codes[name] = p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes[name] = p.wait()
        out["exit_codes"] = codes
    for name in codes:
        with open(os.path.join(out_dir, f"{name}.err"), errors="replace") as f:
            text = f.read()
        if "Traceback" in text or codes[name] != 0:
            raise AssertionError(f"cli: the {name} child exited {codes[name]}; stderr tail "
                                 f"{text[-2000:]}")
    with open(protection) as f:
        raw = f.read()
    SlashingProtection().import_json(raw)
    doc = json.loads(raw)
    out["interchange"] = dict(bytes=len(raw), validators=len(doc["data"]),
                              version=doc["metadata"]["interchange_format_version"])
    # a validator has history once it signed: not those whose only duty
    # fell before the first slot the client ran
    if not 0 < len(doc["data"]) <= validators:
        raise AssertionError(f"cli: the interchange file holds {len(doc['data'])} validators")
    return out


def run_validator_phase(dev, card: str, pool, cli=None) -> dict:
    """Phase 19: the validator client's duties through the node's pool on
    the card's split fused verifier, held against the same run on the host
    (19a), the light client (19b), and the validator flow's commands as
    child processes (19c; ``cli``: its result when it ran earlier, beside
    phase 9)."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops import fused_core

    out = {}
    with Phase("19 validator"):
        host = pool.apply_async(host_validator)
        verifier = TorchBlsVerifier(device=dev, buckets=VAL_BUCKETS,
                                    rng=np.random.default_rng(SEED + 190))
        if not (verifier.fused and verifier.host_final_exp):
            raise AssertionError("validator: the verifier is not the split fused default")
        warm = verifier.warmup()
        log(f"validator: split fused graphs at buckets {VAL_BUCKETS} warmed in {warm:.2f} s")
        counts = {}

        def zero():
            fused_core.reset_launch_counts()
            sync_all()

        def read():
            sync_all()
            counts.update(chain_launches(FUSED))

        d0, stages0 = verifier.dispatches, dict(verifier.stage_seconds)
        # an empty protection database: the slots of an earlier run are signed
        out_dir = fresh_dir(os.path.join(REPO, "chiprun_out", "chip_smoke_validator"))
        run = asyncio.run(validator_duties(
            verifier, protection_path=os.path.join(out_dir, "slashing_protection.json"),
            on_start=zero, on_end=read))
        run["launches"] = counts
        run["dispatches"] = verifier.dispatches - d0
        run["stage_seconds"] = {k: verifier.stage_seconds[k] - stages0.get(k, 0.0)
                                for k in verifier.stage_seconds if k != "warmup"}
        by = {}
        for lanes, n in run["batches"]:
            key = f"{lanes}@{verifier._bucket(n)}"
            by[key] = by.get(key, 0) + 1
        run["batches_by_lane_and_bucket"] = by
        run["batch_count"] = len(run.pop("batches"))
        blocks = [w["block_s"] for w in run["pool_waits"] if w["block_jobs"]]
        duties = [w["duties_s"] for w in run["pool_waits"]]
        run["block_pool_wait_s"] = percentiles(blocks)
        run["duties_pool_wait_s"] = percentiles(duties)
        log("validator: " + json.dumps({k: v for k, v in run.items()
                                        if k not in ("launches", "heads")}))
        log(f"validator: {run['slots']} slots of duties at {VAL_VALIDATORS} validators over "
            f"HTTP in {run['wall']:.3f} s = {run['slots_per_s']:.3f} slots/s; per slot the "
            f"block's pool wait p50 {run['block_pool_wait_s']['p50']:.4f} s, the duties' "
            f"p50 {run['duties_pool_wait_s']['p50']:.4f} s; batches {by}; justified "
            f"{run['outcome']['justified'][0]}, finalized {run['outcome']['finalized'][0]}; "
            f"light client optimistic slot {run['light']['optimistic']['slot']}, finalized "
            f"slot {run['light']['finalized']['slot']} [{card}]")
        idle = [name for name in FUSED if run["launches"][name] == 0]
        if idle:
            raise AssertionError(f"validator: kernels never launched {idle}")
        ref = host.get(timeout=900)
        log(f"validator: host run {ref['wall']:.3f} s = {ref['slots_per_s']:.3f} slots/s "
            f"(FastBlsVerifier in a pool process)")
        check_validator_run(run, ref)
        log("validator: launches over the duties " + json.dumps(run["launches"]))
        out["validator"] = run
        verifier.close()

        # 19c: the commands
        where = "beside phase 9"
        if cli is None:
            torch.cuda.empty_cache()
            cli = run_cli_validator(os.path.join(REPO, "chiprun_out", "chip_smoke_validator_cli"))
            where = "alone"
        log("validator cli: " + json.dumps(cli))
        log(f"validator cli ({where}): the validator child drove the beacon node to slot "
            f"{cli['head_slot']} at {cli['validator_slots_per_s']:.3f} slots/s, the head "
            f"block carries {cli['head_attestations']} attestations [{card}]")
        out["cli"] = cli
    return out


# -- phase 16: the analysis layer on the card ---------------------------------------


def analysis_in_child(card: str) -> dict:
    """Phase 16 in a host process of the pool: the kernels line's
    columns (the report stays in the child)."""
    return {"kernels": run_analysis(card)["kernels"]}


def run_analysis(card: str) -> dict:
    """Phase 16: every analysis layer with the card's halves; fails on a
    violation.  Returns {"kernels": {name: the audit's columns of the
    kernels line}, "report": run_all's report}."""
    from lodestar_tpu_torch.analysis import format_report, run_all

    with Phase("16 analysis"):
        report: dict = {}
        violations = run_all(device="cuda", report=report, log=log)
        san = report["sanitizer"]
        if not san["carried"]:
            verdict = "not carried by the toolkit"
            log("analysis: compute-sanitizer: the card's CUDA toolkit does not carry it; "
                "racecheck, synccheck and memcheck not run")
        elif not san["supported"]:
            verdict = "refuses the device"
            log(f"analysis: {san['path']} ({san['version']}): {san.get('message')}; "
                f"racecheck, synccheck and memcheck not run; the child alone: "
                f"{san.get('child')}")
        else:
            verdict = ", ".join(f"{t} {r['status']}" for t, r in san["tools"].items())
            log(f"analysis: {san['path']} ({san['version']}): {verdict} over the sixteen "
                f"kernels at 37 rows")
        kernels = {}
        for r in report["resources"]:
            shared = r["static_shared_bytes"] + r["dynamic_shared_bytes"]
            log(f"analysis: {r['name']}: {r['registers']} registers, {r['local_bytes']} local "
                f"bytes, {r['static_shared_bytes']} + {r['dynamic_shared_bytes']} = {shared} "
                f"shared bytes (opt-in limit {r['optin']}), a block of {r['threads']} threads "
                f"(at most {r['max_threads']}) [{card}]")
            name = r["name"].split("[")[0]
            cols = {"registers": r["registers"], "local_bytes": r["local_bytes"],
                    "shared_bytes": shared, "sanitizer": verdict}
            if name == "ring_hop":  # three instances: the most of each
                prev = kernels.get(name)
                if prev is not None:
                    cols.update({k: max(prev[k], cols[k]) for k in
                                 ("registers", "local_bytes", "shared_bytes")})
            kernels[name] = cols
        for v in report["known"]:
            log(f"analysis: known violation (open, not clean): {v} [{card}]")
        log(f"analysis: layers {json.dumps(report['seconds'])} s; "
            f"{len(violations)} violation(s), {len(report['known'])} known violation(s)")
        if violations:
            raise RuntimeError("phase 16: the analysis found violations:\n"
                               + format_report(violations))
    return {"kernels": kernels, "report": report}


# -- phase 14: the durable store of built kernel libraries ------------------------

STORE_BUCKET = 4  # the bucket phase 14's processes warm and verify at

# Run in a fresh process by phase 14 (``python3 -c``, the repository root
# and a JSON file of the case on its command line): records every process
# it starts, then makes a verifier over the store, warms it at
# STORE_BUCKET and verifies the case's batches, timing the span from the
# verifier's construction to its first verdict; prints one JSON line.
STORE_CHILD = r"""
import json, os, shutil, subprocess, sys, time
started = []
class Watched(subprocess.Popen):
    def __init__(self, args, *a, **k):
        started.append(args if isinstance(args, str) else " ".join(map(str, args)))
        super().__init__(args, *a, **k)
subprocess.Popen = Watched
sys.path.insert(0, sys.argv[1])
case = json.load(open(sys.argv[2]))
import numpy as np
from lodestar_tpu_torch.aot import AotStoreMiss, KernelLibraryStore
from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.forensics import JOURNAL
from lodestar_tpu_torch.observatory import COMPILE_LEDGER
from lodestar_tpu_torch.ops.kernels import _build
if case.get("build_dir"):
    _build.BUILD_DIR = case["build_dir"]
store = KernelLibraryStore(path=case["store"])
out = {"which_nvcc": shutil.which("nvcc"), "cuda_home": os.environ.get("CUDA_HOME")}
batches = [[SingleSignatureSet(pubkey=PublicKey.from_bytes(bytes.fromhex(pk)),
                               signing_root=bytes.fromhex(m), signature=bytes.fromhex(sg))
            for pk, m, sg in batch] for batch in case["batches"]]
t_made = time.perf_counter()
v = TorchBlsVerifier(load_only=case["load_only"], aot_store=store,
                     rng=np.random.default_rng(case["seed"]))
t0 = time.perf_counter()
try:
    v.warmup((case["bucket"],))
    out["warmup_s"] = time.perf_counter() - t0
    out["library"] = {"kind": _build.build_kind, "seconds": _build.build_seconds}
    out["verdicts"] = [v.verify_signature_sets(batches[0])]
    out["first_verdict_s"] = time.perf_counter() - t_made
    out["verdicts"] += [v.verify_signature_sets(b) for b in batches[1:]]
except AotStoreMiss as e:
    out["raised"] = f"AotStoreMiss: {e}"
out["dispatches"] = v.dispatches
out["started"] = started
out["store"] = store.stats()
out["journal"] = [e["kind"] for e in JOURNAL.events() if e["kind"].startswith("aot.")]
out["ledger"] = COMPILE_LEDGER.session_summary()
print(json.dumps(out))
"""


def _without_nvcc(tmp: str) -> dict:
    """The environment with every directory holding an nvcc taken off PATH
    and CUDA_HOME pointing at an empty directory."""
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(d for d in env.get("PATH", "").split(os.pathsep)
                                  if d and not os.path.exists(os.path.join(d, "nvcc")))
    env["CUDA_HOME"] = os.path.join(tmp, "no_cuda")
    os.makedirs(env["CUDA_HOME"], exist_ok=True)
    return env


def store_child(tmp: str, name: str, case: dict, env=None) -> subprocess.Popen:
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(case, f)
    return subprocess.Popen([sys.executable, "-c", STORE_CHILD, REPO, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def store_result(name: str, proc: subprocess.Popen, timeout: float = 300) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"store: the {name} process did not end in {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"store: the {name} process failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    log(f"store: {name}: " + json.dumps(res))
    return res


def run_store(dev, card: str, sets, build: dict) -> dict:
    """Phase 14: this checkout's library saved to a temporary durable
    store, and three fresh processes at once: one with nvcc off its PATH
    and CUDA_HOME empty, under ``load_only=True``, loads it from the store,
    warms bucket 4 and verifies a valid and a corrupted batch (True,
    False) starting no nvcc; one on an empty store raises ``AotStoreMiss``
    before any batch; one, allowed to build into an empty build directory,
    finds a copy of the store whose payload ``chaos.corrupt_file``
    corrupted, quarantines it, rebuilds with nvcc, saves again and
    verifies the same two batches.  Logs the store's load seconds against
    the build's and the compile ledger's summary.  The three starts, each
    from a verifier's construction to its first verdict at bucket 4: cold
    (the rebuilding process: no usable library, nvcc), aot (the
    ``load_only`` process: the stored library) and warm (this process: the
    library from its memo)."""
    import shutil
    import tempfile

    from lodestar_tpu_torch.aot import KernelLibraryStore, capability_tag
    from lodestar_tpu_torch.chaos import corrupt_file
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.observatory import COMPILE_LEDGER
    from lodestar_tpu_torch.ops.kernels import _build

    batch = sets[:STORE_BUCKET]
    batches = [[(s.pubkey.to_bytes().hex(), s.signing_root.hex(), s.signature.hex())
                for s in b] for b in (batch, corrupt(batch, 1, 2))]
    with Phase("14 store"), tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        store = KernelLibraryStore(path=os.path.join(tmp, "store"))
        t0 = time.perf_counter()
        key = store.save(_build.ENTRY, (), _build._digest(()), _build.library_path(),
                         capability_tag(dev), nvcc=_build.nvcc_version())
        log(f"store: saved {key} ({time.perf_counter() - t0:.3f} s) to {store.path}: "
            + json.dumps(store.keys()[key]))
        bad_store = os.path.join(tmp, "corrupt")
        shutil.copytree(store.path, bad_store)
        corrupt_file(os.path.join(bad_store, store.keys()[key]["file"]), seed=SEED)
        case = dict(store=store.path, load_only=True, bucket=STORE_BUCKET, seed=SEED + 50,
                    batches=batches)
        env = _without_nvcc(tmp)
        procs = {"load_only": store_child(tmp, "load_only", case, env),
                 "empty store": store_child(tmp, "empty", dict(
                     case, store=os.path.join(tmp, "empty")), env),
                 "corrupt payload": store_child(tmp, "corrupt", dict(
                     case, store=bad_store, load_only=False,
                     build_dir=os.path.join(tmp, "build")))}
        loaded, empty, rebuilt = (store_result(n, p) for n, p in procs.items())
        nvcc = [c for r in (loaded, empty) for c in r["started"] if "nvcc" in c]
        if loaded["which_nvcc"] or nvcc:
            raise AssertionError(f"store: nvcc reachable or started under load_only: "
                                 f"{loaded['which_nvcc']} {nvcc}")
        if (loaded["library"]["kind"] != "aot_load" or loaded["verdicts"] != [True, False]
                or loaded["ledger"].get("kernels", {}).get("aot_load", {}).get("count") != 1):
            raise AssertionError("store: the load_only process did not load the stored "
                                 "library and verify True, False")
        if "AotStoreMiss" not in empty.get("raised", "") or empty["dispatches"] != 0:
            raise AssertionError("store: an empty store did not raise AotStoreMiss before any "
                                 "batch")
        files = sorted(os.listdir(os.path.join(bad_store, "entries")))
        if ("aot.corrupt" not in rebuilt["journal"] or rebuilt["library"]["kind"] != "build"
                or rebuilt["verdicts"] != [True, False]
                or not any(f.endswith(".quarantined") for f in files)
                or KernelLibraryStore(path=bad_store).verify()["ok"] != [key]):
            raise AssertionError(f"store: the corrupt payload was not quarantined, rebuilt and "
                                 f"saved again ({files})")
        load_s, build_s = loaded["library"]["seconds"], rebuilt["library"]["seconds"]
        log(f"store: library load from the store {load_s} s (load_only, no nvcc) against an "
            f"nvcc build {build_s} s in the same call (phase 1: {build['kind']} "
            f"{build['seconds']} s); load_only warmup at bucket {STORE_BUCKET} "
            f"{loaded['warmup_s']} s; the corrupt payload quarantined, journal "
            f"{rebuilt['journal']}; entries {files} [{card}]")
        ledger = COMPILE_LEDGER.configure(path=COMPILE_LEDGER.path)
        log("store: compile ledger " + json.dumps(ledger.summary()))
        # the warm start: this process's library comes from its memo
        t0 = time.perf_counter()
        warm = TorchBlsVerifier(rng=np.random.default_rng(SEED + 51))
        warm.warmup((STORE_BUCKET,))
        verdict = warm.verify_signature_sets(batch)
        warm_s = time.perf_counter() - t0
        warm.close()
        if verdict is not True:
            raise AssertionError("store: the warm start did not verify a valid batch")
        starts = dict(cold_s=rebuilt["first_verdict_s"], aot_s=loaded["first_verdict_s"],
                      warm_s=warm_s)
        log(f"store: from a verifier's construction to its first verdict at bucket "
            f"{STORE_BUCKET}: cold (nvcc) {starts['cold_s']} s, aot (the stored library, "
            f"load_only) {starts['aot_s']} s, warm (the library from this process's memo) "
            f"{starts['warm_s']} s [{card}]")
    return dict(load_s=load_s, build_s=build_s, **starts)


# -- phase 15: the observatory on the card ------------------------------------

OBS_BLOCK_SETS = 64  # the block-proposal job of phase 15's first round


class _Tally:
    """One metric family of ``TallyMetrics``: what was added, set and
    observed, by labels."""

    def __init__(self):
        self.children, self.value, self.count, self.sum = {}, 0.0, 0, 0.0

    def labels(self, **kw):
        return self.children.setdefault(tuple(sorted(kw.items())), _Tally())

    def inc(self, n=1.0):
        self.value += n

    def set(self, v):
        self.value = v

    def observe(self, v):
        self.count += 1
        self.sum += v

    def total(self, attr: str) -> float:
        return getattr(self, attr) + sum(c.total(attr) for c in self.children.values())


class TallyMetrics:
    """A metrics registry with the registry's attribute names that keeps
    what the port reports to it (the card's machine has no
    ``prometheus_client``, under which the port's registry is a no-op)."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        family = _Tally()
        setattr(self, name, family)
        return family


def _load_check_trace():
    """tools/check_trace.py (standard library only), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                    "check_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_intervals(doc, base: int):
    return [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in doc["traceEvents"]
            if isinstance(e.get("pid"), int) and e["pid"] >= base and e.get("ph") == "X"]


def _clock_check(summary, merged_dev, mono_minus_wall_us: float) -> dict:
    """The window's timebase, read from its raw export: torch.profiler's
    ``ts`` is microseconds after ``baseTimeNanoseconds`` (a wall-clock
    instant); with the wall and monotonic clocks read together, each
    event's exact host instant is known.  Returns how far the first
    kernel lies from the window's start, and how far the merge's clock map
    put it from its exact instant (the anchor's error)."""
    with open(summary["files"][0]) as f:
        raw = json.load(f)
    base_us = raw.get("baseTimeNanoseconds", 0) / 1e3
    events = raw["traceEvents"]
    window = [e for e in events if e.get("cat") == "Trace" and e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    first = min(kernels, key=lambda e: e["ts"])
    exact = base_us + first["ts"] + mono_minus_wall_us
    merged = min(t0 for t0, _t1, name in merged_dev if name == first["name"])
    return dict(base_time_ns=raw.get("baseTimeNanoseconds"),
                first_kernel_after_window_start_us=(first["ts"] - window[0]["ts"]) if window
                else None,
                anchor_error_us=merged - exact, raw_events=len(events), kernels=len(kernels))


def run_observatory(dev, card: str, pool, keys, sets256=None) -> dict:
    """Phase 15: the port's own entry (``cli.py``) with a profile window,
    the device sampler, the pool's metrics and the recorder's hooks."""
    import argparse
    import faulthandler
    import re
    import shutil
    import signal
    import tempfile

    from lodestar_tpu_torch import cli, tracing
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls.verifier import (
        SignatureSetPriority,
        VerificationDroppedError,
    )
    from lodestar_tpu_torch.forensics import RECORDER
    from lodestar_tpu_torch.observatory import attribution, device_sampler, xprof

    with Phase("15 observatory"):
        if sets256 is None:
            t0 = time.perf_counter()
            sets256 = make_sets(pool, keys, b"observatory")
            log(f"observatory: signed {len(sets256)} sets in {time.perf_counter() - t0:.1f} s")
        check_trace = _load_check_trace()
        tmp = tempfile.mkdtemp(prefix="chip-smoke-observatory-")
        args = cli.add_bls_flags(argparse.ArgumentParser()).parse_args([
            "--bls-buckets", str(BUCKET), "--bls-warmup", "blocking",
            "--torch-profile", os.path.join(tmp, "profile"), "--profile-window", "2",
            "--telemetry-interval-s", "0.2", "--forensics-dir", os.path.join(tmp, "forensics"),
            "--trace-dump", os.path.join(tmp, "trace.json")])
        tracing.TRACER.clear()
        xprof.CAPTURE = None
        metrics = TallyMetrics()
        mono_minus_wall_us = (time.monotonic_ns() - time.time_ns()) / 1e3
        cli.configure_tracing(args)
        t0 = time.perf_counter()
        bls = cli.make_pool(args, metrics=metrics)
        verifier = bls.verifier
        warm_window = xprof.get_capture().last_window()["summary"]
        log(f"observatory: make_verifier {time.perf_counter() - t0:.1f} s, warmup under the "
            f"profile window '{warm_window['label']}' ({warm_window['device_events']} device "
            f"events); verifier fused={verifier.fused} split={verifier.host_final_exp} on "
            f"{[ex.name for ex in verifier._executors]} buckets {verifier.buckets}")
        t0 = time.perf_counter()
        cli.configure_forensics(args, metrics=metrics, pool=bls)  # arms the window too
        configure_s = time.perf_counter() - t0
        cap = xprof.get_capture()
        sampler = device_sampler.SAMPLER
        try:
            # a fresh verifier: the first round packs cold (keys and
            # signatures decompressed), the later rounds' sets are cached
            gossip = gossip_jobs(list(sets256[OBS_BLOCK_SETS:]))
            block = list(sets256[:OBS_BLOCK_SETS])

            async def rounds():
                t1 = time.perf_counter()
                first = await asyncio.gather(
                    *[bls.verify_signature_sets(job) for job in gossip],
                    bls.verify_signature_sets(block, priority=SignatureSetPriority.BLOCK_PROPOSAL))
                n1 = len(bls.batch_spans)
                t2 = time.perf_counter()
                second = await bls.verify_signature_sets(list(sets256[:BUCKET]))
                return first, second, n1, (t2 - t1, time.perf_counter() - t2)

            t0 = time.perf_counter()
            first, second, n_first, round_s = asyncio.run(rounds())
            wall = time.perf_counter() - t0
            t_rounds = time.perf_counter()
            # the background sampler's view of the rounds: busy ticks of its
            # window (a batch is in the in-flight table from its enqueue to
            # its verdict's read)
            row_name = str(dev)
            background = (sampler.busy_ratio(row_name), sum(sampler._busy.get(row_name, ())),
                          sampler.ticks)
            if not cap.wait_idle(120.0):
                raise AssertionError("observatory: the profile window did not finish")
            finish_s = time.perf_counter() - t_rounds  # stop, export, parse, merge
            inside = bls.batch_spans[-1][1] - bls.batch_spans[-1][0]
            # the same batch once more, the window closed: the profiler's cost
            outside_v = asyncio.run(_verify_all(bls, [list(sets256[:BUCKET])]))
            outside = bls.batch_spans[-1][1] - bls.batch_spans[-1][0]
            jobs = len(gossip) + 1 + 2
            verdicts = list(first) + [second] + outside_v
            log(f"observatory: {len(gossip)} gossip jobs and one {len(block)}-set block job "
                f"({len(sets256)} sets), then one {BUCKET}-set job, in {wall} s (rounds "
                f"{round_s[0]} s, {round_s[1]} s; configure_forensics with the window's start "
                f"{configure_s:.2f} s before them): all True "
                f"{all(r is True for r in verdicts)}; {len(bls.batch_spans)} batches; the "
                f"window finished {finish_s:.1f} s after the last verdict")
            if not all(r is True for r in verdicts) or len(verdicts) != jobs:
                raise AssertionError("observatory: a valid job did not verify")
            snap = cap.snapshot()
            if snap["last_error"] is not None or snap["windows"] < 2:
                raise AssertionError(f"observatory: the window failed: {snap['last_error']}")
            last = cap.last_window()
            doc, summary = last["trace"], last["summary"]
            errs = check_trace.validate(doc) + check_trace.validate_device_merge(doc)
            if errs:
                raise AssertionError(f"observatory: the merged trace fails check_trace: {errs}")
            dev_iv = _device_intervals(doc, xprof.DEVICE_PID_BASE)
            names = {n for _a, _b, n in dev_iv}
            missing = [k for k in FUSED
                       if not any(re.search(rf"\b{k}_k\b", n) for n in names)]
            clock = _clock_check(summary, dev_iv, mono_minus_wall_us)
            log(f"observatory: window '{summary['label']}' over "
                f"{doc['otherData']['profile']['flushes']} flushes: "
                f"{len(dev_iv)} device events of {len(names)} names, skew {summary['skew_us']} "
                f"us, offset {summary['offset_us']} us; timebase: ts after "
                f"baseTimeNanoseconds {clock['base_time_ns']}, the first kernel "
                f"{clock['first_kernel_after_window_start_us']} us after the window's start, "
                f"the clock map's error at it {clock['anchor_error_us']} us; raw export "
                f"{clock['raw_events']} events ({clock['kernels']} kernels) [{card}]")
            if missing:
                raise AssertionError(f"observatory: the merged trace names no {missing}")
            # the device time by kernel name over the window's batches: the
            # port's kernels, and the glue ranked by op
            by_name = {}
            for t0_us, t1_us, name in dev_iv:
                by_name[name] = by_name.get(name, 0.0) + (t1_us - t0_us) / 1e3
            ours = {n: ms for n, ms in by_name.items() if re.search(r"\b[a-z0-9_]+_k\(", n)}
            glue = sorted(((ms, n) for n, ms in by_name.items() if n not in ours), reverse=True)
            log(f"observatory: device ms in the window: the port's kernels "
                f"{sum(ours.values())} ms, the rest {sum(ms for ms, _ in glue)} ms over "
                f"{len(glue)} names; the rest ranked: " + json.dumps(
                    [[round(ms, 3), n[:90]] for ms, n in glue[:10]]))
            report = attribution.attribute_spans(doc["traceEvents"])
            fallback = []
            for b in report["batches"]:
                d0, d1 = b["window_us"]
                evidence = any(t1 > d0 and t0 < d1 for t0, t1, _n in dev_iv)
                if not evidence:
                    fallback.append(b["cid"])
                log("observatory: batch " + json.dumps(
                    {"cid": b["cid"], "device": b["device"], "e2e_s": b["e2e_s"],
                     "device_evidence": evidence, "overlap_ratio": b["overlap_ratio"],
                     **b["stages"]}))
            log(f"observatory: the window's overlap ratio {report['overlap_ratio']} over "
                f"{len(report['batches'])} batches [{card}]")
            if len(report["batches"]) != n_first + 1 or fallback:
                raise AssertionError(f"observatory: batches {len(report['batches'])} (want "
                                     f"{n_first + 1}), without device evidence {fallback}")
            # one tick with a batch surely in flight (enqueued, its verdict
            # not read), then the row
            pending = verifier.verify_signature_sets_async(list(sets256[:BUCKET]))
            sampler.tick()
            row = sampler.snapshot()["devices"].get(row_name)
            if pending.result() is not True:
                raise AssertionError("observatory: the sampler's batch did not verify")
            total = torch.cuda.get_device_properties(dev).total_memory
            log(f"observatory: sampler row {row_name} {json.dumps(row)} after {sampler.ticks} "
                f"ticks, the last with a batch in flight (during the rounds: busy ratio "
                f"{background[0]}, {background[1]} busy of the window's ticks at tick "
                f"{background[2]}); sampler overhead ratio {sampler.overhead_ratio()}, capture "
                f"overhead ratio {cap.overhead_ratio()} [{card}]")
            if (row is None or not row["hbm"] or row["hbm"]["bytes_in_use"] <= 0
                    or row["hbm"]["bytes_limit"] != total or not row["busy_ratio"] > 0):
                raise AssertionError(f"observatory: the sampler's row is wrong: {row}")
            log(f"observatory: a {BUCKET}-set batch's wall inside the window {inside} s, "
                f"outside it {outside} s: the profiler's cost {inside - outside} s [{card}]")
            batches = len(bls.batch_spans)
            dispatches = metrics.bls_pool_dispatches_total.total("value")
            sets_seen = metrics.bls_pool_batch_size.total("sum")
            e2e = metrics.bls_e2e_verify_seconds.total("count")
            n_sets = len(sets256) + 2 * BUCKET
            log(f"observatory: pool metrics: dispatches {dispatches} (batches {batches}), "
                f"batch-size sum {sets_seen} (sets {n_sets}), e2e count {e2e} (jobs {jobs}); "
                f"bls_pool_sets_total {metrics.bls_pool_sets_total.total('value')} (the JAX "
                f"pool counts none)")
            if dispatches != batches or sets_seen != n_sets or e2e != jobs:
                raise AssertionError("observatory: the pool's metrics disagree with its batches")
            # a pool set to shed: one job past its deadline crosses a
            # threshold of 1 and writes one overload bundle
            shed = BlsBatchPool(verifier, overload_shed_threshold=1, max_buffer_wait=0.01,
                                metrics=metrics)

            async def shed_one():
                try:
                    await shed.verify_signature_sets(sets256[:2], deadline=time.monotonic() - 1)
                except VerificationDroppedError as e:
                    await shed._overload_task
                    return e.reason
                return None

            reason = asyncio.run(shed_one())
            shed.close()
            bundles = _bundles(RECORDER.dir, "overload")
            if reason != "deadline" or len(bundles) != 1:
                raise AssertionError(f"observatory: shed {reason}, overload bundles {bundles}")
            path, manifest = bundles[0]
            overload = manifest["overload"]
            with open(os.path.join(path, "profile.json")) as f:
                profile = json.load(f)
            log(f"observatory: overload bundle {os.path.basename(path)}: dropped by lane "
                f"{overload['dropped_by_lane']}, profile configured {profile['configured']}")
            if overload["dropped_by_lane"] != {"unaggregated": 2} or profile["configured"] is not True:
                raise AssertionError("observatory: the overload bundle is wrong")
            before = len(_bundles(RECORDER.dir, "sigusr2"))
            os.kill(os.getpid(), signal.SIGUSR2)
            time.sleep(0.2)
            after = len(_bundles(RECORDER.dir, "sigusr2"))
            log(f"observatory: SIGUSR2 after RECORDER.install(): bundles {before} -> {after}, "
                f"the process runs on")
            if after != before + 1:
                raise AssertionError("observatory: SIGUSR2 wrote no bundle")
            merged = cli.finalize_profile(args)
            cli.dump_trace(args.trace_dump)
            log(f"observatory: merged trace {merged}, span dump {args.trace_dump}")
        finally:
            device_sampler.stop_sampler()
            RECORDER.stop_watchdog()
            RECORDER.uninstall_signal_handlers()
            if RECORDER._prev_excepthook is not None:
                sys.excepthook, RECORDER._prev_excepthook = RECORDER._prev_excepthook, None
            faulthandler.disable()
            xprof.CAPTURE = None
            tracing.disable()
            tracing.TRACER.clear()
            bls.close()
            verifier.close()
            shutil.rmtree(tmp, ignore_errors=True)
    return dict(inside=inside, outside=outside, batches=len(report["batches"]))


# -- phase 20: the operations harnesses on the card -----------------------------------

OPS_SLO_RATE = 150.0  # sets/s at the SLO: ~45 % of phase 12's pool rate (329.83 on an H100)
OPS_SLO_S = 10.0
# the firehose reuses 16 signature sets, so the pack hits the point cache and
# the pool runs faster than on phase 12's fresh sets (329.83 sets/s): it kept
# up with 1,500 sets/s offered (1,393.4 verified on an H100), and verified
# 833.1-884.8 of 2,000, whose lanes never shed at intake (aggregates and
# blocks, ~37 % of the sets: ~750 sets/s) stay below that
OPS_OVERLOAD_RATE = 2000.0
OPS_OVERLOAD_S = 5.0
OPS_DEADLINE_MS = 400.0  # the storm lanes' deadline in the overload run
OPS_HIGH_WATER = 512  # pending sets: two merged batches in flight, two waiting
OPS_PREWARM_BUCKETS = (4, 16)
OPS_OUT = os.path.join(REPO, "chiprun_out", "chip_smoke_ops")


def _batches_by(spans, verifier) -> dict:
    """The pool's merged batches (its ``pool.batch`` spans) by bucket, and
    by lane: how many batches carried a job of each lane."""
    lanes = {}
    for sp in spans:
        if sp.name == "bls.queue_wait":
            lanes.setdefault(sp.cid, set()).add(sp.args["lane"])
    by_bucket, by_lane = {}, {}
    for sp in spans:
        if sp.name == "pool.batch":
            b = verifier._bucket(sp.args["sets"])
            by_bucket[b] = by_bucket.get(b, 0) + 1
            for lane in lanes.get(sp.cid, ()):
                by_lane[lane] = by_lane.get(lane, 0) + 1
    return dict(by_bucket=dict(sorted(by_bucket.items())), by_lane=dict(sorted(by_lane.items())))


def firehose_run(verifier, builder, rate: float, seconds: float, deadline_ms=None) -> dict:
    """One ``run_firehose`` window over a pool of its own."""
    from lodestar_tpu_torch import tracing
    from lodestar_tpu_torch.tools import firehose

    tracing.TRACER.clear()
    tracing.enable(1 << 18)
    pool = firehose.make_pool(verifier, high_water=OPS_HIGH_WATER)

    async def run():
        try:
            return await firehose.run_firehose(pool, rate=rate, duration_s=seconds,
                                               deadline_ms=deadline_ms, sets_builder=builder,
                                               seed=SEED)
        finally:
            pool.close()

    report = asyncio.run(run())
    report.update(batches=_batches_by(tracing.TRACER.spans(), verifier))
    tracing.disable()
    tracing.TRACER.clear()
    return report


def run_firehose_phase(dev, card: str) -> dict:
    """Phase 20a: the port's firehose on the card's split fused pool
    (buckets 4, 16 and 128, warmed first): an at-SLO window and an
    overload window, each over a pool of its own.  Both must account for
    every offered set with no future stranded and every verified job True;
    the overload run must shed at intake (backpressure) with the pool's
    pending sets within the bound backpressure sets.  Logs the achieved
    sets/s, queue wait and end-to-end p50 / p99 overall, per lane and per
    duty, the batches by lane and bucket, and the fused kernels' launches
    over both windows."""
    from lodestar_tpu_torch.forensics import RECORDER
    from lodestar_tpu_torch.ops import fused_core
    from lodestar_tpu_torch.tools import firehose

    out = {}
    # the overload run's shed-rate bundle lands beside the children's output
    RECORDER.configure(forensics_dir=os.path.join(OPS_OUT, "firehose"))
    with Phase("20a firehose"):
        t0 = time.perf_counter()
        verifier = firehose.card_verifier(dev)
        log(f"firehose: split fused graphs at buckets {firehose.CARD_BUCKETS} warmed in "
            f"{time.perf_counter() - t0:.2f} s")
        if not (verifier.fused and verifier.host_final_exp):
            raise AssertionError("firehose: the verifier is not the split fused default")
        builder = firehose._build_real_sets("cuda")
        fused_core.reset_launch_counts()
        d0 = verifier.dispatches
        for name, rate, seconds, deadline in (
                ("slo", OPS_SLO_RATE, OPS_SLO_S, None),
                ("overload", OPS_OVERLOAD_RATE, OPS_OVERLOAD_S, OPS_DEADLINE_MS)):
            r = firehose_run(verifier, builder, rate, seconds, deadline)
            out[name] = r
            log(f"firehose {name}: " + json.dumps(r))
            log(f"firehose {name}: offered {rate} sets/s for {seconds} s -> achieved "
                f"{r['achieved_sets_per_s']} sets/s ({r['verified_sets']} of "
                f"{r['offered_sets']} sets verified); queue wait p50 / p99 "
                f"{r['queue_wait']['p50_ms']} / {r['queue_wait']['p99_ms']} ms, end to end "
                f"{r['e2e']['p50_ms']} / {r['e2e']['p99_ms']} ms; per duty "
                + json.dumps({d: [v["p50_ms"], v["p99_ms"]] for d, v in r["e2e_by_duty"].items()})
                + "; queue wait per lane " + json.dumps(
                    {k: [v["p50_ms"], v["p99_ms"]] for k, v in r["queue_wait_by_lane"].items()})
                + f"; shed at intake {r['intake_shed_total']}, dropped "
                f"{r['dropped_sets_total']}, pending peak {r['pending_sets_peak']} (bound "
                f"{r['pending_sets_bound']}); batches "
                + json.dumps(r["batches"]) + f" [{card}]")
            bad = [o for o in r["outcomes"] if not (o == "verified_ok" or o.startswith("dropped_"))]
            if r["unaccounted_sets"] or r["stranded_futures"] or bad:
                raise AssertionError(f"firehose {name}: unaccounted {r['unaccounted_sets']}, "
                                     f"stranded {r['stranded_futures']}, outcomes {r['outcomes']}")
        over = out["overload"]
        if over["intake_shed_total"] == 0:
            raise AssertionError("firehose overload: backpressure never shed at intake")
        if over["pending_sets_peak"] > over["pending_sets_bound"]:
            raise AssertionError(f"firehose overload: pending sets {over['pending_sets_peak']} "
                                 f"above backpressure's bound {over['pending_sets_bound']}")
        out["launches"] = chain_launches(FUSED)
        out["dispatches"] = verifier.dispatches - d0
        idle = [name for name in FUSED if out["launches"][name] == 0]
        if idle:
            raise AssertionError(f"firehose: kernels never launched {idle}")
        log(f"firehose: {out['dispatches']} batches; launches over both windows "
            + json.dumps(out["launches"]))
        verifier.close()
    return out


# the second prewarmer: imported first, then it runs the farm as soon as the
# first one's farm lock exists, so that it meets a held lock whatever the
# two processes' start-up times
SECOND_PREWARMER = r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
from lodestar_tpu_torch.tools import prewarm
lock = os.path.join(sys.argv[2], prewarm.FARM_LOCK_NAME)
t_end = time.monotonic() + 300
while not os.path.exists(lock):
    if time.monotonic() > t_end:
        sys.exit(4)
    time.sleep(0.01)
sys.exit(prewarm.main(["--store", sys.argv[2], "--buckets", "4", "--lock-wait-s", "0.2"]))
"""


def _ops_child(args, env=None) -> subprocess.Popen:
    os.makedirs(OPS_OUT, exist_ok=True)
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _ops_wait(proc: subprocess.Popen, name: str, timeout: float) -> tuple:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"ops: {name} did not end in {timeout} s")
    with open(os.path.join(OPS_OUT, f"{name}.log"), "w") as f:
        f.write(out + "\n-- stderr --\n" + err)
    return proc.returncode, out, err


def run_chaos_phase(card: str) -> dict:
    """Phase 20b: the port's chaos campaign as a user runs it, ``python -m
    lodestar_tpu_torch.tools.chaos_campaign --json`` (the card by default), in a
    child process: device_loss, device_wedge, compile_fault and
    sharded_loss on the card's graphs (two executors of card 0 at bucket
    4; the sharded tier over 2 logical shards at bucket 4), the other four
    classes on the host.  Every scenario must hold with no verdict lost,
    and every bundle it names must pass the port's ``inspect_bundle`` here
    too.  Logs the time to quarantine and to recover, the recovery ratio,
    and the kernels' launches the child counted over the campaign's
    batches (its verifiers' warmups apart)."""
    from lodestar_tpu_torch.tools import inspect_bundle

    t0 = time.perf_counter()
    # the scenarios' stores start empty (an earlier run's would hold entries)
    out_dir = fresh_dir(os.path.join(OPS_OUT, "chaos"))
    proc = _ops_child(["-m", "lodestar_tpu_torch.tools.chaos_campaign",
                       "--json", "--out-dir", out_dir, "--seed", str(SEED % 1000)])
    rc, out, err = _ops_wait(proc, "chaos_campaign", 600)
    try:
        report = json.loads(out)
    except ValueError:
        raise AssertionError(f"chaos: no report (exit {rc}): {err[-2000:]}")
    wall = time.perf_counter() - t0
    summary = {name: {k: s.get(k) for k in ("ok", "on_card", "wall_s", "verdicts_lost",
                                             "requeued_batches", "failures")}
               for name, s in report["scenarios"].items()}
    log("chaos: " + json.dumps(summary))
    bundles = [b for s in report["scenarios"].values() for b in s.get("bundles") or []]
    invalid = {b: e for b in bundles for e in [inspect_bundle.validate(b)] if e}
    on_card = sorted(n for n, s in report["scenarios"].items() if s.get("on_card"))
    log(f"chaos: exit {rc}, ok {report['ok']}, verdicts lost {report['verdicts_lost']}, "
        f"{len(bundles)} bundles validated again here ({len(invalid)} invalid); on the card "
        f"{on_card}; time to quarantine {report['time_to_quarantine_s']} s, to recover "
        f"{report['time_to_recover_s']} s, recovery ratio "
        f"{report['throughput_recovery_ratio']}; campaign {wall:.1f} s [{card}]")
    if (rc != 0 or not report["ok"] or report["verdicts_lost"] or invalid
            or len(report["scenarios"]) != 8 or on_card != sorted(
                ("device_loss", "device_wedge", "compile_fault", "sharded_loss"))):
        raise AssertionError(f"chaos: the campaign failed: {report['failures']} {invalid}")
    launches = report["launches"]
    idle = [name for name in (*FUSED, "ring_hop") if launches.get(name, 0) == 0]
    if idle:
        raise AssertionError(f"chaos: kernels never launched {idle}")
    log("chaos: launches over the campaign's batches " + json.dumps(
        {n: launches[n] for n in (*FUSED, "ring_hop")}) + "; in its verifiers' warmups "
        + json.dumps({n: report["warmup_launches"][n] for n in (*FUSED, "ring_hop")}))
    return dict(report=report, launches=launches, wall=wall)


def run_prewarm_phase(card: str, sets) -> dict:
    """Phase 20c: the port's prewarm farm in child processes.  One fills an
    empty store for buckets 4 and 16; a second, running while the first
    holds the farm lock, exits 3; ``--verify`` exits 0.  Then a child with
    nvcc off its PATH and CUDA_HOME empty loads the library from that store
    under ``load_only``, warms bucket 4 and verifies a valid and a
    corrupted batch (True, False) starting no nvcc."""
    import tempfile

    batches = [[(s.pubkey.to_bytes().hex(), s.signing_root.hex(), s.signature.hex())
                for s in b] for b in (sets, corrupt(sets, 1, 2))]
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        first = _ops_child(["-m", "lodestar_tpu_torch.tools.prewarm", "--store", store,
                            "--buckets", ",".join(map(str, OPS_PREWARM_BUCKETS)), "--json"])
        second = _ops_child(["-c", SECOND_PREWARMER, REPO, store])
        rc2, _, err2 = _ops_wait(second, "prewarm_second", 300)
        rc1, out1, err1 = _ops_wait(first, "prewarm_first", 600)
        farm_wall = time.perf_counter() - t0
        if rc1 != 0:
            raise AssertionError(f"prewarm: the farm failed ({rc1}): {err1[-2000:]}")
        farm = json.loads(out1)
        log("prewarm: farm " + json.dumps(farm))
        log(f"prewarm: the second prewarmer exited {rc2}: {err2.strip()[-300:]}")
        if rc2 != 3 or farm["stats"]["saves"] != 1 or len(farm["entries"]) != 1:
            raise AssertionError(f"prewarm: the farm lock did not hold the second prewarmer "
                                 f"off ({rc2}), or the store holds {farm['entries']}")
        # the sweep and the restart read the store at once: neither writes it
        verify = _ops_child(["-m", "lodestar_tpu_torch.tools.prewarm", "--store", store,
                             "--verify", "--json"])
        case = dict(store=store, load_only=True, bucket=4, seed=SEED + 200, batches=batches)
        restart = store_child(tmp, "ops_load_only", case, _without_nvcc(tmp))
        rc3, out3, err3 = _ops_wait(verify, "prewarm_verify", 300)
        loaded = store_result("ops load_only", restart)
        sweep = json.loads(out3) if rc3 == 0 else None
        if rc3 != 0 or sweep["ok"] != farm["entries"] or sweep["corrupt"] or sweep["orphans"]:
            raise AssertionError(f"prewarm: --verify exited {rc3}: {out3[-500:]} {err3[-500:]}")
        nvcc = [c for c in loaded["started"] if "nvcc" in c]
        if (loaded["which_nvcc"] or nvcc or loaded["library"]["kind"] != "aot_load"
                or loaded["verdicts"] != [True, False]):
            raise AssertionError("prewarm: the load_only restart did not load the farm's "
                                 "library and verify True, False without nvcc")
        log(f"prewarm: farm wall {farm_wall:.2f} s (its warmup {farm['warmup_s']} s, library "
            f"{farm['library']}); second prewarmer exit 3; --verify ok {len(sweep['ok'])}; "
            f"load_only restart: library {loaded['library']}, warmup at bucket 4 "
            f"{loaded['warmup_s']:.2f} s, verdicts {loaded['verdicts']} [{card}]")
    return dict(farm_wall=farm_wall, farm_warmup_s=farm["warmup_s"],
                load_only_warmup_s=loaded["warmup_s"])


def run_chaos(card: str) -> dict:
    """Phase 20b, alone: its recovery ratio compares two rates."""
    with Phase("20b chaos"):
        return run_chaos_phase(card)


def run_prewarm(card: str) -> dict:
    """Phase 20c (its checks are exit codes, verdicts and files; its
    children run on the card)."""
    from lodestar_tpu_torch.tools.chaos_campaign import make_sets as signed_sets

    with Phase("20c prewarm"):
        return run_prewarm_phase(card, signed_sets(4, start=500))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
