#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
(and, with ``--only multicard``, on four) and check them.

    python3 chip_smoke.py                  # every phase; needs one card
    python3 chip_smoke.py --only kernels   # phases 1-3: build and check
    python3 chip_smoke.py --only gnn-times # and the GNN kernels' times
    python3 chip_smoke.py --only lm-times  # and the LM kernels' times
    python3 chip_smoke.py --only lm        # and the LM phases 12-13, 17-19
    python3 chip_smoke.py --only runtime   # phases 1-2 and the runtime's 11
    python3 chip_smoke.py --only graphs    # phases 1-2 and the graphs' 14
    python3 chip_smoke.py --only engine    # phases 1-2 and the engine's 15
    python3 chip_smoke.py --only examples  # phases 1-2 and the examples' 16
    python3 chip_smoke.py --only analysis  # phases 1-2 and the analysis' 20
    python3 chip_smoke.py --only ep        # phases 1-2 and the MoE EP's 21
    python3 chip_smoke.py --only ranks     # phases 1-2 and NCCL's 22
    python3 chip_smoke.py --only multicard # phases 1-2 and 23: four cards
    python3 chip_smoke.py --only dryrun    # phases 1-2 and the dry-run's 24
    python3 chip_smoke.py --only surface   # phases 1-2 and the public ops' 25
    python3 chip_smoke.py --only cache     # phases 1-2 and the cache's 26
    python3 chip_smoke.py --only softmax-times  # phases 1-2, B.3's times

Phases (each raises on failure, so the script exits non-zero):

1. device — the card's name, count and power limit (nvidia-smi);
2. build — nvcc builds the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` and prints the ``-Xptxas -v`` report;
3. kernels vs plain — each kernel, forward and backward, against its
   plain PyTorch version on the card, at the serving and training paths'
   bucket shapes and at the edge cases (empty, masked and all-masked
   rows, pad edges that clip to the last row, no edges, no rows, a width
   that is not a multiple of 4, 4 heads of 16, a cotangent that is not
   contiguous); the segment-max pair exactly, over ties, empty,
   all-masked and NaN rows, pad edges, no edges and no rows, at widths
   64, 128 and 130; both forward kernels also over hub rows of 5,000 to
   6,000 edges, which they cut into pieces and merge (masked,
   all-masked and NaN hubs, hubs at the first and last rows beside empty
   rows, pad edges behind a hub, 4 heads of 16), over the GAT-E cells'
   own 20,000-node alipay_like plan, and ``edge_softmax`` over two plans
   of 1.1 million rows plus edges, which it runs as merge-path chunks;
   on those power-law rows ``segment_sum`` is held against a float64
   sum, within 1e-5 of each row's sum of |x|, also at widths 4, 8, 32,
   64, 128 and 130 over hub rows of 65 to 5,000 edges; and rows of 65 to
   5,000 edges behind a leading row of 0, 1, 17 or 63 edges must give the
   same bits through ``segment_sum``, ``edge_softmax`` and
   ``segment_max`` (row cuts counted from the row's start), and through
   ``edge_softmax`` also behind 110,000 filler rows, in plans past its
   schedule switch that it runs as merge-path chunks, as must rows of 0
   to 5,000 edges (masked and all-masked among them) behind four counts
   of filler rows: the bits of the rows schedule;
4. serve GAT-E (alipay_like, 20,000 nodes, published widths) on the card
   through ``repro_torch.launch.serve_gnn``: 512 requests, 4 clients,
   cache on; every response held against the same port run on the CPU,
   a cache hit held against a full recompute (16 seeded targets and the
   graph's highest in-degree node), the kernel's launch count read;
5. serve GCN (reddit_like + self-loops, hidden 128), the same way;
6. kernel times at layer 0 of a full-graph step (GAT-E on a
   1,000,000-node alipay_like graph, GCN on reddit_like; the segment-max
   pair on the 1,000,000-node plan at width 64), forward and backward:
   each kernel held against its plain version there, then kernel, plain
   version and library call timed with CUDA events, beside the bound from
   bytes moved; and the gather backward (a segment sum over the source
   plan) beside torch's ``index_add_``; ``edge_softmax`` and
   ``segment_max`` also on a hub-free plan of the same N and E, on the
   cells' layer-0 plans and a bucket each, and ``edge_softmax`` on
   power-law plans either side of its schedule switch; the GAT-E
   gathers' backward (``segment_sum`` at widths 32 and 4) over the 1M
   source plan and the cells' 20,000-node source and destination plans,
   and ``edge_softmax_bwd`` at both sizes; one JSON ``plan row`` each,
   with the profiled device ms beside the CUDA-event time;
7. train GAT-E (alipay_like, 20,000 nodes, the config's widths and lr)
   on the card through ``repro_torch.api.make_trainer`` and ``fit``
   (builder threads at the default count), 30 steps under each of
   global, mini (compact) and cluster (compact, halo 1), and the same
   jobs on the CPU from the same seed: step-1 gradients and every
   step's loss held against the CPU's, the same jobs on the card with
   inline staging must give the same losses bit for bit (their steps/s
   printed beside the threads'), the global loss must
   fall, the backward kernel must launch the same number of times on
   every step, and each Sum-stage kernel's profiled device ms a step is
   printed; then the same 20 global steps run twice on the card must
   agree bit for bit;
8. train GCN (reddit_like + self-loops, hidden 128), the same way;
9. serve SAGE-max (reddit_like without self-loops, the Reddit config's
   widths with the model swapped), as in phases 4-5;
10. train SAGE-max (the same job), as in phases 7-8;
11. the fault-tolerant runtime on the GAT-E and GCN mini cells at the
    configs' widths, 30 steps each through ``api.make_trainer`` and
    ``fit``: inline staging, builder threads 1 and 3, sampler processes
    (2) and the chaos run (the reference's chaos plan and a sampler
    killed mid-build, 3 processes, a checkpoint every 5 steps) must agree
    bit for bit in losses and final parameters; a 15-step run with
    checkpoints and a fresh trainer's ``resume=True`` for 15 more must be
    the uninterrupted run, the stream's cursor at 30; skip_view and
    rollback (a checkpoint every 2 steps) with a divergence injected at
    view 4 must end at step 29 and equal, bit for bit, a run over views
    0-3 and 5-29; the card's step-15 checkpoint must take one step on the
    CPU within ``LOSS_TOL`` of the card's step-16 loss; the process pool
    must not degrade to threads. Then, for the mini and cluster cells of
    both configs, ``stage_s`` (the fit loop's ``step.stage_wait`` span,
    whose first wait holds a sampler pool's start), ``step_s`` (its
    ``step.dispatch`` and ``step.loss_wait``) and steps/s for inline
    staging, builder threads and sampler processes (default count), one
    JSON ``runtime row`` each;
12. serve Qwen3-4B at full width and depth (36 layers, d 2560) through
    ``repro_torch.launch.serve.BatchServer``: first the float32 parity
    gates on left-padded prompts (prefill plus 8 decode steps: the
    ``flash_attention`` kernel against its plain version at full depth
    on the card, one launch per layer on the kernel path and none on
    the plain one; then card against CPU at depth 2, decode fed seeded
    tokens and then the CPU's own argmax, the card's prefill launching
    the kernel once a layer), then a bf16 serving run of 8
    requests (prompts uniform in 512-2048 tokens, 128 new tokens each,
    batch 4) with its tokens/s, the kernel's launches per prefill batch,
    a profile of one short batch and the bf16 kernel-vs-plain
    difference (logits reported; every kernel call of one prefill held
    element by element to its plain version on the same inputs, and the
    gap split by layer). The serving run decodes through one CUDA graph per
    bucket (batch, cache length), captured once: the same server
    decoding eagerly (the same model, graphs off) must give the
    replay's tokens and every round's logits bit for bit on the first
    batch (32 new tokens), and decode tokens/s eager and replayed on that
    batch (32 new tokens, eager / replay / replay / eager) are printed
    with a JSON ``decode row``; the serving run's peak device memory;
13. serve RWKV-6 1.6B (24 layers, d 2048) the same way through the
    ``wkv6`` kernel (prompts of whole 128-token chunks, 512-2048; the
    parity gates also cover the prefill's final states).
17. (run after phase 13) serve Mixtral 8x7B and Qwen3-32B at full
    width. First ``examples/serve_lm_torch.py`` (reduced Mixtral, window
    16, rolling) on the card from its CPU run's weights: the same greedy
    tokens. Mixtral (d 4096, 32/8 heads of 128, d_ff 14336, 8 experts
    top-2, dense dispatch, vocab 32,000; 16 of its 32 layers, 47 GB in
    bf16, since 93.4 GB does not fit the card; neither model fits it in
    float32): float32 kernel vs plain at depth 4 with the window cut to
    64 and the rolling cache, so the parity prompts (160, 97, 40, 128)
    wrap it; card vs CPU at depth 2 (weights drawn on the card, copied
    to the CPU); the rolling cache vs the full cache on the card, depth
    2, 72 decode steps past the window, within 1e-4 of max|logit|; then
    the bf16 serving run at the published window 4,096 and rolling: 8
    seeded requests of 3,584-4,608 tokens (the prefill keeps the last
    4,096 keys of the longer ones; every batch's decode runs past the
    window's last slot, checked), 128 new tokens, batch 4,
    ``flash_attention`` in its window band once per layer per batch,
    the decode-graph gates. Qwen3-32B (64 layers, d 5120, 64/8 heads of
    128, d_ff 25600; 65.5 GB in bf16, each weight drawn in float32 and
    cast one tensor at a time): float32 kernel vs plain at depth 8, card
    vs CPU at depth 2, and the serving run of 8 requests of 512-2048
    tokens, 128 new, batch 4, with the decode-graph gates. Both print
    prefill and decode tokens/s and peak device memory; the eager/replay
    rate comparison decodes 32 new tokens.
18. (run after phase 17) serve Jamba-1.5-Large and MiniCPM3-4B at full
    width. Jamba (d 8192, 64/8 heads of 128, d_ff 24576, Mamba d_in
    16384 in 256 heads of 64, d_state 16, conv 4, chunk 128, vocab
    65,536) as one hybrid group of 8 layers (attention at layer 0, Mamba
    at 1-7, MoE on 1, 3, 5, 7): the group with all 16 experts is 90.4 GB
    in bf16, so the served group keeps 8 of them, top-2 (25.85 B
    parameters, 51.7 GB). Float32 gates on the group with 2 experts
    (45.4 GB): ``flash_attention`` against its plain version on prompts
    of (256, 200, 128, 97) tokens (two chunks) plus 8 seeded decode
    steps, one launch; the reference's cache contract, prefill(256)
    against prefill(128) plus 128 decode steps, within 1e-3 of
    max|logit|; the Mamba mixer alone at full width, B 2, T 256, card
    against CPU (output, final state, conv tail, then 8 decode steps);
    the reduced model card against CPU. Then the bf16 serving run: 8
    seeded requests of 512-2048 tokens in whole 128-token chunks, 128 new
    tokens, batch 4, one ``flash_attention`` launch a batch, the
    decode-graph gates, two bf16 prefills bitwise equal. MiniCPM3-4B (62
    layers, d 2560, 40 heads, q/kv latent ranks 768/256, vocab 73,448,
    tied embeddings; 8.15 GB in bf16), whose path runs no kernel (MLA is
    products): float32 card against CPU at depth 2, the cache contract
    at full depth (prefill(128) against prefill(64) plus 64 decode
    steps), then the serving run of 8 requests of 512-2048 tokens with
    the same gates and no kernel launched. Both print prefill and decode
    tokens/s, a decode round's ms against its weight-read bound and
    peak device memory.
19. (run after phase 18) serve Whisper-base and Qwen2-VL-2B at full
    width and depth, and train the LM zoo on the card. Whisper-base (6
    encoder layers over 1,500 frames, 6 decoder layers with
    cross-attention, d 512, 8 heads of 64, LayerNorm and GELU, vocab
    51,865): float32 ``flash_attention`` against its plain version at
    full depth on prompts of (64, 40, 17, 5) tokens plus 8 seeded decode
    steps (12 launches: the encoder's 6 bidirectional, the decoder's 6
    causal), the cache contract (prefill(128) against prefill(64) plus 64
    decode steps, each reading the encoder memory made once), card
    against CPU at 2 + 2 layers; then 20 seeded requests of 4-64 tokens,
    each with its own seeded (1,500, 512) frames, 128 new tokens, batch
    4: the encoder runs once a batch and its memory is carried to every
    decode round. Qwen2-VL-2B (28 layers, d 1536, 12/2 heads of 128,
    tied, vocab 151,936; 3.09 GB in bf16): the same float32 gates on
    prompts of (320, 290, 266, 384) tokens (the contract at 640), then 8
    seeded requests of 512-2048 positions, each holding one seeded image
    block of 16 x 16 patches (seeded embeddings) among its text (the
    table's), the three M-RoPE streams by the published rule, 128 new
    tokens. Both serve through ``prefill``, ``TransformerLM.encode`` and
    one captured ``DecodeGraph`` per bucket (``BatchServer`` takes token
    prompts only, as the reference's): tokens/s, a round's ms against the
    weight-read bound, the encoder's share of a prefill batch, peak
    memory, ``flash_attention`` once per attention layer per batch, the
    first batch replayed bitwise equal to eager and one capture, two
    bf16 prefills bitwise equal, every kernel call of a served prefill
    held element by element. Then ``train_lm`` (batch 8, seq 128, 30
    steps) on the card for reduced Whisper-base, Qwen2-VL-2B and RWKV-6,
    every step's loss within 1e-3 * max(1, |loss|) of the same run on
    the CPU from the same weights, and no kernel launched.
20. (run last) analysis on the card: ``repro_torch.analysis``'s full
    matrix with ``device="cuda"`` (combine-level forward and backward in
    the four modes, the engine ``Trainer``'s step and infer for the four
    models on every strategy's view, ``CompactTrainer``'s mini and
    cluster buckets, the two served steps, flash attention and wkv6 at
    the LM zoo's head dims), each step recorded through the CUDA kernels,
    the contract rules over every op log and ``cuda.resources`` over
    every compiled kernel of every source: any error finding fails the
    run, and so does a ``__global__`` function of the sources that the
    check did not read, or one of the eight kernels that no recorded
    step launched through CUDA. A JSON ``analysis row`` holds the contexts, the findings
    and each kernel's registers, static and dynamic shared memory and
    spilled bytes.
21. (run after phase 19) Mixtral 8x7B's MoE layers under expert
    parallelism (``build_model(cfg, moe_impl="ep", mesh=ExpertMesh(data,
    model))``, every rank on the one card through ``LocalComm``) at full
    width. Float32 at depth 2 with the window cut to 64, prefill at B 2,
    T 512: EP over (1, 8) at capacity factor 8.0 (nothing drops) against
    dense dispatch on the card within 1e-4 of max|logit|; EP over (1, 8)
    and (1, 1) at the config's 1.25 card against CPU within ``LM_CPU``,
    the dropped (token, expert) pairs counted and equal; two EP prefills
    bitwise equal; 8 seeded decode steps at (1, 1) card against CPU. The
    reduced config's loss and gradients with EP over (1, 4) at 8.0
    against dense and against the CPU. Then bf16 at depth 4 of 32: the
    prefill at B 2, T 4,096 under dense, EP (1, 1) and EP (1, 8), and 16
    eager decode steps at B 4 after a 1,024-token prompt under dense and
    EP (1, 1), one JSON ``ep row`` each (tokens/s, ms a step, the dropped
    share, peak memory, ``flash_attention`` launches; for a prefill the
    profiled device ms and its matrix products' share).
22. (run after phase 21) NCCL at world 1: the launcher
    (``repro_torch.launch.ranks``) starts one rank on the card, which
    holds all four partitions over a ``ProcessGroupComm``: the engine
    ``Trainer`` on GAT-E (the config's widths, the 20,000-node graph)
    fits 30 global steps under replay, bitwise the ``LocalComm`` fit
    from the same weights (phase 15's), with exactly one capture and
    the engine's four kernels launched; the reduced Mixtral's EP (1, 4)
    prefill over the group bitwise the ``LocalComm`` mesh's, with equal
    drops. A JSON ``ranks row``. Phase 23 is left to its own call.
23. (``--only multicard`` alone; four cards, raises on fewer) four
    NCCL ranks, one a card. GAT-E at the config's widths on the
    20,000-node graph, P=4, a partition a card, through
    ``api.make_trainer(TrainJob(ranks=4))``: step 1 within 1e-6 of the
    ``LocalComm`` engine's run on card 0 in the same call, then one
    ``Trainer`` over 30 global, 30 mini and 30 cluster steps with one
    capture a rank, every rank's losses bitwise equal, a second fit
    bitwise the first, the engine's four kernels launched on every card
    and no plain version called; GAT-E global on the 200,000-node graph
    (steps/s under replay, launches a step, bytes each card sends a
    step, the profiled busy and NCCL ms a step, each rank's busy share,
    the host's cores), one JSON ``engine row`` each. Mixtral 8x7B at
    full width under EP (1, 4), one model rank a card: float32 at depth
    4, B 2, T 512 against ``LocalComm`` (1, 4) on card 0 (within
    ``LM_CPU``, equal drops); then bf16 at all 32 layers (each card
    holds its two experts a layer), three prefills at B 2, T 4,096 (each
    rank routes its 1,024 positions), at least two bitwise equal, finite,
    32 ``flash_attention`` launches a prefill a rank, and a decode step
    over the four model ranks raising the reference's ``ValueError``;
    one JSON ``ep row`` (ms, tokens/s, the dropped share, peak memory a
    card, the NCCL share of the profiled device ms).
24. (run after phase 22) the dry-run against one card: Qwen3-4B at full
    width and 4 of its 36 layers in bf16, planned by
    ``repro_torch.launch.dryrun.run_one`` at mesh (1, 1) (the port's
    step traced on fake tensors on the host), then run on the card:
    AdamW train steps at B 1, T 4,096 under remat full, dots and none,
    phase 12's prefill (B 4, T 2,048) and one decode round after it.
    For each, the planned held bytes against ``memory_allocated`` once
    the state exists (within 1%) and the planned peak against
    ``max_memory_allocated`` (a ratio within [0.8, 1.25]), counted from
    what the card holds once a reduced step has made cuBLAS's
    workspaces; the train peaks must order none >= dots >= full,
    planned and on the card; one JSON ``dryrun row`` each, with the
    step's CUDA-event ms beside the roofline's bound from the same
    record (printed, not gated).
25. (run after phase 24) the rest of the JAX package's public surface
    on the card: ``repro_torch.core.tgar``'s ``segment_sum`` at width
    32, ``segment_max`` at 64 and ``segment_softmax`` at 4 heads of 8
    over the 1,000,000-node alipay_like edge set (5,999,786 edges, phase
    6's graph, kept from there) in a shuffled order, over its nodes and 8
    more segments that stay empty, with one negative id and one past the
    segments (dropped, as ``jax.ops.segment_*`` drop them): forward and
    ``torch.autograd.grad``, each call planning its ids on the host.
    Calls over the first 100,000 edges are recorded (no ``index_add_`` or
    ``scatter_*`` op, every kernel call through CUDA, no plain version);
    two calls over every edge must be bitwise equal, the launch counters
    must show ``segment_sum``, ``segment_sum_bwd``, ``edge_softmax``,
    ``edge_softmax_bwd`` and ``segment_max``, and each is held against
    its plain version on the same inputs (the sum within 1e-5 of a
    float64 sum's row scale; the softmax 1e-5 of a float64 run;
    ``segment_max`` and its tie-splitting gradient exactly, -inf on the
    empty rows). A third call of each is timed, its plan's build inside
    it, beside the same work on that plan and the ``csc`` backend's (a
    JSON ``surface row`` each). ``repro_torch.launch.train.train_gnn(
    "alipay_like", "gat_e", "global", steps=30, hidden=32,
    eval_every=5)`` runs on the card, and its losses must lie within
    1e-3 * max(1, |loss|) of the same call on the CPU, which runs in a
    thread beside the two calls and the plain checks (a JSON
    ``train_gnn row``). ``combine_messages`` under ``max`` with no plan
    (``backend=None`` and ``"csc"``) over the edges into 20,000 segments,
    messages from a few levels so that rows tie: on the card through the
    kernels, no scatter op, its forward and its tie-splitting gradient
    equal to the CPU's exactly. The phase keeps to 30 s, the graph's
    generation aside.
26. (run after phase 4) the cache contract past ``edge_softmax``'s
    schedule switch: GAT-E served at the config's widths on alipay_like
    at 200,000 nodes (1,199,822 edges) with the default ladder, for 4,097
    and 16,385 targets (seeded, and the graph's highest in-degree node):
    each view's bucket and schedule printed (the recompute's 2-hop view
    past 2^19 rows plus edges both times, the hit's 1-hop view under it
    and then past it, or the run fails), and the hit bitwise equal to the
    recompute and to a ``cache=False`` server. The phase keeps to 30 s.
14. CUDA graphs per bucket (run after phase 11): the GNN train step
    (forward, backward, Adam) and the served forward are one CUDA graph
    per bucket on the card, the default, so phases 4-11 already run
    under replay; here every training cell (GAT-E, GCN and SAGE-max at
    the configs' widths under global, mini and cluster on compact views,
    and dense mini and cluster for GAT-E and GCN) runs 30 steps eagerly
    (``cuda_graphs=False``) and 30 under replay: losses, step-1 gradients
    and final parameters bitwise equal, exactly one capture per touched
    bucket (``assert_compiled_per_bucket``); the dense cells also against
    the CPU (phases 7-8's tolerances) and against the compact cell on the
    same stream indices (losses within 1e-3 * max(1, |loss|): cuBLAS may
    pick other algorithms for other row counts); then steady steps/s
    eager against replay in alternating order and the busy share under
    replay, one JSON ``graphs row`` each. The three served models: 512
    responses in fixed batches bitwise equal eager against replay, a
    cache hit bitwise a recompute under replay, one capture per bucket,
    and QPS and p50/p99 eager against replay (``serve row``). Last, five
    alternating pairs of builder threads against inline staging under
    replay on the GAT-E and GCN mini cells, every fit's losses bitwise
    equal (``pairs row``).
15. the distributed engine (run after phase 14): the engine ``Trainer``
    through ``repro_torch.api.make_trainer`` with ``engine_partitions=4``
    (``1d_src``), all four partitions on the one card (``LocalComm``: no
    network time is measured). First ``segment_max`` and
    ``segment_max_bwd`` at width 4, GAT-E's logits, on shard 0's plan of
    the 20,000-node alipay_like graph, exactly their plain versions over
    ties and masked entries, timed (``plan row``). Then GAT-E (the
    config's widths) on that graph: one Trainer fits 30 steps of global,
    then mini, then cluster views (compact), with no restart, exactly one
    capture of the step; step 1 on the card against the CPU engine
    (loss and gradients within 1e-4) and its loss against one block's
    (the card ``CompactTrainer``) on the same global view within
    1e-4 * max(1, |loss|); the replayed fit bitwise equal to an eager
    one and to a second replayed fit; ``segment_sum``, ``segment_sum_bwd``,
    ``segment_max`` and ``segment_max_bwd`` launched, and no plain
    version called (the halo max's backward counts its ties with
    ``segment_sum`` and hands out the shares with ``segment_max_bwd``,
    ROADMAP C.20). GCN and SAGE-max (the Reddit config) on reddit_like
    over global views, the same checks. The engine's chaos scenarios,
    each bitwise its clean run. Last, GAT-E global on a 200,000-node
    alipay_like graph at P=1 and P=4. Each run prints a JSON ``engine
    row``: steps/s eager and under replay, the replayed step's busy
    share, launches per step by kernel, halo values per sync, the floats
    per value and bytes exchanged per step, and ``build_partitions``
    seconds. A ``gather row`` per width times ``index_select``, the
    engine's gathers, beside advanced indexing at the 200k graph's
    edges.
16. the examples (run after phase 15), each ``main`` on the card:
    ``examples/quickstart_torch.py`` (GCN on cora, 100 Adam steps, then
    the facade: ``api.train`` -> ``api.serve``, certified once per
    bucket), its losses within 1e-4 of the same script's CPU run, which
    the phase also makes, and its test accuracy within 0.01;
    ``examples/strategy_comparison_torch.py`` (the five rows of Tables
    2-4 in miniature, 120 steps each, through one engine ``Trainer`` at
    P=4): exactly one capture across the rows, and the global row run
    again bitwise equal, one JSON ``strategy row`` each;
    ``examples/distributed_training_torch.py`` (GAT-E on 8,000 alipay_like
    nodes at P=8, 60 steps per strategy): one capture, and two fits
    bitwise equal.

Phase 3 also holds ``flash_attention`` (causal, non-causal, window,
``seq_len < T``, ``kv_start`` with fully masked rows, GQA 1 and 4, D 32,
64 and 128, ragged T, T 129, 255 and 4,100 across the bf16 kernel's
tiles, a ``kv_start`` and a window edge inside a tile, Mixtral's served
prefill: T 4,608 in a window of 4,096 behind a left pad, Jamba's: B 4,
T 2,048, 64/8 heads, left pads; Whisper's encoder: B 4, T 1,500,
bidirectional, 8/8 heads of 64, and its decoder's prefill; Qwen2-VL's
served prefill: B 4, T 2,048, 12/2 heads of 128, a group of 6, left
pads) and ``wkv6``
(B > 1, ragged T, T 1 and 33, B*H of 4, the final state; o in r's type
and float32) in float32 and bfloat16 (element by element) against their
plain versions; phase 6 times them at the Qwen3-4B and RWKV-6 1.6B
prefill shapes and at the served batch's (``flash_attention`` also at
Mixtral's windowed prefill, B 2, T 4,608, window 4,096), that kernel
beside ``scaled_dot_product_attention`` (timed only: the port never
calls it) and that call's share of the bf16 element gate. Phases 12-13
and 17-18 print each LM kernel's profiled device ms per batch and gate
two identical bf16 prefills bitwise equal. The GNN cache hits of phases 4,
5 and 9 must equal a full recompute bit for bit.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
RTOL = ATOL = 1e-5                 # kernel vs plain: sums in another order
WKV_TOL = 1e-4                     # wkv6 vs plain, float32
BF16_RTOL = 1e-2                   # LM kernels vs plain in bf16, each
BF16_ATOL = 1e-3                   # element: one bf16 ulp (< 2^-7 |out|),
                                   # plus 1e-3 * rms(out) of float32 noise
LIB_REL = 2e-2                     # bf16 kernel vs the library call,
                                   # * max|out| (it rounds p to bf16)
LM_PARITY = 1e-3                   # f32 kernel vs plain logits, * max|logit|
LM_CPU = 1e-4                      # f32 card vs CPU logits, * max|logit|
SERVE_TOL = 1e-4                   # card vs CPU responses
GRAD_TOL = 1e-4                    # card vs CPU step-1 gradients, relative
LOSS_TOL = 1e-3                    # card vs CPU losses, * max(1, |loss|)
TRAIN_STEPS = 30
RUNTIME_STEPS = 30                 # phase 11's runs
# the reference's chaos plan (tests/test_faults.py) and a sampler process
# killed mid-build: every fault is retried or recovered, so the run is
# bitwise the fault-free one
CHAOS_PLAN = {"worker_kill": {1}, "view_build": {0, 2}, "device_put": {0},
              "checkpoint_save": {0}, "proc_kill": {3}}
FAST = dict(backoff_base=0.0, backoff_cap=0.0, jitter=0.0)
DEVICE = "cuda"
KERNEL_NODES = 1_000_000           # alipay_like nodes for the GAT-E timing
KERNELS = {
    "segment_sum": {
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum.py:164"},
    "edge_softmax": {
        "source": "src/repro_torch/kernels/csrc/edge_softmax.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:98"},
    "segment_sum_bwd": {
        "source": "src/repro_torch/kernels/csrc/segment_sum_bwd.cu",
        "replaces": "src/repro/kernels/backward.py:84"},
    "edge_softmax_bwd": {
        "source": "src/repro_torch/kernels/csrc/edge_softmax_bwd.cu",
        "replaces": "src/repro/kernels/backward.py:220"},
    "segment_max": {
        "source": "src/repro_torch/kernels/csrc/segment_max.cu",
        "replaces": "src/repro/kernels/segment_sum.py:230"},
    "segment_max_bwd": {
        "source": "src/repro_torch/kernels/csrc/segment_max_bwd.cu",
        "replaces": "src/repro/kernels/backward.py:140"},
    "flash_attention": {
        # bf16, the served path's (float32 keeps flash_attention.cu)
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89"},
    "wkv6": {
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:78"},
}
MAX_WIDTH = 64                     # the Reddit config's feature width
LM_REQUESTS = 8                    # LM serving run: seeded requests
                                   # (cut from 40, 24 and 12, with the
                                   # other LM paths' to two batches, to
                                   # keep the full run inside its time),
LM_PROMPTS = (512, 2048)           # prompt lengths uniform in this range,
LM_NEW_TOKENS = 128                # new tokens each,
LM_BATCH = 4                       # in batches of 4
DECODE_CHECK_TOKENS = 32           # replay vs eager decode, new tokens
# phase 17: Mixtral 8x7B at full width, 16 of its 32 layers (47 GB of
# bf16 weights; 93.4 GB at full depth does not fit the 80 GB card), and
# Qwen3-32B at full width and depth (65.5 GB)
MIXTRAL_LAYERS = 16
MIXTRAL_REQUESTS = 8               # prompts of 3,584-4,608 tokens: the
MIXTRAL_PROMPTS = (3584, 4608)     # prefill keeps the last 4,096 keys of
                                   # the longer ones, every decode wraps
QWEN32_REQUESTS = 8                # prompts of LM_PROMPTS' 512-2,048
PARITY_PROMPTS = (160, 97, 40, 128)  # phase 17's parity batch
PARITY_WINDOW = 64                 # Mixtral's window in the parity gates,
                                   # so that those prompts wrap the cache
ROLL_TOL = 1e-4                    # rolling vs full cache, * max|logit|
# phase 18: Jamba-1.5-Large as one hybrid group (attention at layer 0,
# Mamba at 1-7, MoE on 1, 3, 5, 7) at full width with 8 of its 16
# experts, top-2 (25.85 B parameters, 51.7 GB in bf16; the group with all
# 16 is 90.4 GB), and MiniCPM3-4B at full width and depth (8.15 GB)
JAMBA_LAYERS = 8
JAMBA_EXPERTS = 8
JAMBA_PARITY_EXPERTS = 2           # the float32 gates' group: 45.4 GB
JAMBA_REQUESTS = 8                 # prompts of whole 128-token chunks
MINICPM_REQUESTS = 8               # prompts of LM_PROMPTS' 512-2,048
JAMBA_PARITY_PROMPTS = (256, 200, 128, 97)   # padded to two chunks
CONTRACT_TOL = 1e-3                # prefill(S) vs prefill(S/2) + decodes,
                                   # * max|logit|
# phase 19: Whisper-base (6 + 6 layers, d 512) and Qwen2-VL-2B (28 layers,
# d 1536, 12/2 heads of 128) at full width and depth, and LM training
WHISPER_REQUESTS = 20              # decoder prompts of 4-64 tokens, each
WHISPER_PROMPTS = (4, 64)          # with its own 1,500 seeded frames:
                                   # inside the 448-token text context
WHISPER_PARITY_PROMPTS = (64, 40, 17, 5)
VL_REQUESTS = 8                    # prompts of LM_PROMPTS' 512-2,048
VL_GRID = 16                       # one image block a prompt, grid (1, 16,
                                   # 16): 256 patches
VL_PARITY_PROMPTS = (320, 290, 266, 384)
TRAIN_ARCHS = ("whisper-base", "qwen2-vl-2b", "rwkv6-1.6b")
LM_TRAIN = dict(steps=30, batch=8, seq=128)   # the CLI's batch and seq
# phase 21: Mixtral 8x7B's MoE layers under expert parallelism (one card,
# every rank in one process through LocalComm)
EP_PARITY = (2, 2, 512)            # float32 gates: depth, B, T
EP_LAYERS = 4                      # the bf16 runs' depth: about 12 GB
EP_PREFILL = (2, 4096)             # B, T of the timed bf16 prefill
EP_DECODE = (4, 1024, 16)          # B, prompt T, timed eager decode steps
EP_MESHES = ((1, 1), (1, 8))       # (data, model)
EP_TOL = 1e-4                      # EP without drops vs dense, * max|logit|
EP_REPS = 3                        # timed prefills per run


def card_labels() -> list:
    """``nvidia-smi``'s name and power limit of every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()


def card_label() -> str:
    return card_labels()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def _ids(rng, n, e, hub=(), empty=()):
    """Sorted destination ids: ``e`` uniform over ``n`` rows, none in the
    rows ``empty``, plus ``deg`` more for each ``(row, deg)`` of ``hub``."""
    import numpy as np
    ids = rng.integers(0, n, e)
    ids = ids[~np.isin(ids, np.asarray(empty, dtype=np.int64))]
    return np.sort(np.concatenate(
        [ids] + [np.full(deg, row) for row, deg in hub])).astype(np.int32)


def _case(rng, n, e, h, d, *, mask=0.0, all_masked=0, e_pad=0, n_pad=0,
          hub=(), empty=(), masked_rows=()):
    """Inputs shaped as a served block: (plan, logits, values) on the card.
    ``mask`` masks that share of edges, ``all_masked`` every edge of the
    first rows and ``masked_rows`` every edge of those rows; ``hub`` adds
    hub rows and ``empty`` empties rows (:func:`_ids`); ``e_pad``/``n_pad``
    make a bucket with pad edges."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_bucket_csc_plan
    from repro_torch.kernels.ref import NEG
    ids = _ids(rng, n, e, hub, empty)
    e = len(ids)
    logits = (rng.normal(size=(max(e, e_pad), h)) * 3).astype(np.float32)
    values = rng.normal(size=(max(e, e_pad), h, d)).astype(np.float32)
    masked = ((rng.random(e) < mask) | (ids < all_masked)
              | np.isin(ids, np.asarray(masked_rows, dtype=np.int64)))
    logits[:e][masked] = NEG
    values[:e][masked] = 0.0
    plan = build_bucket_csc_plan(ids, max(n, n_pad), max(e, e_pad))
    dev = torch.device(DEVICE)
    return (plan.to(dev), torch.from_numpy(logits).to(dev),
            torch.from_numpy(values).to(dev))


def _cotangent(rng, shape, contiguous: bool):
    """A seeded cotangent on the card; ``contiguous=False`` lays the same
    values out transposed, as autograd may hand them over."""
    import torch
    n, h, d = shape
    g = torch.from_numpy(rng.normal(size=(h, n, d)).astype("float32"))
    g = g.to(DEVICE).transpose(0, 1)
    return g if not contiguous else g.contiguous()


def _check_backward(plan, lg, v, out, m, den, g, worst: dict, name: str):
    """Both backward kernels against their plain versions on one case;
    ``segment_sum_bwd`` exactly (a gather is a copy), under its rule's
    schedule and under each of its two schedules."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (edge_softmax_bwd_ref,
                                         segment_sum_bwd_ref)
    got = ops.segment_sum_bwd_op(g, plan)
    d_lg, d_v = ops.edge_softmax_bwd_op(g, lg, v, out, m, den, plan)
    gc = g.contiguous()
    want = segment_sum_bwd_ref(gc.flatten(1), plan.edge_dst)
    forced = [ops._segment_sum_bwd_cuda(gc.flatten(1), plan, s)
              for s in ops.SUM_BWD_SCHEDULES]
    w_lg, w_v = edge_softmax_bwd_ref(gc, lg, v, m, den, (out * gc).sum(-1),
                                     plan.edge_dst)
    torch.cuda.synchronize()
    for kname, pairs, tol in (
            ("segment_sum_bwd", [(x, want) for x in [got.flatten(1)]
                                 + forced], 0.0),
            ("edge_softmax_bwd", [(d_lg, w_lg), (d_v, w_v)], RTOL)):
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                       msg=f"{kname} on {name}")
            if a.numel():
                worst[kname] = max(worst[kname], float((a - b).abs().max()))


def _max_case(rng, n, e, d, *, mask=0.0, all_masked=0, relu=False, nan=0,
              e_pad=0, n_pad=0, hub=(), empty=(), masked_rows=(),
              nan_rows=()):
    """Inputs shaped as the max combine hands them to the kernel: (plan,
    data) on the card, masked edges at NEG. ``relu`` clamps at 0 (the
    ties of layer 1, which pools ReLU outputs), ``nan`` puts NaN in that
    many entries and ``nan_rows`` in one entry of each of those rows;
    ``hub``, ``empty`` and ``masked_rows`` as in :func:`_case`; pad edges
    carry garbage and read row N - 1."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_bucket_csc_plan
    from repro_torch.kernels.ref import NEG
    ids = _ids(rng, n, e, hub, empty)
    e = len(ids)
    data = rng.normal(size=(max(e, e_pad), d)).astype(np.float32)
    if relu:
        data = np.maximum(data, 0)
    masked = ((rng.random(e) < mask) | (ids < all_masked)
              | np.isin(ids, np.asarray(masked_rows, dtype=np.int64)))
    data[:e][masked] = NEG
    if nan and e:
        data[rng.choice(e, nan, replace=False),
             rng.integers(0, d, nan)] = np.nan
    for row in nan_rows:
        at = np.flatnonzero(ids == row)
        data[at[len(at) // 2], d // 2] = np.nan
    plan = build_bucket_csc_plan(ids, max(n, n_pad), max(e, e_pad))
    return plan.to(DEVICE), torch.from_numpy(data).to(DEVICE)


def _check_max_case(plan, data, rng, worst: dict, name: str) -> None:
    """The segment-max pair against its plain versions on one case."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_max_bwd_ref, segment_max_ref
    got = ops.segment_max_op(data, plan)
    want = segment_max_ref(data, plan.perm, plan.indptr, plan.num_segments)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                               msg=f"segment_max on {name}")
    for contiguous in (True, False):
        # the same values, transposed in memory when not contiguous
        g = torch.from_numpy(rng.normal(size=(
            data.shape[1], plan.num_segments)).astype("float32"))
        g = g.to(DEVICE).t()
        g = g.contiguous() if contiguous else g
        d_data = ops.segment_max_bwd_op(g, got, data, plan)
        w_data = segment_max_bwd_ref(g.contiguous(), want, data,
                                     plan.edge_dst)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            d_data, w_data, rtol=0, atol=0, equal_nan=True,
            msg=f"segment_max_bwd on {name}, contiguous={contiguous}")
    live = ~torch.isnan(want)
    if live.any():
        worst["segment_max"] = max(worst["segment_max"], float(
            (got - want)[live].abs().max()))
    if d_data.numel():
        worst["segment_max_bwd"] = max(worst["segment_max_bwd"], float(
            (d_data - w_data).nan_to_num().abs().max()))
    print(f"  max {name}: ok", flush=True)


def check_max_kernels(rng, worst: dict, alipay_plan) -> None:
    """The segment-max pair against its plain versions, exactly: a max
    picks one of its inputs and the backward multiplies by 1 or 0."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import build_csc_plan
    hub = ((1500, 5000),)          # 5,000 edges: 78 of the kernel's pieces
    cases = {
        # SAGE-max training buckets: layer 0 pools the 64 raw features,
        # layer 1 the 128 ReLU outputs (ties at 0); pad edges clip
        "sage_max_bucket_d64": dict(n=3500, e=90000, d=64, e_pad=131072,
                                    n_pad=4096),
        "sage_max_bucket_d128_relu": dict(n=3500, e=90000, d=128,
                                          relu=True, mask=0.1,
                                          e_pad=131072, n_pad=4096),
        "empty_rows": dict(n=5000, e=1000, d=64),
        "all_masked_rows": dict(n=500, e=4000, d=64, all_masked=100),
        "nan": dict(n=500, e=4000, d=64, nan=12),
        "no_edges": dict(n=300, e=0, d=64),
        "width_130": dict(n=700, e=5000, d=130, relu=True),
        # hub rows, cut into many pieces and merged
        "hub_d64": dict(n=3000, e=20000, d=64, hub=hub),
        "hub_all_masked": dict(n=3000, e=20000, d=64, hub=hub,
                               masked_rows=(1500,)),
        "hub_nan": dict(n=3000, e=20000, d=64, hub=hub, nan_rows=(1500,)),
        "hubs_first_last_d128_relu": dict(
            n=3000, e=3000, d=128, relu=True,
            hub=((0, 5000), (2999, 6000)), empty=(1, 2, 2997, 2998)),
        "hub_bucket_pad": dict(n=3000, e=20000, d=64,
                               hub=((2999, 5000),), e_pad=32768,
                               n_pad=4096),
        "hub_width_130": dict(n=700, e=5000, d=130, hub=((350, 5000),)),
    }
    for name, kw in cases.items():
        plan, data = _max_case(rng, **kw)
        _check_max_case(plan, data, rng, worst, name)
    # the GAT-E cells' own 20,000-node alipay_like plan, seeded messages
    data = torch.from_numpy(rng.normal(size=(
        alipay_plan.num_edges, MAX_WIDTH)).astype(np.float32)).to(DEVICE)
    _check_max_case(alipay_plan, data, rng, worst, "alipay_like_20k_d64")
    # no rows: every edge reads nothing, the gradient is zeros
    plan = build_csc_plan(np.zeros(64, np.int32), 0).to(DEVICE)
    g = torch.zeros((0, MAX_WIDTH), device=DEVICE)
    data = torch.randn((64, MAX_WIDTH), device=DEVICE)
    if (ops.segment_max_op(data, plan).shape != (0, MAX_WIDTH)
            or ops.segment_max_bwd_op(g, g, data, plan).any()):
        raise AssertionError("segment_max with no rows misbehaved")
    print("  max no_rows: ok", flush=True)


def _bf16_rel(got, want) -> float:
    """Largest |got - want| over the largest |want|, in float32."""
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def _bf16_check(got, want, what: str) -> float:
    """Hold a bf16 kernel output against its plain version element by
    element. Both read the same bf16 inputs, compute in float32 and round
    to bf16 once, so they may part by one bf16 ulp (under 2^-7 of |want|)
    where float32 sum-order noise crosses a rounding boundary, and by that
    noise near 0: ``|got - want| <= BF16_ATOL * rms(want) + BF16_RTOL *
    |want|``. Returns the worst element's share of its limit (<= 1)."""
    g, w = got.float(), want.float()
    if not w.numel():
        return 0.0
    atol = BF16_ATOL * float(w.square().mean().sqrt())
    share = float(((g - w).abs() / (atol + BF16_RTOL * w.abs())).max())
    if not share <= 1.0:
        raise AssertionError(f"{what}: bf16 kernel vs plain, the worst "
                             f"element at {share:.3f} of its limit (rtol "
                             f"{BF16_RTOL}, atol {BF16_ATOL} * rms)")
    return share


def check_lm_kernels(rng, worst: dict) -> None:
    """``flash_attention`` and ``wkv6`` against their plain versions on
    the card, in float32 (rtol/atol 1e-5 and 1e-4) and bfloat16 (element
    by element, :func:`_bf16_check`); ``worst`` keeps the float32 max abs
    error and the bf16 worst share of the limit."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, wkv6_ref
    # name -> (B, T, Hq, Hkv, D, causal, window, seq_len, kv_start)
    flash = {
        # the Qwen3-4B prefill of a served batch: GQA 4, D 128, left pad
        "qwen3_prefill": (4, 512, 32, 8, 128, True, 0, 0, (0, 37, 300, 448)),
        "causal_gqa1_d64": (2, 256, 4, 4, 64, True, 0, 0, None),
        "noncausal_d64": (2, 200, 4, 4, 64, False, 0, 0, None),
        "window_d128": (2, 300, 8, 2, 128, True, 48, 0, None),
        "seq_len_noncausal": (2, 256, 4, 1, 128, False, 0, 190, None),
        "seq_len_causal": (1, 256, 8, 2, 64, True, 0, 130, None),
        # row 0 sees no key at all, rows of 1 and 2 lose a prefix
        "kv_start_all_masked": (3, 150, 8, 2, 128, True, 0, 0, (150, 70, 5)),
        "ragged_t_gqa4": (2, 77, 8, 2, 64, True, 0, 0, (0, 10)),
        "window_kv_start": (2, 333, 4, 1, 64, True, 100, 0, (200, 3)),
        # lengths that cross the bf16 kernel's 128-row query and 64-key
        # tiles; D 32; a kv_start and a window edge inside a tile
        "t129": (1, 129, 8, 2, 128, True, 0, 0, None),
        "t255_noncausal": (2, 255, 4, 2, 64, False, 0, 0, None),
        "t4100_qwen_heads": (1, 4100, 32, 8, 128, True, 0, 0, None),
        "d32": (2, 200, 4, 2, 32, True, 0, 0, (0, 50)),
        "kv_start_mid_tile": (2, 300, 8, 2, 128, True, 0, 0, (70, 201)),
        "window_crosses_tile": (2, 400, 8, 2, 64, True, 100, 0, (0, 30)),
        # Mixtral's served prefill (phase 17): window 4,096 inside a
        # 4,608-token batch, GQA 4, D 128, a left pad
        "mixtral_prefill": (2, 4608, 32, 8, 128, True, 4096, 0, (0, 517)),
        # Jamba's served prefill (phase 18): GQA 8, D 128, the longest
        # batch of whole 128-token chunks, left pads
        "jamba_prefill": (4, 2048, 64, 8, 128, True, 0, 0, (0, 37, 300, 448)),
        # Whisper's encoder (phase 19): bidirectional over 1,500 frames,
        # no multiple of a tile, 8/8 heads of 64; its decoder's prefill,
        # causal behind left pads
        "whisper_encoder": (4, 1500, 8, 8, 64, False, 0, 0, None),
        "whisper_decoder_prefill": (4, 64, 8, 8, 64, True, 0, 0,
                                    (0, 24, 47, 59)),
        # Qwen2-VL's served prefill: 12 query heads over 2 KV heads, a
        # group of 6 (not a power of two), D 128, left pads
        "qwen2vl_prefill_g6": (4, 2048, 12, 2, 128, True, 0, 0,
                               (0, 37, 300, 448)),
    }
    for name, (B, T, Hq, Hkv, D, causal, window, seq_len, start) in \
            flash.items():
        q = torch.from_numpy(rng.normal(size=(B, T, Hq, D)).astype(
            "float32")).to(DEVICE)
        k = torch.from_numpy(rng.normal(size=(B, T, Hkv, D)).astype(
            "float32")).to(DEVICE)
        v = torch.from_numpy(rng.normal(size=(B, T, Hkv, D)).astype(
            "float32")).to(DEVICE)
        kv = (None if start is None else
              torch.tensor(start, dtype=torch.int32, device=DEVICE))
        kw = dict(causal=causal, sliding_window=window, seq_len=seq_len,
                  kv_start=kv)
        for dtype in (torch.float32, torch.bfloat16):
            a, b, c = q.to(dtype), k.to(dtype), v.to(dtype)
            got = ops.flash_attention_op(a, b, c, **kw)
            want = flash_attention_ref(a, b, c, **kw)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                           msg=f"flash_attention on {name}")
                worst["flash_attention"] = max(
                    worst["flash_attention"],
                    float((got - want).abs().max()))
            else:
                share = _bf16_check(got, want, f"flash_attention on {name}")
                worst["flash_attention_bf16"] = max(
                    worst.get("flash_attention_bf16", 0.0), share)
            if start is not None and start[0] >= T:
                if got[0].any():
                    raise AssertionError(f"flash_attention on {name}: a "
                                         "row with no visible key is not 0")
        print(f"  flash {name}: ok (bf16: the worst element at "
              f"{share:.3f} of its limit)", flush=True)
    # name -> (B, T, H, K): the RWKV-6 1.6B prefill of a served batch,
    # then ragged T, the reduced head width, one step, two tiles and one,
    # B*H of 4, and more (b, h) blocks than an H100 has SMs
    wkv = {"rwkv6_prefill": (4, 512, 32, 64), "ragged_t": (3, 77, 4, 64),
           "k32": (2, 45, 3, 32), "t1": (2, 1, 4, 64),
           "t33": (1, 33, 8, 64), "bh4": (1, 200, 4, 64),
           "bh4_k32": (2, 70, 2, 32), "bh160_ragged": (5, 77, 32, 64),
           "bh144_k32": (9, 40, 16, 32)}
    for name, (B, T, H, K) in wkv.items():
        r, kk, vv = (torch.from_numpy((rng.normal(size=(B, T, H, K)) * 0.5)
                                      .astype("float32")).to(DEVICE)
                     for _ in range(3))
        w = torch.from_numpy(np.exp(-np.exp(rng.normal(
            -2.0, 0.7, size=(B, T, H, K)))).astype("float32")).to(DEVICE)
        u = torch.from_numpy((rng.normal(size=(H, K)) * 0.1).astype(
            "float32")).to(DEVICE)
        # (input type, out_dtype): o in r's type, then float32 o from
        # bf16 inputs (the model's call)
        for dtype, out in ((torch.float32, None), (torch.bfloat16, None),
                           (torch.bfloat16, torch.float32)):
            a, b, c = r.to(dtype), kk.to(dtype), vv.to(dtype)
            o, S = ops.wkv6_op(a, b, c, w, u, out_dtype=out)
            w_o, w_S = wkv6_ref(a, b, c, w, u, out_dtype=out)
            torch.cuda.synchronize()
            if o.dtype != w_o.dtype:
                raise AssertionError(f"wkv6 on {name}: o in {o.dtype}")
            torch.testing.assert_close(S, w_S, rtol=WKV_TOL, atol=WKV_TOL,
                                       msg=f"wkv6 final state on {name}")
            if o.dtype == torch.float32:
                torch.testing.assert_close(o, w_o, rtol=WKV_TOL,
                                           atol=WKV_TOL,
                                           msg=f"wkv6 on {name}, {dtype} "
                                           "in, float32 out")
                worst["wkv6"] = max(worst["wkv6"],
                                    float((o - w_o).abs().max()),
                                    float((S - w_S).abs().max()))
            else:
                worst["wkv6_bf16"] = max(worst.get("wkv6_bf16", 0.0),
                                         _bf16_check(o, w_o,
                                                     f"wkv6 on {name}"))
        print(f"  wkv6 {name}: ok", flush=True)


def _sum_f64_err(got, flat, plan, what: str) -> float:
    """segment_sum's output against a float64 sum of the same rows: each
    element within rtol 1e-5 of its row's sum of |x| (the scale of a
    float32 sum's rounding error, which cancellation can leave far
    above the sum itself) plus atol 1e-6. Returns the max abs error."""
    from repro_torch.kernels.ref import segment_sum_ref
    n = plan.num_segments
    x = flat.double()
    want = segment_sum_ref(x, plan.perm, plan.indptr, n)
    scale = segment_sum_ref(x.abs(), plan.perm, plan.indptr, n)
    err = (got.double() - want).abs()
    bad = err > ATOL + RTOL * scale
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements past atol {ATOL} + rtol "
            f"{RTOL} * sum|x| of a float64 sum (max abs err "
            f"{float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def _check_case(plan, lg, v, rng, worst: dict, name: str,
                hub: bool = False) -> None:
    """segment_sum, edge_softmax and both backward kernels against their
    plain versions on one case. On hub rows (``hub``) segment_sum is held
    against a float64 sum instead (:func:`_sum_f64_err`): a float32 sum
    of thousands of edges in plan order and the plain version's atomic
    ``index_add_`` differ past the element gate where the row's values
    cancel, whichever is nearer the exact sum."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import edge_softmax_ref, segment_sum_ref
    flat = v.flatten(1)
    got = ops.segment_sum_op(flat, plan)
    want = segment_sum_ref(flat, plan.perm, plan.indptr, plan.num_segments)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    w_out, w_m, w_den = edge_softmax_ref(lg, v, plan.perm, plan.indptr,
                                         plan.num_segments)
    torch.cuda.synchronize()
    if hub:
        worst["segment_sum"] = max(worst["segment_sum"], _sum_f64_err(
            got, flat, plan, f"segment_sum on {name}"))
    for kname, pairs in (("segment_sum", [] if hub else [(got, want)]),
                         ("edge_softmax", [(out, w_out), (m, w_m),
                                           (den, w_den)])):
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                       msg=f"{kname} on {name}")
            if a.numel():
                worst[kname] = max(worst[kname], float((a - b).abs().max()))
    for contiguous in (True, False):
        g = _cotangent(rng, tuple(out.shape), contiguous)
        _check_backward(plan, lg, v, out, m, den, g, worst,
                        f"{name}, contiguous={contiguous}")
    print(f"  {name}: ok", flush=True)


OFFSET_DEGREES = (65, 412, 2832, 5000)
OFFSET_LEADS = (0, 1, 17, 63)
# filler rows of 0-8 edges put in front of the same rows to take a plan
# past edge_softmax's schedule switch (csrc/edge_softmax.cu's kLargePlan)
SWITCH_FILL = 110_000
# rows that must give the same bits in a plan under the switch and in
# plans past it: (edges, share of them masked)
SWITCH_ROWS = ((0, 0.0), (1, 0.0), (3, 0.0), (6, 0.3), (17, 0.0),
               (63, 0.0), (64, 0.0), (65, 0.0), (130, 0.3), (412, 1.0),
               (2832, 0.0), (5000, 0.2), (5000, 1.0))


def large_plan(name: str = "kLargePlan") -> int:
    """``kLargePlan`` of ``csrc/edge_softmax.cu``, the rows plus edges
    from which ``edge_softmax`` runs merge-path chunks (``kWideChunks``:
    from which its chunks are twice as long)."""
    import re
    text = (ROOT / "src/repro_torch/kernels/csrc/edge_softmax.cu").read_text()
    m = re.search(name + r"\s*=\s*int64_t\{(\d+)\}\s*<<\s*(\d+)", text)
    return int(m.group(1)) << int(m.group(2))


def _behind_fillers(fill: int, seed: int, lengths, logits, values):
    """``fill`` seeded filler rows of 0-8 edges, then rows of ``lengths``
    edges with the given data: (plan, logits, values, the rows' first
    row), on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_csc_plan
    front = np.random.default_rng(seed).integers(0, 9, fill)
    k = int(front.sum())
    sizes = np.concatenate([front, np.asarray(lengths, np.int64)])
    ids = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    plan = build_csc_plan(ids, len(sizes)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    lg = torch.cat([torch.randn((k,) + tuple(logits.shape[1:]),
                                generator=gen, device=DEVICE) * 3, logits])
    v = torch.cat([torch.randn((k,) + tuple(values.shape[1:]),
                               generator=gen, device=DEVICE), values])
    return plan, lg, v, fill


def _same_rows(want, got, what: str) -> None:
    import torch
    for name, x, y in zip(("out", "m", "den"), want, got):
        if not torch.equal(x, y):
            bad = int((x != y).flatten(1).any(1).sum())
            raise AssertionError(f"edge_softmax {name}: {bad} rows of {what} "
                                 "differ from the rows schedule's bits")


def check_offsets() -> None:
    """A row gives the same bits wherever it lies in a plan (ROADMAP
    C.14): rows of 65 to 5,000 edges behind a leading row of 0, 1, 17 or
    63 edges, through ``segment_sum`` at widths 32 and 4, ``edge_softmax``
    (4 heads of 8) and ``segment_max``; each launched twice, bitwise
    equal, and held against its plain version. ``edge_softmax`` also
    across its schedule switch: the same rows behind ``SWITCH_FILL``
    filler rows, in plans of 2^19 rows plus edges or more that it runs as
    merge-path chunks, and SWITCH_ROWS (short, long, masked, all-masked)
    in one plan under the switch and behind fillers past it, must give
    the rows schedule's bits."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import build_csc_plan
    from repro_torch.kernels.ref import (NEG, edge_softmax_ref,
                                         segment_max_ref)
    large = large_plan()
    for deg in OFFSET_DEGREES:
        rows = []
        for lead in OFFSET_LEADS:
            row, head = (np.random.default_rng(s) for s in (deg, 9 + lead))
            lg = np.concatenate([head.normal(size=(lead, 4)),
                                 row.normal(size=(deg, 4)) * 3])
            v = np.concatenate([head.normal(size=(lead, 4, 8)),
                                row.normal(size=(deg, 4, 8))])
            lg, v = (torch.from_numpy(a.astype(np.float32)).to(DEVICE)
                     for a in (lg, v))
            plan = build_csc_plan(np.repeat(np.int32([0, 1]), [lead, deg]),
                                  3).to(DEVICE)
            flat = v.flatten(1)

            def softmax_ok(out, what, lg=lg, v=v, plan=plan):
                for x, w in zip(out, edge_softmax_ref(
                        lg, v, plan.perm, plan.indptr, plan.num_segments)):
                    torch.testing.assert_close(x, w, rtol=RTOL, atol=ATOL,
                                               msg=what)

            def max_ok(out, what):
                torch.testing.assert_close(out[0], segment_max_ref(
                    flat, plan.perm, plan.indptr, 3), rtol=0, atol=0,
                    msg=what)
            # the same two rows (and the empty one) behind filler rows, in
            # a plan that edge_softmax runs as merge-path chunks
            big, big_lg, big_v, first = _behind_fillers(
                SWITCH_FILL, 9 + lead, [lead, deg, 0], lg, v)
            if big.num_segments + big.num_edges < large:
                raise AssertionError("the filler rows fall short of the "
                                     "schedule switch")
            # name -> (kernel call, check against the plain version, the
            # row's index)
            calls = {
                "segment_sum d32": (
                    lambda: (ops.segment_sum_op(flat, plan),),
                    lambda out, what: _sum_f64_err(out[0], flat, plan, what),
                    1),
                "segment_sum d4": (
                    lambda: (ops.segment_sum_op(lg, plan),),
                    lambda out, what: _sum_f64_err(out[0], lg, plan, what),
                    1),
                "edge_softmax": (lambda: ops.edge_softmax_fwd_op(lg, v, plan),
                                 softmax_ok, 1),
                "edge_softmax chunks": (
                    lambda: ops.edge_softmax_fwd_op(big_lg, big_v, big),
                    lambda out, what: softmax_ok(out, what, big_lg, big_v,
                                                 big), first + 1),
                "segment_max": (lambda: (ops.segment_max_op(flat, plan),),
                                max_ok, 1),
            }
            got = {}
            for name, (kern, check, r) in calls.items():
                a, b = kern(), kern()
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"{name}: two launches differ")
                check(a, f"{name}, {deg} edges behind {lead}")
                got[name] = [x[r].cpu() for x in a]
            del big, big_lg, big_v
            rows.append(got)
        for lead, got in zip(OFFSET_LEADS, rows):
            for name, outs in got.items():
                want = rows[0][name.replace(" chunks", "")]
                if not all(torch.equal(x, y) for x, y in zip(want, outs)):
                    raise AssertionError(
                        f"{name}: a row of {deg} edges behind {lead} edges "
                        "differs from the same row at offset 0")
        print(f"  offsets: a row of {deg} edges behind 0, 1, 17, 63 edges: "
              "bitwise equal (segment_sum d32/d4, edge_softmax, "
              f"segment_max); edge_softmax behind {SWITCH_FILL} filler rows "
              "too (merge-path chunks): bitwise the rows schedule's",
              flush=True)
    # SWITCH_ROWS under the switch and behind fillers past it, at offsets
    # that move the rows across chunk edges
    rng = np.random.default_rng(32)
    lengths = [k for k, _ in SWITCH_ROWS]
    lg = rng.normal(size=(sum(lengths), 4)).astype(np.float32) * 3
    v = rng.normal(size=(sum(lengths), 4, 8)).astype(np.float32)
    masked = np.concatenate([rng.random(k) < share for k, share in
                             SWITCH_ROWS])
    lg[masked], v[masked] = NEG, 0.0
    lg, v = (torch.from_numpy(a).to(DEVICE) for a in (lg, v))
    plan = build_csc_plan(np.repeat(np.arange(len(lengths), dtype=np.int32),
                                    lengths), len(lengths)).to(DEVICE)
    want = ops.edge_softmax_fwd_op(lg, v, plan)
    for x, w in zip(want, edge_softmax_ref(lg, v, plan.perm, plan.indptr,
                                           len(lengths))):
        torch.testing.assert_close(x, w, rtol=RTOL, atol=ATOL)
    plans = 0
    wide = large_plan("kWideChunks")
    for fill in (SWITCH_FILL, SWITCH_FILL + 1, SWITCH_FILL + 17,
                 SWITCH_FILL + 250, wide // 4):
        big, big_lg, big_v, first = _behind_fillers(fill, fill, lengths, lg,
                                                    v)
        if big.num_segments + big.num_edges < (wide if fill == wide // 4
                                               else large):
            raise AssertionError("the filler rows fall short of the switch")
        got = ops.edge_softmax_fwd_op(big_lg, big_v, big)
        again = ops.edge_softmax_fwd_op(big_lg, big_v, big)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("edge_softmax chunks: two launches differ")
        _same_rows(want, [x[first:] for x in got],
                   f"SWITCH_ROWS behind {fill} filler rows")
        plans += 1
        del big, big_lg, big_v, got, again
    print(f"  schedule switch: {len(lengths)} rows of 0 to 5,000 edges "
          f"(masked, all-masked among them) under the switch and behind "
          f"{plans} counts of filler rows past it (>= {large} rows plus "
          f"edges; the last past {wide}, chunks twice as long): out, m, den "
          "bitwise equal", flush=True)


def check_kernels() -> dict:
    """Max abs error of each kernel against its plain version over every
    case; raises past rtol/atol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import build_csc_plan
    rng = np.random.default_rng(0)
    chunk_hubs = ((0, 5000), (100_000, 6000), (199_999, 5000))
    chunk_empty = (1, 2, 199_997, 199_998)
    sum_hubs = ((0, 65), (1500, 412), (2000, 2832), (2999, 5000))
    cases = {
        # the serving path's buckets: GAT-E's 4 heads of 8 in its
        # (4096, 16384) bucket and GCN's 128 in its (4096, 131072) one,
        # with pad edges and masked edges
        "gat_e_bucket": dict(n=3000, e=12000, h=4, d=8, mask=0.2,
                             e_pad=16384, n_pad=4096),
        "gat_e_bucket_large": dict(n=12000, e=60000, h=4, d=8, mask=0.2,
                                   e_pad=65536, n_pad=16384),
        "gcn_bucket": dict(n=3000, e=70000, h=1, d=128, mask=0.2,
                           e_pad=131072, n_pad=4096),
        "empty_rows": dict(n=5000, e=1000, h=4, d=8),
        "all_masked_rows": dict(n=500, e=4000, h=4, d=8, all_masked=100),
        "no_edges": dict(n=300, e=0, h=4, d=8),
        "width_130": dict(n=700, e=5000, h=1, d=130),
        "heads_4x16": dict(n=700, e=5000, h=4, d=16),
        # the training path's: a GCN mini-batch bucket and a GAT-E cluster
        # bucket; pad edges carry garbage logits and read row N - 1
        "gcn_train_bucket": dict(n=3500, e=90000, h=1, d=128, e_pad=131072,
                                 n_pad=4096),
        "gat_e_train_bucket": dict(n=6000, e=30000, h=4, d=8, e_pad=32768,
                                   n_pad=8192),
        # hub rows (5,000 edges: 78 of the kernels' 64-edge pieces at
        # these sizes), cut into pieces and merged: masked edges, an
        # all-masked hub, hubs at the first and last rows beside empty
        # rows, pad edges behind a hub, 4 heads of 16 (two passes of the
        # warp)
        "hub": dict(n=3000, e=12000, h=4, d=8, mask=0.2,
                    hub=((1500, 5000),)),
        "hub_all_masked": dict(n=2000, e=8000, h=4, d=8,
                               hub=((700, 5000),), masked_rows=(700,)),
        "hubs_first_last": dict(n=3000, e=3000, h=4, d=8,
                                hub=((0, 5000), (2999, 6000)),
                                empty=(1, 2, 2997, 2998)),
        "hub_bucket_pad": dict(n=3000, e=10000, h=4, d=8,
                               hub=((2999, 5000),), e_pad=32768,
                               n_pad=4096),
        "hub_heads_4x16": dict(n=700, e=5000, h=4, d=16,
                               hub=((350, 5000),)),
        # segment_sum at the widths that give its warps 32, 16, 8, 4, 2
        # and 1 sub-warps (4 and 32: the GAT-E gathers' backward), over
        # hub rows of 65 to 5,000 edges, empty rows and pad edges
        **{f"sum_hubs_d{d}": dict(n=3000, e=9000, h=1, d=d, mask=0.1,
                                  hub=sum_hubs, empty=(1, 2, 2997),
                                  e_pad=32768, n_pad=4096)
           for d in (4, 8, 32, 64, 128, 130)},
        # plans of 2^19 rows plus edges or more, which edge_softmax.cu
        # runs as merge-path chunks of 256 items: hubs at the first and
        # last rows beside empty rows, an all-masked hub cut by a few
        # dozen chunk edges, masked edges (a fifth of the short rows all
        # masked), and the same behind pad edges in a bucket
        "chunks_hubs": dict(n=200_000, e=900_000, h=4, d=8, mask=0.2,
                            hub=chunk_hubs, empty=chunk_empty,
                            masked_rows=(100_000,)),
        "chunks_hubs_bucket_pad": dict(n=200_000, e=900_000, h=4, d=8,
                                       mask=0.2, hub=chunk_hubs,
                                       empty=chunk_empty,
                                       masked_rows=(100_000,),
                                       e_pad=1_048_576, n_pad=262_144),
    }
    worst = {k: 0.0 for k in KERNELS}
    for name, kw in cases.items():
        plan, lg, v = _case(rng, **kw)
        _check_case(plan, lg, v, rng, worst, name, hub="hub" in kw)
    # the GAT-E cells' own layer 0: the 20,000-node alipay_like plan
    # (a power-law plan: rows of up to 412 edges, so segment_sum is held
    # as on the hub cases)
    _, block, lg, v = _layer0_inputs("gnn_gat_e_alipay")
    _check_case(block.csc_plan, lg, v, rng, worst, "alipay_like_20k_layer0",
                hub=True)
    # no rows: every edge reads nothing, the gradients are zeros
    plan = build_csc_plan(np.zeros(64, np.int32), 0).to(DEVICE)
    g = torch.zeros((0, 4, 8), device=DEVICE)
    d_lg, d_v = ops.edge_softmax_bwd_op(
        g, torch.zeros((64, 4), device=DEVICE),
        torch.zeros((64, 4, 8), device=DEVICE), g,
        torch.zeros((0, 4), device=DEVICE), torch.zeros((0, 4),
                                                        device=DEVICE), plan)
    if ops.segment_sum_bwd_op(g, plan).any() or d_lg.any() or d_v.any():
        raise AssertionError("backward with no rows gave non-zero gradients")
    print("  no_rows: ok", flush=True)
    check_offsets()
    check_max_kernels(rng, worst, block.csc_plan)
    check_lm_kernels(rng, worst)

    def tol(k: str) -> str:
        if k.startswith("segment_max"):
            return "exact"
        if k == "segment_sum_bwd":
            return "exact, both schedules"
        if k in ("flash_attention", "wkv6"):
            t = RTOL if k == "flash_attention" else WKV_TOL
            return (f"f32 rtol/atol {t}; bf16 worst element "
                    f"{worst[k + '_bf16']:.3f} of its limit, rtol "
                    f"{BF16_RTOL} atol {BF16_ATOL}*rms")
        return f"rtol {RTOL}, atol {ATOL}"
    print("kernels: " + ", ".join(
        f"{k} max_abs_err={worst[k]:.3e} ({tol(k)}) pass" for k in KERNELS),
        flush=True)
    return worst


# -- phases 4 and 5: serving --------------------------------------------------


def _config(config: str, model=None):
    """``(CONFIG, DATASET)`` of the config module, its model swapped for
    ``model`` when given (widths and dataset kept)."""
    import dataclasses
    from repro_torch.config import get_gnn_config
    cfg, dataset = get_gnn_config(config)
    return (dataclasses.replace(cfg, model=model) if model else cfg), dataset


def serve(config: str, label: str, requests: int = 512,
          model_name=None) -> dict:
    """Serve a seeded trace on the card through the entry point's
    functions for the config module ``config`` (its model swapped for
    ``model_name`` when given), hold it against the CPU, and return the
    launch counts of the served run."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import (build_server, config_for,
                                              print_report, request_trace,
                                              resolve_graph, run_clients)
    cfg, dataset = _config(config, model_name)
    model, hidden, layers = cfg.model, cfg.hidden_dim, cfg.num_layers
    t0 = time.perf_counter()
    g = resolve_graph(dataset, model, seed=0)
    if config_for(g, model, layers, hidden) != cfg:
        raise AssertionError(f"{config}: the served model is not CONFIG")
    print(f"  graph {dataset}: {g.num_nodes} nodes, {g.num_edges} edges "
          f"(built in {time.perf_counter() - t0:.2f}s on the host)")
    trace = request_trace(g, requests, seed=0)
    kw = dict(max_batch=16, max_wait_ms=2.0)
    srv = build_server(g, model, layers, hidden, seed=0, device=DEVICE,
                       **kw)

    ops.reset_launches()
    srv.start()
    try:
        out, wall = run_clients(srv, trace, 4)
    finally:
        srv.stop()
    launches = dict(ops.launches)
    print_report(srv, wall, requests, label=f"{label}, {model}")
    print(f"  launches on the served path: {launches}")

    # the same port on the CPU, plain versions, every response
    cpu = build_server(g, model, layers, hidden, seed=0, device="cpu",
                       cache=False, **kw)
    uniq = np.unique(trace)
    ref = np.concatenate([cpu.submit(uniq[i:i + 16])
                          for i in range(0, len(uniq), 16)])
    want = ref[np.searchsorted(uniq, trace)]
    err = float(np.abs(out - want).max())
    if not np.isfinite(out).all() or out.shape != want.shape:
        raise AssertionError(f"{model}: bad responses {out.shape}")
    np.testing.assert_allclose(out, want, rtol=SERVE_TOL, atol=SERVE_TOL,
                               err_msg=f"{model}: card vs CPU")
    print(f"  card vs CPU over {requests} responses: max_abs_err={err:.3e} "
          f"(tolerance {SERVE_TOL}) pass")

    # a cache hit against a full recompute, on the card: 16 seeded
    # targets and the graph's highest in-degree node, whose row the
    # kernels cut into pieces when it has more than 64 in-edges
    rng = np.random.default_rng(1)
    indeg = np.bincount(g.dst, minlength=g.num_nodes)
    hub = int(indeg.argmax())
    targets = np.union1d(rng.choice(g.num_nodes, 16, replace=False), [hub])
    cached = build_server(g, model, layers, hidden, seed=0, device=DEVICE,
                          **kw)
    full = cached.submit(targets)
    hits0 = cached.cache.hits
    if not cached.cache.coverage(np.array([hub]))[0]:
        raise AssertionError(f"{model}: the hub {hub} is not a cache hit")
    again = cached.submit(targets)
    if cached.cache.hits == hits0:
        raise AssertionError(f"{model}: the second submit hit no cache row")
    same = bool(np.array_equal(again, full))
    print(f"  cache hit vs full recompute ({len(targets)} targets, the hub "
          f"{hub} with {int(indeg[hub])} in-edges among them): "
          f"{cached.cache.hits - hits0} hits, max_abs_err="
          f"{float(np.abs(again - full).max()):.3e}, bitwise={same}")
    if not same:
        raise AssertionError(f"{model}: a cache hit is not bitwise equal "
                             "to a full recompute")
    return launches


# -- phase 26: the cache contract past the schedule switch ---------------------

CACHE_NODES = 200_000              # alipay_like nodes: its default ladder
                                   # runs from (32768, 262144) to (262144,
                                   # 2097152), only the first under 2^19
# targets a case (and the graph's highest in-degree node): at 4,096 the
# full recompute's 2-hop view lands past edge_softmax's schedule switch and
# the hit's 1-hop view under it; at 16,384 both land past it
CACHE_TARGETS = ((4096, False), (16_384, True))
CACHE_LIMIT_S = 30.0               # the phase, its graph's generation aside


def cache_phase(label: str) -> dict:
    """Phase 26: GAT-E served at the config's widths (seed-0 weights) on
    alipay_like at ``CACHE_NODES`` nodes with the default ladder; for
    each of ``CACHE_TARGETS``, seeded targets and the hub are served
    once (every target a miss: the 2-hop view, whose top-layer rows the
    cache keeps), again (every target a hit: the top layer over the 1-hop
    view) and by a ``cache=False`` server. Each view's bucket and
    ``edge_softmax`` schedule are printed and must fall on the stated
    sides of ``kLargePlan``; the hit must equal the recompute and the
    server without a cache bit for bit. Returns the launches."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import build_server
    cfg, dataset = _config("gnn_gat_e_alipay")
    model, hidden, layers = cfg.model, cfg.hidden_dim, cfg.num_layers
    t0 = time.perf_counter()
    g = _graph(dataset, model, num_nodes=CACHE_NODES)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    large = large_plan()
    indeg = np.bincount(g.dst, minlength=g.num_nodes)
    hub = int(indeg.argmax())
    kw = dict(max_batch=16, max_wait_ms=2.0)
    ops.reset_launches()

    def schedule(bucket) -> str:
        return "chunks" if sum(bucket) >= large else "rows"
    failed = []
    for count, hit_past in CACHE_TARGETS:
        rng = np.random.default_rng(count)
        targets = np.union1d(rng.choice(g.num_nodes, count, replace=False),
                             [hub])
        cached = build_server(g, model, layers, hidden, seed=0,
                              device=DEVICE, **kw)
        full = cached.submit(targets)
        hits0 = cached.cache.hits
        again = cached.submit(targets)
        hits = cached.cache.hits - hits0
        plain = build_server(g, model, layers, hidden, seed=0, device=DEVICE,
                             cache=False, **kw).submit(targets)
        (miss_bucket,) = cached._full_step.calls
        (hit_bucket,) = cached._hit_step.calls
        if hits != len(targets):
            raise AssertionError(f"{count} targets: {hits} cache hits")
        if sum(miss_bucket) < large or (sum(hit_bucket) >= large) != hit_past:
            raise AssertionError(
                f"{count} targets: buckets {miss_bucket} and {hit_bucket} "
                f"against the switch at {large} rows plus edges")
        same = [bool(np.array_equal(again, full)),
                bool(np.array_equal(again, plain))]
        print(f"  {len(targets)} targets (the hub {hub}, {int(indeg[hub])} "
              f"in-edges, among them): recompute's 2-hop view in bucket "
              f"{miss_bucket} ({schedule(miss_bucket)}), the hit's 1-hop "
              f"view in {hit_bucket} ({schedule(hit_bucket)}); {hits} hits; "
              f"hit vs recompute max_abs_err "
              f"{float(np.abs(again - full).max()):.3e} bitwise={same[0]}, "
              f"vs cache=False {float(np.abs(again - plain).max()):.3e} "
              f"bitwise={same[1]}", flush=True)
        if not all(same) or not np.isfinite(again).all():
            failed.append(count)
        del cached
    if failed:
        raise AssertionError(f"{failed} targets: a cache hit is not bitwise "
                             "the recompute")
    launches = dict(ops.launches)
    took = time.perf_counter() - t0
    print(f"  launches {({k: v for k, v in launches.items() if v})}",
          flush=True)
    print(f"  phase 26: {took:.1f}s ({dataset} at {g.num_nodes} nodes, "
          f"{g.num_edges} edges: {t_gen:.1f}s to get; {label})", flush=True)
    if took > CACHE_LIMIT_S:
        raise AssertionError(f"phase 26 took {took:.1f}s, over "
                             f"{CACHE_LIMIT_S}s")
    return {k: launches[k] for k in KERNELS}


# -- phase 6: kernel times ----------------------------------------------------


def _time_ms(fn, min_total_ms: float = 200.0) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    n = max(5, min(200, int(min_total_ms / max(start.elapsed_time(stop),
                                               1e-3))))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _bound(nbytes: float, nops: float,
           ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_SIZED_GRAPHS: dict = {}


def _graph(dataset: str, model: str, **graph_kw):
    """The named graph as ``model`` sees it (GCN adds self-loops). One
    sized with ``graph_kw`` (``num_nodes``) is made once a run and kept:
    phases 6 and 25 both read the 1,000,000-node alipay_like graph, whose
    generation on the host takes tens of seconds."""
    from repro_torch.launch.serve_gnn import resolve_graph
    if not graph_kw:
        return resolve_graph(dataset, model, seed=0)
    key = (dataset, model, tuple(sorted(graph_kw.items())))
    if key not in _SIZED_GRAPHS:
        _SIZED_GRAPHS[key] = resolve_graph(dataset, model, seed=0,
                                           **graph_kw)
    return _SIZED_GRAPHS[key]


def _layer0_inputs(config: str, **graph_kw):
    """The Sum-stage operands of layer 0 of a full-graph forward on the
    card for the config module ``config``: (graph, block, masked logits
    or None, masked values)."""
    import torch
    from repro_torch.config import get_gnn_config
    from repro_torch.core.tgar import tree_take
    from repro_torch.graph import build_block
    from repro_torch.kernels.ref import NEG
    from repro_torch.launch.serve_gnn import make_model
    cfg, dataset = get_gnn_config(config)
    model = cfg.model
    t0 = time.perf_counter()
    g = _graph(dataset, model, **graph_kw)
    t_gen = time.perf_counter() - t0
    layer = make_model(g, model, cfg.num_layers, cfg.hidden_dim,
                       seed=0).layers[0].to(DEVICE)
    block = build_block(g, gcn_norm=model == "gcn", csc_plan=True).to(
        DEVICE)
    with torch.inference_mode():
        n = layer.transform(block.x)
        msg = layer.gather(tree_take(n, block.src), tree_take(n, block.dst),
                           block.edge_attr, block.edge_weight,
                           block.edge_mask)
        mask = block.edge_mask
        value = (msg["value"] * mask[:, None, None]).contiguous()
        logit = (torch.where(mask[:, None] > 0, msg["logit"],
                             torch.full_like(msg["logit"], NEG))
                 if "logit" in msg else None)
    print(f"  {dataset}: {g.num_nodes} nodes, {g.num_edges} edges "
          f"(generated in {t_gen:.1f}s on the host)")
    return g, block, logit, value


def _device_ms(fn, calls: int = 20, tries: int = 3):
    """Device milliseconds per call of ``fn`` from a ``torch.profiler``
    trace: every CUDA kernel it launches, summed, so the host's time
    between launches (which sets CUDA-event times at a cell's small
    shapes) is left out. A trace that holds no CUDA kernel, or a kernel
    whose count of launches is not a multiple of ``calls`` (a trace that
    dropped events), is taken again, up to ``tries`` traces; then None:
    a profile that saw nothing is not a kernel that took no time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events and not any(e.count % calls for e in events):
            return sum(e.self_device_time_total
                       for e in events) / 1e3 / calls
        print(f"  (a trace of {calls} calls recorded "
              f"{[(e.key, e.count) for e in events]})", flush=True)
    print("  (no whole trace: device_ms null)", flush=True)
    return None


def _softmax_row(plan, logit, value) -> dict:
    """``edge_softmax`` on one plan: held against its plain version, then
    timed beside it (CUDA events; profiled device ms) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import edge_softmax_ref
    _, H, D = value.shape
    N = plan.num_segments
    E = int(plan.indptr[-1])       # real edges: a bucket's pads join no row
    for a, b in zip(ops.edge_softmax_fwd_op(logit, value, plan),
                    edge_softmax_ref(logit, value, plan.perm, plan.indptr,
                                     N)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    kern = (lambda: ops.edge_softmax_fwd_op(logit, value, plan))
    ms = _time_ms(kern)
    plain = _time_ms(lambda: edge_softmax_ref(
        logit, value, plan.perm, plan.indptr, N), 100.0)
    nbytes = 4 * (E * H + E * H * D + E + (N + 1) + N * H * D + 2 * N * H)
    bound, by = _bound(nbytes, 8 * E * H * D)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"E={E} N={N} H={H} D={D}")


# alipay_like power-law plans on either side of edge_softmax's schedule
# switch: 0.35, 0.7 and 1.4 million rows plus edges
SWITCH_NODES = (50_000, 100_000, 200_000)


def softmax_times(label: str) -> None:
    """``edge_softmax`` (B.3) alone, at the plans phase 6 times it on: the
    1,000,000-node alipay_like layer 0, a hub-free plan of its N and E,
    and the SWITCH_NODES plans; each held against its plain version and
    timed (one JSON ``plan row`` each, its schedule in its name)."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_csc_plan
    large = large_plan()
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def row(name: str, plan, logit, value) -> None:
        kind = ("chunks" if plan.num_segments + plan.num_edges >= large
                else "rows")
        _plan_row("edge_softmax", f"{name}, {kind}",
                  {**_softmax_row(plan, logit, value), "card": label})
    with torch.inference_mode():
        _, block, logit, value = _layer0_inputs("gnn_gat_e_alipay",
                                                num_nodes=KERNEL_NODES)
        plan = block.csc_plan
        E, H, D = value.shape
        N = plan.num_segments
        row(f"alipay_like, {N} nodes (power law)", plan, logit, value)
        del block, plan, logit, value
        ids = np.sort(np.random.default_rng(0).integers(0, N, E))
        plan = build_csc_plan(ids.astype(np.int32), N).to(DEVICE)
        row(f"uniform, {N} nodes (hub-free)", plan, torch.randn(
            (E, H), generator=gen, device=DEVICE) * 3, torch.randn(
            (E, H, D), generator=gen, device=DEVICE))
        del plan
        switch_rows(H, D, gen, row)


def switch_rows(H: int, D: int, gen, row) -> None:
    """``row(name, plan, logit, value)`` for ``edge_softmax`` on the
    SWITCH_NODES alipay_like plans, either side of its schedule switch
    (kLargePlan): 0.35, 0.7 and 1.4 million items, between the cells' 20k
    plan (0.14 million) and the 1M one (7 million)."""
    import torch
    for nodes in SWITCH_NODES:
        plan = _dest_plan("alipay_like", "gat_e", num_nodes=nodes)
        e = plan.num_edges
        row(f"alipay_like, {nodes} nodes (power law)", plan, torch.randn(
            (e, H), generator=gen, device=DEVICE) * 3, torch.randn(
            (e, H, D), generator=gen, device=DEVICE))


def _max_row(plan, data) -> dict:
    """``segment_max`` on one plan: held against its plain version
    exactly, then timed beside it, ``scatter_reduce_`` over the
    destinations and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import NEG, segment_max_ref
    (E_all, D), N = data.shape, plan.num_segments
    E = int(plan.indptr[-1])       # real edges: a bucket's pads join no row
    torch.testing.assert_close(
        ops.segment_max_op(data, plan),
        segment_max_ref(data, plan.perm, plan.indptr, N), rtol=0, atol=0)
    kern = (lambda: ops.segment_max_op(data, plan))
    ms = _time_ms(kern)
    plain = _time_ms(lambda: segment_max_ref(data, plan.perm, plan.indptr,
                                             N), 100.0)
    # pad edges (destination N) land in one spare row
    idx = plan.edge_dst.long()[:, None].expand(E_all, D)
    rows = N + (E_all > E)
    lib = _time_ms(lambda: torch.full((rows, D), NEG, device=DEVICE)
                   .scatter_reduce_(0, idx, data, "amax", include_self=True),
                   100.0)
    bound, by = _bound(4 * (E * D + N * D) + 4 * (E + N + 1), E * D)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                shape=f"E={E} N={N} D={D}")


def _bwd_row(plan, logit, value, gen) -> dict:
    """``edge_softmax_bwd`` on one plan, after the forward: held against
    its plain version, then timed beside it (CUDA events; profiled device
    ms) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import edge_softmax_bwd_ref
    E, H, D = value.shape
    N = plan.num_segments
    out, m, den = ops.edge_softmax_fwd_op(logit, value, plan)
    cot = torch.randn((N, H, D), generator=gen, device=DEVICE)
    bwd = (lambda: ops.edge_softmax_bwd_op(cot, logit, value, out, m, den,
                                           plan))
    bwd_plain = (lambda: edge_softmax_bwd_ref(
        cot, logit, value, m, den, (out * cot).sum(-1), plan.edge_dst))
    for a, b in zip(bwd(), bwd_plain()):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    ms = _time_ms(bwd)
    plain = _time_ms(bwd_plain, 100.0)
    # reads g, out, logits, values, m, den, perm and indptr; writes
    # d_logits and d_values
    nbytes = 4 * (2 * N * H * D + 2 * E * H + 2 * E * H * D + 2 * N * H
                  + E + N + 1)
    bound, by = _bound(nbytes, 3 * E * H * D + 5 * E * H + 2 * N * H * D)
    return dict(ms=ms, device_ms=_device_ms(bwd), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"E={E} N={N} H={H} D={D}")


def _sum_row(plan, idx, width: int, gen) -> dict:
    """``segment_sum`` over ``plan`` (the plan over ``idx``) on seeded
    (E, width) data: held against a float64 sum, then timed beside its
    plain version, ``index_add_`` over ``idx`` (atomic: what torch's own
    backward of the gather runs) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_ref
    E, N = plan.num_edges, plan.num_segments
    data = torch.randn((E, width), generator=gen, device=DEVICE)
    _sum_f64_err(ops.segment_sum_op(data, plan), data, plan,
                 f"segment_sum at width {width}")
    kern = (lambda: ops.segment_sum_op(data, plan))
    ms = _time_ms(kern)
    plain = _time_ms(lambda: segment_sum_ref(data, plan.perm, plan.indptr,
                                             N), 100.0)
    idx = idx.long()
    lib = _time_ms(lambda: torch.zeros(N, width, device=DEVICE).index_add_(
        0, idx, data), 100.0)
    bound, by = _bound(4 * (E * width + N * width + E + N + 1), E * width)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                shape=f"E={E} N={N} D={width}")


def gat_e_cell_rows(gen) -> None:
    """The GAT-E cells' own layer-0 plans (20,000-node alipay_like): the
    gathers' backward (``segment_sum``) over the source and the
    destination plans at widths 32 and 4, and ``edge_softmax_bwd``."""
    _, block, logit, value = _layer0_inputs("gnn_gat_e_alipay")
    label = "alipay_like, 20000 nodes (GAT-E cells)"
    _plan_row("edge_softmax_bwd", label, _bwd_row(block.csc_plan, logit,
                                                  value, gen))
    for name, plan, idx in (("source", block.src_plan, block.src),
                            ("destination", block.csc_plan, block.dst)):
        for width in (32, 4):
            _plan_row("segment_sum", f"{label}, {name} plan, width {width}",
                      _sum_row(plan, idx, width, gen))


def _plan_row(kernel: str, plan: str, row: dict) -> None:
    print("  plan row " + json.dumps({"kernel": kernel, "plan": plan,
                                      **row}), flush=True)


def _max_times(plan, gen) -> dict:
    """The segment-max pair at the 1,000,000-node ``alipay_like`` plan,
    on seeded (E, 64) messages: each held against its plain version, then
    timed beside it, its bound and, for the forward, ``scatter_reduce_``
    over the destinations (the backward has no single PyTorch call)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_max_bwd_ref
    E, N, D = plan.num_edges, plan.num_segments, MAX_WIDTH
    data = torch.randn((E, D), generator=gen, device=DEVICE)
    rows = {"segment_max": _max_row(plan, data)}
    _plan_row("segment_max", f"alipay_like, {N} nodes (power law)",
              rows["segment_max"])
    fwd = ops.segment_max_op(data, plan)
    cot = torch.randn((N, D), generator=gen, device=DEVICE)
    torch.testing.assert_close(
        ops.segment_max_bwd_op(cot, fwd, data, plan),
        segment_max_bwd_ref(cot, fwd, data, plan.edge_dst), rtol=0, atol=0)
    ms = _time_ms(lambda: ops.segment_max_bwd_op(cot, fwd, data, plan))
    plain = _time_ms(lambda: segment_max_bwd_ref(cot, fwd, data,
                                                 plan.edge_dst), 100.0)
    # reads g, fwd, data and edge_dst; writes d_data
    bound, by = _bound(4 * (2 * E * D + 2 * N * D) + 4 * E, 2 * E * D)
    rows["segment_max_bwd"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=None,
                                   shape=f"E={E} N={N} D={D}")
    return rows


def _dest_plan(dataset: str, model: str, **graph_kw):
    """The destination plan of a full-graph block of ``dataset`` (as
    ``model`` sees it: GCN adds self-loops), on the card."""
    from repro_torch.graph import build_block
    g = _graph(dataset, model, **graph_kw)
    return build_block(g, csc_plan=True).csc_plan.to(DEVICE)


def plan_rows(E: int, N: int, H: int, D: int, gen) -> None:
    """``edge_softmax`` and ``segment_max`` on more plans, one JSON row
    each: a hub-free plan with the 1,000,000-node plan's N and E (uniform
    destinations: what the kernels take when no row is a hub), the
    cells' own layer-0 plans (GAT-E's 20,000-node alipay_like; SAGE-max's
    reddit_like at width 64), ``edge_softmax`` on power-law plans on
    either side of its schedule switch, and a bucket of each (short
    rows)."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_bucket_csc_plan, build_csc_plan
    ids = np.sort(np.random.default_rng(0).integers(0, N, E))
    plan = build_csc_plan(ids.astype(np.int32), N).to(DEVICE)
    del ids
    logit = torch.randn((E, H), generator=gen, device=DEVICE) * 3
    value = torch.randn((E, H, D), generator=gen, device=DEVICE)
    _plan_row("edge_softmax", f"uniform, {N} nodes (hub-free)",
              _softmax_row(plan, logit, value))
    del logit, value
    data = torch.randn((E, MAX_WIDTH), generator=gen, device=DEVICE)
    _plan_row("segment_max", f"uniform, {N} nodes (hub-free)",
              _max_row(plan, data))
    del data, plan
    torch.cuda.empty_cache()
    _, block, logit, value = _layer0_inputs("gnn_gat_e_alipay")
    _plan_row("edge_softmax", "alipay_like, 20000 nodes (GAT-E cells)",
              _softmax_row(block.csc_plan, logit, value))
    plan = _dest_plan("reddit_like", "sage_max")
    data = torch.randn((plan.num_edges, MAX_WIDTH), generator=gen,
                       device=DEVICE)
    _plan_row("segment_max", "reddit_like (SAGE-max cells)",
              _max_row(plan, data))
    switch_rows(H, D, gen, lambda name, *a: _plan_row(
        "edge_softmax", name, _softmax_row(*a)))
    # bucket-padded views with short uniform rows, the kind the serving
    # and mini-batch paths stage: a GAT-E serving bucket and a SAGE-max
    # training bucket
    rng = np.random.default_rng(1)
    for kernel, n, e, n_pad, e_pad in (("edge_softmax", 3000, 12000, 4096,
                                        16384),
                                       ("segment_max", 3500, 90000, 4096,
                                        131072)):
        plan = build_bucket_csc_plan(
            np.sort(rng.integers(0, n, e)).astype(np.int32), n_pad,
            e_pad).to(DEVICE)
        label = f"bucket ({n_pad}, {e_pad}), {e} uniform edges"
        if kernel == "edge_softmax":
            row = _softmax_row(plan, torch.randn(
                (e_pad, H), generator=gen, device=DEVICE) * 3, torch.randn(
                (e_pad, H, D), generator=gen, device=DEVICE))
        else:
            row = _max_row(plan, torch.randn((e_pad, MAX_WIDTH),
                                             generator=gen, device=DEVICE))
        _plan_row(kernel, label, row)


# GCN's hidden width, the only width the system sends this kernel (its
# Sum stage's backward; the gathers' backward is segment_sum), and two
# narrower ones on either side of the schedules' crossover
SUM_BWD_WIDTHS = (128, 32, 4)
SUM_BWD_SWEEP = (4, 8, 16, 32, 64, 128)   # widths timed under both schedules


def _sum_bwd_rule(width: int):
    """The schedule ``segment_sum_bwd``'s rule takes for rows of
    ``width`` floats; None in an older tree whose kernel has one schedule
    (timed beside this one, as the README's recipe for parent and change
    in one call does)."""
    from repro_torch.kernels import ops
    rule = getattr(ops, "sum_bwd_schedule", None)
    return rule(width) if rule else None


def _sum_bwd_bytes(E: int, N: int, width: int) -> int:
    """What ``segment_sum_bwd`` must move whichever schedule runs: g and
    one E-long index read, d_data written."""
    return 4 * (N * width + E * width + E)


def _sum_bwd_row(plan, width: int, gen) -> dict:
    """``segment_sum_bwd`` on a destination plan on a seeded (N, width)
    cotangent, under its rule's schedule: held exactly against its plain
    version, then timed (CUDA events; profiled device ms) beside it,
    ``index_select`` over the clipped destinations (one PyTorch call for
    the same function) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_bwd_ref
    E, N = plan.num_edges, plan.num_segments
    cot = torch.randn((N, width), generator=gen, device=DEVICE)
    kern = (lambda: ops.segment_sum_bwd_op(cot, plan))
    torch.testing.assert_close(kern(), segment_sum_bwd_ref(
        cot, plan.edge_dst), rtol=0, atol=0)
    ms = _time_ms(kern)
    plain = _time_ms(lambda: segment_sum_bwd_ref(cot, plan.edge_dst), 100.0)
    idx = plan.edge_dst.clamp_max(N - 1)
    lib = _time_ms(lambda: cot.index_select(0, idx), 100.0)
    bound, by = _bound(_sum_bwd_bytes(E, N, width), 0)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                schedule=_sum_bwd_rule(width),
                shape=f"E={E} N={N} D={width}")


def _sum_bwd_sweep(label: str, plan, gen, widths=SUM_BWD_SWEEP) -> None:
    """Both of ``segment_sum_bwd``'s schedules on one plan at each of
    ``widths``, each held exactly against the plain version, then
    timed (CUDA events; profiled device ms): one JSON line a width, with
    the cotangent's size against the L2 cache and the rule's choice."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_bwd_ref
    E, N = plan.num_edges, plan.num_segments
    l2 = torch.cuda.get_device_properties(DEVICE).L2_cache_size
    for width in widths:
        cot = torch.randn((N, width), generator=gen, device=DEVICE)
        want = segment_sum_bwd_ref(cot, plan.edge_dst)
        row = {"kernel": "segment_sum_bwd", "plan": label,
               "shape": f"E={E} N={N} D={width}",
               "g_over_l2": 4 * N * width / l2,
               "rule": _sum_bwd_rule(width)}
        for schedule in ops.SUM_BWD_SCHEDULES:
            kern = (lambda: ops._segment_sum_bwd_cuda(cot, plan, schedule))
            torch.testing.assert_close(kern(), want, rtol=0, atol=0)
            row[f"{schedule}_ms"] = _time_ms(kern)
            row[f"{schedule}_device_ms"] = _device_ms(kern)
        row["bound_ms"] = _bound(_sum_bwd_bytes(E, N, width), 0)[0]
        del want
        print("  sum_bwd sweep " + json.dumps(row), flush=True)


def sum_bwd_times(gen=None, plan=None, sweep: bool = False) -> dict:
    """``segment_sum_bwd`` where the card does real work and on the GCN
    cells' plan: the 1,000,000-node alipay_like destination plan (built
    here unless ``plan`` is given) at widths 128, 32 and 4 and the
    reddit_like plan at the GCN config's hidden width, under the rule's
    schedule, one plan row each; with ``sweep``, both schedules at
    widths 4 to 128 on those plans and on 200,000- and 50,000-node
    alipay_like plans, whose cotangents lie on either side of the L2
    cache's size, and at widths 4 to 32 on a plan of 4,000,000 rows and
    24,000,000 edges in random order (uniform destinations), whose
    narrow cotangents outgrow it too. Returns the GCN cells' row."""
    import numpy as np
    import torch
    from repro_torch.config import get_gnn_config
    from repro_torch.kernels.plan import build_csc_plan
    gen = gen or torch.Generator(device=DEVICE).manual_seed(0)
    if plan is None:
        plan = _dest_plan("alipay_like", "gat_e", num_nodes=KERNEL_NODES)
    label = f"alipay_like, {plan.num_segments} nodes"
    for width in SUM_BWD_WIDTHS:
        _plan_row("segment_sum_bwd", f"{label}, destination plan, width "
                  f"{width}", _sum_bwd_row(plan, width, gen))
    plans = {label: plan}
    if sweep:
        for nodes in (200_000, 50_000):
            plans[f"alipay_like, {nodes} nodes"] = _dest_plan(
                "alipay_like", "gat_e", num_nodes=nodes)
    cfg, dataset = get_gnn_config("gnn_gcn_reddit")
    gcn = _dest_plan(dataset, cfg.model)
    width = cfg.hidden_dim
    record = _sum_bwd_row(gcn, width, gen)
    _plan_row("segment_sum_bwd", f"reddit_like (GCN cells), width {width}",
              record)
    plans["reddit_like (GCN cells)"] = gcn
    if sweep:
        for name, p in plans.items():
            _sum_bwd_sweep(name, p, gen)
        del plans, plan, gcn
        n = 4 * KERNEL_NODES
        ids = np.random.default_rng(2).integers(0, n, 6 * n)
        _sum_bwd_sweep(f"uniform, {n} nodes", build_csc_plan(
            ids.astype(np.int32), n).to(DEVICE), gen, SUM_BWD_SWEEP[:4])
    return record


def kernel_times() -> dict:
    """Kernel, plain-version and library times at full-graph sizes,
    forward and backward, each kernel's output first held against its
    plain version there."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_ref
    rows = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.inference_mode():
        # GAT-E: edge_softmax and its backward at a full-graph layer 0
        g, block, logit, value = _layer0_inputs(
            "gnn_gat_e_alipay", num_nodes=KERNEL_NODES)
        plan = block.csc_plan
        E, H, D = value.shape
        N = plan.num_segments
        rows["edge_softmax"] = _softmax_row(plan, logit, value)
        _plan_row("edge_softmax", f"alipay_like, {N} nodes (power law)",
                  rows["edge_softmax"])
        rows["edge_softmax_bwd"] = _bwd_row(plan, logit, value, gen)
        _plan_row("edge_softmax_bwd", f"alipay_like, {N} nodes (power law)",
                  rows["edge_softmax_bwd"])
        # the GAT-E gathers' backward over the source plan, at the widths
        # of n (4 heads of 8) and of the logit halves (4 heads)
        for width in (32, 4):
            _plan_row("segment_sum", f"alipay_like, {N} nodes, source plan, "
                      f"width {width} (gathers' backward)",
                      _sum_row(block.src_plan, block.src, width, gen))
        del logit, value
        rows.update(_max_times(plan, gen))
        # segment_sum_bwd on the same destination plan (its schedules'
        # crossover is sum_bwd_times(sweep=True), run on its own)
        rows["segment_sum_bwd"] = sum_bwd_times(gen, plan)
        del g, block, plan
        torch.cuda.empty_cache()
        plan_rows(E, N, H, D, gen)
        gat_e_cell_rows(gen)

        # GCN: segment_sum at a full-graph layer 0 (sum_bwd_times above
        # times its backward)
        g, block, _, value = _layer0_inputs("gnn_gcn_reddit")
        plan = block.csc_plan
        flat = value.flatten(1)
        E, D = flat.shape
        N = plan.num_segments
        torch.testing.assert_close(
            ops.segment_sum_op(flat, plan),
            segment_sum_ref(flat, plan.perm, plan.indptr, N),
            rtol=RTOL, atol=ATOL)
        kern = (lambda: ops.segment_sum_op(flat, plan))
        ms = _time_ms(kern)
        plain = _time_ms(lambda: segment_sum_ref(flat, plan.perm,
                                                 plan.indptr, N))
        dst = block.dst.long()
        lib = _time_ms(lambda: torch.zeros(N, D, device=DEVICE).index_add_(
            0, dst, flat))
        nbytes = 4 * (E * D + E + (N + 1) + N * D)
        bound, by = _bound(nbytes, E * D)
        rows["segment_sum"] = dict(ms=ms, device_ms=_device_ms(kern),
                                   plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=lib,
                                   shape=f"E={E} N={N} D={D}")
        _plan_row("segment_sum", "reddit_like (GCN cells)",
                  rows["segment_sum"])

        # the NN-G gather's backward (ROADMAP C.7): the segment_sum kernel
        # over the source plan, against index_select's own backward, an
        # atomic index_add_ over src
        splan, src = block.src_plan, block.src.long()
        d_msg = torch.randn((E, D), generator=gen, device=DEVICE)
        torch.testing.assert_close(
            ops.segment_sum_op(d_msg, splan),
            torch.zeros(N, D, device=DEVICE).index_add_(0, src, d_msg),
            rtol=RTOL, atol=ATOL)
        ms = _time_ms(lambda: ops.segment_sum_op(d_msg, splan))
        lib = _time_ms(lambda: torch.zeros(N, D, device=DEVICE).index_add_(
            0, src, d_msg))
        print(f"  gather backward [E={E} N={N} D={D}]: segment_sum over the "
              f"source plan {ms:.4f} ms, index_add_ over src {lib:.4f} ms")
    for name, r in rows.items():
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def _flash_inputs(gen, B, T, Hq, Hkv, D):
    import torch
    return [torch.randn((B, T, h, D), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv)]


def _flash_pairs(T, pad, window=0, causal: bool = True) -> int:
    """Visible (query, key) pairs of one causal head over T rows behind
    ``pad`` left-pad rows: query i >= pad sees keys max(pad, i - window +
    1)..i (all of pad..i without a window); without ``causal`` every one
    of the T queries sees keys pad..T-1."""
    import numpy as np
    if not causal:
        return T * (T - pad)
    i = np.arange(pad, T, dtype=np.int64)
    lo = np.maximum(pad, i - window + 1) if window else pad
    return int((i - lo + 1).sum())


def _flash_bound(B, T, Hq, Hkv, D, pads=None, window=0,
                 causal: bool = True) -> tuple:
    """q, k, v read and out written once, in bf16; causal attention does
    QK^T and PV, 2 * D multiply-adds each, over the visible (query, key)
    pairs of each head (T (T + 1) / 2 of a row, (T - pad) (T - pad + 1) /
    2 of a left-padded one, fewer in a window: :func:`_flash_pairs`), at
    the bf16 tensor-core peak."""
    nbytes = 2 * B * T * (2 * Hq * D + 2 * Hkv * D)
    pairs = sum(_flash_pairs(T, p, window, causal)
                for p in (pads or (0,) * B))
    nops = 4 * D * Hq * pairs
    return _bound(nbytes, nops, BF16_OPS_PER_S)


def _bf16_share(got, want) -> float:
    """:func:`_bf16_check`'s worst-element share, reported, not gated."""
    g, w = got.float(), want.float()
    atol = BF16_ATOL * float(w.square().mean().sqrt())
    return float(((g - w).abs() / (atol + BF16_RTOL * w.abs())).max())


def _flash_row(gen, B, T, pads=None, plain: bool = True,
               window: int = 0, heads=(32, 8, 128),
               causal: bool = True) -> dict:
    """``flash_attention`` at an attention shape ``heads`` (q heads, kv
    heads, head dim; the default Qwen3-4B's and Mixtral's 32/8 of 128),
    bf16, causal (or not), B rows of T with left ``pads`` and a sliding
    ``window`` (0: none): held against its plain version (when
    ``plain``) and SDPA, then timed beside both. SDPA runs with
    ``is_causal`` (or neither it nor a mask, bidirectional) or, with pads
    or a window, a boolean mask; its share of the element gate against
    the plain version is reported over the rows that see a key."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    Hq, Hkv, D = heads
    q, k, v = _flash_inputs(gen, B, T, Hq, Hkv, D)
    start = (None if pads is None else
             torch.tensor(pads, dtype=torch.int32, device=DEVICE))
    # the library's layout, made once outside the timed call
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    mask = None
    if pads is not None or window:
        i = torch.arange(T, device=DEVICE)
        ok = (i[None, :] <= i[:, None] if causal else
              torch.ones((T, T), dtype=torch.bool, device=DEVICE))
        if window:
            ok = ok & (i[None, :] > i[:, None] - window)
        first = (start.long() if start is not None else
                 torch.zeros(B, dtype=torch.long, device=DEVICE))
        mask = (ok[None] & (i[None, None, :] >= first[:, None, None]))[
            :, None]
        # a masked call takes repeated kv heads (no GQA backend with masks)
        kt, vt = (a.repeat_interleave(Hq // Hkv, dim=1) for a in (kt, vt))

    def lib_fn():
        # never the math backend: its scores would not fit at 32k
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=mask is None and causal, enable_gqa=mask is None)

    def kern():
        return ops.flash_attention_op(q, k, v, kv_start=start,
                                      sliding_window=window, causal=causal)
    got = kern()
    lib_out = lib_fn().transpose(1, 2)
    seen = (slice(None) if pads is None else
            torch.arange(T, device=DEVICE)[None, :] >= start[:, None])
    lib_rel = _bf16_rel(got[seen], lib_out[seen])
    if lib_rel > LIB_REL:
        raise AssertionError(f"flash_attention at B {B} T {T} vs SDPA: "
                             f"{lib_rel:.3e} of max|out|")
    plain_ms = lib_share = kern_share = None
    if plain:
        want = flash_attention_ref(q, k, v, kv_start=start,
                                   sliding_window=window, causal=causal)
        kern_share = _bf16_check(got, want, f"flash_attention at B {B} "
                                 f"T {T}")
        lib_share = _bf16_share(lib_out[seen], want[seen])
        del want
        plain_ms = _time_ms(lambda: flash_attention_ref(
            q, k, v, kv_start=start, sliding_window=window, causal=causal),
            100.0)
    ms = _time_ms(kern, 100.0)
    lib = _time_ms(lib_fn, 100.0)
    bound, by = _flash_bound(B, T, Hq, Hkv, D, pads, window, causal)
    shape = (f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 "
             f"{'causal' if causal else 'bidirectional'}"
             + (f" window={window}" if window else "")
             + (f" pads={tuple(pads)}" if pads else ""))
    print(f"  flash_attention [{shape}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms} ms, SDPA {lib:.4f} ms, bound {bound:.4f} ms ({by}); "
          f"element-gate share vs plain: kernel {kern_share}, SDPA "
          f"{lib_share} (reported); kernel vs SDPA {lib_rel:.3e} of "
          "max|out|", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib, shape=shape)


def _wkv6_row(gen, B, T, H=32, K=64) -> dict:
    """``wkv6`` at the RWKV-6 1.6B shape (32 heads of 64), r/k/v in bf16,
    float32 o (the model's call): held against its plain version, then
    timed beside it and the bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import wkv6_ref
    r, kk, vv = (torch.randn((B, T, H, K), generator=gen, device=DEVICE)
                 .mul_(0.5).to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, H, K), generator=gen,
                                         device=DEVICE) * 0.7 - 2.0))
    u = torch.randn((H, K), generator=gen, device=DEVICE) * 0.1
    f32 = torch.float32
    o, S = ops.wkv6_op(r, kk, vv, w, u, out_dtype=f32)
    w_o, w_S = wkv6_ref(r, kk, vv, w, u, out_dtype=f32)
    torch.testing.assert_close(S, w_S, rtol=WKV_TOL, atol=WKV_TOL)
    torch.testing.assert_close(o, w_o, rtol=WKV_TOL, atol=WKV_TOL)
    ms = _time_ms(lambda: ops.wkv6_op(r, kk, vv, w, u, out_dtype=f32),
                  100.0)
    plain = _time_ms(lambda: wkv6_ref(r, kk, vv, w, u, out_dtype=f32), 100.0)
    n = B * T * H * K
    # r, k, v in bf16, w and o in f32 (14 bytes a (b, t, h, k)), u and
    # the f32 final state; an FMA for the output and one for the decayed
    # state per (k, v) and step (csrc/wkv6.cu's note counts the same)
    nbytes = 14 * n + 4 * H * K + 4 * B * H * K * K
    bound, by = _bound(nbytes, 4 * B * T * H * K * K)
    shape = f"B={B} T={T} H={H} K=V={K} bf16 in, f32 o"
    print(f"  wkv6 [{shape}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bound:.4f} ms ({by})", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, shape=shape)


def lm_kernel_times() -> dict:
    """``flash_attention`` at the Qwen3-4B prefill shapes: B 1 at T 4096
    (the record's row) and 32768 (kernel and SDPA: the plain version's
    scores would not fit), and the served batch (B 4, T 2048, left pads
    0, 37, 300, 448); at Mixtral's served prefill (B 2, T 4608, window
    4096, left pads 0 and 517; phase 17); at Whisper's encoder (B 4, T
    1500, bidirectional, 8/8 heads of 64) and Qwen2-VL's served prefill
    (B 4, T 2048, 12/2 heads of 128, left pads; phase 19); ``wkv6`` at
    the RWKV-6 1.6B prefill, B 8 T 4096 (the record's row) and the served
    batch, B 4 T 2048. Each kernel is held against its plain version
    there first."""
    import torch
    rows = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.inference_mode():
        rows["flash_attention"] = _flash_row(gen, 1, 4096)
        torch.cuda.empty_cache()
        _flash_row(gen, 1, 32768, plain=False)
        torch.cuda.empty_cache()
        _flash_row(gen, 4, 2048, pads=(0, 37, 300, 448))
        torch.cuda.empty_cache()
        _flash_row(gen, 2, 4608, pads=(0, 517), window=4096)
        torch.cuda.empty_cache()
        # phase 19's shapes: Whisper's encoder (bidirectional, 1,500
        # frames, 8/8 heads of 64) and Qwen2-VL's served prefill (12/2
        # heads of 128, left pads)
        _flash_row(gen, 4, 1500, heads=(8, 8, 64), causal=False)
        _flash_row(gen, 4, 2048, pads=(0, 37, 300, 448), heads=(12, 2, 128))
        torch.cuda.empty_cache()
        rows["wkv6"] = _wkv6_row(gen, 8, 4096)
        _wkv6_row(gen, 4, 2048)
        torch.cuda.empty_cache()
    return rows


# -- phases 12 and 13: LM serving ----------------------------------------------


@contextlib.contextmanager
def plain_lm_kernels():
    """Inside the block the model's prefill calls the kernels' plain
    versions in place of the wrappers (the port itself has no such
    switch: on a CUDA tensor a wrapper launches its kernel)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, wkv6_ref
    saved = ops.flash_attention_op, ops.wkv6_op
    ops.flash_attention_op, ops.wkv6_op = flash_attention_ref, wkv6_ref
    try:
        yield
    finally:
        ops.flash_attention_op, ops.wkv6_op = saved


def _padded_batch(toks, pads, dev) -> dict:
    """The prefill batch of left-padded ``toks`` (B, P) with ``pads``
    pads a row: tokens, the validity mask and pad-shifted positions."""
    import torch
    P = toks.shape[1]
    valid = torch.arange(P)[None, :] >= pads[:, None]
    return {"tokens": toks.to(dev), "valid": valid.to(dev),
            "positions": (torch.arange(P)[None, :] - pads[:, None])
            .clamp_min(0).to(dev, torch.int32)}


def _lm_run(model, toks, pads, feed=None, steps: int = 8, extra=None):
    """Prefill a left-padded batch, then ``steps`` decode steps fed the
    tokens ``feed`` (B, steps), or, when it is None, each step's own
    argmax as the server feeds them; returns (logits of every step,
    float32 on the CPU; the prefill's final states for RWKV; the fed
    tokens). ``extra`` (phase 19's :class:`EncDecInputs`) adds Whisper's
    encoder memory or Qwen2-VL's embeddings and position streams."""
    import torch
    dev = model.device
    batch = _padded_batch(toks, pads, dev)
    if extra is not None:
        batch = extra.prefill_batch(model, batch)
    logits, caches, idx = model.prefill(batch,
                                        cache_len=toks.shape[1] + steps)
    out = [logits.float().cpu()]
    pre = [{k: (v.float().cpu() if torch.is_tensor(v) else None)
            for k, v in (c.get("time", {}) or {}).items()}
           for c in caches]
    fed = []
    for i in range(steps):
        tok = (feed[:, i:i + 1] if feed is not None
               else out[-1][:, -1].argmax(-1)[:, None])
        fed.append(tok)
        step = {"tokens": tok.to(dev), "valid": batch["valid"],
                "positions": (idx - pads.to(dev))[:, None].to(torch.int32)}
        if extra is not None:
            step.update(extra.step_inputs(model, batch, step["tokens"], i))
        logits, caches, idx = model.decode_step(step, caches, idx)
        out.append(logits.float().cpu())
    return torch.cat(out, 1), pre, torch.cat(fed, 1)


def _kernel_and_plain(model, kernel: str, toks, pads, feed, extra=None):
    """``_lm_run`` through the kernels, then through their plain
    versions, on the same model; the counts show the two took different
    paths: one ``kernel`` launch per kernel layer (``_kernel_layers``) in
    the first, none in the second."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    got = _lm_run(model, toks, pads, feed, extra=extra)
    n = ops.launches[kernel]
    ops.reset_launches()
    with plain_lm_kernels():
        want = _lm_run(model, toks, pads, feed, extra=extra)
    expected = _kernel_layers(model.cfg, kernel)
    if n != expected or any(ops.launches.values()):
        raise AssertionError(f"{kernel}: {n} launches on the kernel path "
                             f"(expected {expected}), "
                             f"{dict(ops.launches)} on the plain path")
    return got, want


def _prefill_repeat(model, toks, pads, extra=None) -> None:
    """The same left-padded prefill twice on the card: logits and every
    cache tensor (the final WKV states of RWKV-6, K and V of attention)
    must be bitwise equal, since no kernel of the path sums in an order
    that changes from run to run."""
    import torch
    P = toks.shape[1]
    batch = _padded_batch(toks, pads, model.device)
    if extra is not None:
        batch = extra.prefill_batch(model, batch)

    def leaves(tree):
        if torch.is_tensor(tree):
            return [tree]
        items = tree.values() if isinstance(tree, dict) else tree
        return [x for t in items if t is not None for x in leaves(t)]
    runs = []
    for _ in range(2):
        logits, caches, _ = model.prefill(batch, cache_len=P)
        runs.append([logits] + leaves(caches))
    same = all(bool(torch.equal(a, b)) for a, b in zip(*runs))
    print(f"  bitwise repeat, one bf16 prefill ({len(toks)} prompts of "
          f"{P} padded tokens) twice on the card: "
          f"{'bitwise equal' if same else 'NOT bitwise equal'} over the "
          f"logits and {len(runs[0]) - 1} cache tensors")
    if not same:
        raise AssertionError("two identical prefills on the card differ")


def _profile_lm(server, reqs, kernel_key) -> None:
    """Device time by kernel over one short served batch (prefill and its
    decode rounds), from a ``torch.profiler`` trace, and the device's
    busy share against the same batch's unprofiled time; the port's LM
    kernel (names holding ``kernel_key``; None: a path with no kernel)
    on a line of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        r.out.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.run(reqs)
    batch_ms = 1e3 * (time.perf_counter() - t0)
    for r in reqs:
        r.out.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.run(reqs)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    print(f"    profile (one batch of {len(reqs)}, prompts "
          f"{[len(r.prompt) for r in reqs]}, {reqs[0].max_new} new tokens): "
          f"device busy {busy:.3f} ms in {sum(k[1] for k in kernels):.0f} "
          f"device ops, {100 * busy / batch_ms:.1f}% of the unprofiled "
          f"{batch_ms:.3f} ms batch; largest:")
    for ms, n, key in kernels[:6]:
        print(f"      {ms:.4f} ms over {n:.0f} calls  {key[:90]}")
    if kernel_key is None:
        return
    mine = [k for k in kernels if kernel_key in k[2]]
    print(f"    {kernel_key}: {sum(k[0] for k in mine):.4f} ms over "
          f"{sum(k[1] for k in mine):.0f} calls in the batch")
    if not mine:
        raise AssertionError(f"the profile shows no {kernel_key} launch")


def _lm_batch(cfg, lengths, seed: int = 0):
    """Seeded prompts of the given lengths, left-padded: (tokens, pads)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    P = max(lengths)
    toks = np.zeros((len(lengths), P), np.int64)
    for i, n in enumerate(lengths):
        toks[i, P - n:] = rng.integers(0, cfg.vocab_size, n)
    pads = torch.tensor([P - n for n in lengths])
    return torch.from_numpy(toks), pads


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _state_rel(got_pre, want_pre) -> float:
    return max(_rel(a["state"], b["state"]) for a, b in zip(got_pre,
                                                              want_pre))


def _decode_graphs(arch: str, server, reqs, new_tokens: int) -> None:
    """The decode-graph gates at the served bucket (phases 12-13): the
    serving run captured its decode round once; a server on the same
    weights with ``cuda_graphs=False`` decodes the first batch eagerly,
    and its tokens and every round's logits must equal the replay's bit
    for bit; decode tokens/s eager and under replay, in turns, on the
    same batch (a record, not a gate)."""
    import copy
    import gc
    import torch
    from repro_torch.launch.serve import Request
    B, bucket = server.batch_size, server.bucket
    server.assert_compiled_per_bucket()
    if server.captures != {bucket: 1}:
        raise AssertionError(f"{arch}: decode captures {server.captures}, "
                             f"expected one for the bucket {bucket}")
    # the same model and weights (a second copy of a 47-65 GB model
    # would not fit the card), decoding eagerly
    eager = copy.copy(server)
    eager.graphs_on = False
    first = reqs[:B]
    rates = {"eager": [], "replay": []}
    for name in ("eager", "replay", "replay", "eager"):
        srv = eager if name == "eager" else server
        srv.stats = type(srv.stats)()
        srv.run([Request(r.rid, r.prompt, new_tokens) for r in first])
        rates[name].append(srv.stats.decode_tokens / srv.stats.decode_s)
    outs = {}
    for name, srv in (("eager", eager), ("replay", server)):
        batch = [Request(r.rid, r.prompt, DECODE_CHECK_TOKENS)
                 for r in first]
        srv.round_logits = []
        srv.run(batch)
        outs[name] = ([r.out for r in batch], srv.round_logits)
        srv.round_logits = None
    (et, el), (rt, rl) = outs["eager"], outs["replay"]
    same = et == rt and len(el) == len(rl) and all(
        bool(torch.equal(a, b)) for a, b in zip(el, rl))
    server.assert_compiled_per_bucket()
    print(f"  decode rounds as CUDA graphs, bucket (batch, cache) "
          f"{bucket}: captures {server.captures}; decode tok/s eager "
          f"{', '.join(f'{x:.1f}' for x in rates['eager'])}, replayed "
          f"{', '.join(f'{x:.1f}' for x in rates['replay'])} (batch of "
          f"{B}, prompts {[len(r.prompt) for r in first]}, {new_tokens} "
          f"new tokens, eager / replay / replay / eager); replay vs eager "
          f"over {len(rl)} rounds: tokens and logits "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}")
    print("  decode row " + json.dumps({
        "arch": arch, "bucket": list(bucket), "captures": 1,
        "decode_tok_s_eager": rates["eager"],
        "decode_tok_s_replay": rates["replay"],
        "new_tokens": new_tokens, "prompts": [len(r.prompt) for r in first],
        "bitwise": same}), flush=True)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError(f"{arch}: replayed decode differs from eager")


def _rolling_vs_full(card, toks, pads, steps: int) -> None:
    """The rolling cache against the full cache on the card (phase 17),
    float32, the same weights: a left-padded prefill longer than the
    window, then ``steps`` seeded decode steps, each wrapping the slots
    further; every step's logits within ``ROLL_TOL`` of max|logit|."""
    import torch
    from repro_torch.arch import build_model
    cfg = card.cfg
    full = build_model(cfg, torch.Generator(device=DEVICE).manual_seed(1))
    full.load_state_dict(card.state_dict())
    full.requires_grad_(False)
    feed = torch.randint(0, cfg.vocab_size, (len(toks), steps),
                         generator=torch.Generator().manual_seed(2))
    got, _, _ = _lm_run(card, toks, pads, feed, steps=steps)
    want, _, _ = _lm_run(full, toks, pads, feed, steps=steps)
    err = _rel(got, want)
    slots = min(toks.shape[1] + steps, cfg.sliding_window)
    print(f"  f32 depth {cfg.num_layers}, rolling cache ({slots} slots) vs "
          f"full cache ({toks.shape[1] + steps}) on the card: prefill of "
          f"{toks.shape[1]} padded tokens + {steps} decode steps, logits "
          f"max diff {err:.3e} of max|logit| (limit {ROLL_TOL})")
    if not torch.isfinite(got).all() or err > ROLL_TOL:
        raise AssertionError(f"rolling vs full cache differ by {err:.3e}")


def _wrapping_traffic(serve_lengths, window: int, new_tokens: int) -> None:
    """Phase 17's Mixtral traffic: every batch's decode runs past the
    window's last slot (its padded prompt plus the decoded tokens exceed
    the window), and some prefills keep only the window's last keys."""
    B = LM_BATCH
    padded = [max(serve_lengths[i:i + B])
              for i in range(0, len(serve_lengths), B)]
    longer = sum(n > window for n in serve_lengths)
    print(f"  traffic: {len(serve_lengths)} prompts of "
          f"{min(serve_lengths)}-{max(serve_lengths)} tokens, {longer} "
          f"longer than the window {window}; padded batch lengths "
          f"{padded}, each + {new_tokens - 1} decode rounds past {window}")
    if any(P + new_tokens - 1 <= window for P in padded) or not longer:
        raise AssertionError("a batch's decode does not wrap the window")


def _kernel_layers(cfg, kernel) -> int:
    """The layers of ``cfg`` whose prefill launches ``kernel``: the GQA
    layers for ``flash_attention`` (MLA attends through products), with
    Whisper's encoder layers (bidirectional), the RWKV layers for
    ``wkv6``; 0 for no kernel."""
    from repro_torch.arch import layer_kinds
    kinds = layer_kinds(cfg)
    if kernel == "wkv6":
        return kinds.count("rwkv")
    if kernel == "flash_attention" and cfg.mla is None:
        return kinds.count("attn") + cfg.encoder_layers
    return 0


def _free() -> None:
    """Return the card's memory freed by the models just dropped."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _f32_model(f32, seed: int, rolling: bool = False):
    """The float32 model of config ``f32``, its weights drawn on the card
    from ``seed``; prints its size and build time."""
    import torch
    from repro_torch.arch import build_model
    t0 = time.perf_counter()
    model = build_model(f32, torch.Generator(device=DEVICE).manual_seed(seed),
                        rolling_window_decode=rolling).requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"  {f32.name}: {f32.num_layers} layers, d {f32.d_model}, "
          f"{n_params / 1e9:.3f} B parameters, float32 "
          f"({4 * n_params / 1e9:.1f} GB), made on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    return model


def _f32_kernel_vs_plain(model, kernel: str, toks, pads, seeded,
                         label: str, extra=None) -> None:
    """A float32 model's prefill plus 8 seeded decode steps through
    ``kernel`` against its plain version, within ``LM_PARITY`` of
    max|logit| (and RWKV's final states)."""
    import torch
    f32 = model.cfg
    (got, got_pre, _), (want, want_pre, _) = _kernel_and_plain(
        model, kernel, toks, pads, seeded, extra)
    err = _rel(got, want)
    print(f"  f32 {label}, kernel vs plain on the card: prefill + 8 "
          f"decode logits max diff {err:.3e} of max|logit| (limit "
          f"{LM_PARITY}); {_kernel_layers(f32, kernel)} {kernel} "
          f"launches, 0 plain")
    if not torch.isfinite(got).all() or err > LM_PARITY:
        raise AssertionError(f"{f32.name}: kernel vs plain logits {err:.3e}")
    if f32.rwkv is not None:
        s_err = _state_rel(got_pre, want_pre)
        print(f"  f32 {label}, kernel vs plain: prefill final states max "
              f"diff {s_err:.3e} of max|S| (limit {LM_PARITY})")
        if s_err > LM_PARITY:
            raise AssertionError(f"{f32.name}: final states differ by "
                                 f"{s_err}")


def _card_vs_cpu(card, toks, pads, seeded, label: str,
                 kernel=None, extra=None) -> None:
    """``card`` (a float32 model on the card) against its copy on the
    CPU: decode fed the seeded tokens, then the CPU's own argmax as the
    server feeds (the card is fed the CPU's picks, so a near tie cannot
    part them); logits (and RWKV's final states) within ``LM_CPU``; each
    card run launches ``kernel`` once per kernel layer."""
    import copy
    import torch
    from repro_torch.kernels import ops
    cfg = card.cfg
    cpu = copy.deepcopy(card).cpu()
    for feed_name, feed in (("seeded", seeded), ("argmax", None)):
        t0 = time.perf_counter()
        want, want_pre, fed = _lm_run(cpu, toks, pads, feed, extra=extra)
        cpu_s = time.perf_counter() - t0
        ops.reset_launches()
        got, got_pre, _ = _lm_run(card, toks, pads, fed, extra=extra)
        n = ops.launches[kernel] if kernel else 0
        err = _rel(got, want)
        msg = (f"  f32 {label}, card vs CPU, {feed_name} feed: "
               f"logits max diff {err:.3e} of max|logit| (limit {LM_CPU}; "
               f"the CPU run {cpu_s:.1f}s)")
        if feed is None:
            same = float((got[:, :-1].argmax(-1) == fed).float().mean())
            msg += (f"; the card's own argmax picks the CPU's token at "
                    f"{100 * same:.1f}% of {fed.numel()} steps")
        if cfg.rwkv is not None:
            s_err = _state_rel(got_pre, want_pre)
            msg += f"; final states {s_err:.3e} of max|S|"
            err = max(err, s_err)
        if kernel:
            msg += f"; {n} {kernel} launches"
        print(msg)
        if not torch.isfinite(got).all() or err > LM_CPU:
            raise AssertionError(f"{cfg.name}: card vs CPU, {feed_name} "
                                 f"feed, differ by {err:.3e}")
        if n != _kernel_layers(cfg, kernel):
            raise AssertionError(f"{cfg.name}: card vs CPU, {n} {kernel} "
                                 f"launches, expected one per kernel layer")


def serve_lm(arch: str, kernel: str, lengths, serve_lengths,
             new_tokens: int = LM_NEW_TOKENS, parity_layers=None,
             parity_window=None, serve_layers=None, rolling: bool = False,
             decode_tokens=None) -> dict:
    """The parity gates and the bf16 serving run of one LM (see the
    module docstring, phases 12-13 and 17); returns the serving run's
    launch counts. ``parity_layers`` cuts the float32 kernel-vs-plain
    model's depth (None: full depth; a model whose float32 weights do not
    fit the card), ``parity_window`` replaces the window in the float32
    gates, ``serve_layers`` the bf16 server's depth; ``rolling`` serves
    (and gates) the rolling sliding-window cache; ``decode_tokens`` is
    the new-token count of the eager-vs-replay rate comparison."""
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    cfg = get_arch_config(arch)
    f32 = cfg.replace(dtype="float32")
    f32 = f32.replace(num_layers=parity_layers or f32.num_layers,
                      sliding_window=parity_window or f32.sliding_window)
    depth = (f"depth {f32.num_layers} of {cfg.num_layers}"
             if f32.num_layers < cfg.num_layers else "full depth")
    window = (f", window {f32.sliding_window}, rolling"
              if rolling and f32.sliding_window else "")
    toks, pads = _lm_batch(cfg, lengths)
    # seeded decode tokens: the same feed whatever the logits say
    seeded = torch.randint(0, cfg.vocab_size, (len(lengths), 8),
                           generator=torch.Generator().manual_seed(1))

    # f32: the kernel path against the plain path on the card
    model = _f32_model(f32, 0, rolling)
    _f32_kernel_vs_plain(model, kernel, toks, pads, seeded, depth + window)
    del model
    _free()

    # f32, depth 2 at full width: the card against the CPU, the weights
    # drawn on the card and copied to the CPU
    card = build_model(f32.replace(num_layers=2),
                       torch.Generator(device=DEVICE).manual_seed(1),
                       rolling_window_decode=rolling).requires_grad_(False)
    _card_vs_cpu(card, toks, pads, seeded, f"depth 2{window}", kernel)
    if rolling and f32.sliding_window:
        _rolling_vs_full(card, toks, pads, f32.sliding_window + 8)
    del card
    _free()
    served = cfg if serve_layers is None else cfg.replace(
        num_layers=serve_layers)
    return _bf16_serving(served, kernel, toks, pads, seeded, serve_lengths,
                         new_tokens, rolling=rolling,
                         decode_tokens=decode_tokens)


def _bf16_serving(scfg, kernel, toks, pads, seeded, serve_lengths,
                  new_tokens: int, rolling: bool = False,
                  decode_tokens=None) -> dict:
    """The bf16 serving run at full width through ``BatchServer`` of the
    config ``scfg`` (the published one, or one whose depth or expert
    count is cut): a warm-up batch, then ``serve_lengths`` in batches of
    ``LM_BATCH``; tokens/s, a decode round's ms against the weight-read
    bound, peak memory, ``kernel`` launched once per kernel layer per
    batch (no kernel at all when it is None), the decode-graph gates, a
    profile of one short batch, two bf16 prefills of the parity batch
    ``toks`` bitwise equal, the bf16 kernel against plain (logits
    reported; every kernel call gated by :func:`_bf16_layers`); returns
    the serving run's launch counts."""
    import numpy as np
    import torch
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BatchServer, Request
    arch = scfg.name
    cfg = get_arch_config(arch)
    rng = np.random.default_rng(0)
    B = LM_BATCH
    if rolling and cfg.sliding_window:
        _wrapping_traffic(serve_lengths, cfg.sliding_window, new_tokens)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = BatchServer(scfg, batch_size=B,
                         cache_len=max(serve_lengths) + new_tokens,
                         seed=0, device=DEVICE, rolling=rolling)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.model.parameters())
    # a decode round reads every weight once, but of an untied input
    # embedding only the batch's rows
    w_bytes = sum(p.numel() * p.element_size()
                  for n, p in server.model.named_parameters()
                  if scfg.tie_embeddings or n != "embed.table")
    slots = (min(server.cache_len, scfg.sliding_window)
             if server.model.rolling else server.cache_len)
    experts = ("" if scfg.moe is None or scfg.moe == cfg.moe else
               f", {scfg.moe.num_experts} of {cfg.moe.num_experts} experts "
               f"(top {scfg.moe.top_k})")
    print(f"  bf16 server: {scfg.num_layers} of {cfg.num_layers} layers"
          f"{experts}, {n_params / 1e9:.3f} B parameters "
          f"({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card), "
          f"made in {time.perf_counter() - t0:.1f}s"
          + ("" if scfg.rwkv is not None else
             f"; cache {slots} slots a row"))
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    new_tokens) for i, n in enumerate(serve_lengths)]
    server.run(reqs[:B])                  # warm-up batch, not counted
    server.stats = type(server.stats)()
    for r in reqs[:B]:
        r.out.clear()
    ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, len(reqs), B):
        server.run(reqs[i:i + B])
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = server.stats
    n_batches = (len(reqs) + B - 1) // B
    round_ms = 1e3 * st.decode_s / (n_batches * (new_tokens - 1))
    bound_ms = 1e3 * w_bytes / HBM_BYTES_PER_S
    print(f"  bf16 serving, {len(reqs)} requests (prompts "
          f"{min(serve_lengths)}-{max(serve_lengths)}, mean "
          f"{np.mean(serve_lengths):.0f}), batch {B}, {new_tokens} new "
          f"tokens: prefill {st.prefill_tokens} tok in {st.prefill_s:.4f}s "
          f"= {st.prefill_tokens / st.prefill_s:.1f} tok/s; decode "
          f"{st.decode_tokens} tok in {st.decode_s:.4f}s = "
          f"{st.decode_tokens / st.decode_s:.1f} tok/s "
          f"({round_ms:.2f} ms per decode round against a weight-read "
          f"bound of {bound_ms:.2f} ms: {w_bytes / 1e9:.2f} GB"
          + ("" if scfg.tie_embeddings else ", the input embedding left "
             "out,") + f" over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); wall {wall:.3f}s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    if any(len(r.out) != new_tokens for r in reqs):
        raise AssertionError(f"{arch}: a request got the wrong token count")
    if kernel is None:
        print("  launches: none (its path runs no kernel)")
        if any(launches.values()):
            raise AssertionError(f"{arch}: kernels launched {launches}")
    else:
        per = _kernel_layers(scfg, kernel)
        print(f"  launches: {kernel} {launches[kernel]} = "
              f"{launches[kernel] / n_batches:.0f} per prefill batch "
              f"({per} of {scfg.num_layers} layers)")
        if launches[kernel] != per * n_batches:
            raise AssertionError(f"{arch}: {launches[kernel]} {kernel} "
                                 f"launches, expected one per kernel "
                                 f"layer per batch")

    _decode_graphs(arch, server, reqs, decode_tokens or new_tokens)

    # a trace of one batch short enough to profile: the first prompts,
    # 16 new tokens
    _profile_lm(server, [Request(r.rid, r.prompt, 16) for r in reqs[:B]],
                {"flash_attention": "flash_tc_kernel",
                 "wkv6": "wkv6_kernel"}.get(kernel))
    _prefill_repeat(server.model, toks, pads)

    if kernel is not None:
        # bf16: kernel against plain on one batch, reported only
        (got, _, _), (want, _, _) = _kernel_and_plain(server.model, kernel,
                                                      toks, pads, seeded)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        print(f"  bf16 kernel vs plain (reported, not gated): logits max "
              f"diff {_rel(got, want):.3e} of max|logit|; greedy tokens "
              f"agree on {100 * agree:.1f}% of "
              f"{got.shape[0] * got.shape[1]} positions")
        _bf16_layers(server.model, kernel, toks, pads)
    del server
    _free()
    return launches


@contextlib.contextmanager
def _wrapped(module, name: str, after):
    """Inside the block ``module.<name>`` runs as before, then hands its
    arguments and result to ``after(args, kwargs, result)``."""
    fn = getattr(module, name)

    def call(*args, **kw):
        out = fn(*args, **kw)
        after(args, kw, out)
        return out
    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _bf16_layers(model, kernel: str, toks, pads, extra=None) -> None:
    """The bf16 kernel-vs-plain gap of one prefill of ``toks``, split by
    layer. Gated: every ``kernel`` call of the kernel run, held element
    by element (:func:`_bf16_check`) against its plain version on the
    same inputs, at the shapes and on the data of the served model.
    Reported: each layer's output in the kernel run against the plain
    run (max diff over max|h|) and, for an MoE layer, the share of real
    tokens whose top-k experts differ between the two runs."""
    import torch
    from repro_torch.arch import model as model_mod
    from repro_torch.arch import moe as moe_mod
    from repro_torch.kernels import ops, ref
    op = f"{kernel}_op"
    plain = getattr(ref, f"{kernel}_ref")
    shares, runs = [], []

    def check(args, kw, out):
        want = plain(*args, **kw)
        for g, w in zip(*((out, want) if isinstance(out, tuple)
                          else ((out,), (want,)))):
            shares.append(_bf16_check(g, w, f"{kernel} call {len(shares)} "
                                      f"in the served {model.cfg.name}"))

    def keep_h(args, kw, out):
        runs[-1]["h"].append(out[0].float().cpu())

    def keep_picks(args, kw, out):          # called inside layer len(h)
        runs[-1]["picks"][len(runs[-1]["h"])] = (out[0] > 0).cpu()
    for use_kernel in (True, False):
        runs.append({"h": [], "picks": {}})
        with _wrapped(model_mod, "block_apply", keep_h), \
                _wrapped(moe_mod, "router_gates", keep_picks), \
                (_wrapped(ops, op, check) if use_kernel
                 else plain_lm_kernels()):
            batch = _padded_batch(toks, pads, model.device)
            if extra is not None:      # Whisper's encoder runs here
                batch = extra.prefill_batch(model, batch)
            runs[-1]["logits"] = model.prefill(
                batch, cache_len=toks.shape[1])[0].float().cpu()
    (got, want) = runs
    real = (torch.arange(toks.shape[1])[None, :] >= pads[:, None])
    parts = []
    names = ([f"enc {i}" for i in range(model.cfg.encoder_layers)]
             + [f"{i} {kind}" for i, kind in enumerate(model.kinds)])
    for i, (name, a, b) in enumerate(zip(names, got["h"], want["h"])):
        part = f"{name} {_rel(a, b):.2e}"
        if i in got["picks"]:
            moved = (got["picks"][i] != want["picks"][i]).any(-1)[real]
            part += f" (moe, {100 * float(moved.float().mean()):.1f}% " \
                    f"rerouted)"
        parts.append(part)
    print(f"  bf16 kernel vs plain, one prefill ({len(toks)} prompts of "
          f"{toks.shape[1]} padded tokens) split by layer: {len(shares)} "
          f"{kernel} outputs held element by element to their plain "
          f"versions on the same inputs, the worst element at "
          f"{max(shares):.3f} of its limit; each layer's output, max diff "
          f"of max|h|: " + "; ".join(parts) + f"; prefill logits "
          f"{_rel(got['logits'], want['logits']):.3e} of max|logit|")


def _serve_lm_example() -> None:
    """``examples/serve_lm_torch.py`` (reduced Mixtral, window 16,
    rolling) on the card from its CPU run's weights: the same greedy
    tokens, prefill logits within ``LM_CPU`` of max|logit|."""
    import torch
    ex = _example("serve_lm_torch")
    want = ex.main(device="cpu")
    got = ex.main(device=DEVICE, params=want["params"])
    err = _rel(got["prefill_logits"], want["prefill_logits"])
    same = bool((got["tokens"] == want["tokens"]).all())
    print(f"  examples/serve_lm_torch.py card vs CPU: prefill logits max "
          f"diff {err:.3e} of max|logit| (limit {LM_CPU}); "
          f"{got['tokens'].size} greedy tokens "
          f"{'equal' if same else 'NOT equal'}")
    if err > LM_CPU or not same or not torch.isfinite(
            got["prefill_logits"]).all():
        raise AssertionError("the serving example differs on the card")


# -- phases 7 and 8: training --------------------------------------------------


def _fit_job(job, steps: int, prefetch: bool = True,
             cuda_graphs: bool = True):
    """Make the job's trainer (``cuda_graphs=False``: every step eager)
    and fit ``steps`` steps, the first alone so its gradients can be
    read. Returns (trainer, views, losses, step-1 grads on the CPU,
    seconds of steps 2.. with the device drained)."""
    import torch
    from repro_torch import api
    trainer, views, *_ = api.make_trainer(job)
    if not cuda_graphs:
        trainer = _eager(trainer)
    losses = trainer.fit(views, steps=1, prefetch=prefetch)["losses"]
    grads = {k: p.grad.detach().cpu() for k, p in trainer.params.items()}
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += trainer.fit(views, steps=steps - 1,
                          prefetch=prefetch)["losses"]
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return trainer, views, losses, grads, time.perf_counter() - t0


# the port's Sum-stage kernel sources: a profiled CUDA kernel counts for
# the first whose name, with an underscore after it, is in its own
_FAMILIES = ("segment_sum_bwd", "segment_sum", "edge_softmax_bwd",
             "edge_softmax", "segment_max_bwd", "segment_max")


def _eager(trainer):
    """The same trainer (its model, graph, optimizer and staging) with
    every step eager: no CUDA graph."""
    from repro_torch.core.trainer import CompactTrainer
    return CompactTrainer(trainer.model, trainer.g, trainer.opt,
                          gcn_norm=trainer.stager.gcn_norm,
                          device=trainer.device, cuda_graphs=False)


def _profile(trainer, views, step_ms: float, steps: int = 5) -> float:
    """Device time per step by kernel over ``steps`` more steps, from a
    ``torch.profiler`` trace, and the device's busy share against the
    unprofiled step time ``step_ms``; returns the busy ms per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit(views, steps=steps)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3 / steps, e.count
                       / steps, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    print(f"    profile ({steps} steps): device busy {busy:.3f} ms per "
          f"step in {sum(k[1] for k in kernels):.0f} device ops, "
          f"{100 * busy / step_ms:.1f}% of the unprofiled "
          f"{step_ms:.3f} ms step; largest:")
    for ms, n, key in kernels[:6]:
        print(f"      {ms:.4f} ms/step over {n:.0f} calls  {key[:90]}")
    port = [k for k in kernels[6:] if any(
        name in k[2] for name in ("segment_sum", "edge_softmax",
                                  "segment_max"))]
    if port:
        print("    and the port's other Sum-stage kernels:")
    for ms, n, key in port:
        print(f"      {ms:.4f} ms/step over {n:.0f} calls  {key[:90]}")
    # each Sum-stage kernel's device ms a step, its launches (the rows or
    # chunks and the merge) summed
    fams = {}
    for ms, n, key in kernels:
        name = next((f for f in _FAMILIES if f"{f}_" in key), None)
        if name:
            t, c = fams.get(name, (0.0, 0.0))
            fams[name] = (t + ms, c + n)
    print("    Sum-stage kernels, device ms/step: " + ", ".join(
        f"{k} {t:.4f} ({c:.0f} CUDA launches)" for k, (t, c) in fams.items()))
    return busy


def _spans() -> dict:
    """The fit loop's span seconds so far (``repro_torch.utils.trace``):
    the waits for staged views, the dispatches and the loss reads."""
    from repro_torch.utils import trace
    return {k: trace.spans.get(k, {"seconds": 0.0})["seconds"]
            for k in ("step.stage_wait", "step.dispatch", "step.loss_wait")}


def _loop_s(before: dict) -> dict:
    """Host seconds of the fit loop since ``before`` (:func:`_spans`):
    ``stage_s``, the waits for staged views; ``step_s``, the dispatches
    and the loss reads (any wait on the device)."""
    now = _spans()
    d = {k: now[k] - before[k] for k in now}
    return {"stage_s": d["step.stage_wait"],
            "step_s": d["step.dispatch"] + d["step.loss_wait"]}


def _src_plan_s(trainer, views, steps: int):
    """Host seconds that building the source plans (the gather
    backward's, ROADMAP C.7) adds to staging the first ``steps`` views of
    a compact stream; None for the global stream, whose one plan is
    built once per graph."""
    from repro_torch.core.views import CompactView
    from repro_torch.kernels.plan import build_bucket_csc_plan
    total = 0.0
    for i in range(steps):
        view = views.build(i)
        if not isinstance(view, CompactView):
            return None
        n_pad, e_pad = trainer.stager._pick(view)
        t0 = time.perf_counter()
        build_bucket_csc_plan(view.src_local, n_pad, e_pad)
        total += time.perf_counter() - t0
    return total


def train(config: str, label: str, bwd_kernel: str, bwd_per_step: int,
          take_per_step: int, model_name=None) -> dict:
    """Train the config module's model (swapped for ``model_name`` when
    given) on the card under each strategy, hold it against the same job
    on the CPU, and return the launch counts of the card runs; the
    backward kernel must launch ``bwd_per_step`` times on every step, and
    NN-G's planned gather (``"take"``) ``take_per_step`` times. Then run
    20 global steps twice on the card: the two runs must agree bit for
    bit."""
    import dataclasses
    import importlib
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import config_for, resolve_graph
    mod = importlib.import_module(f"repro_torch.configs.{config}")
    cfg, dataset = _config(config, model_name)
    g = resolve_graph(dataset, cfg.model, seed=0)
    if config_for(g, cfg.model, cfg.num_layers, cfg.hidden_dim) != cfg:
        raise AssertionError(f"{config}: the trained model is not CONFIG")
    total = {}
    for strategy, tcfg in mod.TRAIN.items():
        job = api.TrainJob(
            dataset=dataset, model=cfg.model, strategy=strategy,
            steps=TRAIN_STEPS, num_layers=cfg.num_layers,
            hidden=cfg.hidden_dim, lr=tcfg.lr,
            weight_decay=tcfg.weight_decay, seed=tcfg.seed, compact=True,
            halo_hops=tcfg.cluster_halo_hops, eval_every=0, device=DEVICE)
        ops.reset_launches()
        before = _spans()
        card, views, losses, grads, wall = _fit_job(job, TRAIN_STEPS)
        t = _loop_s(before)
        launches = dict(ops.launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        # the same job with inline staging (the parent's), next to the
        # card run and before the CPU job, whose threads would slow it:
        # fit's default builder threads share the GIL with the step's
        # launches, and a global stream is staged inline either way
        before = _spans()
        _, _, inl_losses, _, inl_wall = _fit_job(
            dataclasses.replace(job, dataset=g), TRAIN_STEPS, prefetch=False)
        ti = _loop_s(before)
        _, _, want, want_grads, _ = _fit_job(
            dataclasses.replace(job, device="cpu"), TRAIN_STEPS)
        g_err = max(float((grads[k] - want_grads[k]).abs().max())
                    / max(float(want_grads[k].abs().max()), 1e-30)
                    for k in want_grads)
        l_err = max(abs(a - b) / max(1.0, abs(b))
                    for a, b in zip(losses, want))
        print(f"  [{label}, {cfg.model}, {strategy}] {TRAIN_STEPS} steps, "
              f"buckets {dict(card.step_calls)}: "
              f"{(TRAIN_STEPS - 1) / wall:.2f} steps/s over steps 2-"
              f"{TRAIN_STEPS}; host staging {t['stage_s']:.4f} s, device "
              f"step {t['step_s']:.4f} s (host clock, all steps)")
        print(f"    inline staging: {(TRAIN_STEPS - 1) / inl_wall:.2f} "
              f"steps/s over steps 2-{TRAIN_STEPS} (builder threads "
              f"{(TRAIN_STEPS - 1) / wall:.2f}); host staging "
              f"{ti['stage_s']:.4f} s, device step {ti['step_s']:.4f} s; "
              f"losses {'bitwise equal' if inl_losses == losses else 'DIFFER'}")
        if inl_losses != losses:
            raise AssertionError(f"{strategy}: inline staging's losses "
                                 "differ from the builder threads'")
        src_s = _src_plan_s(card, views, TRAIN_STEPS)
        if src_s is not None:
            # the builder threads stage ahead: stage_s is the loop's
            # wait for a staged view, not the staging's own time
            print(f"    source plans (gather backward): {src_s:.4f} s to "
                  f"build for these views, beside the loop's "
                  f"{t['stage_s']:.4f} s wait for staged views")
        print(f"    loss {losses[0]:.5f} -> {losses[-1]:.5f} (CPU "
              f"{want[0]:.5f} -> {want[-1]:.5f}); card vs CPU: step-1 "
              f"gradients max rel err {g_err:.3e} (tolerance {GRAD_TOL}), "
              f"losses max rel err {l_err:.3e} (tolerance {LOSS_TOL})")
        print(f"    launches: {launches}, "
              f"{launches[bwd_kernel] / TRAIN_STEPS:.2f} {bwd_kernel} and "
              f"{launches['take'] / TRAIN_STEPS:.2f} take per step")
        _profile(card, views, 1e3 * wall / (TRAIN_STEPS - 1))
        if not np.isfinite(losses).all() or len(losses) != TRAIN_STEPS:
            raise AssertionError(f"{strategy}: bad losses {losses}")
        if g_err > GRAD_TOL:
            raise AssertionError(f"{strategy}: step-1 gradients differ "
                                 f"from the CPU's by {g_err:.3e}")
        if l_err > LOSS_TOL:
            raise AssertionError(f"{strategy}: losses differ from the "
                                 f"CPU's by {l_err:.3e}")
        if strategy == "global" and not losses[-1] < losses[0]:
            raise AssertionError(f"global: the loss did not fall "
                                 f"({losses[0]} -> {losses[-1]})")
        # every step runs the same layers, so launches on every step show
        # as exactly bwd_per_step * steps
        if launches[bwd_kernel] != bwd_per_step * TRAIN_STEPS:
            raise AssertionError(
                f"{strategy}: {launches[bwd_kernel]} {bwd_kernel} launches "
                f"in {TRAIN_STEPS} steps, expected {bwd_per_step} per step")
        if launches["take"] != take_per_step * TRAIN_STEPS:
            raise AssertionError(
                f"{strategy}: {launches['take']} take launches in "
                f"{TRAIN_STEPS} steps, expected {take_per_step} per step")

    # the same 20 global steps twice on the card, bit for bit
    job = api.TrainJob(dataset=dataset, model=cfg.model, steps=20,
                       num_layers=cfg.num_layers, hidden=cfg.hidden_dim,
                       lr=mod.TRAIN["global"].lr, eval_every=0,
                       device=DEVICE)
    runs = []
    for _ in range(2):
        trainer, views, *_ = api.make_trainer(job)
        losses = trainer.fit(views, steps=20)["losses"]
        runs.append((losses, {k: v.detach().cpu() for k, v in
                              trainer.model.state_dict().items()}))
    (la, pa), (lb, pb) = runs
    same = la == lb and all(bool((pa[k] == pb[k]).all()) for k in pa)
    diff = max([abs(a - b) for a, b in zip(la, lb)]
               + [float((pa[k] - pb[k]).abs().max()) for k in pa])
    print(f"  bitwise repeat, 20 global steps twice on the card: "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}, largest "
          f"difference over losses and final parameters {diff:.3e}")
    if not same:
        raise AssertionError(f"{cfg.model}: two identical training runs on "
                             "the card differ")
    return total


# -- phase 11: the fault-tolerant runtime ---------------------------------------


def _rt_run(job, steps: int = RUNTIME_STEPS, policy=None, injector=None,
            **fit_kw):
    """A fresh trainer for ``job`` (``api.make_trainer``; rebuilt around
    the same model with a runtime when an ``injector`` is given), fit
    ``steps`` steps over the job's own stream with ``fit_kw``. Returns
    (trainer, stream, fit's result, wall seconds with the device
    drained)."""
    import torch
    from repro_torch import api
    from repro_torch.core.trainer import CompactTrainer
    trainer, stream, *_ = api.make_trainer(job)
    if injector is not None:
        trainer = CompactTrainer(
            trainer.model, trainer.g, trainer.opt,
            gcn_norm=trainer.stager.gcn_norm, device=trainer.device,
            fault_policy=policy, injector=injector)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.fit(stream, steps=steps, **fit_kw)
    torch.cuda.synchronize()
    return trainer, stream, out, time.perf_counter() - t0


def _params(trainer) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in trainer.model.state_dict().items()}


def _bitwise(what: str, got, want) -> None:
    """Gate: losses and final parameters equal bit for bit."""
    (lg, pg), (lw, pw) = got, want
    same = lg == lw and pg.keys() == pw.keys() and all(
        bool((pg[k] == pw[k]).all()) for k in pw)
    print(f"    {what}: {len(lg)} losses and the final parameters "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}")
    if not same:
        raise AssertionError(f"{what}: not bitwise equal to the reference "
                             "run")


def runtime(label: str) -> dict:
    """Phase 11: the GAT-E and GCN mini cells under the fault-tolerant
    runtime, 30 steps each, at the configs' full widths on the card:
    inline staging, builder threads 1 and 3, sampler processes and the
    chaos run agree bit for bit; a 15 + 15 step checkpoint-resume split
    is the uninterrupted run; skip_view and rollback equal a run that
    never saw the poison view; a card checkpoint steps on the CPU within
    LOSS_TOL of the card's next loss. Then ``stage_s``, ``step_s`` and
    steps/s per staging mode for the mini and cluster cells. Returns the
    phase's launch counts."""
    import dataclasses
    import importlib
    import math
    import os
    import tempfile
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import resolve_graph
    from repro_torch.runtime import FaultInjector, FaultPolicy, procpool
    if not procpool.shared_memory_available():
        raise AssertionError("shared memory is unavailable: the sampler "
                             "processes cannot start")
    cores = os.cpu_count()
    workers = max(1, min(4, (cores or 2) - 1))
    print(f"  host: {cores} CPU cores, default prefetch workers {workers}")
    ops.reset_launches()
    for config, kernels in (
            ("gnn_gat_e_alipay", ("edge_softmax", "edge_softmax_bwd",
                                  "segment_sum")),
            ("gnn_gcn_reddit", ("segment_sum", "segment_sum_bwd"))):
        mod = importlib.import_module(f"repro_torch.configs.{config}")
        cfg, dataset = _config(config)
        g = resolve_graph(dataset, cfg.model, seed=0)

        def job(strategy, **kw):
            t = mod.TRAIN[strategy]
            return api.TrainJob(
                dataset=g, model=cfg.model, strategy=strategy,
                num_layers=cfg.num_layers, hidden=cfg.hidden_dim, lr=t.lr,
                weight_decay=t.weight_decay, seed=t.seed, compact=True,
                halo_hops=t.cluster_halo_hops, eval_every=0, device=DEVICE,
                **kw)

        before = dict(ops.launches)
        mini = job("mini")
        print(f"  [{label}, {cfg.model}, mini, {RUNTIME_STEPS} steps]")
        tr, _, out, _ = _rt_run(mini, prefetch=False)
        ref = (out["losses"], _params(tr))
        if not np.isfinite(ref[0]).all():
            raise AssertionError(f"{cfg.model}: bad losses {ref[0]}")
        for what, kw in (("thread workers 1", dict(prefetch_workers=1)),
                         ("thread workers 3", dict(prefetch_workers=3)),
                         ("process workers 2", dict(
                             prefetch_workers=2, prefetch_mode="process"))):
            tr, _, out, _ = _rt_run(mini, **kw)
            _bitwise(f"{what} vs inline", (out["losses"], _params(tr)), ref)
        inj = FaultInjector(CHAOS_PLAN, seed=0)
        with tempfile.TemporaryDirectory() as d:
            tr, _, out, _ = _rt_run(
                mini, policy=FaultPolicy(**FAST), injector=inj,
                prefetch_workers=3, prefetch_mode="process",
                checkpoint_dir=d, checkpoint_every=5)
        print(f"    chaos faults fired: {dict(inj.fired)}")
        if inj.total_fired() < 3:
            raise AssertionError(f"chaos: only {inj.fired} fired")
        _bitwise("chaos, process workers 3, checkpoint_every 5",
                 (out["losses"], _params(tr)), ref)

        half = RUNTIME_STEPS // 2
        with tempfile.TemporaryDirectory() as d:
            _rt_run(mini, steps=half, checkpoint_dir=d, checkpoint_every=5)
            tr, stream, out, _ = _rt_run(mini, steps=RUNTIME_STEPS - half,
                                         checkpoint_dir=d, resume=True)
            _bitwise(f"resume: steps {half + 1}-{RUNTIME_STEPS} after a "
                     f"{half}-step run", (out["losses"], _params(tr)),
                     (ref[0][half:], ref[1]))
            if stream.cursor != RUNTIME_STEPS:
                raise AssertionError(f"resume: the stream's cursor reads "
                                     f"{stream.cursor}")
            cpu, views, *_ = api.make_trainer(
                dataclasses.replace(mini, device="cpu"))
            cpu.restore(d)
            loss = cpu.fit(views, steps=1, prefetch=False)["losses"][0]
            err = abs(loss - ref[0][half]) / max(1.0, abs(ref[0][half]))
            print(f"    the card's step-{half} checkpoint on the CPU: step "
                  f"{half + 1} loss {loss:.6f}, card {ref[0][half]:.6f}, "
                  f"rel err {err:.3e} (tolerance {LOSS_TOL})")
            if not err <= LOSS_TOL:
                raise AssertionError(f"cross-device: {err:.3e}")

        clean, stream, *_ = api.make_trainer(mini)
        want = clean.fit(stream, steps=4, prefetch=False)["losses"]
        stream.seek(5)
        want += clean.fit(stream, steps=RUNTIME_STEPS - 5,
                          prefetch=False)["losses"]
        for action in ("skip_view", "rollback"):
            with tempfile.TemporaryDirectory() as d:
                tr, _, out, _ = _rt_run(
                    mini, policy=FaultPolicy(on_divergence=action, **FAST),
                    injector=FaultInjector({"diverge": {4}}),
                    checkpoint_dir=d, checkpoint_every=2)
            if (tr.step_num != RUNTIME_STEPS - 1
                    or not all(map(math.isfinite, out["losses"]))):
                raise AssertionError(f"{action}: ended at step "
                                     f"{tr.step_num}, losses {out['losses']}")
            _bitwise(f"{action}, diverge at view 4, ends at step "
                     f"{tr.step_num}, vs views 0-3 and 5-{RUNTIME_STEPS - 1}",
                     (out["losses"], _params(tr)), (want, _params(clean)))

        for strategy in ("mini", "cluster"):
            for mode, kw in (("inline", dict(prefetch=False)),
                             (f"thread x{workers}", {}),
                             (f"process x{workers}",
                              dict(prefetch_mode="process"))):
                before = _spans()
                tr, _, out, wall = _rt_run(job(strategy), **kw)
                t = _loop_s(before)
                # stage_s holds the first view's wait, and with it a
                # sampler pool's start (its samplers import torch);
                # other_s the fit's set-up and the pool's close
                row = {"config": config, "strategy": strategy,
                       "mode": mode, "steps": RUNTIME_STEPS,
                       "stage_s": t["stage_s"], "step_s": t["step_s"],
                       "other_s": wall - t["stage_s"] - t["step_s"],
                       "wall_s": wall, "steps_per_s": RUNTIME_STEPS / wall,
                       "cores": cores, "card": label}
                print("    runtime row " + json.dumps(row))
        if procpool._DEGRADE_WARNED:
            raise AssertionError("process mode degraded to threads")
        for k in kernels:
            if ops.launches[k] - before.get(k, 0) <= 0:
                raise AssertionError(f"{cfg.model}: no {k} launches")
    return dict(ops.launches)


# -- phase 14: CUDA graphs per bucket ----------------------------------------------


GRAPH_PAIRS = 5           # threads against inline, alternating pairs
DENSE_REL = 1e-3          # dense vs compact losses, * max(1, |loss|)


def _graph_cells():
    """(config, model swap, strategy, compact) of every training cell the
    phase holds replay against eager in: the three models under the three
    strategies (mini and cluster compact), and dense mini and cluster for
    GAT-E and GCN."""
    cells = [(config, model, strategy, True)
             for config, model in (("gnn_gat_e_alipay", None),
                                   ("gnn_gcn_reddit", None),
                                   ("gnn_gcn_reddit", "sage_max"))
             for strategy in ("global", "mini", "cluster")]
    cells += [(config, None, strategy, False)
              for config in ("gnn_gat_e_alipay", "gnn_gcn_reddit")
              for strategy in ("mini", "cluster")]
    return cells


def _timed_fit(trainer, views, steps: int, **fit_kw):
    """``reset()`` the trainer, move the stream to view 0 and fit
    ``steps`` steps with the device drained on both sides: the same
    trajectory as the trainer's first fit, over buckets it has seen.
    Returns (losses, wall seconds)."""
    import torch
    trainer.reset()
    views.seek(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.fit(views, steps=steps, **fit_kw)["losses"]
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def _graph_train(label: str) -> dict:
    """Replay against eager in every training cell: 30 steps each way,
    losses, final parameters and step-1 gradients bitwise equal, one
    capture per touched bucket; then steady steps/s, eager against
    replay in alternating order, and the busy share under replay. The
    dense cells also against the CPU and against the compact cell on the
    same stream indices. Returns the compact cells' replay losses."""
    import dataclasses
    import importlib
    import numpy as np
    from repro_torch import api
    from repro_torch.launch.serve_gnn import resolve_graph
    graphs, compact_losses = {}, {}
    for i, (config, model_name, strategy, compact) in enumerate(
            _graph_cells()):
        mod = importlib.import_module(f"repro_torch.configs.{config}")
        cfg, dataset = _config(config, model_name)
        if (dataset, cfg.model) not in graphs:
            graphs[(dataset, cfg.model)] = resolve_graph(dataset, cfg.model,
                                                         seed=0)
        g = graphs[(dataset, cfg.model)]
        t = mod.TRAIN[strategy]
        job = api.TrainJob(
            dataset=g, model=cfg.model, strategy=strategy,
            num_layers=cfg.num_layers, hidden=cfg.hidden_dim, lr=t.lr,
            weight_decay=t.weight_decay, seed=t.seed, compact=compact,
            halo_hops=t.cluster_halo_hops, eval_every=0, device=DEVICE)
        name = f"{cfg.model} {strategy}" + ("" if compact else " dense")
        order = (False, True) if i % 2 == 0 else (True, False)
        runs = {}
        for graphs_on in order:
            runs[graphs_on] = _fit_job(job, TRAIN_STEPS,
                                       cuda_graphs=graphs_on)
        (eager, ev, el, eg, ewall), (rep, rv, rl, rg, rwall) = (
            runs[False], runs[True])
        same = (el == rl and all(torch_equal(eg[k], rg[k]) for k in eg)
                and _params(eager).keys() == _params(rep).keys()
                and all(torch_equal(a, b) for a, b in zip(
                    _params(eager).values(), _params(rep).values())))
        if not np.isfinite(rl).all():
            raise AssertionError(f"{name}: bad losses {rl}")
        rep.assert_compiled_per_bucket()
        touched = {k: 1 for k in rep.buckets_touched}
        if rep.captures != touched:
            raise AssertionError(f"{name}: captures {rep.captures}, "
                                 f"buckets touched {sorted(touched)}")
        print(f"  [{label}] {name}: {TRAIN_STEPS} steps eager and under "
              f"replay: losses, step-1 gradients and final parameters "
              f"{'bitwise equal' if same else 'DIFFER'}; captures "
              f"{dict(rep.captures)} = one per touched bucket")
        if not same:
            raise AssertionError(f"{name}: replay differs from eager")
        # steady state: every bucket captured, the same views again
        wall = {}
        for graphs_on in order:
            tr, views = (rep, rv) if graphs_on else (eager, ev)
            losses, wall[graphs_on] = _timed_fit(tr, views, TRAIN_STEPS)
            if losses != rl:
                raise AssertionError(f"{name}: a refit after reset() "
                                     f"differs (graphs={graphs_on})")
        if rep.captures != touched:
            raise AssertionError(f"{name}: the refit captured again "
                                 f"({rep.captures})")
        rv.seek(0)
        busy = _profile(rep, rv, 1e3 * wall[True] / TRAIN_STEPS)
        row = {"cell": name, "config": config, "steps": TRAIN_STEPS,
               "buckets": len(touched),
               "steps_per_s_eager": TRAIN_STEPS / wall[False],
               "steps_per_s_replay": TRAIN_STEPS / wall[True],
               "first_fit_steps_per_s_eager": (TRAIN_STEPS - 1) / ewall,
               "first_fit_steps_per_s_replay": (TRAIN_STEPS - 1) / rwall,
               "busy_ms_per_step_replay": busy,
               "busy_share_replay": busy * TRAIN_STEPS / (1e3 * wall[True]),
               "order": "eager first" if not order[0] else "replay first",
               "card": label}
        print("    graphs row " + json.dumps(row))
        if compact:
            compact_losses[(config, model_name, strategy)] = rl
            continue
        # the dense view on the card against the CPU, and against the
        # compact view of the same stream index
        _, _, want, want_grads, _ = _fit_job(
            dataclasses.replace(job, device="cpu"), TRAIN_STEPS)
        g_err = max(float((rg[k] - want_grads[k]).abs().max())
                    / max(float(want_grads[k].abs().max()), 1e-30)
                    for k in want_grads)
        l_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(rl, want))
        ref = compact_losses[(config, model_name, strategy)]
        d_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(rl, ref))
        print(f"    dense card vs CPU: step-1 gradients max rel err "
              f"{g_err:.3e} (tolerance {GRAD_TOL}), losses max rel err "
              f"{l_err:.3e} (tolerance {LOSS_TOL}); dense vs compact on "
              f"the same views: losses max rel err {d_err:.3e} (tolerance "
              f"{DENSE_REL}); loss {rl[0]:.5f} -> {rl[-1]:.5f}")
        if g_err > GRAD_TOL or l_err > LOSS_TOL:
            raise AssertionError(f"{name}: card vs CPU {g_err:.3e} / "
                                 f"{l_err:.3e}")
        if d_err > DENSE_REL:
            raise AssertionError(f"{name}: dense vs compact {d_err:.3e}")
    return compact_losses


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def _graph_pairs(label: str) -> None:
    """Builder threads against inline staging under replay, in
    ``GRAPH_PAIRS`` alternating pairs on the GAT-E and GCN mini cells:
    one trainer per cell (its buckets captured once), every fit from
    ``reset()`` over the same views; every fit's losses bitwise equal."""
    import importlib
    from repro_torch import api
    from repro_torch.launch.serve_gnn import resolve_graph
    for config in ("gnn_gat_e_alipay", "gnn_gcn_reddit"):
        mod = importlib.import_module(f"repro_torch.configs.{config}")
        cfg, dataset = _config(config)
        t = mod.TRAIN["mini"]
        job = api.TrainJob(
            dataset=resolve_graph(dataset, cfg.model, seed=0),
            model=cfg.model, strategy="mini", num_layers=cfg.num_layers,
            hidden=cfg.hidden_dim, lr=t.lr, weight_decay=t.weight_decay,
            seed=t.seed, compact=True, eval_every=0, device=DEVICE)
        trainer, views, *_ = api.make_trainer(job)
        ref = trainer.fit(views, steps=TRAIN_STEPS)["losses"]  # captures
        rates = {"threads": [], "inline": []}
        for pair in range(GRAPH_PAIRS):
            modes = (("threads", {}), ("inline", dict(prefetch=False)))
            for mode, kw in (modes if pair % 2 == 0 else modes[::-1]):
                losses, wall = _timed_fit(trainer, views, TRAIN_STEPS, **kw)
                if losses != ref:
                    raise AssertionError(f"{cfg.model} mini, {mode}: "
                                         "losses differ")
                rates[mode].append(TRAIN_STEPS / wall)
        trainer.assert_compiled_per_bucket()
        med = {m: float(sorted(r)[len(r) // 2]) for m, r in rates.items()}
        row = {"cell": f"{cfg.model} mini", "pairs": GRAPH_PAIRS,
               "steps": TRAIN_STEPS, "threads_steps_per_s": rates["threads"],
               "inline_steps_per_s": rates["inline"], "median": med,
               "threads_over_inline": med["threads"] / med["inline"],
               "card": label}
        print(f"  [{label}] {cfg.model} mini under replay, {GRAPH_PAIRS} "
              f"alternating pairs, losses bitwise equal in all: builder "
              f"threads {med['threads']:.2f} steps/s, inline "
              f"{med['inline']:.2f} (medians)")
        print("    pairs row " + json.dumps(row))


def _graph_serve(label: str, requests: int = 512) -> None:
    """Served responses under replay bitwise equal to eager (the same
    fixed batches through ``submit``), a cache hit bitwise a recompute,
    one capture per bucket; then QPS and p50/p99 eager against replay
    over 4 clients, in alternating order, each server after an untimed
    pass of the trace (its buckets captured) with its cache aged out."""
    import numpy as np
    from repro_torch.launch.serve_gnn import (build_server, request_trace,
                                              resolve_graph, run_clients)
    from repro_torch.serving.server import ServeStats
    kw = dict(max_batch=16, max_wait_ms=2.0)
    for i, (config, model_name) in enumerate((
            ("gnn_gat_e_alipay", None), ("gnn_gcn_reddit", None),
            ("gnn_gcn_reddit", "sage_max"))):
        cfg, dataset = _config(config, model_name)
        model, hidden, layers = cfg.model, cfg.hidden_dim, cfg.num_layers
        g = resolve_graph(dataset, model, seed=0)
        trace = request_trace(g, requests, seed=0)
        out, srv = {}, {}
        for graphs_on in (False, True):
            srv[graphs_on] = build_server(g, model, layers, hidden, seed=0,
                                          device=DEVICE,
                                          cuda_graphs=graphs_on, **kw)
            out[graphs_on] = np.concatenate([
                srv[graphs_on].submit(trace[j:j + 16])
                for j in range(0, requests, 16)])
            srv[graphs_on].assert_compiled_per_bucket()
        same = bool(np.array_equal(out[False], out[True]))
        tr = srv[True].server_stats()["trace"]
        print(f"  [{label}] serve {model}: {requests} responses in batches "
              f"of 16, replay vs eager {'bitwise equal' if same else 'DIFFER'}"
              f"; captures full {sum(tr['full']['captures'].values())} over "
              f"{len(tr['full']['buckets'])} buckets, hit "
              f"{sum(tr['hit']['captures'].values())} over "
              f"{len(tr['hit']['buckets'])}")
        if not same:
            raise AssertionError(f"{model}: served replay differs from eager")
        # a cache hit against a full recompute, under replay
        rng = np.random.default_rng(1)
        indeg = np.bincount(g.dst, minlength=g.num_nodes)
        targets = np.union1d(rng.choice(g.num_nodes, 16, replace=False),
                             [int(indeg.argmax())])
        cached = build_server(g, model, layers, hidden, seed=0,
                              device=DEVICE, **kw)
        full = cached.submit(targets)
        hits0 = cached.cache.hits
        again = cached.submit(targets)
        if cached.cache.hits == hits0 or not np.array_equal(again, full):
            raise AssertionError(f"{model}: under replay a cache hit is not "
                                 "bitwise a full recompute")
        cached.assert_compiled_per_bucket()
        print(f"    cache hit vs full recompute under replay "
              f"({len(targets)} targets): bitwise equal")
        order = (False, True) if i % 2 == 0 else (True, False)
        for graphs_on in order:
            s = srv[graphs_on]
            s.start()
            try:
                run_clients(s, trace, 4)      # untimed: the last captures
                s.cache.advance()             # every entry stale again
                s.stats = ServeStats()
                before = _captures(s)
                _, wall = run_clients(s, trace, 4)
                late = _captures(s) - before
            finally:
                s.stop()
            s.assert_compiled_per_bucket()
            lat = s.server_stats()["latency_ms"]
            # a bucket first touched in the timed run is captured there
            row = {"model": model, "mode": "replay" if graphs_on else
                   "eager", "requests": requests, "qps": requests / wall,
                   "p50_ms": lat["p50"], "p99_ms": lat["p99"],
                   "captures_in_timed_run": late, "card": label}
            print("    serve row " + json.dumps(row))


def _captures(server) -> int:
    trace = server.server_stats()["trace"]
    return sum(sum(trace[p]["captures"].values()) for p in ("full", "hit"))


def graph_phase(label: str) -> dict:
    """Phase 14: CUDA graphs per bucket against eager, training and
    serving; returns the phase's launch counts."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    _graph_train(label)
    _graph_serve(label)
    _graph_pairs(label)
    return dict(ops.launches)


# -- phase 15: the distributed engine ---------------------------------------

ENGINE_P = 4                  # partitions, all on the one card (LocalComm)
ENGINE_STEPS = 30             # steps per strategy
ENGINE_TOL = 1e-4             # card vs CPU step 1; engine vs one block
ENGINE_TIMING_NODES = 200_000  # alipay_like nodes for the timing row
ENGINE_KERNELS = ("segment_sum", "segment_sum_bwd", "segment_max",
                  "segment_max_bwd")
# NN-G's planned gathers ("take") a process step, read from one eager
# step of each model at P=4 and P=1 alike: a layer gathers each of its
# transform's keys at both edge ends and broadcasts each to the mirrors
# through the halo's gather of master rows; GAT-E's sharded softmax adds
# the broadcast of the row max and its gather onto the edges. GAT-E: 2
# layers x (3 keys x 2 ends + 3 + 2) = 22; GCN and SAGE-max: 2 x (2 + 1)
ENGINE_TAKES = {"gat_e": 22, "gcn": 6, "sage_max": 6}
# the engine's chaos scenarios on the card: every injection point alone,
# the combined plan, a sampler process killed, and both divergence
# recoveries
ENGINE_CHAOS = ("view_build", "device_put", "step", "checkpoint_save",
                "worker_kill")


def _engine_job(config: str, strategy: str, g, model=None, P=ENGINE_P,
                device=DEVICE):
    """The config's job under ``strategy`` on the engine over ``P``
    partitions (``1d_src``), compact mini and cluster views, the config's
    global rate for every strategy (one optimizer runs them all)."""
    import importlib
    from repro_torch import api
    mod = importlib.import_module(f"repro_torch.configs.{config}")
    cfg, _ = _config(config, model)
    t, glob = mod.TRAIN[strategy], mod.TRAIN["global"]
    return api.TrainJob(
        dataset=g, model=cfg.model, strategy=strategy,
        num_layers=cfg.num_layers, hidden=cfg.hidden_dim, lr=glob.lr,
        weight_decay=glob.weight_decay, seed=glob.seed, compact=True,
        halo_hops=t.cluster_halo_hops, eval_every=0, device=device,
        engine_partitions=P)


def _engine_trainer(job, cuda_graphs: bool = True):
    """``api.make_trainer(job)``: the engine Trainer and the job's views;
    ``cuda_graphs=False`` rebuilds it around the same engine eager."""
    from repro_torch import api
    from repro_torch.core.trainer import Trainer
    trainer, views, *_ = api.make_trainer(job)
    if not cuda_graphs:
        trainer = Trainer(trainer.engine, trainer.opt, cuda_graphs=False)
    return trainer, views


def _engine_streams(job, strategies):
    """The job's view stream under each strategy (the facade's choices)."""
    import dataclasses
    from repro_torch import api
    return [api._build(dataclasses.replace(job, strategy=s))[3]
            for s in strategies]


@contextlib.contextmanager
def _no_plain_versions():
    """Count calls of the kernels' plain versions through the wrappers;
    the block fails if there is any."""
    from repro_torch.kernels import ops
    names = [n for n in dir(ops) if n.endswith("_ref")]
    calls = {}

    def wrap(name, fn):
        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return counted

    saved = {n: getattr(ops, n) for n in names}
    for n, fn in saved.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    if calls:
        raise AssertionError(f"the engine path called plain versions: "
                             f"{calls}")


def _exchange_counts(trainer, view) -> dict:
    """What crosses the exchange in one eager step over the staged
    ``view`` (forward and backward), counted on the engine's
    communicator: ``floats_per_value`` (each exchange's width, summed)
    and ``bytes_sent`` (the bytes this process sends other processes:
    each buffer moves whole but for its own block; 0 under
    ``LocalComm``)."""
    import torch
    comm = trainer.engine.comm
    world = getattr(comm, "world", 1)
    seen = {"floats_per_value": 0, "bytes_sent": 0.0}

    def count(buf):
        seen["floats_per_value"] += buf.shape[-1]
        seen["bytes_sent"] += (buf.numel() * buf.element_size()
                               * (world - 1) / world)

    class Count(torch.autograd.Function):
        @staticmethod
        def forward(ctx, buf):
            count(buf)
            return buf.view_as(buf)

        @staticmethod
        def backward(ctx, g):
            count(g)
            return g

    orig = comm.all_to_all
    comm.all_to_all = lambda buf: orig(Count.apply(buf))
    try:
        trainer.engine.make_loss_and_grad()(view)
    finally:
        del comm.all_to_all
    return seen


def _step1(engine, view) -> tuple:
    """(loss, gradients on the CPU) of the engine's first step over
    ``view``: nothing is updated."""
    from repro_torch.core.strategies import shard_view
    loss, grads = engine.make_loss_and_grad()(
        engine.stage_view(shard_view(engine.plan, view)))
    return float(loss), {k: v.detach().cpu().clone()
                         for k, v in grads.items()}


def _rel_grads(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def _engine_checks(name: str, job, g, view) -> None:
    """Step 1 of the card engine against the CPU engine (the kernels'
    plain versions), and its loss against one block's (the card
    CompactTrainer's) on the same view."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core.mpgnn import loss_block
    card, _ = _engine_trainer(job, cuda_graphs=False)
    cpu, _ = _engine_trainer(dataclasses.replace(job, device="cpu"),
                             cuda_graphs=False)
    loss, grads = _step1(card.engine, view)
    want, want_grads = _step1(cpu.engine, view)
    g_err = _rel_grads(grads, want_grads)
    l_err = abs(loss - want) / max(1.0, abs(want))
    block_tr, *_ = api.make_trainer(dataclasses.replace(
        job, engine_partitions=0, strategy="global"))
    with torch.no_grad():
        one = float(loss_block(block_tr.model, block_tr._prepare(view)))
    b_err = abs(loss - one) / max(1.0, abs(one))
    print(f"    {name}: card vs CPU step 1: loss rel err {l_err:.3e}, "
          f"gradients max rel err {g_err:.3e}; P={job.engine_partitions} "
          f"engine vs one block on the card: loss {loss:.6f} vs "
          f"{one:.6f}, rel err {b_err:.3e} (tolerance {ENGINE_TOL})")
    if max(g_err, l_err, b_err) > ENGINE_TOL:
        raise AssertionError(f"{name}: engine parity {g_err:.3e} / "
                             f"{l_err:.3e} / {b_err:.3e}")


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _fit_streams(trainer, streams, steps: int) -> tuple:
    """``steps`` steps over each stream in turn: (losses, wall seconds
    per stream with the device drained)."""
    losses, walls = [], []
    for st in streams:
        st.seek(0)
        _sync(trainer.device)
        t0 = time.perf_counter()
        losses += trainer.fit(st, steps=steps)["losses"]
        _sync(trainer.device)
        walls.append(time.perf_counter() - t0)
    return losses, walls


def _engine_fit(job, streams, cuda_graphs: bool):
    """A fresh engine Trainer fit ``ENGINE_STEPS`` steps over each stream
    in turn, with no restart. Returns (trainer, losses, final
    parameters, wall seconds per stream with the device drained)."""
    trainer, _ = _engine_trainer(job, cuda_graphs)
    losses, walls = _fit_streams(trainer, streams, ENGINE_STEPS)
    return trainer, losses, _params(trainer), walls


def _steady(trainer, streams) -> list:
    """Seconds of ``ENGINE_STEPS`` more steps over each stream, on a
    trainer whose step is already captured (or eager), device drained."""
    return _fit_streams(trainer, streams, ENGINE_STEPS)[1]


def _engine_run(name: str, job, g, strategies, label: str, kernels,
                repeat: bool = False) -> dict:
    """One phase-15 run: the card engine's checks, then a replay fit and
    an eager fit over the strategies' streams (bitwise equal, one
    capture, each of ``kernels`` launched), a second replay fit when
    ``repeat`` (bitwise equal), steady steps/s eager and under replay,
    the exchange volume, the busy share under replay and the launches by
    kernel. Returns the replay fit's launch counts."""
    import numpy as np
    from repro_torch.core.partition import build_partitions, partition_stats
    from repro_torch.core.strategies import shard_view
    from repro_torch.kernels import ops
    streams = _engine_streams(job, strategies)
    _engine_checks(name, job, g, streams[0].build(0))
    ops.reset_launches()
    with _no_plain_versions():
        rep, rl, rp, rwall = _engine_fit(job, streams, cuda_graphs=True)
    got = dict(ops.launches)
    rep.assert_compiled_once()
    if rep.trace_counts["train_step"] != 1:
        raise AssertionError(f"{name}: {rep.trace_counts} captures")
    missing = [k for k in kernels if got[k] <= 0]
    if missing or not np.isfinite(rl).all():
        raise AssertionError(f"{name}: kernels {missing} not launched, or "
                             f"bad losses {rl}")
    take0 = ops.launches["take"]
    eager, el, ep, ewall = _engine_fit(job, streams, cuda_graphs=False)
    _bitwise(f"{name}: replay vs eager over {'/'.join(strategies)}",
             (rl, rp), (el, ep))
    steps = ENGINE_STEPS * len(strategies)
    takes = {"replay": got["take"], "eager": ops.launches["take"] - take0}
    if any(n != ENGINE_TAKES[job.model] * steps for n in takes.values()):
        raise AssertionError(f"{name}: take launches {takes} in {steps} "
                             f"steps, expected {ENGINE_TAKES[job.model]} "
                             "a step")
    print(f"    {name}: one engine Trainer over {' -> '.join(strategies)}: "
          f"captures {rep.trace_counts} (the step captured once); loss "
          f"{rl[0]:.5f} -> {rl[-1]:.5f}")
    if repeat:
        _, l2, p2, _ = _engine_fit(job, streams, cuda_graphs=True)
        _bitwise(f"{name}: two card fits", (l2, p2), (rl, rp))
    t0 = time.perf_counter()
    sg = build_partitions(g, job.engine_partitions,
                          method=job.partition_method,
                          gcn_norm=job.model == "gcn")
    part_s = time.perf_counter() - t0
    stats = partition_stats(sg)
    view0 = streams[0].build(0)
    widths = _exchange_counts(eager, eager.engine.stage_view(
        shard_view(eager.plan, view0)))["floats_per_value"]
    per_step = {k: v / steps for k, v in got.items() if v}
    # steady state: the step captured, the same views again
    swall = {True: _steady(rep, streams), False: _steady(eager, streams)}
    streams[0].seek(0)
    busy = _profile(rep, streams[0], 1e3 * swall[True][0] / ENGINE_STEPS)
    row = {"run": name, "P": job.engine_partitions, "card": label,
           "shared_card": True, "network_time": "not measured",
           "strategies": list(strategies),
           "steps_per_s_eager": [ENGINE_STEPS / w for w in swall[False]],
           "steps_per_s_replay": [ENGINE_STEPS / w for w in swall[True]],
           "first_fit_steps_per_s_eager": [ENGINE_STEPS / w for w in ewall],
           "first_fit_steps_per_s_replay": [ENGINE_STEPS / w
                                            for w in rwall],
           "busy_ms_per_step_replay": busy,
           "busy_share_replay": busy * ENGINE_STEPS
           / (1e3 * swall[True][0]),
           "launches_per_step": per_step,
           "halo_values_per_sync": stats["halo_values_per_sync"],
           "floats_per_value_per_step": widths,
           "bytes_exchanged_per_step":
               4 * stats["halo_values_per_sync"] * widths,
           "replica_factor": stats["replica_factor"],
           "edge_balance": stats["edge_balance"],
           "build_partitions_s": part_s}
    print("    engine row " + json.dumps(row), flush=True)
    return got


def _engine_chaos(label: str) -> None:
    """The engine's chaos scenarios on the card, each bitwise its clean
    run and each re-certifying the one capture."""
    from repro_torch.runtime import chaos
    names = []
    for point in ENGINE_CHAOS:
        occ = {1} if point == "worker_kill" else {0, 2}
        names.append((f"{point}/engine", lambda p=point, o=occ:
                      chaos.run_scenario(f"{p}/engine", {p: o}, "engine",
                                         device=DEVICE)))
    names.append(("combined/engine", lambda: chaos.run_scenario(
        "combined/engine", chaos.SMOKE_PLAN, "engine", device=DEVICE)))
    names.append(("proc_kill/process/engine", lambda: chaos.run_scenario(
        "proc_kill/process/engine", {"proc_kill": {1}}, "engine",
        mode="process", device=DEVICE)))
    for action in ("skip_view", "rollback"):
        names.append((f"diverge/{action}/engine", lambda a=action:
                      chaos.run_divergence(f"diverge/{a}/engine", a,
                                           "engine", device=DEVICE)))
    failed = [n for n, run in names if not run()]
    print(f"    [{label}] engine chaos: {len(names) - len(failed)}/"
          f"{len(names)} scenarios bitwise equal to their clean runs")
    if failed:
        raise AssertionError(f"engine chaos scenarios failed: {failed}")


def _engine_max_pair(g, gen) -> dict:
    """``segment_max`` and ``segment_max_bwd`` at width 4 (GAT-E's
    logits, the softmax's max pass on the engine path) on shard 0's
    destination plan: exactly their plain versions, over ties and masked
    (NEG) entries; timed beside them with their bounds."""
    import torch
    from repro_torch.core.partition import build_partitions
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import NEG, segment_max_bwd_ref
    plan = build_partitions(g, ENGINE_P).plan.csc_plans()[0].to(DEVICE)
    E, N, D = plan.num_edges, plan.num_segments, 4
    data = torch.randint(0, 8, (E, D), generator=gen, device="cpu")
    data = data.float().to(DEVICE)
    masked = torch.rand((E, 1), generator=gen).to(DEVICE) < 0.1
    data = torch.where(masked, torch.full_like(data, NEG), data)
    rows = {"segment_max": _max_row(plan, data)}
    fwd = ops.segment_max_op(data, plan)
    cot = torch.randn((N, D), generator=gen).to(DEVICE)
    torch.testing.assert_close(
        ops.segment_max_bwd_op(cot, fwd, data, plan),
        segment_max_bwd_ref(cot, fwd, data, plan.edge_dst), rtol=0, atol=0)
    ms = _time_ms(lambda: ops.segment_max_bwd_op(cot, fwd, data, plan))
    plain = _time_ms(lambda: segment_max_bwd_ref(cot, fwd, data,
                                                 plan.edge_dst), 100.0)
    bound, by = _bound(4 * (2 * E * D + 2 * N * D) + 4 * E, 2 * E * D)
    rows["segment_max_bwd"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=None,
                                   shape=f"E={E} N={N} D={D}")
    for k, row in rows.items():
        _plan_row(k, f"alipay_like {g.num_nodes} nodes, shard 0 of "
                  f"{ENGINE_P}, width 4 (exact)", row)
    return rows


def _gather_rows(g) -> None:
    """Where the engine's device step goes: its gathers are
    ``index_select`` over the node axis (``core/aggregate.py:take``).
    Times it beside advanced indexing (the same rows, the same bits) at
    the 200k graph's edge count and the widths GAT-E gathers (1, 4, 32),
    with the bytes bound; one JSON ``gather row`` each. Diagnostic: the
    port calls ``index_select``."""
    import torch
    gen = torch.Generator().manual_seed(1)
    idx = torch.from_numpy(g.dst).to(DEVICE)
    for width in (1, 4, 32):
        shape = (g.num_nodes,) + ((width,) if width > 1 else ())
        v = torch.randn(shape, generator=gen).to(DEVICE)
        if not torch.equal(v.index_select(0, idx), v[idx]):
            raise AssertionError("index_select and v[idx] differ")
        sel = _time_ms(lambda: v.index_select(0, idx))
        adv = _time_ms(lambda: v[idx])
        bound, by = _bound(4 * (len(idx) * (width + 1) + v.numel()), 0)
        print("  gather row " + json.dumps({
            "rows": len(idx), "table_rows": g.num_nodes, "width": width,
            "index_select_ms": sel, "advanced_index_ms": adv,
            "bound_ms": bound, "bound_by": by}), flush=True)


def engine_phase(label: str) -> dict:
    """Phase 15: the distributed engine on the card (all ``ENGINE_P``
    partitions on the one card, so no network time is measured). Returns
    the launch counts of its main-path runs (the replayed fits)."""
    import torch
    from repro_torch.launch.serve_gnn import resolve_graph
    from repro_torch.graph import make_dataset
    gen = torch.Generator().manual_seed(0)
    counts = {k: 0 for k in KERNELS}

    def add(got):
        for k in counts:
            counts[k] += got.get(k, 0)

    ga = resolve_graph("alipay_like", "gat_e", seed=0)
    _engine_max_pair(ga, gen)
    print("  GAT-E (alipay_like, 20,000 nodes), P=4, global -> mini -> "
          "cluster in one Trainer:")
    add(_engine_run("gat_e", _engine_job("gnn_gat_e_alipay", "global", ga),
                    ga, ("global", "mini", "cluster"), label, ENGINE_KERNELS,
                    repeat=True))
    # GCN's Sum stage and gathers are sums; SAGE-max's Sum stage is the
    # max pair, its gathers' backward and its halo max's tie count sums
    for model, kernels in (("gcn", ("segment_sum", "segment_sum_bwd")),
                           ("sage_max", ("segment_max", "segment_max_bwd",
                                         "segment_sum"))):
        g = resolve_graph("reddit_like", model, seed=0)
        print(f"  {model} (reddit_like), P=4, global:")
        add(_engine_run(model, _engine_job("gnn_gcn_reddit", "global", g,
                                           model=model), g, ("global",),
                        label, kernels))
    _engine_chaos(label)
    gt = make_dataset("alipay_like", seed=0, num_nodes=ENGINE_TIMING_NODES)
    _gather_rows(gt)
    for P in (1, ENGINE_P):
        print(f"  timing: GAT-E global, alipay_like "
              f"{ENGINE_TIMING_NODES} nodes, P={P}:")
        add(_engine_run(f"gat_e {ENGINE_TIMING_NODES // 1000}k P={P}",
                        _engine_job("gnn_gat_e_alipay", "global", gt, P=P),
                        gt, ("global",), label, ENGINE_KERNELS))
    return counts


# -- phase 16: the examples --------------------------------------------------


EXAMPLE_STEPS = 100                # the quickstart's, the verify skill's
STRATEGY_STEPS = 120               # steps per strategy-comparison row
DISTRIBUTED_STEPS = 180            # 60 per strategy, P=8
EXAMPLE_LOSS_TOL = 1e-4            # card vs CPU quickstart losses
EXAMPLE_ACC_TOL = 0.01             # card vs CPU test accuracy


def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(label: str) -> dict:
    """Phase 16: the three examples' ``main`` on the card. Returns the
    launch counts of the card runs."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    counts = {k: 0 for k in KERNELS}

    def add():
        for k in counts:
            counts[k] += ops.launches[k]
        ops.reset_launches()

    ops.reset_launches()
    print(f"  quickstart: GCN on cora, {EXAMPLE_STEPS} Adam steps, on the "
          "card (then the facade) and on the CPU:")
    t0 = time.perf_counter()
    card = _example("quickstart_torch").main("csc", DEVICE, EXAMPLE_STEPS)
    card_s = time.perf_counter() - t0
    add()
    t0 = time.perf_counter()
    cpu = _example("quickstart_torch").main("csc", "cpu", EXAMPLE_STEPS,
                                            facade=False)
    cpu_s = time.perf_counter() - t0
    ops.reset_launches()
    diff = float(np.abs(np.subtract(card["losses"], cpu["losses"])).max())
    acc_diff = abs(card["test_acc"] - cpu["test_acc"])
    print(f"    quickstart card vs CPU: loss {card['losses'][0]:.4f} -> "
          f"{card['losses'][-1]:.4f} (CPU {cpu['losses'][0]:.4f} -> "
          f"{cpu['losses'][-1]:.4f}), max |dloss| {diff:.3e} over "
          f"{EXAMPLE_STEPS} steps (limit {EXAMPLE_LOSS_TOL}); test acc "
          f"{card['test_acc']:.4f} vs {cpu['test_acc']:.4f} (limit "
          f"{EXAMPLE_ACC_TOL}); facade test acc {card['facade_acc']:.4f}, "
          f"server captures {_captures(card['server'])}; "
          f"{card_s:.1f}s on the card with the facade, {cpu_s:.1f}s on "
          f"the CPU [{label}]")
    if (diff > EXAMPLE_LOSS_TOL or acc_diff > EXAMPLE_ACC_TOL
            or not np.isfinite(card["losses"]).all()):
        raise AssertionError(f"quickstart: card vs CPU losses {diff:.3e}, "
                             f"accuracy {acc_diff:.4f}")

    print(f"  strategy comparison: GCN on reddit_like (3,000 nodes), P=4, "
          f"{STRATEGY_STEPS} steps per row:")
    ex = _example("strategy_comparison_torch")
    out = ex.main(DEVICE, STRATEGY_STEPS)
    add()
    tr = out["trainer"]
    if not tr.graphs_on or tr.trace_counts["train_step"] != 1:
        raise AssertionError(f"strategy comparison: captures "
                             f"{tr.trace_counts}, expected one")
    first = out["rows"][0]
    again = ex.run(tr, out["graph"], out["clusters"], "global",
                   STRATEGY_STEPS)
    ops.reset_launches()
    _bitwise("strategy comparison: the global row run again",
             (again["losses"], again["params"]),
             (first["losses"], first["params"]))
    tr.assert_compiled_once()
    for r in out["rows"]:
        print("    strategy row " + json.dumps({
            k: r[k] for k in ("strategy", "acc", "ms_per_step",
                              "peak_active_nodes", "view_kb")}
            | {"final_loss": r["losses"][-1], "card": label}), flush=True)

    print(f"  distributed training: GAT-E on alipay_like (8,000 nodes), "
          f"P=8, {DISTRIBUTED_STEPS // 3} steps per strategy, twice:")
    ex = _example("distributed_training_torch")
    argv = ["--device", DEVICE, "--steps", str(DISTRIBUTED_STEPS)]
    a = ex.main(argv)
    add()
    b = ex.main(argv)
    ops.reset_launches()
    for run in (a, b):
        tr = run["trainer"]
        if not tr.graphs_on or tr.trace_counts["train_step"] != 1:
            raise AssertionError(f"distributed training: captures "
                                 f"{tr.trace_counts}, expected one")
    flat = [x for k in ("global", "mini", "cluster") for x in a["losses"][k]]
    _bitwise("distributed training: two fits at P=8",
             ([x for k in ("global", "mini", "cluster")
               for x in b["losses"][k]], b["params"]), (flat, a["params"]))
    return counts


# -- phase 21: expert parallelism ------------------------------------------


def _moe_as(model, moe_impl: str, mesh=None, capacity=None):
    """``model`` switched to ``moe_impl`` over ``mesh``, at capacity
    factor ``capacity`` when given: the same weights under another
    dispatch."""
    import dataclasses
    model.moe_impl, model.mesh = moe_impl, mesh
    if capacity is not None:
        model.cfg = model.cfg.replace(moe=dataclasses.replace(
            model.cfg.moe, capacity_factor=capacity))
    return model


def _ep_prefill(model, toks):
    """A prefill of ``toks`` (B, T): its last logits, float32 on the CPU,
    and the (token, expert) pairs (dropped, routed) over its MoE layers
    (EP only; (0, 0) under dense dispatch)."""
    from repro_torch.arch.moe import count_drops
    with count_drops() as log:
        logits, _, _ = model.prefill({"tokens": toks.to(model.device)},
                                     cache_len=toks.shape[1])
    return logits.float().cpu(), (sum(int(d) for d, _ in log),
                                  sum(int(r) for _, r in log))


def _mesh_name(shape) -> str:
    return "dense" if shape is None else f"EP {tuple(shape)}"


def _ep_parity() -> None:
    """Phase 21 (a): float32 at full width, depth 2, window cut to
    ``PARITY_WINDOW``."""
    import copy
    import torch
    from repro_torch.config import get_arch_config
    from repro_torch.launch.mesh import ExpertMesh
    cfg = get_arch_config("mixtral-8x7b")
    depth, B, T = EP_PARITY
    card = _f32_model(cfg.replace(dtype="float32", num_layers=depth,
                                  sliding_window=PARITY_WINDOW), 21,
                      rolling=True)
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(21))
    dense, _ = _ep_prefill(_moe_as(card, "dense"), toks)
    got, (dropped, routed) = _ep_prefill(
        _moe_as(card, "ep", ExpertMesh(1, 8), 8.0), toks)
    err = _rel(got, dense)
    print(f"  f32 depth {depth}, B {B}, T {T}: EP (1, 8) at capacity 8.0 "
          f"vs dense on the card, last logits max diff {err:.3e} of "
          f"max|logit| (limit {EP_TOL}); {dropped} of {routed} pairs "
          f"dropped")
    if dropped or not torch.isfinite(got).all() or err > EP_TOL:
        raise AssertionError(f"EP without drops vs dense: {err:.3e}, "
                             f"{dropped} dropped")
    t0 = time.perf_counter()
    cpu = copy.deepcopy(card).cpu()
    print(f"  copied to the CPU in {time.perf_counter() - t0:.1f}s")
    for shape in EP_MESHES:
        _moe_as(card, "ep", ExpertMesh(*shape), 1.25)
        _moe_as(cpu, "ep", ExpertMesh(*shape), 1.25)
        t0 = time.perf_counter()
        want, want_d = _ep_prefill(cpu, toks)
        cpu_s = time.perf_counter() - t0
        got, got_d = _ep_prefill(card, toks)
        again, _ = _ep_prefill(card, toks)
        err, gap = _rel(got, want), _rel(got, dense)
        same = torch.equal(got, again)
        print(f"  f32 EP {shape} at capacity 1.25, card vs CPU: last "
              f"logits max diff {err:.3e} of max|logit| (limit {LM_CPU}; "
              f"the CPU {cpu_s:.1f}s); pairs dropped {got_d[0]} of "
              f"{got_d[1]} on the card, {want_d[0]} of {want_d[1]} on the "
              f"CPU; {gap:.3e} of max|logit| from dense; two card "
              f"prefills {'bitwise equal' if same else 'DIFFER'}")
        if (err > LM_CPU or got_d != want_d
                or not torch.isfinite(got).all() or not same):
            raise AssertionError(f"EP {shape}: card vs CPU {err:.3e}, "
                                 f"drops {got_d} vs {want_d}, bitwise "
                                 f"{same}")
    # decode at (1, 1): 8 seeded steps after the prefill, card vs CPU
    seeded = torch.randint(0, cfg.vocab_size, (B, 8),
                           generator=torch.Generator().manual_seed(22))
    pads = torch.zeros(B, dtype=torch.long)
    for m in (card, cpu):
        _moe_as(m, "ep", ExpertMesh(1, 1), 1.25)
    want, _, _ = _lm_run(cpu, toks, pads, seeded)
    got, _, _ = _lm_run(card, toks, pads, seeded)
    err = _rel(got, want)
    print(f"  f32 EP (1, 1): prefill + 8 seeded decode steps, card vs "
          f"CPU: logits max diff {err:.3e} of max|logit| (limit {LM_CPU})")
    if not torch.isfinite(got).all() or err > LM_CPU:
        raise AssertionError(f"EP decode: card vs CPU {err:.3e}")
    del card, cpu
    _free()


def _ep_gradients() -> None:
    """Phase 21 (b): the reduced config's loss and gradients with EP over
    (1, 4) at capacity 8.0, against dense on the card and against the
    CPU."""
    import copy
    import dataclasses
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    from repro_torch.launch.mesh import ExpertMesh
    red = get_arch_config("mixtral-8x7b").reduced()
    red = red.replace(dtype="float32", moe=dataclasses.replace(
        red.moe, capacity_factor=8.0))
    model = build_model(red, torch.Generator(device=DEVICE).manual_seed(5),
                        moe_impl="ep", mesh=ExpertMesh(1, 4))
    gen = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, red.vocab_size, (2, 64), generator=gen)
             for k in ("tokens", "labels")}

    def run(m):
        m.zero_grad()
        loss = m.loss({k: v.to(m.device) for k, v in batch.items()},
                      chunk=64)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().cpu()
                                      for n, p in m.named_parameters()}

    loss, grads = run(model)
    cpu_loss, cpu_grads = run(_moe_as(copy.deepcopy(model).cpu(), "ep",
                                      ExpertMesh(1, 4)))
    dense_loss, dense_grads = run(_moe_as(model, "dense"))
    e_cpu, e_dense = _rel_grads(grads, cpu_grads), _rel_grads(grads,
                                                             dense_grads)
    print(f"  f32 reduced {red.name} ({red.num_layers} layers, d "
          f"{red.d_model}, {red.moe.num_experts} experts), loss with EP "
          f"(1, 4) at capacity 8.0: {loss:.6f}; dense {dense_loss:.6f}, "
          f"the CPU's EP {cpu_loss:.6f}; gradients max diff {e_dense:.3e} "
          f"(vs dense) and {e_cpu:.3e} (vs the CPU) of each max (limit "
          f"{GRAD_TOL})")
    lim = LOSS_TOL * max(1.0, abs(loss))
    if (abs(loss - dense_loss) > lim or abs(loss - cpu_loss) > lim
            or max(e_cpu, e_dense) > GRAD_TOL):
        raise AssertionError("EP gradients differ")
    del model
    _free()


def _profile_prefill(model, toks) -> dict:
    """Device ms by op over one prefill of ``toks`` (a ``torch.profiler``
    trace): the busy total, the matrix products' (kernel names holding
    ``gemm`` or cuBLAS's ``nvjet``) and the six largest ops, printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": toks}, cache_len=toks.shape[1])
        torch.cuda.synchronize()
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in ops)
    gemm = sum(k[0] for k in ops
               if "gemm" in k[2].lower() or "nvjet" in k[2])
    print(f"    profile, one prefill: device busy {busy:.3f} ms in "
          f"{sum(k[1] for k in ops):.0f} device ops, matrix products "
          f"{gemm:.3f} ms; largest:")
    for ms, n, key in ops[:6]:
        print(f"      {ms:.4f} ms over {n:.0f} calls  {key[:90]}")
    return {"device_busy_ms": busy, "gemm_ms": gemm}


def _ep_row(label: str, run: str, shape, ms: float, tokens: int,
            dropped, flash: float, **extra) -> dict:
    import torch
    row = {"phase": 21, "run": run, "mesh": shape and list(shape),
           "ms": ms, "tokens_per_s": 1e3 * tokens / ms,
           "dropped_share": (dropped[0] / dropped[1] if dropped[1]
                             else 0.0),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "flash_attention_launches": flash, "card": label, **extra}
    print("  ep row " + json.dumps(row), flush=True)
    return row


def _ep_speed(label: str) -> dict:
    """Phase 21 (c): bf16 at full width, depth ``EP_LAYERS``: the timed
    prefill under dense and EP, and eager decode under dense and EP (1,
    1); returns the EP prefills' launch counts."""
    import torch
    from repro_torch.arch import build_model
    from repro_torch.arch.moe import count_drops
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ExpertMesh
    cfg = get_arch_config("mixtral-8x7b").replace(num_layers=EP_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        rolling_window_decode=True).requires_grad_(False)
    torch.cuda.synchronize()
    w_bytes = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if n != "embed.table")
    print(f"  bf16 {cfg.name}: {EP_LAYERS} of 32 layers, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, made "
          f"in {time.perf_counter() - t0:.1f}s")
    B, T = EP_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(23)
                         ).to(DEVICE)
    got = {k: 0 for k in ops.launches}
    for shape in (None,) + EP_MESHES:
        _moe_as(model, "dense" if shape is None else "ep",
                shape and ExpertMesh(*shape))
        logits, dropped = _ep_prefill(model, toks)      # warm-up
        if not torch.isfinite(logits).all():
            raise AssertionError(f"bf16 {_mesh_name(shape)}: logits not "
                                 "finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(EP_REPS):
            model.prefill({"tokens": toks}, cache_len=T)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / EP_REPS
        if shape is not None:
            for k, v in ops.launches.items():
                got[k] += v
        flash = ops.launches["flash_attention"] / EP_REPS
        prof = _profile_prefill(model, toks)
        _ep_row(label, f"prefill {_mesh_name(shape)}", shape, ms, B * T,
                dropped, flash, B=B, T=T, **prof)
        if flash != EP_LAYERS:
            raise AssertionError(f"{flash} flash_attention launches a "
                                 f"prefill, expected {EP_LAYERS}")
    B, T, steps = EP_DECODE
    dt = torch.randint(0, cfg.vocab_size, (B, T + steps),
                       generator=torch.Generator().manual_seed(24)
                       ).to(DEVICE)
    for shape in (None, (1, 1)):
        _moe_as(model, "dense" if shape is None else "ep",
                shape and ExpertMesh(*shape))
        for timed in (False, True):
            _, caches, idx = model.prefill({"tokens": dt[:, :T]},
                                           cache_len=T + steps)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with (contextlib.nullcontext([]) if timed
                  else count_drops()) as log:
                for t in range(T, T + steps):
                    lo, caches, idx = model.decode_step(
                        {"tokens": dt[:, t:t + 1]}, caches, idx)
                torch.cuda.synchronize()
            if not timed:
                dropped = (sum(int(d) for d, _ in log),
                           sum(int(r) for _, r in log))
        ms = 1e3 * (time.perf_counter() - t0) / steps
        if not torch.isfinite(lo).all():
            raise AssertionError(f"bf16 decode {_mesh_name(shape)}: logits "
                                 "not finite")
        _ep_row(label, f"decode {_mesh_name(shape)}", shape, ms, B,
                dropped, 0, B=B, prompt=T, steps=steps,
                weight_read_bound_ms=1e3 * w_bytes / HBM_BYTES_PER_S)
    del model
    _free()
    return got


def ep_phase(label: str) -> dict:
    """Phase 21: Mixtral 8x7B's MoE layers under expert parallelism;
    returns the bf16 EP prefills' launch counts."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _ep_parity()
    print(f"  float32 parity: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    _ep_gradients()
    print(f"  gradients: {time.perf_counter() - t0:.1f}s", flush=True)
    got = _ep_speed(label)
    print(f"  phase 21: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return got


# -- phase 20: analysis on the card -------------------------------------------


def analysis_phase(label: str) -> None:
    """Phase 20: ``repro_torch.analysis`` over the full matrix on the
    card; raises on any error finding, on a ``__global__`` function of the
    sources whose resources it did not read, and on one of the eight
    kernels that no recorded step launched through CUDA. The kernel calls the
    analysis makes are not counted in the kernels' record."""
    import re
    from repro_torch.analysis.cli import analyze
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    ops.reset_launches()
    report = analyze(full=True, device="cuda",
                     out=lambda line: print(line, flush=True))
    ops.reset_launches()
    seconds = time.perf_counter() - t0
    for f in report.findings:
        print(f"  {f.render()}")
    names = {m for src in build.CSRC.glob("*.cu") for m in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^()]*\)\s*)?(\w+)",
        src.read_text())}
    read = {k["kernel"] for k in report.kernels}
    routed = {c["kernel"] for c in report.launches if c["route"] == "cuda"}
    row = {"card": label, "seconds": round(seconds, 1),
           "contexts": report.contexts,
           "errors": len(report.errors),
           "warnings": len(report.findings) - len(report.errors),
           "findings": [f.to_json() for f in report.findings],
           "kernels_launched": sorted(routed),
           "kernels": [{k: v for k, v in s.items() if k != "function"}
                       for s in report.kernels]}
    print("analysis row " + json.dumps(row), flush=True)
    print(f"  analysis: {report.contexts} contexts, {len(report.kernels)} "
          f"compiled kernels of {len(names)} __global__ functions, "
          f"{len(report.errors)} errors, {row['warnings']} warnings in "
          f"{seconds:.1f}s")
    if report.errors:
        raise AssertionError(f"analysis: {len(report.errors)} error "
                             "findings on the card")
    if names - read:
        raise AssertionError(f"analysis: no resources read for "
                             f"{sorted(names - read)}")
    missing = set(KERNELS) - routed
    if missing:
        raise AssertionError(f"analysis: no recorded step launched "
                             f"{sorted(missing)} through CUDA")


def lm_phases(phase) -> list:
    """Phases 12, 13, 17, 18 and 19; returns each serving (and training)
    run's launch counts."""
    import numpy as np
    rng = np.random.default_rng(0)
    lo, hi = LM_PROMPTS
    phase("12. serve Qwen3-4B (full width, 36 layers)")
    got = [serve_lm("qwen3-4b", "flash_attention", (512, 301, 77, 160),
                    [int(n) for n in rng.integers(lo, hi + 1,
                                                  LM_REQUESTS)],
                    decode_tokens=DECODE_CHECK_TOKENS)]
    phase("13. serve RWKV-6 1.6B (full width, 24 layers)")
    # whole chunks of 128, so every padded batch length is one too
    got.append(serve_lm("rwkv6-1.6b", "wkv6", (512, 384, 128, 256),
                        [int(n) for n in rng.choice(
                            np.arange(lo, hi + 1, 128), LM_REQUESTS)],
                        decode_tokens=DECODE_CHECK_TOKENS))
    phase(f"17. serve Mixtral 8x7B (full width, {MIXTRAL_LAYERS} of 32 "
          "layers) and Qwen3-32B (full width, 64 layers)")
    got += large_lm_phase()
    phase(f"18. serve Jamba-1.5-Large (full width, one group of "
          f"{JAMBA_LAYERS} layers, {JAMBA_EXPERTS} of 16 experts) and "
          "MiniCPM3-4B (full width, 62 layers)")
    got += hybrid_lm_phase()
    phase("19. serve Whisper-base (6 + 6 layers) and Qwen2-VL-2B (28 "
          "layers) at full width; train the LM zoo on the card")
    return got + encdec_lm_phase()


def large_lm_phase() -> list:
    """Phase 17: the serving example, then Mixtral 8x7B (16 of 32 layers)
    and Qwen3-32B (64 layers) at full width; returns each serving run's
    launch counts."""
    import numpy as np
    _serve_lm_example()
    mlo, mhi = MIXTRAL_PROMPTS
    lo, hi = LM_PROMPTS
    got = [serve_lm(
        "mixtral-8x7b", "flash_attention", PARITY_PROMPTS,
        [int(n) for n in np.random.default_rng(17).integers(
            mlo, mhi + 1, MIXTRAL_REQUESTS)],
        parity_layers=4, parity_window=PARITY_WINDOW,
        serve_layers=MIXTRAL_LAYERS, rolling=True,
        decode_tokens=DECODE_CHECK_TOKENS)]
    got.append(serve_lm(
        "qwen3-32b", "flash_attention", PARITY_PROMPTS,
        [int(n) for n in np.random.default_rng(32).integers(
            lo, hi + 1, QWEN32_REQUESTS)],
        parity_layers=8, decode_tokens=DECODE_CHECK_TOKENS))
    return got


def _span(batch: dict, lo: int, hi: int) -> dict:
    """Positions lo..hi-1 of a batch's sequence inputs (tokens, embeds,
    the M-RoPE streams); the encoder memory whole."""
    out = dict(batch)
    for k in ("tokens", "embeds"):
        if k in batch:
            out[k] = batch[k][:, lo:hi]
    if "mrope_positions" in batch:
        out["mrope_positions"] = batch["mrope_positions"][:, :, lo:hi]
    return out


def _check_contract(model, S: int, label: str, B: int = 2,
                    extra=None) -> None:
    """The reference's cache contract (``tests/test_arch_consistency.py:36``)
    on the card: prefill(S) against prefill(S/2) plus S/2 decode steps of
    the same seeded tokens, no pad; the last logits within
    ``CONTRACT_TOL`` of max|logit|. ``extra(model, toks)`` makes the full
    batch of an encoder or VLM model: every decode step then reads the
    encoder memory made once, or its own embeddings and streams."""
    import torch
    t0 = time.perf_counter()
    toks = torch.randint(0, model.cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(5)
                         ).to(model.device)
    batch = {"tokens": toks} if extra is None else extra(model, toks)
    full, _, _ = model.prefill(batch, cache_len=S)
    lo, caches, idx = model.prefill(_span(batch, 0, S // 2), cache_len=S)
    for t in range(S // 2, S):
        lo, caches, idx = model.decode_step(_span(batch, t, t + 1), caches,
                                            idx)
    err = _rel(lo.float().cpu(), full.float().cpu())
    print(f"  f32 {label}, the reference's contract on the card: "
          f"prefill({S}) vs prefill({S // 2}) + {S // 2} decode steps, "
          f"last logits max diff {err:.3e} of max|logit| (limit "
          f"{CONTRACT_TOL}; {time.perf_counter() - t0:.1f}s)")
    if not err <= CONTRACT_TOL:
        raise AssertionError(f"{model.cfg.name}: the cache contract "
                             f"parts by {err:.3e}")


def _mamba_mixer_card_vs_cpu(cfg, B: int = 2, T: int = 256,
                             steps: int = 8) -> None:
    """The Mamba mixer alone at ``cfg``'s full width, float32, weights
    drawn on the card and copied to the CPU: a prefill of T seeded tokens
    into a zero cache (output, final state, conv tail), then ``steps``
    decode steps (outputs and states), card against CPU within
    ``LM_CPU`` of each tensor's max."""
    import torch
    from repro_torch.arch.mamba import (mamba_apply, mamba_init,
                                        mamba_init_cache)
    mc, D = cfg.mamba, cfg.d_model
    p = mamba_init(torch.Generator(device=DEVICE).manual_seed(3), D, mc,
                   torch.float32)
    x = torch.randn((B, T + steps, D),
                    generator=torch.Generator().manual_seed(4))
    runs, secs = {}, {}
    for dev in ("cpu", DEVICE):
        t0 = time.perf_counter()
        pd = {k: v.to(dev) for k, v in p.items()}
        cache = mamba_init_cache(B, mc, D, torch.float32, dev)
        out, cache = mamba_apply(pd, x[:, :T].to(dev), mc, cache=cache)
        got = [out, cache["state"], cache["conv"]]
        for t in range(T, T + steps):
            out, cache = mamba_apply(pd, x[:, t:t + 1].to(dev), mc,
                                     cache=cache)
            got += [out, cache["state"]]
        runs[dev] = [g.float().cpu() for g in got]
        secs[dev] = time.perf_counter() - t0
    errs = [_rel(a, b) for a, b in zip(runs[DEVICE], runs["cpu"])]
    d_in = mc.expand * D
    print(f"  f32 Mamba mixer at full width (d {D}, d_in {d_in}, "
          f"{d_in // mc.head_dim} heads of {mc.head_dim}, d_state "
          f"{mc.d_state}, chunk {mc.chunk}), B {B}, T {T} + {steps} "
          f"decode steps, card vs CPU: output {errs[0]:.3e}, final state "
          f"{errs[1]:.3e}, conv tail {errs[2]:.3e}, decode max "
          f"{max(errs[3:]):.3e} of each max (limit {LM_CPU}; the CPU "
          f"{secs['cpu']:.1f}s)")
    if not all(torch.isfinite(g).all() for g in runs[DEVICE]) or \
            max(errs) > LM_CPU:
        raise AssertionError(f"the Mamba mixer: card vs CPU {max(errs)}")


def hybrid_lm_phase() -> list:
    """Phase 18: Jamba-1.5-Large (one hybrid group, 8 experts) and
    MiniCPM3-4B (full depth) at full width; returns each serving run's
    launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    got = []

    # -- Jamba: float32 gates on one group with 2 experts
    arch = "jamba-1.5-large-398b"
    cfg = get_arch_config(arch)
    toks, pads = _lm_batch(cfg, JAMBA_PARITY_PROMPTS)
    seeded = torch.randint(0, cfg.vocab_size, (len(toks), 8),
                           generator=torch.Generator().manual_seed(1))
    f32 = cfg.replace(dtype="float32", num_layers=JAMBA_LAYERS,
                      moe=dataclasses.replace(
                          cfg.moe, num_experts=JAMBA_PARITY_EXPERTS))
    label = (f"one group of {JAMBA_LAYERS} layers, "
             f"{JAMBA_PARITY_EXPERTS} experts")
    model = _f32_model(f32, 0)
    _f32_kernel_vs_plain(model, "flash_attention", toks, pads, seeded,
                         label)
    _check_contract(model, 2 * cfg.mamba.chunk, label)
    del model
    _free()
    _mamba_mixer_card_vs_cpu(cfg)
    # the reduced model (2 layers: attention, then Mamba with MoE)
    red = cfg.reduced().replace(dtype="float32")
    r_toks, r_pads = _lm_batch(red, (32, 19, 5), seed=3)
    r_seeded = torch.randint(0, red.vocab_size, (len(r_toks), 8),
                             generator=torch.Generator().manual_seed(1))
    card = build_model(red, torch.Generator(device=DEVICE).manual_seed(2)
                       ).requires_grad_(False)
    _card_vs_cpu(card, r_toks, r_pads, r_seeded,
                 f"reduced ({red.num_layers} layers, d {red.d_model})",
                 "flash_attention")
    del card
    lengths = [int(n) for n in np.random.default_rng(18).choice(
        np.arange(LM_PROMPTS[0], LM_PROMPTS[1] + 1, cfg.mamba.chunk),
        JAMBA_REQUESTS)]
    served = cfg.replace(num_layers=JAMBA_LAYERS, moe=dataclasses.replace(
        cfg.moe, num_experts=JAMBA_EXPERTS))
    got.append(_bf16_serving(served, "flash_attention", toks, pads, seeded,
                             lengths, LM_NEW_TOKENS,
                             decode_tokens=DECODE_CHECK_TOKENS))

    # -- MiniCPM3-4B: no kernel on its path
    arch = "minicpm3-4b"
    cfg = get_arch_config(arch)
    toks, pads = _lm_batch(cfg, PARITY_PROMPTS)
    seeded = torch.randint(0, cfg.vocab_size, (len(toks), 8),
                           generator=torch.Generator().manual_seed(1))
    f32 = cfg.replace(dtype="float32")
    card = build_model(f32.replace(num_layers=2),
                       torch.Generator(device=DEVICE).manual_seed(1)
                       ).requires_grad_(False)
    _card_vs_cpu(card, toks, pads, seeded, "depth 2")
    del card
    model = _f32_model(f32, 0)
    _check_contract(model, 128, "full depth")
    del model
    _free()
    lo, hi = LM_PROMPTS
    lengths = [int(n) for n in np.random.default_rng(3).integers(
        lo, hi + 1, MINICPM_REQUESTS)]
    got.append(_bf16_serving(cfg, None, toks, pads, seeded, lengths,
                             LM_NEW_TOKENS,
                             decode_tokens=DECODE_CHECK_TOKENS))
    return got


# -- phase 19: Whisper-base, Qwen2-VL-2B, LM training ----------------------------


class EncDecInputs:
    """Phase 19's inputs beyond tokens, for one left-padded batch of B
    rows, kept on the CPU in float32: Whisper's frames (B, 1,500, D), one
    set a row; Qwen2-VL's image block a row (``VL_GRID`` x ``VL_GRID``
    patches of seeded normal embeddings, scaled as the embedding table,
    at ``offsets[b]`` among the row's real tokens). Qwen2-VL's three
    M-RoPE streams follow the published rule: text at t = h = w; a patch
    at t = s, h = s + row, w = s + col; the text after the image resumes
    at s + ``VL_GRID``; a row's left pads shift all three, and a decode
    step's token takes the last position + 1 on all three."""

    def __init__(self, cfg, frames=None, patches=None, offsets=None):
        self.cfg = cfg
        self.frames, self.patches, self.offsets = frames, patches, offsets

    @classmethod
    def seeded(cls, cfg, lengths, seed):
        """Rows for prompts of ``lengths`` from ``seed``; an image leaves
        at least one text token after it."""
        import numpy as np
        import torch
        rng = np.random.default_rng(seed)
        B, D = len(lengths), cfg.d_model
        if cfg.encoder_layers:
            return cls(cfg, frames=torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder_seq, D), dtype=np.float32)))
        n_img = VL_GRID * VL_GRID
        offsets = [int(rng.integers(0, n - n_img)) for n in lengths]
        patches = torch.from_numpy(rng.standard_normal(
            (B, n_img, D), dtype=np.float32) * np.float32(0.02))
        return cls(cfg, patches=patches, offsets=offsets)

    @classmethod
    def stack(cls, rows: list):
        """One batch's inputs from single-row ones."""
        import torch
        first = rows[0]
        if first.frames is not None:
            return cls(first.cfg, frames=torch.cat([r.frames for r in rows]))
        return cls(first.cfg, patches=torch.cat([r.patches for r in rows]),
                   offsets=[o for r in rows for o in r.offsets])

    def streams(self, pads, P: int):
        """(3, B, P) int32 positions, the (B, P) patch mask and each row's
        next position (the last + 1)."""
        import numpy as np
        g, B = VL_GRID, len(self.offsets)
        pos = np.zeros((3, B, P), np.int64)
        patch = np.zeros((B, P), bool)
        nxt = np.zeros(B, np.int64)
        j = np.arange(g * g)
        for b in range(B):
            pad, s = int(pads[b]), self.offsets[b]
            row = np.empty((3, P - pad), np.int64)
            row[:, :s] = np.arange(s)
            row[:, s:s + g * g] = np.stack([s + 0 * j, s + j // g,
                                            s + j % g])
            row[:, s + g * g:] = s + g + np.arange(P - pad - s - g * g)
            pos[:, b, pad:] = row
            patch[b, pad + s:pad + s + g * g] = True
            nxt[b] = row[0, -1] + 1
        return pos.astype(np.int32), patch, nxt

    def prefill_batch(self, model, batch: dict) -> dict:
        """``batch`` (tokens, and for a left-padded one valid and
        positions, on the model's device) with Whisper's ``enc_memory``
        (the encoder run once, through the kernel) or Qwen2-VL's
        ``embeds`` (the table's rows, the image's patches in place) and
        ``mrope_positions``."""
        import torch
        dev = model.device
        out = dict(batch)
        if self.frames is not None:
            out["enc_memory"] = model.encode(self.frames.to(dev))
            return out
        toks = batch["tokens"]
        B, P = toks.shape
        pads = ((~batch["valid"]).sum(1).cpu() if "valid" in batch
                else torch.zeros(B, dtype=torch.long))
        pos, patch, nxt = self.streams(pads.tolist(), P)
        with torch.no_grad():
            emb = model.embed["table"][toks].clone()
            emb[torch.from_numpy(patch).to(dev)] = self.patches.reshape(
                -1, self.cfg.d_model).to(dev, emb.dtype)
        out["embeds"] = emb
        out["mrope_positions"] = torch.from_numpy(pos).to(dev)
        out["vl_next"] = torch.from_numpy(nxt).to(dev)
        return out

    def step_inputs(self, model, pbatch: dict, tok, i: int) -> dict:
        """Decode step ``i``'s inputs for tokens ``tok`` (B, 1) on the
        device: the carried encoder memory, or the token's row of the
        table and its position on all three streams."""
        import torch
        if self.frames is not None:
            return {"enc_memory": pbatch["enc_memory"]}
        with torch.no_grad():
            emb = model.embed["table"][tok]
        pos = (pbatch["vl_next"] + i).to(torch.int32)
        return {"embeds": emb,
                "mrope_positions": pos.reshape(1, -1, 1).expand(3, -1, 1)}


def _contract_inputs(cfg, seed: int):
    """``_check_contract``'s ``extra``: the full batch of unpadded prompts
    with their frames or their image."""
    def make(model, toks):
        rows = EncDecInputs.seeded(cfg, [toks.shape[1]] * toks.shape[0],
                                   seed)
        return rows.prefill_batch(model, {"tokens": toks})
    return make


def _left_pad(prompts):
    import numpy as np
    import torch
    P = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), P), np.int64)
    for i, p in enumerate(prompts):
        toks[i, P - len(p):] = p
    return (torch.from_numpy(toks),
            torch.tensor([P - len(p) for p in prompts]))


def _encdec_batch(model, graph, toks, pads, inp, cache_len: int,
                  new_tokens: int, times: dict, logits_out=None) -> list:
    """Serve one left-padded batch: the encoder (Whisper) and the prefill,
    then ``new_tokens - 1`` decode rounds through ``graph`` (a
    :class:`~repro_torch.launch.serve.DecodeGraph`: captured once, then
    replayed) or, when it is None, eager ``decode_step``; each round's
    tokens read on the host, as ``BatchServer`` reads them. Adds the
    encoder's, the prefill's (the encoder in it) and the decode's seconds
    to ``times``; returns the tokens of every round."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = inp.prefill_batch(model, _padded_batch(toks, pads, DEVICE))
    if "enc_memory" in batch:
        torch.cuda.synchronize()
        times["encoder_s"] += time.perf_counter() - t0
    logits, caches, idx = model.prefill(batch, cache_len=cache_len)
    cur = torch.argmax(logits[:, -1], -1)
    outs = [cur.tolist()]
    times["prefill_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    pads_dev = pads.to(DEVICE)
    if graph is not None:
        graph.start(caches, batch["valid"], batch.get("enc_memory"))
        del caches
    for r in range(new_tokens - 1):
        pos = (idx - pads_dev)[:, None].to(torch.int32)
        ex = inp.step_inputs(model, batch, cur[:, None], r)
        if graph is not None:
            logits, cur = graph(cur[:, None], pos, idx,
                                embeds=ex.get("embeds"),
                                mrope_positions=ex.get("mrope_positions"))
            idx += 1
        else:
            logits, caches, idx = model.decode_step(
                {"tokens": cur[:, None], "valid": batch["valid"],
                 "positions": pos, **ex}, caches, idx)
            cur = torch.argmax(logits[:, -1], -1)
        if logits_out is not None:
            logits_out.append(logits.float().cpu())
        outs.append(cur.tolist())
    times["decode_s"] += time.perf_counter() - t0
    return outs


def _encdec_serving(scfg, toks, pads, extra, serve_lengths,
                    new_tokens: int) -> dict:
    """Phase 19's bf16 serving run of Whisper-base or Qwen2-VL-2B at full
    width and depth: seeded requests (token prompts of ``serve_lengths``
    with their own frames or image) in batches of ``LM_BATCH``, the
    decode rounds replayed from one capture; a warm-up batch, then the
    timed run; tokens/s, a round's ms against the weight-read bound, the
    encoder's share of a prefill batch, peak memory, ``flash_attention``
    launched once per attention layer (and encoder layer) per batch; the
    first batch decoded eagerly bitwise equal to the replay, one
    capture; two bf16 prefills of the parity batch bitwise equal and its
    every kernel call held element by element (:func:`_bf16_layers`).
    Returns the timed run's launch counts."""
    import numpy as np
    import torch
    from repro_torch.arch import build_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import DecodeGraph
    B, arch = LM_BATCH, scfg.name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(scfg, torch.Generator(device=DEVICE).manual_seed(0)
                        ).requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # a decode round reads the decoder's weights once (not the encoder's;
    # of an untied input embedding only the batch's rows; a tied table
    # once, as the head)
    w_bytes = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters()
                  if not n.startswith(("encoder.", "enc_norm."))
                  and (scfg.tie_embeddings or n != "embed.table"))
    cache_len = max(serve_lengths) + new_tokens
    print(f"  bf16 {arch}: {scfg.num_layers} layers"
          + (f" + {scfg.encoder_layers} encoder layers over "
             f"{scfg.encoder_seq} frames" if scfg.encoder_layers else "")
          + f", d {scfg.d_model}, {n_params / 1e9:.3f} B parameters "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), made "
          f"in {time.perf_counter() - t0:.1f}s; cache {cache_len} slots a row")
    rng = np.random.default_rng(19)
    reqs = [(rng.integers(0, scfg.vocab_size, n).astype(np.int64),
             EncDecInputs.seeded(scfg, [n], seed=1000 + i))
            for i, n in enumerate(serve_lengths)]
    batches = [reqs[i:i + B] for i in range(0, len(reqs), B)]

    def inputs(batch):
        toks_b, pads_b = _left_pad([p for p, _ in batch])
        return toks_b, pads_b, EncDecInputs.stack([x for _, x in batch])

    graph = DecodeGraph(model, B, cache_len)
    zero = lambda: {"encoder_s": 0.0, "prefill_s": 0.0,  # noqa: E731
                    "decode_s": 0.0}
    _encdec_batch(model, graph, *inputs(batches[0]), cache_len, new_tokens,
                  zero())                          # warm-up: the capture
    times = zero()
    ops.reset_launches()
    t0 = time.perf_counter()
    n_prefill = 0
    for batch in batches:
        tb, pb, ib = inputs(batch)
        _encdec_batch(model, graph, tb, pb, ib, cache_len, new_tokens, times)
        n_prefill += tb.numel()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    n_decode = len(reqs) * (new_tokens - 1)
    round_ms = 1e3 * times["decode_s"] / (len(batches) * (new_tokens - 1))
    bound_ms = 1e3 * w_bytes / HBM_BYTES_PER_S
    enc = (f"; the encoder {times['encoder_s']:.4f}s of it, "
           f"{100 * times['encoder_s'] / times['prefill_s']:.1f}% of a "
           f"prefill batch" if scfg.encoder_layers else "")
    print(f"  bf16 serving, {len(reqs)} requests (prompts "
          f"{min(serve_lengths)}-{max(serve_lengths)}, mean "
          f"{np.mean(serve_lengths):.0f}), batch {B}, {new_tokens} new "
          f"tokens: prefill {n_prefill} tok in {times['prefill_s']:.4f}s = "
          f"{n_prefill / times['prefill_s']:.1f} tok/s{enc}; decode "
          f"{n_decode} tok in {times['decode_s']:.4f}s = "
          f"{n_decode / times['decode_s']:.1f} tok/s ({round_ms:.3f} ms per "
          f"decode round against a weight-read bound of {bound_ms:.3f} ms: "
          f"{w_bytes / 1e9:.3f} GB over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"wall {wall:.3f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    per = _kernel_layers(scfg, "flash_attention")
    print(f"  launches: flash_attention {launches['flash_attention']} = "
          f"{launches['flash_attention'] / len(batches):.0f} per prefill "
          f"batch ({per}: {scfg.encoder_layers} encoder and "
          f"{scfg.num_layers} decoder layers)")
    if launches["flash_attention"] != per * len(batches) or any(
            n for k, n in launches.items() if k != "flash_attention"):
        raise AssertionError(f"{arch}: launches {launches}, expected "
                             f"{per} flash_attention per batch")
    # replay against eager on the first batch, bit for bit
    outs = {}
    for name, g in (("replay", graph), ("eager", None)):
        kept = []
        tokens = _encdec_batch(model, g, *inputs(batches[0]), cache_len,
                               DECODE_CHECK_TOKENS, zero(), kept)
        outs[name] = (tokens, kept)
    (rt, rl), (et, el) = outs["replay"], outs["eager"]
    same = rt == et and len(rl) == len(el) and all(
        bool(torch.equal(a, b)) for a, b in zip(rl, el))
    print(f"  decode rounds as CUDA graphs, bucket (batch, cache) "
          f"({B}, {cache_len}): captures {graph.captures}; replay vs eager "
          f"over {len(rl)} rounds of the first batch: tokens and logits "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}")
    if not same or graph.captures != 1:
        raise AssertionError(f"{arch}: replay vs eager {same}, captures "
                             f"{graph.captures}")
    _prefill_repeat(model, toks, pads, extra)
    _bf16_layers(model, "flash_attention", toks, pads, extra)
    del graph, model
    _free()
    return launches


def _train_on_card() -> list:
    """``train_lm`` at the CLI's batch and sequence (30 steps) on the card
    for reduced Whisper-base, Qwen2-VL-2B and RWKV-6 1.6B, each against
    the same run on the CPU from the same weights: every step's loss
    finite and within ``LOSS_TOL`` * max(1, |loss|), and no kernel
    launched (training takes the plain paths; the forward-only kernels
    refuse autograd). Returns the card runs' launch counts."""
    import numpy as np
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_lm
    got = []
    for arch in TRAIN_ARCHS:
        red = get_arch_config(arch).reduced()
        red = red.replace(dtype="float32",
                          vocab_size=min(red.vocab_size, 1024))
        sd = build_model(red, torch.Generator().manual_seed(0),
                         remat=False).state_dict()
        ops.reset_launches()
        t0 = time.perf_counter()
        card = train_lm(arch, device=DEVICE, state_dict=sd, **LM_TRAIN)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        got.append(dict(ops.launches))
        t0 = time.perf_counter()
        cpu = train_lm(arch, device="cpu", state_dict=sd, **LM_TRAIN)
        cpu_s = time.perf_counter() - t0
        a, b = np.array(card["losses"]), np.array(cpu["losses"])
        err = float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
        print(f"  train_lm {arch} (reduced: {red.num_layers} layers, d "
              f"{red.d_model}, float32), {LM_TRAIN['steps']} steps at "
              f"batch {LM_TRAIN['batch']}, seq {LM_TRAIN['seq']}: card "
              f"loss {a[0]:.4f} -> {a[-1]:.4f} in {card_s:.1f}s "
              f"({LM_TRAIN['steps'] / card_s:.2f} steps/s), CPU "
              f"{b[0]:.4f} -> {b[-1]:.4f} in {cpu_s:.1f}s; card vs CPU "
              f"max {err:.3e} of max(1, |loss|) over every step (limit "
              f"{LOSS_TOL}); kernels launched {sum(got[-1].values())}",
              flush=True)
        if not np.isfinite(a).all() or err > LOSS_TOL or any(
                got[-1].values()):
            raise AssertionError(f"{arch}: card training {err:.3e}, "
                                 f"launches {got[-1]}")
    return got


def encdec_lm_phase() -> list:
    """Phase 19: Whisper-base and Qwen2-VL-2B served at full width and
    depth, and LM training on the card; returns the serving runs' and the
    training runs' launch counts."""
    import numpy as np
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    t_phase = time.perf_counter()
    got = []
    for arch, parity, n_req, (lo, hi), contract_S in (
            ("whisper-base", WHISPER_PARITY_PROMPTS, WHISPER_REQUESTS,
             WHISPER_PROMPTS, 128),
            ("qwen2-vl-2b", VL_PARITY_PROMPTS, VL_REQUESTS, LM_PROMPTS, 640)):
        t_arch = time.perf_counter()
        cfg = get_arch_config(arch)
        toks, pads = _lm_batch(cfg, parity)
        extra = EncDecInputs.seeded(cfg, parity, seed=1)
        seeded = torch.randint(0, cfg.vocab_size, (len(toks), 8),
                               generator=torch.Generator().manual_seed(1))
        f32 = cfg.replace(dtype="float32")
        model = _f32_model(f32, 0)
        _f32_kernel_vs_plain(model, "flash_attention", toks, pads, seeded,
                             "full depth", extra)
        _check_contract(model, contract_S, "full depth",
                        extra=_contract_inputs(cfg, 2))
        del model
        _free()
        cut = f32.replace(num_layers=2, encoder_layers=min(
            2, f32.encoder_layers))
        card = build_model(cut, torch.Generator(device=DEVICE).manual_seed(1)
                           ).requires_grad_(False)
        _card_vs_cpu(card, toks, pads, seeded,
                     "depth 2" + (" + 2 encoder layers"
                                  if cut.encoder_layers else ""),
                     "flash_attention", extra)
        del card
        _free()
        lengths = [int(n) for n in np.random.default_rng(19).integers(
            lo, hi + 1, n_req)]
        got.append(_encdec_serving(cfg, toks, pads, extra, lengths,
                                   LM_NEW_TOKENS))
        print(f"  {arch}: {time.perf_counter() - t_arch:.1f}s", flush=True)
    t0 = time.perf_counter()
    got += _train_on_card()
    print(f"  LM training on the card: {time.perf_counter() - t0:.1f}s; "
          f"phase 19: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return got


# -- phases 22-23: one process per card over NCCL -----------------------------

RANK_STEPS = 30                    # steps per strategy in phases 22-23
MULTICARD = 4                      # cards, and NCCL ranks, of phase 23
RANK_TOL = 1e-6                    # NCCL step 1 vs LocalComm's, relative
MC_PARITY = (4, 2, 512)            # float32 EP (1, 4) gate: depth, B, T
MC_PREFILL = (2, 4096)             # B, T of the full-depth bf16 prefills
MC_REPS = 3                        # full-depth prefills per rank
# phase 23 at the configs' sizes; the tests run it over gloo at toy ones
MC_FULL = dict(device=DEVICE, nodes=20_000, timing_nodes=ENGINE_TIMING_NODES,
               steps=RANK_STEPS, lm="full", parity=MC_PARITY,
               prefill=MC_PREFILL, reps=MC_REPS)


def _engine_over(job, comm):
    """The job's engine Trainer with its partitions over ``comm`` (None:
    every partition in this process), and the job's views."""
    from repro_torch import api
    from repro_torch.core.engine import HybridParallelEngine
    from repro_torch.core.partition import build_partitions
    from repro_torch.core.trainer import Trainer
    g, model, opt, views, *_ = api._build(job)
    sg = build_partitions(g, job.engine_partitions,
                          method=job.partition_method,
                          gcn_norm=job.model == "gcn")
    return Trainer(HybridParallelEngine(model, sg, comm=comm,
                                        device=job.device), opt), views


def _world1_rank(rank: int) -> dict:
    """Phase 22 in its one rank (NCCL, world 1, P=4 in this process):
    the engine Trainer over a ProcessGroupComm against phase 15's
    LocalComm fit, and reduced Mixtral's EP (1, 4) prefill over the
    group against the LocalComm mesh's. Returns the NCCL paths' kernel
    launches."""
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    from repro_torch.core.comm import ProcessGroupComm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ExpertMesh
    from repro_torch.launch.serve_gnn import resolve_graph
    g = resolve_graph("alipay_like", "gat_e", seed=0)
    job = _engine_job("gnn_gat_e_alipay", "global", g)
    local, views = _engine_over(job, None)
    want = (local.fit(views, steps=RANK_STEPS)["losses"], _params(local))
    ops.reset_launches()
    with _no_plain_versions():
        tr, views = _engine_over(job, ProcessGroupComm(P=ENGINE_P))
        got = (tr.fit(views, steps=RANK_STEPS)["losses"], _params(tr))
    counts = dict(ops.launches)
    tr.assert_compiled_once()
    caps = tr.trace_counts["train_step"]
    _bitwise(f"GAT-E {g.num_nodes} nodes, global, P={ENGINE_P}: NCCL world "
             f"1 vs LocalComm, {RANK_STEPS} steps", got, want)
    missing = [k for k in ENGINE_KERNELS if counts[k] <= 0]
    if missing or (tr.graphs_on and caps != 1):
        raise AssertionError(f"NCCL engine: kernels {missing} not "
                             f"launched, or {caps} captures")
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(dtype="float32")
    model = build_model(cfg, torch.Generator(device=DEVICE).manual_seed(22),
                        moe_impl="ep", mesh=ExpertMesh(1, 4)
                        ).requires_grad_(False)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(22))
    want_l, want_d = _ep_prefill(model, toks)
    flash = ops.launches["flash_attention"]
    _moe_as(model, "ep", ExpertMesh(1, 4, ProcessGroupComm(P=4)))
    got_l, got_d = _ep_prefill(model, toks)
    counts["flash_attention"] += ops.launches["flash_attention"] - flash
    same = torch.equal(got_l, want_l)
    print(f"    reduced {cfg.name} (f32, {cfg.num_layers} layers), EP (1, 4) "
          f"over NCCL world 1 vs the LocalComm mesh: last logits "
          f"{'bitwise equal' if same else 'DIFFER'}; pairs dropped "
          f"{got_d[0]} of {got_d[1]} ({want_d[0]} of {want_d[1]})",
          flush=True)
    if not same or got_d != want_d:
        raise AssertionError("EP over NCCL at world 1 differs from the "
                             "LocalComm mesh")
    print("    ranks row " + json.dumps({
        "phase": 22, "world": 1, "P": ENGINE_P, "backend": "nccl",
        "graphs": tr.graphs_on, "captures": caps,
        "launches": {k: v for k, v in counts.items() if v}}), flush=True)
    return counts


def world1_phase() -> dict:
    """Phase 22: NCCL at world 1 in a rank that the launcher starts (one
    card); returns the kernel launches of its NCCL paths."""
    from repro_torch.launch.ranks import launch
    t0 = time.perf_counter()
    counts, = launch(_world1_rank, 1, device=DEVICE)
    print(f"  phase 22: {time.perf_counter() - t0:.1f}s, the rank's start "
          f"included; phase 23 (four cards) runs only as `python3 "
          f"chip_smoke.py --only multicard`", flush=True)
    return counts


def _profile_ms(fn, device) -> dict:
    """Device ms of ``fn()`` from a ``torch.profiler`` trace: every
    kernel's summed (``busy_ms``), the NCCL kernels' (``nccl_ms``: the
    exchanges and gathers, which spin on their own stream until the
    peers arrive, so the two overlap and can exceed the wall time), the
    rest (``compute_ms``) and its six largest ops; None on the CPU."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if torch.device(device).type != "cuda":
        return {"busy_ms": None, "nccl_ms": None, "compute_ms": None,
                "largest": []}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    nccl = sum(e.self_device_time_total for e in ev
               if "nccl" in e.key.lower()) / 1e3
    largest = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:80])
                      for e in ev if "nccl" not in e.key.lower()),
                     reverse=True)[:6]
    return {"busy_ms": busy, "nccl_ms": nccl, "compute_ms": busy - nccl,
            "largest": largest}


def _mc_engine(rank: int, spec: dict) -> dict:
    """Phase 23 (a): GAT-E at the config's widths on alipay_like, P=4,
    ``P // world`` partitions a rank, through ``api.make_trainer``: step
    1 (rank 0 also runs it with every partition on its card), then one
    Trainer over global -> mini -> cluster, and a second fit."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import ops
    dev, steps, world = spec["device"], spec["steps"], dist.get_world_size()
    g = make_dataset("alipay_like", seed=0, num_nodes=spec["nodes"])
    job = _engine_job("gnn_gat_e_alipay", "global", g, device=dev)
    strategies = ("global", "mini", "cluster")
    streams = _engine_streams(job, strategies)
    view0 = streams[0].build(0)
    res = {}
    if rank == 0:
        local, _ = _engine_over(job, None)
        res["local_step1"] = _step1(local.engine, view0)
        del local
    dist.barrier()
    ranked = dataclasses.replace(job, ranks=world)
    trainer, *_ = api.make_trainer(ranked)
    res["step1"] = _step1(trainer.engine, view0)
    ops.reset_launches()
    guard = (_no_plain_versions() if dev == "cuda"
             else contextlib.nullcontext())
    with guard:
        losses, walls = _fit_streams(trainer, streams, steps)
    res["launches"] = dict(ops.launches)
    trainer.assert_compiled_once()
    res.update(losses=losses, graphs=trainer.graphs_on,
               captures=trainer.trace_counts["train_step"],
               first_fit_steps_per_s=[steps / w for w in walls])
    params = _params(trainer)
    _, walls = _fit_streams(trainer, streams, steps)
    res["steps_per_s"] = [steps / w for w in walls]
    again, *_ = api.make_trainer(ranked)
    l2, _ = _fit_streams(again, streams, steps)
    p2 = _params(again)
    res["repeat_bitwise"] = l2 == losses and all(
        bool((p2[k] == params[k]).all()) for k in params)
    return res


def _mc_engine_timing(rank: int, spec: dict) -> dict:
    """Phase 23 (b): GAT-E global on the large alipay_like graph, P=4
    over the ranks: steps/s under replay, launches a step, bytes sent a
    step, the profiled busy and NCCL ms a step and the busy share."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core.strategies import shard_view
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import ops
    dev, steps = spec["device"], spec["steps"]
    t0 = time.perf_counter()
    g = make_dataset("alipay_like", seed=0, num_nodes=spec["timing_nodes"])
    job = dataclasses.replace(
        _engine_job("gnn_gat_e_alipay", "global", g, device=dev),
        ranks=dist.get_world_size())
    trainer, views, *_ = api.make_trainer(job)
    setup = time.perf_counter() - t0
    ops.reset_launches()
    losses, first = _fit_streams(trainer, [views], steps)
    launches = {k: v / steps for k, v in ops.launches.items() if v}
    _, walls = _fit_streams(trainer, [views], steps)
    step_ms = 1e3 * walls[0] / steps
    prof_steps = 5
    prof = _profile_ms(lambda: trainer.fit(views, steps=prof_steps), dev)
    per = {k: (v / prof_steps if v is not None else None)
           for k, v in prof.items() if k != "largest"}
    staged = trainer.engine.stage_view(shard_view(
        trainer.plan, views.build(0)))
    return {"setup_s": setup, "losses": losses,
            "first_fit_steps_per_s": steps / first[0],
            "steps_per_s": steps / walls[0], "step_ms": step_ms,
            "launches_per_step": launches,
            "busy_ms_per_step": per["busy_ms"],
            "nccl_ms_per_step": per["nccl_ms"],
            "compute_ms_per_step": per["compute_ms"],
            "busy_share": (per["compute_ms"] / step_ms
                           if per["compute_ms"] is not None else None),
            "largest": [(ms / prof_steps, n / prof_steps, key)
                        for ms, n, key in prof["largest"]],
            "bytes_sent_per_step": _exchange_counts(
                trainer, staged)["bytes_sent"],
            "graphs": trainer.graphs_on,
            "captures": trainer.trace_counts["train_step"]}


def _mc_mixtral(rank: int, spec: dict) -> dict:
    """Phase 23 (c): Mixtral 8x7B at full width under EP (1, world), one
    model rank a card (``make_host_mesh``): float32 at the parity depth
    over the group, and rank 0's LocalComm (1, world) mesh on its card;
    then bf16 at full depth, the timed prefills, a profile and the
    decode step the reference refuses."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ExpertMesh, make_host_mesh
    dev, world = spec["device"], dist.get_world_size()
    cfg = get_arch_config("mixtral-8x7b")
    if spec["lm"] != "full":
        cfg = cfg.reduced()
    mesh = make_host_mesh(world)
    res = {"mesh": [mesh.data, mesh.model, mesh.comm.count]}
    depth, B, T = spec["parity"]
    f32 = cfg.replace(dtype="float32", num_layers=depth)
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(23))

    def f32_model(m):
        return build_model(f32, torch.Generator(device=dev).manual_seed(23),
                           moe_impl="ep", mesh=m).requires_grad_(False)

    model = f32_model(mesh)
    res["f32"] = _ep_prefill(model, toks)
    del model
    _free_on(dev)
    if rank == 0:
        model = f32_model(ExpertMesh(1, world))
        res["f32_local"] = _ep_prefill(model, toks)
        del model
        _free_on(dev)
    dist.barrier()

    t0 = time.perf_counter()
    model = build_model(cfg, torch.Generator(device=dev).manual_seed(0),
                        moe_impl="ep", mesh=mesh, rolling_window_decode=True
                        ).requires_grad_(False)
    _sync(dev)
    res["build_s"] = time.perf_counter() - t0
    res["layers"] = cfg.num_layers
    res["held_gb"] = sum(p.numel() * p.element_size()
                         for p in model.parameters()) / 1e9
    B, T = spec["prefill"]
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(24)
                         ).to(dev)
    _, res["dropped"] = _ep_prefill(model, toks)      # warm-up
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    outs = []
    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(spec["reps"]):
        outs.append(model.prefill({"tokens": toks}, cache_len=T)[0])
    _sync(dev)
    res["ms"] = 1e3 * (time.perf_counter() - t0) / spec["reps"]
    res["flash_per_prefill"] = ops.launches["flash_attention"] / spec["reps"]
    res["launches"] = dict(ops.launches)
    res["finite"] = all(bool(torch.isfinite(o).all()) for o in outs)
    res["bitwise_repeats"] = sum(torch.equal(o, outs[0]) for o in outs)
    res["logits"] = outs[0].float().cpu()
    res["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None)
    res["profile"] = _profile_ms(
        lambda: model.prefill({"tokens": toks}, cache_len=T), dev)
    _, caches, idx = model.prefill({"tokens": toks[:, :8]}, cache_len=9)
    try:
        model.decode_step({"tokens": toks[:, 8:9]}, caches, idx)
        res["decode"] = "no error"
    except ValueError as e:
        res["decode"] = f"ValueError: {e}"
    del model, caches, outs
    _free_on(dev)
    return res


def _free_on(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        _free()


def _multicard_rank(rank: int, spec: dict) -> dict:
    """One of phase 23's ranks: (a), (b) and (c) in turn, each raising on
    its own failures; the checks across ranks are the parent's."""
    import os
    t0 = time.perf_counter()
    out = {"engine": _mc_engine(rank, spec)}
    out["timing"] = _mc_engine_timing(rank, spec)
    out["mixtral"] = _mc_mixtral(rank, spec)
    out["seconds"] = time.perf_counter() - t0
    out["pid_cores"] = len(os.sched_getaffinity(0))
    return out


def _multicard_checks(ranks: list, spec: dict, label: str) -> dict:
    """Phase 23's gates across the ranks, and its rows; returns the
    launches summed over the cards."""
    import os
    import torch
    world = len(ranks)
    eng = [r["engine"] for r in ranks]
    local_loss, local_grads = eng[0]["local_step1"]
    for r, e in enumerate(eng):
        loss, grads = e["step1"]
        l_err = abs(loss - local_loss) / max(1.0, abs(local_loss))
        g_err = _rel_grads(grads, local_grads)
        print(f"  rank {r}: step 1 vs LocalComm P={ENGINE_P} on card 0: "
              f"loss rel err {l_err:.3e}, gradients max rel err "
              f"{g_err:.3e} (limit {RANK_TOL}); captures {e['captures']} "
              f"(graphs {e['graphs']}); a second fit "
              f"{'bitwise equal' if e['repeat_bitwise'] else 'DIFFERS'}")
        if max(l_err, g_err) > RANK_TOL or not e["repeat_bitwise"]:
            raise AssertionError(f"rank {r}: step 1 {l_err:.3e} / "
                                 f"{g_err:.3e}, repeat {e['repeat_bitwise']}")
        if e["losses"] != eng[0]["losses"]:
            raise AssertionError(f"rank {r}'s losses differ from rank 0's")
        if e["graphs"] and e["captures"] != 1:
            raise AssertionError(f"rank {r}: {e['captures']} captures")
        if spec["device"] == "cuda":
            missing = [k for k in ENGINE_KERNELS if e["launches"][k] <= 0]
            if missing:
                raise AssertionError(f"rank {r}: {missing} not launched")
    steps = 3 * spec["steps"]
    print(f"  GAT-E {spec['nodes']} nodes, P={ENGINE_P} over {world} ranks, "
          f"global -> mini -> cluster: {steps} losses bitwise equal on "
          f"every rank; loss {eng[0]['losses'][0]:.5f} -> "
          f"{eng[0]['losses'][-1]:.5f}")
    print("  engine row " + json.dumps({
        "phase": 23, "run": f"gat_e {spec['nodes']} nodes P={ENGINE_P} "
        f"over {world} cards", "P": ENGINE_P, "ranks": world, "card": label,
        "strategies": ["global", "mini", "cluster"],
        "steps_per_s_replay": eng[0]["steps_per_s"],
        "first_fit_steps_per_s": eng[0]["first_fit_steps_per_s"],
        "graphs": eng[0]["graphs"],
        "launches_per_card": [
            {k: v for k, v in e["launches"].items() if v} for e in eng]}),
        flush=True)
    tim = [r["timing"] for r in ranks]
    if any(t["losses"] != tim[0]["losses"] for t in tim):
        raise AssertionError("200k: the ranks' losses differ")
    print("  engine row " + json.dumps({
        "phase": 23, "run": f"gat_e {spec['timing_nodes']} nodes "
        f"P={ENGINE_P} over {world} cards", "P": ENGINE_P, "ranks": world,
        "card": label, "strategies": ["global"],
        "host_cores": os.cpu_count(),
        "rank_cores": [r["pid_cores"] for r in ranks],
        "steps_per_s_replay": tim[0]["steps_per_s"],
        "first_fit_steps_per_s_replay": tim[0]["first_fit_steps_per_s"],
        "step_ms": [t["step_ms"] for t in tim],
        "busy_ms_per_step_all_streams": [t["busy_ms_per_step"] for t in tim],
        "compute_ms_per_step": [t["compute_ms_per_step"] for t in tim],
        "busy_share": [t["busy_share"] for t in tim],
        "exchange_device_ms_per_step": [t["nccl_ms_per_step"] for t in tim],
        "bytes_sent_per_step_per_card": [t["bytes_sent_per_step"]
                                         for t in tim],
        "launches_per_step": tim[0]["launches_per_step"],
        "setup_s": [t["setup_s"] for t in tim],
        "graphs": tim[0]["graphs"],
        "captures": [t["captures"] for t in tim]}), flush=True)
    _print_largest("200k step, rank 0, ms a step", tim[0]["largest"])
    lm = [r["mixtral"] for r in ranks]
    got, want = lm[0]["f32"], lm[0]["f32_local"]
    drops = [sum(m["f32"][1][i] for m in lm) for i in (0, 1)]
    err = _rel(got[0], want[0])
    same = torch.equal(got[0], want[0])
    alike = all(torch.equal(m["f32"][0], got[0]) for m in lm)
    depth, B, T = spec["parity"]
    print(f"  f32 Mixtral depth {depth}, B {B}, T {T}: EP (1, {world}) over "
          f"{world} NCCL ranks vs LocalComm (1, {world}) on card 0: last "
          f"logits {'bitwise equal' if same else f'max diff {err:.3e}'} of "
          f"max|logit| (limit {LM_CPU}); ranks alike {alike}; pairs "
          f"dropped {drops[0]} of {drops[1]} over the ranks, "
          f"{want[1][0]} of {want[1][1]} on card 0")
    if err > LM_CPU or drops != list(want[1]) or not alike:
        raise AssertionError(f"EP over NCCL vs LocalComm: {err:.3e}, drops "
                             f"{drops} vs {want[1]}, alike {alike}")
    m0 = lm[0]
    B, T = spec["prefill"]
    drops = [sum(m["dropped"][i] for m in lm) for i in (0, 1)]
    for r, m in enumerate(lm):
        ok = (m["finite"] and m["bitwise_repeats"] >= 2
              and m["decode"].startswith("ValueError")
              and torch.equal(m["logits"], m0["logits"]))
        print(f"  rank {r}: {m['layers']} layers, {m['held_gb']:.2f} GB "
              f"held (made in {m['build_s']:.1f}s), peak "
              f"{m['peak_gb'] or 0:.1f} GB; {spec['reps']} prefills B {B} "
              f"T {T}, {m['ms']:.1f} ms each, {m['bitwise_repeats']} "
              f"bitwise equal to the first, finite {m['finite']}; "
              f"flash_attention {m['flash_per_prefill']:.0f} a prefill; "
              f"decode over {world} model ranks: {m['decode'][:60]}")
        if not ok:
            raise AssertionError(f"rank {r}: full-depth EP checks failed")
        if spec["device"] == "cuda" and m["flash_per_prefill"] != m["layers"]:
            raise AssertionError(f"rank {r}: {m['flash_per_prefill']} "
                                 "flash_attention launches a prefill")
    prof = m0["profile"]
    print("  ep row " + json.dumps({
        "phase": 23, "run": f"prefill EP (1, {world}) over {world} cards",
        "layers": m0["layers"], "B": B, "T": T, "card": label,
        "ms": m0["ms"], "ms_per_rank": [m["ms"] for m in lm],
        "tokens_per_s": 1e3 * B * T / m0["ms"],
        "dropped_share": drops[0] / drops[1] if drops[1] else 0.0,
        "peak_gb_per_card": [m["peak_gb"] for m in lm],
        "held_gb_per_card": [m["held_gb"] for m in lm],
        "flash_attention_launches": m0["flash_per_prefill"],
        "device_busy_ms": prof["busy_ms"], "nccl_ms": prof["nccl_ms"],
        "compute_ms": prof["compute_ms"],
        "nccl_share": (prof["nccl_ms"] / prof["busy_ms"]
                       if prof["busy_ms"] else None)}), flush=True)
    _print_largest("full-depth prefill, rank 0, ms", prof["largest"])
    total = {k: 0 for k in KERNELS}
    for r in ranks:
        for part in (r["engine"]["launches"], r["mixtral"]["launches"]):
            for k in total:
                total[k] += part.get(k, 0)
    return total


def _print_largest(what: str, largest: list) -> None:
    """The profile's largest ops other than NCCL's."""
    if largest:
        print(f"  profile, {what} (NCCL aside), largest:")
    for ms, n, key in largest:
        print(f"      {ms:.4f} ms over {n:.0f} calls  {key}")


def multicard_phase(label: str, spec: dict = MC_FULL) -> dict:
    """Phase 23: four cards, four NCCL ranks (:mod:`repro_torch.launch.
    ranks`); raises on fewer cards. Returns the main paths' launches,
    summed over the cards."""
    import torch
    from repro_torch.launch.ranks import launch
    if spec["device"] == "cuda":
        have = torch.cuda.device_count()
        if have < MULTICARD:
            raise RuntimeError(f"phase 23 needs {MULTICARD} cards, this "
                               f"host has {have}")
        for i, card in enumerate(card_labels()):
            print(f"  card {i}: {card}")
    import os
    print(f"  host: {os.cpu_count()} CPU cores", flush=True)
    t0 = time.perf_counter()
    ranks = launch(_multicard_rank, MULTICARD, args=(spec,),
                   device=spec["device"])
    got = _multicard_checks(ranks, spec, label)
    took = ", ".join(f"{r['seconds']:.0f}" for r in ranks)
    print(f"  phase 23: {time.perf_counter() - t0:.1f}s (the ranks' {took} "
          "s)", flush=True)
    return got


# phase 24: the dry-run's plan of one card against the card
DRYRUN_LAYERS = 4                  # Qwen3-4B at full width, 4 of 36 layers
DRYRUN_TRAIN = (1, 4096)           # B, T of the AdamW train steps
DRYRUN_PREFILL = (4, 2048)         # phase 12's served prefill, bf16
DRYRUN_HELD_TOL = 0.01             # planned vs the card's held bytes
DRYRUN_PEAK = (0.8, 1.25)          # planned / the card's peak bytes


def _dryrun_warm(cfg, dev) -> int:
    """Run a reduced model's train step, prefill and decode on the card,
    so that cuBLAS's workspaces exist, drop it, and return the bytes the
    card holds then: what the phase's numbers are counted from."""
    import torch
    from repro_torch.arch import build_model
    from repro_torch.launch.faketrace import train_step
    from repro_torch.optim import adamw
    small = cfg.reduced().replace(dtype=cfg.dtype)
    model = build_model(small, torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    opt = adamw(1e-4)
    state = opt.init(params)
    tok = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    train_step(model, opt, state, params, {"tokens": tok, "labels": tok})
    _, caches, idx = model.prefill({"tokens": tok}, 64)
    model.decode_step({"tokens": tok[:, :1]}, caches, idx - 1)
    del model, params, opt, state, caches
    _free()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _shape(kind: str, B: int, T: int):
    """Phase 24's input shape of a step of ``kind``, named as the
    workload of that kind."""
    from repro_torch.config import InputShape
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    return InputShape(name, T, B, kind)


def _dryrun_plan(cfg, kind: str, B: int, T: int, remat: str = "full"):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShapeMesh
    shape = _shape(kind, B, T)
    rec = dryrun.run_one("qwen3-4b", shape.name, "card", "dense", False,
                         None, verbose=False, opts={"remat": remat},
                         mesh=ShapeMesh(("data", "model"), (1, 1)),
                         cfg=cfg, shape=shape)
    if rec["status"] != "ok":
        raise AssertionError(f"dry-run of {kind}: {rec.get('error')}\n"
                             f"{rec.get('trace')}")
    return rec


def _dryrun_row(label: str, run: str, rec: dict, held: int, peak: int,
                ms: float) -> dict:
    import torch
    row = {"phase": 24, "run": run,
           "held_planned": rec["held_bytes_per_device"],
           "held_card": held,
           "held_rel_err": rec["held_bytes_per_device"] / held - 1,
           "peak_planned": rec["memory_per_device_bytes"],
           "peak_card": peak,
           "peak_ratio": rec["memory_per_device_bytes"] / peak,
           "ms": ms, "bound_ms": rec["bound_s"] * 1e3,
           "bound_share": rec["bound_s"] * 1e3 / ms,
           "dominant": rec["dominant"],
           "traced_flops": rec["traced_flops_per_device"],
           "traced_bytes": rec["traced_bytes_per_device"],
           "trace_s": rec["trace_seconds"], "card": label,
           "torch": torch.__version__}
    print("  dryrun row " + json.dumps(row), flush=True)
    bad = []
    if abs(row["held_rel_err"]) > DRYRUN_HELD_TOL:
        bad.append(f"held bytes off by {row['held_rel_err']:+.4f}")
    lo, hi = DRYRUN_PEAK
    if not lo <= row["peak_ratio"] <= hi:
        bad.append(f"peak ratio {row['peak_ratio']:.4f} outside "
                   f"[{lo}, {hi}]")
    if bad:
        raise AssertionError(f"dry-run {run}: " + "; ".join(bad))
    return row


def _softmax_buffers(dev) -> dict:
    """The buffers softmax's backward holds beyond its output on the card,
    in tensors of the output's size, with its gradient input contiguous
    and not (what ``launch/faketrace.py`` books for it)."""
    import torch
    shape = (1, 8, 4, 1024, 1024)
    n = math.prod(shape) * 4
    out = torch.randn(shape, device=dev)
    got = {}
    for name, g in (("contiguous", torch.randn(shape, device=dev)),
                    ("permuted", torch.randn((8, 1024, 4, 1, 1024),
                                             device=dev).permute(
                                                 3, 0, 2, 1, 4))):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = torch.ops.aten._softmax_backward_data(g, out, -1, torch.float32)
        torch.cuda.synchronize(dev)
        got[name] = (torch.cuda.max_memory_allocated() - base - n) / n
        del r
    print(f"  softmax backward's own buffers, in output-sized tensors: "
          f"{got['contiguous']:.3f} (contiguous gradient), "
          f"{got['permuted']:.3f} (permuted)", flush=True)
    return got


def _card_ms(fn, dev) -> float:
    import torch
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop)


def dryrun_phase(label: str) -> dict:
    """Phase 24: the dry-run (``repro_torch.launch.dryrun.run_one`` at
    mesh (1, 1)) against the card, Qwen3-4B at full width and
    ``DRYRUN_LAYERS`` layers in bf16: train steps (loss, gradients,
    AdamW) under remat full, dots and none, then a served prefill and
    one decode round. For each, the planned held bytes against
    ``torch.cuda.memory_allocated`` once the state exists (within
    ``DRYRUN_HELD_TOL``) and the planned peak against
    ``max_memory_allocated`` (a ratio within ``DRYRUN_PEAK``); the train
    peaks must order none >= dots >= full, planned and on the card; the
    step's time against the roofline's bound from the same record is
    printed. Returns the prefill's kernel launches."""
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import input_specs
    from repro_torch.launch.faketrace import train_step
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = get_arch_config("qwen3-4b").replace(num_layers=DRYRUN_LAYERS)
    one = ShapeMesh(("data", "model"), (1, 1))
    _softmax_buffers(dev)
    base = _dryrun_warm(cfg, dev)

    def held_now() -> int:
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated() - base

    def peak_since(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats()
        ms = _card_ms(fn, dev)
        return torch.cuda.max_memory_allocated() - base, ms

    rows, peaks = [], {}
    B, T = DRYRUN_TRAIN
    for remat in ("full", "dots", "none"):
        rec = _dryrun_plan(cfg, "train", B, T, remat)
        model = build_model(cfg, torch.Generator(device=dev).manual_seed(0),
                            remat=True, remat_policy=remat)
        params = dict(model.named_parameters())
        opt = adamw(1e-4)
        state = opt.init(params)
        batch, _ = input_specs(cfg, _shape("train", B, T), one,
                               device=dev)
        out = {}

        def step():
            out["r"] = train_step(model, opt, state, params, batch)
        step()                          # the gradients exist: all held
        held = held_now()
        out.clear()                     # each step makes its gradients
        peak, ms = peak_since(step)
        loss = float(out["r"][0])
        if not math.isfinite(loss):
            raise AssertionError(f"train ({remat}): loss {loss}")
        out.clear()
        rows.append(_dryrun_row(label, f"train remat {remat}", rec, held,
                                peak, ms))
        peaks[remat] = (rec["memory_per_device_bytes"], peak)
        del model, params, opt, state, batch, out
        _free()
    for i, what in enumerate(("planned", "card")):
        p = {k: v[i] for k, v in peaks.items()}
        if not p["none"] >= p["dots"] >= p["full"]:
            raise AssertionError(f"{what} train peaks do not order none >= "
                                 f"dots >= full: {p}")
    print("  train peaks, planned and on the card (GB): " + ", ".join(
        f"{k} {v[0] / 1e9:.3f} / {v[1] / 1e9:.3f}" for k, v in peaks.items()))

    B, T = DRYRUN_PREFILL
    rec = _dryrun_plan(cfg, "prefill", B, T)
    model = build_model(cfg, torch.Generator(device=dev).manual_seed(0),
                        remat=False)
    batch, _ = input_specs(cfg, _shape("prefill", B, T), one, device=dev)
    held = held_now()
    out = {}
    ops.reset_launches()
    peak, ms = peak_since(lambda: out.update(
        r=model.prefill(batch, T)))
    launches = dict(ops.launches)
    if launches["flash_attention"] != DRYRUN_LAYERS:
        raise AssertionError(f"prefill: {launches['flash_attention']} "
                             "flash_attention launches")
    logits, caches, idx = out.pop("r")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("prefill: logits not finite")
    rows.append(_dryrun_row(label, "prefill", rec, held, peak, ms))
    del logits, batch
    rec = _dryrun_plan(cfg, "decode", B, T)
    batch, _ = input_specs(cfg, _shape("decode", B, T), one, device=dev)
    held = held_now()
    peak, ms = peak_since(lambda: out.update(
        r=model.decode_step(batch, caches, T - 1)))
    if not bool(torch.isfinite(out.pop("r")[0].float()).all()):
        raise AssertionError("decode: logits not finite")
    rows.append(_dryrun_row(label, "decode", rec, held, peak, ms))
    del model, caches, batch
    _free()
    print(f"  phase 24: {len(rows)} plans against the card in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return launches


# phase 25: the Sum stage's public primitives at the 1,000,000-node
# alipay_like edge set, and the legacy train_gnn on the card
SURFACE_SUM_WIDTH = 32             # segment_sum: the GAT-E gathers' width
SURFACE_MAX_WIDTH = 64             # segment_max: the Reddit config's width
SURFACE_HEADS = (4, 8)             # segment_softmax: GAT-E's heads of 8
SURFACE_MASKED = 0.1               # share of masked edges in the softmax
SURFACE_EMPTY = 8                  # segments past the graph's nodes: empty
SURFACE_RECORDED = 100_000         # edges of the recorded calls
SURFACE_JOB = ("alipay_like", "gat_e", "global")
SURFACE_TRAIN = dict(steps=TRAIN_STEPS, hidden=32, eval_every=5)
SURFACE_LIMIT_S = 30.0             # the phase, its graph's generation aside
_SCATTERS = frozenset({"index_add", "index_add_", "scatter_add",
                       "scatter_add_", "scatter_reduce", "scatter_reduce_",
                       "index_put", "index_put_", "_index_put_impl_"})


def _plain_segment_sum(x, ids, n):
    """``jax.ops.segment_sum`` in plain PyTorch on the card (atomic
    ``index_add_``): ids outside [0, n) are dropped."""
    kept = (ids >= 0) & (ids < n)
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(
        0, ids[kept], x[kept])


def _plain_segment_max(x, ids, n, g):
    """``jax.ops.segment_max`` (E, D) -> (N, D) and the gradient of
    ``sum(out * g)`` by JAX's rule, in plain PyTorch on the card: -inf on
    an empty row, ties split by the reciprocal of their count."""
    import torch
    kept = (ids >= 0) & (ids < n)
    rows = ids.clamp(0, n - 1)
    idx = rows[kept, None].expand(-1, x.shape[1])
    out = x.new_full((n, x.shape[1]), float("-inf")).scatter_reduce_(
        0, idx, x[kept], "amax", include_self=True)
    hit = (x == out[rows]) & kept[:, None]
    count = x.new_zeros(out.shape).index_add_(0, rows, hit.to(x.dtype))
    share = (g * (1.0 / count.clamp_min(1.0)))[rows]
    return out, torch.where(hit, share, torch.zeros_like(share))


def _plain_segment_softmax(lg, v, ids, n, mask):
    """``repro/core/tgar.py:59`` in plain PyTorch on the card, over the
    kept edges, differentiable by torch's own rules (in the inputs'
    type: the phase runs it in float64)."""
    import torch
    from repro_torch.kernels.ref import NEG
    kept = (ids >= 0) & (ids < n)
    lg, v, mask, ids = lg[kept], v[kept], mask[kept], ids[kept]
    masked = torch.where(mask[:, None] > 0, lg, torch.full_like(lg, NEG))
    idx = ids[:, None].expand_as(masked)
    seg_max = masked.new_full((n, lg.shape[1]), float("-inf")).scatter_reduce(
        0, idx, masked, "amax", include_self=True).clamp_min(NEG)
    ex = torch.exp(masked - seg_max[ids]) * mask[:, None]
    den = ex.new_zeros((n, lg.shape[1])).index_add(0, ids, ex)
    num = v.new_zeros((n,) + tuple(v.shape[1:])).index_add(
        0, ids, ex[..., None] * v)
    return num / den.clamp_min(1e-9)[..., None]


def _wall_ms(fn) -> float:
    """One call's milliseconds on the host's clock, the card drained."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _with_grads(out, inputs, g):
    import torch
    return (out.detach(),) + tuple(torch.autograd.grad(out, inputs, g))


class _SurfaceInputs:
    """Phase 25's operands on the card: the 1M graph's destinations in a
    shuffled order over ``N`` segments (its nodes, each of which has an
    in-edge, and ``SURFACE_EMPTY`` more that stay empty), one id made
    negative and one past ``N``; seeded data and cotangents."""

    def __init__(self, g):
        import numpy as np
        import torch
        dev = torch.device(DEVICE)
        self.E, self.N = g.num_edges, g.num_nodes + SURFACE_EMPTY
        E, N = self.E, self.N
        rng = np.random.default_rng(25)
        ids = g.dst[rng.permutation(E)].astype(np.int64)
        ids[rng.choice(E, 2, replace=False)] = (-1, N + 3)
        self.ids = torch.from_numpy(ids).to(dev)
        gen = torch.Generator(device=dev).manual_seed(25)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        H, Dh = SURFACE_HEADS
        self.xs = randn(E, SURFACE_SUM_WIDTH).requires_grad_()
        self.gs = randn(N, SURFACE_SUM_WIDTH)
        # values from a few levels, so that rows hold ties for their max
        self.xm = randn(E, SURFACE_MAX_WIDTH).mul(2).round().requires_grad_()
        self.gm = randn(N, SURFACE_MAX_WIDTH)
        self.lg = randn(E, H).requires_grad_()
        self.v = randn(E, H, Dh).requires_grad_()
        self.mask = (torch.rand(E, generator=gen, device=dev)
                     >= SURFACE_MASKED).float()
        self.gsm = randn(N, H, Dh)

    def calls(self, e: int) -> dict:
        """The three public calls, forward and gradients, over the first
        ``e`` edges."""
        from repro_torch.core import tgar
        i, N = self.ids[:e], self.N

        def ssum():
            x = self.xs[:e]
            return _with_grads(tgar.segment_sum(x, i, N), (x,), self.gs)

        def smax():
            x = self.xm[:e]
            return _with_grads(tgar.segment_max(x, i, N), (x,), self.gm)

        def ssoft():
            a, b = self.lg[:e], self.v[:e]
            return _with_grads(tgar.segment_softmax(a, b, i, N,
                                                    self.mask[:e]),
                               (a, b), self.gsm)
        return {"segment_sum": ssum, "segment_max": smax,
                "segment_softmax": ssoft}


def _surface_recorded(inp: _SurfaceInputs) -> None:
    """The calls over the first ``SURFACE_RECORDED`` edges, recorded (the
    recorder's cost grows with a call, what it shows does not): no atomic
    scatter on the card, every kernel through CUDA, no plain version."""
    from repro_torch.analysis.oplog import record_ops
    with _no_plain_versions():
        _, log = record_ops(lambda: {k: f() for k, f in inp.calls(
            SURFACE_RECORDED).items()})
    scatters = sorted({e.name for e in log if e.name in _SCATTERS})
    routes = sorted({(e.name, e.route) for e in log.kernels()})
    if scatters or any(r != "cuda" for _, r in routes):
        raise AssertionError(f"public Sum-stage ops: scatters {scatters}, "
                             f"kernel routes {routes}")
    print(f"  recorded over {SURFACE_RECORDED} edges: "
          f"{len(log.kernels())} kernel calls "
          f"({', '.join(n for n, _ in routes)}), all cuda; no scatter op, "
          "no plain version", flush=True)


def _surface_plain(inp: _SurfaceInputs, first: dict) -> None:
    """Each op's first call against its plain version on the same
    inputs: the sum in float64, each element within 1e-5 of its row's sum
    of |x| (phase 3's rule: a hub row's thousands of float32 terms round
    at that scale, in any order); its gradient, the max and the max's
    gradient exactly; the softmax within 1e-5 of a float64 plain run."""
    import torch
    E, N, ids = inp.E, inp.N, inp.ids
    errs = {}
    with torch.no_grad():
        x64 = inp.xs.detach().double()
        want = _plain_segment_sum(x64, ids, N)
        scale = _plain_segment_sum(x64.abs(), ids, N)
        err = (first["segment_sum"][0].double() - want).abs()
        if bool((err > ATOL + RTOL * scale).any()):
            raise AssertionError(f"segment_sum: past {RTOL} of sum|x| of a "
                                 f"float64 sum (max {float(err.max()):.3e})")
        errs["segment_sum"] = float(err.max())
        del x64, want, scale, err
        kept = ((ids >= 0) & (ids < N))[:, None]
        exact = {"segment_sum grad": (first["segment_sum"][1], torch.where(
            kept, inp.gs[ids.clamp(0, N - 1)], 0.0))}
        ref, ref_g = _plain_segment_max(inp.xm.detach(), ids, N, inp.gm)
        exact["segment_max"] = (first["segment_max"][0], ref)
        exact["segment_max grad"] = (first["segment_max"][1], ref_g)
        for name, (a, b) in exact.items():
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: not its plain version "
                                     "exactly")
            errs[name] = 0.0
        empty = int(torch.isneginf(ref).all(1).sum())
        del exact, ref, ref_g
    lg64, v64 = (t.detach().double().requires_grad_()
                 for t in (inp.lg, inp.v))
    ref_s = _plain_segment_softmax(lg64, v64, ids, N, inp.mask.double())
    ref_sg = torch.autograd.grad(ref_s, (lg64, v64), inp.gsm.double())
    for name, a, b in zip(("segment_softmax", "segment_softmax d_logits",
                           "segment_softmax d_values"),
                          first["segment_softmax"], (ref_s,) + ref_sg):
        b = b.detach().float()
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        errs[name] = float((a - b).abs().max())
    print("  against their plain versions (max |diff|; max exactly): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; {empty} empty rows give -inf", flush=True)


SURFACE_COMBINE_ROWS = 20_000       # combine_messages: the edges into
                                    # these segments (about 6 each)
SURFACE_COMBINE_HEADS = (4, 16)


def _surface_combine(inp: _SurfaceInputs) -> None:
    """``combine_messages`` under ``max`` with no plan (``backend=None``
    and ``"csc"``) over the edges into the first SURFACE_COMBINE_ROWS
    segments (and the negative id), messages from a few levels so that
    rows tie for their max: on the card through the kernels (no atomic
    scatter, no plain version), its forward and its gradient (the
    reference's even tie split) equal to the same call on the CPU
    exactly."""
    import torch
    from repro_torch.analysis.oplog import record_ops
    from repro_torch.core import tgar
    from repro_torch.kernels import ops
    n = SURFACE_COMBINE_ROWS + SURFACE_EMPTY
    sel = inp.ids < SURFACE_COMBINE_ROWS
    dst = inp.ids[sel]
    e = int(dst.numel())
    H, Dh = SURFACE_COMBINE_HEADS
    gen = torch.Generator(device=DEVICE).manual_seed(26)
    value = torch.randn((e, H, Dh), generator=gen, device=DEVICE).mul(
        2).round()
    mask = (torch.rand(e, generator=gen, device=DEVICE) >= 0.1).float()
    g = torch.randn((n, H, Dh), generator=gen, device=DEVICE)
    layer = type("MaxLayer", (), {"combine": "max"})()

    def call(device, backend):
        v = value.to(device).requires_grad_()
        out = tgar.combine_messages(layer, {"value": v}, dst.to(device), n,
                                    mask.to(device), backend=backend)
        return _with_grads(out, (v,), g.to(device))
    cpu = call("cpu", None)
    for backend in (None, "csc"):
        before = dict(ops.launches)
        with _no_plain_versions():
            card, log = record_ops(lambda: call(DEVICE, backend))
        torch.cuda.synchronize()
        used = {k: ops.launches[k] - before[k] for k in ops.launches
                if ops.launches[k] > before[k]}
        scatters = sorted({x.name for x in log if x.name in _SCATTERS})
        if scatters or not {"segment_max", "segment_sum",
                            "segment_sum_bwd"} <= set(used):
            raise AssertionError(f"combine_messages backend={backend}: "
                                 f"scatters {scatters}, launches {used}")
        for what, a, b in zip(("forward", "gradient"), card, cpu):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"combine_messages backend={backend} "
                                     f"max {what}: card vs CPU differ")
    ties = int(((cpu[1] != 0) & (cpu[1] != g[dst.clamp(0, n - 1)].cpu())
                ).sum())
    if ties == 0:
        raise AssertionError("combine_messages: no tied maximum to split")
    print(f"  combine_messages max, no plan (None, csc) [E={e} N={n} H={H} "
          f"D={Dh}]: card vs CPU forward and gradient bitwise equal; "
          f"{ties} gradient entries a share of a tie; kernels {used}, no "
          "scatter op", flush=True)


def _surface_times(inp: _SurfaceInputs, first: dict, label: str) -> None:
    """One more public call of each op, timed on the host's clock (the
    plan's build timed inside it) and bitwise its first call; then the
    same work on the plan that call built, and the ``csc`` backend's,
    timed with CUDA events. A JSON ``surface row`` each."""
    import torch
    from repro_torch.core import aggregate as agg
    from repro_torch.core import tgar
    from repro_torch.kernels.ref import NEG
    E, N, ids = inp.E, inp.N, inp.ids
    H, Dh = SURFACE_HEADS
    real, plan_ms, built = tgar._segments, {}, {}
    rows = {}
    for k, f in inp.calls(E).items():
        def timed_segments(*a, k=k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built["s"] = real(*a)
            torch.cuda.synchronize()
            plan_ms[k] = (time.perf_counter() - t0) * 1e3
            return built["s"]
        out = {}
        tgar._segments = timed_segments
        try:
            public = _wall_ms(lambda: out.update(r=f()))
        finally:
            tgar._segments = real
        if not all(torch.equal(a, b) for a, b in zip(out["r"], first[k])):
            raise AssertionError(f"{k}: a third call differs")
        rows[k] = public
    segs, csc = built["s"], agg.get_backend("csc")
    xs, xm, lg, v, mask = inp.xs, inp.xm, inp.lg, inp.v, inp.mask
    prebuilt = {
        "segment_sum": (lambda: _with_grads(
            tgar._planned_sum(xs, segs), (xs,), inp.gs),
            lambda: _with_grads(csc.segment_sum(xs, ids, N, segs.plan),
                                (xs,), inp.gs)),
        "segment_max": (lambda: _with_grads(
            tgar._SegmentMaxSplit.apply(xm, segs), (xm,), inp.gm),
            lambda: _with_grads(csc.segment_max(xm, ids, N, segs.plan),
                                (xm,), inp.gm)),
        "segment_softmax": (lambda: _with_grads(
            tgar._planned_softmax(lg, v, segs, mask), (lg, v), inp.gsm),
            lambda: _with_grads(csc.edge_softmax(
                torch.where(mask[:, None] > 0, lg, torch.full_like(lg, NEG)),
                v * mask[:, None, None], ids, N, segs.plan), (lg, v),
                inp.gsm))}
    widths = {"segment_sum": f"D={SURFACE_SUM_WIDTH}",
              "segment_max": f"D={SURFACE_MAX_WIDTH}",
              "segment_softmax": f"H={H} D={Dh}"}
    for k, (same, backend) in prebuilt.items():
        public = rows[k]
        same_ms, csc_ms = _time_ms(same), _time_ms(backend)
        row = {"phase": 25, "op": k, "E": E, "N": N, "shape": widths[k],
               "public_ms": public, "prebuilt_ms": same_ms,
               "csc_ms": csc_ms, "plan_ms": plan_ms[k],
               "plan_share": plan_ms[k] / public, "card": label}
        print(f"  {k} [E={E} N={N} {widths[k]}], forward and gradients: "
              f"public {public:.1f} ms, of it the plan's build "
              f"{plan_ms[k]:.1f} ms ({row['plan_share']:.1%}); the same "
              f"work on the plan prebuilt {same_ms:.3f} ms (the csc "
              f"backend {csc_ms:.3f} ms)", flush=True)
        print("    surface row " + json.dumps(row), flush=True)


def _surface_cpu_train(out: dict) -> None:
    """``train_gnn`` on the CPU, the card run's reference (run in a
    thread beside the card's work; an exception is kept for the join)."""
    from repro_torch.launch.train import train_gnn
    try:
        t0 = time.perf_counter()
        out["run"] = train_gnn(*SURFACE_JOB, device="cpu", **SURFACE_TRAIN)
        out["s"] = time.perf_counter() - t0
    except BaseException as e:          # re-raised by the joining thread
        out["error"] = e


def surface_phase(label: str) -> dict:
    """Phase 25: the rest of the JAX package's public surface on the
    card. ``segment_sum`` at width 32, ``segment_max`` at 64 and
    ``segment_softmax`` at 4 heads of 8 over the 1,000,000-node
    alipay_like edge set in a shuffled order, with one negative id and
    one past the segments: forward and ``torch.autograd.grad``; recorded
    over the first edges (no atomic scatter, no plain version), then over
    every edge: two calls bitwise equal, B.1-B.5 launched, each held
    against its plain version (1e-5; the max exactly), a third call
    timed beside the same work on a prebuilt plan. ``train_gnn`` on
    GAT-E on the card, held to its CPU run, which runs in a thread while
    the card checks the ops (the host's clock reads the third calls
    after it). Returns the launches."""
    import threading
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_gnn
    t0 = time.perf_counter()
    g = _graph("alipay_like", "gat_e", num_nodes=KERNEL_NODES)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages = {}

    def stage(name: str) -> None:
        stages[name] = time.perf_counter() - t0 - sum(stages.values())

    inp = _SurfaceInputs(g)
    stage("inputs")
    ops.reset_launches()
    _surface_recorded(inp)
    stage("recorded")
    card = train_gnn(*SURFACE_JOB, **SURFACE_TRAIN)
    stage("train_gnn on the card")
    cpu = {}
    worker = threading.Thread(target=_surface_cpu_train, args=(cpu,))
    worker.start()
    try:
        runs = [{k: f() for k, f in inp.calls(inp.E).items()}
                for _ in range(2)]
        first = runs[0]
        for k in first:
            if not all(torch.equal(a, b)
                       for a, b in zip(first[k], runs[1][k])):
                raise AssertionError(f"{k}: two calls differ")
        del runs
        stage("two calls")
        _surface_plain(inp, first)
        stage("plain versions")
    finally:
        worker.join()
    stage("the CPU's train_gnn, beyond")
    if "error" in cpu:
        raise cpu["error"]
    _surface_combine(inp)           # counts plain calls: none beside it
    stage("combine_messages")
    launches = dict(ops.launches)
    need = ("segment_sum", "segment_sum_bwd", "edge_softmax",
            "edge_softmax_bwd", "segment_max")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"phase 25 launched {launches}")
    _surface_times(inp, first, label)
    stage("timed")
    _surface_train_check(card, cpu, label)
    took = time.perf_counter() - t0
    print(f"  launches {({k: v for k, v in launches.items() if v})}; "
          "seconds by stage: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in stages.items()),
          flush=True)
    print(f"  phase 25: {took:.1f}s (the 1M graph: {t_gen:.1f}s to get, "
          "0 where phase 6 made it)", flush=True)
    if took > SURFACE_LIMIT_S:
        raise AssertionError(f"phase 25 took {took:.1f}s, over "
                             f"{SURFACE_LIMIT_S}s")
    return {k: launches[k] for k in KERNELS}


def _surface_train_check(card: dict, cpu: dict, label: str) -> None:
    """``train_gnn``'s card run against its CPU run: the losses within
    ``LOSS_TOL`` * max(1, |loss|), the model on the card."""
    ref = cpu["run"]
    if next(card["model"].parameters()).device.type != "cuda":
        raise AssertionError("train_gnn did not train on the card")
    got = [h["loss"] for h in card["history"]]
    want = [h["loss"] for h in ref["history"]]
    if len(got) != len(want):
        raise AssertionError(f"train_gnn card vs CPU: {got} against {want}")
    rel = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, want))
    if rel > LOSS_TOL:
        raise AssertionError(f"train_gnn card vs CPU: {got} against {want}")
    steps = SURFACE_TRAIN["steps"]
    print(f"  train_gnn{SURFACE_JOB} steps={steps} hidden="
          f"{SURFACE_TRAIN['hidden']}: card vs CPU losses at steps "
          f"{[h['step'] for h in card['history']]} max rel err {rel:.3e} "
          f"(limit {LOSS_TOL}); final test acc {card['final_acc']:.4f} vs "
          f"{ref['final_acc']:.4f}; fit {card['wall_s']:.2f} s on the card "
          f"({steps / card['wall_s']:.1f} steps/s, its capture and "
          f"{len(card['history'])} evaluations included), "
          f"{ref['wall_s']:.2f} s on the CPU beside the card's work",
          flush=True)
    print("    train_gnn row " + json.dumps({
        "phase": 25, "card_s": card["wall_s"], "cpu_s": ref["wall_s"],
        "steps_per_s": steps / card["wall_s"], "loss_rel_err": rel,
        "final_acc": card["final_acc"], "card": label}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only",
                    choices=["kernels", "gnn-times", "lm-times", "lm",
                             "runtime", "graphs", "engine", "examples",
                             "analysis", "ep", "ranks", "multicard",
                             "dryrun", "surface", "cache",
                             "softmax-times"],
                    default=None,
                    help="kernels: stop after phase 3 (build and check the "
                    "kernels); gnn-times: phases 1-3 and the GNN kernels' "
                    "times; lm-times: phases 1-3 and the LM kernels' "
                    "times; lm: those and phases 12-13 and 17-19; runtime: "
                    "phases "
                    "1-2 and 11; graphs: phases 1-2 and 14; engine: "
                    "phases 1-2 and 15; examples: phases 1-2 and 16; "
                    "analysis: phases 1-2 and 20; ep: phases 1-2 and 21; "
                    "ranks: phases 1-2 and 22; multicard: phases 1-2 and "
                    "23, on four cards; dryrun: phases 1-2 and 24; "
                    "surface: phases 1-2 and 25; cache: phases 1-2 and "
                    "26; softmax-times: phases 1-2 and edge_softmax's "
                    "phase-6 times")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"\n== {name} == ({time.perf_counter() - t_start:.0f}s "
              "into the run)", flush=True)

    phase("1. device")
    resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    label = card_label()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{kind} x{torch.cuda.device_count()}; nvidia-smi: {label}")

    phase("2. build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {sorted(build.SIGNATURES)} in "
          f"{time.perf_counter() - t0:.1f}s")

    if args.only == "runtime":
        phase("11. the fault-tolerant runtime (GAT-E, GCN)")
        runtime(label)
        return 0
    if args.only == "graphs":
        phase("14. CUDA graphs per bucket against eager")
        graph_phase(label)
        return 0
    if args.only == "engine":
        phase("15. the distributed engine (P=4 on one card)")
        engine_phase(label)
        return 0
    if args.only == "examples":
        phase("16. the examples")
        examples_phase(label)
        return 0
    if args.only == "analysis":
        phase("20. analysis on the card")
        analysis_phase(label)
        return 0
    if args.only == "ep":
        phase("21. Mixtral 8x7B's MoE under expert parallelism")
        ep_phase(label)
        return 0
    if args.only == "ranks":
        phase("22. NCCL at world 1: one rank holding P=4")
        world1_phase()
        return 0
    if args.only == "multicard":
        phase("23. four cards, four NCCL ranks")
        multicard_phase(label)
        return 0
    if args.only == "dryrun":
        phase("24. the dry-run against one card")
        dryrun_phase(label)
        return 0
    if args.only == "surface":
        phase("25. the Sum stage's public ops and train_gnn")
        surface_phase(label)
        return 0
    if args.only == "cache":
        phase("26. the cache contract at 200,000 nodes")
        cache_phase(label)
        return 0
    if args.only == "softmax-times":
        phase("6. edge_softmax times")
        softmax_times(label)
        return 0

    phase("3. kernels vs plain, on the card")
    errs = check_kernels()
    if args.only == "kernels":
        return 0

    # launches on the main paths: each path's counts are set to 0 just
    # before it runs and read just after; the JSON record sums them
    launches = {k: 0 for k in KERNELS}

    def count(got: dict) -> None:
        for k in launches:
            launches[k] += got[k]

    if args.only == "gnn-times":
        phase("6. kernel times (GNN)")
        kernel_times()
        return 0
    if args.only in ("lm-times", "lm"):
        phase("6. kernel times (LM zoo)")
        lm_kernel_times()
        if args.only == "lm":
            lm_phases(phase)
        return 0

    phase("4. serve GAT-E (alipay_like)")
    requests = 512
    got = serve("gnn_gat_e_alipay", label, requests)
    if got["edge_softmax"] <= 0:
        raise AssertionError("GAT-E serving launched no edge_softmax kernel")
    print(f"  {got['edge_softmax'] / requests:.3f} edge_softmax launches "
          "per served request")
    count(got)

    phase("26. the cache contract at 200,000 nodes")
    count(cache_phase(label))

    phase("5. serve GCN (reddit_like + self-loops)")
    got = serve("gnn_gcn_reddit", label, requests)
    if got["segment_sum"] <= 0:
        raise AssertionError("GCN serving launched no segment_sum kernel")
    print(f"  {got['segment_sum'] / requests:.3f} segment_sum launches per "
          "served request")
    count(got)

    phase("6. kernel times")
    rows = kernel_times()
    rows.update(lm_kernel_times())

    phase("7. train GAT-E (alipay_like)")
    # NN-G gathers n, as and ad at both edge ends: 6 takes a layer
    count(train("gnn_gat_e_alipay", label, "edge_softmax_bwd", 2, 12))

    phase("8. train GCN (reddit_like + self-loops)")
    # n at both edge ends: 2 takes a layer
    count(train("gnn_gcn_reddit", label, "segment_sum_bwd", 2, 4))

    phase("9. serve SAGE-max (reddit_like)")
    got = serve("gnn_gcn_reddit", label, requests, model_name="sage_max")
    if got["segment_max"] <= 0:
        raise AssertionError("SAGE-max serving launched no segment_max "
                             "kernel")
    print(f"  {got['segment_max'] / requests:.3f} segment_max launches per "
          "served request")
    count(got)

    phase("10. train SAGE-max (reddit_like)")
    # layer 0 pools the raw features, which take no gradient: two forward
    # launches and one backward launch per step; n at both edge ends, with
    # a gradient or without: 2 takes a layer
    got = train("gnn_gcn_reddit", label, "segment_max_bwd", 1, 4,
                model_name="sage_max")
    if got["segment_max"] != 2 * 3 * TRAIN_STEPS:
        raise AssertionError(f"SAGE-max training: {got['segment_max']} "
                             "segment_max launches, expected 2 per step")
    count(got)

    phase("11. the fault-tolerant runtime (GAT-E, GCN)")
    count(runtime(label))

    phase("14. CUDA graphs per bucket against eager")
    count(graph_phase(label))

    phase("15. the distributed engine (P=4 on one card)")
    count(engine_phase(label))

    phase("16. the examples")
    count(examples_phase(label))

    for got in lm_phases(phase):
        count(got)
    phase("21. Mixtral 8x7B's MoE under expert parallelism")
    count(ep_phase(label))
    phase("22. NCCL at world 1: one rank holding P=4")
    count(world1_phase())
    phase("24. the dry-run against one card")
    count(dryrun_phase(label))
    phase("25. the Sum stage's public ops and train_gnn")
    count(surface_phase(label))
    phase("20. analysis on the card")
    analysis_phase(label)
    phase("done")

    record = {"kernels": [
        {"name": k, "route": "cuda", **KERNELS[k],
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"],
         "bound_ms": rows[k]["bound_ms"], "bound_by": rows[k]["bound_by"],
         "library_ms": rows[k]["library_ms"]} for k in KERNELS]}
    print()
    print(label)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
