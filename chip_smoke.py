#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voltrix_spmm_tpu_torch) on one
NVIDIA GPU of the Hopper generation (sm_90a, an H100).

    python3 chip_smoke.py

It imports neither jax nor the JAX package. Phases, each of which exits
non-zero on failure (there is no CPU fallback):

1. Device: the card's name and count, and nvidia-smi's name and power
   limit. No CUDA device -> exit 1 before anything else.
2. Build: the native preprocess (csrc/voltrix_preprocess.hpp, g++),
   kernels K1 (csrc/spmm_block.cu), K2 (csrc/spmm_subtile.cu), K3
   (csrc/spmm_fused.cu), K4 (csrc/spmm_weighted.cu), K5
   (csrc/spmm_dvalues.cu), K6 (csrc/spmm_ell.cu), K7
   (csrc/spmm_ell_dvals.cu), K14 (csrc/attn_mh_dq.cu), K15
   (csrc/attn_mh_dkv.cu), K9 and K13 (csrc/attn_fwd.cu), K10
   (csrc/attn_bwd.cu), K8 (csrc/spmm_int8.cu) and K9 and K13 at
   compute_dtype=bfloat16 (csrc/attn_fwd_bf16.cu) and float16
   (csrc/attn_fwd_f16.cu; both instantiate csrc/attn_fwd_half.cuh), one
   nvcc each, all started together, into build/kernels/, while path C's
   protein proxy is made on a thread of its own. K11 and K12 are the kernels of
   K14 and K15 launched with one head and float32 planes; the compute
   variants of K10, K14 and K15 (compute_dtype=bfloat16 in the backward)
   are template instances in the same sources. The SASS of
   every .cu source under csrc/ holds no atomic instruction
   (tools/sass_atomics.py).
3. Each kernel against its plain version on the card, on several plan
   geometries: calc_diff < 1e-6 and allclose(rtol=1e-5, atol=1e-4)
   (float32 sums in another order, so not bit-equal); K1 and K2 also on a
   power-law graph whose hub window is cut into >= 16 pieces, a window of
   exactly 2 x PIECE_BLOCKS blocks, d 130 (4-byte copies) and features 4
   bytes past a 16-byte boundary (the hub rows under the float32
   summation bound of their degrees); K1 also on a padded, rectangular
   sampled hop (data.sample_block: 512 seeds, fanout 25, PlanConfig(32,
   128)) at d 128 and its transpose at d 256, whose padding blocks fill
   the last window, cut into >= 16 empty pieces, each twice
   bit-identical; K4 also on its work list (a
   power-law hub window cut into >= 16 pieces, a window of exactly 2 x
   PIECE_BLOCKS["spmm_weighted"] blocks, d 130, values off the bitmask on
   cut windows; values and features from a generator of their own); K5
   also exactly 0.0 off the bitmask, and on its work list twice on one
   input, bit-identical (block_w 256, bits on rows at num_nodes and beyond,
   0.0 there, hind outside the source rows, hub windows cut into pieces,
   two 128-row groups, three words a group, d 8-100 and 13, empty windows;
   features and dO from a generator of their own); K7 exactly 0.0 on
   padding lanes; K3
   also on its work list and both its walks (a power-law hub window cut
   into >= 16 pieces on J.2's geometry PlanConfig(128, 128, 8) at d 128 and
   256, d 8, 130 and 300, features 4 bytes past a 16-byte boundary, a tail
   run past n at d 8 and 256, empty windows of both kinds at d 8 and 256,
   runs across the 128-lane tiles on PlanConfig(128, 384) at seg 12-192;
   features from a generator of their own), K7 also at d 256 and 300 on
   its wide kernel, on misaligned features at d 256 and on power-law hub
   windows with padding lanes cut into pieces (from a generator of their
   own). K13-K15 (out, lse, dq, dk, dv) with float32 and bf16 planes:
   calc_diff < 1e-6 and allclose(rtol=1e-4, atol=1e-5 x max|plain|); rows
   without edges exactly 0 with lse exactly 1e30; K13, K14 and K15 twice
   on each input, bit-identical. K9-K12 (out, lse, K10's dq and lane
   planes, K10 with its fixed-order sum against the plain backward and
   scatter_lanes, dq, dk, dv) on head 0 of the same problems, to the same
   tolerance; K10's lane planes exactly 0 on lanes without bits; K11 and
   K12 twice on each input, bit-identical. K9 and K10
   also on their work list (from a generator of their own): a power-law
   hub window cut into >= 16 pieces at d 8, 12 and 40 and at d 40 with
   rows 4 bytes past a 16-byte boundary, a tail window past n at d 12
   likewise, empty windows of both kinds at d 40; and twice on each of
   these inputs, bit-identical (out, lse, dq, summed dk and dv). K8
   (int8 rows, bf16 dequantization) on 15 geometries under the same
   tolerance: its plain version dequantizes the same int8 rows the same
   way, so only the order of the float32 sums differs; K8 also on K1's
   cases (a power-law hub window cut into >= 16 pieces, a window of
   exactly 2 x PIECE_BLOCKS["spmm_int8"] blocks, d 130: int8 rows of 132
   bytes), the hub rows under the float32 summation bound, on features
   of a generator of their own.
4. The paths, each driven through the entry points a user calls, with
   every count set to 0 just before and read just after:
   A. GCN serving on the ogbn-arxiv proxy (169,343 nodes),
      PlanConfig(128, 128), 128 -> 256 -> 40: K1 twice per request; then
      GCN training on the same graph, 3 SGD steps: K1 3 times per step.
      K1 runs twice on the same input at d 128 and must give the same bits.
      A, B, F, J.1 and J.2 print what K1's or K2's work list gives their
      plans, I and C K8's: pieces, windows cut, the heaviest piece's work
      against the mean, the workspace.
   I. On A's plan, 3 requests of spmm(plan, x, impl="int8") at d 128 and 3
      at d 256: K8 once each; its output against a float64 host product of
      the same bf16-dequantized features (the first and last 2,048 rows)
      and against K1's float32 output (relative error < 2e-2,
      tests/test_quant.py:41). K8 also runs at d 256 on path C's plan;
      on A's plan (d 128) and on C's, K8 runs twice on the same input and
      must give the same bits.
   J. On A's graph: (1) build_graph(..., stream_chunks=4) with A's GCN: 3
      requests (K1 2 x 4 each) whose logits equal path A's bit for bit,
      step-0 loss and gradients equal to the unstreamed graph's, 3 SGD
      steps (K1 3 x 4 each); (2) csr_preprocess_hybrid with the JAX
      package's defaults: 3 spmm requests at d 128 and 3 at d 256 (K3 and
      K1 once each) against K1 on A's plan and the plain path, a
      torch.profiler breakdown at d 128, and spmm_ad's gradient against
      the plain path; K3 alone on the dense side against its plain
      version, twice on one input (the same bits), timed beside
      torch.sparse.mm on the dense side's CSR, with its bound and work
      list.
   B. GCN serving on the same graph, PlanConfig(2048, 128,
      block_unroll=4, cluster_cols=True): K2, which also runs twice on the
      same input at d 128 and must give the same bits.
   D. GAT serving and training on the same graph with self-loops
      (2,083,571 nnz), PlanConfig(64, 128), 128 -> 8 heads x 8 (ELU) ->
      40: K4 9 times per request; K4 18 and K5 9 times per Adam step. It
      prints the set-up cost of the edges' orders (edge_orders), K4's work
      list (pieces, windows cut, workspace) and the layer-2 scores within
      rounding of leaky_relu's kink and the edges whose sign differs
      between the kernel and the plain path. K4 runs twice on the same
      input at d 8 and d 40, and on A^T's plan at d 40, and must give the
      same bits, and so must K5 at d 8 and 40; so must step 0's kernel-path
      gradients, taken twice. K5's work list is printed.
   E. Dot-product GAT serving and training on D's graph, ELL plans
      PlanConfig(128, 128, block_unroll=4), 128 -> 8 heads x 8 (ELU) ->
      40: K6 and K7 9 times per request; K6 36 and K7 18 times per Adam
      step. It prints the scores within rounding of leaky_relu's kink in
      both layers and the edges whose sign differs between the kernel and
      the plain path. K6 runs twice on the same input at d 8 and d 40
      (and on F's plan at d 256) and must give the same bits, and so must
      K6 on 4 window chunks of the plan (spmm_ell_streamed); K7 likewise
      at d 8 and 40 (and on F's plan at d 256, its wide kernel).
   F. GCN link prediction on the ogbl-ddi proxy (4,267 nodes, 2,571,386
      nnz), GCN 256 -> 256 -> 256 on PlanConfig(128, 128) (K1), SDDMM
      scores over the edges and as many sampled non-edges (ELL plan,
      PlanConfig(128, 128)): K1 2 and K7 1 per scoring request; K1 3, K7 1
      and K6 2 per Adam step. K1 is also held to its plain version and
      timed at d 256 on F's plan.
   G. Flash GAT serving and training on D's graph, PlanConfig(128, 128,
      block_unroll=4), 128 -> 8 heads x 8 (ELU) -> 40, bf16 planes (the
      JAX package's rule at >= 65,536 nodes): K13 twice per request; K13,
      K14 and K15 twice each per Adam step. With bf16 planes float32 noise
      may move a layer-2 input across a bf16 rounding boundary, so logits
      and step-0 gradients are held to the bf16 class (calc_diff < 1e-4,
      rtol and atol 2e-2, gradients 1e-2 x max|grad|); the same model
      with float32 planes is held to rtol and atol 1e-4 (gradients 1e-4 x
      max|grad|: a hub row's dq sums ~38k terms whose coefficients add up
      to 0). Request 0's logits twice, bit-identical; step 0's
      kernel-path gradients twice, bit-identical, with bf16 and with
      float32 planes. At each layer, on the node-major projections the
      model passes: K13's, K14's and K15's work lists (pieces, windows
      cut, the heaviest piece against the mean, workspace; three lists,
      each under its own name, though plan_t is plan), K13, K14 and K15
      twice on one input, bit-identical, and K13 timed in turns beside
      head-major copies of q, k and v made in the call and K13 on those.
   H. Flash GAT on a bare plan, G's graph, plan geometry and widths, one
      head at a time in float32 (the JAX package's per-head path): K9 9
      times per request; K9 and K10 9 times each per Adam step (K10's lane
      planes summed into source rows in a fixed order inside K10, no
      index_add_); logits and step-0 gradients against the plain path to
      rtol / atol 1e-4 (gradients 1e-4 x max|grad|, G's float32 rule), and
      step 0's kernel-path gradients twice, bit-identical; K9 (out, lse)
      and K10 (dq, summed dk and dv) twice on one input at d 8 and 40,
      bit-identical, and K11 and K12 likewise; K9 timed in turns beside
      K13 at one head (float32 planes), K10 beside K11 + K12, and
      scatter_lanes (index_add_) on K10's planes. Then the split backward,
      spmm_attention_ad(plan, q, k, v, plan_t=plan) at a layer-1 head (d 8)
      and at layer 2 (d 40): K9, K11 and K12 once each per width, its
      gradients against the plain ones and against K10's.
   K. On A's graph and plan, OGB's arxiv widths 128 -> 256 -> 40, each
      model 3 requests and 3 Adam steps (lr 5e-3): SAGE (mean; K1 2 a
      request, 3 a step), GIN (sum, learnable eps; 2 and 3), APPNP (K 10,
      alpha 0.1; 10 and 20), an 8-layer residual GCN (mean; 8 and 15, with
      remat=True 8 and 21: the backward recomputes the 6 hidden layers;
      both forwards bit-identical, both steps' time and peak memory),
      R-GCN (4 relations drawn by a seeded rng over A's CSR entries, each
      directed with its own transpose plan, 2 bases; 8 and 12); then
      DropEdge on build_dropedge_graph(A) (PlanConfig(64, 128)) at d 128
      and 256, keep_prob 0.8: the training call and its backward (K4
      twice) and the eval call (K1 once), each against the plain path on
      the same mask (the CUDA generator's state replayed) and twice
      bit-identical. Logits against the plain path at calc_diff < 1e-6,
      rtol 1e-4 and atol 1e-4 x max(1, max|plain|) (sum aggregations
      scale logits by degrees in the thousands).
   L. Neighbour-sampled GraphSAGE on A: 3 Adam steps (lr 1e-2,
      examples/train_sage_minibatch.py) on batches of 512 seeds drawn by a
      seeded rng, sample_blocks with fanouts [10, 25] on PlanConfig(32,
      128), SAGE 128 -> 256 -> 40: K1 3 a step (each hop's plan, the seed
      hop's transpose; the deep hop's transpose stays on the host);
      sampling, plan building, the move to the card, the work lists and
      the step timed apart, sample_blocks against its two timed halves,
      the plans' work lists printed; step 0's gradients and batch 0's
      logits (twice bit-identical) against the plain path; then
      sage_inference over A's graph on PlanConfig(32, 128), K1 2 a request.
   N. The deployment path on A's graph and widths (128 -> 256 -> 40): A's
      plan by the native preprocess and by the numpy path, timed, bit for
      bit (and C's by the native preprocess, timed, beside path C); A's
      plan saved dense and packed,
      loaded back bit for bit and validated (validate_plan, and the CLI in
      a process of its own); the CLI's info, preprocess (--backend native
      --packed, A's plan bit for bit), validate and spmm (on the card,
      against scipy) each in a process of its own; export_servable and
      save_bundle of the GCN request on A's plan (K1) and on B's (K2) and
      of spmm on J.2's hybrid plan (K3 + K1); two fresh processes that
      import only voltrix_spmm_tpu_torch.serve (chip_smoke.py
      --serve-bundles) load the bundles, answer 3 requests each (logits
      bit for bit the eager path's, and within the path's limit of the
      plain path), show K1, K2 and K3 launched from the loaded programs
      (counts and torch.profiler's kernel names) and the bundle's plan
      among the program's constants, and time the cold start (load, plan
      to the card, first request) without and with aot_compile's warm
      call; the loaded programs timed in turns against the eager path;
      compiled_stats of A's request (flops exact), a checkpoint round trip
      of A's trained parameters (logits bit for bit), spmm_tuple on the
      card against the plain version, profile_op and attribute_spmm on A's
      request, and the host microseconds of a K1 call: the wrapper, the
      registered op alone, and the bare launch, in turns; and of a call of
      each op of K4-K15 on 256-node plans at d 8: the wrapper and the op
      alone (bit for bit the wrapper's), in turns. Where their paths hold
      the model, the graph and the eager logits, the requests of D (GAT,
      K4), E (dot-product GAT, K6 and K7; bundled without a plan, the ELL
      plan beside the bundle), G (flash GAT on (plan, plan_t), bf16
      planes, K13), H (flash GAT per head on the bare plan, K9) and I
      (spmm(plan, x, impl="int8") on A's plan at d 128, K8) are exported
      at their paths' full width, the programs' graphs holding the paths'
      voltrix ops, bundled, and timed in turns against the eager request;
      after H two fresh processes (without and with aot_compile) serve the
      five bundles as above: logits bit for bit the eager path's, each
      kernel's launches a request, torch.profiler's kernel names, the
      plans among the programs' constants, cold start and bundle bytes.
   M. GIN graph classification on examples/train_graph_classify.py's
      corpus: 128 graphs of 30-80 nodes (dense or rings) in one
      block-diagonal batch, PlanConfig(128, 128), 16 -> 64 -> 2, sum
      readout: 1 request (K1 2) and 3 Adam steps (K1 3 each).
   C. GCN serving on the protein proxy (132,534 nodes, 79.0M nnz),
      PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
      8 -> 256 -> 112 (OGB's ogbn-proteins GCN widths): K3, which runs
      twice on the same input at d 8 and at d 256 and must give the same
      bits; its work list and workspace are printed.
   O. The tuner on the card (voltrix_spmm_tpu_torch/tuner), each race in a
      fresh cache (build/tune, removed after), features and values from a
      generator of its own. O.1 (after M): tune_spmm on A's graph at d 128,
      the default space, orderings identity and rcm, budget_s 120; every
      candidate's key, plan build seconds, ms (gpu_bench: the median of 8
      CUDA-event launches, each after an L2 flush) and why it was skipped;
      the winner beside K1 on PlanConfig(128, 128) and torch.sparse.mm
      (printed, never raced), its output against a float64 host product,
      its kernel's counter moved; a second call a memory hit, a new
      SpmmTuner on the same directory a disk hit that launches nothing,
      bit for bit; a 1-variant space with isolate=True (a probe process
      per candidate). O.4 (after H): tune_attention on G's graph at H 8 x
      d 8, mode "train", budget_s 60; the winner's out, dq, dk and dv
      against the plain versions at phase 3's K13-K15 tolerance, K13, K14
      and K15 once each. O.3 (after F): tune_spmm on F's graph at d 256 and
      the weighted race (K6 and K4) on it with random values. O.2 (after
      C): tune_spmm on C's graph at d 256, budget_s 12, past 4 GiB of
      edge features: the residency-budgeted space, each candidate in a
      probe, the estimates printed, the winner against a float64 host
      product on the first and last window's rows. O.3: build_graph("auto")
      on A, F and C, the config it picks and its SpMM timed beside the
      race's winner. O.5: `python -m voltrix_spmm_tpu_torch tune` once in a
      process of its own on rmat-15. Any candidate skipped for a reason
      other than a geometry refusal or out-of-memory, a plain version run
      in a race, or a raced kernel that never launched fails the path.
   P. (after O.1) The parallel trainers of voltrix_spmm_tpu_torch.parallel
      on A's graph at A's widths (128 -> 256 -> 40, PlanConfig(128, 128),
      3 SGD steps at lr 0.01), each rank a process of parallel.comm.launch:
      all five modes on one rank under NCCL (row-sharded, ring, hybrid
      1 x 1, grid2d 1 x 1, dp x tp 1 x 1), then 4 ranks sharing cuda:0
      under gloo (row-sharded degree-balanced, ring, hybrid 2 x 2, grid2d
      2 x 2, dp x tp 2 x 2 on 2 feature sets); then parallel.dryrun.dryrun_multichip on 4 ranks of
      the card (n 2048, d 128). Each mode's 3 losses (rel < 1e-4) and
      updated parameters (max|d| / max|p| < 1e-4) against the
      single-process step on A's whole plan (K1), its step-0 logits
      against a float64 host forward on the first and last 2,048 rows,
      K1 3 launches a rank a step (3 x ranks on the ring and hybrid) and
      no plain SpMM in any rank, every rank's parameters and losses alike;
      prints the plans' set-up seconds, rank 0's step times (CUDA events;
      ranks sharing one card, not a scale-out time), the collectives'
      bytes a step, each rank's peak memory, and the collectives staged
      through host memory (parallel.comm.STAGED). A failed rank fails the
      run.
   Q. bf16 feature sources, the bf16 instantiations of K1, K2, K3 and K6
      (counted apart, "<kernel>_bf16"), each drive through a user's call:
      Q.1 spmm(hybrid plan, x.bfloat16()) on J.2's plan at d 128 and 256
      (K3 and K1, REQUESTS each), bit for bit the float32 hybrid on the
      widened rows; REQUESTS GCN requests under agg_dtype=torch.bfloat16 on
      B's graph (K2) and C's (K3), logits within calc_diff 1e-2 of the
      float32 path's; REQUESTS spmm(ELL plan, x.bfloat16()) at d 8 and 40
      on E's graph and geometry (K6); then each kernel on its path's plan at
      the path's widths (K1 A's d 128 / 256, K2 B's, K3 C's d 8 / 256 and
      J.2's dense side, K6 E's d 8 / 40): bit for bit the float32 kernel on
      the widened rows, twice the same bits, against its plain version
      under the summation bound, timed in turns with the float32 kernel
      beside its plain version and torch.sparse.mm (on bf16 operands where
      torch's CSR takes them), with its bound (X's bytes halved). Q.2 A's
      GCN with agg_dtype=torch.bfloat16: REQUESTS requests (K1's bf16
      instantiation twice each) and STEPS SGD steps (3 K1 launches each, the
      two forwards bf16, the backward float32 on the cotangent), no plain
      call; request 0's logits within calc_diff 1e-2 of the float64 host
      forward and every request's of the float32 path, step 0's gradients
      within calc_diff 1e-2 of the float32 step's; request and step timed
      in turns with the float32 path, busy share, peak memory. Q.3
      tune_spmm(accurate=False) on A at d 128 (the bf16 variants race
      beside the float32 ones): the winner, the best of each dtype, the
      output in the caller's float32. Q.4 build_graph("auto") on A keeps
      agg_dtype None (float32 rows, models/graph.py). Phase 3 also
      holds the four bf16 instantiations on small geometries (padded rows
      at d 130 and 300, rows 2 bytes off an 8-byte boundary, hub windows
      cut into pieces, K3's narrow and wide walks and runs across tiles at
      seg 12-192, K6 under compute_dtype=bfloat16), bit for bit the float32
      kernel on the widened rows. Path O races the float32 default space
      (accurate=True), as it did before the bf16 variants joined it.
   R. bf16 on K4, K8, K9 and K13, and compute_dtype=bfloat16 in the
      backward (counted apart: spmm_weighted_bf16, spmm_int8_bf16,
      attn_fwd_bf16, attn_mh_fwd_bf16; attn_bwd_bf16, attn_dq_bf16,
      attn_dkv_bf16, attn_mh_dq_bf16, attn_mh_dkv_bf16), after Q on A, after
      H on the graph with self-loops, and after C: R.1 DropEdge on A
      (build_dropedge_graph, PlanConfig(64, 128), keep 0.8) on bf16 rows at
      d 128 and 256, REQUESTS training calls with their backward (K4's bf16
      instantiation twice each), out and dx within calc_diff 1e-2 of the
      float32 path on the same draws and mask, timed in turns with it, busy
      share, peak memory. R.2 K4 on bf16 rows with a float32 and a bf16
      plane on D's plan geometry at d 8 and 40 and K.6's DropEdge plan at
      d 128 and 256: bit for bit the float32 K4 on the widened inputs, twice
      the same bits, against its plain version under the summation bound,
      timed in turns with the float32 K4 beside torch.sparse.mm on bf16
      operands, with its bound (rows and plane in bf16). R.3 REQUESTS
      spmm(plan, x.bfloat16(), impl="int8") on A's plan at d 128 and 256 and
      one on C's at d 256: the codes and scales of quantize_rows on the card
      equal the CPU's, a bf16 output (K8's float32 output rounded once),
      K8 against its plain version under the summation bound, timed with
      the float32 call, torch.sparse.mm on the dequantized bf16 rows and its
      bound. R.4 spmm_attention_mh(..., compute_dtype=torch.bfloat16) at
      G's geometry (H 8 x d 8 and H 1 x d 40, float32 and bf16 planes) and
      spmm_attention on H's plan at d 8 and 40: out and lse against the
      plain version at phase 3's attention tolerance, twice the same bits,
      rows without edges 0 / 1e30, timed in turns with compute_dtype
      float32. R.5 an int8 request on bf16 rows and a K13 request under the
      flag, exported and loaded in this process: the voltrix op alone, the
      eager bits. R.6 the backward under the flag on the same plan:
      REQUESTS forward-and-backward calls of spmm_attention_mh_ad(...,
      compute_dtype=torch.bfloat16) at H 8 x d 8 and H 1 x d 40 with float32
      and bf16 planes (K13's bf16 kernel, K14's and K15's compute variants)
      and of spmm_attention_ad under the flag at d 8 and 40 with plan_t
      (K9's bf16 kernel, K11's and K12's compute variants) and without (K10's),
      each drive's gradients against the plain backward on the kernel
      forward's out and lse (atol 1e-4 x max|grad|, G's step-0 rule) and
      against impl="reference" in the bf16 class (calc_diff < 1e-6, rtol and
      atol 2e-2 x max|grad|: the plain forward's lse differs in the last
      bits, and a p or draw rounded to bf16 may land on the neighbouring
      value); each compute variant against its plain version on the same
      out, lse and D at calc_diff < 1e-8, twice the same bits, timed in
      turns with its compute-float32 kernel beside its plain version and
      the float32 row's bound. Phase 3 also holds K4's bf16 instantiations on its work
      list's geometries (a hub window cut into >= 16 pieces, a window of
      exactly 2 x PIECE_BLOCKS blocks, d 130 and 300, rows 2 bytes off an
      8-byte boundary, values off the bitmask on cut windows; float32 and
      bf16 planes), bit for bit the float32 K4 on the widened inputs, and
      K9 and K13 at compute_dtype=bfloat16 and the compute variants of
      K10-K12, K14 and K15 (calc_diff < 1e-8, twice the same bits) on each
      of its attention problems (hub windows cut into pieces, empty windows,
      widths not a multiple of 4, d 300). Path R prints its seconds; the run
      prints each part's seconds beside the total.
   S. float16 feature sources, the float16 instantiations of K1, K2, K3 and
      K6 (counted apart, "<kernel>_f16"), after Q on A, B, E and C, each
      drive through a user's call: S.1 A's GCN with agg_dtype=torch.float16,
      REQUESTS requests (K1's float16 instantiation twice each) and STEPS SGD
      steps (twice each; the backward runs the float32 instantiation on the
      cotangent, whose values are float16 ones), logits and loss against the
      float32 GCN on the same weights and logits against the float64 host
      forward at calc_diff < 1e-2 x 2**-6 (Q.2's bf16 limit scaled from 8
      significant bits to 11), step 0's gradients against the plain path
      under the same aggregation and, with the loss scaled by 2**16, against
      the float32 path, at that limit (unscaled, the mean loss's float16
      cotangent is subnormal: printed); request and step in turns with the
      float32 and bf16 paths, busy share, peak memory. S.2 one
      spmm(hybrid plan, x.half()) on J.2's plan at d 128 and one at d 256
      (K3 + K1), bit for bit the float32 hybrid on the widened rows; one GCN
      request of B (K2) and of C (K3); one spmm(ELL plan, x.half()) on E's
      plan at d 8 and one at d 40 (K6). S.3 each float16 instantiation on
      its path's plan at its widths: bit for bit the float32 kernel on
      x.half().float(), twice the same bits, against its plain version, once
      under compute_dtype=torch.float16 on float32 rows (K6: its edge values
      rounded in the kernel; the float32 kernel's bits on the rounded
      operands), timed in turns with the float32 and bf16 kernels, beside
      its plain version and torch.sparse.mm on float16 operands, with its
      bound (X in float16). S.4 one exported float16 aggregate of A, loaded
      in the same process, the eager call's bits. Phase 3 holds the four
      float16 instantiations on the bf16 cases' geometries (features from a
      generator of their own), and K4's float16 instantiations on float16
      rows with each plane type on its work list's geometries (a hub window
      cut into >= 16 pieces at d 40 and 130, rows 2 bytes off an 8-byte
      boundary, values off the bitmask on cut windows). S.5-S.9 mirror R.1-R.5
      on float16 (the same functions, by type; "<kernel>_f16" counts
      wrapper.launches_f16), after R on A, after R on the graph with
      self-loops and after R.3 on C: S.5 DropEdge on A on float16 rows
      (float16 planes) at d 128 and 256, REQUESTS training calls with their
      backward, against the float32 path in the float16 class, timed in turns
      with the float32 and bf16 rows. S.6 K4 on float16 rows with a float32,
      a bf16 and a float16 plane on D's plan geometry at d 8 and 40 and K.6's
      DropEdge plan at d 128 and 256: bit for bit the float32 K4 on the
      widened inputs, twice the same bits, against its plain version, timed
      in turns with the float32 and the bf16 K4, beside torch.sparse.mm on
      float16 operands, with its bound (rows and plane in float16). S.7
      spmm(plan, x.half(), impl="int8") on A's plan at d 128 and 256
      (REQUESTS each) and once on C's at d 256, with a zero row and a row of
      largest value 3e-6 planted: the card's codes and scales equal the
      CPU's (both scales 0), K8 alone timed in turns with K8 on the codes of
      the float32 and the bf16 rows. S.8 K13 under compute_dtype=float16 at
      G's geometry (float32 and bf16 planes) and K9 on H's plan at d 8 and
      40: within calc_diff 1e-8 of the plain version, twice the same bits,
      timed in turns with compute_dtype float32 and bfloat16; K13 on a bf16
      plane whose k reaches 70,144 (inf in float16): the plain version's NaN
      rows, lse 1e30 there. S.9 an int8 request on float16 rows and a K13
      request under compute_dtype=float16, exported and loaded in this
      process.
   Every other kernel and every plain version is launched 0 times. Logits
   must match the same forward with impl="reference" (rtol=1e-4,
   atol=1e-4), and for A-C a float64 host forward (C: the rows of the
   first and the last window); F's scores must match the plain path's
   (calc_diff < 1e-6, allclose rtol 1e-4, atol 1e-4 x max|score|) and so
   must their AUC. A training step 0's loss and gradients must match the
   plain path's (calc_diff < 1e-6, allclose rtol 1e-4, atol 1e-5 x
   max|grad| for GAT, 5e-5 x max|grad| on D, where the plain path's own
   gradients differed from run to run by up to 1.5e-5 x max|grad| while
   both paths summed with float atomics
   (voltrix_spmm_tpu_torch/tools/grad_spread.py), 1e-3 x max|grad| for
   GCN, whose ReLU may switch on an input within float32 noise of 0); the
   loss after 3 steps must be
   finite, and for D, E, F and G below step 0's. Each path's kernels are
   held against their plain versions at the path's widths, under the
   float32 summation bound of their rows.
5. Timing with CUDA events, in turns (plain, kernel, kernel, plain): each
   kernel and its plain version at its path's widths, the one PyTorch
   call that computes the same function (torch.sparse.mm on the CSR for
   K1-K4 and K6, and for K8 on the dequantized features, dequantized
   outside the timed call; torch.sparse.sampled_addmm for K5 and K7; none for
   K9-K15, as no single call computes masked-softmax attention over a
   sparse pattern), the request and the training step on the kernel path
   and on the plain path; each kernel's
   bound (bytes over 3.35 TB/s or float32 flops over 67 TFLOP/s, the
   larger); torch.profiler's device time by kernel, and the share of the
   profiled wall time the card was busy.

Before the last line come a JSON object describing each kernel and then
nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import resource
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = dict(rtol=1e-5, atol=1e-4)  # tests/test_spmm.py:51-52
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
REQUESTS = 3
STEPS = 3
# path P: each parallel mode's loss rel and update max|d| / max|p| against
# the single-process step; a fault that scales a gradient 2x moves them
# 10x past it or path P fails (the faults are computed in the run)
P_GATE = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory peak rate
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# each kernel's key in this script -> (its module under voltrix_spmm_tpu_torch.ops,
# the wrapper whose `launches` counts it, its torch.library op in the voltrix
# namespace, ops/library.py); every call of a kernel goes through its op
KERNEL_OPS = {
    "spmm_block": ("block_spmm", "spmm_block", "spmm_block"),
    "spmm_subtile": ("subtile_spmm", "spmm_subtile", "spmm_subtile"),
    "spmm_fused": ("fused_spmm", "spmm_fused", "spmm_fused"),
    "spmm_weighted": ("weighted", "spmm_weighted", "spmm_weighted"),
    "spmm_dvalues": ("weighted", "spmm_weighted_dvalues", "spmm_dvalues"),
    "spmm_ell": ("ell", "spmm_ell", "spmm_ell"),
    "spmm_ell_dvals": ("ell", "spmm_ell_dvals", "spmm_ell_dvals"),
    "attn_mh_fwd": ("attention_mh", "spmm_attention_mh", "spmm_attention_mh"),
    "attn_mh_dq": ("attention_mh", "attention_mh_dq", "attention_mh_dq"),
    "attn_mh_dkv": ("attention_mh", "attention_mh_dkv", "attention_mh_dkv"),
    "attn_fwd": ("attention", "spmm_attention", "spmm_attention"),
    "attn_bwd": ("attention", "attention_bwd", "attention_bwd"),
    "attn_dq": ("attention", "attention_dq", "attention_dq"),
    "attn_dkv": ("attention", "attention_dkv", "attention_dkv"),
    "spmm_int8": ("quant", "spmm_int8", "spmm_int8"),
}
REGISTERED = {key: op for key, (_, _, op) in KERNEL_OPS.items()}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` launches, after warm-up."""
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


def in_turns(torch, kernel, plain, plain_iters=3):
    """(kernel ms, plain ms, the four readings): plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, iters=plain_iters, warmup=1)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain, iters=plain_iters, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def in_turns_n(torch, fns, iters: int = 20):
    """(mean ms of each fn, the readings): each fn timed in order, then in
    reverse order (a, b, c, c, b, a), each mean of its two readings."""
    order = [*range(len(fns)), *reversed(range(len(fns)))]
    readings = [cuda_ms(torch, fns[i], iters=iters) for i in order]
    means = [sum(r for i, r in zip(order, readings) if i == k) / 2 for k in range(len(fns))]
    return means, readings


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, the larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def csr_tensor(torch, a, dev, values=None):
    """scipy CSR `a` as a torch sparse CSR tensor on `dev` (ones, or
    `values` in CSR order): the operand of the library calls."""
    if not a.has_sorted_indices:
        if values is not None:
            fail("csr_tensor: values of a CSR whose rows are not sorted")
        a = a.sorted_indices()
    vals = torch.ones(a.nnz, dtype=torch.float32) if values is None else values
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)), torch.from_numpy(a.indices.astype(np.int64)),
        vals.float().cpu(), size=a.shape).to(dev)


def plan_csr(plan):
    """The binary CSR (num_nodes x source_rows, scipy) of a plan's bits:
    row w * block_h + 32 * word + bit, column hind of the bit's lane."""
    import torch

    shifts = torch.arange(32, dtype=torch.int32, device=plan.bitmask.device)
    b, wi, j, bit = torch.nonzero((plan.bitmask.unsqueeze(-1) >> shifts) & 1, as_tuple=True)
    rows = plan.window_of_block[b].long() * plan.config.block_h + 32 * wi + bit
    cols = plan.hind[b, j].long()
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows.cpu().numpy(), cols.cpu().numpy())),
                      shape=(plan.num_nodes, plan.source_rows))
    a.sum_duplicates()
    return a


def grads_close(torch, calc_diff, got: dict, want: dict, atol_scale: float,
                max_diff: float = 1e-6, rtol: float = 1e-4):
    """(ok, worst calc_diff, worst max|diff| / max|grad|) of two gradient
    dicts: calc_diff < max_diff and allclose(rtol, atol atol_scale *
    max|grad|) for each parameter."""
    ok, worst_diff, worst_rel = True, 0.0, 0.0
    for k, w in want.items():
        g = got[k]
        scale = w.abs().max().item()
        diff = calc_diff(g, w)
        err = (g - w).abs().max().item()
        print(f"    grad {k} {tuple(w.shape)}: calc_diff {diff:.3e}, max|diff| {err:.3e}, "
              f"max|grad| {scale:.3e}")
        worst_diff, worst_rel = max(worst_diff, diff), max(worst_rel, err / max(scale, 1e-30))
        ok = ok and diff < max_diff and torch.allclose(g, w, rtol=rtol, atol=atol_scale * scale)
    return ok, worst_diff, worst_rel


def rows_only(a, keep):
    """`a` with every row r for which keep(r) is false emptied."""
    a = a.tolil()
    for r in range(a.shape[0]):
        if not keep(r):
            a.rows[r], a.data[r] = [], []
    return a.tocsr()


def host_forward(a, x0, params, rows=None):
    """Float64 GCN forward on the host (scipy CSR), mean aggregation, the
    same order as gcn_forward for in_dim <= 256. With `rows`, the second
    layer only for those rows."""
    a64 = a.astype(np.float64)
    inv_deg = 1.0 / np.maximum(np.asarray(a64.sum(axis=1)), 1.0)
    h = np.maximum((inv_deg * (a64 @ x0)) @ params["w1"] + params["b1"], 0.0)
    if rows is None:
        return (inv_deg * (a64 @ h)) @ params["w2"] + params["b2"]
    return (inv_deg[rows] * (a64[rows] @ h)) @ params["w2"] + params["b2"]


def profile_requests(torch, fn, requests: int = 3):
    """torch.profiler over `requests` calls of fn(): (kernel name, device
    ms per request) and (host op, count, host ms per request), largest
    first, and the profiled wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the profiler's own start-up
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3  # before the trace is processed
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            host.append((e.key[:50], e.count // requests, e.self_cpu_time_total / 1e3 / requests))
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
            continue  # host-side ops carry their kernels' time too
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key[:70], us / 1e3 / requests))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[2])
    return rows, host, wall


def print_profile(rows, host, wall, what, top=10):
    busy = sum(ms for _, ms in rows) * REQUESTS
    print(f"  profile of {REQUESTS} {what}s: {wall:.3f} ms wall, {busy:.3f} ms of kernels (busy "
          f"share {busy / wall:.3f}); device ms per {what} by kernel:")
    for key, ms in rows[:top]:
        print(f"    {ms:9.4f}  {key}")
    print(f"  host ms per {what} by op (self time, calls), {sum(ms for *_, ms in host):.3f} in all:")
    for key, count, ms in host[:5]:
        print(f"    {ms:9.4f}  {key} x{count}")


def main() -> None:
    import torch

    # --- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from voltrix_spmm_tpu_torch import (
        GAT, GCN, GATDot, GATFlash, PlanConfig, build_ell_graph, build_gat_graph, build_graph,
        build_link_candidates, calc_diff, csr_preprocess, csr_preprocess_ell,
        csr_preprocess_hybrid, dequantize_rows, gat_dot_loss, gat_dot_params_from_jax,
        gat_flash_loss, gat_flash_params_from_jax, gat_loss, gat_params_from_jax, gcn_loss,
        gcn_params_from_jax, hybrid_stats, lane_values, link_auc, link_pred_loss, link_scores,
        make_link_pred_step, make_train_step, relative_error, spmm, spmm_ad,
    )
    from voltrix_spmm_tpu_torch.data import (
        block_diagonal, chung_lu_csr, erdos_renyi_csr, gather_features, node_graph_ids, proxy_csr,
        sample_block, sample_blocks, symmetrize,
    )
    from voltrix_spmm_tpu_torch.data.sampling import _block_plans, _sample_edges
    from voltrix_spmm_tpu_torch.models import (
        APPNP, GIN, RGCN, SAGE, DeepGCN, GINClassifier, SageMinibatch, appnp_forward, appnp_loss,
        blocks_args, build_dropedge_graph, deep_gcn_forward, deep_gcn_loss, dropedge_aggregate,
        dropedge_weights,
        gin_classifier_forward, gin_classifier_loss, gin_forward, make_classifier_train_step,
        make_deep_train_step, make_rgcn_train_step, make_sage_minibatch_step, rgcn_forward,
        rgcn_loss, sage_forward, sage_inference,
    )
    from voltrix_spmm_tpu_torch.models.sage_minibatch import _forward as sage_blocks_forward
    from voltrix_spmm_tpu_torch.format import ell_stats, plan_stats, subtile_stats
    from voltrix_spmm_tpu_torch.jit import get_build_dir
    from voltrix_spmm_tpu_torch.runtime.native import build_libraries as native_build_libraries
    from voltrix_spmm_tpu_torch.tools import sass_atomics
    from voltrix_spmm_tpu_torch.models import edge_softmax, gat_attention_aggregate
    from voltrix_spmm_tpu_torch.models.gat import edge_orders
    from voltrix_spmm_tpu_torch.models.gat_ell import dot_attention_aggregate
    from voltrix_spmm_tpu_torch.models.gat_flash import _project_heads
    from voltrix_spmm_tpu_torch.ops._attn_core import (BWD_HEAD_GROUP, bwd_geometry,
                                                       load_fwd_bf16_library,
                                                       load_fwd_f16_library)
    from voltrix_spmm_tpu_torch.ops import (
        attention, attention_bwd, attention_bwd_reference, attention_bwd_summed, attention_dkv,
        attention_dkv_reference, attention_dq, attention_dq_reference, attention_mh,
        attention_mh_dkv, attention_mh_dkv_reference, attention_mh_dq, attention_mh_dq_reference,
        block_spmm, ell, expand_bitmask, fused_spmm, scatter_lanes, sddmm_ell, sddmm_ell_ad,
        spmm_attention,
        spmm_attention_ad, spmm_attention_mh, spmm_attention_mh_ad, spmm_attention_mh_reference,
        spmm_attention_reference, spmm_block, spmm_ell,
        spmm_ell_dvals, spmm_ell_dvals_reference, spmm_ell_reference, spmm_ell_streamed,
        spmm_fused,
        spmm_fused_reference, spmm_reference, spmm_subtile, spmm_subtile_reference,
        spmm_weighted, spmm_weighted_dvalues, spmm_weighted_dvalues_reference,
        spmm_weighted_reference, subtile_spmm, weighted, quant, spmm_int8, spmm_int8_reference,
    )
    from voltrix_spmm_tpu_torch.utils import gen_outlier_normal

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    F16 = torch.float16
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {kind} (count {count}); nvidia-smi name, power.limit: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 is off for matmul and cudnn: dense products run in full float32")

    # name -> (wrapper, plain version, source, TPU kernel it replaces, loader)
    kernels = {
        "spmm_block": (spmm_block, spmm_reference, "spmm_block.cu",
                       "voltrix_spmm_tpu/ops/pallas_spmm.py:165", block_spmm.load_library),
        "spmm_subtile": (spmm_subtile, spmm_subtile_reference, "spmm_subtile.cu",
                         "voltrix_spmm_tpu/ops/pallas_spmm.py:223", subtile_spmm.load_library),
        "spmm_fused": (spmm_fused, spmm_fused_reference, "spmm_fused.cu",
                       "voltrix_spmm_tpu/ops/pallas_spmm_fused.py:45", fused_spmm.load_library),
        "spmm_weighted": (spmm_weighted, spmm_weighted_reference, "spmm_weighted.cu",
                          "voltrix_spmm_tpu/ops/weighted.py:29", weighted.load_library),
        "spmm_dvalues": (spmm_weighted_dvalues, spmm_weighted_dvalues_reference,
                         "spmm_dvalues.cu", "voltrix_spmm_tpu/ops/weighted.py:151",
                         weighted.load_dvalues_library),
        "spmm_ell": (spmm_ell, spmm_ell_reference, "spmm_ell.cu",
                     "voltrix_spmm_tpu/ops/ell.py:35", ell.load_library),
        "spmm_ell_dvals": (spmm_ell_dvals, spmm_ell_dvals_reference, "spmm_ell_dvals.cu",
                           "voltrix_spmm_tpu/ops/ell.py:190", ell.load_dvals_library),
        # K13: beside K9 in attn_fwd.cu, on K9's row walk with a head group
        "attn_mh_fwd": (spmm_attention_mh, spmm_attention_mh_reference, "attn_fwd.cu",
                        "voltrix_spmm_tpu/ops/attention_mh.py:126",
                        attention.load_mh_fwd_library),
        "attn_mh_dq": (attention_mh_dq, attention_mh_dq_reference, "attn_mh_dq.cu",
                       "voltrix_spmm_tpu/ops/attention_mh.py:411",
                       attention_mh.load_dq_library),
        "attn_mh_dkv": (attention_mh_dkv, attention_mh_dkv_reference, "attn_mh_dkv.cu",
                        "voltrix_spmm_tpu/ops/attention_mh.py:499",
                        attention_mh.load_dkv_library),
        "attn_fwd": (spmm_attention, spmm_attention_reference, "attn_fwd.cu",
                     "voltrix_spmm_tpu/ops/attention.py:75", attention.load_fwd_library),
        # K11 and K12: K14's and K15's kernels at H = 1
        "attn_bwd": (attention_bwd, attention_bwd_reference, "attn_bwd.cu",
                     "voltrix_spmm_tpu/ops/attention.py:344", attention.load_bwd_library),
        "attn_dq": (attention_dq, attention_dq_reference, "attn_mh_dq.cu",
                    "voltrix_spmm_tpu/ops/attention.py:430", attention_mh.load_dq_library),
        "attn_dkv": (attention_dkv, attention_dkv_reference, "attn_mh_dkv.cu",
                     "voltrix_spmm_tpu/ops/attention.py:494", attention_mh.load_dkv_library),
        "spmm_int8": (spmm_int8, spmm_int8_reference, "spmm_int8.cu",
                      "voltrix_spmm_tpu/ops/quant.py:37", quant.load_library),
    }

    # the bf16 instantiations of K1, K2, K3 and K6 (path Q): the same
    # sources and wrappers, counted apart (wrapper.launches_bf16)
    bf16_of = {f"{name}_bf16": name
               for name in ("spmm_block", "spmm_subtile", "spmm_fused", "spmm_ell")}
    bf16_loaders = (block_spmm.load_bf16_library, subtile_spmm.load_bf16_library,
                    fused_spmm.load_bf16_library, ell.load_bf16_library)
    # their float16 instantiations (path S), and K4 on float16 rows or a
    # float16 plane, K8 on the codes of float16 rows, K9 and K13 at
    # compute_dtype=float16 (S.5-S.9): the same wrappers, counted apart
    # (wrapper.launches_f16)
    f16_of = {f"{name}_f16": name for name in (*bf16_of.values(), "spmm_weighted", "spmm_int8",
                                               "attn_fwd", "attn_mh_fwd")}
    f16_loaders = (block_spmm.load_f16_library, subtile_spmm.load_f16_library,
                   fused_spmm.load_f16_library, ell.load_f16_library)
    half_of = {**bf16_of, **f16_of}
    # path R: K4 on bf16 rows or a bf16 plane (its bf16 instantiations), K8 on
    # the codes of bf16 rows, and K9 and K13 at compute_dtype=bfloat16
    # (csrc/attn_fwd_bf16.cu, K13's kernel at one head for K9): the same
    # wrappers, counted apart (wrapper.launches_bf16)
    r_of = {"spmm_weighted_bf16": "spmm_weighted", "spmm_int8_bf16": "spmm_int8",
            "attn_fwd_bf16": "attn_fwd", "attn_mh_fwd_bf16": "attn_mh_fwd",
            # R.6: the backward's compute variants, in the float32 kernels' sources
            "attn_bwd_bf16": "attn_bwd", "attn_dq_bf16": "attn_dq", "attn_dkv_bf16": "attn_dkv",
            "attn_mh_dq_bf16": "attn_mh_dq", "attn_mh_dkv_bf16": "attn_mh_dkv"}
    # the sources of K9 and K13 under a 16-bit compute_dtype (csrc/attn_fwd_half.cuh)
    half_source = {"attn_fwd_bf16": "attn_fwd_bf16.cu", "attn_mh_fwd_bf16": "attn_fwd_bf16.cu",
                   "attn_fwd_f16": "attn_fwd_f16.cu", "attn_mh_fwd_f16": "attn_fwd_f16.cu"}

    # --- 2. build: one nvcc per source, all started together -----------
    # path C's protein proxy (79M nnz, ~20 s on the host) is made on a
    # thread of its own meanwhile: the build's threads wait on nvcc
    protein_pool = ThreadPoolExecutor(1)
    protein_made = protein_pool.submit(
        lambda: (time.perf_counter(), symmetrize(proxy_csr("protein", seed=0)),
                 time.perf_counter()))
    def timed_build(loader):
        t0 = time.perf_counter()
        loader()
        return time.perf_counter() - t0

    # K11 and K12 share K14's and K15's builds, K13 K9's; beside them g++
    # builds the native preprocess (csrc/voltrix_preprocess.hpp)
    sources = {k[2]: k[4] for k in kernels.values()}
    sources["attn_fwd_bf16.cu"] = load_fwd_bf16_library  # K9 and K13 at compute_dtype bf16
    sources["attn_fwd_f16.cu"] = load_fwd_f16_library  # and at compute_dtype float16
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host_build = pool.submit(timed_build, native_build_libraries)
        builds = dict(zip(sources, pool.map(timed_build, sources.values())))
        t_gxx = host_build.result()
    t_nvcc = time.perf_counter() - t0
    # each part's seconds, printed beside the total at the end
    part_s, part_t = {}, [t_start]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - part_t[0], 1)
        part_t[0] = now

    part("device and build")
    print(f"build: {', '.join(f'{src} {s:.2f} s' for src, s in builds.items())}; "
          f"g++ voltrix_preprocess.hpp {t_gxx:.2f} s; {t_nvcc:.2f} s in all, into "
          f"{get_build_dir()}")
    for loader in (*bf16_loaders, *f16_loaders):  # 16-bit entry points of the same builds
        loader()
    # every kernel sums in a fixed order: no atomic of any kind in the SASS
    # of any source
    cu_sources = sorted(f for f in os.listdir(os.path.join(ROOT, "voltrix_spmm_tpu_torch", "csrc"))
                        if f.endswith(".cu"))
    if sorted(sources) != cu_sources:
        fail(f"the kernels' sources {sorted(sources)} are not csrc's {cu_sources}")
    for src in cu_sources:
        ops = sass_atomics.atomics(src)
        print(f"sass_atomics {src}: {dict(sorted(ops.items())) or 'no atomics'}")
        if ops:
            fail(f"{src} compiled to atomics {dict(ops)}: its sums must run in a fixed order")

    # --- 3. kernels against their plain versions --------------------------
    max_err = dict.fromkeys([*kernels, *r_of, *f16_of], 0.0)

    def compare(name, label, plan, args, deg=None):
        """The kernel against its plain version on `args` ((feat,), or
        (feat, g) for K5 and K7). With `deg` (row degrees) the allowance of
        each row also holds the textbook bound on float32 summation in any
        order, (deg - 1) * 2**-24 * sum|a x|, once for each version: hub
        rows of a power-law graph sum tens of thousands of terms, and the
        test_spmm tolerance is set for small degrees."""
        kernel, plain = kernels[name][:2]
        out_k = kernel(plan, *args)
        out_p = plain(plan, *args)
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape or not bool(torch.isfinite(out_k).all()):
            fail(f"{name} {label}: kernel output {tuple(out_k.shape)} is not a finite "
                 f"{tuple(out_p.shape)}")
        diff = calc_diff(out_k, out_p)
        err = (out_k - out_p).abs().max().item() if out_k.numel() else 0.0
        max_err[name] = max(max_err[name], err)
        allow = TOL_KERNEL["atol"] + TOL_KERNEL["rtol"] * out_p.abs()
        if deg is not None:
            abs_plan = plan
            if name == "spmm_weighted":
                abs_plan = dataclasses.replace(plan, values=plan.values.abs())
            elif name == "spmm_ell":
                abs_plan = dataclasses.replace(plan, vals=plan.vals.abs())
            abs_sum = plain(abs_plan, args[0].abs())
            allow = allow + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * abs_sum
        ok = diff < 1e-6 and bool(((out_k - out_p).abs() <= allow).all())
        extra = ""
        if name == "spmm_dvalues" and out_k.numel():
            off = ~expand_bitmask(plan.bitmask, plan.config.block_h, torch.bool)
            zero = bool((out_k[off] == 0).all())
            ok = ok and zero
            extra = f", off the bitmask {'all 0.0' if zero else 'NOT ZERO'}"
        if name == "spmm_ell_dvals" and out_k.numel():
            zero = bool((out_k[plan.erow < 0] == 0).all())
            ok = ok and zero
            extra = f", padding lanes {'all 0.0' if zero else 'NOT ZERO'}"
        print(f"  {label}: calc_diff {diff:.3e}, max|kernel - plain| {err:.3e}{extra} "
              f"-> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version on {label}")

    def twice(label, kernel, plan, feat):
        """The kernel twice on the same input: the same bits, or fail."""
        same = torch.equal(kernel(plan, feat), kernel(plan, feat))
        print(f"  {label} twice: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of the kernel on the same input differ")

    walks = {"spmm_block": lambda p: block_spmm.plan_walk(p, "spmm_block"),
             "spmm_subtile": subtile_spmm.subtile_walk,
             "spmm_int8": lambda p: block_spmm.plan_walk(p, "spmm_int8"),
             "spmm_weighted": lambda p: block_spmm.plan_walk(p, "spmm_weighted"),
             "spmm_fused": lambda p: block_spmm.plan_walk(p, "spmm_fused")}

    def most_pieces(p, name):
        """The most pieces that one 128-row group of plan `p` is cut into."""
        merges = walks[name](p).merges
        return int(merges[:, 3].max()) if merges.numel() else 1

    def piece_line(label, plans, name, widths):
        """Print what K1's, K2's or K8's work list gives a path's plan (or its
        window chunks, which run one after another): pieces, windows and
        groups cut, the kept (lane, word) pairs and the work (pairs plus
        their nonzero bitmask bytes, busiest warp) of the heaviest piece
        against the mean piece, and the largest workspace at each width."""
        st = [block_spmm.walk_stats(p, walks[name](p), 1) for p in plans]
        pieces = sum(x["pieces"] for x in st)
        heavy = {k: max(x[f"max_task_{k}"] for x in st) for k in ("pairs", "work")}
        mean = {k: sum(x[f"mean_task_{k}"] * x["pieces"] for x in st) / pieces
                for k in ("pairs", "work")}
        ws = ", ".join(f"{max(x['workspace_mib'] for x in st) * d:.2f} MiB at d {d}"
                       for d in widths)
        print(f"  {label} {name} work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS[name]}, "
              f"PIECE_WORK {block_spmm.PIECE_WORK[name]}): {pieces} pieces, "
              f"{sum(x['cut_windows'] for x in st)} windows and "
              f"{sum(x['cut_groups'] for x in st)} groups cut; heaviest piece "
              f"{heavy['pairs']} kept pairs against a mean of {mean['pairs']:.1f}, "
              f"{heavy['work']} units of work against {mean['work']:.1f}; workspace {ws}")

    rng = np.random.default_rng(0)

    def feat_of(n, d):
        return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def case(name, label, a, d, cfg, expect=None, drop_occ=False, off_mask=False, feat=None,
             offset=False, bound=False, gen=None):
        """`name` against its plain version on plan `cfg` of `a` at width d.
        offset: feat is a contiguous view 4 bytes past a 16-byte boundary;
        bound: allow the float32 summation bound of `a`'s row degrees; gen:
        the generator of the values and features (the shared one if None)."""
        n = a.shape[0]
        draw = rng if gen is None else gen
        weighted_kernel = name in ("spmm_weighted", "spmm_dvalues")
        values = draw.standard_normal(a.nnz).astype(np.float32) if weighted_kernel else None
        plan = csr_preprocess(a.indptr, a.indices, n, cfg, values=values)
        if drop_occ:
            plan = dataclasses.replace(plan, occ=None)
        if off_mask:  # values in every slot, off the bitmask too: K4 reads them all
            dense = draw.standard_normal(tuple(plan.values.shape)).astype(np.float32)
            plan = dataclasses.replace(plan, values=torch.from_numpy(dense))
        if gen is not None and feat is None:
            feat = gen.standard_normal((n, d)).astype(np.float32)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        if offset:
            view = torch.empty(n * d + 1, device=dev)[1:].view(n, d)
            view.copy_(feat_of(n, d) if feat is None else torch.from_numpy(feat).to(dev))
            if view.data_ptr() % 16 != 4 or not view.is_contiguous():
                fail(f"{label}: the features are not the offset view this case is for")
            args = (view,)
        elif feat is not None:
            args = (torch.from_numpy(feat).to(dev),)
        elif name == "spmm_dvalues":
            args = (feat_of(n, d), feat_of(n, d))
        else:
            args = (feat_of(n, d),)
        deg = None
        if bound and off_mask:  # every slot of the row's window counts
            bpw = torch.diff(plan.block_ptr).float()
            deg = (bpw.repeat_interleave(plan.config.block_h)[:n] * plan.config.block_w)
            deg = deg.to(dev)[:, None]
        elif bound:
            deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        compare(name, label, plan.to(dev), args, deg)

    def zero_block(p):
        return bool((p.bitmask.view(p.total_blocks, -1) == 0).all(1).any())

    print(f"kernel K1 against its plain version (calc_diff < 1e-6, allclose {TOL_KERNEL}):")
    k1 = "spmm_block"
    case(k1, "n3000 d300 PlanConfig(128,128), bit 31 set", erdos_renyi_csr(3000, 0.02, 1),
         300, PlanConfig(128, 128), expect=lambda p: bool((p.bitmask < 0).any()))
    case(k1, "n1000 d64 PlanConfig(32,128,block_unroll=4)", erdos_renyi_csr(1000, 0.02, 2),
         64, PlanConfig(32, 128, block_unroll=4))
    case(k1, "n1000 d256 PlanConfig(128,256)", erdos_renyi_csr(1000, 0.01, 3),
         256, PlanConfig(128, 256))
    case(k1, "n700 d72 PlanConfig(48,128) (block_h not a multiple of 32)",
         erdos_renyi_csr(700, 0.02, 4), 72, PlanConfig(48, 128))
    case(k1, "n2048 d96 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 5), lambda r: not 256 <= r < 512),
         96, PlanConfig(128, 128), expect=lambda p: not p.has_empty_windows and zero_block(p))
    case(k1, "n10240 d128 empty windows left without blocks",
         rows_only(erdos_renyi_csr(10240, 0.002, 6), lambda r: r < 128),
         128, PlanConfig(128, 128), expect=lambda p: p.has_empty_windows)
    case(k1, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 7), 64,
         PlanConfig(128, 128), expect=lambda p: p.total_blocks == 0)
    case(k1, "n1001 d40 PlanConfig(128,128,gather_segment=4)", erdos_renyi_csr(1001, 0.01, 8),
         40, PlanConfig(128, 128, gather_segment=4), expect=lambda p: int(p.hind.max()) >= 1001)

    def window0_of(blocks, seed):
        """A graph whose first 128 rows reach exactly blocks x 128 distinct
        columns (row r: columns r * blocks .. r * blocks + blocks - 1), so
        window 0 of a PlanConfig(128, 128) plan holds exactly `blocks`
        blocks; the other rows are random."""
        n = blocks * 128 + 2048
        rest = rows_only(erdos_renyi_csr(n, 0.005, seed), lambda r: r >= 128)
        first = sp.csr_matrix((np.ones(128 * blocks, np.float32),
                               (np.repeat(np.arange(128), blocks), np.arange(128 * blocks))),
                              shape=(n, n))
        return ((rest + first) != 0).astype(np.float32).tocsr()

    # power-law hub windows cut into pieces; the float32 summation bound of
    # their hub rows (degrees in the thousands)
    hub40k = symmetrize(chung_lu_csr(40000, 400000, seed=34))
    for name, kid, sub_cfg in (
            (k1, "K1", {}), ("spmm_subtile", "K2", {"cluster_cols": True})):
        pb = block_spmm.PIECE_BLOCKS[name]
        if name != k1:
            print(f"kernel {kid} against its plain version (clustered plans):")
        print(f"  ({kid}'s pieces: PIECE_BLOCKS {pb}, PIECE_WORK "
              f"{block_spmm.PIECE_WORK[name]})")
        case(name, f"n40000 d128 block_h 128, block_w 32{', clustered' if sub_cfg else ''}, hub "
             "window cut into >= 16 pieces", hub40k, 128, PlanConfig(128, 32, **sub_cfg),
             expect=lambda p, name=name: most_pieces(p, name) >= 16, bound=True)
        case(name, f"n{128 * 2 * pb + 2048} d64 window 0 of exactly 2 x {pb} blocks",
             window0_of(2 * pb, 35), 64, PlanConfig(128, 128, **sub_cfg),
             expect=lambda p, pb=pb: int(p.block_ptr[1]) == 2 * pb)
        wide = PlanConfig(2048, 128, block_unroll=4, **sub_cfg) if sub_cfg else PlanConfig(128, 128)
        wide_label = f"block_h {wide.block_h}, block_w 128{', clustered' if sub_cfg else ''}"
        case(name, f"n40000 d256 {wide_label}, hub windows cut", hub40k, 256, wide,
             expect=lambda p, name=name: most_pieces(p, name) >= 4, bound=True)
        case(name, f"n40000 d130 {wide_label} (unaligned rows: 4-byte copies)", hub40k, 130,
             wide, bound=True)
        case(name, f"n40000 d128 {wide_label}, feat 4 bytes past a 16-byte boundary", hub40k,
             128, wide, offset=True, bound=True)

    # a padded, rectangular sampled hop (path L's seed hop at a small size,
    # PlanConfig(32, 128)): the padding blocks sit in the last window, which
    # the walk cuts into empty pieces and merges in order; the hop at d 128
    # and its transpose at d 256, as path L's step launches them
    print("  (a sampled hop: data.sample_block, 512 seeds, fanout 25, padded to block_caps)")
    hop = sample_block(hub40k.indptr, hub40k.indices,
                       np.random.default_rng(36).choice(40000, 512, replace=False), 25,
                       np.random.default_rng(37))
    hop_rng = np.random.default_rng(38)
    for side, p, d in (("plan", hop.plan, 128), ("plan_t", hop.plan_t, 256)):
        pd = p.to(dev)
        real = int((pd.bitmask.view(p.total_blocks, -1) != 0).any(1).sum())
        last = int(p.block_ptr[-1] - p.block_ptr[-2])
        pieces = most_pieces(pd, k1)
        if p.num_cols is None or (side == "plan_t" and not (real < p.total_blocks and pieces >= 16)):
            fail(f"sampled hop {side}: not the padded rectangular plan this case is for")
        feat = torch.from_numpy(hop_rng.standard_normal((p.source_rows, d)).astype(np.float32))
        feat = feat.to(dev)
        compare(k1, f"sampled hop {side} {p.num_nodes} x {p.source_rows} d{d}: {p.total_blocks} "
                f"blocks ({real} with bits), last window {last} blocks in {pieces} pieces", pd,
                (feat,))
        twice(f"sampled hop {side} K1 d{d}", spmm_block, pd, feat)

    k2 = "spmm_subtile"
    community = chung_lu_csr(6000, 60000, community=128, local_frac=0.8, seed=9)
    for h in (128, 256, 512, 2048):
        for u in (1, 4):
            case(k2, f"n6000 d96 PlanConfig({h},128,block_unroll={u},cluster_cols=True)",
                 community, 96, PlanConfig(h, 128, block_unroll=u, cluster_cols=True),
                 expect=lambda p: p.occ is not None)
    case(k2, "n3001 d64 PlanConfig(256,128,gather_segment=2,cluster_cols=True)",
         erdos_renyi_csr(3001, 0.005, 10), 64,
         PlanConfig(256, 128, gather_segment=2, cluster_cols=True))
    case(k2, "n2048 d96 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 11), lambda r: not 256 <= r < 512), 96,
         PlanConfig(128, 128, cluster_cols=True),
         expect=lambda p: not p.has_empty_windows and bool((p.occ == 0).any()))
    case(k2, "n10240 d128 empty windows left without blocks",
         rows_only(erdos_renyi_csr(10240, 0.002, 12), lambda r: r < 128), 128,
         PlanConfig(128, 128, cluster_cols=True), expect=lambda p: p.has_empty_windows)
    case(k2, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 13), 64,
         PlanConfig(128, 128, cluster_cols=True), expect=lambda p: p.total_blocks == 0)
    case(k2, "n6000 d300 PlanConfig(512,128,block_unroll=4,cluster_cols=True)", community,
         300, PlanConfig(512, 128, block_unroll=4, cluster_cols=True))
    case(k2, "n6000 d72 PlanConfig(2048,128,block_unroll=4,cluster_cols=True), occ None",
         community, 72, PlanConfig(2048, 128, block_unroll=4, cluster_cols=True), drop_occ=True)

    print("kernel K3 against its plain version (coverage plans):")
    k3 = "spmm_fused"
    case(k3, "n512 d64 PlanConfig(128,128,gather_segment=8)", erdos_renyi_csr(512, 0.05, 14),
         64, PlanConfig(128, 128, gather_segment=8))
    case(k3, "n300 d130 PlanConfig(32,128,gather_segment=16)", erdos_renyi_csr(300, 0.02, 15),
         130, PlanConfig(32, 128, gather_segment=16))
    case(k3, "n700 d256 PlanConfig(64,256,gather_segment=32)", erdos_renyi_csr(700, 0.01, 16),
         256, PlanConfig(64, 256, gather_segment=32))
    case(k3, "n5000 d96 PlanConfig(2048,128,gather_segment=128,block_unroll=4), tail past n",
         erdos_renyi_csr(5000, 0.01, 17), 96,
         PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
         expect=lambda p: int(p.hind.max()) >= 5000)
    case(k3, "n2048 d64 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 18), lambda r: not 256 <= r < 512), 64,
         PlanConfig(128, 128, gather_segment=8), expect=lambda p: not p.has_empty_windows)
    case(k3, "n4096 d64 empty windows left without blocks",
         rows_only(erdos_renyi_csr(4096, 0.01, 19), lambda r: r < 32), 64,
         PlanConfig(32, 128, gather_segment=8, block_unroll=2),
         expect=lambda p: p.has_empty_windows)
    case(k3, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 20), 64,
         PlanConfig(128, 128, gather_segment=8), expect=lambda p: p.total_blocks == 0)
    case(k3, "n3000 d8 PlanConfig(2048,128,gather_segment=128,block_unroll=4)",
         erdos_renyi_csr(3000, 0.02, 21), 8,
         PlanConfig(2048, 128, gather_segment=128, block_unroll=4))
    case(k3, "n3000 d300 PlanConfig(256,128,gather_segment=64,block_unroll=2)",
         erdos_renyi_csr(3000, 0.02, 22), 300,
         PlanConfig(256, 128, gather_segment=64, block_unroll=2))
    # K3's work list and both its walks: hub windows cut into pieces (J.2's
    # geometry and C's), the narrow walk (d <= 32), 4-byte copies (d 130,
    # features off a 16-byte boundary), tensor-map boxes (d > 128) past n
    # and empty windows; features from a generator of their own, so those
    # of the paths below stay as they were
    rng3 = np.random.default_rng(97)
    j2_geometry = PlanConfig(128, 128, gather_segment=8)
    c_geometry = PlanConfig(2048, 128, gather_segment=128, block_unroll=4)
    print(f"  (K3's pieces: PIECE_BLOCKS {block_spmm.PIECE_BLOCKS[k3]}, PIECE_WORK "
          f"{block_spmm.PIECE_WORK[k3]})")
    hub1m = symmetrize(chung_lu_csr(40000, 1000000, seed=36))
    for d in (128, 256, 8):
        case(k3, f"n40000 {hub1m.nnz} nnz d{d} PlanConfig(128,128,gather_segment=8), hub window "
             "cut into >= 16 pieces", hub1m, d, j2_geometry,
             expect=lambda p: most_pieces(p, k3) >= 16, bound=True, gen=rng3)
    case(k3, "n40000 d130 PlanConfig(2048,128,gather_segment=128,block_unroll=4) (unaligned "
         "rows: 4-byte copies)", hub40k, 130, c_geometry, bound=True, gen=rng3)
    case(k3, "n40000 d300 PlanConfig(2048,128,gather_segment=128,block_unroll=4) (boxes, a "
         "partial column chunk)", hub40k, 300, c_geometry, bound=True, gen=rng3)
    for d in (128, 8):
        case(k3, f"n40000 d{d} PlanConfig(512,128,gather_segment=8), feat 4 bytes past a 16-byte "
             "boundary", hub40k, d, PlanConfig(512, 128, gather_segment=8), offset=True,
             bound=True, gen=rng3)
    for d in (256, 8):
        case(k3, f"n5000 d{d} PlanConfig(2048,128,gather_segment=128,block_unroll=4), tail past n",
             erdos_renyi_csr(5000, 0.01, 17), d, c_geometry,
             expect=lambda p: int(p.hind.max()) >= 5000, gen=rng3)
        case(k3, f"n2048 d{d} empty windows padded with zero-bit blocks",
             rows_only(erdos_renyi_csr(2048, 0.01, 18), lambda r: not 256 <= r < 512), d,
             PlanConfig(128, 128, gather_segment=8), expect=lambda p: not p.has_empty_windows,
             gen=rng3)
        case(k3, f"n40960 d{d} empty windows left without blocks (tall windows)",
             rows_only(erdos_renyi_csr(40960, 0.0005, 19), lambda r: r < 2048), d, c_geometry,
             expect=lambda p: p.has_empty_windows, gen=rng3)
    # runs that cross the 128-lane tiles the producer stages (block_w 384):
    # tensor-map boxes of 8-64 rows (seg 24, 48, 96, 192), and 4-byte copies
    # where a box would be under 8 rows (seg 12)
    for d, seg in ((128, 48), (256, 48), (256, 24), (128, 96), (256, 192), (8, 48), (128, 12)):
        case(k3, f"n40000 d{d} PlanConfig(128,384,gather_segment={seg}), runs across tiles",
             hub40k, d, PlanConfig(128, 384, gather_segment=seg), bound=True, gen=rng3)

    hub = symmetrize(chung_lu_csr(8000, 80000, seed=23))  # hub windows cut into K4 pieces
    for name, kid in (("spmm_weighted", "K4"), ("spmm_dvalues", "K5")):
        print(f"kernel {kid} against its plain version (weighted plans):")
        case(name, "n3000 d8 PlanConfig(64,128)", erdos_renyi_csr(3000, 0.01, 24), 8,
             PlanConfig(64, 128))
        case(name, "n3000 d40 PlanConfig(64,128,block_unroll=2)", erdos_renyi_csr(3000, 0.01, 25),
             40, PlanConfig(64, 128, block_unroll=2))
        case(name, "n1000 d100 PlanConfig(32,128) (unaligned D)", erdos_renyi_csr(1000, 0.02, 26),
             100, PlanConfig(32, 128))
        case(name, "n1000 d300 PlanConfig(128,128)", erdos_renyi_csr(1000, 0.02, 27), 300,
             PlanConfig(128, 128))
        case(name, "n700 d64 PlanConfig(32,256)", erdos_renyi_csr(700, 0.02, 28), 64,
             PlanConfig(32, 256))
        case(name, "n1500 d40 PlanConfig(96,128) (rows per thread not a power of two)",
             erdos_renyi_csr(1500, 0.01, 33), 40, PlanConfig(96, 128))
        case(name, "n8000 d40 PlanConfig(64,128), power-law hub windows", hub, 40,
             PlanConfig(64, 128), expect=lambda p: int(torch.diff(p.block_ptr).max()) > 16)
        case(name, "n2048 d24 empty windows padded with zero-bit blocks",
             rows_only(erdos_renyi_csr(2048, 0.01, 29), lambda r: not 256 <= r < 512), 24,
             PlanConfig(128, 128), expect=lambda p: not p.has_empty_windows and zero_block(p))
        case(name, "n10240 d8 empty windows left without blocks",
             rows_only(erdos_renyi_csr(10240, 0.002, 30), lambda r: r < 64), 8,
             PlanConfig(64, 128), expect=lambda p: p.has_empty_windows)
        case(name, "n500 d8 empty matrix", erdos_renyi_csr(500, 0.0, 31), 8,
             PlanConfig(64, 128), expect=lambda p: p.total_blocks == 0)
        case(name, "n2000 d40 PlanConfig(64,128), values off the bitmask",
             erdos_renyi_csr(2000, 0.01, 32), 40, PlanConfig(64, 128), off_mask=True)

    # K4's work list: hub windows cut into pieces of at most PIECE_BLOCKS
    # blocks, merged in piece order; the float32 summation bound of the rows'
    # terms (their degrees, or every slot of their window's blocks); values
    # and features from a generator of their own, as K8's cases, so those of
    # the paths below stay as they were
    k4, pb = "spmm_weighted", block_spmm.PIECE_BLOCKS["spmm_weighted"]
    print(f"kernel K4 on its work list (PIECE_BLOCKS {pb}):")
    rng4 = np.random.default_rng(96)
    case(k4, "n40000 d40 PlanConfig(64,128), hub window cut into >= 16 pieces", hub40k, 40,
         PlanConfig(64, 128), expect=lambda p: most_pieces(p, k4) >= 16, bound=True, gen=rng4)
    case(k4, f"n{128 * 2 * pb + 2048} d40 PlanConfig(128,128), window 0 of exactly 2 x {pb} "
         "blocks", window0_of(2 * pb, 36), 40, PlanConfig(128, 128),
         expect=lambda p: int(p.block_ptr[1]) == 2 * pb, gen=rng4)
    case(k4, "n40000 d130 PlanConfig(64,128), hub windows cut (unaligned rows: 4-byte copies)",
         hub40k, 130, PlanConfig(64, 128), expect=lambda p: most_pieces(p, k4) >= 16,
         bound=True, gen=rng4)
    case(k4, "n8000 d40 PlanConfig(64,128), values off the bitmask on cut windows", hub, 40,
         PlanConfig(64, 128), expect=lambda p: most_pieces(p, k4) >= 4, off_mask=True,
         bound=True, gen=rng4)

    # K4's bf16 instantiations on the same geometries, with a float32 and a
    # bf16 plane: bit for bit the float32 K4 on the widened rows and plane
    # (the sums' order does not depend on the source), twice the same bits,
    # and against the plain version (which widens them) under the summation
    # bound; rows padded by the wrapper (d 130, 300) and rows 2 bytes off an
    # 8-byte boundary; values and rows from a generator of their own
    r_err = dict.fromkeys(r_of, 0.0)
    # the same for the 16-bit instantiations of paths Q and S
    half_err = dict.fromkeys([*bf16_of, *f16_of], 0.0)

    def k4_half_check(label, plan, xb, deg, key="spmm_weighted_bf16"):
        """K4 on 16-bit rows xb or a 16-bit plane (`key`: its bf16 or its
        float16 instantiations) against the float32 K4 on the widened rows
        and plane (bit for bit), twice (the same bits) and its plain version
        under the summation bound."""
        err_of = r_err if key in r_err else half_err
        out = spmm_weighted(plan, xb, torch.float32)
        wide = dataclasses.replace(plan, values=plan.values.float())
        same = torch.equal(out, spmm_weighted(wide, xb.float(), torch.float32))
        again = torch.equal(out, spmm_weighted(plan, xb, torch.float32))
        want = spmm_weighted_reference(plan, xb, torch.float32)
        torch.cuda.synchronize()
        allow = TOL_KERNEL["atol"] + TOL_KERNEL["rtol"] * want.abs()
        if deg is not None:
            abs_plan = dataclasses.replace(plan, values=plan.values.abs())
            allow = allow + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * spmm_weighted_reference(
                abs_plan, xb.abs(), torch.float32)
        err = (out - want).abs().max().item() if out.numel() else 0.0
        err_of[key] = max(err_of[key], err)
        ok = same and again and bool(((out - want).abs() <= allow).all())
        print(f"  {key} {label}: {key.rsplit('_', 1)[1]} {'==' if same else '!='} float32 K4 "
              f"on the widened rows and plane, twice {'bit-identical' if again else 'DIFFERENT'}"
              f", max|kernel - plain| {err:.3e} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{key} {label}: not the float32 kernel's bits on the widened inputs, not the "
                 "same twice, or off its plain version")

    rng4b = np.random.default_rng(99)

    def k4_half_case(label, a, cfg, widths, expect=None, off_mask=False, offset=False,
                     half=torch.bfloat16):
        """K4's instantiations on rows of the 16-bit type `half` with each
        plane type it pairs with (bf16 rows: a float32 and a bf16 plane;
        float16 rows: a float32, a bf16 and a float16 plane)."""
        n = a.shape[0]
        plan = csr_preprocess(a.indptr, a.indices, n, cfg,
                              values=rng4b.standard_normal(a.nnz).astype(np.float32))
        if off_mask:  # every slot of a tile counts, off the bitmask too
            dense = rng4b.standard_normal(tuple(plan.values.shape)).astype(np.float32)
            plan = dataclasses.replace(plan, values=torch.from_numpy(dense))
            bpw = torch.diff(plan.block_ptr).float()
            deg = (bpw.repeat_interleave(cfg.block_h)[:n] * cfg.block_w).to(dev)[:, None]
        else:
            deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        plan = plan.to(dev)
        for d in widths:
            x = rng4b.standard_normal((n, d + offset)).astype(np.float32)
            xb = torch.from_numpy(x).to(dev).to(half)
            if offset:
                xb = xb.reshape(-1)[1:1 + n * d].view(n, d)
            for plane in (torch.float32, torch.bfloat16, torch.float16)[:3 if half == F16 else 2]:
                k4_half_check(f"{label} d{d}{' (rows 2 bytes off 8)' if offset else ''}, "
                              f"{str(plane).removeprefix('torch.')} plane",
                              dataclasses.replace(plan, values=plan.values.to(plane)), xb, deg,
                              "spmm_weighted_f16" if half == F16 else "spmm_weighted_bf16")

    print(f"kernel K4's bf16 instantiations on its work list (PIECE_BLOCKS {pb}):")
    k4_half_case("n40000 PlanConfig(64,128), hub window cut into >= 16 pieces", hub40k,
                 PlanConfig(64, 128), (40, 130, 300),
                 expect=lambda p: most_pieces(p, k4) >= 16)
    k4_half_case("n40000 PlanConfig(64,128), hub window cut into >= 16 pieces", hub40k,
                 PlanConfig(64, 128), (40,), offset=True)
    k4_half_case(f"n{128 * 2 * pb + 2048} PlanConfig(128,128), window 0 of exactly 2 x {pb} "
                 "blocks", window0_of(2 * pb, 36), PlanConfig(128, 128), (40,),
                 expect=lambda p: int(p.block_ptr[1]) == 2 * pb)
    k4_half_case("n8000 PlanConfig(64,128), values off the bitmask on cut windows", hub,
                 PlanConfig(64, 128), (40,), expect=lambda p: most_pieces(p, k4) >= 4,
                 off_mask=True)

    # K5 at set bits only, over its work list (PIECE_BLOCKS["spmm_dvalues"]):
    # each case twice on one input, the same bits; block_w 256, bits on rows
    # at num_nodes and beyond (0.0 there), hind outside the source rows
    # (clipped), hub windows cut into pieces, two 128-row groups, three
    # words a group; features and dO from a generator of their own
    print(f"kernel K5 on its work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS['spmm_dvalues']}), "
          "each case twice:")
    rng5 = np.random.default_rng(92)

    def k5_case(label, a, d, cfg, edit=None, expect=None):
        n = a.shape[0]
        plan = csr_preprocess(a.indptr, a.indices, n, cfg)
        last = (plan.window_of_block == plan.num_windows - 1).numpy()
        if edit == "rows_past_n":  # bits on the last window's rows n .. padded_nodes - 1
            if not last.any():
                fail(f"{label}: the last window has no blocks")
            bm = plan.bitmask.numpy().copy()
            r0 = n - (plan.num_windows - 1) * cfg.block_h
            for r in range(r0, cfg.block_h):
                bm[last, r // 32, ::3] |= np.int32(np.uint32(1 << (r % 32)).view(np.int32))
            plan = dataclasses.replace(plan, bitmask=torch.from_numpy(bm))
        if edit == "clipped":  # a fifth of the lanes with bits gather past the source rows
            hind = plan.hind.numpy().copy().reshape(-1)
            held = np.flatnonzero((plan.bitmask.numpy() != 0).any(1).reshape(-1))
            hind[held[::10]], hind[held[5::10]] = n + 11, -4
            plan = dataclasses.replace(plan, hind=torch.from_numpy(hind.reshape(plan.hind.shape)))
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        plan = plan.to(dev)
        feat, grad = (torch.from_numpy(rng5.standard_normal((n, d)).astype(np.float32)).to(dev)
                      for _ in range(2))
        compare("spmm_dvalues", label, plan, (feat, grad))
        out = spmm_weighted_dvalues(plan, feat, grad)
        twice(f"  K5 {label}", lambda p, f: spmm_weighted_dvalues(p, f, grad), plan, feat)
        if edit == "rows_past_n":
            past = out[torch.from_numpy(last).to(dev)][:, r0:]
            if not bool((past == 0).all()):
                fail(f"K5 {label}: rows past num_nodes are not 0.0")
            print(f"    rows past num_nodes: {past.numel()} values, all 0.0")

    k5_case("n3000 d8 PlanConfig(64,128)", erdos_renyi_csr(3000, 0.01, 24), 8, PlanConfig(64, 128))
    k5_case("n3000 d40 PlanConfig(64,128,block_unroll=2)", erdos_renyi_csr(3000, 0.01, 25), 40,
            PlanConfig(64, 128, block_unroll=2))
    k5_case("n1000 d100 PlanConfig(32,128) (two column chunks, unaligned d)",
            erdos_renyi_csr(1000, 0.02, 26), 100, PlanConfig(32, 128))
    k5_case("n1000 d13 PlanConfig(64,128) (4-byte copies)", erdos_renyi_csr(1000, 0.02, 27), 13,
            PlanConfig(64, 128))
    k5_case("n700 d64 PlanConfig(32,256) (block_w 256)", erdos_renyi_csr(700, 0.02, 28), 64,
            PlanConfig(32, 256))
    k5_case("n300 d40 PlanConfig(64,128), bits on rows 300-319 past num_nodes",
            erdos_renyi_csr(300, 0.03, 29), 40, PlanConfig(64, 128), edit="rows_past_n")
    k5_case("n1000 d40 PlanConfig(64,128), hind outside [0, n) on a fifth of the lanes "
            "with bits", erdos_renyi_csr(1000, 0.02, 30), 40, PlanConfig(64, 128), edit="clipped")
    k5_case("n8000 d40 PlanConfig(64,128), power-law hub windows cut into pieces", hub, 40,
            PlanConfig(64, 128), expect=lambda p: int(torch.diff(p.block_ptr).max())
            > 2 * block_spmm.PIECE_BLOCKS["spmm_dvalues"])
    k5_case("n3000 d40 PlanConfig(256,128) (two 128-row groups)", erdos_renyi_csr(3000, 0.01, 31),
            40, PlanConfig(256, 128))
    k5_case("n1500 d24 PlanConfig(96,128) (three words a group)",
            erdos_renyi_csr(1500, 0.01, 33), 24, PlanConfig(96, 128))
    k5_case("n10240 d8 empty windows left without blocks",
            rows_only(erdos_renyi_csr(10240, 0.002, 30), lambda r: r < 64), 8,
            PlanConfig(64, 128), expect=lambda p: p.has_empty_windows)

    def with_duplicates(a, seed):
        """(indptr, indices, n) of `a` with a fifth of its edges repeated:
        duplicate edges keep separate ELL lanes and sum."""
        coo = a.tocoo()
        pick = np.random.default_rng(seed).random(coo.nnz) < 0.2
        rows = np.concatenate([coo.row, coo.row[pick]])
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(a.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=a.shape[0]), out=indptr[1:])
        return indptr, np.concatenate([coo.col, coo.col[pick]])[order], a.shape[0]

    def ell_case(name, label, a, d, cfg, num_cols=None, expect=None, pad_vals=False,
                 misaligned=False, gen=None):
        """K6 or K7 against its plain version on an ELL plan of `a` (a CSR,
        or (indptr, indices, n)) with random edge values; gen: the generator
        of the values and features (the shared one if None)."""
        draw = rng if gen is None else gen
        indptr, indices, n = (a.indptr, a.indices, a.shape[0]) if sp.issparse(a) else a
        values = draw.standard_normal(len(indices)).astype(np.float32)
        plan = csr_preprocess_ell(indptr, indices, n, cfg, values=values, num_cols=num_cols)
        if pad_vals:  # values on padding lanes: K6 must ignore them
            pad = plan.erow < 0
            vals = plan.vals.clone()
            vals[pad] = torch.from_numpy(draw.standard_normal(int(pad.sum())).astype(np.float32))
            plan = dataclasses.replace(plan, vals=vals)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        src = num_cols or n

        def draw_feat(rows):
            if gen is None:
                return feat_of(rows, d)
            return torch.from_numpy(gen.standard_normal((rows, d)).astype(np.float32)).to(dev)

        feat = draw_feat(src)
        if misaligned:  # 4 bytes past a 16-byte boundary: K7 takes scalar loads
            buf = torch.empty(src * d + 1, device=dev)
            buf[1:] = feat.reshape(-1)
            feat = buf[1:].view(src, d)
        args = (feat,) if name == "spmm_ell" else (feat, draw_feat(n))
        compare(name, label, plan.to(dev), args)

    for name, kid in (("spmm_ell", "K6"), ("spmm_ell_dvals", "K7")):
        print(f"kernel {kid} against its plain version (ELL plans):")
        ell_case(name, "n3001 d8 PlanConfig(128,128,block_unroll=4) (unaligned n)",
                 erdos_renyi_csr(3001, 0.005, 40), 8, PlanConfig(128, 128, block_unroll=4))
        ell_case(name, "n1000 d40 PlanConfig(64,128)", erdos_renyi_csr(1000, 0.02, 41), 40,
                 PlanConfig(64, 128))
        ell_case(name, "n700 d1 PlanConfig(32,128)", erdos_renyi_csr(700, 0.02, 42), 1,
                 PlanConfig(32, 128))
        ell_case(name, "n2000 d256 PlanConfig(128,128,block_unroll=4)",
                 erdos_renyi_csr(2000, 0.02, 43), 256, PlanConfig(128, 128, block_unroll=4))
        ell_case(name, "n800 d40 PlanConfig(32,128,block_unroll=4), duplicate edges",
                 with_duplicates(erdos_renyi_csr(800, 0.02, 44), 44), 40,
                 PlanConfig(32, 128, block_unroll=4))
        ell_case(name, "500 x 900 d64 PlanConfig(64,128) (rectangular)",
                 sp.random(500, 900, density=0.02, format="csr",
                           random_state=np.random.default_rng(45)), 64, PlanConfig(64, 128),
                 num_cols=900)
        ell_case(name, "n500 d8 empty matrix (padding blocks only)",
                 erdos_renyi_csr(500, 0.0, 46), 8, PlanConfig(128, 128),
                 expect=lambda p: p.total_blocks > 0 and bool((p.erow < 0).all()))
        ell_case(name, "n12800 d8 empty matrix, no blocks", erdos_renyi_csr(12800, 0.0, 47), 8,
                 PlanConfig(128, 128), expect=lambda p: p.total_blocks == 0)
        ell_case(name, "n10240 d40 empty windows left without blocks",
                 rows_only(erdos_renyi_csr(10240, 0.002, 48), lambda r: r < 128), 40,
                 PlanConfig(128, 128), expect=lambda p: p.has_empty_windows)
        ell_case(name, "n4000 d40 PlanConfig(128,128), values on padding lanes",
                 erdos_renyi_csr(4000, 0.005, 49), 40, PlanConfig(128, 128), pad_vals=True,
                 expect=lambda p: bool((p.erow < 0).any()))
        ell_case(name, "n8000 d40 PlanConfig(128,128,block_unroll=4), power-law hub windows",
                 hub, 40, PlanConfig(128, 128, block_unroll=4),
                 expect=lambda p: int(torch.diff(p.block_ptr).max()) > 16)
        ell_case(name, "n3000 d100 PlanConfig(128,256)", erdos_renyi_csr(3000, 0.01, 50), 100,
                 PlanConfig(128, 256))
        ell_case(name, "n6000 d64 PlanConfig(2048,128) (tall windows, 16-column tile)",
                 erdos_renyi_csr(6000, 0.005, 51), 64, PlanConfig(2048, 128))
        ell_case(name, "n2000 d40 PlanConfig(128,128), misaligned features",
                 erdos_renyi_csr(2000, 0.01, 52), 40, PlanConfig(128, 128), misaligned=True)
    # K7's wide kernel (rows of at least DVALS_WIDE_MIN_D floats) and its
    # source order cut into pieces; values and features from a generator of
    # their own, so those of the paths below stay as they were
    rng7 = np.random.default_rng(98)
    print(f"  (K7's wide kernel from d {ell.DVALS_WIDE_MIN_D}, pieces of at most "
          f"{ell.DVALS_PIECE_LANES} lanes)")

    def cut_sources(p):
        """Some window's lanes are cut into two or more wide pieces."""
        w = ell.ell_source_order(p, ell.DVALS_PIECE_LANES).pieces[:, 0]
        return w.numel() > 0 and int(torch.bincount(w).max()) >= 2

    k7 = "spmm_ell_dvals"
    ell_case(k7, "n2000 d300 PlanConfig(128,128,block_unroll=4) (wide, 3 float4 a lane)",
             erdos_renyi_csr(2000, 0.02, 53), 300, PlanConfig(128, 128, block_unroll=4),
             gen=rng7)
    ell_case(k7, "n2000 d256 PlanConfig(128,128), misaligned features (sub-group kernel)",
             erdos_renyi_csr(2000, 0.02, 54), 256, PlanConfig(128, 128), misaligned=True,
             gen=rng7)
    hub_cand = symmetrize(chung_lu_csr(8000, 400000, seed=55))
    for d in (256, ell.DVALS_WIDE_MIN_D):
        ell_case(k7, f"n8000 d{d} PlanConfig(128,128,block_unroll=4), power-law hub windows "
                 "with padding lanes, cut into pieces", hub_cand, d,
                 PlanConfig(128, 128, block_unroll=4),
                 expect=lambda p: bool((p.erow < 0).any()) and cut_sources(p), gen=rng7)

    print("kernel K8 against its plain version (int8 rows, bf16 dequantization):")
    k8 = "spmm_int8"
    case(k8, "n512 d64 PlanConfig(32,128)", erdos_renyi_csr(512, 0.05, 80), 64,
         PlanConfig(32, 128))
    case(k8, "n300 d130 PlanConfig(32,128) (d not a multiple of 4)",
         erdos_renyi_csr(300, 0.02, 81), 130, PlanConfig(32, 128))
    case(k8, "n700 d1 PlanConfig(32,128)", erdos_renyi_csr(700, 0.02, 82), 1, PlanConfig(32, 128))
    case(k8, "n3000 d300 PlanConfig(128,128), bit 31 set", erdos_renyi_csr(3000, 0.02, 83), 300,
         PlanConfig(128, 128), expect=lambda p: bool((p.bitmask < 0).any()))
    case(k8, "n700 d72 PlanConfig(48,128) (block_h not a multiple of 32)",
         erdos_renyi_csr(700, 0.02, 84), 72, PlanConfig(48, 128))
    case(k8, "n1000 d256 PlanConfig(128,256)", erdos_renyi_csr(1000, 0.01, 85), 256,
         PlanConfig(128, 256))
    case(k8, "n6000 d96 PlanConfig(512,128,block_unroll=4,cluster_cols=True) (occ ignored)",
         community, 96, PlanConfig(512, 128, block_unroll=4, cluster_cols=True),
         expect=lambda p: bool((p.occ != 15).any()))
    case(k8, "n3001 d64 PlanConfig(128,128,gather_segment=8), tail past n",
         erdos_renyi_csr(3001, 0.01, 86), 64, PlanConfig(128, 128, gather_segment=8),
         expect=lambda p: int(p.hind.max()) >= 3001)
    case(k8, "n5000 d96 PlanConfig(2048,128,gather_segment=128,block_unroll=4), tail past n",
         erdos_renyi_csr(5000, 0.01, 87), 96,
         PlanConfig(2048, 128, gather_segment=128, block_unroll=4),
         expect=lambda p: int(p.hind.max()) >= 5000)
    case(k8, "n10240 d128 empty windows left without blocks",
         rows_only(erdos_renyi_csr(10240, 0.002, 88), lambda r: r < 128), 128,
         PlanConfig(128, 128), expect=lambda p: p.has_empty_windows)
    case(k8, "n2048 d96 empty windows padded with zero-bit blocks",
         rows_only(erdos_renyi_csr(2048, 0.01, 89), lambda r: not 256 <= r < 512), 96,
         PlanConfig(128, 128), expect=lambda p: not p.has_empty_windows and zero_block(p))
    case(k8, "n500 d64 empty matrix", erdos_renyi_csr(500, 0.0, 90), 64, PlanConfig(128, 128),
         expect=lambda p: p.total_blocks == 0)
    zero_rows = rng.standard_normal((2048, 40)).astype(np.float32)
    zero_rows[::3] = 0.0
    case(k8, "n2048 d40 PlanConfig(64,128), every third feature row all zero",
         erdos_renyi_csr(2048, 0.01, 91), 40, PlanConfig(64, 128), feat=zero_rows)
    case(k8, "n3000 d64 PlanConfig(32,128), gen_outlier_normal rows",
         erdos_renyi_csr(3000, 0.01, 92), 64, PlanConfig(32, 128),
         feat=gen_outlier_normal((3000, 64), outlier_frac=0.02, seed=1))
    dup_ptr, dup_idx, dup_n = with_duplicates(erdos_renyi_csr(800, 0.02, 93), 93)
    case(k8, "n800 d40 PlanConfig(32,128), duplicate edges",
         sp.csr_matrix((np.ones(len(dup_idx), np.float32), dup_idx, dup_ptr), shape=(dup_n, dup_n)),
         40, PlanConfig(32, 128))
    # K8 on K1's walk: a power-law hub window cut into pieces, a window of
    # exactly 2 x PIECE_BLOCKS blocks, d 130; the hub rows under the float32
    # summation bound; features from a generator of their own, so those of
    # the paths below stay as they were
    pb8 = block_spmm.PIECE_BLOCKS[k8]
    print(f"  (K8's pieces: PIECE_BLOCKS {pb8}, PIECE_WORK {block_spmm.PIECE_WORK[k8]})")
    rng8 = np.random.default_rng(94)

    def feat8(n, d):
        return rng8.standard_normal((n, d)).astype(np.float32)

    case(k8, "n40000 d128 block_h 128, block_w 32, hub window cut into >= 16 pieces", hub40k,
         128, PlanConfig(128, 32), feat=feat8(40000, 128),
         expect=lambda p: most_pieces(p, k8) >= 16, bound=True)
    case(k8, f"n{128 * 2 * pb8 + 2048} d64 window 0 of exactly 2 x {pb8} blocks",
         window0_of(2 * pb8, 95), 64, PlanConfig(128, 128), feat=feat8(128 * 2 * pb8 + 2048, 64),
         expect=lambda p: int(p.block_ptr[1]) == 2 * pb8)
    case(k8, "n40000 d130 block_h 128, block_w 128 (int8 rows of 132 bytes), hub window cut",
         hub40k, 130, PlanConfig(128, 128), feat=feat8(40000, 130),
         expect=lambda p: most_pieces(p, k8) >= 4, bound=True)

    def close(name, label, got, want, extra="", limit=1e-6):
        """One K13-K15 output against its plain version: calc_diff < limit
        (1e-6; 1e-8 for the backward's compute variants, which round the same
        p and draw as their plain versions) and |got - want| <= 1e-4 |want| +
        1e-5 max|want| (float32 sums in another order, a softmax merged
        across tasks)."""
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{name} {label}: kernel output {tuple(got.shape)} is not a finite "
                 f"{tuple(want.shape)}")
        scale = want.abs().max().item() if want.numel() else 0.0
        diff = calc_diff(got, want)
        err = (got - want).abs().max().item() if got.numel() else 0.0
        max_err[name] = max(max_err[name], err)
        ok = diff < limit and torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
        print(f"    {name} {label}: calc_diff {diff:.3e}, max|kernel - plain| {err:.3e} "
              f"(max|plain| {scale:.3e}){extra} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version on {label}")

    def fwd_close(name, label, nq, out_k, lse_k, out_p, lse_p, limit=1e-6):
        """A forward's out and lse (last axis: rows) against its plain
        version's (out at calc_diff < limit); rows without edges exactly 0
        with lse exactly 1e30."""
        empty = lse_p == 1e30
        rows_empty = empty[..., :nq]
        exact = bool((lse_k[empty] == 1e30).all()) and bool((out_k[rows_empty] == 0).all())
        close(name, f"{label} out", out_k, out_p, limit=limit)
        finite = ~empty
        lse_err = (lse_k[finite] - lse_p[finite]).abs().max().item() if finite.any() else 0.0
        lse_ok = lse_err <= 1e-5 * max(1.0, lse_p[finite].abs().max().item()) and exact
        print(f"    {name} {label} lse: max|kernel - plain| {lse_err:.3e}; "
              f"{int(rows_empty.sum())} (head, row) pairs without edges "
              f"{'exactly 0 / 1e30' if exact else 'NOT EXACT'} -> {'ok' if lse_ok else 'MISMATCH'}")
        if not lse_ok:
            fail(f"kernel {name}'s lse disagrees with its plain version on {label}")

    def compute_close(name, label, nq, kernel, plain, limit=1e-6):
        """A forward at a 16-bit compute_dtype (K9's or K13's kernel of
        csrc/attn_fwd_half.cuh) against its plain version, which rounds at
        the same points (fwd_close's tolerance, out at calc_diff < limit;
        rows without edges exactly 0 with lse 1e30), and twice on the input,
        the same bits."""
        out_k, lse_k = kernel()
        out_p, lse_p = plain()
        torch.cuda.synchronize()
        fwd_close(name, f"{label} compute_dtype {name.rsplit('_', 1)[1]}", nq, out_k, lse_k,
                  out_p, lse_p, limit)
        again = kernel()
        same = torch.equal(again[0], out_k) and torch.equal(again[1], lse_k)
        print(f"    {name} {label}: (out, lse) twice {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of {name} on the same input differ")

    def bwd_twice(label, what, first, again):
        """A backward kernel's outputs from two launches on one input: the
        same bits, or fail (K11, K12, K14 and K15 sum in a fixed order)."""
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"    {what} twice on {label}: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of {what} on the same input differ")

    def attn1_compare(label, plan, plan_t, q, k, v, g, slope):
        """K9, K10, K11 and K12 against their plain versions on one head (q
        (n, dk) etc.); the backward takes the plain forward's out and lse.
        K10's lane planes must be exactly 0 on lanes without bits; K11 and
        K12 twice on the same input the same bits."""
        kw = dict(negative_slope=slope)
        out_k, lse_k = spmm_attention(plan, q, k, v, return_stats=True, **kw)
        out_p, lse_p = spmm_attention_reference(plan, q, k, v, return_stats=True, **kw)
        torch.cuda.synchronize()
        fwd_close("attn_fwd", label, plan.num_nodes, out_k, lse_k, out_p, lse_p)
        kb = dict(kw, compute_dtype=torch.bfloat16, return_stats=True)
        compute_close("attn_fwd_bf16", label, plan.num_nodes,
                      lambda: spmm_attention(plan, q, k, v, **kb),
                      lambda: spmm_attention_reference(plan, q, k, v, **kb))
        kw["scale"] = 1.0 / q.shape[1] ** 0.5
        got = attention_bwd(plan, q, k, v, out_p, lse_p, g, **kw)
        want = attention_bwd_reference(plan, q, k, v, out_p, lse_p, g, **kw)
        unset = (plan.bitmask == 0).all(1).reshape(-1)
        zero = all(bool((t[unset] == 0).all()) for t in got[1:])
        extra = f", {int(unset.sum())} lanes without bits {'all 0.0' if zero else 'NOT ZERO'}"
        for part, a, b in zip(("dq", "dk lanes", "dv lanes"), got, want):
            close("attn_bwd", f"{label} {part}", a, b, extra if part != "dq" else "")
        if not zero:
            fail(f"kernel attn_bwd writes lanes without bits on {label}")
        # K10 with its fixed-order sum against the plain planes summed by scatter_lanes
        summed = attention_bwd_summed(plan, q, k, v, out_p, lse_p, g, **kw)
        nk = k.shape[0]
        plain = (want[0], scatter_lanes(plan, want[1], nk), scatter_lanes(plan, want[2], nk))
        for part, a, b in zip(("dq", "dk", "dv"), summed, plain):
            close("attn_bwd", f"{label} summed {part}", a, b)
        bwd = (q, k, v, g, lse_p, (g * out_p).sum(-1))
        dq = attention_dq(plan, *bwd, **kw)
        close("attn_dq", f"{label} dq", dq, attention_dq_reference(plan, *bwd, **kw))
        dkv = attention_dkv(plan_t, *bwd, **kw)
        for part, a, b in zip(("dk", "dv"), dkv, attention_dkv_reference(plan_t, *bwd, **kw)):
            close("attn_dkv", f"{label} {part}", a, b)
        bwd_twice(label, "K11 (dq) and K12 (dk, dv)", (dq, *dkv),
                  (attention_dq(plan, *bwd, **kw), *attention_dkv(plan_t, *bwd, **kw)))
        attn1_compute_bwd(label, plan, plan_t, q, k, v, g, slope)

    def attn1_compute_bwd(label, plan, plan_t, q, k, v, g, slope):
        """K10's, K11's and K12's compute variants (compute_dtype=bfloat16)
        against their plain versions at calc_diff < 1e-8, on the compute
        forward's out and lse (K10's lanes without bits exactly 0); each
        twice on one input, the same bits."""
        kw = dict(negative_slope=slope, compute_dtype=torch.bfloat16)
        out, lse = spmm_attention_reference(plan, q, k, v, return_stats=True, **kw)
        kw["scale"] = 1.0 / q.shape[1] ** 0.5
        got = attention_bwd(plan, q, k, v, out, lse, g, **kw)
        want = attention_bwd_reference(plan, q, k, v, out, lse, g, **kw)
        unset = (plan.bitmask == 0).all(1).reshape(-1)
        zero = all(bool((t[unset] == 0).all()) for t in got[1:])
        for part, a, b in zip(("dq", "dk lanes", "dv lanes"), got, want):
            close("attn_bwd_bf16", f"{label} compute bf16 {part}", a, b, limit=1e-8)
        if not zero:
            fail(f"K10's compute variant writes lanes without bits on {label}")
        summed = attention_bwd_summed(plan, q, k, v, out, lse, g, **kw)
        nk = k.shape[0]
        plain = (want[0], scatter_lanes(plan, want[1], nk), scatter_lanes(plan, want[2], nk))
        for part, a, b in zip(("dq", "dk", "dv"), summed, plain):
            close("attn_bwd_bf16", f"{label} compute bf16 summed {part}", a, b, limit=1e-8)
        bwd = (q, k, v, g, lse, (g * out).sum(-1))
        dq = attention_dq(plan, *bwd, **kw)
        close("attn_dq_bf16", f"{label} compute bf16 dq", dq,
              attention_dq_reference(plan, *bwd, **kw), limit=1e-8)
        dkv = attention_dkv(plan_t, *bwd, **kw)
        for part, a, b in zip(("dk", "dv"), dkv, attention_dkv_reference(plan_t, *bwd, **kw)):
            close("attn_dkv_bf16", f"{label} compute bf16 {part}", a, b, limit=1e-8)
        bwd_twice(label, "the compute variants of K10 (summed), K11 and K12",
                  (*summed, dq, *dkv),
                  (*attention_bwd_summed(plan, q, k, v, out, lse, g, **kw),
                   attention_dq(plan, *bwd, **kw), *attention_dkv(plan_t, *bwd, **kw)))

    def attn_compare(label, plan, plan_t, q, k, v, g, slope, pdt):
        """K13, K14 and K15 against their plain versions on one problem; the
        backward takes the plain forward's lse and D. Rows without edges
        must come out exactly 0 with lse exactly 1e30, and K13, K14 and K15
        twice on the same input the same bits."""
        kw = dict(negative_slope=slope, plane_dtype=pdt)
        scale = 1.0 / q.shape[2] ** 0.5
        out_k, lse_k = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
        out_p, lse_p = spmm_attention_mh_reference(plan, q, k, v, return_stats=True, **kw)
        torch.cuda.synchronize()
        fwd_close("attn_mh_fwd", label, plan.num_nodes, out_k, lse_k, out_p, lse_p)
        again = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
        same = torch.equal(again[0], out_k) and torch.equal(again[1], lse_k)
        print(f"    attn_mh_fwd {label}: K13 (out, lse) twice "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of K13 on the same input differ")
        kb = dict(kw, compute_dtype=torch.bfloat16, return_stats=True)
        compute_close("attn_mh_fwd_bf16", label, plan.num_nodes,
                      lambda: spmm_attention_mh(plan, q, k, v, **kb),
                      lambda: spmm_attention_mh_reference(plan, q, k, v, **kb))
        d_row = (g * out_p).sum(-1)
        bwd = (q, k, v, g, lse_p, d_row)
        kw["scale"] = scale
        dq_k = attention_mh_dq(plan, *bwd, **kw)
        close("attn_mh_dq", f"{label} dq", dq_k, attention_mh_dq_reference(plan, *bwd, **kw))
        dk_k, dv_k = attention_mh_dkv(plan_t, *bwd, **kw)
        dk_p, dv_p = attention_mh_dkv_reference(plan_t, *bwd, **kw)
        close("attn_mh_dkv", f"{label} dk", dk_k, dk_p)
        close("attn_mh_dkv", f"{label} dv", dv_k, dv_p)
        bwd_twice(label, "K14 (dq) and K15 (dk, dv)", (dq_k, dk_k, dv_k),
                  (attention_mh_dq(plan, *bwd, **kw), *attention_mh_dkv(plan_t, *bwd, **kw)))
        mh_compute_bwd(label, plan, plan_t, q, k, v, g, slope, pdt)

    def mh_compute_bwd(label, plan, plan_t, q, k, v, g, slope, pdt):
        """K14's and K15's compute variants (compute_dtype=bfloat16) against
        their plain versions at calc_diff < 1e-8 on the compute forward's
        lse and D, each twice on one input, the same bits. Returns (dq, dk,
        dv) and the inputs (q, k, v, dO, lse, D)."""
        kw = dict(negative_slope=slope, plane_dtype=pdt, compute_dtype=torch.bfloat16)
        out, lse = spmm_attention_mh_reference(plan, q, k, v, return_stats=True, **kw)
        bwd = (q, k, v, g, lse, (g * out).sum(-1))
        kw["scale"] = 1.0 / q.shape[2] ** 0.5
        dq = attention_mh_dq(plan, *bwd, **kw)
        close("attn_mh_dq_bf16", f"{label} compute bf16 dq", dq,
              attention_mh_dq_reference(plan, *bwd, **kw), limit=1e-8)
        dkv = attention_mh_dkv(plan_t, *bwd, **kw)
        for part, a, b in zip(("dk", "dv"), dkv, attention_mh_dkv_reference(plan_t, *bwd, **kw)):
            close("attn_mh_dkv_bf16", f"{label} compute bf16 {part}", a, b, limit=1e-8)
        bwd_twice(label, "the compute variants of K14 and K15", (dq, *dkv),
                  (attention_mh_dq(plan, *bwd, **kw), *attention_mh_dkv(plan_t, *bwd, **kw)))
        return (dq, *dkv), bwd

    def attn_case(label, a, cfg, heads, dk, dv, slope=0.2, pdt=None, cfg_t=None, expect=None):
        """K13-K15 on plans of `a` and of its transpose (`cfg_t`, default
        `cfg`), with random q, k, v and dO."""
        n = a.shape[0]
        at = a.T.tocsr()
        plan = csr_preprocess(a.indptr, a.indices, n, cfg)
        plan_t = csr_preprocess(at.indptr, at.indices, n, cfg_t or cfg)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")
        q, k, g = (feat_of(heads * n, d).view(heads, n, d) for d in (dk, dk, dv))
        v = feat_of(heads * n, dv).view(heads, n, dv)
        pname = "bf16" if pdt is not None else "f32"
        print(f"  {label}, H {heads}, dk {dk}, dv {dv}, slope {slope}, {pname} planes:")
        plan, plan_t = plan.to(dev), plan_t.to(dev)
        attn_compare(label, plan, plan_t, q, k, v, g, slope, pdt)
        print(f"  {label}, head 0, dk {dk}, dv {dv}, slope {slope}, float32:")
        attn1_compare(label, plan, plan_t, q[0], k[0], v[0], g[0], slope)

    def isolated(a, keep):
        """`a` with the rows and columns r for which keep(r) is false emptied."""
        d = sp.diags(np.array([1.0 if keep(r) else 0.0 for r in range(a.shape[0])]))
        b = (d @ a @ d).tocsr()
        b.eliminate_zeros()
        return b

    print("kernels K13, K14 and K15 (multi-head attention) and K9-K12 (one head) against "
          "their plain versions:")
    bf16 = torch.bfloat16
    er = erdos_renyi_csr(3001, 0.005, 60)
    attn_case("n3001 PlanConfig(128,128,block_unroll=4)", er, PlanConfig(128, 128, block_unroll=4),
              8, 8, 8)
    attn_case("n3001 PlanConfig(128,128,block_unroll=4)", er, PlanConfig(128, 128, block_unroll=4),
              8, 8, 8, pdt=bf16)
    attn_case("n2000 PlanConfig(128,128,block_unroll=4)", erdos_renyi_csr(2000, 0.01, 61),
              PlanConfig(128, 128, block_unroll=4), 1, 40, 40, pdt=bf16)
    attn_case("n1500 PlanConfig(32,128)", erdos_renyi_csr(1500, 0.01, 62), PlanConfig(32, 128),
              3, 12, 20, slope=1.0)
    attn_case("n1200 PlanConfig(64,128) (widths not a multiple of 4)",
              erdos_renyi_csr(1200, 0.01, 63), PlanConfig(64, 128), 3, 10, 6)
    directed = sp.random(2000, 2000, density=0.005, format="csr",
                         random_state=np.random.default_rng(64))
    directed.data[:] = 1.0
    for pdt in (None, bf16):
        attn_case("n2000 directed, PlanConfig(32,128), A^T PlanConfig(64,128,block_unroll=2)",
                  directed, PlanConfig(32, 128), 3, 12, 20, pdt=pdt,
                  cfg_t=PlanConfig(64, 128, block_unroll=2))
    attn_case("n10240 empty windows left without blocks",
              rows_only(erdos_renyi_csr(10240, 0.002, 65), lambda r: r < 128),
              PlanConfig(128, 128), 2, 8, 8, expect=lambda p: p.has_empty_windows)
    attn_case("n3000 isolated rows (every 7th), tail windows of zero-bit blocks",
              isolated(erdos_renyi_csr(3000, 0.005, 66), lambda r: r % 7 and r < 2700),
              PlanConfig(64, 128, block_unroll=2), 3, 8, 8, pdt=bf16, expect=zero_block)
    for heads, dk, dv, pdt in ((8, 8, 8, bf16), (1, 40, 40, None), (1, 40, 200, bf16)):
        attn_case("n8000 power-law hub windows cut over several tasks", hub,
                  PlanConfig(128, 128, block_unroll=4), heads, dk, dv, pdt=pdt,
                  expect=lambda p: int(torch.diff(p.block_ptr).max()) > 16)
    attn_case("n700 PlanConfig(48,128) (block_h not a multiple of 32)",
              erdos_renyi_csr(700, 0.02, 67), PlanConfig(48, 128), 2, 8, 8)
    attn_case("n3000 PlanConfig(256,128)", erdos_renyi_csr(3000, 0.01, 68), PlanConfig(256, 128),
              2, 16, 16, pdt=bf16)
    attn_case("n3000 PlanConfig(128,256)", erdos_renyi_csr(3000, 0.01, 69), PlanConfig(128, 256),
              2, 16, 16)
    attn_case("n1000 PlanConfig(2048,128) (tall windows, narrow tiles)",
              erdos_renyi_csr(1000, 0.01, 70), PlanConfig(2048, 128), 1, 300, 300)

    def attn_pieces(plan, d):
        """What K9's work list gives `plan`: pieces, windows cut, the most
        pieces of one window, the heaviest piece's work against the mean,
        the workspace at width d."""
        st = attention.attention_walk_stats(plan, "spmm_attention", d)
        most = int(torch.bincount(
            attention.attention_walk(plan, "spmm_attention").tasks[:, 0].long()).max())
        return (f"K9's work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS['spmm_attention']}, "
                f"PIECE_WORK {block_spmm.PIECE_WORK['spmm_attention']}): {st['pieces']} pieces, "
                f"{st['cut_windows']} windows cut, at most {most} in one window, heaviest "
                f"{st['max_task_work']} units of work against a mean of "
                f"{st['mean_task_work']:.1f}, workspace {st['workspace_mib']:.2f} MiB at d {d}")

    def attn_twice(label, plan, q, k, v, g):
        """K9 (out, lse) and K10 with its fixed-order sum (dq, dk, dv) twice
        on the same input: the same bits, or fail."""
        a1 = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2)
        a2 = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2)
        kw = dict(scale=1.0 / q.shape[1] ** 0.5, negative_slope=0.2)
        b1 = attention_bwd_summed(plan, q, k, v, *a1, g, **kw)
        b2 = attention_bwd_summed(plan, q, k, v, *a1, g, **kw)
        same = all(torch.equal(x, y) for x, y in zip((*a1, *b1), (*a2, *b2)))
        print(f"    K9 (out, lse) and K10 (dq, summed dk and dv) twice on {label}: "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{label}: two runs of K9 or K10 on the same input differ")

    rng9 = np.random.default_rng(96)

    def attn1_case(label, a, cfg, d, offset=False, expect=None):
        """K9, K10 and K10's fixed-order sum (and K11, K12) against their plain
        versions on one head of width d, q, k, v and dO from a generator of
        their own (with `offset`, views 4 bytes past a 16-byte boundary), then
        K9 and K10 twice on the same input."""
        n = a.shape[0]
        at = a.T.tocsr()
        plan = csr_preprocess(a.indptr, a.indices, n, cfg).to(dev)
        plan_t = csr_preprocess(at.indptr, at.indices, n, cfg).to(dev)
        if expect is not None and not expect(plan):
            fail(f"{label}: the plan lacks the property this case is for")

        def rows():
            x = torch.from_numpy(rng9.standard_normal((n, d)).astype(np.float32)).to(dev)
            if not offset:
                return x
            buf = torch.empty(n * d + 1, device=dev)
            buf[1:] = x.reshape(-1)
            return buf[1:].view(n, d)

        q, k, v, g = rows(), rows(), rows(), rows()
        print(f"  {label}, d {d}{', rows 4 bytes past a 16-byte boundary' if offset else ''}: "
              f"{attn_pieces(plan, d)}")
        attn1_compare(label, plan, plan_t, q, k, v, g, 0.2)
        attn_twice(label, plan, q, k, v, g)

    def k9_most_pieces(p):
        return int(torch.bincount(
            attention.attention_walk(p, "spmm_attention").tasks[:, 0].long()).max())

    print("kernels K9 and K10 (and K10's fixed-order sum) on their work list:")
    for d in (8, 12, 40):
        attn1_case("n8000 power-law hub window cut into >= 16 pieces", hub,
                   PlanConfig(128, 128, block_unroll=4), d,
                   expect=lambda p: k9_most_pieces(p) >= 16)
    attn1_case("n8000 power-law hub window cut into >= 16 pieces", hub,
               PlanConfig(128, 128, block_unroll=4), 40, offset=True,
               expect=lambda p: k9_most_pieces(p) >= 16)
    attn1_case("n3001 PlanConfig(128,128,block_unroll=4), a tail window past n", er,
               PlanConfig(128, 128, block_unroll=4), 12, offset=True,
               expect=lambda p: p.num_nodes % 128 != 0)
    attn1_case("n10240 empty windows left without blocks",
               rows_only(erdos_renyi_csr(10240, 0.002, 65), lambda r: r < 128),
               PlanConfig(128, 128), 40, expect=lambda p: p.has_empty_windows)
    attn1_case("n3000 isolated rows (every 7th), tail windows of zero-bit blocks",
               isolated(erdos_renyi_csr(3000, 0.005, 66), lambda r: r % 7 and r < 2700),
               PlanConfig(64, 128, block_unroll=2), 40, expect=zero_block)

    # the bf16 and float16 instantiations of K1, K2, K3 and K6 on small
    # geometries: each bit for bit the float32 kernel on the widened rows
    # (the walk's order does not depend on the source), twice the same bits,
    # and against its plain version; rows padded by the wrapper (d 130, 300),
    # rows 2 bytes off an 8-byte boundary, hub windows cut into pieces, K3's
    # runs across 128-lane tiles at seg 12-192 and both its walks; each
    # dtype's features from a generator of its own

    def half_check(key, label, plan, xb, deg=None):
        """The 16-bit instantiation `key` on `plan` and rows `xb` (bf16 or
        float16) against the float32 kernel on the widened rows (bit for
        bit), twice (the same bits) and its plain version (as compare(),
        under the summation bound with `deg`)."""
        name = half_of[key]
        kernel, plain = kernels[name][:2]
        xw = xb.float()
        out = kernel(plan, xb, torch.float32)
        same = torch.equal(out, kernel(plan, xw, torch.float32))
        again = torch.equal(out, kernel(plan, xb, torch.float32))
        want = plain(plan, xb, torch.float32)
        torch.cuda.synchronize()
        allow = TOL_KERNEL["atol"] + TOL_KERNEL["rtol"] * want.abs()
        if deg is not None:
            abs_plan = plan
            if name == "spmm_ell":
                abs_plan = dataclasses.replace(plan, vals=plan.vals.abs())
            allow = allow + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * plain(abs_plan, xw.abs())
        err = (out - want).abs().max().item() if out.numel() else 0.0
        half_err[key] = max(half_err[key], err)
        ok = (same and again and out.dtype == torch.float32
              and bool(((out - want).abs() <= allow).all()))
        what = key.rsplit("_", 1)[1]
        print(f"  {key} {label}: {what} {'==' if same else '!='} float32 kernel on the widened "
              f"rows, twice {'bit-identical' if again else 'DIFFERENT'}, max|kernel - plain| "
              f"{err:.3e} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{key} {label}: not the float32 kernel's bits on the widened rows, not the "
                 "same twice, or off its plain version")

    def half_sources(suffix, dtype, rng):
        """Phase 3's cases of the `suffix` ("bf16" or "f16") instantiations
        on rows of `dtype`, features and values from `rng`; then K6 under
        compute_dtype=dtype (its edge values rounded in the kernel)."""

        def case(name, label, plan, d, offset=False, deg=None):
            """half_check at width d; offset: a contiguous view 2 bytes past
            an 8-byte boundary."""
            n = plan.source_rows
            x = torch.from_numpy(rng.standard_normal((n, d + offset)).astype(np.float32))
            xb = x.to(dev).to(dtype)
            if offset:
                xb = xb.reshape(-1)[1:1 + n * d].view(n, d)
            half_check(f"{name}_{suffix}",
                       f"{label} d{d}{' (rows 2 bytes off 8)' if offset else ''}", plan, xb, deg)

        print(f"{suffix} sources (K1, K2, K3, K6) on small geometries:")
        for cfg in (PlanConfig(128, 128), PlanConfig(32, 128)):
            p16 = csr_preprocess(er3.indptr, er3.indices, 3000, cfg).to(dev)
            for d in (8, 40, 128, 130, 256, 300):
                case("spmm_block", f"n3000 block_h {cfg.block_h}", p16, d)
            case("spmm_block", f"n3000 block_h {cfg.block_h}", p16, 128, offset=True)
        p16 = csr_preprocess(hub40k.indptr, hub40k.indices, 40000, PlanConfig(128, 128)).to(dev)
        if most_pieces(p16, "spmm_block") < 16:
            fail(f"{suffix} K1: the hub window is not cut into >= 16 pieces")
        for d in (128, 130):
            case("spmm_block", "n40000 hub window cut into >= 16 pieces", p16, d, deg=deg40k)
        p16 = csr_preprocess(hub40k.indptr, hub40k.indices, 40000,
                             PlanConfig(512, 128, block_unroll=2, cluster_cols=True)).to(dev)
        for d in (40, 128, 130, 256):
            case("spmm_subtile", "n40000 PlanConfig(512, 128, 2, clustered)", p16, d,
                 deg=deg40k)
        case("spmm_subtile", "n40000 PlanConfig(512, 128, 2, clustered)", p16, 128,
             offset=True, deg=deg40k)
        p16 = csr_preprocess(er3.indptr, er3.indices, 3000, PlanConfig(128, 128, 8)).to(dev)
        for d in (8, 12, 40, 128, 130, 256, 300):  # narrow and wide walks, bulk and cp.async
            case("spmm_fused", "n3000 PlanConfig(128, 128, 8)", p16, d)
        case("spmm_fused", "n3000 PlanConfig(128, 128, 8)", p16, 128, offset=True)
        p16 = csr_preprocess(hub40k.indptr, hub40k.indices, 40000,
                             PlanConfig(128, 128, 8)).to(dev)
        for d in (8, 128, 256):
            case("spmm_fused", "n40000 PlanConfig(128, 128, 8), hub window cut", p16, d,
                 deg=deg40k)
        for seg in (12, 24, 48, 96, 192):  # boxes of 4-64 rows, runs across 128-lane tiles
            p16 = csr_preprocess(er3.indptr, er3.indices, 3000,
                                 PlanConfig(128, 384, seg)).to(dev)
            for d in (8, 128, 256):
                case("spmm_fused", f"n3000 PlanConfig(128, 384, {seg})", p16, d)
        vals16 = rng.standard_normal(er3.nnz).astype(np.float32)
        p16 = csr_preprocess_ell(er3.indptr, er3.indices, 3000,
                                 PlanConfig(128, 128, block_unroll=4), values=vals16).to(dev)
        for d in (8, 40, 130, 256):
            case("spmm_ell", "n3000 ELL PlanConfig(128, 128, 4)", p16, d)
        case("spmm_ell", "n3000 ELL PlanConfig(128, 128, 4)", p16, 40, offset=True)
        # compute_dtype: K6 rounds the edge values in the kernel too
        x16 = torch.from_numpy(rng.standard_normal((3000, 40)).astype(np.float32)).to(dev)
        got = spmm(p16, x16, compute_dtype=dtype)
        want = spmm_ell(dataclasses.replace(p16, vals=p16.vals.to(dtype).float()),
                        x16.to(dtype).float())
        print(f"  spmm_ell_{suffix} compute_dtype={dtype} (values rounded in the kernel) == "
              f"float32 kernel on the rounded rows and values: {torch.equal(got, want)}")
        if not (torch.equal(got, want) and got.dtype == torch.float32):
            fail(f"K6 under compute_dtype={dtype} is not the float32 kernel on the rounded "
                 "operands")

    er3 = erdos_renyi_csr(3000, 0.004, 98)
    deg40k = torch.from_numpy(np.diff(hub40k.indptr).astype(np.float32)).to(dev)[:, None]
    half_sources("bf16", torch.bfloat16, np.random.default_rng(97))
    half_sources("f16", torch.float16, np.random.default_rng(24))
    # K4's float16 instantiations on its work list's geometries (float16 rows
    # with each plane type), as its bf16 ones above
    print(f"kernel K4's float16 instantiations on its work list (PIECE_BLOCKS {pb}):")
    k4_half_case("n40000 PlanConfig(64,128), hub window cut into >= 16 pieces", hub40k,
                 PlanConfig(64, 128), (40, 130), expect=lambda p: most_pieces(p, k4) >= 16,
                 half=F16)
    k4_half_case("n40000 PlanConfig(64,128), hub window cut into >= 16 pieces", hub40k,
                 PlanConfig(64, 128), (40,), offset=True, half=F16)
    k4_half_case("n8000 PlanConfig(64,128), values off the bitmask on cut windows", hub,
                 PlanConfig(64, 128), (40,), expect=lambda p: most_pieces(p, k4) >= 4,
                 off_mask=True, half=F16)

    # --- 4. + 5. the paths ------------------------------------------------
    part("phase 3")
    count_keys = list(kernels) + list(bf16_of) + list(f16_of) + list(r_of)

    def reset_counts():
        for wrapper, plain, *_ in kernels.values():
            wrapper.launches = 0
            plain.calls = 0
        for name in (*bf16_of.values(), *r_of.values()):
            kernels[name][0].launches_bf16 = 0
        for name in f16_of.values():
            kernels[name][0].launches_f16 = 0

    def read_counts():
        """(launches by kernel, the bf16 instantiations (paths Q and R) apart
        under "<name>_bf16" and the float16 ones (path S) under "<name>_f16",
        also counted in <name>'s; plain-version calls)."""
        counts = {k: w.launches for k, (w, *_) in kernels.items()}
        counts.update({k: kernels[name][0].launches_bf16
                       for k, name in (*bf16_of.items(), *r_of.items())})
        counts.update({k: kernels[name][0].launches_f16 for k, name in f16_of.items()})
        return counts, sum(p.calls for _, p, *_ in kernels.values())

    def check_counts(label, counts, plain_calls, want_nonzero):
        want = {k: want_nonzero.get(k, 0) for k in count_keys}
        if counts != want or plain_calls != 0:
            fail(f"path {label} launched {counts} (want {want}) and the plain "
                 f"versions {plain_calls} times (want 0)")

    def library_ms(fn):
        return cuda_ms(torch, fn, iters=10, warmup=2)

    @contextlib.contextmanager
    def deterministic():
        """torch's deterministic mode, for the plain path that the training
        checks compare with: its index_add_ sums then come out the same in
        every run, as K13's do, so an edge whose score lies within rounding
        of leaky_relu's kink takes the same slope on each side in every run
        and the comparison does not change from run to run."""
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)

    def train(label, loss_fn, step, params, g, x, y, want_launches, atol_scale, **tol):
        """STEPS calls of step(params, g, x, y) (a training step over an
        optimizer that holds `params`) on the kernel path, counted; step 0's
        loss and gradients against loss_fn(..., impl="reference") from the
        same parameters (see grads_close for atol_scale and the tolerances
        `tol` may set). Returns (losses,
        launch counts, final loss, peak GiB)."""
        pref = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        with deterministic():
            loss_ref = loss_fn(pref, g, x, y, impl="reference")
            want = dict(zip(pref, torch.autograd.grad(loss_ref, list(pref.values()))))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, ms, grads0 = [], [], None
        for i in range(STEPS):
            t0 = time.perf_counter()
            losses.append(step(params, g, x, y))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                grads0 = {k: v.grad.detach().clone() for k, v in params.items()}
        counts, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  trained {STEPS} steps: launches {counts}, plain calls {plain_calls}; host ms "
              f"per step {[round(t, 3) for t in ms]}; losses {[round(l.item(), 6) for l in losses]};"
              f" torch.cuda.max_memory_allocated {peak:.3f} GiB")
        check_counts(label, counts, plain_calls, {k: STEPS * n for k, n in want_launches.items()})
        ok, diff, rel = grads_close(torch, calc_diff, grads0, want, atol_scale, **tol)
        loss_ok = torch.allclose(losses[0], loss_ref.detach(), rtol=1e-4, atol=0.0)
        print(f"  step 0 against the plain path: loss {losses[0].item():.6f} / "
              f"{loss_ref.item():.6f}, gradients worst calc_diff {diff:.3e}, worst "
              f"max|diff|/max|grad| {rel:.3e} -> {'ok' if ok and loss_ok else 'MISMATCH'}")
        if not (ok and loss_ok):
            fail(f"path {label}: step 0 disagrees with the plain path")
        with torch.no_grad():
            final = loss_fn(params, g, x, y)
        if not bool(torch.isfinite(final)):
            fail(f"path {label}: the loss after {STEPS} steps is not finite")
        print(f"  loss after {STEPS} steps {final.item():.6f} (step 0: {losses[0].item():.6f})")
        return losses, counts, final, peak

    def time_steps(step, params, g, x, y):
        """The training step on the kernel path and on the plain path, in
        turns, and a profile of 3 steps on the kernel path."""
        k_ms, p_ms, turns = in_turns(torch, lambda: step(params, g, x, y),
                                     lambda: step(params, g, x, y, impl="reference"),
                                     plain_iters=2)
        print(f"  training step: kernel path {k_ms:.4f} ms ({turns[1]:.4f} / {turns[2]:.4f}), "
              f"plain path {p_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        print_profile(*profile_requests(torch, lambda: step(params, g, x, y)), "training step")
        return k_ms, p_ms

    def serve(label, a, cfg, name, widths, host_rows=None, train_gcn=False, then=None):
        """Build the graph, serve REQUESTS requests on kernel `name`, check
        counts and logits, hold the kernel against its plain version at
        the path's widths, time both and the library call in turns, and
        (train_gcn) train the GCN on the same graph. Last, then(g, model,
        params_np, xs, logits) drives the paths that reuse the graph."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, cfg, symmetric=True, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        stats = plan_stats(g.plan)
        bpw = torch.diff(g.plan.block_ptr)
        extra = ""
        if cfg.cluster_cols:
            extra = f", sub-window occupancy {subtile_stats(g.plan)['occupancy']:.4f}"
        print(f"path {label}: {n} nodes, {stats['nnz']} nnz, {cfg}: "
              f"{stats['num_windows']} windows, {stats['total_blocks']} blocks (largest "
              f"window {int(bpw.max())}), fill {stats['fill_ratio']:.5f}, bitmask "
              f"{g.plan.bitmask.numel() * 4 / 2**20:.1f} MiB{extra}; build_graph {t_build:.2f} s, "
              f"host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        plan_tensors = ("bitmask", "hind", "window_of_block", "block_ptr")
        if not (all(getattr(g.plan, f).is_cuda for f in plan_tensors)
                and g.plan_t is g.plan and g.inv_deg.is_cuda):
            fail(f"path {label}: the plan is not on the card before the first request")

        prng = np.random.default_rng(1)
        params_np = {
            "w1": prng.standard_normal((in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
            "b1": prng.standard_normal(hidden) * 0.1,
            "w2": prng.standard_normal((hidden, classes)) * (2.0 / hidden) ** 0.5,
            "b2": prng.standard_normal(classes) * 0.1,
        }
        model = GCN.from_params(gcn_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(g, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, counts, plain_calls, {name: 2 * REQUESTS})

        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(g, x, impl="reference")
                torch.cuda.synchronize()
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and torch.allclose(out, ref, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, max|kernel - plain| "
                      f"{(out - ref).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")
        t0 = time.perf_counter()
        host = host_forward(a, xs[0].cpu().double().numpy(), params_np, host_rows)
        got = logits[0].cpu().double().numpy()
        if host_rows is not None:
            got = got[host_rows]
        host_err = float(np.abs(got - host).max())
        print(f"  request 0 against a float64 host forward ({len(got)} rows, "
              f"{time.perf_counter() - t0:.2f} s): max|diff| {host_err:.3e}")
        if not np.allclose(got, host, **TOL_LOGITS):
            fail(f"path {label} request 0 disagrees with the float64 host forward")

        kernel, plain = kernels[name][:2]
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev)
        plan_fields = [g.plan.bitmask, g.plan.hind, g.plan.block_ptr, g.plan.occ]
        per_width = {}
        for d in (in_dim, hidden):
            feat = xs[0] if d == in_dim else feat_of(n, d)
            compare(name, f"path {label} d{d} (float32 summation bound)", g.plan, (feat,), deg)
            k_ms, p_ms, turns = in_turns(torch, lambda: kernel(g.plan, feat),
                                         lambda: plain(g.plan, feat))
            lib = library_ms(lambda: torch.sparse.mm(csr, feat))
            b_ms, b_by = bound_ms(tensor_bytes(*plan_fields) + 2 * n * d * 4, 2 * a.nnz * d)
            per_width[d] = (k_ms, p_ms, lib, b_ms, b_by)
            print(f"  SpMM d={d}: {name} {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
        if name in walks:
            piece_line(f"path {label}", [g.plan], name, (in_dim, hidden))
            twice(f"path {label} {name} d{in_dim}", kernel, g.plan, xs[0])
        if name == "spmm_fused":
            twice(f"path {label} {name} d{hidden}", kernel, g.plan, feat_of(n, hidden))
        with torch.no_grad():
            x = xs[0]
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (GCN forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request", top=8)
        result = {"launches": counts[name], "request_ms": req_ms,
                  "plain_request_ms": plain_req_ms}
        result.update(widths_summary(per_width))

        trained = None
        if train_gcn:
            print(f"path {label}, training: GCN {in_dim} -> {hidden} -> {classes}, "
                  f"{STEPS} SGD steps (lr 0.1) on labels from the seed")
            tmodel = GCN.from_params(gcn_params_from_jax(params_np, dev))
            y = torch.from_numpy(np.random.default_rng(3).integers(0, classes, n)).to(dev)
            # atol 1e-3 x max|grad|: a ReLU input within float32 noise of 0
            # may switch between the two paths, moving one node's share of
            # a gradient (1.1e-4 of max|grad_b1| in one run of this script)
            _, _, _, peak = train(
                f"{label} training", gcn_loss,
                make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss),
                tmodel.params(), g, xs[0], y, {name: 3}, atol_scale=1e-3)
            step_ms, plain_step_ms = time_steps(
                make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss),
                tmodel.params(), g, xs[0], y)
            result.update(train_launches=STEPS * 3, train_step_ms=step_ms,
                          plain_train_step_ms=plain_step_ms, train_peak_gib=peak)
            trained = tmodel.params()
        if then is not None:
            then(g, model, params_np, xs, logits, trained)
        del g, csr
        torch.cuda.empty_cache()
        return result

    def loss_fell(label, losses, final):
        if not final.item() < losses[0].item():
            fail(f"path {label}: the loss after {STEPS} steps ({final.item():.6f}) is not "
                 f"below step 0's ({losses[0].item():.6f})")

    def widths_summary(per_width):
        """ms, plain_ms, library_ms and bound_ms: one call at each of the
        paths' widths, summed; and each width's numbers."""
        result = {"ms": sum(v[0] for v in per_width.values()),
                  "plain_ms": sum(v[1] for v in per_width.values()),
                  "library_ms": sum(v[2] for v in per_width.values()),
                  "bound_ms": sum(v[3] for v in per_width.values())}
        widest = max(per_width.values(), key=lambda v: v[3])
        result["bound_by"] = widest[4]
        for d, (k_ms, p_ms, lib, b_ms, _) in per_width.items():
            result[f"ms_d{d}"], result[f"plain_ms_d{d}"] = k_ms, p_ms
            result[f"library_ms_d{d}"], result[f"bound_ms_d{d}"] = lib, b_ms
        return result

    def gat_path(label, a, cfg, widths, heads):
        """Path D: GAT serving (K4) and training (K4 and K5) on `a`."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_gat_graph(a.indptr, a.indices, n, cfg, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        # the edges' orders by destination and by source (each node's sums in
        # the softmax and the logits' backward), built once per graph
        t0 = time.perf_counter()
        by_rows, by_cols = edge_orders(g)
        torch.cuda.synchronize()
        t_orders = time.perf_counter() - t0
        stats, stats_t = plan_stats(g.plan), plan_stats(g.plan_t)
        bpw = torch.diff(g.plan.block_ptr)
        plane_mib = stats["expanded_slots"] * 4 / 2**20
        print(f"path {label}: {n} nodes, {stats['nnz']} nnz, {cfg}: {stats['num_windows']} "
              f"windows, {stats['total_blocks']} blocks for A and {stats_t['total_blocks']} for "
              f"A^T (largest window {int(bpw.max())}, mean {float(bpw.float().mean()):.2f}), "
              f"value plane {plane_mib:.1f} MiB, largest slot {int(g.slots.max())}; "
              f"build_gat_graph {t_build:.2f} s, edge orders by rows and cols {t_orders:.3f} s "
              f"(rows {'sorted' if by_rows.perm is None else 'permuted'}, cols "
              f"{'sorted' if by_cols.perm is None else 'permuted'}), host peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        if not (g.plan.hind.is_cuda and g.plan_t.bitmask.is_cuda and g.slots.is_cuda):
            fail(f"path {label}: the graph is not on the card before the first request")

        prng = np.random.default_rng(2)  # init_gat's layouts and scales
        params_np = {
            "w1": prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
            "a1_src": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
            "a1_dst": prng.standard_normal((heads, hidden)) * hidden ** -0.5,
            "w2": prng.standard_normal((heads * hidden, classes)) * (2.0 / (heads * hidden)) ** 0.5,
            "a2_src": prng.standard_normal(classes) * classes ** -0.5,
            "a2_dst": prng.standard_normal(classes) * classes ** -0.5,
        }
        model = GAT.from_params(gat_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        per_request = heads + 1

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(g, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, counts, plain_calls, {"spmm_weighted": per_request * REQUESTS})
        serve_launches = counts["spmm_weighted"]
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(g, x, impl="reference")
                torch.cuda.synchronize()
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and torch.allclose(out, ref, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, max|kernel - plain| "
                      f"{(out - ref).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")
        export_model("D", lambda x: model(g, x), xs, logits, g.plan,
                     {"spmm_weighted": per_request}, ("spmm_weighted_kernel",))

        # layer 2's scores within rounding of leaky_relu's kink, and the edges
        # whose score has another sign on the kernel path than on the plain
        # path (layer 1's scores come from the same dense products on both);
        # each flip moves step 0's gradients by about one edge's share
        with torch.no_grad():
            x, raw = xs[0], []
            for impl in ("auto", "reference"):
                with deterministic() if impl == "reference" else contextlib.nullcontext():
                    h2 = F.elu(torch.cat([gat_attention_aggregate(
                        g, x @ model.w1[hh], model.a1_src[hh], model.a1_dst[hh], impl=impl)
                        for hh in range(heads)], dim=1)) @ model.w2
                raw.append((h2 @ model.a2_src).double()[g.rows]
                           + (h2 @ model.a2_dst).double()[g.cols])
            near = int((raw[1].abs() < 1e-5).sum())
            flips = int(((raw[0] > 0) != (raw[1] > 0)).sum())
            del raw, h2
        print(f"  layer-2 scores within rounding of leaky_relu's kink (|s + t| < 1e-5): {near}; "
              f"edges whose kernel-path and plain-path scores differ in sign: {flips}")

        # the kernels at the path's widths, on head 0's attention plane
        with torch.no_grad():
            h0 = (xs[0] @ model.w1[0]).contiguous()
            e = torch.nn.functional.leaky_relu(
                (h0 @ model.a1_src[0])[g.rows] + (h0 @ model.a1_dst[0])[g.cols], 0.2)
            alpha = edge_softmax(g, e)
            tb, H, K = g.plan.total_blocks, cfg.block_h, cfg.block_w
            plane = torch.zeros(tb * H * K, device=dev).index_add_(0, g.slots, alpha)
            wplan = dataclasses.replace(g.plan, values=plane.view(tb, H, K))
        nz = int(torch.count_nonzero(wplan.values))
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr_w = csr_tensor(torch, a, dev, alpha)
        csr_1 = csr_tensor(torch, a, dev)
        k4, k5 = kernels["spmm_weighted"][:2], kernels["spmm_dvalues"][:2]
        per_width = {"spmm_weighted": {}, "spmm_dvalues": {}}
        for d in (hidden, classes):
            feat = h0 if d == hidden else feat_of(n, d)
            grad = feat_of(n, d)
            compare("spmm_weighted", f"path {label} K4 d{d} (float32 summation bound)",
                    wplan, (feat,), deg)
            compare("spmm_dvalues", f"path {label} K5 d{d}", wplan, (feat, grad))
            k_ms, p_ms, turns = in_turns(torch, lambda: k4[0](wplan, feat),
                                         lambda: k4[1](wplan, feat))
            lib = library_ms(lambda: torch.sparse.mm(csr_w, feat))
            b_ms, b_by = bound_ms(
                tensor_bytes(wplan.values, wplan.hind, wplan.window_of_block) + 2 * n * d * 4,
                2 * nz * d)
            per_width["spmm_weighted"][d] = (k_ms, p_ms, lib, b_ms, b_by)
            print(f"  K4 d={d}: spmm_weighted {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})")
            twice(f"path {label} K4 d{d}", k4[0], wplan, feat)
            k_ms, p_ms, turns = in_turns(torch, lambda: k5[0](wplan, feat, grad),
                                         lambda: k5[1](wplan, feat, grad))
            feat_t = feat.t().contiguous()
            lib = library_ms(lambda: torch.sparse.sampled_addmm(csr_1, grad, feat_t, beta=0.0))
            # reads the plan's geometry, feat and g; writes the (tb, H, K) plane
            b_ms, b_by = bound_ms(
                tensor_bytes(wplan.bitmask, wplan.hind, wplan.window_of_block)
                + 2 * n * d * 4 + tb * H * K * 4, 2 * a.nnz * d)
            per_width["spmm_dvalues"][d] = (k_ms, p_ms, lib, b_ms, b_by)
            print(f"  K5 d={d}: spmm_dvalues {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.sampled_addmm {lib:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
            twice(f"path {label} K5 d{d}", lambda p, f, grad=grad: k5[0](p, f, grad), wplan, feat)
        with torch.no_grad():  # A^T's plane, which the feature gradient reads
            plane_t = torch.zeros(g.plan_t.total_blocks * H * K, device=dev).index_add_(
                0, g.slots_t, alpha)
            wplan_t = dataclasses.replace(g.plan_t, values=plane_t.view(-1, H, K))
            compare("spmm_weighted", f"path {label} K4 on A^T d{classes} (float32 summation "
                    "bound)", wplan_t, (feat,), deg)
        twice(f"path {label} K4 on A^T d{classes}", k4[0], wplan_t, feat)
        walk = block_spmm.plan_walk(wplan, "spmm_dvalues")
        print(f"  path {label} K5 work list of A (PIECE_BLOCKS "
              f"{block_spmm.PIECE_BLOCKS['spmm_dvalues']}, no workspace): "
              f"{walk.tasks.shape[0]} pieces, {walk.cut_windows} windows cut")
        for side, p in (("A", wplan), ("A^T", wplan_t)):
            walk = block_spmm.plan_walk(p, "spmm_weighted")
            most = int(walk.merges[:, 3].max()) if walk.merges.numel() else 1
            print(f"  path {label} K4 work list of {side} (PIECE_BLOCKS "
                  f"{block_spmm.PIECE_BLOCKS['spmm_weighted']}): {walk.tasks.shape[0]} pieces, "
                  f"{walk.cut_windows} windows cut (most pieces {most}); workspace "
                  + ", ".join(f"{walk.slots * walk.rows * d * 4 / 2**20:.2f} MiB at d {d}"
                              for d in (hidden, classes)))
        del wplan, plane, wplan_t, plane_t, csr_w, csr_1
        with torch.no_grad():
            x = xs[0]
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (GAT forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat.py:57) "
              "on labels from the seed")
        tmodel = GAT.from_params(gat_params_from_jax(params_np, dev))
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
        # atol 5e-5 x max|grad|: a1_src's gradient sums edge terms that cancel
        # (a softmax is blind to a shift of a row's logits), so its error is
        # set by the terms; python3 -m voltrix_spmm_tpu_torch.tools.grad_spread
        # needed up to 1.3e-5 (kernel path) and 1.5e-5 (plain path against
        # itself) at these shapes while both summed with float atomics, and
        # one run of this check 2.1e-5
        losses, train_counts, final, peak = train(
            f"{label} training", gat_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_loss),
            tmodel.params(), g, xs[0], y,
            {"spmm_weighted": 2 * per_request, "spmm_dvalues": per_request}, atol_scale=5e-5)
        loss_fell(label, losses, final)
        # step 0's gradients on the kernel path, twice from the same parameters
        p0 = GAT.from_params(gat_params_from_jax(params_np, dev)).params()

        def kernel_grads():
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
            loss = gat_loss(leaves, g, xs[0], y)
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        first, again = kernel_grads(), kernel_grads()
        same = all(torch.equal(first[k], again[k]) for k in first)
        print(f"  step 0's kernel-path gradients twice: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of step 0 on the kernel path give different gradients")
        del p0, first, again
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_loss),
            tmodel.params(), g, xs[0], y)
        results_k4 = {"launches": serve_launches, "train_launches": train_counts["spmm_weighted"],
                      "request_ms": req_ms, "plain_request_ms": plain_req_ms,
                      "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                      "train_peak_gib": peak, **widths_summary(per_width["spmm_weighted"])}
        results_k5 = {"launches": train_counts["spmm_dvalues"], "serve_launches": 0,
                      "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                      **widths_summary(per_width["spmm_dvalues"])}
        del g
        torch.cuda.empty_cache()
        return results_k4, results_k5

    def time_ell(label, wplan, feat, grad, csr_w, csr_1, nnz, per_width, deg):
        """K6 on `wplan` and `feat`, and K7 on (feat, grad), against their
        plain versions at the path's width (K6 under the float32 summation
        bound of rows of degree `deg`; K7 sums d terms); each timed in
        turns with its plain version and its library call
        (torch.sparse.mm on the weighted CSR `csr_w`, sampled_addmm on the
        pattern `csr_1`), with its bound."""
        n, d = wplan.num_nodes, feat.shape[1]
        compare("spmm_ell", f"path {label} K6 d{d} (float32 summation bound)", wplan, (feat,),
                deg)
        compare("spmm_ell_dvals", f"path {label} K7 d{d}", wplan, (feat, grad))
        k6, k7 = kernels["spmm_ell"][:2], kernels["spmm_ell_dvals"][:2]
        rows = ell.plan_rows(wplan)
        lanes = (rows.items[:, 2] - rows.items[:, 1]).float()
        print(f"  K6 row order (PIECE_LANES {ell.PIECE_LANES}): {rows.items.shape[0]} pieces, "
              f"{rows.merges.shape[0]} rows cut (most pieces "
              f"{int(rows.merges[:, 2].max()) if rows.merges.numel() else 1}), heaviest piece "
              f"{int(lanes.max())} lanes against a mean of {float(lanes.mean()):.1f}; workspace "
              f"{rows.slots * d * 4 / 2**20:.2f} MiB at d {d}")
        whole = k6[0](wplan, feat)
        same = torch.equal(whole, k6[0](wplan, feat))
        print(f"  spmm_ell twice at d{d}: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of K6 on the same input differ at d {d}")
        same = torch.equal(spmm_ell_streamed(wplan, feat, num_chunks=4), whole)
        print(f"  spmm_ell_streamed on 4 window chunks at d{d}: "
              f"{'bit-identical to the whole plan' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: K6 on window chunks differs from the whole plan at d {d}")
        k_ms, p_ms, turns = in_turns(torch, lambda: k6[0](wplan, feat), lambda: k6[1](wplan, feat))
        lib = library_ms(lambda: torch.sparse.mm(csr_w, feat))
        # reads hind, erow and vals, feat once; writes out once
        b_ms, b_by = bound_ms(tensor_bytes(wplan.hind, wplan.erow, wplan.vals) + 2 * n * d * 4,
                              2 * nnz * d)
        per_width["spmm_ell"][d] = (k_ms, p_ms, lib, b_ms, b_by)
        print(f"  K6 d={d}: spmm_ell {turns[1]:.4f} / {turns[2]:.4f} ms, plain {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        twice(f"path {label} spmm_ell_dvals d{d}", lambda p, f: k7[0](p, f, grad), wplan, feat)
        k_ms, p_ms, turns = in_turns(torch, lambda: k7[0](wplan, feat, grad),
                                     lambda: k7[1](wplan, feat, grad))
        feat_t = feat.t().contiguous()
        lib = library_ms(lambda: torch.sparse.sampled_addmm(csr_1, grad, feat_t, beta=0.0))
        # reads hind, erow, window_of_block, g and feat once; writes the lanes once
        b_ms, b_by = bound_ms(
            tensor_bytes(wplan.hind, wplan.erow, wplan.window_of_block) + 2 * n * d * 4
            + wplan.erow.numel() * 4, 2 * nnz * d)
        per_width["spmm_ell_dvals"][d] = (k_ms, p_ms, lib, b_ms, b_by)
        print(f"  K7 d={d}: spmm_ell_dvals {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.sampled_addmm {lib:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")

    def gat_ell_path(label, a, cfg, widths, heads):
        """Path E: dot-product GAT on ELL plans of `a`, serving (K6 and K7)
        and training (K6 and K7)."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_ell_graph(a.indptr, a.indices, n, cfg, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        st, st_t = ell_stats(g.plan), ell_stats(g.plan_t)
        bpw = torch.diff(g.plan.block_ptr)
        print(f"path {label}: {n} nodes, {st['nnz']} nnz, {cfg}: {st['num_windows']} windows, "
              f"{st['total_blocks']} blocks for A and {st_t['total_blocks']} for A^T (largest "
              f"window {int(bpw.max())}), {st['lane_slots']} lane slots (fill "
              f"{st['lane_fill']:.4f}, {st['value_bytes_per_edge']:.3f} value bytes per edge, "
              f"{st['lane_slots'] * 4 / 2**20:.2f} MiB per lane array); build_ell_graph "
              f"{t_build:.2f} s, host peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        if not (g.plan.hind.is_cuda and g.plan_t.lane_edge.is_cuda and g.rows.is_cuda):
            fail(f"path {label}: the graph is not on the card before the first request")

        prng = np.random.default_rng(2)  # init_gat_dot's layouts and scales
        h2 = heads * hidden
        params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                     for k in ("wq1", "wk1", "wv1")}
        params_np.update({k: prng.standard_normal((h2, classes)) * (2.0 / h2) ** 0.5
                          for k in ("wq2", "wk2", "wv2")})
        model = GATDot.from_params(gat_dot_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        per_request = heads + 1

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(g, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {serve_counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls,
                     {"spmm_ell": per_request * REQUESTS, "spmm_ell_dvals": per_request * REQUESTS})
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(g, x, impl="reference")
                torch.cuda.synchronize()
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and torch.allclose(out, ref, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, max|kernel - plain| "
                      f"{(out - ref).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")
        export_model("E", lambda x: model(g, x), xs, logits, None,
                     {"spmm_ell": per_request, "spmm_ell_dvals": per_request},
                     ("spmm_ell_rows_kernel", "spmm_ell_dvals_kernel"), ell_plan=g.plan)

        # scores within rounding of leaky_relu's kink, and the edges whose
        # score has another sign on the kernel path than on the plain path
        # (layer 1: K7 against the plain SDDMM on the same q and k; layer 2:
        # each path's q and k, products in float64); each flip moves step
        # 0's gradients by about one edge's share
        with torch.no_grad():
            x, p = xs[0], model.params()
            near, flips, hs = [0, 0], [0, 0], {}
            for impl in ("auto", "reference"):
                with deterministic() if impl == "reference" else contextlib.nullcontext():
                    hs[impl] = F.elu(torch.cat([dot_attention_aggregate(
                        g, x @ p["wq1"][hh], x @ p["wk1"][hh], x @ p["wv1"][hh], impl=impl)
                        for hh in range(heads)], dim=1))
            for hh in range(heads):
                q, k = x @ p["wq1"][hh], x @ p["wk1"][hh]
                e_k, e_p = (sddmm_ell_ad(g.plan, g.plan_t, q, k, impl=impl)
                            for impl in ("auto", "reference"))
                near[0] += int((e_p.abs() < 1e-6).sum())
                flips[0] += int(((e_k > 0) != (e_p > 0)).sum())
            raw = [(hs[impl] @ p["wq2"]).double()[g.rows] * (hs[impl] @ p["wk2"]).double()[g.cols]
                   for impl in ("auto", "reference")]
            raw = [r.sum(-1) for r in raw]
            near[1] = int((raw[1].abs() < 1e-5).sum())
            flips[1] = int(((raw[0] > 0) != (raw[1] > 0)).sum())
            del hs, raw
        print(f"  scores within rounding of leaky_relu's kink (layer 1 |e| < 1e-6, layer 2 "
              f"|q.k| < 1e-5): {near[0]} and {near[1]}; edges whose kernel-path and plain-path "
              f"scores differ in sign: {flips[0]} in layer 1, {flips[1]} in layer 2")

        # the kernels at the path's widths, on head 0's attention
        with torch.no_grad():
            x = xs[0]
            q, k, v = ((x @ model.params()[w][0]).contiguous() for w in ("wq1", "wk1", "wv1"))
            e = sddmm_ell(g.plan, q, k, per_edge=True) / hidden ** 0.5
            alpha = edge_softmax(g, F.leaky_relu(e, 0.2))
            wplan = dataclasses.replace(g.plan, vals=lane_values(g.plan, alpha))
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr_w, csr_1 = csr_tensor(torch, a, dev, alpha), csr_tensor(torch, a, dev)
        per_width = {"spmm_ell": {}, "spmm_ell_dvals": {}}
        for d in (hidden, classes):
            feat = v if d == hidden else feat_of(n, d)
            time_ell(label, wplan, feat, feat_of(n, d), csr_w, csr_1, a.nnz, per_width, deg)
        del wplan, csr_w, csr_1
        with torch.no_grad():
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (dot-product GAT forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat_dot.py:88) "
              "on labels from the seed")
        tmodel = GATDot.from_params(gat_dot_params_from_jax(params_np, dev))
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
        losses, train_counts, final, peak = train(
            f"{label} training", gat_dot_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_dot_loss),
            tmodel.params(), g, xs[0], y,
            {"spmm_ell": 4 * per_request, "spmm_ell_dvals": 2 * per_request}, atol_scale=1e-5)
        loss_fell(label, losses, final)
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_dot_loss),
            tmodel.params(), g, xs[0], y)
        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        del g
        torch.cuda.empty_cache()
        return {name: {"launches": serve_counts[name], "train_launches": train_counts[name],
                       **common, "per_width": per_width[name]}
                for name in ("spmm_ell", "spmm_ell_dvals")}

    def mh_pieces(plan, d, heads, name="spmm_attention_mh"):
        """What K13's, K14's or K15's work list gives `plan` (K15: the
        transpose plan), in the form of attn_pieces: d is the kernel's
        width (K15: dk = dv; its two workspaces)."""
        st = attention.attention_walk_stats(plan, name, 2 * d if name == "attention_mh_dkv" else d,
                                            heads)
        most = int(torch.bincount(attention.attention_walk(plan, name).tasks[:, 0].long()).max())
        if name == "spmm_attention_mh":
            kernel, group = "K13", (f"head group {attention_mh.mh_geometry(heads, d)[0]} of "
                                    f"HEAD_GROUP {attention_mh.HEAD_GROUP}")
        else:
            kernel = "K14" if name == "attention_mh_dq" else "K15"
            group = (f"head group {bwd_geometry(name, heads, d)[0]} of BWD_HEAD_GROUP "
                     f"{BWD_HEAD_GROUP[name]}")
        return (f"{kernel}'s work list (PIECE_BLOCKS {block_spmm.PIECE_BLOCKS[name]}, PIECE_WORK "
                f"{block_spmm.PIECE_WORK[name]}, {group}): {st['pieces']} pieces, "
                f"{st['cut_windows']} windows cut, at most {most} in one window, heaviest "
                f"{st['max_task_work']} units of work against a mean of "
                f"{st['mean_task_work']:.1f}, workspace {st['workspace_mib']:.2f} MiB at H "
                f"{heads} x d {d}")

    def time_attn(label, plan, q, k, v, g, pdt, per_width):
        """K13, K14 and K15 at one of path G's layers (q, k, v as the model
        projects them, dO): held against their plain versions, each twice on
        one input, timed in turns with them, and each kernel's bound from
        this problem's edges; K13 also after head-major copies of q, k and
        v made in the call (what reading through strides saves). K14 and
        K15 read the model's projections through their strides too, k and v
        cast to the plane's type once beforehand, as the backward casts
        them. Returns the time of the copies and K13 on them."""
        heads, n, dk = q.shape
        dv = v.shape[2]
        tag = f"H{heads} d{dk}"
        for name in ("spmm_attention_mh", "attention_mh_dq", "attention_mh_dkv"):
            print(f"  kernels at {tag}/{dv}: {mh_pieces(plan, dv, heads, name)}")
        lists = [attention.attention_walk(plan, x)
                 for x in ("spmm_attention_mh", "attention_mh_dq", "attention_mh_dkv")]
        if len({id(x) for x in lists}) != 3:
            fail(f"path {label}: K13, K14 and K15 share a work list")
        attn_compare(f"path {label} {tag}", plan, plan, q, k, v, g, 0.2, pdt)
        scale = 1.0 / dk ** 0.5
        kw = dict(negative_slope=0.2, plane_dtype=pdt)
        with torch.no_grad():
            out, lse = spmm_attention_mh(plan, q, k, v, return_stats=True, **kw)
            d_row = (g * out).sum(-1)
        kp, vp = (t if pdt is None else t.to(pdt) for t in (k, v))
        bwd = (q, kp, vp, g, lse, d_row)
        plane = 2 if pdt is not None else 4
        plan_bytes = tensor_bytes(plan.bitmask, plan.hind, plan.window_of_block, plan.block_ptr)
        edges = plan.num_edges * heads
        hn = heads * n
        fns = {
            # reads the plan, q, k and v once; writes out and lse once
            "attn_mh_fwd": (lambda: spmm_attention_mh(plan, q, k, v, **kw),
                            lambda: spmm_attention_mh_reference(plan, q, k, v, **kw),
                            plan_bytes + hn * (4 * dk + plane * (dk + dv) + 4 * dv)
                            + lse.numel() * 4, edges * 2 * (dk + dv)),
            # reads the plan, q, k, v, dO, lse and D once; writes dq once
            "attn_mh_dq": (lambda: attention_mh_dq(plan, *bwd, scale=scale, **kw),
                           lambda: attention_mh_dq_reference(plan, *bwd, scale=scale, **kw),
                           plan_bytes + hn * (4 * dk + plane * (dk + dv) + 4 * dv + 4 + 4 * dk)
                           + lse.numel() * 4, edges * (4 * dk + 2 * dv)),
            # reads the plan, q, k, v, dO (all in the plane dtype), lse and D
            # once; writes dk and dv once
            "attn_mh_dkv": (lambda: attention_mh_dkv(plan, *bwd, scale=scale, **kw),
                            lambda: attention_mh_dkv_reference(plan, *bwd, scale=scale, **kw),
                            plan_bytes + hn * (plane * 2 * (dk + dv) + 4 + 4 * (dk + dv))
                            + lse.numel() * 4, edges * 4 * (dk + dv)),
        }
        for name, (kernel, plain, nbytes, flops) in fns.items():
            k_ms, p_ms, turns = in_turns(torch, kernel, plain)
            b_ms, b_by = bound_ms(nbytes, flops)
            per_width[name][f"h{heads}_d{dk}"] = (k_ms, p_ms, None, b_ms, b_by)
            print(f"  {name} {tag}: kernel {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, no library call, bound {b_ms:.4f} ms "
                  f"({b_by})")
        # the alternative to reading through strides: head-major copies made
        # in the call, as K13's launcher made them before
        strided_ms, copies_ms, turns = in_turns(
            torch, fns["attn_mh_fwd"][0],
            lambda: spmm_attention_mh(plan, q.contiguous(), k.contiguous(), v.contiguous(), **kw),
            plain_iters=20)
        print(f"  attn_mh_fwd {tag}: K13 on the model's projections {turns[1]:.4f} / "
              f"{turns[2]:.4f} ms, head-major copies of them and K13 on those {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms")
        return copies_ms

    def gat_flash_path(label, a, cfg, widths, heads):
        """Path G: flash GAT on the binary plan of `a`, serving (K13) and
        training (K13, K14 and K15)."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, cfg, symmetric=True, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        stats = plan_stats(g.plan)
        bpw = torch.diff(g.plan.block_ptr)
        pdt = torch.bfloat16 if n >= 65536 else None  # models/gat_flash.py's rule
        print(f"path {label}: {n} nodes, {stats['nnz']} nnz, {cfg}: {stats['num_windows']} "
              f"windows, {stats['total_blocks']} blocks (largest window {int(bpw.max())}, mean "
              f"{float(bpw.float().mean()):.2f}), fill {stats['fill_ratio']:.5f}, bitmask "
              f"{g.plan.bitmask.numel() * 4 / 2**20:.1f} MiB, planes "
              f"{'bf16' if pdt is not None else 'f32'}; build_graph {t_build:.2f} s, host peak "
              f"RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        if not (g.plan.bitmask.is_cuda and g.plan_t is g.plan):
            fail(f"path {label}: the plan is not on the card before the first request")

        prng = np.random.default_rng(2)  # init_gat_flash (= init_gat_dot) layouts and scales
        h2 = heads * hidden
        params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                     for k in ("wq1", "wk1", "wv1")}
        params_np.update({k: prng.standard_normal((h2, classes)) * (2.0 / h2) ** 0.5
                          for k in ("wq2", "wk2", "wv2")})
        model = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(g, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {serve_counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls, {"attn_mh_fwd": 2 * REQUESTS})
        with torch.no_grad():
            same = torch.equal(model(g, xs[0]), logits[0])
        print(f"  request 0's logits again: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of request 0 give different logits")
        export_model("G", lambda x: model(g, x), xs, logits, g.plan, {"attn_mh_fwd": 2},
                     ("attn_mh_fwd",))
        # bf16 planes: float32 noise in layer 1's output may move a layer-2
        # input across a bf16 rounding boundary (one bf16 ulp, 2**-8
        # relative), so the two paths agree to the bf16 class (JAX's own bf16
        # plane tolerance, tests/test_attention.py:468-470); the same model
        # with float32 planes is held at the float32 tolerance
        g32 = (g.plan, g.plan_t, torch.float32)
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(g, x, impl="reference")
                out32, ref32 = model(g32, x), model(g32, x, impl="reference")
                torch.cuda.synchronize()
                diff = calc_diff(out, ref)
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and diff < 1e-4 and torch.allclose(out, ref, rtol=2e-2, atol=2e-2)
                      and torch.allclose(out32, ref32, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, bf16 planes: calc_diff "
                      f"{diff:.3e}, max|kernel - plain| {(out - ref).abs().max().item():.3e}; "
                      f"float32 planes: max|kernel - plain| "
                      f"{(out32 - ref32).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")

        # the kernels at the path's two layers, on request 0's activations
        per_width = {"attn_mh_fwd": {}, "attn_mh_dq": {}, "attn_mh_dkv": {}}
        p = model.params()
        with torch.no_grad():
            x = xs[0]
            # the layouts the model passes: node-major projections, viewed (H, n, d)
            q1, k1, v1 = (_project_heads(x, p[w]) for w in ("wq1", "wk1", "wv1"))
            heads1 = spmm_attention_mh(g.plan, q1, k1, v1, negative_slope=0.2, plane_dtype=pdt)
            h = F.elu(heads1.permute(1, 0, 2).reshape(n, -1))
            q2, k2, v2 = ((h @ p[w])[None] for w in ("wq2", "wk2", "wv2"))
        copies_ms = {
            "h8_d8": time_attn(label, g.plan, q1, k1, v1,
                               feat_of(heads * n, hidden).view(heads, n, hidden), pdt, per_width),
            "h1_d40": time_attn(label, g.plan, q2, k2, v2, feat_of(n, classes)[None], pdt,
                                per_width)}
        del q1, k1, v1, heads1, h, q2, k2, v2
        with torch.no_grad():
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(g, x), lambda: model(g, x, impl="reference"))
        print(f"  request (flash GAT forward): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(g, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat_dot.py:88) "
              "on labels from the seed")
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)

        def grads_of(impl, graph=g32):
            leaves = {k: v.requires_grad_(True)
                      for k, v in gat_flash_params_from_jax(params_np, dev).items()}
            loss = gat_flash_loss(leaves, graph, xs[0], y, impl=impl)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, grads))

        (loss_k, grads_k), (loss_p, grads_p) = grads_of("auto"), grads_of("reference")
        # atol 1e-4 x max|grad|: a hub row's dq sums ~38k terms whose
        # coefficients ds add up to 0 by construction (D = sum p dP), so
        # float32 rounding in another order is large against dq itself
        # (3.3e-5 x max|grad| on wq1 in one run of this script)
        ok, diff, rel = grads_close(torch, calc_diff, grads_k, grads_p, 1e-4)
        ok = ok and torch.allclose(loss_k, loss_p, rtol=1e-4, atol=0.0)
        print(f"  step-0 gradients with float32 planes against the plain path: loss "
              f"{loss_k.item():.6f} / {loss_p.item():.6f}, worst calc_diff {diff:.3e}, worst "
              f"max|diff|/max|grad| {rel:.3e} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {label}: float32-plane gradients disagree with the plain path")
        tmodel = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev))
        # bf16 planes, the path's own: the bf16 class, as for the logits
        losses, train_counts, final, peak = train(
            f"{label} training", gat_flash_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), g, xs[0], y,
            {"attn_mh_fwd": 2, "attn_mh_dq": 2, "attn_mh_dkv": 2}, atol_scale=1e-2,
            max_diff=1e-4, rtol=2e-2)
        loss_fell(label, losses, final)
        # step 0's gradients on the kernel path, twice from the same
        # parameters, with the path's bf16 planes and with float32 planes
        for graph, planes in ((g, "bf16"), (g32, "float32")):
            first, again = (grads_of("auto", graph)[1] for _ in range(2))
            same = all(torch.equal(first[k], again[k]) for k in first)
            print(f"  step 0's kernel-path gradients twice, {planes} planes: "
                  f"{'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                fail(f"path {label}: two runs of step 0 on the kernel path give different "
                     f"gradients ({planes} planes)")
        del first, again
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), g, xs[0], y)
        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        del g
        torch.cuda.empty_cache()
        results = {}
        for name, per in per_width.items():
            serve = serve_counts[name]
            counts = ({"launches": serve, "train_launches": train_counts[name]} if serve else
                      {"launches": train_counts[name], "serve_launches": 0})
            widest = max(per.values(), key=lambda t: t[3])
            results[name] = {**counts, **common,
                             "ms": sum(t[0] for t in per.values()),
                             "plain_ms": sum(t[1] for t in per.values()),
                             "library_ms": None,
                             "bound_ms": sum(t[3] for t in per.values()),
                             "bound_by": widest[4]}
            for tag, (k_ms, p_ms, _, b_ms, _) in per.items():
                results[name].update({f"ms_{tag}": k_ms, f"plain_ms_{tag}": p_ms,
                                      f"bound_ms_{tag}": b_ms})
        results["attn_mh_fwd"].update({f"copies_and_k13_ms_{tag}": t
                                       for tag, t in copies_ms.items()})
        return results

    def time_attn1(label, plan, q, k, v, g, per_width):
        """K9, K10, K11 and K12 at one of path H's layers (one head: q, k, v,
        dO): held against their plain versions, K9 and K10 twice on one input,
        timed in turns with their plain versions, each kernel's bound from
        this problem's edges; K9 beside K13 at one head (K13's walk with a
        group of one head on float32 planes), K10 (with its fixed-order sum,
        as the step runs it) beside K10's lane planes and scatter_lanes
        (index_add_) on them."""
        n, dk = q.shape
        dv = v.shape[1]
        tag = f"d{dk}"
        print(f"  kernels at one head of width {dk}/{dv}: {attn_pieces(plan, dv)}")
        attn1_compare(f"path {label} {tag}", plan, plan, q, k, v, g, 0.2)
        attn_twice(f"path {label} {tag}", plan, q, k, v, g)
        kw = dict(scale=1.0 / dk ** 0.5, negative_slope=0.2)
        with torch.no_grad():
            out, lse = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2)
            bwd = (q, k, v, g, lse, (g * out).sum(-1))
            _, dk_lane, dv_lane = attention_bwd(plan, q, k, v, out, lse, g, **kw)
        plan_bytes = tensor_bytes(plan.bitmask, plan.hind, plan.window_of_block, plan.block_ptr)
        edges, lanes = plan.num_edges, plan.total_blocks * plan.config.block_w

        def plain_bwd():
            dq, dkl, dvl = attention_bwd_reference(plan, q, k, v, out, lse, g, **kw)
            return dq, scatter_lanes(plan, dkl, n), scatter_lanes(plan, dvl, n)

        fns = {
            # reads the plan, q, k and v once; writes out and lse once
            "attn_fwd": (lambda: spmm_attention(plan, q, k, v, negative_slope=0.2),
                         lambda: spmm_attention_reference(plan, q, k, v, negative_slope=0.2),
                         plan_bytes + n * 4 * (2 * dk + 2 * dv) + lse.numel() * 4,
                         edges * 2 * (dk + dv)),
            # K10 and its fixed-order sum: reads the plan, q, k, v, out, dO and
            # lse once; writes dq, dk and dv once
            "attn_bwd": (lambda: attention_bwd_summed(plan, q, k, v, out, lse, g, **kw),
                         plain_bwd,
                         plan_bytes + n * 4 * (3 * dk + 3 * dv) + lse.numel() * 4
                         + n * 4 * (dk + dv), edges * (6 * dk + 4 * dv) + 2 * n * dv),
            # reads the plan, q, k, v, dO, lse and D once; writes dq once
            "attn_dq": (lambda: attention_dq(plan, *bwd, **kw),
                        lambda: attention_dq_reference(plan, *bwd, **kw),
                        plan_bytes + n * 4 * (3 * dk + 2 * dv + 1) + lse.numel() * 4,
                        edges * (4 * dk + 2 * dv)),
            # reads the plan, q, k, v, dO, lse and D once; writes dk and dv once
            "attn_dkv": (lambda: attention_dkv(plan, *bwd, **kw),
                         lambda: attention_dkv_reference(plan, *bwd, **kw),
                         plan_bytes + n * 4 * (3 * dk + 3 * dv + 1) + lse.numel() * 4,
                         edges * 4 * (dk + dv)),
        }
        for name, (kernel, plain, nbytes, flops) in fns.items():
            k_ms, p_ms, turns = in_turns(torch, kernel, plain)
            b_ms, b_by = bound_ms(nbytes, flops)
            per_width[name][tag] = (k_ms, p_ms, None, b_ms, b_by)
            print(f"  {name} {tag}: kernel {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, no library call, bound {b_ms:.4f} ms "
                  f"({b_by})")
        # K9 beside K13 at one head, in turns
        new_ms, k13_ms, turns = in_turns(
            torch, fns["attn_fwd"][0],
            lambda: spmm_attention_mh(plan, q[None], k[None], v[None], negative_slope=0.2),
            plain_iters=20)
        print(f"  attn_fwd {tag}: K9 {turns[1]:.4f} / {turns[2]:.4f} ms against K13 at one head "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms")
        lanes_ms = cuda_ms(torch, lambda: attention_bwd(plan, q, k, v, out, lse, g, **kw))
        s_ms = cuda_ms(torch, lambda: (scatter_lanes(plan, dk_lane, n),
                                       scatter_lanes(plan, dv_lane, n)))
        s_bound, s_by = bound_ms(lanes * 4 * (dk + dv + 2) + n * 4 * (dk + dv), lanes * (dk + dv))
        per_width["scatter"][tag] = (s_ms, s_bound, k13_ms, lanes_ms)
        print(f"  attn_bwd {tag}: K10 with its fixed-order sum {per_width['attn_bwd'][tag][0]:.4f}"
              f" ms; K10's lane planes {lanes_ms:.4f} ms; scatter_lanes of those planes: "
              f"index_add_ {s_ms:.4f} ms, bound {s_bound:.4f} ms ({s_by}); K11 + K12 "
              f"{per_width['attn_dq'][tag][0] + per_width['attn_dkv'][tag][0]:.4f} ms")

    def flash_head_path(label, a, cfg, widths, heads):
        """Path H: flash GAT on a bare plan of `a`, one head at a time in
        float32: serving (K9) and training (K9 and K10); then the split
        backward (K9, K11 and K12) at both widths."""
        in_dim, hidden, classes = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        plan = csr_preprocess(a.indptr, a.indices, n, cfg).to(dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        lanes = plan.total_blocks * cfg.block_w
        t0 = time.perf_counter()
        held = attention.plan_lane_sources(plan).lane.numel()
        torch.cuda.synchronize()
        t_order = time.perf_counter() - t0
        print(f"path {label}: {n} nodes, {plan.num_edges} edges, {cfg}: {plan.total_blocks} "
              f"blocks, {lanes} lane slots, {held} with bits (K10's slots in the source order "
              f"{held * 4 * 2 * hidden / 1e6:.1f} MB per layer-1 head, "
              f"{held * 4 * 2 * classes / 1e6:.1f} MB at layer 2; the order built in "
              f"{t_order:.2f} s, {(held * 2 + lanes + n + 1) * 4 / 1e6:.1f} MB of int32); "
              f"float32, the per-head path applies no plane rule; csr_preprocess {t_build:.2f} s")
        prng = np.random.default_rng(2)  # G's parameters
        h2 = heads * hidden
        params_np = {k: prng.standard_normal((heads, in_dim, hidden)) * (2.0 / in_dim) ** 0.5
                     for k in ("wq1", "wk1", "wv1")}
        params_np.update({k: prng.standard_normal((h2, classes)) * (2.0 / h2) ** 0.5
                          for k in ("wq2", "wk2", "wv2")})
        model = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        per_request = heads + 1

        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                logits.append(model(plan, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} requests: launches {serve_counts}, plain calls {plain_calls}; "
              f"host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls, {"attn_fwd": per_request * REQUESTS})
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, logits)):
                ref = model(plan, x, impl="reference")
                torch.cuda.synchronize()
                ok = (out.shape == (n, classes) and bool(torch.isfinite(out).all())
                      and torch.allclose(out, ref, **TOL_LOGITS))
                print(f"  request {i}: logits {tuple(out.shape)}, max|kernel - plain| "
                      f"{(out - ref).abs().max().item():.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: logits disagree with the plain forward")
        export_model("H", lambda x: model(plan, x), xs, logits, plan,
                     {"attn_fwd": per_request}, ("attn_fwd_kernel",))

        # the kernels at the path's widths: head 0 of layer 1, and layer 2, on
        # request 0's activations
        per_width = {"attn_fwd": {}, "attn_bwd": {}, "attn_dq": {}, "attn_dkv": {},
                     "scatter": {}}
        p = model.params()
        with torch.no_grad():
            x = xs[0]
            layer1 = [tuple((x @ p[w][hh]).contiguous() for w in ("wq1", "wk1", "wv1"))
                      for hh in range(heads)]
            h = F.elu(torch.cat([spmm_attention(plan, *qkv, negative_slope=0.2)
                                 for qkv in layer1], dim=1))
            layer2 = tuple((h @ p[w]).contiguous() for w in ("wq2", "wk2", "wv2"))
        with torch.no_grad(), deterministic():
            # the plain path's layer-2 q and k, for the scores near the kink
            h_plain = F.elu(torch.cat([spmm_attention_reference(plan, *qkv, negative_slope=0.2)
                                       for qkv in layer1], dim=1))
            rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                           torch.from_numpy(np.diff(a.indptr)).to(dev))
            cols = torch.from_numpy(a.indices.astype(np.int64)).to(dev)
            raw = [(q.double()[rows] * k.double()[cols]).sum(-1)
                   for q, k in (layer2[:2], (h_plain @ p["wq2"], h_plain @ p["wk2"]))]
            near = int((raw[1].abs() < 1e-5).sum())
            flips = int(((raw[0] > 0) != (raw[1] > 0)).sum())
            del h_plain, rows, cols, raw
        print(f"  layer-2 scores q.k in float64 from each path's q and k: {near} within 1e-5 of "
              f"leaky_relu's kink; {flips} edges where the kernel path's and the plain path's "
              "differ in sign (each moves step 0's gradients by about one row's share)")
        time_attn1(label, plan, *layer1[0], feat_of(n, hidden), per_width)
        time_attn1(label, plan, *layer2, feat_of(n, classes), per_width)
        with torch.no_grad():
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: model(plan, x), lambda: model(plan, x, impl="reference"))
        print(f"  request (per-head flash GAT forward): kernel path {req_ms:.4f} ms "
              f"({turns[1]:.4f} / {turns[2]:.4f}), plain path {plain_req_ms:.4f} ms "
              f"({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(plan, x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3, examples/train_gat_dot.py:88) "
              "on labels from the seed")
        y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, n)).to(dev)
        tmodel = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev))
        # atol 1e-4 x max|grad|: G's float32 rule (a hub row's dq sums ~38k
        # terms whose coefficients add up to 0)
        losses, train_counts, final, peak = train(
            f"{label} training", gat_flash_loss,
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), plan, xs[0], y,
            {"attn_fwd": per_request, "attn_bwd": per_request}, atol_scale=1e-4)
        loss_fell(label, losses, final)
        # step 0's gradients on the kernel path, twice from the same parameters
        p0 = GATFlash.from_params(gat_flash_params_from_jax(params_np, dev)).params()

        def kernel_grads():
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
            loss = gat_flash_loss(leaves, plan, xs[0], y)
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        first, again = kernel_grads(), kernel_grads()
        same = all(torch.equal(first[k], again[k]) for k in first)
        print(f"  step 0's kernel-path gradients twice: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"path {label}: two runs of step 0 on the kernel path give different gradients")
        del p0, first, again
        step_ms, plain_step_ms = time_steps(
            make_train_step(torch.optim.Adam(tmodel.parameters(), lr=5e-3), gat_flash_loss),
            tmodel.params(), plan, xs[0], y)

        print(f"path {label}, the split backward: spmm_attention_ad(plan, q, k, v, "
              "plan_t=plan) at a layer-1 head and at layer 2, against the plain split backward "
              "and K10's")

        def grads(qkv, w, plan_t, impl="auto"):
            leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
            out = spmm_attention_ad(plan, *leaves, plan_t=plan_t, negative_slope=0.2, impl=impl)
            (out * w).sum().backward()
            return dict(zip(("q", "k", "v"), (t.grad for t in leaves)))

        ws = [feat_of(n, layer[2].shape[1]) for layer in (layer1[0], layer2)]
        reset_counts()
        split = [grads(layer, w, plan) for layer, w in zip((layer1[0], layer2), ws)]
        torch.cuda.synchronize()
        split_counts, plain_calls = read_counts()
        print(f"  split backward at d {hidden} and d {classes}: launches {split_counts}, plain "
              f"calls {plain_calls}")
        check_counts(f"{label} split backward", split_counts, plain_calls,
                     {"attn_fwd": 2, "attn_dq": 2, "attn_dkv": 2})
        for layer, w, got in zip((layer1[0], layer2), ws, split):
            d = layer[0].shape[1]
            for what, want in (("the plain split backward", grads(layer, w, plan, "reference")),
                               ("K10 and scatter_lanes", grads(layer, w, None))):
                ok, diff, rel = grads_close(torch, calc_diff, got, want, 1e-4)
                print(f"  d {d}: split gradients against {what}: worst calc_diff {diff:.3e}, "
                      f"worst max|diff|/max|grad| {rel:.3e} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label}: the split backward at d {d} disagrees with {what}")
        del plan
        torch.cuda.empty_cache()

        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        counts = {
            "attn_fwd": {"launches": serve_counts["attn_fwd"],
                         "train_launches": train_counts["attn_fwd"],
                         "split_launches": split_counts["attn_fwd"], **common},
            "attn_bwd": {"launches": train_counts["attn_bwd"], "serve_launches": 0, **common},
            "attn_dq": {"launches": split_counts["attn_dq"], "serve_launches": 0,
                        "train_launches": 0},
            "attn_dkv": {"launches": split_counts["attn_dkv"], "serve_launches": 0,
                         "train_launches": 0},
        }
        results = {}
        for name, c in counts.items():
            per = per_width[name]
            widest = max(per.values(), key=lambda t: t[3])
            results[name] = {**c, "ms": sum(t[0] for t in per.values()),
                             "plain_ms": sum(t[1] for t in per.values()), "library_ms": None,
                             "bound_ms": sum(t[3] for t in per.values()), "bound_by": widest[4],
                             "note": ("K14's or K15's kernel at H = 1"
                                      if name in ("attn_dq", "attn_dkv") else "its own kernel")}
            for tag, (k_ms, p_ms, _, b_ms, _) in per.items():
                results[name].update({f"ms_{tag}": k_ms, f"plain_ms_{tag}": p_ms,
                                      f"bound_ms_{tag}": b_ms})
        for tag, (s_ms, s_bound, k13_ms, lanes_ms) in per_width["scatter"].items():
            results["attn_bwd"].update({f"scatter_ms_{tag}": s_ms,
                                        f"scatter_bound_ms_{tag}": s_bound,
                                        f"lane_planes_ms_{tag}": lanes_ms})
            results["attn_fwd"][f"k13_one_head_ms_{tag}"] = k13_ms
        return results

    def linkpred_path(label, a, cfg, widths):
        """Path F: GCN link prediction on `a`: K1 for the encoder, K7 for
        the SDDMM scores of the candidate edges, K6 in their backward."""
        in_dim, hidden, emb = widths
        n = a.shape[0]
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, cfg, symmetric=True, device=dev)
        torch.cuda.synchronize()
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan, plan_t, labels = build_link_candidates(a.indptr, a.indices, n,
                                                     np.random.default_rng(5), neg_ratio=1.0,
                                                     config=cfg, device=dev)
        torch.cuda.synchronize()
        t_cand = time.perf_counter() - t0
        st = ell_stats(plan)
        bpw = torch.diff(plan.block_ptr)
        print(f"path {label}: {n} nodes, {a.nnz} nnz, GCN plan {cfg}: "
              f"{plan_stats(g.plan)['total_blocks']} blocks; {st['nnz']} candidate edges "
              f"({int(labels.sum().item())} of A), ELL {cfg}: {st['num_windows']} windows, "
              f"{st['total_blocks']} blocks (largest window {int(bpw.max())}), fill "
              f"{st['lane_fill']:.4f}; build_graph {t_graph:.2f} s, build_link_candidates "
              f"{t_cand:.2f} s, host peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")

        prng = np.random.default_rng(3)
        params_np = {
            "w1": prng.standard_normal((in_dim, hidden)) * (2.0 / in_dim) ** 0.5,
            "b1": prng.standard_normal(hidden) * 0.1,
            "w2": prng.standard_normal((hidden, emb)) * (2.0 / hidden) ** 0.5,
            "b2": prng.standard_normal(emb) * 0.1,
        }
        model = GCN.from_params(gcn_params_from_jax(params_np, dev)).eval()
        xs = [feat_of(n, in_dim) for _ in range(REQUESTS)]
        torch.cuda.synchronize()

        def request(x, impl="auto"):
            return link_scores(plan, plan_t, model(g, x, impl=impl), impl=impl)

        reset_counts()
        scores, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                scores.append(request(x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        serve_counts, plain_calls = read_counts()
        print(f"  served {REQUESTS} scoring requests: launches {serve_counts}, plain calls "
              f"{plain_calls}; host ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, serve_counts, plain_calls,
                     {"spmm_block": 2 * REQUESTS, "spmm_ell_dvals": REQUESTS})
        with torch.no_grad():
            for i, (x, out) in enumerate(zip(xs, scores)):
                ref = request(x, "reference")
                torch.cuda.synchronize()
                scale = ref.abs().max().item()
                diff = calc_diff(out, ref)
                ok = (out.shape == ref.shape == (plan.num_edges,)
                      and bool(torch.isfinite(out).all()) and diff < 1e-6
                      and torch.allclose(out, ref, rtol=1e-4, atol=1e-4 * scale))
                extra = ""
                if i == 0:  # AUC sorts 5M scores on the host: request 0 only
                    auc_k, auc_p = link_auc(out, labels), link_auc(ref, labels)
                    ok = ok and abs(auc_k - auc_p) <= 1e-5
                    extra = f", AUC {auc_k:.7f} / plain {auc_p:.7f}"
                print(f"  request {i}: {out.numel()} scores, calc_diff {diff:.3e}, max|kernel - "
                      f"plain| {(out - ref).abs().max().item():.3e} (max|score| {scale:.3e})"
                      f"{extra} -> {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"path {label} request {i}: scores disagree with the plain path")

        # the kernels at the path's width: K7 on the scores, K6 on random cotangents
        with torch.no_grad():
            h = model(g, xs[0]).contiguous()
        cot_np = rng.standard_normal(plan.num_edges).astype(np.float32)
        gplan = dataclasses.replace(plan, vals=lane_values(plan, torch.from_numpy(cot_np).to(dev)))
        H, K = cfg.block_h, cfg.block_w
        lane_edge = plan.lane_edge.cpu().numpy()
        lanes = np.nonzero(lane_edge >= 0)[0]
        rows = (plan.window_of_block.cpu().numpy()[lanes // K].astype(np.int64) * H
                + plan.erow.cpu().numpy().reshape(-1)[lanes])
        cols = plan.hind.cpu().numpy().reshape(-1)[lanes]
        cand = sp.csr_matrix((cot_np[lane_edge[lanes]], (rows, cols)), shape=(n, n))
        cand.sort_indices()
        csr_w = csr_tensor(torch, cand, dev, torch.from_numpy(cand.data))
        csr_1 = csr_tensor(torch, cand, dev)
        deg = torch.from_numpy(np.diff(cand.indptr).astype(np.float32)).to(dev)[:, None]
        per_width = {"spmm_ell": {}, "spmm_ell_dvals": {}}
        time_ell(label, gplan, h, h, csr_w, csr_1, plan.num_edges, per_width, deg)
        del gplan, csr_w, csr_1, cand
        # K1 at the encoder's width, under the float32 summation bound of A's rows
        x, deg_a, csr_a = xs[0], torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(
            dev)[:, None], csr_tensor(torch, a, dev)
        compare("spmm_block", f"path {label} K1 d{in_dim} (float32 summation bound)", g.plan,
                (x,), deg_a)
        piece_line(f"path {label}", [g.plan], "spmm_block", (in_dim,))
        k_ms, p_ms, turns = in_turns(torch, lambda: spmm_block(g.plan, x),
                                     lambda: spmm_reference(g.plan, x))
        lib = library_ms(lambda: torch.sparse.mm(csr_a, x))
        b_ms, b_by = bound_ms(tensor_bytes(g.plan.bitmask, g.plan.hind, g.plan.block_ptr)
                              + 2 * n * in_dim * 4, 2 * a.nnz * in_dim)
        print(f"  K1 d={in_dim}: spmm_block {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        k1_times = {f"f_ms_d{in_dim}": k_ms, f"f_plain_ms_d{in_dim}": p_ms,
                    f"f_library_ms_d{in_dim}": lib, f"f_bound_ms_d{in_dim}": b_ms}
        del csr_a
        with torch.no_grad():
            x = xs[0]
            req_ms, plain_req_ms, turns = in_turns(torch, lambda: request(x),
                                                   lambda: request(x, "reference"))
        print(f"  request (GCN forward and scores): kernel path {req_ms:.4f} ms ({turns[1]:.4f} / "
              f"{turns[2]:.4f}), plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: request(x)), "request")

        print(f"path {label}, training: {STEPS} Adam steps (lr 5e-3) on the candidates' labels")
        tmodel = GCN.from_params(gcn_params_from_jax(params_np, dev))

        def loss_fn(params, g_, x_, y_, impl="auto"):
            return link_pred_loss(params, g_, plan, plan_t, x_, y_, impl=impl)

        def stepper(optimizer):
            step = make_link_pred_step(optimizer)
            return lambda params, g_, x_, y_, impl="auto": step(params, g_, plan, plan_t, x_, y_,
                                                                impl=impl)

        # atol 1e-3 x max|grad|: the GCN's ReLU, as on path A
        losses, train_counts, final, peak = train(
            f"{label} training", loss_fn,
            stepper(torch.optim.Adam(tmodel.parameters(), lr=5e-3)), tmodel.params(), g, xs[0],
            labels, {"spmm_block": 3, "spmm_ell_dvals": 1, "spmm_ell": 2}, atol_scale=1e-3)
        loss_fell(label, losses, final)
        step_ms, plain_step_ms = time_steps(
            stepper(torch.optim.Adam(tmodel.parameters(), lr=5e-3)), tmodel.params(), g, xs[0],
            labels)
        common = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
                  "train_step_ms": step_ms, "plain_train_step_ms": plain_step_ms,
                  "train_peak_gib": peak}
        del g, plan, plan_t
        torch.cuda.empty_cache()
        result = {name: {"launches": serve_counts[name], "train_launches": train_counts[name],
                         **common, "per_width": per_width.get(name, {})}
                  for name in ("spmm_ell", "spmm_ell_dvals", "spmm_block")}
        result["spmm_block"].update(k1_times)
        return result

    def sum_bound_ok(got, want, deg, abs_sum):
        """(ok, max|got - want|): |got - want| <= 1e-4 + 1e-5 |want| plus the
        float32 summation bound (deg - 1) 2**-24 sum|a x| once for each side,
        as compare() allows."""
        allow = 1e-4 + 1e-5 * want.abs() + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * abs_sum
        diff = (got - want).abs()
        return bool((diff <= allow).all()) and bool(torch.isfinite(got).all()), diff.max().item()

    path_i, path_j, path_n = {}, {}, {}

    def int8_path(label, a, g):
        """Path I: REQUESTS calls of spmm(plan, x, impl="int8") at d 128 and at
        d 256 on A's plan (K8 once each); K8 against its plain version under
        the summation bound, against a float64 host product of the same
        bf16-dequantized features (first and last 2,048 rows) and against
        K1's float32 output (relative error < 2e-2, tests/test_quant.py:41);
        K8 timed in turns with its plain version and with K1."""
        plan, n = g.plan, a.shape[0]
        widths = (128, 256)
        xs = {d: [feat_of(n, d) for _ in range(REQUESTS)] for d in widths}
        torch.cuda.synchronize()
        reset_counts()
        outs, wall_ms = {d: [] for d in widths}, []
        for d in widths:
            for x in xs[d]:
                t0 = time.perf_counter()
                outs[d].append(spmm(plan, x, impl="int8"))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"path {label}: {REQUESTS} requests of spmm(plan, x, impl='int8') at each of d "
              f"{widths}: launches {counts}, plain calls {plain_calls}; host ms per request "
              f"{[round(t, 3) for t in wall_ms]}")
        check_counts(label, counts, plain_calls, {"spmm_int8": len(widths) * REQUESTS})
        path_i["launches"] = counts["spmm_int8"]
        export_model("I", lambda x: spmm(plan, x, impl="int8"), xs[128], outs[128], plan,
                     {"spmm_int8": 1}, ("spmm_walk_kernel",))
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev)
        piece_line(f"path {label}", [plan], "spmm_int8", widths)
        twice(f"path {label} spmm_int8 d128", spmm_int8, plan, xs[128][0])
        rows = np.r_[0:2048, n - 2048:n]
        a_rows = a[rows].astype(np.float64)
        deg_rows = np.diff(a.indptr)[rows][:, None].astype(np.float64)
        per_width = {}
        for d in widths:
            for i, out in enumerate(outs[d]):
                if out.shape != (n, d) or not bool(torch.isfinite(out).all()):
                    fail(f"path {label} d{d} request {i}: output {tuple(out.shape)} is not a "
                         f"finite ({n}, {d})")
            x, out = xs[d][0], outs[d][0]
            compare("spmm_int8", f"path {label} d{d} (float32 summation bound)", plan, (x,), deg)
            q, sc = quant.quantize_padded(x)
            xq = dequantize_rows(q, sc, torch.bfloat16).float()[:, :d].contiguous()
            xq64 = xq.double().cpu().numpy()
            host = a_rows @ xq64
            got = out.cpu().double().numpy()[rows]
            allow = (1e-4 + 1e-5 * np.abs(host)
                     + np.clip(deg_rows - 1, 0, None) * 2.0**-24 * (abs(a_rows) @ np.abs(xq64)))
            host_err = float(np.abs(got - host).max())
            host_ok = bool((np.abs(got - host) <= allow).all())
            rel = relative_error(spmm_block(plan, x), out)
            ok = host_ok and rel < 2e-2
            print(f"  d{d} request 0: against a float64 host product of the bf16-dequantized "
                  f"features ({len(rows)} rows) max|diff| {host_err:.3e}; against K1's float32 "
                  f"output relative error {rel:.3e} (limit 2e-2) -> {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"path {label} d{d}: K8 disagrees with the host product or with K1")
            k_ms, p_ms, turns = in_turns(torch, lambda: quant.launch_quantized(plan, q, sc, d),
                                         lambda: spmm_int8_reference(plan, x))
            w_ms, k1_ms, turns1 = in_turns(torch, lambda: spmm_int8(plan, x),
                                           lambda: spmm_block(plan, x), plain_iters=20)
            q_ms = cuda_ms(torch, lambda: quant.quantize_padded(x))
            lib = library_ms(lambda: torch.sparse.mm(csr, xq))
            # reads the bitmask, hind, the int8 rows and the scales once; writes out
            b_ms, b_by = bound_ms(tensor_bytes(plan.bitmask, plan.hind, q, sc) + n * d * 4,
                                  2 * a.nnz * d)
            per_width[d] = (k_ms, p_ms, lib, b_ms, b_by)
            path_i.update({f"wrapper_ms_d{d}": w_ms, f"k1_ms_d{d}": k1_ms,
                           f"quantize_ms_d{d}": q_ms})
            print(f"  K8 d={d}: kernel alone {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms; spmm_int8 (quantize_rows and K8) "
                  f"{turns1[1]:.4f} / {turns1[2]:.4f} ms against K1 {turns1[0]:.4f} / "
                  f"{turns1[3]:.4f} ms on the same plan; quantize_rows alone {q_ms:.4f} ms; "
                  f"torch.sparse.mm on the dequantized float32 features (dequantization "
                  f"outside the timed call) {lib:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        path_i.update(widths_summary(per_width))
        del csr

    def int8_on_c(label, a, g):
        """K8 at d 256 on path C's coverage plan: against its plain version
        under the summation bound and K3's float32 output (relative error <
        2e-2), timed in turns with its plain version and with K3."""
        plan, n, d = g.plan, a.shape[0], 256
        x = feat_of(n, d)
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        compare("spmm_int8", f"path {label} K8 d{d} (float32 summation bound)", plan, (x,), deg)
        piece_line(f"path {label}", [plan], "spmm_int8", (d,))
        twice(f"path {label} spmm_int8 d{d}", spmm_int8, plan, x)
        rel = relative_error(spmm_fused(plan, x), spmm_int8(plan, x))
        print(f"  K8 d{d} against K3's float32 output: relative error {rel:.3e} (limit 2e-2) -> "
              f"{'ok' if rel < 2e-2 else 'MISMATCH'}")
        if not rel < 2e-2:
            fail(f"path {label}: K8 disagrees with K3")
        q, sc = quant.quantize_padded(x)
        xq = dequantize_rows(q, sc, torch.bfloat16).float()[:, :d].contiguous()
        k_ms, p_ms, turns = in_turns(torch, lambda: quant.launch_quantized(plan, q, sc, d),
                                     lambda: spmm_int8_reference(plan, x), plain_iters=2)
        w_ms, k3_ms, turns1 = in_turns(torch, lambda: spmm_int8(plan, x),
                                       lambda: spmm_fused(plan, x), plain_iters=20)
        csr = csr_tensor(torch, a, dev)
        lib = library_ms(lambda: torch.sparse.mm(csr, xq))
        b_ms, b_by = bound_ms(tensor_bytes(plan.bitmask, plan.hind, q, sc) + n * d * 4,
                              2 * a.nnz * d)
        path_i.update({f"c_ms_d{d}": k_ms, f"c_plain_ms_d{d}": p_ms, f"c_wrapper_ms_d{d}": w_ms,
                       f"c_k3_ms_d{d}": k3_ms, f"c_library_ms_d{d}": lib,
                       f"c_bound_ms_d{d}": b_ms, "c_bound_by": b_by})
        print(f"  K8 d={d} on C's plan: kernel alone {turns[1]:.4f} / {turns[2]:.4f} ms, plain "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms; spmm_int8 {turns1[1]:.4f} / {turns1[2]:.4f} "
              f"ms against K3 {turns1[0]:.4f} / {turns1[3]:.4f} ms; torch.sparse.mm on the "
              f"dequantized features {lib:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        del csr

    def streamed_path(label, a, g, model, params_np, xs, logits):
        """Path J.1: A's GCN on A's graph built with stream_chunks=4: REQUESTS
        requests (K1 2 x 4 each) whose logits must equal path A's bit for bit
        (K1 sums each window in the same order on a chunk as on the whole
        plan), step-0 loss and gradients equal to the unstreamed graph's,
        then STEPS SGD steps (K1 3 x 4 each)."""
        n, chunks = a.shape[0], 4
        classes = model.w2.shape[1]
        t0 = time.perf_counter()
        gs = build_graph(a.indptr, a.indices, n, g.plan.config, symmetric=True,
                         stream_chunks=chunks, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if not (isinstance(gs.plan, list) and len(gs.plan) == chunks and gs.plan_t is gs.plan
                and all(s.bitmask.is_cuda for s in gs.plan) and gs.num_nodes == n):
            fail(f"path {label}: build_graph(stream_chunks={chunks}) did not give {chunks} chunks "
                 "on the card")
        print(f"path {label}: build_graph(..., {g.plan.config}, stream_chunks={chunks}) "
              f"{t_build:.2f} s: chunk rows {[s.num_nodes for s in gs.plan]}, blocks "
              f"{[s.total_blocks for s in gs.plan]}")
        piece_line(f"path {label}", gs.plan, "spmm_block", (128, 256))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        outs, wall_ms = [], []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                outs.append(model(gs, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        serve_peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  served {REQUESTS} requests: launches {counts}, plain calls {plain_calls}; host "
              f"ms per request {[round(t, 3) for t in wall_ms]}; torch.cuda.max_memory_allocated "
              f"{serve_peak:.3f} GiB (A's graph and this one both held)")
        check_counts(label, counts, plain_calls, {"spmm_block": 2 * chunks * REQUESTS})
        same = [torch.equal(o, w) for o, w in zip(outs, logits)]
        print(f"  logits against path A's unstreamed requests: bit-identical {same}")
        if not all(same):
            fail(f"path {label}: streamed logits differ from path A's")
        y = torch.from_numpy(np.random.default_rng(3).integers(0, classes, n)).to(dev)

        def step0(graph):
            leaves = {k: v.requires_grad_(True)
                      for k, v in gcn_params_from_jax(params_np, dev).items()}
            loss = gcn_loss(leaves, graph, xs[0], y)
            return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        (loss_s, grads_s), (loss_w, grads_w) = step0(gs), step0(g)
        equal = torch.equal(loss_s, loss_w) and all(torch.equal(grads_s[k], grads_w[k])
                                                    for k in grads_w)
        print(f"  step-0 loss and gradients against the unstreamed graph: "
              f"{'bit-identical' if equal else 'DIFFERENT'} (max|diff| "
              f"{max((grads_s[k] - grads_w[k]).abs().max().item() for k in grads_w):.3e})")
        if not equal:
            fail(f"path {label}: streamed step-0 gradients differ from the unstreamed graph's")
        tmodel = GCN.from_params(gcn_params_from_jax(params_np, dev))
        _, train_counts, _, peak = train(
            f"{label} training", gcn_loss,
            make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss),
            tmodel.params(), gs, xs[0], y, {"spmm_block": 3 * chunks}, atol_scale=1e-3)
        with torch.no_grad():
            x = xs[0]
            s_ms, w_ms, turns = in_turns(torch, lambda: model(gs, x), lambda: model(g, x),
                                         plain_iters=20)
        print(f"  request: streamed {turns[1]:.4f} / {turns[2]:.4f} ms, unstreamed (path A's "
              f"graph) {turns[0]:.4f} / {turns[3]:.4f} ms")
        step = make_train_step(torch.optim.SGD(tmodel.parameters(), lr=0.1), gcn_loss)
        st_ms, sw_ms, turns = in_turns(torch, lambda: step(tmodel.params(), gs, xs[0], y),
                                       lambda: step(tmodel.params(), g, xs[0], y),
                                       plain_iters=20)
        print(f"  training step: streamed {turns[1]:.4f} / {turns[2]:.4f} ms, unstreamed "
              f"{turns[0]:.4f} / {turns[3]:.4f} ms")
        with torch.no_grad():
            print_profile(*profile_requests(torch, lambda: model(gs, x)), "request", top=8)
        path_j.update(j_stream_launches=counts["spmm_block"],
                      j_stream_train_launches=train_counts["spmm_block"],
                      j_stream_request_ms=s_ms, j_unstreamed_request_ms=w_ms,
                      j_stream_train_step_ms=st_ms, j_unstreamed_train_step_ms=sw_ms,
                      j_stream_serve_peak_gib=serve_peak, j_stream_train_peak_gib=peak)
        del gs

    def hybrid_path(label, a, g):
        """Path J.2: the JAX package's default hybrid plan of A's CSR (dense
        side PlanConfig(128, 128, 8) on K3, sparse side PlanConfig(512, 128,
        1, block_unroll=4) on K1): REQUESTS spmm requests at d 128 and at d 256
        (K3 and K1 once each), against K1 on A's plan and against the plain
        path under the summation bound; spmm_ad's gradient against the plain
        path; timed in turns with K1 on A's plan."""
        n = a.shape[0]
        t0 = time.perf_counter()
        hplan = csr_preprocess_hybrid(a.indptr, a.indices, n).to(dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        st = hybrid_stats(hplan)
        print(f"path {label}: csr_preprocess_hybrid {t_build:.2f} s; dense_frac "
              f"{st['dense_frac']:.4f}, dense {hplan.dense.config}: {st['dense']['total_blocks']} "
              f"blocks, {st['dense']['nnz']} nnz; sparse {hplan.sparse.config}: "
              f"{st['sparse']['total_blocks']} blocks, {st['sparse']['nnz']} nnz; gather rows "
              f"{st['total_gather_rows']} (A's plan {g.plan.gather_rows})")
        if not (hplan.dense.total_blocks and hplan.sparse.total_blocks):
            fail(f"path {label}: a side of the hybrid plan has no blocks")
        widths = (128, 256)
        piece_line(f"path {label} sparse side", [hplan.sparse], "spmm_block", widths)
        piece_line(f"path {label} dense side", [hplan.dense], "spmm_fused", widths)
        xs = {d: [feat_of(n, d) for _ in range(REQUESTS)] for d in widths}
        torch.cuda.synchronize()
        reset_counts()
        outs, wall_ms = {d: [] for d in widths}, []
        for d in widths:
            for x in xs[d]:
                t0 = time.perf_counter()
                outs[d].append(spmm(hplan, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"  {REQUESTS} requests of spmm(hybrid plan, x) at each of d {widths}: launches "
              f"{counts}, plain calls {plain_calls}; host ms per request "
              f"{[round(t, 3) for t in wall_ms]}")
        nreq = len(widths) * REQUESTS
        check_counts(label, counts, plain_calls, {"spmm_fused": nreq, "spmm_block": nreq})
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        dense_a = plan_csr(hplan.dense)
        if dense_a.nnz != hplan.dense.num_edges:
            fail(f"path {label}: the dense side's bits give {dense_a.nnz} edges, not "
                 f"{hplan.dense.num_edges}")
        csr_dense = csr_tensor(torch, dense_a, dev)
        deg_dense = torch.from_numpy(np.diff(dense_a.indptr).astype(np.float32)).to(dev)[:, None]
        for d in widths:
            for i, (x, out) in enumerate(zip(xs[d], outs[d])):
                abs_sum = spmm_reference(g.plan, x.abs())
                for what, want in (("K1 on A's plan", spmm_block(g.plan, x)),
                                   ("the plain path", spmm(hplan, x, impl="reference"))):
                    ok, err = sum_bound_ok(out, want, deg, abs_sum)
                    print(f"  d{d} request {i} against {what}: max|diff| {err:.3e} -> "
                          f"{'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        fail(f"path {label} d{d} request {i} disagrees with {what}")
            x = xs[d][0]
            # K3 alone on the dense side: against its plain version under the
            # summation bound of the side's rows, twice for the same bits,
            # timed in turns with its plain version, beside torch.sparse.mm on
            # the side's CSR and its bound
            compare("spmm_fused", f"path {label} dense side K3 d{d} (float32 summation bound)",
                    hplan.dense, (x,), deg_dense)
            twice(f"path {label} dense side spmm_fused d{d}", spmm_fused, hplan.dense, x)
            k3_ms, k3_plain_ms, k3_turns = in_turns(
                torch, lambda: spmm_fused(hplan.dense, x),
                lambda: spmm_fused_reference(hplan.dense, x))
            dense_lib = library_ms(lambda: torch.sparse.mm(csr_dense, x))
            b_ms, b_by = bound_ms(tensor_bytes(hplan.dense.bitmask, hplan.dense.hind,
                                               hplan.dense.block_ptr) + 2 * n * d * 4,
                                  2 * hplan.dense.num_edges * d)
            print(f"  K3 d={d} on the dense side: spmm_fused {k3_turns[1]:.4f} / "
                  f"{k3_turns[2]:.4f} ms, plain {k3_turns[0]:.4f} / {k3_turns[3]:.4f} ms, "
                  f"torch.sparse.mm on the side's CSR {dense_lib:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by})")
            path_j.update({f"j_hybrid_dense_plain_ms_d{d}": k3_plain_ms,
                           f"j_hybrid_dense_library_ms_d{d}": dense_lib,
                           f"j_hybrid_dense_bound_ms_d{d}": b_ms})
            h_ms, k1_ms, turns = in_turns(torch, lambda: spmm(hplan, x),
                                          lambda: spmm_block(g.plan, x), plain_iters=20)
            dense_ms = cuda_ms(torch, lambda: spmm_fused(hplan.dense, x))
            sparse_ms = cuda_ms(torch, lambda: spmm_block(hplan.sparse, x))
            if d == widths[0]:
                print_profile(*profile_requests(torch, lambda: spmm(hplan, x)), "request", top=6)
            path_j.update({f"j_hybrid_ms_d{d}": h_ms, f"j_k1_ms_d{d}": k1_ms,
                           f"j_hybrid_dense_k3_ms_d{d}": dense_ms,
                           f"j_hybrid_sparse_k1_ms_d{d}": sparse_ms})
            print(f"  d{d}: spmm on the hybrid plan (K3 + K1) {turns[1]:.4f} / {turns[2]:.4f} ms, "
                  f"K1 on A's plan {turns[0]:.4f} / {turns[3]:.4f} ms; the sides alone: K3 on the "
                  f"dense side {dense_ms:.4f} ms, K1 on the sparse side {sparse_ms:.4f} ms")
        x, w = xs[128][0], feat_of(n, 128)

        def grad_of(impl):
            leaf = x.clone().requires_grad_(True)
            (spmm_ad(hplan, hplan, leaf, impl=impl) * w).sum().backward()
            return leaf.grad

        ok, err = sum_bound_ok(grad_of("auto"), grad_of("reference"), deg,
                               spmm_reference(g.plan, w.abs()))
        print(f"  spmm_ad(hybrid plan, hybrid plan, x) gradient against the plain path: "
              f"max|diff| {err:.3e} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {label}: the hybrid gradient disagrees with the plain path")
        path_j.update(j_hybrid_launches_k3=counts["spmm_fused"],
                      j_hybrid_launches_k1=counts["spmm_block"], j_hybrid_dense_frac=st["dense_frac"])
        del hplan, csr_dense

    # --- path Q: bf16 feature sources (K1, K2, K3 and K6) ------------------
    # each bf16 instantiation's launches on the drives of path Q (a user's
    # call, the counts zeroed just before) and its times at each width; path
    # Q's features and values come from a generator of their own
    path_q = {k: {"launches": 0, "per_width": {}} for k in bf16_of}
    qrng = np.random.default_rng(19)

    def q_feat(n, d):
        return torch.from_numpy(qrng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def library_half(csr, xb, x):
        """(ms, what): torch.sparse.mm on operands of xb's 16-bit dtype where
        torch's CSR takes them, else on the float32 ones."""
        what = {torch.bfloat16: "bf16", torch.float16: "float16"}[xb.dtype]
        csr16 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                        csr.values().to(xb.dtype), size=csr.shape)
        try:
            torch.sparse.mm(csr16, xb)
            torch.cuda.synchronize()
        except RuntimeError as e:
            return library_ms(lambda: torch.sparse.mm(csr, x)), (
                f"float32 operands (torch's CSR refused {what}: {str(e).splitlines()[0][:80]})")
        return library_ms(lambda: torch.sparse.mm(csr16, xb)), f"{what} operands"

    def q_kernel(key, tag, label, plan, d, deg, fields, csr, nnz, plain_iters=3):
        """Q.1 for one bf16 instantiation at width d on a path's plan: bit for
        bit the float32 kernel on the widened rows, twice the same bits,
        against its plain version (which widens the rows) under the float32
        summation bound; timed in turns with the float32 kernel on the
        float32 rows, beside its plain version and torch.sparse.mm, with its
        bound (the plan's `fields`, X in bf16, out in float32, each once)."""
        kernel, plain = kernels[bf16_of[key]][:2]
        x = q_feat(plan.source_rows, d)
        xb = x.to(torch.bfloat16)
        half_check(key, f"Q.1 on {label} d{d}", plan, xb, deg)
        k_ms, f_ms, turns = in_turns(torch, lambda: kernel(plan, xb, torch.float32),
                                     lambda: kernel(plan, x, torch.float32), plain_iters=20)
        p_ms = cuda_ms(torch, lambda: plain(plan, xb, torch.float32), iters=plain_iters,
                       warmup=1)
        lib, lib_what = library_half(csr, xb, x)
        b_ms, b_by = bound_ms(tensor_bytes(*fields) + plan.source_rows * d * 2
                              + plan.num_nodes * d * 4, 2 * nnz * d)
        path_q[key]["per_width"][f"{tag}_d{d}"] = dict(
            ms=k_ms, f32_ms=f_ms, plain_ms=p_ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        print(f"  Q.1 {key} d={d}: bf16 {turns[1]:.4f} / {turns[2]:.4f} ms, the float32 kernel "
              f"on float32 rows {turns[0]:.4f} / {turns[3]:.4f} ms ({k_ms / f_ms:.3f}x), plain "
              f"{p_ms:.4f} ms, torch.sparse.mm {lib:.4f} ms ({lib_what}), bound {b_ms:.4f} ms "
              f"({b_by}; X in bf16)")

    def half_drive(path, store, label, fn, want):
        """A path Q or S drive: fn() with the counts zeroed just before and
        read just after; the 16-bit instantiations launched as `want`, no
        plain call; their launches added to `store`."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        print(f"  {label}: launches {({k: c for k, c in counts.items() if c})}, plain calls "
              f"{plain_calls} ({secs * 1e3:.3f} ms)")
        check_counts(f"{path} {label}", counts, plain_calls, want)
        for k, c in counts.items():
            if k in store:
                store[k]["launches"] += c
        return out

    def q_drive(label, fn, want):
        return half_drive("Q", path_q, label, fn, want)

    def q_path_a(label, a, g, params_np):
        """Path Q on A's graph: Q.1 K1 on A's plan at d 128 and 256, the
        hybrid (K3 + K1) and K3 alone on its dense side; Q.2 A's GCN with
        agg_dtype=torch.bfloat16, REQUESTS requests and STEPS SGD steps; Q.3
        tune_spmm(accurate=False) at d 128; Q.4 build_graph("auto")."""
        t_path = time.perf_counter()
        n = a.shape[0]
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev)
        print(f"path {label}")
        fields = (g.plan.bitmask, g.plan.hind, g.plan.block_ptr)
        for d in (128, 256):
            q_kernel("spmm_block_bf16", "A", "A's plan", g.plan, d, deg, fields, csr, a.nnz)
        # Q.1 on J.2's hybrid plan: both sides read bf16 rows and are summed
        # once in float32
        hplan = csr_preprocess_hybrid(a.indptr, a.indices, n).to(dev)
        xs = {d: [q_feat(n, d).to(torch.bfloat16) for _ in range(REQUESTS)] for d in (128, 256)}
        outs = q_drive(f"{REQUESTS} spmm(hybrid plan, x.bfloat16()) at d 128 and 256",
                       lambda: [spmm(hplan, x, out_dtype=torch.float32)
                                for d in xs for x in xs[d]],
                       {"spmm_fused": 2 * REQUESTS, "spmm_block": 2 * REQUESTS,
                        "spmm_fused_bf16": 2 * REQUESTS, "spmm_block_bf16": 2 * REQUESTS})
        for x, out in zip([x for d in xs for x in xs[d]], outs):
            xw = x.float()
            same = torch.equal(out, spmm(hplan, xw))
            ok, err = sum_bound_ok(out, spmm(hplan, xw, impl="reference"), deg,
                                   spmm_reference(g.plan, xw.abs()))
            if not (ok and same):
                fail(f"path {label}: the bf16 hybrid is not the float32 hybrid on the widened "
                     f"rows ({same}) or is off the plain path ({err:.3e})")
        print(f"  the {len(outs)} hybrid outputs: bit for bit the float32 hybrid on the widened "
              f"rows, and within the summation bound of the plain path")
        dense_a = plan_csr(hplan.dense)
        deg_dense = torch.from_numpy(np.diff(dense_a.indptr).astype(np.float32)).to(dev)[:, None]
        csr_dense = csr_tensor(torch, dense_a, dev)
        for d in (128, 256):
            q_kernel("spmm_fused_bf16", "J2", "J.2's dense side", hplan.dense, d, deg_dense,
                     (hplan.dense.bitmask, hplan.dense.hind, hplan.dense.block_ptr), csr_dense,
                     hplan.dense.num_edges)
        del hplan, csr_dense, outs, xs

        # Q.2: A's GCN on a bf16 aggregation
        gq = dataclasses.replace(g, agg_dtype=torch.bfloat16)
        model = GCN.from_params(gcn_params_from_jax(params_np, dev)).eval()
        xs = [q_feat(n, 128) for _ in range(REQUESTS)]
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            logits = q_drive(f"Q.2 {REQUESTS} GCN requests, agg_dtype=torch.bfloat16",
                             lambda: [model(gq, x) for x in xs],
                             {"spmm_block": 2 * REQUESTS, "spmm_block_bf16": 2 * REQUESTS})
            req_peak = torch.cuda.max_memory_allocated() / 2**30
            f32_logits = [model(g, x) for x in xs]
        host = host_forward(a, xs[0].cpu().double().numpy(), params_np)
        diff_host = calc_diff(logits[0].cpu().double().numpy(), host)
        diffs = [calc_diff(q, f) for q, f in zip(logits, f32_logits)]
        finite = all(q.shape == (n, 40) and bool(torch.isfinite(q).all()) for q in logits)
        print(f"  Q.2 logits: request 0 against the float64 host forward calc_diff "
              f"{diff_host:.3e} (float32 path: {calc_diff(f32_logits[0].cpu().double().numpy(), host):.3e}); "
              f"against the float32 path {[f'{v:.3e}' for v in diffs]} (limit 1e-2, bf16's class)")
        if not (finite and diff_host < 1e-2 and max(diffs) < 1e-2):
            fail(f"path {label} Q.2: the bf16 GCN's logits are off the float64 forward or the "
                 "float32 path")
        y = torch.from_numpy(np.random.default_rng(3).integers(0, 40, n)).to(dev)

        def step_of(graph):
            tm = GCN.from_params(gcn_params_from_jax(params_np, dev))
            return make_train_step(torch.optim.SGD(tm.parameters(), lr=0.1), gcn_loss), tm

        step32, m32 = step_of(g)
        step32(m32.params(), g, xs[0], y)
        want = {k: v.grad.detach().clone() for k, v in m32.params().items()}
        step16, m16 = step_of(gq)
        grads0, losses, step_ms = {}, [], []
        torch.cuda.reset_peak_memory_stats()

        def steps():
            for i in range(STEPS):
                t0 = time.perf_counter()
                losses.append(step16(m16.params(), gq, xs[0], y))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    grads0.update({k: v.grad.detach().clone() for k, v in m16.params().items()})

        # the two forwards read bf16 rows; the backward runs the float32
        # instantiation on the cotangent (ops/library.py)
        q_drive(f"Q.2 {STEPS} SGD steps, agg_dtype=torch.bfloat16", steps,
                {"spmm_block": 3 * STEPS, "spmm_block_bf16": 2 * STEPS})
        step_peak = torch.cuda.max_memory_allocated() / 2**30
        gdiff = {k: calc_diff(grads0[k], want[k]) for k in want}
        print(f"  Q.2 losses {[round(l.item(), 6) for l in losses]}; step 0's gradients against "
              f"the float32 path calc_diff {({k: f'{v:.3e}' for k, v in gdiff.items()})} (limit "
              f"1e-2); host ms per step {[round(t, 3) for t in step_ms]}")
        if not (all(bool(torch.isfinite(l)) for l in losses) and max(gdiff.values()) < 1e-2):
            fail(f"path {label} Q.2: the bf16 step's gradients are off the float32 path's")
        with torch.no_grad():
            x = xs[0]
            req16, req32, rt = in_turns(torch, lambda: model(gq, x), lambda: model(g, x),
                                        plain_iters=20)
        st16, st32, stt = in_turns(torch, lambda: step16(m16.params(), gq, x, y),
                                   lambda: step32(m32.params(), g, x, y), plain_iters=20)
        print(f"  Q.2 request: bf16 {rt[1]:.4f} / {rt[2]:.4f} ms, float32 {rt[0]:.4f} / "
              f"{rt[3]:.4f} ms ({req16 / req32:.3f}x); step: bf16 {stt[1]:.4f} / {stt[2]:.4f} ms, "
              f"float32 {stt[0]:.4f} / {stt[3]:.4f} ms ({st16 / st32:.3f}x); peak "
              f"{req_peak:.3f} GiB a request, {step_peak:.3f} GiB a step")
        with torch.no_grad():
            rows, hostops, wall = profile_requests(torch, lambda: model(gq, x))
        print_profile(rows, hostops, wall, "request", top=6)
        path_q["gcn"] = dict(request_ms=req16, f32_request_ms=req32, step_ms=st16,
                             f32_step_ms=st32, request_peak_gib=req_peak,
                             step_peak_gib=step_peak, busy=sum(ms for _, ms in rows) * REQUESTS / wall,
                             calc_diff_host=diff_host, calc_diff_f32=max(diffs),
                             grad_calc_diff=max(gdiff.values()))
        del gq, model, m16, m32, logits, f32_logits

        # Q.3: the tuner's default space with its bf16 variants
        tuner = SpmmTuner(cache_dir=os.path.join(tune_dir, "q"))
        tuned, race_s = race("Q.3 A d 128, accurate=False", tuner, a, x, budget_s=60,
                             hash_tag="ogbn-arxiv-proxy")
        f32_best = min(((ms, k) for k, ms in tuned.candidates.items()
                        if not tuned.variants[k][1].bf16), default=(float("inf"), None))
        bf16_best = min(((ms, k) for k, ms in tuned.candidates.items()
                         if tuned.variants[k][1].bf16), default=(float("inf"), None))
        out = check_winner("Q.3 A d 128", tuned, a, x)
        print(f"  Q.3 winner {tuned.variant.key()} ({'bf16' if tuned.variant.bf16 else 'float32'} "
              f"rows) {tuned.time_ms:.4f} ms; best float32 {f32_best[1]} {f32_best[0]:.4f} ms, "
              f"best bf16 {bf16_best[1]} {bf16_best[0]:.4f} ms; output {out.dtype} (the "
              f"caller's float32)")
        if out.dtype != torch.float32 or bf16_best[1] is None:
            fail(f"path {label} Q.3: no bf16 variant raced, or the output is not the caller's "
                 "dtype")
        path_q["tuner"] = dict(race_s=race_s, winner=tuned.variant.key(),
                               winner_ms=tuned.time_ms, f32_best=f32_best[1],
                               f32_best_ms=f32_best[0], bf16_best=bf16_best[1],
                               bf16_best_ms=bf16_best[0])
        del tuned, out

        # Q.4: build_graph("auto")'s rule on A
        t0 = time.perf_counter()
        ga = build_graph(a.indptr, a.indices, n, "auto", symmetric=True, device=dev)
        secs = time.perf_counter() - t0
        print(f"  Q.4 build_graph('auto') on A: {ga.plan.config} in {secs:.2f} s, agg_dtype "
              f"{ga.agg_dtype} (float32 rows, as Q.1-Q.2 decided; JAX's rule gives "
              f"bfloat16 here)")
        if ga.agg_dtype is not None:
            fail(f"path {label} Q.4: build_graph('auto') streams {ga.agg_dtype} rows where "
                 "the card's numbers keep float32")
        path_q["auto"] = dict(config=str(ga.plan.config), agg_dtype=str(ga.agg_dtype))
        del ga, csr
        torch.cuda.empty_cache()
        path_q["seconds"] = path_q.get("seconds", 0.0) + time.perf_counter() - t_path
        print(f"path Q on A: {time.perf_counter() - t_path:.1f} s in all")

    def q_path_gcn(label, a, g, model, xs, logits, name, widths):
        """Path Q on B's or C's graph: REQUESTS GCN requests under
        agg_dtype=torch.bfloat16 on the path's kernel `name` (its bf16
        instantiation twice a request), the logits against the path's float32
        ones at bf16's class; then Q.1 of that kernel at the path's widths."""
        t_path = time.perf_counter()
        key = f"{name}_bf16"
        gq = dataclasses.replace(g, agg_dtype=torch.bfloat16)
        with torch.no_grad():
            out = q_drive(f"{label}: {REQUESTS} GCN requests, agg_dtype=torch.bfloat16",
                          lambda: [model(gq, x) for x in xs],
                          {name: 2 * REQUESTS, key: 2 * REQUESTS})
        diffs = [calc_diff(q, f) for q, f in zip(out, logits)]
        print(f"  {label}: logits against the float32 path calc_diff "
              f"{[f'{v:.3e}' for v in diffs]} (limit 1e-2)")
        if not (max(diffs) < 1e-2 and all(bool(torch.isfinite(q).all()) for q in out)):
            fail(f"path Q {label}: the bf16 GCN's logits are off the float32 path")
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev)
        fields = [g.plan.bitmask, g.plan.hind, g.plan.block_ptr, g.plan.occ]
        for d in widths:
            q_kernel(key, label[0], f"{label[0]}'s plan", g.plan, d, deg, fields, csr, a.nnz,
                     plain_iters=1 if name == "spmm_fused" else 3)
        del gq, out, csr
        torch.cuda.empty_cache()
        path_q["seconds"] = path_q.get("seconds", 0.0) + time.perf_counter() - t_path

    def q_path_ell(label, a):
        """Path Q on E's graph and ELL geometry (PlanConfig(128, 128,
        block_unroll=4), random edge values): REQUESTS spmm(plan,
        x.bfloat16()) at d 8 and 40 (K6's bf16 instantiation once each), then
        Q.1 of K6 at those widths."""
        t_path = time.perf_counter()
        n = a.shape[0]
        vals = qrng.standard_normal(a.nnz).astype(np.float32)
        eplan = csr_preprocess_ell(a.indptr, a.indices, n, PlanConfig(128, 128, block_unroll=4),
                                   values=vals).to(dev)
        xs = {d: [q_feat(n, d).to(torch.bfloat16) for _ in range(REQUESTS)] for d in (8, 40)}
        outs = q_drive(f"{label}: {REQUESTS} spmm(ELL plan, x.bfloat16()) at d 8 and 40",
                       lambda: [spmm(eplan, x) for d in xs for x in xs[d]],
                       {"spmm_ell": 2 * REQUESTS, "spmm_ell_bf16": 2 * REQUESTS})
        if not all(o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all()) for o in outs):
            fail(f"path Q {label}: the bf16 ELL SpMM is not a finite bf16 output")
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev, torch.from_numpy(vals))
        fields = (eplan.hind, eplan.erow, eplan.vals, eplan.window_of_block)
        for d in (8, 40):
            q_kernel("spmm_ell_bf16", label[0], f"{label[0]}'s ELL plan", eplan, d, deg,
                     fields, csr, a.nnz)
        del eplan, csr, outs, xs
        torch.cuda.empty_cache()
        path_q["seconds"] = path_q.get("seconds", 0.0) + time.perf_counter() - t_path

    # --- path S: float16 feature sources (K1, K2, K3 and K6) ---------------
    # each float16 instantiation's launches on the drives of path S (a user's
    # call, the counts zeroed just before) and its times at each width,
    # beside its float32 and bf16 kernels; path S's features and values come
    # from a generator of their own
    path_s = {k: {"launches": 0, "per_width": {}} for k in f16_of}
    srng = np.random.default_rng(20)
    # the float16 class of a calc_diff: Q.2's bf16 limit (1e-2) scaled from
    # bf16's 8 significant bits to float16's 11: a relative error 2**-3 as
    # large, so calc_diff (a squared relative distance) 2**-6 as large
    s_limit = 1e-2 * 2.0**-6

    def s_feat(n, d):
        return torch.from_numpy(srng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def s_drive(label, fn, want):
        return half_drive("S", path_s, label, fn, want)

    def s_compute(key, label, plan, x):
        """compute_dtype=torch.float16 on float32 rows `x` through spmm (the
        kernel's float16 instantiation; K6 rounds its edge values in the
        kernel): the float32 kernel's bits on the rounded operands, float32."""
        name = f16_of[key]
        kernel = kernels[name][0]
        ref_plan = plan
        if name == "spmm_ell":
            ref_plan = dataclasses.replace(plan, vals=plan.vals.half().float())
        got = spmm(plan, x, compute_dtype=torch.float16, subtile=name == "spmm_subtile")
        want = kernel(ref_plan, x.half().float(), torch.float32)
        ok = got.dtype == torch.float32 and torch.equal(got, want)
        print(f"  {key} {label}: compute_dtype=torch.float16 on float32 rows "
              f"{'==' if ok else '!='} the float32 kernel on the rounded operands")
        if not ok:
            fail(f"{key} {label}: compute_dtype=float16 is not the float32 kernel on the "
                 "rounded operands")

    def s_kernel(key, tag, label, plan, d, deg, fields, csr, nnz, plain_iters=3):
        """S.3 for one float16 instantiation at width d on a path's plan: bit
        for bit the float32 kernel on the widened rows, twice the same bits,
        against its plain version under the float32 summation bound; once
        under compute_dtype=float16; timed in turns with the float32 kernel
        on the float32 rows and the bf16 kernel on bf16 rows, beside its
        plain version and torch.sparse.mm, with its bound (the plan's
        `fields`, X in float16, out in float32, each once)."""
        kernel, plain = kernels[f16_of[key]][:2]
        x = s_feat(plan.source_rows, d)
        xh, xb = x.half(), x.bfloat16()
        half_check(key, f"S.3 on {label} d{d}", plan, xh, deg)
        s_compute(key, f"S.3 on {label} d{d}", plan, x)
        (f_ms, b_ms, h_ms), turns = in_turns_n(
            torch, [lambda: kernel(plan, x, torch.float32), lambda: kernel(plan, xb, torch.float32),
                    lambda: kernel(plan, xh, torch.float32)])
        p_ms = cuda_ms(torch, lambda: plain(plan, xh, torch.float32), iters=plain_iters,
                       warmup=1)
        lib, lib_what = library_half(csr, xh, x)
        bd_ms, bd_by = bound_ms(tensor_bytes(*fields) + plan.source_rows * d * 2
                                + plan.num_nodes * d * 4, 2 * nnz * d)
        path_s[key]["per_width"][f"{tag}_d{d}"] = dict(
            ms=h_ms, f32_ms=f_ms, bf16_ms=b_ms, plain_ms=p_ms, library_ms=lib, bound_ms=bd_ms,
            bound_by=bd_by)
        print(f"  S.3 {key} d={d}: float16 {turns[2]:.4f} / {turns[3]:.4f} ms, bf16 "
              f"{turns[1]:.4f} / {turns[4]:.4f}, float32 {turns[0]:.4f} / {turns[5]:.4f} "
              f"(float16 / float32 {h_ms / f_ms:.3f}x, float16 / bf16 {h_ms / b_ms:.3f}x), plain "
              f"{p_ms:.4f} ms, torch.sparse.mm {lib:.4f} ms ({lib_what}), bound {bd_ms:.4f} ms "
              f"({bd_by}; X in float16)")

    def s_path_a(label, a, g, params_np):
        """Path S on A's graph: S.3 K1 on A's plan at d 128 and 256; S.2 one
        spmm on J.2's hybrid plan (K3 + K1) at d 128 and one at d 256 on
        float16 rows, and S.3 K3 on its dense side; S.1 A's GCN with
        agg_dtype=torch.float16, REQUESTS requests and STEPS SGD steps; S.4
        the exported float16 aggregate, loaded in this process."""
        from voltrix_spmm_tpu_torch.models.graph import aggregate
        from voltrix_spmm_tpu_torch.serve import export_servable, load_servable

        t_path = time.perf_counter()
        n = a.shape[0]
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev)
        print(f"path {label}")
        fields = (g.plan.bitmask, g.plan.hind, g.plan.block_ptr)
        for d in (128, 256):
            s_kernel("spmm_block_f16", "A", "A's plan", g.plan, d, deg, fields, csr, a.nnz)
        hplan = csr_preprocess_hybrid(a.indptr, a.indices, n).to(dev)
        xs = [s_feat(n, d).half() for d in (128, 256)]
        outs = s_drive("S.2 spmm(hybrid plan, x.half()) at d 128 and 256",
                       lambda: [spmm(hplan, x, out_dtype=torch.float32) for x in xs],
                       {"spmm_fused": 2, "spmm_block": 2, "spmm_fused_f16": 2,
                        "spmm_block_f16": 2})
        for x, out in zip(xs, outs):
            xw = x.float()
            same = torch.equal(out, spmm(hplan, xw))
            ok, err = sum_bound_ok(out, spmm(hplan, xw, impl="reference"), deg,
                                   spmm_reference(g.plan, xw.abs()))
            if not (ok and same):
                fail(f"path {label}: the float16 hybrid is not the float32 hybrid on the "
                     f"widened rows ({same}) or is off the plain path ({err:.3e})")
        print(f"  the {len(outs)} hybrid outputs: bit for bit the float32 hybrid on the widened "
              f"rows, and within the summation bound of the plain path")
        dense_a = plan_csr(hplan.dense)
        deg_dense = torch.from_numpy(np.diff(dense_a.indptr).astype(np.float32)).to(dev)[:, None]
        csr_dense = csr_tensor(torch, dense_a, dev)
        for d in (128, 256):
            s_kernel("spmm_fused_f16", "J2", "J.2's dense side", hplan.dense, d, deg_dense,
                     (hplan.dense.bitmask, hplan.dense.hind, hplan.dense.block_ptr), csr_dense,
                     hplan.dense.num_edges)
        del hplan, csr_dense, outs, xs

        # S.1: A's GCN on a float16 aggregation, beside the float32 and bf16 ones
        gs = dataclasses.replace(g, agg_dtype=torch.float16)
        gb = dataclasses.replace(g, agg_dtype=torch.bfloat16)
        model = GCN.from_params(gcn_params_from_jax(params_np, dev)).eval()
        xs = [s_feat(n, 128) for _ in range(REQUESTS)]
        y = torch.from_numpy(np.random.default_rng(3).integers(0, 40, n)).to(dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            logits = s_drive(f"S.1 {REQUESTS} GCN requests, agg_dtype=torch.float16",
                             lambda: [model(gs, x) for x in xs],
                             {"spmm_block": 2 * REQUESTS, "spmm_block_f16": 2 * REQUESTS})
            req_peak = torch.cuda.max_memory_allocated() / 2**30
            f32_logits = [model(g, x) for x in xs]
            losses16 = [gcn_loss(model.params(), gs, x, y) for x in xs]
            losses32 = [gcn_loss(model.params(), g, x, y) for x in xs]
        host = host_forward(a, xs[0].cpu().double().numpy(), params_np)
        diff_host = calc_diff(logits[0].cpu().double().numpy(), host)
        diffs = [calc_diff(q, f) for q, f in zip(logits, f32_logits)]
        ldiffs = [calc_diff(q, f) for q, f in zip(losses16, losses32)]
        finite = all(q.shape == (n, 40) and bool(torch.isfinite(q).all()) for q in logits)
        print(f"  S.1 logits: request 0 against the float64 host forward calc_diff "
              f"{diff_host:.3e}; against the float32 path {[f'{v:.3e}' for v in diffs]}, "
              f"losses {[f'{v:.3e}' for v in ldiffs]} (limit {s_limit:.3e}, the float16 class: "
              f"Q.2's bf16 1e-2 times 2**-6)")
        if not (finite and max(diff_host, *diffs, *ldiffs) < s_limit):
            fail(f"path {label} S.1: the float16 GCN's logits or loss are off the float64 "
                 "forward or the float32 path")

        def step_of(graph):
            tm = GCN.from_params(gcn_params_from_jax(params_np, dev))
            return make_train_step(torch.optim.SGD(tm.parameters(), lr=0.1), gcn_loss), tm

        step32, m32 = step_of(g)
        step32(m32.params(), g, xs[0], y)
        want = {k: v.grad.detach().clone() for k, v in m32.params().items()}
        step16, m16 = step_of(gs)
        grads0, losses, step_ms = {}, [], []
        torch.cuda.reset_peak_memory_stats()

        def steps():
            for i in range(STEPS):
                t0 = time.perf_counter()
                losses.append(step16(m16.params(), gs, xs[0], y))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    grads0.update({k: v.grad.detach().clone() for k, v in m16.params().items()})

        # the two forwards read float16 rows; the backward runs the float32
        # instantiation on the cotangent, whose values are float16 ones
        # (ops/library.py)
        s_drive(f"S.1 {STEPS} SGD steps, agg_dtype=torch.float16", steps,
                {"spmm_block": 3 * STEPS, "spmm_block_f16": 2 * STEPS})
        step_peak = torch.cuda.max_memory_allocated() / 2**30

        def grads(graph, scale=1.0, impl="auto"):
            """The gradients of `scale` times the loss at the initial
            parameters, divided by `scale`."""
            p = {k: v.requires_grad_(True) for k, v in gcn_params_from_jax(params_np, dev).items()}
            loss = gcn_loss(p, graph, xs[0], y, impl=impl) * scale
            return {k: v / scale for k, v in zip(p, torch.autograd.grad(loss, list(p.values())))}

        def diffs_of(got, ref):
            return {k: calc_diff(got[k], ref[k]) for k in ref}

        # the float16 cotangent of the mean loss over 169,343 rows (about
        # 1e-7 a value) is a float16 subnormal, so the unscaled gradients
        # leave the float16 class of the float32 path's, as they do in the
        # JAX package: the kernel path is held to the plain path under the
        # same float16 aggregation, and with the loss scaled by 2**16
        # (torch.amp.GradScaler's initial scale) to the float32 path
        gdiff = diffs_of(grads0, want)
        pdiff = diffs_of(grads0, grads(gs, impl="reference"))
        sdiff = diffs_of(grads(gs, scale=2.0**16), want)
        fmt = lambda d: {k: f"{v:.3e}" for k, v in d.items()}  # noqa: E731
        print(f"  S.1 losses {[round(l.item(), 6) for l in losses]}; step 0's gradients "
              f"against the plain path under agg_dtype=torch.float16 calc_diff {fmt(pdiff)}, "
              f"with the loss scaled by 2**16 against the float32 path {fmt(sdiff)} (limit "
              f"{s_limit:.3e}); unscaled against the float32 path {fmt(gdiff)} (float16 "
              f"subnormal cotangents); host ms per step {[round(t, 3) for t in step_ms]}")
        if not (all(bool(torch.isfinite(l)) for l in losses)
                and max(*pdiff.values(), *sdiff.values()) < s_limit):
            fail(f"path {label} S.1: the float16 step's gradients are off the plain path's, or "
                 "off the float32 path's with the loss scaled")
        stepb, mb = step_of(gb)
        x = xs[0]
        with torch.no_grad():
            (r32, rb, r16), rt = in_turns_n(torch, [lambda: model(g, x), lambda: model(gb, x),
                                                    lambda: model(gs, x)])
        (st32, stb, st16), stt = in_turns_n(torch, [lambda: step32(m32.params(), g, x, y),
                                                    lambda: stepb(mb.params(), gb, x, y),
                                                    lambda: step16(m16.params(), gs, x, y)])
        print(f"  S.1 request: float16 {rt[2]:.4f} / {rt[3]:.4f} ms, bf16 {rt[1]:.4f} / "
              f"{rt[4]:.4f}, float32 {rt[0]:.4f} / {rt[5]:.4f} (float16 / float32 "
              f"{r16 / r32:.3f}x); step: float16 {stt[2]:.4f} / {stt[3]:.4f} ms, bf16 "
              f"{stt[1]:.4f} / {stt[4]:.4f}, float32 {stt[0]:.4f} / {stt[5]:.4f} "
              f"({st16 / st32:.3f}x); peak {req_peak:.3f} GiB a request, {step_peak:.3f} GiB a "
              "step")
        with torch.no_grad():
            rows, hostops, wall = profile_requests(torch, lambda: model(gs, x))
        print_profile(rows, hostops, wall, "request", top=6)
        path_s["gcn"] = dict(request_ms=r16, bf16_request_ms=rb, f32_request_ms=r32,
                             step_ms=st16, bf16_step_ms=stb, f32_step_ms=st32,
                             request_peak_gib=req_peak, step_peak_gib=step_peak,
                             busy=sum(ms for _, ms in rows) * REQUESTS / wall,
                             calc_diff_host=diff_host, calc_diff_f32=max(diffs),
                             loss_calc_diff=max(ldiffs), grad_calc_diff_plain=max(pdiff.values()),
                             grad_calc_diff_scaled=max(sdiff.values()),
                             grad_calc_diff_unscaled=max(gdiff.values()))

        # S.4: one exported float16 aggregate of A, loaded in this process
        def fn(v):
            return aggregate(gs, v, mode="mean")

        with torch.no_grad():
            eager = fn(x)
            loaded = load_servable(export_servable(fn, x))
            got = s_drive("S.4 the exported float16 aggregate, loaded in this process",
                          lambda: loaded(x), {"spmm_block": 1, "spmm_block_f16": 1})
        ops = sorted({str(nd.target) for nd in loaded.graph.nodes
                      if nd.op == "call_function" and str(nd.target).startswith("voltrix.")})
        ok = ops == ["voltrix.spmm_block.default"] and torch.equal(got, eager)
        print(f"  S.4: ops {ops}, the eager bits {'yes' if torch.equal(got, eager) else 'NO'} "
              f"-> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {label} S.4: the loaded program's ops or bits are not the eager call's")
        del gs, gb, model, m16, m32, mb, logits, f32_logits, loaded, csr
        torch.cuda.empty_cache()
        path_s["seconds"] = path_s.get("seconds", 0.0) + time.perf_counter() - t_path
        print(f"path S on A: {time.perf_counter() - t_path:.1f} s in all")

    def s_path_gcn(label, a, g, model, xs, logits, name, widths, plain_iters=3):
        """Path S on B's or C's graph: one GCN request under
        agg_dtype=torch.float16 on the path's kernel `name` (its float16
        instantiation twice), the logits against the path's float32 ones in
        the float16 class; then S.3 of that kernel at the path's widths."""
        t_path = time.perf_counter()
        key = f"{name}_f16"
        gs = dataclasses.replace(g, agg_dtype=torch.float16)
        with torch.no_grad():
            out = s_drive(f"{label}: 1 GCN request, agg_dtype=torch.float16",
                          lambda: model(gs, xs[0]), {name: 2, key: 2})
        diff = calc_diff(out, logits[0])
        print(f"  {label}: logits against the float32 path calc_diff {diff:.3e} (limit "
              f"{s_limit:.3e})")
        if not (diff < s_limit and bool(torch.isfinite(out).all())):
            fail(f"path S {label}: the float16 GCN's logits are off the float32 path")
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev)
        fields = [g.plan.bitmask, g.plan.hind, g.plan.block_ptr, g.plan.occ]
        for d in widths:
            s_kernel(key, label[0], f"{label[0]}'s plan", g.plan, d, deg, fields, csr, a.nnz,
                     plain_iters=plain_iters)
        del gs, out, csr
        torch.cuda.empty_cache()
        path_s["seconds"] = path_s.get("seconds", 0.0) + time.perf_counter() - t_path

    def s_path_ell(label, a):
        """Path S on E's graph and ELL geometry (PlanConfig(128, 128,
        block_unroll=4), random edge values): one spmm(plan, x.half()) at d 8
        and one at d 40 (K6's float16 instantiation once each), then S.3 of
        K6 at those widths."""
        t_path = time.perf_counter()
        n = a.shape[0]
        vals = srng.standard_normal(a.nnz).astype(np.float32)
        eplan = csr_preprocess_ell(a.indptr, a.indices, n, PlanConfig(128, 128, block_unroll=4),
                                   values=vals).to(dev)
        xs = [s_feat(n, d).half() for d in (8, 40)]
        outs = s_drive(f"{label}: spmm(ELL plan, x.half()) at d 8 and 40",
                       lambda: [spmm(eplan, x) for x in xs],
                       {"spmm_ell": 2, "spmm_ell_f16": 2})
        if not all(o.dtype == torch.float16 and bool(torch.isfinite(o).all()) for o in outs):
            fail(f"path S {label}: the float16 ELL SpMM is not a finite float16 output")
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        csr = csr_tensor(torch, a, dev, torch.from_numpy(vals))
        fields = (eplan.hind, eplan.erow, eplan.vals, eplan.window_of_block)
        for d in (8, 40):
            s_kernel("spmm_ell_f16", label[0], f"{label[0]}'s ELL plan", eplan, d, deg,
                     fields, csr, a.nnz)
        del eplan, csr, outs, xs
        torch.cuda.empty_cache()
        path_s["seconds"] = path_s.get("seconds", 0.0) + time.perf_counter() - t_path

    # --- paths K, L and M: the other model families -----------------------
    TOL_MODEL = 1e-4  # logits: rtol, and atol x max(1, max|plain|)
    # paths K, L and M draw their features from a generator of their own, so
    # those of the paths after them stay as they were (an edge at leaky_relu's
    # kink on path E moves with them)
    klm_rng = np.random.default_rng(16)

    # --- path R: bf16 on K4, K8, K9 and K13 ----------------------------------
    # each path R key's launches on its drives (a user's call, the counts
    # zeroed just before), its times at each width, and path R's seconds; its
    # inputs come from a generator of their own
    path_r = {k: {"launches": 0, "per_width": {}} for k in r_of}
    path_r_s = []
    rrng = np.random.default_rng(23)
    bf16 = torch.bfloat16

    def r_feat(n, d):
        return torch.from_numpy(rrng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def r_drive(label, fn, want):
        """A path R drive: fn() with the counts zeroed just before and read
        just after; launched as `want`, no plain call."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        print(f"  {label}: launches {({k: c for k, c in counts.items() if c})}, plain calls "
              f"{plain_calls} ({secs * 1e3:.3f} ms)")
        check_counts(f"R {label}", counts, plain_calls, want)
        for k, c in counts.items():
            if k in path_r:
                path_r[k]["launches"] += c
        return out

    def half_path(half):
        """Path R's steps R.1-R.5 on bf16 and their float16 mirrors S.5-S.9,
        by the 16-bit type `half`: (the step's name from R's number, the
        path's store, its drive, the keys' suffix)."""
        if half == bf16:
            return (lambda i: f"R.{i}"), path_r, r_drive, "bf16"
        return (lambda i: f"S.{i + 4}"), path_s, s_drive, "f16"

    def path_seconds(half, secs):
        """A part's seconds, added to path R's (bf16) or path S's (float16)."""
        if half == bf16:
            path_r_s.append(secs)
        else:
            path_s["seconds"] = path_s.get("seconds", 0.0) + secs

    def turns_of(turns, i):
        """fn i's two readings of in_turns_n (the order a, b, c, c, b, a)."""
        return f"{turns[i]:.4f} / {turns[len(turns) - 1 - i]:.4f}"

    def r_export(label, fn, x, op, step="R.5"):
        """R.5 (S.9): one request exported with export_servable and loaded
        with load_servable in this process: its program's ops are `op` alone,
        and it gives the eager bits."""
        from voltrix_spmm_tpu_torch.serve import export_servable, load_servable

        with torch.no_grad():
            eager = fn(x)
            loaded = load_servable(export_servable(fn, x))
            got = loaded(x)
        ops = sorted({str(nd.target) for nd in loaded.graph.nodes
                      if nd.op == "call_function" and str(nd.target).startswith("voltrix.")})
        ok = ops == [f"voltrix.{op}.default"] and torch.equal(got, eager)
        print(f"  {step} {label}: exported and loaded in this process, ops {ops}, the eager bits "
              f"{'yes' if torch.equal(got, eager) else 'NO'} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {step} {label}: the loaded program's ops or bits are not the eager call's")

    def r_k4(tag, label, plan, d, deg, csr_w, nz, half=bf16):
        """R.2 (S.6): K4 on rows of `half` at width d on `plan` (a float32
        plane) with each plane type they pair with (bf16: float32 and bf16;
        float16: float32, bf16 and float16; k4_half_check: the float32 K4's
        bits on the widened inputs, twice the same, the plain version under
        the summation bound); rows and plane of `half` timed in turns with the
        float32 K4 on the float32 rows and plane (and, for float16, the bf16
        K4 on bf16 rows and plane), beside its plain version and
        torch.sparse.mm on 16-bit operands, with its bound (the rows' and the
        plane's bytes halved)."""
        step, store, _, sfx = half_path(half)
        key = f"spmm_weighted_{sfx}"
        n = plan.source_rows
        x = r_feat(n, d)
        xh = x.to(half)
        plan16 = dataclasses.replace(plan, values=plan.values.to(half))
        for pdt in (torch.float32, bf16, F16)[:2 if half == bf16 else 3]:
            k4_half_check(f"{step(2)} on {label} d{d}, {str(pdt).removeprefix('torch.')} plane",
                          dataclasses.replace(plan, values=plan.values.to(pdt)), xh, deg, key)
        fns = [lambda: spmm_weighted(plan, x, torch.float32)]
        if half == F16:
            xb, planb = x.to(bf16), dataclasses.replace(plan, values=plan.values.to(bf16))
            fns.append(lambda: spmm_weighted(planb, xb, torch.float32))
        fns.append(lambda: spmm_weighted(plan16, xh, torch.float32))
        means, turns = in_turns_n(torch, fns)
        k_ms, f_ms = means[-1], means[0]
        rows_ms = cuda_ms(torch, lambda: spmm_weighted(plan, xh, torch.float32))
        p_ms = cuda_ms(torch, lambda: spmm_weighted_reference(plan16, xh, torch.float32),
                       iters=3, warmup=1)
        lib, lib_what = library_half(csr_w, xh, x)
        b_ms, b_by = bound_ms(tensor_bytes(plan16.values, plan.hind, plan.window_of_block)
                              + n * d * 2 + plan.num_nodes * d * 4, 2 * nz * d)
        entry = dict(ms=k_ms, f32_ms=f_ms, plain_ms=p_ms, library_ms=lib, bound_ms=b_ms,
                     bound_by=b_by, **{f"{sfx}_rows_f32_plane_ms": rows_ms})
        if half == F16:
            entry["bf16_ms"] = means[1]
        store[key]["per_width"][f"{tag}_d{d}"] = entry
        twin = f", the bf16 K4 {turns_of(turns, 1)} ms" if half == F16 else ""
        print(f"  {step(2)} {key} on {label} d={d}: {sfx} rows and plane "
              f"{turns_of(turns, len(fns) - 1)} ms, the float32 K4 {turns_of(turns, 0)} ms"
              f"{twin} ({k_ms / f_ms:.3f}x float32); {sfx} rows on the float32 plane "
              f"{rows_ms:.4f} ms; plain {p_ms:.4f} ms; torch.sparse.mm {lib:.4f} ms "
              f"({lib_what}); bound {b_ms:.4f} ms ({b_by}; rows and plane in {sfx})")

    def r_dropedge(label, a, half=bf16):
        """R.1 and R.2 (S.5 and S.6) on K.6's graph: DropEdge's training call
        and its backward (K4 twice: the kept edges' plane, then A^T's plane
        for dx) on rows of `half` at d 128 and 256 (the planes in that type),
        REQUESTS calls counted, against the float32 path on the same draws and
        mask (calc_diff < 1e-2 for bf16, the float16 class for float16),
        timed in turns with it (and, for float16, with bf16 rows), its busy
        share and peak memory; then K4 on the DropEdge plan of one mask."""
        step, store, drive, sfx = half_path(half)
        key = f"spmm_weighted_{sfx}"
        limit = 1e-2 if half == bf16 else s_limit
        n, keep = a.shape[0], 0.8
        g = build_dropedge_graph(a.indptr, a.indices, n, device=dev)
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        print(f"  {step(1)} build_dropedge_graph: {g.plan.config}, keep_prob {keep}")
        res = {}
        for d in (128, 256):
            x = r_feat(n, d).requires_grad_(True)
            g_out = r_feat(n, d)
            xh = x.detach().to(half).requires_grad_(True)
            gh = g_out.to(half)
            gen = torch.Generator(device=dev).manual_seed(60 + d)
            state = gen.get_state()

            def call(xx, gg):
                xx.grad = None
                o = dropedge_aggregate(g, xx, gen, keep)
                o.backward(gg)
                return o.detach(), xx.grad

            outs = drive(f"{step(1)} d{d} {REQUESTS} DropEdge training calls and their backward "
                         f"on {sfx} rows", lambda: [call(xh, gh) for _ in range(REQUESTS)],
                         {"spmm_weighted": 2 * REQUESTS, key: 2 * REQUESTS})
            if not all(o.dtype == half and dx.dtype == half and bool(torch.isfinite(o).all())
                       and bool(torch.isfinite(dx).all()) for o, dx in outs):
                fail(f"path {step(1)} d{d}: the {sfx} training call is not a finite {sfx} output")
            gen.set_state(state)
            torch.cuda.reset_peak_memory_stats()
            oh, dxh = call(xh, gh)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            gen.set_state(state)
            of, dxf = call(x, g_out)
            diffs = (calc_diff(oh.float(), of), calc_diff(dxh.float(), dxf))
            ok = max(diffs) < limit
            print(f"  {step(1)} d{d}: out and dx against the float32 path on the same draws and "
                  f"mask calc_diff {diffs[0]:.3e} / {diffs[1]:.3e} (limit {limit:.3e}); peak "
                  f"{peak:.3f} GiB -> {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"path {step(1)} d{d}: the {sfx} DropEdge call is off the float32 path")
            fns = [lambda: call(x, g_out)]
            if half == F16:
                xb = x.detach().to(bf16).requires_grad_(True)
                gb = g_out.to(bf16)
                fns.append(lambda: call(xb, gb))
            fns.append(lambda: call(xh, gh))
            means, turns = in_turns_n(torch, fns)
            twin = f", bf16 rows {turns_of(turns, 1)} ms" if half == F16 else ""
            print(f"  {step(1)} d{d} training call and backward: {sfx} rows "
                  f"{turns_of(turns, len(fns) - 1)} ms, float32 rows {turns_of(turns, 0)} ms"
                  f"{twin} ({means[-1] / means[0]:.3f}x float32)")
            rows, host, wall = profile_requests(torch, lambda: call(xh, gh))
            print_profile(rows, host, wall, f"{sfx} training call", top=6)
            busy = sum(ms for _, ms in rows) * REQUESTS / wall
            res[f"d{d}"] = {"train_ms": means[-1], "f32_train_ms": means[0], "peak_gib": peak,
                            "busy_share": busy, "calc_diff_out": diffs[0],
                            "calc_diff_dx": diffs[1]}
            if half == F16:
                res[f"d{d}"]["bf16_train_ms"] = means[1]
            del x, xh, g_out, gh, outs, oh, dxh, of, dxf, fns
        # R.2 (S.6): K4 on the DropEdge plan of one keep mask, at d 128 and 256
        w = dropedge_weights(g.num_edges, keep, torch.Generator(device=dev).manual_seed(59),
                             device=dev)
        tb, H, K = g.plan.total_blocks, g.plan.config.block_h, g.plan.config.block_w
        plane = torch.zeros(tb * H * K, device=dev).index_add_(0, g.slots, w).view(tb, H, K)
        wplan = dataclasses.replace(g.plan, values=plane)
        csr_w = csr_tensor(torch, a, dev, w)
        for d in (128, 256):
            r_k4("K6", "K.6's DropEdge plan", wplan, d, deg, csr_w, int(torch.count_nonzero(w)),
                 half)
        store["dropedge"] = res
        del g, wplan, plane, csr_w
        torch.cuda.empty_cache()

    def r_int8(tag, label, a, plan, d, requests, half=bf16, iters=20):
        """R.3 (S.7): `requests` calls of spmm(plan, x.to(half),
        impl="int8") at width d (K8 once each, counted apart); the codes and
        scales of quantize_rows on the card equal the CPU's for the same
        16-bit rows (float16: with a planted zero row, whose scale is 0, and
        a row of largest value 3e-6, whose scale underflows to 0); the 16-bit
        output is K8's float32 output rounded once, which holds against its
        plain version under phase 3's tolerance and the summation bound; K8
        alone timed (float16: in turns with K8 on the codes of the float32
        and the bf16 rows), the call in turns with the float32 call, beside
        its plain version, torch.sparse.mm on the dequantized 16-bit rows,
        and its bound; each timing the mean of `iters` calls."""
        step, store, drive, sfx = half_path(half)
        key = f"spmm_int8_{sfx}"
        n = a.shape[0]
        xs = [r_feat(n, d) for _ in range(requests)]
        if half == F16:
            xs[0][3] = 0.0
            xs[0][7] = xs[0][7].clamp(-1, 1) * 3e-6
        xhs = [x.to(half) for x in xs]
        outs = drive(f"{step(3)} {requests} requests spmm(plan, x.to({sfx}), impl='int8') on "
                     f"{label} d{d}", lambda: [spmm(plan, xh, impl="int8") for xh in xhs],
                     {"spmm_int8": requests, key: requests})
        xh = xhs[0]
        q, sc = quant.quantize_padded(xh)
        q_cpu, sc_cpu = quant.quantize_padded(xh.cpu())
        codes = torch.equal(q.cpu(), q_cpu) and torch.equal(sc.cpu(), sc_cpu)
        planted = ""
        if half == F16:
            codes = codes and sc[3].item() == 0.0 and sc[7].item() == 0.0 and not q[3].any()
            planted = (f" (the zero row's scale {sc[3].item()}, the 3e-6 row's {sc[7].item()}, "
                       f"its codes {sorted(set(q[7, :d].tolist()))})")
        out32 = quant.launch_quantized(plan, q, sc, d)
        want = quant.int8_rows_reference(plan, q, sc, d)
        xq = dequantize_rows(q, sc, bf16).float()[:, :d].contiguous()
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        torch.cuda.synchronize()
        allow = (TOL_KERNEL["atol"] + TOL_KERNEL["rtol"] * want.abs()
                 + 2 * (deg - 1).clamp(min=0) * 2.0**-24 * quant.int8_rows_reference(
                     plan, q.abs(), sc.abs(), d))
        err = (out32 - want).abs().max().item()
        err_of = r_err if key in r_err else half_err
        err_of[key] = max(err_of[key], err)
        ok = (codes and all(o.dtype == half and tuple(o.shape) == (n, d)
                            and bool(torch.isfinite(o).all()) for o in outs)
              and torch.equal(outs[0], out32.to(half))
              and bool(((out32 - want).abs() <= allow).all()))
        print(f"  {step(3)} {label} d{d}: codes and scales on the card "
              f"{'==' if codes else '!='} quantize_rows on the CPU{planted}; {sfx} output = "
              f"K8's float32 output rounded once; max|kernel - plain| {err:.3e} -> "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {step(3)} {label} d{d}: K8 on {sfx} rows disagrees")
        alone = lambda qq, ss, dt: lambda: quant.launch_quantized(  # noqa: E731
            plan, qq, ss, d, rows_dtype=dt)
        extra = {}
        if half == F16:  # K8 alone on the codes of float32, bf16 and float16 rows, in turns
            (f_alone, b_alone, k_ms), kt = in_turns_n(torch, [
                alone(*quant.quantize_padded(xs[0]), torch.float32),
                alone(*quant.quantize_padded(xs[0].to(bf16)), bf16), alone(q, sc, half)],
                iters)
            extra = dict(f32_ms=f_alone, bf16_ms=b_alone)
            k_what = (f"K8 alone {turns_of(kt, 2)} ms, on the codes of float32 rows "
                      f"{turns_of(kt, 0)}, of bf16 rows {turns_of(kt, 1)}")
        else:
            k_ms = cuda_ms(torch, alone(q, sc, half), iters)
            k_what = f"K8 alone {k_ms:.4f} ms"
        (f_ms, w_ms), turns = in_turns_n(torch, [lambda: spmm(plan, xs[0], impl="int8"),
                                                 lambda: spmm(plan, xh, impl="int8")], iters)
        p_ms = cuda_ms(torch, lambda: spmm_int8_reference(plan, xh), iters=2, warmup=1)
        lib, lib_what = library_half(csr_tensor(torch, a, dev), xq.to(half), xq)
        b_ms, b_by = bound_ms(tensor_bytes(plan.bitmask, plan.hind, q, sc) + n * d * 4,
                              2 * a.nnz * d)
        store[key]["per_width"][f"{tag}_d{d}"] = dict(
            ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, **({"f32_ms": f_ms} if half == bf16 else
                              {"f32_wrapper_ms": f_ms, **extra}))
        print(f"  {step(3)} {key} on {label} d={d}: {k_what}; spmm(impl='int8') on {sfx} rows "
              f"{turns_of(turns, 1)} ms, on float32 rows {turns_of(turns, 0)} ms; plain "
              f"{p_ms:.4f} ms; torch.sparse.mm on the dequantized rows {lib:.4f} ms "
              f"({lib_what}); bound {b_ms:.4f} ms ({b_by})")
        return xh

    def r_path_a(label, a, g, half=bf16):
        """Path R (S.5-S.7, S.9) on A's graph: R.1 and R.2 on K.6's DropEdge
        graph, R.3 on A's plan at d 128 and 256, R.5's int8 request."""
        step = half_path(half)[0]
        t_path = time.perf_counter()
        print(f"path {label}")
        r_dropedge(label, a, half)
        for d in (128, 256):
            xh = r_int8("A", "A's plan", a, g.plan, d, REQUESTS, half)
        r_export(f"an int8 request on {half_path(half)[3]} rows (A's plan, d 256)",
                 lambda x: spmm(g.plan, x, impl="int8"), xh, "spmm_int8", step(5))
        torch.cuda.empty_cache()
        path_seconds(half, time.perf_counter() - t_path)
        print(f"path {label[0]} on A: {time.perf_counter() - t_path:.1f} s in all")

    def r_int8_on_c(label, a, g, half=bf16):
        """R.3 (S.7) on C's plan: one call at d 256, timed over 5 calls (a
        call takes ~45 ms there)."""
        t_path = time.perf_counter()
        r_int8("C", "C's plan", a, g.plan, 256, 1, half, iters=5)
        path_seconds(half, time.perf_counter() - t_path)
        print(f"path {half_path(half)[0](3)[0]} on {label}: {time.perf_counter() - t_path:.1f} s "
              "in all")

    def r_time(key, tag, kernel, f32, plain, nbytes, flops):
        """R.6: a compute variant timed in turns with its compute-float32
        kernel, beside its plain version and its bound (the float32 row's
        bytes and operations)."""
        k_ms, f_ms, turns = in_turns(torch, kernel, f32, plain_iters=20)
        p_ms = cuda_ms(torch, plain, iters=2, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops)
        path_r[key]["per_width"][tag] = dict(ms=k_ms, f32_ms=f_ms, plain_ms=p_ms,
                                             library_ms=None, bound_ms=b_ms, bound_by=b_by)
        print(f"  R.6 {key} {tag}: compute bf16 {turns[1]:.4f} / {turns[2]:.4f} ms, compute "
              f"float32 {turns[0]:.4f} / {turns[3]:.4f} ms ({k_ms / f_ms:.3f}x); plain "
              f"{p_ms:.4f} ms; no library call; bound {b_ms:.4f} ms ({b_by})")

    def r_ad(label, fn, leaves, w, want, plain_bwd):
        """R.6: REQUESTS forward-and-backward calls of fn(*leaves, impl) on
        the kernel path (r_drive: launched as `want`, no plain call). Their
        gradients against the plain backward on the kernel forward's out and
        lse (plain_bwd(out, lse) -> dq, dk, dv) by G's step-0 rule (atol
        1e-4 max|grad|), and against impl="reference" (the plain forward
        too) in the bf16 class: calc_diff < 1e-6, rtol and atol 2e-2 (JAX's
        bf16 class, tests/test_attention.py:468-470), since the forwards' lse
        differ in the last bits and p and draw, rounded to bf16, may then
        land on the neighbouring bf16 value."""
        def grads(impl):
            xs = [t.detach().clone().requires_grad_(True) for t in leaves]
            out = fn(*xs, impl)
            (out * w).sum().backward()
            return {name: x.grad for name, x in zip("qkv", xs)}

        got = r_drive(f"R.6 {label}: {REQUESTS} forward-and-backward calls",
                      lambda: [grads("auto") for _ in range(REQUESTS)][-1],
                      {k: REQUESTS for k in want})
        with torch.no_grad():
            plain = dict(zip("qkv", plain_bwd()))
        print(f"  R.6 {label}: the gradients against the plain backward on the kernel "
              "forward's out and lse")
        ok, worst, rel = grads_close(torch, calc_diff, got, plain, 1e-4)
        print(f"  R.6 {label}: against impl=\"reference\" (the plain forward too)")
        ok_ref, worst_ref, rel_ref = grads_close(torch, calc_diff, got, grads("reference"), 2e-2,
                                                 rtol=2e-2)
        print(f"  R.6 {label}: worst calc_diff {worst:.3e} / {worst_ref:.3e}, max|diff| / "
              f"max|grad| {rel:.3e} / {rel_ref:.3e} -> {'ok' if ok and ok_ref else 'MISMATCH'}")
        if not (ok and ok_ref):
            fail(f"path R.6 {label}: the kernel path's gradients disagree with the plain path's")

    def r_backward(plan, n, plan_bytes):
        """R.6: spmm_attention_mh_ad under compute_dtype=bfloat16 on G's plan
        (K13's bf16 kernel, K14's and K15's compute variants) at H 8 x d 8
        and H 1 x d 40, float32 and bf16 planes, and spmm_attention_ad under
        the flag on H's plan at d 8 and 40 with plan_t (K9's bf16 kernel,
        K11's and K12's compute variants) and without (K10's): each drive's
        gradients against the plain path's, each backward op against its
        plain version and twice the same bits, timed in turns with its
        compute-float32 kernel."""
        mh_keys = ("attn_mh_fwd", "attn_mh_fwd_bf16", "attn_mh_dq", "attn_mh_dq_bf16",
                   "attn_mh_dkv", "attn_mh_dkv_bf16")
        for heads, d in ((8, 8), (1, 40)):
            for pdt in (None, bf16):
                q, k, v, w = (r_feat(heads * n, d).view(heads, n, d) for _ in range(4))
                pname = "bf16" if pdt is not None else "float32"
                tag = f"h{heads}_d{d}_{pname}"
                kw = dict(negative_slope=0.2, plane_dtype=pdt)

                def plain_mh():
                    out, lse = spmm_attention_mh(plan, q, k, v, return_stats=True,
                                                 compute_dtype=bf16, **kw)
                    kp, vp = (t if pdt is None else t.to(pdt) for t in (k, v))
                    bwd = (q, kp, vp, w, lse, (w * out).sum(-1))
                    kb = dict(kw, scale=1.0 / d ** 0.5, compute_dtype=bf16)
                    return (attention_mh_dq_reference(plan, *bwd, **kb),
                            *attention_mh_dkv_reference(plan, *bwd, **kb))

                r_ad(f"spmm_attention_mh_ad H {heads} d {d}, {pname} planes, compute_dtype bf16",
                     lambda *x: spmm_attention_mh_ad(plan, *x[:3], plan_t=plan, impl=x[3],
                                                     compute_dtype=bf16, **kw),
                     (q, k, v), w, mh_keys, plain_mh)
                _, bwd = mh_compute_bwd(f"R.6 G's plan {tag}", plan, plan, q, k, v, w, 0.2, pdt)
                # k and v in the plane's type once, as the backward casts them
                bwd = (bwd[0], *(t if pdt is None else t.to(pdt) for t in bwd[1:3]), *bwd[3:])
                kw["scale"] = 1.0 / d ** 0.5
                kb = dict(kw, compute_dtype=bf16)
                plane = 2 if pdt is not None else 4
                hn, edges, lse_b = heads * n, plan.num_edges * heads, bwd[4].numel() * 4
                # the float32 rows' bytes and operations (time_attn)
                r_time("attn_mh_dq_bf16", tag, lambda: attention_mh_dq(plan, *bwd, **kb),
                       lambda: attention_mh_dq(plan, *bwd, **kw),
                       lambda: attention_mh_dq_reference(plan, *bwd, **kb),
                       plan_bytes + hn * (4 * d + plane * 2 * d + 4 * d + 4 + 4 * d) + lse_b,
                       edges * 6 * d)
                r_time("attn_mh_dkv_bf16", tag, lambda: attention_mh_dkv(plan, *bwd, **kb),
                       lambda: attention_mh_dkv(plan, *bwd, **kw),
                       lambda: attention_mh_dkv_reference(plan, *bwd, **kb),
                       plan_bytes + hn * (plane * 4 * d + 4 + 8 * d) + lse_b, edges * 8 * d)
        for d in (8, 40):
            q, k, v, w = (r_feat(n, d) for _ in range(4))
            kb = dict(negative_slope=0.2, scale=1.0 / d ** 0.5, compute_dtype=bf16)

            def plain_one(split):
                out, lse = spmm_attention(plan, q, k, v, return_stats=True, negative_slope=0.2,
                                          compute_dtype=bf16)
                if split:
                    bwd = (q, k, v, w, lse, (w * out).sum(-1))
                    return (attention_dq_reference(plan, *bwd, **kb),
                            *attention_dkv_reference(plan, *bwd, **kb))
                dq, dkl, dvl = attention_bwd_reference(plan, q, k, v, out, lse, w, **kb)
                return dq, scatter_lanes(plan, dkl, n), scatter_lanes(plan, dvl, n)

            for plan_t, keys in ((plan, ("attn_dq", "attn_dkv")), (None, ("attn_bwd",))):
                what = "with plan_t (K11, K12)" if plan_t is not None else "without plan_t (K10)"
                r_ad(f"spmm_attention_ad d {d} {what}, compute_dtype bf16",
                     lambda *x: spmm_attention_ad(plan, *x[:3], plan_t=plan_t, impl=x[3],
                                                  negative_slope=0.2, compute_dtype=bf16),
                     (q, k, v), w,
                     ("attn_fwd", "attn_fwd_bf16", *keys, *(f"{key}_bf16" for key in keys)),
                     lambda: plain_one(plan_t is not None))
            attn1_compute_bwd(f"R.6 H's plan d{d}", plan, plan, q, k, v, w, 0.2)
            kw = dict(negative_slope=0.2, scale=1.0 / d ** 0.5)
            with torch.no_grad():
                out, lse = spmm_attention(plan, q, k, v, return_stats=True, **kb)
            bwd = (q, k, v, w, lse, (w * out).sum(-1))
            lse_b = lse.numel() * 4

            def plain_k10():
                dq, dkl, dvl = attention_bwd_reference(plan, q, k, v, out, lse, w, **kb)
                return dq, scatter_lanes(plan, dkl, n), scatter_lanes(plan, dvl, n)

            # the float32 rows' bytes and operations (time_attn1)
            r_time("attn_bwd_bf16", f"d{d}",
                   lambda: attention_bwd_summed(plan, q, k, v, out, lse, w, **kb),
                   lambda: attention_bwd_summed(plan, q, k, v, out, lse, w, **kw), plain_k10,
                   plan_bytes + n * 4 * 6 * d + lse_b + n * 4 * 2 * d,
                   plan.num_edges * 10 * d + 2 * n * d)
            r_time("attn_dq_bf16", f"d{d}", lambda: attention_dq(plan, *bwd, **kb),
                   lambda: attention_dq(plan, *bwd, **kw),
                   lambda: attention_dq_reference(plan, *bwd, **kb),
                   plan_bytes + n * 4 * (5 * d + 1) + lse_b, plan.num_edges * 6 * d)
            r_time("attn_dkv_bf16", f"d{d}", lambda: attention_dkv(plan, *bwd, **kb),
                   lambda: attention_dkv(plan, *bwd, **kw),
                   lambda: attention_dkv_reference(plan, *bwd, **kb),
                   plan_bytes + n * 4 * (6 * d + 1) + lse_b, plan.num_edges * 8 * d)

    def r_attn_fwd(plan, n, plan_bytes, half=bf16):
        """R.4 (S.8): K13 under compute_dtype `half` at G's geometry (H 8 x
        d 8 and H 1 x d 40, float32 and bf16 planes) and K9 on H's plan at d
        8 and 40, each against its plain version (float16: at calc_diff
        1e-8), twice the same bits, timed in turns with compute_dtype float32
        (and, for float16, bfloat16); R.5's (S.9's) K13 request under the
        flag. S.8 also holds K13 on a bf16 plane whose k reaches 70,144, inf
        in float16: the NaN rows the plain version has, and its values
        elsewhere."""
        step, store, drive, sfx = half_path(half)
        limit = 1e-6 if half == bf16 else 1e-8
        mh_key, one_key = f"attn_mh_fwd_{sfx}", f"attn_fwd_{sfx}"

        def timed(key, tag, fns, plain, b_args):
            """The compute variants in turns (float32, [bf16,] `half`), the
            plain version, the bound; stored under `key`, `tag`."""
            means, turns = in_turns_n(torch, fns)
            p_ms = cuda_ms(torch, plain, iters=2, warmup=1)
            b_ms, b_by = bound_ms(*b_args)
            entry = dict(ms=means[-1], f32_ms=means[0], plain_ms=p_ms, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by)
            twin = ""
            if half == F16:
                entry["bf16_ms"] = means[1]
                twin = f", compute bf16 {turns_of(turns, 1)} ms"
            store[key]["per_width"][tag] = entry
            print(f"  {step(4)} {key} {tag}: compute {sfx} {turns_of(turns, len(fns) - 1)} ms, "
                  f"compute float32 {turns_of(turns, 0)} ms{twin} ({means[-1] / means[0]:.3f}x "
                  f"float32); plain {p_ms:.4f} ms; no library call; bound {b_ms:.4f} ms "
                  f"({b_by})")

        def variants(fn, kw):
            """fn under compute_dtype float32, [bf16,] `half`."""
            dts = (bf16,) if half == bf16 else (bf16, half)
            return [lambda: fn(**kw)] + [lambda dt=dt: fn(**kw, compute_dtype=dt) for dt in dts]

        with torch.no_grad():
            for heads, d in ((8, 8), (1, 40)):
                q, k, v = (r_feat(heads * n, d).view(heads, n, d) for _ in range(3))
                for pdt in (None, bf16):
                    kw = dict(negative_slope=0.2, plane_dtype=pdt, return_stats=True)
                    kb = dict(kw, compute_dtype=half)
                    pname = "bf16" if pdt is not None else "float32"
                    tag = f"h{heads}_d{d}_{pname}"
                    drive(f"{step(4)} K13 H {heads} d {d}, {pname} planes, compute_dtype {sfx}",
                          lambda: spmm_attention_mh(plan, q, k, v, **kb),
                          {"attn_mh_fwd": 1, mh_key: 1})
                    compute_close(mh_key, f"{step(4)} G's plan H {heads} d {d} {pname} planes",
                                  n, lambda: spmm_attention_mh(plan, q, k, v, **kb),
                                  lambda: spmm_attention_mh_reference(plan, q, k, v, **kb), limit)
                    plane = 2 if pdt is not None else 4
                    timed(mh_key, tag,
                          variants(lambda **a: spmm_attention_mh(plan, q, k, v, **a), kw),
                          lambda: spmm_attention_mh_reference(plan, q, k, v, **kb),
                          (plan_bytes + heads * n * (4 * d + plane * 2 * d + 4 * d)
                           + heads * plan.padded_nodes * 4, plan.num_edges * heads * 4 * d))
                if heads == 8:
                    r_export(f"a K13 request under compute_dtype {sfx} (G's plan, H 8 x d 8, bf16 "
                             "planes)", lambda x: spmm_attention_mh(
                                 plan, x, k, v, negative_slope=0.2, plane_dtype=bf16,
                                 compute_dtype=half), q, "spmm_attention_mh", step(5))
                if heads == 8 and half == F16:  # k past float16's range on a bf16 plane
                    k2 = k.clone()
                    k2[0, 5, 0] = 7e4
                    kb = dict(negative_slope=0.2, plane_dtype=bf16, return_stats=True,
                              compute_dtype=half)
                    o1, s1 = spmm_attention_mh(plan, q, k2, v, **kb)
                    o2, s2 = spmm_attention_mh(plan, q, k2, v, **kb)
                    op, sp_ = spmm_attention_mh_reference(plan, q, k2, v, **kb)
                    nan_rows = op.isnan().any(-1)
                    twice = all(torch.equal(a.nan_to_num(), b.nan_to_num())
                                for a, b in ((o1, o2), (s1, s2)))
                    same = torch.equal(o1.isnan(), op.isnan())
                    diff = calc_diff(o1[~nan_rows], op[~nan_rows])
                    ok = (same and twice and bool(nan_rows.any()) and diff < limit
                          and bool((s1[:, :n][nan_rows] == 1e30).all()))
                    print(f"  {step(4)} K13 compute_dtype {sfx}, a bf16 plane with k 70,144 (inf "
                          f"in float16): {int(nan_rows.sum())} NaN rows, "
                          f"{'the' if same else 'NOT the'} plain version's, lse 1e30 there; "
                          f"calc_diff elsewhere {diff:.3e}; twice "
                          f"{'bit-identical' if twice else 'DIFFERENT'} -> "
                          f"{'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        fail(f"{step(4)}: K13 under compute_dtype {sfx} disagrees with its plain "
                             "version past float16's range")
            for d in (8, 40):
                q, k, v = (r_feat(n, d) for _ in range(3))
                kw = dict(negative_slope=0.2, return_stats=True)
                kb = dict(kw, compute_dtype=half)
                drive(f"{step(4)} K9 d {d}, compute_dtype {sfx}",
                      lambda: spmm_attention(plan, q, k, v, **kb), {"attn_fwd": 1, one_key: 1})
                compute_close(one_key, f"{step(4)} H's plan d {d}", n,
                              lambda: spmm_attention(plan, q, k, v, **kb),
                              lambda: spmm_attention_reference(plan, q, k, v, **kb), limit)
                timed(one_key, f"d{d}", variants(lambda **a: spmm_attention(plan, q, k, v, **a),
                                                 kw),
                      lambda: spmm_attention_reference(plan, q, k, v, **kb),
                      (plan_bytes + n * 4 * 4 * d + plan.padded_nodes * 4,
                       plan.num_edges * 4 * d))

    def r_path_loops(label, a, half=bf16):
        """Path R (S.6, S.8, S.9) on D's, G's and H's graph (self-loops): R.2
        K4 on D's plan geometry at d 8 and 40; R.4 K13 and K9 under the
        16-bit compute_dtype with R.5's K13 request (r_attn_fwd); for bf16,
        R.6 the backward under the flag (r_backward)."""
        t_path = time.perf_counter()
        n = a.shape[0]
        print(f"path {label}")
        deg = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        vals = rrng.standard_normal(a.nnz).astype(np.float32)
        dplan = csr_preprocess(a.indptr, a.indices, n, PlanConfig(64, 128), values=vals).to(dev)
        csr_w = csr_tensor(torch, a, dev, torch.from_numpy(vals))
        for d in (8, 40):
            r_k4("D", "D's plan", dplan, d, deg, csr_w, a.nnz, half)
        del dplan, csr_w
        plan = csr_preprocess(a.indptr, a.indices, n, PlanConfig(128, 128, block_unroll=4)).to(dev)
        plan_bytes = tensor_bytes(plan.bitmask, plan.hind, plan.window_of_block, plan.block_ptr)
        r_attn_fwd(plan, n, plan_bytes, half)
        if half == bf16:
            r_backward(plan, n, plan_bytes)
        del plan
        torch.cuda.empty_cache()
        path_seconds(half, time.perf_counter() - t_path)
        print(f"path {label}: {time.perf_counter() - t_path:.1f} s in all")

    def klm_feat(n, d):
        return torch.from_numpy(klm_rng.standard_normal((n, d)).astype(np.float32)).to(dev)

    def flat_params(model):
        return dict(model.named_parameters())

    def model_path(label, forward, loss_fn, make_step, model, g, x, y, per_request, per_step,
                   requests=REQUESTS):
        """Serve `requests` requests of forward(params, g, x) on the kernel
        path, counted (per_request launches each); the logits against the
        plain path, in torch's deterministic mode (calc_diff < 1e-6, allclose
        rtol 1e-4, atol 1e-4 x max(1, max|plain|): sum aggregations scale the
        logits by degrees of thousands); the request twice on one input,
        bit-identical; request and step timed in turns with the plain path,
        profiled; then, unless make_step is None, STEPS Adam steps (per_step
        launches each) through `train`, step 0's gradients against the plain
        path's at atol 1e-3 x max|grad| (train()'s GCN rule: a ReLU input
        within float32 noise of 0 may switch). forward, loss_fn and the step
        take the flat parameters."""
        params = flat_params(model)
        reset_counts()
        logits, wall_ms = [], []
        with torch.no_grad():
            for _ in range(requests):
                t0 = time.perf_counter()
                logits.append(forward(params, g, x))
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts, plain_calls = read_counts()
        print(f"  served {requests} requests: launches {counts}, plain calls {plain_calls}; host "
              f"ms per request {[round(t, 3) for t in wall_ms]}")
        check_counts(label, counts, plain_calls, {k: requests * v for k, v in per_request.items()})
        with torch.no_grad():
            with deterministic():
                ref = forward(params, g, x, impl="reference")
            out = logits[0]
            scale = max(1.0, ref.abs().max().item())
            diff = calc_diff(out, ref)
            ok = (out.shape == ref.shape and bool(torch.isfinite(out).all()) and diff < 1e-6
                  and torch.allclose(out, ref, rtol=TOL_MODEL, atol=TOL_MODEL * scale))
            print(f"  request 0: logits {tuple(out.shape)}, calc_diff {diff:.3e}, max|kernel - "
                  f"plain| {(out - ref).abs().max().item():.3e}, max|plain| {scale:.3e} -> "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"path {label}: logits disagree with the plain forward")
            same = torch.equal(forward(params, g, x), forward(params, g, x))
            print(f"  request twice on one input: {'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                fail(f"path {label}: two requests on the same input differ")
            req_ms, plain_req_ms, turns = in_turns(
                torch, lambda: forward(params, g, x), lambda: forward(params, g, x,
                                                                      impl="reference"))
            print(f"  request: kernel path {req_ms:.4f} ms ({turns[1]:.4f} / {turns[2]:.4f}), "
                  f"plain path {plain_req_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
            print_profile(*profile_requests(torch, lambda: forward(params, g, x)), "request",
                          top=6)
        res = {"request_ms": req_ms, "plain_request_ms": plain_req_ms,
               "launches_request": per_request}
        if make_step is None:
            return res
        step = make_step(torch.optim.Adam(model.parameters(), lr=5e-3))
        _, _, _, peak = train(f"{label} training", loss_fn, step, params, g, x, y, per_step,
                              atol_scale=1e-3)
        step_ms, plain_step_ms = time_steps(step, params, g, x, y)
        res.update(step_ms=step_ms, plain_step_ms=plain_step_ms, peak_gib=peak,
                   launches_step=per_step)
        return res

    def full_graph_models(label, a):
        """Path K: SAGE, GIN, APPNP, deep GCN (recomputed layers off and on)
        and R-GCN on `a` (PlanConfig(128, 128)), OGB's arxiv widths 128 ->
        256 -> 40; DropEdge's aggregation on build_dropedge_graph(a)."""
        n = a.shape[0]
        in_dim, hidden, classes = 128, 256, 40
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, PlanConfig(128, 128), symmetric=True, device=dev)
        torch.cuda.synchronize()
        print(f"path {label}: {n} nodes, {a.nnz} nnz, PlanConfig(128, 128), {in_dim} -> "
              f"{hidden} -> {classes}; build_graph {time.perf_counter() - t0:.2f} s")
        x = klm_feat(n, in_dim)
        y = torch.from_numpy(np.random.default_rng(22).integers(0, classes, n)).to(dev)
        out = {}

        def gen(seed):
            return torch.Generator().manual_seed(seed)

        def adapt(model, fn, **kw):
            """fn(tree, g, x, ...) as a function of the flat parameters."""
            return lambda p, *args, **kws: fn(model.tree(p), *args, **kw, **kws)

        def stepper(model, make, **kw):
            return lambda opt: adapt(model, make(opt, **kw) if kw else make(opt))

        def ce_of(forward):
            return lambda p, g, x, y, impl="auto": F.cross_entropy(forward(p, g, x, impl=impl), y)

        for key, cls, fwd, what in (
                ("sage", SAGE, sage_forward, "1: SAGE, mean aggregation"),
                ("gin", GIN, gin_forward, "2: GIN, sum aggregation, learnable eps")):
            model = cls(in_dim, hidden, classes, generator=gen(30 + len(out)), device=dev)
            print(f"path {label}.{what}")
            out[key] = model_path(
                f"{label}.{what[0]} {cls.__name__}", adapt(model, fwd), adapt(model, ce_of(fwd)),
                lambda opt, model=model, fwd=fwd: adapt(model, make_train_step(opt, ce_of(fwd))),
                model, g, x, y, {"spmm_block": 2}, {"spmm_block": 3})

        appnp = APPNP(in_dim, hidden, classes, generator=gen(32), device=dev)
        print(f"path {label}.3: APPNP, K 10, alpha 0.1 (Klicpera et al., ICLR 2019)")
        out["appnp"] = model_path(
            f"{label}.3 APPNP", adapt(appnp, appnp_forward), adapt(appnp, appnp_loss),
            lambda opt: adapt(appnp, make_train_step(opt, appnp_loss)), appnp, g, x, y,
            {"spmm_block": 10}, {"spmm_block": 20})

        deep = DeepGCN(in_dim, hidden, classes, 8, generator=gen(33), device=dev)
        p0 = {k: v.detach().clone() for k, v in flat_params(deep).items()}
        for remat in (False, True):
            # 8 aggregations forward; backward 7 (x needs none) and, with
            # remat, the 6 hidden layers' again
            print(f"path {label}.4: deep GCN, 8 layers, residual, mean, remat={remat}")
            with torch.no_grad():
                for k, v in flat_params(deep).items():
                    v.copy_(p0[k])
            out[f"deep_remat_{remat}"] = model_path(
                f"{label}.4 deep GCN remat={remat}", adapt(deep, deep_gcn_forward, remat=remat),
                adapt(deep, deep_gcn_loss, remat=remat),
                stepper(deep, make_deep_train_step, remat=remat), deep, g, x, y,
                {"spmm_block": 8}, {"spmm_block": 21 if remat else 15})
        with torch.no_grad():
            for k, v in flat_params(deep).items():
                v.copy_(p0[k])
        fwd = [deep_gcn_forward(deep.params(), g, x, remat=remat) for remat in (False, True)]
        same = torch.equal(*fwd)
        print(f"  deep GCN forward with remat=False and remat=True (autograd on): "
              f"{'bit-identical' if same else 'DIFFERENT'}; step ms "
              f"{out['deep_remat_False']['step_ms']:.4f} / {out['deep_remat_True']['step_ms']:.4f},"
              f" peak {out['deep_remat_False']['peak_gib']:.3f} / "
              f"{out['deep_remat_True']['peak_gib']:.3f} GiB")
        if not same:
            fail(f"path {label}.4: the recomputed deep GCN's forward differs")
        del fwd, g
        torch.cuda.empty_cache()

        # R-GCN: each directed CSR entry of `a` takes one of 4 relations
        rel = np.random.default_rng(23).integers(0, 4, a.nnz)
        t0 = time.perf_counter()
        rel_graphs = []
        for r in range(4):
            m = a.copy()
            m.data = (rel == r).astype(np.float32)
            m.eliminate_zeros()
            rel_graphs.append(build_graph(m.indptr, m.indices, n, PlanConfig(128, 128),
                                          symmetric=False, device=dev))
        torch.cuda.synchronize()
        print(f"path {label}.5: R-GCN, 4 relations ({[int((rel == r).sum()) for r in range(4)]} "
              f"edges, each directed with its own transpose plan), num_bases 2; build_graph x 4 "
              f"{time.perf_counter() - t0:.2f} s")
        if any(rg.plan_t is rg.plan for rg in rel_graphs):
            fail(f"path {label}.5: a relation graph has no transpose plan of its own")
        rgcn = RGCN(in_dim, hidden, classes, 4, num_bases=2, generator=gen(34), device=dev)
        out["rgcn"] = model_path(
            f"{label}.5 R-GCN", adapt(rgcn, rgcn_forward), adapt(rgcn, rgcn_loss),
            stepper(rgcn, make_rgcn_train_step), rgcn, rel_graphs, x, y,
            {"spmm_block": 8}, {"spmm_block": 12})
        del rel_graphs
        torch.cuda.empty_cache()
        out["dropedge"] = dropedge_path(f"{label}.6 DropEdge", a)
        return out

    def dropedge_path(label, a):
        """DropEdge's training call and its backward (K4 twice: the kept
        edges' plane, then the transpose plane for the features' gradient)
        and its eval call (K1 once), at d 128 and 256, against the plain path
        on the same mask (the CUDA generator's state replayed)."""
        n, keep_prob = a.shape[0], 0.8
        t0 = time.perf_counter()
        g = build_dropedge_graph(a.indptr, a.indices, n, device=dev)
        torch.cuda.synchronize()
        print(f"path {label}: build_dropedge_graph {time.perf_counter() - t0:.2f} s, "
              f"{g.plan.config}: {g.plan.total_blocks} blocks for A and {g.plan_t.total_blocks} "
              f"for A^T, duplicate edges {g.has_duplicate_edges}, keep_prob {keep_prob}")
        res = {}
        for d in (128, 256):
            x = klm_feat(n, d).requires_grad_(True)
            g_out = klm_feat(n, d)
            gen = torch.Generator(device=dev).manual_seed(40 + d)
            state = gen.get_state()

            def train_call(impl="auto"):
                x.grad = None
                o = dropedge_aggregate(g, x, gen, keep_prob, impl=impl)
                o.backward(g_out)
                return o.detach(), x.grad

            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out_k, dx_k = train_call()
            torch.cuda.synchronize()
            counts, plain_calls = read_counts()
            check_counts(label, counts, plain_calls, {"spmm_weighted": 2})
            peak = torch.cuda.max_memory_allocated() / 2**30
            gen.set_state(state)
            with deterministic():
                out_p, dx_p = train_call("reference")
            gen.set_state(state)
            out_k2, dx_k2 = train_call()
            same = torch.equal(out_k, out_k2) and torch.equal(dx_k, dx_k2)
            kept = int(torch.count_nonzero(dropedge_weights_of(gen, state, g, keep_prob)))
            ok = True
            for what, k, p in (("out", out_k, out_p), ("dx", dx_k, dx_p)):
                scale = p.abs().max().item()
                diff = calc_diff(k, p)
                good = diff < 1e-6 and torch.allclose(k, p, rtol=1e-4, atol=1e-4 * scale)
                ok = ok and good
                print(f"  d{d} training call {what}: calc_diff {diff:.3e}, max|kernel - plain| "
                      f"{(k - p).abs().max().item():.3e}, max|plain| {scale:.3e}")
            print(f"  d{d} training call and backward: launches {counts}, {kept} of {g.num_edges} "
                  f"edges kept; twice on one mask {'bit-identical' if same else 'DIFFERENT'}; "
                  f"peak {peak:.3f} GiB -> {'ok' if ok and same else 'MISMATCH'}")
            if not (ok and same):
                fail(f"path {label} d{d}: the training call disagrees with the plain path or "
                     "with itself")
            xe = x.detach()
            reset_counts()
            with torch.no_grad():
                ev = dropedge_aggregate(g, xe, deterministic=True)
                torch.cuda.synchronize()
                counts, plain_calls = read_counts()
                check_counts(label, counts, plain_calls, {"spmm_block": 1})
                with deterministic():
                    ev_p = dropedge_aggregate(g, xe, deterministic=True, impl="reference")
                scale = ev_p.abs().max().item()
                ok = calc_diff(ev, ev_p) < 1e-6 and torch.allclose(ev, ev_p, rtol=1e-4,
                                                                   atol=1e-4 * scale)
                same = torch.equal(ev, dropedge_aggregate(g, xe, deterministic=True))
            print(f"  d{d} eval call (K1 fast path): max|kernel - plain| "
                  f"{(ev - ev_p).abs().max().item():.3e}, twice "
                  f"{'bit-identical' if same else 'DIFFERENT'} -> "
                  f"{'ok' if ok and same else 'MISMATCH'}")
            if not (ok and same):
                fail(f"path {label} d{d}: the eval call disagrees")
            t_ms, tp_ms, turns = in_turns(torch, train_call, lambda: train_call("reference"))
            print(f"  d{d} training call and backward: kernel path {t_ms:.4f} ms ({turns[1]:.4f} "
                  f"/ {turns[2]:.4f}), plain path {tp_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
            with torch.no_grad():
                e_ms, ep_ms, turns = in_turns(
                    torch, lambda: dropedge_aggregate(g, xe, deterministic=True),
                    lambda: dropedge_aggregate(g, xe, deterministic=True, impl="reference"))
            print(f"  d{d} eval call: kernel path {e_ms:.4f} ms ({turns[1]:.4f} / {turns[2]:.4f}), "
                  f"plain path {ep_ms:.4f} ms ({turns[0]:.4f} / {turns[3]:.4f})")
            print_profile(*profile_requests(torch, train_call), "training call", top=6)
            res[d] = {"train_ms": t_ms, "plain_train_ms": tp_ms, "eval_ms": e_ms,
                      "plain_eval_ms": ep_ms, "peak_gib": peak}
            del x, g_out, out_k, dx_k, out_p, dx_p, out_k2, dx_k2, ev, ev_p
        del g
        torch.cuda.empty_cache()
        return res

    def dropedge_weights_of(gen, state, g, keep_prob):
        """The weights the training call drew from `state` (replayed)."""
        now = gen.get_state()
        gen.set_state(state)
        w = dropedge_weights(g.num_edges, keep_prob, gen, device=dev)
        gen.set_state(now)
        return w

    def sampled_sage_path(label, a):
        """Path L: neighbour-sampled GraphSAGE at full width on `a`: STEPS
        Adam steps (lr 1e-2) on batches of 512 seeds, each sampled anew,
        sampling, plan building, the move to the card, the work lists and
        the step timed apart; then sage_inference over a's graph on
        PlanConfig(32, 128)."""
        n = a.shape[0]
        cfg = PlanConfig(32, 128)
        batch, fanouts, dims = 512, [10, 25], (128, 256, 40)
        x_full = klm_feat(n, dims[0])
        y_full = torch.from_numpy(np.random.default_rng(24).integers(0, dims[-1], n)).to(dev)
        srng = np.random.default_rng(25)
        # the entry point against the two timed halves, from one seed
        seeds = srng.choice(n, size=batch, replace=False)

        def sample(seeds, rng):
            """sample_blocks, as its two halves, each timed."""
            t_s = t_p = 0.0
            blocks, dst = [], np.asarray(seeds, np.int64)
            for f in reversed(fanouts):
                t0 = time.perf_counter()
                edges = _sample_edges(a.indptr, a.indices, dst, f, rng)
                t1 = time.perf_counter()
                blk = _block_plans(*edges, f, cfg)
                t_s, t_p = t_s + t1 - t0, t_p + time.perf_counter() - t1
                blocks.append(blk)
                dst = blk.src_ids.astype(np.int64)
            return blocks[::-1], t_s, t_p

        whole = sample_blocks(a.indptr, a.indices, seeds, fanouts, np.random.default_rng(26), cfg)
        halves = sample(seeds, np.random.default_rng(26))[0]
        for hop, (b1, b2) in enumerate(zip(whole, halves)):
            for side in ("plan", "plan_t"):
                p1, p2 = getattr(b1, side), getattr(b2, side)
                if not all(torch.equal(getattr(p1, f), getattr(p2, f))
                           for f in ("bitmask", "hind", "block_ptr", "window_of_block")):
                    fail(f"path {label}: sample_blocks and its halves differ at hop {hop} {side}")
        del whole, halves
        print(f"path {label}: {n} nodes, batches of {batch} seeds, fanouts {fanouts} "
              f"(fanouts[-1] samples the seed hop), {cfg}, SAGE {' -> '.join(map(str, dims))}; "
              "sample_blocks equals its two timed halves")
        model = SageMinibatch(list(dims), generator=torch.Generator().manual_seed(35), device=dev)
        params = flat_params(model)
        step_fn = make_sage_minibatch_step(torch.optim.Adam(model.parameters(), lr=1e-2))

        def step(p, gp, x, y, impl="auto"):
            return step_fn(model.tree(p), gp[0], gp[1], x, y, impl=impl)

        def loss_fn(p, gp, x, y, impl="auto"):
            return F.cross_entropy(sage_blocks_forward(model.tree(p), gp[0], gp[1], x, impl), y)

        rows, launched = [], None
        for i in range(STEPS):
            seeds = srng.choice(n, size=batch, replace=False)
            t_start = time.perf_counter()
            blocks, t_sample, t_plan = sample(seeds, srng)
            t0 = time.perf_counter()
            plans, inv_degs = blocks_args(blocks, dev)
            torch.cuda.synchronize()
            t_move = time.perf_counter() - t0
            # the plans the step launches: each hop's plan, and the seed hop's
            # transpose (blocks[0].plan_t, read only by x_src's gradient,
            # stays on the host)
            launched = [plans[0][0], plans[1][0], plans[1][1]]
            t0 = time.perf_counter()
            for p in launched:
                block_spmm.plan_walk(p, "spmm_block")
            torch.cuda.synchronize()
            t_walk = time.perf_counter() - t0
            x_src = gather_features(x_full, blocks[0].src_ids)
            y = y_full[torch.from_numpy(seeds).to(dev)]
            torch.cuda.synchronize()
            t_host = time.perf_counter() - t_start  # step 0's plain reference not counted
            if i == 0:
                if plans[0][1].bitmask.is_cuda:
                    fail(f"path {label}: the deep hop's transpose plan was moved to the card")
                for hop, blk in enumerate(blocks):
                    print(f"  hop {hop}: {blk.num_dst} -> {blk.num_src} source slots; plan "
                          f"{blk.plan.total_blocks} blocks, transpose {blk.plan_t.total_blocks} "
                          f"({tensor_bytes(blk.plan_t.bitmask, blk.plan_t.hind) / 2**20:.1f} MiB "
                          f"on the host{'' if hop else ', never moved'})")
                for name, p in zip(("hop 0 plan", "hop 1 plan", "hop 1 transpose"), launched):
                    piece_line(f"path {label} {name}", [p], "spmm_block", dims[:2])
                pref = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
                with deterministic():
                    loss_ref = loss_fn(pref, (plans, inv_degs), x_src, y, impl="reference")
                    want = dict(zip(pref, torch.autograd.grad(loss_ref, list(pref.values()))))
                batch0 = (plans, inv_degs, x_src, y)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
            t0 = time.perf_counter()
            loss = step(params, (plans, inv_degs), x_src, y)
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t0
            if i == 0:
                grads0 = {k: v.grad.detach().clone() for k, v in params.items()}
                loss0 = loss
            wall = t_host + t_step
            rows.append((t_sample, t_plan, t_move, t_walk, t_step, wall))
            print(f"  step {i}: loss {loss.item():.6f}; sampling {t_sample * 1e3:.1f} ms, plans "
                  f"{t_plan * 1e3:.1f} ms, move {t_move * 1e3:.1f} ms, work lists "
                  f"{t_walk * 1e3:.1f} ms, step {t_step * 1e3:.3f} ms; {wall * 1e3:.1f} ms in all "
                  f"(host share {(wall - t_step) / wall:.3f})")
        counts, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {STEPS} steps: launches {counts}, plain calls {plain_calls}; "
              f"torch.cuda.max_memory_allocated {peak:.3f} GiB")
        check_counts(label, counts, plain_calls, {"spmm_block": 3 * STEPS})
        ok, diff, rel = grads_close(torch, calc_diff, grads0, want, 1e-3)
        loss_ok = torch.allclose(loss0, loss_ref.detach(), rtol=1e-4, atol=0.0)
        print(f"  step 0 against the plain path: loss {loss0.item():.6f} / {loss_ref.item():.6f}, "
              f"gradients worst calc_diff {diff:.3e}, worst max|diff|/max|grad| {rel:.3e} -> "
              f"{'ok' if ok and loss_ok else 'MISMATCH'}")
        if not (ok and loss_ok):
            fail(f"path {label}: step 0 disagrees with the plain path")
        plans, inv_degs, x_src, y = batch0
        with torch.no_grad():
            tree = model.params()
            out = sage_blocks_forward(tree, plans, inv_degs, x_src, "auto")
            same = torch.equal(out, sage_blocks_forward(tree, plans, inv_degs, x_src, "auto"))
            with deterministic():
                ref = sage_blocks_forward(tree, plans, inv_degs, x_src, "reference")
            ok = bool(torch.isfinite(out).all()) and torch.allclose(out, ref, **TOL_LOGITS)
        print(f"  batch 0 after training: logits {tuple(out.shape)}, max|kernel - plain| "
              f"{(out - ref).abs().max().item():.3e}; twice on one input "
              f"{'bit-identical' if same else 'DIFFERENT'} -> {'ok' if ok and same else 'MISMATCH'}")
        if not (ok and same):
            fail(f"path {label}: the sampled forward disagrees with the plain path or itself")
        step_ms, plain_step_ms = time_steps(step, params, (plans, inv_degs), x_src, y)
        med = [sorted(r[j] for r in rows)[len(rows) // 2] * 1e3 for j in range(6)]
        res = {"sample_ms": med[0], "plan_ms": med[1], "move_ms": med[2], "walk_ms": med[3],
               "step_wall_ms": med[4], "wall_ms": med[5], "step_ms": step_ms,
               "plain_step_ms": plain_step_ms, "peak_gib": peak}
        del plans, inv_degs, x_src, batch0, blocks, launched
        torch.cuda.empty_cache()

        # full-graph inference with the trained weights (the serving request)
        t0 = time.perf_counter()
        g = build_graph(a.indptr, a.indices, n, cfg, symmetric=True, device=dev)
        torch.cuda.synchronize()
        print(f"path {label}, inference: sage_inference over the whole graph, {cfg} "
              f"({g.plan.total_blocks} blocks); build_graph {time.perf_counter() - t0:.2f} s")
        inf = model_path(f"{label} inference", lambda p, g, x, impl="auto":
                         sage_inference(model.tree(p), g, x, impl=impl),
                         None, None, model, g, x_full, None, {"spmm_block": 2}, None)
        res.update(request_ms=inf["request_ms"], plain_request_ms=inf["plain_request_ms"])
        del g
        torch.cuda.empty_cache()
        return res

    def classify_path(label):
        """Path M: GIN graph classification on examples/train_graph_classify.py's
        corpus (graphs of 30-80 nodes, dense or rings), 128 graphs in one
        block-diagonal batch (Xu et al., ICLR 2019: batches of 128), sum
        readout: one request and STEPS Adam steps."""
        count, feat_dim, hidden = 128, 16, 64
        rng = np.random.default_rng(0)
        graphs, labels = [], []
        for i in range(count):
            m = int(rng.integers(30, 80))
            if i % 2 == 0:
                a = sp.random(m, m, density=0.25, format="csr", random_state=rng)
            else:
                ii = np.arange(m)
                a = sp.csr_matrix((np.ones(m, np.float32), (ii, (ii + 1) % m)), shape=(m, m))
            graphs.append(((a + a.T) != 0).astype(np.float32).tocsr())
            labels.append(0 if i % 2 == 0 else 1)
        big, offs = block_diagonal(graphs)
        n = big.shape[0]
        g = build_graph(big.indptr, big.indices, n, PlanConfig(128, 128), symmetric=True,
                        device=dev)
        ids = torch.from_numpy(node_graph_ids(offs).astype(np.int64)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, feat_dim)).astype(np.float32)).to(dev)
        y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
        print(f"path {label}: {count} graphs, {n} nodes, {big.nnz} nnz in one block-diagonal "
              f"batch, PlanConfig(128, 128) ({g.plan.total_blocks} blocks); GIN classifier "
              f"{feat_dim} -> {hidden} -> 2, sum readout")
        model = GINClassifier(feat_dim, hidden, 2, generator=torch.Generator().manual_seed(36),
                              device=dev)

        def forward(p, g, x, impl="auto"):
            return gin_classifier_forward(model.tree(p), g, x, ids, count, impl=impl)

        def loss_fn(p, g, x, y, impl="auto"):
            return gin_classifier_loss(model.tree(p), g, x, ids, count, y, impl=impl)

        def make_step(opt):
            inner = make_classifier_train_step(opt)
            return lambda p, g, x, y, impl="auto": inner(model.tree(p), g, x, ids, y, impl=impl)

        res = model_path(label, forward, loss_fn, make_step, model, g, x, y, {"spmm_block": 2},
                         {"spmm_block": 3}, requests=1)
        del g
        torch.cuda.empty_cache()
        return res

    def same_plan(p, q):
        """Two plans of the port with the same tensors (bit for bit) and metadata."""
        return all((getattr(p, f) is None and getattr(q, f) is None)
                   or torch.equal(getattr(p, f), getattr(q, f))
                   for f in ("bitmask", "hind", "window_of_block", "block_ptr", "occ")) and \
            all(getattr(p, f) == getattr(q, f) for f in
                ("config", "num_nodes", "num_edges", "num_windows", "total_blocks",
                 "has_empty_windows", "num_cols"))

    def plan_builds(label, a, cfg):
        """csr_preprocess of `a` by the native preprocess and by the numpy path,
        each timed by the host clock; the two plans must be bit-identical."""
        built, secs = {}, {}
        for backend in ("native", "numpy"):
            t0 = time.perf_counter()
            built[backend] = csr_preprocess(a.indptr, a.indices, a.shape[0], cfg, backend=backend)
            secs[backend] = time.perf_counter() - t0
        ok = same_plan(built["native"], built["numpy"])
        print(f"path {label}: {cfg} by csr_preprocess(backend='native') {secs['native']:.3f} s, "
              f"backend='numpy' {secs['numpy']:.3f} s; bit-identical -> "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {label}: the native and numpy plans differ")
        return built["native"], secs

    # path N's model bundles: D, E, G, H and I exported where their paths
    # hold the model, the graph and the eager logits, served together after H
    model_work = os.path.join(ROOT, "build", "deploy_models")
    model_bundles = []

    def export_model(name, fn, xs, logits, plan, launches, names, ell_plan=None):
        """Path N on a model of path `name`: fn (one request on the path's
        graph, at its full width) exported with export_servable after the
        path's eager requests, the program's graph holding the path's
        registered ops, bundled with save_bundle (with `plan`; an ELL plan
        goes beside the bundle, for the serving process's constants check),
        and timed in turns against the eager request in this process. The
        serving process (`serve_models`) later answers the path's inputs
        `xs`, whose eager `logits` are saved here."""
        from voltrix_spmm_tpu_torch.serve import export_servable, load_servable, save_bundle

        t_path = time.perf_counter()
        os.makedirs(model_work, exist_ok=True)
        rec = {}
        t0 = time.perf_counter()
        blob = export_servable(fn, xs[0])
        rec["export_s"] = time.perf_counter() - t0
        path = os.path.join(model_work, f"bundle_{name}")
        save_bundle(path, blob, plan=plan, meta={"path": name})
        rec["bundle_bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                  for f in os.listdir(path))
        loaded = load_servable(blob)
        ops = sorted({str(nd.target) for nd in loaded.graph.nodes
                      if nd.op == "call_function" and str(nd.target).startswith("voltrix.")})
        want_ops = sorted(f"voltrix.{REGISTERED[k]}.default" for k in launches)
        if ops != want_ops:
            fail(f"path N ({name}): the exported program's ops are {ops}, not {want_ops}")
        entry = {"name": name, "path": path, "launches": launches, "kernels": list(names),
                 "xs": [], "ys": []}
        for i, (x, y) in enumerate(zip(xs, logits)):
            for what, t in (("xs", x), ("ys", y)):
                f = os.path.join(model_work, f"{what[0]}_{name}_{i}.pt")
                torch.save(t.detach().cpu(), f)
                entry[what].append(f)
        if ell_plan is not None:
            entry["ell_plan"] = ell_plan.save(os.path.join(model_work, f"ell_plan_{name}.npz"))
        x = xs[0]
        with torch.no_grad():
            same = torch.equal(loaded(x), logits[0])
            l_ms, e_ms, turns = in_turns(torch, lambda: loaded(x), lambda: fn(x), plain_iters=10)
        if not same:
            fail(f"path N ({name}): the loaded program's logits in this process are not the "
                 "eager path's")
        rec.update(loaded_request_ms=l_ms, eager_request_ms=e_ms)
        del loaded
        rec["main_s"] = time.perf_counter() - t_path
        print(f"  path N ({name}): export_servable {rec['export_s']:.2f} s, program "
              f"{len(blob)} bytes, bundle {rec['bundle_bytes']} bytes "
              f"({', '.join(sorted(os.listdir(path)))}); the program's ops {ops}; loaded "
              f"program bit-identical to the eager request; loaded {turns[1]:.4f} / "
              f"{turns[2]:.4f} ms, eager {turns[0]:.4f} / {turns[3]:.4f} ms (CUDA events, 20 "
              f"calls after 3, eager 10 after 1, in turns); {rec['main_s']:.1f} s here")
        path_n[f"model_{name}"] = rec
        model_bundles.append(entry)

    def serve_models():
        """Path N's models served: two fresh processes that import only
        voltrix_spmm_tpu_torch.serve (chip_smoke.py --serve-bundles), side by
        side, each answering REQUESTS requests of every bundle of
        export_model, the second after aot_compile's warm call; logits bit for
        bit the eager path's, the kernels launched by counter and by
        torch.profiler's names, the plans among the programs' constants, cold
        start and bundle bytes."""
        import shutil

        t_path = time.perf_counter()
        procs = []
        for proc, warm in enumerate((False, True)):
            spec_path = os.path.join(model_work, f"serve{proc}.json")
            with open(spec_path, "w") as f:
                json.dump({"bundles": [dict(e, warm=warm) for e in model_bundles]}, f)
            procs.append((time.perf_counter(), subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--serve-bundles",
                 spec_path], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for proc, (t0, p) in enumerate(procs):
            stdout, stderr = p.communicate(timeout=600)
            for line in stdout.strip().splitlines()[:-1]:
                print(f"  [model serving process {proc}] {line}")
            if p.returncode:
                fail(f"path N: model serving process {proc} exited {p.returncode}: "
                     f"{stderr[-3000:]}")
            out = json.loads(stdout.strip().splitlines()[-1])
            print(f"  model serving process {proc}: {time.perf_counter() - t0:.1f} s in all")
            for entry, o in zip(model_bundles, out["bundles"]):
                for i, (y_file, want_file) in enumerate(zip(o["ys"], entry["ys"])):
                    same = torch.equal(torch.load(y_file), torch.load(want_file))
                    print(f"  bundle {o['tag']} request {i} from the fresh process: "
                          f"bit-identical to the eager path {same}")
                    if not same:
                        fail(f"path N: bundle {o['tag']} request {i} disagrees with the eager "
                             "path")
                path_n[f"model_{entry['name']}"].update(
                    {f"cold_{k}{'_aot' if proc else ''}": v for k, v in o.items()
                     if k.endswith("_s")})
        shutil.rmtree(model_work, ignore_errors=True)
        path_n["models_serve_s"] = time.perf_counter() - t_path
        print(f"path N (models D, E, G, H, I): served in {path_n['models_serve_s']:.1f} s")

    def deploy_path(label, a, g, params_np, xs, logits, trained):
        """Path N: the deployment path on A's graph at 128 -> 256 -> 40. The
        native and numpy plan builds timed and held bit for bit; A's plan
        saved dense and packed, loaded back bit for bit and validated; the
        CLI's info, preprocess (native, packed), validate and spmm run each
        in a process of its own; the GCN request on A's plan (K1) and on B's
        (K2) and spmm on J.2's hybrid plan (K3 + K1) exported and bundled;
        the bundles served from fresh processes that import only
        voltrix_spmm_tpu_torch.serve (their logits bit for bit the eager
        path's, the kernels launched from the loaded programs, the plans
        among the programs' constants, cold start with and without
        aot_compile's warm call); the loaded programs timed in turns against
        the eager path; compiled_stats, a checkpoint round trip of A's
        trained parameters, spmm_tuple and profile_op on the card; and the
        host time a call of a registered op takes."""
        import shutil

        from voltrix_spmm_tpu_torch import (SpmmPlan, csr_preprocess_tuple, load_checkpoint,
                                            save_checkpoint, spmm_tuple, validate_plan)
        from voltrix_spmm_tpu_torch.data import save_npz_graph
        from voltrix_spmm_tpu_torch.format import packed_stats
        from voltrix_spmm_tpu_torch.models import gcn_forward
        from voltrix_spmm_tpu_torch.ops import library
        from voltrix_spmm_tpu_torch.profiling import attribute_spmm, profile_op
        from voltrix_spmm_tpu_torch.serve import compiled_stats, export_servable, save_bundle
        from voltrix_spmm_tpu_torch.serve import load_servable

        t_path = time.perf_counter()
        n = a.shape[0]
        work = os.path.join(ROOT, "build", "deploy")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        res = {}

        deg_a = torch.from_numpy(np.diff(a.indptr).astype(np.float32)).to(dev)[:, None]
        # 1. the plan, built by the native preprocess and by the numpy path
        plan, secs = plan_builds(label, a, PlanConfig(128, 128))
        res.update(native_build_s=secs["native"], numpy_build_s=secs["numpy"])
        if not same_plan(plan, g.plan.to("cpu")):
            fail(f"path {label}: the native plan is not path A's plan")

        # 2. plan files, dense and packed
        stats = packed_stats(plan.bitmask)
        for packed in (False, True):
            path = plan.save(os.path.join(work, f"plan_{'packed' if packed else 'dense'}.npz"),
                             packed=packed)
            t0 = time.perf_counter()
            back = SpmmPlan.load(path)
            t_load = time.perf_counter() - t0
            validate_plan(back)
            ok = same_plan(back, plan)
            size = os.path.getsize(path)
            res[f"plan_file_bytes_{'packed' if packed else 'dense'}"] = size
            print(f"  SpmmPlan.save(packed={packed}): {size} bytes; load {t_load:.3f} s, "
                  f"bit-identical {ok}, validate_plan ok")
            if not ok:
                fail(f"path {label}: the plan file (packed={packed}) did not load back bit for bit")
        print(f"  packed_stats: dense bitmask {stats['dense_bytes']} bytes, packed "
              f"{stats['packed_bytes']} bytes, saving {stats['saving']:.4f}")
        res["packed_saving"] = stats["saving"]

        # the CLI, each command in a process of its own, the four side by side
        # and beside the exports
        graph_path = save_npz_graph(os.path.join(work, "a.npz"), a)
        cli = [sys.executable, "-m", "voltrix_spmm_tpu_torch"]
        cli_plan = os.path.join(work, "cli_plan.npz")
        commands = [cli + ["info"],
                    cli + ["preprocess", graph_path, "--backend", "native", "--packed",
                           "-o", cli_plan],
                    cli + ["validate", os.path.join(work, "plan_packed.npz")],
                    cli + ["spmm", graph_path, "-d", "128", "--time"]]

        def run_cli(cmd):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
            return cmd, r, time.perf_counter() - t0

        cli_pool = ThreadPoolExecutor(len(commands))
        cli_futures = [cli_pool.submit(run_cli, cmd) for cmd in commands]

        # 3. exports and bundles: the GCN request on A's plan (K1) and on B's
        # (K2), spmm on J.2's hybrid plan (K3 + K1)
        params = {k: v.to(dev) for k, v in gcn_params_from_jax(params_np, dev).items()}
        t0 = time.perf_counter()
        g_b = build_graph(a.indptr, a.indices, n,
                          PlanConfig(2048, 128, block_unroll=4, cluster_cols=True),
                          symmetric=True, device=dev)
        hplan = csr_preprocess_hybrid(a.indptr, a.indices, n).to(dev)
        torch.cuda.synchronize()
        print(f"  B's graph and J.2's hybrid plan built in {time.perf_counter() - t0:.2f} s")
        requests = {
            "A": (lambda x: gcn_forward(params, g, x), g.plan, "spmm_block",
                  lambda x: gcn_forward(params, g, x, impl="reference")),
            "B": (lambda x: gcn_forward(params, g_b, x), g_b.plan, "spmm_subtile",
                  lambda x: gcn_forward(params, g_b, x, impl="reference")),
            "J.2": (lambda x: spmm(hplan, x), None, None,
                    lambda x: spmm(hplan, x, impl="reference")),
        }
        blobs, bundles = {}, {}
        for name, (fn, bplan, _, _) in requests.items():
            t0 = time.perf_counter()
            blobs[name] = export_servable(fn, xs[0])
            t_export = time.perf_counter() - t0
            bundles[name] = os.path.join(work, f"bundle_{name}")
            save_bundle(bundles[name], blobs[name], plan=bplan, meta={"path": name})
            size = sum(os.path.getsize(os.path.join(bundles[name], f))
                       for f in os.listdir(bundles[name]))
            res[f"export_s_{name}"], res[f"bundle_bytes_{name}"] = t_export, size
            print(f"  export_servable({name}) {t_export:.2f} s, program {len(blobs[name])} bytes, "
                  f"bundle {size} bytes ({', '.join(sorted(os.listdir(bundles[name])))})")
        for i, x in enumerate(xs):
            torch.save(x.cpu(), os.path.join(work, f"x{i}.pt"))

        cli_out = [f.result() for f in cli_futures]
        cli_pool.shutdown()
        for cmd, r, secs in cli_out:
            shown = " ".join(c if not c.startswith(work) else os.path.basename(c) for c in cmd[1:])
            last = (r.stdout.strip().splitlines() or [""])[-1]
            print(f"  {shown}: rc {r.returncode}, {secs:.1f} s; {last[:200]}")
            if r.returncode:
                fail(f"path {label}: `{shown}` exited {r.returncode}: {r.stderr[-2000:]}")
        info = json.loads(cli_out[0][1].stdout)
        rec = json.loads(cli_out[1][1].stdout)
        spmm_rec = json.loads(cli_out[3][1].stdout)
        if not cli_out[2][1].stdout.startswith("ok:"):
            fail(f"path {label}: validate printed {cli_out[2][1].stdout!r}")
        if not (info["nvcc"] and info["cxx"] and info["native_runtime"] and
                info["device"] == kind and "packed" in rec and spmm_rec["device"] == "cuda"
                and spmm_rec["difference_rate"] < 1e-4):
            fail(f"path {label}: the CLI's records disagree: {info} {rec} {spmm_rec}")
        if not same_plan(SpmmPlan.load(cli_plan), plan):
            fail(f"path {label}: the CLI's packed plan is not A's plan bit for bit")
        print(f"  the CLI's packed plan equals A's plan bit for bit; its spmm on the card: "
              f"difference rate {spmm_rec['difference_rate']:.3e}, {spmm_rec['ms']:.4f} ms")

        # 4. fresh processes: cold start without and with aot_compile's warm
        # call, the requests, the profiler, the constants
        walk = ["spmm_walk_kernel"]
        a_, b_ = ({"launches": {k: 2}, "kernels": walk} for k in ("spmm_block", "spmm_subtile"))
        j2 = {"launches": {"spmm_fused": 1, "spmm_block": 1},
              "kernels": ["spmm_fused_kernel", *walk]}
        spec = [{"name": "A", "path": bundles["A"], "warm": False, **a_},
                {"name": "B", "path": bundles["B"], "warm": False, **b_},
                {"name": "A", "path": bundles["A"], "warm": True, "process": 1, **a_},
                {"name": "J.2", "path": bundles["J.2"], "warm": False, "process": 1, **j2}]
        served, procs = {}, []
        for proc in (0, 1):  # the two processes side by side
            mine = [s for s in spec if s.get("process", 0) == proc]
            spec_path = os.path.join(work, f"serve{proc}.json")
            with open(spec_path, "w") as f:
                json.dump({"bundles": mine, "xs": [os.path.join(work, f"x{i}.pt")
                                                   for i in range(REQUESTS)]}, f)
            procs.append((mine, time.perf_counter(), subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--serve-bundles",
                 spec_path], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for proc, (mine, t0, p) in enumerate(procs):
            stdout, stderr = p.communicate(timeout=600)
            secs = time.perf_counter() - t0
            for line in stdout.strip().splitlines()[:-1]:
                print(f"  [serving process {proc}] {line}")
            if p.returncode:
                fail(f"path {label}: serving process {proc} exited {p.returncode}: "
                     f"{stderr[-3000:]}")
            out = json.loads(stdout.strip().splitlines()[-1])
            print(f"  serving process {proc}: {secs:.1f} s in all")
            res[f"serving{proc}_import_s"] = out["import_s"]
            res[f"serving{proc}_context_s"] = out["context_s"]
            for entry, o in zip(mine, out["bundles"]):
                served[(entry["name"], entry["warm"])] = o
        for (name, warm), o in served.items():
            fn, _, _, plain_fn = requests[name]
            for i, x in enumerate(xs):
                got = torch.load(os.path.join(work, f"y_{o['tag']}_{i}.pt")).to(dev)
                with torch.no_grad():
                    eager, plain = fn(x), plain_fn(x)
                if name == "J.2":
                    ok, err = sum_bound_ok(got, plain, deg_a, spmm_reference(g.plan, x.abs()))
                else:
                    ok, err = bool(torch.allclose(got, plain, **TOL_LOGITS)), \
                        (got - plain).abs().max().item()
                same = torch.equal(got, eager)
                print(f"  bundle {o['tag']} request {i} from the fresh process: bit-identical to the "
                      f"eager path {same}; max|loaded - plain| {err:.3e} -> "
                      f"{'ok' if same and ok else 'MISMATCH'}")
                if not (same and ok):
                    fail(f"path {label}: bundle {o['tag']} request {i} disagrees")
        for key, o in served.items():
            res.update({f"cold_{k}_{key[0]}{'_aot' if key[1] else ''}": v
                        for k, v in o.items() if k.endswith("_s")})

        # the loaded programs against the eager path, in turns
        for name, (fn, _, _, _) in requests.items():
            loaded = load_servable(blobs[name])
            x = xs[0]
            with torch.no_grad():
                l_ms, e_ms, turns = in_turns(torch, lambda: loaded(x), lambda: fn(x),
                                             plain_iters=20)
            res[f"loaded_request_ms_{name}"], res[f"eager_request_ms_{name}"] = l_ms, e_ms
            print(f"  request {name}: loaded program {turns[1]:.4f} / {turns[2]:.4f} ms, eager "
                  f"path {turns[0]:.4f} / {turns[3]:.4f} ms (CUDA events, 20 calls after 3)")
            del loaded
        del blobs

        # 5. the smaller pieces
        st = compiled_stats(requests["A"][0], xs[0])
        print(f"  compiled_stats(A's request): {st['flops']} flops, arguments "
              f"{st['argument_size_in_bytes']} bytes, output {st['output_size_in_bytes']} bytes, "
              f"peak {st['peak_device_bytes']} bytes beyond what was allocated")
        want_flops = 2 * plan.num_edges * (128 + 256) + 2 * n * (128 * 256 + 256 * 40)
        if st["flops"] != want_flops:
            fail(f"path {label}: compiled_stats counts {st['flops']} flops, not {want_flops}")
        res.update(flops=st["flops"], peak_bytes=st["peak_device_bytes"])

        ckpt = save_checkpoint(os.path.join(work, "ckpt", "gcn.pt"),
                               {k: v.detach() for k, v in trained.items()})
        restored = load_checkpoint(ckpt, map_location=dev)
        with torch.no_grad():
            same = torch.equal(gcn_forward(restored, g, xs[0]),
                               gcn_forward({k: v.detach() for k, v in trained.items()}, g, xs[0]))
        print(f"  save_checkpoint / load_checkpoint of A's parameters after its {STEPS} SGD "
              f"steps: logits bit-identical {same}")
        if not same:
            fail(f"path {label}: the restored parameters give other logits")

        blk, hspa, hind = csr_preprocess_tuple(a.indptr, a.indices, n, device=dev)
        out = spmm_tuple(blk, hspa, hind, n, a.nnz, xs[0])
        foreign = spmm_tuple(blk.clone(), hspa.clone(), hind.clone(), n, a.nnz, xs[0])
        ok, err = sum_bound_ok(out, spmm_reference(g.plan, xs[0]), deg_a,
                               spmm_reference(g.plan, xs[0].abs()))
        ok = ok and torch.equal(out, foreign)
        print(f"  spmm_tuple on the card: against the plain version max|diff| {err:.3e} "
              f"(float32 summation bound), rebuilt from copied arrays bit-identical "
              f"{torch.equal(out, foreign)} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"path {label}: spmm_tuple disagrees")
        del blk, hspa, hind

        table = profile_op(requests["A"][0], xs[0])
        split = attribute_spmm(table, g.plan)
        res["k1_share"] = split["kernel_frac"]
        print(f"  profile_op(A's request): {len(table)} kernels, {split['total_ms']:.4f} ms a "
              f"request; SpMM kernels {split['kernel_ms']:.4f} ms (share "
              f"{split['kernel_frac']:.4f}), gathers {split['gather_ms']:.4f} ms, other "
              f"{split['other_ms']:.4f} ms")

        # the host time of one registered op call, on a plan small enough that
        # the launch is the cost: the wrapper, the op alone, and the launch as
        # the wrapper made it before the op (check, output, launch)
        small = erdos_renyi_csr(256, 0.02, seed=0)
        sp_plan = csr_preprocess(small.indptr, small.indices, 256).to(dev)
        x8 = torch.from_numpy(np.random.default_rng(71).standard_normal((256, 8)).astype(
            np.float32)).to(dev)
        ops_, geom = library.operands(sp_plan, "spmm_block", x8.device)
        ops_t, geom_t = library.no_plan(ops_, geom)
        walk = block_spmm.plan_walk(sp_plan, "spmm_block")
        lib = block_spmm.load_library()

        def bare():
            block_spmm._check(sp_plan, x8)
            o = torch.empty(256, 8, dtype=torch.float32, device=dev)
            block_spmm.launch_walk("spmm_block", lib, sp_plan, x8, o, walk)
            return o

        def host_us(fn, calls=2000):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / calls * 1e6

        if not torch.equal(spmm_block(sp_plan, x8), bare()):
            fail(f"path {label}: the op and the bare launch differ")
        host = {}
        for _ in range(2):  # in turns: bare, op, wrapper, wrapper, op, bare
            for what, fn in (("bare launch", bare),
                             ("op", lambda: library.spmm_block_op(x8, ops_, geom, ops_t, geom_t)),
                             ("wrapper", lambda: spmm_block(sp_plan, x8))):
                host.setdefault(what, []).append(host_us(fn))
        print("  host us per call on a 256-node plan at d 8 (2000 calls, in turns): " +
              ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in host.items()))
        res.update({f"host_us_{k.replace(' ', '_')}": sum(v) / 2 for k, v in host.items()})
        res["host_us_ops"] = op_host_us(small, x8, host_us)

        del g_b, hplan, plan
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
        res["path_s"] = time.perf_counter() - t_path
        print(f"path {label}: {res['path_s']:.1f} s in all")
        path_n.update(res)

    def op_host_us(small, x8, host_us):
        """Path N: the host microseconds of one call of each op of K4-K15 on
        `small`'s 256-node plan at d 8 (H 2 for K13-K15), the wrapper a user
        calls and the registered op alone on its kept operands, in turns
        (op, wrapper, wrapper, op), 1000 calls each; the op's output against
        the wrapper's, bit for bit."""
        from voltrix_spmm_tpu_torch import csr_preprocess_ell
        from voltrix_spmm_tpu_torch.ops import library

        n, L = 256, library
        hrng = np.random.default_rng(72)

        def f32(*shape):
            return torch.from_numpy(hrng.standard_normal(shape).astype(np.float32)).to(dev)

        plan = csr_preprocess(small.indptr, small.indices, n).to(dev)
        vals = hrng.standard_normal(small.nnz).astype(np.float32)
        wplan = csr_preprocess(small.indptr, small.indices, n, values=vals).to(dev)
        eplan = csr_preprocess_ell(small.indptr, small.indices, n, values=vals).to(dev)
        g8, q, k, v, gq = f32(n, 8), f32(n, 8), f32(n, 8), f32(n, 8), f32(n, 8)
        q2, k2, v2, g2 = f32(2, n, 8), f32(2, n, 8), f32(2, n, 8), f32(2, n, 8)
        out, lse = spmm_attention(plan, q, k, v, return_stats=True)
        out2, lse2 = spmm_attention_mh(plan, q2, k2, v2, return_stats=True)
        d_row, d_row2 = (gq * out).sum(-1), (g2 * out2).sum(-1)
        rows, scale = quant.quantize_padded(x8)
        one = [t[None] for t in (q, k, v, gq, lse, d_row)]
        sc = 8 ** -0.5

        def ops(p, kind, ell_plan=False):
            o, geom = (L.ell_operands if ell_plan else L.operands)(p, kind, dev)
            return o, geom, *L.no_plan(o, geom)

        ow, gw, nw, ngw = ops(wplan, "spmm_weighted")
        oe, ge, ne, nge = ops(eplan, "spmm_ell", True)
        o7, g7, n7, ng7 = ops(eplan, "spmm_ell_dvals", True)
        o9, g9, n9, ng9 = ops(plan, "spmm_attention")
        o13, g13, n13, ng13 = ops(plan, "spmm_attention_mh")
        calls = {
            "K4 spmm_weighted": (
                lambda: spmm_weighted(wplan, x8),
                lambda: L.spmm_weighted_op(x8, wplan.values, ow, gw, nw, ngw, None, nw, ngw)),
            "K5 spmm_dvalues": (
                lambda: spmm_weighted_dvalues(plan, x8, g8),
                lambda: L.spmm_dvalues_op(x8, g8, *ops(plan, "spmm_dvalues")[:2])),
            "K6 spmm_ell": (
                lambda: spmm_ell(eplan, x8),
                lambda: L.spmm_ell_op(x8, eplan.vals, oe, ge, ne, nge, None, ne, nge, False)),
            "K7 spmm_ell_dvals": (
                lambda: spmm_ell_dvals(eplan, x8, g8),
                lambda: L.spmm_ell_dvals_op(x8, g8, o7, g7, n7, ng7, n7, ng7)),
            "K8 spmm_int8": (
                lambda: quant.launch_quantized(plan, rows, scale, 8),
                lambda: L.spmm_int8_op(rows, scale, *ops(plan, "spmm_int8")[:2], 8)),
            "K9 spmm_attention": (
                lambda: spmm_attention(plan, q, k, v, scale=sc, return_stats=True),
                lambda: L.spmm_attention_op(q, k, v, o9, g9, n9, ng9, n9, ng9, sc, 1.0)),
            "K10 attention_bwd": (
                lambda: attention_bwd_summed(plan, q, k, v, out, lse, gq, scale=sc),
                lambda: L.attention_bwd_op(q, k, v, out, lse, gq,
                                           *ops(plan, "attention_bwd")[:2], sc, 1.0, True)),
            "K11 attention_dq": (
                lambda: attention_dq(plan, q, k, v, gq, lse, d_row, scale=sc),
                lambda: L.attention_dq_op(*one, *ops(plan, "attention_dq")[:2], sc, 1.0, None)),
            "K12 attention_dkv": (
                lambda: attention_dkv(plan, q, k, v, gq, lse, d_row, scale=sc),
                lambda: L.attention_dkv_op(*one, *ops(plan, "attention_dkv")[:2], sc, 1.0,
                                           None)),
            "K13 spmm_attention_mh": (
                lambda: spmm_attention_mh(plan, q2, k2, v2, scale=sc, return_stats=True),
                lambda: L.spmm_attention_mh_op(q2, k2, v2, o13, g13, n13, ng13, n13, ng13, sc,
                                               1.0, None)),
            "K14 attention_mh_dq": (
                lambda: attention_mh_dq(plan, q2, k2, v2, g2, lse2, d_row2, scale=sc),
                lambda: L.attention_mh_dq_op(q2, k2, v2, g2, lse2, d_row2,
                                             *ops(plan, "attention_mh_dq")[:2], sc, 1.0, None)),
            "K15 attention_mh_dkv": (
                lambda: attention_mh_dkv(plan, q2, k2, v2, g2, lse2, d_row2, scale=sc),
                lambda: L.attention_mh_dkv_op(q2, k2, v2, g2, lse2, d_row2,
                                              *ops(plan, "attention_mh_dkv")[:2], sc, 1.0,
                                              None)),
        }
        res = {}
        for name, (wrapper, op) in calls.items():
            w_out, o_out = wrapper(), op()
            w_out, o_out = ((w_out,), (o_out,)) if isinstance(w_out, torch.Tensor) else (w_out,
                                                                                         o_out)
            if name.startswith(("K11", "K12")):
                o_out = [t[0] for t in o_out]
            if not all(torch.equal(a_, b_.reshape(a_.shape)) for a_, b_ in zip(w_out, o_out)):
                fail(f"path N: {name}'s op alone and its wrapper differ")
            turns = [host_us(f, calls=1000) for f in (op, wrapper, wrapper, op)]
            res[name] = {"op": (turns[0] + turns[3]) / 2, "wrapper": (turns[1] + turns[2]) / 2}
        print("  host us per call, 256-node plans at d 8 (H 2 for K13-K15; 1000 calls, in turns "
              "op, wrapper, wrapper, op): " + "; ".join(
                  f"{k} op {v['op']:.2f}, wrapper {v['wrapper']:.2f}" for k, v in res.items()))
        return res

    def c_plan_builds(a):
        """Path N's step 1 on C's graph: its plan by the native preprocess,
        timed (the numpy build, ~24 s, and the bit-for-bit comparison went
        when R.6 joined the run; step 1 keeps both on A)."""
        t0 = time.perf_counter()
        csr_preprocess(a.indptr, a.indices, a.shape[0],
                       PlanConfig(2048, 128, gather_segment=128, block_unroll=4), backend="native")
        secs = time.perf_counter() - t0
        print(f"path N on the protein proxy (C's plan): csr_preprocess(backend='native') "
              f"{secs:.3f} s")
        path_n.update(c_native_build_s=secs)

    # --- path P: the parallel trainers (parallel/, torch.distributed) ------
    def parallel_path(label, a):
        """GCN training on A's graph at full width (128 -> 256 -> 40,
        PlanConfig(128, 128), STEPS SGD steps at lr 0.01) through each
        parallel mode's trainer, on ranks of parallel.comm.launch: all five
        modes on one rank under NCCL, then 4 ranks under gloo sharing
        cuda:0; then dryrun_multichip on 4 ranks of the card. Each mode's
        losses and updated parameters against the single-process step on
        A's whole plan (K1) within P_GATE (two faults that scale gradients
        2x, computed on the single process, must land 10x past it), its
        step-0 logits against a float64 host
        forward on the first and last 2,048 rows, K1's launches per rank
        per step and no plain SpMM; prints rank 0's step times (ranks that
        share one card: not a scale-out time), the plans' set-up seconds,
        the collectives' bytes per step, each rank's peak memory and the
        collectives staged through host memory. Returns K1's launches per
        rank per step and the step times by layout and mode."""
        from voltrix_spmm_tpu_torch import gcn_forward
        from voltrix_spmm_tpu_torch.parallel import (
            build_grid2d_plan, build_ring_sharded_plan, build_row_sharded_plan, checks, comm)
        from voltrix_spmm_tpu_torch.parallel.dryrun import dryrun_multichip
        from voltrix_spmm_tpu_torch.parallel.sharded import full_gcn_params

        t_path = time.perf_counter()
        n, ip, ix = a.shape[0], a.indptr, a.indices
        (d, hidden, classes), cfg, lr, seed = (128, 256, 40), PlanConfig(128, 128), 1e-2, 19
        prng = np.random.default_rng(1)  # path A's draws
        params_np = {k: v.astype(np.float32) for k, v in {
            "w1": prng.standard_normal((d, hidden)) * (2.0 / d) ** 0.5,
            "b1": prng.standard_normal(hidden) * 0.1,
            "w2": prng.standard_normal((hidden, classes)) * (2.0 / hidden) ** 0.5,
            "b2": prng.standard_normal(classes) * 0.1}.items()}
        print(f"path {label}: GCN {d} -> {hidden} -> {classes}, {cfg}, {STEPS} SGD steps at lr "
              f"{lr}; collectives staged through host memory (comm.STAGED, from "
              f"tools/gloo_probe.py): {sorted(comm.STAGED)}")

        # the single-process step on A's whole plan (K1), batch 0 = one
        # graph's rows, else that many feature sets (dp x tp)
        g = build_graph(ip, ix, n, cfg, symmetric=True, device=dev)
        rows = np.r_[0:2048, n - 2048:n]

        def sgd(x, y, scale=None):
            """STEPS single-process SGD steps from params_np: losses, final
            parameters, step-0 logits; `scale` multiplies gradients by name."""
            p, losses, logits0 = gcn_params_from_jax(params_np, dev), [], None
            for _ in range(STEPS):
                q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
                logits = gcn_forward(q, g, x, transform_first=False)
                logits0 = logits.detach() if logits0 is None else logits0
                loss = F.cross_entropy(logits.reshape(-1, classes), y.reshape(-1))
                grads = torch.autograd.grad(loss, list(q.values()))
                p = {k: (v - lr * (scale or {}).get(k, 1.0) * gr).detach()
                     for (k, v), gr in zip(q.items(), grads)}
                losses.append(loss.item())
            return {"losses": losses, "params": {k: v.cpu().numpy() for k, v in p.items()},
                    "logits0": logits0}

        def gaps(run, ref):
            """Path P's two numbers: the losses' largest rel difference and
            the updated parameters' max|d| / max|p|, over the parameters."""
            rel = max(abs(u - v) / abs(v) for u, v in zip(run["losses"], ref["losses"]))
            upd = max(np.abs(run["params"][k] - v).max() / np.abs(v).max()
                      for k, v in ref["params"].items())
            return rel, upd

        # the faults the gates must see: a row-parallel sum whose backward
        # sums (tp 2 scales every gradient upstream of it: w2, b1, w1), and
        # the row-sharded count summed inside autograd (2 ranks scale all)
        faults = {1: ("row-parallel sum's backward summed, tp 2", {"w1": 2.0, "b1": 2.0,
                                                                  "w2": 2.0}),
                  0: ("count summed in autograd, 2 ranks", dict.fromkeys(params_np, 2.0))}
        refs = {}
        for batch in (0, 1, 2):
            arr = checks.problem_arrays(ip, n, n, d, classes, seed, batch)
            x = torch.from_numpy(arr["xb"] if batch else arr["x"]).to(dev)
            y = torch.from_numpy(arr["yb"] if batch else arr["y"]).to(dev)
            refs[batch] = sgd(x, y)
            first = (arr["xb"][0] if batch else arr["x"]).astype(np.float64)
            refs[batch]["host"] = (host_forward(a, first, params_np, rows) if batch < 2
                                   else refs[1]["host"])
            logits0 = refs[batch].pop("logits0").reshape(-1, n, classes)[0][rows].cpu().numpy()
            print(f"  single process (K1, batch {batch}): losses "
                  f"{[round(v, 6) for v in refs[batch]['losses']]}; step-0 logits against the "
                  f"float64 host forward on {len(rows)} rows: max|diff| "
                  f"{np.abs(logits0 - refs[batch]['host']).max():.3e}")
            if batch in faults:
                what, scale = faults[batch]
                rel, upd = gaps(sgd(x, y, scale), refs[batch])
                print(f"  fault {what}: loss rel {rel:.3e}, update max|d|/max|p| {upd:.3e} "
                      f"(gate {P_GATE:g})")
                if max(rel, upd) < 10 * P_GATE:
                    fail(f"path {label}: the gates would not see the fault {what}")
        del g, x, y
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        plans, plan_s = {}, {}
        for key, build in (
                ("row 1", lambda: build_row_sharded_plan(ip, ix, n, 1, cfg, with_transpose=True)),
                ("ring 1", lambda: build_ring_sharded_plan(ip, ix, n, 1, cfg, with_transpose=True)),
                ("grid 1x1", lambda: build_grid2d_plan(ip, ix, n, 1, 1, cfg, with_transpose=True)),
                ("row 4 balanced", lambda: build_row_sharded_plan(ip, ix, n, 4, cfg,
                                                                  with_transpose=True,
                                                                  balance=True)),
                ("ring 4", lambda: build_ring_sharded_plan(ip, ix, n, 4, cfg, with_transpose=True)),
                ("grid 2x2", lambda: build_grid2d_plan(ip, ix, n, 2, 2, cfg, with_transpose=True))):
            t1 = time.perf_counter()
            plans[key] = build()
            plan_s[key] = round(time.perf_counter() - t1, 3)
        print(f"  plans (host, with transposes): {time.perf_counter() - t0:.2f} s in all; by plan "
              f"{plan_s}; blocks a shard (tb_max / tbt_max): "
              f"{ {k: (p.tb_max, p.tbt_max) for k, p in plans.items()} }")

        # (layout, ranks, backend, feature sets of dp x tp, [(case, mode,
        # plan, mesh)]): every mode on one rank, then on four ranks sharing
        # cuda:0 (a layout of two ranks, row-sharded contiguous and balanced,
        # ring and dp x tp 1 x 2, went when R.6 joined the run: each gloo
        # layout starts its own processes)
        layouts = (
            ("1 rank, nccl", 1, "nccl", 1, [
                ("row_sharded 1", "row_sharded", "row 1", None),
                ("ring 1", "ring", "ring 1", None),
                ("hybrid 1x1", "hybrid", "ring 1", (1, 1)),
                ("grid2d 1x1", "grid2d", "grid 1x1", (1, 1)),
                ("dp_tp 1x1", "dp_tp", None, (1, 1))]),
            ("4 ranks on cuda:0, gloo", 4, "gloo", 2, [
                ("row_sharded 4 balanced", "row_sharded", "row 4 balanced", None),
                ("ring 4", "ring", "ring 4", None),
                ("hybrid 2x2", "hybrid", "ring 4", (2, 2)),
                ("grid2d 2x2", "grid2d", "grid 2x2", (2, 2)),
                ("dp_tp 2x2", "dp_tp", None, (2, 2))]),
        )
        out = {}
        for layout, world, backend, batch, cases in layouts:
            spec = {"indptr": ip, "indices": ix, "n": n, "cfg": cfg, "params": params_np, "d": d,
                    "classes": classes, "seed": seed, "batch": batch, "lr": lr, "steps": STEPS,
                    "logits": True,
                    "cases": [{"name": name, "mode": mode, "plan": plans.get(key), "mesh": mesh}
                              for name, mode, key, mesh in cases]}
            t0 = time.perf_counter()
            ranks = comm.launch(checks.train_cases, world, spec, "cuda", backend=backend,
                                timeout=300)
            print(f"  {layout}: launch {time.perf_counter() - t0:.1f} s ({world} processes: "
                  f"start, set-up, {STEPS} steps, step-0 logits)")
            for c in spec["cases"]:
                name, mode, plan = c["name"], c["mode"], c["plan"]
                res = [r[name] for r in ranks]
                shards = 1 if plan is None else getattr(plan, "ndev", 1)
                want = 3 * (shards if mode in ("ring", "hybrid") else 1)
                k1 = [r["launches"] / STEPS for r in res]
                if k1 != [want] * world or any(r["plain_calls"] for r in res):
                    fail(f"path {label} {layout} {name}: K1 launches per rank per step {k1} "
                         f"(want {want}), plain calls {[r['plain_calls'] for r in res]}")
                if any(r["losses"] != res[0]["losses"] for r in res):
                    fail(f"path {label} {layout} {name}: the ranks' losses differ")
                if mode == "dp_tp":
                    by = {r["coords"]: r for r in res}
                    dp, tp = c["mesh"]
                    got = full_gcn_params([by[(0, j)]["params"] for j in range(tp)])
                    logits0 = np.concatenate([by[(i, 0)]["logits0"] for i in range(dp)])[0]
                    ref = refs[batch]
                else:
                    got = res[0]["params"]
                    if any(not np.array_equal(r["params"][k], got[k]) for r in res for k in got):
                        fail(f"path {label} {layout} {name}: the ranks' parameters differ")
                    by = {r["index"]: r["logits0"] for r in res}
                    logits0 = plan.assemble([by[i] for i in range(len(res))])[:n]
                    ref = refs[0]
                rel, upd = gaps({"losses": res[0]["losses"], "params": got}, ref)
                host_err = np.abs(logits0[rows] - ref["host"]).max()
                ok = (rel < P_GATE and upd < P_GATE
                      and np.allclose(logits0[rows], ref["host"], **TOL_LOGITS))
                ms = res[0]["ms"]
                per_step = {k: v // STEPS for k, v in
                            sorted(sum((Counter(r["traffic"]) for r in res), Counter()).items())}
                print(f"    {name}: losses {[round(v, 6) for v in res[0]['losses']]}, rel "
                      f"{rel:.2e}, update max|d|/max|p| {upd:.2e}, step-0 logits max|diff| "
                      f"{host_err:.3e} -> {'ok' if ok else 'MISMATCH'}; K1 {want} a rank a step; "
                      f"rank 0 step ms (CUDA events) {[round(t, 3) for t in ms]}, host ms "
                      f"{[round(t, 3) for t in res[0]['host_ms']]}; set-up s "
                      f"{[round(r['setup_s'], 3) for r in res]}; bytes a step, all ranks: "
                      f"{per_step}; peak GiB per rank "
                      f"{[round(r['peak_bytes'] / 2**30, 3) for r in res]}")
                if not ok:
                    fail(f"path {label} {layout} {name}: disagrees with the single-process step")
                out[f"{layout}: {name}"] = {
                    "k1_per_rank_step": want, "step_ms": ms, "host_ms": res[0]["host_ms"],
                    "bytes_per_step": sum(per_step.values()),
                    "peak_gib": max(r["peak_bytes"] for r in res) / 2**30}
        t0 = time.perf_counter()
        try:
            report = dryrun_multichip(4, device="cuda", n=2048, d=128)
        except RuntimeError as e:
            fail(f"path {label}: dryrun_multichip on the card: {e}")
        print(f"  dryrun_multichip(4, device='cuda', n=2048, d=128): "
              f"{time.perf_counter() - t0:.1f} s; K1 launches a rank, no plain call: "
              f"{ {m: r['k1_per_rank'] for m, r in report.items() if isinstance(r, dict)} }")
        out["dryrun 4 ranks on cuda:0, gloo"] = {
            m: r["loss_rel"] for m, r in report.items() if isinstance(r, dict)}
        print(f"path {label}: {time.perf_counter() - t_path:.1f} s in all")
        return out

    # --- path O: the tuner on the card ------------------------------------
    from voltrix_spmm_tpu_torch.models.graph import auto_plan_config
    from voltrix_spmm_tpu_torch.tuner import AttentionTuner, SpmmTuner, Variant
    from voltrix_spmm_tpu_torch.utils import gpu_bench

    orng = np.random.default_rng(18)  # path O's own features and values
    tune_dir = os.path.join(ROOT, "build", "tune")  # a fresh cache: every run races
    path_o = {"races": {}, "launches": dict.fromkeys(count_keys, 0)}

    def race(label, tuner, a, x, **kw):
        """One race on the card: every candidate printed (ms, plan seconds,
        why it was skipped), its launches counted (plain calls must stay 0),
        each raced kernel launched, and no skip but a geometry refusal or
        out-of-memory."""
        reset_counts()
        t0 = time.perf_counter()
        tuned = tuner.compile_and_tune(a.indptr, a.indices, a.shape[0], x, device=dev, **kw)
        secs = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        print(f"  {label}: {len(tuned.candidates)} candidates in {secs:.1f} s (ms each, median of "
              f"8 CUDA-event launches after an L2 flush; plan build s):")
        for key, ms in tuned.candidates.items():
            err = tuned.errors.get(key)
            print(f"    {key}: {ms:.4f} ms, plan {tuned.plan_seconds.get(key, float('nan')):.3f} s"
                  + (f"; skipped: {err}" if err else ""))
        print(f"  winner {tuned.ordering}|{tuned.variant.key()} at {tuned.time_ms:.4f} ms; race "
              f"launches {({k: c for k, c in counts.items() if c})}, plain calls {plain_calls}")
        bad = {k: e for k, e in tuned.errors.items()
               if not e.startswith(("ValueError", "OutOfMemoryError"))}
        if bad or plain_calls:
            fail(f"path O {label}: candidates failed otherwise than by a refusal or "
                 f"out-of-memory {bad}, or plain versions ran ({plain_calls})")
        # in-process races launch each timed candidate's first kernel (K3 for
        # a hybrid); probes launch in their own processes
        raced = {tuned.variants[key][1].kernels()[0] for key, ms in tuned.candidates.items()
                 if ms != float("inf")}
        if any(counts.values()) and not all(counts[k] for k in raced):
            fail(f"path O {label}: a raced kernel never launched: {counts}")
        for k, c in counts.items():
            path_o["launches"][k] += c
        path_o["races"][label] = {"seconds": secs, "winner": f"{tuned.ordering}|"
                                  f"{tuned.variant.key()}", "winner_ms": tuned.time_ms,
                                  "candidates": dict(tuned.candidates),
                                  "plan_seconds": dict(tuned.plan_seconds),
                                  "errors": dict(tuned.errors)}
        return tuned, secs

    def check_winner(label, tuned, a, x, rows=None, values=None):
        """The winner's SpMM through TunedSpmm: its kernels' counters move, no
        plain version runs, and its rows (`rows`, default all) agree with a
        float64 host product within the float32 summation bound."""
        reset_counts()
        out = tuned(x)
        torch.cuda.synchronize()
        counts, plain_calls = read_counts()
        want_k = tuned.variant.kernels()
        if tuned.variant.bf16:  # its kernels' bf16 instantiations
            want_k = want_k + [f"{k}_bf16" for k in want_k]
        moved = {k: c for k, c in counts.items() if c}
        if plain_calls or not moved or set(moved) - set(want_k):
            fail(f"path O {label}: the winner launched {moved} (want {want_k}), plain "
                 f"{plain_calls}")
        a64 = a.astype(np.float64)
        if values is not None:
            a64 = sp.csr_matrix((values.astype(np.float64), a.indices, a.indptr), shape=a.shape)
        sel = slice(None) if rows is None else rows
        # a bf16 variant sums the rows rounded to bf16: the host product of those
        x64 = (x.to(torch.bfloat16) if tuned.variant.bf16 else x).double().cpu().numpy()
        want = torch.from_numpy(a64[sel] @ x64)
        abs_sum = torch.from_numpy(abs(a64[sel]) @ np.abs(x64))
        deg = torch.from_numpy(np.diff(a.indptr)[sel].astype(np.float64))[:, None]
        ok, err = sum_bound_ok(out.double().cpu()[sel], want, deg, abs_sum)
        print(f"  winner's output {tuple(out.shape)} against a float64 host product "
              f"({want.shape[0]} rows): max|diff| {err:.3e} within the float32 summation "
              f"bound -> {'ok' if ok else 'MISMATCH'}; launches {moved}")
        if not (ok and out.shape == (a.shape[0], x.shape[1])):
            fail(f"path O {label}: the tuned SpMM disagrees with the host product")
        return out

    def auto_beside(label, a, x, tuned):
        """build_graph(config="auto"): the config it picks, and its SpMM timed
        as the race times (gpu_bench) beside the race's winner."""
        n = a.shape[0]
        t0 = time.perf_counter()
        cfg = auto_plan_config(a.indptr, a.indices, n)
        g = build_graph(a.indptr, a.indices, n, "auto", symmetric=True, device=dev)
        secs = time.perf_counter() - t0
        plan = g.plan
        got = (plan[0] if isinstance(plan, list) else plan).config
        if got != cfg:
            fail(f"path O {label}: build_graph('auto') built {got}, auto_plan_config says {cfg}")
        ms = gpu_bench(lambda: spmm(plan, x), iters=8, warmup=2, device=dev)
        ratio = ms / tuned.time_ms
        print(f"  build_graph('auto') on {label}: {cfg}"
              f"{f' in {len(plan)} chunks' if isinstance(plan, list) else ''} ({secs:.2f} s); "
              f"spmm {ms:.4f} ms against the race's winner {tuned.variant.key()} "
              f"({tuned.ordering}) {tuned.time_ms:.4f} ms: {ratio:.3f}x")
        path_o.setdefault("auto", {})[label] = {"config": str(cfg), "ms": ms,
                                                "winner_ms": tuned.time_ms, "ratio": ratio}
        del g, plan
        torch.cuda.empty_cache()

    def tuner_path_a(a):
        """O.1 (the race on A's graph at d 128, its caches and the isolated
        probe) and O.3 on A."""
        import shutil

        t_path = time.perf_counter()
        shutil.rmtree(tune_dir, ignore_errors=True)
        n, d = a.shape[0], 128
        print(f"path O.1 (tuner, ogbn-arxiv proxy): tune_spmm at d {d}, default space, "
              f"orderings identity and rcm, budget_s 120, a fresh cache {tune_dir}")
        x = torch.from_numpy(orng.standard_normal((n, d)).astype(np.float32)).to(dev)
        kw = dict(reorderings=("identity", "rcm"), budget_s=120, hash_tag="ogbn-arxiv-proxy",
                  accurate=True)
        tuner = SpmmTuner(cache_dir=os.path.join(tune_dir, "a"))
        tuned, race_s = race("A d 128", tuner, a, x, **kw)
        k1_key = "identity|" + Variant("pregather", block_h=128).key()
        csr = csr_tensor(torch, a, dev)
        lib = gpu_bench(lambda: torch.sparse.mm(csr, x), iters=8, warmup=2, device=dev)
        print(f"  winner {tuned.time_ms:.4f} ms against K1 on PlanConfig(128, 128) "
              f"{tuned.candidates.get(k1_key, float('nan')):.4f} ms and torch.sparse.mm "
              f"{lib:.4f} ms (printed, never raced)")
        out = check_winner("A d 128", tuned, a, x)
        t0 = time.perf_counter()
        again = tuner.compile_and_tune(a.indptr, a.indices, n, x, device=dev, **kw)
        hit_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        fresh = SpmmTuner(cache_dir=os.path.join(tune_dir, "a")).compile_and_tune(
            a.indptr, a.indices, n, x, device=dev, **kw)
        disk_s = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        same = torch.equal(fresh(x), out)
        hit = fresh.variant == tuned.variant and fresh.ordering == tuned.ordering
        print(f"  second call: memory hit {again is tuned} in {hit_s * 1e3:.3f} ms; a new "
              f"SpmmTuner on the same directory: disk hit {hit} in {disk_s:.2f} s (the "
              f"winner's plan rebuilt), launches {sum(counts.values())} while it loaded "
              f"(times nothing), its output bit-identical {same}")
        if not (again is tuned and hit and not any(counts.values()) and not plain_calls
                and same):
            fail("path O.1: the memory or disk cache missed, or the disk hit timed candidates")
        # one variant in a probe of its own (three before R.6 joined the run:
        # each probe's process takes ~14 s of the 1,200 s)
        space1 = [Variant("pregather", block_h=128)]
        iso, iso_s = race("A d 128, 1 variant, isolate=True", SpmmTuner(
            cache_dir=os.path.join(tune_dir, "a_iso")), a, x, space=space1, isolate=True,
            hash_tag="ogbn-arxiv-proxy")
        for key, ms in iso.candidates.items():
            print(f"    {key}: probe {ms:.4f} ms, in-process race "
                  f"{tuned.candidates.get(key, float('nan')):.4f} ms")
        if not all(np.isfinite(list(iso.candidates.values()))):
            fail("path O.1: an isolated probe failed")
        check_winner("A d 128 isolated", iso, a, x)
        path_o.update(a_race_s=race_s, a_memory_hit_ms=hit_s * 1e3, a_disk_hit_s=disk_s,
                      a_isolated_s=iso_s, a_k1_ms=tuned.candidates.get(k1_key),
                      a_library_ms=lib)
        auto_beside("A", a, x, tuned)
        del tuned, again, fresh, iso, out, csr
        torch.cuda.empty_cache()
        print(f"path O.1: {time.perf_counter() - t_path:.1f} s in all")

    def tuner_path_f(a):
        """O.3 on F (the race at d 256 and build_graph('auto')) and the
        weighted race (K4 and K6) on F's graph with random edge values."""
        t_path = time.perf_counter()
        n, d = a.shape[0], 256
        print(f"path O.3 (tuner, ogbl-ddi proxy): tune_spmm at d {d}, default space, budget_s 60")
        x = torch.from_numpy(orng.standard_normal((n, d)).astype(np.float32)).to(dev)
        tuned, _ = race("F d 256", SpmmTuner(cache_dir=os.path.join(tune_dir, "f")), a, x,
                        budget_s=60, hash_tag="ogbl-ddi-proxy", accurate=True)
        check_winner("F d 256", tuned, a, x)
        auto_beside("F", a, x, tuned)
        vals = orng.standard_normal(a.nnz).astype(np.float32)
        print("path O.3 weighted: tune_spmm(values=...) on F's graph at d 256, the weighted "
              "default space (K6, and K4 where its plane stays within 8 slots an edge)")
        wt, _ = race("F weighted d 256", SpmmTuner(cache_dir=os.path.join(tune_dir, "fw")), a,
                     x, values=vals, budget_s=60, hash_tag="ogbl-ddi-proxy", accurate=True)
        check_winner("F weighted d 256", wt, a, x, values=vals)
        raced = {key.split("|")[1].split("/")[0] for key in wt.candidates}
        if raced != {"ell", "weighted"}:
            fail(f"path O.3: the weighted race raced {raced}, not K6 and K4")
        del tuned, wt
        torch.cuda.empty_cache()
        print(f"path O.3 on F: {time.perf_counter() - t_path:.1f} s in all")

    def tuner_path_mid(d=256):
        """O.3 between F and C: a graph of the protein and ogbl-ddi proxies'
        family (sp.random at 300 edges a row, symmetrized; tools/auto_sweep.py's
        graph) of AUTO_FUSED_MIN_NODES rows, the smallest on which
        build_graph('auto') takes K3, raced by auto_sweep's space (K3, K1
        h128, K2 h1024 and h2048 clustered) at d 256, with
        build_graph('auto') beside the winner."""
        from voltrix_spmm_tpu_torch.models.graph import AUTO_FUSED_MIN_NODES
        from voltrix_spmm_tpu_torch.tools.auto_sweep import sweep_space

        t_path = time.perf_counter()
        n = AUTO_FUSED_MIN_NODES
        a = symmetrize(erdos_renyi_csr(n, 300 / n, seed=n))
        label = f"uniform {n}"
        print(f"path O.3 (tuner, {label}: {a.nnz} nnz, AUTO_FUSED_MIN_NODES rows): tune_spmm "
              f"at d {d}, auto_sweep's space")
        x = torch.from_numpy(orng.standard_normal((n, d)).astype(np.float32)).to(dev)
        # in process: past 4 GiB of edge features the tuner would start a
        # probe a candidate, which O.1 and O.2 show
        tuned, _ = race(f"{label} d {d}", SpmmTuner(cache_dir=os.path.join(tune_dir, "mid")),
                        a, x, space=sweep_space(), hash_tag=f"uniform-{n}", isolate=False)
        check_winner(f"{label} d {d}", tuned, a, x)
        auto_beside(label, a, x, tuned)
        del tuned, x, a
        torch.cuda.empty_cache()
        print(f"path O.3 on {label}: {time.perf_counter() - t_path:.1f} s in all")

    def tuner_path_c(a):
        """O.2: the budgeted, isolated race on C's graph at d 256, then O.3
        on C."""
        t_path = time.perf_counter()
        n, d = a.shape[0], 256
        free, total = torch.cuda.mem_get_info()
        print(f"path O.2 (tuner, protein proxy): tune_spmm at d {d}, default space, budget_s "
              f"12; {a.nnz} nnz x {d} x 4 bytes = {a.nnz * d * 4 / 2**30:.1f} GiB of edge "
              f"features, past 4 GiB: residency budgeted (free {free / 2**30:.1f} of "
              f"{total / 2**30:.1f} GiB) and each candidate in a probe of its own")
        x = torch.from_numpy(orng.standard_normal((n, d)).astype(np.float32)).to(dev)
        # budget 12 s (120 before path R joined the run, 60 before R.6, 30
        # before S.5-S.9): the isolated probes of C's candidates take 9-17 s
        # each, and the run has 1,200 s
        tuned, race_s = race("C d 256", SpmmTuner(cache_dir=os.path.join(tune_dir, "c")), a, x,
                             budget_s=12, hash_tag="protein-proxy", accurate=True)
        print("  residency of the kept candidates (plan, workspace, features, output): "
              "tuner.estimate_residency beside the probe's torch.cuda.max_memory_allocated "
              "over the candidate's first call:")
        peaks = {}
        for key, b in tuned.residency.items():
            peak = tuned.peak_bytes.get(f"identity|{key}")
            peaks[key] = peak
            print(f"    {key}: estimate {b / 2**30:.3f} GiB, peak "
                  + (f"{peak / 2**30:.3f} GiB (estimate over peak {b / peak:.2f})" if peak
                     else "not measured (skipped by the budget)"))
        if not tuned.residency or not any(peaks.values()):
            fail("path O.2: the huge branch recorded no residency estimate or no probe peak")
        if any(v.stream_chunks for _, v in tuned.variants.values()):
            print("  window-chunked twins joined the space")
        last = (n - 1) // 2048 * 2048
        check_winner("C d 256", tuned, a, x, rows=np.r_[0:2048, last:n])
        path_o.update(c_race_s=race_s, c_residency=dict(tuned.residency), c_peak_bytes=peaks)
        auto_beside("C", a, x, tuned)
        del tuned
        torch.cuda.empty_cache()
        print(f"path O.2 and O.3 on C: {time.perf_counter() - t_path:.1f} s in all")

    def tuner_path_g(a, heads=8, dk=8):
        """O.4: tune_attention on G's graph and first layer (H 8 x d 8) in
        mode "train"; the winner's out and gradients against the plain
        versions at phase 3's K13-K15 tolerance."""
        t_path = time.perf_counter()
        n = a.shape[0]
        print(f"path O.4 (attention tuner, G's graph): tune_attention H {heads} x d {dk}, "
              "mode='train' (K13, K14, K15), default space, budget_s 60")
        tuner = AttentionTuner(cache_dir=os.path.join(tune_dir, "g"))
        reset_counts()
        t0 = time.perf_counter()
        tuned = tuner.compile_and_tune(a.indptr, a.indices, n, heads=heads, dk=dk, dv=dk,
                                       mode="train", budget_s=60, hash_tag="gat-loops",
                                       device=dev)
        secs = time.perf_counter() - t0
        counts, plain_calls = read_counts()
        for key, ms in tuned.candidates.items():
            err = tuned.errors.get(key)
            print(f"    {key}: {ms:.4f} ms, plan {tuned.plan_seconds.get(key, float('nan')):.3f} s"
                  + (f"; skipped: {err}" if err else ""))
        print(f"  winner {tuned.variant.key()} at {tuned.time_ms:.4f} ms ({secs:.1f} s); race "
              f"launches {({k: c for k, c in counts.items() if c})}, plain calls {plain_calls}")
        bad = {k: e for k, e in tuned.errors.items()
               if not e.startswith(("ValueError", "OutOfMemoryError"))}
        if bad or plain_calls or not all(counts[k] for k in ("attn_mh_fwd", "attn_mh_dq",
                                                              "attn_mh_dkv")):
            fail(f"path O.4: failures {bad}, plain calls {plain_calls} or launches {counts}")
        for k, c in counts.items():
            path_o["launches"][k] += c
        q, k, v = (torch.from_numpy(orng.standard_normal((heads, n, dk)).astype(np.float32)
                                    ).to(dev).requires_grad_(True) for _ in range(3))
        reset_counts()
        out = tuned(q, k, v)
        gk = torch.autograd.grad((out * out).sum(), (q, k, v))
        torch.cuda.synchronize()
        counts, plain_calls = read_counts()
        want_counts = {"attn_mh_fwd": 1, "attn_mh_dq": 1, "attn_mh_dkv": 1}
        if {k_: c for k_, c in counts.items() if c} != want_counts or plain_calls:
            fail(f"path O.4: the winner launched {counts} (want {want_counts}), plain "
                 f"{plain_calls}")
        ref = tuned(q, k, v, impl="reference")
        gp = torch.autograd.grad((ref * ref).sum(), (q, k, v))
        label = f"O.4 winner {tuned.variant.key()}"
        close("attn_mh_fwd", f"{label} out", out.detach(), ref.detach())
        close("attn_mh_dq", f"{label} dq", gk[0], gp[0])
        close("attn_mh_dkv", f"{label} dk", gk[1], gp[1])
        close("attn_mh_dkv", f"{label} dv", gk[2], gp[2])
        path_o["races"]["G attention H 8 x d 8 train"] = {
            "seconds": secs, "winner": tuned.variant.key(), "winner_ms": tuned.time_ms,
            "candidates": dict(tuned.candidates), "plan_seconds": dict(tuned.plan_seconds),
            "errors": dict(tuned.errors)}
        del tuned, out, ref, gk, gp, q, k, v
        torch.cuda.empty_cache()
        print(f"path O.4: {time.perf_counter() - t_path:.1f} s in all")

    def tuner_path_cli():
        """O.5: `python -m voltrix_spmm_tpu_torch tune` once, in a fresh
        process, on a generator graph."""
        t0 = time.perf_counter()
        # budget 8 s (30 before S.5-S.9 joined the run): the race is
        # budget-bound; the command, its orderings and its record are what
        # O.5 checks
        cmd = [sys.executable, "-m", "voltrix_spmm_tpu_torch", "tune", "rmat-15", "-d", "64",
               "--device", "cuda", "--budget", "8", "--reorder", "identity", "rcm"]
        env = dict(os.environ, VOLTRIX_TORCH_CACHE_DIR=os.path.join(tune_dir, "cli"))
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        secs = time.perf_counter() - t0
        try:
            rec = json.loads(r.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            rec = {}
        print(f"path O.5 (the tune command): {' '.join(cmd[1:])} -> rc {r.returncode} in "
              f"{secs:.1f} s: {rec or r.stderr[-500:]}")
        if r.returncode != 0 or not {"variant", "time_ms", "candidates"} <= set(rec):
            fail("path O.5: the tune command failed")
        path_o["cli"] = {**rec, "seconds": secs}

    def after_a(g, model, params_np, xs, logits, trained):
        deploy_path("N (ogbn-arxiv proxy, deployment: plan files, native preprocess, exported "
                    "programs and bundles served from fresh processes, K1, K2, K3)", arxiv, g,
                    params_np, xs, logits, trained)
        int8_path("I (ogbn-arxiv proxy, int8 SpMM, K8)", arxiv, g)
        streamed_path("J.1 (ogbn-arxiv proxy, streamed GCN, K1 on 4 window chunks)", arxiv, g,
                      model, params_np, xs, logits)
        hybrid_path("J.2 (ogbn-arxiv proxy, hybrid plan, K3 and K1)", arxiv, g)
        q_path_a("Q (ogbn-arxiv proxy, bf16 feature sources: K1, the hybrid's K3 and K1, the "
                 "GCN under agg_dtype=torch.bfloat16, the tuner's bf16 variants, the auto rule)",
                 arxiv, g, params_np)
        s_path_a("S (ogbn-arxiv proxy, float16 feature sources: K1, the hybrid's K3 and K1, the "
                 "GCN under agg_dtype=torch.float16, an exported float16 aggregate)",
                 arxiv, g, params_np)
        r_path_a("R (ogbn-arxiv proxy, bf16 on K4 and K8: DropEdge on bf16 rows, K4 on bf16 rows "
                 "and planes, the int8 SpMM on bf16 rows)", arxiv, g)
        r_path_a("S.5-S.7, S.9 (ogbn-arxiv proxy, float16 on K4 and K8: DropEdge on float16 "
                 "rows, K4 on float16 rows with each plane type, the int8 SpMM on float16 rows)",
                 arxiv, g, F16)

    t0 = time.perf_counter()
    arxiv = symmetrize(proxy_csr("ogbn-arxiv", seed=0))
    print(f"graph: ogbn-arxiv proxy in {time.perf_counter() - t0:.2f} s")
    results = {
        "spmm_block": serve("A (ogbn-arxiv proxy, K1)", arxiv, PlanConfig(128, 128),
                            "spmm_block", (128, 256, 40), train_gcn=True, then=after_a),
        "spmm_subtile": serve("B (ogbn-arxiv proxy clustered, K2)", arxiv,
                              PlanConfig(2048, 128, block_unroll=4, cluster_cols=True),
                              "spmm_subtile", (128, 256, 40),
                              then=lambda g, model, _, xs, logits, __: (
                                  q_path_gcn("B (path Q, K2's bf16 instantiation)", arxiv, g,
                                             model, xs, logits, "spmm_subtile", (128, 256)),
                                  s_path_gcn("B (path S, K2's float16 instantiation)", arxiv, g,
                                             model, xs, logits, "spmm_subtile", (128, 256)))),
    }
    part("A and B (A: N, I, J.1, J.2, Q, S, R.1-R.3, S.5-S.7; B: Q, S)")
    path_k = full_graph_models("K (ogbn-arxiv proxy, SAGE, GIN, APPNP, deep GCN, R-GCN on K1; "
                               "DropEdge on K4)", arxiv)
    part("K")
    path_l = sampled_sage_path("L (ogbn-arxiv proxy, neighbour-sampled GraphSAGE, K1)", arxiv)
    part("L")
    path_m = classify_path("M (GIN graph classification, 128 graphs, K1)")
    part("M")
    tuner_path_a(arxiv)
    part("O.1")
    torch.cuda.empty_cache()  # the ranks of path P share the card with this process
    path_p = parallel_path("P (ogbn-arxiv proxy, the parallel trainers on K1)", arxiv)
    part("P")
    # self-loops, the GAT convention (examples/train_gat.py:46-47)
    loops = ((arxiv + sp.eye(arxiv.shape[0], format="csr")) != 0).astype(np.float32).tocsr()
    loops.sort_indices()
    del arxiv
    results["spmm_weighted"], results["spmm_dvalues"] = gat_path(
        "D (ogbn-arxiv proxy with self-loops, GAT, K4 and K5)", loops, PlanConfig(64, 128),
        (128, 8, 40), heads=8)
    part("D")
    # examples/train_gat_dot.py:54's plan geometry
    path_e = gat_ell_path("E (ogbn-arxiv proxy with self-loops, dot-product GAT, K6 and K7)",
                          loops, PlanConfig(128, 128, block_unroll=4), (128, 8, 40), heads=8)
    q_path_ell("E (path Q, K6's bf16 instantiation)", loops)
    s_path_ell("E (path S, K6's float16 instantiation)", loops)
    part("E (Q and S on E)")
    # the same graph, geometry and widths as E (bench/bm_gat.py:174-177)
    results.update(gat_flash_path(
        "G (ogbn-arxiv proxy with self-loops, flash GAT, K13, K14 and K15)", loops,
        PlanConfig(128, 128, block_unroll=4), (128, 8, 40), heads=8))
    part("G")
    # the same graph, plan geometry and widths as G, on a bare plan
    results.update(flash_head_path(
        "H (ogbn-arxiv proxy with self-loops, per-head flash GAT, K9-K12)", loops,
        PlanConfig(128, 128, block_unroll=4), (128, 8, 40), heads=8))
    part("H")
    r_path_loops("R (ogbn-arxiv proxy with self-loops: K4 on D's plan, K13 and K9 at "
                 "compute_dtype=bfloat16 on G's and H's plan, and their backward, K10, K11, "
                 "K12, K14 and K15 under the flag)", loops)
    part("R on D, G, H (R.2, R.4-R.6)")
    r_path_loops("S.6, S.8, S.9 (ogbn-arxiv proxy with self-loops: K4 on D's plan on float16 "
                 "rows, K13 and K9 at compute_dtype=float16 on G's and H's plan)", loops, F16)
    part("S on D, G, H (S.6, S.8, S.9)")
    serve_models()  # path N's bundles of D, E, G, H and I, from fresh processes
    part("N's model bundles")
    tuner_path_g(loops)
    part("O.4")
    del loops
    t0 = time.perf_counter()
    ddi = symmetrize(proxy_csr("ddi", seed=0))
    print(f"graph: ogbl-ddi proxy in {time.perf_counter() - t0:.2f} s")
    path_f = linkpred_path("F (ogbl-ddi proxy, GCN link prediction, K1, K6 and K7)", ddi,
                           PlanConfig(128, 128), (256, 256, 256))
    part("F")
    tuner_path_f(ddi)
    part("O.3 on F")
    del ddi
    tuner_path_mid()
    part("O.3 mid")
    for name in ("spmm_ell", "spmm_ell_dvals"):
        # E's widths (8, 40) and F's (256) side by side
        per_width = {**path_e[name].pop("per_width"), **path_f[name].pop("per_width")}
        results[name] = {**path_e[name], **{f"f_{k}": v for k, v in path_f[name].items()},
                         **widths_summary(per_width)}
    results["spmm_block"].update(f_launches=path_f["spmm_block"]["launches"],
                                 f_train_launches=path_f["spmm_block"]["train_launches"],
                                 **{k: v for k, v in path_f["spmm_block"].items()
                                    if k.startswith("f_")})
    t0 = time.perf_counter()
    made_from, protein, made_to = protein_made.result()
    protein_pool.shutdown()
    n = protein.shape[0]
    print(f"graph: protein proxy in {made_to - made_from:.2f} s, made during the build "
          f"(waited {time.perf_counter() - t0:.2f} s for it here)")
    last = (n - 1) // 2048 * 2048
    results["spmm_fused"] = serve(
        "C (protein proxy, K3)", protein,
        PlanConfig(2048, 128, gather_segment=128, block_unroll=4), "spmm_fused",
        (8, 256, 112), host_rows=np.r_[0:2048, last:n],
        then=lambda g, model, _, xs, logits, __: (
            int8_on_c("C (protein proxy)", protein, g), c_plan_builds(protein),
            r_int8_on_c("C (protein proxy)", protein, g),
            r_int8_on_c("C (protein proxy)", protein, g, F16),
            q_path_gcn("C (path Q, K3's bf16 instantiation)", protein, g, model, xs, logits,
                       "spmm_fused", (8, 256)),
            s_path_gcn("C (path S, K3's float16 instantiation)", protein, g, model, xs, logits,
                       "spmm_fused", (8, 256), plain_iters=1)))
    part("C (I, R.3, S.7, Q and S on C)")
    tuner_path_c(protein)
    part("O.2")
    del protein
    tuner_path_cli()
    part("O.5")
    import shutil

    shutil.rmtree(tune_dir, ignore_errors=True)
    print(f"path O: {json.dumps(path_o)}")
    print(f"path Q: {json.dumps({k: v for k, v in path_q.items() if k not in bf16_of})}")
    print(f"path S: {json.dumps({k: v for k, v in path_s.items() if k not in f16_of})}")
    r_extra = {k: v for k, v in path_r.items() if k not in r_of}
    print(f"path R: {json.dumps({'seconds': sum(path_r_s), 'parts_s': path_r_s, **r_extra})}")
    results["spmm_int8"] = path_i
    results["spmm_block"].update(
        {k: v for k, v in path_j.items() if k.startswith("j_stream") or k.startswith("j_k1")})
    results["spmm_fused"].update(
        {k: v for k, v in path_j.items() if k.startswith("j_hybrid")})

    # paths K, L and M: K1's launches a request and a step on each model, K4's
    # a DropEdge training call and its backward; their times in ms
    results["spmm_block"]["klm"] = {
        **{f"k_{m}": {"request": r["launches_request"]["spmm_block"],
                      "step": r["launches_step"]["spmm_block"], "request_ms": r["request_ms"],
                      "step_ms": r["step_ms"]}
           for m, r in path_k.items() if m != "dropedge"},
        "k_dropedge_eval": {"request": 1, **{f"eval_ms_d{d}": v["eval_ms"]
                                             for d, v in path_k["dropedge"].items()}},
        "l_sage_minibatch": {"request": 2, "step": 3, **path_l},
        "m_gin_classifier": {"request": path_m["launches_request"]["spmm_block"],
                             "step": path_m["launches_step"]["spmm_block"],
                             "request_ms": path_m["request_ms"], "step_ms": path_m["step_ms"]},
    }
    # path N: the deployment path's numbers (seconds, bytes, ms, host us)
    results["spmm_block"]["n_deploy"] = path_n
    # path P: K1's launches per rank per step of each parallel mode and layout
    results["spmm_block"]["p_parallel"] = {
        k: v["k1_per_rank_step"] for k, v in path_p.items() if "k1_per_rank_step" in v}
    results["spmm_weighted"]["k_dropedge"] = {
        "train_call_and_backward": 2, **{f"train_ms_d{d}": v["train_ms"]
                                         for d, v in path_k["dropedge"].items()}}

    if "jax" in sys.modules or "voltrix_spmm_tpu" in sys.modules:
        fail("jax or the JAX package was imported")
    print(f"timing on {smi} (CUDA events; kernels mean of 20 launches after 3 warm-up, "
          "plain versions of 3 after 1, library calls of 10 after 2; in turns plain, kernel, "
          "kernel, plain); bounds at 3.35 TB/s and 67 TFLOP/s float32")
    print(f"seconds by part: {json.dumps(part_s)}")
    print(f"total {time.perf_counter() - t_start:.1f} s (nvcc {t_nvcc:.2f} s)")
    line = []
    for name, (_, _, source, replaces, _) in kernels.items():
        line.append({"name": name, "route": "cuda",
                     "source": f"voltrix_spmm_tpu_torch/csrc/{source}",
                     "replaces": replaces, "max_abs_err": max_err[name],
                     # a torch.library op (ops/library.py) that every call goes through
                     "registered": f"voltrix::{REGISTERED[name]}",
                     # path O: launches of the tuner's in-process races
                     "o_launches": path_o["launches"][name],
                     **results[name]})
    # the bf16 instantiations (path Q): the same sources and registered ops;
    # launches on path Q's drives (the GCN on A, B and C, the hybrid, the ELL
    # SpMM); times summed over the widths of path Q's Q.1, beside the float32
    # kernel's (f32_ms)
    for key, name in bf16_of.items():
        pw = path_q[key]["per_width"]
        widest = max(pw.values(), key=lambda v: v["bound_ms"])
        entry = {"name": key, "route": "cuda",
                 "source": f"voltrix_spmm_tpu_torch/csrc/{kernels[name][2]}",
                 "replaces": kernels[name][3], "max_abs_err": half_err[key],
                 "registered": f"voltrix::{REGISTERED[name]}",
                 "o_launches": path_o["launches"][key], "launches": path_q[key]["launches"],
                 "bound_by": widest["bound_by"]}
        for field in ("ms", "plain_ms", "library_ms", "bound_ms", "f32_ms"):
            entry[field] = sum(v[field] for v in pw.values())
            entry.update({f"{field}_{w}": v[field] for w, v in pw.items()})
        line.append(entry)
    # the float16 instantiations (path S): the same sources and registered
    # ops (K9's and K13's at compute_dtype=float16 their own source);
    # launches on path S's drives (the GCN on A, B and C, the hybrid, the ELL
    # SpMM, the exported aggregate; S.5-S.9); times summed over the widths of
    # S.3 and S.6-S.8, beside the float32 kernel's (f32_ms) and the bf16
    # one's (bf16_ms)
    for key, name in f16_of.items():
        pw = path_s[key]["per_width"]
        widest = max(pw.values(), key=lambda v: v["bound_ms"])
        entry = {"name": key, "route": "cuda",
                 "source": f"voltrix_spmm_tpu_torch/csrc/{half_source.get(key, kernels[name][2])}",
                 "replaces": kernels[name][3], "max_abs_err": max(max_err[key], half_err[key]),
                 "registered": f"voltrix::{REGISTERED[name]}",
                 "o_launches": path_o["launches"][key], "launches": path_s[key]["launches"],
                 "bound_by": widest["bound_by"]}
        for field in ("ms", "plain_ms", "library_ms", "bound_ms", "f32_ms", "bf16_ms"):
            vals = [v[field] for v in pw.values()]
            entry[field] = None if None in vals else sum(vals)
            entry.update({f"{field}_{w}": v[field] for w, v in pw.items()})
        line.append(entry)
    # path R: K4's bf16 instantiations, K8 on bf16 rows' codes, K9 and K13 at
    # compute_dtype=bfloat16 (their own source); launches on path R's drives;
    # times summed over R's widths, beside the float32 kernel's (f32_ms)
    for key, name in r_of.items():
        pw = path_r[key]["per_width"]
        widest = max(pw.values(), key=lambda v: v["bound_ms"])
        entry = {"name": key, "route": "cuda",
                 "source": f"voltrix_spmm_tpu_torch/csrc/{half_source.get(key, kernels[name][2])}",
                 "replaces": kernels[name][3], "max_abs_err": max(max_err[key], r_err[key]),
                 "registered": f"voltrix::{REGISTERED[name]}",
                 "o_launches": path_o["launches"][key], "launches": path_r[key]["launches"],
                 "bound_by": widest["bound_by"]}
        for field in ("ms", "plain_ms", "library_ms", "bound_ms", "f32_ms"):
            vals = [v[field] for v in pw.values()]
            entry[field] = None if None in vals else sum(vals)
            entry.update({f"{field}_{w}": v[field] for w, v in pw.items()})
        line.append(entry)
    # ms / plain_ms / library_ms / bound_ms: one call at each of the paths' widths, summed
    # (K6 and K7: E's d 8 and 40 and F's d 256; K13-K15: G's two layers, H 8 x d 8 and
    # H 1 x d 40; K9-K12: path H's, one head of d 8 and d 40); f_*: path F's counts and
    # times
    print(json.dumps({"kernels": line}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


def serve_bundles(spec_path: str) -> None:
    """Path N's serving process (`chip_smoke.py --serve-bundles SPEC`): it
    imports torch and voltrix_spmm_tpu_torch.serve only, loads each bundle
    of SPEC with load_bundle, moves its plan to the card, with "warm"
    calls aot_compile (its warm call), answers REQUESTS requests (features
    from the entry's files, or SPEC's), and checks that each kernel of the
    entry's "launches" launched that many times a request from the loaded
    program (its count, and its "kernels" among torch.profiler's kernel
    names) and that the plan's tensors are among the program's constants
    (plan.npz's, or the ELL plan beside the bundle). It writes the logits
    beside SPEC and prints one JSON line of times in seconds and the logits'
    files."""
    t0 = time.perf_counter()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from voltrix_spmm_tpu_torch.serve import aot_compile, load_bundle
    t_import = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    with open(spec_path) as f:
        spec = json.load(f)
    work = os.path.dirname(spec_path)
    out = []
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.empty(1, device=dev)
    t_context = time.perf_counter() - t0
    for entry in spec["bundles"]:
        tag = entry["name"] + ("_aot" if entry["warm"] else "")
        rec = {"tag": tag}
        t0 = time.perf_counter()
        bundle = load_bundle(entry["path"])
        rec["load_s"] = time.perf_counter() - t0
        # the kernels' counts, from the modules the loaded program's ops live in
        counted = {k: getattr(sys.modules[f"voltrix_spmm_tpu_torch.ops.{m}"], w)
                   for k, (m, w, _) in KERNEL_OPS.items()}
        t0 = time.perf_counter()
        plan = None if bundle.plan is None else bundle.plan.to(dev)
        torch.cuda.synchronize()
        rec["move_s"] = time.perf_counter() - t0
        xs = [torch.load(p).to(dev) for p in entry.get("xs", spec.get("xs"))]
        torch.cuda.synchronize()
        if entry["warm"]:
            t0 = time.perf_counter()
            aot_compile(bundle.fn, xs[0])
            rec["aot_s"] = time.perf_counter() - t0
        for w in counted.values():
            w.launches = 0
        t0 = time.perf_counter()
        ys = [bundle(xs[0])]
        torch.cuda.synchronize()
        rec["first_request_s"] = time.perf_counter() - t0
        rec["cold_start_s"] = sum(rec[k] for k in ("load_s", "move_s", "aot_s", "first_request_s")
                                  if k in rec)
        ys += [bundle(x) for x in xs[1:]]
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in counted.items() if w.launches}
        want = {k: n * len(xs) for k, n in entry["launches"].items()}
        if launches != want:
            fail(f"bundle {tag}: launches {launches}, want {want}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bundle(xs[0])
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA})
        kernels = [k for k in entry["kernels"] if any(k in nm for nm in names)]
        if kernels != list(entry["kernels"]):
            fail(f"bundle {tag}: the profiler saw kernels {names}")
        consts = [v for v in vars(bundle.fn).values() if isinstance(v, torch.Tensor)]
        held, fields = "no plan in the bundle", ()
        if plan is not None:
            fields, what = ("bitmask", "hind", "window_of_block"), "plan.npz's"
        elif "ell_plan" in entry:
            from voltrix_spmm_tpu_torch.format.ell import EllPlan

            plan = EllPlan.load(entry["ell_plan"]).to(dev)
            fields, what = ("hind", "erow", "window_of_block"), "the ELL plan's"
        if fields:
            found = [f for f in fields if any(
                c.device == getattr(plan, f).device and c.shape == getattr(plan, f).shape
                and torch.equal(c, getattr(plan, f)) for c in consts)]
            if found != list(fields):
                fail(f"bundle {tag}: the program's constants hold {found} of the plan, not {fields}")
            held = f"{what} {', '.join(fields)} among the program's constants"
        rec["ys"] = []
        for i, y in enumerate(ys):
            rec["ys"].append(os.path.join(work, f"y_{tag}_{i}.pt"))
            torch.save(y.cpu(), rec["ys"][-1])
        print(f"bundle {tag}: load_bundle {rec['load_s']:.3f} s, plan to the card "
              f"{rec['move_s']:.3f} s" + (f", aot_compile {rec['aot_s']:.3f} s" if entry["warm"]
                                           else "") +
              f", first request {rec['first_request_s']:.4f} s: cold start "
              f"{rec['cold_start_s']:.3f} s; launches {launches}; profiler kernels {kernels}; "
              f"{held}")
        out.append(rec)
        del bundle, plan
    print(f"import of torch and voltrix_spmm_tpu_torch.serve {t_import:.3f} s, the CUDA "
          f"context {t_context:.3f} s (before the first bundle)")
    if "jax" in sys.modules or "voltrix_spmm_tpu" in sys.modules:
        fail("the serving process imported jax or the JAX package")
    print(json.dumps({"import_s": t_import, "context_s": t_context, "bundles": out}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-bundles":
        serve_bundles(sys.argv[2])
    else:
        main()
