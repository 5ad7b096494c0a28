#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # the full run, needs one CUDA card
    python3 chip_smoke.py --scale 12 --kernel-n 4096   # a short run
    python3 chip_smoke.py --cpu-rehearsal # the same path on the CPU with the
                                          # kernels' plain versions; tiny
                                          # sizes, never prints a result

Phases, in run order (one JSON line each, then the card line, the
kernels line and the final result line):

1. the card (``nvidia-smi`` name and power limit) and the parallel build of
   all six kernel libraries from the sources in
   ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source, together);
   ``cuobjdump -sass`` of K4's library: its bf16 instances must hold
   HGMMA (wgmma) instructions and its f32 instances none;
2. each graph kernel against its plain PyTorch version on the card, on the
   ``scale_free`` family with 4 cells: K1 (``edge_relax_blocks``, the
   per-destination tables) for every min/max builtin, bitwise, and on a
   synthetic stream of hub runs over whole tiles, tombstone-split runs and
   an unsorted tail (one key in several runs of a tile), five launches
   bitwise; K2 (``edge_relax_scan``) for the push_share
   emit, bitwise, and bitwise run to run, and in its pre-emitted input
   mode, and in both modes for every builtin's (emit form, monoid, dtype,
   payload) instance with 4 and 5 lanes, bitwise, and on a synthetic
   stream whose hub runs span 3 and 4 whole tiles, solo and with 1 and 16
   lanes, bitwise in both modes and over five repeated launches; K3
   (``edge_relax_push_blocks``) for every min/max builtin at three
   frontiers (one vertex, 1 %, all vertices), bitwise on its raw outputs and
   after phase 2 (``ref.combine_blocks``);
2c. the generic instances (a program's own emit, payload and monoid op,
   traced by ``emitgen.py``; every library they need built in parallel
   first, the seconds printed) on the same session: K1 and K3 (three
   frontiers) for the min/max programs, K2 solo, with 4 and 5 lanes and
   in its pre-emitted mode for every program: every builtin stripped of
   its KernelEmit, the quickstart's reliability, an int32 sum with a
   custom op, an emit that reads dst_gid through where, a min-class
   monoid with a custom identity, and the programs beyond the first op
   set (transcendental ops, rounding and division, integer ops with
   saturating float-to-int casts, bfloat16 and float16 messages under min
   with a payload and under sum, a bfloat16 field, a 13-word record),
   each bitwise its plain version;
2b. K4 (``flash_attention``) against its plain version: bf16 and f32, head
   dims 64 and 128, causal or not, softcap 0 and 30, GQA groups 1 and 8,
   sq == skv and sq < skv (64 cases, tolerance at ``k4_err``: f32 2e-5,
   bf16 2^-7 |want| + 2^-8 A + 2e-5 with A the plain version on |v|);
4h. K4's gradient: ``ops.attention(q, k, v).backward(dout)`` (K4 forward,
   the reference's chunked backward in plain PyTorch) against autograd
   through ``ref.flash_attention_ref`` on the same tensors: f32 and bf16,
   D 64 and 128, causal or not, softcap 0 and 30, GQA groups 1 and 8, S
   512 and 1024 (one and two backward chunks), and tinyllama's training
   shape at B = 1 (q [1, 32, 4096, 64], k/v 4 heads, bf16, causal); dq, dk
   and dv within ``k4_grad_err`` (f32: 2e-5 (1 + max |grad|); bf16: 2^-7
   |want| + 2^-8 B + that, B what rounding the recomputed out to bf16
   moves through delta), one K4 launch a case (the forward only);
3. the graph main path at a real size: ``DiffusionSession.from_edges`` on
   the Graph500 RMAT graph (default scale 20, edge factor 16) over 4
   cells, then ``query`` for sssp (2 sources), bfs, cc, ppr and pagerank,
   with the kernels' launch counters zeroed just before and read just
   after, and the results checked against scipy on the host;
3b. the push and auto sweeps on the same session: sssp, bfs and cc, each
   bitwise equal to phase 3's pull results (values, parents, rounds, local
   iterations, actions), with K3 launched;
3d. multi-query lanes on the same session (``query(..., sources=[...])``,
   16 roots drawn from ``--seed`` among vertices of nonzero degree, phase
   3's sources first): sssp with parents x16 on pull, push and auto, bfs
   x16, widest with parents x4, ppr x8 on pull and push, and sssp x4 gated
   at ``delta`` = the median edge weight; counters zeroed just before and
   read just after (K2's laned variants launched, K1/K3 not); every lane
   bitwise equal to the same root queried solo, push/auto lanes to pull,
   and a later solo query of a root served from the cache;
3e. hub replicas: a second session on the same edges with
   ``replica_threshold=16384`` (211 hubs split at scale 20): sssp with
   parents, bfs and cc under pull, push and auto bitwise phase 3's unsplit
   results (parents tight over logical ids), pagerank (rtol 1e-5, atol
   1e-6) and ppr (atol 3 eps) against them, 16-lane sssp with phase 3d's
   roots bitwise solo, and one commit around the heaviest hub (16 edge
   adds, a deleted out-edge of it and a deleted vertex) with every repair
   bitwise a fresh diffusion (ppr: n * eps L1); K1, K2 and K3 launched;
3g. the watchdog on phase 3's graph: sssp with ``max_rounds=1`` raises
   ``ConvergenceError`` under ``on_budget="raise"``, warns under
   ``"warn"``, is silent under ``"partial"``; ``validate=True`` passes on
   phase 3's cached results;
3j. the SPMD engine (``engine="spmd"``, one compute cell per rank):
   a world of one on NCCL (``launch.mesh.cells_group(1)``) on a one-cell
   session of phase 3's edges (one cell of about 32 M slots): sssp with
   parents, bfs, cc and widest with parents on pull and push bitwise
   ``engine="sharded"`` on the same session (values, state, every
   DiffuseStats counter), ppr and pagerank within ``n * eps`` L1, 4 sssp
   lanes bitwise their solo queries, and a commit (3c's first kind) with
   spmd sssp, cc and ppr cached: ppr restarts on spmd, the warm repairs
   run on the logical engine, each bitwise a fresh spmd diffusion; the
   counters zeroed just before and read just after (K1, K2 sum and
   laned, K3 launched); then K1, K2 (4 lanes) and K3 at the per-rank
   shapes on phase 3's 4-cell session, each cell's slice ``[c:c+1]``
   bitwise rows ``[c]`` of the logical tables; then four ``gloo`` ranks
   on the one card (``torch.multiprocessing``, graph500 at
   ``--spmd-scale`` 16 over 4 cells, the edges handed over as a ``.npy``
   under the output directory): sssp and cc on pull and auto bitwise the
   parent's logical engine (values, state, the counters both count
   alike).  gloo stages CUDA tensors through the host, so the ranks'
   walls are no exchange speed;
3k. the analysis layer on phase 3's session: a warm sssp pull query
   under ``sanitize(transfers="log")`` (the card's synchronizing calls
   counted, within rounds + local_iters + 1 + ``SSSP_QUERY_SYNCS``; no
   kernel cache rebuilt), a warm 4-lane query with other roots (no
   rebuild), a cold generic program inside ``sanitize()`` (raises
   ``RetraceError``: its libraries build), ``.item()`` under
   ``"disallow"`` (raises), and ``python -m repro_torch.analysis.lint
   src/repro_torch/core src/repro_torch/kernels`` (exits 0);
3l. the diffusion dry-run (``repro_torch.launch.dryrun_diffusion``, each
   run in its own process): rank 0 of a fake process group of 256 ranks
   (pull and push) and of 512 ranks (pull) runs the SPMD engine's
   per-rank function for two rounds on its own cell of the production
   shape at RMAT ``--dry-scale`` 26 (262,144 vertices and 8,388,608 edge
   slots at 256 cells, 131,072 and 4,194,304 at 512; ``n_keys``
   67,108,864): the rank's argument, output and peak bytes and the
   collectives of a round and of the run, by op, count and bytes (the
   values are not read: fake collectives carry no other rank's data);
   then the same rank's cells built in this process, K1 (and K3 on the
   push streams at 256 cells, 1 % of the vertices sending) bitwise their
   plain versions there;
3h. the generic instances on the main path: sssp (with parents), cc and
   ppr stripped of their KernelEmit through pull, push and auto, bitwise
   phase 3's builtin answers (values, state, rounds, local iterations,
   actions), 16-lane stripped sssp bitwise phase 3d's lanes, and the
   quickstart's reliability on a session of the same edges at weights
   ``clip(w / w.max(), 0.05, 1)``: push and auto bitwise pull, 8 lanes
   bitwise solo, a commit's repair bitwise a fresh query; on the same
   session the log-space most reliable path (min-sum over ``-log(w')``):
   the same checks and its pull within rel 1e-5 of scipy's Dijkstra on
   ``-log(w')``; then sssp over bfloat16 messages with its parent payload
   on phase 2's scale_free graph: the card's pull bitwise the same query
   on the CPU, push bitwise pull, 4 lanes bitwise solo; counters zeroed
   just before and read just after (generic K1, K2, K3 launched, by each
   of reliability, the log-space path and the bfloat16 sssp; the fixed K1
   and K3 not);
3f. ``query("triangles")`` on graph500 scale 14 (n = 16384, the bitset's
   ceiling) on the card equal to ``triangle_count_exact`` on the host, and
   recounted after a commit; ``engine="event"`` (the host oracle) on
   ``scale_free`` 512: sssp within atol 1e-4 of the pull result, cc and
   widest bitwise through the generic interpreter, Dijkstra-Scholten
   terminated and never early.  (The oracle's cap is n = 4096, but its
   LIFO delivery on ``scale_free`` takes more actions an edge the larger
   the graph, each one Python-dispatched: the cap does not fit the smoke
   run's time limit.)
4a. K1 and K2 timed at the main path's shapes against their plain
   versions, their bounds and one PyTorch library call each, with the
   device kernels one call runs (from a profiler trace); K1 also with
   what its tables replaced timed beside it: phase 2 alone
   (``ref.combine_blocks`` over the plain partials) and the dense-rank
   block body over every block (K3's kernel) followed by phase 2, held
   bitwise against K1;
4f. K2's laned payload instance at phase 3d's sssp shape (16 lanes) held
   against its plain version and timed beside its bound and
   ``scatter_reduce_`` amin over the same messages;
4g. each generic instance at its fixed row's shape (4a, 4f, 4b), on the
   builtin stripped of its KernelEmit: bitwise the fixed instance, then
   timed in turns with it (the kernels line's ``/generic`` rows); and
   four programs beyond the first op set, each bitwise its plain version
   and timed: K1 with the log-space emit and with a 13-word record at
   4a's sssp shape, K2 with bfloat16 messages under sum and with the
   13-word record at 4a's pagerank shape;
4c. K6 (``relax_sorted``) through its entry point ``relax`` on cell 0 of the
   session's destination-sorted stream with phase 3's sssp distances and a
   50 % random active set: launches counted, bitwise against its plain
   version and ``scatter_reduce_``, timed; and bitwise on a synthetic
   stream of 1,000,003 edges with hub runs over many tiles;
3c. the commit path at full width: with sssp, bfs, cc and ppr cached, and
   four more sssp entries from one laned query, three commits (256 edge
   adds; 256 edge deletes, 32 of them SSSP tree edges; 16 vertex adds with
   4 edges each, 8 vertex deletes and 16 touches), each repair held against
   a fresh diffusion of the committed graph, and scipy's Dijkstra after the
   last;
4b. K3 timed at the shape of the first repair sub-iteration and at a full
   frontier, beside the frontier selector (``active_push_blocks`` and the
   compaction) at the same shapes;
3i. durability on phase 3's session with 3c's cache (the directories under
   ``durable/`` in the output directory, removed at the end; the run fails
   unless the disk has 4 x the snapshot's reckoned bytes free): a staged
   batch of 3c's kind (256 edge adds, 256 deletes) compacted by the merge
   (``_merge_compact``) bitwise the full sort (``with_csr()``, the path
   commits take), both timed (3 repeats), and the same on graph500 graphs
   of scales 6-18 (sorted widths on both sides of the reference's merge
   switch at 4096; at scale 16 also a batch adding 5 % of the edges);
   3c's per-commit apply/repair seconds; ``save()``, two journaled commits,
   ``DiffusionSession.open`` on the card (launch counters zeroed just
   before: the replay's K3 launches) bitwise the live session (every graph
   array, partition, NameServer, cache keys, each entry's state and
   stats), then sssp, bfs, cc and ppr recomputed there bitwise the live
   answers (K1 and K2 launched); a third commit killed at
   ``commit.applied`` and a ``save()`` killed at ``checkpoint.pre-rename``,
   each reopened bitwise the uninterrupted session; ``DurableSessionLoop``
   (``snapshot_every=2``, 6 one-batch steps, preempted at the 4th) stops
   after 4 steps with a final snapshot that opens bitwise the live
   session;
4d. K5 (``segment_sum_sorted``) through its entry point ``segment_sum`` on
   one GNN aggregation layer (values [E, 128] over the edges of
   ``scale_free`` 262,144): launches counted, against ``index_add_``;
   then the kernel on the presorted values and with the gather fused
   (``order``), each bitwise its plain version, five more launches bitwise
   the first, timed beside both (``k5_row``);
5. the LM serving path at full width: ``DecodeServer`` (4 slots, max_len
   2048) on tinyllama-1.1b in bf16 with seeded random weights admits 4
   prompts of 1024 tokens and takes 32 greedy decode steps, every launch
   counter zeroed just before and read just after (K4: 22 launches per
   admitted prompt); prefill and decode tokens/s, ms per decode step and
   its byte bound;
5b. the f32 model at full width on one prompt: prefill logits on K4 against
   the plain attention, decode logits at position p against a prefill over
   p + 1 tokens;
4e. K4 at the prefill shape (q [1, 32, 1024, 64], k/v [1, 4, 1024, 64]
   bf16, causal): held against its plain version there (its error is the
   one in the kernels line), then timed against the plain version, its
   bound and ``scaled_dot_product_attention``, with both TFLOP/s;
5c. MoE serving at full width: phi3.5-moe-42b-a6.6b at its published
   widths in bf16, cut from 32 to 24 layers (the 32 layers' weights and a
   KV cache do not fit 80 GB), seeded weights, the card's free memory
   checked before loading; ``DecodeServer`` (4 slots, max_len 2048)
   admits 4 prompts of 1024 tokens and takes 32 greedy steps, the
   counters zeroed just before and read just after (K4: 24 launches per
   prompt); prefill tokens/s, ms per decode step and its byte bound (the
   weights of the experts the step's tokens route to, beside the capacity
   path's all-experts floor), the peak memory and the rows each prefill's
   capacity dropped (read from the timed prefill's own routing);
5d. the float32 MoE LMs at published widths on 2 layers each,
   phi3.5-moe and then grok-1, freed between: prefill logits on K4
   against the plain attention, decode logits at p = 127 (where no row can
   be dropped) against a prefill over p + 1, and phi3.5 with the int8 KV
   cache (prefill -> ``kv_quantize`` -> ``decode_step``) within 5 % of the
   unquantized decode's largest logit and the same argmax; then grok-1's
   2 layers in bf16, whose prefill runs K4's bf16 softcap instance (the
   grok-1 K4 row's launches);
4e (MoE). K4 at both MoE prefill shapes (q [1, 32, 1024, 128] and
   [1, 48, 1024, 128] with softcap 30, k/v 8 heads, bf16, causal) held and
   timed as above; the library call of the softcapped shape is
   ``flex_attention`` (SDPA has no softcap; its uncapped time is printed
   beside it);
5e. training the dense LM: first one f32 train step of tinyllama-1.1b at
   its widths cut to 2 layers on one 1024-token sequence, on K4 and the
   chunked backward against the plain attention (loss 1e-4, grad norm
   1e-4 relative, every updated parameter 1e-6); then at full width
   (after ``free_card`` and a check of the free memory): tinyllama-1.1b
   in bf16, 22 layers, seeded weights, ``launch.steps.build_cell(
   "tinyllama-1.1b", "train_4k", batch=8)`` (adafactor 1e-3, clip 1.0,
   n_micro 1, remat on) and ``train_loop`` on ``TokenPipeline(8, 4096,
   32000, seed=--seed)`` through a ``Prefetcher``: 6 steps with
   ``ckpt_every=3`` into ``chiprun_out/train``, then a second
   ``train_loop`` to 8 steps resumes at step 6 with the parameters and
   optimizer state bitwise the live ones after step 5, and runs steps 6-7
   only; 3 snapshots of the live bytes (about 2.25 GB each) on disk,
   removed at the end; every loss and grad norm finite, K4 launched 44
   times a step (the forward and the remat recompute), the loss on step
   0's batch reported before, after step 0 and at step 6 (the resume
   does not fast-forward the stream); step seconds and their median,
   tokens/s, peak memory, model FLOPs a step (6 N T + 6 L B S^2 Hq D) and
   their share of 989 TFLOP/s; with ``--profile`` one step traced (busy
   share, K4, the ``repro_torch.attention_bwd`` and
   ``repro_torch.train.*`` ranges);
4e (train). K4 at the training shape (q [8, 32, 4096, 64], k/v 4 heads,
   bf16, causal; its launches the training run's) held and timed as
   above, and the attention backward at that shape (the chunked f32
   recompute and two-pass backward) timed beside
   ``scaled_dot_product_attention``'s backward and the flash backward's
   bound (five causal products at 989 TFLOP/s); not in the kernels line:
   the reference computes it in XLA, not in a Pallas kernel;
5f. GNN training on the card (``phase_gnn``): the four GNNs at their cells'
   full widths through ``launch.steps.build_cell``, ``launch.train``'s
   batches (``data_for`` / ``gnn_batch``, ``on_device``) and
   ``train_loop`` (adamw 1e-3), 4 steps each on one fixed batch: gatedgcn
   on full_graph_sm (``data_for``'s seeded graph of 2,708 nodes and 10,556
   edges, padded to 3,072 / 10,752 with masks) and on minibatch_lg (one
   ``sample_blocks`` block, 1,024 seeds, fanout (15, 10), of a seeded
   graph of Reddit's 232,965 nodes and 114,615,892 edges, its CSR made by
   ``models.sampler.build_csr`` on the host while the other runs train),
   meshgraphnet on that block, mace on molecule (``data_for``'s 128
   graphs of 30 atoms and 64 edges, float32) and on the block (bfloat16,
   16 channel groups), equiformer-v2 on molecule (12 layers, l_max 6) and
   on full_graph_sm (remat).  Every loss and grad norm finite, K5 launched
   every step (counted a step), median step seconds and peak bytes a run;
   then ``launch.train.main`` for equiformer-v2 on molecule, 3 steps, its
   logged losses and grad norms finite; then each architecture at 2 layers
   in float32: the forward pass and the loss twice at the same weights,
   bitwise equal; 3 steps on K5, run twice (whether they repeat bitwise is
   reported), against the same 3 steps on the plain segment sum
   (``index_add``), losses within 2e-5 relative; then K5 at gatedgcn
   minibatch_lg's aggregation ([168,960, 70] f32 into 169,985 segments)
   through ``k5_row`` (its kernels-line row; launches: the 7 runs' and
   the launcher's K5 launches), and the models' ``segment_sum`` helper
   there (with its own sort, with a shared one, the sort alone) beside its
   plain version; then ``k5_row`` at three more shapes the runs gave K5
   (``k5_shapes`` books K5's own launch count by shape, and each run's
   book adds up to its per-step counts): meshgraphnet on the block
   (F = 128 f32), mace on the block (F = 640 bf16) and the graph pool with
   the fewest
   segments (F = 1; mace's one-graph pool of the block), each with its
   launches at that shape.
5g. two-tower retrieval at its published widths (``phase_recsys``: two
   2,000,000 x 256 float32 tables, tower MLPs 1024-512-256, seeded
   weights) through ``launch.steps.build_cell`` and ``launch.train``'s
   ``RecsysPipeline`` batches, K5's launches booked by shape (the bags'
   forward reads a table, the tables' gradient the bags') over the main
   path:
   train_batch (65,536 x 8 fields x 16 slots, adamw 1e-3) 4 steps, step 0
   cold (s a step, examples/s, peak bytes, 4 K5 launches a step; a plain
   step along step 0's gradient lowers the loss on its batch, adamw's
   first step's effect reported); serve_p99 (200 calls of 512
   rows, median and p99 ms) and serve_bulk (262,144 rows, ms a call and
   rows/s); retrieval_cand (one query against 1,000,448 candidates,
   top-100: ms beside the candidates' bytes over 3.35 TB/s, the indices
   equal a host ranking of the same scores); ``launch.train.main`` 3 steps
   (its ~12.3 GB snapshot removed after); then 3 float32 steps at B 8,192
   on K5 against the same on the plain bag (losses within 1e-4
   relative), and K5 at train_batch's bag shape, forward and table
   gradient, each bitwise its plain version and timed beside
   ``F.embedding_bag(mode="sum")`` and its backward (two kernels-line
   rows; launches: the main path's at that shape);
5h. command-r-plus-104b at its published widths (d_model 12,288, 96 query
   heads on 8 KV heads, d_ff 33,792, vocab 256,000, LayerNorm, the
   parallel block, logit_scale 0.0625, tied embeddings) in bf16, cut to
   20 of 64 layers, served as phase 5 serves tinyllama (4 x 1024-token
   prompts, 32 decode steps; the step's bound its weights read once);
   then float32 on 2 layers: prefill logits on K4 against the plain
   attention, decode at p = 127 against a prefill over p + 1 (1e-3); then
   K4 at its prefill shape (q [1, 96, 1024, 128], k/v 8 heads, bf16,
   causal) held and timed beside SDPA (its kernels-line row).
5i. the sharded LM (``phase_sharded``: ``dist/`` on DTensor, K4 on each
   rank's local heads): a world of one on NCCL, mesh (1, 1), where
   tinyllama-1.1b's bf16 train step on 2 x 4096 tokens (full depth) and
   phi3.5-moe's bf16 prefill and 4 decode steps (2 layers, the MoE plan)
   are bitwise the unsharded path's; then four gloo ranks on the card,
   mesh (2, 2): tinyllama-1.1b f32 on 2 layers, one step on 4 x 1024
   tokens within 2e-5 (loss) and 1e-5 (params) of the world of one, K4
   at the rank's local shape held against its plain version,
   phi3.5-moe f32 on 2 layers with the world of one's kept rows and
   logits within 2e-5; the pipeline of 22 bf16 layers in 2 stages bitwise
   the sequential stages; ``compressed_psum_mean`` on the step's
   gradients; ``ElasticScaler`` restoring the four-rank snapshot onto 2
   ranks bitwise.  Two K4 rows (the rank's shape, the world of one's
   step), at most 150 s.
5j. the sharded GNN and two-tower families and the model dry-run
   (``phase_sharded_models``): four gloo ranks on the card, mesh (2, 2):
   mace and equiformer-v2 on molecule (f32, ``spmd_edges``, 16 channel
   groups, the batch laid out by receiver block), gatedgcn on
   full_graph_sm and the two-tower model at B 8,192 (tables split by rows)
   one adamw step each against the unsharded step: loss within 2e-5,
   gradients within 1e-4, parameters within 3e-6 where |g| >= 1e-4 (2 lr
   below: adamw's first update divides by |g| + 1e-8); K5 launched, its
   first launch bitwise its plain version on the rank's inputs.  Then
   ``repro_torch.launch.dryrun`` on one rank of 256 (dry group) in
   subprocesses: mace x ogb_products and equiformer-v2 x minibatch_lg
   (while the ranks run), grok-1-314b and command-r-plus-104b (64 layers)
   x train_4k: bytes, FLOPs, collectives, or the rank's out-of-memory
   error (a finding; any other failure fails the phase).  K5 and K4 held
   against their plain versions on those ranks' kept inputs; three
   kernels-line rows at the ranks' shapes.

With ``--profile``, each trace also gives K1's, K2's, K4's and K5's
device time and their share of the busy and the wall time (K5's level
kernels start early and wait: its time counts their overlap once, beside
the sum of its calls' spans from first kernel start to last kernel end), and the device time under
the engine's ``repro_torch.*`` ranges (relax, outbox_merge, receive,
counters, poll, exchange, the phase-2 combines).

With ``--cpu-rehearsal`` the same phases run on the CPU on the kernels'
plain versions at tiny sizes (the serving phases, 4h, 5e-5j on the smoke
configs and shapes).
Any failed check raises, so the script exits nonzero and prints no result.
Without a CUDA device it exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# float32 throughput outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12       # dense tensor cores

MINMAX_CASES = [
    ("sssp", {"source": 0, "track_parents": True}),
    ("sssp", {"source": 0, "track_parents": False}),
    ("bfs", {"source": 0}),
    ("cc", {}),
    ("widest", {"source": 0, "track_parents": False}),
    ("widest", {"source": 0, "track_parents": True}),
    ("reach", {"sources": (0, 1)}),
]


_T0 = [time.perf_counter()]          # the run's start (main resets it)


def emit(obj) -> None:
    """Print one JSON line, and append it to ``chip_smoke.jsonl`` under
    OUT_DIR, the run's whole record where only the end of the printed
    output is kept; a phase's line carries the run's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0[0]}
    line = json.dumps(obj)
    print(line, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.jsonl", "a") as f:
        f.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Clock:
    """Device time per call: CUDA events on the card, the host clock on
    the CPU rehearsal.  On the card the device first spins for longer than
    the host takes to queue all ``reps`` calls, so the events time the
    calls back to back even where one call's host work (checks, tensor
    maps, the launch) outlasts its kernel."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            # one call's wall time bounds its host time; 2e9 cycles a second
            # bounds the card's clock from above
            hold_s = min(1.5 * reps * (time.perf_counter() - t) + 1e-3, 3.0)
            torch.cuda._sleep(int(hold_s * 2e9))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / reps
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# --------------------------------------------------------------------------
# per-kernel inputs and comparisons
# --------------------------------------------------------------------------

def stream_inputs(sess, prog, vstate, senders):
    """The arguments the engine hands K1/K2 for one sweep of every cell
    (the streams of ``diffuse.sweep_streams``), and the structural key."""
    from repro_torch.core.diffuse import sweep_streams

    sgd, delta_e = sweep_streams(sess.sg)
    check(delta_e == 0, "a fresh graph carries no staged edges")
    return sgd["csr_skey"], (prog, vstate, senders, sgd["gid"],
                             sgd["csr_key"], sgd["csr_src"],
                             sgd["csr_weight"], sgd["csr_dst_gid"])


def hold_k1(args, n_keys: int, tag: str, repeats: int = 1) -> float:
    """K1's tables against its plain version on the same inputs (the
    blocked partials and ``ref.combine_blocks``): bitwise, for each of
    ``repeats`` launches (their atomics land in any order)."""
    from repro_torch.kernels.edge_relax import kernel, ref

    prog = args[0]
    runs = [kernel.edge_relax_blocks(*args, n_keys) for _ in range(repeats)]
    want = ref.combine_blocks(
        *ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E), n_keys,
        prog.combine)
    sync(args[2].device)
    for got in runs:
        for g, w, what in zip(got, want, ("table", "cnt", "pay")):
            check((g is None) == (w is None), f"K1 {tag}: {what} output")
            check(w is None or torch.equal(g, w),
                  f"K1 {tag}: {what} differs from the plain version or "
                  f"from another launch")
    fin = torch.isfinite(want[0].float())
    return float((runs[0][0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def compare_k1(sess, prog, vstate, senders):
    """K1 on the session's streams against its plain version: bitwise."""
    _, args = stream_inputs(sess, prog, vstate, senders)
    return hold_k1(args, sess.sg.n_shards * sess.sg.n_per_shard, prog.name)


def hold_k2(args, skey, tag: str) -> float:
    """K2 on ``args`` against its plain version (bitwise, every output)
    and against a second launch."""
    from repro_torch.kernels.edge_relax import kernel, ref

    runs = [kernel.edge_relax_scan(*args, skey=skey) for _ in range(2)]
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    sync(args[2].device)
    for g1, g2, w, what in zip(*runs, want, ("value", "count", "payload")):
        check((g1 is None) == (w is None), f"K2 {tag}: {what} output")
        if w is None:
            continue
        check(torch.equal(g1, g2), f"K2 {tag}: {what} scan is not "
                                   f"deterministic run to run")
        check(torch.equal(g1, w), f"K2 {tag}: {what} scan differs from the "
                                  f"plain version")
    fin = torch.isfinite(want[0].float())
    return float((runs[0][0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def compare_k2(sess, prog, vstate, senders):
    """K2 against its plain version (bitwise) and against itself."""
    skey, args = stream_inputs(sess, prog, vstate, senders)
    return hold_k2(args, skey, prog.name)


def push_inputs(sess, prog, vstate, senders, cap=None):
    """The compaction and the arguments the push sweep hands K3 for this
    frontier, at ``cap`` or (None) the ladder rung the engine would
    pick."""
    from repro_torch.core.diffuse import sweep_streams
    from repro_torch.core.relax import (
        active_push_blocks,
        push_caps,
        select_bucket,
    )
    from repro_torch.kernels.edge_relax import kernel, ref

    sgd, _ = sweep_streams(sess.sg, with_push=True)
    be = kernel.BLOCK_E
    nb = sgd["push_src"].shape[-1] // be
    if cap is None:
        count = int(active_push_blocks(senders, sgd["push_src"], be).max())
        cap = push_caps(nb)[select_bucket(count, nb, "push")]
    idx, valid = ref.compact_push_blocks(senders, sgd["push_src"], be, cap)
    args = (prog, vstate, senders, sgd["gid"], sgd["push_key"],
            sgd["push_src"], sgd["push_weight"], sgd["push_dst_gid"], idx)
    return sgd, idx, valid, args


def hold_k3(args, valid, n_keys: int, tag: str,
            block_e: int | None = None) -> dict:
    """K3 on ``args`` (its compaction ``idx`` last, ``valid`` its live
    slots) against its plain version: bitwise on the raw outputs (fill
    slots included) and after phase 2."""
    from repro_torch.kernels.edge_relax import kernel, ops, ref

    block_e = block_e or kernel.BLOCK_E
    got = kernel.edge_relax_push_blocks(*args, block_e)
    want = ref.edge_relax_push_blocks_ref(*args, block_e=block_e)
    sync(args[2].device)
    err = 0.0
    for g, w, what in zip(got, want, ("part", "cnt", "uniq", "pay")):
        if w is None:
            check(g is None, f"K3 {tag}: unexpected {what}")
            continue
        check(torch.equal(g, w), f"K3 {tag}: raw {what} differs from "
                                 f"the plain version")
        fin = torch.isfinite(w.float())
        if fin.any():
            err = max(err, float((g.float() - w.float())[fin].abs().max()))
    combine = args[0].combine
    tg = ref.combine_blocks(*ops._mask_fill_blocks(*got, valid), n_keys,
                            combine)
    tw = ref.combine_blocks(*ops._mask_fill_blocks(*want, valid), n_keys,
                            combine)
    sync(args[2].device)
    for g, w in zip(tg, tw):
        check((g is None and w is None) or torch.equal(g, w),
              f"K3 {tag}: phase-2 tables differ from the plain version")
    return {"cap": int(args[-1].shape[-1]), "fill_slots": int((~valid).sum()),
            "max_abs_err": err}


def compare_k3(sess, prog, vstate, senders, cap=None):
    """K3 against its plain version on the same inputs: bitwise on the raw
    outputs (fill slots included) and after phase 2."""
    _, idx, valid, args = push_inputs(sess, prog, vstate, senders, cap)
    return hold_k3(args, valid, sess.sg.n_shards * sess.sg.n_per_shard,
                   prog.name)


def compare_k2_pre(sess, prog, vstate, senders):
    """K2's pre-emitted mode against ``ref.stream_scan``: bitwise."""
    from repro_torch.kernels.edge_relax import kernel, ref

    skey, args = stream_inputs(sess, prog, vstate, senders)
    cand, send, _ = ref.edge_messages(*args)
    v1, c1, _ = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey)
    vr, cr, _ = ref.stream_scan(prog.monoid, cand, send, skey)
    sync(senders.device)
    check(torch.equal(v1, vr) and torch.equal(c1, cr),
          "K2 pre-emitted mode differs from the plain scan")
    return float((v1 - vr).abs().max())


def random_lane_state(prog, shape, seed: int, device):
    """A random vertex state of the program's schema and a 50 % sending
    frontier, both of ``shape`` ([S, L, Np]): distances with unreached
    (+-inf) entries, small residuals, degrees 1-8, payload-range ints."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda: torch.rand(shape, generator=g)
    out = {}
    for k, f in prog.fields:
        if k in ("dist", "width"):
            v = torch.where(rand() < 0.2, float("inf"), rand() * 40)
            if k == "width":
                v = torch.where(rand() < 0.2, float("-inf"), v)
        elif k in ("rank", "residual"):
            v = rand() * 1e-3
        elif k == "deg":
            v = torch.randint(1, 9, shape, generator=g).float()
        elif k == "reached":
            v = (rand() < 0.5).int()
        elif k == "rel":
            v = torch.where(rand() < 0.2, 0.0, rand())
        elif k in ("pending", "hops", "q"):
            v = torch.randint(0, 1200, shape, generator=g, dtype=torch.int32)
        elif k in ("d16", "h16"):           # 16-bit distances
            v = torch.where(rand() < 0.2, float("inf"), rand() * 40)
        elif k in ("r16", "r16h"):          # 16-bit residuals
            v = rand() * 1e-2
        elif k == "x" or k.startswith("w"):  # positive, finite
            v = 0.01 + rand() * 10
        else:
            v = torch.randint(-1, 1 << 16, shape, generator=g,
                              dtype=torch.int32)
        out[k] = v.to(f.dtype).to(device)
    return out, (rand() < 0.5).to(device)


def compare_k2_lanes(sess, base, lanes: int, seed: int, device, tag: str):
    """K2 in both input modes on lane-stacked inputs ([S, lanes, Np]
    state against the shared stream) against its plain versions, and the
    two modes against each other: bitwise on (value, count, payload)."""
    from repro_torch.core.programs import make_laned
    from repro_torch.kernels.edge_relax import kernel, ref

    prog = make_laned([base] * lanes)
    S, Np = sess.sg.node_ok.shape
    vstate, senders = random_lane_state(prog, (S, lanes, Np), seed, device)
    senders &= sess.sg.node_ok[:, None]
    skey, args = stream_inputs(sess, prog, vstate, senders)
    got = kernel.edge_relax_scan(*args, skey=skey)
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    cand, send, pay = ref.edge_messages(*args)
    pre = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey, pay)
    pre_want = ref.stream_scan(prog.monoid, cand, send, skey, pay)
    sync(device)
    tag = f"K2 {tag} lanes={lanes}"
    check((want[2] is None) == (not prog.with_payload),
          f"{tag}: payload output")
    for g, w, pg, pw, what in zip(got, want, pre, pre_want, "vcp"):
        if w is None:
            continue
        check(torch.equal(g, w), f"{tag}: {what} differs from the plain "
                                 f"version (emit mode)")
        check(torch.equal(pg, pw), f"{tag}: {what} differs from the plain "
                                   f"scan (pre-emitted mode)")
        check(torch.equal(g, pg), f"{tag}: the two modes differ on {what}")
    fin = torch.isfinite(want[0].float())
    return float((got[0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def hub_stream(cells: int, width: int, np_: int, seed: int, device):
    """A synthetic destination-sorted stream [cells, width]: per cell a
    hub run of 3.5 tiles from position 0, short runs, a hub of 4 tiles
    that opens mid-tile, then short runs (K2's look-back walks over the
    hubs' whole tiles); a tenth of the positions tombstoned (``key`` -1,
    ``skey`` keeps the run).  Returns key, skey, src, weight, gid."""
    from repro_torch.kernels.edge_relax import ref

    rng = np.random.default_rng(seed)
    tile = ref.SCAN_TILE
    skey, key = [], []
    for c in range(cells):
        lengths = [3 * tile + tile // 2]
        lengths += rng.integers(1, 40, 100 + c).tolist()
        lengths += [4 * tile + 3]
        lengths += rng.integers(1, 60, width).tolist()
        ids = np.repeat(np.arange(len(lengths)), lengths)[:width]
        ids = np.sort(rng.choice(cells * np_, ids[-1] + 1,
                                 replace=False))[ids]
        skey.append(ids)
        key.append(np.where(rng.random(width) < 0.1, -1, ids))
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    weight = torch.from_numpy(
        (1 + 7 * rng.random((cells, width))).astype(np.float32)).to(device)
    return (as_t(key), as_t(skey), as_t(rng.integers(0, np_, (cells, width))),
            weight, as_t(np.arange(cells * np_).reshape(cells, np_)))


def k1_hub_stream(cells: int, width: int, np_: int, seed: int, device):
    """:func:`hub_stream` (``width`` a multiple of 128) with its last 384
    positions an unsorted tail of 5 keys drawn from the stream, as a
    staged delta segment holds them: one key then closes several runs of
    a tile, besides the runs the tombstones split.  Returns key, src,
    weight, gid."""
    key, skey, src, weight, gid = hub_stream(cells, width, np_, seed, device)
    rng = np.random.default_rng(seed + 1)
    for c in range(cells):
        pick = rng.choice(skey[c, :width - 384].cpu().numpy(), 5)
        key[c, width - 384:] = torch.from_numpy(
            rng.choice(pick, 384).astype(np.int32)).to(device)
    return key, src, weight, gid


def compare_k1_hub(stream, name, kw, seed: int, device) -> float:
    """K1 on :func:`k1_hub_stream` against its plain version, five
    launches bitwise, with ``n_keys`` below the stream's largest keys (K1
    and the plain scatter drop them)."""
    from repro_torch.core.programs import PROGRAMS

    key, src, weight, gid = stream
    prog = PROGRAMS[name].factory(**kw)
    S, np_ = gid.shape
    vstate, senders = random_lane_state(prog, (S, np_), seed, device)
    args = (prog, vstate, senders, gid, key, src, weight, key)
    return hold_k1(args, S * np_ - 1000, f"hub stream {name} {kw}",
                   repeats=5)


def compare_k2_hub(stream, name, kw, lanes, seed: int, device) -> float:
    """K2 in both input modes on :func:`hub_stream`, solo (``lanes`` None)
    or laned: bitwise against the plain versions, and five launches of the
    emit mode bitwise equal (the tiles run in any order)."""
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.kernels.edge_relax import kernel, ref

    key, skey, src, weight, gid = stream
    prog = PROGRAMS[name].factory(**kw)
    if lanes:
        prog = make_laned([prog] * lanes)
    S, np_ = gid.shape
    shape = (S, np_) if lanes is None else (S, lanes, np_)
    vstate, senders = random_lane_state(prog, shape, seed, device)
    args = (prog, vstate, senders, gid, key, src, weight, key)
    runs = [kernel.edge_relax_scan(*args, skey=skey) for _ in range(5)]
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    cand, send, pay = ref.edge_messages(*args)
    pre = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey, pay)
    pre_want = ref.stream_scan(prog.monoid, cand, send, skey, pay)
    sync(device)
    tag = f"K2 hub stream {name} {kw} lanes={lanes}"
    for out in runs + [pre]:
        for g, w_, pw, what in zip(out, want, pre_want, "vcp"):
            check((g is None) == (w_ is None), f"{tag}: {what} output")
            if w_ is not None:
                check(torch.equal(g, w_) and torch.equal(w_, pw),
                      f"{tag}: {what} differs from the plain version or "
                      f"from another launch")
    fin = torch.isfinite(want[0].float())
    return float((runs[0][0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def random_senders(sess, seed: int, p: float = 0.5):
    rng = np.random.default_rng(seed)
    mask = rng.random(tuple(sess.sg.node_ok.shape)) < p
    return torch.from_numpy(mask).to(sess.device) & sess.sg.node_ok


def phase_kernels(sess, device) -> dict:
    """Phase 2: every kernel against its plain version."""
    from repro_torch.core.programs import PROGRAMS

    out = {"k1": {}, "k1_hub": {}, "k2": {}, "k2_pre": {}, "k3": {},
           "k2_lanes": {}}
    k1_hub = k1_hub_stream(4, 40 * 1024 + 3 * 128, 16384, 19, device)
    one = torch.zeros_like(sess.sg.node_ok)
    one[sess.ns.resolve(0)] = True
    frontiers = {"one": one, "1pct": None, "all": sess.sg.node_ok.clone()}
    for i, (name, kw) in enumerate(MINMAX_CASES):
        prog = PROGRAMS[name].factory(**kw)
        sess.query(name, **kw)
        vstate = sess.vertex_state(name, **kw)
        tag = f"{name}{'+pay' if prog.with_payload else ''}"
        out["k1"][tag] = compare_k1(sess, prog, vstate,
                                    random_senders(sess, i))
        out["k1_hub"][tag] = compare_k1_hub(k1_hub, name, kw, 400 + i,
                                            device)
        for f, senders in frontiers.items():
            if senders is None:
                senders = random_senders(sess, 100 + i, p=0.01)
            out["k3"][f"{tag}/{f}"] = compare_k3(sess, prog, vstate, senders)
    for name, kw in (("ppr", {"source": 0}), ("pagerank", {})):
        prog = PROGRAMS[name].factory(**kw)
        vstate, _ = prog.init(sess.sg)
        # a mid-run state: residuals spread over every vertex
        rng = np.random.default_rng(7)
        res = rng.random(tuple(vstate["residual"].shape)).astype(np.float32)
        vstate = dict(vstate, residual=torch.from_numpy(res * 1e-3).to(device))
        out["k2"][name] = compare_k2(sess, prog, vstate,
                                     random_senders(sess, 11))
        out["k2_pre"][name] = compare_k2_pre(sess, prog, vstate,
                                             random_senders(sess, 12, p=0.05))
    # every (emit form, monoid, dtype, payload) instance of the builtins,
    # with lanes equal to and different from the 4 cells; then on a stream
    # whose hub runs span whole tiles, solo and with 1 and 16 lanes
    out["k2_hub"] = {}
    hub = hub_stream(4, 40 * 1024 + 77, 16384, 17, device)
    for i, (name, kw) in enumerate(MINMAX_CASES + [("ppr", {"source": 0}),
                                                   ("pagerank", {})]):
        for lanes in (4, 5):
            out["k2_lanes"][f"{name}{kw}/L{lanes}"] = compare_k2_lanes(
                sess, PROGRAMS[name].factory(**kw), lanes, 200 + i, device,
                f"{name} {kw}")
        for lanes in (None, 1, 16):
            out["k2_hub"][f"{name}{kw}/L{lanes or 'solo'}"] = compare_k2_hub(
                hub, name, kw, lanes, 300 + i, device)
    return out


# --------------------------------------------------------------------------
# the generic instances: programs without a KernelEmit
# --------------------------------------------------------------------------

STRIPPED = MINMAX_CASES + [("ppr", {"source": 0}), ("pagerank", {})]
CAP = 1000


def stripped(name: str, kw: dict):
    """The builtin ``name`` lowered without its KernelEmit: the same
    functions on the kernels' generic instance."""
    import dataclasses

    from repro_torch.core import programs as P

    spec = dataclasses.replace(getattr(P, name).fn(**kw), kernel_emit=None)
    return P.lower(spec, name=f"{name}_generic")


def register_stripped(name: str) -> str:
    """Register ``<name>_generic``, the builtin without its KernelEmit, so
    the session runs it (same value key, repair and lanes)."""
    import dataclasses

    from repro_torch.core import programs as P

    gname = f"{name}_generic"
    if gname not in P.PROGRAMS:
        spec, fn = P.PROGRAMS[name], getattr(P, name).fn

        @functools.wraps(fn)                # the builtin's signature
        def factory(*a, **kw):
            return dataclasses.replace(fn(*a, **kw), kernel_emit=None)

        P.diffusive(gname, value_key=spec.value_key, repair=spec.repair,
                    monotone=spec.monotone, lane_param=spec.lane_param)(
            factory)
    return gname


def _capped(a, b):
    return torch.clamp_max(a + b, CAP)


def register_reliability() -> str:
    """The quickstart's user program (examples/quickstart.py): max-product
    path reliability over edge weights in (0, 1], written on torch with
    no KernelEmit."""
    from repro_torch.core import programs as P

    if "reliability" not in P.PROGRAMS:
        @P.diffusive("reliability", value_key="rel", monotone=True,
                     lane_param="source")
        def reliability(source: int) -> P.DiffusiveProgram:
            def receive(vstate, inbox, has_msg, payload, node_ok):
                better = has_msg & (inbox > vstate["rel"]) & node_ok
                return ({"rel": torch.where(better, inbox, vstate["rel"])},
                        better)

            return P.DiffusiveProgram(
                monoid="max", msg_dtype=torch.float32,
                state={"rel": P.Field(torch.float32,
                                      init=lambda v: torch.where(
                                          v.gid == source, 1.0, 0.0),
                                      on_dead=0.0)},
                init_active=lambda v: v.gid == source,
                emit=lambda s, weight, src_gid, dst_gid: s["rel"] * weight,
                receive=receive)
    return "reliability"


def _min_plus_spec(source: int, dtype, emit, payload=None):
    """A min-plus program over field ``d`` of ``dtype`` from ``source``
    (unreached at inf), the payload (if any) into field ``p``."""
    from repro_torch.core import programs as P

    def receive(s, inbox, has, pay, ok):
        better = has & (inbox < s["d"]) & ok
        out = {**s, "d": torch.where(better, inbox, s["d"])}
        if payload is not None:
            out["p"] = torch.where(better, pay, s["p"])
        return out, better

    state = {"d": P.Field(dtype, init=lambda v: torch.where(
        v.gid == source, 0.0, float("inf")).to(dtype),
        on_dead=float("inf"))}
    if payload is not None:
        state["p"] = P.Field(torch.int32, init=-1, on_dead=-1)
    return P.DiffusiveProgram(
        monoid="min", msg_dtype=dtype, state=state,
        init_active=lambda v: v.gid == source, emit=emit, payload=payload,
        receive=receive)


def register_logrel() -> str:
    """The most reliable path in log space: min-sum over -log(w) with
    weights success probabilities in (0, 1] (a transcendental emit on
    the generic kernels)."""
    from repro_torch.core import programs as P

    if "logrel" not in P.PROGRAMS:
        P.diffusive("logrel", value_key="d", monotone=True,
                    lane_param="source")(
            lambda source: _min_plus_spec(
                source, torch.float32,
                lambda s, w, sg, dg: s["d"] - torch.log(w)))
    return "logrel"


def register_bf16_sssp() -> str:
    """sssp with bfloat16 distances and messages and its parent payload."""
    from repro_torch.core import programs as P

    if "sssp_bf16" not in P.PROGRAMS:
        P.diffusive("sssp_bf16", value_key="d", monotone=True,
                    lane_param="source")(
            lambda source: _min_plus_spec(
                source, torch.bfloat16,
                lambda s, w, sg, dg: s["d"] + w.to(torch.bfloat16),
                payload=lambda s, sg: sg))
    return "sssp_bf16"


def user_programs() -> dict:
    """Programs written without a KernelEmit: the quickstart's
    reliability, an int32 sum with a custom op (min(a + b, CAP)), an emit
    that reads dst_gid through where (with a payload), and a min-class
    int32 monoid with a custom identity."""
    from repro_torch.core import programs as P
    from repro_torch.core.monoid import Monoid

    f32, i32 = torch.float32, torch.int32
    keep = _keep
    register_reliability()
    return {
        "reliability": P.PROGRAMS["reliability"].factory(source=0),
        "capsum": P.lower(P.DiffusiveProgram(
            monoid=Monoid("capsum", "sum", op=_capped), msg_dtype=i32,
            state={"pending": P.Field(i32)},
            emit=lambda s, w, sg, dg: s["pending"], receive=keep), "capsum"),
        "dst_where": P.lower(P.DiffusiveProgram(
            monoid="min", msg_dtype=f32, state={"dist": P.Field(f32)},
            emit=lambda s, w, sg, dg: torch.where(dg > sg, s["dist"] + w,
                                                  s["dist"] * 2.0 + 1.0),
            payload=lambda s, sg: sg, receive=keep), "dst_where"),
        "ident_min": P.lower(P.DiffusiveProgram(
            monoid=Monoid("min1000", "min", identity_of=lambda dt: CAP),
            msg_dtype=i32, state={"hops": P.Field(i32)},
            emit=lambda s, w, sg, dg: torch.clamp_max(s["hops"] + 1, CAP),
            receive=keep), "ident_min"),
    }


@contextlib.contextmanager
def unverified():
    """``lower`` without the verifier: it refuses a 16-bit sum, as the
    reference's does (its rounding is not associative on seeded
    samples), and the generic kernels compute it all the same."""
    import os

    old = os.environ.get("REPRO_VERIFY")
    os.environ["REPRO_VERIFY"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_VERIFY")
        else:
            os.environ["REPRO_VERIFY"] = old


def _keep(s, ib, h, p, ok):
    return s, h & ok


def lower_program(name, state, emit, msg=torch.float32, monoid="min",
                  payload=None):
    """``lower`` of a program that only emits (receive keeps the state)."""
    from repro_torch.core import programs as P

    return P.lower(P.DiffusiveProgram(
        monoid=monoid, msg_dtype=msg,
        state={k: P.Field(dt) for k, dt in state.items()}, emit=emit,
        payload=payload, receive=_keep), name)


def emit_programs() -> dict:
    """The programs beyond the generic kernels' first op set: every new op
    class (exp/exp2/log/log2/log10/log1p/expm1, the three pow forms,
    sin/cos/tanh/sigmoid, rsqrt/reciprocal; floor/ceil/round/trunc/sign
    and the division family; integer shifts, pow and division and the
    float predicates; float16 floor division, remainder and fmod),
    float-to-int casts (saturating: ``x * 1e9``),
    bfloat16 and float16 messages under min with a payload (the float16
    one cast from a 16-bit value, saturating at inf) and under sum, a bfloat16 field under a
    float32 message, and a record of 13 words after hoisting (12 fields
    picked by dst_gid, the payload)."""
    f32, i32 = torch.float32, torch.int32
    bf16, f16 = torch.bfloat16, torch.float16
    prog = lower_program

    def wide(s, w, sg, dg):
        out = w
        for k in range(12):
            out = out + torch.where(dg % 12 == k, s[f"w{k}"], 0.0)
        return out

    with unverified():
        sums = {
            "bf16_sum": prog("bf16_sum", {"r16": bf16, "deg": f32},
                             lambda s, w, sg, dg: (s["r16"] * 0.85) /
                             s["deg"].to(bf16), bf16, "sum"),
            "f16_sum": prog("f16_sum", {"r16h": f16},
                            lambda s, w, sg, dg: s["r16h"] * w.half(), f16,
                            "sum")}
    return {
        "transcendental": prog(
            "transcendental", {"dist": f32, "x": f32},
            lambda s, w, sg, dg: s["dist"] + torch.exp(-s["x"]) +
            torch.exp2(-w) + torch.log(w) + torch.log2(s["x"]) +
            torch.log10(w) + torch.log1p(s["x"]) + torch.expm1(-w) +
            w ** 2.5 + s["x"] ** 2 + torch.pow(s["x"], w * 0.1) +
            0.5 ** w + torch.sin(w) + torch.cos(s["x"]) + torch.tanh(w) +
            torch.sigmoid(-s["x"]) + torch.rsqrt(w) +
            torch.reciprocal(s["x"])),
        "rounding_division": prog(
            "rounding_division", {"x": f32},
            lambda s, w, sg, dg: s["x"] + torch.floor(w * 3) +
            torch.ceil(w) + torch.round(w * 2.5) + torch.trunc(w * 7) +
            torch.sign(w - 4.0) + w // 0.3 + w % 0.7 +
            torch.fmod(s["x"], w) + torch.div(s["x"], w, rounding_mode=
                                              "trunc") + s["x"] // w +
            torch.round(w, decimals=2),
            monoid="max", payload=lambda s, sg: sg),
        "integer_ops": prog(
            "integer_ops", {"q": i32, "x": f32},
            lambda s, w, sg, dg: s["q"] + ((w * 100).int() >> 2) +
            ((dg % 7) << 1) + (s["q"] // 7) % 5 + torch.fmod(s["q"], 11) +
            torch.div(s["q"], 3, rounding_mode="trunc") +
            torch.isfinite(w).int() + (s["q"] & 15) ** 2 +
            (s["x"] * 1e9).int() // 1000000 + (s["x"] * 1e9).long().int(),
            i32),
        "bf16_min_payload": prog(
            "bf16_min_payload", {"d16": bf16},
            lambda s, w, sg, dg: s["d16"] + w.to(bf16) * 1.5, bf16,
            payload=lambda s, sg: sg),
        "f16_min_payload": prog(
            "f16_min_payload", {"h16": f16},
            lambda s, w, sg, dg: s["h16"] + w.half() / 3 +
            (w.half() // 0.7) % 2.5 + torch.fmod(w.half(), 1.3), f16,
            payload=lambda s, sg: (s["h16"] * 100).int()),
        "bf16_field": prog(
            "bf16_field", {"d16": bf16},
            lambda s, w, sg, dg: s["d16"].float() + w),
        "wide_record": prog(
            "wide_record", {f"w{k}": f32 for k in range(12)}, wide,
            monoid="max", payload=lambda s, sg: sg),
        **sums,
    }


def build_generic(progs) -> float:
    """Compile every generic library the programs need (their own, and
    the pre-emitted combine of a custom monoid or of 16-bit messages) in
    parallel; seconds taken."""
    from repro_torch.kernels.edge_relax import emitgen, kernel

    trs = [p.kernel_gen for p in progs]
    trs += [emitgen.translate_monoid(p.monoid, p.msg_dtype) for p in progs
            if kernel._custom(p.monoid) or p.msg_dtype in (torch.bfloat16,
                                                          torch.float16)]
    t = time.perf_counter()
    if torch.cuda.is_available():
        kernel.build_generic(*trs)
    return time.perf_counter() - t


def generic_programs() -> list:
    """Every program whose generic libraries the run builds: phase 2c's,
    3h's and 4g's (a header does not depend on a query's source)."""
    from repro_torch.core.programs import PROGRAMS

    progs = [stripped(n, kw) for n, kw in STRIPPED]
    progs += [*user_programs().values(), *emit_programs().values(),
              *timing_programs(0)]
    progs += [PROGRAMS[register_stripped("cc")].factory()]
    progs += [PROGRAMS[n].factory(source=0) for n in (
        register_stripped("sssp"), register_stripped("ppr"),
        register_reliability(), register_logrel(), register_bf16_sssp())]
    return progs


def start_generic_build(device):
    """On the card: lower :func:`generic_programs` and compile their
    libraries on a host thread, while phase 2 (which needs none of them)
    runs; returns the future of the build's seconds, or None."""
    if device.type != "cuda":
        return None
    import concurrent.futures

    progs = generic_programs()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(build_generic, progs)
    pool.shutdown(wait=False)
    return fut


def phase_generic_kernels(sess, device, gen_build=None) -> dict:
    """Phase 2c: the generic instances against their plain versions,
    bitwise: K1 and K3 (three frontiers) for the min/max programs, K2
    solo, laned (4 and 5 lanes) and pre-emitted for every program: every
    builtin stripped of its KernelEmit, the user programs and the
    programs beyond the first op set (:func:`emit_programs`)."""
    from repro_torch.kernels.edge_relax import kernel

    progs = {f"{n}{kw}": stripped(n, kw) for n, kw in STRIPPED}
    progs.update(user_programs())
    progs.update(emit_programs())
    t = time.perf_counter()
    build_s = gen_build.result() if gen_build is not None else \
        build_generic(progs.values())
    out = {"build_s": build_s, "build_wait_s": time.perf_counter() - t,
           "k1": {}, "k3": {}, "k2": {}, "k2_pre": {}, "k2_lanes": {}}
    one = torch.zeros_like(sess.sg.node_ok)
    one[sess.ns.resolve(0)] = True
    kernel.reset_launches()
    for i, (tag, prog) in enumerate(progs.items()):
        S, Np = sess.sg.node_ok.shape
        vstate, _ = random_lane_state(prog, (S, Np), 500 + i, device)
        if prog.combine != "sum":
            out["k1"][tag] = compare_k1(sess, prog, vstate,
                                        random_senders(sess, 600 + i))
            for f, senders in (("one", one),
                               ("1pct", random_senders(sess, 700 + i, 0.01)),
                               ("all", sess.sg.node_ok.clone())):
                out["k3"][f"{tag}/{f}"] = compare_k3(sess, prog, vstate,
                                                     senders)
        out["k2"][tag] = compare_k2(sess, prog, vstate,
                                    random_senders(sess, 800 + i))
        out["k2_pre"][tag] = compare_k2_pre(
            sess, prog, vstate, random_senders(sess, 900 + i, p=0.05))
        for lanes in (4, 5):
            out["k2_lanes"][f"{tag}/L{lanes}"] = compare_k2_lanes(
                sess, prog, lanes, 1000 + i, device, tag)
    launches = {k: v for k, v in {**kernel.LAUNCHES,
                                  **kernel.SCAN_LAUNCHES}.items() if v}
    out["launches"] = launches
    if device.type == "cuda":
        for k in ("edge_relax_blocks/generic", "edge_relax_scan/generic",
                  "edge_relax_push_blocks/generic", "sum/generic",
                  "sum/laned/generic", "min/max+payload/laned/generic"):
            check(launches.get(k, 0) > 0, f"phase 2c launched no {k}")
        check(launches.get("edge_relax_blocks", 0) == 0
              and launches.get("edge_relax_push_blocks", 0) == 0,
              "phase 2c launched a fixed K1/K3 instance")
    return out


# --------------------------------------------------------------------------
# the main path and its checks against scipy
# --------------------------------------------------------------------------

def scipy_checks(src, dst, w, n, results, sources):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import (
        connected_components,
        dijkstra,
        shortest_path,
    )

    a = sp.csr_matrix((w.astype(np.float64), (src, dst)), shape=(n, n))
    report = {}
    for s in sources:
        got = results[("sssp", s)]
        dist = got.values
        t = time.perf_counter()
        ref = dijkstra(a, directed=True, indices=s)
        report[f"scipy_sssp_{s}_s"] = time.perf_counter() - t
        fin = np.isfinite(ref)
        check(np.array_equal(np.isfinite(dist), fin),
              f"sssp({s}): reachability differs from scipy")
        rel = np.abs(dist[fin] - ref[fin]) / np.maximum(ref[fin], 1.0)
        check(rel.max(initial=0.0) <= 1e-5,
              f"sssp({s}): rel error {rel.max()} > 1e-5")
        # every parent is an in-neighbour on a tight edge (in float32)
        par = got.extra["parent"]
        v = np.nonzero(fin & (np.arange(n) != s))[0]
        p = par[v]
        check((p >= 0).all(), f"sssp({s}): reached vertex without parent")
        keys = src.astype(np.int64) * n + dst
        order = np.argsort(keys)
        want = p.astype(np.int64) * n + v
        pos = np.searchsorted(keys[order], want)
        pos = np.minimum(pos, keys.shape[0] - 1)
        check(np.array_equal(keys[order][pos], want),
              f"sssp({s}): a parent is not an in-neighbour")
        wt = w[order][pos].astype(np.float32)
        check(np.array_equal(dist[p].astype(np.float32) + wt,
                             dist[v].astype(np.float32)),
              f"sssp({s}): dist[p] + w != dist[v] for some parent")
        report[f"sssp_{s}_max_rel_err"] = float(rel.max(initial=0.0))
        report[f"sssp_{s}_reached"] = int(fin.sum())
    s0 = sources[0]
    t = time.perf_counter()
    hops = shortest_path(a, method="D", unweighted=True, indices=s0)
    report["scipy_bfs_s"] = time.perf_counter() - t
    check(np.array_equal(results[("bfs", s0)].values.astype(np.float64),
                         hops), "bfs levels differ from scipy")
    t = time.perf_counter()
    _, labels = connected_components(a, directed=True, connection="weak")
    report["scipy_cc_s"] = time.perf_counter() - t
    mins = np.full(labels.max() + 1, n, np.int64)
    np.minimum.at(mins, labels, np.arange(n))
    check(np.array_equal(results[("cc",)].values, mins[labels]),
          "cc labels differ from the min gid of each scipy component")
    report["cc_components"] = int(labels.max() + 1)
    # pagerank: the push fixed point alpha * (I - (1-alpha) P^T)^-1 u with
    # P = D^-1 A, D = max(out-degree, 1) (dangling mass leaves), by float64
    # power iteration
    pr = results[("pagerank",)]
    rank = pr.values.astype(np.float64)
    check(np.isfinite(rank).all() and (rank >= 0).all(),
          "pagerank is not finite and non-negative")
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    pt = sp.csr_matrix((np.ones(src.shape[0]), (dst, src)), shape=(n, n))
    alpha, eps = 0.15, 1e-7
    u = np.full(n, 1.0 / n)
    x = alpha * u
    for _ in range(500):
        nxt = alpha * u + (1 - alpha) * (pt @ (x / deg))
        done = np.abs(nxt - x).sum() < 1e-13
        x = nxt
        if done:
            break
    l1 = float(np.abs(rank - x).sum())
    check(l1 <= n * eps, f"pagerank L1 {l1} > n*eps {n * eps}")
    report["pagerank_l1"] = l1
    report["pagerank_l1_limit"] = n * eps
    ppr = results[("ppr", s0)].values.astype(np.float64)
    check(np.isfinite(ppr).all() and (ppr >= 0).all() and ppr.sum() <= 1.0001,
          "ppr is not a finite non-negative sub-distribution")
    report["ppr_mass"] = float(ppr.sum())
    return report


def phase_main(args, device):
    """Phase 3: the user's front door on Graph500 RMAT at ``args.scale``."""
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family
    from repro_torch.kernels.edge_relax import kernel

    t = time.perf_counter()
    src, dst, w, n = make_graph_family("graph500", 1 << args.scale, seed=0)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    # free capacity for phase 3c's commits: >= 4096 edge and 64 vertex
    # slots (1 % of the edges and 0.01 % of the vertices at scale 20)
    edge_slack = max(0.01, 4096 / src.shape[0])
    node_slack = max(1e-4, 64 / n)
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       edge_slack=edge_slack,
                                       node_slack=node_slack, device=device)
    sync(device)
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(args.seed)
    deg = np.bincount(src, minlength=n)
    sources = [int(x) for x in rng.choice(np.nonzero(deg > 0)[0], 2,
                                          replace=False)]
    emit({"phase": "main_setup", "graph": "graph500", "scale": args.scale,
          "n": n, "edges": int(src.shape[0]), "cells": 4,
          "n_per_shard": sess.sg.n_per_shard,
          "edges_per_shard": sess.sg.edges_per_shard,
          "stream_width": int(sess.sg.csr_key.shape[-1]),
          "edge_slack": edge_slack, "node_slack": node_slack,
          "generate_s": gen_s, "partition_upload_s": build_s,
          "sources": sources})

    queries = ([("sssp", {"source": s}) for s in sources]
               + [("bfs", {"source": sources[0]}), ("cc", {}),
                  ("ppr", {"source": sources[0]}),
                  ("pagerank", {"eps": 1e-7})])
    results, rows = {}, []
    sync(device)
    kernel.reset_launches()
    for name, kw in queries:
        before = dict(kernel.LAUNCHES)
        sync(device)
        t = time.perf_counter()
        res = sess.query(name, refresh=True, **kw)
        sync(device)
        dt = time.perf_counter() - t
        st = res.stats
        key = (name,) + tuple(v for k, v in kw.items() if k == "source")
        results[key] = trim(res, n)
        rows.append({"query": name, **kw, "wall_s": dt,
                     "rounds": int(st.rounds),
                     "local_iters": int(st.local_iters),
                     "actions": int(st.actions),
                     "converged": bool(st.converged),
                     "k1_launches": kernel.LAUNCHES["edge_relax_blocks"]
                     - before["edge_relax_blocks"],
                     "k2_launches": kernel.LAUNCHES["edge_relax_scan"]
                     - before["edge_relax_scan"]})
    launches = dict(kernel.LAUNCHES)
    walls = {}
    for (name, kw), r in zip(queries, rows):
        walls[(name,) + tuple(kw.values())] = r["wall_s"]
    for r in rows:
        emit({"phase": "main_query", **r})
    emit({"phase": "main_launches", **launches})
    if device.type == "cuda":              # the pull sweep: K1 and K2
        for k in ("edge_relax_blocks", "edge_relax_scan"):
            check(launches[k] > 0, f"kernel {k} was not launched on the "
                                   f"main path")
    for r in rows:
        check(r["converged"], f"{r['query']} did not converge")
    report = scipy_checks(src, dst, w, n, results, sources)
    emit({"phase": "main_checks", "ok": True, **report})
    return sess, launches, sources, results, walls, (src, dst, w, n), queries


def trim(res, n: int):
    """A Result cut to the graph's first ``n`` ids (the rest are the free
    vertex slots reserved for commits)."""
    return type(res)(values=res.values[:n], stats=res.stats,
                     extra={k: v[:n] for k, v in res.extra.items()})


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def phase_push(sess, results, walls, sources, n, device) -> dict:
    """Phase 3b: the push and auto sweeps through ``query(sweep=...)``,
    each bitwise equal to phase 3's pull result."""
    from repro_torch.kernels.edge_relax import kernel

    s0 = sources[0]
    rows = []
    sync(device)
    kernel.reset_launches()
    for sweep in ("push", "auto"):
        for name, kw in (("sssp", {"source": s0}), ("bfs", {"source": s0}),
                         ("cc", {})):
            before = dict(kernel.LAUNCHES)
            sync(device)
            t = time.perf_counter()
            res = trim(sess.query(name, sweep=sweep, refresh=True, **kw), n)
            sync(device)
            dt = time.perf_counter() - t
            key = (name,) + tuple(kw.values())
            walls[(name, sweep) + tuple(kw.values())] = dt
            pull = results[key]
            what = f"{name} sweep={sweep}"
            check(same_bits(res.values, pull.values), f"{what}: values "
                  f"differ from the pull sweep")
            for k in pull.extra:
                check(same_bits(res.extra[k], pull.extra[k]),
                      f"{what}: {k} differs from the pull sweep")
            for f in ("rounds", "local_iters", "actions"):
                check(int(getattr(res.stats, f)) == int(getattr(pull.stats,
                                                                f)),
                      f"{what}: stats.{f} differs from the pull sweep")
            rows.append({"query": name, "sweep": sweep, **kw, "wall_s": dt,
                         "pull_wall_s": walls[key],
                         "rounds": int(res.stats.rounds),
                         "local_iters": int(res.stats.local_iters),
                         "push_iters": int(res.stats.push_iters),
                         "actions": int(res.stats.actions),
                         **{f"{k}_launches": kernel.LAUNCHES[k] - before[k]
                            for k in kernel.LAUNCHES}})
    launches = dict(kernel.LAUNCHES)
    for r in rows:
        emit({"phase": "push_query", **r})
    emit({"phase": "push_launches", **launches})
    if device.type == "cuda":
        check(launches["edge_relax_push_blocks"] > 0,
              "K3 was not launched by the push/auto queries")
    return launches


def lane_roots(src, n: int, sources, seed: int, count: int = 16) -> list:
    """``count`` query roots drawn from ``seed`` among the vertices of
    nonzero degree (as Graph500 draws its search keys), phase 3's sources
    first."""
    rng = np.random.default_rng(seed + 3)
    deg = np.bincount(src, minlength=n)
    pool = np.setdiff1d(np.nonzero(deg > 0)[0], sources)
    more = rng.choice(pool, count - len(sources), replace=False)
    return list(sources) + [int(x) for x in more]


def phase_lanes(sess, results, roots, data, device) -> dict:
    """Phase 3d: multi-query lanes through ``query(..., sources=[...])``
    on phase 3's session (launch counters zeroed just before, read just
    after), then every lane held against the same root queried solo."""
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    delta = float(np.median(w))
    # (program, kwargs, lanes, sweep, delta)
    queries = [("sssp", {}, 16, "pull", None), ("sssp", {}, 16, "push", None),
               ("sssp", {}, 16, "auto", None), ("bfs", {}, 16, "pull", None),
               ("widest", {"track_parents": True}, 4, "pull", None),
               ("ppr", {}, 8, "pull", None), ("ppr", {}, 8, "push", None),
               ("sssp", {}, 4, "pull", delta)]
    sync(device)
    kernel.reset_launches()
    lanes_out, rows = [], []
    for name, kw, lanes, sweep, dl in queries:
        before = {**kernel.LAUNCHES, **kernel.SCAN_LAUNCHES}
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = sess.query(name, sources=roots[:lanes], sweep=sweep, delta=dl,
                         refresh=True, **kw)
        sync(device)
        dt = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device.type == "cuda" else None)
        lanes_out.append([trim(r, n) for r in res])
        st = res[0].stats
        now = {**kernel.LAUNCHES, **kernel.SCAN_LAUNCHES}
        rows.append({"query": name, **kw, "lanes": lanes, "sweep": sweep,
                     "delta": dl, "wall_s": dt, "rounds": int(st.rounds),
                     "local_iters": int(st.local_iters),
                     "push_iters": int(st.push_iters),
                     "actions": int(st.actions),
                     "converged": bool(st.converged),
                     "peak_gib": peak,
                     "launches": {k: now[k] - before[k] for k in now
                                  if now[k] != before[k]}})
    launches = dict(kernel.LAUNCHES)
    scan = dict(kernel.SCAN_LAUNCHES)
    emit({"phase": "lanes_launches", **launches, "edge_relax_scan_variants":
          scan})
    for r in rows:
        check(r["converged"], f"laned {r['query']} did not converge")
    if device.type == "cuda":
        for k in ("sum/laned", "min/max/laned", "min/max+payload/laned"):
            check(scan[k] > 0, f"K2's {k} variant was not launched by the "
                               f"laned queries")
        check(launches["edge_relax_blocks"] == 0
              and launches["edge_relax_push_blocks"] == 0,
              "a laned query launched K1 or K3 (lanes take K2)")
    # a later solo query of a lane's root is a cache hit
    before = dict(kernel.LAUNCHES)
    hit = sess.query("sssp", source=roots[5])
    check(dict(kernel.LAUNCHES) == before
          and hit.stats is lanes_out[0][5].stats,
          "a solo query of a lane's root was not served from the cache")
    # every lane against the same root queried solo; sweeps against pull
    for (name, kw, lanes, sweep, dl), res, row in zip(queries, lanes_out,
                                                      rows):
        what = f"{name} x{lanes} sweep={sweep} delta={dl}"
        solo_s = 0.0
        for lane, root in zip(res, roots):
            sync(device)
            t = time.perf_counter()
            solo = trim(sess.query(name, source=root, sweep=sweep, delta=dl,
                                   refresh=True, **kw), n)
            sync(device)
            solo_s += time.perf_counter() - t
            check(same_bits(lane.values, solo.values)
                  and all(same_bits(lane.extra[k], solo.extra[k])
                          for k in solo.extra),
                  f"{what}: lane {root} differs from its solo query")
        row["solo_wall_s"] = solo_s
        pull = lanes_out[queries.index((name, kw, lanes, "pull", dl))] \
            if (name, kw, lanes, "pull", dl) in queries else None
        if pull is not None and sweep != "pull":
            for lane, p in zip(res, pull):
                check(same_bits(lane.values, p.values)
                      and all(same_bits(lane.extra[k], p.extra[k])
                              for k in p.extra),
                      f"{what}: lanes differ from the pull sweep")
            for f in ("rounds", "local_iters", "actions"):
                check(int(getattr(res[0].stats, f))
                      == int(getattr(pull[0].stats, f)),
                      f"{what}: stats.{f} differs from the pull sweep")
        emit({"phase": "lanes_query", **row})
    # phase 3's solo results (held against scipy) and the gated lanes'
    # distances are the pull lanes'
    for i, s in enumerate(roots[:2]):
        check(same_bits(lanes_out[0][i].values, results[("sssp", s)].values),
              f"sssp lane {s} differs from phase 3's query")
    for gated, pull in zip(lanes_out[-1], lanes_out[0]):
        check(same_bits(gated.values, pull.values),
              "gated sssp distances differ from the ungated lanes'")
    emit({"phase": "lanes_checks", "ok": True, "roots": roots,
          "delta": delta, "bitwise_vs_solo": True})
    return scan, lanes_out[0]


def phase_generic(args, sess, results, lanes16, roots, sources, data,
                  device) -> dict:
    """Phase 3h: the generic instances on the main path.  The builtins
    sssp (with parents), cc and ppr stripped of their KernelEmit, through
    pull, push and auto, bitwise the builtins' answers of phase 3 (values,
    state, rounds, local iterations, actions); 16-lane stripped sssp
    bitwise phase 3d's lanes; the quickstart's reliability on a session of
    the same edges at weights ``clip(w / w.max(), 0.05, 1)``: push and
    auto bitwise pull, 8 lanes bitwise their solo queries, and a commit's
    repair bitwise a fresh query.  Counters zeroed just before, read just
    after: the generic K1, K2 and K3 launched, the fixed K1 and K3 not."""
    from repro_torch.core import DiffusionSession
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    s0 = sources[0]
    names = {b: register_stripped(b) for b in ("sssp", "cc", "ppr")}
    rel = register_reliability()
    lr, b16 = register_logrel(), register_bf16_sssp()
    build_s = build_generic([
        PROGRAMS[names["sssp"]].factory(source=s0),
        PROGRAMS[names["cc"]].factory(),
        PROGRAMS[names["ppr"]].factory(source=s0),
        PROGRAMS[rel].factory(source=s0),
        PROGRAMS[lr].factory(source=s0), PROGRAMS[b16].factory(source=0)])
    emit({"phase": "generic_build", "seconds": build_s})
    sync(device)
    kernel.reset_launches()
    rows = []

    def run(s, name, **kw):
        sync(device)
        t = time.perf_counter()
        res = s.query(name, refresh=True, **kw)
        sync(device)
        return res, time.perf_counter() - t

    for base, kw in (("sssp", {"source": s0}), ("cc", {}),
                     ("ppr", {"source": s0})):
        want = results[(base,) + tuple(kw.values())]
        for sweep in ("pull", "push", "auto"):
            res, dt = run(sess, names[base], sweep=sweep, **kw)
            res = trim(res, n)
            what = f"{names[base]} sweep={sweep}"
            check(same_bits(res.values, want.values),
                  f"{what}: values differ from the builtin's")
            for k in want.extra:
                check(same_bits(res.extra[k], want.extra[k]),
                      f"{what}: {k} differs from the builtin's")
            for f in ("rounds", "local_iters", "actions"):
                check(int(getattr(res.stats, f))
                      == int(getattr(want.stats, f)),
                      f"{what}: stats.{f} differs from the builtin's")
            rows.append({"query": names[base], "sweep": sweep, **kw,
                         "wall_s": dt, "rounds": int(res.stats.rounds),
                         "actions": int(res.stats.actions)})
    sync(device)
    t = time.perf_counter()
    lanes = sess.query(names["sssp"], sources=roots, refresh=True)
    sync(device)
    rows.append({"query": names["sssp"], "lanes": len(roots),
                 "wall_s": time.perf_counter() - t})
    for lane, want, r in zip(lanes, lanes16, roots):
        lane = trim(lane, n)
        check(same_bits(lane.values, want.values)
              and all(same_bits(lane.extra[k], want.extra[k])
                      for k in want.extra),
              f"stripped sssp lane {r} differs from phase 3d's lane")
    stripped_launches = dict(kernel.LAUNCHES)

    # reliability on the same edges, weights as success probabilities
    probs = np.clip(w / w.max(), 0.05, 1.0).astype(np.float32)
    edge_slack = max(0.01, 4096 / src.shape[0])
    node_slack = max(1e-4, 64 / n)
    t = time.perf_counter()
    rsess = DiffusionSession.from_edges(src, dst, n, probs, n_cells=4,
                                        edge_slack=edge_slack,
                                        node_slack=node_slack, device=device)
    sync(device)
    setup_s = time.perf_counter() - t
    before = dict(kernel.LAUNCHES)
    pull, dt = run(rsess, rel, source=s0)
    rows.append({"query": rel, "sweep": "pull", "source": s0, "wall_s": dt,
                 "rounds": int(pull.stats.rounds),
                 "actions": int(pull.stats.actions),
                 "reached": int((pull.values[:n] > 0).sum())})
    for sweep in ("push", "auto"):
        res, dt = run(rsess, rel, source=s0, sweep=sweep)
        check(same_bits(res.values, pull.values),
              f"reliability sweep={sweep}: values differ from pull")
        for f in ("rounds", "local_iters", "actions"):
            check(int(getattr(res.stats, f)) == int(getattr(pull.stats, f)),
                  f"reliability sweep={sweep}: stats.{f} differs from pull")
        rows.append({"query": rel, "sweep": sweep, "source": s0,
                     "wall_s": dt})
    lroots = roots[:8]
    sync(device)
    t = time.perf_counter()
    rlanes = rsess.query(rel, sources=lroots, refresh=True)
    sync(device)
    rows.append({"query": rel, "lanes": len(lroots),
                 "wall_s": time.perf_counter() - t})
    for lane, r in zip(rlanes, lroots):
        solo, _ = run(rsess, rel, source=r)
        check(same_bits(lane.values, solo.values),
              f"reliability lane {r} differs from its solo query")
    lr_before = dict(kernel.LAUNCHES)
    lr_report = logrel_checks(rsess, lr, s0, lroots, data, probs, run, rows)
    lr_launches = {k: kernel.LAUNCHES[k] - lr_before[k]
                   for k in kernel.LAUNCHES}
    rsess.query(lr, source=s0)                  # cached for the commit
    rsess.query(rel, source=s0)                 # cached for the commit
    rng = np.random.default_rng(args.seed + 7)
    live = rng.choice(src.shape[0], 64, replace=False)
    for i in live:
        rsess.delete_edge(int(src[i]), int(dst[i]))
    for u, v in rng.integers(0, n, (256, 2)):
        rsess.add_edge(int(u), int(v), float(0.5 + 0.5 * rng.random()))
    sync(device)
    info = rsess.commit()
    sync(device)
    repaired = rsess.query(rel, source=s0)
    fresh, _ = run(rsess, rel, source=s0)
    check(same_bits(repaired.values, fresh.values),
          "reliability: the commit's repair differs from a fresh query")
    repaired = rsess.query(lr, source=s0)
    fresh, _ = run(rsess, lr, source=s0)
    check(same_bits(repaired.values, fresh.values),
          "logrel: the commit's repair differs from a fresh query")
    lr_report["commit_repairs"] = [v[0] for k, v in info.repairs.items()
                                   if k[0] == lr]
    launches = dict(kernel.LAUNCHES)
    rel_launches = {k: launches[k] - before[k] - lr_launches[k]
                    for k in launches}
    del rsess
    if device.type == "cuda":
        torch.cuda.empty_cache()
    b16_before = dict(kernel.LAUNCHES)
    b16_report = bf16_sssp_checks(args, b16, device, rows)
    launches = dict(kernel.LAUNCHES)
    scan = dict(kernel.SCAN_LAUNCHES)
    b16_launches = {k: launches[k] - b16_before[k] for k in launches}
    if device.type == "cuda":
        torch.cuda.empty_cache()
        for k in ("edge_relax_blocks/generic", "edge_relax_scan/generic",
                  "edge_relax_push_blocks/generic"):
            check(launches[k] > 0, f"phase 3h launched no {k}")
            check(rel_launches[k] > 0, f"reliability launched no {k}")
        for k in ("edge_relax_blocks", "edge_relax_push_blocks"):
            check(launches[k] == 0, f"phase 3h launched the fixed {k}")
        check(rel_launches["edge_relax_scan"] == 0,
              "reliability launched the fixed K2")
        for who, book in (("logrel", lr_launches),
                          ("sssp_bf16", b16_launches)):
            for k in ("edge_relax_blocks/generic", "edge_relax_scan/generic",
                      "edge_relax_push_blocks/generic"):
                check(book[k] > 0, f"{who} launched no {k}")
    for r in rows:
        emit({"phase": "generic_query", **r})
    report = {"phase": "generic_checks", "ok": True, "build_s": build_s,
              "reliability_setup_s": setup_s,
              "commit": {"apply_s": info.apply_s, "repair_s": info.repair_s,
                         "repairs": {str(k): v[0] for k, v in
                                     info.repairs.items()}},
              "launches": launches, "scan_variants": {
                  k: v for k, v in scan.items() if v},
              "stripped_launches": stripped_launches,
              "reliability_launches": rel_launches,
              "logrel": {**lr_report, "launches": lr_launches},
              "sssp_bf16": {**b16_report, "launches": b16_launches}}
    emit(report)
    return {**launches, **{f"scan:{k}": v for k, v in scan.items()},
            **{f"logrel:{k}": v for k, v in lr_launches.items()}}


def logrel_checks(rsess, lr, s0, lroots, data, probs, run, rows) -> dict:
    """Phase 3h's log-space most reliable path on the reliability session
    (weights ``w' = clip(w / w.max(), 0.05, 1)``): push and auto bitwise
    pull (values, rounds, local iterations, actions), 8 lanes bitwise
    their solo queries, and the pull values within rel 1e-5 of scipy's
    Dijkstra on ``-log(w')`` in float64 (an edge of cost 0, w' = 1, at the
    least positive float64 so that scipy keeps it)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    src, dst, _, n = data
    pull, dt = run(rsess, lr, source=s0)
    rows.append({"query": lr, "sweep": "pull", "source": s0, "wall_s": dt,
                 "rounds": int(pull.stats.rounds),
                 "actions": int(pull.stats.actions)})
    for sweep in ("push", "auto"):
        res, dt = run(rsess, lr, source=s0, sweep=sweep)
        check(same_bits(res.values, pull.values),
              f"logrel sweep={sweep}: values differ from pull")
        for f in ("rounds", "local_iters", "actions"):
            check(int(getattr(res.stats, f)) == int(getattr(pull.stats, f)),
                  f"logrel sweep={sweep}: stats.{f} differs from pull")
        rows.append({"query": lr, "sweep": sweep, "source": s0,
                     "wall_s": dt})
    t = time.perf_counter()
    lanes = rsess.query(lr, sources=lroots, refresh=True)
    rows.append({"query": lr, "lanes": len(lroots),
                 "wall_s": time.perf_counter() - t})
    for lane, r in zip(lanes, lroots):
        solo, _ = run(rsess, lr, source=r)
        check(same_bits(lane.values, solo.values),
              f"logrel lane {r} differs from its solo query")
    cost = -np.log(probs.astype(np.float64))
    cost = np.where(cost > 0, cost, np.finfo(np.float64).tiny)
    a = sp.csr_matrix((cost, (src, dst)), shape=(n, n))
    t = time.perf_counter()
    want = dijkstra(a, directed=True, indices=s0)
    scipy_s = time.perf_counter() - t
    got = pull.values[:n].astype(np.float64)
    fin = np.isfinite(want)
    check(np.array_equal(np.isfinite(got), fin),
          "logrel: reachability differs from scipy")
    rel = np.abs(got[fin] - want[fin]) / np.maximum(want[fin], 1.0)
    check(rel.max(initial=0.0) <= 1e-5,
          f"logrel: rel error {rel.max()} > 1e-5 against scipy")
    return {"source": s0, "reached": int(fin.sum()),
            "max_rel_err_vs_scipy": float(rel.max(initial=0.0)),
            "scipy_s": scipy_s, "rounds": int(pull.stats.rounds),
            "lanes_bitwise_solo": len(lroots), "push_auto_bitwise": True}


def bf16_sssp_checks(args, b16, device, rows) -> dict:
    """Phase 3h's bfloat16 sssp on phase 2's scale_free graph (4 cells):
    pull on the card bitwise the same query on the CPU (values, parents,
    stats), push bitwise pull, 4 lanes bitwise their solo queries."""
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family

    src, dst, w, n = make_graph_family("scale_free", args.kernel_n, seed=0)
    gs = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                     device=device)
    cs = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                     device="cpu")
    out = {"graph": "scale_free", "n": n}
    sync(device)
    t = time.perf_counter()
    got = gs.query(b16, source=0)
    sync(device)
    out["card_pull_s"] = time.perf_counter() - t
    t = time.perf_counter()
    want = cs.query(b16, source=0)
    out["cpu_pull_s"] = time.perf_counter() - t
    check(same_bits(got.values, want.values)
          and all(same_bits(got.extra[k], want.extra[k]) for k in want.extra)
          and all(int(getattr(got.stats, f)) == int(getattr(want.stats, f))
                  for f in ("rounds", "local_iters", "actions")),
          "sssp_bf16: the card's query differs from the CPU's")
    push = gs.query(b16, source=0, sweep="push", refresh=True)
    check(same_bits(push.values, got.values),
          "sssp_bf16 push: values differ from pull")
    roots = [0, 7, 23, 101]
    lanes = gs.query(b16, sources=roots, refresh=True)
    for lane, r in zip(lanes, roots):
        solo = gs.query(b16, source=r, refresh=True)
        check(same_bits(lane.values, solo.values)
              and same_bits(lane.extra["p"], solo.extra["p"]),
              f"sssp_bf16 lane {r} differs from its solo query")
    sync(device)
    out.update(rounds=int(got.stats.rounds),
               reached=int(np.isfinite(want.values[:n]).sum()),
               values_dtype=str(got.values.dtype), card_vs_cpu_bitwise=True)
    rows.append({"query": b16, "sweep": "pull", "source": 0,
                 "wall_s": out["card_pull_s"]})
    del gs, cs
    return out


def phase_generic_timing(sess, fixed_rows, gen_launches, sources, roots,
                         device, reps: int, kernels) -> list:
    """Phase 4g: each generic instance of ``kernels`` (fixed rows' names)
    at its fixed row's shape, on the
    builtin stripped of its KernelEmit (the same function on the same
    inputs): bitwise the fixed instance's output, then timed in turns with
    it (fixed, generic, generic, fixed).  The plain version is the same
    code for both (its time is the fixed row's); the bound is the fixed
    row's bytes plus the record words the generic instance packs beyond
    the fixed one's (none for these programs)."""
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.kernels.edge_relax import kernel

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    es = sg.sorted_width
    n_keys = S * Np
    full = sg.node_ok.clone()
    by_name = {r["name"]: r for r in fixed_rows}
    kw = {"source": sources[0]}
    sssp_state = sess.vertex_state("sssp", **kw)
    pr_fixed = PROGRAMS["pagerank"].factory(eps=1e-7)
    pr_state, _ = pr_fixed.init(sg)
    nb = sg.csr_key.shape[-1] // kernel.BLOCK_E
    L = len(roots)

    def k1(prog):
        _, a = stream_inputs(sess, prog, sssp_state, full)
        return lambda: kernel.edge_relax_blocks(*a, n_keys)

    def k2(prog):
        skey, a = stream_inputs(sess, prog, pr_state, full)
        return lambda: kernel.edge_relax_scan(*a, skey=skey)

    def k2l(prog):
        states = [sess.vertex_state("sssp", source=r) for r in roots]
        lane_state = {k: torch.stack([st[k] for st in states], dim=1)
                      for k in states[0]}
        senders = sg.node_ok[:, None].expand(S, L, Np).contiguous()
        skey, a = stream_inputs(sess, prog, lane_state, senders)
        return lambda: kernel.edge_relax_scan(*a, skey=skey)

    def k3(prog):
        _, _, _, a = push_inputs(sess, prog, sssp_state, full, nb)
        return lambda: kernel.edge_relax_push_blocks(*a)

    cases = [
        ("edge_relax_blocks", k1, PROGRAMS["sssp"].factory(**kw),
         stripped("sssp", kw), "edge_relax_blocks/generic"),
        ("edge_relax_scan", k2, pr_fixed,
         stripped("pagerank", {"eps": 1e-7}), "scan:sum/generic"),
        ("edge_relax_scan (laned, payload)", k2l,
         make_laned([PROGRAMS["sssp"].factory(source=r) for r in roots]),
         make_laned([stripped("sssp", {"source": r}) for r in roots]),
         "scan:min/max+payload/laned/generic"),
        ("edge_relax_push_blocks", k3, PROGRAMS["sssp"].factory(**kw),
         stripped("sssp", kw), "edge_relax_push_blocks/generic"),
    ]
    rows = []
    for name, make, fixed, gen, counter in cases:
        if name not in kernels:
            continue
        fixed_fn, gen_fn = make(fixed), make(gen)
        got, want = gen_fn(), fixed_fn()
        sync(device)
        for g, w_ in zip(got, want):
            check((g is None) == (w_ is None)
                  and (w_ is None or torch.equal(g, w_)),
                  f"{name}: the generic instance differs from the fixed one")
        del got, want
        kernel.reset_launches()             # timing launches never count
        f1 = clock.ms(fixed_fn, reps)
        g1 = clock.ms(gen_fn, reps)
        g2 = clock.ms(gen_fn, reps)
        f2 = clock.ms(fixed_fn, reps)
        base = by_name[name]
        row = kernel_row(
            f"{name}/generic", base["source"], base["replaces"],
            gen_launches.get(counter, 0), base["max_abs_err"],
            (g1 + g2) / 2, base["plain_ms"], base["bytes"], base["ops"],
            base["library_ms"])
        rows.append(row)
        emit({"phase": "generic_timing", "kernel": name,
              "program": gen.name, "generic_ms": [g1, g2],
              "fixed_ms": [f1, f2], "ratio": (g1 + g2) / (f1 + f2),
              "record_words": gen.kernel_gen.words,
              **{k: row[k] for k in ("launches", "bound_ms", "plain_ms",
                                     "library_ms")}})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def timing_programs(source: int) -> tuple:
    """Phase 4g's programs beyond the first op set: the log-space path
    from ``source``, a min and a sum program over a 13-word record (12
    fields picked by dst_gid), and pagerank's share over bfloat16."""
    from repro_torch.core.programs import PROGRAMS

    f32, bf16 = torch.float32, torch.bfloat16

    def pick(s, w, dg):
        out = w
        for k in range(12):
            out = out + torch.where(dg % 12 == k, s[f"w{k}"], 0.0)
        return out

    ws = {f"w{k}": f32 for k in range(12)}
    wide_min = lower_program("wide_min", {"d": f32, **ws},
                             lambda s, w, sg_, dg: s["d"] + pick(s, w, dg))
    with unverified():
        bf16_sum = lower_program(
            "bf16_share", {"residual": bf16, "deg": bf16},
            lambda s, w, sg_, dg: (s["residual"] * 0.85) / s["deg"], bf16,
            "sum")
    wide_sum = lower_program(
        "wide_share", {"residual": f32, "deg": f32, **ws},
        lambda s, w, sg_, dg: (s["residual"] * 0.85) / s["deg"] +
        pick(s, 0.0 * w, dg), f32, "sum")
    return (PROGRAMS[register_logrel()].factory(source=source), wide_min,
            bf16_sum, wide_sum)


def phase_emit_timing(sess, gen_launches, sources, device,
                      reps: int) -> list:
    """Phase 4g's programs beyond the first op set, each bitwise its plain
    version first, then timed: K1's generic instance with a
    transcendental emit (the log-space path, -log(w)) and with a record of
    13 words (12 fields picked by dst_gid) at K1's sssp shape, K2's with
    bfloat16 messages under sum (pagerank's push share in bfloat16) and
    with the 13-word record at K2's pagerank shape.  The bound counts
    each byte once: the stream, the fields the record packs (its bytes at
    their dtype), the senders, and the outputs at the message dtype.
    ``library_ms`` is the scatter (``scatter_reduce_`` amin) or segment
    sum (``segment_reduce``) of the same messages; launches are the
    generic instance's in phase 3h (the log-space row: its own)."""
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel, ref

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    es = sg.sorted_width
    n_keys = S * Np
    full = sg.node_ok.clone()
    kw = {"source": sources[0]}
    dist = sess.vertex_state("sssp", **kw)["dist"]
    pr_state, _ = PROGRAMS["pagerank"].factory(eps=1e-7).init(sg)
    g = torch.Generator(device="cpu").manual_seed(5)
    fields = {f"w{k}": (0.01 + 4 * torch.rand((S, Np), generator=g)).to(
        device) for k in range(12)}
    bf16 = torch.bfloat16
    lr, wide_min, bf16_sum, wide_sum = timing_programs(sources[0])
    cases = [
        ("edge_relax_blocks/generic (log-space emit)", "k1", lr,
         {"d": dist}, gen_launches.get("logrel:edge_relax_blocks/generic",
                                       0)),
        ("edge_relax_blocks/generic (13-word record)", "k1", wide_min,
         {"d": dist, **fields},
         gen_launches.get("edge_relax_blocks/generic", 0)),
        ("edge_relax_scan/generic (bfloat16 sum)", "k2", bf16_sum,
         {k: pr_state[k].to(bf16) for k in ("residual", "deg")},
         gen_launches.get("scan:sum/generic", 0)),
        ("edge_relax_scan/generic (13-word record)", "k2", wide_sum,
         {"residual": pr_state["residual"], "deg": pr_state["deg"],
          **fields}, gen_launches.get("scan:sum/generic", 0)),
    ]
    rows = []
    for name, which, prog, vstate, launches in cases:
        skey, args = stream_inputs(sess, prog, vstate, full)
        tr = prog.kernel_gen
        msg_b = prog.msg_dtype.itemsize
        field_b = sum(vstate[k].element_size() for k, _ in tr.fields)
        per_pos = 4 + 4 + (4 if which == "k2" else 0) \
            + 4 * tr.reads_weight + 4 * tr.reads_dst_gid
        cand, send, _ = ref.edge_messages(*args)
        if which == "k1":
            err = hold_k1(args, n_keys, name)
            fn = lambda a=args: kernel.edge_relax_blocks(*a, n_keys)
            plain = lambda a=args: ref.combine_blocks(
                *ref.edge_relax_blocks_ref(*a, block_e=kernel.BLOCK_E),
                n_keys, prog.combine)
            ids = torch.where(send, args[4], n_keys).long()
            ids = ids + torch.arange(S, device=device)[:, None] * (n_keys + 1)
            flat_c, flat_i = cand.reshape(-1), ids.reshape(-1)
            table = torch.empty(S * (n_keys + 1), dtype=cand.dtype,
                                device=device)
            lib = lambda: table.fill_(float("inf")).scatter_reduce_(
                0, flat_i, flat_c, "amin")
            nbytes = S * es * per_pos + S * Np * (1 + field_b) \
                + S * n_keys * (msg_b + 4)
        else:
            err = hold_k2(args, skey, name)
            fn = lambda a=args, k=skey: kernel.edge_relax_scan(*a, skey=k)
            plain = lambda a=args, k=skey: ref.edge_relax_scan_ref(*a,
                                                                   skey=k)
            k_ = skey.reshape(-1)
            starts = torch.nonzero(torch.cat([
                torch.ones(1, dtype=torch.bool, device=device),
                k_[1:] != k_[:-1]])).reshape(-1)
            lengths = torch.diff(starts, append=torch.tensor(
                [k_.numel()], device=device))
            flat = cand.reshape(-1).contiguous()
            lib = lambda: torch.segment_reduce(flat, "sum", lengths=lengths)
            nbytes = S * es * per_pos + S * Np * (1 + field_b) \
                + S * es * (msg_b + 4)
        kernel.reset_launches()             # timing launches never count
        ms1 = clock.ms(fn, reps)
        p_ms = clock.ms(plain, max(2, reps // 10), warmup=1)
        ms2 = clock.ms(fn, reps)
        lib_ms = clock.ms(lib, reps)
        row = kernel_row(
            name, "src/repro_torch/kernels/edge_relax/csrc/" + (
                "edge_relax_tables.cu" if which == "k1" else
                "edge_relax_scan.cu"),
            "src/repro/kernels/edge_relax/kernel.py:" + (
                "220" if which == "k1" else "97"),
            launches, err, (ms1 + ms2) / 2, p_ms, nbytes, S * es * 6, lib_ms)
        rows.append(row)
        emit({"phase": "emit_timing", "kernel": name, "program": prog.name,
              "ms": [ms1, ms2], "record_words": tr.words,
              "msg_dtype": str(prog.msg_dtype),
              **{k: row[k] for k in ("launches", "bound_ms", "plain_ms",
                                     "library_ms", "bytes")}})
        del cand, send
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def parents_tight(sess, vstate, source: int) -> bool:
    """On the device: every reached live vertex but the source has its
    parent on a live in-edge with dist[parent] + w == dist[v] (float32)."""
    sg = sess.sg
    dist, par = vstate["dist"], vstate["parent"]
    cells = torch.arange(sg.n_shards, device=dist.device)[:, None]
    sl = sg.src_local.long()
    ds, dl = sg.dst_shard.long(), sg.dst_local.long()
    tight = (sg.edge_ok & (sg.gid[cells, sl] == par[ds, dl])
             & (dist[cells, sl] + sg.weight == dist[ds, dl]))
    flat = (ds * sg.n_per_shard + dl)[tight]
    has = torch.zeros(sg.n_shards * sg.n_per_shard, dtype=torch.bool,
                      device=dist.device)
    has[flat] = True
    need = sg.node_ok & torch.isfinite(dist) & (sg.gid != source)
    return bool((has.view_as(need) | ~need).all())


def commit_batches(sess, src, dst, n, sources, rng):
    """The three commits of phase 3c, as (label, script) pairs; each
    script queues its ops on the session."""
    s0 = sources[0]

    def adds(s):
        u = rng.integers(0, n, 256)
        v = rng.integers(0, n, 256)
        w = (1 + 7 * rng.random(256)).astype(np.float32)
        for a, b, x in zip(u, v, w):
            s.add_edge(int(a), int(b), float(x))
        return {"edge_adds": 256, "frontier": u}

    def deletes(s):
        par = s.to_global(s.vertex_state("sssp", source=s0)["parent"])[:n]
        reached = np.nonzero((par >= 0) & (np.arange(n) != s0))[0]
        tree = rng.choice(reached, 32, replace=False)
        for v in tree:
            s.delete_edge(int(par[v]), int(v))
        for i in rng.choice(src.shape[0], 224, replace=False):
            s.delete_edge(int(src[i]), int(dst[i]))
        return {"edge_deletes": 256, "tree_edges": 32}

    def mixed(s):
        for _ in range(16):
            g = s.add_vertex()
            for a in rng.integers(0, n, 2):
                s.add_edge(g, int(a), 2.0)
                s.add_edge(int(rng.integers(0, n)), g, 3.0)
        deg = np.bincount(src, minlength=n)
        pool = np.setdiff1d(np.nonzero(deg > 0)[0], sources)
        for g in rng.choice(pool, 8, replace=False):
            s.delete_vertex(int(g))
        for g in rng.integers(0, n, 16):
            s.touch(int(g))
        return {"vertex_adds": 16, "edge_adds": 64, "vertex_deletes": 8,
                "touches": 16}
    return [("adds", adds), ("deletes", deletes), ("mixed", mixed)]


def phase_commits(args, sess, data, sources, roots, device) -> dict:
    """Phase 3c: three commits at full width, each repair held against a
    fresh diffusion of the committed graph; four sssp entries come from
    one laned query and are repaired like the rest."""
    from repro_torch.core import diffuse
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    s0 = sources[0]
    solo = [("sssp", {"source": s0}), ("bfs", {"source": s0}), ("cc", {}),
            ("ppr", {"source": s0})]
    laned = roots[2:6]
    cached = solo + [("sssp", {"source": r}) for r in laned]
    # exactly these entries: refreshing them evicts the rest
    sess.max_cache_entries = len(cached)
    for name, kw in solo:
        sess.query(name, refresh=True, **kw)
    sess.query("sssp", sources=laned, refresh=True)
    rng = np.random.default_rng(args.seed + 1)
    sync(device)
    kernel.reset_launches()
    k3_total = 0
    frontier0 = None
    times = []
    for label, script in commit_batches(sess, src, dst, n, sources, rng):
        ops = script(sess)
        if "frontier" in ops:           # the first repair's sources
            frontier0 = ops.pop("frontier")
        before = dict(kernel.LAUNCHES)
        info = sess.commit()
        k3 = (kernel.LAUNCHES["edge_relax_push_blocks"]
              - before["edge_relax_push_blocks"])
        k3_total += k3
        repairs = {}
        for key, (strategy, st) in info.repairs.items():
            root = dict(key[2]).get("source", "")
            repairs[f"{key[0]}{root}"] = {"strategy": strategy,
                               "rounds": int(st.rounds),
                               "local_iters": int(st.local_iters),
                               "push_iters": int(st.push_iters),
                               "actions": int(st.actions)}
        checks = {}
        for name, kw in cached:
            spec = PROGRAMS[name]
            got = sess.vertex_state(name, **kw)
            fresh, _ = diffuse(sess.sg, spec.factory(**kw))
            vk = spec.value_key
            live = sess.sg.node_ok
            if name == "ppr":           # default eps 1e-4: n * eps L1
                l1 = float((got[vk] - fresh[vk]).abs()[live].sum())
                limit = int(live.sum()) * 1e-4
                check(l1 <= limit, f"commit {label}: ppr L1 {l1} > {limit}")
                checks[name] = {"l1": l1, "limit": limit}
                continue
            tag = f"{name}{kw.get('source', '')}"
            check(torch.equal(torch.where(live, got[vk], 0),
                              torch.where(live, fresh[vk], 0)),
                  f"commit {label}: repaired {tag} differs from a fresh "
                  f"diffusion")
            checks[tag] = "bitwise"
            if name == "sssp":
                check(parents_tight(sess, got, kw["source"]),
                      f"commit {label}: a repaired parent of {tag} is not a "
                      f"tight in-edge")
                checks[f"{tag}_parents"] = "tight"
        check(len(info.repairs) == len(cached),
              f"commit {label} repaired {len(info.repairs)} entries, not "
              f"{len(cached)}")
        times.append({"batch": label, "apply_s": info.apply_s,
                      "repair_s": info.repair_s})
        emit({"phase": "commit", "batch": label, **ops,
              "apply_s": info.apply_s, "repair_s": info.repair_s,
              "k3_launches": k3,
              "launches": {k: kernel.LAUNCHES[k] - before[k]
                           for k in kernel.LAUNCHES},
              "delta_count": sess.sg.delta_count.tolist(),
              "tomb_count": sess.sg.tomb_count.tolist(),
              "repairs": repairs, "checks": checks})
    if device.type == "cuda":
        check(k3_total > 0, "K3 was not launched by the commit repairs")
    # scipy Dijkstra on the committed graph
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    es, ed, ew = sess.edge_list()
    m = sess.n_ids
    a = sp.csr_matrix((ew.astype(np.float64), (es, ed)), shape=(m, m))
    ref = dijkstra(a, directed=True, indices=s0)
    got = sess.query("sssp", source=s0).values
    live = sess.live_ids()
    fin = np.isfinite(ref) & live
    check(np.array_equal(np.isfinite(got) & live, fin),
          "committed sssp: reachability differs from scipy")
    rel = np.abs(got[fin] - ref[fin]) / np.maximum(ref[fin], 1.0)
    check(rel.max(initial=0.0) <= 1e-5,
          f"committed sssp: rel error {rel.max()} > 1e-5")
    launches = {"edge_relax_push_blocks": k3_total}
    emit({"phase": "commit_checks", "ok": True, "k3_launches": k3_total,
          "sssp_max_rel_err": float(rel.max(initial=0.0)),
          "reached": int(fin.sum())})
    return launches, frontier0, times


# --------------------------------------------------------------------------
# durability: merge compaction, save / open / replay, kills, the serve loop
# --------------------------------------------------------------------------

VIEW_FIELDS = ("csr_perm", "csr_key", "csr_live", "csr_inv", "push_perm",
               "push_src", "push_pos", "push_inv")


def same_tensor(x, y) -> bool:
    """Bitwise equality (NaN and -0.0 included) of two tensors, on x's
    device."""
    return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).contiguous().view(torch.uint8),
        y.to(x.device).reshape(-1).contiguous().view(torch.uint8)))


def same_session(a, b, tag: str) -> dict:
    """Every ShardedGraph array, the partition, the NameServer and the
    cache (the set of keys; each entry's state and stats) bitwise; b's
    tensors on a's device."""
    import dataclasses

    check(b.device == a.device, f"{tag}: opened on {b.device}")
    for f in dataclasses.fields(a.sg):
        x, y = getattr(a.sg, f.name), getattr(b.sg, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            check(x is not None and y is not None and y.device == x.device
                  and same_tensor(x, y), f"{tag}: graph array {f.name}")
        else:
            check(x == y, f"{tag}: graph field {f.name}: {x} != {y}")
    pa, pb = a.part, b.part
    check(np.array_equal(pa.owner_np, pb.owner_np)
          and np.array_equal(pa.local_np, pb.local_np)
          and pa.n_real == pb.n_real
          and (pa.replica is None) == (pb.replica is None),
          f"{tag}: partition differs")
    if pa.replica is not None:
        check(all(np.array_equal(x, y) for x, y in zip(pa.replica,
                                                       pb.replica)),
              f"{tag}: replica maps differ")
    na, nb = a.ns.state_dict(), b.ns.state_dict()
    check(sorted(na) == sorted(nb) and all(np.array_equal(na[k], nb[k])
                                           for k in na),
          f"{tag}: NameServer state differs")
    check(set(a._cache) == set(b._cache), f"{tag}: cache keys differ")
    for key, ea in a._cache.items():
        eb = b._cache[key]
        check(sorted(ea.vstate) == sorted(eb.vstate)
              and all(same_tensor(ea.vstate[f], eb.vstate[f])
                      for f in ea.vstate), f"{tag}: cached state of {key}")
        check(all(same_tensor(x, y) for x, y in zip(ea.stats, eb.stats)),
              f"{tag}: cached stats of {key}")
    return {"graph_arrays": len(a.sg.state_dict()), "ns_arrays": len(na),
            "cache_entries": len(a._cache)}


def snapshot_bytes(sess) -> int:
    """The bytes a snapshot of ``sess`` holds, reckoned from the state
    dicts: the graph, the partition maps, the NameServer and every cached
    state and stats leaf."""
    def nb(a):
        if isinstance(a, torch.Tensor):
            return a.numel() * a.element_size()
        return np.asarray(a).nbytes
    total = sum(nb(a) for a in sess.sg.state_dict().values())
    total += sum(nb(a) for a in sess.ns.state_dict().values())
    total += sess.part.owner_np.nbytes + sess.part.local_np.nbytes
    for e in sess._cache.values():
        total += sum(nb(v) for v in (e.vstate or {}).values())
        total += sum(nb(v) for v in (e.stats or ()))
    return total


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def edge_batch(src, dst, n, rng) -> list:
    """One batch of phase 3c's kind: 256 edge adds (weights in [1, 8)) and
    256 deletes of input edges, as ops to stage on any session."""
    u, v = rng.integers(0, n, 256), rng.integers(0, n, 256)
    w = (1 + 7 * rng.random(256)).astype(np.float32)
    dels = rng.choice(src.shape[0], 256, replace=False)
    return ([("add", int(a), int(b), float(x)) for a, b, x in zip(u, v, w)]
            + [("del", int(src[i]), int(dst[i])) for i in dels])


def stage(s, ops) -> None:
    for op in ops:
        if op[0] == "add":
            s.add_edge(*op[1:])
        else:
            s.delete_edge(*op[1:])


# graph500 scales of the merge / full-sort sweep: per-cell sorted widths
# from about 500 to 2 M positions (phase 3's graph adds 8 M)
MERGE_SWEEP_SCALES = (6, 8, 10, 12, 14, 16, 18)


def merge_vs_sort(dirty, clock, reps: int, tag: str) -> dict:
    """``_merge_compact`` against ``with_csr()`` (the full sort) on a dirty
    graph: all eight view arrays bitwise, then both timed in device ms."""
    check(bool(dirty.delta_count.any()) and bool(dirty.tomb_count.any()),
          f"{tag}: graph not dirty")
    used = int(dirty.delta_count.max())   # read once, outside the timing
    merged, full = dirty._merge_compact(used), dirty.with_csr()
    for f in VIEW_FIELDS:
        check(same_tensor(getattr(merged, f), getattr(full, f)),
              f"{tag}: merged {f} differs from the full sort")
    check(full.with_csr() is full, f"{tag}: compacted views not clean")
    return {"sorted_width": dirty.sorted_width,
            "delta_width": dirty.delta_width, "cells": dirty.n_shards,
            "staged": dirty.delta_count.tolist(),
            "tombstones": dirty.tomb_count.tolist(), "bitwise": True,
            "merge_ms": clock.ms(lambda: dirty._merge_compact(used), reps,
                                 warmup=1),
            "full_sort_ms": clock.ms(lambda: dirty.with_csr(), reps,
                                     warmup=1)}


def merge_sweep(device, seed: int, scales=MERGE_SWEEP_SCALES,
                reps: int = 5) -> list:
    """The merge compaction against the full sort on graph500 graphs of 4
    cells: at each scale one staged batch of 3c's kind (256 edge adds and
    256 deletes, 1 % of the edges each on smaller graphs), and at scale 16
    also a batch whose adds are 5 % of the edges."""
    from repro_torch.core import UpdateBatch
    from repro_torch.core.api import build
    from repro_torch.core.dynamic import NameServer
    from repro_torch.core.generators import make_graph_family

    clock = Clock(device)
    rng = np.random.default_rng(seed + 5)
    rows = []
    for scale in scales:
        src, dst, w, n = make_graph_family("graph500", 1 << scale, seed=0)
        e = int(src.shape[0])
        cases = [("3c", min(256, e // 100), min(256, e // 100))]
        if scale == 16:
            cases.append(("adds_5pct", e // 20, 256))
        for case, n_add, n_del in cases:
            part = build(src, dst, n, w, n_cells=4,
                         edge_slack=max(0.01, 4096 / e, 3 * n_add / e),
                         node_slack=max(1e-4, 64 / n), device=device)
            b = UpdateBatch(NameServer(part))
            u, v = rng.integers(0, n, n_add), rng.integers(0, n, n_add)
            for a, c in zip(u.tolist(), v.tolist()):
                b.add_edge(a, c, 1.0)
            for i in rng.choice(e, n_del, replace=False).tolist():
                b.delete_edge(int(src[i]), int(dst[i]))
            dirty, _ = b.apply(part.sg)
            row = {"scale": scale, "case": case,
                   **merge_vs_sort(dirty, clock, reps,
                                   f"merge sweep: scale {scale} {case}")}
            rows.append(row)
            emit({"phase": "merge_sweep", **row})
            del part, b, dirty
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def phase_durability(args, sess, data, sources, commit_times, device):
    """Phase 3i: the merge compaction, save / open / replay, a killed
    commit, a killed save and the preempted serve loop on phase 3's
    session (3c's cache), every recovered session bitwise the live one.
    The snapshots go under OUT_DIR/durable, removed at the end."""
    import shutil
    from unittest import mock

    from repro_torch.core import DiffusionSession, UpdateBatch, chaos
    from repro_torch.kernels.edge_relax import kernel
    from repro_torch.launch.serve import DurableSessionLoop
    from repro_torch.runtime.fault_tolerance import PreemptionGuard

    t_phase = time.perf_counter()
    src, dst, w, n = data
    s0 = sources[0]
    rng = np.random.default_rng(args.seed + 3)
    base = OUT_DIR / "durable"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    dir_a, dir_b = base / "a", base / "b"
    nbytes = snapshot_bytes(sess)
    free = shutil.disk_usage(base).free
    emit({"phase": "durable_setup", "snapshot_bytes": nbytes,
          "free_disk_bytes": free, "cache": [list(map(str, k))
                                             for k in sess._cache]})
    check(free >= 4 * nbytes,
          f"phase 3i needs 4 x {nbytes} B of free disk under {base} (up "
          f"to three retained snapshots and one being written); "
          f"{free} B free")
    rep = {"phase": "durability", "snapshot_bytes": nbytes,
           "commits_3c": commit_times}
    opened = []
    try:
        # (a) the merge against the full sort: phase 3's graph after one
        # staged batch, then the sweep's smaller graphs
        b = UpdateBatch(sess.ns)
        stage(b, edge_batch(src, dst, n, rng))
        dirty, _ = b.apply(sess.sg)
        clock = Clock(device)
        rep["merge"] = merge_vs_sort(dirty, clock, 3, "3i")
        if args.profile and device.type == "cuda":
            used = int(dirty.delta_count.max())
            for name, run in (
                    ("merge", lambda: dirty._merge_compact(used)),
                    ("full_sort", lambda: dirty.with_csr())):
                line = trace(name, run)
                rep["merge"][f"{name}_profile"] = {
                    k: line[k] for k in ("wall_ms", "device_busy_ms",
                                         "kernel_launches", "top")}
        del b, dirty
        rep["merge_sweep"] = merge_sweep(
            device, args.seed,
            MERGE_SWEEP_SCALES if args.scale >= 20 else (6, args.scale))

        # (b) save, two journaled commits, open on the card
        batches = [edge_batch(src, dst, n, rng) for _ in range(3)]
        sync(device)
        t = time.perf_counter()
        step0 = sess.save(str(dir_a))
        rep["save_s"] = time.perf_counter() - t
        rep["snapshot_disk_bytes"] = dir_bytes(dir_a / f"step_{step0}")
        rep["journaled_commits"] = []
        for ops in batches[:2]:
            stage(sess, ops)
            info = sess.commit()
            rep["journaled_commits"].append(
                {"apply_s": info.apply_s, "repair_s": info.repair_s,
                 "repairs": {f"{k[0]}{dict(k[2]).get('source', '')}": v[0]
                             for k, v in info.repairs.items()}})
        shutil.copytree(dir_a, dir_b)     # the two journals stay apart
        replay_s = []
        real = DiffusionSession._replay_journal

        def timed_replay(self, from_seq):
            sync(device)
            t = time.perf_counter()
            out = real(self, from_seq)
            sync(device)
            replay_s.append(time.perf_counter() - t)
            return out

        sync(device)
        kernel.reset_launches()
        t = time.perf_counter()
        with mock.patch.object(DiffusionSession, "_replay_journal",
                               timed_replay):
            rec = DiffusionSession.open(str(dir_b), device=device.type)
        sync(device)
        rep["open_s"] = time.perf_counter() - t
        rep["replay_s"] = replay_s[0]
        launches = {k: kernel.LAUNCHES[k] for k in (
            "edge_relax_blocks", "edge_relax_scan", "edge_relax_push_blocks")}
        rep["replay_launches"] = launches
        if device.type == "cuda":
            check(launches["edge_relax_push_blocks"] > 0,
                  "3i: replay launched no K3")
        opened.append(rec)
        check(len(rec._journal) == 2, "3i: the journal lost a commit")
        rep["open_equal"] = same_session(sess, rec, "3i open")
        queries = [("sssp", {"source": s0}), ("bfs", {"source": s0}),
                   ("cc", {}), ("ppr", {"source": s0})]
        kernel.reset_launches()
        for name, kw in queries:
            got = rec.query(name, refresh=True, **kw)
            want = sess.query(name, **kw)
            check(same_bits(got.values, want.values),
                  f"3i: {name} on the opened session differs")
        rep["query_launches"] = {k: kernel.LAUNCHES[k] for k in launches}
        if device.type == "cuda":
            check(rep["query_launches"]["edge_relax_blocks"] > 0
                  and rep["query_launches"]["edge_relax_scan"] > 0,
                  "3i: the queries after open launched no K1 or K2")

        # (c) a commit killed after its apply, then a killed save
        stage(rec, batches[2])
        monkey = chaos.ChaosMonkey(kill_at=("commit.applied", 0))
        try:
            with chaos.harness(monkey):
                rec.commit()
        except chaos.ChaosKill:
            pass
        check(monkey.fired == ("commit.applied", 0), "3i: no kill")
        rec.close()
        opened.remove(rec)
        del rec
        stage(sess, batches[2])
        sess.commit()                     # the uninterrupted run
        t = time.perf_counter()
        rec = DiffusionSession.open(str(dir_b), device=device.type)
        sync(device)
        rep["open_after_kill_s"] = time.perf_counter() - t
        opened.append(rec)
        check(len(rec._journal) == 3, "3i: the killed commit is not durable")
        same_session(sess, rec, "3i after the killed commit")
        monkey = chaos.ChaosMonkey(kill_at=("checkpoint.pre-rename", 0))
        try:
            with chaos.harness(monkey):
                rec.save()
        except chaos.ChaosKill:
            pass
        check(monkey.fired == ("checkpoint.pre-rename", 0),
              "3i: the save was not killed")
        rec.close()
        opened.remove(rec)
        del rec
        rec = DiffusionSession.open(str(dir_b), device=device.type)
        opened.append(rec)
        check(rec._ckpt.all_steps() == [step0],
              "3i: the killed save published a snapshot")
        same_session(sess, rec, "3i after the killed save")
        rec.close()
        opened.remove(rec)
        del rec
        shutil.rmtree(dir_b)
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # (d) the serve loop, preempted at its 4th step
        guard = PreemptionGuard()
        loop_ops = [edge_batch(src, dst, n, rng) for _ in range(6)]

        def loop_batches():
            for i, ops in enumerate(loop_ops):
                if i == 3:
                    guard.trigger()
                yield lambda s, ops=ops: stage(s, ops)

        t = time.perf_counter()
        loop = DurableSessionLoop(sess, str(dir_a), snapshot_every=2)
        steps = loop.run(loop_batches(), guard=guard)
        sync(device)
        rep["loop_s"] = time.perf_counter() - t
        final = sess._journal.next_seq
        check(steps == 4 and loop.preempted
              and sess._ckpt.latest_step() == final,
              f"3i: the loop ran {steps} steps, preempted "
              f"{loop.preempted}, last snapshot "
              f"{sess._ckpt.latest_step()} (journal at {final})")
        rep["loop"] = {"steps": steps, "preempted": loop.preempted,
                       "snapshots": sess._ckpt.all_steps()}
        t = time.perf_counter()
        rec = DiffusionSession.open(str(dir_a), device=device.type)
        sync(device)
        rep["open_after_loop_s"] = time.perf_counter() - t
        opened.append(rec)
        same_session(sess, rec, "3i after the serve loop")
    finally:
        for r in opened:
            r.close()
        sess.close()
        shutil.rmtree(base, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t_phase
    rep["ok"] = True
    emit(rep)
    return rep


def parents_tight_logical(sess, vstate, source: int) -> bool:
    """On the device, over logical vertex ids (so a split hub's member
    slots count as one vertex): every reached live vertex but the source
    has its parent on a live in-edge with dist[parent] + w == dist[v]."""
    sg = sess.sg
    owner, local = sess._layout()
    dist = vstate["dist"][owner, local]
    par = vstate["parent"][owner, local].long()
    cells = torch.arange(sg.n_shards, device=dist.device)[:, None]
    sgid = sg.gid[cells, sg.src_local.long()].long()
    dgid = sg.dst_gid.long()
    tight = (sg.edge_ok & (par[dgid] == sgid)
             & (dist[sgid] + sg.weight == dist[dgid]))
    has = torch.zeros(dist.shape[0], dtype=torch.bool, device=dist.device)
    has[dgid[tight]] = True
    ids = torch.arange(dist.shape[0], device=dist.device)
    live = sg.node_ok[owner, local] & (sg.gid[owner, local] == ids)
    need = live & torch.isfinite(dist) & (ids != source)
    return bool((has | ~need).all())


def phase_replicas(args, sess, results, walls, sources, roots, data,
                   device) -> dict:
    """Phase 3e: a second session on phase 3's edges with hub replicas
    (``replica_threshold``); every min/max result bitwise phase 3's and
    3b's unsplit ones, pagerank/ppr at the reference test's limits, lanes
    bitwise solo, and one commit around the heaviest hub repaired bitwise
    a fresh diffusion."""
    from repro_torch.core import DiffusionSession, diffuse
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    s0 = sources[0]
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    edge_slack = max(0.01, 4096 / src.shape[0])
    node_slack = max(1e-4, 64 / n)
    t = time.perf_counter()
    split = DiffusionSession.from_edges(
        src, dst, n, w, n_cells=4, edge_slack=edge_slack,
        node_slack=node_slack, replica_threshold=args.replica_threshold,
        device=device)
    sync(device)
    build_s = time.perf_counter() - t
    rep = split.part.replica
    check(rep is not None, f"replica_threshold={args.replica_threshold} "
                           f"split no hub")
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    hubs = rep.hub_gid.astype(np.int64)
    on = split.sg.edge_ok.sum(dim=1).tolist()
    off = sess.sg.edge_ok.sum(dim=1).tolist()
    members = np.bincount(rep.n_members).tolist()
    emit({"phase": "replicas_setup", "threshold": args.replica_threshold,
          "hubs": int(hubs.shape[0]),
          "members_per_hub": {str(r): c for r, c in enumerate(members)
                              if c},
          "non_primary_slots": int((rep.n_members - 1).sum()),
          "hub_endpoint_share": float(deg[hubs].sum() / deg.sum()),
          "max_total_degree": int(deg.max()),
          "n_per_shard": split.sg.n_per_shard,
          "edges_per_shard": split.sg.edges_per_shard,
          "live_edges_per_cell_on": on, "live_edges_per_cell_off": off,
          "max_mean_on": [max(on), sum(on) / len(on)],
          "max_mean_off": [max(off), sum(off) / len(off)],
          "partition_upload_s": build_s})

    sync(device)
    kernel.reset_launches()
    rows = []

    def run(name, kw, sweep):
        before = dict(kernel.LAUNCHES)
        sync(device)
        t = time.perf_counter()
        res = trim(split.query(name, sweep=sweep, refresh=True, **kw), n)
        sync(device)
        dt = time.perf_counter() - t
        off_key = ((name,) if sweep == "pull" else (name, sweep)) + tuple(
            kw.values())
        rows.append({"query": name, **kw, "sweep": sweep, "wall_s": dt,
                     "off_wall_s": walls.get(off_key),
                     "rounds": int(res.stats.rounds),
                     "actions": int(res.stats.actions),
                     "converged": bool(res.stats.converged),
                     **{f"{k}_launches": kernel.LAUNCHES[k] - before[k]
                        for k in kernel.LAUNCHES}})
        return res

    for sweep in ("pull", "push", "auto"):
        for name, kw in (("sssp", {"source": s0}), ("bfs", {"source": s0}),
                         ("cc", {})):
            res = run(name, kw, sweep)
            off_res = results[(name,) + tuple(kw.values())]
            what = f"split {name} sweep={sweep}"
            check(same_bits(res.values, off_res.values),
                  f"{what}: values differ from the unsplit session's")
            for k in off_res.extra:
                check(same_bits(res.extra[k], off_res.extra[k]),
                      f"{what}: {k} differs from the unsplit session's")
            if name == "sssp":
                check(parents_tight_logical(
                    split, split.vertex_state(name, sweep=sweep, **kw), s0),
                      f"{what}: a parent is not a tight in-edge")
    # Sum programs: the reference test's limits (tests/test_rhizome.py:
    # pagerank rtol 1e-5 / atol 1e-6 at n = 400 and eps = 1e-6; ppr atol
    # 3 eps).  A push fixed point keeps up to eps of residual per vertex,
    # so pagerank's eps scales with 1/n to keep the test's setting (eps
    # 1e-6 for values near 1/400); phase 3's eps = 1e-7 run is compared
    # too, for the record, unchecked.
    eps_pr = 1e-6 * 400 / n
    sums, failed = {}, []
    for name, kw, rtol, atol, checked in (
            ("pagerank", {"eps": 1e-7}, 1e-5, 1e-6, False),
            ("pagerank", {"eps": eps_pr}, 1e-5, 1e-6, True),
            ("ppr", {"source": s0}, 0.0, 3e-4, True)):
        res = run(name, kw, "pull")
        if checked and name == "pagerank":
            off_res = trim(sess.query(name, refresh=True, **kw), n)
        else:
            off_res = results[(name,) + tuple(v for k, v in kw.items()
                                               if k == "source")]
        err = np.abs(res.values.astype(np.float64) - off_res.values)
        limit = atol + rtol * np.abs(off_res.values.astype(np.float64))
        out = int((err > limit).sum())
        worst = int(np.argmax(err - limit))
        sums[f"{name}_eps{kw.get('eps', 1e-4):.3g}"] = {
            "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol,
            "outside": out, "checked": checked, "worst_vertex": worst,
            "worst_unsplit": float(off_res.values[worst]),
            "worst_split": float(res.values[worst]),
            "worst_degree": int(deg[worst])}
        if checked and out:
            failed.append(f"split {name} (eps {kw.get('eps', 1e-4)}): {out} "
                          f"values outside rtol={rtol} atol={atol} of the "
                          f"unsplit session's")
    emit({"phase": "replicas_sums", **sums})
    check(not failed, "; ".join(failed))

    # 16-lane sssp with phase 3d's roots, each lane bitwise its solo query
    before = dict(kernel.LAUNCHES)
    sync(device)
    t = time.perf_counter()
    lanes = split.query("sssp", sources=roots, refresh=True)
    sync(device)
    lanes_s = time.perf_counter() - t
    lane_launches = {k: kernel.LAUNCHES[k] - before[k]
                     for k in kernel.LAUNCHES}
    solo_s = 0.0
    for root, lane in zip(roots, lanes):
        sync(device)
        t = time.perf_counter()
        solo = trim(split.query("sssp", source=root, refresh=True), n)
        sync(device)
        solo_s += time.perf_counter() - t
        lane = trim(lane, n)
        check(same_bits(lane.values, solo.values)
              and same_bits(lane.extra["parent"], solo.extra["parent"]),
              f"split sssp lane {root} differs from its solo query")
    emit({"phase": "replicas_lanes", "lanes": len(roots), "wall_s": lanes_s,
          "solo_wall_s": solo_s, "launches": lane_launches,
          "bitwise_vs_solo": True})

    # one commit around the heaviest hub, with four entries cached
    cached = [("sssp", {"source": s0}), ("bfs", {"source": s0}), ("cc", {}),
              ("ppr", {"source": s0})]
    split.max_cache_entries = len(cached)
    for name, kw in cached:
        split.query(name, refresh=True, **kw)
    rng = np.random.default_rng(args.seed + 5)
    hub = int(hubs[np.argmax(deg[hubs])])
    for a in rng.integers(0, n, 8):
        split.add_edge(int(a), hub, 1.5)
        split.add_edge(hub, int(a), 2.5)
    out_hub = np.flatnonzero(src == hub)
    i = int(rng.choice(out_hub))
    split.delete_edge(hub, int(dst[i]))
    pool = np.setdiff1d(np.nonzero(deg > 0)[0], np.concatenate(
        [hubs, roots]))
    victim = int(rng.choice(pool))
    split.delete_vertex(victim)
    before = dict(kernel.LAUNCHES)
    info = split.commit()
    commit_launches = {k: kernel.LAUNCHES[k] - before[k]
                       for k in kernel.LAUNCHES}
    checks = {}
    for name, kw in cached:
        spec = PROGRAMS[name]
        got = split.vertex_state(name, **kw)
        fresh, _ = diffuse(split.sg, spec.factory(**kw))
        vk = spec.value_key
        live = split.sg.node_ok
        if name == "ppr":
            l1 = float((got[vk] - fresh[vk]).abs()[live].sum())
            limit = int(live.sum()) * 1e-4
            check(l1 <= limit, f"split commit: ppr L1 {l1} > {limit}")
            checks[name] = {"l1": l1, "limit": limit}
            continue
        check(torch.equal(torch.where(live, got[vk], 0),
                          torch.where(live, fresh[vk], 0)),
              f"split commit: repaired {name} differs from a fresh "
              f"diffusion")
        checks[name] = "bitwise"
        if name == "sssp":
            check(parents_tight_logical(split, got, s0),
                  "split commit: a repaired parent is not a tight in-edge")
            checks["sssp_parents"] = "tight"
    launches = dict(kernel.LAUNCHES)
    for r in rows:
        emit({"phase": "replicas_query", **r})
        check(r["converged"], f"split {r['query']} did not converge")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else None)
    emit({"phase": "replicas_commit", "hub": hub, "hub_degree":
          int(deg[hub]), "edge_adds": 16, "edge_deletes": 1,
          "vertex_deletes": 1, "apply_s": info.apply_s,
          "repair_s": info.repair_s,
          "repairs": {k[0]: v[0] for k, v in info.repairs.items()},
          "launches": commit_launches, "checks": checks})
    if device.type == "cuda":
        for k in ("edge_relax_blocks", "edge_relax_scan",
                  "edge_relax_push_blocks"):
            check(launches[k] > 0, f"kernel {k} was not launched on the "
                                   f"split-graph path")
    report = {"phase": "replicas_checks", "ok": True, "launches": launches,
              "sums": sums, "peak_gib": peak,
              "seconds": time.perf_counter() - t0}
    emit(report)
    return report


def phase_oracles(args, device) -> dict:
    """Phase 3f: ``query("triangles")`` on graph500 at ``--tri-scale`` on
    the card against the exact host count, recounted after a commit; and
    ``engine="event"`` (the host oracle) on ``scale_free`` at
    ``--event-n`` against the sharded engine."""
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family
    from repro_torch.core.triangles import triangle_count_exact

    t0 = time.perf_counter()
    src, dst, w, n = make_graph_family("graph500", 1 << args.tri_scale,
                                       seed=0)
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       edge_slack=0.01, device=device)
    sync(device)
    t = time.perf_counter()
    tri = sess.query("triangles")
    sync(device)
    tri_s = time.perf_counter() - t
    t = time.perf_counter()
    exact = triangle_count_exact(src, dst, n)
    exact_s = time.perf_counter() - t
    check(int(tri.values) == exact,
          f"triangles {int(tri.values)} != exact {exact}")
    # a commit: three new pairs closing a triangle and two deleted ones,
    # both directions each (the list stays simple and symmetric)
    rng = np.random.default_rng(args.seed + 7)
    have = set(zip(src.tolist(), dst.tolist()))
    while True:
        a, b, c = (int(x) for x in rng.choice(n, 3, replace=False))
        if not {(a, b), (a, c), (b, c)} & have:
            break
    for u, v in ((a, b), (a, c), (b, c)):
        sess.add_edge(u, v, 1.0)
        sess.add_edge(v, u, 1.0)
    for i in rng.choice(src.shape[0], 2, replace=False):
        sess.delete_edge(int(src[i]), int(dst[i]))
        sess.delete_edge(int(dst[i]), int(src[i]))
    info = sess.commit()
    sync(device)
    key = next(k for k in info.repairs if k[0] == "triangles")
    check(info.repairs[key][0] == "recount", "triangles not recounted")
    es, ed, _ = sess.edge_list()
    recount = int(sess.query("triangles").values)
    exact2 = triangle_count_exact(es, ed, sess.n_ids)
    check(recount == exact2, f"recounted triangles {recount} != exact "
                             f"{exact2}")
    emit({"phase": "triangles", "graph": "graph500",
          "scale": args.tri_scale, "n": n, "edges": int(src.shape[0]),
          "triangles": exact, "card_s": tri_s, "exact_host_s": exact_s,
          "after_commit": recount, "commit_s": info.apply_s + info.repair_s})

    src, dst, w, n = make_graph_family("scale_free", args.event_n, seed=0)
    ev_sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                          device=device)
    rows = {}
    for name, kw in (("sssp", {"source": 0}), ("cc", {}),
                     ("widest", {"source": 0})):
        t = time.perf_counter()
        ev = ev_sess.query(name, engine="event", **kw)
        ev_s = time.perf_counter() - t
        ref = ev_sess.query(name, **kw)
        live = ev.extra["live"]
        got, want = np.asarray(ev.values)[live], ref.values[live]
        if name == "sssp":          # the oracle adds in Python doubles
            check(np.array_equal(np.isfinite(got), np.isfinite(want)),
                  "event sssp: reachability differs from the pull result")
            fin = np.isfinite(want)
            err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
            check(err <= 1e-4, f"event sssp: {err} > atol 1e-4")
        else:
            check(same_bits(got, want), f"event {name}: differs from the "
                                        f"sharded engine")
            err = 0.0
        st = ev.stats
        check(st.ds_terminated and not st.ds_was_premature,
              f"event {name}: Dijkstra-Scholten verdict wrong")
        rows[name] = {"actions": st.actions, "acks": st.acks,
                      "max_queue": st.max_queue, "host_s": ev_s,
                      "max_abs_err": err}
    report = {"phase": "event_oracle", "graph": "scale_free",
              "n": n, "edges": int(src.shape[0]), **rows,
              "seconds": time.perf_counter() - t0}
    emit(report)
    return report


def phase_watchdog(sess, queries, sources, device) -> dict:
    """Phase 3g: on phase 3's graph, an sssp with ``max_rounds=1`` under
    each ``on_budget`` policy (fresh sessions over the same partition, so
    the main session's cache stays whole), and ``validate=True`` on phase
    3's cached results."""
    import warnings

    from repro_torch.core import (
        ConvergenceError,
        ConvergenceWarning,
        DiffusionSession,
    )

    t0 = time.perf_counter()
    s0 = sources[0]
    seen = {}
    for policy in ("raise", "warn", "partial"):
        cut = DiffusionSession(sess.part, max_rounds=1, on_budget=policy)
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            try:
                res = cut.query("sssp", source=s0)
                outcome = "returned"
                check(not bool(res.stats.converged),
                      f"on_budget={policy}: one round converged")
            except ConvergenceError:
                outcome = "raised"
        warned = any(issubclass(x.category, ConvergenceWarning)
                     for x in got)
        seen[policy] = {"outcome": outcome, "warned": warned}
    check(seen["raise"] == {"outcome": "raised", "warned": False},
          f"on_budget='raise': {seen['raise']}")
    check(seen["warn"] == {"outcome": "returned", "warned": True},
          f"on_budget='warn': {seen['warn']}")
    check(seen["partial"] == {"outcome": "returned", "warned": False},
          f"on_budget='partial': {seen['partial']}")
    validated = []
    for name, kw in queries:
        sess.query(name, validate=True, **kw)     # cache hits, re-checked
        validated.append(name)
    report = {"phase": "watchdog", **seen, "validated": validated,
              "seconds": time.perf_counter() - t0}
    emit(report)
    return report


# --------------------------------------------------------------------------
# the SPMD engine (phase 3j) and the analysis layer (phase 3k)
# --------------------------------------------------------------------------

STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")
# the counters spmd and sharded count alike at any cell count (local and
# push iterations are the slowest rank's on spmd, max_frontier the
# largest cell peak)
SPMD_SAME_STATS = ("rounds", "actions", "remote_actions", "operons_sent",
                   "operons_delivered", "frontier_log", "converged")
# the host reads of a warm sssp query on phase 3's session besides one
# poll a round and a sub-iteration (and the last round's check): the
# staged-edge counters, the watchdog's converged flag, and the results'
# copies (dist, parent and the two live-id arrays)
SSSP_QUERY_SYNCS = 6


def stats_row(st) -> dict:
    row = {f: int(getattr(st, f)) for f in (
        "rounds", "local_iters", "actions", "remote_actions", "operons_sent",
        "max_frontier", "push_iters")}
    row["converged"] = bool(st.converged)
    return row


def result_diff(a, b, stats=STAT_FIELDS) -> list:
    """The fields where two Results differ: values, state fields, the
    named DiffuseStats counters."""
    bad = [k for k in ("values", *sorted(b.extra))
           if not same_bits(np.asarray(a.values if k == "values"
                                       else a.extra[k]),
                            np.asarray(b.values if k == "values"
                                       else b.extra[k]))]
    return bad + [f for f in stats if not torch.equal(
        getattr(a.stats, f).cpu(), getattr(b.stats, f).cpu())]


def spmd_rank(rank: int, ranks: int, out_dir: str, n: int, root: int,
              device: str) -> None:
    """One of phase 3j's ranks (``torch.multiprocessing`` spawns it): a
    ``gloo`` rank on the one card, the session built from the parent's
    edges, sssp and cc on pull and auto through ``engine="spmd"``; rank 0
    writes the results and its launch counts."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import DiffusionSession
    from repro_torch.kernels.edge_relax import kernel

    if device == "cuda":
        torch.cuda.set_device(0)
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=300))
    try:
        e = np.load(out / "edges.npy")
        sess = DiffusionSession.from_edges(
            e[0], e[1], n, e[2].view(np.float32), n_cells=ranks,
            device=device)
        kernel.reset_launches()
        arrays, walls = {}, {}
        for name, kw in (("sssp", {"source": root}), ("cc", {})):
            for sweep in ("pull", "auto"):
                sync(torch.device(device))
                t = time.perf_counter()
                r = sess.query(name, engine="spmd", sweep=sweep, **kw)
                sync(torch.device(device))
                walls[f"{name}-{sweep}"] = time.perf_counter() - t
                arrays[f"{name}-{sweep}-values"] = r.values
                for k, v in r.extra.items():
                    arrays[f"{name}-{sweep}-extra-{k}"] = v
                for f in STAT_FIELDS:
                    arrays[f"{name}-{sweep}-{f}"] = getattr(
                        r.stats, f).cpu().numpy()
        if rank == 0:
            np.savez(out / "ranks.npz", **arrays)
            (out / "ranks.json").write_text(json.dumps(
                {"walls": walls, "launches": dict(kernel.LAUNCHES),
                 "backend": dist.get_backend()}))
    finally:
        dist.destroy_process_group()


def phase_spmd(args, sess, data, sources, roots, device) -> dict:
    """Phase 3j: the SPMD engine.  (a) A world of one on the graph500
    session's edges at full width: every min/max builtin on pull and push,
    ppr and pagerank, 4 sssp lanes and a commit through ``engine="spmd"``,
    each held against ``engine="sharded"`` on the same session; (b) K1,
    K2 (laned) and K3 at the per-rank shapes on phase 3's 4-cell session,
    each cell's slice bitwise the logical tables' rows; (c) four ``gloo``
    ranks on the one card against the parent's logical engine."""
    import shutil

    import torch.distributed as dist

    from repro_torch.core import DiffusionSession
    from repro_torch.core.diffuse import sweep_streams
    from repro_torch.core.generators import make_graph_family
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.core.relax import (
        active_push_blocks,
        make_relax,
        push_caps,
        select_bucket,
    )
    from repro_torch.kernels.edge_relax import kernel, ref
    from repro_torch.launch.mesh import cells_group

    t_phase = time.perf_counter()
    src, dst, w, n = data
    s0 = sources[0]

    def timed(fn):
        sync(device)
        t = time.perf_counter()
        out = fn()
        sync(device)
        return out, time.perf_counter() - t

    # (a) a world of one at full width
    (one, group), build_s = timed(lambda: (DiffusionSession.from_edges(
        src, dst, n, w, n_cells=1, edge_slack=max(0.01, 4096 / src.shape[0]),
        node_slack=max(1e-4, 64 / n), device=device),
        cells_group(1, device)))
    emit({"phase": "spmd_setup", "cells": 1, "ranks": 1,
          "backend": dist.get_backend(group),
          "n_per_shard": one.sg.n_per_shard,
          "edges_per_shard": one.sg.edges_per_shard,
          "build_s": build_s})
    launches = {k: 0 for k in kernel.LAUNCHES}
    scans = {k: 0 for k in kernel.SCAN_LAUNCHES}

    def on_spmd(fn):
        """Run ``fn`` (an spmd query) timed; its launches are the path's."""
        before = dict(kernel.LAUNCHES), dict(kernel.SCAN_LAUNCHES)
        out, dt = timed(fn)
        for k in launches:
            launches[k] += kernel.LAUNCHES[k] - before[0][k]
        for k in scans:
            scans[k] += kernel.SCAN_LAUNCHES[k] - before[1][k]
        return out, dt

    kernel.reset_launches()
    rows = []
    for name, kw in (("sssp", {"source": s0}), ("bfs", {"source": s0}),
                     ("cc", {}), ("widest", {"source": s0,
                                             "track_parents": True})):
        for sweep in ("pull", "push"):
            a, ta = on_spmd(lambda: one.query(
                name, engine="spmd", sweep=sweep, refresh=True, **kw))
            b, tb = timed(lambda: one.query(
                name, engine="sharded", sweep=sweep, refresh=True, **kw))
            bad = result_diff(a, b)
            check(not bad, f"3j: spmd {name} {sweep} differs from sharded "
                           f"in {bad}")
            rows.append({"query": name, "sweep": sweep, "spmd_s": ta,
                         "sharded_s": tb, "spmd": stats_row(a.stats),
                         "sharded": stats_row(b.stats)})
    for name, kw, eps in (("ppr", {"source": s0}, 1e-4),
                          ("pagerank", {"eps": 1e-7}, 1e-7)):
        a, ta = on_spmd(lambda: one.query(name, engine="spmd", refresh=True,
                                          **kw))
        b, tb = timed(lambda: one.query(name, engine="sharded",
                                        refresh=True, **kw))
        l1 = float(np.abs(a.values[:n] - b.values[:n]).astype(
            np.float64).sum())
        check(l1 <= n * eps, f"3j: spmd {name} L1 {l1} > n * eps")
        rows.append({"query": name, "sweep": "pull", "spmd_s": ta,
                     "sharded_s": tb, "l1": l1, "limit": n * eps,
                     "bitwise": not result_diff(a, b),
                     "spmd": stats_row(a.stats),
                     "sharded": stats_row(b.stats)})
    lane_roots = roots[:4]
    batch, tl = on_spmd(lambda: one.query(
        "sssp", engine="spmd", sources=lane_roots, refresh=True))
    for r, res in zip(lane_roots, batch):
        solo = one.query("sssp", engine="sharded", source=r, refresh=True)
        bad = result_diff(res, solo, ())
        check(not bad, f"3j: spmd lane {r} differs from its solo sharded "
                       f"query in {bad}")
    rows.append({"query": "sssp", "lanes": len(lane_roots), "spmd_s": tl,
                 "spmd": stats_row(batch[0].stats)})
    for r in rows:
        emit({"phase": "spmd_query", **r})

    # K1, K2 and K3 at the world of one's full width, against their plain
    # versions (these launches are the comparison's, not the path's)
    sssp1 = PROGRAMS["sssp"].factory(source=s0)
    vs1 = one.vertex_state("sssp", engine="spmd", source=s0)
    ppr1 = PROGRAMS["ppr"].factory(source=s0)
    pvs1 = one.vertex_state("ppr", engine="spmd", source=s0)
    full_width = {
        "k1": compare_k1(one, sssp1, vs1, random_senders(one, args.seed + 34)),
        "k2": compare_k2(one, ppr1, pvs1, random_senders(one, args.seed + 35)),
        "k3": compare_k3(one, sssp1, vs1, random_senders(
            one, args.seed + 36, 0.01))}
    emit({"phase": "spmd_full_width", "n_keys": one.sg.n_per_shard,
          "plain": "bitwise", **full_width})

    # a commit with spmd entries cached: restart repairs rerun on spmd,
    # warm ones on the logical engine
    part = one.part
    del one
    dur = DiffusionSession(part, engine="spmd")
    cached = [("sssp", {"source": s0}), ("cc", {}), ("ppr", {"source": s0})]
    for name, kw in cached:
        on_spmd(lambda: dur.query(name, **kw))
    stage(dur, edge_batch(src, dst, n, np.random.default_rng(args.seed + 20)))
    info, commit_s = on_spmd(dur.commit)
    strategies = {key[0]: s for key, (s, _) in info.repairs.items()}
    check(strategies.get("ppr") == "restart" and
          strategies.get("sssp") not in (None, "restart", "noop"),
          f"3j: commit repairs {strategies}")
    for name, kw in cached:
        got = dur.query(name, **kw)
        fresh = DiffusionSession(part, engine="spmd").query(name, **kw)
        bad = result_diff(got, fresh, ("converged",))
        check(not bad, f"3j: repaired spmd {name} differs from a fresh "
                       f"spmd diffusion in {bad}")
        if name != "ppr":
            logical = DiffusionSession(part).query(name, **kw)
            check(same_bits(got.values, logical.values),
                  f"3j: repaired spmd {name} differs from sharded")
    commit = {"phase": "spmd_commit", "ops": len(info.applied.edge_adds)
              + len(info.applied.edge_deletes), "repairs": strategies,
              "apply_s": info.apply_s, "repair_s": info.repair_s,
              "wall_s": commit_s}
    emit(commit)
    del dur, part
    dist.destroy_process_group()
    path_launches = {"launches": {k: v for k, v in launches.items() if v},
                     "scan_launches": {k: v for k, v in scans.items() if v}}
    if device.type == "cuda":
        for k in ("edge_relax_blocks", "edge_relax_scan",
                  "edge_relax_push_blocks"):
            check(launches[k] > 0, f"3j: the spmd path launched no {k}")
        for k in ("sum", "min/max+payload/laned"):
            check(scans[k] > 0, f"3j: the spmd path launched no K2 {k}")
    emit({"phase": "spmd_launches", **path_launches})
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (b) K1, K2 (laned) and K3 at the per-rank shapes, no collective
    sg = sess.sg
    S, Np, block = sg.n_shards, sg.n_per_shard, sg.csr_block
    sssp = PROGRAMS["sssp"].factory(source=s0)
    vstate = sess.vertex_state("sssp", source=s0)
    per_rank = {}

    def plain_at(tag, prog, vs, senders, sgd, delta_e, bucket):
        """The kernel under ``tag`` on one rank's inputs against its plain
        version on the same inputs, bitwise (``hold_k1``/``hold_k2``/
        ``hold_k3``)."""
        n_keys = S * Np
        if tag == "K1":
            return hold_k1((prog, vs, senders, sgd["gid"], sgd["csr_key"],
                            sgd["csr_src"], sgd["csr_weight"],
                            sgd["csr_dst_gid"]), n_keys, f"3j per-rank {tag}")
        if tag == "K3":
            idx, valid = ref.compact_push_blocks(
                senders, sgd["push_src"], block,
                push_caps(sgd["push_src"].shape[-1] // block)[bucket])
            return hold_k3((prog, vs, senders, sgd["gid"], sgd["push_key"],
                            sgd["push_src"], sgd["push_weight"],
                            sgd["push_dst_gid"], idx), valid, n_keys,
                           f"3j per-rank {tag}", block)
        es = sgd["csr_key"].shape[-1] - delta_e
        cut = lambda k: sgd[k][..., :es]
        return hold_k2((prog, vs, senders, sgd["gid"], cut("csr_key"),
                        cut("csr_src"), cut("csr_weight"),
                        cut("csr_dst_gid")), cut("csr_skey"),
                       f"3j per-rank {tag}")

    def hold(tag, prog, vs, senders, sweep, bucket_of=None):
        """Each cell's per-rank relax (the kernel under ``tag`` at one
        source row against S * Np keys) bitwise the logical tables' row
        ``[c]``, and that kernel on the rank's inputs bitwise its plain
        version."""
        sgd, delta_e = sweep_streams(sg, with_push=sweep != "pull")
        relax = make_relax(prog, S, Np, block, delta_e=delta_e, sweep=sweep)
        row_of = lambda d, c: {k: v if k == "replica_members"
                               else v[c:c + 1] for k, v in d.items()}
        whole = relax(vs, senders, sgd,
                      bucket_of(senders, sgd) if bucket_of else None)
        buckets, errs = [], []
        for c in range(S):
            mine, vs_c = row_of(sgd, c), row_of(vs, c)
            b = bucket_of(senders[c:c + 1], mine) if bucket_of else None
            buckets.append(b)
            part_ = relax(vs_c, senders[c:c + 1], mine, b)
            for x, y, what in zip(part_, whole, ("table", "cnt", "pay")):
                if y is None:
                    continue
                check(torch.equal(x, y[c:c + 1]),
                      f"3j: {tag} cell {c}: the per-rank {what} differs "
                      f"from the logical row")
            errs.append(plain_at(tag.split()[0], prog, vs_c,
                                 senders[c:c + 1], mine, delta_e, b))
        per_rank[tag] = {"shape": list(part_[0].shape), "buckets": buckets,
                         "delta_e": delta_e, "plain": "bitwise",
                         "vs_plain": errs}

    nb = sweep_streams(sg, with_push=True)[0]["push_src"].shape[-1] // block

    def push_bucket(senders, sgd):
        got = int(active_push_blocks(senders, sgd["push_src"], block).max())
        return select_bucket(got, nb, "push")

    before = dict(kernel.LAUNCHES), dict(kernel.SCAN_LAUNCHES)
    hold("K1", sssp, vstate, random_senders(sess, args.seed + 31), "pull")
    laned = make_laned([PROGRAMS["sssp"].factory(source=r)
                        for r in lane_roots])
    lvs, lsend = random_lane_state(laned, (S, len(lane_roots), Np),
                                   args.seed + 32, device)
    hold("K2 laned", laned, lvs, lsend & sg.node_ok[:, None], "pull")
    hold("K3", sssp, vstate, random_senders(sess, args.seed + 33, 0.01),
         "push", push_bucket)
    per_rank["caps"] = len(push_caps(nb))
    per_rank["launches"] = {
        k: kernel.LAUNCHES[k] - before[0][k] for k in
        ("edge_relax_blocks", "edge_relax_scan", "edge_relax_push_blocks")}
    if device.type == "cuda":
        for k, v in per_rank["launches"].items():
            check(v > 0, f"3j: the per-rank comparison launched no {k}")
    emit({"phase": "spmd_per_rank", **per_rank})

    # (c) four gloo ranks on the one card
    out_dir = OUT_DIR / "spmd_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    s16, d16, w16, n16 = make_graph_family(
        "graph500", 1 << args.spmd_scale, seed=0)
    np.save(out_dir / "edges.npy", np.stack([s16, d16, w16.view(np.int32)]))
    deg = np.bincount(s16, minlength=n16)
    root = int(np.random.default_rng(args.seed).choice(np.nonzero(deg)[0]))
    ref = DiffusionSession.from_edges(s16, d16, n16, w16, n_cells=4,
                                      device=device)
    t = time.perf_counter()
    torch.multiprocessing.spawn(spmd_rank, args=(4, str(out_dir), n16, root,
                                                 device.type),
                                nprocs=4, join=True)
    spawn_s = time.perf_counter() - t
    got = dict(np.load(out_dir / "ranks.npz"))
    meta = json.loads((out_dir / "ranks.json").read_text())
    ranks_rows = []
    for name, kw in (("sssp", {"source": root}), ("cc", {})):
        for sweep in ("pull", "auto"):
            want, ts = timed(lambda: ref.query(name, sweep=sweep, **kw))
            key = f"{name}-{sweep}"
            check(same_bits(got[f"{key}-values"], want.values),
                  f"3j: 4 ranks {key} values differ from sharded")
            for k, v in want.extra.items():
                check(same_bits(got[f"{key}-extra-{k}"], v),
                      f"3j: 4 ranks {key} {k} differs from sharded")
            for f in SPMD_SAME_STATS:
                check(np.array_equal(got[f"{key}-{f}"],
                                     getattr(want.stats, f).cpu().numpy()),
                      f"3j: 4 ranks {key} {f} differs from sharded")
            ranks_rows.append({"query": key, "spmd_s": meta["walls"][key],
                               "sharded_s": ts,
                               "spmd_local_iters": int(
                                   got[f"{key}-local_iters"]),
                               "sharded_local_iters": int(
                                   want.stats.local_iters)})
    shutil.rmtree(out_dir, ignore_errors=True)
    ranks = {"phase": "spmd_ranks", "ranks": 4, "backend": meta["backend"],
             "scale": args.spmd_scale, "n": n16, "edges": int(s16.shape[0]),
             "spawn_s": spawn_s, "rank0_launches": {
                 k: v for k, v in meta["launches"].items() if v},
             "queries": ranks_rows,
             "note": "gloo stages CUDA tensors through the host: these "
                     "walls are no exchange speed"}
    emit(ranks)
    report = {"phase": "spmd_checks", "ok": True, **path_launches,
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    return {"queries": rows, "commit": commit, "per_rank": per_rank,
            "ranks": ranks, **report}


def register_probe() -> str:
    """A user program no earlier phase built: sssp with the message
    ``dist + 0.5 w + 1``, on the generic instance."""
    from repro_torch.core import programs as P

    if "sanitize_probe" not in P.PROGRAMS:
        @P.diffusive("sanitize_probe", value_key="dist", monotone=True,
                     lane_param="source")
        def probe(source: int) -> P.DiffusiveProgram:
            def receive(vstate, inbox, has_msg, payload, node_ok):
                better = has_msg & (inbox < vstate["dist"]) & node_ok
                return ({"dist": torch.where(better, inbox, vstate["dist"])},
                        better)

            return P.DiffusiveProgram(
                monoid="min", msg_dtype=torch.float32,
                state={"dist": P.Field(torch.float32,
                                       init=lambda v: torch.where(
                                           v.gid == source, 0.0,
                                           float("inf")),
                                       on_dead=float("inf"))},
                init_active=lambda v: v.gid == source,
                emit=lambda s, weight, src_gid, dst_gid:
                    s["dist"] + 0.5 * weight + 1.0,
                receive=receive)
    return "sanitize_probe"


def phase_sanitize(args, sess, roots, device) -> dict:
    """Phase 3k: the sanitizer and the lint pass on phase 3's session: a
    warm sssp pull query under ``sanitize(transfers="log")`` (syncs within
    the budget, no rebuild), a warm 4-lane query with other roots (no
    rebuild), a cold generic program (``RetraceError``), an ``.item()``
    under ``"disallow"`` (raises), and the lint CLI on the port's tree."""
    import collections
    import os

    from repro_torch.analysis import RetraceError, sanitize
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    s = roots[5]
    with sanitize(transfers="log") as rep:
        res = sess.query("sssp", source=s, refresh=True)
    st = res.stats
    budget = int(st.rounds) + int(st.local_iters) + 1 + SSSP_QUERY_SYNCS
    check(rep.guarded == cuda, f"3k: the sync mode guarded={rep.guarded}")
    check(rep.syncs() <= budget,
          f"3k: a warm sssp query made {rep.syncs()} syncs, budget "
          f"{budget}: {collections.Counter(rep.sync_sites())}")
    warm = {"source": s, "syncs": rep.syncs(), "budget": budget,
            "rounds": int(st.rounds), "local_iters": int(st.local_iters),
            "rebuilds": rep.total_retraces(),
            "sites": dict(collections.Counter(
                site.replace(str(ROOT) + "/", "")
                for site in rep.sync_sites()))}
    with sanitize(transfers=None) as rep:
        sess.query("sssp", sources=roots[8:12], refresh=True)
    lanes = {"roots": roots[8:12], "rebuilds": rep.total_retraces()}

    g_src, g_dst, g_w, g_n = make_graph_family("scale_free", 4096, seed=1)
    small = DiffusionSession.from_edges(g_src, g_dst, g_n, g_w, n_cells=4,
                                        device=device)
    name = register_probe()
    t = time.perf_counter()
    cold = "returned"
    try:
        with sanitize(transfers=None):
            small.query(name, source=0)
    except RetraceError as e:
        cold = str(e)
    cold_s = time.perf_counter() - t
    check(cold != "returned" or not cuda,
          "3k: a cold generic program inside sanitize() did not raise")
    x = torch.arange(4, device=device)
    disallow = "returned"
    try:
        with sanitize(transfers="disallow", retraces=False):
            x.sum().item()
    except RuntimeError as e:
        disallow = str(e)
    check("synchronizing" in disallow or not cuda,
          f"3k: .item() under 'disallow': {disallow[:200]}")
    t = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         "src/repro_torch/core", "src/repro_torch/kernels"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(lint.returncode == 0, f"3k: lint exit {lint.returncode}: "
                                f"{lint.stdout[-2000:]}{lint.stderr[-500:]}")
    report = {"phase": "sanitize", "ok": True, "warm_query": warm,
              "warm_lanes": lanes, "cold_generic": cold[:300],
              "cold_generic_s": cold_s, "disallow": disallow[:200],
              "lint_exit": lint.returncode,
              "lint_s": time.perf_counter() - t,
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    return report


# --------------------------------------------------------------------------
# timing at the main path's shapes
# --------------------------------------------------------------------------

def device_kernels_per_call(fn) -> dict:
    """The device kernels (by name, and the memsets) that one call of
    ``fn`` runs, from a ``torch.profiler`` trace; {} off the card."""
    if not torch.cuda.is_available():
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def phase_timing(sess, launches, sources, device, reps: int) -> list:
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel, ref

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    es = sg.sorted_width                   # the swept width (no staged edges)
    n_keys = S * Np
    senders = sg.node_ok.clone()           # a full frontier sweep
    rows = []

    # K1 on sssp with parents (the heaviest min/max form)
    kw = {"source": sources[0]}
    prog = PROGRAMS["sssp"].factory(**kw)
    sess.query("sssp", **kw)
    vstate = sess.vertex_state("sssp", **kw)
    _, args = stream_inputs(sess, prog, vstate, senders)
    err = compare_k1(sess, prog, vstate, senders)
    kernel.reset_launches()                 # timing launches never count
    k1 = lambda: kernel.edge_relax_blocks(*args, n_keys)
    k_ms = clock.ms(k1, reps)
    plain = lambda: ref.combine_blocks(
        *ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E), n_keys,
        prog.combine)
    p_ms = clock.ms(plain, max(2, reps // 10), warmup=1)
    # what the tables replaced: phase 2 alone (ref.combine_blocks over the
    # plain partials, on the card), and the dense-rank block body over every
    # block (K3's kernel with every block listed, bitwise the former K1)
    # with phase 2 after it
    parts = ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E)
    p2_ms = clock.ms(lambda: ref.combine_blocks(*parts, n_keys,
                                                prog.combine), reps)
    del parts
    nb = es // kernel.BLOCK_E
    every = torch.arange(nb, dtype=torch.int32, device=device).expand(
        S, nb).contiguous()
    blocks = lambda: kernel.edge_relax_push_blocks(*args, every)
    blocks_p2 = lambda: ref.combine_blocks(*blocks(), n_keys, prog.combine)
    for g, w_ in zip(blocks_p2(), k1()):
        check(torch.equal(g, w_), "K1's tables differ from the block body "
                                  "and phase 2")
    blocks_ms = clock.ms(blocks, reps)
    blocks_p2_ms = clock.ms(blocks_p2, reps)
    cand, send, _ = ref.edge_messages(*args)
    ids = torch.where(send, args[4], n_keys).long()
    ids = ids + torch.arange(S, device=device)[:, None] * (n_keys + 1)
    flat_c, flat_i = cand.reshape(-1), ids.reshape(-1)
    table = torch.empty(S * (n_keys + 1), dtype=cand.dtype, device=device)
    lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
        0, flat_i, flat_c, "amin"), reps)
    del cand, send, ids, flat_c, flat_i, table
    # each byte once: the stream (key, src, weight), the vertex block
    # (senders, dist, gid) and the tables (table, cnt, pay)
    k1_bytes = S * es * (4 + 4 + 4) + S * Np * (1 + 4 + 4) \
        + S * n_keys * (4 + 4 + 4)
    k1_ops = S * es * 6
    rows.append(kernel_row(
        "edge_relax_blocks", "src/repro_torch/kernels/edge_relax/csrc/"
        "edge_relax_tables.cu", "src/repro/kernels/edge_relax/kernel.py:220",
        launches["edge_relax_blocks"], err, k_ms, p_ms, k1_bytes, k1_ops,
        lib_ms))
    emit({"phase": "k1_timing", "program": "sssp+parents", "cells": S,
          "width": es, "n_keys": n_keys, "ms": k_ms,
          "phase2_alone_ms": p2_ms,
          "block_body_ms": blocks_ms,
          "block_body_plus_phase2_ms": blocks_p2_ms,
          "device_kernels_per_call": device_kernels_per_call(k1),
          "block_body_plus_phase2_device_kernels":
              device_kernels_per_call(blocks_p2),
          **{k: rows[-1][k] for k in ("plain_ms", "bound_ms", "library_ms",
                                      "bytes")}})

    # K2 on pagerank's full first sweep
    prog = PROGRAMS["pagerank"].factory(eps=1e-7)
    vstate, _ = prog.init(sg)
    skey, args = stream_inputs(sess, prog, vstate, senders)
    err = compare_k2(sess, prog, vstate, senders)
    kernel.reset_launches()
    k_ms = clock.ms(lambda: kernel.edge_relax_scan(*args, skey=skey), reps)
    p_ms = clock.ms(lambda: ref.edge_relax_scan_ref(*args, skey=skey),
                    max(2, reps // 10), warmup=1)
    cand, _, _ = ref.edge_messages(*args)
    k = skey.reshape(-1)
    runs = torch.ones_like(k, dtype=torch.bool)
    runs[1:] = k[1:] != k[:-1]
    starts = torch.nonzero(runs).reshape(-1)
    lengths = torch.diff(starts, append=torch.tensor([k.numel()],
                                                      device=device))
    flat = cand.reshape(-1).contiguous()
    lib_ms = clock.ms(lambda: torch.segment_reduce(flat, "sum",
                                                   lengths=lengths), reps)
    k2_bytes = S * es * (4 + 4 + 4) + S * Np * (1 + 4 + 4) + S * es * (4 + 4)
    k2_ops = S * es * (2 + 2 * 10)
    rows.append(kernel_row(
        "edge_relax_scan", "src/repro_torch/kernels/edge_relax/csrc/"
        "edge_relax_scan.cu", "src/repro/kernels/edge_relax/kernel.py:97",
        launches["edge_relax_scan"], err, k_ms, p_ms, k2_bytes, k2_ops,
        lib_ms))
    emit({"phase": "k2_timing", "program": "pagerank", "cells": S,
          "width": es, "device_kernels_per_call": device_kernels_per_call(
              lambda: kernel.edge_relax_scan(*args, skey=skey)),
          **{k: rows[-1][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "bytes")}})
    return rows


def phase_k2_lanes_timing(sess, roots, launches: int, device,
                          reps: int) -> dict:
    """Phase 4f: K2's laned payload instance at phase 3d's sssp shape (16
    lanes of sssp with parents over every cell's sorted region, the lanes'
    fixed-point distances, a full frontier): held bitwise against its
    plain version, then timed against it, its byte bound and
    ``scatter_reduce_`` amin over the same [S * L, E] messages (the
    yardstick computes the values only, not the counts or the payload)."""
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.kernels.edge_relax import kernel, ref

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    es = sg.sorted_width
    n_keys = S * Np
    L = len(roots)
    prog = make_laned([PROGRAMS["sssp"].factory(source=r) for r in roots])
    states = [sess.vertex_state("sssp", source=r) for r in roots]
    vstate = {k: torch.stack([st[k] for st in states], dim=1)
              for k in states[0]}
    senders = sg.node_ok[:, None].expand(S, L, Np).contiguous()
    skey, args = stream_inputs(sess, prog, vstate, senders)
    got = kernel.edge_relax_scan(*args, skey=skey)
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    sync(device)
    for g, w_, what in zip(got, want, ("value", "count", "payload")):
        check(torch.equal(g, w_), f"K2 laned payload at the lanes shape: "
                                  f"{what} differs from the plain version")
    fin = torch.isfinite(want[0])
    err = float((got[0] - want[0])[fin].abs().max()) if bool(fin.any()) \
        else 0.0
    del got, want
    kernel.reset_launches()                 # timing launches never count
    k_ms = clock.ms(lambda: kernel.edge_relax_scan(*args, skey=skey), reps)
    p_ms = clock.ms(lambda: ref.edge_relax_scan_ref(*args, skey=skey),
                    max(2, reps // 10), warmup=1)
    cand, send, _ = ref.edge_messages(*args)
    ids = torch.where(send, args[4][:, None], n_keys).long()
    rows = torch.arange(S * L, device=device).view(S, L, 1)
    flat_i = (ids + rows * (n_keys + 1)).reshape(-1)
    flat_c = cand.reshape(-1)
    del ids, send
    table = torch.empty(S * L * (n_keys + 1), dtype=cand.dtype,
                        device=device)
    lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
        0, flat_i, flat_c, "amin"), reps)
    del cand, flat_i, flat_c, table
    # each byte once: the shared stream (key, skey, src, weight), the
    # lanes' dist and senders and the cells' gid, the [S, L, E] value,
    # count and payload outputs
    nbytes = S * es * 16 + S * L * Np * 5 + S * Np * 4 + S * L * es * 12
    ops = S * L * es * (1 + 3 * 10)
    row = kernel_row(
        "edge_relax_scan (laned, payload)", "src/repro_torch/kernels/"
        "edge_relax/csrc/edge_relax_scan.cu",
        "src/repro/kernels/edge_relax/kernel.py:97", launches, err, k_ms,
        p_ms, nbytes, ops, lib_ms)
    per_call = device_kernels_per_call(
        lambda: kernel.edge_relax_scan(*args, skey=skey))
    emit({"phase": "k2_lanes_timing", "lanes": L, "cells": S, "width": es,
          "elements": S * L * es, "library": "scatter_reduce_ amin, values "
          "only", "device_kernels_per_call": per_call,
          **{k: row[k] for k in ("launches", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "bytes")}})
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def phase_k3_timing(sess, launches, sources, frontier0, device,
                    reps: int) -> tuple:
    """Phase 4b: K3 at the shape of the first repair sub-iteration (the
    first commit's sssp repair: the added edges' sources on the committed
    graph) and at a full frontier (cap = nb), beside the frontier selector
    at the same shapes.  Returns (the kernels-line row at the full
    frontier, the per-shape detail)."""
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.core.relax import active_push_blocks
    from repro_torch.kernels.edge_relax import kernel, ref

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    n_keys = S * Np
    be = kernel.BLOCK_E
    kw = {"source": sources[0]}
    prog = PROGRAMS["sssp"].factory(**kw)
    vstate = sess.vertex_state("sssp", **kw)
    first = torch.zeros_like(sg.node_ok)
    for u in frontier0:
        first[sess.ns.resolve(int(u))] = True
    first &= sg.node_ok
    nb = sg.csr_key.shape[-1] // be
    detail, row = {}, None
    for label, senders, cap in (("first_repair", first, None),
                                ("full", sg.node_ok.clone(), nb)):
        check_k3 = compare_k3(sess, prog, vstate, senders, cap)
        sgd, idx, valid, args = push_inputs(sess, prog, vstate, senders, cap)
        cap = int(idx.shape[-1])
        kernel.reset_launches()              # timing launches never count
        k_ms = clock.ms(lambda: kernel.edge_relax_push_blocks(*args), reps)
        p_ms = clock.ms(lambda: ref.edge_relax_push_blocks_ref(
            *args, block_e=be), max(2, reps // 10), warmup=1)
        sel_ms = clock.ms(lambda: active_push_blocks(
            senders, sgd["push_src"], be), reps)
        cmp_ms = clock.ms(lambda: ref.compact_push_blocks(
            senders, sgd["push_src"], be, cap), reps)
        g, _ = ref.push_gather(sgd, idx, be)
        cand, send, _ = ref.edge_messages(prog, vstate, senders, sgd["gid"],
                                          g["key"], g["src"], g["weight"],
                                          g["dst_gid"])
        ids = torch.where(send, g["key"], n_keys).long()
        ids = ids + torch.arange(S, device=device)[:, None] * (n_keys + 1)
        flat_c, flat_i = cand.reshape(-1), ids.reshape(-1)
        table = torch.empty(S * (n_keys + 1), dtype=cand.dtype,
                            device=device)
        lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
            0, flat_i, flat_c, "amin"), reps)
        # bytes each read once: the block list, the swept (real) blocks'
        # key/src/weight, each distinct source vertex's senders/dist/gid,
        # and the [S, cap, 128] outputs (part/cnt/uniq/pay)
        n_real = int(valid.sum())
        keyed = g["src"].clamp(min=0) + torch.arange(
            S, device=device)[:, None] * Np
        distinct = int(torch.unique(keyed[g["key"] >= 0]).numel())
        nbytes = (S * cap * 4 + n_real * be * 12 + distinct * 9
                  + S * cap * be * 16)
        ops = S * cap * be * 6
        r = kernel_row(
            "edge_relax_push_blocks", "src/repro_torch/kernels/edge_relax/"
            "csrc/edge_relax_push_blocks.cu",
            "src/repro/kernels/edge_relax/kernel.py:155",
            launches, check_k3["max_abs_err"], k_ms, p_ms, nbytes, ops,
            lib_ms)
        detail[label] = {**r, "cap": cap, "active_blocks": n_real,
                         "fill_slots": int((~valid).sum()),
                         "frontier": int(senders.sum()),
                         "selector_ms": sel_ms, "compaction_ms": cmp_ms}
        emit({"phase": "k3_timing", "shape": label, **detail[label]})
        if label == "full":
            row = r
    return row, detail


def k5_device_ms(events) -> tuple[float, float]:
    """K5's calls in a trace: (the time some K5 kernel is on the card,
    overlaps counted once; the sum over calls of the span from the start
    of a call's ``chunk_sums`` to the end of its last ``fold_level``, which
    also holds the gaps where the card waits for the host's launches)."""
    from torch.autograd import DeviceType

    mine = sorted(((e.time_range.start, e.time_range.end,
                    "chunk_sums" in e.name) for e in events
                   if e.device_type == DeviceType.CUDA and (
                       "chunk_sums" in e.name or "fold_level" in e.name)))
    busy = span = 0.0
    lo = hi = first = None
    for a, b, is_first in mine:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        hi = max(hi, b)
        if is_first:
            span += 0.0 if first is None else last - first
            first, last = a, b
        last = max(last, b)
    if hi is not None:
        busy += hi - lo
        span += last - first
    return busy / 1e3, span / 1e3


def trace(name: str, run) -> dict:
    """One ``torch.profiler`` trace of ``run()``: device time by kernel, the
    ``repro_torch.*`` ranges, and the device busy share of the wall time
    (the table goes under chiprun_out/)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    avg = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    tot = lambda e: getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0))
    # a range has a host row (calls, host time) and a device row (the time
    # of its kernels outside the ranges nested in it)
    ranges = {}
    for e in avg:
        if e.key.startswith("repro_torch."):
            r = ranges.setdefault(e.key, {"device_ms": 0.0, "calls": 0,
                                          "cpu_ms": 0.0})
            if e.device_type == DeviceType.CUDA:
                r["device_ms"] = tot(e) / 1e3
            else:
                r["calls"], r["cpu_ms"] = e.count, e.cpu_time_total / 1e3
    # device-side events only: an aten op's row repeats its kernels' time,
    # and a range's device-side row (its kernels, outside nested ranges)
    # repeats theirs
    rows = sorted(((e.key, dev(e) / 1e3, e.count) for e in avg
                   if e.device_type == DeviceType.CUDA and dev(e) > 0
                   and not e.key.startswith("repro_torch.")),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    # K5's level kernels start early (programmatic launch) and wait, so
    # its kernels' durations overlap: count that time once
    k5_kernel_ms = sum(r[1] for r in rows
                       if "chunk_sums" in r[0] or "fold_level" in r[0])
    k5_ms, k5_span = k5_device_ms(prof.events()) if k5_kernel_ms else (
        0.0, 0.0)
    busy_ms -= k5_kernel_ms - k5_ms
    # K1's, K2's, K4's and K5's device time and their share of the busy
    # and wall time
    shares = {}
    for label, frags in (("K1", ("tables_kernel",)), ("K2", ("scan_pass",)),
                         ("K4", ("flash_fwd",)),
                         ("K5", ("chunk_sums", "fold_level"))):
        mine = [r for r in rows if any(f in r[0] for f in frags)]
        ms = k5_ms if label == "K5" else sum(r[1] for r in mine)
        shares[label] = {"device_ms": ms,
                         "launches": sum(r[2] for r in mine),
                         "share_of_busy": ms / busy_ms if busy_ms else 0.0,
                         "share_of_wall": ms / (wall * 1e3)}
    shares["K5"].update(kernel_ms=k5_kernel_ms, span_ms=k5_span)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"profile_{name}.txt").write_text(avg.table(
        sort_by="self_cuda_time_total", row_limit=40))
    return {"phase": "profile", "query": name, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "kernel_launches": sum(r[2] for r in rows), "ranges": ranges,
            "kernel_shares": shares,
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def phase_profile(sess, sources, roots, n: int) -> list:
    """Where the time goes: one trace per query (phase 3d's 16-lane sssp
    on pull and push among them), and one of a commit's push repair (64
    edge adds, sssp alone cached) with the device time under the frontier
    selector's and the compaction's ranges."""
    s0 = sources[0]
    rng = np.random.default_rng(99)

    def commit():
        sess.max_cache_entries = 1           # sssp alone is repaired
        sess.query("sssp", refresh=True, source=s0)
        torch.cuda.synchronize()
        for a, b in rng.integers(0, n, (64, 2)):
            sess.add_edge(int(a), int(b), 2.0)
        return sess.commit

    out = []
    for name, run in (("sssp", lambda: sess.query("sssp", refresh=True,
                                                  source=s0)),
                      ("pagerank", lambda: sess.query("pagerank",
                                                      refresh=True,
                                                      eps=1e-7)),
                      ("lanes_sssp_pull", lambda: sess.query(
                          "sssp", sources=roots, refresh=True)),
                      ("lanes_sssp_push", lambda: sess.query(
                          "sssp", sources=roots, sweep="push",
                          refresh=True)),
                      ("commit_repair", None)):
        out.append(trace(name, run if run is not None else commit()))
    return out


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               ops, library_ms, peak_ops=PEAK_F32_OPS_PER_S) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": int(nbytes), "ops": int(ops)}



# --------------------------------------------------------------------------
# K4-K6: kernels against their plain versions, entry points and timings
# --------------------------------------------------------------------------

K4_F32_TOL = 2e-5
K4_BF16_ULP = 2.0 ** -7
K4_BF16_P = 2.0 ** -8


def k4_err(got, want, q=None, k=None, v=None, **kw) -> tuple:
    """(max abs error, within tolerance) of K4 against its plain version
    ``flash_attention_ref`` on the same inputs (``kw``: its masks).

    f32: both run the same online softmax in f32 and differ by sums in
    other orders: 2e-5 max abs on N(0, 1) inputs (sound runs: 7.5e-7).

    bf16, per element: |got - want| <= 2^-7 |want| + 2^-8 A + 2e-5, with
    A = ``flash_attention_ref(q, k, |v|)`` under the same masks.  The
    kernel rounds P to bf16 before P V (the plain version keeps P in f32;
    JAX's default matmul precision rounds f32 dot operands to bf16 on the
    TPU's MXU too): each weight moves by at most 2^-9 of itself, so an
    output moves by at most 2^-9 (sum_j p_j |v_j|) / l = 2^-9 A.  The
    limit takes twice that, one bf16 ulp of the output (2^-7 relative:
    each side rounds its f32 result once) and the f32 limit.  A limit of
    one ulp alone, 2^-7 |want| + 2e-5, has no A term and fails near
    outputs close to zero, whose error is set by the |v| they average."""
    from repro_torch.kernels.flash_attention import ref

    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        limit = K4_F32_TOL
    else:
        a = ref.flash_attention_ref(q, k, v.abs(), **kw).float()
        limit = K4_BF16_ULP * want.float().abs() + K4_BF16_P * a + K4_F32_TOL
    return float(diff.max()), bool((diff <= limit).all())


def k4_sass_check() -> dict:
    """The bf16 instances of K4 run both products on the tensor cores: the
    SASS of each ``flash_fwd_wgmma`` function in the built library (from
    ``cuobjdump -sass``) holds HGMMA instructions, and the f32 instances
    (``flash_fwd``) hold none.  Returns the HGMMA count per function."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as k4

    lib = _build.library_paths(k4.KERNEL_SOURCES)["flash_attention"]
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        inst = re.search(r"flash_fwd(_wgmma)?ILi(\d+)E", name)
        if inst:
            kind = "bf16" if inst.group(1) else "f32"
            counts[f"{kind}/D{inst.group(2)}"] = chunk.count("HGMMA")
    for d in (64, 128):
        check(counts.get(f"bf16/D{d}", 0) > 0,
              f"K4's bf16 D={d} instance has no HGMMA in its SASS: {counts}")
        check(counts.get(f"f32/D{d}", -1) == 0,
              f"K4's f32 D={d} instance is missing or uses HGMMA: {counts}")
    return counts


def phase_k4_vs_plain(device) -> dict:
    """K4 against its plain version on the card: bf16 and f32, D = 64 and
    128, causal or not, softcap 0 and 30, GQA groups 1 and 8, sq == skv
    and sq < skv, within the tolerance of :func:`k4_err`."""
    from repro_torch.kernels.flash_attention import kernel, ref

    g = torch.Generator(device="cpu").manual_seed(4)
    worst = {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for groups in (1, 8):
                for sq, skv in ((192, 192), (100, 300)):
                    q, k, v = (torch.randn(shape, generator=g).to(device,
                                                                 dtype)
                               for shape in ((2, 2 * groups, sq, d),
                                             (2, 2, skv, d), (2, 2, skv, d)))
                    for causal in (True, False):
                        for cap in (0.0, 30.0):
                            kw = dict(causal=causal, softcap=cap,
                                      q_offset=skv - sq)
                            got = kernel.flash_attention(q, k, v, **kw)
                            want = ref.flash_attention_ref(q, k, v, **kw)
                            sync(device)
                            err, ok = k4_err(got, want, q, k, v, **kw)
                            tag = str(dtype).split(".")[-1]
                            check(got.dtype == dtype and ok,
                                  f"K4 {tag} d={d} g={groups} sq={sq} "
                                  f"skv={skv} causal={causal} softcap={cap}:"
                                  f" max abs err {err}")
                            worst[tag] = max(worst.get(tag, 0.0), err)
                            n += 1
    return {"cases": n, "max_abs_err": worst,
            "tolerance": {"float32": K4_F32_TOL,
                          "bfloat16": "2^-7 |want| + 2^-8 A + 2e-5, A = "
                                      "the plain version on |v|"}}


# phase 4h: K4's gradient.  Twice the 2^-9 rounding of the recomputed out
# (bf16) that the backward's delta reads, as K4_BF16_P is twice K4's P
# rounding
K4_GRAD_P = 2.0 ** -8


def k4_grad_err(got, want, q, k, v, dout, causal: bool,
                softcap: float) -> tuple:
    """({"dq", "dk", "dv"}: max abs error, all within tolerance) of the
    port's attention gradient (K4 forward, the chunked backward) against
    autograd through K4's plain version on the same inputs.

    float32: 2e-5 (K4's f32 limit) plus 2e-5 of the largest |grad| (f32
    products over up to 4096 keys and a group's heads, in other orders).

    bf16, per element: |got - want| <= 2^-7 |want| + 2^-8 B + the f32
    limit.  The backward never reads K4's output (so K4_BF16_P's P
    rounding does not enter): it recomputes out with the chunked forward,
    which returns it in q's dtype as the reference's ``_mea_fwd`` does, so
    each out element is within 2^-9 of the f32 out, delta_i = sum_d
    out_id dout_id within 2^-9 r_i (r_i = sum_d |out_id dout_id|), and
    ds_ij = p_ij (dp_ij - delta_i) dcap_ij (|dcap| <= 1) within p_ij of
    that.  So dq_i moves by at most 2^-9 scale r_i sum_j p_ij |k_j| (B_q:
    the plain version on (q, k, |k|)), dk_j by 2^-9 scale sum_i p_ij r_i
    |q_i| (B_k: the plain version's v-gradient for the cotangent r |q|),
    dv not at all (B_v = 0).  As K4's limit: twice that, one bf16 ulp
    (each side rounds its f32 gradient once) and the f32 limit."""
    from repro_torch.kernels.flash_attention import ref

    names = ("dq", "dk", "dv")
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    errs = {n: float(x.max()) for n, x in zip(names, diffs)}
    f32 = [K4_F32_TOL * (1.0 + float(w.float().abs().max())) for w in want]
    if q.dtype == torch.float32:
        return errs, all(e <= t for e, t in zip(errs.values(), f32))
    kw = dict(causal=causal, softcap=softcap,
              q_offset=k.shape[2] - q.shape[2])
    qf, kf, vf, df = (t.detach().float() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        r = (df * ref.flash_attention_ref(qf, kf, vf, **kw)).abs().sum(
            -1, keepdim=True)
        b_q = scale * r * ref.flash_attention_ref(qf, kf, kf.abs(), **kw)
    vv = vf.clone().requires_grad_()
    (b_k,) = torch.autograd.grad(ref.flash_attention_ref(qf, kf, vv, **kw),
                                 vv, r * qf.abs())
    ok = True
    for x, w, b, t in zip(diffs, want, (b_q, scale * b_k, 0.0), f32):
        ok &= bool((x <= K4_BF16_ULP * w.float().abs() + K4_GRAD_P * b
                    + t).all())
    return errs, ok


def k4_grad_case(q, k, v, dout, causal: bool, softcap: float) -> tuple:
    """(errors, ok, K4 launches) of one gradient case (see
    :func:`k4_grad_err`)."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref

    kernel.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.attention(*leaves, causal=causal, softcap=softcap).backward(dout)
    launches = kernel.LAUNCHES["flash_attention"]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*plain, causal=causal, softcap=softcap,
                            q_offset=k.shape[2] - q.shape[2]).backward(dout)
    sync(q.device)
    errs, ok = k4_grad_err([t.grad for t in leaves],
                           [t.grad for t in plain], q, k, v, dout, causal,
                           softcap)
    return errs, ok, launches


def phase_k4_grad(args, device) -> dict:
    """Phase 4h: ``attention(q, k, v).backward()`` on the card against
    autograd through ``ref.flash_attention_ref``: f32 and bf16, D = 64 and
    128, causal or not, softcap 0 and 30, GQA groups 1 and 8, S 512 and
    1024 (one and two chunks of the backward), then tinyllama's training
    shape at B = 1 (q [1, 32, 4096, 64], k/v 4 heads, bf16, causal):
    dq, dk, dv within :func:`k4_grad_err`'s tolerance, and one K4 launch a
    case (the forward; the backward is plain PyTorch)."""
    g = torch.Generator(device="cpu").manual_seed(8)
    lens = (64, 128) if args.cpu_rehearsal else (512, 1024)
    want_launches = 1 if device.type == "cuda" else 0
    worst, n = {}, 0

    def inputs(b, hq, hkv, s, d, dtype):
        return [torch.randn(shape, generator=g).to(device, dtype)
                for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                              (b, hq, s, d))]

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for d in (64, 128):
            for groups in (1, 8):
                for s in lens:
                    q, k, v, dout = inputs(1, 2 * groups, 2, s, d, dtype)
                    for causal in (True, False):
                        for cap in (0.0, 30.0):
                            errs, ok, launches = k4_grad_case(
                                q, k, v, dout, causal, cap)
                            check(ok and launches == want_launches,
                                  f"4h {tag} d={d} g={groups} s={s} causal="
                                  f"{causal} softcap={cap}: {errs}, K4 "
                                  f"launched {launches}")
                            for name, e in errs.items():
                                worst[f"{tag}/{name}"] = max(
                                    worst.get(f"{tag}/{name}", 0.0), e)
                            n += 1
    s = 256 if args.cpu_rehearsal else 4096
    q, k, v, dout = inputs(1, 32, 4, s, 64, torch.bfloat16)
    errs, ok, launches = k4_grad_case(q, k, v, dout, True, 0.0)
    check(ok and launches == want_launches,
          f"4h training shape [1, 32, {s}, 64]: {errs}, K4 launched "
          f"{launches}")
    del q, k, v, dout
    free_card(device)
    rep = {"phase": "k4_grad", "cases": n, "max_abs_err": worst,
           "training_shape": {"shape": [1, 32, s, 64], "kv_heads": 4,
                              "dtype": "bfloat16", "causal": True,
                              "max_abs_err": errs},
           "k4_launches_per_case": want_launches,
           "tolerance": {"float32": "2e-5 (1 + max |grad|)",
                         "bfloat16": "2^-7 |want| + 2^-8 B + 2e-5 (1 + "
                                     "max |grad|), B: what rounding the "
                                     "recomputed out to bf16 moves"}}
    emit(rep)
    return rep


def k5_inputs(n: int, device, f: int = 128):
    """One GNN aggregation layer at width ``f``: values [E, f] over the
    edges of ``make_graph_family("scale_free", n)``, summed by destination."""
    from repro_torch.core.generators import make_graph_family

    src, dst, _, n = make_graph_family("scale_free", n, seed=0)
    g = torch.Generator(device="cpu").manual_seed(5)
    values = torch.randn((src.shape[0], f), generator=g).to(device)
    return values, torch.from_numpy(dst).to(device), n


K5_SOURCE = "src/repro_torch/kernels/segment_reduce/csrc/segment_sum_sorted.cu"
K5_REPLACES = "src/repro/kernels/segment_reduce/kernel.py:59"
K5_REPEATS = 5


def same_tensor_bits(a, b) -> bool:
    """Equal bit for bit (bf16 or f32 tensors of one shape)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(view), b.view(view))


def k5_row(name, values, ids, n, launches, device, reps) -> dict:
    """K5 over ``ids`` sorted by ``ops.sort_ids`` (the models' and
    ``segment_sum``'s sort): the kernel on the presorted values and with
    the gather fused (``order``, the main path's call), each bitwise its
    plain version, and ``K5_REPEATS`` more launches of each bitwise the
    first; both timed beside the plain version and ``index_add_`` on the
    unsorted stream.  ``ms`` and ``bound_ms`` are the presorted call's
    (values, ``offsets`` and the output once); ``gather_ms`` and
    ``gather_bound_ms`` the fused call's (``order`` too)."""
    from repro_torch.kernels.segment_reduce import kernel, ops, ref

    s = ops.sort_ids(ids, n)
    sv = values.index_select(0, s.order.long())

    def presorted():
        return kernel.segment_sum_sorted(sv, s.sorted_ids, n,
                                         offsets=s.offsets)

    def fused():
        return kernel.segment_sum_sorted(values, s.sorted_ids, n,
                                         order=s.order, offsets=s.offsets)

    def plain():
        return ref.segment_sum_sorted_ref(sv, s.sorted_ids, n,
                                          offsets=s.offsets)

    want, got, got_fused = plain(), presorted(), fused()
    repeats = all(same_tensor_bits(presorted(), got) and
                  same_tensor_bits(fused(), got)
                  for _ in range(K5_REPEATS))
    sync(device)
    check(same_tensor_bits(got, want) and same_tensor_bits(got_fused, want),
          f"{name}: K5 is not bitwise its plain version "
          f"(max abs {float((got.float() - want.float()).abs().max())}, "
          f"fused {float((got_fused.float() - want.float()).abs().max())})")
    check(repeats, f"{name}: repeated K5 launches differ")
    clock = Clock(device)
    k_ms = clock.ms(presorted, reps)
    g_ms = clock.ms(fused, reps)
    p_ms = clock.ms(plain, max(2, reps // 10), warmup=1)
    e, f = values.shape
    lib = torch.zeros((n, f), dtype=values.dtype, device=device)
    il = ids.long()
    lib_ms = clock.ms(lambda: lib.index_add_(0, il, values), reps)
    b = values.element_size()
    nbytes = e * f * b + 4 * (n + 1) + n * f * b
    row = kernel_row(name, K5_SOURCE, K5_REPLACES, launches, 0.0, k_ms, p_ms,
                     nbytes, e * f, lib_ms)
    row.update(dtype=str(values.dtype).replace("torch.", ""),
               bitwise=True, repeats=K5_REPEATS, gather_ms=g_ms,
               gather_bound_ms=(nbytes + 4 * e) / PEAK_BYTES_PER_S * 1e3)
    return row


def phase_k5(args, device, reps: int) -> dict:
    """K5: its entry point ``segment_sum`` once (launches counted, against
    ``index_add_`` within 1e-5 of the segments' sums of |values|), then the
    kernel bitwise its plain version and timed (``k5_row``)."""
    from repro_torch.kernels.segment_reduce import kernel, ops, ref

    values, ids, n = k5_inputs(args.k5_n, device)
    e, f = values.shape
    sync(device)
    kernel.reset_launches()
    out = ops.segment_sum(values, ids, n)
    sync(device)
    launches = kernel.LAUNCHES["segment_sum_sorted"]
    if device.type == "cuda":
        check(launches > 0, "K5 was not launched by segment_sum")
    check(out.shape == (n, f) and bool(torch.isfinite(out).all()),
          "segment_sum output is not finite [N, F]")
    mag = ref.segment_sum_ref(values.abs(), ids, n)
    lib = torch.zeros((n, f), dtype=torch.float32, device=device)
    lib.index_add_(0, ids.long(), values)
    sync(device)
    check(bool(((out - lib).abs() <= 1e-5 * mag + 1e-30).all()),
          "segment_sum differs from index_add_")
    row = k5_row("segment_sum_sorted", values, ids.to(torch.int32), n,
                 launches, device, reps)
    emit({"phase": "k5", "graph": "scale_free", "n": n, "edges": e, "f": f,
          **{k: row[k] for k in (
              "max_abs_err", "launches", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "gather_ms", "gather_bound_ms",
              "repeats")}})
    return row


def phase_k6(sess, sources, device, reps: int) -> dict:
    """K6 on cell 0 of the session's destination-sorted stream, with the
    main path's sssp distances and a 50 % random active set: its entry
    point ``relax`` once (launches counted), bitwise against its plain
    version and ``scatter_reduce_`` amin, and timings."""
    from repro_torch.kernels.sssp_relax import kernel, ops, ref

    sg = sess.sg
    es = sg.sorted_width
    dist = sess.vertex_state("sssp", source=sources[0])["dist"][0]
    dist = dist.contiguous()
    g = torch.Generator(device="cpu").manual_seed(6)
    active = (torch.rand(dist.shape[0], generator=g) < 0.5).to(device)
    view = sg.csr_view()
    weight = view["csr_weight"][0, :es].contiguous()
    src = view["csr_src"][0, :es].contiguous()
    dst = view["csr_key"][0, :es].contiguous()
    n_keys = sg.n_shards * sg.n_per_shard
    args = (dist, active, weight, src, dst, n_keys)
    sync(device)
    kernel.reset_launches()
    out = ops.relax(*args)
    sync(device)
    launches = kernel.LAUNCHES["relax_sorted"]
    if device.type == "cuda":
        check(launches > 0, "K6 was not launched by relax")
    want = ref.relax_ref(dist, weight, src, dst, active, n_keys)
    got = kernel.relax_sorted(*args)
    s = src.long().clamp(0, dist.shape[0] - 1)
    live = (dst >= 0) & active[s]
    cand = torch.where(live, dist[s] + weight, float("inf"))
    ids = torch.where(dst >= 0, dst, n_keys).long()
    table = torch.empty(n_keys + 1, dtype=torch.float32, device=device)
    lib = table.fill_(float("inf")).scatter_reduce_(0, ids, cand, "amin")
    sync(device)
    check(torch.equal(got, want) and torch.equal(out, want),
          "K6 differs from its plain version")
    check(torch.equal(lib[:n_keys], want), "K6 differs from scatter_reduce_")
    hub = k6_hub_check(dist, active, n_keys, device)
    clock = Clock(device)
    kernel.reset_launches()
    k_ms = clock.ms(lambda: kernel.relax_sorted(*args), reps)
    p_ms = clock.ms(lambda: ref.relax_ref(dist, weight, src, dst, active,
                                          n_keys), max(2, reps // 10),
                    warmup=1)
    lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
        0, ids, cand, "amin"), reps)
    e = int(es)
    nbytes = e * 12 + dist.shape[0] * 5 + n_keys * 4
    row = kernel_row(
        "relax_sorted", "src/repro_torch/kernels/sssp_relax/csrc/"
        "relax_sorted.cu", "src/repro/kernels/sssp_relax/kernel.py:57",
        launches, 0.0, k_ms, p_ms, nbytes, 2 * e, lib_ms)
    emit({"phase": "k6", "cell": 0, "edges": e, "np": int(dist.shape[0]),
          "n_keys": n_keys, "live_edges": int((dst >= 0).sum()),
          "messages": int(live.sum()), "bitwise": True, "hub_stream": hub,
          **{k: row[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    return row


def k6_hub_check(dist, active, n_keys: int, device) -> dict:
    """K6 on a synthetic sorted stream of 1,000,003 edges (no multiple of
    the 1024-edge tile or of 8): dead edges first, hub runs of 20,000 and
    70,000 edges among short runs, a few sources outside the cell (the
    clamp): bitwise against its plain version and ``scatter_reduce_``."""
    from repro_torch.kernels.sssp_relax import kernel, ref

    rng = np.random.default_rng(16)
    e, np_ = 1_000_003, dist.shape[0]
    lengths = [333, 20_000] + rng.integers(1, 40, 2000).tolist() \
        + [70_000] + rng.integers(1, 60, e).tolist()
    ids = np.repeat(np.arange(len(lengths)), lengths)[:e]
    keys = np.sort(rng.integers(0, n_keys, ids[-1] + 1))
    dst = np.where(ids == 0, -1, keys[ids]).astype(np.int32)
    src = rng.integers(-3, np_ + 3, e).astype(np.int32)
    w = (1 + 7 * rng.random(e)).astype(np.float32)
    as_t = lambda a: torch.from_numpy(a).to(device)
    w_, s_, d_ = as_t(w), as_t(src), as_t(dst)
    got = kernel.relax_sorted(dist, active, w_, s_, d_, n_keys)
    want = ref.relax_ref(dist, w_, s_, d_, active, n_keys)
    s = s_.long().clamp(0, np_ - 1)
    cand = torch.where((d_ >= 0) & active[s], dist[s] + w_, float("inf"))
    lib = torch.full((n_keys + 1,), float("inf"), device=device)
    lib.scatter_reduce_(0, torch.where(d_ >= 0, d_, n_keys).long(), cand,
                        "amin")
    sync(device)
    check(torch.equal(got, want) and torch.equal(lib[:n_keys], want),
          "K6 on the hub stream differs from its plain version or from "
          "scatter_reduce_")
    return {"edges": e, "hub_runs": [20_000, 70_000], "bitwise": True}


def reset_all_launches() -> None:
    from repro_torch.kernels.edge_relax import kernel as k13
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.kernels.sssp_relax import kernel as k6

    for mod in (k13, k4, k5, k6):
        mod.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels.edge_relax import kernel as k13
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.kernels.sssp_relax import kernel as k6

    return {**k13.LAUNCHES, **k4.LAUNCHES, **k5.LAUNCHES, **k6.LAUNCHES}


def lm_config(args):
    from repro_torch.configs import registry

    mod = registry.get_module("tinyllama-1.1b")
    if args.cpu_rehearsal:
        return mod.smoke_config(dtype=torch.bfloat16)
    return mod.make_config()


def phase_serve(args, device, cfg=None, phase: str = "serve") -> dict:
    """The LM serving path at full width: ``DecodeServer`` with 4 slots
    and max_len 2048 on ``cfg`` (tinyllama-1.1b by default; bf16, seeded
    random weights); admit 4 prompts of 1024 tokens, then 32 greedy decode
    steps, with every launch counter zeroed just before and read just
    after.  For an MoE LM the timed runs also keep each ``moe.route``'s
    group sizes (references, no device work): the rows each prompt's
    prefill lost to the capacity, and the experts each decode step's
    tokens route to, whose weights set the step's bound."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = cfg or lm_config(args)
    slots, max_len, plen, steps = ((4, 64, 16, 4) if args.cpu_rehearsal
                                   else (4, 2048, args.prompt_len, 32))
    free = check_free(device, model_bytes(cfg, slots, max_len), phase)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tf.init_params(cfg, seed=args.seed, device=device)
    srv = serve.DecodeServer(cfg, params, batch_slots=slots, max_len=max_len)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (slots, plen)).astype(np.int32)
    # warm-up (cuBLAS handles, the first launches): one short request
    srv.admit(prompts[0][: plen // 8])
    srv.step()
    srv.retire(0)
    sync(device)
    setup_s = time.perf_counter() - t
    moe = cfg.moe is not None
    reset_all_launches()
    with recording_routes(moe) as prefill_routes:
        t = time.perf_counter()
        for p in prompts:
            check(srv.admit(p) is not None, "no free slot")
        sync(device)
        prefill_s = time.perf_counter() - t
    kv_positions = 0
    with recording_routes(moe) as decode_routes:
        t = time.perf_counter()
        for _ in range(steps):
            kv_positions += int(srv.lens[srv.active].sum())
            srv.step()
        sync(device)
        decode_s = time.perf_counter() - t
    launches = all_launches()
    k4 = launches["flash_attention"]
    if device.type == "cuda":
        check(k4 == cfg.n_layers * slots,
              f"K4 launched {k4} times, not {cfg.n_layers} per admitted "
              f"prompt")
    check(bool((srv.lens == plen + 1 + steps).all()),
          f"slot lengths {srv.lens.tolist()}")
    check(bool((srv.tokens[:, : plen + 1 + steps] < cfg.vocab).all()
               and (srv.tokens >= 0).all()), "a token outside the vocab")
    for kv in ("k", "v"):
        check(bool(torch.isfinite(srv.cache[kv].float()).all()),
              f"non-finite {kv} cache")
    outs = [srv.retire(s) for s in range(slots)]
    drops = experts_a_step = None
    if moe:
        check(len(prefill_routes) == slots * cfg.n_layers and
              len(decode_routes) == steps * cfg.n_layers,
              f"{len(prefill_routes)} prefill and {len(decode_routes)} "
              f"decode routings")
        per_prompt = cfg.n_layers
        drops = [dropped_rows(cfg.moe, prefill_routes[i: i + per_prompt])
                 for i in range(0, len(prefill_routes), per_prompt)]
        # expert-layers whose weights a step's tokens need
        experts_a_step = int(sum(int((sz > 0).sum())
                                 for sz, _ in decode_routes)) / steps
    profiles = []
    if args.profile and device.type == "cuda":
        tag = "" if phase == "serve" else f"{phase}_"
        profiles = [trace(f"{tag}prefill", lambda: srv.admit(prompts[0])),
                    trace(f"{tag}decode_step", srv.step)]
    # a decode step's least time: the weights it needs and the live KV read
    # once; for an MoE LM only the experts its tokens route to (the
    # capacity path reads all of them: its own floor, kept beside)
    wbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    kv_per_pos = cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * \
        params["embed"].element_size()
    kv_bytes = kv_per_pos * kv_positions / steps
    step_bytes = all_experts_bytes = wbytes + kv_bytes
    if moe:
        expert_bytes = 3 * cfg.d_model * cfg.moe.d_ff * \
            params["embed"].element_size()
        step_bytes -= expert_bytes * (cfg.n_layers * cfg.moe.n_experts -
                                      experts_a_step)
    bound_step_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    rep = {"phase": phase, "arch": cfg.name, "dtype": str(cfg.dtype),
           "layers": cfg.n_layers, "slots": slots, "max_len": max_len,
           "prompt_len": plen, "decode_steps": steps,
           "setup_s": setup_s, "prefill_s": prefill_s,
           "prefill_tokens_per_s": slots * plen / prefill_s,
           "decode_s": decode_s,
           "decode_tokens_per_s": slots * steps / decode_s,
           "ms_per_decode_step": decode_s / steps * 1e3,
           "decode_step_bound_ms": bound_step_ms,
           "decode_step_bytes": step_bytes,
           "routed_experts_a_step": experts_a_step,
           "all_experts_floor_ms": (all_experts_bytes / PEAK_BYTES_PER_S *
                                    1e3 if moe else None),
           "weight_bytes": wbytes,
           "k4_launches": k4, "k4_per_prompt": k4 / slots,
           "launches": launches,
           "free_bytes_before": free,
           "peak_bytes": (torch.cuda.max_memory_allocated()
                          if device.type == "cuda" else None),
           "capacity_dropped_rows": drops,
           # of the rows the router sends in one prompt's prefill
           "capacity_dropped_share": (sum(drops) / (
               slots * cfg.n_layers * plen * cfg.moe.top_k) if drops
               else None),
           "first_tokens": [o[plen: plen + 8].tolist() for o in outs]}
    emit(rep)
    for line in profiles:
        emit(line)
    del srv, params
    free_card(device)
    return rep


def phase_lm_checks(args, device) -> dict:
    """The f32 model at full width on one prompt: prefill logits on K4
    against the same model on the plain attention, and the decode logits
    at position p against the last logits of a prefill over p + 1 tokens.
    Tolerance 1e-3 max abs on logits of order 1: 22 layers of f32 sums in
    other orders (the kernel, cuBLAS at other shapes)."""
    import dataclasses
    from unittest import mock

    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(lm_config(args), dtype=torch.float32)
    plen = 16 if args.cpu_rehearsal else args.prompt_len
    params = tf.init_params(cfg, seed=args.seed + 1, device=device)
    rng = np.random.default_rng(args.seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(
        device)
    logits, cache = tf.prefill(params, prompt, cfg, max_len=plen + 1)
    with mock.patch.object(tf, "attention", plain_attention):
        want, _ = tf.prefill(params, prompt, cfg, max_len=plen + 1)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    dec, _ = tf.decode_step(params, nxt, cache, plen, cfg)
    longer, _ = tf.prefill(params, torch.cat([prompt, nxt], 1), cfg,
                           max_len=plen + 1)
    sync(device)
    err_k4 = float((logits - want).abs().max())
    err_dec = float((dec - longer).abs().max())
    check(bool(torch.isfinite(logits).all()) and logits.shape ==
          (1, 1, cfg.vocab), "prefill logits are not finite [1, 1, V]")
    check(err_k4 <= 1e-3, f"f32 prefill on K4 vs plain attention: {err_k4}")
    check(err_dec <= 1e-3, f"f32 decode vs prefill over p + 1: {err_dec}")
    rep = {"phase": "lm_checks", "dtype": "float32", "prompt_len": plen,
           "logit_absmax": float(logits.abs().max()),
           "k4_vs_plain_max_abs": err_k4, "decode_vs_prefill_max_abs":
           err_dec, "tolerance": 1e-3}
    emit(rep)
    del params, cache
    return rep


def phase_k4_timing(args, launches: int, device, reps: int) -> dict:
    """K4 at the prefill shape: q [1, 32, 1024, 64], k/v [1, 4, 1024, 64]
    bf16, causal (:func:`k4_row`)."""
    cfg = lm_config(args)
    s = 32 if args.cpu_rehearsal else args.prompt_len
    return k4_row("flash_attention", cfg.n_heads, cfg.n_kv_heads, s, cfg.hd,
                  cfg.dtype, launches, device, reps)


def k4_row(name: str, hq: int, hkv: int, s: int, d: int, dtype, launches,
           device, reps: int, softcap: float = 0.0, b: int = 1) -> dict:
    """K4 at q [b, hq, s, d], k/v [b, hkv, s, d], causal, ``softcap``:
    held against its plain version there (the tolerance of
    :func:`k4_err`), then timed beside the plain version, its bound and one
    library call of the same function: ``scaled_dot_product_attention``
    without a softcap; with one, ``flex_attention`` with a tanh-softcap
    ``score_mod`` and a causal block mask (compiled on the card before the
    timing; SDPA has no softcap, its uncapped time is kept as
    ``sdpa_ms``).  The library's output is held to the same tolerance."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref

    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn((b, hq, s, d), generator=g).to(device, dtype)
    k, v = (torch.randn((b, hkv, s, d), generator=g).to(device, dtype)
            for _ in range(2))
    kw = dict(causal=True, softcap=softcap)
    got = kernel.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    sync(device)
    err, ok = k4_err(got, want, q, k, v, **kw)
    check(got.shape == q.shape and got.dtype == q.dtype and ok,
          f"K4 {name} at {list(q.shape)}, kv {hkv}, softcap {softcap}: max "
          f"abs err {err}")
    if softcap:
        library, lib_name = flex_softcap(q, k, v, softcap), "flex_attention"
    else:
        library, lib_name = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
            "scaled_dot_product_attention")
    lib_err, lib_ok = k4_err(library(), want, q, k, v, **kw)
    check(lib_ok, f"{lib_name} at {list(q.shape)}, softcap {softcap}: max "
                  f"abs err {lib_err} against K4's plain version")
    del got, want
    clock = Clock(device)
    k_ms = clock.ms(lambda: kernel.flash_attention(q, k, v, **kw), reps)
    p_ms = clock.ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                    max(2, reps // 10), warmup=1)
    lib_ms = clock.ms(library, reps)
    sdpa_ms = lib_ms if not softcap else clock.ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True), reps)
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * k.numel() * el
    flops = 4 * b * hq * d * (s * (s + 1) // 2)
    row = kernel_row(
        name, "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:89",
        launches, err, k_ms, p_ms, nbytes, flops, lib_ms,
        peak_ops=PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16
        else PEAK_F32_OPS_PER_S)
    emit({"phase": "k4_timing", "name": name, "shape": [b, hq, s, d],
          "kv_heads": hkv, "dtype": str(dtype), "causal": True,
          "softcap": softcap, "max_abs_err": err,
          "tflops": flops / (k_ms * 1e-3) / 1e12, "library": lib_name,
          "library_max_abs_err": lib_err,
          "library_tflops": flops / (lib_ms * 1e-3) / 1e12,
          "sdpa_ms": sdpa_ms,
          "sdpa_note": "no softcap: SDPA computes the uncapped function"
          if softcap else "the library call",
          **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}})
    return row


def flex_softcap(q, k, v, softcap: float):
    """``flex_attention`` computing K4's causal softcapped attention on
    (q, k, v) (scores scaled by 1/sqrt(D), then ``softcap * tanh(s /
    softcap)``), as a call of no arguments: compiled and run once here on
    the card (eager, the library's own fallback, on the CPU)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    s = q.shape[2]

    def capped(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(lambda b, h, q_idx, kv_idx: q_idx >= kv_idx,
                             None, None, s, s, device=q.device)
    fn = torch.compile(flex_attention, dynamic=False) if q.is_cuda \
        else flex_attention

    def call():
        return fn(q, k, v, score_mod=capped, block_mask=mask, enable_gqa=True)

    call()
    sync(q.device)
    return call


# --------------------------------------------------------------------------
# the MoE LMs (phases 5c, 5d) and the diffusion dry-run (phase 3l)
# --------------------------------------------------------------------------

MOE_SERVE_ARCH, MOE_SERVE_LAYERS = "phi3.5-moe-42b-a6.6b", 24
MOE_CHECK_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")
DRYRUN_CELLS = ((256, "pull"), (256, "push"), (512, "pull"))
# a prefill of at most this many tokens drops no row: each expert gets at
# most one row a token, and the least capacity is 128
NO_DROP_LEN = 128


def moe_config(args, arch: str = MOE_SERVE_ARCH,
               layers: int = MOE_SERVE_LAYERS, dtype=torch.bfloat16):
    """``arch`` at its published widths cut to ``layers`` layers (the
    smoke config on the CPU rehearsal)."""
    import dataclasses

    from repro_torch.configs import registry

    mod = registry.get_module(arch)
    if args.cpu_rehearsal:
        return mod.smoke_config(dtype=dtype)
    return dataclasses.replace(mod.make_config(dtype=dtype),
                               n_layers=layers)


def free_card(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check_free(device, need: int, what: str) -> int | None:
    """The card's free bytes, checked against ``need`` before a model is
    loaded (None on the CPU)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info()
    check(free >= need, f"{what} needs {need} B of the card, {free} B free")
    return free


def model_bytes(cfg, slots: int, max_len: int) -> int:
    """What loading and serving ``cfg`` takes on the card: its weights,
    the slots' KV cache and a prefill's, and the two float32 copies of the
    largest tensor ``dense_init`` holds before casting."""
    el = torch.empty((), dtype=cfg.dtype).element_size()
    kv = cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * el * max_len
    f = cfg.moe.d_ff if cfg.moe is not None else cfg.d_ff
    e = cfg.moe.n_experts if cfg.moe is not None else 1
    return cfg.param_count() * el + kv * (slots + 1) + \
        2 * e * cfg.d_model * f * 4


@contextlib.contextmanager
def recording_routes(on: bool = True):
    """``moe.route`` wrapped to keep, at each call, its group sizes [E]
    (a device tensor, not read) and its token count, in the list yielded;
    ``moe_ffn`` routes once a call, so routing and drops are the run's
    own.  ``on`` False records nothing (a dense model)."""
    from unittest import mock

    from repro_torch.models import moe

    routes = []
    if not on:
        yield routes
        return
    real = moe.route

    def recorded(params, x, cfg):
        out = real(params, x, cfg)
        routes.append((out[-1], x.shape[0]))
        return out

    with mock.patch.object(moe, "route", recorded):
        yield routes


def dropped_rows(cfg, routes) -> int:
    """The rows the capacity path drops in ``routes`` (group sizes past
    ``moe.capacity`` of each call's token count)."""
    from repro_torch.models import moe

    return int(sum(int((sz - moe.capacity(cfg, t)).clamp(min=0).sum())
                   for sz, t in routes))


def plain_attention(q, k, v, causal=True, softcap=0.0):
    """``ops.attention`` on K4's plain version (the same alignment)."""
    from repro_torch.kernels.flash_attention import ref

    return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap,
                                   q_offset=k.shape[2] - q.shape[2])


def phase_moe_checks(args, device) -> dict:
    """Phase 5d: the float32 MoE LMs at published widths on 2 layers each,
    phi3.5-moe and then grok-1 (freed between): prefill logits on K4
    against the same model on the plain attention; the decode logits at
    p = ``NO_DROP_LEN`` - 1, where no expert can receive more rows than the
    least capacity (128) holds, against the last logits of a prefill over
    p + 1 tokens (1e-3 max abs, as phase 5b); and phi3.5 with the int8 KV
    cache made from that prefill's (prefill -> ``kv_quantize`` ->
    ``decode_step``): within the reference test's 5 % of the unquantized
    decode's largest logit, with the same argmax.  Then grok-1's 2 layers
    in bf16: a prefill of the prompt, which launches K4's bf16 softcap
    instance (counted: the grok-1 K4 row's launches)."""
    import dataclasses
    from unittest import mock

    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.models import transformer as tf

    plen = 16 if args.cpu_rehearsal else args.prompt_len
    p = min(plen, NO_DROP_LEN) - 1
    out = {"phase": "moe_checks", "dtype": "float32", "prompt_len": plen,
           "decode_at": p, "tolerance": 1e-3, "int8_tolerance": 0.05}
    for arch in MOE_CHECK_ARCHS:
        cfg = moe_config(args, arch, layers=2, dtype=torch.float32)
        free = check_free(device, model_bytes(cfg, 1, plen + 1),
                          f"5d {arch}")
        params = tf.init_params(cfg, seed=args.seed + 2, device=device)
        rng = np.random.default_rng(args.seed + 2)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(
            device)
        k4.reset_launches()
        with recording_routes() as routes:
            logits, _ = tf.prefill(params, prompt, cfg, max_len=plen + 1)
        launches = k4.LAUNCHES["flash_attention"]
        dropped = dropped_rows(cfg.moe, routes)
        with mock.patch.object(tf, "attention", plain_attention):
            want, _ = tf.prefill(params, prompt, cfg, max_len=plen + 1)
        sync(device)
        err_k4 = float((logits - want).abs().max())
        check(bool(torch.isfinite(logits).all()) and logits.shape ==
              (1, 1, cfg.vocab), f"5d {arch}: prefill logits are not finite "
                                 f"[1, 1, V]")
        check(err_k4 <= 1e-3, f"5d {arch}: f32 prefill on K4 vs plain "
                              f"attention: {err_k4}")
        # decode at p against a prefill over p + 1: neither can drop a row
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        with recording_routes() as short_routes:
            _, cache = tf.prefill(params, prompt[:, :p], cfg, max_len=p + 1)
            longer, _ = tf.prefill(params, torch.cat([prompt[:, :p], nxt], 1),
                                   cfg, max_len=p + 1)
        (qk, sk), (qv, sv) = (tf.kv_quantize(cache[n]) for n in "kv")
        dec, _ = tf.decode_step(params, nxt, cache, p, cfg)
        if cfg.logit_softcap:       # decode caps, prefill does not
            longer = cfg.logit_softcap * torch.tanh(
                longer / cfg.logit_softcap)
        err_dec = float((dec - longer).abs().max())
        check(dropped_rows(cfg.moe, short_routes) == 0,
              f"5d {arch}: a prefill of {p + 1} tokens dropped a row")
        check(err_dec <= 1e-3, f"5d {arch}: f32 decode vs prefill over "
                               f"p + 1 at p = {p}: {err_dec}")
        row = {"layers": cfg.n_layers, "free_bytes_before": free,
               "k4_launches": launches, "capacity_dropped_rows": dropped,
               "logit_absmax": float(logits.abs().max()),
               "k4_vs_plain_max_abs": err_k4,
               "decode_vs_prefill_max_abs": err_dec}
        if arch == MOE_CHECK_ARCHS[0]:
            lg_q, qc2 = tf.decode_step(
                params, nxt, {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv},
                p, dataclasses.replace(cfg, kv_quant=True))
            sync(device)
            rel = float((lg_q - dec).abs().max() / dec.abs().max())
            same = bool((lg_q.argmax(-1) == dec.argmax(-1)).all())
            check(qc2["k"].dtype == torch.int8 and rel < 0.05 and same,
                  f"5d {arch}: int8 decode {rel} of the largest logit "
                  f"(limit 0.05), same argmax {same}")
            row["int8_vs_decode_rel"] = rel
            row["int8_same_argmax"] = same
        out[arch] = row
        del params, cache, qk, qv, logits, want, dec, longer
        free_card(device)
    # grok-1 in bf16, the serving dtype: K4's bf16 softcap instance
    cfg = moe_config(args, MOE_CHECK_ARCHS[1], layers=2, dtype=torch.bfloat16)
    free = check_free(device, model_bytes(cfg, 1, plen), "5d grok-1 bf16")
    params = tf.init_params(cfg, seed=args.seed + 2, device=device)
    rng = np.random.default_rng(args.seed + 2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(
        device)
    k4.reset_launches()
    logits, _ = tf.prefill(params, prompt, cfg, max_len=plen)
    sync(device)
    launches = k4.LAUNCHES["flash_attention"]
    check(bool(torch.isfinite(logits).all()) and logits.shape ==
          (1, 1, cfg.vocab), "5d grok-1 bf16: prefill logits are not finite "
                             "[1, 1, V]")
    if device.type == "cuda":
        check(launches == cfg.n_layers, f"5d grok-1 bf16: K4 launched "
                                        f"{launches} times, not "
                                        f"{cfg.n_layers}")
    out["grok_bf16"] = {"layers": cfg.n_layers, "free_bytes_before": free,
                        "k4_launches": launches,
                        "logit_absmax": float(logits.abs().max())}
    del params, logits
    free_card(device)
    emit(out)
    return out


# --------------------------------------------------------------------------
# phase 5e: training the dense LM at full width
# --------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_BATCH = "tinyllama-1.1b", 8
TRAIN_STEPS, TRAIN_RESUME_TO, TRAIN_CKPT_EVERY = 6, 8, 3
# 2.2 GB of bf16 weights and gradients, ~3 GB of saved layer
# inputs, ~13 GB around the f32 logits, the attention backward's chunks
TRAIN_NEED_BYTES = 55 * 10**9


def train_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one training step: 6 N T + 6 L B S^2 Hq D, with N the
    parameters outside the embedding (the unembedding counts) and T = B S
    tokens."""
    n = cfg.param_count() - cfg.vocab * cfg.d_model
    return 6.0 * n * b * s + 6.0 * cfg.n_layers * b * s * s * cfg.n_heads \
        * cfg.hd


def phase_train(args, device) -> dict:
    """Phase 5e: tinyllama-1.1b at its published widths and depth in bf16
    with seeded weights, trained through ``launch.steps.build_cell``
    (``train_4k``, the global batch cut to 8 x 4096; adafactor 1e-3, clip
    1.0, n_micro 1, remat on) and ``runtime.trainer.train_loop`` on the
    ``TokenPipeline`` synthetic stream through a ``Prefetcher`` (smoke
    config, 8 x 64 tokens, on the CPU rehearsal).  Six steps with
    ``ckpt_every=3`` into ``chiprun_out/train``; then a second
    ``train_loop`` to 8 steps on weights of another seed resumes at step
    6: the restored parameters and optimizer state equal the live ones
    after step 5 bit for bit, and it runs steps 6-7 only; three snapshots
    (steps 2, 5, 7) of the live tensors' bytes are on disk, and the
    directory is removed at the end.  Every loss and grad norm is finite;
    K4 launches 2 L a step (forward and remat recompute).  The loss on
    step 0's batch is reported before, right after step 0's update and
    after six updates (step 6 reads it again: a resume does not
    fast-forward the stream); one update lowers the loss on the batch it
    was taken on.  Step 5's loss is not held below step 0's: without
    warmup the recipe does not lower the loss on six fresh batches, and
    the reference's own loss rises as far as step 4 at these widths
    (``tests/test_torch_train_wide.py``, which the port tracks), as the
    plain attention's does in :func:`phase_train_check`.  Reports step
    seconds, tokens/s, peak memory and the model-FLOPs share of 989
    TFLOP/s; with ``--profile`` one more step is traced."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager, flatten
    from repro_torch.data.pipeline import Prefetcher, TokenPipeline
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import steps
    from repro_torch.launch.train import on_device
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.trainer import train_loop

    rehearsal = args.cpu_rehearsal
    cell = steps.build_cell(TRAIN_ARCH, "train_4k", smoke=rehearsal,
                            batch=TRAIN_BATCH, device=device)
    cfg = cell.config
    b, s = cell.input_specs()["tokens"].shape
    free_card(device)
    free = check_free(device, TRAIN_NEED_BYTES, "5e training")
    ckpt_dir = OUT_DIR / "train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def stream():
        return on_device(Prefetcher(TokenPipeline(b, s, cfg.vocab,
                                                  seed=args.seed)), device)

    rows = []

    def on_metrics(step, m, dt):
        rows.append({"step": step, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "seconds": dt,
                     "k4_launches": k4.LAUNCHES["flash_attention"]})
        reset_all_launches()

    try:
        t = time.perf_counter()
        params = cell.init_params(args.seed)
        opt_state = cell.init_opt(params)
        sync(device)
        setup_s = time.perf_counter() - t
        probe = {}

        def probed_step(p, o, step_no, batch):
            # step 0's batch again right after step 0's update (a forward
            # whose K4 launches are not the step's)
            out = cell.step(p, o, step_no, batch)
            if step_no == 0:
                n = k4.LAUNCHES["flash_attention"]
                with torch.no_grad():
                    probe["loss"] = float(tf.loss_fn(
                        out[0], batch["tokens"], batch["labels"], cfg))
                k4.LAUNCHES["flash_attention"] = n
            return out

        reset_all_launches()
        params, opt_state, last = train_loop(
            probed_step, params, opt_state, stream(), TRAIN_STEPS,
            str(ckpt_dir), ckpt_every=TRAIN_CKPT_EVERY,
            on_metrics=on_metrics)
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else None)
        live = {n: t.detach().to("cpu", copy=True) for n, t in
                flatten((params, opt_state)).items()}
        live_bytes = sum(t.numel() * t.element_size() for t in live.values())
        del params, opt_state
        free_card(device)
        # the resume: weights of another seed, which the restore overwrites
        params = cell.init_params(args.seed + 1)
        opt_state = cell.init_opt(params)
        first = {}

        def checked_step(p, o, step_no, batch):
            if not first:
                got = flatten((p, o))
                first.update(step=step_no, names=sorted(got) == sorted(live),
                             bitwise=all(same_tensor(live[n], got[n])
                                         for n in live))
            return cell.step(p, o, step_no, batch)

        params, opt_state, last2 = train_loop(
            checked_step, params, opt_state, stream(), TRAIN_RESUME_TO,
            str(ckpt_dir), ckpt_every=TRAIN_CKPT_EVERY,
            on_metrics=on_metrics)
        snaps = {st: dir_bytes(ckpt_dir / f"step_{st}")
                 for st in CheckpointManager(str(ckpt_dir)).all_steps()}
        profile = None
        if args.profile and device.type == "cuda":
            batch = next(stream())
            profile = trace("train_step", lambda: cell.step(
                params, opt_state, TRAIN_RESUME_TO, batch))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    secs = [r["seconds"] for r in rows]
    med = float(np.median(secs))
    flops = train_flops(cfg, b, s)
    rep = {"phase": "train", "arch": cfg.name, "dtype": str(cfg.dtype),
           "layers": cfg.n_layers, "batch": b, "seq_len": s,
           "optimizer": "adafactor(lr=1e-3)", "clip": 1.0, "n_micro": 1,
           "remat": cfg.remat, "setup_s": setup_s, "steps": rows,
           "step_seconds_median": med,
           "step_seconds_median_after_first": float(np.median(secs[1:])),
           "tokens_per_s": b * s / med,
           "k4_launches_per_step": rows[-1]["k4_launches"],
           "k4_launches": sum(r["k4_launches"] for r in rows),
           "model_flops_per_step": flops,
           "model_flops_share_of_bf16_peak": flops / med /
           PEAK_BF16_OPS_PER_S, "peak_bytes": peak,
           "free_bytes_before": free, "snapshot_bytes": snaps,
           "live_state_bytes": live_bytes, "resumed_at": first.get("step"),
           "resume_bitwise": first.get("bitwise"),
           "last_steps": [last, last2],
           # the loss on step 0's batch: before, after step 0's update, and
           # after 6 updates (step 6 reads it again: no fast-forward)
           "step0_batch_loss": [rows[0]["loss"], probe.get("loss"),
                                rows[TRAIN_STEPS]["loss"]]}
    emit(rep)
    ran = [r["step"] for r in rows]
    check(last == TRAIN_STEPS - 1 and last2 == TRAIN_RESUME_TO - 1 and
          ran == list(range(TRAIN_RESUME_TO)),
          f"5e ran steps {ran} (last {last}, then {last2})")
    check(first.get("step") == TRAIN_STEPS and first["names"] and
          first["bitwise"], f"5e resume: {first}")
    # each leaf's .npy adds a header of 128 B, the manifest ~200 B a leaf
    check(sorted(snaps) == [2, 5, 7] and all(
        live_bytes <= v <= live_bytes + 512 * len(live)
        for v in snaps.values()),
        f"5e snapshots {snaps} against {live_bytes} live bytes")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rows), f"5e a loss or grad norm is not finite: {rows}")
    check(probe.get("loss", np.inf) < rows[0]["loss"],
          f"5e step 0's update did not lower the loss on its own batch: "
          f"{rep['step0_batch_loss']}")
    if device.type == "cuda":
        check(all(r["k4_launches"] == 2 * cfg.n_layers for r in rows),
              f"5e K4 launches a step {[r['k4_launches'] for r in rows]}, "
              f"not {2 * cfg.n_layers}")
    if profile is not None:
        emit(profile)
    del params, opt_state, live
    free_card(device)
    return rep


def phase_train_check(args, device) -> dict:
    """Phase 5e (f32): train steps (``launch.steps._make_train_step``: the
    gradient, clip 1.0, adafactor 1e-3, ``p + u``) of tinyllama-1.1b at its
    published widths in float32 cut to 2 layers, on 1024-token sequences
    of the ``TokenPipeline`` stream (two chunks of the attention
    backward), with K4 and the chunked backward against the same steps on
    the plain attention (autograd through ``ref.flash_attention_ref``).
    Step 0: loss within 1e-4 (one f32 cross entropy; phase 5b's logits
    agree to 1e-3), grad norm within 1e-4 of itself, every parameter after
    the update within 1e-6 (a thousandth of the lr: adafactor's step-0
    update is the gradient over its factored RMS, so a 1e-4 relative
    gradient error moves it by 1e-4 lr).  Steps 1-5, the recipe of phase
    5e: each loss within 1e-3 of the plain path's (the step-0 differences
    carried through five updates), and on both paths the loss on step 0's
    batch right after step 0's update below step 0's.  Both loss
    trajectories are reported, the plain one the witness of what six
    steps of the recipe do.  K4 launches 2 a layer a step: the forward and
    the remat recompute."""
    import dataclasses
    from unittest import mock

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adafactor, tree_leaves

    cfg = dataclasses.replace(lm_config(args), dtype=torch.float32,
                              n_layers=2)
    s = 128 if args.cpu_rehearsal else 1024
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b, _ in zip(TokenPipeline(1, s, cfg.vocab,
                                             seed=args.seed + 3),
                               range(TRAIN_STEPS))]
    opt = adafactor(lr=1e-3)
    step = steps._make_train_step(
        lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], cfg), opt)

    def loss_of(params, batch):
        with torch.no_grad():
            return float(tf.loss_fn(params, batch["tokens"],
                                    batch["labels"], cfg))

    def run():
        params = tf.init_params(cfg, seed=args.seed + 3, device=device)
        state, ms = opt.init(params.tree()), []
        for i, batch in enumerate(batches):
            params, state, m = step(params, state, i, batch)
            ms.append({k: float(v) for k, v in m.items()})
            if i == 0:
                after0 = [t.detach().clone() for t in
                          tree_leaves(params.tree())]
                n = k4.LAUNCHES["flash_attention"]
                probe = loss_of(params, batches[0])
                k4.LAUNCHES["flash_attention"] = n
        return after0, ms, probe

    k4.reset_launches()
    got, gm, gprobe = run()
    launches = k4.LAUNCHES["flash_attention"]
    with mock.patch.object(tf, "attention", plain_attention):
        want, wm, wprobe = run()
    sync(device)
    err_p = max(float((a - b).abs().max()) for a, b in zip(got, want))
    err_loss = [abs(g["loss"] - w["loss"]) for g, w in zip(gm, wm)]
    err_norm = abs(gm[0]["grad_norm"] - wm[0]["grad_norm"])
    rep = {"phase": "train_check", "dtype": "float32",
           "layers": cfg.n_layers, "seq_len": s, "steps": len(batches),
           "loss": gm[0]["loss"], "loss_abs_err": err_loss[0],
           "grad_norm": gm[0]["grad_norm"], "grad_norm_abs_err": err_norm,
           "params_max_abs_err": err_p,
           "losses": [m["loss"] for m in gm],
           "plain_losses": [m["loss"] for m in wm],
           "grad_norms": [m["grad_norm"] for m in gm],
           "plain_grad_norms": [m["grad_norm"] for m in wm],
           "later_loss_abs_err": max(err_loss[1:]),
           "step0_batch_loss_after_update": gprobe,
           "plain_step0_batch_loss_after_update": wprobe,
           "k4_launches": launches,
           "tolerance": {"loss": 1e-4, "grad_norm": "1e-4 relative",
                         "params": 1e-6, "later_loss": 1e-3}}
    emit(rep)
    check(np.isfinite(rep["loss"]) and err_loss[0] <= 1e-4 and
          err_norm <= 1e-4 * wm[0]["grad_norm"] and err_p <= 1e-6,
          f"5e f32 train step on K4 vs the plain attention: {rep}")
    check(all(np.isfinite(e) and e <= 1e-3 for e in err_loss[1:]),
          f"5e f32 steps 1-5 on K4 vs the plain attention: {err_loss}")
    check(gprobe < gm[0]["loss"] and wprobe < wm[0]["loss"],
          f"5e f32 step 0's update did not lower the loss on its batch: "
          f"{gprobe} / {wprobe} against {gm[0]['loss']} / {wm[0]['loss']}")
    if device.type == "cuda":
        check(launches == 2 * cfg.n_layers * len(batches),
              f"5e f32: K4 launched {launches} times, not "
              f"{2 * cfg.n_layers * len(batches)}")
    del got, want
    free_card(device)
    return rep


def phase_attention_bwd_timing(args, device, reps: int) -> dict:
    """The attention backward at the training shape (q [8, 32, 4096, 64],
    k/v 4 heads, bf16, causal; smaller on the CPU rehearsal): what
    ``ops.attention``'s backward runs (the chunked f32 recompute and the
    two-pass backward of ``xla_flash.py``, plain PyTorch as in the
    reference) timed beside ``scaled_dot_product_attention``'s backward
    (its forward run once outside the timing) and the flash backward's
    bound: five products of 2 Sq Skv D a head, halved by the causal mask,
    at 989 TFLOP/s bf16.  Not a TPU kernel: the reference computes it in
    XLA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import xla_flash

    b, hq, hkv, s, d = ((1, 4, 2, 256, 64) if args.cpu_rehearsal
                        else (TRAIN_BATCH, 32, 4, 4096, 64))
    g = torch.Generator(device="cpu").manual_seed(9)
    q, dout = (torch.randn((b, hq, s, d), generator=g).to(
        device, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=g).to(
        device, torch.bfloat16) for _ in range(2))
    chunk = min(512, s)

    def port():
        out, lse = xla_flash.mea_fwd(q, k, v, True, 0.0, chunk)
        return xla_flash.mea_bwd(q, k, v, out, lse, dout, True, 0.0, chunk)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       enable_gqa=True)

    def library():
        return torch.autograd.grad(o, leaves, dout, retain_graph=True)

    clock = Clock(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    port_ms = clock.ms(port, 3, warmup=1)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    lib_ms = clock.ms(library, reps)
    causal_flops = 2 * b * hq * d * (s * (s + 1) // 2)   # one product
    bound_ms = 5 * causal_flops / PEAK_BF16_OPS_PER_S * 1e3
    # what the port's passes compute: 2 + 5 unmasked f32 products
    port_flops = 7 * 2 * b * hq * s * s * d
    rep = {"phase": "attention_bwd_timing", "shape": [b, hq, s, d],
           "kv_heads": hkv, "dtype": "bfloat16", "causal": True,
           "chunk": chunk, "port_ms": port_ms, "sdpa_backward_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": "operations",
           "port_f32_flops": port_flops,
           "port_f32_tflops": port_flops / (port_ms * 1e-3) / 1e12,
           "port_over_sdpa": port_ms / lib_ms,
           "port_peak_bytes": peak}
    emit(rep)
    del q, k, v, dout, leaves, o
    free_card(device)
    return rep


def phase_dryrun(args, device) -> dict:
    """Phase 3l: the diffusion dry-run at RMAT ``--dry-scale`` (26), each
    run in its own process (``python -m
    repro_torch.launch.dryrun_diffusion``: rank 0 of a fake world of 256
    or 512 ranks, on its own cell of the production shape; see that
    module) at 256 cells on pull and push and 512 cells on pull: the
    rank's argument, output and peak bytes, the collectives of a round and
    of the run.  Then the same rank's cells made here by the module's
    ``build_cell``, and K1 (and K3, at 256 cells with the push streams) on them
    bitwise their plain versions, with no process group."""
    import os

    from repro_torch.core.programs import sssp_program
    from repro_torch.core.relax import (
        active_push_blocks,
        push_caps,
        select_bucket,
    )
    from repro_torch.kernels.edge_relax import kernel, ref
    from repro_torch.launch import dryrun_diffusion as dry

    scale = args.dry_scale
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {"phase": "dryrun", "scale": scale, "runs": []}
    # the three runs at once: each builds its own cell on the host (a few
    # GB of device memory each); the walls are each process's, overlapped
    t = time.perf_counter()
    (OUT_DIR / "dryrun").mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    for cells, sweep in DRYRUN_CELLS:
        where = OUT_DIR / "dryrun" / f"{cells}-{sweep}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun_diffusion",
               "--scale", str(scale), "--sweep", sweep, "--device",
               device.type, "--seed", str(args.seed), "--out-dir",
               str(where)] + (["--multi-pod"] if cells == 512 else [])
        logs.append(open(OUT_DIR / "dryrun" / f"{cells}-{sweep}.log", "w+"))
        procs.append(subprocess.Popen(cmd, stdout=logs[-1],
                                      stderr=subprocess.STDOUT, text=True,
                                      cwd=ROOT, env=env))
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:          # a run that failed or hung stops here
            if p.poll() is None:
                p.kill()
                p.wait()
    for (cells, sweep), proc, log in zip(DRYRUN_CELLS, procs, logs):
        wall = time.perf_counter() - t
        where = OUT_DIR / "dryrun" / f"{cells}-{sweep}"
        log.seek(0)
        text = log.read()
        log.close()
        check(proc.returncode == 0, f"3l: the dry-run at {cells} cells "
              f"({sweep}) failed:\n{text[-4000:]}")
        rep = json.loads((where / f"diffusion_sssp_s{scale}_{cells}cells"
                                  f".json").read_text())
        np_ = rep["per_cell_vertices"]
        per_round = rep["collectives_per_round"]
        check(rep["rounds"] == 2 and rep["world"] ==
              f"fake group of {cells} ranks", f"3l: {rep['world']}, "
                                              f"{rep['rounds']} rounds")
        check(per_round.get("all_to_all_single", {}).get("bytes") ==
              5 * cells * np_, f"3l: a round's all_to_all {per_round}")
        if device.type == "cuda":
            check(rep["launches"].get("edge_relax_blocks", 0) > 0 or
                  sweep != "pull", f"3l: no K1 launch {rep['launches']}")
            check(rep["launches"].get("edge_relax_push_blocks", 0) > 0 or
                  sweep == "pull", f"3l: no K3 launch {rep['launches']}")
            check(rep["device"] == torch.cuda.get_device_name(0),
                  f"3l: the dry-run ran on {rep['device']}")
        line = {k: v for k, v in rep.items() if k != "calls"}
        line.update(phase="dryrun_run", wall_since_start_s=wall)
        emit(line)
        out["runs"].append(line)

    prog = sssp_program(0, track_parents=False)
    be = kernel.BLOCK_E
    holds = {}
    for cells, with_push in ((256, True), (512, False)):
        cell = dry.build_cell(scale, cells, 0, with_push=with_push,
                              seed=args.seed, device=device)
        n_keys = cells * cell["gid"].shape[1]
        g = torch.Generator(device="cpu").manual_seed(args.seed + 50)
        shape = tuple(cell["node_ok"].shape)
        vs = {"dist": (torch.rand(shape, generator=g) * 64).to(device)}
        senders = (torch.rand(shape, generator=g) < 0.5).to(device)
        tag = f"3l {cells} cells"
        hold = {"n_keys": n_keys, "edge_slots": cell["csr_key"].shape[1],
                "k1_max_abs_err": hold_k1(
                    (prog, vs, senders, cell["gid"], cell["csr_key"],
                     cell["csr_src"], cell["csr_weight"],
                     cell["csr_dst_gid"]), n_keys, tag)}
        if with_push:
            few = (torch.rand(shape, generator=g) < 0.01).to(device)
            nb = cell["push_src"].shape[-1] // be
            count = int(active_push_blocks(few, cell["push_src"], be).max())
            cap = push_caps(nb)[select_bucket(count, nb, "push")]
            idx, valid = ref.compact_push_blocks(few, cell["push_src"], be,
                                                 cap)
            hold["k3"] = hold_k3(
                (prog, vs, few, cell["gid"], cell["push_key"],
                 cell["push_src"], cell["push_weight"], cell["push_dst_gid"],
                 idx), valid, n_keys, tag, be)
            hold["k3"]["active_blocks"] = count
        holds[cells] = hold
        del cell, vs, senders
        free_card(device)
    out["kernels_vs_plain"] = holds
    emit({"phase": "dryrun_kernels", "bitwise": True, **holds})
    return out

# --------------------------------------------------------------------------
# phase 5f: GNN training on the card (K5 on the message-passing path)
# --------------------------------------------------------------------------

# the sampled runs last: the host builds their graph meanwhile
GNN_RUNS = (("gatedgcn", "full_graph_sm"), ("mace", "molecule"),
            ("equiformer-v2", "molecule"), ("equiformer-v2", "full_graph_sm"),
            ("gatedgcn", "minibatch_lg"), ("meshgraphnet", "minibatch_lg"),
            ("mace", "minibatch_lg"))
GNN_STEPS = 4
# each architecture's K5-against-plain check: the run whose batch it
# takes, at 2 layers in float32
GNN_CHECK_RUNS = (("gatedgcn", "full_graph_sm"),
                  ("meshgraphnet", "minibatch_lg"), ("mace", "molecule"),
                  ("equiformer-v2", "molecule"))
GNN_CHECK_STEPS, GNN_CHECK_RTOL = 3, 2e-5
# the CPU rehearsal's cuts: a graph of 2,000 nodes and 20,000 edges, its
# block (4 seeds, fanout (3, 2)) fits the smoke cells' 64 nodes, 256 edges
GNN_REHEARSAL = {"graph": (2000, 20_000), "seeds": 4, "fanout": (3, 2)}
# the launcher's own run (``launch.train.main``)
GNN_MAIN_ARGS, GNN_MAIN_STEPS = ("--arch", "equiformer-v2", "--shape",
                                 "molecule"), 3


def reddit_block(args):
    """One ``sample_blocks`` block (minibatch_lg's 1,024 seeds, fanout (15,
    10)) of a seeded graph of Reddit's size (232,965 vertices, 114,615,892
    edges; uniform endpoints, ``--seed``) whose CSR ``build_csr`` makes on
    the host, as ``launch.train.block_structure``."""
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import train
    from repro_torch.models.sampler import build_csr, sample_blocks

    rng = np.random.default_rng(args.seed + 23)
    shape = GNN_SHAPES["minibatch_lg"]
    n, e = ((shape.n_nodes, shape.n_edges) if not args.cpu_rehearsal
            else GNN_REHEARSAL["graph"])
    seeds, fanout = ((shape.batch_nodes, shape.fanout)
                     if not args.cpu_rehearsal else
                     (GNN_REHEARSAL["seeds"], GNN_REHEARSAL["fanout"]))
    t = time.perf_counter()
    src = rng.integers(0, n, e, dtype=np.int32)
    dst = rng.integers(0, n, e, dtype=np.int32)
    graph = build_csr(src, dst, n)
    del src, dst
    t_csr = time.perf_counter() - t
    blk = sample_blocks(graph, rng.choice(n, seeds, replace=False), fanout,
                        rng)
    st = train.block_structure(blk)
    return st, {"n": n, "edges": e, "csr_seconds": t_csr,
                "seconds": time.perf_counter() - t,
                "block_nodes": st.n_real, "block_edges": len(st.senders)}


@contextlib.contextmanager
def plain_segment_sums():
    """The GNN segment sums on their plain version (``index_add``) on the
    card, for the K5-against-plain check."""
    from repro_torch.models.gnn import common

    saved = common.segment_sum_sorted_by
    common.segment_sum_sorted_by = (
        lambda flat, s: common.segment_sum_plain(flat, s.ids,
                                                 s.num_segments))
    try:
        yield
    finally:
        common.segment_sum_sorted_by = saved


@contextlib.contextmanager
def k5_shapes(book: dict):
    """Book the GNN segment sums by shape while they run: ``book`` maps
    (E, F, N, dtype) to [K5 launches, the ids of the first call].  The
    launches are read from K5's own counter around each
    ``segment_sum_sorted_by`` call; the CPU rehearsal's plain sums book
    their shape with no launch (K5 runs only on the card)."""
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.models.gnn import common

    saved = common.segment_sum_sorted_by, common.segment_sum_plain

    def note(flat, ids, n, launches):
        key = (flat.shape[0], flat.shape[1], n,
               str(flat.dtype).replace("torch.", ""))
        book.setdefault(key, [0, ids.clone()])[0] += launches

    def sorted_by(flat, s):
        before = k5.LAUNCHES["segment_sum_sorted"]
        out = saved[0](flat, s)
        note(flat, s.ids, s.num_segments,
             k5.LAUNCHES["segment_sum_sorted"] - before)
        return out

    def plain(flat, ids, n):
        if not flat.is_cuda:
            note(flat, ids, n, 0)
        return saved[1](flat, ids, n)

    common.segment_sum_sorted_by, common.segment_sum_plain = sorted_by, plain
    try:
        yield book
    finally:
        common.segment_sum_sorted_by, common.segment_sum_plain = saved


def gnn_check(arch, cell, batch, seed: int, device) -> dict:
    """``arch`` at 2 layers in float32 on the run's batch: the forward
    pass (``apply``) and the loss twice at the same weights, bitwise equal;
    then 3 adamw steps with K5, run twice from the same weights (whether
    the losses and grad norms repeat bitwise is reported: the backward's
    own scatters may use atomics), and the same 3 steps on the plain
    segment sum: the losses within ``GNN_CHECK_RTOL``."""
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(cell.config, n_layers=2, dtype=torch.float32)
    model = steps._GNN_MODELS[arch]
    params = model.init_params(cfg, seed=seed, device=device)
    k5.reset_launches()
    with torch.no_grad():
        fwd = [model.apply(params, batch, cfg) for _ in range(2)]
        loss = [model.loss_fn(params, batch, cfg) for _ in range(2)]
    sync(device)
    out = {"forward_bitwise": same_tensor_bits(*fwd) and
           same_tensor_bits(*loss),
           "forward_k5_launches": k5.LAUNCHES["segment_sum_sorted"]}
    check(out["forward_bitwise"] and bool(torch.isfinite(loss[0])),
          f"5f {arch}: two float32 forward passes on K5 differ "
          f"(loss {float(loss[0])!r} vs {float(loss[1])!r})")
    del params, fwd, loss
    for tag, ctx in (("k5", contextlib.nullcontext),
                     ("k5_again", contextlib.nullcontext),
                     ("plain", plain_segment_sums)):
        opt = adamw(lr=1e-3, weight_decay=1e-5)
        step = steps._make_train_step(
            lambda p, b: model.loss_fn(p, b, cfg), opt)
        params = model.init_params(cfg, seed=seed, device=device)
        state = opt.init(params.tree())
        k5.reset_launches()
        losses, norms = [], []
        with ctx():
            for i in range(GNN_CHECK_STEPS):
                params, state, m = step(params, state, i, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[tag] = {"losses": losses, "grad_norms": norms,
                    "k5_launches": k5.LAUNCHES["segment_sum_sorted"]}
    out["steps_bitwise"] = {
        k: out["k5"][k] == out["k5_again"][k]
        for k in ("losses", "grad_norms")}
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(out["k5"]["losses"], out["plain"]["losses"]))
    out["max_rel_diff"] = rel
    check(all(np.isfinite(out["k5"]["losses"])) and rel <= GNN_CHECK_RTOL,
          f"5f {arch}: K5 losses against plain {out}")
    if device.type == "cuda":
        check(out["k5"]["k5_launches"] > 0 and
              out["forward_k5_launches"] > 0 and
              out["plain"]["k5_launches"] == 0,
              f"5f {arch}: K5 launches {out}")
    return out


def k5_gnn_row(batch, launches: int, device, reps: int) -> tuple:
    """K5 at gatedgcn minibatch_lg's aggregation: values [E, 70] f32 over
    the batch's receivers (masked edges to the spare segment n), through
    ``k5_row``.  Also the helper as the models call it
    (``common.segment_sum``: the sort and K5 with the gather fused; given
    ``common.segments``: K5 alone) beside its plain version
    (``segment_sum_plain``)."""
    from repro_torch.models.gnn import common

    n, e = batch.n_nodes, batch.receivers.shape[0]
    ids = torch.where(batch.edge_mask, batch.receivers, n)
    g = torch.Generator(device=device).manual_seed(70)
    values = torch.randn((e, 70), generator=g, device=device)
    row = k5_row(f"segment_sum_sorted (gatedgcn minibatch_lg: [{e}, 70] "
                 f"into {n + 1})", values, ids.to(torch.int32), n + 1,
                 launches, device, reps)
    seg = common.segments(ids, n + 1)
    clock = Clock(device)
    helper = {
        "sort_gather_k5_ms": clock.ms(
            lambda: common.segment_sum(values, ids, n + 1), reps),
        "gather_k5_ms": clock.ms(lambda: common.segment_sum(values, seg),
                                 reps),
        "sort_ms": clock.ms(lambda: common.segments(ids, n + 1), reps),
        "plain_ms": clock.ms(
            lambda: common.segment_sum_plain(values, ids, n + 1), reps)}
    return row, helper


# phase 5f's other K5 rows, each the shape of that width and dtype that
# the run gave K5 most often: meshgraphnet and mace (bf16) on the block;
# and the graph pool (F = 1) with the fewest segments in any run (mace's
# one-graph pool of the block: every node into one segment)
GNN_K5_ROWS = ((("meshgraphnet", "minibatch_lg"), 128, "float32"),
               (("mace", "minibatch_lg"), 640, "bfloat16"),
               (None, 1, "float32"))


def k5_gnn_shape_rows(books: dict, device, reps: int) -> list:
    """``GNN_K5_ROWS`` through ``k5_row``, each on the ids its run gave K5
    at that shape and seeded random values; launches: phase 5f's K5
    launches at that exact shape, all runs together.  On the CPU rehearsal
    (smoke widths, no K5) a shape of the run of any width stands in."""
    rows = []
    for run, f, dtype in GNN_K5_ROWS:
        found = [(r, k) for r, book in books.items() if run in (None, r)
                 for k in book if (k[1], k[3]) == (f, dtype)]
        if device.type != "cuda" and not found:
            found = [(r, k) for r, book in books.items() if run in (None, r)
                     for k in book]
        check(bool(found), f"5f {run}: no K5 call at F = {f} {dtype}")
        if run is None:                     # the pool: fewest segments
            r, key = min(found, key=lambda rk: (rk[1][2], -rk[1][0]))
        else:
            r, key = max(found, key=lambda rk: books[rk[0]][rk[1]][0])
        e, f_, n, dt = key
        ids = books[r][key][1].to(torch.int32)
        g = torch.Generator(device=device).manual_seed(f_)
        values = torch.randn((e, f_), generator=g, device=device).to(
            getattr(torch, dt))
        launches = sum(b[key][0] for b in books.values() if key in b)
        name = (f"segment_sum_sorted ({r[0]} {r[1]}"
                f"{' pool' if run is None else ''}: [{e}, {f_}] {dt} into "
                f"{n})")
        rows.append(k5_row(name, values, ids, n, launches, device, reps))
    return rows


def gnn_main_run(args, root) -> dict:
    """``launch.train.main`` with ``GNN_MAIN_ARGS`` (equiformer-v2 on
    molecule; the smoke config on the CPU rehearsal), ``GNN_MAIN_STEPS``
    steps: every loss and grad norm in its log finite."""
    import shutil

    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import train

    shutil.rmtree(root, ignore_errors=True)
    log = root / "log.jsonl"
    argv = [*GNN_MAIN_ARGS, "--steps", str(GNN_MAIN_STEPS),
            "--ckpt-dir", str(root), "--log", str(log)]
    if args.cpu_rehearsal:
        argv += ["--smoke", "--device", "cpu"]
    t = time.perf_counter()
    k5.reset_launches()
    train.main(argv)
    launches = k5.LAUNCHES["segment_sum_sorted"]
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    out = {"argv": argv,
           "losses": [r["loss"] for r in rows],
           "grad_norms": [r["grad_norm"] for r in rows],
           "k5_launches": launches, "seconds": time.perf_counter() - t}
    check(len(rows) == GNN_MAIN_STEPS and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in rows), f"5f launch.train.main: {out}")
    if not args.cpu_rehearsal:
        check(launches > 0, f"5f launch.train.main: K5 launches {out}")
    emit({"phase": "gnn_main", **out})
    return out


def phase_gnn(args, device, reps: int) -> tuple[dict, dict]:
    """Phase 5f: the four GNNs trained on the card through
    ``launch.steps.build_cell``, ``launch.train.data_for`` /
    ``on_device`` and ``runtime.trainer.train_loop`` at their full widths
    (the reference's config choices), ``GNN_STEPS`` steps each on one fixed
    batch (smoke configs and a cut graph on the CPU rehearsal): gatedgcn on
    full_graph_sm (``data_for``'s graph of Cora's 2,708 nodes and 10,556
    edges, padded with masks) and on minibatch_lg (``gnn_batch`` on one
    ``sample_blocks`` block, 1,024 seeds, fanout (15, 10), of a seeded
    graph of Reddit's 232,965 nodes and 114,615,892 edges, built on the
    host while the other runs train), meshgraphnet on
    the same block, mace on molecule (``data_for``'s 128 graphs of 30 atoms
    and 64 edges, float32) and on the block (bfloat16, 16 channel groups),
    equiformer-v2 on molecule (12 layers, l_max 6) and on full_graph_sm
    (remat).  Every loss finite; K5 launched every step of every run
    (counted a step); median step seconds and peak bytes a run.  Then
    ``launch.train.main`` for equiformer-v2 on molecule
    (``gnn_main_run``), each
    architecture's K5 checks (``gnn_check``) and K5 timed at gatedgcn
    minibatch_lg's aggregation (its kernels-line row: launches the runs'
    and the launcher's K5 launches) and at ``GNN_K5_ROWS``."""
    import itertools
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import steps, train
    from repro_torch.runtime.trainer import train_loop

    t0 = time.perf_counter()
    free_card(device)
    pool = ThreadPoolExecutor(1)
    pending = pool.submit(reddit_block, args)
    block = graph_rep = None
    runs, batches, books = [], {}, {}
    ckpt_root = OUT_DIR / "gnn"
    try:
        for i, (arch, shape_name) in enumerate(GNN_RUNS):
            cell = steps.build_cell(arch, shape_name,
                                    smoke=args.cpu_rehearsal, device=device)
            if shape_name == "minibatch_lg" and block is None:
                t = time.perf_counter()
                block, graph_rep = pending.result()
                graph_rep["waited_seconds"] = time.perf_counter() - t
                emit({"phase": "gnn_graph", **graph_rep})
            host = (itertools.repeat(train.gnn_batch(
                        cell, args.seed + i, structure=block))
                    if shape_name == "minibatch_lg" else train.data_for(cell))
            data = train.on_device(host, device)
            batch = next(data)
            if (arch, shape_name) in GNN_CHECK_RUNS:
                batches[arch] = (cell, batch)
            ckpt = ckpt_root / f"{arch}-{shape_name}"
            shutil.rmtree(ckpt, ignore_errors=True)
            rows = []

            def on_metrics(step, m, dt):
                rows.append({"step": step, "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "seconds": dt, "k5_launches":
                             k5.LAUNCHES["segment_sum_sorted"]})
                k5.reset_launches()

            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            params = cell.init_params(args.seed)
            opt_state = cell.init_opt(params)
            k5.reset_launches()
            with k5_shapes(books.setdefault((arch, shape_name), {})):
                params, opt_state, _ = train_loop(
                    cell.step, params, opt_state,
                    itertools.chain([batch], data), GNN_STEPS, str(ckpt),
                    ckpt_every=GNN_STEPS, on_metrics=on_metrics)
            if args.profile and device.type == "cuda":
                emit(trace(f"gnn_{arch}_{shape_name}", lambda: cell.step(
                    params, opt_state, GNN_STEPS, batch)))
            cfg = cell.config
            run = {"arch": arch, "shape": shape_name, "dtype": str(cfg.dtype),
                   "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
                   "n": batch.n_nodes, "edges": int(batch.senders.shape[0]),
                   "real_nodes": int(batch.node_mask.sum()),
                   "real_edges": int(batch.edge_mask.sum()),
                   **{k: getattr(cfg, k) for k in (
                       "edge_chunks", "remat", "channel_groups", "l_max")
                      if hasattr(cfg, k)},
                   "losses": [r["loss"] for r in rows],
                   "grad_norms": [r["grad_norm"] for r in rows],
                   "step_seconds": [r["seconds"] for r in rows],
                   "step_seconds_median": float(np.median(
                       [r["seconds"] for r in rows])),
                   "k5_launches_per_step": [r["k5_launches"] for r in rows],
                   "peak_bytes": (torch.cuda.max_memory_allocated()
                                  if device.type == "cuda" else None)}
            emit({"phase": "gnn_run", **run})
            runs.append(run)
            check(len(rows) == GNN_STEPS and all(
                np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                for r in rows), f"5f {arch} {shape_name}: {rows}")
            if device.type == "cuda":
                check(all(r["k5_launches"] > 0 for r in rows),
                      f"5f {arch} {shape_name}: K5 was not launched every "
                      f"step: {[r['k5_launches'] for r in rows]}")
                booked = sum(c[0] for c in books[(arch, shape_name)].values())
                check(booked == sum(run["k5_launches_per_step"]),
                      f"5f {arch} {shape_name}: {booked} K5 launches booked "
                      f"by shape, {run['k5_launches_per_step']} counted")
            if shape_name == "minibatch_lg" and arch == "gatedgcn":
                row_batch = batch
            del params, opt_state, batch, data
            if (arch, shape_name) not in GNN_CHECK_RUNS:
                free_card(device)
        main_run = gnn_main_run(args, ckpt_root / "main")
        checks = {arch: gnn_check(arch, cell, batch, args.seed, device)
                  for arch, (cell, batch) in batches.items()}
    finally:
        pool.shutdown()
        shutil.rmtree(ckpt_root, ignore_errors=True)
    del batches
    free_card(device)
    launches = sum(sum(r["k5_launches_per_step"]) for r in runs) + \
        main_run["k5_launches"]
    row, helper = k5_gnn_row(row_batch, launches, device, reps)
    shape_rows = k5_gnn_shape_rows(books, device, reps)
    for r in (row, *shape_rows):
        emit({"phase": "gnn_k5", **{k: r[k] for k in (
            "name", "dtype", "launches", "ms", "bound_ms", "gather_ms",
            "gather_bound_ms", "plain_ms", "library_ms", "bitwise")}})
    rep = {"phase": "gnn", "graph": graph_rep, "runs": runs,
           "main_run": main_run, "checks": checks,
           "check_rtol": GNN_CHECK_RTOL, "k5_launches": launches,
           "segment_sum_helper": helper, "k5_rows": shape_rows,
           "k5_calls_by_shape": {
               f"{a} {sh}": {f"[{e}, {f}] {dt} into {n}": c[0]
                             for (e, f, n, dt), c in b.items()}
               for (a, sh), b in books.items()},
           "seconds": time.perf_counter() - t0,
           **{k: row[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}
    emit(rep)
    return rep, row


# --------------------------------------------------------------------------
# phase 5g: two-tower retrieval at full width
# --------------------------------------------------------------------------

RECSYS_ARCH = "two-tower-retrieval"
RECSYS_STEPS = 4
# the float32 check: 3 steps on K5 and 3 on the plain bag, at a batch
# whose plain gather ([B, 8, 16, 256] f32, 1 GB) fits beside the state;
# adamw moves an element whose gradient is rounding noise by up to 2 lr
RECSYS_CHECK_BATCH, RECSYS_CHECK_STEPS, RECSYS_CHECK_RTOL = 8192, 3, 1e-4
RECSYS_P99_CALLS, RECSYS_BULK_CALLS, RECSYS_QUERIES = 200, 5, 50
RECSYS_MAIN_STEPS = 3
# the descent probe: a plain step of this size along the step-0 gradient
# (adamw's own first step, about lr * sign(g) on every touched table
# element, raises the loss on its batch at this batch size, in the
# reference too: ROADMAP queue 3)
RECSYS_PROBE_LR = 1e-3
# K5 against F.embedding_bag(mode="sum"): float32 sums of 16 rows in
# another order, within 1e-5 of the sums of |rows|
RECSYS_LIBRARY_TOL = 1e-5


@contextlib.contextmanager
def recsys_k5_book(book: dict):
    """Book the embedding bags' K5 launches while they run: ``book`` maps
    (value rows, E, F, N, dtype) to launches, read from K5's own counter
    around each of ``ops.gather_segment_sum``'s ``segment_sum_sorted``
    calls: the forward reads a table ([V, F] into N bags), the table
    gradient the output gradient ([N, F] into V rows)."""
    from repro_torch.kernels.segment_reduce import kernel as k5, ops

    saved = ops.segment_sum_sorted

    def booked(values, sorted_ids, n, **kw):
        before = k5.LAUNCHES["segment_sum_sorted"]
        out = saved(values, sorted_ids, n, **kw)
        key = (values.shape[0], sorted_ids.shape[0], values.shape[1], n,
               str(values.dtype).replace("torch.", ""))
        book[key] = book.get(key, 0) + \
            k5.LAUNCHES["segment_sum_sorted"] - before
        return out

    ops.segment_sum_sorted = booked
    try:
        yield book
    finally:
        ops.segment_sum_sorted = saved


@contextlib.contextmanager
def plain_bags():
    """The two-tower bags and lookups on their plain version (masked
    gather + ``index_add``) on the card, for the K5-against-plain check."""
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.models import recsys

    saved = recsys.gather_segment_sum
    recsys.gather_segment_sum = ops.gather_segment_sum_plain
    try:
        yield
    finally:
        recsys.gather_segment_sum = saved


def recsys_batch(cfg, b: int, seed: int, device, keys=None) -> dict:
    """One ``RecsysPipeline`` batch of ``b`` rows (seed ``seed``) on the
    device, restricted to ``keys``."""
    from repro_torch.data.pipeline import RecsysPipeline

    host = next(RecsysPipeline(b, cfg, seed=seed))
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()
            if keys is None or k in keys}


def k5_bag_rows(cfg, params, batch, launches: dict, device, reps,
                tag: str | None = None) -> list:
    """K5 at train_batch's bag shape, through the sorts the model's calls
    make: the forward (the user table [V, D] read through the slots of
    ``batch``'s user bags into B F bags) and the table gradient (a seeded
    output gradient [B F, D] read through the slots sorted by table row
    into V rows), each bitwise its plain version on the same arguments,
    ``K5_REPEATS`` more launches bitwise the first, and timed beside the
    plain version and the library: ``F.embedding_bag(mode="sum",
    per_sample_weights=mask)`` (its output within ``RECSYS_LIBRARY_TOL``
    of the sums of |rows|) and that call's own backward (autograd, the
    dense table gradient).  Bytes: the distinct table rows the slots read
    (this batch's), ``order``, ``offsets`` and the output once; for the
    gradient the output gradient, ``order``, ``offsets`` and the [V, D]
    gradient once.  ``launches``: phase 5g's K5 launches at each shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.segment_reduce import kernel, ops, ref

    table = params["user_table"].detach()
    ids = batch["user_ids"]
    l_ = ids.shape[-1]
    rows = ids.reshape(-1)
    e, (vocab, d) = rows.shape[0], table.shape
    n = e // l_
    bags = torch.arange(e, dtype=torch.int32, device=device) // l_
    keys = ops.slot_keys(rows, bags, n, vocab)
    g = torch.Generator(device=device).manual_seed(25)
    cot = torch.randn((n, d), generator=g, device=device)
    mask = (ids.reshape(n, l_) >= 0).float()
    lib_in = ids.reshape(n, l_).clamp(min=0).long()
    leaf = table.clone().requires_grad_(True)
    lib_out = F.embedding_bag(lib_in, leaf, mode="sum",
                              per_sample_weights=mask)
    distinct = int(torch.unique(rows[rows >= 0]).shape[0])
    out = []
    for direction, s, values, segs in (
            ("bag", ops.bag_order(rows, keys, n), table, n),
            ("table_grad", ops.table_order(rows, keys, n, vocab), cot,
             vocab)):
        def call():
            return kernel.segment_sum_sorted(values, s.sorted_ids, segs,
                                             order=s.order,
                                             offsets=s.offsets)

        def plain():
            return ref.segment_sum_sorted_ref(values, s.sorted_ids, segs,
                                              order=s.order,
                                              offsets=s.offsets)

        if direction == "bag":
            def library():
                return F.embedding_bag(lib_in, table, mode="sum",
                                       per_sample_weights=mask)
            read = distinct * d * 4
        else:
            def library():
                return torch.autograd.grad(lib_out, leaf, cot,
                                           retain_graph=True)[0]
            read = n * d * 4
        want, got = plain(), call()
        repeats = all(same_tensor_bits(call(), got)
                      for _ in range(K5_REPEATS))
        lib = library()
        sync(device)
        check(same_tensor_bits(got, want),
              f"5g K5 {direction}: not bitwise its plain version (max abs "
              f"{float((got - want).abs().max())})")
        check(repeats, f"5g K5 {direction}: repeated launches differ")
        if direction == "bag":
            mag = ops.gather_segment_sum_plain(table.abs(), rows, bags, n)[0]
        else:
            mag = ops.gather_segment_sum_plain(
                cot.abs(), torch.where(keys < n, keys, -1),
                torch.where(keys < n, rows, vocab), vocab)[0]
        lib_err = float((lib - got).abs().max())
        check(bool(((lib - got).abs() <= RECSYS_LIBRARY_TOL * mag +
                    1e-30).all()),
              f"5g K5 {direction} against the library: max abs {lib_err}")
        del want, got, lib, mag
        clock = Clock(device)
        k_ms = clock.ms(call, reps)
        p_ms = clock.ms(plain, 2, warmup=1)
        lib_ms = clock.ms(library, reps)
        nbytes = read + 4 * e + 4 * (segs + 1) + segs * d * 4
        shape = (values.shape[0], e, d, segs, "float32")
        name = (f"segment_sum_sorted (two-tower bags: table [{vocab}, {d}] "
                f"f32 through [{e}] slots into {n})" if direction == "bag"
                else f"segment_sum_sorted (two-tower table gradient: "
                f"[{n}, {d}] f32 through [{e}] slots into {vocab})")
        if tag:
            name = name.replace("(two-tower", f"({tag}: two-tower")
        row = kernel_row(name, K5_SOURCE, K5_REPLACES,
                         launches.get(shape, 0), 0.0, k_ms, p_ms, nbytes,
                         e * d, lib_ms)
        row.update(dtype="float32", bitwise=True, repeats=K5_REPEATS,
                   library="F.embedding_bag" + (" backward" if direction
                                                == "table_grad" else ""),
                   library_max_abs_err=lib_err, distinct_rows=distinct)
        emit({"phase": "recsys_k5", **{k: row[k] for k in (
            "name", "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_max_abs_err", "bytes", "distinct_rows")}})
        out.append(row)
    del leaf, lib_out
    return out


def descent_probe(params, batch, cfg, lr: float) -> float:
    """The loss on ``batch`` after a plain step of ``lr`` along its own
    gradient (every leaf, the tables' dense gradients on K5 included);
    ``params`` are restored bit for bit after."""
    from repro_torch.models import recsys
    from repro_torch.optim import tree_leaves

    leaves = tree_leaves(params.requires_grad_(True).tree())
    grads = torch.autograd.grad(recsys.loss_fn(params, batch, cfg), leaves)
    with torch.no_grad():
        saved = [x.clone() for x in leaves]
        for x, g in zip(leaves, grads):
            x.sub_(g, alpha=lr)
        del grads
        moved = float(recsys.loss_fn(params, batch, cfg))
        for x, s in zip(leaves, saved):
            x.copy_(s)
    return moved


def recsys_check(args, cfg, device) -> dict:
    """Three adamw steps (the cell's step, float32, full-width tables) at
    ``RECSYS_CHECK_BATCH`` on K5 and the same three on the plain bag
    (``plain_bags``), from the same seeded weights on the same batches:
    every loss within ``RECSYS_CHECK_RTOL`` relative; K5 launched 4 times
    a step on K5, never on the plain bag."""
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import steps

    b = 8 if args.cpu_rehearsal else RECSYS_CHECK_BATCH
    cell = steps.build_cell(RECSYS_ARCH, "train_batch",
                            smoke=args.cpu_rehearsal, batch=b, device=device)
    batches = [recsys_batch(cfg, b, args.seed + 30 + i, device)
               for i in range(RECSYS_CHECK_STEPS)]
    out = {"batch": b}
    for tag, ctx in (("k5", contextlib.nullcontext), ("plain", plain_bags)):
        params = cell.init_params(args.seed + 3)
        state = cell.init_opt(params)
        k5.reset_launches()
        losses = []
        with ctx():
            for i, batch in enumerate(batches):
                params, state, m = cell.step(params, state, i, batch)
                losses.append(float(m["loss"]))
        out[tag] = {"losses": losses,
                    "k5_launches": k5.LAUNCHES["segment_sum_sorted"]}
        del params, state
        free_card(device)
    rel = max(abs(a - b_) / max(abs(b_), 1e-30)
              for a, b_ in zip(out["k5"]["losses"], out["plain"]["losses"]))
    out.update(max_rel_diff=rel, rtol=RECSYS_CHECK_RTOL)
    check(all(np.isfinite(out["k5"]["losses"])) and rel <= RECSYS_CHECK_RTOL,
          f"5g K5 losses against the plain bag: {out}")
    if device.type == "cuda":
        check(out["k5"]["k5_launches"] == 4 * RECSYS_CHECK_STEPS and
              out["plain"]["k5_launches"] == 0, f"5g check launches {out}")
    return out


def recsys_main_run(args, root, book) -> dict:
    """``launch.train.main`` for two-tower retrieval (its default shape,
    train_batch; the smoke config on the CPU rehearsal),
    ``RECSYS_MAIN_STEPS`` steps with no snapshot (``--ckpt-every 0``: the
    tables and their adamw moments would write ~12.3 GB): every logged
    loss and grad norm finite."""
    import shutil

    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import train

    shutil.rmtree(root, ignore_errors=True)
    log = root / "log.jsonl"
    argv = ["--arch", RECSYS_ARCH, "--steps", str(RECSYS_MAIN_STEPS),
            "--ckpt-dir", str(root), "--ckpt-every", "0", "--log", str(log)]
    if args.cpu_rehearsal:
        argv += ["--smoke", "--device", "cpu"]
    t = time.perf_counter()
    k5.reset_launches()
    try:
        with recsys_k5_book(book):
            train.main(argv)
        launches = k5.LAUNCHES["segment_sum_sorted"]
        rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"argv": argv, "losses": [r["loss"] for r in rows],
           "grad_norms": [r["grad_norm"] for r in rows],
           "step_seconds": [r["seconds"] for r in rows],
           "k5_launches": launches, "seconds": time.perf_counter() - t}
    check(len(rows) == RECSYS_MAIN_STEPS and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in rows), f"5g launch.train.main: {out}")
    if not args.cpu_rehearsal:
        check(launches == 4 * RECSYS_MAIN_STEPS,
              f"5g launch.train.main: K5 launches {out}")
    emit({"phase": "recsys_main", **out})
    return out


def phase_recsys(args, device, reps: int) -> tuple[dict, list]:
    """Phase 5g: two-tower retrieval at its published widths (2,000,000 x
    256 float32 tables, tower MLPs 1024-512-256, seeded weights; the smoke
    config on the CPU rehearsal) through ``launch.steps.build_cell`` and
    ``launch.train``'s data (``data_for``: ``RecsysPipeline``), with K5
    booked by shape (``recsys_k5_book``) over the main path:
    train_batch (65,536 users x 8 fields x 16 slots, adamw 1e-3),
    ``RECSYS_STEPS`` steps, step 0 cold: s a step (median after the
    first), examples/s, peak bytes, K5 launches a step (4: the user bags
    and the item lookup, forward and table gradient), the loss on step 0's
    batch before and after a plain step of ``RECSYS_PROBE_LR`` along its
    gradient (it must fall: ``descent_probe``) and after step 0's adamw
    update (reported: that step raises it at this batch); serve_p99
    (512 rows): ``RECSYS_P99_CALLS`` scoring calls, each synchronized,
    median and p99 ms on the host clock; serve_bulk (262,144 rows): ms a
    call and rows/s; retrieval_cand (one query against 1,000,448
    candidates, top-100): ms a query beside the candidates' bytes over
    3.35 TB/s, and the top-100 indices equal a host ranking of the same
    scores; ``launch.train.main`` 3 steps (``recsys_main_run``).  Then the
    float32 check (``recsys_check``) and K5 at the bag shape
    (``k5_bag_rows``: the kernels line's two two-tower rows).  With
    ``--profile`` one training step is traced."""
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import steps, train
    from repro_torch.models import recsys

    t0 = time.perf_counter()
    free_card(device)
    rehearsal = args.cpu_rehearsal
    book = {}
    cell = steps.build_cell(RECSYS_ARCH, "train_batch", smoke=rehearsal,
                            device=device)
    cfg = cell.config
    b = cell.input_specs()["item_ids"].shape[0]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = cell.init_params(args.seed)
    opt_state = cell.init_opt(params)
    data = train.on_device(Prefetcher(train.data_for(cell)), device)
    batch0 = next(data)
    sync(device)
    setup_s = time.perf_counter() - t
    rows = []
    with torch.no_grad():
        before = float(recsys.loss_fn(params, batch0, cfg))
    descended = descent_probe(params, batch0, cfg, RECSYS_PROBE_LR)
    free_card(device)
    batch = batch0
    for i in range(RECSYS_STEPS):
        t = time.perf_counter()
        k5.reset_launches()
        with recsys_k5_book(book):
            params, opt_state, m = cell.step(params, opt_state, i, batch)
            loss = float(m["loss"])
        rows.append({"step": i, "loss": loss,
                     "grad_norm": float(m["grad_norm"]),
                     "seconds": time.perf_counter() - t,
                     "k5_launches": k5.LAUNCHES["segment_sum_sorted"]})
        if i == 0:
            with torch.no_grad():
                after = float(recsys.loss_fn(params, batch0, cfg))
        batch = next(data)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    profile = None
    if args.profile and device.type == "cuda":
        profile = trace("recsys_train_step", lambda: cell.step(
            params, opt_state, RECSYS_STEPS, batch))
    bag_batch = {"user_ids": batch0["user_ids"]}
    del opt_state, batch, batch0, data
    free_card(device)
    serve = recsys_serving(args, params, cfg, book, device)
    retrieval = recsys_retrieval(args, params, cfg, book, device)
    del params
    free_card(device)
    main_run = recsys_main_run(args, OUT_DIR / "recsys", book)
    secs = [r["seconds"] for r in rows]
    med = float(np.median(secs[1:]))
    run = {"arch": cfg.name, "shape": "train_batch", "batch": b,
           "dtype": str(cfg.dtype), "embed_dim": cfg.embed_dim,
           "vocab": [cfg.user_vocab, cfg.item_vocab],
           "tower_mlp": list(cfg.tower_mlp), "optimizer": "adamw(lr=1e-3)",
           "setup_s": setup_s, "steps": rows,
           "step_seconds_median_after_first": med,
           "examples_per_s": b / med, "peak_bytes": peak,
           "k5_launches_per_step": [r["k5_launches"] for r in rows],
           # the loss on step 0's batch: before, after a plain gradient
           # step of RECSYS_PROBE_LR, after step 0's adamw update
           "step0_batch_loss": [before, descended, after]}
    emit({"phase": "recsys_train", **run})
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rows), f"5g a loss or grad norm is not finite: {rows}")
    check(descended < before, f"5g a gradient step did not lower the loss "
                              f"on its own batch: {[before, descended]}")
    if device.type == "cuda":
        check(all(r["k5_launches"] == 4 for r in rows),
              f"5g K5 launches a step {run['k5_launches_per_step']}, not 4")
        booked = sum(book.values())
        launched = sum(run["k5_launches_per_step"]) + \
            serve["k5_launches"] + retrieval["k5_launches"] + \
            main_run["k5_launches"]
        check(booked == launched, f"5g {booked} K5 launches booked by "
                                  f"shape, {launched} counted")
    if profile is not None:
        emit(profile)
    check_rep = recsys_check(args, cfg, device)
    # K5 at train_batch's bag shape, on weights of the run's seed
    params = recsys.init_params(cfg, seed=args.seed, device=device)
    k5_rows = k5_bag_rows(cfg, params, bag_batch, book, device, reps)
    del params, bag_batch
    free_card(device)
    rep = {"phase": "recsys", "train": run, "serve": serve,
           "retrieval": retrieval, "main_run": main_run, "check": check_rep,
           "k5_calls_by_shape": {" ".join(map(str, k)): v
                                 for k, v in book.items()},
           "seconds": time.perf_counter() - t0}
    emit(rep)
    return rep, k5_rows


# serve_bulk's bags checked against K5's plain version this many bags at a
# time (the plain version gathers every slot's row: 34 GB at once)
RECSYS_BULK_CHECK_BAGS = 262_144


def k5_bag_check(table, ids, device) -> int:
    """K5 over all of ``ids``' bags (one launch, as the model's forward
    makes it) bitwise its plain version, computed ``RECSYS_BULK_CHECK_BAGS``
    bags at a time on the same sorted slots (a bag's sum reads only its own
    slots, so the pieces are the whole's bits); returns the pieces."""
    from repro_torch.kernels.segment_reduce import kernel, ops, ref

    l_ = ids.shape[-1]
    rows = ids.reshape(-1)
    n = rows.shape[0] // l_
    bags = torch.arange(rows.shape[0], dtype=torch.int32,
                        device=device) // l_
    s = ops.bag_order(rows, ops.slot_keys(rows, bags, n, table.shape[0]), n)
    got = kernel.segment_sum_sorted(table, s.sorted_ids, n, order=s.order,
                                    offsets=s.offsets)
    cuts = s.offsets.cpu().tolist()
    pieces = 0
    for c0 in range(0, n, RECSYS_BULK_CHECK_BAGS):
        c1 = min(n, c0 + RECSYS_BULK_CHECK_BAGS)
        lo, hi = cuts[c0], cuts[c1]
        want = ref.segment_sum_sorted_ref(
            table, s.sorted_ids[lo:hi] - c0, c1 - c0, order=s.order[lo:hi])
        check(same_tensor_bits(got[c0:c1], want),
              f"5g serve_bulk: K5 bags {c0}-{c1} not bitwise their plain "
              f"version")
        pieces += 1
    return pieces


def recsys_serving(args, params, cfg, book, device) -> dict:
    """serve_p99 and serve_bulk through their cells' ``step`` (``score``
    without autograd) on ``params``: the p99 cell's calls one at a time
    (each synchronized; median and p99 of the host clock), the bulk
    cell's ms a call and rows/s; every score finite and in [-1, 1]; K5 at
    serve_bulk's user bags bitwise its plain version (``k5_bag_check``:
    the kernel's 64-bit row offsets and scratch past 2^31 elements)."""
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import steps

    out = {}
    k5.reset_launches()
    for shape, calls in (("serve_p99", RECSYS_P99_CALLS),
                         ("serve_bulk", RECSYS_BULK_CALLS)):
        cell = steps.build_cell(RECSYS_ARCH, shape,
                                smoke=args.cpu_rehearsal, device=device)
        b = cell.input_specs()["item_ids"].shape[0]
        batch = recsys_batch(cfg, b, args.seed + 40, device,
                             cell.input_specs().keys())
        ms = []
        with recsys_k5_book(book):
            for _ in range(3):
                scores = cell.step(params, batch)
            sync(device)
            for _ in range(calls):
                t = time.perf_counter()
                cell.step(params, batch)
                sync(device)
                ms.append((time.perf_counter() - t) * 1e3)
        check(scores.shape == (b,) and bool(torch.isfinite(scores).all())
              and float(scores.abs().max()) <= 1 + 1e-5,
              f"5g {shape}: scores not finite [B] in [-1, 1]")
        if shape == "serve_bulk":
            # E = 33,554,432 slots of 256 columns: E F past 2^31; the
            # check's own launch is not the serving path's
            n = k5.LAUNCHES["segment_sum_sorted"]
            out["serve_bulk_k5_bitwise_pieces"] = k5_bag_check(
                params["user_table"].detach(), batch["user_ids"], device)
            k5.LAUNCHES["segment_sum_sorted"] = n
        out[shape] = {"batch": b, "calls": calls,
                      "median_ms": float(np.median(ms)),
                      "p99_ms": float(np.percentile(ms, 99)),
                      "max_ms": max(ms),
                      "rows_per_s": b / (float(np.median(ms)) * 1e-3)}
        del batch, scores
        free_card(device)
    out["k5_launches"] = k5.LAUNCHES["segment_sum_sorted"]
    emit({"phase": "recsys_serve", **out})
    return out


def recsys_retrieval(args, params, cfg, book, device) -> dict:
    """retrieval_cand through its cell's ``step``: one query against the
    padded candidate matrix (seeded normal rows), top-100; ms a query
    (``RECSYS_QUERIES`` calls, each synchronized, host clock) beside its
    bound, the candidates read once over 3.35 TB/s; the indices equal a
    host ranking (numpy, stable) of the same scores."""
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch import steps
    from repro_torch.models import recsys

    cell = steps.build_cell(RECSYS_ARCH, "retrieval_cand",
                            smoke=args.cpu_rehearsal, device=device)
    spec = cell.input_specs()
    batch = recsys_batch(cfg, spec["user_ids"].shape[0], args.seed + 50,
                         device, spec.keys())
    g = torch.Generator(device=device).manual_seed(args.seed + 50)
    batch["cand_emb"] = torch.randn(spec["cand_emb"].shape, generator=g,
                                    device=device)
    k5.reset_launches()
    ms = []
    with recsys_k5_book(book):
        values, idx = cell.step(params, batch)
        for _ in range(RECSYS_QUERIES):
            t = time.perf_counter()
            cell.step(params, batch)
            sync(device)
            ms.append((time.perf_counter() - t) * 1e3)
    launches = k5.LAUNCHES["segment_sum_sorted"]
    with torch.no_grad():
        u = recsys.user_tower(params, batch["user_ids"],
                              batch["user_dense"], cfg)
        scores = (batch["cand_emb"] @ u[0]).float().cpu().numpy()
    host = np.argsort(-scores, kind="stable")[:idx.shape[0]]
    same = bool(np.array_equal(idx.cpu().numpy(), host))
    check(idx.dtype == torch.int32 and idx.shape == (100,) and same and
          bool(torch.isfinite(values).all()),
          f"5g retrieval_cand: top-100 differs from the host ranking")
    cand = batch["cand_emb"]
    bound_ms = cand.numel() * cand.element_size() / PEAK_BYTES_PER_S * 1e3
    out = {"candidates": cand.shape[0], "k": idx.shape[0],
           "median_ms": float(np.median(ms)), "min_ms": min(ms),
           "p99_ms": float(np.percentile(ms, 99)), "bound_ms": bound_ms,
           "top_k_equals_host": same, "k5_launches": launches}
    emit({"phase": "recsys_retrieval", **out})
    del batch, cand
    return out


# --------------------------------------------------------------------------
# phase 5h: command-r-plus-104b at its published widths, a cut depth
# --------------------------------------------------------------------------

CR_ARCH = "command-r-plus-104b"
# 20 of 64 layers in bf16: 20 x 3.146 GB + the 6.29 GB embedding = 69.2
# GB of weights, with the KV cache and init's float32 temporaries inside
# the card's 85 GB (24 layers would not be)
CR_SERVE_LAYERS, CR_CHECK_LAYERS = 20, 2
CR_DECODE_AT = 127


def cr_config(args, layers: int, dtype=torch.bfloat16):
    """command-r-plus at its published widths cut to ``layers`` layers
    (the smoke config on the CPU rehearsal)."""
    from repro_torch.configs import registry

    mod = registry.get_module(CR_ARCH)
    if args.cpu_rehearsal:
        return mod.smoke_config(dtype=dtype)
    return dataclasses.replace(mod.make_config(dtype=dtype), n_layers=layers)


def phase_cr_checks(args, device) -> dict:
    """Phase 5h's float32 check: command-r-plus at its widths on
    ``CR_CHECK_LAYERS`` layers (the parallel block, LayerNorm, logit_scale
    0.0625, tied embeddings): prefill logits on K4 against the same model
    on the plain attention, and the decode logits at p = ``CR_DECODE_AT``
    against the last logits of a prefill over p + 1 tokens; 1e-3 max abs,
    as phases 5b and 5d."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.models import transformer as tf

    cfg = cr_config(args, CR_CHECK_LAYERS, dtype=torch.float32)
    plen = 16 if args.cpu_rehearsal else args.prompt_len
    p = min(plen, CR_DECODE_AT + 1) - 1
    free = check_free(device, model_bytes(cfg, 1, plen + 1), "5h f32")
    params = tf.init_params(cfg, seed=args.seed + 4, device=device)
    rng = np.random.default_rng(args.seed + 4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(
        device)
    k4.reset_launches()
    logits, _ = tf.prefill(params, prompt, cfg, max_len=plen + 1)
    launches = k4.LAUNCHES["flash_attention"]
    with mock.patch.object(tf, "attention", plain_attention):
        want, _ = tf.prefill(params, prompt, cfg, max_len=plen + 1)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _, cache = tf.prefill(params, prompt[:, :p], cfg, max_len=p + 1)
    dec, _ = tf.decode_step(params, nxt, cache, p, cfg)
    longer, _ = tf.prefill(params, torch.cat([prompt[:, :p], nxt], 1), cfg,
                           max_len=p + 1)
    sync(device)
    err_k4 = float((logits - want).abs().max())
    err_dec = float((dec - longer).abs().max())
    check(bool(torch.isfinite(logits).all()) and logits.shape ==
          (1, 1, cfg.vocab), "5h prefill logits are not finite [1, 1, V]")
    check(err_k4 <= 1e-3, f"5h f32 prefill on K4 vs plain attention: "
                          f"{err_k4}")
    check(err_dec <= 1e-3, f"5h f32 decode vs prefill over p + 1 at p = "
                           f"{p}: {err_dec}")
    if device.type == "cuda":
        check(launches == cfg.n_layers, f"5h K4 launched {launches} times "
                                        f"in a prefill of {cfg.n_layers} "
                                        f"layers")
    rep = {"phase": "cr_checks", "arch": cfg.name, "dtype": "float32",
           "layers": cfg.n_layers, "prompt_len": plen, "decode_at": p,
           "free_bytes_before": free, "k4_launches": launches,
           "logit_absmax": float(logits.abs().max()),
           "k4_vs_plain_max_abs": err_k4,
           "decode_vs_prefill_max_abs": err_dec, "tolerance": 1e-3}
    emit(rep)
    del params, cache, logits, want, dec, longer
    free_card(device)
    return rep


def phase_command_r(args, device) -> tuple[dict, dict]:
    """Phase 5h: command-r-plus-104b at its published widths (d_model
    12,288, 96 query heads on 8 KV heads, d_ff 33,792, vocab 256,000,
    LayerNorm, the parallel block, logit_scale 0.0625, tied embeddings)
    served in bf16 through ``DecodeServer`` as phase 5 serves tinyllama
    (``phase_serve``: 4 slots, 4 prompts of 1024 tokens, 32 decode steps),
    cut to ``CR_SERVE_LAYERS`` of 64 layers; then the float32 check on 2
    layers (``phase_cr_checks``)."""
    free_card(device)
    cfg = cr_config(args, CR_SERVE_LAYERS)
    served = phase_serve(args, device, cfg, phase="cr_serve")
    checks = phase_cr_checks(args, device)
    return served, checks


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# phase 5i: the sharded LM (dist/, torch.distributed, K4 per shard)
# --------------------------------------------------------------------------

SHARD_RANKS, SHARD_MESH = 4, (2, 2)
SHARD_LAYERS, SHARD_MICRO = 2, 4
# the MoE layer alone at this capacity factor drops rows on random inputs
LAYER_CAPACITY = 0.25


def shard_config(args, arch: str, layers, dtype):
    """``arch`` at its published widths cut to ``layers`` layers (None:
    all) in ``dtype``; the smoke config on the CPU rehearsal."""
    import dataclasses

    from repro_torch.configs import registry

    mod = registry.get_module(arch)
    cfg = (mod.smoke_config(dtype=dtype) if args.cpu_rehearsal
           else mod.make_config(dtype=dtype))
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)


def shard_tokens(args, cfg, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32))


@contextlib.contextmanager
def recording_kept():
    """``moe.kept_rows`` wrapped to keep each call's (expert ids [T, k],
    the [T, k] mask of the rows the capacity keeps): the sharded MoE layer
    decides its drops with it, on the whole batch's routing."""
    from unittest import mock

    from repro_torch.models import moe

    kept, real = [], moe.kept_rows

    def recorded(expert_idx, cfg):
        out = real(expert_idx, cfg)
        kept.append((expert_idx, out))
        return out

    with mock.patch.object(moe, "kept_rows", recorded):
        yield kept


@contextlib.contextmanager
def recording_comms():
    """A dispatch mode that books the collectives run inside it by op
    (``_c10d_functional::*``, DTensor's, and ``c10d::*``, the explicit
    ones): {op: [calls, bytes of their tensor arguments]}.  A collective
    DTensor runs inside an op's dispatch in C++ is not seen, so the book
    is a floor (``repro_torch.dist.comms.BookedGroup``, a process group,
    sees them all)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    book: dict = {}

    class Book(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if name.split("::")[0] in ("_c10d_functional", "c10d") and \
                    "wait" not in name and "wrap" not in name:
                nbytes = sum(t.numel() * t.element_size() for t in
                             tree_leaves((args, kwargs))
                             if isinstance(t, torch.Tensor))
                row = book.setdefault(name, [0, 0])
                row[0] += 1
                row[1] += nbytes
            return func(*args, **(kwargs or {}))

    with Book():
        yield book


def grads_on_host():
    """:func:`grads_of_step` keeping host copies of the rank's blocks (the
    card keeps only what the step itself holds)."""
    from unittest import mock

    from repro_torch.launch import steps
    from repro_torch.optim import tree_map

    seen, real = [], steps.clip_by_global_norm

    def recorded(tree, max_norm):
        seen.append(tree_map(lambda g: (g.to_local() if hasattr(
            g, "to_local") else g).detach().cpu(), tree))
        return real(tree, max_norm)

    return mock.patch.object(steps, "clip_by_global_norm", recorded), seen


def grads_of_step():
    """``launch.steps.clip_by_global_norm`` wrapped to keep the train
    step's gradients (the tree it clips), in the list yielded."""
    from unittest import mock

    from repro_torch.launch import steps

    seen, real = [], steps.clip_by_global_norm

    def recorded(tree, max_norm):
        seen.append(tree)
        return real(tree, max_norm)

    return mock.patch.object(steps, "clip_by_global_norm", recorded), seen


def full_tree(tree) -> dict:
    """{leaf name: the global tensor} of a tree of DTensors (a
    collective)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import flatten

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach()
            for k, v in flatten(tree).items()}


def _tiny_step(args, device, mesh, layers, dtype, b: int, s: int):
    """(loss, params, opt state, the cell, K4 launches, gradients) of one
    sharded train step of tinyllama-1.1b (``train_4k``, batch cut to b x
    s, adafactor) on ``mesh`` with seeded weights."""
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import steps

    cfg = shard_config(args, "tinyllama-1.1b", layers, dtype)
    cell = steps.build_cell("tinyllama-1.1b", "train_4k", batch=b,
                            device=device, config=cfg)
    params = cell.init_params(args.seed + 9)
    params = steps.place(params, cell.param_shardings(mesh, params))
    opt = cell.init_opt(params)
    toks = shard_tokens(args, cfg, b, s + 1, args.seed + 9).to(device)
    batch = steps.place({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                        cell.batch_spec_fn(mesh))
    patch, grads = grads_of_step()
    sync(device)
    k4.reset_launches()
    with patch, cell.context(mesh):
        params, opt, m = cell.step(params, opt, 0, batch)
    sync(device)
    return (m["loss"], params, opt, cell, k4.LAUNCHES["flash_attention"],
            grads[0])


def _moe_prefill(args, device, mesh, dtype, b: int, s: int, decode: int,
                 sharded: bool, layer: bool = False):
    """phi3.5-moe at 2 layers: a prefill of b x s tokens, then ``decode``
    greedy steps, under the cell's context (the MoE plan) with the
    parameters placed when ``sharded``; -> (each step's logits, the
    (expert ids, kept mask) of the sharded MoE layer's calls).  With
    ``layer``, also (the output, the routing) of layer 0's MoE layer alone
    through ``moe_apply`` on a seeded [b s, d] input the same on every
    rank, at capacity factor ``LAYER_CAPACITY`` (so that it drops rows):
    the drops of one input, where the model's later layers see inputs
    that differ in their last bits between meshes."""
    from functools import partial

    from repro_torch.dist.sharding import distribute, moe_apply
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer as tf

    cfg = shard_config(args, "phi3.5-moe-42b-a6.6b", SHARD_LAYERS, dtype)
    cell = steps.build_cell("phi3.5-moe-42b-a6.6b", "prefill_32k",
                            batch=b, device=device, config=cfg)
    params = cell.init_params(args.seed + 10)
    toks = shard_tokens(args, cfg, b, s, args.seed + 10).to(device)
    ctx = contextlib.nullcontext
    if sharded:
        params = steps.place(params, cell.param_shardings(mesh, params))
        toks = steps.place({"tokens": toks},
                           cell.batch_spec_fn(mesh))["tokens"]
        ctx = functools.partial(cell.context, mesh)
    out = []
    with ctx(), recording_kept() as kept, torch.no_grad():
        logits, cache = tf.prefill(params, toks, cfg, max_len=s + decode)
        for i in range(decode + 1):
            full = logits.full_tensor() if sharded else logits
            out.append(full.float())
            if i == decode:
                break
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            logits, cache = tf.decode_step(params, nxt, cache, s + i, cfg)
    one = None
    if layer:
        g = torch.Generator(device="cpu").manual_seed(args.seed + 12)
        x = torch.randn((b * s, cfg.d_model), generator=g).to(device, dtype)
        p0 = params.layer_params()[0]["moe"]
        if sharded:
            from torch.distributed.tensor import Replicate
            x = distribute(x, mesh, [Replicate()] * mesh.ndim)
        mcfg = dataclasses.replace(cfg.moe, capacity_factor=LAYER_CAPACITY)
        with ctx(), recording_kept() as one_kept, torch.no_grad():
            y, _ = moe_apply(partial(moe.moe_ffn, cfg=mcfg), p0, x)
        one = ((y.full_tensor() if sharded else y).float(), one_kept)
    sync(device)
    del params, cache
    return out, kept, one


def _explained(got, want) -> bool:
    """Whether every kept row of ``got`` that ``want`` does not keep (and
    the reverse) is in the group of an expert some token is routed to
    differently in the two (expert ids, kept mask) pairs: a drop the
    routing explains, not the capacity."""
    diff = _pairs(got) ^ _pairs(want)
    a, b = got[0].cpu(), want[0].cpu()
    moved = (torch.sort(a, -1)[0] != torch.sort(b, -1)[0]).any(-1)
    experts = set(a[moved].flatten().tolist()) | set(
        b[moved].flatten().tolist())
    return all(e in experts for _, e in diff)


def _pairs(routed) -> set:
    """The (token, expert) rows a (expert ids, kept mask) pair keeps."""
    idx, mask = (t.cpu() for t in routed)
    tok = torch.arange(idx.shape[0])[:, None].expand_as(idx)
    return set(zip(tok[mask].tolist(), idx[mask].tolist()))


def sharded_rank(rank: int, ranks: int, out_dir: str, rehearsal: bool,
                 seed: int, device: str) -> None:
    """One of phase 5i's four ``gloo`` ranks on the one card
    (``torch.multiprocessing`` spawns it; see :func:`phase_sharded`).
    Rank 0 writes ``ranks.json``."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable(all_threads=True)   # a crash names its line
    sys.path.insert(0, str(ROOT / "src"))
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=300))
    try:
        args = argparse.Namespace(cpu_rehearsal=rehearsal, seed=seed)
        try:
            rep = _sharded_rank(args, rank, out, torch.device(device))
        except Exception:
            import traceback
            rep = {"error": traceback.format_exc()}
        reps = [None] * ranks
        dist.all_gather_object(reps, rep)
        if rank == 0:
            (out / "ranks.json").write_text(json.dumps(reps))
    finally:
        dist.destroy_process_group()


def _sharded_rank(args, rank: int, out: Path, device) -> dict:
    """One rank's checks (b)-(e) of :func:`phase_sharded`, its report;
    progress marks on stderr name how far a rank that dies got."""
    import hashlib
    import shutil

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.manager import CheckpointManager, flatten
    from repro_torch.dist import compressed_dp
    from repro_torch.dist.pipeline import bubble_fraction, make_pipeline_fn
    from repro_torch.dist.rules import param_sharding
    from repro_torch.kernels.flash_attention import kernel as k4, ref as k4_ref
    from repro_torch.launch.mesh import lm_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.fault_tolerance import ElasticScaler

    rep = {"rank": rank}
    mesh = lm_mesh(SHARD_MESH, device)
    # the parent writes the references of (a) first
    deadline = time.time() + 900
    while not (out / "go").exists():
        if time.time() > deadline:
            raise TimeoutError("5i: no references from the world of one")
        time.sleep(0.2)
    print(f"5i rank {rank}: step", file=sys.stderr, flush=True)
    b, s = (4, 64) if args.cpu_rehearsal else (4, 1024)
    t = time.perf_counter()
    with k4.recording() as k4_calls, recording_comms() as comms:
        loss, params, opt, cell, launches, grads = _tiny_step(
            args, device, mesh, SHARD_LAYERS, torch.float32, b, s)
    rep["step_s"] = time.perf_counter() - t     # with the book on
    rep["step_comms"] = comms
    rep["loss"] = float(loss.full_tensor())
    rep["k4_launches"] = launches
    # each launch's local q [B, Hq, Sq, D] and its kv heads
    rep["k4_shapes"] = sorted({(sh[:3] + (sh[4],), sh[7])
                               for sh, _ in k4_calls})
    rep["k4_err"], rep["k4_ok"] = None, not k4_calls   # no launch: the CPU
    if k4_calls:
        (q, k, v), kw = k4_calls[0][1]
        got = k4.flash_attention(q, k, v, **kw)     # read after the counts
        err, ok = k4_err(got, k4_ref.flash_attention_ref(q, k, v, **kw),
                         q, k, v, **kw)
        rep["k4_err"], rep["k4_ok"] = err, bool(ok)
        del got, q, k, v
    del k4_calls
    want = torch.load(out / "expect.pt", map_location=device)
    now = full_tree(params.tree())
    rep["param_err"] = max(
        float(((now[n].float() - w.float()).abs()
               / (1 + w.float().abs())).max()) for n, w in
        want["params"].items())
    rep["loss_rel"] = abs(rep["loss"] - float(want["loss"])) / abs(
        float(want["loss"]))
    del want

    # (d) compressed_psum_mean over the four ranks on the step's gradients
    print(f"5i rank {rank}: compressed", file=sys.stderr, flush=True)
    t = time.perf_counter()
    contrib = {n: g.to_local().float() for n, g in flatten(grads).items()}
    err0 = compressed_dp.init_error_state(contrib)
    mean, new_err = compressed_dp.compressed_psum_mean(
        contrib, err0, dist.group.WORLD, SHARD_RANKS)
    half, ulp, digest = 0.0, 0.0, hashlib.blake2b(digest_size=16)
    same_err = True
    for n, g in contrib.items():
        exact = g.clone()
        dist.all_reduce(exact)
        exact /= SHARD_RANKS
        qq, scale, ne = compressed_dp._compress_leaf(g, err0[n],
                                                     dist.group.WORLD)
        half = max(half, float((mean[n] - exact).abs().max() / (scale / 2)))
        back = qq.float() * scale + ne
        gf = g + err0[n]
        spacing = torch.nextafter(gf.abs(), torch.tensor(
            float("inf"), device=gf.device)) - gf.abs()
        ulp = max(ulp, float(((back - gf).abs() / spacing).max()))
        digest.update(mean[n].cpu().numpy().tobytes())
        same_err = same_err and bool(torch.equal(ne, new_err[n]))
    rep["cdp_s"] = time.perf_counter() - t
    rep["cdp_err_over_half_scale"] = half
    rep["cdp_roundtrip_ulps"] = ulp
    rep["cdp_mean_digest"] = digest.hexdigest()
    rep["cdp_err_state_same"] = same_err
    rep["cdp_bytes"] = sum(g.numel() for g in contrib.values())
    del contrib, err0, mean, new_err, grads

    # (e) save on the four-rank mesh, restore onto ranks 0 and 1
    print(f"5i rank {rank}: elastic", file=sys.stderr, flush=True)
    t = time.perf_counter()
    saved = {"params": params.tree(), "opt": opt}
    global_ = full_tree(saved)
    mgr = CheckpointManager(str(out / "ckpt"))
    mgr.save(0, saved, wait=True)
    dist.barrier()
    tree, small, step = ElasticScaler(mgr).rescale(
        saved, lambda m, tr: param_sharding(tr, m, "lm"), world=[0, 1])
    if tree is not None:
        back = full_tree(tree)
        rep["elastic_same"] = sorted(back) == sorted(global_) and all(
            torch.equal(back[n], global_[n]) for n in global_)
        rep["elastic_mesh"] = list(small.shape)
        rep["elastic_split"] = any(
            p.is_shard() for p in tree["params"]["embed"].placements)
        del back
    rep["elastic_s"] = time.perf_counter() - t
    rep["elastic_leaves"] = len(global_)
    del saved, global_, tree, params, opt
    dist.barrier()
    if rank == 0:
        shutil.rmtree(out / "ckpt", ignore_errors=True)
    free_card(device)

    # (b) phi3.5-moe at 2 layers in f32 under the plan
    print(f"5i rank {rank}: moe", file=sys.stderr, flush=True)
    t = time.perf_counter()
    logits, kept, one = _moe_prefill(args, device, mesh, torch.float32, b,
                                     s, 0, sharded=True, layer=True)
    want = torch.load(out / "moe_expect.pt", map_location=device)
    rep["moe_s"] = time.perf_counter() - t
    rep["moe_logit_err"] = float(((logits[0] - want["logits"]).abs()
                                  / (1 + want["logits"].abs())).max())
    rep["moe_kept_same"] = len(kept) == len(want["kept"]) and all(
        torch.equal(a[1], w[1]) for a, w in zip(kept, want["kept"]))
    rep["moe_routes_same"] = len(kept) == len(want["kept"]) and all(
        torch.equal(a[0], w[0]) for a, w in zip(kept, want["kept"]))
    rep["moe_kept_diff"] = [
        {"tokens_routed_differently": int((torch.sort(a[0], -1)[0] != torch.sort(
            w[0], -1)[0]).any(-1).sum()),
         "kept_pairs_differing": len(_pairs(a) ^ _pairs(w))}
        for a, w in zip(kept, want["kept"])]
    rep["moe_dropped"] = [int((~m).sum()) for _, m in kept]
    rep["moe_explained"] = all(_explained(a, w) for a, w in
                               zip(kept, want["kept"]))
    rep["layer_kept_same"] = len(one[1]) == len(want["layer_kept"]) == 1 \
        and all(torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])
                for a, w in zip(one[1], want["layer_kept"]))
    rep["layer_dropped"] = int((~one[1][0][1]).sum())
    rep["layer_err"] = float(((one[0] - want["layer_y"]).abs()
                              / (1 + want["layer_y"].abs())).max())
    del logits, kept, want
    free_card(device)

    # (c) the pipeline: 22 layers in two stages of 11 on each pod pair
    print(f"5i rank {rank}: pipeline", file=sys.stderr, flush=True)
    t = time.perf_counter()
    pods = init_device_mesh(device.type, (2, 2), mesh_dim_names=("pod", "x"))
    stage = pods.get_local_rank(0)
    cfg = shard_config(args, "tinyllama-1.1b", None, torch.bfloat16)
    per = cfg.n_layers // 2
    params = tf.init_params(cfg, seed=args.seed + 11, device=device)
    toks = shard_tokens(args, cfg, SHARD_MICRO, s, args.seed + 11).to(device)
    pos = torch.arange(s, device=device)

    def stage_fn(w, x):
        for i in range(per):
            x, _, _ = tf._layer_apply(cfg, _layer_at(w, i), x, pos)
        return x

    with torch.no_grad():
        xs = torch.stack([tf._embed(params, toks[i:i + 1], cfg)
                          for i in range(SHARD_MICRO)])
        layers = params.tree()["layers"]
        ws = _tree_slice(layers, stage * per, (stage + 1) * per)
        fn = make_pipeline_fn(pods, stage_fn, 2, SHARD_MICRO, axis="pod")
        ys = fn(ws, xs)
        sync(device)
        rep["pipe_s"] = time.perf_counter() - t
        if rank == 0:
            seq = torch.stack([
                stage_fn(_tree_slice(layers, per, 2 * per, squeeze=True),
                         stage_fn(_tree_slice(layers, 0, per, squeeze=True),
                                  x))
                for x in xs])
            rep["pipe_bitwise"] = bool(torch.equal(ys, seq))
            rep["pipe_shape"] = list(ys.shape)
    rep["bubble_fraction"] = bubble_fraction(SHARD_MICRO, 2)
    return rep


def _tree_slice(tree, lo: int, hi: int, squeeze: bool = False):
    """The layers [lo, hi) of a stacked layer tree, as one stage's
    ``[1, n, ...]`` block (``[n, ...]`` with ``squeeze``)."""
    if isinstance(tree, dict):
        return {k: _tree_slice(v, lo, hi, squeeze) for k, v in tree.items()}
    return tree[lo:hi] if squeeze else tree[lo:hi][None]


def _layer_at(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_at(v, i) for k, v in tree.items()}
    return tree[i]


def phase_sharded(args, device, reps: int) -> tuple[dict, list]:
    """Phase 5i: the sharded LM through ``dist/`` on ``torch.distributed``
    (DTensor on a named ``DeviceMesh``; K4 on each rank's local heads).

    (a) A world of one on NCCL, mesh (data 1, model 1): tinyllama-1.1b in
    bf16 at full width and depth, one ``train_4k`` step on 2 x 4096 tokens
    (the cell's batch cut) under ``cell.context(mesh)`` with the params
    placed by ``param_shardings``: loss and every parameter bitwise the
    unsharded step's, K4 launched as often; phi3.5-moe in bf16 at full
    width and 2 layers, a prefill of 4 x 1024 tokens and 4 greedy decode
    steps under the MoE plan, each step's logits bitwise the unsharded
    path's.  Then the references of (b): the same configurations in f32
    on the world of one (saved under ``chiprun_out/sharded_ranks``).
    (b) Four ``gloo`` ranks on the card (NCCL refuses two ranks on one
    GPU), mesh (data 2, model 2): tinyllama-1.1b at full width, 2 layers,
    f32, 4 x 1024 tokens, one step with the cell's adafactor: every rank's
    loss the same and within 2e-5 relative of the world of one's, every
    parameter within 1e-5 of it (max abs, scaled by 1 + |p|); K4 launches
    at the rank's local shape (q [2, 16, 1024, 64], 2 KV heads) and one
    launch is held against its plain version (``k4_err``).  phi3.5-moe at
    2 layers in f32 under the plan: the kept rows of every MoE call equal
    the world of one's, the prefill logits within 2e-5.  (c) The pipeline
    on each 2-rank ``pod`` group: tinyllama-1.1b's 22 bf16 layers in 2
    stages of 11 over 4 micro-batches of 1 x 1024, ``ys`` bitwise the
    sequential stages on rank 0.  (d) ``compressed_psum_mean`` over the
    four ranks on (b)'s gradients (each rank's local shards): the mean
    bitwise the same on every rank, within scale / 2 of the exact mean,
    q * scale + err within 1 ulp of g.  (e) (b)'s params and adafactor
    state saved from the four-rank mesh and restored by
    ``ElasticScaler.rescale`` onto ranks 0 and 1 (mesh (1, 2)), every
    leaf bitwise the saved global tensor.  Returns (the report, two K4
    rows: the per-rank shape of (b) and the world of one's step).  The
    ranks start with the phase and wait for (a)'s references."""
    import shutil

    import torch.distributed as dist

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "5i: a process group is already up")
    # every record of the phase names the card it was taken on
    smi = "cpu rehearsal" if device.type != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"phase": "sharded", "nvidia_smi": smi}
    shard_dir = OUT_DIR / "sharded_ranks"
    shutil.rmtree(shard_dir, ignore_errors=True)
    shard_dir.mkdir(parents=True)
    # the ranks start now (imports, the card, their gloo mesh) and wait for
    # the references (a) leaves, then run (b)-(e)
    spawned = torch.multiprocessing.spawn(
        sharded_rank, args=(SHARD_RANKS, str(shard_dir), args.cpu_rehearsal,
                            args.seed, device.type),
        nprocs=SHARD_RANKS, join=False)
    try:
        out.update(_sharded_one(args, device, shard_dir))
        out["a_s"] = time.perf_counter() - t_phase
        (shard_dir / "go").write_text("go")
        t = time.perf_counter()
        while not spawned.join():
            pass
        out["ranks_s"] = time.perf_counter() - t
        ranks = json.loads((shard_dir / "ranks.json").read_text())
    except BaseException:
        for p in spawned.processes:      # no rank outlives a failure
            if p.is_alive():
                p.terminate()
        raise
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    b, s = (4, 64) if args.cpu_rehearsal else (4, 1024)
    b1, s1 = (2, 64) if args.cpu_rehearsal else (2, 4096)
    cfg = shard_config(args, "tinyllama-1.1b", None, torch.bfloat16)
    emit({"phase": "sharded_ranks", "nvidia_smi": smi, "ranks": ranks})
    for r in ranks:
        check("error" not in r, f"5i: rank failed: {r.get('error')}")
    r0 = ranks[0]
    losses = {r["loss"] for r in ranks}
    check(len(losses) == 1, f"5i (b): the ranks' losses differ: {losses}")
    check(r0["loss_rel"] <= 2e-5, f"5i (b): loss {r0['loss']} is "
                                  f"{r0['loss_rel']} relative off the "
                                  f"world of one's")
    check(r0["param_err"] <= 1e-5, f"5i (b): params after the step are "
                                   f"{r0['param_err']} off the world of one")
    rcfg = shard_config(args, "tinyllama-1.1b", SHARD_LAYERS, torch.float32)
    hq, hkv = rcfg.n_heads // 2, rcfg.n_kv_heads // 2
    local_q = [b // 2, hq, s, rcfg.hd]
    for r in ranks:
        check((r["k4_launches"] > 0 or device.type != "cuda") and
              r["k4_ok"],
              f"5i (b): rank {r['rank']}: K4 launched {r['k4_launches']} "
              f"times, its check {r['k4_err']}")
        check(device.type != "cuda" or (
            [list(q) for q, _ in r["k4_shapes"]] == [local_q] and
            all(kv == hkv for _, kv in r["k4_shapes"])),
              f"5i (b): rank {r['rank']}'s K4 shapes {r['k4_shapes']}")
        check(r["layer_kept_same"] and r["layer_err"] <= 2e-5 and (
            r["layer_dropped"] > 0 or args.cpu_rehearsal),
              f"5i (b): rank {r['rank']}: the MoE layer's routing and kept "
              f"rows equal {r['layer_kept_same']}, outputs off by "
              f"{r['layer_err']}")
        check(r["moe_explained"] and r["moe_logit_err"] <= 2e-5 and all(
            d["tokens_routed_differently"] <= 4 for d in r["moe_kept_diff"]),
              f"5i (b): rank {r['rank']}: the model's kept rows "
              f"{r['moe_kept_diff']} (explained by routing "
              f"{r['moe_explained']}), logits off by {r['moe_logit_err']}")
        check(r["cdp_err_over_half_scale"] <= 1.0 + 1e-4 and
              r["cdp_roundtrip_ulps"] <= 1.0 and r["cdp_err_state_same"],
              f"5i (d): rank {r['rank']}: mean off by "
              f"{r['cdp_err_over_half_scale']} half-scales, round trip "
              f"{r['cdp_roundtrip_ulps']} ulps")
    check(len({r["cdp_mean_digest"] for r in ranks}) == 1,
          "5i (d): the compressed means differ between ranks")
    check(r0["pipe_bitwise"], "5i (c): the pipeline's ys differ from the "
                              "sequential stages")
    for r in ranks[:2]:
        check(r["elastic_same"] and r["elastic_mesh"] == [1, 2] and
              (r["elastic_split"] or args.cpu_rehearsal),
              f"5i (e): rank {r['rank']}'s restore: bitwise "
              f"{r['elastic_same']}, mesh {r['elastic_mesh']}")
    out["ranks"] = ranks
    out["bubble_fraction"] = r0["bubble_fraction"]
    emit({**{k: v for k, v in out.items() if k != "ranks"},
          "rank0": r0})
    rows = [
        k4_row(f"flash_attention (5i rank of 4: tinyllama-1.1b f32, q "
               f"{local_q}, {hkv} kv heads)", hq, hkv, s, rcfg.hd,
               torch.float32, r0["k4_launches"], device, reps, b=b // 2),
        k4_row(f"flash_attention (5i world of one: tinyllama-1.1b bf16, "
               f"B {b1}, S {s1})", cfg.n_heads, cfg.n_kv_heads, s1, cfg.hd,
               torch.bfloat16, out["one_k4_launches"], device, reps, b=b1)]
    out["seconds"] = time.perf_counter() - t_phase
    check(args.cpu_rehearsal or out["seconds"] <= 150,
          f"5i took {out['seconds']:.1f} s, over its 150 s")
    emit({"phase": "sharded_time", "nvidia_smi": smi,
          "seconds": out["seconds"],
          "a_s": out["a_s"], "ranks_s": out["ranks_s"]})
    return out, rows


def _sharded_one(args, device, shard_dir: Path) -> dict:
    """Phase 5i (a) on a world of one, and the references of (b) saved
    under ``shard_dir``; -> its report."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import lm_mesh

    out = {}
    mesh = lm_mesh((1, 1), device)
    out["one_backend"] = dist.get_backend()
    b1, s1 = (2, 64) if args.cpu_rehearsal else (2, 4096)
    try:
        # (a) tinyllama bf16, full depth: unsharded, then sharded
        cfg = shard_config(args, "tinyllama-1.1b", None, torch.bfloat16)
        cell = steps.build_cell("tinyllama-1.1b", "train_4k", batch=b1,
                                device=device, config=cfg)
        params = cell.init_params(args.seed + 9)
        opt = cell.init_opt(params)
        toks = shard_tokens(args, cfg, b1, s1 + 1, args.seed + 9).to(device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        sync(device)
        k4.reset_launches()
        params, opt, m = cell.step(params, opt, 0, batch)
        sync(device)
        plain_launches = k4.LAUNCHES["flash_attention"]
        want = {n: v.detach().clone() for n, v in full_tree(
            params.tree()).items()}
        want_loss = m["loss"].detach().clone()
        del params, opt
        free_card(device)
        t = time.perf_counter()
        loss, params, _, _, one_launches, _ = _tiny_step(
            args, device, mesh, None, torch.bfloat16, b1, s1)
        out["one_step_s"] = time.perf_counter() - t
        now = full_tree(params.tree())
        same = torch.equal(loss.full_tensor(), want_loss) and all(
            torch.equal(now[n], w) for n, w in want.items())
        check(same, "5i (a): the sharded tinyllama step on a world of one "
                    "differs from the unsharded step")
        check(one_launches == plain_launches and (
            one_launches > 0 or device.type != "cuda"),
              f"5i (a): K4 launched {one_launches} times sharded, "
              f"{plain_launches} unsharded")
        out.update(one_loss=float(want_loss), one_k4_launches=one_launches,
                   one_params_bitwise=True)
        del params, now, want
        free_card(device)
        # (a) phi3.5-moe bf16, 2 layers: prefill + 4 decode steps
        b2, s2 = (4, 32) if args.cpu_rehearsal else (4, 1024)
        plain, _, _ = _moe_prefill(args, device, mesh, torch.bfloat16, b2,
                                   s2, 4, sharded=False)
        free_card(device)
        shard, kept, _ = _moe_prefill(args, device, mesh, torch.bfloat16,
                                      b2, s2, 4, sharded=True)
        check(len(plain) == len(shard) == 5 and all(
            torch.equal(a, c) for a, c in zip(plain, shard)),
            "5i (a): phi3.5-moe's sharded prefill/decode on a world of one "
            "differs from the unsharded path")
        check(len(kept) == 2 * 5, f"5i (a): {len(kept)} MoE calls took "
                                  f"the sharded layer, not 10")
        out["one_moe_bitwise"] = True
        out["one_moe_dropped"] = [int((~m).sum()) for _, m in kept]
        del plain, shard, kept
        free_card(device)
        # the references of (b), in f32 on the world of one
        b, s = (4, 64) if args.cpu_rehearsal else (4, 1024)
        loss, params, _, _, _, _ = _tiny_step(
            args, device, mesh, SHARD_LAYERS, torch.float32, b, s)
        torch.save({"loss": loss.full_tensor().cpu(),
                    "params": {n: v.cpu() for n, v in
                               full_tree(params.tree()).items()}},
                   shard_dir / "expect.pt")
        del params
        free_card(device)
        logits, kept, one = _moe_prefill(args, device, mesh, torch.float32,
                                         b, s, 0, sharded=True, layer=True)
        torch.save({"logits": logits[0].cpu(),
                    "kept": [(e.cpu(), m.cpu()) for e, m in kept],
                    "layer_y": one[0].cpu(),
                    "layer_kept": [(e.cpu(), m.cpu()) for e, m in one[1]]},
                   shard_dir / "moe_expect.pt")
        out["moe_dropped_one"] = [int((~m).sum()) for _, m in kept]
        del logits, kept
    finally:
        dist.destroy_process_group()
    free_card(device)
    return out


# --------------------------------------------------------------------------
# phase 5j: the sharded GNN and two-tower families, the model dry-run
# --------------------------------------------------------------------------

SM_RANKS, SM_MESH = 4, (2, 2)
SM_CASES = ("mace", "equiformer-v2", "gatedgcn", "two-tower-retrieval")
SM_TT_BATCH, SM_GROUPS = 8192, 16
# the gradients as the CPU tests hold the reference's (1e-4, scaled)
SM_LOSS_TOL, SM_PARAM_TOL, SM_GRAD_TOL = 2e-5, 3e-6, 1e-4
# adamw's first update is lr g / (|g| + 1e-8): a gradient error dg moves it
# by lr 1e-8 dg / g^2, under 3e-6 for |g| >= 1e-4 and dg up to 3e-3, but
# by up to lr where g nears 0: below this floor the parameters are held
# to 2 lr
SM_G_FLOOR, SM_NOISY_TOL = 1e-4, 2e-3
# the dry-run's cells, one rank of 256: the GNNs run while the ranks do
# (a few GB of the card), the LMs after them (up to all of it)
DRY_GNN = ("mace:ogb_products", "equiformer-v2:minibatch_lg")
DRY_LM = ("grok-1-314b:train_4k", "command-r-plus-104b:train_4k")


def sm_cell(args, arch: str, device):
    """(cell, batch on ``device``) of a 5j case at its published widths:
    mace and equiformer-v2 on molecule in float32 with ``spmd_edges`` and
    ``channel_groups`` 16 forced on (as the large cells set them; 4 at
    the rehearsal's smoke widths), the batch laid out by receiver block
    for the mesh's data shards; gatedgcn on full_graph_sm; the two-tower
    model's train_batch cut to ``SM_TT_BATCH`` rows."""
    import dataclasses

    from repro_torch.launch import steps, train

    smoke = args.cpu_rehearsal
    if arch == "two-tower-retrieval":
        b = 8 if smoke else SM_TT_BATCH
        cell = steps.build_cell(arch, "train_batch", smoke=smoke, batch=b,
                                device=device)
        return cell, recsys_batch(cell.config, b, args.seed + 20, device)
    shape = "molecule" if arch != "gatedgcn" else "full_graph_sm"
    cell = steps.build_cell(arch, shape, smoke=smoke, device=device)
    if arch != "gatedgcn":
        cfg = dataclasses.replace(cell.config, spmd_edges=True,
                                  channel_groups=4 if smoke else SM_GROUPS,
                                  dtype=torch.float32)
        cell = steps.build_cell(arch, shape, smoke=smoke, device=device,
                                config=cfg)
    host = train.gnn_batch(cell, args.seed + 21, data_shards=SM_MESH[0])
    return cell, host.map(lambda a: torch.from_numpy(a).to(device))


def k5_held(args_kw) -> tuple[bool, float]:
    """K5 on a recorded launch's inputs against its plain version: (bitwise,
    max abs difference)."""
    from repro_torch.kernels.segment_reduce import kernel, ref

    (values, ids, n), kw = args_kw
    got = kernel.segment_sum_sorted(values, ids, n, **kw)
    want = ref.segment_sum_sorted_ref(values, ids, n, **kw)
    return (same_tensor_bits(got, want),
            float((got.float() - want.float()).abs().max()))


def _sm_place(cell, mesh, params, batch):
    from repro_torch.launch import steps
    from repro_torch.models.gnn.common import GraphBatch

    params = steps.place(params, cell.param_shardings(mesh, params))
    specs = cell.batch_spec_fn(mesh)
    if isinstance(batch, GraphBatch):
        return params, dataclasses.replace(batch, **{
            k: steps.distribute(v, mesh, getattr(specs, k).placements)
            for k, v in batch.fields().items()})
    return params, steps.place(batch, {k: specs[k] for k in batch})


def sm_rank(rank: int, ranks: int, out_dir: str, rehearsal: bool,
            seed: int, device: str) -> None:
    """One of phase 5j's four ``gloo`` ranks on the one card
    (``torch.multiprocessing`` spawns it; see :func:`phase_sharded_models`).
    Rank 0 writes ``ranks.json``."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable(all_threads=True)
    sys.path.insert(0, str(ROOT / "src"))
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=300))
    try:
        args = argparse.Namespace(cpu_rehearsal=rehearsal, seed=seed)
        try:
            rep = _sm_rank(args, rank, out, torch.device(device))
        except Exception:
            import traceback
            rep = {"error": traceback.format_exc()}
        reps = [None] * ranks
        dist.all_gather_object(reps, rep)
        if rank == 0:
            (out / "ranks.json").write_text(json.dumps(reps))
    finally:
        dist.destroy_process_group()


def _sm_rank(args, rank: int, out: Path, device) -> dict:
    """One rank's steps of :func:`phase_sharded_models` (b): each case's
    step on the (2, 2) mesh, its loss and its parameters' blocks against
    the world of one's, K5's launches, the first held against its plain
    version on the rank's own inputs."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.checkpoint.manager import flatten
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.launch.mesh import lm_mesh

    mesh = lm_mesh(SM_MESH, device)
    deadline = time.time() + 900
    while not (out / "go").exists():
        if time.time() > deadline:
            raise TimeoutError("5j: no references from the world of one")
        time.sleep(0.2)
    rep = {"rank": rank}
    for arch in SM_CASES:
        print(f"5j rank {rank}: {arch}", file=sys.stderr, flush=True)
        t = time.perf_counter()
        cell, batch = sm_cell(args, arch, device)
        params, batch = _sm_place(cell, mesh, cell.init_params(args.seed + 22),
                                  batch)
        opt = cell.init_opt(params)
        sync(device)
        k5.reset_launches()
        t_step = time.perf_counter()
        patch, seen = grads_on_host()
        with k5.recording() as calls, patch, cell.context(mesh):
            params, opt, m = cell.step(params, opt, 0, batch)
        sync(device)
        row = {"step_s": time.perf_counter() - t_step,
               "k5_launches": k5.LAUNCHES["segment_sum_sorted"],
               "k5_by_shape": [[list(c), n] for c, n in sorted(
                   collections.Counter(c for c, _ in calls).items())],
               "loss": float(m["loss"].to_local())}
        if calls:
            row["k5_bitwise"], row["k5_err"] = k5_held(calls[0][1])
        del calls
        want = torch.load(out / f"expect_{arch}.pt", mmap=True)
        row["loss_rel"] = abs(row["loss"] - float(want["loss"])) / abs(
            float(want["loss"]))
        errs = {"grad_err": 0.0, "param_err": 0.0, "noisy_param_err": 0.0}
        noisy, worst = 0, None
        grads = flatten(seen[0])
        with torch.no_grad():
            for name, p in flatten(params.tree()).items():
                shape, off = compute_local_shape_and_global_offset(
                    p.shape, p.device_mesh, p.placements)
                at = tuple(slice(o, o + n) for o, n in zip(off, shape))
                w = want["params"][name][at].to(device).float()
                gw = want["grads"][name][at].to(device).float()
                g = grads[name].to(device).float()
                d = (p.to_local().float() - w).abs() / (1 + w.abs())
                calm = gw.abs() >= SM_G_FLOOR
                noisy += int((~calm).sum())
                for key, v in (
                        ("grad_err", (g - gw).abs() / (1 + gw.abs())),
                        ("param_err", torch.where(calm, d, 0.0)),
                        ("noisy_param_err", torch.where(calm, 0.0, d))):
                    if v.numel() and float(v.max()) > errs[key]:
                        errs[key] = float(v.max())
                        if key == "param_err":
                            worst = name
        row.update(errs, param_worst=worst, noisy_params=noisy)
        del seen, grads
        if arch == "two-tower-retrieval":
            row["table_placements"] = str(params.tree()[
                "user_table"].placements)
        row["s"] = time.perf_counter() - t
        rep[arch] = row
        del params, opt, batch, want
        free_card(device)
    return rep


def _sm_one(args, device, shard_dir: Path) -> dict:
    """Phase 5j (a): each case's unsharded step (the world of one's: no
    mesh, the one path a world of one takes) on the same seeded weights
    and batch, saved for the ranks."""
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.kernels.segment_reduce import kernel as k5

    out = {}
    for arch in SM_CASES:
        cell, batch = sm_cell(args, arch, device)
        params = cell.init_params(args.seed + 22)
        opt = cell.init_opt(params)
        sync(device)
        k5.reset_launches()
        t = time.perf_counter()
        patch, seen = grads_on_host()
        with patch:
            params, opt, m = cell.step(params, opt, 0, batch)
        sync(device)
        out[arch] = {"loss": float(m["loss"]), "s": time.perf_counter() - t,
                     "k5_launches": k5.LAUNCHES["segment_sum_sorted"]}
        check(bool(np.isfinite(out[arch]["loss"])),
              f"5j (a): {arch}'s loss {out[arch]['loss']}")
        torch.save({"loss": m["loss"].detach().cpu(),
                    "params": {n: v.detach().cpu() for n, v in
                               flatten(params.tree()).items()},
                    "grads": flatten(seen[0])},
                   shard_dir / f"expect_{arch}.pt")
        del params, opt, batch, seen
        free_card(device)
    return out


def _dry_models(args, device, cells, keep: Path, log: Path):
    """``python -m repro_torch.launch.dryrun`` on ``cells`` (one rank of
    256, each cell its own dry group), artifacts and the first K4/K5
    inputs under ``keep``; the process (not waited for)."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_ART_DIR": str(keep)}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
           device.type, "--continue-on-error", "--seed", str(args.seed),
           "--cells", ",".join(cells), "--keep-inputs", str(keep / "inputs")]
    if args.cpu_rehearsal:
        cmd += ["--smoke", "--world", "4"]
    return subprocess.Popen(cmd, stdout=open(log, "w"),
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                            env=env)


def _dry_wait(proc, timeout: float = 600) -> None:
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _dry_report(cells, keep: Path, mesh: str, smi: str) -> dict:
    """Each cell's artifact, checked: it ran, or its rank did not fit the
    card (a finding, its error kept)."""
    out = {}
    for c in cells:
        arch, shape = c.split(":")
        rep = json.loads((keep / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        check(rep["ok"] or rep.get("oom"),
              f"5j: the dry-run of {c} failed: {rep.get('error')}\n"
              f"{rep.get('traceback', '')[-3000:]}")
        line = {k: rep.get(k) for k in (
            "arch", "shape", "mesh", "world", "ok", "oom", "error", "memory",
            "cost", "collectives", "step_seconds", "launches", "k4_shapes",
            "k5_shapes", "loss", "before_error")}
        emit({"phase": "dryrun_models", "nvidia_smi": smi, **line})
        out[c] = line
    return out


def phase_sharded_models(args, device, reps: int) -> tuple[dict, list]:
    """Phase 5j (:func:`_sharded_models`); its directory under
    ``chiprun_out`` (the world of one's parameters, the dry-run's kept
    inputs) is removed after it, passed or not."""
    import shutil

    try:
        return _sharded_models(args, device, reps)
    finally:
        for f in (OUT_DIR / "sharded_models").glob("expect_*.pt"):
            f.unlink()
        shutil.rmtree(OUT_DIR / "sharded_models" / "dryrun" / "inputs",
                      ignore_errors=True)


def _sharded_models(args, device, reps: int) -> tuple[dict, list]:
    """Phase 5j: the sharded GNN and two-tower families and the model
    dry-run.

    (a) The world of one: each case of :func:`sm_cell` (mace and
    equiformer-v2 on molecule in f32 with ``spmd_edges`` and 16 channel
    groups, on a batch laid out by receiver block; gatedgcn on
    full_graph_sm; the two-tower model at B 8,192) one adamw step
    unsharded, saved under ``chiprun_out/sharded_models``.  (b) Four
    ``gloo`` ranks on the card, mesh (data 2, model 2): each case's step
    under ``cell.context(mesh)`` on the placed weights and batch (the
    two-tower tables split by rows over ``model``): every rank's loss
    within 2e-5 relative and every parameter block within 3e-6 (max abs,
    scaled by 1 + |p|) of the world of one's; K5 launched, its first
    launch bitwise its plain version on the rank's own inputs.  (c) The
    model dry-run (``repro_torch.launch.dryrun``), one rank of 256 of a
    dry group, in subprocesses: mace on ogb_products and equiformer-v2 on
    minibatch_lg (while (b) runs), then grok-1-314b and
    command-r-plus-104b (64 layers) train_4k: each artifact's bytes,
    FLOPs and collectives printed; a rank that does not fit the card is a
    finding (its error printed), any other failure fails the phase.
    Then K5 on mace's rank's first launch and K4 on command-r's, each held
    against its plain version on those inputs, and three kernels-line
    rows at the ranks' shapes: K5 at mace ogb_products's rank, K5 at a
    two-tower rank's row block (forward and table gradient), K4 at
    command-r-plus-104b's rank (6 of 96 query heads, one KV head)."""
    import shutil

    import torch.distributed as dist

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "5j: a process group is already up")
    smi = "cpu rehearsal" if device.type != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"phase": "sharded_models", "nvidia_smi": smi}
    shard_dir = OUT_DIR / "sharded_models"
    shutil.rmtree(shard_dir, ignore_errors=True)
    shard_dir.mkdir(parents=True)
    keep = shard_dir / "dryrun"
    keep.mkdir()
    mesh = "2x2" if args.cpu_rehearsal else "16x16"
    dry_gnn = _dry_models(args, device, DRY_GNN, keep, keep / "gnn.log")
    spawned = torch.multiprocessing.spawn(
        sm_rank, args=(SM_RANKS, str(shard_dir), args.cpu_rehearsal,
                       args.seed, device.type),
        nprocs=SM_RANKS, join=False)
    try:
        out["one"] = _sm_one(args, device, shard_dir)
        out["a_s"] = time.perf_counter() - t_phase
        (shard_dir / "go").write_text("go")
        t = time.perf_counter()
        while not spawned.join():
            pass
        out["ranks_s"] = time.perf_counter() - t
        ranks = json.loads((shard_dir / "ranks.json").read_text())
        _dry_wait(dry_gnn)
        out["dry_gnn_s"] = time.perf_counter() - t_phase
        t = time.perf_counter()
        free_card(device)
        dry_lm = _dry_models(args, device, DRY_LM, keep, keep / "lm.log")
        _dry_wait(dry_lm)
        out["dry_lm_s"] = time.perf_counter() - t
    except BaseException:
        for p in spawned.processes:
            if p.is_alive():
                p.terminate()
        if dry_gnn.poll() is None:
            dry_gnn.kill()
        raise
    emit({"phase": "sharded_models_ranks", "nvidia_smi": smi,
          "ranks": ranks})
    out["ranks"] = ranks
    out["dry"] = _dry_report(DRY_GNN + DRY_LM, keep, mesh, smi)
    out["dry_logs"] = {log: (keep / log).read_text()[-2000:]
                       for log in ("gnn.log", "lm.log")}
    for r in ranks:
        check("error" not in r, f"5j: rank failed: {r.get('error')}")
        for arch in SM_CASES:
            row = r[arch]
            check(row["loss_rel"] <= SM_LOSS_TOL,
                  f"5j (b): rank {r['rank']} {arch}: loss {row['loss']} is "
                  f"{row['loss_rel']} relative off the world of one's")
            check(row["grad_err"] <= SM_GRAD_TOL,
                  f"5j (b): rank {r['rank']} {arch}: gradients "
                  f"{row['grad_err']} off the world of one's")
            check(row["param_err"] <= SM_PARAM_TOL and
                  row["noisy_param_err"] <= SM_NOISY_TOL,
                  f"5j (b): rank {r['rank']} {arch}: params after the step "
                  f"{row['param_err']} off the world of one's "
                  f"({row['noisy_param_err']} where |g| < {SM_G_FLOOR}: "
                  f"{row['noisy_params']} values)")
            check((row["k5_launches"] > 0 and row["k5_bitwise"]) or
                  device.type != "cuda",
                  f"5j (b): rank {r['rank']} {arch}: K5 launched "
                  f"{row['k5_launches']} times, bitwise {row.get('k5_bitwise')}")
        tt = r["two-tower-retrieval"]
        check(args.cpu_rehearsal or "Shard(dim=0)" in tt["table_placements"],
              f"5j (b): the two-tower table is laid out "
              f"{tt['table_placements']}")
    # the kernels on the dry-run ranks' own inputs, then their rows
    rows = []
    if device.type == "cuda":
        from repro_torch.kernels.flash_attention import kernel as k4, \
            ref as k4_ref

        mace_in = keep / "inputs" / "mace__ogb_products" / "k5.pt"
        got = torch.load(mace_in, map_location=device)
        (values, ids, n), kw = got["args"], got["kw"]
        ok, err = k5_held(((values, ids, n), kw))
        check(ok, f"5j: K5 on mace ogb_products's rank inputs: max abs "
                  f"{err} from its plain version")
        # each value row's segment (the launch reads row order[i] as the
        # stream's row i, of segment ids[i]; rows it does not read drop)
        flat_ids = torch.full((values.shape[0],), -1, dtype=ids.dtype,
                              device=device)
        flat_ids[kw["order"].long()] = ids
        # the dry-run's launches at this shape
        launches = dict((tuple(k), n) for k, n in out["dry"][DRY_GNN[0]][
            "k5_shapes"]).get((values.shape[0], ids.shape[0],
                               values.shape[1], n), 0)
        rows.append(k5_row(
            f"segment_sum_sorted (5j dry-run rank of 256: mace ogb_products "
            f"[{values.shape[0]}, {values.shape[1]}] "
            f"{str(values.dtype).replace('torch.', '')} into {n})",
            values, flat_ids, n, launches, device, reps))
        del got, values, ids, flat_ids
        cr_in = keep / "inputs" / "command-r-plus-104b__train_4k" / "k4.pt"
        dcr = out["dry"][DRY_LM[1]]
        # the launches of the step, or of its part that ran before the
        # rank ran out of the card (then not a step's count: the row says)
        partial = "" if dcr["ok"] else (
            "; launches of the part of the step that ran before the rank "
            "ran out of the card")
        dcr = dcr if dcr["ok"] else dcr.get("before_error") or {}
        if cr_in.exists():
            got = torch.load(cr_in, map_location=device)
            (q, k, v), kw = got["args"], got["kw"]
            err, ok = k4_err(k4.flash_attention(q, k, v, **kw),
                             k4_ref.flash_attention_ref(q, k, v, **kw),
                             q, k, v, **kw)
            check(ok, f"5j: K4 on command-r's rank inputs {list(q.shape)}: "
                      f"{err}")
            out["cr_k4"] = {"q": list(q.shape), "kv": list(k.shape),
                            "err": err}
            b, hq, s, d = q.shape
            rows.append(k4_row(
                f"flash_attention (5j dry-run rank of 256: command-r-plus-104b "
                f"train_4k, q {list(q.shape)}, {k.shape[1]} kv head{partial})",
                hq,
                k.shape[1], s, d, q.dtype,
                (dcr.get("launches") or {}).get("flash_attention", 0),
                device, reps, b=b))
            del got, q, k, v
        free_card(device)
        rows += sm_tt_rows(args, device, ranks, reps)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "sharded_models_time", "nvidia_smi": smi,
          **{k: out[k] for k in ("seconds", "a_s", "ranks_s", "dry_gnn_s",
                                  "dry_lm_s")}})
    return out, rows


def sm_tt_rows(args, device, ranks, reps) -> list:
    """K5 at a two-tower rank's row block of (2, 2): the user table's
    block [V / 2, D] read through the rank's bags (B / 2 users, their ids
    made local: those of the other block drop like pads) and the table
    gradient into the block: :func:`k5_bag_rows`'s two rows there, their
    launches the ranks' at those shapes."""
    cell, batch = sm_cell(args, "two-tower-retrieval", device)
    cfg = cell.config
    v_loc = cfg.user_vocab // SM_MESH[1]
    b_loc = batch["user_ids"].shape[0] // SM_MESH[0]
    gen = torch.Generator(device=device).manual_seed(args.seed + 23)
    table = torch.randn((v_loc, cfg.embed_dim), generator=gen,
                        device=device).mul_(0.01)
    ids = batch["user_ids"][:b_loc]
    local = torch.where((ids >= 0) & (ids < v_loc), ids, -1)
    # rank 0's launches by (value rows, slots, columns, segments, dtype)
    launches = {tuple(k): n for k, n in
                ranks[0]["two-tower-retrieval"]["k5_by_shape"]}
    rows = k5_bag_rows(cfg, {"user_table": table}, {"user_ids": local},
                       launches, device, reps,
                       tag="5j rank of (2, 2), its row block")
    del table, batch, ids, local
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="Graph500 scale of the main path (default 20)")
    ap.add_argument("--kernel-n", type=int, default=65536,
                    help="scale_free vertices for the kernel checks")
    ap.add_argument("--k5-n", type=int, default=262144,
                    help="scale_free vertices of K5's aggregation layer")
    ap.add_argument("--prompt-len", type=int, default=1024,
                    help="tokens per prompt on the serving path")
    ap.add_argument("--replica-threshold", type=int, default=16384,
                    help="hub-split degree bound of phase 3e's session")
    ap.add_argument("--tri-scale", type=int, default=14,
                    help="Graph500 scale of phase 3f's triangle count "
                         "(14: n = 16384, the bitset's ceiling)")
    ap.add_argument("--event-n", type=int, default=512,
                    help="scale_free vertices of phase 3f's event oracle")
    ap.add_argument("--spmd-scale", type=int, default=16,
                    help="Graph500 scale of phase 3j's four gloo ranks")
    ap.add_argument("--dry-scale", type=int, default=26,
                    help="RMAT scale of phase 3l's diffusion dry-run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one sssp query, one pagerank query, "
                         "16-lane sssp on pull and push, one commit's push "
                         "repair, one prefill and one decode step, one "
                         "training step of each GNN run with "
                         "torch.profiler (tables under chiprun_out/)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the path on the CPU with the plain versions "
                         "(tiny sizes); exits 3 and prints no result")
    args = ap.parse_args(argv)
    _T0[0] = time.perf_counter()
    (OUT_DIR / "chip_smoke.jsonl").unlink(missing_ok=True)

    if args.cpu_rehearsal:
        device = torch.device("cpu")
        args.scale, args.kernel_n, args.reps = (min(args.scale, 10),
                                                min(args.kernel_n, 2048), 2)
        args.k5_n = min(args.k5_n, 2048)
        args.replica_threshold = min(args.replica_threshold, 64)
        args.tri_scale = min(args.tri_scale, 10)
        args.event_n = min(args.event_n, 128)
        args.spmd_scale = min(args.spmd_scale, 8)
        args.dry_scale = min(args.dry_scale, 12)
    elif not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import kernel
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.kernels.sssp_relax import kernel as k6

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = "cpu rehearsal"
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        emit({"phase": "card", "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        t = time.perf_counter()
        sources = {**kernel.KERNEL_SOURCES, **k4.KERNEL_SOURCES,
                   **k5.KERNEL_SOURCES, **k6.KERNEL_SOURCES}
        _build.build(sources)             # one nvcc per source, together
        for mod in (kernel, k4, k5, k6):
            mod.build()                   # bind the loaded libraries
        logs = _build.build_logs(sources)
        ptxas = {k: [ln.strip() for ln in v.splitlines()
                     if "registers" in ln or "smem" in ln]
                 for k, v in logs.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t,
              "ptxas": ptxas})
        emit({"phase": "k4_sass", "hgmma": k4_sass_check()})
    gen_build = start_generic_build(device)

    src, dst, w, n = make_graph_family("scale_free", args.kernel_n, seed=0)
    ksess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                        device=device)
    errs = phase_kernels(ksess, device)
    emit({"phase": "kernels_vs_plain", "graph": "scale_free",
          "n": args.kernel_n, "cells": 4, "bitwise": True, **errs})
    gen_errs = phase_generic_kernels(ksess, device, gen_build)
    emit({"phase": "generic_kernels_vs_plain", "graph": "scale_free",
          "n": args.kernel_n, "cells": 4, "bitwise": True, **gen_errs})
    del ksess
    k4_check = phase_k4_vs_plain(device)
    emit({"phase": "k4_vs_plain", **k4_check})
    k4_grad = phase_k4_grad(args, device)

    sess, launches, sources, results, walls, data, queries = phase_main(
        args, device)
    push_launches = phase_push(sess, results, walls, sources, data[3],
                               device)
    roots = lane_roots(data[0], data[3], sources, args.seed)
    lane_launches, lanes16 = phase_lanes(sess, results, roots, data, device)
    replicas = phase_replicas(args, sess, results, walls, sources, roots,
                              data, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    watchdog = phase_watchdog(sess, queries, sources, device)
    spmd = phase_spmd(args, sess, data, sources, roots, device)
    sanitized = phase_sanitize(args, sess, roots, device)
    dryrun = phase_dryrun(args, device)
    gen_launches = phase_generic(args, sess, results, lanes16, roots,
                                 sources, data, device)
    del lanes16
    oracles = phase_oracles(args, device)
    rows = phase_timing(sess, launches, sources, device, args.reps)
    rows.append(phase_k2_lanes_timing(
        sess, roots, lane_launches["min/max+payload/laned"], device,
        args.reps))
    rows += phase_generic_timing(
        sess, rows, gen_launches, sources, roots, device, args.reps,
        ("edge_relax_blocks", "edge_relax_scan",
         "edge_relax_scan (laned, payload)"))
    rows += phase_emit_timing(sess, gen_launches, sources, device, args.reps)
    k6_row = phase_k6(sess, sources, device, args.reps)
    commit_launches, frontier0, commit_times = phase_commits(
        args, sess, data, sources, roots, device)
    k3_launches = (push_launches["edge_relax_push_blocks"]
                   + commit_launches["edge_relax_push_blocks"])
    k3_row, k3_detail = phase_k3_timing(sess, k3_launches, sources,
                                        frontier0, device, args.reps)
    rows.append(k3_row)
    rows += phase_generic_timing(sess, rows, gen_launches, sources, roots,
                                 device, args.reps,
                                 ("edge_relax_push_blocks",))
    durability = phase_durability(args, sess, data, sources, commit_times,
                                  device)
    if args.profile and device.type == "cuda":
        for line in phase_profile(sess, sources, roots, data[3]):
            emit(line)
    del sess, results
    if device.type == "cuda":
        torch.cuda.empty_cache()
    k5_row = phase_k5(args, device, args.reps)
    served = phase_serve(args, device)
    lm = phase_lm_checks(args, device)
    k4_dense = phase_k4_timing(args, served["k4_launches"], device,
                               args.reps)
    # the MoE LMs: every graph session and process group is gone
    check(not torch.distributed.is_initialized(),
          "a process group outlived phase 3j")
    free_card(device)
    moe_cfg = moe_config(args)
    moe_served = phase_serve(args, device, moe_cfg, phase="moe_serve")
    moe = phase_moe_checks(args, device)
    s_moe = 32 if args.cpu_rehearsal else args.prompt_len
    grok = moe_config(args, MOE_CHECK_ARCHS[1], dtype=torch.bfloat16)
    moe_rows = [
        k4_row("flash_attention (phi3.5-moe prefill)", moe_cfg.n_heads,
               moe_cfg.n_kv_heads, s_moe, moe_cfg.hd, moe_cfg.dtype,
               moe_served["k4_launches"], device, args.reps),
        k4_row("flash_attention (grok-1 prefill, softcap 30)", grok.n_heads,
               grok.n_kv_heads, s_moe, grok.hd, grok.dtype,
               moe["grok_bf16"]["k4_launches"], device, args.reps,
               softcap=grok.attn_softcap)]
    # training the dense LM (5e), then K4 and the backward at its shape
    free_card(device)
    train_check = phase_train_check(args, device)
    trained = phase_train(args, device)
    k4_train = k4_row(
        "flash_attention (tinyllama-1.1b training: B 8, S 4096)",
        32, 4, 256 if args.cpu_rehearsal else 4096, 64, torch.bfloat16,
        trained["k4_launches"], device, args.reps,
        b=1 if args.cpu_rehearsal else TRAIN_BATCH)
    attention_bwd = phase_attention_bwd_timing(args, device, args.reps)
    free_card(device)
    gnn, k5_gnn = phase_gnn(args, device, args.reps)
    free_card(device)
    recsys, k5_recsys = phase_recsys(args, device, args.reps)
    free_card(device)
    cr_served, cr_checks = phase_command_r(args, device)
    cr = cr_config(args, CR_SERVE_LAYERS)
    k4_cr = k4_row("flash_attention (command-r-plus prefill)", cr.n_heads,
                   cr.n_kv_heads, 32 if args.cpu_rehearsal
                   else args.prompt_len, cr.hd, cr.dtype,
                   cr_served["k4_launches"], device, args.reps)
    free_card(device)
    sharded, k4_sharded = phase_sharded(args, device, args.reps)
    free_card(device)
    sharded_models, sm_rows = phase_sharded_models(args, device, args.reps)
    free_card(device)
    rows += [k4_dense, *moe_rows, k4_train, k4_cr, *k4_sharded, k5_row,
             k5_gnn, *k5_recsys, *sm_rows, k6_row]
    detail = {"nvidia_smi": smi, "kernels": rows, "k3": k3_detail,
              "k4_grad": k4_grad, "train": trained,
              "train_check": train_check,
              "attention_bwd": attention_bwd, "gnn": gnn,
              "recsys": recsys, "cr_serve": cr_served,
              "cr_checks": cr_checks, "sharded": sharded,
              "sharded_models": sharded_models,
              "serve": served, "lm_checks": lm, "moe_serve": moe_served,
              "moe_checks": moe, "dryrun": dryrun, "k4_vs_plain": k4_check,
              "replicas": replicas, "oracles": oracles,
              "watchdog": watchdog, "generic": gen_launches,
              "spmd": spmd, "sanitize": sanitized,
              "durability": durability,
              "seconds": time.perf_counter() - t0}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if device.type != "cuda":
        print("chip_smoke: CPU rehearsal finished (no result on the CPU)",
              file=sys.stderr)
        return 3
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
