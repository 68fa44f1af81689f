#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spinglass_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from csrc/ with nvcc (one process per source, all
at once): K1 (dense sweep: a thread-block cluster per 72 replica columns,
bf16 tensor-core fields from an exact 3-plane split of J), its variants K5
(pipelined), K6 (interleaved) and K7 (folded) on K1's cluster design within
their shared memory envelopes, K2 (single-call sparse
sweep, the tile's spins in shared memory), K3 (sparse thresholds, four per
Philox run) and K4 (one colour of the sparse sweep per launch: it gathers
its own fields), and the Swendsen-Wang sweep's two kernels, which have no
Pallas counterpart: C2 (bond and ghost activation into bit masks) and C1
(union-find labels and the cluster flips in one launch). Holds each against
its plain PyTorch twin, drives
the dense SA slice (SK glass, N=4096, R=1024; K1 and each variant), the
sparse slice (10k spins: SA at R=1024, time-to-target PT at R=128, PT at
R=4096 on K4, make_engine's choice there, and on K3), the RL path (the
annealer environment, PPO and the hybrid DQN on the SK glass at N=512 with
256 envs through K1, and on the 10k graph through K2 and K4; the training
pipeline, train-rl, the gym adapter's episode and the captured evaluation)
and the problem path (TSP and
MaxCut encoded, solved through K1, K2 and K4, and the command line), the
drivers' remaining paths (checkpoint/resume, PT with Swendsen-Wang cluster
moves, the tuned ladder, the compact engine), the batch, adaptive,
operations and research layers, and the distributed layer on a one-rank
NCCL group (sharded PT through K1, K2 and K4, model-sharded sweeps,
data-parallel PPO, the job pools, the quality gates) end to end, and times
the kernels against the twins. Phases:

  1. device and build: nvidia-smi name and power limit, build seconds,
     registers, spills and shared memory of every kernel, how many of
     K1's clusters the card holds at once, and the shared memory of K1's,
     K5's, K6's and K7's cluster kernels as built against the wrapper's
     shape rules (at Np=4096, at each envelope's edge and one block
     beyond); the host C++ library (native) built from the checkout;
  2. parity with the twins. +-J couplings with h on a quarter grid make every
     field exact, so spins, dE and counts must be equal bit for bit.
     K1: N=500 padded to 512, R in {1, 37, 256}, both rules, both block
     sizes, host-uniform and Philox sweeps; N=4096, R=1024 at block 128 (the
     size anneal uses) and 256, both rules, both modes; three sweeps of sa.run_chunk through
     make_engine's engine against the same driver with the twin; Gaussian SK
     (all three planes of J non-zero) energy identity (1e-4 relative) and
     counts within 0.5%; j_dtype="bfloat16" against its twin, bitwise on +-J
     and on the SK instance's rounded J by counts and identity; the
     one-block float32 kernel (K1 beyond the cluster kernel's shapes)
     against the twin, bitwise on +-J.
     K2/K3: sparse N=2000 and the 10k bench graph, R in {128, 256, 1024},
     both rules, K2 on K3's thresholds and in Philox mode, 3 sweeps; the
     same on the Gaussian 10k graph against the slot-ordered twin (spins and
     counts bitwise) and the per-colour twin (counts within 0.5%); K3 at
     [10240, 1024], [10240, 4096] and [10240, 130] (R % 4 != 0); two PT
     super-steps through
     make_engine's engine (K2, R=128) against the same driver with the twin
     on a +-J planted 10k instance (state bitwise); Gaussian 10k energy
     identity (1e-4 relative) on K2 (R=1024), on K4 (R=4096 and 16) and on
     K3 + the plain sweep (R=4096).
     K5, K6 (2 and 4 chains), K7: each against its own twin and against K1
     on +-J N=500 (R in {1, 16, 72, 73, 1024, 1100}: a part of a tile, one
     tile, two, 15 tiles and a second wave; both rules, both blocks, a
     host-uniform or a Philox sweep at each), and at N=4096, R=1024 against
     its twin and K1 (block 128, Philox) and against K1 (block 256, host
     uniforms); K5, K6 and K7 at n_pad on each block's envelope edge (their
     cluster kernels; against twin and K1) and one block beyond (the
     one-block float32 kernels; against K1), R=73: spins, dE, counts
     bitwise.
     K4: whole sweeps in gather mode against the slot-ordered plain version
     on the 10k +-J graph (spins, dE, counts bitwise) and on the Gaussian
     10k graph (spins and counts bitwise, dE within 1e-5), int8 and float32
     spins, both rules, R in {128, 4096}; on given fields against its twin
     (R in {128, 4096, 130}); one K4-path sweep == one K3-path sweep == one
     K2 sweep at [10240, 1024] and [10240, 130] under one seed, bitwise.
     The overlap kernel against its twin at [32768, 136] (4 chains of 34
     slots), int8 and float32, with and without padding rows, and at 2, 3
     and 8 chains: q bitwise; K4 over 3 whole sweeps of the L=32 +-J
     lattice (2 colours) at R=136, int8 and float32, both rules, against
     its plain version, bitwise. The SA driver's best-tracking kernel
     (sa_track) against its twin at the SA shapes ([10240, 1024] and
     [4096, 1024] float32) and at [32768, 136] int8, with some, all and no
     replicas improved: every output bitwise. The time-to-target latch
     (pt_latch) against its twin on the TTT state's nine leaves
     ([10240, 128] float32 spins): a no-op step, the hit and a step after
     it, snapshot and flag bitwise.
     RL: two env steps of 10 sweeps through make_engine's engine against
     the same steps through the twin under one generator seed, in all three
     action modes with sweep fractions below 1 for some envs (the kernels
     write in place; those envs must keep their spins): +-J N=512 with 256
     envs (K1), the +-J 10k graph with 128 envs (K2) and 64 envs (K4);
     spins, energies, counts, rewards, observations and done bitwise;
     RL training: two act_and_learn steps of the hybrid DQN at its default
     widths (buffer 4096, batch 128, hidden (128, 128)) on the same three
     shapes, through the kernels against the twins, without and with
     prioritised replay: the whole DQN state (env, ring, priorities,
     parameters, target network, Adam, counters) bitwise;
     C2 and C1 against their plain versions on the same inputs, bit for
     bit, in the Philox and the given draw modes (masks, start labels,
     labels, new spins, cluster counts): one SW sweep's inputs on the TTT
     instance (R=128: one block per replica; R=16: a cluster of 8 blocks),
     the +-J 10k graph (R=128), the Gaussian 10k graph (R=16) and a dense
     +-J problem in ELL form (K=255, 8 mask words); C1 also on every bond
     on, no bond, and one long path through shuffled indices, its table in
     a cluster and in one block;
     K1 with a problem axis (the batch path's StackedFusedSweep): one
     launch over P stacked +-J problems against P one-problem launches
     under the per-problem seeds, P in {1, 3, 16}, Np in {512, 2048}, R in
     {1, 16, 37}, both rules, Philox and host uniforms, spins, dE and counts
     bitwise; against the stacked twin too on one case of P = 3 at each Np
     and of P = 16; the one-block kernel at Np = 8448 with P = 2;
     the research layer: one SQA stage (40 sweeps) on a +-J Trotter
     problem (N=128, P=4, J_perp 0.25, R=16) through K1 (three planes)
     against the same
     stage through the twin, state bitwise; J_perp rewritten in place ==
     a fresh build; the stage's captured sa.anneal == its eager chunks;
  3. in-kernel Philox, statistically: a 6-spin system sampled for 400 sweeps
     at beta=0.6 against exact enumeration (TV < 0.05), through K1 and
     through K2; K1's SK acceptance within 1% of the host-uniform sweep's;
  4. the slices: a chunk of sweeps must make no host sync
     (torch.cuda.set_sync_debug_mode("error")), dense and sparse; then
     anneal(SK 4096, R=1024, 500 sweeps) must run K1 500 times and reach
     E/N <= -0.72, and the same with j_dtype="bfloat16"; anneal(10k sparse,
     R=1024, 500 sweeps) must run
     SortedSparseTEngine with K2 500 times; time_to_target on the
     ttt_provenance.json instance (hash checked) must hit its threshold for
     seeds 42, 43, 44 within 20000 sweeps, with pt_latch launched once a
     replay over that run and one replay discarded a hit; pt.run with R=4096 (32 chains of
     128) must take the fused sweep, K4 once per colour and sweep. The
     sparse anneal's E/N must lie within 0.01 of -1.63. Each run's
     best_energy must equal the energy of its best_spins (1e-3 relative).
     Then K5, K6 (2 and 4 chains) and K7 run 500 sweeps of the SK anneal
     (its seeds, its schedule, sa's sweep step): E/N <= -0.72, energy
     identity within 1e-4 relative per 50-sweep chunk, best E/N within
     0.005 of K1's 500 sweeps through the same driver (K5's and K7's fields
     sum in another order; K6's in K1's, so its spins and best energies
     must equal K1's run bit for bit); on a +-J N=4096 instance 50
     such sweeps must end bitwise equal to K1's spins. PT at R=4096 through
     make_pt_step with SortedSparseTEngine(accept_kernel="fused") for 200
     sweeps on the +-J 10k graph must equal the K3 path
     (accept_kernel="none", K3 200 times)
     under one seed (spins and slots bitwise, energies within 1e-4), with
     K4 launched once per colour and sweep, K3 not, and no per-colour field
     gather outside K4. RL: a rollout of 8 env steps with auto_reset at
     N=512 x 256 envs makes no host sync; bench_rl (ppo.train, 48 updates)
     must launch K1 exactly updates x 8 x 10 times, keep every metric
     finite, end with best_energy <= energy == energy(spins) (1e-4
     relative) and reach a mean best energy per spin <= -0.60; make_ppo on
     the 10k bench graph must launch K2 80 times at 128 envs and K4 once
     per colour and sweep at 64 envs over 2 updates of rollout 4, with the
     mean best energy below the reset energy; rollout_best_energy for the
     geometric controller must launch K1 max_steps x sweeps_per_step times,
     and env.reset without an engine on a problem on the card must raise.
     RL training: the captured DQN step (k=8, 16 steps, N=512 x 256 envs,
     with and without PER) against the eager loop bit for bit, its replays
     and reads without host sync, K1 exactly 10 launches per env step;
     captured DQN runs on the 10k graph at 128 (K2, 40 launches) and 64
     envs (K4, one per colour and sweep); RLTrainingPipeline with the
     curriculum (32 / 64 / 128 at 32 envs), DQN (k=2) and PPO, checkpointed,
     and PPO resumed from its checkpoint == the uninterrupted run bit for
     bit; `sgt-torch train-rl --agent dqn` in process; a gym episode at R=1
     on K1 against the same episode through K1's twin (SpinGlassGymEnv, or
     its episode core SpinGlassEpisode where gymnasium is not installed);
     the captured evaluate_controllers against the eager loop of its
     episodes, every seed bitwise; a short learning_report.
     The launch counts
     are those of each call (AnnealResult.metadata["kernel_launches"]). The
     entry points above run their captured steps (anneal/graphs.py: CUDA
     graphs replayed, the kernels' seeds read from device memory, launches
     counted per replay; engine and graphs kept per problem object and
     config). Then a repeat call of the dense and sparse anneal and of PT at
     R=4096 must hit that cache and give the first call's result bit for
     bit; and each captured driver against the eager loop of its step under
     one seed, bit for bit: anneal on the SK glass (K1 500 launches on both
     paths, E/N -0.75696 since the start is drawn on the card) and
     anneal_scan against it; the sparse anneal (K2 500, E/N -1.63106);
     pt.run at 16 replicas (1000 sweeps) and at R=4096
     (200 sweeps), K4 (spins, slots, energies, exchange counts, histories);
     time_to_target's sweeps per seed (42-44, all hit); the first 16 of
     bench_rl's 48 captured PPO updates against 16 eager ones (history; E/N
     <= -0.60 after 48), updates_per_dispatch=8 over 16 updates against
     them (parameters, history), and 2 updates on the 10k graph at 128 (K2)
     and 64 envs (K4) against phase 4's eager ones. Replays and their reads
     of each path run under set_sync_debug_mode("error"). The problem path
     (encoders, ProblemTemplate.solve, the command line): K1 against its
     twin on a TSP of integer points (Manhattan metric, integer penalty:
     exact fields) encoded at Np = 128, 256, 384 (R in {1, 32, 37}) and 4096
     (R in {32, 1024}), spins, dE and counts bitwise; TSP-64 (seed 7) solved
     at R=1024 and 2000 sweeps through K1, one launch per sweep done, the
     tour a permutation; a dense bipartite MaxCut of 4096 nodes
     (sweep_method="blocked": "auto" takes the coloured engine) through K1
     to the full cut; a sparse bipartite MaxCut at G-set G55's scale (5000
     nodes, 12498 unit edges): K4 (R=32, 3 Philox sweeps) and K2 (R=1024,
     3 Philox and 2 host-threshold sweeps) against TwinSparseTEngine and
     K2's plain version, spins, dE and counts bitwise; then solved through
     K4 (R=32), K2 (R=1024) and PT (K4, 32
     replicas), one launch per colour or per sweep, each at least 99.9% of
     the full cut; each run's best_energy == the energy of its decoded
     spins (1e-4 relative); benchmark_instance's five seeds sharing one
     capture, each trial equal to a fresh call bit for bit; and
     `sgt-torch solve -p tsp -s 20 --sweeps 2000` on the card through
     click's CliRunner (exit 0, objective, energy, feasible; K1 alone, its
     launches read from the launch ledger over the command). The
     drivers' remaining paths: (a) anneal on the SK glass (K1, R=1024, 500
     sweeps, chunks of 50, early stop off) checkpointed every 2 chunks, cut
     back to its first kept checkpoint and resumed; (b) the same for pt.run
     (1000 sweeps, a save every 20 super-steps) at 16 replicas on the
     Gaussian 10k graph (K4) and at 128 on the TTT instance (K2): each equal
     to the uninterrupted run bit for bit (best spins, best energies, four
     histories), the resumed launches those of the sweeps left; (c) PT with
     cluster_moves=1 on the TTT instance at 128 (K2 + C2 + C1) and 16 (K4 +
     C2 + C1) replicas, 1000 sweeps: the captured super-step == its eager
     loop bit for bit, C2 and C1 once per super-step, checkpointed and
     resumed == uninterrupted, no host sync in a replay, E0 + dE ==
     E1 across an SW sweep (1e-4 relative), best_energy == energy(best
     spins) (1e-4), the best energy beside the provenance's (recorded);
     (d) tune_ladder at 16 replicas (K4, pilot 200, 2 iterations): the JAX
     test's spread criterion, endpoints kept; (e) the compact engine through
     anneal at 10k x 1024 == its eager sweep; (f) `sgt-torch solve -p tsp -s
     20 -a pt --cluster-moves 1 --tune-ladder --checkpoint-dir D`, the same
     with --resume (the same output), and `-p maxcut --sweep-method
     sparse_compact`, each exit 0. The batch, adaptive and operations
     slice: BatchProcessor() at its defaults (200 sweeps, 16 replicas,
     batches of 16) over 64 Gaussian SK glasses at N=2048 drawn on the
     card: one captured stacked run (P = 16), K1 exactly 200 launches per
     batch, every result "sa/batched" (no batch fell back to per-problem
     anneal), no failure, best_energy == energy(best_spins) (1e-4), and one
     batch's replay == its eager loop bit for bit with no host sync in the
     replay; a mixed set (8 each at N=500, 1000, 2048) bucketed into three
     stacked runs; AdaptiveBatchProcessor over the 64 (its batch sizes and
     captures); adaptive_anneal at its defaults (2000 sweeps) on the SK
     4096 glass (K1, R=32) and on the 10k graph at R=32 (K4) and R=1024
     (K2): the interventions the JAX rule makes on the run's history (at
     least one), one launch per sweep (per colour for K4), the energy
     identity; sgt-torch health (exit 0, the micro-anneal on K1), benchmark
     --sizes 20,50 --sweeps 500 --trials 2 (each case's engine printed),
     monitor (the card's memory), /metrics from SGT_METRICS_PORT scraped in
     process after an anneal, bench --path dense (one JSON line) and
     cache-stats. The research layer on a Gaussian SK glass at N=1024
     (seed 42), each call with its seconds, captures and K1 launches:
     SQA at SQAConfig() twice (K1 at [8192, 16], 1000 launches; one
     capture, then none; the best slice's energy == the energy of the
     returned spins), PIMC (500), QEC ([3072, 16], 400), MSHO (one anneal
     per level), AQIA (R=32, 500 replays of a captured iteration), LESD
     (R=16, 300 replays of a captured iteration), compare_algorithms, MetaOptimizer.solve on
     sa / pt / adaptive_sa / sqa, the federated SA and SQA servers (4
     clients, 2 rounds), pareto.optimize, UnifiedResearchFramework.compare,
     BreakthroughResearchFramework.validate (2 trials) and the meta-RL
     agent (3 solves, a refit). The distributed layer on a one-rank NCCL
     group (multihost.initialize): pt_sharded.run (the super-step captured
     with its all-gather inside) through K1 (SK 4096 x 1024), K2 (the 10k
     graph, R=128) and K4 (R=16), each == pt.run on the same seed bit for
     bit, twice, the engine's launches exact; blocked_sweep_sharded
     (captured with its all-reduces) and colored_sweep_sharded at N=4096,
     R=256 == the plain sweeps on the same uniforms bit for bit (+-J); the
     sharded PPO's 4 captured updates (SK N=512, 256 envs, K1) == make_ppo's
     (metrics and parameters bitwise); JobCoordinator(2) and WorkerPool(4)
     running 8 SA seeds through K1 from their threads == each seed's call
     alone; EdgeOrchestrator's sa, pt and sqa on the card; then
     `sgt-torch quality-gates` over every gate but suite_budget (printed as
     excluded), all passing. The host C++ routines (native): the greedy
     colourings, plain and balanced, and build_ell at 100k spins through
     the C++ library and through their numpy versions, bitwise equal, both
     times printed; every other native call of the run (make_engine's
     colourings, EllProblem.from_coo's ELL build, from_terms' scatter) must
     have gone through the C++ library;
  5. timing: each kernel's bound (bytes over 3.35 TB/s against operations
     over the peak of their type) and the two library yardsticks for K1's
     and K2's field work alone (torch.matmul, torch.sparse.mm; the port
     calls neither); bench_dense (K1) at block 128 and one twin sweep;
     profile_chunk's device breakdown of anneal's loop; bench_sparse (K2),
     K2 alone at R=128, one sweep of K2's twin at R=1024; K3 and its twin
     at [10240, 4096]; the TTT median; bench_pt10k (300 sweeps); the device
     breakdown of a sparse SA chunk and of the TTT loop; K1, K5, K6 (2, 4)
     and K7 at N=4096, R=1024, blocks 128 and 256, in turns, beside the
     twins' sweeps at that shape (timed in phase 2); K4 in gather mode alone
     over one sweep's colours beside its plain version and K4 on given
     fields; an ea3d-shaped pt.run (L=32, R=136, heat bath, overlaps on)
     whose launches must be one overlap a super-step and two K4 a sweep,
     its last q the twin's, and the overlap kernel at [32768, 136] as a
     graph beside its plain version and its bound; SA anneals at the two
     SA cells' shapes (one sa_track launch a sweep, best_copy_share) and
     sa_track at both shapes as a graph at their copy shares beside its
     bound, its twin and torch.where alone; pt_latch on the TTT state as a
     graph with nothing to copy (at most 5 us) and on a hit, beside its
     byte bounds and its twin; PT at R=4096 three
     ways in turns (the K3 path, the K4 path, K2 with its budget lifted)
     with each way's device breakdown; PT at 16
     replicas through K4 and through the plain [R, N] engine; bench_rl's
     env steps/s with its window rates, and profile_rl's breakdown of one
     PPO update (us per env step, device-busy share, launches per env
     step, K1's share, rollout against learning phase); bench_dqn at k=1
     and 64 steps per read, profile_dqn's breakdown of one DQN step and its
     eager act / learn split, and the captured evaluation against the eager
     loop in turns; each captured
     driver against the eager loop of its step in turns
     (headline.captured_vs_plain: the dense and sparse SA chunk, TTT, one
     PPO update; whole calls of anneal, dense and sparse, and of pt.run at
     bench_pt10k's shape: the eager loop, a first call with its capture, a
     repeat call), the captured paths' busy shares and graph launches per
     sweep or env step, and in each profile the kernels the profiler counts
     per name against what the launch ledger counted over the same
     replays (the cluster-move super-steps' C2 and C1 too). The drivers'
     remaining paths: C2 and C1 at [128, 10112] and [16, 10112] in both
     draw modes beside their plain versions and bounds, C1's table at 16
     replicas in one block against clusters of 2, 4 and 8 in turns; one SW
     sweep as a graph; the captured PT
     super-step with and without cluster_moves=1 at 128 and 16 replicas; the
     layout round trip; a dense checkpoint's bytes and save time; segmented
     against single-dispatch pt.run; tune_ladder's time and captures; the
     compact engine beside K2. The batch slice: the stacked K1 at P = 16,
     [2048, 16] against 16 one-problem launches in turns (graphs) and its
     bound; BatchProcessor.process of the 64 glasses, first call (its
     capture inside) and repeat call, and one batch's device breakdown
     (headline.profile_batch); adaptive_anneal against sa.anneal at the
     same budget (SK 4096, 2000 sweeps, R=32), in turns. The research
     layer: K1 at the Trotter shape [8192, 16] (a graph of 20 launches)
     against its bound; K1 against its twin there on the same spins and
     uniforms (the SK glass's Trotter problem: energy identity within 1e-4
     relative, counts within 0.5%; a +-J SK glass at N=1024, P=8 with
     J_perp 0.25: spins, dE and counts bitwise);
     headline.profile_research's breakdowns of SQA, PIMC, AQIA and LESD;
     and sparse SQA at the ea2d-l80.sqa shape (80x80, P=20, R=128): a
     short carried run's launches from the ledger (K2 and sa_track once a
     sweep), the replayed engine's tables against a fresh build after the
     field rewrites, K2 at [128000, 128] on that engine against the fresh
     engine's twins, and K2 there as a graph against its plain version and
     its bound.
     The distributed layer: the sharded PT super-step against pt.run's at
     the three shapes in turns and the all-gather of [5, R] alone (a graph
     of 20); the captured model-sharded blocked sweep against the plain
     eager one, and the coloured ones; the sharded PPO's env steps/s against
     make_ppo's (8 captured updates, in turns) and bench_rl's.

Any failed check exits non-zero. The last line is the JSON status
{"ok": true, "device": {...}}; the line before it lists the kernels.
Without a CUDA device, or without the package beside this file, it exits 1
and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SA_BLOCK = 128  # SAConfig's block_size: the K1 build anneal launches
# kernel (csrc/<name>.cu) -> the Pallas TPU kernel it replaces
KERNELS = {
    "metropolis_sweep": "spinglass_tpu/kernels/metropolis_pallas.py:73",
    "sparse_sweep": "spinglass_tpu/kernels/sparse.py:756",
    "sparse_thresholds": "spinglass_tpu/kernels/sparse.py:523",
    "sparse_accept": "spinglass_tpu/kernels/sparse.py:582",
    "metropolis_pipelined": "spinglass_tpu/kernels/metropolis_pallas.py:400",
    "metropolis_interleaved": "spinglass_tpu/kernels/metropolis_pallas.py:281",
    "metropolis_folded": "spinglass_tpu/kernels/metropolis_pallas.py:179",
    # C1 and C2 have no Pallas counterpart: the JAX code they replace (the
    # labelling while_loop and flips; the bond and ghost activation)
    "sw_labels": "spinglass_tpu/core/cluster.py:291",
    "sw_bonds": "spinglass_tpu/core/cluster.py:240",
    # the overlap kernel replaces nothing: the JAX package measures no
    # overlap of real replicas
    "replica_overlap": None,
    # nor the SA driver's best tracking: the JAX package has it inside its
    # jitted scan (XLA fuses it), not as a Pallas kernel
    "sa_track": None,
    # nor the time-to-target latch: the JAX package runs the whole solve as
    # one lax.while_loop on the device, whose state is the answer at its end
    "pt_latch": None,
}
# FusedSweep flags of the dense variants, by label
VARIANTS = {"K5": dict(pipelined=True), "K6x2": dict(interleave=2),
            "K6x4": dict(interleave=4), "K7": dict(folded=True)}
TF32_NOTE = "torch.backends.cuda.matmul.allow_tf32 = False (full float32 matmuls)"
# published peaks of one H100 SXM (NVIDIA's data sheet): device memory,
# bf16 tensor cores, float32 outside the tensor cores
HBM_BYTES_PER_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
# integer and float operations of one run of Philox4x32-10 (10 rounds of 4
# multiplies, 4 xors and 2 adds) and of one threshold from an output word
# (the conversion and the logarithm); counted at the float32 rate (the data
# sheet gives no int32 one). The sparse kernels' stream takes four
# thresholds from a run, so their work is a quarter run per entry.
PHILOX_RUN_OPS, THRESHOLD_OPS = 100, 10
SPARSE_DRAW_OPS = PHILOX_RUN_OPS / 4 + THRESHOLD_OPS


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(least milliseconds the card could take, what bounds it)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)
    print(f"  ok: {msg}")


def pm_j_problem(n: int, seed: int, device):
    """+-1 couplings and h on a quarter grid: every field is exact in f32."""
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return IsingProblem.from_dense(j, h, device=device)


def sk_problem(device):
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    j = topology.fully_connected(4096, dist="gaussian", scale=1.0 / 64, seed=42)
    return IsingProblem.from_dense(j, device=device)


def phase_parity(torch, mc, stats):
    """Phase 2: the kernel against the twin on identical inputs."""
    from spinglass_tpu_torch.core.energy import energy_t
    from spinglass_tpu_torch.core.problem import random_spins

    gen = torch.Generator().manual_seed(7)
    worst = 0.0

    def compare(problem, r, rule, block, sweeps, beta, philox):
        nonlocal worst
        fused = mc.FusedSweep(problem, block_size=block, rule=rule)
        s_k = random_spins(gen, (r, problem.n_padded),
                           problem.active_mask).t().contiguous()
        s_p = s_k.clone()
        for k in range(sweeps):
            if philox:
                seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                _, de_k, c_k = fused(s_k, beta, seed)
                u = mc.philox_uniforms(seed, problem.n_padded, r, device="cuda")
            else:
                u = torch.rand(problem.n_padded, r, generator=gen).cuda()
                _, de_k, c_k = fused.sweep_with_uniforms(s_k, beta, u)
            _, de_p, c_p = mc.fused_sweep_reference(
                problem.j, problem.h, problem.active_mask, s_p, beta, u,
                rule, fused.block_size)
            torch.cuda.synchronize()
            worst = max(worst, float((de_k - de_p).abs().max()))
            if not (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                    and torch.equal(de_k, de_p)):
                raise CheckFailed(
                    f"kernel != twin: N={problem.n_spins} R={r} {rule} "
                    f"block {block} philox={philox} sweep {k}: "
                    f"{int((s_k != s_p).sum())} spins, "
                    f"{int((c_k != c_p).sum())} counts differ")

    small = pm_j_problem(500, 3, "cuda")
    for r, rule, block in itertools.product((1, 37, 256),
                                            ("metropolis", "glauber"),
                                            (128, 256)):
        beta = torch.rand(r, generator=gen).cuda() * 2.0 + 0.1
        compare(small, r, rule, block, 3, beta, philox=False)
    check(True, "+-J N=500 (Np=512), R in {1,37,256}, both rules, blocks "
                "128/256, 3 host-uniform sweeps: spins, dE, counts bitwise")
    for r in (37, 256):
        beta = torch.rand(r, generator=gen).cuda() * 2.0 + 0.1
        compare(small, r, "metropolis", 256, 3, beta, philox=True)
        compare(small, r, "glauber", 128, 3, beta, philox=True)
    check(True, "+-J N=500, Philox mode vs twin on philox_uniforms: bitwise")
    big = pm_j_problem(4096, 5, "cuda")
    beta = torch.full((1024,), 0.05, device="cuda")
    for rule, block, philox in (("metropolis", 128, False),
                                ("glauber", 128, True),
                                ("metropolis", 256, True)):
        compare(big, 1024, rule, block, 1, beta, philox)
    check(True, "+-J N=4096, R=1024 (the slice's shape): Metropolis at block "
                "128 with host uniforms, Glauber at 128 and Metropolis at 256 "
                "in Philox mode: bitwise")
    driver_parity(torch, mc, big)
    # j_dtype="bfloat16": +-J is its own rounding, so the mode equals the
    # float32 twin bit for bit; then the one-block float32 kernel, which
    # the wrapper takes beyond the cluster kernel's shapes
    def compare_mode(problem, r, block, beta, what, **kw):
        nonlocal worst
        fused = mc.FusedSweep(problem, block_size=block, **kw)
        if what == "one-block":
            fused.tile = mc.BLOCK_TILE
        s_k = random_spins(gen, (r, problem.n_padded),
                           problem.active_mask).t().contiguous()
        s_p = s_k.clone()
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        _, de_k, c_k = fused(s_k, beta, seed)
        u = mc.philox_uniforms(seed, problem.n_padded, r, device="cuda")
        _, de_p, c_p = mc.fused_sweep_reference(
            problem.j, problem.h, problem.active_mask, s_p, beta, u,
            "metropolis", block)
        torch.cuda.synchronize()
        worst = max(worst, float((de_k - de_p).abs().max()))
        if not (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                and torch.equal(de_k, de_p)):
            raise CheckFailed(f"{what} kernel != twin: N={problem.n_spins} "
                              f"R={r} block {block}")

    for what, kw in (("bfloat16", dict(j_dtype="bfloat16")), ("one-block", {})):
        for r, block in ((37, 128), (256, 256)):
            compare_mode(small, r, block,
                         torch.rand(r, generator=gen).cuda() * 2.0 + 0.1,
                         what, **kw)
        for block in (128, 256):
            compare_mode(big, 1024, block, beta, what, **kw)
    check(True, 'j_dtype="bfloat16" (one plane) and the one-block float32 '
                "kernel on +-J N=500 (R 37, 256) and N=4096, R=1024, blocks "
                "128/256, Philox: spins, dE, counts bitwise equal to the twin")
    stats["max_abs_err"] = worst

    sk = sk_problem("cuda")
    stats["sk"] = sk
    fused = mc.FusedSweep(sk, block_size=SA_BLOCK)
    check(fused.planes == 3 and fused.tile == mc.CLUSTER_TILE
          and mc.FusedSweep(big, block_size=SA_BLOCK).planes == 1,
          f"the SK instance needs all 3 bf16 planes of J, +-J one; K1's tile "
          f"at Np=4096 is {fused.tile} (columns, thread blocks per cluster)")
    s0 = random_spins(gen, (1024, sk.n_padded), sk.active_mask).t().contiguous()
    stats["sk_spins"] = s0
    u = torch.rand(sk.n_padded, 1024, generator=gen).cuda()
    beta = torch.ones(1024, device="cuda")
    e0 = energy_t(sk, s0)
    s_k, de_k, c_k = fused.sweep_with_uniforms(s0.clone(), beta, u)
    e1 = energy_t(sk, s_k)
    s_p, de_p, c_p = mc.fused_sweep_reference(sk.j, sk.h, sk.active_mask,
                                              s0.clone(), beta, u,
                                              block_size=fused.block_size)
    torch.cuda.synchronize()
    rel = float(((e0 + de_k - e1).abs() / e1.abs().clamp(min=1.0)).max())
    check(rel <= 1e-4, f"SK N=4096 R=1024 block {fused.block_size} energy "
                       f"identity E0+dE==E1: "
                       f"max rel err {rel:.3e} <= 1e-4")
    ck, cp = int(c_k.sum()), int(c_p.sum())
    check(abs(ck - cp) <= 0.005 * cp,
          f"SK accept counts kernel {ck} vs twin {cp} (within 0.5%); "
          f"replicas bitwise equal {int((s_k == s_p).all(0).sum())}/1024, "
          f"max |dE_k - dE_twin| {float((de_k - de_p).abs().max()):.3e}")
    stats["host_acc"] = ck / (1024 * 4096)
    # the bf16 mode on the SK instance: its twin sweeps on the rounded J
    bf = mc.FusedSweep(sk, block_size=SA_BLOCK, j_dtype="bfloat16")
    sk_r = type(sk)(j=bf.j, h=sk.h, active_mask=sk.active_mask,
                    n_spins=sk.n_spins)
    e0 = energy_t(sk_r, s0)
    s_k, de_k, c_k = bf.sweep_with_uniforms(s0.clone(), beta, u)
    e1 = energy_t(sk_r, s_k)
    s_p, de_p, c_p = bf.reference(s0.clone(), beta, u)
    torch.cuda.synchronize()
    rel = float(((e0 + de_k - e1).abs() / e1.abs().clamp(min=1.0)).max())
    ck, cp = int(c_k.sum()), int(c_p.sum())
    check(bf.planes == 1 and rel <= 1e-4 and abs(ck - cp) <= 0.005 * cp,
          f'SK j_dtype="bfloat16": energy identity on the rounded J max rel '
          f"err {rel:.3e} <= 1e-4; accept counts kernel {ck} vs twin {cp} "
          f"(within 0.5%); replicas bitwise equal "
          f"{int((s_k == s_p).all(0).sum())}/1024")


def driver_parity(torch, mc, problem):
    """Three sweeps of the SA driver through make_engine's engine, against
    the same driver with the kernel swapped for the twin on the kernel's
    Philox stream: every piece of the state must be equal bit for bit."""
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine
    from spinglass_tpu_torch.anneal.twins import TwinFusedEngine

    cfg = sa.SAConfig(n_sweeps=500, n_replicas=1024)
    engine = sa.make_sweep_engine(problem, cfg)
    check(type(engine) is CudaFusedEngine
          and engine.fused.block_size == SA_BLOCK,
          f"make_engine picks CudaFusedEngine, block {SA_BLOCK}")
    twin = TwinFusedEngine(problem, block_size=cfg.block_size,
                           rule=cfg.update_rule)
    out, launched = [], []
    for eng in (engine, twin):
        l0 = build.launch_snapshot()
        state = sa.init_state(problem, cfg, eng)
        state, _ = sa.run_chunk(problem, cfg, eng, state, 3)
        out.append(state)
        launched.append(build.launches_since(l0, [mc.KERNEL_NAME]))
    a, b = out
    torch.cuda.synchronize()
    fields = ("spins", "energy", "best_energy", "best_spins", "acc_rate")
    diff = [k for k in fields if not torch.equal(getattr(a, k), getattr(b, k))]
    if not torch.equal(a.sched.temp, b.sched.temp):
        diff.append("sched.temp")
    check(not diff and launched == [{mc.KERNEL_NAME: 3}, {mc.KERNEL_NAME: 0}],
          f"+-J N=4096 R=1024: 3 sweeps of sa.run_chunk, kernel engine == "
          f"twin engine bitwise in {', '.join(fields)}, sched.temp "
          f"(differ: {diff or 'none'}; acceptance of the last sweep "
          f"{float(a.acc_rate.mean()):.4f})")


def phase_philox(torch, mc, stats):
    """Phase 3: in-kernel Philox against exact enumeration and host uniforms."""
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins

    n, beta_v, r, sweeps = 6, 0.6, 512, 400
    j = topology.fully_connected(n, dist="gaussian", scale=0.4, seed=11)
    h = np.random.default_rng(11).normal(0, 0.2, n)
    p = IsingProblem.from_dense(j, h, device="cuda")
    states = np.array(list(itertools.product([-1.0, 1.0], repeat=n)))
    energies = np.array([-0.5 * s @ j @ s - h @ s for s in states])
    logw = -beta_v * energies
    probs = np.exp(logw - logw.max())
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(1)
    fused = mc.FusedSweep(p)
    s = random_spins(gen, (r, p.n_padded), p.active_mask).t().contiguous()
    beta = torch.full((r,), beta_v, device="cuda")
    trace = []
    for k in range(sweeps):
        s, _, _ = fused(s, beta, int(torch.randint(0, 2 ** 62, (1,), generator=gen)))
        if k >= 100:
            trace.append(s[:n].t().clone())
    samples = torch.cat(trace).cpu().numpy()
    codes = ((samples > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    state_codes = ((states > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    emp = np.bincount(codes, minlength=2 ** n) / len(codes)
    tv = 0.5 * np.abs(emp[state_codes] - probs).sum()
    check(tv < 0.05, f"6-spin Boltzmann, R=512, 400 Philox sweeps, beta=0.6: "
                     f"TV {tv:.4f} < 0.05")

    sk = stats["sk"]
    beta = torch.ones(1024, device="cuda")
    _, _, c = mc.FusedSweep(sk, block_size=SA_BLOCK)(
        stats["sk_spins"].clone(), beta, 12345)
    acc = int(c.sum()) / (1024 * 4096)
    host = stats["host_acc"]
    check(abs(acc - host) <= 0.01 * host,
          f"SK beta=1 mean acceptance Philox {acc:.5f} vs host uniforms "
          f"{host:.5f} (within 1%)")


def phase_slice(torch, mc, stats):
    """Phase 4: the dense SA slice through the user's entry points."""
    from spinglass_tpu_torch import IsingProblem, SAConfig, anneal, energy
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.core import topology

    j = topology.fully_connected(4096, dist="gaussian", scale=1.0 / 64, seed=42)
    problem = IsingProblem.from_dense(j, device="cuda")
    cfg = SAConfig(n_sweeps=500, n_replicas=1024)
    # inside a chunk nothing may wait for the device (sa.py's contract)
    eng = sa.make_sweep_engine(problem, cfg)
    state = sa.init_state(problem, cfg, eng)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sa.run_chunk(problem, cfg, eng, state, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(True, "a chunk of sweeps runs under set_sync_debug_mode('error'): "
                "no host sync inside a chunk")
    # the count is the launches of this call, the main path's
    t0 = time.perf_counter()
    res = anneal(problem, cfg)
    wall = time.perf_counter() - t0
    stats["dense_first"] = (problem, cfg, res)
    launches = res.metadata["kernel_launches"].get(mc.KERNEL_NAME, 0)
    stats["launches"] = launches
    print(f"  anneal wall {wall:.3f} s (engine selection and set-up included); "
          f"total_time {res.total_time:.3f} s (the first call: the capture "
          f"included), {res.sweeps_per_second:.1f} sweeps/s, "
          f"{res.spin_flips_per_second:.4e} flips/s")
    check(res.metadata["engine"] == "cuda_fused",
          f"make_engine picked {res.metadata['engine']} (CudaFusedEngine)")
    check(launches == 500, f"K1 launched {launches} times in the run, "
                           f"expected 500")
    e_n = res.best_energy / 4096
    check(e_n <= -0.72, f"best energy per spin {e_n:.5f} <= -0.72 "
                        f"(SK ground state ~ -0.763)")
    s = torch.ones(problem.n_padded, device="cuda")
    s[:4096] = torch.as_tensor(res.best_spins, device="cuda")
    e_best = float(energy(problem, s))
    rel = abs(e_best - res.best_energy) / abs(e_best)
    check(rel <= 1e-3, f"best_energy {res.best_energy:.4f} == energy(best_spins) "
                       f"{e_best:.4f} (rel {rel:.2e} <= 1e-3)")
    check(bool(torch.isfinite(torch.as_tensor(res.energy_history)).all())
          and len(res.energy_history) == 10, "10 finite history records")
    import dataclasses
    res = anneal(problem, dataclasses.replace(cfg, j_dtype="bfloat16"))
    e_n = res.best_energy / 4096
    n_bf = res.metadata["kernel_launches"].get(mc.KERNEL_NAME, 0)
    check(n_bf == 500 and e_n <= -0.72,
          f'anneal(j_dtype="bfloat16"): K1 launched {n_bf} times, best energy '
          f"per spin {e_n:.5f} <= -0.72 on the true couplings; "
          f"{res.sweeps_per_second:.1f} sweeps/s")


def phase_timing(torch, mc, stats, card):
    """Phase 5: K1 through bench_dense (block 256 is timed beside the
    variants), and one sweep of the twin."""
    from spinglass_tpu_torch.benchmarks.headline import bench_dense, profile_chunk

    b = bench_dense(sweeps=200, block_size=SA_BLOCK)
    us_k = b["extras"]["us_per_sweep"]
    print(f"  K1 bench_dense N=4096 R=1024 block {b['extras']['block_size']}: "
          f"{us_k:.1f} us/sweep, {b['value']:.4e} flips/s [{card}]")
    sk = stats["sk"]
    beta = torch.ones(1024, device="cuda")
    u = torch.rand(sk.n_padded, 1024, device="cuda")
    s = stats["sk_spins"].clone()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    mc.fused_sweep_reference(sk.j, sk.h, sk.active_mask, s, beta, u,
                             block_size=SA_BLOCK)
    stop.record()
    stop.synchronize()
    us_p = start.elapsed_time(stop) * 1e3
    print(f"  plain twin, one sweep N=4096 R=1024 block {SA_BLOCK}: "
          f"{us_p:.1f} us/sweep [{card}]")
    prof = profile_chunk(block_size=SA_BLOCK)
    stats["profiles"]["dense SA chunk (K1, 4096 x 1024)"] = prof
    print(f"  profile_chunk (anneal's loop, {prof['sweeps']} sweeps, block "
          f"{SA_BLOCK}): {prof['us_per_sweep']:.1f} us/sweep, profiled "
          f"{prof['profiled_us_per_sweep']:.1f}; kernels "
          f"{prof['device_us_per_sweep']:.1f} us/sweep, device busy "
          f"{100 * prof['device_busy_share']:.1f}% [{card}]")
    for k in prof["kernels"]:
        print(f"    {k['us_per_sweep']:9.2f} us/sweep  {k['calls']:5d} calls  "
              f"{k['name'][:80]}")
    stats["ms"] = us_k / 1e3
    stats["plain_ms"] = us_p / 1e3
    # the bound of the dense kernels at this shape, one for K1, K5, K6 and K7
    # (one function; metropolis_cuda.dense_sweep_bound): J read once, the
    # spins read and written, h, mask, beta, dE and counts; 2 Np^2 R
    # operations per plane of J on the bf16 tensor cores
    n_pad, r = sk.n_padded, 1024
    planes = mc.FusedSweep(sk, block_size=SA_BLOCK).planes
    stats["bounds"] = {name: mc.dense_sweep_bound(name, n_pad, r, planes)
                       for name in mc.DENSE_KERNELS}
    b_ms, b_by = stats["bounds"][mc.KERNEL_NAME]
    b1_ms, _ = mc.dense_sweep_bound(mc.KERNEL_NAME, n_pad, r, 1)
    print(f"  K1-K7 (dense) bound at Np={n_pad}, R={r}: {1e3 * b_ms:.1f} us "
          f"({b_by}: {planes} bf16 planes x {2.0 * n_pad * n_pad * r:.3e} "
          f"FLOP at 989 TFLOP/s; one plane {1e3 * b1_ms:.1f} us); K1 takes "
          f"{us_k:.1f} us, {100 * 1e3 * b_ms / us_k:.1f}% of its bound's "
          f"rate [{card}]")
    # library yardstick for the field work alone (no sweep does only this,
    # and the port never calls it): J @ s in full float32
    s = stats["sk_spins"]
    torch.matmul(sk.j, s)
    start.record()
    for _ in range(10):
        torch.matmul(sk.j, s)
    stop.record()
    stop.synchronize()
    print(f"  yardstick torch.matmul(J [{n_pad}, {n_pad}], s [{n_pad}, {r}]), "
          f"float32 with TF32 off: {start.elapsed_time(stop) * 1e2:.1f} us "
          f"per call (K1's field work alone, without its decisions) [{card}]")


# ---------------------------------------------------------------------------
# K1's variants: K5 (pipelined), K6 (interleaved, 2 and 4 chains), K7 (folded)
# ---------------------------------------------------------------------------

def variant_parity(torch, mc, stats):
    """Phase 2 (variants): each against its own twin and against K1 on the
    same inputs, +-J, bit for bit. At the slice's shape the twin's sweep is
    timed (phase 5 reports it)."""
    from spinglass_tpu_torch.core.problem import random_spins

    gen = torch.Generator().manual_seed(23)
    worst = {label: 0.0 for label in VARIANTS}
    twin_us = {}
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def compare(problem, label, r, rule, block, philox, twin=True, beta=None):
        fused = mc.FusedSweep(problem, block_size=block, rule=rule,
                              **VARIANTS[label])
        flat = mc.FusedSweep(problem, block_size=block, rule=rule)
        s_k = random_spins(gen, (r, problem.n_padded),
                           problem.active_mask).t().contiguous()
        s_p, s_1 = s_k.clone(), s_k.clone()
        if beta is None:
            beta = torch.rand(r, generator=gen).cuda() * 2.0 + 0.1
        if philox:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            _, de_k, c_k = fused(s_k, beta, seed)
            _, de_1, c_1 = flat(s_1, beta, seed)
            u = mc.philox_uniforms(seed, problem.n_padded, r, device="cuda")
        else:
            u = torch.rand(problem.n_padded, r, generator=gen).cuda()
            _, de_k, c_k = fused.sweep_with_uniforms(s_k, beta, u)
            _, de_1, c_1 = flat.sweep_with_uniforms(s_1, beta, u)
        if twin:
            start.record()
            _, de_p, c_p = fused.reference(s_p, beta, u)
            stop.record()
            stop.synchronize()
            if (problem.n_spins, r, block) == (4096, 1024, 128):
                twin_us[label] = start.elapsed_time(stop) * 1e3
        else:  # K1 alone is the reference
            s_p, de_p, c_p = s_1, de_1, c_1
        torch.cuda.synchronize()
        worst[label] = max(worst[label], float((de_k - de_p).abs().max()))
        same = (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                and torch.equal(de_k, de_p))
        if not (same and torch.equal(s_k, s_1) and torch.equal(c_k, c_1)
                and torch.equal(de_k, de_1)):
            raise CheckFailed(
                f"{label} ({fused.kernel_name}) != twin or K1: N="
                f"{problem.n_spins} R={r} {rule} block {block} philox="
                f"{philox}: vs twin {int((s_k != s_p).sum())} spins, vs K1 "
                f"{int((s_k != s_1).sum())} spins differ")

    small = pm_j_problem(500, 3, "cuda")
    big = pm_j_problem(4096, 5, "cuda")
    # R: one column, a part of a tile, one tile of 72, a second tile, 15
    # tiles (one wave of clusters) and 16 (a second wave)
    shapes = ((1, "metropolis", 128, False), (16, "glauber", 256, True),
              (72, "metropolis", 256, False), (73, "glauber", 128, True),
              (1024, "glauber", 128, False), (1100, "metropolis", 256, True))
    for label in VARIANTS:
        for r, rule, block, philox in shapes:
            compare(small, label, r, rule, block, philox)
        # the slice's shape: against the twin (its sweep timed last) and K1
        # in Philox mode at block 128, and against K1 with host uniforms at
        # block 256; beta 0.05 as K1's check there, so replicas flip
        beta = torch.full((1024,), 0.05, device="cuda")
        compare(big, label, 1024, "glauber", 256, False, twin=False, beta=beta)
        compare(big, label, 1024, "metropolis", 128, True, beta=beta)
    check(True, "K5, K6 (2, 4 chains), K7 on +-J N=500, R in {1, 16, 72, 73, "
                "1024, 1100}, both rules, blocks 128/256, a host-uniform or a "
                "Philox sweep each: spins, dE, counts bitwise equal to each "
                "variant's twin and to K1; at N=4096, R=1024 (the slice's "
                "shape) bitwise equal to the twin and K1 at block 128 "
                "(Philox) and to K1 at block 256 (host uniforms)")
    # K5's, K6's and K7's cluster kernels at their envelope's edge, and one
    # block beyond it, where the one-block float32 kernels run
    edges = []
    for label, name in (("K5", mc.PIPELINED_KERNEL),
                        ("K6x2", mc.INTERLEAVED_KERNEL),
                        ("K6x4", mc.INTERLEAVED_KERNEL),
                        ("K7", mc.FOLDED_KERNEL)):
        for block in (128, 256):
            edge = mc.cluster_envelope(name, block)
            for n_pad in (edge, edge + block):
                problem = big if n_pad == 4096 else pm_j_problem(n_pad, 11,
                                                                 "cuda")
                fused = mc.FusedSweep(problem, block_size=block,
                                      **VARIANTS[label])
                # the rule's cluster size (K6's one-block tile is wider)
                want = mc.TILE_RULES[name](n_pad, block)
                check(fused.tile[1] == want[1] and (fused.tile ==
                      mc.CLUSTER_TILE) == (n_pad == edge),
                      f"{label} at n_pad {n_pad}, block {block}: tile "
                      f"{fused.tile}")
                # the twin at the edge; beyond it K1, which phase 2 holds to
                # its twin in both designs
                compare(problem, label, 73, "metropolis", block, True,
                        twin=n_pad == edge)
                edges.append(f"{label} {n_pad}/{block} {fused.tile}")
    check(True, "K5, K6 and K7 at the edge of their cluster kernels (+-J, "
                "R=73, Philox: bitwise equal to their twins and to K1) and "
                "one block beyond (bitwise equal to K1): " + ", ".join(edges))
    stats["variant_err"] = worst
    stats["variant_twin_us"] = twin_us


def _variant_run(torch, mc, problem, flags, sweeps, chunk):
    """sa's sweep step through CudaFusedEngine(**flags) on the SA config of
    the dense slice (its seeds, its schedule), with the anneal's exact
    resync every ``chunk`` sweeps. Returns (state, engine, worst relative
    error of the tracked energy against the exact one at a resync)."""
    import dataclasses

    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine

    cfg = sa.SAConfig(n_sweeps=sweeps, n_replicas=1024)
    engine = CudaFusedEngine(problem, block_size=cfg.block_size, **flags)
    state = sa.init_state(problem, cfg, engine)
    worst = 0.0
    for _ in range(sweeps // chunk):
        for _ in range(chunk):
            state = sa._one_sweep(problem, cfg, engine, state)
        exact = engine.energy(state.spins)
        worst = max(worst, float(((state.energy - exact).abs()
                                  / exact.abs().clamp(min=1.0)).max()))
        state = dataclasses.replace(state, energy=exact)
    torch.cuda.synchronize()
    return state, engine, worst


# E/N of the best replica after 500 sweeps of the slice's schedule may
# differ between K1 and a variant that sums its fields in another order
# (on the SK glass the trajectories part after a few sweeps): the two
# are held within this much of each other
ANNEAL_EN_TOL = 0.005


def variant_slice(torch, mc, stats):
    """Phase 4 (variants): the dense slice through each variant on the SK
    instance (500 sweeps against K1's 500 through the same driver), and 50
    on a +-J instance against K1."""
    sk = stats["sk"]
    stats["variant_launches"] = {}
    ref, _, _ = _variant_run(torch, mc, sk, {}, 500, 50)
    e_k1 = float(ref.best_energy.min()) / 4096
    _, _, res = stats["dense_first"]
    print(f"  K1 through the same driver, 500 sweeps: best E/N {e_k1:.5f} "
          f"(anneal's {res.best_energy / 4096:.5f})")
    for label, flags in VARIANTS.items():
        sweeps = 500
        l0 = build.launch_snapshot()
        state, engine, rel = _variant_run(torch, mc, sk, flags, sweeps, 50)
        name = engine.fused.kernel_name
        launches = build.launches_since(l0, [name])[name]
        stats["variant_launches"][name] = (
            stats["variant_launches"].get(name, 0) + launches)
        e_n = float(state.best_energy.min()) / 4096
        near = abs(e_n - e_k1) <= ANNEAL_EN_TOL
        if label.startswith("K6"):  # K1's sums in K1's order: K1's run
            near = near and torch.equal(state.spins, ref.spins) and \
                torch.equal(state.best_energy, ref.best_energy)
        check(launches == sweeps and e_n <= -0.72 and rel <= 1e-4 and near,
              f"{label} ({name}, tile {engine.fused.tile}): SK N=4096 "
              f"R=1024, {sweeps} sweeps of the SA schedule: launched "
              f"{launches} times, best E/N {e_n:.5f} <= -0.72 and within "
              f"{ANNEAL_EN_TOL} of K1's {e_k1:.5f}"
              + (", spins and best energies bitwise K1's"
                 if label.startswith("K6") else "")
              + f", energy identity max rel err {rel:.3e} <= 1e-4")
    pm = pm_j_problem(4096, 9, "cuda")
    ref, _, _ = _variant_run(torch, mc, pm, {}, 50, 50)
    for label, flags in VARIANTS.items():
        state, engine, _ = _variant_run(torch, mc, pm, flags, 50, 50)
        check(torch.equal(state.spins, ref.spins)
              and torch.equal(state.best_energy, ref.best_energy),
              f"{label}: +-J N=4096 R=1024, 50 Philox sweeps: spins and "
              f"best energies bitwise equal to K1's")


def variant_timing(torch, mc, stats, card):
    """Phase 5 (variants): us/sweep of K1 and each variant in turns; the
    twins' sweeps as phase 2 timed them."""
    sk = stats["sk"]
    beta = torch.ones(1024, device="cuda")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    labels = ["K1"] + list(VARIANTS)
    us = {}
    for block in (128, 256):
        sweeps = {lab: mc.FusedSweep(sk, block_size=block,
                                     **VARIANTS.get(lab, {}))
                  for lab in labels}
        s = stats["sk_spins"].clone()
        for turn in (labels, labels[::-1]):  # in turns: a b c ... c b a
            for lab in turn:
                fused = sweeps[lab]
                fused(s, beta, 1)
                start.record()
                for k in range(20):
                    fused(s, beta, 2 + k)
                stop.record()
                stop.synchronize()
                us.setdefault((lab, block), []).append(
                    start.elapsed_time(stop) * 1e3 / 20)
    for (lab, block), v in sorted(us.items(), key=lambda kv: kv[0][1]):
        print(f"  {lab:5s} N=4096 R=1024 block {block}: "
              f"{' / '.join(f'{x:.1f}' for x in v)} us/sweep [{card}]")
    for lab, t in stats["variant_twin_us"].items():
        print(f"  {lab} twin, one sweep N=4096 R=1024 block 128 (phase 2): "
              f"{t:.1f} us [{card}]")
    stats["variant_us"] = {lab: min(us[(lab, 128)]) for lab in labels}


# ---------------------------------------------------------------------------
# The sparse slice: K2 (single-call sparse sweep) and K3 (thresholds)
# ---------------------------------------------------------------------------

def pm_j_ell(n: int, seed: int):
    """Sparse +-1 couplings (average degree 6) with h on a quarter grid, as an
    EllProblem on the card: every field and dE is exact in float32."""
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    coo = topology.sparse_random_graph_coo(n, avg_degree=6.0, dist="binary",
                                           seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return EllProblem.from_coo(n, *coo, h=h, device="cuda")


def _finite_diff(a, b) -> float:
    """max |a - b| where both are finite; raises unless the infinities agree."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        raise CheckFailed("infinite entries differ")
    return float((a[fa] - b[fb]).abs().max()) if bool(fa.any()) else 0.0


def sparse_parity(torch, stats):
    """Phase 2 (sparse): K2 and K3 against their twins on identical inputs."""
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    gen = torch.Generator().manual_seed(17)
    worst = {"k2": 0.0, "k3": 0.0}
    for n in (2000, 10000):
        ell = pm_j_ell(n, 42 if n == 10000 else 5)
        for rule in ("metropolis", "glauber"):
            eng = SortedSparseTEngine(ell, rule=rule, accept_kernel="single")
            for r in (128, 256, 1024):
                s_k = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                                 ell.active_mask))
                s_p = s_k.clone()
                beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).cuda()
                for k in range(3):
                    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                    th_k = eng.kernels.thresholds(beta, seed, r)      # K3
                    th = sc.thresholds_reference(eng.mask_col, beta, seed, r,
                                                 rule)
                    worst["k3"] = max(worst["k3"], _finite_diff(th_k, th))
                    if not torch.equal(th_k, th):
                        raise CheckFailed(f"K3 != twin at [{eng.n_sorted}, {r}]")
                    if k == 0:   # host-threshold mode on K3's output
                        _, de_k, c_k = eng.kernels.single_sweep(s_k, beta, th=th_k)
                    else:        # in-kernel Philox mode: K2(seed)
                        _, de_k, c_k = eng.kernels.single_sweep(s_k, beta, seed=seed)
                    # the twin on K3(seed)
                    _, de_p, c_p = sc.single_sweep_reference(eng.groups, s_p, th_k)
                    torch.cuda.synchronize()
                    worst["k2"] = max(worst["k2"], float((de_k - de_p).abs().max()))
                    if not (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                            and torch.equal(de_k, de_p)):
                        raise CheckFailed(
                            f"K2 != twin: N={n} R={r} {rule} sweep {k}: "
                            f"{int((s_k != s_p).sum())} spins, "
                            f"{int((c_k != c_p).sum())} counts differ")
    check(True, "+-J sparse N=2000 and the 10k bench graph, R in {128, 256, "
                "1024}, both rules, 3 sweeps: K2 on K3(seed) and K2(seed) in "
                "Philox mode == the plain sweep on K3(seed), spins, dE, counts "
                "bitwise; K3(seed) == its twin")
    ell = pm_j_ell(10000, 42)
    eng = SortedSparseTEngine(ell, accept_kernel="single")
    for r, rule in ((1024, "metropolis"), (4096, "metropolis"),
                    (4096, "glauber"), (130, "metropolis"), (130, "glauber")):
        k3 = SortedSparseTEngine(ell, rule=rule, accept_kernel="none").kernels
        beta = torch.linspace(0.05, 3.0, r, device="cuda")
        l0 = build.launch_snapshot()
        th_k = k3.thresholds(beta, 2 ** 63 + r, r)
        th_p = sc.thresholds_reference(eng.mask_col, beta, 2 ** 63 + r, r,
                                       rule)
        torch.cuda.synchronize()
        check(torch.equal(th_k, th_p) and build.launches_since(
                  l0, [sc.THRESHOLD_KERNEL]) == {sc.THRESHOLD_KERNEL: 1},
              f"K3 == twin bitwise at [{eng.n_sorted}, {r}] {rule} (64-bit "
              f"seed{'; R % 4 != 0: scalar stores' if r % 4 else ''})")
    stats["k2_max_abs_err"], stats["k3_max_abs_err"] = worst["k2"], worst["k3"]
    sparse_gaussian_parity(torch)
    pt_driver_parity(torch)
    gaussian_identity(torch)


def sparse_gaussian_parity(torch):
    """K2 on the Gaussian 10k bench graph, where a field's last bit depends
    on the order of its sum: against the slot-ordered twin (the kernel's
    order) spins and counts must be equal bit for bit and dE within 1e-5 of
    its largest entry; against the per-colour twin, whose sums torch
    orders, the counts within 0.5%."""
    from spinglass_tpu_torch.benchmarks.headline import sparse_bench_problem
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    gen = torch.Generator().manual_seed(19)
    ell = sparse_bench_problem()
    differ = 0
    for rule in ("metropolis", "glauber"):
        eng = SortedSparseTEngine(ell, rule=rule, accept_kernel="single")
        k = eng.kernels
        for r in (128, 256, 1024):
            s_k = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                             ell.active_mask))
            s_o, s_p = s_k.clone(), s_k.clone()
            beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).cuda()
            for mode in ("philox", "host thresholds"):
                seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                th = k.thresholds(beta, seed, r)
                kw = dict(seed=seed) if mode == "philox" else dict(th=th)
                _, de_k, c_k = k.single_sweep(s_k, beta, **kw)
                _, de_o, c_o = sc.single_sweep_ordered(k.tables, k.span_list,
                                                       s_o, th)
                _, de_p, c_p = sc.single_sweep_reference(eng.groups, s_p, th)
                torch.cuda.synchronize()
                tol = 1e-5 * float(de_o.abs().max())
                if not (torch.equal(s_k, s_o) and torch.equal(c_k, c_o)
                        and float((de_k - de_o).abs().max()) <= tol):
                    raise CheckFailed(
                        f"K2 != slot-ordered twin on Gaussian 10k: R={r} "
                        f"{rule} {mode}: {int((s_k != s_o).sum())} spins, "
                        f"{int((c_k != c_o).sum())} counts differ")
                ck, cp = int(c_k.sum()), int(c_p.sum())
                if abs(ck - cp) > 0.005 * cp:
                    raise CheckFailed(f"K2 counts {ck} vs per-colour twin {cp}")
                differ += int((s_k != s_p).sum())
                s_p.copy_(s_k)  # keep the states together
    check(True, f"Gaussian 10k graph, R in {{128, 256, 1024}}, both rules, "
                f"Philox and host-threshold sweeps: K2 == its slot-ordered "
                f"twin (spins, counts bitwise; dE within 1e-5); against the "
                f"per-colour twin "
                f"{differ} spins differ in all, counts within 0.5%")


def pt_driver_parity(torch):
    """Two super-steps of pt.run's step through make_engine's engine (K2 at
    the TTT shape, R=128) against the same driver whose engine runs the twin
    on the kernel's Philox stream: the state must be equal bit for bit."""
    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.anneal.twins import TwinSparseTEngine
    from spinglass_tpu_torch.benchmarks import planted
    from spinglass_tpu_torch.benchmarks.headline import ttt_config
    from spinglass_tpu_torch.kernels.sparse import EllProblem, SortedSparseTEngine

    inst = planted.planted_gauge_coo(10000, 6.0, seed=42, frustration=0.3,
                                     magnitude="ones")
    ell = EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols, inst.vals,
                              device="cuda")
    cfg = ttt_config()
    step, _, engine = pt.make_pt_step(ell, cfg)
    check(type(engine) is SortedSparseTEngine and engine._takes_single(128),
          "make_engine picks SortedSparseTEngine (K2 path) for the 128-replica PT")
    twin = TwinSparseTEngine(ell)
    twin_step, _, _ = pt.make_pt_step(ell, cfg, engine=twin)
    out, launched = [], []
    for st_fn, eng in ((step, engine), (twin_step, twin)):
        l0 = build.launch_snapshot()
        state = pt.init_state(ell, cfg, torch.Generator().manual_seed(3), eng)
        for _ in range(2):
            state, _ = st_fn(state)
        out.append(state)
        launched.append(build.launches_since(l0, engine.kernel_names))
    a, b = out
    torch.cuda.synchronize()
    fields = ("spins", "slot", "energy", "best_energy", "best_spins",
              "exch_attempts", "exch_accepts", "acc_rate")
    diff = [k for k in fields if not torch.equal(getattr(a, k), getattr(b, k))]
    check(not diff and launched[0]["sparse_sweep"] == 20
          and launched[1]["sparse_sweep"] == 0
          and launched[0]["sparse_accept"] == 0,
          f"+-J planted 10k, 128 replicas: 2 super-steps of pt's step, kernel "
          f"engine == twin engine bitwise in {', '.join(fields)} (differ: "
          f"{diff or 'none'}; exchanges accepted {int(a.exch_accepts.sum())})")


def gaussian_identity(torch):
    """Gaussian couplings: E0 + dE == E1 after one sweep, through
    make_engine's engine on K2 (R=1024) and on K4 (R=4096 and R=16, which K2
    does not take), and on the threshold path (K3 + the plain sweep,
    R=4096)."""
    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.benchmarks.headline import sparse_bench_problem
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    ell = sparse_bench_problem()
    eng = make_engine(ell, r_hint=1024)
    none = SortedSparseTEngine(ell, accept_kernel="none")
    n_col = len(eng.groups)
    gen = torch.Generator().manual_seed(5)
    for e, r, path, key, n in ((eng, 1024, "K2", "sparse_sweep", 1),
                               (eng, 4096, "K4", "sparse_accept", n_col),
                               (eng, 16, "K4", "sparse_accept", n_col),
                               (none, 4096, "K3 + plain sweep",
                                "sparse_thresholds", 1)):
        s = e.to_layout(random_spins(gen, (r, ell.n_padded), ell.active_mask))
        e0 = e.energy(s)
        before = build.launch_snapshot()
        s, de, cnt = e.sweep(s, torch.full((r,), 1.0, device="cuda"), gen)
        e1 = e.energy(s)
        torch.cuda.synchronize()
        rel = float(((e0 + de - e1).abs() / e1.abs().clamp(min=1.0)).max())
        check(rel <= 1e-4 and build.launches_since(before, [key]) == {key: n},
              f"Gaussian 10k R={r} ({path}, {s.dtype}): E0 + dE == E1, max "
              f"rel err {rel:.3e} <= 1e-4; acceptance "
              f"{float(cnt.sum()) / (r * 1e4):.4f}")


def sparse_philox(torch):
    """Phase 3 (sparse): K2's Philox stream against exact enumeration."""
    import itertools as it

    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
    from spinglass_tpu_torch.kernels.sparse import EllProblem, SortedSparseTEngine

    n, beta_v, r, sweeps = 6, 0.6, 512, 400
    j = topology.fully_connected(n, dist="gaussian", scale=0.4, seed=11)
    h = np.random.default_rng(11).normal(0, 0.2, n)
    ell = EllProblem.from_problem(IsingProblem.from_dense(j, h, device="cuda"))
    eng = SortedSparseTEngine(ell)
    states = np.array(list(it.product([-1.0, 1.0], repeat=n)))
    logw = -beta_v * np.array([-0.5 * s @ j @ s - h @ s for s in states])
    probs = np.exp(logw - logw.max())
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(1)
    s = eng.to_layout(random_spins(gen, (r, ell.n_padded), ell.active_mask))
    beta = torch.full((r,), beta_v, device="cuda")
    l0 = build.launch_snapshot()
    trace = []
    for k in range(sweeps):
        s, _, _ = eng.sweep(s, beta, gen)
        if k >= 100:
            trace.append(eng.from_layout(s)[:, :n].clone())
    samples = torch.cat(trace).cpu().numpy()
    codes = ((samples > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    state_codes = ((states > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    emp = np.bincount(codes, minlength=2 ** n) / len(codes)
    tv = 0.5 * np.abs(emp[state_codes] - probs).sum()
    check(tv < 0.05 and build.launches_since(l0, ["sparse_sweep"]) == {"sparse_sweep": sweeps},
          f"6-spin EllProblem ({eng.n_colors} colours), R=512, 400 K2 Philox "
          f"sweeps, beta=0.6: TV {tv:.4f} < 0.05")


def sparse_slice(torch, stats):
    """Phase 4 (sparse): sparse SA, time-to-target and PT at R=4096, through
    the user's entry points."""
    import numpy as np

    from spinglass_tpu_torch import SAConfig, anneal
    from spinglass_tpu_torch.anneal import pt, sa
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.benchmarks.planted import time_to_target
    from spinglass_tpu_torch.kernels.sparse import sparse_energy

    ell = headline.sparse_bench_problem()
    cfg = SAConfig(n_sweeps=500, n_replicas=1024)
    eng = sa.make_sweep_engine(ell, cfg)
    state = sa.init_state(ell, cfg, eng)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sa.run_chunk(ell, cfg, eng, state, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(True, "a chunk of sparse sweeps (K2) runs under "
                "set_sync_debug_mode('error'): no host sync inside a chunk")

    def best_check(res, what):
        s = torch.ones(1, ell.n_padded, device="cuda")
        s[0, :ell.n_spins] = torch.as_tensor(res.best_spins, device="cuda")
        e = float(sparse_energy(ell, s)[0])
        rel = abs(e - res.best_energy) / abs(e)
        check(rel <= 1e-3 and np.isfinite(res.energy_history).all(),
              f"{what}: best_energy {res.best_energy:.4f} == energy(best_spins) "
              f"{e:.4f} (rel {rel:.2e} <= 1e-3), finite history")

    # the counts are those of each call (the first on this problem)
    t0 = time.perf_counter()
    res = anneal(ell, cfg)
    wall = time.perf_counter() - t0
    stats["sparse_first"] = (ell, cfg, res)
    k2 = res.metadata["kernel_launches"].get("sparse_sweep", 0)
    stats["k2_launches"] = k2
    print(f"  sparse anneal wall {wall:.3f} s (set-up included); total_time "
          f"{res.total_time:.3f} s (first call, capture included), "
          f"{res.sweeps_per_second:.1f} sweeps/s, "
          f"{res.spin_flips_per_second:.4e} flips/s, E/N "
          f"{res.best_energy / ell.n_spins:.5f}")
    check(res.metadata["engine"] == "sparse_sorted_t" and k2 == 500,
          f"anneal(10k sparse, R=1024, 500 sweeps) ran SortedSparseTEngine, "
          f"K2 launched {k2} times (500 expected), K3 "
          f"{res.metadata['kernel_launches'].get('sparse_thresholds')}")
    best_check(res, "sparse anneal")
    e_n = res.best_energy / ell.n_spins
    check(abs(e_n + 1.63) <= 0.01, f"sparse anneal E/N {e_n:.5f} within 0.01 "
                                   f"of -1.63")

    l0 = build.launch_snapshot()
    ttt = headline.bench_ttt(max_sweeps=20000)
    latch_n = build.launches_since(l0, ["pt_latch"])["pt_latch"]
    stats["ttt"] = ttt
    stats["latch_launches"] = latch_n
    ex = ttt["extras"]
    for run in ex["per_seed"]:
        print(f"    seed run: {run['seconds']:.4f} s, {run['sweeps']} sweeps, "
              f"best {run['best_energy']:.3f}, hit {run['hit']}, "
              f"{run['launched']} replays launched, {run['discarded']} "
              f"discarded")
    launched = sum(run["launched"] for run in ex["per_seed"])
    check(latch_n == launched and all(
              run["discarded"] == 1 and run["launched"] == run["sweeps"] // 10
              + 1 for run in ex["per_seed"] if run["hit"]),
          f"time_to_target: pt_latch launched {latch_n} times over the run, "
          f"once a replay ({launched}); one replay discarded a hit, queued "
          f"behind the super-step that hit")
    check(ex["all_hit"] and ex["engine"] == "sparse_sorted_t",
          f"time_to_target on the provenance instance (hash checked), 3 seeds, "
          f"<= 20000 sweeps: all hit threshold {ex['threshold']:.3f}; median "
          f"{ttt['value']:.4f} s")

    cfg = headline.pt_wide_config(n_sweeps=200)
    res = pt.run(ell, cfg)
    stats["pt_wide_first"] = (cfg, res)
    k4 = res.metadata["kernel_launches"]
    stats["k4_launches"] = k4.get("sparse_accept", 0)
    n_col = len(eng.groups)
    print(f"  PT R=4096: {res.total_time:.3f} s for 200 sweeps, "
          f"{res.spin_flips_per_second:.4e} flips/s, exchange rate "
          f"{pt.exchange_rate_summary(res)['mean_exchange_rate']:.3f}")
    check(res.metadata["engine"] == "sparse_sorted_t"
          and k4 == {"sparse_sweep": 0, "sparse_thresholds": 0,
                     "sparse_accept": 200 * n_col},
          f"pt.run(n_chains=32, R=4096, 200 sweeps) took make_engine's "
          f"choice beyond K2's budget, the fused sweep: K4 once per colour "
          f"({n_col}) and sweep, launches {k4}")
    best_check(res, "PT R=4096")


def sparse_timing(torch, stats, card):
    """Phase 5 (sparse): K2, K3 and their twins; TTT; bench_pt10k."""
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    b = headline.bench_sparse(sweeps=1000)
    us_k2 = b["extras"]["us_per_sweep"]
    print(f"  K2 bench_sparse 10k R=1024: {us_k2:.1f} us/sweep, "
          f"{b['value']:.4e} flips/s, engine {b['extras']['engine']} [{card}]")
    ell = headline.sparse_bench_problem()
    eng = SortedSparseTEngine(ell, accept_kernel="single")
    gen = torch.Generator().manual_seed(9)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn, reps):
        fn()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / reps

    s = eng.to_layout(random_spins(gen, (128, ell.n_padded), ell.active_mask))
    beta = torch.ones(128, device="cuda")
    us_128 = timed(lambda: eng.kernels.single_sweep(s, beta, seed=7), 200)
    s = eng.to_layout(random_spins(gen, (1024, ell.n_padded), ell.active_mask))
    beta = torch.ones(1024, device="cuda")
    th = eng.kernels.thresholds(beta, 7, 1024)
    us_twin = timed(lambda: sc.single_sweep_reference(eng.groups, s, th), 5)
    print(f"  K2 alone at R=128 (the TTT shape): {us_128:.1f} us/sweep; twin "
          f"(per-colour sweep) at R=1024: {us_twin:.1f} us/sweep [{card}]")
    beta = torch.ones(4096, device="cuda")
    us_k3 = timed(lambda: eng.kernels.thresholds(beta, 11, 4096), 50)
    us_k3_twin = timed(lambda: sc.thresholds_reference(eng.mask_col, beta, 11,
                                                       4096, "metropolis"), 5)
    print(f"  K3 [{eng.n_sorted}, 4096]: {us_k3:.1f} us/call; twin "
          f"{us_k3_twin:.1f} us/call [{card}]")
    ttt = stats["ttt"]
    print(f"  TTT median {ttt['value']:.4f} s (min {ttt['extras']['seconds_min']:.4f},"
          f" max {ttt['extras']['seconds_max']:.4f}) [{card}]")
    p = headline.bench_pt10k(sweeps=300)
    print(f"  bench_pt10k (16 replicas, 300 sweeps, {p['extras']['engine']}): "
          f"{p['value']:.4f} s, best {p['extras']['best_energy']:.3f} [{card}]")
    for name, prof in (("sparse SA chunk (R=1024)", headline.profile_sparse_chunk()),
                       ("TTT loop (R=128, 20 super-steps)", headline.profile_ttt())):
        stats["profiles"][name] = prof
        print(f"  profile {name}: {prof['us_per_sweep']:.1f} us/sweep, kernels "
              f"{prof['device_us_per_sweep']:.1f} us/sweep, device busy "
              f"{100 * prof['device_busy_share']:.1f}% [{card}]")
        for k in prof["kernels"][:4]:
            print(f"    {k['us_per_sweep']:9.2f} us/sweep  {k['calls']:5d} calls  "
                  f"{k['name'][:80]}")
    stats.update(k2_ms=us_k2 / 1e3, k2_plain_ms=us_twin / 1e3,
                 k3_ms=us_k3 / 1e3, k3_plain_ms=us_k3_twin / 1e3)
    # bounds. K2 at [NS, 1024]: the spins read and written, the tables
    # (idx, val, deg, h, mask), beta, dE, counts; a threshold per spin (a
    # quarter Philox run each) and an FMA per coupling and replica. K3 at
    # [NS, 4096]: th written, mask and beta read; a threshold per entry. K4
    # in gather mode over one sweep at [NS, 4096]: the int8 spins read and
    # written once, the tables, beta, dE, counts (every gather served by
    # the cache); a threshold per entry and an FMA per coupling and replica.
    ns, kmax = eng.n_sorted, eng.kernels.tables["idx"].shape[1]
    nnz = int(eng.kernels.tables["deg"].sum())
    tables = ns * (8 * kmax + 12)
    k2_bytes = 8 * ns * 1024 + tables + 12 * 1024
    k2_ops = ns * 1024 * SPARSE_DRAW_OPS + 2.0 * nnz * 1024
    k4_bytes = 2 * ns * 4096 + tables + 12 * 4096
    k4_ops = ns * 4096 * SPARSE_DRAW_OPS + 2.0 * nnz * 4096
    stats["bounds"].update({
        "sparse_sweep": bound(k2_bytes, k2_ops, FP32_FLOPS),
        "sparse_thresholds": bound(4 * ns * 4096 + 4 * ns + 4 * 4096,
                                   ns * 4096 * SPARSE_DRAW_OPS, FP32_FLOPS),
        "sparse_accept": bound(k4_bytes, k4_ops, FP32_FLOPS)})
    b128, _ = bound(8 * ns * 128 + tables + 12 * 128,
                    ns * 128 * SPARSE_DRAW_OPS + 2.0 * nnz * 128, FP32_FLOPS)
    for name in ("sparse_sweep", "sparse_thresholds", "sparse_accept"):
        b_ms, b_by = stats["bounds"][name]
        print(f"  {name} bound: {1e3 * b_ms:.1f} us ({b_by}) [{card}]")
    print(f"  K2 at [{ns}, 1024]: {k2_bytes / 1e6:.1f} MB, {k2_ops:.3e} "
          f"operations ({SPARSE_DRAW_OPS:.0f} per threshold: a quarter of a "
          f"Philox run's {PHILOX_RUN_OPS} and {THRESHOLD_OPS}, at the float32 "
          f"rate); "
          f"{us_k2:.1f} us is {100 * 1e3 * stats['bounds']['sparse_sweep'][0] / us_k2:.1f}% "
          f"of the bound's rate; at [{ns}, 128] the bound is {1e3 * b128:.1f} "
          f"us against {us_128:.1f} us [{card}]")
    b3 = stats["bounds"]["sparse_thresholds"][0]
    print(f"  K3 at [{ns}, 4096]: {4 * ns * 4096 / 1e6:.1f} MB written, "
          f"{ns * 4096 * SPARSE_DRAW_OPS:.3e} operations "
          f"({1e6 * ns * 4096 * SPARSE_DRAW_OPS / FP32_FLOPS:.1f} us); "
          f"{us_k3:.1f} us is {100 * 1e3 * b3 / us_k3:.1f}% of the bound's "
          f"rate [{card}]")
    print(f"  K4 over one sweep at [{ns}, 4096] int8: {k4_bytes / 1e6:.1f} MB, "
          f"{k4_ops:.3e} operations "
          f"({1e6 * k4_ops / FP32_FLOPS:.1f} us); if every gather went to "
          f"device memory {(k4_bytes + nnz * 4096) / 1e6:.1f} MB, "
          f"{1e6 * (k4_bytes + nnz * 4096) / HBM_BYTES_PER_S:.1f} us "
          f"(its time is in phase 5 (K4)) [{card}]")
    # library yardstick for K2's field work alone (never called by the
    # port's sweep): the CSR couplings times the [NS, 1024] spins
    us_mm = timed(lambda: torch.sparse.mm(eng._coupling, s), 20)
    print(f"  yardstick torch.sparse.mm(CSR [{ns}, {ns}], {nnz} non-zeros, s "
          f"[{ns}, 1024]): {us_mm:.1f} us per call (all fields of one spin "
          f"state at once, without colours or decisions) [{card}]")


# ---------------------------------------------------------------------------
# K4: the fused sparse accept, on the threshold path at R=4096
# ---------------------------------------------------------------------------

def accept_parity(torch, stats):
    """Phase 2 (K4): the gather mode against its plain version on +-J and
    on Gaussian couplings, the given-fields mode against its twin, and one
    K4-path sweep against one K3-path sweep and one K2 sweep under one
    seed."""
    import numpy as np

    from spinglass_tpu_torch.benchmarks.headline import sparse_bench_problem
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse as sp
    from spinglass_tpu_torch.kernels import sparse_cuda as sc

    gen = torch.Generator().manual_seed(29)
    ell = pm_j_ell(10000, 42)
    worst = 0.0

    def buffers(r):
        return [(torch.zeros(r, device="cuda"),
                 torch.zeros(r, dtype=torch.int32, device="cuda"))
                for _ in range(2)]

    # one draw of spins per R (the host generator's 41M numbers at R=4096
    # cost more than the sweeps); every combination starts from it
    start = {r: random_spins(gen, (r, ell.n_padded), ell.active_mask)
             for r in (128, 4096)}
    for prob, exact in ((ell, True), (sparse_bench_problem(), False)):
        for dtype in (torch.int8, torch.float32):
            for rule in ("metropolis", "glauber"):
                eng = sp.SortedSparseTEngine(prob, rule=rule, spin_dtype=dtype,
                                             accept_kernel="fused")
                k = eng.kernels
                for r in (128, 4096):
                    s_k = eng.to_layout(start[r])
                    s_p = s_k.clone()
                    beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).cuda()
                    # the kernel: a whole sweep, one launch per colour; the
                    # plain version colour by colour
                    _, de_k, c_k = k.accept_sweep(s_k, beta, 77 + r)
                    (de_p, c_p), _ = buffers(r)
                    for off, mc_, _ in eng.groups:
                        sc.accept_gather_reference(k.tables, s_p, off, mc_,
                                                   eng.mask_col, beta, 77 + r,
                                                   rule, de_p, c_p)
                    torch.cuda.synchronize()
                    err = float((de_k - de_p).abs().max())
                    if exact:
                        worst = max(worst, err)
                    de_ok = (torch.equal(de_k, de_p) if exact
                             else err <= 1e-5 * float(de_p.abs().max()))
                    if not (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                            and de_ok and s_k.dtype == dtype):
                        raise CheckFailed(
                            f"K4 gather mode != plain version: "
                            f"{'+-J' if exact else 'Gaussian'} {dtype} {rule} "
                            f"R={r}: {int((s_k != s_p).sum())} spins, "
                            f"{int((c_k != c_p).sum())} counts differ, "
                            f"max |dE - dE_plain| {err:.3e}")
    check(True, "K4 in gather mode, whole sweeps of the 10k graphs, int8 and "
                "float32 spins, both rules, R in {128, 4096}: on +-J spins, "
                "dE and counts bitwise equal to the slot-ordered plain "
                "version; on Gaussian couplings spins and counts bitwise, dE "
                "within 1e-5")
    for dtype, rule in ((torch.int8, "metropolis"), (torch.float32, "glauber")):
        eng = sp.SortedSparseTEngine(ell, rule=rule, spin_dtype=dtype,
                                     accept_kernel="fused")
        for r in (128, 4096, 130):
            s = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                           ell.active_mask))
            beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).cuda()
            for off, mc_, bs in eng.groups[:2]:
                f = sp._colour_fields(s, bs)
                s_k, s_p = s.clone(), s.clone()
                out = buffers(r)
                eng.kernels.accept(f, s_k, off, beta, 77 + off, *out[0])
                sc.accept_reference(f, s_p, off, eng.mask_col, beta,
                                    77 + off, rule, *out[1])
                torch.cuda.synchronize()
                worst = max(worst, float((out[0][0] - out[1][0]).abs().max()))
                if not (torch.equal(s_k, s_p)
                        and torch.equal(out[0][1], out[1][1])
                        and torch.equal(out[0][0], out[1][0])):
                    raise CheckFailed(
                        f"K4 on given fields != twin: {dtype} {rule} R={r} "
                        f"colour at {off}+{mc_}: {int((s_k != s_p).sum())} "
                        f"spins differ")
    check(True, "K4 on given fields, two colours of the 10k +-J graph, int8 / "
                "Metropolis and float32 / Glauber, R in {128, 4096, 130}: "
                "spins, dE, counts bitwise equal to accept_reference")
    stats["k4_max_abs_err"] = worst
    fused = sp.SortedSparseTEngine(ell, accept_kernel="fused")
    single = sp.SortedSparseTEngine(ell, accept_kernel="single")
    check(np.array_equal(fused.perm, single.perm),
          "the K4, K3 and K2 engines share one colour-sorted layout")
    for r in (1024, 130):  # 130: no multiple of 4, K3's and K4's scalar tails
        seed = 2 ** 63 + r
        s_rn = random_spins(gen, (r, ell.n_padded), ell.active_mask)
        beta = torch.linspace(0.05, 3.0, r, device="cuda")
        s4 = fused.to_layout(s_rn)
        s3, s2 = s4.float(), s4.float()
        _, de4, c4 = fused._sweep_fused(s4, beta, seed)
        th = single.kernels.thresholds(beta, seed, r)
        _, de3, c3 = sp.make_sorted_t_sweep(single.groups)(s3, th)
        _, de2, c2 = single.kernels.single_sweep(s2, beta, seed=seed)
        torch.cuda.synchronize()
        check(s4.dtype == torch.int8 and torch.equal(s4.float(), s3)
              and torch.equal(s3, s2) and torch.equal(c4, c3)
              and torch.equal(c3, c2) and torch.equal(de4, de3)
              and torch.equal(de3, de2),
              f"+-J 10k, [{fused.n_sorted}, {r}], one seed: K4 path (int8, "
              f"gather mode) == K3 path == K2, spins, dE and counts bitwise "
              f"(acceptance {float(c4.sum()) / (r * 1e4):.4f})")


# ---------------------------------------------------------------------------
# the replica overlap kernel and K4 on the 3-D +-J lattice (ea3d-l32.pt)
# ---------------------------------------------------------------------------
EA_L, EA_CHAINS, EA_SLOTS = 32, 4, 34   # the ea3d-l32 cell's lattice and PT


def _random_pm(torch, gen, shape, dtype):
    return (2 * torch.randint(0, 2, shape, generator=gen, device="cuda")
            - 1).to(dtype)


def _slots(torch, gen, c, t):
    return torch.cat([torch.randperm(t, generator=gen, device="cuda")
                      for _ in range(c)]).to(torch.int32)


def overlap_parity(torch, stats):
    """Phase 2 (overlap, K4 on the lattice): the overlap kernel against its
    plain twin at [32768, 136] (4 chains of 34 slots), int8 and float32,
    with every row real and with padding rows, and at other chain counts
    and slot blocks; K4 in gather mode over whole sweeps of the L=32 +-J
    lattice at R=136, both rules, against its plain version."""
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.core.topology import lattice_coo
    from spinglass_tpu_torch.kernels import overlap_cuda as oc
    from spinglass_tpu_torch.kernels import sparse as sp
    from spinglass_tpu_torch.kernels import sparse_cuda as sc

    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = [(32768, EA_CHAINS, EA_SLOTS, dtype, pad)
             for dtype in (torch.int8, torch.float32) for pad in (0, 1000)]
    # two chains over two slot blocks, three, and the most chains
    cases += [(5000, 2, 300, torch.int8, 77), (5000, 3, 34, torch.int8, 0),
              (5000, 8, 17, torch.float32, 77)]
    for ns, c, t, dtype, pad in cases:
        s = _random_pm(torch, gen, (ns, c * t), dtype)
        slot = _slots(torch, gen, c, t)
        mask = torch.zeros(ns, device="cuda")
        mask[ns - pad:] = -torch.inf
        op = oc.ReplicaOverlap(mask, c, ns - pad)
        l0 = build.launch_snapshot()
        got, again = op(s, slot), op(s, slot)
        want = oc.overlap_reference(s.cpu(), mask.cpu(), slot.cpu(), c,
                                    ns - pad)
        torch.cuda.synchronize()
        if not (got.shape == (t, c * (c - 1) // 2)
                and build.launches_since(l0, [oc.KERNEL]) == {oc.KERNEL: 2}
                and torch.equal(got.cpu(), want) and torch.equal(again, got)):
            raise CheckFailed(
                f"overlap kernel != twin at [{ns}, {c * t}], {c} chains, "
                f"{dtype}, {pad} padding rows: max |q - q_twin| "
                f"{float((got.cpu() - want).abs().max()):.3e}")
    stats["overlap_max_abs_err"] = 0.0
    check(True, "overlap kernel == its twin bit for bit (q, and a second "
                "launch on the zeroed scratch): [32768, 136] (4 chains of "
                "34) int8 and float32 with 0 and 1000 padding rows; [5000, "
                "600] 2 chains (two slot blocks), [5000, 102] 3, [5000, 136] "
                "8 chains")
    ell = sp.EllProblem.from_coo(*lattice_coo(EA_L, seed=20100602),
                                 device="cuda")
    r = EA_CHAINS * EA_SLOTS
    hgen = torch.Generator().manual_seed(32)
    start = random_spins(hgen, (r, ell.n_padded), ell.active_mask)
    for dtype in (torch.int8, torch.float32):
        for rule in ("glauber", "metropolis"):
            eng = sp.SortedSparseTEngine(ell, rule=rule, spin_dtype=dtype,
                                         accept_kernel="fused")
            k = eng.kernels
            s_k = eng.to_layout(start)
            s_p = s_k.clone()
            beta = (torch.rand(r, generator=hgen) * 1.5 + 0.1).cuda()
            for sweep in range(3):
                _, de_k, c_k = k.accept_sweep(s_k, beta, 91 + sweep)
                de_p = torch.zeros(r, device="cuda")
                c_p = torch.zeros(r, dtype=torch.int32, device="cuda")
                for off, mc_, _ in eng.groups:
                    sc.accept_gather_reference(k.tables, s_p, off, mc_,
                                               eng.mask_col, beta, 91 + sweep,
                                               rule, de_p, c_p)
                torch.cuda.synchronize()
                if not (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                        and torch.equal(de_k, de_p)):
                    raise CheckFailed(
                        f"K4 on the L={EA_L} lattice != plain version: "
                        f"{dtype} {rule} R={r} sweep {sweep}: "
                        f"{int((s_k != s_p).sum())} spins, "
                        f"{int((c_k != c_p).sum())} counts differ")
    check(eng.n_colors == 2 and [m for _, m, _ in eng.groups] == [16384] * 2,
          f"K4 in gather mode, 3 whole sweeps of the L={EA_L} +-J lattice "
          f"(2 colours of 16384 rows) at R={r}, int8 and float32, glauber "
          f"and metropolis: spins, dE and counts bitwise equal to the "
          f"slot-ordered plain version")


def overlap_timing(torch, stats, card):
    """Phase 5 (overlap): an ea3d-shaped pt.run (L=32, 4 chains of 34
    slots, heat bath, overlaps every super-step), its launches read from the
    ledger over the call: one overlap launch a super-step and two K4
    launches a sweep, the last q equal to the twin's on the final state;
    the kernel at [32768, 136] int8 as a graph against its plain version
    and its bound."""
    from spinglass_tpu_torch.anneal import graphs, pt
    from spinglass_tpu_torch.core.topology import lattice_coo
    from spinglass_tpu_torch.kernels import overlap_cuda as oc
    from spinglass_tpu_torch.kernels import sparse as sp

    ell = sp.EllProblem.from_coo(*lattice_coo(EA_L, seed=20100602),
                                 device="cuda")
    cfg = pt.PTConfig(n_replicas=EA_SLOTS, n_chains=EA_CHAINS,
                      ladder="linear", min_temp=0.703, max_temp=1.6,
                      update_rule="heat_bath", exchange_interval=10,
                      n_sweeps=1000, measure_overlaps=True)
    n_super = cfg.n_sweeps // cfg.exchange_interval
    pt.run(ell, cfg, generator=torch.Generator().manual_seed(1))  # capture
    _, engine, step = graphs.PT_CACHE.get(ell, ("run",
                                                graphs.config_key(cfg)))
    l0 = build.launch_snapshot()
    t0 = time.perf_counter()
    res = pt.run(ell, cfg, generator=torch.Generator().manual_seed(2))
    run_s = time.perf_counter() - t0
    n_op = build.launches_since(l0, [oc.KERNEL])[oc.KERNEL]
    kl = res.metadata["kernel_launches"]
    st = step.state
    want = oc.overlap_reference(st.spins.cpu(), engine.row_mask().cpu(),
                                st.slot.cpu(), EA_CHAINS, ell.n_spins)
    got = res.metadata["slot_overlap_history"][-1]
    check(engine.name == "sparse_sorted_t" and n_op == n_super
          and kl[oc.KERNEL] == n_super
          and kl["sparse_accept"] == 2 * cfg.n_sweeps
          and kl["sparse_sweep"] == 0 and kl["sparse_thresholds"] == 0
          and res.metadata["overlap_measurements"] == n_super
          and torch.equal(torch.as_tensor(got), want),
          f"pt.run at the ea3d-l32 shape ([{engine.n_sorted}, "
          f"{EA_CHAINS * EA_SLOTS}], heat bath, {cfg.n_sweeps} sweeps): "
          f"{n_op} overlap launches ({n_super} super-steps), "
          f"{kl['sparse_accept']} K4 launches (2 a sweep), no K2 or K3; the "
          f"last q == the twin's on the final state; {run_s:.3f} s a run")
    stats["overlap_launches"] = n_op
    gen = torch.Generator(device="cuda").manual_seed(33)
    ns, r = 32768, EA_CHAINS * EA_SLOTS
    s = _random_pm(torch, gen, (ns, r), torch.int8)
    slot = _slots(torch, gen, EA_CHAINS, EA_SLOTS)
    mask = torch.zeros(ns, device="cuda")
    timed = oc.ReplicaOverlap(mask, EA_CHAINS, ns)
    ms = _graph_ms(torch, lambda: timed(s, slot), 50)
    oc.overlap_reference(s, mask, slot, EA_CHAINS, ns)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        oc.overlap_reference(s, mask, slot, EA_CHAINS, ns)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 5
    pairs = EA_CHAINS * (EA_CHAINS - 1) // 2
    b = bound(1.0 * ns * r + 4.0 * r + 4.0 * EA_SLOTS * pairs, 0.0,
              FP32_FLOPS)
    stats["overlap"] = (ms, plain_ms) + b
    print(f"  overlap kernel at [{ns}, {r}] int8, as a graph: "
          f"{1e3 * ms:.2f} us (bound {1e3 * b[0]:.2f} us, {b[1]}: "
          f"{100 * b[0] / ms:.1f}% of it); plain version {plain_ms:.3f} ms "
          f"[{card}]")


# the SA driver's best tracking (sa_track) at the SA cells' shapes
TRACK_SHAPES = (("planted10k", 10240), ("sk4096", 4096))   # rows at R=1024


def _track_case(torch, layout, dtype, rows, r, share, seed):
    """A sweep's [R] state on the card with each replica improved with
    probability ``share`` (some of the others tied, the rest worse), and
    random spins and int8 best spins in ``layout``; n_spins is rows - rows
    // 33 (the rest padding)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (rows, r) if layout == "nr" else (r, rows)
    spins, best = (_random_pm(torch, g, shape, t)
                   for t in (dtype, torch.int8))
    energy = torch.randn(r, generator=g, device="cuda") * 1e4
    de = torch.randn(r, generator=g, device="cuda") * 30
    e = energy + de
    u = torch.rand(r, generator=g, device="cuda")
    step = torch.where(u < share, 0.5, torch.where(u < (1 + share) / 2, 0.0,
                                                    -0.5))
    cnt = torch.randint(0, rows, (r,), generator=g, device="cuda",
                        dtype=torch.int32)
    return energy, de, e + step, cnt, spins, best, layout, rows - rows // 33


def track_parity(torch, stats):
    """Phase 2 (sa_track): the best-tracking kernel against its twin on the
    same card tensors at [10240, 1024] and [4096, 1024] float32 and
    [32768, 136] int8 ("nr"), and at [64, 4096] float32 ("rn"), with a
    random share, all and none of the replicas improved: energies, best
    energies, acceptance rates, best spins (int8, in place) and copy counts
    bitwise."""
    from spinglass_tpu_torch.kernels import track_cuda as tc

    cases = [("nr", torch.float32, rows, 1024) for _, rows in TRACK_SHAPES]
    cases += [("nr", torch.int8, 32768, 136), ("rn", torch.float32, 4096, 64)]
    for k, (layout, dtype, rows, r) in enumerate(cases):
        for share in (0.22, 1.0, 0.0):
            args = _track_case(torch, layout, dtype, rows, r, share, 40 + k)
            want = tc.track_reference(*args)
            track = tc.BestTrack()
            l0 = build.launch_snapshot()
            got = track(*args)
            torch.cuda.synchronize()
            want = want[:2] + (want[2].to(torch.int8),) + want[3:]
            same = (got[2] is args[5] and build.launches_since(l0) == {tc.KERNEL: 1}
                    and all(torch.equal(a, b) for a, b in zip(got, want[:4]))
                    and torch.equal(track.copies, want[4].to(torch.int32)))
            if not same:
                raise CheckFailed(
                    f"sa_track != twin at {layout} {dtype} [{rows}, {r}], "
                    f"share {share}: "
                    + ", ".join(n for n, a, b in zip(
                        ("energy", "best_energy", "best_spins", "acc_rate"),
                        got, want) if not torch.equal(a, b)))
    check(True, "sa_track == its twin bit for bit (energy, best energy, "
                "acceptance, best spins in place, copies; one launch): nr "
                "float32 [10240, 1024], [4096, 1024], nr int8 [32768, 136], "
                "rn float32 [64, 4096]; shares 0.22, 1 and 0")


def track_timing(torch, stats, card):
    """Phase 5 (sa_track): 1000-sweep SA anneals at R=1024 on the 10k
    sparse bench graph (K2) and the SK glass (K1), a repeat call each:
    one sa_track launch a sweep, and their best_copy_share; then the kernel
    at each shape as a graph at that share (and at share 1) against its
    byte bound, its twin (the six ops) and torch.where over every spin
    alone, both on float32 best spins as the driver had them."""
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.kernels import track_cuda as tc

    cfg = sa.SAConfig(n_sweeps=1000, n_replicas=1024, enable_early_stop=False)
    problems = {"planted10k": headline.sparse_bench_problem(),
                "sk4096": sk_problem("cuda")}
    launches, shares = 0, {}
    for name, p in problems.items():
        sa.anneal(p, cfg)                           # captures
        res = sa.anneal(p, cfg, generator=torch.Generator().manual_seed(5))
        n = res.metadata["kernel_launches"]["sa_track"]
        launches += n
        shares[name] = res.metadata["best_copy_share"]
        check(n == res.n_sweeps == 1000 and 0 < shares[name] < 1,
              f"{name}-shaped SA (R=1024, 1000 sweeps, engine "
              f"{res.metadata['engine']}): sa_track {n} launches, "
              f"best_copy_share {shares[name]:.4f}, {res.total_time:.3f} s "
              f"[{card}]")
    stats["track_launches"] = launches
    r = 1024
    for k, (name, rows) in enumerate(TRACK_SHAPES):
        for share in (shares[name], 1.0):
            args = _track_case(torch, "nr", torch.float32, rows, r, share,
                               50 + k)
            track = tc.BestTrack()
            ms = _graph_ms(torch, lambda: track(*args), 50)
            # the twin and the torch.where as the driver ran them: best
            # spins in the spins' float32
            plain = args[:5] + (args[5].float(),) + args[6:]
            plain_ms = _graph_ms(torch, lambda: tc.track_reference(*plain), 50)
            imp = tc.track_reference(*plain)[4]
            where_ms = _graph_ms(torch, lambda: torch.where(
                imp[None, :], plain[4], plain[5]), 50)
            got = float(imp.float().mean())
            b = bound(36.0 * r + 5.0 * rows * r * got, 0.0, FP32_FLOPS)
            if k == 0 and share != 1.0:
                stats["track"] = (ms, plain_ms) + b
            print(f"  sa_track at [{rows}, {r}] float32, share {got:.4f}, as "
                  f"a graph: {1e3 * ms:.2f} us (bound {1e3 * b[0]:.2f} us, "
                  f"{b[1]}: {100 * b[0] / ms:.1f}% of it); twin (six ops) "
                  f"{1e3 * plain_ms:.2f} us; torch.where alone "
                  f"{1e3 * where_ms:.2f} us [{card}]")


# the time-to-target latch (pt_latch) on the TTT loop's own state
def _ttt_leaves(torch, seed):
    """The leaves of a fresh PT state of the TTT bench (the planted 10k
    instance, ttt_config's 128 replicas) on the card, as time_to_target's
    captured state holds them: nine tensors, spins and best spins
    [10240, 128] float32."""
    from spinglass_tpu_torch.anneal import graphs, pt
    from spinglass_tpu_torch.benchmarks import headline

    ell, _ = headline.ttt_instance()
    cfg = headline.ttt_config()
    _, _, engine = pt.make_pt_step(ell, cfg)
    state = graphs.distinct(graphs.device_counter(pt.init_state(
        ell, cfg, torch.Generator().manual_seed(seed), engine)))
    return graphs.leaves(state)


def latch_parity(torch, stats):
    """Phase 2 (pt_latch): the latch against its twin on the same card
    tensors, the TTT loop's nine state leaves at [10240, 128] float32, over
    a solve's three kinds of super-step: above the threshold (no copy), the
    hit (every leaf copied, the flag set) and one after the hit (below the
    threshold again, on other tensors: no copy); snapshot and flag bitwise,
    one launch each."""
    from spinglass_tpu_torch.kernels import latch_cuda as lc

    first, later = _ttt_leaves(torch, 1), _ttt_leaves(torch, 2)
    kernel, twin = lc.Latch(first), lc.Latch(first)
    for latch in (kernel, twin):
        latch.arm(-1000.0)
    l0 = build.launch_snapshot()
    for what, best, src, flag in (("no-op", -999.5, first, 0),
                                  ("hit", -1000.0, first, 1),
                                  ("after the hit", -2000.0, later, 1)):
        b = torch.tensor(best, dtype=torch.float32, device="cuda")
        kernel(b, src)
        lc.latch_reference(b, twin.threshold, twin.flag, src, twin.snapshot)
        torch.cuda.synchronize()
        bad = [k for k, (a, w) in enumerate(zip(kernel.snapshot,
                                                twin.snapshot))
               if not torch.equal(a, w)]
        if kernel.flag.tolist() != [flag, 0] or twin.flag.tolist() != \
                [flag, 0] or bad:
            raise CheckFailed(f"pt_latch != twin on the {what} step: flags "
                              f"{kernel.flag.tolist()} / "
                              f"{twin.flag.tolist()}, leaves {bad} differ")
    kept = all(torch.equal(a, w) for a, w in zip(kernel.snapshot, first))
    n = build.launches_since(l0, [lc.KERNEL])[lc.KERNEL]
    shapes = [tuple(t.shape) for t in first]
    check(kept and n == 3,
          f"pt_latch == its twin bit for bit on the TTT state's {len(first)} "
          f"leaves ({shapes[0]} {first[0].dtype} spins): no-op, hit and "
          f"after the hit (snapshot and flag); the snapshot holds the hit's "
          f"state; {n} launches (3)")


def latch_timing(torch, stats, card):
    """Phase 5 (pt_latch): the latch on the TTT state's leaves as a graph of
    100 launches, where it copies nothing (every super-step but the hit;
    bound 16 bytes read: best, threshold, flag) and on a hit (the flag
    cleared before each launch inside the graph; bound twice the state's
    bytes), against the twin (eager: its flag read waits on the card); the
    no-op latch at most 5 us."""
    from spinglass_tpu_torch.kernels import latch_cuda as lc

    src = _ttt_leaves(torch, 3)
    nbytes = float(sum(t.numel() * t.element_size() for t in src))
    best = torch.tensor(-1.0, dtype=torch.float32, device="cuda")
    latch, twin = lc.Latch(src), lc.Latch(src)

    def twin_call():
        lc.latch_reference(best, twin.threshold, twin.flag, src,
                           twin.snapshot)

    def hit():
        latch.flag.zero_()
        latch(best, src)

    def twin_hit():
        twin.flag.zero_()
        twin_call()

    latch.arm(-10.0)
    twin.arm(-10.0)
    ms = _graph_ms(torch, lambda: latch(best, src), 100)
    plain_ms = _event_ms(torch, twin_call, 50)
    b = bound(16.0, 0.0, FP32_FLOPS)
    latch.arm(0.0)
    twin.arm(0.0)
    hit_ms = _graph_ms(torch, hit, 100)
    hit_plain_ms = _event_ms(torch, twin_hit, 50)
    hb = bound(2.0 * nbytes, 0.0, FP32_FLOPS)
    stats["latch"] = (ms, plain_ms) + b
    print(f"  pt_latch on the TTT state ({nbytes / 1e6:.2f} MB in "
          f"{len(src)} leaves), as a graph: no copy {1e3 * ms:.3f} us (bound "
          f"{1e6 * b[0]:.4f} ns, {b[1]}); hit {1e3 * hit_ms:.2f} us with its "
          f"flag reset (bound {1e3 * hb[0]:.2f} us, {hb[1]}: "
          f"{100 * hb[0] / hit_ms:.1f}% of it); twin {1e3 * plain_ms:.2f} / "
          f"{1e3 * hit_plain_ms:.2f} us [{card}]")
    check(1e3 * ms <= 5.0, f"pt_latch with nothing to copy costs "
                           f"{1e3 * ms:.3f} us a super-step (<= 5 us)")
    check(all(torch.equal(a, w) for a, w in zip(latch.snapshot, src)),
          "the timed hits left the state in the snapshot")


def _pt_run(torch, ell, cfg, engine, gen_seed, n_super):
    """n_super super-steps of pt's step through ``engine`` from a fresh
    state; returns (state, seconds of the super-steps)."""
    from spinglass_tpu_torch.anneal import pt

    step, _, _ = pt.make_pt_step(ell, cfg, engine=engine)
    state = pt.init_state(ell, cfg, torch.Generator().manual_seed(gen_seed),
                          engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_super):
        state, _ = step(state)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def accept_slice(torch, stats):
    """Phase 4 (K4, K3): PT at R=4096 through make_pt_step with the fused
    engine, against the K3 path under the same generator seed; the fused
    path must compute no field outside K4. On the +-J 10k graph: K4 sums a
    field in slot order and the K3 path's plain gathers in torch.sum's, so
    on Gaussian couplings a last bit would part the two runs within 200
    sweeps (pt.run on the Gaussian instance is in the sparse slice)."""
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.kernels import sparse as sp

    ell = pm_j_ell(10000, 42)
    cfg = headline.pt_wide_config(n_sweeps=200)
    eng4 = headline.pt_wide_engine(ell, "fused")
    eng3 = headline.pt_wide_engine(ell, "threshold")
    gathers = {"fused": 0, "threshold": 0}
    plain_fields = sp._colour_fields
    out, launched = {}, {}
    try:
        for path, eng in (("fused", eng4), ("threshold", eng3)):
            def counted(*args, path=path):
                gathers[path] += 1
                return plain_fields(*args)

            sp._colour_fields = counted  # the plain per-colour gathers
            l0 = build.launch_snapshot()
            out[path] = _pt_run(torch, ell, cfg, eng, cfg.seed, 20)
            launched[path] = build.launches_since(l0, eng.kernel_names)
    finally:
        sp._colour_fields = plain_fields
    (a, sec4), (b, sec3) = out["fused"], out["threshold"]
    stats["k3_launches"] = launched["threshold"]["sparse_thresholds"]
    rel = float(((a.best_energy - b.best_energy).abs()
                 / b.best_energy.abs().clamp(min=1.0)).max())
    rel_e = float(((a.energy - b.energy).abs()
                   / b.energy.abs().clamp(min=1.0)).max())
    print(f"  PT R=4096, 200 sweeps: K4 path {sec4:.3f} s, K3 path "
          f"{sec3:.3f} s; best E/N {float(a.best_energy.min()) / ell.n_spins:.5f}")
    check(a.spins.dtype == torch.int8 and torch.equal(a.spins, b.spins)
          and torch.equal(a.slot, b.slot) and rel <= 1e-4 and rel_e <= 1e-4,
          f"make_pt_step(SortedSparseTEngine(accept_kernel='fused')), 32 "
          f"chains x 128, 200 sweeps == the K3 path under one seed: spins and "
          f"slots bitwise, energies within {max(rel, rel_e):.2e} <= 1e-4")
    l4, l3 = launched["fused"], launched["threshold"]
    n_col = len(eng4.groups)
    check(l4 == {"sparse_sweep": 0, "sparse_thresholds": 0,
                 "sparse_accept": 200 * n_col}
          and l3 == {"sparse_sweep": 0, "sparse_thresholds": 200,
                     "sparse_accept": 0}
          and gathers == {"fused": 0, "threshold": 200 * n_col},
          f"launches: K4 path {l4}, K3 path {l3}; plain per-colour field "
          f"gathers {gathers}: the fused sweep is one K4 launch per colour "
          f"and no gather outside it")


def accept_timing(torch, stats, card):
    """Phase 5 (K4): K4 in gather mode alone over one sweep's colours beside
    its plain version and K4 on given fields; PT at R=4096 three ways in
    turns with each way's device breakdown; PT at 16 replicas through K4
    and through the plain [R, N] engine."""
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse as sp
    from spinglass_tpu_torch.kernels import sparse_cuda as sc

    ell = headline.sparse_bench_problem()
    eng = headline.pt_wide_engine(ell, "fused")
    k = eng.kernels
    r = 4096
    gen = torch.Generator().manual_seed(3)
    s = eng.to_layout(random_spins(gen, (r, ell.n_padded), ell.active_mask))
    beta = torch.ones(r, device="cuda")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn, reps):
        fn()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / reps

    us_k4 = min(timed(lambda: k.accept_sweep(s, beta, 11), 20)
                for _ in range(3))
    de = torch.zeros(r, device="cuda")
    cnt = torch.zeros(r, dtype=torch.int32, device="cuda")

    def plain():
        for off, mc_, _ in eng.groups:
            sc.accept_gather_reference(k.tables, s, off, mc_, eng.mask_col,
                                       beta, 11, "metropolis", de, cnt)

    us_plain = timed(plain, 2)
    fields = [(off, sp._colour_fields(s, bs)) for off, _, bs in eng.groups]

    def given():
        for off, f in fields:
            k.accept(f, s, off, beta, 11, de, cnt)

    us_given = min(timed(given, 10) for _ in range(3))
    print(f"  K4 in gather mode over one sweep's {len(eng.groups)} colours at "
          f"[{eng.n_sorted}, {r}] int8: {us_k4:.1f} us; its plain version "
          f"{us_plain:.1f} us; K4 on given fields (precomputed) "
          f"{us_given:.1f} us [{card}]")
    stats.update(k4_ms=us_k4 / 1e3, k4_plain_ms=us_plain / 1e3)
    b = headline.bench_pt_wide(super_steps=5)
    for path, ms in b["value"].items():
        print(f"  PT R=4096 through the {path} path, 50 sweeps, in turns: "
              f"{ms[0]:.3f} / {ms[1]:.3f} ms/sweep [{card}]")
    for path in headline.PT_WIDE_PATHS:
        # the threshold path runs ~460 kernels a sweep: over 3 super-steps
        # (~14k kernel records) the profiler has lost ~9% of them (415.1
        # launches a sweep seen against 457.9), so it is profiled over one
        prof = headline.profile_pt_wide(
            path, super_steps=1 if path == "threshold" else 3)
        stats["profiles"][f"PT R=4096, {path} path"] = prof
        print(f"  profile PT R=4096, {path} path: {prof['us_per_sweep']:.1f} "
              f"us/sweep, kernels {prof['device_us_per_sweep']:.1f} us/sweep, "
              f"device busy {100 * prof['device_busy_share']:.1f}%, "
              f"{prof['launches_per_sweep']:.1f} kernel launches a sweep, "
              f"{prof['gather_launches_per_sweep']:.1f} of them PyTorch index "
              f"kernels; engine launches {prof['launches']} [{card}]")
        for kern in prof["kernels"][:4]:
            print(f"    {kern['us_per_sweep']:9.2f} us/sweep  {kern['calls']:5d} "
                  f"calls  {kern['name'][:80]}")
    b = headline.bench_pt16(super_steps=5)
    for label, ms in b["value"].items():
        print(f"  PT at 16 replicas (bench_pt10k's shape) through the {label} "
              f"engine ({b['extras']['engines'][label]}, launches "
              f"{b['extras']['launches'][label]}), in turns: "
              f"{ms[0]:.3f} / {ms[1]:.3f} ms/sweep [{card}]")


# ---------------------------------------------------------------------------
# The RL path: the annealer environment, PPO and its evaluation
# ---------------------------------------------------------------------------

RL_MODES = ("discrete", "continuous", "hybrid")
SMOKE_RL_UPDATES = 48   # bench_rl's updates here (its default is 512)
RL_EAGER_UPDATES = 16   # the eager updates the captured PPO run is held to
# the RL bench run must anneal: mean best energy per spin over the 256 envs
# after SMOKE_RL_UPDATES updates (episodes of 50 steps from a log-uniform start
# temperature, all at different stages). The first run on the H100 read
# -0.654 (-0.445 after the first update, whose 8 env steps are what a run
# that stops annealing keeps).
RL_E_PER_SPIN_MAX = -0.60


def _rl_actions(torch, mode, b, seed):
    """Fixed actions of one mode on the card; the sweep fractions leave some
    envs with a spent budget."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, 10, (b,), generator=g).cuda()
    frac = torch.linspace(0.05, 1.1, b).cuda()
    if mode == "discrete":
        return idx
    if mode == "continuous":
        return torch.stack([(torch.rand(b, generator=g) * 1.9 + 0.3).cuda(),
                            frac], dim=-1)
    return {"temp_index": idx, "sweep_frac": frac}


def rl_parity(torch, mc, stats):
    """Phase 2 (RL): env.step through make_engine's engine against the same
    step through the kernels' twins under one generator seed, in all three
    action modes with sweep fractions below 1 for some envs: the kernels
    write the spins in place, and the envs whose budget is spent must keep
    theirs."""
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine
    from spinglass_tpu_torch.anneal.twins import (TwinFusedEngine,
                                                  TwinSparseTEngine)
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine
    from spinglass_tpu_torch.rl import env

    dense = pm_j_problem(512, 13, "cuda")
    ell = pm_j_ell(10000, 42)
    launches = {}
    for problem, b, key, what in (
            (dense, 256, mc.KERNEL_NAME, "K1, +-J N=512, 256 envs"),
            (ell, 128, "sparse_sweep", "K2, +-J 10k graph, 128 envs"),
            (ell, 64, "sparse_accept", "K4, +-J 10k graph, 64 envs")):
        cfg0 = env.EnvConfig(n_envs=b)
        engine = env.default_engine(problem, cfg0)
        if problem is dense:
            twin = TwinFusedEngine(problem, block_size=cfg0.block_size)
            per_sweep = 1
            check(type(engine) is CudaFusedEngine,
                  "default_engine picks CudaFusedEngine for the dense env")
        else:
            twin = TwinSparseTEngine(problem)
            per_sweep = 1 if b == 128 else len(engine.groups)
            check(type(engine) is SortedSparseTEngine
                  and engine.state_dtype(b) == (torch.float32 if b == 128
                                                else torch.int8),
                  f"default_engine picks SortedSparseTEngine at {b} envs, "
                  f"state {engine.state_dtype(b)}")
        counts = [0, 0]   # the engine's launches of ``key``, the twin's
        for mode in RL_MODES:
            cfg = env.EnvConfig(n_envs=b, sweeps_per_step=10, max_steps=50,
                                action_mode=mode, init_temp_range=(0.1, 20.0))
            out = []
            for i, eng in enumerate((engine, twin)):
                gen = torch.Generator().manual_seed(31)
                l0 = build.launch_snapshot()
                state, _ = env.reset(problem, cfg, gen, eng)
                for t in range(2):
                    state, obs, reward, done = env.step(
                        problem, cfg, state, _rl_actions(torch, mode, b, t),
                        gen, eng)
                out.append((state, obs, reward, done))
                counts[i] += build.launches_since(l0, [key])[key]
            torch.cuda.synchronize()
            (a, *a_rest), (t_, *t_rest) = out
            fields = ("spins", "energy", "best_energy", "acc_rate", "temp",
                      "plateau")
            diff = [k for k in fields
                    if not torch.equal(getattr(a, k), getattr(t_, k))]
            diff += [k for k, x, y in zip(("obs", "reward", "done"), a_rest,
                                          t_rest) if not torch.equal(x, y)]
            if diff:
                raise CheckFailed(f"env.step through the kernel != through "
                                  f"the twin ({what}, {mode}): {diff} differ")
        launches[key] = counts[0]
        check(counts == [3 * 2 * 10 * per_sweep, 0],
              f"{what}: two env steps of 10 sweeps in each action mode, "
              f"kernel engine == twin engine bitwise in spins, energies, "
              f"counts (acc_rate), rewards, observations and done "
              f"({counts[0]} launches; acceptance of the last "
              f"step {float(a.acc_rate.mean()):.4f})")


def rl_slice(torch, mc, stats):
    """Phase 4 (RL): a rollout without host sync; ppo.train at the bench
    shape through bench_rl; the sparse env at 128 envs (K2) and 64 (K4); the
    geometric controller's evaluation rollout."""
    import math

    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.core.energy import energy
    from spinglass_tpu_torch.rl import env, evaluate, ppo

    problem, env_cfg, ppo_cfg = headline.rl_bench_setup(n_updates=1)
    init_fn, update_fn, _ = ppo.make_ppo(problem, env_cfg, ppo_cfg)
    state = init_fn()
    state, _, _ = update_fn.rollout(state)   # builds and warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, traj, _ = update_fn.rollout(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(traj["reward"].shape) == (8, 256),
          "a rollout of 8 env steps with auto_reset (N=512, 256 envs) runs "
          "under set_sync_debug_mode('error'): no host sync")

    b = headline.bench_rl(n_updates=SMOKE_RL_UPDATES)
    stats["bench_rl"] = b
    ex, out = b["extras"], b["train"]
    k1 = ex["kernel_launches"].get(mc.KERNEL_NAME, 0)
    want = SMOKE_RL_UPDATES * ppo_cfg.rollout_len * env_cfg.sweeps_per_step
    check(ex["engine"] == "cuda_fused" and k1 == want,
          f"bench_rl(n_updates={SMOKE_RL_UPDATES}) through ppo.train: K1 launched "
          f"{k1} times, expected updates x 8 x 10 = {want}")
    finite = all(math.isfinite(v) for h in out["history"] for v in h.values())
    check(finite and len(out["history"]) == SMOKE_RL_UPDATES,
          f"{SMOKE_RL_UPDATES} updates, every metric finite; last "
          f"{ {k: round(v, 4) for k, v in out['history'][-1].items()} }")
    st = out["state"].env_state
    exact = energy(problem, st.spins)
    rel = float(((st.energy - exact).abs() / exact.abs().clamp(min=1.0)).max())
    check(bool((st.best_energy <= st.energy).all()) and rel <= 1e-4,
          f"at the end best_energy <= energy in every env and energy == "
          f"energy(spins) (max rel err {rel:.2e} <= 1e-4)")
    e_n = ex["final_mean_best_energy"] / problem.n_spins
    first = out["history"][0]["mean_best_energy"] / problem.n_spins
    check(e_n <= RL_E_PER_SPIN_MAX,
          f"final mean best energy per spin {e_n:.5f} <= {RL_E_PER_SPIN_MAX} "
          f"(after the first update {first:.5f})")

    ell = headline.sparse_bench_problem()
    rl_launches = {mc.KERNEL_NAME: k1}
    for n_envs, key, path in ((128, "sparse_sweep", "K2"),
                              (64, "sparse_accept", "K4")):
        s_env = type(env_cfg)(n_envs=n_envs, sweeps_per_step=10, max_steps=50,
                              init_temp_range=(0.1, 20.0))
        s_ppo = ppo.PPOConfig(rollout_len=4, hidden_sizes=(128, 128), seed=42)
        l0 = build.launch_snapshot()
        init_fn, update_fn, _ = ppo.make_ppo(ell, s_env, s_ppo)
        eng = update_fn.engine
        state = init_fn()
        e0 = float(state.env_state.energy.mean())
        hist = []
        for _ in range(2):
            state, metrics = update_fn(state)
            hist.append(dict(zip(ppo.METRIC_KEYS, torch.stack(
                [metrics[k] for k in ppo.METRIC_KEYS]).tolist())))
        got = build.launches_since(l0, eng.kernel_names)
        # the eager reference of the captured run in captured_parity
        stats.setdefault("rl_sparse_eager", {})[n_envs] = (
            s_env, s_ppo, hist, state.params)
        best = float(metrics["mean_best_energy"])
        per_sweep = 1 if path == "K2" else len(eng.groups)
        others = [v for k, v in got.items() if k != key]
        rl_launches[key] = got[key]
        check(eng.name == "sparse_sorted_t"
              and got[key] == 2 * 4 * 10 * per_sweep
              and not any(others) and math.isfinite(best) and best < e0,
              f"make_ppo on the 10k bench graph, {n_envs} envs, 2 updates of "
              f"rollout 4: {path} launched {got[key]} times "
              f"(2 x 4 x 10 x {per_sweep}), no other sparse kernel; mean best "
              f"energy {best:.1f} below the reset energy {e0:.1f}")
    stats["rl_launches"] = rl_launches

    try:    # engine=None is the plain sweep: refused for a problem on the card
        env.reset(problem, env_cfg, torch.Generator().manual_seed(0))
        refused = False
    except ValueError:
        refused = True
    check(refused, "env.reset without an engine on a problem on the card "
                   "raises: the plain sweep is not reachable there")
    engine = env.default_engine(problem, env_cfg)
    policy = evaluate.make_geometric_policy(env_cfg, 0.05)
    l0 = build.launch_snapshot()
    best = evaluate.rollout_best_energy(problem, env_cfg, policy,
                                        torch.Generator().manual_seed(42),
                                        engine=engine)
    n = build.launches_since(l0, [mc.KERNEL_NAME])[mc.KERNEL_NAME]
    check(n == env_cfg.max_steps * env_cfg.sweeps_per_step
          and bool(torch.isfinite(best).all()),
          f"rollout_best_energy, the geometric controller at the bench shape: "
          f"K1 launched {n} times (max_steps x sweeps_per_step = "
          f"{env_cfg.max_steps * env_cfg.sweeps_per_step}), mean best energy "
          f"per spin {float(best.mean()) / problem.n_spins:.5f}")


def rl_timing(torch, stats, card):
    """Phase 5 (RL): bench_rl's env steps/s with its window rates (phase 4's
    run) and profile_rl's breakdown of one update."""
    from spinglass_tpu_torch.benchmarks import headline

    b = stats["bench_rl"]
    ex = b["extras"]
    rates = " / ".join(f"{r:.1f}" for r in ex["window_rates"])
    print(f"  bench_rl N={ex['n_spins']}, {ex['n_envs']} envs, "
          f"{ex['n_updates']} updates ({ex['n_warmup_excluded']} left out): "
          f"ppo_env_steps_per_sec {b['value']:.1f} (median of the windows "
          f"{rates}; mean steady rate {ex['mean_steady_rate']:.1f}) [{card}]")
    # what RL_E_PER_SPIN_MAX and SMOKE_RL_UPDATES were chosen from
    hist = b["train"]["history"]
    marks = sorted({0, len(hist) - 1, *range(7, len(hist), 8)})
    curve = ", ".join(f"{u + 1}: {hist[u]['mean_best_energy'] / ex['n_spins']:.4f}"
                      for u in marks)
    print(f"  mean best energy per spin after update {curve}")
    prof = headline.profile_rl()
    stats["profiles"]["PPO update (K1, N=512 x 256 envs)"] = prof
    steps = prof["env_steps"]
    print(f"  profile_rl (one PPO update = {steps} env steps of 256 envs + "
          f"the learning phase): {prof['us_per_env_step']:.1f} us per env "
          f"step, profiled {prof['profiled_us_per_env_step']:.1f}; kernels "
          f"{prof['device_us_per_env_step']:.1f} us per env step, device busy "
          f"{100 * prof['device_busy_share']:.1f}%, "
          f"{prof['launches_per_env_step']:.1f} kernel launches per env step, "
          f"K1's share of the device time "
          f"{100 * prof['sweep_kernel_share']:.1f}% [{card}]")
    print(f"  one update's wall time: rollout "
          f"{1e3 * prof['rollout_seconds']:.2f} ms, learning phase (GAE, 16 "
          f"minibatch steps) {1e3 * prof['learn_seconds']:.2f} ms [{card}]")
    for k in prof["kernels"]:
        print(f"    {k['us_per_env_step']:9.2f} us/env step  {k['calls']:5d} "
              f"calls  {k['name'][:76]}")


# ---------------------------------------------------------------------------
# The RL training path: the hybrid DQN, the pipeline, train-rl, the gym
# adapter and the captured evaluation
# ---------------------------------------------------------------------------

DQN_STEPS = 16   # the captured DQN run (k=8) against the eager loop


def _dqn_diff(torch, a, b) -> list:
    """The fields of two DQN states (Adam's moments and steps too) that are
    not equal bit for bit."""
    import dataclasses

    from spinglass_tpu_torch.anneal.graphs import leaves

    bad = [f.name for f in dataclasses.fields(a) if f.name != "opt"
           and not all(torch.equal(x, y) for x, y in zip(
               leaves(getattr(a, f.name)), leaves(getattr(b, f.name))))]
    for p, q in zip(a.params.values(), b.params.values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(a.opt.state[p][key], b.opt.state[q][key]):
                bad.append(f"adam {key}")
    return bad


def _rl_shapes(mc):
    """The RL bench's three paths on +-J instances: (problem, envs, kernel,
    label)."""
    dense = pm_j_problem(512, 13, "cuda")
    ell = pm_j_ell(10000, 42)
    return ((dense, 256, mc.KERNEL_NAME, "K1, +-J N=512, 256 envs"),
            (ell, 128, "sparse_sweep", "K2, +-J 10k graph, 128 envs"),
            (ell, 64, "sparse_accept", "K4, +-J 10k graph, 64 envs"))


def dqn_parity(torch, mc, stats):
    """Phase 2 (RL training): two act_and_learn steps of the hybrid DQN at
    its default widths (buffer 4096, batch 128, hidden (128, 128)) through
    make_engine's engine against the same steps through the kernels' twins
    under one generator seed, with and without PER: the whole DQN state
    (env, buffer, priorities, parameters, target network, Adam, counters)
    bit for bit."""
    from spinglass_tpu_torch.anneal.twins import (TwinFusedEngine,
                                                  TwinSparseTEngine)
    from spinglass_tpu_torch.rl import dqn, env

    for problem, b, key, what in _rl_shapes(mc):
        env_cfg = env.EnvConfig(n_envs=b, sweeps_per_step=10, max_steps=50,
                                init_temp_range=(0.1, 20.0))
        engine = env.default_engine(problem, env_cfg)
        twin = (TwinFusedEngine(problem, block_size=env_cfg.block_size)
                if key == mc.KERNEL_NAME else TwinSparseTEngine(problem))
        per_sweep = len(engine.groups) if key == "sparse_accept" else 1
        counts = [0, 0]   # the engine's launches of ``key``, the twin's
        for per in (False, True):
            cfg = dqn.DQNConfig(prioritized_replay=per, seed=42)
            states = []
            for i, eng in enumerate((engine, twin)):
                l0 = build.launch_snapshot()
                init_fn, step_fn, _ = dqn.make_dqn(problem, env_cfg, cfg,
                                                   engine=eng)
                st = init_fn(torch.Generator().manual_seed(7))
                for _ in range(2):
                    st, m = step_fn(st)
                states.append(st)
                counts[i] += build.launches_since(l0, [key])[key]
            torch.cuda.synchronize()
            diff = _dqn_diff(torch, *states)
            if diff:
                raise CheckFailed(f"DQN steps through the kernel != through "
                                  f"the twin ({what}, PER {per}): {diff}")
        check(counts == [2 * 2 * 10 * per_sweep, 0],
              f"{what}: two act_and_learn steps (without and with PER), "
              f"kernel engine == twin engine bitwise in the env state, the "
              f"buffer, the priorities, the parameters, the target network, "
              f"Adam and the counters ({counts[0]} launches; "
              f"last loss {float(m['loss']):.4f})")


def rl_training_slice(torch, mc, stats, card):
    """Phase 4 (RL training): the captured DQN step against the eager loop
    at N=512 x 256 envs (K1), without host sync, 10 K1 launches per env
    step; captured DQN runs on the 10k graph at 128 (K2) and 64 envs (K4);
    RLTrainingPipeline with the curriculum (DQN and PPO), checkpointed, PPO
    resumed == uninterrupted; `sgt-torch train-rl --agent dqn`; a gym
    episode on K1 at R=1 against K1's twin; the captured
    evaluate_controllers against the eager loop; a short learning_report."""
    import math
    import tempfile

    from click.testing import CliRunner

    from spinglass_tpu_torch import cli
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine
    from spinglass_tpu_torch.anneal.twins import TwinFusedEngine
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.rl import dqn, env, evaluate, ppo
    from spinglass_tpu_torch.rl import train as T
    from spinglass_tpu_torch.rl import gym_adapter
    from spinglass_tpu_torch.rl.gym_adapter import (SpinGlassEpisode,
                                                    SpinGlassGymEnv)

    launches = {}   # kernel -> launches of this part's main-path runs

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # 1. the captured DQN step (k=8) against the eager loop, both with PER
    # off and on, at the RL bench's shape with the DQN defaults
    problem, env_cfg, _ = headline.rl_bench_setup(n_updates=1)
    for per in (False, True):
        cfg = dqn.DQNConfig(prioritized_replay=per, steps_per_dispatch=8,
                            seed=42)
        init_fn, step_fn, _ = dqn.make_dqn(problem, env_cfg, cfg)
        l0 = build.launch_snapshot()
        cap = dqn.CapturedSteps(step_fn, init_fn(), 8)
        rows = []

        def replays():
            for _ in range(DQN_STEPS // 8):
                for _ in range(8):
                    cap.replay()
                rows.extend(cap.read(8))

        _sync_free(torch, f"captured DQN (PER {per}), {DQN_STEPS} steps in "
                          f"blocks of 8", replays)
        got = build.launches_since(l0, step_fn.engine.kernel_names)
        n1 = got[mc.KERNEL_NAME]
        add(got)
        init_e, step_e, _ = dqn.make_dqn(problem, env_cfg, cfg)
        st = init_e()
        want = []
        for _ in range(DQN_STEPS):
            st, m = step_e(st)
            want.append({k: float(m[k]) for k in dqn.METRIC_KEYS})
        diff = _dqn_diff(torch, cap.state, st)
        finite = all(math.isfinite(v) for r in rows for v in r.values())
        check(rows == want and not diff and finite
              and type(step_fn.engine) is CudaFusedEngine
              and n1 == DQN_STEPS * env_cfg.sweeps_per_step,
              f"the captured DQN step (PER {per}, k=8, {DQN_STEPS} steps at "
              f"N=512 x 256 envs) == the eager loop bit for bit (metrics, "
              f"env state, buffer, parameters, target network, Adam); K1 "
              f"launched {n1} times = 10 per env step; last "
              f"{ {k: round(v, 4) for k, v in rows[-1].items()} }")

    # 2. captured DQN runs on the 10k bench graph: K2 at 128 envs, K4 at 64
    ell = headline.sparse_bench_problem()
    for n_envs, key, path in ((128, "sparse_sweep", "K2"),
                              (64, "sparse_accept", "K4")):
        s_env = env.EnvConfig(n_envs=n_envs, sweeps_per_step=10, max_steps=50,
                              init_temp_range=(0.1, 20.0))
        init_fn, step_fn, _ = dqn.make_dqn(ell, s_env, dqn.DQNConfig(seed=42))
        l0 = build.launch_snapshot()
        cap = dqn.CapturedSteps(step_fn, init_fn(), 4)
        for _ in range(4):
            cap.replay()
        rows = cap.read(4)
        eng = step_fn.engine
        per_sweep = len(eng.groups) if path == "K4" else 1
        got = build.launches_since(l0, eng.kernel_names)
        others = [v for k, v in got.items() if k != key]
        add(got)
        check(got[key] == 4 * 10 * per_sweep and not any(others)
              and all(math.isfinite(v) for r in rows for v in r.values()),
              f"captured DQN on the 10k bench graph, {n_envs} envs, 4 steps: "
              f"{path} launched {got[key]} times (4 x 10 x "
              f"{per_sweep}), no other sparse kernel, every metric finite")

    # 3. the pipeline: the curriculum (32, 64, 128) on the card, train-rl's
    # 32 envs, DQN (k=2) and PPO, checkpointed
    tmp = tempfile.mkdtemp(prefix="rl_pipeline_")
    base = env.EnvConfig(n_envs=32)
    for agent in ("dqn", "ppo"):
        d = os.path.join(tmp, agent)
        pipe = T.RLTrainingPipeline(
            T.TrainingConfig(agent=agent, n_updates=6, curriculum=True,
                             checkpoint_interval=2, checkpoint_dir=d),
            base, dqn_cfg=dqn.DQNConfig(steps_per_dispatch=2, seed=1))
        out = pipe.train()
        files = sorted(os.listdir(d))
        check([(m["stage"], m["update"]) for m in out["metrics"]]
              == [(s, u) for s in range(3) for u in range(2)]
              and all(p.is_cuda for p in out["params"].values())
              and all(f"params_s{s}_u1.npz" in files for s in range(3))
              and ("train_state_s2.pt" in files) == (agent == "ppo"),
              f"RLTrainingPipeline({agent}, curriculum 32/64/128, 32 envs, 2 "
              f"updates per stage) on the card: {files}; "
              f"{out['env_steps_per_second']:.1f} env steps/s")
    # PPO resumed from the checkpoint of update 1 == uninterrupted (N=64)
    p64 = T.default_problem(64)
    ppo_cfg = ppo.PPOConfig(seed=3)

    def tcfg(d, n, resume=False):
        return T.TrainingConfig(n_updates=n, checkpoint_interval=2,
                                checkpoint_dir=d, seed=3, resume=resume)

    full = T.RLTrainingPipeline(tcfg(os.path.join(tmp, "a"), 4), base,
                                ppo_cfg, problem=p64).train()
    d = os.path.join(tmp, "b")
    T.RLTrainingPipeline(tcfg(d, 2), base, ppo_cfg, problem=p64).train()
    res = T.RLTrainingPipeline(tcfg(d, 4, True), base, ppo_cfg,
                               problem=p64).train()
    same = all(torch.equal(res["params"][k], v)
               for k, v in full["params"].items())
    check(res["metrics"] == full["metrics"][2:] and same,
          "the PPO pipeline (N=64, 32 envs) resumed from its checkpoint at "
          "update 1 == the uninterrupted 4 updates bit for bit (metrics of "
          "updates 2-3, parameters)")

    # 4. the command line, in process
    result = CliRunner().invoke(cli.main, ["train-rl", "--agent", "dqn",
                                           "--updates", "20"])
    check(result.exit_code == 0 and "env-steps/s:" in result.output,
          f"`sgt-torch train-rl --agent dqn --updates 20` on the card (N=64, "
          f"32 envs): exit {result.exit_code}, "
          f"{result.output.strip().splitlines()[-1]}")

    # 5. a gym episode on K1 at R=1 against K1's twin: through
    # SpinGlassGymEnv where gymnasium is installed, else through its episode
    # core SpinGlassEpisode (the reset and step the adapter runs)
    dense = pm_j_problem(512, 13, "cuda")
    g_cfg = env.EnvConfig(n_envs=1, sweeps_per_step=10, max_steps=20)
    adapter = SpinGlassGymEnv if gym_adapter.gymnasium else SpinGlassEpisode
    genv = adapter(dense, g_cfg)
    twin_env = adapter(dense, g_cfg, engine=TwinFusedEngine(
        dense, block_size=g_cfg.block_size))
    runs, got = [], []
    for e in (genv, twin_env):
        l0 = build.launch_snapshot()
        rows = [e.reset(seed=5)[0].tolist()]
        for t in range(g_cfg.max_steps):
            obs, r, term, trunc, info = e.step((3 * t) % 10)
            rows.append((obs.tolist(), r, term, trunc, info))
        runs.append(rows)
        got.append(build.launches_since(l0, e._engine.kernel_names))
    g_eng = genv._engine
    add(got[0])
    check(type(g_eng) is CudaFusedEngine and runs[0] == runs[1]
          and runs[0][-1][3]
          and got[0][mc.KERNEL_NAME] == 20 * 10,
          f"a gym episode ({adapter.__name__}, N=512, 20 steps) on K1 at "
          f"R=1 == the same episode "
          f"through K1's twin bit for bit, truncated at the budget, "
          f"{got[0][mc.KERNEL_NAME]} K1 launches; best energy "
          f"{runs[0][-1][4]['best_energy']:.1f}")

    # 6. the captured evaluate_controllers against the eager loop
    ev = headline.bench_evaluate(n_seeds=3)
    stats["bench_evaluate"] = ev
    check(ev["equal"], "evaluate_controllers (geometric, random; 3 seeds; "
                       "N=512 x 256 envs) through captured episodes == the "
                       "eager loop of their step, every seed, bit for bit")
    check(ev["rollout_equal"], "rollout_best_energy (geometric, N=512 x 256 "
                               "envs, its step captured anew per call) == "
                               "the eager loop of its episode, bit for bit")

    # 7. a short learning_report at the RL bench's width
    problem, env_cfg, _ = headline.rl_bench_setup(n_updates=1)
    engine = env.default_engine(problem, env_cfg)
    l0 = build.launch_snapshot()
    rep = evaluate.learning_report(
        problem, env_cfg, ppo.PPOConfig(n_updates=8, rollout_len=8, seed=42),
        n_seeds=2, engine=engine)
    got = build.launches_since(l0, engine.kernel_names)
    add(got)
    check(set(rep["per_seed"]) == {"trained_ppo", "geometric", "random"}
          and all(math.isfinite(v) for v in rep["mean_best_energy"].values())
          and rep["n_updates"] == 8
          and got[mc.KERNEL_NAME] == 8 * 8 * 10 + 3 * 2 * 50 * 10,
          f"learning_report (8 PPO updates, 2 seeds, N=512 x 256 envs): "
          f"mean best energy per spin "
          f"{ {k: round(v / 512, 4) for k, v in rep['mean_best_energy'].items()} }, "
          f"K1 launched {got[mc.KERNEL_NAME]} times")
    stats["rl_training_launches"] = launches
    for k, v in launches.items():
        stats["rl_launches"][k] = stats["rl_launches"].get(k, 0) + v
    print(f"  RL training path launches: {launches}")


def rl_training_timing(torch, stats, card):
    """Phase 5 (RL training): DQN env steps/s at N=512 x 256 envs with k=1
    and k=64 steps per read, profile_dqn's breakdown of one step and its act
    / learn split, and the captured evaluation against the eager loop."""
    from spinglass_tpu_torch.benchmarks import headline

    for k in (1, 64):
        b = headline.bench_dqn(n_steps=128 if k == 1 else 256, k=k)
        ex = b["extras"]
        check(ex["finite"], f"bench_dqn k={k}: every metric finite")
        print(f"  bench_dqn N={ex['n_spins']}, {ex['n_envs']} envs, "
              f"{ex['n_steps']} steps, k={k} per read: "
              f"dqn_env_steps_per_sec {b['value']:.1f} steady (the first "
              f"block left out), {ex['whole_call_rate']:.1f} over the whole "
              f"call (capture {ex['capture_seconds']:.3f} s); launches "
              f"{ex['kernel_launches']} [{card}]")
    prof = headline.profile_dqn()
    stats["profiles"]["DQN step (K1, N=512 x 256 envs)"] = prof
    print(f"  profile_dqn (one captured act_and_learn of 256 envs, batch "
          f"128): {prof['us_per_env_step']:.1f} us per env step, profiled "
          f"{prof['profiled_us_per_env_step']:.1f}; kernels "
          f"{prof['device_us_per_env_step']:.1f} us, device busy "
          f"{100 * prof['device_busy_share']:.1f}%, "
          f"{prof['launches_per_env_step']:.1f} kernel launches per env step, "
          f"K1's share of the device time "
          f"{100 * prof['sweep_kernel_share']:.1f}% [{card}]")
    print(f"  the eager step's wall time: act (decision, env.step, push, "
          f"auto_reset) {1e3 * prof['eager_act_seconds']:.2f} ms, learn "
          f"(sample, TD loss, backward, Adam, soft update) "
          f"{1e3 * prof['eager_learn_seconds']:.2f} ms [{card}]")
    for k in prof["kernels"]:
        print(f"    {k['us_per_env_step']:9.2f} us/env step  {k['calls']:5d} "
              f"calls  {k['name'][:76]}")
    ev = stats["bench_evaluate"]
    print(f"  evaluate_controllers (2 policies x 3 seeds x 50 steps, N=512 x "
          f"256 envs) eager "
          f"{' / '.join(f'{t:.3f}' for t in ev['eager_seconds'])} s, captured "
          f"{' / '.join(f'{t:.3f}' for t in ev['captured_seconds'])} s "
          f"(in turns) [{card}]")
    print(f"  one rollout_best_energy call (geometric, 50 steps, N=512 x 256 "
          f"envs, captured anew) eager "
          f"{' / '.join(f'{t:.3f}' for t in ev['rollout_eager_seconds'])} s, "
          f"captured "
          f"{' / '.join(f'{t:.3f}' for t in ev['rollout_captured_seconds'])}"
          f" s (in turns) [{card}]")


# ---------------------------------------------------------------------------
# The captured drivers (anneal/graphs.py) against the eager loop of their step
# ---------------------------------------------------------------------------

def _sync_free(torch, what, replays):
    """Runs ``replays`` (replays of a captured step and their reads) under
    set_sync_debug_mode('error')."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replays()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(True, f"{what}: replays and their reads run under "
                f"set_sync_debug_mode('error')")


def _same_result(np, a, b) -> bool:
    """Two AnnealResults of one run: every array and the launch counts."""
    return (all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
        "best_spins", "replica_best_energy", "energy_history",
        "mean_energy_history", "temperature_history", "acceptance_history"))
        and a.metadata["kernel_launches"] == b.metadata["kernel_launches"])


def captured_parity(torch, mc, stats):
    """Phase 4 (captured): each driver through its graph against the eager
    loop of its step under one seed, bit for bit; a repeat call on the same
    problem and config replays the cached graphs and gives the first call's
    result; no host sync inside a window of replays."""
    import dataclasses

    import numpy as np

    from spinglass_tpu_torch import anneal
    from spinglass_tpu_torch.anneal import graphs, pt, sa
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.rl import ppo

    def same_anneal(res, state, hist, engine, problem, what):
        best = int(torch.argmin(state.best_energy))
        row = engine.from_layout(state.best_spins)[best].cpu().numpy()
        ok = (np.array_equal(res.energy_history, hist[:, 0])
              and np.array_equal(res.mean_energy_history, hist[:, 1])
              and np.array_equal(res.temperature_history, hist[:, 2])
              and np.array_equal(res.acceptance_history, hist[:, 3])
              and np.array_equal(res.replica_best_energy,
                                 state.best_energy.cpu().numpy())
              and np.array_equal(res.best_spins, row[:problem.n_spins]))
        check(ok, f"{what}: anneal (captured chunks) == the eager run_chunk "
                  f"loop: best spins, best energies and the four histories "
                  f"bit for bit")

    def repeat(first, again, cache, what):
        check(_same_result(np, first, again) and cache.hits == hits + 1
              and again.metadata["capture_seconds"] == 0.0,
              f"{what}: a repeat call (same problem object and config) hits "
              f"the cache and gives the first call's result and launches bit "
              f"for bit; total_time {first.total_time:.4f} s first (its "
              f"capture {first.metadata['capture_seconds']:.4f} s included) "
              f"/ {again.total_time:.4f} s repeat")

    stats["captured"] = cap = {}
    read = graphs.HostRead()
    for kind, kernel, known in (("dense", mc.KERNEL_NAME, "-0.75696"),
                                ("sparse", "sparse_sweep", "-1.63106")):
        problem, cfg, first = stats[f"{kind}_first"]
        hits = graphs.SA_CACHE.hits
        res = anneal(problem, cfg)
        repeat(first, res, graphs.SA_CACHE, f"{kind} anneal")
        l0 = build.launch_snapshot()
        state, hist, eng = headline.eager_anneal(problem, cfg)
        n_eager = build.launches_since(l0, [kernel])[kernel]
        what = (f"{kind} {problem.n_spins} x {cfg.n_replicas}, "
                f"{cfg.n_sweeps} sweeps")
        same_anneal(res, state, hist, eng, problem, what)
        n = res.metadata["kernel_launches"].get(kernel, 0)
        e_n = res.best_energy / problem.n_spins
        cap[f"{kind}_e_n"] = e_n
        check(n == 500 and n_eager == 500 and f"{e_n:.5f}" == known,
              f"{kernel} launched {n} times through the replays and "
              f"{n_eager} in the eager loop (500 "
              f"each); E/N {e_n:.5f} (the known-good {known})")
        if kind == "dense":
            s_state, s_hist = sa.anneal_scan(problem, dataclasses.replace(
                cfg, enable_early_stop=False))
            check(torch.equal(s_state.spins, state.spins)
                  and torch.equal(s_state.best_energy, state.best_energy)
                  and torch.equal(s_state.best_spins, state.best_spins)
                  and all(np.array_equal(s_hist[k].cpu().numpy(),
                                         hist[:, i].astype(np.float32))
                          for i, k in enumerate(sa.STAT_KEYS))
                  and int(s_state.sweep) == 500,
                  "anneal_scan (10 replays, no read until the end) == the "
                  "eager loop: final spins, best spins and energies, the [10] "
                  "histories")
            del s_state
        _, steps = graphs.SA_CACHE.get(problem,
                                       ("anneal", graphs.config_key(cfg)))
        _sync_free(torch, f"{kind} SA chunk ({kernel})",
                   lambda: [read([steps[50].replay()]) for _ in range(3)])
        del state, eng

    ell = stats["sparse_first"][0]
    for label, pcfg in (
            ("PT at 16 replicas (bench_pt10k's), 1000 sweeps, K4",
             pt.PTConfig(n_replicas=16, seed=42)),
            ("PT at R=4096 (32 chains of 128), 200 sweeps, K4",
             stats["pt_wide_first"][0])):
        hits = graphs.PT_CACHE.hits
        res = pt.run(ell, pcfg)
        if pcfg.n_chains > 1:
            repeat(stats["pt_wide_first"][1], res, graphs.PT_CACHE, label)
        l0 = build.launch_snapshot()
        state, hist, eng = headline.eager_pt(ell, pcfg)
        n_eager = build.launches_since(l0, ["sparse_accept"])["sparse_accept"]
        rates = (state.exch_accepts.cpu().numpy()
                 / np.maximum(state.exch_attempts.cpu().numpy(), 1))
        best = int(torch.argmin(state.best_energy))
        row = eng.from_layout(state.best_spins)[best].cpu().numpy()
        _, _, step = graphs.PT_CACHE.get(ell, ("run", graphs.config_key(pcfg)))
        got = step.state
        ok = (all(torch.equal(getattr(got, f), getattr(state, f))
                  for f in ("spins", "slot", "energy", "best_energy",
                            "best_spins", "exch_attempts", "exch_accepts"))
              and np.array_equal(res.energy_history,
                                 hist["best_energy"].cpu().numpy())
              and np.array_equal(res.mean_energy_history,
                                 hist["cold_energy"].cpu().numpy())
              and np.array_equal(res.acceptance_history,
                                 hist["mean_acceptance"].cpu().numpy())
              and np.array_equal(res.metadata["slot_trajectory"],
                                 hist["slot_of_replica"].cpu().numpy())
              and np.array_equal(res.metadata["slot_energy_history"],
                                 hist["slot_energy"].cpu().numpy())
              and np.array_equal(res.metadata["exchange_rates"], rates)
              and np.array_equal(res.best_spins, row[:ell.n_spins]))
        n4 = res.metadata["kernel_launches"].get("sparse_accept", 0)
        check(ok and n4 == pcfg.n_sweeps * len(getattr(eng, "groups", ()))
              and n_eager == n4,
              f"{label}: pt.run == the eager loop: final spins, slots, "
              f"energies, exchange counts and the histories bit for bit; K4 "
              f"{n4} launches through the replays and in the eager loop")
        _sync_free(torch, f"{label}: the super-step",
                   lambda: [step.replay() for _ in range(2)])
        del state, got, step

    ttt = stats["ttt"]["extras"]
    tell, _ = headline.ttt_instance()
    tcfg = headline.ttt_config()
    super_step, _, eng = pt.make_pt_step(tell, tcfg)
    sweeps = []
    for seed in headline.TTT_SEEDS:
        st = pt.init_state(tell, tcfg, torch.Generator().manual_seed(seed),
                           eng)
        n, best = 0, float("inf")
        while best > ttt["threshold"] and n < 20000 // tcfg.exchange_interval:
            st, out = super_step(st)
            n += 1
            best = min(best, float(out["best_energy"]))
        sweeps.append(n * tcfg.exchange_interval)
    got = [r["sweeps"] for r in ttt["per_seed"]]
    cap["ttt_sweeps"] = got
    check(got == sweeps and ttt["all_hit"],
          f"time_to_target, seeds 42-44 (one captured super-step shared by "
          f"the seeds, a 4-byte read after each replay): sweeps {got} == the "
          f"eager loop's {sweeps}, all hit")

    def best_of(st):
        st, out = super_step(st)
        return st, out["best_energy"]

    step = pt.capture_super_step(best_of, pt.init_state(
        tell, tcfg, torch.Generator().manual_seed(42), eng))
    _sync_free(torch, "TTT super-step (K2 at 128 replicas) with its 4-byte "
                      "read", lambda: [read([step.replay()])
                                       for _ in range(3)])
    del step

    out = stats["bench_rl"]["train"]
    problem, env_cfg, ppo_cfg = headline.rl_bench_setup(
        n_updates=SMOKE_RL_UPDATES)
    init_fn, update_fn, _ = ppo.make_ppo(problem, env_cfg, ppo_cfg)
    state = init_fn()
    hist = []
    for _ in range(RL_EAGER_UPDATES):
        state, m = update_fn(state)
        hist.append(dict(zip(ppo.METRIC_KEYS, torch.stack(
            [m[k] for k in ppo.METRIC_KEYS]).tolist())))
    e_n = out["history"][-1]["mean_best_energy"] / problem.n_spins
    cap["rl_e_n"] = e_n
    check(out["history"][:RL_EAGER_UPDATES] == hist
          and e_n <= RL_E_PER_SPIN_MAX,
          f"ppo.train (bench_rl's run: {SMOKE_RL_UPDATES} captured updates, "
          f"capturable Adam): its first {RL_EAGER_UPDATES} updates' history == "
          f"{RL_EAGER_UPDATES} eager updates' bit for bit; final E/N "
          f"{e_n:.5f} <= {RL_E_PER_SPIN_MAX}")
    k8 = ppo.train(problem, env_cfg, dataclasses.replace(
        ppo_cfg, n_updates=RL_EAGER_UPDATES, updates_per_dispatch=8))
    check(k8["history"] == hist
          and all(torch.equal(k8["params"][k], p)
                  for k, p in state.params.items()),
          f"updates_per_dispatch=8 ({RL_EAGER_UPDATES // 8} dispatches of 8 "
          f"replays, one read each) == {RL_EAGER_UPDATES} eager updates: "
          f"parameters and history bit for bit")
    cap_u = ppo.CapturedUpdates(update_fn, init_fn())
    _sync_free(torch, "PPO update (K1, N=512 x 256 envs) with its metrics "
                      "read", lambda: [(cap_u.replay(), cap_u.read(1))
                                       for _ in range(2)])
    del cap_u
    for n_envs, key in ((128, "sparse_sweep"), (64, "sparse_accept")):
        s_env, s_ppo, hist, params = stats["rl_sparse_eager"][n_envs]
        t = ppo.train(ell, s_env, dataclasses.replace(s_ppo, n_updates=2))
        check(t["history"] == hist
              and all(torch.equal(t["params"][k], p)
                      for k, p in params.items())
              and t["kernel_launches"].get(key, 0) > 0,
              f"PPO on the 10k bench graph, {n_envs} envs ({key}), 2 "
              f"captured updates == 2 eager updates: parameters and history "
              f"bit for bit; launches {t['kernel_launches']}")


def _energy_check(torch, template, binary, sol, what):
    """The solution's energy (the run's best_energy) against the energy of
    the best spins, rebuilt from the decoded binary variables (x = (1+s)/2
    of every logical spin), within 1e-4 relative."""
    import numpy as np

    from spinglass_tpu_torch.core.energy import energy

    p = template.problem
    spins = np.where(np.asarray(binary).ravel() > 0, 1.0, -1.0)
    s = torch.ones(p.n_padded, device="cuda")
    s[:p.n_spins] = torch.as_tensor(spins, dtype=torch.float32, device="cuda")
    e = float(energy(p, s))
    rel = abs(e - sol.energy) / max(abs(e), 1.0)
    check(rel <= 1e-4 and np.isfinite(sol.energy),
          f"{what}: best_energy {sol.energy:.4f} == energy(best_spins) "
          f"{e:.4f} (rel {rel:.2e} <= 1e-4)")


def _sparse_twin_check(torch, problem) -> dict:
    """K4 (R=32) and K2 (R=1024) against their twins on an encoded sparse
    MaxCut with unit weights (every field exact): from random spins at
    betas across [0.05, 3], three Philox sweeps of the engine make_engine
    builds against ``TwinSparseTEngine`` under one generator seed, and for K2
    two host-threshold sweeps against its plain version on the same
    thresholds (K4 draws its own). Spins, dE and counts must be equal bit for
    bit. Returns each kernel's largest difference seen (0)."""
    import numpy as np

    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.anneal.twins import TwinSparseTEngine
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels.sparse import accept_threshold

    worst = {}
    for r, kernel, n_host in ((32, "sparse_accept", 0),
                              (1024, "sparse_sweep", 2)):
        eng = make_engine(problem, r_hint=r)
        twin = TwinSparseTEngine(problem)
        gen = torch.Generator().manual_seed(r)
        s = eng.to_layout(random_spins(gen, (r, problem.n_padded),
                                       problem.active_mask))
        s_ref = s.clone()
        beta = torch.as_tensor(np.random.default_rng(r).uniform(0.05, 3.0, r),
                               dtype=torch.float32, device="cuda")
        before = build.launch_snapshot()
        same, flips, err, twin_n = True, 0, 0.0, 0
        g_k, g_t = (torch.Generator().manual_seed(7 + r) for _ in range(2))
        for k in range(3 + n_host):
            if k < 3:
                _, de, cnt = eng.sweep(s, beta, g_k)
                t0 = build.launch_snapshot()
                _, de_p, cnt_p = twin.sweep(s_ref, beta, g_t)
                twin_n += sum(build.launches_since(t0).values())
            else:
                u = torch.rand(eng.n_sorted, r, device="cuda")
                _, de, cnt = eng.sweep_with_uniforms(s, beta, u)
                th = accept_threshold(u, beta[None, :], eng.rule)
                th = torch.where(eng.mask_col < 0,
                                 torch.full_like(th, -torch.inf), th)
                _, de_p, cnt_p = sc.single_sweep_reference(eng.groups, s_ref,
                                                           th)
            same &= (torch.equal(s, s_ref) and torch.equal(de, de_p)
                     and torch.equal(cnt, cnt_p))
            err = max(err, float((s.float() - s_ref.float()).abs().max()),
                      float((de - de_p).abs().max()))
            flips += int(cnt.sum())
        worst[kernel] = err
        per = len(eng.groups) if kernel == "sparse_accept" else 1
        got = build.launches_since(before, eng.kernel_names)
        check(same and flips > 0 and got[kernel] == (3 + n_host) * per
              and sum(got.values()) == got[kernel] and twin_n == 0,
              f"encoded sparse MaxCut ({problem.n_spins} nodes, {s.dtype} "
              f"spins), R={r}: {kernel} == twin bit for bit in spins, dE and "
              f"counts over 3 Philox"
              + (f" + {n_host} host-threshold" if n_host else "")
              + f" sweeps; {flips} flips, launches {got}")
    return worst


def problems_slice(torch, mc, stats, card):
    """Phase 4 (problems): the problem path, encoder -> make_engine -> K1 /
    K2 / K4 -> decode, through ProblemTemplate.solve and the command line."""
    import dataclasses

    import numpy as np
    from click.testing import CliRunner

    from spinglass_tpu_torch import cli
    from spinglass_tpu_torch.anneal import graphs, pt, sa
    from spinglass_tpu_torch.anneal.engines import ColoredEngine
    from spinglass_tpu_torch.benchmarks.exact_instances import (
        bipartite_weights, grid_tsp)
    from spinglass_tpu_torch.problems import MaxCutProblem, TSPProblem

    launches = {}   # kernel -> launches of this phase's runs

    def count(meta):
        for k, v in meta["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v

    # 1. K1 against its twin on the dyadic encoded TSP, bitwise
    worst = 0.0
    for n_cities, rs in ((10, (1, 32, 37)), (15, (1, 32, 37)),
                         (19, (1, 32, 37)), (64, (32, 1024))):
        _, p = grid_tsp(n_cities, device="cuda")
        fused = mc.FusedSweep(p, block_size=SA_BLOCK)
        for r in rs:
            rng = np.random.default_rng(r)
            s = torch.as_tensor(np.where(rng.random((p.n_padded, r)) < 0.5,
                                         -1.0, 1.0), dtype=torch.float32,
                                device="cuda")
            s[p.n_spins:] = 1.0
            beta = torch.as_tensor(rng.uniform(0.005, 0.2, r),
                                   dtype=torch.float32, device="cuda")
            flips, same = 0, True
            for k in range(4):   # two host-uniform and two Philox sweeps
                s_ref = s.clone()
                if k < 2:
                    u = torch.rand(p.n_padded, r, device="cuda")
                    _, de, cnt = fused.sweep_with_uniforms(s, beta, u)
                else:
                    _, de, cnt = fused(s, beta, 77 + k)
                    u = mc.philox_uniforms(77 + k, p.n_padded, r,
                                           device="cuda")
                _, de_p, cnt_p = mc.fused_sweep_reference(
                    p.j, p.h, p.active_mask, s_ref, beta, u, "metropolis",
                    SA_BLOCK)
                same &= (torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
                         and torch.equal(de, de_p))
                worst = max(worst, float((s - s_ref).abs().max()),
                            float((de - de_p).abs().max()))
                flips += int(cnt.sum())
            check(same and flips > 0,
                  f"K1 == twin bitwise on the integer-grid TSP-{n_cities} "
                  f"(Np={p.n_padded}, R={r}): 2 host-uniform + 2 Philox "
                  f"sweeps, {flips} flips")
    stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0), worst)

    # 2. TSP-64 (examples/tsp_example.py's seed) at full width, SA
    t0 = time.perf_counter()
    tsp = TSPProblem(device="cuda")
    tsp.generate_random_instance(n_cities=64, seed=7)
    tsp.encode_to_ising()
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    cfg = sa.SAConfig(n_sweeps=2000, n_replicas=1024)
    t0 = time.perf_counter()
    engine = sa.make_sweep_engine(tsp.problem, cfg)
    t_engine = time.perf_counter() - t0
    check(engine.name == "cuda_fused" and tsp.problem.n_padded == 4096,
          f"TSP-64 (4096 spins): make_engine picked {engine.name} "
          f"(CudaFusedEngine)")
    del engine
    sol = tsp.solve(cfg)
    meta = sol.metadata["anneal"]
    count(meta)
    n_k1 = meta["kernel_launches"].get(mc.KERNEL_NAME, 0)
    check(meta["engine"] == "cuda_fused" and n_k1 == meta["n_sweeps"] > 0,
          f"TSP-64 solve: K1 launched {n_k1} times for {meta['n_sweeps']} "
          f"sweeps done (one per sweep)")
    check(tsp.validate_tour(sol.variables["tour"]),
          "the decoded tour is a permutation of the 64 cities")
    _energy_check(torch, tsp, sol.variables["assignment"], sol, "TSP-64")
    print(f"  TSP-64: {meta['engine']}, launches {meta['kernel_launches']}; "
          f"tour length {sol.objective_value:.4f}, clean_decode "
          f"{sol.metadata['clean_decode']}, best energy {sol.energy:.4f}; "
          f"encode {t_encode:.3f} s, engine choice {t_engine:.3f} s, solve "
          f"{sol.metadata['solve_time']:.3f} s (anneal total_time "
          f"{meta['total_time']:.3f} s: capture "
          f"{meta['capture_seconds']:.3f} s, {meta['n_sweeps']} sweeps "
          f"{meta['total_time'] - meta['capture_seconds']:.3f} s) [{card}]")

    # 3. known optimum at full width: bipartite MaxCut, dense through K1
    w = bipartite_weights(4096, 2048 * 2048 // 2, 11)
    total = 0.5 * w.sum()
    t0 = time.perf_counter()
    dense = MaxCutProblem(weights=w, device="cuda")
    dense.encode_to_ising()
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = sa.make_sweep_engine(dense.problem, sa.SAConfig(n_replicas=1024))
    t_engine = time.perf_counter() - t0
    check(isinstance(auto, ColoredEngine),
          f'bipartite MaxCut-4096: "auto" picks {auto.name} ({auto.n_colors} '
          f'colours, plain PyTorch): the case runs sweep_method="blocked"')
    del auto
    cfg = sa.SAConfig(n_sweeps=2000, n_replicas=1024, sweep_method="blocked")
    sol = dense.solve(cfg)
    meta = sol.metadata["anneal"]
    count(meta)
    n_k1 = meta["kernel_launches"].get(mc.KERNEL_NAME, 0)
    check(meta["engine"] == "cuda_fused" and n_k1 == meta["n_sweeps"],
          f"dense MaxCut: CudaFusedEngine, K1 launched {n_k1} times for "
          f"{meta['n_sweeps']} sweeps")
    _energy_check(torch, dense, sol.variables["partition"], sol,
                  "dense MaxCut")
    cut = sol.variables["cut_value"]
    check(cut == total, f"dense bipartite MaxCut-4096 (density 0.5 across "
                        f"the halves): cut {cut:.1f} == total weight "
                        f"{total:.1f}")
    print(f"  dense MaxCut: {meta['engine']}, launches "
          f"{meta['kernel_launches']}; encode {t_encode:.3f} s, auto engine "
          f"choice "
          f"{t_engine:.3f} s, solve {sol.metadata['solve_time']:.3f} s "
          f"({meta['sweeps_per_second']:.1f} sweeps/s) [{card}]")
    del dense, w

    # 3b. sparse at G-set G55's scale: 5000 nodes, 12498 unit edges
    w = bipartite_weights(5000, 12498, 55)
    total = 0.5 * w.sum()
    t0 = time.perf_counter()
    sparse = MaxCutProblem(weights=w, device="cuda")
    sparse.encode_to_ising()
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    for name, err in _sparse_twin_check(torch, sparse.problem).items():
        key = {"sparse_sweep": "k2", "sparse_accept": "k4"}[name]
        stats[f"{key}_max_abs_err"] = max(stats[f"{key}_max_abs_err"], err)
    for r, kernel in ((32, "sparse_accept"), (1024, "sparse_sweep")):
        cfg = sa.SAConfig(n_sweeps=2000, n_replicas=r)
        t0 = time.perf_counter()
        engine = sa.make_sweep_engine(sparse.problem, cfg)
        t_engine = time.perf_counter() - t0
        n_col = len(engine.groups)
        per = n_col if kernel == "sparse_accept" else 1
        check(engine.name == "sparse_sorted_t",
              f"sparse MaxCut-5000, R={r}: make_engine picked {engine.name} "
              f"(SortedSparseTEngine, {len(engine.groups)} colours)")
        del engine
        sol = sparse.solve(cfg)
        meta = sol.metadata["anneal"]
        count(meta)
        got = meta["kernel_launches"]
        check(got.get(kernel, 0) == per * meta["n_sweeps"]
              and got.get("sa_track") == meta["n_sweeps"]
              and sum(got.values()) == got[kernel] + got["sa_track"],
              f"sparse MaxCut SA R={r}: {kernel} launched {got.get(kernel)} "
              f"times = {per} x {meta['n_sweeps']} sweeps, sa_track once a "
              f"sweep, no other kernel ({got})")
        _energy_check(torch, sparse, sol.variables["partition"], sol,
                      f"sparse MaxCut SA R={r}")
        cut = sol.variables["cut_value"]
        check(cut >= 0.999 * total,
              f"sparse MaxCut SA R={r}: cut {cut:.1f} of {total:.1f}, gap "
              f"{total - cut:.1f} ({100 * (total - cut) / total:.4f}%; gate "
              f"99.9%)")
        print(f"  sparse MaxCut SA R={r}: {meta['engine']}, launches {got}; "
              f"encode {t_encode:.3f} s, engine "
              f"choice {t_engine:.3f} s, solve "
              f"{sol.metadata['solve_time']:.3f} s "
              f"({meta['sweeps_per_second']:.1f} sweeps/s) [{card}]")

    # 4. PT through the command line's path: pt.run as the annealer, K4
    cfg = pt.PTConfig(n_replicas=32, n_sweeps=2000)
    sol = sparse.solve(cfg, annealer=pt.run)
    meta = sol.metadata["anneal"]
    count(meta)
    got = meta["kernel_launches"]
    check(got.get("sparse_accept", 0) == n_col * meta["n_sweeps"]
          and sum(got.values()) == got["sparse_accept"],
          f"sparse MaxCut PT R=32: K4 launched {got.get('sparse_accept')} "
          f"times = {n_col} x {meta['n_sweeps']} sweeps ({got})")
    _energy_check(torch, sparse, sol.variables["partition"], sol,
                  "sparse MaxCut PT R=32")
    cut = sol.variables["cut_value"]
    check(cut >= 0.999 * total,
          f"sparse MaxCut PT R=32: cut {cut:.1f} of {total:.1f}, gap "
          f"{total - cut:.1f}")
    print(f"  sparse MaxCut PT R=32: {meta['engine']}, launches {got}; solve "
          f"{sol.metadata['solve_time']:.3f} s [{card}]")
    del sparse, w

    # 5. the seed out of the cache key: trials share one capture and each
    # equals a fresh call with its seed
    graphs.clear_caches()
    tsp20 = TSPProblem(device="cuda")
    tsp20.generate_random_instance(n_cities=20, seed=42)
    tsp20.encode_to_ising()
    cfg = sa.SAConfig(n_sweeps=200, n_replicas=32, seed=42)
    hits = graphs.SA_CACHE.hits
    bench = tsp20.benchmark_instance(cfg, n_trials=5)
    hits = graphs.SA_CACHE.hits - hits
    check(len(graphs.SA_CACHE) == 1 and hits == 4,
          f"benchmark_instance(n_trials=5): {len(graphs.SA_CACHE)} cache "
          f"entry, {hits} hits (one capture for the five seeds)")
    trials = [sa.anneal(tsp20.problem, dataclasses.replace(cfg, seed=42 + t))
              for t in range(5)]
    same = True
    for t, res in enumerate(trials):
        count(res.metadata)
        graphs.clear_caches()
        fresh = sa.anneal(tsp20.problem, dataclasses.replace(cfg, seed=42 + t))
        count(fresh.metadata)
        same &= (np.array_equal(res.best_spins, fresh.best_spins)
                 and np.array_equal(res.energy_history, fresh.energy_history)
                 and np.array_equal(res.replica_best_energy,
                                    fresh.replica_best_energy))
    check(same, "each of the 5 trials (cached capture) == a fresh call with "
                "its seed after graphs.clear_caches(), bit for bit")
    print(f"  benchmark_instance TSP-20: best {bench['best_objective']:.4f}, "
          f"mean {bench['mean_objective']:.4f}, mean time "
          f"{bench['mean_time']:.3f} s [{card}]")

    # 6. the README's quick start through the console script's entry; its
    # launches are read from the ledger, for the kernels of the engine it
    # left in the cache
    graphs.clear_caches()
    l0 = build.launch_snapshot()
    t0 = time.perf_counter()
    out = CliRunner().invoke(cli.main, ["solve", "-p", "tsp", "-s", "20",
                                        "--sweeps", "2000"])
    wall = time.perf_counter() - t0
    print("  " + out.output.replace("\n", "\n  ").rstrip())
    engines = [entry[0] for entry in graphs.SA_CACHE.values()]
    cli_launches = (build.launches_since(l0, sa.step_kernels(engines[0]))
                    if len(engines) == 1 else {})
    check(out.exit_code == 0 and "objective:" in out.output
          and "energy:" in out.output and "feasible:" in out.output,
          f"sgt-torch solve -p tsp -s 20 --sweeps 2000 exits "
          f"{out.exit_code} on the card ({wall:.3f} s) [{card}]")
    check(len(engines) == 1 and engines[0].name == "cuda_fused"
          and cli_launches.get(mc.KERNEL_NAME, 0) > 0
          and cli_launches.get("sa_track") == cli_launches[mc.KERNEL_NAME]
          and sum(cli_launches.values()) == 2 * cli_launches[mc.KERNEL_NAME],
          f"the command's run swept through K1 alone (and sa_track once a "
          f"sweep): engine "
          f"{[e.name for e in engines]}, launches {cli_launches}")
    for k, v in cli_launches.items():
        launches[k] = launches.get(k, 0) + v
    stats["problem_launches"] = launches
    print(f"  problem path launches: {launches}")


def captured_timing(torch, stats, card):
    """Phase 5 (captured): each captured driver against the eager loop of
    its step in turns, and whole driver calls three ways
    (headline.captured_vs_plain); the captured paths' busy shares and graph
    launches, and their kernels per name by the profiler against the
    launch ledger (the profiles of the phases above)."""
    from spinglass_tpu_torch.benchmarks import headline

    b = headline.captured_vs_plain()
    for label, turns in b["value"].items():
        ways = ", ".join(f"{way} {t[0]:.4f} / {t[1]:.4f}"
                         for way, t in turns.items())
        print(f"  {label}: {ways} (in turns) [{card}]")
    for name, prof in stats["profiles"].items():
        # the kernels a replayed graph ran, counted by the profiler, against
        # what the launch ledger counted over the same replays
        lc = prof["launch_check"]
        check(lc and all(c["counter"] == c["profiler"] for c in lc.values())
              and any(c["counter"] > 0 for c in lc.values()),
              f"profile {name}: launches per kernel over the profiled replays, "
              f"counter == profiler: "
              + ", ".join(f"{k} {c['counter']} == {c['profiler']}"
                          for k, c in lc.items() if c["counter"]
                          or c["profiler"]))
        unit = "env step" if "us_per_env_step" in prof else "sweep"
        key = unit.replace(" ", "_")
        print(f"  captured {name}: {prof[f'us_per_{key}']:.1f} us/{unit}, "
              f"kernels {prof[f'device_us_per_{key}']:.1f} us/{unit}, device "
              f"busy {100 * prof['device_busy_share']:.1f}%, "
              f"{prof[f'graph_launches_per_{key}']:.3f} graph launches and "
              f"{prof[f'launches_per_{key}']:.1f} kernels per {unit} [{card}]")


# ---------------------------------------------------------------------------
# The drivers' remaining paths: checkpoint/resume, Swendsen-Wang cluster
# moves through C1, the tuned ladder, the compact engine, the command line
# ---------------------------------------------------------------------------

def _sw_spins(torch, sw, r: int, seed: int):
    """Random +-1 spins [R, Np] (padding +1) and the betas of the TTT
    config's ladder at R replicas (T 0.05-3.0, as the cluster-move PT runs
    take them) on the card: one SW sweep's inputs."""
    import dataclasses

    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.benchmarks.headline import ttt_config

    gen = torch.Generator().manual_seed(seed)
    s = torch.where(torch.rand(r, sw.ell.n_padded, generator=gen) < 0.5,
                    -1.0, 1.0).cuda()
    s = torch.where(sw.ell.active_mask[None] > 0, s, torch.ones_like(s))
    temps = pt.temperature_ladder(dataclasses.replace(ttt_config(),
                                                      n_replicas=r))
    beta = 1.0 / torch.as_tensor(temps, dtype=torch.float32, device="cuda")
    return s.contiguous(), beta.contiguous()


def _path_set(torch, n_pad: int, n: int, r: int, seed: int):
    """One long path through the n active sites in shuffled order (both
    directions bonded), the most rounds a labelling can take."""
    import numpy as np

    order = np.random.default_rng(seed).permutation(n)
    idx = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, 2))
    bond = np.zeros((n_pad, 2), bool)
    idx[order[:-1], 0], bond[order[:-1], 0] = order[1:], True
    idx[order[1:], 1], bond[order[1:], 1] = order[:-1], True
    init = np.where(np.arange(n_pad) < n, np.arange(n_pad), n_pad)
    return (torch.as_tensor(idx, device="cuda"),
            torch.as_tensor(np.broadcast_to(bond, (r, n_pad, 2)).copy(),
                            device="cuda"),
            torch.as_tensor(np.tile(init, (r, 1)).astype(np.int32),
                            device="cuda"))


# operations counted per satisfied bond (the product, expm1f, the compare)
# and per active bond in C1 (a find at each end and a hook)
SW_BOND_OPS, SW_UNION_OPS = 20, 10


def _c2_bound(torch, sw, s, given: bool):
    """C2's least time on these inputs: spins, the ELL operands (idx, val,
    rev_i, rev_k, h, active) and beta read once, masks and start labels
    written once (the given mode also reads u_ghost and the lower ends'
    u_dir); against this run's Philox runs (one per site, slot and group of
    4 replicas that has a satisfied bond, at both ends, and one per site and
    group for the ghost) and SW_BOND_OPS per satisfied bond, at the float32
    rate."""
    r, n = s.shape
    idx, val = sw._idx.long(), sw.ell.val
    k, w = idx.shape[1], -(-idx.shape[1] // 32)
    g = -(-r // 4)
    nbytes = (r * n * 4 + 4 * n * k * 4 + n * 5 + r * 4 + r * n * w * 4
              + r * n * 4)
    sat = (val[None] * s[:, :, None] * s[:, idx]) > 0           # [R, Np, K]
    if given:
        lower = (torch.arange(n, device=s.device)[:, None] < idx) & (val != 0)
        nbytes += r * n * 4 + int(lower.sum()) * r * 4
        ops = int(sat.sum()) * SW_BOND_OPS
    else:
        pad = torch.zeros(g * 4 - r, n, k, dtype=torch.bool, device=s.device)
        runs = int(torch.cat([sat, pad]).reshape(g, 4, n, k).any(1).sum())
        ops = (runs + n * g) * PHILOX_RUN_OPS + int(sat.sum()) * SW_BOND_OPS
    return bound(nbytes, ops, FP32_FLOPS)


def _c1_bound(masks, init, k: int, given: bool):
    """C1's least time on these inputs: masks, start labels and spins read
    once, labels and new spins written once, n_clusters and rounds, idx
    [Np, K] once (coins [R, Np] in the given mode); against SW_UNION_OPS
    per active bond and, in the Philox mode, one Philox run per active
    site, at the float32 rate."""
    from spinglass_tpu_torch.kernels.cluster_cuda import unpack_masks

    r, n, w = masks.shape
    active_bonds = int(unpack_masks(masks, k).sum())
    sites = int((init != n).sum())
    nbytes = r * n * (w * 4 + 4 * 4) + 8 * r + n * k * 4
    nbytes += r * n if given else 0
    ops = active_bonds * SW_UNION_OPS + (0 if given else sites * PHILOX_RUN_OPS)
    return bound(nbytes, ops, FP32_FLOPS)


def _c1_against_plain(torch, cc, c1, idx, masks, init, s, flip):
    """C1 (labels and flip) against labels_reference + flip_reference on
    the same inputs: (bit for bit, max abs difference, plain rounds)."""
    k = idx.shape[1]
    new, n_cl, labels, rounds = c1.flip(idx, masks, init, s, **flip)
    torch.cuda.synchronize()
    want_l, plain_rounds = cc.labels_reference(idx, cc.unpack_masks(masks, k),
                                               init)
    want_s, want_n = cc.flip_reference(s, want_l, init, **flip)
    same = (torch.equal(labels, want_l) and torch.equal(new, want_s)
            and torch.equal(n_cl, want_n) and bool((rounds == 1).all()))
    err = max(int((labels.long() - want_l.long()).abs().max()),
              int((new - want_s).abs().max()),
              int((n_cl.long() - want_n.long()).abs().max()))
    return same, err, plain_rounds, int(n_cl.float().mean())


def cluster_parity(torch, stats):
    """Phase 2 (C2, C1): the SW kernels against their plain versions on the
    card, bit for bit, in the Philox and the given modes: C2's masks and
    start labels, C1's labels, new spins and cluster counts, on one SW
    sweep's inputs on the TTT instance (R=128: one block per replica; R=16:
    a cluster of 8), the +-J and the Gaussian 10k graphs and a dense +-J
    problem in ELL form (K = 255, W = 8); C1 also on three adversarial bond
    sets at Np = 10112 (every bond on, no bond, one long shuffled path),
    with its table in a cluster and in one block."""
    from spinglass_tpu_torch.benchmarks.headline import (sparse_bench_problem,
                                                         ttt_instance)
    from spinglass_tpu_torch.core.cluster import SwendsenWang
    from spinglass_tpu_torch.kernels import cluster_cuda as cc
    from spinglass_tpu_torch.kernels import metropolis_cuda as mc

    ttt, prov = ttt_instance()
    t0 = time.perf_counter()
    sw_ttt = SwendsenWang(ttt)
    stats["reverse_slots_s"] = time.perf_counter() - t0
    stats["drv_ttt"], stats["bench10k"] = (ttt, prov), sparse_bench_problem()
    stats["sw_ttt"] = sw_ttt
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {"TTT 128": (sw_ttt, 128), "TTT 16": (sw_ttt, 16),
             "+-J 10k 128": (SwendsenWang(pm_j_ell(10000, 7)), 128),
             "Gaussian 10k 16": (SwendsenWang(stats["bench10k"]), 16),
             "dense +-J 256 in ELL, 32": (
                 SwendsenWang(pm_j_problem(256, 11, "cuda")), 32)}
    c1 = cc.ClusterLabels()
    err1 = err2 = bonds_launches = 0
    stats["sw_cases"] = {}
    l0 = build.launch_snapshot()
    for name, (sw, r) in cases.items():
        s, beta = _sw_spins(torch, sw, r, r + 1)
        n, k = sw._idx.shape
        seed = 1000 + r
        u_dir, u_ghost, coins = mc.sw_philox_draws(seed, r, n, k, "cuda")
        plan = cc.labels_plan(n, r, sms)
        b = sw.bonds
        for mode, bonds_kw, flip in (
                ("Philox", {"seed": seed}, {"seed": seed}),
                ("given", {"u_dir": u_dir, "u_ghost": u_ghost},
                 {"coins": coins})):
            masks, init = b(s, beta, **bonds_kw)
            torch.cuda.synchronize()
            want_m, want_i = cc.bonds_reference(b.idx, b.val, b.h, b.active,
                                                b.rev_i, b.rev_k, s, beta,
                                                **bonds_kw)
            same2 = torch.equal(masks, want_m) and torch.equal(init, want_i)
            err2 = max(err2, int((masks != want_m).sum()),
                       int((init.long() - want_i.long()).abs().max()))
            same1, e1, plain_rounds, n_cl = _c1_against_plain(
                torch, cc, c1, sw._idx, masks, init, s, flip)
            err1 = max(err1, e1)
            n_bonds = int(cc.unpack_masks(masks, k).sum())
            check(same2 and same1,
                  f"C2 and C1 == plain ({mode}) on {name} [{r}, {n}], K={k}, "
                  f"W={masks.shape[2]}: {n_bonds} bond ends, {n_cl} clusters "
                  f"per replica (the plain loop {plain_rounds} rounds); C1 "
                  f"plan {plan} (mode, blocks, log2 chunk)")
        bonds_launches += 2
        stats["sw_cases"][name] = (sw, s, beta, seed)
    c1_launches = build.launches_since(l0, [cc.KERNEL_NAME])[cc.KERNEL_NAME]   # c1's alone
    check(cc.labels_plan(ttt.n_padded, 16, sms)[:2] == (1, 8)
          and cc.labels_plan(ttt.n_padded, 128, sms)[:2] == (0, 1),
          f"C1 takes a cluster of 8 blocks per replica at 16 replicas and one "
          f"block at 128 ({sms} SMs)")
    idx = sw_ttt._idx
    _, s4, _ = stats["sw_cases"]["TTT 16"][:3]
    masks, init = sw_ttt.bonds(s4[:4].contiguous(), torch.ones(4, device="cuda"),
                               seed=5)
    k = idx.shape[1]
    on = (ttt.val != 0)[None].expand(4, -1, -1)
    adversarial = {"all bonds on": (idx, cc.pack_bonds(on), init),
                   "no bond": (idx, torch.zeros_like(masks), init),
                   "long shuffled path": None}
    pidx, pbond, pinit = _path_set(torch, ttt.n_padded, ttt.n_spins, 2, 5)
    adversarial["long shuffled path"] = (pidx, cc.pack_bonds(pbond), pinit)
    for name, (a_idx, a_masks, a_init) in adversarial.items():
        r = a_init.shape[0]
        s = s4[:r].contiguous()
        for blocks in (None, 1):
            same, e1, plain_rounds, n_cl = _c1_against_plain(
                torch, cc, cc.ClusterLabels(blocks), a_idx, a_masks, a_init,
                s, {"seed": 9})
            err1 = max(err1, e1)
            check(same,
                  f"C1 == plain on {name} [{r}, {a_init.shape[1]}] (table "
                  f"{'in a cluster' if blocks is None else 'in one block'}): "
                  f"{n_cl} clusters per replica, the plain loop "
                  f"{plain_rounds} rounds")
    c2_launches = build.launches_since(l0, [cc.BONDS_KERNEL])[cc.BONDS_KERNEL]
    check(c1_launches == 2 * len(cases) and c2_launches == bonds_launches + 1,
          f"C1 launched {c1_launches} times, C2 {c2_launches}")
    stats["c1_max_abs_err"], stats["c2_max_abs_err"] = err1, err2


def _keep_first_checkpoint(d: str) -> int:
    """Deletes every checkpoint in ``d`` but the first one kept; returns its
    step."""
    steps = sorted(int(f[5:-3]) for f in os.listdir(d) if f.startswith("ckpt_"))
    for s in steps[1:]:
        os.remove(os.path.join(d, f"ckpt_{s}.pt"))
    return steps[0]


def _result_arrays_equal(np, a, b) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
        "best_spins", "replica_best_energy", "energy_history",
        "mean_energy_history", "temperature_history", "acceptance_history")
    ) and a.best_energy == b.best_energy


def _resume_check(torch, np, what, run, n_sweeps, every, tmp, key, per_unit):
    """The uninterrupted run, the checkpointed run and a run resumed after
    deleting all but the first kept checkpoint: results bit for bit, and
    the launches of ``key`` (per_unit(done) = sweeps the checkpoint had
    done). Returns (uninterrupted, checkpointed) results."""
    ref = run()
    d = os.path.join(tmp, what.split()[0])
    full = run(checkpoint_dir=d, checkpoint_every=every)
    first = _keep_first_checkpoint(d)
    saved = torch.load(os.path.join(d, f"ckpt_{first}.pt"), weights_only=True)
    done = per_unit(saved)
    res = run(checkpoint_dir=d, checkpoint_every=every, resume=True)
    want = ref.metadata["kernel_launches"][key]
    got = res.metadata["kernel_launches"][key]
    check(_result_arrays_equal(np, full, ref) and _result_arrays_equal(
        np, res, ref) and full.metadata["kernel_launches"]
          == ref.metadata["kernel_launches"]
          and got * n_sweeps == want * (n_sweeps - done),
          f"{what}: checkpointed and resumed (from {done} of {n_sweeps} "
          f"sweeps) == uninterrupted, bit for bit (best spins, best "
          f"energies, four histories); {key} {want} launches uninterrupted "
          f"and checkpointed, {got} resumed")
    return ref, full


def drivers_slice(torch, mc, stats, card):
    """Phase 4 (the drivers' remaining paths): (a) dense SA through K1,
    checkpointed and resumed; (b) pt.run likewise at 16 replicas (K4) and
    128 (K2); (c) PT with cluster_moves=1 through K2 + C1 and K4 + C1, the
    captured super-step against its eager loop; (d) tune_ladder through K4;
    (e) the compact engine through anneal; (f) the command line's options."""
    import dataclasses
    import tempfile

    import numpy as np
    from click.testing import CliRunner

    from spinglass_tpu_torch import cli
    from spinglass_tpu_torch.anneal import graphs, pt, sa
    from spinglass_tpu_torch.benchmarks.headline import ttt_config
    from spinglass_tpu_torch.kernels.sparse import sparse_energy
    from spinglass_tpu_torch.utils.checkpoint import save_pytree

    tmp = tempfile.mkdtemp(prefix="sgt_ckpt_")
    launches = {}

    def add(res):
        for k, v in res.metadata["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v

    # (a) dense SA, 4096 x 1024, 500 sweeps in chunks of 50, through K1
    sk = stats["dense_first"][0]
    cfg = sa.SAConfig(n_sweeps=500, n_replicas=1024, record_interval=50,
                      enable_early_stop=False)
    sa.anneal(sk, cfg)    # the capture, outside the comparison
    ref, full = _resume_check(
        torch, np, "dense SA (K1, 4096 x 1024)",
        lambda **kw: sa.anneal(sk, cfg, **kw), 500, 2, tmp, mc.KERNEL_NAME,
        lambda saved: int(saved["/sweeps_done"]))
    add(ref)
    steps = graphs.SA_CACHE.get(sk, ("anneal", graphs.config_key(cfg)))[1]
    state = steps[50].state
    tree = sa._ckpt_tree(state, torch.Generator().manual_seed(1), {
        k: list(range(10)) for k in sa.HIST_KEYS}, 500)
    path = os.path.join(tmp, "save_probe.pt")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pytree(tree, path)
        times.append(time.perf_counter() - t0)
    stats["ckpt_save"] = (times, os.path.getsize(path))
    print(f"  a dense SA checkpoint (spins and best spins [4096, 1024] "
          f"float32): {os.path.getsize(path)} bytes, saved in "
          + " / ".join(f"{t:.4f}" for t in times) + " s; anneal total_time "
          f"{ref.total_time:.3f} s uninterrupted, {full.total_time:.3f} s "
          f"with 5 saves [{card}]")

    # (b) pt.run checkpointed every 20 super-steps: K4 at 16 replicas on the
    # Gaussian 10k graph, K2 at 128 on the planted TTT instance
    ttt, prov = stats["drv_ttt"]
    bench = stats["bench10k"]
    pt16 = pt.PTConfig(n_replicas=16, n_sweeps=1000, seed=42)
    ttt128 = dataclasses.replace(ttt_config(), n_sweeps=1000)
    for what, prob, pcfg, key in (
            ("pt16 PT (K4, 16 replicas, Gaussian 10k)", bench, pt16,
             "sparse_accept"),
            ("pt128 PT (K2, 128 replicas, TTT instance)", ttt, ttt128,
             "sparse_sweep")):
        pt.run(prob, pcfg)    # the capture, outside the comparison
        ref, full = _resume_check(
            torch, np, what, lambda **kw: pt.run(prob, pcfg, **kw), 1000, 20,
            tmp, key, lambda saved: int(saved["/done_super"]) * 10)
        add(ref)
        stats.setdefault("segmented", {})[what.split()[0]] = (
            ref.total_time, full.total_time)
        print(f"  {what}: total_time {ref.total_time:.4f} s single-dispatch, "
              f"{full.total_time:.4f} s segmented (5 saves) [{card}]")

    # (c) PT with one SW sweep per super-step on the TTT instance
    best_known = prov["best_known_energy"]
    stats["cm"] = {}
    for r, key in ((128, "sparse_sweep"), (16, "sparse_accept")):
        ccfg = dataclasses.replace(ttt_config(), n_replicas=r, n_sweeps=1000,
                                   cluster_moves=1)
        res = pt.run(ttt, ccfg)
        add(res)
        kl = res.metadata["kernel_launches"]
        super_step, _, engine = pt.make_pt_step(ttt, ccfg)
        state = pt.init_state(ttt, ccfg, torch.Generator().manual_seed(
            ccfg.seed), engine)
        hist = []
        for _ in range(100):
            state, st = super_step(state)
            hist.append(torch.stack([st["best_energy"], st["cold_energy"],
                                     st["mean_acceptance"]]))
        hist = torch.stack(hist).cpu().numpy()
        same = (np.array_equal(res.energy_history, hist[:, 0])
                and np.array_equal(res.mean_energy_history, hist[:, 1])
                and np.array_equal(res.acceptance_history, hist[:, 2])
                and np.array_equal(res.replica_best_energy,
                                   state.best_energy.cpu().numpy()))
        per = 1 if key == "sparse_sweep" else len(engine.groups)
        check(same and kl["sw_labels"] == kl["sw_bonds"] == 100
              and kl[key] == 1000 * per,
              f"PT with cluster_moves=1 at {r} replicas: the captured "
              f"super-step == its eager loop bit for bit (100 super-steps); "
              f"C2 {kl['sw_bonds']} and C1 {kl['sw_labels']} launches, {key} "
              f"{kl[key]}")
        _resume_check(
            torch, np, f"cm{r} PT + SW ({'K2' if r == 128 else 'K4'}, {r} replicas, TTT)",
            lambda **kw: pt.run(ttt, ccfg, **kw), 1000, 20, tmp, "sw_labels",
            lambda saved: int(saved["/done_super"]) * 10)
        step = graphs.PT_CACHE.get(ttt, ("run", graphs.config_key(ccfg)))[2]
        gen = torch.Generator().manual_seed(9)
        _sync_free(torch, f"the cluster-move super-step at {r} replicas",
                   lambda: [step.replay(gen) for _ in range(3)])
        # E0 + dE == E1 across an SW sweep, on the eager run's last state
        sw = super_step.sw
        s_rn = engine.from_layout(state.spins).contiguous()
        betas = 1.0 / torch.as_tensor(pt.temperature_ladder(ccfg),
                                      device="cuda")
        e0 = sparse_energy(ttt, s_rn)
        s1, de, n_cl = sw.sweep(s_rn, betas[state.slot.long()], gen)
        e1 = sparse_energy(ttt, s1)
        rel = float(((e0 + de - e1).abs() / e1.abs()).max())
        check(rel <= 1e-4, f"E0 + dE == E1 across an SW sweep at {r} replicas "
                           f"(max rel {rel:.2e} <= 1e-4); clusters per "
                           f"replica {float(n_cl.float().mean()):.1f}, "
                           f"rounds max {int(sw.last_rounds.max())}")
        s = torch.ones(1, ttt.n_padded, device="cuda")
        s[0, :ttt.n_spins] = torch.as_tensor(res.best_spins, device="cuda")
        e_best = float(sparse_energy(ttt, s)[0])
        rel = abs(e_best - res.best_energy) / abs(e_best)
        check(rel <= 1e-4, f"best_energy {res.best_energy:.3f} == energy("
                           f"best_spins) {e_best:.3f} (rel {rel:.1e})")
        gap = (res.best_energy - best_known) / abs(best_known)
        stats["cm"][r] = {"best": res.best_energy, "gap": gap,
                          "total_time": res.total_time, "config": ccfg}
        print(f"  PT + SW at {r} replicas, 1000 sweeps: best energy "
              f"{res.best_energy:.3f} against the provenance's {best_known} "
              f"(gap {100 * gap:.3f}%; recorded, not a gate); total_time "
              f"{res.total_time:.3f} s, capture {res.metadata['capture_seconds']:.3f} s "
              f"[{card}]")

    # (d) tune_ladder on the Gaussian 10k graph at 16 replicas (K4)
    base = pt.run(bench, pt16)
    misses = graphs.PT_CACHE.misses
    t0 = time.perf_counter()
    temps, diag = pt.tune_ladder(bench, pt16, n_pilot_sweeps=200, n_iters=2)
    wall = time.perf_counter() - t0
    captures = graphs.PT_CACHE.misses - misses
    kept = graphs.PT_CACHE.get(bench, ("run", graphs.config_key(pt16)))
    tuned = pt.run(bench, pt16, ladder_override=temps)
    b_rates = np.asarray(base.metadata["exchange_rates"])
    t_rates = np.asarray(tuned.metadata["exchange_rates"])
    spread_b, spread_t = np.ptp(b_rates), np.ptp(t_rates)
    stats["tune"] = (wall, captures, diag["pilot_sweeps"], spread_b, spread_t)
    check(spread_t <= spread_b + 0.05 and bool(np.all(np.diff(temps) > 0))
          and np.allclose([temps[0], temps[-1]], [pt16.min_temp,
                                                  pt16.max_temp], rtol=1e-5),
          f"tune_ladder (16 replicas, pilot 200 sweeps, 2 iterations): rate "
          f"spread {spread_t:.4f} <= geometric {spread_b:.4f} + 0.05, "
          f"increasing, endpoints kept; pilots {diag['pilot_sweeps']} "
          f"sweeps, {captures} captures, {wall:.2f} s; the caller's own "
          f"entry {'kept' if kept is not None else 'evicted'} [{card}]")

    # (e) the compact engine at 10k x 1024: one sweep through anneal
    ecfg = sa.SAConfig(n_sweeps=1, n_replicas=1024, record_interval=1,
                       sweep_method="sparse_compact", enable_early_stop=False)
    res = sa.anneal(bench, ecfg)
    eng = sa.make_sweep_engine(bench, ecfg)
    st = sa.init_state(bench, ecfg, eng, torch.Generator().manual_seed(42))
    st, chunk = sa.run_chunk(bench, ecfg, eng, st, 1)
    check(res.metadata["engine"] == "sparse_colored"
          and res.energy_history[0] == float(chunk["best_energy"])
          and res.acceptance_history[0] == float(chunk["acceptance"])
          and np.array_equal(res.replica_best_energy,
                             st.best_energy.cpu().numpy()),
          f"the compact engine ({eng.n_colors} colours) through anneal at "
          f"10k x 1024: one captured sweep == the engine's eager sweep")
    stats["compact"] = (bench, ecfg, eng)

    # (f) the command line's options that raised before this slice
    d = os.path.join(tmp, "cli")
    outs = []
    pt_args = ["solve", "-p", "tsp", "-s", "20", "-a", "pt", "--cluster-moves",
               "1", "--tune-ladder", "--checkpoint-dir", d]
    for argv in (pt_args, pt_args + ["--resume"],
                 ["solve", "-p", "maxcut", "-s", "20", "--sweep-method",
                  "sparse_compact"]):
        t0 = time.perf_counter()
        out = CliRunner().invoke(cli.main, argv)
        outs.append(out.output)
        check(out.exit_code == 0 and "objective:" in out.output,
              f"sgt-torch {' '.join(argv).replace(d, 'D')} exits "
              f"{out.exit_code} ({time.perf_counter() - t0:.2f} s) "
              f"[{card}]: " + out.output.replace("\n", "; ")[:160])
    check(outs[0] == outs[1], "the resumed command prints what the first did")
    stats["driver_launches"] = launches
    print(f"  drivers' paths launches: {launches}")


def _event_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``reps`` calls,
    after one call to warm up."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events around one replay of a
    graph that captured ``reps`` calls (the device's time alone: a narrow
    kernel finishes before the host launches the next), after one eager
    call (shared-memory attributes are set outside the capture)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _event_ms(torch, graph.replay, 3) / reps


def drivers_timing(torch, stats, card):
    """Phase 5 (the drivers' remaining paths): C2 and C1 in both draw modes
    against their plain versions and their bounds, as graphs, at 128 and 16
    replicas on the TTT instance, and C1's table placements at 16 in turns;
    one SW sweep as a graph (from a seed slot and on given draws); the
    captured PT super-step with and without cluster_moves=1 at 128 (K2) and
    16 (K4) replicas; the layout round trip; checkpoint saves; segmented
    against single-dispatch pt.run; tune_ladder; the compact engine beside
    K2."""
    import dataclasses

    from spinglass_tpu_torch.anneal import graphs, pt, sa
    from spinglass_tpu_torch.benchmarks.headline import (_profile,
                                                         _pt_steppers,
                                                         ttt_config)
    from spinglass_tpu_torch.kernels import cluster_cuda as cc
    from spinglass_tpu_torch.kernels import metropolis_cuda as mc
    from spinglass_tpu_torch.kernels.sparse import sparse_energy

    ttt, _ = stats["drv_ttt"]
    sw = stats["sw_ttt"]
    for r in (128, 16):
        _, s, beta, seed = stats["sw_cases"][f"TTT {r}"]
        n, k = sw._idx.shape
        slot = torch.tensor([seed], dtype=torch.int64, device="cuda")[0]
        u_dir, u_ghost, coins = mc.sw_philox_draws(seed, r, n, k, "cuda")
        masks, init = sw.bonds(s, beta, seed=slot)
        c1 = cc.ClusterLabels()
        ms = {
            "C2 Philox": _graph_ms(torch, lambda: sw.bonds(s, beta, seed=slot),
                                   20),
            "C2 given": _graph_ms(torch, lambda: sw.bonds(
                s, beta, u_dir=u_dir, u_ghost=u_ghost), 20),
            "C1 Philox": _graph_ms(torch, lambda: c1.flip(
                sw._idx, masks, init, s, seed=slot), 20),
            "C1 given": _graph_ms(torch, lambda: c1.flip(
                sw._idx, masks, init, s, coins=coins), 20)}
        b = sw.bonds
        t0 = time.perf_counter()
        cc.bonds_reference(b.idx, b.val, b.h, b.active, b.rev_i, b.rev_k, s,
                           beta, seed=slot)
        torch.cuda.synchronize()
        plain2_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        labels, _ = cc.labels_reference(sw._idx, cc.unpack_masks(masks, k),
                                        init)
        cc.flip_reference(s, labels, init, seed=slot)
        torch.cuda.synchronize()
        plain1_ms = 1e3 * (time.perf_counter() - t0)
        b2 = _c2_bound(torch, sw, s, False)
        b2g = _c2_bound(torch, sw, s, True)
        b1 = _c1_bound(masks, init, k, False)
        b1g = _c1_bound(masks, init, k, True)
        if r == 128:
            stats["c1"] = (ms["C1 Philox"], plain1_ms) + b1
            stats["c2"] = (ms["C2 Philox"], plain2_ms) + b2
        plan = cc.labels_plan(n, r)
        print(f"  C2 at [{r}, {n}] (K={k}, one SW sweep's inputs on the TTT "
              f"instance at its ladder's betas), as a graph: Philox {1e3 * ms['C2 Philox']:.1f} us "
              f"(bound {1e3 * b2[0]:.2f} us, {b2[1]}), given "
              f"{1e3 * ms['C2 given']:.1f} us (bound {1e3 * b2g[0]:.2f}, "
              f"{b2g[1]}); plain version {plain2_ms:.3f} ms [{card}]")
        print(f"  C1 at [{r}, {n}] (plan {plan}): Philox "
              f"{1e3 * ms['C1 Philox']:.1f} us (bound {1e3 * b1[0]:.2f} us, "
              f"{b1[1]}), given {1e3 * ms['C1 given']:.1f} us (bound "
              f"{1e3 * b1g[0]:.2f}, {b1g[1]}); plain labels + flip "
              f"{plain1_ms:.3f} ms [{card}]")
        if r == 16:   # where C1 keeps its table at 16 replicas, in turns
            turn = {}
            for blocks in (8, 1, 1, 8, 2, 4):
                c = cc.ClusterLabels(blocks)
                turn.setdefault(blocks, []).append(_graph_ms(
                    torch, lambda: c.flip(sw._idx, masks, init, s, seed=slot),
                    20))
            stats["c1_turns16"] = turn
            print("  C1 at [16, %d], table placement in turns (us): %s [%s]"
                  % (n, "; ".join(f"{b} block(s) " + " / ".join(
                      f"{1e3 * t:.1f}" for t in ts) for b, ts in turn.items()),
                     card))
    for r in (128, 16):
        _, s, beta, seed = stats["sw_cases"][f"TTT {r}"]
        n, k = sw._idx.shape
        slot = torch.tensor([seed], dtype=torch.int64, device="cuda")[0]
        draws = mc.sw_philox_draws(seed, r, n, k, "cuda")
        seeded = _graph_ms(torch, lambda: sw._sweep(s, beta, seed=slot), 20)
        given = _graph_ms(torch, lambda: sw.sweep_with_draws(s, beta, *draws),
                          20)
        energy = _graph_ms(torch, lambda: sparse_energy(sw.ell, s), 20)
        print(f"  one SW sweep at [{r}, {n}] as a graph (C2, C1, two ELL "
              f"energies): {1e3 * seeded:.1f} us from a seed slot, "
              f"{1e3 * given:.1f} us on given draws; one of its ELL energies "
              f"{1e3 * energy:.1f} us [{card}]")
    for r, key in ((128, "K2"), (16, "K4")):
        rows = []
        for cm in (0, 1):
            cfg = dataclasses.replace(ttt_config(), n_replicas=r,
                                      n_sweeps=1000, cluster_moves=cm)
            if graphs.PT_CACHE.get(ttt, ("run", graphs.config_key(cfg))) is None:
                pt.run(ttt, cfg)
            betas, engine, step = graphs.PT_CACHE.get(
                ttt, ("run", graphs.config_key(cfg)))
            gen = torch.Generator().manual_seed(3)
            rows.append(_event_ms(torch, lambda: step.replay(gen), 20))
            if cm == 0:
                spins = step.state.spins
                rn = engine.from_layout(spins).contiguous()
                out_ms = _event_ms(torch, lambda: engine.from_layout(spins)
                                   .contiguous(), 50)
                in_ms = _event_ms(torch, lambda: engine.to_layout(rn), 50)
        print(f"  PT super-step on the TTT instance at {r} replicas ({key}), "
              f"captured: {1e3 * rows[0]:.1f} us, with cluster_moves=1 "
              f"{1e3 * rows[1]:.1f} us (+{1e3 * (rows[1] - rows[0]):.1f}); "
              f"layout round trip [{spins.shape[0]}, {r}] {spins.dtype} -> "
              f"[{r}, {ttt.n_padded}] {1e3 * out_ms:.1f} us, back "
              f"{1e3 * in_ms:.1f} us [{card}]")
    for r in (128, 16):
        # the cluster-move super-step profiled as the TTT loop is: 10 replays
        # of a captured super-step, each followed by its 4-byte read (the
        # launch counts are checked against the profiler's below)
        ccfg = stats["cm"][r]["config"]
        steps = _pt_steppers(ttt, ccfg, None, 10, read_each=True)
        stats["profiles"][f"PT + SW, {r} replicas (K{2 if r == 128 else 4} "
                          f"+ C2 + C1)"] = _profile(
            steps["captured"], 100, 8, graph_launches=10,
            kernels=steps["kernels"])
    times, nbytes = stats["ckpt_save"]
    print(f"  checkpoint save, dense SA: {nbytes} bytes, {min(times):.4f}-"
          f"{max(times):.4f} s; _ell_reverse_slots on the TTT instance "
          f"{stats['reverse_slots_s']:.3f} s [{card}]")
    for name, (single, seg) in stats["segmented"].items():
        print(f"  {name}: single-dispatch {single:.4f} s, segmented {seg:.4f} "
              f"s [{card}]")
    wall, captures, pilots, spread_b, spread_t = stats["tune"]
    print(f"  tune_ladder: {wall:.3f} s, {captures} captures, pilots {pilots} "
          f"sweeps, spread {spread_b:.4f} -> {spread_t:.4f} [{card}]")
    bench, ecfg, eng = stats["compact"]
    cfg = dataclasses.replace(ecfg, n_sweeps=10)
    step = sa.capture_chunk(bench, cfg, eng, sa.init_state(bench, cfg, eng), 10)
    gen = torch.Generator().manual_seed(1)
    ms = _event_ms(torch, lambda: step.replay(gen), 5) / 10
    print(f"  compact engine at 10k x 1024 ({eng.n_colors} colours), "
          f"captured chunk of 10: {1e3 * ms:.1f} us/sweep; K2 "
          f"{1e3 * stats['k2_ms']:.1f} us/sweep ({ms / stats['k2_ms']:.2f}x) "
          f"[{card}]")


# ---------------------------------------------------------------------------
# The batch, adaptive and operations slice: K1 with a problem axis,
# BatchProcessor, adaptive_anneal, health / benchmark / monitor / bench /
# cache-stats and the /metrics server
# ---------------------------------------------------------------------------

BATCH_N, BATCH_PROBLEMS = 2048, 64   # BatchProcessor's phase: SK glasses


def _stacked_pm_j(torch, n_problems: int, n: int, seed: int):
    """P +-J problems (h on a quarter grid: every field exact) drawn on the
    card from seeds seed, seed + 1, ..., and their stack."""
    from spinglass_tpu_torch.anneal import batch
    from spinglass_tpu_torch.core.problem import IsingProblem, round_up

    n_pad = round_up(n)
    ps = []
    for p in range(n_problems):
        gen = torch.Generator(device="cuda").manual_seed(seed + p)
        a = torch.triu(2.0 * torch.randint(0, 2, (n, n), generator=gen,
                                           device="cuda") - 1.0, diagonal=1)
        j = torch.zeros(n_pad, n_pad, device="cuda")
        j[:n, :n] = a + a.T
        h = torch.zeros(n_pad, device="cuda")
        h[:n] = torch.randint(-8, 9, (n,), generator=gen, device="cuda") / 4.0
        mask = torch.zeros(n_pad, device="cuda")
        mask[:n] = 1.0
        ps.append(IsingProblem(j=j, h=h, active_mask=mask, n_spins=n))
    return ps, batch.stack_problems(ps)


def _stacked_check(torch, mc, ps, st, r, rule, mode, seed, twin: bool,
                   ones=None):
    """One stacked K1 sweep against P one-problem launches under the
    per-problem seeds (``ones``: each problem's ``FusedSweep`` at this
    rule) and, with ``twin``, against the stacked twin: spins, dE and
    counts bitwise. Returns the largest difference."""
    import numpy as np

    n_problems, n_pad = st.n_problems, st.n_padded
    sw = mc.StackedFusedSweep(st.j, st.h, st.active_mask, block_size=SA_BLOCK,
                              rule=rule)
    rng = np.random.default_rng(seed)
    s = torch.as_tensor(np.where(rng.random((n_problems, n_pad, r)) < 0.5,
                                 -1.0, 1.0), dtype=torch.float32,
                        device="cuda")
    for p, prob in enumerate(ps):
        s[p, prob.n_spins:] = 1.0
    beta = torch.as_tensor(rng.uniform(0.1, 2.0, (n_problems, r)),
                           dtype=torch.float32, device="cuda")
    singles, ref = s.clone(), s.clone()
    if mode == "philox":
        seeds = torch.as_tensor(rng.integers(0, 2 ** 62, n_problems),
                                dtype=torch.int64, device="cuda")
        _, de, cnt = sw(s, beta, seeds)
        u = (torch.stack([mc.philox_uniforms(seeds[p], n_pad, r, "cuda")
                          for p in range(n_problems)]) if twin else None)
    else:
        u = torch.rand(n_problems, n_pad, r, device="cuda")
        _, de, cnt = sw.sweep_with_uniforms(s, beta, u)
    err = 0.0
    if ones is None:
        ones = [mc.FusedSweep(prob, block_size=SA_BLOCK, rule=rule)
                for prob in ps]
    for p, one in enumerate(ones):
        if mode == "philox":
            _, de1, cnt1 = one(singles[p], beta[p], seeds[p:p + 1])
        else:
            _, de1, cnt1 = one.sweep_with_uniforms(singles[p], beta[p],
                                                   u[p].contiguous())
        err = max(err, float((de[p] - de1).abs().max()),
                  float((cnt[p] - cnt1).abs().max()))
    err = max(err, float((s - singles).abs().max()))
    if twin:
        _, de_t, cnt_t = sw.reference(ref, beta, u)
        err = max(err, float((s - ref).abs().max()),
                  float((de - de_t).abs().max()),
                  float((cnt - cnt_t).abs().max()))
    return err


def batch_parity(torch, mc, stats):
    """Phase 2 (K1's problem axis): a stacked launch against P one-problem
    launches and against the stacked twin, bit for bit."""
    worst = 0.0
    n_cases = 0
    for n_problems, n in itertools.product((1, 3, 16), (500, 2000)):
        ps, st = _stacked_pm_j(torch, n_problems, n, 11 * n_problems + n)
        ones = {rule: [mc.FusedSweep(prob, block_size=SA_BLOCK, rule=rule)
                       for prob in ps] for rule in ("metropolis", "glauber")}
        # the twin (a Python loop over the rows, ~0.1 ms a row on the card)
        # on one case of P = 3 at each size and of P = 16 at Np = 512
        twin_case = ((37, "glauber", "philox") if n_problems == 3 else
                     (16, "metropolis", "given") if n_problems == 16
                     and n == 500 else None)
        for r, rule, mode in itertools.product(
                (1, 16, 37), ("metropolis", "glauber"), ("philox", "given")):
            twin = (r, rule, mode) == twin_case
            err = _stacked_check(torch, mc, ps, st, r, rule, mode,
                                 n_problems * 100 + r, twin, ones[rule])
            worst = max(worst, err)
            n_cases += 1
            check(err == 0.0, f"stacked K1 P={n_problems} Np={st.n_padded} "
                              f"R={r} {rule} {mode}: == {n_problems} single "
                              f"launches{' and the twin' if twin else ''}")
    ps, st = _stacked_pm_j(torch, 2, 8400, 5)
    check(mc.dense_tile(st.n_padded, SA_BLOCK) == mc.BLOCK_TILE,
          f"Np={st.n_padded} is beyond the cluster kernel: the one-block "
          f"kernel runs")
    for rule, mode, twin in (("metropolis", "philox", True),
                             ("glauber", "given", False)):
        err = _stacked_check(torch, mc, ps, st, 5, rule, mode, 3, twin)
        worst = max(worst, err)
        check(err == 0.0, f"stacked one-block K1 P=2 Np={st.n_padded} R=5 "
                          f"{rule} {mode}: == single launches"
                          f"{' and the twin' if twin else ''}")
    occ = mc.cluster_occupancy(BATCH_N, 16, SA_BLOCK)
    print(f"  K1 cluster kernel at Np={BATCH_N}, R=16, block {SA_BLOCK}: "
          f"{occ['max_active_clusters']} clusters resident at once (P = 16 "
          f"launches 16)")
    stats["max_abs_err"] = max(stats["max_abs_err"], worst)


def _batch_problems(torch, n: int, count: int, seed0: int = 0):
    """Gaussian SK glasses of n spins, J_ij ~ N(0, 1/n), drawn on the card
    from seeds seed0, seed0 + 1, ... (the upper triangle, mirrored), padded
    to a multiple of 128."""
    from spinglass_tpu_torch.core.problem import IsingProblem, round_up

    n_pad = round_up(n)
    out = []
    for s in range(count):
        gen = torch.Generator(device="cuda").manual_seed(seed0 + s)
        a = torch.randn(n, n, generator=gen, device="cuda") * n ** -0.5
        a = torch.triu(a, diagonal=1)
        j = torch.zeros(n_pad, n_pad, device="cuda")
        j[:n, :n] = a + a.T
        mask = torch.zeros(n_pad, device="cuda")
        mask[:n] = 1.0
        out.append(IsingProblem(j=j, h=torch.zeros(n_pad, device="cuda"),
                                active_mask=mask, n_spins=n))
    return out


def _identity_ok(torch, problem, best_spins, best_energy) -> bool:
    """best_energy == energy(best_spins), 1e-4 relative."""
    import numpy as np

    from spinglass_tpu_torch.core.energy import energy

    s = np.ones(problem.n_padded, np.float32)
    s[: problem.n_spins] = best_spins
    e = float(energy(problem, torch.as_tensor(s, device="cuda")))
    return abs(e - best_energy) <= 1e-4 * max(1.0, abs(e))


class _RunTracker:
    """The captured stacked runs a call uses (``batch.stacked_run`` wrapped)
    and the K1 launches counted while it runs."""

    def __init__(self, batch):
        self.batch, self.orig, self.runs = batch, batch.stacked_run, []

    def __enter__(self):
        def tracked(stacked, cfg):
            run = self.orig(stacked, cfg)
            if all(run is not r for r in self.runs):
                self.runs.append(run)
            return run

        self.batch.stacked_run = tracked
        self.before = build.launch_snapshot()
        return self

    def __exit__(self, *exc):
        self.batch.stacked_run = self.orig
        self.k1 = build.launches_since(self.before, ["metropolis_sweep"])["metropolis_sweep"]

    def launches(self) -> int:
        return self.k1


def _adaptive_expected(history, cfg) -> int:
    """The interventions the JAX rule makes on this best-energy history."""
    best, stagnant, n = float("inf"), 0, 0
    for be in history:
        if be < best - 1e-9:
            best, stagnant = be, 0
        else:
            stagnant += 1
        if stagnant >= cfg.stagnation_chunks and n < cfg.max_interventions:
            stagnant, n = 0, n + 1
    return n


def batch_slice(torch, mc, stats, card):
    """Phase 4 (the batch, adaptive and operations slice)."""
    import urllib.request

    import numpy as np
    from click.testing import CliRunner

    from spinglass_tpu_torch import cli
    from spinglass_tpu_torch.anneal import adaptive, batch
    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.anneal.sa import SAConfig
    from spinglass_tpu_torch.benchmarks import headline, runner
    from spinglass_tpu_torch.utils import health, metrics_exporter as me

    launches = {mc.KERNEL_NAME: 0, "sparse_sweep": 0, "sparse_accept": 0}
    stats["batch_launches"] = launches
    # -- BatchProcessor at its defaults over 64 SK glasses ------------------
    t0 = time.perf_counter()
    problems = _batch_problems(torch, BATCH_N, BATCH_PROBLEMS)
    torch.cuda.synchronize()
    print(f"  {BATCH_PROBLEMS} SK glasses at N={BATCH_N} drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    stats["batch_problems"] = problems
    batch.clear_runs()
    proc = batch.BatchProcessor()
    cfg = proc.sa_config
    check((cfg.n_sweeps, cfg.n_replicas, proc.batch_config.max_batch_size)
          == (200, 16, 16), "BatchProcessor's defaults: 200 sweeps, 16 "
                            "replicas, batches of up to 16")
    with _RunTracker(batch) as tr:
        t0 = time.perf_counter()
        res = proc.process(problems, seed=0)
        first_s = time.perf_counter() - t0
    n_k1 = tr.launches()
    launches[mc.KERNEL_NAME] += n_k1
    check(len(tr.runs) == 1 and tr.runs[0].sweep.n_problems == 16,
          f"one captured stacked run, P = 16 (capture "
          f"{tr.runs[0].capture_seconds:.3f} s)")
    check(n_k1 == 4 * 200, f"K1 launched {n_k1} times: 200 per batch, 4 "
                           f"batches of 16 problems")
    check(all(r.algorithm == "sa/batched" for r in res)
          and proc.failures == [] and proc.n_processed == BATCH_PROBLEMS,
          "every result sa/batched, no failure, 64 processed")
    check(all(_identity_ok(torch, p, r.best_spins, r.best_energy)
              for p, r in zip(problems, res)),
          "each best_energy == energy(best_spins) (1e-4 relative)")
    e_n = np.array([r.best_energy / BATCH_N for r in res])
    print(f"  process of {BATCH_PROBLEMS} problems (first call, capture "
          f"inside): {first_s:.3f} s; best E/N mean {e_n.mean():.5f}, min "
          f"{e_n.min():.5f}, max {e_n.max():.5f} [{card}]")
    check(e_n.max() < -0.6, "every problem anneals (E/N < -0.6)")
    # the captured run against its eager loop, one batch; no sync in a replay
    st = batch.stack_problems(problems[:16])
    run = batch.stacked_run(st, cfg)
    l0 = build.launch_snapshot()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        run.j.copy_(st.j)
        run.h.copy_(st.h)
        run.mask.copy_(st.active_mask)
    run.step.load({"spins": batch._start_spins(gen, run.mask, 16)})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run.step.replay(gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [t.cpu() for t in out]
    (be, bs, rep), n_eager = batch.eager_stacked(
        st, cfg, torch.Generator().manual_seed(3))
    launches[mc.KERNEL_NAME] += build.launches_since(l0, [mc.KERNEL_NAME])[mc.KERNEL_NAME]
    check(all(torch.equal(a, b.cpu()) for a, b in zip(got, (be, bs, rep))),
          "the captured stacked run == its eager loop bit for bit (best "
          "energies, best spins, replica bests), no host sync in the replay")
    # -- bucketing and adaptive batches ------------------------------------
    mixed = (_batch_problems(torch, 500, 8, 100)
             + _batch_problems(torch, 1000, 8, 200)
             + _batch_problems(torch, BATCH_N, 8, 300))
    order = np.random.default_rng(0).permutation(len(mixed))
    mixed = [mixed[i] for i in order]
    with _RunTracker(batch) as tr:
        t0 = time.perf_counter()
        res = batch.BatchProcessor().process(mixed, seed=1)
        dt = time.perf_counter() - t0
    launches[mc.KERNEL_NAME] += tr.launches()
    check(sorted((r.sweep.n_problems, r.sweep.n_pad) for r in tr.runs)
          == [(8, 512), (8, 1024), (8, 2048)] and tr.launches() == 600,
          f"bucketed: 3 sizes, one batch of 8 each, K1 600 launches "
          f"({dt:.3f} s, {len(tr.runs)} new captures)")
    check(all(len(r.best_spins) == p.n_spins and r.algorithm == "sa/batched"
              and _identity_ok(torch, p, r.best_spins, r.best_energy)
              for p, r in zip(mixed, res)),
          "results in input order, each energy identity holds")
    with _RunTracker(batch) as tr:
        aproc = batch.AdaptiveBatchProcessor()
        t0 = time.perf_counter()
        res = aproc.process(problems, seed=2)
        dt = time.perf_counter() - t0
    launches[mc.KERNEL_NAME] += tr.launches()
    sizes = aproc.batch_sizes
    new = [r for r in tr.runs if r.sweep.n_problems != 16]
    check(sum(sizes) == BATCH_PROBLEMS and tr.launches() == 200 * len(sizes)
          and all(r.algorithm == "sa/batched" for r in res),
          f"AdaptiveBatchProcessor: batch sizes {sizes}, {len(tr.runs)} "
          f"captured runs used ({len(new)} new captures, "
          f"{sum(r.capture_seconds for r in new):.3f} s), K1 "
          f"{tr.launches()} launches, {dt:.3f} s [{card}]")
    stats["batch_adaptive"] = {"sizes": sizes, "seconds": dt,
                               "captures": len(new)}
    # -- adaptive SA: K1 (SK 4096), K4 (10k, R=32), K2 (10k, R=1024) --------
    stats["adaptive"] = {}
    ell = headline.sparse_bench_problem()
    for label, prob, r in (("SK 4096 (K1)", stats["sk"], 32),
                           ("10k graph, R=32 (K4)", ell, 32),
                           ("10k graph, R=1024 (K2)", ell, 1024)):
        acfg = adaptive.AdaptiveSAConfig()
        if r != acfg.base.n_replicas:
            acfg = adaptive.AdaptiveSAConfig(base=SAConfig(
                n_sweeps=acfg.base.n_sweeps, n_replicas=r,
                schedule=acfg.base.schedule))
        res = adaptive.adaptive_anneal(prob, acfg)
        kl = res.metadata["kernel_launches"]
        want_iv = _adaptive_expected(res.energy_history, acfg)
        print(f"  adaptive_anneal {label}: engine {res.metadata['engine']}, "
              f"{res.metadata['interventions']} interventions, best E/N "
              f"{res.best_energy / prob.n_spins:.5f}, {res.total_time:.3f} s "
              f"(capture {res.metadata['capture_seconds']:.3f} s), launches "
              f"{kl} [{card}]")
        check(res.metadata["interventions"] == want_iv >= 1,
              f"{label}: interventions {want_iv} as the JAX rule makes them "
              f"on its history (stagnation fired)")
        sweeps = res.n_sweeps
        if "SK" in label:
            check(kl == {mc.KERNEL_NAME: sweeps, "sa_track": sweeps},
                  f"{label}: K1 and sa_track {sweeps} launches")
            ok = _identity_ok(torch, prob, res.best_spins, res.best_energy)
        else:
            eng = make_engine(prob, r_hint=r)
            colours = eng.n_colors
            key = "sparse_sweep" if r % 128 == 0 else "sparse_accept"
            per = 1 if key == "sparse_sweep" else colours
            check(kl[key] == per * sweeps and kl["sa_track"] == sweeps
                  and sum(kl.values()) == (per + 1) * sweeps,
                  f"{label}: {key} {per} x {sweeps} launches, sa_track "
                  f"{sweeps}, no other kernel")
            from spinglass_tpu_torch.kernels.sparse import sparse_energy

            s = np.ones(prob.n_padded, np.float32)
            s[: prob.n_spins] = res.best_spins
            e = float(sparse_energy(prob, torch.as_tensor(s, device="cuda")[None])[0])
            ok = abs(e - res.best_energy) <= 1e-4 * abs(e)
        check(ok, f"{label}: best_energy == energy(best_spins) (1e-4)")
        for k, v in kl.items():
            launches[k] = launches.get(k, 0) + v
        stats["adaptive"][label] = res
    # -- the operations commands, in process -------------------------------
    invoke = CliRunner().invoke
    out = invoke(cli.main, ["health"])
    rep = json.loads(out.output) if out.exit_code == 0 else {}
    check(out.exit_code == 0 and rep["checks"]["annealer"]["status"]
          == "healthy" and "engine=cuda_fused"
          in rep["checks"]["annealer"]["message"],
          f"sgt-torch health exits 0, the annealer healthy on K1: "
          f"{rep.get('checks', {}).get('device_compute', {}).get('message')}")
    hc = health.check_annealer()
    check(hc.details["kernel_launches"] == {mc.KERNEL_NAME: 50,
                                            "sa_track": 50},
          "the micro-anneal launches K1 and sa_track 50 times")
    for k, v in hc.details["kernel_launches"].items():
        launches[k] = launches.get(k, 0) + v
    for case in runner.standard_suite((20, 50), device="cuda"):
        prob = case.make_problem().encode_to_ising()
        sa_eng = make_engine(prob, r_hint=32)
        pt_eng = make_engine(prob, r_hint=16)
        print(f"    {case.name}: Np={prob.n_padded}, SA engine "
              f"{sa_eng.name}, PT engine {pt_eng.name}")
    t0 = time.perf_counter()
    tmp = os.path.join(HERE, "chipwork", "benchmark_results.json")
    os.makedirs(os.path.dirname(tmp), exist_ok=True)
    out = invoke(cli.main, ["benchmark", "--sizes", "20,50", "--sweeps",
                            "500", "--trials", "2", "-o", tmp])
    with open(tmp) as f:
        data = json.load(f)
    check(out.exit_code == 0 and len(data["results"]) == 32
          and all(np.isfinite(r["objective"]) for r in data["results"]),
          f"sgt-torch benchmark --sizes 20,50 --sweeps 500 --trials 2: exit "
          f"0, 32 solves, every objective finite "
          f"({time.perf_counter() - t0:.1f} s)")
    for k, v in sorted(data["summary"].items()):
        print(f"    {k}: best {v['best_objective']:.3f}, mean "
              f"{v['mean_objective']:.3f}, feasible "
              f"{v['feasibility_rate']:.2f}, {v['mean_time']:.3f} s")
    out = invoke(cli.main, ["monitor"])
    snap = json.loads(out.output) if out.exit_code == 0 else {}
    dev = snap.get("device", {}).get("cuda:0", {})
    check(out.exit_code == 0 and dev.get("bytes_limit", 0) > 0,
          f"sgt-torch monitor: the card's memory {dev}")
    os.environ["SGT_METRICS_PORT"] = "0"
    me._global_server = None
    try:
        out = invoke(cli.main, ["ising", "-n", "256", "--sweeps", "200",
                                "--replicas", "32"])
        srv = me._global_server
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read().decode()
    finally:
        os.environ.pop("SGT_METRICS_PORT")
        if me._global_server is not None:
            me._global_server.stop()
        me._global_server = None
    line = [ln for ln in body.splitlines()
            if ln.startswith('spinglass_solver_flips_per_sec{solver="sa"}')]
    check(out.exit_code == 0 and line, f"SGT_METRICS_PORT: /metrics served "
                                       f"in process after an anneal: {line}")
    out = invoke(cli.main, ["bench", "--path", "dense"])
    lines = out.output.strip().splitlines()
    bench = json.loads(lines[-1]) if out.exit_code == 0 and lines else {}
    check(out.exit_code == 0 and len(lines) == 1 and "value" in bench,
          f"sgt-torch bench --path dense: one JSON line, "
          f"{bench.get('value', 0):.4e} {bench.get('unit', '')} [{card}]")
    out = invoke(cli.main, ["cache-stats"])
    check(out.exit_code == 0 and "sa_steps" in json.loads(out.output),
          f"sgt-torch cache-stats: {out.output.strip()}")


def batch_timing(torch, mc, stats, card):
    """Phase 5 (the batch slice): the stacked K1 at P = 16 against 16 single
    launches in turns (graphs, CUDA events); a whole process of the 64
    problems, first and repeat call; adaptive_anneal against sa.anneal at
    the same budget, in turns."""
    from spinglass_tpu_torch.anneal import adaptive, batch
    from spinglass_tpu_torch.anneal.sa import anneal

    problems = stats["batch_problems"]
    st = batch.stack_problems(problems[:16])
    sw = mc.StackedFusedSweep(st.j, st.h, st.active_mask, block_size=SA_BLOCK)
    singles = [mc.FusedSweep(p, block_size=SA_BLOCK) for p in problems[:16]]
    gen = torch.Generator().manual_seed(0)
    s = torch.where(torch.rand(16, BATCH_N, 16, generator=gen) < 0.5, -1.0,
                    1.0).cuda()
    beta = torch.full((16, 16), 2.0, device="cuda")
    seeds = torch.arange(16, dtype=torch.int64, device="cuda") + 7
    s1 = s.clone()

    def stacked():
        sw(s, beta, seeds)

    def sixteen():
        for p, one in enumerate(singles):
            one(s1[p], beta[p], seeds[p:p + 1])

    times = {"stacked": [], "16 single": []}
    for _ in range(2):
        times["stacked"].append(_graph_ms(torch, stacked, 20))
        times["16 single"].append(_graph_ms(torch, sixteen, 5))
    one_ms = _graph_ms(torch, lambda: singles[0](s1[0], beta[0],
                                                 seeds[0:1]), 20)
    nbytes = 16 * (4 * BATCH_N * BATCH_N + 8 * BATCH_N * 16 + 8 * BATCH_N
                   + 12 * 16)
    flops = 16 * 2.0 * BATCH_N * BATCH_N * 16 * sw.planes
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    st_ms = min(times["stacked"])
    print(f"  K1 stacked P=16 at [{BATCH_N}, 16], block {SA_BLOCK} ({sw.planes} "
          f"planes): {1e3 * st_ms:.1f} us per launch (turns "
          f"{[round(1e3 * t, 1) for t in times['stacked']]}); 16 single "
          f"launches {[round(1e3 * t, 1) for t in times['16 single']]} us; "
          f"one problem alone {1e3 * one_ms:.1f} us; bound {1e3 * b_ms:.1f} us "
          f"({b_by}), {100 * b_ms / st_ms:.1f}% of it [{card}]")
    stats["batch_k1"] = {"stacked_ms": st_ms, "singles_ms": min(
        times["16 single"]), "one_ms": one_ms, "bound": (b_ms, b_by)}
    calls = []
    for k in range(2):
        if k == 0:
            batch.clear_runs()
        t0 = time.perf_counter()
        res = batch.BatchProcessor().process(problems, seed=k)
        calls.append(time.perf_counter() - t0)
        check(all(r.algorithm == "sa/batched" for r in res),
              f"process call {k}: every result sa/batched")
    print(f"  BatchProcessor().process of {BATCH_PROBLEMS} SK glasses at "
          f"N={BATCH_N} (4 batches of 16, 200 sweeps, R=16): first call "
          f"{calls[0]:.3f} s (capture inside), repeat call {calls[1]:.3f} s; "
          f"{4 * 200 / calls[1]:.1f} stacked sweeps/s, "
          f"{BATCH_PROBLEMS * 200 * 16 * BATCH_N / calls[1]:.4e} flips/s "
          f"[{card}]")
    stats["batch_calls"] = calls
    from spinglass_tpu_torch.benchmarks.headline import profile_batch

    prof = profile_batch(problems[:16])
    stats["profiles"]["batch of 16 (stacked K1, [16, 2048, 16])"] = prof
    lc = prof["launch_check"][mc.KERNEL_NAME]
    print(f"  profile_batch (one batch of 16: copy, start spins, replay, "
          f"read): {prof['us_per_sweep']:.1f} us per stacked sweep, "
          f"kernels {prof['device_us_per_sweep']:.1f}, device busy "
          f"{100 * prof['device_busy_share']:.1f}%, "
          f"{prof['launches_per_sweep']:.1f} kernels per sweep; K1 counter "
          f"{lc['counter']}, profiler {lc['profiler']} [{card}]")
    for k in prof["kernels"]:
        print(f"    {k['us_per_sweep']:9.2f} us/sweep  {k['calls']:5d} calls  "
              f"{k['name'][:80]}")
    check(lc["counter"] == 200, "the profiled batch launched K1 200 times "
                                "(its counter; the profiler's count above "
                                "is recorded, not checked: it loses records "
                                "now and then)")
    acfg = adaptive.AdaptiveSAConfig()
    sk = stats["sk"]
    rows = {"adaptive_anneal": [], "sa.anneal": []}
    for _ in range(2):
        rows["adaptive_anneal"].append(
            adaptive.adaptive_anneal(sk, acfg).total_time)
        rows["sa.anneal"].append(anneal(sk, acfg.base).total_time)
    print(f"  SK 4096, 2000 sweeps, R=32 (K1), in turns: adaptive_anneal "
          f"{[round(t, 4) for t in rows['adaptive_anneal']]} s (a capture "
          f"each call), sa.anneal {[round(t, 4) for t in rows['sa.anneal']]} "
          f"s (first call captures) [{card}]")
    stats["adaptive_vs_anneal"] = rows


# ---------------------------------------------------------------------------
# The research layer: SQA and PIMC on a Trotter problem built on the card,
# AQIA, MSHO, LESD, QEC, meta, federated, Pareto, unified, breakthrough and
# meta-RL, all annealing through K1
# ---------------------------------------------------------------------------

RESEARCH_N = 1024   # the SK glass of the research path (J ~ N(0, 1/N))


def research_problem(device, n: int = RESEARCH_N, seed: int = 42):
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=seed)
    return IsingProblem.from_dense(j, device=device)


def _k1(mc, l0: dict) -> int:
    """K1's launches since the launch ledger's snapshot ``l0``."""
    return build.launches_since(l0, [mc.KERNEL_NAME])[mc.KERNEL_NAME]


def research_parity(torch, mc, stats):
    """Phase 2 (research): one SQA stage on a +-J Trotter problem (N=128,
    P=4, Gamma putting J_perp at 0.25, every field exact) through K1 against
    the same stage through the twin on one generator seed, bit for bit; the
    stage's captured ``sa.anneal`` against its eager chunks; the in-place
    rewrite of J_perp against a fresh build, three planes kept."""
    import math

    import numpy as np

    from spinglass_tpu_torch.anneal import graphs, sa
    from spinglass_tpu_torch.anneal.twins import TwinFusedEngine
    from spinglass_tpu_torch.research import quantum as Q

    base = pm_j_problem(128, 5, "cuda")
    beta, p = 2.0, 4
    gammas = [p / beta * math.atanh(math.exp(-2.0 * beta * jp))
              for jp in (0.25, 0.5)]
    tp = Q.trotterize(base, p, beta, gammas[0])
    cfg = Q.stage_config(Q.SQAConfig(n_trotter=p, beta=beta, n_replicas=16),
                         40, 0)
    engine = sa.make_sweep_engine(tp, cfg)
    twin = TwinFusedEngine(tp, block_size=cfg.block_size)
    check(engine.fused.planes == 3 and engine.name == "cuda_fused",
          f"the Trotter problem [{tp.n_padded}, 16] takes K1 with 3 planes "
          f"(J_perp 0.25 alone would need 1)")
    out, launched = [], []
    for eng in (engine, twin):
        l0 = build.launch_snapshot()
        st = sa.init_state(tp, cfg, eng, torch.Generator().manual_seed(3))
        st, _ = sa.run_chunk(tp, cfg, eng, st, 40)
        out.append(st)
        launched.append(build.launches_since(l0, [mc.KERNEL_NAME]))
    a, b = out
    torch.cuda.synchronize()
    fields = ("spins", "energy", "best_energy", "best_spins", "acc_rate")
    diff = [k for k in fields if not torch.equal(getattr(a, k), getattr(b, k))]
    check(not diff and launched == [{mc.KERNEL_NAME: 40},
                                    {mc.KERNEL_NAME: 0}],
          f"+-J N=128 P=4 Trotter stage (40 sweeps, R=16, J_perp 0.25): K1 "
          f"== twin bitwise in {', '.join(fields)} (differ: {diff or 'none'})")
    tp.set_field(beta, gammas[1])
    fresh = Q.trotterize(base, p, beta, gammas[1])
    check(torch.equal(tp.j, fresh.j), "J_perp rewritten in place (0.5) == a "
                                      "fresh Trotter build, bitwise")
    graphs.clear_caches()
    res = sa.anneal(tp, cfg, generator=torch.Generator().manual_seed(4))
    st = sa.init_state(tp, cfg, engine, torch.Generator().manual_seed(4))
    st, _ = sa.run_chunk(tp, cfg, engine, st, 40)
    b = int(torch.argmin(st.best_energy))
    eager_spins = st.best_spins[:, b].cpu().numpy()[: tp.n_spins]
    check(res.metadata["capture_seconds"] > 0
          and res.best_energy == float(st.best_energy[b])
          and np.array_equal(res.best_spins, eager_spins)
          and np.array_equal(res.replica_best_energy,
                             st.best_energy.cpu().numpy()),
          f"the captured stage (sa.anneal, one replay of its 40-sweep chunk) "
          f"== its eager chunks bitwise: best energy {res.best_energy}, best "
          f"spins, replica bests")
    graphs.clear_caches()


def _identity(torch, problem, res) -> float:
    """|reported best energy - energy of the returned spins| (float32 on
    the card), relative."""
    import numpy as np

    from spinglass_tpu_torch.core.energy import energy

    s = np.ones(problem.n_padded, np.float32)
    s[: problem.n_spins] = res.best_spins
    e = float(energy(problem, torch.as_tensor(s, device="cuda")))
    return abs(e - res.best_energy) / max(1.0, abs(e))


def research_slice(torch, mc, stats, card):
    """Phase 4 (research): the research layer's entry points on the SK glass
    at N=1024 (and its federated, Pareto and meta-RL companions), each call
    with its seconds, captures (``graphs.CapturedStep.made``) and K1
    launches (the launch ledger over each call)."""
    import numpy as np

    from spinglass_tpu_torch.anneal import graphs
    from spinglass_tpu_torch.research import (breakthrough, federated, meta,
                                              meta_rl, novel, pareto, quantum,
                                              unified)

    sk = research_problem("cuda")
    n = RESEARCH_N
    rows = {}
    stats["research"] = rows
    total = {mc.KERNEL_NAME: 0}
    stats["research_launches"] = total
    graphs.clear_caches()

    def call(name, fn, want=None):
        made0 = graphs.CapturedStep.made
        l0 = build.launch_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1 = _k1(mc, l0)
        total[mc.KERNEL_NAME] += k1
        caps = graphs.CapturedStep.made - made0
        rows[name] = {"seconds": secs, "k1_launches": k1, "captures": caps}
        check(k1 > 0 and (want is None or k1 == want),
              f"{name}: {secs:.3f} s, {caps} captures, K1 launched {k1} "
              f"times{'' if want is None else f' (expected {want})'} [{card}]")
        return out

    # -- SQA and PIMC at their defaults: K1 at [8192, 16] ------------------
    for k in range(2):
        res = call(f"SQA call {k} (P=8, 10 stages x 100 sweeps, R=16)",
                   lambda: quantum.simulated_quantum_annealing(sk), 1000)
        err = _identity(torch, sk, res)
        check(err <= 1e-5 and res.best_energy / n < -0.6
              and res.metadata["captures"] == (1 if k == 0 else 0),
              f"SQA call {k}: best slice E/N {res.best_energy / n:.5f}, the "
              f"reported energy == the classical energy of the returned "
              f"spins (rel err {err:.1e} <= 1e-5); captures {res.metadata['captures']}"
              f" (capture {res.metadata['capture_seconds']:.3f} s); "
              f"{res.sweeps_per_second:.1f} Trotter sweeps/s")
    rows["SQA E/N"] = res.best_energy / n
    tp = quantum.TROTTER_CACHE.get(sk, ("trotter", 8))
    check(tp is not None and tp.n_padded == 8192,
          "one Trotter problem [8192, 8192] on the card for both calls")
    res = call("PIMC (P=8, 500 sweeps, R=16)",
               lambda: quantum.path_integral_monte_carlo(sk), 500)
    check(_identity(torch, sk, res) <= 1e-5 and len(
        res.metadata["slice_energies"]) == 8,
          f"PIMC: best slice E/N {res.best_energy / n:.5f} == the energy of "
          f"its spins; captures {res.metadata['captures']}")
    rows["PIMC E/N"] = res.best_energy / n
    # -- the novel algorithms at their defaults ------------------------------
    res = call("QEC (rep 3, [3072, 16], 400 sweeps)",
               lambda: novel.quantum_error_corrected_annealing(sk), 400)
    check(_identity(torch, sk, res) <= 1e-5,
          f"QEC: E/N {res.best_energy / n:.5f}, "
          f"{res.metadata['code_violations']} code violations")
    res = call("MSHO", lambda: novel.multi_scale_optimization(sk))
    lv = res.metadata["n_levels"]
    check(rows["MSHO"]["k1_launches"] == 300 + 200 * (lv - 1)
          and _identity(torch, sk, res) <= 1e-5,
          f"MSHO: {lv} levels, one anneal each (300 + 200 x {lv - 1} K1 "
          f"launches), E/N {res.best_energy / n:.5f}")
    l0 = build.launch_snapshot()
    made0 = graphs.CapturedStep.made
    t0 = time.perf_counter()
    res = novel.adaptive_quantum_inspired_annealing(sk)
    secs = time.perf_counter() - t0
    rows["AQIA (R=32, 500 iterations, captured)"] = {
        "seconds": secs, "k1_launches": 0,
        "captures": graphs.CapturedStep.made - made0,
        "capture_seconds": res.metadata["capture_seconds"]}
    check(_k1(mc, l0) == 0 and len(res.energy_history) == 500
          and graphs.CapturedStep.made - made0 == 1
          and _identity(torch, sk, res) <= 1e-5,
          f"AQIA (R=32, 500 iterations as replays of one captured "
          f"iteration, no K1: it measures, it does not sweep): {secs:.3f} s "
          f"(capture {res.metadata['capture_seconds']:.3f} s), E/N "
          f"{res.best_energy / n:.5f} [{card}]")
    l0 = build.launch_snapshot()
    made0 = graphs.CapturedStep.made
    t0 = time.perf_counter()
    res = novel.learning_enhanced_dynamics(sk)
    secs = time.perf_counter() - t0
    rows["LESD (R=16, 300 iterations, captured)"] = {
        "seconds": secs, "k1_launches": 0,
        "captures": graphs.CapturedStep.made - made0,
        "capture_seconds": res.metadata["capture_seconds"]}
    check(_k1(mc, l0) == 0 and np.isfinite(res.metadata["final_loss"])
          and graphs.CapturedStep.made - made0 == 1
          and _identity(torch, sk, res) <= 1e-4,
          f"LESD (R=16, 300 replays of one captured iteration, Adam "
          f"included, one read of the losses): {secs:.3f} s (capture "
          f"{res.metadata['capture_seconds']:.3f} s), E/N "
          f"{res.best_energy / n:.5f}, final loss "
          f"{res.metadata['final_loss']:.4g} [{card}]")
    out = call("compare_algorithms (all four)",
               lambda: novel.compare_algorithms(sk))
    check(set(out) == {"aqia", "msho", "lesd", "qec"} and all(
        np.isfinite(v["best_energy"]) for v in out.values()),
          "compare_algorithms: " + ", ".join(
              f"{k} E/N {v['best_energy'] / n:.4f}" for k, v in out.items()))
    # -- the rest, at budgets that keep the phase short ----------------------
    opt = meta.MetaOptimizer(n_sweeps=200, n_replicas=16)
    for algo, want in (("sa", 200), ("pt", 200), ("adaptive_sa", 200),
                       ("sqa", 200)):
        res = call(f"MetaOptimizer.solve({algo!r})",
                   lambda: opt.solve(sk, algorithm=algo), want)
        check(np.isfinite(res.best_energy),
              f"  {algo}: E/N {res.best_energy / n:.5f}")
    clients = [research_problem("cuda", seed=100 + k) for k in range(4)]
    out = call("FederatedAnnealingServer.run (4 clients, 2 rounds)",
               lambda: federated.FederatedAnnealingServer(
                   federated.FederatedConfig(n_rounds=2)).run(clients),
               4 * 2 * 300)
    check(set(out["global_params"]) == {"initial_temp", "alpha"},
          f"federated: final bests E/N "
          f"{[round(e / n, 4) for e in out['final_best']]}")
    out = call("FederatedQuantumHybridOptimizer.run (4 clients, 2 rounds)",
               lambda: federated.FederatedQuantumHybridOptimizer(
                   federated.FederatedConfig(n_rounds=2, local_sweeps=100)
               ).run(clients), 4 * 2 * 5 * 20)
    check(out["global_gamma0"] > 0, f"federated SQA: global gamma0 "
                                    f"{out['global_gamma0']:.4f}")
    arch = call("pareto.optimize (2 objectives, 4 weight vectors)",
                lambda: pareto.optimize(
                    [sk, clients[0]], pareto.MultiObjectiveConfig(
                        n_weight_vectors=4, n_sweeps=200)), 4 * 200)
    check(arch.front.shape[1] == 2 and len(arch.objectives) >= 1,
          f"Pareto front of {len(arch.objectives)} points")
    fw = unified.UnifiedResearchFramework(n_sweeps=200, n_replicas=16)
    out = call("UnifiedResearchFramework.compare (sa, pt; 2 trials)",
               lambda: fw.compare(sk, n_trials=2), 4 * 200)
    check(out["winner"] in ("sa", "pt"), f"unified compare: winner "
                                         f"{out['winner']}, p {out['p_value']:.3g}")
    rep = call("BreakthroughResearchFramework.validate (2 trials)",
               lambda: breakthrough.BreakthroughResearchFramework(
                   n_trials=2).validate(sk))
    check(set(rep["algorithms"]) == {"baseline", "adaptive_neural",
                                     "quantum_error_corrected", "federated"},
          "breakthrough: " + ", ".join(
              f"{k} E/N {v['mean_best_energy'] / n:.4f}"
              for k, v in rep["algorithms"].items()))
    agent = meta_rl.AdaptiveMetaRLAgent(meta_rl.MetaRLConfig(
        refit_interval=100), device="cuda")

    def agent_run():
        for p in [sk] + clients[:2]:
            agent.solve(p)
        return agent.refit()

    loss = call("AdaptiveMetaRLAgent: 3 solves, then refit", agent_run,
                3 * 400)
    check(np.isfinite(loss) and agent.report()["fits"] == 1,
          f"meta-RL: refit loss {loss:.4g}, memory "
          f"{agent.report()['memory_size']}")
    print(f"  research path K1 launches: {total[mc.KERNEL_NAME]}; captures "
          f"{sum(r['captures'] for r in rows.values() if isinstance(r, dict))}"
          f" [{card}]")


def research_timing(torch, mc, stats, card):
    """Phase 5 (research): K1 at the Trotter shape [8192, 16] against its
    bound, and against its twin there on the same spins and uniforms: on
    the SK glass's Trotter problem (Gaussian J, all three planes non-zero:
    the energy identity within 1e-4 relative, counts within 0.5%) and on a
    +-J SK glass at N=1024, P=8 with J_perp 0.25 (every field exact: spins,
    dE and counts bitwise); where SQA, PIMC, AQIA and LESD spend their time
    (``headline.profile_research``)."""
    import math

    import numpy as np

    from spinglass_tpu_torch.benchmarks.headline import profile_research
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.energy import energy_t
    from spinglass_tpu_torch.core.problem import IsingProblem
    from spinglass_tpu_torch.research import quantum

    sk = research_problem("cuda")
    tp = quantum.trotterize(sk, 8, 2.0, 1.0)
    fused = mc.FusedSweep(tp, block_size=SA_BLOCK)
    r = 16
    gen = torch.Generator().manual_seed(2)
    s = torch.where(torch.rand(tp.n_padded, r, generator=gen) < 0.5, -1.0,
                    1.0).cuda()
    beta = torch.full((r,), 2.0, device="cuda")
    ms = _graph_ms(torch, lambda: fused(s, beta, 7), 20)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    u = torch.rand(tp.n_padded, r, device="cuda")
    e0 = energy_t(tp, s)
    s_k, de_k, c_k = fused.sweep_with_uniforms(s.clone(), beta, u)
    e1 = energy_t(tp, s_k)
    start.record()
    s_p, de_p, c_p = mc.fused_sweep_reference(
        tp.j, tp.h, tp.active_mask, s.clone(), beta, u, block_size=SA_BLOCK)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    rel = float(((e0 + de_k - e1).abs() / e1.abs().clamp(min=1.0)).max())
    ck, cp = int(c_k.sum()), int(c_p.sum())
    check(fused.planes == 3 and rel <= 1e-4 and abs(ck - cp) <= 0.005 * cp,
          f"K1 on the SK N=1024 P=8 Trotter problem [{tp.n_padded}, {r}] "
          f"(3 planes) against its twin on the same spins and uniforms: "
          f"energy identity E0+dE==E1 max rel err {rel:.3e} <= 1e-4; accept "
          f"counts kernel {ck} vs twin {cp} (within 0.5%); replicas bitwise "
          f"equal {int((s_k == s_p).all(0).sum())}/{r}, max |dE_k - dE_twin| "
          f"{float((de_k - de_p).abs().max()):.3e}")
    # +-J SK at N=1024 (J = +-1/32, so J/P = +-1/256) and Gamma putting
    # J_perp at 0.25: every coupling and field is exact in float32 and bf16
    jb = topology.fully_connected(RESEARCH_N, dist="binary",
                                  scale=1.0 / np.sqrt(RESEARCH_N), seed=42)
    pm = IsingProblem.from_dense(jb, device="cuda")
    p, beta_q = 8, 2.0
    gamma = p / beta_q * math.atanh(math.exp(-2.0 * beta_q * 0.25))
    tpm = quantum.trotterize(pm, p, beta_q, gamma)
    fpm = mc.FusedSweep(tpm, block_size=SA_BLOCK)
    jp = float(tpm.j[0, RESEARCH_N])
    s_k, de_k, c_k = fpm.sweep_with_uniforms(s.clone(), beta, u)
    s_p, de_p, c_p = mc.fused_sweep_reference(
        tpm.j, tpm.h, tpm.active_mask, s.clone(), beta, u,
        block_size=SA_BLOCK)
    torch.cuda.synchronize()
    diff = [k for k, a, b in (("spins", s_k, s_p), ("dE", de_k, de_p),
                              ("counts", c_k, c_p)) if not torch.equal(a, b)]
    check(fpm.planes == 3 and jp == 0.25 and not diff,
          f"K1 on a +-J SK N=1024 P=8 Trotter problem [{tpm.n_padded}, {r}] "
          f"(J_perp {jp}, 3 planes) against its twin on the same spins and "
          f"uniforms: spins, dE, counts bitwise (differ: {diff or 'none'}; "
          f"{int(c_k.sum())} flips)")
    n_pad = tp.n_padded
    nbytes = 4 * n_pad * n_pad + 8 * n_pad * r + 8 * n_pad + 12 * r
    b_ms, b_by = bound(nbytes, fused.planes * 2.0 * n_pad * n_pad * r,
                       BF16_FLOPS)
    occ = mc.cluster_occupancy(n_pad, r, SA_BLOCK)
    stats["research_k1"] = {"ms": ms, "plain_ms": plain_ms,
                            "bound": (b_ms, b_by)}
    print(f"  K1 at the Trotter shape [{n_pad}, {r}] ({fused.planes} planes, "
          f"block {SA_BLOCK}): {1e3 * ms:.1f} us per sweep (a graph of 20); "
          f"bound {1e3 * b_ms:.1f} us ({b_by}: J read once as float32, "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s), {100 * b_ms / ms:.1f}% of "
          f"it; {occ['clusters_launched']} cluster(s) of 8 thread blocks on "
          f"132 SMs; plain twin {plain_ms:.1f} ms [{card}]")
    prof = profile_research(sk)
    for name, p in prof.items():
        stats["profiles"][f"research {name}"] = p
        print(f"  profile {name}: {p['us_per_sweep']:.1f} us per "
              f"{p['unit']}, kernels {p['device_us_per_sweep']:.1f}, device "
              f"busy {100 * p['device_busy_share']:.1f}%, "
              f"{p['launches_per_sweep']:.1f} kernels per {p['unit']}, "
              f"{p['graph_launches_per_sweep']:.2f} graph replays per "
              f"{p['unit']} [{card}]")
        for k in p["kernels"][:5]:
            print(f"    {k['us_per_sweep']:9.2f} us/{p['unit']}  "
                  f"{k['calls']:5d} calls  {k['name'][:80]}")


# the ea2d-l80.sqa cell's shape: the 80 x 80 glass (J uniform in (-2, 2),
# its instance seed), P=20 slices at T=0.05, R=128: K2 at [128000, 128]
SQA_L, SQA_SEED, SQA_P, SQA_R, SQA_BETA = 80, 20020329, 20, 128, 20.0


def sqa_sparse(torch, stats, card):
    """Phase 5 (research, sparse SQA) at the ea2d-l80.sqa shape: a short
    carried SQA (4 stages of 25 sweeps, linear ramp; ``write_couplings``
    runs between the replays of the captured chunk), its launches read from
    the ledger over the second call alone: K2 and ``sa_track`` once a
    sweep, no K3 or K4; its best energy against the float64 energy of its
    spins; every coupling table of the engine it replays equal to a fresh
    build at the last Gamma. Then K2 on that rewritten engine against the
    fresh engine's twins on the same spins and thresholds (K3's): the
    slot-ordered twin (spins, counts bitwise, dE within 1e-5 of its largest
    entry) and the per-colour twin (counts within 0.5%); K2 there as a
    graph against its plain version and its bound."""
    import numpy as np

    from spinglass_tpu_torch.anneal import graphs
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.core.topology import lattice_coo
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels import track_cuda
    from spinglass_tpu_torch.kernels.sparse import (EllProblem,
                                                    SortedSparseTEngine)
    from spinglass_tpu_torch.research import quantum as Q

    n, rows, cols, vals = lattice_coo(SQA_L, dims=2, dist="uniform",
                                      scale=2.0, seed=SQA_SEED)
    ell = EllProblem.from_coo(n, rows, cols, vals, device="cuda")
    cfg = Q.SQAConfig(n_trotter=SQA_P, beta=SQA_BETA, gamma_start=2.5,
                      n_stages=4, sweeps_per_stage=25, n_replicas=SQA_R,
                      carry_state=True, gamma_schedule="linear")
    names = (sc.SWEEP_KERNEL, track_cuda.KERNEL, sc.THRESHOLD_KERNEL,
             sc.ACCEPT_KERNEL)
    graphs.clear_caches()
    Q.simulated_quantum_annealing(ell, cfg,
                                  generator=torch.Generator().manual_seed(1))
    l0 = build.launch_snapshot()
    t0 = time.perf_counter()
    res = Q.simulated_quantum_annealing(
        ell, cfg, generator=torch.Generator().manual_seed(2))
    run_s = time.perf_counter() - t0
    got = build.launches_since(l0, names)
    md = res.metadata
    sweeps = cfg.n_stages * cfg.sweeps_per_stage
    s = res.best_spins.astype(np.float64)
    j64 = np.asarray(vals, np.float32).astype(np.float64)
    e64 = -0.5 * float(np.sum(j64 * s[rows] * s[cols]))
    rel = abs(res.best_energy - e64) / abs(e64)
    check(got == {sc.SWEEP_KERNEL: sweeps, track_cuda.KERNEL: sweeps,
                  sc.THRESHOLD_KERNEL: 0, sc.ACCEPT_KERNEL: 0}
          and md["kernel_launches"][sc.SWEEP_KERNEL] == sweeps
          and md["sweeps"] == sweeps and md["captures"] == 0
          and md["stages"] == md["field_writes"] == cfg.n_stages
          and rel <= 1e-5,
          f"carried SQA at the ea2d-l80.sqa shape ({SQA_L}x{SQA_L}, P="
          f"{SQA_P}, R={SQA_R}, {cfg.n_stages} stages of "
          f"{cfg.sweeps_per_stage} sweeps, replayed, no capture): launches "
          f"{got} ({sweeps} sweeps, {md['field_writes']} field writes); best "
          f"{res.best_energy:.4f} against its spins' float64 energy "
          f"{e64:.4f} (rel {rel:.2e} <= 1e-5); {run_s:.3f} s a call")
    for k in (sc.SWEEP_KERNEL, track_cuda.KERNEL):
        stats["research_launches"][k] = (stats["research_launches"].get(k, 0)
                                         + got[k])
    tp = Q.TROTTER_CACHE.get(ell, ("trotter", SQA_P))
    engine, = graphs.sa_engines_of(tp)
    fresh = SortedSparseTEngine(Q.trotterize(ell, SQA_P, SQA_BETA,
                                             md["gammas"][-1]))

    def tables(eng):
        return ([b.val for _, _, bs in eng.groups for b in bs]
                + [eng.kernels.tables["val"], eng.kernels._val_t,
                   eng._coupling.values()])

    same = [torch.equal(a, b) for a, b in zip(tables(engine), tables(fresh))]
    ns, r = engine.n_sorted, SQA_R
    check(all(same) and len(same) > 3 and engine.state_dtype(r) ==
          torch.float32,
          f"after the run every coupling table of the replayed engine ("
          f"{len(same)}: buckets, K4's, K2's, the CSR) == a fresh build at "
          f"Gamma {md['gammas'][-1]} bitwise; K2 takes [{ns}, {r}] "
          f"(tile {sc.default_tile(r, ns)})")
    gen = torch.Generator().manual_seed(23)
    s_k = engine.to_layout(random_spins(gen, (r, tp.n_padded),
                                        tp.active_mask))
    s_o, s_p = s_k.clone(), s_k.clone()
    beta = torch.linspace(0.5, SQA_BETA, r, device="cuda")
    k, kf = engine.kernels, fresh.kernels
    err = 0.0
    for mode in ("philox", "host thresholds"):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        th = kf.thresholds(beta, seed, r)
        kw = dict(seed=seed) if mode == "philox" else dict(th=th)
        _, de_k, c_k = k.single_sweep(s_k, beta, **kw)
        _, de_o, c_o = sc.single_sweep_ordered(kf.tables, kf.span_list, s_o,
                                               th)
        _, de_p, c_p = sc.single_sweep_reference(fresh.groups, s_p, th)
        torch.cuda.synchronize()
        e = float((de_k - de_o).abs().max())
        err = max(err, e)
        tol = 1e-5 * float(de_o.abs().max())
        ck, cp = int(c_k.sum()), int(c_p.sum())
        check(torch.equal(s_k, s_o) and torch.equal(c_k, c_o) and e <= tol
              and abs(ck - cp) <= 0.005 * cp and ck > 0,
              f"K2 ({mode}) on the rewritten engine at [{ns}, {r}] == the "
              f"fresh engine's slot-ordered twin: spins, counts bitwise, dE "
              f"within {e:.2e} <= {tol:.2e}; per-colour twin counts {cp} "
              f"against {ck}")
        s_p.copy_(s_k)
    ms = _graph_ms(torch, lambda: k.single_sweep(s_k, beta, seed=7), 20)
    th = kf.thresholds(beta, 7, r)
    sc.single_sweep_reference(fresh.groups, s_p, th)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        sc.single_sweep_reference(fresh.groups, s_p, th)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 3
    # bound as phase 5 (K2, K3) counts it, at [NS, 128]
    kmax = k.tables["idx"].shape[1]
    nnz = int(k.tables["deg"].sum())
    b = bound(8.0 * ns * r + ns * (8 * kmax + 12) + 12 * r,
              ns * r * SPARSE_DRAW_OPS + 2.0 * nnz * r, FP32_FLOPS)
    stats["k2_sqa"] = {"shape": [ns, r], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b[0], "bound_by": b[1],
                       "max_abs_err": err}
    print(f"  K2 at the ea2d-l80.sqa shape [{ns}, {r}] ({nnz} entries, "
          f"one replica column a block), as a graph: {1e3 * ms:.2f} us a "
          f"sweep (bound {1e3 * b[0]:.2f} us, {b[1]}: {100 * b[0] / ms:.1f}% "
          f"of it); per-colour twin {plain_ms:.3f} ms [{card}]")
    print("  " + json.dumps({"k2_sqa": stats["k2_sqa"]}))
    graphs.clear_caches()


def _same_pt(np, a, b) -> bool:
    """Two PT results equal bit for bit: ``_same_result``'s arrays and
    launches, the best energy, the slot records and exchange rates."""
    return (_same_result(np, a, b) and a.best_energy == b.best_energy
            and all(np.array_equal(np.asarray(a.metadata[k]),
                                   np.asarray(b.metadata[k])) for k in (
                "slot_trajectory", "slot_energy_history", "exchange_rates")))


DIST_PT = (  # (label, problem, PTConfig keywords, the kernel it must launch)
    ("dense SK N=4096, R=1024 (K1)", "sk",
     dict(n_replicas=1024, n_sweeps=100, exchange_interval=10,
          sweep_method="blocked", min_temp=0.2, max_temp=3.0, seed=5),
     "metropolis_sweep"),
    ("sparse 10k, R=128 (K2)", "ell",
     dict(n_replicas=128, n_sweeps=100, exchange_interval=10, min_temp=0.2,
          max_temp=3.0, seed=6), "sparse_sweep"),
    ("sparse 10k, R=16 (K4)", "ell",
     dict(n_replicas=16, n_sweeps=100, exchange_interval=10, min_temp=0.2,
          max_temp=3.0, seed=7), "sparse_accept"),
)
DIST_N, DIST_R = 4096, 256       # the model-sharded sweeps' shape
DIST_PPO_UPDATES = 4


def distributed_slice(torch, mc, stats, card):
    """Phase 4 (distributed): a one-rank NCCL group (``multihost
    .initialize``); ``pt_sharded.run`` through K1, K2 and K4, each equal to
    ``pt.run`` on the same seed bit for bit; the model-sharded sweeps at
    N=4096, R=256 against the plain sweeps on the same uniforms; the
    sharded PPO against ``make_ppo`` (both captured); the job pools and the
    edge orchestrator running SA seeds through K1 from several threads.
    ``stats["dist_launches"]``: the K1, K2 and K4 launches of the
    distributed runs (the sharded PT runs' ``kernel_launches``, the sharded
    PPO engine's count, the launch ledger around the pools and the edge
    orchestrator); the reference calls they are held against do not
    count."""
    import numpy as np

    from spinglass_tpu_torch.anneal import graphs
    from spinglass_tpu_torch.anneal import pt as pt_mod
    from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem
    from spinglass_tpu_torch.distributed import (model_sharded, multihost,
                                                 pt_sharded, rl_sharded)
    from spinglass_tpu_torch.distributed.coordinator import JobCoordinator
    from spinglass_tpu_torch.distributed.edge import EdgeOrchestrator
    from spinglass_tpu_torch.distributed.workpool import WorkerPool
    from spinglass_tpu_torch.kernels import sweeps as K
    from spinglass_tpu_torch.rl import ppo as ppo_mod

    launches = {mc.KERNEL_NAME: 0, "sparse_sweep": 0, "sparse_accept": 0}
    stats["dist_launches"] = launches
    info = multihost.initialize()
    check(info["process_count"] == 1 and info["backend"] == "nccl"
          and info["device"].startswith("cuda"),
          f"multihost.initialize(): {info}")
    mesh = pt_sharded.make_mesh()
    check(mesh.mesh_dim_names == ("replica",) and mesh.size() == 1,
          f"replica mesh {mesh}")
    problems = {"sk": sk_problem("cuda"),
                "ell": headline.sparse_bench_problem()}
    stats["dist_pt"] = {}
    for label, which, kw, kernel in DIST_PT:
        prob = problems[which]
        cfg = pt_mod.PTConfig(**kw)
        t0 = time.perf_counter()
        sh = pt_sharded.run(prob, cfg, mesh)
        t_first = time.perf_counter() - t0
        ref = pt_mod.run(prob, cfg)
        again = pt_sharded.run(prob, cfg, mesh)
        got = sh.metadata["kernel_launches"]
        eng = sh.metadata["engine"]
        _, _, sh_engine, _, sh_step = pt_sharded.SHARDED_CACHE.get(
            prob, ("run", graphs.config_key(cfg), id(mesh)))
        plain_step = graphs.PT_CACHE.get(prob, ("run",
                                                graphs.config_key(cfg)))[2]
        n_col = (sh_engine.inner.n_colors if kernel == "sparse_accept"
                 else 1)
        want = cfg.n_sweeps * n_col
        check(got.get(kernel) == want and sum(got.values()) == want,
              f"sharded PT {label}: engine {eng}, launches {got} "
              f"(expected {kernel} {want}); algorithm {sh.algorithm}")
        check(_same_pt(np, sh, ref) and _same_pt(np, again, ref),
              f"sharded PT {label} == pt.run on seed {cfg.seed} bit for bit "
              f"(best spins, energies, histories, slots, exchange rates; "
              f"first call {t_first:.3f} s with the capture, "
              f"{sh.metadata['capture_seconds']:.3f} s of it; a repeat "
              f"call replays); E {sh.best_energy:.4f}")
        launches[kernel] += got[kernel] + again.metadata[
            "kernel_launches"][kernel]
        stats["dist_pt"][label] = (cfg, sh_step, plain_step)
    # -- model-sharded sweeps ------------------------------------------------
    pj = pm_j_problem(DIST_N, 11, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    s0 = torch.where(torch.rand(DIST_R, pj.n_padded, device="cuda",
                                generator=gen) < 0.5, -1.0, 1.0)
    u = torch.rand(DIST_R, pj.n_padded, device="cuda", generator=gen)
    beta = torch.full((DIST_R,), 0.6, device="cuda")
    smesh = model_sharded.make_mesh()
    shard = model_sharded.shard_problem_rows(pj, smesh)
    t0 = time.perf_counter()
    s_sh, de_sh, cnt_sh = model_sharded.blocked_sweep_sharded(
        shard, smesh, s0, beta, u, block_size=SA_BLOCK)
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t0
    s_p, de_p, cnt_p = K.blocked_sweep(pj, s0, beta, u, block_size=SA_BLOCK)
    check(torch.equal(s_sh, s_p) and torch.equal(de_sh, de_p)
          and torch.equal(cnt_sh, cnt_p) and int(cnt_p.sum()) > 0,
          f"blocked_sweep_sharded at N={DIST_N}, R={DIST_R} (+-J, captured "
          f"with its {2 * pj.n_padded // SA_BLOCK} all-reduces: "
          f"{t_cap:.2f} s to warm up and capture) == kernels.sweeps"
          f".blocked_sweep on the same uniforms bit for bit "
          f"({int(cnt_p.sum())} flips)")
    s_sh2, _, _ = model_sharded.blocked_sweep_sharded(
        shard, smesh, s0, beta, u, block_size=SA_BLOCK)
    check(torch.equal(s_sh2, s_p), "blocked_sweep_sharded replayed again == "
          "the plain sweep")
    side = int(np.sqrt(DIST_N))
    jc = topology.grid_2d(side, side, dist="binary", seed=2)
    pc = IsingProblem.from_dense(jc, device="cuda")
    masks = K.color_masks_from_colors(topology.greedy_coloring(jc),
                                      pc.n_padded, device="cuda")
    sc, dec, cntc = model_sharded.colored_sweep_sharded(
        pc, smesh, masks, model_sharded.local_columns(s0, smesh), beta,
        model_sharded.local_columns(u, smesh))
    sp, dep, cntp = K.colored_sweep(pc, masks, s0, beta, u)
    check(torch.equal(sc, sp) and torch.equal(dec, dep)
          and torch.equal(cntc, cntp),
          f"colored_sweep_sharded on a {side}x{side} +-J grid, R={DIST_R} "
          f"({masks.shape[0]} colours) == kernels.sweeps.colored_sweep bit "
          f"for bit")
    stats["dist_model"] = (shard, smesh, s0, beta, u, pj, pc, masks)
    # -- data-parallel PPO -----------------------------------------------------
    problem, env_cfg, ppo_cfg = headline.rl_bench_setup(
        n_updates=DIST_PPO_UPDATES)
    histories, params, k1_ppo = [], [], 0
    for make in ("sharded", "plain"):
        if make == "sharded":
            init_fn, update_fn, _, _ = rl_sharded.make_sharded_ppo(
                problem, env_cfg, ppo_cfg, rl_sharded.make_mesh())
        else:
            init_fn, update_fn, _ = ppo_mod.make_ppo(problem, env_cfg,
                                                     ppo_cfg)
        l0 = build.launch_snapshot()
        cap = ppo_mod.CapturedUpdates(update_fn, init_fn(), 1)
        hist = []
        for _ in range(DIST_PPO_UPDATES):
            cap.replay()
            hist.extend(cap.read(1))
        histories.append(hist)
        params.append({k: v.detach().clone() for k, v in
                       cap.state.params.items()})
        got = build.launches_since(l0, update_fn.engine.kernel_names)
        if make == "sharded":
            k1_ppo = got[mc.KERNEL_NAME]
            launches[mc.KERNEL_NAME] += k1_ppo
            stats["dist_ppo"] = (update_fn, init_fn)
    want = DIST_PPO_UPDATES * ppo_cfg.rollout_len * env_cfg.sweeps_per_step
    check(k1_ppo == want, f"sharded PPO ({env_cfg.n_envs} envs, SK N="
          f"{problem.n_spins}): K1 {k1_ppo} launches through the sharded "
          f"engine ({want} expected)")
    check(histories[0] == histories[1] and all(
        torch.equal(params[0][k], params[1][k]) for k in params[1]),
          f"sharded PPO ({DIST_PPO_UPDATES} captured updates, the gather and "
          f"the env batch statistics inside) == make_ppo's updates: "
          f"metrics and parameters bit for bit; last mean best energy "
          f"{histories[0][-1]['mean_best_energy']:.3f}")
    # -- job pools: SA seeds from several threads through K1 -----------------
    pool_p = pm_j_problem(512, 12, "cuda")

    def job(seed):
        return anneal(pool_p, SAConfig(n_sweeps=200, n_replicas=64,
                                       seed=seed))

    seq = {s: job(s) for s in range(8)}
    l0 = build.launch_snapshot()
    c = JobCoordinator(n_workers=2).start()
    ids = c.map(job, list(range(8)), prefix="seed")
    ok = c.wait(timeout=300)
    res_c = c.results()
    c.shutdown()
    items = WorkerPool(4).map([lambda s=s: job(s) for s in range(8)],
                              timeout=300)
    k1_pools = _k1(mc, l0)

    def same(a, b):
        return (a.best_energy == b.best_energy
                and np.array_equal(a.best_spins, b.best_spins)
                and np.array_equal(a.energy_history, b.energy_history))

    check(ok and all(same(res_c[i], seq[s]) for s, i in enumerate(ids))
          and all(it.error is None and same(it.result, seq[s])
                  for s, it in enumerate(items))
          and all(r.metadata["engine"] == "cuda_fused" for r in seq.values()),
          f"JobCoordinator(n_workers=2) and WorkerPool(4): 8 SA seeds "
          f"(+-J N=512, R=64, 200 sweeps) through K1 from several threads "
          f"== each seed's call made alone, bit for bit; K1 {k1_pools} "
          f"launches")
    l0 = build.launch_snapshot()
    orch = EdgeOrchestrator(n_sweeps=200, n_replicas=16, seed=0)
    outs = [orch.submit(pool_p, prefer_backend=b) for b in ("sa", "pt", "sqa")]
    check(all(np.isfinite(o.best_energy) for o in outs)
          and orch.report()["n_jobs"] == 3,
          "EdgeOrchestrator on the card: " + ", ".join(
              f"{o.backend} on {o.node} E {o.best_energy:.1f} in "
              f"{o.runtime:.3f} s" for o in outs))
    launches[mc.KERNEL_NAME] += k1_pools + _k1(mc, l0)
    print(f"  distributed path launches: {launches} [{card}]")


# ---------------------------------------------------------------------------
# The host C++ routines (native): colourings and the ELL build
# ---------------------------------------------------------------------------

def native_slice(stats, card):
    """Phase 4 (native): the C++ library built from the checkout serves
    the colourings (plain and balanced) and build_ell at 100k spins, each
    bitwise equal to its numpy version; both times printed. Every other
    native call of the run must be the C++ path's too (checked at the
    end)."""
    from spinglass_tpu_torch import native
    from spinglass_tpu_torch.benchmarks.native_host import compare

    check(native.available() and native.BACKEND == "native",
          f"the native library is built and loaded "
          f"({os.path.relpath(native.library_path('g++'), HERE)})")
    before = dict(native.CALLS)
    res = compare(100_000)
    new = {k: v - before.get(k, 0) for k, v in native.CALLS.items()
           if v != before.get(k, 0)}
    want = {(fn, path): 1 for fn in ("greedy_coloring",
                                     "greedy_coloring_balanced", "build_ell")
            for path in ("native", "numpy")}
    check(new == want, f"each step once through C++ and once through numpy: "
                       f"{sorted(new.items())}")
    stats["native_numpy_calls"] = sum(new[k] for k in want if k[1] == "numpy")
    for name, r in res.items():
        check(r["same"], f"{name} at 100000 spins (sparse_random_graph_coo, "
                         f"degree 6, seed 42): native {r['native_s']:.4f} s, "
                         f"numpy {r['numpy_s']:.4f} s, bitwise equal "
                         f"[host: {os.cpu_count()} CPUs; {card}]")


def quality_gates_slice(torch, card):
    """Phase 4 (quality gates): ``sgt-torch quality-gates`` in process over
    every gate but suite_budget (the port's GPU tests: a run of their own,
    ``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``)."""
    from click.testing import CliRunner

    from spinglass_tpu_torch import cli
    from spinglass_tpu_torch.benchmarks.quality_gates import DEFAULT_GATES

    gates = [g for g in DEFAULT_GATES if g != "suite_budget"]
    print(f"  excluded: suite_budget (runs tests/test_torch_gpu.py in a "
          f"process of its own; run it apart)")
    out = CliRunner().invoke(cli.main, ["quality-gates", "--gates",
                                        ",".join(gates)])
    print("  " + out.output.replace("\n", "\n  ").rstrip())
    check(out.exit_code == 0 and f"{len(gates)}/{len(gates)} gates passed"
          in out.output, f"sgt-torch quality-gates: every gate passes "
          f"[{card}]")


def distributed_timing(torch, mc, stats, card):
    """Phase 5 (distributed): per super-step, the sharded PT's captured
    step against ``pt.run``'s at the same shapes, in turns (CUDA events
    around host replays), and the all-gather alone (a graph of 20); the
    model-sharded sweep's replay against the plain eager sweep; the sharded
    PPO's env steps/s against make_ppo's (captured updates in turns) and
    bench_rl's."""
    import numpy as np

    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.distributed import model_sharded, pt_sharded
    from spinglass_tpu_torch.kernels import sweeps as K
    from spinglass_tpu_torch.rl import ppo as ppo_mod

    rows = {}
    stats["dist_timing"] = rows
    for label, (cfg, sharded, plain) in stats["dist_pt"].items():
        gen = torch.Generator().manual_seed(1)
        ms = {"sharded": [], "pt.run": []}
        for _ in range(2):
            for name, st in (("sharded", sharded), ("pt.run", plain)):
                ms[name].append(_event_ms(torch, lambda st=st: st.replay(gen),
                                          10))
        r = cfg.n_replicas * cfg.n_chains
        x = torch.zeros(5, r, device="cuda")
        group = pt_sharded.make_mesh().get_group()
        coll = _graph_ms(torch, lambda: pt_sharded.gather_replicas(x, group,
                                                                   1), 20)
        rows[label] = dict(sharded=ms["sharded"], plain=ms["pt.run"],
                           gather_ms=coll)
        print(f"  PT super-step ({cfg.exchange_interval} sweeps), {label}: "
              f"sharded {' / '.join(f'{1e3 * v:.1f}' for v in ms['sharded'])}"
              f" us, pt.run {' / '.join(f'{1e3 * v:.1f}' for v in ms['pt.run'])}"
              f" us (in turns); the all-gather of [5, {r}] alone "
              f"{1e3 * coll:.1f} us = {100 * coll / np.mean(ms['sharded']):.2f}"
              f"% of the sharded super-step [{card}]")
    shard, smesh, s0, beta, u, pj, pc, masks = stats["dist_model"]
    sweep_ms = _event_ms(torch, lambda: model_sharded.blocked_sweep_sharded(
        shard, smesh, s0, beta, u, block_size=SA_BLOCK), 3)
    plain_ms = _event_ms(torch, lambda: K.blocked_sweep(
        pj, s0, beta, u, block_size=SA_BLOCK), 1)
    col_ms = _event_ms(torch, lambda: model_sharded.colored_sweep_sharded(
        pc, smesh, masks, s0, beta, u), 5)
    colp_ms = _event_ms(torch, lambda: K.colored_sweep(pc, masks, s0, beta, u),
                        5)
    rows["model"] = dict(blocked=sweep_ms, blocked_plain=plain_ms,
                         colored=col_ms, colored_plain=colp_ms)
    print(f"  model-sharded sweeps at N={DIST_N}, R={DIST_R}: blocked (one "
          f"captured sweep, {pj.n_padded // SA_BLOCK} blocks) {sweep_ms:.2f} "
          f"ms, the plain eager blocked sweep {plain_ms:.2f} ms; coloured "
          f"(eager, {masks.shape[0]} colours) {col_ms:.3f} ms, plain "
          f"{colp_ms:.3f} ms [{card}]")
    update_fn, init_fn = stats["dist_ppo"]
    problem, env_cfg, ppo_cfg = headline.rl_bench_setup(n_updates=8)
    _, plain_update, _ = ppo_mod.make_ppo(problem, env_cfg, ppo_cfg)
    caps = {"sharded": ppo_mod.CapturedUpdates(update_fn, init_fn(), 8),
            "make_ppo": ppo_mod.CapturedUpdates(
                plain_update, ppo_mod.make_ppo(problem, env_cfg, ppo_cfg)[0](),
                8)}
    rates = {k: [] for k in caps}
    steps = 8 * ppo_cfg.rollout_len * env_cfg.n_envs
    for _ in range(2):
        for name, cap in caps.items():
            cap.replay()
            cap.read(1)
            t0 = time.perf_counter()
            for _ in range(8):
                cap.replay()
            cap.read(8)
            rates[name].append(steps / (time.perf_counter() - t0))
    rows["ppo"] = rates
    b = stats.get("bench_rl", {}).get("value", float("nan"))
    print(f"  PPO env steps/s, 8 captured updates of {env_cfg.n_envs} envs "
          f"(N={problem.n_spins}), in turns: sharded "
          f"{' / '.join(f'{v:.1f}' for v in rates['sharded'])}, make_ppo "
          f"{' / '.join(f'{v:.1f}' for v in rates['make_ppo'])}; bench_rl "
          f"(phase 4) {b:.1f} [{card}]")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "spinglass_tpu_torch")):
        print("FAIL: spinglass_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats: dict = {"profiles": {}}
    t_start = time.perf_counter()
    try:
        from spinglass_tpu_torch.benchmarks.headline import device_description
        global build  # the launch ledger's module, read by every phase
        from spinglass_tpu_torch.kernels import build
        from spinglass_tpu_torch.kernels import metropolis_cuda as mc
        from spinglass_tpu_torch.kernels import sparse_cuda as sc

        card = device_description()
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; {TF32_NOTE}")
        print("phase 1: build (one nvcc per source, all at once)")
        t0 = time.perf_counter()
        libs = build.build_many(list(KERNELS))
        print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
        for lib in libs:
            print(f"  {os.path.relpath(lib, HERE)}")
            with open(lib + ".log") as f:
                for line in f:
                    if "Compiling entry" in line:  # the kernel's template
                        print("    " + line.split("'")[1][-44:])
                    elif ("registers" in line or "spill" in line
                          or "seconds" in line):
                        print("    " + line.strip())
        from spinglass_tpu_torch import native

        t0 = time.perf_counter()
        native.CALLS.clear()
        check(native.available(), f"native (host C++) built and loaded in "
                                  f"{time.perf_counter() - t0:.2f} s")
        for name in (mc.KERNEL_NAME, mc.PIPELINED_KERNEL, mc.INTERLEAVED_KERNEL,
                     mc.FOLDED_KERNEL):
            mc.load_kernel(name)
        sc.load_kernels()
        sc.load_accept_kernel()
        from spinglass_tpu_torch.kernels import cluster_cuda as cc

        cc.load_kernel()
        cc.load_bonds_kernel()
        for block in (128, 256):
            occ = mc.cluster_occupancy(4096, 1024, block)
            print(f"  K1 cluster kernel at Np=4096, R=1024, block {block}: "
                  f"{occ['clusters_launched']} clusters of 8 thread blocks "
                  f"launched, {occ['max_active_clusters']} resident at once, "
                  f"{occ['smem_bytes_per_block']} bytes of shared memory per "
                  f"block")
        # each cluster kernel's shared memory as its source lays it out,
        # against the wrapper's shape rule (metropolis_cuda.*_smem_bytes)
        for name, smem in ((mc.KERNEL_NAME, mc.cluster_smem_bytes),
                           (mc.PIPELINED_KERNEL, mc.pipelined_smem_bytes),
                           (mc.INTERLEAVED_KERNEL, mc.cluster_smem_bytes),
                           (mc.FOLDED_KERNEL, mc.folded_smem_bytes)):
            lib = mc.load_kernel(name)
            for block in (128, 256):
                edge = mc.cluster_envelope(name, block)
                got = [getattr(lib, f"sgt_{name}_smem")(n, block)
                       for n in (4096, edge, edge + block)]
                check(got == [smem(n, block) for n in (4096, edge,
                                                       edge + block)],
                      f"{name} cluster kernel, block {block}: {got[0]} bytes "
                      f"per thread block at Np=4096, n_pad up to {edge} "
                      f"({got[1]} bytes; {edge + block}: {got[2]} > "
                      f"{mc.SMEM_PER_BLOCK})")
        for name, phase in (
                ("phase 2: parity with the twins (K1)", lambda: phase_parity(torch, mc, stats)),
                ("phase 2: parity with the twins (K2, K3)", lambda: sparse_parity(torch, stats)),
                ("phase 2: parity with the twins and K1 (K5, K6, K7)",
                 lambda: variant_parity(torch, mc, stats)),
                ("phase 2: parity with the twin, K3 and K2 (K4)", lambda: accept_parity(torch, stats)),
                ("phase 2: parity with the twin (overlap) and K4 on the "
                 "3-D lattice", lambda: overlap_parity(torch, stats)),
                ("phase 2: parity with the twin (sa_track) at the SA "
                 "shapes", lambda: track_parity(torch, stats)),
                ("phase 2: parity with the twin (pt_latch) on the TTT "
                 "state", lambda: latch_parity(torch, stats)),
                ("phase 2: parity with the plain versions (C2, C1)",
                 lambda: cluster_parity(torch, stats)),
                ("phase 2: env.step through K1, K2 and K4 against the twins (RL)",
                 lambda: rl_parity(torch, mc, stats)),
                ("phase 2: DQN steps through K1, K2 and K4 against the twins "
                 "(RL training)", lambda: dqn_parity(torch, mc, stats)),
                ("phase 2: K1 with a problem axis against single launches "
                 "and the twin (batch)", lambda: batch_parity(torch, mc, stats)),
                ("phase 2: an SQA stage through K1 against the twin "
                 "(research)", lambda: research_parity(torch, mc, stats)),
                ("phase 3: in-kernel Philox (K1)", lambda: phase_philox(torch, mc, stats)),
                ("phase 3: in-kernel Philox (K2)", lambda: sparse_philox(torch)),
                ("phase 4: dense SA slice", lambda: phase_slice(torch, mc, stats)),
                ("phase 4: sparse SA, TTT and PT slice", lambda: sparse_slice(torch, stats)),
                ("phase 4: dense SA slice through K5, K6, K7",
                 lambda: variant_slice(torch, mc, stats)),
                ("phase 4: PT at R=4096 through K4 and through K3",
                 lambda: accept_slice(torch, stats)),
                ("phase 4: the RL path (rollout, PPO, sparse env, evaluation)",
                 lambda: rl_slice(torch, mc, stats)),
                ("phase 4: the RL training path (DQN, pipeline, train-rl, gym, "
                 "captured evaluation)",
                 lambda: rl_training_slice(torch, mc, stats, card)),
                ("phase 4: the captured drivers against the eager loop",
                 lambda: captured_parity(torch, mc, stats)),
                ("phase 4: the problem path (encoders, solve, the CLI)",
                 lambda: problems_slice(torch, mc, stats, card)),
                ("phase 4: the drivers' remaining paths (checkpoint/resume, "
                 "cluster moves, tune_ladder, the compact engine, the CLI)",
                 lambda: drivers_slice(torch, mc, stats, card)),
                ("phase 4: batch and adaptive annealing, the operations "
                 "commands", lambda: batch_slice(torch, mc, stats, card)),
                ("phase 4: the research layer (SQA, PIMC, QEC, MSHO, AQIA, "
                 "LESD, meta, federated, Pareto, unified, breakthrough, "
                 "meta-RL)", lambda: research_slice(torch, mc, stats, card)),
                ("phase 4: the distributed layer on a one-rank NCCL group "
                 "(sharded PT through K1, K2 and K4, model-sharded sweeps, "
                 "data-parallel PPO, the job pools, edge)",
                 lambda: distributed_slice(torch, mc, stats, card)),
                ("phase 4: sgt-torch quality-gates",
                 lambda: quality_gates_slice(torch, card)),
                ("phase 4: the host C++ routines (native: colourings and "
                 "build_ell at 100k spins against numpy)",
                 lambda: native_slice(stats, card)),
                ("phase 5: timing (K1)", lambda: phase_timing(torch, mc, stats, card)),
                ("phase 5: timing (K2, K3)", lambda: sparse_timing(torch, stats, card)),
                ("phase 5: timing (K5, K6, K7)", lambda: variant_timing(torch, mc, stats, card)),
                ("phase 5: timing (K4, PT at R=4096 three ways)",
                 lambda: accept_timing(torch, stats, card)),
                ("phase 5: timing (overlap: an ea3d-shaped pt.run, the "
                 "kernel against its plain version)",
                 lambda: overlap_timing(torch, stats, card)),
                ("phase 5: timing (sa_track: SA anneals at the cells' "
                 "shapes, the kernel against its bound, its twin and "
                 "torch.where)", lambda: track_timing(torch, stats, card)),
                ("phase 5: timing (pt_latch: no copy and a hit, against "
                 "its bounds and its twin)",
                 lambda: latch_timing(torch, stats, card)),
                ("phase 5: timing (RL: bench_rl, profile_rl)",
                 lambda: rl_timing(torch, stats, card)),
                ("phase 5: timing (RL training: bench_dqn, profile_dqn, the "
                 "captured evaluation)",
                 lambda: rl_training_timing(torch, stats, card)),
                ("phase 5: timing (the drivers' remaining paths, C2, C1)",
                 lambda: drivers_timing(torch, stats, card)),
                ("phase 5: timing (captured drivers against the eager loop)",
                 lambda: captured_timing(torch, stats, card)),
                ("phase 5: timing (the batch slice: stacked K1, process, "
                 "adaptive_anneal)", lambda: batch_timing(torch, mc, stats,
                                                          card)),
                ("phase 5: timing (research: K1 at the Trotter shape, the "
                 "profiles of SQA, PIMC, AQIA and LESD)",
                 lambda: research_timing(torch, mc, stats, card)),
                ("phase 5: timing (research, sparse SQA at the ea2d-l80.sqa "
                 "shape: a carried run's launches, K2 at [128000, 128] "
                 "against its twins after a field rewrite)",
                 lambda: sqa_sparse(torch, stats, card)),
                ("phase 5: timing (distributed: the sharded PT super-step "
                 "and its all-gather, the model-sharded sweeps, the sharded "
                 "PPO)", lambda: distributed_timing(torch, mc, stats, card))):
            print(name)
            t0 = time.perf_counter()
            phase()
            print(f"  ({time.perf_counter() - t0:.1f} s)")
        # every native call but the native phase's numpy comparisons went
        # through the C++ library
        numpy_calls = sum(v for (_, path), v in native.CALLS.items()
                          if path == "numpy")
        check(numpy_calls == stats["native_numpy_calls"],
              f"native: {sum(native.CALLS.values()) - numpy_calls} calls "
              f"through C++ over the run, numpy only for the "
              f"{numpy_calls} comparisons")
    except Exception:  # report any failure of any phase, then exit non-zero
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1
    finally:
        if "spinglass_tpu_torch.distributed.multihost" in sys.modules:
            sys.modules["spinglass_tpu_torch.distributed.multihost"].shutdown()
    rows = [(mc.KERNEL_NAME, stats["launches"], stats["max_abs_err"],
             stats["ms"], stats["plain_ms"]),
            ("sparse_sweep", stats["k2_launches"], stats["k2_max_abs_err"],
             stats["k2_ms"], stats["k2_plain_ms"]),
            ("sparse_thresholds", stats["k3_launches"], stats["k3_max_abs_err"],
             stats["k3_ms"], stats["k3_plain_ms"]),
            ("sparse_accept", stats["k4_launches"], stats["k4_max_abs_err"],
             stats["k4_ms"], stats["k4_plain_ms"])]
    err, us, twin_us = (stats["variant_err"], stats["variant_us"],
                        stats["variant_twin_us"])
    for name, labels in ((mc.PIPELINED_KERNEL, ("K5",)),
                         (mc.INTERLEAVED_KERNEL, ("K6x2", "K6x4")),
                         (mc.FOLDED_KERNEL, ("K7",))):
        # K6's times are those of 2 chains; its launches are both runs'
        rows.append((name, stats["variant_launches"][name],
                     max(err[lab] for lab in labels), us[labels[0]] / 1e3,
                     twin_us[labels[0]] / 1e3))
    for name, key in (("sw_labels", "c1"), ("sw_bonds", "c2")):
        k_ms, k_plain_ms, k_bound, k_by = stats[key]
        rows.append((name, 0, stats[f"{key}_max_abs_err"], k_ms, k_plain_ms))
        stats["bounds"][name] = (k_bound, k_by)
    o_ms, o_plain_ms, o_bound, o_by = stats["overlap"]
    rows.append(("replica_overlap", stats["overlap_launches"],
                 stats["overlap_max_abs_err"], o_ms, o_plain_ms))
    stats["bounds"]["replica_overlap"] = (o_bound, o_by)
    t_ms, t_plain_ms, t_bound, t_by = stats["track"]
    rows.append(("sa_track", stats["track_launches"], 0.0, t_ms, t_plain_ms))
    stats["bounds"]["sa_track"] = (t_bound, t_by)
    l_ms, l_plain_ms, l_bound, l_by = stats["latch"]
    rows.append(("pt_latch", stats["latch_launches"], 0.0, l_ms, l_plain_ms))
    stats["bounds"]["pt_latch"] = (l_bound, l_by)
    b4 = stats["bounds"]["sparse_accept"][0]
    print(f"K4 {1e3 * stats['k4_ms']:.1f} us per sweep is "
          f"{100 * b4 / stats['k4_ms']:.1f}% of its bound's rate [{card}]")
    print(f"total {time.perf_counter() - t_start:.1f} s (build included)")
    # no single PyTorch call computes any of these functions (a sequential
    # sweep, a coloured sweep with accept, Philox thresholds, cluster
    # labels): library_ms is null; the yardsticks above time the field work
    # alone. launches: those of the SA / PT / variant runs above plus the RL
    # path's (bench_rl and the two sparse PPO runs; the captured DQN runs,
    # the pipelines, train-rl, the gym episode and learning_report of the RL
    # training path), the problem path's (its
    # solves and the command line's), the drivers' remaining paths' (the
    # uninterrupted runs of (a) and (b), the cluster-move runs of (c)) and
    # the batch slice's (the stacked runs of the three processors and the
    # eager loop, adaptive_anneal's three runs, the health micro-anneal),
    # each the count of its own call
    rl = stats["rl_launches"]
    prob = stats["problem_launches"]
    drv = stats["driver_launches"]
    bat = stats["batch_launches"]
    res = stats["research_launches"]
    dst = stats["dist_launches"]
    print(f"RL path launches: {rl}; problem path launches: {prob}; drivers' "
          f"paths launches: {drv}; batch slice launches: {bat}; research "
          f"path launches: {res}; distributed path launches: {dst}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"spinglass_tpu_torch/csrc/{name}.cu",
        "replaces": KERNELS[name],
        "launches": (launches + rl.get(name, 0) + prob.get(name, 0)
                     + drv.get(name, 0) + bat.get(name, 0) + res.get(name, 0)
                     + dst.get(name, 0)),
        "launches_rl": rl.get(name, 0),
        "launches_problems": prob.get(name, 0),
        "launches_drivers": drv.get(name, 0),
        "launches_batch": bat.get(name, 0),
        "launches_research": res.get(name, 0),
        "launches_distributed": dst.get(name, 0), "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": stats["bounds"][name][0],
        "bound_by": stats["bounds"][name][1], "library_ms": None}
        for name, launches, err, ms, plain_ms in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
