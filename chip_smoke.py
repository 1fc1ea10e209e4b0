#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (any failure exits nonzero; no result line is printed then):

1. build    — prints the card's name and power limit, compiles the three
              CUDA kernels (``gain_reduce``, ``swa_attention`` and
              ``fused_ce``, one nvcc per source, started together) from
              the sources under ``src/repro_torch/kernels/*/csrc/`` for
              sm_90a, and prints nvcc's register/shared-memory/spill
              report.
2. kernel   — holds ``gain_reduce`` against its plain PyTorch version and
              against the exact (float64) sum on the card, at the fleet's
              (64, 32), the m=4096 fleet's (4096, 32), one (1, 2^26) row
              and the ragged (64, 33), (4096, 31) and (3, 1_000_003), in
              fp32 and bf16, each aligned and one element off alignment;
              integer-valued inputs must come out exact, and a repeated
              launch bitwise equal; an input that requires grad raises.
              Under ``torch.func.vmap`` over 16 lanes of (64, 32) (and
              4 × 4 nested) the wrapper launches once over the folded
              1024 rows, bitwise equal to the kernel lane by lane and
              within the tolerance of the plain version.
3. slice    — serves the n=32, m=64, N=32 tiered fleet with its metered
              tiers gated by ``gain_quadratic(kernel=true)`` through the
              hybrid dispatch for 200 rounds, with the launch counter set
              to 0 just before and read just after: exactly one kernel
              launch per round, finite losses, a falling loss, and the
              first 10 rounds equal to the same session on the CPU.
   fleet adaptive — the served fleet's default, ``TIERED_M64_ADAPTIVE``
              (budget_window / budget_dual controllers on the metered
              tiers), on the same problem and batches for 200 rounds:
              rounds/s beside [slice]'s, each metered tier's bytes per
              agent and round over the last 50 rounds against its wire
              budget, a falling loss, and the first 10 rounds equal to
              the CPU session's (decisions exactly; metrics and
              controller rows within rtol 1e-4).
   random   — the port's threefry (``repro_torch.random``): ``bits``,
              ``uniform`` and ``split`` over 2^20 counters and the
              channels' ``fold_in(fold_in(PRNGKey(seed), step), uid)``
              then ``uniform`` over 240 × 64 (step, uid) pairs, each word
              equal to the CPU's.
   fleet lossy — ``TIERED_M64_ADAPTIVE_LOSSY`` (20 % Bernoulli loss with
              staleness boost on the metered tiers) for 240 rounds: the
              first 10 rounds against the same step on the CPU from the
              same state (decisions, deliveries and staleness exactly,
              floats and controller rows within rtol 1e-4), each metered
              tier's delivered bytes per agent and round over the last
              120 rounds within 15 % of its budget, and the final J under
              half the initial J (benchmarks/lossy_channels.py's claims
              for one run); the delivered byte fraction and rounds/s.
   fleet lossy quadratic — ``TIERED_M64_QUADRATIC`` with that loss on
              its metered tiers, 240 rounds: exactly 240 ``gain_reduce``
              launches, the CPU check, and each tier's budget printed
              (a fixed λ misses under loss).
   fleet delayed — ``TIERED_M64_ADAPTIVE_DELAYED`` (geometric latency,
              mean lag 2, depth 6, discount 0.5), 240 rounds: the CPU
              check, no payload applied past ``max_lag``, each metered
              tier's arrived bytes within 15 % of its budget (the
              discounted ``agent_bytes`` printed beside them); then the
              fixed-λ ``TIERED_M64_DELAYED`` and ``..._NAIVE``: tail loss
              and wire bytes, printed.
   fleet churn — ``TIERED_M64_DELAYED`` under ``churn_schedule(net,
              240)``: ``num_active`` equal to the schedule's count in
              every round, fewer wire bytes than without churn, and the
              CPU check over rounds 0–10 and 55–65 (the joins at 60).
   dispatch — ``TIERED_M64_QUADRATIC`` and ``TIERED_M64_ADAPTIVE_LOSSY``
              under the ``switch`` and ``unroll`` paths: 2 rounds (4
              until [mesh]'s seq and inner jobs needed the time), each
              from the ``hybrid`` path's state before it, held to
              hybrid's round under ROADMAP's parity contract (decisions,
              deliveries and staleness exactly but at a gain on its
              threshold; floats within 1e-5; EF memory, the delay line
              and the parameters also one rounding step of the wire
              format apart, but only at an entry of g + ef on a
              rounding midpoint, counted); ``gain_reduce`` launched
              once per kernel-gated agent per round (56 for the
              quadratic fleet, counted from its config); each path's
              rounds/s.
   frontier — benchmarks/tiered_m64.py's frontiers: each TIER_MIXES fleet
              over its 16 λ scales, 40 rounds of one ``torch.func.vmap``ped
              step on the [slice] problem and batches: lanes 0 and 11
              against the plain step pinned at their scale, every round
              from the lane's state; every lane's first 10 rounds against
              the same batched step on the CPU; every lane learns;
              lane-rounds/s.  [frontier quadratic]: TIERED_M64_QUADRATIC
              on the same grid, exactly one ``gain_reduce`` launch per
              round (16 × 64 rows), the same checks.  [frontier lossy]:
              benchmarks/lossy_channels.py's budget × severity grid on
              TIERED_M64_ADAPTIVE_LOSSY, 240 rounds: the severity-0 lanes
              deliver every payload, the lanes' channel draws are equal
              in every round, each lane's metered tiers' delivered bytes
              over the last 120 rounds within 15 % of their scaled
              budgets.  [frontier drifting]: benchmarks/async_rounds.py's
              drifting target (amplitude 2, period 16) on
              TIERED_M64_DELAYED over a λ × lag grid, 240 rounds.
   sim      — the paper's closed-form simulator: the five figure
              drivers (``repro_torch.figures``) at full trials, each
              asserting its claims, the README Quickstart's λ loop, and
              one sweep at the fleet's size (TIERED_M64_CFG, 10 λs of
              gain_estimated and 10 of gain_exact, 512 trials): ms per
              sweep, and its first 8 trials against the CPU on the same
              batches (decisions exactly but at a gain within 1e-4 of its
              threshold, J_traj within rtol 1e-4).
   durable  — ``TIERED_M64_QUADRATIC`` served for 100 rounds with a
              checkpoint every 50 (``SessionOptions``, under
              ``chiprun_out/durable``), then a fresh session that resumes
              from the latest checkpoint and serves 100 more: every state
              leaf bitwise an unbroken 200-round run's on the same (seed +
              1, k) batches, the rollup's counters monotone and equal to
              the unbroken run's, one restart, exactly 200 ``gain_reduce``
              launches across the lineage; the checkpoint's bytes, save
              and restore ms (median of 5), the sessions' build ms, and
              rounds/s with and without checkpoints.
   kill     — ``faults.kill_and_resume`` on the card with CI's numbers
              at a third of the rounds
              (the adaptive mix, 200 rounds, SIGKILL at round 100, a
              checkpoint every 50, a log every 20) through ``python -m
              repro_torch.launch.serve --fleet``: the lineage's checks
              (restart recorded, round target reached, counters monotone,
              the resumed process past its checkpoint) and the record
              (``recovery_s``, rounds at the kill, resume round, wire
              bytes).
   telemetry — ``TIERED_M64_QUADRATIC`` in thread mode (``start()`` …
              ``stop()``) behind a TelemetryServer on 127.0.0.1:
              ``/stats.json`` and ``/metrics`` scraped while rounds run,
              ``rounds`` growing between scrapes; round 40 stalled for
              1 s under a 0.5 s watchdog: exactly one ``"stall"`` event;
              the first metro agent crashed by a ``FaultInjector`` for
              rounds 60–139: ``agent_tx`` 0 in each.
   shard    — the fleet-sharded step (``repro_torch.sharding``) over 4
              gateway ranks that ``repro_torch.launch.mesh.spawn``
              starts on the backend ``choose_backend`` picks (gloo with
              one card: the ranks share it), each serving its 16 agents
              through ``build_linreg_fleet_session(mesh=)``: (a)
              ``TIERED_M64_QUADRATIC`` for 50 rounds (100 until [mesh]'s
              moe, vlm and audio jobs needed the time, 200 until [mesh]
              needed the time), each rank
              launching ``gain_reduce`` once per round and the payload
              ``all_reduce`` running once per round; (b)
              ``TIERED_M64_ADAPTIVE_LOSSY`` for 240 rounds, its
              delivered bytes against the budgets printed; each round of
              both, gathered, held to the single-process hybrid step on
              the card from the same state (``_hold_round``) and the
              ranks' parameters bitwise equal; (c) the counted
              ``all_reduce`` operand bytes of one step equal at m = 64
              and m = 1024, and equal to the payload (n × 4 bytes) plus
              the packed scalars; (d) sketch-native: fewer operand bytes
              than the dense gateway at n = 4096, and the dense
              gateway's params within 1e-5 at n = 6; sharded rounds/s
              beside [slice]'s and [fleet lossy]'s, and where a sharded
              round's time goes: a round's two ``all_reduce`` calls
              alone (on CUDA tensors, and staged through host copies),
              and the unsharded [slice] session run on every rank at
              once (the card time-sliced).  [shard frontier]:
              the quadratic frontier (16 lanes, 40 rounds) sharded: one
              ``gain_reduce`` launch and one payload ``all_reduce`` per
              round on every rank, lanes 0 and 11 held to the unsharded
              frontier step from the same stacked state every round;
              rounds/s beside [frontier quadratic]'s.
   mesh     — the LM train step over a (data 2, model 2) mesh of 4 gloo
              ranks sharing the card (``build_train_step(mesh=...)``,
              ``int8+ef``, sgd, fp32, 2 agents × 2 × 1024 tokens, weights
              from seed 0; each agent's gradient, EF memory, payload
              and aggregate the rank's model blocks): llama3.2-3b at
              full width (every head, kv head, ff column and vocab row
              split over model) cut to 2 layers (4 until the moe, vlm
              and audio jobs needed the time), 2 steps with fsdp off,
              1 with fsdp on, 1 with ``seq_shard`` (each model rank's
              chunk of the sequence; 2 each until the moe, vlm and audio
              jobs needed the time) and 1 with ``fleet_shard=True``;
              then smollm-135m at 4 of its 30 layers (8 until the
              hybrid and ssm jobs needed the time, 30 until the moe,
              vlm and audio jobs did; its 9/3 heads whole, ff
              and vocab split), fsdp on, 1 step, and 1 step with
              ``inner_batch_shard`` (each model rank's row of an agent's
              two, the weights gathered whole at use); then per-agent
              policies on smollm at 2 of its 30 layers, m = 4 (two
              agents on each data slice) × 1 × 1024 tokens, 1 step each
              (2 steps until the seq and inner jobs needed the time, 15
              layers until the moe, vlm and audio jobs did, 4 until the
              hybrid and ssm jobs did): the
              four-tier
              tuple (``always``,
              ``gain_lookahead(lam=0.01)|fp16``, ``…|int8+ef``,
              ``…|topk(0.05)|int8+ef``) with fsdp on, and
              ``gain_lookahead(lam=0.01)|int8+ef @ delay(max_lag=2)``;
              then the other families, 1 step each: ``moe``,
              mixtral-8x7b at full width cut to 1 layer on a second
              mesh of the same ranks, (data 1, model 4), m = 1 × 2 ×
              1024 (each rank 2 of the 8 experts; the router's logits
              made whole before the top-2), its dropped (token, k) pairs
              per layer recorded on every rank and in one process and
              equal; ``vlm``, phi-3-vision cut to 2 layers (4 until the
              hybrid and ssm jobs needed the time), m = 2 × 1 ×
              (576 patches + 512 tokens); ``audio``, whisper-medium cut
              to 4 + 4 layers, m = 2 × 1 × (1500 frames, 448 tokens)
              (the GELU MLPs and the cross-attention on the rank's
              heads and ``ff`` columns, the table whole); ``hybrid``,
              zamba2-1.2b at full width cut to 6 of its 38 layers (one
              group: six Mamba2 layers and the shared attention block),
              m = 2 × 1 × 512 ([hybrid train]'s rows; each Mamba2 layer
              on the rank's 32 of 64 heads, its gated norm's sum over
              "model", the shared block on 16 of 32 heads); ``ssm``,
              xlstm-350m at full width cut to 2 of its 24 layers (one
              mLSTM/sLSTM pair), m = 2 × 1 × 512 ([xlstm train]'s rows,
              2 mLSTM chunks; the mLSTM on the rank's 2 of 4 heads, the
              sLSTM's recurrence whole on every rank, its weights
              gathered once a forward).
              Rank 0 first runs the single-process step of each on the
              card; every job is held to it (first step's parameters per
              element, a rounding step where an agent's input lies at a
              midpoint of its wire format counted; decisions and
              deliveries equal and loss, gain and |g| within 1e-4 every
              step; the last step's parameters in L2; after the first
              step the EF memory, the controller and channel rows and the
              delay line's payloads of every agent, gathered leaf by
              leaf, within 1e-4 of each agent's max|g|), and each rank
              launches ``swa_attention`` 2 × layers times (zamba2: 2 ×
              its shared-block sites; xlstm: never) and ``fused_ce``
              twice a step, as the single-process step.
              Prints per rank the ms per step beside the single-process
              step's, the collectives per step by kind and mesh axes
              with their operand and wire bytes, the peak memory and the
              bytes held at rest.
   mesh serve — prefill and decode over the same (data 2, model 2) mesh
              of 4 gloo ranks, in [mesh]'s spawn after its jobs
              (``build_prefill_step(mesh=...,
              cache_len=...)``, ``build_serve_step(mesh=...)``):
              llama3.2-3b at full width cut to 2 of its 28 layers
              (28 until [mesh]'s seq and inner jobs needed the time, 14
              until the moe, vlm and audio jobs did), fp32,
              weights from seed 0, each rank drawing only its blocks; B 4
              × 1024 prompt tokens (2 requests on each data slice), then
              4 decode steps (16 until the seq and inner jobs needed the
              time, 8 until the moe, vlm and audio jobs did)
              teacher-forced on the single-process greedy
              tokens, the cache on the rank's kv heads (``decode_heads``),
              then with the prefill under ``seq_shard`` (each model
              rank's chunk of the prompt) filling the cache in either
              layout (``decode_heads``; ``cache_seq_shard``: its slice
              of the 1028 positions, flash-decoding; after a
              tensor-parallel prefill too until PR 28's jobs needed the
              time); mixtral-8x7b cut
              to 2 layers, B 4 × 1024 then 4 steps, ``decode_heads``
              (each rank 4 of the 8 experts, the batch's rows gathered
              over data before routing); whisper-medium cut to 4 + 4
              layers, one encode of 4 × 1500 frames (the cross K/V on
              the rank's heads) then 4 decoder tokens from token 0;
              zamba2-1.2b cut to 6 layers, B 4 × 64 prompt tokens
              replayed through the rank's decode step, then 4 steps,
              the shared block's cache on the rank's kv heads and on its
              positions (``cache_seq_shard``), the Mamba2 states on its
              heads; xlstm-350m cut to 2 layers, B 4 × 64 replayed then
              4 steps, the mLSTM states on the rank's heads.
              Rank 0 first runs each run's
              single-process prefill and greedy decode on the card; the
              prefill's logits and each step's are held to it within
              1e-4 + 1e-4·|ref| ([lm]'s card-against-CPU tolerance), and
              the greedy tokens equal but where the reference's top two
              lie within that tolerance (counted).  One ``swa_attention``
              launch per decoder layer per prefill per rank (whisper's
              encode and the zamba2 and xlstm replays none), none per
              decode step.
              Prints ms per prefill and per decode step beside the
              single-process ones, the collectives of a prefill and of a
              decode step by tag, and each rank's peak.
4. swa      — holds ``swa_attention`` against its plain version on the
              card in fp32 (2e-5) and bf16 (3e-2): the served shapes
              (with the moe, hybrid and vlm families', and hd 32), one
              hd = 128 shape, whisper's and phi-3-vision's training
              shapes, the [mesh] ranks' heads (llama's (2, 1024, 12, 4,
              128), mixtral's at model 4 (2, 1024, 8, 2, 128) W 4096,
              phi-3-vision's at model 2 (1, 1088, 16, 16, 96) and (2,
              1088, 16, 16, 96), whisper's decoder (1, 448, 8, 8, 64),
              zamba2's shared block at model 2 (1, 512, 16, 16, 64)),
              the JAX tests' S × W grid and the tensor-core
              tiles' edges (S = 1000 at hd = 128 and 96, S = 77 with W =
              5 at hd = 64 and 32); every head dim of the kernel (32, 64,
              96, 128) in both dtypes; hd 48, which has no instance,
              raises on the card and launches nothing; a
              repeated launch is bitwise equal, a head-major tensor viewed
              in the model layout gives the contiguous tensor's result,
              and inputs one element off the 16-byte alignment (plain loads
              instead of cp.async) the aligned inputs' result.  The
              Function's gradients at the served shape match autograd
              through the plain version, and ``torch.func.vmap`` over 3
              slices is ONE launch, bitwise equal to a loop of three.
   ce       — holds ``fused_ce`` against its plain version on the card at
              every family's train loss's shape (moe, hybrid, xlstm,
              whisper, vlm) and every [mesh] rank's loss (llama's
              vocabulary block (2048, 3072, 64128), mixtral's at model 4
              (2048, 4096, 8000), phi-3-vision's at model 2 (512, 3072,
              16032), whisper's whole table (448, 1024, 51865),
              zamba2's and xlstm's at model 2 (512, 2048, 16000) and
              (512, 1024, 25152)), the
              tensor-core
              tiles' edges (T, D, V) ∈ {(129, 100, 129),
              (1000, 100, 50257), (257, 200, 49153)} and over
              T ∈ {64, 1000, 8192}, D ∈ {64, 576, 3072}, V ∈ {7, 1000,
              49152, 50257, 128256}, fp32 and bf16 (1e-5 + 1e-5·|plain|:
              fp32 in 3×TF32, bf16 products exact, sums in other orders),
              labels at 0, V − 1 and on tile edges; a repeated launch is
              bitwise equal, a strided x gives the contiguous x's result,
              the Function's (dx, dtable) match autograd through the
              plain version, and both vmap cases (shared table, per-agent
              tables) are one launch each and match a loop.
5. lm       — serves smollm-135m at full width and depth (30 layers,
              d 576, vocab 49152, fp32, weights from seed 0) through the
              serving CLI's prefill and greedy decode: (a) batch 4,
              prompt 1024, 32 tokens, plain causal; (b) the
              long-context variant (W = 4096), batch 1, prompt 6000, 16
              tokens.  Each: the counter shows 30 ``swa_attention``
              launches in the prefill and none in decode, finite logits,
              prefill ms, decode ms per step and tokens/s, and decode
              against a fresh prefill of the same tokens.  Then the same
              weights at 256 tokens on the card and on the CPU: prefill
              logits within 1e-4, the 16 greedy tokens equal.
   train    — trains smollm-135m at full width and depth (fp32, weights
              from seed 0) through the training CLI's `build_train_step`: m = 4
              agents, global batch 8 × 1024 tokens, ``gain_lookahead(lam=
              0.01)|int8+ef``, sgd lr 0.05; 3 warm-up and 6 timed steps.
              Each step launches ``fused_ce`` twice (the agents' losses,
              the lookahead probe) and ``swa_attention`` 60 times (30
              layers, twice); ms per step, tokens/s, the losses, num_tx,
              peak memory; every loss finite and the loss on the first
              batch lower after the 9 steps.  Then one step at 2 layers
              and full width on the card and on the CPU (64 tokens an
              agent): loss and
              grad_norm within 1e-4 relative, params within 1e-4 of each
              leaf's largest value, the same decisions; the peak memory
              may exceed the earlier runs' 36.75 GB by at most 1 %.
   dryrun   — the dry-run against the card: [train]'s step once more
              under the cost counter (``repro_torch.analysis.cost``),
              its flops, HBM bytes and device ops equal to the ``meta``
              trace of the same plan (``lower_for``); the step's counted
              TFLOP, ``model_flops``, [train]'s ms per step, the counted
              rate against the fp32 peak and the MFU, beside the card's
              name and power limit; the trace's memory estimate within
              10 % of the card's peak above what was allocated before;
              ``build_prefill_step`` and ``build_serve_step`` at B 4 ×
              1024 and one decode token bitwise the direct ``forward``
              and ``decode_step``; then the dry-run records of
              smollm-135m and mixtral-8x7b at train_4k and prefill_32k
              (traced on ``meta`` on the host), their roofline terms.
   train quadratic — the same model, shape and batches gated by
              ``gain_quadratic(lam=0.01)|int8+ef``: each agent's gain from
              a Hessian-vector product, forward over reverse through both
              kernels; 1 warm-up and 2 timed steps, 2 ``fused_ce`` and 60
              ``swa_attention`` launches per step, finite gains, ms per
              step and peak memory; one 2-layer step against the CPU as
              above, the mean gain within 1e-4 too.
   remat    — the same model, shape and first batch, one step with
              ``remat=False`` and one with ``remat=True`` (each after a
              warm-up call) from the same state, under the [train] policy
              and then the [train quadratic] one: ms, peak memory and
              launches of each, ``swa_attention`` 60 → 90 (lookahead:
              the backward recomputes each block's attention) and 60 →
              150 (quadratic: the HVP's jvp rule and its backward
              recompute it too), ``fused_ce`` 2; decisions equal, loss
              and mean gain within 1e-4, the parameters bitwise equal (or
              the largest gap printed and held to 1e-4 of a leaf's max,
              an int8 rounding midpoint a level apart).
   microbatch — the same step with ``microbatches=2`` (each agent's 2
              sequences one at a time), alone and with ``remat``, against
              the plain step: the kernels launched once per slice,
              decisions equal, loss and parameters within 1e-4 (the
              slices' sums associate otherwise), ms and peak memory.
   train resume — the training CLI (``repro_torch.launch.train.main``)
              on smollm-135m at full width cut to 2 layers (4 until
              [mesh]'s hybrid and ssm jobs needed the time), m = 4,
              ``gain_lookahead(lam=0.01)|int8+ef``: 4 steps with
              ``--ckpt-every 2``, then ``--resume`` over a directory
              holding only the step-2 checkpoint: the final checkpoint's
              leaves bitwise the unbroken run's, ``fused_ce`` and
              ``swa_attention`` launched as often per step as in the
              unbroken run (the checkpoints live under ``build/`` and are
              removed).
   moe      — mixtral-8x7b at full width cut to 4 of its 32 layers
              (6.07 B parameters, fp32, weights from seed 0) served
              through the serving CLI's prefill and greedy decode: batch
              4, prompt 1024, 32 tokens; 4 ``swa_attention`` launches in
              the prefill (GQA 32/8, hd 128, W 4096 ≥ S) and none in
              decode, finite logits, prefill ms, decode ms per step,
              tokens/s, peak memory, and the (token, k) pairs each
              layer's prefill drops past capacity; decode against a fresh
              prefill at capacity factor E/K (no pair dropped: at the
              served factor a longer prefill drops other pairs); then 1
              layer at 64 tokens on the card and the CPU: logits within
              1e-4, the routed expert ids equal except at near-ties, the
              greedy tokens equal.
   moe train — mixtral-8x7b at full width, 1 layer, through the training
              CLI's step: m = 2, global batch 2 × 1024, the [train]
              policy; 1 warm-up and 1 timed step (3 until PR 26's
              [mesh] needed the time, 2 until PR 28's moe, vlm and audio
              jobs did), 2 ``fused_ce`` and 2
              ``swa_attention`` launches per step, finite losses and
              router aux, ms per step, tokens/s, peak memory; the last
              step run twice from one state bitwise equal (per-leaf
              checksums); one step with d_ff_expert narrowed to 1024 on
              the card and the CPU under [train]'s rules.
   hybrid   — zamba2-1.2b at full width cut to 3 (6 until PR 28's
              [mesh] jobs needed the time) of its 38 Mamba2
              layers (1 site of the shared attention block; [mesh]'s
              and [mesh serve]'s time came out of this replay), fp32,
              seed 0:
              batch 4, a 256-token prompt replayed through decode, 32
              tokens; no kernel launch in prefill or decode; prefill ms,
              decode ms per step, tokens/s, peak memory; decode against
              a fresh replay; 64 tokens through its first 6 layers on
              the card and the CPU.
   hybrid train — zamba2-1.2b at full width and depth (38 layers, 7
              sites) with ``remat`` (each Mamba2 layer checkpointed, the
              shared block not), m = 2, global batch 2 × 512: 14
              ``swa_attention`` (7 sites, loss and probe) and 2
              ``fused_ce`` launches per step, ms per step, peak memory;
              then cut to 6 layers (1 site; 12 until PR 28's [mesh]
              jobs needed the time) without remat: 2 and 2
              launches per step, ms, peak memory (the profile's step);
              1 warm-up and 1 timed step each (3 until [mesh] needed
              the time, 2 until its moe, vlm and audio jobs did); a
              2-layer step on the card and the CPU.
   xlstm    — xlstm-350m at full width cut to 1 of its 12 mLSTM/sLSTM
              pairs (2 until [mesh]'s hybrid and ssm jobs needed the
              time, 3 before; [mesh]'s and [mesh serve]'s time came out
              of this replay), fp32, seed
              0: batch 4, a 256-token prompt replayed through
              decode, 32 tokens; no kernel launch; decode bitwise a fresh
              replay; the chunkwise forward over 2 × 1024 tokens (4 mLSTM
              chunks of 256) against the replay's logits at every
              position, each chunk within 1e-4 plus 4× the forward's own
              last-bit sensitivity there (the recurrence amplifies
              rounding with the position); 2 layers on the card and the
              CPU.
   xlstm train — xlstm-350m at full width cut to 2 layers (1 pair; 4
              until [mesh] needed the time), 1 warm-up and 1 timed step
              (3 until [mesh serve] needed the time),
              m = 2, global batch 2 × 512 (2 mLSTM chunks): 2 ``fused_ce``
              and no ``swa_attention`` launch per step, the last step run
              twice from one state bitwise equal; a 2-layer step on the
              card and the CPU.
   whisper  — whisper-medium at full width and depth (24 + 24 layers):
              4 × 1500 stubbed frames encoded once by the prefill (the
              cross K/V of every decoder layer, no logits), 32 greedy
              decoder tokens; no kernel launch (a non-causal encoder,
              plain decode); prefill ms, decode ms per step; the encoder
              at attn_q_block 500 (``attend_blockwise``, 3 blocks) and 512
              (the one-block fallback) within 1e-4·(1 + max) of the
              plain encoder; 1 + 1 layers over 300 frames on the card
              and the CPU: decode logits within 1e-4, tokens equal.
   vlm      — phi-3-vision at full width and depth (32 layers, hd 96,
              3.83 B parameters): batch 4, prompt 512 (tokens only, as
              the reference's prefill), 32 tokens; 32 ``swa_attention``
              launches at hd 96 in the prefill and none in decode, decode
              against a fresh prefill; 2 layers on the card and the CPU.
   vlm train — phi-3-vision at full width cut to 4 layers, m = 2, each
              agent 576 projected patches + 512 tokens: 2 ``fused_ce``
              launches a step over the 512 text tokens (the prefix
              cropped, recorded at the loss's call) and 8
              ``swa_attention`` launches at hd 96 (1088 positions); a
              1-layer step on the card and the CPU (2 until [mesh]
              needed the time); why the depth stays
              cut (the parameter-sized trees of an m = 2 step at 32
              layers, with or without remat).
   whisper train — whisper-medium at full width and depth, m = 2, each
              agent 1500 frames and 448 decoder tokens: with ``remat``
              and ``attn_q_block`` 500 (the encoder blockwise, each block
              checkpointed) 2 ``fused_ce`` and 72 ``swa_attention``
              launches a step; then plain, 2 and 48 (the decoder's causal
              self-attention, loss and probe); ms per step and both peak
              memories, the first losses within 1e-4; a 2 + 2-layer step
              on the card and the CPU.
6. times    — ``gain_reduce``'s, its plain version's and
              ``torch.linalg.vecdot``'s times at each shape beside the
              bytes-over-bandwidth bound: per call by CUDA events (median
              of 100 calls after warm-up), and on the device by the
              profiler, whose trace must hold as many device records as
              the calls make (counted in one-call traces; a short trace is
              taken again, and the tenth fails the run).  Then the
              device time of an empty kernel (the card's launch floor)
              beside the kernel's at (64, 32), and the kernel's HBM share
              at (1, 2^26) (bytes over bandwidth / device time).
7. swa times — the same for ``swa_attention`` at the served shapes
              (smollm's two, mixtral's (4, 1024, 32, 8, 128) W 4096,
              zamba2's training (2, 512, 32, 32, 64) W = S,
              phi-3-vision's (4, 512, 32, 32, 96) and hd 32's (4, 1024,
              4, 2, 32), W = S, and the [mesh] ranks' heads: mixtral's
              (2, 1024, 8, 2, 128) W 4096, phi-3-vision's (1, 1088, 16,
              16, 96), zamba2's (1, 512, 16, 16, 64) and llama's (2,
              1024, 12, 4, 128)),
              fp32, and bf16 at all but the moe, vlm and hybrid ranks'
              heads,
              beside its plain version,
              ``scaled_dot_product_attention`` with the same boolean mask
              and the GQA heads expanded (timed only, never on the path),
              and two bounds max(flops / peak, bytes / HBM rate): the
              kernel's path (``tf32x3``: 3 × flops at the TF32 rate;
              ``bf16-mma``: Q·Kᵀ once and P·V twice, P in two bf16
              parts, at the bf16 rate) and the fp32 CUDA cores' (67
              TFLOP/s), each with the kernel's share of it.  Only the
              path's bound goes into the ``kernels`` record.
   ce times — the same for ``fused_ce`` (each call's median of 10,
              not 100, since [mesh serve]) at (8192, 576, 49152), (4096,
              3072, 128256) and the moe and hybrid train losses' (2048,
              4096, 32000) and (1024, 2048, 32000), fp32 and bf16, and
              the [mesh] ranks' losses (llama's (2048, 3072, 64128),
              mixtral's (2048, 4096, 8000), phi-3-vision's (512, 3072,
              16032), whisper's (448, 1024, 51865), zamba2's (512, 2048,
              16000), xlstm's (512, 1024, 25152)) in fp32, beside its
              plain version,
              ``F.cross_entropy(x @ table.T, labels, reduction="none")``
              and both bounds (``bf16-mma``: flops at the bf16 rate).
8. profile  — 5 more fleet rounds under torch.profiler (device ops,
              busy time and idle share per round, top kernels and host
              operators); then 5 rounds each of [slice], [fleet adaptive]
              and [fleet lossy] in traces that must hold exactly 5 times
              one round's records (taken again when short, as
              ``device_ms`` does): device ops, busy time, idle share;
              then 5 rounds of [frontier quadratic] the same way (10
              each until [mesh]'s seq and inner jobs needed the time);
              then
              one prefill and 8 decode steps of LM run
              (a): the kernel's share of the prefill's device time and
              the device's idle share in decode; then one train step:
              device time by kernel, device ops and idle share; then one
              simulator sweep: device time, device ops and idle share;
              then one [hybrid train] step with each SSD call a
              synchronized range (the SSD forward's device time, one SSD
              call's forward and forward + backward timed alone, the
              SSD's share of the step estimated from them, the peak
              against the decay tiles); then 8 [xlstm] decode steps
              (device ops, busy time, idle share) and one [whisper train]
              step (device time by kernel, device ops, idle share); then
              one [moe] prefill with each
              MoE layer a range: the expert GEMMs' and the dispatch's
              device time against the prefill's.

Before the last line come the ``{"kernels": [...]}`` record (each kernel
with its arithmetic path, ``tf32x3``, ``bf16-mma`` or ``fp32-fma``, and
the path's bound; ``gain_reduce`` also with its launches in the
quadratic frontier and its times at that frontier's (1024, 32);
``swa_attention`` and ``fused_ce`` with their launches on every LM path,
``swa_attention`` also with its times at the hd 32 and 96 shapes) and
the card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  The full record is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import os
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# the fleet's rows, the quadratic frontier's 16 lanes × 64 agents, the
# m = 4096 fleet's, and one long row
SHAPES = ((64, 32), (1024, 32), (4096, 32), (1, 1 << 26))
TIMED_RUNS = 100
# traces of a timed call's device records taken before device_ms fails
# on a trace that lost records
DEVICE_TRACE_ATTEMPTS = 10
# idle card before and after the traced calls inside the profiler's cycle
TRACE_GAP_S = 0.02
# the [fleet adaptive] phase: bytes/round per tier over the last rounds
ADAPTIVE_TAIL = 50
# the [sim] phase's sweep at the fleet's size (TIERED_M64_CFG: n = 32,
# m = 64, N = 32, K = 40): 10 λs of gain_estimated and 10 of gain_exact
# over 512 trials; the CPU holds the first 8 trials on the same batches
SIM_LAMS = (0.0, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0)
SIM_TRIALS, SIM_CHECK_TRIALS = 512, 8
# sweeps in the [profile] phase's trace of the [sim] sweep (2 until
# PR 26's [mesh] and [mesh serve] needed the time)
SIM_PROFILED_SWEEPS = 1
# card vs CPU: 40 rounds of fp32 sums in other orders, free-running
SIM_TOL = 1e-4
ROUNDS = 200
CHECK_ROUNDS = 10
# the lossy and delayed fleets: as benchmarks/lossy_channels.py and
# async_rounds.py define a run (240 rounds, judged on the last half)
NET_ROUNDS = 240
NET_TAIL = 120
TOL_LOSSY = 0.15    # benchmarks/lossy_channels.py:57
TOL_BUDGET = 0.15   # benchmarks/async_rounds.py:68
CHURN_WINDOW = (55, 65)   # around round 60, where the late agents join
RANDOM_COUNTERS = 1 << 20
# fleet rounds in each [profile] trace (20 until [mesh] needed the time,
# 10 until its seq and inner jobs did)
PROFILED_ROUNDS = 5
# the switch and unroll dispatch paths at m = 64: rounds held to hybrid's
# (4 until [mesh]'s seq and inner jobs needed the time)
DISPATCH_ROUNDS = 2
# one step of two paths from the same state (ROADMAP's parity contract)
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# the fleet-sharded phases: gateway ranks, the O(#gateways) check's
# second fleet size (the m = 64 tiers, 16 times over), the sketch-native
# model widths, and the spawn's time limit
SHARD_GATEWAYS = 4
# rounds of the sharded quadratic fleet (ROUNDS until [mesh] needed the
# time, 100 until its moe, vlm and audio jobs did; the lossy fleet keeps
# NET_ROUNDS: its budgets are judged on the last NET_TAIL)
SHARD_ROUNDS = 50
SHARD_BIG_M = 1024
SKETCH_BIG_N, SKETCH_SMALL_N, SKETCH_ROUNDS = 4096, 6, 3
SKETCH_SMALL = "gain_lookahead(lam=0.5)|sketch(rows=5,cols=16,seed=3)+ef"
SKETCH_BIG = "always|sketch(rows=5,cols=64,seed=3)"
SHARD_TIMEOUT_S = 300
SHARD_PROBE_CALLS, SHARD_PROBE_ROUNDS = 50, 30
# the frontiers: benchmarks/tiered_m64.py:34-35's 16 λ scales,
# benchmarks/lossy_channels.py:55-56's budget × severity grid and
# benchmarks/async_rounds.py:65-71's budget × lag grid and drift
FRONTIER_SCALES = (0.0, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8,
                   1.2, 1.8, 2.7, 4.0, 6.0, 9.0, 13.0, 20.0)
LOSSY_BUDGET_SCALES = (0.6, 1.0)
LOSSY_SEVERITIES = (0.0, 1.0)
DRIFT_SCALES = (0.6, 1.0)
DRIFT_LAG_SCALES = (0.5, 1.0)
DRIFT_AMP, DRIFT_PERIOD = 2.0, 16
# the drifting grid's rounds (NET_ROUNDS until PR 28's [mesh] jobs
# needed the time; its tail loss is the last half's)
DRIFT_ROUNDS = 120
# the lanes each frontier holds to the plain step pinned at its scale
FRONTIER_PLAIN_LANES = (0, 11)      # scales 0.0 and 4.0
LOSSY_PLAIN_LANES = (1, 2)          # (0.6, 20 % loss), (1.0, lossless)
DRIFT_PLAIN_LANES = (0, 3)          # (0.6, lag 1), (1.0, lag 2)

# swa_attention shapes (B, S, H, KV, hd, W): the two the LM runs serve
# (smollm-135m's 9 query and 3 kv heads of 64) and the moe and hybrid
# families' (timed too), one hd = 128 shape, and
# the JAX tests' grid (W = 2^30 is plain causal attention)
SWA_SERVED = ((4, 1024, 9, 3, 64, 1024), (1, 6000, 9, 3, 64, 4096),
              # mixtral's served prefill (GQA 32/8, hd 128, W 4096 ≥ S)
              # and zamba2's shared block in training (W = S)
              (4, 1024, 32, 8, 128, 4096), (2, 512, 32, 32, 64, 512),
              # phi-3-vision's served prefill (hd 96) and the reduced
              # smollm's hd 32 (--reduced --d-model 128) at run (a)'s length
              (4, 512, 32, 32, 96, 512), (4, 1024, 4, 2, 32, 1024),
              # a [mesh] moe rank's mixtral heads at model 4 (32/8 → 8/2)
              # over its agent's 2 × 1024 tokens, W 4096, and a vlm rank's
              # phi-3-vision heads at model 2 (32/32 → 16/16) over its
              # agent's 576 patches + 512 tokens
              (2, 1024, 8, 2, 128, 4096), (1, 1088, 16, 16, 96, 1088),
              # a hybrid [mesh] rank's zamba2 shared-block heads at
              # model 2 (32/32 → 16/16) over its agent's 512 tokens
              (1, 512, 16, 16, 64, 512),
              # a [mesh] rank's llama3.2-3b heads at model 2 (24/8 → 12/4)
              (2, 1024, 12, 4, 128, 1024))
SWA_CHECK = SWA_SERVED + (
    # an inner_batch_shard [mesh] rank's smollm-135m: its row of each
    # agent's 2, every head
    (1, 1024, 9, 3, 64, 1024),
    (1, 2048, 24, 8, 128, 512),
    # whisper's decoder and phi-3-vision's patches + tokens in training
    (2, 448, 16, 16, 64, 448), (2, 1088, 32, 32, 96, 1088),
    # an audio [mesh] rank's whisper decoder heads at model 2 (16 → 8),
    # and phi-3-vision's at two rows
    (1, 448, 8, 8, 64, 448), (2, 1088, 16, 16, 96, 1088)) + tuple(
    (2, s, 4, 2, 64, w) for s in (64, 200, 384) for w in (32, 128, 1 << 30))
# the tensor-core tiles' edges: S not a multiple of the 64-row tiles with
# hd = 128, 96 and 32 (fp32 and bf16) and a window shorter than a tile
SWA_EDGE = ((1, 1000, 8, 2, 128, 300), (1, 77, 6, 3, 64, 5),
            (1, 1000, 8, 2, 96, 300), (1, 77, 6, 3, 32, 5))
# a head dim the kernel has no instance for: the card raises, never falls
# back to the plain version
SWA_NO_INSTANCE_HD = 48
# kernel vs plain, |err| ≤ tol + tol·|plain| (the JAX tests' tolerances):
# fp32 by 3×TF32 products (~2^-21 relative) and the order of the sums;
# bf16 by one output rounding (P·V with P in two bf16 parts, ~2^-17)
SWA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Function gradients vs autograd of the plain version, per tensor, of its
# largest entry: the same fp32 backward math on forward outputs that
# differ by the kernel's ~1e-6
SWA_GRAD_TOL = 1e-5

LM_ARCH = "smollm-135m"
LM_RUNS = {"a": dict(batch=4, prompt=1024, gen=32, long_context=False),
           "b": dict(batch=1, prompt=6000, gen=16, long_context=True)}
LM_CHECK = dict(batch=2, prompt=256, gen=16)
# card vs CPU and decode vs prefill, fp32 logits: 30 layers of fp32 sums
# in other orders; bf16 or TF32 arithmetic would miss it by 10-100x
LM_LOGIT_TOL = 1e-4
LM_PROFILED_STEPS = 8

# fused_ce shapes (T, D, V): token counts from a decode batch to the train
# step's 8 × 1024, widths of smollm-135m (576) and llama3.2-3b (3072) and
# a narrow one, vocabularies from a toy 7 to llama3's 128256 (smollm's
# 49152, gpt2's 50257); the pairs the train path and a large model run
CE_T = (64, 1000, 8192)
CE_D = (64, 576, 3072)
CE_V = (7, 1000, 49152, 50257, 128256)
# [ce times]' calls per median (TIMED_RUNS until [mesh serve] needed
# the time, then 25; each call there takes 0.6–68 ms)
CE_TIMED_RUNS = 10
CE_TIMED = ((8192, 576, 49152), (4096, 3072, 128256),
            # mixtral's and zamba2's train losses (m = 2 agents' tokens)
            (2048, 4096, 32000), (1024, 2048, 32000),
            # a [mesh] rank's llama3.2-3b loss: its agent's 2 × 1024
            # tokens against its half of the vocabulary (model 2)
            (2048, 3072, 64128),
            # the moe, vlm and audio [mesh] ranks' losses: mixtral's 2 ×
            # 1024 tokens against a quarter of its vocabulary (model 4),
            # phi-3-vision's 512 text tokens against half of its, and
            # whisper's 448 decoder tokens against its whole tied table
            # (51865 rows: model 2 does not divide it)
            (2048, 4096, 8000), (512, 3072, 16032), (448, 1024, 51865),
            # the hybrid and ssm [mesh] ranks' losses: zamba2's and
            # xlstm's 512 tokens against half of their vocabularies
            (512, 2048, 16000), (512, 1024, 25152))
# each family's train loss (T = the m = 2 agents' tokens): the moe and
# hybrid ones timed above; xlstm's (2 × 512, d 1024, V 50304), whisper's
# (2 × 448 decoder tokens, V 51865) and phi-3-vision's (2 × 512 text
# tokens, d 3072, V 32064) checked only
CE_TRAIN_LOSSES = {"moe": CE_TIMED[2], "hybrid": CE_TIMED[3],
                   "dense_mesh_block": CE_TIMED[4],
                   # an inner_batch_shard [mesh] rank's smollm-135m loss:
                   # its row of 1024 tokens at the whole vocabulary
                   "dense_mesh_rows": (1024, 576, 49152),
                   "xlstm": (1024, 1024, 50304),
                   "whisper": (896, 1024, 51865),
                   "vlm": (1024, 3072, 32064),
                   "moe_mesh_block": CE_TIMED[5],
                   "vlm_mesh_block": CE_TIMED[6],
                   "audio_mesh": CE_TIMED[7],
                   "hybrid_mesh_block": CE_TIMED[8],
                   "ssm_mesh_block": CE_TIMED[9]}
# the tensor-core tiles' edges: T and V not multiples of the 128-row and
# 128-entry tiles, and D not a multiple of the 32 (fp32) or 64 (bf16)
# columns of a k-chunk (D = 100 in bf16 is also off the 16-byte copies)
CE_EDGE = ((129, 100, 129), (1000, 100, 50257), (257, 200, 49153))
# kernel vs plain, |err| ≤ tol + tol·|plain|: fp32 by 3×TF32 products
# (~2^-21 relative), bf16 products exact; sums in other orders
CE_TOL = 1e-5
# (dx, dtable) of the Function vs autograd of the plain version, per
# tensor, of its largest entry: fp32 backward math in other orders
CE_GRAD_TOL = 1e-5
CE_GRAD_SHAPE = (1000, 576, 49152)

# the train slice: smollm-135m at full width and depth, fp32
# (10 timed steps until [mesh] needed the time)
TRAIN = dict(agents=4, batch=8, seq=1024, warmup=3, timed=6, lr=0.05,
             comm="gain_lookahead(lam=0.01)|int8+ef")
# the gradient-only path's peak memory in the earlier runs of this phase
# (NVIDIA H100 80GB HBM3, 700 W): the forward-mode rules of the LM
# kernels must not bring back the double-backward graph's memory
TRAIN_PEAK_GB, TRAIN_PEAK_SLACK = 36.75, 0.01
# the same slice gated by eq. (28): each agent's gain from a
# Hessian-vector product (forward over reverse through both kernels)
TRAIN_QUAD = dict(TRAIN, warmup=1, timed=2,
                  comm="gain_quadratic(lam=0.01)|int8+ef")
# card vs CPU: one step of the same model cut to 2 layers, full width,
# on each batch's first 64 positions (128 until [mesh] needed the time:
# the families' CPU steps are most of their phases)
TRAIN_CHECK = dict(layers=2, agents=2, per_agent=1, seq=64)
# swa_attention launches per causal self-attention site in one step
# ([remat], [microbatch]: per slice): the agents' losses and the probe
# (lookahead) or the HVP's forward (quadratic); under remat the backward
# recomputes each checkpointed block, and the HVP recomputes it twice
# more (its jvp rule and its backward)
REMAT_SWA_PER_LAYER = {("lookahead", False): 2, ("lookahead", True): 3,
                       ("quadratic", False): 2, ("quadratic", True): 5}
# timed calls of each [remat]/[microbatch] variant, after one warm-up
# (2 until [mesh] needed the time)
KNOB_TIMED = 1
# durable serving: each half of the [durable] lineage, its checkpoint
# period; [kill] drives the faults CLI with CI's kill-and-resume numbers
# (.github/workflows/ci.yml:185-200) at a third of the rounds, the kill
# at round 100 (600 and a kill at 200 until [mesh] needed the time, 300
# until its moe, vlm and audio jobs did); [telemetry] serves in thread mode
# with a stalled round and a crashed metro agent
DURABLE_ROUNDS, DURABLE_EVERY, DURABLE_TIMED = 100, 50, 5
KILL = dict(mix="tiered_m64_adaptive", rounds=200, kill_round=100,
            ckpt_every=50, log_every=20)
TELEMETRY = dict(watchdog=0.5, stall_round=40, rounds=200,
                 crash_start=60, crash_rounds=80)
# the train CLI's resume at full width, cut to 2 layers (an int8+ef
# checkpoint of m = 4 agents stays under 1 GB; 4 until the hybrid and ssm
# [mesh] jobs needed the time)
TRAIN_RESUME = dict(TRAIN, layers=2, steps=4, every=2)
# [dryrun]: the serving steps' batch and prompt (LM run (a)'s), the
# (arch, shape) pairs whose dry-run records it writes, and the memory
# estimate's bound against the card's peak
DRYRUN_SERVE = dict(batch=4, seq=1024)
DRYRUN_PAIRS = (("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
                ("mixtral-8x7b", "train_4k"), ("mixtral-8x7b", "prefill_32k"))
DRYRUN_MEMORY_TOL = 0.10
# fp32 forward and backward of 2 layers and a 49152-way softmax, sums in
# other orders on the card and the CPU
TRAIN_TOL = 1e-4

# the moe family: mixtral-8x7b at full width (46.7 B parameters, 187 GB
# in fp32, so the depth is cut): [moe] serves 4 of its 32 layers (6.07 B
# parameters, 24.3 GB) through the serving CLI's functions, and holds 1
# layer (1.71 B, 6.85 GB) on the card against the CPU
MOE_ARCH = "mixtral-8x7b"
MOE_SERVE = dict(layers=4, batch=4, prompt=1024, gen=32)
MOE_CHECK = dict(layers=1, batch=2, prompt=64, gen=8)
# [moe train]: 1 layer at full width through the training CLI's step, m =
# 2 (the gradients, EF memories and lookahead probes are 6 trees of the
# 6.85 GB parameters), global batch 2 × 1024; its card-vs-CPU step narrows
# the experts (d_ff_expert only) so that the CPU step stays short
MOE_TRAIN = dict(layers=1, agents=2, batch=2, seq=1024, warmup=1, timed=1)
MOE_TRAIN_CHECK_FF = 1024
# router probabilities within this (relative) of each other are a
# near-tie that a last-bit gap between card and CPU may flip
ROUTE_TIE = 1e-5
# the hybrid family: zamba2-1.2b at full width (38 Mamba2 layers, 7
# sites of the shared attention block; 1.17 B parameters in the init)
# served by replay cut to 3 layers (6 until PR 28's [mesh] jobs needed
# the time; 1 site: the replay is host-bound,
# ~45 ms a token at 38; 12 until [mesh serve] needed the time), as its
# card-vs-CPU check (at 19 layers the CPU took 22.8 s); trained at full
# width cut to 6 layers (1 site; 12, 2 sites, until PR 28's [mesh] jobs
# needed the time), global batch 2 × 512 (the SSD keeps (m, L, L, h) decay tiles of
# 33.6 MB per chunk and layer for the backward); its card-vs-CPU step at
# 2 layers (1 site)
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_SERVE = dict(layers=3, batch=4, prompt=256, gen=32)
HYBRID_CHECK = dict(layers=3, batch=2, prompt=64, gen=8)
HYBRID_TRAIN = dict(layers=6, agents=2, batch=2, seq=512, warmup=1,
                    timed=1)
# ... and at all 38 layers (7 sites) with remat: each Mamba2 layer keeps
# only its input for the backward, so the parameter state (weights, 2
# gradients, 2 EF memories, 2 probes: ~7 × 4.7 GB) is what fills the card
HYBRID_TRAIN_FULL = dict(HYBRID_TRAIN, layers=38)
HYBRID_TRAIN_CHECK_LAYERS = 2
# card vs CPU through 38 recurrent layers: the two devices' roundings
# part as a last-bit change of the weights does, and this model amplifies
# one far more than smollm-135m's 30 layers (on the CPU at reduced width
# 2.5e-5 against 1.4e-6; on the H100 at full width 2.1e-4, beside a
# card-vs-CPU gap of 2.8e-4), so its logits are held to LM_LOGIT_TOL plus
# this many times the card's own last-bit sensitivity, measured in the
# same run
HYBRID_SENS_FACTOR = 4
# the ssm family: xlstm-350m at full width (12 mLSTM/sLSTM pairs, d
# 1024, 4 heads, vocab 50304) served by replay cut to 4 layers (6 until
# PR 28's [mesh] jobs needed the time; 2
# pairs: the replay of 2 × 1024 positions is host-bound, and [mesh] and
# [mesh serve] needed the time); its chunkwise
# forward over XLSTM_FORWARD_S tokens (4 mLSTM chunks of 256) against the
# replay's logits at every position; trained at full width cut to 2
# layers (1 pair: every sLSTM position is a host iteration of ~20 ops
# per pair, so a step of 512 positions is host-bound; 4 until [mesh]
# needed the time), global batch 2 ×
# 512 (2 mLSTM chunks); card vs CPU at 2 layers (1 pair)
XLSTM_ARCH = "xlstm-350m"
XLSTM_SERVE = dict(layers=2, batch=4, prompt=256, gen=32)
XLSTM_FORWARD = dict(batch=2, seq=1024)
XLSTM_CHECK = dict(layers=2, batch=2, prompt=64, gen=8)
# 1 timed step (3 until [mesh serve] needed the time, 2 until [mesh]'s
# seq and inner jobs)
XLSTM_TRAIN = dict(layers=2, agents=2, batch=2, seq=512, warmup=1, timed=1)
# [profile] xlstm decode: steps after a short replayed prompt (a profile
# of a whole train step, ~100 k device ops, costs ~2 minutes of trace
# processing)
XLSTM_PROFILED_PROMPT, XLSTM_PROFILED_STEPS = 16, 8
# the audio family: whisper-medium at full width and depth (24 encoder and
# 24 decoder layers, d 1024, 16 heads of 64, vocab 51865): encode 4 × 1500
# frames (30 s of audio) once, then 32 greedy decoder tokens; the encoder
# again with attn_q_block 500 (attend_blockwise in 3 blocks) and 512
# (which does not divide 1500: the one-block fallback); card vs CPU at
# 1 + 1 layers over 300 frames; trained at full depth, m = 2 × 1 × (1500
# frames, 448 decoder tokens)
WHISPER_ARCH = "whisper-medium"
WHISPER_SERVE = dict(batch=4, frames=1500, gen=32, q_blocks=(500, 512))
WHISPER_CHECK = dict(layers=1, batch=2, frames=300, gen=8)
WHISPER_TRAIN = dict(agents=2, batch=2, seq=1500, warmup=1, timed=1)
# ... and with remat and the encoder's score tiles in 3 query blocks of
# 500 frames (each checkpointed)
WHISPER_TRAIN_REMAT = dict(remat=True, attn_q_block=500)
# encoder outputs (rms-normed, |x| ~ 1): blockwise against plain on the
# card, 24 layers of fp32 sums in other orders
WHISPER_ENC_TOL = 1e-4
# the vlm family: phi-3-vision at full width and depth (32 layers, d 3072,
# 32 heads of 96, vocab 32064; 3.83 B parameters, 15.3 GB): serve B 4 ×
# 512 tokens (the prefill takes tokens only, as the reference's) + 32
# greedy; card vs CPU at 2 layers; trained at full width cut to 4 layers,
# m = 2 × 1 × (576 patches + 512 tokens)
VLM_ARCH = "phi-3-vision-4.2b"
VLM_SERVE = dict(batch=4, prompt=512, gen=32)
VLM_CHECK = dict(layers=2, batch=2, prompt=64, gen=8)
VLM_TRAIN = dict(layers=4, agents=2, batch=2, seq=512, warmup=1, timed=1)
# an m = 2 step's parameter-sized trees: weights, 2 gradients, 2 EF
# memories, 2 lookahead probes
VLM_STATE_TREES = 7


# [mesh]: MESH_WORLD gloo ranks share the card as a (data 2, model 2)
# mesh.  llama3.2-3b at full width (d 3072, 24/8 heads of 128, d_ff 8192,
# vocab 128256: every head, kv head, ff column and vocab row splits over
# model 2) cut to 2 of its 28 layers (4 until the moe, vlm and audio
# jobs needed the time), and smollm-135m at 4 of its 30
# layers (8 until the hybrid and ssm jobs needed the time, 30 until the
# moe, vlm and audio jobs did; its 9/3
# heads stay whole, its ff and vocab split); 2 agents × 2 × 1024
# tokens, fp32, sgd.  Each agent's gradient, its EF memory, the payload
# and the aggregate are a rank's model blocks (until the block epilogue,
# each was a whole parameter tree on every rank and llama ran out of the
# card at 4 layers: 19.96 GB on rank 0).  The per-agent jobs run m = 4
# agents of 1 × 1024 tokens, so a rank holds the same 2048 tokens as the
# smollm job's, at 2 of smollm's 30 layers (15 until the moe, vlm and
# audio jobs needed the time, 4 until the hybrid and ssm jobs did).  `seq` runs llama with seq_shard (each model rank's chunk
# of the sequence), `inner` smollm with inner_batch_shard (each model
# rank's row of each agent's 2: smollm's 9/3 heads do not split at
# model 2, the case the knob is for), and fleet_shard runs on llama.
# fsdp_off takes 2 steps (the second reads the EF memory and the
# optimizer state at rest as blocks; its parameters are held in L2 to
# the single-process step's second, which the llama reference takes,
# and its time is the steady step's), the other llama jobs 1 (fsdp_on
# and seq 2 until the moe, vlm and audio jobs needed the time; fsdp_on
# is held bitwise to fsdp_off's blocks after its step), the smollm jobs
# 1 (the per-agent ones 2 until the seq and inner jobs needed the
# time).  The other families: `moe` runs
# mixtral-8x7b at full width cut to 1 layer (1.71 B parameters with its
# two untied tables, 6.85 GB in fp32) on a second mesh of the same 4
# ranks, (data 1, model 4) (MESH_RUNS' "model"): m = 1 agent of 2 × 1024
# tokens, each rank 2 of the 8 experts (at (data 2, model 2) with m = 2 a
# rank would hold 3.4 GB of blocks, ~29 GB a rank by the llama job's
# ratio, ~117 GB on the card); `vlm` phi-3-vision cut to 2 layers (4
# until the hybrid and ssm jobs needed the time; m = 2 × 1 × (576
# patches + 512 tokens), [vlm train]'s rows); `audio` whisper-medium cut
# to 4 + 4 layers (m = 2 × 1 × (1500 frames, 448 tokens)); `hybrid`
# zamba2-1.2b cut to 6 of its 38 layers (one group: six Mamba2 layers,
# one site of the shared block) and `ssm` xlstm-350m cut to 2 of its 24
# (one mLSTM/sLSTM pair), each m = 2 × 1 × 512 ([hybrid train]'s and
# [xlstm train]'s rows); one step each.  The jobs: (run, fsdp, fleet_shard, steps,
# policy), each from seed 0, with MESH_KNOBS' plan knobs.
MESH_WORLD, MESH_MODEL = 4, 2
MESH_TIMEOUT_S = 900
MESH_COMM = "gain_lookahead(lam=0.01)|int8+ef"
MESH_LA = "gain_lookahead(lam=0.01)"
MESH_TIERS = ("always", MESH_LA + "|fp16", MESH_LA + "|int8+ef",
              MESH_LA + "|topk(0.05)|int8+ef")
MESH_DELAY = MESH_COMM + " @ delay(max_lag=2)"
MESH_LR = 0.05
MESH_RUNS = {
    "llama": dict(arch="llama3.2-3b", layers=2, agents=2, per_agent=2,
                  seq=1024, steps=2),
    "smollm": dict(arch="smollm-135m", layers=4, agents=2, per_agent=2,
                   seq=1024, steps=1),
    "smollm_m4": dict(arch="smollm-135m", layers=2, agents=4, per_agent=1,
                      seq=1024, steps=1),
    "mixtral": dict(arch="mixtral-8x7b", layers=1, agents=1, per_agent=2,
                    seq=1024, steps=1, model=4),
    "vlm": dict(arch="phi-3-vision-4.2b", layers=2, agents=2, per_agent=1,
                seq=512, steps=1),
    "audio": dict(arch="whisper-medium", layers=4, encoder_layers=4,
                  agents=2, per_agent=1, seq=1500, steps=1),
    "hybrid": dict(arch="zamba2-1.2b", layers=6, agents=2, per_agent=1,
                   seq=512, steps=1),
    "ssm": dict(arch="xlstm-350m", layers=2, agents=2, per_agent=1,
                seq=512, steps=1),
}
MESH_JOBS = {"fsdp_off": ("llama", False, False, 2, MESH_COMM),
             "fsdp_on": ("llama", True, False, 1, MESH_COMM),
             "seq": ("llama", False, False, 1, MESH_COMM),
             "fleet_shard": ("llama", True, True, 1, MESH_COMM),
             "smollm": ("smollm", True, False, 1, MESH_COMM),
             "inner": ("smollm", True, False, 1, MESH_COMM),
             "tiers": ("smollm_m4", True, False, 1, MESH_TIERS),
             "delay": ("smollm_m4", False, False, 1, MESH_DELAY),
             "moe": ("mixtral", False, False, 1, MESH_COMM),
             "vlm": ("vlm", False, False, 1, MESH_COMM),
             "audio": ("audio", False, False, 1, MESH_COMM),
             "hybrid": ("hybrid", False, False, 1, MESH_COMM),
             "ssm": ("ssm", False, False, 1, MESH_COMM)}
MESH_KNOBS = {"seq": {"seq_shard": True}, "inner": {"inner_batch_shard": True}}
# a family whose per-agent gradients on the mesh stand further from one
# process's on the card than TRAIN_TOL allows: the band, as a share of
# the agent's max|g| per leaf, and of the lookahead gain relatively.
# Its job sends the agents' gradients on the mesh to rank 0, which holds
# them to one process's within the band (zamba2 at 6 layers: 1.5e-3,
# its mean gain 1.1e-3 apart, PERF.md §6) and lets an int8 element be
# one level apart only where the two gradients round apart; every
# other check stays at TRAIN_TOL
MESH_FAMILY_GAP = {"hybrid": 3e-3}
# the jobs [mesh] runs (every job when empty), and whether rank 0 runs
# the single-process references and holds the jobs to them: only
# tools/mesh_depth.py's upward search changes these (a depth past the
# one process's memory runs the ranks alone), and main() refuses to run
# without the holds
MESH_ONLY: tuple = ()
MESH_HOLD = True

# [mesh serve]: on the same 4 ranks as (data 2, model 2), fp32, each run
# held to its single-process prefill and greedy decode.  llama3.2-3b at
# full width cut to 2 of its 28 layers and 4 decode steps (28 and 16
# until [mesh]'s seq and inner jobs needed the time, 14 until the moe,
# vlm and audio jobs did, and 8 steps), the cache on the kv heads, then its prefill
# under seq_shard (each model rank's chunk of the prompt) filling the
# cache that decode reads in both layouts ("seq_" layouts; the
# tensor-parallel prefill into the positions' layout went for the moe,
# vlm and audio jobs' time: each path still runs).  A rank's blocks
# are half the model's (every head, kv head, ff column and vocab row
# split over model 2).  The cache holds the prompt and the generated
# tokens: 1028 slots, which model 2 divides.  mixtral-8x7b at full width
# cut to 2 layers (each rank 4 of the 8 experts; the batch's rows
# gathered over data before routing), B 4 × 1024 and 4 decode steps;
# whisper-medium cut to 4 + 4 layers: one encode of 4 × 1500 frames
# (its cross K/V on the rank's heads), then 4 decoder tokens from token
# 0; zamba2-1.2b cut to 6 layers (one group) and xlstm-350m to 2 (one
# pair), B 4 × 64 prompt tokens replayed through the rank's decode step
# (the recurrent prefill: a token a step, so the prompt is short), then
# 4 steps; zamba2's shared block's cache (68 slots) on its kv heads and
# on its positions.
MESH_SERVES = {
    "llama": dict(arch="llama3.2-3b", layers=2, batch=4, prompt=1024, gen=4,
                  layouts=("decode_heads", "seq_decode_heads",
                           "seq_cache_seq_shard")),
    "mixtral": dict(arch="mixtral-8x7b", layers=2, batch=4, prompt=1024,
                    gen=4, layouts=("decode_heads",)),
    "whisper": dict(arch="whisper-medium", layers=4, encoder_layers=4,
                    batch=4, prompt=1500, gen=4, layouts=("decode_heads",)),
    "zamba2": dict(arch="zamba2-1.2b", layers=6, batch=4, prompt=64, gen=4,
                   layouts=("decode_heads", "cache_seq_shard")),
    "xlstm": dict(arch="xlstm-350m", layers=2, batch=4, prompt=64, gen=4,
                  layouts=("decode_heads",)),
}

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# Rows the kernel is checked at beyond the timed shapes: lengths that are
# not a multiple of the 16-byte group (the masked scalar loads), and one
# ragged row long enough to span many blocks (the second-stage sum of
# per-block partials) with several rows (the partials' row offsets).
RAGGED_SHAPES = ((64, 33), (4096, 31), (3, 1_000_003))
CHECK_SHAPES = SHAPES + RAGGED_SHAPES
RTOL, ATOL_PER_MASS = 1e-5, 1e-6  # kernel vs plain, every shape
U32 = 2.0 ** -24                   # unit roundoff of fp32


def _threads_for(items: int) -> int:
    t = 32
    while t < 256 and t < items:
        t *= 2
    return t


def summation_depth(n: int, width: int):
    """(stage-1 blocks per row, the longest chain of fp32 roundings any
    product passes through) in the kernel, for a row of n elements and
    loads of ``width`` elements — ``make_plan`` of csrc/gain_reduce.cu:
    each thread's serial run of fused multiply-adds, its block's tree
    (≤ 10 shuffle levels), and, when the row spans several blocks, the
    second stage's serial run over partials and its tree."""
    threads = _threads_for(-(-n // width))
    per_pass = threads * width
    chunk = per_pass * 8
    nsplit = -(-n // chunk)
    if nsplit > 65535:
        chunk = -(-(-(-n // 65535)) // per_pass) * per_pass
        nsplit = -(-n // chunk)
    depth = -(-min(chunk, n) // per_pass) * width + 10
    if nsplit > 1:
        depth += -(-nsplit // _threads_for(nsplit)) + 10
    return nsplit, depth


def error_bound(n: int, width: int) -> float:
    """Worst-case |kernel − exact sum| / Σ|terms|: a sum whose every term
    passes through at most d roundings errs by at most
    γ_d = d·u / (1 − d·u) times Σ|terms| (u = 2^-24).  The products
    themselves are exact inside the fused multiply-add, and bf16 inputs
    widen exactly to fp32, so the same bound holds for both dtypes."""
    d = summation_depth(n, width)[1]
    return d * U32 / (1 - d * U32)


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median time of one ``fn()`` call over ``runs`` calls after
    warm-up, by CUDA events recorded around each call: device time plus
    any host dispatch during which the device waits."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(gr_ops, rows: int, n: int, dtype):
    """Least time (ms) for the same work and what bounds it: the
    kernel's own cost record (every input byte read once and the
    (rows, 2) fp32 output written once, 4 flops per element pair) at the
    H100's peaks (``repro_torch.analysis.roofline.kernel_bound``)."""
    from repro_torch.analysis.roofline import kernel_bound

    work = gr_ops.cost(rows, n, dtype)
    return kernel_bound(work["path_flops"], work["hbm_bytes"], work["path"])


def phase_build(*kernel_ops) -> dict:
    """Build every kernel at once: one nvcc per source, all started
    together (each build waits on its own nvcc process)."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(ops):
        t0 = time.perf_counter()
        lib = ops.build()
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_ops)) as pool:
        built = list(pool.map(timed, kernel_ops))
    record = {"wall_seconds": time.perf_counter() - t0}
    for ops, (lib, seconds) in zip(kernel_ops, built):
        print(f"[build] {lib.relative_to(REPO)} in {seconds:.1f} s")
        log = Path(f"{lib}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"[build] {line.strip()}")
        record[ops.SOURCE.stem] = {"library": str(lib.relative_to(REPO)),
                                   "seconds": seconds}
    print(f"[build] {len(kernel_ops)} kernels in "
          f"{record['wall_seconds']:.1f} s")
    return record


def _rows(make, rows: int, n: int, offset: int):
    """A contiguous (rows, n) view that starts ``offset`` elements into
    its buffer: offset 1 puts it off the 16-byte alignment the vector
    loads need, so the kernel takes its scalar loads."""
    return make(rows * n + offset)[offset:].view(rows, n)


def _normal_rows(torch, gen, dtype, rows: int, n: int, offset: int):
    def make(size):
        return torch.randn((size,), generator=gen, device="cuda").to(dtype)

    return _rows(make, rows, n, offset)


def _integer_rows(torch, gen, dtype, rows: int, n: int, offset: int):
    """Integers in [-3, 3], sparse enough that every partial sum of gᵢ²
    or gᵢhᵢ stays below 2^22: all of them are exact in fp32 and bf16,
    so any order of summation gives the exact result, bit for bit.  A
    dropped, doubled or misplaced element or partial shows as a nonzero
    difference."""
    density = min(1.0, 2.0 ** 22 / (9 * n))

    def make(size):
        vals = torch.randint(-3, 4, (size,), generator=gen, device="cuda")
        keep = torch.rand((size,), generator=gen, device="cuda") < density
        return (vals * keep).to(dtype)

    return _rows(make, rows, n, offset)


def phase_kernel(torch, gr_ops, ref) -> list:
    """Kernel vs plain version on the card, at every checked shape and
    dtype, aligned and one element off alignment.  Three checks each:

    - normal inputs, kernel vs plain: ``RTOL``·|plain| + ``ATOL_PER_MASS``
      ·Σ|terms| (both sum the same fp32 products in different orders);
    - normal inputs, kernel vs the exact (float64) sum: ``error_bound``
      ·Σ|terms|, derived from the kernel's own order of summation;
    - integer inputs (``_integer_rows``): kernel, plain and exact sum
      bitwise equal;

    and a repeated launch is bitwise equal."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, n in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            width = 16 // torch.empty((), dtype=dtype).element_size()
            nsplit, _ = summation_depth(n, width)
            code = 0 if dtype == torch.float32 else 1
            if nsplit != gr_ops._splits(n, code):
                raise AssertionError(f"summation_depth's plan for n={n} "
                                     "differs from the kernel's")
            bound = error_bound(n, width)
            for offset in (0, 1):
                g = _normal_rows(torch, gen, dtype, rows, n, offset)
                h = _normal_rows(torch, gen, dtype, rows, n, offset)
                got = gr_ops.gain_reduce(g, h)
                again = gr_ops.gain_reduce(g, h)
                want = ref.gain_reduce_ref(g, h)
                gf, hf = g.double(), h.double()
                exact = torch.stack([(gf * gf).sum(-1), (gf * hf).sum(-1)],
                                    -1)
                mass = torch.stack([(gf * gf).sum(-1),
                                    (gf * hf).abs().sum(-1)], -1)
                torch.cuda.synchronize()
                name = (f"gain_reduce {rows}x{n} {str(dtype)[6:]} "
                        f"offset {offset}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: repeated launch differs")
                err = (got.double() - want.double()).abs()
                if not bool((err <= RTOL * want.double().abs()
                             + ATOL_PER_MASS * mass).all()):
                    raise AssertionError(
                        f"{name}: kernel disagrees with its plain version "
                        f"(max err {err.max().item():.3e})")
                err_exact = (got.double() - exact).abs()
                ratio = (err_exact / (bound * mass)).max().item()
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"{name}: kernel error {err_exact.max().item():.3e} "
                        f"exceeds its derived bound (x{ratio:.3g})")
                gi = _integer_rows(torch, gen, dtype, rows, n, offset)
                hi = _integer_rows(torch, gen, dtype, rows, n, offset)
                got_i = gr_ops.gain_reduce(gi, hi)
                want_i = ref.gain_reduce_ref(gi, hi)
                gd, hd = gi.double(), hi.double()
                exact_i = torch.stack([(gd * gd).sum(-1), (gd * hd).sum(-1)],
                                      -1)
                if not (torch.equal(got_i, want_i)
                        and torch.equal(got_i.double(), exact_i)):
                    bad = (got_i.double() - exact_i).abs().max().item()
                    raise AssertionError(
                        f"{name}: integer inputs not summed exactly (kernel "
                        f"off by {bad}, plain off by "
                        f"{(want_i.double() - exact_i).abs().max().item()})")
                vector = n % width == 0 and offset == 0
                results.append({
                    "shape": [rows, n], "dtype": str(dtype)[6:],
                    "offset": offset,
                    "loads": "vector" if vector else "scalar",
                    "splits": nsplit,
                    "max_abs_err": err.max().item(), "rtol": RTOL,
                    "atol_per_abs_mass": ATOL_PER_MASS,
                    "max_abs_err_vs_exact": err_exact.max().item(),
                    "bound_per_abs_mass": bound,
                    "err_over_bound": ratio,
                    "integer_exact": True, "bitwise_repeat": True,
                })
                print(f"[kernel] {rows}x{n} {str(dtype)[6:]} offset "
                      f"{offset} ({results[-1]['loads']} loads, {nsplit} "
                      f"split{'s' if nsplit > 1 else ''}): vs plain "
                      f"{err.max().item():.3e} within {RTOL}·|plain| + "
                      f"{ATOL_PER_MASS}·Σ|gh|; vs exact "
                      f"{err_exact.max().item():.3e} = {ratio:.2e} of the "
                      f"bound {bound:.2e}·Σ|gh|; integers exact; repeat "
                      f"bitwise equal")
                del g, h, gi, hi, gf, hf, gd, hd
    covered = {(r["loads"], r["splits"] > 1) for r in results}
    if len(covered) != 4:
        raise AssertionError(f"load/split paths not all covered: {covered}")
    # no gradient: an input that requires grad raises, never detaches
    g = torch.ones((2, 64), device="cuda")
    try:
        gr_ops.gain_reduce(g.clone().requires_grad_(True), g)
    except RuntimeError as err:
        if "no gradient" not in str(err):
            raise
    else:
        raise AssertionError("gain_reduce on an input that requires grad "
                             "did not raise")
    results.append(_vmap_check(torch, gr_ops, ref, gen))
    return results


def _vmap_check(torch, gr_ops, ref, gen) -> dict:
    """The vmap rule at the quadratic frontier's shape: 16 lanes of
    (64, 32) fp32 rows under ``torch.func.vmap`` (and 4 × 4 lanes under
    two nested maps) are ONE launch each, bitwise equal to the kernel on
    the folded (1024, 32) rows and to it lane by lane, and within the
    kernel's tolerance of the plain version per lane."""
    lanes, (rows, n) = len(FRONTIER_SCALES), SHAPES[0]
    g = torch.randn((lanes, rows, n), generator=gen, device="cuda")
    h = torch.randn((lanes, rows, n), generator=gen, device="cuda")
    launches = []
    gr_ops.gain_reduce.launches = 0
    got = torch.func.vmap(gr_ops.gain_reduce)(g, h)
    launches.append(gr_ops.gain_reduce.launches)
    gr_ops.gain_reduce.launches = 0
    nested = torch.func.vmap(torch.func.vmap(gr_ops.gain_reduce))(
        g.reshape(4, 4, rows, n), h.reshape(4, 4, rows, n))
    launches.append(gr_ops.gain_reduce.launches)
    folded = gr_ops.gain_reduce(g.reshape(-1, n), h.reshape(-1, n))
    per_lane = torch.stack([gr_ops.gain_reduce(g[i], h[i])
                            for i in range(lanes)])
    want = torch.stack([ref.gain_reduce_ref(g[i], h[i])
                        for i in range(lanes)])
    torch.cuda.synchronize()
    if launches != [1, 1]:
        raise AssertionError(f"gain_reduce under vmap launched {launches} "
                             f"times (want one per map)")
    if not (torch.equal(got, folded.reshape(lanes, rows, 2))
            and torch.equal(got, per_lane)
            and torch.equal(nested.reshape(lanes, rows, 2), got)):
        raise AssertionError("gain_reduce under vmap differs from the "
                             "kernel on the folded rows or lane by lane")
    gd, hd = g.double(), h.double()
    mass = torch.stack([(gd * gd).sum(-1), (gd * hd).abs().sum(-1)], -1)
    err = (got.double() - want.double()).abs()
    if not bool((err <= RTOL * want.double().abs()
                 + ATOL_PER_MASS * mass).all()):
        raise AssertionError(f"gain_reduce under vmap disagrees with the "
                             f"plain version (max err {err.max().item():.3e})")
    print(f"[kernel] vmap over {lanes} lanes of {rows}x{n} (and 4 x 4 "
          f"nested): one launch each over {lanes * rows} rows, bitwise "
          f"equal to the kernel lane by lane; vs plain "
          f"{err.max().item():.3e}; an input that requires grad raises")
    return {"vmap": True, "lanes": lanes, "shape": [rows, n],
            "launches": launches, "max_abs_err": err.max().item(),
            "bitwise_vs_per_lane": True}


def phase_slice(torch, gr_ops):
    """The main path: the m=64 quadratic-gated fleet served on the card."""
    from repro_torch.configs.paper_linreg import (
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.convert import to_numpy
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator
    from repro_torch.launch.session import build_linreg_fleet_session

    cfg = TIERED_M64_CFG
    seed = 0
    dev = torch.device("cuda", torch.cuda.current_device())
    problem = R.make_problem(cfg, step_generator(seed, 0, dev), device=dev)

    def batch_fn(k):
        return R.agent_batches(problem, step_generator(seed + 1, k, dev))

    history, history_loss, stamps = [], [], []

    def on_round(k, metrics):
        stamps.append(time.perf_counter())
        if k < CHECK_ROUNDS:
            history.append(metrics)
        history_loss.append(float(metrics["loss"]))

    session = build_linreg_fleet_session(
        net=TIERED_M64_QUADRATIC, cfg_lr=cfg, seed=seed, device=dev,
        batch_fn=batch_fn, on_round=on_round)

    gr_ops.gain_reduce.launches = 0
    session.run(ROUNDS)
    torch.cuda.synchronize()
    launches = gr_ops.gain_reduce.launches

    if launches != ROUNDS:
        raise AssertionError(f"main path launched gain_reduce {launches} "
                             f"times in {ROUNDS} rounds (want 1 per round)")
    if not all(math.isfinite(v) for v in history_loss):
        raise AssertionError("non-finite loss on the card")
    if not history_loss[-1] < history_loss[0]:
        raise AssertionError(f"loss did not fall: {history_loss[0]} -> "
                             f"{history_loss[-1]}")
    steady = (len(stamps) - 1 - CHECK_ROUNDS) / (stamps[-1]
                                                 - stamps[CHECK_ROUNDS])

    # the same session on the CPU, on the same batches
    cpu_hist = []
    cpu = build_linreg_fleet_session(
        net=TIERED_M64_QUADRATIC, cfg_lr=cfg, seed=seed, device="cpu",
        batch_fn=lambda k: tuple(x.cpu() for x in batch_fn(k)),
        on_round=lambda k, m: cpu_hist.append(m))
    cpu.run(CHECK_ROUNDS)
    # free-running over 10 rounds: the card's matmuls and reductions sum
    # in other orders than the CPU's, and the gaps compound round over
    # round, so floats get rtol 1e-4 / atol 1e-5; decisions stay exact
    import numpy as np

    for k, (a, b) in enumerate(zip(history, cpu_hist)):
        for key in ("agent_tx", "num_tx", "any_tx"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"round {k}: {key} differs card vs CPU")
        for key in b:
            if not np.allclose(a[key], b[key], rtol=1e-4, atol=1e-5):
                raise AssertionError(
                    f"round {k}: {key} differs card vs CPU: {a[key]} vs "
                    f"{b[key]}")
    card_w = to_numpy(session.state.params)["w"]
    print(f"[slice] {ROUNDS} rounds, m={cfg.num_agents} n={cfg.n} "
          f"N={cfg.samples_per_agent}: gain_reduce launches {launches}; "
          f"loss {history_loss[0]:.4f} -> {history_loss[-1]:.4f}; "
          f"first {CHECK_ROUNDS} rounds match the CPU session; "
          f"{steady:.1f} rounds/s after round {CHECK_ROUNDS}")
    snap = session.rollup.snapshot()
    return session, {
        "rounds": ROUNDS, "launches": launches,
        "loss_first": history_loss[0], "loss_last": history_loss[-1],
        "rounds_per_s": steady, "num_tx_total": snap["counters"]["num_tx"],
        "wire_bytes_total": snap["counters"]["wire_bytes"],
        "w_norm": float(np.linalg.norm(card_w)),
    }


def phase_fleet_adaptive(torch, slice_rounds_per_s: float) -> dict:
    """The served fleet's default: ``build_linreg_fleet_session`` with no
    ``net`` serves ``TIERED_M64_ADAPTIVE`` (budget_window / budget_dual
    controllers on the metered tiers, their rows in the state) on the
    [slice] phase's problem and batch stream, for ROUNDS rounds; then
    the first CHECK_ROUNDS rounds against the same session on the CPU."""
    import numpy as np

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_ADAPTIVE,
        TIERED_M64_CFG,
    )
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator
    from repro_torch.launch.session import build_linreg_fleet_session

    net, cfg, seed = TIERED_M64_ADAPTIVE, TIERED_M64_CFG, 0
    dev = torch.device("cuda", torch.cuda.current_device())
    problem = R.make_problem(cfg, step_generator(seed, 0, dev), device=dev)

    def batch_fn(k):
        return R.agent_batches(problem, step_generator(seed + 1, k, dev))

    tier_of = np.asarray(net.tier_index())
    history, losses, stamps, tier_bytes = [], [], [], []
    session = None

    def on_round(k, metrics):
        stamps.append(time.perf_counter())
        losses.append(float(metrics["loss"]))
        tier_bytes.append(np.bincount(tier_of, weights=metrics["agent_bytes"],
                                      minlength=len(net.tiers)))
        if k < CHECK_ROUNDS:
            history.append((metrics, session.state.ctrl_state.cpu().numpy()))

    session = build_linreg_fleet_session(seed=seed, device=dev,
                                         batch_fn=batch_fn, on_round=on_round)
    if session.state.ctrl_state is None or tuple(
            session.state.ctrl_state.shape) != (cfg.num_agents, 3):
        raise AssertionError("the default fleet carries no controller rows")
    session.run(ROUNDS)
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("fleet adaptive: non-finite loss on the card")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fleet adaptive: loss did not fall: "
                             f"{losses[0]} -> {losses[-1]}")
    steady = (len(stamps) - 1 - CHECK_ROUNDS) / (stamps[-1]
                                                 - stamps[CHECK_ROUNDS])
    tail = np.mean(tier_bytes[-ADAPTIVE_TAIL:], axis=0)
    tiers = []
    for t, spec in enumerate(net.tiers):
        # wire_budget is per agent and round (None: unmetered)
        budget = spec.wire_budget
        tiers.append({"tier": spec.name, "agents": int(spec.count),
                      "bytes_per_agent_round": float(tail[t] / spec.count),
                      "wire_budget": budget if math.isfinite(budget)
                      else None})
    cpu_hist = []
    cpu = build_linreg_fleet_session(
        seed=seed, device="cpu",
        batch_fn=lambda k: tuple(x.cpu() for x in batch_fn(k)),
        on_round=lambda k, m: cpu_hist.append(
            (m, cpu.state.ctrl_state.numpy().copy())))
    cpu.run(CHECK_ROUNDS)
    # decisions exact; floats and controller rows as [slice] holds them
    for k, ((a, ca), (b, cb)) in enumerate(zip(history, cpu_hist)):
        for key in ("agent_tx", "num_tx", "any_tx"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"fleet adaptive round {k}: {key} "
                                     f"differs card vs CPU")
        for key in b:
            if not np.allclose(a[key], b[key], rtol=1e-4, atol=1e-5):
                raise AssertionError(f"fleet adaptive round {k}: {key} "
                                     f"differs card vs CPU: {a[key]} vs "
                                     f"{b[key]}")
        if not np.allclose(ca, cb, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"fleet adaptive round {k}: controller "
                                 f"rows differ card vs CPU (max "
                                 f"{np.abs(ca - cb).max():.3e})")
    budgets = ", ".join(
        f"{r['tier']} {r['bytes_per_agent_round']:.2f}"
        + (f"/{r['wire_budget']:.2f}" if r["wire_budget"] is not None
           else "") for r in tiers)
    print(f"[fleet adaptive] {net.name} on {cfg.name}, {ROUNDS} rounds: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {steady:.1f} rounds/s "
          f"after round {CHECK_ROUNDS} (the [slice] fleet: "
          f"{slice_rounds_per_s:.1f}); bytes per agent and round over the "
          f"last {ADAPTIVE_TAIL} rounds vs wire budget: {budgets}; first "
          f"{CHECK_ROUNDS} rounds (decisions, metrics, controller rows) "
          f"match the CPU session")
    return {
        "net": net.name, "rounds": ROUNDS, "loss_first": losses[0],
        "loss_last": losses[-1], "rounds_per_s": steady,
        "slice_rounds_per_s": slice_rounds_per_s, "tiers": tiers,
        "tail_rounds": ADAPTIVE_TAIL, "cpu_rounds_checked": CHECK_ROUNDS,
        "lam_final": session.state.ctrl_state[:, 0].tolist()}, session


def phase_random(torch) -> dict:
    """The port's threefry on the card against the CPU, bit for bit:
    ``bits``, ``uniform`` and ``split`` over 2^20 counters, and the
    channels' chained ``fold_in(fold_in(PRNGKey(seed), step), uid)`` then
    ``uniform`` over 64 × 240 (step, uid) pairs."""
    from repro_torch import random as prng

    dev = torch.device("cuda", torch.cuda.current_device())
    record = {}

    def both(name, fn):
        fn(dev)  # warm-up: the first call loads the int64 kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fn(dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = fn(torch.device("cpu"))
        card = card.cpu()
        if card.dtype == torch.float32:
            card, cpu = card.view(torch.int32), cpu.view(torch.int32)
        if not torch.equal(card, cpu):
            bad = int((card != cpu).sum())
            raise AssertionError(f"random: {name}: {bad} of {card.numel()} "
                                 f"words differ card vs CPU")
        record[name] = {"words": card.numel(), "card_ms": ms}

    n = RANDOM_COUNTERS
    both("bits", lambda d: prng.bits(prng.PRNGKey(7, device=d), (n,)))
    both("uniform", lambda d: prng.uniform(prng.PRNGKey(7, device=d), (n,)))
    both("split", lambda d: prng.split(prng.PRNGKey(7, device=d), n))
    steps, uids = NET_ROUNDS, 64

    def chained(d):
        keys = prng.fold_in(prng.fold_in(
            prng.PRNGKey(3, device=d),
            torch.arange(steps, device=d)[:, None]),
            torch.arange(uids, device=d)[None, :])
        return torch.cat([keys.reshape(-1), prng.uniform(keys).view(
            torch.int32).to(torch.int64).reshape(-1)])

    both("fold_in_uniform", chained)
    # the host fold of (seed, step) then the device fold of the uids:
    # the channels' own derivation, against the all-device chain
    host = torch.stack([prng.fold_in(prng.host_fold_in(3, k),
                                     torch.arange(uids, device=dev))
                        for k in range(steps)]).cpu()
    if not torch.equal(host, chained(torch.device("cpu"))[:steps * uids * 2]
                       .reshape(steps, uids, 2)):
        raise AssertionError("random: host (seed, step) folds differ from "
                             "the device chain")
    print(f"[random] bits, uniform, split over {n} counters and "
          f"fold_in(fold_in(key, step), uid) + uniform over {steps} x "
          f"{uids} (step, uid) pairs: card equal to the CPU bit for bit; "
          + ", ".join(f"{k} {v['card_ms']:.2f} ms" for k, v in
                      record.items()))
    return record


def _to_cpu(state):
    """A TrainState with every tensor moved to the CPU (step stays)."""
    from repro_torch.utils.tree import tree_map

    def move(tree):
        return None if tree is None else tree_map(lambda x: x.cpu(), tree)

    return state._replace(params=move(state.params),
                          opt_state=move(state.opt_state),
                          ef_memory=move(state.ef_memory),
                          ctrl_state=move(state.ctrl_state),
                          net_state=move(state.net_state))


# a round's integer-valued realization: held exactly card vs CPU
EXACT_KEYS = ("agent_tx", "num_tx", "any_tx", "agent_delivered",
              "agent_staleness", "agent_active", "num_active")


def _serve_net(torch, net, *, churn=None, rounds: int = NET_ROUNDS,
               keep=(), starts=(0,)):
    """Serve ``net`` on TIERED_M64_CFG (seed 0, the [slice] problem and
    batch stream) for ``rounds`` rounds on the card.  Keeps every
    round's metrics, the controller rows after the rounds in ``keep``
    and the state before each round in ``starts`` (on the CPU)."""
    from repro_torch.configs.paper_linreg import TIERED_M64_CFG
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator
    from repro_torch.launch.session import build_linreg_fleet_session

    cfg, seed = TIERED_M64_CFG, 0
    dev = torch.device("cuda", torch.cuda.current_device())
    problem = R.make_problem(cfg, step_generator(seed, 0, dev), device=dev)

    def batch_fn(k):
        return R.agent_batches(problem, step_generator(seed + 1, k, dev))

    run = {"hist": [], "stamps": [], "ctrl": {}, "states": {},
           "problem": problem, "batch_fn": batch_fn}
    session = None

    def on_round(k, metrics):
        run["stamps"].append(time.perf_counter())
        run["hist"].append(metrics)
        if k in keep and session.state.ctrl_state is not None:
            run["ctrl"][k] = session.state.ctrl_state.cpu().numpy()
        if k + 1 in starts:
            run["states"][k + 1] = _to_cpu(session.state)

    session = build_linreg_fleet_session(
        net=net, cfg_lr=cfg, seed=seed, device=dev, batch_fn=batch_fn,
        on_round=on_round, churn=churn)
    run["states"][0] = _to_cpu(session.state)
    session.run(rounds)
    torch.cuda.synchronize()
    run["session"] = session
    losses = [float(m["loss"]) for m in run["hist"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{net.name}: non-finite loss on the card")
    run["losses"] = losses
    run["rounds_per_s"] = (len(run["stamps"]) - 1 - CHECK_ROUNDS) / (
        run["stamps"][-1] - run["stamps"][CHECK_ROUNDS])
    run["J"] = (float(problem.J(torch.zeros_like(problem.w_star))),
                float(problem.J(session.state.params["w"])))
    return run


def _cpu_check(torch, label, net, run, start: int, rounds: int,
               churn=None) -> None:
    """Rounds ``start .. start + rounds`` of a card run against the same
    step on the CPU from the card's state before round ``start``, on the
    same batches: the realization (decisions, deliveries, staleness, the
    churn mask) exactly, floats and controller rows within rtol 1e-4 /
    atol 1e-5, as [fleet adaptive] holds them."""
    import numpy as np

    from repro_torch.configs.paper_linreg import TIERED_M64_CFG
    from repro_torch.launch.session import (
        FleetSession,
        build_linreg_fleet_session,
    )

    def cpu_batch(k):
        return tuple(x.cpu() for x in run["batch_fn"](k))

    template = build_linreg_fleet_session(
        net=net, cfg_lr=TIERED_M64_CFG, device="cpu", batch_fn=cpu_batch,
        churn=churn)
    got = []
    cpu = FleetSession(
        template.step_fn, run["states"][start],
        lambda k: cpu_batch(start + k), template.rollup,
        on_round=lambda k, m: got.append(
            (m, None if cpu.state.ctrl_state is None
             else cpu.state.ctrl_state.numpy().copy())))
    cpu.run(rounds)
    for i, (b, cb) in enumerate(got):
        k = start + i
        a = run["hist"][k]
        for key in EXACT_KEYS:
            if key in b and not np.array_equal(a[key], b[key]):
                raise AssertionError(f"{label} round {k}: {key} differs "
                                     f"card vs CPU")
        for key in b:
            if not np.allclose(a[key], b[key], rtol=1e-4, atol=1e-5):
                raise AssertionError(f"{label} round {k}: {key} differs "
                                     f"card vs CPU: {a[key]} vs {b[key]}")
        if cb is not None and not np.allclose(run["ctrl"][k], cb, rtol=1e-4,
                                              atol=1e-5):
            raise AssertionError(f"{label} round {k}: controller rows "
                                 f"differ card vs CPU")


def _tier_bytes(net, run, tol: float, *, arrived: bool = False):
    """Each tier's delivered bytes per agent and round over the last
    NET_TAIL rounds against its wire budget.  ``arrived`` prices every
    payload that arrived at its full wire cost (``agent_bytes`` carries
    a delay line's staleness-discounted application weight instead)."""
    import numpy as np

    tier_of = np.asarray(net.tier_index())
    per_round = []
    for m in run["hist"][-NET_TAIL:]:
        b = np.asarray(m["agent_bytes"], np.float64)
        if arrived:
            w = np.asarray(m["agent_delivered"], np.float64)
            b = np.where(w > 0, b / np.where(w > 0, w, 1.0), 0.0)
        per_round.append(np.bincount(tier_of, weights=b,
                                     minlength=len(net.tiers)))
    tail = np.mean(per_round, axis=0)
    rows = []
    for t, spec in enumerate(net.tiers):
        rate = float(tail[t] / spec.count)
        budget = spec.wire_budget if math.isfinite(spec.wire_budget) else None
        err = None if budget is None else rate / budget - 1.0
        rows.append({"tier": spec.name, "agents": int(spec.count),
                     "bytes_per_agent_round": rate, "wire_budget": budget,
                     "rel_err": err,
                     "within": None if err is None else abs(err) <= tol})
    return rows


def _budget_text(rows) -> str:
    return ", ".join(
        f"{r['tier']} {r['bytes_per_agent_round']:.2f}"
        + ("" if r["wire_budget"] is None else
           f"/{r['wire_budget']:.2f} ({r['rel_err']:+.3f})") for r in rows)


def _net_record(net, run) -> dict:
    import numpy as np

    att = sum(float(m["wire_bytes_attempted"]) for m in run["hist"])
    got = sum(float(m["wire_bytes"]) for m in run["hist"])
    return {"net": net.name, "rounds": len(run["hist"]),
            "rounds_per_s": run["rounds_per_s"],
            "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
            "tail_loss": float(np.mean(run["losses"][-NET_TAIL:])),
            "J_initial": run["J"][0], "J_final": run["J"][1],
            "wire_bytes": got, "wire_bytes_attempted": att,
            "delivered_byte_frac": got / att if att else None}


def phase_fleet_lossy(torch, adaptive_rounds_per_s: float) -> tuple:
    """``TIERED_M64_ADAPTIVE_LOSSY`` (20 % Bernoulli loss with staleness
    boost on the metered tiers, controllers pricing delivered bytes) for
    NET_ROUNDS rounds: the first CHECK_ROUNDS against the CPU, each
    metered tier's delivered bytes over the last NET_TAIL rounds within
    TOL_LOSSY of its budget, and the final J under half the initial J
    (benchmarks/lossy_channels.py's claims for one served run)."""
    from repro_torch.configs.paper_linreg import TIERED_M64_ADAPTIVE_LOSSY

    net = TIERED_M64_ADAPTIVE_LOSSY
    run = _serve_net(torch, net, keep=range(CHECK_ROUNDS))
    _cpu_check(torch, "fleet lossy", net, run, 0, CHECK_ROUNDS)
    rows = _tier_bytes(net, run, TOL_LOSSY)
    record = {**_net_record(net, run), "tiers": rows,
              "adaptive_rounds_per_s": adaptive_rounds_per_s}
    print(f"[fleet lossy] {net.name}, {NET_ROUNDS} rounds: loss "
          f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}, J "
          f"{run['J'][0]:.3f} -> {run['J'][1]:.4f}; delivered byte "
          f"fraction {record['delivered_byte_frac']:.4f}; "
          f"{run['rounds_per_s']:.1f} rounds/s after round {CHECK_ROUNDS} "
          f"([fleet adaptive]: {adaptive_rounds_per_s:.1f}); delivered "
          f"bytes per agent and round over the last {NET_TAIL} vs budget: "
          f"{_budget_text(rows)}; first {CHECK_ROUNDS} rounds match the CPU")
    if not all(r["within"] in (None, True) for r in rows):
        raise AssertionError(f"fleet lossy: a metered tier's delivered "
                             f"bytes miss its budget by more than "
                             f"{TOL_LOSSY}: {_budget_text(rows)}")
    if not run["J"][1] < 0.5 * run["J"][0]:
        raise AssertionError(f"fleet lossy: final J {run['J'][1]} not under "
                             f"half the initial {run['J'][0]}")
    return record, run["session"], 1e3 / run["rounds_per_s"]


def phase_fleet_lossy_quadratic(torch, gr_ops) -> dict:
    """``TIERED_M64_QUADRATIC`` with 20 % Bernoulli loss on its metered
    tiers: one ``gain_reduce`` launch per round by the wrapper's counter,
    the CPU check, and whether each tier met its budget (printed: the
    JAX claim is that a fixed λ misses under loss)."""
    from repro_torch.configs.paper_linreg import (
        LOSSY_CHANNEL,
        TIERED_M64_QUADRATIC,
        _lossy,
    )

    net = _lossy(TIERED_M64_QUADRATIC, "tiered_m64_quadratic_lossy",
                 LOSSY_CHANNEL)
    gr_ops.gain_reduce.launches = 0
    run = _serve_net(torch, net)
    launches = gr_ops.gain_reduce.launches
    if launches != NET_ROUNDS:
        raise AssertionError(f"fleet lossy quadratic: gain_reduce launched "
                             f"{launches} times in {NET_ROUNDS} rounds")
    _cpu_check(torch, "fleet lossy quadratic", net, run, 0, CHECK_ROUNDS)
    rows = _tier_bytes(net, run, TOL_LOSSY)
    print(f"[fleet lossy quadratic] {net.name}, {NET_ROUNDS} rounds: "
          f"gain_reduce launches {launches}; loss {run['losses'][0]:.4f} -> "
          f"{run['losses'][-1]:.4f}; {run['rounds_per_s']:.1f} rounds/s; "
          f"delivered bytes per agent and round vs budget: "
          f"{_budget_text(rows)}; budgets met: "
          f"{[r['tier'] for r in rows if r['within']]}, missed: "
          f"{[r['tier'] for r in rows if r['within'] is False]}; first "
          f"{CHECK_ROUNDS} rounds match the CPU")
    return {**_net_record(net, run), "launches": launches, "tiers": rows}


def phase_fleet_delayed(torch) -> tuple:
    """``TIERED_M64_ADAPTIVE_DELAYED`` (geometric latency, mean lag 2,
    depth 6, staleness discount 0.5) for NET_ROUNDS rounds: the CPU
    check, no payload applied older than ``max_lag``, and each metered
    tier's arrived bytes within TOL_BUDGET of its budget; then the
    fixed-λ ``TIERED_M64_DELAYED`` and ``TIERED_M64_DELAYED_NAIVE`` with
    their tail losses and wire bytes (printed)."""
    import numpy as np

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_ADAPTIVE_DELAYED,
        TIERED_M64_DELAYED,
        TIERED_M64_DELAYED_NAIVE,
    )

    from repro_torch.comm import CommPolicy

    net = TIERED_M64_ADAPTIVE_DELAYED
    max_lag = CommPolicy.parse(net.tiers[1].policy).channel_model().depth
    run = _serve_net(torch, net, keep=range(CHECK_ROUNDS))
    _cpu_check(torch, "fleet delayed", net, run, 0, CHECK_ROUNDS)
    # staleness counts silent rounds too (a gated agent's counter passes
    # max_lag: ROADMAP §3); the line bounds the age of every payload it
    # applies, read back from the weight w = 1 / (1 + discount·(age − 1))
    discount = CommPolicy.parse(net.tiers[1].policy).channel_model().discount
    stale = max(float(np.max(m["agent_staleness"])) for m in run["hist"])
    ages = [1.0 + (1.0 / w - 1.0) / discount for m in run["hist"]
            for w in np.asarray(m["agent_delivered"], np.float64) if w > 0]
    oldest = max(ages)
    if oldest > max_lag + 1e-3:
        raise AssertionError(f"fleet delayed: a payload applied at age "
                             f"{oldest:.3f}, past max_lag {max_lag}")
    arrived = _tier_bytes(net, run, TOL_BUDGET, arrived=True)
    weighted = _tier_bytes(net, run, TOL_BUDGET)
    record = {**_net_record(net, run), "max_staleness": stale,
              "max_applied_age": oldest, "tiers_arrived": arrived,
              "tiers_weighted": weighted}
    fixed = {}
    for other in (TIERED_M64_DELAYED, TIERED_M64_DELAYED_NAIVE):
        orun = _serve_net(torch, other)
        fixed[other.name] = _net_record(other, orun)
    record["fixed"] = fixed
    print(f"[fleet delayed] {net.name}, {NET_ROUNDS} rounds: loss "
          f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; oldest "
          f"applied payload {oldest:.3f} rounds (max_lag {max_lag}), max "
          f"staleness {stale:.0f}; "
          f"{run['rounds_per_s']:.1f} rounds/s; arrived bytes per agent and "
          f"round over the last {NET_TAIL} vs budget: {_budget_text(arrived)}"
          f"; at the discounted application weights: "
          f"{_budget_text(weighted)}; first {CHECK_ROUNDS} rounds match the "
          f"CPU")
    print("[fleet delayed] fixed lambda: " + "; ".join(
        f"{name}: tail loss {r['tail_loss']:.5f}, wire bytes "
        f"{r['wire_bytes']:.0f} of {r['wire_bytes_attempted']:.0f} attempted"
        f", {r['rounds_per_s']:.1f} rounds/s" for name, r in fixed.items()))
    if not all(r["within"] in (None, True) for r in arrived):
        raise AssertionError(f"fleet delayed: a metered tier's arrived bytes "
                             f"miss its budget by more than {TOL_BUDGET}: "
                             f"{_budget_text(arrived)}")
    return record, fixed[TIERED_M64_DELAYED.name]["wire_bytes"]


def phase_fleet_churn(torch, unchurned_wire_bytes: float) -> dict:
    """``TIERED_M64_DELAYED`` under ``churn_schedule(net, NET_ROUNDS)``:
    ``num_active`` equal to the schedule's count in every round, fewer
    wire bytes than the same fleet without churn, and the CPU check over
    the first CHECK_ROUNDS rounds and over CHURN_WINDOW, where the late
    agents join."""
    from repro_torch.configs.paper_linreg import (
        TIERED_M64_DELAYED,
        churn_schedule,
    )

    net = TIERED_M64_DELAYED
    churn = churn_schedule(net, NET_ROUNDS)
    lo, hi = CHURN_WINDOW
    run = _serve_net(torch, net, churn=churn,
                     keep=set(range(CHECK_ROUNDS)) | set(range(lo, hi)),
                     starts=(0, lo))
    want = [sum(j <= k < e for j, e in churn) for k in range(NET_ROUNDS)]
    got = [float(m["num_active"]) for m in run["hist"]]
    if got != [float(w) for w in want]:
        raise AssertionError(f"fleet churn: num_active {got} differs from "
                             f"the schedule's {want}")
    joins = sorted({j for j, _ in churn if j > 0})
    if not all(lo <= j < hi for j in joins):
        raise AssertionError(f"fleet churn: joins {joins} outside the "
                             f"checked window {CHURN_WINDOW}")
    _cpu_check(torch, "fleet churn", net, run, 0, CHECK_ROUNDS, churn)
    _cpu_check(torch, "fleet churn", net, run, lo, hi - lo, churn)
    record = {**_net_record(net, run), "num_active_min": min(got),
              "num_active_max": max(got),
              "unchurned_wire_bytes": unchurned_wire_bytes,
              "cpu_windows": [[0, CHECK_ROUNDS], [lo, hi]]}
    print(f"[fleet churn] {net.name} under churn_schedule: num_active "
          f"{min(got):.0f}..{max(got):.0f}, equal to the schedule in all "
          f"{NET_ROUNDS} rounds; wire bytes {record['wire_bytes']:.0f} vs "
          f"{unchurned_wire_bytes:.0f} without churn; "
          f"{run['rounds_per_s']:.1f} rounds/s; rounds 0-{CHECK_ROUNDS} and "
          f"{lo}-{hi} (joins at {joins}) match the CPU")
    if not record["wire_bytes"] < unchurned_wire_bytes:
        raise AssertionError("fleet churn: churn did not free wire bytes")
    return record


# ----------------------------------------------------------------------
# the dispatch paths and the frontier
# ----------------------------------------------------------------------

def _linreg_loss(torch):
    def loss_fn(params, batch):
        xs, ys = batch
        r = xs @ params["w"] - ys
        return 0.5 * torch.mean(r * r)

    return loss_fn


def _fleet_step(torch, net, dev, dispatch: str = "hybrid", cfg_lr=None,
                **options):
    """The fleet session's train step for ``net`` on TIERED_M64_CFG (or
    ``cfg_lr``; the loss, optimizer and policies of
    ``build_linreg_fleet_session``) on the ``dispatch`` path, with its
    initial state, config and optimizer; ``options`` go to
    ``StepOptions``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.paper_linreg import TIERED_M64_CFG
    from repro_torch.core.api import (
        StepOptions,
        init_train_state,
        make_triggered_train_step,
    )
    from repro_torch.optim import optimizers as opt_lib

    cfg_lr = cfg_lr or TIERED_M64_CFG
    cfg = TrainConfig(lr=cfg_lr.stepsize, optimizer="sgd",
                      num_agents=cfg_lr.num_agents,
                      comm=net.policies(lam_base=1.0))
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(
        _linreg_loss(torch), opt, cfg, device=dev,
        options=StepOptions(hetero_dispatch=dispatch, agent_metrics=True,
                            **options))
    state = init_train_state({"w": torch.zeros(cfg_lr.n)}, opt, cfg,
                             device=dev)
    return step, state, cfg, opt


def _tie_text(row: dict) -> str:
    entries = sum(s["entries"] for s in row["splits"])
    return (f"{len(row['ties'])} threshold ties, {entries} entries a "
            f"rounding step apart in {len(row['splits'])} rounds")


def _numpy_metrics(metrics) -> dict:
    return {k: v.cpu().numpy() for k, v in metrics.items()}


def _lane(state, g: int):
    """Lane ``g`` of a stacked TrainState (``step`` is shared)."""
    from repro_torch.utils.tree import tree_map

    return type(state)(state.step, *(
        None if f is None else tree_map(lambda x: x[g], f)
        for f in state[1:]))


def _gate_margin(torch, net, state, batch, agent: int, scale: float):
    """Agent ``agent``'s gain and transmit threshold in the round that
    starts from ``state``, from its own trigger on one agent's gradient
    (None for a trigger without a threshold)."""
    from repro_torch.comm.policy import CommPolicy
    from repro_torch.configs.paper_linreg import TIERED_M64_CFG
    from repro_torch.net import channels as net_lib

    pol = CommPolicy.parse(net.policies(lam_base=1.0)[agent])
    lam = pol.trigger.arg("lam")
    if not pol.is_adaptive and lam is None:
        return None  # always / never
    loss_fn = _linreg_loss(torch)
    trig = pol.build_trigger(loss_fn=loss_fn,
                             probe_eps=TIERED_M64_CFG.stepsize)
    ab = tuple(x[agent:agent + 1] for x in batch)
    g, loss = torch.func.grad_and_value(loss_fn)(state.params,
                                                 tuple(x[0] for x in ab))
    gain = float(trig.prologue(state.params,
                               {k: v.unsqueeze(0) for k, v in g.items()},
                               ab, loss.unsqueeze(0))[0])
    if pol.is_adaptive:
        # the controller's λ; staleness scales its target, not λ
        return gain, -float(state.ctrl_state[agent, 0])
    lam = float(lam) * float(scale)
    if pol.needs_net and state.net_state is not None:
        stale = float(net_lib.net_rows(state.net_state)[agent, 0])
        lam /= 1.0 + pol.channel_model().boost * stale
    return gain, -lam


def _rounding_ties(torch, net, g_eff):
    """Per agent and entry of ``g + ef`` (``g_eff``, numpy ``(A, n)``):
    the spacing of the agent's wire format where the entry lies within
    STEP_ATOL + 2·STEP_RTOL·``max|g + ef|`` of a rounding midpoint
    (``CompressorChain.rounding_ties``), else 0.  Two paths' ``g + ef``
    agree to STEP_RTOL of that maximum, and so do their int8 scales."""
    import numpy as np

    from repro_torch.comm.policy import CommPolicy

    x = torch.from_numpy(np.ascontiguousarray(g_eff, dtype=np.float32))
    tol = STEP_ATOL + 2.0 * STEP_RTOL * x.abs().amax(1, keepdim=True)
    out = torch.zeros_like(x)
    specs = net.policies(lam_base=1.0)
    for spec in set(specs):
        rows = [i for i, p in enumerate(specs) if p == spec]
        out[rows] = CommPolicy.parse(spec).chain().rounding_ties(
            x[rows], tol[rows])
    return out.numpy()


def _step_mismatch(a, b, g_eff, ties, lr: float):
    """Why the round ``a = (metrics, next state)`` disagrees with ``b``
    under ROADMAP's parity contract, or None, and how many entries
    needed a rounding step.  The realization (``EXACT_KEYS``) exactly;
    metrics, controller rows and channel rows within STEP_RTOL /
    STEP_ATOL; EF memory within STEP_RTOL of each agent's ``max|g + ef|``
    (``g_eff``: it carries the gradient's rounding), and so the delay
    line's payloads.  Two paths' gradients differ in the last place, so
    an entry of ``g + ef`` on a
    rounding boundary of its wire format may be sent one step apart
    (``ties``: that step at such an entry, 0 elsewhere, from
    ``_rounding_ties``): there, and only there, EF memory and the delay
    line's payloads may also differ by that step, and the parameters and
    ``grad_norm`` by the mean of the delivered agents' steps (× ``lr``)."""
    import numpy as np

    from repro_torch.convert import to_numpy
    from repro_torch.utils.tree import tree_leaves

    (am, anext), (bm, bnext) = a, b
    if set(am) != set(bm):
        return f"metric keys {sorted(set(am) ^ set(bm))}", 0
    for key in EXACT_KEYS:
        if key in bm and not np.array_equal(am[key], bm[key]):
            return key, 0
    amax = np.abs(g_eff).max(axis=1)
    got = np.asarray(bm.get("agent_delivered", bm["agent_tx"])) > 0
    # the delivered payloads' steps, through eq. (10), per coordinate
    agg = ties[got].sum(0) / max(int(got.sum()), 1)
    stepped = 0

    def close(x, y, extra=0.0, scale=None):
        nonlocal stepped
        diff = np.abs(np.asarray(x) - np.asarray(y))
        tol = STEP_ATOL + STEP_RTOL * np.abs(y if scale is None else scale)
        stepped += int(np.sum(diff > tol))
        return bool(np.all(diff <= tol + extra))

    for key in bm:
        extra = float(np.sqrt(np.sum(agg * agg))) if key == "grad_norm" \
            else 0.0
        if not close(am[key], bm[key], extra):
            return f"{key}: {am[key]} vs {bm[key]}", stepped
    if not close(to_numpy(anext.params)["w"], to_numpy(bnext.params)["w"],
                 lr * agg):
        return "params", stepped
    for name in ("ctrl_state", "net_state"):
        x, y = getattr(anext, name), getattr(bnext, name)
        if (x is None) != (y is None):
            return f"{name} slot", stepped
        if x is None:
            continue
        x, y = to_numpy(x), to_numpy(y)
        pairs = [(x, y, 0.0, None)]
        if isinstance(y, tuple):
            # a delay line: the slot written this round, (A, L, n), holds
            # the payload of g + ef, held like EF memory (to STEP_RTOL of
            # the agent's max|g + ef|), and a tied entry may sit one step
            # of its agent's format apart
            pairs = [((x[0], x[1]["meta"]), (y[0], y[1]["meta"]), 0.0, None),
                     (x[1]["buf"]["w"], y[1]["buf"]["w"], ties[:, None],
                      amax[:, None, None])]
        for u, v, extra, scale in pairs:
            for a_leaf, b_leaf in zip(tree_leaves(u), tree_leaves(v)):
                if not close(a_leaf, b_leaf, extra, scale):
                    return (f"{name}: max diff "
                            f"{np.abs(a_leaf - b_leaf).max():.3e}", stepped)
    if (anext.ef_memory is None) != (bnext.ef_memory is None):
        return "EF memory slot", stepped
    if bnext.ef_memory is not None:
        diff = np.abs(to_numpy(anext.ef_memory)["w"]
                      - to_numpy(bnext.ef_memory)["w"])
        tol = STEP_ATOL + STEP_RTOL * amax[:, None]
        stepped += int(np.sum(diff > tol))
        if not np.all(diff <= tol + ties):
            return f"ef_memory: max diff {diff.max():.3e}", stepped
    return None, stepped


def _g_eff(torch, state, batch):
    """Every agent's ``g + ef`` in the round from ``state`` (numpy)."""
    g = torch.func.vmap(torch.func.grad(_linreg_loss(torch)),
                        in_dims=(None, 0))(state.params, batch)["w"]
    if state.ef_memory is not None:
        g = g + state.ef_memory["w"]
    return g.cpu().numpy()


def _hold_round(torch, label, net, k, state, batch, got, want, scale,
                ties: list, splits: list) -> None:
    """Round ``k`` of two paths from the same ``state`` on ``batch``:
    ``got`` held to ``want`` (each ``(numpy metrics, next state)``) by
    ``_step_mismatch``.  A decision may differ only where the gain sits
    on its threshold within STEP_RTOL / STEP_ATOL (``ties`` records the
    agent, and the round's floats are not compared); ``splits`` records
    a round, and how many entries, whose payload-carrying state needed
    one rounding step of its wire format.  Every round starts both paths
    from one state, so neither carries over."""
    import numpy as np

    from repro_torch.configs.paper_linreg import TIERED_M64_CFG

    differ = np.flatnonzero(np.asarray(got[0]["agent_tx"])
                            != np.asarray(want[0]["agent_tx"]))
    for i in differ:
        margin = _gate_margin(torch, net, state, batch, int(i), scale)
        if margin is None or abs(margin[0] - margin[1]) > (
                STEP_ATOL + STEP_RTOL * abs(margin[1])):
            raise AssertionError(f"{label} round {k}: agent {i}'s decision "
                                 f"differs off its threshold (gain, "
                                 f"threshold: {margin})")
        ties.append({"round": k, "agent": int(i), "gain": margin[0],
                     "threshold": margin[1]})
    if differ.size:
        return
    g_eff = _g_eff(torch, state, batch)
    why, stepped = _step_mismatch(got, want, g_eff,
                                  _rounding_ties(torch, net, g_eff),
                                  TIERED_M64_CFG.stepsize)
    if why is not None:
        raise AssertionError(f"{label} round {k}: {why}")
    if stepped:
        splits.append({"round": k, "entries": stepped})


def phase_dispatch(torch, gr_ops) -> dict:
    """``TIERED_M64_QUADRATIC`` and ``TIERED_M64_ADAPTIVE_LOSSY`` under
    the ``switch`` and ``unroll`` paths on the [slice] problem and batch
    stream: DISPATCH_ROUNDS rounds of ``hybrid``, then each path's step
    from hybrid's state before every round, held to hybrid's round
    (``_hold_round``); ``gain_reduce`` launched once per kernel-gated
    agent (counted from the config) per round; each path's rounds/s over
    DISPATCH_ROUNDS rounds after a warm-up round, pulling each round's
    metrics as the session does."""
    from repro_torch.comm.policy import CommPolicy
    from repro_torch.configs.paper_linreg import (
        TIERED_M64_ADAPTIVE_LOSSY,
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator

    dev = torch.device("cuda", torch.cuda.current_device())
    problem = R.make_problem(TIERED_M64_CFG, step_generator(0, 0, dev),
                             device=dev)
    batches = [R.agent_batches(problem, step_generator(1, k, dev))
               for k in range(DISPATCH_ROUNDS + 1)]
    record = {}
    for net in (TIERED_M64_QUADRATIC, TIERED_M64_ADAPTIVE_LOSSY):
        gated = sum(CommPolicy.parse(p).trigger.arg("kernel") is True
                    for p in net.policies(lam_base=1.0))
        steps = {d: _fleet_step(torch, net, dev, d)[:2]
                 for d in ("hybrid", "switch", "unroll")}
        state, starts, want = steps["hybrid"][1], [], []
        for k in range(DISPATCH_ROUNDS):
            starts.append(state)
            state, m = steps["hybrid"][0](state, batches[k])
            want.append((_numpy_metrics(m), state))
        row = {"kernel_gated_agents": gated, "rounds": DISPATCH_ROUNDS}
        for d in ("switch", "unroll"):
            ties, splits = [], []
            gr_ops.gain_reduce.launches = 0
            got = [steps[d][0](starts[k], batches[k])
                   for k in range(DISPATCH_ROUNDS)]
            torch.cuda.synchronize()
            launches = gr_ops.gain_reduce.launches
            if launches != gated * DISPATCH_ROUNDS:
                raise AssertionError(
                    f"dispatch {net.name} {d}: gain_reduce launched "
                    f"{launches} times in {DISPATCH_ROUNDS} rounds, not "
                    f"{gated} per round")
            for k, (nxt, m) in enumerate(got):
                _hold_round(torch, f"dispatch {net.name} {d}", net, k,
                            starts[k], batches[k], (_numpy_metrics(m), nxt),
                            want[k], 1.0, ties, splits)
            row[d] = {"launches": launches, "ties": ties, "splits": splits}
        for d, (step, state) in steps.items():
            stamps = []
            for batch in batches:
                state, m = step(state, batch)
                _numpy_metrics(m)  # the session's pull of the round
                stamps.append(time.perf_counter())
            row.setdefault(d, {})["rounds_per_s"] = DISPATCH_ROUNDS / (
                stamps[-1] - stamps[0])
        record[net.name] = row
        print(f"[dispatch] {net.name}: switch and unroll match hybrid in "
              f"all {DISPATCH_ROUNDS} rounds (each from hybrid's state; "
              f"{_tie_text(row['switch'])} and {_tie_text(row['unroll'])})"
              f"; gain_reduce launches per "
              f"round: switch {row['switch']['launches'] // DISPATCH_ROUNDS}"
              f", unroll {row['unroll']['launches'] // DISPATCH_ROUNDS} "
              f"({gated} kernel-gated agents); rounds/s: hybrid "
              f"{row['hybrid']['rounds_per_s']:.1f}, switch "
              f"{row['switch']['rounds_per_s']:.2f}, unroll "
              f"{row['unroll']['rounds_per_s']:.2f}")
    return record


def _frontier_problem(torch, dev):
    """The [slice] problem and its batch stream (seed 0)."""
    from repro_torch.configs.paper_linreg import TIERED_M64_CFG
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator

    problem = R.make_problem(TIERED_M64_CFG, step_generator(0, 0, dev),
                             device=dev)
    return problem, lambda k: R.agent_batches(problem,
                                              step_generator(1, k, dev))


def _frontier_run(torch, net, scales, chans, batch_fn, rounds: int) -> dict:
    """``rounds`` rounds of the batched frontier step over ``net`` on
    TIERED_M64_CFG: the stacked state before each round (and the last),
    each round's metrics (numpy, pulled every round) and the rounds/s
    after CHECK_ROUNDS rounds."""
    import numpy as np

    from repro_torch.core.frontier import make_frontier_step, stack_states

    dev = torch.device("cuda", torch.cuda.current_device())
    _, state0, cfg, opt = _fleet_step(torch, net, dev)
    bstep = make_frontier_step(_linreg_loss(torch), opt, cfg, device=dev)
    s = torch.tensor(scales, dtype=torch.float32, device=dev)
    c = None if chans is None else torch.tensor(chans, dtype=torch.float32,
                                                device=dev)
    states = stack_states(state0, len(scales))
    run = {"states": [], "hist": [], "stamps": [], "bstep": bstep,
           "scales": s, "chans": c, "cfg": cfg, "opt": opt}
    for k in range(rounds):
        run["states"].append(states)
        states, m = bstep(states, batch_fn(k), s, c)
        run["hist"].append(_numpy_metrics(m))
        run["stamps"].append(time.perf_counter())
    run["states"].append(states)
    run["rounds_per_s"] = (rounds - 1 - CHECK_ROUNDS) / (
        run["stamps"][-1] - run["stamps"][CHECK_ROUNDS])
    if not all(np.isfinite(m["loss"]).all() for m in run["hist"]):
        raise AssertionError(f"frontier {net.name}: non-finite loss")
    return run


def _frontier_checks(torch, label, net, run, batch_fn, lanes) -> dict:
    """What every frontier phase checks:

    - lanes ``lanes`` against the plain step pinned at their scale
      (``StepOptions(scale=s)``, and the lane's ``chan_scale``), every
      round from the lane's state before it (``_hold_round``);
    - the first CHECK_ROUNDS rounds of every lane against the same
      batched step on the CPU, from the card's state before each round;
    - on a wire with a channel: every round's channel draws equal in
      all lanes (``_common_draws``), and on a loss channel, where two
      lanes of one severity both attempted, the same deliveries."""
    import numpy as np

    from repro_torch.core.frontier import make_frontier_step

    dev = torch.device("cuda", torch.cuda.current_device())
    scales = run["scales"].tolist()
    chans = None if run["chans"] is None else run["chans"].tolist()
    ties, splits = [], []
    for g in lanes:
        plain = _fleet_step(
            torch, net, dev, scale=scales[g],
            chan_scale=None if chans is None else chans[g])[0]
        for k, m in enumerate(run["hist"]):
            start = _lane(run["states"][k], g)
            nxt, pm = plain(start, batch_fn(k))
            _hold_round(torch, f"{label} lane {g}", net, k, start,
                        batch_fn(k),
                        ({key: v[g] for key, v in m.items()},
                         _lane(run["states"][k + 1], g)),
                        (_numpy_metrics(pm), nxt), scales[g], ties, splits)
    cpu_step = make_frontier_step(_linreg_loss(torch), run["opt"],
                                  run["cfg"], device="cpu")
    cpu_ties, cpu_splits = [], []
    for k in range(CHECK_ROUNDS):
        start = _to_cpu(run["states"][k])
        batch = tuple(x.cpu() for x in batch_fn(k))
        nxt, cm = cpu_step(start, batch, run["scales"].cpu(),
                           None if chans is None else run["chans"].cpu())
        cm = _numpy_metrics(cm)
        card_next = _to_cpu(run["states"][k + 1])
        for g in range(len(scales)):
            _hold_round(torch, f"{label} CPU lane {g}", net, k,
                        _lane(start, g), batch,
                        ({key: v[g] for key, v in run["hist"][k].items()},
                         _lane(card_next, g)),
                        ({key: v[g] for key, v in cm.items()},
                         _lane(nxt, g)), scales[g], cpu_ties, cpu_splits)
    out = {"plain_lanes": list(lanes),
           "plain": {"ties": ties, "splits": splits},
           "cpu_rounds": CHECK_ROUNDS,
           "cpu": {"ties": cpu_ties, "splits": cpu_splits}}
    if run["states"][0].net_state is None:
        return out
    out["common_draw_rounds"] = _common_draws(torch, label, net, run)
    if not isinstance(run["states"][0].net_state, tuple):
        # a loss channel (no payload line): the delivery of an attempt
        # is the round's draw itself
        pairs = [(a, b) for a in range(len(scales))
                 for b in range(a + 1, len(scales))
                 if chans is None or chans[a] == chans[b]]
        for m in run["hist"]:
            tx, dl = m["agent_tx"], m["agent_delivered"]
            for a, b in pairs:
                both = (tx[a] > 0) & (tx[b] > 0)
                if not np.array_equal(dl[a][both] > 0, dl[b][both] > 0):
                    raise AssertionError(
                        f"{label}: lanes {a} and {b} of one severity both "
                        f"attempted and delivered differently")
        out["same_severity_pairs"] = len(pairs)
    return out


def _common_draws(torch, label, net, run) -> int:
    """Every round's uniforms of each keyed channel seed, drawn from each
    lane's own channel rows as the step derives them (``round_keys`` of
    the rows' uid column, under the grid's vmap), equal in every lane."""
    from repro_torch import random as prng
    from repro_torch.comm.policy import CommPolicy
    from repro_torch.net import channels as net_lib

    models = [CommPolicy.parse(p).channel_model()
              for p in net.policies(lam_base=1.0)
              if CommPolicy.parse(p).needs_net]
    seeds = sorted({m.seed for m in models if m.keyed})
    for k, states in enumerate(run["states"][:-1]):
        rows = net_lib.net_rows(states.net_state)
        for seed in seeds:
            u = torch.func.vmap(lambda r: prng.uniform(
                net_lib.round_keys(seed, k, r[:, 2])))(rows)
            if not bool((u == u[:1]).all()):
                raise AssertionError(f"{label} round {k}: the lanes' draws "
                                     f"of channel seed {seed} differ")
    return len(run["hist"])


def _tier_rates(net, run, tail: int):
    """(G, tiers) bytes per agent and round over the last ``tail`` rounds."""
    import numpy as np

    tier_of = np.asarray(net.tier_index())
    ab = np.mean([m["agent_bytes"] for m in run["hist"][-tail:]], axis=0)
    return np.stack([ab[:, tier_of == t].mean(1)
                     for t in range(len(net.tiers))], 1)


def phase_frontier(torch) -> dict:
    """benchmarks/tiered_m64.py's frontiers on the card: each TIER_MIXES
    fleet over FRONTIER_SCALES (16 λ scales), TIERED_M64_CFG.steps
    rounds of one batched step on the [slice] problem and batches; the
    frontier checks (lanes FRONTIER_PLAIN_LANES against the plain step,
    10 rounds against the CPU), every lane learning (final J under the
    initial J); lanes × rounds per second, the wire bytes per lane and
    whether they fall with the scale (printed)."""
    import numpy as np

    from repro_torch.configs.paper_linreg import TIER_MIXES, TIERED_M64_CFG

    dev = torch.device("cuda", torch.cuda.current_device())
    problem, batch_fn = _frontier_problem(torch, dev)
    J0 = float(problem.J(torch.zeros_like(problem.w_star)))
    record = {}
    for net in TIER_MIXES:
        run = _frontier_run(torch, net, FRONTIER_SCALES, None, batch_fn,
                            TIERED_M64_CFG.steps)
        checks = _frontier_checks(torch, f"frontier {net.name}", net, run,
                                  batch_fn, FRONTIER_PLAIN_LANES)
        J = problem.J(run["states"][-1].params["w"]).tolist()
        if not all(j < J0 for j in J):
            raise AssertionError(f"frontier {net.name}: a lane did not "
                                 f"learn: J {J} vs initial {J0}")
        wire = np.sum([m["wire_bytes"] for m in run["hist"]], 0).tolist()
        record[net.name] = {
            "lanes": len(FRONTIER_SCALES), "rounds": TIERED_M64_CFG.steps,
            "rounds_per_s": run["rounds_per_s"],
            "lane_rounds_per_s": run["rounds_per_s"] * len(FRONTIER_SCALES),
            "J_initial": J0, "J_final": J, "wire_bytes": wire,
            "wire_falls_with_scale": bool(np.all(np.diff(wire) <= 1e-3)),
            **checks}
        print(f"[frontier] {net.name}: {len(FRONTIER_SCALES)} lanes x "
              f"{TIERED_M64_CFG.steps} rounds, {run['rounds_per_s']:.1f} "
              f"rounds/s = {record[net.name]['lane_rounds_per_s']:.0f} "
              f"lane-rounds/s; J {J0:.2f} -> {min(J):.4f}..{max(J):.4f}; "
              f"wire bytes {wire[0]:.0f} (scale 0) .. {wire[-1]:.0f} "
              f"(scale 20), falling with the scale: "
              f"{record[net.name]['wire_falls_with_scale']}; lanes "
              f"{list(FRONTIER_PLAIN_LANES)} match the plain step pinned at "
              f"their scale in every round ({_tie_text(checks['plain'])}), "
              f"every lane's first {CHECK_ROUNDS} rounds the CPU "
              f"({_tie_text(checks['cpu'])})")
    return record


def phase_frontier_quadratic(torch, gr_ops) -> tuple:
    """``TIERED_M64_QUADRATIC`` over FRONTIER_SCALES: the metered agents
    of all 16 lanes gated through ONE ``gain_reduce`` launch per round
    (the kernel's vmap rule folds the lanes into its rows: 16 × 64 rows
    of 32), counted from 0 over the run; the frontier checks."""
    from repro_torch.configs.paper_linreg import (
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )

    net = TIERED_M64_QUADRATIC
    dev = torch.device("cuda", torch.cuda.current_device())
    _, batch_fn = _frontier_problem(torch, dev)
    rounds = TIERED_M64_CFG.steps
    gr_ops.gain_reduce.launches = 0
    run = _frontier_run(torch, net, FRONTIER_SCALES, None, batch_fn, rounds)
    torch.cuda.synchronize()
    launches = gr_ops.gain_reduce.launches
    if launches != rounds:
        raise AssertionError(f"frontier quadratic: gain_reduce launched "
                             f"{launches} times in {rounds} rounds (want "
                             f"one per round for all lanes)")
    checks = _frontier_checks(torch, "frontier quadratic", net, run,
                              batch_fn, FRONTIER_PLAIN_LANES)
    G = len(FRONTIER_SCALES)
    record = {"lanes": G, "rounds": rounds, "launches": launches,
              "kernel_rows": G * TIERED_M64_CFG.num_agents,
              "rounds_per_s": run["rounds_per_s"],
              "lane_rounds_per_s": run["rounds_per_s"] * G, **checks}
    print(f"[frontier quadratic] {net.name}: {G} lanes x {rounds} rounds: "
          f"gain_reduce launches {launches} (one per round over "
          f"{G} x {TIERED_M64_CFG.num_agents} rows); "
          f"{run['rounds_per_s']:.1f} rounds/s = "
          f"{record['lane_rounds_per_s']:.0f} lane-rounds/s; lanes "
          f"{list(FRONTIER_PLAIN_LANES)} match the plain step, the first "
          f"{CHECK_ROUNDS} rounds the CPU ({_tie_text(checks['plain'])}; "
          f"{_tie_text(checks['cpu'])})")
    return record, run


def phase_frontier_lossy(torch) -> dict:
    """benchmarks/lossy_channels.py's surface: TIERED_M64_ADAPTIVE_LOSSY
    over LOSSY_BUDGET_SCALES × LOSSY_SEVERITIES (lane i: its controllers
    at scale × budget, scale × 20 % loss), NET_ROUNDS rounds; the
    frontier checks, every payload delivered in the lossless lanes, and
    each lane's metered tiers' delivered bytes over the last NET_TAIL
    rounds within TOL_LOSSY of their scaled budgets."""
    import numpy as np

    from repro_torch.configs.paper_linreg import TIERED_M64_ADAPTIVE_LOSSY

    net = TIERED_M64_ADAPTIVE_LOSSY
    dev = torch.device("cuda", torch.cuda.current_device())
    _, batch_fn = _frontier_problem(torch, dev)
    scales = [b for b in LOSSY_BUDGET_SCALES for _ in LOSSY_SEVERITIES]
    chans = [c for _ in LOSSY_BUDGET_SCALES for c in LOSSY_SEVERITIES]
    run = _frontier_run(torch, net, scales, chans, batch_fn, NET_ROUNDS)
    checks = _frontier_checks(torch, "frontier lossy", net, run, batch_fn,
                              LOSSY_PLAIN_LANES)
    for g, c in enumerate(chans):
        if c == 0.0 and not all(
                np.array_equal(m["agent_delivered"][g], m["agent_tx"][g])
                for m in run["hist"]):
            raise AssertionError(f"frontier lossy: lane {g} (severity 0) "
                                 f"lost a payload")
    rates = _tier_rates(net, run, NET_TAIL)
    budgets = np.asarray([t.wire_budget for t in net.tiers])
    metered = np.isfinite(budgets)
    rel = rates[:, metered] / (np.asarray(scales)[:, None]
                               * budgets[None, metered]) - 1.0
    record = {"lanes": [{"scale": s, "chan_scale": c,
                         "tier_bytes": dict(zip(
                             (t.name for t in net.tiers), r.tolist())),
                         "rel_err": e.tolist()}
                        for s, c, r, e in zip(scales, chans, rates, rel)],
              "rounds": NET_ROUNDS, "tail": NET_TAIL,
              "rounds_per_s": run["rounds_per_s"],
              "lane_rounds_per_s": run["rounds_per_s"] * len(scales),
              **checks}
    print(f"[frontier lossy] {net.name}: {len(scales)} lanes (budget scale"
          f" x severity) x {NET_ROUNDS} rounds, {run['rounds_per_s']:.1f} "
          f"rounds/s; delivered bytes of the metered tiers over the last "
          f"{NET_TAIL} rounds vs the scaled budgets: " + "; ".join(
              f"({s}, {c}) " + ", ".join(f"{e:+.3f}" for e in row)
              for s, c, row in zip(scales, chans, rel))
          + f"; severity-0 lanes deliver every payload; the lanes' draws "
          f"equal in all {checks['common_draw_rounds']} rounds; lanes "
          f"{list(LOSSY_PLAIN_LANES)} match the plain step, the first "
          f"{CHECK_ROUNDS} rounds the CPU ({_tie_text(checks['plain'])}; "
          f"{_tie_text(checks['cpu'])})")
    if not np.all(np.abs(rel) <= TOL_LOSSY):
        raise AssertionError(f"frontier lossy: a tier misses its scaled "
                             f"budget by more than {TOL_LOSSY}: {rel}")
    return record


def phase_frontier_drifting(torch) -> dict:
    """benchmarks/async_rounds.py's drifting target (amplitude DRIFT_AMP,
    period DRIFT_PERIOD: ``drifting_batch_fn``) under TIERED_M64_DELAYED,
    over DRIFT_SCALES × DRIFT_LAG_SCALES (λ scale × mean-lag scale),
    DRIFT_ROUNDS rounds: the frontier checks and every lane's tail loss
    (the last half's)."""
    import numpy as np

    from repro_torch.configs.paper_linreg import TIERED_M64_DELAYED
    from repro_torch.data.synthetic import drifting_batch_fn

    net = TIERED_M64_DELAYED
    dev = torch.device("cuda", torch.cuda.current_device())
    problem, _ = _frontier_problem(torch, dev)
    batch_fn = drifting_batch_fn(problem, amp=DRIFT_AMP,
                                 period=DRIFT_PERIOD, seed=0)
    scales = [s for s in DRIFT_SCALES for _ in DRIFT_LAG_SCALES]
    chans = [c for _ in DRIFT_SCALES for c in DRIFT_LAG_SCALES]
    run = _frontier_run(torch, net, scales, chans, batch_fn, DRIFT_ROUNDS)
    checks = _frontier_checks(torch, "frontier drifting", net, run,
                              batch_fn, DRIFT_PLAIN_LANES)
    tail = np.mean([m["loss"] for m in run["hist"][-DRIFT_ROUNDS // 2:]],
                   0).tolist()
    record = {"lanes": [{"scale": s, "lag_scale": c, "tail_loss": t}
                        for s, c, t in zip(scales, chans, tail)],
              "rounds": DRIFT_ROUNDS, "rounds_per_s": run["rounds_per_s"],
              "lane_rounds_per_s": run["rounds_per_s"] * len(scales),
              **checks}
    print(f"[frontier drifting] {net.name} on a drifting target (amp "
          f"{DRIFT_AMP}, period {DRIFT_PERIOD}): {len(scales)} lanes (λ "
          f"scale x lag scale) x {DRIFT_ROUNDS} rounds, "
          f"{run['rounds_per_s']:.1f} rounds/s; tail loss " + ", ".join(
              f"({s}, {c}) {t:.4f}" for s, c, t in zip(scales, chans, tail))
          + f"; the lanes' draws equal in all {checks['common_draw_rounds']}"
          f" rounds; lanes {list(DRIFT_PLAIN_LANES)} match the plain step, "
          f"the first {CHECK_ROUNDS} rounds the CPU "
          f"({_tie_text(checks['plain'])}; {_tie_text(checks['cpu'])})")
    return record


def _stack_trees(torch, states):
    """A list of TrainStates as one, every tensor leaf stacked along a
    new leading axis (``step`` the first's)."""
    from repro_torch.utils.tree import tree_map

    first = states[0]
    return type(first)(first.step, *(
        None if first[i] is None else tree_map(
            lambda *xs: torch.stack(xs), first[i],
            *(s[i] for s in states[1:]))
        for i in range(1, len(first))))


def _on_device(state, dev):
    from repro_torch.utils.tree import tree_map

    return type(state)(state.step, *(
        None if f is None else tree_map(lambda x: x.to(dev), f)
        for f in state[1:]))


def _shard_serve(torch, gr_ops, mesh, net, rounds: int) -> dict:
    """One gateway's session of ``net`` (the [slice] problem and batch
    stream: every rank draws the global batch, the step takes its
    slice) for ``rounds`` rounds, counting launches and collectives from
    0; the gathered per-round metrics and states before/after each
    round (on rank 0), the final params and rounds/s on every rank."""
    import numpy as np

    from repro_torch.configs.paper_linreg import TIERED_M64_CFG
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator
    from repro_torch.launch.session import build_linreg_fleet_session
    from repro_torch.sharding.agent_shard import gather_agents

    cfg, seed, dev = TIERED_M64_CFG, 0, mesh.device
    problem = R.make_problem(cfg, step_generator(seed, 0, dev), device=dev)
    hist, stamps, states = [], [], []
    session = None

    def on_round(k, metrics):
        stamps.append(time.perf_counter())
        hist.append(metrics)
        states.append(session.state)

    session = build_linreg_fleet_session(
        net=net, cfg_lr=cfg, seed=seed, device=dev, mesh=mesh,
        batch_fn=lambda k: R.agent_batches(
            problem, step_generator(seed + 1, k, dev)),
        on_round=on_round)
    states.append(session.state)
    gr_ops.gain_reduce.launches = 0
    mesh.collectives.reset()
    session.run(rounds)
    torch.cuda.synchronize()
    out = {"launches": gr_ops.gain_reduce.launches,
           "collectives": mesh.collectives.by_tag(),
           "rounds_per_s": (len(stamps) - 1 - CHECK_ROUNDS)
           / (stamps[-1] - stamps[CHECK_ROUNDS]),
           "params": session.state.params["w"].cpu(),
           "tiers": list(session.rollup.snapshot().get("tiers", {}))}
    metrics = gather_agents(
        {k: torch.from_numpy(np.stack([h[k] for h in hist]))
         for k in hist[0]}, mesh, axis=1)
    stacked = gather_agents(_stack_trees(torch, states), mesh, axis=1)
    if mesh.rank == 0:
        out["metrics"] = {k: v.numpy() for k, v in metrics.items()}
        out["states"] = stacked
    return out


def _shard_bytes(torch, mesh) -> dict:
    """The collectives of one sharded step of TIERED_M64_QUADRATIC's
    policies at m = 64 and of the same tiers 16 times over (m = 1024),
    on TIERED_M64_CFG's model: ``{m: {tag: counts}}``."""
    import dataclasses

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator
    from repro_torch.sharding.agent_shard import scatter_agents

    dev = mesh.device
    out = {}
    for m in (TIERED_M64_CFG.num_agents, SHARD_BIG_M):
        reps = m // TIERED_M64_CFG.num_agents
        net = dataclasses.replace(TIERED_M64_QUADRATIC, tiers=tuple(
            dataclasses.replace(t, count=t.count * reps)
            for t in TIERED_M64_QUADRATIC.tiers))
        cfg_lr = dataclasses.replace(TIERED_M64_CFG, num_agents=m)
        step, state, cfg, _ = _fleet_step(torch, net, dev, mesh=mesh,
                                          cfg_lr=cfg_lr)
        problem = R.make_problem(cfg_lr, step_generator(0, 0, dev),
                                 device=dev)
        batch = R.agent_batches(problem, step_generator(1, 0, dev))
        state = scatter_agents(state, mesh)
        mesh.collectives.reset()
        step(state, batch)
        torch.cuda.synchronize()
        out[m] = mesh.collectives.by_tag()
    return out


def _shard_sketch(torch, mesh) -> dict:
    """Sketch-native against the dense gateway: the params after
    SKETCH_ROUNDS rounds of SKETCH_SMALL at n = SKETCH_SMALL_N (m = 64,
    normal batches from seed 13), and the all_reduce operand bytes of
    one SKETCH_BIG step at n = SKETCH_BIG_N."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.api import init_train_state
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding.agent_shard import (
        make_sharded_train_step,
        scatter_agents,
    )

    dev, m = mesh.device, 64
    loss_fn = _linreg_loss(torch)
    out = {"params": {}, "operand_bytes": {}}
    for comm, n, rounds in ((SKETCH_SMALL, SKETCH_SMALL_N, SKETCH_ROUNDS),
                            (SKETCH_BIG, SKETCH_BIG_N, 1)):
        cfg = TrainConfig(lr=0.1, optimizer="sgd", num_agents=m, comm=comm)
        opt = opt_lib.from_config(cfg)
        for native in (False, True):
            step = make_sharded_train_step(loss_fn, opt, cfg, mesh,
                                           sketch_native=native, device=dev)
            gen = torch.Generator(dev).manual_seed(13)
            state = scatter_agents(init_train_state(
                {"w": torch.randn(n, generator=gen, device=dev)}, opt, cfg,
                device=dev), mesh)
            mesh.collectives.reset()
            for _ in range(rounds):
                batch = (torch.randn(m, 8, n, generator=gen, device=dev),
                         torch.randn(m, 8, generator=gen, device=dev))
                state, metrics = step(state, batch)
            torch.cuda.synchronize()
            if n == SKETCH_BIG_N:
                out["operand_bytes"][native] = mesh.collectives.stats()[
                    "all-reduce"]["operand_bytes"]
            else:
                out["params"][native] = (state.params["w"].cpu(),
                                         float(metrics["num_tx"]),
                                         float(metrics["wire_bytes"]))
    return out


def _shard_frontier_rank(torch, gr_ops, mesh) -> dict:
    """One gateway's quadratic frontier over FRONTIER_SCALES for
    TIERED_M64_CFG.steps rounds (``make_frontier_step(mesh=)`` on the
    [slice] batch stream): launches and collectives counted from 0, the
    gathered stacked state before each round and the metrics (rank 0),
    rounds/s."""
    import numpy as np

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.core.frontier import make_frontier_step, stack_states
    from repro_torch.sharding.agent_shard import gather_agents, scatter_agents

    dev = mesh.device
    _, batch_fn = _frontier_problem(torch, dev)
    _, state0, cfg, opt = _fleet_step(torch, TIERED_M64_QUADRATIC, dev)
    bstep = make_frontier_step(_linreg_loss(torch), opt, cfg, mesh=mesh,
                               device=dev)
    scales = torch.tensor(FRONTIER_SCALES, dtype=torch.float32, device=dev)
    states = [stack_states(scatter_agents(state0, mesh), len(scales))]
    hist, stamps = [], []
    gr_ops.gain_reduce.launches = 0
    mesh.collectives.reset()
    for k in range(TIERED_M64_CFG.steps):
        nxt, m = bstep(states[-1], batch_fn(k), scales)
        hist.append(_numpy_metrics(m))
        stamps.append(time.perf_counter())
        states.append(nxt)
    torch.cuda.synchronize()
    out = {"launches": gr_ops.gain_reduce.launches,
           "collectives": mesh.collectives.by_tag(),
           "rounds_per_s": (len(stamps) - 1 - CHECK_ROUNDS)
           / (stamps[-1] - stamps[CHECK_ROUNDS])}
    metrics = gather_agents(
        {k: torch.from_numpy(np.stack([h[k] for h in hist]))
         for k in hist[0]}, mesh, axis=2)
    stacked = gather_agents(_stack_trees(torch, states), mesh, axis=2)
    if mesh.rank == 0:
        out["metrics"] = {k: v.numpy() for k, v in metrics.items()}
        out["states"] = stacked
    return out


def _shard_probes(torch, mesh) -> dict:
    """Where a sharded round's time goes, on every rank at once: the two
    ``all_reduce`` calls of a round alone (the payload's 32 floats and
    the 9 packed scalars, synchronized; median of SHARD_PROBE_CALLS
    pairs) on CUDA tensors, and under gloo also staged through host
    copies (each tensor copied to the CPU, reduced there, copied back);
    and the unsharded [slice] session run by all ranks at once (the card
    time-sliced between SHARD_GATEWAYS processes): its rounds/s."""
    import statistics as stats

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator
    from repro_torch.launch.session import build_linreg_fleet_session

    dev = mesh.device

    def pair_ms(staged: bool) -> float:
        operands = (torch.zeros(TIERED_M64_CFG.n, device=dev),
                    torch.zeros(5 + mesh.size, device=dev))
        pairs = []
        for i in range(SHARD_PROBE_CALLS + 10):
            t = time.perf_counter()
            for x in operands:
                if staged:
                    x.copy_(mesh.all_reduce(x.cpu(), "probe"))
                else:
                    mesh.all_reduce(x, "probe")
            torch.cuda.synchronize()
            if i >= 10:
                pairs.append(time.perf_counter() - t)
        return 1e3 * stats.median(pairs)

    out = {"all_reduce_pair_ms": pair_ms(False),
           "all_reduce_pair_host_staged_ms": (
               pair_ms(True) if mesh.backend == "gloo" else None)}
    problem = R.make_problem(TIERED_M64_CFG, step_generator(0, 0, dev),
                             device=dev)
    stamps = []
    session = build_linreg_fleet_session(
        net=TIERED_M64_QUADRATIC, cfg_lr=TIERED_M64_CFG, seed=0, device=dev,
        batch_fn=lambda k: R.agent_batches(problem,
                                           step_generator(1, k, dev)),
        on_round=lambda k, m: stamps.append(time.perf_counter()))
    mesh.barrier()
    session.run(SHARD_PROBE_ROUNDS)
    torch.cuda.synchronize()
    out["contended_rounds_per_s"] = (len(stamps) - 1 - CHECK_ROUNDS) / (
        stamps[-1] - stamps[CHECK_ROUNDS])
    return out


def _shard_rank(mesh) -> dict:
    """Everything [shard] and [shard frontier] run on one gateway rank
    (a process of its own: ``spawn`` starts it)."""
    import torch

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_ADAPTIVE_LOSSY,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.kernels.gain_reduce import ops as gr_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {
        "rank": mesh.rank, "backend": mesh.backend, "world": mesh.size,
        "device": str(mesh.device),
        "quadratic": _shard_serve(torch, gr_ops, mesh, TIERED_M64_QUADRATIC,
                                  SHARD_ROUNDS),
        "lossy": _shard_serve(torch, gr_ops, mesh, TIERED_M64_ADAPTIVE_LOSSY,
                              NET_ROUNDS),
        "bytes": _shard_bytes(torch, mesh),
        "sketch": _shard_sketch(torch, mesh),
        "frontier": _shard_frontier_rank(torch, gr_ops, mesh),
        "probes": _shard_probes(torch, mesh),
    }


def _shard_hold(torch, label, net, run, batch_fn, step, scale: float,
                lane=None) -> dict:
    """Every round of a gathered sharded run held to ``step`` (the
    single-process step, or the unsharded frontier step when ``lane`` is
    given) from the same state on the same batch (``_hold_round``)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    ties, splits = [], []
    for k in range(len(run["metrics"]["loss"])):
        start = _on_device(_lane(run["states"], k), dev)._replace(step=k)
        got_next = _lane(run["states"], k + 1)
        got_m = {key: v[k] for key, v in run["metrics"].items()}
        batch = batch_fn(k)
        nxt, m = step(start, batch) if lane is None else step(
            start, batch, torch.tensor(FRONTIER_SCALES, dtype=torch.float32,
                                       device=dev))
        want = (_numpy_metrics(m), nxt)
        if lane is not None:
            start, got_next, nxt = (_lane(start, lane),
                                    _lane(got_next, lane), _lane(nxt, lane))
            got_m = {key: v[lane] for key, v in got_m.items()}
            want = ({key: v[lane] for key, v in want[0].items()}, nxt)
        _hold_round(torch, label, net, k, start, batch, (got_m, got_next),
                    want, scale, ties, splits)
    return {"ties": ties, "splits": splits}


def phase_shard(torch, card: str, rates: dict) -> dict:
    """The [shard] phase (the module docstring's): one spawn of
    SHARD_GATEWAYS ranks runs every gateway program, [shard frontier]'s
    too, and the checks here hold the gathered results.  ``rates`` are
    the unsharded runs' rounds/s ([slice], [fleet lossy], [frontier
    quadratic]) measured earlier in this call."""
    import numpy as np

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_ADAPTIVE_LOSSY,
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.launch.mesh import choose_backend, spawn

    dev = torch.device("cuda", torch.cuda.current_device())
    backend = choose_backend(SHARD_GATEWAYS, "cuda")
    print(f"[shard] backend {backend}, world {SHARD_GATEWAYS}, "
          f"torch.cuda.device_count() {torch.cuda.device_count()}, card "
          f"{card}")
    t0 = time.perf_counter()
    ranks = spawn(_shard_rank, SHARD_GATEWAYS, timeout_s=SHARD_TIMEOUT_S,
                  backend=backend, device="cuda")
    spawn_s = time.perf_counter() - t0
    if [r["rank"] for r in ranks] != list(range(SHARD_GATEWAYS)) or any(
            r["backend"] != backend for r in ranks):
        raise AssertionError(f"shard: ranks {[(r['rank'], r['backend']) for r in ranks]}")
    problem, batch_fn = _frontier_problem(torch, dev)
    record = {"backend": backend, "world": SHARD_GATEWAYS,
              "cuda_device_count": torch.cuda.device_count(),
              "rank_devices": [r["device"] for r in ranks],
              "spawn_s": spawn_s}
    for key, net, rounds, unsharded in (
            ("quadratic", TIERED_M64_QUADRATIC, SHARD_ROUNDS,
             rates["slice"]),
            ("lossy", TIERED_M64_ADAPTIVE_LOSSY, NET_ROUNDS,
             rates["fleet_lossy"])):
        runs = [r[key] for r in ranks]
        run = runs[0]
        launches = [r["launches"] for r in runs]
        payload = [r["collectives"]["payload"]["count"] for r in runs]
        scalars = [r["collectives"]["scalars"]["count"] for r in runs]
        if payload != [rounds] * SHARD_GATEWAYS or scalars != payload:
            raise AssertionError(f"shard {net.name}: payload all_reduce "
                                 f"{payload}, scalars {scalars} in {rounds} "
                                 f"rounds (want one each per round)")
        if key == "quadratic" and launches != [rounds] * SHARD_GATEWAYS:
            raise AssertionError(f"shard {net.name}: gain_reduce launches "
                                 f"per rank {launches} in {rounds} rounds "
                                 f"(want one per round on every rank)")
        if not all(torch.equal(r["params"], run["params"]) for r in runs):
            raise AssertionError(f"shard {net.name}: the ranks' params "
                                 f"differ")
        losses = run["metrics"]["loss"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"shard {net.name}: loss {losses[0]} -> "
                                 f"{losses[-1]}")
        step = _fleet_step(torch, net, dev)[0]
        held = _shard_hold(torch, f"shard {net.name}", net, run, batch_fn,
                           step, 1.0)
        rate = float(np.median([r["rounds_per_s"] for r in runs]))
        row = {"net": net.name, "rounds": rounds, "launches_per_rank":
               launches, "payload_all_reduce_per_rank": payload,
               "collectives_rank0": run["collectives"],
               "rounds_per_s": rate, "unsharded_rounds_per_s": unsharded,
               "loss_first": float(losses[0]),
               "loss_last": float(losses[-1]),
               "gateway_tiers": [r["tiers"] for r in runs], **held}
        text = ""
        if key == "lossy":
            hist = [{k: v[i] for k, v in run["metrics"].items()}
                    for i in range(rounds)]
            rows = _tier_bytes(net, {"hist": hist}, TOL_BUDGET)
            row["tier_bytes"] = rows
            text = f"; delivered bytes/agent/round vs budget: " \
                   f"{_budget_text(rows)}"
        record[key] = row
        print(f"[shard] {net.name} x {rounds} rounds on {SHARD_GATEWAYS} "
              f"gateways of {TIERED_M64_CFG.num_agents // SHARD_GATEWAYS} "
              f"agents ({backend}): gain_reduce launches per rank "
              f"{launches}; payload all_reduce per rank {payload}; every "
              f"round held to the single-process hybrid step "
              f"({_tie_text(held)}); loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; {rate:.1f} rounds/s sharded vs "
              f"{unsharded:.1f} unsharded{text}")

    tags = [r["bytes"] for r in ranks]
    m0, m1 = TIERED_M64_CFG.num_agents, SHARD_BIG_M
    payload_b = TIERED_M64_CFG.n * 4
    scalars_b = (5 + SHARD_GATEWAYS) * 4
    for t in tags:
        per = {m: (t[m]["payload"]["operand_bytes"],
                   t[m]["scalars"]["operand_bytes"],
                   sum(v["count"] for v in t[m].values())) for m in (m0, m1)}
        if per[m0] != per[m1] or per[m0] != (payload_b, scalars_b, 2):
            raise AssertionError(f"shard: all_reduce operand bytes per step "
                                 f"{per} (want {payload_b} + {scalars_b} in "
                                 f"2 calls at both m)")
    record["operand_bytes"] = {str(m): tags[0][m] for m in (m0, m1)}
    sk = ranks[0]["sketch"]
    ops = sk["operand_bytes"]
    (dense_w, dense_tx, dense_wire), (nat_w, nat_tx, nat_wire) = (
        sk["params"][False], sk["params"][True])
    gap = float((dense_w - nat_w).abs().max())
    if not (ops[True] < ops[False] and gap < 1e-5
            and (dense_tx, dense_wire) == (nat_tx, nat_wire)):
        raise AssertionError(f"shard sketch-native: operand bytes {ops}, "
                             f"params gap {gap}, (num_tx, wire) "
                             f"{(dense_tx, dense_wire)} vs "
                             f"{(nat_tx, nat_wire)}")
    record["sketch_native"] = {"operand_bytes": {
        "dense": ops[False], "sketch_native": ops[True]},
        "params_gap": gap}
    print(f"[shard] all_reduce operand bytes per step {payload_b} + "
          f"{scalars_b} in 2 calls at m = {m0} and m = {m1} on every rank; "
          f"sketch-native at n = {SKETCH_BIG_N}: {ops[True]} operand bytes "
          f"vs the dense gateway's {ops[False]}; at n = {SKETCH_SMALL_N} "
          f"its params within {gap:.2e} of the dense gateway's; the spawn "
          f"took {spawn_s:.1f} s")

    fr = [r["frontier"] for r in ranks]
    rounds = TIERED_M64_CFG.steps
    launches = [r["launches"] for r in fr]
    payload = [r["collectives"]["payload"] for r in fr]
    lanes = len(FRONTIER_SCALES)
    if launches != [rounds] * SHARD_GATEWAYS or any(
            p["count"] != rounds
            or p["operand_bytes"] != rounds * lanes * payload_b
            for p in payload):
        raise AssertionError(f"shard frontier: gain_reduce launches "
                             f"{launches}, payload all_reduce {payload} in "
                             f"{rounds} rounds (want one each per round)")
    _, _, cfg, opt = _fleet_step(torch, TIERED_M64_QUADRATIC, dev)
    from repro_torch.core.frontier import make_frontier_step

    bstep = make_frontier_step(_linreg_loss(torch), opt, cfg, device=dev)
    held = {g: _shard_hold(torch, f"shard frontier lane {g}",
                           TIERED_M64_QUADRATIC, fr[0], batch_fn, bstep,
                           FRONTIER_SCALES[g], lane=g)
            for g in FRONTIER_PLAIN_LANES}
    rate = float(np.median([r["rounds_per_s"] for r in fr]))
    record["frontier"] = {
        "lanes": lanes, "rounds": rounds, "launches_per_rank": launches,
        "payload_all_reduce_per_rank": [p["count"] for p in payload],
        "rounds_per_s": rate, "lane_rounds_per_s": rate * lanes,
        "unsharded_rounds_per_s": rates["frontier_quadratic"],
        "held_lanes": {str(g): h for g, h in held.items()}}
    probes = [r["probes"] for r in ranks]
    pair_ms = float(np.median([p["all_reduce_pair_ms"] for p in probes]))
    staged = [p["all_reduce_pair_host_staged_ms"] for p in probes]
    staged_ms = None if None in staged else float(np.median(staged))
    contended = float(np.median([p["contended_rounds_per_s"]
                                 for p in probes]))
    record["probes"] = {"per_rank": probes, "all_reduce_pair_ms": pair_ms,
                        "all_reduce_pair_host_staged_ms": staged_ms,
                        "contended_rounds_per_s": contended}
    staged_text = "" if staged_ms is None else (
        f", {staged_ms:.3f} ms staged through host copies")
    print(f"[shard] where a sharded round goes: the two all_reduce calls "
          f"alone {pair_ms:.3f} ms a round on CUDA tensors ({backend}; "
          f"median over ranks of each rank's median of "
          f"{SHARD_PROBE_CALLS}){staged_text}; the unsharded [slice] "
          f"session on all {SHARD_GATEWAYS} ranks at once {contended:.1f} "
          f"rounds/s each (alone, earlier: {rates['slice']:.1f})")
    print(f"[shard frontier] {TIERED_M64_QUADRATIC.name}: {lanes} lanes x "
          f"{rounds} rounds on {SHARD_GATEWAYS} gateways: gain_reduce "
          f"launches per rank {launches}, payload all_reduce per rank "
          f"{[p['count'] for p in payload]} ({lanes} lanes x {payload_b} "
          f"bytes each); lanes {list(FRONTIER_PLAIN_LANES)} held to the "
          f"unsharded frontier step every round ("
          + "; ".join(_tie_text(h) for h in held.values())
          + f"); {rate:.1f} rounds/s sharded vs "
          f"{rates['frontier_quadratic']:.1f} unsharded")
    return record


# ----------------------------------------------------------------------
# [mesh]: the LM train step over a (data, model) mesh of gloo ranks
# ----------------------------------------------------------------------

def _mesh_batches(torch, cfg, agents: int, per: int, seq: int, steps: int,
                  dev):
    """``steps`` LM batches of uniform tokens (seeds 20, 21, ...; the
    labels are the tokens shifted by one) on ``dev``: every rank draws
    the same global batches.  (``lm_batch``'s bigram table would be
    vocab² floats: 61 GiB at llama's 128256.)  phi-3-vision's also hold
    ``num_patches`` patch embeddings, whisper's ``seq`` frames and
    min(seq, 448) decoder tokens, both 0.02·N(0, 1) as ``lm_batch``
    draws them."""
    from repro_torch.configs.whisper_medium import DECODER_LEN

    out = []
    audio = cfg.is_encoder_decoder
    for k in range(steps):
        gen = torch.Generator(device=dev).manual_seed(20 + k)
        n = min(seq, DECODER_LEN) if audio else seq
        toks = torch.randint(0, cfg.vocab_size, (agents, per, n + 1),
                             generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": toks[..., :-1].contiguous(),
                 "labels": toks[..., 1:].contiguous()}
        if audio or cfg.num_patches:
            key = "frame_embeds" if audio else "patch_embeds"
            rows = seq if audio else cfg.num_patches
            batch[key] = 0.02 * torch.randn(
                (agents, per, rows, cfg.d_model), generator=gen,
                device=dev)
        out.append(batch)
    return out


def _mesh_cfg(name: str):
    from repro_torch.configs import get_config

    run = MESH_RUNS[name]
    cfg = get_config(run["arch"]).replace(num_layers=run["layers"])
    if "encoder_layers" in run:
        cfg = cfg.replace(encoder_layers=run["encoder_layers"])
    return cfg, run


def _mesh_params(torch, model, dev):
    """The run's weights: seed 0 on the rank's card (every rank and the
    single-process reference draw the same)."""
    return model.init(torch.Generator(device=dev).manual_seed(0))[0]


def _cpu_tree(tree):
    from repro_torch.utils.tree import tree_flatten_with_path

    return {p: x.detach().cpu() for p, x in tree_flatten_with_path(tree)}


def _mesh_key(run: str, comm) -> str:
    """A single-process reference's key: the run and its policy."""
    return run if comm == MESH_COMM else f"{run}:{_comm_name(comm)}"


def _comm_name(comm) -> str:
    return "tiers" if isinstance(comm, tuple) else (
        "delay" if comm == MESH_DELAY else str(comm))


def _mesh_plan(cfg, run: dict, comm, mesh=None, fsdp=None, knobs=None):
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S

    shape = InputShape("mesh", run["seq"], run["agents"] * run["per_agent"],
                       "train")
    return S.plan_run(cfg, shape, mesh, num_agents=run["agents"],
                      comm=comm, lr=MESH_LR, fsdp=fsdp, **(knobs or {}))


def _policy_ties(torch, comm, agents: int, grads: dict) -> tuple:
    """Per leaf of the agents' first-step gradients (EF memory 0, so
    ``g + ef`` is g; ``(agents, *shape)`` on the card): the step of each
    agent's wire format where an entry lies within TRAIN_TOL · its
    max|g| of a rounding midpoint (``CompressorChain.rounding_ties``) or
    of a leading ``topk`` stage's threshold (the k-th largest |g|: kept
    or not, the entry is sent as its wire value or as 0, so the step is
    |g| and the chain's rounding spacing), else 0, on the CPU; and each
    agent's max|g| per leaf.  Two computations of g within that gap may
    send such entries, and only those, one step apart."""
    from repro_torch.comm.policy import CommPolicy

    specs = comm if isinstance(comm, tuple) else (comm,) * agents
    chains = [CommPolicy.parse(p).chain() for p in specs]
    ties, amax = {}, {}
    for path, g in grads.items():
        top = g.abs().amax(dim=tuple(range(1, g.ndim)))
        out = torch.zeros_like(g)
        for i, chain in enumerate(chains):
            if not chain.stages:
                continue
            gi, tol = g[i:i + 1], TRAIN_TOL * top[i]
            step = chain.rounding_ties(gi, tol)
            first = chain.stages[0].spec
            if first.name == "topk":
                flat = gi.abs().reshape(1, -1)
                k = max(1, int(float(first.arg("frac")) * flat.shape[1]))
                thr = torch.topk(flat, k, dim=1).values[:, -1]
                kept = ((gi.abs() - thr).abs() <= tol)
                step = torch.where(kept, torch.maximum(
                    step, gi.abs() + chain.spacing(gi)), step)
            out[i:i + 1] = step
        ties[path], amax[path] = out.cpu(), top.cpu()
    return ties, amax


def _mesh_reference(torch, ce_ops, swa_ops, name: str, comm, dev) -> dict:
    """The single-process step (no mesh) of run ``name`` under ``comm`` on
    the card from seed 0: its per-step metrics (with the per-agent
    vectors) and ms, the parameters after the first and the last step,
    and the agents' first-step gradients (for the int8 exemptions) or,
    for the per-agent jobs, each agent's rounding ties and max|g| and the
    per-agent slots after the first step, all on the CPU; launches per
    step."""
    from repro_torch.comm.bank import batch_prologue
    from repro_torch.core.api import init_train_state
    from repro_torch.launch import steps as S
    from repro_torch.models import build
    from repro_torch.optim import optimizers as opt_lib

    cfg, run = _mesh_cfg(name)
    batches = _mesh_batches(torch, cfg, run["agents"], run["per_agent"],
                            run["seq"], run["steps"], dev)
    plan = _mesh_plan(cfg, run, comm)
    step = S.build_train_step(plan, compute_dtype="float32", device=dev,
                              agent_metrics=True)
    model = build(plan.cfg)
    opt = opt_lib.from_config(plan.train_cfg)
    state = init_train_state(_mesh_params(torch, model, dev), opt,
                             plan.train_cfg, device=dev)
    _, grads = batch_prologue(model.loss_fn)(state.params, batches[0])
    out = {"steps": []}
    if cfg.moe is not None:
        out["drops"] = _moe_drops(torch, model, state.params, batches[0],
                                  range(run["agents"]))
    if comm == MESH_COMM:
        out["grads"] = _cpu_tree(grads)
    else:
        out["ties"], out["amax"] = _policy_ties(
            torch, comm, run["agents"], _flat_tree(grads))
    del grads
    torch.cuda.empty_cache()
    for k, b in enumerate(batches):
        ce0, swa0 = ce_ops.fused_ce.launches, swa_ops.swa_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        print(f"[mesh] rank 0 single-process {_mesh_key(name, comm)} step "
              f"{k}: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        out["steps"].append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "metrics": {key: v.cpu() for key, v in m.items()},
            "launches": (swa_ops.swa_attention.launches - swa0,
                         ce_ops.fused_ce.launches - ce0)})
        if k == 0:
            out["first"] = _cpu_tree(state.params)
            if comm != MESH_COMM:
                out["slots"] = {slot: _cpu_tree(getattr(state, slot))
                                for slot in _SLOTS
                                if getattr(state, slot) is not None}
    out["last"] = (out["first"] if len(batches) == 1
                   else _cpu_tree(state.params))
    del state, step, batches, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


_SLOTS = ("ef_memory", "ctrl_state", "net_state")


def _moe_drops(torch, model, params, batch, agents, active=None) -> list:
    """Per agent (``agents``: its indices in ``batch``), each moe layer's
    (T, K) mask of the (token, k) pairs dropped past their expert's
    capacity, on the CPU, from one forward of the agent's loss (called
    directly: no ``torch.func`` transform, so the layers can record);
    ``active`` is a mesh step's context (the rank's blocks and part of
    the tokens; the routing sees the agent's whole token set)."""
    import contextlib

    from repro_torch.models import moe as MOE

    out = []
    for i in agents:
        one = {k: v[i] for k, v in batch.items()}
        with (active() if active else contextlib.nullcontext()), \
                MOE.record_drops() as rec, torch.no_grad():
            model.loss_fn(params, one)
        out.append(list(rec))
    return out


def _flat_tree(tree):
    """``{path: leaf}`` of a tree, each left on its device."""
    from repro_torch.utils.tree import tree_flatten_with_path

    return dict(tree_flatten_with_path(tree))


def _hold_slots(torch, mesh, state, shardings, ref) -> dict:
    """After the first step of a per-agent job: every leaf of the EF
    memory, the controller rows and the channel slot (a delay line's
    metadata and payloads) gathered over the agent axes one at a time (a
    collective every rank calls) and, on rank 0, held to the
    single-process step's (``ref``): rows and metadata within TRAIN_TOL
    (relative, 1e-6 absolute), EF memory and payloads within TRAIN_TOL of
    the agent's max|g| on that leaf, plus one step of its wire format
    where its g lies at a rounding midpoint.  Returns, on rank 0, the
    largest gap over that scale away from such midpoints and the
    elements that needed a step."""
    from repro_torch.utils.tree import tree_flatten_with_path

    worst, stepped, leaves = 0.0, 0, 0
    for slot in _SLOTS:
        local = getattr(state, slot)
        if local is None:
            continue
        sh = dict(tree_flatten_with_path(getattr(shardings, slot)))
        for path, x in tree_flatten_with_path(local):
            full = sh[path].gather(x)
            if mesh.rank == 0:
                # on the card, a leaf at a time
                got = full.float()
                want = ref["slots"][slot][path].to(got.device).float()
                leaf = path[2:] if slot == "net_state" else path
                if leaf in ref["amax"] and want.ndim > 1:
                    # EF memory (A, *shape) or a line's payloads
                    # (A, depth, *shape)
                    lead = want.ndim - ref["ties"][leaf].ndim + 1
                    view = (-1,) + (1,) * (want.ndim - 1)
                    scale = ref["amax"][leaf].to(got.device).reshape(view)
                    ties = ref["ties"][leaf].to(got.device)
                    if lead == 2:
                        ties = ties[:, None]
                    diff = (got - want).abs()
                    tol = 1e-6 + TRAIN_TOL * scale
                    bad = diff > tol + ties
                    if bool(bad.any()):
                        where = bad.nonzero()[0].tolist()
                        raise AssertionError(
                            f"mesh {slot} {'/'.join(map(str, path))}: "
                            f"{(diff / scale).max().item():.3e} of the "
                            f"agent's max|g| (first at {where}: "
                            f"{got[tuple(where)].item():.6g} vs "
                            f"{want[tuple(where)].item():.6g})")
                    stepped += int((diff > tol).sum())
                    worst = max(worst, (diff * (ties == 0) / scale)
                                .max().item())
                else:
                    diff = (got - want).abs()
                    if not bool((diff <= 1e-6 + TRAIN_TOL * want.abs())
                                .all()):
                        raise AssertionError(
                            f"mesh {slot} {'/'.join(map(str, path))}: "
                            f"max diff {diff.max().item():.3e}")
                leaves += 1
                del got, want
            del full
    return {"worst": worst, "stepped": stepped, "leaves": leaves}


def _mesh_job(torch, ce_ops, swa_ops, mesh, job: str, keep: bool = False,
              against=None, ref=None) -> dict:
    """The steps of MESH_JOBS[``job``] on ``mesh`` from seed 0: per step
    the launches, the collectives by kind and axis, the ms and the
    fleet's metrics; the bytes at rest and this rank's peak; with
    ``keep`` the rank's blocks at rest after the first and the last step
    (CPU); and either, on rank 0, the gathered parameters then, or, with
    ``against`` (another job's result on this rank, its blocks a
    superset of these), the largest gap of this rank's blocks from that
    job's over every rank (one small ``all_reduce``: no gather).  A
    per-agent job holds its per-agent slots after the first step to
    ``ref`` (rank 0's single-process reference; ``_hold_slots``)."""
    from repro_torch.core.api import init_train_state
    from repro_torch.launch import steps as S
    from repro_torch.models import build
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding.rules import (
        NamedSharding,
        gather_tree,
        shard_tree,
        split_spec,
    )
    from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

    name, fsdp, fleet_shard, steps, comm = MESH_JOBS[job]
    dev = mesh.device
    cfg, run = _mesh_cfg(name)
    batches = _mesh_batches(torch, cfg, run["agents"], run["per_agent"],
                            run["seq"], steps, dev)
    plan = _mesh_plan(cfg, run, comm, mesh, fsdp, MESH_KNOBS.get(job))
    step = S.build_train_step(plan, compute_dtype="float32", device=dev,
                              mesh=mesh, fleet_shard=fleet_shard,
                              agent_metrics=comm != MESH_COMM)
    model = build(plan.cfg)
    opt = opt_lib.from_config(plan.train_cfg)
    state = shard_tree(init_train_state(_mesh_params(torch, model, dev), opt,
                                        plan.train_cfg, device=dev),
                       step.state_shardings)
    out = {"steps": []}
    if MESH_HOLD and cfg.arch_type in MESH_FAMILY_GAP:
        out["grads"] = _mesh_grads(torch, mesh, step, model, state.params,
                                   batches[0])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shardings = step.state_shardings.params
    out["rest_bytes"] = sum(x.nbytes for x in tree_leaves((state.params,
                                                           state.opt_state)))
    if cfg.moe is not None:
        # the rank's agents' drops from seed 0's weights, as the
        # single-process reference records them
        pl = step.placement
        local = pl.local_rows(batches[0])
        out["drops_agents"] = list(pl.agents)
        out["drops"] = _moe_drops(torch, model, state.params, local,
                                  range(len(pl.agents)), active=pl.active)
    for k, b in enumerate(batches):
        mesh.collectives.reset()
        ce0, swa0 = ce_ops.fused_ce.launches, swa_ops.swa_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        out["steps"].append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": (swa_ops.swa_attention.launches - swa0,
                         ce_ops.fused_ce.launches - ce0),
            "collectives": mesh.collectives.by_axis(),
            "by_tag": mesh.collectives.by_tag(),
            "metrics": {key: v.cpu() for key, v in m.items()}})
        if mesh.rank == 0:
            print(f"[mesh] rank 0 {job} step {k}: "
                  f"{out['steps'][-1]['ms']:.1f} ms, "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak",
                  flush=True)
        if k == 0 and comm != MESH_COMM and MESH_HOLD:
            out["slots"] = _hold_slots(torch, mesh, state,
                                       step.state_shardings, ref)
        if k not in (0, steps - 1) or not MESH_HOLD:
            continue
        key = "first" if k == 0 else "last"
        if keep:
            out[f"blocks_{key}"] = _cpu_tree(state.params)
        if against is None:
            # each block sent once to rank 0's host
            full = gather_tree(state.params, shardings, "hold", dst=0)
            if mesh.rank == 0:
                out[key] = _cpu_tree(full)
            del full
            continue
        # this rank's blocks against the same rank's blocks of a job
        # that splits no more: each leaf's data block of them
        gap, same = 0.0, True
        flat = dict(tree_flatten_with_path(shardings))
        for path, x in _cpu_tree(state.params).items():
            data = NamedSharding(mesh, split_spec(flat[path].spec)[0])
            w = data.local(against[f"blocks_{key}"][path])
            same &= torch.equal(x, w)
            gap = max(gap, float((x - w).abs().max() / w.abs().max()))
        red = mesh.all_reduce(torch.tensor([gap, float(not same)],
                                           device=dev), "check", op="max")
        out[f"vs_{key}"] = (float(red[0]), not bool(red[1]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step, batches, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_grads(torch, mesh, step, model, params, batch):
    """The agents' first-step gradients on the mesh, each rank its blocks
    of its agents', sent to rank 0: ``{path: (agents, *shape)}`` on the
    CPU there, None elsewhere."""
    from repro_torch.comm.bank import batch_prologue
    from repro_torch.sharding.rules import (
        NamedSharding,
        PartitionSpec,
        gather_tree,
    )
    from repro_torch.utils.tree import tree_map

    pl = step.placement
    with pl.active():
        _, grads = batch_prologue(model.loss_fn)(pl.gather_params(params),
                                                 pl.local_rows(batch))
    lead = tuple(pl.agent_sharding.spec)[:1] or (None,)
    shardings = tree_map(lambda sh: NamedSharding(
        mesh, PartitionSpec(*lead, *sh.spec)), pl.model_shardings)
    full = gather_tree(tree_map(lambda t: t.detach().cpu(), grads),
                       shardings, "hold", dst=0)
    return _cpu_tree(full) if mesh.rank == 0 else None


def _mesh_rank(mesh) -> dict:
    """Everything [mesh] and [mesh serve] run on one rank of the (data 2,
    model 2) mesh (a process of its own: ``spawn`` starts it).  Before
    the first job of each run and policy rank 0 runs its single-process
    reference while the others wait, holds each job to it right after
    the job, and drops it after the run's last job (the host holds one
    run's parameter trees at a time); the serving part follows the
    training jobs."""
    import torch

    from repro_torch.kernels.fused_ce import ops as ce_ops
    from repro_torch.kernels.swa_attention import ops as swa_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh

    out = {"rank": mesh.rank, "coords": mesh.coords,
           "backend": mesh.backend, "device": str(mesh.device), "jobs": {}}
    jobs = [j for j in MESH_JOBS if not MESH_ONLY or j in MESH_ONLY]
    # every job's mesh: the spawn's, or another of the same ranks (every
    # rank makes them in one order: their groups are collectives)
    meshes = {MESH_MODEL: mesh}
    for job in jobs:
        size = MESH_RUNS[MESH_JOBS[job][0]].get("model", MESH_MODEL)
        if size not in meshes:
            meshes[size] = make_host_mesh(size, device=mesh.device)
    keys = [_mesh_key(MESH_JOBS[j][0], MESH_JOBS[j][4]) for j in jobs]
    hold = mesh.rank == 0 and MESH_HOLD
    if hold:
        out["reference"], out["held"] = {}, {}
    paired = MESH_HOLD and "fsdp_off" in jobs and "fsdp_on" in jobs
    for i, job in enumerate(jobs):
        name, comm = MESH_JOBS[job][0], MESH_JOBS[job][4]
        key = keys[i]
        t0 = time.perf_counter()
        if hold and key not in out["reference"]:
            out["reference"][key] = _mesh_reference(
                torch, ce_ops, swa_ops, name, comm, mesh.device)
            _mesh_clock(mesh, f"the single-process {key}", t0)
        mesh.barrier()
        t0 = time.perf_counter()
        # fsdp on is held, rank by rank, to fsdp off's blocks (which are
        # held to the single-process step): its blocks are theirs split
        # further over data, so no gather is needed
        ref = out["reference"][key] if hold else None
        job_mesh = meshes[MESH_RUNS[name].get("model", MESH_MODEL)]
        got = out["jobs"][job] = _mesh_job(
            torch, ce_ops, swa_ops, job_mesh, job,
            keep=paired and job == "fsdp_off",
            against=out["jobs"]["fsdp_off"] if paired and job == "fsdp_on"
            else None, ref=ref)
        if hold:
            out["held"][job] = _mesh_hold_job(torch, job, got, ref)
        for k in ("first", "last", "grads"):
            got.pop(k, None)
        if job == "fsdp_on" or (job == "fsdp_off" and not paired):
            for k in ("blocks_first", "blocks_last"):
                out["jobs"]["fsdp_off"].pop(k, None)
        if hold and key not in keys[i + 1:]:
            for k in ("first", "last", "grads", "ties", "amax", "slots"):
                ref.pop(k, None)
        gc.collect()
        torch.cuda.empty_cache()
        mesh.barrier()
        _mesh_clock(mesh, f"job {job}", t0)
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()
    if MESH_ONLY:
        return out
    # [mesh serve] on the same ranks (one spawn: each rank's start-up is
    # paid once)
    t0 = time.perf_counter()
    out["serve"] = _mesh_serve_rank(mesh)
    out["serve"]["seconds"] = time.perf_counter() - t0
    return out


def _mesh_clock(mesh, what: str, t0: float) -> None:
    """Rank 0's wall-clock seconds of a stage of the spawn (where the
    spawn's time goes beside its steps)."""
    if mesh.rank == 0:
        print(f"[mesh] rank 0 {what} in {time.perf_counter() - t0:.1f} s",
              flush=True)


def _mesh_params_ties(torch, got: dict, want: dict, ties: dict,
                      weight: float, what: str):
    """Hold a per-agent job's first-step parameters to the single-process
    step's: every element within TRAIN_TOL of its leaf's largest value,
    plus lr · (the delivered agents' rounding steps) / ``weight`` where
    an agent's g lies at a midpoint of its wire format (``ties``,
    ``(agents, *shape)``).  Returns (the largest gap elsewhere over its
    leaf's max, the elements that needed a step)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    worst, stepped = 0.0, 0
    for path, w in want.items():
        w = w.to(dev)
        scale = w.abs().max().item()
        diff = (got[path].to(dev) - w).abs()
        allowed = MESH_LR * ties[path].to(dev).sum(0) / max(weight, 1.0)
        if not bool((diff <= TRAIN_TOL * scale + allowed).all()):
            raise AssertionError(f"{what}: params {path} differ by "
                                 f"{diff.max().item() / scale:.3e} of "
                                 f"their largest value")
        stepped += int((diff > TRAIN_TOL * scale).sum())
        worst = max(worst, (diff * (allowed == 0)).max().item() / scale)
    return worst, stepped


def _mesh_hold_job(torch, job: str, got: dict, ref: dict) -> dict:
    """Rank 0's checks of one job: its gathered parameters after its
    first step against the single-process step's from the same state
    (``_params_within``: TRAIN_TOL of each leaf's largest value, one
    int8 level where a gradient lies at a rounding boundary; a per-agent
    job's each agent's wire format's step, ``_mesh_params_ties``), after
    the last step within TRAIN_TOL in each leaf's relative L2 norm;
    decisions (and a per-agent job's each agent's decision and
    delivery) equal every step, loss, mean gain and grad_norm within
    TRAIN_TOL.  A family of MESH_FAMILY_GAP: the agents' gradients on
    the mesh within its band of one process's, the mean gain within it
    relatively, an int8 element a level apart only where the two
    gradients round apart.  A job held to another rank by rank
    (``vs_first``/``vs_last``) within TRAIN_TOL of each leaf's largest
    value."""
    name, fsdp, fleet, steps, comm = MESH_JOBS[job]
    agents = MESH_RUNS[name]["agents"]
    band = MESH_FAMILY_GAP.get(_mesh_cfg(name)[0].arch_type)
    gaps = {}
    for k, (g, r) in enumerate(zip(got["steps"], ref["steps"])):
        gm, rm = g["metrics"], r["metrics"]
        for key in ("num_tx", "agent_tx", "agent_delivered"):
            if key in gm and not torch.equal(gm[key], rm[key]):
                raise AssertionError(f"mesh {job} step {k}: {key} "
                                     f"{gm[key]} vs {rm[key]}")
        for key in ("loss", "mean_gain", "grad_norm"):
            a, b = float(gm[key]), float(rm[key])
            tol = (band if key == "mean_gain" and band
                   else TRAIN_TOL) * abs(b)
            if not abs(a - b) <= tol:
                raise AssertionError(f"mesh {job} step {k}: {key} {a} "
                                     f"vs {b}")
            gaps[key] = max(gaps.get(key, 0.0),
                            abs(a - b) / abs(b) if b else abs(a - b))
    if "vs_first" in got:
        (gap0, same0) = got["vs_first"]
        (gap1, same1) = got.get("vs_last", got["vs_first"])
        if not max(gap0, gap1) <= TRAIN_TOL:
            raise AssertionError(f"mesh {job}: blocks {gap0:.3e} / "
                                 f"{gap1:.3e} from fsdp_off's")
        return {"vs_fsdp_off_first": gap0, "vs_fsdp_off_last": gap1,
                "bitwise_fsdp_off": same0 and same1}
    dev = torch.device("cuda", torch.cuda.current_device())
    grad_gap = None
    if comm == MESH_COMM:
        on = {p: x.to(dev) for p, x in got["first"].items()}
        mine = None
        if "grads" in got:
            mine = {p: x.to(dev) for p, x in got["grads"].items()}
            grad_gap = _grad_gap(mine, ref["grads"])
            if not grad_gap <= band:
                raise AssertionError(f"mesh {job}: the agents' gradients "
                                     f"{grad_gap:.3e} of max|g| from one "
                                     f"process's (band {band})")
        worst, tied, worst_all = _params_within(
            torch, on, {p: x.to(dev) for p, x in ref["first"].items()},
            {p: x.to(dev) for p, x in ref["grads"].items()}, agents,
            f"mesh {job} step 0", other=mine)
        del on, mine
    else:
        m0 = ref["steps"][0]["metrics"]
        weight = float(m0.get("agent_delivered", m0["agent_tx"]).sum())
        worst, tied = _mesh_params_ties(
            torch, got["first"], ref["first"], ref["ties"], weight,
            f"mesh {job} step 0")
        worst_all = None
    last = 0.0
    if steps > 1:
        for p, x in got["last"].items():
            w = ref["last"][p]
            last = max(last, float((x - w).norm() / w.norm()))
        if not last <= TRAIN_TOL:
            raise AssertionError(f"mesh {job}: parameters after {steps} "
                                 f"steps {last:.3e} apart in L2")
    held = {"first_step_worst": worst, "first_step_worst_all": worst_all,
            "int8_one_level": tied,
            "last_step_rel_l2": last, "rel_gaps": gaps,
            "family_gap": band, "grad_gap": grad_gap}
    if "slots" in got:
        held["slots"] = got["slots"]
    torch.cuda.empty_cache()
    return held


def _grad_gap(got: dict, want: dict) -> float:
    """The largest gap of any agent's gradient in ``got`` from ``want``'s
    (``{path: (agents, *shape)}``), over that agent's max|g| in the leaf."""
    worst = 0.0
    for path, w in want.items():
        w = w.to(got[path].device)
        amax = w.abs().flatten(1).amax(1)
        gap = (got[path] - w).abs().flatten(1).amax(1) / amax
        worst = max(worst, gap.max().item())
    return worst


def _mesh_drops(torch, ranks, job: str, ref) -> dict:
    """A moe job's dropped pairs: every rank's masks (each routes its
    agents' whole token sets) equal to rank 0's, and to the
    single-process step's where it ran; the counts per agent and layer,
    printed."""
    r0 = ranks[0]["jobs"][job]
    for r in ranks[1:]:
        mine = r["jobs"][job]
        for a, got in zip(mine["drops_agents"], mine["drops"]):
            want = r0["drops"][r0["drops_agents"].index(a)] if (
                a in r0["drops_agents"]) else None
            if want is not None and not all(
                    torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"mesh {job}: rank {r['rank']}'s "
                                     f"dropped pairs of agent {a} differ "
                                     f"from rank 0's")
    counts = {a: [int(m.sum()) for m in d]
              for a, d in zip(r0["drops_agents"], r0["drops"])}
    single = None
    if ref is not None:
        single = {a: [int(m.sum()) for m in ref["drops"][a]]
                  for a in r0["drops_agents"]}
        for a, d in zip(r0["drops_agents"], r0["drops"]):
            if len(d) != len(ref["drops"][a]) or not all(
                    torch.equal(x, y) for x, y in zip(d, ref["drops"][a])):
                raise AssertionError(f"mesh {job}: agent {a}'s dropped "
                                     f"pairs differ from the single-process "
                                     f"step's")
    print(f"[mesh] {job} dropped (token, k) pairs per agent and layer: "
          f"mesh {counts}, single-process "
          f"{single if single is not None else 'not run'} (the same pairs "
          f"on every rank{' and in one process' if single else ''})")
    return {"mesh": counts, "single": single}


def _mesh_launches(cfg) -> tuple:
    """A job's (swa_attention, fused_ce) launches per rank and step, the
    single-process step's: the causal self-attention once per decoder
    layer (zamba2: per shared-block site; xlstm: none) in the loss and in
    the lookahead probe, and the two losses."""
    from repro_torch.models.transformer import group_bounds

    if cfg.arch_type == "hybrid":
        sites = len(group_bounds(cfg.num_layers, cfg.shared_attn_every))
    else:
        sites = 0 if cfg.arch_type == "ssm" else cfg.num_layers
    return (2 * sites, 2)


def phase_mesh(torch, card: str) -> tuple:
    """The [mesh] and [mesh serve] phases (the module docstring's): one
    spawn of MESH_WORLD gloo ranks sharing the card runs every job, then
    the serving; rank 0 holds them to the single-process steps; the
    parent checks the counts and prints.  Returns both records."""
    from repro_torch.launch.mesh import choose_backend, spawn

    backend = choose_backend(MESH_WORLD, "cuda")
    t0 = time.perf_counter()
    with _shared_card(torch):
        ranks = spawn(_mesh_rank, MESH_WORLD, timeout_s=MESH_TIMEOUT_S,
                      backend=backend, device="cuda", model=MESH_MODEL)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    record = {"backend": backend, "world": MESH_WORLD, "spawn_s": spawn_s,
              "coords": [r["coords"] for r in ranks],
              "held": r0.get("held"), "jobs": {}}
    for job in r0["jobs"]:
        name, fsdp, fleet, steps, comm = MESH_JOBS[job]
        cfg, run = _mesh_cfg(name)
        # without the holds (tools/mesh_depth.py's search) no
        # single-process step ran: the ranks' launches are checked alone
        ref = r0["reference"][_mesh_key(name, comm)] if MESH_HOLD else None
        layers = cfg.num_layers
        want = _mesh_launches(cfg)
        for r in ranks:
            for k, s in enumerate(r["jobs"][job]["steps"]):
                single = ref["steps"][k]["launches"] if ref else None
                if s["launches"] != want or single not in (None, want):
                    raise AssertionError(
                        f"mesh {job} rank {r['rank']} step {k}: launches "
                        f"(swa_attention, fused_ce) {s['launches']}, "
                        f"single-process {single} (want {want})")
        peaks = [r["jobs"][job]["peak_gb"] for r in ranks]
        rest = [r["jobs"][job]["rest_bytes"] for r in ranks]
        ms = [[s["ms"] for s in r["jobs"][job]["steps"]] for r in ranks]
        coll = r0["jobs"][job]["steps"][-1]["collectives"]
        tags = r0["jobs"][job]["steps"][-1]["by_tag"]
        ref_ms = [s["ms"] for s in ref["steps"][:steps]] if ref else None
        row = {"arch": run["arch"], "layers": layers, "fsdp": fsdp,
               "fleet_shard": fleet, "knobs": MESH_KNOBS.get(job, {}),
               "steps": steps,
               "policy": list(comm) if isinstance(comm, tuple) else comm,
               "agents": run["agents"],
               "ms_per_step_ranks": ms, "ms_per_step_single": ref_ms,
               "peak_gb_ranks": peaks, "peak_gb_sum": sum(peaks),
               "rest_bytes_ranks": rest,
               "launches_per_step": list(r0["jobs"][job]["steps"][0][
                   "launches"]),
               "collectives_per_step_rank0": coll,
               "collectives_by_tag_rank0": tags,
               "loss": [float(s["metrics"]["loss"])
                        for s in r0["jobs"][job]["steps"]]}
        record["jobs"][job] = row
        kinds = ", ".join(f"{k} {v['count']} ({v['operand_bytes'] / 1e6:.1f}"
                          f" MB, wire {v['wire_bytes'] / 1e6:.1f} MB)"
                          for k, v in sorted(coll.items()))
        by_tag = ", ".join(f"{k} {v['count']} ({v['operand_bytes'] / 1e6:.1f}"
                           f" MB)" for k, v in sorted(tags.items()))
        knobs = "".join(f", {k}" for k in MESH_KNOBS.get(job, {}))
        model = run.get("model", MESH_MODEL)
        depth = (f"{run['encoder_layers']} + {layers}"
                 if "encoder_layers" in run else str(layers))
        row["mesh"] = {"data": MESH_WORLD // model, "model": model}
        if "drops" in r0["jobs"][job]:
            row["drops"] = _mesh_drops(torch, ranks, job, ref)
        print(f"[mesh] {job}: {run['arch']} {depth} layers, (data "
              f"{MESH_WORLD // model}, model {model}), m = {run['agents']}, "
              f"{_comm_name(comm)}, fsdp {fsdp}, "
              f"fleet_shard {fleet}{knobs}, {steps} steps: ms per step per rank "
              f"{[[round(x, 1) for x in r] for r in ms]} vs single-process "
              f"{[round(x, 1) for x in ref_ms] if ref else 'not run'}; "
              f"launches per step per rank "
              f"(swa_attention, fused_ce) {row['launches_per_step']}; peak "
              f"GB per rank {[round(p, 2) for p in peaks]} (sum "
              f"{sum(peaks):.2f}); bytes at rest per rank {rest}")
        print(f"[mesh] {job} collectives per step on rank 0: {kinds}")
        print(f"[mesh] {job} collectives per step on rank 0 by tag: "
              f"{by_tag}")
        if not MESH_HOLD:
            continue
        h = r0["held"][job]
        if "vs_fsdp_off_first" in h:
            print(f"[mesh] {job} vs the single-process step: decisions "
                  f"equal, loss/gain/|g| within {TRAIN_TOL}; each rank's "
                  f"blocks after the first and the last step within "
                  f"{h['vs_fsdp_off_first']:.2e} / "
                  f"{h['vs_fsdp_off_last']:.2e} of fsdp_off's (bitwise "
                  f"equal: {h['bitwise_fsdp_off']})")
            continue
        slots = ""
        if "slots" in h:
            sl = h["slots"]
            slots = (f"; the per-agent slots' {sl['leaves']} leaves after "
                     f"the first step within {sl['worst']:.2e} of each "
                     f"agent's max|g| ({sl['stepped']} elements a rounding "
                     f"step apart)")
        within = (f"loss/|g| within {TRAIN_TOL}, the gain within "
                  f"{h['family_gap']}, the agents' gradients "
                  f"{h['grad_gap']:.2e} of max|g| from one process's "
                  f"(band {h['family_gap']}), the params apart beyond "
                  f"{TRAIN_TOL} only as far as the two gradients' int8 "
                  f"wire values"
                  if h["family_gap"] else
                  f"loss/gain/|g| within {TRAIN_TOL}")
        gaps = ", ".join(f"{k} {v:.2e}" for k, v in h["rel_gaps"].items())
        print(f"[mesh] {job} vs the single-process step: decisions equal, "
              f"{within} (relative gaps {gaps}); first step's params "
              f"within {h['first_step_worst']:.2e} of each leaf's max apart "
              f"from {h['int8_one_level']} elements a rounding step apart"
              + (f" (all elements: {h['first_step_worst_all']:.2e})"
                 if h["first_step_worst_all"] is not None else "")
              + f"; after {steps} steps {h['last_step_rel_l2']:.2e} in L2"
              f"{slots}")
    if MESH_ONLY:
        print(f"[mesh] spawn {spawn_s:.1f} s")
        return record, None
    serve_s = max(r["serve"]["seconds"] for r in ranks)
    print(f"[mesh] spawn {spawn_s:.1f} s, of which [mesh serve] "
          f"{serve_s:.1f}")
    return record, _mesh_serve_record([r["serve"] for r in ranks],
                                      backend, serve_s)


class _shared_card:
    """The context of a spawn whose ranks share the card: this process
    keeps none of its cache, and theirs grows in segments (less of the
    card held unused)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        gc.collect()
        self.torch.cuda.empty_cache()
        self.alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        return self

    def __exit__(self, *exc):
        if self.alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = self.alloc


# ----------------------------------------------------------------------
# [mesh serve]: prefill and decode over the (data, model) mesh
# ----------------------------------------------------------------------

def _serve_cfg(name: str):
    from repro_torch.configs import get_config

    run = MESH_SERVES[name]
    cfg = get_config(run["arch"]).replace(num_layers=run["layers"])
    if "encoder_layers" in run:
        cfg = cfg.replace(encoder_layers=run["encoder_layers"])
    return cfg, run


def _serve_plans(name: str, mesh=None, layout: str = "decode_heads"):
    """[mesh serve] run ``name``'s prefill and decode plans (on ``mesh``,
    or one card) in ``layout`` (a ``seq_`` prefix: the prefill under
    ``seq_shard``), and the decode's cache length: the prompt and the
    generated tokens' slots, or whisper's frames (its decoder's
    self-attention slots are the architecture's 448)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S

    cfg, run = _serve_cfg(name)
    cs = layout.endswith("cache_seq_shard")
    slots = (run["prompt"] if cfg.is_encoder_decoder
             else run["prompt"] + run["gen"])
    return (S.plan_run(cfg, InputShape("serve", run["prompt"], run["batch"],
                                       "prefill"), mesh,
                       cache_seq_shard=cs,
                       seq_shard=layout.startswith("seq_")),
            S.plan_run(cfg, InputShape("serve", slots, run["batch"],
                                       "decode"), mesh,
                       cache_seq_shard=cs), slots)


def _serve_position(name: str, t: int) -> int:
    """Decode step ``t``'s position: after the prompt, or from 0 for
    whisper (its prefill fills the cross-attention cache only)."""
    cfg, run = _serve_cfg(name)
    return t if cfg.is_encoder_decoder else run["prompt"] + t


def _serve_reference(torch, swa_ops, dev, name: str) -> dict:
    """The single-process prefill of run ``name``'s prompts (seed 0's
    weights and batch, ``build_prefill_step``) and its greedy decode on
    the card (whisper: from token 0 after the encode): the prefill's
    logits (none for whisper) and each step's (CPU), the greedy tokens
    ``(B, gen)``, ms and launches, the peak."""
    from repro_torch.launch import steps as S

    run = MESH_SERVES[name]
    plan_p, plan_d, slots = _serve_plans(name)
    torch.cuda.reset_peak_memory_stats()
    pstep, params, batch = S.build_prefill_step(
        plan_p, compute_dtype="float32", device=dev, cache_len=slots)
    dstep, _, _ = S.build_serve_step(plan_d, compute_dtype="float32",
                                     device=dev, init_params=False)
    swa0 = swa_ops.swa_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pstep(params, batch)
    torch.cuda.synchronize()
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
           "prefill_launches": swa_ops.swa_attention.launches - swa0,
           "prefill": None if logits is None else logits.cpu(),
           "steps": [], "step_ms": [], "step_launches": []}
    tok = (torch.zeros((run["batch"], 1), dtype=torch.int32, device=dev)
           if logits is None else
           logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    del logits
    toks = []
    for t in range(run["gen"]):
        toks.append(tok)
        swa0 = swa_ops.swa_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = dstep(params, cache, tok, torch.tensor(
            _serve_position(name, t), dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_launches"].append(swa_ops.swa_attention.launches - swa0)
        out["steps"].append(lg[:, 0].cpu())
        tok = lg[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    out["tokens"] = torch.cat(toks, 1).cpu()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[mesh serve] rank 0 single-process {name}: prefill "
          f"{out['prefill_ms']:.1f} ms, decode "
          f"{statistics.median(out['step_ms']):.1f} ms a step (median), "
          f"peak {out['peak_gb']:.2f} GB", flush=True)
    del params, cache, batch, pstep, dstep
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _logit_gap(torch, got, want, what: str) -> float:
    """[lm]'s card-against-CPU tolerance, LM_LOGIT_TOL + LM_LOGIT_TOL ·
    |ref|: the largest gap, raising beyond it (on the card, a request at
    a time)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.to(dev), w.to(dev)
        gap = (g - w).abs()
        if not bool((gap <= LM_LOGIT_TOL + LM_LOGIT_TOL * w.abs()).all()):
            raise AssertionError(f"mesh serve {what}: logits differ by "
                                 f"{gap.max().item():.3e}")
        worst = max(worst, gap.max().item())
    return worst


def _greedy_ties(torch, ref_logits, tokens, what: str) -> int:
    """The greedy ``tokens`` ``(B,)`` of a mesh step against the
    single-process step's ``ref_logits`` ``(B, V)``: equal to their
    argmax, or apart where the reference's top two lie within
    LM_LOGIT_TOL · (2 + |top|) of each other (counted)."""
    want = ref_logits.argmax(-1)
    odd = (tokens != want).nonzero().flatten().tolist()
    for i in odd:
        top2 = ref_logits[i].topk(2).values
        if not (top2[0] - top2[1]).abs() <= LM_LOGIT_TOL * (
                2 + top2[0].abs()):
            raise AssertionError(f"mesh serve {what}: request {i}'s greedy "
                                 f"token {int(tokens[i])} vs {int(want[i])}")
    return len(odd)


def _cache_block(cache) -> list:
    """The shape of a cache block's keys (whisper: the cross-attention's;
    zamba2: its shared block's; xlstm: the mLSTM's matrix memory)."""
    if not isinstance(cache, dict):
        return list(cache.k.shape)
    if "cross_k" in cache:
        return list(cache["cross_k"].shape)
    return list((cache["attn"].k if "attn" in cache else cache["mlstm"].C)
                .shape)


def _mesh_serve_rank(mesh) -> dict:
    """Everything [mesh serve] runs on one rank, run by run: rank 0's
    single-process reference first (the others wait), its greedy tokens
    to every rank, then each layout: the rank builds its blocks (once a
    run), prefills, decodes the run's steps teacher-forced on the
    reference's tokens; rank 0 holds the whole batch's logits (gathered
    on the CPU) to the reference."""
    import torch

    from repro_torch.launch import steps as S
    from repro_torch.kernels.swa_attention import ops as swa_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {"rank": mesh.rank, "coords": mesh.coords, "runs": {}}
    for name, run in MESH_SERVES.items():
        t_run = time.perf_counter()
        ref = (_serve_reference(torch, swa_ops, dev, name)
               if mesh.rank == 0 else None)
        tokens = (ref["tokens"].to(torch.int64) if ref is not None else
                  torch.zeros((run["batch"], run["gen"]), dtype=torch.int64))
        mesh.all_reduce(tokens, "tokens", mesh.axis_names)
        tokens = tokens.to(torch.int32).to(dev)
        res = {"layouts": {}}
        if ref is not None:
            res["reference"] = {k: ref[k] for k in (
                "prefill_ms", "step_ms", "prefill_launches",
                "step_launches", "peak_gb")}
        params = None
        for layout in run["layouts"]:
            plan_p, plan_d, slots = _serve_plans(name, mesh, layout)
            torch.cuda.reset_peak_memory_stats()
            # the layouts split the weights alike: one draw serves all
            pstep, drawn, batch = S.build_prefill_step(
                plan_p, compute_dtype="float32", device=dev, mesh=mesh,
                cache_len=slots, init_params=params is None)
            params = drawn if params is None else params
            dstep, _, _ = S.build_serve_step(plan_d, compute_dtype="float32",
                                             device=dev, mesh=mesh,
                                             init_params=False)
            rec = {"rest_bytes": sum(x.nbytes for x in
                                     _flat_tree(params).values()),
                   "step_ms": [], "step_launches": [], "logits_gap": [],
                   "greedy_apart": 0}
            mesh.barrier()
            mesh.collectives.reset()
            swa0 = swa_ops.swa_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = pstep(params, batch)
            torch.cuda.synchronize()
            rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            rec["prefill_launches"] = swa_ops.swa_attention.launches - swa0
            rec["prefill_collectives"] = mesh.collectives.by_tag()
            rec["cache_block"] = _cache_block(cache)
            rec["prefill_gap"] = None
            if logits is not None:
                full = pstep.logits_sharding.gather(logits.cpu())
                del logits
                if ref is not None:
                    rec["prefill_gap"] = _logit_gap(
                        torch, full, ref["prefill"], f"{name} {layout} "
                        f"prefill")
                    rec["greedy_apart"] += _greedy_ties(
                        torch, ref["prefill"][:, -1], full[:, -1].argmax(-1),
                        f"{name} {layout} prefill")
                del full
            for t in range(run["gen"]):
                mesh.collectives.reset()
                swa0 = swa_ops.swa_attention.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = dstep(params, cache, tokens[:, t:t + 1],
                                  torch.tensor(_serve_position(name, t),
                                               dtype=torch.int32,
                                               device=dev))
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["step_launches"].append(swa_ops.swa_attention.launches
                                            - swa0)
                rec["step_collectives"] = mesh.collectives.by_tag()
                full = dstep.logits_sharding.gather(lg[:, 0].cpu())
                if ref is not None:
                    rec["logits_gap"].append(_logit_gap(
                        torch, full, ref["steps"][t],
                        f"{name} {layout} step {t}"))
                    rec["greedy_apart"] += _greedy_ties(
                        torch, ref["steps"][t], full.argmax(-1),
                        f"{name} {layout} step {t}")
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            res["layouts"][layout] = rec
            if mesh.rank == 0:
                print(f"[mesh serve] rank 0 {name} {layout}: prefill "
                      f"{rec['prefill_ms']:.1f} ms, decode "
                      f"{statistics.median(rec['step_ms']):.1f} ms a step, "
                      f"peak {rec['peak_gb']:.2f} GB", flush=True)
            del drawn, cache, batch, pstep, dstep
            gc.collect()
            torch.cuda.empty_cache()
            mesh.barrier()
        del params
        gc.collect()
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t_run
        out["runs"][name] = res
    return out


def _mesh_serve_record(ranks: list, backend: str, seconds: float) -> dict:
    """[mesh serve]'s checks of the ranks' results (the launches) and its
    lines and record, run by run."""
    record = {"backend": backend, "world": MESH_WORLD, "seconds": seconds,
              "runs": {}}
    for name, run in MESH_SERVES.items():
        cfg, _ = _serve_cfg(name)
        # the causal self-attention's kernel once a decoder layer in a
        # prefill (whisper's prefill only encodes, zamba2's and xlstm's
        # replay the prompt through decode: no causal attention kernel)
        layers = (0 if cfg.arch_type in ("audio", "hybrid", "ssm")
                  else run["layers"])
        ref = ranks[0]["runs"][name]["reference"]
        rrec = {"arch": run["arch"], "layers": run["layers"],
                "run": dict(run), "reference": ref, "layouts": {},
                "seconds": ranks[0]["runs"][name]["seconds"]}
        record["runs"][name] = rrec
        if ref["prefill_launches"] != layers or any(ref["step_launches"]):
            raise AssertionError(f"mesh serve {name} single-process "
                                 f"launches {ref['prefill_launches']} / "
                                 f"{ref['step_launches']}")
        for layout in run["layouts"]:
            recs = [r["runs"][name]["layouts"][layout] for r in ranks]
            for r, rec in zip(ranks, recs):
                if rec["prefill_launches"] != layers or any(
                        rec["step_launches"]):
                    raise AssertionError(
                        f"mesh serve {name} {layout} rank {r['rank']}: "
                        f"swa_attention launches {rec['prefill_launches']} "
                        f"per prefill, {rec['step_launches']} per decode "
                        f"step (want {layers}, 0)")
            r0 = recs[0]
            row = {"prefill_ms_ranks": [x["prefill_ms"] for x in recs],
                   "prefill_ms_single": ref["prefill_ms"],
                   "step_ms_median_ranks": [statistics.median(x["step_ms"])
                                            for x in recs],
                   "step_ms_median_single": statistics.median(
                       ref["step_ms"]),
                   "step_ms_rank0": r0["step_ms"],
                   "peak_gb_ranks": [x["peak_gb"] for x in recs],
                   "rest_bytes_ranks": [x["rest_bytes"] for x in recs],
                   "cache_block_rank0": r0["cache_block"],
                   "launches_prefill": r0["prefill_launches"],
                   "launches_step": r0["step_launches"][0],
                   "prefill_collectives_rank0": r0["prefill_collectives"],
                   "step_collectives_rank0": r0["step_collectives"],
                   "prefill_max_abs_gap": r0["prefill_gap"],
                   "step_max_abs_gap": max(r0["logits_gap"]),
                   "greedy_apart": r0["greedy_apart"]}
            rrec["layouts"][layout] = row

            def tags(c):
                return ", ".join(
                    f"{k} {v['count']} ({v['operand_bytes'] / 1e6:.2f} MB)"
                    for k, v in sorted(c.items()))

            depth = (f"{run['encoder_layers']} + {run['layers']}"
                     if "encoder_layers" in run else str(run["layers"]))
            prompt = (f"{run['prompt']} frames" if cfg.is_encoder_decoder
                      else f"{run['prompt']}")
            gap = ("no prefill logits" if row["prefill_max_abs_gap"] is None
                   else f"prefill max |gap| "
                   f"{row['prefill_max_abs_gap']:.3e}")
            print(f"[mesh serve] {name} {layout}: {run['arch']} {depth} "
                  f"layers fp32 on (data 2, model 2), B {run['batch']} × "
                  f"{prompt} then {run['gen']} tokens: ms per prefill per "
                  f"rank {[round(x, 1) for x in row['prefill_ms_ranks']]} "
                  f"vs single-process {ref['prefill_ms']:.1f}; ms per decode "
                  f"step (median) per rank "
                  f"{[round(x, 1) for x in row['step_ms_median_ranks']]} vs "
                  f"single-process {row['step_ms_median_single']:.1f}; peak "
                  f"GB per rank {[round(x, 2) for x in row['peak_gb_ranks']]}"
                  f" (single-process {ref['peak_gb']:.2f}); weights at rest "
                  f"per rank "
                  f"{[round(x / 1e9, 2) for x in row['rest_bytes_ranks']]} "
                  f"GB; rank 0's cache block {r0['cache_block']}")
            print(f"[mesh serve] {name} {layout}: launches per rank "
                  f"(swa_attention) {layers} per prefill, 0 per decode "
                  f"step, as single-process; logits within {LM_LOGIT_TOL} + "
                  f"{LM_LOGIT_TOL}·|ref| of the single-process step ({gap}, "
                  f"decode {row['step_max_abs_gap']:.3e}); greedy tokens "
                  f"equal but {row['greedy_apart']} at a top-two tie")
            print(f"[mesh serve] {name} {layout} collectives per prefill on "
                  f"rank 0: {tags(r0['prefill_collectives'])}")
            print(f"[mesh serve] {name} {layout} collectives per decode step"
                  f" on rank 0: {tags(r0['step_collectives'])}")
    print(f"[mesh serve] {seconds:.1f} s on the ranks")
    return record


def _fresh_dir(path: Path) -> str:
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    return str(path)


def _state_leaves_equal(a, b) -> bool:
    """Two TrainStates bit for bit: the same leaves, dtypes and values."""
    from repro_torch.utils.tree import tree_flatten_with_path

    la, lb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all())
        if hasattr(x, "dtype") else x == y for (_, x), (_, y) in zip(la, lb))


def phase_durable(torch, gr_ops) -> dict:
    """The kernel-gated m=64 fleet served durably: TIERED_M64_QUADRATIC,
    DURABLE_ROUNDS rounds with a checkpoint every DURABLE_EVERY, then a
    fresh session that resumes from the latest checkpoint and serves
    DURABLE_ROUNDS more; every state leaf bitwise an unbroken run's on
    the same (seed + 1, k) batches, the rollup's counters monotone, one
    restart, one ``gain_reduce`` launch per round across the lineage."""
    import numpy as np

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs.paper_linreg import TIERED_M64_QUADRATIC
    from repro_torch.launch.session import (
        SessionOptions,
        build_linreg_fleet_session,
    )

    net, seed = TIERED_M64_QUADRATIC, 0
    dev = torch.device("cuda", torch.cuda.current_device())
    ckpt_dir = _fresh_dir(REPO / "chiprun_out" / "durable")
    opts = SessionOptions(ckpt_dir=ckpt_dir, ckpt_every=DURABLE_EVERY)

    def build(options):
        t0 = time.perf_counter()
        session = build_linreg_fleet_session(net=net, seed=seed, device=dev,
                                             options=options)
        return session, (time.perf_counter() - t0) * 1e3

    def serve(session, rounds):
        t0 = time.perf_counter()
        session.run(rounds)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the unbroken run, then the lineage, both on the default (seed + 1,
    # k) batch stream
    unbroken, fresh_session_ms = build(None)
    serve(unbroken, 2 * DURABLE_ROUNDS)
    gr_ops.gain_reduce.launches = 0
    first, _ = build(opts)
    serve(first, DURABLE_ROUNDS)
    before = first.rollup.snapshot()
    resumed, resume_session_ms = build(opts)
    if (resumed.round_index, resumed.rollup.rounds) != (DURABLE_ROUNDS,) * 2:
        raise AssertionError(
            f"durable: resumed at round {resumed.round_index} with "
            f"{resumed.rollup.rounds} rolled-up rounds, want "
            f"{DURABLE_ROUNDS}")
    serve(resumed, DURABLE_ROUNDS)
    launches = gr_ops.gain_reduce.launches
    after = resumed.rollup.snapshot()

    if launches != 2 * DURABLE_ROUNDS:
        raise AssertionError(f"durable: gain_reduce launched {launches} "
                             f"times in the {2 * DURABLE_ROUNDS}-round "
                             f"lineage (want 1 per round)")
    if after.get("restarts") != 1 or after["rounds"] != 2 * DURABLE_ROUNDS:
        raise AssertionError(f"durable: the rollup shows "
                             f"{after.get('restarts')} restarts and "
                             f"{after['rounds']} rounds")
    if not all(after["counters"][k] >= before["counters"][k]
               for k in before["counters"]):
        raise AssertionError("durable: rollup counters fell across the "
                             "restart")
    if after["counters"] != unbroken.rollup.snapshot()["counters"]:
        raise AssertionError("durable: the lineage's counters differ from "
                             "the unbroken run's")
    if not _state_leaves_equal(resumed.state, unbroken.state):
        raise AssertionError("durable: the resumed lineage's state is not "
                             "bitwise the unbroken run's")

    step = ckpt.latest_step(ckpt_dir)
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    save_ms, restore_ms = [], []
    template = {"key": np.zeros(2, np.uint32), "state": resumed.state}
    for _ in range(DURABLE_TIMED):
        t0 = time.perf_counter()
        resumed.checkpoint()
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ckpt.restore(ckpt_dir, template)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    # rounds/s with and without checkpoints: fresh sessions of
    # DURABLE_ROUNDS rounds in turns (plain, checkpointed, checkpointed,
    # plain), after the runs above have warmed the path
    timed_opts = SessionOptions(
        ckpt_dir=_fresh_dir(REPO / "chiprun_out" / "durable_timed"),
        ckpt_every=DURABLE_EVERY, resume=False)
    rates = {"plain": [], "ckpt": []}
    for kind in ("plain", "ckpt", "ckpt", "plain"):
        session, _ = build(timed_opts if kind == "ckpt" else None)
        rates[kind].append(DURABLE_ROUNDS / serve(session, DURABLE_ROUNDS))
    record = {
        "net": net.name, "rounds": 2 * DURABLE_ROUNDS,
        "ckpt_every": DURABLE_EVERY, "launches": launches,
        "checkpoint_bytes": nbytes,
        "checkpoint_leaves": ckpt.read_manifest(ckpt_dir)["num_leaves"],
        "save_ms": statistics.median(save_ms),
        "restore_ms": statistics.median(restore_ms),
        "resume_session_ms": resume_session_ms,
        "fresh_session_ms": fresh_session_ms,
        "rounds_per_s_ckpt": rates["ckpt"],
        "rounds_per_s_plain": rates["plain"],
        "restarts": after["restarts"],
        "wire_bytes": after["counters"]["wire_bytes"],
    }
    print(f"[durable] {net.name}: {DURABLE_ROUNDS} rounds, a fresh session "
          f"resumed at round {DURABLE_ROUNDS}, {DURABLE_ROUNDS} more: every "
          f"state leaf bitwise the unbroken {2 * DURABLE_ROUNDS}-round run's; "
          f"gain_reduce launches {launches}; restarts 1, counters monotone; "
          f"checkpoint {nbytes} bytes ({record['checkpoint_leaves']} leaves),"
          f" save {record['save_ms']:.2f} ms, restore "
          f"{record['restore_ms']:.2f} ms, resumed session built in "
          f"{resume_session_ms:.1f} ms (fresh {fresh_session_ms:.1f} ms); "
          f"rounds/s over {DURABLE_ROUNDS} rounds in turns: without "
          f"checkpoints {rates['plain'][0]:.1f}, with one every "
          f"{DURABLE_EVERY} {rates['ckpt'][0]:.1f}, {rates['ckpt'][1]:.1f}, "
          f"without {rates['plain'][1]:.1f}")
    return record


def phase_kill(torch) -> dict:
    """SIGKILL-and-resume through ``python -m repro_torch.launch.serve
    --fleet`` on the card (``faults.kill_and_resume`` with CI's numbers,
    KILL): the lineage record, its checks passed."""
    from repro_torch.launch import faults

    ckpt_dir = _fresh_dir(REPO / "chiprun_out" / "kill")
    record = faults.kill_and_resume(ckpt_dir, device="cuda", timeout=300.0,
                                    verbose=False, **KILL)
    if not record["rounds_at_kill"] < KILL["rounds"]:
        raise AssertionError(f"kill: the serve process reached round "
                             f"{record['rounds_at_kill']} before the kill")
    print(f"[kill] {KILL['mix']}, {KILL['rounds']} rounds, SIGKILL at "
          f"observed round {record['rounds_at_kill']} (target "
          f"{KILL['kill_round']}), resumed from round "
          f"{record['resume_round']} (a checkpoint every "
          f"{KILL['ckpt_every']}), recovery {record['recovery_s']:.2f} s; "
          f"final rounds {record['rounds_final']}, restarts "
          f"{record['restarts']}, wire bytes "
          f"{record['wire_bytes_at_kill']:.0f} at the kill -> "
          f"{record['wire_bytes_final']:.0f}")
    return record


def phase_telemetry(torch) -> dict:
    """Thread mode on the card: TIERED_M64_QUADRATIC served with
    ``start()`` behind a TelemetryServer on 127.0.0.1, both endpoints
    scraped while rounds run (``rounds`` grows between scrapes), one
    round stalled for twice the watchdog's timeout (exactly one
    ``"stall"`` event), one metro agent crashed by a FaultInjector (no
    transmission in any round it is down), then ``stop()``."""
    import json as _json
    import urllib.request

    from repro_torch.configs.paper_linreg import (
        TIERED_M64_CFG,
        TIERED_M64_QUADRATIC,
    )
    from repro_torch.core import regression as R
    from repro_torch.data.synthetic import step_generator
    from repro_torch.launch.faults import AgentFault, FaultInjector, make_stall
    from repro_torch.launch.session import (
        SessionOptions,
        build_linreg_fleet_session,
    )

    net, seed, t = TIERED_M64_QUADRATIC, 0, TELEMETRY
    dev = torch.device("cuda", torch.cuda.current_device())
    problem = R.make_problem(TIERED_M64_CFG, step_generator(seed, 0, dev),
                             device=dev)
    agent = net.tier_index().index(1)  # the first metro agent
    fault = AgentFault(agent=agent, start=t["crash_start"],
                       duration=t["crash_rounds"])
    batches = FaultInjector(
        lambda k: R.agent_batches(problem, step_generator(seed + 1, k, dev)),
        [fault], net.num_agents)
    sent = {}
    session = build_linreg_fleet_session(
        net=net, seed=seed, device=dev, batch_fn=batches,
        options=SessionOptions(watchdog_timeout=t["watchdog"]),
        on_round=make_stall(t["stall_round"], 2 * t["watchdog"],
                            on_round=lambda k, m: sent.__setitem__(
                                k, float(m["agent_tx"][agent]))))
    server = session.serve_telemetry(port=0)

    def scrape(path):
        with urllib.request.urlopen(server.url + path, timeout=10) as r:
            return r.read().decode()

    def wait_for(rounds):
        deadline = time.monotonic() + 120
        while session.rollup.rounds < rounds:
            if time.monotonic() > deadline:
                raise AssertionError(f"telemetry: round {rounds} not "
                                     f"reached in 120 s")
            time.sleep(0.01)

    try:
        session.start(rounds=0)
        wait_for(10)
        first = _json.loads(scrape("/stats.json"))
        metrics = scrape("/metrics")
        wait_for(t["rounds"])
        second = _json.loads(scrape("/stats.json"))
    finally:
        session.stop()
        server.stop()
    stalls = session.rollup.snapshot().get("degradation_events", {})
    down = [k for k in sent if fault.down(k)]
    if not first["rounds"] < second["rounds"]:
        raise AssertionError(f"telemetry: scraped rounds did not grow: "
                             f"{first['rounds']} -> {second['rounds']}")
    if not metrics.startswith("# HELP fleet_rounds_total ") or \
            'fleet_tier_tx_rate{tier="metro"}' not in metrics:
        raise AssertionError("telemetry: /metrics is not the rollup's "
                             "Prometheus text")
    if stalls != {"stall": 1}:
        raise AssertionError(f"telemetry: degradation events {stalls}, "
                             f"want one stall")
    if len(down) != t["crash_rounds"] or any(sent[k] for k in down):
        raise AssertionError(f"telemetry: crashed agent {agent} sent in a "
                             f"down round or missed rounds: "
                             f"{[(k, sent[k]) for k in down]}")
    record = {"net": net.name, "rounds_scraped": [first["rounds"],
                                                  second["rounds"]],
              "rounds_served": session.round_index,
              "degradation_events": stalls, "crashed_agent": agent,
              "down_rounds": len(down),
              "sent_while_up_after_crash": sum(
                  sent[k] for k in sent if k >= t["crash_start"]
                  + t["crash_rounds"]),
              "rounds_per_s": second["rounds_per_sec"]}
    print(f"[telemetry] {net.name} in thread mode: /stats.json rounds "
          f"{first['rounds']} -> {second['rounds']}, /metrics scraped; a "
          f"{2 * t['watchdog']:.1f} s stall at round {t['stall_round']} under "
          f"a {t['watchdog']} s watchdog: events {stalls}; metro agent "
          f"{agent} crashed for rounds {t['crash_start']}-"
          f"{t['crash_start'] + t['crash_rounds'] - 1}: agent_tx 0 in all "
          f"{len(down)}; stopped after {session.round_index} rounds")
    return record


def phase_fleet_profile(torch, session, round_ms: float, label: str) -> dict:
    """Device ops, busy time and idle share of a fleet's rounds
    (``_profile_rounds``)."""
    return _profile_rounds(torch, lambda: session.run(1), round_ms, label)


def phase_frontier_profile(torch, run, batch_fn) -> dict:
    """Device ops, busy time and idle share of the quadratic frontier's
    rounds (``_profile_rounds``), continuing its run; a round draws its
    batch, steps every lane and pulls the metrics, as the run's rounds
    did."""
    state = {"states": run["states"][-1], "k": len(run["hist"])}

    def one_round():
        state["states"], m = run["bstep"](state["states"],
                                          batch_fn(state["k"]),
                                          run["scales"], run["chans"])
        _numpy_metrics(m)
        state["k"] += 1

    return _profile_rounds(torch, one_round, 1e3 / run["rounds_per_s"],
                           "frontier")


def _profile_rounds(torch, one_round, round_ms: float, label: str) -> dict:
    """Device ops, busy time and idle share of ``one_round()`` calls from
    a trace that holds exactly PROFILED_ROUNDS times one round's records
    (the most that three one-round traces hold), as ``device_ms``
    checks its traces; the idle share is against the round time
    measured without the profiler."""
    per_round = max(len(_device_records(torch, one_round, 1))
                    for _ in range(3))
    if per_round == 0:
        raise AssertionError(f"{label}: the profiler saw no device activity")
    recs, counts = _complete_records(torch, one_round, PROFILED_ROUNDS,
                                     per_round)
    busy = sum(t for _, t in recs) / 1e3 / PROFILED_ROUNDS
    by_name: dict = {}
    for n, t in recs:
        ms, c = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + t / 1e3 / PROFILED_ROUNDS, c + 1 / PROFILED_ROUNDS)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    record = {"device_ops_per_round": per_round,
              "device_busy_ms_per_round": busy,
              "round_ms_unprofiled": round_ms,
              "idle_share": 1.0 - busy / round_ms, "device_records": counts,
              "top": [{"name": n, "ms_per_round": ms, "per_round": c}
                      for n, (ms, c) in top]}
    print(f"[profile] {label}: {per_round} device ops per round, busy "
          f"{busy:.4f} ms of {round_ms:.4f} ms (unprofiled) -> idle share "
          f"{record['idle_share']:.3f} ({counts['records']} records in "
          f"{PROFILED_ROUNDS} rounds, as expected)")
    for n, (ms, c) in top:
        print(f"[profile]   {label} {ms:.4f} ms/round x{c:.0f}  {n[:80]}")
    return record


def _sim_check(card, cpu, grid, problem, trials: int) -> int:
    """The card's first ``trials`` trials of a sweep against the CPU's on
    the same batches: decisions exact except a gain within SIM_TOL
    (relative) of its threshold — the run is then compared up to that
    round — and J_traj within rtol SIM_TOL.  Returns the runs cut."""
    import numpy as np

    mode, lam, mu, decay = (x.numpy().astype(np.float64) for x in grid)
    K = cpu.alphas.shape[2]
    ks = np.arange(K, dtype=np.float64)
    rho = float(((1.0 - problem.eps * problem.sigma_diag.cpu().double()) ** 2)
                .max())
    lam_k = np.where(decay[:, None] == 0, lam[:, None],
                     np.where(decay[:, None] == 1, lam[:, None] / (1 + ks),
                              lam[:, None] * rho ** ks))
    thr = np.where(mode[:, None] == 2, -problem.eps * mu[:, None], -lam_k)
    ca, cg = card.alphas[:, :trials].cpu().numpy(), cpu.alphas.numpy()
    cj, hj = card.J_traj[:, :trials].cpu().numpy(), cpu.J_traj.numpy()
    gains = cpu.gains.numpy()
    cut = 0
    for g in range(ca.shape[0]):
        for t in range(trials):
            rounds = K
            if not np.array_equal(ca[g, t], cg[g, t]):
                k, i = np.argwhere(ca[g, t] != cg[g, t])[0]
                if not abs(gains[g, t, k, i] - thr[g, k]) <= SIM_TOL * max(
                        1.0, abs(thr[g, k])):
                    raise AssertionError(
                        f"sim card vs CPU: point {g} trial {t} round {k} "
                        f"agent {i}: decision differs at gain "
                        f"{gains[g, t, k, i]} (threshold {thr[g, k]})")
                rounds, cut = k, cut + 1
            if not np.allclose(cj[g, t, :rounds + 1], hj[g, t, :rounds + 1],
                               rtol=SIM_TOL, atol=0.0):
                raise AssertionError(f"sim card vs CPU: J_traj of point {g} "
                                     f"trial {t} differs")
    return cut


def phase_sim(torch) -> tuple:
    """The paper's closed-form simulator on the card: the five figure
    drivers at full trials (each asserting its claims), the README
    Quickstart's λ loop, then one sweep at the fleet's size, timed and
    held to the CPU on SIM_CHECK_TRIALS trials' batches."""
    import importlib

    from repro_torch.configs.paper_linreg import FIG2_LEFT, TIERED_M64_CFG
    from repro_torch.core import regression as R
    from repro_torch.core.regression import Problem
    from repro_torch.figures import FIGURES, seeded

    dev = torch.device("cuda", torch.cuda.current_device())
    record = {"figures": {}}
    for name in FIGURES:
        mod = importlib.import_module(f"repro_torch.figures.{name}")
        mod.run(device=dev)  # warm-up (and the claims, asserted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = mod.run(device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        claims = payload.get("claims", {"all_bounds_hold":
                                        payload.get("all_bounds_hold")})
        record["figures"][name] = {"ms": ms, "payload": payload}
        print(f"[sim] {name}: {payload['trials']} trials in {ms:.1f} ms; "
              f"claims {claims}")
    problem = R.make_problem(FIG2_LEFT, seeded(0, dev), device=dev)
    quick = []
    for lam in (0.0, 0.5, 2.0, 5.0):
        res = R.run_many(problem, seeded(1, dev), steps=10, num_trials=64,
                         policy=f"gain_estimated(lam={lam})")
        quick.append({"lam": lam, "final_J": float(res.J_traj[:, -1].mean()),
                      "transmissions": float(res.alphas.sum((1, 2)).mean())})
    tx = [q["transmissions"] for q in quick]
    if not all(a > b for a, b in zip(tx, tx[1:])):
        raise AssertionError(f"quickstart: transmissions do not fall as λ "
                             f"rises: {quick}")
    record["quickstart"] = quick
    print("[sim] quickstart: " + "; ".join(
        f"lam={q['lam']}: final J={q['final_J']:.3f} mean transmissions="
        f"{q['transmissions']:.1f}" for q in quick))

    cfg = TIERED_M64_CFG
    fleet = R.make_problem(cfg, seeded(0, dev), device=dev)
    grid = R.grid_concat(R.lambda_grid(SIM_LAMS),
                         R.lambda_grid(SIM_LAMS, mode="gain_exact"))
    T, K = SIM_TRIALS, cfg.steps
    R.sweep(fleet, seeded(1, dev), K, grid, T)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = R.sweep(fleet, seeded(1, dev), K, grid, T)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    sweep_ms = statistics.median(times)
    if not bool(torch.isfinite(res.J_traj).all()):
        raise AssertionError("sim: non-finite J on the card")
    # the same sweep again, keeping the first trials' batches for the CPU
    kept = []
    gen = seeded(1, dev)

    def source(k):
        xs, ys = R.trial_batches(fleet, gen, T)
        kept.append((xs[:SIM_CHECK_TRIALS].cpu(), ys[:SIM_CHECK_TRIALS].cpu()))
        return xs, ys

    card = R.sweep(fleet, source, K, grid, T)
    if not all(torch.equal(a, b) for a, b in zip(card, res)):
        raise AssertionError("sim: the same sweep twice differs on the card")
    cpu_problem = Problem(fleet.sigma_diag.cpu(), fleet.w_star.cpu(),
                          fleet.noise_std, fleet.eps, fleet.n_samples,
                          fleet.num_agents)
    t0 = time.perf_counter()
    cpu = R.sweep(cpu_problem, lambda k: kept[k], K, grid, SIM_CHECK_TRIALS)
    cpu_s = time.perf_counter() - t0
    cut = _sim_check(card, cpu, grid, fleet, SIM_CHECK_TRIALS)
    batch_mb = 4 * T * cfg.num_agents * cfg.samples_per_agent * (cfg.n + 1) / 1e6
    J, comm, _ = (x.tolist() for x in R.frontier(res))
    record["fleet_sweep"] = {
        "config": cfg.name, "grid_points": len(grid.mode), "trials": T,
        "steps": K, "ms_per_sweep": sweep_ms, "ms_runs": times,
        "batch_mb_per_round": batch_mb, "mean_final_J": J,
        "mean_total_comm": comm, "cpu_trials_checked": SIM_CHECK_TRIALS,
        "cpu_runs_cut_at_threshold": cut, "cpu_seconds": cpu_s}
    print(f"[sim] sweep at {cfg.name} (n={cfg.n}, m={cfg.num_agents}, "
          f"N={cfg.samples_per_agent}, K={K}): {len(grid.mode)} grid points "
          f"× {T} trials, {batch_mb:.0f} MB of batch per round: "
          f"{sweep_ms:.2f} ms per sweep (median of {times}); first "
          f"{SIM_CHECK_TRIALS} trials match the CPU on the same batches "
          f"({cut} runs cut at a near-threshold decision)")
    return record, (fleet, grid, K, sweep_ms)


def phase_sim_profile(torch, fleet, grid, steps: int,
                      sweep_ms: float) -> dict:
    """Fleet-size sweeps under torch.profiler: device time, device ops
    and the idle share against the unprofiled sweep time.  The trace is
    taken as ``device_ms`` takes it (after a dropped profiler cycle) and
    must hold exactly SIM_PROFILED_SWEEPS times the records of one sweep,
    the most that three one-sweep traces hold."""
    from repro_torch.core import regression as R
    from repro_torch.figures import seeded

    def sweep():
        R.sweep(fleet, seeded(1, fleet.device), steps, grid, SIM_TRIALS)

    per_call = max(len(_device_records(torch, sweep, 1)) for _ in range(3))
    if per_call == 0:
        raise AssertionError("the profiler saw no device activity")
    ivals, counts = _complete_records(torch, sweep, SIM_PROFILED_SWEEPS,
                                      per_call)
    busy = sum(t for _, t in ivals) / 1e3 / SIM_PROFILED_SWEEPS
    by_name: dict = {}
    for n, t in ivals:
        ms, c = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + t / 1e3 / SIM_PROFILED_SWEEPS,
                      c + 1 / SIM_PROFILED_SWEEPS)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    record = {"device_ms": busy, "device_ops": per_call,
              "device_records": counts,
              "sweep_ms_unprofiled": sweep_ms,
              "idle_share": 1.0 - busy / sweep_ms,
              "top": [{"name": n, "ms": ms, "count": c}
                      for n, (ms, c) in top]}
    print(f"[profile] sim sweep: {busy:.2f} ms on the device in "
          f"{per_call} device ops per sweep ({counts['records']} records "
          f"in {SIM_PROFILED_SWEEPS} sweeps, as expected) against the "
          f"unprofiled {sweep_ms:.2f} ms -> idle share "
          f"{record['idle_share']:.3f}")
    for n, (ms, c) in top:
        print(f"[profile]   sim {ms:8.3f} ms x{c:<5.0f} {n[:90]}")
    return record


def phase_profile(torch, session, round_ms: float) -> dict:
    """Device time of served rounds, from a torch.profiler trace.

    Busy time is the sum of the card's kernel and copy intervals (one
    stream, so they do not overlap); the idle share compares it with
    the round time measured WITHOUT the profiler in the main run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session.run(PROFILED_ROUNDS)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    # host side: self time of the traced operators and runtime calls
    # (what is not in them is Python between the calls)
    host = [(a.key, a.self_cpu_time_total, a.count)
            for a in prof.key_averages()
            if a.device_type == DeviceType.CPU and a.self_cpu_time_total > 0]
    host_ms = sum(t for _, t, _ in host) / 1e3 / PROFILED_ROUNDS
    host_top = sorted(host, key=lambda x: -x[1])[:8]
    if not by_name:
        raise AssertionError("the profiler saw no device activity")
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / PROFILED_ROUNDS
    kernels = sum(c for _, c in by_name.values()) / PROFILED_ROUNDS
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    idle = 1.0 - busy_ms / round_ms
    print(f"[profile] per round: {kernels:.0f} device ops, device busy "
          f"{busy_ms:.4f} ms of {round_ms:.4f} ms (unprofiled) -> idle "
          f"share {idle:.3f}")
    for name, (t, c) in top:
        print(f"[profile]   {t / 1e3 / PROFILED_ROUNDS:.4f} ms/round "
              f"x{c / PROFILED_ROUNDS:.0f}  {name[:90]}")
    print(f"[profile] host, under the profiler: {host_ms:.3f} ms/round "
          f"of self time in traced operators and runtime calls")
    for name, t, c in host_top:
        print(f"[profile]   host {t / 1e3 / PROFILED_ROUNDS:.4f} ms/round "
              f"x{c / PROFILED_ROUNDS:.0f}  {name[:80]}")
    return {"rounds": PROFILED_ROUNDS, "device_ops_per_round": kernels,
            "device_busy_ms_per_round": busy_ms,
            "round_ms_unprofiled": round_ms, "idle_share": idle,
            "top": [{"name": n, "ms_per_round": t / 1e3 / PROFILED_ROUNDS,
                     "per_round": c / PROFILED_ROUNDS}
                    for n, (t, c) in top],
            "host_self_ms_per_round": host_ms,
            "host_top": [{"name": n, "ms_per_round": t / 1e3 / PROFILED_ROUNDS,
                          "per_round": c / PROFILED_ROUNDS}
                         for n, t, c in host_top]}


def _device_records(torch, fn, calls: int):
    """The device records (name, µs) of ``calls`` calls of ``fn`` in a
    torch.profiler trace.  The trace is the second cycle of a profiler
    schedule: a first cycle of one call, dropped, lets device tracing
    start before the recorded calls are made (a trace begun with them
    kept none of a single long call's records).  The second cycle also
    opens with one call that is not counted: its first record can go
    missing too (the 12.8 ms `fused_ce` partial of the first call of
    (4096, 3072, 128256) bf16 in most traces on the H100).  The counted
    calls run inside a ``record_function`` range with TRACE_GAP_S of
    idle card before and after it, so that a skew between the host's
    and the card's clocks up to half the gap neither cuts a call's
    record at the cycle's end nor keeps one of the call before: only
    records that start after the middle of the gap before the range
    are kept."""
    from torch.autograd import DeviceType
    from torch.profiler import (
        ProfilerActivity,
        profile,
        record_function,
        schedule,
    )

    mark = "chip_smoke.device_ms"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_GAP_S)
        with record_function(mark):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        time.sleep(TRACE_GAP_S)
        prof.step()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == mark and e.device_type == DeviceType.CPU)
    start = span.start - TRACE_GAP_S * 1e6 / 2
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name != mark]
    kept = [e for e in device if e.time_range.start >= start]
    # for the error message of an incomplete trace: the records left out
    # (their starts from the range's, µs), and the kept records' first
    # start and last end from the range's start and end (the calls end
    # before the range does, so a positive last end is a clock skew)
    _device_records.before = [round(e.time_range.start - span.start, 1)
                              for e in device if e.time_range.start < start]
    _device_records.edges = (
        round(min(e.time_range.start for e in kept) - span.start, 1),
        round(max(e.time_range.end for e in kept) - span.end, 1),
    ) if kept else None
    return [(e.name, e.time_range.elapsed_us()) for e in kept]


def _complete_records(torch, fn, calls: int, per_call: int,
                      kernel: str | None = None) -> tuple:
    """The device records of a trace of ``calls`` calls of ``fn`` that
    holds exactly ``per_call`` × ``calls`` of them and, where ``kernel``
    names one of the port's kernels, none but its device functions'.
    The profiler drops records of some traces: a trace that does not
    hold that count is taken again, and after ``DEVICE_TRACE_ATTEMPTS``
    such traces the measurement fails.  Returns the records and their
    counts, with the traces that fell short."""
    want = per_call * calls
    seen = []
    for _ in range(DEVICE_TRACE_ATTEMPTS):
        recs = _device_records(torch, fn, calls)
        other = 0 if kernel is None else sum(kernel not in n for n, _ in recs)
        names: dict = {}
        for n, _ in recs:
            names[n[:40]] = names.get(n[:40], 0) + 1
        seen.append({"records": len(recs), "other": other,
                     "left_out_starts_us": _device_records.before,
                     "edges_us": _device_records.edges, "by_name": names})
        if len(recs) == want and other == 0:
            return recs, {"records_per_call": per_call,
                          "records": len(recs), "expected": want,
                          "attempts": len(seen),
                          "edges_us": _device_records.edges,
                          "short_traces": seen[:-1]}
    raise AssertionError(
        f"device records: {len(seen)} traces of {calls} calls held {seen} "
        f"(edges: the kept records' first start and last end against the "
        f"range's, µs), not the {want} records ({per_call} per call"
        + ("" if kernel is None else f", all of {kernel}") + ") the calls make")


def device_ms(torch, fn, calls: int = 20, kernel=None) -> float:
    """Device time of one ``fn()`` call: the summed durations of the
    device records of a torch.profiler trace of ``calls`` calls (free of
    the host's dispatch time that CUDA events include).

    The trace must hold exactly the records the calls make
    (``_complete_records``).  For a row of one of the port's kernels,
    ``kernel`` is ``(wrapper, name, functions)``: the wrapper's own
    ``launches`` counter, read around one call outside the profiler,
    gives its launches per call, each of which runs ``functions``
    device functions whose names hold ``name``, and the calls make
    those records and no other.  For a plain or library row, which has
    no counter, the records per call are the count that most of five
    one-call traces hold (the larger of equally common counts): a
    one-call trace can lose a record or hold a stray one (the most of
    five held 6 where F.cross_entropy at (4096, 3072, 128256) fp32
    makes 4, and every trace of 20 calls then fell short on the H100).
    ``device_ms.last`` keeps the counts of the last measurement."""
    if kernel is None:
        held = [len(_device_records(torch, fn, 1)) for _ in range(5)]
        per_call = max(held, key=lambda c: (held.count(c), c))
        source, name = "profiler", None
    else:
        wrapper, name, functions = kernel
        before = wrapper.launches
        fn()
        torch.cuda.synchronize()
        per_call = (wrapper.launches - before) * functions
        source = "launch counter"
    if per_call == 0:
        raise AssertionError("device_ms: the call made no device records")
    recs, counts = _complete_records(torch, fn, calls, per_call, name)
    device_ms.last = {**counts, "expected_from": source}
    return sum(t for _, t in recs) / calls / 1e3


def phase_times(torch, gr_ops, ref) -> list:
    """Per shape and dtype: the kernel, its plain version and two
    ``vecdot`` calls, first by CUDA events around each call (what a
    caller waits, host dispatch included), then by the profiler's
    device time (what the card spends).  The profiler runs last: its
    callbacks slow every later launch on the host."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for rows, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
            h = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
            # one launch runs a second function to sum the splits
            functions = 1 + (gr_ops._splits(n, gr_ops._DTYPE_CODES[dtype]) > 1)
            fns = {
                "": lambda g=g, h=h: gr_ops.gain_reduce(g, h),
                "plain_": lambda g=g, h=h: ref.gain_reduce_ref(g, h),
                "library_": lambda g=g, h=h: (torch.linalg.vecdot(g, g),
                                              torch.linalg.vecdot(g, h)),
            }
            bound_ms, bound_by = bound(gr_ops, rows, n, dtype)
            cases.append(({"shape": [rows, n],
                           "dtype": str(dtype).split(".")[-1],
                           "bound_ms": bound_ms, "bound_by": bound_by},
                          fns, (gr_ops.gain_reduce, "gain_reduce",
                                functions)))
    before = gr_ops.gain_reduce.launches
    for row, fns, _ in cases:
        for key, fn in fns.items():
            row[f"{key}ms"] = time_ms(fn)
    for row, fns, kernel in cases:
        for key, fn in fns.items():
            row[f"{key}device_ms"] = device_ms(
                torch, fn, kernel=None if key else kernel)
            row[f"{key}device_records"] = dict(device_ms.last)
    gr_ops.gain_reduce.launches = before  # timing launches do not count
    for row, _, _ in cases:
        (rows, n), dt = row["shape"], row["dtype"]
        print(f"[times] {rows}x{n} {dt}: per call (events) kernel "
              f"{row['ms']:.4f} / plain {row['plain_ms']:.4f} / vecdot x2 "
              f"{row['library_ms']:.4f} ms; on the device kernel "
              f"{row['device_ms']:.5f} / plain {row['plain_device_ms']:.5f}"
              f" / vecdot x2 {row['library_device_ms']:.5f} ms; bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return [row for row, _, _ in cases]


def phase_launch_floor(torch, gr_ops, times: list) -> dict:
    """The card's launch floor and ``gain_reduce``'s HBM share: the
    device time of a kernel that does nothing (``gain_reduce.cu``'s
    ``gain_reduce_empty``, one block of one thread), beside the kernel's
    at the fleet's (64, 32); and at one (1, 2^26) row, the kernel's
    bytes over HBM bandwidth as a share of its device time, from the
    same [times] run."""
    import ctypes

    lib = gr_ops._library()
    lib.gain_reduce_empty_launch.argtypes = [ctypes.c_void_p]
    lib.gain_reduce_empty_launch.restype = ctypes.c_int

    def empty():
        err = lib.gain_reduce_empty_launch(
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel: CUDA error {err}")

    floor = device_ms(torch, empty)
    fleet = next(r for r in times if r["shape"] == [64, 32]
                 and r["dtype"] == "float32")
    rows = {r["dtype"]: r for r in times if r["shape"] == [1, 1 << 26]}
    shares = {dt: r["bound_ms"] / r["device_ms"] for dt, r in rows.items()}
    print(f"[times] empty kernel {floor:.5f} ms on the device, "
          f"gain_reduce (64, 32) fp32 {fleet['device_ms']:.5f} ms; "
          f"gain_reduce (1, 2^26): HBM share "
          + ", ".join(f"{dt} {shares[dt]:.1%} ({rows[dt]['bound_ms']:.4f} "
                      f"/ {rows[dt]['device_ms']:.4f} ms)" for dt in rows))
    return {"empty_device_ms": floor,
            "fleet_device_ms": fleet["device_ms"],
            "hbm_share_1x2p26": shares}


# ----------------------------------------------------------------------
# swa_attention and the LM slice
# ----------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _swa_inputs(torch, gen, shape, dtype, head_major: bool = False):
    """Normal q, k, v in the model layout (B, S, heads, hd); with
    ``head_major`` each is a (B, heads, S, hd) tensor viewed in that
    layout (other strides, same values)."""
    b, s, h, kv, hd, _ = shape
    out = []
    for heads in (h, kv, kv):
        dims = (b, heads, s, hd) if head_major else (b, s, heads, hd)
        x = torch.randn(dims, generator=gen, device="cuda").to(dtype)
        out.append(x.transpose(1, 2) if head_major else x)
    return out


def path_bounds(work: dict) -> dict:
    """Least times (ms) for a kernel's work, from its own cost record
    (``ops.cost``) at the H100's peaks
    (``repro_torch.analysis.roofline.kernel_bound``): on its tensor-core
    path, the operations it runs there (fp32 inputs in 3×TF32, three
    products per product, at the dense TF32 rate; bf16 at the bf16
    rate) and, for fp32, the function's flops on the fp32 CUDA cores
    (67 TFLOP/s, the design before the tensor cores), each the larger
    of the operations' time and the bytes' time over HBM bandwidth.
    ``bound_ms`` is the path's: the least time the arithmetic the kernel
    runs could take."""
    from repro_torch.analysis.roofline import kernel_bound

    ms, by = kernel_bound(work["path_flops"], work["hbm_bytes"],
                          work["path"])
    fma = (kernel_bound(work["flops"], work["hbm_bytes"], "fp32")[0]
           if work["path"] == "tf32x3" else None)
    return {"bound_ms": ms, "bound_by": by, "bound_fp32_fma_ms": fma}


def swa_bound(swa_ops, shape, dtype):
    """The bounds of :func:`path_bounds` for one call of the kernel's
    cost record: the two products' 4·hd flops per (query, visible key)
    pair and head, the softmax's and the normalisation's, q, k, v read
    and o written once; the tensor cores run the products three times
    in fp32 (3×TF32) and Q·Kᵀ once and P·V twice (P in two bf16 parts)
    in bf16."""
    b, s, h, kv, hd, w = shape
    work = swa_ops.cost(b, s, h, kv, hd, w, dtype)
    return path_bounds(work), work["flops"], work["hbm_bytes"]


def phase_swa_kernel(torch, swa_ops, swa_ref) -> list:
    """``swa_attention`` against its plain version on the card, at every
    SWA_CHECK shape in fp32 and bf16; a repeated launch bitwise equal."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = []
    for shape in SWA_CHECK + SWA_EDGE:
        for dtype in (torch.float32, torch.bfloat16):
            dt = _dtype_name(dtype)
            q, k, v = _swa_inputs(torch, gen, shape, dtype)
            w = shape[-1]
            got = swa_ops.swa_attention(q, k, v, window=w)
            again = swa_ops.swa_attention(q, k, v, window=w)
            want = swa_ref.swa_attention_ref(q, k, v, window=w)
            torch.cuda.synchronize()
            name = f"swa_attention {shape[:5]} W={w} {dt}"
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: repeated launch differs")
            if got.dtype != dtype or got.shape != q.shape:
                raise AssertionError(f"{name}: output {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = (got.float() - want.float()).abs()
            tol = SWA_TOL[dt]
            if not bool((err <= tol + tol * want.float().abs()).all()):
                raise AssertionError(f"{name}: kernel disagrees with its "
                                     f"plain version (max err "
                                     f"{err.max().item():.3e})")
            # the share of outputs not equal to the plain version's: in
            # bf16, where the two round fp32 results that differ to
            # different bf16 values
            differs = (got != want).float().mean().item()
            results.append({"shape": list(shape[:5]), "window": w,
                            "dtype": dt, "max_abs_err": err.max().item(),
                            "tol": tol, "differs_share": differs,
                            "bitwise_repeat": True})
            print(f"[swa] B,S,H,KV,hd={shape[:5]} W={w} {dt}: vs plain "
                  f"{err.max().item():.3e} within {tol} + {tol}·|plain|, "
                  f"{differs:.2e} of outputs differ; repeat bitwise equal")
            del q, k, v, got, again, want, err
    shape = SWA_SERVED[0]
    q, k, v = _swa_inputs(torch, gen, shape, torch.float32, head_major=True)
    strided = swa_ops.swa_attention(q, k, v, window=shape[-1])
    dense = swa_ops.swa_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=shape[-1])
    torch.cuda.synchronize()
    if not torch.equal(strided, dense):
        raise AssertionError("swa_attention: a strided (head-major) input "
                             "differs from its contiguous copy")
    print(f"[swa] head-major inputs viewed as {shape[:5]}: equal to the "
          f"contiguous inputs' result")
    # inputs one element off the 16-byte alignment take the kernel's plain
    # loads instead of cp.async: the same staged tiles, the same result
    shape = SWA_EDGE[0]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _swa_inputs(torch, gen, shape, dtype)
        off = [_rows(lambda n: torch.empty(n, dtype=dtype, device="cuda"),
                     1, x.numel(), 1).view(x.shape).copy_(x)
               for x in (q, k, v)]
        a = swa_ops.swa_attention(*off, window=shape[-1])
        b = swa_ops.swa_attention(q, k, v, window=shape[-1])
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"swa_attention: unaligned {dtype} inputs "
                                 "differ from aligned ones")
    print(f"[swa] inputs one element off alignment at {shape[:5]}, fp32 "
          f"and bf16: equal to the aligned inputs' result")
    hd = SWA_NO_INSTANCE_HD
    q = torch.randn((1, 64, 2, hd), generator=gen, device="cuda")
    launches = swa_ops.swa_attention.launches
    try:
        swa_ops.swa_attention(q, q, q, window=16)
    except ValueError as err:
        print(f"[swa] head dim {hd} (no kernel instance) raises on the "
              f"card: {err}")
    else:
        raise AssertionError(f"swa_attention: head dim {hd} has no kernel "
                             f"instance and did not raise")
    if swa_ops.swa_attention.launches != launches:
        raise AssertionError(f"swa_attention: head dim {hd} launched")
    results.append(_swa_grad_and_vmap(torch, swa_ops, swa_ref, gen))
    return results


def _swa_grad_and_vmap(torch, swa_ops, swa_ref, gen) -> dict:
    """The Function's gradients at the served shape against autograd
    through the plain version (the same backward math; they differ only
    through the kernel's and the plain forward's outputs), and vmap over
    3 slices: one launch, bitwise equal to three."""
    shape = SWA_SERVED[0]
    w = shape[-1]
    q, k, v = _swa_inputs(torch, gen, shape, torch.float32)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = swa_ops.swa_attention.launches
    got = torch.autograd.grad(
        (swa_ops.swa_attention(*leaves, window=w) * dout).sum(), leaves)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        (swa_ref.swa_attention_ref(*plain, window=w) * dout).sum(), plain)
    errs = []
    for name, g, p in zip("qkv", got, want):
        err = (g - p).abs().max().item()
        scale = p.abs().max().item()
        if not err <= SWA_GRAD_TOL * scale:
            raise AssertionError(f"swa_attention d{name}: {err:.3e} vs "
                                 f"autograd of the plain version (scale "
                                 f"{scale:.3e})")
        errs.append(err / scale)
    mapped_in = [torch.stack([x, x.flip(1), 0.5 * x]) for x in (q, k, v)]
    swa_ops.swa_attention.launches = 0
    mapped = torch.func.vmap(
        lambda a, b, c: swa_ops.swa_attention(a, b, c, window=w))(*mapped_in)
    torch.cuda.synchronize()
    folded = swa_ops.swa_attention.launches
    looped = torch.stack([swa_ops.swa_attention(*(x[i] for x in mapped_in),
                                                window=w) for i in range(3)])
    swa_ops.swa_attention.launches = before  # check launches do not count
    if folded != 1 or not torch.equal(mapped, looped):
        raise AssertionError(f"swa_attention under vmap: {folded} launches, "
                             f"equal to a loop: {torch.equal(mapped, looped)}")
    print(f"[swa] gradients at {shape[:5]} W={w}: dq, dk, dv within "
          f"{max(errs):.2e}·max|g| of autograd through the plain version "
          f"(tol {SWA_GRAD_TOL}); vmap over 3 slices: {folded} launch, "
          f"bitwise equal to 3 launches")
    return {"shape": list(shape[:5]), "window": w,
            "grad_max_err_over_scale": max(errs), "grad_tol": SWA_GRAD_TOL,
            "vmap_launches": folded, "vmap_equal_to_loop": True}


def _lm_run(torch, swa_ops, serve, model, params, prompts, gen: int,
            label: str, tag: str = "lm", check_decode: bool = True) -> dict:
    """One served batch through the serving CLI's prefill and greedy
    decode: warm-up, then the counted and timed run, then (with
    ``check_decode``) decode against a fresh prefill of the same tokens.
    An attention model's prefill launches ``swa_attention`` once per
    layer; the hybrid's replays the prompt through decode (no launch)
    and returns the last position's logits."""
    b, s = prompts.shape
    recurrent = model.cfg.arch_type in ("hybrid", "ssm")
    cache_len = s + gen + 8
    # warm-up (a recurrent replay is a loop of decode steps: a few warm
    # every op it runs)
    warm = prompts[:, :16] if recurrent else prompts
    toks, _, cache = serve.prefill_prompt(model, params, warm, cache_len)
    serve.decode_tokens(model, params, cache, toks, warm.shape[1], 2)
    del toks, cache
    torch.cuda.synchronize()

    swa_ops.swa_attention.launches = 0
    t0 = time.perf_counter()
    toks, logits, cache = serve.prefill_prompt(model, params, prompts,
                                               cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    in_prefill = swa_ops.swa_attention.launches
    t0 = time.perf_counter()
    rest, last = serve.decode_tokens(model, params, cache, toks, s, gen - 1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = swa_ops.swa_attention.launches
    layers = 0 if recurrent else model.cfg.num_layers
    if in_prefill != layers or launches != layers:
        raise AssertionError(
            f"LM run ({label}): swa_attention launched {in_prefill} times "
            f"in the prefill and {launches - in_prefill} in decode (want "
            f"{layers} and 0)")
    if logits.shape != (b, 1 if recurrent else s, model.cfg.vocab_size):
        raise AssertionError(f"LM run ({label}): logits {logits.shape}")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(last).all())):
        raise AssertionError(f"LM run ({label}): non-finite logits")
    tokens = torch.cat([toks, rest], 1)
    del logits, cache

    # decode through the cache against a prefill of prompt + the tokens
    # fed to decode: the last decode step's logits are that prefill's
    # last row, where the cache holds every position (no window)
    window = model.cfg.swa_window
    gap = None
    if check_decode:
        full = torch.cat([prompts, tokens[:, :-1].to(prompts.dtype)], 1)
        ref_logits, _ = model.prefill(params, {"tokens": full},
                                      cache_len=full.shape[1])
        gap = (last - ref_logits[:, -1]).abs().max().item()
        del ref_logits
    # exact where the ring buffer never overwrites a live key: no window,
    # S a multiple of it, or a cache that never wraps
    exact = check_decode and (window is None or s % window == 0
                              or cache_len <= window)
    if exact and not gap <= LM_LOGIT_TOL * (1 + last.abs().max().item()):
        raise AssertionError(f"LM run ({label}): decode differs from a "
                             f"fresh prefill by {gap:.3e}")
    # an attention-free replay (ssm) is the same decode steps on the same
    # states: the fresh replay's last logits are bitwise the decoded ones
    # (the hybrid's shared attention reads a cache of another length)
    if model.cfg.arch_type == "ssm" and check_decode and gap != 0:
        raise AssertionError(f"LM run ({label}): decode differs from a "
                             f"fresh replay by {gap:.3e} (want bitwise)")
    steps = gen - 1
    row = {"batch": b, "prompt": s, "gen": gen, "window": window,
           "launches": launches, "launches_prefill": in_prefill,
           "launches_decode": launches - in_prefill,
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": b * s / prefill_s,
           "decode_ms_per_step": decode_s / steps * 1e3,
           "decode_tokens_per_s": b * steps / decode_s,
           "decode_vs_prefill_max_abs": gap,
           "decode_vs_prefill_checked": exact,
           "first_tokens": tokens[0, :8].tolist()}
    if not check_decode:
        tail = " (decode checked separately)"
    else:
        note = ("" if exact else " (not checked: the reference's ring "
                "buffer overwrites a live key when S % W ≠ 0, ROADMAP §3)")
        tail = f"; decode vs fresh prefill max |gap| {gap:.3e}{note}"
    print(f"[{tag}] ({label}) B={b} S={s} W={window}: swa_attention "
          f"launches {in_prefill} in prefill, {launches - in_prefill} in "
          f"decode; prefill {row['prefill_ms']:.2f} ms "
          f"({row['prefill_tokens_per_s']:.0f} tok/s); decode "
          f"{row['decode_ms_per_step']:.3f} ms/step "
          f"({row['decode_tokens_per_s']:.1f} tok/s){tail}")
    return row


def _card_vs_cpu(torch, serve, model, params, prompts,
                 gen: int = LM_CHECK["gen"], tag: str = "lm",
                 extra_tol: float = 0.0) -> dict:
    """The same weights and prompts through the port on the card (the
    kernels) and on the CPU (their plain versions): prefill logits within
    ``LM_LOGIT_TOL`` + ``LM_LOGIT_TOL``·|cpu| (+ ``extra_tol``), greedy
    tokens equal."""
    from repro_torch.utils.tree import tree_map

    b, s = prompts.shape
    runs = {}
    for where, p, x in (("card", params, prompts),
                        ("cpu", tree_map(lambda t: t.cpu(), params),
                         prompts.cpu())):
        t0 = time.perf_counter()
        toks, logits, cache = serve.prefill_prompt(model, p, x, s + gen + 8)
        rest, _ = serve.decode_tokens(model, p, cache, toks, s, gen - 1)
        runs[where] = (logits.cpu(), torch.cat([toks, rest], 1).cpu(),
                       time.perf_counter() - t0)
    (lc, tc, _), (lh, th, cpu_s) = runs["card"], runs["cpu"]
    gap = (lc - lh).abs()
    tol = LM_LOGIT_TOL + extra_tol
    if not bool((gap <= tol + LM_LOGIT_TOL * lh.abs()).all()):
        raise AssertionError(f"card vs CPU: prefill logits differ by "
                             f"{gap.max().item():.3e}")
    if not torch.equal(tc, th):
        raise AssertionError(f"card vs CPU: greedy tokens differ:\n{tc}\n"
                             f"{th}")
    top2 = lh[:, -1].topk(2, -1).values
    margin = (top2[:, 0] - top2[:, 1]).min().item()
    print(f"[{tag}] card vs CPU, B={b} S={s}: prefill logits max |gap| "
          f"{gap.max().item():.3e} (tol {tol:.3g} + {LM_LOGIT_TOL}"
          f"·|cpu|), {gen} greedy tokens equal; CPU run {cpu_s:.1f} s")
    return {"batch": b, "prompt": s, "gen": gen,
            "logits_max_abs_gap": gap.max().item(), "tol": tol,
            "tokens_equal": True, "last_row_top2_margin": margin}


def phase_lm(torch, swa_ops) -> tuple:
    """The LM serving slice on the card: runs (a) and (b), then the card
    against the CPU.  Returns (record, run (a)'s model, params, prompts)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import sample_lm_tokens
    from repro_torch.launch import serve
    from repro_torch.models import build, long_context_variant
    from repro_torch.utils.tree import tree_size

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(LM_ARCH)
    models = {label: build(long_context_variant(cfg) if run["long_context"]
                           else cfg) for label, run in LM_RUNS.items()}
    params, _ = models["a"].init(torch.Generator(device=dev).manual_seed(0))
    n_params = tree_size(params)
    longest = max(r["prompt"] for r in LM_RUNS.values())
    widest = max(r["batch"] for r in LM_RUNS.values())
    t0 = time.perf_counter()
    prompts = sample_lm_tokens(torch.Generator(device=dev).manual_seed(7),
                               widest, longest, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the 9.7 GB bigram table
    print(f"[lm] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim_}, "
          f"vocab {cfg.vocab_size}, {n_params / 1e6:.1f}M parameters "
          f"(fp32, seed 0); prompts drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    record = {"arch": cfg.name, "params": n_params}
    for label, run in LM_RUNS.items():
        record[label] = _lm_run(
            torch, swa_ops, serve, models[label], params,
            prompts[:run["batch"], :run["prompt"]].contiguous(),
            run["gen"], label)
    record["card_vs_cpu"] = _card_vs_cpu(
        torch, serve, models["a"], params,
        prompts[:LM_CHECK["batch"], :LM_CHECK["prompt"]].contiguous())
    run_a = LM_RUNS["a"]
    return record, models["a"], params, prompts[
        :run_a["batch"], :run_a["prompt"]].contiguous()


def phase_swa_times(torch, swa_ops, swa_ref) -> list:
    """Per served shape and dtype: the kernel, its plain version and
    ``scaled_dot_product_attention`` (the same boolean window mask, GQA
    heads expanded beforehand, head-major layout), per call by CUDA
    events and on the device by the profiler, beside the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for shape in SWA_SERVED:
        b, s, h, kv, hd, w = shape
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - w)
        # bf16 too at every served shape but the moe, vlm and hybrid
        # [mesh] ranks' heads (their jobs run in fp32)
        dtypes = ((torch.float32,) if shape in SWA_SERVED[6:9]
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            q, k, v = _swa_inputs(torch, gen, shape, dtype)
            qh = q.transpose(1, 2).contiguous()
            kh = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)
            vh = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
            kh, vh = kh.contiguous(), vh.contiguous()
            fns = {
                "": lambda q=q, k=k, v=v, w=w: swa_ops.swa_attention(
                    q, k, v, window=w),
                "plain_": lambda q=q, k=k, v=v, w=w: swa_ref.swa_attention_ref(
                    q, k, v, window=w),
                "library_": lambda qh=qh, kh=kh, vh=vh, m=mask:
                    F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m),
            }
            lib_err = (fns["library_"]().transpose(1, 2).float()
                       - fns["plain_"]().float()).abs().max().item()
            bounds, flops, nbytes = swa_bound(swa_ops, shape, dtype)
            cases.append(({"shape": list(shape[:5]), "window": w,
                           "dtype": _dtype_name(dtype),
                           "path": swa_ops.PATHS[dtype], "flops": flops,
                           "bytes": nbytes, **bounds,
                           "library_max_abs_err": lib_err}, fns))
    before = swa_ops.swa_attention.launches
    for row, fns in cases:
        for key, fn in fns.items():
            row[f"{key}ms"] = time_ms(fn)
    for row, fns in cases:
        for key, fn in fns.items():
            row[f"{key}device_ms"] = device_ms(
                torch, fn, kernel=None if key else (
                    swa_ops.swa_attention, "swa_attention", 1))
            row[f"{key}device_records"] = dict(device_ms.last)
    swa_ops.swa_attention.launches = before  # timing launches do not count
    for row, _ in cases:
        _shares(row)
        print(f"[swa times] {tuple(row['shape'])} W={row['window']} "
              f"{row['dtype']} ({row['path']}): per call (events) kernel "
              f"{row['ms']:.4f} / plain {row['plain_ms']:.4f} / sdpa "
              f"{row['library_ms']:.4f} ms; on the device kernel "
              f"{row['device_ms']:.4f} / plain "
              f"{row['plain_device_ms']:.4f} / sdpa "
              f"{row['library_device_ms']:.4f} ms; {_share_text(row)}; "
              f"sdpa vs plain {row['library_max_abs_err']:.2e}")
    return [row for row, _ in cases]


def _shares(row: dict) -> None:
    """The roofline share against the path's bound (at most 1), the
    share of the fp32 CUDA-core bound beside it, and the rate."""
    row["roofline_share"] = row["bound_ms"] / row["device_ms"]
    fma = row["bound_fp32_fma_ms"]
    row["fp32_fma_share"] = None if fma is None else fma / row["device_ms"]
    row["tflop_per_s"] = row["flops"] / row["device_ms"] / 1e9


def _share_text(row: dict) -> str:
    text = (f"bound {row['bound_ms']:.4f} ms ({row['path']}, "
            f"{row['bound_by']}): {row['roofline_share']:.1%} of it")
    if row["bound_fp32_fma_ms"] is not None:
        text += (f"; fp32 CUDA-core bound {row['bound_fp32_fma_ms']:.4f} "
                 f"ms: {row['fp32_fma_share']:.1%} of it")
    return text + f"; {row['tflop_per_s']:.2f} TFLOP/s"


# ----------------------------------------------------------------------
# fused_ce and the LM train slice
# ----------------------------------------------------------------------

def _ce_inputs(torch, gen, t, d, v, dtype):
    """x ~ N(0, 1), table ~ 2·N(0, 1)/√D (logits of spread ~2 at every
    width), int64 labels with 0, V − 1 and the 64-entry tile edges
    first."""
    x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    table = (torch.randn((v, d), generator=gen, device="cuda")
             * (2.0 / math.sqrt(d))).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda")
    edges = [c for c in (0, v - 1, 63, 64, 65, 127, 128, v // 2) if c < v]
    labels[:len(edges)] = torch.tensor(edges[:t], device="cuda")
    return x, table, labels


def _ce_check(torch, ce_ops, ce_ref, x, table, labels, name: str) -> float:
    got = ce_ops.fused_ce_nll(x, table, labels)
    again = ce_ops.fused_ce_nll(x, table, labels)
    want = ce_ref.fused_ce_ref(x, table, labels)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: repeated launch differs")
    if got.dtype != torch.float32 or got.shape != labels.shape:
        raise AssertionError(f"{name}: output {got.dtype} "
                             f"{tuple(got.shape)}")
    err = (got - want).abs()
    if not bool((err <= CE_TOL + CE_TOL * want.abs()).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max err {err.max().item():.3e})")
    return err.max().item()


def phase_ce_kernel(torch, ce_ops, ce_ref) -> list:
    """``fused_ce`` against its plain version on the card at every
    (T, D, V) of CE_T × CE_D × CE_V in fp32 and bf16; then a strided x,
    the Function's gradients and both vmap cases."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    results = []
    for t, d, v in CE_EDGE:
        for dtype in (torch.float32, torch.bfloat16):
            x, table, labels = _ce_inputs(torch, gen, t, d, v, dtype)
            dt = _dtype_name(dtype)
            err = _ce_check(torch, ce_ops, ce_ref, x, table, labels,
                            f"fused_ce ({t}, {d}, {v}) {dt}")
            results.append({"shape": [t, d, v], "dtype": dt,
                            "max_abs_err": err, "tol": CE_TOL,
                            "bitwise_repeat": True})
    print(f"[ce] tile edges {CE_EDGE}, fp32 and bf16: vs plain max "
          f"{max(r['max_abs_err'] for r in results):.3e} within {CE_TOL} + "
          f"{CE_TOL}·|plain|; repeats bitwise equal")
    for family, (t, d, v) in CE_TRAIN_LOSSES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, table, labels = _ce_inputs(torch, gen, t, d, v, dtype)
            dt = _dtype_name(dtype)
            err = _ce_check(torch, ce_ops, ce_ref, x, table, labels,
                            f"fused_ce ({t}, {d}, {v}) {dt}")
            results.append({"shape": [t, d, v], "dtype": dt,
                            "max_abs_err": err, "tol": CE_TOL,
                            "bitwise_repeat": True})
            del x, table, labels
        print(f"[ce] the {family} train loss's "
              f"({t}, {d}, {v}), fp32 and bf16: vs plain max "
              f"{max(r['max_abs_err'] for r in results[-2:]):.3e} within "
              f"{CE_TOL} + {CE_TOL}·|plain|; repeats bitwise equal")
    for t in CE_T:
        for d in CE_D:
            for v in CE_V:
                for dtype in (torch.float32, torch.bfloat16):
                    x, table, labels = _ce_inputs(torch, gen, t, d, v, dtype)
                    dt = _dtype_name(dtype)
                    err = _ce_check(torch, ce_ops, ce_ref, x, table, labels,
                                    f"fused_ce ({t}, {d}, {v}) {dt}")
                    results.append({"shape": [t, d, v], "dtype": dt,
                                    "max_abs_err": err, "tol": CE_TOL,
                                    "bitwise_repeat": True})
                    del x, table, labels
            print(f"[ce] T={t} D={d}: V ∈ {CE_V}, fp32 and bf16: vs plain "
                  f"max {max(r['max_abs_err'] for r in results[-10:]):.3e} "
                  f"within {CE_TOL} + {CE_TOL}·|plain|; repeats bitwise "
                  f"equal")
    torch.cuda.empty_cache()
    # a strided x (rows of a wider buffer, one element in) reads the same
    for dtype in (torch.float32, torch.bfloat16):
        x, table, labels = _ce_inputs(torch, gen, 1000, 576, 50257, dtype)
        wide = torch.zeros((1000, 600), dtype=dtype, device="cuda")
        wide[:, 1:577] = x
        strided = wide[:, 1:577]
        assert not strided.is_contiguous()
        a = ce_ops.fused_ce_nll(strided, table, labels)
        b = ce_ops.fused_ce_nll(x, table, labels)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"fused_ce: a strided {dtype} x differs "
                                 "from its contiguous copy")
    print("[ce] strided x (row stride 600, offset 1), fp32 and bf16: equal "
          "to the contiguous x's result")
    results.append(_ce_grad(torch, ce_ops, ce_ref, gen))
    results.append(_ce_mesh_block(torch, ce_ops, ce_ref, gen))
    results.append(_ce_vmap(torch, ce_ops, gen))
    return results


def _ce_grad(torch, ce_ops, ce_ref, gen) -> dict:
    t, d, v = CE_GRAD_SHAPE
    x, table, _ = _ce_inputs(torch, gen, t, d, v, torch.float32)
    labels = torch.randint(0, v, (t,), generator=gen, device="cuda")
    w = torch.rand((t,), generator=gen, device="cuda")
    before = ce_ops.fused_ce.launches
    leaves = [x.clone().requires_grad_(True), table.clone().requires_grad_(True)]
    got = torch.autograd.grad((ce_ops.fused_ce_nll(*leaves, labels) * w).sum(),
                              leaves)
    plain = [x.clone().requires_grad_(True), table.clone().requires_grad_(True)]
    want = torch.autograd.grad((ce_ref.fused_ce_ref(*plain, labels) * w).sum(),
                               plain)
    ce_ops.fused_ce.launches = before  # check launches do not count
    errs = []
    for name, g, p in zip(("dx", "dtable"), got, want):
        err, scale = (g - p).abs().max().item(), p.abs().max().item()
        if not err <= CE_GRAD_TOL * scale:
            raise AssertionError(f"fused_ce {name}: {err:.3e} vs autograd "
                                 f"of the plain version (scale {scale:.3e})")
        errs.append(err / scale)
    print(f"[ce] gradients at {CE_GRAD_SHAPE}: dx, dtable within "
          f"{max(errs):.2e}·max|g| of autograd through the plain version "
          f"(tol {CE_GRAD_TOL})")
    return {"grad_shape": list(CE_GRAD_SHAPE),
            "grad_max_err_over_scale": max(errs), "grad_tol": CE_GRAD_TOL}


def _ce_mesh_block(torch, ce_ops, ce_ref, gen) -> dict:
    """The launch a [mesh] rank makes for its half of llama3.2-3b's
    vocabulary (``vocab_parallel_nll``): both outputs of
    ``fused_ce_nll_lse`` on the second block, labels drawn over the whole
    vocabulary and those outside the block pointed at row 0, against the
    plain (nll, logsumexp); then the backward with nonzero cotangents of
    both outputs against autograd through the plain version.  The
    backward reads the kernel's lse, so each softmax entry P_tv it forms
    carries a relative error up to e^δ_t − 1 (δ_t the measured lse gap
    of token t); the gradients are held within CE_GRAD_TOL·max|g| plus
    what that propagates to: |Δdx_t| ≤ (e^δ_t − 1)·|c_t|·max|table| and
    |Δdtable_v| ≤ Σ_t (e^δ_t − 1)·|c_t|·max|x_t|·P_tv, with c_t the
    token's cotangent on P (dnll_t + dlse_t)."""
    t, d, v = CE_TIMED[4]
    x, table, _ = _ce_inputs(torch, gen, t, d, v, torch.float32)
    labels = torch.randint(0, 2 * v, (t,), generator=gen, device="cuda")
    rel = labels - v
    inside = (rel >= 0) & (rel < v)
    rows = torch.where(inside, rel, torch.zeros_like(rel))
    before = ce_ops.fused_ce.launches
    nll, lse = ce_ops.fused_ce_nll_lse(x, table, rows)
    want_nll, want_lse = ce_ref.fused_ce_lse_ref(x, table, rows)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("nll", nll, want_nll), ("lse", lse, want_lse)):
        err = (got - want).abs()
        if got.shape != (t,) or not bool(
                (err <= CE_TOL + CE_TOL * want.abs()).all()):
            raise AssertionError(
                f"fused_ce_nll_lse {name} at the [mesh] block ({t}, {d}, "
                f"{v}): {tuple(got.shape)}, max err {err.max().item():.3e}")
        errs[name] = err.max().item()
    w = torch.rand((t,), generator=gen, device="cuda")
    u = torch.rand((t,), generator=gen, device="cuda") - 0.5
    leaves = [x.clone().requires_grad_(True), table.clone().requires_grad_(True)]
    n, l = ce_ops.fused_ce_nll_lse(*leaves, rows)
    got = torch.autograd.grad((n * w + l * u).sum(), leaves)
    plain = [x.clone().requires_grad_(True), table.clone().requires_grad_(True)]
    n, l = ce_ref.fused_ce_lse_ref(*plain, rows)
    want = torch.autograd.grad((n * w + l * u).sum(), plain)
    ce_ops.fused_ce.launches = before  # check launches do not count
    k = torch.expm1((lse - want_lse).abs()) * (w + u).abs()
    probs = torch.softmax(x @ table.T, -1)
    carried = {"dx": (k.max() * table.abs().max()).item(),
               "dtable": ((k * x.abs().amax(1)) @ probs).max().item()}
    del probs
    for name, g, p in zip(("dx", "dtable"), got, want):
        err, scale = (g - p).abs().max().item(), p.abs().max().item()
        if not err <= CE_GRAD_TOL * scale + carried[name]:
            raise AssertionError(
                f"fused_ce_nll_lse {name} with a logsumexp cotangent: "
                f"{err:.3e} vs autograd of the plain version (scale "
                f"{scale:.3e}, the lse gap carries {carried[name]:.3e})")
        errs[name + "_over_scale"] = err / scale
        errs[name + "_lse_carried"] = carried[name]
    print(f"[ce] the [mesh] block ({t}, {d}, {v}), {int(inside.sum())} of "
          f"{t} labels inside it, the rest at row 0: nll max "
          f"{errs['nll']:.3e}, lse max {errs['lse']:.3e} vs the plain "
          f"(nll, logsumexp) within {CE_TOL} + {CE_TOL}·|plain|; backward "
          f"with nonzero dnll and dlse: dx, dtable "
          f"{errs['dx_over_scale']:.2e}, {errs['dtable_over_scale']:.2e}·"
          f"max|g| from autograd (tol {CE_GRAD_TOL}·max|g| plus the lse "
          f"gap's {errs['dx_lse_carried']:.2e}, "
          f"{errs['dtable_lse_carried']:.2e})")
    return {"mesh_block": {"shape": [t, d, v], "max_abs_err": errs,
                           "tol": CE_TOL, "grad_tol": CE_GRAD_TOL}}


def _ce_vmap(torch, ce_ops, gen) -> dict:
    """The train path's two mapped calls at its shape (4 agents of 2048
    tokens, D 576, V 49152): one launch each, matching a loop of
    per-agent launches (whose vocab split, and so order of summation,
    differs: within CE_TOL, not bitwise)."""
    a, t, d, v = TRAIN["agents"], 2048, 576, 49152
    xs = torch.randn((a, t, d), generator=gen, device="cuda")
    tables = torch.randn((a, v, d), generator=gen, device="cuda") / 12.0
    labels = torch.randint(0, v, (a, t), generator=gen, device="cuda")
    before = ce_ops.fused_ce.launches
    out = {}
    for case, dims, tbl in (("shared table", (0, None, 0), tables[0]),
                            ("per-agent tables", (0, 0, 0), tables)):
        ce_ops.fused_ce.launches = 0
        mapped = torch.func.vmap(ce_ops.fused_ce_nll, in_dims=dims)(
            xs, tbl, labels)
        torch.cuda.synchronize()
        n = ce_ops.fused_ce.launches
        looped = torch.stack([ce_ops.fused_ce_nll(
            xs[i], tbl if dims[1] is None else tbl[i], labels[i])
            for i in range(a)])
        err = (mapped - looped).abs()
        if n != 1 or not bool((err <= CE_TOL + CE_TOL * looped.abs()).all()):
            raise AssertionError(f"fused_ce under vmap ({case}): {n} "
                                 f"launches, max err vs a loop "
                                 f"{err.max().item():.3e}")
        out[case] = {"launches": n, "max_abs_err_vs_loop": err.max().item()}
        print(f"[ce] vmap over {a} agents, {case}: {n} launch, vs a loop of "
              f"{a} launches max {err.max().item():.3e}")
    ce_ops.fused_ce.launches = before
    return {"vmap": out}


def _train_parts(cfg, agents: int, batch: int, seq: int, device,
                 comm: str = TRAIN["comm"], **knobs):
    """What the training CLI builds: the plan, its step, the model and
    its optimizer (``repro_torch.launch.train.main``'s calls); ``knobs``
    are ``plan_run``'s memory knobs (``remat``, ``attn_q_block``,
    ``microbatches``)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S
    from repro_torch.models import build
    from repro_torch.optim import optimizers as opt_lib

    shape = InputShape("train_smoke", seq_len=seq, global_batch=batch,
                       kind="train")
    plan = S.plan_run(cfg, shape, num_agents=agents, comm=comm,
                      optimizer="sgd", lr=TRAIN["lr"], **knobs)
    step = S.build_train_step(plan, compute_dtype="float32", device=device)
    return (plan, shape, step, build(plan.cfg),
            opt_lib.from_config(plan.train_cfg))


def phase_train(torch, ce_ops, swa_ops, cfg, dev) -> tuple:
    """The LM train slice of ``cfg`` on ``dev`` (the card).  Returns
    (record, what the profile phase needs)."""
    from repro_torch.core.api import init_train_state
    from repro_torch.data.synthetic import batch_iterator
    from repro_torch.utils.tree import tree_size

    agents, gbatch, seq = TRAIN["agents"], TRAIN["batch"], TRAIN["seq"]
    plan, shape, step, model, opt = _train_parts(cfg, agents, gbatch, seq,
                                                 dev)
    steps = TRAIN["warmup"] + TRAIN["timed"]
    t0 = time.perf_counter()
    stream = batch_iterator(cfg, shape, num_agents=agents, seed=0, device=dev)
    batches = [next(stream) for _ in range(steps + 1)]  # +1: the profile
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    del stream  # frees the stream's 9.7 GB bigram table
    torch.cuda.empty_cache()
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(params, opt, plan.train_cfg, device=dev)
    del params
    torch.cuda.reset_peak_memory_stats()
    layers = cfg.num_layers
    print(f"[train] {cfg.name}: {layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {tree_size(state.params) / 1e6:.1f}M "
          f"parameters (fp32, seed 0); {agents} agents × "
          f"{gbatch // agents} × {seq} tokens, comm={TRAIN['comm']!r}, sgd "
          f"lr {TRAIN['lr']}; {steps + 1} batches drawn in {draw_s:.1f} s")

    ce_ops.fused_ce.launches = 0
    swa_ops.swa_attention.launches = 0
    rows = []
    for k in range(steps):
        ce0, swa0 = ce_ops.fused_ce.launches, swa_ops.swa_attention.launches
        t0 = time.perf_counter()
        state, m = step(state, batches[k])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows.append({"step": k, "ms": dt * 1e3, "loss": float(m["loss"]),
                     "mean_gain": float(m["mean_gain"]),
                     "num_tx": float(m["num_tx"]),
                     "grad_norm": float(m["grad_norm"]),
                     "fused_ce": ce_ops.fused_ce.launches - ce0,
                     "swa_attention": swa_ops.swa_attention.launches - swa0})
    launches = {"fused_ce": ce_ops.fused_ce.launches,
                "swa_attention": swa_ops.swa_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not peak_gb <= TRAIN_PEAK_GB * (1 + TRAIN_PEAK_SLACK):
        raise AssertionError(
            f"train peak memory {peak_gb:.2f} GB exceeds the earlier "
            f"{TRAIN_PEAK_GB} GB by more than {TRAIN_PEAK_SLACK:.0%}")
    for r in rows:
        if r["fused_ce"] != 2 or r["swa_attention"] != 2 * layers:
            raise AssertionError(
                f"train step {r['step']}: fused_ce launched {r['fused_ce']} "
                f"times (want 2: the agents' losses, the lookahead probe), "
                f"swa_attention {r['swa_attention']} (want {2 * layers})")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    # the first batch's loss, before (step 0's metric) and after the run
    after = torch.func.vmap(model.loss_fn, in_dims=(None, 0))(
        state.params, batches[0])
    loss_after = float(after.mean())
    ce_ops.fused_ce.launches, swa_ops.swa_attention.launches = (
        launches["fused_ce"], launches["swa_attention"])
    if not loss_after < losses[0]:
        raise AssertionError(f"train loss did not fall: first batch "
                             f"{losses[0]:.5f} before, {loss_after:.5f} "
                             f"after {steps} steps")
    timed = [r["ms"] for r in rows[TRAIN["warmup"]:]]
    mean_ms = statistics.mean(timed)
    tokens_per_s = gbatch * seq / (mean_ms / 1e3)
    for r in rows:
        print(f"[train] step {r['step']:2d}: {r['ms']:8.2f} ms  loss "
              f"{r['loss']:.5f}  num_tx {r['num_tx']:.0f}/{agents}  |g| "
              f"{r['grad_norm']:.4f}  launches fused_ce {r['fused_ce']}, "
              f"swa_attention {r['swa_attention']}")
    print(f"[train] {TRAIN['timed']} timed steps: {mean_ms:.2f} ms per step "
          f"(median {statistics.median(timed):.2f}), {tokens_per_s:.0f} "
          f"tokens/s; first batch's loss {losses[0]:.5f} -> "
          f"{loss_after:.5f} after {steps} steps; peak memory "
          f"{peak_gb:.2f} GB; launches fused_ce {launches['fused_ce']}, "
          f"swa_attention {launches['swa_attention']} in {steps} steps")
    record = {"arch": cfg.name, "agents": agents, "global_batch": gbatch,
              "seq": seq, "comm": TRAIN["comm"], "lr": TRAIN["lr"],
              "steps": rows, "ms_per_step": mean_ms,
              "ms_per_step_median": statistics.median(timed),
              "tokens_per_s": tokens_per_s, "launches": launches,
              "loss_first_batch_before": losses[0],
              "loss_first_batch_after": loss_after,
              "peak_memory_gb": peak_gb, "batch_draw_s": draw_s}
    check_batch = {k: v[:TRAIN_CHECK["agents"], :TRAIN_CHECK["per_agent"],
                         :TRAIN_CHECK["seq"]].contiguous()
                   for k, v in batches[0].items()}
    record["card_vs_cpu"] = _train_card_vs_cpu(torch, cfg, check_batch, dev)
    return record, (step, state, batches, mean_ms)


def phase_train_quadratic(torch, ce_ops, swa_ops, cfg, dev, batches) -> dict:
    """The LM train slice gated by ``gain_quadratic``: each agent's gain
    −ε‖g‖² + ½ε²·gᵀHg from a Hessian-vector product, forward over
    reverse (``torch.func.jvp`` of ``torch.func.grad``) through both
    kernels' forward-mode rules and first-order backwards, on the
    [train] phase's batches."""
    from repro_torch.core.api import init_train_state

    run = TRAIN_QUAD
    agents, gbatch, seq = run["agents"], run["batch"], run["seq"]
    plan, _, step, model, opt = _train_parts(cfg, agents, gbatch, seq, dev,
                                             comm=run["comm"])
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(params, opt, plan.train_cfg, device=dev)
    del params
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    layers = cfg.num_layers
    steps = run["warmup"] + run["timed"]
    ce_ops.fused_ce.launches = 0
    swa_ops.swa_attention.launches = 0
    rows = []
    for k in range(steps):
        ce0, swa0 = ce_ops.fused_ce.launches, swa_ops.swa_attention.launches
        t0 = time.perf_counter()
        state, m = step(state, batches[k])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows.append({"step": k, "ms": dt * 1e3, "loss": float(m["loss"]),
                     "mean_gain": float(m["mean_gain"]),
                     "num_tx": float(m["num_tx"]),
                     "grad_norm": float(m["grad_norm"]),
                     "fused_ce": ce_ops.fused_ce.launches - ce0,
                     "swa_attention": swa_ops.swa_attention.launches - swa0})
    launches = {"fused_ce": ce_ops.fused_ce.launches,
                "swa_attention": swa_ops.swa_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in rows:
        # one launch per call under vmap: the agents' losses and the
        # HVP's forward (its tangents by the jvp rules, no launch)
        if r["fused_ce"] != 2 or r["swa_attention"] != 2 * layers:
            raise AssertionError(
                f"train quadratic step {r['step']}: fused_ce launched "
                f"{r['fused_ce']} times (want 2: the agents' losses, the "
                f"HVP's forward), swa_attention {r['swa_attention']} (want "
                f"{2 * layers})")
        if not (math.isfinite(r["mean_gain"]) and math.isfinite(r["loss"])):
            raise AssertionError(f"train quadratic step {r['step']}: "
                                 f"non-finite gain or loss: {r}")
    timed = [r["ms"] for r in rows[run["warmup"]:]]
    mean_ms = statistics.mean(timed)
    for r in rows:
        print(f"[train quadratic] step {r['step']}: {r['ms']:8.2f} ms  loss "
              f"{r['loss']:.5f}  mean gain {r['mean_gain']:.6e}  num_tx "
              f"{r['num_tx']:.0f}/{agents}  |g| {r['grad_norm']:.4f}  "
              f"launches fused_ce {r['fused_ce']}, swa_attention "
              f"{r['swa_attention']}")
    print(f"[train quadratic] {cfg.name}, {agents} agents × "
          f"{gbatch // agents} × {seq} tokens, comm={run['comm']!r}: "
          f"{run['timed']} timed steps {mean_ms:.2f} ms per step "
          f"({gbatch * seq / (mean_ms / 1e3):.0f} tokens/s); peak memory "
          f"{peak_gb:.2f} GB (with {base_gb:.2f} GB allocated before the "
          f"phase: {peak_gb - base_gb:.2f} GB above it)")
    record = {"arch": cfg.name, "agents": agents, "global_batch": gbatch,
              "seq": seq, "comm": run["comm"], "lr": run["lr"],
              "steps": rows, "ms_per_step": mean_ms,
              "tokens_per_s": gbatch * seq / (mean_ms / 1e3),
              "launches": launches, "peak_memory_gb": peak_gb,
              "allocated_before_gb": base_gb}
    del state
    torch.cuda.empty_cache()
    check_batch = {k: v[:TRAIN_CHECK["agents"], :TRAIN_CHECK["per_agent"],
                         :TRAIN_CHECK["seq"]].contiguous()
                   for k, v in batches[0].items()}
    record["card_vs_cpu"] = _train_card_vs_cpu(
        torch, cfg, check_batch, dev, comm=run["comm"], gains=True)
    return record


def _knob_step(torch, ce_ops, swa_ops, cfg, dev, params, batch, comm: str,
               **knobs) -> dict:
    """One TRAIN step of ``cfg`` with ``plan_run``'s ``knobs`` from a
    fresh state on ``params`` (EF memory 0): a warm-up call (which also
    fills the allocator's cache), then KNOB_TIMED calls from the same
    state, their launches counted from 0 (per call) and their peak
    memory from a reset.  Returns the mean ms, the peak, the launches
    per call, the metrics and new parameters (``{path: tensor}``)."""
    from repro_torch.core.api import init_train_state
    from repro_torch.utils.tree import tree_flatten_with_path

    plan, _, step, _, opt = _train_parts(cfg, TRAIN["agents"], TRAIN["batch"],
                                         TRAIN["seq"], dev, comm, **knobs)
    state = init_train_state(params, opt, plan.train_cfg, device=dev)
    step(state, batch)  # warm-up, result dropped: new shapes, cached blocks
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    times, per_call = [], []
    for _ in range(KNOB_TIMED):
        new = m = None  # the last call's state is not held during this one
        ce_ops.fused_ce.launches = swa_ops.swa_attention.launches = 0
        t0 = time.perf_counter()
        new, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_call.append({"fused_ce": ce_ops.fused_ce.launches,
                         "swa_attention": swa_ops.swa_attention.launches})
    if any(c != per_call[0] for c in per_call):
        raise AssertionError(f"{knobs}: launches differ between calls "
                             f"{per_call}")
    launches = per_call[0]
    ms = statistics.mean(times)
    out = {"knobs": knobs, "comm": comm, "ms": ms, "ms_calls": times,
           "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "allocated_before_gb": base_gb,
           "metrics": {k: v.cpu() for k, v in m.items()},
           "params": dict(tree_flatten_with_path(new.params))}
    for k in ("loss", "mean_gain", "num_tx"):
        if not math.isfinite(float(out["metrics"][k])):
            raise AssertionError(f"{knobs}: non-finite {k} {out['metrics']}")
    return out


def _agent_grads(torch, model, params, batch) -> dict:
    """Each agent's gradient ``{path: (agents, *shape)}``: where the int8
    wire may round two steps one level apart."""
    from repro_torch.comm.bank import batch_prologue
    from repro_torch.utils.tree import tree_flatten_with_path

    _, grads = batch_prologue(model.loss_fn)(params, batch)
    return dict(tree_flatten_with_path(grads))


def _hold_variant(torch, label: str, got: dict, want: dict,
                  grads) -> dict:
    """``got`` (a :func:`_knob_step`) against ``want`` from the same
    state and batch: the decisions equal, the loss and the gain within
    TRAIN_TOL, the parameters bitwise or else each leaf within
    TRAIN_TOL of its largest value but at an int8 rounding midpoint, a
    level apart (``grads()``: the agents' gradients that find those)."""
    mg, mw = got["metrics"], want["metrics"]
    if not torch.equal(mg["num_tx"], mw["num_tx"]):
        raise AssertionError(f"{label}: num_tx {mg['num_tx']} vs "
                             f"{mw['num_tx']}")
    gaps = {}
    for key in ("loss", "mean_gain", "grad_norm"):
        gaps[key] = (abs(float(mg[key]) - float(mw[key]))
                     / abs(float(mw[key])))
        if not gaps[key] <= TRAIN_TOL:
            raise AssertionError(f"{label}: {key} {float(mg[key])} vs "
                                 f"{float(mw[key])}")
    equal = all(torch.equal(got["params"][p], w)
                for p, w in want["params"].items())
    worst, tied = 0.0, 0
    if not equal:
        worst, tied, _ = _params_within(
            torch, got["params"], want["params"], grads(),
            TRAIN["agents"], label)
    return {"params_bitwise_equal": equal,
            "params_max_gap_over_leaf_max": worst,
            "int8_midpoint_elements_one_level_apart": tied,
            "rel_gaps": gaps}


def _variant_text(v: dict) -> str:
    return (f"{v['ms']:.2f} ms, peak {v['peak_memory_gb']:.2f} GB "
            f"({v['allocated_before_gb']:.2f} GB before), launches "
            f"fused_ce {v['launches']['fused_ce']}, swa_attention "
            f"{v['launches']['swa_attention']}")


def _match_text(h: dict) -> str:
    if h["params_bitwise_equal"]:
        return "params bitwise equal"
    return (f"params NOT bitwise: within "
            f"{h['params_max_gap_over_leaf_max']:.2e} of each leaf's max "
            f"(tol {TRAIN_TOL}) apart from "
            f"{h['int8_midpoint_elements_one_level_apart']} elements at an "
            f"int8 rounding midpoint, a level apart")


def phase_remat(torch, ce_ops, swa_ops, cfg, dev, batch) -> tuple:
    """``remat`` on the LM train slice: smollm-135m at full width and
    depth, TRAIN's settings, one step with ``remat=False`` and one with
    ``remat=True`` from the same state and batch, under
    ``gain_lookahead`` and then ``gain_quadratic`` (the HVP through the
    checkpointed blocks).  Each causal self-attention runs once more per
    step under remat (REMAT_SWA_PER_LAYER); the parameters after the step
    are bitwise equal (the recompute runs the forward's products on the
    same shapes, and its backward the plain step's formulas).  Returns
    (record, the plain lookahead step for [microbatch])."""
    from repro_torch.models import build

    model = build(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    layers = cfg.num_layers
    record, base = {}, None
    for trig, comm in (("lookahead", TRAIN["comm"]),
                       ("quadratic", TRAIN_QUAD["comm"])):
        runs = {}
        for remat in (False, True):
            v = _knob_step(torch, ce_ops, swa_ops, cfg, dev, params, batch,
                           comm, remat=remat)
            want = REMAT_SWA_PER_LAYER[trig, remat] * layers
            if v["launches"] != {"fused_ce": 2, "swa_attention": want}:
                raise AssertionError(
                    f"[remat] {trig} remat={remat}: launches {v['launches']}"
                    f", want fused_ce 2 and swa_attention {want}")
            runs[remat] = v
        # bitwise expected: the recompute runs the forward's products on
        # the same shapes, and its backward the plain step's formulas; a
        # gap would mean cuBLAS picked another algorithm for a product
        held = _hold_variant(
            torch, f"[remat] {trig}", runs[True], runs[False],
            lambda: _agent_grads(torch, model, params, batch))
        for remat in (False, True):
            print(f"[remat] {cfg.name} {layers} layers, {comm!r}, "
                  f"remat={remat}: {_variant_text(runs[remat])}")
        m = runs[True]["metrics"]
        print(f"[remat] {trig}: remat against plain from one state: "
              f"{_match_text(held)}; num_tx {float(m['num_tx']):.0f}/"
              f"{TRAIN['agents']} equal, loss {float(m['loss']):.6f} (rel gap "
              f"{held['rel_gaps']['loss']:.2e}), mean gain "
              f"{float(m['mean_gain']):.6e} (rel gap "
              f"{held['rel_gaps']['mean_gain']:.2e}); peak "
              f"{runs[False]['peak_memory_gb']:.2f} -> "
              f"{runs[True]['peak_memory_gb']:.2f} GB, "
              f"{runs[False]['ms']:.2f} -> {runs[True]['ms']:.2f} ms a step")
        if trig == "lookahead":
            base = runs[False]
        record[trig] = {
            "check": held, **{f"remat_{r}": {k: v for k, v in runs[r].items()
                                             if k not in ("params",
                                                          "metrics")}
                              for r in (False, True)},
            "metrics": {str(r): {k: float(v) for k, v in
                                 runs[r]["metrics"].items()}
                        for r in (False, True)}}
        del runs
        torch.cuda.empty_cache()
    return record, (model, params, base)


def phase_microbatch(torch, ce_ops, swa_ops, cfg, dev, batch, base) -> dict:
    """``microbatches=2`` on the [remat] phase's lookahead step (each
    agent's 2 sequences in 2 slices), alone and with ``remat``, against
    the plain step from the same state: the loss and the parameters
    within TRAIN_TOL (the slices' sums associate otherwise), the
    decisions equal, each kernel once per slice, and the peak memory.
    A loop under ``grad`` keeps every slice's graph, so microbatching
    alone is not expected to lower the peak much."""
    model, params, plain = base
    layers = cfg.num_layers
    grads = None

    def agent_grads():
        nonlocal grads
        if grads is None:
            grads = _agent_grads(torch, model, params, batch)
        return grads

    record = {"plain": {k: v for k, v in plain.items()
                        if k not in ("params", "metrics")}}
    for remat in (False, True):
        v = _knob_step(torch, ce_ops, swa_ops, cfg, dev, params, batch,
                       TRAIN["comm"], microbatches=2, remat=remat)
        want = {"fused_ce": 4, "swa_attention":
                2 * REMAT_SWA_PER_LAYER["lookahead", remat] * layers}
        if v["launches"] != want:
            raise AssertionError(f"[microbatch] remat={remat}: launches "
                                 f"{v['launches']}, want {want}")
        held = _hold_variant(torch, f"[microbatch] remat={remat}", v, plain,
                             agent_grads)
        m = v["metrics"]
        print(f"[microbatch] {cfg.name}, microbatches=2, remat={remat}: "
              f"{_variant_text(v)}; against the plain step (peak "
              f"{plain['peak_memory_gb']:.2f} GB, {plain['ms']:.2f} ms): "
              f"loss {float(m['loss']):.6f} (rel gap "
              f"{held['rel_gaps']['loss']:.2e}), num_tx "
              f"{float(m['num_tx']):.0f}/{TRAIN['agents']} equal, "
              f"{_match_text(held)}")
        record[f"microbatches_2_remat_{remat}"] = {
            "check": held, **{k: x for k, x in v.items()
                              if k not in ("params", "metrics")},
            "metrics": {k: float(x) for k, x in m.items()}}
        del v
    del grads
    torch.cuda.empty_cache()
    return record


def _count_diff(card, trace) -> dict:
    """The op names whose (count, flops, bytes) differ between two
    counters."""
    names = set(card.by_op) | set(trace.by_op)
    return {n: (card.by_op.get(n), trace.by_op.get(n)) for n in sorted(names)
            if card.by_op.get(n) != trace.by_op.get(n)}


def phase_dryrun(torch, ce_ops, swa_ops, cfg, dev, step, state, batch,
                 step_ms: float, card: str) -> dict:
    """The dry-run's counts against the card.  (a) [train]'s step, run
    once on the card under the cost counter, counts exactly the flops,
    HBM bytes and device ops of the ``meta`` trace of the same plan
    (``lower_for``; the batch in ``input_specs``' contiguous layout).
    (b) The step's counted TFLOP, ``model_flops``, [train]'s ms per
    step, the counted rate over the path's peak and the MFU
    (``model_flops / (ms × peak)``).  (c) The trace's memory estimate
    (its temporaries and outputs) within DRYRUN_MEMORY_TOL of the card's
    peak above what was allocated before the step.  (d) The prefill and
    serve steps (``build_prefill_step``, ``build_serve_step``) at B 4 ×
    1024 and one decode token, bitwise the direct ``forward`` and
    ``decode_step`` calls.  (e) ``dryrun.run_one`` for DRYRUN_PAIRS
    (traced on ``meta`` on the host), their terms printed."""
    from repro_torch.analysis.cost import CostCounter, summarize
    from repro_torch.analysis.roofline import PEAK_FLOPS, model_flops, step_path
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.models import build
    from repro_torch.utils.tree import tree_leaves, tree_map

    agents, gbatch, seq = TRAIN["agents"], TRAIN["batch"], TRAIN["seq"]
    plan, shape, *_ = _train_parts(cfg, agents, gbatch, seq, dev)
    t0 = time.perf_counter()
    lowered = S.lower_for(plan, compute_dtype="float32")
    trace, estimate = lowered.cost(), lowered.memory()
    trace_s = time.perf_counter() - t0
    del lowered

    batch = {k: v.contiguous() for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ce0, swa0 = ce_ops.fused_ce.launches, swa_ops.swa_attention.launches
    t0 = time.perf_counter()
    with CostCounter() as counted:
        new_state, metrics = step(state, batch)
        torch.cuda.synchronize()
    counted_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - before
    launches = {"fused_ce": ce_ops.fused_ce.launches - ce0,
                "swa_attention": swa_ops.swa_attention.launches - swa0}
    loss = float(metrics["loss"])
    del new_state, metrics
    torch.cuda.empty_cache()
    same = (counted.flops == trace.flops
            and counted.hbm_bytes == trace.hbm_bytes
            and counted.device_ops == trace.device_ops)
    if not same:
        raise AssertionError(
            f"[dryrun] the card counted {summarize(counted)}, the meta "
            f"trace {summarize(trace)}; by op: {_count_diff(counted, trace)}")
    for name, n in launches.items():
        if counted.by_op[f"kernel:{name}"].count != n:
            raise AssertionError(f"[dryrun] {name}: {n} launches, "
                                 f"{counted.by_op[f'kernel:{name}'].count} "
                                 f"counted")
    if not math.isfinite(loss):
        raise AssertionError(f"[dryrun] non-finite loss {loss}")

    path = step_path("float32")
    peak_flops = PEAK_FLOPS[path]
    useful = model_flops(plan.cfg, shape)
    rate_share = trace.flops / (step_ms / 1e3) / peak_flops
    mfu = useful / (step_ms / 1e3 * peak_flops)
    est_bytes = estimate["temp_bytes"] + estimate["output_bytes"]
    gap = est_bytes / peak - 1
    print(f"[dryrun] {cfg.name} [train]'s step ({agents} agents × "
          f"{gbatch // agents} × {seq}, {TRAIN['comm']}, fp32): the card's "
          f"count equals the meta trace's: {trace.flops / 1e12:.4f} TFLOP "
          f"({trace.dot_flops / 1e12:.4f} in products), "
          f"{trace.hbm_bytes / 1e9:.2f} GB of HBM traffic, "
          f"{trace.device_ops} device ops (fused_ce {launches['fused_ce']}, "
          f"swa_attention {launches['swa_attention']}); traced in "
          f"{trace_s:.1f} s, counted on the card in {counted_ms:.1f} ms")
    print(f"[dryrun] model_flops 6·N·D {useful / 1e12:.4f} TFLOP "
          f"(useful/counted {useful / trace.flops:.3f}); [train] "
          f"{step_ms:.2f} ms a step: counted rate "
          f"{trace.flops / (step_ms / 1e3) / 1e12:.2f} TFLOP/s = "
          f"{rate_share:.1%} of the {path} peak "
          f"({peak_flops / 1e12:g} TFLOP/s), MFU {mfu:.1%}; bound "
          f"t_compute {trace.flops / peak_flops * 1e3:.2f} ms, t_memory "
          f"{trace.hbm_bytes / 3.35e12 * 1e3:.2f} ms; on {card}")
    print(f"[dryrun] memory: estimate {est_bytes / 1e9:.3f} GB (temp "
          f"{estimate['temp_bytes'] / 1e9:.3f} + output "
          f"{estimate['output_bytes'] / 1e9:.3f}; arguments "
          f"{estimate['argument_bytes'] / 1e9:.3f}) vs the card's peak "
          f"{peak / 1e9:.3f} GB above the {before / 1e9:.3f} GB allocated "
          f"before: {gap:+.2%}")
    if abs(gap) > DRYRUN_MEMORY_TOL:
        raise AssertionError(f"[dryrun] memory estimate {est_bytes} bytes "
                             f"vs the card's {peak}: {gap:+.2%}")
    record = {"trace": summarize(trace), "dot_flops": trace.dot_flops,
              "counted": summarize(counted), "launches": launches,
              "trace_s": trace_s, "counted_ms": counted_ms,
              "model_flops": useful, "step_ms": step_ms, "path": path,
              "peak_flops": peak_flops, "counted_rate_share": rate_share,
              "mfu": mfu, "memory_estimate": estimate,
              "memory_peak_bytes": peak, "memory_before_bytes": before,
              "memory_gap": gap, "card": card,
              "top_hbm": [(n, r.count, r.hbm_bytes)
                          for n, r in trace.top(8)],
              "top_flops": [(n, r.count, r.flops)
                            for n, r in trace.top(8, "flops")]}
    print("[dryrun] top HBM contributors: " + ", ".join(
        f"{n} ×{c} {b / 1e9:.1f} GB" for n, c, b in record["top_hbm"]))

    # (d) the serving steps
    b, s = DRYRUN_SERVE["batch"], DRYRUN_SERVE["seq"]
    model = build(cfg.replace(compute_dtype="float32"))
    pplan = S.plan_run(cfg, InputShape("prefill_smoke", s, b, "prefill"))
    pstep, params, pbatch = S.build_prefill_step(
        pplan, compute_dtype="float32", device=dev)
    swa0 = swa_ops.swa_attention.launches
    logits = pstep(params, pbatch)
    prefill_launches = swa_ops.swa_attention.launches - swa0
    want, _ = model.forward(params, pbatch)
    if not torch.equal(logits, want):
        raise AssertionError("[dryrun] the prefill step differs from "
                             "model.forward")
    if prefill_launches != cfg.num_layers:
        raise AssertionError(f"[dryrun] prefill step: {prefill_launches} "
                             f"swa_attention launches, want "
                             f"{cfg.num_layers}")
    del logits, want, params, pbatch
    dplan = S.plan_run(cfg, InputShape("decode_smoke", s, b, "decode"))
    sstep, params, (cache, tokens, pos) = S.build_serve_step(
        dplan, compute_dtype="float32", device=dev)
    direct = tree_map(torch.clone, cache)
    got, cache = sstep(params, cache, tokens, pos)
    want, direct = model.decode_step(params, direct, tokens, int(pos))
    if not (torch.equal(got, want) and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(cache),
                                               tree_leaves(direct)))):
        raise AssertionError("[dryrun] the serve step differs from "
                             "decode_step")
    print(f"[dryrun] prefill step (B {b} × {s}) bitwise model.forward "
          f"({prefill_launches} swa_attention); serve step (one token at "
          f"position {int(pos)} against a {s}-slot cache) bitwise "
          f"decode_step, logits and cache")
    record["serving"] = {"prefill_launches": prefill_launches,
                         "bitwise": True}
    del got, want, cache, direct, params, tokens
    torch.cuda.empty_cache()

    # (e) the dry-run's own records
    out_dir = REPO / "chiprun_out" / "dryrun_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    record["pairs"] = {}
    for arch, shape_name in DRYRUN_PAIRS:
        rec = dryrun.run_one(arch, shape_name, False, out_dir)
        if rec["status"] != "ok":
            raise AssertionError(f"[dryrun] {arch} {shape_name}: {rec}")
        r, m = rec["roofline"], rec["memory_analysis"]
        print(f"[dryrun] {rec['name']}: {rec['cost']['flops'] / 1e12:.1f} "
              f"TFLOP, {rec['cost']['hbm_bytes'] / 1e12:.2f} TB, "
              f"{rec['cost']['device_ops']} ops; t_compute "
              f"{r['t_compute_s']:.4f} s, t_memory {r['t_memory_s']:.4f} s "
              f"-> {r['bottleneck']}; useful {r['useful_flop_ratio']:.3f}, "
              f"MFU bound {r['mfu_bound']:.4f}; memory "
              f"{m['total_bytes'] / 1e9:.1f} GB; traced in "
              f"{rec['trace_seconds']} s")
        record["pairs"][rec["name"]] = {k: rec[k] for k in (
            "cost", "memory_analysis", "roofline", "trace_seconds")}
    return record


def phase_train_resume(torch, ce_ops, swa_ops) -> dict:
    """The train CLI's resume on the card: smollm-135m at full width cut
    to TRAIN_RESUME["layers"] layers, m = 4, ``--ckpt-every 2``.  An
    unbroken 4-step run writes its step-2 and step-4 checkpoints; a
    relaunch with ``--resume`` over a directory holding only the step-2
    checkpoint (what a run killed after it leaves) must end bit for bit
    where the unbroken run ends, launching each kernel as often per step
    as the unbroken run."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch import train as train_cli

    t = TRAIN_RESUME
    root = REPO / "build" / "train_resume"
    _fresh_dir(root)
    unbroken, resumed = root / "unbroken", root / "resumed"
    args = ["--arch", LM_ARCH, "--layers", str(t["layers"]), "--agents",
            str(t["agents"]), "--batch", str(t["batch"]), "--seq",
            str(t["seq"]), "--lr", str(t["lr"]), "--comm", t["comm"],
            "--steps", str(t["steps"]), "--ckpt-every", str(t["every"]),
            "--log-every", str(t["steps"]), "--device", "cuda"]

    def run(extra):
        ce_ops.fused_ce.launches = swa_ops.swa_attention.launches = 0
        t0 = time.perf_counter()
        train_cli.main(args + extra)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the stream's 9.7 GB bigram table
        return (time.perf_counter() - t0,
                {"fused_ce": ce_ops.fused_ce.launches,
                 "swa_attention": swa_ops.swa_attention.launches})

    # the host ms of each checkpoint write and of the restore, timed
    # around the CLI's own calls
    ckpt_ms = {"save": [], "restore": []}
    calls = {name: getattr(checkpointer, name) for name in ckpt_ms}

    def timed(name):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = calls[name](*a, **k)
            torch.cuda.synchronize()
            ckpt_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    for name in ckpt_ms:
        setattr(checkpointer, name, timed(name))
    try:
        unbroken_s, unbroken_n = run(["--ckpt-dir", str(unbroken)])
        kept = f"step_{t['every']:08d}"
        resumed.mkdir()
        shutil.copytree(unbroken / kept, resumed / kept)
        resumed_s, resumed_n = run(["--ckpt-dir", str(resumed),
                                    "--resume"])
        final = f"step_{t['steps']:08d}"
        a = np.load(unbroken / final / "arrays.npz")
        b = np.load(resumed / final / "arrays.npz")
        with a, b:
            leaves = len(a.files)
            unequal = [f for f in a.files if not (
                a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]))]
            unequal += sorted(set(b.files) - set(a.files))
        nbytes = sum(f.stat().st_size for f in (unbroken / final).iterdir())
    finally:
        for name, fn in calls.items():
            setattr(checkpointer, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    if unequal:
        raise AssertionError(f"train resume: {len(unequal)} of {leaves} "
                             f"leaves differ from the unbroken run's: "
                             f"{unequal[:5]}")
    ratio = t["steps"] // (t["steps"] - t["every"])
    want = {"fused_ce": 2 * t["steps"],
            "swa_attention": 2 * t["layers"] * t["steps"]}
    if unbroken_n != want or {k: ratio * v for k, v in
                              resumed_n.items()} != want:
        raise AssertionError(f"train resume: launches {unbroken_n} in the "
                             f"unbroken run and {resumed_n} resumed, want "
                             f"{want} and 1/{ratio} of it")
    print(f"[train resume] {LM_ARCH} at {t['layers']} layers, m = "
          f"{t['agents']}, {t['comm']!r}: {t['steps']} steps with a "
          f"checkpoint every {t['every']} ({nbytes} bytes each, save "
          + ", ".join(f"{x:.0f}" for x in ckpt_ms["save"])
          + f" ms), {unbroken_s:.1f} s; resumed from step {t['every']} "
          f"(restore {ckpt_ms['restore'][0]:.0f} ms) in "
          f"{resumed_s:.1f} s: all {leaves} leaves of the final state "
          f"bitwise equal; launches {unbroken_n} unbroken, {resumed_n} "
          f"resumed")
    return {"layers": t["layers"], "agents": t["agents"],
            "steps": t["steps"], "ckpt_every": t["every"],
            "checkpoint_bytes": nbytes, "leaves": leaves,
            "save_ms": ckpt_ms["save"], "restore_ms": ckpt_ms["restore"],
            "unbroken_s": unbroken_s, "resumed_s": resumed_s,
            "launches_unbroken": unbroken_n, "launches_resumed": resumed_n}


def _train_card_vs_cpu(torch, cfg, batch, dev, comm: str = TRAIN["comm"],
                       gains: bool = False, small=None,
                       tag: str = "") -> dict:
    """One step of the model cut to TRAIN_CHECK["layers"] layers at full
    width, from the same weights and batch, on the card and the CPU.

    The int8 wire quantizes each agent's gradient with a per-tensor
    scale; card and CPU gradients differ in their last bits, so an
    element within that gap of a rounding boundary may land one int8
    level apart (ROADMAP §3).  Elements whose CPU gradient lies within
    ``TRAIN_TOL``·max|g| of a boundary may so differ by at most one
    level per agent (lr · level / agents); every other element is held
    to ``TRAIN_TOL`` of its leaf's largest value.  With ``gains`` the
    mean gain is held to ``TRAIN_TOL`` too, beside loss and grad_norm;
    the gates (num_tx) are equal.  ``small`` replaces the cut of
    ``cfg`` that runs (its layers and, for the experts, their width)."""
    from repro_torch.comm.bank import batch_prologue
    from repro_torch.core.api import init_train_state
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map

    small = small or cfg.replace(num_layers=TRAIN_CHECK["layers"])
    agents = TRAIN_CHECK["agents"]
    n = agents * TRAIN_CHECK["per_agent"]
    params = None
    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        plan, _, step, model, opt = _train_parts(small, agents, n,
                                                 TRAIN_CHECK["seq"], d, comm)
        if params is None:
            params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
        state = init_train_state(tree_map(lambda t: t.to(d), params), opt,
                                 plan.train_cfg, device=d)
        t0 = time.perf_counter()
        new, m = step(state, {k: v.to(d) for k, v in batch.items()})
        runs[where] = (dict(tree_flatten_with_path(
            tree_map(lambda t: t.cpu(), new.params))),
            {k: v.cpu() for k, v in m.items()}, time.perf_counter() - t0)
    # the CPU's per-agent gradients (EF memory starts at 0: g + ef = g)
    _, grads = batch_prologue(model.loss_fn)(
        state.params, {k: v.cpu() for k, v in batch.items()})
    g_cpu = dict(tree_flatten_with_path(grads))
    (pc, mc, _), (ph, mh, cpu_s) = runs["card"], runs["cpu"]
    if not torch.equal(mc["num_tx"], mh["num_tx"]):
        raise AssertionError(f"train card vs CPU: num_tx {mc['num_tx']} vs "
                             f"{mh['num_tx']}")
    gaps = {}
    for key in ("loss", "grad_norm") + (("mean_gain",) if gains else ()):
        gaps[key] = abs(float(mc[key]) - float(mh[key])) / abs(float(mh[key]))
        if not gaps[key] <= TRAIN_TOL:
            raise AssertionError(f"train card vs CPU: {key} {float(mc[key])} "
                                 f"vs {float(mh[key])}")
    worst, tied, _ = _params_within(torch, pc, ph, g_cpu, agents,
                                    "train card vs CPU")
    tag = tag or ("[train quadratic]" if gains else "[train]")
    gain_text = (f", mean gain {float(mh['mean_gain']):.6e} (rel gap "
                 f"{gaps['mean_gain']:.2e})" if gains else "")
    print(f"{tag} card vs CPU, {small.num_layers} layers at full width, "
          f"{agents} agents × {TRAIN_CHECK['per_agent']} × "
          f"{TRAIN_CHECK['seq']} tokens: loss {float(mh['loss']):.6f} "
          f"(rel gap {gaps['loss']:.2e}), grad_norm rel gap "
          f"{gaps['grad_norm']:.2e}{gain_text}, num_tx "
          f"{float(mh['num_tx']):.0f} equal, "
          f"params within {worst:.2e} of each leaf's max (tol {TRAIN_TOL}) "
          f"apart from {tied} elements at an int8 rounding boundary, each "
          f"within one level; CPU step {cpu_s:.1f} s")
    return {"layers": small.num_layers, "agents": agents, "comm": comm,
            "seq": TRAIN_CHECK["seq"], "rel_gaps": gaps,
            "params_max_gap_over_leaf_max": worst, "tol": TRAIN_TOL,
            "int8_boundary_elements_one_level_apart": tied,
            "num_tx": float(mh["num_tx"])}


def _int8_wire(g):
    """``g`` (``(agents, *shape)``) as int8 sends it: rounded to each
    agent's level (its max|g| / 127); and the level."""
    level = g.abs().amax(dim=tuple(range(1, g.ndim)), keepdim=True) / 127
    return (g / level).round() * level, level


def _int8_ties(g, level):
    """Where ``g`` lies within ``TRAIN_TOL``·max|g| of an int8 rounding
    boundary."""
    r = (g / level).abs()
    return (r - r.floor() - 0.5).abs() <= 127 * TRAIN_TOL


def _params_within(torch, got: dict, want: dict, grads: dict, agents: int,
                   what: str, other: dict = None):
    """Hold one step's parameters (``{path: tensor}``) to another's
    taken from the same state with EF memory 0: every element within
    ``TRAIN_TOL`` of its leaf's largest value, plus lr · level / agents
    for each agent whose gradient ``grads[path]`` (``(agents, *shape)``)
    lies within ``TRAIN_TOL``·max|g| of an int8 rounding boundary (the
    two may round one level apart; ROADMAP §3), and, given the other
    step's gradients ``other``, plus lr / agents · the gap of the two
    gradients' int8 wire values (and ``other``'s own ties).  Returns (the largest gap over its
    leaf's max where nothing is allowed beyond TRAIN_TOL, the number of
    elements past TRAIN_TOL, the largest gap over all elements)."""
    worst, tied, worst_all = 0.0, 0, 0.0
    lr = TRAIN["lr"]
    for path, w in want.items():
        scale = w.abs().max().item()
        diff = (got[path] - w).abs()
        g = grads[path]
        wire, level = _int8_wire(g)
        allowed = lr * (level * _int8_ties(g, level)).sum(0) / agents
        if other is not None:
            o = other[path]
            wo, lo = _int8_wire(o)
            allowed = allowed + lr * ((wo - wire).abs()
                                      + lo * _int8_ties(o, lo)).sum(0) / agents
        if not bool((diff <= TRAIN_TOL * scale + allowed).all()):
            raise AssertionError(f"{what}: params {path} differ by "
                                 f"{diff.max().item() / scale:.3e} of "
                                 f"their largest value")
        tied += int((diff > TRAIN_TOL * scale).sum())
        worst = max(worst, (diff * (allowed == 0)).max().item() / scale)
        worst_all = max(worst_all, diff.max().item() / scale)
    return worst, tied, worst_all


# ----------------------------------------------------------------------
# the moe and hybrid families
# ----------------------------------------------------------------------

class _MoERecorder:
    """Wraps ``repro_torch.models.moe.moe_layer`` (which the model calls
    through its module) to record each call's routing: the expert ids,
    the router probabilities and the (token, k) pairs dropped by
    capacity.  Its own route and dispatch work runs only in the recorded
    passes, never in a timed or counted run."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls, self._layer = moe, [], moe.moe_layer

    def __enter__(self):
        moe, layer, calls = self.moe, self._layer, self.calls

        def recorded(p, cfg, x):
            xt = x.reshape(-1, x.shape[-1])
            probs, _, experts = moe.route(p, cfg, xt)
            m = cfg.moe
            cap = moe.capacity(xt.shape[0], m.experts_per_token,
                               m.num_experts, m.capacity_factor)
            slot = moe.dispatch_slots(experts, m.num_experts, cap)
            kept = slot < m.num_experts * cap
            calls.append({"experts": experts.cpu(), "probs": probs.cpu(),
                          "kept": kept.reshape(experts.shape).cpu(),
                          "cap": cap, "pairs": slot.numel(),
                          "dropped": int((~kept).sum())})
            return layer(p, cfg, x)

        moe.moe_layer = recorded
        return self

    def __exit__(self, *exc):
        self.moe.moe_layer = self._layer


def _route_ties(card, cpu) -> int:
    """Expert ids of one layer on the card against the CPU's: equal,
    except where the two experts' CPU probabilities lie within ROUTE_TIE
    (relative) of each other.  Returns the count of such entries."""
    probs = cpu["probs"]
    rows, ks = (card["experts"] != cpu["experts"]).nonzero(as_tuple=True)
    for t, k in zip(rows.tolist(), ks.tolist()):
        a = probs[t, card["experts"][t, k]].item()
        b = probs[t, cpu["experts"][t, k]].item()
        if not abs(a - b) <= ROUTE_TIE * max(a, b):
            raise AssertionError(f"moe card vs CPU: token {t}, k {k} routed "
                                 f"to expert {card['experts'][t, k]} vs "
                                 f"{cpu['experts'][t, k]} (probs {a:.8g}, "
                                 f"{b:.8g})")
    return len(rows)


def _first_layers(torch, params, n: int, stacks=("blocks",)):
    """The parameters of a stacked model's first ``n`` layers (views) of
    each of its ``stacks``."""
    from repro_torch.utils.tree import tree_map

    return {**params, **{k: tree_map(lambda t: t[:n], params[k])
                         for k in stacks}}


def _init_served(torch, cfg, batch: int, prompt: int):
    """A model of ``cfg`` with weights from seed 0 on the card, and
    ``batch`` prompts of ``prompt`` tokens from the bigram chain (seed 7)."""
    from repro_torch.data.synthetic import sample_lm_tokens
    from repro_torch.models import build

    dev = torch.device("cuda", torch.cuda.current_device())
    model = build(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = sample_lm_tokens(torch.Generator(device=dev).manual_seed(7),
                               batch, prompt, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the stream's bigram table
    return model, params, prompts


def phase_moe(torch, swa_ops) -> dict:
    """mixtral-8x7b at full width, cut to MOE_SERVE["layers"] layers,
    served through the serving CLI's prefill and greedy decode; the
    pairs each layer's prefill drops; decode against a fresh prefill at
    a capacity that drops nothing; 1 layer on the card against the
    CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.utils.tree import tree_size

    run = MOE_SERVE
    cfg = get_config(MOE_ARCH).replace(num_layers=run["layers"])
    t0 = time.perf_counter()
    model, params, prompts = _init_served(torch, cfg, run["batch"],
                                          run["prompt"])
    n_params = tree_size(params)
    print(f"[moe] {cfg.name}: {cfg.num_layers} of 32 layers at full width "
          f"(d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim_}, {cfg.moe.num_experts} experts of "
          f"{cfg.moe.d_ff_expert}, top {cfg.moe.experts_per_token}, W "
          f"{cfg.swa_window}, vocab {cfg.vocab_size}), {n_params / 1e9:.3f} "
          f"B parameters (fp32, seed 0); weights and prompts in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    record = {"arch": cfg.name, "layers": cfg.num_layers,
              "params": n_params}
    row = _lm_run(torch, swa_ops, serve, model, params, prompts, run["gen"],
                  "served", tag="moe", check_decode=False)
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["serve"] = row
    # the pairs each layer's prefill drops (a recorded pass, not counted)
    before = swa_ops.swa_attention.launches
    with _MoERecorder() as rec:
        model.prefill(params, {"tokens": prompts}, cache_len=run["prompt"])
    swa_ops.swa_attention.launches = before
    row["dropped_per_layer"] = [c["dropped"] for c in rec.calls]
    row["pairs_per_layer"], row["capacity"] = (rec.calls[0]["pairs"],
                                               rec.calls[0]["cap"])
    print(f"[moe] prefill: {row['pairs_per_layer']} (token, k) pairs per "
          f"layer, capacity {row['capacity']} per expert; dropped per "
          f"layer {row['dropped_per_layer']}; peak memory "
          f"{row['peak_memory_gb']:.2f} GB")
    # decode through the cache against a fresh prefill, where no pair is
    # dropped (capacity factor E / K: an expert can hold every token); at
    # the served factor a longer prefill drops other pairs, which the
    # reference's semantics allow
    moe = cfg.moe
    full_cap = cfg.replace(moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.experts_per_token))
    record["no_drop"] = _lm_run(torch, swa_ops, serve, build(full_cap),
                                params, prompts, run["gen"],
                                "capacity factor E/K", tag="moe")
    # the same weights at 1 layer on the card and the CPU
    chk = MOE_CHECK
    one = build(cfg.replace(num_layers=chk["layers"]))
    record["card_vs_cpu"] = _moe_card_vs_cpu(
        torch, serve, one, _first_layers(torch, params, chk["layers"]),
        prompts[:chk["batch"], :chk["prompt"]].contiguous(), chk["gen"])
    return record


def _moe_card_vs_cpu(torch, serve, model, params, prompts, gen: int) -> dict:
    """``_card_vs_cpu`` for a moe model, with each MoE call's routing
    recorded on both sides: the expert ids equal but at near-ties, the
    prefill logits within LM_LOGIT_TOL at every position whose pairs
    went to the same experts and were kept alike (a near-tie flip moves
    its token, and through capacity the drops of later pairs), and the
    greedy tokens equal unless a near-tie flipped a route."""
    from repro_torch.utils.tree import tree_map

    b, s = prompts.shape
    runs = {}
    for where, p, x in (("card", params, prompts),
                        ("cpu", tree_map(lambda t: t.cpu(), params),
                         prompts.cpu())):
        t0 = time.perf_counter()
        with _MoERecorder() as rec:
            toks, logits, cache = serve.prefill_prompt(model, p, x,
                                                       s + gen + 8)
            rest, _ = serve.decode_tokens(model, p, cache, toks, s, gen - 1)
        runs[where] = (logits.cpu(), torch.cat([toks, rest], 1).cpu(),
                       rec.calls, time.perf_counter() - t0)
    (lc, tc, rc, _), (lh, th, rh, cpu_s) = runs["card"], runs["cpu"]
    layers = model.cfg.num_layers
    ties = [_route_ties(c, h) for c, h in zip(rc, rh)]
    alike = torch.ones((b * s,), dtype=torch.bool)
    for c, h in zip(rc[:layers], rh[:layers]):  # the prefill's calls
        alike &= ((c["experts"] == h["experts"])
                  & (c["kept"] == h["kept"])).all(-1)
    alike = alike.reshape(b, s)
    gap = (lc - lh).abs()
    within = (gap <= LM_LOGIT_TOL + LM_LOGIT_TOL * lh.abs()).all(-1)
    if not bool(within[alike].all()):
        raise AssertionError(f"moe card vs CPU: prefill logits differ by "
                             f"{gap[alike].max().item():.3e} where the "
                             f"routes agree")
    if not torch.equal(tc, th) and not any(ties):
        raise AssertionError(f"moe card vs CPU: greedy tokens differ with "
                             f"every route equal:\n{tc}\n{th}")
    moved = int((~alike).sum())
    print(f"[moe] card vs CPU, {layers} layer, B={b} S={s}: expert ids "
          f"equal but {sum(ties)} near-ties (probabilities within "
          f"{ROUTE_TIE}) over {len(rc)} MoE calls; prefill logits max "
          f"|gap| {gap[alike].max().item():.3e} at the {int(alike.sum())} "
          f"positions routed alike (tol {LM_LOGIT_TOL} + {LM_LOGIT_TOL}"
          f"·|cpu|; {moved} moved by a flip, max |gap| "
          f"{gap.max().item():.3e}); {gen} greedy tokens "
          f"{'equal' if torch.equal(tc, th) else 'differ after a near-tie'}"
          f"; CPU run {cpu_s:.1f} s")
    return {"layers": layers, "batch": b, "prompt": s, "gen": gen,
            "route_near_ties": sum(ties), "positions_moved": moved,
            "logits_max_abs_gap_alike": gap[alike].max().item(),
            "logits_max_abs_gap": gap.max().item(), "tol": LM_LOGIT_TOL,
            "tokens_equal": torch.equal(tc, th)}


def _checksums(torch, tree) -> list:
    """Per leaf, the sum of its 32-bit words (bitwise-equal leaves give
    equal sums): a repeatability check that holds no second state."""
    from repro_torch.utils.tree import tree_leaves

    out = []
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):  # the host-int step
            out.append(t)
            continue
        if t.dtype == torch.float32:
            t = t.contiguous().view(torch.int32)
        out.append(int(t.long().sum()))
    return out


def _family_train(torch, ce_ops, swa_ops, cfg, run: dict, tag: str,
                  swa_per_step: int, repeat: bool = False, **knobs):
    """The training CLI's step for ``cfg`` on the card: warm-up and timed
    steps on one stream's batches, each step's launches, losses, ms and
    peak memory; with ``repeat`` the last step runs twice from one state
    and must give bitwise-equal states; ``knobs`` go to ``plan_run``.
    Returns (record, step, state, batches, mean ms)."""
    from repro_torch.core.api import init_train_state
    from repro_torch.data.synthetic import batch_iterator
    from repro_torch.utils.tree import tree_size

    dev = torch.device("cuda", torch.cuda.current_device())
    agents, gbatch, seq = run["agents"], run["batch"], run["seq"]
    plan, shape, step, model, opt = _train_parts(cfg, agents, gbatch, seq,
                                                 dev, **knobs)
    steps = run["warmup"] + run["timed"]
    stream = batch_iterator(cfg, shape, num_agents=agents, seed=0, device=dev)
    batches = [next(stream) for _ in range(steps + 1)]  # +1: the profile
    del stream  # the stream's bigram table
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(params, opt, plan.train_cfg, device=dev)
    del params
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    n_params = tree_size(state.params)
    # the tokens a step trains on (whisper: decoder tokens, not frames;
    # vlm: text tokens, not patches)
    tokens = int(batches[0]["tokens"].numel())
    leaves = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batches[0].items())
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers at full width, "
          f"{n_params / 1e9:.3f} B parameters (fp32, seed 0); {agents} "
          f"agents, batch leaves {leaves}, comm={TRAIN['comm']!r}, sgd lr "
          f"{TRAIN['lr']}" + (f"; {knobs}" if knobs else ""))
    ce_ops.fused_ce.launches = swa_ops.swa_attention.launches = 0
    rows, repeat_equal = [], None
    for k in range(steps):
        ce0, swa0 = ce_ops.fused_ce.launches, swa_ops.swa_attention.launches
        prev = state
        t0 = time.perf_counter()
        state, m = step(prev, batches[k])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows.append({"step": k, "ms": dt * 1e3, "loss": float(m["loss"]),
                     "num_tx": float(m["num_tx"]),
                     "grad_norm": float(m["grad_norm"]),
                     "fused_ce": ce_ops.fused_ce.launches - ce0,
                     "swa_attention": swa_ops.swa_attention.launches - swa0})
        if repeat and k == steps - 1:
            # the same step again from the same state: bitwise the same
            # (the MoE combine and every other op of the step use no
            # float atomics)
            launches = (ce_ops.fused_ce.launches,
                        swa_ops.swa_attention.launches)
            first = _checksums(torch, state) + _checksums(torch, m)
            del state, m
            state, m = step(prev, batches[k])
            repeat_equal = first == (_checksums(torch, state)
                                     + _checksums(torch, m))
            ce_ops.fused_ce.launches, swa_ops.swa_attention.launches = \
                launches
            if not repeat_equal:
                raise AssertionError(f"{tag}: the step run twice from one "
                                     f"state differs")
        del prev
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"fused_ce": ce_ops.fused_ce.launches,
                "swa_attention": swa_ops.swa_attention.launches}
    for r in rows:
        if r["fused_ce"] != 2 or r["swa_attention"] != swa_per_step:
            raise AssertionError(
                f"{tag} step {r['step']}: fused_ce launched {r['fused_ce']} "
                f"times (want 2: the agents' losses, the lookahead probe), "
                f"swa_attention {r['swa_attention']} (want {swa_per_step})")
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"{tag}: non-finite loss {r}")
    timed = [r["ms"] for r in rows[run["warmup"]:]]
    mean_ms = statistics.mean(timed)
    for r in rows:
        print(f"[{tag}] step {r['step']}: {r['ms']:8.2f} ms  loss "
              f"{r['loss']:.5f}  num_tx {r['num_tx']:.0f}/{agents}  |g| "
              f"{r['grad_norm']:.4f}  launches fused_ce {r['fused_ce']}, "
              f"swa_attention {r['swa_attention']}")
    print(f"[{tag}] {run['timed']} timed steps: {mean_ms:.2f} ms per step "
          f"({tokens / (mean_ms / 1e3):.0f} tokens/s); peak memory "
          f"{peak_gb:.2f} GB ({base_gb:.2f} GB allocated before the steps)"
          + ("" if repeat_equal is None else
             "; the last step run twice from one state: bitwise equal"))
    record = {"arch": cfg.name, "layers": cfg.num_layers, "knobs": knobs,
              "params": n_params, "agents": agents, "global_batch": gbatch,
              "seq": seq, "comm": TRAIN["comm"], "lr": TRAIN["lr"],
              "steps": rows, "ms_per_step": mean_ms,
              "tokens_per_step": tokens,
              "tokens_per_s": tokens / (mean_ms / 1e3),
              "launches": launches, "peak_memory_gb": peak_gb,
              "allocated_before_gb": base_gb,
              "repeat_bitwise_equal": repeat_equal}
    return record, step, state, batches, mean_ms


def _check_batch(batches) -> dict:
    return {k: v[:TRAIN_CHECK["agents"], :TRAIN_CHECK["per_agent"],
                 :TRAIN_CHECK["seq"]].contiguous()
            for k, v in batches[0].items()}


def phase_moe_train(torch, ce_ops, swa_ops) -> dict:
    """mixtral-8x7b at full width, 1 layer, through the training CLI's
    step: m = 2, ``gain_lookahead(lam=0.01)|int8+ef``; the router aux
    loss finite; the step bitwise repeatable; then one step with the
    experts narrowed on the card and the CPU."""
    import dataclasses

    from repro_torch.configs import get_config

    dev = torch.device("cuda", torch.cuda.current_device())
    run = MOE_TRAIN
    cfg = get_config(MOE_ARCH).replace(num_layers=run["layers"])
    record, step, state, batches, _ = _family_train(
        torch, ce_ops, swa_ops, cfg, run, "moe train",
        swa_per_step=2 * run["layers"], repeat=True)
    from repro_torch.models import build

    before = (ce_ops.fused_ce.launches, swa_ops.swa_attention.launches)
    one_agent = {k: v[0] for k, v in batches[0].items()}
    _, aux = build(cfg).forward(state.params, one_agent)
    ce_ops.fused_ce.launches, swa_ops.swa_attention.launches = before
    record["router_aux"] = float(aux)
    if not math.isfinite(record["router_aux"]):
        raise AssertionError(f"moe train: router aux {record['router_aux']}")
    print(f"[moe train] after {len(record['steps'])} steps: router aux "
          f"loss {record['router_aux']:.6f} on the first batch (weight "
          f"{cfg.moe.router_aux_weight})")
    check_batch = _check_batch(batches)
    del step, state, batches
    torch.cuda.empty_cache()
    small = cfg.replace(moe=dataclasses.replace(
        cfg.moe, d_ff_expert=MOE_TRAIN_CHECK_FF))
    record["card_vs_cpu"] = _train_card_vs_cpu(
        torch, cfg, check_batch, dev, small=small, tag="[moe train]")
    record["card_vs_cpu"]["d_ff_expert"] = MOE_TRAIN_CHECK_FF
    return record


def phase_hybrid(torch, swa_ops) -> dict:
    """zamba2-1.2b at full width (HYBRID_SERVE's layers) served by
    replay through the serving CLI's prefill and greedy decode (no
    kernel launch), decode against a fresh replay, and the card against
    the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.models.transformer import group_bounds
    from repro_torch.utils.tree import tree_size

    run = HYBRID_SERVE
    cfg = get_config(HYBRID_ARCH).replace(num_layers=run["layers"])
    t0 = time.perf_counter()
    model, params, prompts = _init_served(torch, cfg, run["batch"],
                                          run["prompt"])
    n_params = tree_size(params)
    sites = len(group_bounds(cfg.num_layers, cfg.shared_attn_every))
    print(f"[hybrid] {cfg.name}: {cfg.num_layers} Mamba2 layers and "
          f"{sites} sites of the shared attention block, d "
          f"{cfg.d_model}, state {cfg.ssm.state_dim}, vocab "
          f"{cfg.vocab_size}: {n_params / 1e9:.3f} B parameters in the "
          f"init (param_count() {cfg.param_count() / 1e9:.2f} B, the "
          f"reference's formula); weights and prompts in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    row = _lm_run(torch, swa_ops, serve, model, params, prompts, run["gen"],
                  "replay", tag="hybrid")
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[hybrid] peak memory {row['peak_memory_gb']:.2f} GB")
    chk = HYBRID_CHECK
    record = {"arch": cfg.name, "layers": cfg.num_layers, "sites": sites,
              "params": n_params, "param_count": cfg.param_count(),
              "serve": row}
    x = prompts[:chk["batch"], :chk["prompt"]].contiguous()
    small = build(cfg.replace(num_layers=chk["layers"]))
    p_small = _first_layers(torch, params, chk["layers"])
    sens = _last_bit_sensitivity(torch, serve, small, p_small, x)
    record["last_bit_sensitivity"] = sens
    print(f"[hybrid] the model's own sensitivity on the card: weights "
          f"scaled by 1 + 2^-23·N(0, 1) move the prefill logits by "
          f"{sens:.3e} (smollm-135m's 30 layers: ~1e-6 on the CPU)")
    record["card_vs_cpu"] = _card_vs_cpu(
        torch, serve, small, p_small, x, gen=chk["gen"], tag="hybrid",
        extra_tol=HYBRID_SENS_FACTOR * sens)
    return record


def _last_bit_sensitivity(torch, serve, model, params, prompts) -> float:
    """How far the prefill logits move on the card when every weight
    changes in its last bits (× 1 + 2^-23·N(0, 1), seed 13): the scale
    at which two devices' roundings of the same model part."""
    from repro_torch.utils.tree import tree_map

    gen = torch.Generator(device=prompts.device).manual_seed(13)
    shaken = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
        t.shape, generator=gen, device=t.device)), params)
    s = prompts.shape[1]
    a = serve.prefill_prompt(model, params, prompts, s + 8)[1]
    b = serve.prefill_prompt(model, shaken, prompts, s + 8)[1]
    del shaken
    return (a - b).abs().max().item()


def phase_hybrid_train(torch, ce_ops, swa_ops) -> tuple:
    """zamba2-1.2b at full width and depth (38 layers, 7 sites of the
    shared block) with ``remat`` through the training CLI's step; then
    cut to HYBRID_TRAIN["layers"] layers (two sites) without it, for the
    profile (whose trace it bounds), and one 2-layer step on the card
    and the CPU.  Returns (record, what its profile needs)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import group_bounds

    dev = torch.device("cuda", torch.cuda.current_device())
    full = get_config(HYBRID_ARCH)
    assert full.num_layers == HYBRID_TRAIN_FULL["layers"]
    sites = len(group_bounds(full.num_layers, full.shared_attn_every))
    # remat checkpoints the Mamba2 layers only: the shared block's
    # launches (loss and probe at each site) do not move
    remat_record = _family_train(
        torch, ce_ops, swa_ops, full, HYBRID_TRAIN_FULL, "hybrid train",
        swa_per_step=2 * sites, remat=True)[0]
    remat_record["sites"] = sites
    torch.cuda.empty_cache()
    run = HYBRID_TRAIN
    cfg = full.replace(num_layers=run["layers"])
    sites = len(group_bounds(cfg.num_layers, cfg.shared_attn_every))
    record, step, state, batches, mean_ms = _family_train(
        torch, ce_ops, swa_ops, cfg, run, "hybrid train",
        swa_per_step=2 * sites)
    record["sites"] = sites
    record["full_depth_remat"] = remat_record
    small = cfg.replace(num_layers=HYBRID_TRAIN_CHECK_LAYERS)
    record["card_vs_cpu"] = _train_card_vs_cpu(
        torch, cfg, _check_batch(batches), dev, small=small,
        tag="[hybrid train]")
    return record, (step, state, batches[-1], mean_ms, record)


# ----------------------------------------------------------------------
# the ssm, audio and vlm families
# ----------------------------------------------------------------------

def _replay_logits(torch, model, params, tokens):
    """Every position's logits (B, S, V) of ``tokens`` (B, S) by the
    recurrent replay: one decode step per position from the empty
    cache, as the reference's prefill replays a prompt."""
    b, s = tokens.shape
    cache, _ = model.init_cache(b, s, device=tokens.device)
    out = []
    for t in range(s):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t)
        out.append(logits)
    return torch.cat(out, 1)


def _forward_sensitivity(torch, model, params, x, logits):
    """|Δ logits| (B, S, V) of ``model.forward`` on ``x`` when every
    weight changes in its last bits (× 1 + 2^-23·N(0, 1), seed 13), as
    :func:`_last_bit_sensitivity` shakes them: the scale at which two
    orders of the same fp32 sums part, position by position."""
    from repro_torch.utils.tree import tree_map

    gen = torch.Generator(device=x.device).manual_seed(13)
    shaken = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
        t.shape, generator=gen, device=t.device)), params)
    moved, _ = model.forward(shaken, {"tokens": x})
    del shaken
    return (moved - logits).abs()


def phase_xlstm(torch, swa_ops) -> dict:
    """xlstm-350m at full width (XLSTM_SERVE's layers) served by replay
    through the serving CLI's prefill and greedy decode (no kernel
    launch, decode bitwise a fresh replay); the chunkwise forward over
    XLSTM_FORWARD["seq"] tokens against the replay's logits at every
    position; 2 layers on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.utils.tree import tree_size

    run, fwd, chk = XLSTM_SERVE, XLSTM_FORWARD, XLSTM_CHECK
    cfg = get_config(XLSTM_ARCH).replace(num_layers=run["layers"])
    t0 = time.perf_counter()
    model, params, prompts = _init_served(torch, cfg, run["batch"],
                                          fwd["seq"])
    n_params = tree_size(params)
    print(f"[xlstm] {cfg.name}: {cfg.num_layers // 2} mLSTM/sLSTM pairs, d "
          f"{cfg.d_model}, {cfg.num_heads} heads, mLSTM chunk "
          f"{cfg.xlstm.chunk_size}, vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B parameters in the init (param_count() "
          f"{cfg.param_count() / 1e9:.2f} B, the reference's formula; fp32, "
          f"seed 0); weights and prompts in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    row = _lm_run(torch, swa_ops, serve, model, params,
                  prompts[:, :run["prompt"]].contiguous(), run["gen"],
                  "replay", tag="xlstm")
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[xlstm] peak memory {row['peak_memory_gb']:.2f} GB")
    record = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
              "param_count": cfg.param_count(), "serve": row}
    # the chunkwise (training) form against the recurrent (serving) form
    x = prompts[:fwd["batch"]].contiguous()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, {"tokens": x})
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    replay = _replay_logits(torch, model, params, x)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3
    gap = (logits - replay).abs()
    # the two forms sum in other orders, and the recurrence amplifies a
    # rounding with the position (the reference's own forms part by 1e-4
    # to 1.9e-3 over these 4 chunks at reduced width, ROADMAP §3): each
    # chunk is held to LM_LOGIT_TOL + HYBRID_SENS_FACTOR × the forward's
    # own last-bit sensitivity in that chunk, measured here
    sens = _forward_sensitivity(torch, model, params, x, logits)
    chunk = cfg.xlstm.chunk_size
    starts = range(0, fwd["seq"], chunk)
    by_chunk = [gap[:, c:c + chunk].max().item() for c in starts]
    sens_by_chunk = [sens[:, c:c + chunk].max().item() for c in starts]
    tol_by_chunk = [LM_LOGIT_TOL + HYBRID_SENS_FACTOR * t
                    for t in sens_by_chunk]
    for c, g, t in zip(starts, by_chunk, tol_by_chunk):
        rel = LM_LOGIT_TOL * replay[:, c:c + chunk].abs()
        if not bool((gap[:, c:c + chunk] <= t + rel).all()):
            raise AssertionError(f"xlstm: the chunkwise forward differs from "
                                 f"the replay by {g:.3e} in the chunk at "
                                 f"{c} (tol {t:.3e}; per chunk {by_chunk})")
    record["forward_vs_replay"] = {
        "batch": fwd["batch"], "seq": fwd["seq"], "chunk": chunk,
        "max_abs_gap": gap.max().item(), "max_abs_gap_by_chunk": by_chunk,
        "last_bit_sensitivity_by_chunk": sens_by_chunk,
        "tol_by_chunk": tol_by_chunk, "forward_ms": fwd_ms,
        "replay_ms": replay_ms}
    print(f"[xlstm] chunkwise forward over B={fwd['batch']} S={fwd['seq']} "
          f"({fwd['seq'] // chunk} chunks of {chunk}) against the replay's "
          f"logits at every position: max |gap| per chunk "
          f"{', '.join(f'{g:.2e}' for g in by_chunk)}; the forward's "
          f"last-bit sensitivity per chunk "
          f"{', '.join(f'{g:.2e}' for g in sens_by_chunk)} (tol "
          f"{LM_LOGIT_TOL} + {HYBRID_SENS_FACTOR}× that, + "
          f"{LM_LOGIT_TOL}·|replay|); forward {fwd_ms:.1f} ms, replay "
          f"{replay_ms:.1f} ms")
    del logits, replay, gap, sens
    x_chk = prompts[:chk["batch"], :chk["prompt"]].contiguous()
    small = build(cfg.replace(num_layers=chk["layers"]))
    small_params = _first_layers(torch, params, chk["layers"] // 2,
                                 ("pairs",))
    small_sens = _last_bit_sensitivity(torch, serve, small, small_params,
                                       x_chk)
    record["card_vs_cpu"] = _card_vs_cpu(
        torch, serve, small, small_params, x_chk, gen=chk["gen"],
        tag="xlstm", extra_tol=HYBRID_SENS_FACTOR * small_sens)
    record["card_vs_cpu"]["layers"] = chk["layers"]
    record["card_vs_cpu"]["last_bit_sensitivity"] = small_sens
    return record, (model, params, prompts[:, :XLSTM_PROFILED_PROMPT],
                    row["decode_ms_per_step"])


def phase_xlstm_train(torch, ce_ops, swa_ops) -> dict:
    """xlstm-350m at full width cut to XLSTM_TRAIN["layers"] layers
    through the training CLI's step (no attention: 2 ``fused_ce`` and no
    ``swa_attention`` launch a step), bitwise repeatable; one 2-layer
    step on the card and the CPU."""
    from repro_torch.configs import get_config

    dev = torch.device("cuda", torch.cuda.current_device())
    run = XLSTM_TRAIN
    cfg = get_config(XLSTM_ARCH).replace(num_layers=run["layers"])
    record, step, state, batches, _ = _family_train(
        torch, ce_ops, swa_ops, cfg, run, "xlstm train", swa_per_step=0,
        repeat=True)
    check_batch = _check_batch(batches)
    del step, state, batches
    torch.cuda.empty_cache()
    record["card_vs_cpu"] = _train_card_vs_cpu(
        torch, cfg, check_batch, dev,
        small=cfg.replace(num_layers=XLSTM_CHECK["layers"]),
        tag="[xlstm train]")
    return record


def phase_decode_profile(torch, model, params, prompts, step_ms: float,
                         label: str) -> dict:
    """XLSTM_PROFILED_STEPS decode steps under torch.profiler after a
    short replayed prompt: device ops and busy time per step, and the
    idle share against the unprofiled decode time of the served run
    (a recurrent step's work does not depend on its position)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    s = prompts.shape[1]
    n = XLSTM_PROFILED_STEPS
    toks, _, cache = serve.prefill_prompt(model, params, prompts, s + n + 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve.decode_tokens(model, params, cache, toks, s, n)
        torch.cuda.synchronize()
    ivals = _device_intervals(prof)
    if not ivals:
        raise AssertionError("the profiler saw no device activity")
    busy = sum(t for _, t in ivals) / 1e3 / n
    gemm = sum(t for nm, t in ivals if "gemm" in nm.lower()
               or "gemv" in nm.lower()) / 1e3 / n
    record = {"steps": n, "device_ops_per_step": len(ivals) / n,
              "busy_ms_per_step": busy, "gemm_ms_per_step": gemm,
              "decode_ms_per_step": step_ms,
              "idle_share": 1.0 - busy / step_ms}
    print(f"[profile] {label} decode: {record['device_ops_per_step']:.0f} "
          f"device ops and {busy:.3f} ms busy per step ({gemm:.3f} ms in "
          f"GEMMs and GEMVs) against the unprofiled {step_ms:.3f} ms -> "
          f"idle share {record['idle_share']:.3f}")
    return record


def _whisper_serve(torch, model, params, frames, first, gen: int) -> dict:
    """Whisper served as the reference's prefill and decode_step run it:
    the frames encoded once (``prefill``: the cross K/V of every decoder
    layer, no logits), then ``gen`` greedy decoder steps from ``first``
    at positions 0 … gen − 1.  Returns the cache, the tokens (B, gen),
    every step's logits (B, gen, V) and the prefill and decode times."""
    from repro_torch.launch import serve

    cuda = frames.device.type == "cuda"
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"frame_embeds": frames},
                                  cache_len=frames.shape[1])
    if cuda:
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if logits is not None:
        raise AssertionError("whisper: the prefill returned logits")
    toks, out, steps = first, [], []
    t0 = time.perf_counter()
    for i in range(gen):
        step_logits, cache = model.decode_step(params, cache, toks, i)
        toks = serve.greedy(step_logits[:, 0])
        steps.append(step_logits)
        out.append(toks)
    if cuda:
        torch.cuda.synchronize()
    return {"cache": cache, "tokens": torch.cat(out, 1),
            "logits": torch.cat(steps, 1), "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0}


def phase_whisper(torch, swa_ops) -> dict:
    """whisper-medium at full width and depth: 4 × 1500 frames encoded
    once, 32 greedy decoder tokens, no kernel launch (the encoder's
    attention is non-causal, decode plain); the encoder through
    ``attend_blockwise`` against the plain encoder; 1 + 1 layers on the
    card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.transformer import whisper_encode
    from repro_torch.utils.tree import tree_map, tree_size

    dev = torch.device("cuda", torch.cuda.current_device())
    run, chk = WHISPER_SERVE, WHISPER_CHECK
    cfg = get_config(WHISPER_ARCH)
    model = build(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(8)
    # the stubbed frontend's frames, 0.02·N(0, 1) as lm_batch draws them,
    # and each request's first decoder token
    frames = 0.02 * torch.randn((run["batch"], run["frames"], cfg.d_model),
                                generator=gen, device=dev)
    first = torch.randint(0, cfg.vocab_size, (run["batch"], 1),
                          generator=gen, device=dev)
    n_params = tree_size(params)
    print(f"[whisper] {cfg.name}: {cfg.encoder_layers} encoder and "
          f"{cfg.num_layers} decoder layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.head_dim_}, vocab "
          f"{cfg.vocab_size}: {n_params / 1e9:.3f} B parameters (fp32, "
          f"seed 0); {run['batch']} × {run['frames']} frames")
    _whisper_serve(torch, model, params, frames, first, 2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    swa_ops.swa_attention.launches = 0
    out = _whisper_serve(torch, model, params, frames, first, run["gen"])
    launches = swa_ops.swa_attention.launches
    if launches != 0:
        raise AssertionError(f"whisper serving launched swa_attention "
                             f"{launches} times (want 0: a non-causal "
                             f"encoder and plain decode)")
    cross = out["cache"]["cross_k"]
    if cross.shape != (cfg.num_layers, run["batch"], run["frames"],
                       cfg.num_kv_heads, cfg.head_dim_):
        raise AssertionError(f"whisper: cross cache {tuple(cross.shape)}")
    if not (bool(torch.isfinite(out["logits"]).all())
            and bool(torch.isfinite(cross).all())):
        raise AssertionError("whisper: non-finite logits or cross K/V")
    steps = run["gen"]
    row = {"batch": run["batch"], "frames": run["frames"], "gen": steps,
           "launches": launches,
           "prefill_ms": out["prefill_s"] * 1e3,
           "frames_per_s": run["batch"] * run["frames"] / out["prefill_s"],
           "decode_ms_per_step": out["decode_s"] / steps * 1e3,
           "decode_tokens_per_s": run["batch"] * steps / out["decode_s"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_tokens": out["tokens"][0, :8].tolist()}
    print(f"[whisper] B={run['batch']} frames={run['frames']}: "
          f"swa_attention launches 0; prefill (encode once, cross K/V of "
          f"{cfg.num_layers} layers) {row['prefill_ms']:.2f} ms "
          f"({row['frames_per_s']:.0f} frames/s); decode "
          f"{row['decode_ms_per_step']:.3f} ms/step "
          f"({row['decode_tokens_per_s']:.1f} tok/s); peak memory "
          f"{row['peak_memory_gb']:.2f} GB")
    del out
    record = {"arch": cfg.name, "params": n_params, "serve": row}
    # attend_blockwise on the card: the encoder at attn_q_block against
    # the plain encoder, on the served frames
    plain = whisper_encode(cfg, params, {"frame_embeds": frames})
    scale = plain.abs().max().item()
    record["blockwise"] = []
    for qb in run["q_blocks"]:
        t0 = time.perf_counter()
        got = whisper_encode(cfg.replace(attn_q_block=qb), params,
                             {"frame_embeds": frames})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gap = (got - plain).abs().max().item()
        blocks = run["frames"] // qb if run["frames"] % qb == 0 else 1
        if not gap <= WHISPER_ENC_TOL * (1 + scale):
            raise AssertionError(f"whisper: the encoder at attn_q_block "
                                 f"{qb} differs from the plain one by "
                                 f"{gap:.3e}")
        record["blockwise"].append({"q_block": qb, "blocks": blocks,
                                    "max_abs_gap": gap, "encode_ms": ms})
        print(f"[whisper] encoder at attn_q_block {qb} ({blocks} "
              f"block{'s' if blocks > 1 else ''} of "
              f"{run['frames'] // blocks} queries"
              + (", the ragged fallback" if blocks == 1 else "")
              + f"): max |gap| {gap:.3e} from the plain encoder (tol "
              f"{WHISPER_ENC_TOL}·(1 + {scale:.2f})); {ms:.1f} ms")
        del got
    del plain
    # the same weights at 1 + 1 layers on the card and the CPU
    small = build(cfg.replace(num_layers=chk["layers"],
                              encoder_layers=chk["layers"]))
    p_small = _first_layers(torch, params, chk["layers"],
                            ("enc_blocks", "dec_blocks"))
    x = frames[:chk["batch"], :chk["frames"]].contiguous()
    f0 = first[:chk["batch"]]
    t0 = time.perf_counter()
    card = _whisper_serve(torch, small, p_small, x, f0, chk["gen"])
    cpu = _whisper_serve(torch, small, tree_map(lambda t: t.cpu(), p_small),
                         x.cpu(), f0.cpu(), chk["gen"])
    cpu_s = time.perf_counter() - t0
    enc_gap = (card["cache"]["cross_k"].cpu()
               - cpu["cache"]["cross_k"]).abs()
    gap = (card["logits"].cpu() - cpu["logits"]).abs()
    tol = LM_LOGIT_TOL
    if not bool((gap <= tol + tol * cpu["logits"].abs()).all()):
        raise AssertionError(f"whisper card vs CPU: decode logits differ by "
                             f"{gap.max().item():.3e}")
    if not torch.equal(card["tokens"].cpu(), cpu["tokens"]):
        raise AssertionError(f"whisper card vs CPU: greedy tokens differ:\n"
                             f"{card['tokens']}\n{cpu['tokens']}")
    record["card_vs_cpu"] = {
        "layers": chk["layers"], "batch": chk["batch"],
        "frames": chk["frames"], "gen": chk["gen"],
        "cross_k_max_abs_gap": enc_gap.max().item(),
        "logits_max_abs_gap": gap.max().item(), "tol": tol,
        "tokens_equal": True}
    print(f"[whisper] card vs CPU, {chk['layers']} + {chk['layers']} layers, "
          f"B={chk['batch']} frames={chk['frames']}: cross keys max |gap| "
          f"{enc_gap.max().item():.3e}, {chk['gen']} decode steps' logits "
          f"max |gap| {gap.max().item():.3e} (tol {tol} + {tol}·|cpu|), "
          f"greedy tokens equal; both runs {cpu_s:.1f} s")
    return record


def phase_whisper_train(torch, ce_ops, swa_ops) -> tuple:
    """whisper-medium at full width and depth through the training CLI's
    step: m = 2 × 1 × (1500 frames, 448 decoder tokens); first with
    WHISPER_TRAIN_REMAT (3 × 24 ``swa_attention`` launches a step), its
    state freed, then plain: 2 ``fused_ce`` and 2 × 24 ``swa_attention``
    (the decoder's causal self-attention, loss and probe) launches a
    step; both peaks; one step at 2 + 2 layers on the card and the CPU.
    Returns (record, what its profile needs)."""
    from repro_torch.configs import get_config

    dev = torch.device("cuda", torch.cuda.current_device())
    run = WHISPER_TRAIN
    cfg = get_config(WHISPER_ARCH)
    # remat: the decoder's causal self-attention runs once more a step
    remat_record = _family_train(
        torch, ce_ops, swa_ops, cfg, run, "whisper train",
        swa_per_step=REMAT_SWA_PER_LAYER["lookahead", True] * cfg.num_layers,
        **WHISPER_TRAIN_REMAT)[0]
    torch.cuda.empty_cache()
    record, step, state, batches, mean_ms = _family_train(
        torch, ce_ops, swa_ops, cfg, run, "whisper train",
        swa_per_step=2 * cfg.num_layers)
    # the same batches and initial state: the first step's loss (forward
    # only; the blockwise encoder sums in other orders)
    first = (remat_record["steps"][0]["loss"], record["steps"][0]["loss"])
    gap = abs(first[0] - first[1]) / abs(first[1])
    if not gap <= TRAIN_TOL:
        raise AssertionError(f"whisper train: first loss with "
                             f"{WHISPER_TRAIN_REMAT} {first[0]} vs {first[1]}")
    print(f"[whisper train] peak memory {record['peak_memory_gb']:.2f} GB "
          f"plain, {remat_record['peak_memory_gb']:.2f} GB with "
          f"{WHISPER_TRAIN_REMAT} ({record['ms_per_step']:.2f} -> "
          f"{remat_record['ms_per_step']:.2f} ms a step); first loss rel gap "
          f"{gap:.2e}")
    record["remat"] = remat_record
    record["remat_first_loss_rel_gap"] = gap
    record["card_vs_cpu"] = _train_card_vs_cpu(
        torch, cfg, _check_batch(batches), dev,
        small=cfg.replace(num_layers=2, encoder_layers=2),
        tag="[whisper train]")
    return record, (step, state, batches[-1], mean_ms)


def phase_vlm(torch, swa_ops) -> dict:
    """phi-3-vision at full width and depth served through the serving
    CLI's prefill (tokens only, as the reference's) and greedy decode:
    one ``swa_attention`` launch per layer at hd 96 in the prefill, none
    in decode, decode against a fresh prefill; 2 layers on the card
    against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.utils.tree import tree_size

    run, chk = VLM_SERVE, VLM_CHECK
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    model, params, prompts = _init_served(torch, cfg, run["batch"],
                                          run["prompt"])
    n_params = tree_size(params)
    print(f"[vlm] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim_}, "
          f"vocab {cfg.vocab_size}, {cfg.num_patches} patches (training "
          f"only): {n_params / 1e9:.3f} B parameters (fp32, seed 0); "
          f"weights and prompts in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    row = _lm_run(torch, swa_ops, serve, model, params, prompts, run["gen"],
                  "served", tag="vlm")
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["head_dim"] = cfg.head_dim_
    print(f"[vlm] peak memory {row['peak_memory_gb']:.2f} GB")
    record = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
              "serve": row}
    small = build(cfg.replace(num_layers=chk["layers"]))
    record["card_vs_cpu"] = _card_vs_cpu(
        torch, serve, small, _first_layers(torch, params, chk["layers"]),
        prompts[:chk["batch"], :chk["prompt"]].contiguous(), gen=chk["gen"],
        tag="vlm")
    record["card_vs_cpu"]["layers"] = chk["layers"]
    return record


def _fused_ce_rows(torch, ce_ops, swa_ops, model, params, batch) -> int:
    """The rows (tokens) of the ``fused_ce`` call in one ``loss_fn`` of
    ``batch``: recorded by a wrapper around the loss's call, outside
    every counted run (the launch counters are put back)."""
    from repro_torch.models import transformer

    launches = (ce_ops.fused_ce.launches, swa_ops.swa_attention.launches)
    nll, rows = transformer.fused_ce_nll, []

    def recorded(x, table, labels):
        rows.append(x.shape[0])
        return nll(x, table, labels)

    transformer.fused_ce_nll = recorded
    try:
        model.loss_fn(params, batch)
        torch.cuda.synchronize()
    finally:
        transformer.fused_ce_nll = nll
        ce_ops.fused_ce.launches, swa_ops.swa_attention.launches = launches
    return rows[0]


def phase_vlm_train(torch, ce_ops, swa_ops) -> dict:
    """phi-3-vision at full width cut to VLM_TRAIN["layers"] layers
    through the training CLI's step, each agent's sequence 576 projected
    patches + 512 tokens: 2 ``fused_ce`` launches a step over the tokens
    alone (the prefix cropped), 2 ``swa_attention`` launches a layer
    (loss and probe) at hd 96; one 1-layer step on the card and the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    dev = torch.device("cuda", torch.cuda.current_device())
    run = VLM_TRAIN
    cfg = get_config(VLM_ARCH).replace(num_layers=run["layers"])
    record, step, state, batches, _ = _family_train(
        torch, ce_ops, swa_ops, cfg, run, "vlm train",
        swa_per_step=2 * run["layers"])
    one_agent = {k: v[0] for k, v in batches[0].items()}
    rows = _fused_ce_rows(torch, ce_ops, swa_ops, build(cfg), state.params,
                          one_agent)
    want = one_agent["tokens"].numel()
    seq = cfg.num_patches + one_agent["tokens"].shape[1]
    if rows != want:
        raise AssertionError(f"vlm train: fused_ce took {rows} rows, want "
                             f"the {want} text tokens (the {cfg.num_patches} "
                             f"patches cropped)")
    record["fused_ce_rows_per_agent"] = rows
    record["sequence_per_agent"] = seq
    # why the depth stays cut, with or without remat: the parameter-sized
    # trees of an m = 2 step (weights, 2 gradients, 2 EF memories, 2
    # lookahead probes) at full depth
    from repro_torch.utils.tree import tree_size

    per_layer = tree_size(state.params["blocks"]) / cfg.num_layers
    outside = record["params"] - per_layer * cfg.num_layers
    full_layers = get_config(VLM_ARCH).num_layers
    full_gb = (outside + per_layer * full_layers) * 4 / 1e9
    record["depth_reckoning"] = {"full_layers": full_layers,
                                 "params_gb_full_depth": full_gb,
                                 "trees": VLM_STATE_TREES}
    print(f"[vlm train] depth: {per_layer / 1e6:.1f} M parameters a layer, "
          f"{outside / 1e6:.1f} M outside them; at all {full_layers} layers "
          f"{full_gb:.2f} GB in fp32, × {VLM_STATE_TREES} parameter-sized "
          f"trees of an m = {run['agents']} step = "
          f"{VLM_STATE_TREES * full_gb:.1f} GB > 80 GB with or without "
          f"remat (which drops activations, not these): the depth stays "
          f"{cfg.num_layers}")
    print(f"[vlm train] the loss's fused_ce takes {rows} rows per agent: "
          f"the text tokens of a {seq}-position sequence, its "
          f"{cfg.num_patches} patch positions cropped")
    check_batch = _check_batch(batches)
    del step, state, batches
    torch.cuda.empty_cache()
    # one layer: at two the CPU step took 20.9 s, and [mesh] needed it
    record["card_vs_cpu"] = _train_card_vs_cpu(
        torch, cfg, check_batch, dev, small=cfg.replace(num_layers=1),
        tag="[vlm train]")
    return record


def _ranges(torch, module, name: str):
    """Wrap ``module.name`` so that each call is a profiler range that
    the device has finished (synchronized on entry and exit): the
    kernels a call launches run inside its range.  Returns the undo."""
    from torch.profiler import record_function

    fn = getattr(module, name)

    def ranged(*a, **k):
        torch.cuda.synchronize()
        with record_function(f"chip_smoke::{name}"):
            out = fn(*a, **k)
            torch.cuda.synchronize()
        return out

    setattr(module, name, ranged)
    return lambda: setattr(module, name, fn)


def _kernels(prof):
    """The device records (name, µs) of a trace without the device-side
    copies of the ``chip_smoke::`` ranges (a profiler range also shows
    on the device as an annotation spanning its kernels)."""
    return [(n, t) for n, t in _device_intervals(prof)
            if not n.startswith("chip_smoke::")]


def _in_ranges(prof, name: str):
    """The device kernels (name, µs) that ran inside the host ranges
    ``chip_smoke::name`` of a trace, and the ranges' count."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name == f"chip_smoke::{name}"
             and e.device_type == DeviceType.CPU]
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("chip_smoke::") and any(
                   a <= e.time_range.start and e.time_range.end <= b
                   for a, b in spans)]
    return kernels, len(spans)


GEMM_WORDS = ("gemm", "xmma", "cutlass", "cublas", "sm90_", "bmm")
DISPATCH_WORDS = ("sort", "scatter", "gather", "index", "cat", "copy",
                  "memcpy", "cumsum", "scan")


def phase_moe_profile(torch, served: dict) -> dict:
    """One prefill of [moe]'s served batch under torch.profiler, each
    MoE layer a synchronized range: the device time of the layers' expert
    products (GEMMs), of their dispatch (sort, scatters, gathers, copies)
    and of the rest of the layer, against the whole prefill's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    run = MOE_SERVE
    cfg = get_config(MOE_ARCH).replace(num_layers=run["layers"])
    model, params, prompts = _init_served(torch, cfg, run["batch"],
                                          run["prompt"])
    model.prefill(params, {"tokens": prompts}, cache_len=run["prompt"])
    torch.cuda.synchronize()
    undo = _ranges(torch, moe, "moe_layer")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill(params, {"tokens": prompts},
                          cache_len=run["prompt"])
            torch.cuda.synchronize()
    finally:
        undo()
    total = sum(t for _, t in _kernels(prof)) / 1e3
    kernels, calls = _in_ranges(prof, "moe_layer")
    if calls != cfg.num_layers or not kernels:
        raise AssertionError(f"moe profile: {calls} ranges, "
                             f"{len(kernels)} kernels in them")
    parts = {"experts_gemm": 0.0, "dispatch": 0.0, "other": 0.0}
    by_name: dict = {}
    for n, t in kernels:
        low = n.lower()
        key = ("experts_gemm" if any(w in low for w in GEMM_WORDS) else
               "dispatch" if any(w in low for w in DISPATCH_WORDS) else
               "other")
        parts[key] += t / 1e3
        by_name[n] = by_name.get(n, 0.0) + t / 1e3
    moe_ms = sum(parts.values())
    record = {"prefill_device_ms": total, "moe_device_ms": moe_ms,
              **{f"{k}_ms": v for k, v in parts.items()},
              **{f"{k}_share_of_prefill": v / total
                 for k, v in parts.items()},
              "prefill_ms_unprofiled": served["prefill_ms"],
              "moe_top": [{"name": n, "ms": t} for n, t in sorted(
                  by_name.items(), key=lambda kv: -kv[1])[:8]]}
    print(f"[profile] moe prefill: {total:.3f} ms on the device; the "
          f"{calls} MoE layers {moe_ms:.3f} ms: expert GEMMs "
          f"{parts['experts_gemm']:.3f} ({parts['experts_gemm'] / total:.1%}"
          f" of the prefill), dispatch {parts['dispatch']:.3f} "
          f"({parts['dispatch'] / total:.2%}), other {parts['other']:.3f} "
          f"({parts['other'] / total:.2%}); unprofiled prefill "
          f"{served['prefill_ms']:.2f} ms")
    for item in record["moe_top"]:
        print(f"[profile]   moe {item['ms']:9.3f} ms  {item['name'][:90]}")
    return record


def phase_hybrid_profile(torch, step, state, batch, step_ms: float,
                         train: dict) -> dict:
    """One [hybrid train] step under torch.profiler with each SSD call a
    synchronized range: the SSD forward's device time against the
    step's (its backward runs in the autograd engine, outside the
    ranges); then one SSD call's forward and forward + backward at the
    step's shapes timed alone (``device_ms``), the SSD's share of the
    step estimated from them; and the peak memory against the
    parameter-sized trees and the decay tiles."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    cfg_layers = train["layers"]
    undo = _ranges(torch, ssm, "ssd_chunked")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    ivals = _kernels(prof)
    busy = sum(t for _, t in ivals) / 1e3
    kernels, calls = _in_ranges(prof, "ssd_chunked")
    ssd_fwd_ms = sum(t for _, t in kernels) / 1e3
    # one SSD call at the step's shapes: b = 1 per agent, vmapped over m
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_ARCH)
    s = cfg.ssm
    agents, seq = train["agents"], train["seq"]
    heads = s.expand * cfg.d_model // s.head_dim
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xh = rnd(agents, 1, seq, heads, s.head_dim)
    dt = torch.nn.functional.softplus(rnd(agents, 1, seq, heads))
    A = -torch.exp(rnd(heads) * 0.5)
    B, C = rnd(agents, 1, seq, s.state_dim), rnd(agents, 1, seq, s.state_dim)
    w = rnd(agents, 1, seq, heads, s.head_dim)

    def loss(xh, dt, B, C, w):
        y, _ = ssm.ssd_chunked(xh, dt, A, B, C, s.chunk_size)
        return (y * w).sum()

    fwd = torch.func.vmap(loss)
    fwd_bwd = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3)))
    t_f = device_ms(torch, lambda: fwd(xh, dt, B, C, w), calls=5)
    t_fb = device_ms(torch, lambda: fwd_bwd(xh, dt, B, C, w), calls=5)
    # per step: each layer's SSD forward + backward (the loss) and forward
    # (the probe)
    est = cfg_layers * (t_fb + t_f)
    chunks = seq // s.chunk_size if seq % s.chunk_size == 0 else 1
    L = s.chunk_size if seq % s.chunk_size == 0 else seq
    tile_gb = agents * L * L * heads * 4 / 1e9
    p_gb = train["params"] * 4 / 1e9
    record = {"step_device_ms": busy, "device_ops": len(ivals),
              "step_ms_unprofiled": step_ms, "step_ms_profiled": wall_ms,
              "idle_share": 1.0 - busy / step_ms,
              "ssd_calls": calls, "ssd_forward_device_ms": ssd_fwd_ms,
              "ssd_forward_share": ssd_fwd_ms / busy,
              "ssd_call_forward_ms": t_f, "ssd_call_fwd_bwd_ms": t_fb,
              "ssd_share_estimated": est / busy,
              "decay_tile_gb": tile_gb, "chunks": chunks,
              "params_gb": p_gb, "peak_memory_gb": train["peak_memory_gb"]}
    print(f"[profile] hybrid train step: {busy:.2f} ms on the device in "
          f"{len(ivals)} device ops against the unprofiled {step_ms:.2f} ms "
          f"-> idle share {record['idle_share']:.3f} (the profiled step, "
          f"its SSD calls synchronized, {wall_ms:.2f} ms); SSD forward "
          f"{ssd_fwd_ms:.2f} ms in {calls} calls "
          f"({record['ssd_forward_share']:.1%}); one SSD call alone "
          f"(m = {agents}, S {seq}): forward {t_f:.3f} ms, forward + "
          f"backward {t_fb:.3f} ms -> the SSD's share of the step "
          f"≈ {cfg_layers} × ({t_fb:.3f} + {t_f:.3f}) / {busy:.2f} = "
          f"{record['ssd_share_estimated']:.1%}")
    print(f"[profile] hybrid train memory: peak {train['peak_memory_gb']:.2f}"
          f" GB; the parameters {p_gb:.2f} GB (× m = {agents} per "
          f"per-agent tree); one (m, L, L, h) decay tile {tile_gb * 1e3:.1f}"
          f" MB per chunk ({chunks} chunks × {cfg_layers} layers: "
          f"{tile_gb * chunks * cfg_layers:.2f} GB per tile kept)")
    return record


def ce_bound(ce_ops, t: int, d: int, v: int, dtype):
    """The bounds of :func:`path_bounds` for one call of the kernel's
    cost record: 2·T·D·V flops and the online logsumexp's, x and the
    table read once, the int64 labels read and the fp32 NLL and
    logsumexp written once."""
    work = ce_ops.cost(1, t, d, v, dtype)
    return path_bounds(work), work["flops"], work["hbm_bytes"]


def phase_ce_times(torch, ce_ops, ce_ref) -> list:
    """Per timed shape and dtype: the kernel, its plain version and
    ``F.cross_entropy`` over ``x @ table.T`` (timed only, never on the
    path), per call by CUDA events and on the device by the profiler,
    beside the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for t, d, v in CE_TIMED:
        # bf16 too at every shape but [mesh]'s losses (their jobs run
        # in fp32)
        dtypes = ((torch.float32,) if (t, d, v) in CE_TIMED[4:]
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            x, table, labels = _ce_inputs(torch, gen, t, d, v, dtype)
            fns = {
                "": lambda x=x, w=table, y=labels: ce_ops.fused_ce_nll(x, w, y),
                "plain_": lambda x=x, w=table, y=labels: ce_ref.fused_ce_ref(
                    x, w, y),
                "library_": lambda x=x, w=table, y=labels: F.cross_entropy(
                    x @ w.T, y, reduction="none"),
            }
            lib_err = (fns["library_"]().float()
                       - fns["plain_"]()).abs().max().item()
            bounds, flops, nbytes = ce_bound(ce_ops, t, d, v, dtype)
            row = {"shape": [t, d, v], "dtype": _dtype_name(dtype),
                   "path": ce_ops.PATHS[dtype], "flops": flops,
                   "bytes": nbytes, **bounds, "library_max_abs_err": lib_err}
            before = ce_ops.fused_ce.launches
            for key, fn in fns.items():
                row[f"{key}ms"] = time_ms(fn, CE_TIMED_RUNS)
            for key, fn in fns.items():
                # one launch runs the vocab-split partials, then the combine
                row[f"{key}device_ms"] = device_ms(
                    torch, fn, kernel=None if key else (
                        ce_ops.fused_ce, "fused_ce", 2))
                row[f"{key}device_records"] = dict(device_ms.last)
            ce_ops.fused_ce.launches = before  # timing launches do not count
            _shares(row)
            rows.append(row)
            print(f"[ce times] ({t}, {d}, {v}) {row['dtype']} "
                  f"({row['path']}): per call (events) kernel "
                  f"{row['ms']:.3f} / plain {row['plain_ms']:.3f} / "
                  f"F.cross_entropy {row['library_ms']:.3f} ms; on the "
                  f"device kernel {row['device_ms']:.3f} / plain "
                  f"{row['plain_device_ms']:.3f} / F.cross_entropy "
                  f"{row['library_device_ms']:.3f} ms; {_share_text(row)}; "
                  f"library vs plain {lib_err:.2e}")
            del x, table, labels, fns
            torch.cuda.empty_cache()
    return rows


def phase_train_profile(torch, step, state, batch, step_ms: float,
                        label: str = "train") -> dict:
    """One train step under torch.profiler: device time by kernel
    (the kernels, the backward's and the model's cuBLAS products, the
    elementwise ops), device ops and the idle share against the
    unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    ivals = _device_intervals(prof)
    if not ivals:
        raise AssertionError("the profiler saw no device activity")
    busy = sum(t for _, t in ivals) / 1e3
    by_name: dict = {}
    for n, t in ivals:
        ms, c = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + t / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    kernel_ms = {k: sum(ms for n, (ms, _) in by_name.items() if k in n)
                 for k in ("fused_ce", "swa_attention")}
    gemm_ms = sum(ms for n, (ms, _) in by_name.items()
                  if "gemm" in n.lower() or "xmma" in n.lower())
    record = {"device_ms": busy, "device_ops": len(ivals),
              "step_ms_unprofiled": step_ms,
              "idle_share": 1.0 - busy / step_ms,
              "kernel_device_ms": kernel_ms, "gemm_device_ms": gemm_ms,
              "top": [{"name": n, "ms": ms, "count": c}
                      for n, (ms, c) in top]}
    print(f"[profile] {label} step: {busy:.2f} ms on the device in "
          f"{len(ivals)} device ops against the unprofiled {step_ms:.2f} ms "
          f"-> idle share {record['idle_share']:.3f}; fused_ce "
          f"{kernel_ms['fused_ce']:.2f} ms, swa_attention "
          f"{kernel_ms['swa_attention']:.2f} ms, GEMMs {gemm_ms:.2f} ms")
    for n, (ms, c) in top:
        print(f"[profile]   {label} {ms:9.3f} ms x{c:<5d} {n[:90]}")
    return record


def _device_intervals(prof):
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def phase_lm_profile(torch, model, params, prompts, run: dict) -> dict:
    """One prefill and LM_PROFILED_STEPS decode steps of LM run (a) under
    torch.profiler: the kernel's share of the prefill's device time, and
    the device's idle share against the unprofiled times of run (a)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    b, s = prompts.shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        toks, _, cache = serve.prefill_prompt(
            model, params, prompts, s + LM_PROFILED_STEPS + 8)
        torch.cuda.synchronize()
    pre = _device_intervals(prof)
    with profile(activities=acts) as prof:
        serve.decode_tokens(model, params, cache, toks, s, LM_PROFILED_STEPS)
        torch.cuda.synchronize()
    dec = _device_intervals(prof)
    if not pre or not dec:
        raise AssertionError("the profiler saw no device activity")
    pre_ms = sum(t for _, t in pre) / 1e3
    swa_ms = sum(t for n, t in pre if "swa_attention" in n) / 1e3
    swa_calls = sum(1 for n, _ in pre if "swa_attention" in n)
    if swa_calls != model.cfg.num_layers:
        raise AssertionError(f"profiled prefill ran {swa_calls} "
                             f"swa_attention kernels")
    by_name: dict = {}
    for n, t in pre:
        by_name[n] = by_name.get(n, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    dec_busy = sum(t for _, t in dec) / 1e3 / LM_PROFILED_STEPS
    record = {
        "prefill_device_ms": pre_ms, "swa_device_ms": swa_ms,
        "swa_share_of_prefill": swa_ms / pre_ms,
        "prefill_idle_share": 1.0 - pre_ms / run["prefill_ms"],
        "decode_device_ops_per_step": len(dec) / LM_PROFILED_STEPS,
        "decode_busy_ms_per_step": dec_busy,
        "decode_idle_share": 1.0 - dec_busy / run["decode_ms_per_step"],
        "prefill_top": [{"name": n, "ms": t / 1e3} for n, t in top],
    }
    print(f"[profile] LM (a) prefill: {pre_ms:.3f} ms on the device, "
          f"swa_attention {swa_ms:.3f} ms in {swa_calls} launches = "
          f"{record['swa_share_of_prefill']:.1%}; idle share "
          f"{record['prefill_idle_share']:.3f} against the unprofiled "
          f"{run['prefill_ms']:.2f} ms")
    for n, t in top:
        print(f"[profile]   prefill {t / 1e3:.4f} ms  {n[:90]}")
    print(f"[profile] LM (a) decode: {record['decode_device_ops_per_step']:.0f}"
          f" device ops and {dec_busy:.4f} ms busy per step against the "
          f"unprofiled {run['decode_ms_per_step']:.3f} ms -> idle share "
          f"{record['decode_idle_share']:.3f}")
    return record


# wall seconds of each phase function in this run (every ``phase_*``
# timed; a phase that calls another counts it too)
PHASE_SECONDS: dict = {}


def _timed(fn):
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        PHASE_SECONDS[fn.__name__] = (PHASE_SECONDS.get(fn.__name__, 0.0)
                                      + time.perf_counter() - t0)
        return out

    return run


def main() -> int:
    import torch

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = _timed(fn)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if MESH_ONLY or not MESH_HOLD:
        print("chip_smoke: [mesh] runs every job, each held to the "
              "single-process step", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # full-precision fp32 products and convolutions on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.gain_reduce import ops as gr_ops
    from repro_torch.kernels.gain_reduce import ref
    from repro_torch.kernels.fused_ce import ops as ce_ops
    from repro_torch.kernels.fused_ce import ref as ce_ref
    from repro_torch.kernels.swa_attention import ops as swa_ops
    from repro_torch.kernels.swa_attention import ref as swa_ref

    card = nvidia_smi()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    record = {"card": card,
              "build": phase_build(gr_ops, swa_ops, ce_ops)}
    record["kernel_checks"] = phase_kernel(torch, gr_ops, ref)
    session, record["slice"] = phase_slice(torch, gr_ops)
    record["fleet_adaptive"], adaptive = phase_fleet_adaptive(
        torch, record["slice"]["rounds_per_s"])
    record["random"] = phase_random(torch)
    record["fleet_lossy"], lossy, lossy_ms = phase_fleet_lossy(
        torch, record["fleet_adaptive"]["rounds_per_s"])
    record["fleet_lossy_quadratic"] = phase_fleet_lossy_quadratic(torch,
                                                                  gr_ops)
    record["fleet_delayed"], unchurned = phase_fleet_delayed(torch)
    record["fleet_churn"] = phase_fleet_churn(torch, unchurned)
    record["dispatch"] = phase_dispatch(torch, gr_ops)
    record["frontier"] = phase_frontier(torch)
    record["frontier_quadratic"], quad_run = phase_frontier_quadratic(
        torch, gr_ops)
    record["frontier_lossy"] = phase_frontier_lossy(torch)
    record["frontier_drifting"] = phase_frontier_drifting(torch)
    record["shard"] = phase_shard(torch, card, {
        "slice": record["slice"]["rounds_per_s"],
        "fleet_lossy": record["fleet_lossy"]["rounds_per_s"],
        "frontier_quadratic": record["frontier_quadratic"]["rounds_per_s"]})
    record["mesh"], record["mesh_serve"] = phase_mesh(torch, card)
    record["durable"] = phase_durable(torch, gr_ops)
    record["kill"] = phase_kill(torch)
    record["telemetry"] = phase_telemetry(torch)
    record["sim"], sim_run = phase_sim(torch)
    record["swa_checks"] = phase_swa_kernel(torch, swa_ops, swa_ref)
    record["ce_checks"] = phase_ce_kernel(torch, ce_ops, ce_ref)
    record["lm"], lm_model, lm_params, lm_prompts = phase_lm(torch, swa_ops)
    from repro_torch.configs import get_config

    dev = torch.device("cuda", torch.cuda.current_device())
    record["train"], (step, state, batches, step_ms) = phase_train(
        torch, ce_ops, swa_ops, get_config(LM_ARCH), dev)
    record["dryrun"] = phase_dryrun(torch, ce_ops, swa_ops,
                                    get_config(LM_ARCH), dev, step, state,
                                    batches[0], record["train"]["ms_per_step"],
                                    card)
    record["train_quadratic"] = phase_train_quadratic(
        torch, ce_ops, swa_ops, get_config(LM_ARCH), dev, batches)
    record["remat"], remat_base = phase_remat(
        torch, ce_ops, swa_ops, get_config(LM_ARCH), dev, batches[0])
    record["microbatch"] = phase_microbatch(
        torch, ce_ops, swa_ops, get_config(LM_ARCH), dev, batches[0],
        remat_base)
    del remat_base
    torch.cuda.empty_cache()
    record["train_resume"] = phase_train_resume(torch, ce_ops, swa_ops)
    record["moe"] = phase_moe(torch, swa_ops)
    record["moe_train"] = phase_moe_train(torch, ce_ops, swa_ops)
    record["hybrid"] = phase_hybrid(torch, swa_ops)
    record["hybrid_train"], hybrid_run = phase_hybrid_train(torch, ce_ops,
                                                            swa_ops)
    record["xlstm"], xlstm_run = phase_xlstm(torch, swa_ops)
    record["xlstm_train"] = phase_xlstm_train(torch, ce_ops, swa_ops)
    record["whisper"] = phase_whisper(torch, swa_ops)
    record["vlm"] = phase_vlm(torch, swa_ops)
    record["vlm_train"] = phase_vlm_train(torch, ce_ops, swa_ops)
    torch.cuda.empty_cache()
    record["whisper_train"], whisper_run = phase_whisper_train(
        torch, ce_ops, swa_ops)
    # the profiler runs last: its callbacks slow every later host dispatch
    record["times"] = phase_times(torch, gr_ops, ref)
    record["launch_floor"] = phase_launch_floor(torch, gr_ops,
                                                record["times"])
    record["swa_times"] = phase_swa_times(torch, swa_ops, swa_ref)
    record["ce_times"] = phase_ce_times(torch, ce_ops, ce_ref)
    record["profile"] = phase_profile(
        torch, session, 1e3 / record["slice"]["rounds_per_s"])
    record["profile_checked"] = {
        "slice": phase_fleet_profile(
            torch, session, 1e3 / record["slice"]["rounds_per_s"], "slice"),
        "fleet_adaptive": phase_fleet_profile(
            torch, adaptive, 1e3 / record["fleet_adaptive"]["rounds_per_s"],
            "fleet adaptive"),
        "fleet_lossy": phase_fleet_profile(torch, lossy, lossy_ms,
                                           "fleet lossy"),
        "frontier": phase_frontier_profile(
            torch, quad_run, _frontier_problem(torch, dev)[1]),
    }
    record["lm_profile"] = phase_lm_profile(
        torch, lm_model, lm_params, lm_prompts, record["lm"]["a"])
    record["train_profile"] = phase_train_profile(torch, step, state,
                                                  batches[-1], step_ms)
    record["sim_profile"] = phase_sim_profile(torch, *sim_run)
    record["hybrid_profile"] = phase_hybrid_profile(torch, *hybrid_run)
    del hybrid_run
    record["xlstm_profile"] = phase_decode_profile(torch, *xlstm_run,
                                                   label="xlstm")
    record["whisper_train_profile"] = phase_train_profile(
        torch, *whisper_run, label="whisper train")
    del xlstm_run, whisper_run
    torch.cuda.empty_cache()
    record["moe_profile"] = phase_moe_profile(torch, record["moe"]["serve"])
    record["seconds"] = time.perf_counter() - t_start
    record["phase_seconds"] = dict(PHASE_SECONDS)
    print("[times] phase seconds: " + ", ".join(
        f"{k[6:]} {v:.1f}" for k, v in sorted(
            PHASE_SECONDS.items(), key=lambda kv: -kv[1])))

    main_shape = record["times"][0]
    assert main_shape["shape"] == [64, 32] and main_shape["dtype"] == "float32"
    main_check = record["kernel_checks"][0]
    # the quadratic frontier's one launch per round: 16 lanes × 64 rows
    frontier_shape = next(r for r in record["times"]
                          if r["shape"] == [1024, 32]
                          and r["dtype"] == "float32")
    kernels = {"kernels": [{
        "name": "gain_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/gain_reduce/csrc/gain_reduce.cu",
        "replaces": "src/repro/kernels/gain_reduce/kernel.py:44",
        "launches": record["slice"]["launches"],
        "max_abs_err": main_check["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "path": "fp32-fma",
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "device_ms": main_shape["device_ms"],
        "plain_device_ms": main_shape["plain_device_ms"],
        "library_device_ms": main_shape["library_device_ms"],
        "shape": main_shape["shape"],
        "dtype": main_shape["dtype"],
        "launch_floor_device_ms": record["launch_floor"]["empty_device_ms"],
        "hbm_share_1x2p26": record["launch_floor"]["hbm_share_1x2p26"],
        "launches_frontier": record["frontier_quadratic"]["launches"],
        "launches_shard_per_rank": record["shard"]["quadratic"][
            "launches_per_rank"],
        "launches_shard_frontier_per_rank": record["shard"]["frontier"][
            "launches_per_rank"],
        "launches_durable": record["durable"]["launches"],
        "frontier": {k: frontier_shape[k] for k in (
            "shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "plain_device_ms",
            "library_device_ms")},
    }]}
    # swa_attention at LM run (a)'s shape and dtype: what its prefill runs
    swa_time = record["swa_times"][0]
    swa_check = record["swa_checks"][0]
    assert swa_time["shape"] == swa_check["shape"] == list(SWA_SERVED[0][:5])
    assert swa_time["dtype"] == swa_check["dtype"] == "float32"
    kernels["kernels"].append({
        "name": "swa_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/swa_attention/csrc/"
                  "swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention/kernel.py:81",
        "launches": record["lm"]["a"]["launches"],
        "max_abs_err": swa_check["max_abs_err"],
        "ms": swa_time["ms"],
        "plain_ms": swa_time["plain_ms"],
        "path": swa_time["path"],
        "bound_ms": swa_time["bound_ms"],
        "bound_by": swa_time["bound_by"],
        "library_ms": swa_time["library_ms"],
        "device_ms": swa_time["device_ms"],
        "plain_device_ms": swa_time["plain_device_ms"],
        "library_device_ms": swa_time["library_device_ms"],
        "shape": swa_time["shape"],
        "window": swa_time["window"],
        "dtype": swa_time["dtype"],
        "launches_long_context": record["lm"]["b"]["launches"],
        "launches_train": record["train"]["launches"]["swa_attention"],
        "launches_train_resume": record["train_resume"]["launches_resumed"][
            "swa_attention"],
        "launches_moe": record["moe"]["serve"]["launches"],
        "launches_moe_train": record["moe_train"]["launches"][
            "swa_attention"],
        "launches_hybrid": record["hybrid"]["serve"]["launches"],
        "launches_hybrid_train": record["hybrid_train"]["launches"][
            "swa_attention"],
        "launches_hybrid_train_full_remat": record["hybrid_train"][
            "full_depth_remat"]["launches"]["swa_attention"],
        "launches_remat": record["remat"]["lookahead"]["remat_True"][
            "launches"]["swa_attention"],
        "launches_remat_quadratic": record["remat"]["quadratic"][
            "remat_True"]["launches"]["swa_attention"],
        "launches_microbatch": record["microbatch"][
            "microbatches_2_remat_False"]["launches"]["swa_attention"],
        "launches_microbatch_remat": record["microbatch"][
            "microbatches_2_remat_True"]["launches"]["swa_attention"],
        "launches_whisper_train_remat": record["whisper_train"]["remat"][
            "launches"]["swa_attention"],
        "launches_xlstm": record["xlstm"]["serve"]["launches"],
        "launches_whisper": record["whisper"]["serve"]["launches"],
        "launches_whisper_train": record["whisper_train"]["launches"][
            "swa_attention"],
        "launches_vlm": record["vlm"]["serve"]["launches"],
        "launches_vlm_train": record["vlm_train"]["launches"][
            "swa_attention"],
        "launches_mesh_per_rank_step": {
            job: row["launches_per_step"][0]
            for job, row in record["mesh"]["jobs"].items()},
        "launches_mesh_serve_per_rank": {
            f"{run} {layout}": {"prefill": row["launches_prefill"],
                                "decode_step": row["launches_step"]}
            for run, rec in record["mesh_serve"]["runs"].items()
            for layout, row in rec["layouts"].items()},
        "mesh_local_heads": {k: r[k] for r in record["swa_times"]
                             if r["shape"] == list(SWA_SERVED[-1][:5])
                             and r["dtype"] == "float32"
                             for k in ("shape", "window", "dtype", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "device_ms")},
        # the head dims added since the first instances (64, 128): each
        # served shape's fp32 time row
        "head_dims": {str(r["shape"][4]): {k: r[k] for k in (
            "shape", "window", "dtype", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "device_ms")}
            for r in record["swa_times"]
            if r["shape"] in (list(SWA_SERVED[4][:5]),
                              list(SWA_SERVED[5][:5]))
            and r["dtype"] == "float32"},
        # the moe, vlm and hybrid [mesh] ranks' heads
        "mesh_family_heads": [{k: r[k] for k in (
            "shape", "window", "dtype", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "device_ms")}
            for r in record["swa_times"]
            if r["shape"] in [list(x[:5]) for x in SWA_SERVED[6:9]]],
    })
    # fused_ce at the train step's token count, width and vocabulary
    ce_time = record["ce_times"][0]
    ce_check = next(r for r in record["ce_checks"]
                    if r.get("shape") == ce_time["shape"]
                    and r["dtype"] == ce_time["dtype"])
    assert ce_time["shape"] == list(CE_TIMED[0])
    assert ce_time["dtype"] == "float32"
    kernels["kernels"].append({
        "name": "fused_ce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_ce/csrc/fused_ce.cu",
        "replaces": "src/repro/kernels/fused_ce/kernel.py:76",
        "launches": record["train"]["launches"]["fused_ce"],
        "launches_train_resume": record["train_resume"]["launches_resumed"][
            "fused_ce"],
        "launches_moe_train": record["moe_train"]["launches"]["fused_ce"],
        "launches_hybrid_train": record["hybrid_train"]["launches"][
            "fused_ce"],
        "launches_hybrid_train_full_remat": record["hybrid_train"][
            "full_depth_remat"]["launches"]["fused_ce"],
        "launches_remat": record["remat"]["lookahead"]["remat_True"][
            "launches"]["fused_ce"],
        "launches_microbatch": record["microbatch"][
            "microbatches_2_remat_False"]["launches"]["fused_ce"],
        "launches_xlstm_train": record["xlstm_train"]["launches"][
            "fused_ce"],
        "launches_whisper_train": record["whisper_train"]["launches"][
            "fused_ce"],
        "launches_vlm_train": record["vlm_train"]["launches"]["fused_ce"],
        "launches_mesh_per_rank_step": {
            job: row["launches_per_step"][1]
            for job, row in record["mesh"]["jobs"].items()},
        "mesh_vocab_block": {k: r[k] for r in record["ce_times"]
                             if r["shape"] == list(CE_TIMED[4])
                             and r["dtype"] == "float32"
                             for k in ("shape", "dtype", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "device_ms")},
        # the moe, vlm, audio, hybrid and ssm [mesh] ranks' losses
        "mesh_family_losses": [{k: r[k] for k in (
            "shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms")} for r in record["ce_times"]
            if r["shape"] in [list(x) for x in CE_TIMED[5:]]],
        "max_abs_err": ce_check["max_abs_err"],
        "ms": ce_time["ms"],
        "plain_ms": ce_time["plain_ms"],
        "path": ce_time["path"],
        "bound_ms": ce_time["bound_ms"],
        "bound_by": ce_time["bound_by"],
        "library_ms": ce_time["library_ms"],
        "device_ms": ce_time["device_ms"],
        "plain_device_ms": ce_time["plain_device_ms"],
        "library_device_ms": ce_time["library_device_ms"],
        "shape": ce_time["shape"],
        "dtype": ce_time["dtype"],
    })
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=2))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
