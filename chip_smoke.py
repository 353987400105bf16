#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py [--prev DIR]

Needs one NVIDIA H100 (sm_90a) and nvcc.  With --prev, DIR holds the
parent tree's kernel sources (csrc/): its fleet_route, wwl_route and
maxweight kernels are built with the same flags, held against the plain
versions and timed beside this tree's on the same inputs, the fleet
slots/s is measured with each fleet_route in turn, and its float32
flash_attention and ssd kernels (CUDA cores) are timed beside this
tree's at the float32 rows of phases 3b and 3c.  Phases, each fatal
on failure:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: every kernel source under src/repro_torch/kernels/csrc/ with
   nvcc, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   outputs equal bit for bit, kernel and plain times by CUDA events, and
   the bound: `fleet_route`, `wwl_route` and `maxweight_claim` at the
   fleet shapes (M = 10008, B = 5474, depths 0, 1 and 2, tie-heavy
   inputs, and ragged group sizes, racks of 4 and 8 and pods of 12 and
   24, depths 1 and 2), with device times by `torch.profiler` (for
   `wwl_route` and `maxweight_claim`, the sum of a call's two
   launches, issued in stream order, and each launch's own);
   `wwl_route` and `maxweight_claim` also on the D=1 and D=2 tables with
   their columns permuted, and `maxweight_claim` at near-ties (queue
   lengths one float apart whose products round equal); each call's
   launch count must move by one, and each must take the
   group-restricted path on a sorted table and the all-pairs path on a
   permuted one (read from the kernel's flag after the call); then
   `fleet_route` with a cell axis at the D = 1 fleet shape for N = 1, 8
   and 30 cells: bit for bit against the plain version and against N
   one-cell launches, one launch a call, device time beside N x the
   one-cell time, and the bound (with --prev, the parent's one-cell
   kernel at N = 1);
4. the fleet slice: `simulate("balanced_pandas", ...)` at M = 10008,
   rho = 0.8 (auto-engages the fleet path), with every launch count set
   to 0 just before and read just after; then 128 slots with the kernel
   on and off must leave an identical carry;
5. fleet profile: steady-state slots/s (with --prev, also this tree's
   fleet_route and the parent's in turn), and the device's busy share
   and time by kernel over a window of slots under `torch.profiler`;
5b. the fleet study: `run_study(fleet=True)` for Balanced-PANDAS and
   power-of-d at phase 4's configuration, loads 0.6/0.8/0.95 x exact and
   "per_server" eps 0.1/0.3 of both signs x seeds 0-1 (30 cells, one
   batch per arm), counts set to 0 before each and read after
   (fleet_route = rounds x horizon for Balanced-PANDAS whatever the
   cell count, 0 for power-of-d); fatal: delays not finite, a cell's
   throughput at loads 0.6 and 0.8 off lam by more than 2%, a sampled
   cell per arm unequal to `simulate` of that cell; cell-slots/s beside
   phase 5's one-cell slots/s, and a profiled window of the batched
   Balanced-PANDAS step at the 30 cells;
6. the dense study, counts set to 0 before and read after (fatal if a
   kernel launched): the paper's robustness study through `run_study`
   for all five policies on the dense path (Topology(24, 6), horizon
   600, loads 0.6/0.8/0.95, eps 0.1/0.3 both signs, 8 seeds), with its
   fatal checks (finite delays, throughput within 2% of lam at loads 0.6
   and 0.8 for all but FIFO, Balanced-PANDAS at or below JSQ-MaxWeight
   at 0.95 with exact rates) and the headline claims (printed); the
   quickstart's `ops.wwl_route` at M = 1024, B = 128 runs in 21a;
7. the kernel bench path (benchmarks/bench_kernels.py at full width),
   counts set to 0 before and read after: `ops.wwl_route` and
   `ops.maxweight_claim` at M = N = 65536, B = 8192 with the legacy rack
   map, against their plain versions (group-restricted path), then
   timed by events and on the device a call (with --prev, the parent's
   all-pairs kernels beside them);
8. dense loop: every registered policy's slot loop (Blind-PANDAS and
   SLO-PANDAS too) and the batched fleet steps of Balanced-PANDAS and
   power-of-d at the fleet study's 30 cells under
   `torch.cuda.set_sync_debug_mode("error")` (no host sync), and a
   profiled window of the Balanced-PANDAS dense step;
3b. (run after 8) flash_attention: the bf16 kernel's ptxas summary
   (registers, shared memory, spills) and its `HGMMA` count in the
   built library's SASS (fatal if 0: bf16 must run on the tensor
   cores), the same for every float32 tensor-core instantiation (split
   TF32, fatal at 0), and the TF32 probe (what one `wgmma` .tf32 makes
   of a raw float32 operand, and a split product's error; fatal if
   neither is as expected); the CUDA kernels against their plain version
   `ref.mha` at the 8 cases of tests/test_kernels_attention.py in
   float32 (atol/rtol 2e-5) and bf16 (2e-2, and every row within 1% of
   its largest value); then in bf16 at the serving slice's prefill shape
   of every bucket (B 1, Hq 32, Hkv 2, T 32/64/128, D 128, causal) and
   at T = 8192, each timed beside its plain version, one
   `scaled_dot_product_attention` call (the library yardstick, used
   nowhere in the port) and its bound, with the share of the bound
   reached, the kernel's device time by `torch.profiler` at the serving
   shapes (where CUDA events time the host's enqueue) and the host time
   of encoding the TMA tensor maps; then float32 at the launcher's
   shape, chatglm3-6b's full-width prefill (T 128), T = 8192 and the 8
   cases, on the attention layer's strided views, each held to 2e-5 and
   timed by events and on the device beside its plain version, SDPA and
   its bound (and, with --prev, the parent's CUDA-core kernel on the
   same inputs, its error recorded); granite-moe-1b's bf16 prefill shape
   at every bucket (B 1, Hq 16, Hkv 8, D 64) timed as chatglm3-6b's;
   then each kernel (bf16 and float32 on the tensor cores, float32 on
   the CUDA cores) at D = 16 through the wrapper's `_launch(code)`:
   the 8 cases at D = 16 held as above, and B 1, H 4/4, T 128 timed;
9. the serving slice: chatglm3-6b at full width (28 layers, d_model
   4096, bf16, random weights from a seed) through
   `ServingEngine.run_until_drained` with the `EngineConfig()` defaults
   (4 replicas in 2 pods, 4 slots each, buckets 32/64/128,
   Balanced-PANDAS): 16 requests of 24-120 prompt tokens and 16 new
   tokens, counts set to 0 before and read after (flash_attention = 28
   x prefills), every logits tensor finite; one prefill through
   impl="pallas" against impl="xla" (last real row within 3.5% of its
   largest logit; the same weights in float32 within
   `SERVE_F32_LOGIT_TOL`, and a deliberately wrong attention, one key
   past the causal edge, must read beyond that limit), each forward free
   of host syncs (sync debug mode "error"); prefill ms, decode tokens/s
   and the device's busy share over a profiled window of decode steps;
3c. (run after 9) ssd: the bf16 and the float32 tensor-core kernels'
   ptxas summaries and `HGMMA` counts per instantiation (fatal at 0);
   the CUDA SSD scan against its plain version `ref.ssd` at the 4 cases
   of tests/test_kernels_ssd.py in float32 (atol/rtol 3e-4) and bf16
   (3e-2, and every row within 1% of its largest value; the final
   state, float32, within 3e-4), two calls threaded through
   `init_state` against one, bf16 at T = 1, 17 and 129 from a nonzero
   state at mamba2-1.3b's head widths, then in bf16 at its prefill shape
   of every bucket (B 1, T 32/64/128, H 64, P 64, N 128) and at T =
   8192, each timed beside its plain version and the recurrent kernel
   (by CUDA events and, by `torch.profiler`, on the device), with its
   bound; then float32 at the launcher's shape, the full-width prefill
   (T 128), T = 8192 and the 4 cases, b and c as views into one buffer,
   held to 3e-4 and timed beside the recurrent kernel, the plain version
   and the bound (and, with --prev, the parent's recurrent kernel);
11. the Mamba serving slice: mamba2-1.3b at full width (48 layers,
   d_model 2048, bf16, random weights from a seed) through the same
   engine, defaults and 16 requests as phase 9: ssd = 48 x prefills,
   flash_attention 0, every logits tensor finite, every request drained
   with 17 tokens; one prefill through impl="pallas_ssd" against
   impl="xla" (last real row within `MAMBA_LOGIT_TOL` of its largest
   logit in bf16, and within `MAMBA_F32_LOGIT_TOL` for the same weights
   in float32), each forward free of host syncs; the drained run's
   tokens/s with `ssd` on the tensor cores and on the recurrent kernel
   in turn; prefill ms, decode tokens/s and the device's busy share over
   a profiled decode window;
10. the launcher: `python -m repro_torch.launch.serve` with its
   defaults (the smoke config, on the card), then with `--arch
   mamba2_13b`, counts set to 0 before and read after each; then at the
   largest shape the launcher gave the float32 `flash_attention` and
   `ssd`, one call must be one launch of the float32 tensor-core kernel
   and nothing else (`torch.profiler`'s record of the host's runtime
   calls: no copy, no set, every recorded device activity that kernel),
   and each is held against its plain version and timed by events and on
   the device, with the bound (and SDPA for attention); then `--arch
   granite_moe_1b --requests 4` (the reference's serving CLI test) and
   `--arch mixtral_8x22b --requests 4`: flash_attention = layers x 4,
   and their float32 D = 16 and D = 8 calls checked and timed the same
   way;
12. the scenario slice.  (a, run after 8) the drift study
   (examples/drift_study.py: `drift_study` over the 7 DRIFT_SCENARIOS,
   fixed-prior against blind-EWMA Balanced-PANDAS, Topology(24, 6), load
   0.75, seeds 0-7, depth cut to horizon 300 / warmup 75 from 8000 /
   2000), counts set to 0 before and read after (no kernel on the dense
   path); its table, each arm's seconds and cell-slots/s, `blind_wins`;
   fatal: a delay not finite, an arm's throughput in any seed under 0.9
   x lam x the window's mean lam_mult for static, stragglers and
   rack_congestion, the static fixed-prior sweep unequal to the same
   sweep without a scenario in any metric, a host sync in the scenario
   slot loop (sync debug mode "error"; stragglers, rack_congestion,
   diurnal and a schedule with per-rack weights); a profiled window of
   the fixed-prior slot, static and stragglers (launches a slot, busy
   share).  (b, run after phase
   9's drained run) chatglm3-6b at full width through the same engine,
   defaults and 16 requests under `EngineConfig(scenario="stragglers",
   scenario_horizon=H)`, H the engine steps of phase 9's run,
   submissions timed by the scenario's arrival plan, counts set to 0
   before and read after: fatal unless every request drains with 17
   tokens, flash_attention = 28 x prefills, logits finite, and at least
   one admission is observed at a slowdown of 4.0, every such one on
   replicas 0-1 inside the window (the playback wraps every H steps);
   tokens/s beside phase 9's, the
   routed counts per replica and the tier mix;
13. the placement slice.  (a, run after 12a) the placement study
   (examples/placement_study.py: `placement_study` over the four
   PLACEMENTS x the three PLACEMENT_POLICIES under static and
   rack_congestion, Topology(24, 6), load 0.7 x the uniform static
   capacity, seeds 0-7, depth cut to horizon 300 / warmup 75 from
   8000 / 2000), counts set to 0 before and read after (no kernel on the
   dense path); its table, each placement's fluid capacity (the LP over
   2000 types sampled on the card), each sweep's seconds and
   cell-slots/s; fatal: a delay not finite, a static throughput in any
   seed under 0.9 x lam, the uniform Balanced-PANDAS sweep unequal to
   the same sweep without a placement in any metric, a host sync in the
   slot loop under hdfs, spread and hot_aware (sync debug mode "error";
   Balanced-PANDAS static, JSQ-MaxWeight under per-rack weights), or a
   rack-aware placement's static Balanced-PANDAS delay not below
   uniform's; a profiled window of 8 Balanced-PANDAS slots under each
   placement (launches a slot, busy share).  (b, run after 12b)
   chatglm3-6b at full width through the same engine, defaults and 16
   requests under each of `SERVE_PLACEMENTS` (hdfs, spread, and
   hot_aware with hot_frac 0.5), rebalanced every 4 routed requests,
   counts set to 0 before each run and read after: fatal unless every
   request drains with 17 tokens, flash_attention = 28 x prefills,
   logits finite, 16 requests routed, and hot_aware's rebalance moved a
   chunk; tokens/s, routed counts per replica and the tier mix beside
   phase 9's.  (c, run after 13a) types drawn on the card by each
   non-uniform placement's sampler through `ops.wwl_route` and, as queue
   lengths, `ops.maxweight_claim` at Topology(24, (4, 12)), B = 9, and
   the fleet shape (M = 10008, B = 5474, D = 1), each call bit for bit
   against its plain version on the group-restricted path, with the
   racks each task's replicas span;
14. the replication slice.  (a, run after 13a) the replication study
   (examples/replication_study.py: `replication_study` over the three
   REPLICATIONS x server_loss and rack_loss x Balanced-PANDAS and
   JSQ-MaxWeight, Topology(24, 6), loads 0.7 and 0.95 of the healthy
   capacity, seeds 0-7, depth cut to horizon 300 / warmup 75 from
   8000 / 2000), counts set to 0 before and read after (no kernel on the
   dense path); its table, each sweep's seconds and cell-slots/s;
   rack_loss + spread + repair once; the checks that need no long run at
   horizon 100; fatal: a delay not finite, a
   server_loss throughput at rho 0.7 under 0.9 x lam, static "fixed"
   unequal to the run without replication in any metric (static
   "repair" in the core metrics), a host sync in the slot loop under
   server_loss with each controller (sync debug mode "error"), a fixed
   or repair lifecycle metric other than lost_tasks that differs
   between cells or policies (it follows no draw), fixed with a repair
   move, repair's final replication not above fixed's under
   server_loss, data loss under rack_loss + spread; a profiled window of
   8 Balanced-PANDAS slots under server_loss + repair and under static
   without replication.  (b, run after 13b) chatglm3-6b at full width
   through the same engine, defaults and 16 requests under
   `EngineConfig(scenario="server_loss", replication="repair",
   scenario_horizon=12)`, one request submitted a step, counts set to 0
   before and read after: fatal unless every request drains with 17
   tokens, flash_attention = 28 x prefills, logits finite, the lifecycle
   made a repair move, availability is 1.0 and no route was lost;
   tokens/s, routed counts, the tier mix, moves and the admissions on a
   dead replica beside phase 9's.  (c, run after 13c) post-repair replica
   rows of a repair `HostReplication` (Topology(24, (4, 12)), servers 0,
   5 and 7 dead, B = 9; the quickstart's M = 1024, B = 128 with racks of
   64 and rack 0 dead) through `ops.wwl_route` and, as queue lengths,
   `ops.maxweight_claim`, bit for bit against their plain versions on
   the group-restricted path, with the racks each row spans;
15. the telemetry slice.  (a, run after 14a) the tail study
   (examples/tail_latency_study.py: `tail_study` over the TAIL_POLICIES
   Balanced-PANDAS, JSQ-MaxWeight and FIFO at the TAIL_LOADS 0.90/0.95/
   0.99 of the hot-rack capacity, Topology(24, 6), exact estimates,
   seeds 0-7, `TelemetryConfig()` defaults, depth cut to horizon 500 /
   warmup 125 from 12000 / 3000), counts set to 0 before and read after
   (no kernel on the dense path); its table and each sweep's seconds
   and cell-slots/s; fatal: the histogram mass plus
   `telemetry_unmatched` unequal to a cell's in-window completions, an
   unmatched or dropped pairing or percentiles outside 0 < p50 <= p95
   <= p99 < inf for Balanced-PANDAS and JSQ-MaxWeight at rho 0.90 and
   0.95, a metric of the three policies that the recorder changes
   (100-slot sweeps), SLO-PANDAS without telemetry unequal to
   Balanced-PANDAS, SLO-PANDAS at target 2.0 and rho 0.99 left on
   Balanced-PANDAS's sample path, a host sync in 23 recorder-on slots of
   Balanced-PANDAS or of SLO-PANDAS with signals (sync debug mode
   "error"); reported: FIFO's overflow share and whether
   `maybe_warn_overflow` fires, SLO-PANDAS at target 40 beside
   Balanced-PANDAS at rho 0.99, profiled windows of 8 recorder-on
   Balanced-PANDAS slots, 8 without the recorder and 8 of SLO-PANDAS
   with signals (the breach branch's launches).  (b, run after
   14b) phase 14b's engine, requests and submissions with
   `tracer=EventRecorder()`, the trace saved and read back with
   `load_trace`: fatal unless every request drains with 17 tokens,
   flash_attention = 28 x prefills, logits finite, 16 submit, route and
   admit instants and 16 request spans on tids 1-4 on the step clock,
   decode spans of cat kernel, a server_down, repair_commit events equal
   to the lifecycle's moves and a repair_start, the router's and the
   four replicas' thread names, no dropped event; tokens/s beside 14b's
   and the median decode span;
16. the control slice.  (a, run after 15a) the SLO-control study
   (examples/slo_control_study.py: `control_study` over the
   CONTROL_ARMS none / admission / autoscale / both x Balanced-PANDAS and
   SLO-PANDAS at the CONTROL_LOADS 0.90/0.95/0.99 of the hot-rack
   capacity, Topology(24, 6), exact estimates, seeds 0-7, telemetry on,
   `slo_target` 40, `admit_frac` 0.93, depth cut to horizon 300 /
   warmup 75 from 12000 / 3000), counts set to 0 before and read after
   (no kernel on the dense path); its table and each sweep's seconds and
   cell-slots/s; fatal: a delay not finite, offered unequal to admitted
   + shed in a cell of a controlled arm, a shed rate other than NaN for
   the none arm, the admission arm shedding nothing at rho 0.99 or over
   1% in a cell at 0.90 or its p99 at 0.99 not below the none arm's,
   the autoscale arm's ctl_active_min under 24 or its percentiles,
   throughput or sample path unequal to the none arm's, "both" unequal
   to "admission" in any metric but ctl_active_*; at 300 slots: open
   loop unequal to the uncontrolled run, closed loop (64 users, think
   8) over 64 in the system or unconserved, the autoscaler at 0.3 of
   capacity keeping all 24 servers or off lam by over 15%, the
   deferring bucket unconserved; a host sync in 19 slots of admission,
   autoscale, both, closed loop and SLO-PANDAS with signals under both
   (sync debug mode "error"); profiled windows of 8 recorder-on
   Balanced-PANDAS slots under "both" and without control.  (b, run
   after 15b)
   chatglm3-6b at full width through the same engine, defaults and
   requests under a token bucket (16 at once; fatal unless it sheds,
   admitted + shed = 16, admitted = completed = prefills = routed, no
   shed request routed), a traced autoscaler (one request every two
   steps; fatal unless an autoscale event targets under 4 replicas and
   no later route goes to a parked one) and a closed loop of 8 users
   (polled every step until 16 completions; fatal if in-flight passes 8
   or the budget takes 600 steps), counts set to 0 before each and read
   after: every admitted request drains with 17 tokens, flash_attention
   = 28 x prefills, logits finite; tokens/s beside phase 9's, the steps
   and the sojourn p95 of each arm.

17. the training slice (run after 10), counts set to 0 before and read
   after (training runs none of the five kernels: the reference trains
   with impl="xla", and none has a backward).  (a) mamba2-1.3b at full
   width in bf16 (48 layers, d_model 2048, random weights from a seed)
   through `Trainer`, fed by `DataPipeline(PipelineConfig(vocab 50280,
   seq_len 512, global_batch 8, token_skew 1.2, chunks of 256 tokens))`
   with host 0 reading 10x slower, under `plan_for(cfg, "train_4k",
   "train")` (4 microbatches, float32 accumulation and moments, remat)
   with the quickstart's 5-step warmup, 4 steps, then one microbatch's
   forward and backward under `torch.profiler`: each step's loss, grad
   norm, ms and tokens/s, the model FLOPs a step (6 N D) and their share
   of the bf16 dense peak, `max_memory_allocated` beside the reckoned 16
   bytes a parameter, the locality fractions, and host 0's reads beside
   its reads in the same pipeline without the slowdown; fatal: a loss or
   grad norm not finite, a first loss off ln(padded vocab) by over 1
   nat, a last loss not below the first, host 0 serving as many reads as
   the mean host or over half its reads without the slowdown.
   (b) chatglm3-6b's, mamba2-1.3b's and granite-moe-1b's smoke configs
   (float32) take one `build_train_step` step on the card and on the CPU
   from the same weights and batch, TF32 off: loss and grad norm (and
   the microbatches' mean moe_aux) within 1e-4 relative.
   (c) chatglm3-6b's smoke config trains 2 steps on the card
   with a checkpoint at step 2; a new `Trainer` restores it: every
   tensor bit for bit, and the restored pipeline's next batch the
   uninterrupted one's.  (d) `launch.train.main(["--arch", "mamba2_13b",
   "--full", "--steps", "2", "--seq-len", "512", "--global-batch",
   "8"])` on the card.
18. the MoE slice (run after 17).  (a) granite-moe-1b at full width
   (24 layers, d_model 1024, 32 experts top 8, bf16, random weights from
   a seed, 2.67 GB) through the engine, defaults and 16 requests as
   phase 9: fatal unless flash_attention = 24 x prefills and no other
   kernel, the parameter count is `param_count`'s, every logits tensor
   finite and every request drained with 17 tokens; one prefill through
   impl="pallas" against impl="xla" within `MOE_LOGIT_TOL` in bf16 and
   `SERVE_F32_LOGIT_TOL` for the same weights in float32 (a one key past
   the edge attention beyond it), the real tokens whose experts differ
   between the two routes counted layer by layer; prefill ms, decode
   tokens/s and a profiled decode window.  (b) `moe_mlp` at full width
   on one layer's seeded weights, float32 with TF32 off, card against
   CPU at n = 8192 (the capacity branch, some pairs dropped) and 1024:
   choices and kept mask equal (a near-tie flip counted, at most 1 in
   1000 tokens), y within 1e-4 of its largest value, aux within 1e-6;
   the bf16 call twice on the card bit for bit.  (c) granite-moe-1b
   trained at full width in bf16 through `Trainer` and `DataPipeline`
   (seq 512, batch 8, `plan_for(cfg, "train_4k", "train")`: 4
   drop-free microbatches of 1024 tokens, the quickstart's warmup), 4
   steps: fatal unless the losses are finite and the last below the
   first, and every microbatch's moe_aux finite and positive; tokens/s,
   6 x active parameters x tokens over the bf16 peak,
   `max_memory_allocated`, one microbatch's forward and backward under
   the profiler.  Counts set to 0 before 18b and 18c and 0 after.
19. the rest of the model stack (run after 18).  (a) whisper-medium at
   full width (24 + 24 layers, d_model 1024, LayerNorm, GELU, learned
   positions, bf16, random weights from a seed, 1.69 GB; the parameter
   count `param_count`'s plus `_uncounted`): `encode` of B 4 x 1500
   stub frames timed, then `launch.steps.build_prefill_step` on a
   64-token prompt (the encoder, then the decoder through
   impl="pallas", cross K/V written into the cache) and
   `build_serve_step` for 16 decode steps against the self and cross
   caches, counts set to 0 before each and read after: fatal unless
   flash_attention = 24 a prefill and no other kernel, none in decode,
   every logits tensor finite; decode tokens/s, launches and busy share
   of a profiled window, the cross cache's bytes; one prefill through
   impl="pallas" against impl="xla" within `SERVE_LOGIT_TOL` (bf16) and
   `SERVE_F32_LOGIT_TOL` for the same weights in float32, each forward
   free of host syncs; in float32, 4 decode steps of the serve step
   against the full forward at their positions within 5e-3
   (tests/test_models_decode.py).  (b) internvl2-2b at full width (24
   layers, d_model 2048, GQA 16/8, D 128, 3.78 GB bf16) the same, its
   prefill of B 4 x (256 frontend rows + 64 tokens), 24 launches a
   prefill at D 128.  (c) both trained at full width in bf16 through
   `build_train_step` (`plan_for(cfg, "train_4k", "train")`, the
   quickstart's warmup), 3 steps of batch 8: whisper 448 decoder tokens
   with (8, 1500, 1024) frames, internvl2 256 frontend rows and 256
   text tokens; fatal unless the losses are finite and the last below
   the first; tokens/s, `max_memory_allocated` beside 16 bytes a
   parameter, model FLOPs (whisper 6 x (encoder parameters x frames +
   decoder parameters x tokens)) over the bf16 peak.  (d)
   jamba-1.5-large at its smoke config (one block: Mamba-2 at 0-3 and
   5-7, attention at 4, MoE at the odd positions; 44.1B parameters a
   full-width block, over one card), float32 with TF32 off, card
   against CPU: the forward under impl="xla", "pallas" and
   "pallas_ssd" (flash_attention 1 and ssd 0, ssd 7 and flash_attention
   0, none, counted on the card), logits within 1e-4 of their largest
   magnitude, the aux within 1e-6, router set flips counted; the
   prefill step then 4 serve steps; one train step of the jamba plan (8
   microbatches, bf16 gradient sum and moments) within 1e-4 relative;
   then the engine (`EngineConfig()`) drains 4 requests through the SSD
   route, ssd = 7 x prefills and no flash_attention, and the launcher
   serves whisper-medium's and internvl2-2b's smoke configs (4 requests
   each, flash_attention = decoder layers x 4).  Counts set to 0 after.
20. the dry run against the card (run after 19).  (a)
   `launch.dryrun.run_shape` counts gemma3-1b's and mamba2-1.3b's
   decode_32k serve steps on ``meta`` (B 128, caches of 32,768) under
   `utils.hlo.OpCounter` and reckons their memory and roofline for the
   H100; its rows are printed.  (b) both cells run for real: random bf16
   parameters from a seed, zero caches, ``lengths`` 32,767 (every row
   reads its whole cache), DRY_WARMUP + DRY_STEPS steps each under its
   own counter, the last DRY_STEPS timed by CUDA events; fatal: a step's
   flops, bytes or launches (total and by op) off the meta count,
   `max_memory_allocated` (its peak reset before the parameters are
   allocated) off the dry run's `peak_bytes_per_device` by more than
   DRY_MEM_TOL (5%), the roofline's `ideal_s` over 1.05 x the median
   step (a share of the bound over 105% is a wrong count); the median
   step, the bound, the shares, and for gemma3-1b one step's kernels by
   `torch.profiler` beside the counter's launches.  (c) prefill steps of
   both at B 4 x T 1024 through the kernel route, counted on ``meta``
   (the kernel wrappers' meta branch reports the kernel's cost) and on
   the card, counts set to 0 before: flops, bytes and launches equal,
   the kernel's counted launches equal to the `LAUNCHES` delta,
   flash_attention 26 a gemma3-1b prefill and ssd 48 a mamba2-1.3b one.
   Counts set to 0 after.

21. the examples (`repro_torch.examples`, run after 20), each through
   its own entry point on the card, counts set to 0 before and read
   after.  (a) `quickstart.run` at horizon 200 / 50 and `--fast`'s 12
   training steps: fatal unless wwl_route made 1 launch and no other
   kernel launched, its (server, tier, score) equal `ref.wwl_route`'s
   on the example's inputs (M = 1024, B = 128, group-restricted path),
   every delay is finite and the last logged loss is 0.2 below the
   first.  (b) `figures.fig1_precise` and
   `figures.fig34_under` at Topology(24, 6), horizon 100 / 25, loads
   0.6/0.8/0.9/0.95 (high 0.9/0.95), eps 0.1/0.2/0.3, seed 0, then
   `robustness_study.write_csv` into a temporary directory: fatal unless
   the rows number 20 + 28, the CSV holds them, every delay is finite,
   no kernel launched and `headline_claims` has fig1's and figs 3/4's
   keys (printed, not gated).  (c) `serve_cluster.main([])` (4
   schedulers x 24 requests x 6 new tokens, chatglm3-6b's smoke config,
   float32, D 8): fatal unless every request drains with 7 tokens, every
   logits tensor is finite and flash_attention = 4 layers x prefills
   (96).  (d) `replay.replay_trace(fast=True, export_path=...)` (12
   requests under the bundled diurnal_week trace), then trace_replay's
   round-trip asserts on the export: fatal unless flash_attention = 4 x
   prefills (12) and the export holds 12 arrivals.  Each sub-phase's
   seconds are printed.

Prints the seconds of each phase, a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when there is no card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
# the H100's rates and the two model kernels' bounds (the roofline's)
from repro_torch.utils.roofline import (  # noqa: E402
    BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S, attention_cost,
    ssd_cost)

M_FLEET, B_FLEET = 10008, 5474
M_BENCH, B_BENCH = 65536, 8192      # benchmarks/bench_kernels.py, full width
M_QUICK, B_QUICK = 1024, 128        # examples/quickstart.py, layer 2
KERNEL_REPS, PLAIN_REPS = 50, 5
FLEET_TOPOS = ((M_FLEET, (), (0.5, 0.25)), (M_FLEET, 6, (0.5, 0.45, 0.25)),
               (M_FLEET, (6, 72), (0.5, 0.45, 0.35, 0.25)))


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call by CUDA events, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _fuzz_state(rng, m, k, batch):
    """Tie-heavy state: half the tasks pile onto servers 0..5."""
    q = rng.integers(0, 60, (m, k)).astype("int32")
    serving = rng.integers(0, 8, (m,)).astype("int32")
    hot = [sorted(rng.choice(6, 3, replace=False))
           for _ in range(batch // 2)]
    cold = [sorted(rng.choice(m, 3, replace=False))
            for _ in range(batch - batch // 2)]
    return q, serving, np.asarray(hot + cold, np.int32)


def _fleet_route_bound(topo, est, locs):
    """(bound_ms, bound_by) of fleet_route on these inputs: bytes moved
    once (inputs read, outputs written) over the HBM rate against the
    operations these inputs need over the f32 rate — the workload (K
    divides, K-1 adds, the residual's divide and add per server) plus
    one divide, multiply and subtract for every private (task, server)
    pair, i.e. the union of the locals' coarsest-level groups."""
    m, k = est.shape
    d = topo.depth
    b = locs.shape[0]
    nbytes = 4 * (m * k + m + m * k + d * m + 3 * b) + 12 * b
    if d == 0:
        private = sum(len(set(row)) for row in locs.tolist())
    else:
        top = topo.ancestors[d - 1]
        sizes = np.bincount(top)
        g = np.sort(top[locs], axis=1)
        private = int((sizes[g[:, 0]] + sizes[g[:, 1]] * (g[:, 1] != g[:, 0])
                       + sizes[g[:, 2]] * (g[:, 2] != g[:, 1])).sum())
    ops = m * (2 * k + 1) + 3 * private
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


# ragged explicit group sizes at the fleet width: racks of 4 and 8 in
# turn, then pods of 12 and 24 in turn (every boundary nested)
RAGGED_RACKS = (4, 8) * (M_FLEET // 12)
RAGGED_PODS = (12, 24) * (M_FLEET // 36)
FLEET_ROUTE_KERNEL = "fleet_route_kernel"   # the CUDA kernel's name


def fleet_route_topos():
    """(name, Topology, Rates) of phase 3: the three depths at uniform
    sizes (D=1 is the fleet slice's Topology(10008, 6)), then the ragged
    sizes at depths 1 and 2."""
    from repro_torch.core import locality as loc

    return (("D=0", loc.Topology(M_FLEET), loc.Rates(0.5, 0.25)),
            ("D=1", loc.Topology(M_FLEET, 6), loc.Rates()),
            ("D=2", loc.Topology(M_FLEET, (6, 72)),
             loc.Rates(0.5, 0.45, 0.35, 0.25)),
            ("ragged D=1", loc.Topology(M_FLEET, (RAGGED_RACKS,)),
             loc.Rates()),
            ("ragged D=2", loc.Topology(M_FLEET, (RAGGED_RACKS, RAGGED_PODS)),
             loc.Rates(0.5, 0.45, 0.35, 0.25)))


# an earlier tree's scheduling kernels: (source, C entry point, pointer
# arguments before and after its three ints, without a scratch pointer)
PREV_KERNELS = {"fleet_route": ("fleet_route", "fleet_route_launch", 5, 4),
                "wwl_route": ("wwl_route", "wwl_route_launch", 4, 4),
                "maxweight_claim": ("maxweight", "maxweight_launch", 5, 3)}
# the cell count that fleet_route's entry takes after its three ints
# since it routes a study's cells in one launch
FLEET_ROUTE_CELLS_ARG = rb"fleet_route_launch\([^)]*\bint n,"


# an earlier tree's model kernels: (source, C entry point, its argument
# types), each called with contiguous tensors, as that tree's wrappers
# passed them (before the float32 kernels took strides)
PREV_MODEL_KERNELS = {
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        ["p"] * 4 + ["i"] * 7 + ["f", "i", "i", "f", "p"]),
    "ssd": ("ssd_scan", "ssd_scan_launch", ["p"] * 7 + ["i"] * 6 + ["p"])}


def load_prev(prev_dir):
    """{kernel: an earlier tree's launch function} from `prev_dir`'s
    fleet_route.cu, wwl_route.cu and maxweight.cu (and its headers),
    built with this tree's flags into the build directory, one nvcc
    each, all started together; None without a directory.  Each takes
    this tree's wrapper's arguments, so it can stand in for the
    wrapper's `_fn`: where a source's entry point takes no scratch
    pointer (the earlier all-pairs kernels), it is dropped,
    and where its `fleet_route` takes no cell count (a tree from before
    the cell axis: one cell a launch), so is the count, which must be 1.
    Its flash_attention.cu and ssd_scan.cu, built alongside, give
    "flash_attention" and "ssd": the earlier float32 kernels on the CUDA
    cores (`_prev_attention`, `_prev_ssd`)."""
    import ctypes
    import glob
    import hashlib
    import re

    from repro_torch.kernels import _build

    if prev_dir is None:
        return None
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = b"".join(open(h, "rb").read() for h in
                       sorted(glob.glob(os.path.join(prev_dir, "*.cuh"))))
    procs = {}
    sources = {n: v[0] for n, v in PREV_KERNELS.items()}
    sources.update({n: v[0] for n, v in PREV_MODEL_KERNELS.items()})
    for name, source in sources.items():
        src = os.path.join(prev_dir, f"{source}.cu")
        text = open(src, "rb").read()
        digest = hashlib.sha256(text + headers).hexdigest()[:16]
        out = _build.BUILD_DIR / f"prev-{source}-{digest}.so"
        procs[name] = (out, b"void* scratch" in text,
                       bool(re.search(FLEET_ROUTE_CELLS_ARG, text)),
                       subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for name, (out, scratch, cells, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}:\n{log}")
        if name in PREV_MODEL_KERNELS:
            _, entry, args = PREV_MODEL_KERNELS[name]
            fn = getattr(ctypes.CDLL(str(out)), entry)
            fn.argtypes = [types[a] for a in args]
            fn.restype = ctypes.c_int
            fns[name] = (_prev_attention if name == "flash_attention"
                         else _prev_ssd)(fn)
            continue
        _, entry, before, after = PREV_KERNELS[name]
        fn = getattr(ctypes.CDLL(str(out)), entry)
        fn.argtypes = ([ctypes.c_void_p] * before
                       + [ctypes.c_int] * (3 + cells)
                       + [ctypes.c_void_p] * (after + scratch))
        fn.restype = ctypes.c_int
        if name == "fleet_route":
            fns[name] = fn if cells else _one_cell(fn)
        else:
            fns[name] = fn if scratch else _without_scratch(fn)
    return fns


def _prev_attention(raw):
    """The earlier float32 attention kernel (CUDA cores, route 0) called
    on contiguous float32 q, k, v as `ops.flash_attention` takes them."""
    def call(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
        b, hq, tq, d = q.shape
        out = torch.empty_like(q)
        err = raw(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, k.shape[1], tq, k.shape[2], d, 0,
                  float(d ** -0.5 if scale is None else scale),
                  int(causal), int(window), float(softcap),
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's flash_attention: cudaError "
                               f"{err}")
        return out
    return call


def _prev_ssd(raw):
    """The earlier float32 SSD kernel (recurrent, route 0) called on
    contiguous float32 x, a, b, c and h0."""
    def call(x, a, b, c, h0):
        bsz, t, h, p = x.shape
        y, h_final = torch.empty_like(x), torch.empty_like(h0)
        err = raw(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  h0.data_ptr(), y.data_ptr(), h_final.data_ptr(), bsz, t, h,
                  p, b.shape[-1], 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's ssd_scan: cudaError {err}")
        return y, h_final
    return call


def _one_cell(raw):
    """A one-cell fleet_route launcher called with this tree's wrapper's
    arguments, less the cell count (the ninth), which must be 1."""
    def call(*args):
        if args[8] != 1:
            raise ValueError("the parent's fleet_route routes one cell a "
                             "launch")
        return raw(*args[:8], *args[9:])
    return call


def _without_scratch(raw):
    """An all-pairs launcher called with this tree's wrapper's
    arguments, less the scratch pointer (the one before the stream)."""
    return lambda *args: raw(*args[:-2], args[-1])


def phase_kernels(dev, prev_fn=None):
    """fleet_route against its plain version at M = 10008, B = 5474, at
    each of `fleet_route_topos`, timed by CUDA events and on the device;
    with `prev_fn` (the parent tree's kernel, `load_prev`) that kernel is
    checked and timed beside it on the same inputs."""
    from repro_torch.core import locality as loc
    from repro_torch.kernels import ops, ref, slot_step

    rng = np.random.default_rng(0)
    rows = {}
    for name, topo, rates in fleet_route_topos():
        k, d = topo.num_tiers, topo.depth
        est = loc.per_server_rates(rates.as_array(dev), M_FLEET).contiguous()
        anc = torch.as_tensor(np.array(topo.ancestors), device=dev)
        mismatches, prev_mismatches, max_err = 0, 0, 0.0
        for _ in range(3):
            q, serving, locs = _fuzz_state(rng, M_FLEET, k, B_FLEET)
            args = (torch.as_tensor(q, device=dev),
                    torch.as_tensor(serving, device=dev), est, anc,
                    torch.as_tensor(locs, device=dev))
            plain = ref.fleet_route(*args)
            got = ops.fleet_route(*args)
            bad, err = _compare(got, plain)
            mismatches += bad
            max_err = max(max_err, err)
            if prev_fn is not None:
                with mock.patch.object(slot_step, "_fn", prev_fn):
                    prev_mismatches += _compare(ops.fleet_route(*args),
                                                plain)[0]
        new = lambda: ops.fleet_route(*args)  # noqa: E731
        row = dict(depth=d, mismatches=mismatches, max_abs_err=max_err,
                   ms=_time_ms(new, KERNEL_REPS),
                   device_ms=_device_ms(new, FLEET_ROUTE_KERNEL, KERNEL_REPS),
                   plain_ms=_time_ms(lambda: ref.fleet_route(*args),
                                     PLAIN_REPS),
                   prev_ms=None, prev_device_ms=None)
        if prev_fn is not None:
            with mock.patch.object(slot_step, "_fn", prev_fn):
                row.update(prev_mismatches=prev_mismatches,
                           prev_ms=_time_ms(new, KERNEL_REPS),
                           prev_device_ms=_device_ms(new, FLEET_ROUTE_KERNEL,
                                                     KERNEL_REPS))
        bound_ms, bound_by, nbytes, nops = _fleet_route_bound(topo,
                                                              est.cpu(), locs)
        row.update(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   ops=nops)
        rows[name] = row
        print(f"fleet_route {name}: {json.dumps(row)}", flush=True)
        if mismatches or prev_mismatches:
            raise AssertionError(f"fleet_route kernel disagrees with its "
                                 f"plain version at {name}: {mismatches} "
                                 f"tasks ({prev_mismatches} for the parent's "
                                 f"kernel)")
    return rows


BATCH_CELLS = (1, 8, 30)   # the fleet study's grid is 30 cells


def phase_batched_route(dev, prev_fn=None):
    """fleet_route with a cell axis at the fleet shape (M = 10008, B =
    5474, D = 1) for N = 1, 8 and 30 cells of their own tie-heavy states:
    bit for bit against the plain version and against N one-cell
    launches, one launch a call; events and device time beside N x the
    one-cell device time, and the bound, N cells' bytes (the table read
    once) against their operations.  With `prev_fn`, the parent's
    one-cell kernel is timed at N = 1 beside it."""
    from repro_torch.core import locality as loc
    from repro_torch.kernels import ops, ref, slot_step

    rng = np.random.default_rng(1)
    topo, rates = loc.Topology(M_FLEET, 6), loc.Rates()
    k, d = topo.num_tiers, topo.depth
    anc = torch.as_tensor(np.array(topo.ancestors), device=dev)
    est1 = loc.per_server_rates(rates.as_array(dev), M_FLEET).contiguous()
    rows = {}
    for n in BATCH_CELLS:
        cells = [_fuzz_state(rng, M_FLEET, k, B_FLEET) for _ in range(n)]
        q, serving, locs = (torch.as_tensor(np.stack(x), device=dev)
                            for x in zip(*cells))
        est = est1.expand(n, M_FLEET, k).contiguous()
        before = ops.LAUNCHES["fleet_route"]
        got = ops.fleet_route(q, serving, est, anc, locs)
        calls = ops.LAUNCHES["fleet_route"] - before
        mismatches, max_err = _compare(got, ref.fleet_route(q, serving, est,
                                                            anc, locs))
        singles = [ops.fleet_route(q[c], serving[c], est[c], anc, locs[c])
                   for c in range(n)]
        single_bad = _compare(got, tuple(torch.stack(x)
                                         for x in zip(*singles)))[0]
        call = lambda: ops.fleet_route(q, serving, est, anc, locs)  # noqa
        one = lambda: ops.fleet_route(q[0], serving[0], est[0], anc,  # noqa
                                      locs[0])
        bounds = [_fleet_route_bound(topo, est1.cpu(), c[2]) for c in cells]
        nbytes = sum(b[2] for b in bounds) - (n - 1) * 4 * d * M_FLEET
        nops = sum(b[3] for b in bounds)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
        row = dict(cells=n, launches_a_call=calls, mismatches=mismatches,
                   single_cell_mismatches=single_bad, max_abs_err=max_err,
                   ms=_time_ms(call, KERNEL_REPS),
                   device_ms=_device_ms(call, FLEET_ROUTE_KERNEL,
                                        KERNEL_REPS),
                   one_cell_device_ms=_device_ms(one, FLEET_ROUTE_KERNEL,
                                                 KERNEL_REPS),
                   plain_ms=_time_ms(lambda: ref.fleet_route(
                       q, serving, est, anc, locs), 2),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, ops=nops, prev_device_ms=None)
        if row["one_cell_device_ms"] and row["device_ms"]:
            row["device_ms_over_n_cells"] = (row["device_ms"]
                                             / (n * row["one_cell_device_ms"]))
        if prev_fn is not None and n == 1:
            with mock.patch.object(slot_step, "_fn", prev_fn):
                row["prev_device_ms"] = _device_ms(call, FLEET_ROUTE_KERNEL,
                                                   KERNEL_REPS)
        rows[n] = row
        print(f"fleet_route batched N={n}: {json.dumps(row)}", flush=True)
        if mismatches or single_bad or calls != 1:
            raise AssertionError(f"batched fleet_route at N={n}: "
                                 f"{mismatches} tasks differ from the plain "
                                 f"version, {single_bad} from one-cell "
                                 f"launches, {calls} launches a call")
        del q, serving, locs, est, got, singles
        torch.cuda.empty_cache()
    return rows


def phase_slice(dev):
    """The fleet path at M = 10008 through `simulate`, and kernel on/off."""
    from repro_torch.core import locality as loc, simulator as sim
    from repro_torch.core.rng import DeviceSource
    from repro_torch.kernels import ops
    from repro_torch.sharding import sim as fleet

    topo, rates = loc.Topology(M_FLEET, 6), loc.Rates()
    lam = 0.8 * loc.capacity_hot_rack(topo, rates, 0.5)
    cfg = sim.SimConfig(topo, rates, p_hot=0.5,
                        max_arrivals=int(2.05 * lam), horizon=512,
                        warmup=128)
    if cfg.max_arrivals != B_FLEET:
        raise AssertionError(f"batch {cfg.max_arrivals} != {B_FLEET}")
    est = sim.make_estimates(cfg, "network", 0.2, -1)
    rounds = fleet.FleetConfig().rounds

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    out = sim.simulate("balanced_pandas", cfg, lam, est, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    res = dict(out, lam=lam, wall_s=wall, slots_per_s=cfg.horizon / wall,
               launches=launches)
    print(f"slice M={M_FLEET} B={cfg.max_arrivals}: {json.dumps(res)}",
          flush=True)
    want = rounds * cfg.horizon
    if launches["fleet_route"] != want:
        raise AssertionError(f"fleet_route launched {launches} times on the "
                             f"main path, want {want}")
    if abs(out["throughput"] - lam) > 0.02 * lam:
        raise AssertionError(f"throughput {out['throughput']} not within 2% "
                             f"of lam {lam}")
    if not math.isfinite(out["mean_delay"]):
        raise AssertionError(f"mean_delay {out['mean_delay']} not finite")

    # kernel on/off: same seed, 128 slots, identical carry
    est_t = torch.as_tensor(est, device=dev)[None].contiguous()
    carries = []
    for use_kernel in (True, False):
        init, step = fleet._build_fleet_step(
            "balanced_pandas", cfg, fleet.FleetConfig(use_kernel=use_kernel),
            dev)
        src = DeviceSource([(0, lam)], cfg.max_arrivals, M_FLEET, dev)
        carry = init()
        for t in range(128):
            carry = step(carry, t, est_t, src.slot(t))
        carries.append([x.cpu() for x in carry])
    for a, b in zip(*carries):
        if not torch.equal(a, b):
            raise AssertionError("kernel on/off carries differ after 128 "
                                 "slots")
    print("kernel on/off: identical carry after 128 slots", flush=True)
    return launches, res, (cfg, lam, est_t)


def phase_profile(dev, cfg, cells, est_t, slots: int = 32, prev_fn=None,
                  ab_slots: int = 64, label: str = f"M={M_FLEET}"):
    """Where a slot's time goes, for the cells ``[(seed, lam), ...]`` with
    (N, M, K) estimates `est_t` as one batch: steady-state slots/s
    without the profiler, then one profiled window — the device's busy
    share (kernel time over wall time) and the device time of the top
    kernels.  With `prev_fn` (the parent's fleet_route kernel), steady
    slots/s over `ab_slots` slots with this tree's kernel and the
    parent's in turn (new, parent, parent, new, new, parent), the same
    carry going on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.rng import DeviceSource
    from repro_torch.sharding import sim as fleet

    init, step = fleet._build_fleet_step("balanced_pandas", cfg,
                                         fleet.FleetConfig(), dev)
    src = DeviceSource(cells, cfg.max_arrivals, M_FLEET, dev)
    carry, t = init(len(cells)), 0

    def run(n):
        nonlocal carry, t
        for _ in range(n):
            carry = step(carry, t, est_t, src.slot(t))
            t += 1
        torch.cuda.synchronize()

    def slots_per_s(n=slots):
        t0 = time.perf_counter()
        run(n)
        return n / (time.perf_counter() - t0)

    run(16)  # warm up
    steady = slots_per_s()
    ab = None
    if prev_fn is not None:
        from repro_torch.kernels import slot_step

        ab = {"new": [], "prev": []}
        for which in ("new", "prev", "prev", "new", "new", "prev"):
            if which == "prev":
                with mock.patch.object(slot_step, "_fn", prev_fn):
                    ab[which].append(slots_per_s(ab_slots))
            else:
                ab[which].append(slots_per_s(ab_slots))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(slots)
        window_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kern)
    out = {"cells": len(cells), "slots_per_s_steady": steady,
           "cell_slots_per_s_steady": steady * len(cells),
           "slots_per_s_new_vs_prev": ab, "window_slots": slots,
           "window_ms_per_slot": window_us / slots / 1e3,
           "device_busy_share": busy_us / window_us if kern else None,
           "device_launches_per_slot": sum(k[1] for k in kern) / slots,
           "top_kernels_us_per_slot": [[k[2][:60], k[0] / slots]
                                       for k in kern[:6]]}
    print(f"profile {label}: {json.dumps(out)}", flush=True)
    return out


# the fleet study: the robustness study at data-centre scale, phase 4's
# fleet configuration under loads x per-server errors x seeds (30 cells)
FLEET_STUDY_LOADS = (0.6, 0.8, 0.95)
FLEET_STUDY_EPS = (0.1, 0.3)
FLEET_STUDY_SEEDS = (0, 1)
FLEET_STUDY_ALGOS = ("balanced_pandas", "pandas_po2")
# (load index, error index, seed index) of the cells rerun by `simulate`
FLEET_STUDY_SAMPLES = ((2, 4, 0),)


def phase_fleet_study(dev, cfg, single_slots_per_s):
    """`run_study(fleet=True)` for Balanced-PANDAS and power-of-d at phase
    4's configuration, each arm's 3 x 5 x 2 = 30 cells one batch (counts
    set to 0 before each and read after: fleet_route = rounds x horizon
    for Balanced-PANDAS whatever the cell count, 0 for power-of-d).
    Fatal: a delay not finite, a cell's throughput at loads 0.6 and 0.8
    off lam by more than 2%, a sampled cell unequal to `simulate` of that
    cell.  Prints cell-slots/s beside phase 5's one-cell slots/s, then
    profiles a window of the batched Balanced-PANDAS step."""
    from repro_torch.core import robustness as rb, simulator as sim
    from repro_torch.sharding import sim as fleet

    study_cfg = rb.StudyConfig(sim=cfg, loads=FLEET_STUDY_LOADS,
                               eps_grid=FLEET_STUDY_EPS,
                               error_mode="per_server",
                               seeds=FLEET_STUDY_SEEDS)
    ests = [sim.make_estimates(cfg, "network", 0.0, -1)]
    ests += [sim.make_estimates(cfg, "per_server", e, sg)
             for sg in (-1, 1) for e in FLEET_STUDY_EPS]
    rounds = fleet.FleetConfig().rounds
    rows = {}
    for algo in FLEET_STUDY_ALGOS:
        _zero_counts()
        t0 = time.perf_counter()
        out = rb.run_study(study_cfg, algos=(algo,), fleet=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = rounds * cfg.horizon if algo == "balanced_pandas" else 0
        launches = _check_counts(f"fleet study {algo}",
                                 {"fleet_route": want})
        delay, thru = out["delay"][algo], out["throughput"][algo]
        cells = int(np.prod(delay.shape))
        row = dict(cells=cells, shape=list(delay.shape), wall_s=wall,
                   cell_slots_per_s=cells * cfg.horizon / wall,
                   single_cell_slots_per_s=single_slots_per_s,
                   launches=launches["fleet_route"],
                   mean_delay=delay.mean(axis=(1, 2)).tolist(),
                   throughput_over_lam=(thru.mean(axis=(1, 2))
                                        / out["lam"]).tolist())
        row["cell_slots_over_single"] = (row["cell_slots_per_s"]
                                         / single_slots_per_s)
        if delay.shape != (3, 5, 2) or not np.isfinite(delay).all():
            raise AssertionError(f"fleet study {algo}: delays {delay}")
        for li, load in enumerate(FLEET_STUDY_LOADS):
            lam = out["lam"][li]
            off = np.abs(thru[li] - lam) / lam
            if load <= 0.8 and off.max() > 0.02:
                raise AssertionError(f"fleet study {algo} at rho {load}: "
                                     f"throughput {thru[li]} not within 2% "
                                     f"of {lam}")
        for li, ei, si in FLEET_STUDY_SAMPLES:
            one = sim.simulate(algo, cfg, float(out["lam"][li]), ests[ei],
                               seed=FLEET_STUDY_SEEDS[si], device=dev)
            got = {"mean_delay": delay, "throughput": thru,
                   "final_n": out["final_n"][algo]}
            for key, grid in got.items():
                if one[key] != float(grid[li, ei, si]):
                    raise AssertionError(
                        f"fleet study {algo}: cell {(li, ei, si)} {key} "
                        f"{grid[li, ei, si]} != simulate's {one[key]}")
        row["sampled_cells_equal_simulate"] = len(FLEET_STUDY_SAMPLES)
        rows[algo] = row
        print(f"fleet study {algo}: {json.dumps(row)}", flush=True)

    cap = out["capacity"]
    cells = [(s, np.float32(load * cap)) for load in FLEET_STUDY_LOADS
             for _ in ests for s in FLEET_STUDY_SEEDS]
    est_t = torch.as_tensor(np.stack([e for _ in FLEET_STUDY_LOADS
                                      for e in ests
                                      for _ in FLEET_STUDY_SEEDS]),
                            device=dev)
    rows["profile"] = phase_profile(dev, cfg, cells, est_t, slots=16,
                                    label=f"fleet study N={len(cells)}")
    return rows


# ---------------------------------------------------------------------------
# wwl_route and maxweight_claim
# ---------------------------------------------------------------------------


def _top_groups(anc, ids):
    """Coarsest-level group of each id, or the ids themselves at depth 0."""
    return anc[-1][ids] if anc.shape[0] else ids


def _wwl_bound(anc, locs, k):
    """(bound_ms, bound_by, bytes, ops) of wwl_route on these inputs:
    W, est and the table read once, the locals read and 12 bytes a task
    written, against the operations they need — M remote-tier scores
    with their shared argmin (2 per server) plus a division and a
    comparison for each non-remote (task, server) pair, i.e. the union
    of the locals' coarsest groups (the locals alone at depth 0)."""
    d, m = anc.shape
    b = locs.shape[0]
    nbytes = 4 * m * (1 + k + d) + 12 * b + 12 * b
    g = np.sort(_top_groups(anc, locs), axis=1)
    size = (np.bincount(anc[-1], minlength=m) if d else np.ones(m, np.int64))
    private = int((size[g[:, 0]] + size[g[:, 1]] * (g[:, 1] != g[:, 0])
                   + size[g[:, 2]] * (g[:, 2] != g[:, 1])).sum())
    ops = 2 * m + 2 * private
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def _maxweight_bound(qanc, ids, k):
    """(bound_ms, bound_by, bytes, ops) of maxweight_claim: Q and the
    queue table read once, the idle ids, their table and rates read once,
    8 bytes an idle server written, against one shared max of Q (the
    remote tier, N comparisons) plus a product and a comparison for each
    non-remote (idle server, queue) pair: the queues of the idle
    server's coarsest group (its own queue alone at depth 0)."""
    d, n = qanc.shape
    b = ids.shape[0]
    nbytes = 4 * n * (1 + d) + 4 * b * (1 + d + k) + 8 * b
    size = (np.bincount(qanc[-1], minlength=n) if d else np.ones(n, np.int64))
    ops = n + 2 * int(size[_top_groups(qanc, ids)].sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def _compare(kernel_out, plain_out):
    """(mismatches, max_abs_err) of two output tuples: an element differs
    unless every output agrees bit for bit; the error is over finite
    float pairs."""
    torch.cuda.synchronize()
    bad = torch.zeros_like(kernel_out[0], dtype=torch.bool)
    err = 0.0
    for a, b in zip(kernel_out, plain_out):
        bad |= a.view(torch.int32) != b.view(torch.int32)
        if a.dtype == torch.float32:
            both = torch.isfinite(a) & torch.isfinite(b)
            if bool(both.any()):
                err = max(err, float((a - b).abs()[both].max()))
    return int(bad.sum()), err


def _wwl_inputs(rng, m, b, anc, rates, ties):
    """Fleet-shape wwl_route inputs; `ties`: small-integer workloads and
    shared rates, so many servers score exactly alike."""
    k = len(rates)
    wl = rng.integers(0, 4, m) if ties else rng.uniform(0, 50, m)
    er = np.tile(rates, (m, 1))
    if not ties:
        er = er * rng.uniform(0.8, 1.2, (m, k))
    hot = [sorted(rng.choice(6, 3, replace=False)) for _ in range(b // 2)]
    cold = [sorted(rng.choice(m, 3, replace=False))
            for _ in range(b - b // 2)]
    return (wl.astype(np.float32), er.astype(np.float32),
            np.asarray(anc, np.int32), np.asarray(hot + cold, np.int32))


def near_tie(rng):
    """(x, y, w): y = nextafter(x, 0) and a rate w whose products with
    the two round to one float, searched with numpy."""
    x = np.float32(3.0)
    y = np.nextafter(x, np.float32(0))
    while True:
        w = np.float32(rng.uniform(0.2, 0.3))
        if w * x == w * y:
            return x, y, w


def _mw_inputs(rng, n, b, anc, rates, ties, near=False):
    """Fleet-shape maxweight_claim inputs; `ties`: shared rates, so equal
    small queues score exactly alike; `near`: queues of 0 and 1, then 48
    queues of nextafter(x, 0), all at lower indices than 48 of x, under
    a remote rate that rounds the two products to one float (the lowest
    index must win, with the smaller queue)."""
    k = len(rates)
    q = rng.integers(0, 5, n).astype(np.float32)
    ids = rng.choice(n, b, replace=False).astype(np.int32)
    er = np.tile(rates, (b, 1))
    if not ties:
        er = er * rng.uniform(0.8, 1.2, (b, k))
    er = er.astype(np.float32)
    if near:
        x, y, w = near_tie(rng)
        q = np.minimum(q, 1).astype(np.float32)
        pos = np.sort(rng.choice(n, 96, replace=False))
        q[pos[:48]], q[pos[48:]] = y, x
        er[:, k - 1] = w
    anc = np.asarray(anc, np.int32)
    return q, anc, ids, anc[:, ids], er


def sched_topos():
    """(name, (D, M) table, rates) of phase 3's wwl_route and
    maxweight_claim checks at M = 10008: `fleet_route_topos` (depths 0-2,
    ragged sizes at depths 1-2), then the D=1 and D=2 tables with their
    columns permuted (not sorted: the all-pairs path)."""
    out = [(name, np.array(topo.ancestors), tuple(rates.as_array().tolist()))
           for name, topo, rates in fleet_route_topos()]
    perm = np.random.default_rng(7).permutation(M_FLEET)
    out += [(f"permuted {name}", anc[:, perm], rates)
            for name, anc, rates in out if name in ("D=1", "D=2")]
    return out


# profiler name fragments of each call's kernels: both passes of this
# tree's, the one all-pairs kernel of the parent's
SCHED_KERNEL_NAMES = {"wwl_route": "wwl_", "maxweight_claim": "maxweight_"}


def _sched_times(name, call, plain, prev_fn, reps=KERNEL_REPS):
    """ms by events, device ms a call (`_device_times`: the sum of its
    kernels' mean durations, each kernel's beside it, and how many
    kernels the profiler recorded) and plain ms; with `prev_fn`, the
    parent's kernel in the wrapper's place, by events and on the
    device."""
    from repro_torch.kernels import maxweight, wwl_route

    module = wwl_route if name == "wwl_route" else maxweight
    frag = SCHED_KERNEL_NAMES[name]
    split = _device_times(call, frag, reps)
    row = dict(ms=_time_ms(call, reps),
               device_ms=sum(split.values()) if split else None,
               device_ms_by_kernel=split, kernels_a_call=len(split) or None,
               plain_ms=_time_ms(plain, PLAIN_REPS),
               prev_ms=None, prev_device_ms=None)
    if prev_fn is not None:
        with mock.patch.object(module, "_fn", prev_fn):
            row.update(prev_ms=_time_ms(call, reps),
                       prev_device_ms=_device_ms(call, frag, reps))
    return row


def _checked_call(name, kernel, plain, args, want_path, prev_fn=None):
    """One call of the kernel against its plain version: (mismatches,
    max_abs_err, path); raises if the launch count does not move by one
    or the call took another path than `want_path`.  With `prev_fn`, the
    parent's kernel is also held against the plain version on the same
    inputs, and its mismatches are added."""
    from repro_torch.kernels import maxweight, ops, wwl_route

    module = wwl_route if name == "wwl_route" else maxweight
    before = ops.LAUNCHES[name]
    got = kernel(*args)
    if ops.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{name}: one call moved LAUNCHES by "
                             f"{ops.LAUNCHES[name] - before}")
    want = plain(*args)
    bad, err = _compare(got, want)
    path = module.last_path()
    if path != want_path:
        raise AssertionError(f"{name} took the {path} path, want "
                             f"{want_path}")
    if prev_fn is not None:
        with mock.patch.object(module, "_fn", prev_fn):
            bad += _compare(kernel(*args), want)[0]
    return bad, err, path


def phase_sched_kernels(dev, prev=None):
    """wwl_route and maxweight_claim against their plain versions at the
    fleet shapes (`sched_topos`: depths 0-2, ragged, permuted), with and
    without exact ties, and maxweight_claim at near-ties; which path each
    call took (group-restricted on the sorted tables, all-pairs on the
    permuted), read after the call; times by events, on the device a
    call (both passes) and, with `prev`, the parent's all-pairs kernels
    beside them on the same inputs."""
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(1)
    rows = {}
    for topo, anc, rates in sched_topos():
        d, k = anc.shape[0], len(rates)
        want_path = "all-pairs" if topo.startswith("permuted") else "group"
        for name, make, kernel, plain, bound, sets in (
                ("wwl_route", _wwl_inputs, ops.wwl_route, ref.wwl_route,
                 lambda a: _wwl_bound(a[2], a[3], k),
                 ((True, False), (False, False), (True, False))),
                ("maxweight_claim", _mw_inputs, ops.maxweight_claim,
                 ref.maxweight_claim, lambda a: _maxweight_bound(a[1], a[2],
                                                                 k),
                 ((True, False), (True, True), (False, False)))):
            mismatches, max_err, paths = 0, 0.0, []
            pfn = prev[name] if prev else None
            for ties, near in sets:
                extra = {"near": True} if near else {}
                host = make(rng, M_FLEET, B_FLEET, anc, rates, ties, **extra)
                args = [torch.as_tensor(x, device=dev) for x in host]
                bad, err, path = _checked_call(name, kernel, plain, args,
                                               want_path, pfn)
                mismatches += bad
                max_err = max(max_err, err)
                paths.append(path)
            row = dict(depth=d, mismatches=mismatches, max_abs_err=max_err,
                       paths=paths)
            row.update(_sched_times(name, lambda: kernel(*args),
                                    lambda: plain(*args), pfn))
            bound_ms, bound_by, nbytes, nops = bound(host)
            row.update(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       ops=nops)
            rows[(name, topo)] = row
            print(f"{name} M={M_FLEET} B={B_FLEET} {topo}: "
                  f"{json.dumps(row)}", flush=True)
            if mismatches:
                raise AssertionError(f"{name} kernel disagrees with its "
                                     f"plain version at {topo}: "
                                     f"{mismatches} rows")
    return rows


def _zero_counts():
    from repro_torch.kernels import ops
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0


def _check_counts(path: str, want: dict) -> dict:
    """The launch counts must equal `want`, every kernel it omits 0."""
    from repro_torch.kernels import ops
    got = dict(ops.LAUNCHES)
    want = {name: want.get(name, 0) for name in got}
    print(f"launches on the {path} path: {json.dumps(got)}", flush=True)
    if got != want:
        raise AssertionError(f"{path} path launched {got}, want {want}")
    return got


# ---------------------------------------------------------------------------
# The dense study (the paper's experiment)
# ---------------------------------------------------------------------------

STUDY_LOADS = (0.6, 0.8, 0.95)
STUDY_EPS = (0.1, 0.3)
STUDY_SEEDS = tuple(range(8))
# examples/quickstart.py --fast runs 4000/1000; cut to 2500/600 when a
# 4000 run took the whole script to 369 s on an H100, and to the drift
# study's 1000/250 when phase 12 came: 2500 took the script to 500 s;
# to 600/150 when phase 21 came (a CPU run of this phase at 600/150 kept
# every throughput gate and Balanced-PANDAS 7.73 below JSQ-MaxWeight
# 8.96 slots at rho 0.95)
STUDY_HORIZON, STUDY_WARMUP = 600, 150


def _study_cfg():
    from repro_torch.core import robustness as rb, simulator as sim
    return rb.StudyConfig(sim=sim.default_config(horizon=STUDY_HORIZON,
                                                 warmup=STUDY_WARMUP),
                          loads=STUDY_LOADS, eps_grid=STUDY_EPS,
                          seeds=STUDY_SEEDS)


def headline_claims(study) -> dict:
    """The paper's headline claims on the study, by the ported
    `examples.figures.headline_claims` on the study's figure rows: fig1
    every load at exact rates; figs 3/4 and 5/6 the figures' high loads
    (rho >= 0.9) at exact rates and each error of the figure's sign.
    (1) figs 1/2, BP's delay at most JSQ-MW's (the larger over loads);
    (2) figs 3-6, BP at or below JSQ-MW at every (load, eps), and BP's
    band (max - min over those settings) the narrower."""
    from repro_torch.examples import figures

    loads = [float(x) for x in study["loads"]]
    rows = []
    for algo, d in study["delay"].items():
        dm = d.mean(-1)   # (L, E); E is 1 for a rate-oblivious policy
        settings = study["est_settings"][:dm.shape[1]]
        rows += [{"figure": "fig1", "algo": algo, "load": load, "eps": 0.0,
                  "sign": 0, "mean_delay": float(dm[li, 0])}
                 for li, load in enumerate(loads)]
        for fig, sign in (("fig3_4", -1), ("fig5_6", 1)):
            rows += [{"figure": fig, "algo": algo, "load": load,
                      "eps": float(eps), "sign": sign,
                      "mean_delay": float(dm[li, e])}
                     for li, load in enumerate(loads) if load >= 0.9
                     for e, (_, eps, sg) in enumerate(settings)
                     if e == 0 or sg == sign]
    claims = figures.headline_claims(rows)
    return {"fig1_2_pandas_beats_jsq_mw": claims["fig1_pandas_beats_jsq_mw"],
            **{f"{fig}_{k}": claims[f"{fig}_{k}"]
               for fig in ("fig3_4", "fig5_6")
               for k in ("pandas_dominates_jsq_mw", "pandas_narrower_band")}}


def phase_study(dev):
    """The robustness study through `run_study` on the card (every policy
    on the dense path, no kernel launched), counts set to 0 before and
    read after."""
    from repro_torch.core import robustness as rb

    cfg = _study_cfg()
    _zero_counts()
    study = {"delay": {}, "throughput": {}, "final_n": {}}
    rates = {}
    for algo in rb.RATE_AWARE + rb.RATE_OBLIVIOUS:
        t0 = time.perf_counter()
        part = rb.run_study(cfg, algos=(algo,), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for key in ("delay", "throughput", "final_n"):
            study[key][algo] = part[key][algo]
        for key in ("capacity", "loads", "lam", "est_settings"):
            study[key] = part[key]
        cells = int(np.prod(part["delay"][algo].shape))
        rates[algo] = dict(cells=cells, wall_s=wall,
                           slots_per_s=cfg.sim.horizon / wall,
                           cell_slots_per_s=cells * cfg.sim.horizon / wall)
        print(f"study {algo}: {json.dumps(rates[algo])}", flush=True)
    print(rb.summarize(study), flush=True)
    _check_counts("dense study", {})

    lam = study["lam"]
    for algo, d in study["delay"].items():
        if not np.isfinite(d).all():
            raise AssertionError(f"{algo}: mean_delay not finite: {d}")
        if algo == "fifo":
            continue  # FIFO may diverge inside the others' region (Fig. 1)
        for li, load in enumerate(STUDY_LOADS):
            if load > 0.8:
                continue
            thru = float(study["throughput"][algo][li, 0].mean())
            if abs(thru - lam[li]) > 0.02 * lam[li]:
                raise AssertionError(f"{algo} at rho {load}: throughput "
                                     f"{thru} not within 2% of {lam[li]}")
    li = STUDY_LOADS.index(0.95)
    bp = float(study["delay"]["balanced_pandas"][li, 0].mean())
    mw = float(study["delay"]["jsq_maxweight"][li, 0].mean())
    print(f"rho 0.95, exact rates: balanced_pandas {bp:.4f} vs "
          f"jsq_maxweight {mw:.4f} slots", flush=True)
    if not bp <= mw:
        raise AssertionError(f"Balanced-PANDAS {bp} above JSQ-MaxWeight "
                             f"{mw} at rho 0.95 with exact rates")
    claims = headline_claims(study)
    print(f"headline claims: {json.dumps(claims)}", flush=True)


def phase_bench(dev, prev=None):
    """benchmarks/bench_kernels.py's scheduler rows at full width, counts
    set to 0 before and read after, then each kernel against its plain
    version (the group-restricted path, as the sorted rack map gives)
    and timed: by events, on the device a call (both passes) and, with
    `prev`, the parent's all-pairs kernel in its place."""
    from repro_torch.kernels import maxweight, ops, ref, wwl_route

    rng = np.random.default_rng(0)
    m, b = M_BENCH, B_BENCH
    rates = np.asarray([0.5, 0.45, 0.25], np.float32)
    wl = rng.uniform(0, 50, m).astype(np.float32)
    sr = (np.arange(m) // 64).astype(np.int32)
    tl = np.sort(rng.integers(0, m, (b, 3)), axis=1).astype(np.int32)
    q = rng.integers(0, 5, m).astype(np.float32)
    ids = rng.choice(m, b, replace=False).astype(np.int32)
    g = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    wwl_args = (g(wl), g(np.tile(rates, (m, 1))), g(sr), g(tl))
    mw_args = (g(q), g(sr), g(ids), g(sr[ids]), g(np.tile(rates, (b, 1))))

    _zero_counts()
    wwl_out = ops.wwl_route(*wwl_args)
    wwl_path = wwl_route.last_path()
    mw_out = ops.maxweight_claim(*mw_args)
    mw_path = maxweight.last_path()
    launches = _check_counts("bench", {"wwl_route": 1,
                                       "maxweight_claim": 1})
    rows = {}
    for name, out, path, kernel, plain, args, bound in (
            ("wwl_route", wwl_out, wwl_path, ops.wwl_route, ref.wwl_route,
             wwl_args, _wwl_bound(sr[None], tl, 3)),
            ("maxweight_claim", mw_out, mw_path, ops.maxweight_claim,
             ref.maxweight_claim, mw_args, _maxweight_bound(sr[None], ids,
                                                            3))):
        bad, err = _compare(out, plain(*args))
        pfn = prev[name] if prev else None
        if pfn is not None:
            bad += _checked_call(name, kernel, plain, args, path, pfn)[0]
        rows[name] = dict(mismatches=bad, max_abs_err=err, path=path,
                          bound_ms=bound[0], bound_by=bound[1],
                          bytes=bound[2], ops=bound[3])
        rows[name].update(_sched_times(name, lambda: kernel(*args),
                                       lambda: plain(*args), pfn))
        print(f"{name} bench M={m} B={b}: {json.dumps(rows[name])}",
              flush=True)
        if bad:
            raise AssertionError(f"{name} at bench width: {bad} mismatches")
        if path != "group":
            raise AssertionError(f"{name} at bench width took the {path} "
                                 f"path on a sorted rack map")
        torch.cuda.empty_cache()
    return launches, rows


DENSE_ONLY = ("blind_pandas", "slo_pandas")   # not in the dense study


def _no_sync(step, carry, draw, slots: int):
    """`slots` calls of ``carry = step(carry, t, draw(t))`` under sync
    debug mode "error" (the first call outside it)."""
    carry = step(carry, 0, draw(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, slots):
            carry = step(carry, t, draw(t))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_dense_loop(dev, slots: int = 32, fleet_cfg=None):
    """No host sync in any policy's slot loop (sync debug mode "error"):
    every registered policy's dense step and, given `fleet_cfg`, the
    batched fleet steps of Balanced-PANDAS and power-of-d at the fleet
    study's 30 cells; then the Balanced-PANDAS dense step at the study's
    120 cells: steady slots/s and a profiled window (launches a slot,
    busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import locality as loc, robustness as rb
    from repro_torch.core import simulator as sim
    from repro_torch.core.policy import make_policy
    from repro_torch.core.rng import DenseDeviceSource

    cfg = _study_cfg().sim
    m = cfg.topo.num_servers
    cap = loc.capacity_hot_rack(cfg.topo, cfg.true_rates, cfg.p_hot)
    ests = [sim.make_estimates(cfg, "network", 0.0, -1)]
    ests += [sim.make_estimates(cfg, "per_server", e, s)
             for s in (-1, 1) for e in STUDY_EPS]
    cells = [(seed, np.float32(load * cap), e)
             for load in STUDY_LOADS for e in range(len(ests))
             for seed in STUDY_SEEDS]

    def build(name):
        est = torch.as_tensor(np.stack([ests[e] for _, _, e in cells]),
                              device=dev)
        pol, init, step, _, _ = sim._build_dense_step(name, cfg, est, dev)
        src = DenseDeviceSource([(s, lam) for s, lam, _ in cells],
                                make_policy(name).draw_plan(m),
                                cfg.max_arrivals, m, dev)
        return init(), step, src

    for name in rb.RATE_AWARE + rb.RATE_OBLIVIOUS + DENSE_ONLY:
        carry, step, src = build(name)
        _no_sync(step, carry, src.slot, 24)
    print("dense slot loop: no host sync in 23 slots of every policy",
          flush=True)
    if fleet_cfg is not None:
        from repro_torch.core.rng import DeviceSource
        from repro_torch.sharding import sim as fleet

        fm = fleet_cfg.topo.num_servers
        fcap = loc.capacity_hot_rack(fleet_cfg.topo, fleet_cfg.true_rates,
                                     fleet_cfg.p_hot)
        fests = [sim.make_estimates(fleet_cfg, "network", 0.0, -1)]
        fests += [sim.make_estimates(fleet_cfg, "per_server", e, sg)
                  for sg in (-1, 1) for e in FLEET_STUDY_EPS]
        fcells = [(s, np.float32(load * fcap), e)
                  for load in FLEET_STUDY_LOADS for e in range(len(fests))
                  for s in FLEET_STUDY_SEEDS]
        est = torch.as_tensor(np.stack([fests[e] for _, _, e in fcells]),
                              device=dev)
        for name in FLEET_STUDY_ALGOS:
            init, fstep = fleet._build_fleet_step(name, fleet_cfg,
                                                  fleet.FleetConfig(), dev)
            src = DeviceSource([(s, lam) for s, lam, _ in fcells],
                               fleet_cfg.max_arrivals, fm, dev,
                               fleet.candidates(name))
            _no_sync(lambda c, t, d: fstep(c, t, est, d), init(len(fcells)),
                     src.slot, 8)
        print(f"fleet slot loop: no host sync in 7 slots of "
              f"{FLEET_STUDY_ALGOS} at {len(fcells)} cells", flush=True)

    carry, step, src = build("balanced_pandas")
    t = 0

    def run(n):
        nonlocal carry, t
        for _ in range(n):
            carry = step(carry, t, src.slot(t))
            t += 1
        torch.cuda.synchronize()

    run(16)
    t0 = time.perf_counter()
    run(slots)
    steady = slots / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(slots)
        window_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kern)
    out = {"cells": len(cells), "slots_per_s_steady": steady,
           "window_slots": slots,
           "window_ms_per_slot": window_us / slots / 1e3,
           "device_busy_share": busy_us / window_us if kern else None,
           "device_launches_per_slot": sum(k[1] for k in kern) / slots,
           "top_kernels_us_per_slot": [[k[2][:60], k[0] / slots]
                                       for k in kern[:6]]}
    print(f"profile dense balanced_pandas: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The scenario slice: the drift study on the dense path (phase 12a)
# ---------------------------------------------------------------------------

# examples/drift_study.py's study (Topology(24, 6), load 0.75, the seven
# DRIFT_SCENARIOS), its depth cut from 8000 / 2000 slots (to 600 / 150
# from 1000 / 250 to make room for phase 16 within the time limit, then to
# 300 / 75 for phase 18: at 300 / 75 the gated arms' least throughput
# stayed 4-8% above the 0.9 lam floor in a CPU run of this phase)
DRIFT_HORIZON, DRIFT_WARMUP = 300, 75
DRIFT_SEEDS = tuple(range(8))
DRIFT_LOAD = 0.75
DRIFT_GATED = ("static", "stragglers", "rack_congestion")
DRIFT_ARMS = {"balanced_pandas": "fixed_prior", "blind_pandas": "blind_ewma"}


def phase_drift(dev) -> dict:
    """Phase 12a: `drift_study` over the 7 drift scenarios on the card,
    each arm's sweep timed, launch counts 0 before and after (the dense
    path runs no kernel, as in the reference); the static fixed-prior
    sweep against the same sweep without a scenario, every metric bit for
    bit; the scenario slot loop free of host syncs.  Fatal: a delay not
    finite, or an arm's throughput under 0.9 x lam x the window's mean
    lam_mult in any seed of `DRIFT_GATED`."""
    from repro_torch import workloads as wl
    from repro_torch.core import locality as loc, robustness as rb
    from repro_torch.core import simulator as sim
    from repro_torch.core.policy import make_policy
    from repro_torch.core.rng import DenseDeviceSource

    cfg = rb.StudyConfig(sim=sim.default_config(horizon=DRIFT_HORIZON,
                                                warmup=DRIFT_WARMUP),
                         seeds=DRIFT_SEEDS)
    scfg = cfg.sim
    runs, sweep = {}, sim.sweep

    def timed_sweep(policy, *args, scenario=None, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(policy, *args, scenario=scenario, **kw)
        torch.cuda.synchronize()
        name = getattr(policy, "name", policy)
        runs[(scenario, DRIFT_ARMS[name])] = (time.perf_counter() - t0, out)
        return out

    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(sim, "sweep", timed_sweep):
        study = rb.drift_study(cfg, rb.DRIFT_SCENARIOS, load=DRIFT_LOAD,
                               device=dev)
    wall = time.perf_counter() - t0
    _check_counts("drift study", {})
    print(rb.summarize_drift(study), flush=True)
    cells = len(DRIFT_SEEDS)
    rates = {f"{scen}/{arm}": dict(
        wall_s=sec, cell_slots_per_s=cells * DRIFT_HORIZON / sec)
        for (scen, arm), (sec, _) in runs.items()}
    print(f"phase 12a, drift study arms: {json.dumps(rates)}", flush=True)
    print(f"phase 12a, blind_wins: {json.dumps(study['blind_wins'])}; "
          f"{wall:.1f} s for {len(runs)} sweeps of {cells} cells x "
          f"{DRIFT_HORIZON} slots", flush=True)

    lam = float(study["capacity"]) * DRIFT_LOAD
    gates = {}
    for scen in rb.DRIFT_SCENARIOS:
        sched = wl.compile_schedule(wl.make_scenario(scen), scfg.topo,
                                    DRIFT_HORIZON, scfg.p_hot, device=dev)
        want = 0.9 * lam * wl.mean_lam_mult_over(sched, DRIFT_WARMUP,
                                                 DRIFT_HORIZON)
        for arm in study["arms"]:
            d = study["delay"][scen][arm]
            if not np.isfinite(d).all():
                raise AssertionError(f"drift {scen}/{arm}: delay not "
                                     f"finite: {d}")
            thru = float(study["throughput"][scen][arm].min())
            gates[f"{scen}/{arm}"] = dict(min_throughput=thru, floor=want)
            if scen in DRIFT_GATED and thru < want:
                raise AssertionError(f"drift {scen}/{arm}: throughput "
                                     f"{thru} under {want}")
    print(f"phase 12a, throughput gates: {json.dumps(gates)}", flush=True)

    # "static" is the run without a scenario, bit for bit
    _, static = runs[("static", "fixed_prior")]
    est = sim.make_estimates(scfg, "network", 0.0, -1)[None]
    none = sweep("balanced_pandas", scfg,
                 np.asarray([DRIFT_LOAD], np.float32) * study["capacity"],
                 est, np.asarray(DRIFT_SEEDS), device=dev)
    if set(none) != set(static) or any(
            not np.array_equal(none[k], static[k]) for k in none):
        raise AssertionError("the static scenario differs from the run "
                             "without a scenario")
    print("phase 12a: scenario static equals no scenario bit for bit "
          f"({sorted(none)})", flush=True)

    # no host sync in the scenario slot loop, the weighted arrival path
    # (which no drift scenario takes) included
    weighted = wl.Scenario("weighted", (
        wl.Segment(0.0),
        wl.Segment(0.3, lam_mult=1.2, rack_weights=(4.0, 1.0, 0.0, 2.0),
                   tier_mult=(1.0, 0.7, 0.5))))
    m = scfg.topo.num_servers
    cap = loc.capacity_hot_rack(scfg.topo, scfg.true_rates, scfg.p_hot)
    cells_l = [(s, np.float32(DRIFT_LOAD * cap)) for s in DRIFT_SEEDS]
    est_t = torch.as_tensor(np.repeat(est, len(cells_l), 0), device=dev)

    def build(name, scen):
        sched = wl.compile_schedule(wl.make_scenario(scen), scfg.topo,
                                    DRIFT_HORIZON, scfg.p_hot, device=dev)
        _, init, step, _, _ = sim._build_dense_step(name, scfg, est_t,
                                                    dev, sched)
        src = DenseDeviceSource(cells_l, make_policy(name).draw_plan(m),
                                scfg.max_arrivals, m, dev, sched)
        return init(), step, src

    for name, scen in (("balanced_pandas", "stragglers"),
                       ("blind_pandas", "rack_congestion"),
                       ("balanced_pandas", "diurnal"),
                       ("balanced_pandas", weighted)):
        carry, step, src = build(name, scen)
        _no_sync(step, carry, src.slot, 24)
    print("phase 12a: no host sync in 23 slots of the scenario slot loop "
          "(stragglers, rack_congestion, diurnal, per-rack weights)",
          flush=True)

    # a profiled window of the fixed-prior arm's slot, static against a
    # multi-segment scenario: launches a slot and the busy share
    windows = {}
    for scen in ("static", "stragglers"):
        carry, step, src = build("balanced_pandas", scen)
        t = 0

        def one():
            nonlocal carry, t
            carry = step(carry, t, src.slot(t))
            t += 1

        for _ in range(8):
            one()
        windows[scen] = _profile_window(dev, one, 32)
    print(f"phase 12a, profiled windows of the fixed-prior slot: "
          f"{json.dumps(windows)}", flush=True)
    return dict(wall_s=wall, arms=rates, blind_wins=study["blind_wins"],
                windows=windows)


# ---------------------------------------------------------------------------
# The placement slice: the placement study on the dense path (phase 13a)
# and placement-sampled types through the scheduling kernels (phase 13c)
# ---------------------------------------------------------------------------

# examples/placement_study.py's study (Topology(24, 6), load 0.7, the four
# PLACEMENTS x the three PLACEMENT_POLICIES), under the scenarios static
# and rack_congestion, its depth cut from 8000 / 2000 slots (to 400 / 100
# from 500 / 125 to hold the phase near 120 s, then to 300 / 75 for phase
# 18: at 300 / 75 a CPU run of this phase kept every static throughput
# 4-6% above the 0.9 lam floor and the rack-aware placements' delays
# 2.27-2.49 against uniform's 3.20)
PLACE_HORIZON, PLACE_WARMUP = 300, 75
PLACE_SEEDS = tuple(range(8))
PLACE_LOAD = 0.7
PLACE_SCENARIOS = ("static", "rack_congestion")
PLACE_NONDEFAULT = ("hdfs", "spread", "hot_aware")


def phase_placement(dev) -> dict:
    """Phase 13a: `placement_study` on the card, each sweep timed, launch
    counts 0 before and after (the dense path runs no kernel); the
    uniform Balanced-PANDAS sweep against the same sweep without a
    placement, every metric bit for bit; the slot loop of each non-uniform
    placement free of host syncs, static and under per-rack weights; a
    profiled window of the Balanced-PANDAS slot under each placement.
    Fatal: a delay not finite, a throughput in any static seed under 0.9
    x lam, uniform unequal to no placement, a host sync, or a rack-aware
    placement's static Balanced-PANDAS delay not below uniform's."""
    from repro_torch import workloads as wl
    from repro_torch.core import robustness as rb, simulator as sim
    from repro_torch.core.policy import make_policy
    from repro_torch.core.rng import DenseDeviceSource
    from repro_torch.placement import make_placement

    cfg = rb.StudyConfig(sim=sim.default_config(horizon=PLACE_HORIZON,
                                                warmup=PLACE_WARMUP),
                         seeds=PLACE_SEEDS)
    scfg = cfg.sim
    runs, sweep = {}, sim.sweep

    def timed_sweep(policy, *args, scenario=None, placement=None, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(policy, *args, scenario=scenario, placement=placement,
                    **kw)
        torch.cuda.synchronize()
        name = getattr(policy, "name", policy)
        runs[(placement, scenario, name)] = (time.perf_counter() - t0, out)
        return out

    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(sim, "sweep", timed_sweep):
        study = rb.placement_study(cfg, rb.PLACEMENTS, rb.PLACEMENT_POLICIES,
                                   PLACE_SCENARIOS, load=PLACE_LOAD,
                                   device=dev)
    wall = time.perf_counter() - t0
    _check_counts("placement study", {})
    print(rb.summarize_placement(study), flush=True)
    cells = len(PLACE_SEEDS)
    rates = {f"{plc}/{scen}/{pol}": dict(
        wall_s=sec, cell_slots_per_s=cells * PLACE_HORIZON / sec)
        for (plc, scen, pol), (sec, _) in runs.items()}
    sweep_s = sum(sec for sec, _ in runs.values())
    print(f"phase 13a, placement study sweeps: {json.dumps(rates)}",
          flush=True)
    print(f"phase 13a, fluid capacities: {json.dumps(study['capacity'])} "
          f"(uniform closed form {study['capacity_uniform']}); {wall:.1f} s "
          f"for {len(runs)} sweeps of {cells} cells x {PLACE_HORIZON} slots "
          f"({sweep_s:.1f} s in the sweeps)", flush=True)

    lam = float(np.float32(PLACE_LOAD) * np.float32(study["capacity_uniform"]))
    gates = {}
    for (plc, scen, pol), (_, out) in runs.items():
        d, thru = out["mean_delay"], float(out["throughput"].min())
        if not np.isfinite(d).all():
            raise AssertionError(f"placement {plc}/{scen}/{pol}: delay not "
                                 f"finite: {d}")
        if scen == "static":
            gates[f"{plc}/{pol}"] = dict(min_throughput=thru,
                                         floor=0.9 * lam)
            if thru < 0.9 * lam:
                raise AssertionError(f"placement {plc}/{pol}: static "
                                     f"throughput {thru} under {0.9 * lam}")
    delay = {plc: float(study["delay"][plc]["static"]["balanced_pandas"]
                        .mean()) for plc in rb.PLACEMENTS}
    print(f"phase 13a, throughput gates: {json.dumps(gates)}; static "
          f"Balanced-PANDAS delays {json.dumps(delay)}", flush=True)
    worse = [p for p in PLACE_NONDEFAULT if not delay[p] < delay["uniform"]]
    if worse:
        raise AssertionError(f"static Balanced-PANDAS on {worse} not below "
                             f"uniform's {delay['uniform']}: {delay}")

    # "uniform" is the run without a placement, bit for bit
    _, unif = runs[("uniform", "static", "balanced_pandas")]
    est = sim.make_estimates(scfg, "network", 0.0, -1)[None]
    none = sweep("balanced_pandas", scfg,
                 np.asarray([PLACE_LOAD], np.float32)
                 * study["capacity_uniform"], est,
                 np.asarray(PLACE_SEEDS), device=dev)
    if set(none) != set(unif) or any(
            not np.array_equal(none[k], unif[k]) for k in none):
        raise AssertionError("the uniform placement differs from the run "
                             "without a placement")
    print("phase 13a: placement uniform equals no placement bit for bit "
          f"({sorted(none)})", flush=True)

    # no host sync in any placement's slot loop, static and weighted
    weighted = wl.Scenario("weighted", (
        wl.Segment(0.0),
        wl.Segment(0.3, lam_mult=1.2, rack_weights=(4.0, 1.0, 0.0, 2.0),
                   tier_mult=(1.0, 0.7, 0.5))))
    m = scfg.topo.num_servers
    cells_l = [(s, np.float32(lam)) for s in PLACE_SEEDS]
    est_t = torch.as_tensor(np.repeat(est, len(cells_l), 0), device=dev)

    def build(name, scen, plc):
        sched = wl.compile_schedule(wl.make_scenario(scen), scfg.topo,
                                    PLACE_HORIZON, scfg.p_hot, device=dev)
        _, init, step, _, _ = sim._build_dense_step(name, scfg, est_t,
                                                    dev, sched, plc)
        src = DenseDeviceSource(cells_l, make_policy(name).draw_plan(m),
                                scfg.max_arrivals, m, dev, sched,
                                make_placement(plc).gumbel_blocks(scfg.topo))
        return init(), step, src

    for plc in PLACE_NONDEFAULT:
        for name, scen in (("balanced_pandas", "static"),
                           ("jsq_maxweight", weighted)):
            carry, step, src = build(name, scen, plc)
            _no_sync(step, carry, src.slot, 24)
    print("phase 13a: no host sync in 23 slots of the slot loop under "
          f"{PLACE_NONDEFAULT} (Balanced-PANDAS static, JSQ-MaxWeight under "
          "per-rack weights)", flush=True)

    # a profiled window of the Balanced-PANDAS slot under each placement,
    # 8 slots each: the profiler's processing of a window's events, not
    # the slots, sets the phase's time
    windows = {}
    for plc in rb.PLACEMENTS:
        carry, step, src = build("balanced_pandas", "static", plc)
        t = 0

        def one():
            nonlocal carry, t
            carry = step(carry, t, src.slot(t))
            t += 1

        for _ in range(8):
            one()
        windows[plc] = _profile_window(dev, one, 8)
    print(f"phase 13a, profiled windows of the Balanced-PANDAS slot: "
          f"{json.dumps(windows)}", flush=True)
    return dict(wall_s=wall, sweeps=rates, capacity=study["capacity"],
                delay_static_bp=delay, windows=windows)


# (name, topology, batch) of phase 13c: the reference test's K=4 shape and
# the fleet shape at depth 1
PLACE_KERNEL_SHAPES = (("24x(4,12)", (24, (4, 12)), 9),
                       ("fleet D=1", (M_FLEET, 6), B_FLEET))
PLACE_KERNEL_RATES = {3: (0.5, 0.45, 0.25), 4: (0.5, 0.45, 0.35, 0.25)}


def phase_placement_kernels(dev) -> dict:
    """Phase 13c (tests/test_placement.py's placement-sampled types
    through both kernels, on the card): types drawn on the card by each
    non-uniform placement's sampler go through `ops.wwl_route` and, as
    the queue lengths (each server's replica count), `ops.maxweight_claim`
    at `PLACE_KERNEL_SHAPES`, each call held bit for bit against its plain
    version on the group-restricted path; the racks a task's replicas
    span are recorded.  Fatal: a mismatch, a call on another path."""
    from repro_torch.core import locality as loc
    from repro_torch.kernels import ops, ref
    from repro_torch.placement import sample_placement_types

    rng = np.random.default_rng(13)
    rows, bad = {}, {"wwl_route": 0, "maxweight_claim": 0}
    for shape, (m, groups), b in PLACE_KERNEL_SHAPES:
        topo = loc.Topology(m, groups)
        k = topo.num_tiers
        anc_np = np.array(topo.ancestors, np.int32)
        anc = torch.as_tensor(anc_np, device=dev)
        rates = PLACE_KERNEL_RATES[k]
        for name in PLACE_NONDEFAULT:
            t0 = time.perf_counter()
            types = sample_placement_types(topo, name, 0.5, b, seed=21,
                                           device=dev)
            sample_s = time.perf_counter() - t0
            span = np.bincount([len(set(anc_np[0, row])) for row in types],
                               minlength=4)[1:].tolist()
            wlv = rng.uniform(0, 50, m).astype(np.float32)
            er = (np.tile(rates, (m, 1))
                  * rng.uniform(0.8, 1.2, (m, k))).astype(np.float32)
            args = [torch.as_tensor(x, device=dev)
                    for x in (wlv, er, anc_np, types)]
            w_bad, w_err, _ = _checked_call("wwl_route", ops.wwl_route,
                                            ref.wwl_route, args, "group")
            q = np.bincount(types.ravel(), minlength=m).astype(np.float32)
            ids = rng.choice(m, b, replace=False).astype(np.int32)
            er2 = (np.tile(rates, (b, 1))
                   * rng.uniform(0.8, 1.2, (b, k))).astype(np.float32)
            args = [torch.as_tensor(q, device=dev), anc,
                    torch.as_tensor(ids, device=dev),
                    anc[:, torch.as_tensor(ids, device=dev)],
                    torch.as_tensor(er2, device=dev)]
            q_bad, q_err, _ = _checked_call("maxweight_claim",
                                            ops.maxweight_claim,
                                            ref.maxweight_claim, args,
                                            "group")
            bad["wwl_route"] += w_bad
            bad["maxweight_claim"] += q_bad
            rows[f"{shape}/{name}"] = dict(
                m=m, batch=b, racks_spanned_1_2_3=span, sample_s=sample_s,
                wwl_mismatches=w_bad, wwl_max_abs_err=w_err,
                maxweight_mismatches=q_bad, maxweight_max_abs_err=q_err)
            print(f"phase 13c, {shape} {name}: "
                  f"{json.dumps(rows[f'{shape}/{name}'])}", flush=True)
    if any(bad.values()):
        raise AssertionError(f"placement-sampled types: kernels disagree "
                             f"with their plain versions: {bad}")
    return dict(rows=rows, mismatches=bad)


# ---------------------------------------------------------------------------
# The replication slice: the replication study on the dense path (phase
# 14a) and post-repair replica rows through the scheduling kernels (14c)
# ---------------------------------------------------------------------------

# examples/replication_study.py's study (Topology(24, 6), loads 0.7 and
# 0.95 of the healthy capacity, the three REPLICATIONS x the two
# REPLICATION_SCENARIOS x the two REPLICATION_POLICIES), its depth cut
# from 8000 / 2000 slots (to 300 / 75 from 400 / 100 to hold phase 14
# near 100 s); the checks that need no long run (static against no
# replication, host syncs, profiled windows) run at REPL_CHECK_HORIZON
REPL_HORIZON, REPL_WARMUP = 300, 75
REPL_CHECK_HORIZON = 100
REPL_SEEDS = tuple(range(8))
REPL_LOADS = (0.7, 0.95)
# the lifecycle metrics that follow no draw under fixed and repair
REPL_NO_DRAW = ("availability", "data_loss_frac", "mean_replication",
                "final_replication", "repair_moves", "dropped_replicas",
                "migration_busy_slots", "max_concurrent_moves")
CORE_METRICS = ("mean_n", "mean_delay", "throughput", "final_n")


def phase_replication(dev) -> dict:
    """Phase 14a: `replication_study` on the card, each sweep timed, launch
    counts 0 before and after (the dense path runs no kernel); "fixed"
    and "repair" under static against the run without replication;
    rack_loss + spread + repair once; the slot loop free of host syncs
    under server_loss with each controller; a profiled window of 8
    Balanced-PANDAS slots under server_loss + repair and under static
    without replication.  Fatal: a delay not finite, a server_loss
    throughput at rho 0.7 under 0.9 x lam in any cell, "fixed" under
    static unequal to no replication in any metric, "repair" unequal to
    it in the core metrics, a host sync, a fixed or repair lifecycle
    metric (`REPL_NO_DRAW`) that differs between cells or between the
    two policies of a scenario, fixed with a repair move, repair's
    final replication not above fixed's under server_loss, or a data
    loss under rack_loss + spread."""
    from repro_torch import workloads as wl
    from repro_torch.core import locality as loc, robustness as rb
    from repro_torch.core import simulator as sim
    from repro_torch.core.policy import make_policy
    from repro_torch.core.rng import DenseDeviceSource

    cfg = rb.StudyConfig(sim=sim.default_config(horizon=REPL_HORIZON,
                                                warmup=REPL_WARMUP),
                         seeds=REPL_SEEDS)
    scfg = cfg.sim
    runs, sweep = {}, sim.sweep

    def timed_sweep(policy, *args, scenario=None, replication=None, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(policy, *args, scenario=scenario, replication=replication,
                    **kw)
        torch.cuda.synchronize()
        runs[(scenario, replication, policy)] = (time.perf_counter() - t0,
                                                 out)
        return out

    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(sim, "sweep", timed_sweep):
        study = rb.replication_study(cfg, loads=REPL_LOADS, device=dev)
    wall = time.perf_counter() - t0
    _check_counts("replication study", {})
    print(rb.summarize_replication(study), flush=True)
    cells = len(REPL_SEEDS) * len(REPL_LOADS)
    rates = {f"{scen}/{ctrl}/{pol}": dict(
        wall_s=sec, cell_slots_per_s=cells * REPL_HORIZON / sec)
        for (scen, ctrl, pol), (sec, _) in runs.items()}
    sweep_s = sum(sec for sec, _ in runs.values())
    print(f"phase 14a, replication study sweeps: {json.dumps(rates)}",
          flush=True)
    print(f"phase 14a: {wall:.1f} s for {len(runs)} sweeps of {cells} cells "
          f"x {REPL_HORIZON} slots ({sweep_s:.1f} s in the sweeps)",
          flush=True)

    lam = np.asarray(REPL_LOADS, np.float32) * np.float32(study["capacity"])
    table, gates = {}, {}
    for (scen, ctrl, pol), (_, out) in runs.items():
        d = out["mean_delay"]
        if not np.isfinite(d).all():
            raise AssertionError(f"replication {scen}/{ctrl}/{pol}: delay "
                                 f"not finite: {d}")
        table[f"{scen}/{ctrl}/{pol}"] = {
            k: out[k][:, 0].mean(axis=-1).tolist() for k in
            ("mean_delay", "throughput", "availability", "data_loss_frac",
             "mean_replication", "final_replication", "repair_moves",
             "lost_tasks", "migration_busy_slots", "max_concurrent_moves")}
        if scen == "server_loss":
            thru = float(out["throughput"][0].min())
            gates[f"{ctrl}/{pol}"] = dict(min_throughput=thru,
                                          floor=0.9 * float(lam[0]))
            if thru < 0.9 * lam[0]:
                raise AssertionError(f"replication server_loss/{ctrl}/{pol}"
                                     f": throughput {thru} at rho "
                                     f"{REPL_LOADS[0]} under {0.9 * lam[0]}")
    print(f"phase 14a, table (means over seeds, one entry a load): "
          f"{json.dumps(table)}", flush=True)
    print(f"phase 14a, server_loss throughput gates: {json.dumps(gates)}",
          flush=True)
    for scen in rb.REPLICATION_SCENARIOS:
        for ctrl in ("fixed", "repair"):
            first = None
            for pol in rb.REPLICATION_POLICIES:
                out = runs[(scen, ctrl, pol)][1]
                for k in REPL_NO_DRAW:
                    v = out[k]
                    if not (v == v.flat[0]).all() or (
                            first is not None and v.flat[0] != first[k]):
                        raise AssertionError(
                            f"replication {scen}/{ctrl}: {k} follows a draw"
                            f" ({pol}: {v.ravel().tolist()})")
                first = {k: out[k].flat[0] for k in REPL_NO_DRAW}
            if ctrl == "fixed" and first["repair_moves"] != 0:
                raise AssertionError(f"fixed made repair moves under {scen}")
    fin = {ctrl: float(runs[("server_loss", ctrl, "balanced_pandas")][1]
                       ["final_replication"].flat[0])
           for ctrl in ("fixed", "repair")}
    if not fin["repair"] > fin["fixed"]:
        raise AssertionError(f"server_loss: repair's final replication "
                             f"{fin['repair']} not above fixed's "
                             f"{fin['fixed']}")

    # static: "fixed" is the run without replication in every metric,
    # "repair" in the core metrics (no deficit, no move, reads drawn
    # from a generator of their own)
    est = sim.make_estimates(scfg, "network", 0.0, -1)[None]
    seeds = np.asarray(REPL_SEEDS)
    ccfg = sim.default_config(horizon=REPL_CHECK_HORIZON,
                              warmup=REPL_CHECK_HORIZON // 4)
    none = sweep("balanced_pandas", ccfg, lam, est, seeds, device=dev)
    for ctrl in ("fixed", "repair"):
        got = sweep("balanced_pandas", ccfg, lam, est, seeds,
                    scenario="static", replication=ctrl, device=dev)
        if ctrl == "fixed" and set(none) != set(got):
            raise AssertionError(f"static fixed: keys {sorted(got)} "
                                 f"against {sorted(none)}")
        keys = sorted(none) if ctrl == "fixed" else CORE_METRICS
        bad = [k for k in keys if not np.array_equal(none[k], got[k])]
        if bad:
            raise AssertionError(f"static {ctrl} differs from the run "
                                 f"without replication in {bad}")
    print("phase 14a: static fixed equals no replication in every metric, "
          "static repair in the core metrics", flush=True)
    spread = sweep("balanced_pandas", scfg, lam, est, seeds,
                   scenario="rack_loss", placement="spread",
                   replication="repair", device=dev)
    spread_row = {k: spread[k][:, 0].mean(axis=-1).tolist() for k in (
        "mean_delay", "availability", "data_loss_frac", "repair_moves",
        "final_replication")}
    print(f"phase 14a, rack_loss + spread + repair: "
          f"{json.dumps(spread_row)}", flush=True)
    if (spread["data_loss_frac"] != 0).any():
        raise AssertionError(f"rack_loss + spread lost data: "
                             f"{spread['data_loss_frac'].ravel().tolist()}")

    # no host sync in the slot loop under server_loss, each controller
    m = scfg.topo.num_servers
    cap = loc.capacity_hot_rack(scfg.topo, scfg.true_rates, scfg.p_hot)
    cells_l = [(s, np.float32(REPL_LOADS[0] * cap)) for s in REPL_SEEDS]
    est_t = torch.as_tensor(np.repeat(est, len(cells_l), 0), device=dev)

    def build(name, scen, ctrl):
        sched = wl.compile_schedule(wl.make_scenario(scen), ccfg.topo,
                                    REPL_CHECK_HORIZON, ccfg.p_hot,
                                    device=dev)
        _, init, step, rep, _ = sim._build_dense_step(
            name, ccfg, est_t, dev, sched, None, ctrl)
        src = DenseDeviceSource(cells_l, make_policy(name).draw_plan(m),
                                scfg.max_arrivals, m, dev, sched, 0,
                                None if rep is None else rep.read_cdf)
        return init(), step, src

    # server_loss's window opens at 0.35 x the horizon: check inside it
    start = int(0.375 * REPL_CHECK_HORIZON)
    for ctrl in rb.REPLICATIONS:
        carry, step, src = build("balanced_pandas", "server_loss", ctrl)
        for t in range(start):
            carry = step(carry, t, src.slot(t))
        _no_sync(lambda c, t, d: step(c, t + start, d), carry,
                 lambda t: src.slot(t + start), 24)
    print(f"phase 14a: no host sync in 23 slots of the slot loop under "
          f"server_loss with {rb.REPLICATIONS}", flush=True)

    # a profiled window of 8 Balanced-PANDAS slots, one profiler session
    # each: server_loss + repair inside its window, static without
    # replication
    windows = {}
    for label, scen, ctrl in (("server_loss/repair", "server_loss",
                               "repair"), ("static/none", "static", None)):
        carry, step, src = build("balanced_pandas", scen, ctrl)
        t = 0

        def one():
            nonlocal carry, t
            carry = step(carry, t, src.slot(t))
            t += 1

        for _ in range(start):
            one()
        windows[label] = _profile_window(dev, one, 8)
    print(f"phase 14a, profiled windows of the Balanced-PANDAS slot: "
          f"{json.dumps(windows)}", flush=True)
    return dict(wall_s=wall, sweeps=rates, table=table, spread=spread_row,
                windows=windows)


# (name, topology, batch, chunks, dead servers, observes) of phase 14c:
# the reference test's K=4 shape, and the quickstart's width with racks of
# 64 and one whole rack dead (its storm of about 34 moves needs more than
# 200 observes at 4 lanes)
REPL_KERNEL_SHAPES = (("24x(4,12)", (24, (4, 12)), 9, 16, (0, 5, 7), 200),
                      ("1024x64", (M_QUICK, 64), B_QUICK, B_QUICK,
                       tuple(range(64)), 400))


def phase_replication_kernels(dev) -> dict:
    """Phase 14c (tests/test_replication.py's post-repair rows through both
    kernels, on the card): a repair `HostReplication` on uniform
    placement observes a liveness mask with servers dead, then each
    chunk's live replica row goes to `ops.wwl_route` as a task's locals
    and, as queue lengths (each server's replica count), to
    `ops.maxweight_claim`, each call held bit for bit against its plain
    version on the group-restricted path; the racks each row spans are
    recorded.  Fatal: a row short of 3 live replicas, a mismatch, a call
    on another path."""
    from repro_torch.core import locality as loc
    from repro_torch.kernels import ops, ref
    from repro_torch.placement import make_placement
    from repro_torch.replication import make_replication

    rng = np.random.default_rng(14)
    rows, bad = {}, {"wwl_route": 0, "maxweight_claim": 0}
    for shape, (m, groups), b, chunks, dead, observes in REPL_KERNEL_SHAPES:
        topo = loc.Topology(m, groups)
        k = topo.num_tiers
        rates = PLACE_KERNEL_RATES[k]
        host = make_replication("repair").build_host(
            topo, make_placement(None), chunks, 3, 0, np.asarray(rates))
        alive = np.ones(m, bool)
        alive[list(dead)] = False
        for t in range(observes):
            host.observe(float(t), alive)
        locs = [host.replicas_for(c) for c in range(b)]
        if any(len(r) != 3 or not alive[r].all() for r in locs):
            raise AssertionError(f"{shape}: rows short of 3 live replicas "
                                 f"after {observes} observes: {locs}")
        types = np.asarray(locs, np.int32)
        anc_np = np.array(topo.ancestors, np.int32)
        anc = torch.as_tensor(anc_np, device=dev)
        span = np.bincount([len(set(anc_np[0, r])) for r in types],
                           minlength=4)[1:].tolist()
        wlv = rng.uniform(0, 50, m).astype(np.float32)
        er = (np.tile(rates, (m, 1))
              * rng.uniform(0.8, 1.2, (m, k))).astype(np.float32)
        args = [torch.as_tensor(x, device=dev)
                for x in (wlv, er, anc_np, types)]
        w_bad, w_err, _ = _checked_call("wwl_route", ops.wwl_route,
                                        ref.wwl_route, args, "group")
        q = np.bincount(types.ravel(), minlength=m).astype(np.float32)
        ids = rng.choice(m, b, replace=False).astype(np.int32)
        er2 = (np.tile(rates, (b, 1))
               * rng.uniform(0.8, 1.2, (b, k))).astype(np.float32)
        ids_t = torch.as_tensor(ids, device=dev)
        args = [torch.as_tensor(q, device=dev), anc, ids_t, anc[:, ids_t],
                torch.as_tensor(er2, device=dev)]
        q_bad, q_err, _ = _checked_call("maxweight_claim",
                                        ops.maxweight_claim,
                                        ref.maxweight_claim, args, "group")
        bad["wwl_route"] += w_bad
        bad["maxweight_claim"] += q_bad
        rows[shape] = dict(m=m, batch=b, dead=len(dead), moves=host.moves,
                           racks_spanned_1_2_3=span, wwl_mismatches=w_bad,
                           wwl_max_abs_err=w_err, maxweight_mismatches=q_bad,
                           maxweight_max_abs_err=q_err)
        print(f"phase 14c, {shape}: {json.dumps(rows[shape])}", flush=True)
    if any(bad.values()):
        raise AssertionError(f"post-repair rows: kernels disagree with "
                             f"their plain versions: {bad}")
    return dict(rows=rows, mismatches=bad)


# ---------------------------------------------------------------------------
# The telemetry slice: the tail study on the dense path (phase 15a) and
# the traced engine (phase 15b, inside phase_serving)
# ---------------------------------------------------------------------------

# examples/tail_latency_study.py's study (Topology(24, 6), the TAIL_LOADS
# 0.90/0.95/0.99 of the hot-rack capacity, exact estimates, the
# TAIL_POLICIES, `TelemetryConfig()` defaults), its depth cut from
# 12000 / 3000 slots (to 1000 / 250 from 2000 / 500 to make room for
# phase 16, then to 500 / 125 for phase 18, within the time limit); the
# checks that need no long run at TAIL_CHECK_HORIZON
TAIL_HORIZON, TAIL_WARMUP = 500, 125
TAIL_CHECK_HORIZON = 100
TAIL_SEEDS = tuple(range(8))
TAIL_CLEAN = ("balanced_pandas", "jsq_maxweight")   # gated at 0.90/0.95
SLO_BREACH_TARGET = 2.0       # breached from the first slots at rho 0.99
SLO_REPORT_TARGET = 40.0      # reported beside Balanced-PANDAS at 0.99


def phase_tail(dev) -> dict:
    """Phase 15a: `tail_study` on the card, each sweep timed, launch counts
    0 before and after (the dense path runs no kernel); its table and
    cell-slots/s; FIFO's overflow share and whether `maybe_warn_overflow`
    fires; SLO-PANDAS at target 40 beside Balanced-PANDAS at rho 0.99;
    profiled windows of 8 recorder-on Balanced-PANDAS slots, 8 without
    the recorder and 8 of SLO-PANDAS with signals.  Fatal: the histogram mass plus `telemetry_unmatched`
    unequal to a cell's in-window completions; for Balanced-PANDAS and
    JSQ-MaxWeight at rho 0.90/0.95 a cell with an unmatched or dropped
    pairing or without 0 < p50 <= p95 <= p99 < inf; a metric of
    Balanced-PANDAS, JSQ-MaxWeight or FIFO that the recorder changes,
    SLO-PANDAS without telemetry unequal to Balanced-PANDAS, SLO-PANDAS
    at target 2.0 and rho 0.99 on Balanced-PANDAS's sample path, a host
    sync in 23 recorder-on slots of Balanced-PANDAS or of SLO-PANDAS
    with signals."""
    import warnings
    from repro_torch.core import locality as loc, robustness as rb
    from repro_torch.core import simulator as sim
    from repro_torch.core.policy import PolicyConfig, make_policy
    from repro_torch.core.rng import DenseDeviceSource
    from repro_torch.telemetry import TelemetryConfig, maybe_warn_overflow

    cfg = rb.StudyConfig(sim=sim.default_config(horizon=TAIL_HORIZON,
                                                warmup=TAIL_WARMUP),
                         seeds=TAIL_SEEDS)
    scfg = cfg.sim
    runs, sweep = {}, sim.sweep

    def timed_sweep(policy, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(policy, *args, **kw)
        torch.cuda.synchronize()
        runs[getattr(policy, "name", policy)] = (time.perf_counter() - t0,
                                                 out)
        return out

    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(sim, "sweep", timed_sweep):
        study = rb.tail_study(cfg, telemetry=TelemetryConfig(), device=dev)
    wall = time.perf_counter() - t0
    _check_counts("tail study", {})
    print(rb.summarize_tail(study), flush=True)
    cells = len(rb.TAIL_LOADS) * len(TAIL_SEEDS)
    rates = {pol: dict(wall_s=sec, cell_slots_per_s=cells * TAIL_HORIZON
                       / sec) for pol, (sec, _) in runs.items()}
    print(f"phase 15a, tail study sweeps: {json.dumps(rates)}; {wall:.1f} s "
          f"for {len(runs)} sweeps of {cells} cells x {TAIL_HORIZON} "
          f"slots", flush=True)

    # accounting, cell by cell: every in-window completion is binned or
    # unmatched (throughput x window slots recovers the completion count)
    window = TAIL_HORIZON - TAIL_WARMUP
    table, overflow = {}, {}
    for pol, (_, out) in runs.items():
        done = np.rint(out["throughput"].astype(np.float64) * window)
        mass = out["delay_hist"].sum(-1) + out["telemetry_unmatched"]
        if not np.array_equal(mass, done):
            raise AssertionError(f"tail {pol}: histogram mass + unmatched "
                                 f"{mass.ravel().tolist()} against the "
                                 f"completions {done.ravel().tolist()}")
        table[pol] = {k: out[k][:, 0].mean(-1).tolist() for k in (
            "mean_delay", "delay_p50", "delay_p95", "delay_p99",
            "telemetry_dropped", "telemetry_unmatched",
            "delay_overflow_frac")}
        overflow[pol] = float(out["delay_overflow_frac"].max())
    for pol in TAIL_CLEAN:
        out = runs[pol][1]
        for li in (0, 1):   # rho 0.90 and 0.95
            p = [out[k][li, 0] for k in ("delay_p50", "delay_p95",
                                         "delay_p99")]
            ok = ((out["telemetry_unmatched"][li] == 0).all()
                  and (out["telemetry_dropped"][li] == 0).all()
                  and (p[0] > 0).all() and (p[0] <= p[1]).all()
                  and (p[1] <= p[2]).all() and np.isfinite(p[2]).all())
            if not ok:
                raise AssertionError(
                    f"tail {pol} at rho {rb.TAIL_LOADS[li]}: percentiles "
                    f"{[x.tolist() for x in p]}, unmatched "
                    f"{out['telemetry_unmatched'][li].ravel().tolist()}, "
                    f"dropped {out['telemetry_dropped'][li].ravel().tolist()}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fired = maybe_warn_overflow(overflow["fifo"], TelemetryConfig())
    print(f"phase 15a, table (means over seeds, one entry a load): "
          f"{json.dumps(table)}", flush=True)
    print(f"phase 15a: accounting holds in every cell; FIFO's largest "
          f"overflow share {overflow['fifo']}, maybe_warn_overflow "
          f"{'fires' if fired else 'stays quiet'}"
          f"{': ' + str(caught[0].message) if caught else ''}", flush=True)

    # SLO-PANDAS at a target of 40 slots beside Balanced-PANDAS at 0.99
    lam = np.asarray(rb.TAIL_LOADS, np.float32) * np.float32(
        study["capacity"])
    est = sim.make_estimates(scfg, "network", 0.0, -1)[None]
    seeds = np.asarray(TAIL_SEEDS)
    t0 = time.perf_counter()
    slo40 = sweep(PolicyConfig("slo_pandas", {"slo_target":
                                              SLO_REPORT_TARGET}),
                  scfg, lam[2:], est, seeds, telemetry=TelemetryConfig(),
                  device=dev)
    slo_s = time.perf_counter() - t0
    bp99 = runs["balanced_pandas"][1]
    slo_row = {label: {k: float(np.mean(out[k][li])) for k in (
        "mean_delay", "delay_p50", "delay_p95", "delay_p99")}
        for label, out, li in (("slo_pandas@40", slo40, 0),
                               ("balanced_pandas", bp99, 2))}
    print(f"phase 15a, rho 0.99, slo_pandas (target {SLO_REPORT_TARGET}) "
          f"beside balanced_pandas: {json.dumps(slo_row)} ({slo_s:.1f} s)",
          flush=True)

    # purity: the recorder changes no metric; SLO-PANDAS without telemetry
    # is Balanced-PANDAS; with it at target 2.0 the breach moves the path
    ccfg = sim.default_config(horizon=TAIL_CHECK_HORIZON,
                              warmup=TAIL_CHECK_HORIZON // 4)
    for pol in rb.TAIL_POLICIES:
        off = sweep(pol, ccfg, lam, est, seeds, device=dev)
        on = sweep(pol, ccfg, lam, est, seeds, telemetry=True, device=dev)
        bad = [k for k in off if not np.array_equal(off[k], on[k])]
        if bad:
            raise AssertionError(f"the recorder changed {pol}'s {bad}")
        if pol == "balanced_pandas":
            bp_off, bp_on = off, on
    slo_off = sweep("slo_pandas", ccfg, lam, est, seeds, device=dev)
    if set(slo_off) != set(bp_off) or any(
            not np.array_equal(slo_off[k], bp_off[k]) for k in bp_off):
        raise AssertionError("slo_pandas without telemetry differs from "
                             "balanced_pandas")
    slo2 = sweep(PolicyConfig("slo_pandas", {"slo_target":
                                             SLO_BREACH_TARGET}),
                 ccfg, lam[2:], est, seeds, telemetry=True, device=dev)
    moved = [k for k in ("mean_n", "final_n", "delay_hist")
             if not np.array_equal(slo2[k], bp_on[k][2:])]
    if not moved:
        raise AssertionError(f"slo_pandas at target {SLO_BREACH_TARGET}, "
                             f"rho 0.99: the breach left Balanced-PANDAS's "
                             f"sample path unchanged")
    print(f"phase 15a: the recorder leaves {rb.TAIL_POLICIES} bit for bit; "
          f"slo_pandas without telemetry is balanced_pandas; at target "
          f"{SLO_BREACH_TARGET} the breach moved {moved}", flush=True)

    # no host sync in the recorder-on loop (in the window, a series row
    # written at slot 16), and a profiled window beside the slot without
    # the recorder
    m = scfg.topo.num_servers
    cap = loc.capacity_hot_rack(scfg.topo, scfg.true_rates, scfg.p_hot)
    cells_l = [(s, np.float32(rho * cap)) for rho in rb.TAIL_LOADS
               for s in TAIL_SEEDS]
    est_t = torch.as_tensor(np.repeat(est, len(cells_l), 0), device=dev)
    qcfg = sim.default_config(horizon=TAIL_CHECK_HORIZON, warmup=4)

    def build(policy, telemetry):
        _, init, step, _, _ = sim._build_dense_step(
            policy, qcfg, est_t, dev, telemetry=telemetry)
        src = DenseDeviceSource(cells_l, make_policy(policy).draw_plan(m),
                                qcfg.max_arrivals, m, dev)
        return init(), step, src

    for policy in ("balanced_pandas", PolicyConfig(
            "slo_pandas", {"slo_target": SLO_BREACH_TARGET})):
        carry, step, src = build(policy, TelemetryConfig())
        _no_sync(step, carry, src.slot, 24)
    print("phase 15a: no host sync in 23 recorder-on slots of "
          "balanced_pandas and of slo_pandas with signals", flush=True)
    windows = {}
    for label, policy, telemetry in (
            ("recorder", "balanced_pandas", TelemetryConfig()),
            ("static", "balanced_pandas", None),
            ("slo_breach", PolicyConfig("slo_pandas", {
                "slo_target": SLO_BREACH_TARGET}), TelemetryConfig())):
        carry, step, src = build(policy, telemetry)
        t = 0

        def one():
            nonlocal carry, t
            carry = step(carry, t, src.slot(t))
            t += 1

        for _ in range(8):
            one()
        windows[label] = _profile_window(dev, one, 8)
    print(f"phase 15a, profiled windows of the Balanced-PANDAS slot at "
          f"{len(cells_l)} cells, recorder on and off, and of SLO-PANDAS "
          f"with signals: {json.dumps(windows)}", flush=True)
    return dict(wall_s=wall, sweeps=rates, table=table,
                fifo_overflow=overflow["fifo"], warned=fired,
                slo_target_40=slo_row, windows=windows)


# phase 16a: the SLO-control study (examples/slo_control_study.py's grid:
# CONTROL_ARMS x CONTROL_POLICIES at CONTROL_LOADS, Topology(24, 6), exact
# estimates, telemetry on), its depth cut from 12000 / 3000 slots (to
# 600 / 150 after a first whole run took 171 s for phase 16 on a slow
# host, then to 300 / 75 for phase 18); the checks that need no long
# run at CTL_CHECK_HORIZON
CTL_HORIZON, CTL_WARMUP = 300, 75
CTL_CHECK_HORIZON = 300
CTL_SEEDS = tuple(range(8))
CTL_SLO_TARGET, CTL_ADMIT_FRAC = 40.0, 0.93
CTL_SYNC_SLOTS = 20
# what the autoscaler leaves alone when every server stays active
CTL_MASK_FREE = ("delay_p50", "delay_p95", "delay_p99", "throughput",
                 "mean_n", "final_n", "delay_hist")


# closed loop with the autoscaler: 24 users thinking 3.3 slots keep the
# count at ceil(thinking x 0.81818187) <= 20 under the 24 servers; the
# folded constant (1 / 3.3 x 1.35) x (1 / 0.5) is inexact, and the two-
# product form differs from it (tools/xla_control_fold.py)
CTL_PAIR = [{"name": "closed_loop", "options": {"users": 24,
                                                "think_time": 3.3}},
            "autoscale"]
CTL_FOLD_USERS = 4096


def _closed_loop_autoscale(dev, sweep, zcfg, lam, est, seeds) -> dict:
    """Phase 16a's closed loop with the autoscaler: one sweep on
    Balanced-PANDAS (offered = admitted, admitted - completed = final_n,
    at most `users` in the system, ``ctl_active_mean`` under M), then the
    autoscaler's count over thinking 0..`CTL_FOLD_USERS` on the card, on
    the CPU and as numpy's float32 product with the folded constant,
    bit for bit."""
    from repro_torch import control as ctl
    from repro_torch.core import simulator as sim

    users = CTL_PAIR[0]["options"]["users"]
    m = zcfg.topo.num_servers
    t0 = time.perf_counter()
    res = sweep("balanced_pandas", zcfg, lam, est, seeds, control=CTL_PAIR,
                device=dev)
    sec = time.perf_counter() - t0
    done = np.rint(res["throughput"].astype(np.float64) * zcfg.horizon)
    out = dict(wall_s=sec, active_mean=float(res["ctl_active_mean"].mean()),
               active_min=float(res["ctl_active_min"].min()),
               final_n_max=float(res["final_n"].max()),
               mean_delay=float(res["mean_delay"].mean()))
    if (res["final_n"] > users).any() or not np.array_equal(
            res["ctl_admitted"] - done, res["final_n"]) or \
            not np.array_equal(res["ctl_offered"], res["ctl_admitted"]) or \
            not (res["ctl_active_mean"] < m).all() or \
            not np.isfinite(res["mean_delay"]).all():
        raise AssertionError(f"closed loop + autoscale: {out}, admitted "
                             f"{res['ctl_admitted'].ravel()}, completed "
                             f"{done.ravel()}")
    sim_ctl = sim.build_control(CTL_PAIR, zcfg, None, dev)
    asc = sim_ctl.plane.autoscale
    lgen = ctl.make_controller(dict(CTL_PAIR[0], options=dict(
        CTL_PAIR[0]["options"], users=CTL_FOLD_USERS)))
    fold = asc.sim_scale(sim_ctl.rate0, lgen.rate_factor)

    def counts(device):
        th = torch.arange(CTL_FOLD_USERS + 1, dtype=torch.int32,
                          device=device)
        base, _ = lgen.sim_base(CTL_FOLD_USERS - th, None, None)
        return asc.sim_count(base, fold, 1 << 24).cpu().numpy()

    card, cpu = counts(dev), counts(torch.device("cpu"))
    want = np.maximum(np.ceil(np.arange(CTL_FOLD_USERS + 1,
                                        dtype=np.float32)
                              * np.float32(fold)), 1.0).astype(np.int32)
    out.update(fold=fold, counts=len(want),
               card_vs_cpu=int((card != cpu).sum()),
               card_vs_product=int((card != want).sum()))
    if out["card_vs_cpu"] or out["card_vs_product"]:
        raise AssertionError(f"closed loop + autoscale counts: {out}")
    print(f"phase 16a, closed loop + autoscale: {json.dumps(out)}",
          flush=True)
    return out


def phase_control(dev) -> dict:
    """Phase 16a: `control_study` on the card, each sweep timed, launch
    counts 0 before and after (the dense path runs no kernel); its table
    and cell-slots/s; the checks that need no long run (300 slots,
    Balanced-PANDAS); no host sync in 20 slots of each plane; profiled
    windows of 8 recorder-on Balanced-PANDAS slots under "both" and
    without control.
    Fatal: a delay not finite; offered unequal to admitted + shed in a
    cell of a controlled arm; closed loop with the autoscaler unconserved,
    over its users or keeping every server, or its count on the card off
    the CPU's or the folded constant's product (`_closed_loop_autoscale`);
    a shed rate other than NaN for the none
    arm; the admission arm shedding nothing at rho 0.99 or over 1% in a
    cell at 0.90, or its p99 at 0.99 not below the none arm's; the
    autoscale arm's ctl_active_min under 24 (1.35 x lam / 0.5 >= 24 at
    these loads), its percentiles, throughput or sample path unequal to
    the none arm's, or "both" unequal to "admission" in any metric but
    ctl_active_*; open loop off the uncontrolled run's throughput,
    final_n or percentiles; closed loop (64 users, think 8) over 64 in
    the system or unconserved; the autoscaler at 0.3 of capacity keeping
    every server or off lam by over 15%; the deferring bucket
    unconserved; a host sync."""
    from repro_torch.core import locality as loc, robustness as rb
    from repro_torch.core import simulator as sim
    from repro_torch.core.policy import PolicyConfig, make_policy
    from repro_torch.core.rng import DenseDeviceSource
    from repro_torch.telemetry import TelemetryConfig

    cfg = rb.StudyConfig(sim=sim.default_config(horizon=CTL_HORIZON,
                                                warmup=CTL_WARMUP),
                         seeds=CTL_SEEDS)
    scfg = cfg.sim
    m = scfg.topo.num_servers
    calls, sweep = [], sim.sweep

    def timed_sweep(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(*args, **kw)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out))
        return out

    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(sim, "sweep", timed_sweep):
        study = rb.control_study(cfg, admit_frac=CTL_ADMIT_FRAC,
                                 slo_target=CTL_SLO_TARGET, device=dev)
    wall = time.perf_counter() - t0
    _check_counts("control study", {})
    print(rb.summarize_control(study), flush=True)
    keys = [(p, a) for p in rb.CONTROL_POLICIES for a in rb.CONTROL_ARMS]
    runs = dict(zip(keys, calls))
    cells = len(rb.CONTROL_LOADS) * len(CTL_SEEDS)
    rates = {f"{p}/{a}": dict(wall_s=sec, cell_slots_per_s=cells
                              * CTL_HORIZON / sec)
             for (p, a), (sec, _) in runs.items()}
    print(f"phase 16a, control study sweeps: {json.dumps(rates)}; "
          f"{wall:.1f} s for {len(runs)} sweeps of {cells} cells x "
          f"{CTL_HORIZON} slots", flush=True)

    bad = []
    for (pol, arm), (_, out) in runs.items():
        for k in ("mean_delay", "delay_p50", "delay_p95", "delay_p99"):
            if not np.isfinite(out[k]).all():
                bad.append(f"{pol}/{arm}: {k} not finite")
        if arm != "none" and not np.array_equal(
                out["ctl_offered"], out["ctl_admitted"] + out["ctl_shed"]):
            bad.append(f"{pol}/{arm}: offered != admitted + shed")
        shed = study["shed_rate"][pol][arm]
        if arm == "none" and not np.isnan(shed).all():
            bad.append(f"{pol}/none: shed rate {shed.tolist()}")
    for pol in rb.CONTROL_POLICIES:
        shed = study["shed_rate"][pol]["admission"]
        if not shed[2].mean() > 0 or (shed[0] > 0.01).any():
            bad.append(f"{pol}/admission: shed {shed.mean(-1).tolist()}")
        p99 = {a: study["p99"][pol][a][2].mean() for a in ("none",
                                                          "admission")}
        if not p99["admission"] < p99["none"]:
            bad.append(f"{pol}: p99 at 0.99 {p99}")
        auto, none = runs[(pol, "autoscale")][1], runs[(pol, "none")][1]
        if (auto["ctl_active_min"] < m).any():
            bad.append(f"{pol}/autoscale: ctl_active_min "
                       f"{auto['ctl_active_min'].min()}")
        moved = [k for k in CTL_MASK_FREE
                 if not np.array_equal(auto[k], none[k])]
        both, adm = runs[(pol, "both")][1], runs[(pol, "admission")][1]
        moved += [f"both/{k}" for k in adm if not np.array_equal(
            both[k], adm[k], equal_nan=True)]
        if moved:
            bad.append(f"{pol}: an all-active autoscaler moved {moved}")
    table = {f"{p}/{a}": {k: study[k][p][a].mean(-1).tolist() for k in (
        "mean", "p50", "p95", "p99", "shed_rate", "throughput")}
        for p, a in keys}
    print(f"phase 16a, table (means over seeds, one entry a load): "
          f"{json.dumps(table)}", flush=True)
    if bad:
        raise AssertionError(f"control study: {'; '.join(bad)}")
    print("phase 16a: conservation in every cell; the all-active "
          "autoscaler leaves both policies bit for bit", flush=True)

    # the checks that need no long run
    cap = loc.capacity_hot_rack(scfg.topo, scfg.true_rates, scfg.p_hot)
    lam = np.asarray(rb.CONTROL_LOADS, np.float32) * np.float32(cap)
    est = sim.make_estimates(scfg, "network", 0.0, -1)[None]
    seeds = np.asarray(CTL_SEEDS)
    ccfg = sim.default_config(horizon=CTL_CHECK_HORIZON,
                              warmup=CTL_CHECK_HORIZON // 4)
    zcfg = sim.default_config(horizon=CTL_CHECK_HORIZON, warmup=0)
    bp = "balanced_pandas"
    checks = {}
    off = sweep(bp, ccfg, lam, est, seeds, telemetry=True, device=dev)
    lg = sweep(bp, ccfg, lam, est, seeds, telemetry=True,
               control="open_loop", device=dev)
    moved = [k for k in ("throughput", "final_n", "delay_p50", "delay_p95",
                         "delay_p99") if not np.array_equal(off[k], lg[k])]
    if moved:
        raise AssertionError(f"open_loop moved {moved}")
    users = {"name": "closed_loop", "options": {"users": 64,
                                                "think_time": 8.0}}
    cl = sweep(bp, zcfg, lam[:1], est, seeds, control=users, device=dev)
    done = np.rint(cl["throughput"].astype(np.float64) * CTL_CHECK_HORIZON)
    checks["closed_loop"] = dict(final_n_max=float(cl["final_n"].max()),
                                 admitted=float(cl["ctl_admitted"].mean()))
    if (cl["final_n"] > 64).any() or not np.array_equal(
            cl["ctl_admitted"] - done, cl["final_n"]) or not np.array_equal(
            cl["ctl_offered"], cl["ctl_admitted"]):
        raise AssertionError(f"closed loop: final_n {cl['final_n'].ravel()}"
                             f", admitted {cl['ctl_admitted'].ravel()}, "
                             f"completed {done.ravel()}")
    checks["closed_loop+autoscale"] = _closed_loop_autoscale(
        dev, sweep, zcfg, lam[:1], est, seeds)
    low = np.float32(0.3 * cap)
    au = sweep(bp, ccfg, [low], est, seeds, control="autoscale", device=dev)
    checks["autoscale_0.3"] = dict(
        active_mean=float(au["ctl_active_mean"].mean()),
        active_min=float(au["ctl_active_min"].min()),
        throughput=float(au["throughput"].mean()), lam=float(low))
    if not (au["ctl_active_mean"] < m).all() or \
            (np.abs(au["throughput"] / low - 1.0) > 0.15).any():
        raise AssertionError(f"autoscale at 0.3: {checks['autoscale_0.3']}")
    defer = {"name": "token_bucket", "options": {
        "rate": CTL_ADMIT_FRAC * cap, "burst": 8.0 * cap, "defer": True}}
    df = sweep(bp, zcfg, lam[2:] * np.float32(1.2), est, seeds,
               control=defer, device=dev)
    checks["defer"] = dict(backlog=float(df["ctl_backlog"].mean()),
                           shed=float(df["ctl_shed"].mean()))
    if not np.array_equal(df["ctl_offered"], df["ctl_admitted"]
                          + df["ctl_shed"] + df["ctl_backlog"]):
        raise AssertionError(f"deferring bucket unconserved: {checks}")
    print(f"phase 16a, checks at {CTL_CHECK_HORIZON} slots: open_loop is "
          f"the uncontrolled run; {json.dumps(checks)}", flush=True)

    # no host sync in the controlled loops, and profiled windows
    cells_l = [(s, np.float32(rho * cap)) for rho in rb.CONTROL_LOADS
               for s in CTL_SEEDS]
    est_t = torch.as_tensor(np.repeat(est, len(cells_l), 0), device=dev)
    lam_t = torch.tensor([x for _, x in cells_l], device=dev)
    qcfg = sim.default_config(horizon=CTL_CHECK_HORIZON, warmup=4)
    both = rb.control_arm_spec("both", cap, CTL_ADMIT_FRAC)
    slo = PolicyConfig("slo_pandas", {"slo_target": CTL_SLO_TARGET})

    def build(policy, control, telemetry=None):
        ctl = sim.build_control(control, qcfg, None, dev)
        _, init, step, _, _ = sim._build_dense_step(
            policy, qcfg, est_t, dev, telemetry=telemetry, ctl=ctl,
            lam=lam_t)
        src = DenseDeviceSource(cells_l, make_policy(policy).draw_plan(m),
                                qcfg.max_arrivals, m, dev,
                                **({} if ctl is None else ctl.count_law()))
        return init(), step, src

    planes = (("admission", bp, rb.control_arm_spec("admission", cap,
                                                     CTL_ADMIT_FRAC), None),
              ("autoscale", bp, "autoscale", None), ("both", bp, both, None),
              ("closed_loop", bp, users, None),
              ("slo_pandas+both", slo, both, True))
    for label, policy, control, telemetry in planes:
        carry, step, src = build(policy, control, telemetry)
        _no_sync(step, carry, src.slot, CTL_SYNC_SLOTS)
    print(f"phase 16a: no host sync in {CTL_SYNC_SLOTS - 1} slots of "
          f"{[p[0] for p in planes]}", flush=True)
    windows = {}
    for label, control in (("both", both), ("none", None)):
        carry, step, src = build(bp, control, TelemetryConfig())
        t = 0

        def one():
            nonlocal carry, t
            carry = step(carry, t, src.slot(t))
            t += 1

        for _ in range(8):
            one()
        windows[label] = _profile_window(dev, one, 8)
    print(f"phase 16a, profiled windows of the recorder-on "
          f"Balanced-PANDAS slot at {len(cells_l)} cells under \"both\" "
          f"and without control: "
          f"{json.dumps(windows)}", flush=True)
    return dict(wall_s=wall, sweeps=rates, table=table, checks=checks,
                windows=windows)


# ---------------------------------------------------------------------------
# flash_attention and the serving slice (chatglm3-6b at full width)
# ---------------------------------------------------------------------------

# tests/test_kernels_attention.py::CASES:
# b, hq, hkv, tq, tk, d, causal, window, softcap
ATTN_CASES = (
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 1, 200, 200, 64, True, 0, 0.0),
    (1, 4, 4, 64, 192, 64, True, 0, 0.0),
    (1, 4, 2, 1, 256, 64, True, 0, 0.0),
    (2, 4, 2, 256, 256, 64, True, 128, 0.0),
    (1, 2, 2, 128, 128, 64, True, 0, 50.0),
    (1, 2, 2, 96, 96, 32, False, 0, 0.0),
    (1, 2, 1, 256, 256, 128, True, 64, 30.0),
)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 is also held row by row: max |kernel - plain| over the row's max
# |plain|.  Both compute in float32 from the same bf16 inputs and round
# once to bf16, so a sound kernel is off by one bf16 ulp at most (2^-7 of
# the value, 0.0078) plus float32 summation order.  An absolute 2e-2
# alone is as large as a late row's output at T = 8192 (about
# sqrt(e / T)), so it could not see a fault there.
BF16_ROW_REL = 1e-2
SERVE_ARCH, SERVE_REQUESTS, SERVE_NEW = "chatglm3_6b", 16, 16
LONG_T = 8192     # a long prefill, timed beside the serving buckets
# kernel route vs plain route prefill: max |logit difference| over the
# last real row, against this share of the row's max |logit|.  Sound
# runs read 0.017 (0.086 of 5.06); the limit is about twice that.  A
# kernel that lets each row see one key past the causal edge reads 0.57.
SERVE_LOGIT_TOL = 0.035
# the same for chatglm3-6b in float32 (the split-TF32 kernel on the
# tensor cores against the plain route): a sound run reads 2.3e-6 (1.17e-5
# of 5.05) and the limit is about 8x that; the kernel that lets each row
# see one key past the causal edge (`attention_fault_reading`) reads 0.57
SERVE_F32_LOGIT_TOL = 2e-5


def _attn_check(name, out, plain, dtype, kernel="flash_attention",
                tols=ATTN_TOL):
    """(max |kernel - plain|, the worst row's share of its max |plain|);
    raises beyond the dtype's tolerance in `tols`, and for bf16 beyond
    `BF16_ROW_REL` in any row (a row: the last axis)."""
    torch.cuda.synchronize()
    diff = (out.float() - plain.float()).abs()
    err = float(diff.max())
    row_rel = float((diff.amax(-1) / plain.float().abs().amax(-1)
                     .clamp_min(1e-30)).max())
    tol = tols[dtype]
    try:
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
    except AssertionError as exc:
        raise AssertionError(f"{kernel} disagrees with its plain "
                             f"version at {name}: {exc}") from None
    if dtype == torch.bfloat16 and not row_rel <= BF16_ROW_REL:
        raise AssertionError(f"{kernel} disagrees with its plain "
                             f"version at {name}: a row is off by {row_rel}"
                             f" of its largest value, beyond {BF16_ROW_REL}")
    return err, row_rel


def _device_times(fn, frag: str, reps: int) -> dict:
    """{kernel: mean device ms of one launch} of the kernels whose names
    hold `frag`, over `reps` calls of `fn` under `torch.profiler` (CUDA
    events time the host's enqueue where that is the slower); {} if the
    profiler records no device time for them in three tries (it
    sometimes records no kernel of a window at all)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.key_averages():
            if frag in e.key and e.count and e.device_time_total:
                name = re.search(r"\w*" + re.escape(frag) + r"\w*",
                                 e.key).group(0)
                times[name] = (times.get(name, 0.0)
                               + e.device_time_total / e.count / 1e3)
        if times:
            return times
        top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
        print(f"profiler: no device time for {frag}; top events "
              f"{[(e.key[:60], e.count, e.device_time_total) for e in top[:4]]}",
              flush=True)
    return {}


def _device_ms(fn, frag: str, reps: int):
    """Device ms of one call of `fn`: the sum, over the kernels whose
    names hold `frag` (each launched once a call, in stream order), of
    each one's mean launch (`_device_times`); None if the profiler
    recorded none."""
    times = _device_times(fn, frag, reps)
    return sum(times.values()) if times else None


def _sdpa_fn(q, k, v, scale):
    """A call of one PyTorch function computing the same (Tq = Tk,
    causal, no window or softcap): the library yardstick, used nowhere
    in the port."""
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True, scale=scale)


def attn_shapes():
    """(name, (B, Hq, Hkv, Tq, Tk, D), reps, plain reps) of the timed
    bf16 causal shapes: chatglm3-6b's prefill at every bucket of
    `EngineConfig()` (the shapes the serving path gives the kernel; the
    largest is the kernels line's row), a long prefill, then
    granite-moe-1b's prefill at every bucket (B 1, Hq 16, Hkv 8, D 64:
    phase 18a's shapes), then the prefill steps of phase 19a (whisper-
    medium: B 4, 16/16, T 64, D 64) and 19b (internvl2-2b: B 4, 16/8,
    T 256 + 64, D 128)."""
    from repro_torch.configs import registry
    from repro_torch.serve.engine import EngineConfig

    cfg = registry.get_config(SERVE_ARCH)
    moe = registry.get_config(MOE_ARCH)
    heads = (1, cfg.num_heads, cfg.num_kv_heads)
    buckets = EngineConfig().prefill_buckets
    return ([(f"prefill_{t}", heads + (t, t, cfg.head_dim), 50, 20)
             for t in buckets]
            + [("long", heads + (LONG_T, LONG_T, cfg.head_dim), 3, 1)]
            + [(f"moe_prefill_{t}", (1, moe.num_heads, moe.num_kv_heads, t,
                                     t, moe.head_dim), 50, 20)
               for t in buckets]
            + [(f"stack_prefill_{a}", (STACK_BATCH, c.num_heads,
                                       c.num_kv_heads,
                                       c.num_frontend_tokens + STACK_PROMPT,
                                       c.num_frontend_tokens + STACK_PROMPT,
                                       c.head_dim), 50, 5)
               for a, c in ((ENCDEC_ARCH, registry.get_config(ENCDEC_ARCH)),
                            (VLM_ARCH, registry.get_config(VLM_ARCH)))])


TC_KERNEL = "attention_tc_kernel"   # the bf16 tensor-core kernel's name


def _build_report(source, kernel, tag_re, tag_fmt, names) -> dict:
    """Per instantiation of `kernel` in csrc/`source`.cu (named by
    `tag_fmt` of the `tag_re` match on its mangled name): its ptxas
    summary (registers, spill bytes, from `_build.BUILD_LOGS` when this
    run built it) and the `HGMMA` instructions in the built library's
    SASS.  Raises if one of `names` has no `HGMMA` (off the tensor
    cores)."""
    import re

    from repro_torch.kernels import _build

    def tag(fn):
        got = re.search(tag_re, fn or "")
        if fn is None or kernel not in fn or got is None:
            return None
        return tag_fmt(got)

    report, fn = {}, None
    for line in _build.BUILD_LOGS.get(source, "").splitlines():
        got = re.search(r"(?:Compiling entry function|Function properties "
                        r"for) '?(\S+?)'?(?: for |$)", line)
        if got:
            fn = got.group(1)
            continue
        if tag(fn) is None:
            continue
        row = report.setdefault(tag(fn), {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            row["spill_stores"], row["spill_loads"] = map(int, spill.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            row["registers"] = int(regs.group(1))
            row["ptxas"] = line.split(":", 1)[-1].strip()
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build.library_path(source))],
        check=True, capture_output=True, text=True, timeout=300).stdout
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = tag(line.split("Function :")[-1].strip())
            if fn is not None:
                report.setdefault(fn, {})["hgmma"] = 0
        elif fn is not None and "HGMMA" in line:
            report[fn]["hgmma"] += 1
    for name in names:
        row = report.setdefault(name, {})
        print(f"{source} {kernel} {name}: {json.dumps(row)}", flush=True)
        if not row.get("hgmma"):
            raise AssertionError(f"{source}: {kernel} at {name} has no "
                                 f"HGMMA instruction in its SASS")
    return report


def attn_build_report() -> dict:
    """Per instantiation of the bf16 kernel ("D=128" or "D=128 softcap"):
    `_build_report` of `attention_tc_kernel`."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    return _build_report(
        "flash_attention", TC_KERNEL, r"ILi(\d+)ELb([01])E",
        lambda g: f"D={g.group(1)}" + (" softcap" if g.group(2) == "1"
                                       else ""),
        [f"D={d}{cap}" for d in HEAD_DIMS for cap in ("", " softcap")])


TF32_KERNEL = "attention_tf32_kernel"   # float32, split TF32 (wgmma)
F32_CORE_KERNEL = "attention_f32_kernel"   # float32, the CUDA cores


def attn_tf32_build_report() -> dict:
    """`_build_report` of the float32 tensor-core kernel, per head dim it
    takes and softcap ("D=128", "D=128 softcap"): fatal where one has no
    `HGMMA` (off the tensor cores)."""
    from repro_torch.kernels.flash_attention import TF32_HEAD_DIMS

    return _build_report(
        "flash_attention", TF32_KERNEL, r"ILi(\d+)ELb([01])E",
        lambda g: f"D={g.group(1)}" + (" softcap" if g.group(2) == "1"
                                       else ""),
        [f"D={d}{cap}" for d in TF32_HEAD_DIMS for cap in ("", " softcap")])


# the probe's rows (row i of a, times b's row 0 = e_0): a raw float32
# above half a TF32 ulp, at a tie with an even and an odd last kept bit,
# negative, below half an ulp, and an exact TF32 value
TF32_PROBE_VALUES = (1 + 2 ** -11 + 2 ** -12, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                     -(1 + 2 ** -11 + 2 ** -12), 1 + 2 ** -12, 1 + 2 ** -10)
TF32_PROBE_MODES = {   # what each conversion reads for the values above
    "truncate": (1.0, 1.0, 1 + 2 ** -10, -1.0, 1.0, 1 + 2 ** -10),
    "nearest-even": (1 + 2 ** -10, 1.0, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                     1 + 2 ** -10),
    "nearest-away": (1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9,
                     -(1 + 2 ** -10), 1.0, 1 + 2 ** -10)}


def tf32_probe_report(dev) -> dict:
    """The TF32 probe (`flash_attention.tf32_probe`, one `wgmma` .tf32
    product of raw float32 operands): which conversion the tensor cores
    apply to a float32 that is not a TF32 value, and the error of a
    product of random operands split as the float32 kernels split them
    (`split_tf32.cuh`: three products) against float64.  Fatal unless
    the readings are one of `TF32_PROBE_MODES` and the split product is
    within 2^-20 of the largest |product| (a single product: about
    2^-10)."""
    from repro_torch.kernels import flash_attention as fa

    a = torch.zeros((64, 8))
    b = torch.zeros((32, 8))
    b[0, 0] = 1.0
    for i, x in enumerate(TF32_PROBE_VALUES):
        a[i, 0] = x
    got = fa.tf32_probe(a.to(dev), b.to(dev))[:len(TF32_PROBE_VALUES), 0]
    read = tuple(float(x) for x in got.cpu())
    mode = next((m for m, want in TF32_PROBE_MODES.items() if read == want),
                None)
    gen = torch.Generator().manual_seed(0)
    ra, rb = torch.randn((64, 8), generator=gen), torch.randn((32, 8),
                                                              generator=gen)

    def rna(x):  # cvt.rna.tf32.f32
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    (ah, al), (bh, bl) = ((rna(x), rna(x - rna(x))) for x in (ra, rb))
    split = sum(fa.tf32_probe(u.to(dev), w.to(dev)).cpu().double()
                for u, w in ((al, bh), (ah, bl), (ah, bh)))
    one = fa.tf32_probe(ra.to(dev), rb.to(dev)).cpu().double()
    exact = ra.double() @ rb.double().T
    scale = float(exact.abs().max())
    report = dict(readings=read, raw_float32=mode,
                  split_rel_err=float((split - exact).abs().max()) / scale,
                  one_product_rel_err=float((one - exact).abs().max())
                  / scale)
    print(f"tf32 probe: {json.dumps(report)}", flush=True)
    if mode is None or not report["split_rel_err"] <= 2 ** -20:
        raise AssertionError(f"tf32 probe: unexpected readings {report}")
    return report


def attn_f32_shapes():
    """(name, (B, Hq, Hkv, Tq, Tk, D), causal, window, softcap, reps,
    plain reps) of the timed float32 shapes: the launcher's (the smoke
    config's heads at T = 16), chatglm3-6b's full-width prefill at the
    largest bucket, the same at T = 8192, jamba-1.5-large's smoke
    forward of phase 19d (B 2, 1/1, T 32, D 8), then the test cases."""
    from repro_torch.configs import registry
    from repro_torch.serve.engine import EngineConfig

    smoke = registry.get_smoke_config(SERVE_ARCH)
    hyb = registry.get_smoke_config(HYBRID_ARCH)
    cfg = registry.get_config(SERVE_ARCH)
    heads = (1, cfg.num_heads, cfg.num_kv_heads)
    t = max(EngineConfig().prefill_buckets)
    return ([("launcher", (1, smoke.num_heads, smoke.num_kv_heads, 16, 16,
                           smoke.head_dim), True, 0, 0.0, 50, 5),
             (f"prefill_{t}", heads + (t, t, cfg.head_dim), True, 0, 0.0,
              50, 5),
             ("long", heads + (LONG_T, LONG_T, cfg.head_dim), True, 0, 0.0,
              3, 1),
             ("hybrid", (HYBRID_B, hyb.num_heads, hyb.num_kv_heads, HYBRID_T,
                         HYBRID_T, hyb.head_dim), True, 0, 0.0, 50, 5)]
            + [(f"case{i}", c[:6], *c[6:], 10, 2)
               for i, c in enumerate(ATTN_CASES)])


def attn_f32_rows(dev, prev_fn=None) -> dict:
    """float32 `flash_attention` at `attn_f32_shapes`, its inputs in the
    attention layer's layout ((B, H, T, D) views of (B, T, H, D)
    storage), against its plain version (2e-5, fatal): times by events
    and on the device, the plain version's and, causal without window or
    softcap, one SDPA call's, with the bound; with `prev_fn` (the
    parent's CUDA-core kernel, `_prev_attention`) the same times of that
    kernel on contiguous copies of the inputs and its error (recorded,
    not fatal)."""
    from repro_torch.kernels import flash_attention as fa, ops, ref

    gen = torch.Generator(dev).manual_seed(1)
    rows = {}
    for name, shape, causal, window, cap, reps, plain_reps in \
            attn_f32_shapes():
        b, hq, hkv, tq, tk, d = shape
        q = torch.randn((b, tq, hq, d), generator=gen,
                        device=dev).transpose(1, 2)
        k, v = (torch.randn((b, tk, hkv, d), generator=gen,
                            device=dev).transpose(1, 2) for _ in range(2))
        opts = dict(causal=causal, window=window, softcap=cap,
                    scale=d ** -0.5)
        fn = lambda: ops.flash_attention(q, k, v, **opts)  # noqa: E731
        plain = ref.mha(q, k, v, **opts)
        err, _ = _attn_check(f"float32 {name}", fn(), plain, torch.float32)
        tc = fa.route(torch.float32, d) == fa.F32_TENSOR_CORES
        bound = attention_cost(shape, causal, window, torch.float32)
        sdpa = causal and not window and not cap and tq == tk
        row = dict(shape=list(shape), dtype="f32",
                   route="tensor cores" if tc else "CUDA cores",
                   max_abs_err=err, ms=_time_ms(fn, reps),
                   device_ms=_device_ms(fn, TF32_KERNEL if tc
                                        else F32_CORE_KERNEL, reps),
                   plain_ms=_time_ms(lambda: ref.mha(q, k, v, **opts),
                                     plain_reps),
                   library_ms=(_time_ms(_sdpa_fn(q, k, v, d ** -0.5), reps)
                               if sdpa else None),
                   bound_ms=bound[0], bound_by=bound[1], bytes=bound[2],
                   flops=bound[3])
        if prev_fn is not None:
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            pfn = lambda: prev_fn(qc, kc, vc, **opts)  # noqa: E731
            perr = float((pfn() - plain).abs().max())
            row.update(prev_max_abs_err=perr,
                       prev_within_limit=bool(torch.allclose(
                           pfn(), plain, atol=ATTN_TOL[torch.float32],
                           rtol=ATTN_TOL[torch.float32])),
                       prev_ms=_time_ms(pfn, reps),
                       prev_device_ms=_device_ms(pfn, F32_CORE_KERNEL, reps))
            del qc, kc, vc, pfn
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        timed = row["device_ms"] or row["ms"]
        row["bound_share"] = row["bound_ms"] / timed
        rows[name] = row
        print(f"flash_attention f32 {name}: {json.dumps(row)}", flush=True)
        del q, k, v, fn, plain
        torch.cuda.empty_cache()
    return rows


# the 8 cases at head dim 16 (granite-moe-1b's smoke config), on every
# kernel that takes it: (label, dtype, route code, kernel name fragment)
D16_CASES = tuple(c[:5] + (16,) + c[6:] for c in ATTN_CASES)
D16_ROUTES = (("bf16 tensor cores", torch.bfloat16, 1, "attention_tc_kernel"),
              ("f32 tensor cores", torch.float32, 2, "attention_tf32_kernel"),
              ("f32 CUDA cores", torch.float32, 0, "attention_f32_kernel"))
# timed: granite-moe-1b's smoke heads (4 on 4, D 16) at T = 128
D16_TIMED = (1, 4, 4, 128, 128, 16)


def attn_d16_rows(dev) -> dict:
    """Each kernel at D = 16 through the wrapper's `_launch(code)`:
    the 8 cases against `ref.mha` (float32 2e-5; bf16 2e-2 and every row
    within 1%, fatal), then `D16_TIMED` (causal) by events and on the
    device beside the plain version, one SDPA call and the bound."""
    from repro_torch.kernels import flash_attention as fa, ref

    rng = np.random.default_rng(16)
    rows = {}
    for label, dtype, code, frag in D16_ROUTES:
        err = worst = 0.0
        for case in D16_CASES:
            b, hq, hkv, tq, tk, d, causal, window, cap = case
            q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                       device=dev).to(dtype)
                       for s in ((b, hq, tq, d), (b, hkv, tk, d),
                                 (b, hkv, tk, d)))
            opts = dict(causal=causal, window=window, softcap=cap,
                        scale=d ** -0.5)
            e, r = _attn_check(f"D=16 {label} {case}",
                               fa._launch(q, k, v, code, **opts),
                               ref.mha(q, k, v, **opts), dtype)
            err, worst = max(err, e), max(worst, r)
        b, hq, hkv, tq, tk, d = D16_TIMED
        gen = torch.Generator(dev).manual_seed(16)
        q = torch.randn((b, hq, tq, d), generator=gen, device=dev,
                        dtype=dtype)
        k, v = (torch.randn((b, hkv, tk, d), generator=gen, device=dev,
                            dtype=dtype) for _ in range(2))
        opts = dict(causal=True, window=0, softcap=0.0, scale=d ** -0.5)
        fn = lambda: fa._launch(q, k, v, code, **opts)  # noqa
        e, _ = _attn_check(f"D=16 {label} {D16_TIMED}", fn(),
                           ref.mha(q, k, v, **opts), dtype)
        bound = attention_cost(D16_TIMED, True, 0, dtype)
        rows[label] = row = dict(
            cases=len(D16_CASES), max_abs_err=max(err, e),
            bf16_worst_row=worst if dtype == torch.bfloat16 else None,
            shape=list(D16_TIMED), ms=_time_ms(fn, KERNEL_REPS),
            device_ms=_device_ms(fn, frag, KERNEL_REPS),
            plain_ms=_time_ms(lambda: ref.mha(q, k, v, **opts), PLAIN_REPS),
            library_ms=_time_ms(_sdpa_fn(q, k, v, d ** -0.5), KERNEL_REPS),
            bound_ms=bound[0], bound_by=bound[1])
        print(f"flash_attention D=16 {label}: {json.dumps(row)}", flush=True)
    return rows


def phase_attention(dev, prev_fn=None):
    """flash_attention's build reports (`attn_build_report`,
    `attn_tf32_build_report`) and the TF32 probe, then the kernels
    against their plain version at the attention test cases (float32 and
    bf16), then in bf16 at the slice's prefill shape of every bucket and
    at T = 8192, timed beside the plain version and SDPA, then float32 at
    `attn_f32_shapes` (`attn_f32_rows`, with the parent's kernel beside
    it given `prev_fn`), then every kernel at D = 16 (`attn_d16_rows`).
    Returns (timed rows, max |error|, the build reports, the float32
    rows, the probe's report, the D = 16 rows)."""
    from repro_torch.kernels import flash_attention as fa, ops, ref

    build = attn_build_report()
    build.update({f"f32 {n}": r for n, r in attn_tf32_build_report().items()})
    probe = tf32_probe_report(dev)
    rng = np.random.default_rng(0)
    max_err = max_rel = 0.0
    for case in ATTN_CASES:
        b, hq, hkv, tq, tk, d, causal, window, cap = case
        host = [rng.normal(size=s).astype(np.float32)
                for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]
        for dtype in ATTN_TOL:
            q, k, v = (torch.as_tensor(x, device=dev).to(dtype) for x in host)
            opts = dict(causal=causal, window=window, softcap=cap)
            err, rel = _attn_check(
                f"{case} {dtype}", ops.flash_attention(q, k, v, **opts),
                ref.mha(q, k, v, **opts), dtype)
            max_err = max(max_err, err)
            if dtype == torch.bfloat16:
                max_rel = max(max_rel, rel)
    print(f"flash_attention: {len(ATTN_CASES)} test cases x (float32, bf16) "
          f"within tolerance, max_abs_err {max_err:.3g}, bf16 worst row "
          f"{max_rel:.3g} of its max (limit {BF16_ROW_REL})", flush=True)
    rows = {}
    gen = torch.Generator(dev).manual_seed(0)
    for name, shape, reps, plain_reps in attn_shapes():
        b, hq, hkv, tq, tk, d = shape
        q = torch.randn((b, hq, tq, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, hkv, tk, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        scale = d ** -0.5
        err, rel = _attn_check(name, ops.flash_attention(q, k, v,
                                                         scale=scale),
                               ref.mha(q, k, v, scale=scale), torch.bfloat16)
        lib_fn = _sdpa_fn(q, k, v, scale)
        bound = attention_cost(shape, True, 0, torch.bfloat16)
        row = dict(shape=list(shape), dtype="bf16", max_abs_err=err,
                   row_rel_err=rel,
                   ms=_time_ms(lambda: ops.flash_attention(q, k, v,
                                                           scale=scale),
                               reps),
                   plain_ms=_time_ms(lambda: ref.mha(q, k, v, scale=scale),
                                     plain_reps),
                   library_ms=_time_ms(lib_fn, reps),
                   bound_ms=bound[0], bound_by=bound[1], bytes=bound[2],
                   flops=bound[3], encode_us=fa.tensor_map_encode_us(q, k, v))
        if "prefill_" in name:  # CUDA events time the host here
            row["device_ms"] = _device_ms(
                lambda: ops.flash_attention(q, k, v, scale=scale), TC_KERNEL,
                reps)
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        print(f"flash_attention {name}: {json.dumps(row)}", flush=True)
        del q, k, v, lib_fn
        torch.cuda.empty_cache()
    f32_rows = attn_f32_rows(dev, prev_fn)
    d16_rows = attn_d16_rows(dev)
    return (rows, max([max_err] + [r["max_abs_err"] for r in rows.values()]
                      + [r["max_abs_err"] for r in f32_rows.values()]
                      + [r["max_abs_err"] for r in d16_rows.values()]),
            build, f32_rows, probe, d16_rows)


# ---------------------------------------------------------------------------
# ssd and the Mamba serving slice (mamba2-1.3b at full width)
# ---------------------------------------------------------------------------

# tests/test_kernels_ssd.py::CASES: b, t, h, p, n
SSD_CASES = ((1, 128, 2, 32, 16), (2, 200, 3, 16, 32), (1, 64, 1, 8, 8),
             (1, 512, 4, 64, 64))
SSD_TOL = {torch.float32: 3e-4, torch.bfloat16: 3e-2}
MAMBA_ARCH = "mamba2_13b"
# kernel route vs plain route prefill of mamba2-1.3b, as SERVE_LOGIT_TOL
# for chatglm3-6b.  In bf16 (the served model) sound runs read 0.050-
# 0.064 of the largest logit, and so does the kernel's own plain version
# against the plain route: 48 layers of bf16 rounding, beside which a
# small kernel fault does not show; the limit is about twice that.  The
# same weights in float32 read 6e-6 to 1.3e-5, and there a decay off by
# 0.1% reads 0.0038: that limit is about 8x the sound readings
# (PERF.md, PR 14).
MAMBA_LOGIT_TOL = 0.12
MAMBA_F32_LOGIT_TOL = 1e-4
# the MoE slice: granite-moe-1b served and trained at full width (phase
# 18), mixtral-8x22b at its smoke config through the launcher (phase 10)
MOE_ARCH, MOE_SMOKE_ARCH = "granite_moe_1b", "mixtral_8x22b"
# kernel route vs plain route prefill of granite-moe-1b in bf16, as
# SERVE_LOGIT_TOL for chatglm3-6b.  In float32 the two routes read 1.1e-6
# of the largest logit (within SERVE_F32_LOGIT_TOL) with no token's
# expert set flipped in any of the 24 layers; in bf16 they read 0.0225,
# with 0-25 of 106 tokens a layer routed to another expert set (the two
# attention routes round differently and a router near-tie follows
# either way), so a bf16 gap is flips more than kernel error.  The limit
# is about twice that reading; a kernel that lets each row see one key
# past the causal edge reads 0.46 (float32; PERF.md §6, the MoE slice).
MOE_LOGIT_TOL = 0.05


def _ssd_inputs(gen, shape, dtype, dev):
    """x, a, b, c on the card: x ~ N(0, 1), a ~ -U[0.01, 0.2), b and c ~
    0.3 N(0, 1) (tests/test_kernels_ssd.py's law), x, b, c in `dtype`."""
    bsz, t, h, p, n = shape
    x = torch.randn((bsz, t, h, p), generator=gen, device=dev).to(dtype)
    a = -(torch.rand((bsz, t, h), generator=gen, device=dev) * 0.19 + 0.01)
    b, c = ((torch.randn((bsz, t, n), generator=gen, device=dev) * 0.3)
            .to(dtype) for _ in range(2))
    return x, a, b, c


def _ssd_check(name, got, want, dtype):
    """`_attn_check` on y (rows: P) and on the final state (float32)."""
    err, rel = _attn_check(name, got[0], want[0], dtype, "ssd", SSD_TOL)
    h_err, _ = _attn_check(name + " final state", got[1], want[1],
                           torch.float32, "ssd", SSD_TOL)
    return max(err, h_err), rel


def ssd_shapes():
    """(name, (B, T, H, P, N), reps, plain reps) of the timed bf16
    shapes: mamba2-1.3b's prefill at every bucket of `EngineConfig()`
    (the shapes the serving path gives the kernel; the largest is the
    kernels line's row), then a long prefill of 64 chunks."""
    from repro_torch.configs import registry
    from repro_torch.serve.engine import EngineConfig

    cfg = registry.get_config(MAMBA_ARCH)
    ssm = cfg.ssm
    heads = (ssm.num_heads(cfg.d_model), ssm.head_dim, ssm.d_state)
    return ([(f"prefill_{t}", (1, t) + heads, 50, 3)
             for t in EngineConfig().prefill_buckets]
            + [("long", (1, LONG_T) + heads, 5, 1)])


SSD_TC_KERNEL = "ssd_tc_kernel"     # bf16, the tensor cores
SSD_REC_KERNEL = "ssd_scan_kernel"  # the recurrent kernel (CUDA cores)
SSD_EDGES = (1, 17, 129)            # bf16 lengths around a chunk of 64


def _ssd_recurrent():
    """Within the block, calls take the recurrent kernel of their dtype
    (the one every call took before the tensor-core kernels), for timing
    beside the tensor-core kernels."""
    from repro_torch.kernels import ssd_scan

    route = ssd_scan.route

    def recurrent(dtype, p, n):
        return {ssd_scan.TENSOR_CORES: ssd_scan.RECURRENT_BF16,
                ssd_scan.TENSOR_CORES_F32: ssd_scan.RECURRENT_F32}.get(
                    route(dtype, p, n), route(dtype, p, n))

    return mock.patch.object(ssd_scan, "route", recurrent)


def ssd_build_report() -> dict:
    """Per instantiation of the tensor-core kernel ("N=128"): its ptxas
    summary (registers, spill bytes, from `_build.BUILD_LOGS` when this
    run built it) and the `HGMMA` instructions in the built library's
    SASS.  Raises if an instantiation has none (bf16 off the tensor
    cores)."""
    return _build_report("ssd_scan", SSD_TC_KERNEL, r"ILi(\d+)E",
                         lambda g: f"N={g.group(1)}",
                         [f"N={n}" for n in (8, 16, 32, 64, 128)])


SSD_TF32_KERNEL = "ssd_tf32_kernel"  # float32, split TF32 (wgmma)


def ssd_tf32_build_report() -> dict:
    """`_build_report` of the float32 tensor-core kernel per N: fatal
    where one has no `HGMMA`."""
    return _build_report("ssd_scan", SSD_TF32_KERNEL, r"ILi(\d+)E",
                         lambda g: f"N={g.group(1)}",
                         [f"N={n}" for n in (8, 16, 32, 64, 128)])


def ssd_f32_shapes():
    """(name, (B, T, H, P, N), reps, plain reps) of the timed float32
    shapes: the launcher's (the smoke config's heads at T = 16),
    mamba2-1.3b's full-width prefill at the largest bucket, the same at
    T = 8192, jamba-1.5-large's smoke forward of phase 19d (B 2, T 32,
    H 32, P 8, N 8), then the test cases."""
    from repro_torch.configs import registry
    from repro_torch.serve.engine import EngineConfig

    def heads(cfg):
        ssm = cfg.ssm
        return (ssm.num_heads(cfg.d_model), ssm.head_dim, ssm.d_state)

    full = heads(registry.get_config(MAMBA_ARCH))
    t = max(EngineConfig().prefill_buckets)
    return ([("launcher", (1, 16) + heads(registry.get_smoke_config(
                MAMBA_ARCH)), 50, 3),
             (f"prefill_{t}", (1, t) + full, 50, 3),
             ("long", (1, LONG_T) + full, 5, 1),
             ("hybrid", (HYBRID_B, HYBRID_T) + heads(
                 registry.get_smoke_config(HYBRID_ARCH)), 50, 3)]
            + [(f"case{i}", c, 10, 2) for i, c in enumerate(SSD_CASES)])


def ssd_f32_rows(dev, prev_fn=None) -> dict:
    """float32 `ssd` at `ssd_f32_shapes`, b and c as views into one
    buffer (as `mamba_block` passes them) and the initial state as the
    served prefill passes it (zeros; the test cases a random one),
    against its plain version (3e-4 on y and the final state, fatal):
    times by events and on the device, this tree's recurrent kernel on
    the same inputs, the plain version's, the bound; with `prev_fn` (the
    parent's recurrent kernel, `_prev_ssd`) its times on contiguous
    copies and its error (recorded, not fatal)."""
    from repro_torch.kernels import ops, ref, ssd_scan

    gen = torch.Generator(dev).manual_seed(2)
    rows = {}
    for name, shape, reps, plain_reps in ssd_f32_shapes():
        bsz, t, h, p, n = shape
        x, a, b, c = _ssd_inputs(gen, shape, torch.float32, dev)
        conv = torch.cat([x.new_zeros((bsz, t, 8)), b, c], -1)
        b, c = conv[..., 8:8 + n], conv[..., 8 + n:]
        h0 = (torch.randn((bsz, h, p, n), generator=gen, device=dev) * 0.1
              if name.startswith("case") else
              torch.zeros((bsz, h, p, n), device=dev))
        fn = lambda: ops.ssd(x, a, b, c, init_state=h0)  # noqa: E731
        plain = ref.ssd(x, a, b, c, init_state=h0)
        err, _ = _ssd_check(f"float32 {name}", fn(), plain, torch.float32)
        tc = ssd_scan.route(torch.float32, p, n) == ssd_scan.TENSOR_CORES_F32
        bound = ssd_cost(shape, torch.float32)
        row = dict(shape=list(shape), dtype="f32",
                   route="tensor cores" if tc else "recurrent",
                   max_abs_err=err, ms=_time_ms(fn, reps),
                   device_ms=_device_ms(fn, SSD_TF32_KERNEL if tc
                                        else SSD_REC_KERNEL, reps),
                   plain_ms=_time_ms(lambda: ref.ssd(x, a, b, c,
                                                     init_state=h0),
                                     plain_reps),
                   library_ms=None, bound_ms=bound[0], bound_by=bound[1],
                   bytes=bound[2], flops=bound[3])
        with _ssd_recurrent():
            rec_err, _ = _ssd_check(f"float32 {name} recurrent", fn(), plain,
                                    torch.float32)
            row.update(recurrent_max_abs_err=rec_err,
                       recurrent_ms=_time_ms(fn, reps),
                       recurrent_device_ms=_device_ms(fn, SSD_REC_KERNEL,
                                                      reps))
        if prev_fn is not None:
            xc, bc, cc = (v.contiguous() for v in (x, b, c))
            pfn = lambda: prev_fn(xc, a, bc, cc, h0)  # noqa: E731
            py, ph = pfn()
            tol = SSD_TOL[torch.float32]
            row.update(prev_max_abs_err=max(
                           float((py - plain[0]).abs().max()),
                           float((ph - plain[1]).abs().max())),
                       prev_within_limit=bool(
                           torch.allclose(py, plain[0], atol=tol, rtol=tol)
                           and torch.allclose(ph, plain[1], atol=tol,
                                              rtol=tol)),
                       prev_ms=_time_ms(pfn, reps),
                       prev_device_ms=_device_ms(pfn, SSD_REC_KERNEL, reps))
            del xc, bc, cc, pfn, py, ph
        timed = row["device_ms"] or row["ms"]
        row["bound_share"] = row["bound_ms"] / timed
        row["tflops"] = row["flops"] / timed / 1e9
        rows[name] = row
        print(f"ssd f32 {name}: {json.dumps(row)}", flush=True)
        del x, a, b, c, conv, h0, fn, plain
        torch.cuda.empty_cache()
    return rows


def phase_ssd(dev, prev_fn=None):
    """ssd's build reports (`ssd_build_report`, `ssd_tf32_build_report`),
    then the kernels against their plain version at the SSD test cases
    (float32 and bf16), the init-state split and the bf16 edges T = 1,
    17, 129 at mamba2-1.3b's widths, then in bf16 at the slice's prefill
    shape of every bucket and at T = 8192, timed beside the plain version
    and the recurrent kernel (by CUDA events and on the device), with its
    bound, then float32 at `ssd_f32_shapes` (`ssd_f32_rows`, with the
    parent's kernel beside it given `prev_fn`)."""
    from repro_torch.kernels import ops, ref, ssd_scan

    build = ssd_build_report()
    build.update({f"f32 {n}": r for n, r in ssd_tf32_build_report().items()})
    gen = torch.Generator(dev).manual_seed(0)
    max_err = max_rel = 0.0
    for case in SSD_CASES:
        for dtype in SSD_TOL:
            x, a, b, c = _ssd_inputs(gen, case, dtype, dev)
            h0 = torch.randn((case[0],) + case[2:], generator=gen,
                             device=dev) * 0.1
            err, rel = _ssd_check(f"{case} {dtype}",
                                  ops.ssd(x, a, b, c, init_state=h0),
                                  ref.ssd(x, a, b, c, init_state=h0), dtype)
            max_err = max(max_err, err)
            if dtype == torch.bfloat16:
                max_rel = max(max_rel, rel)
    # two calls threaded through init_state equal one call
    x, a, b, c = _ssd_inputs(gen, (1, 256, 2, 16, 16), torch.float32, dev)
    y_full, h_full = ops.ssd(x, a, b, c)
    y1, h1 = ops.ssd(x[:, :128], a[:, :128], b[:, :128], c[:, :128])
    y2, h2 = ops.ssd(x[:, 128:], a[:, 128:], b[:, 128:], c[:, 128:],
                     init_state=h1)
    err, _ = _ssd_check("init-state split", (torch.cat([y1, y2], 1), h2),
                        (y_full, h_full), torch.float32)
    max_err = max(max_err, err)
    shapes = ssd_shapes()
    heads = shapes[0][1][2:]
    if ssd_scan.route(torch.bfloat16, *heads[1:]) != ssd_scan.TENSOR_CORES:
        raise AssertionError(f"bf16 ssd at {heads} would not run on the "
                             f"tensor cores")
    for t in SSD_EDGES:  # below, across and past a chunk, from a state
        x, a, b, c = _ssd_inputs(gen, (1, t) + heads, torch.bfloat16, dev)
        h0 = torch.randn((1,) + heads, generator=gen, device=dev) * 0.1
        err, rel = _ssd_check(f"edge T={t}", ops.ssd(x, a, b, c,
                                                     init_state=h0),
                              ref.ssd(x, a, b, c, init_state=h0),
                              torch.bfloat16)
        max_err, max_rel = max(max_err, err), max(max_rel, rel)
    print(f"ssd: {len(SSD_CASES)} test cases x (float32, bf16), the "
          f"init-state split and the bf16 edges T = {SSD_EDGES} within "
          f"tolerance, max_abs_err {max_err:.3g}, bf16 worst row "
          f"{max_rel:.3g} of its max (limit {BF16_ROW_REL})", flush=True)
    rows = {}
    for name, shape, reps, plain_reps in shapes:
        x, a, b, c = _ssd_inputs(gen, shape, torch.bfloat16, dev)
        h0 = torch.zeros((shape[0],) + shape[2:], device=dev)
        fn = lambda: ops.ssd(x, a, b, c, init_state=h0)  # noqa: E731
        err, rel = _ssd_check(name, fn(), ref.ssd(x, a, b, c, init_state=h0),
                              torch.bfloat16)
        with _ssd_recurrent():
            rec_err, _ = _ssd_check(name + " recurrent", fn(),
                                    ref.ssd(x, a, b, c, init_state=h0),
                                    torch.bfloat16)
        bound = ssd_cost(shape, torch.bfloat16)
        row = dict(shape=list(shape), dtype="bf16", max_abs_err=err,
                   row_rel_err=rel, ms=_time_ms(fn, reps),
                   device_ms=_device_ms(fn, SSD_TC_KERNEL, reps),
                   plain_ms=_time_ms(lambda: ref.ssd(x, a, b, c,
                                                     init_state=h0),
                                     plain_reps),
                   library_ms=None,
                   bound_ms=bound[0], bound_by=bound[1], bytes=bound[2],
                   flops=bound[3], recurrent_max_abs_err=rec_err)
        with _ssd_recurrent():
            row.update(recurrent_ms=_time_ms(fn, reps),
                       recurrent_device_ms=_device_ms(fn, SSD_REC_KERNEL,
                                                      reps))
        row["gb_per_s"] = row["bytes"] / row["ms"] / 1e6
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        print(f"ssd {name}: {json.dumps(row)}", flush=True)
        del x, a, b, c, h0, fn
        torch.cuda.empty_cache()
    f32_rows = ssd_f32_rows(dev, prev_fn)
    return (rows, max([max_err] + [r["max_abs_err"] for r in rows.values()]
                      + [r["max_abs_err"] for r in f32_rows.values()]),
            build, f32_rows)


def _profile_window(dev, fn, steps: int, cpu: bool = True, top: int = 6,
                    chars: int = 60) -> dict:
    """The device's busy share over `steps` calls of `fn` under
    torch.profiler: kernel time over wall time, and the `top` kernels
    (names cut to `chars`).  ``cpu=False`` records the device alone,
    which costs far less a launch on a window of tens of thousands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kern = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kern)
    return {"window_steps": steps,
            "window_ms_per_step": window_us / steps / 1e3,
            "device_busy_share": busy_us / window_us if kern else None,
            "device_launches_per_step": sum(k[1] for k in kern) / steps,
            "top_kernels_us_per_step": [[k[2][:chars], k[0] / steps,
                                         k[1] / steps]
                                        for k in kern[:top]]}


# per served arch: the prefill's kernel route, its kernel, the limit of
# the kernel-route vs plain-route prefill logits in the served dtype and
# (None: not run) in float32
SERVE_ROUTES = {
    SERVE_ARCH: ("pallas", "flash_attention", SERVE_LOGIT_TOL,
                 SERVE_F32_LOGIT_TOL),
    MAMBA_ARCH: ("pallas_ssd", "ssd", MAMBA_LOGIT_TOL, MAMBA_F32_LOGIT_TOL),
    MOE_ARCH: ("pallas", "flash_attention", MOE_LOGIT_TOL,
               SERVE_F32_LOGIT_TOL)}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _uncounted(cfg) -> int:
    """Parameters of the model's tree that the reference's analytic
    `param_count` leaves out: each Mamba layer's conv bias, the
    embedding's vocab-padding rows (0 for chatglm3-6b), with a LayerNorm
    the final and cross-attention norms' biases, and an encoder's final
    norm and position table (whisper-medium: 1,774,592)."""
    d = cfg.d_model
    conv_b = sum(st.repeats * (cfg.ssm.d_inner(d)
                               + 2 * cfg.ssm.n_groups * cfg.ssm.d_state)
                 for st in cfg.stages for sl in st.block
                 if sl.kind == "mamba")
    pad = (cfg.padded_vocab - cfg.vocab_size) * d
    n = conv_b + pad * (1 if cfg.tie_embeddings else 2)
    if cfg.norm == "layernorm":
        n += d + d * sum(st.repeats for st in cfg.stages
                         for sl in st.block if sl.cross)
    if cfg.enc_stages:
        n += d * (2 if cfg.norm == "layernorm" else 1)
        if cfg.learned_pos:
            n += max(cfg.num_audio_frames, 1) * d
    return n


def _kernel_layers(cfg, kernel: str) -> int:
    """Launches of `kernel` a decoder prefill makes: one a causal
    attention layer (flash_attention) or one a Mamba layer (ssd)."""
    return sum(st.repeats for st in cfg.stages for sl in st.block
               if (sl.kind == "mamba") == (kernel == "ssd")
               and (kernel == "ssd" or sl.causal))


def phase_serving(dev, arch=SERVE_ARCH):
    """A model at full width through the engine's entry points: its
    prefills through its kernel route (`SERVE_ROUTES`)."""
    from repro_torch.configs import registry
    from repro_torch.models import config as mconfig
    from repro_torch.models import params as P, transformer as T
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine

    impl, kernel, logit_tol, f32_tol = SERVE_ROUTES[arch]
    cfg = registry.get_config(arch)
    t0 = time.perf_counter()
    params = P.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = P.count_params(params)
    want = mconfig.param_count(cfg) + _uncounted(cfg)
    if n_params != want or _shapes(params) != _shapes(P.model_defs(cfg)):
        raise AssertionError(f"{n_params} parameters, want {want} in the "
                             f"shapes of `params.model_defs`")
    weight_gb = n_params * params["embed"].element_size() / 1e9
    print(f"serving {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters, {weight_gb:.2f} GB "
          f"{cfg.dtype}, drawn in {init_s:.1f} s", flush=True)

    ecfg = EngineConfig()
    eng = ServingEngine(cfg, params, ecfg, device=dev)
    reqs = serve_requests(cfg)
    run = drained_run(dev, arch, cfg, eng, reqs, f"{arch} serving")
    print(f"serving run {cfg.name}: {json.dumps(run)}", flush=True)
    if arch == SERVE_ARCH:
        run["scenario"] = scenario_serving(dev, cfg, params, run)
        t0 = time.perf_counter()
        run["placement"] = placement_serving(dev, cfg, params, run)
        run["placement_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run["replication"] = replication_serving(dev, cfg, params, run)
        run["replication_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run["traced"] = traced_serving(dev, cfg, params, run["replication"])
        run["traced_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run["control"] = control_serving(dev, cfg, params, run)
        run["control_s"] = time.perf_counter() - t0
    if arch == MAMBA_ARCH:
        run["tokens_per_s_tc_vs_recurrent"] = ssd_ab(eng, reqs)

    compare = prefill_compare(dev, cfg, params, ecfg, reqs[0].prompt, impl,
                              logit_tol)
    decode = decode_window(dev, eng, ecfg, reqs)
    if f32_tol is not None:  # the same weights and prefill in float32
        del eng, params
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = P.init_params(cfg32, torch.Generator(dev).manual_seed(0),
                                 device=dev)
        compare["float32"] = prefill_compare(dev, cfg32, params32, ecfg,
                                             reqs[0].prompt, impl, f32_tol)
        if kernel == "flash_attention":
            compare["float32_fault"] = attention_fault_reading(
                dev, cfg32, params32, ecfg, reqs[0].prompt, f32_tol)
        del params32
        torch.cuda.empty_cache()
    return run["launches"], run, compare, decode


def serve_requests(cfg):
    """The serving phases' 16 seeded requests of 24-120 prompt tokens."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, int(rng.integers(24, 121))
            ).astype(np.int32), max_new_tokens=SERVE_NEW, prefix_id=i % 5)
            for i in range(SERVE_REQUESTS)]


@contextlib.contextmanager
def _prefills(dev, impl):
    """Counts `transformer.forward` calls through `impl` (the engine's
    prefills) and folds each logits tensor's finiteness into one flag on
    the card (no host read)."""
    from repro_torch.models import transformer as T
    forward = T.forward
    state = {"prefills": 0,
             "finite": torch.ones((), dtype=torch.bool, device=dev)}

    def checked(*args, **kwargs):
        state["prefills"] += kwargs.get("impl") == impl
        out = forward(*args, **kwargs)
        state["finite"].logical_and_(torch.isfinite(out[0]).all())
        return out

    T.forward = checked
    try:
        yield state
    finally:
        T.forward = forward


def drained_run(dev, arch, cfg, eng, reqs, path, submit_at=None,
                drive=None) -> dict:
    """Drives `eng` until every request of `reqs` is drained: all
    submitted at once (`run_until_drained`), request i at engine step
    ``submit_at[i]``, or by ``drive(eng)``, which submits and steps and
    returns the requests it made.  Launch counts are set to 0 before and
    must equal the kernel's layers x prefills after (`_kernel_layers`); every
    logits tensor is checked finite on the card (no host read); every
    request the control plane did not shed (``finish_time == -1.0``)
    must be prefilled once and drain with SERVE_NEW + 1 tokens."""
    impl, kernel = SERVE_ROUTES[arch][:2]
    _zero_counts()
    with _prefills(dev, impl) as seen:
        t0 = time.perf_counter()
        if drive is not None:
            out = drive(eng)
        elif submit_at is None:
            out = eng.run_until_drained(reqs)
        else:
            out, nxt = list(reqs), 0
            while any(r.finish_time == 0.0 for r in out):
                while nxt < len(out) and submit_at[nxt] <= eng.steps:
                    eng.submit(out[nxt])
                    nxt += 1
                eng.step()
                if eng.steps > 10_000:
                    raise RuntimeError("engine did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prefills = seen["prefills"]
    launches = _check_counts(path, {kernel: _kernel_layers(cfg, kernel)
                                    * prefills})
    kept = [r for r in out if r.finish_time != -1.0]
    if prefills != len(kept):
        raise AssertionError(f"{prefills} prefills for {len(kept)} "
                             f"admitted requests")
    short = [r.rid for r in kept
             if r.finish_time <= 0 or len(r.generated) != SERVE_NEW + 1]
    if short:
        raise AssertionError(f"requests {short} did not drain with "
                             f"{SERVE_NEW + 1} tokens")
    if not bool(seen["finite"]):
        raise AssertionError(f"non-finite logits in the {path} run")
    tokens = sum(len(r.generated) for r in kept)
    return dict(requests=len(out), shed=len(out) - len(kept),
                prefills=prefills, steps=eng.steps,
                wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
                tier_mix=eng.assign_tiers,
                routed=np.bincount([r.replica for r in kept],
                                   minlength=len(eng.replicas)).tolist(),
                sojourn_p50_p95_p99_steps=eng.sojourn_percentiles().tolist(),
                launches=launches)


class _RecordedPlayback:
    """A `HostPlayback` that records every slowdown the engine reads."""

    def __init__(self, playback):
        self.playback, self.seen = playback, []

    def slowdown(self, t, worker, tier=None):
        s = self.playback.slowdown(t, worker, tier)
        self.seen.append((int(t), int(worker), tier, s))
        return s

    def __getattr__(self, name):
        return getattr(self.playback, name)


def scenario_serving(dev, cfg, params, static_run) -> dict:
    """Phase 12b: the same engine, defaults and requests as phase 9 under
    ``EngineConfig(scenario="stragglers", scenario_horizon=H)``, H the
    engine steps of phase 9's drained run, so replicas 0 and 1 run at a
    quarter of their rate during steps [H/4, 3H/4).  Submitted all at
    once, every request is admitted at step 0, before the window opens,
    so the scenario's own arrival plan (`workloads.arrival_steps`, one
    cycle of H steps) times the submissions, as the reference's serving
    bench does.  Fatal: a request not drained with 17 tokens, launches
    other than 28 x prefills, non-finite logits, no admission observed at
    a slowdown of 4.0 (every such one on replicas 0-1 inside the window,
    which the playback repeats every H steps)."""
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.workloads import arrival_steps

    horizon = static_run["steps"]
    ecfg = EngineConfig(scenario="stragglers", scenario_horizon=horizon)
    eng = ServingEngine(cfg, params, ecfg, device=dev)
    eng.playback = _RecordedPlayback(eng.playback)
    reqs = serve_requests(cfg)
    when = arrival_steps(eng.playback.playback, len(reqs),
                         len(reqs) / horizon)
    run = drained_run(dev, SERVE_ARCH, cfg, eng, reqs,
                      f"{SERVE_ARCH} stragglers serving", submit_at=when)
    seen = eng.playback.seen
    slowed = sorted({(t, w) for t, w, _, s in seen if s == 4.0})
    run.update(scenario_horizon=horizon, submit_steps=when.tolist(),
               admissions=len(seen), slowed_admissions=slowed,
               static_tokens_per_s=static_run["tokens_per_s"])
    print(f"phase 12b, serving {cfg.name} under stragglers: "
          f"{json.dumps(run)}", flush=True)
    if len(seen) != len(reqs):
        raise AssertionError(f"{len(seen)} slowdowns read for "
                             f"{len(reqs)} admissions")
    # the playback wraps: step t reads the window at t mod H
    if not slowed or any(w not in (0, 1) or not horizon / 4 <= t % horizon
                         < 3 * horizon / 4 for t, w in slowed):
        raise AssertionError(f"admissions at a slowdown of 4.0: {slowed}; "
                             f"want at least one, all on replicas 0-1 "
                             f"inside steps [{horizon / 4}, "
                             f"{3 * horizon / 4}) mod {horizon}")
    return run


# phase 13b's placements: (label, EngineConfig.placement)
SERVE_PLACEMENTS = (("hdfs", "hdfs"), ("spread", "spread"),
                    ("hot_aware", ("hot_aware", {"hot_frac": 0.5})))
SERVE_REBALANCE_EVERY = 4


def placement_serving(dev, cfg, params, static_run) -> dict:
    """Phase 13b: the same engine, defaults and requests as phase 9 under
    each non-uniform placement (`SERVE_PLACEMENTS`, rebalanced every 4
    routed requests), counts set to 0 before each and read after.  Fatal:
    a request not drained with 17 tokens, launches other than 28 x
    prefills, non-finite logits, a routed count other than 16, no
    rebalance under hot_aware."""
    from repro_torch.placement import PlacementConfig
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    out = {}
    for label, spec in SERVE_PLACEMENTS:
        plc = spec if isinstance(spec, str) else PlacementConfig(*spec)
        eng = ServingEngine(cfg, params, EngineConfig(
            placement=plc, rebalance_every=SERVE_REBALANCE_EVERY),
            device=dev)
        reqs = serve_requests(cfg)
        run = drained_run(dev, SERVE_ARCH, cfg, eng, reqs,
                          f"{SERVE_ARCH} {label} placement serving")
        run.update(routed_requests=eng.routed, rebalanced=eng.rebalanced,
                   static_tokens_per_s=static_run["tokens_per_s"],
                   static_routed=static_run["routed"],
                   static_tier_mix=static_run["tier_mix"])
        print(f"phase 13b, serving {cfg.name} under placement {label}: "
              f"{json.dumps(run)}", flush=True)
        if eng.routed != len(reqs):
            raise AssertionError(f"{label}: {eng.routed} routed for "
                                 f"{len(reqs)} requests")
        if label == "hot_aware" and eng.rebalanced == 0:
            raise AssertionError("hot_aware: no rebalance moved a chunk")
        out[label] = run
    return out


def replication_serving(dev, cfg, params, static_run) -> dict:
    """Phase 14b: the same engine, defaults and requests as phase 9 under
    ``EngineConfig(scenario="server_loss", replication="repair",
    scenario_horizon=12)``, one request submitted a step, counts set to
    0 before and read after.  On the defaults' Topology(4, 2) the loss
    window kills pod 0 (servers 0 and 1) for steps 5-7 of every 12, and
    every prefix keeps a replica in pod 1.  Fatal: a request not drained
    with 17 tokens, launches other than 28 x prefills, non-finite logits,
    no repair move, availability at the end other than 1.0, a lost
    route."""
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    eng = ServingEngine(cfg, params, EngineConfig(
        scenario="server_loss", replication="repair", scenario_horizon=12),
        device=dev)
    rep, dead = eng.replication, []
    is_alive = rep.is_alive

    def recorded(host):   # the engine asks once an admission
        up = is_alive(host)
        if not up:
            dead.append((eng.steps, int(host)))
        return up

    rep.is_alive = recorded
    reqs = serve_requests(cfg)
    run = drained_run(dev, SERVE_ARCH, cfg, eng, reqs,
                      f"{SERVE_ARCH} server_loss + repair serving",
                      submit_at=list(range(len(reqs))))
    run.update(moves=rep.moves, dropped=rep.dropped,
               availability=rep.availability(),
               mean_replication=rep.mean_replication(),
               data_loss_frac=rep.data_loss_frac(),
               lost_routes=eng.lost_routes, lost_reads=rep.lost_reads,
               dead_admissions=dead, routed_requests=eng.routed,
               static_tokens_per_s=static_run["tokens_per_s"],
               static_routed=static_run["routed"],
               static_tier_mix=static_run["tier_mix"])
    print(f"phase 14b, serving {cfg.name} under server_loss + repair: "
          f"{json.dumps(run)}", flush=True)
    if rep.moves == 0:
        raise AssertionError("server_loss + repair: no repair move")
    if rep.availability() != 1.0:
        raise AssertionError(f"server_loss + repair: availability "
                             f"{rep.availability()}")
    if eng.lost_routes:
        raise AssertionError(f"server_loss + repair: {eng.lost_routes} "
                             f"lost routes")
    return run


def traced_serving(dev, cfg, params, repl_run) -> dict:
    """Phase 15b: phase 14b's engine, defaults, requests and submissions
    (server_loss + repair, scenario_horizon 12, one request a step) with
    ``tracer=EventRecorder()``; the trace saved to a temporary directory
    and read back with `load_trace`.  Fatal: a request not drained with
    17 tokens, launches other than 28 x prefills, non-finite logits; not
    16 submit, route and admit instants and 16 request spans on tids 1-4
    on the step clock; no decode span of cat kernel; no server_down; a
    repair_commit count other than the lifecycle's moves, or no
    repair_start; thread names other than the router's and the four
    replicas'; a dropped event.  Prints tokens/s beside 14b's and the
    median decode span (host ms of a replica step)."""
    import tempfile
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.telemetry import CLOCK_UNIT_US, EventRecorder, load_trace

    tracer = EventRecorder()
    eng = ServingEngine(cfg, params, EngineConfig(
        scenario="server_loss", replication="repair", scenario_horizon=12,
        tracer=tracer), device=dev)
    reqs = serve_requests(cfg)
    run = drained_run(dev, SERVE_ARCH, cfg, eng, reqs,
                      f"{SERVE_ARCH} traced server_loss + repair serving",
                      submit_at=list(range(len(reqs))))
    with tempfile.TemporaryDirectory() as tmp:
        doc = load_trace(tracer.save(os.path.join(tmp, "engine.json")))
    evs = doc["traceEvents"]
    count = {}
    for e in evs:
        count[e["name"]] = count.get(e["name"], 0) + 1
    spans = [e for e in evs if e["ph"] == "X" and e.get("cat") == "request"]
    decode = [e["dur"] / 1e3 for e in evs if e["name"] == "decode"
              and e.get("cat") == "kernel"]
    threads = sorted(e["args"]["name"] for e in evs
                     if e["name"] == "thread_name")
    rep = eng.replication
    n = len(reqs)
    run.update(events=len(evs), dropped_events=doc["otherData"]["dropped"],
               counts={k: count.get(k, 0) for k in (
                   "submit", "route", "admit", "queued", "decode",
                   "server_down", "server_up", "repair_start",
                   "repair_commit", "lost_route")},
               request_spans=len(spans), moves=rep.moves,
               decode_span_ms_median=(float(np.median(decode))
                                      if decode else None),
               replication_tokens_per_s=repl_run["tokens_per_s"])
    print(f"phase 15b, serving {cfg.name} traced: {json.dumps(run)}",
          flush=True)
    bad = []
    for name in ("submit", "route", "admit"):
        if count.get(name, 0) != n:
            bad.append(f"{count.get(name, 0)} {name} instants")
    if len(spans) != n or any(
            not 1 <= e["tid"] <= len(eng.replicas)
            or e["ts"] % CLOCK_UNIT_US or e["dur"] < CLOCK_UNIT_US
            for e in spans):
        bad.append(f"request spans (tid, ts, dur) "
                   f"{[(e['tid'], e['ts'], e['dur']) for e in spans]}")
    if not decode:
        bad.append("no decode span of cat kernel")
    if count.get("server_down", 0) < 1:
        bad.append("no server_down")
    if count.get("repair_commit", 0) != rep.moves or \
            count.get("repair_start", 0) < 1:
        bad.append(f"{count.get('repair_commit', 0)} repair_commit for "
                   f"{rep.moves} moves, {count.get('repair_start', 0)} "
                   f"repair_start")
    if threads != sorted(["router"] + [f"replica{i}" for i in
                                       range(len(eng.replicas))]):
        bad.append(f"thread names {threads}")
    if doc["otherData"]["dropped"]:
        bad.append(f"{doc['otherData']['dropped']} dropped events")
    if bad:
        raise AssertionError(f"traced serving: {'; '.join(bad)}")
    return run


# phase 16b's arms: a token bucket of 0.25 a step and 8 tokens for 16
# requests at once, and an autoscaler that shrinks on every reading
CTL_SERVE_BUCKET = {"name": "token_bucket",
                    "options": {"rate": 0.25, "burst": 8}}
CTL_SERVE_AUTOSCALE = {"name": "autoscale", "options": {
    "p95_high": 1e9, "p95_low": 1e8, "down_after": 2, "cooldown": 2,
    "min_servers": 1, "step_frac": 0.5}}
CTL_SERVE_USERS = {"name": "closed_loop",
                   "options": {"users": 8, "think_time": 4.0}}
CTL_SERVE_MAX_STEPS = 600


def control_serving(dev, cfg, params, static_run) -> dict:
    """Phase 16b: the same engine, defaults and requests as phase 9 under
    each control arm, counts set to 0 before each run and read after.
    Admission (`CTL_SERVE_BUCKET`, all 16 submitted at once): fatal
    unless it sheds at least one, admitted + shed = 16, admitted =
    completed = prefills, every admitted request drains with 17 tokens,
    flash_attention = 28 x prefills and no shed request was routed.
    Autoscale (`CTL_SERVE_AUTOSCALE`, traced, one request every two
    steps): fatal unless an ``autoscale`` event has a target under 4, no
    route after an event goes to a replica that event parked, every
    request drains and flash_attention = 28 x prefills.  Closed loop (8
    users, think time 4, the client pool polled every step until 16
    completions, as benchmarks/bench_serving.py drives it, then drained):
    fatal unless in-flight never passes 8 and the 16 completions take
    under 600 steps.  Every logits tensor finite.  Prints tokens/s beside
    phase 9's, the steps and the sojourn p95 of each arm."""
    from repro_torch.control import scale_priority
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
    from repro_torch.telemetry import EventRecorder

    out = {}
    n = SERVE_REQUESTS

    def report(label, eng, run):
        run.update(sojourn_p95_steps=float(eng.sojourn_percentiles(
            (0.95,))[0]), control=eng.control.metrics(),
            static_tokens_per_s=static_run["tokens_per_s"])
        print(f"phase 16b, serving {cfg.name} under {label}: "
              f"{json.dumps(run)}", flush=True)
        out[label] = run

    # admission
    eng = ServingEngine(cfg, params, EngineConfig(control=CTL_SERVE_BUCKET),
                        device=dev)
    reqs = serve_requests(cfg)
    run = drained_run(dev, SERVE_ARCH, cfg, eng, reqs,
                      f"{SERVE_ARCH} token-bucket serving")
    m = eng.control.metrics()
    shed = [r for r in reqs if r.finish_time == -1.0]
    report("admission", eng, run)
    if not (1 <= m["ctl_shed"] == len(shed) and m["ctl_admitted"]
            + m["ctl_shed"] == n and m["ctl_admitted"] == eng.completed
            == run["prefills"] == eng.routed):
        raise AssertionError(f"admission: {m}, {len(shed)} shed, "
                             f"{eng.completed} completed, {eng.routed} "
                             f"routed, {run['prefills']} prefills")
    if any(r.replica != -1 or r.generated is not None for r in shed):
        raise AssertionError("admission: a shed request was routed")

    # autoscale, traced
    tracer = EventRecorder()
    eng = ServingEngine(cfg, params, EngineConfig(
        control=CTL_SERVE_AUTOSCALE, tracer=tracer), device=dev)
    run = drained_run(dev, SERVE_ARCH, cfg, eng, serve_requests(cfg),
                      f"{SERVE_ARCH} autoscale serving",
                      submit_at=[2 * i for i in range(n)])
    rank = scale_priority(eng.spec)
    events = [e for e in tracer.events() if e["name"] in ("autoscale",
                                                          "route")]
    targets = [(e["ts"], e["args"]["target"]) for e in events
               if e["name"] == "autoscale"]
    late, target = [], len(eng.replicas)
    for e in events:   # in emission order: a step's routes precede it
        if e["name"] == "autoscale":
            target = e["args"]["target"]
        elif rank[e["args"]["replica"]] >= target:
            late.append((e["ts"], e["args"]["replica"], target))
    run.update(autoscale_events=targets,
               routes_after_first=sum(e["name"] == "route" and targets
                                      and e["ts"] > targets[0][0]
                                      for e in events))
    report("autoscale", eng, run)
    if not any(t < len(eng.replicas) for _, t in targets) or late:
        raise AssertionError(f"autoscale: events {targets}, routes to "
                             f"parked replicas {late}")

    # closed loop, as the serving bench drives it
    eng = ServingEngine(cfg, params, EngineConfig(control=CTL_SERVE_USERS),
                        device=dev)
    flight, budget_steps = [], []

    def drive(e):
        rng, made = np.random.default_rng(0), []
        clients = e.control.clients
        while e.completed < n:
            for _ in range(clients.poll(e.steps, e.completed)):
                made.append(Request(rid=len(made), prompt=rng.integers(
                    0, cfg.vocab_size, int(rng.integers(24, 121))
                ).astype(np.int32), max_new_tokens=SERVE_NEW,
                    prefix_id=len(made) % 5))
                e.submit(made[-1])
            flight.append(clients.in_flight)
            e.step()
            if e.steps >= CTL_SERVE_MAX_STEPS:
                break
        budget_steps.append(e.steps)
        while any(r.finish_time == 0.0 for r in made):   # drain the rest
            e.step()
        return made

    run = drained_run(dev, SERVE_ARCH, cfg, eng, None,
                      f"{SERVE_ARCH} closed-loop serving", drive=drive)
    run.update(steps_to_budget=budget_steps[0], max_in_flight=max(flight))
    report("closed_loop", eng, run)
    if max(flight) > 8 or budget_steps[0] >= CTL_SERVE_MAX_STEPS:
        raise AssertionError(f"closed loop: in flight up to {max(flight)}, "
                             f"{budget_steps[0]} steps to {n} completions")
    return out


def attention_fault_reading(dev, cfg, params, ecfg, prompt, logit_tol):
    """`prefill_compare` with a deliberately wrong attention: every row
    sees one key past its causal edge (k and v given one more key, zero
    at the end, so the kernel's offset Tk - Tq is 1).  Its share must
    exceed `logit_tol`, or the limit cannot see such a fault (fatal)."""
    from repro_torch.kernels import ops

    real = ops.flash_attention

    def one_past(q, k, v, **opts):
        def pad(x):
            return torch.cat([x, x.new_zeros(x.shape[:2] + (1,)
                                             + x.shape[3:])], 2)
        return real(q, pad(k), pad(v), **opts)

    with mock.patch.object(ops, "flash_attention", one_past):
        got = prefill_compare(dev, cfg, params, ecfg, prompt, "pallas",
                              math.inf)
    if not got["share"] > logit_tol:
        raise AssertionError(f"a kernel one key past the causal edge reads "
                             f"{got['share']}, within the limit {logit_tol}")
    return got


def ssd_ab(eng, reqs) -> dict:
    """Tokens/s of the same drained run with bf16 `ssd` on the tensor
    cores and on the recurrent kernel in turn, every request drained
    each time (one run each since phase 12 came: the serving runs are
    host-bound, and the kernels are timed on their own in phase 3c)."""
    from repro_torch.serve.engine import Request

    out = {"tc": [], "recurrent": []}
    for which in ("tc", "recurrent"):
        fresh = [Request(rid=1000 + r.rid, prompt=r.prompt,
                         max_new_tokens=r.max_new_tokens,
                         prefix_id=r.prefix_id) for r in reqs]
        route = (_ssd_recurrent() if which == "recurrent"
                 else contextlib.nullcontext())
        with route:
            t0 = time.perf_counter()
            done = eng.run_until_drained(fresh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if any(len(r.generated) != SERVE_NEW + 1 for r in done):
            raise AssertionError(f"a request of the {which} run did not "
                                 f"drain with {SERVE_NEW + 1} tokens")
        out[which].append(sum(len(r.generated) for r in done) / wall)
    print(f"mamba serving tokens/s, ssd on the tensor cores vs the "
          f"recurrent kernel: {json.dumps(out)}", flush=True)
    return out


@contextlib.contextmanager
def _recorded_routes():
    """Records every `layers.moe_route` result made inside (one a MoE
    layer a forward, in layer order)."""
    from repro_torch.models import layers as L

    seen, real = [], L.moe_route

    def route(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    with mock.patch.object(L, "moe_route", route):
        yield seen


def prefill_compare(dev, cfg, params, ecfg, prompt, impl,
                    logit_tol) -> dict:
    """One right-padded prefill of `prompt` through the kernel route
    (`impl`) and the plain route (impl="xla"), each forward free of host
    syncs: the last real row's max |logit difference| and its share of
    the row's max |logit| (`share`), printed; raises when the share is
    beyond `logit_tol`.  For an MoE model, per layer, the real tokens
    whose chosen experts differ between the two routes (as sets, and in
    top-k order)."""
    from repro_torch.models import transformer as T

    t = len(prompt)
    bucket = next(b for b in ecfg.prefill_buckets if b >= t)
    tok = np.zeros((1, bucket), np.int32)
    tok[0, :t] = prompt
    pos = np.where(np.arange(bucket) < t, np.arange(bucket),
                   -(np.arange(bucket) - t + 1)).astype(np.int32)[None]
    tok, pos = torch.as_tensor(tok, device=dev), torch.as_tensor(pos,
                                                                 device=dev)
    last, prefill_ms, choices = {}, {}, {}
    for route in (impl, "xla", impl, "xla"):
        caches = T.init_caches(cfg, 1, ecfg.max_len, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # no host sync inside
        try:
            with _recorded_routes() as routes:
                logits, _, _ = T.forward(params, cfg, tok, positions=pos,
                                         caches=caches, impl=route)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        prefill_ms[route] = (time.perf_counter() - t0) * 1e3  # second run
        last[route] = logits[0, t - 1, :cfg.vocab_size]  # no pad rows
        choices[route] = [r["top_e"][:t] for r in routes]   # real rows
    diff = float((last[impl] - last["xla"]).abs().max())
    scale = float(last["xla"].abs().max())
    compare = dict(model=cfg.name, dtype=cfg.dtype, prompt_tokens=t,
                   bucket=bucket,
                   max_abs_diff=diff, max_abs_logit=scale,
                   share=diff / scale, tolerance=logit_tol * scale,
                   margin=logit_tol * scale - diff,
                   same_argmax=bool(last[impl].argmax()
                                    == last["xla"].argmax()),
                   prefill_ms=prefill_ms)
    if cfg.moe is not None:   # router choices that differ, layer by layer
        pairs = list(zip(choices[impl], choices["xla"]))
        compare["moe_layers"] = len(pairs)
        compare["moe_set_flips"] = [
            int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
            for a, b in pairs]
        compare["moe_order_flips"] = [int((a != b).any(-1).sum())
                                      for a, b in pairs]
        compare["moe_choices"] = t * cfg.moe.top_k * len(pairs)
    print(f"prefill kernel route vs plain route: {json.dumps(compare)}",
          flush=True)
    if not compare["share"] <= logit_tol:
        raise AssertionError(f"kernel and plain prefill logits of "
                             f"{cfg.name} ({cfg.dtype}) differ by {diff}, "
                             f"beyond {logit_tol} x {scale}")
    return compare


def decode_window(dev, eng, ecfg, reqs) -> dict:
    """A decode window on one replica with all its slots busy: admit
    times, decode tokens/s and a profiled window of decode steps."""
    from repro_torch.serve.engine import Request

    rep = eng.replicas[0]
    admit_ms = []
    for i in range(ecfg.slots_per_replica):
        r = Request(rid=100 + i, prompt=reqs[i].prompt, max_new_tokens=100,
                    prefix_id=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep.admit(r)        # one prefill, ending in a host read
        admit_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(4):
        rep.decode_once()   # warm up
    torch.cuda.synchronize()
    steps = 16
    t0 = time.perf_counter()
    for _ in range(steps):
        rep.decode_once()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    decode = dict(batch=ecfg.slots_per_replica, ms_per_step=step_s * 1e3,
                  tokens_per_s=ecfg.slots_per_replica / step_s,
                  admit_ms=admit_ms,
                  prompt_tokens=[len(reqs[i].prompt)
                                 for i in range(ecfg.slots_per_replica)])
    decode.update(_profile_window(dev, rep.decode_once, 8))
    print(f"decode window: {json.dumps(decode)}", flush=True)
    return decode


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _launches_of(fn, calls: int = 20) -> dict:
    """What `calls` calls of `fn` asked of the card, from torch.profiler's
    record of the host's CUDA runtime calls (which it keeps whole, where
    it sometimes drops device records of a window): kernel launches,
    copies and sets, and the names of the device activities it did
    record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e.name for e in events if e.device_type == DeviceType.CPU]
    return dict(
        launches=sum(n in LAUNCH_CALLS for n in host),
        copies=sum(n.startswith(("cudaMemcpy", "cudaMemset")) for n in host),
        device=sorted({e.name for e in events
                       if e.device_type == DeviceType.CUDA}))


def _launcher_row(name, calls, dev_kernel):
    """The kernel at the largest shape the launcher gave it (the smoke
    config, float32): 20 calls are 20 kernel launches, no copy or set,
    and every device activity the profiler records is `dev_kernel`
    (fatal), then its error against the plain version, times by events
    and on the device, the plain version's, the bound and, for causal
    attention with Tq = Tk, no softcap and no window that binds (none,
    or one of at least Tk keys, which keeps every pair), one SDPA
    call."""
    from repro_torch.kernels import ops, ref

    args, kwargs = max(calls, key=lambda c: c[0][0].numel())
    dtype = args[0].dtype
    if name == "flash_attention":
        q, k, v = args
        kernel = lambda: ops.flash_attention(*args, **kwargs)  # noqa: E731
        plain = lambda: ref.mha(*args, **kwargs)  # noqa: E731
        shape = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                 q.shape[3])
        bound = attention_cost(shape, kwargs.get("causal", True),
                            kwargs.get("window", 0), dtype)
        err = _attn_check(f"launcher {shape}", kernel(), plain(), dtype)[0]
        window = kwargs.get("window", 0)
        library = (_sdpa_fn(q, k, v, kwargs.get("scale") or
                            q.shape[-1] ** -0.5)
                   if (not window or window >= shape[4])
                   and not kwargs.get("softcap")
                   and kwargs.get("causal", True) and shape[3] == shape[4]
                   else None)
    else:
        x, a, b, c = args[:4]
        init = kwargs.get("init_state", args[4] if len(args) > 4 else None)
        kernel = lambda: ops.ssd(x, a, b, c, init_state=init)  # noqa: E731
        plain = lambda: ref.ssd(x, a, b, c, init)  # noqa: E731
        shape = tuple(x.shape) + (b.shape[-1],)
        bound = ssd_cost(shape, dtype)
        err = _ssd_check(f"launcher {shape}", kernel(), plain(), dtype)[0]
        library = None
    calls_profiled = 20
    seen = _launches_of(kernel, calls_profiled)
    if (seen["launches"] != calls_profiled or seen["copies"]
            or not all(dev_kernel in d for d in seen["device"])):
        raise AssertionError(f"{name} at the launcher's shape {shape}: "
                             f"{calls_profiled} calls made {seen}, want "
                             f"one launch of {dev_kernel} a call and no "
                             f"copy")
    row = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               calls=len(calls),
               launches_a_call=seen["launches"] / calls_profiled,
               max_abs_err=err,
               ms=_time_ms(kernel, KERNEL_REPS),
               device_ms=_device_ms(kernel, dev_kernel, KERNEL_REPS),
               plain_ms=_time_ms(plain, PLAIN_REPS), bound_ms=bound[0],
               bound_by=bound[1], library_ms=(_time_ms(library, KERNEL_REPS)
                                              if library else None))
    print(f"{name} at the launcher's largest shape: {json.dumps(row)}",
          flush=True)
    return row


LAUNCHER_MOE_REQS = 4   # tests/test_launchers.py::test_serve_cli


def phase_launcher(dev):
    """`python -m repro_torch.launch.serve` with its defaults (the smoke
    config on the card, float32), then with `--arch mamba2_13b`, then
    `--arch granite_moe_1b --requests 4` (the reference's serving CLI
    test) and `--arch mixtral_8x22b --requests 4`, counts set to 0
    before and read after each; each kernel's calls are recorded, and at
    the largest shape each run gave it a call is checked to be one
    launch of the float32 tensor-core kernel and nothing else, then
    timed (`_launcher_row`)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    seen = {"flash_attention": [], "ssd": []}

    def recorded(name):
        real = getattr(ops, name)

        def call(*args, **kwargs):
            seen[name].append((args, kwargs))
            return real(*args, **kwargs)
        return mock.patch.object(ops, name, call)

    _zero_counts()
    with recorded("flash_attention"):
        serve.main([])
    layers = registry.get_smoke_config("chatglm3_6b").num_layers
    got = {SERVE_ARCH: _check_counts("launcher",
                                     {"flash_attention": layers * 16})}
    _zero_counts()
    with recorded("ssd"):
        serve.main(["--arch", MAMBA_ARCH])
    layers = registry.get_smoke_config(MAMBA_ARCH).num_layers
    got[MAMBA_ARCH] = _check_counts("launcher --arch mamba2_13b",
                                    {"ssd": layers * 16})
    rows = {"flash_attention": _launcher_row(
                "flash_attention", seen["flash_attention"], TF32_KERNEL),
            "ssd": _launcher_row("ssd", seen["ssd"], SSD_TF32_KERNEL)}
    # the MoE smoke configs, float32 at D = 16 (granite-moe-1b) and D = 8
    # (mixtral-8x22b, window 4096): `_launcher_row` checks that each ran
    # on the float32 tensor-core kernel alone
    for arch in (MOE_ARCH, MOE_SMOKE_ARCH):
        seen["flash_attention"] = []
        _zero_counts()
        with recorded("flash_attention"):
            serve.main(["--arch", arch, "--requests", str(LAUNCHER_MOE_REQS)])
        smoke = registry.get_smoke_config(arch)
        got[arch] = _check_counts(
            f"launcher --arch {arch} --requests {LAUNCHER_MOE_REQS}",
            {"flash_attention": smoke.num_layers * LAUNCHER_MOE_REQS})
        rows[f"flash_attention {arch}"] = _launcher_row(
            "flash_attention", seen["flash_attention"], TF32_KERNEL)
    return got, rows


# ---------------------------------------------------------------------------
# Phase 17: training (the pipeline, lm_loss, AdamW, the trainer, the
# checkpointer, the launcher)
# ---------------------------------------------------------------------------

TRAIN_ARCH = MAMBA_ARCH
# 4 steps (8 until phase 19 came; cut for time, every gate kept: the
# losses of the 8-step runs read 11.18, 9.85, 13.20, 10.39 over the first
# four, and the pipeline's reads below hold at 4 steps)
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 4, 512, 8
# chunks of 256 tokens: 4 steps of 8 x 513 tokens make 65 chunk reads
# (at the default 65 536 they would make one, and the straggler check
# would say nothing)
TRAIN_TOKENS_PER_CHUNK = 256
TRAIN_SLOW = {0: 0.1}                 # host 0 reads 10x slower
# the straggler must serve at most this share of the reads host 0 serves
# in the same pipeline without it (seed 0, 4 steps: 1 of 65 with the
# straggler, 9 of 65 without)
TRAIN_STRAGGLER_SHARE = 0.5
TRAIN_CHECK_ARCHS = (SERVE_ARCH, MAMBA_ARCH, MOE_ARCH)
TRAIN_CHECK_TOL = 1e-4                # card vs CPU, float32, TF32 off
TRAIN_SMOKE_SEQ = 32
TRAIN_LAUNCHER_ARGS = ["--arch", TRAIN_ARCH, "--full", "--steps", "2",
                       "--seq-len", str(TRAIN_SEQ), "--global-batch",
                       str(TRAIN_BATCH)]


def _train_plan(cfg):
    """`plan_for(cfg, "train_4k", "train")` with the warmup shortened as
    examples/quickstart.py shortens it (5 steps, decay over 200): the
    production warmup of 100 steps would leave a short run's loss flat."""
    from repro_torch.configs import runtime
    plan = runtime.plan_for(cfg, "train_4k", "train")
    return dataclasses.replace(plan, opt=dataclasses.replace(
        plan.opt, warmup_steps=5, decay_steps=200))


def _train_tensors(state):
    from repro_torch.models.params import tree_leaves
    return (tree_leaves(state.params) + tree_leaves(state.opt.mu)
            + tree_leaves(state.opt.nu) + [state.opt.count, state.step])


@contextlib.contextmanager
def _recorded_loss_metrics():
    """Records the metrics of every `transformer.lm_loss` call made
    inside (one a microbatch; the train step reads only the loss)."""
    from repro_torch.models import transformer as T

    seen, real = [], T.lm_loss

    def loss(*args, **kwargs):
        total, met = real(*args, **kwargs)
        seen.append({k: v.detach() for k, v in met.items()})
        return total, met

    with mock.patch.object(T, "lm_loss", loss):
        yield seen


def train_full_width(dev) -> dict:
    """17a: mamba2-1.3b at full width in bf16 through `Trainer`, fed by
    the locality-aware pipeline with a 10x straggler, 4 steps; then one
    microbatch's forward and backward under the profiler, and the same
    pipeline without the straggler for the same batches (the control of
    the straggler check)."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.params import count_params, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = registry.get_config(TRAIN_ARCH)
    pcfg = PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, token_skew=1.2,
        tokens_per_chunk=TRAIN_TOKENS_PER_CHUNK)
    pipe = DataPipeline(pcfg, slow_hosts=TRAIN_SLOW)
    plan = _train_plan(cfg)
    n_mb = steps.num_microbatches(plan, TRAIN_BATCH)
    tr = Trainer(cfg, TrainerConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    steps=TRAIN_STEPS, log_every=1),
                 plan, pipeline=pipe, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.init_state()
    n = count_params(tr.state.params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        rec = tr.history[-1]
        print(f"  17a step {rec['step']}: loss {rec['loss']:.4f} grad_norm "
              f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e} "
              f"{step_s[-1] * 1e3:.1f} ms, {tokens / step_s[-1]:.0f} "
              f"tokens/s", flush=True)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(step_s[1:])         # not the first
    med_s = steady[len(steady) // 2]
    flops = 6 * n * tokens             # model FLOPs, recompute excluded
    reads = pipe.metrics["host_reads"]
    # the control: the same pipeline and seed without the straggler, for
    # the same batches (its last one feeds the profiled microbatch)
    ctrl = DataPipeline(pcfg, slow_hosts={})
    for _ in range(TRAIN_STEPS):
        last = next(ctrl)
    ctrl_reads = ctrl.metrics["host_reads"]
    # one microbatch's forward and backward under the profiler (a whole
    # step's profile costs 10x its time); a step runs n_mb of them, and
    # the accumulation and the update besides
    leaves = [p.requires_grad_(True) for p in tree_leaves(tr.state.params)]
    mb = {k: steps.microbatch(torch.as_tensor(last[k], device=dev), n_mb, 0)
          for k in ("tokens", "labels")}
    fwd_bwd = lambda: torch.autograd.grad(
        T.lm_loss(tr.state.params, cfg, mb, remat=plan.remat)[0], leaves)
    prof = _profile_window(dev, fwd_bwd, 1, cpu=False, top=12, chars=160)
    busy_ms = (prof["device_busy_share"] or 0.0) * prof["window_ms_per_step"]
    losses = [r["loss"] for r in tr.history]
    norms = [r["grad_norm"] for r in tr.history]
    out = {
        "arch": cfg.name, "params": n, "dtype": cfg.dtype,
        "steps": TRAIN_STEPS, "seq_len": TRAIN_SEQ,
        "global_batch": TRAIN_BATCH,
        "microbatches": plan.microbatches, "remat": plan.remat,
        "losses": losses, "grad_norms": norms,
        "lrs": [r["lr"] for r in tr.history],
        "step_ms": [x * 1e3 for x in step_s],
        "median_step_ms": med_s * 1e3, "tokens_per_s": tokens / med_s,
        "model_flops_per_step": flops,
        "bf16_peak_share": flops / med_s / BF16_OPS_PER_S,
        "max_memory_allocated_bytes": peak,
        # bf16 params + float32 mu, nu and accumulator + one
        # microbatch's bf16 gradients
        "reckoned_state_bytes": 16 * n,
        "locality_fractions": pipe.locality_fractions,
        "host_reads": reads.tolist(),
        "host0_reads": int(reads[0]), "mean_host_reads": float(reads.mean()),
        "host0_share": float(reads[0] / reads.sum()),
        "control_host_reads": ctrl_reads.tolist(),
        "control_host0_reads": int(ctrl_reads[0]),
        "microbatch_fwd_bwd_profile": prof,
        # n_mb profiled microbatches: a step's launches and busy time
        # less the accumulation's and the update's
        "fwd_bwd_launches_per_step": n_mb * prof["device_launches_per_step"],
        "fwd_bwd_busy_over_median_step": n_mb * busy_ms / (med_s * 1e3)}
    print(f"  17a: {n} params, median step {med_s * 1e3:.1f} ms, "
          f"{tokens / med_s:.0f} tokens/s, model FLOPs {flops:.3e} a step "
          f"({flops / med_s / BF16_OPS_PER_S:.4f} of the bf16 dense "
          f"peak), max_memory_allocated {peak / 1e9:.2f} GB beside the "
          f"reckoned state {16 * n / 1e9:.2f} GB, locality "
          f"{pipe.locality_fractions}, host 0 {int(reads[0])} of "
          f"{int(reads.sum())} reads (mean {reads.mean():.2f}; without "
          f"the straggler {int(ctrl_reads[0])} of {int(ctrl_reads.sum())}), "
          f"one microbatch's forward and backward "
          f"{prof['window_ms_per_step']:.1f} ms profiled, "
          f"{prof['device_launches_per_step']:.0f} launches, busy "
          f"{busy_ms:.1f} ms: x{n_mb} is "
          f"{out['fwd_bwd_busy_over_median_step']:.3f} of the median "
          f"step", flush=True)
    bad = [x for x in losses + norms if not math.isfinite(x)]
    if bad:
        raise AssertionError(f"17a: a loss or grad norm is not finite: "
                             f"{losses} {norms}")
    if abs(losses[0] - math.log(cfg.padded_vocab)) > 1.0:
        raise AssertionError(f"17a: first loss {losses[0]} not within 1 "
                             f"nat of ln({cfg.padded_vocab})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"17a: last loss {losses[-1]} not below the "
                             f"first {losses[0]}")
    if not reads[0] < reads.mean():
        raise AssertionError(f"17a: the straggler host 0 served "
                             f"{reads[0]} reads, the mean host "
                             f"{reads.mean()}")
    if not (reads.sum() == ctrl_reads.sum() and reads[0]
            <= TRAIN_STRAGGLER_SHARE * ctrl_reads[0]):
        raise AssertionError(f"17a: the straggler host 0 served "
                             f"{reads[0]} of {reads.sum()} reads, without "
                             f"the slowdown {ctrl_reads[0]} of "
                             f"{ctrl_reads.sum()}: not at most "
                             f"{TRAIN_STRAGGLER_SHARE} of it")
    return out


def train_card_vs_cpu(dev) -> dict:
    """17b: one `build_train_step` step of each smoke config (float32) on
    the card and on the CPU, from the same weights and batch (for an MoE
    config, the microbatches' mean `moe_aux` too)."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import steps
    from repro_torch.models import params as P
    from repro_torch.optim import adamw

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products
    out = {}
    try:
        for arch in TRAIN_CHECK_ARCHS:
            cfg = registry.get_smoke_config(arch)
            plan = _train_plan(cfg)
            batch = next(DataPipeline(PipelineConfig(
                vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE_SEQ,
                global_batch=TRAIN_BATCH, token_skew=1.2)))
            prm = P.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
            got = {}
            for where in ("cpu", dev):
                p = P.tree_map(lambda t: t.to(where, copy=True), prm)
                state = steps.TrainState(
                    p, adamw.init(plan.opt, p),
                    torch.zeros((), dtype=torch.int32, device=where))
                fn, _, _ = steps.build_train_step(
                    cfg, plan, TRAIN_BATCH, TRAIN_SMOKE_SEQ, device=where)
                with _recorded_loss_metrics() as mets:
                    _, met = fn(state, batch)
                got[str(where)] = {k: float(v) for k, v in met.items()}
                if cfg.moe is not None:   # the microbatches' mean aux
                    got[str(where)]["moe_aux"] = float(np.mean(
                        [float(m["moe_aux"]) for m in mets]))
            want, card = got["cpu"], got[str(dev)]
            rel = {k: abs(card[k] - want[k]) / abs(want[k])
                   for k in ("loss", "grad_norm", "moe_aux") if k in want}
            out[arch] = {"cpu": want, "card": card, "rel": rel}
            print(f"  17b {arch}: card {card}, cpu {want}, rel {rel}",
                  flush=True)
            if max(rel.values()) > TRAIN_CHECK_TOL:
                raise AssertionError(f"17b {arch}: card vs CPU {rel} over "
                                     f"{TRAIN_CHECK_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def train_checkpoint(dev) -> dict:
    """17c: a checkpoint round trip on the card at the chatglm3-6b smoke
    config: saved at step 2, restored into a new `Trainer`."""
    import pathlib
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = registry.get_smoke_config(SERVE_ARCH)
    plan = _train_plan(cfg)
    with tempfile.TemporaryDirectory() as d:
        mk = lambda: Trainer(cfg, TrainerConfig(
            seq_len=TRAIN_SMOKE_SEQ, global_batch=TRAIN_BATCH, steps=2,
            ckpt_every=2, log_every=1, ckpt_dir=d), plan, device=dev)
        a = mk()
        a.init_state()
        a.run(2)
        b = mk()
        step = b.restore_or_init()
        b.pipeline.load_state_dict(
            b.ckpt.manifest()["metadata"]["pipeline"])
        pairs = list(zip(_train_tensors(a.state), _train_tensors(b.state)))
        unequal = sum(not (x.dtype == y.dtype and y.device == x.device
                           and torch.equal(x, y)) for x, y in pairs)
        want, got = next(a.pipeline), next(b.pipeline)
        same_batch = all(want[k].tobytes() == got[k].tobytes()
                         for k in want)
        nbytes = sum(f.stat().st_size
                     for f in pathlib.Path(d).rglob("*.npz"))
    out = {"restored_step": step, "tensors": len(pairs),
           "unequal_tensors": unequal, "next_batch_equal": same_batch,
           "npz_bytes": nbytes}
    print(f"  17c: {out}", flush=True)
    if step != 2 or unequal or not same_batch:
        raise AssertionError(f"17c: checkpoint round trip failed: {out}")
    return out


def train_launcher() -> dict:
    """17d: `python -m repro_torch.launch.train` at full width on the
    card (`device=None`)."""
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    hist = launch_train.main(TRAIN_LAUNCHER_ARGS)
    secs = time.perf_counter() - t0
    losses = [r["loss"] for r in hist]
    if not hist or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"17d: launcher history {hist}")
    return {"args": TRAIN_LAUNCHER_ARGS, "seconds": secs, "losses": losses}


def phase_train(dev) -> dict:
    """Phase 17: training, counts set to 0 before and read after (the
    training path runs none of the five kernels: the reference trains
    with impl="xla", and no kernel has a backward)."""
    import gc

    secs = {}
    _zero_counts()
    t0 = time.perf_counter()
    out = {"17a": train_full_width(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    secs["17a"] = time.perf_counter() - t0
    for name, fn in (("17b", lambda: train_card_vs_cpu(dev)),
                     ("17c", lambda: train_checkpoint(dev)),
                     ("17d", train_launcher)):
        t0 = time.perf_counter()
        out[name] = fn()
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    out["launches"] = _check_counts("training", {})
    out["seconds"] = secs
    print(f"training: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 18: the MoE slice (granite-moe-1b served and trained at full width)
# ---------------------------------------------------------------------------

MOE_CHECK_TOKENS = (8192, 1024)   # 18b: the capacity branch, drop-free
# 18b's tokens share one direction at this weight beside their own normal
# draws (hidden states do), which skews the experts' loads: at n = 8192
# 6.6% of the pairs overflow the capacity of 3072 and are dropped, where
# the draws alone leave every expert under 2,150 and drop none
MOE_CHECK_SHIFT = 0.5
MOE_CHECK_Y_TOL = 1e-4            # of the largest |y|, float32, TF32 off
MOE_CHECK_AUX_TOL = 1e-6
MOE_TRAIN_STEPS = 4


def _moe_layer_params(cfg, seed: int) -> dict:
    """One MoE layer's weights at `cfg`'s width, drawn on the CPU from a
    seed by `params.init_params`' rule (normal over sqrt(fan-in)),
    float32."""
    from repro_torch.models import params as P

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, d in sorted(P.layer_defs(cfg, cfg.stages[0].block[0])
                          ["moe"].items()):
        fan_in = int(np.prod([d.shape[i] for i in d.fan_in_dims]))
        out[name] = torch.randn(d.shape, generator=gen) / math.sqrt(fan_in)
    return out


def moe_layer_card_vs_cpu(dev) -> dict:
    """18b: `moe_mlp` at granite-moe-1b's full width on one layer's seeded
    weights, float32 (TF32 off), on the card and on the CPU: at n = 8192
    tokens (the capacity branch, cap 3072; `MOE_CHECK_SHIFT` makes some
    experts overflow it) and n = 1024 (drop-free), the
    top-k choices and the kept mask equal on both devices (a token whose
    choices differ, a float32 near-tie, is counted, at most one in 1000
    tokens, and left out of the output comparison with the tokens whose
    kept mask it moved), y within `MOE_CHECK_Y_TOL` of its largest value,
    the aux within `MOE_CHECK_AUX_TOL`; then the same capacity call
    twice on the card in bf16, bit for bit (the combine has no atomic
    add), and its time."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(registry.get_config(MOE_ARCH), dtype="float32")
    p = _moe_layer_params(cfg, 18)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        shift = MOE_CHECK_SHIFT * torch.randn(
            (cfg.d_model,), generator=torch.Generator().manual_seed(1))
        for n in MOE_CHECK_TOKENS:
            x = torch.randn((1, n, cfg.d_model),
                            generator=torch.Generator().manual_seed(n)) + shift
            got = {}
            for where in ("cpu", dev):
                pw = {k: v.to(where) for k, v in p.items()}
                with _recorded_routes() as routes:
                    y, aux = L.moe_mlp(pw, cfg, x.to(where))
                got[str(where)] = (y.cpu(), float(aux), routes[0])
            (yc, ac, rc), (yd, ad, rd) = got["cpu"], got[str(dev)]
            same_e = (rc["top_e"] == rd["top_e"].cpu()).all(-1)
            keep_c = rc["keep"].reshape(n, -1)
            keep_d = rd["keep"].cpu().reshape(n, -1)
            same = same_e & (keep_c == keep_d).all(-1)
            scale = float(yc.abs().max())
            err = float((yc[0][same] - yd[0][same]).abs().max())
            row = dict(tokens=n, cap=rc["cap"], capacity_branch=rc["cap"] < n,
                       dropped_pair_share=float(1 - keep_c.float().mean()),
                       choice_flip_tokens=int((~same_e).sum()),
                       keep_mismatch_tokens=int((same_e & ~same).sum()),
                       max_abs_err=err, max_abs_y=scale,
                       aux_cpu=ac, aux_card=ad, aux_err=abs(ac - ad))
            out[f"n={n}"] = row
            print(f"  18b moe_mlp card vs CPU: {json.dumps(row)}", flush=True)
            # a flip moves the ranks of the pairs after it, so the kept
            # mask may then differ on tokens whose choices do not
            if ((row["keep_mismatch_tokens"] and not row[
                    "choice_flip_tokens"])
                    or (row["capacity_branch"]
                        and not row["dropped_pair_share"] > 0)
                    or not err <= MOE_CHECK_Y_TOL
                    * scale or not row["aux_err"] <= MOE_CHECK_AUX_TOL
                    or row["choice_flip_tokens"] > n // 1000):
                raise AssertionError(f"18b: moe_mlp card vs CPU at n={n}: "
                                     f"{row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    pb = {k: v.to(dev, torch.bfloat16) for k, v in p.items()}
    x = (torch.randn((1, MOE_CHECK_TOKENS[0], cfg.d_model),
                     generator=torch.Generator().manual_seed(0))
         + shift).to(dev, torch.bfloat16)
    fn = lambda: L.moe_mlp(pb, cfg16, x)[0]  # noqa: E731
    y1, y2 = fn(), fn()
    out["bf16_bitwise"] = bool(torch.equal(y1, y2))
    out["bf16_ms"] = _time_ms(fn, 10)
    print(f"  18b bf16 moe_mlp at n={MOE_CHECK_TOKENS[0]}: twice bit for "
          f"bit {out['bf16_bitwise']}, {out['bf16_ms']:.3f} ms a call",
          flush=True)
    if not out["bf16_bitwise"]:
        raise AssertionError("18b: two bf16 moe_mlp calls on the card "
                             "differ")
    return out


def moe_train_full_width(dev) -> dict:
    """18c: granite-moe-1b at full width in bf16 through `Trainer` and
    `DataPipeline` (vocab 49155, seq 512, global batch 8, token skew
    1.2), `plan_for(cfg, "train_4k", "train")` (4 microbatches of 1024
    tokens: the drop-free branch) with the quickstart's 5-step warmup,
    `MOE_TRAIN_STEPS` steps, each microbatch's `moe_aux` recorded; then
    one microbatch's forward and backward under the profiler.  Fatal: a
    loss not finite, the last loss not below the first, an aux not
    finite and positive."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import steps
    from repro_torch.models import config as mconfig
    from repro_torch.models import transformer as T
    from repro_torch.models.params import count_params, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = registry.get_config(MOE_ARCH)
    pipe = DataPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, token_skew=1.2))
    plan = _train_plan(cfg)
    n_mb = steps.num_microbatches(plan, TRAIN_BATCH)
    tr = Trainer(cfg, TrainerConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    steps=MOE_TRAIN_STEPS, log_every=1),
                 plan, pipeline=pipe, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.init_state()
    n = count_params(tr.state.params)
    active = mconfig.active_param_count(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s, auxes = [], []
    for _ in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recorded_loss_metrics() as mets:
            tr.run(1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        auxes.append([float(m["moe_aux"]) for m in mets])
        rec = tr.history[-1]
        print(f"  18c step {rec['step']}: loss {rec['loss']:.4f} grad_norm "
              f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e} moe_aux "
              f"{auxes[-1]} {step_s[-1] * 1e3:.1f} ms, "
              f"{tokens / step_s[-1]:.0f} tokens/s", flush=True)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(step_s[1:])
    med_s = steady[len(steady) // 2]
    flops = 6 * active * tokens
    last = next(DataPipeline(pipe.cfg))
    leaves = [p.requires_grad_(True) for p in tree_leaves(tr.state.params)]
    mb = {k: steps.microbatch(torch.as_tensor(last[k], device=dev), n_mb, 0)
          for k in ("tokens", "labels")}
    fwd_bwd = lambda: torch.autograd.grad(  # noqa: E731
        T.lm_loss(tr.state.params, cfg, mb, remat=plan.remat)[0], leaves)
    prof = _profile_window(dev, fwd_bwd, 1, cpu=False, top=12, chars=160)
    losses = [r["loss"] for r in tr.history]
    out = {
        "arch": cfg.name, "params": n, "active_params": active,
        "dtype": cfg.dtype, "steps": MOE_TRAIN_STEPS, "seq_len": TRAIN_SEQ,
        "global_batch": TRAIN_BATCH, "microbatches": plan.microbatches,
        "remat": plan.remat, "losses": losses,
        "grad_norms": [r["grad_norm"] for r in tr.history],
        "moe_aux": auxes, "step_ms": [x * 1e3 for x in step_s],
        "median_step_ms": med_s * 1e3, "tokens_per_s": tokens / med_s,
        # 6 x active parameters x tokens: the drop-free branch's E / k
        # padded rows are not counted
        "active_flops_per_step": flops,
        "bf16_peak_share": flops / med_s / BF16_OPS_PER_S,
        "max_memory_allocated_bytes": peak, "reckoned_state_bytes": 16 * n,
        "microbatch_fwd_bwd_profile": prof}
    print(f"  18c: {n} params ({active} active), median step "
          f"{med_s * 1e3:.1f} ms, {tokens / med_s:.0f} tokens/s, "
          f"6 x active x tokens {flops:.3e} a step "
          f"({out['bf16_peak_share']:.4f} of the bf16 dense peak; the "
          f"drop-free padding not counted), max_memory_allocated "
          f"{peak / 1e9:.2f} GB beside the reckoned state "
          f"{16 * n / 1e9:.2f} GB, one microbatch's forward and backward "
          f"{prof['window_ms_per_step']:.1f} ms profiled, "
          f"{prof['device_launches_per_step']:.0f} launches", flush=True)
    flat = [a for step in auxes for a in step]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"18c: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"18c: last loss {losses[-1]} not below the "
                             f"first {losses[0]}")
    if len(flat) != MOE_TRAIN_STEPS * n_mb or not all(
            math.isfinite(a) and a > 0 for a in flat):
        raise AssertionError(f"18c: moe_aux not finite and positive in "
                             f"every microbatch: {auxes}")
    return out


def phase_moe(dev) -> dict:
    """Phase 18: granite-moe-1b served at full width through the engine
    (18a, `phase_serving`), `moe_mlp` card against CPU (18b) and trained
    at full width (18c)."""
    import gc

    secs = {}
    t0 = time.perf_counter()
    launches, run, compare, decode = phase_serving(dev, MOE_ARCH)
    out = {"18a": dict(launches=launches, run=run, compare=compare,
                       decode=decode)}
    gc.collect()
    torch.cuda.empty_cache()
    secs["18a"] = time.perf_counter() - t0
    for name, fn in (("18b", moe_layer_card_vs_cpu),
                     ("18c", moe_train_full_width)):
        t0 = time.perf_counter()
        _zero_counts()
        out[name] = fn(dev)
        out[f"{name} launches"] = _check_counts(f"phase {name}", {})
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    out["seconds"] = secs
    print(f"phase 18 seconds: {json.dumps(secs)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 19: the rest of the model stack (whisper-medium, internvl2-2b,
# jamba-1.5-large)
# ---------------------------------------------------------------------------

ENCDEC_ARCH, VLM_ARCH, HYBRID_ARCH = ("whisper_medium", "internvl2_2b",
                                      "jamba15_large")
STACK_BATCH, STACK_PROMPT, STACK_DECODE = 4, 64, 16
# a decoded step against the full forward at its position, float32:
# tests/test_models_decode.py's tolerance (atol = rtol)
STACK_DECODE_TOL = 5e-3
STACK_DECODE_CHECK = 4     # float32 decode steps held against the forward
STACK_WINDOW = 4           # decode steps profiled (device activities only)
STACK_TRAIN_STEPS, STACK_TRAIN_BATCH = 3, 8
# whisper's real decoder context; internvl2's stream of 256 frontend rows
# and 256 text tokens
STACK_TRAIN_SEQ = {ENCDEC_ARCH: 448, VLM_ARCH: 512}
# 19d: jamba's smoke config, card against CPU (float32, TF32 off): the
# logits within this share of their largest magnitude (18b's limit on
# moe_mlp's y), the aux within MOE_CHECK_AUX_TOL, a train step's loss,
# grad norm and aux within TRAIN_CHECK_TOL (17b's)
HYBRID_LOGIT_TOL = 1e-4
HYBRID_B, HYBRID_T = 2, 32
HYBRID_REQUESTS = 4
# the launcher (`python -m repro_torch.launch.serve`) on the two new
# attention archs' smoke configs: flash_attention = decoder layers x 4
STACK_LAUNCHER_ARCHS = (ENCDEC_ARCH, VLM_ARCH)
SERVE_ROUTES[HYBRID_ARCH] = ("pallas_ssd", "ssd", None, None)


def _modality(cfg, b: int, dev, dtype, seed: int) -> dict:
    """A model's stub inputs beside its tokens, drawn on the card from a
    seed: ``frames`` (b, num_audio_frames, d) or ``frontend`` (b,
    num_frontend_tokens, d), standard normal, in `dtype`."""
    gen = torch.Generator(dev).manual_seed(seed)
    out = {}
    if cfg.is_encdec:
        out["frames"] = torch.randn((b, cfg.num_audio_frames, cfg.d_model),
                                    generator=gen, device=dev).to(dtype)
    if cfg.frontend == "vision":
        out["frontend"] = torch.randn(
            (b, cfg.num_frontend_tokens, cfg.d_model), generator=gen,
            device=dev).to(dtype)
    return out


def _stack_batch(cfg, dev, dtype, b: int, t: int, seed: int) -> dict:
    x = _modality(cfg, b, dev, dtype, seed)
    x["tokens"] = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32), device=dev)
    return x


def _stack_forward(params, cfg, batch, impl, caches=None):
    """The prefill step's computation on `batch`: `encode` of its frames,
    then `forward` with its frontend (no autograd)."""
    from repro_torch.models import transformer as T

    with torch.no_grad():
        enc = (T.encode(params, cfg, batch["frames"], impl=impl)
               if cfg.is_encdec else None)
        return T.forward(params, cfg, batch["tokens"],
                         frontend=batch.get("frontend"), enc_out=enc,
                         caches=caches, impl=impl)[0]


def stack_prefill_compare(dev, cfg, params, batch, logit_tol) -> dict:
    """`prefill_compare` for the prefill step's inputs: the batch's last
    row through impl="pallas" and impl="xla" (twice each, alternating;
    each forward, the encoder included, free of host syncs): the max
    |logit difference| over the rows, its share of their max |logit|;
    raises beyond `logit_tol`."""
    from repro_torch.models import transformer as T

    last, ms = {}, {}
    for route in ("pallas", "xla", "pallas", "xla"):
        caches = T.init_caches(cfg, batch["tokens"].shape[0],
                               batch["tokens"].shape[1]
                               + cfg.num_frontend_tokens, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = _stack_forward(params, cfg, batch, route, caches)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms[route] = (time.perf_counter() - t0) * 1e3
        last[route] = logits[:, -1, :cfg.vocab_size]
    diff = float((last["pallas"] - last["xla"]).abs().max())
    scale = float(last["xla"].abs().max())
    out = dict(model=cfg.name, dtype=cfg.dtype,
               shape=list(batch["tokens"].shape), max_abs_diff=diff,
               max_abs_logit=scale, share=diff / scale,
               tolerance=logit_tol * scale,
               same_argmax=bool((last["pallas"].argmax(-1)
                                 == last["xla"].argmax(-1)).all()),
               prefill_ms=ms)
    print(f"  prefill kernel route vs plain route: {json.dumps(out)}",
          flush=True)
    if not out["share"] <= logit_tol:
        raise AssertionError(f"kernel and plain prefill logits of "
                             f"{cfg.name} ({cfg.dtype}) differ by {diff}, "
                             f"beyond {logit_tol} x {scale}")
    return out


def stack_decode_check(dev, cfg, params) -> dict:
    """Float32 (TF32 off): `build_prefill_step` on the first
    STACK_PROMPT tokens (frontend rows and frames with them), then
    `STACK_DECODE_CHECK` `build_serve_step` steps fed the next tokens;
    each step's logits against the full forward's at its position, within
    STACK_DECODE_TOL (atol = rtol)."""
    from repro_torch.configs import runtime
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    nf = cfg.num_frontend_tokens
    b, t, k = 2, STACK_PROMPT, STACK_DECODE_CHECK
    full_batch = _stack_batch(cfg, dev, torch.float32, b, t + k, seed=19)
    batch = dict(full_batch, tokens=full_batch["tokens"][:, :t])
    plan = dataclasses.replace(runtime.plan_for(cfg, "prefill_32k",
                                                "prefill"),
                               max_len=nf + t + k)
    pre, _ = steps.build_prefill_step(cfg, plan, b, nf + t, device=dev)
    serve, _ = steps.build_serve_step(cfg, plan, b, nf + t + k, device=dev)
    caches = T.init_caches(cfg, b, nf + t + k, device=dev)
    full = _stack_forward(params, cfg, full_batch, "xla")
    _, caches = pre(params, caches, batch)
    errs = []
    for i in range(k):
        step = {"tokens": full_batch["tokens"][:, t + i:t + i + 1],
                "lengths": torch.full((b,), nf + t + i, dtype=torch.int32,
                                      device=dev)}
        _, lg, caches = serve(params, caches, step)
        want = full[:, nf + t + i]
        torch.testing.assert_close(lg, want, atol=STACK_DECODE_TOL,
                                   rtol=STACK_DECODE_TOL)
        errs.append(float((lg - want).abs().max()))
    out = dict(steps=k, max_abs_err=max(errs),
               max_abs_logit=float(full[..., :cfg.vocab_size].abs().max()),
               tolerance=STACK_DECODE_TOL)
    print(f"  decode vs full forward (float32): {json.dumps(out)}",
          flush=True)
    return out


def stack_serving(dev, arch) -> dict:
    """19a (whisper-medium) / 19b (internvl2-2b) at full width, bf16,
    seeded weights on the card: `build_prefill_step` on B 4 x
    STACK_PROMPT tokens (whisper: its 1500 stub frames encoded first;
    internvl2: 256 frontend rows before the text), then
    `build_serve_step` for STACK_DECODE steps against the self (and
    cross) caches, counts set to 0 before each and read after
    (flash_attention = the decoder's causal layers a prefill, nothing
    else; a decode step none); then the prefill route compare in bf16
    and, for the same weights in float32, the compare and the decode
    check (`stack_decode_check`)."""
    from repro_torch.configs import registry, runtime
    from repro_torch.launch import steps
    from repro_torch.models import config as mconfig
    from repro_torch.models import params as P, transformer as T

    cfg = registry.get_config(arch)
    nf = cfg.num_frontend_tokens
    b, t, k = STACK_BATCH, STACK_PROMPT, STACK_DECODE
    secs, mark = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[name], mark[0] = now - mark[0], now

    params = P.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    lap("init")
    n_params = P.count_params(params)
    want = mconfig.param_count(cfg) + _uncounted(cfg)
    if n_params != want or _shapes(params) != _shapes(P.model_defs(cfg)):
        raise AssertionError(f"{n_params} parameters, want {want} in the "
                             f"shapes of `params.model_defs`")
    weight_gb = n_params * 2 / 1e9
    max_len = nf + t + k + STACK_WINDOW   # and the profiled decode window
    plan = dataclasses.replace(runtime.plan_for(cfg, "prefill_32k",
                                                "prefill"), max_len=max_len)
    pre, (_, acaches, abatch) = steps.build_prefill_step(
        cfg, plan, b, nf + t, device=dev)
    serve, _ = steps.build_serve_step(cfg, plan, b, max_len, device=dev)
    batch = _stack_batch(cfg, dev, torch.bfloat16, b, t, seed=0)
    if {n: tuple(v.shape) for n, v in batch.items()} != {
            n: tuple(v.shape) for n, v in abatch.items()}:
        raise AssertionError(f"batch {batch} is not the step's {abatch}")
    finite = torch.ones((), dtype=torch.bool, device=dev)
    encode_ms = None
    if cfg.is_encdec:
        with torch.no_grad():
            T.encode(params, cfg, batch["frames"])      # warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = T.encode(params, cfg, batch["frames"])
            torch.cuda.synchronize()
            encode_ms = (time.perf_counter() - t0) * 1e3
        finite.logical_and_(torch.isfinite(enc).all())
        del enc
    caches = T.init_caches(cfg, b, max_len, device=dev,
                           enc_len=cfg.num_audio_frames)
    if _shapes(caches) != _shapes(acaches):
        raise AssertionError("caches are not the step's abstract caches")
    cross_bytes = sum(x.numel() * x.element_size()
                      for st in caches.values() for e in st.values()
                      if "cross" in e for x in e["cross"].values())
    pre(params, T.init_caches(cfg, b, max_len, device=dev), batch)  # warm
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pre(params, caches, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _check_counts(
        f"{arch} prefill", {"flash_attention": _kernel_layers(
            cfg, "flash_attention")})
    finite.logical_and_(torch.isfinite(logits).all())
    nxt = logits.argmax(-1).to(torch.int32)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(k):
        step = {"tokens": nxt[:, None], "lengths": torch.full(
            (b,), nf + t + i, dtype=torch.int32, device=dev)}
        nxt, lg, caches = serve(params, caches, step)
        finite.logical_and_(torch.isfinite(lg).all())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = _check_counts(f"{arch} decode", {})
    lengths = torch.full((b,), nf + t + k, dtype=torch.int32, device=dev)

    def one_step():
        nonlocal caches, lengths
        _, _, caches = serve(params, caches, {"tokens": nxt[:, None],
                                               "lengths": lengths})
        lengths = lengths + 1

    lap("prefill_decode")
    window = _profile_window(dev, one_step, STACK_WINDOW, cpu=False)
    lap("window")
    if not bool(finite):
        raise AssertionError(f"non-finite logits in the {arch} run")
    out = dict(arch=cfg.name, params=n_params, weight_gb=weight_gb,
               batch=b, prompt_tokens=t, frontend_rows=nf,
               frames=cfg.num_audio_frames if cfg.is_encdec else 0,
               encode_ms=encode_ms, prefill_step_ms=prefill_ms,
               decode_steps=k, decode_ms_per_step=decode_s / k * 1e3,
               decode_tokens_per_s=b * k / decode_s,
               prefill_launches=prefill_launches,
               decode_launches=decode_launches,
               cross_cache_bytes=cross_bytes, decode_window=window)
    print(f"  {arch}: {json.dumps(out)}", flush=True)
    out["compare"] = stack_prefill_compare(
        dev, cfg, params, _stack_batch(cfg, dev, torch.bfloat16, 1, t,
                                       seed=1), SERVE_LOGIT_TOL)
    lap("compare")
    del params, caches, logits
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = P.init_params(cfg32, torch.Generator(dev).manual_seed(0),
                        device=dev)
    out["compare_f32"] = stack_prefill_compare(
        dev, cfg32, p32, _stack_batch(cfg32, dev, torch.float32, 1, t,
                                      seed=1), SERVE_F32_LOGIT_TOL)
    out["decode_check_f32"] = stack_decode_check(dev, cfg32, p32)
    del p32
    torch.cuda.empty_cache()
    lap("float32")
    out["seconds"] = secs
    print(f"  {arch} seconds: {json.dumps(secs)}", flush=True)
    return out


def stack_train(dev, arch) -> dict:
    """19c: whisper-medium / internvl2-2b trained at full width in bf16
    through `build_train_step` under `plan_for(cfg, "train_4k",
    "train")` as it stands (its 100-step warmup: with the quickstart's
    5-step one and a new batch a step, whisper's loss went from 11.10 to
    9.31, then to 11.92 at the third step, lr 1.8e-4),
    STACK_TRAIN_STEPS steps on one batch of 8 (so that the losses differ
    by what the steps learned, not by the spread of batches): tokens and
    labels from `DataPipeline` (token skew 1.2; whisper 448 decoder
    tokens, internvl2 256 text tokens), frames (8, 1500, 1024) or
    frontend rows (8, 256, 2048) drawn on the card from a seed.  Fatal:
    a loss not finite, the last not below the first.  Model FLOPs a step:
    whisper 6 x (encoder parameters x frames + decoder parameters x
    decoder tokens), the encoder's the encoder stages' and its final
    norm's, the decoder's the rest but the two position tables (lookups;
    the cross K/V projections, which run over the frames, counted with
    the decoder); internvl2 6 x parameters x stream rows (frontend rows
    included)."""
    from repro_torch.configs import registry, runtime
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import steps
    from repro_torch.models import params as P
    from repro_torch.optim import adamw

    cfg = registry.get_config(arch)
    seq = STACK_TRAIN_SEQ[arch]
    n_text = seq - cfg.num_frontend_tokens
    b = STACK_TRAIN_BATCH
    plan = runtime.plan_for(cfg, "train_4k", "train")
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=n_text, global_batch=b,
                                       token_skew=1.2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = P.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    n = P.count_params(params)
    state = steps.TrainState(params, adamw.init(plan.opt, params),
                             torch.zeros((), dtype=torch.int32, device=dev))
    fn, _, abatch = steps.build_train_step(cfg, plan, b, seq, device=dev)
    if cfg.is_encdec:
        enc_n = P.count_params(params["enc_stages"]) + sum(
            params[k].numel() for k in params if k.startswith("enc_final"))
        pos_n = params["pos_embed"].numel() + params["enc_pos_embed"].numel()
        flops = 6 * (enc_n * b * cfg.num_audio_frames
                     + (n - enc_n - pos_n) * b * n_text)
    else:
        flops = 6 * n * b * seq
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in next(pipe).items()}
    batch.update(_modality(cfg, b, dev, torch.bfloat16, seed=100))
    if {k: tuple(v.shape) for k, v in batch.items()} != {
            k: tuple(v.shape) for k, v in abatch.items()}:
        raise AssertionError(f"batch shapes are not the step's {abatch}")
    losses, norms, step_s = [], [], []
    for i in range(STACK_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        print(f"  19c {arch} step {i + 1}: loss {losses[-1]:.4f} grad_norm "
              f"{norms[-1]:.4f} lr {float(met['lr']):.3e} "
              f"{step_s[-1] * 1e3:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    med_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = b * n_text
    out = dict(arch=cfg.name, params=n, steps=STACK_TRAIN_STEPS,
               global_batch=b, text_tokens=n_text, stream_rows=seq,
               frames=cfg.num_audio_frames if cfg.is_encdec else 0,
               microbatches=steps.num_microbatches(plan, b),
               losses=losses, grad_norms=norms,
               step_ms=[x * 1e3 for x in step_s], median_step_ms=med_s * 1e3,
               tokens_per_s=tokens / med_s,
               model_flops_per_step=flops,
               bf16_peak_share=flops / med_s / BF16_OPS_PER_S,
               max_memory_allocated_bytes=peak,
               reckoned_state_bytes=16 * n)
    print(f"  19c {arch}: {json.dumps(out)}", flush=True)
    del state, params
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"19c {arch}: a loss or grad norm is not "
                             f"finite: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"19c {arch}: last loss {losses[-1]} not "
                             f"below the first {losses[0]}")
    return out


def hybrid_card_vs_cpu(dev) -> dict:
    """19d: jamba-1.5-large at its smoke config (one block: Mamba-2 at
    0-3 and 5-7, attention at 4, MoE at the odd positions), float32 with
    TF32 off, the same seeded weights on the card and on the CPU: the
    forward of B 2 x T 32 under impl="xla", "pallas" and "pallas_ssd"
    (on the card flash_attention 1 and ssd 0, ssd 7 and flash_attention
    0, none, counted), its logits within HYBRID_LOGIT_TOL of their
    largest magnitude and the aux within MOE_CHECK_AUX_TOL, the router's
    choices compared layer by layer (a token whose expert set differs, a
    float32 near-tie, is counted); `build_prefill_step` then 4
    `build_serve_step` steps, each step's logits the same way; one
    `build_train_step` step of the jamba plan (8 microbatches, bf16
    gradient sum and moments), its loss, grad norm and the microbatches'
    mean aux within TRAIN_CHECK_TOL relative."""
    from repro_torch.configs import registry, runtime
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import steps
    from repro_torch.models import params as P, transformer as T
    from repro_torch.optim import adamw

    cfg = registry.get_smoke_config(HYBRID_ARCH)
    prm = P.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, t = HYBRID_B, HYBRID_T
    tok = torch.as_tensor(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (b, t + 4)).astype(np.int32))
    want_calls = {"xla": {}, "pallas": {"flash_attention": 1},
                  "pallas_ssd": {"ssd": 7}}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"forward": {}}
    try:
        got = {}
        for where in ("cpu", dev):
            p = P.tree_map(lambda x: x.to(where, copy=True), prm)
            x = tok.to(where)
            res = {}
            for impl in ("xla", "pallas", "pallas_ssd"):
                _zero_counts()
                with _recorded_routes() as routes, torch.no_grad():
                    lg, _, aux = T.forward(p, cfg, x[:, :t], impl=impl)
                calls = (_check_counts(f"19d forward {impl}",
                                       want_calls[impl])
                         if where != "cpu" else None)
                res[impl] = (lg.cpu(), float(aux),
                             [r["top_e"].cpu() for r in routes], calls)
            # prefill then decode through the steps
            plan = dataclasses.replace(
                runtime.plan_for(cfg, "prefill_32k", "prefill"),
                max_len=t + 4)
            pre, _ = steps.build_prefill_step(cfg, plan, b, t, device=where)
            serve, _ = steps.build_serve_step(cfg, plan, b, t + 4,
                                              device=where)
            caches = T.init_caches(cfg, b, t + 4, device=where)
            last, caches = pre(p, caches, {"tokens": x[:, :t]})
            dec = [last.cpu()]
            for i in range(4):
                _, lg, caches = serve(p, caches, {
                    "tokens": x[:, t + i:t + i + 1],
                    "lengths": torch.full((b,), t + i, dtype=torch.int32,
                                          device=where)})
                dec.append(lg.cpu())
            res["decode"] = dec
            got[str(where)] = res
        cpu, card = got["cpu"], got[str(dev)]
        for impl in ("xla", "pallas", "pallas_ssd"):
            (lc, ac, rc, _), (ld, ad, rd, calls) = cpu[impl], card[impl]
            scale = float(lc.abs().max())
            flips = [int((a.sort(-1).values != c.sort(-1).values).any(-1)
                         .sum()) for a, c in zip(rc, rd)]
            row = dict(max_abs_err=float((lc - ld).abs().max()),
                       max_abs_logit=scale, aux_cpu=ac, aux_card=ad,
                       aux_err=abs(ac - ad), moe_set_flips=flips,
                       launches=calls)
            out["forward"][impl] = row
            print(f"  19d forward {impl} card vs CPU: {json.dumps(row)}",
                  flush=True)
            if not (row["max_abs_err"] <= HYBRID_LOGIT_TOL * scale
                    and row["aux_err"] <= MOE_CHECK_AUX_TOL):
                raise AssertionError(f"19d: forward {impl} card vs CPU: "
                                     f"{row}")
        errs = [float((a - c).abs().max()) for a, c in
                zip(cpu["decode"], card["decode"])]
        scale = max(float(a.abs().max()) for a in cpu["decode"])
        out["prefill_decode"] = dict(steps=4, max_abs_err=max(errs),
                                     max_abs_logit=scale)
        print(f"  19d prefill + decode card vs CPU: "
              f"{json.dumps(out['prefill_decode'])}", flush=True)
        if not max(errs) <= HYBRID_LOGIT_TOL * scale:
            raise AssertionError(f"19d: prefill + decode card vs CPU: "
                                 f"{out['prefill_decode']}")
        # one train step of the jamba plan
        plan = _train_plan(cfg)
        batch = {k: torch.as_tensor(v) for k, v in next(DataPipeline(
            PipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE_SEQ,
                           global_batch=TRAIN_BATCH, token_skew=1.2))).items()}
        mets = {}
        for where in ("cpu", dev):
            p = P.tree_map(lambda x: x.to(where, copy=True), prm)
            state = steps.TrainState(p, adamw.init(plan.opt, p),
                                     torch.zeros((), dtype=torch.int32,
                                                 device=where))
            fn, _, _ = steps.build_train_step(cfg, plan, TRAIN_BATCH,
                                              TRAIN_SMOKE_SEQ, device=where)
            with _recorded_loss_metrics() as seen:
                _, met = fn(state, batch)
            mets[str(where)] = {k: float(v) for k, v in met.items()}
            mets[str(where)]["moe_aux"] = float(np.mean(
                [float(m["moe_aux"]) for m in seen]))
        want, card_m = mets["cpu"], mets[str(dev)]
        rel = {k: abs(card_m[k] - want[k]) / abs(want[k])
               for k in ("loss", "grad_norm", "moe_aux")}
        out["train_step"] = {"cpu": want, "card": card_m, "rel": rel,
                             "microbatches": plan.microbatches,
                             "accum_dtype": plan.accum_dtype}
        print(f"  19d train step card vs CPU: "
              f"{json.dumps(out['train_step'])}", flush=True)
        if max(rel.values()) > TRAIN_CHECK_TOL:
            raise AssertionError(f"19d: train step card vs CPU {rel} over "
                                 f"{TRAIN_CHECK_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def hybrid_engine(dev) -> dict:
    """19d, on: jamba's smoke config through the engine on the card
    (`EngineConfig()` defaults), the first HYBRID_REQUESTS of the serving
    phases' requests, counts set to 0 before and read after: ssd = its 7
    Mamba layers x prefills and flash_attention 0 (the engine prefills a
    Mamba model through the SSD kernel, attention on the plain path);
    then the launcher on whisper-medium's and internvl2-2b's smoke
    configs (4 requests each; flash_attention = decoder layers x 4)."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import params as P
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    cfg = registry.get_smoke_config(HYBRID_ARCH)
    params = P.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    eng = ServingEngine(cfg, params, EngineConfig(), device=dev)
    reqs = serve_requests(cfg)[:HYBRID_REQUESTS]
    out = {"engine": drained_run(dev, HYBRID_ARCH, cfg, eng, reqs,
                                 f"{HYBRID_ARCH} smoke serving")}
    print(f"  19d engine: {json.dumps(out['engine'])}", flush=True)
    for arch in STACK_LAUNCHER_ARCHS:
        scfg = registry.get_smoke_config(arch)
        _zero_counts()
        t0 = time.perf_counter()
        launch_serve.main(["--arch", arch, "--requests", "4"])
        torch.cuda.synchronize()
        out[f"launcher {arch}"] = dict(
            seconds=time.perf_counter() - t0,
            launches=_check_counts(f"launcher {arch}", {
                "flash_attention": _kernel_layers(scfg, "flash_attention")
                * 4}))
    return out


def phase_stack(dev) -> dict:
    """Phase 19: whisper-medium (19a) and internvl2-2b (19b) served
    through the prefill and serve steps at full width, both trained at
    full width (19c), jamba-1.5-large's smoke config card against CPU
    and through the engine (19d)."""
    import gc

    secs, out = {}, {}
    for name, fn in (("19a", lambda: stack_serving(dev, ENCDEC_ARCH)),
                     ("19b", lambda: stack_serving(dev, VLM_ARCH)),
                     ("19c", lambda: {a: stack_train(dev, a)
                                      for a in STACK_TRAIN_SEQ}),
                     ("19d", lambda: dict(hybrid_card_vs_cpu(dev),
                                          **hybrid_engine(dev)))):
        t0 = time.perf_counter()
        out[name] = fn()
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    _zero_counts()
    out["seconds"] = secs
    print(f"phase 19 seconds: {json.dumps(secs)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The dry run against the card (phase 20)
# ---------------------------------------------------------------------------

# the two decode cells of the dry-run table that fit one 80 GB card
DRY_ARCHS = ("gemma3_1b", "mamba2_13b")
DRY_DECODE = "decode_32k"
DRY_WARMUP, DRY_STEPS = 2, 5
# |max_memory_allocated - the dry run's peak| over the dry run's peak.
# The dry run counts every storage the step's ops allocate; the caching
# allocator adds its rounding (512-byte blocks, a remainder under 1 MB
# left unsplit) and cuBLAS's workspace, and the ops' own scratch, which
# no op-level count sees: tens of MB against the reckoned 41.7 and 55.3
# GB peaks.  A step that kept one more copy of a global layer's float32
# K (reckoned 17.2 GB for gemma3_1b) would read 31% off.
DRY_MEM_TOL = 0.05
DRY_IDEAL_SLACK = 1.05   # ideal_s over the median step: over it, a bad count
# 20c: prefills through the kernel route, B 4 x T 1024, and the kernel
# each makes once a layer
DRY_PREFILL = (4, 1024)
DRY_PREFILL_KERNELS = {"gemma3_1b": ("flash_attention", 26),
                       "mamba2_13b": ("ssd", 48)}


def _same_count(what: str, card, meta) -> None:
    """The card's op count must equal the meta count: flops, bytes and
    launches, total and by op."""
    got = (card.flops, card.bytes, card.launches)
    want = (meta["flops"], meta["bytes"], meta["launches"])
    if got != want or card.by_op != meta["by_op"]:
        diff = {k: (card.by_op.get(k), meta["by_op"].get(k))
                for k in set(card.by_op) | set(meta["by_op"])
                if card.by_op.get(k) != meta["by_op"].get(k)}
        raise AssertionError(f"20 {what}: the card counts (flops, bytes, "
                             f"launches) {got}, meta {want}; by op "
                             f"(card, meta): {diff}")


def _event_ms(fn) -> float:
    """ms of one call by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def dry_decode_card(dev, arch, dry: dict) -> dict:
    """20b: one decode cell of the dry run for real: random bf16
    parameters from a seed, zero caches, ``lengths`` 32767 (every row
    reads its whole cache), DRY_WARMUP + DRY_STEPS serve steps, each
    under its own `OpCounter`, the last DRY_STEPS timed by CUDA events.
    Fatal: a step's flops, bytes or launches off the meta count,
    `max_memory_allocated` (its peak reset before the parameters are
    allocated) off the dry run's peak by more than DRY_MEM_TOL, the
    roofline's ideal time over DRY_IDEAL_SLACK x the median step."""
    from repro_torch.configs import registry, runtime
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import params as P, transformer as T
    from repro_torch.utils import hlo

    cfg = registry.get_config(arch)
    shape = SHAPES[DRY_DECODE]
    b, t = shape.global_batch, shape.seq_len
    plan = runtime.plan_for(cfg, shape.name, shape.kind)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = P.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    caches = T.init_caches(cfg, b, t, device=dev,
                           enc_len=cfg.num_audio_frames)
    gen = torch.Generator(dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, 1),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             "lengths": torch.full((b,), t - 1, dtype=torch.int32,
                                   device=dev)}
    fn, _ = steps.build_serve_step(cfg, plan, b, t, device=dev)
    step_ms, finite = [], True
    for i in range(DRY_WARMUP + DRY_STEPS):
        with hlo.OpCounter() as counter:
            holder = {}
            ms = _event_ms(lambda: holder.update(
                out=fn(params, caches, batch)))
        _same_count(f"{arch} decode step {i}", counter.report(), dry["ops"])
        finite = finite and bool(torch.isfinite(holder["out"][1]).all())
        del holder
        if i >= DRY_WARMUP:
            step_ms.append(ms)
    peak = torch.cuda.max_memory_allocated() - base
    want = dry["memory"]["peak_bytes_per_device"]
    window = _profile_window(
        dev, lambda: fn(params, caches, batch), 1, cpu=False) \
        if arch == DRY_ARCHS[0] else None
    del params, caches
    torch.cuda.empty_cache()
    med = sorted(step_ms)[len(step_ms) // 2]
    roof = dry["roofline"]
    out = dict(arch=cfg.name, shape=DRY_DECODE, batch=b, cache_len=t,
               step_ms=step_ms, median_step_ms=med,
               ideal_ms=roof["ideal_s"] * 1e3,
               bound_ms=roof["bound_s"] * 1e3, dominant=roof["dominant"],
               ideal_share=roof["ideal_s"] * 1e3 / med,
               bound_share=roof["bound_s"] * 1e3 / med,
               max_memory_allocated_bytes=peak, dry_peak_bytes=want,
               memory_off=abs(peak - want) / want,
               analyzer_launches=dry["ops"]["launches"],
               profiler=window)
    print(f"  20b {arch}: {json.dumps(out)}", flush=True)
    if not finite:
        raise AssertionError(f"20b {arch}: logits not finite")
    if out["memory_off"] > DRY_MEM_TOL:
        raise AssertionError(f"20b {arch}: max_memory_allocated {peak} "
                             f"off the dry run's peak {want} by "
                             f"{out['memory_off']:.4f} > {DRY_MEM_TOL}")
    if roof["ideal_s"] * 1e3 > DRY_IDEAL_SLACK * med:
        raise AssertionError(f"20b {arch}: ideal {roof['ideal_s'] * 1e3} ms "
                             f"over {DRY_IDEAL_SLACK} x the median step "
                             f"{med} ms: a wrong count")
    return out


def dry_prefill_card(dev, arch) -> dict:
    """20c: a prefill step of B x T = DRY_PREFILL through the kernel
    route, counted on ``meta`` (the kernel wrapper's meta branch) and run
    on the card under an `OpCounter`: flops, bytes and launches equal,
    total and by op, and the kernel's launches equal to the `LAUNCHES`
    delta and to DRY_PREFILL_KERNELS (one a layer)."""
    from repro_torch.configs import registry, runtime
    from repro_torch.configs.shapes import RunShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import params as P, transformer as T
    from repro_torch.utils import hlo

    cfg = registry.get_config(arch)
    b, t = DRY_PREFILL
    shape = RunShape(f"prefill_{b}x{t}", "prefill", t, b)
    dry = dryrun.run_shape(cfg, shape)
    plan = runtime.plan_for(cfg, "prefill_32k", "prefill")
    params = P.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    caches = T.init_caches(cfg, b, t, device=dev,
                           enc_len=cfg.num_audio_frames)
    tokens = torch.randint(0, cfg.vocab_size, (b, t), device=dev,
                           generator=torch.Generator(dev).manual_seed(2),
                           dtype=torch.int32)
    fn, _ = steps.build_prefill_step(cfg, plan, b, t, device=dev)
    kernel, per_prefill = DRY_PREFILL_KERNELS[arch]
    _zero_counts()
    with hlo.OpCounter() as counter:
        logits, _ = fn(params, caches, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = _check_counts(f"20c {arch} prefill", {kernel: per_prefill})
    rep = counter.report()
    finite = bool(torch.isfinite(logits).all())
    del params, caches, logits
    torch.cuda.empty_cache()
    _same_count(f"{arch} prefill", rep, dry["ops"])
    meta_k = dry["ops"]["by_op"].get(kernel, {}).get("launches")
    out = dict(arch=cfg.name, batch=b, seq_len=t, kernel=kernel,
               launches=launches[kernel], counted_launches=meta_k,
               flops=rep.flops, bytes=rep.bytes, ops=rep.launches,
               kernel_flops=rep.by_op[kernel]["flops"],
               kernel_bytes=rep.by_op[kernel]["bytes"])
    print(f"  20c {arch}: {json.dumps(out)}", flush=True)
    if meta_k != launches[kernel]:
        raise AssertionError(f"20c {arch}: meta counts {meta_k} {kernel} "
                             f"launches, the card made {launches[kernel]}")
    if not finite:
        raise AssertionError(f"20c {arch}: prefill logits not finite")
    return out


def phase_dryrun(dev) -> dict:
    """Phase 20: the dry run (`launch.dryrun`) against the card: 20a the
    two decode cells on ``meta``, 20b each run for real, 20c prefills
    through the kernel route counted on ``meta`` and on the card."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun

    secs, out = {}, {"20a": {}, "20b": {}, "20c": {}}
    t0 = time.perf_counter()
    for arch in DRY_ARCHS:
        r = dryrun.run_shape(registry.get_config(arch), SHAPES[DRY_DECODE])
        out["20a"][arch] = {"arch": arch, "shape": DRY_DECODE,
                            "mesh": dryrun.MESH, **r}
        print("  20a " + dryrun.fmt_row(out["20a"][arch]), flush=True)
    secs["20a"] = time.perf_counter() - t0
    for name, fn in (("20b", lambda a: dry_decode_card(dev, a,
                                                       out["20a"][a])),
                     ("20c", lambda a: dry_prefill_card(dev, a))):
        t0 = time.perf_counter()
        for arch in DRY_ARCHS:
            out[name][arch] = fn(arch)
            gc.collect()
        secs[name] = time.perf_counter() - t0
    _zero_counts()
    for row in out["20a"].values():
        row["ops"].pop("by_op")
    out["seconds"] = secs
    print(f"phase 20 seconds: {json.dumps(secs)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 21: the examples (repro_torch.examples) on the card
# ---------------------------------------------------------------------------

DRV_QUICK = (200, 50, 12)     # quickstart: horizon, warmup, --fast's steps
DRV_FIG_HORIZON = (100, 25)   # figures 1 and 3/4 at a cut depth
DRV_FIG_ROWS = 20 + 28        # fig1: 5 algos x 4 loads; fig3/4: 3 x 2 x 4 + 2 x 2
DRV_FIG_CLAIMS = ("fig1_pandas_beats_jsq_mw",
                  "fig3_4_pandas_dominates_jsq_mw",
                  "fig3_4_pandas_narrower_band")
DRV_SERVE = (4 * 24, 6)       # serve_cluster: prefills, new tokens
DRV_REPLAY = 12               # replay_trace(fast=True): requests


def examples_quickstart(dev) -> dict:
    """21a: the quickstart's three layers through `quickstart.run`."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ref, wwl_route

    layer_s = {}

    def timed(name):
        fn = getattr(quickstart, name)

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            layer_s[name] = time.perf_counter() - t0
            return res
        return mock.patch.object(quickstart, name, run)

    _zero_counts()
    with timed("queueing"), timed("routing"), timed("training"):
        out = quickstart.run(*DRV_QUICK, device=dev)
    launches = _check_counts("quickstart example", {"wwl_route": 1})
    path = wwl_route.last_path()
    if path != "group":
        raise AssertionError(f"quickstart example's wwl_route took the "
                             f"{path} path on a sorted rack map")
    args = [torch.as_tensor(x, device=dev) for x in quickstart.route_inputs()]
    bad, err = _compare([torch.as_tensor(x, device=dev)
                         for x in out["route"]], ref.wwl_route(*args))
    if bad:
        raise AssertionError(f"quickstart example's wwl_route: {bad} "
                             f"mismatches")
    delays = {a: [float(x) for x in d] for a, d in out["delays"].items()}
    if not np.isfinite(list(delays.values())).all():
        raise AssertionError(f"quickstart example's delays: {delays}")
    hist = out["history"]
    drop = hist[0]["loss"] - hist[-1]["loss"]
    if not drop >= 0.2:
        raise AssertionError(f"quickstart example's loss fell {drop}")
    return dict(launches=launches, mismatches=bad, max_abs_err=err,
                delays=delays, loss_drop=drop,
                losses=[h["loss"] for h in hist], layer_s=layer_s)


def examples_figures(dev) -> dict:
    """21b: figures 1 and 3/4 at a cut depth, their CSV and claims."""
    import csv
    import tempfile

    from repro_torch.core import robustness as rb, simulator as sim
    from repro_torch.examples import figures, robustness_study

    horizon, warmup = DRV_FIG_HORIZON
    cfg = rb.StudyConfig(
        sim=sim.default_config(horizon=horizon, warmup=warmup),
        loads=(0.6, 0.8, 0.9, 0.95), high_loads=(0.9, 0.95),
        eps_grid=(0.1, 0.2, 0.3), seeds=(0,))
    _zero_counts()
    rows = (figures.fig1_precise(cfg=cfg, device=dev)
            + figures.fig34_under(cfg=cfg, device=dev))
    launches = _check_counts("figures", {})
    with tempfile.TemporaryDirectory() as tmp:
        with open(robustness_study.write_csv(rows, tmp), newline="") as f:
            written = list(csv.DictReader(f))
    if len(rows) != DRV_FIG_ROWS or len(written) != DRV_FIG_ROWS:
        raise AssertionError(f"figures: {len(rows)} rows, {len(written)} "
                             f"in the CSV, want {DRV_FIG_ROWS}")
    if not np.isfinite([r["mean_delay"] for r in rows]).all():
        raise AssertionError("figures: a delay is not finite")
    claims = figures.headline_claims(rows)
    print(f"figures' headline claims: {json.dumps(claims)}", flush=True)
    missing = [k for k in DRV_FIG_CLAIMS if k not in claims]
    if missing:
        raise AssertionError(f"figures' claims lack {missing}")
    return dict(launches=launches, rows=len(rows), claims=claims)


def examples_serving(dev, name: str) -> dict:
    """21c (`serve_cluster`) and 21d (`replay`): the engine's prefills
    counted, each logits tensor checked finite, flash_attention = layers
    x prefills."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.examples import replay, serve_cluster, trace_replay

    cfg = registry.get_smoke_config(SERVE_ARCH)
    impl, kernel = SERVE_ROUTES[SERVE_ARCH][:2]
    out = {}
    _zero_counts()
    with _prefills(dev, impl) as seen, \
            tempfile.TemporaryDirectory() as tmp:
        if name == "serve_cluster":
            results = serve_cluster.main([], device=dev)
            want, new = DRV_SERVE
            short = [(s, r.rid) for s, (_, reqs) in results.items()
                     for r in reqs
                     if r.finish_time <= 0 or len(r.generated) != new + 1]
            if short:
                raise AssertionError(f"serve_cluster: {short} not drained "
                                     f"with {new + 1} tokens")
            out["steps"] = {s: eng.steps for s, (eng, _) in results.items()}
        else:
            export = os.path.join(tmp, "rerecorded.jsonl")
            rows = replay.replay_trace(fast=True, export_path=export,
                                       device=dev)
            rerec, _ = trace_replay.check_round_trip(export, 64)
            want = DRV_REPLAY
            if int(rerec.arrivals.sum()) != want:
                raise AssertionError(f"replay export holds "
                                     f"{rerec.arrivals.sum()} arrivals")
            out["steps"] = rows[0][1]
        torch.cuda.synchronize()
    if seen["prefills"] != want:
        raise AssertionError(f"{name}: {seen['prefills']} prefills, want "
                             f"{want}")
    if not bool(seen["finite"]):
        raise AssertionError(f"{name}: non-finite logits")
    out["launches"] = _check_counts(
        name, {kernel: _kernel_layers(cfg, kernel) * seen["prefills"]})
    out["prefills"] = seen["prefills"]
    return out


def phase_examples(dev) -> dict:
    """Phase 21: the examples on the card, 21a-21d."""
    secs, out = {}, {}
    for sub, fn in (("21a", examples_quickstart), ("21b", examples_figures),
                    ("21c", lambda d: examples_serving(d, "serve_cluster")),
                    ("21d", lambda d: examples_serving(d, "replay"))):
        t0 = time.perf_counter()
        out[sub] = fn(dev)
        secs[sub] = time.perf_counter() - t0
        print(f"  {sub}: {json.dumps(out[sub])}", flush=True)
    _zero_counts()
    out["seconds"] = secs
    print(f"phase 21 seconds: {json.dumps(secs)}", flush=True)
    return out


# the keys of a float32 row in the kernels line
F32_ROW_KEYS = ("shape", "route", "max_abs_err", "ms", "device_ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_share", "prev_ms", "prev_device_ms",
                "prev_max_abs_err")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prev", default=None, help=(
        "a directory holding the parent tree's kernel sources (csrc/): "
        "its fleet_route, wwl_route and maxweight kernels are built and "
        "timed beside this tree's"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import _build

    print(_device_line(), flush=True)  # "name, power limit" as nvidia-smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    prev = load_prev(args.prev)
    prev_route = prev["fleet_route"] if prev else None
    seconds, mark = {}, [time.perf_counter()]

    def done(phase):   # seconds of command since the last phase ended
        now = time.perf_counter()
        seconds[phase], mark[0] = now - mark[0], now

    rows = phase_kernels(dev, prev_route)
    batched_rows = phase_batched_route(dev, prev_route)
    sched_rows = phase_sched_kernels(dev, prev)
    done("3")
    launches, _, (cfg, lam, est_t) = phase_slice(dev)
    done("4")
    profile = phase_profile(dev, cfg, [(1, lam)], est_t, prev_fn=prev_route)
    done("5")
    study_rows = phase_fleet_study(dev, cfg, profile["slots_per_s_steady"])
    done("5b")
    phase_study(dev)
    done("6")
    bench_launches, bench_rows = phase_bench(dev, prev)
    done("7")
    phase_dense_loop(dev, fleet_cfg=cfg)
    done("8")
    phase_drift(dev)
    done("12a")
    phase_placement(dev)
    done("13a")
    phase_replication(dev)
    done("14a")
    phase_tail(dev)
    done("15a")
    phase_control(dev)
    done("16a")
    place_kernels = phase_placement_kernels(dev)
    done("13c")
    repl_kernels = phase_replication_kernels(dev)
    done("14c")
    attn_rows, attn_err, attn_build, attn_f32, probe, attn_d16 = \
        phase_attention(dev, prev and prev["flash_attention"])
    done("3b")
    serve_launches, serve_run, _, _ = phase_serving(dev)
    torch.cuda.empty_cache()
    done("9+12b")
    ssd_rows, ssd_err, ssd_build, ssd_f32 = phase_ssd(
        dev, prev and prev["ssd"])
    done("3c")
    mamba_launches, _, _, _ = phase_serving(dev, MAMBA_ARCH)
    torch.cuda.empty_cache()
    done("11")
    _, launcher_rows = phase_launcher(dev)
    done("10")
    train = phase_train(dev)
    done("17")
    moe = phase_moe(dev)
    done("18")
    stack = phase_stack(dev)
    done("19")
    dry = phase_dryrun(dev)
    done("20")
    examples = phase_examples(dev)
    done("21")
    for name, secs in (list(train["seconds"].items())
                       + list(moe["seconds"].items())
                       + list(stack["seconds"].items())
                       + list(dry["seconds"].items())
                       + list(examples["seconds"].items())):
        seconds[f"{name} (within {name[:2]})"] = secs
    seconds["13b (within 9+12b)"] = serve_run["placement_s"]
    seconds["14b (within 9+12b)"] = serve_run["replication_s"]
    seconds["15b (within 9+12b)"] = serve_run["traced_s"]
    seconds["16b (within 9+12b)"] = serve_run["control_s"]
    print(f"phase seconds (build excluded): {json.dumps(seconds)}",
          flush=True)

    main_row = rows["D=1"]  # the slice's Topology(10008, 6)
    timed = ("ms", "device_ms", "prev_ms", "prev_device_ms", "bound_ms")
    entries = [{
        "name": "fleet_route", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_route.cu",
        "replaces": "src/repro/kernels/slot_step.py:46",
        "launches": launches["fleet_route"],
        "mismatches": (sum(r["mismatches"] for r in rows.values())
                       + sum(r["mismatches"] + r["single_cell_mismatches"]
                             for r in batched_rows.values())),
        "max_abs_err": max(r["max_abs_err"] for r in
                           list(rows.values()) + list(batched_rows.values())),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "device_ms": main_row["device_ms"],
        "prev_ms": main_row["prev_ms"],
        "prev_device_ms": main_row["prev_device_ms"],
        "topologies": {n: {k: r[k] for k in timed} for n, r in rows.items()},
        "batched": {n: {k: r.get(k) for k in (
            "ms", "device_ms", "one_cell_device_ms", "device_ms_over_n_cells",
            "plain_ms", "bound_ms", "bound_by", "prev_device_ms")}
            for n, r in batched_rows.items()},
        "study_launches": {a: study_rows[a]["launches"]
                           for a in FLEET_STUDY_ALGOS}}]
    for name, source, replaces in (
            ("wwl_route", "src/repro_torch/kernels/csrc/wwl_route.cu",
             "src/repro/kernels/wwl_route.py:41"),
            ("maxweight_claim", "src/repro_torch/kernels/csrc/maxweight.cu",
             "src/repro/kernels/maxweight.py:24")):
        fleet_rows = {t: r for (n, t), r in sched_rows.items() if n == name}
        bench = bench_rows[name]  # the bench path's full width
        quick = examples["21a"]
        extra = ((quick["mismatches"], quick["max_abs_err"])
                 if name == "wwl_route" else (0, 0.0))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": quick["launches"][name] + bench_launches[name],
            "mismatches": (sum(r["mismatches"] for r in fleet_rows.values())
                           + bench["mismatches"] + extra[0]),
            "max_abs_err": max([r["max_abs_err"]
                                for r in fleet_rows.values()]
                               + [bench["max_abs_err"], extra[1]]),
            "ms": bench["ms"], "plain_ms": bench["plain_ms"],
            "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
            "library_ms": None, "device_ms": bench["device_ms"],
            "placement_mismatches": place_kernels["mismatches"][name],
            "replication_mismatches": repl_kernels["mismatches"][name],
            "device_ms_by_kernel": bench["device_ms_by_kernel"],
            "kernels_a_call": bench["kernels_a_call"],
            "prev_ms": bench["prev_ms"],
            "prev_device_ms": bench["prev_device_ms"],
            "example_launches": quick["launches"][name],
            "topologies": {t: {k: r[k] for k in timed + ("paths",)}
                           for t, r in fleet_rows.items()}})
    main_attn = attn_rows[max((k for k in attn_rows
                               if k.startswith("prefill_")),
                              key=lambda k: attn_rows[k]["shape"][3])]
    entries.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": serve_launches["flash_attention"],
        "scenario_launches": serve_run["scenario"]["launches"][
            "flash_attention"],
        "placement_launches": {
            label: run["launches"]["flash_attention"]
            for label, run in serve_run["placement"].items()},
        "replication_launches": serve_run["replication"]["launches"][
            "flash_attention"],
        "traced_launches": serve_run["traced"]["launches"][
            "flash_attention"],
        "max_abs_err": attn_err,
        "ms": main_attn["ms"], "plain_ms": main_attn["plain_ms"],
        "bound_ms": main_attn["bound_ms"], "bound_by": main_attn["bound_by"],
        "library_ms": main_attn["library_ms"],
        "device_ms": main_attn["device_ms"],
        "long": {k: attn_rows["long"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "f32": {n: {k: r.get(k) for k in F32_ROW_KEYS}
                for n, r in attn_f32.items()},
        "tf32_probe": probe,
        "launcher": launcher_rows["flash_attention"],
        "launcher_moe": {arch: launcher_rows[f"flash_attention {arch}"]
                         for arch in (MOE_ARCH, MOE_SMOKE_ARCH)},
        "moe_launches": moe["18a"]["launches"]["flash_attention"],
        "stack_prefill_launches": {
            stack[n]["arch"]: stack[n]["prefill_launches"]["flash_attention"]
            for n in ("19a", "19b")},
        "stack_prefill": {n: {k: r[k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for n, r in attn_rows.items() if n.startswith("stack_")},
        "hybrid_launches": stack["19d"]["forward"]["pallas"]["launches"][
            "flash_attention"],
        "example_launches": {n: examples[sub]["launches"]["flash_attention"]
                            for sub, n in (("21c", "serve_cluster"),
                                           ("21d", "replay"))},
        "moe_prefill": {n: {k: r[k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for n, r in attn_rows.items() if n.startswith("moe_prefill_")},
        "d16": attn_d16,
        "dry_run_prefill": dry["20c"]["gemma3_1b"],
        "hgmma": {n: r["hgmma"] for n, r in attn_build.items()}})
    main_ssd = ssd_rows[max((k for k in ssd_rows if k != "long"),
                            key=lambda k: ssd_rows[k]["shape"][1])]
    entries.append({
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:29",
        "launches": mamba_launches["ssd"],
        "max_abs_err": ssd_err,
        "ms": main_ssd["ms"], "plain_ms": main_ssd["plain_ms"],
        "bound_ms": main_ssd["bound_ms"], "bound_by": main_ssd["bound_by"],
        "library_ms": None, "device_ms": main_ssd["device_ms"],
        "recurrent_ms": main_ssd["recurrent_ms"],
        "recurrent_device_ms": main_ssd["recurrent_device_ms"],
        "long": {k: ssd_rows["long"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "recurrent_ms",
            "recurrent_device_ms")},
        "buckets": {n: {k: r[k] for k in ("ms", "device_ms", "recurrent_ms",
                                          "recurrent_device_ms")}
                    for n, r in ssd_rows.items()},
        "f32": {n: {k: r.get(k) for k in F32_ROW_KEYS
                    + ("recurrent_ms", "recurrent_device_ms")}
                for n, r in ssd_f32.items()},
        "launcher": launcher_rows["ssd"],
        "hybrid_launches": {
            "forward": stack["19d"]["forward"]["pallas_ssd"]["launches"][
                "ssd"],
            "engine": stack["19d"]["engine"]["launches"]["ssd"]},
        "dry_run_prefill": dry["20c"]["mamba2_13b"],
        "ptxas": {n: {k: r.get(k) for k in ("registers", "spill_stores",
                                            "hgmma")}
                  for n, r in ssd_build.items()}})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
