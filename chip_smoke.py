#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``hpc_patterns_tpu_torch``) on
one NVIDIA card — the quickest proof that the port still starts there.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. build    — compile every kernel source under
              ``hpc_patterns_tpu_torch/csrc/`` with nvcc for sm_90a into
              ``build/`` (all sources in parallel) and load them, printing
              each one's ptxas registers and spills; for kernel 1's, the
              backward's (kernels 2-4) and the fused MLP's libraries
              count the HGMMA, UTMALDG, UTMASTG and LDGSTS instructions
              (``cuobjdump -sass``), print each kernel's registers and
              spills, and fail if a library holds no HGMMA (they must run
              on wgmma), if the fused MLP's holds cp.async (LDGSTS), if
              any kernel of the fused MLP's, the backward's (kernels 2-4),
              the linear, paged or exact-softmax decode's (kernels 5, 6
              and 7), the allreduce's or all-gather matmul's (kernels 11
              and 12), the migration exchange's (kernel 13) or the overlap
              pipeline's (kernel 14; the registers and spills of the
              sources without wgmma are printed too) spills, or if
              ptxas serialized the
              wgmma of any kernel of the three (its note C7513);
2. kernel   — each kernel's wrapper on card tensors at its path's shapes,
              held against its plain PyTorch version on the same inputs
              (stated tolerance; the busy-wait and pipeline kernels
              bitwise, every pipeline mode with its written array and
              its grid plan, each timed mode beside its bound), with
              the kernel's, the plain version's and, where one exists,
              one library call's device time (yardstick only; the port
              never calls it) beside the kernel's bound; the decode
              kernels on bf16, int8 and fp8 caches (the linear cache,
              the paged cache, the exact-softmax paged route; each twice
              for equal bits, with SDPA's time and the bound on each
              dtype's values, the three split kernels with the chunks
              they split the rows into, the linear one at two shapes it
              must run in one
              chunk: pos 63, and B 33 on 132 SMs); kernel 11, the
              allreduce, bitwise with its launch plan and its FIFO within
              the L2 budget; kernel 12, the all-gather matmul, within its
              stated
              bound (a TF32 product as the control that must fail it),
              twice for equal bits, with its launch plan (tile, CTAs a
              rank, waves); kernel 13,
              the migration exchange, byte for byte (uint8 views) against
              its plain version on the plane row's bf16 K/V pages (8 kv
              heads, page 256, D 128) at 1, 2, 5 (a ragged last chunk)
              and 16 pages, int8 pages with their f32 scale pools and fp8
              pages, an oversized slab refused with MigrationDmaError
              before any launch, and timed at one bundle array (2 pages,
              1 MiB) beside ``landing.copy_(x)``;
3. serve    — the serving benchmark's chip model at full width (vocab
             32768, d_model 1024, 8 heads of 128, 8 layers, d_ff 4096,
             bf16, page 256, 8 slots, chunk 16, prompts up to 512,
             budgets up to 512; random weights from a seeded
             ``torch.Generator``) through ``ContinuousBatcher``: launch
             counts read around the run, every sequence held against the
             standalone ``paged_generate`` with a tie-aware oracle, and
             two sequences against the all-plain route;
3a. sample  — sampled serving at the serve phase's model and the first
              8 requests of its stream:
              ``serve_app --temperature 0.8 --top-k 50`` in-process
              (SUCCESS: each sequence on its standalone ``paged_generate``
              with the request's key, tie-aware on the perturbed scores),
              the measured run's kernel 1 and 6 launches equal to n_layers
              x its flash admissions and decode steps, its tokens/s beside
              the serve phase's; 8 rows sampled in one batch against each
              alone;
3b. scenario — ``bench_serving.run_scenario`` at the chip widths: (a) the
              staged chaos schedule (page 16, 3 slots, pool 25, two seeded
              stalls, arrivals on the engine's progress clock) whose pool
              forces a preemption (>= 1 asserted), (b) the bursty stream
              (page 256, 8 slots, the first 4 of its 32 requests at 16
              rps, pool 2.5 rows, high-water 0.95, a stall every 12
              rounds): every served
              sequence, resumed ones included, on its standalone; the
              timed run's kernel 1 and 6 launches against its counted
              calls; tokens/s, goodput, preemptions, sheds, the
              attribution shares, the budget breaches and the static
              baseline printed; each part's request trace and breach
              records logged for phase fit;
3c. fit     — the observability-and-control layer: (a) ``serve_app
              --explain --explain-out`` at the serve phase's model and
              stream (4 requests) logs a run (SUCCESS, the attribution
              table and digest), ``python -m
              hpc_patterns_tpu_torch.harness.autofit run.jsonl --emit``
              fits a config from it (a ladder section, fitted E[pad] <=
              the default's), ``serve_app --autofit`` replays it (SUCCESS,
              the fitted ladder printed, every sequence on its
              standalone); kernel 1 and 6 launches of both measured runs
              against their counted calls; (b) ``bench_serving.run_fitted``
              at ``fit_full_config`` (prompts 128/320/512 at 0.2/0.6/0.2,
              page 256, 8 slots, 16 of its 32 requests, budgets to 256,
              timed once): the strict
              padding win and both legs on their standalone, the goodputs
              and ``autofit_gain_frac`` printed, not asserted, every engine
              run's launches counted, then its blame A/B (the
              ``--slo-budget`` chassis, a tiny gather model: the fitter
              blames ``prefetch_wait`` and the fitted residency shrinks
              it; both stall legs on their standalone, the ``blame_*``
              keys printed); the explain CLI and the budget
              evaluation over phase scenario's two request traces (the
              breaches equal to the row's and to the logged records); (c)
              two concurrent processes of ``allreduce_app --algorithm
              fused --trace`` (world 4, 2^20 f32 a rank; ``HPCPAT_PROCESS_ID``
              0/1, ``HPCPAT_NUM_PROCESSES`` 2, one ``HPCPAT_TRACE_DIR``),
              each printing its kernel 11 launches, merged by ``python -m
              hpc_patterns_tpu_torch.harness.collect DIR -o merged.json
              --rollup-out rollup.json``: 2 pid lanes, matched collectives
              whose flow events pair up, schedule ``consistent``, the
              report's trace_merged line; (d) two ``hpc_patterns_tpu_torch.
              bench --gate DIR`` rounds (0.05 s a pass): the gate's table
              and exit code printed (0 or 1 asserted, the gated keys
              named), then a copy of the newest round with its value
              halved must exit 1. The bench rounds also launch kernels 11,
              12 and 14; the table does not count them;
3e. tiered  — tiered memory (``memory/``): (a) ``bench_serving.
              run_offload`` at ``offload_full_config`` (the serve model,
              the first 4 of its 24 requests, 8 slots, chunk 16, page 256, prompts to 256,
              budgets to 512; the pool 9 of the 24-page working set, host
              48, cold-after-3) under the flight recorder: tiered ==
              all-HBM == standalone (tie-aware), paging forced, every
              host-tier tensor pinned, kernel 1 and 6 launches of every
              engine run against its calls, the ``mem.prefetch`` /
              ``mem.evict`` windows' device time and rate; (b)
              ``run_shared`` at ``shared_full_config`` (8 of its 48
              requests, 3 templates of 512, tails 16/32/64, budgets 64/128, gather):
              both engines on the standalone, skip > 0.3, hits > 0; one
              more sharing leg of the stream's first 8 requests on
              ``flash`` at rungs off the
              multiples of 128 (kernel 6 reads shared pages; launches ==
              n_layers x decode steps, none of kernel 1) on the flash
              standalone; the tail prefill's largest |difference| from a
              monolithic prefill at one template on each ladder's first
              rung; (c) ``run_slo_budget`` (breaches exactly
              ``prefetch_wait``) beside phase fit's blame A/B; (d)
              ``train_app`` at phase train's model, 8 steps, resident then
              ``--offload-opt``: equal losses and final params bit for
              bit, every moment leaf pinned between steps, kernels 1, 3
              and 4 launched n_layers x grad passes, each step time and
              the streamed pull's overlap; (e) ``allreduce_app
              --algorithm fused`` at p 16, 20, 24, ``-D`` then ``-H``
              (pinned operand and result, the copies on the stream around
              kernel 11): the results bit-equal, each time printed;
3d. spec    — speculative decoding at the card widths: (a) the aligned
              pair (``make_draft_pair`` at its card widths: vocab 32768,
              d_model 1024, 8 heads with 2 KV heads, d_ff 4096, bf16,
              rope; 8 target and 2 draft layers; 200 / 200 steps), which
              must beat a random draft's greedy agreement and E[min(p,
              q)] by > 0.05 each; (b) ``serve_app --draft-pair --gamma
              4`` at the serve phase's geometry and its stream's first 4
              requests (SUCCESS), then the engine on 4 prompts of the
              pair's own Markov process:
              greedy (each row on the target's standalone), sampled at T
              0.8, top-k 50 (each row on ``speculative_generate_batched``
              with the request's key; tie-aware on each decision's
              margin, replayed over teacher-forced logits, at a fixed
              0.05 / T) and the plain engine on the same stream, with
              tokens/s, tokens a row a round and the acceptance a /
              gamma; (c) 4 requests on int8 pools against the target's
              own int8 standalone; (d) ``bench_speculative --pair --n
              8`` at gamma 2, 4, 8, greedy and sampled, and
              ``--batched 8`` at 8 tokens a call.
              Every engine run's kernel 1 launches == (8 + 2) x its flash
              admissions, kernel 6's (6q's on int8) == 2 x (gamma + 1) x
              its rounds;
4. overlap  — the port bench's protocol (``hpc_patterns_tpu_torch.bench``)
              at the JAX bench shape 16 x 2048 x 128 (16 MiB, L2-resident)
              and at 16 x 32768 x 128 (256 MiB, past the 50 MB L2), with
              each per-pass measurement cut to ~0.1 s: every time > 0,
              the sycl-rule verdict printed, not asserted; then, at each
              shape, the kernel in every mode the bench drove, at the
              probe and the balanced tripcounts, bitwise against its
              plain version;
5. dispatch — ``concurrency_app`` in-process: the dispatch engine (each
              command on its own CUDA stream, pinned host buffers) for
              async C M2D, async C D2M, async M2D D2M, threads C M2D, and
              the on-card engine for its four pairs; the busy-wait
              launches equal the compute submits the phase counted, the
              pipeline launches the ``overlap_run`` calls;
6. comm     — the communication suite's entry points over logical
              ranks on the card (the kernels were held against their
              plain versions in phase 2): ``allreduce_app --sweep
              --min-p 3 -p 25`` at world 4, f32, over all four
              algorithms (every point on its oracle); one fused point
              each at world 2 and 8 and in bf16 and int32; the
              Communicator's ``allreduce_into(bias, relu)`` on the
              analytic oracle and its fused ``allgather_matmul`` exactly
              equal to the collective route on integer-valued data;
              ``pingpong_app`` over p 3-25 on both routes (the fused one
              through ``fused_permute``); ``interop_app`` (every leg);
              the port bench's collective keys. Each kernel's launches
              equal the calls of its entry point the phase counted;
6a. stencil — ``stencil_app`` in this process on the card at world 8,
              ``-p 22`` and ``-p 26`` (16 and 256 MiB of f32), 64 steps:
              SUCCESS with both oracles (conservation, the dense replay,
              and whether the two are equal bit for bit), the per-step
              time and the domain's effective GB/s beside the bound (the
              domain read once and written once a step over the card's
              memory rate; the eager step makes about 12 passes);
6b. launch  — real child processes on the one card through
              ``apps/launch.py`` (2 processes x 2 logical ranks, a gloo
              group; their collectives cross through pinned host memory):
              (a) ``allreduce_app --sweep`` over ring, ring_chunked and
              collective at p 16..22 (Passed 0..3, fused named as not
              run), then every algorithm on seeded rows, each rank's
              result digest equal to one process of 4 ranks on the card,
              and ``stencil_app`` across the two processes equal to its
              dense replay bit for bit (the one-process run here against
              the same replay); the launched busbw printed as gloo over
              host memory, not a card figure; (b) a traced
              ``--chaos straggler:rank=1,delay_ms=40`` ping-pong merged
              by the launcher: the rollup names rank 1, the schedule is
              consistent, the clocks aligned on the barrier's anchors; (c)
              ``--chaos die:rank=1,at=3``: the rank report names
              ``killed (SIGKILL)``;
7. quant    — the quantized-KV counterpart of the serving benchmark's
              ``run_quantized``: the precision law on the chip model
              (bf16 KV against int8 KV, then fp8 KV; 4 prompts of 512, 8
              teacher-forced steps on the linear cache's flash route)
              checked against ``DEFAULT_BOUNDS``; then 4 requests of the
              bench stream served at int8 KV on the ``flash`` route and
              on the ``paged_flash`` route (and timed in bf16 for
              comparison), every sequence held against its standalone
              ``paged_generate`` under the same config (tie-aware), no
              page leaked; the pool bytes against a bf16 pool of equal
              geometry; each decode kernel's launches equal to n_layers x
              the decode steps that ran it; then the ``bench_serving
              --quant`` row (``run_quantized`` at ``quantized_full_config``,
              its first 4 of 24 requests, budgets cut to 128): the law,
              both engines on their
              standalone, the pool-bytes fraction, goodput and the
              gather vs ``paged_flash`` race, kernels 5, 6/6q and 7
              launched;
8. plane    — the serving plane at the serve phase's model (page 256, 8
              slots, chunk 16, the plane benchmark's stream cut from 32
              requests to 8, Poisson at 32 rps, seed 11, prompts 32/64/128, budgets
              32/128/256 at 0.5/0.3/0.2, two classes): the port's
              ``bench_serving.run_plane`` over dma (single engine,
              2-replica, 1 prefill + 1 decode replica on logical ranks 0
              and 1 of the card), then closed-loop 1p/1d legs over dma,
              device_put and wire (dma's tokens == wire's byte for byte)
              and 4 requests at int8 KV over dma: every sequence against
              its standalone ``paged_generate`` (tie-aware), migrations >
              0, every bundle over the asked transport (a fallback warning
              fails), kernel 13's launches == the dma bundles' payload
              arrays (2 x 8 a bf16 bundle, 4 x 8 an int8 one), every arena
              drained; wall time, tokens/s, goodput, the overlap fraction
              and bytes a round printed; ``run_plane``'s sampled 1p/1d leg
              and a closed-loop sampled 1p/1d leg over dma (T 0.8, top-k
              50: every sequence on its standalone with its key, kernel
              13's launches == the bundles' arrays); the 2-replica plane
              with ``die:replica=1`` (``deaths == ["r1"]``, every casualty
              shed and counted, every served sequence on its standalone);
8a. elastic — the launched and the elastic plane at the serve phase's
              model: (a) ``bench_serving.run_elastic`` at
              ``elastic_full_config`` (page 256, 4 slots, chunk 16,
              prompts 64/128, budgets 128/256, diurnal at 24 rps, period
              1 s, replica 1 dying at its round 3, the sampled leg), its
              32 requests cut to 16 (``ELASTIC_CUTS``): the row's own
              asserts (the fault fired, static sheds and elastic does not,
              elastic attainment strictly above, every stream tie-aware on
              its standalone, greedy and sampled), warm spin-up and cold
              init printed side by side with the verdict, a scale-up on
              load and a drain by migration, every rung a multiple of
              128 and kernel 1 and 6 launches == n_layers x the engines'
              admissions / decode steps (the oracle's own launches
              apart); (b) two
              ``plane_app`` replica processes (``--roles prefill,decode``,
              the chip widths, prompts to 256, budget 64, 8 requests)
              under the launcher's HPCPAT_* protocol with this process as
              the router (``service.connect_replicas``,
              ``service.PlaneRouter``): every request over the socket's KV
              handoff, every stream tie-aware on ``paged_generate`` at the
              replicas' seeded weights, each replica's printed kernel 1/6
              launches == n_layers x its admissions / decode steps (the
              replicas start once (a)'s timed work is done), the
              export and handoff times and bytes, tokens/s of the two
              time-sliced processes beside the in-process 1p/1d plane's
              over the wire codec on the same arrivals; (c)
              ``apps/launch.py -np 4 --chaos die:replica=2,at=3,...
              plane_app --roles both,both,both --temperature 0.7``:
              ``PLANE SUCCESS``, ``deaths=[2]``, a non-empty
              ``resumed``, every request served, ``rank 2: fault: killed
              (SIGKILL)``, the survivors' kernel 1/6 launches == n_layers
              x their admissions / decode steps (started once (b)'s timed
              runs are done, its start-up overlapping (b)'s oracle);
9. observe  — the observability layer: ``serve_app`` in-process at the
              serve phase's model and the first 8 requests of its stream
              with ``--metrics --trace
              --reqtrace --log --trace-out``: SUCCESS, every sequence
              equal to the untraced serve phase's byte for byte, the
              Chrome JSON balanced with its decode-chunk slices timed by
              CUDA events, the report's phase table, every request's
              segments covering its life; the same engine untraced and
              traced in turns (untraced, then traced):
              equal sequences, equal kernel 1 and 6 launches, tokens/s; on
              one more traced run (the stream's first 8 requests at 64
              tokens each, their sequences the serve phase's first 64
              tokens) the decode-chunk windows' share of wall time beside
              ``torch.profiler``'s device-busy share;
              ``train_app --metrics --trace`` at the training widths and 2
              layers for 3 steps (``train.steps``, ``train.step_s``,
              ``train.step_time_s``); ``allreduce_app --sweep --min-p 3 -p
              12 --metrics`` (each algorithm's busbw gauge equal to its
              printed busbw) and one ``comm.allreduce`` span and
              event-timed window per Communicator call; one closed-loop
              1p/1d dma plane leg with ``emit=`` (its tokens equal to
              phase 8's, one ``plane_migrate`` record and one window per
              migration, every migrated bundle carrying its segments);
10. kernel  — the training kernels (kernels 1-4) at one layer of the
              training benchmark's step (B 8, T 2048, H 8, D 128, causal,
              bf16): the forward with lse, the fused, dq and dkv backward
              kernels, each against its plain version (stated tolerances)
              and called twice for equal bits, timed beside its plain
              version, its bound and SDPA, and both backward routes end
              to end; the same at GQA (Hkv 2); then
              ``flash_attention_block`` at offsets with Tq != Tk, a
              fully-future block and dead rows, its gradients through out
              and lse against autograd of the plain forward in f32; then
              the fused MLP kernels (kernels 8-9) at one layer's MLP of
              the same step (N 16384, D 1024, F 4096, bf16): the forward,
              the save-a forward, the backward's dx and dW kernels, each
              against its plain version and twice for equal bits, timed
              beside its bound, its plain version and the dense chain in
              the library (forward, and its autograd backward), each with
              its launches' plan (cluster size, tiles, waves,
              ``cudaOccupancyMaxActiveClusters``; the forwards clusters of
              more than one CTA);
11. train   — ``train_app`` in-process at the training benchmark's chip
              model (vocab 32768, d_model 1024, 8 heads of 128, 8 layers,
              d_ff 4096, bf16, flash, batch 8 x 2048; 8 steps, with
              --resume-check and --generate 16): SUCCESS, the first loss
              near ln 32768, the losses falling, the forward, dq and dkv
              launches (the card's auto backward is the split route)
              equal to n_layers x the gradient passes counted, no fused
              backward launch, generate's flash_decode launches equal to
              n_layers
              x its decode steps; then on the same seed and batch with
              --mlp-impl fused (8 steps), and with it --remat under the
              split and nothing policies (5 steps each): SUCCESS, step
              time, tokens/s and peak memory of every run, the losses
              equal to the fused run's, each kernel's launches equal to
              n_layers x the gradient passes (the MLP and flash forwards
              twice under nothing, once under split); ``eval_app`` on the
              dense checkpoint; then on one batch at the checkpoint's
              trained params flash against full attention (loss, each
              gradient leaf's cosine), the split backward against the
              fused one (each route named: ``bwd="split"`` and
              ``bwd="fused"``), the fused MLP against the dense one and
              the kernel backward against the save-a one (``xla_a``: the
              save-a forward once per layer), one step on the fused route
              (kernel 2 once per layer), and one step profiled
              (device-busy share, top kernels);
12. parallel — the sp and ep axes as logical ranks of the card, at the
              training cell's widths, each part's line with the card's
              name and power limit: (a) ``ring_attention`` alone on q/k/v
              of sp 4 x B 2 x T_local 512 x H 8 x D 128 bf16 (and Hkv 2):
              the fused (kernel 10) and ppermute shifts move equal bytes,
              ring_flash and the dense ring within ``PAR_ATOL`` of
              ``flash_attention`` on the gathered sequence, one counted
              entry-point call launching kernel 10 2 x (sp - 1) times and
              kernel 1 sp (sp + 1) / 2 times (fully-future causal blocks
              are not launched), each route's device ms, Ulysses' flash
              route beside them; (b) ``train_app --attention ring_flash
              --sp 4`` and ``--attention ulysses_flash --sp 4``, 4 steps
              each: SUCCESS, the first loss within ``PAR_LOSS_RTOL`` of
              flash's at init, every gradient leaf's 1 - cosine against
              flash's within ``PAR_GAP`` (one batch at init), kernel 1,
              3 and 4 launches equal to n_layers x blocks a layer x grad
              passes, step ms and tokens/s; (c) ``train_app --n-experts 8
              --n-experts-top-k 2 --drop-rate-every 2 --generate 16`` (E
              and k are Mixtral-8x7B's), 8 steps: SUCCESS, the loss
              falling, the drop rates, step ms, tokens/s, TF/s with the
              expert FLOPs counted by E x C slots, peak memory, and
              generate's kernel 5 launches; (d) the MoE loss at
              capacity_factor 8 (drop-free) on ``{"ep": 4}`` against no
              mesh, no drops: on 2 rows (JAX's test's layout, routing
              replicated with its warning) the loss, on the 8 the NLL,
              within ``PAR_EP_RTOL``; (e) one profiled step each of the
              MoE cell and of ring_flash at sp 4 (busy share, top
              kernels); (f) the scatter MoE at top-3 (``PAR_TOP3``: the
              MoE cell's widths at 2 layers, 8 experts), loss and
              gradients twice: equal bits;
12a. sharded — dp, fsdp and tp as logical ranks of the card at the
              training cell's widths (``SHARD_*``), each part's line with
              the card's name and power limit: (a) tp 4 with the fused
              MLP: the first loss within ``SHARD_LOSS_RTOL`` and every
              gradient leaf's 1 - cosine within ``SHARD_GAP`` of the
              no-mesh step at init (also under the save-a backward), the
              step's ms, busy share, kernels a step and peak memory
              beside the no-mesh step's, then ``train_app --tp 4
              --mlp-impl fused`` (SUCCESS; kernel 1, 3, 4 launches = n_
              layers x grad passes, kernel 8 and 9 = tp x that); (b)
              ``train_app --dp 2 --fsdp 2 --tp 2 --resume-check``: the
              resume bit for bit, the loss falling, its step's stats; (c)
              ``generate`` and ``paged_generate`` at ``{"tp": 4}`` on the
              serving widths (page 256, 4 prompts of 512, 64 tokens) on
              bf16 and int8 caches, tie-aware against the unsharded route
              on the card, with kernels 1, 5, 6 and 6q launched n_layers
              times a prefill / step; (d) ``launch.py -np 2`` with 2
              logical ranks a process at ``SHARD_LAUNCH_ARGV``'s cut
              widths: ``train_app --dp 4`` and ``--dcn-dp --dp -1 --tp 2
              --slices 2``, each SUCCESS and each process's losses within
              ``SHARD_LAUNCH_RTOL`` of one process's run of the same
              global mesh; then kernels 1, 3, 4, 8, 8a, 9, 5, 6 and 6q at
              their shard shapes against their plain versions;
12b. pipeline — pp and the tp serving engine as logical ranks of the card
              (``PIPE_*``), each part's line with the card's name and
              power limit: (a) pp 4 x 8 microbatches with the fused MLP
              at the training cell: the loss within ``PIPE_LOSS_RTOL``
              and every gradient leaf's 1 - cosine within ``PIPE_GAP``
              of the no-mesh step at init, both steps' ms, busy share,
              kernels and peak memory side by side, each stage's peak
              stash within min(P - r, M), and a step's launches of
              kernels 1 (forward, and with lse in the recompute), 3/4
              and 8/9 equal to the 1F1B schedule's; (b) ``train_app
              --pp 2 --tp 2`` and ``--dp 2 --pp 2`` (dense MLP,
              ``PIPE_STEPS`` steps, ``--resume-check``): SUCCESS, the
              resume bit for bit, each step's loss within ``PIPE_B_RTOL``
              of the no-mesh step's; (c) ``train_app --pp 4
              --microbatches 8``: SUCCESS; (d) ``launch.py -np 2
              --slices 2 ... train_app --pp 2 --dcn-dp --dp -1`` at
              ``SHARD_LAUNCH_ARGV``'s widths, each process's losses
              within ``SHARD_LAUNCH_RTOL`` of one process of dp 2 x pp 2;
              (e) the tp 4 engine at ``SHARD_SERVE``'s geometry on bf16
              and int8 pools, tie-aware against the tp standalone
              ``paged_generate`` (the prompts batched), tokens/s (best of
              two runs) beside the unsharded engine and, on bf16, the
              busy share of one steady decode round (kernel 1 and 6/6q
              launches against the counted admissions and steps); one
              tp bundle through
              kernel 13 into an unsharded engine; the aligned pair
              (phase spec's build) draft-assisted unsharded, at tp 4
              (whole pools: tp does not divide its 2 kv heads) and at tp
              2 (both caches' pools stacked), tie-aware against the
              target's standalone; then kernels 1-4 at the microbatch
              shape (B 1 x T 2048 x H 8) and 8, 8a and 9 at a
              microbatch's MLP (N 2048 x D 1024 x F 4096);
12c. analysis — the static analyzer (``hpc_patterns_tpu_torch.analysis``)
              and its runtime halves on the card: (a) ``--ci`` over the
              port on this host (findings, the suppressed count, files,
              seconds; every protocol kernel's static ledger analyzed,
              none abstained); (b) each library's ``hpcpat_smem_rows``
              (``cudaFuncGetAttributes``' static bytes and registers,
              the launcher's dynamic request) against ``smem.py``'s row
              of the same instantiation, a request set per call (kernels
              8, 8a, 14) at the launchers' plans for the shapes this
              script launches (``ANALYSIS_MLP_SHAPES``,
              ``ANALYSIS_PIPELINE_ROWS``), every block within
              ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` (the table in
              ``build/smem_table.json``, its non-decode rows printed);
              (c) ``strict_dispatch``: the serve phase's engine sampling
              with preemption (``ANALYSIS_SERVE``: one row evicted by a
              higher-priority arrival and resumed), a ``Command`` submit
              loop and one ``Communicator`` allreduce with the statically
              clean dispatch-critical functions under the sync debug
              mode's "error" — no synchronizing op raised, guarded calls
              > 0, a preemption and its resume, the streams equal to the
              unguarded run's; (d)
              ``strict_barriers``: kernels 11 and 14 once each from the
              ``-DHPCPAT_LEDGER`` build (compiled beside phase build's,
              into ``build/ledger/``), each equal to its plain version,
              the barrier and flag ledger balanced;
13. the ``done`` line with each phase's wall seconds, the ``{"kernels":
   [...]}`` line, the card's name and power limit
   (``nvidia-smi``), and last ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero and prints no
``ok`` line. Without CUDA, or run from a directory that does not hold the
repository, it exits non-zero before printing any result. Imports
nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = "hpc_patterns_tpu_torch"

# NVIDIA H100 SXM published peaks (data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
FFMA_LATENCY_CYCLES = 4  # a dependent FFMA's latency on Hopper

# tolerances of the kernel-vs-plain phase (max abs error):
# prefill — bf16 in/out; the kernel rounds p to bf16 before p.v (as the
#   TPU kernel does) and the output to bf16, each ~2^-8 relative on
#   values of order 1;
# decode  — f32 math on both sides over the same cache values; only the
#   summation order differs (online softmax block by block vs one
#   softmax), and for one-byte caches where the scales are folded in
#   (the kernels scale scores and probabilities, the plain versions
#   dequantize first). The same for the linear, paged and exact-softmax
#   decode kernels.
PREFILL_ATOL = 2e-2
DECODE_ATOL = 1e-4
# the training kernels: lse is f32 on both sides from the same bf16 scores
# (only the summation order differs); the backward kernels' error is
# taken over max|plain| — their outputs are bf16, and P and dS are rounded
# to bf16 before their products (as the TPU kernels do), where an f32
# difference in the last place can move a rounding
LSE_ATOL = 1e-3
BWD_RTOL = 2e-2
# the overlap phase: (chunks, chunk rows, calibration passes) per shape;
# each per-pass measurement aims at OVERLAP_TARGET_S of device time
OVERLAP_SHAPES = ((16, 2048, 200), (16, 32768, 20))
OVERLAP_TARGET_S = 0.1
# passes of the overlap phase's kernel-vs-plain check at each shape
OVERLAP_CHECK_PASSES = 2
# the pipeline kernel's timed row: the bench shape, one pass
PIPE_TIMED = dict(chunks=16, rows=2048, trips=8, passes=1)
# the busy-wait kernel's timed row: the suite's compute buffer
BUSY_TIMED = dict(n=1024, trips=300)
# the comm kernels' timed rows: the allreduce app's top point (2^25 f32 per
# rank, the reference's default -p) and the bench's allgather_matmul shape,
# at the app's default 4 ranks
COMM_WORLD = 4
RING_ELEMENTS = 1 << 25
AGMM_SHAPE = (256, 1024, 1024)
ALIAS_SHAPE = (8, 128)
# sweep repetitions in the comm phase (the app's default is 10)
SWEEP_REPS = 3
# the serving benchmark's chip stream, cut from 32 requests to 16; the
# quant phase serves 4 of them per route
N_REQUESTS = 16
N_QUANT_REQUESTS = 4
# the bench_serving --quant row (quantized_full_config: 24 requests on
# the card, budgets up to 256) at its first 4, budgets up to 64 (128
# until phase pipeline joined)
QUANT_ROW_REQUESTS, QUANT_ROW_BUDGET = 4, 64
# phase sample's serve_app leg: the stream's first 4 (16 until a whole
# run took 752 s on a slow host with phases stencil and launch, 8 until
# phase pipeline joined)
SAMPLE_REQUESTS = 4
SERVE_CUTS = {"requests": "32 -> 16",
              "sample_requests": f"32 -> {SAMPLE_REQUESTS}",
              "quant_requests": f"16 -> {N_QUANT_REQUESTS}",
              "quant_row_requests": f"24 -> {QUANT_ROW_REQUESTS}",
              "quant_row_budget": f"256 -> {QUANT_ROW_BUDGET}"}
# the quant phase's precision law: prompts x length, teacher-forced steps
LAW_PROMPTS, LAW_PROMPT_LEN, LAW_STEPS = 4, 512, 8
# the training benchmark's chip model (benchmarks/bench_train.py:39-55:
# d_ff = 4 x d_model as train_app builds it; bf16, learned positions,
# flash attention, dense MLP and loss) and batch, run through train_app;
# cut from bench_train's 32 amortized iterations to 8 steps
TRAIN_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8,
                   d_ff=4096, dtype="bfloat16")
TRAIN_BATCH = (8, 2048)
TRAIN_BASE = ["--batch", "8", "--seq", "2048", "--d-model", "1024",
              "--n-layers", "8", "--n-heads", "8", "--vocab", "32768",
              "--attention", "flash"]
TRAIN_ARGV = ["--steps", "8", *TRAIN_BASE, "--resume-check", "--generate",
              "16"]
# the Hopper kernels' SASS instructions counted in phase build (kernel 1,
# the backward's and the fused MLP's): the warpgroup MMA (HGMMA, which
# must be there), the TMA's tensor loads and stores, and cp.async (LDGSTS,
# the pre-Hopper copy; the fused MLP must have none)
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "LDGSTS")
HOPPER_SOURCES = ("flash_prefill", "flash_attention_bwd", "fused_mlp")
# the kernels that must not spill, by source and name prefixes: every one
# of the fused MLP's, the attention backward's (kernels 2-4), the linear,
# paged and exact-softmax decodes' (kernels 5, 6 and 7: both passes), the
# allreduce's and the all-gather matmul's (kernels 11 and 12: every dtype,
# tile and route), the migration exchange's (kernel 13) and the overlap
# pipeline's (kernel 14: every mode)
NO_SPILL = {"fused_mlp": "", "flash_attention_bwd": "", "flash_decode": "",
            "paged_decode": "", "paged_attention": "",
            "fused_ring": ("fused_allreduce_kernel", "allgather_matmul_kernel"),
            "migration_dma": "", "overlap_pipeline": ""}
# the fused MLP runs on the same model, seed and batch: the kernels alone,
# then under the split and nothing remat policies
FUSED_RUNS = {
    "fused": {"steps": 8, "argv": ["--mlp-impl", "fused"]},
    "fused_remat_split": {"steps": 5, "argv": [
        "--mlp-impl", "fused", "--remat", "--remat-policy", "split"]},
    "fused_remat_nothing": {"steps": 5, "argv": [
        "--mlp-impl", "fused", "--remat", "--remat-policy", "nothing"]},
}
TRAIN_CUTS = {"iterations": "32 amortized (bench_train) -> 8 steps",
              "fused_runs": "no --resume-check or --generate (the dense "
                            "run drives both)",
              "remat_runs": "8 -> 5 steps (the fifth is the first "
                            "below the first loss: the fourth spikes at "
                            "lr 3e-4 from init)"}
# flash vs full attention on one batch at the trained chip model, bf16:
# the flash kernels round P to bf16 before P.V where the dense path keeps
# f32; held on the loss and on every gradient leaf's 1 - cosine (the
# worst leaf, so the attention projections' gradients cannot hide behind
# the embedding's); the split and fused backward routes differ only in
# where dQ is summed. Limits about 10x the readings of a sound run on the
# H100 (loss 3.7e-6 relative; worst leaf 9.3e-6 flash vs full, 3.4e-6
# split vs fused; PERF.md)
TRAIN_LOSS_RTOL = 4e-5
TRAIN_GAP_FULL = 1e-4
TRAIN_GAP_SPLIT = 4e-5
# the fused MLP against the dense one at the same trained params: the
# dense path rounds a = x W1 to bf16 before gelu, the kernel keeps it in
# f32; and the kernel backward against the save-a backward (xla_a), which
# starts from a rounded to bf16 and forms its products in f32 library
# GEMMs. Limits about 10x the readings of a sound run on the H100 (loss
# 3.5e-6 relative, worst leaf 9.5e-6 at lm_head; xla_a worst leaf 3.4e-6
# at embed; PERF.md)
TRAIN_LOSS_MLP_RTOL = 4e-5
TRAIN_GAP_MLP = 1e-4
TRAIN_GAP_XLA_A = 4e-5
# the first loss against ln(vocab): at init the logits have a variance
# near 1, which lifts the expected logsumexp by about half of it
TRAIN_FIRST_LOSS_ATOL = 1.0
# the training kernels' timed shape: one layer of the chip model's step
TRAIN_KERNEL_SHAPE = dict(B=8, T=2048, H=8, Hkv=8, D=128)
# the fused MLP kernels' timed shape: one layer's MLP of the same step
# (tokens B x T, d_model, d_ff), which is also benchmarks/bench_mlp.py's
MLP_SHAPE = dict(N=8 * 2048, D=1024, F=4096)
# fused MLP kernels against their plain versions, each output's max abs
# error over its max|plain|: y, a, dx, g and da are bf16, and g and da are
# rounded to bf16 from f32 values whose sums run in another order (which
# can move a rounding); dW1 and dW2 are f32 sums of the same bf16 products
# in another order
MLP_RTOL = 2e-2
MLP_DW_RTOL = 1e-3
# phase parallel: ring attention alone at sp 4 x B 2 x T_local 512 x H 8 x
# D 128 bf16 (and Hkv 2), held against flash_attention on the gathered
# sequence (max abs error: both round P to bf16 before P.V; the ring merges
# its bf16 partials in f32 and rounds once more); the sp runs' first loss
# and gradient cosines against flash at init (the limits of flash vs full
# in phase train: the same roundings at other places); the MoE cell adds
# Mixtral-8x7B's num_local_experts 8 and num_experts_per_tok 2 to the
# training cell; ep 4 against no mesh at a drop-free capacity: the same
# tokens reach the same experts, so the NLL moves only by the slots'
# order in the expert products (bf16 outputs; 1.0e-5 relative on the
# H100, PERF.md). With JAX's test's layout (2 rows: the batch does not
# divide the ep ranks, so routing runs replicated and the aux is the
# whole batch's) the loss is held; with the whole batch (routing
# partitioned) the NLL is, since the aux is then a mean over the shards'
# load-balance terms (JAX's pmean), another number by definition. The
# ring's worst gradient leaf read 5.7e-5 (embed) on the H100 against
# flash: its partials are rounded to bf16 before the merge
PAR_RING = dict(P=4, B=2, T=512, H=8, D=128)
PAR_ATOL = 2e-2
PAR_LOSS_RTOL = 4e-5
PAR_GAP = 3e-4
PAR_EP_RTOL = 1e-4
PAR_SP_STEPS = 5
PAR_MOE = ["--n-experts", "8", "--n-experts-top-k", "2"]
PAR_MOE_ARGV = ["--steps", "8", *TRAIN_BASE, *PAR_MOE, "--drop-rate-every",
                "2", "--generate", "16"]
# the sp runs: 5 steps, the first whose last loss can sit below the first
# (the fourth spikes at lr 3e-4 from init, as in phase train's remat runs)
# the scatter dispatch at top-3, twice for equal bits: the MoE cell's
# widths at 2 layers
PAR_TOP3 = {"n_layers": 2, "n_experts": 8, "n_experts_top_k": 3}
PAR_CUTS = {"sp_steps": f"8 -> {PAR_SP_STEPS} (the sp runs)",
            "ring_alone": "one layer's q/k/v at B 8 -> 2 (random, seeded)",
            "ep_check": "no grad, 8 layers; the loss check on the first 2 "
                        "of 8 rows (JAX's test's layout)"}


# phase sharded: the training cell on dp/fsdp/tp logical ranks. The tp 4
# step against the no-mesh step at init: the row-parallel sums add each
# rank's bf16 partial product (rounded once more than one GEMM's f32 sum)
# and the vocab-sharded loss another association. Limits about 10x the
# readings of a sound run on the H100 (loss 4.7e-6 relative, worst leaf
# 8.2e-5 at embed; PERF.md)
SHARD_TP = 4
SHARD_STEPS = 5
SHARD_LOSS_RTOL = 5e-5
SHARD_GAP = 1e-3
SHARD_MESHES = {"tp4": {"tp": 4}, "dp2_fsdp2_tp2":
                {"dp": 2, "fsdp": 2, "tp": 2}}
# (c) the serving widths: 4 prompts of 512 (a multiple of 128: kernel 1
# prefills), 64 tokens, page 256; the tp prefill's logits against the
# unsharded ones, max abs diff over max |logits| (bf16 logits of ~5 round
# at ~0.02, and the row sums add roundings)
SHARD_SERVE = {"rows": 4, "prompt_len": 512, "new_tokens": 64, "page": 256}
SHARD_LOGITS_RTOL = 3e-2
# (d) the launched legs, cut for the gloo wire: each step's gradient
# (3.8 M f32 at these widths) crosses host TCP; each process's losses
# against one process's at the same global mesh (bf16 GEMMs at another
# row count may round differently): about 10x the readings of a sound
# run on the H100 (1.5e-6 and 1.4e-5 relative; PERF.md)
SHARD_LAUNCH_ARGV = ["--steps", "3", "--batch", "8", "--seq", "512",
                     "--d-model", "256", "--n-layers", "2", "--n-heads", "4",
                     "--vocab", "4096", "--attention", "flash", "--device",
                     "cuda"]
SHARD_LAUNCH_RTOL = 2e-4
SHARD_CUTS = {"steps": f"8 -> {SHARD_STEPS} (train_app legs)",
              "launched": "d_model 1024, 8 layers, vocab 32768, seq 2048 "
                          "-> 256, 2, 4096, 512, 3 steps (a step's "
                          "gradient crosses gloo over host TCP: 168 M f32 "
                          "at full width)",
              "serve": "16 requests of the serving cell -> 4 prompts of "
                       "512 at 64 tokens through generate/paged_generate"}

# phase pipeline: pp and the tp engine on logical ranks of the card. (a)
# pp 4 x 8 microbatches at the training cell (B 1 a microbatch) against
# the no-mesh step at init: the loss and every gradient leaf as 1 -
# cosine, limits about 10x a sound run's readings on the H100 (PERF.md;
# the loss read bit-equal, so its limit is bf16 GEMM noise); (b) pp 2 x
# tp 2 and dp 2 x pp 2 through train_app, each step's loss against the
# no-mesh step's from the same seeds; (e) at SHARD_SERVE's geometry,
# PIPE_SPEC's requests of the pair's stream for the draft leg
PIPE_PP, PIPE_M = 4, 8
PIPE_STEPS = 3
PIPE_LOSS_RTOL = 1e-5  # a sound run's loss: bit-equal (0.0)
PIPE_GAP = 3e-5        # its worst leaf 2.5e-6 (embed)
PIPE_B_RTOL = 1e-4     # its (b) legs 7.6e-6 (pp 2 x tp 2), 3.5e-6
PIPE_MESHES = {"pp2_tp2": ["--pp", "2", "--tp", "2", "--microbatches", "4"],
               "dp2_pp2": ["--dp", "2", "--pp", "2", "--microbatches", "4"]}
PIPE_SPEC = {"requests": 4, "budget": 32}
PIPE_DRAFT_MESH = {"tp": 2}  # divides the pair's 2 kv heads: stacked pools
PIPE_CUTS = {"steps": f"8 -> {PIPE_STEPS} (train_app legs)",
             "launched": "the sharded phase's cut widths (d_model 256, "
                         "2 layers, vocab 4096, seq 512)",
             "serve": "16 requests of the serving cell -> 4 prompts of "
                      "512 at 64 tokens",
             "draft": f"16 requests -> {PIPE_SPEC['requests']} of the "
                      f"pair's stream at {PIPE_SPEC['budget']} tokens"}

# phase stencil: stencil_app at world 8 on the card, 16 and 256 MiB of f32
STENCIL_P = (22, 26)
STENCIL_ARGV = ["--world", "8", "--steps", "64", "--repetitions", "5",
                "--warmup", "1", "--device", "cuda"]
# phase launch: 2 processes x 2 logical ranks on the card through the
# launcher (gloo over pinned host memory between them)
LAUNCH_NP, LAUNCH_LOCAL = 2, 2
LAUNCH_P = (16, 22)
LAUNCH_ALGORITHMS = ("ring", "ring_chunked", "collective")
LAUNCH_STENCIL = ["-p", "22", "--steps", "64", "--repetitions", "3",
                  "--warmup", "1", "--device", "cuda"]
LAUNCH_CHAOS = {"straggler": "straggler:rank=1,delay_ms=40",
                "die": "die:rank=1,at=3"}
LAUNCH_TIMEOUT_S = 240


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_ms(fn, arg_sets, n: int = 30) -> float:
    """Mean device time of one ``fn(*args)`` call: the stream is first
    held by a ``torch.cuda._sleep`` so the host enqueues all ``n`` calls
    before the start event runs, then the events bracket back-to-back
    work (no host gaps). Calls cycle over ``arg_sets`` so that repeated
    calls do not find their inputs in the 50 MB L2."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
    start.record()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def n_sets(bytes_per_set: int) -> int:
    """Input copies to cycle through so that they exceed the L2 3x."""
    return max(2, min(32, math.ceil(150e6 / bytes_per_set)))


def bound(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def ptxas_kernels(log: str) -> list:
    """Each kernel of one nvcc ``-Xptxas -v`` log: its name (template
    arguments as the mangled ``Li<n>E``/``Lb<n>E`` values), registers,
    spill stores and loads, and whether ptxas serialized its wgmma (note
    C7513, which names the kernel)."""
    rows = []
    for block in log.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        # the length-prefixed identifier that ends in "_kernel" (its length
        # may follow other digits: try every tail of each digit run; the
        # shortest wins, since a namespace's length and name can read as a
        # longer prefix, as "12dq9dq_kernel" does for dq::dq_kernel)
        found = []
        for m in re.finditer(r"\d+", mangled):
            for i in range(len(m.group())):
                ident = mangled[m.end():m.end() + int(m.group()[i:])]
                if ident.endswith("_kernel") and ident[0].isalpha():
                    found.append((ident, mangled[m.end() + len(ident):]))
        name, rest = min(found, key=lambda f: len(f[0])) if found \
            else (mangled, "")
        args = re.findall(r"L[ib](\d+)E",
                          rest[1:rest.find("Ev")]) if rest[:1] == "I" else []
        used = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        rows.append({"kernel": f"{name}<{','.join(args)}>" if args else name,
                     "registers": int(used.group(1)) if used else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None,
                     "wgmma_serialized": any(
                         "C7513" in ln and mangled in ln
                         for ln in log.splitlines())})
    return rows


def phase_build():
    from hpc_patterns_tpu_torch.ops import _build

    import threading

    from hpc_patterns_tpu_torch.analysis import runtime

    t0 = time.perf_counter()
    # the ledger build of kernels 11 and 14 (phase analysis) compiles
    # beside the timed sources, into build/ledger/
    ledger = threading.Thread(target=_build.build_variant, args=(
        runtime.LEDGER_SOURCES, ("HPCPAT_LEDGER",), "ledger"))
    ledger.start()
    info = _build.build_all()
    ledger.join()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs,
          "sources": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                    if "Used" in ln or "spill" in ln]}
                      for k, v in info.items()}})
    # kernel 1, the backward and the fused MLP must run on Hopper's
    # warpgroup MMA, fed by the TMA; the fused MLP without cp.async; no
    # wgmma serialized by ptxas (note C7513); no spills in NO_SPILL's
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for name in HOPPER_SOURCES:
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build._target(name))],
            capture_output=True, text=True, check=True).stdout
        counts = {op: sass.count(op) for op in SASS_OPS}
        kernels = ptxas_kernels(info[name]["log"])
        serialized = [k["kernel"] for k in kernels if k["wgmma_serialized"]]
        emit({"phase": "build", "source": name, "sass": counts,
              "wgmma_serialized": serialized,
              "kernels": [{k: v for k, v in row.items()
                           if k != "wgmma_serialized"} for row in kernels],
              "log_cached": info[name]["cached"]})
        check(counts["HGMMA"] > 0, f"{name}'s SASS holds HGMMA: {counts}")
        check(name != "fused_mlp" or counts["LDGSTS"] == 0,
              f"{name}'s SASS holds no cp.async (LDGSTS): {counts}")
        check(info[name]["cached"] or (kernels and not serialized),
              f"{name}: ptxas serialized no wgmma (C7513): {serialized}")
    for name, prefix in NO_SPILL.items():
        if info[name]["cached"]:
            continue
        kernels = ptxas_kernels(info[name]["log"])
        if name not in HOPPER_SOURCES:
            emit({"phase": "build", "source": name, "kernels": [
                {k: v for k, v in row.items() if k != "wgmma_serialized"}
                for row in kernels]})
        watched = [k for k in kernels if k["kernel"].startswith(prefix)]
        check(bool(watched) and all(
            k["spill_stores"] == 0 == k["spill_loads"] for k in watched),
            f"{name}: no spills in {prefix or 'any kernel'}: {kernels}")


def _sdpa_layout(q, k, v):
    """(B, T, H, D) -> SDPA's (B, H, T, D), K/V expanded to H heads."""
    g = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).contiguous(),
            k.repeat_interleave(g, 2).transpose(1, 2).contiguous(),
            v.repeat_interleave(g, 2).transpose(1, 2).contiguous())


def prefill_case(gen, B, T, H, Hkv, D):
    from hpc_patterns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    per = (2 * B * T * H * D + 2 * B * T * Hkv * D) * 2
    sets = []
    for _ in range(n_sets(per)):
        q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        sets.append((q, k, v))
    q, k, v = sets[0]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()), "prefill output finite")
    check(err <= PREFILL_ATOL,
          f"prefill {B, T, H, Hkv, D}: max err {err} > {PREFILL_ATOL}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda *a: fa.flash_attention(*a, causal=True), sets)
    plain = device_ms(
        lambda *a: fa.flash_attention_reference(*a, causal=True), sets)
    lib = device_ms(lambda *a: sdpa(*a, is_causal=True),
                    [_sdpa_layout(*s) for s in sets])  # made untimed
    flops = 4.0 * B * H * D * T * (T + 1) / 2  # causal q.k and p.v
    b_ms, b_by = bound(per, flops, BF16_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "flash_prefill",
           "shape": {"B": B, "T": T, "H": H, "Hkv": Hkv, "D": D,
                     "dtype": "bfloat16"},
           "max_abs_err": err, "tol": PREFILL_ATOL, "ms": ms,
           "plain_ms": plain, "library_ms": lib, "library": "sdpa",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": per,
           "flops": flops, "tflops": flops / ms / 1e9,
           "input_sets": len(sets)}
    emit(row)
    return row


def _cache(gen, shape, kv):
    """Random K or V rows on the card in ``kv`` storage ("bfloat16",
    "float32", "int8", "fp8"): (values, f32 scales of shape[:-1] or
    None)."""
    from hpc_patterns_tpu_torch.models.decode import _quantize_rows

    x = torch.randn(*shape, generator=gen, device="cuda")
    if kv in ("int8", "fp8"):
        return _quantize_rows(x, kv)
    return x.to(getattr(torch, kv)), None


def _kv_bytes(kv) -> int:
    return {"float32": 4, "bfloat16": 2, "int8": 1, "fp8": 1}[kv]


def decode_case(gen, B, H, Hkv, D, P, pages, kv, kernel="paged_decode"):
    """A paged decode kernel (``paged_decode``: kernel 6, the split
    merged by lse; ``paged_attention``: kernel 7, the exact softmax of each
    chunk, split the same way) on ``kv``
    pools through a permuted table at ragged fills, against its plain
    version (the gather route) on the same inputs, twice for equal bits;
    the yardstick is one ``scaled_dot_product_attention`` call on the same
    live rows gathered into a linear compute-dtype cache (the gather and
    dequantization made outside the timing)."""
    from hpc_patterns_tpu_torch.ops import flash_decode as fd
    from hpc_patterns_tpu_torch.ops import paged_attention as pa

    fn = {"paged_decode": fd.flash_decode_paged,
          "paged_attention": pa.paged_attention_decode}[kernel]
    dev = torch.device("cuda")
    qdt = torch.float32 if kv == "float32" else torch.bfloat16
    n_pool = B * pages + 1
    esz, qsz = _kv_bytes(kv), 4 if kv == "float32" else 2
    quant = kv in ("int8", "fp8")
    # ragged fills: 0, a page's last row, the next page's first, the top,
    # the rest drawn
    pos = torch.randint(0, pages * P, (B,), generator=gen, device=dev)
    fixed = [0, P - 1, P, pages * P - 1]
    pos[:min(B, 4)] = torch.tensor(fixed[:min(B, 4)], device=dev)
    pos = pos.to(torch.int32)
    table = torch.randperm(n_pool, generator=gen, device=dev)[:B * pages]
    table = table.to(torch.int32).reshape(B, pages).contiguous()
    pool_bytes = 2 * n_pool * Hkv * P * (D * esz + 4 * quant)
    sets = []
    for _ in range(n_sets(pool_bytes)):
        q = torch.randn(B, H, D, generator=gen, device=dev).to(qdt)
        kp, ks = _cache(gen, (n_pool, Hkv, P, D), kv)
        vp, vs = _cache(gen, (n_pool, Hkv, P, D), kv)
        if quant:
            ks, vs = (ks[:, :, None, :].contiguous(),
                      vs[:, :, None, :].contiguous())
        sets.append((q, kp, vp, table, pos, ks, vs))

    def run(q, kp, vp, tbl, p, ks, vs):
        return fn(q, kp, vp, tbl, p, k_scale_pool=ks, v_scale_pool=vs)

    def plain(q, kp, vp, tbl, p, ks, vs):
        return fd.flash_decode_paged_reference(q, kp, vp, tbl, p,
                                               k_scale_pool=ks,
                                               v_scale_pool=vs)

    # the yardstick: SDPA (enable_gqa, a boolean mask past each fill) on
    # the live rows already gathered into a linear compute-dtype cache
    # (dequantized for one-byte pools), the gather made untimed
    S = pages * P
    mask = (torch.arange(S, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    lib_sets = []
    for q, kp, vp, tbl, _, ks, vs in sets:
        kd = fd._gather_pages(kp, tbl.long())
        vd = fd._gather_pages(vp, tbl.long())
        if quant:
            kd = kd.float() * fd._gather_pages(ks.transpose(2, 3), tbl.long())
            vd = vd.float() * fd._gather_pages(vs.transpose(2, 3), tbl.long())
        lib_sets.append((q[:, :, None, :], kd.to(qdt), vd.to(qdt)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    got, want = run(*sets[0]), plain(*sets[0])
    again = run(*sets[0])
    lib_out = sdpa(*lib_sets[0], attn_mask=mask, enable_gqa=True)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{kernel} output finite")
    check(err <= DECODE_ATOL,
          f"{kernel} {B, H, Hkv, D, P, pages, kv}: max err {err} > "
          f"{DECODE_ATOL}")
    check(torch.equal(got, again), f"{kernel} {B, H, Hkv, D, P, pages, kv}: "
          "two calls give equal bits")
    check(lib_out.shape == (B, H, 1, D), "the SDPA yardstick's shape")
    ms = device_ms(run, sets)
    plain_ms = device_ms(plain, sets)
    lib = device_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                         enable_gqa=True), lib_sets)
    del lib_sets
    live = int((pos.long() + 1).sum())  # rows this run's fills need
    nbytes = (2 * live * Hkv * (D * esz + 4 * quant) + B * H * D * qsz
              + B * H * D * 4 + table.numel() * 4 + B * 4)
    flops = 4.0 * H * D * live
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
    row = {"phase": "kernel", "name": kernel,
           "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "P": P,
                     "pages": pages, "kv": kv, "q": str(qdt)[6:],
                     "pos": pos.tolist()},
           "max_abs_err": err, "tol": DECODE_ATOL, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib,
           "library": "sdpa (enable_gqa, bool mask; the live rows gathered "
                      "into a compute-dtype cache, untimed)",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, "input_sets": len(sets)}
    n_chunks, chunk = fd.paged_decode_plan(pages, P)
    row.update(n_chunks=n_chunks, chunk_rows=chunk)
    emit(row)
    return row


def linear_decode_case(gen, B, H, Hkv, D, S, pos, kv):
    """Kernel 5 (``flash_decode``) on a linear ``kv`` cache of S rows at
    the shared fill ``pos``, against its plain version; the yardstick is
    one ``scaled_dot_product_attention`` call (``enable_gqa``, a boolean
    mask past ``pos``) on a compute-dtype cache of the same values (no
    library call reads int8/fp8 K/V; the dequantization is made outside
    the timing)."""
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    qdt = torch.float32 if kv == "float32" else torch.bfloat16
    esz, qsz = _kv_bytes(kv), 4 if kv == "float32" else 2
    quant = kv in ("int8", "fp8")
    cache_bytes = 2 * B * Hkv * S * (D * esz + 4 * quant)
    sets, lib_sets = [], []
    mask = (torch.arange(S, device=dev) <= pos)[None, None, None, :]
    for _ in range(n_sets(cache_bytes)):
        q = torch.randn(B, H, D, generator=gen, device=dev).to(qdt)
        kc, ks = _cache(gen, (B, Hkv, S, D), kv)
        vc, vs = _cache(gen, (B, Hkv, S, D), kv)
        sets.append((q, kc, vc, ks, vs))
        kd = fd.dequant(kc, ks) if quant else kc
        vd = fd.dequant(vc, vs) if quant else vc
        lib_sets.append((q[:, :, None, :], kd.to(qdt), vd.to(qdt)))

    def run(q, kc, vc, ks, vs):
        return fd.flash_decode_attention(q, kc, vc, pos, k_scale=ks,
                                         v_scale=vs)

    def plain(q, kc, vc, ks, vs):
        return fd.flash_decode_attention_reference(q, kc, vc, pos,
                                                   k_scale=ks, v_scale=vs)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    got, want = run(*sets[0]), plain(*sets[0])
    again = run(*sets[0])
    lib_out = sdpa(*lib_sets[0], attn_mask=mask, enable_gqa=True)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), "flash_decode output finite")
    check(err <= DECODE_ATOL, f"flash_decode {B, H, Hkv, D, S, pos, kv}: "
          f"max err {err} > {DECODE_ATOL}")
    check(torch.equal(got, again), f"flash_decode {B, H, Hkv, D, S, pos, kv}"
          ": two calls give equal bits")
    # the split of the live rows the wrapper planned (one chunk: no merge)
    n_chunks, chunk = fd.decode_chunks(pos, B * Hkv, fd._sm_count(dev))
    check(lib_out.shape == (B, H, 1, D), "the SDPA yardstick's shape")
    ms = device_ms(run, sets)
    plain_ms = device_ms(plain, sets)
    lib = device_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                         enable_gqa=True), lib_sets)
    live = B * (pos + 1)
    nbytes = (2 * live * Hkv * (D * esz + 4 * quant) + B * H * D * qsz
              + B * H * D * 4)
    flops = 4.0 * H * D * live
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "flash_decode",
           "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "S": S, "pos": pos,
                     "kv": kv, "q": str(qdt)[6:]},
           "n_chunks": n_chunks, "chunk_rows": chunk,
           "max_abs_err": err, "tol": DECODE_ATOL, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib,
           "library": "sdpa (enable_gqa, bool mask; compute-dtype cache)",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, "input_sets": len(sets)}
    emit(row)
    return row


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    # the serving path's shapes first (those feed the kernels line)
    rows["flash_prefill"] = prefill_case(gen, 1, 512, 8, 8, 128)
    prefill_case(gen, 1, 256, 8, 8, 128)
    prefill_case(gen, 1, 512, 8, 2, 128)  # GQA
    rows["paged_decode"] = decode_case(gen, 8, 8, 8, 128, 256, 4, "bfloat16")
    decode_case(gen, 8, 8, 2, 128, 256, 4, "bfloat16")  # GQA
    decode_case(gen, 4, 8, 8, 64, 16, 6, "float32")
    # the quantized decode path: kernel 6 on one-byte pools, kernel 7 on
    # bf16 and one-byte pools, kernel 5 at the precision law's shape
    rows["paged_decode_quant"] = decode_case(gen, 8, 8, 8, 128, 256, 4,
                                             "int8")
    decode_case(gen, 8, 8, 8, 128, 256, 4, "fp8")
    decode_case(gen, 8, 8, 2, 128, 256, 4, "int8")  # GQA
    rows["paged_attention"] = decode_case(gen, 8, 8, 8, 128, 256, 4, "int8",
                                          "paged_attention")
    rows["paged_attention_by_cache"] = {"int8": rows["paged_attention"]}
    for kv, hkv in (("bfloat16", 8), ("fp8", 8), ("int8", 2)):
        rows["paged_attention_by_cache"][
            kv if hkv == 8 else f"{kv}_hkv{hkv}"] = decode_case(
                gen, 8, 8, hkv, 128, 256, 4, kv, "paged_attention")
    decode_case(gen, 4, 8, 8, 64, 16, 6, "float32", "paged_attention")
    S = LAW_PROMPT_LEN + LAW_STEPS
    rows["flash_decode"] = linear_decode_case(gen, LAW_PROMPTS, 8, 8, 128, S,
                                              S - 1, "int8")
    rows["flash_decode_by_cache"] = {"int8": rows["flash_decode"]}
    for kv, hkv in (("bfloat16", 8), ("fp8", 8), ("int8", 2)):
        rows["flash_decode_by_cache"][f"{kv}" if hkv == 8 else
                                      f"{kv}_hkv{hkv}"] = linear_decode_case(
            gen, LAW_PROMPTS, 8, hkv, 128, S, S - 1, kv)
    linear_decode_case(gen, 4, 8, 8, 64, 600, 300, "float32")
    # the shapes the planner runs in one chunk (the CTA normalises its rows
    # in place, no merge): few live rows, and enough kv rows to give every
    # SM its CTAS_PER_SM CTAs unsplit (B 33 on an H100's 132 SMs)
    from hpc_patterns_tpu_torch.ops import flash_decode as fd
    b_fill = -(-fd.CTAS_PER_SM * fd._sm_count(torch.device("cuda")) // 8)
    rows["flash_decode_one_chunk"] = {}
    for key, b, p in (("pos63", LAW_PROMPTS, 63), (f"b{b_fill}", b_fill,
                                                   S - 1)):
        r = linear_decode_case(gen, b, 8, 8, 128, S, p, "int8")
        check(r["n_chunks"] == 1, f"flash_decode B {b} pos {p}: one chunk, "
              f"got {r['n_chunks']}")
        rows["flash_decode_one_chunk"][key] = r
    return rows


def phase_serve():
    import dataclasses

    from hpc_patterns_tpu_torch.apps.serve_app import (
        CHIP_MODEL,
        CHIP_SERVE,
        TIE_TOL,
        bench_stream,
        engine_geometry,
    )
    from hpc_patterns_tpu_torch.models.decode import paged_generate
    from hpc_patterns_tpu_torch.models.serving import (
        ContinuousBatcher,
        pad_to_bucket,
        tie_aware_compare,
    )
    from hpc_patterns_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    s = CHIP_SERVE
    tie_tol = TIE_TOL[CHIP_MODEL["dtype"]]
    dev = torch.device("cuda")
    cfg = TransformerConfig(**CHIP_MODEL,
                            max_seq=s["prompt_len"] + s["max_budget"],
                            decode_attn="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev,
                         dtype=torch.bfloat16)
    reqs = bench_stream(N_REQUESTS, s["prompt_len"], s["max_budget"],
                        cfg.vocab)
    geom = engine_geometry(reqs, **s)
    buckets, pool_pages = geom["prompt_buckets"], geom["pool_pages"]

    def engine():
        return ContinuousBatcher(params, cfg, **geom, device=dev)

    warm = engine()  # library init and allocator, outside the count
    for p, b in reqs[:2]:
        warm.submit(p, 8)
    warm.run()
    torch.cuda.synchronize()

    eng = engine()
    fa.launches["fwd"] = 0
    fd.launches["paged_decode"] = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, b) for p, b in reqs]
    got = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_prefill": fa.launches["fwd"],
                "paged_decode": fd.launches["paged_decode"]}
    out = {i: got[sid] for i, sid in enumerate(ids)}
    served = sum(len(v) for v in out.values())

    flash_admits = sum(pad_to_bucket(buckets, len(p)) % 128 == 0
                       for p, _ in reqs)
    check(launches["flash_prefill"] > 0 and launches["paged_decode"] > 0,
          f"both kernels launched on the main path: {launches}")
    check(launches["flash_prefill"] == cfg.n_layers * flash_admits,
          f"prefill launches {launches['flash_prefill']} == n_layers x "
          f"{flash_admits} flash admissions")
    check(launches["paged_decode"] == cfg.n_layers * eng.decode_steps,
          f"decode launches {launches['paged_decode']} == n_layers x "
          f"{eng.decode_steps} decode steps")
    check(eng.free_page_count == pool_pages,
          f"all {pool_pages} pages back on the free list "
          f"({eng.free_page_count})")
    for i, (p, b) in enumerate(reqs):
        check(out[i].shape == (b,) and out[i].min() >= 0
              and out[i].max() < cfg.vocab,
              f"seq {i}: {b} tokens in [0, vocab)")

    counts = {"exact": 0, "near_tie": 0, "mismatch": 0}
    detail = []
    standalone = {}
    for i, (p, b) in enumerate(reqs):
        want, margins = paged_generate(
            params, torch.from_numpy(p)[None, :], cfg, b,
            page_size=s["page_size"], device=dev, with_margins=True)
        want, margins = want[0].cpu().numpy(), margins[0].cpu().numpy()
        standalone[i] = want
        v = tie_aware_compare(out[i], want, margins, tie_tol)
        counts[v] += 1
        if v != "exact":
            j = int(np.nonzero(out[i] != want)[0][0])
            detail.append({"seq": i, "verdict": v, "step": j,
                           "gap": float(margins[j])})
    # the whole path against its plain route (dense prefill attention,
    # gather decode) on the two longest-budget sequences
    plain_cfg = dataclasses.replace(cfg, decode_attn="gather")
    plain_counts = {"exact": 0, "near_tie": 0, "mismatch": 0}
    for i in sorted(range(len(reqs)), key=lambda i: -reqs[i][1])[:2]:
        p, b = reqs[i]
        pw, pm = paged_generate(
            params, torch.from_numpy(p)[None, :], plain_cfg, b,
            page_size=s["page_size"], device=dev, with_margins=True)
        pw, pm = pw[0].cpu().numpy(), pm[0].cpu().numpy()
        v = tie_aware_compare(standalone[i], pw, pm, tie_tol)
        plain_counts[v] += 1
        if v != "exact":
            j = int(np.nonzero(standalone[i] != pw)[0][0])
            detail.append({"seq": i, "route": "plain", "verdict": v,
                           "step": j, "gap": float(pm[j])})
    emit({"phase": "serve",
          "config": {"vocab": cfg.vocab, "d_model": cfg.d_model,
                     "n_heads": cfg.n_heads, "n_layers": cfg.n_layers,
                     "d_ff": cfg.d_ff, "dtype": cfg.dtype, **s,
                     "requests": N_REQUESTS, "pool_pages": pool_pages,
                     "pages_per_seq": geom["pages_per_seq"],
                     "buckets": list(buckets)},
          "cuts": SERVE_CUTS, "served_tokens": served, "seconds": dt,
          "tokens_per_s": served / dt, "admissions": eng.admissions,
          "decode_steps": eng.decode_steps, "launches": launches,
          "oracle": counts, "tie_tol": tie_tol, "divergences": detail,
          "plain_route": plain_counts})
    check(counts["mismatch"] == 0,
          f"engine vs standalone: {counts} {detail}")
    check(plain_counts["mismatch"] == 0,
          f"kernel route vs plain route: {plain_counts}")
    return launches, {"params": params, "cfg": cfg, "reqs": reqs,
                      "geom": geom, "out": out, "launches": launches,
                      "tokens_per_s": served / dt}


def phase_quant():
    """The quantized-KV serving check (``run_quantized``'s counterpart):
    the precision law first, then int8 serving on both kernel routes."""
    import dataclasses

    from hpc_patterns_tpu_torch.apps.serve_app import (
        CHIP_MODEL,
        CHIP_SERVE,
        TIE_TOL,
        bench_stream,
        engine_geometry,
    )
    from hpc_patterns_tpu_torch.harness.cli import resolve_kv_cache_dtype
    from hpc_patterns_tpu_torch.models import quantization
    from hpc_patterns_tpu_torch.models.decode import (
        init_paged_cache,
        paged_generate,
    )
    from hpc_patterns_tpu_torch.models.serving import (
        ContinuousBatcher,
        tie_aware_compare,
    )
    from hpc_patterns_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from hpc_patterns_tpu_torch.ops import flash_decode as fd
    from hpc_patterns_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    s = CHIP_SERVE
    dev = torch.device("cuda")
    tie_tol = TIE_TOL[CHIP_MODEL["dtype"]]
    cfg = TransformerConfig(**CHIP_MODEL,
                            max_seq=s["prompt_len"] + s["max_budget"],
                            decode_attn="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev,
                         dtype=torch.bfloat16)

    # 1. the law gate on the linear cache's flash route (kernel 5), both
    # variants' decode steps counted
    steps = {"n": 0}
    step = quantization.decode_step

    def counted_step(*a, **k):
        steps["n"] += 1
        return step(*a, **k)

    rng = np.random.RandomState(7)
    prompts = np.stack([rng.randint(0, cfg.vocab, size=LAW_PROMPT_LEN)
                        .astype(np.int32) for _ in range(LAW_PROMPTS)])
    laws = {}
    quantization.decode_step = counted_step
    fd.launches["flash_decode"] = 0
    try:
        for spec in ("int8", "fp8"):
            _, kv = resolve_kv_cache_dtype(spec, note=print, device=dev)
            t0 = time.perf_counter()
            law = quantization.precision_law(
                params, cfg, params,
                dataclasses.replace(cfg, kv_cache_dtype=kv), prompts,
                steps=LAW_STEPS)
            laws[spec] = {"kv": kv, "greedy_agreement": law.greedy_agreement,
                          "tv_mean": law.tv_mean, "tv_max": law.tv_max,
                          "steps": law.steps,
                          "seconds": time.perf_counter() - t0}
            emit({"phase": "quant", "law": spec, **laws[spec],
                  "bounds": quantization.DEFAULT_BOUNDS})
            law.check()
    finally:
        quantization.decode_step = step
    launches = {"flash_decode": fd.launches["flash_decode"]}
    check(launches["flash_decode"] > 0
          and launches["flash_decode"] == cfg.n_layers * steps["n"],
          f"flash_decode launches {launches['flash_decode']} == n_layers x "
          f"{steps['n']} law decode steps")

    # 2. serving: 8 requests of the bench stream, int8 KV on the flash
    # route (kernel 6q) and on the paged_flash route (kernel 7); the bf16
    # pool served once for comparison
    reqs = bench_stream(N_REQUESTS, s["prompt_len"], s["max_budget"],
                        cfg.vocab)[:N_QUANT_REQUESTS]
    geom = engine_geometry(reqs, **s)
    served = {}
    runs = (("bf16", cfg, None),
            ("int8_flash", dataclasses.replace(cfg, kv_cache_dtype="int8"),
             "paged_decode"),
            ("int8_paged_flash",
             dataclasses.replace(cfg, kv_cache_dtype="int8",
                                 decode_attn="paged_flash"),
             "paged_attention"))
    for name, c, kernel in runs:
        warm = ContinuousBatcher(params, c, **geom, device=dev)
        warm.submit(reqs[0][0], 4)
        warm.run()
        eng = ContinuousBatcher(params, c, **geom, device=dev)
        torch.cuda.synchronize()
        fd.launches["paged_decode"] = 0
        pa.launches = 0
        t0 = time.perf_counter()
        ids = [eng.submit(p, b) for p, b in reqs]
        got = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_launch = {"paged_decode": fd.launches["paged_decode"],
                    "paged_attention": pa.launches}
        tokens = sum(len(got[i]) for i in ids)
        rec = {"phase": "quant", "serve": name, "kv": c.kv_cache_dtype,
               "decode_attn": c.decode_attn, "requests": len(reqs),
               "served_tokens": tokens, "seconds": dt,
               "tokens_per_s": tokens / dt, "decode_steps": eng.decode_steps,
               "admissions": eng.admissions, "launches": n_launch}
        check(eng.free_page_count == geom["pool_pages"],
              f"{name}: all pages back on the free list")
        if kernel is not None:
            other = ({"paged_decode", "paged_attention"} - {kernel}).pop()
            check(n_launch[kernel] == cfg.n_layers * eng.decode_steps
                  and n_launch[other] == 0,
                  f"{name}: {kernel} launches {n_launch} == n_layers x "
                  f"{eng.decode_steps} decode steps")
            launches[kernel] = n_launch[kernel]
            counts = {"exact": 0, "near_tie": 0, "mismatch": 0}
            detail = []
            for i, (p, b) in zip(ids, reqs):
                want, margins = paged_generate(
                    params, torch.from_numpy(p)[None, :], c, b,
                    page_size=s["page_size"], device=dev, with_margins=True)
                want, margins = want[0].cpu().numpy(), margins[0].cpu().numpy()
                v = tie_aware_compare(got[i], want, margins, tie_tol)
                counts[v] += 1
                if v != "exact":
                    j = int(np.nonzero(got[i] != want)[0][0])
                    detail.append({"seq": i, "verdict": v, "step": j,
                                   "gap": float(margins[j])})
            rec.update(oracle=counts, tie_tol=tie_tol, divergences=detail)
            check(counts["mismatch"] == 0,
                  f"{name}: engine vs standalone {counts} {detail}")
        emit(rec)
        served[name] = rec

    # 3. pool bytes at equal geometry: int8 values + f32 scale pools over a
    # bf16 pool (closed form (D + 4) / (2 D) per row and kv head)
    def pool_bytes(c):
        cache = init_paged_cache(c, s["slots"], geom["pages_per_seq"],
                                 s["page_size"],
                                 pool_pages=geom["pool_pages"] + 1,
                                 device=dev)
        return sum(t.numel() * t.element_size() for k, v in cache.items()
                   if k != "table" for t in v)

    q_bytes = pool_bytes(dataclasses.replace(cfg, kv_cache_dtype="int8"))
    bf16_bytes = pool_bytes(dataclasses.replace(cfg, dtype="bfloat16"))
    frac = q_bytes / bf16_bytes
    want_frac = (cfg.head_dim + 4) / (2 * cfg.head_dim)
    emit({"phase": "quant", "kv_pool_bytes": q_bytes,
          "bf16_pool_bytes": bf16_bytes, "kv_pool_bytes_frac": frac,
          "closed_form": want_frac, "launches": launches,
          "law_decode_steps": steps["n"]})
    check(abs(frac - want_frac) < 1e-9 and 0.5 < frac < 0.55,
          f"kv_pool_bytes_frac {frac} == (D + 4) / 2D = {want_frac}")

    # 4. the bench_serving --quant row (run_quantized at
    # quantized_full_config on the card, its first QUANT_ROW_REQUESTS
    # requests): the law, each engine on its standalone, the route race
    from hpc_patterns_tpu_torch import bench_serving as bs

    conf = dict(bs.quantized_full_config(dev), n=QUANT_ROW_REQUESTS,
                max_budget=QUANT_ROW_BUDGET)
    fd.launches["paged_decode"] = fd.launches["flash_decode"] = 0
    pa.launches = 0
    t0 = time.perf_counter()
    row = bs.run_quantized(**conf)
    torch.cuda.synchronize()
    row_launches = {"flash_decode": fd.launches["flash_decode"],
                    "paged_decode": fd.launches["paged_decode"],
                    "paged_attention": pa.launches}
    emit({"phase": "quant", "row": "bench_serving --quant",
          "requests": QUANT_ROW_REQUESTS, "page_size": conf["page_size"],
          "prompt_len": conf["prompt_len"],
          "max_budget": conf["max_budget"], **row,
          "launches": row_launches, "seconds": time.perf_counter() - t0,
          "seconds_phase": time.perf_counter() - t_phase})
    check(row["kv_pool_bytes_frac"] <= 0.55
          and 0.0 < row["quant_goodput_tok_s"]
          and "tokens_per_s_paged_flash" in row
          and all(n > 0 for n in row_launches.values()),
          f"the --quant row: pool bytes, goodput, the route race, kernels "
          f"5, 6/6q and 7 launched ({row_launches})")
    launches["row"] = row_launches
    return launches


def smi(query: str) -> str:
    """First line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def busy_wait_case(gen):
    from hpc_patterns_tpu_torch.concurrency import kernels

    dev = torch.device("cuda")
    err = 0.0
    for n in (1024, 65536):
        x = torch.rand(n, generator=gen, device=dev)
        for trips in (1, 7, 300):
            got = kernels.busy_wait(x, trips)
            want = kernels.busy_wait_reference(x, trips)
            torch.cuda.synchronize()
            err = max(err, (got - want).abs().max().item())
            check(torch.equal(got, want),
                  f"busy_wait n={n} trips={trips}: kernel == plain bitwise")
    n, trips = BUSY_TIMED["n"], BUSY_TIMED["trips"]
    sets = [(torch.rand(n, generator=gen, device=dev), trips)
            for _ in range(4)]
    ms = device_ms(kernels.busy_wait, sets)
    plain = device_ms(kernels.busy_wait_reference, sets, n=2)
    b_ms, b_by = bound(8.0 * n, 2.0 * n * 8 * trips, F32_FLOPS_PER_S)
    mhz = float(smi("clocks.max.sm").split()[0])
    # one launch with no chain (trips 0: a load and a store a thread),
    # back to back: the least time of any launch
    launch_ms = device_ms(kernels.busy_wait, [(x, 0) for x, _ in sets])
    floor_ms = 8 * trips * FFMA_LATENCY_CYCLES / (mhz * 1e6) * 1e3
    row = {"phase": "kernel", "name": "busy_wait",
           "shape": {"n": n, "trips": trips, "dtype": "float32"},
           "checked": {"n": [1024, 65536], "trips": [1, 7, 300],
                       "bitwise": True},
           "max_abs_err": err, "tol": 0.0, "ms": ms, "plain_ms": plain,
           "library_ms": None, "library": None, "bound_ms": b_ms,
           "bound_by": b_by,
           # the dependent chain's floor: 8 * trips FFMAs of 4 cycles;
           # with one launch, the least time these inputs can take
           "latency_floor_ms": floor_ms, "launch_ms": launch_ms,
           "least_ms": floor_ms + launch_ms, "sm_clock_max_mhz": mhz}
    emit(row)
    return row


def pipeline_case(gen):
    from hpc_patterns_tpu_torch.concurrency import pipeline as pl

    dev = torch.device("cuda")
    x = torch.rand(4, 64, 128, generator=gen, device=dev)
    csums = {}
    for mode in pl.MODES:
        out = torch.full_like(x, -1.0)
        got = pl.overlap_run(x, mode=mode, tripcount=3, passes=2, out=out)
        want, written = pl.overlap_run_reference(x, mode=mode, tripcount=3,
                                                 passes=2)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"pipeline {mode}: checksum == plain")
        if mode.startswith("pair"):
            check(torch.equal(out, x), f"pipeline {mode}: wrote the input")
        elif written is not None:
            check(all(bool((out[i] == pl.SEEDS[i % 2]).all())
                      for i in range(x.shape[0])),
                  f"pipeline {mode}: wrote 0.25/0.75 by chunk parity")
        else:
            check(bool((out == -1.0).all()), f"pipeline {mode}: wrote nothing")
        csums[mode] = got
    for a, b in (("overlap", "serial"), ("overlap_out", "serial_out"),
                 ("pair_overlap", "pair_serial")):
        check(torch.equal(csums[a], csums[b]), f"pipeline {a} == {b}")
    check(not csums["dma"].any() and not csums["dma_out"].any(),
          "pipeline dma/dma_out checksums are zero")
    emit({"phase": "kernel", "name": "overlap_pipeline",
          "checked": {"shape": list(x.shape), "trips": 3, "passes": 2,
                      "modes": list(pl.MODES), "bitwise": True,
                      "written_arrays": True}})

    C, R = PIPE_TIMED["chunks"], PIPE_TIMED["rows"]
    blocks, tiles = pl.pipeline_plan(
        R, torch.cuda.get_device_properties(0).multi_processor_count)
    trips, passes = PIPE_TIMED["trips"], PIPE_TIMED["passes"]
    xb = torch.rand(C, R, 128, generator=gen, device=dev)
    chunk_bytes = C * R * 512.0
    chain_flops = C * R * 128 * 8 * trips * 2.0
    rows = {}
    for mode in ("overlap", "serial", "dma", "compute", "overlap_out",
                 "serial_out", "pair_overlap", "pair_serial"):
        out = torch.empty_like(xb) if mode in pl.OUT_BUF_MODES else None

        def run(x, m=mode, o=out):
            return pl.overlap_run(x, mode=m, tripcount=trips, passes=passes,
                                  out=o)

        def plain_run(x, m=mode):
            return pl.overlap_run_reference(x, mode=m, tripcount=trips,
                                            passes=passes)[0]

        got = run(xb)
        want, written = pl.overlap_run_reference(xb, mode=mode,
                                                 tripcount=trips,
                                                 passes=passes)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.equal(got, want), f"pipeline {mode} at the bench shape")
        check(written is None or torch.equal(out, written),
              f"pipeline {mode} at the bench shape: written array")
        ms = device_ms(run, [(xb,)])
        plain = device_ms(plain_run, [(xb,)], n=2)
        copies = {"dma": 1, "overlap": 1, "serial": 1, "dma_out": 1,
                  "overlap_out": 1, "serial_out": 1, "pair_overlap": 2,
                  "pair_serial": 2}.get(mode, 0)
        t_copy = passes * copies * chunk_bytes / HBM_BYTES_PER_S
        t_comp = (passes * chain_flops / F32_FLOPS_PER_S
                  if mode in ("overlap", "serial", "compute", "overlap_out",
                              "serial_out") else 0.0)
        # serial modes: the two legs add up; the others: the larger one
        t_bound = (t_copy + t_comp if mode in ("serial", "serial_out")
                   else max(t_copy, t_comp))
        lib = (device_ms(lambda s, d: d.copy_(s), [(xb, out)])
               if mode.startswith("pair") else None)
        row = {"phase": "kernel", "name": "overlap_pipeline", "mode": mode,
               "shape": {"chunks": C, "rows": R, "lanes": 128,
                         "trips": trips, "passes": passes,
                         "dtype": "float32"},
               "max_abs_err": err, "tol": 0.0, "ms": ms, "plain_ms": plain,
               "library_ms": lib, "library": "copy_" if lib else None,
               "bound_ms": t_bound * 1e3,
               "bound_by": "bytes" if t_copy >= t_comp else "operations",
               "bytes": passes * copies * chunk_bytes,
               "flops": t_comp * F32_FLOPS_PER_S,
               "launch_plan": {"blocks": blocks, "tiles": tiles}}
        emit(row)
        rows[mode] = row
    return rows


def phase_overlap():
    from hpc_patterns_tpu_torch import bench
    from hpc_patterns_tpu_torch.concurrency import kernels
    from hpc_patterns_tpu_torch.concurrency import pipeline as pl

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launches = {"overlap_pipeline": 0, "busy_wait": 0}
    for C, R, cal in OVERLAP_SHAPES:
        x = pl.make_hbm_array(C, R, device="cuda")
        kernels.launches = 0
        pl.launches = 0
        rec = bench.overlap_headline(x, cal_passes=cal,
                                     target_s=OVERLAP_TARGET_S)
        launches["overlap_pipeline"] += pl.launches
        launches["busy_wait"] += kernels.launches
        d = rec["detail"]
        times = [d[k] for k in ("t_dma_us", "t_compute_us", "t_serial_us",
                                "t_overlap_us")]
        emit({"phase": "overlap", "shape": d["shape"],
              "working_set_mib": d["working_set_bytes"] / 2**20,
              "fits_in_l2": d.get("fits_in_l2"),
              "t_dma_us": d["t_dma_us"], "t_compute_us": d["t_compute_us"],
              "tripcount": d["tripcount"], "t_serial_us": d["t_serial_us"],
              "t_overlap_us": d["t_overlap_us"], "speedup": rec["value"],
              "theoretical": d["theoretical_max_speedup"],
              "vs_baseline": rec["vs_baseline"], "dma_gbps": d["dma_gbps"],
              "verdict": d["verdict"], "pairs_us": d["pairs_us"],
              "cal_passes": cal, "target_s": OVERLAP_TARGET_S})
        check(not d["degenerate"] and min(times) > 0,
              f"overlap {d['shape']}: every time > 0 ({times})")
        # the kernel at this shape (one block an SM, each with an equal
        # share, in two tiles past the L2) in every mode the bench drove, at
        # the probe and the balanced tripcounts, against the plain version
        # bitwise
        checked = []
        for mode in ("dma", "compute", "serial", "overlap"):
            for trips in sorted({bench.PROBE_TRIPS, d["tripcount"]}):
                got = pl.overlap_run(x, mode=mode, tripcount=trips,
                                     passes=OVERLAP_CHECK_PASSES)
                want, _ = pl.overlap_run_reference(
                    x, mode=mode, tripcount=trips,
                    passes=OVERLAP_CHECK_PASSES)
                check(torch.equal(got, want),
                      f"overlap {d['shape']} {mode} trips {trips}: "
                      "checksum == plain bitwise")
                checked.append([mode, trips])
        blocks, tiles = pl.pipeline_plan(R, sms)
        emit({"phase": "overlap", "shape": d["shape"],
              "checked": {"modes_trips": checked,
                          "passes": OVERLAP_CHECK_PASSES, "bitwise": True,
                          "blocks": blocks, "tiles": tiles}})
    check(launches["overlap_pipeline"] > 0,
          f"the overlap bench launched the pipeline kernel: {launches}")
    return launches


# (mode, command a, command b, engine) of the dispatch phase
DISPATCH_CASES = (
    ("async", "C", "M2D", "dispatch"), ("async", "C", "D2M", "dispatch"),
    ("async", "M2D", "D2M", "dispatch"), ("threads", "C", "M2D", "dispatch"),
    ("async", "C", "M2D", "onchip"), ("async", "C", "D2M", "onchip"),
    ("async", "M2D", "D2M", "onchip"), ("async", "C", "C", "onchip"),
)


def phase_dispatch():
    from hpc_patterns_tpu_torch.apps import concurrency_app
    from hpc_patterns_tpu_torch.concurrency import commands, kernels
    from hpc_patterns_tpu_torch.concurrency import pipeline as pl

    counted = {"compute_submits": 0, "overlap_runs": 0}
    submit, overlap_run = commands.ComputeCommand.submit, pl.overlap_run

    def counted_submit(self):
        counted["compute_submits"] += 1
        submit(self)

    def counted_run(*a, **k):
        counted["overlap_runs"] += 1
        return overlap_run(*a, **k)

    logs = ROOT / "build" / "smoke_dispatch"
    logs.mkdir(parents=True, exist_ok=True)
    commands.ComputeCommand.submit = counted_submit
    pl.overlap_run = counted_run
    kernels.launches = 0
    pl.launches = 0
    try:
        for i, (mode, a, b, eng) in enumerate(DISPATCH_CASES):
            log = logs / f"{i}.jsonl"
            t0 = time.perf_counter()
            code = concurrency_app.main(
                [mode, a, b, "--engine", eng, "--device", "cuda",
                 "--repetitions", "5", "--warmup", "2", "--target-s", "0.05",
                 "--log", str(log)])
            recs = [json.loads(ln) for ln in log.read_text().splitlines()]
            res = [r for r in recs if r.get("kind") == "result"]
            check(len(res) == 1, f"{mode} {a} {b} --engine {eng}: one result")
            r = res[0]
            emit({"phase": "dispatch", "mode": mode, "commands": r["commands"],
                  "engine": eng, "exit_code": code,
                  "verdict": "SUCCESS" if r["success"] else "FAILURE",
                  "speedup": r.get("speedup"),
                  "theoretical": r.get("max_theoretical_speedup"),
                  "per_command_ms": r.get("per_command_ms"),
                  "per_command_us": r.get("per_command_us"),
                  "serial_total_ms": r.get("serial_total_ms"),
                  "concurrent_total_ms": r.get("concurrent_total_ms"),
                  "serial_us": r.get("serial_us"),
                  "concurrent_us": r.get("concurrent_us"),
                  "tripcount": r.get("tripcount"),
                  "autotune": [x for x in recs if x.get("kind") == "autotune"],
                  "seconds": time.perf_counter() - t0})
    finally:
        commands.ComputeCommand.submit = submit
        pl.overlap_run = overlap_run
    launches = {"busy_wait": kernels.launches,
                "overlap_pipeline": pl.launches}
    emit({"phase": "dispatch", "launches": launches, "counted": counted})
    check(launches["busy_wait"] > 0
          and launches["busy_wait"] == counted["compute_submits"],
          f"busy_wait launches == compute submits: {launches} {counted}")
    check(launches["overlap_pipeline"] > 0
          and launches["overlap_pipeline"] == counted["overlap_runs"],
          f"pipeline launches == overlap_run calls: {launches} {counted}")
    return launches


def fused_allreduce_case(gen):
    import dataclasses

    from hpc_patterns_tpu_torch.comm import fused

    dev = torch.device("cuda")
    W, n = COMM_WORLD, RING_ELEMENTS
    sets = [(torch.randn(W, n, generator=gen, device=dev),)
            for _ in range(n_sets(W * n * 4))]
    x = sets[0][0]
    got = fused.fused_allreduce(x)
    want = fused.fused_allreduce_reference(x, lane=fused.CARD_LANE)
    fused.synchronize()
    err = (got - want).abs().max().item()
    check(torch.equal(got, want), "fused_allreduce at 2^25 x 4 == plain "
          "bitwise")
    bias = torch.randn(n, generator=gen, device=dev)
    got = fused.allreduce_into(x, bias=bias, epilogue="relu")
    want = fused.fused_allreduce_reference(x, bias=bias, epilogue="relu",
                                           lane=fused.CARD_LANE)
    fused.synchronize()
    check(torch.equal(got, want), "allreduce_into(bias, relu) at 2^25 x 4 "
          "== plain bitwise")
    del got, want, bias
    checked = []
    for world, dtype, n_chk in ((2, torch.float32, 65), (3, torch.bfloat16,
                                                         4099),
                                (8, torch.int32, 40), (8, torch.bfloat16,
                                                       1 << 20)):
        xc = (torch.randn(world, n_chk, generator=gen, device=dev) * 8)
        xc = xc.to(dtype)
        bias = xc[0].clone()
        for kw in ({}, {"bias": bias, "epilogue": "relu"}):
            g2 = fused.fused_allreduce(xc, **kw)
            w2 = fused.fused_allreduce_reference(xc, lane=fused.CARD_LANE,
                                                 **kw)
            fused.synchronize()
            check(torch.equal(g2, w2), f"fused_allreduce world {world} "
                  f"{dtype} n {n_chk} {sorted(kw)}: == plain bitwise")
        checked.append([world, str(dtype).split(".")[-1], n_chk])
    # the receive slots are a FIFO within the L2 budget, whatever the size
    ms = device_ms(fused.fused_allreduce, sets)
    fused.synchronize()
    scratch = fused._scratch["allreduce"]
    plan = scratch["key"][-1]
    scratch_bytes = sum(t.numel() * t.element_size()
                        for t in scratch.values() if torch.is_tensor(t))
    check(plan.fifo_bytes <= fused.ALLREDUCE_FIFO_BUDGET
          and scratch["fifo"].numel() == plan.fifo_bytes,
          f"fused_allreduce FIFO {plan.fifo_bytes} bytes within "
          f"{fused.ALLREDUCE_FIFO_BUDGET}: {plan}")
    plain = device_ms(lambda v: fused.fused_allreduce_reference(
        v, lane=fused.CARD_LANE), sets, n=5)
    lib = device_ms(lambda v: v.sum(0, keepdim=True).expand_as(v).contiguous(),
                    sets)
    b_ms, b_by = bound(2.0 * W * n * 4, (W - 1) * n, F32_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "fused_allreduce",
           "shape": {"ranks": W, "elements_per_rank": n, "dtype": "float32",
                     "lane": fused.CARD_LANE},
           "checked": {"world_dtype_n": checked, "bias_relu": True,
                       "bitwise": True},
           "max_abs_err": err, "tol": 0.0, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "library": "sum(0).expand_as.contiguous",
           "bound_ms": b_ms, "bound_by": b_by,
           "launch_plan": dataclasses.asdict(plan),
           "scratch_bytes": scratch_bytes,
           "fifo_budget_bytes": fused.ALLREDUCE_FIFO_BUDGET,
           # the hops' own traffic, written and read in the L2: every rank
           # hands 2 (W - 1) partials of its chunk along
           "fifo_traffic_bytes": 2 * 2 * (W - 1) * n * 4,
           "input_sets": len(sets)}
    emit(row)
    return row


def allgather_matmul_case(gen):
    from hpc_patterns_tpu_torch.comm import fused

    dev = torch.device("cuda")
    W, (m, k, n) = COMM_WORLD, AGMM_SHAPE
    per = W * (m * k + k * n) * 4
    sets = [(torch.randn(W, m, k, generator=gen, device=dev),
             torch.randn(W, k, n, generator=gen, device=dev))
            for _ in range(n_sets(per))]
    x, w = sets[0]
    got = fused.allgather_matmul(x, w)
    again = fused.allgather_matmul(x, w)
    want = fused.allgather_matmul_reference(x, w)
    fused.synchronize()
    check(torch.equal(got, again), f"allgather_matmul {AGMM_SHAPE} x {W}: "
          "two calls give equal bits")
    bm, bn, G, waves = fused.agmm_plan(W, m, n, fused._capacity(
        "allgather_matmul", 0))
    diff = (got - want).abs()
    # the stated bound (fused.allgather_matmul_tolerance): two f32 orders
    # of the k-sum; the control is the same product with TF32 inputs,
    # which must fail it
    tol = fused.allgather_matmul_tolerance(x, w, want)
    check(bool((diff <= tol).all()), f"allgather_matmul {AGMM_SHAPE} x {W}: "
          f"max err / bound {(diff / tol).max().item()}")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = (fused.allgather_matmul_reference(x, w) - want).abs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_over = (tf32 > tol).float().mean().item()
    check(tf32_over > 0, "control: a TF32 product must fail the bound")
    for dtype in (torch.bfloat16, torch.int32):
        if dtype == torch.int32:
            xs = torch.randint(-3, 4, (8, 3, 16), generator=gen, device=dev,
                               dtype=dtype)
            ws = torch.randint(-3, 4, (8, 16, 8), generator=gen, device=dev,
                               dtype=dtype)
        else:
            xs, ws = x.to(dtype), w.to(dtype)
        g2 = fused.allgather_matmul(xs, ws)
        w2 = fused.allgather_matmul_reference(xs, ws)
        fused.synchronize()
        d2 = (g2.float() - w2.float()).abs()
        check(bool((d2 <= fused.allgather_matmul_tolerance(xs, ws, w2)).all()),
              f"allgather_matmul {dtype}: within tolerance")
    ms = device_ms(fused.allgather_matmul, sets)
    fused.synchronize()
    plain = device_ms(fused.allgather_matmul_reference, sets)
    lib = device_ms(lambda a, b: torch.matmul(a.reshape(1, W * m, k), b),
                    sets)
    flops = 2.0 * W * (W * m) * k * n
    b_ms, b_by = bound(per + W * W * m * n * 4, flops, F32_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "allgather_matmul",
           "shape": {"ranks": W, "m": m, "k": k, "n": n, "dtype": "float32"},
           "checked": {"bf16": list(AGMM_SHAPE), "int32": [3, 16, 8],
                       "equal_bits": True},
           "launch_plan": {"tile": [bm, bn], "ctas_a_rank": G,
                           "ctas": W * G, "waves": waves},
           "max_abs_err": diff.max().item(), "tol": tol.max().item(),
           "max_err_over_bound": (diff / tol).max().item(),
           "tf32_control": {"max_abs_err": tf32.max().item(),
                            "max_err_over_bound": (tf32 / tol).max().item(),
                            "share_over_bound": tf32_over},
           "ms": ms, "plain_ms": plain, "library_ms": lib,
           "library": "matmul (batched, fp32)", "bound_ms": b_ms,
           "bound_by": b_by, "flops": flops, "input_sets": len(sets)}
    emit(row)
    return row


def fused_permute_case(gen):
    from hpc_patterns_tpu_torch.comm import fused, ring

    dev = torch.device("cuda")
    W, n = COMM_WORLD, RING_ELEMENTS
    sets = [(torch.randn(W, n, generator=gen, device=dev),)
            for _ in range(n_sets(W * n * 4))]
    x = sets[0][0]
    pairs = [(r, r ^ 1) for r in range(W)]
    for perm in [pairs] + [ring._ring_perm(W, s) for s in (1, -1, 3)]:
        got = fused.fused_permute(x, perm)
        fused.synchronize()
        check(torch.equal(got, fused.fused_permute_reference(x, perm)),
              f"fused_permute {perm}: == plain bitwise")
    src = torch.tensor([r ^ 1 for r in range(W)], device=dev)
    ms = device_ms(lambda v: fused.fused_permute(v, pairs), sets)
    fused.synchronize()
    plain = device_ms(lambda v: fused.fused_permute_reference(v, pairs), sets)
    lib = device_ms(lambda v: v.index_select(0, src), sets)
    b_ms, b_by = bound(2.0 * W * n * 4, 0.0, F32_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "fused_permute",
           "shape": {"ranks": W, "elements_per_rank": n, "dtype": "float32",
                     "perm": "r^1"},
           "checked": {"perms": ["r^1", "+1", "-1", "+3"], "bitwise": True},
           "max_abs_err": 0.0, "tol": 0.0, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "library": "index_select", "bound_ms": b_ms,
           "bound_by": b_by, "input_sets": len(sets)}
    emit(row)
    return row


def alias_case(gen, launch_ms: float):
    from hpc_patterns_tpu_torch.interop import device as idev

    dev = torch.device("cuda")
    rows, cols = ALIAS_SHAPE
    x = torch.randn(rows, cols, generator=gen, device=dev)
    want = x.clone().mul_(2.0).add_(1.0)
    ptr = x.data_ptr()
    got = idev.alias_inplace(x)
    torch.cuda.synchronize()
    check(got.data_ptr() == ptr and torch.equal(got, want),
          "alias_inplace: in place (data_ptr) and == x*2+1 bitwise")
    sets = [(torch.zeros(rows, cols, device=dev),) for _ in range(4)]
    ms = device_ms(idev.alias_inplace, sets)
    plain = device_ms(idev.alias_inplace_reference, sets)
    lib = device_ms(lambda v: v.mul_(2).add_(1), sets)
    b_ms, b_by = bound(2.0 * rows * cols * 4, 2.0 * rows * cols,
                       F32_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "alias_inplace",
           "shape": {"rows": rows, "cols": cols, "dtype": "float32"},
           "max_abs_err": 0.0, "tol": 0.0, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "library": "mul_(2).add_(1)",
           "bound_ms": b_ms, "bound_by": b_by,
           # one launch: its 4 KB move in far less than any launch takes
           "least_ms": launch_ms}
    emit(row)
    return row


# kernel 13's checked slabs: the plane row's bf16 K/V pages (8 kv heads,
# page 256, D 128) at 1, 2, 5 (a ragged last chunk) and 16 pages, int8
# pages with their f32 scale pools, fp8 pages; timed at one array of a
# plane bundle: 2 pages x 8 x 256 x 128 bf16 = 1 MiB
MIGRATION_PAGE = (8, 256, 128)
MIGRATION_CASES = ((1, MIGRATION_PAGE, torch.bfloat16),
                   (2, MIGRATION_PAGE, torch.bfloat16),
                   (5, MIGRATION_PAGE, torch.bfloat16),
                   (16, MIGRATION_PAGE, torch.bfloat16),
                   (2, MIGRATION_PAGE, torch.int8),
                   (2, (8, 1, 256), torch.float32),
                   (5, MIGRATION_PAGE, torch.float8_e4m3fn))
MIGRATION_TIMED_PAGES = 2


def migration_case(gen):
    """Kernel 13 against its plain version byte for byte (uint8 views) on
    every case of MIGRATION_CASES, the oversized slab refused before any
    launch, then timed at one bundle array of the plane row beside its
    plain version and ``landing.copy_(x)``."""
    from hpc_patterns_tpu_torch.comm import migration_dma as md

    dev = torch.device("cuda")
    checked = []
    for n_pages, page, dt in MIGRATION_CASES:
        nbytes = n_pages * math.prod(page) * torch.tensor(
            [], dtype=dt).element_size()
        bits = torch.randint(0, 256, (nbytes,), generator=gen, device=dev,
                             dtype=torch.uint8)
        x = bits.view(dt).reshape(n_pages, -1)
        got = md.migration_exchange(x)
        want = md.migration_exchange_reference(x)
        md.synchronize()
        check(torch.equal(got.view(torch.uint8), want.view(torch.uint8))
              and torch.equal(got.view(torch.uint8).flatten(), bits),
              f"migration_exchange {n_pages} x {page} {dt}: == plain, "
              "byte for byte")
        checked.append({"n_pages": n_pages, "page": list(page),
                        "dtype": str(dt).replace("torch.", "")})
    n0 = md.launches["migration_exchange"]
    big = torch.zeros(1, md.LANDING_LIMIT // 4 + 4, device=dev)
    try:
        md.migration_exchange(big)
        refused = False
    except md.MigrationDmaError:
        refused = True
    check(refused and md.launches["migration_exchange"] == n0,
          "an oversized slab raises MigrationDmaError before any launch")
    del big
    nbytes = MIGRATION_TIMED_PAGES * math.prod(MIGRATION_PAGE) * 2
    sets = [(torch.randn(MIGRATION_TIMED_PAGES, math.prod(MIGRATION_PAGE),
                         generator=gen, device=dev).bfloat16(),)
            for _ in range(math.ceil(150e6 / nbytes))]
    landing = torch.empty_like(sets[0][0])
    ms = device_ms(md.migration_exchange, sets)
    md.synchronize()
    plain = device_ms(md.migration_exchange_reference, sets)
    lib = device_ms(landing.copy_, sets)
    b_ms, b_by = bound(2.0 * nbytes, 0.0, BF16_FLOPS_PER_S)
    row = {"phase": "kernel", "name": "migration_exchange",
           "shape": {"n_pages": MIGRATION_TIMED_PAGES,
                     "page": list(MIGRATION_PAGE), "dtype": "bfloat16",
                     "bytes": nbytes, "page_chunk": md.PAGE_CHUNK},
           "checked": checked, "budget_refused": refused,
           "senders": md._senders(dev, min(md.PAGE_CHUNK,
                                           MIGRATION_TIMED_PAGES)
                                  * math.prod(MIGRATION_PAGE) * 2),
           "max_abs_err": 0.0, "tol": 0.0, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "library": "landing.copy_(x)",
           "bound_ms": b_ms, "bound_by": b_by, "input_sets": len(sets)}
    emit(row)
    return row


def run_app(main, argv, log):
    """An app's ``main`` in-process with a JSONL log and its printed lines
    in a file beside it: (exit code, records)."""
    import contextlib

    with open(log.with_suffix(".out"), "w") as out, \
            contextlib.redirect_stdout(out):
        code = main(argv + ["--log", str(log)])
    return code, [json.loads(ln) for ln in log.read_text().splitlines()]


def phase_comm():
    from hpc_patterns_tpu_torch import bench
    from hpc_patterns_tpu_torch.apps import (
        allreduce_app,
        interop_app,
        pingpong_app,
    )
    from hpc_patterns_tpu_torch.comm import fused
    from hpc_patterns_tpu_torch.comm.communicator import Communicator
    from hpc_patterns_tpu_torch.interop import device as idev

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    logs = ROOT / "build" / "smoke_comm"
    logs.mkdir(parents=True, exist_ok=True)
    counted = {"fused_allreduce": 0, "allgather_matmul": 0,
               "fused_permute": 0, "alias_inplace": 0}
    originals = {"fused_allreduce": fused.fused_allreduce,
                 "allgather_matmul": fused.allgather_matmul,
                 "fused_permute": fused.fused_permute}
    orig_alias = idev.alias_inplace

    def counting(name, fn):
        def wrapped(*a, **k):
            counted[name] += 1
            return fn(*a, **k)
        return wrapped

    for name, fn in originals.items():
        setattr(fused, name, counting(name, fn))
    idev.alias_inplace = counting("alias_inplace", orig_alias)
    for k in fused.launches:
        fused.launches[k] = 0
    idev.launches = 0
    by_path = {}  # fused_allreduce launches by entry point
    gen = torch.Generator(device=dev).manual_seed(3)
    try:
        # the busbw-vs-size curve, every point on its oracle
        t0 = time.perf_counter()
        code, recs = run_app(allreduce_app.main,
                             ["--sweep", "--min-p", "3", "-p", "25",
                              "--world", str(COMM_WORLD), "--device", "cuda",
                              "--repetitions", str(SWEEP_REPS),
                              "--warmup", "1"], logs / "sweep.jsonl")
        res = [r for r in recs if r.get("kind") == "result"]
        check(code == 0 and len(res) == 4 * 23 and all(r["success"]
                                                       for r in res),
              f"allreduce sweep: rc {code}, {sum(r['success'] for r in res)}"
              f"/{len(res)} points passed")
        by_path["sweep"] = fused.launches["fused_allreduce"]
        curve = {}
        for r in res:
            alg = r["name"][len("allreduce["):-1]
            curve.setdefault(alg, []).append(
                [r["elements"], r["elapsed_s"] * 1e3, r["busbw_gbps"]])
        emit({"phase": "comm", "sweep": "allreduce", "world": COMM_WORLD,
              "points": len(res), "repetitions": SWEEP_REPS,
              "curve_elements_ms_busbw": curve,
              "seconds": time.perf_counter() - t0})
        # one fused point each at world 2 and 8, and in bf16 and int32
        points = []
        for world, dtype in ((2, "float32"), (8, "float32"),
                             (COMM_WORLD, "bfloat16"), (COMM_WORLD, "int32")):
            code, recs = run_app(allreduce_app.main,
                                 ["-p", "20", "--algorithm", "fused",
                                  "--world", str(world), "--dtype", dtype,
                                  "--device", "cuda", "--repetitions",
                                  str(SWEEP_REPS)],
                                 logs / f"point_{world}_{dtype}.jsonl")
            (r,) = [x for x in recs if x.get("kind") == "result"]
            check(code == 0 and r["success"] and r["world"] == world,
                  f"fused point world {world} {dtype}")
            points.append([world, dtype, r["elapsed_s"] * 1e3,
                           r["busbw_gbps"]])
        emit({"phase": "comm", "fused_points_world_dtype_ms_busbw": points})
        by_path["points"] = fused.launches["fused_allreduce"] - sum(
            by_path.values())
        # the Communicator's fused consumer ops at the bench shapes, on
        # oracles of their own: rank-valued rows sum exactly to W(W-1)/2,
        # and integer-valued f32 products sum exactly in either order
        comm = Communicator({"x": COMM_WORLD}, "x", device=dev)
        x = comm.rank_filled(RING_ELEMENTS)
        bias = torch.randn(RING_ELEMENTS, generator=gen, device=dev)
        got = comm.allreduce_into(x, bias=bias, epilogue="relu")
        comm.synchronize()
        check(torch.equal(got, torch.relu(
            comm.expected_allreduce_value() + bias).expand_as(x)),
              "Communicator allreduce_into(bias, relu) on the oracle")
        by_path["communicator"] = fused.launches["fused_allreduce"] - sum(
            by_path.values())
        del x, got
        m, k, n = AGMM_SHAPE
        xa = torch.randint(-3, 4, (COMM_WORLD, m, k), generator=gen,
                           device=dev).float()
        wa = torch.randint(-3, 4, (COMM_WORLD, k, n), generator=gen,
                           device=dev).float()
        got = comm.allgather_matmul(xa, wa, "fused")
        want = comm.allgather_matmul(xa, wa, "collective")
        comm.synchronize()
        check(torch.equal(got, want), "Communicator allgather_matmul on "
              "integer-valued f32 == the collective route")
        # ping-pong on both routes, and the interop app
        for alg in ("collective", "fused"):
            t0 = time.perf_counter()
            code, recs = run_app(pingpong_app.main,
                                 ["--min-p", "3", "-p", "25", "--device",
                                  "cuda", "--algorithm", alg,
                                  "--repetitions", str(SWEEP_REPS)],
                                 logs / f"pingpong_{alg}.jsonl")
            res = [r for r in recs if r.get("kind") == "result"]
            check(code == 0 and len(res) == 23
                  and all(r["success"] for r in res),
                  f"pingpong_app --algorithm {alg} rc {code}")
            emit({"phase": "comm", "pingpong": alg,
                  "elements_us_gbps": [[r["elements"], r["latency_us"],
                                        r["bandwidth_gbps"]] for r in res],
                  "world": res[0]["world"],
                  "seconds": time.perf_counter() - t0})
        code, recs = run_app(interop_app.main, ["--device", "cuda"],
                             logs / "interop.jsonl")
        (r,) = [x for x in recs if x.get("kind") == "result"]
        check(code == 0 and r["success"] and all(r["checks"].values()),
              f"interop_app: {r['checks']}")
        emit({"phase": "comm", "interop": r["checks"]})
        # the port bench's collective keys
        detail = bench.fused_collective_detail(dev)
        emit({"phase": "comm", "bench_detail": detail})
        comm.synchronize()
        by_path["bench"] = fused.launches["fused_allreduce"] - sum(
            by_path.values())
    finally:
        for name, fn in originals.items():
            setattr(fused, name, fn)
        idev.alias_inplace = orig_alias
    launches = dict(fused.launches, alias_inplace=idev.launches)
    emit({"phase": "comm", "launches": launches, "counted": counted,
          "fused_allreduce_by_path": by_path,
          "seconds": time.perf_counter() - t_phase})
    launches["fused_allreduce_by_path"] = by_path
    for name in counted:
        check(launches[name] > 0 and launches[name] == counted[name],
              f"{name} launches == calls counted: {launches} {counted}")
    return launches


# ---------------------------------------------------------------- training


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def train_kernel_cases(gen, B, T, H, Hkv, D):
    """Kernels 1-4 at a training shape (self-attention, causal): the
    forward with lse, then the fused, dq and dkv backward kernels on the
    forward kernel's out/lse, each held against its plain version and
    called twice for equal bits; then each one's time beside its plain
    version's, its bound and SDPA's (forward; fwd+bwd less fwd for the
    backward rows), and both backward routes end to end."""
    from hpc_patterns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    bh, bkv = B * T * H * D * 2, B * T * Hkv * D * 2  # bf16 tensor bytes
    per = 3 * bh + 2 * bkv + 2 * B * H * T * 4
    sets = []
    for _ in range(n_sets(per)):
        q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        do = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
        out, lse = fa.flash_attention_block(q, k, v, 0, 0)
        lse = lse.permute(0, 2, 1).contiguous()
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
        sets.append((q, k, v, do, lse, delta.contiguous(), out))
    q, k, v, do, lse, delta, out = sets[0]
    shape = {"B": B, "T": T, "H": H, "Hkv": Hkv, "D": D, "dtype": "bfloat16"}
    rows = {}

    # forward with lse
    w_out, w_lse = fa.flash_attention_reference(q, k, v, True, with_lse=True)
    again = fa.flash_attention_block(q, k, v, 0, 0)
    torch.cuda.synchronize()
    err = (out.float() - w_out.float()).abs().max().item()
    lse_err = (lse - w_lse).abs().max().item()
    check(bool(torch.isfinite(out).all()), "flash fwd output finite")
    check(err <= PREFILL_ATOL and lse_err <= LSE_ATOL,
          f"flash fwd {shape}: max err {err}, lse {lse_err}")
    check(torch.equal(again[0], out) and torch.equal(
        again[1].permute(0, 2, 1), lse), "flash fwd deterministic")
    # multiply-adds of one causal product: T(T+1)/2 visible (q, k) pairs
    tri = B * H * D * T * (T + 1) / 2
    rows["flash_fwd_lse"] = {"max_abs_err": err, "lse_max_abs_err": lse_err,
                             "tol": PREFILL_ATOL, "lse_tol": LSE_ATOL,
                             "flops": 4 * tri,
                             "bytes": 2 * bh + 2 * bkv + B * H * T * 4}

    # the backward kernels
    args = (q, k, v, do, lse, delta)
    dk, dv, slab = fa.flash_attention_fused_bwd(*args)
    dq = fa.flash_attention_dq(*args)
    dk2, dv2 = fa.flash_attention_dkv(*args)
    w_dk, w_dv, w_slab = fa.flash_attention_fused_bwd_reference(*args)
    w_dq = fa.flash_attention_dq_reference(*args)
    seen = fa._written(T, T, 0, 0, True, dev)[:, None, :, None]
    seen = seen.expand_as(slab)
    pairs = {"fused_bwd": ((dk, w_dk), (dv, w_dv),
                           (slab[seen], w_slab[seen])),
             "dq": ((dq, w_dq),),
             "dkv": ((dk2, w_dk), (dv2, w_dv))}
    # each output against BWD_RTOL x its own max|plain|; the row reports
    # the absolute error and that relative reading beside it
    errs = {n: max(_rel_err(a, b) for a, b in ps) for n, ps in pairs.items()}
    abs_errs = {n: max((a.float() - b.float()).abs().max().item()
                       for a, b in ps) for n, ps in pairs.items()}
    del pairs
    re = fa.flash_attention_fused_bwd(*args)
    same = (torch.equal(re[0], dk) and torch.equal(re[1], dv)
            and torch.equal(re[2][seen], slab[seen])
            and torch.equal(fa.flash_attention_dq(*args), dq)
            and all(torch.equal(a, b) for a, b in
                    zip(fa.flash_attention_dkv(*args), (dk2, dv2))))
    torch.cuda.synchronize()
    check(same, f"backward kernels deterministic at {shape}")
    for name, e in errs.items():
        check(e <= BWD_RTOL, f"{name} {shape}: max err / max|plain| {e} > "
              f"{BWD_RTOL}")
    del w_dk, w_dv, w_slab, w_dq, re
    # bytes: inputs read once, outputs written once; of the slab, only the
    # slots of visible (kv tile, q tile) pairs are written by the kernel
    io = 2 * bh + 2 * bkv + 2 * B * H * T * 4  # q, do, k, v, lse, delta
    slab_bytes = sum(T - r for r in fa._unwritten_rows(T, T, 0, 0, True)) \
        * B * H * D * 2
    rows["fused_bwd"] = {"flops": 10 * tri, "bytes": io + 2 * bkv + slab_bytes,
                         "slab_written_bytes": slab_bytes,
                         "slab_bytes": slab.numel() * 2}
    rows["dq"] = {"flops": 6 * tri, "bytes": io + bh}
    rows["dkv"] = {"flops": 8 * tri, "bytes": io + 2 * bkv}
    for name, e in errs.items():
        rows[name].update(max_abs_err=abs_errs[name], max_rel_err=e,
                          rel_tol=BWD_RTOL,
                          rel_err_is="max abs err / max |plain|, worst "
                          "output")
    del dk, dv, slab, dq, dk2, dv2

    # times: the kernels, their plain versions, SDPA
    fwd = lambda q, k, v, do, lse, delta, out: fa.flash_attention_block(
        q, k, v, 0, 0)
    fwd_plain = lambda q, k, v, do, lse, delta, out: \
        fa.flash_attention_reference(q, k, v, True, with_lse=True)
    kern = {"fused_bwd": fa.flash_attention_fused_bwd,
            "dq": fa.flash_attention_dq, "dkv": fa.flash_attention_dkv}
    plain = {"fused_bwd": fa.flash_attention_fused_bwd_reference,
             "dq": fa.flash_attention_dq_reference,
             "dkv": fa.flash_attention_dkv_reference}
    rows["flash_fwd_lse"]["ms"] = device_ms(fwd, sets)
    rows["flash_fwd_lse"]["plain_ms"] = device_ms(fwd_plain, sets, n=5)
    for name in kern:
        rows[name]["ms"] = device_ms(lambda *a, f=kern[name]: f(*a[:6]),
                                     sets)
        rows[name]["plain_ms"] = device_ms(
            lambda *a, f=plain[name]: f(*a[:6]), sets, n=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = []
    for (q_, k_, v_, do_, *_) in sets:
        lq, lk, lv = (x.requires_grad_() for x in _sdpa_layout(q_, k_, v_))
        lib_sets.append((lq, lk, lv, do_.transpose(1, 2).contiguous()))
    lib_fwd = device_ms(lambda q, k, v, g: sdpa(q, k, v, is_causal=True),
                        lib_sets)
    lib_fb = device_ms(lambda q, k, v, g: torch.autograd.grad(
        sdpa(q, k, v, is_causal=True), (q, k, v), g), lib_sets)
    rows["flash_fwd_lse"]["library_ms"] = lib_fwd
    for name in kern:
        rows[name]["library_ms"] = lib_fb - lib_fwd
    # both routes of the whole backward (Delta, kernels, slab sum)
    for route in ("fused", "split"):
        rows[f"route_{route}_ms"] = device_ms(
            lambda q, k, v, do, lse, delta, out, r=route: fa._backward(
                q, k, v, out, lse, 0, 0, do, None, causal=True, scale=None,
                bwd=r), sets)
    rows["flash_fwd_lse"]["tflops"] = (rows["flash_fwd_lse"]["flops"]
                                       / rows["flash_fwd_lse"]["ms"] / 1e9)
    for name in ("flash_fwd_lse", *kern):
        r = rows[name]
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"],
                                             BF16_FLOPS_PER_S)
        emit({"phase": "kernel", "name": name, "shape": shape,
              "library": "sdpa (is_causal; backward = fwd+bwd less fwd)",
              "input_sets": len(sets), **r})
    plan = fa.plan_backward(B, T, T, H, D, 2, on_card=True)
    emit({"phase": "kernel", "name": "flash_bwd_routes", "shape": shape,
          "auto_plan": plan, "fused_route_ms": rows["route_fused_ms"],
          "split_route_ms": rows["route_split_ms"]})
    return rows


def block_case(gen):
    """``flash_attention_block`` on the card at offsets with Tq != Tk, a
    fully-future block and rows before every key (dead): out and lse
    against the plain forward, then gradients through out AND lse against
    autograd of the plain forward in f32, on both backward routes."""
    from hpc_patterns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    results = []
    for (Tq, Tk, qo, ko) in ((256, 512, 512, 128), (512, 256, 0, 192),
                             (256, 256, 0, 4096)):
        B, H, Hkv, D = 2, 8, 2, 128
        q = torch.randn(B, Tq, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Tk, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Tk, Hkv, D, generator=gen, device=dev).bfloat16()
        g = torch.randn(B, Tq, H, D, generator=gen, device=dev)
        gl = torch.randn(B, Tq, H, generator=gen, device=dev)
        ref_in = [x.float().requires_grad_() for x in (q, k, v)]
        w_out, w_lse = fa.flash_attention_reference(
            *ref_in, True, q_offset=qo, k_offset=ko, with_lse=True)
        w_lse = w_lse.permute(0, 2, 1)
        w_grads = torch.autograd.grad(
            (w_out * g).sum() + (w_lse.clamp_min(-30) * gl).sum(), ref_in)
        rec = {"Tq": Tq, "Tk": Tk, "q_offset": qo, "k_offset": ko}
        for bwd in ("fused", "split"):
            t_in = [x.detach().requires_grad_() for x in (q, k, v)]
            out, lse = fa.flash_attention_block(*t_in, qo, ko, bwd=bwd)
            grads = torch.autograd.grad(
                (out.float() * g).sum() + (lse.clamp_min(-30) * gl).sum(),
                t_in)
            torch.cuda.synchronize()
            err = (out.float() - w_out.float()).abs().max().item()
            lse_err = (lse - w_lse).abs().max().item()
            gerr = max(_rel_err(a, b) if b.abs().max() > 0 else
                       a.float().abs().max().item()
                       for a, b in zip(grads, w_grads))
            dead = max(0, min(Tq, ko - qo))  # rows before every key
            check(err <= PREFILL_ATOL and lse_err <= LSE_ATOL
                  and gerr <= BWD_RTOL,
                  f"block {rec} {bwd}: out {err} lse {lse_err} grads {gerr}")
            check(bool((out[:, :dead] == 0).all())
                  and bool((lse[:, :dead] < -1e29).all()),
                  f"block {rec}: {dead} dead rows give out 0, lse -1e30")
            rec[bwd] = {"max_abs_err": err, "lse_max_abs_err": lse_err,
                        "grad_err": gerr}
        rec["dead_rows"] = dead
        results.append(rec)
    emit({"phase": "kernel", "name": "flash_attention_block",
          "cases": results, "tol": PREFILL_ATOL, "lse_tol": LSE_ATOL,
          "grad_tol": BWD_RTOL})


def fused_mlp_cases(gen, N, D, F):
    """Kernels 8-9 at one layer's MLP of the chip model's step (bf16): the
    forward, the save-a forward, and the backward's dx and dW kernels,
    each against its plain version on the same inputs and twice for equal
    bits; then each one's time beside its plain version's, its bound and
    the dense chain's (``F.gelu(x @ w1, approximate="tanh") @ w2``; its
    autograd backward, fwd+bwd less fwd, for the backward rows), and the
    whole kernel backward (both kernels and the dW casts). Each row carries
    its launches' plan (CTAs a cluster, tiles, ring slots, grid,
    ``cudaOccupancyMaxActiveClusters``, waves); the forwards must run as
    clusters of more than one CTA at d_model 1024."""
    from hpc_patterns_tpu_torch import bench_mlp
    from hpc_patterns_tpu_torch.ops import fused_mlp as fm

    dev = torch.device("cuda")
    nd, df = N * D * 2, D * F * 2  # bf16 bytes of x (or dy) and one weight
    sets = []
    for _ in range(n_sets(2 * nd + 2 * df)):
        x = torch.randn(N, D, generator=gen, device=dev).bfloat16()
        w1 = (torch.randn(D, F, generator=gen, device=dev)
              * D ** -0.5).bfloat16()
        w2 = (torch.randn(F, D, generator=gen, device=dev)
              * F ** -0.5).bfloat16()
        dy = torch.randn(N, D, generator=gen, device=dev).bfloat16()
        sets.append((x, w1, w2, dy))
    x, w1, w2, dy = sets[0]
    shape = {"N": N, "D": D, "F": F, "dtype": "bfloat16"}
    rows = {}

    def errs(pairs, tol):
        rel = max(_rel_err(a, b) for a, b in pairs)
        ab = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        return {"max_abs_err": ab, "max_rel_err": rel, "rel_tol": tol,
                "rel_err_is": "max abs err / max |plain|, worst output"}

    y = fm.fused_mlp_forward(x, w1, w2)
    ys, a = fm.fused_mlp_forward(x, w1, w2, save_a=True)
    w_y, w_a = fm.fused_mlp_forward_reference(x, w1, w2, save_a=True)
    same = (torch.equal(fm.fused_mlp_forward(x, w1, w2), y)
            and torch.equal(ys, y))
    rows["fused_mlp_fwd"] = errs([(y, w_y)], MLP_RTOL)
    rows["fused_mlp_fwd_save_a"] = errs([(ys, w_y), (a, w_a)], MLP_RTOL)
    del w_y, w_a, ys, a
    dx, g, da = fm.fused_mlp_bwd_dx(x, w1, w2, dy)
    w_dx, w_g, w_da = fm.fused_mlp_bwd_dx_reference(x, w1, w2, dy)
    rows["fused_mlp_bwd_dx"] = errs([(dx, w_dx), (g, w_g), (da, w_da)],
                                    MLP_RTOL)
    del w_dx, w_g, w_da
    dw1, dw2 = fm.fused_mlp_bwd_dw(x, g, da, dy)
    rows["fused_mlp_bwd_dw"] = errs(
        list(zip((dw1, dw2), fm.fused_mlp_bwd_dw_reference(x, g, da, dy))),
        MLP_DW_RTOL)
    same = same and all(torch.equal(p, q) for p, q in zip(
        fm.fused_mlp_bwd_dx(x, w1, w2, dy), (dx, g, da))) and all(
        torch.equal(p, q) for p, q in zip(fm.fused_mlp_bwd_dw(x, g, da, dy),
                                          (dw1, dw2)))
    torch.cuda.synchronize()
    check(same and bool(torch.isfinite(y).all()),
          f"fused MLP kernels finite and deterministic at {shape}")
    for name, r in rows.items():
        check(r["max_rel_err"] <= r["rel_tol"],
              f"{name} {shape}: max err / max|plain| {r['max_rel_err']} > "
              f"{r['rel_tol']}")
    del dx, dw1, dw2

    # operations (2 N D F per block product) and bytes (inputs read once,
    # outputs written once) of each kernel's function
    prod = 2 * N * D * F
    rows["fused_mlp_fwd"].update(flops=2 * prod, bytes=2 * nd + 2 * df)
    rows["fused_mlp_fwd_save_a"].update(flops=2 * prod,
                                        bytes=2 * nd + 2 * df + N * F * 2)
    rows["fused_mlp_bwd_dx"].update(flops=3 * prod,
                                    bytes=4 * nd + 2 * df + 2 * N * F * 2)
    rows["fused_mlp_bwd_dw"].update(flops=2 * prod,
                                    bytes=2 * nd + 2 * N * F * 2 + 4 * df)
    gda = [fm.fused_mlp_bwd_dx(*st)[1:] for st in sets]
    kern = {"fused_mlp_fwd": lambda x, w1, w2, dy, g, da:
            fm.fused_mlp_forward(x, w1, w2),
            "fused_mlp_fwd_save_a": lambda x, w1, w2, dy, g, da:
            fm.fused_mlp_forward(x, w1, w2, save_a=True),
            "fused_mlp_bwd_dx": lambda x, w1, w2, dy, g, da:
            fm.fused_mlp_bwd_dx(x, w1, w2, dy),
            "fused_mlp_bwd_dw": lambda x, w1, w2, dy, g, da:
            fm.fused_mlp_bwd_dw(x, g, da, dy)}
    plain = {"fused_mlp_fwd": lambda x, w1, w2, dy, g, da:
             fm.fused_mlp_forward_reference(x, w1, w2),
             "fused_mlp_fwd_save_a": lambda x, w1, w2, dy, g, da:
             fm.fused_mlp_forward_reference(x, w1, w2, save_a=True),
             "fused_mlp_bwd_dx": lambda x, w1, w2, dy, g, da:
             fm.fused_mlp_bwd_dx_reference(x, w1, w2, dy),
             "fused_mlp_bwd_dw": lambda x, w1, w2, dy, g, da:
             fm.fused_mlp_bwd_dw_reference(x, g, da, dy)}
    args = [(*st, *gd) for st, gd in zip(sets, gda)]
    for name in kern:
        rows[name]["ms"] = device_ms(kern[name], args)
        rows[name]["plain_ms"] = device_ms(plain[name], args, n=5)
    route_ms = device_ms(lambda x, w1, w2, dy, g, da: fm._backward_kernel(
        x, w1, w2, dy, dict(block_t=512, block_f=512)), args)
    del gda, args
    gelu = torch.nn.functional.gelu
    lib_sets = [tuple(t.clone().requires_grad_() for t in st[:3]) + st[3:]
                for st in sets]
    lib_fwd = device_ms(lambda x, w1, w2, dy: gelu(
        x @ w1, approximate="tanh") @ w2, lib_sets)
    lib_fb = device_ms(lambda x, w1, w2, dy: torch.autograd.grad(
        gelu(x @ w1, approximate="tanh") @ w2, (x, w1, w2), dy), lib_sets)
    for name in rows:
        r = rows[name]
        r["launch_plan"] = bench_mlp.plan(name.replace("fused_mlp_", ""), N,
                                          D, F)
        check("fwd" not in name or D != 1024
              or r["launch_plan"][0]["cluster"] > 1,
              f"{name} runs as clusters at D 1024: {r['launch_plan']}")
        r["library_ms"] = lib_fwd if "fwd" in name else lib_fb - lib_fwd
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"],
                                             BF16_FLOPS_PER_S)
        emit({"phase": "kernel", "name": name, "shape": shape,
              "library": "gelu(x @ w1, tanh) @ w2" + (
                  "" if "fwd" in name else
                  " autograd backward (fwd+bwd less fwd; the whole "
                  "backward)"),
              "input_sets": len(sets), **r})
    bwd_bound, _ = bound(0, 5 * prod, BF16_FLOPS_PER_S)
    emit({"phase": "kernel", "name": "fused_mlp_bwd_route", "shape": shape,
          "route_ms": route_ms, "bound_ms": bwd_bound,
          "bound_is": "the TPU kernel's 5 block products at 989 TF/s",
          "library_ms": lib_fb - lib_fwd})
    return rows


def _leaf_names(tree, prefix="") -> list:
    """The leaf paths of a nested dict, in ``tree_leaves``'s order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _cosine_gaps(names, a, b) -> dict:
    """1 - cosine of each pair of gradient leaves, by leaf name (in f64,
    so the reading sits above the sum's own rounding)."""
    gaps = {}
    for n, x, y in zip(names, a, b):
        x, y = x.double().flatten(), y.double().flatten()
        gaps[n] = 1.0 - (x @ y / (x.norm() * y.norm())).item()
    return gaps


def _train_run(argv, log) -> dict:
    """``train_app`` in-process with every launch count set to 0 just
    before and read just after, the gradient passes and decode steps
    counted, and the peak device memory from a reset just before."""
    from hpc_patterns_tpu_torch.apps import train_app
    from hpc_patterns_tpu_torch.models import decode as dec
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd
    from hpc_patterns_tpu_torch.ops import fused_mlp as fm

    passes = {"grad": 0, "decode": 0}
    orig_make, orig_decode = train_app.make_train_step, dec.decode_step

    def counting_make(cfg, **kw):
        step = orig_make(cfg, **kw)

        def counted(*a):
            passes["grad"] += kw.get("accum_steps", 1)
            return step(*a)
        return counted

    def counting_decode(*a, **kw):  # --generate's steps
        passes["decode"] += 1
        return orig_decode(*a, **kw)

    for counts in (fa.launches, fm.launches):
        for key in counts:
            counts[key] = 0
    fd.launches["flash_decode"] = 0
    train_app.make_train_step = counting_make
    dec.decode_step = counting_decode
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        code, recs = run_app(train_app.main, argv + ["--device", "cuda"], log)
        app_s = time.perf_counter() - t0
    finally:
        train_app.make_train_step = orig_make
        dec.decode_step = orig_decode
    peak = torch.cuda.max_memory_allocated()
    steps = [r for r in recs if r.get("kind") == "step"]
    (res,) = [r for r in recs if r.get("kind") == "result"]
    return {"code": code, "res": res, "losses": [r["loss"] for r in steps],
            "steps_ms": [r["dt_s"] * 1e3 for r in steps],
            "launches": dict(fa.launches,
                             flash_decode=fd.launches["flash_decode"]),
            "mlp_launches": dict(fm.launches), "passes": passes,
            "app_seconds": app_s, "peak_bytes": peak,
            "peak_over_start_bytes": peak - base,
            "out": log.with_suffix(".out").read_text()}


# ------------------------------------------------ sampling and scenarios

# the sample phase: serve_app's sampling flags; the batch-of-8 check's
# prompt length and budget (the first 8 requests' prompts cut to it)
SAMPLE_ARGS = dict(temperature=0.8, top_k=50, seed=0)
SAMPLE_BATCH = dict(rows=8, prompt_len=256, budget=32)


def _counting_engine(cls, runs: list):
    """``cls`` with each ``run`` read around: kernel 1 and 6 launch counts
    set to 0 just before it and read just after, beside the admissions,
    the admissions whose padded prompt takes the flash prefill (the
    ``flash`` route, a multiple of 128, no prefix match: a matched
    admission prefills its tail on the plain route), the decode steps and
    the tokens of that run."""
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    class Counting(cls):
        def _admit(self, slot, req, need, *a, **kw):
            self._flash_admits += (
                self.cfg.decode_attn == "flash"
                and self._bucket_len(req.prompt.size) % 128 == 0
                and not kw.get("chain"))
            return super()._admit(slot, req, need, *a, **kw)

        def run(self, **kw):
            self._flash_admits = 0
            a0, d0 = self.admissions, self.decode_steps
            r0 = self.spec_rounds
            torch.cuda.synchronize()
            fa.launches["fwd"] = 0
            fd.launches["paged_decode"] = 0
            got = super().run(**kw)
            torch.cuda.synchronize()
            runs.append({"flash_prefill": fa.launches["fwd"],
                         "paged_decode": fd.launches["paged_decode"],
                         "flash_admissions": self._flash_admits,
                         "admissions": self.admissions - a0,
                         "decode_steps": self.decode_steps - d0,
                         "spec_rounds": self.spec_rounds - r0,
                         "n_layers": self.cfg.n_layers,
                         "decode_attn": self.cfg.decode_attn,
                         "draft_layers": (self.draft_cfg.n_layers
                                          if self.spec else 0),
                         "gamma": self.gamma, "out": dict(got)})
            return got

    return Counting


def _check_launches(run: dict, label: str) -> dict:
    """A counted engine run's kernel 1 and 6 launches against the calls it
    made: n_layers x its flash admissions and x its decode steps (on the
    ``gather`` route neither kernel runs: 0 of each)."""
    L = run["n_layers"]
    on_route = run.get("decode_attn", "flash") == "flash"
    if on_route:
        check(run["paged_decode"] > 0, f"{label}: kernel 6 launched")
    check(run["flash_prefill"] == L * run["flash_admissions"],
          f"{label}: prefill launches {run['flash_prefill']} == {L} x "
          f"{run['flash_admissions']} flash admissions")
    want = L * run["decode_steps"] if on_route else 0
    check(run["paged_decode"] == want,
          f"{label}: decode launches {run['paged_decode']} == {want} "
          f"({L} x {run['decode_steps']} decode steps on the "
          f"{run.get('decode_attn', 'flash')} route)")
    return {k: run[k] for k in ("flash_prefill", "paged_decode",
                                "flash_admissions", "admissions",
                                "decode_steps")}


def _sampler_times(keys, vocab: int, rows: int, chunk: int) -> dict:
    """The sampler's pieces at one decode step's shape (``rows`` x
    ``vocab`` f32 logits): each one's device time (CUDA events over 30
    back-to-back calls) and host time a call (enqueue, 50 calls, no
    sync inside), beside the greedy argmax's. ``sampled_pick`` draws its
    own noise (the standalone's step); the engine draws a chunk's noise
    in one pass (``chunk_noise``, ``chunk`` positions) and picks from a
    step's slice of it (``engine_pick``)."""
    from hpc_patterns_tpu_torch.models.decode import (
        _as_keys,
        _pick,
        gumbel_noise,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    sets = [(torch.randn(rows, vocab, generator=gen, device=dev),)
            for _ in range(4)]
    kd = _as_keys(keys[:rows], rows, dev)
    temps = torch.full((rows,), SAMPLE_ARGS["temperature"], device=dev)
    pos = torch.full((rows,), 600, dtype=torch.int32, device=dev)
    steps = pos[None].long() + torch.arange(1, chunk + 1, device=dev)[:, None]
    noise = gumbel_noise(kd, steps, vocab)[0]
    top_k = SAMPLE_ARGS["top_k"]
    fns = {"greedy_argmax": lambda lg: _pick(lg),
           "sampled_pick": lambda lg: _pick(lg, temps, top_k, kd, pos),
           "engine_pick": lambda lg: _pick(lg, temps, top_k, kd, pos,
                                           noise),
           "chunk_noise": lambda lg: gumbel_noise(kd, steps, vocab)}
    out = {}
    for name, fn in fns.items():
        ms = device_ms(fn, sets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            fn(*sets[i % len(sets)])
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        out[name] = {"device_ms": ms, "host_us": host_us}
    return out


def phase_sample(ctx):
    """Sampled serving at the serve phase's model and stream:
    ``serve_app --temperature 0.8 --top-k 50`` in-process (SUCCESS: every
    sequence on its standalone ``paged_generate`` with the request's key,
    tie-aware on the perturbed scores), the measured engine run's kernel
    1 and 6 launches against its counted prefills and decode steps, its
    tokens/s beside the greedy serve phase's; then 8 rows sampled in one
    batch against each alone."""
    from hpc_patterns_tpu_torch.apps import serve_app
    from hpc_patterns_tpu_torch.apps.serve_app import (
        CHIP_MODEL,
        CHIP_SERVE,
        TIE_TOL,
    )
    from hpc_patterns_tpu_torch.models.decode import (
        paged_generate,
        sample_key,
    )
    from hpc_patterns_tpu_torch.models.serving import tie_aware_compare

    t_phase = time.perf_counter()
    s, cfg, dev = CHIP_SERVE, ctx["cfg"], torch.device("cuda")
    logs = ROOT / "build" / "smoke_sample"
    logs.mkdir(parents=True, exist_ok=True)
    runs: list = []
    argv = ["--device", "cuda", "--dtype", CHIP_MODEL["dtype"],
            "--vocab", str(CHIP_MODEL["vocab"]),
            "--d-model", str(CHIP_MODEL["d_model"]),
            "--n-layers", str(CHIP_MODEL["n_layers"]),
            "--n-heads", str(CHIP_MODEL["n_heads"]),
            "--requests", str(SAMPLE_REQUESTS), "--slots", str(s["slots"]),
            "--chunk", str(s["chunk"]), "--page-size", str(s["page_size"]),
            "--prompt-len", str(s["prompt_len"]),
            "--budget", str(s["max_budget"]),
            "--temperature", str(SAMPLE_ARGS["temperature"]),
            "--top-k", str(SAMPLE_ARGS["top_k"]),
            "--seed", str(SAMPLE_ARGS["seed"])]
    orig = serve_app.make_requests, serve_app.ContinuousBatcher
    # the serve phase's stream (the benchmark's) in place of the app's
    serve_app.make_requests = lambda n, plen, budget, vocab, mix: \
        serve_app.bench_stream(n, plen, budget, vocab)
    serve_app.ContinuousBatcher = _counting_engine(
        serve_app.ContinuousBatcher, runs)
    try:
        code, recs = run_app(serve_app.main, argv, logs / "sample.jsonl")
    finally:
        serve_app.make_requests, serve_app.ContinuousBatcher = orig
    printed = (logs / "sample.out").read_text()
    (res,) = [r for r in recs if r["kind"] == "result"]
    check(code == 0 and "SUCCESS" in printed.splitlines()
          and res["oracle"]["mismatch"] == 0,
          f"sampled serve_app prints SUCCESS, oracle {res['oracle']}")
    measured = runs[-1]  # the warm-up ran first
    launches = _check_launches(measured, "sample")
    greedy = ctx["out"]
    differs = sum(not np.array_equal(measured["out"][sid], greedy[i])
                  for i, sid in enumerate(sorted(measured["out"])))
    check(differs > 0, f"sampling moved {differs} of {SAMPLE_REQUESTS} sequences "
                       "off the greedy ones")

    # one batch of 8 rows against each row alone (tie-aware on the
    # perturbed scores: bf16 matmuls at batch 8 and 1 may round a near-tie
    # either way)
    b = SAMPLE_BATCH
    prompts = np.stack([p[:b["prompt_len"]]
                        for p, _ in ctx["reqs"][:b["rows"]]])
    keys = np.stack([sample_key(SAMPLE_ARGS["seed"], i)
                     for i in range(b["rows"])])
    kw = dict(temperature=SAMPLE_ARGS["temperature"],
              top_k=SAMPLE_ARGS["top_k"], page_size=s["page_size"],
              device=dev, with_margins=True)
    batch, _ = paged_generate(ctx["params"], torch.from_numpy(prompts), cfg,
                              b["budget"], key=keys, **kw)
    batch = batch.cpu().numpy()
    alone = {"exact": 0, "near_tie": 0, "mismatch": 0}
    for i in range(b["rows"]):
        want, margins = paged_generate(
            ctx["params"], torch.from_numpy(prompts[i:i + 1]), cfg,
            b["budget"], key=keys[i], **kw)
        alone[tie_aware_compare(batch[i], want[0].cpu().numpy(),
                                margins[0].cpu().numpy(),
                                TIE_TOL[cfg.dtype])] += 1
    check(alone["mismatch"] == 0, f"batch of 8 vs alone: {alone}")
    sampler = _sampler_times(keys, cfg.vocab, s["slots"], s["chunk"])
    emit({"phase": "sample", "sampling": SAMPLE_ARGS,
          "tokens_per_s": res["tokens_per_s"],
          "greedy_tokens_per_s": ctx["tokens_per_s"],
          "served_tokens": res["served_tokens"], "oracle": res["oracle"],
          "tie_tol": TIE_TOL[cfg.dtype], "launches": launches,
          "differs_from_greedy": differs, "batch_vs_alone": alone,
          "batch_shape": SAMPLE_BATCH, "sampler": sampler,
          "seconds": time.perf_counter() - t_phase})
    return launches


# phase scenario's bursty part serves the first 4 of
# scenario_full_config's 32 requests (cut for the run's time: 16 until
# phases stencil and launch joined and a run took 832 s, 8 until phase
# elastic joined; the first 4 hold budgets 256/128/256/256, so the stall
# every 12 rounds still fires)
SCENARIO_BURSTY_REQUESTS = 4


def phase_scenario():
    """The robustness row at the chip widths: (a) the staged chaos
    schedule (page 16, 3 slots, pool 25, the ladder over 192, two seeded
    50 ms stalls, arrivals on the engine's progress clock), whose pool
    forces a preemption; (b) the bursty stream at the chip shape (page
    256, 8 slots, the first SCENARIO_BURSTY_REQUESTS of its 32 requests
    at 16 rps on the wall clock, pool 2.5 rows,
    high-water 0.95, a stall every 12 rounds). Each through
    ``bench_serving.run_scenario``: every served sequence (resumed ones
    included) on its standalone, the timed engine run's kernel 1 and 6
    launches against its counted calls; tokens/s, goodput, preemptions,
    sheds, the attribution shares, the budget breaches and the static
    baseline printed; each part's request trace and breach records land
    in ``build/smoke_scenario/<part>.jsonl`` for phase fit."""
    import dataclasses

    from hpc_patterns_tpu_torch import bench_serving as bs

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out, launches = {}, {"flash_prefill": 0, "paged_decode": 0}
    logs = ROOT / "build" / "smoke_scenario"
    logs.mkdir(parents=True, exist_ok=True)
    ctx = {"logs": {}, "budget_breaches": {}}
    orig = bs.ContinuousBatcher
    bursty = bs.scenario_full_config(dev)
    first = bursty["schedule"].requests[:SCENARIO_BURSTY_REQUESTS]
    bursty["schedule"] = dataclasses.replace(
        bursty["schedule"], requests=first,
        spec=dict(bursty["schedule"].spec, n=len(first)))
    for part, conf in (("staged", bs.scenario_smoke_config(dev, chip=True)),
                       ("bursty", bursty)):
        runs: list = []
        log = ctx["logs"][part] = logs / f"{part}.jsonl"
        log.unlink(missing_ok=True)
        bs.ContinuousBatcher = _counting_engine(orig, runs)
        try:
            res = bs.run_scenario(**conf, log=log)
        finally:
            bs.ContinuousBatcher = orig
        timed = _check_launches(runs[-1], f"scenario {part}")
        for k in launches:
            launches[k] += timed[k]
        check(res["stall_injections"] >= 1, f"scenario {part}: stalls fired")
        if part == "staged":
            check(res["preemptions"] >= 1,
                  f"scenario staged: preemptions {res['preemptions']} >= 1")
        out[part] = {k: v for k, v in res.items() if k != "schedule"}
        out[part]["launches"] = timed
        ctx["budget_breaches"][part] = res["budget_breaches"]
        out[part]["config"] = {
            k: conf.get(k) for k in ("page_size", "slots", "chunk",
                                     "pool_pages", "pages_per_seq",
                                     "chaos_spec", "admit_highwater",
                                     "arrival_round_s")}
        out[part]["config"]["buckets"] = list(conf["buckets"])
        out[part]["config"]["schedule"] = conf["schedule"].spec
    emit({"phase": "scenario", **out,
          "seconds": time.perf_counter() - t_phase})
    return launches, ctx


# phase fit: serve_app's record and replay legs serve 4 requests of the
# serve phase's stream (cut from 16: each leg serves them twice and runs
# every sequence's standalone); the --fit row serves 8 of
# fit_full_config's 32 requests (16 until phase pipeline joined; the
# first 8 hold prompts of 320, which the default ladder pads to 512, so
# the fitted ladder's padding win stays strict), timed once (JAX's reps
# 2); the collect
# leg's two processes run one fused point of 2^20 f32 a rank at 4 logical
# ranks; the gate's bench rounds measure each pass for 0.05 s after 50
# calibration passes (the bench's defaults: 1 s, 1000; 100 until phase
# pipeline joined)
FIT_REQUESTS = 4
FIT_ROW = {"n": 8, "reps": 1}
FIT_COLLECT = dict(p=20, world=4, repetitions=5)
FIT_GATE = ["--target-s", "0.05", "--cal-passes", "50"]
FIT_CUTS = {"serve_app_requests": f"16 -> {FIT_REQUESTS}",
            "fit_row": f"32 requests x 2 reps -> {FIT_ROW['n']} x "
                       f"{FIT_ROW['reps']}",
            "gate_bench": "per-pass 1 s -> 0.05 s, calibration 1000 -> 50"}


def _fit_serve(argv_extra, log):
    """serve_app in-process at the serve phase's model and stream (the
    benchmark's), its engine runs counted: (exit code, records, printed
    lines, counted runs)."""
    from hpc_patterns_tpu_torch.apps import serve_app
    from hpc_patterns_tpu_torch.apps.serve_app import CHIP_MODEL, CHIP_SERVE

    s = CHIP_SERVE
    argv = ["--device", "cuda", "--dtype", CHIP_MODEL["dtype"],
            "--vocab", str(CHIP_MODEL["vocab"]),
            "--d-model", str(CHIP_MODEL["d_model"]),
            "--n-layers", str(CHIP_MODEL["n_layers"]),
            "--n-heads", str(CHIP_MODEL["n_heads"]),
            "--requests", str(FIT_REQUESTS), "--slots", str(s["slots"]),
            "--chunk", str(s["chunk"]), "--page-size", str(s["page_size"]),
            "--prompt-len", str(s["prompt_len"]),
            "--budget", str(s["max_budget"]), *argv_extra]
    runs: list = []
    orig = serve_app.make_requests, serve_app.ContinuousBatcher
    serve_app.make_requests = lambda n, plen, budget, vocab, mix: \
        serve_app.bench_stream(n, plen, budget, vocab)
    serve_app.ContinuousBatcher = _counting_engine(orig[1], runs)
    try:
        code, recs = run_app(serve_app.main, argv, log)
    finally:
        serve_app.make_requests, serve_app.ContinuousBatcher = orig
    return code, recs, log.with_suffix(".out").read_text().splitlines(), runs


def _fit_record_replay(logs) -> tuple[dict, dict]:
    """(a): serve_app --explain records a run log, the autofit CLI fits a
    config from it, serve_app --autofit replays it."""
    from hpc_patterns_tpu_torch.harness import autofit

    out, launches = {}, {"flash_prefill": 0, "paged_decode": 0}
    log, digest = logs / "run.jsonl", logs / "digest.json"
    code, recs, printed, runs = _fit_serve(
        ["--explain", "--explain-out", str(digest)], log)
    (res,) = [r for r in recs if r["kind"] == "result"]
    check(code == 0 and "SUCCESS" in printed
          and res["oracle"]["mismatch"] == 0,
          f"fit: serve_app --explain prints SUCCESS, oracle {res['oracle']}")
    dig = json.loads(digest.read_text())
    check(dig["n"] == FIT_REQUESTS
          and any(r["kind"] == "reqtrace" for r in recs)
          and any(ln.startswith("request forensics") for ln in printed),
          f"fit: the attribution table, the digest of {dig['n']} requests "
          "and a kind=reqtrace record")
    timed = _check_launches(runs[-1], "fit record")
    out["record"] = {"tokens_per_s": res["tokens_per_s"],
                     "oracle": res["oracle"], "launches": timed,
                     "coverage_frac": dig["coverage_frac"],
                     "ttft_p99_queue_share": dig["ttft_p99_queue_share"],
                     "tpot_p99_stall_share": dig["tpot_p99_stall_share"]}
    for k in launches:
        launches[k] += timed[k]

    fitted = logs / "fitted.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.harness.autofit", str(log), "--emit",
         str(fitted)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    check(proc.returncode == 0, f"fit: autofit --emit exits 0 "
          f"({proc.stdout.strip()} {proc.stderr.strip()[-500:]})")
    cfg = autofit.load_fitted(fitted)
    lad = cfg["ladder"]
    check(lad is not None and lad["expected_padding"]
          <= lad["default_expected_padding"],
          f"fit: a ladder section, fitted E[pad] <= the default's ({lad})")
    out["fitted"] = {"ladder": lad["buckets"],
                     "default_ladder": lad["default_ladder"],
                     "expected_padding": lad["expected_padding"],
                     "default_expected_padding":
                         lad["default_expected_padding"],
                     "sections": [k for k in ("ladder", "residency",
                                              "placement", "autoscaler",
                                              "blame") if cfg.get(k)],
                     "blame": cfg["blame"]}

    code, recs, printed, runs = _fit_serve(["--autofit", str(fitted)],
                                           logs / "replay.jsonl")
    (res,) = [r for r in recs if r["kind"] == "result"]
    from hpc_patterns_tpu_torch.apps.serve_app import CHIP_SERVE

    ladder = list(autofit.ladder_from(cfg, max_seq=CHIP_SERVE["prompt_len"]))
    check(code == 0 and "SUCCESS" in printed
          and f"autofit ladder from {fitted}: {ladder}" in printed
          and res["prompt_buckets"] == ladder
          and res["oracle"]["mismatch"] == 0,
          f"fit: serve_app --autofit serves the fitted ladder {ladder} to "
          f"SUCCESS, every sequence on its standalone ({res['oracle']})")
    timed = _check_launches(runs[-1], "fit replay")
    out["replay"] = {"tokens_per_s": res["tokens_per_s"],
                     "oracle": res["oracle"], "launches": timed,
                     "prompt_buckets": res["prompt_buckets"]}
    for k in launches:
        launches[k] += timed[k]
    return out, launches


def _fit_row(scenario_ctx, logs) -> tuple[dict, dict]:
    """(b): bench_serving's --fit row at fit_full_config (FIT_ROW) on the
    card,
    every engine run's launches counted; then the explain CLI and the
    budget evaluation over the scenario phase's request traces."""
    from hpc_patterns_tpu_torch import bench_serving as bs
    from hpc_patterns_tpu_torch.harness import budget, slo
    from hpc_patterns_tpu_torch.harness.report import load_records

    dev = torch.device("cuda")
    runs: list = []
    orig = bs.ContinuousBatcher
    bs.ContinuousBatcher = _counting_engine(orig, runs)
    try:
        res = bs.run_fitted(**dict(bs.fit_full_config(dev), **FIT_ROW),
                            quiet=True)
    finally:
        bs.ContinuousBatcher = orig
    launches = {"flash_prefill": 0, "paged_decode": 0}
    for i, run in enumerate(runs):
        timed = _check_launches(run, f"fit row run {i}")
        for k in launches:
            launches[k] += timed[k]
    oracle = res["oracle"]
    legs = {"default": FIT_ROW["n"], "fitted": FIT_ROW["n"],
            "blame_recorded": 5, "blame_fitted": 5}
    check(res["expected_padding_fitted"] < res["expected_padding_default"]
          and all(oracle[k]["exact"] + oracle[k]["near_tie"] == n
                  for k, n in legs.items()),
          f"fit row: strict padding win (E[pad] "
          f"{res['expected_padding_default']} -> "
          f"{res['expected_padding_fitted']}), every leg on its "
          f"standalone ({oracle})")
    check(res["blame_segment"] == "prefetch_wait"
          and res["blame_share_fitted"] < res["blame_share_default"],
          f"fit row: the blame A/B blamed prefetch_wait and shrank it "
          f"({res['blame_share_default']} -> {res['blame_share_fitted']})")
    out = {k: res[k] for k in (
        "default_goodput_tok_s", "fitted_goodput_tok_s", "autofit_gain_frac",
        "t_default", "t_fitted", "tokens", "ladder_default", "ladder_fitted",
        "expected_padding_default", "expected_padding_fitted",
        "config_sections", "oracle")}
    out["engine_runs"] = len(runs)
    out["blame_ab"] = {k: res[k] for k in res if k.startswith("blame")}

    targets = slo.targets_from_classes(bs.SCENARIO_CLASSES)
    out["scenario_traces"] = {}
    for part, log in scenario_ctx["logs"].items():
        dig_path = logs / f"scenario_{part}.digest.json"
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.harness.explain", str(log), "-o",
             str(dig_path)], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0 and "request forensics" in proc.stdout,
              f"fit: explain CLI over the scenario's {part} trace "
              f"({proc.stderr.strip()[-500:]})")
        recs = load_records([log])
        (snap,) = [r for r in recs if r.get("kind") == "reqtrace"]
        breaches = budget.evaluate(snap, targets)
        n_records = sum(r.get("kind") == "slo_budget" for r in recs)
        check(len(breaches) == n_records
              == scenario_ctx["budget_breaches"][part],
              f"fit: scenario {part} budget breaches {len(breaches)} == "
              f"its slo_budget records {n_records} == the row's")
        dig = json.loads(dig_path.read_text())
        out["scenario_traces"][part] = {
            "budget_breaches": len(breaches),
            "breached_segments": sorted(budget.breached_segments(breaches)),
            "coverage_frac": dig["coverage_frac"],
            "ttft_p99_queue_share": dig["ttft_p99_queue_share"],
            "tpot_p99_stall_share": dig["tpot_p99_stall_share"],
            "table": proc.stdout.splitlines()[:4]}
    return out, launches


_RANK_MAIN = (
    "import json, sys\n"
    "from hpc_patterns_tpu_torch.apps import allreduce_app\n"
    "from hpc_patterns_tpu_torch.comm import fused\n"
    "rc = allreduce_app.main(sys.argv[1:])\n"
    "print(json.dumps({'fused_allreduce': fused.launches['fused_allreduce']"
    "}))\n"
    "sys.exit(rc)\n")


def _fit_collect(logs) -> tuple[dict, int]:
    """(c): two processes of allreduce_app --algorithm fused --trace (its
    ``main``, as ``python -m`` runs it, each printing its kernel 11
    launch count after) under one HPCPAT_TRACE_DIR, then the collect CLI
    over that directory, then the report over its trace_merged record."""
    import os
    import shutil

    from hpc_patterns_tpu_torch.harness import report

    ranks = logs / "ranks"
    shutil.rmtree(ranks, ignore_errors=True)
    c = FIT_COLLECT
    argv = ["--algorithm", "fused", "--trace", "-p", str(c["p"]),
            "--world", str(c["world"]), "--repetitions",
            str(c["repetitions"]), "--device", "cuda"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, HPCPAT_TRACE_DIR=str(ranks),
                   HPCPAT_PROCESS_ID=str(rank), HPCPAT_NUM_PROCESSES="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_MAIN, *argv,
             "--log", str(logs / f"rank{rank}.jsonl")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            outs.append((proc.returncode, stdout, stderr))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (rc, stdout, stderr) in enumerate(outs):
        check(rc == 0 and "SUCCESS" in stdout,
              f"fit: rank {rank} allreduce_app exits 0 with SUCCESS "
              f"(rc {rc}: {stderr.strip()[-500:]})")
    launches = [json.loads(o[1].strip().splitlines()[-1])["fused_allreduce"]
                for o in outs]
    check(all(n > 0 for n in launches),
          f"fit: kernel 11 launched in both rank processes ({launches})")

    merged, rollup_path = logs / "merged.json", logs / "rollup.json"
    clog = logs / "collect.jsonl"
    clog.unlink(missing_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.harness.collect", str(ranks), "-o",
         str(merged), "--rollup-out", str(rollup_path), "--log", str(clog)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"fit: collect exits 0 "
          f"({proc.stderr.strip()[-500:]})")
    chrome = json.loads(merged.read_text())
    rollup = json.loads(rollup_path.read_text())
    lanes = {e["pid"] for e in chrome["traceEvents"]
             if e.get("name") == "process_name"}
    flows: dict = {}
    for e in chrome["traceEvents"]:
        if e.get("cat") == "collective" and e["ph"] in ("s", "t", "f"):
            flows.setdefault(e["id"], []).append(e["ph"])
    paired = all(p[0] == "s" and p[-1] == "f" and len(p) >= 2
                 for p in flows.values())
    check(len(lanes) == 2, f"fit: 2 pid lanes in the merge ({lanes})")
    check(rollup["n_matched"] >= 1 and len(flows) == rollup["n_matched"]
          and paired,
          f"fit: {rollup['n_matched']} matched collective(s), "
          f"{len(flows)} flow chain(s), paired {paired}")
    check(rollup["schedule"]["verdict"] == "consistent",
          f"fit: schedule verdict {rollup['schedule']['verdict']}")
    table = report.format_report(report.aggregate(
        report.load_records([clog])))
    line = [ln for ln in table.splitlines() if ln.startswith("trace_merged")]
    check(bool(line) and "2 rank(s)" in line[0]
          and str(rollup_path) in line[0],
          f"fit: report renders the trace_merged record ({line})")
    out = {"ranks": 2, "lanes": len(lanes), "n_matched": rollup["n_matched"],
           "n_unmatched": rollup["n_unmatched"], "flows": len(flows),
           "align": rollup["align"]["method"],
           "schedule": rollup["schedule"], "skew": rollup["skew"],
           "stragglers": rollup["stragglers"], "busy": rollup["busy"],
           "launches_by_rank": launches, "report_line": line[0],
           "config": FIT_COLLECT}
    return out, sum(launches)


def _fit_gate(logs) -> dict:
    """(d): two ``bench --gate DIR`` rounds into a scratch directory, the
    gate's table and exit code printed; then a copy of the newest round
    with its value halved must fail the gate."""
    import contextlib
    import shutil

    from hpc_patterns_tpu_torch import bench
    from hpc_patterns_tpu_torch.harness import regress

    gdir = logs / "gate"
    shutil.rmtree(gdir, ignore_errors=True)
    rounds = []
    for i in range(2):
        text = logs / f"gate{i}.out"
        with open(text, "w") as f, contextlib.redirect_stdout(f):
            rc = bench.main(["--gate", str(gdir), *FIT_GATE])
        rounds.append((rc, text.read_text()))
    rc, printed = rounds[-1]
    table = printed[printed.index("newest comparable"):]
    check(rc in (0, 1), f"fit: the gate's exit code {rc} is 0 or 1")
    check(all(k in table for k in ("headline value", "vs_baseline",
                                   "detail.fused_allreduce_gbps",
                                   "detail.allreduce_busbw_gbps")),
          "fit: the gate's table names the gated keys")
    newest = json.loads((gdir / "BENCH_r02.json").read_text())
    check(newest["parsed"] is not None, "fit: the second round parsed")
    halved = dict(newest, n=3, parsed=dict(
        newest["parsed"], value=newest["parsed"]["value"] / 2))
    (gdir / "BENCH_r03.json").write_text(json.dumps(halved))
    with open(logs / "gate_halved.out", "w") as f, \
            contextlib.redirect_stdout(f):
        rc_halved = regress.main(sorted(map(str, gdir.glob("BENCH_r*.json"))))
    check(rc_halved == 1, f"fit: a halved headline fails the gate "
          f"(rc {rc_halved})")
    return {"rcs": [r for r, _ in rounds], "table": table.splitlines(),
            "halved_rc": rc_halved,
            "values": [json.loads((gdir / f"BENCH_r0{n}.json").read_text())
                       ["parsed"]["value"] for n in (1, 2)]}


def phase_fit(scenario_ctx):
    """The observability-and-control layer on the card: (a) serve_app
    --explain records, the autofit CLI fits, serve_app --autofit replays
    (SUCCESS, the fitted ladder, every sequence on its standalone,
    kernel 1 and 6 launches against the counted calls); (b)
    bench_serving's --fit row at fit_full_config (strict padding win,
    both legs on their standalone; gain printed, not asserted), then the
    explain CLI and the budget evaluation over phase scenario's request
    traces; (c) two traced allreduce_app processes merged by the collect
    CLI (2 lanes, matched collectives with paired flows, a consistent
    schedule, the report's trace_merged line); (d) two bench --gate rounds
    and a halved copy that must fail the gate."""
    t_phase = time.perf_counter()
    logs = ROOT / "build" / "smoke_fit"
    logs.mkdir(parents=True, exist_ok=True)
    seconds = {}
    t = time.perf_counter()
    record, launches = _fit_record_replay(logs)
    seconds["record_fit_replay"] = time.perf_counter() - t
    t = time.perf_counter()
    row, row_launches = _fit_row(scenario_ctx, logs)
    seconds["fit_row"] = time.perf_counter() - t
    for k in launches:
        launches[k] += row_launches[k]
    t = time.perf_counter()
    collect, ring_launches = _fit_collect(logs)
    seconds["collect"] = time.perf_counter() - t
    launches["fused_allreduce"] = ring_launches
    t = time.perf_counter()
    gate = _fit_gate(logs)
    seconds["gate"] = time.perf_counter() - t
    emit({"phase": "fit", "record_fit_replay": record, "fit_row": row,
          "collect": collect, "gate": gate, "launches": launches,
          "cuts": FIT_CUTS, "card": smi("name,power.limit"),
          "seconds_by_part": seconds,
          "seconds": time.perf_counter() - t_phase})
    return launches, row["blame_ab"]


# phase tiered: tiered memory on the card. (b)'s second sharing leg runs
# the same stream's first SHARED_FLASH_REQUESTS requests on the flash
# route with a ladder off the multiples of 128 (the engine refuses flash
# with 128-multiple rungs), so kernel 6 reads shared pages; (d) trains
# phase train's model with the moments resident and offloaded; (e) times
# allreduce_app -H and -D. The whole script must end well inside its
# 1200 s limit on a host that runs it a third slower than the fastest
# seen, so (a) and (b) serve the first TIERED_OFFLOAD_REQUESTS and
# TIERED_SHARED_REQUESTS of their configs' streams (every leg serves its
# stream six or four times and runs each request's standalone; the pool
# of 9 of 24 pages and the templates are the configs' own; 12 and 24
# until phases stencil and launch joined and whole runs took 832 s, then
# 6 and 12 until one took 752 s)
TIERED_OFFLOAD_REQUESTS = 4
TIERED_SHARED_REQUESTS = 8
SHARED_FLASH_LADDER = (552, 600, 648, 664)
SHARED_FLASH_REQUESTS = 8
# phase train's 8 steps (at 4 the one static batch's loss had not yet
# fallen below its first step's, which train_app's check asks)
TIERED_TRAIN_STEPS = 8
TIERED_ALLREDUCE_P = (16, 20, 24)
TIERED_CUTS = {"allreduce": "p 3..25 sweep -> p 16, 20, 24 at -H and -D",
               "offload_requests": f"24 -> {TIERED_OFFLOAD_REQUESTS}",
               "shared_requests": f"48 -> {TIERED_SHARED_REQUESTS}",
               "shared_flash_leg": "48 requests -> the stream's first "
                                   f"{SHARED_FLASH_REQUESTS}"}


def _pin_watch(managers: list):
    """A ``ResidencyManager`` that counts the host-tier tensors it pushed
    and those of them that are not pinned (the tier must have none)."""
    from hpc_patterns_tpu_torch.memory import ResidencyManager
    from hpc_patterns_tpu_torch.memory.kinds import tree_tensors

    class Watched(ResidencyManager):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.host_tensors = self.unpinned = 0
            managers.append(self)

        def push_payload(self, payload, **kw):
            out = super().push_payload(payload, **kw)
            for t in tree_tensors(out):
                self.host_tensors += 1
                self.unpinned += not t.is_pinned()
            return out

    return Watched


def _mem_windows(rec) -> dict:
    """The flight recorder's mem.* device windows (CUDA-event clock):
    count, bytes, device seconds and the rate they imply."""
    out = {}
    for name in ("mem.prefetch", "mem.evict"):
        wins = [ev for ev in rec.events if ev[0] == "X"
                and ev[1] == "device" and ev[2] == name]
        nbytes = sum(ev[6]["bytes"] for ev in wins)
        dev_s = sum(ev[5] for ev in wins)
        out[name] = {"windows": len(wins), "bytes": nbytes,
                     "device_s": dev_s,
                     "event_clock": all(ev[6].get("clock") == "cuda_event"
                                        for ev in wins),
                     "gb_per_s": nbytes / dev_s / 1e9 if dev_s else None}
    return out


def _tiered_offload() -> tuple[dict, dict]:
    """(a) bench_serving's --offload row at offload_full_config (its
    stream's first TIERED_OFFLOAD_REQUESTS), under the
    flight recorder (both legs alike): every engine run's kernel 1 and 6
    launches counted, every host-tier tensor checked pinned, the mem.*
    windows' device time and rate."""
    from hpc_patterns_tpu_torch import bench_serving as bs
    from hpc_patterns_tpu_torch import memory as memlib
    from hpc_patterns_tpu_torch.harness import trace as tracelib

    dev = torch.device("cuda")
    runs: list = []
    managers: list = []
    orig_eng, orig_mgr = bs.ContinuousBatcher, memlib.ResidencyManager
    bs.ContinuousBatcher = _counting_engine(orig_eng, runs)
    memlib.ResidencyManager = _pin_watch(managers)
    rec = tracelib.configure(enabled=True, capacity=1 << 20)
    try:
        res = bs.run_offload(**dict(bs.offload_full_config(dev),
                                    n=TIERED_OFFLOAD_REQUESTS), quiet=True)
        windows = _mem_windows(rec)
    finally:
        tracelib.configure(enabled=False)
        bs.ContinuousBatcher, memlib.ResidencyManager = orig_eng, orig_mgr
    launches = {"flash_prefill": 0, "paged_decode": 0}
    for i, run in enumerate(runs):
        timed = _check_launches(run, f"offload row run {i}")
        for k in launches:
            launches[k] += timed[k]
    oracle = res["oracle"]
    check(res["swap_outs"] > 0 and res["swap_ins"] > 0
          and res["hbm_pool"] == 9 and res["full_pool"] == 24,
          f"offload: the cap (9 of 24 pages) forced paging "
          f"({res['swap_outs']}/{res['swap_ins']})")
    check(all(oracle[k]["exact"] + oracle[k]["near_tie"]
              == TIERED_OFFLOAD_REQUESTS for k in ("full", "tiered")),
          f"offload: both engines on their standalone ({oracle})")
    check(len(managers) == 2 and all(m.unpinned == 0 and m.host_tensors
                                     for m in managers),
          "offload: every host-tier tensor pinned "
          f"({[(m.host_tensors, m.unpinned) for m in managers]})")
    check(windows["mem.prefetch"]["windows"] > 0
          and windows["mem.prefetch"]["event_clock"],
          "offload: mem.prefetch windows timed by CUDA events on the side "
          "stream")
    out = {k: res[k] for k in (
        "offload_goodput_tok_s", "full_goodput_tok_s", "tokens_per_s_full",
        "tokens_per_s_tiered", "t_full", "t_tiered", "tokens",
        "prefetch_overlap_frac", "swap_outs", "swap_ins", "prefetch_bytes",
        "evict_bytes", "hbm_pool", "full_pool", "bubble_frac", "oracle")}
    out["mem_windows"] = windows
    out["host_tensors_pushed"] = [m.host_tensors for m in managers]
    out["engine_runs"] = len(runs)
    return out, launches


def _tail_delta(cfg, params, template, tails, rung, dev) -> dict:
    """The largest |difference| between paged_tail_prefill's tail K/V and
    logits and a monolithic paged_prefill's of the same prompt at
    ``rung``, the prefix pages written by a same-rung prefill of another
    prompt sharing ``template``."""
    from hpc_patterns_tpu_torch.models import decode as dec

    P = 256
    m = len(template) // P
    n = -(-rung // P)
    a, b = (np.concatenate([template, t]).astype(np.int32) for t in tails)
    pad = lambda x: np.pad(x, (0, rung - x.size))  # noqa: E731
    T = b.size
    cache = dec.init_paged_cache(cfg, 1, n, P, pool_pages=3 * n,
                                 table=np.arange(n)[None], device=dev)
    dec.paged_prefill(params, torch.from_numpy(pad(a))[None].to(dev), cfg,
                      cache, P, last_pos=a.size - 1)
    cache["table"] = torch.tensor([list(range(m)) + list(range(n, 2 * n - m))],
                                  dtype=torch.int32, device=dev)
    lt, _ = dec.paged_tail_prefill(
        params, torch.from_numpy(pad(b)[m * P:])[None].to(dev), cfg, cache,
        P, m, last_pos=T - 1 - m * P)
    cache["table"] = torch.arange(2 * n, 3 * n, dtype=torch.int32,
                                  device=dev)[None]
    lm, _ = dec.paged_prefill(params, torch.from_numpy(pad(b))[None].to(dev),
                              cfg, cache, P, last_pos=T - 1)
    torch.cuda.synchronize()
    d = {"rung": rung, "prefix": m * P, "tail": rung - m * P,
         "logits": float((lt - lm).abs().max())}
    for name in ("k", "v"):
        d[name] = max(float((pool[n:2 * n - m].float()
                             - pool[2 * n + m:3 * n].float()).abs().max())
                      for pool in cache[name])
    d["bitwise"] = d["logits"] == d["k"] == d["v"] == 0.0
    return d


def _tiered_shared() -> tuple[dict, dict]:
    """(b) bench_serving's --shared row at shared_full_config (its
    stream's first TIERED_SHARED_REQUESTS; gather, as JAX pins it), then one sharing leg of the stream's first requests on
    the flash route at SHARED_FLASH_LADDER (kernel 6 reading shared pages, its
    launches counted) held against the flash standalone; and the tail
    prefill's |difference| from a monolithic prefill at one template, on
    each ladder's rung."""
    import dataclasses

    from hpc_patterns_tpu_torch import bench_serving as bs
    from hpc_patterns_tpu_torch.harness import loadgen
    from hpc_patterns_tpu_torch.models.serving import pad_to_bucket

    dev = torch.device("cuda")
    conf = dict(bs.shared_full_config(dev), n=TIERED_SHARED_REQUESTS)
    runs: list = []
    orig = bs.ContinuousBatcher
    bs.ContinuousBatcher = _counting_engine(orig, runs)
    try:
        res = bs.run_shared(**conf, quiet=True)
    finally:
        bs.ContinuousBatcher = orig
    for i, run in enumerate(runs):
        _check_launches(run, f"shared row run {i}")
    n = conf["n"]
    oracle = res["oracle"]
    check(all(oracle[k]["exact"] + oracle[k]["near_tie"] == n
              for k in oracle) and res["prefill_skip_frac"] > 0.3
          and res["prefix_hits"] > 0,
          f"shared: both engines on their standalone ({oracle}), skip "
          f"{res['prefill_skip_frac']:.3f} > 0.3, hits {res['prefix_hits']}")
    out = {k: res[k] for k in (
        "shared_goodput_tok_s", "private_goodput_tok_s",
        "tokens_per_s_private", "tokens_per_s_shared", "t_private",
        "t_shared", "tokens", "prefill_skip_frac", "prefix_hits",
        "prefix_misses", "ladder", "pool_pages", "bubble_frac", "oracle")}

    # the flash leg: the same stream, the sharing engine only
    cfg = dataclasses.replace(conf["cfg"], decode_attn="flash")
    params = conf["params"]
    schedule = loadgen.make_shared_prefix_schedule(
        n, rate_rps=conf["rate_rps"], classes=bs.SCENARIO_CLASSES,
        n_templates=conf["n_templates"], template_len=conf["template_len"],
        tail_lens=conf["tail_lens"], budgets=conf["budgets"],
        tree_frac=conf["tree_frac"], seed=conf["seed"])
    leg = schedule.requests[:SHARED_FLASH_REQUESTS]
    prompts = {r.index: loadgen.materialize_prompt(schedule, r.index,
                                                   cfg.vocab)
               for r in leg}
    page = conf["page_size"]
    pps = max(bs.ContinuousBatcher.pages_needed(
        len(prompts[r.index]), r.max_new, page,
        padded_len=pad_to_bucket(SHARED_FLASH_LADDER, len(prompts[r.index])))
        for r in leg)
    flash_runs: list = []
    eng = _counting_engine(bs.ContinuousBatcher, flash_runs)(
        params, cfg, slots=conf["slots"], pool_pages=conf["slots"] * pps,
        pages_per_seq=pps, page_size=page, chunk=conf["chunk"],
        prompt_buckets=SHARED_FLASH_LADDER, prefix_cache=True, device=dev)
    t0 = time.perf_counter()
    got = eng.run(arrivals=[(r.t_arrival_s, dict(
        prompt=prompts[r.index], max_new=r.max_new, seq_id=r.index,
        priority=r.priority, deadline_s=r.deadline_s)) for r in leg])
    torch.cuda.synchronize()
    t_flash = time.perf_counter() - t0
    (run,) = flash_runs
    launches = _check_launches(run, "shared flash leg")
    check(launches["flash_prefill"] == 0,
          "shared flash leg: no rung takes kernel 1")
    tol = bs.TIE_TOL[cfg.dtype]
    verdicts = {"exact": 0, "near_tie": 0}
    for r in leg:
        want, margins = bs._standalone(params, cfg, prompts[r.index],
                                       r.max_new, page_size=page,
                                       device=dev)
        verdicts[bs._held(got[r.index], want, margins, tol,
                          f"shared flash seq {r.index}")] += 1
    tokens = sum(r.max_new for r in leg)
    check(eng._prefix.hits > 0
          and sum(verdicts.values()) == SHARED_FLASH_REQUESTS,
          f"shared flash leg: {verdicts}, hits {eng._prefix.hits}")
    out["flash_leg"] = {
        "ladder": SHARED_FLASH_LADDER, "requests": len(leg),
        "oracle": verdicts,
        "prefill_skip_frac": eng.prefill_skip_frac,
        "prefix_hits": eng._prefix.hits, "prefix_misses": eng._prefix.misses,
        "tokens_per_s": tokens / t_flash, "t": t_flash, **launches}
    # the tail's bits against a monolithic prefill at one template
    t0 = loadgen.materialize_prompt(schedule, 0, cfg.vocab)
    template = t0[:conf["template_len"]]
    rng = np.random.RandomState(19)
    tails = [rng.randint(0, cfg.vocab, size=40) for _ in range(2)]
    out["tail_prefill_delta"] = [
        _tail_delta(conf["cfg"], params, template, tails, res["ladder"][0],
                    dev),
        _tail_delta(cfg, params, template, tails, SHARED_FLASH_LADDER[0],
                    dev)]
    return out, {"paged_decode": launches["paged_decode"]}


def _tiered_train(logs) -> tuple[dict, dict]:
    """(d) train_app at phase train's model, TIERED_TRAIN_STEPS steps, the
    moments resident and then --offload-opt: equal losses and final params
    bit for bit, every moment leaf pinned between steps, kernels 1, 3 and
    4 launched n_layers x grad passes; each run's step time and the
    streamed step's prefetch overlap."""
    from hpc_patterns_tpu_torch.memory.kinds import tree_tensors
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.utils.checkpoint import _load

    argv = ["--steps", str(TIERED_TRAIN_STEPS), *TRAIN_BASE]
    pinned: list = []
    orig = tr._make_streamed_step

    def watched(*a, **kw):
        step = orig(*a, **kw)

        def run(params, opt_state, tokens):
            out = step(params, opt_state, tokens)
            pinned.append(all(t.is_pinned() for k in tr.MOMENTS
                              for t in tree_tensors(out[2][k])))
            return out
        return run

    result, launches = {}, {}
    for name, extra in (("resident", []), ("offload", ["--offload-opt"])):
        tr._make_streamed_step = watched
        try:
            r = _train_run(argv + extra + ["--checkpoint-dir",
                                           str(logs / name)],
                           logs / f"train_{name}.jsonl")
        finally:
            tr._make_streamed_step = orig
        check(r["code"] == 0, f"tiered train {name}: SUCCESS "
              f"({r['out'][-2000:]})")
        L = TRAIN_MODEL["n_layers"]
        g = r["passes"]["grad"]
        check(all(r["launches"][k] == L * g for k in ("fwd_lse", "dq",
                                                      "dkv")),
              f"tiered train {name}: fwd_lse/dq/dkv launches "
              f"{[r['launches'][k] for k in ('fwd_lse', 'dq', 'dkv')]} == "
              f"{L} x {g} grad passes")
        result[name] = {"losses": r["losses"], "steps_ms": r["steps_ms"],
                        "step_ms": r["res"]["step_time_s"] * 1e3,
                        "peak_bytes": r["peak_bytes"],
                        **{k: r["res"].get(k) for k in (
                            "prefetch_overlap_frac", "prefetch_bytes",
                            "evict_bytes") if name == "offload"}}
        launches[name] = {k: r["launches"][k] for k in ("fwd_lse", "dq",
                                                        "dkv")}
        result[name]["out_tail"] = r["out"].splitlines()[-4:]
    check(len(pinned) == TIERED_TRAIN_STEPS and all(pinned),
          f"tiered train: every moment leaf pinned between steps {pinned}")
    a, b = (_load(logs / n / f"step_{TIERED_TRAIN_STEPS}" / "params.pt",
                  torch.device("cpu")) for n in ("resident", "offload"))
    same = all(torch.equal(x, y) for x, y in zip(tr.tree_leaves(a),
                                                 tr.tree_leaves(b)))
    check(result["resident"]["losses"] == result["offload"]["losses"]
          and same,
          f"tiered train: losses {result['resident']['losses']} == "
          f"{result['offload']['losses']} and final params bit-equal "
          f"({same})")
    result["params_bit_equal"] = same
    moments = 2 * 4 * sum(x.numel() for x in tr.tree_leaves(a))
    result["moment_bytes"] = moments
    return result, {k: launches["offload"][k] for k in launches["offload"]}


def _tiered_allreduce(logs) -> tuple[dict, int]:
    """(e) allreduce_app --algorithm fused at TIERED_ALLREDUCE_P, -D then
    -H (each timed by the app, kernel 11's launches counted), and the two
    routes' results bit-equal on one operand a size."""
    from hpc_patterns_tpu_torch.apps import allreduce_app, common
    from hpc_patterns_tpu_torch.comm import fused
    from hpc_patterns_tpu_torch.memory import kinds

    comm = common.make_communicator("cuda", COMM_WORLD, even=True)
    rows = {}
    n_launch = 0
    for p in TIERED_ALLREDUCE_P:
        x = comm.rank_filled(1 << p, "float32")
        step = comm.jit_allreduce(x, "fused")
        want = step(x).cpu()
        xh = kinds.move_to_kind(comm.device, "pinned_host")(x)
        comm.synchronize()
        got = allreduce_app.host_resident(step, comm.device)(xh)
        comm.synchronize()
        check(got.is_pinned() and torch.equal(got, want),
              f"allreduce -H p={p}: pinned and bit-equal to -D")
        del x, xh, got, want
        rows[p] = {}
        for flag in ("-D", "-H"):
            fused.launches["fused_allreduce"] = 0
            code, recs = run_app(allreduce_app.main, [
                "-p", str(p), "--algorithm", "fused", flag, "--device",
                "cuda", "--world", str(COMM_WORLD)],
                logs / f"allreduce_{p}{flag}.jsonl")
            comm.synchronize()
            (res,) = [r for r in recs if r.get("kind") == "result"]
            check(code == 0 and res["success"],
                  f"allreduce_app {flag} p={p}: SUCCESS")
            check(res["memory_kind"] == ("pinned_host" if flag == "-H"
                                         else "device"),
                  f"allreduce_app {flag} p={p} ran in {res['memory_kind']}")
            if flag == "-H":
                n_launch += fused.launches["fused_allreduce"]
            rows[p][flag] = {"elapsed_ms": res["elapsed_s"] * 1e3,
                             "busbw_gbps": res["busbw_gbps"],
                             "launches": fused.launches["fused_allreduce"]}
    return rows, n_launch


def phase_tiered(blame_ab):
    """Tiered memory on the card: (a) the --offload row at
    offload_full_config (tiered == all-HBM == standalone, real paging,
    every host-tier tensor pinned, the mem.* windows' device time); (b)
    the --shared row at shared_full_config and a flash sharing leg (kernel
    6 on shared pages), the tail prefill's bits against a monolithic one;
    (c) the --slo-budget row (breaches exactly prefetch_wait) beside the
    --fit row's blame A/B from phase fit; (d) train_app --offload-opt
    against resident moments; (e) allreduce_app -H against -D."""
    import shutil

    from hpc_patterns_tpu_torch import bench_serving as bs

    t_phase = time.perf_counter()
    logs = ROOT / "build" / "smoke_tiered"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    seconds, launches = {}, {}
    t = time.perf_counter()
    offload, launches["offload"] = _tiered_offload()
    seconds["offload"] = time.perf_counter() - t
    t = time.perf_counter()
    shared, launches["shared_flash"] = _tiered_shared()
    seconds["shared"] = time.perf_counter() - t
    t = time.perf_counter()
    budget = bs.run_slo_budget(**bs.slo_budget_smoke_config("cuda"),
                               quiet=True)
    check(budget["budget_breach_segments"] == ["prefetch_wait"],
          f"slo-budget: breaches {budget['budget_breach_segments']}")
    seconds["slo_budget"] = time.perf_counter() - t
    t = time.perf_counter()
    train, launches["train"] = _tiered_train(logs)
    seconds["train"] = time.perf_counter() - t
    t = time.perf_counter()
    allreduce, launches["fused_allreduce"] = _tiered_allreduce(logs)
    seconds["allreduce"] = time.perf_counter() - t
    total = {"flash_prefill": launches["offload"]["flash_prefill"],
             "paged_decode": launches["offload"]["paged_decode"]
             + launches["shared_flash"]["paged_decode"],
             **launches["train"],
             "fused_allreduce": launches["fused_allreduce"]}
    emit({"phase": "tiered", "offload": offload, "shared": shared,
          "slo_budget": budget, "fit_blame_ab": blame_ab, "train": train,
          "allreduce": allreduce, "launches": total,
          "launches_by_part": launches, "cuts": TIERED_CUTS,
          "card": smi("name,power.limit"), "seconds_by_part": seconds,
          "seconds": time.perf_counter() - t_phase})
    return total


# phase spec: the aligned pair at make_draft_pair's card widths, cut from
# the JAX script's 400 / 400 steps to 100 / 100 (batch 16 x 256, the 2M
# token corpus uncut; 200 / 200 until phase analysis joined, when the
# pair's greedy agreement read 0.598 against a random draft's 0.0, and
# its E[min(p, q)] 0.770 against 0.330: the checks ask 0.05 over);
# gamma 4 throughout (serve_app's default)
SPEC_PAIR_STEPS = (100, 100)
SPEC_GAMMA = 4
# the engine legs' stream: prompts of 256 tokens from the pair's Markov
# process on a disjoint path (draw_seed 777, as JAX's bench_speculative),
# budgets 64/128/256 at 0.5/0.3/0.2 (RandomState(7)); page 256, 8 slots,
# 4 rounds a dispatch (a round emits up to gamma + 1 tokens, so about the
# plain engine's 16-step chunk); 4 requests (16, then 8, before the run
# had to end well inside its limit on slower hosts), the int8 leg the
# first 2 (4 until phase pipeline joined);
# serve_app's leg the serve phase's first SPEC_APP_REQUESTS requests (2;
# 4 until phase pipeline joined)
SPEC_STREAM = dict(requests=4, prompt_len=256, budgets=(64, 128, 256),
                   p=(0.5, 0.3, 0.2))
SPEC_CHUNK = 4
SPEC_INT8_REQUESTS = 2
SPEC_APP_REQUESTS = 2
# the benchmark: the gamma sweep and the batched rows at 8 tokens a call
# (at JAX's 256 the vmap impl's eight one-row loops took most of the 251 s
# the whole benchmark took on the H100; the sweep at 256 took 173 s of a
# 1032 s run once phase fit joined, so it was cut to 128; with phase
# tiered the run reached 1112 s with the sweep at 64 (72 s), so both went
# to 32; a host that ran the script a third slower took both to 16, and
# phases stencil and launch to 8; phase pipeline took both to 4)
SPEC_BENCH = dict(n=4, temp=0.8, top_k=40, batched=8, batched_n=4)
SPEC_CUTS = {"pair_steps": "400 / 400 -> 100 / 100",
             "serve_app": "the serve phase's stream, its first "
                          f"{SPEC_APP_REQUESTS} requests",
             "engine_requests": f"16 -> {SPEC_STREAM['requests']}",
             "int8_requests": f"16 -> {SPEC_INT8_REQUESTS}",
             "bench_n": f"256 -> {SPEC_BENCH['n']}",
             "bench_batched_n": f"256 -> {SPEC_BENCH['batched_n']}"}


def _spec_stream(vocab: int) -> list:
    from hpc_patterns_tpu_torch.make_draft_pair import markov_corpus

    s = SPEC_STREAM
    L = s["prompt_len"]
    corpus = markov_corpus(vocab, 2 * L * s["requests"], draw_seed=777)
    rng = np.random.RandomState(7)
    return [(corpus[2 * i * L:2 * i * L + L].copy(),
             int(rng.choice(s["budgets"], p=s["p"])))
            for i in range(s["requests"])]


def _check_spec_launches(run: dict, label: str) -> dict:
    """A counted draft-assisted run's kernel 1 and 6 launches against its
    calls: (target + draft layers) x its flash admissions, and draft
    layers x (gamma + 1) x its rounds."""
    L, Ld, g = run["n_layers"], run["draft_layers"], run["gamma"]
    check(run["paged_decode"] > 0, f"{label}: kernel 6 launched")
    check(run["flash_prefill"] == (L + Ld) * run["flash_admissions"],
          f"{label}: prefill launches {run['flash_prefill']} == ({L} + {Ld})"
          f" x {run['flash_admissions']} flash admissions")
    check(run["paged_decode"] == Ld * (g + 1) * run["spec_rounds"],
          f"{label}: decode launches {run['paged_decode']} == {Ld} x "
          f"{g + 1} x {run['spec_rounds']} rounds")
    return {k: run[k] for k in ("flash_prefill", "paged_decode",
                                "flash_admissions", "admissions",
                                "spec_rounds")}


def _tie_counts(pairs, tol: float) -> tuple[dict, list, int]:
    """tie_aware_compare over (index, got, want, margins) tuples: the
    verdict counts, each divergence's first step and gap, and the tokens
    compared (a sequence's length, or its steps up to and with its first
    divergence)."""
    from hpc_patterns_tpu_torch.models.serving import tie_aware_compare

    counts = {"exact": 0, "near_tie": 0, "mismatch": 0}
    detail = []
    compared = 0
    for i, got, want, margins in pairs:
        v = tie_aware_compare(got, want, margins, tol)
        counts[v] += 1
        j = -1
        if v != "exact":
            j = int(np.nonzero(got != want)[0][0]) if got.shape == \
                want.shape else -1
            detail.append({"seq": i, "verdict": v, "step": j,
                           "gap": float(margins[j]) if j >= 0 else None})
        compared += len(want) if v == "exact" or j < 0 else j + 1
    return counts, detail, compared


# -- decision margins of sampled speculative tokens (the tie-aware oracle) --

def _position_margin(parts, x, dl, tl, g, top_k: int, t: float):
    """The margin (N,) in score units of N positions' speculative
    decisions, each decided alone (``speculative._accept_resample`` at
    gamma 0 on ``parts``): how far either model's logits (``dl``, ``tl``
    (N, V)) must move to change the token. The draft's pick of ``x``
    (``decode.pick_margin`` on its noise ``g``) and the accept decision,
    |log u - min(0, log p - log q)|, and the proposal's distance to the
    target's top-k edge (off it, p = 0). A rejection adds the residual
    draw's: for each other token c of the target's support, twice the
    smallest shift d of both laws (p -> p(1 + d) against q -> q(1 - d))
    that lets c's residual outscore the winner's under their noise, so a
    residual of two close laws, which moves far more than either, counts
    as close; the winner's distance to both supports' edges; a token off
    the target's support that would win once it joined it, and one of
    both supports that would win once it left the draft's (its residual
    then p)."""
    from hpc_patterns_tpu_torch.models.decode import (
        pick_margin,
        support_edges,
    )

    ins_q, mem_q = support_edges(dl, top_k, t)
    raw_q = dl / t + g
    masked_q = torch.where(ins_q, raw_q, torch.full_like(raw_q,
                                                         float("-inf")))
    ins_p, mem_p = support_edges(tl, top_k, t)
    xi = x.long()[:, None]
    acc = (torch.log(parts["u"][:, 0]) - torch.clamp(
        torch.log(parts["p_at"][:, 0]) - torch.log(parts["q_at"][:, 0]),
        max=0.0)).abs()
    base = torch.minimum(pick_margin(masked_q, raw_q, ins_q, mem_q),
                         torch.minimum(acc, mem_p.gather(1, xi)[:, 0]))
    # the residual draw
    scores, res, noise = parts["scores"], parts["res"], parts["noise"]
    p_a, q_a = parts["p_a"], parts["q_a"]
    w = scores.argmax(dim=-1, keepdim=True)
    others = torch.arange(scores.shape[-1], device=w.device) != w
    e = torch.exp(noise - noise.gather(1, w))
    shift = (res.gather(1, w) - (p_a - q_a) * e) / (
        (p_a + q_a) * e + (p_a + q_a).gather(1, w))
    close = 2.0 * torch.where(ins_p & others, shift,
                              float("inf")).amin(dim=-1)
    close = torch.minimum(close, torch.minimum(mem_p, mem_q).gather(
        1, w)[:, 0])
    # the supports' edges move a residual by a jump: a token off the
    # target's support joins it (its score then its p over the support,
    # as a share of the residual's mass), a token on both leaves the
    # draft's (p's share)
    log_mass = torch.log(res.sum(dim=-1, keepdim=True).clamp(min=1e-30))
    s_w = scores.gather(1, w)
    lt = tl / t
    lp_join = lt - torch.logsumexp(torch.where(
        ins_p, lt, float("-inf")), dim=-1, keepdim=True) + noise - log_mass
    join = torch.where(ins_p, float("inf"),
                       torch.maximum(mem_p, s_w - lp_join))
    leave = torch.where(ins_p & ins_q, torch.maximum(
        mem_q, s_w - torch.log(p_a + 1e-30) - noise + log_mass),
        float("inf"))
    close = torch.minimum(close, torch.where(
        others, torch.minimum(join, leave), float("inf")).amin(dim=-1))
    close = torch.where(parts["all_accepted"], float("inf"), close)
    return torch.minimum(base, close)


def _spec_margins(params, cfg, dparams, dcfg, prompts, toks, keys,
                  temperature: float, top_k: int):
    """Each sampled speculative token's decision margin (B, n) in score
    units, and how many tokens the replay gives back. A token depends on
    its row's key, its prefix and its position only
    (``models/speculative.py``), so the decisions are replayed a position
    at a time over both models' teacher-forced logits (``forward`` of
    prompt + tokens): the first token the plain draw at T, each later
    one the draft's pick on its position's draft noise and
    ``_accept_resample`` at gamma 0 on its accept and residual draws."""
    from hpc_patterns_tpu_torch.models.decode import (
        _as_keys,
        _topk_mask,
        gumbel_noise,
        pick_margin,
        sample_scores,
        support_edges,
    )
    from hpc_patterns_tpu_torch.models.speculative import (
        _accept_resample,
        _warp,
        spec_streams,
    )
    from hpc_patterns_tpu_torch.models.transformer import forward

    B, T = prompts.shape
    n, V = toks.shape[1], cfg.vocab
    kt = _as_keys(keys, B, prompts.device)
    margins, agree = [], 0
    with torch.no_grad():
        for b in range(B):
            seq = torch.cat([prompts[b:b + 1], toks[b:b + 1]], dim=1)
            tl = forward(params, seq, cfg)[0, T - 1:-1].float()  # (n, V)
            dl = forward(dparams, seq, dcfg)[0, T - 1:-1].float()
            k = kt[b:b + 1]
            g0 = gumbel_noise(k, T, V)
            sc = sample_scores(tl[:1], k, T, temperature, top_k, g0)
            ins, mem = support_edges(tl[:1], top_k, temperature)
            m0 = pick_margin(sc, tl[:1] / temperature + g0, ins, mem)
            first = torch.argmax(sc, dim=-1)
            streams = spec_streams(k.expand(n - 1, 2).contiguous())
            at = torch.arange(T + 1, T + n, device=prompts.device,
                              dtype=torch.int32)
            g = gumbel_noise(streams["draft"], at.long(), V)
            masked = _topk_mask(dl[1:], top_k) / temperature
            x = torch.argmax(masked + g, dim=-1).to(torch.int32)
            _, nxt, parts = _accept_resample(
                streams, at, x[:, None], torch.softmax(masked, -1)[:, None],
                _warp(tl[1:], temperature, top_k)[:, None])
            margins.append(torch.cat([m0, _position_margin(
                parts, x, dl[1:], tl[1:], g, top_k, temperature)]))
            agree += int((torch.cat([first.to(torch.int32), nxt])
                          == toks[b]).sum())
    return torch.stack(margins), agree


def phase_spec():
    """Speculative decoding at the card widths: (a) the aligned pair
    (``make_draft_pair.build_pair``), which must beat a random draft on
    both held-out diagnostics by > 0.05; (b) ``serve_app --draft-pair
    --gamma 4`` at the serve phase's geometry and stream (SUCCESS: every
    sequence on the target's standalone, tie-aware), then the engine
    through its API on the pair's own prompts: greedy (each row on the
    target's standalone ``paged_generate``), sampled at T 0.8, top-k 50
    (each row on ``speculative_generate_batched`` with the request's key,
    tie-aware on each decision's margin from :func:`_spec_margins` at the
    fixed tolerance 0.05 / T) and the plain engine on the same stream;
    (c) a draft-assisted engine on int8 pools against the target's own
    int8 ``paged_generate``; (d) ``bench_speculative --pair --n 8`` at
    gamma 2, 4 and 8, greedy and sampled, and ``--batched 8`` at 8
    tokens a call. Every engine run's kernel 1 and 6 launches against its
    counted admissions and rounds; tokens/s, tokens a row a round and the
    acceptance a / gamma printed."""
    import dataclasses
    import shutil

    from hpc_patterns_tpu_torch import bench_speculative
    from hpc_patterns_tpu_torch import make_draft_pair as mdp
    from hpc_patterns_tpu_torch.apps import serve_app
    from hpc_patterns_tpu_torch.apps.serve_app import (
        CHIP_SERVE,
        TIE_TOL,
    )
    from hpc_patterns_tpu_torch.models.decode import paged_generate
    from hpc_patterns_tpu_torch.models.serving import (
        ContinuousBatcher,
        bucket_ladder,
        pad_to_bucket,
    )
    from hpc_patterns_tpu_torch.models.speculative import (
        speculative_generate_batched,
    )
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    G = SPEC_GAMMA
    work = ROOT / "build" / "smoke_spec"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pair = str(work / "pair")
    launches = {"flash_prefill": 0, "paged_decode": 0,
                "paged_decode_quant": 0}

    # (a) the pair
    base, layers, dlayers = mdp.widths(True)
    steps, dsteps = SPEC_PAIR_STEPS
    for k in fa.launches:
        fa.launches[k] = 0
    t0 = time.perf_counter()
    meta = mdp.build_pair(pair, steps=steps, distill_steps=dsteps, batch=16,
                          seq=256, n_corpus=2_000_000, base=base,
                          layers=layers, draft_layers=dlayers, device=dev,
                          log=lambda m: None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = {k: fa.launches[k] for k in ("fwd", "fwd_lse", "dq",
                                                  "dkv")}
    acc = meta["acceptance"]
    emit({"phase": "spec", "leg": "pair", "config": meta["target_cfg"],
          "draft_layers": dlayers, "steps": steps, "distill_steps": dsteps,
          "acceptance": acc, "seconds": build_s,
          "train_seconds": meta["seconds"], "launches": build_launches})
    check(acc["aligned_greedy"] > acc["random_greedy"] + 0.05,
          f"pair: greedy agreement {acc['aligned_greedy']:.3f} > random "
          f"{acc['random_greedy']:.3f} + 0.05")
    check(acc["aligned_minpq"] > acc["random_minpq"] + 0.05,
          f"pair: E[min(p,q)] {acc['aligned_minpq']:.3f} > random "
          f"{acc['random_minpq']:.3f} + 0.05")
    check(build_launches["fwd_lse"] > 0 and build_launches["dq"] > 0
          and build_launches["dkv"] > 0,
          f"the pair trained on kernels 1, 3 and 4: {build_launches}")
    torch.cuda.empty_cache()

    # (b) serve_app with the pair, at the serve phase's geometry and stream
    t0 = time.perf_counter()
    s = CHIP_SERVE
    runs: list = []
    argv = ["--device", "cuda", "--draft-pair", pair, "--gamma", str(G),
            "--requests", str(SPEC_APP_REQUESTS), "--slots", str(s["slots"]),
            "--chunk", str(SPEC_CHUNK), "--page-size", str(s["page_size"]),
            "--prompt-len", str(s["prompt_len"]),
            "--budget", str(s["max_budget"])]
    orig = serve_app.make_requests, serve_app.ContinuousBatcher
    serve_app.make_requests = lambda n, plen, budget, vocab, mix: \
        serve_app.bench_stream(n, plen, budget, vocab)
    serve_app.ContinuousBatcher = _counting_engine(
        serve_app.ContinuousBatcher, runs)
    try:
        code, recs = run_app(serve_app.main, argv, work / "serve.jsonl")
    finally:
        serve_app.make_requests, serve_app.ContinuousBatcher = orig
    printed = (work / "serve.out").read_text()
    (res,) = [r for r in recs if r["kind"] == "result"]
    emit({"phase": "spec", "leg": "serve_app", "gamma": G,
          "chunk_rounds": SPEC_CHUNK, "tokens_per_s": res["tokens_per_s"],
          "served_tokens": res["served_tokens"], "oracle": res["oracle"],
          "spec_rounds": res["spec_rounds"],
          "tokens_a_row_round": res["spec_tokens"]
          / max(1, res["spec_row_rounds"]),
          "acceptance": res["spec_accepted"]
          / max(1, G * res["spec_row_rounds"]),
          "seconds": time.perf_counter() - t0})
    check(code == 0 and "SUCCESS" in printed.splitlines()
          and res["oracle"]["mismatch"] == 0,
          f"serve_app --draft-pair prints SUCCESS, oracle {res['oracle']}")
    app_launches = _check_spec_launches(runs[-1], "spec serve_app")
    for k in ("flash_prefill", "paged_decode"):
        launches[k] += app_launches[k]

    # the engine through its API on the pair's own prompts
    reqs = _spec_stream(base["vocab"])
    L, max_b = SPEC_STREAM["prompt_len"], max(SPEC_STREAM["budgets"])
    cfg, params, dcfg, dparams, _ = mdp.load_pair(
        pair, max_seq=L + max_b + G + 1, device=dev)
    buckets = bucket_ladder(L)
    pps = ContinuousBatcher.pages_needed(L, max_b, s["page_size"], gamma=G,
                                         padded_len=pad_to_bucket(buckets, L))
    geom = dict(slots=s["slots"], pool_pages=s["slots"] * pps,
                pages_per_seq=pps, page_size=s["page_size"],
                prompt_buckets=buckets, device=dev)
    tol = TIE_TOL[cfg.dtype]
    eruns: list = []
    Counting = _counting_engine(ContinuousBatcher, eruns)

    def serve(c, stream, **kw):
        eng = Counting(params, c, **geom, **kw)
        ids = [eng.submit(p, b) for p, b in stream]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = [got[sid] for sid in ids]
        check(eng.free_page_count == eng.pool_pages,
              f"every page back ({eng.free_page_count}/{eng.pool_pages})")
        for (p, b), o in zip(stream, out):
            check(o.shape == (b,) and o.min() >= 0 and o.max() < c.vocab,
                  f"{b} tokens in [0, vocab)")
        return eng, ids, out, sum(len(o) for o in out) / dt

    def standalone(c, stream):
        rows = []
        for i, (p, b) in enumerate(stream):
            w, m = paged_generate(params, torch.from_numpy(p)[None, :], c,
                                  b, page_size=s["page_size"], device=dev,
                                  with_margins=True)
            rows.append((i, w[0].cpu().numpy(), m[0].cpu().numpy()))
        return rows

    def spec_stats(eng):
        st = eng.spec_stats
        return {"rounds": eng.spec_rounds,
                "tokens_a_row_round": st["tokens"] / max(1,
                                                         st["row_rounds"]),
                "acceptance": st["accepted"] / max(1, G * st["row_rounds"])}

    spec_kw = dict(draft_params=dparams, draft_cfg=dcfg, gamma=G,
                   chunk=SPEC_CHUNK)
    legs = {}
    t0 = time.perf_counter()
    eng, _, out, tps = serve(cfg, reqs, **spec_kw)
    counts, detail, compared = _tie_counts(
        [(i, out[i], w, m) for i, w, m in standalone(cfg, reqs)], tol)
    legs["greedy"] = {"tokens_per_s": tps, "oracle": counts,
                      "divergences": detail, "tokens_compared": compared,
                      **spec_stats(eng),
                      "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    emit({"phase": "spec", "leg": "greedy", **legs["greedy"]})
    legs["greedy"]["launches"] = _check_spec_launches(eruns[-1],
                                                      "spec greedy")
    check(counts["mismatch"] == 0, f"spec greedy vs standalone: {counts}")
    samp = dict(temperature=SAMPLE_ARGS["temperature"],
                top_k=SAMPLE_ARGS["top_k"])
    eng, ids, out, tps = serve(cfg, reqs, **spec_kw, **samp,
                               seed=SAMPLE_ARGS["seed"])
    prompts = torch.from_numpy(np.stack([p for p, _ in reqs])).to(dev)
    keys = np.stack([eng.request_key(sid) for sid in ids])
    want = speculative_generate_batched(
        params, cfg, dparams, dcfg, prompts, max_b, gamma=G, key=keys,
        device=dev, **samp)
    margins, replayed = _spec_margins(params, cfg, dparams, dcfg, prompts,
                                      want, keys, **samp)
    # the greedy tolerance in logit units, as a score gap (margins are
    # in units of logits / T)
    tol_s = tol / samp["temperature"]
    want, margins = want.cpu().numpy(), margins.cpu().numpy()
    counts, detail, compared = _tie_counts(
        [(i, out[i], want[i, :b], margins[i, :b])
         for i, (_, b) in enumerate(reqs)], tol_s)
    legs["sampled"] = {"tokens_per_s": tps, "oracle": counts,
                       "divergences": detail, "tokens_compared": compared,
                       "tokens_served": sum(b for _, b in reqs),
                       "replay_agrees": replayed / want.size,
                       **spec_stats(eng), "tie_tol": tol_s,
                       "seconds": time.perf_counter() - t0}
    emit({"phase": "spec", "leg": "sampled", **legs["sampled"]})
    legs["sampled"]["launches"] = _check_spec_launches(eruns[-1],
                                                       "spec sampled")
    check(counts["mismatch"] == 0,
          f"spec sampled vs speculative_generate_batched: {counts}")
    _, _, _, tps = serve(cfg, reqs, chunk=s["chunk"])
    legs["plain"] = {"tokens_per_s": tps, "chunk_steps": s["chunk"],
                     "launches": _check_launches(eruns[-1], "spec plain")}
    for leg in ("greedy", "sampled"):
        for k in ("flash_prefill", "paged_decode"):
            launches[k] += legs[leg]["launches"][k]

    # (c) int8 pools for both models, against the target's own int8 decode
    t0 = time.perf_counter()
    qcfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    qdcfg = dataclasses.replace(dcfg, kv_cache_dtype="int8")
    q_reqs = reqs[:SPEC_INT8_REQUESTS]
    eng, _, out, tps = serve(qcfg, q_reqs, **dict(spec_kw,
                                                  draft_cfg=qdcfg))
    counts, detail, compared = _tie_counts(
        [(i, out[i], w, m) for i, w, m in standalone(qcfg, q_reqs)], tol)
    legs["int8"] = {"tokens_per_s": tps, "oracle": counts,
                    "divergences": detail, "tokens_compared": compared,
                    **spec_stats(eng),
                    "seconds": time.perf_counter() - t0}
    emit({"phase": "spec", "leg": "int8", **legs["int8"]})
    legs["int8"]["launches"] = _check_spec_launches(eruns[-1], "spec int8")
    check(counts["mismatch"] == 0, f"spec int8 vs int8 standalone: {counts}")
    launches["paged_decode_quant"] += legs["int8"]["launches"]["paged_decode"]
    launches["flash_prefill"] += legs["int8"]["launches"]["flash_prefill"]
    emit({"phase": "spec", "leg": "engine", "gamma": G,
          "chunk_rounds": SPEC_CHUNK, "stream": SPEC_STREAM,
          "tie_tol": tol, **{k: {kk: vv for kk, vv in v.items()
                                 if kk != "divergences"}
                             for k, v in legs.items()}})

    # (d) the benchmark
    t0 = time.perf_counter()
    fd.launches["flash_decode"] = 0
    fd.launches["paged_decode"] = 0
    bench_speculative.run_bench(pair=pair, device=dev, emit=emit,
                                **SPEC_BENCH)
    torch.cuda.synchronize()
    bench_launches = {"flash_decode": fd.launches["flash_decode"],
                      "paged_decode": fd.launches["paged_decode"]}
    check(bench_launches["flash_decode"] > 0
          and bench_launches["paged_decode"] > 0,
          f"bench_speculative ran kernels 5 and 6: {bench_launches}")
    emit({"phase": "spec", "leg": "done", "cuts": SPEC_CUTS,
          "bench_launches": bench_launches,
          "bench_seconds": time.perf_counter() - t0,
          "seconds": time.perf_counter() - t_phase})
    return {**launches, "flash_decode": bench_launches["flash_decode"],
            "build": build_launches}


# the plane phase's closed-loop transports; the requests of every leg
# (plane_full_config's 32, cut to 16 and, once phases stencil and launch
# joined, to 8 for the run's time) and of its int8 leg
PLANE_TRANSPORTS = ("dma", "device_put", "wire")
PLANE_REQUESTS = 8
# the int8 leg: 4 requests (8 until phase elastic joined)
PLANE_INT8_REQUESTS = 4
# the death leg: replica 1 of a 2-replica fixed plane dies at its round 3
PLANE_DEATH_SPEC = "die:replica=1,at=3,site=replica_round"


def _plane_leg(bs, stream, oracle, geom, migration, label, **sampling):
    """One closed-loop 1p/1d leg (every request submitted up front, so the
    rounds are deterministic) on logical ranks 0 and 1 of the card:
    tie-aware oracle, transports, kernel 13's launches against the dma
    bundles' payload arrays, arenas drained. ``sampling``: the replicas'
    temperature, top-k and seed (the oracle's must match)."""
    from hpc_patterns_tpu_torch.comm import migration_dma as md

    dev = torch.device("cuda")
    plane = bs.make_plane(
        stream, ("prefill", "decode"), **geom, migration=migration,
        device=dev, placed=True,
        slo_targets=bs.slo.targets_from_classes(bs.SCENARIO_CLASSES),
        **sampling)
    n0 = md.launches["migration_exchange"]
    t0 = time.perf_counter()
    ids = {r.index: plane.submit(stream["prompts"][r.index], r.max_new,
                                 priority=r.priority)
           for r in stream["schedule"].requests}
    got = plane.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    md.synchronize()
    launched = md.launches["migration_exchange"] - n0
    check(all(rid == i for i, rid in ids.items()),
          f"{label}: requests numbered in schedule order")
    outs = {i: got[rid] for i, rid in ids.items()}
    verdicts = oracle.check(outs, label)
    arrays = sum(len(v) for k, v in plane.replicas[0].engine.cache.items()
                 if k != "table")
    check(plane.migrations > 0, f"{label}: migrated")
    check(dict(plane.migration_transports) == {migration: plane.migrations},
          f"{label}: transports {dict(plane.migration_transports)}")
    check(launched == (plane.migrations * arrays if migration == "dma"
                       else 0),
          f"{label}: kernel 13 launches {launched} == {arrays} payload "
          f"arrays x {plane.migrations} dma bundles")
    for r in plane.replicas:
        check(r.engine.free_page_count == stream["pool"],
              f"{label}: replica {r.name} drained")
    tokens = sum(len(v) for v in outs.values())
    return outs, launched, {
        "transport": migration, "requests": len(ids), "seconds": dt,
        "tokens": tokens, "tokens_per_s": tokens / dt,
        "goodput_tok_s": plane.last_slo["total"]["goodput_tok_s"]
        * plane._serve_s / dt,
        "migrations": plane.migrations, "payload_arrays": arrays,
        "kernel13_launches": launched,
        "kv_migration_overlap_frac": plane.last_kv_migration_overlap_frac,
        "dma_migration_overlap_frac":
            plane.last_dma_migration_overlap_frac,
        "migration_bytes_per_round": plane.migration_bytes_per_round,
        "oracle": verdicts}


def _plane_death(bs, stream, oracle, geom):
    """The fixed 2-replica plane (logical ranks 0 and 1, least-loaded) with
    replica 1 killed by chaos at its round 3, closed loop: ``deaths ==
    ["r1"]``, every casualty shed and counted (``shed_on_death`` == the
    ``plane_shed`` records == the shed outcomes), every served sequence on
    its standalone, the survivor's arena drained."""
    from hpc_patterns_tpu_torch.harness import chaos

    dev = torch.device("cuda")
    records: list = []
    plane = bs.make_plane(
        stream, ("both", "both"), **geom, migration="dma", device=dev,
        placed=True, emit=lambda **kw: records.append(kw))
    ids = {r.index: plane.submit(stream["prompts"][r.index], r.max_new,
                                 priority=r.priority)
           for r in stream["schedule"].requests}
    chaos.configure(PLANE_DEATH_SPEC)
    t0 = time.perf_counter()
    try:
        got = plane.run()
        torch.cuda.synchronize()
        fired = chaos.injections()
    finally:
        chaos.reset()
    dt = time.perf_counter() - t0
    sheds = [r["seq_id"] for r in records
             if r["kind"] == "plane_shed" and r["on_death"]]
    shed_outcomes = [rid for rid in ids.values()
                     if plane.stats[rid]["outcome"] == "shed"]
    check(plane.deaths == ["r1"] and [e["kind"] for e in fired] == ["die"],
          f"death leg: deaths {plane.deaths}, injections {fired}")
    check(plane.shed_on_death > 0
          and plane.shed_on_death == len(sheds) == len(shed_outcomes)
          and sorted(sheds) == sorted(shed_outcomes),
          f"death leg: {plane.shed_on_death} shed on death, {len(sheds)} "
          f"plane_shed records, {len(shed_outcomes)} shed outcomes")
    served = {i: got[rid] for i, rid in ids.items()
              if plane.stats[rid]["outcome"] == "ok"}
    check(len(served) + len(shed_outcomes) == len(ids),
          "death leg: every request served or shed")
    verdicts = oracle.check(served, "plane death leg")
    check(plane.replicas[0].engine.free_page_count == stream["pool"],
          "death leg: the survivor drained")
    return {"spec": PLANE_DEATH_SPEC, "deaths": plane.deaths,
            "shed_on_death": plane.shed_on_death, "served": len(served),
            "seconds": dt, "oracle": verdicts,
            "records": {k: sum(r["kind"] == k for r in records)
                        for k in ("plane_replica_death", "plane_shed",
                                  "plane_route")}}


def phase_plane():
    """The serving plane at the chip model: the port's ``run_plane`` over
    dma (single engine, 2-replica, 1p/1d, a sampled 1p/1d), then
    closed-loop 1p/1d legs over every transport (dma's tokens == wire's,
    byte for byte), 4 requests at int8 KV over dma, a sampled leg over
    dma, and the 2-replica plane losing replica 1 to chaos. Counts zeroed
    just before, read just after; a transport fallback warning fails the
    phase."""
    import warnings

    from hpc_patterns_tpu_torch import bench_serving as bs
    from hpc_patterns_tpu_torch.apps.serve_app import CHIP_MODEL
    from hpc_patterns_tpu_torch.comm import migration_dma as md
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    conf = dict(bs.plane_full_config(dev), n=PLANE_REQUESTS)
    cfg = conf["cfg"]
    check(all(getattr(cfg, k) == v for k, v in CHIP_MODEL.items())
          and cfg.decode_attn == "flash",
          f"the plane runs the serve phase's model: {cfg}")
    geom = {k: conf[k] for k in ("cfg", "params", "slots", "chunk",
                                 "page_size")}
    md.launches["migration_exchange"] = 0
    fa.launches["fwd"] = 0
    fd.launches["paged_decode"] = 0
    stream = bs.plane_stream(**conf)
    oracle = bs.Oracle(stream, cfg=cfg, params=conf["params"],
                       page_size=conf["page_size"], device=dev)
    soracle = bs.Oracle(stream, cfg=cfg, params=conf["params"],
                        page_size=conf["page_size"], device=dev,
                        **bs.PLANE_SAMPLING)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = bs.run_plane(**conf, migration="dma", oracle=oracle,
                           sampled_oracle=soracle)
        md.synchronize()
        k13_open = md.launches["migration_exchange"]
        closed, outs = {}, {}
        for mig in PLANE_TRANSPORTS:
            outs[mig], _, closed[mig] = _plane_leg(
                bs, stream, oracle, geom, mig, f"plane closed-loop {mig}")
        for i, toks in outs["dma"].items():
            check(np.array_equal(toks, outs["wire"][i]),
                  f"closed-loop dma == wire, byte for byte (request {i})")
        qconf = bs.with_kv_dtype(dict(conf, n=PLANE_INT8_REQUESTS), "int8")
        qgeom = dict(geom, cfg=qconf["cfg"])
        qstream = bs.plane_stream(**qconf)
        qoracle = bs.Oracle(qstream, cfg=qconf["cfg"], params=conf["params"],
                            page_size=conf["page_size"], device=dev)
        _, _, closed["dma_int8"] = _plane_leg(bs, qstream, qoracle, qgeom,
                                              "dma", "plane int8 dma")
        _, _, closed["dma_sampled"] = _plane_leg(
            bs, stream, soracle, geom, "dma", "plane sampled dma",
            **bs.PLANE_SAMPLING)
        death = _plane_death(bs, stream, oracle, geom)
    md.synchronize()
    launches = {"migration_exchange": md.launches["migration_exchange"],
                "flash_prefill": fa.launches["fwd"],
                "paged_decode": fd.launches["paged_decode"]}
    fallbacks = [str(w.message) for w in caught
                 if "fell back" in str(w.message)]
    check(not fallbacks, f"no transport fallback: {fallbacks}")
    arrays = closed["dma"]["payload_arrays"]
    check(res["migrations"] > 0 and res["migration_transports"]
          == {"dma": res["migrations"]},
          f"run_plane 1p/1d: every bundle over dma "
          f"{res['migration_transports']}")
    check(res["sampled_migrations"] > 0 and res["sampled_migration_"
                                              "transports"]
          == {"dma": res["sampled_migrations"]},
          f"run_plane sampled 1p/1d: every bundle over dma "
          f"{res['sampled_migration_transports']}")
    bundles = res["migrations"] + res["sampled_migrations"]
    check(k13_open == bundles * arrays,
          f"run_plane: kernel 13 launches {k13_open} == {arrays} x "
          f"{bundles} bundles (greedy and sampled 1p/1d)")
    check(launches["flash_prefill"] > 0 and launches["paged_decode"] > 0,
          f"the plane ran kernels 1 and 6: {launches}")
    legs = {leg: {"seconds": res[f"t_{leg}"],
                  "tokens_per_s": res[f"{leg}_tok_s"],
                  "goodput_tok_s": res[f"{leg}_goodput_tok_s"],
                  "oracle": res["oracle"][leg]}
            for leg in ("single", "plane", "disagg")}
    legs["sampled"] = {"seconds": res["t_sampled"],
                       "tokens_per_s": res["sampled_tok_s"],
                       "migrations": res["sampled_migrations"],
                       "oracle": res["oracle"]["sampled"],
                       "sampling": bs.PLANE_SAMPLING}
    emit({"phase": "plane",
          "config": {"vocab": cfg.vocab, "d_model": cfg.d_model,
                     "n_heads": cfg.n_heads, "n_layers": cfg.n_layers,
                     "d_ff": cfg.d_ff, "dtype": cfg.dtype,
                     "decode_attn": cfg.decode_attn,
                     **{k: conf[k] for k in ("n", "slots", "chunk",
                                             "page_size", "prompt_len",
                                             "max_budget", "rate_rps",
                                             "seed")}},
          "cuts": {"chips": "2 -> 2 logical ranks of one card",
                   "requests": f"32 -> {PLANE_REQUESTS}",
                   "int8_requests": f"32 -> {PLANE_INT8_REQUESTS}"},
          "open_loop": {**legs,
                        "migrations": res["migrations"],
                        "kv_migration_overlap_frac":
                            res["kv_migration_overlap_frac"],
                        "dma_migration_overlap_frac":
                            res["dma_migration_overlap_frac"],
                        "migration_bytes_per_round":
                            res["migration_bytes_per_round"],
                        "ladder_fit": res["ladder_fit"],
                        "expected_padding_fit":
                            res["expected_padding_fit"],
                        "expected_padding_default":
                            res["expected_padding_default"],
                        "kernel13_launches": k13_open},
          "closed_loop": closed, "death": death, "launches": launches,
          "note": "replicas are logical ranks 0 and 1 of one card; a "
                  "migration is a copy within its memory",
          "seconds": time.perf_counter() - t_phase})
    return launches, {"conf": conf, "geom": geom, "stream": stream,
                      "dma_outs": outs["dma"]}


# ------------------------------------------------------------ elastic plane

# (a) bench_serving.run_elastic at elastic_full_config, its stream cut
ELASTIC_REQUESTS = 16
# (b) the launched 1p/1d plane and (c) the launched death drill: plane_app
# replicas at the chip widths
ELASTIC_MODEL = ["--vocab", "32768", "--d-model", "1024", "--n-heads", "8",
                 "--n-layers", "8", "--d-ff", "4096", "--dtype", "bfloat16",
                 "--decode-attn", "flash"]
ELASTIC_PLANE = ["--page-size", "256", "--prompt-len", "256", "--budget",
                 "64", "--rate", "10000", "--plane-timeout", "300"]
ELASTIC_PD_REQUESTS = 8
ELASTIC_DIE = "die:replica=2,at=3,site=replica_round"
ELASTIC_DIE_REQUESTS = 9
ELASTIC_CUTS = {"requests": f"32 -> {ELASTIC_REQUESTS} (run_elastic)",
                "chips": "every replica an engine (or a process) on one "
                         "card"}


def _replica_counts(text: str) -> dict:
    """{rank: the JSON counts line a real plane_app replica prints last}."""
    out = {}
    for line in text.splitlines():
        line = re.sub(r"^\[\d+\] ", "", line.strip())
        if line.startswith('{"replica"'):
            rec = json.loads(line)
            out[rec["replica"]] = rec
    return out


def _elastic_counted(bs, engines: list, oracle_launches: dict):
    """``bs.EngineCore`` recording every engine it builds, and
    ``bs._standalone`` tallying the oracle's own kernel 1/6 launches."""
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    class Counted(bs.EngineCore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    def standalone(*a, **kw):
        f0, d0 = fa.launches["fwd"], fd.launches["paged_decode"]
        out = orig(*a, **kw)
        oracle_launches["flash_prefill"] += fa.launches["fwd"] - f0
        oracle_launches["paged_decode"] += fd.launches["paged_decode"] - d0
        return out

    orig = bs._standalone
    return Counted, standalone


def _prefill_on_kernel(c: dict) -> bool:
    """A replica's (or an engine's) every admission prefilled through
    kernel 1: its rungs are multiples of 128 and its launches n_layers x
    its admissions."""
    return (c["admissions"] > 0
            and all(r % 128 == 0 for r in c["prefill_rungs"])
            and c["flash_prefill"] == c["n_layers"] * c["admissions"])


def _elastic_run(bs, dev, after_timed) -> tuple[dict, dict]:
    """(a): ``run_elastic`` at ``elastic_full_config`` (its asserts: the
    fault fired on both legs, static sheds and elastic does not, elastic
    attainment strictly above, every stream tie-aware on its standalone,
    greedy and sampled; ``after_timed`` passed on), kernel 1 and 6
    launches read around it: the engines' == n_layers x their admissions
    (every rung a multiple of 128) / decode steps. Returns the engines'
    launches, the oracle's apart."""
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    conf = dict(bs.elastic_full_config(dev), n=ELASTIC_REQUESTS)
    engines: list = []
    oracle = {"flash_prefill": 0, "paged_decode": 0}
    orig = bs.EngineCore, bs._standalone
    bs.EngineCore, bs._standalone = _elastic_counted(bs, engines, oracle)
    try:
        torch.cuda.synchronize()
        fa.launches["fwd"] = 0
        fd.launches["paged_decode"] = 0
        t0 = time.perf_counter()
        res = bs.run_elastic(**conf, after_timed=after_timed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"flash_prefill": fa.launches["fwd"],
                    "paged_decode": fd.launches["paged_decode"]}
    finally:
        bs.EngineCore, bs._standalone = orig
    L = conf["cfg"].n_layers
    admits = sum(e.admissions for e in engines)
    steps = sum(e.decode_steps for e in engines)
    rungs = sorted(set().union(*(e.prefill_rungs for e in engines)))
    engine_launches = {k: launches[k] - oracle[k] for k in launches}
    check(_prefill_on_kernel({"admissions": admits, "prefill_rungs": rungs,
                              "n_layers": L, **engine_launches}),
          f"elastic (a): every admission through kernel 1: "
          f"{engine_launches} == {L} x {admits} admissions, rungs {rungs}")
    check(engine_launches["paged_decode"] == L * steps > 0,
          f"elastic (a): kernel 6 launches == {L} x {steps} decode steps")
    on_load = [r for r in res["spinup_reasons"]
               if not r.startswith("below min_replicas")]
    check(on_load and res["drained"],
          f"elastic (a): a scale-up on load ({res['spinup_reasons']}) and "
          f"a drain by migration ({res['drained']})")
    return engine_launches, {
        "config": {k: conf[k] for k in ("n", "slots", "chunk", "page_size",
                                        "prompt_len", "max_budget",
                                        "rate_rps", "period_s", "depth",
                                        "die_replica", "die_at",
                                        "sampled_n")},
        **{k: res[k] for k in (
            "elastic_slo_attainment", "static_slo_attainment",
            "per_class_attainment", "goodput_per_replica_round",
            "static_goodput_per_replica_round", "static_shed_on_death",
            "elastic_shed_on_death", "spinups", "spinup_reasons",
            "resumed", "drained",
            "replica_rounds", "static_replica_rounds", "sampled_resumed",
            "t_static", "t_elastic", "oracle", "warm_param_bytes")},
        "warm_vs_cold": {"warm_spinup_ms": res["warm_spinup_s"] * 1e3,
                         "cold_init_ms": res["cold_init_s"] * 1e3,
                         "verdict": res["warm_vs_cold"]},
        "engines": len(engines), "admissions": admits,
        "prefill_rungs": rungs, "decode_steps": steps,
        "launches": engine_launches, "oracle_launches": oracle,
        "seconds": dt}


def _start_replicas(argv: list, nprocs: int, out: Path) -> list:
    """plane_app replica processes 1..nprocs-1 under the launcher's
    HPCPAT_* protocol (this process plays rank 0, the router)."""
    import os

    procs = []
    for rank in range(1, nprocs):
        env = dict(os.environ, HPCPAT_PROCESS_ID=str(rank),
                   HPCPAT_NUM_PROCESSES=str(nprocs))
        env.pop("HPCPAT_COORDINATOR", None)
        log = open(out / f"replica{rank}.out", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.apps.plane_app", *argv],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True), log))
    return procs


def _elastic_pd(bs, dev, argv, procs, out: Path,
                after_timed) -> tuple[dict, dict]:
    """(b): this process is rank 0 of the launched 1p/1d plane
    (``service.connect_replicas`` + ``service.PlaneRouter``) over the
    replica processes ``_start_replicas`` started: every request crosses
    the KV handoff over the socket; then the same arrivals through the
    in-process 1p/1d plane over the wire codec, its tokens/s beside.
    ``after_timed()`` runs once both timed runs are done (the death drill
    starts there); then every stream of both is held tie-aware on
    ``paged_generate`` at the replicas' seeded weights, and each
    replica's kernel 1/6 launches == n_layers x its admissions / decode
    steps."""
    from hpc_patterns_tpu_torch.apps import plane_app
    from hpc_patterns_tpu_torch.harness import slo as slolib
    from hpc_patterns_tpu_torch.serving_plane import service

    args = plane_app.build_parser().parse_args(argv)
    sched, prompts, arrivals, classes = plane_app._schedule(args)
    check([a[0] for a in arrivals] == sorted(a[0] for a in arrivals),
          "elastic (b): request i is the i-th arrival (both routers number "
          "requests in arrival order)")
    t0 = time.perf_counter()
    handles = service.connect_replicas(
        args.rdv, [1, 2], wait_s=args.plane_timeout,
        timeout_s=args.plane_timeout)
    t_ready = time.perf_counter() - t0
    router = service.PlaneRouter(
        handles, slo_targets=slolib.targets_from_classes(classes))
    report = router.run(arrivals, timeout_s=args.plane_timeout)
    texts = []
    for proc, log in procs:
        try:
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs, start=1):
        texts.append((out / f"replica{rank}.out").read_text())
        check(proc.returncode == 0,
              f"elastic (b): replica {rank} exits 0 ({texts[-1][-800:]})")
    counts = _replica_counts("\n".join(texts))
    n = ELASTIC_PD_REQUESTS
    check(report["served"] == n and report["migrations"] == n
          and not report["shed"] and not report["deaths"],
          f"elastic (b): served {report['served']}/{n}, "
          f"{report['migrations']} migrations over the socket, "
          f"shed {report['shed']}")
    cfg, params = plane_app.replica_model(args, dev)
    # the same arrivals in one process, 1p/1d over the wire codec
    stream_prompts = {i: np.asarray(p, np.int32) for i, p in prompts.items()}
    ladder = plane_app.replica_ladder(args)
    plane = bs.ServingPlane(
        [bs.Replica(bs.EngineCore(params, cfg, prompt_buckets=ladder,
                                  device=dev,
                                  **plane_app.replica_engine_kw(args,
                                                                ladder)),
                    name=role, role=role)
         for role in ("prefill", "decode")],
        migration="wire", slo=slolib.targets_from_classes(classes))
    t0 = time.perf_counter()
    got = plane.run(arrivals=[
        (t, dict(kw, prompt=stream_prompts[i]))
        for i, (t, kw) in enumerate(arrivals)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after_timed()
    tol = bs.TIE_TOL[cfg.dtype]
    verdicts = {"exact": 0, "near_tie": 0}
    for rid in sorted(router.finished):
        want, margins = bs._standalone(
            params, cfg, stream_prompts[rid], sched.requests[rid].max_new,
            page_size=args.page_size, device=dev)
        for label, toks in (("launched", router.finished[rid]),
                            ("in-process", got[rid])):
            verdicts[bs._held(toks, want, margins, tol,
                              f"elastic (b) {label} request {rid}")] += 1
    L = cfg.n_layers
    pre, dec = counts.get(1), counts.get(2)
    check(pre is not None and dec is not None
          and pre["role"] == "prefill" and dec["role"] == "decode",
          f"elastic (b): both replicas report their counts ({counts})")
    check(_prefill_on_kernel(pre) and pre["admissions"] == n
          and dec["paged_decode"] == L * dec["decode_steps"] > 0
          and dec["flash_prefill"] == pre["paged_decode"] == 0,
          f"elastic (b): kernel 1 == {L} x admissions on the prefill "
          f"replica, kernel 6 == {L} x decode steps on the decode one "
          f"({counts})")
    tokens = sum(len(t) for t in router.finished.values())
    launched = {
        "requests": n, "tokens": tokens, "wall_s": report["wall_s"],
        "tokens_per_s": tokens / report["wall_s"],
        "note": "two replica processes time-slicing one card (no MPS)",
        "replicas_ready_s": t_ready,
        "migrations": report["migrations"],
        "export_ms": [x * 1e3 for x in router.export_s],
        "handoff_ms": [x * 1e3 for x in router.handoff_s],
        "handoff_bytes": router.handoff_bytes,
        "oracle": verdicts, "replicas": counts}
    in_tokens = sum(len(t) for t in got.values())
    in_process = {"tokens": in_tokens, "wall_s": dt,
                  "tokens_per_s": in_tokens / dt,
                  "migrations": plane.migrations,
                  "transport": "wire (in one process)"}
    return ({"flash_prefill": pre["flash_prefill"] + dec["flash_prefill"],
             "paged_decode": pre["paged_decode"] + dec["paged_decode"]},
            {"launched": launched, "in_process": in_process})


def _start_die(out: Path) -> subprocess.Popen:
    """(c), started: the real launcher, 3 real replicas at the chip widths,
    sampled at T 0.7, replica 2 killed at its round 3."""
    return subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.apps.launch", "-np", "4",
         "--timeout", "400", "--chaos", ELASTIC_DIE, "--",
         sys.executable, "-m", f"{PKG}.apps.plane_app", "--roles",
         "both,both,both", "--temperature", "0.7", "--rdv",
         str(out / "rdv_die"), "--requests", str(ELASTIC_DIE_REQUESTS),
         "--device", "cuda", *ELASTIC_MODEL, *ELASTIC_PLANE],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def _kill_group(proc: subprocess.Popen) -> None:
    """Kill a started launcher and every process it started."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _elastic_die(proc: subprocess.Popen, t0: float,
                 out: Path) -> tuple[dict, dict]:
    """(c), finished: the plane recovers (``PLANE SUCCESS``,
    ``deaths=[2]``, a non-empty ``resumed``, every request served) while
    the launch fails loudly, naming the fault."""
    try:
        text, _ = proc.communicate(timeout=460)
    finally:
        _kill_group(proc)
    (out / "c_die.out").write_text(text)
    n = ELASTIC_DIE_REQUESTS
    summary = [ln for ln in text.splitlines() if "plane: served" in ln]
    check(proc.returncode == 1 and "PLANE SUCCESS" in text
          and "deaths=[2]" in text and "resumed=[" in text
          and "resumed=[]" not in text and f"served {n}/{n}" in text
          and "rank 2: fault: killed (SIGKILL)" in text,
          f"elastic (c): the plane recovered the death, the launch named "
          f"it ({proc.returncode}; {text[-1500:]})")
    counts = _replica_counts(text)
    check(set(counts) == {1, 3} and all(
        c["paged_decode"] == c["n_layers"] * c["decode_steps"] > 0
        and _prefill_on_kernel(c) for c in counts.values()),
        f"elastic (c): every survivor's admission through kernel 1, its "
        f"decode steps through kernel 6 ({counts})")
    return ({"flash_prefill": sum(c["flash_prefill"]
                                  for c in counts.values()),
             "paged_decode": sum(c["paged_decode"]
                                 for c in counts.values())},
            {"chaos": ELASTIC_DIE, "rc": proc.returncode,
             "summary": summary, "replicas": counts,
             "seconds": time.perf_counter() - t0})


def phase_elastic() -> dict:
    """The launched plane and the elastic plane at the chip widths: (a)
    ``bench_serving.run_elastic`` at ``elastic_full_config`` (cut to
    :data:`ELASTIC_REQUESTS`), warm spin-up and cold init printed side by
    side; (b) the launched 1p/1d plane with this process as its router;
    (c) the real launcher's replica-death drill. Kernel 1 and 6 launches:
    (a)'s counted here, (b)'s and (c)'s as each replica process
    reports them."""
    import shutil

    from hpc_patterns_tpu_torch import bench_serving as bs

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    out = ROOT / "build" / "smoke_elastic"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pd_argv = ["--roles", "prefill,decode", "--rdv", str(out / "rdv_pd"),
               "--requests", str(ELASTIC_PD_REQUESTS), "--device", "cuda",
               *ELASTIC_MODEL, *ELASTIC_PLANE]
    # (b)'s replicas start once (a)'s timed work is done: their start-up
    # (imports, context, weights) overlaps (a)'s oracle and sampled leg;
    # they then wait idle for the router. (c) starts once (b)'s timed runs
    # are done: its processes' start-up overlaps (b)'s oracle
    procs: list = []
    die = {}

    def start_replicas():
        procs.extend(_start_replicas(pd_argv, 3, out))

    def start_die():
        die["t0"] = time.perf_counter()
        die["proc"] = _start_die(out)

    try:
        la, a = _elastic_run(bs, dev, start_replicas)
        emit({"phase": "elastic", "part": "a_run_elastic", "card": card,
              **a})
        lb, b = _elastic_pd(bs, dev, pd_argv, procs, out, start_die)
    except BaseException:
        if "proc" in die:
            _kill_group(die["proc"])
        raise
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    emit({"phase": "elastic", "part": "b_launched_pd", "card": card, **b})
    lc, c = _elastic_die(die["proc"], die["t0"], out)
    emit({"phase": "elastic", "part": "c_launched_death", "card": card,
          **c})
    launches = {k: {"run_elastic": la[k], "launched_pd": lb[k],
                    "launched_death": lc[k]} for k in la}
    emit({"phase": "elastic", "leg": "done", "cuts": ELASTIC_CUTS,
          "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------ observability

# the observe phase: training at the chip widths cut to this depth and
# step count; the allreduce sweep's sizes
OBSERVE_TRAIN = {"n_layers": 2, "steps": 3}
OBSERVE_SWEEP = ["--sweep", "--min-p", "3", "-p", "10"]
# serving untraced (False) and traced (True) in turns, one pair since
# phase tiered joined (the block (F, T, T, F) twice before): the serve
# phase's tokens/s moves ~10% from run to run, so one pair shows equal
# tokens and launches, not the tracing's cost
OBSERVE_TURNS = (False, True)
# each turn serves the stream's first 4 requests (16 until phase pipeline
# joined, 8 until phase analysis did)
OBSERVE_TURN_REQUESTS = 4
# the profiled serving run: the stream's first 4 requests at a budget of
# 32 (each sequence the first 32 tokens of the serve phase's). The
# profiler records every kernel and op, and the whole stream (~150k
# kernels) took it about two minutes on the H100's host (8 requests at 64
# until phase pipeline joined)
OBSERVE_PROFILE = {"requests": 4, "budget": 32}
# the traced serve_app run serves the stream's first 8 requests (16 until
# phase elastic joined; the first 8 give the same engine geometry, so
# each sequence still equals the serve phase's)
OBSERVE_APP_REQUESTS = 8
OBSERVE_CUTS = {"train": "8 layers x 8 steps -> 2 layers x 3 steps",
                "comm": "p 3..25 -> p 3..10",
                "plane": "one closed-loop 1p/1d dma leg",
                "turns": "8 serving runs in turns -> 2, of the stream's "
                         f"first {OBSERVE_TURN_REQUESTS} requests",
                "profiled": f"the stream -> its first "
                            f"{OBSERVE_PROFILE['requests']} requests at "
                            f"{OBSERVE_PROFILE['budget']} tokens",
                "serve_app": f"{N_REQUESTS} -> {OBSERVE_APP_REQUESTS} "
                             "requests (the traced app run)"}


def _observe_reset():
    """Every registry and recorder back to its disabled state."""
    from hpc_patterns_tpu_torch.harness import metrics, reqtrace, trace

    metrics.configure(enabled=False)
    trace.configure(enabled=False)
    reqtrace.reset()


def _balanced(chrome) -> bool:
    depth = {}
    for e in chrome["traceEvents"]:
        if e["ph"] in ("B", "E"):
            depth[e["tid"]] = depth.get(e["tid"], 0) + (
                1 if e["ph"] == "B" else -1)
            if depth[e["tid"]] < 0:
                return False
    return not any(depth.values())


def _observe_serve(ctx, logs):
    """serve_app traced at the serve phase's model and stream, then the
    same engine untraced and traced in turns."""
    from hpc_patterns_tpu_torch.apps import serve_app
    from hpc_patterns_tpu_torch.apps.serve_app import CHIP_MODEL, CHIP_SERVE
    from hpc_patterns_tpu_torch.harness import metrics, report, reqtrace
    from hpc_patterns_tpu_torch.harness import trace as tracelib
    from hpc_patterns_tpu_torch.harness.profiling import device_profile
    from hpc_patterns_tpu_torch.models.serving import ContinuousBatcher
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    s, cfg, want = CHIP_SERVE, ctx["cfg"], ctx["out"]
    dev = torch.device("cuda")
    runs = []

    class Captured(ContinuousBatcher):
        def run(self, **kw):
            got = super().run(**kw)
            runs.append(dict(got))
            return got

    log, out = logs / "serve.jsonl", logs / "serve.trace.json"
    argv = ["--device", "cuda", "--dtype", CHIP_MODEL["dtype"],
            "--vocab", str(CHIP_MODEL["vocab"]),
            "--d-model", str(CHIP_MODEL["d_model"]),
            "--n-layers", str(CHIP_MODEL["n_layers"]),
            "--n-heads", str(CHIP_MODEL["n_heads"]),
            "--requests", str(OBSERVE_APP_REQUESTS),
            "--slots", str(s["slots"]),
            "--chunk", str(s["chunk"]), "--page-size", str(s["page_size"]),
            "--prompt-len", str(s["prompt_len"]),
            "--budget", str(s["max_budget"]), "--metrics", "--trace",
            "--reqtrace", "--trace-out", str(out)]
    orig = serve_app.make_requests, serve_app.ContinuousBatcher
    # the serve phase's stream (the benchmark's) in place of the app's
    serve_app.make_requests = lambda n, plen, budget, vocab, mix: \
        serve_app.bench_stream(n, plen, budget, vocab)
    serve_app.ContinuousBatcher = Captured
    try:
        code, recs = run_app(serve_app.main, argv, log)
    finally:
        serve_app.make_requests, serve_app.ContinuousBatcher = orig
        _observe_reset()
    printed = log.with_suffix(".out").read_text()
    check(code == 0 and "SUCCESS" in printed.splitlines(),
          f"traced serve_app prints SUCCESS (rc {code})")
    measured = runs[-1]
    for i in range(OBSERVE_APP_REQUESTS):
        check(np.array_equal(measured[i], want[i]),
              f"traced serve_app seq {i} == the untraced serve phase's")
    chrome = json.loads(out.read_text())
    dev_x = [e for e in chrome["traceEvents"] if e["ph"] == "X"
             and e["tid"] == tracelib.TID_DEVICE]
    check(_balanced(chrome) and dev_x and all(
        e["args"].get("clock") == tracelib.EVENT_CLOCK for e in dev_x),
        f"Chrome JSON balanced, {len(dev_x)} decode-chunk slices timed "
        "by CUDA events")
    table = report.format_report(report.aggregate(recs))
    check("span.serve.measure/serve.decode_round" in table
          and "serve.tokens" in table, "report renders the phase table")
    (rq,) = [r for r in recs if r["kind"] == "reqtrace"]
    from hpc_patterns_tpu_torch.harness.reqtrace import coverage_frac

    cover = [coverage_frac(r["segments"], r["t_submit"], r["t_finish"])
             for r in rq["requests"].values()]
    check(rq["n"] == OBSERVE_APP_REQUESTS and min(cover) > 0.999,
          f"every request's segments cover its life (min {min(cover)})")
    (snap,) = [r for r in recs if r["kind"] == "metrics"]
    check(snap["counters"]["serve.admitted"] == OBSERVE_APP_REQUESTS
          and snap["counters"]["serve.tokens"] == sum(
              len(want[i]) for i in range(OBSERVE_APP_REQUESTS)),
          f"counters of the measured run: {snap['counters']}")

    # turns: the same engine and stream untraced / traced; ``n`` and
    # ``budget`` serve the stream's first n requests, each cut to budget
    def serve(traced, n=None, budget=None):
        if traced:
            metrics.configure(enabled=True)
            rec = tracelib.configure(enabled=True)
            reqtrace.configure(enabled=True)
        fa.launches["fwd"] = 0
        fd.launches["paged_decode"] = 0
        eng = ContinuousBatcher(ctx["params"], cfg, **ctx["geom"],
                                device=dev)
        t0 = time.perf_counter()
        ids = [eng.submit(p, min(b, budget or b))
               for p, b in ctx["reqs"][:n]]
        got = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = (fa.launches["fwd"], fd.launches["paged_decode"])
        share = None
        if traced:
            chunks = [e[5] for e in rec.events
                      if e[0] == "X" and e[2] == "serve.chunk"]
            share = sum(chunks) / dt
        _observe_reset()
        for i, sid in enumerate(ids):
            check(np.array_equal(got[sid], want[i][:budget]),
                  f"turn (traced {traced}) seq {i} == the serve phase's")
        served = sum(len(v) for v in got.values())
        return served / dt, launched, share

    turns = []
    for traced in OBSERVE_TURNS:
        tps, launched, share = serve(traced, n=OBSERVE_TURN_REQUESTS)
        turns.append({"traced": traced, "tokens_per_s": tps,
                      "launches": launched, "chunk_window_share": share})
    check(len({t["launches"] for t in turns}) == 1,
          f"kernel 1 and 6 launches equal traced and untraced: "
          f"{[t['launches'] for t in turns]}")
    prof = {}

    def profiled():
        prof["tps"], _, prof["share"] = serve(
            True, n=OBSERVE_PROFILE["requests"],
            budget=OBSERVE_PROFILE["budget"])

    busy = device_profile(profiled)
    emit({"phase": "observe", "part": "serve",
          "tokens_per_s_turns": [[t["traced"], t["tokens_per_s"]]
                                 for t in turns],
          "launches_flash_prefill_paged_decode": turns[0]["launches"],
          "chunk_window_share": [t["chunk_window_share"] for t in turns
                                 if t["traced"]],
          "profiled": {**OBSERVE_PROFILE,
                       "chunk_window_share": prof["share"],
                       "profiler_busy_share": busy["device_busy_frac"],
                       "wall_s": busy["wall_s"],
                       "device_kernels": busy["device_kernels"]},
          "device_slices": len(dev_x),
          "reqtrace_coverage_min": min(cover),
          "trace_events": len(chrome["traceEvents"])})


def _observe_train(logs):
    from hpc_patterns_tpu_torch.apps import train_app

    argv = list(TRAIN_BASE)
    argv[argv.index("--n-layers") + 1] = str(OBSERVE_TRAIN["n_layers"])
    argv += ["--steps", str(OBSERVE_TRAIN["steps"]), "--device", "cuda",
             "--metrics", "--trace"]
    try:
        code, recs = run_app(train_app.main, argv, logs / "train.jsonl")
    finally:
        _observe_reset()
    (res,) = [r for r in recs if r.get("kind") == "result"]
    (snap,) = [r for r in recs if r.get("kind") == "metrics"]
    steps = [r for r in recs if r.get("kind") == "step"]
    n = OBSERVE_TRAIN["steps"]
    check(code == 0 and res["success"], f"traced train_app rc {code}")
    check(snap["counters"]["train.steps"] == n == len(steps),
          f"train.steps {snap['counters']['train.steps']} == {n}")
    check(snap["histograms"]["train.step_s"]["count"] == n - 1,
          "train.step_s counts every step after the first")
    check(snap["gauges"]["train.step_time_s"]["last"] == steps[-1]["dt_s"],
          "train.step_time_s == the last step's time")
    emit({"phase": "observe", "part": "train",
          "steps_ms": [r["dt_s"] * 1e3 for r in steps],
          "gauges": sorted(snap["gauges"])})


def _observe_comm(logs):
    from hpc_patterns_tpu_torch.apps import allreduce_app
    from hpc_patterns_tpu_torch.comm.communicator import Communicator
    from hpc_patterns_tpu_torch.harness import metrics
    from hpc_patterns_tpu_torch.harness import trace as tracelib

    try:
        code, recs = run_app(
            allreduce_app.main, OBSERVE_SWEEP + [
                "--world", str(COMM_WORLD), "--device", "cuda",
                "--metrics"], logs / "sweep.jsonl")
    finally:
        _observe_reset()
    res = [r for r in recs if r.get("kind") == "result"]
    (snap,) = [r for r in recs if r.get("kind") == "metrics"]
    check(code == 0 and all(r["success"] for r in res),
          f"allreduce sweep with --metrics rc {code}")
    points = len(res) // len(allreduce_app.ALGORITHMS)
    for alg in allreduce_app.ALGORITHMS:
        last = [r for r in res if r["name"] == f"allreduce[{alg}]"][-1]
        g = snap["gauges"][f"comm.allreduce.{alg}.busbw_gbps"]
        check(g["last"] == last["busbw_gbps"] and g["n"] == points,
              f"{alg}: busbw gauge {g} == the printed {last['busbw_gbps']}")
    # one comm.allreduce span and device window per Communicator call
    reg = metrics.configure(enabled=True)
    rec = tracelib.configure(enabled=True)
    try:
        comm = Communicator({"x": COMM_WORLD}, "x", device="cuda")
        x = comm.rank_filled(1 << 12)
        calls = 0
        for alg in allreduce_app.ALGORITHMS:
            for _ in range(2):
                comm.allreduce(x, alg)
                calls += 1
        comm.synchronize()
        spans = reg.snapshot()["histograms"]["span.comm.allreduce"]["count"]
        wins = [e for e in rec.events if e[0] == "X"
                and e[2].startswith("comm.allreduce.")]
    finally:
        _observe_reset()
    check(spans == calls == len(wins) and all(
        e[6]["clock"] == tracelib.EVENT_CLOCK for e in wins),
        f"{spans} comm.allreduce spans, {len(wins)} windows == {calls} calls")
    emit({"phase": "observe", "part": "comm", "points": len(res),
          "busbw_gauges": {alg: snap["gauges"][
              f"comm.allreduce.{alg}.busbw_gbps"]["last"]
              for alg in allreduce_app.ALGORITHMS},
          "communicator_calls": calls})


def _observe_plane(ctx):
    from hpc_patterns_tpu_torch import bench_serving as bs
    from hpc_patterns_tpu_torch.harness import metrics, reqtrace
    from hpc_patterns_tpu_torch.harness import trace as tracelib

    records, carried = [], []
    stream, geom = ctx["stream"], ctx["geom"]
    reg = metrics.configure(enabled=True)
    rec = tracelib.configure(enabled=True)
    rtr = reqtrace.configure(enabled=True)
    try:
        plane = bs.make_plane(
            stream, ("prefill", "decode"), **geom, migration="dma",
            device=torch.device("cuda"), placed=True,
            slo_targets=bs.slo.targets_from_classes(bs.SCENARIO_CLASSES),
            emit=lambda **kw: records.append(kw))
        dst = plane.replicas[1].engine
        install = dst.install_migration

        def carrying(bundle):
            carried.append(bundle.segments is not None
                           and bundle.segments[-1][0] == "migrating")
            return install(bundle)

        dst.install_migration = carrying
        ids = {r.index: plane.submit(stream["prompts"][r.index], r.max_new,
                                     priority=r.priority)
               for r in stream["schedule"].requests}
        got = plane.run()
        torch.cuda.synchronize()
        counters = reg.snapshot()["counters"]
        windows = [e for e in rec.events if e[0] == "X"
                   and e[2] == "plane.kv_migration"]
        lives = [rtr.segments(rid) for rid in ids.values()]
    finally:
        _observe_reset()
    for i, rid in ids.items():
        check(np.array_equal(got[rid], ctx["dma_outs"][i]),
              f"traced plane request {i} == the plane phase's dma leg")
    migrates = [r for r in records if r["kind"] == "plane_migrate"]
    check(len(migrates) == plane.migrations > 0
          and counters["plane.migrations"] == plane.migrations,
          f"{len(migrates)} plane_migrate records == {plane.migrations} "
          "migrations")
    check(len(carried) == plane.migrations and all(carried),
          f"every migrated bundle carries segments ({sum(carried)}/"
          f"{len(carried)})")
    check(len(windows) == plane.migrations and all(
        e[6]["clock"] == tracelib.EVENT_CLOCK for e in windows),
        "one event-timed window per migration")
    check(all("migrating" in [s[0] for s in life] for life in lives),
          "every request's segments pass through migrating")
    emit({"phase": "observe", "part": "plane",
          "records": {k: sum(1 for r in records if r["kind"] == k)
                      for k in sorted({r["kind"] for r in records})},
          "migrations": plane.migrations, "counters": counters,
          "migration_window_ms": [e[5] * 1e3 for e in windows][:8]})


def phase_observe(serve_ctx, plane_ctx):
    """The observability layer on the card: serve_app traced at the serve
    phase's model and stream (SUCCESS, every sequence equal to the
    untraced serve phase's, a balanced Chrome JSON whose decode-chunk
    slices are timed by CUDA events, the report's phase table, request
    segments covering every life), the engine untraced and traced in
    turns (equal sequences, equal kernel 1 and 6 launches, tokens/s, the
    chunk windows' share of wall time beside a profiler's busy share);
    train_app traced; the allreduce sweep's bandwidth gauges and one span
    per Communicator call; one closed-loop plane leg with emit=."""
    t0 = time.perf_counter()
    logs = ROOT / "build" / "smoke_observe"
    logs.mkdir(parents=True, exist_ok=True)
    seconds = {}
    for part, fn in (("serve", lambda: _observe_serve(serve_ctx, logs)),
                     ("train", lambda: _observe_train(logs)),
                     ("comm", lambda: _observe_comm(logs)),
                     ("plane", lambda: _observe_plane(plane_ctx))):
        t = time.perf_counter()
        fn()
        seconds[part] = time.perf_counter() - t
    emit({"phase": "observe", "cuts": OBSERVE_CUTS,
          "seconds_by_part": seconds, "seconds": time.perf_counter() - t0})


def phase_train():
    """``train_app`` in-process at the training benchmark's chip model
    (dense MLP, then the fused MLP kernels without and with remat),
    ``eval_app`` on the dense run's checkpoint, then the routes on one
    batch: flash against full attention, the split backward against the
    fused one (each named), the fused MLP against the dense one and its
    save-a backward, one step on the fused route, one profiled step."""
    import dataclasses
    import os
    import shutil

    from hpc_patterns_tpu_torch.apps import eval_app
    from hpc_patterns_tpu_torch.harness.profiling import device_profile
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import fused_mlp as fm
    from hpc_patterns_tpu_torch.utils.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    logs = ROOT / "build" / "smoke_train"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    ckdir = logs / "ckpt"
    run = _train_run(TRAIN_ARGV + ["--checkpoint-dir", str(ckdir)],
                     logs / "train.jsonl")
    code, res, losses = run["code"], run["res"], run["losses"]
    launches, passes = run["launches"], run["passes"]
    L = TRAIN_MODEL["n_layers"]
    B, T = TRAIN_BATCH
    cfg = tf.TransformerConfig(**TRAIN_MODEL, max_seq=T, attention="flash")
    n_params = sum(x.numel() for x in tr.tree_leaves(
        tf.init_params(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev, dtype=torch.bfloat16)))
    flops_tok = 6 * n_params + 12 * L * T * cfg.d_model * 0.5  # bench_train

    def speed(r):
        step_s = r["res"]["step_time_s"]
        tflops = flops_tok * B * T / step_s / 1e12
        return {"step_ms": step_s * 1e3, "steps_ms": r["steps_ms"],
                "tokens_per_s": r["res"]["tokens_per_s"],
                "model_tflops": tflops, "share_of_989": tflops / 989,
                "peak_bytes": r["peak_bytes"],
                "peak_over_start_bytes": r["peak_over_start_bytes"]}

    emit({"phase": "train", "argv": TRAIN_ARGV, "cuts": TRAIN_CUTS,
          "rc": code, "success": res["success"], "losses": losses,
          **speed(run), "n_params": n_params,
          "launches": launches, "mlp_launches": run["mlp_launches"],
          "grad_passes": passes["grad"], "decode_steps": passes["decode"],
          "app_seconds": run["app_seconds"],
          "resume": [ln for ln in run["out"].splitlines() if "resume" in ln]})
    check(code == 0 and res["success"], f"train_app SUCCESS (rc {code})")
    check(abs(losses[0] - math.log(cfg.vocab)) < TRAIN_FIRST_LOSS_ATOL,
          f"first loss {losses[0]} near ln {cfg.vocab}")
    check(losses[-1] < losses[0], f"losses decrease: {losses}")
    plan = fa.plan_backward(B, T, T, cfg.n_heads, cfg.head_dim, 2,
                            on_card=True)
    check(not plan["fused"],
          f"the card's auto picks the split route at the chip shape: {plan}")
    check(launches["fwd_lse"] == L * passes["grad"]
          and launches["dq"] == L * passes["grad"]
          and launches["dkv"] == L * passes["grad"]
          and launches["fused_bwd"] == 0,
          f"training launches == {L} layers x {passes['grad']} grad "
          f"passes: {launches}")
    check(launches["fwd"] == L, f"generate's prefill ran the forward once "
          f"per layer: {launches}")
    n_new = int(TRAIN_ARGV[TRAIN_ARGV.index("--generate") + 1])
    check(passes["decode"] == n_new - 1
          and launches["flash_decode"] == L * passes["decode"],
          f"generate's {passes['decode']} decode steps ran flash_decode once "
          f"per layer: {launches}")
    check(not any(run["mlp_launches"].values()),
          f"the dense run launched no fused MLP kernel: {run['mlp_launches']}")
    train_launches = {"flash_fwd_lse": launches["fwd_lse"],
                      "dq": launches["dq"], "dkv": launches["dkv"],
                      "flash_decode": launches["flash_decode"]}

    # the fused MLP kernels on the same seed and batch, without and with
    # remat: the MLP forward and the flash forward run once per layer and
    # gradient pass, twice under "nothing" (the region's recompute reruns
    # both kernels), once under "split" (both outside every region)
    fused_runs = {}
    for name, extra in FUSED_RUNS.items():
        r = _train_run(["--steps", str(extra["steps"]), *TRAIN_BASE,
                        *extra["argv"]], logs / f"{name}.jsonl")
        la, ml, p = r["launches"], r["mlp_launches"], r["passes"]["grad"]
        fused_runs[name] = r
        emit({"phase": "train", "run": name, "argv": extra["argv"],
              "steps": extra["steps"], "rc": r["code"],
              "success": r["res"]["success"], "losses": r["losses"],
              **speed(r), "launches": la, "mlp_launches": ml,
              "grad_passes": p, "app_seconds": r["app_seconds"]})
        check(r["code"] == 0 and r["res"]["success"],
              f"train_app {name} SUCCESS (rc {r['code']})")
        reruns = 2 if "nothing" in extra["argv"] else 1
        check(ml["fwd"] == L * p * reruns and la["fwd_lse"] == L * p * reruns
              and ml["bwd_dx"] == L * p and ml["bwd_dw"] == L * p
              and la["dq"] == la["dkv"] == L * p and ml["fwd_save_a"] == 0
              and la["fused_bwd"] == la["fwd"] == 0,
              f"{name}: launches == {L} layers x {p} grad passes (forwards "
              f"x {reruns}): {la} {ml}")
    first = fused_runs["fused"]["losses"]
    for name, r in fused_runs.items():
        n = len(r["losses"])
        check(all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
                  for a, b in zip(r["losses"], first[:n])),
              f"{name} losses {r['losses']} follow the fused run's {first}")

    code, recs = run_app(eval_app.main, [
        "--device", "cuda", "--checkpoint-dir", str(ckdir), "--batches",
        "2", "--batch", str(B), "--seq", str(T), "--d-model",
        str(cfg.d_model), "--n-layers", str(L), "--n-heads",
        str(cfg.n_heads), "--vocab", str(cfg.vocab), "--attention",
        "flash"], logs / "eval.jsonl")
    (ev,) = [r for r in recs if r.get("kind") == "result"]
    emit({"phase": "train", "eval": {k: ev[k] for k in (
        "success", "mean_nll", "perplexity", "batches")}})
    check(code == 0 and ev["success"], f"eval_app on the checkpoint: {ev}")

    # the routes on one batch, at the trained state from the checkpoint
    params, opt_state = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params, opt_state, _ = restore_checkpoint(ckdir, params, opt_state)
    shutil.rmtree(ckdir)
    leaves = tr.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    names = _leaf_names(params)
    tokens = tr.make_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                           B, T, device=dev)

    def routed(route, fn):
        """``fn()`` with the model's attention on the backward route
        ``route`` by name (None: the card's auto, split)"""
        orig = tf.flash_attention
        if route is not None:
            tf.flash_attention = functools.partial(fa.flash_attention,
                                                   bwd=route)
        try:
            return fn()
        finally:
            tf.flash_attention = orig

    def loss_grads(c, route=None):
        def run():
            loss = tf.loss_fn(params, tokens, c)
            return loss.item(), torch.autograd.grad(loss, leaves)
        return routed(route, run)

    l_flash, g_flash = loss_grads(cfg)
    l_full, g_full = loss_grads(dataclasses.replace(cfg, attention="full"))
    gap_full = _cosine_gaps(names, g_flash, g_full)
    del g_full
    fused_cfg = dataclasses.replace(cfg, mlp_impl="fused")
    l_fused, g_fused = loss_grads(fused_cfg)
    gap_fused = _cosine_gaps(names, g_flash, g_fused)
    # the save-a forward kernel on the path: HPCPAT_FUSED_MLP_BWD=xla_a
    for key in fm.launches:
        fm.launches[key] = 0
    os.environ["HPCPAT_FUSED_MLP_BWD"] = "xla_a"
    try:
        l_xla_a, g_xla_a = loss_grads(fused_cfg)
    finally:
        del os.environ["HPCPAT_FUSED_MLP_BWD"]
    xla_a_launches = dict(fm.launches)
    gap_xla_a = _cosine_gaps(names, g_fused, g_xla_a)
    del g_fused, g_xla_a
    del g_flash
    # the two backward routes by name: fused (kernel 2 and the slab) and
    # split (kernels 3 and 4, the card's auto)
    l_fused_route, g_fused_route = loss_grads(cfg, "fused")
    l_split, g_split = loss_grads(cfg, "split")
    gap_split = _cosine_gaps(names, g_fused_route, g_split)
    del g_fused_route, g_split
    for key in fa.launches:
        fa.launches[key] = 0
    step = tr.make_train_step(cfg)
    l_step = routed("fused", lambda: step(params, opt_state, tokens)[0]
                    .item())
    fused_launches = dict(fa.launches)
    prof = device_profile(lambda: step(params, opt_state, tokens)[0].item())
    worst_full = max(gap_full.values())
    worst_split = max(gap_split.values())
    worst_fused = max(gap_fused.values())
    worst_xla_a = max(gap_xla_a.values())
    emit({"phase": "train", "routes": {
        "params": "trained (the checkpoint of step 8)",
        "loss_flash": l_flash, "loss_full": l_full,
        "loss_rel_diff": abs(l_flash - l_full) / abs(l_full),
        "grad_gap_flash_full": gap_full, "loss_fused_route": l_fused_route,
        "loss_split_route": l_split, "grad_gap_fused_split": gap_split,
        "loss_fused_step": l_step, "fused_step_launches": fused_launches,
        "loss_fused_mlp": l_fused,
        "loss_fused_mlp_rel_diff": abs(l_fused - l_flash) / abs(l_flash),
        "grad_gap_dense_fused_mlp": gap_fused, "loss_xla_a": l_xla_a,
        "grad_gap_fused_mlp_kernel_xla_a": gap_xla_a,
        "xla_a_launches": xla_a_launches},
        "tol": {"loss_rel": TRAIN_LOSS_RTOL, "gap_full": TRAIN_GAP_FULL,
                "gap_split": TRAIN_GAP_SPLIT,
                "loss_rel_fused_mlp": TRAIN_LOSS_MLP_RTOL,
                "gap_fused_mlp": TRAIN_GAP_MLP,
                "gap_xla_a": TRAIN_GAP_XLA_A},
        "profile_one_step": prof,
        "seconds": time.perf_counter() - t_phase})
    check(abs(l_flash - l_full) <= TRAIN_LOSS_RTOL * abs(l_full)
          and worst_full <= TRAIN_GAP_FULL,
          f"flash vs full: loss {l_flash} vs {l_full}, worst leaf 1 - "
          f"cosine {worst_full}")
    check(l_split == l_flash and l_fused_route == l_flash
          and l_step == l_flash and worst_split <= TRAIN_GAP_SPLIT,
          f"split vs fused route: loss {l_split}/{l_fused_route}/{l_step} "
          f"vs {l_flash}, worst leaf 1 - cosine {worst_split}")
    check(fused_launches["fused_bwd"] == L and fused_launches["dq"] == 0
          and fused_launches["dkv"] == 0 and fused_launches["fwd_lse"] == L,
          f"the fused step launched fused_bwd once per layer: "
          f"{fused_launches}")
    check(abs(l_fused - l_flash) <= TRAIN_LOSS_MLP_RTOL * abs(l_flash)
          and worst_fused <= TRAIN_GAP_MLP,
          f"fused vs dense MLP: loss {l_fused} vs {l_flash}, worst leaf 1 - "
          f"cosine {worst_fused}")
    check(l_xla_a == l_fused and worst_xla_a <= TRAIN_GAP_XLA_A
          and xla_a_launches["fwd_save_a"] == L
          and xla_a_launches["fwd"] == xla_a_launches["bwd_dx"] == 0,
          f"xla_a: loss {l_xla_a} vs {l_fused}, worst leaf 1 - cosine "
          f"{worst_xla_a}, launches {xla_a_launches}")
    train_launches.update(fused_bwd=fused_launches["fused_bwd"])
    by_run = {n: r["mlp_launches"] for n, r in fused_runs.items()}
    mlp = {k: sum(m[k] for m in by_run.values())
           for k in ("fwd", "bwd_dx", "bwd_dw")}
    train_launches.update(
        fused_mlp_fwd=mlp["fwd"], fused_mlp_bwd_dx=mlp["bwd_dx"],
        fused_mlp_bwd_dw=mlp["bwd_dw"],
        fused_mlp_fwd_save_a=xla_a_launches["fwd_save_a"],
        fused_mlp_by_run=by_run)
    for name in ("fused_mlp_fwd", "fused_mlp_fwd_save_a", "fused_mlp_bwd_dx",
                 "fused_mlp_bwd_dw"):
        check(train_launches[name] > 0, f"{name} ran on the main path")
    return train_launches


# ------------------------------------------------ parallel (logical ranks)


def _par_argv(attention: str, steps: int, extra=()) -> list:
    """The training cell's argv at ``attention``, ``steps`` steps."""
    base = list(TRAIN_BASE)
    base[base.index("--attention") + 1] = attention
    return ["--steps", str(steps), *base, *extra]


def _par_ring(gen) -> dict:
    """(a) ``ring_attention`` alone: the shifts' bytes, ring_flash and the
    dense ring (and Ulysses' flash route) against ``flash_attention`` on the
    gathered sequence, one counted entry-point call, each route's ms."""
    from hpc_patterns_tpu_torch.comm import fused
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.parallel.ring_attention import (
        _kv_rotate,
        ring_attention,
    )
    from hpc_patterns_tpu_torch.parallel.ulysses import ulysses_attention

    P, B, T, H, D = PAR_RING.values()
    rows, counted = {}, {}
    for Hkv in (H, 2):
        def qkv():
            return [torch.randn(P, B, T, h, D, generator=gen, device="cuda")
                    .bfloat16() for h in (H, Hkv, Hkv)]

        q, k, v = qkv()
        gathered = [t.movedim(0, 1).flatten(1, 2) for t in (q, k, v)]
        ref = fa.flash_attention(*gathered, causal=True)

        def err(o):
            return (o.movedim(0, 1).flatten(1, 2).float()
                    - ref.float()).abs().max().item()

        shifted = [_kv_rotate(s)((k, v)) for s in ("fused", "ppermute")]
        same_bytes = all(torch.equal(a, b) for a, b in zip(*shifted))
        torch.cuda.synchronize()
        for key in fa.launches:
            fa.launches[key] = 0
        fused.launches["fused_permute"] = 0
        got = ring_attention(q, k, v, causal=True, impl="flash",
                                shift_impl="fused")
        torch.cuda.synchronize()
        launches = {"fwd_lse": fa.launches["fwd_lse"],
                    "fused_permute": fused.launches["fused_permute"]}
        if Hkv == H:
            counted = launches
        pp = ring_attention(q, k, v, causal=True, impl="flash")
        routes = {
            "ring_flash_fused": got, "ring_flash_ppermute": pp,
            "ring_dense": ring_attention(q, k, v, causal=True),
            "ulysses_flash": ulysses_attention(q, k, v, causal=True,
                                               impl="flash")}
        row = {"Hkv": Hkv, "shifts_equal_bytes": same_bytes,
               "fused_equals_ppermute": torch.equal(got, pp),
               "max_abs_err": {n: err(o) for n, o in routes.items()},
               "launches_a_call": launches,
               "want_launches_a_call": {"fwd_lse": P * (P + 1) // 2,
                                        "fused_permute": 2 * (P - 1)}}
        check(same_bytes and row["fused_equals_ppermute"],
              f"ring Hkv {Hkv}: the fused and ppermute shifts move equal "
              "bytes")
        check(all(e <= PAR_ATOL for e in row["max_abs_err"].values()),
              f"ring Hkv {Hkv}: routes within {PAR_ATOL} of flash on the "
              f"gathered sequence: {row['max_abs_err']}")
        check(launches == row["want_launches_a_call"],
              f"ring Hkv {Hkv}: launches {launches} == "
              f"{row['want_launches_a_call']}")
        if Hkv == H:
            sets = [qkv() for _ in range(n_sets(3 * q.numel() * 2))]
            gsets = [[t.movedim(0, 1).flatten(1, 2).contiguous() for t in x]
                     for x in sets]
            ms = {
                "ring_flash_fused": device_ms(lambda *x: ring_attention(
                    *x, causal=True, impl="flash", shift_impl="fused"),
                    sets, 10),
                "ring_flash_ppermute": device_ms(lambda *x: ring_attention(
                    *x, causal=True, impl="flash"), sets, 10),
                "ring_dense": device_ms(lambda *x: ring_attention(
                    *x, causal=True), sets, 5),
                "ulysses_flash": device_ms(lambda *x: ulysses_attention(
                    *x, causal=True, impl="flash"), sets, 10),
                "flash_gathered": device_ms(lambda *x: fa.flash_attention(
                    *x, causal=True), gsets, 10)}
            flops = 4 * B * H * (P * T) ** 2 * D / 2  # causal: half
            nbytes = 2 * (2 * q.numel() + 2 * k.numel())
            row["ms"] = ms
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOPS_PER_S)
        rows[f"Hkv{Hkv}"] = row
    return {"rows": rows, "counted": counted}


def _par_grads(params, tokens, cfg, mesh=None):
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf

    leaves = tr.tree_leaves(params)
    loss = tf.loss_fn(params, tokens, cfg, mesh)
    return loss.item(), torch.autograd.grad(loss, leaves)


def phase_parallel():
    """The sp and ep axes as logical ranks of the card (module docstring,
    item 12): (a) ring attention alone, (b) the sp training runs, (c) the
    MoE training run with its generate, (d) ep 4 against no mesh."""
    import dataclasses
    import shutil

    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    dev = torch.device("cuda")
    logs = ROOT / "build" / "smoke_parallel"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)

    ring = _par_ring(torch.Generator(device="cuda").manual_seed(7))
    emit({"phase": "parallel", "part": "a_ring", "card": card,
          "shape": PAR_RING, "tol": PAR_ATOL, **ring["rows"]})

    # (b) the sp runs: the first loss and every gradient leaf at init
    # against flash, then train_app at sp 4 for each flash route
    L = TRAIN_MODEL["n_layers"]
    B, T = TRAIN_BATCH
    P = PAR_RING["P"]
    cfg = tf.TransformerConfig(**TRAIN_MODEL, max_seq=T, attention="flash")
    params, _ = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tokens = tr.make_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                           B, T, device=dev)
    names = _leaf_names(params)
    l_flash, g_flash = _par_grads(params, tokens, cfg)
    launches = {"fwd_lse": ring["counted"]["fwd_lse"], "dq": 0, "dkv": 0,
                "fwd": 0, "flash_decode": 0,
                "fused_permute": ring["counted"]["fused_permute"]}
    sp_rows = {}
    for attention, blocks in (("ring_flash", P * (P + 1) // 2),
                              ("ulysses_flash", 1)):
        c = dataclasses.replace(cfg, attention=attention)
        l_sp, g_sp = _par_grads(params, tokens, c, {"sp": P})
        gaps = _cosine_gaps(names, g_flash, g_sp)
        del g_sp
        run = _train_run(_par_argv(attention, PAR_SP_STEPS,
                                   ("--sp", str(P))),
                         logs / f"{attention}.jsonl")
        la, passes = run["launches"], run["passes"]["grad"]
        res, losses = run["res"], run["losses"]
        row = {"argv_attention": attention, "sp": P, "rc": run["code"],
               "success": res["success"], "mesh": res.get("mesh"),
               "mesh_ranks": res.get("mesh_ranks"), "losses": losses,
               "loss_init": l_sp, "loss_flash_init": l_flash,
               "loss_rel_diff": abs(l_sp - l_flash) / abs(l_flash),
               "first_step_rel_diff": abs(losses[0] - l_flash) / abs(l_flash),
               "worst_grad_gap": max(gaps.values()), "grad_gaps": gaps,
               "step_ms": res["step_time_s"] * 1e3,
               "steps_ms": run["steps_ms"],
               "tokens_per_s": res["tokens_per_s"],
               "peak_bytes": run["peak_bytes"], "launches": la,
               "grad_passes": passes, "blocks_a_layer": blocks}
        sp_rows[attention] = row
        emit({"phase": "parallel", "part": "b_sp", "card": card, **row,
              "tol": {"loss_rel": PAR_LOSS_RTOL, "gap": PAR_GAP}})
        check(run["code"] == 0 and res["success"]
              and res.get("mesh_ranks") == "logical ranks of one device",
              f"train_app {attention} --sp {P} SUCCESS on logical ranks")
        check(row["loss_rel_diff"] <= PAR_LOSS_RTOL
              and row["first_step_rel_diff"] <= PAR_LOSS_RTOL
              and row["worst_grad_gap"] <= PAR_GAP,
              f"{attention} vs flash: loss {l_sp}/{losses[0]} vs {l_flash},"
              f" worst leaf 1 - cosine {row['worst_grad_gap']}")
        want = L * blocks * passes
        check(la["fwd_lse"] == la["dq"] == la["dkv"] == want
              and la["fused_bwd"] == 0,
              f"{attention}: kernel 1/3/4 launches == {L} layers x {blocks} "
              f"blocks x {passes} passes: {la}")
        for key in ("fwd_lse", "dq", "dkv"):
            launches[key] += la[key]
    del g_flash

    # (c) the MoE cell: train, drop rates, generate
    run = _train_run(PAR_MOE_ARGV, logs / "moe.jsonl")
    la, passes, res = run["launches"], run["passes"], run["res"]
    steps = [json.loads(x) for x in (logs / "moe.jsonl").read_text()
             .splitlines()]
    drops = {r["step"]: r["moe_drop_rate"] for r in steps
             if r.get("kind") == "step" and "moe_drop_rate" in r}
    mcfg = dataclasses.replace(cfg, n_experts=8, n_experts_top_k=2)
    E, k, D, F = 8, 2, mcfg.d_model, mcfg.d_ff
    N = B * T
    C = int(N * k * mcfg.capacity_factor / E)
    mparams = tf.init_params(mcfg, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev,
                             dtype=torch.bfloat16)
    n_params = sum(x.numel() for x in tr.tree_leaves(mparams))
    n_expert = L * E * 2 * D * F
    n_router = L * D * E
    del mparams
    # bench_train's 6 x params + attention per token for everything but the
    # experts and the router; the experts by E x C slots as the code
    # computes them (padding slots included), 3 x the forward's 4 E C D F
    flops = (N * (6 * (n_params - n_expert - n_router)
                  + 12 * L * T * D * 0.5)
             + 12 * L * E * C * D * F + 6 * L * N * D * E)
    step_s = res["step_time_s"]
    moe_row = {"argv": PAR_MOE_ARGV, "rc": run["code"],
               "success": res["success"], "losses": run["losses"],
               "drop_rates": drops, "capacity": C, "n_params": n_params,
               "expert_params": n_expert, "step_ms": step_s * 1e3,
               "steps_ms": run["steps_ms"],
               "tokens_per_s": res["tokens_per_s"],
               "model_tflops": flops / step_s / 1e12,
               "flops_counted": "experts by E x C slots",
               "peak_bytes": run["peak_bytes"],
               "peak_over_start_bytes": run["peak_over_start_bytes"],
               "launches": la, "grad_passes": passes["grad"],
               "decode_steps": passes["decode"]}
    emit({"phase": "parallel", "part": "c_moe", "card": card, **moe_row})
    losses = run["losses"]
    check(run["code"] == 0 and res["success"], "MoE train_app SUCCESS")
    check(losses[-1] < losses[0], f"MoE losses fall: {losses}")
    check(sorted(drops) == [0, 2, 4, 6]
          and all(0.0 <= d < 1.0 for d in drops.values()),
          f"the drop rate on every second step: {drops}")
    n_new = int(PAR_MOE_ARGV[PAR_MOE_ARGV.index("--generate") + 1])
    check(passes["decode"] == n_new - 1
          and la["flash_decode"] == L * passes["decode"],
          f"MoE generate's {passes['decode']} decode steps ran kernel 5 once "
          f"per layer: {la}")
    check(la["fwd_lse"] == la["dq"] == la["dkv"] == L * passes["grad"]
          and la["fwd"] == L * (1 + len(drops)),
          f"MoE kernel 1/3/4 launches == {L} x {passes['grad']} passes, "
          f"the forward once a layer for generate's prefill and each drop "
          f"reading: {la}")
    for key in ("fwd_lse", "dq", "dkv", "fwd", "flash_decode"):
        launches[key] += la[key]

    # (d) ep 4 on logical ranks against no mesh, drop-free
    ecfg = dataclasses.replace(mcfg, capacity_factor=8.0)
    eparams = tf.init_params(ecfg, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    ep_row = {"capacity_factor": 8.0, "ep": P, "tol": PAR_EP_RTOL}
    with torch.no_grad(), warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        for rows in (2, B):
            toks = tokens[:rows]
            for name, mesh in (("ep1", None), (f"ep{P}", {"ep": P})):
                logits, aux = tf.forward(eparams, toks, ecfg, mesh,
                                         return_aux=True)
                nll = tf.masked_causal_nll(logits, toks).item()
                del logits
                ep_row.setdefault(f"batch{rows}", {})[name] = {
                    "nll": nll, "aux": aux.item(),
                    "loss": nll + ecfg.moe_aux_weight * aux.item(),
                    "drop_rate": tf.moe_drop_rates(eparams, toks, ecfg,
                                                   mesh).max().item()}
            one, many = (ep_row[f"batch{rows}"][n] for n in ("ep1",
                                                               f"ep{P}"))
            ep_row[f"batch{rows}"].update({
                f"{k}_rel_diff": abs(many[k] - one[k]) / abs(one[k])
                for k in ("nll", "loss")})
            check(one["drop_rate"] == many["drop_rate"] == 0.0,
                  f"ep at capacity_factor 8 drops nothing: {ep_row}")
    ep_row["replicated_routing_warned"] = any(
        "routing runs replicated" in str(w.message) for w in warned)
    emit({"phase": "parallel", "part": "d_ep", "card": card, **ep_row})
    check(ep_row["replicated_routing_warned"]
          and ep_row["batch2"]["loss_rel_diff"] <= PAR_EP_RTOL
          and ep_row[f"batch{B}"]["nll_rel_diff"] <= PAR_EP_RTOL,
          f"ep {P} vs ep 1 drop-free: the loss (2 rows, routing "
          f"replicated), the NLL ({B} rows, partitioned): {ep_row}")
    del eparams

    # (e) one profiled step of the MoE cell and of ring_flash at sp 4
    from hpc_patterns_tpu_torch.harness.profiling import device_profile

    prof = {}
    for name, c, mesh in (("moe", mcfg, None),
                          ("ring_flash_sp4", dataclasses.replace(
                              cfg, attention="ring_flash"), {"sp": P})):
        p_, s_ = tr.init_train_state(torch.Generator(device=dev)
                                     .manual_seed(0), c, device=dev)
        step = tr.make_train_step(c, mesh=mesh)
        step(p_, s_, tokens)[0].item()

        def one_step():
            return step(p_, s_, tokens)[0].item()

        prof[name] = device_profile(one_step, top=8)
        del p_, s_, step
    emit({"phase": "parallel", "part": "e_profile", "card": card, **prof})

    # (f) the scatter dispatch at top-3, twice: equal loss and gradient
    # bits (three terms a token summed in a fixed order, not by atomics)
    kcfg = dataclasses.replace(cfg, **PAR_TOP3, moe_dispatch="scatter")
    kparams, _ = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(0), kcfg, device=dev)
    t0 = time.perf_counter()
    runs = [_par_grads(kparams, tokens, kcfg) for _ in range(2)]
    (l0, g0), (l1, g1) = runs
    equal = [bool(torch.equal(a, b)) for a, b in zip(g0, g1)]
    top3 = {**PAR_TOP3, "dispatch": "scatter", "losses": [l0, l1],
            "loss_equal": l0 == l1, "leaves": len(equal),
            "leaves_equal": sum(equal),
            "seconds": time.perf_counter() - t0}
    emit({"phase": "parallel", "part": "f_top3_twice", "card": card,
          **top3, "seconds_phase": time.perf_counter() - t_phase,
          "cuts": PAR_CUTS})
    check(top3["loss_equal"] and all(equal),
          f"MoE scatter at top-3 twice: equal loss and gradient bits {top3}")
    del kparams, runs, g0, g1
    return launches


# ------------------------------------------------ sharded (dp/fsdp/tp)


def _shard_grads(cfg, mesh, tokens):
    """A train state on ``mesh`` (None: no mesh) from seed 0, and its
    loss and global f32 gradients (in ``tree_leaves`` order) at init."""
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf

    dev = torch.device("cuda")
    params, opt = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
        mesh=mesh)
    leaves = tr.tree_leaves(params)
    loss = tf.loss_fn(params, tokens, cfg, mesh)
    grads = torch.autograd.grad(loss, leaves)
    if mesh is not None:
        from hpc_patterns_tpu_torch.models import sharding as sh

        grads = tr.tree_leaves(sh.unshard_params(tr.tree_map(
            dict(zip(map(id, leaves), grads)).__getitem__,
            tr.tree_map(id, params)), mesh, cfg))
    return loss.item(), [g.float() for g in grads], params, opt


def _shard_step_stats(cfg, mesh, tokens):
    """:func:`_shard_grads`, then the state's step's :func:`_step_stats`."""
    from hpc_patterns_tpu_torch.models import train as tr

    loss, grads, params, opt = _shard_grads(cfg, mesh, tokens)
    stats = _step_stats(tr.make_train_step(cfg, mesh=mesh), params, opt,
                        tokens)
    del params, opt
    torch.cuda.empty_cache()
    return loss, grads, stats


def _shard_serve(cfg_base, dev):
    """(c): generate and paged_generate at ``{"tp": SHARD_TP}`` on bf16
    and int8 caches against the unsharded route on the card, tie-aware;
    kernel 1, 5, 6 (6q) launches of the sharded runs counted."""
    import dataclasses

    from hpc_patterns_tpu_torch.bench_serving import TIE_TOL
    from hpc_patterns_tpu_torch.models import decode as dec
    from hpc_patterns_tpu_torch.models import sharding as sh
    from hpc_patterns_tpu_torch.models.serving import tie_aware_compare
    from hpc_patterns_tpu_torch.models.transformer import init_params
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import flash_decode as fd

    s = SHARD_SERVE
    mesh = {"tp": SHARD_TP}
    L = cfg_base.n_layers
    tol = TIE_TOL[cfg_base.dtype]
    prompt = torch.randint(0, cfg_base.vocab, (s["rows"], s["prompt_len"]),
                           generator=torch.Generator(device=dev)
                           .manual_seed(3), device=dev, dtype=torch.int32)
    rows, launches = {}, {"fwd": 0, "flash_decode": 0, "paged_decode": 0,
                          "paged_decode_quant": 0}
    for kv in ("compute", "int8"):
        cfg = dataclasses.replace(
            cfg_base, kv_cache_dtype=kv,
            max_seq=s["prompt_len"] + s["new_tokens"])
        params = init_params(cfg, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev,
                             dtype=torch.bfloat16)
        sharded = sh.shard_params(params, mesh, cfg)
        with torch.no_grad():
            want_lg = dec.prefill(params, prompt, cfg, cfg.max_seq)[0]
            got_lg = dec.prefill(sharded, prompt, cfg, cfg.max_seq,
                                 mesh=mesh)[0]
        lg_rel = ((got_lg - want_lg).abs().max()
                  / want_lg.abs().max()).item()
        check(lg_rel <= SHARD_LOGITS_RTOL,
              f"tp prefill logits {kv}: {lg_rel} > {SHARD_LOGITS_RTOL}")
        rows[f"prefill_logits_rel_diff_{kv}"] = lg_rel
        if kv == "compute":  # one profiled call each: the busy shares
            from hpc_patterns_tpu_torch.harness.profiling import (
                device_profile,
            )

            with torch.no_grad():
                rows["busy_frac_linear_unsharded"] = device_profile(
                    lambda: dec.generate(params, prompt, cfg, 16,
                                         device=dev))["device_busy_frac"]
                rows["busy_frac_linear_tp4"] = device_profile(
                    lambda: dec.generate(sharded, prompt, cfg, 16,
                                         device=dev, mesh=mesh)
                )["device_busy_frac"]
        for route in ("linear", "paged"):
            fn = (functools.partial(dec.paged_generate, page_size=s["page"])
                  if route == "paged" else dec.generate)
            with torch.no_grad():
                t0 = time.perf_counter()
                want, margins = fn(params, prompt, cfg, s["new_tokens"],
                                   device=dev, with_margins=True)
                torch.cuda.synchronize()
                t_plain = time.perf_counter() - t0
                fa.launches["fwd"] = 0
                fd.launches["flash_decode"] = fd.launches["paged_decode"] = 0
                t0 = time.perf_counter()
                got = fn(sharded, prompt, cfg, s["new_tokens"], device=dev,
                         mesh=mesh)
                torch.cuda.synchronize()
                t_tp = time.perf_counter() - t0
            n = {"fwd": fa.launches["fwd"],
                 "flash_decode": fd.launches["flash_decode"],
                 "paged_decode": fd.launches["paged_decode"]}
            key = "flash_decode" if route == "linear" else "paged_decode"
            steps = s["new_tokens"] - 1
            check(n["fwd"] == L and n[key] == L * steps
                  and sum(n.values()) == L * (1 + steps),
                  f"tp {route} {kv}: kernel 1 once and the decode kernel "
                  f"{steps} times a layer, in one launch over the folded "
                  f"ranks: {n}")
            verdicts = [tie_aware_compare(got[i].cpu().numpy(),
                                          want[i].cpu().numpy(),
                                          margins[i].cpu().numpy(), tol)
                        for i in range(s["rows"])]
            check("mismatch" not in verdicts,
                  f"tp {route} {kv} tokens tie-aware on the unsharded "
                  f"route: {verdicts}")
            launches["fwd"] += n["fwd"]
            if route == "linear":
                launches["flash_decode"] += n[key]
            else:
                launches["paged_decode_quant" if kv == "int8"
                         else "paged_decode"] += n[key]
            firsts = [int(np.nonzero((got[i] != want[i]).cpu().numpy())[0][0])
                      if v != "exact" else None
                      for i, v in enumerate(verdicts)]
            rows[f"{route}_{kv}"] = {
                "verdicts": verdicts, "first_divergence_step": firsts,
                "launches": n,
                "tp_ms_a_token": t_tp * 1e3 / s["new_tokens"],
                "unsharded_ms_a_token": t_plain * 1e3 / s["new_tokens"]}
        del params, sharded
    return rows, launches


def _shard_launched(out_dir):
    """(d): the two launched legs (started together: they share the card
    and the host), then each against one process's run of the same
    global mesh."""
    from hpc_patterns_tpu_torch.apps import train_app

    legs = {"dp4": (["--dp", "4"], [], ["--dp", "4"]),
            "dcn_dp": (["--dcn-dp", "--dp", "-1", "--tp", "2"],
                       ["--slices", "2"], ["--dp", "2", "--tp", "2"])}
    t0 = time.perf_counter()
    procs = {name: _start_launch(launch_args, [
        sys.executable, "-m", f"{PKG}.apps.train_app", *SHARD_LAUNCH_ARGV,
        *flags]) for name, (flags, launch_args, _) in legs.items()}
    done = {name: _finish_launch(proc, out_dir, name)
            for name, proc in procs.items()}
    wall = time.perf_counter() - t0
    rows = {"wall_s_both": wall}
    for name, (code, text) in done.items():
        losses = [json.loads(ln.split("losses ", 1)[1])
                  for ln in text.splitlines() if "one flat allreduce" in ln]
        check(code == 0 and text.count("SUCCESS") >= 3 and len(losses) == 2
              and losses[0] == losses[1],
              f"launched {name}: exit {code}, both processes SUCCESS on "
              f"one update: {losses} ({out_dir / name}.out)")
        c1, recs = run_app(train_app.main, SHARD_LAUNCH_ARGV + legs[name][2],
                           out_dir / f"{name}_one.jsonl")
        (res,) = [r for r in recs if r.get("kind") == "result"]
        one_losses = [r["loss"] for r in recs if r.get("kind") == "step"]
        err = max(abs(a - b) / abs(b) for a, b in zip(losses[0], one_losses))
        check(c1 == 0 and err <= SHARD_LAUNCH_RTOL,
              f"launched {name} losses {losses[0]} vs one process "
              f"{one_losses}: {err} > {SHARD_LAUNCH_RTOL}")
        rows[name] = {"rc": code, "losses": losses[0],
                      "one_process_losses": one_losses, "max_rel_err": err,
                      "wire": [ln.split("over ", 1)[1].split(";")[0]
                               for ln in text.splitlines()
                               if "one flat allreduce" in ln][0],
                      "launched_step_ms": [
                          float(ln.split(" ms/step")[0].rsplit(" ", 1)[1])
                          for ln in text.splitlines()
                          if "ms/step" in ln and "train[" in ln],
                      "one_process_step_ms": res["step_time_s"] * 1e3}
    return rows


def _shard_row(row: dict) -> dict:
    """A kernel row's numbers at its shard shape, for the kernels line."""
    return {k: row[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "library_ms") if k in row}


def phase_sharded():
    """dp, fsdp and tp as logical ranks of the card (module docstring,
    item 12a). Returns the main path's launches by kernel and the shard
    shapes' kernel rows."""
    import dataclasses
    import os
    import shutil

    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf
    from hpc_patterns_tpu_torch.ops import fused_mlp as fm

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    dev = torch.device("cuda")
    logs = ROOT / "build" / "smoke_sharded"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    L = TRAIN_MODEL["n_layers"]
    B, T = TRAIN_BATCH
    cfg = tf.TransformerConfig(**TRAIN_MODEL, max_seq=T, attention="flash",
                               mlp_impl="fused")
    tokens = tr.make_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                           B, T, device=dev)
    names = _leaf_names(tf.init_params(
        dataclasses.replace(cfg, n_layers=1),
        generator=torch.Generator().manual_seed(0), device="cpu"))
    launches = {k: 0 for k in ("fwd", "fwd_lse", "dq", "dkv", "mlp_fwd",
                               "mlp_fwd_save_a", "mlp_bwd_dx", "mlp_bwd_dw",
                               "flash_decode", "paged_decode",
                               "paged_decode_quant")}

    # (a) tp 4 against no mesh at init, the two steps' stats, the app
    l0, g0, st0 = _shard_step_stats(cfg, None, tokens)
    mesh = {"tp": SHARD_TP}
    l1, g1, st1 = _shard_step_stats(cfg, mesh, tokens)
    gap = _cosine_gaps(names, g0, g1)
    del g1
    for key in fm.launches:
        fm.launches[key] = 0
    os.environ["HPCPAT_FUSED_MLP_BWD"] = "xla_a"
    try:
        la, ga = _shard_grads(cfg, mesh, tokens)[:2]
    finally:
        del os.environ["HPCPAT_FUSED_MLP_BWD"]
    gap_a = _cosine_gaps(names, g0, ga)
    del g0, ga
    save_a = fm.launches["fwd_save_a"]
    run = _train_run(["--steps", str(SHARD_STEPS), *TRAIN_BASE, "--tp",
                      str(SHARD_TP), "--mlp-impl", "fused"],
                     logs / "tp4.jsonl")
    la_, ml, p = run["launches"], run["mlp_launches"], run["passes"]["grad"]
    rel = abs(l1 - l0) / abs(l0)
    emit({"phase": "sharded", "part": "a_tp4", "card": card,
          "loss_no_mesh": l0, "loss_tp4": l1, "loss_rel_diff": rel,
          "worst_gap": max(gap.values()), "grad_gap": gap,
          "loss_tp4_xla_a": la, "worst_gap_xla_a": max(gap_a.values()),
          "tol": {"loss_rel": SHARD_LOSS_RTOL, "gap": SHARD_GAP},
          "no_mesh_step": st0, "tp4_step": st1,
          "app": {"rc": run["code"], "success": run["res"]["success"],
                  "losses": run["losses"], "step_ms":
                  run["res"]["step_time_s"] * 1e3,
                  "steps_ms": run["steps_ms"], "peak_bytes":
                  run["peak_bytes"], "launches": la_, "mlp_launches": ml,
                  "grad_passes": p}})
    check(rel <= SHARD_LOSS_RTOL and max(gap.values()) <= SHARD_GAP
          and max(gap_a.values()) <= SHARD_GAP,
          f"tp 4 vs no mesh at init: loss {l1} vs {l0}, worst leaf 1 - "
          f"cosine {max(gap.values())} (xla_a {max(gap_a.values())})")
    check(save_a == SHARD_TP * L, f"xla_a at tp 4: the save-a forward "
          f"once a rank and layer: {save_a}")
    check(run["code"] == 0 and run["res"]["success"],
          f"train_app --tp {SHARD_TP} SUCCESS (rc {run['code']})")
    check(la_["fwd_lse"] == la_["dq"] == la_["dkv"] == L * p
          and ml["fwd"] == ml["bwd_dx"] == ml["bwd_dw"] == SHARD_TP * L * p,
          f"tp 4: kernel 1/3/4 once a layer (ranks folded), 8/9 once a "
          f"rank and layer, x {p} grad passes: {la_} {ml}")
    for k in ("fwd_lse", "dq", "dkv"):
        launches[k] += la_[k]
    for k in ("fwd", "bwd_dx", "bwd_dw"):
        launches[f"mlp_{k}"] += ml[k]
    launches["mlp_fwd_save_a"] += save_a

    # (b) dp 2 x fsdp 2 x tp 2 with the resume check
    dense = dataclasses.replace(cfg, mlp_impl="dense", fsdp=True)
    _, _, st_dense = _shard_step_stats(
        dataclasses.replace(dense, fsdp=False), None, tokens)
    _, _, st2 = _shard_step_stats(dense, SHARD_MESHES["dp2_fsdp2_tp2"],
                                  tokens)
    run = _train_run(["--steps", str(SHARD_STEPS), *TRAIN_BASE, "--dp", "2",
                      "--fsdp", "2", "--tp", "2", "--resume-check"],
                     logs / "dp2_fsdp2_tp2.jsonl")
    resume = [ln for ln in run["out"].splitlines() if "resume" in ln]
    emit({"phase": "sharded", "part": "b_dp2_fsdp2_tp2", "card": card,
          "rc": run["code"], "success": run["res"]["success"],
          "losses": run["losses"], "step_ms": run["res"]["step_time_s"]
          * 1e3, "steps_ms": run["steps_ms"], "peak_bytes":
          run["peak_bytes"], "launches": run["launches"], "step": st2,
          "no_mesh_dense_step": st_dense, "resume": resume})
    check(run["code"] == 0 and run["res"]["success"]
          and run["losses"][-1] < run["losses"][0] and resume,
          f"dp2 fsdp2 tp2: SUCCESS with the resume bit for bit and the "
          f"loss falling: {run['losses']} {resume}")
    for k in ("fwd_lse", "dq", "dkv"):
        launches[k] += run["launches"][k]

    # (c) tp decode at the serving widths
    serve_rows, n = _shard_serve(dataclasses.replace(
        cfg, mlp_impl="dense"), dev)
    for k, v in n.items():
        launches[k] += v
    emit({"phase": "sharded", "part": "c_tp4_decode", "card": card,
          "shape": SHARD_SERVE, **serve_rows})

    # (d) the launched legs
    launched = _shard_launched(logs)
    emit({"phase": "sharded", "part": "d_launched", "card": card,
          "argv": SHARD_LAUNCH_ARGV, "tol": SHARD_LAUNCH_RTOL, **launched})
    t_path = time.perf_counter() - t_phase

    # the kernels at their shard shapes against their plain versions
    kgen = torch.Generator(device="cuda").manual_seed(6)
    tp = SHARD_TP
    H = TRAIN_MODEL["n_heads"]
    shard_rows = {"attention": train_kernel_cases(
        kgen, B=B * tp, T=T, H=H // tp, Hkv=H // tp, D=128)}
    shard_rows["mlp"] = fused_mlp_cases(kgen, N=B * T, D=TRAIN_MODEL[
        "d_model"], F=TRAIN_MODEL["d_ff"] // tp)
    s = SHARD_SERVE
    S = s["prompt_len"] + s["new_tokens"]
    shard_rows["flash_prefill"] = prefill_case(
        kgen, B=s["rows"] * tp, T=s["prompt_len"], H=H // tp, Hkv=H // tp,
        D=128)
    for kv in ("bfloat16", "int8"):
        shard_rows[f"flash_decode_{kv}"] = linear_decode_case(
            kgen, B=s["rows"] * tp, H=H // tp, Hkv=H // tp, D=128, S=S,
            pos=S - 1, kv=kv)
        shard_rows[f"paged_decode_{kv}"] = decode_case(
            kgen, B=s["rows"] * tp, H=H // tp, Hkv=H // tp, D=128,
            P=s["page"], pages=-(-S // s["page"]), kv=kv)
    for name, v in launches.items():
        check(v > 0, f"sharded: {name} launched on the main path")
    emit({"phase": "sharded", "part": "done", "cuts": SHARD_CUTS,
          "launches": launches, "path_seconds": t_path,
          "seconds": time.perf_counter() - t_phase})
    return launches, shard_rows


# ------------------------------------------- pipeline and the tp engine


def _pp_grads(cfg, tokens, stats):
    """The pp 4 state from seed 0 (the no-mesh state's params) and its
    pipeline loss and global f32 gradients at init, in ``tree_leaves``
    order."""
    from hpc_patterns_tpu_torch.models import pp as pplib
    from hpc_patterns_tpu_torch.models import train as tr

    dev = torch.device("cuda")
    params, opt = pplib.init_pp_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    loss, grads = pplib.pp_loss_and_grads(
        params, tokens, cfg, {"pp": PIPE_PP}, microbatches=PIPE_M,
        stats=stats)
    return loss.item(), [g.float() for g in tr.tree_leaves(grads)], params, \
        opt


def _step_stats(step, params, opt, tokens) -> dict:
    """A step's min ms over 3 timed steps (after a warm-up), one profiled
    step (busy share, kernels), the wrappers' launches in that step and
    the peak memory over it (from a reset with the state resident)."""
    from hpc_patterns_tpu_torch.harness.profiling import device_profile
    from hpc_patterns_tpu_torch.ops import flash_attention as fa
    from hpc_patterns_tpu_torch.ops import fused_mlp as fm

    step(params, opt, tokens)[0].item()  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, tokens)[0].item()
        times.append((time.perf_counter() - t0) * 1e3)
    for counts in (fa.launches, fm.launches):
        for key in counts:
            counts[key] = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prof = device_profile(lambda: step(params, opt, tokens)[0].item())
    peak = torch.cuda.max_memory_allocated()
    return {"step_ms": min(times), "steps_ms": times,
            "busy_frac": prof["device_busy_frac"],
            "device_kernels_a_step": prof["device_kernels"],
            "top_kernels": prof["top_kernels"][:3],
            "launches_a_step": {**{f"flash_{k}": v for k, v in
                                   fa.launches.items()},
                                **{f"mlp_{k}": v for k, v in
                                   fm.launches.items()}},
            "peak_bytes": peak, "peak_over_state_bytes": peak - base}


def _pipe_a(cfg, tokens, names) -> dict:
    """(a): pp 4 x 8 microbatches, fused MLP, at init against the no-mesh
    step, both steps' stats side by side, the schedule's launches."""
    from hpc_patterns_tpu_torch.models import pp as pplib
    from hpc_patterns_tpu_torch.models import train as tr

    L = cfg.n_layers
    l0, g0, st0 = _shard_step_stats(cfg, None, tokens)
    pipe = {}
    l1, g1, params, opt = _pp_grads(cfg, tokens, pipe)
    gap = _cosine_gaps(names, g0, g1)
    del g0, g1
    st1 = _step_stats(pplib.make_pp_train_step(
        cfg, {"pp": PIPE_PP}, microbatches=PIPE_M), params, opt, tokens)
    del params, opt
    torch.cuda.empty_cache()
    M, P_ = PIPE_M, PIPE_PP
    want = {"flash_fwd": M * L, "flash_fwd_lse": M * L, "flash_dq": M * L,
            "flash_dkv": M * L, "flash_fused_bwd": 0, "mlp_fwd": 2 * M * L,
            "mlp_fwd_save_a": 0, "mlp_bwd_dx": M * L, "mlp_bwd_dw": M * L}
    rel = abs(l1 - l0) / abs(l0)
    row = {"loss_no_mesh": l0, "loss_pp": l1, "loss_rel_diff": rel,
           "worst_gap": max(gap.values()), "grad_gap": gap,
           "tol": {"loss_rel": PIPE_LOSS_RTOL, "gap": PIPE_GAP},
           "peak_stash": pipe["peak_stash"], "ticks": pipe["ticks"],
           "no_mesh_step": st0, "pp_step": st1,
           "step_ratio": st1["step_ms"] / st0["step_ms"],
           "schedule_launches": want}
    check(rel <= PIPE_LOSS_RTOL and max(gap.values()) <= PIPE_GAP,
          f"pp {P_} x {M} vs no mesh at init: loss {l1} vs {l0}, worst "
          f"leaf 1 - cosine {max(gap.values())}")
    check(all(n <= min(P_ - r, M) for r, n in
              enumerate(pipe["peak_stash"])),
          f"peak stash {pipe['peak_stash']} within min(P - r, M)")
    check(st1["launches_a_step"] == want,
          f"pp {P_} x {M}: a step's launches {st1['launches_a_step']} == "
          f"the schedule's {want} (forward and recompute forward a "
          "microbatch and layer, one backward each)")
    return row


def _pipe_b(cfg, logs) -> dict:
    """(b): pp 2 x tp 2 and dp 2 x pp 2 through train_app (dense MLP,
    PIPE_STEPS steps, --resume-check), their losses against the no-mesh
    train step's from the same seeds."""
    from hpc_patterns_tpu_torch.models import train as tr

    dev = torch.device("cuda")
    B, T = TRAIN_BATCH
    params, opt = tr.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tokens = tr.make_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                           B, T, device=dev)
    step = tr.make_train_step(cfg)
    ref = [step(params, opt, tokens)[0].item() for _ in range(PIPE_STEPS)]
    del params, opt, step
    torch.cuda.empty_cache()
    rows = {"no_mesh_losses": ref}
    for name, flags in PIPE_MESHES.items():
        run = _train_run(["--steps", str(PIPE_STEPS), *TRAIN_BASE, *flags,
                          "--resume-check"], logs / f"{name}.jsonl")
        resume = [ln for ln in run["out"].splitlines()
                  if "resume-check" in ln]
        err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref))
        bits = resume and resume[0].rsplit("losses ", 1)[1].split(" vs ")
        rows[name] = {"rc": run["code"], "label": run["res"].get("label"),
                      "losses": run["losses"], "max_rel_err": err,
                      "step_ms": run["res"]["step_time_s"] * 1e3,
                      "steps_ms": run["steps_ms"],
                      "peak_bytes": run["peak_bytes"],
                      "launches": run["launches"], "resume": resume}
        check(run["code"] == 0 and run["res"]["success"]
              and err <= PIPE_B_RTOL and bits and bits[0] == bits[1],
              f"{name}: SUCCESS, losses {run['losses']} within "
              f"{PIPE_B_RTOL} of no mesh {ref} ({err}), resume {resume}")
    return rows


def _pipe_serve(dev) -> tuple[dict, dict]:
    """(e): the tp 4 engine at SHARD_SERVE's geometry on bf16 and int8
    pools against the tp standalone (tie-aware), tokens/s and busy share
    beside the unsharded engine; one tp bundle installed in an unsharded
    engine through kernel 13; the aligned pair's draft-assisted engine at
    tp 4 (whole pools) and tp 2 (stacked pools) against the unsharded
    one."""
    from hpc_patterns_tpu_torch import topology
    from hpc_patterns_tpu_torch.apps.serve_app import CHIP_MODEL, TIE_TOL
    from hpc_patterns_tpu_torch.comm import migration_dma as md
    from hpc_patterns_tpu_torch.harness.profiling import device_profile
    from hpc_patterns_tpu_torch.models import decode as dec
    from hpc_patterns_tpu_torch.models.serving import ContinuousBatcher
    from hpc_patterns_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    s = SHARD_SERVE
    mesh = {"tp": SHARD_TP}
    tol = TIE_TOL[CHIP_MODEL["dtype"]]
    pages = -(-(s["prompt_len"] + s["new_tokens"]) // s["page"])
    geom = dict(slots=s["rows"], pool_pages=s["rows"] * pages,
                pages_per_seq=pages, page_size=s["page"], chunk=16,
                device=dev)
    prompts = [torch.randint(0, CHIP_MODEL["vocab"], (s["prompt_len"],),
                             generator=torch.Generator().manual_seed(10 + i))
               .to(torch.int32).numpy() for i in range(s["rows"])]
    rows, launches = {}, {"fwd": 0, "paged_decode": 0,
                          "paged_decode_quant": 0, "migration_exchange": 0}
    seconds = {}
    for kv in ("compute", "int8"):
        t_leg = time.perf_counter()
        cfg = TransformerConfig(
            **CHIP_MODEL, max_seq=s["prompt_len"] + s["new_tokens"],
            decode_attn="flash", kv_cache_dtype=kv)
        params = init_params(cfg, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev,
                             dtype=torch.bfloat16)
        legs = {}
        for name, m in (("unsharded", None), ("tp4", mesh)):
            runs: list = []
            Counting = _counting_engine(ContinuousBatcher, runs)

            def engine():
                eng = Counting(params, cfg, **geom, mesh=m)
                return eng, [eng.submit(p, s["new_tokens"]) for p in prompts]

            dts = []
            for _ in range(2):  # the host-paced run's best of two
                eng, ids = engine()
                t0 = time.perf_counter()
                got = eng.run()
                torch.cuda.synchronize()
                dts.append(time.perf_counter() - t0)
            dt = min(dts)
            out = [got[i] for i in ids]
            busy = None
            if kv == "compute":
                # the busy share of one steady decode round (16 steps of
                # 4 rows; a whole run's profile costs the profiler tens
                # of seconds to read back)
                again = ContinuousBatcher(params, cfg, **geom, mesh=m)
                for p in prompts:
                    again.submit(p, s["new_tokens"])
                again.service_round()
                busy = device_profile(again.service_round)[
                    "device_busy_frac"]
                again.run()
            legs[name] = {"tokens_per_s": sum(map(len, out)) / dt,
                          "runs_s": dts,
                          "busy_frac": busy, "out": out,
                          "launches": _check_launches(runs[0],
                                                      f"{name} {kv}")}
            if m is not None:
                check(eng.cache["k"][0].shape[0] == SHARD_TP,
                      f"tp engine {kv}: pools stacked over tp")
                launches["fwd"] += runs[0]["flash_prefill"]
                launches["paged_decode_quant" if kv == "int8"
                         else "paged_decode"] += runs[0]["paged_decode"]
        with torch.no_grad():  # the tp standalone, the prompts batched
            want, margins = dec.paged_generate(
                params, torch.from_numpy(np.stack(prompts)).to(dev), cfg,
                s["new_tokens"], page_size=s["page"], with_margins=True,
                mesh=mesh, device=dev)
        counts, detail, _ = _tie_counts(
            [(i, legs["tp4"]["out"][i], want[i].cpu().numpy(),
              margins[i].cpu().numpy()) for i in range(len(prompts))], tol)
        check(counts["mismatch"] == 0,
              f"tp 4 engine {kv} vs the tp standalone: {counts} {detail}")
        for leg in legs.values():
            del leg["out"]
        seconds[kv] = time.perf_counter() - t_leg
        rows[kv] = {**legs, "vs_tp_standalone": counts,
                    "divergences": detail,
                    "tp_over_unsharded_tokens_per_s":
                        legs["tp4"]["tokens_per_s"]
                        / legs["unsharded"]["tokens_per_s"]}
        if kv == "compute":
            # one tp bundle to an unsharded engine, through kernel 13
            t_leg = time.perf_counter()
            src = ContinuousBatcher(params, cfg, **geom, mesh=mesh)
            dst = ContinuousBatcher(params, cfg, **geom)
            sid = src.submit(prompts[0], s["new_tokens"])
            src.service_round(decode=False)
            [slot] = src.exportable_slots()
            b = src.export_migration(slot)
            md.launches["migration_exchange"] = 0
            b = md.send_migration(b, topology.LogicalDevice(dev, 0),
                                  topology.LogicalDevice(dev, 1))
            md.synchronize()
            n13 = md.launches["migration_exchange"]
            dst.install_migration(md.recv_migration(
                b, topology.LogicalDevice(dev, 1)))
            got = dst.run()[sid]
            with torch.no_grad():
                want, margins = dec.paged_generate(
                    params, torch.from_numpy(prompts[0])[None].to(dev), cfg,
                    s["new_tokens"], page_size=s["page"],
                    with_margins=True, device=dev)
            verdict = _tie_counts([(0, got, want[0].cpu().numpy(),
                                    margins[0].cpu().numpy())], tol)[0]
            check(n13 == 2 * cfg.n_layers and verdict["mismatch"] == 0
                  and b.pages_payload["k"][0].shape[1] == cfg.kv_heads,
                  f"tp bundle into an unsharded engine: kernel 13 {n13} "
                  f"launches (2 x {cfg.n_layers} layers), {verdict}")
            launches["migration_exchange"] += n13
            rows["bundle_tp4_to_unsharded"] = {
                "kernel13_launches": n13, "n_pages": b.n_pages,
                "verdict": verdict}
            seconds["bundle"] = time.perf_counter() - t_leg
            del src, dst
        del params
        torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    rows["draft"] = _pipe_draft(dev, mesh, launches)
    seconds["draft"] = time.perf_counter() - t_leg
    rows["seconds_by_leg"] = seconds
    return rows, launches


def _pipe_draft(dev, mesh, launches) -> dict:
    """The aligned pair (phase spec's build) draft-assisted unsharded, at
    ``mesh`` (tp 4, which does not divide the pair's 2 kv heads: JAX's
    warning and whole pools) and at ``PIPE_DRAFT_MESH`` (tp 2: both
    caches' pools kv-head-sharded and stacked, the verify extend and the
    draft's steps on the folded ranks) on PIPE_SPEC's requests of the
    pair's own stream: each sequence tie-aware on the target's unsharded
    standalone, each tp run's kernel 1 and 6 launches against its
    admissions and rounds."""
    from hpc_patterns_tpu_torch import make_draft_pair as mdp
    from hpc_patterns_tpu_torch.apps.serve_app import TIE_TOL
    from hpc_patterns_tpu_torch.models.decode import paged_generate
    from hpc_patterns_tpu_torch.models.serving import ContinuousBatcher

    pair = ROOT / "build" / "smoke_spec" / "pair"
    G, n, budget = SPEC_GAMMA, PIPE_SPEC["requests"], PIPE_SPEC["budget"]
    L = SPEC_STREAM["prompt_len"]
    cfg, params, dcfg, dparams, _ = mdp.load_pair(
        str(pair), max_seq=L + budget + G + 1, device=dev)
    reqs = [(p, budget) for p, _ in _spec_stream(cfg.vocab)[:n]]
    pps = ContinuousBatcher.pages_needed(L, budget, SHARD_SERVE["page"],
                                         gamma=G)
    geom = dict(slots=n, pool_pages=n * pps, pages_per_seq=pps,
                page_size=SHARD_SERVE["page"], chunk=SPEC_CHUNK, device=dev,
                draft_params=dparams, draft_cfg=dcfg, gamma=G)
    legs = {"unsharded": None, f"tp{mesh['tp']}": mesh,
            f"tp{PIPE_DRAFT_MESH['tp']}": PIPE_DRAFT_MESH}
    out = {}
    for name, m in legs.items():
        runs: list = []
        with warnings.catch_warnings():
            # tp 4 over 2 kv heads: JAX's warning, the pools whole
            warnings.filterwarnings(
                "ignore", message=r"decode: tp size \d+ does not divide "
                r"kv_heads")
            eng = _counting_engine(ContinuousBatcher, runs)(
                params, cfg, **geom, mesh=m)
            ids = [eng.submit(p, b) for p, b in reqs]
            t0 = time.perf_counter()
            got = eng.run()
            dt = time.perf_counter() - t0
        ranks = [eng.cache["k"][0].dim(), eng.dcache["k"][0].dim()]
        if m is PIPE_DRAFT_MESH:
            check(ranks == [5, 5] and eng.cache["k"][0].shape[0]
                  == eng.dcache["k"][0].shape[0] == m["tp"],
                  f"draft {name}: both pools stacked over tp "
                  f"({tuple(eng.cache['k'][0].shape)}, "
                  f"{tuple(eng.dcache['k'][0].shape)})")
        out[name] = {"out": [got[i] for i in ids],
                     "tokens_per_s": n * budget / dt,
                     "pools_stacked": ranks == [5, 5],
                     "launches": _check_spec_launches(runs[0],
                                                      f"draft {name}")}
        if m is not None:
            launches["fwd"] += runs[0]["flash_prefill"]
            launches["paged_decode"] += runs[0]["paged_decode"]
    pairs = []
    with torch.no_grad():
        for i, (p, b) in enumerate(reqs):
            want, margins = paged_generate(
                params, torch.from_numpy(p)[None].to(dev), cfg, b,
                page_size=SHARD_SERVE["page"], with_margins=True, device=dev)
            for name in out:
                pairs.append((f"{name}/{i}", out[name]["out"][i],
                              want[0].cpu().numpy(),
                              margins[0].cpu().numpy()))
    counts, detail, _ = _tie_counts(pairs, TIE_TOL[cfg.dtype])
    check(counts["mismatch"] == 0,
          f"draft-assisted tp and unsharded vs the target's standalone: "
          f"{counts} {detail}")
    same = {f"{name}_equal_unsharded_rows":
            sum(np.array_equal(a, b) for a, b in
                zip(out[name]["out"], out["unsharded"]["out"]))
            for name in out if name != "unsharded"}
    for leg in out.values():
        del leg["out"]
    return {**out, "vs_target_standalone": counts, "divergences": detail,
            **same, "requests": n, "budget": budget,
            "kv_heads": cfg.kv_heads}


def phase_pipeline():
    """pp and the tp engine as logical ranks of the card (module
    docstring, item 12b). Returns the main path's launches by kernel and
    the kernels at the microbatch shape."""
    import dataclasses
    import shutil

    from hpc_patterns_tpu_torch.apps import train_app
    from hpc_patterns_tpu_torch.models import train as tr
    from hpc_patterns_tpu_torch.models import transformer as tf

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    dev = torch.device("cuda")
    logs = ROOT / "build" / "smoke_pipeline"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    L = TRAIN_MODEL["n_layers"]
    B, T = TRAIN_BATCH
    cfg = tf.TransformerConfig(**TRAIN_MODEL, max_seq=T, attention="flash",
                               mlp_impl="fused")
    tokens = tr.make_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                           B, T, device=dev)
    names = _leaf_names(tf.init_params(
        dataclasses.replace(cfg, n_layers=1),
        generator=torch.Generator().manual_seed(0), device="cpu"))
    launches = {k: 0 for k in ("fwd", "fwd_lse", "dq", "dkv", "mlp_fwd",
                               "mlp_bwd_dx", "mlp_bwd_dw", "paged_decode",
                               "paged_decode_quant", "migration_exchange")}

    # (a) pp 4 x 8 microbatches against no mesh
    t0 = time.perf_counter()
    row = _pipe_a(cfg, tokens, names)
    emit({"phase": "pipeline", "part": "a_pp4_m8", "card": card, **row,
          "seconds": time.perf_counter() - t0})
    for k in ("fwd", "fwd_lse", "dq", "dkv"):
        launches[k] += row["pp_step"]["launches_a_step"][f"flash_{k}"]
    for k in ("fwd", "bwd_dx", "bwd_dw"):
        launches[f"mlp_{k}"] += row["pp_step"]["launches_a_step"][f"mlp_{k}"]

    # (d) started now: the launched leg runs beside (b) and (c)
    proc = _start_launch(["--slices", "2"], [
        sys.executable, "-m", f"{PKG}.apps.train_app", *SHARD_LAUNCH_ARGV,
        "--pp", "2", "--dcn-dp", "--dp", "-1"])

    # (b) pp 2 x tp 2 and dp 2 x pp 2, dense MLP
    t0 = time.perf_counter()
    rows_b = _pipe_b(dataclasses.replace(cfg, mlp_impl="dense"), logs)
    emit({"phase": "pipeline", "part": "b_pp2_meshes", "card": card,
          "tol": PIPE_B_RTOL, **rows_b, "seconds": time.perf_counter() - t0})
    for name in PIPE_MESHES:
        for k in ("fwd", "fwd_lse", "dq", "dkv"):
            launches[k] += rows_b[name]["launches"][k]

    # (c) train_app --pp 4 --microbatches 8
    t0 = time.perf_counter()
    run = _train_run(["--steps", str(PIPE_STEPS), *TRAIN_BASE, "--pp",
                      str(PIPE_PP), "--microbatches", str(PIPE_M)],
                     logs / "pp4.jsonl")
    emit({"phase": "pipeline", "part": "c_train_app_pp4", "card": card,
          "rc": run["code"], "success": run["res"]["success"],
          "label": run["res"].get("label"), "losses": run["losses"],
          "step_ms": run["res"]["step_time_s"] * 1e3,
          "steps_ms": run["steps_ms"], "peak_bytes": run["peak_bytes"],
          "launches": run["launches"], "seconds": time.perf_counter() - t0})
    check(run["code"] == 0 and run["res"]["success"]
          and "SUCCESS" in run["out"].splitlines()
          and run["res"].get("label") == f"pp={PIPE_PP} 1f1b",
          f"train_app --pp {PIPE_PP} --microbatches {PIPE_M} SUCCESS "
          f"(rc {run['code']})")
    for k in ("fwd", "fwd_lse", "dq", "dkv"):
        launches[k] += run["launches"][k]

    # (d) the launched leg against one process of dp 2 x pp 2
    t0 = time.perf_counter()
    code, text = _finish_launch(proc, logs, "pp2_dcn_dp")
    t_wait = time.perf_counter() - t0
    losses = [json.loads(ln.split("losses ", 1)[1])
              for ln in text.splitlines() if "one flat allreduce" in ln]
    check(code == 0 and text.count("SUCCESS") >= 3 and len(losses) == 2
          and losses[0] == losses[1] and "dcn-dp=2" in text,
          f"launched --pp 2 --dcn-dp: exit {code}, both processes SUCCESS "
          f"on one update: {losses} ({logs / 'pp2_dcn_dp'}.out)")
    c1, recs = run_app(train_app.main, SHARD_LAUNCH_ARGV
                       + ["--pp", "2", "--dp", "2"], logs / "pp2_one.jsonl")
    one = [r["loss"] for r in recs if r.get("kind") == "step"]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[0], one))
    emit({"phase": "pipeline", "part": "d_launched", "card": card,
          "argv": SHARD_LAUNCH_ARGV, "losses": losses[0],
          "one_process_losses": one, "max_rel_err": err,
          "tol": SHARD_LAUNCH_RTOL, "wait_seconds": t_wait,
          "seconds": time.perf_counter() - t0})
    check(c1 == 0 and err <= SHARD_LAUNCH_RTOL,
          f"launched pp losses {losses[0]} vs one process {one}: {err} > "
          f"{SHARD_LAUNCH_RTOL}")

    # (e) the tp 4 engine, its bundle, the draft-assisted rounds
    t0 = time.perf_counter()
    serve_rows, n = _pipe_serve(dev)
    for k, v in n.items():
        launches[k] += v
    emit({"phase": "pipeline", "part": "e_tp4_engine", "card": card,
          "shape": SHARD_SERVE, **serve_rows,
          "seconds": time.perf_counter() - t0})
    t_path = time.perf_counter() - t_phase

    # kernels 1-4 at the microbatch shape (B 1 x T 2048 x H 8), and 8,
    # 8a and 9 at a microbatch's MLP (N 2048 x D 1024 x F 4096)
    kgen = torch.Generator(device="cuda").manual_seed(7)
    mb_rows = train_kernel_cases(kgen, B=B // PIPE_M, T=T,
                                 H=TRAIN_MODEL["n_heads"],
                                 Hkv=TRAIN_MODEL["n_heads"], D=128)
    mb_rows["mlp"] = fused_mlp_cases(kgen, N=(B // PIPE_M) * T,
                                     D=TRAIN_MODEL["d_model"],
                                     F=TRAIN_MODEL["d_ff"])
    for name, v in launches.items():
        check(v > 0, f"pipeline: {name} launched on the main path")
    emit({"phase": "pipeline", "part": "done", "cuts": PIPE_CUTS,
          "launches": launches, "path_seconds": t_path,
          "seconds": time.perf_counter() - t_phase})
    return launches, mb_rows


def phase_stencil() -> dict:
    """``stencil_app`` in this process on the card at world 8, ``-p 22``
    and ``-p 26`` (16 and 256 MiB of f32), 64 steps: both oracles, the
    per-step time and the domain's effective GB/s beside the bound (the
    domain read once and written once a step)."""
    import shutil

    from hpc_patterns_tpu_torch.apps import stencil_app

    card = smi("name,power.limit")
    logs = ROOT / "build" / "smoke_stencil"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    rows = {}
    for p in STENCIL_P:
        code, recs = run_app(stencil_app.main, ["-p", str(p), *STENCIL_ARGV],
                             logs / f"p{p}.jsonl")
        (res,) = [r for r in recs if r.get("kind") == "result"]
        n = res["elements"]
        bound_ms = 2 * 4 * n / HBM_BYTES_PER_S * 1e3
        step_ms = res["per_step_us"] / 1e3
        row = {"p": p, "rc": code, "success": res["success"],
               "world": res["world"], "elements": n, "mib": n * 4 / 2 ** 20,
               "steps": res["steps"], "per_step_us": res["per_step_us"],
               "domain_gbps": res["domain_gbps"],
               "bound_ms_a_step": bound_ms, "bound_by": "bytes",
               "over_bound": step_ms / bound_ms,
               "full_passes_a_step": 12,
               "conserved": res["conserved"],
               "matches_dense": res["matches_dense"],
               "bitwise_dense": res["bitwise_dense"]}
        rows[p] = row
        emit({"phase": "stencil", "card": card, **row})
        check(code == 0 and res["success"] and res["conserved"]
              and res["matches_dense"],
              f"stencil p {p}: SUCCESS with both oracles: {row}")
    return rows


# one launched process of phase launch's run (a): the allreduce sweep,
# each algorithm's results on seeded rows as per-rank digests, the stencil
_LAUNCH_CHILD = (
    "import hashlib, json, os, sys\n"
    "import numpy as np, torch\n"
    "from hpc_patterns_tpu_torch.apps import allreduce_app, common, "
    "stencil_app\n"
    "out, lo, hi = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])\n"
    "algs = sys.argv[4].split(',')\n"
    "pid = int(os.environ['HPCPAT_PROCESS_ID'])\n"
    "rc = allreduce_app.main(['--sweep', '--min-p', str(lo), '-p', str(hi),"
    " '--repetitions', '3', '--warmup', '1', '--device', 'cuda', '--log',"
    " f'{out}/allreduce{pid}.jsonl'])\n"
    "comm = common.make_communicator('cuda')\n"
    "print(json.dumps({'digests': 'start'}), flush=True)\n"
    "dig = {}\n"
    "sl = slice(comm.rank_offset, comm.rank_offset + comm.local_size)\n"
    "for p in range(lo, hi + 1):\n"
    "    rows = np.random.default_rng(p).standard_normal(\n"
    "        (comm.size, 1 << p)).astype(np.float32)\n"
    "    x = torch.from_numpy(rows[sl]).cuda()\n"
    "    for a in algs:\n"
    "        y = comm.allreduce(x, a).cpu().numpy()\n"
    "        for i, row in enumerate(y):\n"
    "            dig[f'{a}/{p}/{comm.rank_offset + i}'] = "
    "hashlib.sha256(row.tobytes()).hexdigest()\n"
    "json.dump(dig, open(f'{out}/digests{pid}.json', 'w'))\n"
    "rs = stencil_app.main(sys.argv[5:] + ['--log', "
    "f'{out}/stencil{pid}.jsonl'])\n"
    "sys.exit(rc or rs)\n")


def _start_launch(args, cmd) -> subprocess.Popen:
    """``python -m ...apps.launch ARGS -- CMD`` from the checkout's root,
    started."""
    return subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.apps.launch", "-np", str(LAUNCH_NP),
         "--cpu-devices-per-proc", str(LAUNCH_LOCAL), "--timeout",
         str(LAUNCH_TIMEOUT_S), *args, "--", *cmd],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_launch(proc: subprocess.Popen, out: Path, name: str
                   ) -> tuple[int, str]:
    """(exit code, printed lines) of a started launch, the lines also kept
    in ``out/name.out``; the launcher is killed past its own timeout."""
    try:
        stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT_S + 60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    (out / f"{name}.out").write_text(stdout + stderr)
    return proc.returncode, stdout


def _digests(comm, lo: int, hi: int) -> dict:
    """This process's counterpart of ``_LAUNCH_CHILD``'s digests."""
    import hashlib

    dig = {}
    for p in range(lo, hi + 1):
        rows = np.random.default_rng(p).standard_normal(
            (comm.size, 1 << p)).astype(np.float32)
        x = torch.from_numpy(rows).cuda()
        for a in LAUNCH_ALGORITHMS:
            y = comm.allreduce(x, a).cpu().numpy()
            for r, row in enumerate(y):
                dig[f"{a}/{p}/{r}"] = hashlib.sha256(row.tobytes()).hexdigest()
    return dig


def phase_launch() -> dict:
    """Real child processes on the one card through the launcher (2
    processes x 2 logical ranks, joined by gloo; their collectives cross
    through pinned host memory): (a) the allreduce sweep over ring,
    ring_chunked and collective at p 16..22 (Passed 0..3, fused named as
    not run) with every algorithm's results on seeded rows equal bit for
    bit to one process of 4 ranks on the card, and the stencil across the
    two processes against its dense replay (the one-process run below
    against the same replay); (b) a traced straggler run
    (``straggler:rank=1,delay_ms=40``) merged: the rollup names rank 1,
    the schedule is consistent; (c) a ``die:rank=1,at=3`` run whose rank
    report names the fault kind. The launched busbw is gloo over host
    memory, not a card figure."""
    import shutil

    from hpc_patterns_tpu_torch.apps import stencil_app
    from hpc_patterns_tpu_torch.comm.communicator import Communicator

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    out = ROOT / "build" / "smoke_launch"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    lo, hi = LAUNCH_P
    world = LAUNCH_NP * LAUNCH_LOCAL

    # (a) the sweep, the digests and the stencil in one launch
    t0 = time.perf_counter()
    code, text = _finish_launch(_start_launch(
        [], [sys.executable, "-c", _LAUNCH_CHILD, str(out), str(lo), str(hi),
             ",".join(LAUNCH_ALGORITHMS), *LAUNCH_STENCIL]), out, "a_sweep")
    dt_a = time.perf_counter() - t0
    check(code == 0 and "launch -np 2: exit codes [0, 0]" in text,
          f"launch (a): every rank exits 0 ({code}; {text[-800:]})")
    check(all(f"[{r // LAUNCH_LOCAL}] Passed {r}" in text
              for r in range(world)),
          "launch (a): Passed 0..3, each on the process that holds it")
    check(text.count("fused: not run across processes") == LAUNCH_NP
          and text.count("gloo over pinned host memory") >= LAUNCH_NP,
          "launch (a): fused named as not run, the wire named")
    got = {}
    for pid in range(LAUNCH_NP):
        got.update(json.loads((out / f"digests{pid}.json").read_text()))
    want = _digests(Communicator({"x": world}, "x", device="cuda"), lo, hi)
    check(got == want,
          f"launch (a): {len(got)} rank results equal one process's bit for "
          f"bit ({sum(got.get(k) == v for k, v in want.items())}/"
          f"{len(want)})")
    busbw = {}
    for pid in range(LAUNCH_NP):
        for r in (json.loads(x) for x in (out / f"allreduce{pid}.jsonl")
                  .read_text().splitlines()):
            if r.get("kind") == "result" and pid == 0:
                name = r["name"][len("allreduce["):-1]
                busbw.setdefault(name, {})[int(math.log2(r["elements"]))] = {
                    "ms": r["elapsed_s"] * 1e3, "busbw_gbps": r["busbw_gbps"]}
    sten = [json.loads(x) for pid in range(LAUNCH_NP) for x in
            (out / f"stencil{pid}.jsonl").read_text().splitlines()]
    sten = [r for r in sten if r.get("kind") == "result"]
    check(len(sten) == LAUNCH_NP
          and all(r["success"] and r["conserved"] and r["matches_dense"]
                  and r["bitwise_dense"] for r in sten),
          f"launch (a): the stencil across {LAUNCH_NP} processes on both "
          f"oracles, bit-equal to its dense replay: {sten}")
    one_code, one = run_app(stencil_app.main,
                            ["--world", str(world), *LAUNCH_STENCIL],
                            out / "stencil_one.jsonl")
    (one,) = [r for r in one if r.get("kind") == "result"]
    check(one_code == 0 and one["bitwise_dense"],
          f"launch (a): the one-process stencil bit-equal to the same "
          f"dense replay: {one}")
    emit({"phase": "launch", "part": "a_sweep", "card": card,
          "processes": LAUNCH_NP, "ranks_a_process": LAUNCH_LOCAL,
          "wire": "gloo over pinned host memory (not a card figure)",
          "digests_equal": len(want), "busbw_by_algorithm_p": busbw,
          "stencil_launched_us": [r["per_step_us"] for r in sten],
          "stencil_one_process_us": one["per_step_us"],
          "seconds": dt_a})

    # (b) a straggler, traced and merged, and (c) a worker death at
    # collective 3, the two launches side by side (nothing timed)
    t0 = time.perf_counter()
    runlog = out / "b_straggler.jsonl"
    straggler = _start_launch(
        ["--chaos", LAUNCH_CHAOS["straggler"], "--trace-out",
         str(out / "b_merged.json"), "--trace-dir", str(out / "b_ranks"),
         "--log", str(runlog)],
        [sys.executable, "-m", f"{PKG}.apps.pingpong_app", "-p", "16",
         "--min-p", "16", "--repetitions", "5", "--device", "cuda",
         "--trace"])
    dielog = out / "c_die.jsonl"
    death = _start_launch(
        ["--chaos", LAUNCH_CHAOS["die"], "--trace-out",
         str(out / "c_merged.json"), "--trace-dir", str(out / "c_ranks"),
         "--log", str(dielog)],
        [sys.executable, "-m", f"{PKG}.apps.allreduce_app", "-p", "16",
         "--repetitions", "5", "--device", "cuda", "--trace"])
    code, text = _finish_launch(straggler, out, "b_straggler")
    die_code, die_text = _finish_launch(death, out, "c_die")
    (tm,) = [json.loads(x) for x in runlog.read_text().splitlines()
             if json.loads(x).get("kind") == "trace_merged"]
    strag = tm["stragglers"]
    emit({"phase": "launch", "part": "b_straggler", "card": card,
          "chaos": LAUNCH_CHAOS["straggler"], "rc": code,
          "align": tm["align"]["method"], "skew": tm["skew"],
          "stragglers": strag, "schedule": tm["schedule"]["verdict"],
          "seconds": time.perf_counter() - t0})
    check(code == 0 and "straggler: rank 1 finished last" in text
          and strag["1"]["last"] == strag["1"]["of"] > 0
          and tm["schedule"]["verdict"] == "consistent"
          and tm["align"]["method"] == "sync",
          f"launch (b): the merged rollup names rank 1, schedule "
          f"consistent, sync anchors ({text[-800:]})")

    faults = [line.strip() for line in die_text.splitlines()
              if "fault:" in line or ": was at " in line]
    emit({"phase": "launch", "part": "c_die", "card": card,
          "chaos": LAUNCH_CHAOS["die"], "rc": die_code, "report": faults})
    check(die_code == 1 and "rank 1: fault: killed (SIGKILL)" in die_text
          and "FAILURE" in die_text,
          f"launch (c): the rank report names the fault kind ({faults})")
    emit({"phase": "launch", "leg": "done",
          "seconds": time.perf_counter() - t_phase})
    return {"digests": len(want), "busbw": busbw}


# ---------------------------------------------------------------- analysis

#: phase analysis (c): the serve phase's engine (its model, page size,
#: chunk and prefill ladder) sampling, with preemption on: a low-priority
#: request admitted first, and a high-priority one arriving at
#: ``arrive_s`` of the progress clock (one round a second) whose pages
#: evict it; the evicted row resumes after it (prompt + its tokens, its
#: key uploaded from the host)
ANALYSIS_SERVE = dict(prompts=(384, 256), budgets=(64, 32), priorities=(1, 0),
                      arrive_s=2.0, temperature=0.8, top_k=50)
#: phase analysis (b): the shapes chip_smoke launches the kernels whose
#: shared memory is set per call at — 8 and 8a at the kernel rows' MLP,
#: phase pipeline's microbatch and phase sharded's tp shard; 14 at
#: pipeline_case's, the overlap phase's and the timed row's chunks
ANALYSIS_MLP_SHAPES = (
    (MLP_SHAPE["N"], MLP_SHAPE["D"], MLP_SHAPE["F"]),
    (TRAIN_BATCH[0] // PIPE_M * TRAIN_BATCH[1], TRAIN_MODEL["d_model"],
     TRAIN_MODEL["d_ff"]),
    (TRAIN_BATCH[0] * TRAIN_BATCH[1], TRAIN_MODEL["d_model"],
     TRAIN_MODEL["d_ff"] // SHARD_TP))
ANALYSIS_PIPELINE_ROWS = tuple(sorted(
    {64, PIPE_TIMED["rows"], *(R for _, R, _ in OVERLAP_SHAPES)}))


def _strict_serve(runtime, serve_ctx):
    """(c): the preempting sampled serve, a Command submit loop and one
    Communicator collective under strict_dispatch."""
    from hpc_patterns_tpu_torch.comm.communicator import Communicator
    from hpc_patterns_tpu_torch.concurrency.commands import make_command
    from hpc_patterns_tpu_torch.models.serving import (
        ContinuousBatcher,
        pad_to_bucket,
    )

    dev = torch.device("cuda")
    a = ANALYSIS_SERVE
    cfg, geom = serve_ctx["cfg"], serve_ctx["geom"]
    page, buckets = geom["page_size"], geom["prompt_buckets"]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in a["prompts"]]
    need = [ContinuousBatcher.pages_needed(
        n, b, page, padded_len=pad_to_bucket(buckets, n))
        for n, b in zip(a["prompts"], a["budgets"])]
    pool = max(need) + 1  # both rows never fit: the second evicts the first
    check(sum(need) > pool, f"analysis (c): {need} pages overflow {pool}")
    reqs = [dict(prompt=p, max_new=b, priority=pr) for p, b, pr in
            zip(prompts, a["budgets"], a["priorities"])]

    def serve():
        eng = ContinuousBatcher(
            serve_ctx["params"], cfg, slots=2, pool_pages=pool,
            pages_per_seq=max(need), page_size=page, chunk=geom["chunk"],
            prompt_buckets=buckets, device=dev, preempt=True,
            temperature=a["temperature"], top_k=a["top_k"], seed=11)
        got = eng.run(arrivals=[(0.0, reqs[0]), (a["arrive_s"], reqs[1])],
                      round_s=1.0)
        torch.cuda.synchronize()
        return [got[sid] for sid in sorted(got)], eng

    plain, _ = serve()  # libraries and allocator warm, outside the guard
    cmds = [make_command(k, device=dev, copy_elements=1 << 16,
                         tripcount=50) for k in ("C", "M2D", "D2M")]
    comm = Communicator({"x": 4}, "x", device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(4, 4096, generator=gen, device=dev)
    want_ar = comm.allreduce(x)
    torch.cuda.synchronize()
    with runtime.strict_dispatch() as guard:
        outs, eng = serve()
        for _ in range(4):
            for c in cmds:
                c.submit()
        for c in cmds:
            c.block()
        got_ar = comm.allreduce(x)
        torch.cuda.synchronize()
    preempted = sum(r["preemptions"] for r in eng.stats.values())
    check(preempted >= 1 and eng.admissions == len(reqs) + preempted,
          f"strict dispatch: {preempted} preemption(s), {eng.admissions} "
          f"admissions (each evicted row resumed)")
    check([list(o) for o in outs] == [list(o) for o in plain]
          and [len(o) for o in outs] == list(a["budgets"]),
          "strict dispatch: the sampled, preempted serve's streams == the "
          "unguarded run's")
    check(torch.equal(got_ar, want_ar),
          "strict dispatch: the collective's result unchanged")
    guard.preemptions = preempted
    return guard


def _strict_ledger(runtime):
    """(d): kernels 11 and 14 once each from the ledger build, against
    their plain versions, the ledger balanced."""
    from hpc_patterns_tpu_torch.comm import fused
    from hpc_patterns_tpu_torch.concurrency import pipeline as pl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    with runtime.strict_barriers() as sb:
        x = torch.randn(COMM_WORLD, 1 << 20, generator=gen, device=dev)
        sb.reset("fused_ring")
        got = fused.fused_allreduce(x)
        fused.synchronize()
        led = sb.check("fused_ring", flags=True)
        want = fused.fused_allreduce_reference(x, lane=fused.CARD_LANE)
        check(torch.equal(got, want),
              "ledger build: fused_allreduce == plain bitwise")
        out["fused_allreduce"] = led["flags"]
        xp = torch.rand(4, 64, 128, generator=gen, device=dev)
        sb.reset("overlap_pipeline")
        got = pl.overlap_run(xp, mode="overlap", tripcount=3, passes=2)
        torch.cuda.synchronize()
        led = sb.check("overlap_pipeline")
        want, _ = pl.overlap_run_reference(xp, mode="overlap", tripcount=3,
                                           passes=2)
        check(torch.equal(got, want),
              "ledger build: overlap_pipeline == plain bitwise")
        out["overlap_pipeline"] = {
            "barriers": len(led["bars"]),
            "arrive": sum(r["arrive"] for r in led["bars"].values()),
            "tx_bytes": sum(r["tx_copy"] for r in led["bars"].values()),
            "wait": sum(r["wait"] for r in led["bars"].values())}
    out["checked"] = sb.checked
    return out


def phase_analysis(serve_ctx):
    """torchlint over the port on the card's host (a), its shared-memory
    rows against the compiled kernels (b), the runtime guard on the
    dispatch paths (c) and the ledger build of kernels 11 and 14 (d)."""
    from hpc_patterns_tpu_torch.analysis import core, cuda_rules, runtime, smem
    from hpc_patterns_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = core.run_paths([ROOT / PKG])
    t_lint = time.perf_counter() - t0
    for f in report.findings:
        print(f.format(), flush=True)
    ledgers = cuda_rules.kernel_report([ROOT / PKG / "csrc"])
    emit({"phase": "analysis", "part": "a", "findings": len(report.findings),
          "by_rule": report.by_rule(), "suppressed": len(report.suppressed),
          "files": report.n_files, "seconds": t_lint,
          "kernels_analyzed": sum(x.status == "analyzed" for x in ledgers),
          "kernels_abstained": [x.kernel for x in ledgers
                                if x.status != "analyzed"]})
    check(report.ok, f"torchlint --ci over the port: "
          f"{len(report.findings)} finding(s)")

    plans = runtime.launch_plans(ANALYSIS_MLP_SHAPES, ANALYSIS_PIPELINE_ROWS)
    rows, bad, optin = runtime.smem_card_rows(plans)
    smem_path = ROOT / "build" / "smem_table.json"
    smem_path.write_text(json.dumps(rows))
    per_call = [r for r in rows if r["launcher_dynamic"] is None
                or r.get("plan", "every call") != "every call"]
    big = sorted((r for r in rows if r.get("total") is not None),
                 key=lambda r: -r["total"])
    emit({"phase": "analysis", "part": "b", "rows": len(rows),
          "optin_bytes": optin, "mismatches": bad[:8],
          "table": [r for r in rows if "chunk_kernel" not in r["kernel"]
                    and r not in per_call] + big[:2],
          "per_call_rows": per_call,
          "decode_chunk_rows": sum("chunk_kernel" in r["kernel"]
                                   for r in rows),
          "full_table": str(smem_path.relative_to(ROOT))})
    check(not bad, f"smem rows == cudaFuncGetAttributes + launch: {bad[:4]}")
    held = {smem.canonical(r["kernel"]) for r in per_call
            if r.get("total") is not None}
    check(held == set(plans) and len(plans) == 12,
          f"smem: kernels 8, 8a and 14 held at their launched shapes "
          f"({sorted(held)})")

    t1 = time.perf_counter()
    guard = _strict_serve(runtime, serve_ctx)
    emit({"phase": "analysis", "part": "c", "serve": ANALYSIS_SERVE,
          "preemptions": guard.preemptions,
          "guarded_calls": guard.guarded_calls,
          "lifted_calls": guard.lifted_calls, "raised": guard.raised,
          "functions_guarded": sum(guard.functions.values()),
          "seconds": time.perf_counter() - t1})
    check(guard.guarded_calls > 0 and not guard.raised,
          f"strict dispatch: {guard.guarded_calls} guarded call(s), "
          f"raised {guard.raised}")

    t2 = time.perf_counter()
    led = _strict_ledger(runtime)
    emit({"phase": "analysis", "part": "d", **led,
          "ledger_build_seconds": {k: v["seconds"] for k, v
                                   in _build.build_info.items()
                                   if k.startswith("ledger/")},
          "seconds": time.perf_counter() - t2})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside {Path(__file__).name};"
              " run it from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    seconds: dict = {}

    def timed(name, fn, *args, **kw):
        """fn(*args, **kw), its wall seconds added to seconds[name]."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    kgen = torch.Generator(device="cuda").manual_seed(2)
    busy = timed("kernels", busy_wait_case, kgen)
    pipe_rows = timed("kernels", pipeline_case, kgen)
    pipe = pipe_rows["overlap"]
    launches, serve_ctx = timed("serve", phase_serve)
    launches_sample = timed("sample", phase_sample, serve_ctx)
    launches_scenario, scenario_ctx = timed("scenario", phase_scenario)
    launches_fit, blame_ab = timed("fit", phase_fit, scenario_ctx)
    launches_tiered = timed("tiered", phase_tiered, blame_ab)
    launches_spec = timed("spec", phase_spec)
    launches_overlap = timed("overlap", phase_overlap)
    launches_dispatch = timed("dispatch", phase_dispatch)
    cgen = torch.Generator(device="cuda").manual_seed(4)
    ring_row = timed("kernels", fused_allreduce_case, cgen)
    agmm_row = timed("kernels", allgather_matmul_case, cgen)
    perm_row = timed("kernels", fused_permute_case, cgen)
    alias_row = timed("kernels", alias_case, cgen, busy["launch_ms"])
    mig_row = timed("kernels", migration_case, cgen)
    launches_comm = timed("comm", phase_comm)
    timed("stencil", phase_stencil)
    timed("launch", phase_launch)
    launches_quant = timed("quant", phase_quant)
    launches_plane, plane_ctx = timed("plane", phase_plane)
    launches_elastic = timed("elastic", phase_elastic)
    timed("observe", phase_observe, serve_ctx, plane_ctx)
    tgen = torch.Generator(device="cuda").manual_seed(5)
    train_rows = timed("kernels", train_kernel_cases, tgen,
                       **TRAIN_KERNEL_SHAPE)
    timed("kernels", train_kernel_cases, tgen,
          **dict(TRAIN_KERNEL_SHAPE, Hkv=2))  # GQA
    timed("kernels", block_case, tgen)
    mlp_rows = timed("kernels", fused_mlp_cases, tgen, **MLP_SHAPE)
    launches_train = timed("train", phase_train)
    launches_par = timed("parallel", phase_parallel)
    launches_sh, shard_rows = timed("sharded", phase_sharded)
    launches_pp, mb_rows = timed("pipeline", phase_pipeline)
    timed("analysis", phase_analysis, serve_ctx)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "seconds_by_phase": seconds})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the backward rows also carry the error the check holds: relative to
    # max|plain| of each output
    rel = ("max_rel_err", "rel_tol")
    emit({"kernels": [
        {"name": "flash_prefill", "route": "cuda",
         "source": f"{PKG}/csrc/flash_prefill.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_attention.py:125",
         "launches": launches["flash_prefill"]
         + launches_sample["flash_prefill"]
         + launches_scenario["flash_prefill"]
         + launches_fit["flash_prefill"]
         + launches_tiered["flash_prefill"]
         + launches_spec["flash_prefill"]
         + launches_plane["flash_prefill"]
         + sum(launches_elastic["flash_prefill"].values())
         + launches_par["fwd"] + launches_sh["fwd"] + launches_pp["fwd"],
         "launches_by_path": {"serve": launches["flash_prefill"],
                              "sample": launches_sample["flash_prefill"],
                              "scenario":
                                  launches_scenario["flash_prefill"],
                              "fit": launches_fit["flash_prefill"],
                              "tiered": launches_tiered["flash_prefill"],
                              "spec": launches_spec["flash_prefill"],
                              "plane": launches_plane["flash_prefill"],
                              **{f"elastic_{k}": v for k, v in
                                 launches_elastic["flash_prefill"].items()},
                              "parallel_moe": launches_par["fwd"],
                              "sharded_tp4_decode": launches_sh["fwd"],
                              "pipeline": launches_pp["fwd"],
                              "spec_pair_build":
                                  launches_spec["build"]["fwd"]},
         **{k: rows["flash_prefill"][k] for k in keys + ("tflops",)},
         "shard_shape": _shard_row(shard_rows["flash_prefill"])},
        {"name": "paged_decode", "route": "cuda",
         "source": f"{PKG}/csrc/paged_decode.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_decode.py:216",
         "launches": launches["paged_decode"]
         + launches_sample["paged_decode"]
         + launches_scenario["paged_decode"]
         + launches_fit["paged_decode"]
         + launches_tiered["paged_decode"]
         + launches_spec["paged_decode"]
         + launches_plane["paged_decode"]
         + sum(launches_elastic["paged_decode"].values())
         + launches_sh["paged_decode"] + launches_pp["paged_decode"],
         "launches_by_path": {"serve": launches["paged_decode"],
                              "sample": launches_sample["paged_decode"],
                              "scenario": launches_scenario["paged_decode"],
                              "fit": launches_fit["paged_decode"],
                              "tiered": launches_tiered["paged_decode"],
                              "spec": launches_spec["paged_decode"],
                              "plane": launches_plane["paged_decode"],
                              **{f"elastic_{k}": v for k, v in
                                 launches_elastic["paged_decode"].items()},
                              "sharded_tp4": launches_sh["paged_decode"],
                              "pipeline_tp4_engine":
                                  launches_pp["paged_decode"]},
         **{k: rows["paged_decode"][k] for k in keys},
         "shard_shape": _shard_row(shard_rows["paged_decode_bfloat16"])},
        {"name": "flash_decode", "route": "cuda",
         "source": f"{PKG}/csrc/flash_decode.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_decode.py:84",
         "launches": launches_quant["flash_decode"]
         + launches_quant["row"]["flash_decode"]
         + launches_train["flash_decode"] + launches_spec["flash_decode"]
         + launches_par["flash_decode"] + launches_sh["flash_decode"],
         "launches_by_path": {"quant": launches_quant["flash_decode"],
                              "quant_row_law":
                              launches_quant["row"]["flash_decode"],
                              "train_generate":
                              launches_train["flash_decode"],
                              "moe_generate": launches_par["flash_decode"],
                              "bench_speculative":
                              launches_spec["flash_decode"],
                              "sharded_tp4": launches_sh["flash_decode"]},
         **{k: rows["flash_decode"][k] for k in keys},
         "shard_shape": {kv: _shard_row(shard_rows[f"flash_decode_{kv}"])
                         for kv in ("bfloat16", "int8")},
         "by_cache": {c: {k: r[k] for k in ("ms", "library_ms", "bound_ms",
                                            "max_abs_err", "n_chunks")}
                      for c, r in rows["flash_decode_by_cache"].items()},
         "one_chunk": {c: {"B": r["shape"]["B"], "pos": r["shape"]["pos"],
                           **{k: r[k] for k in ("ms", "library_ms",
                                                "bound_ms", "max_abs_err",
                                                "n_chunks")}}
                       for c, r in rows["flash_decode_one_chunk"].items()}},
        {"name": "paged_decode_quant", "route": "cuda",
         "source": f"{PKG}/csrc/paged_decode.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_decode.py:216",
         "launches": launches_quant["paged_decode"]
         + launches_quant["row"]["paged_decode"]
         + launches_spec["paged_decode_quant"]
         + launches_sh["paged_decode_quant"]
         + launches_pp["paged_decode_quant"],
         "launches_by_path": {"quant_int8_flash":
                              launches_quant["paged_decode"],
                              "quant_row_bf16_and_int8":
                              launches_quant["row"]["paged_decode"],
                              "spec_int8":
                              launches_spec["paged_decode_quant"],
                              "sharded_tp4_int8":
                              launches_sh["paged_decode_quant"],
                              "pipeline_tp4_engine_int8":
                              launches_pp["paged_decode_quant"]},
         **{k: rows["paged_decode_quant"][k] for k in keys},
         "shard_shape": _shard_row(shard_rows["paged_decode_int8"])},
        {"name": "paged_attention", "route": "cuda",
         "source": f"{PKG}/csrc/paged_attention.cu",
         "replaces": "hpc_patterns_tpu/ops/paged_attention.py:61",
         "launches": launches_quant["paged_attention"]
         + launches_quant["row"]["paged_attention"],
         "launches_by_path": {"quant_int8_paged_flash":
                              launches_quant["paged_attention"],
                              "quant_row_race":
                              launches_quant["row"]["paged_attention"]},
         **{k: rows["paged_attention"][k] for k in keys},
         "by_cache": {c: {k: r[k] for k in keys + ("n_chunks",)}
                      for c, r in rows["paged_attention_by_cache"].items()}},
        {"name": "busy_wait", "route": "cuda",
         "source": f"{PKG}/csrc/busy_wait.cu",
         "replaces": "hpc_patterns_tpu/concurrency/kernels.py:32",
         "launches": launches_dispatch["busy_wait"],
         **{k: busy[k] for k in keys}},
        {"name": "overlap_pipeline", "route": "cuda",
         "source": f"{PKG}/csrc/overlap_pipeline.cu",
         "replaces": "hpc_patterns_tpu/concurrency/pipeline.py:74",
         "launches": launches_overlap["overlap_pipeline"],
         **{k: pipe[k] for k in keys + ("launch_plan",)},
         "by_mode": {m: {k: r[k] for k in keys}
                     for m, r in pipe_rows.items()}},
        {"name": "fused_allreduce", "route": "cuda",
         "source": f"{PKG}/csrc/fused_ring.cu",
         "replaces": "hpc_patterns_tpu/comm/fused.py:424",
         "launches": launches_comm["fused_allreduce"]
         + launches_fit["fused_allreduce"]
         + launches_tiered["fused_allreduce"],
         "launches_by_path": {**launches_comm["fused_allreduce_by_path"],
                              "fit": launches_fit["fused_allreduce"],
                              "tiered": launches_tiered["fused_allreduce"]},
         **{k: ring_row[k] for k in keys + ("launch_plan",)}},
        {"name": "allgather_matmul", "route": "cuda",
         "source": f"{PKG}/csrc/fused_ring.cu",
         "replaces": "hpc_patterns_tpu/comm/fused.py:570",
         "launches": launches_comm["allgather_matmul"],
         **{k: agmm_row[k] for k in keys + ("launch_plan",)}},
        {"name": "fused_permute", "route": "cuda",
         "source": f"{PKG}/csrc/fused_ring.cu",
         "replaces": "hpc_patterns_tpu/comm/fused.py:335",
         "launches": launches_comm["fused_permute"]
         + launches_par["fused_permute"],
         "launches_by_path": {"comm": launches_comm["fused_permute"],
                              "ring_attention":
                                  launches_par["fused_permute"]},
         **{k: perm_row[k] for k in keys}},
        {"name": "alias_inplace", "route": "cuda",
         "source": f"{PKG}/csrc/alias_inplace.cu",
         "replaces": "hpc_patterns_tpu/interop/device.py:104",
         "launches": launches_comm["alias_inplace"],
         **{k: alias_row[k] for k in keys}},
        {"name": "flash_fwd_lse", "route": "cuda",
         "source": f"{PKG}/csrc/flash_prefill.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_attention.py:125",
         "launches": launches_train["flash_fwd_lse"]
         + launches_tiered["fwd_lse"]
         + launches_spec["build"]["fwd_lse"] + launches_par["fwd_lse"]
         + launches_sh["fwd_lse"] + launches_pp["fwd_lse"],
         "launches_by_path": {"train": launches_train["flash_fwd_lse"],
                              "tiered": launches_tiered["fwd_lse"],
                              "parallel": launches_par["fwd_lse"],
                              "sharded": launches_sh["fwd_lse"],
                              "pipeline": launches_pp["fwd_lse"],
                              "spec_pair_build":
                                  launches_spec["build"]["fwd_lse"]},
         **{k: train_rows["flash_fwd_lse"][k]
            for k in keys + ("tflops",)},
         "shard_shape": _shard_row(shard_rows["attention"]["flash_fwd_lse"]),
         "microbatch_shape": _shard_row(mb_rows["flash_fwd_lse"])},
        {"name": "fused_bwd", "route": "cuda",
         "source": f"{PKG}/csrc/flash_attention_bwd.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_attention.py:235",
         "launches": launches_train["fused_bwd"],
         **{k: train_rows["fused_bwd"][k] for k in keys + rel},
         "microbatch_shape": _shard_row(mb_rows["fused_bwd"])},
        {"name": "dq", "route": "cuda",
         "source": f"{PKG}/csrc/flash_attention_bwd.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_attention.py:188",
         "launches": launches_train["dq"] + launches_tiered["dq"]
         + launches_spec["build"]["dq"] + launches_par["dq"]
         + launches_sh["dq"] + launches_pp["dq"],
         "launches_by_path": {"train": launches_train["dq"],
                              "tiered": launches_tiered["dq"],
                              "parallel": launches_par["dq"],
                              "sharded": launches_sh["dq"],
                              "pipeline": launches_pp["dq"],
                              "spec_pair_build":
                                  launches_spec["build"]["dq"]},
         **{k: train_rows["dq"][k] for k in keys + rel},
         "shard_shape": _shard_row(shard_rows["attention"]["dq"]),
         "microbatch_shape": _shard_row(mb_rows["dq"])},
        {"name": "dkv", "route": "cuda",
         "source": f"{PKG}/csrc/flash_attention_bwd.cu",
         "replaces": "hpc_patterns_tpu/ops/flash_attention.py:297",
         "launches": launches_train["dkv"] + launches_tiered["dkv"]
         + launches_spec["build"]["dkv"] + launches_par["dkv"]
         + launches_sh["dkv"] + launches_pp["dkv"],
         "launches_by_path": {"train": launches_train["dkv"],
                              "tiered": launches_tiered["dkv"],
                              "parallel": launches_par["dkv"],
                              "sharded": launches_sh["dkv"],
                              "pipeline": launches_pp["dkv"],
                              "spec_pair_build":
                                  launches_spec["build"]["dkv"]},
         **{k: train_rows["dkv"][k] for k in keys + rel},
         "shard_shape": _shard_row(shard_rows["attention"]["dkv"]),
         "microbatch_shape": _shard_row(mb_rows["dkv"])},
        *({"name": name, "route": "cuda",
           "source": f"{PKG}/csrc/fused_mlp.cu",
           "replaces": f"hpc_patterns_tpu/ops/fused_mlp.py:{line}",
           "launches": launches_train[name]
           + launches_sh[name.replace("fused_", "")]
           + launches_pp.get(name.replace("fused_", ""), 0),
           **({"launches_by_run": {
               **{r: m[name.replace("fused_mlp_", "")]
                  for r, m in launches_train["fused_mlp_by_run"].items()},
               "sharded": launches_sh[name.replace("fused_", "")],
               "pipeline": launches_pp[name.replace("fused_", "")]}}
              if name != "fused_mlp_fwd_save_a" else
              {"launches_by_run": {
                  "xla_a step": launches_train[name],
                  "sharded_tp4_xla_a": launches_sh["mlp_fwd_save_a"]}}),
           **{k: mlp_rows[name][k] for k in keys + rel + ("launch_plan",)},
           "shard_shape": _shard_row(shard_rows["mlp"][name]),
           "microbatch_shape": _shard_row(mb_rows["mlp"][name])}
          for name, line in (("fused_mlp_fwd", 65),
                             ("fused_mlp_fwd_save_a", 148),
                             ("fused_mlp_bwd_dx", 93),
                             ("fused_mlp_bwd_dw", 93))),
        {"name": "migration_exchange", "route": "cuda",
         "source": f"{PKG}/csrc/migration_dma.cu",
         "replaces": "hpc_patterns_tpu/comm/migration_dma.py:110",
         "launches": launches_plane["migration_exchange"]
         + launches_pp["migration_exchange"],
         "launches_by_path": {"plane": launches_plane["migration_exchange"],
                              "pipeline_tp4_bundle":
                                  launches_pp["migration_exchange"]},
         **{k: mig_row[k] for k in keys}},
    ]})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
