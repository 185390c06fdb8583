#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card, check them, and time
their kernels against their plain versions.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (``nvcc``); imports
nothing of JAX or of the JAX package.  Phases, each printing one JSON line:

1. device: the card's name, count and power limit;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, all started together; the registers and spill bytes of the
   Hopper flash-attention kernels (``flash_fwd_hopper`` at head_dim 64,
   128 and 256, which must not spill at 256; ``flash_bwd_dq_hopper`` and
   ``flash_bwd_dkv_hopper`` at 64, 128 and 256, which must not spill at
   256), of the forward's three kernels
   at head_dim 256 (``flash_fwd_hopper``, ``flash_fwd_bf16`` and
   ``flash_fwd_f32``) and the backward's six there (dq and dk/dv on the
   three routes), and the registers, shared memory and spill bytes of
   ``ell_to_dense``'s tiled kernel (identity and ``log1p`` epilogues) and
   of the scan's backward kernel (float32 and bf16 at N 4 and 16) from
   ``ptxas -v``;

The cell-training path (slice 1):

3. data: a Tahoe-like dataset at Tahoe-100M's width, 62,710 genes (14
   plates, 32,768 cells = two fetches of 64 x 256, 2,048 counts per cell,
   seed 0), generated under ``build/chip_smoke_data`` in the checkout or
   reused when its manifest matches; the generation runs in a process of
   its own while phases 31-36 run, and this phase waits for it;
4. kernel: ``ell_to_dense``'s tiled kernel, with and without its fused
   ``log1p``, on the card against its plain PyTorch version (followed by
   ``log1p_``): the JAX package's sweep with duplicate columns (atol 1e-6,
   the order in which duplicates add up differs; its values made
   non-negative, counts, for ``log1p``) and a real batch of the path
   (bitwise: canonical CSR has no duplicates, so every output is one value
   or 0, and ``log1p`` of it the same bits as PyTorch's ``log1p_``), and
   against the one-block-per-row kernel it replaced
   (``previous_ell_to_dense``, followed by ``log1p_``), bitwise on the path
   batch; the mutation check: three edited copies of
   ``csrc/ell_to_dense.cu`` (``ELL_MUTANTS``), built under ``build/`` and
   run on the same inputs into outputs filled with NaN, must each fail that
   check; CUDA-event times, in turns, at the path batch and at 132 and 264
   rows, of the kernel, the fused kernel, the replaced kernel alone and
   followed by ``log1p_``, ``log1p_`` alone, ``index_put_`` (one PyTorch
   call of the same function) alone and followed by ``log1p_``, a
   ``zero_()`` of the output's size (the card's write rate, a reading
   beside the bound) and the plain version, each over back-to-back calls
   queued behind a sleep kernel so that the host's time per call is
   hidden; the host's microseconds per call of the wrapper and of
   ``previous_ell_to_dense``; one train step on the card against the same
   step on the CPU (loss within rtol 1e-4: float32 products summed in
   another order);
5. main path: ``BlockShuffling(16)``, batch 64, ``fetch_factor=256``, the
   two-deep device feed and one epoch of ``train_step`` (512 steps, two
   fetches of 16,384 random 16-cell blocks) through
   ``train_probe``, whose features are the fused kernel's, with the
   kernel's launch count set to 0 just before and read just after;
6. trace: 64 steps of the next epoch under ``torch.profiler``: the
   device's kernel time per step by name, ``ell_to_dense``'s own per
   launch (the tiled kernel), and no ``log1p`` kernel beside the fused one.

LM serving (slice 2), smollm-360m at its full width and depth (32 layers,
d_model 960, 15 query heads over 5 kv heads of 64, vocab 49,152):

7. flash_kernel: ``flash_attention`` on the card against its plain
   version: the JAX package's sweep (four shapes x causal / window 48 /
   non-causal) in bf16 (atol 3e-2: outputs are means of N(0, 1) values,
   under 4 in magnitude, where a bf16 ulp is 2**-6 and the P.V sums round
   in another order) and float32 (atol 3e-5, TF32 off: summation order), the ``q_offset=200`` decode tile, and
   the prefill's shape, q (8, 15, 512, 64) and k/v (8, 5, 512, 64) bf16 as
   the strided (B, S, H, D) views the model passes, which must take the
   Hopper kernel (``hopper_launches`` + 1); event times of the kernel, of
   the ``mma.sync`` kernel it replaced on that route (launched by
   ``previous_kernel``, held to the same atol), of the plain version and of
   ``scaled_dot_product_attention`` there; the host's microseconds per
   call of the wrapper and of ``previous_kernel`` (the wrapper's host work
   before the Hopper route);
8. lm_vs_cpu: float32 weights drawn once from a seeded generator and
   copied to the card; a 64-token prefill and 8 decode steps on the card
   and on the CPU: logits within rtol 1e-3 / atol 1e-3 (float32 sums in
   another order over 32 layers), greedy tokens equal except across ties;
9. serve (the main path): ``serve_batch`` in bf16, batch 8, 512-token
   prompts, 64 generated tokens, with the kernel's launch counts set to 0
   just before and read just after (32 per prefill, all 32 through the
   Hopper kernel); time to first token,
   decode ms per step, tokens/s, peak memory; then one prefill under
   ``torch.profiler`` for the kernel's own device time per launch, and
   the decode step's wall ms with and without its ``full_float32_matmul``
   block, in turns (``decode_ms_with_and_without_block``);
10. batching: ``SlotBatcher`` in float32, 16 requests over 4 slots (prompts
   of 64-512 tokens, 16-64 new tokens, numpy seed 0, max_len 1024); every
   request's tokens equal a standalone batch-1 serve of its prompt except
   across ties.

LM training (slice 3), smollm-360m at its full width:

11. train_kernels: the forward with lse, dq and dk/dv kernels on the card
   against their plain versions: the JAX package's backward sweep
   (tests/test_kernels_bwd.py: GQA, MQA, uneven tiles x causal / window 32 /
   non-causal) in float32 (atol = rtol = 2e-4, the JAX package's own
   tolerance; TF32 off) and bf16 (|err| <= 3e-2 + 2e-2 |want|: P and dS are
   rounded to bf16 as operands, outputs to bf16), and the training shape,
   q (4, 15, 2048, 64) and k/v (4, 5, 2048, 64) bf16 causal as the strided
   (B, S, H, D) views the model passes, each tensor there within
   0.1 rms(want) + 2**-6 |want| (its values are too small for the sweep's
   atol; rms(want) is printed beside each error), all three there through
   the Hopper kernels; the mutation checks: three edited copies of
   ``csrc/flash_attention.cu`` (one drops the rescale of O by alpha, one
   skips each block's last KV tile, one lets the causal mask of a diagonal
   tile see one key too many) and three of ``csrc/flash_attention_bwd.cu``
   (dk/dv without the delta of dS, dk/dv skipping each item's first query
   tile, dq's diagonal tile seeing one key too many), built under
   ``build/`` and run on the training shape's inputs, must each fail that
   rule (or lse's 1e-4) at least FLASH_MUTANT_MIN times over; the
   ``mma.sync`` kernels the Hopper routes replaced (``previous_kernel``,
   ``previous_bwd``), held to the same rule; event times of each kernel,
   of those ``mma.sync`` kernels, of the plain versions, of
   ``scaled_dot_product_attention``'s forward, and of its backward alone
   (``autograd.grad`` over one saved forward; the names of its kernels
   from the profiler, taken in ``main`` before any of the port's kernels
   runs); the host's microseconds per call of each wrapper
   and of its ``mma.sync`` counterpart, the two taking turns;
12. train_vs_cpu: one train step at full width in float32 with 2 layers on
   the card and on the CPU from the same weights and batch: loss within
   rtol 1e-5, grad norm within rtol 1e-4 (float32 sums in another order),
   and the updated parameters: at least 99.9% of each tensor within 1e-6,
   every element within 2 lr + 1e-6 (Adam's first step moves each weight
   by lr times the sign of its gradient, which float32 noise flips where a
   gradient is within noise of zero);
13. train (the main path): ``build_loader`` over a 2,000,000-token corpus
   under ``build/`` (vocabulary 1,024, as ``main`` sizes it), batch 4 x
   2,048 tokens (SmolLM's context length), ``train_loop`` in bf16 with
   ``remat="full"`` at 32 layers for 5 warm-up and 25 timed steps, the
   kernels' launch counts set to 0 just before and read just after
   (64 / 32 / 32 per step required, all through the Hopper kernels:
   ``flash_attention.hopper_launches`` and the ``hopper_launches`` of
   ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``); step time, tokens/s over the median
   step and over the timed steps' wall (loader included), the loader's
   share of that wall, loss, peak
   memory; then one step under ``torch.profiler`` for each kernel's device
   time per launch and their share of the step's device time;
14. resume: at full width with 4 layers, 6 steps with a checkpoint every 3
   and a crash injected after step 4, restarted by ``run_with_restarts``
   from step 3: the final parameters and moments equal an uninterrupted
   run's bitwise.

Mamba serving (slice 4), falcon-mamba-7b at its full width (d_model
4,096, d_inner 8,192, d_state 16, d_conv 4, vocab 65,024):

15. ssm_kernel: ``ssm_scan`` on the card against its plain version: a
   sweep (S = 1, 37, 300, 1,023; N = 4 and 16; h0 present or absent;
   float32 and bf16; x, B and C as the strided views the model passes,
   every call through ``ssm_scan_hopper``, counted by ``hopper_launches``)
   and the prefill's shape, x (8, 1024, 8192) bf16 with N = 16, each tensor
   within the rule SSM_RULE scaled to rms(want) (max error, rms(want) and
   error over the rule printed for y and h_final; y there within
   SSM_PATH_Y_OF_RULE of it; two calls bitwise equal); the simt kernel
   that the Hopper one replaced on those layouts (``previous_ssm_scan``,
   the old wrapper's host work) held to the same rule on the same inputs;
   the mutation check: three edited copies of ``csrc/ssm_scan.cu``'s
   Hopper kernel (one drops D x, one resets h at a stage of the ring, one
   skips the last step), built under ``build/`` and run on the same
   inputs, must each fail the rule at least SSM_MUTANT_MIN times over (the
   least ratio printed beside that threshold); event times of the Hopper
   and the simt kernel in turns and of the plain version, the host's
   microseconds per call of the two wrappers, the bound with its parts
   (bytes; exponentials on the special-function units; the FMA pipe),
   ``ptxas``'s registers and spills of every instantiation and, where the
   toolkit has ``cuobjdump``, the instructions per exponential of both
   kernels' inner loops (N = 16, bf16);
16. ssm_vs_cpu: 2 layers at full width in float32 on the card and on the
   CPU from the same weights: a 300-token prefill (not a multiple of the
   reference's 256-step chunk) at batch 2 and 8 decode steps: logits
   within rtol / atol 1e-3, greedy tokens equal except across ties, the
   convolution and scan states within SSM_STATE_ATOL / SSM_STATE_RTOL;
17. ssm_serve (the main path): ``serve_batch`` at full width and depth (64
   layers, 7.27 B parameters drawn on the card from a seed) in bf16, batch
   8, 1,024-token prompts, 32 new tokens, after a warm-up at the same
   shapes, with ``ssm_scan``'s launch count and ``hopper_launches`` set to
   0 just before and read just after (64 in the prefill, all through
   ``ssm_scan_hopper``, none in the 31 decode steps); time to first token,
   decode ms per step, tokens/s, peak memory; then one prefill (64
   ``ssm_scan_hopper`` launches) and one decode step under
   ``torch.profiler``, and the decode step's wall ms with and without its
   ``full_float32_matmul`` block, in turns;
18. ssm_batching: ``SlotBatcher`` over SSM caches at full width with 4
   layers in float32, 10 requests of 16-512 prompt tokens over 4 slots;
   every request equals its standalone serve except across ties.

The paper's Fig. 5 experiment (slice 9):

19. fig5: ``repro_torch.train.fig5.run`` on a Tahoe-like store of 20,000
   cells x 2,048 genes (FIG5_DATA, the benchmark's width), seed 0 only,
   all four strategies (1,106 steps), from a caller that has TF32 on, with
   ``ell_to_dense``'s launch count set to 0 just before and read just
   after: one launch per step and one per chunk of the held-out plate;
   every macro-F1 finite and in [0, 1]; the TF32 setting after the phase
   what it was before; the host's microseconds per call of
   ``full_float32_matmul`` alone.  Then, at one of its batches (64 cells, K the
   batch's longest row, 2,048 genes), the kernel with and without its fused
   ``log1p`` bitwise the plain version (followed by ``log1p_``), and event
   times of both, of the plain version, of ``index_put_`` and of a
   ``zero_()`` of the output, beside the bound.

The planned storage layer on the cell path (slice 10):

20. planned_cell_path: phase 5's store, strategy and geometry (32,768 cells,
   ``BlockShuffling(16)``, batch 64, ``fetch_factor`` 256: two fetches and
   512 steps an epoch), one epoch of ``train_probe`` from the same heads
   in each of five ways, one after another (PLANNED_TURNS): (a) the
   ``ShardedCSRStore`` directly, as phase 5; (b)
   ``Pipeline.from_uri("sharded-csr://...")``
   with ``io_workers=1`` and ``readahead=0``; (c) ``io_workers=4`` and
   ``readahead=1``; (d) and (e): (b) and (c) with
   ``IOCounters(simulate=NVME_SSD, simulate_scale=1.0)``, whose reads sleep
   as an NVMe disk would (0.8 ms a run, 3.2 GB/s).  The planner's blocks
   are the sampling blocks (``block_rows=16``); its cache holds
   (readahead + 1) fetches of ``avg_row_bytes`` with 25% headroom
   (``PLANNED_CACHE_HEADROOM``).  Each run opens its collection anew (a cold
   block cache).  Every epoch's batches must be bitwise (a)'s (a CRC-32 of
   each batch's values, columns, row pointers and obs on the host), its
   ``ell_to_dense`` launches equal its steps and its losses finite and
   falling; (c) and (e) must count ``prefetched`` blocks.  Per way:
   samples/s, the loader wait (the host's time blocked on the next batch),
   seconds, the stream's idle share and the counters ``runs``, ``bytes_read``, ``cache_hits``,
   ``cache_misses``, ``prefetched``, ``wall_s`` and ``modeled_s``.  No speed
   is asserted.

h5ad plate files and the fetch pool on the cell path (slice 11):

21. h5ad_cell_path: phase 5's plates exported to ``build/chip_smoke_h5ad``
   (one ``.h5ad`` each through ``csr_shard_to_h5ad``, the shim's writer,
   and a ``manifest.json``; the export's seconds and bytes printed), then
   one epoch of ``train_probe`` from the same heads in each of four ways,
   one after another (H5AD_TURNS): (a) the ``ShardedCSRStore`` directly,
   whose batches
   are the reference; (b) ``Pipeline.from_uri("sharded-h5ad://...?driver=
   shim")`` at ``io_workers`` 1 and ``readahead`` 0, its cache sized as
   phase 20's; (c) (b) with ``.prefetch(workers=4)``, through
   ``FetchPool``; (d) (b)'s dataset in a ``DataLoader`` with 4 forked
   workers, which split the fetches round-robin.  (d) shares the
   collection with its workers: it is opened in this process with no
   executor thread, and no lock of it is held at the fork (checked); the
   shim's reads are positioned, so the workers share its descriptors.
   Each worker reports its ``IOCounters`` after its share.  Per way and
   turn the batches must equal (a)'s (the CRC-32 of phase 20; (d) as a
   multiset), ``ell_to_dense`` launch once a step, the losses be finite
   and falling; the obs columns' dtypes must agree between the formats.
   Printed per way: samples/s, loader wait, seconds, the stream's idle
   share and the counters' ``runs``, ``bytes_read``, ``cache_hits``,
   ``cache_misses``, ``wall_s`` and ``modeled_s``; for (c) the pool's
   ``stats``.  Then the paper's random baseline on its format: 64 steps
   of ``BlockShuffling(1)`` with ``fetch_factor`` 1 (one row a block and a
   read, no cache) beside (b)'s first 64 steps, both counted under
   ``IOCounters(simulate=SATA_SSD, simulate_scale=0.0)``, which models the
   disk without sleeping; the page cache is warm.  Where h5py imports,
   one more epoch of (b) through ``driver=h5py``, bitwise (a)'s
   (``h5py_importable`` is printed either way).  No speed is asserted.

The diversity monitor, autotune and resilient storage on the cell path
(slice 12), on phase 5's store:

22. diversity_autotune: ``Pipeline.from_uri("sharded-csr://...")``, its
   cache sized as phase 20's (b), ``BlockShuffling(16)``, batch 64,
   ``drop_last=False`` (a recommended fetch may exceed the store: the
   epoch is then one fetch), ``.diversity(obs="plate",
   entropy_floor=3.5)`` and ``.autotune(budget=2e9)``, which probes a
   freshly opened collection and records its pick in the spec: the
   recommendation, the fitted model's ``c0``, ``c_seek``, ``c_byte``,
   ``hit_rate`` and ``runs_per_sample`` and the probe's seconds are
   printed.  Then one epoch of ``train_probe`` through the tuned pipeline
   with the monitor and one without it (its spec less the diversity
   fields), in turns: both epochs' batches bitwise equal (phase 20's
   CRC-32), ``div_batches`` equal to the steps, the live mean entropy
   within rtol 1e-9 of the offline mean of the delivered plates, the
   measured entropy inside the §3.4 bounds for the tuned block size
   widened by three standard deviations (at least 0.05 bits, the Fig. 4
   benchmark's ``in_bounds``), ``ell_to_dense`` launched once a step,
   losses finite and falling.  Printed per epoch: samples/s and loader
   wait (the monitor's cost is the difference); then ``check_drift()`` and
   a ``retune()`` of the live collection.  Then the Fig. 4 twin
   (``repro_torch.train.fig4.run``) on this store at b in {1, 16, 256} x
   f in {1, 16, 256} and random sampling: H, bounds and ``in_bounds`` per
   cell, each cell's live counters held to its offline mean.
23. resilient_cell_path: phase 21's h5ad plates behind
   ``fault://cloud://sharded-h5ad://...?driver=shim`` (``same-region``
   requests at ``latency_scale=0.1``; ``error_rate=0.05``,
   ``spike_rate=0.02``, ``seed=3``) with ``.resilience(retries=4,
   backoff_s=0.001, max_backoff_s=0.01, hedge_factor=3.0,
   hedge_min_s=0.005, breaker_threshold=3)``, the cache sized as phase
   20's; one epoch of ``train_probe`` each at (a) ``io_workers=1,
   readahead=0``, twice; (b) ``io_workers=4, readahead=1``; (c) (a) with
   shard 1's ops 5-10 failing (``blackout=1:5:11``) and
   ``breaker_cooldown_s=0.001``, with ``retries=8``: one synchronous read
   meets all six failing ops in a row, so 4 retries cannot outlive the
   window (RESILIENT_BLACKOUT_RETRIES).  Every epoch's batches bitwise
   those of phase 5's store (CRC-32), (a)'s ``retries`` equal in its two
   runs and above 0, (c) opening and closing the shard circuit, no read
   out of retries, ``ell_to_dense`` once a step, losses finite and
   falling.  Printed per epoch: samples/s, loader wait, the stream's idle
   share and the counters ``runs``, ``bytes_read``, ``requests``,
   ``request_wait_s``, ``retries``, ``retry_wait_s``, ``hedges_issued``,
   ``hedges_won``, ``breaker_opens`` and ``breaker_closes``.  No speed is
   asserted.

Data serving and the elastic fabric on the cell path (slice 13), on phase
5's store behind ``cloud://sharded-csr://...?profile=same-region&
latency_scale=0.1``:

24. served_cell_path: a ``BatchServer`` in this process on ``127.0.0.1:0``
   (``io_workers=2``, ``block_rows`` 16, ``queue_depth`` 2), its cache
   three times phase 20's synchronous budget for a fetch of 64 x 16 rows
   (printed), and three tenants with identical specs (``BlockShuffling(16)``,
   batch 64, ``fetch_factor`` 16, seed 0), each in a thread of its own with
   its own ``DataClient``, probe heads and CUDA stream, one epoch of
   ``train_probe`` each; tenant 0 stops after 200 steps and resumes over a
   new connection from its ``state()``.  Then a ``qint8`` tenant for one
   fetch, and ``GET /stats`` over HTTP.  The isolated arm: the same three
   specs as local pipelines, a third of the cache each, in three threads.
   Every tenant's and isolated loader's batches must be bitwise one local
   pipeline's epoch of the spec (phase 20's CRC-32), the qint8 tenant's
   columns, row pointers and obs exact and its values within the codec's
   bound (the batch's largest value over 127), the shared arm's
   ``requests`` and ``bytes_read`` strictly below the isolated arm's,
   ``ell_to_dense`` launched once a step in each arm (the count set to 0
   before the threads start and read after they end), losses finite and
   falling.  Printed per arm and tenant: samples/s, loader wait, the
   stream's idle share, wire bytes (the server's ``bytes_sent``) and the
   arm's ``requests``, ``bytes_read``, ``cache_hits``; the ``/stats``
   aggregate.
25. elastic_cell_path: an ``ElasticFabric`` of world 3 over one collection
   (``BlockShuffling(16)``, batch 64, ``fetch_factor`` 8: 64 fetches and
   512 batches an epoch; the planner's default 256-row blocks, so that
   ranks' fetches meet in blocks; the cache three times phase 20's
   synchronous budget, ``io_workers=2``), the ranks drawn in turns batch
   by batch, each through probe heads of its own: 13 batches a rank (the
   kill lands mid-fetch), ``kill(1)``, ``recover()`` of the
   ``RankSupervisor`` that issued and acknowledged every fetch,
   ``resize(2)``, 13 batches a rank, ``resize(3)``, the rest of the epoch.
   Beside it the never-resized world-3 epoch on one collection, and the
   isolated arm: the three ranks on a collection and a third of the cache
   each.  The merged stream keyed by ``(gid, batch_index)`` must be the
   never-resized one (CRC-32), 512 batches and no key twice;
   ``shared_rank_hits > 0``, ``reissued_fetches >= 1`` with rank 1's
   fetch re-issued, no duplicate acknowledgement and nothing outstanding;
   the shared arm's ``requests`` and ``bytes_read`` per sample strictly
   below the isolated arm's; ``ell_to_dense`` launched once a batch;
   losses finite.  Printed per arm: samples/s, loader wait, the stream's
   idle share, ``requests``, ``bytes_read``, ``cache_hits``,
   ``shared_rank_hits``, and ``recover()``'s result.  No speed is
   asserted in either phase.

LM serving of the other registered configs (slice 14), after phase 18:

26. wide_kernels: the forward at gemma-7b's prefill shape, q, k and v (4,
   16, 4,608, 256), causal, and h2o-danube-3-4b's, q (4, 32, 4,608, 120)
   over k, v (4, 8, 4,608, 120), window 4,096 (WIDE_SHAPES), as the model's
   strided (B, S, H, D) views, in bf16 and float32, against the plain
   version: max |err| and rms(err) / rms(want) within WIDE_RULE; bf16
   through the Hopper kernel (``hopper_launches`` + 1; at 256
   ``wide_launches`` + 1 too); gemma's bf16 inputs also copied into rows
   of 260 values (a head stride TMA refuses), through the ``mma.sync``
   kernel ``flash_fwd_bf16<256>`` (``wide_launches`` + 1 alone), within
   the same rule; the mutation check: six edited copies of
   ``csrc/flash_attention.cu`` (WIDE_MUTANTS) must each fail the rule
   FLASH_MUTANT_MIN times over at one of the cases, the unedited build
   pass all, and the one without V's loads is timed beside the unedited
   build at gemma's shape; CUDA-event times, in turns, of the kernel and of
   ``scaled_dot_product_attention`` (at 120 with the kv heads expanded and
   the window as a mask, made outside the timing), at 256 also of
   ``flash_fwd_bf16<256>`` on the same inputs (``previous_kernel``), the
   plain version's, the bound and the kernel's share of it; then
   (``family_kernels``) the same at the prefill shapes of phases 29-30
   (FAMILY_SHAPES): whisper-large-v3's encoder, q, k, v (8, 20, 1,500,
   64), non-causal, internvl2-26b's prefill, q (4, 48, 4,608, 128) over
   k, v (4, 8, 4,608, 128), causal, and jamba-1.5-large's (phase 35), q
   (4, 64, 4,608, 128) over the same k, v, in bf16 through the Hopper
   kernel, within WIDE_RULE of the plain version (run one batch row at a
   time), timed in turns with SDPA, beside the bound (bytes, tensor cores
   and exponentials);
27. dense_serve: phi3-medium-14b (40 layers, head_dim 128), h2o-danube-3-4b
   (24 layers, head_dim 120, window 4,096) and gemma-7b (28 layers,
   head_dim 256) at full width and depth, each first at 2 layers in
   float32 on the card against the CPU (64-token prompts; 4,160 for
   danube, past its window; 4 decode steps; CPU_RTOL / CPU_ATOL, greedy
   ties as phase 8), then in bf16, weights drawn on the card from a seed,
   ``serve_batch`` of 4 prompts of 4,608 tokens and 32 greedy tokens after
   a warm-up serve of 2, with the attention counts set to 0 just before
   and read just after: every prefill layer through the Hopper kernel (at
   256 counted in ``wide_launches`` too); time to first
   token, decode ms per step, peak memory and the route; then one prefill
   and one decode step under ``torch.profiler``: device kernel ms by kind
   (the attention kernel, matrix products, the rest) and the longest
   kernels;
28. moe_serve: mixtral-8x7b and phi3.5-moe-42b-a6.6b at full width and
   MOE_LAYERS of their 32 layers (``reduced``: the full depth does not fit
   the card), each first at 1 layer in float32 on the card against the
   CPU (as phase 27, and each layer's expert choices equal where the
   router's top-k margin exceeds MOE_ROUTER_TIE), then served as phase 27;
   then ``SlotBatcher`` at mixtral's width with 2 layers in float32, 8
   requests over 4 slots: every request equals its standalone serve
   except across ties.

LM serving of the encdec and vlm families (slice 16), after phase 28:

29. encdec_serve: whisper-large-v3 at full width and depth (32 encoder and
   32 decoder layers, d_model 1,280, 20 heads of 64), first at 2 + 2
   layers in float32 on the card against the CPU over 1,500 frames
   (the prefill's BOS logits and 4 decode steps, as phase 27), then in
   bf16, weights drawn on the card from a seed, ``serve_batch`` of 8
   requests of 1,500 frames (the frontend's stub: random frame
   embeddings) and 64 greedy tokens after a warm-up serve of 2, the
   attention counts set to 0 just before and read just after: each of
   the 32 encoder layers' non-causal attention through the Hopper kernel
   (the decoder's prefill is one step at BOS, plain); time to first
   token, decode ms per step, peak memory, the route and the traced
   prefill and decode step, as phase 27;
30. vlm_serve: internvl2-26b at full width and depth (48 layers, d_model
   6,144, 48 heads of 128 over 8), first at 2 layers in float32 on the
   card against the CPU (256 patch embeddings and 64 tokens), then in
   bf16 ``serve_batch`` of 4 requests of 256 patch embeddings (the
   frontend's stub) and 4,352 tokens, 4,608 positions, and 32 greedy
   tokens at positions 4,608 on: every layer's prefill attention through
   the Hopper kernel; as phase 29.

LM training at head_dim 256 and in the MoE family (slice 17), after phase
30, through phase 13's corpus:

31. wide_train_kernels: the forward with lse, dq and dk/dv at gemma-7b's
   training shape, q, k, v and dO (4, 16, 2,048, 256) bf16, causal, as
   the model's strided (B, S, H, D) views, against their plain versions
   by phase 11's training rule (and the sweep's bf16 tolerance), all three
   through the Hopper kernels (``hopper_launches`` of each entry point + 1,
   ``wide_launches`` + 1); the backward's sweep at head_dim 256
   (WIDE_BWD_SWEEP x BWD_MASKS: GQA, T != S, a window) in float32 and bf16
   within BWD_TOL, bf16 through the Hopper kernels and, copied into rows of
   260 values (a stride TMA refuses), through the ``mma.sync`` ones; the
   mutation check: three edited copies of ``csrc/flash_attention_bwd.cu``
   (BWD256_MUTANTS) must each fail the training rule FLASH_MUTANT_MIN
   times over; CUDA-event times in turns of the three kernels and of
   SDPA's forward and backward (its kernels named as phase 11 names
   them), the plain versions', the bounds (bytes, tensor cores,
   exponentials) and each kernel's share of its bound;
32. gemma_train: gemma-7b at full width and GEMMA_TRAIN_LAYERS of its 28
   layers (``reduced``), first one forward and backward through the train
   step's loss (``make_loss_fn``) at 2 layers in float32, 1 x 256 tokens,
   on the card and on the CPU from the same weights: the loss within
   CPU_LOSS_RTOL, the gradient norm and every gradient within
   CPU_GNORM_RTOL (phase 12's rule); then ``train_loop`` in bf16 with
   ``remat="full"``, batch 4 x 2,048, AdamW, 2 warm-up and 10 timed steps,
   the weights drawn on the card from a seed, with the attention kernels'
   counts set to 0 just before and read just after (12 forwards with lse,
   6 dq and 6 dk/dv a step, all through the Hopper kernels at head_dim
   256); the loss finite and falling; step ms, tokens/s, peak memory and
   each step's metrics; one more step under ``torch.profiler``: device
   kernel ms by kind (attention forward and backward, matrix products, the
   rest);
33. moe_train: mixtral-8x7b's training kernels at its shape (q (4, 32,
   2,048, 128) over k, v (4, 8, 2,048, 128), causal, window 4,096) against
   their plain versions and timed in turns with SDPA, beside the bounds
   and ``ptxas``'s spill of ``flash_bwd_dkv_hopper<128>``; then as phase 32
   at MIXTRAL_TRAIN_LAYERS of its 32 layers (1 layer against the CPU, the
   router's aux losses held too), each step's ``moe_lb_loss`` and
   ``z_loss`` printed (4 forwards with lse, 2 dq and 2 dk/dv a step at
   head_dim 128).

``remat="dots"`` and the hybrid family (slice 18), after phase 33:

34. remat_dots: gemma-7b at full width, first at 2 layers in float32, one
   forward and backward through ``make_loss_fn`` under ``remat="dots"``
   and under ``"full"`` on the same weights and tokens: the loss equal and
   the gradients bitwise (where a recomputed product changes bits, each
   within CPU_GNORM_RTOL, the differing tensors printed); then at
   GEMMA_TRAIN_LAYERS in bf16, batch 4 x 2,048, AdamW, one state trained
   DOTS_WARMUP + DOTS_STEPS steps under ``"dots"`` and then under
   ``"full"``, the attention kernels' counts set to 0 just before each
   turn and read just after (12 forwards with lse, 6 dq and 6 dk/dv a
   step under both, all Hopper at head_dim 256: the backward recomputes
   the attention under both); step ms, tokens/s, peak memory, losses;
35. hybrid_serve: jamba-1.5-large-398b at full width (d_model 8,192, 64
   heads of 128 over 8, d_ff 24,576, 16 experts top 2, Mamba d_inner
   16,384 with N 16, no RoPE, vocabulary 65,536), the host's memory
   printed first; at HYBRID_CPU_SCHEDULE (three layers with its three
   kinds) in float32 on the card against the CPU as phase 28 (each MoE
   layer's expert choices compared where the router's margin exceeds
   MOE_ROUTER_TIE), then ``SlotBatcher`` at that schedule as phase 28's;
   then in bf16 at HYBRID_LAYERS of its 72 layers (``reduced``: the
   layers' weights), all 16 experts, ``serve_batch`` as phase 27, the
   counts set to 0 just before and read just after: 4 ``ssm_scan``
   launches a prefill, all ``ssm_scan_hopper``, and 1 through
   ``flash_fwd_hopper<128>``; time to first token, decode ms per step,
   peak memory, and the traced prefill and decode step by kind (the
   scan, attention, products, the rest, and the device time of the MoE
   layers and of their routing, ``moe_dispatch``); then the scan at the
   prefill's shape, x (4, 4,608, 16,384) bf16, dt float32, N 16, through
   ``ssm_scan_hopper`` within SSM_RULE of its plain version, timed around
   it, beside its bound (the forward at that prefill's shape is phase
   26's ``jamba_prefill``).

Training in the ssm and hybrid families (slice 19), after phase 35:

36. ssm_train: (a) the scan's backward (``ssm_scan_bwd``,
   ``csrc/ssm_scan_bwd.cu``) against its plain version
   (``ssm_scan_bwd_ref``) at S 0, 1, 15, 16, 17 and 1,023, N 4 and 16, D
   96 and 200, float32 and bf16, with h0 and a seeded h_final gradient
   and without: on the model's layouts (B and C column views, dy a half
   of a wider tensor) through ``ssm_scan_bwd_hopper``, which reads the
   checkpoints of the training forward (``ssm_scan_train_hopper``, whose
   y and h_final must equal the serving kernel's bitwise), with h0 and
   h_final also with a dy of last stride 2 through
   ``ssm_scan_bwd_strided``: every gradient within SSM_RULE of rms(want)
   (dx by x's type, the rest as float32), each call counted by its route
   and no copy made, the checkpoints handed over and the training
   forwards counted, two calls of either route bitwise equal (the second
   hopper call making its own checkpoints); the mutation check: three edited
   copies of the hopper kernel (SSM_BWD_MUTANTS: ddt without A a_t
   h_{t-1}, the state's adjoint not carried across a segment, one warp's
   dB/dC sums left out of its block's) built under ``build/`` must each
   fail that rule SSM_MUTANT_MIN times over; (b) at falcon-mamba-7b's
   training shape, x and dy (4, 2,048, 8,192) bf16, N 16: the hopper
   kernel within the rule and bitwise repeatable, from the forward's
   checkpoints and from its own, its CUDA-event times in turns with the
   strided kernel it replaced there (``previous_ssm_scan_bwd``), the
   serving forward and the training forward (new, previous, forward,
   training forward, then the other way), the plain backward once, the
   bounds (the backward's: bytes, exponentials, float32 flops; the
   training forward's: the scan's own bytes and exponentials, its
   checkpoints' stores reported beside them), the training forward's
   checkpoints against the plain recurrence's states, and ``ptxas``'s
   registers, spills and stack of both backward kernels; (c) one forward
   and backward of falcon-mamba-7b at 2 layers in float32 on the card and
   on the CPU, by phase 32's rule, the card's scan gradient through the
   hopper kernel (one launch a layer); (e) the same for jamba's smoke
   config (its three kinds of layer, one launch a Mamba layer); (d)
   falcon-mamba-7b at full width (d_model 4,096, d_inner 8,192, N 16,
   vocabulary 65,024, untied) and SSM_TRAIN_LAYERS of its 64 layers
   (``reduced``), trained as phase 32 (bf16, ``remat="full"``, batch 4 x
   2,048, 2 + 10 steps), the scan's counts set to 0 just before and read
   just after (2 ``ssm_scan_train_hopper`` launches and one
   ``ssm_scan_bwd_hopper`` given their checkpoints a layer and step), the
   loss finite and falling; step ms, tokens/s, peak memory, kernel ms by
   kind.

Parallelism (slice 21), after phase 36:

37. sharded_train: a one-rank NCCL group (a ``FileStore`` under
   ``build/``, no network) and a (1, 1) ("data", "model") device mesh;
   smollm-360m at full width and depth (32 layers, bf16,
   ``remat="full"``), drawn on the card from a seed, trained 3 steps
   plainly and, from the same weights and phase 13's corpus batches, 3
   steps rule-sharded (``shard_lm``: FSDP2's ``fully_shard`` of each
   block and the model, each parameter on the dim ``RULES_TRAIN`` puts on
   "data"), the attention kernels' counts set to 0 just before the
   sharded run and read just after (64 forwards with lse, 32 dq and 32
   dk/dv a step, all through the Hopper kernels); the two runs' metrics,
   parameters and moments bitwise equal (else the largest differences,
   and the gradient norm within CPU_GNORM_RTOL, the parameters within
   CPU_PARAM_TOL / CPU_PARAM_SHARE as phase 12); the step-3 checkpoint of
   the sharded state restored by ``reshard_for_mesh`` onto the mesh,
   every tensor bitwise and the loader state as saved; the int8
   error-feedback DDP hook (``ef_int8_hook``) on that group, two steps,
   against ``quantize_ef`` / ``dequantize`` on the card bitwise; step ms
   and peak memory of both runs (and the memory each found resident)
   beside the card's name and power limit, and one more step of each
   under ``torch.profiler``: wall ms, the device's kernel ms and launches.

Tensor and expert parallelism (slice 22): phase 35 goes on through the
model axis, phase 37 takes FSDP2 x TP, and phase 38 runs after 37:

35. (model axis) after the plain bf16 serve, jamba at HYBRID_LAYERS is
   served again from the same weights through ``serve_batch``'s mesh
   path: a one-rank NCCL group and a (1, 1) ("data", "model") mesh under
   ``RULES_DECODE``, the weights placed on it over their own storage (the
   shards' data pointers checked), the cache beside them, prefill and
   WIDE_GEN - 1 decode steps inside the sharding context, the attention
   and scan counts set to 0 just before and read just after (one
   ``flash_fwd_hopper`` and 4 ``ssm_scan_hopper`` launches a prefill);
   every step's logits and the greedy tokens bitwise the plain run's
   (else the first layer whose prefill output differs is printed and the
   logits held to the bf16 rule); first-token and decode ms a step beside
   the plain run's: DTensor's host cost.
37. (routes) the sharded steps run twice from the same weights, each
   beside the plain run with the same checks: FSDP2 alone (``shard_lm``
   on a ("data",) mesh, as before) and FSDP2 x TP (``shard_lm`` on a
   (1, 1) ("data", "model") mesh: the parameters placed on its "model"
   dim first, ``distribute_params`` on ``mesh["model"]``, then sharded
   over "data" by FSDP2; the step runs the model as DTensors inside the
   rules' sharding context).  Both routes' step ms and traced steps are
   printed; the checkpoint is restored from the FSDP2 x TP state.
38. model_axis_kernels: in one process, each rank's slice of the three
   kernels' inputs at model sizes 2 and 4, picked by the helpers the
   model uses (``tensor_parallel.chunk_range`` and ``attention_heads``),
   through the Hopper kernels: jamba's prefill attention (4, 4,608, 64
   heads over 8, 128), smollm-360m's training attention with lse, dq and
   dk/dv at its uneven 15 / 5 split over 2, and falcon-mamba-7b's training
   scan and its backward (4, 2,048, 8,192, N 16).  The slices' outputs put
   together equal the whole call's bitwise (attention per head; the
   scan's y, h, dx, ddt, dA and dD per channel); the dk/dv of kv heads
   several ranks read, and the scan's dB and dC, summed over the slices,
   are printed beside the whole with their worst error, dB and dC within
   float32 rounding (MODEL_AXIS_SUM_RTOL), dk/dv (bf16 outputs: one
   rounding a slice, where the whole call rounds its float32 sum once)
   within a bf16 rounding of each; every slice's launch counted by the
   Hopper counters.

Then the kernels line (one entry per kernel), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero before it.
"""
from __future__ import annotations

import atexit
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

N_GENES = 62_710  # Tahoe-100M's gene count: the probe's full width
DATA = dict(n_cells=32_768, n_genes=N_GENES, n_plates=14, total_counts=2048, chunk=256, seed=0)
BATCH, FETCH_FACTOR, BLOCK = 64, 256, 16
MIN_STEPS = 200
# the JAX package's ELL sweep (tests/test_kernels.py): (rows, K, n_cols)
SWEEP = [(16, 8, 64), (33, 5, 100), (8, 16, 512), (1, 1, 8)]
SWEEP_ATOL = 1e-6
TIMED_CALLS, TIMED_GROUPS = 100, 5
SLEEP_CYCLES = 50_000_000  # ~30 ms of sleep kernel: time to queue TIMED_CALLS calls
SWEEP_ROWS = (64, 132, 264)  # the path's batch, and one and two rows per SM
# the mutation check of ell_to_dense: edited copies of csrc/ell_to_dense.cu,
# built under build/; each must fail phase 4's check (the sweep's atol or
# the path batch's bits, with or without log1p)
ELL_MUTANTS = {
    "skips_epilogue": ("return x == 0.f ? x : log1pf(x);", "return x == 0.f ? x : x;"),
    "drops_each_tiles_first_column": ("if (j[u] >= 0 && j[u] < width) {",
                                      "if (j[u] > 0 && j[u] < width) {"),
    "last_tile_one_float4_short": (
        "for (int i = t; i < n_vec; i += kThreads) {",
        "for (int i = t; i < n_vec - (item % tiles == tiles - 1); i += kThreads) {"),
}
TRACE_STEPS = 64
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# LM serving
ARCH = "smollm-360m"
FA_SWEEP = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 128, 128, 32), (1, 8, 1, 96, 160, 64),
            (2, 2, 1, 64, 128, 32)]  # the JAX package's (B, H, Hkv, S, T, D)
FA_MASKS = [(True, None), (True, 48), (False, None)]
FA_ATOL = {"float32": 3e-5, "bfloat16": 3e-2}
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 64
CPU_PROMPT, CPU_DECODE, CPU_RTOL, CPU_ATOL = 64, 8, 1e-3, 1e-3
# greedy tokens may differ only where two logits of a step lie this close:
# float32 sums in another order (batch of 4 vs 1, card vs CPU)
TIE_F32 = 1e-3
BATCH_SLOTS, BATCH_REQUESTS, BATCH_MAX_LEN = 4, 16, 1024
BATCH_PROMPT_LENS, BATCH_NEW = (64, 512), (16, 64)  # inclusive ranges drawn from
FULL_WIDTH = (32, 960, 15, 5, 64)  # layers, d_model, heads, kv heads, head_dim
# the mutation check of the Hopper forward: edited copies of
# csrc/flash_attention.cu, built under build/; each must fail the training
# shape's rule FLASH_MUTANT_MIN times over
FLASH_MUTANTS = {
    "drops_alpha_rescale": ("o[i2] *= alpha[(i2 / 2) % 2];", "(void)alpha;"),
    "skips_last_kv_tile": ("(k_end - wk.kt0 + kBlockN - 1) / kBlockN", "(k_end - wk.kt0 - 1) / kBlockN"),
    "diagonal_off_by_one": ("p.causal ? clamp_col<kBlockN>(d) : kBlockN",
                            "p.causal ? clamp_col<kBlockN>(d + 1) : kBlockN"),
}
FLASH_MUTANT_MIN = 3.0
# the mutation check of the Hopper backward: edited copies of
# csrc/flash_attention_bwd.cu, built under build/; each must fail the training
# shape's rule (on dq, dk or dv) FLASH_MUTANT_MIN times over.  The dk/dv one
# skips each item's first query tile, the one on the causal diagonal: under
# the causal mask a key's largest probabilities come from the queries just
# after it, while its last query tile adds about 1/2,048 of a softmax row each.
BWD_MUTANTS = {
    "dkv_drops_delta": ("dp[i] = pr * (dp[i] - (x % 2 ? dl.y : dl.x));", "dp[i] = pr * dp[i];"),
    "dkv_skips_first_query_tile": ("wk.qt0 = static_cast<int>(lo / kTileQ) * kTileQ;",
                                   "wk.qt0 = static_cast<int>(lo / kTileQ) * kTileQ + kTileQ;"),
    "dq_diagonal_off_by_one": ("p.causal ? hopper::clamp_col<kN>(d) : kN",
                               "p.causal ? hopper::clamp_col<kN>(d + 1) : kN"),
}
# LM training
BWD_SWEEP = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 64, 64, 32), (1, 2, 1, 96, 96, 16)]
BWD_MASKS = [(True, None), (True, 32), (False, None)]
BWD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (3e-2, 2e-2)}  # (atol, rtol)
# At the training shape the values are small (dq, dk and dv of a 2,048-key
# softmax: rms about 0.1), so BWD_TOL's atol would be as large as what it
# checks.  There each tensor is held to |got - want| <= TRAIN_TOL_RMS *
# rms(want) + TRAIN_TOL_REL * |want|: the relative term is two bf16 ulps of
# the value (both sides round their float32 result to bf16, one ulp being at
# most 2**-7 of it), the rms term takes the kernels' rounding of P and dS to
# bf16 as operands, whose errors are spread over the tensor.
TRAIN_TOL_RMS, TRAIN_TOL_REL = 0.1, 2**-6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 2048, 5, 25
TRAIN_CORPUS_TOKENS = 2_000_000
CPU_STEP_LAYERS, CPU_STEP_BATCH, CPU_STEP_SEQ, CPU_STEP_LR = 2, 2, 128, 3e-4
CPU_LOSS_RTOL, CPU_GNORM_RTOL, CPU_PARAM_TOL, CPU_PARAM_SHARE = 1e-5, 1e-4, 1e-6, 0.999
RESUME_LAYERS, RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = 4, 6, 3, 4
# Mamba serving
SSM_ARCH = "falcon-mamba-7b"
SSM_FULL = (64, 4096, 8192, 16, 4)  # layers, d_model, d_inner, d_state, d_conv
# (B, S, D, N): S = 1, S under one 16-step chunk and past several (1,023
# too); N = 4 (the smoke config) and 16, the kernels' only state sizes; D
# not a multiple of the kernels' 128 channels
SSM_SWEEP = [(2, 1, 64, 4), (2, 37, 200, 4), (1, 300, 160, 16), (2, 37, 96, 16),
             (1, 1, 128, 16), (2, 300, 256, 4), (2, 1023, 200, 16)]
SSM_PATH = (8, 1024, 8192, 16)  # the prefill's scan: batch 8, 1,024-token prompts
# The scan's rule, written before the first run: |got - want| <= a rms(want)
# + r |want|, per tensor; (a, r) by the type of what is compared.  float32
# (y and h_final, and h_final in bf16, which stays float32): a recurrence of
# up to 1,024 steps that rounds the state once per step (2**-24) and takes
# its exponentials on the special-function unit (about 2**-22); the errors
# add along the decay's memory, up to about 1,000 steps: about 2**-14 of the
# scale, and four times that.  bf16 y: each side rounds its float32 y once;
# where float32 noise moves a value across a rounding boundary the two
# differ by one bf16 ulp, at most 2**-7 of the value, which is half of r;
# a covers values near zero.  So the shipped kernel's error sits under half
# the rule, and a mutant must fail it SSM_MUTANT_MIN times over.
SSM_RULE = {"float32": (2**-12, 2**-12), "bfloat16": (2**-8, 2**-6)}
SSM_MUTANT_MIN = 3.0
SSM_PATH_Y_OF_RULE = 0.5  # the path shape's bf16 y stays within half the rule (see above)
# the mutation check: edited copies of csrc/ssm_scan.cu, built under build/,
# each an edit of ssm_scan_hopper (the kernel the model's layouts take).  No
# edit of the ring itself (a stage read before its copy lands) is among
# them: what such a kernel reads depends on when the copy lands, so it
# would not fail the same way on every run.
SSM_MUTANTS = {
    "drops_D_x": ("const float yv = acc + dd * xv;", "const float yv = acc;"),
    "resets_h_at_stage_boundary": (
        "    const St& st = ring[stage];\n",
        "    const St& st = ring[stage];\n    if (c > 0 && stage == 0) {\n#pragma unroll\n"
        "      for (int n = 0; n < kN; ++n) h[n] = 0.f;\n    }\n"),
    "skips_last_step": ("const int64_t rest = p.S - t0;", "const int64_t rest = p.S - 1 - t0;"),
}
SFU_EXP2_PER_CLOCK_PER_SM = 16  # CUDA C++ Programming Guide, compute capability 9.0
SCHEDULERS_PER_SM = 4  # each issues one warp instruction a clock
SSM_SERVE_BATCH, SSM_SERVE_PROMPT, SSM_SERVE_GEN = 8, 1024, 32
SSM_CPU_LAYERS, SSM_CPU_BATCH, SSM_CPU_PROMPT, SSM_CPU_DECODE = 2, 2, 300, 8
# the card's float32 state against the CPU's: 300 recurrence steps and two
# layers of float32 sums in another order
SSM_STATE_ATOL, SSM_STATE_RTOL = 1e-4, 1e-3
SSM_BATCH_LAYERS, SSM_BATCH_REQUESTS, SSM_BATCH_MAX_LEN = 4, 10, 1024
SSM_BATCH_PROMPT_LENS, SSM_BATCH_NEW = (16, 512), (8, 32)  # inclusive ranges drawn from
# the Fig. 5 experiment: the benchmark's 2,048 genes, cut from 150,000 cells
# to 20,000 (one fetch of each block strategy) and from two seeds to one
DECODE_TURNS, DECODE_TURN_STEPS = 5, 4  # decode with and without the TF32 block, in turns
FIG5_DATA = dict(n_cells=20_000, n_genes=2_048, seed=0)
FIG5_SEEDS = (0,)
# the planned cell path: ways (a)-(e) of phase 20, each (io_workers,
# readahead, simulated storage); None is the store read directly
PLANNED_WAYS = {"a_direct": None, "b_planned": (1, 0, False), "c_readahead": (4, 1, False),
                "d_planned_nvme": (1, 0, True), "e_readahead_nvme": (4, 1, True)}
# one turn of the ways each: the script's time limit (1,200 s) holds the
# host-bound cell path's epochs, which a slow host stretches by a third
PLANNED_TURNS = 1
PLANNED_CACHE_HEADROOM = 1.25
# the h5ad cell path: ways (a)-(d) of phase 21; None is the CSR store read
# directly, else how sharded-h5ad:// is iterated
H5AD_WAYS = {"a_direct": None, "b_h5ad": "sync", "c_fetch_pool": "pool",
             "d_dataloader": "dataloader"}
H5AD_TURNS = 1  # as PLANNED_TURNS
H5AD_POOL_WORKERS = 4  # FetchPool threads of way (c)
H5AD_LOADER_WORKERS = 4  # DataLoader processes of way (d)
H5AD_LOADER_TIMEOUT_S = 300  # a worker that hangs raises instead of holding the call
RANDOM_STEPS = 64  # the paper's random baseline: b = 1, f = 1
# the diversity monitor and autotune on the cell path (phase 22)
DIVERSITY_FLOOR = 3.5  # bits: 14 plates have H(p) about 3.77, the IID deficit at m 64 is 0.15
AUTOTUNE_BUDGET = 2e9
FIG4_SUBGRID = ((1, 16, 256), (1, 16, 256))  # (b, f) of the Fig. 4 twin on phase 5's store
# resilient storage on the cell path (phase 23)
RESILIENT_FAULTS = "profile=same-region&latency_scale=0.1&error_rate=0.05&spike_rate=0.02&seed=3"
RESILIENT_KNOBS = dict(retries=4, backoff_s=0.001, max_backoff_s=0.01, hedge_factor=3.0,
                       hedge_min_s=0.005, breaker_threshold=3)
RESILIENT_BLACKOUT = "1:5:11"  # shard 1's ops 5-10 fail: the reference test's window
RESILIENT_BLACKOUT_RETRIES = 8  # a read meets all six failing ops: 4 retries run out first
# ways of phase 23: (io_workers, readahead, blackout)
RESILIENT_WAYS = {"a_sync": (1, 0, False), "a_sync_again": (1, 0, False),
                  "b_readahead": (4, 1, False), "c_blackout": (1, 0, True)}
RESILIENT_IO = ("runs", "bytes_read", "requests", "request_wait_s", "retries", "retry_wait_s",
                "hedges_issued", "hedges_won", "breaker_opens", "breaker_closes")
# the served cell path (phase 24): tenants of one server on phase 5's store
SERVE_TENANTS = 3
SERVE_FETCH_FACTOR = 16  # the reference's serving benchmark's geometry (bench_serve.py)
SERVE_CLOUD = "profile=same-region&latency_scale=0.1"
SERVE_RESUME_AFTER = 200  # tenant 0's steps before it reconnects and resumes
SERVE_QINT8_STEPS = 16  # one fetch of the qint8 tenant
SERVE_SOCKET_S = 120.0  # every client socket's timeout
SERVE_THREAD_S = 600.0  # a tenant thread still running after this fails the phase
# the elastic cell path (phase 25): the reference's elastic benchmark's geometry
ELASTIC_WORLD = 3
ELASTIC_FETCH_FACTOR = 8
ELASTIC_PHASE_BATCHES = 13  # a rank's batches between events: the kill lands mid-fetch
ELASTIC_HEARTBEAT_S = 0.05  # the liveness timeout: the killed rank is a suspect after it
# LM serving of the other registered configs (phases 26-28)
DENSE_ARCHS = ("phi3-medium-14b", "h2o-danube-3-4b", "gemma-7b")
MOE_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
MOE_LAYERS = 16  # of 32: the full depth's bf16 weights (93 GB, 84 GB) exceed the card's 80 GB
WIDE_BATCH, WIDE_PROMPT, WIDE_GEN = 4, 4608, 32  # prompts past danube's and mixtral's 4,096 window
# the card against the CPU in float32 at full width: layers, prompt, decode steps
WIDE_CPU_LAYERS, MOE_CPU_LAYERS, WIDE_CPU_PROMPT, WIDE_CPU_DECODE = 2, 1, 64, 4
DANUBE_CPU_PROMPT = 4160  # past the 4,096-token window: the mask cuts and the ring wraps
# expert choices are compared where the router's k-th and (k+1)-th
# probabilities lie further apart than this: float32 router logits summed
# in another order move a probability by about 1e-7
MOE_ROUTER_TIE = 1e-4
MOE_BATCH_LAYERS, MOE_BATCH_REQUESTS, MOE_BATCH_MAX_LEN = 2, 8, 512
MOE_BATCH_PROMPT_LENS, MOE_BATCH_NEW = (16, 128), (4, 16)  # inclusive ranges drawn from
# the forward at the new head widths' serving shapes, (B, H, Hkv, S, D,
# window): gemma-7b's prefill and h2o-danube-3-4b's
WIDE_SHAPES = {"d256": (4, 16, 16, 4608, 256, None), "d120": (4, 32, 8, 4608, 120, 4096)}
# (max |got - want|, rms(got - want) / rms(want)) at those shapes.  The max
# is phase 7's atol; the rms term sees what the max cannot at 4,608 keys,
# where an output's rms is about 0.02: float32, sums in another order
# (measured: 2e-5 of rms(want)); bf16, each side rounds its output to bf16
# once (an error of about 2**-9 of rms(want)) and P as an operand
WIDE_RULE = {"float32": (3e-5, 2**-12), "bfloat16": (3e-2, 2**-7)}
WIDE_TIMED_CALLS = 10
# LM serving of the encdec and vlm families (phases 29-30): whisper-large-v3
# over 8 requests of 1,500 frames (its encoder's 30 s window, cross_len),
# 64 new tokens; internvl2-26b over 4 requests of 256 patch embeddings and
# 4,352 tokens (the 4,608 positions of phases 27-28), 32 new tokens
ENCDEC_ARCH, VLM_ARCH = "whisper-large-v3", "internvl2-26b"
ENCDEC_BATCH, ENCDEC_GEN = 8, 64
VLM_BATCH, VLM_TEXT = 4, 4352
# the card against the CPU in float32: whisper at 2 + 2 layers over 1,500
# frames, internvl2 at 2 layers over its 256 patches and WIDE_CPU_PROMPT tokens
FAMILY_CPU_LAYERS = 2
# the forward at those prefills' shapes, (B, H, Hkv, S, D, causal), timed in
# phase 26: whisper's encoder (non-causal self-attention over the frames)
# and internvl2's prefill
FAMILY_SHAPES = {"whisper_encoder": (8, 20, 20, 1500, 64, False),
                 "internvl2_prefill": (4, 48, 8, 4608, 128, True),
                 "jamba_prefill": (4, 64, 8, 4608, 128, True)}
# the mutation check at the new shapes: edited copies of
# csrc/flash_attention.cu, each of which must fail WIDE_RULE at one of
# wide_kernel_phase's cases FLASH_MUTANT_MIN times over: the mma.sync
# kernel's head_dim 256 Q.K^T without its last 16 columns (on the layout
# TMA refuses), the Hopper kernel's S without its last 16-column step,
# the Hopper kernel's P.V without V's last 64-column panel (V's tensor map
# ends at column 192 at head_dim 256, so TMA fills that panel with
# zeros), the Hopper kernel at head_dim 256 without V's loads (P.V reads
# whatever the stage held; phase 26 also times it beside the unedited
# build: what V's bytes from L2 cost), head_dim 120's store without its
# last 8 columns (the output there is left as allocated), float32's Q.K^T
# without its last column
WIDE_MUTANTS = {
    "d256_hopper_s_skips_last_step": (
        "for (int kk = 0; kk < kD / 16; ++kk) {  // 16 columns of Q and K a step",
        "for (int kk = 0; kk < kD / 16 - 1; ++kk) {  // 16 columns of Q and K a step"),
    "d256_hopper_pv_drops_last_v_panel": (
        "p.B, p.Hkv, p.T, extent, p.v_sb", "p.B, p.Hkv, p.T, kD == 256 ? 192 : extent, p.v_sb"),
    "d256_hopper_skips_v_loads": (
        "mbar_expect_tx(bar_v + 8 * s, L::kTileBytes);",
        "if (kD == 256) { mbar_arrive(bar_v + 8 * s); continue; } "
        "mbar_expect_tx(bar_v + 8 * s, L::kTileBytes);"),
    "d256_qk_skips_last_slice": (
        "for (int kk = 0; kk < kD / 16; ++kk) {  // one fragment of A a step",
        "for (int kk = 0; kk < kD / 16 - 1; ++kk) {  // one fragment of A a step"),
    "d120_store_drops_last_8_columns": ("if (8 * j >= p.D) break;",
                                        "if (8 * j >= p.D - 8) break;"),
    "f32_qk_skips_last_column": ("for (int d = 0; d < p.D; ++d) {",
                                 "for (int d = 0; d < p.D - 1; ++d) {"),
}
# LM training at head_dim 256 and in the MoE family (phases 31-33):
# gemma-7b at GEMMA_TRAIN_LAYERS of its 28 layers (the full depth's bf16
# weights and gradients and float32 AdamW moments need 102 GB) and
# mixtral-8x7b at MIXTRAL_TRAIN_LAYERS of its 32 (the full depth's bf16
# weights alone exceed the card), both at full width, batch TRAIN_BATCH x
# TRAIN_SEQ through phase 13's corpus
GEMMA_ARCH, MIXTRAL_ARCH = "gemma-7b", "mixtral-8x7b"
GEMMA_TRAIN_LAYERS, MIXTRAL_TRAIN_LAYERS = 6, 2
WIDE_TRAIN_WARMUP, WIDE_TRAIN_STEPS = 2, 10
# the card against the CPU in float32: layers at full width, 1 x 256 tokens
WIDE_TRAIN_CPU_LAYERS = {GEMMA_ARCH: 2, MIXTRAL_ARCH: 1}
WIDE_TRAIN_CPU_SEQ = 256
# the backward's sweep at head_dim 256, (B, H, Hkv, S, T, D): one kv head
# a query head, GQA 2:1 over an uneven S, 4:1 with T > S and with T < S
WIDE_BWD_SWEEP = [(1, 2, 2, 64, 64, 256), (2, 4, 2, 130, 130, 256), (1, 8, 2, 96, 160, 256),
                  (1, 4, 1, 200, 120, 256)]
# remat="dots" against "full" in gemma-7b's training (phase 34): steps a turn
DOTS_WARMUP, DOTS_STEPS = 2, 5
# jamba-1.5-large served (phase 35): at 5 of its 72 layers, which hold every
# kind of layer it has (Mamba with an MLP, Mamba with an MoE, attention with
# an MLP) in 24.0 B weights, 48.1 GB in bf16 (8 layers would need 90 GB);
# against the CPU in float32 at three layers with those kinds (attention at
# layer 2 of a period of 3, the MoE at layer 1, as jamba's schedule puts
# them at 4 and at every odd layer); the prefill's scan, (B, S, d_inner, N)
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_LAYERS = 5
HYBRID_CPU_SCHEDULE = dict(num_layers=3, attn_period=3, attn_offset=2)
HYBRID_SCAN = (4, 4608, 16384, 16)
# the mutation check of the backward at head_dim 256: edited copies of
# csrc/flash_attention_bwd.cu, each of which must fail the training rule
# FLASH_MUTANT_MIN times over at gemma's training shape: dK without the
# delta of dS (the dS side of the split dk/dv kernel), dQ without the
# second 16-key step of each 32-key tile, P^T's causal mask seeing one
# query too many (a key counted by the query just before it)
BWD256_MUTANTS = {
    "d256_dkv_drops_delta": ("st[i] = buf[128 * i + x] * (st[i] - (e % 2 ? dl.y : dl.x));",
                             "st[i] = buf[128 * i + x] * st[i];"),
    "d256_dq_skips_last_key_step": ("for (int kk = 0; kk < kN / 16; ++kk) {",
                                    "for (int kk = 0; kk < kN / 16 - 1; ++kk) {"),
    "d256_dkv_diagonal_off_by_one": (
        "-kTileQ : hopper::clamp_col<kTileQ>(d - 1) - 2 * t;",
        "-kTileQ : hopper::clamp_col<kTileQ>(d - 2) - 2 * t;"),
}
# The scan's backward and the ssm family's training (phase 36).  The sweep
# of (a): S = 0, one step, around the backward's 8-step segments (15, 16,
# 17) and 1,023; D 96 (less than one of the hopper kernel's 128-channel
# blocks, three of the strided kernel's 32) and 200 (no whole number of
# either); every gradient held to SSM_RULE scaled to rms(want) (dx by x's
# type, the rest as float32)
SSM_BWD_S = (0, 1, 15, 16, 17, 1023)
SSM_BWD_D = (96, 200)
SSM_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
# the mutation check: edited copies of csrc/ssm_scan_bwd.cu's hopper
# kernel, built under build/, each of which must fail the rule
# SSM_MUTANT_MIN times over on the sweep's longest case: ddt without its A
# a_t h_{t-1} term, the state's adjoint not carried from one segment into
# the one before it, and the last warp's dB_t/dC_t sums left out of its
# block's
SSM_BWD_MUTANTS = {
    "ddt_drops_A_a_h": ("const float vt = fmaf(xv, dxs, kLn2 * dda);",
                        "const float vt = xv * dxs;"),
    "drops_carry_across_segments": (
        "    float* ow = ost + buf * kSeg * 2 * kChannels;\n",
        "    float* ow = ost + buf * kSeg * 2 * kChannels;\n"
        "    if (s < segs - 1) {\n#pragma unroll\n"
        "      for (int i = 0; i < kS; ++i) carry[i] = 0.f;\n    }\n"),
    "drops_last_warp_of_block_sum": (
        "for (int w = 0; w < kWarps; ++w) acc += rw[",
        "for (int w = 0; w < kWarps - 1; ++w) acc += rw["),
}
SSM_BWD_MUTANT_CASE = (2, 1023, 200, 16)
# (b): falcon-mamba-7b's training scan, batch 4 x 2,048 tokens (phase 13's
# shape), d_inner 8,192, N 16
SSM_BWD_PATH = (TRAIN_BATCH, TRAIN_SEQ, 8192, 16)
SSM_BWD_TIMED_CALLS = 10
# float32 flops the backward must do per state and step: seven FMAs (h_t,
# dh_t, the dB, dC and dx terms, dA's and ddt's sums of dh a_t h_{t-1})
# and four products (dt A, a_t h_{t-1}, dh a_t h_{t-1}, the carried a_t dh)
SSM_BWD_FLOPS = 18
# (c)-(e): falcon-mamba-7b at 2 layers in float32 against the CPU, trained
# at 8 of its 64 layers (the full depth's 7.27 B weights, gradients and
# AdamW moments need 87 GB at 12 bytes a weight); jamba's smoke config (one
# period of 4: Mamba, Mamba with MoE, attention, Mamba with MoE) against the
# CPU in float32
SSM_TRAIN_LAYERS, SSM_TRAIN_CPU_LAYERS = 8, 2
# the rule-sharded train step (phase 37): steps of each run, the DDP hook's
# weight (rows, columns: 2,100 values, not a whole number of 256-blocks)
SHARDED_STEPS, HOOK_SHAPE = 3, (7, 300)
# per-rank slices of the kernels (phase 38): jamba's prefill attention
# (B, S, H, Hkv, D), smollm-360m's training attention, falcon-mamba-7b's
# training scan (B, S, d_inner, N); the "model" sizes; the sums over slices
# (dB, dC) within this share of the whole's largest magnitude
MODEL_AXIS_ATTN = (4, 4608, 64, 8, 128)
MODEL_AXIS_TRAIN_ATTN = (4, 2048, 15, 5, 64)
MODEL_AXIS_SCAN = (4, 2048, 8192, 16)
MODEL_AXIS_SIZES = (2, 4)
MODEL_AXIS_SUM_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, calls: int = TIMED_CALLS, groups: int = TIMED_GROUPS) -> float:
    """Device ms per call of ``fn``: one CUDA-event pair around ``calls``
    back-to-back calls, divided by their number; the median of ``groups``
    such groups.  A sleep kernel ahead of each group holds the stream
    while the host queues the calls, so the host's time per call does not
    count unless ``fn`` itself waits for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def host_us(fns: dict, calls: int = TIMED_CALLS, groups: int = 2 * TIMED_GROUPS + 1) -> dict:
    """Host microseconds per call of each function of ``fns``: the wall
    time to issue ``calls`` calls while a sleep kernel holds the stream (so
    that no call waits for the device), divided by their number; the
    median of ``groups`` such groups, the functions taking turns group by
    group so that a drift of the host's speed falls on each alike."""
    import torch

    per_call = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(groups):
        for name, fn in fns.items():
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per_call[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in per_call.items()}


def decode_ms_with_and_without_block(params, tok, cache, pos: int) -> dict:
    """Wall ms per decode step through ``decode_lm`` (one
    ``full_float32_matmul`` block a call) and through the same function
    without its block (the step as it was before the block, the flag being
    off for the whole script), DECODE_TURN_STEPS steps at a time, the two
    taking turns DECODE_TURNS times; the median of each."""
    import inspect

    import torch

    from repro_torch.models import transformer as tr

    bare = inspect.unwrap(tr.decode_lm)

    def without_block():
        with torch.no_grad():
            return bare(params, tok, cache, pos)

    fns = {"decode_lm": lambda: tr.decode_lm(params, tok, cache, pos),
           "without_block": without_block}
    per_step = {name: [] for name in fns}
    for _ in range(DECODE_TURNS):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DECODE_TURN_STEPS):
                fn()
            torch.cuda.synchronize()
            per_step[name].append((time.perf_counter() - t0) / DECODE_TURN_STEPS * 1e3)
    return {"steps": DECODE_TURN_STEPS, "turns": DECODE_TURNS,
            **{name: statistics.median(t) for name, t in per_step.items()}}


def previous_ell_to_dense(vals, cols, n_cols: int):
    """ELL -> dense through the kernel that the tiled one replaced
    (``ell_to_dense_rowblock_f32``: one block per row, a zero-fill of the
    row in the card's memory, then global atomics), launched from the
    package's library with the host work its wrapper did before: its
    checks (copied here), the output and the C call under a device guard
    with the current ``Stream`` object.  For its device and host times
    beside the tiled kernel's; counts nothing."""
    import torch

    from repro_torch.kernels import csr_to_dense

    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"vals and cols must be (R, K) of one shape, got {tuple(vals.shape)} "
                         f"and {tuple(cols.shape)}")
    if not (isinstance(n_cols, int) and n_cols > 0):
        raise ValueError(f"n_cols must be a positive int, got {n_cols!r}")
    if not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("vals and cols must be contiguous")
    if vals.device.type != "cuda" or cols.device != vals.device:
        raise ValueError(f"the kernel takes tensors on one CUDA device, got {vals.device} "
                         f"and {cols.device}")
    R, K = vals.shape
    if R >= 2**31:
        raise ValueError(f"at most 2**31 - 1 rows per launch, got {R}")
    out = torch.empty((R, n_cols), dtype=torch.float32, device=vals.device)
    if R == 0:
        return out
    lib = csr_to_dense._library()
    with torch.cuda.device(vals.device):
        err = lib.ell_to_dense_rowblock_f32(vals.data_ptr(), cols.data_ptr(), out.data_ptr(),
                                            R, K, n_cols, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_to_dense_rowblock launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    return out


def previous_kernel(q, k, v, with_lse: bool):
    """Causal attention through the ``mma.sync`` kernel (``flash_fwd_bf16``)
    that the Hopper route replaced, launched from the package's library with
    the host work its wrapper did before that route: the checks, the
    outputs and the C call.  For its device and host times beside the
    Hopper kernel's; counts nothing.  Returns ``(out, lse or None)``."""
    import ctypes

    import torch

    from repro_torch.kernels import flash_attention as fa

    fa.check_layout(q, k, v, None)
    fa.check_device(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = fa.empty_like_rows(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    dims = (ctypes.c_int64 * 6)(B, H, Hkv, S, T, D)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = fa._library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), 1, dims, strides, 1, 0, 0, 0,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    fa.raise_on_error(lib, err, "flash_fwd_bf16")
    return out, lse


def previous_bwd(q, k, v, dout, lse, delta, dkv: bool) -> tuple:
    """dq, or (dk, dv), through the ``mma.sync`` kernels (``dq_bf16``,
    ``dkv_bf16``) that the Hopper route replaced, launched from the
    package's library with the host work their wrapper did before that
    route: the checks, the outputs and the C call under a device guard with
    the current ``Stream`` object.  For their device and host times beside
    the Hopper kernels'; counts nothing.  Returns the outputs."""
    import ctypes

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    fa.check_layout(q, k, v, None)
    fa.check_device(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError("dout does not fit q")
    if dout.stride(3) != 1:
        raise ValueError("dout needs a contiguous last axis")
    for t in (lse, delta):
        if t.shape != (B, H, S) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError("lse and delta must be (B, H, S) float32 on q's device")
        if not t.is_contiguous():
            raise ValueError("lse and delta must be contiguous")
    outs = (fa.empty_like_rows(k), fa.empty_like_rows(v)) if dkv else (fa.empty_like_rows(q),)
    tensors = (q, k, v, dout, *outs)
    strides = (ctypes.c_int64 * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))
    lib = fab._library()
    fn = lib.flash_attention_bwd_dkv if dkv else lib.flash_attention_bwd_dq
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in (q, k, v, dout, lse, delta, *outs)), 1,
                 (ctypes.c_int64 * 6)(B, H, Hkv, S, T, D), strides, 1, 0, 0, 1.0 / math.sqrt(D),
                 torch.cuda.current_stream().cuda_stream)
    fa.raise_on_error(lib, err, "dkv_bf16" if dkv else "dq_bf16")
    return outs


def _previous_ssm_checks(x, dt, A, Bc, Cc, D, h0) -> None:
    """The checks the scan's wrapper made before the Hopper route (its
    ``_check_inputs`` then, copied here): types, shapes, one CUDA device,
    contiguous A, D and h0; no route and no stride read."""
    import torch

    from repro_torch.kernels import ssm_scan as ssm

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    named = {"dt": dt, "A": A, "Bc": Bc, "Cc": Cc, "D": D}
    if h0 is not None:
        named["h0"] = h0
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2 or A.shape[0] != x.shape[2]:
        raise ValueError(f"need x, dt (B, S, D) and A (D, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    if N not in ssm.STATE_SIZES:
        raise ValueError(f"the state size N must be one of {ssm.STATE_SIZES}, got {N}")
    if Bc.shape != (Bsz, S, N) or Cc.shape != (Bsz, S, N):
        raise ValueError(f"need B and C ({Bsz}, {S}, {N}), got {tuple(Bc.shape)}, "
                         f"{tuple(Cc.shape)}")
    if D.shape != (Dm,):
        raise ValueError(f"need D ({Dm},), got {tuple(D.shape)}")
    if h0 is not None and h0.shape != (Bsz, Dm, N):
        raise ValueError(f"need h0 ({Bsz}, {Dm}, {N}), got {tuple(h0.shape)}")
    tensors = [x, *named.values()]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"the kernel takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    for name in ("A", "D", "h0"):
        if name in named and not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bsz >= 2**16:
        raise ValueError(f"at most 65,535 batch rows per launch, got {Bsz}")


def previous_ssm_scan(x, dt, A, Bc, Cc, D, h0):
    """The selective scan through the kernel that ``ssm_scan_hopper``
    replaced on the model's layouts (``ssm_scan_kernel``, the simt route),
    launched from the package's library with the host work its wrapper did
    before: the checks (:func:`_previous_ssm_checks`, without the route),
    the outputs and the C call under a device guard with the current
    ``Stream`` object.  For its device and host times beside the Hopper
    kernel's; counts nothing.  Returns (y, h_final)."""
    import ctypes

    import torch

    from repro_torch.kernels import ssm_scan as ssm

    _previous_ssm_checks(x, dt, A, Bc, Cc, D, h0)
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    y = torch.empty((Bsz, S, Dm), dtype=x.dtype, device=x.device)
    h_final = torch.empty((Bsz, Dm, N), dtype=torch.float32, device=x.device)
    dims = (ctypes.c_int64 * 4)(Bsz, S, Dm, N)
    strides = (ctypes.c_int64 * 12)(*(s for t in (x, dt, Bc, Cc) for s in t.stride()))
    lib = ssm._library()
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), 0 if x.dtype == torch.float32 else 1, dims, strides,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_kernel launch failed: {lib.cuda_error_string(err).decode()}")
    return y, h_final


def previous_ssm_scan_bwd(x, dt, A, Bc, Cc, D, h0, dy, dh_final=None):
    """The scan's backward through the kernel that ``ssm_scan_bwd_hopper``
    replaced on the model's layouts (``ssm_scan_bwd_strided``, the
    wrapper's strided route, which takes any layout), with the host work
    its wrapper did: the checks, the outputs and the scratch (checkpoints
    and one dB/dC partial per 32 channels), one C call.  For its device
    time beside the new kernel's on the same inputs; counts nothing.
    Returns ``(dx, ddt, dA, dB, dC, dD, dh0)``."""
    import ctypes

    import torch

    from repro_torch.kernels import ssm_scan as ssm

    ssm._check_bwd_inputs(x, dt, A, Bc, Cc, D, h0, dy, dh_final)
    Bsz, S, Dm = x.shape
    N = Bc.shape[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, Dm), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, S, Dm), **f32)
    dB, dC = torch.empty((Bsz, S, N), **f32), torch.empty((Bsz, S, N), **f32)
    dA, dD, dh0 = torch.empty((Dm, N), **f32), torch.empty((Dm,), **f32), torch.empty(
        (Bsz, Dm, N), **f32)
    lib = ssm._bwd_library()
    seg, lanes = lib.ssm_scan_bwd_segment_steps(), lib.ssm_scan_bwd_block_channels()
    scratch = (torch.empty((Bsz, -(-S // seg), N * Dm), **f32),
               torch.empty((Bsz, -(-Dm // lanes), S, 2 * N), **f32),
               torch.empty((Bsz, Dm, N), **f32), torch.empty((Bsz, Dm), **f32))
    tensors = (x, dt, A, Bc, Cc, D, h0, dy, dh_final, dx, ddt, dB, dC, dA, dD, dh0, *scratch)
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_bwd(
            *(None if t is None else t.data_ptr() for t in tensors),
            0 if x.dtype == torch.float32 else 1, (ctypes.c_int64 * 4)(Bsz, S, Dm, N),
            (ctypes.c_int64 * 15)(*(s for t in (x, dt, Bc, Cc, dy) for s in t.stride())),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd_strided launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    return dx, ddt, dA, dB, dC, dD, dh0


def sdpa_backward_kernels(dev, shape) -> list:
    """The names of the kernels that ``scaled_dot_product_attention``'s
    backward launches at the training shape ``(B, S, H, Hkv, D)``, bf16,
    causal, from one profiled ``autograd.grad`` over a saved forward.
    Called before any of the port's kernels runs: once they have, the
    profiler lists only some of cuDNN's kernels."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    B, S, H, Hkv, D = shape
    q = torch.randn((B, S, H, D), device=dev, dtype=torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, S, Hkv, D), device=dev, dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    dout = torch.randn((B, H, S, D), device=dev, dtype=torch.bfloat16)
    qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(o, (qg, kg, vg), dout)
        torch.cuda.synchronize()
    return sorted({e.key[:120] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def _ell_errors(run, sweep, path) -> dict:
    """Run ``run(vals, cols, n_cols, log1p, out)``, which fills ``out``, on
    the sweep and on the path batch, with and without ``log1p``, into
    outputs filled with NaN (so that an element left unwritten shows),
    against the plain version (followed by ``log1p_``) on the card.  Returns
    the sweep's worst error (a non-finite one as 1e30; the sweep's values
    made non-negative, counts, for ``log1p``), the path batch's by
    epilogue, the number of its elements whose bits differ, and ``ok``:
    the sweep within SWEEP_ATOL and the path batch bitwise."""
    import torch

    from repro_torch.kernels import ref

    def err(got, want) -> float:
        e = (got - want).abs().max().item() if want.numel() else 0.0
        return e if math.isfinite(e) else 1e30

    sweep_err = 0.0
    for vals, cols, G in sweep:
        for log1p in (False, True):
            v = vals.abs() if log1p else vals
            want = ref.ell_to_dense_ref(v, cols, G)
            if log1p:
                want.log1p_()
            out = torch.full(want.shape, math.nan, device=want.device)
            run(v, cols, G, log1p, out)
            sweep_err = max(sweep_err, err(out, want))
    vals, cols, wants = path
    path_err, differ = {}, {}
    for log1p, want in wants.items():
        out = torch.full(want.shape, math.nan, device=want.device)
        run(vals, cols, N_GENES, log1p, out)
        key = "log1p" if log1p else "identity"
        path_err[key] = err(out, want)
        differ[key] = int((out.view(torch.int32) != want.view(torch.int32)).sum())
    return {"sweep_max_abs_err": sweep_err, "path_batch_max_abs_err": path_err,
            "path_batch_elements_differing": differ,
            "ok": sweep_err <= SWEEP_ATOL and not any(differ.values())}


def _ell_mutants(sweep, path) -> dict:
    """Run the unedited tiled kernel and each of ELL_MUTANTS, built by
    :func:`_build_mutants`, through :func:`_ell_errors`."""
    from repro_torch.kernels import csr_to_dense

    libs, out_dir = _build_mutants("ell_to_dense", ELL_MUTANTS, csr_to_dense.bind)
    result = {}
    for name, lib in libs.items():
        def run(v, c, G, log1p, out, lib=lib):
            csr_to_dense.launch(lib, v, c, G, log1p, out=out)
        result[name] = _ell_errors(run, sweep, path)
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def ell_kernel_phase(dev, vals, cols) -> dict:
    """Phase 4: ``ell_to_dense`` on the card at the path batch ``vals``,
    ``cols``; returns its kernels-line entry."""
    import numpy as np
    import torch

    from repro_torch.kernels import csr_to_dense, ref

    rng = np.random.default_rng(0)
    cases = [(rng.normal(0, 1, (R, K)), rng.integers(-1, G, (R, K)), G) for R, K, G in SWEEP]
    cases.append(([[1.0, 2.0, 3.0]], [[4, 4, -1]], 8))  # explicit duplicates
    sweep = [(torch.tensor(np.asarray(v, np.float32), device=dev),
              torch.tensor(np.asarray(c, np.int32), device=dev), G) for v, c, G in cases]
    want = ref.ell_to_dense_ref(vals, cols, N_GENES)
    path = (vals, cols, {False: want, True: want.clone().log1p_()})

    def run_wrapper(v, c, G, log1p, out):
        out.copy_(csr_to_dense.ell_to_dense(v, c, n_cols=G, log1p=log1p))

    def run_previous(v, c, G, log1p, out):
        got = previous_ell_to_dense(v, c, G)
        out.copy_(got.log1p_() if log1p else got)

    errors = _ell_errors(run_wrapper, sweep, path)
    if not errors["ok"]:
        fail(f"ell_to_dense disagrees with its plain version: {errors}")
    previous_errors = _ell_errors(run_previous, sweep, path)
    if not previous_errors["ok"]:
        fail(f"the replaced ell_to_dense kernel disagrees with its plain version: {previous_errors}")
    got, got_fused = (csr_to_dense.ell_to_dense(vals, cols, n_cols=N_GENES, log1p=f)
                      for f in (False, True))
    previous = previous_ell_to_dense(vals, cols, N_GENES)
    if not torch.equal(got, previous):
        fail("ell_to_dense is not bitwise the replaced kernel on a path batch")
    if not torch.equal(got_fused, previous.log1p_()):
        fail("ell_to_dense with log1p is not bitwise the replaced kernel followed by log1p_")
    del got, got_fused, previous
    mutants = _ell_mutants(sweep, path)
    if not mutants["shipped"]["ok"]:
        fail(f"the unedited ell_to_dense built as a mutant fails the check: {mutants['shipped']}")
    passing = [k for k, m in mutants.items() if k != "shipped" and m["ok"]]
    if passing:
        fail(f"mutants of ell_to_dense pass the check: {passing}")

    def fns(v, c) -> dict:
        """The timed functions at the rows of ``v``, ``c``."""
        R = v.shape[0]
        valid = c >= 0
        rows = torch.arange(R, device=dev).unsqueeze(1).expand_as(c)[valid]
        lib_cols, lib_vals = c[valid].long(), v[valid]
        dense = ref.ell_to_dense_ref(v, c, N_GENES)  # log1p_ alone runs on it in place

        def library():
            return torch.zeros((R, N_GENES), device=dev).index_put_(
                (rows, lib_cols), lib_vals, accumulate=True)

        return {
            "kernel": lambda: csr_to_dense.ell_to_dense(v, c, n_cols=N_GENES),
            "fused_log1p": lambda: csr_to_dense.ell_to_dense(v, c, n_cols=N_GENES, log1p=True),
            "previous_kernel": lambda: previous_ell_to_dense(v, c, N_GENES),
            "previous_plus_log1p": lambda: previous_ell_to_dense(v, c, N_GENES).log1p_(),
            "log1p": lambda: dense.log1p_(),
            "library": library,
            "library_plus_log1p": lambda: library().log1p_(),
            "write_floor": lambda: torch.empty((R, N_GENES), device=dev).zero_(),
            "plain": lambda: ref.ell_to_dense_ref(v, c, N_GENES),
        }

    R, K = vals.shape
    by_rows, turns = {}, {}  # the same rows repeated: does the time follow the bytes?
    for n in SWEEP_ROWS:
        v_n = vals.repeat(-(-n // R), 1)[:n].contiguous()
        c_n = cols.repeat(-(-n // R), 1)[:n].contiguous()
        timed = fns(v_n, c_n)
        turns[n] = {k: [] for k in timed}
        for order in (list(timed), list(reversed(timed))):
            for k in order:
                turns[n][k].append(event_ms(timed[k]))
        by_rows[n] = {k: statistics.mean(t) for k, t in turns[n].items()}
        del timed
    if R not in by_rows:
        fail(f"the path batch has {R} rows, not one of SWEEP_ROWS {SWEEP_ROWS}")
    ms = by_rows[R]
    host = host_us({"wrapper": lambda: csr_to_dense.ell_to_dense(vals, cols, n_cols=N_GENES),
                    "previous_wrapper": lambda: previous_ell_to_dense(vals, cols, N_GENES)})
    nnz = int((cols >= 0).sum())
    moved = vals.numel() * 4 + cols.numel() * 4 + R * N_GENES * 4  # each input read, the output written
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, nnz / FP32_FLOP_PER_S * 1e3
    return {"name": "ell_to_dense", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ell_to_dense.cu",
            "replaces": "src/repro/kernels/csr_to_dense.py:53",
            "kernel": "ell_to_dense_tiled_kernel",
            "shape": [R, K, N_GENES], "nnz": nnz,
            "max_abs_err": max(errors["sweep_max_abs_err"],
                               *errors["path_batch_max_abs_err"].values()),
            "errors": errors, "previous_kernel_errors": previous_errors,
            # "ms" and "kernel_ms" name one time: readers of the kernels line expect both
            "ms": ms["kernel"], "kernel_ms": ms["kernel"], "fused_log1p_ms": ms["fused_log1p"],
            "previous_kernel": "ell_to_dense_rowblock_f32 (one block per row: a zero-fill of "
                               "the row in the card's memory, then global atomics)",
            "previous_kernel_ms": ms["previous_kernel"],
            "previous_plus_log1p_ms": ms["previous_plus_log1p"], "log1p_ms": ms["log1p"],
            "plain_ms": ms["plain"], "library": "index_put_ with accumulate",
            "library_ms": ms["library"], "library_plus_log1p_ms": ms["library_plus_log1p"],
            "write_floor_ms": ms["write_floor"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": moved,
            "ms_by_rows": by_rows, "ms_turns_by_rows": turns, "host_us_per_call": host,
            "mutants": mutants}


def _start_data(root: str) -> subprocess.Popen:
    """Start generating phase 3's store (``generate_tahoe_like(root,
    **DATA)``, numpy on one core) in a process of its own; it is ended if
    this script exits before waiting for it."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.data import generate_tahoe_like; "
            "generate_tahoe_like(sys.argv[2], **json.loads(sys.argv[3]))")
    proc = subprocess.Popen([sys.executable, "-c", code, os.path.join(HERE, "src"), root,
                             json.dumps(DATA)], stdout=subprocess.DEVNULL)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def main() -> None:
    import torch

    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the card and has no CPU mode")
    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import generate_tahoe_like, load_tahoe_like
    from repro_torch.kernels import _build, csr_to_dense
    from repro_torch.train import probe

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # Float32 products in full float32 for the whole script, not TF32: the
    # phases that hold the card against the CPU in float32 (step_vs_cpu,
    # lm_vs_cpu, batching, train_vs_cpu, ssm_vs_cpu, ssm_batching) and the
    # scan's float32 dt product in every Mamba phase depend on it.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    max_sm_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "max_sm_clock_mhz": float(max_sm_mhz), "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(torch.cuda.get_device_capability(0))})

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    hopper = {k: v for k, v in _build.ptxas_report("flash_attention").items() if "flash_fwd_hopper" in k}
    if len(hopper) != 3:
        fail(f"ptxas reports {len(hopper)} flash_fwd_hopper kernels, not 3 (head_dim 64, 128 and "
             f"256)")
    spilled = {k: v for k, v in hopper.items()
               if "ILi256E" in k and (v["spill_store_bytes"] or v["spill_load_bytes"])}
    if spilled:
        fail(f"flash_fwd_hopper<256> spills: {spilled}")
    bwd_hopper = {k: v for k, v in _build.ptxas_report("flash_attention_bwd").items()
                  if "flash_bwd_dq_hopper" in k or "flash_bwd_dkv_hopper" in k}
    if len(bwd_hopper) != 6:
        fail(f"ptxas reports {len(bwd_hopper)} Hopper backward kernels, not 6 (dq and dk/dv at "
             f"head_dim 64, 128 and 256)")
    spilled = {k: v for k, v in bwd_hopper.items()
               if "ILi256E" in k and (v["spill_store_bytes"] or v["spill_load_bytes"])}
    if spilled:
        fail(f"the Hopper backward kernels spill at head_dim 256: {spilled}")
    wide = {k: v for k, v in _build.ptxas_report("flash_attention").items() if "ILi256E" in k}
    if len(wide) != 3:
        fail(f"ptxas reports {len(wide)} flash-attention kernels at head_dim 256, not 3 (Hopper, "
             f"bf16 and f32)")
    wide_bwd = {k: v for k, v in _build.ptxas_report("flash_attention_bwd").items() if "ILi256E" in k}
    if len(wide_bwd) != 6:
        fail(f"ptxas reports {len(wide_bwd)} backward kernels at head_dim 256, not 6 (dq and dk/dv "
             f"on the Hopper, bf16 and f32 routes)")
    ell_ptxas = {k: v for k, v in _build.ptxas_report("ell_to_dense").items()
                 if "ell_to_dense_tiled" in k}
    if len(ell_ptxas) != 2:
        fail(f"ptxas reports {len(ell_ptxas)} tiled ell_to_dense kernels, not 2 (identity and "
             f"log1p epilogues)")
    scan_bwd = {k: v for k, v in _build.ptxas_report("ssm_scan_bwd").items()
                if "ssm_scan_bwd_hopper" in k or "ssm_scan_bwd_strided" in k}
    if len(scan_bwd) != 8:
        fail(f"ptxas reports {len(scan_bwd)} scan backward kernels, not 8 (hopper and strided, "
             f"float32 and bf16 at N 4 and 16)")
    spilled = {k: v for k, v in scan_bwd.items()
               if "hopper" in k and "bfloat16" in k and (v["spill_store_bytes"]
                                                          or v["spill_load_bytes"])}
    if spilled:
        fail(f"the scan's hopper backward spills at bf16: {spilled}")
    emit({"phase": "build", "seconds": seconds, "built": built, "ssm_scan_bwd_ptxas": scan_bwd,
          "flash_fwd_hopper_ptxas": hopper,
          "flash_fwd_head_dim_256_ptxas": wide, "flash_bwd_hopper_ptxas": bwd_hopper,
          "flash_bwd_head_dim_256_ptxas": wide_bwd,
          "ell_to_dense_tiled_ptxas": ell_ptxas})

    # before any of the port's kernels runs (see sdpa_backward_kernels)
    sdpa_bwd_kernels = sdpa_backward_kernels(dev, (TRAIN_BATCH, TRAIN_SEQ, *FULL_WIDTH[2:]))
    sdpa_bwd_kernels_256 = sdpa_backward_kernels(dev, (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 256))
    lm_kernel = lm_phases(dev, float(max_sm_mhz) * 1e6)
    torch.cuda.empty_cache()
    train_kernels = train_phases(dev, float(max_sm_mhz) * 1e6, sdpa_bwd_kernels)
    torch.cuda.empty_cache()
    ssm_kernel = ssm_phases(dev, float(max_sm_mhz) * 1e6)
    torch.cuda.empty_cache()

    # 26-28. the other registered configs' serving: the forward at head_dim
    # 256 and 120, three dense configs at full depth, two MoE configs
    seconds = {}
    t0 = time.perf_counter()
    wide_kernels = wide_kernel_phase(dev)
    torch.cuda.empty_cache()
    family_kernels = family_kernel_phase(dev, float(max_sm_mhz) * 1e6)
    torch.cuda.empty_cache()
    seconds["wide_kernels"] = time.perf_counter() - t0
    dense = dense_serve_phase(dev)
    wide_kernels[0]["launches"] = dense["gemma-7b"]["hopper"]
    wide_kernels[1]["launches"] = dense["h2o-danube-3-4b"]["hopper"]
    seconds["dense_serve"] = time.perf_counter() - t0 - sum(seconds.values())
    moe_serve_phase(dev)
    torch.cuda.empty_cache()
    seconds["moe_serve"] = time.perf_counter() - t0 - sum(seconds.values())

    # 29-30. the encdec and vlm families served at full width and depth
    family_kernels[0]["launches"] = encdec_serve_phase(dev)["hopper"]
    torch.cuda.empty_cache()
    seconds["encdec_serve"] = time.perf_counter() - t0 - sum(seconds.values())
    family_kernels[1]["launches"] = vlm_serve_phase(dev)["hopper"]
    torch.cuda.empty_cache()
    seconds["vlm_serve"] = time.perf_counter() - t0 - sum(seconds.values())

    # phase 3's store is generated on one host core while phases 31-36,
    # whose times are the card's, run
    root = os.path.join(HERE, "build", "chip_smoke_data")
    data_t0 = time.perf_counter()
    data_proc = _start_data(root)

    # 31-33. training at head_dim 256 (gemma-7b) and in the MoE family
    #        (mixtral-8x7b): the backward kernels at 256, then both trained
    wide_train = wide_train_kernel_phase(dev, float(max_sm_mhz) * 1e6, sdpa_bwd_kernels_256)
    seconds["wide_train_kernels"] = time.perf_counter() - t0 - sum(seconds.values())
    gemma_launches = gemma_train_phase(dev)
    for key in ("dq", "dkv"):
        wide_train[key]["launches"] = gemma_launches[key]
    seconds["gemma_train"] = time.perf_counter() - t0 - sum(seconds.values())
    moe_train_phase(dev, float(max_sm_mhz) * 1e6)
    torch.cuda.empty_cache()
    seconds["moe_train"] = time.perf_counter() - t0 - sum(seconds.values())

    # 34. remat="dots" against "full" in gemma-7b's training
    dots = remat_dots_phase(dev)
    for key in ("dq", "dkv"):
        wide_train[key]["dots_launches"] = dots[key]
    seconds["remat_dots"] = time.perf_counter() - t0 - sum(seconds.values())

    # 35. the hybrid family: jamba-1.5-large served at 5 of its 72 layers,
    #     plainly and through the model axis
    hybrid, hybrid_scan = hybrid_serve_phase(dev, float(max_sm_mhz) * 1e6, smi)
    family_kernels[2]["launches"] = hybrid["hopper"]
    family_kernels[2]["model_axis_route_launches"] = hybrid["model_axis"]["hopper"]
    hybrid_scan["model_axis_route_launches"] = hybrid["model_axis"]["ssm_scan_hopper"]
    hybrid_scan["launches"] = hybrid["ssm_scan_hopper"]
    torch.cuda.empty_cache()
    seconds["hybrid_serve"] = time.perf_counter() - t0 - sum(seconds.values())

    # 36. training in the ssm and hybrid families: the scan's backward kernel
    ssm_train_kernels = ssm_train_phase(dev, float(max_sm_mhz) * 1e6)
    torch.cuda.empty_cache()
    seconds["ssm_train"] = time.perf_counter() - t0 - sum(seconds.values())

    # 37. the rule-sharded train step (FSDP2 x TP) on a one-rank NCCL mesh
    sharded = sharded_train_phase(dev, smi)
    for entry, key in zip(train_kernels, ("fwd", "dq", "dkv")):
        entry["sharded_launches"] = sharded[key]
    torch.cuda.empty_cache()
    seconds["sharded_train"] = time.perf_counter() - t0 - sum(seconds.values())

    # 38. each rank's slice of the kernels at model sizes 2 and 4
    model_axis = model_axis_kernel_phase(dev, smi)
    family_kernels[2]["model_axis_launches"] = model_axis["jamba_attention"]
    for entry, key in zip(train_kernels, ("fwd", "dq", "dkv")):
        entry["model_axis_launches"] = model_axis[key]
    ssm_train_kernels[0]["model_axis_launches"] = model_axis["scan_bwd"]
    ssm_train_kernels[1]["model_axis_launches"] = model_axis["scan"]
    torch.cuda.empty_cache()
    seconds["model_axis_kernels"] = time.perf_counter() - t0 - sum(seconds.values())
    emit({"phase": "other_configs_seconds", **seconds,
          "script_seconds_so_far": time.perf_counter() - script_t0})

    # 3. data
    t0 = time.perf_counter()
    if data_proc.wait() != 0:
        fail(f"generating the store under {root} exited {data_proc.returncode}")
    generate_tahoe_like(root, **DATA)  # the store just written: its manifest matches
    store = load_tahoe_like(root)
    emit({"phase": "data", "seconds": time.perf_counter() - data_t0,
          "waited_after_phases_31_36_s": time.perf_counter() - t0, "cells": len(store),
          "genes": store.n_var, "plates": len(store.shards),
          "fetches_per_epoch": math.ceil(len(store) / (BATCH * FETCH_FACTOR))})

    def dataset():
        return ScIterableDataset(store, BlockShuffling(BLOCK), batch_size=BATCH,
                                 fetch_factor=FETCH_FACTOR, seed=0)

    # 4. the kernel against its plain version
    batches = dataset().fetch(0, 0)[:3]
    t = batches[0].to_tensors()
    kernel = ell_kernel_phase(dev, t["vals"].to(dev), t["cols"].to(dev))
    emit({"phase": "kernel", **kernel})

    # the same train steps on the card and on the CPU, from the same heads
    gen = torch.Generator().manual_seed(1)
    heads_gpu = probe.init_heads(N_GENES, device=dev, generator=gen)
    heads_cpu = probe.init_heads(N_GENES, device="cpu", generator=torch.Generator().manual_seed(1))
    opt_gpu, opt_cpu = probe.init_adam(heads_gpu), probe.init_adam(heads_cpu)
    step_losses = []
    for b in batches:
        tb = b.to_tensors()
        lc = probe.train_step(heads_cpu, opt_cpu, probe.features(tb["vals"], tb["cols"], n_genes=N_GENES), tb["obs"])
        tg = {"vals": tb["vals"].to(dev), "cols": tb["cols"].to(dev),
              "obs": {k: v.to(dev) for k, v in tb["obs"].items()}}
        lg = probe.train_step(heads_gpu, opt_gpu, probe.features(tg["vals"], tg["cols"], n_genes=N_GENES), tg["obs"])
        step_losses.append((lg.item(), lc.item()))
    for lg, lc in step_losses:
        if not math.isclose(lg, lc, rel_tol=1e-4):
            fail(f"train_step on the card and on the CPU disagree: losses {step_losses}")
    emit({"phase": "step_vs_cpu", "losses_card_cpu": step_losses, "rtol": 1e-4})
    del heads_gpu, heads_cpu, opt_gpu, opt_cpu

    # 5. the main path
    ds = dataset()
    heads = probe.init_heads(N_GENES, device=dev, generator=torch.Generator().manual_seed(0))
    opt = probe.init_adam(heads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    csr_to_dense.ell_to_dense.launches = 0
    run = probe.train_probe(ds, heads, opt, device=dev)
    launches = csr_to_dense.ell_to_dense.launches
    losses = run["losses"]
    steps = run["steps"]
    if steps < MIN_STEPS:
        fail(f"the epoch gave {steps} steps, fewer than {MIN_STEPS}")
    if launches != steps:
        fail(f"ell_to_dense launched {launches} times in {steps} steps")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not last < first:
        fail(f"loss did not fall: first 20 steps {first}, last 20 {last}")
    stream_ms = sorted(run["step_stream_ms"])
    emit({"phase": "main_path", "steps": steps, "batch": BATCH, "fetch_factor": FETCH_FACTOR,
          "block_size": BLOCK, "genes": N_GENES, "cells": len(store),
          "cut": "32,768 cells (two fetches per epoch), not 65,536, to leave time for LM serving",
          "ell_to_dense_launches": launches, "seconds": run["seconds"],
          "samples_per_s": steps * BATCH / run["seconds"],
          "step_ms_mean": run["seconds"] / steps * 1e3,
          "step_stream_ms_median": statistics.median(stream_ms),
          "step_stream_ms_p90": stream_ms[int(0.9 * (len(stream_ms) - 1))],
          "loader_wait_s": run["loader_wait_s"],
          "stream_idle_share": 1 - sum(stream_ms) / 1e3 / run["seconds"],
          "peak_device_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "loss_first20": first, "loss_last20": last})

    # 6. a traced window of the next epoch, after the counts were read:
    #    device kernel time by name (the profiler's own cost is in the wall)
    from torch.profiler import ProfilerActivity, profile

    ds.set_epoch(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = probe.train_probe(ds, heads, opt, device=dev, max_steps=TRACE_STEPS)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        fail("the trace shows no kernel on the card")
    kernel_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    mine = [e for e in on_card if "ell_to_dense" in e.key]
    log1p = [e for e in on_card if "log1p" in e.key.lower() and "ell_to_dense" not in e.key]
    # The launch count is phase 5's: the profiler drops some of the
    # window's ~13,600 kernel records (one step's, seen on the card), so
    # the trace may hold fewer feature kernels than steps.
    if not mine or not all("ell_to_dense_tiled" in e.key for e in mine):
        fail(f"the trace shows {[e.key[:80] for e in mine]} for {traced['steps']} steps")
    if log1p:
        fail(f"the trace shows a separate log1p kernel: {[e.key[:80] for e in log1p]}")
    seen = sum(e.count for e in mine)  # one feature kernel a step
    ms_per_launch = sum(e.self_device_time_total for e in mine) / 1e3 / seen
    emit({"phase": "trace", "steps": traced["steps"], "steps_in_trace": seen,
          "seconds": traced["seconds"], "loader_wait_s": traced["loader_wait_s"],
          "device_kernel_ms": kernel_ms, "device_ms_per_step": kernel_ms / seen,
          "device_busy_share": kernel_ms / 1e3 / traced["seconds"],
          "ell_to_dense": {"kernels": sorted({e.key[:80] for e in mine}), "count": seen,
                           "ms_per_launch": ms_per_launch},
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]})
    kernel["trace_ms_per_launch"] = ms_per_launch

    kernel["launches"] = launches
    del ds, heads, opt
    torch.cuda.empty_cache()

    # 20. the planned storage layer on the cell path
    planned_phase(dev, root, store)
    torch.cuda.empty_cache()

    # 21. the same path from h5ad plate files, with the fetch pool and
    #     DataLoader workers
    h5ad_phase(dev, root, store)
    torch.cuda.empty_cache()

    # 22. the diversity monitor and (b, f) autotune on the cell path
    diversity_phase(dev, root, store)
    torch.cuda.empty_cache()

    # 23. resilient storage on the cell path: faults, cloud requests,
    #     retries, hedged reads and the shard circuit
    resilient_phase(dev, store)
    torch.cuda.empty_cache()

    # 24. tenants of one batch server against the same loaders isolated
    served_phase(dev, root, store)
    torch.cuda.empty_cache()

    # 25. the elastic fabric: a kill and two resizes over one collection
    elastic_phase(dev, root, store)
    torch.cuda.empty_cache()

    # 19. the Fig. 5 experiment
    kernel["fig5_shape"] = fig5_phase(dev)
    ell_keys = (*KERNEL_KEYS, "kernel", "fused_log1p_ms", "previous_kernel", "previous_kernel_ms",
                "previous_plus_log1p_ms", "log1p_ms", "library", "library_plus_log1p_ms",
                "write_floor_ms", "trace_ms_per_launch", "host_us_per_call", "bytes", "fig5_shape")
    emit({"phase": "script_seconds", "seconds": time.perf_counter() - script_t0})
    emit({"kernels": [{k: kernel[k] for k in ell_keys}, lm_kernel, *wide_kernels,
                      *family_kernels, *train_kernels, wide_train["dq"], wide_train["dkv"],
                      ssm_kernel, hybrid_scan, *ssm_train_kernels]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def _largest_differences(got: dict, want: dict, n: int = 5) -> list:
    """The ``n`` tensors of ``got`` furthest from ``want``'s, with their
    largest absolute differences."""
    diffs = [(k, float((got[k].float() - want[k].float()).abs().max())) for k in want]
    return sorted(diffs, key=lambda kv: -kv[1])[:n]


def _traced_step(fn, state, batch) -> dict:
    """One train step under ``torch.profiler``: its wall ms, the device's
    kernel ms and launches, and the five kernels that took the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall * 1e3,
            "device_kernel_ms": sum(e.self_device_time_total for e in on_card) / 1e3,
            "kernel_launches": sum(e.count for e in on_card),
            "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]}


def sharded_train_phase(dev, smi: str) -> dict:
    """Phase 37: the rule-sharded train step on a one-rank NCCL group by its
    two routes, FSDP2 alone on a ("data",) mesh and FSDP2 x TP on a
    ("data", "model") mesh, each from the same weights beside the plain
    step; returns the attention kernels' launches in the FSDP2 x TP run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.nn.parallel import DistributedDataParallel as DDP

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression
    from repro_torch.distributed.fault import reshard_for_mesh
    from repro_torch.distributed.sharding import RULES_TRAIN
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch.train import build_loader
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig, constant_lr
    from repro_torch.train.step import make_train_state, make_train_step, shard_lm, train_state_tree

    root = os.path.join(HERE, "build", "chip_smoke_dist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        mesh_dp = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        cfg = get_config(ARCH)
        model = Model(cfg)
        opt_cfg = AdamWConfig(lr=constant_lr(CPU_STEP_LR), weight_decay=0.01)
        lm = model.init(generator=torch.Generator(device=dev).manual_seed(37), device=dev)
        lm_fsdp = shard_lm(model, copy.deepcopy(lm), mesh_dp)
        lm_sharded = shard_lm(model, copy.deepcopy(lm), mesh)
        loader = build_loader(os.path.join(HERE, "build", "chip_smoke_corpus"), TRAIN_SEQ,
                              TRAIN_BATCH, n_tokens=TRAIN_CORPUS_TOKENS,
                              vocab_size=min(cfg.vocab_size, 1024))
        it = iter(loader)
        batches = []
        for _ in range(SHARDED_STEPS):
            b = next(it)
            batches.append({k: torch.from_numpy(np.asarray(b[k])).to(dev)
                            for k in ("tokens", "labels")})
        loader_state = json.loads(json.dumps(loader.state().to_dict()))  # as a manifest holds it

        def run(params, counted: bool) -> tuple:
            state = make_train_state(model, opt_cfg, params=params)
            fn = make_train_step(model, opt_cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)  # the copies' weights, earlier states
            if counted:
                for entry in (fa.flash_attention_fwd_lse, fab.flash_attention_bwd_dq,
                              fab.flash_attention_bwd_dkv):
                    entry.launches = 0
                fab.flash_attention_bwd_dq.hopper_launches = 0
                fab.flash_attention_bwd_dkv.hopper_launches = 0
                fa.hopper_launches = 0
            metrics, step_ms = [], []
            for b in batches:
                t0 = time.perf_counter()
                state, m = fn(state, b)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
            return state, fn, metrics, step_ms, (torch.cuda.max_memory_allocated(dev), resident)

        plain_state, plain_fn, plain_m, plain_ms, plain_peak = run(lm, False)
        plain_t = train_state_tree(plain_state)
        want = {f"params/{k}": v for k, v in plain_t["params"].items()}
        want.update({f"m/{k}": v for k, v in plain_t["opt"]["m"].items()})
        want.update({f"v/{k}": v for k, v in plain_t["opt"]["v"].items()})
        per_step = {"fwd": 2 * cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}
        routes = {}
        for route, params in (("fsdp2", lm_fsdp), ("fsdp2_tp", lm_sharded)):
            state, fn, metrics, step_ms, peak = run(params, True)
            launches = {"fwd": fa.flash_attention_fwd_lse.launches,
                        "dq": fab.flash_attention_bwd_dq.launches,
                        "dkv": fab.flash_attention_bwd_dkv.launches}
            hopper = {"fwd": fa.hopper_launches, "dq": fab.flash_attention_bwd_dq.hopper_launches,
                      "dkv": fab.flash_attention_bwd_dkv.hopper_launches}
            if launches != {k: n * SHARDED_STEPS for k, n in per_step.items()} or hopper != launches:
                fail(f"the {route} steps launched {launches} attention kernels, {hopper} through "
                     f"the Hopper kernels, in {SHARDED_STEPS} steps; need {per_step} a step, "
                     f"all Hopper")
            if not all(math.isfinite(m["loss"]) for m in metrics):
                fail(f"non-finite {route} losses: {metrics}")

            # against the plain run: bitwise, else within phase 12's rule with
            # the differences printed
            tree = train_state_tree(state)
            flat = {f"params/{k}": v for k, v in tree["params"].items()}
            flat.update({f"m/{k}": v for k, v in tree["opt"]["m"].items()})
            flat.update({f"v/{k}": v for k, v in tree["opt"]["v"].items()})
            bitwise = metrics == plain_m and all(torch.equal(flat[k], want[k]) for k in want)
            result = {"bitwise_equal": bitwise, "tensors_compared": len(want)}
            if not bitwise:
                gnorm_rel = max(abs(m["grad_norm"] / p["grad_norm"] - 1)
                                for m, p in zip(metrics, plain_m))
                share, worst = 1.0, 0.0
                for k in (k for k in want if k.startswith("params/")):
                    d = (flat[k].float() - want[k].float()).abs()
                    share = min(share, float((d <= CPU_PARAM_TOL).float().mean()))
                    worst = max(worst, float(d.max()))
                result.update(largest_differences=_largest_differences(flat, want),
                              grad_norm_rel_err=gnorm_rel, param_min_share_within_tol=share,
                              param_max_abs_err=worst)
                if not (gnorm_rel <= CPU_GNORM_RTOL and share >= CPU_PARAM_SHARE
                        and worst <= 2 * SHARDED_STEPS * CPU_STEP_LR + CPU_PARAM_TOL):
                    fail(f"the {route} and plain steps disagree beyond phase 12's rule: {result}")
            del flat
            routes[route] = {"state": state, "fn": fn, "tree": tree, "metrics": metrics,
                             "step_ms": step_ms, "peak": peak, "launches": launches,
                             "hopper": hopper, "result": result}
        del plain_t, want

        # one more step of each under the profiler (after the counts and the
        # comparisons): the device's kernel time against the wall
        traced = {"plain": _traced_step(plain_fn, plain_state, batches[0])}
        for route, r in routes.items():
            traced[route] = _traced_step(r["fn"], r["state"], batches[0])
        del plain_state
        state, tree = routes["fsdp2_tp"]["state"], routes["fsdp2_tp"]["tree"]

        # the step-3 checkpoint restored onto the mesh
        t0 = time.perf_counter()
        mgr = CheckpointManager(os.path.join(root, "ckpt"))
        mgr.save(state["step"], tree, loader_state=loader_state)
        axes = model.param_axes()
        restored, manifest = reshard_for_mesh(mgr, tree, {"params": axes,
                                                          "opt": {"m": axes, "v": axes}},
                                              mesh, RULES_TRAIN)
        differ = [k for k, v in tree["params"].items()
                  if not torch.equal(restored["params"][k].full_tensor(), v)]
        differ += [f"{mv}/{k}" for mv in ("m", "v") for k, v in tree["opt"][mv].items()
                   if not torch.equal(restored["opt"][mv][k].full_tensor(), v)]
        if differ or manifest["loader_state"] != loader_state or int(restored["step"]) != 3:
            fail(f"the re-meshed checkpoint differs in {differ[:8]} or its loader state "
                 f"{manifest['loader_state']} is not {loader_state}")
        remesh_s = time.perf_counter() - t0
        del restored, tree, state, lm, lm_sharded, lm_fsdp
        for r in routes.values():
            del r["state"], r["fn"], r["tree"]

        # the int8 error-feedback hook under DDP on the group, two steps
        gen = torch.Generator(device=dev).manual_seed(11)
        lin = torch.nn.Linear(HOOK_SHAPE[1], HOOK_SHAPE[0], bias=False, device=dev)
        ddp = DDP(lin, device_ids=[dev.index])
        hook_state = compression.EFInt8State()
        ddp.register_comm_hook(hook_state, compression.ef_int8_hook)
        resid = None
        for step in range(2):
            g = torch.randn(HOOK_SHAPE, generator=gen, device=dev)
            ddp.zero_grad(set_to_none=True)
            (ddp(torch.eye(HOOK_SHAPE[1], device=dev)) * g.T).sum().backward()
            q, sc, resid = compression.quantize_ef(g.reshape(-1), resid)
            want_g = compression.dequantize(q, sc, (g.numel(),), torch.float32).reshape(HOOK_SHAPE)
            if not torch.equal(ddp.module.weight.grad, want_g):
                fail(f"the DDP hook's gradient at step {step} is not quantize_ef / dequantize's")
        if not torch.equal(hook_state.residuals.get(0, torch.empty(0)), resid):
            fail("the DDP hook's residual is not quantize_ef's")
        del ddp, lin
    finally:
        dist.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)
    tp_run, dp_run = routes["fsdp2_tp"], routes["fsdp2"]
    emit({"phase": "sharded_train", "arch": ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.compute_dtype, "remat": cfg.remat,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": SHARDED_STEPS,
          "backend": "nccl", "nvidia_smi": smi,
          "routes": {"fsdp2": {"mesh": {"data": 1}, "route": "FSDP2 over 'data' alone "
                               "(shard_lm on a ('data',) mesh)"},
                     "fsdp2_tp": {"mesh": {"data": 1, "model": 1},
                                  "route": "FSDP2 over 'data' x TP placements on 'model' "
                                           "(shard_lm on a 2-D mesh)"}},
          "sharded_step_ms": tp_run["step_ms"], "fsdp2_step_ms": dp_run["step_ms"],
          "plain_step_ms": plain_ms,
          "sharded_peak_device_mem_gb": tp_run["peak"][0] / 1e9,
          "fsdp2_peak_device_mem_gb": dp_run["peak"][0] / 1e9,
          "plain_peak_device_mem_gb": plain_peak[0] / 1e9,
          "sharded_resident_at_start_gb": tp_run["peak"][1] / 1e9,
          "fsdp2_resident_at_start_gb": dp_run["peak"][1] / 1e9,
          "plain_resident_at_start_gb": plain_peak[1] / 1e9,
          "traced_step": traced,
          "losses": [m["loss"] for m in tp_run["metrics"]],
          "fsdp2_losses": [m["loss"] for m in dp_run["metrics"]],
          "plain_losses": [m["loss"] for m in plain_m],
          "grad_norms": [m["grad_norm"] for m in tp_run["metrics"]],
          "launches": tp_run["launches"], "hopper_launches": tp_run["hopper"],
          "fsdp2_launches": dp_run["launches"], "fsdp2_hopper_launches": dp_run["hopper"],
          **tp_run["result"], "fsdp2": dp_run["result"],
          "remesh_bitwise": True, "remesh_s": remesh_s, "ddp_hook_bitwise": True,
          "seconds": time.perf_counter() - t_phase})
    return tp_run["launches"]


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")


def _greedy_standalone(model, lm, prompt, max_new: int, max_len: int, dev):
    """Greedy continuation of one prompt at batch 1, and each step's logits."""
    import torch

    cache = model.init_cache(1, max_len, device=dev)
    tokens = torch.as_tensor(prompt[None], dtype=torch.int64, device=dev)
    logits, cache = model.prefill(lm, {"tokens": tokens}, cache)
    toks, lgs = [int(logits[0].argmax())], [logits[0].float().cpu()]
    while len(toks) < max_new:
        logits, cache = model.decode(lm, torch.tensor([toks[-1]], device=dev), cache,
                                     len(prompt) + len(toks) - 1)
        toks.append(int(logits[0].argmax()))
        lgs.append(logits[0].float().cpu())
    return toks, lgs


def _tie_diverged(got, want, lgs, tie: float):
    """None if ``got`` equals ``want``; else the first step where they
    differ, with the gap between the two tokens' logits there, which must
    be under ``tie`` (after an exact tie the rest is not compared)."""
    for j, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = abs(float(lgs[j][g]) - float(lgs[j][w]))
            if not gap < tie:
                fail(f"greedy tokens differ at step {j} ({g} vs {w}) with a logit gap {gap} >= {tie}")
            return {"step": j, "gap": gap}
    if len(got) != len(want):
        fail(f"sequences of {len(got)} and {len(want)} tokens")
    return None


def lm_phases(dev, sm_clock_hz: float) -> dict:
    """Phases 7-10, LM serving at smollm-360m's full width; returns the
    kernels-line entry of ``flash_attention``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Model
    from repro_torch.serve.scheduler import SlotBatcher

    cfg = get_config(ARCH)
    if (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim) != FULL_WIDTH:
        fail(f"{ARCH} is not at its published width: {cfg}")

    # 7. the kernel against its plain version
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for B, H, Hkv, S, T, D in FA_SWEEP:
            q = torch.randn((B, H, S, D), generator=gen).to(dev, dtype)
            k = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            v = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            for causal, window in FA_MASKS:
                got = fa.flash_attention(q, k, v, causal=causal, window=window)
                want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
                worst = max(worst, (got.float() - want.float()).abs().max().item())
        q = torch.randn((1, 2, 8, 32), generator=gen).to(dev, dtype)
        k = torch.randn((1, 2, 256, 32), generator=gen).to(dev, dtype)
        v = torch.randn((1, 2, 256, 32), generator=gen).to(dev, dtype)
        got = fa.flash_attention(q, k, v, causal=True, q_offset=200)
        want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=200)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        name = str(dtype).removeprefix("torch.")
        errs[name] = worst
        if not worst <= FA_ATOL[name]:
            fail(f"flash_attention disagrees with its plain version in {name}: {worst} > {FA_ATOL[name]}")

    # the prefill's shape, as the strided (B, S, H, D) views the model passes
    B, S, H, Hkv, D = SERVE_BATCH, SERVE_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qs = torch.randn((B, S, H, D), generator=gen).to(dev, torch.bfloat16)
    ks = torch.randn((B, S, Hkv, D), generator=gen).to(dev, torch.bfloat16)
    vs = torch.randn((B, S, Hkv, D), generator=gen).to(dev, torch.bfloat16)
    q, k, v = qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)
    hopper_before = fa.hopper_launches
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    if fa.hopper_launches != hopper_before + 1:
        fail(f"the prefill shape took the {fa.route(q, k, v)} kernel, not the Hopper one")
    path_err = (got.float() - want.float()).abs().max().item()
    if not path_err <= FA_ATOL["bfloat16"]:
        fail(f"flash_attention disagrees with its plain version at the prefill shape: {path_err}")
    kernel_ms = event_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    previous_out, _ = previous_kernel(q, k, v, False)
    previous_err = (previous_out.float() - want.float()).abs().max().item()
    if not previous_err <= FA_ATOL["bfloat16"]:
        fail(f"the mma.sync forward disagrees with its plain version at the prefill shape: {previous_err}")
    mma_sync_ms = event_ms(lambda: previous_kernel(q, k, v, False))
    host = host_us({"hopper_wrapper": lambda: fa.flash_attention(q, k, v, causal=True),
                    "previous_wrapper": lambda: previous_kernel(q, k, v, False)})
    plain_ms = event_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    library_ms = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                   enable_gqa=True))
    pairs = S * (S + 1) // 2  # (query, key) pairs the causal mask keeps, per head
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v read; o written
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * B * H * D * pairs / BF16_FLOP_PER_S * 1e3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_ms = B * H * pairs / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3  # one per pair
    kernel = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:86",
              "kernel": "flash_fwd_hopper", "previous_kernel": "flash_fwd_bf16 (mma.sync)",
              "previous_kernel_ms": mma_sync_ms, "host_us_per_call": host,
              "shape": [B, H, Hkv, S, S, D], "dtype": "bfloat16",
              "max_abs_err": max(path_err, *errs.values()), "sweep_max_abs_err": errs,
              "path_shape_max_abs_err": path_err,
              "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "scaled_dot_product_attention",
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "bound_parts_ms": {"bytes": bytes_ms, "tensor_cores": ops_ms, "exponentials": exp_ms},
              "bytes": moved, "flop": 4 * B * H * D * pairs}
    emit({"phase": "flash_kernel", **kernel})
    del q, k, v, qs, ks, vs, got, want, previous_out

    # 8. the card against the CPU at full width in float32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model32 = Model(cfg32)
    lm_cpu = model32.init(generator=torch.Generator().manual_seed(1), device="cpu")
    lm32 = copy.deepcopy(lm_cpu).to(dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CPU_PROMPT)))
    max_len = CPU_PROMPT + CPU_DECODE
    caches = {"cpu": model32.init_cache(1, max_len, device="cpu"),
              "card": model32.init_cache(1, max_len, device=dev)}
    want, _ = model32.prefill(lm_cpu, {"tokens": prompt}, caches["cpu"])
    got, _ = model32.prefill(lm32, {"tokens": prompt.to(dev)}, caches["card"])
    steps = [(got.cpu(), want)]
    tok = want.argmax(-1)  # both sides decode the CPU's greedy tokens
    for i in range(CPU_DECODE):
        want, _ = model32.decode(lm_cpu, tok, caches["cpu"], CPU_PROMPT + i)
        got, _ = model32.decode(lm32, tok.to(dev), caches["card"], CPU_PROMPT + i)
        steps.append((got.cpu(), want))
        tok = want.argmax(-1)
    cpu_err, ties = 0.0, 0
    for g, w in steps:
        if not bool(torch.isfinite(g).all()):
            fail("non-finite logits on the card")
        if not torch.allclose(g, w, rtol=CPU_RTOL, atol=CPU_ATOL):
            fail(f"card and CPU logits disagree: max err {(g - w).abs().max().item()}")
        cpu_err = max(cpu_err, (g - w).abs().max().item())
        gt, wt = int(g[0].argmax()), int(w[0].argmax())
        if gt != wt:
            if not abs(float(w[0, gt]) - float(w[0, wt])) < TIE_F32:
                fail(f"greedy tokens differ off a tie: card {gt}, CPU {wt}")
            ties += 1
    emit({"phase": "lm_vs_cpu", "arch": ARCH, "layers": cfg.num_layers, "dtype": "float32",
          "prompt": CPU_PROMPT, "decode_steps": CPU_DECODE, "max_abs_err": cpu_err,
          "max_abs_logit": max(w.abs().max().item() for _, w in steps),
          "rtol": CPU_RTOL, "atol": CPU_ATOL, "greedy_ties": ties})
    del lm_cpu, caches

    # 9. the main path: serve_batch at full width in bf16
    model = Model(cfg)
    params = model.init(generator=torch.Generator().manual_seed(0), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    # a warm-up serve at the same shapes: the caching allocator's first
    # cudaMallocs and cuBLAS's first choice of algorithms stay out of the times
    serve_batch(model, prompts, SERVE_GEN, params=params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    fa.flash_attention.launches = 0
    fa.hopper_launches = 0
    toks = serve_batch(model, prompts, SERVE_GEN, params=params, device=dev, timings=timings)
    launches, hopper = fa.flash_attention.launches, fa.hopper_launches
    if launches != cfg.num_layers:
        fail(f"flash_attention launched {launches} times in one prefill of {cfg.num_layers} layers")
    if hopper != launches:
        fail(f"{hopper} of the prefill's {launches} attention launches took the Hopper kernel")
    if toks.shape != (SERVE_BATCH, SERVE_GEN) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"serve_batch gave tokens of shape {toks.shape} outside the vocabulary")
    peak = torch.cuda.max_memory_allocated(dev)
    decode_ms = timings["decode_s"] / timings["decode_steps"] * 1e3

    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, device=dev)
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(params, batch, cache)
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in on_card if "flash_fwd" in e.key]
    if not mine:
        fail("the trace shows no flash_attention kernel on the card")
    prefill_kernel_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    fa_ms = sum(e.self_device_time_total for e in mine) / 1e3
    fa_n = sum(e.count for e in mine)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    turns = decode_ms_with_and_without_block(
        params, torch.from_numpy(toks[:, -1].astype(np.int64)).to(dev), cache, SERVE_PROMPT)
    emit({"phase": "serve", "arch": ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "dtype": cfg.compute_dtype, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
          "gen": SERVE_GEN, "prefill_ms": timings["prefill_s"] * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": SERVE_BATCH * timings["decode_steps"] / timings["decode_s"],
          "peak_device_mem_gb": peak / 1e9, "flash_attention_launches": launches,
          "hopper_launches": hopper,
          "prefills": 1, "traced_prefill_device_kernel_ms": prefill_kernel_ms,
          "flash_attention_trace": {"count": fa_n, "device_ms": fa_ms, "ms_per_launch": fa_ms / fa_n,
                                    "share_of_prefill_kernel_time": fa_ms / prefill_kernel_ms},
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
          "decode_ms_with_and_without_tf32_block": turns})
    kernel["launches"] = launches
    kernel["hopper_launches"] = hopper
    kernel["trace_ms_per_launch"] = fa_ms / fa_n
    del params, cache

    # 10. continuous batching at full width in float32
    brng = np.random.default_rng(0)
    lens = brng.integers(BATCH_PROMPT_LENS[0], BATCH_PROMPT_LENS[1] + 1, BATCH_REQUESTS)
    max_new = brng.integers(BATCH_NEW[0], BATCH_NEW[1] + 1, BATCH_REQUESTS)
    prompts = [brng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    batcher = SlotBatcher(model32, lm32, batch_slots=BATCH_SLOTS, max_len=BATCH_MAX_LEN)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, int(m))
    t0 = time.perf_counter()
    done = batcher.run()
    batch_s = time.perf_counter() - t0
    if [r.rid for r in done] != list(range(BATCH_REQUESTS)) or not all(r.done for r in done):
        fail(f"the batcher completed {[r.rid for r in done]}")
    diverged = []
    for req, p, m in zip(done, prompts, max_new):
        want, lgs = _greedy_standalone(model32, lm32, p, int(m), BATCH_MAX_LEN, dev)
        tie = _tie_diverged(req.out, want, lgs, TIE_F32)
        if tie is not None:
            diverged.append({"rid": req.rid, **tie})
    emit({"phase": "batching", "dtype": "float32", "slots": BATCH_SLOTS,
          "requests": BATCH_REQUESTS, "max_len": BATCH_MAX_LEN,
          "prompt_lens": lens.tolist(), "max_new": max_new.tolist(),
          "tokens": int(sum(len(r.out) for r in done)), "cursor_end": batcher.pos,
          "seconds": batch_s, "ties": diverged})
    del lm32, batcher
    return {k: kernel[k] for k in (*KERNEL_KEYS, "dtype", "library", "trace_ms_per_launch",
                                     "kernel", "hopper_launches", "previous_kernel",
                                     "previous_kernel_ms", "host_us_per_call", "bound_parts_ms")}


def _scaled_err(got, want, atol: float, rtol: float) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (atol + rtol |want|)): the
    second is at most 1 within the tolerance."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d / (atol + rtol * want.float().abs())).max().item()


def _rms_err(got, want) -> tuple[float, float, float]:
    """(max |got - want|, the same over the training shape's tolerance,
    rms(want)); the second is at most 1 within the tolerance."""
    want = want.float()
    rms = want.square().mean().sqrt().item()
    return _scaled_err(got, want, TRAIN_TOL_RMS * rms, TRAIN_TOL_REL) + (rms,)


def attention_errors(q, k, v, dout, causal, window, err):
    """The training attention kernels (forward with lse, dq, dk/dv) against
    their plain versions on these inputs: ``err(got, want)`` of the forward's
    out, dq and the worse of dk and dv (the one with the larger second
    item), and (max, max / 1e-4) of lse.  Returns ``(errors, outputs)``."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref

    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal, window=window)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq = fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal, window=window)
    dk, dv = fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal, window=window)
    w_out, w_lse = ref.flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window)
    wq, wk, wv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                             window=window)
    torch.cuda.synchronize()
    errs = {"fwd": err(out, w_out), "lse": _scaled_err(lse, w_lse, 1e-4, 0.0),
            "dq": err(dq, wq), "dkv": max(err(dk, wk), err(dv, wv), key=lambda e: e[1])}
    return errs, (out, lse, delta)


def train_phases(dev, sm_clock_hz: float, sdpa_bwd_kernels: list) -> list:
    """Phases 11-14, LM training at smollm-360m's full width; returns the
    kernels-line entries of the forward with lse, dq and dk/dv.
    ``sdpa_bwd_kernels``: the names :func:`sdpa_backward_kernels` found,
    printed in phase 11."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import run_with_restarts
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    from repro_torch.launch.train import build_loader, train_loop
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig, constant_lr
    from repro_torch.train.step import make_train_state, make_train_step

    cfg = get_config(ARCH)

    # 11. the three kernels against their plain versions
    gen = torch.Generator().manual_seed(3)
    worst = {}  # (kernel, dtype) -> (abs, scaled)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for B, H, Hkv, S, T, D in BWD_SWEEP:
            q = torch.randn((B, H, S, D), generator=gen).to(dev, dtype)
            k = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            v = torch.randn((B, Hkv, T, D), generator=gen).to(dev, dtype)
            dout = torch.randn((B, H, S, D), generator=gen).to(dev, dtype)
            for causal, window in BWD_MASKS:
                errs, _ = attention_errors(q, k, v, dout, causal, window,
                                           lambda g, w: _scaled_err(g, w, *BWD_TOL[name]))
                for kern, e in errs.items():
                    old = worst.get((kern, name), (0.0, 0.0))
                    worst[(kern, name)] = (max(old[0], e[0]), max(old[1], e[1]))
    bad = {f"{k}/{n}": e for (k, n), e in worst.items() if not e[1] <= 1.0}
    if bad:
        fail(f"training attention kernels disagree with their plain versions on the sweep: {bad}")

    B, S, H, Hkv, D = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf = torch.bfloat16
    qs = torch.randn((B, S, H, D), generator=gen).to(dev, bf)
    ks = torch.randn((B, S, Hkv, D), generator=gen).to(dev, bf)
    vs = torch.randn((B, S, Hkv, D), generator=gen).to(dev, bf)
    q, k, v = qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)
    dout = torch.randn((B, H, S, D), generator=gen).to(dev, bf)
    hopper_before = (fa.hopper_launches, fab.hopper_launches)
    path, (out, lse, delta) = attention_errors(q, k, v, dout, True, None, _rms_err)
    if fa.hopper_launches != hopper_before[0] + 1:
        fail(f"the training shape's forward took the {fa.route(q, k, v)} kernel, not the Hopper one")
    if fab.hopper_launches != hopper_before[1] + 2:
        fail(f"the training shape's backward took the {fab.route(q, k, v, dout)} kernels, not the "
             f"Hopper ones")
    if not all(e[1] <= 1.0 for e in path.values()):
        fail(f"training attention kernels disagree with their plain versions at the training shape: {path}")
    path_sweep_tol, _ = attention_errors(q, k, v, dout, True, None,
                                         lambda g, w: _scaled_err(g, w, *BWD_TOL["bfloat16"]))
    if not all(e[1] <= 1.0 for e in path_sweep_tol.values()):
        fail(f"training attention kernels exceed the sweep's bf16 tolerance at the training shape: "
             f"{path_sweep_tol}")
    mutants = _flash_mutants(q, k, v, *ref.flash_attention_fwd_lse_ref(q, k, v, causal=True))
    failing = {n: max(e["out"][1], e["lse"][1]) for n, e in mutants.items()}
    weak = {n: r for n, r in failing.items() if n != "shipped" and r < FLASH_MUTANT_MIN}
    if weak:
        fail(f"mutants of the Hopper forward pass the rule with less than {FLASH_MUTANT_MIN}x: {weak}")
    if failing["shipped"] > 1.0:
        fail(f"the unedited Hopper forward built as a mutant fails the rule: {mutants['shipped']}")
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    bwd_mutants = _bwd_mutants(q, k, v, dout, lse, delta, wants)
    bwd_failing = {n: max(e[1] for e in errs.values()) for n, errs in bwd_mutants.items()}
    weak = {n: r for n, r in bwd_failing.items() if n != "shipped" and not r >= FLASH_MUTANT_MIN}
    if weak:
        fail(f"mutants of the Hopper backward pass the rule with less than {FLASH_MUTANT_MIN}x: {weak}")
    if not bwd_failing["shipped"] <= 1.0:
        fail(f"the unedited Hopper backward built as a mutant fails the rule: {bwd_mutants['shipped']}")
    # the mma.sync backward kernels the Hopper route replaced, held to the same rule
    (prev_dq,), (prev_dk, prev_dv) = (previous_bwd(q, k, v, dout, lse, delta, d) for d in (False, True))
    torch.cuda.synchronize()
    prev_err = {n: _rms_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), (prev_dq, prev_dk, prev_dv),
                                                     wants)}
    if not all(e[1] <= 1.0 for e in prev_err.values()):
        fail(f"the mma.sync backward kernels disagree with their plain version: {prev_err}")
    del wants, prev_dq, prev_dk, prev_dv
    times = {
        "fwd": event_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True)),
        "dq": event_ms(lambda: fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta)),
        "dkv": event_ms(lambda: fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta)),
    }
    previous_ms = {
        "fwd": event_ms(lambda: previous_kernel(q, k, v, True)),
        "dq": event_ms(lambda: previous_bwd(q, k, v, dout, lse, delta, False)),
        "dkv": event_ms(lambda: previous_bwd(q, k, v, dout, lse, delta, True)),
    }
    host = host_us({"fwd/hopper_wrapper": lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True),
                    "fwd/previous_wrapper": lambda: previous_kernel(q, k, v, True),
                    "dq/hopper_wrapper": lambda: fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta),
                    "dq/previous_wrapper": lambda: previous_bwd(q, k, v, dout, lse, delta, False),
                    "dkv/hopper_wrapper": lambda: fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta),
                    "dkv/previous_wrapper": lambda: previous_bwd(q, k, v, dout, lse, delta, True)})
    plain = {
        "fwd": event_ms(lambda: ref.flash_attention_fwd_lse_ref(q, k, v, causal=True)),
        "bwd": event_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True)),
    }
    with torch.no_grad():
        sdpa_fwd_ms = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                      enable_gqa=True))
    # SDPA's backward alone: autograd.grad over one saved forward, its graph kept
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)

    def sdpa_bwd():
        torch.autograd.grad(o_sdpa, (qg, kg, vg), dout, retain_graph=True)

    sdpa_bwd_ms = event_ms(sdpa_bwd)
    del qg, kg, vg, o_sdpa

    pairs = S * (S + 1) // 2
    work = _attention_work(B, H, Hkv, S, D, pairs)
    src = "src/repro_torch/kernels/csrc/"
    sdpa_bwd_name = "scaled_dot_product_attention backward alone (dq, dk and dv in one call)"
    meta = {
        "fwd": ("flash_attention_fwd_lse", src + "flash_attention.cu",
                "src/repro/kernels/flash_attention_bwd.py:164", plain["fwd"], sdpa_fwd_ms,
                "scaled_dot_product_attention forward"),
        "dq": ("flash_attention_bwd_dq", src + "flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention_bwd.py:81", plain["bwd"], sdpa_bwd_ms,
               sdpa_bwd_name),
        "dkv": ("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention_bwd.py:115", plain["bwd"], sdpa_bwd_ms,
                sdpa_bwd_name),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_ms = B * H * pairs / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3  # one per visible pair
    hopper_kernel = {"fwd": ("flash_fwd_hopper", "flash_fwd_bf16 (mma.sync)", failing),
                     "dq": ("flash_bwd_dq_hopper", "dq_bf16 (mma.sync)", bwd_failing),
                     "dkv": ("flash_bwd_dkv_hopper", "dkv_bf16 (mma.sync)", bwd_failing)}
    kernels = {}
    for key, (name, source, replaces, plain_ms, lib_ms, lib) in meta.items():
        nbytes, flop = work[key]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flop / BF16_FLOP_PER_S * 1e3
        err = max(worst[(key, "float32")][0], worst[(key, "bfloat16")][0], path[key][0])
        if key == "fwd":
            err = max(err, worst[("lse", "float32")][0], worst[("lse", "bfloat16")][0], path["lse"][0])
        kernels[key] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": [B, H, Hkv, S, S, D], "dtype": "bfloat16", "max_abs_err": err,
            "ms": times[key], "kernel_ms": times[key], "plain_ms": plain_ms,
            "plain": "flash_attention_bwd_ref (dq, dk and dv in one call)" if key != "fwd"
            else "flash_attention_fwd_lse_ref",
            "library_ms": lib_ms, "library": lib,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes,
            "flop": flop, "want_rms": path[key][2],
            "kernel": hopper_kernel[key][0], "previous_kernel": hopper_kernel[key][1],
            "previous_kernel_ms": previous_ms[key],
            "host_us_per_call": {w: host[f"{key}/{w}"] for w in ("hopper_wrapper", "previous_wrapper")},
            "mutant_err_of_rule": hopper_kernel[key][2],
            "bound_parts_ms": {"bytes": bytes_ms, "tensor_cores": ops_ms, "exponentials": exp_ms}}
    kernels["dq"]["previous_kernel_err"] = prev_err["dq"]
    kernels["dkv"]["previous_kernel_err"] = max(prev_err["dk"], prev_err["dv"], key=lambda e: e[1])
    emit({"phase": "train_kernels", "sweep_errors": {f"{k}/{n}": e for (k, n), e in worst.items()},
          "training_shape_errors": path, "training_shape_errors_of_sweep_tol": path_sweep_tol,
          "tolerance": BWD_TOL,
          "training_shape_tolerance": {"rms": TRAIN_TOL_RMS, "rel": TRAIN_TOL_REL},
          "kernels_sum_ms": sum(times.values()), "bwd_pair_ms": times["dq"] + times["dkv"],
          "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
          "sdpa_bwd_kernels": sdpa_bwd_kernels,
          "previous_kernel_ms": previous_ms, "previous_bwd_errors": prev_err,
          "host_us_per_call": host,
          "mutants": mutants, "bwd_mutants": bwd_mutants,
          # the least error over the rule among the edited copies, and what each must reach
          "mutant_min_err_of_rule": min(r for n, r in failing.items() if n != "shipped"),
          "bwd_mutant_min_err_of_rule": min(r for n, r in bwd_failing.items() if n != "shipped"),
          "mutant_min_required": FLASH_MUTANT_MIN,
          **{f"{k}_ms": t for k, t in times.items()},
          **{f"{k}_bound_ms": kernels[k]["bound_ms"] for k in kernels},
          **{f"plain_{k}_ms": t for k, t in plain.items()}})
    del q, k, v, qs, ks, vs, dout, out, lse, delta

    # 12. one float32 train step at full width on the card and on the CPU
    cfg32 = dataclasses.replace(cfg, num_layers=CPU_STEP_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32)
    opt_cfg = AdamWConfig(lr=constant_lr(CPU_STEP_LR), weight_decay=0.01)
    lm_cpu = model32.init(generator=torch.Generator().manual_seed(2), device="cpu")
    lm_gpu = copy.deepcopy(lm_cpu).to(dev)
    seq = np.random.default_rng(1).integers(0, cfg.vocab_size, (CPU_STEP_BATCH, CPU_STEP_SEQ + 1))
    batch = {"tokens": torch.from_numpy(seq[:, :-1]), "labels": torch.from_numpy(seq[:, 1:])}
    states = {"cpu": make_train_state(model32, opt_cfg, params=lm_cpu),
              "card": make_train_state(model32, opt_cfg, params=lm_gpu)}
    before = {n: p.detach().clone() for n, p in lm_cpu.named_parameters()}
    step_fn = make_train_step(model32, opt_cfg)
    _, m_cpu = step_fn(states["cpu"], batch)
    _, m_gpu = step_fn(states["card"], {k: t.to(dev) for k, t in batch.items()})
    loss_rel = abs(float(m_gpu["loss"]) / float(m_cpu["loss"]) - 1)
    gnorm_rel = abs(float(m_gpu["grad_norm"]) / float(m_cpu["grad_norm"]) - 1)
    if not (loss_rel <= CPU_LOSS_RTOL and gnorm_rel <= CPU_GNORM_RTOL):
        fail(f"a train step on the card and on the CPU disagree: loss {float(m_gpu['loss'])} vs "
             f"{float(m_cpu['loss'])}, grad norm {float(m_gpu['grad_norm'])} vs {float(m_cpu['grad_norm'])}")
    gpu_params = dict(lm_gpu.named_parameters())
    share, worst_p, moved = 1.0, 0.0, 0.0
    for n, p in lm_cpu.named_parameters():
        d = (gpu_params[n].detach().cpu() - p.detach()).abs()
        share = min(share, float((d <= CPU_PARAM_TOL).float().mean()))
        worst_p = max(worst_p, float(d.max()))
        moved = max(moved, float((p.detach() - before[n]).abs().max()))
    if not (share >= CPU_PARAM_SHARE and worst_p <= 2 * CPU_STEP_LR + CPU_PARAM_TOL):
        fail(f"updated parameters on the card and the CPU disagree: {share} of a tensor within "
             f"{CPU_PARAM_TOL}, max err {worst_p}")
    emit({"phase": "train_vs_cpu", "layers": CPU_STEP_LAYERS, "dtype": "float32",
          "batch": [CPU_STEP_BATCH, CPU_STEP_SEQ], "loss_card": float(m_gpu["loss"]),
          "loss_cpu": float(m_cpu["loss"]), "loss_rel_err": loss_rel,
          "grad_norm_card": float(m_gpu["grad_norm"]), "grad_norm_cpu": float(m_cpu["grad_norm"]),
          "grad_norm_rel_err": gnorm_rel, "param_min_share_within_tol": share,
          "param_max_abs_err": worst_p, "param_max_update": moved})
    del lm_cpu, lm_gpu, states, gpu_params, before

    # 13. the main path: main's build_loader and train_loop at full width and depth
    model = Model(cfg)
    corpus = os.path.join(HERE, "build", "chip_smoke_corpus")
    t0 = time.perf_counter()
    loader = build_loader(corpus, TRAIN_SEQ, TRAIN_BATCH, n_tokens=TRAIN_CORPUS_TOKENS,
                          vocab_size=min(cfg.vocab_size, 1024))
    corpus_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    fa.flash_attention_fwd_lse.launches = 0
    fab.flash_attention_bwd_dq.launches = 0
    fab.flash_attention_bwd_dkv.launches = 0
    fab.flash_attention_bwd_dq.hopper_launches = 0
    fab.flash_attention_bwd_dkv.hopper_launches = 0
    fa.hopper_launches = 0
    fab.hopper_launches = 0
    total = TRAIN_WARMUP + TRAIN_STEPS
    t0 = time.perf_counter()
    run = train_loop(model, loader, steps=total, log_every=1, device=dev, timings=timings)
    wall = time.perf_counter() - t0
    launches = {"fwd": fa.flash_attention_fwd_lse.launches,
                "dq": fab.flash_attention_bwd_dq.launches,
                "dkv": fab.flash_attention_bwd_dkv.launches}
    per_step = {"fwd": 2 * cfg.num_layers, "dq": cfg.num_layers, "dkv": cfg.num_layers}
    if launches != {k: n * total for k, n in per_step.items()}:
        fail(f"the training kernels launched {launches} times in {total} steps; "
             f"need {per_step} per step")
    hopper = fa.hopper_launches
    if hopper != launches["fwd"]:
        fail(f"{hopper} of the {launches['fwd']} training forwards took the Hopper kernel")
    hopper_bwd = {"dq": fab.flash_attention_bwd_dq.hopper_launches,
                  "dkv": fab.flash_attention_bwd_dkv.hopper_launches}
    for key, n in hopper_bwd.items():
        if n != launches[key]:
            fail(f"{n} of the {launches[key]} {key} launches took the Hopper kernel")
    bwd_hopper = fab.hopper_launches
    if bwd_hopper != sum(hopper_bwd.values()):
        fail(f"the module counts {bwd_hopper} Hopper backward launches, its entry points "
             f"{hopper_bwd}")
    losses = [m["loss"] for m in run["metrics"]]
    if len(losses) != total or not all(math.isfinite(x) for x in losses):
        fail(f"non-finite or missing losses: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} at the first step, {losses[-1]} at the last")
    step_s = timings["step_s"]
    timed = sorted(step_s[TRAIN_WARMUP:])
    med = statistics.median(timed)
    # the timed steps' wall, loader included: end of the last warm-up step
    # to the end of the last step
    timed_wall = timings["end"][-1] - timings["end"][TRAIN_WARMUP - 1]
    fetch_share = sum(timings["fetch_s"][TRAIN_WARMUP:]) / timed_wall
    peak = torch.cuda.max_memory_allocated(dev)

    # one more step under the profiler (the counts were read above)
    step_fn = make_train_step(model, AdamWConfig(lr=constant_lr(3e-4), weight_decay=0.01))
    tb = {k: torch.from_numpy(np.asarray(next(iter(loader))[k])).to(dev) for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(run["final_state"], tb)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    step_kernel_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    trace = {}
    for key, pat in (("fwd", "flash_fwd_hopper"), ("dq", "flash_bwd_dq_hopper"),
                     ("dkv", "flash_bwd_dkv_hopper")):
        mine = [e for e in on_card if pat in e.key]
        n = sum(e.count for e in mine)
        if n != per_step[key]:
            fail(f"the traced step shows {n} launches of {pat}, not {per_step[key]}")
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        trace[key] = {"count": n, "device_ms": ms, "ms_per_launch": ms / n}
        kernels[key]["launches"] = launches[key]  # in the main path's run of `total` steps
        kernels[key]["launches_per_step"] = launches[key] // total
        kernels[key]["trace_ms_per_launch"] = ms / n
    kernels["fwd"]["hopper_launches"] = hopper
    kernels["dq"]["hopper_launches"] = hopper_bwd["dq"]
    kernels["dkv"]["hopper_launches"] = hopper_bwd["dkv"]
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "train", "arch": ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "dtype": cfg.compute_dtype, "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "corpus_tokens": TRAIN_CORPUS_TOKENS, "corpus_vocab": min(cfg.vocab_size, 1024),
          "corpus_s": corpus_s, "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
          "step_ms_median": med * 1e3, "step_ms_p90": timed[int(0.9 * (len(timed) - 1))] * 1e3,
          "step_ms_first": step_s[0] * 1e3, "wall_s": wall,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "timed_wall_s": timed_wall,
          "wall_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / timed_wall,
          "loader_share_of_wall": fetch_share,
          "fetch_ms_median": statistics.median(timings["fetch_s"][TRAIN_WARMUP:]) * 1e3,
          "loss_first": losses[0],
          "loss_last": losses[-1], "peak_device_mem_gb": peak / 1e9,
          "launches_per_step": {k: v // total for k, v in launches.items()},
          "hopper_launches_per_step": {"fwd": hopper // total,
                                       **{k: n // total for k, n in hopper_bwd.items()}},
          "traced_step_s": traced_s, "traced_step_device_kernel_ms": step_kernel_ms,
          "traced_step_device_busy_share": step_kernel_ms / 1e3 / traced_s,
          "attention_kernels_share_of_device_ms":
              sum(t["device_ms"] for t in trace.values()) / step_kernel_ms,
          "trace": trace,
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]})
    del run, loader, step_fn, tb
    torch.cuda.empty_cache()

    # 14. crash and resume at full width with 4 layers: bitwise
    cfg4 = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
    model4 = Model(cfg4)
    ck_root = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck_root, ignore_errors=True)

    def loader4():
        return build_loader(corpus, TRAIN_SEQ, TRAIN_BATCH, n_tokens=TRAIN_CORPUS_TOKENS,
                            vocab_size=min(cfg.vocab_size, 1024))

    t0 = time.perf_counter()
    want = train_loop(model4, loader4(), steps=RESUME_STEPS, ckpt_dir=os.path.join(ck_root, "ref"),
                      ckpt_every=RESUME_EVERY, log_every=100, device=dev)["final_state"]
    restarts = []

    def work(resume: bool):
        return train_loop(model4, loader4(), steps=RESUME_STEPS,
                          ckpt_dir=os.path.join(ck_root, "crashy"), ckpt_every=RESUME_EVERY,
                          log_every=100, resume=resume,
                          crash_after=None if resume else RESUME_CRASH, device=dev)

    got = run_with_restarts(work, max_restarts=1, on_restart=lambda n, e: restarts.append(str(e)))
    got = got["final_state"]
    resume_s = time.perf_counter() - t0
    if len(restarts) != 1 or "injected crash" not in restarts[0]:
        fail(f"the resume phase restarted {restarts}")
    wp, gp = dict(want["params"].named_parameters()), dict(got["params"].named_parameters())
    differ = [n for n in wp if not torch.equal(wp[n], gp[n])]
    differ += [f"m/{n}" for n in wp if not torch.equal(want["opt"].m[n], got["opt"].m[n])]
    differ += [f"v/{n}" for n in wp if not torch.equal(want["opt"].v[n], got["opt"].v[n])]
    if differ or got["step"] != want["step"]:
        fail(f"the resumed run differs from the uninterrupted one in {differ[:8]}")
    emit({"phase": "resume", "layers": RESUME_LAYERS, "steps": RESUME_STEPS,
          "ckpt_every": RESUME_EVERY, "crash_after": RESUME_CRASH, "restarts": restarts,
          "resumed_from": RESUME_EVERY * (RESUME_CRASH // RESUME_EVERY), "bitwise_equal": True,
          "tensors_compared": 3 * len(wp), "seconds": resume_s})
    shutil.rmtree(ck_root, ignore_errors=True)
    del want, got, wp, gp
    extra = ("kernel", "hopper_launches", "previous_kernel", "previous_kernel_ms",
             "host_us_per_call", "mutant_err_of_rule", "bound_parts_ms")
    return [{k: kernels[key][k] for k in (*KERNEL_KEYS, "dtype", "library", "plain",
                                             "trace_ms_per_launch", "launches_per_step", "bytes",
                                             "flop", "want_rms", *extra)}
            for key in ("fwd", "dq", "dkv")]


def _ssm_inputs(B, S, Dm, N, dtype, dev, gen, dt_rank: int = 256):
    """The scan's inputs with the model's distributions and layouts: x one
    half of a wider projection, dt log-uniform in [1e-3, 1e-1] (mamba's dt
    init), A near -(1..N), B and C column slices of a float32 x_proj output
    (after ``dt_rank`` columns: falcon-mamba-7b's 256, jamba's 512), D near
    1, h0 ~ N(0, 0.3)."""
    import torch

    xz = torch.randn((B, S, 2 * Dm), generator=gen, device=dev).to(dtype)
    dt = torch.exp(torch.empty((B, S, Dm), device=dev).uniform_(math.log(1e-3), math.log(1e-1),
                                                               generator=gen))
    A = -torch.exp(torch.log(torch.arange(1, N + 1, device=dev).float())[None]
                   + 0.1 * torch.randn((Dm, N), generator=gen, device=dev))
    xdb = torch.randn((B, S, dt_rank + 2 * N), generator=gen, device=dev)
    D = 1 + 0.1 * torch.randn((Dm,), generator=gen, device=dev)
    h0 = 0.3 * torch.randn((B, Dm, N), generator=gen, device=dev)
    return (xz[..., :Dm], dt, A, xdb[..., dt_rank:dt_rank + N], xdb[..., dt_rank + N:], D, h0)


def _rule_err(got, want, dtype_name: str) -> tuple[float, float, float]:
    """(max |got - want|, the same over SSM_RULE[dtype_name], rms(want));
    the second is at most 1 within the rule."""
    want = want.float()
    a, r = SSM_RULE[dtype_name]
    rms = want.square().mean().sqrt().item()
    return _scaled_err(got, want, a * rms, r) + (rms,)


def _build_mutants(source: str, edits: dict, bind) -> tuple[dict, str]:
    """Build ``csrc/<source>.cu`` unedited (as ``shipped``) and once per
    (old, new) edit of ``edits``, each line occurring once in the source,
    all under ``build/<source>_mutants`` with the port's flags and its
    headers; returns ({name: the library bound by ``bind``}, that
    directory, which the caller removes)."""
    return _finish_mutants(_start_mutants(source, edits), bind)


def _start_mutants(source: str, edits: dict) -> tuple[dict, str, str]:
    """Start :func:`_build_mutants`'s builds (one ``nvcc`` each, ended if
    this script exits first); :func:`_finish_mutants` waits for them."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir = os.path.join(HERE, "build", f"{source}_mutants")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    jobs = {}
    for name, edit in {"shipped": None, **edits}.items():
        text = src
        if edit is not None:
            if src.count(edit[0]) != 1:
                fail(f"mutant {name}: its line occurs {src.count(edit[0])} times in {source}.cu")
            text = src.replace(edit[0], edit[1])
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda proc=proc: proc.poll() is None and proc.kill())
        jobs[name] = (proc, so)
    return jobs, out_dir, source


def _finish_mutants(started: tuple, bind) -> tuple[dict, str]:
    """Wait for :func:`_start_mutants`'s builds; returns ({name: the library
    bound by ``bind``}, their directory, which the caller removes)."""
    import ctypes

    jobs, out_dir, source = started
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"mutant {name} of {source}.cu did not build:\n{log}")
        libs[name] = bind(ctypes.CDLL(so))
    return libs, out_dir


def _sass(so: str) -> str | None:
    """``cuobjdump -sass`` of a built library, or None where the toolkit
    has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True,
                          timeout=300).stdout


def _count_ops(ops: list) -> dict:
    """Instructions, ``MUFU.EX2`` among them, their ratio and the opcodes."""
    counts = {}
    for o in ops:
        counts[o] = counts.get(o, 0) + 1
    mufu = counts.get("MUFU.EX2", 0)
    return {"instructions": len(ops), "mufu_ex2": mufu,
            "per_mufu": len(ops) / mufu if mufu else None,
            "opcodes": dict(sorted(counts.items(), key=lambda kv: -kv[1]))}


def sass_exp_loop(sass: str, *name_parts: str) -> dict:
    """Where the exponentials are issued in the one function of ``sass``
    (``cuobjdump -sass`` text) whose name holds every one of
    ``name_parts``.  ``block``: the branch-free run of instructions that
    holds the most ``MUFU.EX2`` (an unrolled chunk of steps).  ``loop``:
    the loop (from a backward branch's target to the branch) that holds the
    most ``MUFU.EX2`` outside the loops nested in it (waits, a ragged
    chunk's steps), counted without them: each chunk's own work.  Each as
    :func:`_count_ops`; NOP does not count."""
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
             if all(p in f.split("\n", 1)[0] for p in name_parts)]
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} functions match {name_parts}")
    code = []  # (address, opcode, text)
    labels = {}
    for line in funcs[0].splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(code)
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            text = m.group(2)
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            code.append((int(m.group(1), 16), op, text))
    index = {addr: i for i, (addr, _, _) in enumerate(code)}
    loops, targets = [], set()  # loops as (first, last) indices
    for i, (_, op, text) in enumerate(code):
        if not op.startswith("BRA"):
            continue
        target = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", text.split(op, 1)[1])
        if target is None:
            continue
        t = target.group(1)
        j = labels.get(t) if t.startswith(".L") else index.get(int(t, 16))
        if j is None:
            continue
        targets.add(j)
        if j <= i:
            loops.append((j, i))
    blocks, first = [], 0
    for i, (_, op, _) in enumerate(code):
        if i in targets and i > first:
            blocks.append((first, i - 1))
            first = i
        if op.startswith("BRA") or op == "EXIT":
            blocks.append((first, i))
            first = i + 1

    def ops(span, holes=()):
        return [o for i, (_, o, _) in enumerate(code[span[0]:span[1] + 1], span[0])
                if o != "NOP" and not any(a <= i <= b for a, b in holes)]

    def mufu(span):
        return sum(o == "MUFU.EX2" for o in ops(span))

    def nested(loop):
        return [lp for lp in loops if lp != loop and loop[0] <= lp[0] and lp[1] <= loop[1]]

    def own(loop):
        return sum(o == "MUFU.EX2" for o in ops(loop, nested(loop)))

    if not blocks or max(map(mufu, blocks)) == 0:
        raise ValueError(f"no MUFU.EX2 in {name_parts}")
    loop = max(loops, key=own, default=None)
    if loop is None or own(loop) == 0:
        raise ValueError(f"no loop with MUFU.EX2 of its own in {name_parts}")
    return {"block": _count_ops(ops(max(blocks, key=mufu))),
            "loop": _count_ops(ops(loop, nested(loop)))}


def _ssm_mutants(dev, inputs) -> dict:
    """Run the unedited ssm_scan and each of SSM_MUTANTS, built by
    :func:`_build_mutants`, on ``inputs`` into zero-filled outputs; return
    each one's (y, h_final) errors against the plain version over the rule."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm

    libs, out_dir = _build_mutants("ssm_scan", SSM_MUTANTS, ssm.bind)
    x, dt, A, Bc, Cc, D, h0 = inputs
    want_y, want_h = ref.ssm_scan_ref(*inputs)
    result = {}
    for name, lib in libs.items():
        y = torch.zeros(x.shape, dtype=x.dtype, device=dev)
        h = torch.zeros(h0.shape, dtype=torch.float32, device=dev)
        _, _, kernel = ssm.launch(lib, x, dt, A, Bc, Cc, D, h0, out=(y, h))
        torch.cuda.synchronize()
        if kernel != "hopper":
            fail(f"the mutation check ran the {kernel} kernel, not ssm_scan_hopper")
        result[name] = {"y": _rule_err(y, want_y, str(x.dtype).removeprefix("torch.")),
                        "h_final": _rule_err(h, want_h, "float32")}
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def _flash_mutants(q, k, v, want_out, want_lse) -> dict:
    """Run the unedited Hopper forward and each of FLASH_MUTANTS, built by
    :func:`_build_mutants`, on the training shape's causal inputs; return
    each one's out error over the training rule and lse's over 1e-4, as
    (max abs, over the rule[, rms(want)]).  An lse of -inf (a row left
    without keys) counts as -1e30, so that every error stays a finite
    number in the JSON lines."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    libs, out_dir = _build_mutants("flash_attention", FLASH_MUTANTS, fa.bind)
    result = {}
    for name, lib in libs.items():
        out, lse, kernel = fa.launch(lib, q, k, v, True, None, 0, True)
        torch.cuda.synchronize()
        if kernel != "hopper":
            fail(f"the mutation check ran the {kernel} kernel, not the Hopper one")
        result[name] = {"out": _rms_err(out, want_out),
                        "lse": _scaled_err(lse.nan_to_num(neginf=-1e30), want_lse, 1e-4, 0.0)}
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def _bwd_mutants(q, k, v, dout, lse, delta, wants) -> dict:
    """Run the unedited Hopper backward and each of BWD_MUTANTS, built by
    :func:`_build_mutants`, on the training shape's causal inputs; return
    each one's dq, dk and dv errors against ``wants`` (the plain version's)
    over the training rule, as (max abs, over the rule, rms(want)).  A
    non-finite error counts as 1e30, so that every error stays a finite
    number in the JSON lines."""
    import torch

    from repro_torch.kernels import flash_attention_bwd as fab

    libs, out_dir = _build_mutants("flash_attention_bwd", BWD_MUTANTS, fab.bind)
    result = {}
    for name, lib in libs.items():
        (dq,), kq = fab.launch(lib, False, q, k, v, dout, lse, delta, True, None)
        (dk, dv), kkv = fab.launch(lib, True, q, k, v, dout, lse, delta, True, None)
        torch.cuda.synchronize()
        if kq != "hopper" or kkv != "hopper":
            fail(f"the mutation check ran the {kq} and {kkv} kernels, not the Hopper ones")
        result[name] = {n: tuple(x if math.isfinite(x) else 1e30 for x in _rms_err(g, w))
                        for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), wants)}
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def ssm_phases(dev, sm_clock_hz: float) -> dict:
    """Phases 15-18, Mamba serving at falcon-mamba-7b's full width; returns
    the kernels-line entry of ``ssm_scan``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Model
    from repro_torch.serve.scheduler import SlotBatcher

    cfg = get_config(SSM_ARCH)
    s = cfg.ssm
    if (cfg.num_layers, cfg.d_model, s.expand * cfg.d_model, s.d_state, s.d_conv) != SSM_FULL:
        fail(f"{SSM_ARCH} is not at its published width: {cfg}")

    # 15. the kernels against their plain version
    gen = torch.Generator(device=dev).manual_seed(15)
    sweep = {}  # "dtype/y" or "dtype/h_final" -> the worst (abs, over the rule, rms)
    previous_sweep = {}  # the same for the simt kernel on the same inputs
    hopper_before, calls = ssm.hopper_launches, 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for B, S, Dm, N in SSM_SWEEP:
            for with_h0 in (False, True):
                x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(B, S, Dm, N, dtype, dev, gen)
                h0 = h0 if with_h0 else None
                if ssm.route(x, dt, Bc, Cc) != "hopper":
                    fail(f"the sweep's inputs {(B, S, Dm, N, name)} do not take ssm_scan_hopper")
                y, h = ssm.ssm_scan(x, dt, A, Bc, Cc, D, h0)
                yp, hp = previous_ssm_scan(x, dt, A, Bc, Cc, D, h0)
                calls += 1
                want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
                for errs, (gy, gh) in ((sweep, (y, h)), (previous_sweep, (yp, hp))):
                    for key, e in ((f"{name}/y", _rule_err(gy, want_y, name)),
                                   (f"{name}/h_final", _rule_err(gh, want_h, "float32"))):
                        errs[key] = max(errs.get(key, e), e, key=lambda t: t[1])
    if ssm.hopper_launches != hopper_before + calls:
        fail(f"{ssm.hopper_launches - hopper_before} of the sweep's {calls} scans took ssm_scan_hopper")
    if not all(e[1] <= 1.0 for e in (*sweep.values(), *previous_sweep.values())):
        fail(f"ssm_scan disagrees with its plain version on the sweep: {sweep}, "
             f"the simt kernel: {previous_sweep}")

    B, S, Dm, N = SSM_PATH
    inputs = _ssm_inputs(B, S, Dm, N, torch.bfloat16, dev, gen)
    x, dt, A, Bc, Cc, D, h0 = inputs
    if ssm.route(x, dt, Bc, Cc) != "hopper":
        fail("the path shape's inputs do not take ssm_scan_hopper")
    y, h = ssm.ssm_scan(*inputs)
    y2, h2 = ssm.ssm_scan(*inputs)
    yp, hp = previous_ssm_scan(*inputs)
    want_y, want_h = ref.ssm_scan_ref(*inputs)
    torch.cuda.synchronize()
    path = {"y": _rule_err(y, want_y, "bfloat16"), "h_final": _rule_err(h, want_h, "float32")}
    previous_path = {"y": _rule_err(yp, want_y, "bfloat16"),
                     "h_final": _rule_err(hp, want_h, "float32")}
    repeatable = bool(torch.equal(y, y2) and torch.equal(h, h2))
    same_as_previous = bool(torch.equal(y, yp) and torch.equal(h, hp))
    if not all(e[1] <= 1.0 for e in (*path.values(), *previous_path.values())):
        fail(f"ssm_scan disagrees with its plain version at the path shape: {path}, "
             f"the simt kernel: {previous_path}")
    if not path["y"][1] <= SSM_PATH_Y_OF_RULE:
        fail(f"ssm_scan's y at the path shape is at {path['y'][1]} of the rule, above "
             f"{SSM_PATH_Y_OF_RULE}")
    if not repeatable:
        fail("two calls of ssm_scan at the path shape differ")
    del y, h, y2, h2, yp, hp, want_y, want_h
    mutants = _ssm_mutants(dev, inputs)
    failing = {k: max(v["y"][1], v["h_final"][1]) for k, v in mutants.items()}
    weak = {k: r for k, r in failing.items() if k != "shipped" and not r >= SSM_MUTANT_MIN}
    if weak:
        fail(f"mutants of ssm_scan pass the rule with less than {SSM_MUTANT_MIN}x: {weak}")
    if not failing["shipped"] <= 1.0:
        fail(f"the unedited ssm_scan built as a mutant fails the rule: {mutants['shipped']}")
    # the Hopper kernel and the simt kernel it replaced, in turns
    fns = {"hopper": lambda: ssm.ssm_scan(*inputs), "previous": lambda: previous_ssm_scan(*inputs)}
    turns = {"hopper": [], "previous": []}
    for key in ("hopper", "previous", "previous", "hopper"):
        turns[key].append(event_ms(fns[key]))
    kernel_ms, previous_ms = statistics.mean(turns["hopper"]), statistics.mean(turns["previous"])
    host = host_us({"hopper_wrapper": fns["hopper"], "previous_wrapper": fns["previous"]})
    plain_ms = event_ms(lambda: ref.ssm_scan_ref(*inputs), calls=1, groups=3)
    # each input read once, each output written once
    moved = sum(t.numel() * t.element_size() for t in inputs) + x.numel() * x.element_size() \
        + h0.numel() * 4
    exps = B * S * Dm * N
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    exp_ms = exps / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3
    fp32_ms = 6 * exps / FP32_FLOP_PER_S * 1e3  # per state and step: 2 FMAs and 2 products
    ptxas = _build.ptxas_report("ssm_scan")
    sass_text = _sass(str(_build._target("ssm_scan")))
    sass = None
    if sass_text is not None:  # the N = 16 bf16 kernels' inner loops
        sass = {k: sass_exp_loop(sass_text, f, "__nv_bfloat16", "Li16E")
                for k, f in (("hopper", "ssm_scan_hopper"), ("previous", "ssm_scan_kernel"))}
        # a warp issues one instruction a clock on each of an SM's 4
        # schedulers: the time to issue the chunk loop's instructions
        sass["hopper_loop_issue_ms"] = (exps * sass["hopper"]["loop"]["per_mufu"] / 32
                                        / (SCHEDULERS_PER_SM * sms * sm_clock_hz) * 1e3)
    kernel = {"name": "ssm_scan", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
              "replaces": "src/repro/kernels/ssm_scan.py:68",
              "shape": list(SSM_PATH), "dtype": "bfloat16",
              "max_abs_err": max(e[0] for e in (*sweep.values(), *path.values())),
              "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "plain": "ssm_scan_ref, 3 calls", "library_ms": None,
              "library": "none: no single PyTorch call computes a selective scan",
              "bound_ms": max(bytes_ms, exp_ms),
              "bound_by": "bytes" if bytes_ms >= exp_ms else "operations",
              "bound_parts_ms": {"bytes": bytes_ms, "exponentials": exp_ms,
                                 "fp32_pipe": fp32_ms},
              "kernel": "ssm_scan_hopper",
              "previous_kernel": "ssm_scan_kernel (simt: the kernel ssm_scan_hopper replaced "
                                 "on the model's layouts)",
              "previous_kernel_ms": previous_ms, "host_us_per_call": host,
              "bytes": moved, "exponentials": exps, "sm_clock_hz": sm_clock_hz, "sms": sms}
    emit({"phase": "ssm_kernel", **kernel, "rule": SSM_RULE,
          "kernel_ms_turns": turns["hopper"], "previous_kernel_ms_turns": turns["previous"],
          "sweep_errors": sweep, "previous_kernel_sweep_errors": previous_sweep,
          "sweep_hopper_launches": calls,
          "path_shape_errors": path,  # [max abs err, err / rule, rms(want)]
          "path_shape_y_err_of_rule": path["y"][1],
          "path_shape_h_final_err_of_rule": path["h_final"][1],
          "path_shape_y_max_of_rule": SSM_PATH_Y_OF_RULE,
          "previous_kernel_path_shape_errors": previous_path,
          "bitwise_repeatable": repeatable, "bitwise_equal_to_previous_kernel": same_as_previous,
          "mutants": mutants,
          # the least error over the rule among the edited copies, and what each must reach
          "mutant_min_err_of_rule": min(r for k, r in failing.items() if k != "shipped"),
          "mutant_min_required": SSM_MUTANT_MIN,
          "ptxas": ptxas, "sass_inner_loop": sass})
    del inputs, x, dt, A, Bc, Cc, D, h0
    torch.cuda.empty_cache()

    # 16. the card against the CPU at full width with 2 layers in float32
    cfg32 = dataclasses.replace(cfg, num_layers=SSM_CPU_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32)
    lm32 = model32.init(generator=torch.Generator(device=dev).manual_seed(16), device=dev)
    lm_cpu = model32.init(generator=torch.Generator(device=dev).manual_seed(16), device="cpu")
    rng = np.random.default_rng(16)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SSM_CPU_BATCH, SSM_CPU_PROMPT)))
    max_len = SSM_CPU_PROMPT + SSM_CPU_DECODE
    caches = {"cpu": model32.init_cache(SSM_CPU_BATCH, max_len, device="cpu"),
              "card": model32.init_cache(SSM_CPU_BATCH, max_len, device=dev)}

    def state_err() -> dict:
        out = {}
        for k in ("conv", "h"):
            g, w = caches["card"]["sub_0"][k].cpu(), caches["cpu"]["sub_0"][k]
            if not torch.allclose(g, w, rtol=SSM_STATE_RTOL, atol=SSM_STATE_ATOL):
                fail(f"card and CPU {k} states disagree: max err {(g - w).abs().max().item()}")
            out[k] = (g - w).abs().max().item()
        return out

    ssm.ssm_scan.launches = 0
    want, _ = model32.prefill(lm_cpu, {"tokens": prompt}, caches["cpu"])
    got, _ = model32.prefill(lm32, {"tokens": prompt.to(dev)}, caches["card"])
    if ssm.ssm_scan.launches != SSM_CPU_LAYERS:
        fail(f"the card's prefill launched ssm_scan {ssm.ssm_scan.launches} times")
    prefill_state = state_err()
    steps = [(got.cpu(), want)]
    tok = want.argmax(-1)
    for i in range(SSM_CPU_DECODE):
        want, _ = model32.decode(lm_cpu, tok, caches["cpu"], SSM_CPU_PROMPT + i)
        got, _ = model32.decode(lm32, tok.to(dev), caches["card"], SSM_CPU_PROMPT + i)
        steps.append((got.cpu(), want))
        tok = want.argmax(-1)
    cpu_err, ties = 0.0, 0
    for g, w in steps:
        if not bool(torch.isfinite(g).all()):
            fail("non-finite logits on the card")
        if not torch.allclose(g, w, rtol=CPU_RTOL, atol=CPU_ATOL):
            fail(f"card and CPU logits disagree: max err {(g - w).abs().max().item()}")
        cpu_err = max(cpu_err, (g - w).abs().max().item())
        for b in range(SSM_CPU_BATCH):
            gt, wt = int(g[b].argmax()), int(w[b].argmax())
            if gt != wt:
                if not abs(float(w[b, gt]) - float(w[b, wt])) < TIE_F32:
                    fail(f"greedy tokens differ off a tie: card {gt}, CPU {wt}")
                ties += 1
    emit({"phase": "ssm_vs_cpu", "arch": SSM_ARCH, "layers": SSM_CPU_LAYERS, "dtype": "float32",
          "batch": SSM_CPU_BATCH, "prompt": SSM_CPU_PROMPT, "decode_steps": SSM_CPU_DECODE,
          "max_abs_err": cpu_err, "max_abs_logit": max(w.abs().max().item() for _, w in steps),
          "rtol": CPU_RTOL, "atol": CPU_ATOL, "greedy_ties": ties,
          "state_max_abs_err_after_prefill": prefill_state,
          "state_max_abs_err_after_decode": state_err(),
          "state_rtol": SSM_STATE_RTOL, "state_atol": SSM_STATE_ATOL})
    del lm32, lm_cpu, caches
    torch.cuda.empty_cache()

    # 17. the main path: serve_batch at full width and depth in bf16
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(generator=torch.Generator(device=dev).manual_seed(17), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prompts = rng.integers(0, cfg.vocab_size, (SSM_SERVE_BATCH, SSM_SERVE_PROMPT)).astype(np.int32)
    serve_batch(model, prompts, SSM_SERVE_GEN, params=params, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    ssm.ssm_scan.launches = 0
    ssm.hopper_launches = 0
    toks = serve_batch(model, prompts, SSM_SERVE_GEN, params=params, device=dev, timings=timings)
    launches = ssm.ssm_scan.launches
    hopper = ssm.hopper_launches
    # one prefill and SSM_SERVE_GEN - 1 decode steps: the prefill's 64, none in decode
    per_decode_step = (launches - cfg.num_layers) / timings["decode_steps"]
    if launches != cfg.num_layers:
        fail(f"ssm_scan launched {launches} times in one prefill of {cfg.num_layers} layers "
             f"and {timings['decode_steps']} decode steps")
    if hopper != launches:
        fail(f"{hopper} of the prefill's {launches} scans took ssm_scan_hopper")
    if toks.shape != (SSM_SERVE_BATCH, SSM_SERVE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"serve_batch gave tokens of shape {toks.shape} outside the vocabulary")
    peak = torch.cuda.max_memory_allocated(dev)
    decode_ms = timings["decode_s"] / timings["decode_steps"] * 1e3

    def traced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        return on_card, sum(e.self_device_time_total for e in on_card) / 1e3, wall

    cache = model.init_cache(SSM_SERVE_BATCH, SSM_SERVE_PROMPT + SSM_SERVE_GEN, device=dev)
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    on_card, prefill_kernel_ms, prefill_wall = traced(lambda: model.prefill(params, batch, cache))
    mine = [e for e in on_card if "ssm_scan" in e.key]
    if not mine:
        fail("the trace shows no ssm_scan kernel on the card")
    scan_ms = sum(e.self_device_time_total for e in mine) / 1e3
    scan_n = sum(e.count for e in mine)
    traced_hopper = sum(e.count for e in mine if "ssm_scan_hopper" in e.key)
    if traced_hopper != scan_n or scan_n != cfg.num_layers:
        fail(f"the traced prefill shows {scan_n} scans, {traced_hopper} of them ssm_scan_hopper")
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    tok = torch.from_numpy(toks[:, -1].astype(np.int64)).to(dev)
    dec_card, decode_kernel_ms, decode_wall = traced(
        lambda: model.decode(params, tok, cache, SSM_SERVE_PROMPT))
    if any("ssm_scan" in e.key for e in dec_card):
        fail("a traced decode step launched ssm_scan")
    dec_top = sorted(dec_card, key=lambda e: -e.self_device_time_total)[:5]
    turns = decode_ms_with_and_without_block(params, tok, cache, SSM_SERVE_PROMPT)
    emit({"phase": "ssm_serve", "arch": SSM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_inner": s.expand * cfg.d_model, "params": n_params,
          "dtype": cfg.compute_dtype, "batch": SSM_SERVE_BATCH, "prompt": SSM_SERVE_PROMPT,
          "gen": SSM_SERVE_GEN, "init_on_card_s": init_s,
          "prefill_ms": timings["prefill_s"] * 1e3, "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": SSM_SERVE_BATCH * timings["decode_steps"] / timings["decode_s"],
          "peak_device_mem_gb": peak / 1e9, "ssm_scan_launches": launches,
          "ssm_scan_hopper_launches": hopper, "prefills": 1,
          "decode_steps": timings["decode_steps"],
          "ssm_scan_launches_per_decode_step": per_decode_step,
          "traced_prefill_device_kernel_ms": prefill_kernel_ms,
          "traced_prefill_wall_ms": prefill_wall * 1e3,
          "ssm_scan_trace": {"count": scan_n, "device_ms": scan_ms,
                             "ms_per_launch": scan_ms / scan_n,
                             "share_of_prefill_kernel_time": scan_ms / prefill_kernel_ms},
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
          "traced_decode_step_device_kernel_ms": decode_kernel_ms,
          "traced_decode_step_wall_ms": decode_wall * 1e3,
          "traced_decode_step_kernel_launches": sum(e.count for e in dec_card),
          "decode_top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                                 for e in dec_top],
          "decode_ms_with_and_without_tf32_block": turns})
    kernel["launches"] = launches
    kernel["hopper_launches"] = hopper
    kernel["trace_ms_per_launch"] = scan_ms / scan_n
    del params, cache, batch
    torch.cuda.empty_cache()

    # 18. continuous batching over SSM caches at full width in float32
    cfg_b = dataclasses.replace(cfg, num_layers=SSM_BATCH_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    model_b = Model(cfg_b)
    lm_b = model_b.init(generator=torch.Generator(device=dev).manual_seed(18), device=dev)
    brng = np.random.default_rng(18)
    lens = brng.integers(SSM_BATCH_PROMPT_LENS[0], SSM_BATCH_PROMPT_LENS[1] + 1,
                         SSM_BATCH_REQUESTS)
    max_new = brng.integers(SSM_BATCH_NEW[0], SSM_BATCH_NEW[1] + 1, SSM_BATCH_REQUESTS)
    prompts = [brng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    batcher = SlotBatcher(model_b, lm_b, batch_slots=BATCH_SLOTS, max_len=SSM_BATCH_MAX_LEN)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, int(m))
    t0 = time.perf_counter()
    done = batcher.run()
    batch_s = time.perf_counter() - t0
    if [r.rid for r in done] != list(range(SSM_BATCH_REQUESTS)) or not all(r.done for r in done):
        fail(f"the batcher completed {[r.rid for r in done]}")
    diverged = []
    for req, p, m in zip(done, prompts, max_new):
        want, lgs = _greedy_standalone(model_b, lm_b, p, int(m), SSM_BATCH_MAX_LEN, dev)
        tie = _tie_diverged(req.out, want, lgs, TIE_F32)
        if tie is not None:
            diverged.append({"rid": req.rid, **tie})
    emit({"phase": "ssm_batching", "arch": SSM_ARCH, "layers": SSM_BATCH_LAYERS,
          "dtype": "float32", "slots": BATCH_SLOTS, "requests": SSM_BATCH_REQUESTS,
          "max_len": SSM_BATCH_MAX_LEN, "prompt_lens": lens.tolist(),
          "max_new": max_new.tolist(), "tokens": int(sum(len(r.out) for r in done)),
          "cursor_end": batcher.pos, "seconds": batch_s, "ties": diverged})
    del lm_b, batcher
    torch.cuda.empty_cache()
    return {k: kernel[k] for k in (*KERNEL_KEYS, "dtype", "library", "plain",
                                     "trace_ms_per_launch", "kernel", "hopper_launches",
                                     "previous_kernel", "previous_kernel_ms", "host_us_per_call",
                                     "bound_parts_ms", "bytes", "exponentials", "sm_clock_hz",
                                     "sms")}



def _batch_crc(batch) -> int:
    """CRC-32 of a CSR batch's values, columns, row pointers and obs."""
    import numpy as np

    crc = 0
    for a in (batch.data, batch.indices, batch.indptr,
              *(batch.obs[k] for k in sorted(batch.obs))):
        crc = zlib.crc32(np.ascontiguousarray(a).view(np.uint8), crc)
    return crc


def planned_phase(dev, root: str, store) -> dict:
    """Phase 20: one epoch of the cell path in each way of PLANNED_WAYS, in
    turns, PLANNED_TURNS times; see the module docstring."""
    import numpy as np
    import torch

    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import NVME_SSD, IOCounters
    from repro_torch.kernels import csr_to_dense
    from repro_torch.pipeline import Pipeline
    from repro_torch.train import probe

    fetch_rows = BATCH * FETCH_FACTOR
    avg_row_bytes = store.avg_row_bytes
    want, runs = None, {way: [] for way in PLANNED_WAYS}
    for turn in range(PLANNED_TURNS):
        for way, knobs in PLANNED_WAYS.items():
            pipe, counters, cache_bytes = None, store.iostats, None
            if knobs is None:
                store.iostats.reset()
                loader = ScIterableDataset(store, BlockShuffling(BLOCK), batch_size=BATCH,
                                           fetch_factor=FETCH_FACTOR, seed=0)
            else:
                workers, readahead, nvme = knobs
                counters = IOCounters(simulate=NVME_SSD if nvme else None, simulate_scale=1.0)
                cache_bytes = int(PLANNED_CACHE_HEADROOM * (readahead + 1) * fetch_rows * avg_row_bytes)
                pipe = (Pipeline.from_uri(f"sharded-csr://{root}", cache_bytes=cache_bytes,
                                          block_rows=BLOCK, io_workers=workers,
                                          readahead=readahead, iostats=counters)
                        .strategy("block", block_size=BLOCK)
                        .batch(BATCH, fetch_factor=FETCH_FACTOR).seed(0).build())
                loader = pipe
            crcs = []

            def digested(batches):
                for b in batches:
                    crcs.append(_batch_crc(b))
                    yield b

            heads = probe.init_heads(N_GENES, device=dev, generator=torch.Generator().manual_seed(0))
            opt = probe.init_adam(heads)
            torch.cuda.synchronize()
            csr_to_dense.ell_to_dense.launches = 0
            run = probe.train_probe(digested(loader), heads, opt, device=dev)
            launches = csr_to_dense.ell_to_dense.launches
            snap = counters.snapshot()
            if pipe is not None:
                pipe.close()
            del heads, opt
            where = f"planned_cell_path {way}, turn {turn}"
            if want is None:
                want = crcs
            if crcs != want:
                diff = next(i for i, (x, y) in enumerate(zip(crcs, want)) if x != y) \
                    if len(crcs) == len(want) else f"{len(crcs)} batches, not {len(want)}"
                fail(f"{where}: the batches differ from way (a)'s (first at {diff})")
            losses, steps = run["losses"], run["steps"]
            if steps < MIN_STEPS or launches != steps:
                fail(f"{where}: {steps} steps, ell_to_dense launched {launches} times")
            if not all(math.isfinite(x) for x in losses):
                fail(f"{where}: non-finite loss")
            first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
            if not last < first:
                fail(f"{where}: loss did not fall: first 20 steps {first}, last 20 {last}")
            if knobs is not None and knobs[1] > 0 and snap["prefetched"] <= 0:
                fail(f"{where}: readahead staged no block (prefetched {snap['prefetched']})")
            runs[way].append({
                "samples_per_s": steps * BATCH / run["seconds"], "loader_wait_s": run["loader_wait_s"],
                "seconds": run["seconds"], "steps": steps, "launches": launches,
                "stream_idle_share": 1 - sum(run["step_stream_ms"]) / 1e3 / run["seconds"],
                "cache_bytes": cache_bytes, "loss_first20": first, "loss_last20": last,
                **{k: snap[k] for k in ("runs", "bytes_read", "cache_hits", "cache_misses",
                                        "prefetched", "wall_s", "modeled_s")}})
    out = {"phase": "planned_cell_path", "cells": len(store), "genes": store.n_var,
           "batch": BATCH, "fetch_factor": FETCH_FACTOR, "block_size": BLOCK, "block_rows": BLOCK,
           "avg_row_bytes": avg_row_bytes, "turns": PLANNED_TURNS, "batches_bitwise": True,
           "storage_model": dataclasses.asdict(NVME_SSD),
           "ways": {way: {"io_workers_readahead_nvme": PLANNED_WAYS[way], "runs": r}
                    for way, r in runs.items()}}
    emit(out)
    return out


def export_h5ad(root: str, out: str) -> dict:
    """Phase 5's plates as one ``.h5ad`` file each (``csr_shard_to_h5ad``,
    the shim's writer) and a ``manifest.json`` under ``out``; returns the
    export's seconds and bytes."""
    from repro_torch.data.synth import export_sharded_h5ad

    t0 = time.perf_counter()
    with open(os.path.join(root, "manifest.json")) as f:
        shards = [os.path.join(root, s) for s in json.load(f)["shards"]]
    files = export_sharded_h5ad(shards, out)
    return {"seconds": time.perf_counter() - t0, "files": len(files),
            "bytes": sum(os.path.getsize(p) for p in files)}


def _digested(items, crcs: list, reports: list):
    """``items``' batches, each one's CRC appended to ``crcs``; a DataLoader
    worker's closing report of its counters goes to ``reports``."""
    for b in items:
        if isinstance(b, dict) and "worker_io" in b:
            reports.append(b["worker_io"])
            continue
        crcs.append(_batch_crc(b))
        yield b


def _probe_run(dev, batches, max_steps=None) -> tuple[dict, int]:
    """``train_probe`` from fresh heads (seed 0) over ``batches``, with
    ``ell_to_dense``'s count set to 0 just before; returns the run and the
    count read just after."""
    import torch

    from repro_torch.kernels import csr_to_dense
    from repro_torch.train import probe

    heads = probe.init_heads(N_GENES, device=dev, generator=torch.Generator().manual_seed(0))
    opt = probe.init_adam(heads)
    torch.cuda.synchronize()
    csr_to_dense.ell_to_dense.launches = 0
    run = probe.train_probe(batches, heads, opt, device=dev, max_steps=max_steps)
    return run, csr_to_dense.ell_to_dense.launches


def h5ad_phase(dev, root: str, store) -> dict:
    """Phase 21: phase 5's plates exported to h5ad, then one epoch of the
    cell path in each way of H5AD_WAYS, in turns, H5AD_TURNS times, the
    paper's random baseline and, where h5py imports, one epoch through it;
    see the module docstring."""
    import numpy as np
    import torch
    from torch.utils.data import DataLoader, IterableDataset

    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import SATA_SSD, IOCounters
    from repro_torch.pipeline import Pipeline

    t_phase = time.perf_counter()
    out_root = os.path.join(HERE, "build", "chip_smoke_h5ad")
    export = export_h5ad(root, out_root)
    emit({"phase": "h5ad_export", **export, "plates": len(store.shards), "cells": len(store),
          "genes": store.n_var})
    uri = f"sharded-h5ad://{out_root}?driver=shim"
    cache_bytes = int(PLANNED_CACHE_HEADROOM * BATCH * FETCH_FACTOR * store.avg_row_bytes)

    def pipeline(counters, *, driver="shim", workers=0, block=BLOCK, fetch_factor=FETCH_FACTOR,
                 cache=cache_bytes):
        pipe = Pipeline.from_uri(f"sharded-h5ad://{out_root}?driver={driver}", cache_bytes=cache,
                                 block_rows=block, io_workers=1, readahead=0, iostats=counters)
        return (pipe.strategy("block", block_size=block).batch(BATCH, fetch_factor=fetch_factor)
                .seed(0).prefetch(workers=workers).build())

    class Reporting(IterableDataset):
        """A DataLoader worker's share of the epoch, then its counters."""

        def __init__(self, ds):
            self.ds = ds

        def __iter__(self):
            yield from self.ds
            yield {"worker_io": self.ds.collection.iostats.snapshot()}

    io_keys = ("runs", "bytes_read", "cache_hits", "cache_misses", "wall_s", "modeled_s")
    want, runs, obs_dtypes = None, {way: [] for way in H5AD_WAYS}, None
    for turn in range(H5AD_TURNS):
        for way, how in H5AD_WAYS.items():
            pipe, extra, reports = None, {}, []
            if how is None:
                store.iostats.reset()
                loader = ScIterableDataset(store, BlockShuffling(BLOCK), batch_size=BATCH,
                                           fetch_factor=FETCH_FACTOR, seed=0)
                counters = store.iostats
            else:
                counters = IOCounters()
                pipe = pipeline(counters, workers=H5AD_POOL_WORKERS if how == "pool" else 0)
                loader = pipe
                if how == "dataloader":
                    # The collection is shared with forked workers: at the
                    # fork no executor thread may exist and no lock be held.
                    col = pipe.collection
                    if col.async_enabled or col._executor is not None or any(
                            lk.locked() for lk in (col._fl, col._exec_lock, counters._lock)):
                        fail("h5ad_cell_path: the collection is not fork-safe at the fork")
                    loader = DataLoader(Reporting(pipe.dataset), batch_size=None,
                                        num_workers=H5AD_LOADER_WORKERS,
                                        multiprocessing_context="fork",
                                        timeout=H5AD_LOADER_TIMEOUT_S)
            crcs = []
            run, launches = _probe_run(dev, _digested(loader, crcs, reports))
            where = f"h5ad_cell_path {way}, turn {turn}"
            if how == "dataloader":
                del loader
                if len(reports) != H5AD_LOADER_WORKERS:
                    fail(f"{where}: {len(reports)} worker reports, not {H5AD_LOADER_WORKERS}")
                snap = {k: sum(r[k] for r in reports) for k in io_keys}
            else:
                snap = counters.snapshot()
            if how == "pool":
                st = pipe.last_pool.stats
                extra = {"pool": {k: st[k] for k in ("fetches", "speculative_reissues",
                                                     "heartbeat_reissues", "duplicate_completions")},
                         "pool_worker_fetches": dict(sorted(st["worker_fetches"].items()))}
            if pipe is not None:
                if obs_dtypes is None:
                    b = pipe.collection.fetch(np.arange(4))
                    a = store[np.arange(4)]
                    obs_dtypes = {k: [str(a.obs[k].dtype), str(b.obs[k].dtype)] for k in a.obs}
                    if sorted(a.obs) != sorted(b.obs) or any(x != y for x, y in obs_dtypes.values()):
                        fail(f"{where}: obs columns or dtypes differ between CSR and h5ad: "
                             f"{obs_dtypes}")
                pipe.close()
            if want is None:
                want = crcs
            same = sorted(crcs) == sorted(want) if how == "dataloader" else crcs == want
            if not same:
                fail(f"{where}: the batches differ from way (a)'s "
                     f"({len(crcs)} batches, {len(want)} wanted)")
            losses, steps = run["losses"], run["steps"]
            if steps < MIN_STEPS or launches != steps:
                fail(f"{where}: {steps} steps, ell_to_dense launched {launches} times")
            if not all(math.isfinite(x) for x in losses):
                fail(f"{where}: non-finite loss")
            first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
            if not last < first:
                fail(f"{where}: loss did not fall: first 20 steps {first}, last 20 {last}")
            runs[way].append({
                "samples_per_s": steps * BATCH / run["seconds"], "loader_wait_s": run["loader_wait_s"],
                "seconds": run["seconds"], "steps": steps, "launches": launches,
                "stream_idle_share": 1 - sum(run["step_stream_ms"]) / 1e3 / run["seconds"],
                "loss_first20": first, "loss_last20": last, **{k: snap[k] for k in io_keys},
                **extra})

    # The paper's random baseline on the paper's format: b = 1, f = 1, one
    # block of one row per read, beside way (b)'s first RANDOM_STEPS steps;
    # both counted under a modeled SATA disk that does not sleep.
    baseline = {}
    for name, kw in (("random", dict(block=1, fetch_factor=1, cache=0)), ("block", {})):
        counters = IOCounters(simulate=SATA_SSD, simulate_scale=0.0)
        pipe = pipeline(counters, **kw)
        run, launches = _probe_run(dev, pipe, max_steps=RANDOM_STEPS)
        pipe.close()
        if run["steps"] != RANDOM_STEPS or launches != RANDOM_STEPS:
            fail(f"h5ad_cell_path {name}: {run['steps']} steps, {launches} launches")
        if not all(math.isfinite(x) for x in run["losses"]):
            fail(f"h5ad_cell_path {name}: non-finite loss")
        snap = counters.snapshot()
        baseline[name] = {"block_size": kw.get("block", BLOCK),
                          "fetch_factor": kw.get("fetch_factor", FETCH_FACTOR),
                          "samples_per_s": RANDOM_STEPS * BATCH / run["seconds"],
                          "seconds": run["seconds"], "loader_wait_s": run["loader_wait_s"],
                          "rows_read": snap["rows"], **{k: snap[k] for k in io_keys},
                          "modeled_samples_per_s": RANDOM_STEPS * BATCH / snap["modeled_s"]}
    ratio = baseline["block"]["samples_per_s"] / baseline["random"]["samples_per_s"]
    modeled_ratio = (baseline["block"]["modeled_samples_per_s"]
                     / baseline["random"]["modeled_samples_per_s"])

    # h5py, where it imports: one more epoch of way (b) through it
    try:
        import h5py  # noqa: F401

        h5py_importable = True
    except ImportError:
        h5py_importable = False
    h5py_run = None
    if h5py_importable:
        counters = IOCounters()
        pipe = pipeline(counters, driver="h5py")
        crcs = []
        run, launches = _probe_run(dev, _digested(pipe, crcs, []))
        pipe.close()
        if crcs != want or launches != run["steps"]:
            fail(f"h5ad_cell_path h5py: batches equal (a)'s: {crcs == want}, {launches} launches "
                 f"in {run['steps']} steps")
        h5py_run = {"samples_per_s": run["steps"] * BATCH / run["seconds"],
                    "loader_wait_s": run["loader_wait_s"], "seconds": run["seconds"],
                    "launches": launches, **{k: counters.snapshot()[k] for k in io_keys}}

    out = {"phase": "h5ad_cell_path", "uri": uri, "cells": len(store), "genes": store.n_var,
           "batch": BATCH, "fetch_factor": FETCH_FACTOR, "block_size": BLOCK, "block_rows": BLOCK,
           "cache_bytes": cache_bytes, "turns": H5AD_TURNS, "pool_workers": H5AD_POOL_WORKERS,
           "loader_workers": H5AD_LOADER_WORKERS, "batches_bitwise": True,
           "dataloader_compared_as": "multiset", "obs_dtypes_csr_h5ad": obs_dtypes,
           "dataloader_design": "the collection is opened in the parent with io_workers 1 and "
                                "readahead 0 (no executor thread, no lock held at the fork); "
                                "forked workers share the shim's descriptor (positioned reads)",
           "ways": {way: {"how": H5AD_WAYS[way], "runs": r} for way, r in runs.items()},
           "random_baseline": {**baseline, "block_over_random_samples_per_s": ratio,
                               "block_over_random_modeled": modeled_ratio,
                               "storage_model": dataclasses.asdict(SATA_SSD),
                               "note": "page cache warm; the paper's format and ratio, not "
                                       "its figure"},
           "h5py_importable": h5py_importable, "h5py_epoch": h5py_run,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def _epoch_checks(where: str, run: dict, launches: int | None) -> tuple:
    """An epoch of ``train_probe``: enough steps, one feature launch each
    (unless ``launches`` is None: threads share the count), finite losses
    that fall; returns the first and last 20 steps' means."""
    losses, steps = run["losses"], run["steps"]
    if steps < MIN_STEPS or launches not in (None, steps):
        fail(f"{where}: {steps} steps, ell_to_dense launched {launches} times")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{where}: non-finite loss")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not last < first:
        fail(f"{where}: loss did not fall: first 20 steps {first}, last 20 {last}")
    return first, last


def _epoch_row(run: dict, launches: int, first: float, last: float) -> dict:
    return {"samples_per_s": run["steps"] * BATCH / run["seconds"],
            "loader_wait_s": run["loader_wait_s"], "seconds": run["seconds"],
            "steps": run["steps"], "launches": launches,
            "stream_idle_share": 1 - sum(run["step_stream_ms"]) / 1e3 / run["seconds"],
            "loss_first20": first, "loss_last20": last}


def diversity_phase(dev, root: str, store) -> dict:
    """Phase 22: autotune with an entropy floor, the tuned cell path with
    and without the diversity monitor, drift and a retune, and the Fig. 4
    twin on phase 5's store; see the module docstring."""
    import numpy as np

    from repro_torch.core.theory import distribution_entropy, entropy_bounds, mean_batch_entropy
    from repro_torch.pipeline import Pipeline
    from repro_torch.train import fig4

    t_phase = time.perf_counter()
    cache_bytes = int(PLANNED_CACHE_HEADROOM * BATCH * FETCH_FACTOR * store.avg_row_bytes)
    builder = (Pipeline.from_uri(f"sharded-csr://{root}", cache_bytes=cache_bytes,
                                 block_rows=BLOCK)
               .strategy("block", block_size=BLOCK)
               .batch(BATCH, fetch_factor=FETCH_FACTOR, drop_last=False).seed(0)
               .diversity(obs="plate", entropy_floor=DIVERSITY_FLOOR))
    fingerprint = builder.spec.fingerprint()
    t0 = time.perf_counter()
    builder.autotune(budget=AUTOTUNE_BUDGET)
    probe_s = time.perf_counter() - t0
    rec, spec = builder.last_recommendation, builder.spec
    block = int(spec.strategy_params["block_size"])
    if (spec.fetch_factor, block) != (rec.fetch_factor, rec.block_size):
        fail(f"diversity_autotune: the spec records ({block}, {spec.fetch_factor}), the pick is "
             f"({rec.block_size}, {rec.fetch_factor})")
    if rec.predicted_entropy < DIVERSITY_FLOOR:
        fail(f"diversity_autotune: predicted E[H] {rec.predicted_entropy} under the floor")
    plain_spec = spec.replace(diversity_obs=None, entropy_floor=0.0)
    if plain_spec.fingerprint() != spec.fingerprint():
        fail("diversity_autotune: the diversity fields moved the fingerprint")
    sizes = np.array([len(s) for s in store.shards], dtype=np.float64)
    p = sizes / sizes.sum()
    lo, hi = entropy_bounds(p, BATCH, block)
    want, epochs, drift, retuned = None, {}, None, None
    for name, with_monitor in (("monitor", True), ("no_monitor", False)):
        pipe = builder.build() if with_monitor else Pipeline.from_spec(plain_spec).build()
        crcs, plates = [], []

        def digested(batches):
            for b in batches:
                crcs.append(_batch_crc(b))
                plates.append(np.asarray(b.obs["plate"]))
                yield b

        run, launches = _probe_run(dev, digested(pipe))
        where = f"diversity_autotune {name}"
        first, last = _epoch_checks(where, run, launches)
        snap = pipe.collection.iostats.snapshot()
        row = {**_epoch_row(run, launches, first, last), "io_workers": pipe.collection.io_workers,
               "readahead": pipe.collection.readahead, "div_batches": snap["div_batches"]}
        if want is None:
            want = crcs
        elif crcs != want:
            fail(f"{where}: the batches differ from the monitored epoch's")
        if with_monitor:
            mean, std = mean_batch_entropy(plates)
            if snap["div_batches"] != run["steps"]:
                fail(f"{where}: div_batches {snap['div_batches']} for {run['steps']} steps")
            live = snap["div_entropy_sum"] / snap["div_batches"]
            if not math.isclose(live, mean, rel_tol=1e-9):
                fail(f"{where}: live mean entropy {live} != offline {mean}")
            slack = 3 * max(std, 0.05)
            in_bounds = lo - slack <= mean <= hi + slack
            if not in_bounds:
                fail(f"{where}: entropy {mean} +- {std} outside the bounds [{lo}, {hi}]")
            row.update({"entropy_live_mean": live, "entropy_offline_mean": mean,
                        "entropy_std": std, "entropy_min": snap["div_entropy_min"],
                        "in_bounds": in_bounds, "stats_diversity": pipe.stats()["diversity"]})
            drift = pipe.check_drift()
            t0 = time.perf_counter()
            r2 = pipe.retune(budget=AUTOTUNE_BUDGET)
            retuned = {"seconds": time.perf_counter() - t0, "block_size": r2.block_size,
                       "fetch_factor": r2.fetch_factor, "predicted_entropy": r2.predicted_entropy,
                       "io_workers": r2.io_workers, "readahead": r2.readahead,
                       "hit_rate": r2.model.hit_rate, "runs_per_sample": r2.model.runs_per_sample}
        elif snap["div_batches"] != 0:
            fail(f"{where}: an unmonitored epoch counted {snap['div_batches']} batches")
        pipe.close()
        epochs[name] = row
    t0 = time.perf_counter()
    grid = fig4.run(root, grid_b=FIG4_SUBGRID[0], grid_f=FIG4_SUBGRID[1], log=lambda line: None)
    fig4_s = time.perf_counter() - t0
    m = rec.model
    out = {"phase": "diversity_autotune", "cells": len(store), "genes": store.n_var,
           "batch": BATCH, "entropy_floor": DIVERSITY_FLOOR, "budget": AUTOTUNE_BUDGET,
           "cache_bytes": cache_bytes, "probe_seconds": probe_s,
           "recommendation": {"block_size": rec.block_size, "fetch_factor": rec.fetch_factor,
                              "predicted_entropy": rec.predicted_entropy,
                              "io_workers": rec.io_workers, "readahead": rec.readahead,
                              "buffer_bytes": rec.buffer_bytes,
                              "cache_reserved_bytes": rec.cache_reserved_bytes,
                              "modeled_samples_per_s": rec.modeled_samples_per_sec,
                              "rationale": rec.rationale},
           "model": {"c0": m.c0, "c_seek": m.c_seek, "c_byte": m.c_byte, "hit_rate": m.hit_rate,
                     "runs_per_sample": m.runs_per_sample, "row_bytes": m.row_bytes},
           "fingerprint_before_autotune": fingerprint, "fingerprint": spec.fingerprint(),
           "Hp": distribution_entropy(p), "bounds_at_tuned_b": [lo, hi],
           "batches_bitwise": True, "epochs": epochs,
           "monitor_cost_s": epochs["monitor"]["seconds"] - epochs["no_monitor"]["seconds"],
           "check_drift": drift, "retune": retuned,
           "fig4": {"seconds": fig4_s, "Hp": grid["Hp"], "all_in_bounds": grid["all_in_bounds"],
                    "random": [grid["random"]["H"], grid["random"]["std"]],
                    "cells": {k: {"H": c["H"], "std": c["std"], "bounds": c["bounds"],
                                  "in_bounds": c["in_bounds"]} for k, c in grid["grid"].items()}},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def resilient_phase(dev, store) -> dict:
    """Phase 23: the cell path from phase 21's h5ad plates behind fault
    injection and object-store requests, under the resilience knobs; see
    the module docstring."""
    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.pipeline import Pipeline

    t_phase = time.perf_counter()
    out_root = os.path.join(HERE, "build", "chip_smoke_h5ad")  # phase 21's export
    uri = f"fault://cloud://sharded-h5ad://{out_root}?driver=shim&{RESILIENT_FAULTS}"
    want = [_batch_crc(b) for b in ScIterableDataset(store, BlockShuffling(BLOCK), batch_size=BATCH,
                                                     fetch_factor=FETCH_FACTOR, seed=0)]
    fetch_rows = BATCH * FETCH_FACTOR
    runs = {}
    for way, (workers, readahead, blackout) in RESILIENT_WAYS.items():
        knobs = dict(RESILIENT_KNOBS)
        if blackout:
            knobs.update(retries=RESILIENT_BLACKOUT_RETRIES, breaker_cooldown_s=0.001)
        cache_bytes = int(PLANNED_CACHE_HEADROOM * (readahead + 1) * fetch_rows * store.avg_row_bytes)
        pipe = (Pipeline.from_uri(uri + (f"&blackout={RESILIENT_BLACKOUT}" if blackout else ""),
                                  cache_bytes=cache_bytes, block_rows=BLOCK, io_workers=workers,
                                  readahead=readahead)
                .strategy("block", block_size=BLOCK).batch(BATCH, fetch_factor=FETCH_FACTOR).seed(0)
                .resilience(**knobs).build())
        crcs = []
        run, launches = _probe_run(dev, _digested(pipe, crcs, []))
        where = f"resilient_cell_path {way}"
        first, last = _epoch_checks(where, run, launches)
        snap, stats = pipe.collection.iostats.snapshot(), pipe.stats()
        pipe.close()
        if crcs != want:
            fail(f"{where}: the batches differ from phase 5's store's ({len(crcs)} batches, "
                 f"{len(want)} wanted)")
        runs[way] = {**_epoch_row(run, launches, first, last), "io_workers": workers,
                     "readahead": readahead, "retries_budget": knobs["retries"],
                     "cache_bytes": cache_bytes, **{k: snap[k] for k in RESILIENT_IO},
                     "faults": stats["faults"], "breaker": stats["resilience"]["breaker"]}
    a, a2, c = runs["a_sync"], runs["a_sync_again"], runs["c_blackout"]
    if not (a["retries"] == a2["retries"] > 0):
        fail(f"resilient_cell_path: (a) retried {a['retries']} and {a2['retries']} times")
    if c["breaker_opens"] < 1 or c["breaker_closes"] < 1:
        fail(f"resilient_cell_path c_blackout: the circuit opened {c['breaker_opens']} and closed "
             f"{c['breaker_closes']} times")
    out = {"phase": "resilient_cell_path", "uri": uri, "resilience": RESILIENT_KNOBS,
           "blackout": RESILIENT_BLACKOUT, "blackout_retries": RESILIENT_BLACKOUT_RETRIES,
           "cells": len(store), "genes": store.n_var, "batch": BATCH,
           "fetch_factor": FETCH_FACTOR, "block_size": BLOCK, "batches_bitwise": True,
           "ways": runs, "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def _idle_share(run: dict):
    """The stream's idle share over a run (None where no step was timed on
    the card)."""
    spans = run.get("step_stream_ms")
    return None if spans is None else 1 - sum(spans) / 1e3 / run["seconds"]


def _http_stats(address) -> dict:
    """The server's ``GET /stats`` body, over a socket with a timeout."""
    import socket

    with socket.create_connection(address, timeout=SERVE_SOCKET_S) as s:
        s.sendall(b"GET /stats HTTP/1.0\r\n\r\n")
        resp = b""
        while chunk := s.recv(1 << 16):
            resp += chunk
    head, body = resp.split(b"\r\n\r\n", 1)
    if b"200 OK" not in head:
        fail(f"served_cell_path: GET /stats answered {head[:80]!r}")
    return json.loads(body)


def _run_threads(where: str, fns: list) -> list:
    """Run each function in a thread of its own; their results in order.
    A function that raised, or a thread still running after
    SERVE_THREAD_S, fails the phase."""
    import threading

    out = [None] * len(fns)

    def body(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # handed to the caller, which fails
            out[i] = e

    threads = [threading.Thread(target=body, args=(i,), name=f"{where}-{i}", daemon=True)
               for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=SERVE_THREAD_S)
        if th.is_alive():
            fail(f"{where}: {th.name} still running after {SERVE_THREAD_S} s")
    for i, r in enumerate(out):
        if isinstance(r, BaseException):
            fail(f"{where} {i}: {type(r).__name__}: {r}")
    return out


def _threaded_probe(dev, batches) -> dict:
    """``train_probe`` from fresh heads (seed 0) over ``batches``, on a
    stream of this thread's own (the ranks' steps do not share a stream)."""
    import contextlib

    import torch

    from repro_torch.train import probe

    heads = probe.init_heads(N_GENES, device=dev, generator=torch.Generator().manual_seed(0))
    opt = probe.init_adam(heads)
    on_card = dev.type == "cuda"
    with torch.cuda.stream(torch.cuda.Stream(dev)) if on_card else contextlib.nullcontext():
        return probe.train_probe(batches, heads, opt, device=dev)


def served_phase(dev, root: str, store) -> dict:
    """Phase 24: tenants of one batch server against the same loaders
    isolated, on phase 5's store; see the module docstring."""
    import numpy as np

    from repro_torch.kernels import csr_to_dense
    from repro_torch.pipeline import Pipeline
    from repro_torch.serve.data import BatchServer, DataClient, ServeConfig

    t_phase = time.perf_counter()
    uri = f"cloud://sharded-csr://{root}?{SERVE_CLOUD}"
    spec = (Pipeline.from_uri(uri, io_workers=2).strategy("block", block_size=BLOCK)
            .batch(BATCH, fetch_factor=SERVE_FETCH_FACTOR).seed(0).spec)
    budget = int(PLANNED_CACHE_HEADROOM * BATCH * SERVE_FETCH_FACTOR * store.avg_row_bytes)
    cache_total = SERVE_TENANTS * budget
    local = Pipeline.from_spec(spec).build()
    want, head = [], []
    for b in local:
        want.append(_batch_crc(b))
        if len(head) < SERVE_QINT8_STEPS:
            head.append(b)
    local.close()
    io = ("requests", "bytes_read", "cache_hits", "cache_misses", "runs")

    def arm_row(runs, wire, snap, launches):
        rows = []
        for i, (run, first, last) in enumerate(runs):
            rows.append({"samples_per_s": run["steps"] * BATCH / run["seconds"],
                         "loader_wait_s": run["loader_wait_s"], "seconds": run["seconds"],
                         "steps": run["steps"], "stream_idle_share": _idle_share(run),
                         "loss_first20": first, "loss_last20": last,
                         **({"wire_bytes": wire[i]} if wire else {})})
        return {"tenants": rows, "launches": launches, **{k: snap[k] for k in io}}

    srv = BatchServer(ServeConfig(max_tenants=SERVE_TENANTS, cache_bytes=cache_total,
                                  block_rows=BLOCK, io_workers=2, queue_depth=2)).start()
    try:
        def sent(cli) -> int:
            return next(t["bytes_sent"] for t in srv.stats().tenants if t["id"] == cli.tenant_id)

        def tenant(i):
            crcs, wire = [], [0]

            def batches():
                cli = DataClient(srv.address, spec, timeout_s=SERVE_SOCKET_S)
                try:
                    it = iter(cli)
                    if i == 0:  # stops, then resumes over a new connection
                        for k, b in enumerate(it):
                            crcs.append(_batch_crc(b))
                            yield b
                            if k + 1 == SERVE_RESUME_AFTER:
                                break
                        ckpt = cli.state()
                        wire[0] += sent(cli)
                        cli.close()
                        cli = DataClient(srv.address, spec, timeout_s=SERVE_SOCKET_S)
                        cli.load_state(ckpt)
                        it = iter(cli)
                    for b in it:
                        crcs.append(_batch_crc(b))
                        yield b
                    wire[0] += sent(cli)
                finally:
                    cli.close()

            return _threaded_probe(dev, batches()), crcs, wire[0]

        csr_to_dense.ell_to_dense.launches = 0
        tenants = _run_threads("served_cell_path tenant", [lambda i=i: tenant(i)
                                                           for i in range(SERVE_TENANTS)])
        launches = csr_to_dense.ell_to_dense.launches
        shared_snap = srv.stats().aggregate
        runs = []
        for i, (run, crcs, _) in enumerate(tenants):
            if crcs != want:
                fail(f"served_cell_path tenant {i}: {len(crcs)} batches, not bitwise the local "
                     f"pipeline's {len(want)}")
            runs.append((run, *_epoch_checks(f"served_cell_path tenant {i}", run, None)))
        if launches != sum(r["steps"] for r, _, _ in tenants):
            fail(f"served_cell_path: ell_to_dense launched {launches} times in "
                 f"{[r['steps'] for r, _, _ in tenants]} steps")
        shared = arm_row(runs, [w for _, _, w in tenants], shared_snap, launches)

        # the qint8 tenant: exact structure, values within the codec's bound
        with DataClient(srv.address, spec, compression="qint8", timeout_s=SERVE_SOCKET_S) as cli:
            it = iter(cli)
            qbatches = [next(it) for _ in range(SERVE_QINT8_STEPS)]
            q_wire = sent(cli)
        q_err = 0.0
        for i, (a, b) in enumerate(zip(head, qbatches)):
            if not (np.array_equal(a.indices, b.indices) and np.array_equal(a.indptr, b.indptr)
                    and all(np.array_equal(a.obs[k], b.obs[k]) for k in a.obs)
                    and list(a.obs) == list(b.obs)):
                fail(f"served_cell_path qint8: batch {i}'s columns, row pointers or obs differ")
            err, bound = float(np.abs(a.data - b.data).max()), float(np.abs(a.data).max()) / 127
            if err > bound + 1e-6:
                fail(f"served_cell_path qint8: batch {i} off by {err}, bound {bound}")
            q_err = max(q_err, err)
        q_run, q_launches = _probe_run(dev, qbatches)
        if q_launches != q_run["steps"] or q_run["steps"] != SERVE_QINT8_STEPS or not all(
                math.isfinite(x) for x in q_run["losses"]):
            fail(f"served_cell_path qint8: {q_run['steps']} steps, {q_launches} launches")
        http = _http_stats(srv.address)
    finally:
        srv.stop()

    # the isolated arm: the same specs as local pipelines, a third of the cache each
    pipes = [Pipeline.from_spec(spec.replace(cache_bytes=budget, block_rows=BLOCK)).build()
             for _ in range(SERVE_TENANTS)]

    def isolated(i):
        crcs = []
        return _threaded_probe(dev, _digested(pipes[i], crcs, [])), crcs

    csr_to_dense.ell_to_dense.launches = 0
    loaders = _run_threads("served_cell_path isolated", [lambda i=i: isolated(i)
                                                         for i in range(SERVE_TENANTS)])
    iso_launches = csr_to_dense.ell_to_dense.launches
    iso_snap = {k: sum(p.collection.iostats.snapshot()[k] for p in pipes) for k in io}
    for p in pipes:
        p.close()
    iso_runs = []
    for i, (run, crcs) in enumerate(loaders):
        if crcs != want:
            fail(f"served_cell_path isolated {i}: not bitwise the local pipeline's batches")
        iso_runs.append((run, *_epoch_checks(f"served_cell_path isolated {i}", run, None)))
    if iso_launches != sum(r["steps"] for r, _ in loaders):
        fail(f"served_cell_path isolated: ell_to_dense launched {iso_launches} times")
    isolated_row = arm_row(iso_runs, None, iso_snap, iso_launches)
    for k in ("requests", "bytes_read"):
        if not shared[k] < isolated_row[k]:
            fail(f"served_cell_path: the shared arm's {k} {shared[k]} is not below the "
                 f"isolated arm's {isolated_row[k]}")
    out = {"phase": "served_cell_path", "uri": uri, "cells": len(store), "genes": store.n_var,
           "tenants": SERVE_TENANTS, "batch": BATCH, "fetch_factor": SERVE_FETCH_FACTOR,
           "block_size": BLOCK, "block_rows": BLOCK, "cache_bytes_total": cache_total,
           "cache_bytes_isolated_each": budget, "resume_after": SERVE_RESUME_AFTER,
           "batches_bitwise": True, "shared": shared, "isolated": isolated_row,
           "requests_ratio": isolated_row["requests"] / shared["requests"],
           "bytes_ratio": isolated_row["bytes_read"] / shared["bytes_read"],
           "qint8": {"steps": SERVE_QINT8_STEPS, "max_abs_err": q_err, "wire_bytes": q_wire,
                     "launches": q_launches},
           "http_stats": {"aggregate": {k: http["aggregate"][k] for k in io},
                          "admission": http["admission"],
                          "collections": [{"key": c["key"], "refs": c["refs"]}
                                          for c in http["collections"]]},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def _fabric_steps(dev, heads: dict, loaders: dict, got: dict, limit, on_batch=None) -> dict:
    """The ranks' loaders in turns, batch by batch (the co-located
    schedule), each rank's batch through its own heads and optimizer
    (``heads[rank]``) on the card; each batch's CRC under its
    ``(gid, batch_index)``, which must be new.  Returns the steps'
    losses, span events, loader wait and batches."""
    import torch

    from repro_torch.distributed.elastic import tagged_batches
    from repro_torch.train import probe

    its = {r: tagged_batches(ds, limit=limit) for r, ds in sorted(loaders.items())}
    acc = {"losses": [], "marks": [], "wait": 0.0, "batches": 0}
    on_card = dev.type == "cuda"
    while its:
        for r in list(its):
            tw = time.perf_counter()
            try:
                gid, j, b = next(its[r])
            except StopIteration:
                del its[r]
                continue
            finally:
                acc["wait"] += time.perf_counter() - tw
            if (gid, j) in got:
                fail(f"elastic_cell_path: batch {(gid, j)} delivered twice")
            got[(gid, j)] = _batch_crc(b)
            if on_batch is not None:
                on_batch(r, gid, j)
            rank_heads, opt = heads[r]
            t = b.to_tensors()
            if on_card:
                acc["marks"].append((torch.cuda.Event(enable_timing=True),
                                     torch.cuda.Event(enable_timing=True)))
                acc["marks"][-1][0].record()
            x = probe.features(t["vals"].to(dev), t["cols"].to(dev), n_genes=N_GENES)
            acc["losses"].append(probe.train_step(rank_heads, opt, x, {k: v.to(dev) for k, v in
                                                                       t["obs"].items()}))
            if on_card:
                acc["marks"][-1][1].record()
            acc["batches"] += 1
    return acc


def _fabric_arm(dev, schedule) -> tuple:
    """One arm of phase 25: ``schedule(step)`` calls ``step(loaders,
    limit=None, on_batch=None)`` for each stretch of :func:`_fabric_steps`,
    with fresh heads per rank and the feature kernel's count set to 0 just
    before and read just after; returns the delivered CRCs and the arm's
    row (without its counters)."""
    import torch

    from repro_torch.kernels import csr_to_dense
    from repro_torch.train import probe

    heads = {}
    for r in range(ELASTIC_WORLD):
        h = probe.init_heads(N_GENES, device=dev, generator=torch.Generator().manual_seed(r))
        heads[r] = (h, probe.init_adam(h))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got, steps = {}, []

    def step(loaders, limit=None, on_batch=None):
        steps.append(_fabric_steps(dev, heads, loaders, got, limit, on_batch))

    csr_to_dense.ell_to_dense.launches = 0
    t0 = time.perf_counter()
    schedule(step)
    losses = torch.stack([x for s in steps for x in s["losses"]]).tolist()
    seconds = time.perf_counter() - t0
    launches = csr_to_dense.ell_to_dense.launches
    n = sum(s["batches"] for s in steps)
    spans = [a.elapsed_time(b) for s in steps for a, b in s["marks"]]
    if launches != n or len(got) != n:
        fail(f"elastic_cell_path: {n} batches, {len(got)} keys, ell_to_dense launched "
             f"{launches} times")
    if not all(math.isfinite(x) for x in losses):
        fail("elastic_cell_path: a non-finite loss")
    return got, {"batches": n, "launches": launches, "seconds": seconds,
                 "samples_per_s": n * BATCH / seconds,
                 "loader_wait_s": sum(s["wait"] for s in steps),
                 "stream_idle_share": 1 - sum(spans) / 1e3 / seconds if spans else None,
                 "loss_first20": statistics.mean(losses[:20]),
                 "loss_last20": statistics.mean(losses[-20:])}


def elastic_phase(dev, root: str, store) -> dict:
    """Phase 25: the elastic fabric over one cloud collection, with a kill
    and two resizes, against the never-resized epoch and isolated ranks,
    on phase 5's store; see the module docstring."""
    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import IOCounters, open_collection
    from repro_torch.distributed.elastic import ElasticFabric, RankSupervisor
    from repro_torch.distributed.fault import LivenessMonitor

    t_phase = time.perf_counter()
    uri = f"cloud://sharded-csr://{root}?{SERVE_CLOUD}"
    kw = dict(batch_size=BATCH, fetch_factor=ELASTIC_FETCH_FACTOR, seed=0)
    cache_total = ELASTIC_WORLD * int(PLANNED_CACHE_HEADROOM * BATCH * FETCH_FACTOR
                                      * store.avg_row_bytes)
    io = ("requests", "bytes_read", "cache_hits", "cache_misses", "shared_rank_hits",
          "reissued_fetches", "prefetched")

    def shared_collection():
        return open_collection(uri, iostats=IOCounters(), cache_bytes=cache_total, io_workers=2)

    # the reference arm: world 3, never resized, on one collection
    ref_col = shared_collection()
    ref_fab = ElasticFabric(ref_col, world_size=ELASTIC_WORLD, strategy=BlockShuffling(BLOCK), **kw)
    ref, ref_row = _fabric_arm(dev, lambda step: step(ref_fab.loaders))
    ref_row.update({k: ref_col.iostats.snapshot()[k] for k in io})
    ref_col.release()
    epoch_batches = len(ScIterableDataset(store, BlockShuffling(BLOCK), **kw))
    if len(ref) != epoch_batches:
        fail(f"elastic_cell_path: the never-resized epoch gave {len(ref)} batches, "
             f"not {epoch_batches}")

    # the elastic arm: kill(1) mid-fetch, resize(2), resize(3), drain
    col = shared_collection()
    fab = ElasticFabric(col, world_size=ELASTIC_WORLD, strategy=BlockShuffling(BLOCK), **kw)
    sup = RankSupervisor(ScIterableDataset(col, BlockShuffling(BLOCK), **kw),
                         heartbeat=LivenessMonitor(timeout_s=ELASTIC_HEARTBEAT_S))
    owes: dict = {}  # rank -> the gid it has issued and not yet acknowledged
    acks = []

    def on_batch(rank, gid, j):
        sup.beat(rank)
        if owes.get(rank) != gid:
            sup.issue(rank, 0, gid)
            owes[rank] = gid
        if j == ELASTIC_FETCH_FACTOR - 1:
            acks.append(sup.ack(rank, 0, gid))
            owes.pop(rank)

    recovered = {}

    def schedule(step):
        step(fab.loaders, ELASTIC_PHASE_BATCHES, on_batch)
        killed = fab.kill(1)
        time.sleep(2 * ELASTIC_HEARTBEAT_S)
        for r in fab.loaders:  # the live ranks beat on; rank 1 is a suspect now
            sup.beat(r)
        recovered.update(sup.recover())
        recovered["killed_in"] = list(killed.remaining[0])  # (gid, batches it delivered)
        owes.clear()
        fab.resize(ELASTIC_WORLD - 1)
        step(fab.loaders, ELASTIC_PHASE_BATCHES, on_batch)
        owes.clear()
        fab.resize(ELASTIC_WORLD)
        step(fab.loaders, None, on_batch)

    got, row = _fabric_arm(dev, schedule)
    snap = col.iostats.snapshot()
    row.update({k: snap[k] for k in io})
    col.release()
    if got != ref:
        missing = sorted(set(ref) - set(got))[:5]
        fail(f"elastic_cell_path: the kill/resize stream is not the never-resized one "
             f"({len(got)} batches, {len(ref)} wanted, missing e.g. {missing})")
    gid, skip = recovered["killed_in"]
    if not 0 < skip < ELASTIC_FETCH_FACTOR or recovered.get("1") != [gid]:
        fail(f"elastic_cell_path: rank 1 died in fetch {gid} after {skip} of its batches, and "
             f"recover() re-issued {recovered}")
    if snap["shared_rank_hits"] <= 0 or snap["reissued_fetches"] < 1:
        fail(f"elastic_cell_path: shared_rank_hits {snap['shared_rank_hits']}, "
             f"reissued_fetches {snap['reissued_fetches']}")
    if not all(acks) or sup.outstanding():
        fail(f"elastic_cell_path: {acks.count(False)} duplicate acks, outstanding "
             f"{sup.outstanding()}")

    # the isolated arm: the same three ranks, a collection and a third of the cache each
    cols = [open_collection(uri, iostats=IOCounters(), cache_bytes=cache_total // ELASTIC_WORLD,
                            io_workers=2) for _ in range(ELASTIC_WORLD)]
    loaders = {r: ScIterableDataset(cols[r], BlockShuffling(BLOCK), rank=r,
                                    world_size=ELASTIC_WORLD, **kw) for r in range(ELASTIC_WORLD)}
    iso, iso_row = _fabric_arm(dev, lambda step: step(loaders))
    iso_row.update({k: sum(c.iostats.snapshot()[k] for c in cols) for k in io})
    for c in cols:
        c.release()
    if iso != ref:
        fail("elastic_cell_path: the isolated ranks' stream is not the never-resized one")
    for k in ("requests", "bytes_read"):
        if not row[k] / row["batches"] < iso_row[k] / iso_row["batches"]:
            fail(f"elastic_cell_path: the shared arm's {k} per sample is not below the "
                 f"isolated arm's ({row[k]} against {iso_row[k]})")
    out = {"phase": "elastic_cell_path", "uri": uri, "cells": len(store), "genes": store.n_var,
           "world": ELASTIC_WORLD, "schedule": f"{ELASTIC_WORLD} -> kill(1) -> "
           f"{ELASTIC_WORLD - 1} -> {ELASTIC_WORLD}, {ELASTIC_PHASE_BATCHES} batches a rank "
           f"between events", "batch": BATCH, "fetch_factor": ELASTIC_FETCH_FACTOR,
           "block_size": BLOCK, "block_rows": "default (256)", "cache_bytes_total": cache_total,
           "batches_bitwise": True, "recover": recovered,
           "acks": len(acks), "reference": ref_row, "elastic": row, "isolated": iso_row,
           "requests_ratio": iso_row["requests"] / row["requests"],
           "bytes_ratio": iso_row["bytes_read"] / row["bytes_read"],
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def fig5_phase(dev) -> dict:
    """Phase 19: the Fig. 5 experiment at FIG5_DATA; returns ``ell_to_dense``'s
    times at one of its batches for the kernels line."""
    import numpy as np
    import torch

    from repro_torch.data import generate_tahoe_like, load_tahoe_like
    from repro_torch.kernels import csr_to_dense, ref
    from repro_torch.precision import full_float32_matmul
    from repro_torch.train import fig5

    root = os.path.join(HERE, "build", "chip_smoke_fig5")
    t0 = time.perf_counter()
    generate_tahoe_like(root, **FIG5_DATA)
    store = load_tahoe_like(root)
    data_s = time.perf_counter() - t0
    flag = torch.backends.cuda.matmul
    flag.allow_tf32 = True  # a caller with TF32 on: the experiment's products stay float32
    torch.cuda.synchronize()
    csr_to_dense.ell_to_dense.launches = 0
    t0 = time.perf_counter()
    result = fig5.run(store, seeds=FIG5_SEEDS, device=dev, log=lambda line: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = csr_to_dense.ell_to_dense.launches
    tf32_after = flag.allow_tf32
    flag.allow_tf32 = False  # the script's setting again
    if tf32_after is not True:
        fail(f"the Fig. 5 experiment left allow_tf32 {tf32_after}, its caller had True")
    steps = sum(e["steps"] for e in result["epochs"])
    test_chunks = -(-len(store.shards[fig5.TRAIN_PLATES]) // fig5.TEST_CHUNK_ROWS)
    if launches != steps + test_chunks or any(e["ell_to_dense_launches"] != e["steps"]
                                              for e in result["epochs"]):
        fail(f"ell_to_dense launched {launches} times for {steps} steps and {test_chunks} "
             f"chunks of the held-out plate: {result['epochs']}")
    scores = [x for by in result["macro_f1"].values() for v in by.values() for x in v]
    if len(scores) != 4 * 4 * len(FIG5_SEEDS) or not all(
            math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores):
        fail(f"macro-F1 outside [0, 1]: {result['macro_f1']}")
    # the host's cost of keeping float32 products in full float32: one
    # flag block, as each model entry point and training step enters it once

    def block():
        with full_float32_matmul():
            pass

    precision_us = host_us({"full_float32_matmul": block})
    emit({"phase": "fig5", "cells": len(store), "genes": store.n_var, "seeds": list(FIG5_SEEDS),
          "cut": "20,000 cells, not 150,000, and one seed: the full experiment is its own run "
                 "(python -m repro_torch.train.fig5)",
          "data_seconds": data_s, "seconds": seconds, "steps": steps,
          "ell_to_dense_launches": launches, "held_out_chunks": test_chunks,
          "allow_tf32_before_and_after": [True, tf32_after], "epochs": result["epochs"],
          "macro_f1": result["summary"], "ordering": result["ordering"],
          "precision_host_us_per_call": precision_us})

    # the kernel at one of the experiment's batches, after the counts were read
    strategy, f = fig5.strategies()["block_shuffling"]
    t = next(iter(fig5.train_dataset(store, strategy, f, 0))).to_tensors()
    vals, cols, G = t["vals"].to(dev), t["cols"].to(dev), store.n_var
    want = ref.ell_to_dense_ref(vals, cols, G)
    if not torch.equal(csr_to_dense.ell_to_dense(vals, cols, n_cols=G), want):
        fail("ell_to_dense is not bitwise its plain version at the Fig. 5 batch")
    if not torch.equal(csr_to_dense.ell_to_dense(vals, cols, n_cols=G, log1p=True),
                       want.clone().log1p_()):
        fail("ell_to_dense with log1p is not bitwise the plain version then log1p_ at the "
             "Fig. 5 batch")
    R, K = vals.shape
    valid = cols >= 0
    rows = torch.arange(R, device=dev).unsqueeze(1).expand_as(cols)[valid]
    lib_cols, lib_vals = cols[valid].long(), vals[valid]
    timed = {
        "kernel": lambda: csr_to_dense.ell_to_dense(vals, cols, n_cols=G),
        "fused_log1p": lambda: csr_to_dense.ell_to_dense(vals, cols, n_cols=G, log1p=True),
        "library": lambda: torch.zeros((R, G), device=dev).index_put_(
            (rows, lib_cols), lib_vals, accumulate=True),
        "write_floor": lambda: torch.empty((R, G), device=dev).zero_(),
        "plain": lambda: ref.ell_to_dense_ref(vals, cols, G),
    }
    turns = {k: [] for k in timed}
    for order in (list(timed), list(reversed(timed))):
        for k in order:
            turns[k].append(event_ms(timed[k]))
    ms = {k: statistics.mean(v) for k, v in turns.items()}
    moved = vals.numel() * 4 + cols.numel() * 4 + R * G * 4
    nnz = int(valid.sum())
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, nnz / FP32_FLOP_PER_S * 1e3
    return {"shape": [R, K, G], "nnz": nnz, "launches": launches, "ms": ms["kernel"],
            "fused_log1p_ms": ms["fused_log1p"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "write_floor_ms": ms["write_floor"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": moved,
            "ms_turns": turns}


def _wide_err(got, want, dtype_name: str) -> dict:
    """The new shapes' rule, WIDE_RULE: the largest |got - want| and
    rms(got - want) / rms(want), each over its bound; ``of_rule`` is the
    larger ratio, at most 1 within the rule."""
    import torch

    # float64, non-finite values as 1e30: a mutant's stale output stays a
    # finite, failing number in the JSON lines
    d = torch.nan_to_num(got.double() - want.double(), nan=1e30, posinf=1e30, neginf=-1e30)
    max_abs = d.abs().max().item()
    rms_want = want.double().square().mean().sqrt().item()
    rms_of = d.square().mean().sqrt().item() / rms_want
    a, r = WIDE_RULE[dtype_name]
    return {"max_abs_err": max_abs, "rms_err_of_rms_want": rms_of, "rms_want": rms_want,
            "of_rule": max(max_abs / a, rms_of / r)}


def _visible_pairs(S: int, window) -> int:
    """(query, key) pairs a causal mask (and a window) keeps over S rows."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _wide_inputs(B, H, Hkv, S, D, dtype, dev, gen):
    """q, k, v as the model passes them: (B, S, H, D) projections viewed as
    (B, H, S, D), drawn on the card."""
    import torch

    def view(heads):
        return torch.randn((B, S, heads, D), generator=gen, device=dev).to(dtype).transpose(1, 2)
    return view(H), view(Hkv), view(Hkv)


def _tma_refused(x):
    """A copy of the (B, H, S, D) view ``x`` of (B, S, H, D) rows, each row
    now 4 values longer than D: its head stride of D + 4 values (520 bytes
    at D 256) is one TMA refuses, so the copy takes the ``mma.sync``
    kernel."""
    import torch

    B, H, S, D = x.shape
    rows = torch.empty((B, S, H, D + 4), dtype=x.dtype, device=x.device)[..., :D].transpose(1, 2)
    return rows.copy_(x)


def _wide_mutants(cases: dict) -> tuple[dict, dict]:
    """Run the unedited forward and each of WIDE_MUTANTS, built by
    :func:`_build_mutants`, on every case of the new shapes (``cases``:
    {(shape, dtype): (q, k, v, window, want)}); return each one's error
    over the rule per case, and the CUDA-event times, in turns, of the
    unedited build and of the one without V's loads at gemma's shape."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    libs, out_dir = _build_mutants("flash_attention", WIDE_MUTANTS, fa.bind)
    result = {}
    for name, lib in libs.items():
        result[name] = {}
        for (shape, dtype_name), (q, k, v, window, want) in cases.items():
            out, _, kernel = fa.launch(lib, q, k, v, True, window, 0, False)
            torch.cuda.synchronize()
            result[name][f"{shape}_{dtype_name}"] = _wide_err(out, want, dtype_name)["of_rule"]
            del out
    q, k, v, window, _ = cases[("d256", "bfloat16")]
    timed = ("shipped", "d256_hopper_skips_v_loads")
    turns = {name: [] for name in timed}
    for order in (timed, timed[::-1]):
        for name in order:
            turns[name].append(event_ms(
                lambda lib=libs[name]: fa.launch(lib, q, k, v, True, window, 0, False),
                calls=WIDE_TIMED_CALLS, groups=3))
    shutil.rmtree(out_dir, ignore_errors=True)
    return result, turns


def wide_kernel_phase(dev) -> list:
    """Phase 26: the forward at the new head widths' serving shapes
    (WIDE_SHAPES) on the card against its plain version, in bf16 and
    float32, and at head_dim 256 at strides TMA refuses (the ``mma.sync``
    kernel); the mutation check (WIDE_MUTANTS); CUDA-event times, in turns,
    of the kernel, of ``scaled_dot_product_attention`` and at 256 of
    ``flash_fwd_bf16<256>``, beside the bound.  Returns the kernels-line entries of the two shapes (their
    launches filled in by phase 27)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(2)
    cases, entries, phase = {}, {}, {}
    for shape, (B, H, Hkv, S, D, window) in WIDE_SHAPES.items():
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            q, k, v = _wide_inputs(B, H, Hkv, S, D, dtype, dev, gen)
            route = fa.route(q, k, v, window)
            want_route = "f32" if dtype == torch.float32 else "hopper"
            if route != want_route:
                fail(f"the {shape} shape in {name} routes to {route}, not {want_route}")
            counts = (fa.hopper_launches, fa.wide_launches)
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            moved = (fa.hopper_launches - counts[0], fa.wide_launches - counts[1])
            if moved != (int(route == "hopper"), int(D > 128)):
                fail(f"the {shape} shape in {name} moved the Hopper and wide counts by {moved}")
            errs[name] = _wide_err(got, want, name)
            if not errs[name]["of_rule"] <= 1.0:
                fail(f"flash_attention disagrees with its plain version at {shape} in {name}: "
                     f"{errs[name]}")
            cases[(shape, name)] = (q, k, v, window, want)
            del got
        q, k, v, _, want = cases[(shape, "bfloat16")]
        if D > 128:  # the kept mma.sync kernel, on the same values at strides TMA refuses
            qr, kr, vr = (_tma_refused(t) for t in (q, k, v))
            route = fa.route(qr, kr, vr, window)
            counts = (fa.hopper_launches, fa.wide_launches)
            got = fa.flash_attention(qr, kr, vr, causal=True, window=window)
            torch.cuda.synchronize()
            moved = (fa.hopper_launches - counts[0], fa.wide_launches - counts[1])
            if route != "bf16" or moved != (0, 1):
                fail(f"the {shape} shape at strides TMA refuses took {route}, counts moved {moved}")
            errs["bfloat16_tma_refused"] = _wide_err(got, want, "bfloat16")
            if not errs["bfloat16_tma_refused"]["of_rule"] <= 1.0:
                fail(f"flash_fwd_bf16<256> disagrees with its plain version: "
                     f"{errs['bfloat16_tma_refused']}")
            cases[(f"{shape}_tma_refused", "bfloat16")] = (qr, kr, vr, window, want)
            del got
        if window is None:
            def library(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        else:  # SDPA's GQA with a mask: the heads expanded and the mask made outside the timing
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
            kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))

            def library(q=q, kx=kx, vx=vx, mask=mask):
                return F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask)
        lib_err = _wide_err(library(), cases[(shape, "bfloat16")][4], "bfloat16")

        def kernel(q=q, k=k, v=v, window=window):
            return fa.flash_attention(q, k, v, causal=True, window=window)

        def plain(q=q, k=k, v=v, window=window):
            return ref.flash_attention_ref(q, k, v, causal=True, window=window)

        def previous(q=q, k=k, v=v):  # flash_fwd_bf16<256>, which gemma's prefill took before
            return previous_kernel(q, k, v, False)

        fns = {"kernel": kernel, "library": library}
        if D > 128:
            fns["previous"] = previous
        turns = {key: [] for key in fns}
        for order in (tuple(fns), tuple(reversed(fns))):
            for key in order:
                turns[key].append(event_ms(fns[key], calls=WIDE_TIMED_CALLS, groups=3))
        plain_ms = event_ms(plain, calls=1, groups=3)
        pairs = _visible_pairs(S, window)
        moved = (2 * B * H * S * D + 2 * B * Hkv * S * D) * 2  # q, k, v read; o written
        flop = 4 * B * H * D * pairs
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flop / BF16_FLOP_PER_S * 1e3
        kernel_name = "flash_fwd_hopper<256>" if D > 128 else \
            "flash_fwd_hopper<128> (inner extent 120)"
        ms = statistics.mean(turns["kernel"])
        bound_ms = max(bytes_ms, ops_ms)
        previous_ms = {"previous_kernel": "flash_fwd_bf16<256> (mma.sync)",
                       "previous_kernel_ms": statistics.mean(turns["previous"])} if D > 128 else {}
        entries[shape] = {
            "name": f"flash_attention_{shape}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:86", "kernel": kernel_name,
            "launches": None, "max_abs_err": errs["bfloat16"]["max_abs_err"],
            "f32_max_abs_err": errs["float32"]["max_abs_err"],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": statistics.mean(turns["library"]),
            "library": "scaled_dot_product_attention", "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_parts_ms": {"bytes": bytes_ms, "tensor_cores": ops_ms},
            "bound_share": bound_ms / ms,
            "library_over_kernel": statistics.mean(turns["library"]) / ms, **previous_ms,
            "shape": [B, H, Hkv, S, S, D], "window": window, "dtype": "bfloat16",
            "bytes": moved, "flop": flop}
        phase[shape] = {"shape": [B, H, Hkv, S, S, D], "window": window, "errors": errs,
                        "library_error": lib_err, "ms_turns": turns, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": entries[shape]["bound_by"],
                        "bound_share": bound_ms / ms, "kernel": kernel_name, **previous_ms}
    mutants, v_loads = _wide_mutants(cases)
    for case, of_rule in mutants["shipped"].items():
        if not of_rule <= 1.0:
            fail(f"the unedited build fails the rule at {case}: {of_rule}")
    for name, by_case in mutants.items():
        if name != "shipped" and not max(by_case.values()) >= FLASH_MUTANT_MIN:
            fail(f"mutant {name} passes the new shapes' rule: {by_case}")
    del cases
    torch.cuda.empty_cache()
    emit({"phase": "wide_kernels", "rule": {k: {"max_abs": a, "rms_of_rms_want": r}
                                             for k, (a, r) in WIDE_RULE.items()},
          **phase, "mutants": mutants, "mutant_min": FLASH_MUTANT_MIN,
          "d256_ms_with_and_without_v_loads": v_loads})
    return [entries["d256"], entries["d120"]]


def _prefill_len(cfg, prompt_len: int, inputs: dict) -> int:
    """The rows of the prefill's attention: the encoder's frames for
    encdec, the image prefix and the prompt for vlm, else the prompt."""
    if cfg.family == "encdec":
        return inputs["frames"].shape[1]
    return prompt_len + (cfg.num_patches if cfg.family == "vlm" else 0)


def _serve_arch(dev, cfg, prompts, phase: str, extra: dict, *, inputs=None,
                gen: int = WIDE_GEN, after=None) -> dict:
    """Serve ``prompts`` (with ``inputs``, the vlm's ``patch_embeds`` or
    encdec's ``frames``, numpy) with ``cfg`` at full width on the card in
    bf16: weights drawn there from a seeded generator, a warm-up serve of
    2 tokens at the same shapes, then ``gen`` tokens with the attention
    kernels' counts set to 0 just before and read just after: every
    prefill attention layer (encdec: every encoder layer) through the
    Hopper kernel, also counted as wide past head_dim 128, and every
    Mamba layer's scan through ``ssm_scan_hopper`` (the hybrid family's).
    Emits the phase line; returns the launch counts, with ``after(model,
    params, tokens, logits, timings)``'s result under "model_axis" where
    ``after`` is given (called with the weights before they are freed,
    and the timed serve's tokens, every step's logits and its timings)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Model

    inputs = inputs or {}
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() for p in params.parameters())
    serve_batch(model, prompts, 2, extra=inputs, params=params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings, logits = {}, []
    fa.flash_attention.launches = fa.hopper_launches = fa.wide_launches = 0
    ssm.ssm_scan.launches = ssm.hopper_launches = 0
    toks = serve_batch(model, prompts, gen, extra=inputs, params=params, device=dev,
                       timings=timings, logits_out=logits if after is not None else None)
    counts = {"flash_attention": fa.flash_attention.launches, "hopper": fa.hopper_launches,
              "wide": fa.wide_launches, "ssm_scan": ssm.ssm_scan.launches,
              "ssm_scan_hopper": ssm.hopper_launches}
    L, D = cfg.num_layers, cfg.resolved_head_dim
    A = L if cfg.family == "encdec" else sum(cfg.is_attn_layer(i) for i in range(L))
    M = L - A if cfg.family == "hybrid" else 0  # Mamba layers
    want = {"flash_attention": A, "hopper": A, "wide": A if D > 128 else 0, "ssm_scan": M,
            "ssm_scan_hopper": M}
    if counts != want:
        fail(f"{cfg.name}: one prefill of {A} attention and {M} Mamba layers launched {counts}, "
             f"not {want}")
    B = prompts.shape[0]
    if toks.shape != (B, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{cfg.name}: serve_batch gave tokens of shape {toks.shape} outside the vocabulary")
    S = _prefill_len(cfg, prompts.shape[1], inputs)
    views = [torch.empty((B, S, h, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
             for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)]
    trace = _trace_prefill_and_decode(model, params, prompts, inputs, gen)
    line = {"phase": phase, "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads, D], "window": cfg.sliding_window,
            "weights": weights, "init_s": init_s, "dtype": cfg.compute_dtype, "batch": B,
            "prompt": prompts.shape[1], "prefill_rows": S, "gen": gen,
            "time_to_first_token_ms": timings["prefill_s"] * 1e3,
            "decode_ms_per_step": timings["decode_s"] / timings["decode_steps"] * 1e3,
            "decode_tokens_per_s": B * timings["decode_steps"] / timings["decode_s"],
            "peak_device_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "route": fa.route(*views, cfg.sliding_window), "launches": counts,
            "first_tokens": np.asarray(toks[0, :8]).tolist(), "trace": trace, **extra}
    emit(line)
    if after is not None:
        counts = {**counts, "model_axis": after(model, params, toks, logits, timings)}
    del params
    torch.cuda.empty_cache()
    return counts


# kernel names by what they compute, for the traces' shares of device time
_KERNEL_KINDS = (("attention_kernel", ("flash_fwd",)), ("ssm_scan", ("ssm_scan",)),
                 ("matrix_products", ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "cublas")))
# record_function ranges of the serving traces (:func:`_traced_moe`)
_TRACED_RANGES = ("moe_apply", "moe_dispatch")


def _device_time(prof) -> dict:
    """The profiler's device kernels: their total ms, each kind's ms
    (_KERNEL_KINDS; the rest is elementwise, copies, reductions), the
    device ms of the kernels launched inside each of _TRACED_RANGES (the
    MoE layers whole, and their routing and dispatch and combine tensors:
    products among them), and the ten longest by name with their count and
    ms."""
    import torch

    # the ranges' own spans on the card are annotations, not kernels
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in _TRACED_RANGES]
    if not on_card:
        fail("the trace shows no kernel on the card")
    total = sum(e.self_device_time_total for e in on_card) / 1e3
    kinds = {kind: sum(e.self_device_time_total for e in on_card
                       if any(m in e.key.lower() for m in marks)) / 1e3
             for kind, marks in _KERNEL_KINDS}
    kinds["other"] = total - sum(kinds.values())
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    ranges = {name: sum(e.device_time_total for e in prof.events()
                        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
              for name in _TRACED_RANGES}
    return {"device_kernel_ms": total, "ms_by_kind": kinds, "ranges_ms": ranges,
            "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]}


def _traced_moe():
    """Stand-ins for ``transformer.moe_apply`` and ``moe.moe_dispatch``
    that run them inside ``record_function`` ranges of those names."""
    import torch

    from repro_torch.models import moe

    def ranged(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return run
    return ranged("moe_apply", moe.moe_apply), ranged("moe_dispatch", moe.moe_dispatch)


def _trace_prefill_and_decode(model, params, prompts, inputs: dict, gen: int) -> dict:
    """One prefill of ``prompts`` (and ``inputs``, as ``serve_batch``
    takes them) and its first decode step under ``torch.profiler``, after
    the counts were read, the MoE layers in ranges (:func:`_traced_moe`):
    each one's device kernel time by kind and its longest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import decode_span
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    B, P = prompts.shape
    dev = params.embed.device
    max_len, start = decode_span(model.cfg, P, gen)
    cache = model.init_cache(B, max_len, device=dev)
    cd = getattr(torch, model.cfg.compute_dtype)
    batch = {"tokens": torch.from_numpy(prompts.astype("int64")).to(dev),
             **{k: torch.from_numpy(v).to(device=dev, dtype=cd) for k, v in inputs.items()}}
    torch.cuda.synchronize()
    originals = tr.moe_apply, moe.moe_dispatch
    tr.moe_apply, moe.moe_dispatch = _traced_moe()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits, cache = model.prefill(params, batch, cache)
            torch.cuda.synchronize()
        prefill = _device_time(prof)
        tok = logits.argmax(-1)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.decode(params, tok, cache, start)
            torch.cuda.synchronize()
        decode = {**_device_time(prof), "wall_ms_traced": (time.perf_counter() - t0) * 1e3}
    finally:
        tr.moe_apply, moe.moe_dispatch = originals
    del cache
    return {"prefill": prefill, "decode_step": decode}


def _routing_spy(seen: list):
    """A stand-in for ``transformer.moe_apply`` that records each MoE
    layer's expert choices and router probabilities (on the host) before
    computing what ``moe_apply`` computes."""
    from repro_torch.models import moe

    def spy(p, cfg, x, **kw):
        G = moe.group_count(cfg.moe, x.shape[0], x.shape[1], kw.get("groups"))
        r = moe.moe_dispatch(p, cfg, x.reshape(G, -1, cfg.d_model))
        seen.append((r.expert_ids.cpu(), r.probs.cpu()))
        return moe.moe_apply(p, cfg, x, **kw)
    return spy


def _wide_vs_cpu(dev, cfg, layers: int, prompt_len: int, moe_routing: bool,
                 inputs: dict | None = None) -> dict:
    """``cfg`` at full width with ``layers`` layers (encdec: ``layers``
    encoder and decoder layers) in float32, the same weights (drawn on the
    card from one seed, a copy moved to the CPU) on the card and on the
    CPU: a prefill of ``prompt_len`` tokens (with ``inputs``, the vlm's
    ``patch_embeds`` or encdec's ``frames``, numpy, batch 1) and
    WIDE_CPU_DECODE greedy steps at the model's positions, logits within
    CPU_RTOL / CPU_ATOL, greedy tokens equal except across ties; with
    ``moe_routing`` each MoE layer's expert choices equal wherever the
    router's k-th and (k+1)-th probabilities lie more than MOE_ROUTER_TIE
    apart."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import decode_span
    from repro_torch.models import Model
    from repro_torch.models import transformer as tr

    cfg32 = dataclasses.replace(cfg, num_layers=layers, param_dtype="float32",
                                compute_dtype="float32")
    if cfg.family == "encdec":
        cfg32 = dataclasses.replace(cfg32, decoder_layers=layers)
    model = Model(cfg32)
    t0 = time.perf_counter()
    lm_cpu = model.init(generator=torch.Generator(device=dev).manual_seed(1), device="cpu")
    lm_card = model.init(generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, prompt_len)))
    extras = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in (inputs or {}).items()}
    batches = {"cpu": {"tokens": prompt, **extras},
               "card": {k: t.to(dev) for k, t in {"tokens": prompt, **extras}.items()}}
    max_len, start = decode_span(cfg32, prompt_len, WIDE_CPU_DECODE + 1)
    caches = {"cpu": model.init_cache(1, max_len, device="cpu"),
              "card": model.init_cache(1, max_len, device=dev)}
    seen = {"cpu": [], "card": []}
    original = tr.moe_apply
    try:
        def run(side, fn):
            if moe_routing:
                tr.moe_apply = _routing_spy(seen[side])
            return fn()
        want, _ = run("cpu", lambda: model.prefill(lm_cpu, batches["cpu"], caches["cpu"]))
        got, _ = run("card", lambda: model.prefill(lm_card, batches["card"], caches["card"]))
        steps = [(got.cpu(), want)]
        tok = want.argmax(-1)
        for i in range(WIDE_CPU_DECODE):
            want, _ = run("cpu", lambda: model.decode(lm_cpu, tok, caches["cpu"], start + i))
            got, _ = run("card", lambda: model.decode(lm_card, tok.to(dev), caches["card"],
                                                      start + i))
            steps.append((got.cpu(), want))
            tok = want.argmax(-1)
    finally:
        tr.moe_apply = original
    err, ties = 0.0, 0
    for g, w in steps:
        if not bool(torch.isfinite(g).all()):
            fail(f"{cfg.name}: non-finite logits on the card")
        if not torch.allclose(g, w, rtol=CPU_RTOL, atol=CPU_ATOL):
            fail(f"{cfg.name}: card and CPU logits disagree: max err {(g - w).abs().max().item()}")
        err = max(err, (g - w).abs().max().item())
        gt, wt = int(g[0].argmax()), int(w[0].argmax())
        if gt != wt:
            if not abs(float(w[0, gt]) - float(w[0, wt])) < TIE_F32:
                fail(f"{cfg.name}: greedy tokens differ off a tie: card {gt}, CPU {wt}")
            ties += 1
    line = {"layers": layers, "dtype": "float32", "prompt": prompt_len,
            "inputs": {k: list(t.shape) for k, t in extras.items()},
            "decode_steps": WIDE_CPU_DECODE, "max_abs_err": err,
            "max_abs_logit": max(w.abs().max().item() for _, w in steps),
            "rtol": CPU_RTOL, "atol": CPU_ATOL, "greedy_ties": ties,
            "seconds": time.perf_counter() - t0}
    if moe_routing:
        k = cfg.moe.top_k
        compared = near = 0
        for (ids_c, pr_c), (ids_g, pr_g) in zip(seen["cpu"], seen["card"]):
            top = torch.sort(pr_c, dim=-1, descending=True).values
            clear = (top[..., k - 1] - top[..., k]) > MOE_ROUTER_TIE  # (G, Sg)
            if not torch.equal(ids_c[clear], ids_g[clear]):
                fail(f"{cfg.name}: the card routes tokens to other experts than the CPU")
            compared += int(clear.sum())
            near += int((~clear).sum())
        moe_layers = sum(cfg32.is_moe_layer(i) for i in range(layers))
        if len(seen["cpu"]) != moe_layers * (1 + WIDE_CPU_DECODE) or compared == 0:
            fail(f"{cfg.name}: routing recorded {len(seen['cpu'])} times, {compared} compared")
        line["routing"] = {"tokens_compared": compared, "near_ties_skipped": near,
                           "tie": MOE_ROUTER_TIE}
    del lm_cpu, lm_card, caches, batches
    torch.cuda.empty_cache()
    return line


def dense_serve_phase(dev) -> dict:
    """Phase 27: phi3-medium-14b, h2o-danube-3-4b and gemma-7b at full width
    and depth; returns the prefill launches of the new kernel shapes."""
    import numpy as np

    from repro_torch.configs import get_config

    rng = np.random.default_rng(3)
    launches = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        prompt = DANUBE_CPU_PROMPT if cfg.sliding_window else WIDE_CPU_PROMPT
        vs_cpu = _wide_vs_cpu(dev, cfg, WIDE_CPU_LAYERS, prompt, False)
        prompts = rng.integers(0, cfg.vocab_size, (WIDE_BATCH, WIDE_PROMPT)).astype(np.int32)
        launches[arch] = _serve_arch(dev, cfg, prompts, "dense_serve", {"vs_cpu": vs_cpu})
    return launches


def moe_serve_phase(dev) -> None:
    """Phase 28: mixtral-8x7b and phi3.5-moe at full width and MOE_LAYERS of
    their 32 layers, the card against the CPU at 1 layer, and SlotBatcher
    at mixtral's width."""
    import numpy as np

    from repro_torch.configs import get_config

    rng = np.random.default_rng(4)
    for arch in MOE_ARCHS:
        full = get_config(arch)
        vs_cpu = _wide_vs_cpu(dev, full, MOE_CPU_LAYERS, WIDE_CPU_PROMPT, True)
        cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
        prompts = rng.integers(0, cfg.vocab_size, (WIDE_BATCH, WIDE_PROMPT)).astype(np.int32)
        _serve_arch(dev, cfg, prompts, "moe_serve", {
            "reduced": {"num_layers": [full.num_layers, MOE_LAYERS],
                        "why": "memory: the full depth's bf16 weights exceed the card's 80 GB"},
            "experts": [full.moe.num_experts, full.moe.top_k], "vs_cpu": vs_cpu})

    # continuous batching at mixtral's width, 2 layers, float32
    _batcher_vs_standalone(dev, dataclasses.replace(get_config("mixtral-8x7b"),
                                                    num_layers=MOE_BATCH_LAYERS),
                           "moe_batching", {})


def _batcher_vs_standalone(dev, cfg, phase: str, extra: dict) -> None:
    """``SlotBatcher`` over ``cfg`` (its width and depth) in float32, the
    weights drawn on the card from seed 5: MOE_BATCH_REQUESTS requests of
    MOE_BATCH_PROMPT_LENS prompt tokens and MOE_BATCH_NEW new ones over
    BATCH_SLOTS slots, each request's tokens equal to its standalone serve
    except across ties.  Emits the phase line."""
    import numpy as np
    import torch

    from repro_torch.models import Model
    from repro_torch.serve.scheduler import SlotBatcher

    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    lm = model.init(generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    brng = np.random.default_rng(5)
    lens = brng.integers(MOE_BATCH_PROMPT_LENS[0], MOE_BATCH_PROMPT_LENS[1] + 1, MOE_BATCH_REQUESTS)
    max_new = brng.integers(MOE_BATCH_NEW[0], MOE_BATCH_NEW[1] + 1, MOE_BATCH_REQUESTS)
    prompts = [brng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    batcher = SlotBatcher(model, lm, batch_slots=BATCH_SLOTS, max_len=MOE_BATCH_MAX_LEN)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, int(m))
    t0 = time.perf_counter()
    done = batcher.run()
    batch_s = time.perf_counter() - t0
    if [r.rid for r in done] != list(range(MOE_BATCH_REQUESTS)) or not all(r.done for r in done):
        fail(f"{cfg.name}: the batcher completed {[r.rid for r in done]}")
    diverged, equal = [], 0
    for req, p, m in zip(done, prompts, max_new):
        want, lgs = _greedy_standalone(model, lm, p, int(m), MOE_BATCH_MAX_LEN, dev)
        tie = _tie_diverged(req.out, want, lgs, TIE_F32)
        if tie is None:
            equal += 1
        else:
            diverged.append({"rid": req.rid, **tie})
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": "float32", "slots": BATCH_SLOTS,
          "requests": MOE_BATCH_REQUESTS, "max_len": MOE_BATCH_MAX_LEN,
          "prompt_lens": lens.tolist(), "max_new": max_new.tolist(),
          "tokens": int(sum(len(r.out) for r in done)), "equal_to_standalone": equal,
          "seconds": batch_s, "ties": diverged, **extra})
    del lm, batcher
    torch.cuda.empty_cache()

def family_kernel_phase(dev, sm_clock_hz: float) -> list:
    """Phase 26, the new families' shapes (FAMILY_SHAPES): the forward on
    the model's strided (B, S, H, D) views in bf16 through the Hopper
    kernel (one ``hopper_launches`` each) against its plain version within
    WIDE_RULE, and CUDA-event times, in turns, of the kernel and of
    ``scaled_dot_product_attention`` beside the bound.  The plain version
    runs one batch row at a time (internvl2's scores at once would take 16
    GB a copy).  Returns the kernels-line entries (their launches filled
    in by phases 29-30)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    entries, phase = [], {}
    for shape, (B, H, Hkv, S, D, causal) in FAMILY_SHAPES.items():
        q, k, v = _wide_inputs(B, H, Hkv, S, D, torch.bfloat16, dev, gen)
        route = fa.route(q, k, v, None)
        if route != "hopper":
            fail(f"the {shape} shape routes to {route}, not hopper")
        before = fa.hopper_launches
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if fa.hopper_launches != before + 1:
            fail(f"the {shape} shape moved the Hopper count by {fa.hopper_launches - before}")

        def plain(q=q, k=k, v=v, causal=causal):
            return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                                      causal=causal) for b in range(q.shape[0])])
        want = plain()
        err = _wide_err(got, want, "bfloat16")
        if not err["of_rule"] <= 1.0:
            fail(f"flash_attention disagrees with its plain version at {shape}: {err}")
        del got

        def kernel(q=q, k=k, v=v, causal=causal):
            return fa.flash_attention(q, k, v, causal=causal)

        def library(q=q, k=k, v=v, causal=causal):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=H != Hkv)
        lib_err = _wide_err(library(), want, "bfloat16")
        del want
        fns = {"kernel": kernel, "library": library}
        turns = {key: [] for key in fns}
        for order in (tuple(fns), tuple(reversed(fns))):
            for key in order:
                turns[key].append(event_ms(fns[key], calls=WIDE_TIMED_CALLS, groups=3))
        plain_ms = event_ms(plain, calls=1, groups=3)
        pairs = B * H * (_visible_pairs(S, None) if causal else S * S)
        moved = (2 * B * H * S * D + 2 * B * Hkv * S * D) * 2  # q, k, v read; o written
        flop = 4 * D * pairs
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flop / BF16_FLOP_PER_S * 1e3
        exp_ms = pairs / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3  # one per pair
        ms = statistics.mean(turns["kernel"])
        library_ms = statistics.mean(turns["library"])
        bound_ms = max(bytes_ms, ops_ms, exp_ms)
        bound_by = "bytes" if bytes_ms >= max(ops_ms, exp_ms) else "operations"
        kernel_name = f"flash_fwd_hopper<{D}>"
        parts = {"bytes": bytes_ms, "tensor_cores": ops_ms, "exponentials": exp_ms}
        entries.append({
            "name": f"flash_attention_{shape}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:86", "kernel": kernel_name,
            "launches": None, "max_abs_err": err["max_abs_err"], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention", "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_parts_ms": parts, "bound_share": bound_ms / ms,
            "library_over_kernel": library_ms / ms, "shape": [B, H, Hkv, S, S, D],
            "causal": causal, "dtype": "bfloat16", "bytes": moved, "flop": flop,
            "visible_pairs": pairs})
        phase[shape] = {"shape": [B, H, Hkv, S, S, D], "causal": causal, "error": err,
                        "library_error": lib_err, "ms_turns": turns, "plain_ms": plain_ms,
                        "plain": "one batch row at a time", "bound_ms": bound_ms,
                        "bound_by": bound_by, "bound_parts_ms": parts,
                        "bound_share": bound_ms / ms, "kernel": kernel_name}
        del q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "family_kernels", "rule": {"max_abs": WIDE_RULE["bfloat16"][0],
                                              "rms_of_rms_want": WIDE_RULE["bfloat16"][1]},
          **phase})
    return entries


def encdec_serve_phase(dev) -> dict:
    """Phase 29: whisper-large-v3 at full width and depth (32 encoder and
    32 decoder layers), first at FAMILY_CPU_LAYERS + FAMILY_CPU_LAYERS in
    float32 on the card against the CPU over cross_len frames, then
    ``serve_batch`` of ENCDEC_BATCH requests of cross_len frames and
    ENCDEC_GEN tokens in bf16: every encoder layer's attention through the
    Hopper kernel, non-causal.  Returns the prefill's launch counts."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC_ARCH)
    rng = np.random.default_rng(7)
    cpu_frames = rng.normal(0, 1, (1, cfg.cross_len, cfg.d_model)).astype(np.float32)
    vs_cpu = _wide_vs_cpu(dev, cfg, FAMILY_CPU_LAYERS, cfg.cross_len, False,
                          {"frames": cpu_frames})
    frames = rng.normal(0, 1, (ENCDEC_BATCH, cfg.cross_len, cfg.d_model)).astype(np.float32)
    # the prompt's tokens are not read (the decoder starts at BOS), as in the reference
    prompts = rng.integers(0, cfg.vocab_size, (ENCDEC_BATCH, cfg.cross_len)).astype(np.int32)
    return _serve_arch(dev, cfg, prompts, "encdec_serve", {
        "decoder_layers": cfg.decoder_layers, "frames": [ENCDEC_BATCH, cfg.cross_len],
        "vs_cpu": vs_cpu}, inputs={"frames": frames}, gen=ENCDEC_GEN)


def vlm_serve_phase(dev) -> dict:
    """Phase 30: internvl2-26b at full width and depth (48 layers), first
    at FAMILY_CPU_LAYERS layers in float32 on the card against the CPU
    (its 256 patch embeddings and WIDE_CPU_PROMPT tokens), then
    ``serve_batch`` of VLM_BATCH requests of 256 patch embeddings and
    VLM_TEXT tokens and WIDE_GEN tokens in bf16: every layer's prefill
    attention through the Hopper kernel over the 4,608 positions.  Returns
    the prefill's launch counts."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(VLM_ARCH)
    rng = np.random.default_rng(8)
    cpu_patches = rng.normal(0, 1, (1, cfg.num_patches, cfg.d_model)).astype(np.float32)
    vs_cpu = _wide_vs_cpu(dev, cfg, FAMILY_CPU_LAYERS, WIDE_CPU_PROMPT, False,
                          {"patch_embeds": cpu_patches})
    patches = rng.normal(0, 1, (VLM_BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT)).astype(np.int32)
    return _serve_arch(dev, cfg, prompts, "vlm_serve", {
        "patches": [VLM_BATCH, cfg.num_patches], "vs_cpu": vs_cpu},
        inputs={"patch_embeds": patches})


def _attention_work(B, H, Hkv, S, D, pairs: int) -> dict:
    """(bytes, flop) of the training attention kernels over ``pairs``
    visible (query, key) pairs per query head, bf16: each input read once,
    each output written once (phase 11's reckoning)."""
    qb, kb = B * H * S * D * 2, B * Hkv * S * D * 2  # q (= dO, o, dq) and k (= v, dk, dv)
    rows = B * H * S * 4  # float32 lse (= delta)
    return {"fwd": (qb + 2 * kb + qb + rows, 4 * B * H * D * pairs),
            "dq": (qb + 2 * kb + qb + 2 * rows + qb, 6 * B * H * D * pairs),
            "dkv": (qb + 2 * kb + qb + 2 * rows + 2 * kb, 8 * B * H * D * pairs)}


def _time_training_attention(q, k, v, dout, lse, delta, window, out) -> dict:
    """CUDA-event ms per call, in turns (the order, then reversed), of the
    forward with lse, dq and dk/dv kernels and of SDPA's forward and its
    backward alone (``autograd.grad`` over one saved forward) on these
    inputs; then the plain versions'."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    fns = {  # the kernels' inputs need no gradient: only SDPA's backward records a graph
        "fwd": lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True, window=window),
        "dq": lambda: fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta, window=window),
        "dkv": lambda: fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, window=window),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                           enable_gqa=True),
        "sdpa_bwd": lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), dout, retain_graph=True),
    }
    turns = {key: [] for key in fns}
    for order in (tuple(fns), tuple(reversed(fns))):
        for key in order:
            turns[key].append(event_ms(fns[key], calls=WIDE_TIMED_CALLS, groups=3))
    plain = {"fwd": event_ms(lambda: ref.flash_attention_fwd_lse_ref(q, k, v, causal=True,
                                                                     window=window), 1, 3),
             "bwd": event_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                                 causal=True, window=window), 1, 3)}
    del qg, kg, vg, o_sdpa
    return {"turns": turns, "ms": {key: statistics.mean(t) for key, t in turns.items()},
            "plain_ms": plain}


def _bwd256_mutants(q, k, v, dout, lse, delta, wants) -> dict:
    """Run the unedited backward and each of BWD256_MUTANTS, built by
    :func:`_build_mutants`, on gemma's training inputs; each one's dq, dk
    and dv errors over the training rule, as :func:`_bwd_mutants` gives
    them at head_dim 64."""
    import torch

    from repro_torch.kernels import flash_attention_bwd as fab

    libs, out_dir = _build_mutants("flash_attention_bwd", BWD256_MUTANTS, fab.bind)
    result = {}
    for name, lib in libs.items():
        (dq,), kq = fab.launch(lib, False, q, k, v, dout, lse, delta, True, None)
        (dk, dv), kkv = fab.launch(lib, True, q, k, v, dout, lse, delta, True, None)
        torch.cuda.synchronize()
        if kq != "hopper" or kkv != "hopper":
            fail(f"the head_dim 256 mutation check ran the {kq} and {kkv} kernels")
        result[name] = {n: tuple(x if math.isfinite(x) else 1e30 for x in _rms_err(g, w))
                        for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), wants)}
        del dq, dk, dv
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def wide_train_kernel_phase(dev, sm_clock_hz: float, sdpa_bwd_kernels: list) -> dict:
    """Phase 31: the training attention kernels at gemma-7b's training
    shape, q, k, v and dO (4, 16, 2,048, 256) bf16, causal, as the model's
    strided (B, S, H, D) views, against their plain versions by phase 11's
    training rule, all three through the Hopper kernels; the backward
    sweep at head_dim 256 (WIDE_BWD_SWEEP x BWD_MASKS) in bf16 (the Hopper
    kernels, and the ``mma.sync`` ones at a stride TMA refuses) and in
    float32, within BWD_TOL; the mutation check (BWD256_MUTANTS); CUDA-event
    times in turns with SDPA's forward and backward, the plain versions'
    and the bounds.  Returns the kernels-line entries of dq and dk/dv
    (their launches filled in by phase 32)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref

    cfg = get_config(GEMMA_ARCH)
    B, S, H, Hkv, D = TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(31)
    worst, routes = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for b, h, hkv, s, t, d in WIDE_BWD_SWEEP:
            x = [torch.randn(shape, generator=gen).to(dev, dtype)
                 for shape in ((b, h, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, h, s, d))]
            variants = {name: x}
            if dtype == torch.bfloat16:
                variants[f"{name}_tma_refused"] = [_tma_refused(t_) for t_ in x]
            for key, (q, k, v, dout) in variants.items():
                route = fab.route(q, k, v, dout)
                want_route = {"float32": "f32", "bfloat16": "hopper",
                              "bfloat16_tma_refused": "bf16"}[key]
                if route != want_route:
                    fail(f"the head_dim 256 sweep's {key} inputs route to {route}, not {want_route}")
                routes[key] = route
                for causal, window in BWD_MASKS:
                    errs, _ = attention_errors(q, k, v, dout, causal, window,
                                               lambda g, w: _scaled_err(g, w, *BWD_TOL[name]))
                    for kern, e in errs.items():
                        old = worst.get((kern, key), (0.0, 0.0))
                        worst[(kern, key)] = (max(old[0], e[0]), max(old[1], e[1]))
            del x, variants
    bad = {f"{k}/{n}": e for (k, n), e in worst.items() if not e[1] <= 1.0}
    if bad:
        fail(f"training attention kernels disagree with their plain versions at head_dim 256: {bad}")

    bf = torch.bfloat16
    q, k, v = (torch.randn((B, S, n, D), generator=gen).to(dev, bf).transpose(1, 2)
               for n in (H, Hkv, Hkv))
    dout = torch.randn((B, H, S, D), generator=gen).to(dev, bf)
    counts = (fa.hopper_launches, fa.wide_launches, fab.flash_attention_bwd_dq.hopper_launches,
              fab.flash_attention_bwd_dkv.hopper_launches)
    path, (out, lse, delta) = attention_errors(q, k, v, dout, True, None, _rms_err)
    moved = (fa.hopper_launches - counts[0], fa.wide_launches - counts[1],
             fab.flash_attention_bwd_dq.hopper_launches - counts[2],
             fab.flash_attention_bwd_dkv.hopper_launches - counts[3])
    if moved != (1, 1, 1, 1):
        fail(f"gemma's training shape moved the Hopper (forward, wide, dq, dk/dv) counts by {moved}")
    if not all(e[1] <= 1.0 for e in path.values()):
        fail(f"training attention kernels disagree with their plain versions at gemma's training "
             f"shape: {path}")
    path_sweep_tol, _ = attention_errors(q, k, v, dout, True, None,
                                         lambda g, w: _scaled_err(g, w, *BWD_TOL["bfloat16"]))
    if not all(e[1] <= 1.0 for e in path_sweep_tol.values()):
        fail(f"training attention kernels exceed the sweep's bf16 tolerance at gemma's training "
             f"shape: {path_sweep_tol}")
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    mutants = _bwd256_mutants(q, k, v, dout, lse, delta, wants)
    del wants
    failing = {n: max(e[1] for e in errs.values()) for n, errs in mutants.items()}
    weak = {n: r for n, r in failing.items() if n != "shipped" and not r >= FLASH_MUTANT_MIN}
    if weak:
        fail(f"mutants of the head_dim 256 backward pass the rule with less than "
             f"{FLASH_MUTANT_MIN}x: {weak}")
    if not failing["shipped"] <= 1.0:
        fail(f"the unedited backward built as a mutant fails the rule at head_dim 256: "
             f"{mutants['shipped']}")
    timed = _time_training_attention(q, k, v, dout, lse, delta, None, out)
    ms = timed["ms"]
    pairs = S * (S + 1) // 2
    work = _attention_work(B, H, Hkv, S, D, pairs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_ms = B * H * pairs / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3
    bounds = {}
    for key, (nbytes, flop) in work.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flop / BF16_FLOP_PER_S * 1e3
        bounds[key] = {"bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "bound_parts_ms": {"bytes": bytes_ms, "tensor_cores": ops_ms,
                                          "exponentials": exp_ms},
                       "bytes": nbytes, "flop": flop}
    src = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    sdpa_bwd_name = "scaled_dot_product_attention backward alone (dq, dk and dv in one call)"
    entries = {}
    for key, name, replaces, kernel in (
            ("dq", "flash_attention_bwd_dq_d256", "src/repro/kernels/flash_attention_bwd.py:81",
             "flash_bwd_dq_hopper<256>"),
            ("dkv", "flash_attention_bwd_dkv_d256", "src/repro/kernels/flash_attention_bwd.py:115",
             "flash_bwd_dkv_hopper<256>")):
        err = max(path[key][0], *(e[0] for (kern, _), e in worst.items() if kern == key))
        entries[key] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces, "kernel": kernel,
            "launches": None, "max_abs_err": err, "ms": ms[key], "kernel_ms": ms[key],
            "plain_ms": timed["plain_ms"]["bwd"],
            "plain": "flash_attention_bwd_ref (dq, dk and dv in one call)",
            "library_ms": ms["sdpa_bwd"], "library": sdpa_bwd_name,
            **bounds[key], "bound_share": bounds[key]["bound_ms"] / ms[key],
            "shape": [B, H, Hkv, S, S, D], "dtype": "bfloat16", "want_rms": path[key][2],
            "mutant_err_of_rule": failing}
    emit({"phase": "wide_train_kernels", "arch": GEMMA_ARCH, "shape": [B, H, Hkv, S, S, D],
          "sweep_errors": {f"{k}/{n}": e for (k, n), e in worst.items()}, "sweep_routes": routes,
          "tolerance": BWD_TOL, "training_shape_errors": path,
          "training_shape_errors_of_sweep_tol": path_sweep_tol,
          "training_shape_tolerance": {"rms": TRAIN_TOL_RMS, "rel": TRAIN_TOL_REL},
          "hopper_counts_moved": moved, "mutants": mutants,
          "mutant_min_err_of_rule": min(r for n, r in failing.items() if n != "shipped"),
          "mutant_min_required": FLASH_MUTANT_MIN, "ms_turns": timed["turns"], "ms": ms,
          "plain_ms": timed["plain_ms"], "bounds": bounds,
          "bound_share": {key: bounds[key]["bound_ms"] / ms[key] for key in bounds},
          "sdpa_bwd_over_dq_plus_dkv": ms["sdpa_bwd"] / (ms["dq"] + ms["dkv"]),
          "sdpa_bwd_kernels": sdpa_bwd_kernels})
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    return entries


def _wide_train_vs_cpu(dev, cfg, layers: int) -> dict:
    """One forward and backward through the train step's loss
    (``make_loss_fn``) with ``cfg`` at full width and ``layers`` layers in
    float32, 1 x WIDE_TRAIN_CPU_SEQ tokens, on the card and on the CPU from
    the same weights (drawn once on the card from a seeded generator, a
    copy moved to the CPU): phase 12's rule, the loss (and the router's aux
    losses) within CPU_LOSS_RTOL, the gradient norm and every gradient
    (|g_card - g_cpu| / |g_cpu| in the 2-norm) within CPU_GNORM_RTOL.  The
    line counts the scan backward's launches on the card's side."""
    import numpy as np
    import torch

    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models import Model
    from repro_torch.precision import full_float32_matmul
    from repro_torch.train.step import make_loss_fn

    cfg32 = dataclasses.replace(cfg, num_layers=layers, param_dtype="float32",
                                compute_dtype="float32")
    model = Model(cfg32)
    t0 = time.perf_counter()
    lm_card = model.init(generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    lm_cpu = copy.deepcopy(lm_card).to("cpu")
    seq = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, WIDE_TRAIN_CPU_SEQ + 1))
    batch = {"tokens": torch.from_numpy(seq[:, :-1]), "labels": torch.from_numpy(seq[:, 1:])}
    loss_fn = make_loss_fn(model)
    res = {}
    for side, lm in (("card", lm_card), ("cpu", lm_cpu)):
        device = dev if side == "card" else torch.device("cpu")
        b = {k: t.to(device) for k, t in batch.items()}
        params = dict(lm.named_parameters())
        scans, hopper = ssm.ssm_scan_bwd.launches, ssm.hopper_bwd_launches
        with torch.enable_grad(), full_float32_matmul():
            total, metrics, aux = loss_fn(lm, b)
            grads = torch.autograd.grad(total, list(params.values()))
        res[side] = {"loss": float(total.detach()), "scan_bwd": ssm.ssm_scan_bwd.launches - scans,
                     "scan_bwd_hopper": ssm.hopper_bwd_launches - hopper,
                     "aux": {k: float(t.detach()) for k, t in (aux or {}).items()},
                     "grads": {n: g.detach().cpu() for n, g in zip(params, grads)}}
        del grads, total, metrics, aux
    card, cpu = res["card"], res["cpu"]
    loss_rel = abs(card["loss"] / cpu["loss"] - 1)
    aux_rel = {k: abs(card["aux"][k] / cpu["aux"][k] - 1) for k in cpu["aux"]}
    grad_rel = {n: float((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30))
                for n, g in cpu["grads"].items()}
    norm = {side: math.sqrt(sum(float(g.double().square().sum()) for g in r["grads"].values()))
            for side, r in res.items()}
    gnorm_rel = abs(norm["card"] / norm["cpu"] - 1)
    worst_grad = max(grad_rel, key=grad_rel.get)
    if not (loss_rel <= CPU_LOSS_RTOL and all(r <= CPU_LOSS_RTOL for r in aux_rel.values())):
        fail(f"{cfg.name}: the card's and the CPU's losses disagree: {card['loss']} vs "
             f"{cpu['loss']}, aux {card['aux']} vs {cpu['aux']}")
    if not (gnorm_rel <= CPU_GNORM_RTOL and grad_rel[worst_grad] <= CPU_GNORM_RTOL):
        fail(f"{cfg.name}: the card's and the CPU's gradients disagree: grad norm {norm}, "
             f"{worst_grad} off by {grad_rel[worst_grad]}")
    line = {"layers": layers, "dtype": "float32", "tokens": [1, WIDE_TRAIN_CPU_SEQ],
            "loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel_err": loss_rel,
            "aux_card": card["aux"], "aux_cpu": cpu["aux"], "aux_rel_err": aux_rel,
            "grad_norm_card": norm["card"], "grad_norm_cpu": norm["cpu"],
            "grad_norm_rel_err": gnorm_rel, "grads_compared": len(grad_rel),
            "worst_grad": [worst_grad, grad_rel[worst_grad]],
            "rtol": {"loss": CPU_LOSS_RTOL, "grad": CPU_GNORM_RTOL},
            "scan_bwd_launches_on_the_card": card["scan_bwd"],
            "scan_bwd_hopper_launches_on_the_card": card["scan_bwd_hopper"],
            "seconds": time.perf_counter() - t0}
    del lm_card, lm_cpu, res, card, cpu
    torch.cuda.empty_cache()
    return line


# kernel names by what they compute, for a training step's shares of device time
_TRAIN_KERNEL_KINDS = (("attention_forward", ("flash_fwd",)),
                       ("attention_backward", ("flash_bwd",)),
                       ("scan_forward", ("ssm_scan_hopper", "ssm_scan_train_hopper")),
                       ("scan_backward", ("ssm_scan_bwd", "sum_over_middle")),
                       ("matrix_products", ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "cublas")))


def _train_arch(dev, cfg, phase: str, extra: dict) -> dict:
    """Train ``cfg`` (at full width, its depth as given) in bf16 with
    ``remat="full"`` through ``build_loader`` and ``train_loop`` for
    WIDE_TRAIN_WARMUP + WIDE_TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens, the weights drawn on the card from a seeded generator, with the
    attention and scan kernels' counts set to 0 just before and read just
    after: per step 2 forwards with lse an attention layer (the
    recomputation), one dq and one dk/dv, all through the Hopper kernels,
    and 2 scans a Mamba layer (``ssm_scan_train_hopper``, which writes the
    backward's checkpoints) and one scan backward (``ssm_scan_bwd_hopper``,
    given them).  The loss finite and falling; step ms, tokens/s,
    peak memory, each step's metrics (with ``moe_lb_loss`` where the config
    has MoE layers); then one step under ``torch.profiler``: device kernel
    ms by kind.  Emits the phase line; returns the launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch.train import build_loader, train_loop
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig, constant_lr
    from repro_torch.train.step import make_train_state, make_train_step

    cfg = dataclasses.replace(cfg, remat="full")
    model = Model(cfg)
    corpus = os.path.join(HERE, "build", "chip_smoke_corpus")
    loader = build_loader(corpus, TRAIN_SEQ, TRAIN_BATCH, n_tokens=TRAIN_CORPUS_TOKENS,
                          vocab_size=min(cfg.vocab_size, 1024))
    t0 = time.perf_counter()
    state = make_train_state(model, AdamWConfig(lr=constant_lr(3e-4)), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() for p in state["params"].parameters())
    blocks = list(state["params"].blocks)
    n_attn = sum(hasattr(blk, "attn") for blk in blocks)
    n_scan = sum(hasattr(blk, "ssm") for blk in blocks)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention_fwd_lse.launches = fa.hopper_launches = fa.wide_launches = 0
    for entry in (fab.flash_attention_bwd_dq, fab.flash_attention_bwd_dkv):
        entry.launches = entry.hopper_launches = 0
    fab.hopper_launches = 0
    ssm.ssm_scan.launches = ssm.hopper_launches = ssm.ssm_scan_bwd.launches = 0
    ssm.hopper_bwd_launches = ssm.ssm_scan_bwd.with_checkpoints = ssm.ssm_scan_train.checkpoints = 0
    total = WIDE_TRAIN_WARMUP + WIDE_TRAIN_STEPS
    timings = {}
    t0 = time.perf_counter()
    run = train_loop(model, loader, steps=total, log_every=1, device=dev, state=state,
                     timings=timings)
    wall = time.perf_counter() - t0
    L, D = cfg.num_layers, cfg.resolved_head_dim
    launches = {"fwd": fa.flash_attention_fwd_lse.launches,
                "dq": fab.flash_attention_bwd_dq.launches,
                "dkv": fab.flash_attention_bwd_dkv.launches,
                "scan_fwd": ssm.ssm_scan.launches, "scan_bwd": ssm.ssm_scan_bwd.launches}
    # the scans' forwards and backwards on the hopper routes, the forwards
    # writing the checkpoints that the backwards read
    hopper = {"fwd": fa.hopper_launches, "dq": fab.flash_attention_bwd_dq.hopper_launches,
              "dkv": fab.flash_attention_bwd_dkv.hopper_launches,
              "scan_fwd": ssm.ssm_scan_train.checkpoints,
              "scan_bwd": ssm.ssm_scan_bwd.with_checkpoints}
    if (ssm.hopper_launches, ssm.hopper_bwd_launches) != (launches["scan_fwd"],
                                                          launches["scan_bwd"]):
        fail(f"{cfg.name}: {ssm.hopper_launches} of {launches['scan_fwd']} scans and "
             f"{ssm.hopper_bwd_launches} of {launches['scan_bwd']} scan backwards on the hopper "
             f"routes")
    per_step = {"fwd": 2 * n_attn, "dq": n_attn, "dkv": n_attn, "scan_fwd": 2 * n_scan,
                "scan_bwd": n_scan}
    want = {key: n * total for key, n in per_step.items()}
    if launches != want or hopper != want:
        fail(f"{cfg.name}: the training kernels launched {launches} times ({hopper} through the "
             f"Hopper kernels, the scans' with checkpoints) in {total} steps; need {per_step} a "
             f"step, all Hopper")
    if fab.hopper_launches != hopper["dq"] + hopper["dkv"]:
        fail(f"{cfg.name}: the module counts {fab.hopper_launches} Hopper backward launches")
    if fa.wide_launches != (want["fwd"] if D > 128 else 0):
        fail(f"{cfg.name}: {fa.wide_launches} forwards counted at head_dim over 128")
    metrics = run["metrics"]
    losses = [m["loss"] for m in metrics]
    if len(losses) != total or not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name}: non-finite or missing losses: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name}: loss did not fall: {losses[0]} at the first step, {losses[-1]} at the last")
    if cfg.moe is not None and not all(math.isfinite(m["moe_lb_loss"]) for m in metrics):
        fail(f"{cfg.name}: non-finite moe_lb_loss: {[m.get('moe_lb_loss') for m in metrics]}")
    peak = torch.cuda.max_memory_allocated(dev)
    step_s = timings["step_s"]
    timed = sorted(step_s[WIDE_TRAIN_WARMUP:])
    med = statistics.median(timed)
    timed_wall = timings["end"][-1] - timings["end"][WIDE_TRAIN_WARMUP - 1]

    step_fn = make_train_step(model, AdamWConfig(lr=constant_lr(3e-4), weight_decay=0.01))
    tb = {k: torch.from_numpy(np.asarray(next(iter(loader))[k])).to(dev) for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(run["final_state"], tb)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        fail(f"{cfg.name}: the traced step shows no kernel on the card")
    kernel_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    kinds = {kind: sum(e.self_device_time_total for e in on_card
                       if any(m in e.key.lower() for m in marks)) / 1e3
             for kind, marks in _TRAIN_KERNEL_KINDS}
    kinds["other"] = kernel_ms - sum(kinds.values())
    attn = {}
    for key, pat in (("fwd", "flash_fwd_hopper"), ("dq", "flash_bwd_dq_hopper"),
                     ("dkv", "flash_bwd_dkv_hopper"), ("scan_fwd", "ssm_scan_train_hopper"),
                     ("scan_bwd", "ssm_scan_bwd_hopper")):
        mine = [e for e in on_card if pat in e.key]
        n = sum(e.count for e in mine)
        # The profiler drops kernel records where a step launches many
        # kernels (PERF.md §7; a Mamba step's elementwise passes): the
        # scan's kernels, whose launches the wrappers counted exactly
        # above, must show at least once and at most that often; the
        # attention kernels exactly as counted.
        if n != per_step[key] and not (key.startswith("scan") and 0 < n <= per_step[key]):
            fail(f"{cfg.name}: the traced step shows {n} launches of {pat}, not {per_step[key]}")
        if n:
            attn[key] = {"count": n, "launched": per_step[key],
                         "ms_per_launch": sum(e.self_device_time_total for e in mine) / 1e3 / n}
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    keep = ("loss", "ce_loss", "z_loss", "moe_lb_loss", "grad_norm", "lr")
    emit({"phase": phase, "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads, D], "window": cfg.sliding_window,
          "attention_layers": n_attn, "mamba_layers": n_scan,
          "weights": weights, "init_s": init_s, "dtype": cfg.compute_dtype, "remat": cfg.remat,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "corpus_vocab": min(cfg.vocab_size, 1024),
          "warmup_steps": WIDE_TRAIN_WARMUP, "timed_steps": WIDE_TRAIN_STEPS,
          "step_ms_median": med * 1e3, "step_ms_max": timed[-1] * 1e3,
          "step_ms_first": step_s[0] * 1e3, "wall_s": wall,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
          "wall_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * WIDE_TRAIN_STEPS / timed_wall,
          "peak_device_mem_gb": peak / 1e9,
          "launches_per_step": {k: v // total for k, v in launches.items()},
          "hopper_launches_per_step": {k: v // total for k, v in hopper.items()},
          "metrics": [{k: m[k] for k in keep if k in m} for m in metrics],
          "traced_step_s": traced_s, "traced_step_device_kernel_ms": kernel_ms,
          "traced_step_device_busy_share": kernel_ms / 1e3 / traced_s,
          "traced_step_ms_by_kind": kinds, "traced_attention": attn,
          "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
          **extra})
    del run, state, step_fn, tb, loader
    torch.cuda.empty_cache()
    return launches


def gemma_train_phase(dev) -> dict:
    """Phase 32: gemma-7b's training at full width (head_dim 256) and
    GEMMA_TRAIN_LAYERS of its 28 layers, first at 2 layers in float32 on
    the card against the CPU; returns the attention kernels' launches."""
    from repro_torch.configs import get_config

    full = get_config(GEMMA_ARCH)
    vs_cpu = _wide_train_vs_cpu(dev, full, WIDE_TRAIN_CPU_LAYERS[GEMMA_ARCH])
    return _train_arch(dev, dataclasses.replace(full, num_layers=GEMMA_TRAIN_LAYERS),
                       "gemma_train", {
        "reduced": {"num_layers": [full.num_layers, GEMMA_TRAIN_LAYERS],
                    "why": "memory: the full depth's weights, gradients and AdamW moments need "
                           "102 GB"},
        "vs_cpu": vs_cpu})


def moe_train_phase(dev, sm_clock_hz: float) -> dict:
    """Phase 33: mixtral-8x7b's training at full width and
    MIXTRAL_TRAIN_LAYERS of its 32 layers, first at 1 layer in float32 on
    the card against the CPU; then the training attention kernels at its
    shape, q (4, 32, 2,048, 128) over k and v (4, 8, 2,048, 128), causal
    under its 4,096-token window, against their plain versions by the
    training rule and timed in turns with SDPA, beside the bound and
    ``ptxas``'s spill of ``flash_bwd_dkv_hopper<128>``.  Returns the
    attention kernels' launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_bwd as fab

    full = get_config(MIXTRAL_ARCH)
    B, S, H, Hkv, D = TRAIN_BATCH, TRAIN_SEQ, full.num_heads, full.num_kv_heads, \
        full.resolved_head_dim
    window = full.sliding_window
    gen = torch.Generator().manual_seed(33)
    q, k, v = (torch.randn((B, S, n, D), generator=gen).to(dev, torch.bfloat16).transpose(1, 2)
               for n in (H, Hkv, Hkv))
    dout = torch.randn((B, H, S, D), generator=gen).to(dev, torch.bfloat16)
    if fab.route(q, k, v, dout, window) != "hopper":
        fail(f"mixtral's training shape routes to {fab.route(q, k, v, dout, window)}")
    path, (out, lse, delta) = attention_errors(q, k, v, dout, True, window, _rms_err)
    if not all(e[1] <= 1.0 for e in path.values()):
        fail(f"training attention kernels disagree with their plain versions at mixtral's "
             f"training shape: {path}")
    timed = _time_training_attention(q, k, v, dout, lse, delta, window, out)
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    pairs = _visible_pairs(S, window)
    work = _attention_work(B, H, Hkv, S, D, pairs)
    bounds = {key: max(nb / HBM_BYTES_PER_S, fl / BF16_FLOP_PER_S) * 1e3
              for key, (nb, fl) in work.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_ms = B * H * pairs / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3
    ptxas = {k: v_ for k, v_ in _build.ptxas_report("flash_attention_bwd").items()
             if "flash_bwd_dkv_hopperILi128E" in k}
    kernels = {"shape": [B, H, Hkv, S, S, D], "window": window, "errors": path,
               "ms_turns": timed["turns"], "ms": timed["ms"], "plain_ms": timed["plain_ms"],
               "bound_ms": bounds, "exponentials_ms": exp_ms,
               "bound_share": {key: bounds[key] / timed["ms"][key] for key in bounds},
               "flash_bwd_dkv_hopper_128_ptxas": ptxas}
    vs_cpu = _wide_train_vs_cpu(dev, full, WIDE_TRAIN_CPU_LAYERS[MIXTRAL_ARCH])
    return _train_arch(dev, dataclasses.replace(full, num_layers=MIXTRAL_TRAIN_LAYERS),
                       "moe_train", {
        "reduced": {"num_layers": [full.num_layers, MIXTRAL_TRAIN_LAYERS],
                    "why": "memory: the full depth's bf16 weights alone (93 GB) exceed the "
                           "card's 80 GB"},
        "experts": [full.moe.num_experts, full.moe.top_k], "vs_cpu": vs_cpu,
        "training_kernels": kernels})


def remat_dots_phase(dev) -> dict:
    """Phase 34: ``remat="dots"`` against ``"full"`` in gemma-7b's training
    at full width: first one forward and backward through the train step's
    loss at 2 layers in float32 on the card, under each (the gradients
    bitwise equal; where a recomputed product changes bits, each gradient
    within CPU_GNORM_RTOL, the differing ones named); then in bf16 at
    GEMMA_TRAIN_LAYERS, batch TRAIN_BATCH x TRAIN_SEQ, AdamW, one state
    trained DOTS_WARMUP + DOTS_STEPS steps under each in turns, the
    attention kernels' counts set to 0 just before each turn and read just
    after (per step 2 forwards with lse a layer, the recomputation
    included, one dq and one dk/dv, all Hopper at head_dim 256).  Returns
    the kernels' launches counted in the ``"dots"`` turn."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.models import Model
    from repro_torch.precision import full_float32_matmul
    from repro_torch.train.optimizer import AdamWConfig, constant_lr
    from repro_torch.train.step import make_loss_fn, make_train_state, make_train_step

    full = get_config(GEMMA_ARCH)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(full, num_layers=WIDE_TRAIN_CPU_LAYERS[GEMMA_ARCH],
                                param_dtype="float32", compute_dtype="float32")
    lm = Model(cfg32).init(generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    seq = np.random.default_rng(2).integers(0, full.vocab_size, (1, WIDE_TRAIN_CPU_SEQ + 1))
    batch = {"tokens": torch.from_numpy(seq[:, :-1]).to(dev),
             "labels": torch.from_numpy(seq[:, 1:]).to(dev)}
    params = dict(lm.named_parameters())
    grads, losses = {}, {}
    for remat in ("full", "dots"):
        lm.cfg = dataclasses.replace(cfg32, remat=remat)  # forward_lm reads the module's config
        with torch.enable_grad(), full_float32_matmul():
            total, _, _ = make_loss_fn(Model(lm.cfg))(lm, batch)
            grads[remat] = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        losses[remat] = float(total.detach())
    differ = {n: float((grads["dots"][n] - g).norm() / g.norm().clamp_min(1e-30))
              for n, g in grads["full"].items() if not torch.equal(grads["dots"][n], g)}
    if losses["dots"] != losses["full"] or not all(r <= CPU_GNORM_RTOL for r in differ.values()):
        fail(f"remat='dots' and 'full' disagree: losses {losses}, gradients {differ}")
    f32 = {"layers": cfg32.num_layers, "dtype": "float32", "tokens": [1, WIDE_TRAIN_CPU_SEQ],
           "losses": losses, "grads_compared": len(params), "grads_bitwise": len(params) - len(differ),
           "differing_grads_rel_err": differ, "rtol": CPU_GNORM_RTOL,
           "seconds": time.perf_counter() - t0}
    del lm, params, grads, batch
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, num_layers=GEMMA_TRAIN_LAYERS)
    opt = AdamWConfig(lr=constant_lr(3e-4), weight_decay=0.01)
    state = make_train_state(Model(cfg), opt, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(34)
    L, per_step = cfg.num_layers, {"fwd": 2 * cfg.num_layers, "dq": cfg.num_layers,
                                   "dkv": cfg.num_layers}
    turns, dots_launches = {}, None
    for remat in ("dots", "full"):
        state["params"].cfg = dataclasses.replace(cfg, remat=remat)
        step_fn = make_train_step(Model(state["params"].cfg), opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.flash_attention_fwd_lse.launches = fa.hopper_launches = fa.wide_launches = 0
        for entry in (fab.flash_attention_bwd_dq, fab.flash_attention_bwd_dkv):
            entry.launches = entry.hopper_launches = 0
        step_s, run_losses = [], []
        for _ in range(DOTS_WARMUP + DOTS_STEPS):
            seq = rng.integers(0, min(cfg.vocab_size, 1024), (TRAIN_BATCH, TRAIN_SEQ + 1))
            tb = {"tokens": torch.from_numpy(seq[:, :-1]).to(dev),
                  "labels": torch.from_numpy(seq[:, 1:]).to(dev)}
            ts = time.perf_counter()
            _, m = step_fn(state, tb)
            run_losses.append(float(m["loss"]))  # synchronises
            step_s.append(time.perf_counter() - ts)
        n = DOTS_WARMUP + DOTS_STEPS
        launches = {"fwd": fa.flash_attention_fwd_lse.launches,
                    "dq": fab.flash_attention_bwd_dq.launches,
                    "dkv": fab.flash_attention_bwd_dkv.launches}
        hopper = {"fwd": fa.hopper_launches, "dq": fab.flash_attention_bwd_dq.hopper_launches,
                  "dkv": fab.flash_attention_bwd_dkv.hopper_launches}
        want = {k: v * n for k, v in per_step.items()}
        if launches != want or hopper != want or fa.wide_launches != want["fwd"]:
            fail(f"remat={remat!r}: the training kernels launched {launches} ({hopper} Hopper, "
                 f"{fa.wide_launches} wide) in {n} steps; need {per_step} a step, all Hopper at 256")
        if not all(math.isfinite(x) for x in run_losses):
            fail(f"remat={remat!r}: non-finite loss: {run_losses}")
        if remat == "dots":
            dots_launches = launches
        med = statistics.median(step_s[DOTS_WARMUP:])
        turns[remat] = {"step_ms_median": med * 1e3,
                        "step_ms": [x * 1e3 for x in step_s[DOTS_WARMUP:]],
                        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
                        "peak_device_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                        "launches_per_step": {k: v // n for k, v in launches.items()},
                        "hopper_launches_per_step": {k: v // n for k, v in hopper.items()},
                        "losses": run_losses}
    emit({"phase": "remat_dots", "arch": GEMMA_ARCH, "layers": L, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": cfg.compute_dtype,
          "warmup_steps": DOTS_WARMUP, "timed_steps": DOTS_STEPS, "order": list(turns),
          "reduced": {"num_layers": [full.num_layers, L],
                      "why": "memory: the full depth's weights, gradients and AdamW moments need "
                             "102 GB"},
          "vs_full_f32": f32, **turns,
          "dots_over_full_step": turns["dots"]["step_ms_median"] / turns["full"]["step_ms_median"],
          "dots_minus_full_peak_gb": turns["dots"]["peak_device_mem_gb"]
          - turns["full"]["peak_device_mem_gb"]})
    del state, step_fn
    torch.cuda.empty_cache()
    return dots_launches


def _scan_at_shape(dev, sm_clock_hz: float, B: int, S: int, Dm: int, N: int,
                   dt_rank: int) -> dict:
    """``ssm_scan`` at a prefill's shape, x (B, S, Dm) bf16 and dt float32
    as the model's layouts give them, N states, through ``ssm_scan_hopper``,
    within SSM_RULE of its plain version; CUDA-event times of the kernel
    around the plain version's, beside the bound (bytes; exponentials on
    the special-function units).  Returns the kernels-line entry."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm

    gen = torch.Generator(device=dev).manual_seed(35)
    inputs = _ssm_inputs(B, S, Dm, N, torch.bfloat16, dev, gen, dt_rank=dt_rank)
    x, dt, A, Bc, Cc, D, h0 = inputs
    if ssm.route(x, dt, Bc, Cc) != "hopper":
        fail(f"the scan at {(B, S, Dm, N)} routes to {ssm.route(x, dt, Bc, Cc)}, not hopper")
    before = ssm.hopper_launches
    y, h = ssm.ssm_scan(*inputs)
    torch.cuda.synchronize()
    if ssm.hopper_launches != before + 1:
        fail(f"the scan at {(B, S, Dm, N)} moved the Hopper count by {ssm.hopper_launches - before}")
    want_y, want_h = ref.ssm_scan_ref(*inputs)
    err = {"y": _rule_err(y, want_y, "bfloat16"), "h_final": _rule_err(h, want_h, "float32")}
    if not all(e[1] <= 1.0 for e in err.values()):
        fail(f"ssm_scan disagrees with its plain version at {(B, S, Dm, N)}: {err}")
    del y, h, want_y, want_h

    def kernel():
        return ssm.ssm_scan(*inputs)

    def plain():
        return ref.ssm_scan_ref(*inputs)

    turns = {"kernel": [], "plain": []}
    for key, fn, calls, groups in (("kernel", kernel, WIDE_TIMED_CALLS, 3), ("plain", plain, 1, 2),
                                   ("kernel", kernel, WIDE_TIMED_CALLS, 3)):
        turns[key].append(event_ms(fn, calls=calls, groups=groups))
    moved = sum(t.numel() * t.element_size() for t in inputs) + x.numel() * x.element_size() \
        + h0.numel() * 4  # each input read once, y and h_final written once
    exps = B * S * Dm * N
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    exp_ms = exps / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3
    ms = statistics.mean(turns["kernel"])
    del inputs, x, dt, A, Bc, Cc, D, h0
    torch.cuda.empty_cache()
    return {"name": "ssm_scan_jamba", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:68", "kernel": "ssm_scan_hopper",
            "launches": None, "max_abs_err": max(e[0] for e in err.values()), "ms": ms,
            "kernel_ms": ms, "plain_ms": statistics.mean(turns["plain"]),
            "plain": "ssm_scan_ref", "library_ms": None,
            "library": "none: no single PyTorch call computes a selective scan",
            "bound_ms": max(bytes_ms, exp_ms),
            "bound_by": "bytes" if bytes_ms >= exp_ms else "operations",
            "bound_parts_ms": {"bytes": bytes_ms, "exponentials": exp_ms},
            "bound_share": max(bytes_ms, exp_ms) / ms, "shape": [B, S, Dm, N],
            "dtype": "bfloat16", "errors": err, "ms_turns": turns, "bytes": moved,
            "exponentials": exps}


def hybrid_serve_phase(dev, sm_clock_hz: float, smi: str) -> tuple[dict, dict]:
    """Phase 35: jamba-1.5-large at full width (d_model 8,192, 64 heads of
    128 over 8, d_ff 24,576, 16 experts top 2, Mamba d_inner 16,384 with N
    16, no RoPE, vocabulary 65,536).  First at HYBRID_CPU_SCHEDULE (three
    layers with jamba's three kinds: Mamba and MLP, Mamba and MoE,
    attention and MLP) in float32 on the card against the CPU, as phase
    28 (the host's memory printed first: the MoE layer's 16 float32
    experts are 38.7 GB on each side); ``SlotBatcher`` at that schedule;
    then ``serve_batch`` in bf16 at HYBRID_LAYERS of its 72 layers, all 16
    experts, as phase 27, every Mamba layer's prefill scan through
    ``ssm_scan_hopper`` and the attention layer's through
    ``flash_fwd_hopper<128>``; then the scan at the prefill's shape
    (HYBRID_SCAN) against its plain version.  (The forward at its prefill
    shape is timed in phase 26, FAMILY_SHAPES.)  After the plain serve,
    the same weights through the model axis (:func:`model_axis_serve`).
    Returns the prefill's launch counts and the scan's kernels-line
    entry."""
    import numpy as np

    from repro_torch.configs import get_config

    full = get_config(HYBRID_ARCH)
    meminfo = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":")
            if key in ("MemTotal", "MemAvailable"):
                meminfo[key] = int(value.split()[0]) * 1024 / 1e9  # GB
    emit({"phase": "hybrid_host_memory", "host_gb": meminfo,
          "float32_layers": HYBRID_CPU_SCHEDULE["num_layers"]})
    small = dataclasses.replace(full, **HYBRID_CPU_SCHEDULE)
    kinds = small.layer_kinds()
    if set(kinds) != set(full.layer_kinds()):
        fail(f"the float32 schedule's layers {kinds} do not hold jamba's kinds {full.layer_kinds()}")
    vs_cpu = _wide_vs_cpu(dev, small, small.num_layers, WIDE_CPU_PROMPT, True)
    vs_cpu["schedule"] = {**HYBRID_CPU_SCHEDULE, "kinds": kinds}
    _batcher_vs_standalone(dev, small, "hybrid_batching", {"schedule": HYBRID_CPU_SCHEDULE})
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS)
    prompts = np.random.default_rng(35).integers(0, cfg.vocab_size,
                                                 (WIDE_BATCH, WIDE_PROMPT)).astype(np.int32)
    launches = _serve_arch(dev, cfg, prompts, "hybrid_serve", {
        "reduced": {"num_layers": [full.num_layers, HYBRID_LAYERS],
                    "why": "memory: 5 layers hold 24.0 B weights (48.1 GB in bf16) and every "
                           "kind of layer jamba has; 8 would need 90 GB, the full depth 797 GB"},
        "kinds": cfg.layer_kinds(), "experts": [full.moe.num_experts, full.moe.top_k],
        "vs_cpu": vs_cpu}, after=lambda *plain: model_axis_serve(dev, *plain, prompts, smi))
    B, S, Dm, N = HYBRID_SCAN
    scan = _scan_at_shape(dev, sm_clock_hz, B, S, Dm, N, full.ssm.resolved_dt_rank(full.d_model))
    emit({"phase": "hybrid_kernels", **scan})
    return launches, scan


def _block_outputs(model, params, batch: dict, max_len: int, place=lambda c: c) -> list:
    """Each block's output of one prefill of ``batch`` (whole tensors, on
    the host), the cache passed through ``place`` first."""
    import torch

    outs = []

    def keep(_module, _args, out):
        outs.append((out.full_tensor() if hasattr(out, "full_tensor") else out).cpu())

    hooks = [blk.register_forward_hook(keep) for blk in params.blocks]
    try:
        cache = place(model.init_cache(batch["tokens"].shape[0], max_len,
                                       device=batch["tokens"].device))
        model.prefill(params, batch, cache)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return outs


def model_axis_serve(dev, model, params, plain_toks, plain_logits, plain_t: dict, prompts,
                     smi: str) -> dict:
    """Phase 35 through the model axis: ``serve_batch`` of ``prompts`` on a
    one-rank NCCL group's (1, 1) ("data", "model") mesh under
    ``RULES_DECODE``, the weights of the plain serve (its tokens, logits
    and timings given) placed on the mesh in place (each shard's storage
    the weight's own); logits and tokens of every step bitwise, else the
    first block whose prefill output differs and the logits within the
    bf16 rule; the attention and scan kernels counted in the mesh run.
    Returns its launch counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.context import sharding_context
    from repro_torch.distributed.sharding import RULES_DECODE, distribute_cache, distribute_params
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch.serve import decode_span, serve_batch

    t_phase = time.perf_counter()
    cfg = model.cfg
    B, P = prompts.shape
    max_len, _ = decode_span(cfg, P, WIDE_GEN)
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    plain_blocks = _block_outputs(model, params, batch, max_len)
    ptrs = {n: p.untyped_storage().data_ptr() for n, p in params.named_parameters()}
    root = os.path.join(HERE, "build", "chip_smoke_tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        distribute_params(model, params, RULES_DECODE, mesh)
        moved = [n for n, p in params.named_parameters()
                 if p.to_local().untyped_storage().data_ptr() != ptrs[n]]
        if moved:
            fail(f"placing the weights on the mesh copied {moved[:4]}")
        serve_batch(model, prompts, 2, params=params, device=dev, mesh=mesh,
                    rules=RULES_DECODE)  # warm-up, as the plain serve had
        torch.cuda.synchronize()
        fa.flash_attention.launches = fa.hopper_launches = 0
        ssm.ssm_scan.launches = ssm.hopper_launches = 0
        tp_logits, tp_t = [], {}
        tp_toks = serve_batch(model, prompts, WIDE_GEN, params=params, device=dev, mesh=mesh,
                              rules=RULES_DECODE, timings=tp_t, logits_out=tp_logits)
        counts = {"flash_attention": fa.flash_attention.launches, "hopper": fa.hopper_launches,
                  "ssm_scan": ssm.ssm_scan.launches, "ssm_scan_hopper": ssm.hopper_launches}
        L = cfg.num_layers
        A = sum(cfg.is_attn_layer(i) for i in range(L))
        want = {"flash_attention": A, "hopper": A, "ssm_scan": L - A, "ssm_scan_hopper": L - A}
        if counts != want:
            fail(f"the model-axis prefill launched {counts}, not {want}")
        bitwise = bool((tp_toks == plain_toks).all()) and all(
            torch.equal(a, b) for a, b in zip(tp_logits, plain_logits))
        line = {"bitwise_equal": bitwise, "steps_compared": len(plain_logits)}
        if not bitwise:
            with sharding_context(mesh, RULES_DECODE):
                tp_blocks = _block_outputs(model, params, batch, max_len, lambda c: (
                    distribute_cache(model, c, RULES_DECODE, mesh)))
            first = next((i for i, (a, b) in enumerate(zip(tp_blocks, plain_blocks))
                          if not torch.equal(a, b)), None)
            errs = [_rule_err(a, b, "bfloat16") for a, b in zip(tp_logits, plain_logits)]
            line.update(first_differing_block=first,
                        first_differing_kind=None if first is None else cfg.layer_kinds()[first],
                        logits_max_abs_err=max(e[0] for e in errs),
                        logits_rule_err=max(e[1] for e in errs))
            if not max(e[1] for e in errs) <= 1.0:
                fail(f"the model-axis serve disagrees with the plain one beyond the bf16 rule: "
                     f"{line}")
            ties = _tie_diverged(tp_toks[0].tolist(), plain_toks[0].tolist(),
                                 [lg[0].float().cpu() for lg in plain_logits], TIE_F32)
            line["greedy_tie"] = ties
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "hybrid_serve_model_axis", "arch": cfg.name, "layers": cfg.num_layers,
          "mesh": {"data": 1, "model": 1}, "rules": "decode", "backend": "nccl",
          "nvidia_smi": smi, "batch": B, "prompt": P, "gen": WIDE_GEN, **line,
          "time_to_first_token_ms": tp_t["prefill_s"] * 1e3,
          "plain_time_to_first_token_ms": plain_t["prefill_s"] * 1e3,
          "decode_ms_per_step": tp_t["decode_s"] / tp_t["decode_steps"] * 1e3,
          "plain_decode_ms_per_step": plain_t["decode_s"] / plain_t["decode_steps"] * 1e3,
          "launches": counts, "weights_copied": 0,
          "seconds": time.perf_counter() - t_phase})
    return counts


def _slice_heads(t, h0: int, h1: int):
    """Heads [h0, h1) of a (B, S, H, D) tensor as a region's local product
    gives them: contiguous, then the kernel's (B, H, S, D) view."""
    return t[:, :, h0:h1].contiguous().transpose(1, 2)


def _slice_kv(t, plan):
    """A rank's kv heads of a (B, T, Hkv, D) tensor for ``plan``
    (``tensor_parallel.attention_heads``), as the model's region takes them,
    in the kernel's view."""
    import torch

    if plan[0] == "range":
        return _slice_heads(t, plan[1], plan[2])
    idx = torch.tensor(plan[1], dtype=torch.long, device=t.device)
    return t.index_select(2, idx).transpose(1, 2)


def _kv_sum(parts, Hkv: int, H: int, m: int, fn=lambda t: t.float()):
    """The slices' dk (or dv), each (B, Hl, T, D) for its plan, added into
    (B, Hkv, T, D) float32 at the kv heads they stand for (each slice
    through ``fn`` first)."""
    import torch

    from repro_torch.distributed.tensor_parallel import attention_heads, chunk_range

    B, _, T, D = parts[0].shape
    out = torch.zeros((B, Hkv, T, D), dtype=torch.float32, device=parts[0].device)
    for r, part in enumerate(parts):
        h0, h1 = chunk_range(H, m, r)
        plan = attention_heads(h0, h1, H, Hkv)
        if plan[0] == "range":
            out[:, plan[1]:plan[2]] += fn(part)
        else:
            out.index_add_(1, torch.tensor(plan[1], device=out.device), fn(part))
    return out


def _sum_of_roundings_err(parts, want, Hkv: int, H: int, m: int) -> dict:
    """The slices' bf16 dk (or dv) summed against the whole call's: each
    slice's output is its float32 sum rounded once to bf16, the whole's
    the float32 sum of all its query heads rounded once, so the two may
    differ by a rounding of each (unit roundoff 2**-8 of its magnitude)
    plus float32 noise: max |sum - whole|, and the same over that bound
    (at most 1 within it)."""
    got = _kv_sum(parts, Hkv, H, m)
    mags = _kv_sum(parts, Hkv, H, m, lambda t: t.float().abs())
    w = want.float()
    bound = 2.0**-8 * (mags + w.abs()) + 1e-6 * float(w.square().mean().sqrt())
    d = (got - w).abs()
    return {"max_abs_err": float(d.max()), "rounding_err": float((d / bound).max()),
            "rms": float(w.square().mean().sqrt())}


def model_axis_kernel_phase(dev, smi: str) -> dict:
    """Phase 38: each rank's slice of the Hopper kernels' inputs at the
    model sizes of MODEL_AXIS_SIZES, in one process; returns the launches
    of each kernel over the slices."""
    import torch

    from repro_torch.distributed.tensor_parallel import attention_heads, chunk_range
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ssm_scan as ssm

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(38)
    out, line = {}, {}

    def bshd(B, S, H, D):
        return torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)

    # (a) jamba's prefill attention: each rank's query heads and their kv heads
    B, S, H, Hkv, D = MODEL_AXIS_ATTN
    q, k, v = bshd(B, S, H, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
    whole = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True)
    before = fa.hopper_launches
    for m in MODEL_AXIS_SIZES:
        parts = []
        for r in range(m):
            h0, h1 = chunk_range(H, m, r)
            plan = attention_heads(h0, h1, H, Hkv)
            qs, ks, vs = _slice_heads(q, h0, h1), _slice_kv(k, plan), _slice_kv(v, plan)
            if fa.route(qs, ks, vs) != "hopper":
                fail(f"rank {r} of {m}'s attention slice routes to {fa.route(qs, ks, vs)}")
            parts.append(fa.flash_attention(qs, ks, vs, causal=True))
        if not torch.equal(torch.cat(parts, dim=1), whole):
            fail(f"jamba's prefill attention over {m} ranks' heads differs from the whole call")
    out["jamba_attention"] = fa.hopper_launches - before
    if out["jamba_attention"] != sum(MODEL_AXIS_SIZES):
        fail(f"{out['jamba_attention']} Hopper launches for {sum(MODEL_AXIS_SIZES)} slices")
    line["jamba_attention"] = {"shape": list(MODEL_AXIS_ATTN), "model_sizes": MODEL_AXIS_SIZES,
                               "bitwise": True, "hopper_launches": out["jamba_attention"]}
    del q, k, v, whole, parts

    # (b) smollm's training attention, uneven 15 / 5 over 2 ranks
    B, S, H, Hkv, D = MODEL_AXIS_TRAIN_ATTN
    q, k, v, dout = bshd(B, S, H, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D), bshd(B, S, H, D)
    qt, kt, vt, dt_ = (t.transpose(1, 2) for t in (q, k, v, dout))
    o, lse = fa.flash_attention_fwd_lse(qt, kt, vt, causal=True)
    delta = (dout.transpose(1, 2).float() * o.float()).sum(-1).contiguous()
    dq = fab.flash_attention_bwd_dq(qt, kt, vt, dt_, lse, delta, causal=True)
    dk, dv = fab.flash_attention_bwd_dkv(qt, kt, vt, dt_, lse, delta, causal=True)
    counters = (fa.hopper_launches, fab.flash_attention_bwd_dq.hopper_launches,
                fab.flash_attention_bwd_dkv.hopper_launches)
    m = 2
    os_, lses, dqs, dks, dvs, plans = [], [], [], [], [], []
    for r in range(m):
        h0, h1 = chunk_range(H, m, r)
        plan = attention_heads(h0, h1, H, Hkv)
        plans.append(plan)
        qs, ks, vs, ds = (_slice_heads(q, h0, h1), _slice_kv(k, plan), _slice_kv(v, plan),
                          _slice_heads(dout, h0, h1))
        o_r, lse_r = fa.flash_attention_fwd_lse(qs, ks, vs, causal=True)
        delta_r = (ds.float() * o_r.float()).sum(-1).contiguous()
        os_.append(o_r)
        lses.append(lse_r)
        dqs.append(fab.flash_attention_bwd_dq(qs, ks, vs, ds, lse_r, delta_r, causal=True))
        dk_r, dv_r = fab.flash_attention_bwd_dkv(qs, ks, vs, ds, lse_r, delta_r, causal=True)
        dks.append(dk_r)
        dvs.append(dv_r)
    counted = (fa.hopper_launches - counters[0],
               fab.flash_attention_bwd_dq.hopper_launches - counters[1],
               fab.flash_attention_bwd_dkv.hopper_launches - counters[2])
    if counted != (m, m, m):
        fail(f"the training attention's slices counted {counted} Hopper launches, not {m} each")
    out.update(fwd=m, dq=m, dkv=m)
    for name, got, want in (("out", torch.cat(os_, 1), o), ("lse", torch.cat(lses, 1), lse),
                            ("dq", torch.cat(dqs, 1), dq)):
        if not torch.equal(got, want):
            fail(f"smollm's training attention over 2 ranks: {name} differs from the whole call")
    kv_err = {}
    for name, parts, want in (("dk", dks, dk), ("dv", dvs, dv)):
        kv_err[name] = _sum_of_roundings_err(parts, want, Hkv, H, m)
        if not kv_err[name]["rounding_err"] <= 1.0:
            fail(f"the slices' {name} summed over the ranks is off the whole beyond a bf16 "
                 f"rounding of each: {kv_err[name]}")
    line["smollm_training_attention"] = {
        "shape": list(MODEL_AXIS_TRAIN_ATTN), "model_size": m, "plans": plans,
        "bitwise": ["out", "lse", "dq"], "summed_over_slices": kv_err,
        "hopper_launches": {"fwd": m, "dq": m, "dkv": m}}
    del q, k, v, dout, o, lse, dq, dk, dv, os_, lses, dqs, dks, dvs

    # (c) falcon-mamba's training scan and its backward, on each rank's channels
    B, S, Dm, N = MODEL_AXIS_SCAN
    xz, dt, A, Bc, Cc, Dd, _ = _ssm_inputs(B, S, Dm, N, torch.bfloat16, dev, gen)
    x = xz.contiguous()
    dy = torch.randn((B, S, Dm), generator=gen, device=dev).to(torch.bfloat16)
    y, h, ckpt = ssm.ssm_scan_train(x, dt, A, Bc, Cc, Dd, None)
    grads = ssm.ssm_scan_bwd(x, dt, A, Bc, Cc, Dd, None, dy, None, ckpt)
    del ckpt
    before = (ssm.hopper_launches, ssm.ssm_scan_train.checkpoints, ssm.hopper_bwd_launches)
    sums = {}
    for m in MODEL_AXIS_SIZES:
        ys, hs, gs = [], [], []
        for r in range(m):
            c0, c1 = chunk_range(Dm, m, r)
            xs, dts, dys = (t[..., c0:c1].contiguous() for t in (x, dt, dy))
            y_r, h_r, ck_r = ssm.ssm_scan_train(xs, dts, A[c0:c1], Bc, Cc, Dd[c0:c1], None)
            ys.append(y_r)
            hs.append(h_r)
            gs.append(ssm.ssm_scan_bwd(xs, dts, A[c0:c1], Bc, Cc, Dd[c0:c1], None, dys, None,
                                       ck_r))
            del ck_r
        per_channel = {"y": (torch.cat(ys, -1), y), "h_final": (torch.cat(hs, 1), h),
                       "dx": (torch.cat([g[0] for g in gs], -1), grads[0]),
                       "ddt": (torch.cat([g[1] for g in gs], -1), grads[1]),
                       "dA": (torch.cat([g[2] for g in gs], 0), grads[2]),
                       "dD": (torch.cat([g[5] for g in gs], 0), grads[5])}
        differ = [k for k, (a, b) in per_channel.items() if not torch.equal(a, b)]
        if differ:
            fail(f"the scan over {m} ranks' channels differs from the whole call in {differ}")
        for name, i in (("dB", 3), ("dC", 4)):
            total = sum(g[i] for g in gs)
            err = float((total - grads[i]).abs().max())
            scale = float(grads[i].abs().max())
            sums[f"{name}_{m}"] = {"max_abs_err": err, "whole_max_abs": scale}
            if not err <= MODEL_AXIS_SUM_RTOL * scale:
                fail(f"the slices' {name} summed over {m} ranks is {err} off the whole "
                     f"(largest {scale}), past float32 rounding")
        del ys, hs, gs, per_channel
    counted = (ssm.hopper_launches - before[0], ssm.ssm_scan_train.checkpoints - before[1],
               ssm.hopper_bwd_launches - before[2])
    n = sum(MODEL_AXIS_SIZES)
    if counted != (n, n, n):
        fail(f"the scan's slices counted {counted} Hopper launches (forward, its checkpoints, "
             f"backward), not {n} each")
    out.update(scan=n, scan_bwd=n)
    line["falcon_mamba_training_scan"] = {
        "shape": list(MODEL_AXIS_SCAN), "model_sizes": MODEL_AXIS_SIZES,
        "bitwise": ["y", "h_final", "dx", "ddt", "dA", "dD"], "summed_over_slices": sums,
        "rtol": MODEL_AXIS_SUM_RTOL, "hopper_launches": {"forward": n, "backward": n}}
    del x, dt, A, Bc, Cc, Dd, dy, y, h, grads, xz
    torch.cuda.empty_cache()
    emit({"phase": "model_axis_kernels", "nvidia_smi": smi, **line,
          "seconds": time.perf_counter() - t_phase})
    return out


def _bwd_inputs(B, S, Dm, N, dtype, dev, gen, seeded: bool):
    """The scan's inputs as :func:`_ssm_inputs` gives them (B and C column
    views), dy a half of a wider tensor (not contiguous), h0 and dh_final
    where ``seeded`` (else None)."""
    import torch

    inputs = list(_ssm_inputs(B, S, Dm, N, dtype, dev, gen))
    dy = torch.randn((B, S, 2 * Dm), generator=gen, device=dev).to(dtype)[..., Dm:]
    dh_final = torch.randn((B, Dm, N), generator=gen, device=dev) if seeded else None
    if not seeded:
        inputs[6] = None
    return inputs, dy, dh_final


def _grad_errs(got, want, dtype_name: str) -> dict:
    """{gradient: (max |err|, over SSM_RULE, rms(want))} of the non-empty
    gradients; dx by x's type, the rest as float32.  A gradient that is
    all zeros (dA and dD of an empty sequence) must be met exactly."""
    errs = {}
    for name, g, w in zip(SSM_GRADS, got, want):
        if not w.numel():
            continue
        if not bool(w.any()):
            d = (g.float() - w.float()).abs().max().item()
            errs[name] = (d, 0.0 if d == 0 else math.inf, 0.0)
        else:
            errs[name] = _rule_err(g, w, dtype_name if name == "dx" else "float32")
    return errs


def _ssm_bwd_mutants(dev, case, started: tuple) -> dict:
    """Each of SSM_BWD_MUTANTS and the unedited source, their builds
    ``started`` by :func:`_start_mutants`, on ``case``'s float32 inputs (h0
    and dh_final given) and the package's training forward's checkpoints
    into NaN-filled outputs: the worst gradient's error over the rule (a
    NaN counts as infinite)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm

    libs, out_dir = _finish_mutants(started, ssm.bind_bwd)
    B, S, Dm, N = case
    inputs, dy, dh_final = _bwd_inputs(B, S, Dm, N, torch.float32, dev,
                                       torch.Generator(device=dev).manual_seed(361), True)
    want = ref.ssm_scan_bwd_ref(*inputs, dy, dh_final)
    ckpt = ssm.ssm_scan_train(*inputs)[2]
    result = {}
    for name, lib in libs.items():
        shapes = ((B, S, Dm), (B, S, Dm), (B, S, N), (B, S, N), (Dm, N), (Dm,), (B, Dm, N))
        out = tuple(torch.full(sh, math.nan, device=dev) for sh in shapes)
        got = ssm.launch_bwd(lib, *inputs, dy, dh_final, out=out, ckpt=ckpt)[:7]
        torch.cuda.synchronize()
        errs = _grad_errs(got, want, "float32")
        result[name] = max(math.inf if math.isnan(e[1]) else e[1] for e in errs.values())
    shutil.rmtree(out_dir, ignore_errors=True)
    return result


def _plain_checkpoints(x, dt, A, Bc, Cc, h0):
    """The state at the start of every SEGMENT_STEPS-step segment, (B,
    segments, D, N) float32, by the plain recurrence of ``ssm_scan_ref``:
    what ``ssm_scan_train_hopper`` writes for the backward."""
    import torch

    from repro_torch.kernels import ssm_scan as ssm

    Bsz, S, Dm = x.shape
    N = A.shape[1]
    h = torch.zeros((Bsz, Dm, N), device=x.device) if h0 is None else h0.float()
    out = torch.empty((Bsz, -(-S // ssm.SEGMENT_STEPS), Dm, N), device=x.device)
    xf = x.float()
    for t in range(S):
        if t % ssm.SEGMENT_STEPS == 0:
            out[:, t // ssm.SEGMENT_STEPS] = h
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * xf[:, t])[:, :, None] * Bc[:, t, None, :])
    return out


def ssm_train_phase(dev, sm_clock_hz: float) -> dict:
    """Phase 36: training in the ssm and hybrid families.  (a) the scan's
    backward on the sweep through both routes (the hopper one given the
    training forward's checkpoints, and making its own) against
    ``ssm_scan_bwd_ref``, two calls bitwise equal, and SSM_BWD_MUTANTS;
    (b) at falcon-mamba-7b's training shape the hopper kernel in turns
    with the strided kernel and the two forwards, the plain backward once,
    the bound, the checkpoints against the plain recurrence and
    ``ptxas``'s registers and spills; (c) falcon-mamba-7b at 2 layers in
    float32 on the card against the CPU; (d) falcon-mamba-7b trained at
    full width and SSM_TRAIN_LAYERS of its 64 layers; (e) jamba's smoke
    config in float32 on the card against the CPU.  Returns the kernels
    line's entries: the backward's and the training forward's."""
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssm_scan as ssm

    t_phase = time.perf_counter()
    mutant_builds = _start_mutants("ssm_scan_bwd", SSM_BWD_MUTANTS)  # built while the sweep runs
    full = get_config(SSM_ARCH)
    # (a) the sweep: each case through the hopper route from the training
    # forward's checkpoints, and with h0 and h_final given through the
    # strided route (dy of last stride 2); the longest case twice on each,
    # the second hopper call making its own checkpoints
    gen = torch.Generator(device=dev).manual_seed(36)
    worst, calls, before = {}, {"hopper": 0, "strided": 0}, ssm.ssm_scan_bwd.launches
    before_hopper, copies = ssm.hopper_bwd_launches, ssm.ssm_scan_bwd.copies
    given, trained = ssm.ssm_scan_bwd.with_checkpoints, ssm.ssm_scan_train.checkpoints
    handed, forwards = 0, 0  # checkpoints handed to the backward; training forwards run
    repeatable, fwd_same = True, True
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for S in SSM_BWD_S:
            for Dm in SSM_BWD_D:
                for N in (4, 16):
                    for seeded in (False, True):
                        inputs, dy, dh_final = _bwd_inputs(2, S, Dm, N, dtype, dev, gen, seeded)
                        want = ref.ssm_scan_bwd_ref(*inputs, dy, dh_final)
                        cases = {"hopper": dy}
                        if seeded:
                            cases["strided"] = torch.stack([dy, dy], dim=-1)[..., 0]
                        for kernel, g in cases.items():
                            if ssm.bwd_route(*inputs[:2], *inputs[3:5], g) != kernel:
                                fail(f"the sweep's {kernel} case routes elsewhere")
                            ckpt = None
                            if kernel == "hopper" and S:
                                y, h_final, ckpt = ssm.ssm_scan_train(*inputs)
                                y0, h0_final = ssm.ssm_scan(*inputs)
                                fwd_same &= torch.equal(y, y0) and torch.equal(h_final, h0_final)
                                handed, forwards = handed + 1, forwards + 1
                            got = ssm.ssm_scan_bwd(*inputs, g, dh_final, ckpt=ckpt)
                            calls[kernel] += 1
                            if (S, Dm, N, seeded) == SSM_BWD_MUTANT_CASE[1:] + (True,):
                                again = ssm.ssm_scan_bwd(*inputs, g, dh_final)
                                calls[kernel] += 1
                                forwards += kernel == "hopper"
                                repeatable &= all(torch.equal(a, b) for a, b in zip(got, again))
                            for grad, e in _grad_errs(got, want, name).items():
                                key = f"{kernel}/{name}/{grad}"
                                worst[key] = max(worst.get(key, e), e, key=lambda t: t[1])
    torch.cuda.synchronize()
    counted = {"launches": ssm.ssm_scan_bwd.launches - before,
               "hopper": ssm.hopper_bwd_launches - before_hopper,
               "copies": ssm.ssm_scan_bwd.copies - copies,
               "with_checkpoints": ssm.ssm_scan_bwd.with_checkpoints - given,
               "training_forwards": ssm.ssm_scan_train.checkpoints - trained}
    if (counted["launches"] != sum(calls.values()) or counted["hopper"] != calls["hopper"]
            or counted["copies"] or counted["with_checkpoints"] != handed
            or counted["training_forwards"] != forwards):
        fail(f"the sweep's calls {calls} ({handed} handed checkpoints, {forwards} training "
             f"forwards) counted {counted}")
    if not all(e[1] <= 1.0 for e in worst.values()):
        fail(f"the scan's backward disagrees with its plain version on the sweep: {worst}")
    if not repeatable:
        fail("two calls of the scan's backward differ")
    if not fwd_same:
        fail("the training forward's y and h_final differ from the serving kernel's")
    mutants = _ssm_bwd_mutants(dev, SSM_BWD_MUTANT_CASE, mutant_builds)
    weak = {k: r for k, r in mutants.items() if k != "shipped" and not r >= SSM_MUTANT_MIN}
    if weak:
        fail(f"mutants of the scan's backward pass the rule with less than {SSM_MUTANT_MIN}x: "
             f"{weak}")
    if not mutants["shipped"] <= 1.0:
        fail(f"the unedited backward built as a mutant fails the rule: {mutants['shipped']}")
    emit({"phase": "ssm_train_kernel_sweep", "S": list(SSM_BWD_S), "D": list(SSM_BWD_D),
          "N": [4, 16], "dtypes": ["float32", "bfloat16"], "h0_and_dh_final": [False, True],
          "calls": calls, "counted": counted, "worst_over_rule": worst, "rule": SSM_RULE,
          "repeatable_bitwise": repeatable, "training_forward_bitwise": fwd_same, "mutants_over_rule": mutants,
          "mutant_case": list(SSM_BWD_MUTANT_CASE), "mutant_min": SSM_MUTANT_MIN,
          "seconds": time.perf_counter() - t_phase})

    # (b) the training shape: the hopper kernel in turns with the strided
    # kernel it replaced there and the two forwards, the plain version once
    B, S, Dm, N = SSM_BWD_PATH
    x, dt, A, Bc, Cc, D, _ = _ssm_inputs(B, S, Dm, N, torch.bfloat16, dev, gen)
    dy = torch.randn((B, S, Dm), generator=gen, device=dev).to(torch.bfloat16)
    inputs = (x, dt, A, Bc, Cc, D, None)
    if ssm.bwd_route(x, dt, Bc, Cc, dy) != "hopper":
        fail(f"the training shape's layouts do not take the hopper route")
    y, h_final, ckpt = ssm.ssm_scan_train(*inputs)
    plain_ckpt = _plain_checkpoints(x, dt, A, Bc, Cc, None)
    ckpt_err = _rule_err(ckpt.view(plain_ckpt.shape), plain_ckpt, "float32")
    if not ckpt_err[1] <= 1.0:
        fail(f"the training forward's checkpoints disagree with the plain recurrence's: {ckpt_err}")
    del plain_ckpt, y, h_final
    got = ssm.ssm_scan_bwd(*inputs, dy, None, ckpt=ckpt)
    again = ssm.ssm_scan_bwd(*inputs, dy, None, ckpt=ckpt)
    alone = ssm.ssm_scan_bwd(*inputs, dy, None)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref.ssm_scan_bwd_ref(*inputs, dy, None)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    path = _grad_errs(got, want, "bfloat16")
    if not all(e[1] <= 1.0 for e in path.values()):
        fail(f"the scan's backward disagrees with its plain version at {SSM_BWD_PATH}: {path}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"two calls of the scan's backward differ at {SSM_BWD_PATH}")
    if not all(torch.equal(a, b) for a, b in zip(got, alone)):
        fail(f"the backward from the forward's checkpoints differs from one that made its own "
             f"at {SSM_BWD_PATH}")
    prev = previous_ssm_scan_bwd(*inputs, dy, None)
    torch.cuda.synchronize()
    prev_path = _grad_errs(prev, want, "bfloat16")
    max_abs_err = max(e[0] for e in (*path.values(), *worst.values()))
    del got, again, alone, want, prev
    fns = {"hopper": lambda: ssm.ssm_scan_bwd(*inputs, dy, None, ckpt=ckpt),
           "previous": lambda: previous_ssm_scan_bwd(*inputs, dy, None),
           "forward": lambda: ssm.ssm_scan(*inputs),
           "training_forward": lambda: ssm.ssm_scan_train(*inputs)}
    turns = {key: [] for key in fns}
    for key in (*fns, *reversed(fns)):
        turns[key].append(event_ms(fns[key], calls=SSM_BWD_TIMED_CALLS, groups=3))
    means = {key: statistics.mean(v) for key, v in turns.items()}
    ms = means["hopper"]
    # each input read once (x, dt, dy, B, C, A, D), each output written once
    # (dx, ddt, dB, dC, dA, dD, dh0)
    read = sum(t.numel() * t.element_size() for t in (x, dt, dy, Bc, Cc, A, D))
    written = x.numel() * (x.element_size() + 4) + 2 * B * S * N * 4 + Dm * N * 4 + Dm * 4 \
        + B * Dm * N * 4
    exps = B * S * Dm * N
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = {"bytes": (read + written) / HBM_BYTES_PER_S * 1e3,
             "exponentials": exps / (SFU_EXP2_PER_CLOCK_PER_SM * sms * sm_clock_hz) * 1e3,
             "fp32_flops": SSM_BWD_FLOPS * exps / FP32_FLOP_PER_S * 1e3}
    bound = max(parts.values())
    ptxas = {k: v for k, v in _build.ptxas_report("ssm_scan_bwd").items()
             if "ssm_scan_bwd_hopper" in k or "ssm_scan_bwd_strided" in k}
    kernel = {"name": "ssm_scan_bwd", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
              "replaces": "src/repro/kernels/ssm_scan.py:101",
              "replaces_note": "the gradient of the TPU kernel's function, which has no Pallas "
                               "backward: the JAX package differentiates selective_scan "
                               "(src/repro/models/ssm.py:100) with jax.vjp",
              "kernel": "ssm_scan_bwd_hopper", "launches": None,
              "max_abs_err": max_abs_err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
              "plain": "ssm_scan_bwd_ref, once", "library_ms": None,
              "library": "none: no single PyTorch call computes a selective scan's gradient",
              "bound_ms": bound, "bound_by": "bytes" if parts["bytes"] == bound else "operations",
              "bound_parts_ms": parts, "bound_share": bound / ms,
              "previous_kernel": "ssm_scan_bwd_strided (the strided route, replaced here)",
              "previous_kernel_ms": means["previous"], "previous_errors": prev_path,
              "ms_over_previous": ms / means["previous"],
              "forward_ms": means["forward"], "training_forward_ms": means["training_forward"],
              "shape": list(SSM_BWD_PATH), "dtype": "bfloat16", "errors": path,
              "ms_turns": turns, "bytes": read + written, "exponentials": exps, "ptxas": ptxas}
    emit({"phase": "ssm_train_kernel", **kernel})
    # the training forward: y and h_final as the serving kernel's (the
    # sweep), its checkpoints against the plain recurrence's states.  Its
    # bound is the scan's own (x, dt, B, C, A, D read; y and h_final
    # written): the checkpoints are the backward's residuals, not the
    # function's output, and their stores are reported beside it.
    fwd_read = sum(t.numel() * t.element_size() for t in (x, dt, Bc, Cc, A, D))
    fwd_written = x.numel() * x.element_size() + B * Dm * N * 4
    fwd_parts = {"bytes": (fwd_read + fwd_written) / HBM_BYTES_PER_S * 1e3,
                 "exponentials": parts["exponentials"]}
    fwd_bound = max(fwd_parts.values())
    fwd_ptxas = {k: v for k, v in _build.ptxas_report("ssm_scan").items()
                 if "ssm_scan_train_hopper" in k}
    train_fwd = {"name": "ssm_scan_train", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "replaces": "src/repro/kernels/ssm_scan.py:101",
                 "replaces_note": "the TPU kernel's forward, which training runs with the "
                                  "backward's checkpoints as its residuals",
                 "kernel": "ssm_scan_train_hopper", "launches": None,
                 "max_abs_err": max(ckpt_err[0], max(e[0] for e in worst.values())),
                 "checkpoint_errors": ckpt_err, "ms": means["training_forward"],
                 "kernel_ms": means["training_forward"], "plain_ms": None,
                 "plain": "ssm_scan_ref's recurrence with the states kept every 8 steps, once "
                          "(untimed)",
                 "library_ms": None,
                 "library": "none: no single PyTorch call computes a selective scan",
                 "bound_ms": fwd_bound,
                 "bound_by": "bytes" if fwd_parts["bytes"] == fwd_bound else "operations",
                 "bound_parts_ms": fwd_parts, "bound_share": fwd_bound / means["training_forward"],
                 "serving_forward_ms": means["forward"], "shape": list(SSM_BWD_PATH),
                 "dtype": "bfloat16", "checkpoint_bytes": ckpt.numel() * 4,
                 "checkpoint_bytes_ms": ckpt.numel() * 4 / HBM_BYTES_PER_S * 1e3,
                 "ms_over_serving_forward": means["training_forward"] - means["forward"],
                 "ptxas": fwd_ptxas}
    del x, dt, A, Bc, Cc, D, dy, inputs, fns, ckpt
    torch.cuda.empty_cache()

    # (c) falcon-mamba-7b at 2 layers in float32, the card against the CPU
    vs_cpu = _wide_train_vs_cpu(dev, full, SSM_TRAIN_CPU_LAYERS)
    if not (vs_cpu["scan_bwd_launches_on_the_card"]
            == vs_cpu["scan_bwd_hopper_launches_on_the_card"] == SSM_TRAIN_CPU_LAYERS):
        fail(f"the float32 step on the card launched the scan's backward "
             f"{vs_cpu['scan_bwd_launches_on_the_card']} times "
             f"({vs_cpu['scan_bwd_hopper_launches_on_the_card']} on the hopper route) for "
             f"{SSM_TRAIN_CPU_LAYERS} layers")

    # (e) jamba's smoke config, its three kinds of layer, the card against the CPU
    small = smoke_config(HYBRID_ARCH)
    hybrid = _wide_train_vs_cpu(dev, small, small.num_layers)
    mamba = sum(not attn for attn, _ in small.layer_kinds())
    hybrid.update(kinds=small.layer_kinds(), arch=small.name)
    if hybrid["scan_bwd_launches_on_the_card"] != mamba:
        fail(f"jamba's float32 step on the card launched the scan's backward "
             f"{hybrid['scan_bwd_launches_on_the_card']} times for {mamba} Mamba layers")
    emit({"phase": "hybrid_train_vs_cpu", **hybrid})

    # (d) falcon-mamba-7b trained at full width, SSM_TRAIN_LAYERS of 64 layers
    launches = _train_arch(dev, dataclasses.replace(full, num_layers=SSM_TRAIN_LAYERS),
                           "ssm_train", {
        "reduced": {"num_layers": [full.num_layers, SSM_TRAIN_LAYERS],
                    "why": "memory: the full depth's 7.27 B weights, gradients and AdamW "
                           "moments need 87 GB at 12 bytes a weight"},
        "d_inner": full.ssm.expand * full.d_model, "d_state": full.ssm.d_state,
        "vocab": full.vocab_size, "tie_embeddings": full.tie_embeddings, "vs_cpu": vs_cpu,
        "phase_seconds_before_training": time.perf_counter() - t_phase})
    kernel["launches"] = launches["scan_bwd"]
    train_fwd["launches"] = launches["scan_fwd"]
    return [kernel, train_fwd]


if __name__ == "__main__":
    main()
