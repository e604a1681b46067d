#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py [--seed 0] [--size 512] [--n-iter 10]

Run from the repository root (it imports ``src/repro_torch``).  Phases:

1. Device: fails without CUDA; prints the card's name and power limit.
2. Build: compiles the three kernels of ``src/repro_torch/kernels/csrc/``
   (``sb_gemm.cu``, ``grouped_gemm.cu``, ``flash_attn.cu``; the last two
   include ``hopper.cuh``, and so does ``sb_gemm.cu``) with nvcc, one
   process each, all at once; prints the registers, spills and shared
   memory of the wgmma and fma kernels (attention at D = 64, 128, 256;
   grouped for each type) and of the ``stream`` and ``splitk`` kernels of
   ``native_gemm``, the one kernel of its ``wgmma`` and ``batched``
   routes (at each tile height and operand layout, and its split
   reduction; it may not spill), the kernel of its ``fbatched`` route
   (at each tile width and slab layout, and its split reduction; it may
   not spill) and the gathering ``nm_gather_kernel`` of its ``gathered``
   route (at each tile height and stage layout; it may not spill); no fma
   kernel may spill, and each must have the
   shared memory its plan (``fma_tiles``, ``KERNEL_TILES``) gives.
3. Kernel vs plain version on the card: the 36 Table II cases (native and
   batched strategies, f32 and bf16, ragged dims; every f32 launch on
   ``fbatched``, every bf16 one on ``gathered``), the 8 exceptional cases
   through ``ext_gemm``, the 100-spec layout-fuzz stream (integer-valued,
   bit-identical), the native kernel's gradients and a small HOOI, every
   ``native_gemm`` launch in them held to the route ``native_route``
   gives; then cases that force each ``native_gemm`` route at ragged
   extents (narrow widths 1, 10 and 16, depths and rows off the stage and
   tile sizes, bf16 output, integer-valued bit-identical; for ``wgmma``
   bf16 weight streaming at rows 1 (a stride-0 decode row), 2, 4, 63, 64,
   65 and 200, depths 6144, 1000 and 328, 1032 columns, each operand
   layout, bf16 and f32 output; and bf16 cases whose rows are no
   multiple of 16 bytes apart, which take ``gathered``; weight
   gradients whose contracted modes ``b`` and ``s`` fuse, on ``wgmma``
   unsplit at 40 to 5000 rows, a K-major fused product split, and a
   float32 pair of fusing modes on ``splitk``; ``batched`` attention
   products with up to 3 grid modes, an M-major X, an outer contracted
   mode (``r`` beside ``s`` in a GQA dK and dV), a decode row and a
   1024-deep P.V, expert products with 341 rows and depth, GShard's;
   ``gathered`` bf16 products no tensor map reads (experts whose rows are
   500 bytes apart, four grid modes and an outer contracted mode, a start
   2 bytes off); ``fbatched`` float32 products (Table II layouts at
   ragged extents, a split Gram, a stride-0 view, a start 4 bytes off,
   every other column, batch modes, a big read kind no tensor map reads,
   bf16 output), mixed bf16 x f32 products (either operand bf16, a split
   chunked walk) and degenerate bf16 ones (an outer product, no own C
   mode)), each launched twice and bit-identical; ``grouped_gemm`` on
   the grouped cases of ``tests/test_runtime.py``, mixed bf16 x f32
   operands and the fig14 ragged set, then every ragged case again in
   bf16 under the default tiles
   (bf16 and f32 output), each case held to the route it must take
   (``wgmma`` for bf16 whose depths pack to multiples of 64, ``fma``
   otherwise); ``flash_attention`` on the grid of ``tests/test_flash_attn.py``,
   the GQA fold, causal cross attention, wide-range scores (f32 and bf16),
   float32 at S off the fma query tile and strided operands, each case
   held to the route it must take (``wgmma`` for every bf16 layout TMA can
   read, ``fma`` otherwise).
4. Copy-freedom: the kernel path moves no data; the conventional baseline
   makes at least its counted transposes.
5. Main path: Tucker HOOI on a low-rank-plus-noise float32 tensor of
   ``size``³ with ranks (10, 10, 10) (the paper's Fig. 9 core), three ways:
   the kernel backend, the torch backend and the conventional baseline.
10. Tuned HOOI (run right after phase 5, on its tensor): a ``"measure"``
   dispatcher with a fresh cache in a temporary directory pretunes the
   HOOI working set on the card (every candidate of every shape, the
   ``kernel`` ones through ``native_gemm``; one line per shape with each
   candidate's µs and the winner), then HOOI runs with
   ``strategy="tuned"`` under ``"cached"``: every lookup must hit with no
   measurement, ``native_gemm``'s launches by route must be what the
   winners imply, and ``rel_error`` within 1e-5 of the kernel variant's;
   its ms (upper median of 2 runs after a warm-up) is printed beside the
   three variants.  The cost model fitted on that cache predicts each
   shape, printed beside the measured winner.  One traced tuned HOOI
   iteration must give every ``contract`` span a ``roofline_fraction``
   (bound over device time, from CUDA events) in (0, 1.05], and its
   Chrome-trace export must parse.
6. Kernel time at each of the main path's launch shapes and its route:
   device time with the calls queued behind a sleeping kernel
   (``queued_ms``) and the call with its host time (CUDA events around
   back-to-back calls, ``cuda_ms``), against its bound, the plain version
   and ``torch.einsum`` timed both ways; two launches at each shape must
   be bit-identical.
7. A profile of one HOOI on the kernel backend: device time by kernel
   name and the device's idle share (the torch and conventional variants'
   profiles were cut for phase 25).
29. CP-ALS (run right after phase 7), the paper's other decomposition,
   in float32 with 25 iterations at 512³ rank 10 and 64 and at
   1024×512×256 rank 16 (``CP_CASES``), each on a tensor made from
   ``--seed`` (orthonormal factor columns, λ = geomspace(1, 0.2, r), 10%
   Gaussian noise), three ways as in phase 5 and tuned as in phase 10:
   (a) the kernel's ``rel_error`` at most 1.001 times the noise share and
   within 1e-5 of the torch backend's and the conventional baseline's, λ
   within rtol 1e-4 and each factor column (its sign aligned) within 1e-3
   of the torch backend's, all finite; (b) the counted run launches
   ``native_gemm`` alone, 6 an iteration (two an MTTKRP: the Khatri-Rao
   factor then its product with T, or tensor-times-matrix then the
   exceptional batched GEMV), each on the route ``native_route`` gives,
   the baselines none; (c) phase 4's copy check on every contraction of
   one iteration; (d) phase 10's tuned run; (e) ms per CP-ALS in turns,
   every launch shape as in phase 6, the init's three ``eigh`` alone,
   one kernel run's device time by kind (``native_gemm``, ``eigh``, the
   solves, the rest) and the counted run's peak memory.
8. Grouped path at full width: the routed experts of qwen2-moe-a2.7b (60
   experts, top-4, d_model 2048 -> d_expert 1408) over 4096 tokens with a
   skewed routing that leaves one expert empty, through ``grouped_matmul``
   in f32, bf16 and bf16 with weights stored ``(1408, 2048)``, and a
   uniform routing in bf16 (the bf16 runs on ``wgmma``, f32 on ``fma``);
   then times the kernel, the path and its packing alone, against
   ``torch._grouped_mm`` (bf16) and the per-group ``torch.matmul`` loop.
9. Attention path at full width: internlm2-20b prefill (48 query heads
   over 8 KV heads folded into BH = 48, D = 128, S = T = 4096) through
   ``flash_attention``: causal in bf16 and f32, non-causal in bf16; then
   times against SDPA, and names the backend SDPA's default call takes in
   f32 (bit-identical output to the efficient or math backend, each timed,
   and its device kernels' names).  Both bf16 runs must take the ``wgmma``
   route.

11. Serving at full width: internlm2-20b at its published widths (d_model
   6144, 48 query heads over 8 KV heads, head dim 128, d_ff 16384, vocab
   92544), bf16 activations over f32 master weights drawn on the card
   from ``--seed``, its depth cut to 4 layers (``SERVE["periods"]``; the
   cut is printed), ``contract_backend="kernel"``.  8 greedy requests of
   32-256 prompt tokens drawn from ``--seed``, 16 new tokens each,
   through ``ServingRuntime(slots=4, max_len=512, prefill_chunk=64)``:
   a warm-up serve, then the counted serve, which must give every
   request its 16 tokens, build no bucket entry, launch ``native_gemm``
   (every launch on the route ``native_route`` gives) and no other
   kernel; one decode pass and one prefill chunk must make one
   ``native_gemm`` launch per model contraction (9 a layer and the LM
   head): ``wgmma`` for the 7 dense products of a layer and the LM head,
   ``batched`` for the scores and P.V products (29 and 8 at 4 layers),
   and the counted serve launches the routes in that ratio.  The legacy
   ``ServeEngine`` must give the same tokens, and a prefill's logits on
   the kernel backend must be within 2e-2 of the largest magnitude of
   the torch backend's.  Then one timed serve on each backend (kernel,
   torch; four in turns until phase 30 took their time): ms per prefill chunk by length,
   ms per decode tick by bucket and tokens/s, each chunk and tick timed
   by the host clock between synchronisations; and the top 8
   ``native_gemm`` launch shapes of the counted serve as in phase 6.
   Then the paged KV-cache: the same 8 requests through
   ``ServingRuntime(paged=True, page_size=16)`` with its default pool (a
   warm-up serve, then the counted paged serve, a path of its own): every
   request's tokens equal the unpaged serve's, the pool is whole after
   the drain (every page free, no refcount), no bucket entry is built
   after the warm-up, every launch is ``native_gemm`` on the route
   ``native_route`` gives.  A prefix-sharing mix drawn from ``--seed`` (8
   requests sharing a 128-token prefix, each with its own 32-128-token
   tail, 16 new tokens each) runs with sharing on and off: the same
   tokens, shared tokens > 0 with sharing on (printed).  Paged and
   unpaged tokens/s in turns (unpaged, paged, paged, unpaged).
12. Every architecture: the ten smoke configs (float32) on the card with
   the kernel backend and on the CPU with the same weights (the plain
   version): one forward, and for decoders a prefill plus 3 decode steps
   (through ``ServingRuntime``, jamba's hybrid cache included; the
   vision model through the model functions, since its prompt carries
   patch features), logits within 1e-4 of the largest magnitude and the
   same tokens.
13. Training at full width: minicpm-2b at its published widths (d_model
   2304, 36 heads (MHA), head dim 64, d_ff 5760, vocab 122753 padded to
   122880 by ``get_config``, tied embeddings), f32 master weights drawn
   on the card from ``--seed``, bf16 activations, its depth cut to 4
   layers (``TRAIN["periods"]``; the cut is printed), remat on,
   ``contract_backend="kernel"`` with ``contract_strategy="native"`` (the
   differentiable kernel path), ``SyntheticLM(seq_len=512,
   global_batch=4)``, AdamW on the WSD schedule (lr 1e-3, warmup 2, 8
   total steps).  The counted run is 6 steps of the port's ``Trainer``
   with a checkpoint at step 3 in a temporary directory: every loss
   finite, step 6's below step 1's; 147 ``native_gemm`` launches a step,
   each on the route ``native_route`` gives and by route what the model
   gives (``train_launches_per_step``: 9 contractions a layer and the LM
   head, the layers' recomputed by remat, two backward launches per
   product: 115 ``wgmma``, the weight gradients' fused b·s included, and
   32 ``batched``), and no other kernel.  A fresh ``Trainer`` restores step 3
   and reruns steps 4-6 within rtol 1e-4 (bit-identity printed).  From
   the initial weights and the first batch: every parameter leaf gets a
   finite nonzero gradient; the torch backend's loss within 2e-2
   relative and each leaf's gradient within 5e-2 of its largest
   magnitude; a ``microbatches=2`` step's parameters within 5e-3 of the
   full batch's; an int8-compressed step finite.  Then ms per step and
   tokens/s, 2 steps on each backend (kernel, torch; four turns until
   phase 30 took their time), peak
   memory of the counted run, a profile of one step per backend, and the
   top 8 ``native_gemm`` launch shapes of a step as in phase 6.
14. Sharded contraction: ``make_host_mesh(1, 1)`` starts a world of one
   rank over NCCL, and a 1x1 mesh with axes ``x`` and ``y`` runs, through
   ``contract``/``xeinsum``/``compile_program`` with ``mesh=`` and
   ``backend="kernel"``: each of the 15 contractions of the HOOI working
   set (512³ float32, ranks 10) three times (a free mode over ``x``; its
   first contracted mode over ``y``, a psum; the same with ``out_spec``
   putting ``y`` on the first output mode, a reduce-scatter);
   internlm2-20b's two MLP products at published widths in bf16 over 2048
   rows (column-parallel ``bse,ef->bsf`` with ``f`` over ``y``,
   row-parallel ``bsf,fe->bse`` with ``f`` contracted over ``y``); the 36
   Table II cases at the ragged dims with ``m`` over ``x`` and ``k`` over
   ``y``; and ``compile_program("bik,kn,nj->bij")`` at ~290 MB.  Each
   plan's ``describe()`` is printed.  The counted run must launch
   ``native_gemm`` once per pairwise step, on the route ``native_route``
   gives, and no other kernel (every device kernel the profiler records
   on the HOOI set and the MLP products is one of ``native_gemm``'s, and
   on Table II and the program one the unsharded calls run); every
   result's ``full_tensor()`` (and local block) equals the unsharded
   kernel call bit for bit, since every block is the whole tensor; its
   copies equal the unsharded call's (0 on the HOOI set and the MLP
   products).  A collective over a one-rank group is the identity and is
   not issued.  Every launch shape of the counted run is then held
   against the plain version and timed as in phase 6, and the HOOI set's
   free and psum calls and the MLP products are timed per call, sharded
   against unsharded, queued (``queued_ms``) and back to back
   (``cuda_ms``, which counts the host's time between calls).  The
   process group is destroyed at the phase's end.
15. The sharded trainer and server: ``make_host_mesh(1, 1)`` starts a new
   world of one (NCCL) with a ``("data", "model")`` mesh, and the default
   ``ShardingRules`` on it.  (a) minicpm-2b at phase 13's cut (4 layers,
   4 x 512 tokens, kernel backend, ``contract_strategy="native"``):
   placing the params on the mesh allocates 0 bytes (views); step 1's
   loss and every gradient under the rules are bit-identical to the
   unsharded step's (every block is the whole tensor, no collective is
   issued), or the first leaf that differs is named and held to ``TOL``;
   then ``Trainer(rules=)`` and the unsharded ``Trainer`` from the same
   weights and batches take 2 steps each, in turns (unsharded, sharded,
   sharded, unsharded), with equal losses, 147 ``native_gemm`` launches a
   step by route in both (each on the route ``native_route`` gives), ms
   per step and peak memory; one profiled step each, where the sharded
   step may run no library GEMM the unsharded one does not.  (b) The
   unsharded trainer's checkpoint restores with ``shardings=`` onto the
   mesh: every leaf a DTensor on the card, bit-equal; a sharded
   ``Trainer.restore(shardings=)`` then steps to the unsharded trainer's
   next loss.  (c) internlm2-20b with phase 11's cut and traffic through
   ``ServingRuntime(mesh=)`` on the kernel backend: ``paged=True`` with a
   mesh raises; the counted serve's tokens and ``native_gemm`` launches by
   route equal phase 11's unpaged kernel serve, as do the tokens of the
   sharded warm-up serve and of an unsharded serve; a profiled decode pass
   each, sharded and unsharded (device time, host wall, idle share: what
   the mesh route costs a pass; the timed serves were cut for phase 25).
   Every launch shape of (a) and (c) that the unsharded runs do not launch
   is held to the plain version and timed as in phase 6.  The process
   group is destroyed; then (d) ``python -m repro_torch.launch.train
   --arch minicpm-2b --smoke --mesh 1x1 --steps 3`` and ``python -m
   repro_torch.launch.serve --arch minicpm-2b --smoke --mesh 1x1`` run in
   subprocesses on the card, both at once, and exit 0.
16. Expert and pipeline parallelism, on phase 15's world and mesh before
   it is destroyed.  (a) One qwen2-moe-a2.7b ``moe_ffn`` with
   ``moe_impl="a2a"`` at full width (60 experts top-4 of 1408, 4 shared)
   over 4096 bf16 tokens under the default rules, kernel backend,
   ``contract_strategy="native"``: finite, within ``TOL`` of the same
   call with every ``native_gemm`` replaced by ``native_gemm_ref``, and of
   the GShard path at capacity factor ``A2A["no_drop_cf"]``, where the
   busiest expert must fit both paths' capacities; its three expert
   products launch on ``batched`` (each held to the plain version, two
   launches bit-identical) and are timed queued against one
   ``torch.bmm`` on the same operands and their bound; their device
   kernels are ``native_gemm``'s alone.  (b) qwen2-moe-a2.7b at published
   widths, depth cut 24 -> 2 layers, f32 master weights, bf16
   activations, remat, a2a, through ``Trainer(rules=)`` (kernel backend,
   native), 4 x 512 tokens a step, 3 steps with a checkpoint at step 2:
   losses finite; launches by route per step what
   ``a2a_launches_per_step`` gives (171: 131 ``wgmma``, 40 ``batched``, 24
   of them expert products), each on ``native_route``'s route; a fresh
   trainer restores step 2 and reruns step 3 within rtol 1e-4; from the
   initial weights every gradient leaf finite and nonzero; the torch
   backend's step on the kernel step's routing (``routing`` replays its
   expert choices) within 2e-2 in loss and 5e-2 of each leaf's largest
   magnitude (on its own routing the error and the tokens rerouted are
   printed); ms per step, the backends in turns, a profile of the kernel
   step, and the counted run's peak memory; then every launch shape of a
   counted step (recorded without its operands), on normal random
   operands with that shape's strides, offsets and types, held to the
   plain version and timed as in phase 6 (3 calls each).  (c) ``pipeline_forward`` over a one-rank
   ``pod`` axis with one internlm2-20b block at published widths as the
   stage (kernel backend, native), 4 microbatches of 512 bf16 tokens:
   output bit-identical to the block called on each microbatch with the
   same launches, and ``pipeline_loss``'s loss and gradients bit-identical
   to the sequential run's, with the same launches; each launch of both on
   ``native_route``'s route, none ``gathered`` (every bf16 product is read
   by tensor maps; the GQA dK and dV, whose ``r`` does not fuse with
   ``s``, take ``batched`` with ``r`` as an outer contracted mode).  The seconds of each part are printed.
17. The dry run, after phase 16's world is destroyed.  (a) ``python -m
   repro_torch.launch.dryrun`` in a subprocess for each of minicpm-2b x
   ``train_4k`` on 16x16 and 2x16x16 and internlm2-20b x ``decode_32k``
   on 16x16, all at once, at published widths with phase 13's depth cut
   (``--cfg-overrides '{"n_periods": 4}'``): each traces its step on fake
   CUDA tensors in a fake world of 256 or 512 ranks; then ``python -m
   repro_torch.launch.roofline`` and ``python -m
   repro_torch.launch.report`` on their records.  Every record must be
   ``ok``, ``launch.roofline``'s rows ``roofline_cell``'s, the report
   must hold every cell, and the 16x16 train cell must sum gradients
   over its data axis (nonzero all-reduce or reduce-scatter bytes); each
   record, its roofline row (H100 ceilings) and its seconds are printed.
   Beside them, in its own subprocess at once, the minicpm-2b
   ``train_4k`` 16x16 cell on the kernel backend (``contract_strategy
   "native"``: each block product one ``repro_torch::native_gemm`` op,
   traced by the op's fake kernel): ``ok``, 147 ops, its flops the
   library cell's plus one down projection a layer (remat's recompute
   stops after an ``autograd.Function``'s forward but before an
   ``aten.mm``), and both cells' bytes, fused bytes, peaks and roofline
   rows printed with their differences.  The loss under sharding rules is
   vocab-parallel (``models.layers.token_nll``): in the three training
   cells no storage live at the traced peak has the vocab as its last
   dim, and each cell's peak per device is printed beside its peak when
   the loss gathered the vocab (612.67 GB on 16x16 on either backend,
   805.66 GB on 2x16x16), with the card's name and power limit.
   (b) Phase 13's step (minicpm-2b, 4 layers, 4 x 512 tokens, unsharded)
   on each backend, torch and kernel, traced on fake CUDA tensors under
   ``repro_torch.utils.CostCounter``, then run for real under the same
   counter: equal flops, and the traced peak within 10% of
   ``max_memory_allocated`` over the real step (above what was allocated
   before its inputs); on the kernel backend the traced
   ``repro_torch.native_gemm`` ops and their routes equal the real step's
   ``native_gemm`` launches by route (147); the step's roofline bound
   (its flops at the bf16 peak, or its bytes fused to its products at the
   HBM rate, whichever is longer) and its fraction of phase 13's ms per
   step on that backend are printed.  Its record is
   printed as a ``{"dryrun": ...}`` line.
21. Host cost of a launch, after phase 17: phase 11's decode-shaped bf16
   ``wgmma`` product (one row of internlm2-20b's KV projection, 6144 x
   1024) called 2000 times back to back with one synchronize at the end:
   the host µs a call (the loop before the synchronize) and the wall µs
   (to its end); ``tools/launch_host_us.py`` times the same on another
   checkout.
22. Serving a state-space model at published width and depth, after phase
   21: mamba2-1.3b (48 layers, d_model 2048, d_state 128, headdim 64,
   expand 2, chunk 128, vocab 50280 padded to 50304, tied embeddings),
   bf16 activations over f32 master weights drawn on the card from
   ``--seed``, ``contract_backend="kernel"`` with ``contract_strategy=
   "native"`` (one ``native_gemm`` launch a product).  8 greedy requests of
   64, 100, 128, 131 (prime: chunks of 1), 256, 512, 2048 and 8192 prompt
   tokens drawn from ``--seed``, 16 new tokens each, through
   ``ServingRuntime(slots=4, max_len=8208)`` with whole-prompt prefill (the
   runtime's rule for SSM stacks): a warm-up serve, then the counted serve,
   which must give every request its 16 tokens, build no bucket entry and
   launch only ``native_gemm``, each launch on the route ``native_route``
   gives: every prefill 289 launches (97 ``wgmma``, 48 ``fbatched``, 48
   ``gathered``, 96 ``batched``; the 131-token one 97 ``wgmma``, 144
   ``fbatched``, 48 ``batched``), every decode pass 145 (97 ``wgmma``, 48
   ``batched``).  (a) Each request's served prefill logits within 2e-2 of
   the largest magnitude of ``transformer.forward``'s last-position logits
   on its prompt; (b) after the 256-token prefill (two chunks), each
   layer's conv window
   and state against a token-by-token ``decode_step`` loop, both against
   a float32-activation prefill of the same weights: the prefill's no
   farther from it than the larger of 2e-2 and twice the loop's (two bf16
   summation orders drift apart with depth; printed); (c) the tokens
   equal ``ServeEngine``'s, and against a float32 forward on the torch
   backend over each request's served tokens the runtime's logits (every
   prefill and decode row) no farther than the larger of 2e-2 and twice
   the torch backend's runtime's (its rows fed the same tokens); at 48
   layers two bf16 runs differ by more than 2e-2 (printed), as each does
   from float32; (e) every SSD launch shape of the 512- and
   8192-token prefills and a 4-slot decode pass on random operands of its
   layout within ``TOL`` of the plain version, bit-identical twice, timed
   queued against its bound, the plain version and one ``torch.einsum``;
   (f) the times of the kernel backend's counted serve and of the torch
   backend's serve of (c) (``contract_strategy="auto"``, library GEMMs),
   both recording every row's logits on the host as they run: ms per
   prefill by length, ms per decode pass by bucket, tokens/s; where a
   decode pass spends device time, and its idle share, on each backend;
   the counted serve's peak memory.  (Cut for phase 25: two further timed
   serves, and the 8192-token prefill's profiles.)
23. Training a state-space model at published width and depth, after
   phase 22: mamba2-1.3b as in phase 22 (48 layers, no cut; 1.344B
   params, f32 masters, bf16 activations), ``contract_backend="kernel"``
   with ``contract_strategy="native"``, through the port's ``Trainer``
   with ``remat=True``, ``SyntheticLM(seq_len=2048, global_batch=2)``
   (the Mamba-2 paper's training context) and phase 13's lr, warmup and
   schedule.  (1) The counted run, 6 steps: every loss finite, step 6's
   below step 1's; 1155 ``native_gemm`` launches a step, each on the route
   ``native_route`` gives and by route what the model gives
   (``ssm_train_launches_per_step``: in_proj and out_proj on ``wgmma``,
   ``CBt`` (float32) on ``fbatched``, ``y_intra`` (W with the head
   minor-most) on ``gathered``, the chunk states and ``y_inter`` on
   ``batched``, each launched in the forward, in remat's recompute and
   twice in the backward, and the tied head three times: 387 ``wgmma``,
   384 ``batched``, 192 ``fbatched``, 192 ``gathered``), no other kernel;
   the run's peak memory.  (2) From the initial weights and the first
   batch, ``value_and_grad`` four ways: the torch backend in float32 (TF32
   off; the reference), the kernel backend in float32, the torch backend
   in bf16, the kernel backend in bf16, at most two gradient trees on the
   card at once: every leaf's gradient finite in each, and zero exactly on
   the leaves the loss does not reach (``unreached_leaves``: the ``norm2``
   of the layers without a feed-forward); the float32 kernel step within
   1e-3 of the reference on every leaf (largest difference over the
   reference's largest magnitude) and on the loss; the bf16 kernel step
   within the larger of 5e-2 and twice the bf16 torch step's distance on
   every leaf, its loss within 2e-2; the worst leaf of each printed.  (3)
   Every launch layout of one recorded step (21) on random operands of
   its layout within ``TOL`` of the plain version, bit-identical twice,
   timed queued against its bound, the plain version and one
   ``torch.einsum``; per-step sums, the top 8 by time and each backward
   layout printed.  (4) ms per step and tokens/s, 1 step on each backend
   (the torch backend warmed by one; the turns were cut for phase 25, the
   second step for phase 30),
   and one profiled step each (top 8 device kernels, idle share).
24. Serving a hybrid SSD + GQA + MoE stack at published width, after
   phase 23: jamba-v0.1-52b (d_model 4096, 32 query heads over 8 KV heads
   of 128, d_ff 14336, vocab 65536; 16 experts top-2 with d_expert 14336,
   capacity factor 1.25, on every other layer; SSD d_state 16, headdim 64,
   expand 2, chunk 128), depth cut to one period of 8 layers (seven Mamba
   mixers, attention at position 4; 13.268B params, 53.07 GB of f32
   masters drawn on the card from ``--seed``), bf16 activations,
   ``contract_backend="kernel"`` with ``contract_strategy="native"``.  8
   greedy requests of 64, 100, 128, 131 (prime: chunks of 1), 256, 512,
   2048 and 4096 prompt tokens drawn from ``--seed``, 16 new tokens each,
   through ``ServingRuntime(slots=4, max_len=4112)`` with whole-prompt
   prefill (the runtime's rule for hybrid stacks; a prompt routes its MoE
   tokens as one dispatch group, a decode row its token alone): a warm-up
   serve (counting the tokens GShard drops in each prefill, printed), then
   the counted serve, which must give every request its 16 tokens, build
   no bucket entry and launch only ``native_gemm``, each launch on the
   route ``native_route`` gives: every prefill 73 launches (256 to 4096
   tokens 31 ``wgmma``, 7 ``fbatched``, 7 ``gathered``, 28 ``batched``;
   131 tokens 31 ``wgmma``, 21 ``fbatched``, 21 ``batched``; one chunk,
   64 to 128 tokens, ``CBt`` on ``stream``), every decode pass 52 (31
   ``wgmma``, 21 ``batched``), as ``ssm_routes`` derives them from the
   layer pattern; the serve's peak memory.  (a) Each request's served
   prefill logits within 2e-2 of the largest magnitude of
   ``transformer.forward``'s last-position logits on its prompt; (b) the
   tokens equal ``ServeEngine``'s; (c) the runtime on the torch backend in
   bf16 and in float32 (TF32 off; the oracle), each fed the kernel
   runtime's tokens, so that every row routes its MoE tokens as the served
   row did: every prefill and decode row of the kernel runtime no farther
   from the oracle than the larger of 2e-2 and twice the bf16 torch
   runtime's worst row; (d) every launch layout of the 128-, 512- and
   4096-token prefills and a 4-slot decode pass on random operands of its layout
   within ``TOL`` of the plain version, bit-identical twice, timed queued
   against its bound, the plain version and one ``torch.einsum``; one MoE
   layer's expert weight casts to bf16 timed against their byte bound;
   (e) one serve on each backend: ms per prefill by length, ms per decode
   pass, tokens/s (the kernel serve's tokens checked); where a decode pass spends device time, and the
   idle share, on each backend (the turns and the 4096-token prefill's
   profiles were cut for phase 25).
25. Serving sliding-window attention at published width and Gemma 2's
   context, after phase 24: gemma2-27b (d_model 4608, 32 query heads over
   16 KV heads of 128, d_ff 36864, vocab 256000 tied; a local layer with a
   4096-token window alternating with a global one; attention softcap 50,
   final-logit softcap 30), depth cut from 46 to 8 layers (5.710B
   params, 22.84 GB of f32 masters drawn on the card from ``--seed``),
   bf16 activations, ``contract_backend="kernel"`` with
   ``contract_strategy="native"``.  8 greedy requests of 64, 511, 2048,
   4095, 4096, 4097, 6000 and 8192 prompt tokens drawn from ``--seed``, 16
   new tokens each, through ``ServingRuntime(slots=4, max_len=8208,
   prefill_chunk=512)`` (chunked prefill, bucketed decode): a warm-up
   serve, then the counted serve (timed: the kernel backend's times),
   which must give every request its 16 tokens, build no bucket entry and launch only ``native_gemm``,
   each launch on the route ``native_route`` gives, every prefill chunk
   (``chunk_schedule``'s, 78 for the 8 prompts) and decode pass 73
   launches (57 ``wgmma``, 16 ``batched``); then the same traffic off
   the page pool (``paged=True, page_size=16``, its default 2053 pages,
   every bucket entry built first, the kernels warm): the unpaged serve's tokens, the same
   launches, the pool whole after the drain, no entry built.  (b) Layer 0
   (local) at the 8192-token prompt's last 512 query rows, its cache
   filled by the rows before in chunks of 512: the kernel backend's
   attention output within 2e-2 of the largest magnitude of the float32
   torch backend's, and the same layer with ``window=None`` farther than
   10x that; (d) the tokens equal ``ServeEngine``'s at every prompt (its
   whole-prompt prefill beside the 4-slot cache); (e) the runtime on the
   torch backend in bf16 (its fed serve timed) and in float32 (TF32 off;
   the oracle), each fed the kernel runtime's tokens, one cache on the
   card at a time: every prefill and decode row of the kernel runtime no
   farther from the oracle than the larger of 2e-2 and twice the bf16
   torch runtime's worst row; (c) each served prefill's logits within 2e-2
   of ``transformer.forward``'s last position at every prompt, the
   longest last; (f) every launch layout of the 8192 prompt's
   last chunk and a 4-slot decode pass at 8208 rows on random operands of
   its layout within ``TOL`` of the plain version, bit-identical twice,
   timed queued against its bound, the plain version and one
   ``torch.einsum``; the 57 weights' casts to bf16 and one layer's
   cache rewrite against their byte bounds; (g) ms per prefill by prompt
   length, per chunk and per decode pass, tokens/s, on each backend (the
   kernel's counted serve and the torch backend's fed serve, both
   recording every row's logits on the host as they run); where a decode
   pass spends device time, and the idle share, on each backend; the
   peak memory of each stage.
26. Training an encoder at published width and depth, after phase 25:
   hubert-xlarge (d_model 1280, 16 heads of 80, d_ff 5120 with GELU, the
   504-entry codebook head padded to 512 and untied, bidirectional
   attention, an audio frontend projecting 512-d frames; 48 layers, no
   cut; f32 masters drawn on the card from ``--seed``, bf16
   activations), ``contract_backend="kernel"`` with
   ``contract_strategy="native"``, through ``Trainer`` with
   ``remat=True`` on ``SyntheticLM(seq_len=781, global_batch=4,
   with_features=(None, 512), labels=True)`` as ``launch.train`` builds
   it (781 frames: fairseq's HuBERT crop cap of 250000 samples at 16 kHz
   after the wav2vec 2.0 conv stack) and phase 13's warmup and schedule
   at lr 1e-4 (at phase 13's 1e-3 both backends' losses climb for 5
   steps before they fall).  Phase 23's checks (``train_at_width``): (1) 6 steps, losses
   finite and falling, 1541 ``native_gemm`` launches a step, each on the
   route ``native_route`` gives and by route what the model gives
   (``hubert_train_launches_per_step``: the dense products on ``wgmma``
   four times each, the frontend twice, the head three times; the
   scores and dP on ``batched``; P.V, dV, dQ and dK on ``gathered``,
   since a 781-key bf16 probability row is no multiple of 16 bytes:
   1157, 144, 240), no other kernel, the peak memory; (2) the float32
   oracle, the zero gradient only on ``embed``, which an audio model
   never reads (``unreached_leaves``); (3) every launch layout of a
   step; (4) ms per step and tokens (frames)/s, 1 step a backend (2 until
   phase 30), one profiled
   step each with device time summed by kind (``STEP_KINDS``:
   ``native_gemm``'s kernels, f32 adds, fills, copies).  Then (5) the 8
   attention layouts of one layer at 768 frames (every one on
   ``batched``), each within ``TOL``, bit-identical twice and timed,
   beside the same product at 781 frames, and one layer's weight casts
   to bf16 against their byte bound.
27. Serving multi-query attention at published width, after phase 26:
   granite-20b (d_model 6144, 48 query heads over one KV head of 128,
   d_ff 24576 with GELU, vocab 49152 untied), depth cut from 52 to 8
   layers (3.637B params, 14.55 GB of f32 masters drawn on the card from
   ``--seed``), bf16 activations, ``contract_backend="kernel"`` with
   ``contract_strategy="native"``; code completion over repository
   context: 8 greedy requests of 64, 511, 512, 513, 2048, 4097, 6000 and
   8192 prompt tokens drawn from ``--seed``, 16 new tokens each, through
   phase 25's ``serve_at_width`` (the same runtime, its checks (a) and
   (c)-(g), chunk and decode-pass launches derived from the layer
   pattern: 65 a pass, 49 ``wgmma`` and 16 ``batched``).  Its (b) is the
   broadcast: ``native_plan`` on layer 0's own scores and P·V at the
   8192 prompt's last chunk puts the 48 query heads on a grid mode of
   ``batched`` whose K (V) stride is 0, one K (V) tile serving all 48 with
   no copy, and in a 4-slot decode pass at 8208 rows makes them the
   tile's 48 rows, W carrying no head mode (both plans' grids and tiles
   logged); layer 0's output there within 2e-2 of the float32 torch
   backend's, and the same layer with K and V copied out to 48 heads (G =
   48, the copy the broadcast avoids) within 2e-2 of it; the scores timed
   queued three ways: broadcast, copy then GEMM, ``torch.einsum``.  The
   decode pass's P·V (4 tiles, 8208 deep, never split) is logged by name
   beside its bound and einsum.
28. Serving a MoE at published width and depth, after phase 27:
   qwen2-moe-a2.7b (d_model 2048, 16 heads over 16 KV heads of 128; every
   layer MoE: 60 routed experts of 1408 top-4, renormalised, and 4
   ungated shared experts of 1408, SwiGLU; vocab 151936 untied), 24 of 24
   layers (14.316B params, 57.26 GB of f32 masters drawn on the card from
   ``--seed``), bf16 activations, ``contract_backend="kernel"`` with
   ``contract_strategy="native"``; a chat assistant's traffic: 8 greedy
   requests of 64, 511, 512, 513, 1024, 2048, 4096 and 4097 prompt tokens
   drawn from ``--seed``, 8 new tokens each, through ``serve_at_width``
   (``ServingRuntime(slots=4, max_len=4112, prefill_chunk=512)``, unpaged
   and paged; every chunk and decode pass 505 launches, 385 ``wgmma``: Q,
   K, V, O and the 4 shared experts' 3 products a layer, the head; 120
   ``batched``: the scores, P·V and the 3 expert products a layer).  A
   MoE stack's chunked prefill routes each chunk as dispatch groups of
   its own, so (c) and (d) hold a whole-prompt serve
   (``chunked_prefill=False``), which routes as ``forward`` and
   ``ServeEngine`` do, and the chunked serve only at prompts of one chunk
   (64, 512); GShard's drops are logged by MoE layer for every chunk,
   whole-prompt prefill and decode pass (a decode pass must drop none);
   the float32 oracle runs on 3 slots (4 would not fit beside the
   masters); no warm-up serve (the runtime's build runs every lattice
   point; the paged serve repeats the counted serve's tokens).  Its (b) is the experts at width: ``native_plan`` on layer
   0's expert products at the 4097 prompt's last 512 rows and in a 4-slot
   decode pass puts the 60 experts on a grid mode of ``batched`` that X
   and W walk at a stride (no copy), and the decode's up-projections'
   slots on a grid mode of W stride 0 (the weights re-read a slot, bytes
   logged); layer 0's MoE output there within 2e-2 of the float32 torch
   backend's on the same input, the rows whose top-4 sets differ from
   float32's own counted; the expert products queued three ways: the
   kernel, ``torch.einsum``, and ``expert_in`` copied to (x, g·c, e) then
   one ``torch.bmm`` (the conventional path).  The decode pass's expert
   up-projection is logged by name beside its bound and einsum.
30. Serving a vision-language model at published width and depth, after
   phase 28: internvl2-2b (d_model 2048, 16 heads over 8 KV heads of 128,
   d_ff 8192 SwiGLU, vocab 92553 padded to 92672, untied; the JAX
   package's stub frontend: 256 patch positions of 1024 features through
   one linear projection, prepended to the text), 24 of 24 layers (7.57 GB
   of f32 masters drawn on the card from ``--seed``), bf16 activations,
   ``contract_backend="kernel"`` with ``contract_strategy="native"``; a
   VLM chat endpoint's traffic, one image a request (features N(0, 1)
   from ``--seed``): 8 requests alone of 32-3840 text tokens and one batch
   of 4 of 1024, 16 greedy tokens each, through the model's own
   ``transformer.prefill`` (tokens and features, the whole prompt) and
   ``decode_step`` on a cache of 4112 rows (``ServingRuntime`` takes no
   image).  (a) Every prefill 218 launches (170 ``wgmma``: Q, K, V, O
   and the 3 MLP products a layer, the head, the projector; 48
   ``batched``: the scores and P·V a layer), every decode pass 217, as
   ``ssm_routes`` derives them; (b) each cache holds 256 + L rows, zeroed
   features move the prefill's last logits by more than 10x 2e-2, the
   projector's launch within 2e-2 of float32 on the same features; (c)
   every served row (prefill and decode) within 2e-2 of ``forward`` over
   image, prompt and the tokens before, padded after its last token to
   the cache's width (forward's softmax rows then as wide as the served
   ones), and the prefill rows against forward unpadded logged; (d) the
   batch's rows within 2e-2 of its requests alone fed its tokens, tokens
   equal wherever the float32 oracle's top-two margin exceeds 2e-2, bit
   identity logged; (e) every row no farther from the float32 forward
   (torch backend) fed the same tokens than max(2e-2, 2x the bf16 torch
   backend's serve); (f) every launch layout of the 4096-position prefill
   and of a 1-slot and a 4-slot decode pass against bound, plain and
   einsum, the weights' casts against their byte bound; (g) ms per
   prefill and decode pass, tokens/s, both backends; the prefill and a
   4-slot decode pass profiled by kind; peaks by stage.
   Then the seconds of every phase.
19. Float32 products on ``fbatched``, right after phase 14: the 36 f32
   Table II cases at n = 256 through ``contract(strategy="native")`` as a
   counted run (36 launches, all ``fbatched``), then each case at n = 256
   and Fig. 3's case 1.3 (``strategy="batched"``) at n = 16 to 256:
   route, error against ``native_gemm_ref``, two launches bit-identical,
   queued ms of the kernel, the conventional baseline, one
   ``torch.einsum`` (TF32 off) and the plain version, against the bound.
   Phase 14 re-times its 55 launch shapes (the three 512³ Grams and the
   program's ``bik,kn->bin`` among them, on ``fbatched``).
20. The products the retired ``generic`` route took, right after phase
   19: the 36 bf16 Table II cases at ragged extents (``gathered``) and the
   36 with A bf16 and B float32 at n = 256 (``fbatched``, widening) as a
   counted run (72 launches, 36 on each), then both on integer-valued
   operands bit-identical, then each case of both sets (bf16 at ragged
   extents, mixed at n = 256): route, error against
   ``native_gemm_ref``, two launches bit-identical, queued ms of the
   kernel, one ``torch.einsum`` (the mixed set: of A cast to float32, the
   cast included) and the plain version, against the bound; and a
   gathered product's rows in launches of 1, 64 and 1000 rows, bit for
   bit.
18. Tensor-core products, right after phase 16 (before 17): every launch
   shape of the counted runs of phases 11, 13, 15 and 16 (16 (c) too)
   that takes the ``batched`` route or fuses its contracted modes (noted by
   ``native_routes_held``), on normal random operands laid out as the
   path's own: within ``TOL`` of ``native_gemm_ref``, two launches
   bit-identical, timed queued against its bound, the plain version and
   one ``torch.einsum``; sums per serve, step or layer of each path.

Each path (5, 10, 29 at each case, 8, 9, 11, the paged serve of 11, 12, 13, 14, 19, 20, 15's
training and serving, 16's layer, training and pipeline, 22, 23, 24, 25 and its
paged serve, 26, 27 and its paged serve, 28 and its paged serve, 30) is driven with every
kernel's launch count set to 0 just before it and read just after;
launches made to compare, time or tune a kernel do not count.  Phases 5,
10 and 29 also read ``native_gemm``'s launches by route, which must be
what ``native_route`` gives for each launch shape (and, in phases 10 and
29, what the tuner's winners imply).

Tolerances: integer-valued inputs are exact under any summation order, so
they must match bit for bit; float32 results may differ from the plain
version's by the summation order, 2e-5 of the largest output magnitude;
bfloat16 inputs keep ~3 digits, 2e-2.  A grouped case takes its output
type's tolerance: bfloat16 inputs with a float32 output differ only by
the summation order, like float32.  Attention outputs take that
magnitude per row (see ``row_rel_err``), and at full width the bfloat16
kernel's distance to the float32 reference may be at most twice the
plain version's own.  TF32 is switched off for matmuls and cuDNN, so the
library calls compared against run in full float32.

The last lines of stdout are a JSON ``kernels`` record (the grouped and
attention entries carry their f32 run, the fma route, under ``"fma"``;
``native_gemm``'s carries the tuned HOOI's launches by route, phase
29's launches under ``cp_launches``/``cp_launches_by_route`` and each
case's checks, times per CP-ALS and launch-shape sums under ``cp``, the
serving phase's launches, routes, tokens/s and top-shape times (the
paged serve's under ``serve.paged``) and the training phase's launches
by route, ms per step, tokens/s, peak memory and top-shape times, and
the sharded phase's launches by route and ms under ``sharded``, and
phase 15's under ``sharded_train`` (launches by route, ms per step, peak
memory) and ``sharded_serve`` (launches, tokens/s), and phase 16's a2a
training launches under ``a2a_launches``/``a2a_launches_by_route``, its
layer, expert-product times and training checks under ``a2a`` and the
pipeline's launches under ``pipeline_launches``, phase 21's host µs
a call under ``host``, and phase 22's launches under
``ssm_serve_launches``/``ssm_serve_launches_by_route`` and its checks and
times under ``ssm_serve``, and phase 23's launches, losses, oracle
distances, launch layouts, times and peak memory under ``ssm_train``, and
phase 24's launches under ``jamba_serve_launches``/
``jamba_serve_launches_by_route`` and its drops, checks, layouts, casts,
times and peak memory under ``jamba_serve``, and phase 25's launches under
``gemma2_serve_launches``/``gemma2_serve_launches_by_route`` and its
paged launches, checks, layouts, casts, times and peaks under
``gemma2_serve``, and phase 26's launches, losses, oracle distances,
layouts, attention at both lengths, casts, times and peak memory under
``hubert_train``, and phase 27's launches under ``granite_serve_launches``/
``granite_serve_launches_by_route`` and its plans, broadcast checks and
times, paged launches, layouts, casts, times and peaks under
``granite_serve``, and phase 28's launches under
``qwen2_moe_serve_launches``/``qwen2_moe_serve_launches_by_route`` and
its expert plans, MoE checks and times, drops, whole-prompt serve, paged
launches, layouts, casts, times and peaks under ``qwen2_moe_serve``, and
phase 30's launches under ``internvl2_serve_launches``/
``internvl2_serve_launches_by_route`` and its checks, layouts, casts,
times, profiles and peaks under ``internvl2_serve``), then
``native_gemm.batched``, the batched route on its own line: phase 13's
counted launches on it, and its times per train step from phase 18 (every
path's under ``tc_shapes``), then ``native_gemm.f32``, the fbatched route
on its own line: phase 19's counted launches and their summed times
(every row under ``table2``, phase 14's fbatched shapes and Grams under
``sharded_fbatched``), then ``native_gemm.gathered`` and
``native_gemm.mixed``, the gathered route and fbatched's widening kernel
each on its own line: phase 20's counted launches on it and its set's
summed times (every set's sums under ``former_generic``); the batched,
fbatched and gathered lines also carry each route's launches on phase
22's mamba2 serve (``model_launches``: per prefill in chunks of more than
one token and in the counted serve; per train step of phase 23; per
4096-token prefill and in the counted serve of phase 24's jamba; per
prefill chunk or decode pass and in the counted serve of phase 25's
gemma2, phase 27's granite and phase 28's qwen2-moe; per prefill, per
decode pass and in the counted serve of phase 30's internvl2; per train
step of phase 26's hubert) and its SSD launch shapes on the mamba2 serve
and its launch layouts on the jamba, gemma2, granite, qwen2-moe and
internvl2 serves, summed (``ssm_shapes``, ``jamba_shapes``,
``gemma2_shapes``, ``granite_shapes``, ``qwen2_moe_shapes``,
``internvl2_shapes``),
the card's name and power limit as ``nvidia-smi`` prints them, and the
``{"ok": true, ...}`` line.  Any failed check raises and exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

KERNEL_SOURCES = ("sb_gemm", "grouped_gemm", "flash_attn")

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RAGGED_DIMS = {"m": 383, "n": 257, "p": 47, "k": 321}
RANKS = (10, 10, 10)


def log(*args):
    print(*args, flush=True)


def rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude (at least 1)."""
    diff = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    scale = max(1.0, want.float().abs().max().item() if want.numel() else 0.0)
    return diff / scale


def row_rel_err(got, want) -> float:
    """The worst row's largest absolute difference over that row's largest
    reference magnitude (rows along the last axis).  An attention output
    is a weighted mean of ``v``: its scale falls with the row's count of
    visible keys, so a scale taken over the whole tensor would let most
    rows differ by several times their own size."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = w.abs().amax(dim=1).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - w).abs().amax(dim=1) / scale).max().item()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after two warm-ups."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: cycles of the sleeping kernel that a run of calls first queues behind in
#: ``queued_ms``: about 5 ms at the H100's 1980 MHz, doubled while the host
#: cannot queue the calls in time; a run that would need ``QUEUE_SLEEP_MAX``
#: (about 400 ms) fails
QUEUE_SLEEP_CYCLES = 10_000_000
QUEUE_SLEEP_MAX = 800_000_000


def queued_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls are all queued behind
    a sleeping kernel before the first of them runs, and CUDA events time
    them from the sleep's end, so the host's time between launches is not
    counted (``cuda_ms`` counts it).  Of two rounds the first warms what a
    queue of calls needs (pinned host blocks); a round whose sleep ended
    before the queue was full is run again with a longer sleep."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    fn()
    cycles, rounds = QUEUE_SLEEP_CYCLES, 0
    while rounds < 2:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()      # the sleep still ran: nothing waited on the host
        torch.cuda.synchronize()
        if queued:
            rounds += 1
        else:
            check(cycles < QUEUE_SLEEP_MAX, "calls could not be queued behind the sleep")
            cycles *= 2
    return start.elapsed_time(end) / reps


def dtype_label(dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


def modes_of(spec: str):
    a, rest = spec.split(",")
    b, c = rest.split("->")
    return a, b, c


# ----------------------------------------------------------------- phase 1/2
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build() -> dict:
    """Build every kernel source at once (nvcc runs outside the GIL);
    returns each one's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        return dict(zip(KERNEL_SOURCES, pool.map(one, KERNEL_SOURCES)))


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """Least time (ms) for ``nbytes`` moved and ``flops`` done at the card's
    peaks for ``dtype``, and which of the two bounds it.  The peaks are the
    port's table (``repro_torch.obs.roofline.DEVICE_PEAKS``, from NVIDIA's
    data sheet), for whatever units the kernel uses: the port's float32
    kernels accumulate with plain FMA, so float32 takes the FMA peak."""
    from repro_torch.obs.roofline import roofline_bound

    us, by = roofline_bound(flops, nbytes, dtype, torch.cuda.get_device_name(0))
    return us / 1e3, by


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------- phase 3
#: the tensor-core launch shapes of the counted runs of phases 11, 13, 15
#: and 16 that the batched route or a fused contraction gives: layout key
#: -> {"layout": ..., "route": ..., "k_modes": ..., "launches": {path: n}};
#: phase 18 holds and times each
TC_SHAPES: dict = {}
#: each path's counted run in units: path -> (units, unit name)
TC_UNITS: dict = {}


def layout_key(A, B, kw) -> tuple:
    """A launch's modes, operand shapes, strides, storage offsets and
    types, and options: what :func:`operands_like` rebuilds it from."""
    layout = tuple((tuple(t.shape), t.stride(), t.storage_offset(), t.dtype) for t in (A, B))
    return (kw["a_modes"], kw["b_modes"], kw["c_modes"], *layout,
            kw.get("out_dtype")), (layout, dict(kw))


class native_routes_held:
    """Within the block, every ``native_gemm`` launch (through
    ``kernels.ops``, where every path calls it) must launch the route
    ``native_route`` gives for its operands; ``tally`` counts the routes
    seen.  A call with an empty output launches nothing.  Given a
    ``path`` label, each launch on the batched route, or on the wgmma
    route with fused contracted modes, is noted in :data:`TC_SHAPES`
    under it."""

    def __init__(self, path: str | None = None):
        from repro_torch.kernels.sb_gemm import ROUTES

        self.tally = dict.fromkeys(ROUTES, 0)
        self.path = path

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.sb_gemm import native_gemm, native_plan

        self.real = real = ops.native_gemm

        def held(A, B, **kw):
            want, plan = native_plan(A, B, a_modes=kw["a_modes"], b_modes=kw["b_modes"],
                                     c_modes=kw["c_modes"])
            before = dict(native_gemm.launches_by_route)
            out = real(A, B, **kw)
            ran = {r: n - before[r] for r, n in native_gemm.launches_by_route.items()}
            launched = int(out.numel() > 0)
            check(ran == {r: launched * (r == want) for r in ran},
                  f"native_gemm {kw['a_modes']},{kw['b_modes']}->{kw['c_modes']} "
                  f"A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)}{B.stride()}: launched "
                  f"{ran}, native_route says {want}")
            self.tally[want] += launched
            if self.path and launched and (want == "batched" or want == "wgmma"
                                           and len(plan["k_modes"]) > 1):
                key, layout = layout_key(A, B, kw)
                rec = TC_SHAPES.setdefault(key, dict(layout=layout, route=want,
                                                     k_modes=plan["k_modes"], launches={}))
                rec["launches"][self.path] = rec["launches"].get(self.path, 0) + 1
            return out

        ops.native_gemm = held
        return self.tally

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.native_gemm = self.real
        return False


def routes_text(tally) -> str:
    return ", ".join(f"{r} {n}" for r, n in tally.items() if n) or "none"


def check_table2(dev) -> dict:
    from repro_torch.core.contract import contract
    from repro_torch.core.table2 import CASES
    from repro_torch.kernels.ext_gemm import ext_gemm
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0
    tallies = {}
    for label in sorted(CASES):
        rm = CASES[label].row_major()
        a, b, c = modes_of(rm)
        for dt in worst:
            with native_routes_held() as tally:
                A = torch.randn([RAGGED_DIMS[m] for m in a], device=dev, generator=gen).to(dt)
                B = torch.randn([RAGGED_DIMS[m] for m in b], device=dev, generator=gen).to(dt)
                want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c,
                                       out_dtype=torch.float32)
                runs = {s: contract(rm, A, B, strategy=s, backend="kernel",
                                    out_dtype=torch.float32)
                        for s in ("native", "batched")}
                if CASES[label].exceptional:
                    runs["ext_gemm"] = ext_gemm(rm, A, B, out_dtype=torch.float32)
                torch.cuda.synchronize()
                for how, got in runs.items():
                    err = rel_err(got, want)
                    check(err <= TOL[dt], f"Table II {label} {rm} {how} {dt}: error {err}")
                    worst[dt] = max(worst[dt], err)
                    n_checks += 1
            total = tallies.setdefault(dt, Counter())
            total.update(tally)
            # every float32 launch is a product of two float32 operands; no
            # tensor map steps a bf16 row of RAGGED_DIMS
            alone = "fbatched" if dt == torch.float32 else "gathered"
            check(set(+Counter(tally)) == {alone},
                  f"Table II {label} {rm} {dt}: native_gemm routes {routes_text(tally)}, "
                  f"not {alone} alone")
    log(f"table2: {n_checks} checks (36 cases x native/batched + 8 ext_gemm, f32 and bf16) "
        f"worst error f32 {worst[torch.float32]:.3g} bf16 {worst[torch.bfloat16]:.3g}; "
        f"native_gemm routes: f32 {routes_text(tallies[torch.float32])} (fbatched alone), "
        f"bf16 {routes_text(tallies[torch.bfloat16])} (gathered alone)")
    return worst


def check_layoutfuzz(dev, n_cases: int = 100) -> None:
    from repro_torch import layoutfuzz
    from repro_torch.core.contract import contract
    from repro_torch.interop import from_numpy
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    n = 0
    with native_routes_held() as tally:
        for i in range(n_cases):
            cs, _, An, Bn, treatments = layoutfuzz.gen_layout_case(i)
            A, B = from_numpy((An, Bn), device=dev)
            spec = cs.spec_str()
            want = np.einsum(spec, An, Bn)
            plain = native_gemm_ref(A, B, a_modes=cs.a_modes, b_modes=cs.b_modes,
                                    c_modes=cs.c_modes).cpu().numpy()
            check(np.array_equal(plain, want), f"fuzz {i} {spec}: plain version vs numpy")
            for strategy in ("native", "auto", "batched"):
                got = contract(cs, A, B, strategy=strategy, backend="kernel").cpu().numpy()
                check(np.array_equal(got, plain),
                      f"fuzz {i} {spec} {treatments} {strategy}: not bit-identical")
                n += 1
    log(f"layoutfuzz: {n_cases} specs x native/auto/batched = {n} runs, all bit-identical; "
        f"native_gemm routes: {routes_text(tally)}")


def check_grads(dev) -> None:
    from repro_torch.core.contract import contract
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    specs = [("pk,mkn->nmp", (5, 7), (4, 7, 3)), ("mk,kn->mn", (6, 4), (4, 5)),
             ("k,k->", (9,), (9,)), ("bmk,bkn->bnm", (2, 3, 4), (2, 4, 5)),
             ("mq,qn->qnm", (3, 4), (4, 5))]
    gen = torch.Generator(device=dev).manual_seed(6)
    with native_routes_held() as tally:
        for spec, sa, sb in specs:
            a, b, c = modes_of(spec)
            A0 = torch.randn(sa, device=dev, generator=gen)
            B0 = torch.randn(sb, device=dev, generator=gen)
            A, B = A0.clone().requires_grad_(), B0.clone().requires_grad_()
            (contract(spec, A, B, strategy="native") ** 2).sum().backward()
            Ar, Br = A0.clone().requires_grad_(), B0.clone().requires_grad_()
            (native_gemm_ref(Ar, Br, a_modes=a, b_modes=b, c_modes=c) ** 2).sum().backward()
            for g, r, name in ((A.grad, Ar.grad, "dA"), (B.grad, Br.grad, "dB")):
                err = rel_err(g, r)
                check(err <= TOL[torch.float32], f"grad {spec} {name}: error {err}")
    log(f"grads: execute_native gradients match the plain version on {len(specs)} specs; "
        f"native_gemm routes: {routes_text(tally)}")


def native_route_cases(dev):
    """Cases that force each route of ``native_gemm`` at ragged extents:
    (spec, A, B, out_dtype, route, integer-valued)."""
    from repro_torch.kernels.sb_gemm import STREAM_MIN_ROWS

    gen = torch.Generator(device=dev).manual_seed(16)
    # rows off the stream tile, a multiple of 4: a row stride TMA can step
    big = STREAM_MIN_ROWS + 436

    def rn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def ints(*shape):
        return torch.randint(-3, 4, shape, device=dev, generator=gen).float()

    cases = []
    for r in (1, 10, 16):
        # stream, read kind: m stride-1, then k stride-1 (rows 80 apart), k = 77
        cases += [("mn,mi->ni", rn(77, big), rn(77, r), None, "stream", False),
                  ("mp,pk->mk", rn(big, 80)[:, :77], rn(77, r), None, "stream", False),
                  # splitk: two C modes of X, three C modes in all, one long k
                  ("npi,nj->ijp", rn(300, 37, 10), rn(300, r), None, "splitk", False),
                  ("mnk,nj->mjk", rn(77, 300, 7), rn(300, r), None, "splitk", False),
                  ("mn,mi->in", rn(515, 1000), rn(r, 515).t(), None, "splitk", False)]
    # stream, write kind: depths 3, 10, 16; rows 512 and 130 wide (16-byte
    # and scalar stores)
    for k, p in ((3, 512), (10, 130), (16, 512)):
        cases.append(("km,pk->mp", rn(k, big), rn(p, k), None, "stream", False))
    # bf16 output on each kernel, and integer-valued inputs (exact sums)
    cases += [("mn,mi->ni", rn(77, big), rn(77, 10), torch.bfloat16, "stream", False),
              ("mp,pk->mk", rn(big, 80)[:, :77], rn(77, 10), torch.bfloat16, "stream", False),
              ("km,pk->mp", rn(10, big), rn(512, 10), torch.bfloat16, "stream", False),
              ("npi,nj->ijp", rn(300, 37, 10), rn(300, 10), torch.bfloat16, "splitk", False),
              ("mn,mi->ni", ints(77, big), ints(77, 10), None, "stream", True),
              ("mp,pk->mk", ints(big, 80)[:, :77], ints(77, 16), None, "stream", True),
              ("km,pk->mp", ints(10, big), ints(130, 10), None, "stream", True),
              ("mnk,nj->mjk", ints(77, 300, 7), ints(300, 10), None, "splitk", True),
              # a big side no tensor map reads (rows 77 floats apart): fbatched
              ("mp,pk->mk", rn(big, 77), rn(77, 10), None, "fbatched", False)]
    # fbatched: Table II's layouts at ragged extents (grid modes in X, in W
    # only, in neither), a split Gram (an outer contracted mode), a stride-0
    # view, a start 4 bytes off, every other column, batch modes, bf16
    # output, integer-valued inputs (exact sums)
    cases += [("km,npk->pnm", rn(321, 383), rn(257, 47, 321), None, "fbatched", False),
              ("kn,pmk->pnm", rn(321, 257), rn(47, 383, 321), None, "fbatched", False),
              ("pk,kmn->pnm", rn(47, 321), rn(321, 383, 257), None, "fbatched", False),
              ("mnp,mqp->nq", rn(300, 40, 256), rn(300, 72, 256), None, "fbatched", False),
              ("mnp,mqp->nq", ints(300, 40, 256), ints(300, 72, 256), None, "fbatched", True),
              ("mk,pkn->pnm", rn(1, 45).expand(300, 45), rn(20, 45, 190), None, "fbatched",
               False),
              ("mk,kn->mn", rn(400 * 68 + 1)[1:].view(400, 68)[:, :66], rn(66, 152), None,
               "fbatched", False),
              ("mk,kn->mn", rn(400, 140)[:, ::2], rn(70, 150), None, "fbatched", False),
              ("bmk,bkn->bnm", rn(3, 140, 33), rn(3, 33, 170), None, "fbatched", False),
              ("mk,kn->mn", rn(200, 66), rn(66, 152), torch.bfloat16, "fbatched", False),
              ("km,pkn->pnm", ints(321, 383), ints(47, 321, 257), None, "fbatched", True),
              ("kn,mkp->pnm", ints(321, 257), ints(383, 321, 47), None, "fbatched", True)]

    # wgmma: bf16 weight streaming, 1032 columns (a ragged last tile), rows
    # 1 (a stride-0 decode row) to 200, depths 6144 (split 14 ways), 1000
    # (a ragged last split) and 328 (a ragged last stage)
    def bf(*shape):
        return rn(*shape).bfloat16()

    def bints(*shape):
        return ints(*shape).bfloat16()

    def rows(m, k):
        return bf(1, k).as_strided((1, k), (0, 1)) if m == 1 else bf(m, k)

    n = 1032
    for m in (1, 2, 4, 63, 64, 65, 200):
        for k in (6144, 328):
            cases.append(("be,ef->bf", rows(m, k), bf(k, n), None, "wgmma", False))
    # W K-major, X M-major, f32 output, integer-valued inputs (exact sums)
    for m, k in ((1, 6144), (65, 328), (200, 6144)):
        cases.append(("be,fe->bf", rows(m, k), bf(n, k), None, "wgmma", False))
    cases += [("eb,ef->bf", bf(6144, 200), bf(6144, n), None, "wgmma", False),
              ("eb,fe->bf", bf(328, 64), bf(n, 328), None, "wgmma", False),
              ("be,ef->bf", bf(4, 6144), bf(6144, n), torch.float32, "wgmma", False),
              ("be,fe->bf", bf(65, 328), bf(n, 328), torch.float32, "wgmma", False),
              ("be,ef->bf", bf(3, 1000), bf(1000, n), None, "wgmma", False),
              ("be,ef->bf", bints(2, 6144), bints(6144, n), None, "wgmma", True),
              ("be,fe->bf", bints(200, 6144), bints(n, 6144), torch.float32, "wgmma", True),
              ("eb,ef->bf", bints(328, 64), bints(328, n), None, "wgmma", True),
              # bf16 that TMA cannot read: W's rows 1030 bytes apart, gathered
              ("be,ef->bf", bf(4, 6144), bf(6144, 515)[:, :512], None, "gathered", False),
              ("be,ef->bf", bints(4, 6144), bints(6144, 515)[:, :512], torch.float32,
               "gathered", True),
              ("be,ef->bf", bf(1000, 6144), bf(6144, 515)[:, :512], None, "gathered", False)]

    # fused contracted modes (b, s) on wgmma: weight gradients, X M-major
    # (never split) at 136 to 5000 rows (64- and 128-row tiles); and X
    # K-major, split 4 ways
    cases += [("bsv,bse->ve", bf(2, 100, 1000), bf(2, 100, 136), None, "wgmma", False),
              ("bsf,bse->ef", bf(2, 512, 200), bf(2, 512, 136), None, "wgmma", False),
              ("bse,bsf->fe", bf(2, 100, 136), bf(2, 100, 5000), None, "wgmma", False),
              ("bsf,bse->ef", bints(2, 512, 200), bints(2, 512, 136), torch.float32, "wgmma",
               True),
              ("bsf,bse->ef", bf(2, 100, 200), bf(2, 100, 40), None, "wgmma", False),
              ("mbs,nbs->mn", bf(136, 2, 512), bf(200, 2, 512), None, "wgmma", False),
              ("mbs,nbs->mn", bints(136, 2, 512), bints(200, 2, 512), torch.float32, "wgmma",
               True),
              # ... and in float32, onto splitk
              ("mkq,kqi->mi", rn(40, 6, 7), rn(6, 7, 3), None, "splitk", False)]
    # batched: attention (3 grid modes b, g, r; S, T and C2 off the tiles;
    # X M-major in dK; an outer contracted mode r beside s in a GQA dK and
    # dV; one decode row), expert products (K = 341 rows off a stage),
    # GShard's (g and c fuse), a 1024-deep decode P.V
    cases += [("bsgrd,btgd->bgrst", bf(2, 70, 3, 2, 64), bf(2, 136, 3, 64), None, "batched",
               False),
              ("bgrst,btgd->bsgrd", bf(2, 3, 2, 70, 136), bf(2, 136, 3, 64), None, "batched",
               False),
              ("bgrst,bsgrd->btgd", bf(2, 3, 1, 70, 136), bf(2, 70, 3, 1, 64), None,
               "batched", False),
              ("bgrst,bsgrd->btgd", bf(2, 3, 2, 70, 136), bf(2, 70, 3, 2, 64), None,
               "batched", False),
              ("bsgrd,bgrst->btgd", bf(2, 70, 3, 2, 64), bf(2, 3, 2, 70, 136), None,
               "batched", False),
              ("bgrst,bsgrd->btgd", bints(2, 3, 2, 70, 136), bints(2, 70, 3, 2, 64),
               torch.float32, "batched", True),
              ("bsgrd,btgd->bgrst", bf(4, 1, 3, 1, 64), bf(4, 136, 3, 64), None, "batched",
               False),
              ("bgrst,btgd->bsgrd", bf(1, 2, 6, 1, 1024), bf(1, 1024, 2, 128), None, "batched",
               False),
              ("xce,xef->xcf", bf(3, 341, 256), bf(3, 256, 200), None, "batched", False),
              ("xcf,xfe->xce", bf(3, 341, 200), bf(3, 200, 256), None, "batched", False),
              ("xcf,xce->xef", bf(3, 341, 200), bf(3, 341, 256), None, "batched", False),
              ("xgce,xef->xgcf", bf(3, 2, 40, 256), bf(3, 256, 200), None, "batched", False),
              ("xce,xef->xcf", bf(3, 341, 256), bf(3, 256, 200), torch.float32, "batched",
               False),
              ("bgrst,btgd->bsgrd", bints(2, 3, 2, 70, 136), bints(2, 136, 3, 64), None,
               "batched", True),
              ("xcf,xce->xef", bints(3, 341, 200), bints(3, 341, 256), torch.float32,
               "batched", True),
              ("bgrst,btgd->bsgrd", bints(1, 2, 6, 1, 1024), bints(1, 1024, 2, 128),
               torch.float32, "batched", True),
              # experts whose rows are 500 bytes apart: no tensor map; gathered
              ("xce,xef->xcf", bf(3, 341, 250), bf(3, 250, 200), None, "gathered", False),
              ("xce,xef->xcf", bints(3, 341, 250), bints(3, 250, 200), torch.float32,
               "gathered", True)]
    # gathered: four grid modes and an outer contracted mode (q beside k,
    # in the other order in B), past the three a tensor map holds; a start
    # 2 bytes off; a 2-mode product with rows 66 elements apart
    cases += [("abcdmqk,dcbakqn->abcdmn", bf(2, 2, 2, 2, 70, 3, 66), bf(2, 2, 2, 2, 66, 3, 150),
               None, "gathered", False),
              ("abcdmqk,dcbakqn->abcdmn", bints(2, 2, 2, 2, 70, 3, 66),
               bints(2, 2, 2, 2, 66, 3, 150), torch.float32, "gathered", True),
              ("mk,kn->mn", bf(200 * 64 + 1)[1:].view(200, 64), bf(64, 152), None, "gathered",
               False),
              ("mk,kn->mn", bints(200, 66), bints(66, 152), torch.float32, "gathered", True)]
    # fbatched with a bf16 operand, widened: mixed bf16 x f32 (either
    # operand bf16; 16-byte and element loads; a split, chunked walk), and
    # the degenerate bf16 products (an outer product, no own C mode)
    cases += [("mk,kn->mn", bf(200, 66), rn(66, 152), None, "fbatched", False),
              ("km,pkn->pnm", bints(321, 383), ints(47, 321, 257), None, "fbatched", True),
              ("km,pkn->pnm", ints(321, 383), bints(47, 321, 257), None, "fbatched", True),
              ("mk,kn->mn", bints(200, 64), ints(64, 152), None, "fbatched", True),
              ("mk,kn->mn", bf(300, 9000), rn(9000, 20), None, "fbatched", False),
              ("m,n->mn", bints(300), bints(200), torch.float32, "fbatched", True),
              ("bk,bk->b", bf(40, 300), bf(40, 300), torch.float32, "fbatched", False)]
    return cases


def check_native_routes(dev) -> None:
    """Each forced case launches its route (twice, bit-identical) and
    matches the plain version: exactly where the inputs are integers."""
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    worst = 0.0
    cases = native_route_cases(dev)
    for spec, A, B, out_dtype, route, exact in cases:
        a, b, c = modes_of(spec)
        kw = dict(a_modes=a, b_modes=b, c_modes=c, out_dtype=out_dtype)
        what = f"native_gemm {spec} A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)} -> {out_dtype}"
        check(native_route(A, B, a_modes=a, b_modes=b, c_modes=c) == route,
              f"{what}: native_route does not give {route}")
        before = dict(native_gemm.launches_by_route)
        got, again = native_gemm(A, B, **kw), native_gemm(A, B, **kw)
        torch.cuda.synchronize()
        ran = {r: n - before[r] for r, n in native_gemm.launches_by_route.items()}
        check(ran == {r: 2 * (r == route) for r in ran}, f"{what}: launched {ran}, not {route}")
        check(torch.equal(got, again), f"{what}: two launches differ")
        want = native_gemm_ref(A, B, **kw)
        check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
        if exact:
            check(torch.equal(got, want), f"{what}: integer-valued case not bit-identical")
        else:
            err = rel_err(got, want)
            check(err <= TOL[got.dtype], f"{what}: error {err}")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
    counts = {r: sum(1 for *_, rt, _ in cases if rt == r) for r in native_gemm.launches_by_route}
    log(f"native_gemm routes: {len(cases)} forced cases ({routes_text(counts)}; narrow widths "
        f"1/10/16, ragged rows and depths, bf16 weight streaming at 1-200 rows in every "
        f"operand layout, fused contracted modes, batched attention and expert products "
        f"with up to 3 grid modes, bf16 layouts no tensor map reads on gathered, float32 "
        f"Table II layouts, a split Gram and strided views, mixed bf16 x f32 and degenerate "
        f"bf16 products on fbatched, bf16 and f32 output, integer-valued bit-identical), each "
        f"launched twice on its route, bit-identical, matching the plain version "
        f"(max abs error {worst:.3g})")


GROUPED_T8 = {"u": 8, "v": 8, "k": 8}
#: the grouped shape lists of tests/test_runtime.py:27-32, (m, n, k) each
RUNTIME_SHAPE_LISTS = [
    [(5, 17, 9), (12, 3, 33), (1, 1, 1), (40, 20, 8)],
    [(8, 8, 8)],
    [(3, 3, 3), (3, 3, 3), (3, 3, 3)],
    [(33, 7, 65), (2, 31, 4)],
]


def fig14_shapes() -> list:
    """The ragged set of ``benchmarks/fig14_runtime.py:170-177`` (full run)."""
    rng = np.random.default_rng(14)
    shapes = [(int(m), 32, 64) for m in rng.integers(1, 33, size=8)]
    shapes[0] = (64, 32, 64)
    return shapes


def groups_of(shapes, dev, dtype, seed, ta=False, tb=False, integers=False):
    """Per-group operands from a numpy seed, stored transposed where
    flagged (``ta``/``tb`` scalar or per group)."""
    rng = np.random.default_rng(seed)
    ta = [ta] * len(shapes) if isinstance(ta, bool) else ta
    tb = [tb] * len(shapes) if isinstance(tb, bool) else tb

    def draw(shape):
        x = (rng.integers(-3, 4, shape) if integers else rng.standard_normal(shape))
        return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)

    As = [draw((k, m) if ta[g] else (m, k)) for g, (m, n, k) in enumerate(shapes)]
    Bs = [draw((n, k) if tb[g] else (k, n)) for g, (m, n, k) in enumerate(shapes)]
    return As, Bs


def check_grouped_case(As, Bs, tiles, ta=False, tb=False, exact=False, out_dtype=None,
                       route=None) -> float:
    """``grouped_gemm`` against its plain version on the same packed
    buffers, and ``grouped_matmul`` against the per-group product, in
    ``out_dtype`` (default: the operands' promoted type); both calls must
    launch ``route``.  Returns the largest absolute difference."""
    from repro_torch.kernels.grouped_gemm import (
        grouped_gemm, grouped_gemm_packed_ref, pack_groups, packed_geometry)
    from repro_torch.kernels.ops import grouped_matmul

    dt = out_dtype or torch.promote_types(As[0].dtype, Bs[0].dtype)
    A_flat, B_flat, descs, problems = pack_groups(As, Bs, tiles, trans_a=ta, trans_b=tb)
    _, out_rows, out_cols = packed_geometry(problems, tiles)
    kw = dict(out_cols=out_cols, out_rows=out_rows, out_dtype=dt)
    before = dict(grouped_gemm.launches_by_route)
    got = grouped_gemm(A_flat, B_flat, descs, **kw)
    outs = grouped_matmul(As, Bs, tiles=tiles, trans_a=ta, trans_b=tb, out_dtype=dt)
    torch.cuda.synchronize()
    ran = {r: n - before[r] for r, n in grouped_gemm.launches_by_route.items()}
    launched = 2 if any(m and n for m, n, *_ in descs.tolist()) else 0
    what = f"grouped {[tuple(a.shape) for a in As]} tiles {tiles} ta {ta} tb {tb} -> {dt}"
    check(ran == {r: launched * (r == route) for r in ran}, f"{what}: launched {ran}, "
                                                          f"not {route}")
    want = grouped_gemm_packed_ref(A_flat, B_flat, descs, **kw)
    flags = [(ta if isinstance(ta, bool) else ta[g], tb if isinstance(tb, bool) else tb[g])
             for g in range(len(As))]
    refs = [((A.T if fa else A).float() @ (B.T if fb else B).float()).to(dt)
            for A, B, (fa, fb) in zip(As, Bs, flags)]
    pairs = [(got[c:c + m, :n], want[c:c + m, :n])
             for m, n, _, _, _, c, _, _ in descs.tolist()]
    pairs += list(zip(outs, refs))
    worst = 0.0
    for g, w in pairs:
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: {g.shape} {g.dtype} "
                                                         f"vs {w.shape} {w.dtype}")
        if exact:
            check(torch.equal(g, w), f"{what}: integer-valued case not bit-identical")
        else:
            err = rel_err(g, w)
            check(err <= TOL[dt], f"{what}: error {err}")
        if g.numel():
            worst = max(worst, (g.float() - w.float()).abs().max().item())
    return worst


def native_kernel_info() -> None:
    """Registers, spills and shared memory of the built stream, splitk,
    wgmma and fbatched kernels of ``native_gemm`` (the first two with
    float32 output, the stream read kernels at the HOOI depth 512 and the
    read kinds at rank 10, padded to 12; the wgmma and batched routes'
    kernel with bf16 output at each tile height and operand layout, and
    its split reduction; the fbatched kernel with float32 output at each
    tile width and slab layout, and its split reduction, and with a bf16
    operand ("widening"); the gathered kernel with bf16 output at each
    tile height and stage layout).  The wgmma, fbatched and widening
    kernels must not spill: their 64 accumulators a thread stay in
    registers.  The 128-row gathered kernels, 384 threads at 168
    registers, may spill a few bytes; they are printed."""
    from repro_torch.kernels.sb_gemm import route_info

    for name, info in route_info(K=512, rp=12).items():
        log(f"sb_gemm.cu {name}: {info['registers']} registers/thread, {info['spill_bytes']} "
            f"bytes spilled (local)/thread, {info['smem_bytes']} bytes shared memory/block")
        check(not name.startswith(("wgmma", "fbatched", "widening")) or info["spill_bytes"] == 0,
              f"sb_gemm.cu {name} spills {info['spill_bytes']} bytes a thread")


def grouped_kernel_info() -> None:
    """Registers, spills and shared memory of the built grouped kernels:
    wgmma for each output type, fma for each (A, B, C) type triple; no fma
    kernel may spill, and each must have the shared memory its tiles
    plan."""
    from repro_torch.kernels.grouped_gemm import FMA_DEPTH, KERNEL_TILES, fma_info, wgmma_info

    tm, tn = KERNEL_TILES["wgmma"]
    for dtype, info in wgmma_info().items():
        log(f"grouped_gemm.cu wgmma {tm}x{tn} -> {str(dtype).removeprefix('torch.')}: "
            f"{info['registers']} registers/thread at launch (then setmaxnreg: producer 40, "
            f"consumers 232), {info['spill_bytes']} bytes spilled (local)/thread, "
            f"{info['smem_bytes']} bytes dynamic shared memory/block")
    tu, tv = KERNEL_TILES["fma"]
    plan = 2 * FMA_DEPTH * (tu + 4 + tv + 4) * 4
    for types, info in fma_info().items():
        name = " x ".join(str(t).removeprefix("torch.") for t in types[:2])
        what = f"grouped_gemm.cu fma {tu}x{tv} {name} -> {str(types[2]).removeprefix('torch.')}"
        log(f"{what}: {info['registers']} registers/thread, {info['spill_bytes']} bytes "
            f"spilled (local)/thread, {info['smem_bytes']} bytes static shared memory/block")
        check(info["spill_bytes"] == 0, f"{what}: spills")
        check(info["smem_bytes"] == plan, f"{what}: smem {info['smem_bytes']} != planned {plan}")


def check_grouped(dev) -> None:
    bf16, f32 = torch.bfloat16, torch.float32
    n = 0
    for i, shapes in enumerate(RUNTIME_SHAPE_LISTS):     # T8 leaves ragged depths: fma
        for dt in (f32, bf16):
            check_grouped_case(*groups_of(shapes, dev, dt, seed=i), GROUPED_T8, route="fma")
            n += 1
    for dt in (f32, bf16):     # default tiles (8, 128, 128)
        check_grouped_case(*groups_of([(5, 130, 9), (20, 4, 140)], dev, dt, seed=8), None,
                           route="wgmma" if dt == bf16 else "fma")
        n += 1
    # empty groups (tests/test_runtime.py:121-133): k=0 gives exact zeros
    rng = np.random.default_rng(3)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    As, Bs = [r(4, 0), r(0, 6), r(4, 6), r(4, 6)], [r(0, 5), r(6, 5), r(6, 0), r(6, 5)]
    check_grouped_case(As, Bs, GROUPED_T8, route="fma")
    from repro_torch.kernels.ops import grouped_matmul

    outs = grouped_matmul(As, Bs, tiles=GROUPED_T8)
    check([tuple(o.shape) for o in outs] == [(4, 5), (0, 5), (4, 0), (4, 5)],
          "grouped: empty-group shapes")
    check(bool((outs[0] == 0).all()), "grouped: k=0 group not exact zeros")
    # per-group layout flags (tests/test_runtime.py:148-154), integer-valued
    ta, tb = [False, True, True], [False, True, False]
    shapes = [(5, 9, 7), (6, 4, 7), (12, 130, 9)]
    check_grouped_case(*groups_of(shapes, dev, f32, seed=7, ta=ta, tb=tb, integers=True),
                       None, ta, tb, exact=True, route="fma")
    # several kernel tiles and K stages per group, every layout, ragged
    multi = [(130, 260, 70), (64, 128, 200), (1, 300, 33), (77, 5, 513)]
    ta, tb = [True, False, True, False], [False, True, True, False]
    for dt in (f32, bf16):
        check_grouped_case(*groups_of(multi, dev, dt, seed=9, ta=ta, tb=tb), GROUPED_T8,
                           ta, tb, route="fma")
    check_grouped_case(*groups_of(multi, dev, f32, seed=10, ta=ta, tb=tb, integers=True),
                       GROUPED_T8, ta, tb, exact=True, route="fma")
    # mixed operand types (bf16 A, f32 B; tests/test_torch_grouped_gemm.py),
    # f32 and bf16 output, every layout, ragged; integer-valued bit-identical
    for out in (f32, bf16):
        As, _ = groups_of(multi, dev, bf16, seed=11, ta=ta, tb=tb)
        _, Bs = groups_of(multi, dev, f32, seed=12, ta=ta, tb=tb)
        check_grouped_case(As, Bs, GROUPED_T8, ta, tb, out_dtype=out, route="fma")
        As, _ = groups_of(multi, dev, bf16, seed=13, ta=ta, tb=tb, integers=True)
        _, Bs = groups_of(multi, dev, f32, seed=14, ta=ta, tb=tb, integers=True)
        check_grouped_case(As, Bs, None, ta, tb, exact=True, out_dtype=out, route="fma")
    # the fig14 ragged set at its tiles (k = 64: bf16 takes wgmma)
    for dt in (f32, bf16):
        check_grouped_case(*groups_of(fig14_shapes(), dev, dt, seed=14),
                           {"u": 8, "v": 32, "k": 32}, route="wgmma" if dt == bf16 else "fma")
    log(f"grouped_gemm: {n} runtime-test cases (f32 and bf16), empty groups (k=0 exact "
        f"zeros), trans flags and multi-tile layouts (integer-valued bit-identical), mixed "
        f"bf16 x f32 operands with f32 and bf16 output, fig14 ragged set: all match the "
        f"plain version, each on its route")
    check_grouped_wgmma(dev)


def check_grouped_wgmma(dev) -> None:
    """Every ragged case again under the default tiles in bf16, where the
    wgmma route takes each of them, with bf16 and float32 output: ragged M
    and N edges, sub-tile groups, one group, empty and k=0 groups, and all
    four trans_a/trans_b combinations over several tiles and ring laps."""
    from repro_torch.kernels.ops import grouped_matmul

    bf16, f32 = torch.bfloat16, torch.float32
    n = 0
    multi = [(130, 260, 70), (64, 128, 200), (1, 300, 33), (77, 5, 513), (260, 130, 900)]
    ta, tb = [True, False, True, False, True], [False, True, True, False, False]
    cases = [(shapes, False, False) for shapes in RUNTIME_SHAPE_LISTS]
    cases += [([(3, 5, 2), (1, 1, 1)], False, False), ([(13, 29, 7)], False, False),
              (multi, ta, tb)]
    for out in (bf16, f32):
        for i, (shapes, fa, fb) in enumerate(cases):
            check_grouped_case(*groups_of(shapes, dev, bf16, seed=40 + i, ta=fa, tb=fb), None,
                               fa, fb, out_dtype=out, route="wgmma")
            n += 1
        # integer-valued: sums are exact in f32, so kernel and plain version
        # round the same value and must agree bit for bit
        check_grouped_case(*groups_of(multi, dev, bf16, seed=50, ta=ta, tb=tb, integers=True),
                           None, ta, tb, exact=True, out_dtype=out, route="wgmma")
        n += 1
        # empty groups and a k=0 group
        rng = np.random.default_rng(3)

        def r(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)

        As, Bs = [r(4, 0), r(0, 6), r(4, 6), r(4, 6)], [r(0, 5), r(6, 5), r(6, 0), r(6, 5)]
        check_grouped_case(As, Bs, None, out_dtype=out, route="wgmma")
        outs = grouped_matmul(As, Bs, out_dtype=out)
        check([tuple(o.shape) for o in outs] == [(4, 5), (0, 5), (4, 0), (4, 5)],
              "grouped wgmma: empty-group shapes")
        check(bool((outs[0] == 0).all()), "grouped wgmma: k=0 group not exact zeros")
        n += 1
    log(f"grouped_gemm wgmma: {n} default-tile bf16 cases (runtime-test shapes, sub-tile, "
        f"single group, empty and k=0 groups with exact zeros, all four trans combinations "
        f"over up to 16 K stages, integer-valued bit-identical), bf16 and f32 output: all "
        f"on the wgmma route and matching the plain version")


#: tests/test_flash_attn.py's SHAPES: (bh, s, t, block, d)
FLASH_SHAPES = [(2, 64, 64, 64, 16), (1, 96, 96, 32, 16), (3, 128, 256, 64, 32),
                (2, 200, 200, 48, 64)]


def qkv_of(rng, bh, s, t, d, dev, dtype):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((bh, s, d), (bh, t, d), (bh, t, d))]


def check_flash_case(q, k, v, causal, route) -> float:
    """One ``flash_attention`` call against its plain version; ``route`` is
    the route it must launch."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    what = f"flash {tuple(q.shape)}{q.stride()} {tuple(k.shape)}{k.stride()} causal={causal} {q.dtype}"
    ran = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()}
    check(ran == {r: int(r == route) for r in ran}, f"{what}: launched {ran}, not {route}")
    check(got.shape == want.shape and got.dtype == q.dtype, "flash: shape or dtype")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = row_rel_err(got, want)
    check(err <= TOL[q.dtype], f"{what}: error {err}")
    return (got.float() - want.float()).abs().max().item()


def flash_kernel_info() -> None:
    """Registers, spills and shared memory of the built wgmma and fma
    kernels; the shared memory must be what ``wgmma_tiles`` and
    ``fma_tiles`` plan, and no fma kernel may spill."""
    from repro_torch.kernels.flash_attn import fma_info, fma_tiles, wgmma_info, wgmma_tiles

    for D in (64, 128, 256):
        info, plan = wgmma_info(D), wgmma_tiles(D)
        check(info["smem_bytes"] == plan["smem_bytes"],
              f"flash wgmma DP={plan['dp']}: kernel smem {info['smem_bytes']} != planned "
              f"{plan['smem_bytes']}")
        log(f"flash_attn.cu wgmma DP={plan['dp']} BK={plan['bk']} stages={plan['stages']}: "
            f"{info['registers']} registers/thread at launch (then setmaxnreg: producer 40, "
            f"consumers 232), {info['spill_bytes']} bytes spilled (local)/thread, "
            f"{info['smem_bytes']} bytes dynamic shared memory/block")
    for D in (64, 128, 256):
        plan = fma_tiles(D)
        for dt in (torch.float32, torch.bfloat16):
            info = fma_info(D, dt)
            what = (f"flash_attn.cu fma DP={plan['dp']} BQ={plan['bq']} BK={plan['bk']} "
                    f"{str(dt).removeprefix('torch.')}")
            log(f"{what}: {info['registers']} registers/thread ({plan['rows']} rows x 4 keys "
                f"of S, {plan['rows']} x {plan['cols']} of O), {info['spill_bytes']} bytes "
                f"spilled (local)/thread, {info['smem_bytes']} bytes dynamic shared memory/block")
            check(info["spill_bytes"] == 0, f"{what}: spills")
            check(info["smem_bytes"] == plan["smem_bytes"],
                  f"{what}: kernel smem {info['smem_bytes']} != planned {plan['smem_bytes']}")


def check_flash(dev) -> None:
    rng = np.random.default_rng(11)
    bf16, f32 = torch.bfloat16, torch.float32
    route = {f32: "fma", bf16: "wgmma"}
    n = 0
    for bh, s, t, _, d in FLASH_SHAPES:
        for causal in (True, False):
            for dt in (f32, bf16):
                check_flash_case(*qkv_of(rng, bh, s, t, d, dev, dt), causal, route[dt])
                n += 1
    # GQA fold (tests/test_flash_attn.py:61-76): each q head gets its kv head
    B, G, R, S, D = 2, 2, 3, 64, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev)
               for sh in ((B, G, R, S, D), (B, G, S, D), (B, G, S, D)))
    fold = lambda x: x[:, :, None].expand(B, G, R, S, D).reshape(B * G * R, S, D)
    for dt in (f32, bf16):
        check_flash_case(q.reshape(B * G * R, S, D).to(dt), fold(k).to(dt), fold(v).to(dt),
                         True, route[dt])
    # causal cross attention, top-left aligned, ragged; every head-dim path
    # (160: a padded head dim whose last 64-column box lies past D)
    for bh, s, t, d in ((2, 100, 300, 128), (2, 300, 100, 128), (1, 70, 70, 256),
                        (2, 33, 65, 48), (1, 130, 200, 160)):
        for dt in (f32, bf16):
            check_flash_case(*qkv_of(rng, bh, s, t, d, dev, dt), True, route[dt])
    # scores over a wide range (q scaled by 8) across 6 (wgmma) or 11 (fma)
    # key tiles: the running max moves and the accumulator is rescaled from
    # tile to tile
    q, k, v = qkv_of(rng, 2, 300, 700, 128, dev, f32)
    for dt in (f32, bf16):
        for causal in (True, False):
            check_flash_case((q * 8).to(dt), k.to(dt), v.to(dt), causal, route[dt])
    # strided operands: q read from an (S, BH, D) layout, one K/V for all heads
    q = torch.from_numpy(rng.standard_normal((90, 4, 64)).astype(np.float32)).to(dev)
    k1, v1 = (torch.from_numpy(rng.standard_normal((1, 120, 64)).astype(np.float32))
              .to(dev) for _ in range(2))
    for dt in (f32, bf16):
        for causal in (True, False):
            check_flash_case(q.to(dt).transpose(0, 1),
                             k1.to(dt).expand(4, 120, 64), v1.to(dt).expand(4, 120, 64),
                             causal, route[dt])
    # one query row, then one key, each with a row stride TMA could not
    # step: a dimension of extent 1 is never stepped, so both take wgmma
    q, k, v = qkv_of(rng, 2, 40, 40, 64, dev, bf16)
    check_flash_case(q.as_strided((2, 1, 64), (64 * 40, 3, 1)), k, v, True, "wgmma")
    check_flash_case(q, *(x.as_strided((2, 1, 64), (64 * 40, 5, 1)) for x in (k, v)), False,
                     "wgmma")
    # bf16 layouts TMA cannot describe take the fma route: D = 4 (8-byte
    # rows) and rows 44 elements apart
    check_flash_case(*qkv_of(rng, 2, 50, 70, 4, dev, bf16), True, "fma")
    q, k, v = (x[..., :40] for x in qkv_of(rng, 2, 80, 96, 44, dev, bf16))
    check_flash_case(q, k, v, False, "fma")
    # float32 with S off the fma route's query tile (128 rows, 64 at D > 128)
    # and ragged T, each head-dim tile
    for bh, s, t, d in ((3, 333, 260, 128), (2, 100, 150, 256), (2, 130, 70, 64)):
        for causal in (True, False):
            check_flash_case(*qkv_of(rng, bh, s, t, d, dev, f32), causal, "fma")
    log(f"flash_attention: {n} cases of the SHAPES x causal/full x f32/bf16 grid, GQA fold, "
        f"causal T>S and T<S, D in 48/128/160/256, scores x8 over 6-11 key tiles (f32 and "
        f"bf16), strided and broadcast operands, S = 1 and T = 1, two bf16 layouts TMA "
        f"cannot read, f32 at S off the query tile: all match the plain version, every bf16 "
        f"case TMA can read on the wgmma route, every other case on fma")


# ------------------------------------------------------------------- phase 4
def check_copy_freedom(dev, working_set) -> None:
    from repro_torch.core.contract import (
        contract, conventional_transpose_count, count_copy_ops)

    gen = torch.Generator(device=dev).manual_seed(2)
    for spec, dims in working_set:
        a, b, _ = modes_of(spec)
        A = torch.randn([dims[m] for m in a], device=dev, generator=gen)
        B = torch.randn([dims[m] for m in b], device=dev, generator=gen)
        for strategy in ("auto", "native"):
            n = sum(count_copy_ops(
                lambda: contract(spec, A, B, strategy=strategy, backend="kernel")).values())
            check(n == 0, f"copy-freedom {spec} {strategy}/kernel: {n} copies")
        conv = sum(count_copy_ops(
            lambda: contract(spec, A, B, strategy="conventional")).values())
        want = conventional_transpose_count(spec)
        check(conv >= want, f"conventional {spec}: {conv} copies < {want} transposes")
        log(f"copies {spec} {dims}: kernel 0, conventional {conv} "
            f"(>= {want} counted transposes)")
        del A, B


# ------------------------------------------------------------------- phase 5
def low_rank_plus_noise(size: int, ranks, seed: int, noise_rel: float = 0.1,
                        device="cuda"):
    """``G ×1 A ×2 B ×3 C + noise`` made from a numpy seed, with the noise's
    norm ``noise_rel`` times the low-rank part's.  Returns (T, noise share
    of ||T||)."""
    rng = np.random.default_rng(seed)
    G = torch.from_numpy(rng.standard_normal(ranks).astype(np.float32)).to(device)
    A, B, C = (torch.from_numpy(np.linalg.qr(rng.standard_normal((size, r)))[0]
                                .astype(np.float32)).to(device) for r in ranks)
    T = torch.einsum("ijk,mi,nj,pk->mnp", G, A, B, C).contiguous()
    N = torch.from_numpy(rng.standard_normal((size,) * 3, dtype=np.float32)).to(device)
    N *= noise_rel * torch.linalg.norm(T) / torch.linalg.norm(N)
    T += N
    return T, (torch.linalg.norm(N) / torch.linalg.norm(T)).item()


VARIANTS = {"kernel": dict(strategy="auto", backend="kernel"),
            "torch": dict(strategy="auto", backend="torch"),
            "conventional": dict(strategy="conventional", backend="torch")}
#: every HOOI run: the three variants and phase 10's tuned run, in which
#: each step runs the tuner's winner (``backend`` unused)
RUNS = {**VARIANTS, "tuned": dict(strategy="tuned")}


def check_small_hooi(dev) -> None:
    """The kernel-backed HOOI on the card agrees with the port on the CPU."""
    from repro_torch.core.tucker import hooi

    T, _ = low_rank_plus_noise(24, (4, 3, 5), seed=3, noise_rel=0.05, device="cpu")
    want = hooi(T, (4, 3, 5), n_iter=5)
    with native_routes_held() as tally:
        got = hooi(T.to(dev), (4, 3, 5), n_iter=5, **VARIANTS["kernel"])
    d = abs(got.rel_error.item() - want.rel_error.item())
    check(d <= 1e-5, f"small HOOI: rel_error {got.rel_error.item()} vs CPU "
                     f"{want.rel_error.item()}")
    for f, w in zip(got.factors, want.factors):
        err = (f @ f.T).cpu().sub(w @ w.T).abs().max().item()
        check(err <= 1e-4, f"small HOOI: factor projector differs by {err}")
    log(f"small HOOI 24^3: card (kernel) rel_error {got.rel_error.item():.7f} = "
        f"CPU {want.rel_error.item():.7f}; native_gemm routes: {routes_text(tally)}")


@contextlib.contextmanager
def recording_launches():
    """Within the block, every ``native_gemm`` launch through
    ``kernels.ops`` is counted by its shape, strides and options; yields
    ``{key: (launches, (A, B, kwargs))}`` with one launch's operands per
    key, for :func:`time_shapes`."""
    from repro_torch.kernels import ops

    launches: dict = {}
    real = ops.native_gemm

    def recording(A, B, **kw):
        key = (kw["a_modes"], kw["b_modes"], kw["c_modes"], tuple(A.shape), A.stride(),
               tuple(B.shape), B.stride())
        n, _ = launches.get(key, (0, None))
        launches[key] = (n + 1, (A, B, kw))
        return real(A, B, **kw)

    ops.native_gemm = recording
    try:
        yield launches
    finally:
        ops.native_gemm = real


def run_timed(decompose, T, rank, n_iter: int, variant: str):
    """``decompose(T, rank)`` (HOOI or CP-ALS) on the card as ``variant``,
    and its ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = decompose(T, rank, n_iter=n_iter, **RUNS[variant])
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


class Decomposition(NamedTuple):
    """A decomposition that phases 5, 10 and 29 drive on ``device``:
    ``run(n_iter, variant)`` runs it as ``variant`` (a key of
    :data:`RUNS`) and returns (result, ms); ``parts(result)`` gives the
    result's tensors, each of which must be finite and of the shape at its
    place in ``shapes``."""

    label: str
    device: torch.device
    run: Callable
    parts: Callable
    shapes: tuple

    def whole(self, res) -> bool:
        parts = self.parts(res)
        return len(parts) == len(self.shapes) and all(
            tuple(x.shape) == tuple(s) and torch.isfinite(x).all().item()
            for x, s in zip(parts, self.shapes))


def hooi_run(T) -> Decomposition:
    from repro_torch.core.tucker import hooi

    return Decomposition(f"hooi {T.shape[0]}^3 ranks {RANKS}", T.device,
                         functools.partial(run_timed, hooi, T, RANKS),
                         lambda r: (r.core, *r.factors), (RANKS, *zip(T.shape, RANKS)))


def counted_turns(dec: Decomposition, n_iter: int, counters) -> tuple:
    """The turns of phases 5 and 29: a warm-up of each variant (the
    kernel's records what it launches), the kernel's counted run (every
    count set to 0 just before and read just after, ``native_gemm``'s
    launches by route what ``native_route`` gives each recorded launch
    shape, the peak memory read after it), then torch, conventional,
    conventional, torch, kernel in turns, in which only the kernel
    launches the kernel.  Returns the counts, the launches by route, the
    recorded launches, each variant's last result, its ms per run and the
    counted run's peak bytes."""
    from repro_torch.kernels.sb_gemm import native_gemm, native_route

    # warm-up of each variant; the kernel's one records what it launches
    with recording_launches() as launches:
        dec.run(n_iter, "kernel")
    for v in ("torch", "conventional"):
        dec.run(n_iter, v)

    # the main path: counts to 0 just before, read just after
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    torch.cuda.reset_peak_memory_stats()
    res_k, ms_k = dec.run(n_iter, "kernel")
    peak = torch.cuda.max_memory_allocated()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    check(counted["native_gemm"] > 0, f"{dec.label}: main path launched native_gemm no time")
    check(counted["native_gemm"] == sum(n for n, _ in launches.values()),
          f"{dec.label}: launch count {counted} differs from the recorded run's")
    want_routes = dict.fromkeys(routes, 0)
    for (a, b, c, *_), (n, (A, B, _)) in launches.items():
        want_routes[native_route(A, B, a_modes=a, b_modes=b, c_modes=c)] += n
    check(routes == want_routes,
          f"{dec.label}: routes {routes}, native_route gives {want_routes}")
    native_gemm.launches = 0
    results, times = {"kernel": res_k}, {"kernel": [ms_k]}
    for v in ("torch", "conventional", "conventional", "torch", "kernel"):
        res, ms = dec.run(n_iter, v)
        results[v] = res
        times.setdefault(v, []).append(ms)
    check(native_gemm.launches == sum(n for n, _ in launches.values()),
          f"{dec.label}: a baseline variant launched the kernel")
    return counted, routes, launches, results, times, peak


def main_path(dec: Decomposition, noise_share, n_iter, counters):
    """HOOI three ways.  Returns the kernel launches of the counted run,
    ``native_gemm``'s launches in it by route, and the kernel run's
    per-shape launches."""
    counted, routes, launches, results, times, _ = counted_turns(dec, n_iter, counters)
    rel = {v: r.rel_error.item() for v, r in results.items()}
    check(abs(rel["kernel"] - rel["torch"]) <= 1e-5,
          f"kernel rel_error {rel['kernel']} vs torch {rel['torch']}")
    for v, r in results.items():
        check(dec.whole(r), f"{v}: non-finite or misshapen")
        check(rel[v] <= noise_share * 1.001, f"{v}: rel_error {rel[v]} above the noise "
                                             f"share {noise_share}")
    A = results["kernel"].factors[0]
    check((A.T @ A - torch.eye(RANKS[0], device=A.device)).abs().max().item() < 1e-4,
          "kernel factors not orthonormal")
    med = {v: sorted(t)[len(t) // 2] for v, t in times.items()}
    for v in VARIANTS:
        log(f"{dec.label} x{n_iter} [{v}]: {med[v]:.3f} ms per HOOI "
            f"(runs {', '.join(f'{t:.3f}' for t in times[v])}), rel_error {rel[v]:.7f}, "
            f"speedup over conventional {med['conventional'] / med[v]:.3f}x")
    log(f"hooi: noise share of ||T|| {noise_share:.7f}; kernel launches per HOOI "
        f"{counted['native_gemm']}, by route {routes}")
    return counted, routes, launches, {"ms": med, "rel": rel}


# ------------------------------------------------------------------ phase 10
#: the tuned run's tolerance against the ``auto``+kernel variant's rel_error
TUNED_REL_TOL = 1e-5
#: a span's roofline fraction above this means its count or its clock is wrong
MAX_FRACTION = 1.05


def tuned_path(dec: Decomposition, working_set, noise_share, n_iter, counters,
               variants) -> dict:
    """``dec`` (HOOI in phase 10, CP-ALS in 29) under ``strategy="tuned"``.
    A ``"measure"`` dispatcher with a fresh cache in a temporary directory
    pretunes the recorded working set on the card (every candidate of
    every shape measured); the tuned run then goes under ``"cached"``:
    every lookup a hit, no measurement, ``native_gemm``'s launches by
    route what the winners imply, and ``rel_error`` within
    :data:`TUNED_REL_TOL` of the ``auto``+kernel variant's (``variants``
    holds each variant's ``"ms"`` and ``"rel"``).  Then the cost model
    fitted on that cache predicts each shape, and one traced tuned
    iteration must give every ``contract`` span a roofline fraction in
    (0, :data:`MAX_FRACTION`], exported to a Chrome trace that parses.
    Returns the tuned run's record."""
    import tempfile
    from collections import Counter

    from repro_torch.core.notation import parse_spec
    from repro_torch.obs import export, trace
    from repro_torch.tuning import Candidate, Dispatcher, canonical_key, set_dispatcher
    from repro_torch.tuning.cache import platform_of
    from repro_torch.tuning.candidates import enumerate_candidates
    from repro_torch.tuning.model import kernel_route
    from repro_torch.kernels.sb_gemm import native_gemm

    dev, both = dec.device, ("torch", "kernel")
    platform = platform_of(dev)
    shapes = {}
    for spec, dims, dt in working_set:
        shapes.setdefault(canonical_key(spec, dims, dt, platform), (spec, dims, dt))
    with tempfile.TemporaryDirectory() as tmp:
        disp = Dispatcher(Path(tmp) / "tuning.json", policy="measure", backends=both)
        set_dispatcher(disp)
        try:
            t0 = time.perf_counter()
            stats = disp.pretune(working_set, device=dev)
            pretune_s = time.perf_counter() - t0
            check(stats["tuned"] == stats["unique"] == len(shapes),
                  f"pretune on a fresh cache: {stats}")
            n_cands = 0
            winner_route = {}
            for key, (spec, dims, dt) in shapes.items():
                cs = parse_spec(spec)
                entry = disp.cache.get(key)
                want = {c.key() for c in enumerate_candidates(cs, dims, backends=both)}
                check(set(entry["results"]) == want,
                      f"{key}: measured {sorted(entry['results'])}, candidates {sorted(want)}")
                n_cands += len(want)
                best = Candidate.from_key(entry["best"])
                winner_route[key] = (kernel_route(cs, dims, dt, best)[0]
                                     if best.backend == "kernel" else None)
                us = ", ".join(f"{k} {v:.2f}" for k, v in sorted(entry["results"].items(),
                                                                   key=lambda kv: kv[1]))
                log(f"tuned {spec} {dims}: winner {entry['best']}"
                    f"{' [' + winner_route[key] + ']' if winner_route[key] else ''}; "
                    f"µs {us}")
            check(disp.measurements == n_cands, f"{disp.measurements} measurements, "
                                                f"{n_cands} candidates")
            log(f"pretune: {stats['unique']} shapes, {n_cands} candidates measured on the card "
                f"in {pretune_s:.1f} s ({platform})")

            disp.policy = "cached"
            with native_routes_held() as warm:       # warm-up; launches held to native_route
                dec.run(n_iter, "tuned")
            looked = Counter()
            real_lookup = disp.lookup

            def tally(spec, dims, dtype, plat=None):
                looked[canonical_key(spec, dims, dtype, plat)] += 1
                return real_lookup(spec, dims, dtype, plat)

            disp.lookup = tally
            disp.reset_counters()
            for c in counters:
                c.launches = 0
            native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
            res, ms = dec.run(n_iter, "tuned")
            counted = {c.__name__: c.launches for c in counters}
            routes = dict(native_gemm.launches_by_route)
            disp.lookup = real_lookup
            implied = dict.fromkeys(routes, 0)
            for key, n in looked.items():
                if winner_route.get(key):
                    implied[winner_route[key]] += n
            log(f"tuned {dec.label}: {disp.stats['hits']} lookups, all hits, "
                f"{disp.stats['measurements']} measurements; native_gemm launches by route "
                f"{routes}, implied by the winners {implied}, held in the warm-up run "
                f"{warm}")
            check(disp.misses == 0 and disp.measurements == 0 and disp.hits > 0
                  and disp.hits == sum(looked.values()),
                  f"tuned {dec.label} under 'cached': {disp.stats}")
            check(set(looked) <= set(shapes), "a tuned lookup outside the pretuned working set")
            check(routes == implied == warm, f"native_gemm routes {routes}, implied {implied}, "
                                             f"warm-up {warm}")
            check(counted["native_gemm"] == sum(routes.values())
                  and counted["grouped_gemm"] == counted["flash_attention"] == 0,
                  f"tuned {dec.label} launches {counted}")
            times = [ms, dec.run(n_iter, "tuned")[1]]

            rel = res.rel_error.item()
            check(dec.whole(res), f"tuned {dec.label}: non-finite or misshapen")
            check(abs(rel - variants["rel"]["kernel"]) <= TUNED_REL_TOL,
                  f"tuned rel_error {rel} vs auto+kernel {variants['rel']['kernel']}")
            check(rel <= noise_share * 1.001, f"tuned rel_error {rel} above the noise share")
            med = sorted(times)[len(times) // 2]
            log(f"{dec.label} x{n_iter} [tuned]: {med:.3f} ms a run "
                f"(runs {', '.join(f'{t:.3f}' for t in times)}), rel_error {rel:.7f} "
                f"(auto+kernel {variants['rel']['kernel']:.7f}); beside "
                + ", ".join(f"{v} {t:.3f} ms" for v, t in variants["ms"].items()))

            pred = Dispatcher(disp.cache, policy="predict", backends=both)
            model = pred.model()
            log(f"cost model: families {sorted(model.families)}, {model.n_rows} rows")
            for key, (spec, dims, dt) in shapes.items():
                p = pred.predict(spec, dims, dt)
                entry = disp.cache.get(key)
                measured = entry["results"][entry["best"]]
                log(f"predict {spec} {dims}: "
                    + (f"{p.candidate.key()} {p.us:.2f} µs (confidence {p.confidence:.3f})"
                       if p else "no prediction")
                    + f"; measured {entry['best']} {measured:.2f} µs")

            tracer = trace.enable_tracing(trace.Tracer())
            try:
                traced = dec.run(1, "tuned")[0]
            finally:
                trace.disable_tracing()
            check(torch.isfinite(traced.rel_error).item(), f"traced {dec.label}: non-finite")
            spans = [e for e in tracer.events() if e["name"] == "contract"]
            fracs = [e["args"].get("roofline_fraction") for e in spans]
            check(spans and all(e["args"].get("roofline_bound_us", 0) > 0 for e in spans),
                  "a contract span on the card carries no roofline bound")
            bad = [(e["args"]["spec"], f) for e, f in zip(spans, fracs)
                   if f is None or not 0 < f <= MAX_FRACTION]
            by_spec = {}
            for e, f in zip(spans, fracs):
                by_spec.setdefault((e["args"]["spec"], e["args"]["strategy"]), []).append(f)
            for (spec, strategy), fs in sorted(by_spec.items()):
                log(f"trace contract {spec} [{strategy}] x{len(fs)}: roofline_fraction "
                    f"{min(fs):.4f}-{max(fs):.4f} of device time")
            check(not bad, f"roofline fractions outside (0, {MAX_FRACTION}]: {bad[:5]}")
            path = Path(tmp) / "tuned_trace.json"
            n_ev = export.write_chrome_trace(str(path), tracer)
            summary = export.validate_chrome_trace(str(path))
            check("contract" in summary["names"], "exported trace has no contract span")
            log(f"trace: {len(spans)} contract spans, fractions {min(fracs):.4f}-"
                f"{max(fracs):.4f}; {n_ev} Chrome-trace events exported, parsed and valid")
        finally:
            set_dispatcher(None)
    return {"launches": counted["native_gemm"], "launches_by_route": routes,
            "ms": med, "rel_error": rel}


# ------------------------------------------------------------------- phase 6
def launch_cost(A, B, kw) -> tuple[int, int]:
    """Bytes and flops of one ``native_gemm`` launch: each operand read
    once, the output written once; two flops per multiply-add."""
    a, b, c = kw["a_modes"], kw["b_modes"], kw["c_modes"]
    out_dtype = kw.get("out_dtype") or torch.promote_types(A.dtype, B.dtype)
    dims = dict(zip(a, A.shape)) | dict(zip(b, B.shape))
    flops = 2 * int(np.prod([dims[m] for m in set(a + b + c)], dtype=np.int64))
    nbytes = (A.numel() * A.element_size() + B.numel() * B.element_size()
              + int(np.prod([dims[m] for m in c])) * out_dtype.itemsize)
    return nbytes, flops


def time_shapes(launches, reps: int = 20, per: str = "HOOI", top: int | None = None,
                summary: bool = True) -> dict:
    """Kernel, plain-version and library time at each launch shape of the
    main path, its route and the bound at its type's peak; two launches at
    each shape must be bit-identical, and the kernel's error against the
    plain version within ``TOL`` (both are also printed against a float64
    einsum, to show which of the two sums rounds more).  The kernel and ``torch.einsum`` are
    timed both with their calls queued (device time, ``queued_ms``) and
    back to back (the call with its host time, ``cuda_ms``).  Per-``per``
    sums weight each shape by its launches; ``top`` keeps only the shapes
    with the largest launches x bound; ``rows`` holds each shape's numbers
    for one launch, and ``summary`` prints the sums."""
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    keys = ("ms", "call_ms", "plain_ms", "library_ms", "library_call_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0) | dict(bytes=0, flops=0, rows=[])
    worst = 0.0
    items = sorted(launches.items(), key=lambda x: x[0][:3])
    if top is not None:
        def weight(item):
            n, (A, B, kw) = item[1]
            nb, fl = launch_cost(A, B, kw)
            return n * bound(nb, fl, torch.promote_types(A.dtype, B.dtype))[0]
        items = sorted(sorted(items, key=weight, reverse=True)[:top], key=lambda x: x[0][:3])
    for (a, b, c, *_), (n, (A, B, kw)) in items:
        out_dtype = kw.get("out_dtype") or torch.promote_types(A.dtype, B.dtype)
        dtype = torch.promote_types(A.dtype, B.dtype)
        nbytes, flops = launch_cost(A, B, kw)
        b_ms, by = bound(nbytes, flops, dtype)
        spec = f"{a},{b}->{c}"
        route = native_route(A, B, a_modes=a, b_modes=b, c_modes=c)
        saved = native_gemm.launches, dict(native_gemm.launches_by_route)
        got, again = native_gemm(A, B, **kw), native_gemm(A, B, **kw)
        want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c, out_dtype=out_dtype)
        check(torch.equal(got, again), f"{spec} at {tuple(A.shape)}: two launches differ")
        err = rel_err(got, want)
        exact = torch.einsum(spec, A.double(), B.double())
        errs = (f"error {err:.2e} against the plain version; against a float64 einsum "
                f"kernel {rel_err(got, exact):.2e}, plain {rel_err(want, exact):.2e}")
        del exact
        check(err <= TOL[out_dtype], f"{spec} at {tuple(A.shape)}: {errs}")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        ms = queued_ms(lambda: native_gemm(A, B, **kw), reps)
        call_ms = cuda_ms(lambda: native_gemm(A, B, **kw), reps)
        # comparison launches do not count
        native_gemm.launches, native_gemm.launches_by_route = saved
        plain = cuda_ms(lambda: native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c,
                                                out_dtype=out_dtype), reps)
        lib = queued_ms(lambda: torch.einsum(spec, A, B), reps)
        lib_call = cuda_ms(lambda: torch.einsum(spec, A, B), reps)
        log(f"shape {spec} A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)}{B.stride()} "
            f"x{n}/{per} [{route}] {dtype_label(dtype)}: kernel {ms:.4f} ms queued "
            f"({call_ms:.4f} ms by events), "
            f"bound {b_ms:.4f} ms ({by}), {100 * b_ms / ms:.1f}% of bound; plain "
            f"{plain:.4f} ms; einsum {lib:.4f} ms queued ({lib_call:.4f} ms by events); "
            f"two launches bit-identical; {errs}")
        for k, v in zip(keys, (ms, call_ms, plain, lib, lib_call, b_ms)):
            tot[k] += n * v
        tot["bytes"] += n * nbytes
        tot["flops"] += n * flops
        tot["rows"].append(dict(zip(keys, (ms, call_ms, plain, lib, lib_call, b_ms)),
                                spec=spec, route=route, bound_by=by, bytes=nbytes, flops=flops,
                                max_abs_err=(got.float() - want.float()).abs().max().item()))
    tot["max_abs_err"] = worst
    tot["bound_by"] = bound(tot["bytes"], tot["flops"], dtype)[1]
    if summary:
        log(f"native_gemm per {per}{'' if top is None else f' (top {len(items)} shapes)'}: "
            f"kernel {tot['ms']:.4f} ms queued ({tot['call_ms']:.4f} ms by "
            f"events), bound {tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, einsum "
            f"{tot['library_ms']:.4f} ms queued ({tot['library_call_ms']:.4f} ms by events)")
    return tot


# ------------------------------------------------------------------- phase 7
def profile_hooi(T, n_iter: int, variant: str, top: int = 10) -> None:
    """Where one HOOI of ``variant`` spends device time (see
    :func:`profile_device`)."""
    from repro_torch.core.tucker import hooi

    profile_device(f"one HOOI [{variant}]",
                   lambda: hooi(T, RANKS, n_iter=n_iter, **VARIANTS[variant]), top)


def device_spans(fn) -> tuple[list, float]:
    """The device activities of one call of ``fn`` under ``torch.profiler``,
    as sorted ``(start_us, end_us, name)``, and the host wall time in µs.
    Only device activity is recorded: host ops are not read here, and
    recording them too made a mamba2-1.3b train step's 30k device
    activities take ~20 s to list instead of ~7 (H100 80GB HBM3, torch
    2.11)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA), wall_us


def profile_device(label: str, fn, top: int = 10, kinds: dict | None = None) -> dict | None:
    """Where one call of ``fn`` spends device time, by kernel name, and the
    device's idle share: of the host wall time under the profiler, and of
    the span from the first device activity to the last.  ``kinds`` maps a
    label to a test of a kernel's name: the device time of the kernels it
    accepts is summed under it (a kernel counts under its first label).
    Returns the busy and wall ms, the idle share
    of the wall and the kinds' ``[ms, launches]``, or ``None`` when the
    profiler recorded no device activity."""
    spans, wall_us = device_spans(fn)
    if not spans:
        log(f"profile of {label}: the profiler recorded no device activity (not measured)")
        return None
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:      # union of intervals: overlaps count once
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + stop - start, n + 1)
    span_us = end - spans[0][0]
    log(f"profile of {label}: device busy {busy / 1e3:.3f} ms; idle share "
        f"{1 - busy / wall_us:.3f} of the host wall {wall_us / 1e3:.3f} ms under the "
        f"profiler, {1 - busy / span_us:.3f} of the device span {span_us / 1e3:.3f} ms; "
        f"{len(spans)} device activities")
    for name, (us, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:top]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<5d} {name[:80]}")
    by_kind = {k: [0.0, 0] for k in kinds or ()}
    for name, (us, n) in by_name.items():
        kind = next((k for k, accepts in (kinds or {}).items() if accepts(name)), None)
        if kind is not None:
            by_kind[kind][0] += us / 1e3
            by_kind[kind][1] += n
    if kinds:
        log(f"profile of {label} by kind: " + "; ".join(
            f"{k} {ms:.3f} ms x{n} ({100 * ms * 1e3 / busy:.1f}%)"
            for k, (ms, n) in by_kind.items()))
    return dict(busy_ms=busy / 1e3, wall_ms=wall_us / 1e3, idle_share=1 - busy / wall_us,
                by_kind=by_kind)


# ------------------------------------------------------------------ phase 29
#: phase 29's CP-ALS cases, ``((m, n, p), rank)``, all float32: at 512³ each
#: MTTKRP forms the Khatri-Rao factor first, its product against T on
#: ``splitk`` (modes 1 and 3) and ``fbatched`` (mode 2) at rank 10, all on
#: ``fbatched`` at 64; at 1024×512×256 modes 2 and 3 take
#: tensor-times-matrix first, then the exceptional batched GEMV
CP_CASES = (((512, 512, 512), 10), ((512, 512, 512), 64), ((1024, 512, 256), 16))
CP_ITER = 25
#: two ``native_gemm`` launches an MTTKRP, three MTTKRPs an iteration
CP_LAUNCHES_PER_ITER = 6
#: check (a) against the torch backend: rel_error (absolute, the
#: conventional variant's too), λ (relative), each factor column with its
#: sign aligned (absolute)
CP_REL_TOL, CP_LAMBDA_RTOL, CP_FACTOR_TOL = 1e-5, 1e-4, 1e-3
#: the device kernels of one CP-ALS, by kind: ``eigh`` (cuSOLVER's
#: Jacobi sweeps and rotations, ``syevbj_batch`` and ``*_rotate_batch``,
#: its tridiagonal reduction and LAPACK-named stages) and the solves (LU
#: and triangular solves)
EIGH_NAMES = ("syev", "sytrd", "sytd2", "syr2k", "rotate_batch", "ormtr", "orgtr", "stedc",
              "steqr", "sterf", "laed", "lasr", "latrd", "larf", "heevd", "hetrd")
SOLVE_NAMES = ("getrf", "getrs", "getf2", "trsm", "laswp", "trsv")
CP_KINDS = {"native_gemm": lambda name: name.removeprefix("void ").startswith(NATIVE_KERNELS),
            "eigh": lambda name: any(s in name.lower() for s in EIGH_NAMES),
            "solves": lambda name: any(s in name.lower() for s in SOLVE_NAMES)}


def recoverable_cp(shape, rank: int, seed: int, noise_rel: float = 0.1, device="cuda"):
    """``Σ_r λ_r a_r ∘ b_r ∘ c_r + noise`` made from a numpy seed: each
    factor's ``rank`` columns orthonormal (QR of a Gaussian), ``λ =
    geomspace(1, 0.2, rank)``, the noise Gaussian with its norm
    ``noise_rel`` times the low-rank part's.  ALS from the HOSVD init
    reaches the noise floor on it in both packages; on Gaussian factors it
    can stop far above it, where the packages part
    (``tests/test_torch_cp.py``).  Returns (T, noise share of ||T||)."""
    rng = np.random.default_rng(seed)
    lam = torch.from_numpy(np.geomspace(1.0, 0.2, rank).astype(np.float32)).to(device)
    A, B, C = (torch.from_numpy(np.linalg.qr(rng.standard_normal((d, rank)))[0]
                                .astype(np.float32)).to(device) for d in shape)
    T = torch.einsum("r,mr,nr,pr->mnp", lam, A, B, C).contiguous()
    N = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
    N *= noise_rel * torch.linalg.norm(T) / torch.linalg.norm(N)
    T += N
    return T, (torch.linalg.norm(N) / torch.linalg.norm(T)).item()


def cp_run(T, rank: int) -> Decomposition:
    from repro_torch.core.cp import cp_als

    return Decomposition(f"cp_als {'x'.join(map(str, T.shape))} rank {rank}", T.device,
                         functools.partial(run_timed, cp_als, T, rank),
                         lambda r: (r.weights, *r.factors),
                         ((rank,), *((d, rank) for d in T.shape)))


def aligned_factor_err(got, want) -> float:
    """Largest difference of two CP factors, each column's sign (which
    follows the eigenvectors of the init) aligned first."""
    return max((f * torch.sign((f * g).sum(0)) - g).abs().max().item()
               for f, g in zip(got.factors, want.factors))


def program_steps(progs) -> list:
    """Every pairwise step of the compiled programs ``progs`` as the
    ``(spec, dims, dtype)`` that ``record_contractions`` records."""
    from repro_torch.core.contract import dtype_name
    from repro_torch.core.notation import parse_spec
    from repro_torch.core.program import propagate_shapes, step_dims

    steps = []
    for prog in progs:
        shapes, dtypes = propagate_shapes(prog.program)
        steps += [(s.spec, step_dims(parse_spec(s.spec), *(shapes[a] for a in s.args)),
                   dtype_name(functools.reduce(torch.promote_types, (dtypes[a] for a in s.args))))
                  for s in prog.program.steps if s.op == "contract"]
    return steps


def cp_case(dev, shape, rank: int, seed: int, n_iter: int, counters) -> dict:
    """Phase 29 at one case (see the module docstring): checks (a)-(e)."""
    from repro_torch.core.contract import contract
    from repro_torch.core.program import record_programs
    from repro_torch.kernels.sb_gemm import native_route

    t0 = time.perf_counter()
    T, noise_share = recoverable_cp(shape, rank, seed, device=dev)
    dec = cp_run(T, rank)
    tag = dec.label
    # the working set of (c) and (d): the steps of the three MTTKRP
    # programs, the only contractions the kernel backend and the tuner
    # reach (the init's Grams are ``direct``, the reconstruction the
    # torch backend's)
    with record_programs() as progs:
        dec.run(1, "kernel")
    mttkrps = list({id(p): p for p in progs if p.options.backend == "kernel"}.values())
    check(len(mttkrps) == 3, f"{tag}: {len(mttkrps)} kernel programs, want 3 MTTKRPs")
    rec = program_steps(mttkrps)
    check_copy_freedom(dev, list({s: d for s, d, _ in rec}.items()))

    # (a), (b) and the turns of (e)
    counted, routes, launches, results, times, peak = counted_turns(dec, n_iter, counters)
    want = CP_LAUNCHES_PER_ITER * n_iter
    log(f"{tag} x{n_iter}: native_gemm launches {counted['native_gemm']} by route "
        f"{routes_text(routes)}, each on native_route's route; torch and conventional "
        f"launched none")
    for (a, b, c, *_), (n, (A, B, _)) in sorted(launches.items(), key=lambda x: x[0][:3]):
        log(f"  {a},{b}->{c} A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)}{B.stride()} "
            f"x{n} [{native_route(A, B, a_modes=a, b_modes=b, c_modes=c)}]")
    check(counted["native_gemm"] == want and counted["grouped_gemm"] == 0
          and counted["flash_attention"] == 0,
          f"{tag}: launches {counted}, want {want} native_gemm and nothing else")
    rel = {v: r.rel_error.item() for v, r in results.items()}
    k, t = results["kernel"], results["torch"]
    lam_err = ((k.weights - t.weights).abs() / t.weights.abs()).max().item()
    fac_err = aligned_factor_err(k, t)
    log(f"{tag}: rel_error kernel {rel['kernel']:.7f}, torch {rel['torch']:.7f}, "
        f"conventional {rel['conventional']:.7f}; noise share {noise_share:.7f} "
        f"(kernel / share {rel['kernel'] / noise_share:.6f}); lambda rel. diff {lam_err:.2e}, "
        f"factor diff (signs aligned) {fac_err:.2e} from torch")
    for v, r in results.items():
        check(dec.whole(r), f"{tag} [{v}]: non-finite or misshapen")
    check(rel["kernel"] <= noise_share * 1.001,
          f"{tag}: kernel rel_error {rel['kernel']} above the noise share {noise_share}")
    for v in ("torch", "conventional"):
        check(abs(rel["kernel"] - rel[v]) <= CP_REL_TOL,
              f"{tag}: kernel rel_error {rel['kernel']} vs {v} {rel[v]}")
    check(lam_err <= CP_LAMBDA_RTOL, f"{tag}: lambda {lam_err} from torch's")
    check(fac_err <= CP_FACTOR_TOL, f"{tag}: factors {fac_err} from torch's")
    med = {v: sorted(ts)[len(ts) // 2] for v, ts in times.items()}
    for v in VARIANTS:
        log(f"{tag} x{n_iter} [{v}]: {med[v]:.3f} ms per CP-ALS (runs "
            f"{', '.join(f'{x:.3f}' for x in times[v])}), speedup over conventional "
            f"{med['conventional'] / med[v]:.3f}x")

    # (d)
    tuned = tuned_path(dec, rec, noise_share, n_iter, counters, {"ms": med, "rel": rel})

    # (e) every launch shape against its bound, the plain version and einsum
    tot = time_shapes(launches, per="CP-ALS")
    mttkrp_bytes = T.numel() * T.element_size()
    mttkrp_flops = 2 * T.numel() * rank
    reckoned = 3 * n_iter * bound(mttkrp_bytes, mttkrp_flops, T.dtype)[0]
    log(f"{tag}: {counted['native_gemm']} launches {tot['ms']:.4f} ms queued against a bound "
        f"of {tot['bound_ms']:.4f} ({tot['bound_by']}; {3 * n_iter} MTTKRPs reading T once "
        f"each: {reckoned:.4f}), einsum {tot['library_ms']:.4f}; "
        f"{100 * tot['ms'] / med['kernel']:.1f}% of the {med['kernel']:.3f} ms per CP-ALS")
    # the init's three eigh alone, then one kernel run's device time by kind
    grams = [contract(s, T, T, strategy="direct")
             for s in ("mnp,qnp->mq", "mnp,mqp->nq", "mnp,mnq->pq")]
    eigh_ms = [cuda_ms(lambda g=g: torch.linalg.eigh(g), 3) for g in grams]
    log(f"{tag}: eigh of the init's Grams {', '.join(f'{x:.3f}' for x in eigh_ms)} ms "
        f"({sum(eigh_ms):.3f} ms of {med['kernel']:.3f} per CP-ALS)")
    prof = profile_device(f"one {tag} [kernel]", lambda: dec.run(n_iter, "kernel"), top=15,
                          kinds=CP_KINDS)
    if prof:
        rest = prof["busy_ms"] - sum(ms for ms, _ in prof["by_kind"].values())
        log(f"{tag}: device busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} "
            f"(idle share {prof['idle_share']:.3f}); the rest {rest:.3f} ms")
    log(f"{tag}: peak memory of the counted run {peak / 1e9:.3f} GB; "
        f"case took {time.perf_counter() - t0:.1f} s")
    return dict(launches=counted["native_gemm"], launches_by_route=routes, ms=med, rel=rel,
                noise_share=noise_share, lambda_rel_diff=lam_err, factor_diff=fac_err,
                tuned=tuned, reckoned_bound_ms=reckoned, eigh_ms=eigh_ms, peak_bytes=peak,
                profile=prof, **{k: tot[k] for k in ("max_abs_err", "bound_by")},
                per_cp_als={k: tot[k] for k in ("ms", "call_ms", "plain_ms", "library_ms",
                                                "library_call_ms", "bound_ms")})


def cp_path(dev, seed: int, counters, cases=CP_CASES, n_iter: int = CP_ITER) -> dict:
    """Phase 29: CP-ALS at each of ``cases`` (see the module docstring).
    Returns ``native_gemm``'s launches over the cases' counted runs, by
    route, and each case's record."""
    t_start = time.perf_counter()
    recs = {}
    for shape, rank in cases:
        recs[f"{'x'.join(map(str, shape))} rank {rank}"] = cp_case(dev, shape, rank, seed,
                                                                   n_iter, counters)
        gc.collect()
        torch.cuda.empty_cache()
    by_route = Counter()
    for r in recs.values():
        by_route.update(r["launches_by_route"])
    log(f"cp: phase 29 took {time.perf_counter() - t_start:.1f} s")
    return dict(launches=sum(r["launches"] for r in recs.values()),
                launches_by_route=dict(by_route), cases=recs)


# ------------------------------------------------------------------- phase 8
#: qwen2-moe-a2.7b's routed experts (src/repro/configs/qwen2_moe_a2p7b.py)
MOE = dict(n_experts=60, top_k=4, d_model=2048, d_expert=1408, tokens=4096)


def moe_counts(seed: int, skewed: bool = True) -> np.ndarray:
    """Rows per expert for ``MOE["tokens"]`` tokens, each routed to
    ``top_k`` distinct experts drawn (Gumbel top-k) from a popularity:
    ``skewed``, Zipf with the last expert never chosen (an assumption with
    no routing trace behind it), else uniform (what a load-balancing loss
    aims at)."""
    rng = np.random.default_rng(seed)
    E = MOE["n_experts"]
    pop = 1.0 / np.arange(1, E + 1) if skewed else np.ones(E)
    if skewed:
        pop[-1] = 0.0
    with np.errstate(divide="ignore"):
        scores = np.log(pop / pop.sum()) + rng.gumbel(size=(MOE["tokens"], E))
    top = np.argsort(-scores, axis=1)[:, :MOE["top_k"]]
    return np.bincount(top.ravel(), minlength=E)


def time_with(fn, reps: int, counters) -> float:
    """``cuda_ms`` of ``fn`` with every launch count put back afterwards:
    timing launches do not count."""
    saved = [c.launches for c in counters]
    ms = cuda_ms(fn, reps)
    for c, n in zip(counters, saved):
        c.launches = n
    return ms


def grouped_bytes(As, Bs, trans_b: bool, out_dtype) -> int:
    """Bytes the grouped product ``A_g (m, k) @ B_g`` must move: each group
    with output reads its A and B once and writes its C once, unpadded; a
    group with no rows or columns moves nothing (an expert with no tokens
    reads no weights)."""
    total = 0
    for A, B in zip(As, Bs):
        m, n = A.shape[0], B.shape[0 if trans_b else 1]
        if m and n:
            total += nbytes(A, B) + m * n * out_dtype.itemsize
    return total


def grouped_path(dev, seed: int, counters, reps: int = 10) -> dict:
    """The expert up-projection ``A_g (m_g, 2048) @ W_g (2048, 1408)`` of
    qwen2-moe-a2.7b through ``grouped_matmul``: under a skewed routing in
    f32, bf16, and bf16 with the weights stored ``(1408, 2048)``
    (``trans_b``); under a uniform routing in bf16.  Checks (the bf16 runs
    on the wgmma route, f32 on fma), then times the kernel, the path with
    its packing, ``pack_groups`` alone, the plain version and library
    calls.  Returns the skewed bf16 run's record for the kernels line, with
    the f32 run's (the fma route) under ``"fma"``."""
    from repro_torch.kernels.grouped_gemm import (
        grouped_gemm, grouped_gemm_packed_ref, grouped_gemm_ref, pack_groups,
        packed_geometry)
    from repro_torch.kernels.ops import grouped_matmul

    routings = {"skewed": moe_counts(seed), "uniform": moe_counts(seed, skewed=False)}
    check(routings["skewed"].min() == 0, "routing left no expert empty")
    M, K, N = MOE["tokens"] * MOE["top_k"], MOE["d_model"], MOE["d_expert"]
    for how, counts in routings.items():
        log(f"moe routing [{how}]: {MOE['tokens']} tokens x top-{MOE['top_k']} = {M} rows "
            f"over {MOE['n_experts']} experts; rows per expert max {counts.max()}, median "
            f"{int(np.median(counts))}, min {counts.min()} "
            f"({int((counts == 0).sum())} empty)")
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(M, K, device=dev, generator=gen)       # routed rows, by expert
    W = torch.randn(MOE["n_experts"], K, N, device=dev, generator=gen) * K**-0.5
    Xb, Wb = X.bfloat16(), W.bfloat16()
    runs = {"f32": (X, W, False, "skewed"), "bf16": (Xb, Wb, False, "skewed"),
            "bf16 trans_b": (Xb, Wb.transpose(1, 2).contiguous(), True, "skewed"),
            "bf16 uniform": (Xb, Wb, False, "uniform")}

    def split(x, counts):
        offs = np.concatenate([[0], np.cumsum(counts)])
        return [x[offs[g]:offs[g + 1]] for g in range(len(counts))]

    groups = {name: (split(x, routings[how]), list(w), tb, routings[how])
              for name, (x, w, tb, how) in runs.items()}

    for c in counters:
        c.launches = 0
    grouped_gemm.launches_by_route = dict.fromkeys(grouped_gemm.launches_by_route, 0)
    outs = {name: grouped_matmul(As, Bs, trans_b=tb) for name, (As, Bs, tb, _) in groups.items()}
    torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(grouped_gemm.launches_by_route)
    check(counted["grouped_gemm"] == len(runs) and sum(counted.values()) == len(runs),
          f"grouped path launches {counted}")
    check(routes == {"wgmma": 3, "fma": 1}, f"grouped path routes {routes}: the three bf16 "
                                            f"runs must take wgmma, f32 fma")

    rec = {}
    for name, (As, Bs, tb, counts) in groups.items():
        got = outs[name]
        want = grouped_gemm_ref(As, Bs, trans_b=tb)
        dt = As[0].dtype
        check([tuple(o.shape) for o in got] == [(int(c), N) for c in counts],
              f"moe {name}: output shapes")
        check(all(bool(torch.isfinite(o).all()) for o in got), f"moe {name}: non-finite")
        err = max(rel_err(o, w) for o, w in zip(got, want) if o.numel())
        check(err <= TOL[dt], f"moe {name}: error {err} against the plain version")
        abs_err = max((o.float() - w.float()).abs().max().item()
                      for o, w in zip(got, want) if o.numel())
        del want
        A_flat, B_flat, descs, problems = pack_groups(As, Bs, trans_b=tb)
        _, out_rows, out_cols = packed_geometry(problems)
        kw = dict(out_cols=out_cols, out_rows=out_rows)
        saved = (dict(grouped_gemm.launches_by_route), [c.launches for c in counters])
        ms = queued_ms(lambda: grouped_gemm(A_flat, B_flat, descs, **kw), reps)
        call_ms = cuda_ms(lambda: grouped_gemm(A_flat, B_flat, descs, **kw), reps)
        path_ms = cuda_ms(lambda: grouped_matmul(As, Bs, trans_b=tb), reps)
        grouped_gemm.launches_by_route = saved[0]
        for c, count in zip(counters, saved[1]):     # timing launches do not count
            c.launches = count
        pack_ms = cuda_ms(lambda: pack_groups(As, Bs, trans_b=tb), reps)
        aliased = B_flat.data_ptr() == Bs[0].data_ptr()
        plain_ms = cuda_ms(lambda: grouped_gemm_packed_ref(
            A_flat, B_flat, descs, out_cols=out_cols, out_rows=out_rows), reps)
        # 3 queued rounds of 60 matmuls stay inside the card's launch queue,
        # which a full queue would make the host wait on
        loop = lambda: [a @ (b.T if tb else b) for a, b in zip(As, Bs)]
        loop_ms, loop_q_ms = cuda_ms(loop, reps), queued_ms(loop, 3)
        W3 = torch.stack(Bs).transpose(1, 2) if tb else torch.stack(Bs)
        A_pad = torch.zeros(len(As), int(counts.max()), K, dtype=dt, device=dev)
        for g, a in enumerate(As):
            A_pad[g, :a.shape[0]] = a
        bmm_ms = cuda_ms(lambda: torch.bmm(A_pad, W3), reps)
        del A_pad
        lib_ms, lib_note = None, "none (torch._grouped_mm takes bf16 only)"
        if dt == torch.bfloat16:
            if hasattr(torch, "_grouped_mm"):
                x_cat = torch.cat(As)
                offs_t = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=dev)
                try:
                    lib_ms = queued_ms(lambda: torch._grouped_mm(x_cat, W3, offs=offs_t), reps)
                    lib_note = f"{lib_ms:.4f} ms"
                except RuntimeError as exc:   # the yardstick only: the port never calls it
                    lib_note = f"none ({str(exc).splitlines()[0][:100]})"
            else:
                lib_note = "none (torch has no _grouped_mm)"
        flops = 2 * M * N * K
        b_ms, by = bound(grouped_bytes(As, Bs, tb, dt), flops, dt)
        log(f"moe up-projection [{name}] {M}x{K} @ {MOE['n_experts']}x{K}x{N}: kernel "
            f"{ms:.4f} ms (calls queued), {flops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms "
            f"({by}), {100 * b_ms / ms:.1f}% of bound; grouped_gemm call {call_ms:.4f} ms "
            f"(CUDA events); grouped_matmul with packing {path_ms:.4f} ms; "
            f"pack_groups alone {pack_ms:.4f} ms (B a view of the weights: {aliased}); "
            f"plain {plain_ms:.4f} ms; library _grouped_mm {lib_note} (calls queued); per-group "
            f"torch.matmul loop {loop_q_ms:.4f} ms queued ({loop_ms:.4f} ms by events; "
            f"kernel/loop {ms / loop_q_ms:.3f}x); padded-to-largest torch.bmm {bmm_ms:.4f} ms; "
            f"max abs error {abs_err:.3g}")
        rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, loop_ms=loop_q_ms, max_abs_err=abs_err)
        del A_flat, B_flat
    same = all(torch.equal(a, b) for a, b in zip(outs["bf16"], outs["bf16 trans_b"]))
    log(f"moe: trans_b result bit-identical to the plain-layout bf16 result: {same}; "
        f"path launches {counted}, by route {routes}")
    f32 = rec["f32"]
    fma = {k: f32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    fma |= {"library_ms": f32["loop_ms"],
            "library": "per-group torch.matmul loop over the 60 experts (calls queued)"}
    return {**{k: v for k, v in rec["bf16"].items() if k != "loop_ms"},
            "launches": counted["grouped_gemm"], "fma": fma}


# ------------------------------------------------------------------- phase 9
#: internlm2-20b (src/repro/configs/internlm2_20b.py): 48 query heads over
#: 8 KV heads, d_model 6144
ATTN = dict(n_heads=48, n_kv_heads=8, d_model=6144, seq=4096)


def sdpa_backend(q4, k4, v4, causal: bool, reps: int) -> str:
    """Which backend the default SDPA call takes on these inputs: its
    output is compared bit for bit with the efficient-attention and math
    backends' (each timed as well), and one profiled call names its device
    kernels.  Returns the backend whose output it equals, else "unknown"."""
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    default, found, notes = sdpa(), "unknown", []
    for name, backend, n in (("efficient", SDPBackend.EFFICIENT_ATTENTION, reps),
                             ("math", SDPBackend.MATH, 2)):
        with sdpa_kernel(backend):
            try:
                same = torch.equal(sdpa(), default)
                ms = cuda_ms(sdpa, n)
            except RuntimeError as exc:     # a backend that refuses these inputs
                notes.append(f"{name}: refused ({str(exc).splitlines()[0][:80]})")
                continue
        notes.append(f"{name} {ms:.4f} ms, output bit-identical to the default call: {same}")
        if same and found == "unknown":
            found = name
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
    log(f"SDPA {q4.dtype} causal={causal}: {'; '.join(notes)}; the default call takes "
        f"{found}; its device kernels: {', '.join(n[:100] for n in names) or 'none recorded'}")
    return found


def attention_path(dev, seed: int, counters, reps: int = 5) -> dict:
    """internlm2-20b prefill through ``flash_attention``, heads folded into
    BH as a GQA caller does: causal in bf16 and f32, and non-causal in
    bf16.  Checks (both bf16 runs on the wgmma route), then times the
    kernel, the plain version and SDPA, and names SDPA's backend for f32.
    Returns the causal bf16 run's record for the kernels line, with the
    f32 run's (the fma route) under ``"fma"``."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    H, Hkv, S = ATTN["n_heads"], ATTN["n_kv_heads"], ATTN["seq"]
    D, R = ATTN["d_model"] // H, H // Hkv
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, Hkv, R, S, D, device=dev, generator=gen)
    k, v = (torch.randn(1, Hkv, S, D, device=dev, generator=gen) for _ in range(2))

    def fold(x, dt):   # (1, Hkv, [R,] S, D) -> (H, S, D), each q head its kv head
        x = x if x.ndim == 5 else x[:, :, None].expand(1, Hkv, R, S, D)
        return x.reshape(H, S, D).to(dt)

    qkv = {dt: [fold(x, dt) for x in (q, k, v)] for dt in (torch.bfloat16, torch.float32)}
    runs = {"bf16": (torch.bfloat16, True), "f32": (torch.float32, True),
            "bf16 full": (torch.bfloat16, False)}
    for c in counters:
        c.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    outs = {name: flash_attention(*qkv[dt], causal=causal) for name, (dt, causal) in runs.items()}
    torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(flash_attention.launches_by_route)
    check(counted["flash_attention"] == len(runs) and sum(counted.values()) == len(runs),
          f"attention path launches {counted}")
    check(routes == {"wgmma": 2, "fma": 1}, f"attention path routes {routes}: both bf16 "
                                            f"prefills must take wgmma, f32 fma")

    # bf16 control: how far rounding to bf16 alone moves the plain version
    # from the f32 reference; the bf16 kernel may be at most twice as far
    want32 = flash_attention_ref(*qkv[torch.float32], causal=True)
    want16 = flash_attention_ref(*qkv[torch.bfloat16], causal=True)
    control = row_rel_err(want16, want32)
    to_f32 = row_rel_err(outs["bf16"], want32)
    log(f"attention bf16 against the f32 reference, worst row: kernel {to_f32:.4g}, plain "
        f"version {control:.4g} (the control; limit twice it)")
    check(to_f32 <= 2 * control, f"attention bf16: kernel {to_f32} from the f32 reference, "
                                 f"over twice the plain version's {control}")
    del want16

    rec = {}
    for name, (dt, causal) in runs.items():
        qf, kf, vf = qkv[dt]
        got = outs[name]
        check(tuple(got.shape) == (H, S, D) and got.dtype == dt, f"attention {name}: shape")
        check(bool(torch.isfinite(got).all()), f"attention {name}: non-finite")
        want = want32 if name == "f32" else flash_attention_ref(qf, kf, vf, causal=causal)
        err = row_rel_err(got, want)
        check(err <= TOL[dt], f"attention {name}: worst row's error {err} against the "
                              f"plain version")
        abs_err = (got.float() - want.float()).abs().max().item()
        log(f"attention {name}: worst row's error against the plain version {err:.4g} "
            f"(limit {TOL[dt]:g}), max abs error {abs_err:.3g}")
        del want
        ms = time_with(lambda: flash_attention(qf, kf, vf, causal=causal), reps, counters)
        plain_ms = cuda_ms(lambda: flash_attention_ref(qf, kf, vf, causal=causal), 2)
        q4, k4, v4 = (x.view(1, H, S, D) for x in (qf, kf, vf))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), reps)
        pairs = S * (S + 1) // 2 if causal else S * S   # (i, j) pairs computed
        flops = 4 * H * D * pairs
        b_ms, by = bound(4 * nbytes(qf), flops, dt)
        log(f"attention prefill [{name}] BH={H} S=T={S} D={D} causal={causal}: kernel "
            f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms ({by}), "
            f"{100 * b_ms / ms:.2f}% of bound; plain {plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms "
            f"(kernel/SDPA {ms / lib_ms:.3f}x); max abs error {abs_err:.3g}")
        rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, max_abs_err=abs_err)
        if dt == torch.float32:
            rec[name]["library"] = f"SDPA, default call ({sdpa_backend(q4, k4, v4, causal, reps)})"
    log(f"attention: path launches {counted}, by route {routes}")
    return {**rec["bf16"], "launches": counted["flash_attention"], "fma": rec["f32"]}


# ------------------------------------------------------------------ phase 11
#: the serving cell: internlm2-20b at its published widths, depth cut to
#: ``periods`` layers (the one cut); 8 greedy requests of 32-256 prompt
#: tokens and 16 new tokens on 4 slots
SERVE = dict(arch="internlm2-20b", periods=4, requests=8, prompt=(32, 256), max_new=16,
             slots=4, max_len=512, chunk=64, top_shapes=8, page_size=16, prefix=128,
             tail=(32, 128))


def serve_traffic(cfg, seed: int):
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(seed)
    lo, hi = SERVE["prompt"]
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
                    .astype(np.int32), max_new_tokens=SERVE["max_new"])
            for i in range(SERVE["requests"])]


def prefix_traffic(cfg, seed: int):
    """The system-prompt mix: ``SERVE["requests"]`` requests that share one
    ``SERVE["prefix"]``-token prefix, each with its own tail, drawn from
    ``seed``."""
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, SERVE["prefix"])
    lo, hi = SERVE["tail"]
    return [Request(rid=i, prompt=np.concatenate(
                [prefix, rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))])
                .astype(np.int32), max_new_tokens=SERVE["max_new"])
            for i in range(SERVE["requests"])]


def check_pool_whole(rt, what: str) -> None:
    check(rt.pool.n_free == rt.pool.usable and not rt.pool.refcount,
          f"{what}: the pool did not drain ({rt.pool.n_free} of {rt.pool.usable} pages "
          f"free, refcounts {rt.pool.refcount})")


def paged_serve(cfg, params, rt, outputs, seed: int, counters, kw) -> dict:
    """The counted serve's traffic through the paged runtime (default
    pool, ``SERVE["page_size"]``-row pages): the unpaged serve's tokens,
    a whole pool after the drain, no bucket entry built after the warm-up;
    then the prefix-sharing mix with sharing on and off (the same tokens,
    shared tokens > 0), and paged against unpaged tokens/s in turns."""
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.runtime.engine import ServingRuntime

    t0 = time.perf_counter()
    rt_p = ServingRuntime(cfg, params, prefill_chunk=SERVE["chunk"], paged=True,
                          page_size=SERVE["page_size"], **kw)
    torch.cuda.synchronize()
    log(f"paged: pool of {rt_p.pool.usable} usable pages x {rt_p.pool.page_size} rows, "
        f"lattice {rt_p.lattice.describe()}; built and warmed in "
        f"{time.perf_counter() - t0:.2f} s")
    rt_p.serve(serve_traffic(cfg, seed))
    check_pool_whole(rt_p, "paged warm-up serve")
    entries = rt_p.buckets.compiles

    # the paged path: counts to 0 just before, read just after
    traffic = serve_traffic(cfg, seed)
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with native_routes_held() as held:
        rt_p.serve(traffic)
        torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    check(all(r.done and len(r.output) == SERVE["max_new"] for r in traffic),
          f"paged: not every request finished: "
          f"{[(r.rid, r.status, len(r.output)) for r in traffic]}")
    same = [r.output == o for r, o in zip(traffic, outputs)]
    check(all(same), f"paged: tokens differ from the unpaged serve's for requests "
                     f"{[r.rid for r, ok in zip(traffic, same) if not ok]}")
    check_pool_whole(rt_p, "paged serve")
    check(rt_p.buckets.compiles == entries,
          f"paged: the counted serve built {rt_p.buckets.compiles - entries} bucket entries")
    check(counted["native_gemm"] > 0 and counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"paged: launches {counted}")
    check(routes == held, f"paged: routes {routes} differ from native_route's {held}")
    stats = rt_p.pool.stats()
    log(f"paged: {len(traffic)} requests, tokens equal to the unpaged serve's; pool whole "
        f"after the drain ({stats['pages_free']} of {stats['pages_total']} free, "
        f"{stats['page_allocs']} allocations); bucket entries {entries}, none built by the "
        f"counted serve; native_gemm launches {counted['native_gemm']} by route {routes}")

    mix = {}
    for sharing in (True, False):
        rt_s = rt_p if sharing else ServingRuntime(
            cfg, params, prefill_chunk=SERVE["chunk"], paged=True,
            page_size=SERVE["page_size"], prefix_sharing=False, **kw)
        before = dict(rt_s.pool.stats())
        reqs = rt_s.serve(prefix_traffic(cfg, seed))
        check(all(r.done and len(r.output) == SERVE["max_new"] for r in reqs),
              f"prefix mix (sharing {sharing}): not every request finished")
        check_pool_whole(rt_s, f"prefix mix (sharing {sharing})")
        after = rt_s.pool.stats()
        mix[sharing] = dict(outputs=[r.output for r in reqs],
                            shared_tokens=after["prefix_shared_tokens"]
                            - before["prefix_shared_tokens"],
                            hits=after["prefix_hits"] - before["prefix_hits"])
    check(mix[True]["outputs"] == mix[False]["outputs"],
          "prefix mix: tokens with prefix sharing differ from those without")
    check(mix[True]["shared_tokens"] > 0 and mix[False]["shared_tokens"] == 0,
          f"prefix mix: shared tokens {mix[True]['shared_tokens']} (on), "
          f"{mix[False]['shared_tokens']} (off)")
    prompts = [len(r.prompt) for r in prefix_traffic(cfg, seed)]
    log(f"prefix mix: {len(prompts)} requests sharing a {SERVE['prefix']}-token prefix, prompts "
        f"{prompts}; sharing on: {mix[True]['hits']} hits, {mix[True]['shared_tokens']} shared "
        f"tokens; sharing off: 0; tokens equal")

    saved = [c.launches for c in counters]
    runs = {"unpaged": [], "paged": []}
    for mode in ("unpaged", "paged", "paged", "unpaged"):
        res = timed_serve(rt if mode == "unpaged" else rt_p, serve_traffic(cfg, seed))
        check(res["outputs"] == outputs, f"a timed {mode} serve gave other tokens")
        runs[mode].append(res)
        log(f"serve [kernel, {mode}]: {res['tokens']} tokens in {res['wall_ms']:.1f} ms, "
            f"{res['tokens_per_s']:.1f} tokens/s; prefill {res['chunk_ms']:.3f} ms per chunk; "
            f"decode ms per tick by bucket: "
            f"{', '.join(f'{b}: {m:.3f}' for b, m in res['tick_ms_by_bucket'].items())}")
    for c, n in zip(counters, saved):
        c.launches = n
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                prefix_shared_tokens=mix[True]["shared_tokens"],
                tokens_per_s={m: [r["tokens_per_s"] for r in v] for m, v in runs.items()})


def timed_serve(rt, traffic) -> dict:
    """Serve ``traffic`` with every prefill chunk and decode tick timed by
    the host clock between device synchronisations: ms per chunk by its
    length, ms per prompt by its length (its chunks summed), ms per tick
    by its bucket, tokens/s over the whole serve."""
    chunks, ticks, prompts = {}, {}, {}
    prefill_impl, decode_impl = rt._run_prefill_chunk_impl, rt._run_decode_impl

    def timed(fn, into, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        into.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return into[key][-1]

    def prefill_timed(state, chunk):
        L = len(state.request.prompt)
        prompts[L] = prompts.get(L, 0.0) + timed(lambda: prefill_impl(state, chunk), chunks,
                                                 chunk)

    rt._run_prefill_chunk_impl = prefill_timed
    rt._run_decode_impl = lambda decodes: timed(
        lambda: decode_impl(decodes), ticks, rt.lattice.decode_bucket(len(decodes)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.serve(traffic)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rt._run_prefill_chunk_impl, rt._run_decode_impl = prefill_impl, decode_impl
    tokens = sum(len(r.output) for r in traffic)
    n_chunks = sum(len(v) for v in chunks.values())
    return dict(wall_ms=wall_ms, tokens_per_s=tokens / wall_ms * 1e3, tokens=tokens,
                chunk_ms=sum(map(sum, chunks.values())) / n_chunks, n_chunks=n_chunks,
                chunk_ms_by_len={c: sum(v) / len(v) for c, v in sorted(chunks.items())},
                prefill_ms_by_prompt=dict(sorted(prompts.items())),
                tick_ms_by_bucket={b: sum(v) / len(v) for b, v in sorted(ticks.items())},
                ticks_by_bucket={b: len(v) for b, v in sorted(ticks.items())},
                outputs=[list(r.output) for r in traffic])


def serve_path(dev, seed: int, counters) -> dict:
    """internlm2-20b at full width through ``ServingRuntime`` on the kernel
    backend, then the same traffic on the torch backend (see the module
    docstring, phase 11).  Returns ``native_gemm``'s serving record."""
    from repro_torch.configs import get_config
    from repro_torch.core.contract import record_contractions
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import transformer
    from repro_torch.runtime.engine import ServingRuntime, slot_cache
    from repro_torch.serving.engine import ServeEngine

    periods = SERVE["periods"]
    full = get_config(SERVE["arch"])
    cfg = full.with_(n_periods=periods, contract_backend="kernel", contract_strategy="auto")
    cfg_t = cfg.with_(contract_backend="torch")
    log(f"serve: {cfg.arch_id} d_model {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads, head dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype} activations, {cfg.param_dtype} params; depth cut "
        f"from {full.n_periods} layers to {periods} (the one cut); "
        f"{cfg.param_count() / 1e9:.2f}B params")
    t0 = time.perf_counter()
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    log(f"serve: random weights drawn on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
    kw = dict(slots=SERVE["slots"], max_len=SERVE["max_len"])

    t0 = time.perf_counter()
    rt = ServingRuntime(cfg, params, prefill_chunk=SERVE["chunk"], **kw)
    torch.cuda.synchronize()
    log(f"serve: runtime built, warm-up of every lattice point {rt.lattice.describe()} in "
        f"{time.perf_counter() - t0:.2f} s ({rt.program_stats})")
    warm = rt.serve(serve_traffic(cfg, seed))
    entries = rt.buckets.compiles

    # the main path: counts to 0 just before, read just after
    traffic = serve_traffic(cfg, seed)
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with recording_launches() as launches, native_routes_held("serve") as held:
        rt.serve(traffic)
        torch.cuda.synchronize()
    TC_UNITS["serve"] = (1, "serve")
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    outputs = [r.output for r in traffic]
    check(all(r.done and len(r.output) == SERVE["max_new"] for r in traffic),
          f"serve: not every request finished with its {SERVE['max_new']} tokens: "
          f"{[(r.rid, r.status, len(r.output)) for r in traffic]}")
    check(rt.buckets.compiles == entries, f"serve: the second serve built "
                                          f"{rt.buckets.compiles - entries} bucket entries")
    check(outputs == [r.output for r in warm], "serve: the warm-up serve gave other tokens")
    check(counted["native_gemm"] > 0, "serve: native_gemm launched no time")
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"serve: another kernel launched on the path: {counted}")
    check(counted["native_gemm"] == sum(n for n, _ in launches.values())
          and routes == held, f"serve: launch count {counted} or routes {routes} differ "
                              f"from the recorded run's {held}")
    log(f"serve: {len(traffic)} requests, prompts {[len(r.prompt) for r in traffic]}, "
        f"{sum(len(o) for o in outputs)} tokens; native_gemm launches {counted['native_gemm']} "
        f"by route {routes}; grouped_gemm {counted['grouped_gemm']}, flash_attention "
        f"{counted['flash_attention']}; bucket entries {entries}, none built by the second "
        f"serve")

    # every model contraction of a decode pass and of a prefill chunk
    # launches native_gemm once: 9 per layer (q, k, v, o, scores, P.V and
    # three MLP products) and the LM head
    scratch = slot_cache(cfg, SERVE["slots"], SERVE["max_len"], device=dev)
    toks = torch.zeros((SERVE["slots"], 1), dtype=torch.long, device=dev)
    prompt = torch.as_tensor(traffic[0].prompt[:SERVE["chunk"]], device=dev)[None].long()
    # launches ``wgmma`` for the 7 dense products of a layer and the LM head,
    # ``batched`` for the scores and P.V products
    per_pass = {"wgmma": 7 * periods + 1, "batched": 2 * periods}
    for name, run in (("decode pass", lambda: transformer.decode_step(cfg, params, scratch, toks)),
                      ("prefill chunk", lambda: transformer.prefill(
                          cfg, params, {"tokens": prompt},
                          transformer.init_cache(cfg, 1, SERVE["max_len"], device=dev)))):
        before = native_gemm.launches, dict(native_gemm.launches_by_route)
        with torch.no_grad(), record_contractions() as rec:
            run()
        n = native_gemm.launches - before[0]
        by_route = {r: c - before[1][r] for r, c in native_gemm.launches_by_route.items()
                    if c > before[1][r]}
        check(n == len(rec) == 9 * periods + 1,
              f"serve: a {name} made {len(rec)} contractions and {n} native_gemm launches, "
              f"not {9 * periods + 1} each")
        check(by_route == per_pass, f"serve: a {name} launched by route {by_route}, not "
                                    f"{per_pass}")
        log(f"serve: one {name}: {len(rec)} contractions, {n} native_gemm launches, by route "
            f"{by_route}")
    check(routes["wgmma"] * (9 * periods + 1) == per_pass["wgmma"] * counted["native_gemm"]
          and routes["wgmma"] + routes["batched"] == counted["native_gemm"],
          f"serve: the counted serve's routes {routes} are not {per_pass['wgmma']} wgmma in "
          f"every {9 * periods + 1} launches")
    native_gemm.launches = counted["native_gemm"]
    native_gemm.launches_by_route = dict(routes)

    legacy = ServeEngine(cfg, params, **kw).serve(serve_traffic(cfg, seed))
    check([r.output for r in legacy] == outputs,
          "serve: the runtime's tokens differ from ServeEngine's (the legacy oracle)")
    log("serve: tokens equal ServeEngine's (legacy engine, same kernels)")
    paged = paged_serve(cfg, params, rt, outputs, seed, counters, kw)

    with torch.no_grad():
        cache = transformer.init_cache(cfg, 1, SERVE["max_len"], device=dev)
        prompt = torch.as_tensor(traffic[0].prompt, device=dev)[None].long()
        got, _ = transformer.prefill(cfg, params, {"tokens": prompt}, cache)
        want, _ = transformer.prefill(cfg_t, params, {"tokens": prompt}, cache)
    err = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (1, cfg.vocab_size),
          "serve: prefill logits not finite or of the wrong shape")
    check(err <= TOL[torch.bfloat16], f"serve: kernel prefill logits {err} from the torch "
                                      f"backend's (limit {TOL[torch.bfloat16]})")
    log(f"serve: prefill logits of a {prompt.shape[1]}-token prompt, kernel against torch "
        f"backend: {err:.4g} of the largest magnitude (limit {TOL[torch.bfloat16]:g})")

    # times, the two backends in turns
    rt_t = ServingRuntime(cfg_t, params, prefill_chunk=SERVE["chunk"], **kw)
    rt_t.serve(serve_traffic(cfg, seed))
    saved = [c.launches for c in counters]
    runs = {"kernel": [], "torch": []}
    for backend in runs:
        res = timed_serve(rt if backend == "kernel" else rt_t, serve_traffic(cfg, seed))
        runs[backend].append(res)
        log(f"serve [{backend}]: {res['tokens']} tokens in {res['wall_ms']:.1f} ms, "
            f"{res['tokens_per_s']:.1f} tokens/s; prefill {res['chunk_ms']:.3f} ms per chunk "
            f"over {res['n_chunks']} chunks (by length: "
            f"{', '.join(f'{c}: {m:.3f}' for c, m in res['chunk_ms_by_len'].items())}); "
            f"decode ms per tick by bucket: "
            f"{', '.join(f'{b}: {m:.3f} (x{res['ticks_by_bucket'][b]})' for b, m in res['tick_ms_by_bucket'].items())}")
    check(all(r["outputs"] == outputs for r in runs["kernel"]),
          "serve: a timed kernel serve gave other tokens")
    # where a decode pass (bucket 4) and a 64-token prefill chunk spend
    # device time, and how long the device idles, on each backend
    profiles = {}
    chunk = torch.as_tensor(traffic[0].prompt[:SERVE["chunk"]], device=dev)[None].long()
    with torch.no_grad():
        for backend, conf in (("kernel", cfg), ("torch", cfg_t)):
            for step, fn in (
                    ("decode pass", lambda conf=conf: transformer.decode_step(
                        conf, params, scratch, toks)),
                    ("prefill chunk", lambda conf=conf: transformer.prefill(
                        conf, params, {"tokens": chunk},
                        transformer.init_cache(conf, 1, SERVE["max_len"], device=dev)))):
                fn()
                profiles[f"{backend} {step}"] = profile_device(f"one {step} [{backend}]", fn, top=6)
    for c, n in zip(counters, saved):
        c.launches = n
    same = sum(a == b for r in runs["torch"] for a, b in zip(r["outputs"], outputs))
    log(f"serve: the torch backend's greedy tokens equal the kernel backend's in {same} of "
        f"{len(runs['torch']) * len(outputs)} requests (bf16 rounding differs between the "
        f"two)")
    del rt_t, legacy

    tot = time_shapes(launches, reps=10, per="serve", top=SERVE["top_shapes"])
    return dict(launches=counted["native_gemm"], launches_by_route=routes, periods=periods,
                profiles=profiles, paged=paged, outputs=outputs,
                tokens_per_s={b: [r["tokens_per_s"] for r in v] for b, v in runs.items()},
                runs={b: [{k: v for k, v in r.items() if k != "outputs"}
                                            for r in rs] for b, rs in runs.items()},
                top_shapes={k: tot[k] for k in ("ms", "library_ms", "bound_ms", "plain_ms",
                                                  "max_abs_err", "bound_by")})


# ------------------------------------------------------------------ phase 12
def every_arch(dev, seed: int, counters) -> dict:
    """Each of the ten smoke configs (float32) on the card with the kernel
    backend and on the CPU with the same weights (the plain version): one
    forward; for decoders, prefill plus 3 decode steps (through
    ``ServingRuntime`` with its decode logits, or through the model for a
    vision model, whose prompt carries patch features the runtime does not
    take).  Logits agree within 1e-4 of the largest magnitude."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import transformer
    from repro_torch.models.tree import tree_map
    from repro_torch.runtime.engine import ServingRuntime
    from repro_torch.runtime.scheduler import Request

    tol = 1e-4
    for c in counters:
        c.launches = 0
    worst = {}
    for arch in list_archs():
        cfg = get_config(arch, smoke=True, contract_backend="kernel")
        cpu = transformer.init_params(torch.Generator().manual_seed(seed), cfg)
        card = tree_map(lambda t: t.to(dev), cpu)
        rng = np.random.default_rng(seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
        if cfg.frontend is not None:
            n = 16 if cfg.frontend.kind == "audio" else cfg.frontend.n_positions
            batch["features"] = rng.standard_normal((2, n, cfg.frontend.feature_dim),
                                                    dtype=np.float32)
        on = {d: {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
              for d in (dev, torch.device("cpu"))}
        errs = []
        with torch.no_grad():
            got, _ = transformer.forward(cfg, card, on[dev])
            want, _ = transformer.forward(cfg, cpu, on[torch.device("cpu")])
            errs.append(rel_err(got.cpu(), want))
            if cfg.encoder_only:
                pass
            elif cfg.frontend is not None:
                outs = []
                for params, d in ((card, dev), (cpu, torch.device("cpu"))):
                    cache = transformer.init_cache(cfg, 2, 64, device=d)
                    logits, cache = transformer.prefill(cfg, params, on[d], cache)
                    seq = [logits.cpu()]
                    for _ in range(3):
                        logits, cache = transformer.decode_step(
                            cfg, params, cache, torch.argmax(logits, -1)[:, None])
                        seq.append(logits.cpu())
                    outs.append(seq)
                errs += [rel_err(g, w) for g, w in zip(*outs)]
            else:
                outs = []
                for params in (card, cpu):
                    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8)
                    seen = []
                    rt.logits_probe = lambda logits: seen.append(logits.cpu())
                    reqs = rt.serve([Request(rid=i, prompt=batch["tokens"][i].astype(np.int32),
                                             max_new_tokens=4) for i in range(2)])
                    check(all(r.done and len(r.output) == 4 for r in reqs),
                          f"{arch}: a request did not finish")
                    outs.append((seen, [r.output for r in reqs]))
                (seen_g, toks_g), (seen_c, toks_c) = outs
                check(toks_g == toks_c, f"{arch}: tokens on the card {toks_g} differ from the "
                                        f"CPU's {toks_c}")
                check(len(seen_g) == len(seen_c) == 3, f"{arch}: {len(seen_g)} decode steps")
                errs += [rel_err(g, w) for g, w in zip(seen_g, seen_c)]
        worst[arch] = max(errs)
        check(worst[arch] <= tol, f"{arch}: card against CPU {worst[arch]} (limit {tol})")
        log(f"arch {arch}: forward{'' if cfg.encoder_only else ' + prefill + 3 decode steps'} "
            f"on the card (kernel) against the CPU (plain version): worst {worst[arch]:.3g} "
            f"of the largest logit magnitude over {len(errs)} comparisons (limit {tol:g})")
    torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    check(counted["native_gemm"] > 0 and counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"every-arch launches {counted}")
    log(f"every arch: launches {counted}")
    return worst


# ------------------------------------------------------------------ phase 13
#: minicpm-2b (src/repro/configs/minicpm_2b.py) at its published widths,
#: its depth cut; SyntheticLM batches; the launcher's minicpm preset (WSD)
TRAIN = dict(arch="minicpm-2b", periods=4, seq_len=512, batch=4, steps=6, ckpt_at=3,
             lr=1e-3, warmup=2, total_steps=8, timed_steps=2, top_shapes=8)


def train_launches_per_step(periods: int) -> dict:
    """``native_gemm`` launches of one train step on the kernel backend, by
    route, derived from the model: 9 contractions a layer (q, k, v, o, three
    MLP products on ``wgmma``; scores and P.V on ``batched``) and the LM
    head (``wgmma``), each launched in the forward; remat recomputes each
    layer's 9 in the backward; each product's backward launches two: a
    dense product's dX (its weight carries n and k) and dW (its two
    contracted modes, b and s, fuse into one) on ``wgmma``, the scores'
    and P.V's on ``batched``."""
    dense, attn = 7 * periods + 1, 2 * periods    # a forward's products (the head is dense)
    return {"wgmma": dense + (dense - 1) + 2 * dense,      # forward, recompute, dX and dW
            "batched": attn + attn + 2 * attn}            # forward, recompute, backward


def ssm_train_launches_per_step(cfg) -> dict:
    """``native_gemm`` launches of one mamba2 train step on the kernel
    backend, by route, derived from the model: each product of a forward
    over ``SSM_TRAIN["seq_len"]`` tokens (:func:`ssm_routes`) launches in
    the forward, again in remat's recompute (every layer product: the
    recompute stops only after an autograd Function's forward has
    launched, so out_proj runs as well; ROADMAP C2b), and twice in the
    backward (dX and dW, each on its forward's route); the tied LM head,
    outside remat, launches once in the forward and twice in the
    backward, so one ``wgmma`` launch fewer than four times the
    forward's."""
    forward = ssm_routes(cfg, SSM_TRAIN["seq_len"])
    return {r: 4 * n - (r == "wgmma") for r, n in forward.items()}


def timed_steps(step_fn, params, batch, n: int) -> list:
    """ms of ``n`` train steps from ``params``, each timed by the host clock
    between synchronisations."""
    from repro_torch.training.optimizer import adamw_init

    state, out = adamw_init(params), []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _, m = step_fn(params, state, batch, None)
        float(m["loss"])
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def train_path(dev, seed: int, counters) -> dict:
    """minicpm-2b at its published widths, 4 layers, through the port's
    ``Trainer`` on the kernel backend with ``contract_strategy="native"``
    (see the module docstring, phase 13).  Returns ``native_gemm``'s
    training record."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.minicpm_2b import make_config
    from repro_torch.distributed.compress import Int8Compressor
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import transformer
    from repro_torch.models.tree import tree_leaves, tree_leaves_with_path
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.trainer import (
        TrainConfig, Trainer, make_train_step, value_and_grad,
    )

    periods, steps, at = TRAIN["periods"], TRAIN["steps"], TRAIN["ckpt_at"]
    full = get_config(TRAIN["arch"])
    cfg = full.with_(n_periods=periods, contract_backend="kernel", contract_strategy="native")
    cfg_t = cfg.with_(contract_backend="torch", contract_strategy="auto")
    log(f"train: {cfg.arch_id} d_model {cfg.d_model}, {cfg.n_heads} heads (MHA), head dim "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {make_config().vocab_size} padded to "
        f"{cfg.vocab_size} (get_config, as in the JAX package), tied embeddings, "
        f"{cfg.dtype} activations, {cfg.param_dtype} master weights, remat on; depth cut from "
        f"{full.n_periods} layers to {periods} (the one cut); {cfg.param_count() / 1e9:.3f}B "
        f"params; kernel backend, contract_strategy native")
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    opt = AdamWConfig(lr=TRAIN["lr"], schedule="wsd", warmup_steps=TRAIN["warmup"],
                      total_steps=TRAIN["total_steps"])

    def data():
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                           global_batch=TRAIN["batch"], seed=seed)

    tokens = TRAIN["seq_len"] * TRAIN["batch"]
    per_step = train_launches_per_step(periods)
    n_step = sum(per_step.values())
    check(n_step == (9 * periods + 1) + 9 * periods + 2 * (9 * periods + 1),
          f"train: {per_step} is not 9 a layer + the head, x2 (remat) + 2 per product")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainConfig(opt=opt, ckpt_dir=ckpt_dir, ckpt_every=10**9)
        tr = Trainer(cfg, tcfg, params, data())
        # the main path: counts to 0 just before, read just after
        for c in counters:
            c.launches = 0
        native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with native_routes_held("train") as held:
            hist = tr.run(at)
            tr.save(force=True)
            hist += tr.run(steps - at)
            torch.cuda.synchronize()
        TC_UNITS["train"] = (steps, "step")
        counted = {c.__name__: c.launches for c in counters}
        routes = dict(native_gemm.launches_by_route)
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [h["loss"] for h in hist]
        check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
        check(losses[-1] < losses[0], f"train: step {steps}'s loss {losses[-1]} is not below "
                                      f"step 1's {losses[0]}")
        check(counted["native_gemm"] == steps * n_step,
              f"train: {counted['native_gemm']} native_gemm launches in {steps} steps, not "
              f"{steps} x {n_step}")
        check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
              f"train: another kernel launched on the path: {counted}")
        check(routes == held, f"train: routes {routes} differ from native_route's {held}")
        by_step = {r: n // steps for r, n in routes.items() if n}
        check(by_step == per_step and all(n % steps == 0 for n in routes.values()),
              f"train: launches per step by route {routes} / {steps}, the model gives {per_step}")
        log(f"train: {steps} steps of {TRAIN['batch']} x {TRAIN['seq_len']} tokens, losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}; step ms "
            f"{', '.join(f'{h['step_time_s'] * 1e3:.1f}' for h in hist)}; lr "
            f"{', '.join(f'{h['lr']:.3g}' for h in hist)}; native_gemm launches "
            f"{counted['native_gemm']} ({n_step} a step: by route {by_step}, every one on the "
            f"route native_route gives); grouped_gemm {counted['grouped_gemm']}, "
            f"flash_attention {counted['flash_attention']}; peak memory {peak / 2**30:.2f} GiB")

        saved = [c.launches for c in counters]
        tr2 = Trainer(cfg, tcfg, params, data())
        check(tr2.restore() == at and tr2.step == at and tr2.data.step == at,
              "train: the restart did not resume at the checkpoint's step and cursor")
        again = [h["loss"] for h in tr2.run(steps - at)]
        check(np.allclose(again, losses[at:], rtol=1e-4, atol=0),
              f"train: restarted losses {again} differ from {losses[at:]} beyond rtol 1e-4")
        log(f"train: a fresh Trainer restored step {at} and reran steps {at + 1}-{steps}: losses "
            f"{', '.join(f'{x:.6f}' for x in again)} (first run "
            f"{', '.join(f'{x:.6f}' for x in losses[at:])}); bit-identical: "
            f"{again == losses[at:]}")
        del tr, tr2

    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data()).items()}
    loss_k, _, grads_k = value_and_grad(cfg, params, batch)
    zero_or_bad = [p for p, g in tree_leaves_with_path(grads_k)
                   if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    check(not zero_or_bad, f"train: leaves without a finite nonzero gradient: {zero_or_bad}")
    loss_t, _, grads_t = value_and_grad(cfg_t, params, batch)
    loss_err = abs(float(loss_k) - float(loss_t)) / abs(float(loss_t))
    grad_err = {p: float((gk.float() - gt.float()).abs().max() / gt.float().abs().max())
                for (p, gk), gt in zip(tree_leaves_with_path(grads_k), tree_leaves(grads_t))}
    worst = max(grad_err, key=grad_err.get)
    check(loss_err <= 2e-2, f"train: kernel loss {float(loss_k)} vs torch {float(loss_t)}")
    check(grad_err[worst] <= 5e-2, f"train: gradient of {worst} {grad_err[worst]} of its "
                                   f"largest magnitude from the torch backend's (limit 5e-2)")
    log(f"train: every one of {len(grad_err)} leaves has a finite nonzero gradient; one step "
        f"from the same weights and batch: loss {float(loss_k):.6f} (kernel) vs "
        f"{float(loss_t):.6f} (torch), {loss_err:.3g} apart (limit 2e-2); worst gradient "
        f"{worst} {grad_err[worst]:.3g} of its largest magnitude (limit 5e-2)")
    del grads_k, grads_t

    state = adamw_init(params)
    p1, *_ = make_train_step(cfg, TrainConfig(opt=opt))(params, state, batch, None)
    p2, *_ = make_train_step(cfg, TrainConfig(opt=opt, microbatches=2))(params, state, batch,
                                                                        None)
    d = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    check(d < 5e-3, f"train: microbatches=2 moved the parameters {d} from the full batch's")
    del p1, p2
    comp = Int8Compressor()
    p3, _, _, m3 = make_train_step(cfg, TrainConfig(opt=opt, compression="int8"), comp)(
        params, state, batch, comp.init_residual(params))
    check(np.isfinite(float(m3["loss"])) and all(bool(torch.isfinite(x).all())
                                                  for x in tree_leaves(p3)),
          "train: the int8-compressed step is not finite")
    log(f"train: microbatches=2 step within {d:.3g} of the full batch's parameters (limit "
        f"5e-3; the step's lr is {float(m3['lr']):.3g}); int8-compressed step finite, loss "
        f"{float(m3['loss']):.6f}")
    del p3, state

    # times, the two backends in turns
    steps_fn = {"kernel": make_train_step(cfg, TrainConfig(opt=opt)),
                "torch": make_train_step(cfg_t, TrainConfig(opt=opt))}
    timed_steps(steps_fn["torch"], params, batch, 1)
    runs = {"kernel": [], "torch": []}
    for backend in runs:
        ms = timed_steps(steps_fn[backend], params, batch, TRAIN["timed_steps"])
        runs[backend] += ms
        log(f"train [{backend}]: ms per step {', '.join(f'{m:.1f}' for m in ms)}, "
            f"{tokens / (min(ms) / 1e3):.1f} tokens/s at the fastest")
    ms_step = {b: sorted(v)[len(v) // 2] for b, v in runs.items()}
    profiles = {}
    for backend in ("kernel", "torch"):
        state = adamw_init(params)
        profiles[backend] = profile_device(
            f"one train step [{backend}]",
            lambda b=backend, st=state: steps_fn[b](params, st, batch, None), top=8)
    with recording_launches() as launches:
        steps_fn["kernel"](params, adamw_init(params), batch, None)
        torch.cuda.synchronize()
    check(sum(n for n, _ in launches.values()) == n_step,
          "train: the recorded step launched another count")
    for c, n in zip(counters, saved):
        c.launches = n
    tot = time_shapes(launches, reps=3, per="step", top=TRAIN["top_shapes"])
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                launches_per_step=per_step, periods=periods, losses=losses,
                restart_losses=again, peak_gib=peak / 2**30, profiles=profiles,
                ms_per_step={b: v for b, v in runs.items()},
                tokens_per_s={b: tokens / (ms_step[b] / 1e3) for b in ms_step},
                top_shapes={k: tot[k] for k in ("ms", "library_ms", "bound_ms", "plain_ms",
                                                  "max_abs_err", "bound_by")})


# ------------------------------------------------------------------ phase 14
#: internlm2-20b's MLP (src/repro/configs/internlm2_20b.py) at its published
#: widths, over 2048 rows
MLP = dict(d_model=6144, d_ff=16384, rows=2048)
#: the compiled program's expression and extents (~290 MB of float32)
PROGRAM = dict(spec="bik,kn,nj->bij", b=16, i=2048, k=1024, n=2048, j=1024)
SHARD_REPS = 20
#: reps of each launch shape's times in the sharded run (two of HOOI's take ~155 ms)
SHARD_REPS_SHAPES = 5


def spec_on(modes: str, shard: dict):
    """The PartitionSpec of ``modes`` with ``shard``'s modes over its axes."""
    from repro_torch.distributed.sharding import P

    return P(*[shard.get(m) for m in modes])


#: name prefixes of ``native_gemm``'s ``__global__`` functions (csrc/sb_gemm.cu)
NATIVE_KERNELS = ("ns_", "nw_", "nk_", "nm_", "fb_")


def device_kernels(fn) -> Counter | None:
    """The device kernels one call of ``fn`` runs, by name and count (None
    when the profiler records no device activity)."""
    return Counter(name for *_, name in device_spans(fn)[0]) or None


def sharded_cases(dev, working_set, mesh, seed: int) -> list:
    """The calls of phase 14, each with its unsharded twin: ``(label, call,
    plain, steps, plan text)``."""
    from repro_torch.core.contract import contract
    from repro_torch.core.einsum import xeinsum
    from repro_torch.core.program import compile_program
    from repro_torch.core.table2 import CASES
    from repro_torch.distributed.contract import plan_sharded
    from repro_torch.distributed.sharding import P

    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    cases = []

    def pair(label, spec, A, B, in_specs, out_spec=None):
        dims = dict(zip(modes_of(spec)[0], A.shape)) | dict(zip(modes_of(spec)[1], B.shape))
        plan = plan_sharded(spec, dims, mesh=mesh, in_specs=in_specs, out_spec=out_spec)
        cases.append((label, lambda: contract(spec, A, B, mesh=mesh, in_specs=in_specs,
                                              out_spec=out_spec, backend="kernel"),
                      lambda: contract(spec, A, B, backend="kernel"), 1, plan.describe()))
        return plan

    for spec, dims in working_set:
        a, b, c = modes_of(spec)
        A = torch.randn([dims[m] for m in a], device=dev, generator=gen)
        B = torch.randn([dims[m] for m in b], device=dev, generator=gen)
        free = {c[0]: "x"}
        pair(f"hooi free {spec}", spec, A, B, (spec_on(a, free), spec_on(b, free)))
        k = next(m for m in a if m in b and m not in c)
        ins = (spec_on(a, {k: "y"}), spec_on(b, {k: "y"}))
        plan = pair(f"hooi psum {spec}", spec, A, B, ins)
        check(plan.psum_axes == ("y",), f"{spec}: {plan.describe()} has no psum over y")
        plan = pair(f"hooi scatter {spec}", spec, A, B, ins, spec_on(c, {c[0]: "y"}))
        check(plan.scatters == ((0, ("y",)),), f"{spec}: {plan.describe()} scatters nothing")

    d, f, rows = MLP["d_model"], MLP["d_ff"], MLP["rows"]
    X = torch.randn(1, rows, d, device=dev, generator=gen).to(torch.bfloat16)
    H = torch.randn(1, rows, f, device=dev, generator=gen).to(torch.bfloat16)
    W_up = (torch.randn(d, f, device=dev, generator=gen) / d ** 0.5).to(torch.bfloat16)
    W_down = (torch.randn(f, d, device=dev, generator=gen) / f ** 0.5).to(torch.bfloat16)
    pair("mlp column-parallel", "bse,ef->bsf", X, W_up, (None, P(None, "y")))
    pair("mlp row-parallel", "bsf,fe->bse", H, W_down, (P(None, None, "y"), P("y", None)))

    shard = {"m": "x", "k": "y"}
    for label in sorted(CASES):
        rm = CASES[label].row_major()
        a, b, _ = modes_of(rm)
        A = torch.randn([RAGGED_DIMS[m] for m in a], device=dev, generator=gen)
        B = torch.randn([RAGGED_DIMS[m] for m in b], device=dev, generator=gen)
        ins = (spec_on(a, shard), spec_on(b, shard))
        plan = plan_sharded(rm, dict(zip(a, A.shape)) | dict(zip(b, B.shape)), mesh=mesh,
                            in_specs=ins)
        cases.append((f"table2 {label} {rm}",
                      lambda rm=rm, A=A, B=B, ins=ins: xeinsum(rm, A, B, strategy="kernel",
                                                               mesh=mesh, in_specs=ins),
                      lambda rm=rm, A=A, B=B: xeinsum(rm, A, B, strategy="kernel"),
                      1, plan.describe()))

    ext = {m: PROGRAM[m] for m in "biknj"}
    ops = [torch.randn([ext[m] for m in t], device=dev, generator=gen)
           for t in PROGRAM["spec"].split("->")[0].split(",")]
    ins = (P("x", None, "y"), P("y", None), None)
    prog = compile_program(PROGRAM["spec"], *ops, backend="kernel", mesh=mesh, in_specs=ins)
    plain = compile_program(PROGRAM["spec"], *ops, backend="kernel")
    steps = [s for s in prog.program.steps if s.op == "contract"]
    check([s.spec for s in steps] == [s.spec for s in plain.program.steps if s.op == "contract"],
          "the sharded program planned another path")
    cases.append((f"program {PROGRAM['spec']} {ext}", lambda: prog(*ops), lambda: plain(*ops),
                  len(steps), prog.describe().replace("\n", " | ")))
    return cases


def sharded_path(dev, working_set, seed: int, counters) -> dict:
    """Phase 14: sharded contraction through ``contract``/``xeinsum``/
    ``compile_program`` with ``mesh=`` on a 1x1 mesh over a world of one
    (see the module docstring).  Returns ``native_gemm``'s sharded record."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.contract import count_copy_ops
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.launch.mesh import make_host_mesh

    world = make_host_mesh(1, 1, device=dev.type)
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("x", "y"))
    log(f"sharded: world of {dist.get_world_size()} rank over {dist.get_backend()}; "
        f"make_host_mesh gave {world}; the phase's mesh {mesh}")
    try:
        cases = sharded_cases(dev, working_set, mesh, seed)
        for label, _, _, _, text in cases:
            log(f"sharded plan [{label}]: {text}")

        # HOOI's set and the MLP products run no kernel but native_gemm's
        # unsharded; Table II and the program also run copies
        n_own = sum(not label.startswith(("table2", "program")) for label, *_ in cases)

        # the main path: counts to 0 just before, read just after
        for c in counters:
            c.launches = 0
        native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
        outs = []

        def counted_run(part):
            for label, call, _, steps, _ in part:
                before = native_gemm.launches
                outs.append(call())
                check(native_gemm.launches - before == steps,
                      f"sharded [{label}]: {native_gemm.launches - before} native_gemm "
                      f"launches for {steps} pairwise steps")

        with recording_launches() as launches, native_routes_held() as held:
            kernels_own = device_kernels(lambda: counted_run(cases[:n_own]))
            kernels_rest = device_kernels(lambda: counted_run(cases[n_own:]))
        counted = {c.__name__: c.launches for c in counters}
        routes = dict(native_gemm.launches_by_route)
        saved = [c.launches for c in counters], dict(routes)
        n_steps = sum(steps for *_, steps, _ in cases)
        check(counted["native_gemm"] == n_steps,
              f"sharded: {counted['native_gemm']} launches for {n_steps} steps")
        check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
              f"sharded: another kernel launched on the path: {counted}")
        check(routes == held, f"sharded: routes {routes} differ from native_route's {held}")
        check(routes["wgmma"] >= 2, f"sharded: the MLP products did not take wgmma: {routes}")

        # comparisons: none of these launches count.  The profiler drops
        # device records on the card's machine once earlier phases have
        # profiled, so names are checked and the counts come from the
        # launch counters above.
        kernels_plain = device_kernels(lambda: [plain() for _, _, plain, _, _ in cases[n_own:]])
        if kernels_own is None:
            log("sharded: the profiler recorded no device activity on the HOOI set and the "
                "MLP products; their device kernels not measured")
        else:
            other = sorted(n for n in kernels_own
                           if not n.removeprefix("void ").startswith(NATIVE_KERNELS))
            check(not other, f"sharded: device kernels {other} besides native_gemm's")
            log(f"sharded: the HOOI set and the MLP products ran native_gemm's kernels only "
                f"({sum(kernels_own.values())} profiler records): {dict(kernels_own)}")
        if kernels_rest is None or kernels_plain is None:
            log("sharded: the profiler recorded no device activity on Table II and the "
                "program; their device kernels not measured")
        else:
            check(set(kernels_rest) <= set(kernels_plain),
                  f"sharded: device kernels {sorted(set(kernels_rest) - set(kernels_plain))} "
                  f"that the unsharded calls do not run")
            log(f"sharded: Table II's and the program's device kernels are among the "
                f"unsharded calls' (profiler records: {sum(kernels_rest.values())} and "
                f"{sum(kernels_plain.values())}): {dict(kernels_rest)}")
        for (label, call, plain, _, _), got in zip(cases, outs):
            want = plain()
            check(torch.equal(got.full_tensor(), want) and torch.equal(got.to_local(), want),
                  f"sharded [{label}]: result differs from the unsharded kernel call")
            n_sh, n_pl = (sum(count_copy_ops(fn).values()) for fn in (call, plain))
            check(n_sh == n_pl, f"sharded [{label}]: {n_sh} copies, unsharded {n_pl}")
            check(n_sh == 0 or label.startswith(("table2", "program")),
                  f"sharded [{label}]: {n_sh} operand copies")
        log(f"sharded: {len(cases)} calls ({n_steps} pairwise steps) bit-identical to the "
            f"unsharded kernel calls (full_tensor and local block); copies equal to the "
            f"unsharded calls' (0 on the HOOI set and the MLP products); native_gemm "
            f"launches {counted['native_gemm']}, one per step, by route {routes}, every "
            f"one on the route native_route gives; grouped_gemm {counted['grouped_gemm']}, "
            f"flash_attention {counted['flash_attention']}")
        for c, n in zip(counters, saved[0]):
            c.launches = n
        native_gemm.launches_by_route = saved[1]

        # every launch shape of the counted run against the plain version
        tot = time_shapes(launches, reps=SHARD_REPS_SHAPES, per="sharded run")
        fb_rows = [r for r in tot["rows"] if r["route"] == "fbatched"]
        fbatched = {k: sum(r[k] for r in fb_rows)
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        # the Grams of HOOI's 512^3 tensor: 512 x 512 outputs over 512 x 512 indices
        gram = [r for r in fb_rows if r["flops"] == 2 * 512 ** 4]
        gram_ms = ", ".join(f"{r['ms']:.4f}" for r in gram)
        gram_lib = ", ".join(f"{r['library_ms']:.4f}" for r in gram)
        log(f"sharded: {len(fb_rows)} of {len(tot['rows'])} launch shapes on fbatched, "
            f"{fbatched['ms']:.4f} ms queued against einsum's {fbatched['library_ms']:.4f}; "
            f"the Grams {', '.join(r['spec'] for r in gram)} {gram_ms} ms (einsum {gram_lib}); "
            f"all {len(tot['rows'])} shapes {tot['ms']:.4f} ms against einsum's "
            f"{tot['library_ms']:.4f}")

        # ms per call on the HOOI set and the MLP products, sharded against
        # unsharded
        calls, hooi = [], dict.fromkeys(("queued", "queued_plain", "call", "call_plain"), 0.0)
        for label, call, plain, _, _ in cases[:n_own]:
            if label.startswith("hooi scatter"):
                continue
            # a call of over 5 ms (two of the HOOI shapes take ~155) gets 3 reps
            reps = SHARD_REPS if cuda_ms(plain, 1) < 5 else 3
            row = dict(label=label, reps=reps, queued=queued_ms(call, reps),
                       queued_plain=queued_ms(plain, reps),
                       call=cuda_ms(call, reps), call_plain=cuda_ms(plain, reps))
            calls.append(row)
            if label.startswith("hooi"):
                for k in hooi:
                    hooi[k] += row[k]
            log(f"sharded ms [{label}]: {row['queued']:.4f} queued vs unsharded "
                f"{row['queued_plain']:.4f}; back to back by events {row['call']:.4f} vs "
                f"{row['call_plain']:.4f} (+{row['call'] - row['call_plain']:.4f} ms a call)")
        n_hooi = sum(r["label"].startswith("hooi") for r in calls)
        overhead = (hooi["call"] - hooi["call_plain"]) / n_hooi
        log(f"sharded ms over the {n_hooi} HOOI calls: queued {hooi['queued']:.4f} vs "
            f"{hooi['queued_plain']:.4f}; back to back by events {hooi['call']:.4f} vs "
            f"{hooi['call_plain']:.4f}; {overhead:.4f} ms a call of planning and DTensor "
            f"wrapping (no collective on a one-rank mesh)")
        return dict(launches=counted["native_gemm"], launches_by_route=routes,
                    calls=len(cases), steps=n_steps, hooi_ms=hooi,
                    overhead_ms_per_call=overhead, calls_ms=calls,
                    shapes={k: tot[k] for k in ("ms", "library_ms", "bound_ms", "plain_ms",
                                                "max_abs_err", "bound_by")},
                    fbatched=dict(fbatched, launches=routes["fbatched"], shapes=len(fb_rows),
                                  gram_ms=[r["ms"] for r in gram],
                                  gram_library_ms=[r["library_ms"] for r in gram]))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ phase 19
#: Table II's extents for phase 19 (the counted run first), and Fig. 3's
#: (benchmarks/fig3_conventional_vs_sb.py ``SIZES``); n = 64's set, which
#: Fig. 3's n = 64 case and ``tools/f32_times.py`` also time, is not run
TABLE2_SIZES = (256,)
FIG3_SIZES = (16, 32, 64, 128, 256)
TABLE2_REPS = 20


def f32_products(dev, seed: int, counters) -> dict:
    """Phase 19: the paper's experiment on the fbatched route.  The 36
    float32 Table II cases at n = 256 through ``contract(strategy=
    "native")`` with every kernel's count set to 0 just before and read
    just after (36 ``native_gemm`` launches, all fbatched); then each case
    at ``TABLE2_SIZES``, and Fig. 3's case 1.3 (``strategy="batched"``, as
    the benchmark runs it) at n = 16 to 256: its route, two launches
    bit-identical, its error against ``native_gemm_ref`` within ``TOL``,
    and queued ms of the kernel, of the conventional baseline
    (``strategy="conventional"``: copies and a flat ``torch.matmul``), of
    one ``torch.einsum`` (TF32 off) and of the plain version, against the
    bound.  Returns the counted run's launches and the sums of its times,
    and every row."""
    from repro_torch.core.contract import contract
    from repro_torch.core.table2 import CASES
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    gen = torch.Generator(device=dev).manual_seed(seed + 19)

    def operands(spec, n):
        a, b, _ = modes_of(spec)
        return (torch.randn([n] * len(a), device=dev, generator=gen),
                torch.randn([n] * len(b), device=dev, generator=gen))

    labels = sorted(CASES)
    counted = {n: [(l, CASES[l].row_major(), *operands(CASES[l].row_major(), n)) for l in labels]
               for n in TABLE2_SIZES}
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with native_routes_held() as held:
        outs = [contract(spec, A, B, strategy="native", backend="kernel")
                for _, spec, A, B in counted[TABLE2_SIZES[0]]]
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    check(launches["native_gemm"] == len(labels) and routes["fbatched"] == len(labels)
          and launches["grouped_gemm"] == launches["flash_attention"] == 0,
          f"table2 f32: launches {launches}, routes {routes}, held {held}")
    for (label, spec, A, B), got in zip(counted[TABLE2_SIZES[0]], outs):
        a, b, c = modes_of(spec)
        err = rel_err(got, native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c))
        check(err <= TOL[torch.float32], f"table2 f32 {label} {spec}: error {err}")
    del outs
    saved = launches["native_gemm"], routes

    def row(label, spec, A, B, strategy):
        a, b, c = modes_of(spec)
        kw = dict(a_modes=a, b_modes=b, c_modes=c)
        if strategy == "native":
            route = native_route(A, B, **kw)
            call = lambda: native_gemm(A, B, **kw)   # noqa: E731
        else:
            with native_routes_held() as tally:
                contract(spec, A, B, strategy=strategy, backend="kernel")
            route = "+".join(r for r, k in tally.items() if k)
            call = lambda: contract(spec, A, B, strategy=strategy, backend="kernel")  # noqa: E731
        got, again = call(), call()
        want = native_gemm_ref(A, B, **kw)
        check(torch.equal(got, again), f"table2 f32 {label} {spec}: two launches differ")
        err = rel_err(got, want)
        check(err <= TOL[torch.float32], f"table2 f32 {label} {spec}: error {err}")
        nb, fl = launch_cost(A, B, kw)
        b_ms, by = bound(nb, fl, torch.float32)
        r = dict(label=label, spec=spec, n=A.shape[0], route=route, strategy=strategy,
                 max_abs_err=(got - want).abs().max().item(), bound_ms=b_ms, bound_by=by,
                 bytes=nb, flops=fl,
                 ms=queued_ms(call, TABLE2_REPS),
                 conventional_ms=queued_ms(lambda: contract(spec, A, B, strategy="conventional",
                                                            backend="torch"), TABLE2_REPS),
                 library_ms=queued_ms(lambda: torch.einsum(spec, A, B), TABLE2_REPS),
                 plain_ms=queued_ms(lambda: native_gemm_ref(A, B, **kw), TABLE2_REPS))
        log(f"table2 f32 [{label} {spec} n={r['n']} {strategy}] {route}: kernel {r['ms']:.4f} "
            f"ms queued, {100 * b_ms / r['ms']:.1f}% of bound {b_ms:.4f} ({by}); conventional "
            f"{r['conventional_ms']:.4f}; einsum {r['library_ms']:.4f} "
            f"({r['library_ms'] / r['ms']:.2f}x the kernel's time); plain {r['plain_ms']:.4f}; "
            f"error {err:.2e}, two launches bit-identical")
        return r

    rows = [row(l, spec, A, B, "native") for n in TABLE2_SIZES for l, spec, A, B in counted[n]]
    del counted
    fig3 = CASES["1.3"].row_major()
    rows += [row("1.3", fig3, *operands(fig3, n), "batched") for n in FIG3_SIZES]
    native_gemm.launches, native_gemm.launches_by_route = saved
    for c in counters:
        if c is not native_gemm:
            c.launches = 0
    sums = {}
    for n in TABLE2_SIZES:
        part = [r for r in rows if r["n"] == n and r["strategy"] == "native"]
        tot = {k: sum(r[k] for r in part)
               for k in ("ms", "conventional_ms", "library_ms", "plain_ms", "bound_ms", "bytes",
                         "flops")}
        tot["bound_by"] = bound(tot["bytes"], tot["flops"], torch.float32)[1]
        slower = [r["label"] for r in part if r["ms"] > r["library_ms"]]
        below = [r["label"] for r in part if r["bound_ms"] < 0.5 * r["ms"]]
        log(f"table2 f32 n={n}: 36 cases on {sorted({r['route'] for r in part})}, kernel "
            f"{tot['ms']:.4f} ms queued in all, bound {tot['bound_ms']:.4f}, conventional "
            f"{tot['conventional_ms']:.4f}, einsum {tot['library_ms']:.4f}, plain "
            f"{tot['plain_ms']:.4f}; slower than einsum: {slower or 'none'}; below half "
            f"their bound: {below or 'none'}")
        sums[n] = tot
    big = sums[TABLE2_SIZES[0]]
    return dict(launches=saved[0], launches_by_route=saved[1],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                bound_by=big["bound_by"], ms=big["ms"], plain_ms=big["plain_ms"],
                library_ms=big["library_ms"], bound_ms=big["bound_ms"],
                conventional_ms=big["conventional_ms"], sums=sums, rows=rows)


# ------------------------------------------------------------------ phase 20
#: phase 20's extent besides RAGGED_DIMS: the mixed set (A bf16, B
#: float32) at n = MIXED_N; the bf16 set at n = 255, which
#: ``tools/former_generic_times.py`` times, is not run (the ragged set
#: takes the same route with every stride odd too)
MIXED_N = 256
FORMER_REPS = 10
#: the rows of the launches in which a gathered product's rows must keep
#: their bits
GATHER_ROWS = (1, 64, 1000)


def former_generic(dev, seed: int, counters) -> dict:
    """Phase 20: the products the retired ``generic`` route took, on their
    new routes.  (a) The 36 bf16 Table II cases at ``RAGGED_DIMS`` and the
    36 with A bf16 and B float32 at n = ``MIXED_N`` through
    ``contract(strategy="native")``, with every kernel's count set to 0
    just before and read just after: 72 ``native_gemm`` launches, 36
    ``gathered`` and 36 ``fbatched``, each within ``TOL`` of
    ``native_gemm_ref``.  (b) Both sets again on integer-valued operands:
    bit-identical to ``native_gemm_ref``.  (c) Each case of both sets,
    bf16 at ``RAGGED_DIMS`` and mixed at n = ``MIXED_N``: its route, two launches bit-identical, its error within
    ``TOL``, and queued ms of the kernel, of one ``torch.einsum`` on the
    same operands (the mixed set: ``torch.einsum`` of A cast to float32
    and B, the cast included, since no one call takes mixed operands) and
    of the plain version, against the bound (bf16 peaks for the bf16 sets;
    the FMA peak for the mixed set, whose products are float32).  (d) A
    gathered product's rows in launches of ``GATHER_ROWS`` rows, bit for
    bit.  Returns the counted run's launches and each set's sums and rows."""
    from repro_torch.core.contract import contract
    from repro_torch.core.table2 import CASES
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    labels = sorted(CASES)
    bf, f32 = torch.bfloat16, torch.float32
    sets = {"bf16 ragged": (RAGGED_DIMS, bf, bf, "gathered"),
            f"mixed n={MIXED_N}": (dict.fromkeys("mnpk", MIXED_N), bf, f32, "fbatched")}
    counted_sets = tuple(sets)

    def operands(spec, dims, a_dt, b_dt, ints=False):
        a, b, _ = modes_of(spec)

        def make(modes, dt):
            shape = [dims[m] for m in modes]
            t = (torch.randint(-3, 4, shape, device=dev, generator=gen).float() if ints
                 else torch.randn(shape, device=dev, generator=gen))
            return t.to(dt)

        return make(a, a_dt), make(b, b_dt)

    # (a) the counted run, then (b) exactness on integer-valued operands
    for ints in (False, True):
        cases = [(name, l, CASES[l].row_major(),
                  *operands(CASES[l].row_major(), *sets[name][:3], ints=ints))
                 for name in counted_sets for l in labels]
        if not ints:
            for c in counters:
                c.launches = 0
            native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
        with native_routes_held() as held:
            outs = [contract(spec, A, B, strategy="native", backend="kernel")
                    for _, _, spec, A, B in cases]
        torch.cuda.synchronize()
        if not ints:
            launches = {c.__name__: c.launches for c in counters}
            routes = dict(native_gemm.launches_by_route)
            check(launches["native_gemm"] == 2 * len(labels) and routes["gathered"] == len(labels)
                  and routes["fbatched"] == len(labels)
                  and launches["grouped_gemm"] == launches["flash_attention"] == 0,
                  f"former generic: launches {launches}, routes {routes}, held {held}")
        for (name, label, spec, A, B), got in zip(cases, outs):
            a, b, c = modes_of(spec)
            want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c)
            if ints:
                check(torch.equal(got, want),
                      f"former generic {name} {label} {spec}: integer-valued case not "
                      f"bit-identical")
            else:
                err = rel_err(got, want)
                check(err <= TOL[got.dtype], f"former generic {name} {label} {spec}: error {err}")
        del cases, outs
    log(f"former generic: counted run of {2 * len(labels)} launches "
        f"({routes_text(routes)}), each within TOL of native_gemm_ref; the same on "
        f"integer-valued operands bit-identical")

    # (c) each case of each set, timed
    rows = []
    for name, (dims, a_dt, b_dt, want_route) in sets.items():
        mixed = a_dt != b_dt
        for label in labels:
            spec = CASES[label].row_major()
            A, B = operands(spec, dims, a_dt, b_dt)
            a, b, c = modes_of(spec)
            kw = dict(a_modes=a, b_modes=b, c_modes=c)
            route = native_route(A, B, **kw)
            check(route == want_route, f"former generic {name} {label} {spec}: {route}, not "
                                       f"{want_route}")
            before = dict(native_gemm.launches_by_route)
            got, again = native_gemm(A, B, **kw), native_gemm(A, B, **kw)
            torch.cuda.synchronize()
            ran = {r: n - before[r] for r, n in native_gemm.launches_by_route.items()}
            check(ran == {r: 2 * (r == route) for r in ran},
                  f"former generic {name} {label}: launched {ran}")
            check(torch.equal(got, again), f"former generic {name} {label}: two launches differ")
            want = native_gemm_ref(A, B, **kw)
            err = rel_err(got, want)
            check(err <= TOL[got.dtype], f"former generic {name} {label} {spec}: error {err}")
            nb, fl = launch_cost(A, B, kw)
            b_ms, by = bound(nb, fl, f32 if mixed else bf)
            lib = ((lambda: torch.einsum(spec, A.float(), B)) if mixed  # noqa: E731
                   else (lambda: torch.einsum(spec, A, B)))
            r = dict(set=name, label=label, spec=spec, route=route, bytes=nb, flops=fl,
                     bound_ms=b_ms, bound_by=by,
                     max_abs_err=(got.float() - want.float()).abs().max().item(),
                     ms=queued_ms(lambda: native_gemm(A, B, **kw), FORMER_REPS),
                     library_ms=queued_ms(lib, FORMER_REPS),
                     plain_ms=queued_ms(lambda: native_gemm_ref(A, B, **kw), FORMER_REPS))
            log(f"former generic [{name} {label} {spec}] {route}: kernel {r['ms']:.4f} ms "
                f"queued, {100 * b_ms / r['ms']:.1f}% of bound {b_ms:.4f} ({by}); einsum "
                f"{r['library_ms']:.4f} ({r['ms'] / r['library_ms']:.2f}x its time); plain "
                f"{r['plain_ms']:.4f}; error {err:.2e}, two launches bit-identical")
            rows.append(r)
            del A, B, got, again, want
    sums = {}
    for name in sets:
        part = [r for r in rows if r["set"] == name]
        tot = {k: sum(r[k] for r in part)
               for k in ("ms", "library_ms", "plain_ms", "bound_ms", "bytes", "flops")}
        tot["bound_by"] = bound(tot["bytes"], tot["flops"],
                                f32 if name.startswith("mixed") else bf)[1]
        tot["max_abs_err"] = max(r["max_abs_err"] for r in part)
        slow = [r["label"] for r in part if r["ms"] > 2 * r["library_ms"]]
        log(f"former generic {name}: 36 cases on {sorted({r['route'] for r in part})}, kernel "
            f"{tot['ms']:.4f} ms queued in all, bound {tot['bound_ms']:.4f} "
            f"({tot['bound_by']}), einsum {tot['library_ms']:.4f} ({tot['ms'] / tot['library_ms']:.2f}x), "
            f"plain {tot['plain_ms']:.4f}; over twice einsum's time: {slow or 'none'}")
        sums[name] = tot

    # (d) a gathered product's rows in launches of any size: W's rows 1030
    # bytes apart, so no tensor map reads it
    X = torch.randn(max(GATHER_ROWS), 6144, device=dev, generator=gen).to(bf)
    W = torch.randn(6144, 515, device=dev, generator=gen).to(bf)[:, :512]
    kw = dict(a_modes="be", b_modes="ef", c_modes="bf")
    full = native_gemm(X, W, **kw)
    for m in GATHER_ROWS:
        check(native_route(X[:m], W, **kw) == "gathered", f"former generic: {m} rows not gathered")
        part = native_gemm(X[:m], W, **kw)
        check(torch.equal(part, full[:m]),
              f"former generic: rows of a {m}-row gathered launch differ from a "
              f"{max(GATHER_ROWS)}-row one's")
    torch.cuda.synchronize()
    log(f"former generic: a gathered product's rows bit-identical in launches of "
        f"{', '.join(map(str, GATHER_ROWS))} rows")
    return dict(launches=launches["native_gemm"], launches_by_route=routes, sums=sums, rows=rows)


# ------------------------------------------------------------------ phase 15
#: device kernel names that mark a library GEMM (cuBLAS, cuBLASLt, CUTLASS)
LIBRARY_GEMM = ("gemm", "xmma", "nvjet", "cutlass", "cublas")
#: the CLIs phase 15 runs on the card, each with its marker line
MESH_CLIS = (
    (["repro_torch.launch.train", "--arch", "minicpm-2b", "--smoke", "--mesh", "1x1",
      "--steps", "3"], "step 3: loss="),
    (["repro_torch.launch.serve", "--arch", "minicpm-2b", "--smoke", "--mesh", "1x1"],
     "served 8 requests"),
)


def step_launches(fn) -> tuple:
    """``fn()``'s result, its ``native_gemm`` launches by route (nonzero
    routes only) and its host ms between synchronisations."""
    from repro_torch.kernels.sb_gemm import native_gemm

    before = dict(native_gemm.launches_by_route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {r: n - before[r] for r, n in native_gemm.launches_by_route.items()
                 if n > before[r]}, ms


def first_difference(named_got, named_want):
    """The first ``(name, got, want)`` whose tensors differ in any bit, or
    ``None``."""
    for (name, got), want in zip(named_got, named_want):
        if not torch.equal(got, want):
            return name, got, want
    return None


def library_gemms(kernels) -> list:
    return sorted(n for n in kernels or () if any(p in n.lower() for p in LIBRARY_GEMM)
                  and not n.removeprefix("void ").startswith(NATIVE_KERNELS))


def mesh_train(dev, mesh, seed: int, counters) -> dict:
    """Phase 15 (a) and (b): minicpm-2b at phase 13's cut on the kernel
    backend, ``Trainer(rules=)`` on ``mesh`` against the unsharded
    ``Trainer``; then the unsharded checkpoint restored onto the mesh."""
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules, device_put, use_rules
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.launch.shardings import (
        batch_logical_axes, param_logical_axes, tree_shardings,
    )
    from repro_torch.models import transformer
    from repro_torch.models.tree import tree_leaves, tree_leaves_with_path
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, Trainer, value_and_grad

    periods = TRAIN["periods"]
    cfg = get_config(TRAIN["arch"]).with_(n_periods=periods, contract_backend="kernel",
                                          contract_strategy="native")
    rules = ShardingRules(mesh)
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    opt = AdamWConfig(lr=TRAIN["lr"], schedule="wsd", warmup_steps=TRAIN["warmup"],
                      total_steps=TRAIN["total_steps"])

    def data():
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                           global_batch=TRAIN["batch"], seed=seed)

    per_step = train_launches_per_step(periods)
    # placing the params is views of the global values: no allocation
    # (earlier phases' garbage is collected first, so nothing frees meanwhile)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    p_sh = tree_shardings(rules, param_logical_axes(params), params)
    placed = device_put(params, p_sh)
    grew = torch.cuda.memory_allocated(dev) - before
    check(grew == 0, f"mesh train: placing the params allocated {grew} bytes")
    check(all(isinstance(p, DTensor) for p in tree_leaves(placed)),
          "mesh train: a placed leaf is not a DTensor")

    # step 1's loss and gradients, unsharded and sharded, from one batch
    arrays = next(data())
    batch = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    loss_u, _, grads_u = value_and_grad(cfg, params, batch)
    batch_s = device_put(batch, tree_shardings(rules, batch_logical_axes(batch), batch))
    with use_rules(rules):
        loss_s, _, grads_s = value_and_grad(cfg, placed, batch_s)
    named = [("loss", loss_s.full_tensor())] + [
        ("/".join(map(str, p)), g.full_tensor()) for p, g in tree_leaves_with_path(grads_s)]
    diff = first_difference(named, [loss_u] + tree_leaves(grads_u))
    if diff is None:
        log(f"mesh train: step 1's loss {float(loss_u):.6f} and all {len(named) - 1} "
            f"gradient leaves bit-identical to the unsharded step's")
        deviation = None
    else:
        name, got, want = diff
        err = rel_err(got, want)
        check(err <= TOL[torch.float32], f"mesh train: {name} differs from the unsharded "
                                         f"step's by {err:.3g} of its largest magnitude")
        deviation = dict(leaf=name, rel_err=err)
        log(f"mesh train: step 1 NOT bit-identical: first leaf that differs is {name}, "
            f"{err:.3g} of its largest magnitude (limit {TOL[torch.float32]:g})")
    del grads_u, grads_s, named, placed

    # the main path: counts to 0 just before the sharded trainer's steps;
    # the unsharded trainer's steps run between them, in turns
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tu = Trainer(cfg, TrainConfig(opt=opt, ckpt_dir=ckpt_dir, ckpt_every=10**9), params,
                     data())
        ts = Trainer(cfg, TrainConfig(opt=opt), params, data(), rules=rules)
        for c in counters:
            c.launches = 0
        native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
        runs = {"sharded": [], "unsharded": []}
        recorded = {"sharded": {}, "unsharded": {}}
        TC_UNITS["mesh train"] = (4, "step")
        with native_routes_held("mesh train") as held:
            for which in ("unsharded", "sharded", "sharded", "unsharded"):
                tr = ts if which == "sharded" else tu
                torch.cuda.reset_peak_memory_stats(dev)
                with recording_launches() as launches:
                    (hist,), by_route, ms = step_launches(lambda tr=tr: tr.run(1))
                recorded[which].update(launches)
                runs[which].append(dict(loss=hist["loss"], ms=ms, routes=by_route,
                                        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30))
        counted = {c.__name__: c.launches for c in counters}
        routes = dict(native_gemm.launches_by_route)
        check(routes == held, f"mesh train: routes {routes} differ from native_route's {held}")
        check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
              f"mesh train: another kernel launched on the path: {counted}")
        for which, rs in runs.items():
            for i, r in enumerate(rs):
                check(r["routes"] == per_step, f"mesh train: {which} step {i + 1} launched "
                                               f"{r['routes']}, the model gives {per_step}")
        sharded_routes = {r: 2 * n for r, n in per_step.items()}
        losses = {w: [r["loss"] for r in rs] for w, rs in runs.items()}
        if deviation is None:
            check(losses["sharded"] == losses["unsharded"],
                  f"mesh train: sharded losses {losses['sharded']} are not the unsharded "
                  f"{losses['unsharded']}")
        else:
            check(np.allclose(losses["sharded"], losses["unsharded"], rtol=1e-4, atol=0),
                  f"mesh train: losses {losses}")
        for which, rs in runs.items():
            log(f"mesh train [{which}]: losses {', '.join(f'{r['loss']:.6f}' for r in rs)}; "
                f"ms per step {', '.join(f'{r['ms']:.1f}' for r in rs)}; peak "
                f"{', '.join(f'{r['peak_gib']:.2f}' for r in rs)} GiB; native_gemm "
                f"launches by route per step {rs[0]['routes']}")
        log(f"mesh train: {counted['native_gemm']} native_gemm launches in 4 steps "
            f"(2 sharded, 2 unsharded), {sum(per_step.values())} a step by route {per_step} "
            f"in both, every one on the route native_route gives")

        # one profiled step each: the sharded step may run no library GEMM
        profiled = {w: device_kernels(lambda tr=tr: tr.run(1))
                    for w, tr in (("unsharded", tu), ("sharded", ts))}
        if None in profiled.values():
            gemms = None
            log("mesh train: the profiler recorded no device activity; the step's device "
                "kernels not measured")
        else:
            new = sorted(set(profiled["sharded"]) - set(profiled["unsharded"]))
            gemms = library_gemms(new)
            check(not gemms, f"mesh train: the sharded step ran library GEMMs {gemms}")
            log(f"mesh train: device kernels of a sharded step that the unsharded step does "
                f"not run: {new or 'none'}; library GEMMs among them: none")

        # (b) the unsharded checkpoint onto the mesh, and a step from it
        tu.save(force=True)
        tree, _, step = restore_checkpoint(ckpt_dir, None, tu.state_tree(),
                                           shardings=ts.shardings)
        check(step == tu.step, f"mesh restore: step {step}, saved {tu.step}")
        for (path, got), want in zip(tree_leaves_with_path(tree),
                                     tree_leaves(tu.state_tree())):
            check(isinstance(got, DTensor) and got.device.type == dev.type,
                  f"mesh restore: {path} is not a DTensor on {dev.type}")
            check(torch.equal(got.full_tensor(), want), f"mesh restore: {path} differs")
        n_leaves = len(tree_leaves(tree))
        del tree, ts
        tr2 = Trainer(cfg, TrainConfig(opt=opt, ckpt_dir=ckpt_dir), params, data(),
                      rules=rules)
        check(tr2.restore(shardings=tr2.shardings) == tu.step, "mesh restore: wrong step")
        got = tr2.run(1)[0]["loss"]
        want = tu.run(1)[0]["loss"]
        check(got == want if deviation is None else abs(got - want) <= 1e-4 * abs(want),
              f"mesh restore: the restored sharded step's loss {got} vs unsharded {want}")
        log(f"mesh restore: {n_leaves} leaves of the unsharded checkpoint at step {step} "
            f"restored onto the mesh as DTensors on {dev.type}, bit-equal; Trainer.restore(shardings=) "
            f"then stepped to loss {got:.6f} (unsharded {want:.6f})")
        del tr2, tu
    return dict(launches=sum(sharded_routes.values()), launches_by_route=sharded_routes,
                launches_per_step=per_step, deviation=deviation, losses=losses,
                ms_per_step={w: [r["ms"] for r in rs] for w, rs in runs.items()},
                peak_gib={w: [r["peak_gib"] for r in rs] for w, rs in runs.items()},
                library_gemms=gemms, launch_keys=recorded["sharded"],
                plain_keys=recorded["unsharded"])


def mesh_serve(dev, mesh, seed: int, counters, serve_ref: dict) -> dict:
    """Phase 15 (c): internlm2-20b at phase 11's cut and traffic on the
    kernel backend, ``ServingRuntime(mesh=)`` against the unsharded one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import transformer
    from repro_torch.runtime.engine import ServingRuntime, slot_cache

    cfg = get_config(SERVE["arch"]).with_(n_periods=SERVE["periods"],
                                          contract_backend="kernel",
                                          contract_strategy="auto")
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    kw = dict(slots=SERVE["slots"], max_len=SERVE["max_len"], prefill_chunk=SERVE["chunk"])
    try:
        ServingRuntime(cfg, params, paged=True, mesh=mesh, **kw)
    except NotImplementedError as e:
        log(f"mesh serve: paged=True with mesh= raises: {e}")
    else:
        check(False, "mesh serve: paged=True with mesh= did not raise")
    t0 = time.perf_counter()
    rts = ServingRuntime(cfg, params, mesh=mesh, **kw)
    torch.cuda.synchronize()
    log(f"mesh serve: sharded runtime built and warmed in {time.perf_counter() - t0:.2f} s "
        f"({rts.program_stats})")
    warm = {"sharded warm-up": serve_traffic(cfg, seed), "unsharded": serve_traffic(cfg, seed)}
    rts.serve(warm["sharded warm-up"])
    rt = ServingRuntime(cfg, params, **kw)
    with recording_launches() as plain_launches:
        rt.serve(warm["unsharded"])
    for which, reqs in warm.items():
        check([list(r.output) for r in reqs] == serve_ref["outputs"],
              f"mesh serve: the {which} serve's tokens differ from phase 11's unpaged kernel "
              f"serve")

    # the main path: counts to 0 just before, read just after
    traffic = serve_traffic(cfg, seed)
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with recording_launches() as launches, native_routes_held("mesh serve") as held:
        rts.serve(traffic)
        torch.cuda.synchronize()
    TC_UNITS["mesh serve"] = (1, "serve")
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    outputs = [list(r.output) for r in traffic]
    check(outputs == serve_ref["outputs"], "mesh serve: tokens differ from phase 11's "
                                           "unpaged kernel serve")
    check(routes == held and counted["native_gemm"] == serve_ref["launches"]
          and routes == serve_ref["launches_by_route"],
          f"mesh serve: launches {counted['native_gemm']} by route {routes}; phase 11 "
          f"{serve_ref['launches']} by route {serve_ref['launches_by_route']}")
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"mesh serve: another kernel launched on the path: {counted}")
    log(f"mesh serve: {len(traffic)} requests, {sum(map(len, outputs))} tokens equal to phase "
        f"11's unpaged kernel serve; native_gemm launches {counted['native_gemm']} by route "
        f"{routes}, as phase 11's, each on the route native_route gives")
    saved = [c.launches for c in counters], dict(routes)

    # what the mesh route costs a decode pass, sharded against unsharded
    scratch = {w: r._place_cache(slot_cache(cfg, SERVE["slots"], SERVE["max_len"], device=dev))
               for w, r in (("unsharded", rt), ("sharded", rts))}
    toks = torch.zeros((SERVE["slots"], 1), dtype=torch.long, device=dev)
    profiles = {}
    with torch.no_grad():
        for which, r in (("unsharded", rt), ("sharded", rts)):
            def one(r=r, which=which):
                with r._mesh_ctx():
                    r._decode(r.params, scratch[which], toks)
            one()
            profiles[which] = profile_device(f"one decode pass [{which}]", one, top=6)
    for c, n in zip(counters, saved[0]):
        c.launches = n
    native_gemm.launches_by_route = saved[1]
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                profiles=profiles, launch_keys=launches, plain_keys=plain_launches)


def mesh_clis(dev) -> dict:
    """Phase 15 (d): the launchers with ``--mesh 1x1`` in subprocesses on
    the card, all started at once (each world of one rendezvouses in its
    own process); seconds from the start to each one's exit.  Every
    subprocess is stopped before this returns or raises."""
    import os

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    secs = {}
    t0 = time.perf_counter()
    procs = [(args, marker, subprocess.Popen(
                [sys.executable, "-m", *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, stdin=subprocess.DEVNULL))
             for args, marker in MESH_CLIS]
    try:
        for args, marker, proc in procs:
            out, err = proc.communicate(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
            secs[args[0]] = time.perf_counter() - t0
            check(proc.returncode == 0 and marker in out and "mesh: 1x1" in out,
                  f"mesh cli {' '.join(args)}: exit {proc.returncode}\n{out[-2000:]}\n"
                  f"{err[-4000:]}")
            log(f"mesh cli: python -m {' '.join(args)} exited 0 in {secs[args[0]]:.1f} s "
                f"({marker!r} in its output)")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return secs


# ------------------------------------------------------------------ phase 16
#: qwen2-moe-a2.7b (src/repro/configs/qwen2_moe_a2p7b.py) with
#: moe_impl="a2a": the layer over ``tokens`` tokens (and again at
#: ``no_drop_cf``, where neither it nor GShard drops a token), and training
#: at published widths with the depth cut to ``periods`` layers
A2A = dict(arch="qwen2-moe-a2.7b", tokens=4096, no_drop_cf=2.0, reps=10, periods=2,
           seq_len=512, batch=4, steps=3, ckpt_at=2, lr=1e-3, warmup=1, total_steps=8,
           timed_steps=1)
#: one internlm2-20b block (src/repro/configs/internlm2_20b.py) as the
#: stage of a one-rank pipeline: ``n_micro`` microbatches of ``tokens``
PIPE = dict(arch="internlm2-20b", n_micro=4, tokens=512)


@contextlib.contextmanager
def plain_native():
    """Within the block every ``native_gemm`` call through ``kernels.ops``
    runs its plain version ``native_gemm_ref`` on the same operands."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    real = ops.native_gemm

    def plain(A, B, **kw):
        return native_gemm_ref(A, B, a_modes=kw["a_modes"], b_modes=kw["b_modes"],
                               c_modes=kw["c_modes"], out_dtype=kw.get("out_dtype"))

    ops.native_gemm = plain
    try:
        yield
    finally:
        ops.native_gemm = real


def expert_launches(launches) -> dict:
    """The recorded launches of the expert products and their backward:
    the expert mode ``x`` is in A, B and C."""
    return {k: v for k, v in launches.items() if all("x" in m for m in k[:3])}


@contextlib.contextmanager
def counting_expert_launches():
    """Within the block, ``native_gemm`` launches (through ``kernels.ops``)
    of the expert products and their backward are counted in the yielded
    list's one entry; no operand is kept."""
    from repro_torch.kernels import ops

    real = ops.native_gemm
    count = [0]

    def counting(A, B, **kw):
        out = real(A, B, **kw)
        if out.numel() and all("x" in kw[m] for m in ("a_modes", "b_modes", "c_modes")):
            count[0] += 1
        return out

    ops.native_gemm = counting
    try:
        yield count
    finally:
        ops.native_gemm = real


@contextlib.contextmanager
def recording_launch_keys():
    """Within the block, every ``native_gemm`` launch through
    ``kernels.ops`` is counted by its modes, shapes, strides, storage
    offsets, types and options; yields ``{key: [launches, layout]}``, the
    ``layout`` for :func:`operands_like`.  No operand is kept."""
    from repro_torch.kernels import ops

    keys: dict = {}
    real = ops.native_gemm

    def recording(A, B, **kw):
        out = real(A, B, **kw)
        if out.numel():         # an empty output launches nothing
            key, layout = layout_key(A, B, kw)
            keys.setdefault(key, [0, layout])[0] += 1
        return out

    ops.native_gemm = recording
    try:
        yield keys
    finally:
        ops.native_gemm = real


def operands_like(layout, gen, dev) -> tuple:
    """Normal random operands from ``gen`` laid out as a recorded launch's
    (shapes, strides, storage offsets and types), and its options."""
    (a, b), kw = layout

    def one(shape, stride, offset, dtype):
        span = offset + 1 + (sum((n - 1) * st for n, st in zip(shape, stride)) if all(shape)
                             else 0)
        flat = torch.randn(span, generator=gen, device=dev).to(dtype)
        return flat.as_strided(shape, stride, offset)

    return one(*a), one(*b), kw


def a2a_launches_per_step(cfg) -> dict:
    """``native_gemm`` launches of one MoE train step under
    ``moe_impl="a2a"`` on a mesh of one, by route: a layer's forward makes
    the dense products q, k, v, o and each shared expert's (3 for swiglu:
    16 for qwen2-moe-a2.7b's 4), on ``wgmma``, and the batched ones,
    scores, P.V and the expert products (3), on ``batched``; the LM head is
    dense; remat recomputes the layers; each product's backward launches
    two (a dense dX and its dW, whose b and s fuse, on ``wgmma``, every
    batched product's both on ``batched``)."""
    mlp = 3 if cfg.mlp_act == "swiglu" else 2
    dense = (4 + mlp * cfg.moe.n_shared) * cfg.n_periods + 1
    batched = (2 + mlp) * cfg.n_periods
    return {"wgmma": dense + (dense - 1) + 2 * dense,
            "batched": batched + batched + 2 * batched}


@contextlib.contextmanager
def routing(record: list | None = None, replay: list | None = None):
    """Within the block ``models.moe.top_k`` appends the expert indices it
    picks to ``record``, or (``replay``) returns the ones recorded, call
    by call, with its input's values at them (a DTensor input is the
    router statistics' pass, whose values go unused)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import moe

    real = moe.top_k
    calls = iter(replay) if replay is not None else None

    def top_k(x, k):
        values, idx = real(x, k)
        if calls is None:
            if record is not None:
                record.append(idx)
            return values, idx
        idx = next(calls)
        return (values if isinstance(x, DTensor) else torch.gather(x, -1, idx)), idx

    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = real


def a2a_layer(dev, mesh, seed: int, counters) -> dict:
    """Phase 16 (a): one ``moe_ffn`` with a2a at full width under the rules
    of ``mesh``, on the kernel backend (see the module docstring)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.contract import as_dtensor
    from repro_torch.distributed.sharding import ShardingRules, device_put
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route
    from repro_torch.launch.shardings import param_logical_axes, tree_shardings
    from repro_torch.models.layers import mesh_scope
    from repro_torch.models.moe import init_moe, moe_ffn, top_k

    T, reps, cf = A2A["tokens"], A2A["reps"], A2A["no_drop_cf"]
    cfg = get_config(A2A["arch"]).with_(moe_impl="a2a", contract_backend="kernel",
                                        contract_strategy="native")
    m = cfg.moe
    rules = ShardingRules(mesh)
    gen = torch.Generator(dev).manual_seed(seed)
    params = init_moe(gen, cfg)
    x = torch.randn((T // 512, 512, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    tree = {"moe": params}
    placed = device_put(tree, tree_shardings(rules, param_logical_axes(tree), tree))["moe"]
    xs = as_dtensor(x, rules.physical(("batch", "seq_sharded", None)), mesh)
    D = mesh.size()
    Xloc = -(-m.n_experts // D)
    cap = max(int(T // D * m.top_k / D * m.capacity_factor) + 1, 1)
    log(f"a2a layer: {cfg.arch_id} d_model {cfg.d_model}, {m.n_experts} experts top-{m.top_k} "
        f"of {m.d_expert}, {m.n_shared} shared of {m.d_shared}; {T} tokens in bf16 over "
        f"{D} rank(s): cap {cap}, C2 {cap * D // Xloc} at capacity factor "
        f"{m.capacity_factor}; kernel backend, contract_strategy native")

    def layer(c=cfg):
        with mesh_scope(rules), torch.no_grad():
            y, _ = moe_ffn(c, placed, xs)
        return y.full_tensor()

    layer()
    # the main path: counts to 0 just before, read just after
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with recording_launches() as launches, native_routes_held("a2a layer") as held:
        y = layer()
        torch.cuda.synchronize()
    TC_UNITS["a2a layer"] = (1, "layer")
    counted = {c.__name__: c.launches for c in counters}
    routes = {r: n for r, n in native_gemm.launches_by_route.items() if n}
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"a2a layer: another kernel launched on the path: {counted}")
    check(routes == {r: n for r, n in held.items() if n},
          f"a2a layer: routes {routes} differ from native_route's {held}")
    experts = expert_launches(launches)
    n_expert = sum(n for n, _ in experts.values())
    expert_routes = Counter()
    for n, (A, B, kw) in experts.values():
        expert_routes[native_route(A, B, a_modes=kw["a_modes"], b_modes=kw["b_modes"],
                                   c_modes=kw["c_modes"])] += n
    check(n_expert == 3 and expert_routes == {"batched": 3},
          f"a2a layer: the expert products launched {n_expert} by route "
          f"{dict(expert_routes)}, not 3 on batched")
    check(bool(torch.isfinite(y).all()) and tuple(y.shape) == tuple(x.shape),
          "a2a layer: the output is not finite or not of the input's shape")
    saved = [c.launches for c in counters], dict(native_gemm.launches_by_route)

    with plain_native():
        y_plain = layer()
    err_plain = rel_err(y, y_plain)
    check(err_plain <= TOL[torch.bfloat16], f"a2a layer: {err_plain:.3g} from the same call "
                                            f"on native_gemm_ref (limit {TOL[torch.bfloat16]})")

    # GShard on the same weights at a factor where neither path drops
    cfg_nd = cfg.with_(moe=dataclasses.replace(m, capacity_factor=cf))
    with torch.no_grad():
        gates = torch.softmax(x.reshape(T, -1).float() @ params["router"], dim=-1)
        most = int(torch.bincount(top_k(gates, m.top_k)[1].reshape(-1),
                                  minlength=m.n_experts).max())
        cap_nd = max(int(T // D * m.top_k / D * cf) + 1, 1)
        c2_nd = cap_nd * D // Xloc
        c_gshard = max(int(cf * m.top_k * min(T, 4096) / m.n_experts) + 1, 4)
        check(D == 1 and most <= min(c2_nd, c_gshard),
              f"a2a layer: the busiest expert takes {most} tokens; C2 {c2_nd}, GShard "
              f"capacity {c_gshard} at factor {cf} on {D} rank(s)")
        y_a2a = layer(cfg_nd)
        y_gshard = moe_ffn(cfg_nd, params, x)[0]
    err_gshard = rel_err(y_a2a, y_gshard)
    check(err_gshard <= TOL[torch.bfloat16],
          f"a2a layer: {err_gshard:.3g} from GShard where neither drops (limit "
          f"{TOL[torch.bfloat16]})")
    del gates, y_a2a, y_gshard, y_plain
    log(f"a2a layer: output finite, {err_plain:.3g} of its largest magnitude from the same "
        f"call on native_gemm_ref, {err_gshard:.3g} from the GShard path at capacity factor "
        f"{cf} (busiest expert {most} tokens; C2 {c2_nd}, GShard capacity {c_gshard}: "
        f"neither drops); native_gemm launches {counted['native_gemm']} by route {routes}, "
        f"the expert products 3 on batched")

    # each expert product: kernel (queued) against one torch.bmm and its bound
    products, worst = [], 0.0
    for (a, b, c, *_), (n, (A, B, kw)) in sorted(experts.items(), key=lambda i: i[0][:3]):
        spec = f"{a},{b}->{c}"
        check(spec in ("xce,xef->xcf", "xcf,xfe->xce"), f"a2a layer: expert product {spec}")
        got, again = native_gemm(A, B, **kw), native_gemm(A, B, **kw)
        check(torch.equal(got, again), f"a2a layer: two launches of {spec} differ")
        want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c)
        err = rel_err(got, want)
        check(err <= TOL[torch.bfloat16], f"a2a layer: {spec} {err:.3g} from the plain version")
        abs_err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, abs_err)
        lib_err = rel_err(torch.bmm(A, B), want)
        check(lib_err <= TOL[torch.bfloat16], f"a2a layer: torch.bmm is {lib_err:.3g} from "
                                              f"{spec}'s plain version")
        ms = queued_ms(lambda: native_gemm(A, B, **kw), reps)
        plain = cuda_ms(lambda: native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c), reps)
        lib = queued_ms(lambda: torch.bmm(A, B), reps)
        nb, fl = launch_cost(A, B, kw)
        b_ms, by = bound(nb, fl, torch.bfloat16)
        products.append(dict(spec=spec, A=list(A.shape), B=list(B.shape), B_stride=list(B.stride()),
                             launches=n, ms=ms, plain_ms=plain, bmm_ms=lib, bound_ms=b_ms,
                             bound_by=by, max_abs_err=abs_err, rel_err=err))
        log(f"a2a expert product {spec} A{tuple(A.shape)} B{tuple(B.shape)}{B.stride()} x{n} "
            f"[batched] bf16: kernel {ms:.4f} ms queued, bound {b_ms:.4f} ms ({by}), "
            f"{100 * b_ms / ms:.1f}% of bound; torch.bmm {lib:.4f} ms queued "
            f"({ms / lib:.1f}x); plain {plain:.4f} ms; {err:.2e} from the plain version")
    kernels = device_kernels(lambda: [native_gemm(A, B, **kw)
                                      for _, (A, B, kw) in experts.values()])
    if kernels is None:
        gemms = None
        log("a2a layer: the profiler recorded no device activity; the expert products' "
            "device kernels not measured")
    else:
        gemms = library_gemms(kernels)
        others = sorted(k for k in kernels if not k.removeprefix("void ").startswith(
            NATIVE_KERNELS))
        check(not gemms and not others, f"a2a layer: the expert products ran {gemms or others}")
        log(f"a2a layer: the expert products' device kernels {dict(kernels)}; no library GEMM")
    for c, n in zip(counters, saved[0]):
        c.launches = n
    native_gemm.launches_by_route = saved[1]
    return dict(launches=n_expert, launches_by_route=routes, tokens=T,
                rel_err_plain=err_plain, rel_err_gshard=err_gshard, no_drop_cf=cf,
                busiest_expert=most, products=products, max_abs_err=worst,
                ms=sum(p["ms"] * p["launches"] for p in products),
                bmm_ms=sum(p["bmm_ms"] * p["launches"] for p in products),
                bound_ms=sum(p["bound_ms"] * p["launches"] for p in products),
                plain_ms=sum(p["plain_ms"] * p["launches"] for p in products),
                library_gemms=gemms)


def a2a_train(dev, mesh, seed: int, counters) -> dict:
    """Phase 16 (b): qwen2-moe-a2.7b at published widths, 2 layers, with
    a2a, through ``Trainer(rules=)`` on ``mesh`` (see the module
    docstring)."""
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules, device_put, use_rules
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.launch.shardings import (
        batch_logical_axes, opt_state_logical_axes, tree_shardings,
    )
    from repro_torch.models import transformer
    from repro_torch.models.tree import tree_leaves, tree_leaves_with_path
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.trainer import (
        TrainConfig, Trainer, make_train_step, value_and_grad,
    )

    periods, steps, at = A2A["periods"], A2A["steps"], A2A["ckpt_at"]
    full = get_config(A2A["arch"])
    cfg = full.with_(n_periods=periods, moe_impl="a2a", contract_backend="kernel",
                     contract_strategy="native")
    cfg_t = cfg.with_(contract_backend="torch", contract_strategy="auto")
    rules = ShardingRules(mesh)
    log(f"a2a train: {cfg.arch_id} d_model {cfg.d_model}, {cfg.n_heads} heads, vocab "
        f"{cfg.vocab_size}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
        f"{cfg.moe.d_expert} + {cfg.moe.n_shared} shared, moe_impl a2a; {cfg.dtype} "
        f"activations, {cfg.param_dtype} master weights, remat on; depth cut from "
        f"{full.n_periods} layers to {periods} (the one cut); {cfg.param_count() / 1e9:.3f}B "
        f"params; Trainer(rules=) on a {'x'.join(map(str, mesh.shape))} mesh; kernel backend, "
        f"contract_strategy native")
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    opt = AdamWConfig(lr=A2A["lr"], schedule="wsd", warmup_steps=A2A["warmup"],
                      total_steps=A2A["total_steps"])

    def data():
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=A2A["seq_len"],
                           global_batch=A2A["batch"], seed=seed)

    tokens = A2A["seq_len"] * A2A["batch"]
    per_step = a2a_launches_per_step(cfg)
    secs, t0 = {}, time.perf_counter()

    def lap(label):
        nonlocal t0
        secs[label] = time.perf_counter() - t0
        t0 = time.perf_counter()

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainConfig(opt=opt, ckpt_dir=ckpt_dir, ckpt_every=10**9)
        tr = Trainer(cfg, tcfg, params, data(), rules=rules)
        del params  # the trainer's views hold the initial weights until step 1
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the main path: counts to 0 just before, read just after
        for c in counters:
            c.launches = 0
        native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
        hist, by_step = [], []
        TC_UNITS["a2a train"] = (steps, "step")
        with counting_expert_launches() as experts, native_routes_held("a2a train") as held, \
                recording_launch_keys() as keys:
            for _ in range(steps):
                (h,), r, ms = step_launches(lambda: tr.run(1))
                hist.append(dict(h, ms=ms))
                by_step.append(r)
                if tr.step == at:
                    tr.save(force=True)
        counted = {c.__name__: c.launches for c in counters}
        routes = {r: n for r, n in native_gemm.launches_by_route.items() if n}
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [h["loss"] for h in hist]
        check(all(np.isfinite(losses)), f"a2a train: a loss is not finite: {losses}")
        check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
              f"a2a train: another kernel launched on the path: {counted}")
        check(routes == {r: n for r, n in held.items() if n},
              f"a2a train: routes {routes} differ from native_route's {held}")
        check(all(r == per_step for r in by_step),
              f"a2a train: launches by route per step {by_step}, the model gives {per_step}")
        check(sum(n for n, _ in keys.values()) == counted["native_gemm"]
              and all(n % steps == 0 for n, _ in keys.values()),
              "a2a train: the recorded launch shapes do not repeat each step")
        n_expert = experts[0]
        check(n_expert == 12 * periods * steps,
              f"a2a train: {n_expert} expert-product launches in {steps} steps, not 12 a "
              f"layer (3 forward, 3 recomputed, 6 backward)")
        log(f"a2a train: {steps} steps of {A2A['batch']} x {A2A['seq_len']} tokens, losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}; step ms "
            f"{', '.join(f'{h['ms']:.1f}' for h in hist)}; native_gemm launches "
            f"{counted['native_gemm']} ({sum(per_step.values())} a step by route {per_step}, "
            f"{12 * periods} of them the expert products on batched; every one on the route "
            f"native_route gives); peak memory {peak / 2**30:.2f} GiB")
        saved = [c.launches for c in counters], dict(native_gemm.launches_by_route)
        lap("trainer and 3 steps")
        tr2 = Trainer(cfg, tcfg, tr.params, data(), rules=rules)
        del tr
        check(tr2.restore() == at and tr2.step == at and tr2.data.step == at,
              "a2a train: the restart did not resume at the checkpoint's step and cursor")
        again = [h["loss"] for h in tr2.run(steps - at)]
        check(np.allclose(again, losses[at:], rtol=1e-4, atol=0),
              f"a2a train: restarted losses {again} differ from {losses[at:]} beyond rtol 1e-4")
        log(f"a2a train: a fresh Trainer(rules=) restored step {at} and reran step(s) "
            f"{at + 1}-{steps}: losses {', '.join(f'{x:.6f}' for x in again)} (first run "
            f"{', '.join(f'{x:.6f}' for x in losses[at:])}); bit-identical: "
            f"{again == losses[at:]}")
        placed = tr2.params  # step 3's weights, placed by the rules
        del tr2
    lap("checkpoint and restart")

    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data()).items()}
    batch = device_put(batch, tree_shardings(rules, batch_logical_axes(batch), batch))

    def grads_of(c, record=None, replay=None):
        with use_rules(rules), routing(record, replay):
            loss, _, grads = value_and_grad(c, placed, batch)
        return float(loss.full_tensor()), grads

    kernel_routes, torch_routes = [], []
    loss_k, grads_k = grads_of(cfg, record=kernel_routes)
    named_k = [("/".join(map(str, p)), g.full_tensor()) for p, g in tree_leaves_with_path(grads_k)]
    del grads_k
    bad = [n for n, g in named_k if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    check(not bad, f"a2a train: leaves without a finite nonzero gradient: {bad}")

    def against_kernel(grads_t):
        errs = {}
        for (n, gk), gt in zip(named_k, tree_leaves(grads_t)):
            gt = gt.full_tensor().float()
            errs[n] = float((gk.float() - gt).abs().max() / gt.abs().max())
        return errs

    # the torch backend on its own routing: a bf16 rounding apart, some
    # tokens' top-4 differ, and each moves a token between experts
    loss_t, grads_t = grads_of(cfg_t, record=torch_routes)
    free_err = against_kernel(grads_t)
    del grads_t
    flips = [int((a != b).any(dim=-1).sum()) for a, b in zip(kernel_routes, torch_routes)
             if not isinstance(a, DTensor)]
    routed = [a.shape[0] for a in kernel_routes if not isinstance(a, DTensor)]
    free_worst = max(free_err, key=free_err.get)
    log(f"a2a train: the torch backend on its own routing: loss {loss_t:.6f}, worst gradient "
        f"{free_worst} {free_err[free_worst]:.3g} of its largest magnitude; tokens whose "
        f"experts differ from the kernel step's, per a2a call (forward, then remat's "
        f"recompute): {flips} of {routed}")
    # ... and on the kernel step's routing: the products alone differ
    loss_r, grads_r = grads_of(cfg_t, replay=kernel_routes)
    grad_err = against_kernel(grads_r)
    del grads_r, named_k
    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    worst = max(grad_err, key=grad_err.get)
    check(loss_err <= 2e-2, f"a2a train: kernel loss {loss_k} vs torch {loss_r}")
    check(grad_err[worst] <= 5e-2, f"a2a train: gradient of {worst} {grad_err[worst]} of its "
                                   f"largest magnitude from the torch backend's (limit 5e-2)")
    log(f"a2a train: every one of {len(grad_err)} leaves (the expert stacks included) has a "
        f"finite nonzero gradient; one step from step 3's weights, one batch and one routing: loss "
        f"{loss_k:.6f} (kernel) vs {loss_r:.6f} (torch), {loss_err:.3g} apart (limit 2e-2); "
        f"worst gradient {worst} {grad_err[worst]:.3g} of its largest magnitude (limit 5e-2)")
    lap("three gradient passes")

    # ms per step, the two backends in turns, from the same placed state
    state = adamw_init(placed)
    state = device_put(state, tree_shardings(rules, opt_state_logical_axes(placed), state))
    steps_fn = {"kernel": make_train_step(cfg, TrainConfig(opt=opt)),
                "torch": make_train_step(cfg_t, TrainConfig(opt=opt))}

    def one_step(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_rules(rules):
            out = steps_fn[backend](placed, state, batch, None)
        float(out[3]["loss"].full_tensor())
        torch.cuda.synchronize()
        del out
        return (time.perf_counter() - t0) * 1e3

    one_step("torch")
    runs = {"kernel": [], "torch": []}
    for backend in ("kernel", "torch", "torch", "kernel"):
        ms = [one_step(backend) for _ in range(A2A["timed_steps"])]
        runs[backend] += ms
        log(f"a2a train [{backend}]: ms per step {', '.join(f'{m:.1f}' for m in ms)}, "
            f"{tokens / (min(ms) / 1e3):.1f} tokens/s")
    lap("steps in turns")
    profile = profile_device("one a2a train step [kernel]", lambda: one_step("kernel"), top=8)
    del state, placed, steps_fn
    gc.collect()
    torch.cuda.empty_cache()
    lap("profile")

    # every launch shape of one step, on operands laid out as its own,
    # against the plain version and timed as in phase 6
    gen = torch.Generator(dev).manual_seed(seed)
    launches = {k: (n // steps, operands_like(layout, gen, dev))
                for k, (n, layout) in keys.items()}
    shapes = {k: v for k, v in time_shapes(launches, reps=3, per="a2a step").items()
              if k in ("ms", "library_ms", "bound_ms", "plain_ms", "max_abs_err", "bound_by")}
    del launches
    lap("launch shapes held")
    log(f"a2a train: {len(keys)} launch shapes a step held to the plain version; seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    for c, n in zip(counters, saved[0]):
        c.launches = n
    native_gemm.launches_by_route = saved[1]
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                launches_per_step=per_step, expert_launches=n_expert, periods=periods,
                losses=losses, restart_losses=again, peak_gib=peak / 2**30,
                ms_per_step=runs, loss_rel_err_torch=loss_err,
                worst_grad={"leaf": worst, "rel_err": grad_err[worst]},
                own_routing={"loss_torch": loss_t, "leaf": free_worst,
                             "rel_err": free_err[free_worst], "tokens_rerouted": flips,
                             "tokens": routed},
                profile=profile, shapes=dict(shapes, n=len(keys)), seconds=secs)


def pipeline_stage(dev, seed: int, counters) -> dict:
    """Phase 16 (c): ``pipeline_forward`` over a one-rank ``pod`` axis with
    one internlm2-20b block as the stage (see the module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_forward, pipeline_loss
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models.transformer import _block, _init_block
    from repro_torch.models.tree import tree_leaves, tree_map

    cfg = get_config(PIPE["arch"]).with_(contract_backend="kernel", contract_strategy="native")
    spec = cfg.pattern[0]
    n_micro, S = PIPE["n_micro"], PIPE["tokens"]
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
    gen = torch.Generator(dev).manual_seed(seed)
    stacked = _init_block(gen, cfg, spec, lead=(1,))
    x = torch.randn((n_micro, 1, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(S, device=dev)

    def stage_fn(p, xb, stage_idx):
        return _block(cfg, spec, p, xb, positions=pos)[0]

    def sequential(inp):
        one = tree_map(lambda t: t[0], stacked)
        return torch.stack([stage_fn(one, inp[i], 0) for i in range(n_micro)])

    log(f"pipeline: one {cfg.arch_id} block (d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}) as the stage over a one-rank pod axis; "
        f"{n_micro} microbatches of {S} tokens in bf16; kernel backend, native")
    # the main path: counts to 0 just before, read just after
    for c in counters:
        c.launches = 0
    TC_UNITS["pipeline"] = (1, "forward")
    with torch.no_grad(), native_routes_held("pipeline") as held:
        y = pipeline_forward(mesh, stage_fn, stacked, x)
        torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    check(held["gathered"] == 0,
          f"pipeline: bf16 products no tensor map reads: {routes_text(held)}")
    native_gemm.launches = 0
    with torch.no_grad():
        want = sequential(x)
    direct = native_gemm.launches
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"pipeline: another kernel launched on the path: {counted}")
    check(torch.equal(y, want) and counted["native_gemm"] == direct,
          f"pipeline: output bit-identical {torch.equal(y, want)}, launches "
          f"{counted['native_gemm']} against {direct} calling the block directly")

    leaves = tree_leaves(stacked)
    for t in leaves:
        t.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    target = torch.randn(y.shape, generator=gen, device=dev)

    def loss_fn(out, t):
        return (out.float() * t).sum()

    native_gemm.launches = 0
    TC_UNITS["pipeline loss"] = (1, "loss")
    with native_routes_held("pipeline loss") as held_loss:
        loss = pipeline_loss(mesh, stage_fn, stacked, xg, target, loss_fn)
        got = torch.autograd.grad(loss, leaves + [xg])
    n_pipe = native_gemm.launches
    check(held_loss["gathered"] == 0,
          f"pipeline_loss: bf16 products no tensor map reads: {routes_text(held_loss)}")
    native_gemm.launches = 0
    ref_loss = loss_fn(sequential(xg), target)
    ref = torch.autograd.grad(ref_loss, leaves + [xg])
    n_seq = native_gemm.launches
    names = [f"leaf {i}" for i in range(len(leaves))] + ["x"]
    diff = first_difference(list(zip(names, got)), list(ref))
    check(diff is None and torch.equal(loss, ref_loss) and n_pipe == n_seq,
          f"pipeline_loss: loss bit-identical {torch.equal(loss, ref_loss)}; first gradient "
          f"that differs {diff and diff[0]}; launches {n_pipe} against {n_seq} sequentially")
    log(f"pipeline: output bit-identical to the block called on each microbatch, "
        f"{counted['native_gemm']} native_gemm launches in both ({routes_text(held)}); "
        f"pipeline_loss's loss and all {len(got)} gradients bit-identical to the sequential "
        f"run's, {n_pipe} launches in both ({routes_text(held_loss)}); none gathered")
    for t in leaves:
        t.requires_grad_(False)
    del stacked, got, ref
    return dict(launches=counted["native_gemm"], grad_launches=n_pipe, n_micro=n_micro,
                tokens=S)


def a2a_path(dev, mesh, seed: int, counters) -> dict:
    """Phase 16 on phase 15's world and ``("data", "model")`` mesh:
    returns ``native_gemm``'s ``a2a`` and ``pipeline`` records."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"a2a: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated as phase 16 "
        f"starts")
    layer = a2a_layer(dev, mesh, seed, counters)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    train = a2a_train(dev, mesh, seed, counters)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    pipe = pipeline_stage(dev, seed, counters)
    t3 = time.perf_counter()
    log(f"a2a: phase 16 took {t3 - t0:.1f} s: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
        f"(c) {t3 - t2:.1f} s")
    return dict(layer=layer, train=train, pipeline=pipe)


def mesh_path(dev, seed: int, counters, serve_ref: dict) -> dict:
    """Phase 15: the sharded trainer and server on a 1x1 mesh over a new
    world of one (see the module docstring), then phase 16 on that world.
    Returns ``native_gemm``'s ``sharded_train`` and ``sharded_serve``
    records and phase 16's ``a2a`` record."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1, device=dev.type)
    log(f"mesh: world of {dist.get_world_size()} rank over {dist.get_backend()}; mesh {mesh}")
    try:
        train = mesh_train(dev, mesh, seed, counters)
        serve = mesh_serve(dev, mesh, seed, counters, serve_ref)
        # every launch shape the sharded runs made that the unsharded ones
        # did not, against the plain version and timed as in phase 6
        for label, res in (("sharded step", train), ("sharded serve", serve)):
            plain = res.pop("plain_keys")
            new = {k: v for k, v in res.pop("launch_keys").items() if k not in plain}
            if new:
                res["new_shapes"] = {k: v for k, v in time_shapes(
                    new, reps=3, per=label).items()
                    if k in ("ms", "library_ms", "bound_ms", "plain_ms", "max_abs_err")}
            else:
                res["new_shapes"] = None
            log(f"mesh: {len(new)} launch shapes of the {label} that the unsharded runs "
                f"do not launch" + ("" if new else " (every one is held in phases 11/13)"))
        del new, plain  # the recorded operands
        log(f"mesh: phase 15 took {time.perf_counter() - t0:.1f} s before its CLIs")
        a2a = a2a_path(dev, mesh, seed, counters)
    finally:
        dist.destroy_process_group()
    clis = mesh_clis(dev)
    log(f"mesh: phases 15 and 16 took {time.perf_counter() - t0:.1f} s")
    return dict(sharded_train=train, sharded_serve=serve, cli_s=clis, a2a=a2a)


# ------------------------------------------------------------------ phase 18
def tc_shapes_path(dev, seed: int) -> dict:
    """Phase 18: every launch shape of the counted runs of phases 11, 13,
    15 and 16 that takes the batched route or fuses contracted modes
    (:data:`TC_SHAPES`), on normal random operands laid out as the path's
    own, held to the plain version (two launches bit-identical, within
    ``TOL``) and timed as in phase 6 (queued against its bound, the plain
    version and one ``torch.einsum``).  Returns, for each path and each of
    the two kinds (``batched``; ``fused`` for the fused-K ``wgmma``
    launches), the sums per unit of the path (a serve, a step, a layer)
    and every shape's row."""
    gen = torch.Generator(dev).manual_seed(seed + 18)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops")
    per_path, rows, worst = {}, [], 0.0
    for key, rec in sorted(TC_SHAPES.items(), key=lambda kv: str(kv[0])):
        A, B, kw = operands_like(rec["layout"], gen, dev)
        row = time_shapes({key: (1, (A, B, kw))}, reps=5, per="launch",
                          summary=False)["rows"][0]
        del A, B
        kind = "batched" if rec["route"] == "batched" else "fused"
        check(rec["route"] in ("batched", "wgmma"), f"phase 18: {row['spec']} on {rec['route']}")
        worst = max(worst, row["max_abs_err"])
        rows.append(dict(row, kind=kind, k_modes=rec["k_modes"], launches=rec["launches"]))
        for path, n in rec["launches"].items():
            units, unit = TC_UNITS[path]
            tot = per_path.setdefault(path, {}).setdefault(
                kind, dict.fromkeys(keys, 0.0) | dict(launches=0, unit=unit))
            tot["launches"] += n / units
            for k in keys:
                tot[k] += n / units * row[k]
    for path, kinds in per_path.items():
        for kind, tot in kinds.items():
            tot["bound_by"] = bound(tot["bytes"], tot["flops"], torch.bfloat16)[1]
            log(f"phase 18 [{path}] {kind}, per {tot['unit']} ({tot['launches']:g} launches): "
                f"kernel {tot['ms']:.4f} ms queued, bound {tot['bound_ms']:.4f} ms "
                f"({tot['bound_by']}), plain {tot['plain_ms']:.4f} ms, einsum "
                f"{tot['library_ms']:.4f} ms queued")
    log(f"phase 18: {len(rows)} launch shapes ({sum(r['kind'] == 'batched' for r in rows)} "
        f"batched, {sum(r['kind'] == 'fused' for r in rows)} fused-K wgmma) of the counted runs "
        f"of phases 11, 13, 15 and 16, each within TOL of the plain version and bit-identical "
        f"twice (max abs error {worst:.3g})")
    return dict(paths=per_path, rows=rows, max_abs_err=worst)


# ------------------------------------------------------------------ phase 17
#: the dry-run cells of phase 17 (a), (arch, shape, multi_pod), at their
#: published widths with phase 13's depth cut (the one cut)
DRYRUN_CELLS = (("minicpm-2b", "train_4k", False), ("minicpm-2b", "train_4k", True),
                ("internlm2-20b", "decode_32k", False))
DRYRUN_OVERRIDES = {"n_periods": TRAIN["periods"]}
#: phase 17 (a)'s kernel-backend cell, beside the library cell of the same
#: arch, shape and mesh; a training step differentiates the kernel backend
#: through strategy "native"
DRYRUN_KERNEL_CELL = ("minicpm-2b", "train_4k", False)
KERNEL_BACKEND = {"contract_backend": "kernel", "contract_strategy": "native"}
#: the traced peak's largest distance from the measured one, relative
PEAK_TOL = 0.10
#: phase 17 (a)'s training cells' traced peaks per device, in GB, when
#: the loss under rules gathered the vocab and built its gradient at the
#: global (batch, seq, vocab) shape on every rank
GATHERED_LOSS_PEAK_GB = {"minicpm-2b__train_4k__16x16": 612.67,
                         "minicpm-2b__train_4k__2x16x16": 805.66, "kernel": 612.67}


def cell_tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"


def dryrun_launchers(device: str = "cuda") -> dict:
    """Phase 17 (a): ``python -m repro_torch.launch.dryrun`` on each of
    ``DRYRUN_CELLS`` in a subprocess of its own, all at once (fake CUDA
    tensors, or ``device``'s, in a fake world of 256 or 512 ranks), then
    ``launch.roofline`` and ``launch.report`` on their records.  Returns
    each cell's record, roofline row and seconds."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.roofline import roofline_cell

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}

    def run(args, cwd=None):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                              env=env, cwd=cwd, timeout=600, stdin=subprocess.DEVNULL)
        check(proc.returncode == 0, f"dryrun: python -m {' '.join(args)}: exit "
                                    f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                                    f"{proc.stderr[-4000:]}")
        return proc.stdout, time.perf_counter() - t0

    def cell_args(c, over, out_dir):
        return (["repro_torch.launch.dryrun", "--arch", c[0], "--shape", c[1], "--device",
                 device, "--cfg-overrides", json.dumps(over), "--out", str(out_dir)]
                + (["--multi-pod"] if c[2] else []))

    kernel_tag = cell_tag(*DRYRUN_KERNEL_CELL)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "results" / "torch"
        cells = {cell_tag(*c): cell_args(c, DRYRUN_OVERRIDES, out / "dryrun")
                 for c in DRYRUN_CELLS}
        # the kernel-backend cell writes elsewhere: launch.roofline and
        # launch.report read one record a cell from results/torch/dryrun
        cells["kernel"] = cell_args(DRYRUN_KERNEL_CELL, {**DRYRUN_OVERRIDES, **KERNEL_BACKEND},
                                    out / "dryrun_kernel")
        with ThreadPoolExecutor(len(cells)) as pool:
            ran = dict(zip(cells, pool.map(run, cells.values())))
        records, rows, secs = {}, {}, {}
        for tag in cells:
            where = out / "dryrun" / f"{tag}.json"
            if tag == "kernel":
                where = out / "dryrun_kernel" / f"{kernel_tag}.json"
            with open(where) as f:
                records[tag] = rec = json.load(f)
            secs[tag] = ran[tag][1]
            check(rec["status"] == "ok", f"dryrun: {tag} is not ok: {rec}")
            rows[tag] = roofline_cell(rec["arch"], rec["shape"], rec)
        text, roof_s = run(["repro_torch.launch.roofline", "--dryrun-dir", str(out / "dryrun"),
                            "--out", str(out / "roofline.json")])
        with open(out / "roofline.json") as f:
            single = {cell_tag(r["arch"], r["shape"], False): r for r in json.load(f)}
        check(single == {t: r for t, r in rows.items() if t.endswith("__16x16")},
              f"dryrun: launch.roofline's rows {single} differ from roofline_cell's")
        report, report_s = run(["repro_torch.launch.report"], cwd=tmp)
        check(all(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok |" in report
                  for t, r in records.items() if t != "kernel"),
              f"dryrun: the report lacks a cell:\n{report}")
    for tag, rec in records.items():
        log(f"dryrun: {tag} in {secs[tag]:.1f} s: {json.dumps(rec)}")
        log(f"dryrun: {tag} roofline (H100 ceilings): {json.dumps(rows[tag])}")
    log(f"dryrun: launch.roofline {roof_s:.1f} s, launch.report {report_s:.1f} s; the "
        f"report:\n{report}")
    grad_sync = records[cell_tag("minicpm-2b", "train_4k", False)]["collective_bytes"]
    check(grad_sync["all-reduce"] + grad_sync["reduce-scatter"] > 0,
          f"dryrun: the 16x16 train cell sums no gradient over its data axis: {grad_sync}")
    kernel_vs_library(records["kernel"], records[kernel_tag], rows["kernel"], rows[kernel_tag])
    vocab_parallel_peaks(records)
    return dict(records=records, roofline=rows, seconds=secs)


def vocab_parallel_peaks(records: dict) -> None:
    """Phase 17 (a)'s training cells under the vocab-parallel loss: no
    storage live at the traced peak has the vocab as its last dim, and each
    peak per device is printed beside the gathered loss's, with the card."""
    from repro_torch.configs import get_config

    card = device_line()
    for tag, before in GATHERED_LOSS_PEAK_GB.items():
        rec = records[tag]
        vocab = get_config(rec["arch"]).vocab_size
        wide = [e for e in rec["peak_live"] if e["shape"][-1] == vocab]
        check(not wide, f"dryrun: {tag} holds the vocab's full width at its peak: {wide}")
        peak = rec["peak_bytes_per_device"]
        log(f"dryrun: {tag} traced peak {peak / 1e9:.2f} GB a device ({peak} bytes) against "
            f"{before:.2f} GB with the loss gathering the vocab ({peak / 1e9 / before:.4f}x); "
            f"no storage of vocab width ({vocab}) at the peak; {card}")


def kernel_vs_library(kern: dict, lib: dict, kern_row: dict, lib_row: dict) -> None:
    """Phase 17 (a)'s kernel-backend cell against the library cell of the
    same arch, shape and mesh: 147 ``repro_torch.native_gemm`` ops at 4
    layers (9 a layer and the head, remat, 2 a product's backward), one a
    library product and one more a layer: remat's recompute stops once it
    holds every tensor the backward saved, which an ``aten.mm`` saves
    before it runs and an ``autograd.Function`` after, so the kernel
    backend alone recomputes each layer's last product, the MLP's down
    projection; its flops exactly that product's more.  Prints what the
    no-copy path saves a 256-rank step, as traced."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES

    cfg, shape = get_config(kern["arch"], **kern["cfg_overrides"]), SHAPES[kern["shape"]]
    periods = cfg.n_periods
    ops = kern["ops"].get("repro_torch.native_gemm", 0)
    check(ops == 36 * periods + 3 and set(kern["ops"]) == {"repro_torch.native_gemm"},
          f"dryrun: the kernel cell's products {kern['ops']}, not {36 * periods + 3} "
          f"native_gemm ops")
    check(sum(lib["ops"].values()) == ops - periods,
          f"dryrun: the library cell's products {lib['ops']}, not {ops - periods}")
    # the down projection's local product on 16x16: tokens over data, d_ff
    # over model
    down = 2 * shape.global_batch * shape.seq_len * cfg.d_ff * cfg.d_model // 256
    check(kern["flops"] == lib["flops"] + periods * down,
          f"dryrun: kernel cell {kern['flops']} flops, the library cell's {lib['flops']} + "
          f"{periods} x {down} (the recomputed down projections)")
    log(f"dryrun: kernel cell (contract_backend kernel, strategy native) ok: {ops} "
        f"native_gemm ops by route {kern['routes']['repro_torch.native_gemm']}; the library "
        f"cell's {lib['ops']}; flops {kern['flops']} = the library cell's {lib['flops']} + "
        f"{periods} recomputed down projections of {down}")
    for key in ("bytes_accessed", "fused_bytes_accessed", "peak_bytes_per_device",
                "temp_bytes"):
        log(f"dryrun: {key}: kernel {kern[key]}, library {lib[key]}, kernel - library "
            f"{kern[key] - lib[key]} ({kern[key] / lib[key]:.4f}x)")
    log(f"dryrun: roofline (H100 ceilings): kernel {json.dumps(kern_row)}; library "
        f"{json.dumps(lib_row)}")


def predicted_step(dev, seed: int, train_ms: dict) -> dict:
    """Phase 17 (b): phase 13's step (minicpm-2b, 4 layers, 4 x 512
    tokens, unsharded) on each backend, torch and kernel
    (:func:`predicted_backend_step`).  Returns each backend's record."""
    return {backend: predicted_backend_step(dev, seed, backend, train_ms[backend])
            for backend in ("torch", "kernel")}


def predicted_backend_step(dev, seed: int, backend: str, train_ms: list) -> dict:
    """Phase 13's step on ``backend``, traced on fake CUDA tensors under
    ``repro_torch.utils.CostCounter``, against the same step run for real
    under the same counter: equal flops, products by op and routes, and
    the traced peak within ``PEAK_TOL`` of ``max_memory_allocated`` over
    the real step (above what was allocated before its inputs were made);
    on the kernel backend the traced ``repro_torch.native_gemm`` ops and
    their routes are the real step's ``native_gemm`` launches by route.
    Prints the step's roofline bound and its fraction of phase 13's ms per
    step on the backend."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models.transformer import init_params
    from repro_torch.obs.roofline import device_peaks
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.trainer import TrainConfig, make_train_step
    from repro_torch.utils import CostCounter

    over = (KERNEL_BACKEND if backend == "kernel"
            else {"contract_backend": "torch", "contract_strategy": "auto"})
    cfg = get_config(TRAIN["arch"]).with_(n_periods=TRAIN["periods"], **over)
    opt = AdamWConfig(lr=TRAIN["lr"], schedule="wsd", warmup_steps=TRAIN["warmup"],
                      total_steps=TRAIN["total_steps"])
    step = make_train_step(cfg, TrainConfig(opt=opt))
    t0 = time.perf_counter()
    with FakeTensorMode():
        params = init_params(None, cfg, device=dev)
        state = adamw_init(params)
        batch = {"tokens": torch.zeros((TRAIN["batch"], TRAIN["seq_len"]), dtype=torch.int32,
                                       device=dev)}
        with CostCounter() as traced:
            traced.hold((params, state, batch))
            traced.output(step(params, state, batch, None))
    del params, state, batch
    trace_s = time.perf_counter() - t0
    pred = traced.costs()

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    params = init_params(torch.Generator(dev).manual_seed(seed), cfg)
    state = adamw_init(params)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                       global_batch=TRAIN["batch"], seed=seed)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
    resident = torch.cuda.memory_allocated(dev) - base
    saved = (native_gemm.launches, native_gemm.launches_by_route)
    native_gemm.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(saved[1], 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        with CostCounter() as real:
            real.hold((params, state, batch))
            out = step(params, state, batch, None)
            real.output(out)
            torch.cuda.synchronize()
        launched = (native_gemm.launches,
                    {r: n for r, n in native_gemm.launches_by_route.items() if n})
    finally:
        native_gemm.launches, native_gemm.launches_by_route = saved
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    loss = float(out[3]["loss"])
    del out, params, state, batch
    got = real.costs()
    ratio = pred["peak_bytes"] / peak
    log(f"predict [{backend}]: phase 13's step traced on fake CUDA tensors in {trace_s:.1f} s: "
        f"{pred['flops']} flops, {pred['fused_bytes']} bytes fused to its products, "
        f"{pred['bytes']} bytes unfused (upper bound), products {pred['ops']}, routes "
        f"{pred['routes']}, peak {pred['peak_bytes'] / 2**30:.3f} GiB of which "
        f"{pred['argument_bytes'] / 2**30:.3f} GiB arguments; the real step ({real_s:.2f} s "
        f"under the counter, loss {loss:.6f}): {got['flops']} flops, {got['bytes']} bytes, "
        f"products {got['ops']}, native_gemm launches {launched[0]} by route {launched[1]}, "
        f"the counter's peak {got['peak_bytes'] / 2**30:.3f} GiB; inputs resident "
        f"{resident / 2**30:.3f} GiB over {base / 2**30:.3f} GiB allocated before them; "
        f"max_memory_allocated over the step {peak / 2**30:.3f} GiB above that: "
        f"predicted/measured peak {ratio:.4f} (limit 1 +- {PEAK_TOL})")
    check(np.isfinite(loss), f"predict [{backend}]: the real step's loss {loss} is not finite")
    check(got["flops"] == pred["flops"],
          f"predict [{backend}]: the real step counts {got['flops']} flops, the trace "
          f"{pred['flops']}")
    check(got["ops"] == pred["ops"] and got["routes"] == pred["routes"],
          f"predict [{backend}]: the real step's products {got['ops']} by route "
          f"{got['routes']}, the trace's {pred['ops']} by route {pred['routes']}")
    if backend == "kernel":
        per_step = train_launches_per_step(TRAIN["periods"])
        check(pred["ops"] == {"repro_torch.native_gemm": launched[0]}
              and launched[0] == sum(per_step.values())
              and pred["routes"] == {"repro_torch.native_gemm": launched[1]},
              f"predict: the trace's native_gemm ops {pred['ops']} by route "
              f"{pred['routes']}; the real step launched {launched[0]} by route "
              f"{launched[1]} ({sum(per_step.values())} a step: {per_step})")
    else:
        check(launched[0] == 0, f"predict: the torch step launched native_gemm {launched}")
    for key in ("bytes", "fused_bytes"):
        same = "equal" if got[key] == pred[key] else "differ from"
        log(f"predict [{backend}]: the real step's {key} {same} the trace's ({got[key]} and "
            f"{pred[key]})")
    check(abs(ratio - 1) <= PEAK_TOL,
          f"predict [{backend}]: traced peak {pred['peak_bytes']} is {ratio:.4f} of the "
          f"measured {peak}")
    peaks = device_peaks(torch.cuda.get_device_name(0))
    dtype = str(cfg.activation_dtype()).removeprefix("torch.")
    t_compute = pred["flops"] / peaks["flops_per_s"][dtype]
    t_memory = pred["fused_bytes"] / peaks["hbm_bytes_per_s"]
    bound_ms = max(t_compute, t_memory) * 1e3
    ms = sorted(train_ms)[len(train_ms) // 2]
    fraction = bound_ms / ms
    log(f"predict [{backend}]: roofline bound of the step {bound_ms:.3f} ms (compute "
        f"{t_compute * 1e3:.3f} ms at the {dtype} peak, memory {t_memory * 1e3:.3f} ms for the "
        f"fused bytes; the unfused bytes would take "
        f"{pred['bytes'] / peaks['hbm_bytes_per_s'] * 1e3:.3f} ms); phase 13's ms per step "
        f"{ms:.1f}: roofline fraction {fraction:.4f}")
    return dict(flops=pred["flops"], bytes=pred["bytes"], fused_bytes=pred["fused_bytes"],
                ops=pred["ops"], routes=pred["routes"], launches=launched[0],
                launches_by_route=launched[1],
                peak_bytes=pred["peak_bytes"], argument_bytes=pred["argument_bytes"],
                measured_peak_bytes=peak,
                counter_peak_bytes_real=got["peak_bytes"], peak_ratio=ratio,
                peak_live=pred["peak_live"], bound_ms=bound_ms, t_compute_ms=t_compute * 1e3,
                t_memory_ms=t_memory * 1e3, ms_per_step=ms, roofline_fraction=fraction,
                trace_s=trace_s)


def dryrun_path(dev, seed: int, train_ms: dict) -> dict:
    """Phase 17: the dry-run launchers, then the traced step against the
    real one."""
    t0 = time.perf_counter()
    launchers = dryrun_launchers()
    t1 = time.perf_counter()
    step = predicted_step(dev, seed, train_ms)
    log(f"dryrun: phase 17 took {time.perf_counter() - t0:.1f} s: (a) {t1 - t0:.1f} s, "
        f"(b) {time.perf_counter() - t1:.1f} s")
    return dict(launchers=launchers, step=step)


# ------------------------------------------------------------------ phase 21
#: calls back to back per timed loop of phase 21 (and tools/launch_host_us.py)
HOST_CALLS = 2000


def host_cost(dev, seed: int) -> dict:
    """Phase 21: host µs per ``native_gemm`` call of phase 11's decode-shaped
    bf16 ``wgmma`` product, one row of internlm2-20b's KV projection
    (``bse,ef->bsf``, E = d_model, F = KV heads x head dim): ``HOST_CALLS``
    calls back to back with one synchronize at the end, twice; the host µs
    a call is the loop's time before the synchronize, the wall µs its time
    to the synchronize's end.  Timing only: the launches count nowhere."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sb_gemm import native_gemm, native_route

    cfg = get_config(SERVE["arch"])
    E, F = cfg.d_model, cfg.n_kv_heads * cfg.hd
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(1, 1, E, generator=gen, device=dev).bfloat16()
    w = torch.randn(E, F, generator=gen, device=dev).bfloat16()
    kw = dict(a_modes="bse", b_modes="ef", c_modes="bsf")
    route = native_route(x, w, **kw)
    check(route == "wgmma", f"host: the decode-shaped product takes {route}, not wgmma")
    saved = (native_gemm.launches, dict(native_gemm.launches_by_route))
    try:
        for _ in range(50):
            native_gemm(x, w, **kw)
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                native_gemm(x, w, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            runs.append(((t1 - t0) / HOST_CALLS * 1e6, (t2 - t0) / HOST_CALLS * 1e6))
    finally:
        native_gemm.launches, native_gemm.launches_by_route = saved
    log(f"host: native_gemm bse,ef->bsf at 1 x {E} x {F} bf16 on {route}, {HOST_CALLS} calls "
        f"back to back, twice: host µs a call {', '.join(f'{h:.2f}' for h, _ in runs)}; wall "
        f"µs a call {', '.join(f'{w:.2f}' for _, w in runs)}")
    return dict(spec="bse,ef->bsf", rows=1, E=E, F=F, route=route, calls=HOST_CALLS,
                host_us=[h for h, _ in runs], wall_us=[w for _, w in runs])


# ------------------------------------------------------------------ phase 22
#: the SSM serving cell: mamba2-1.3b (src/repro/configs/mamba2_1p3b.py) at
#: its published widths and depth (no cut) on the kernel backend, one
#: ``native_gemm`` launch a product; 8 greedy requests of the prompt lengths
#: below (131 is prime: chunks of 1; 100 one chunk of 100; 8192 64 chunks of
#: 128), 16 new tokens each, on 4 slots with whole-prompt prefill;
#: ``state_check`` is the prompt whose cache is held to a token-by-token
#: decode loop, ``shape_lens`` the prefills whose SSD launch shapes are timed
SSM_SERVE = dict(arch="mamba2-1.3b", prompts=(64, 100, 128, 131, 256, 512, 2048, 8192),
                 max_new=16, slots=4, state_check=256, shape_lens=(512, 8192))
#: the products of a mamba2 pass that are not the SSD's: in_proj, out_proj
#: and the tied LM head
SSM_DENSE = ("ble,ef->blf", "bld,de->ble", "bse,ve->bsv")


def mag_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), torch.finfo(torch.float32).tiny)


def ssm_traffic(cfg, seed: int, serve: dict = SSM_SERVE, salt: int = 22):
    """The greedy requests of ``serve``'s prompt lengths, tokens drawn from
    ``seed + salt``, ``serve["max_new"]`` new tokens each."""
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(seed + salt)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=serve["max_new"])
            for i, n in enumerate(serve["prompts"])]


def ssm_routes(cfg, L: int | None = None) -> dict:
    """``native_gemm`` launches of one pass of a mamba2 or jamba stack by
    route, from its layer pattern.  On ``wgmma``: in_proj and out_proj of
    each Mamba layer, Q, K, V and O of each attention layer, the 2 or 3
    products of each dense MLP and of each shared expert of a MoE layer
    (qwen2-moe's 4), the head.  On ``batched``: an attention
    layer's scores and P·V and a MoE layer's 2 or 3 expert products; a
    decode pass's ``bhn,bhnp->bhp`` of each Mamba layer.  A prefill of ``L``
    tokens in chunks of Q (the largest divisor of L up to the chunk) runs
    four SSD products a Mamba layer: ``CBt`` (float32 operands) on
    ``fbatched`` (on ``stream`` where it writes one chunk of one group
    from a contraction at most ``NARROW`` deep: jamba's d_state 16 in a
    prompt of one chunk), ``y_intra`` (W with the head minor-most) on
    ``gathered``, the chunk states and ``y_inter`` on ``batched`` (chunks
    of 2 to 16 rows would take ``splitk`` for ``CBt``: not these phases'
    traffic); in chunks of 1 the first three on ``fbatched`` (nothing to
    contract, or f32) and ``y_inter`` on ``batched``.  A stack without
    Mamba layers (gemma2) launches the same routes whatever ``L``; so does
    one of granite's one KV head, whose one-row passes copy their row
    (``layers.attention``) to keep the scores and P·V on ``batched``.  A
    prefill of a stack with a frontend (internvl2's image) also runs the
    frontend's projection, ``bpf,fe->bpe``, on ``wgmma``."""
    from repro_torch.kernels.sb_gemm import NARROW

    n = cfg.n_periods
    ff = 3 if cfg.mlp_act == "swiglu" else 2
    mamba, attn, dense, moe = (n * sum(pick(s) for s in cfg.pattern) for pick in (
        lambda s: s.mixer == "mamba", lambda s: s.mixer == "attn",
        lambda s: s.ff == "dense", lambda s: s.ff == "moe"))
    shared = cfg.moe.n_shared if moe else 0
    routes = {"wgmma": 2 * mamba + 4 * attn + ff * (dense + shared * moe) + 1,
              "batched": 2 * attn + ff * moe + mamba}
    if L is not None and cfg.frontend is not None:
        routes["wgmma"] += 1
    if L is not None and mamba:
        Q = min(cfg.ssm.chunk, L)
        while L % Q:
            Q -= 1
        check(Q == 1 or Q > 16, f"ssm routes: chunks of {Q} are not this phase's traffic")
        if Q == 1:
            routes["fbatched"] = 3 * mamba
        else:
            one = Q == L and cfg.ssm.n_groups == 1 and cfg.ssm.d_state <= NARROW
            routes |= {"stream" if one else "fbatched": mamba, "gathered": mamba}
            routes["batched"] += mamba
    return {r: k for r, k in routes.items() if k}


@contextlib.contextmanager
def dropped_tokens():
    """Within the block every GShard dispatch appends ``(tokens per group,
    capacity, tokens that lost a slot to capacity, routing)`` to the list
    it yields, ``routing`` on the host: each token's top-k experts ``(g,
    t, k)``, ``-1 - e`` where capacity dropped the token from expert ``e``
    (one host read a dispatch)."""
    from repro_torch.models import moe

    real, seen = moe._dispatch_tensors, []

    def counting(gates, top_w, top_e, n_experts, capacity):
        dispatch, combine = real(gates, top_w, top_e, n_experts, capacity)
        kept = dispatch.sum(-1).gather(-1, top_e) > 0
        routing = torch.where(kept, top_e, -1 - top_e).to(torch.int16).cpu()
        seen.append((top_e.shape[1], capacity, int((routing < 0).any(-1).sum()), routing))
        return dispatch, combine

    moe._dispatch_tensors = counting
    try:
        yield seen
    finally:
        moe._dispatch_tensors = real


@contextlib.contextmanager
def served_events(rt, logits: dict, routes: list, forced: dict | None = None,
                  drops: list | None = None):
    """Within the block the runtime ``rt`` records every request's logits
    as float32 on the host under ``(rid, tokens generated before)``: a
    prefill's under ``(rid, 0)``, each decode pass's rows under their
    requests; each prefill and decode pass appends ``(kind, length or
    bucket, native_gemm launches by route)`` to ``routes``.  With
    ``forced`` (rid to tokens) every request is fed those tokens in place
    of its own samples: each decode row runs on the forced token.  With
    ``drops`` each pass appends ``(kind, rid or None, length or bucket,
    its GShard dispatches)``, a dispatch ``(tokens per group, capacity,
    tokens that lost a slot)`` a MoE layer (:func:`dropped_tokens`)."""
    from repro_torch.kernels.sb_gemm import native_gemm

    prefill, decode, sample = rt._run_prefill_chunk_impl, rt._run_decode_impl, rt._sample

    def launched(fn, kind, size, rid=None):
        before = dict(native_gemm.launches_by_route)
        with dropped_tokens() if drops is not None else contextlib.nullcontext() as seen:
            fn()
        routes.append((kind, size, {r: n - before[r] for r, n in
                                    native_gemm.launches_by_route.items() if n > before[r]}))
        if drops is not None:
            drops.append((kind, rid, size, seen))

    def sampled(state, row):
        pos = len(state.request.output)
        logits[(state.rid, pos)] = row.float().cpu()
        return sample(state, row) if forced is None else forced[state.rid][pos]

    def decoded(decodes):
        bucket = rt.lattice.decode_bucket(len(decodes))
        rows = ([s.slot for s in decodes] if bucket == rt.slots and not rt.paged
                else list(range(len(decodes))))
        keys = [(s.rid, len(s.request.output)) for s in decodes]
        rt.logits_probe = lambda out: logits.update(
            {k: out[r].float().cpu() for k, r in zip(keys, rows)})
        launched(lambda: decode(decodes), "decode", bucket)
        if forced is not None:
            for s, (rid, pos) in zip(decodes, keys):
                s.request.output[pos] = forced[rid][pos]
                # a request that finished in this pass has freed its slot
                # (``slot`` None): its slot's next token is not its own
                if s.slot is not None:
                    rt._tokens[s.slot, 0] = forced[rid][pos]

    rt._sample = sampled
    rt._run_prefill_chunk_impl = lambda state, chunk: launched(
        lambda: prefill(state, chunk), "prefill", chunk, state.rid)
    rt._run_decode_impl = decoded
    try:
        yield logits
    finally:
        del rt._sample, rt._run_prefill_chunk_impl, rt._run_decode_impl
        rt.logits_probe = None


def counted_serve(tag: str, rt, cfg, traffic, warm, counters, drops: list | None = None) -> dict:
    """The main path of a serving phase: ``traffic`` through ``rt`` with
    every kernel's launch count set to 0 just before and read just after.
    Every request must get its tokens, the warm-up serve's (``warm``,
    where given), with no bucket entry built and only ``native_gemm`` launched, each
    launch on the route ``native_route`` gives and each prefill and decode
    pass by the routes :func:`ssm_routes` derives.  Returns the logits by
    ``(rid, position)`` (``seen``), the launches by kernel (``counted``)
    and by route (``routes``), each prefill's routes by prompt length,
    the decode passes' routes, the peak memory, the serve's seconds and
    its times (``timed``, :func:`timed_serve`'s, every row's logits
    recorded on the host as it ran); ``drops`` as :func:`served_events`'.
    With chunked prefill a prefill is a chunk: the chunks must be those of
    each prompt's ``chunk_schedule``, and ``prefills`` is keyed by chunk."""
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.runtime.buckets import chunk_schedule

    entries = rt.buckets.compiles
    seen, events = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    t0 = time.perf_counter()
    with native_routes_held() as held, served_events(rt, seen, events, drops=drops):
        timed = timed_serve(rt, traffic)
    serve_s = time.perf_counter() - t0
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    outputs = [r.output for r in traffic]
    max_new = traffic[0].max_new_tokens
    check(all(r.done and len(r.output) == r.max_new_tokens for r in traffic),
          f"{tag}: not every request finished with its {max_new} tokens: "
          f"{[(r.rid, r.status, len(r.output)) for r in traffic]}")
    differ = [r.rid for r, w in zip(traffic, warm or traffic) if r.output != w.output]
    check(not differ, f"{tag}: tokens differ from the warm-up serve's (a paged serve: the "
                      f"unpaged serve's) for requests {differ}")
    check(rt.buckets.compiles == entries,
          f"{tag}: the counted serve built {rt.buckets.compiles - entries} bucket entries")
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"{tag}: another kernel launched on the path: {counted}")
    check(routes == held and counted["native_gemm"] == sum(held.values()),
          f"{tag}: launches {counted['native_gemm']} by route {routes}, native_route gives "
          f"{held}")
    for kind, size, by in events:
        want = ssm_routes(cfg, size if kind == "prefill" else None)
        check(by == want, f"{tag}: a {kind} of {size} launched by route {by}, not {want}")
    check(sum(sum(by.values()) for *_, by in events) == counted["native_gemm"],
          f"{tag}: launches outside a prefill or decode pass")
    prefills = {size: by for kind, size, by in events if kind == "prefill"}
    decodes = [by for kind, _, by in events if kind == "decode"]
    lens = [len(r.prompt) for r in traffic]
    # one prefill a prompt, or with chunked prefill one a chunk of its schedule
    want = sorted(c for L in lens for c in (
        chunk_schedule(L, rt.lattice.chunk_buckets) if rt.lattice.chunked else [L]))
    got = sorted(size for kind, size, _ in events if kind == "prefill")
    check(got == want, f"{tag}: prefills of {got}, not {want}")
    log(f"{tag}: {len(traffic)} requests, prompts {tuple(lens)}, "
        f"{sum(map(len, outputs))} tokens in {serve_s:.2f} s; native_gemm launches "
        f"{counted['native_gemm']} by route {routes}, each on the route native_route gives; "
        f"grouped_gemm {counted['grouped_gemm']}, flash_attention "
        f"{counted['flash_attention']}; bucket entries {entries}, none built by the counted "
        f"serve; peak {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) allocated")
    for L in sorted(prefills):
        log(f"{tag}: prefill{' chunk' if rt.lattice.chunked else ''} of {L} "
            f"(x{got.count(L)}): {sum(prefills[L].values())} launches, {prefills[L]}")
    log(f"{tag}: {len(decodes)} decode passes, each {sum(decodes[0].values())} launches, "
        f"{decodes[0]}")
    return dict(seen=seen, counted=counted, routes=routes, prefills=prefills,
                decodes=decodes, peak=peak, outputs=outputs, n_prefills=len(got), timed=timed)


def prefill_vs_forward(tag: str, cfg, params, traffic, seen: dict, dev,
                       peaks: dict | None = None, label: str = "(a)",
                       beside: dict | None = None, routing: dict | None = None):
    """Check (a) of a serving phase: each request's served prefill logits
    (``seen[(rid, 0)]``), finite and of the vocab's width, within 2e-2 of
    the largest magnitude of ``transformer.forward``'s last position on
    its prompt.  Returns the distances by prompt length; ``peaks``, where
    given, gets each forward's peak allocated bytes by prompt length.

    With ``routing`` (rid to the served prefill's GShard routing, a tensor
    a MoE layer, :func:`dropped_tokens`), forward's own routing is held to
    it: a prompt is held to 2e-2 where forward routed every token of
    every layer as the served prefill did (the same top-k, the same
    drops).  bf16 bits that differ (forward takes its softmax over S keys,
    a served row over the runtime's width) flip near-ties, and each flip
    moves the capacity queue behind it, so elsewhere the distance is
    logged beside the first layer whose routing differs, where at most
    5% of the tokens (or one) may choose other experts (a fault of
    positions, masks or cache moves them all); at least one prompt must
    route alike.  Then it also takes ``beside`` (logits keyed as
    ``seen``, held to nothing here) and returns the distances, those of
    ``beside`` from the same forward, and which prompts routed alike
    (``alike``) or where they diverged (``diverged``)."""
    from repro_torch.models import transformer

    errs, errs_b, alike, diverged = {}, {}, [], {}
    with torch.no_grad():
        for r in traffic:
            L = len(r.prompt)
            toks = torch.as_tensor(r.prompt, device=dev)[None].long()
            if peaks is not None:
                torch.cuda.reset_peak_memory_stats()
            with dropped_tokens() if routing is not None else contextlib.nullcontext() as fwd:
                full, _ = transformer.forward(cfg, params, {"tokens": toks})
            if peaks is not None:
                peaks[L] = torch.cuda.max_memory_allocated()
            got = seen[(r.rid, 0)]
            check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (cfg.vocab_size,),
                  f"{tag}: prefill logits of {L} not finite or of the wrong shape")
            last = full[0, -1].cpu()
            del full
            errs[L] = mag_err(got, last)
            if routing is None:
                continue
            errs_b[L] = mag_err(beside[(r.rid, 0)], last)
            served = routing[r.rid]
            check(len(served) == len(fwd), f"{tag}: {len(fwd)} dispatches in forward, "
                                           f"{len(served)} in the served prefill of {L}")
            first = next((i for i, (a, b) in enumerate(zip(fwd, served))
                          if not torch.equal(a[3], b)), None)
            if first is None:
                alike.append(L)
                continue
            # the experts each token chose, whether or not capacity kept it
            chosen = [torch.where(x < 0, -1 - x, x) for x in (fwd[first][3], served[first])]
            moved = int((chosen[0] != chosen[1]).any(-1).sum())
            diverged[L] = dict(layer=first, tokens=moved, err=errs[L])
            check(moved <= max(1, 0.05 * L),
                  f"{tag}: forward's routing of the {L}-token prompt leaves the served "
                  f"prefill's at MoE layer {first} for {moved} tokens (over 5%)")
    held = errs if routing is None else {L: errs[L] for L in alike}
    check(bool(held) and max(held.values()) <= TOL[torch.bfloat16],
          f"{tag}: served prefill logits against forward's last position {held} (limit "
          f"{TOL[torch.bfloat16]} of the largest magnitude; routed alike: {alike})")
    log(f"{tag}: {label} served prefill logits against transformer.forward's last position, by "
        f"prompt length: {', '.join(f'{L}: {e:.3g}' for L, e in errs.items())} of the "
        f"largest magnitude (limit {TOL[torch.bfloat16]:g}"
        + ("" if routing is None else
           f" where forward routed as the served prefill in every MoE layer: at {alike}; "
           f"elsewhere the first layer whose routing differs and the tokens it moves: "
           + (", ".join(f"{L}: layer {d['layer']}, {d['tokens']} tokens"
                        for L, d in diverged.items()) or "none"))
        + ")")
    if routing is not None:
        return errs, errs_b, dict(alike=alike, diverged=diverged)
    return errs


def oracle_check(tag: str, label: str, seen: dict, seen_t: dict, ref: dict, tokens: dict,
                 rows: int, what: str = "runtime", oracle: str | None = None,
                 note: str = "") -> dict:
    """The float32 oracle check of a serving phase: every row the kernel
    backend served (``seen``, logits by ``(rid, tokens generated
    before)``) no farther from the float32 oracle's (``ref``: the torch
    backend in float32 fed the same tokens) than the larger of 2e-2 and
    twice the worst of the bf16 torch backend's (``seen_t``), each of the
    largest magnitude; all three recorded at the same ``rows`` positions.
    ``tokens`` (rid to the kernel's tokens) counts where the oracle's
    argmax is the kernel's token; ``what`` names the served path and
    ``oracle`` the float32 one (``what`` by default); ``note`` ends the
    log line.  Returns the worst distances, and each row's (``rows``)."""
    check(seen.keys() == ref.keys() == seen_t.keys() and len(ref) == rows,
          f"{tag}: logits recorded at {len(seen)}, {len(seen_t)} and {len(ref)} positions")
    e_k = {k: mag_err(seen[k], ref[k]) for k in ref}
    e_t = {k: mag_err(seen_t[k], ref[k]) for k in ref}
    direct = max(mag_err(seen[k], seen_t[k]) for k in ref)
    err_k, err_t = max(e_k.values()), max(e_t.values())
    limit = max(TOL[torch.bfloat16], 2 * err_t)
    far = {k: (e, e_t[k]) for k, e in e_k.items() if e > limit}
    check(not far, f"{tag}: kernel {what} rows farther from the float32 oracle than {limit} "
                   f"(the larger of {TOL[torch.bfloat16]} and twice the torch backend's "
                   f"worst {err_t}): {far}")
    agree = sum(int(torch.argmax(ref[(rid, pos)])) == tok
                for rid, toks in tokens.items() for pos, tok in enumerate(toks))

    def worst(errs, pre):
        return max(e for (_, pos), e in errs.items() if (pos == 0) == pre)

    log(f"{tag}: {label} against the float32 {oracle or what} (torch backend, TF32 off) fed "
        f"the same tokens, worst of the largest magnitude over {len(ref)} rows: kernel {what} "
        f"{err_k:.3g} (prefill rows {worst(e_k, True):.3g}, decode rows "
        f"{worst(e_k, False):.3g}; median {sorted(e_k.values())[len(e_k) // 2]:.3g}), torch "
        f"backend {what} {err_t:.3g} (prefill {worst(e_t, True):.3g}, decode "
        f"{worst(e_t, False):.3g}; median {sorted(e_t.values())[len(e_t) // 2]:.3g}); limit "
        f"for the kernel {limit:.3g}; kernel against torch directly {direct:.3g}; the "
        f"oracle's argmax is the kernel's token at {agree} of {len(ref)} positions; {note}")
    return dict(kernel=err_k, torch=err_t, kernel_vs_torch=direct, rows=e_k)


def pass_layouts(tag: str, passes: dict, gen, dev, skip=()) -> tuple:
    """Every ``native_gemm`` launch layout of each pass in ``passes`` (name
    to a function that runs it), but the specs in ``skip``, on random
    operands of its layout from ``gen``: within ``TOL`` of the plain
    version, bit-identical twice, timed queued against its bound, the
    plain version and one ``torch.einsum`` (:func:`time_shapes`, 3 calls).
    Returns the rows (one a layout and pass, with its launches), the sums
    per pass and the sums by route, each weighted by launches; the
    comparison launches do not count."""
    from repro_torch.kernels.sb_gemm import native_gemm

    keys4 = ("ms", "plain_ms", "library_ms", "bound_ms")
    saved = native_gemm.launches, dict(native_gemm.launches_by_route)
    shapes, per_pass = [], {}
    for name, run in passes.items():
        with torch.no_grad(), recording_launch_keys() as keys:
            run()
        tot = per_pass[name] = dict.fromkeys(keys4, 0.0) | dict(launches=0)
        for key, (n, layout) in sorted(keys.items(), key=lambda kv: str(kv[0])):
            if f"{key[0]},{key[1]}->{key[2]}" in skip:
                continue
            A, B, kw = operands_like(layout, gen, dev)
            row = time_shapes({key: (1, (A, B, kw))}, reps=3, per=name,
                              summary=False)["rows"][0]
            del A, B
            shapes.append(dict(row, path=name, launches=n))
            tot["launches"] += n
            for k in keys4:
                tot[k] += n * row[k]
        log(f"{tag} {name}: {tot['launches']} launches timed, kernel {tot['ms']:.4f} ms "
            f"queued, bound {tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, einsum "
            f"{tot['library_ms']:.4f} ms queued")
    native_gemm.launches, native_gemm.launches_by_route = saved
    by_route = {}
    for row in shapes:
        tot = by_route.setdefault(row["route"], dict.fromkeys(keys4 + ("bytes", "flops"), 0.0)
                                  | dict(launches=0, max_abs_err=0.0))
        tot["launches"] += row["launches"]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        for k in keys4 + ("bytes", "flops"):
            tot[k] += row["launches"] * row[k]
    for route, tot in by_route.items():
        tot["bound_by"] = bound(tot["bytes"], tot["flops"], torch.bfloat16)[1]
        log(f"{tag} {route}, over the {len(passes)} passes ({tot['launches']} launches): "
            f"kernel {tot['ms']:.4f} ms queued, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']}), plain {tot['plain_ms']:.4f} ms, einsum "
            f"{tot['library_ms']:.4f} ms queued")
    return shapes, per_pass, by_route


def serve_passes(cfg, params, traffic, lens, slots: int, max_len: int, dev) -> dict:
    """The passes a serving phase times and profiles: a prefill of each
    prompt length in ``lens`` (that request's prompt, from an empty batch-1
    cache) and a decode pass over ``slots`` empty slots, by name, each a
    function of the config to run it with (``cfg`` by default)."""
    from repro_torch.models import transformer
    from repro_torch.runtime.engine import slot_cache

    scratch = slot_cache(cfg, slots, max_len, device=dev)
    toks = torch.zeros((slots, 1), dtype=torch.long, device=dev)

    def prefill(n, conf=cfg):
        prompt = next(r.prompt for r in traffic if len(r.prompt) == n)
        return transformer.prefill(conf, params, {
            "tokens": torch.as_tensor(prompt, device=dev)[None].long()},
            transformer.init_cache(conf, 1, max_len, device=dev))

    passes = {f"prefill {n}": (lambda conf=cfg, n=n: prefill(n, conf)) for n in lens}
    passes["decode pass"] = lambda conf=cfg: transformer.decode_step(conf, params, scratch, toks)
    return passes


def ssm_serve_path(dev, seed: int, counters) -> dict:
    """Phase 22: mamba2-1.3b at its published widths and depth through
    ``ServingRuntime`` on the kernel backend (see the module docstring).
    Returns ``native_gemm``'s SSM serving record."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime.engine import ServingRuntime
    from repro_torch.serving.engine import ServeEngine

    t_start = time.perf_counter()
    cfg = get_config(SSM_SERVE["arch"]).with_(**KERNEL_BACKEND)
    cfg_t = cfg.with_(contract_backend="torch", contract_strategy="auto")
    raw = get_config(SSM_SERVE["arch"], pad_vocab=False).vocab_size
    s = cfg.ssm
    log(f"ssm: {cfg.arch_id} {cfg.n_periods} layers (no cut), d_model {cfg.d_model}, d_state "
        f"{s.d_state}, headdim {s.headdim}, expand {s.expand}, chunk {s.chunk}, vocab {raw} "
        f"padded to {cfg.vocab_size}, tied embeddings {cfg.tie_embeddings}, {cfg.dtype} "
        f"activations, {cfg.param_dtype} params, contract_backend {cfg.contract_backend}, "
        f"strategy {cfg.contract_strategy}; {cfg.param_count() / 1e9:.3f}B params")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    log(f"ssm: random weights drawn on the card, "
        f"{(torch.cuda.memory_allocated(dev) - base) / 2**30:.2f} GiB")
    max_len = max(SSM_SERVE["prompts"]) + SSM_SERVE["max_new"]
    kw = dict(slots=SSM_SERVE["slots"], max_len=max_len)
    rt = ServingRuntime(cfg, params, **kw)
    check(not rt.lattice.chunked, "ssm: the runtime chunks an SSM model's prompts")
    warm = rt.serve(ssm_traffic(cfg, seed))

    # the main path, with (d): every prefill and decode pass launches what
    # its products give; timed, it gives the kernel backend's times
    traffic = ssm_traffic(cfg, seed)
    main = counted_serve("ssm", rt, cfg, traffic, warm, counters)
    seen, counted, routes = main["seen"], main["counted"], main["routes"]
    runs = {"kernel": [main["timed"]]}
    prefills, decodes, peak, outputs = (main[k] for k in ("prefills", "decodes", "peak",
                                                          "outputs"))

    # (a) each request's prefill logits against the forward's last position
    errs_a = prefill_vs_forward("ssm", cfg, params, traffic, seen, dev)

    # (b) the cache after a prefill against a token-by-token decode loop,
    # both held to the cache of a float32-activation prefill (the same
    # weights): two bf16 summation orders drift apart with depth
    L = SSM_SERVE["state_check"]
    prompt = torch.as_tensor(next(r.prompt for r in traffic if len(r.prompt) == L),
                             device=dev)[None].long()
    with torch.no_grad():
        _, pre = transformer.prefill(cfg, params, {"tokens": prompt},
                                     transformer.init_cache(cfg, 1, max_len, device=dev))
        cfg32 = cfg.with_(dtype="float32")
        _, ref32 = transformer.prefill(cfg32, params, {"tokens": prompt},
                                       transformer.init_cache(cfg32, 1, max_len, device=dev))
        loop = transformer.init_cache(cfg, 1, max_len, device=dev)
        t0 = time.perf_counter()
        for t in range(L):
            _, loop = transformer.decode_step(cfg, params, loop, prompt[:, t:t + 1])
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    check(int(pre["length"]) == int(loop["length"]) == L, "ssm: cache lengths")
    errs_b = {}
    for leaf in ("conv", "state"):
        def layer(cache, i):
            return cache["pattern"][0][leaf][i]
        n = range(cfg.n_periods)
        e = errs_b[leaf] = dict(
            direct=[mag_err(layer(pre, i), layer(loop, i)) for i in n],
            prefill_off=[mag_err(layer(pre, i), layer(ref32, i)) for i in n],
            loop_off=[mag_err(layer(loop, i), layer(ref32, i)) for i in n])
        far = [i for i in n if e["prefill_off"][i] > max(TOL[torch.bfloat16],
                                                         2 * e["loop_off"][i])]
        check(not far, f"ssm: {leaf} of layers {far} after the {L}-token prefill farther from "
                       f"the float32 prefill's than twice the decode loop's: "
                       f"{e['prefill_off']} against {e['loop_off']}")
        log(f"ssm: (b) {leaf} of the {cfg.n_periods} layers after the {L}-token prefill, "
            f"against a token-by-token decode_step loop ({loop_s:.1f} s): worst layer "
            f"{max(e['direct']):.3g} of its largest magnitude; from the float32 prefill's: "
            f"prefill worst {max(e['prefill_off']):.3g}, loop worst {max(e['loop_off']):.3g} "
            f"(a layer's prefill within the larger of {TOL[torch.bfloat16]:g} and twice its "
            f"loop's)")
    del pre, ref32, loop

    # (c) the legacy engine's tokens; the logits of the runtime on each
    # backend against a float32 forward on the library backend
    legacy = ServeEngine(cfg, params, **kw).serve(ssm_traffic(cfg, seed))
    check([r.output for r in legacy] == outputs,
          "ssm: the runtime's tokens differ from ServeEngine's (the legacy oracle)")
    rt_t = ServingRuntime(cfg_t, params, **kw)
    seen_t, served_t = {}, ssm_traffic(cfg, seed)
    with served_events(rt_t, seen_t, []):
        runs["torch"] = [timed_serve(rt_t, served_t)]
    torch_out = {r.rid: r.output for r in served_t}
    kern_out = {r.rid: r.output for r in traffic}
    ref = {}
    with torch.no_grad():
        for r in traffic:
            seq = np.concatenate([r.prompt, np.asarray(r.output[:-1], np.int32)])
            full, _ = transformer.forward(cfg_t.with_(dtype="float32"), params, {
                "tokens": torch.as_tensor(seq, device=dev)[None].long()})
            rows = full[0, len(r.prompt) - 1:].cpu()
            ref.update({(r.rid, pos): rows[pos] for pos in range(len(r.output))})
            del full
    # a position of the torch backend compares where it fed the request the
    # kernel backend's tokens
    same = [k for k in seen_t if torch_out[k[0]][:k[1]] == kern_out[k[0]][:k[1]]]
    check(seen.keys() == ref.keys() and sum(pos == 0 for _, pos in same) == len(traffic),
          f"ssm: {len(seen)} logits recorded for {len(ref)} positions")
    err_k = max(mag_err(seen[k], ref[k]) for k in seen)
    err_t = max(mag_err(seen_t[k], ref[k]) for k in same)
    direct = max(mag_err(seen[k], seen_t[k]) for k in same)
    limit = max(TOL[torch.bfloat16], 2 * err_t)
    check(err_k <= limit, f"ssm: the kernel runtime's logits {err_k} from a float32 forward's, "
                          f"the torch backend's {err_t} (limit {limit})")
    agree = sum(kern_out[i] == torch_out[i] for i in kern_out)
    log(f"ssm: (c) tokens equal ServeEngine's; against a float32 forward (torch backend) on the "
        f"served tokens, worst of the largest magnitude: kernel runtime {err_k:.3g} at "
        f"{len(seen)} positions, torch backend runtime {err_t:.3g} at the {len(same)} fed the "
        f"same tokens (limit for the kernel: the larger of {TOL[torch.bfloat16]:g} and twice "
        f"the torch backend's); kernel against torch directly {direct:.3g}; greedy tokens "
        f"equal in {agree} of {len(traffic)} requests")
    del ref

    # (e) every SSD launch shape of two prefills and a 4-slot decode pass
    passes = serve_passes(cfg, params, traffic, SSM_SERVE["shape_lens"], SSM_SERVE["slots"],
                          max_len, dev)
    shapes, per_pass, by_route = pass_layouts("ssm: (e)", passes,
                                              torch.Generator(dev).manual_seed(seed + 22),
                                              dev, skip=SSM_DENSE)

    # (f) times: the kernel's counted serve and the torch backend's serve of
    # (c), both recording every row's logits on the host; a decode pass's
    # idle share on each
    saved = [c.launches for c in counters]
    for backend, (res,) in runs.items():
        log(f"ssm [{backend}]: {res['tokens']} tokens in {res['wall_ms']:.1f} ms, "
            f"{res['tokens_per_s']:.2f} tokens/s; ms per prefill by length: "
            f"{', '.join(f'{c}: {m:.3f}' for c, m in res['chunk_ms_by_len'].items())}; "
            f"ms per decode pass by bucket: "
            f"{', '.join(f'{b}: {m:.3f} (x{res['ticks_by_bucket'][b]})' for b, m in res['tick_ms_by_bucket'].items())}")
    profiles = {}
    with torch.no_grad():
        for backend, conf in (("kernel", cfg), ("torch", cfg_t)):
            fn = functools.partial(passes["decode pass"], conf)
            fn()
            profiles[f"{backend} decode pass"] = profile_device(
                f"one mamba2 decode pass [{backend}]", fn, top=6)
    for c, n in zip(counters, saved):
        c.launches = n
    del rt, rt_t, legacy, passes, params
    log(f"ssm: phase 22 took {time.perf_counter() - t_start:.1f} s")
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                prefill_launches_by_route={str(L): prefills[L] for L in SSM_SERVE["prompts"]},
                decode_launches_by_route=decodes[0], prefill_logits_err=errs_a,
                state_err={leaf: {k: max(v) for k, v in e.items()} for leaf, e in errs_b.items()},
                logits_err=dict(kernel=err_k, torch=err_t, kernel_vs_torch=direct),
                peak_bytes=peak, shapes=shapes, shapes_by_route=by_route, per_pass=per_pass,
                profiles=profiles,
                tokens_per_s={b: [r["tokens_per_s"] for r in v] for b, v in runs.items()},
                runs={b: [{k: v for k, v in r.items() if k != "outputs"} for r in rs]
                      for b, rs in runs.items()})


# ------------------------------------------------------------------ phase 23
#: mamba2-1.3b trained at its published widths and depth (48 layers, no
#: cut), ``batch`` sequences of ``seq_len`` tokens a step (the Mamba-2
#: paper's training context), ``steps`` steps of ``Trainer`` with phase
#: 13's lr, warmup and schedule; the float32 oracle's limits: the float32
#: kernel step ``f32_tol`` of each leaf's largest magnitude (and relative on
#: the loss), the bf16 kernel step the larger of ``bf16_floor`` and twice
#: the bf16 torch step's distance, its loss ``loss_tol`` relative
SSM_TRAIN = dict(arch="mamba2-1.3b", seq_len=2048, batch=2, steps=6, timed_steps=1,
                 top_shapes=8, f32_tol=1e-3, bf16_floor=5e-2, loss_tol=2e-2, lr=TRAIN["lr"])


#: device kernels a train step's profile sums by kind (by name):
#: ``native_gemm``'s, the float32 adds and fills that the stacked
#: parameters' gradient costs (ROADMAP E4), and copies (the weights' casts
#: to bf16 among them)
STEP_KINDS = {"native_gemm": lambda name: name.removeprefix("void ").startswith(NATIVE_KERNELS),
              "f32 adds": lambda name: "CUDAFunctor_add<float>" in name,
              "fills": lambda name: "FillFunctor" in name,
              "copies": lambda name: "copy" in name}


def unreached_leaves(cfg) -> set:
    """Paths of the parameter leaves the loss does not reach, whose gradient
    is identically zero (in the JAX package too): the ``norm2`` of every
    pattern layer without a feed-forward, since its block never reads it,
    and ``embed`` under an audio frontend, whose frames are the whole
    sequence, so no token is ever looked up."""
    audio = cfg.frontend is not None and cfg.frontend.kind == "audio"
    return ({("pattern", j, "norm2") for j, spec in enumerate(cfg.pattern) if spec.ff == "none"}
            | ({("embed",)} if audio else set()))


def train_at_width(dev, seed: int, counters, tag: str, cfg, data, per_step: dict,
                   settings: dict) -> dict:
    """``cfg`` (at its published widths, kernel backend with
    ``contract_strategy="native"``) trained through ``Trainer``, and held
    to account (phases 23 and 26): (1) ``settings["steps"]`` steps with
    every count set to 0 just before and read just after: finite losses,
    the last below the first, ``per_step`` ``native_gemm`` launches a step
    by route, each on ``native_route``'s route, no other kernel; the peak
    memory.  (2) The float32 oracle from the first weights and batch.  (3)
    Every launch layout of one recorded step on random operands of its
    layout against the plain version, bit-identical twice, timed.  (4) ms
    per step and tokens/s (an audio model's frames are its tokens) on
    each backend, one profiled step each.
    ``data()`` gives a fresh stream of the phase's batches; ``tag`` starts
    every line.  Returns the record, its ``seconds`` by part."""
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import transformer
    from repro_torch.models.tree import tree_leaves_with_path
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.trainer import (
        TrainConfig, Trainer, make_train_step, value_and_grad,
    )

    took, mark = {}, [time.perf_counter()]

    def lap(label):
        took[label] = round(time.perf_counter() - mark[0], 1)
        mark[0] = time.perf_counter()

    cfg_t = cfg.with_(contract_backend="torch", contract_strategy="auto")
    steps = settings["steps"]
    tokens = settings["seq_len"] * settings["batch"]
    n_step = sum(per_step.values())
    zero = unreached_leaves(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    opt = AdamWConfig(lr=settings["lr"], schedule="wsd", warmup_steps=TRAIN["warmup"],
                      total_steps=TRAIN["total_steps"])

    # (1) the main path: counts to 0 just before, read just after
    tr = Trainer(cfg, TrainConfig(opt=opt, remat=True), params, data())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with native_routes_held() as held:
        hist = tr.run(steps)
        torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    peak = torch.cuda.max_memory_allocated(dev)
    del tr
    losses = [h["loss"] for h in hist]
    by_step = {r: n // steps for r, n in routes.items() if n}
    log(f"{tag}: {steps} steps, losses {', '.join(f'{x:.6f}' for x in losses)}; step ms "
        f"{', '.join(f'{h['step_time_s'] * 1e3:.1f}' for h in hist)}; lr "
        f"{', '.join(f'{h['lr']:.3g}' for h in hist)}; native_gemm launches "
        f"{counted['native_gemm']} ({n_step} a step: by route {by_step}); grouped_gemm "
        f"{counted['grouped_gemm']}, flash_attention {counted['flash_attention']}; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) allocated")
    check(all(np.isfinite(losses)), f"{tag}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{tag}: step {steps}'s loss {losses[-1]} is not below "
                                  f"step 1's {losses[0]}")
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"{tag}: another kernel launched on the path: {counted}")
    check(routes == held, f"{tag}: routes {routes} differ from native_route's {held}")
    check(counted["native_gemm"] == steps * n_step and by_step == per_step
          and all(n % steps == 0 for n in routes.values()),
          f"{tag}: {counted['native_gemm']} native_gemm launches by route {routes} in "
          f"{steps} steps; the model gives {per_step} a step")
    log(f"{tag}: (1) every loss finite, the last below the first; every launch on the route "
        f"native_route gives, none of grouped_gemm or flash_attention")
    lap("(1) trainer")

    # (2) the float32 oracle: at most two gradient trees on the card at once
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data()).items()}

    def step_of(conf, label):
        loss, _, grads = value_and_grad(conf, params, batch)
        grads = tree_leaves_with_path(grads)
        bad = [p for p, g in grads if not bool(torch.isfinite(g).all())]
        check(not bad, f"{tag}: [{label}] non-finite gradients on {bad}")
        zeros = {p for p, g in grads if not bool(g.abs().max() > 0)}
        check(zeros == zero, f"{tag}: [{label}] leaves with a zero gradient {zeros}, the "
                             f"config gives {zero}")
        return float(loss), grads

    loss_ref, ref = step_of(cfg_t.with_(dtype="float32"), "float32 torch")

    def distance(label, conf):
        loss, grads = step_of(conf, label)
        dist = {p: mag_err(g, r) for (p, g), (_, r) in zip(grads, ref)}
        worst = max(dist, key=dist.get)
        log(f"{tag}: (2) [{label}] loss {loss:.6f} against the float32 torch step's "
            f"{loss_ref:.6f} ({abs(loss - loss_ref) / abs(loss_ref):.3g} relative); worst leaf "
            f"{'/'.join(map(str, worst))} {dist[worst]:.3g} of its largest magnitude")
        return loss, dist

    loss_k32, d_k32 = distance("float32 kernel", cfg.with_(dtype="float32"))
    loss_t16, d_t16 = distance("bf16 torch", cfg_t)
    loss_k16, d_k16 = distance("bf16 kernel", cfg)
    del ref
    f32_tol, floor = settings["f32_tol"], settings["bf16_floor"]
    far = {p: e for p, e in d_k32.items() if e > f32_tol}
    check(not far and abs(loss_k32 - loss_ref) <= f32_tol * abs(loss_ref),
          f"{tag}: the float32 kernel step from the float32 torch step's beyond {f32_tol}: "
          f"leaves {far}, loss {loss_k32} against {loss_ref}")
    far = {p: (e, d_t16[p]) for p, e in d_k16.items() if e > max(floor, 2 * d_t16[p])}
    check(not far, f"{tag}: bf16 kernel gradients farther from float32 than the larger of "
                   f"{floor} and twice the bf16 torch step's: {far}")
    check(abs(loss_k16 - loss_ref) <= settings["loss_tol"] * abs(loss_ref),
          f"{tag}: the bf16 kernel loss {loss_k16} from the float32 loss {loss_ref}")
    log(f"{tag}: (2) every leaf's gradient finite in all four steps, nonzero except "
        f"{sorted(zero)}; float32 kernel within {f32_tol:g} on every leaf; bf16 kernel within "
        f"the larger of {floor:g} and twice the bf16 torch step's distance on every leaf, its "
        f"loss within {settings['loss_tol']:g}")
    lap("(2) oracle")

    # (3) each launch layout of one recorded step against its plain version
    saved = [c.launches for c in counters]
    with recording_launch_keys() as keys:
        value_and_grad(cfg, params, batch)
        torch.cuda.synchronize()
    check(sum(n for n, _ in keys.values()) == n_step,
          f"{tag}: the recorded step launched {sum(n for n, _ in keys.values())}")
    with recording_launch_keys() as fwd, torch.no_grad():
        transformer.forward(cfg, params, batch)
    forward = {f"{a},{b}->{c}" for a, b, c, *_ in fwd}
    rows = layout_rows(keys, torch.Generator(dev).manual_seed(seed + 23), dev)
    tot = {k: sum(r["launches"] * r[k] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    top = sorted(rows, key=lambda r: -r["launches"] * r["ms"])[:settings["top_shapes"]]
    log(f"{tag}: (3) {len(rows)} launch layouts of a step, each within TOL of the plain "
        f"version and bit-identical twice; per step: kernel {tot['ms']:.4f} ms queued, bound "
        f"{tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, einsum "
        f"{tot['library_ms']:.4f} ms queued; top {len(top)} by time: " + "; ".join(
            f"{r['spec']} x{r['launches']} [{r['route']}] {r['launches'] * r['ms']:.4f} ms "
            f"(einsum {r['launches'] * r['library_ms']:.4f}, bound "
            f"{r['launches'] * r['bound_ms']:.4f})" for r in top))
    for r in rows:
        if r["spec"] not in forward:
            log(f"{tag}: (3) backward {r['spec']} [{r['route']}] x{r['launches']}: kernel "
                f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ({r['bound_by']}, "
                f"{100 * r['bound_ms'] / r['ms']:.1f}%), einsum {r['library_ms']:.4f} "
                f"({r['ms'] / r['library_ms']:.2f}x einsum's time), plain {r['plain_ms']:.4f}")
    lap("(3) layouts")

    # (4) ms per step on each backend, the torch backend warmed first; one
    # profiled step each
    steps_fn = {b: make_train_step(conf, TrainConfig(opt=opt, remat=True))
                for b, conf in (("kernel", cfg), ("torch", cfg_t))}
    timed_steps(steps_fn["torch"], params, batch, 1)
    runs = {"kernel": [], "torch": []}
    for backend in runs:
        runs[backend] = timed_steps(steps_fn[backend], params, batch, settings["timed_steps"])
        log(f"{tag} [{backend}]: ms per step {', '.join(f'{m:.1f}' for m in runs[backend])}, "
            f"{tokens / (min(runs[backend]) / 1e3):.1f} tokens/s at the fastest")
    ms_step = {b: sorted(v)[len(v) // 2] for b, v in runs.items()}
    profiles = {}
    for backend in ("kernel", "torch"):
        state = adamw_init(params)
        profiles[backend] = profile_device(
            f"one {cfg.arch_id} train step [{backend}]",
            lambda b=backend, st=state: steps_fn[b](params, st, batch, None), top=8,
            kinds=STEP_KINDS)
        del state
    for c, n in zip(counters, saved):
        c.launches = n
    lap("(4) times")
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                launches_per_step=per_step, losses=losses, peak_bytes=peak,
                loss=dict(float32_torch=loss_ref, float32_kernel=loss_k32, bf16_torch=loss_t16,
                          bf16_kernel=loss_k16),
                grad_err={label: max(d.values()) for label, d in (
                    ("float32_kernel", d_k32), ("bf16_torch", d_t16), ("bf16_kernel", d_k16))},
                shapes=rows, per_step=tot, profiles=profiles, ms_per_step=runs,
                tokens_per_s={b: tokens / (ms_step[b] / 1e3) for b in ms_step}, seconds=took)


def layout_rows(keys: dict, gen, dev) -> list:
    """Each recorded launch layout (:func:`recording_launch_keys`) on
    random operands from ``gen``: within ``TOL`` of the plain version,
    bit-identical twice, timed as :func:`time_shapes` times it; its row
    with its ``launches``."""
    rows = []
    for key, (n, layout) in sorted(keys.items(), key=lambda kv: str(kv[0])):
        A, B, kw_ = operands_like(layout, gen, dev)
        row = time_shapes({key: (n, (A, B, kw_))}, reps=3, per="step", summary=False)["rows"][0]
        del A, B
        rows.append(dict(row, launches=n))
    return rows


def ssm_train_path(dev, seed: int, counters) -> dict:
    """Phase 23: mamba2-1.3b at its published widths and depth trained
    through ``Trainer`` on the kernel backend with ``contract_strategy=
    "native"`` (see the module docstring).  Returns ``native_gemm``'s SSM
    training record."""
    from repro_torch.configs import get_config
    from repro_torch.training.data import SyntheticLM

    t_start = time.perf_counter()
    cfg = get_config(SSM_TRAIN["arch"]).with_(**KERNEL_BACKEND)
    per_step = ssm_train_launches_per_step(cfg)
    check(sum(per_step.values()) == 24 * cfg.n_periods + 3,
          f"ssm train: {per_step} is not 6 products a layer x4 (forward, recompute, dX, dW) "
          f"+ 3 for the head")
    s = cfg.ssm
    log(f"ssm train: {cfg.arch_id} {cfg.n_periods} layers (no cut), d_model {cfg.d_model}, "
        f"{s.expand * cfg.d_model // s.headdim} heads of {s.headdim}, d_state {s.d_state}, "
        f"chunk {s.chunk}, vocab {cfg.vocab_size}, tied embeddings; {cfg.dtype} activations over "
        f"{cfg.param_dtype} masters, remat on; {cfg.param_count() / 1e9:.3f}B params; "
        f"{SSM_TRAIN['batch']} x {SSM_TRAIN['seq_len']} tokens a step; kernel backend, "
        f"contract_strategy native; leaves the loss does not reach: "
        f"{sorted(unreached_leaves(cfg))}")

    def data():
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SSM_TRAIN["seq_len"],
                           global_batch=SSM_TRAIN["batch"], seed=seed)

    out = train_at_width(dev, seed, counters, "ssm train", cfg, data, per_step, SSM_TRAIN)
    log(f"ssm train: phase 23 took {time.perf_counter() - t_start:.1f} s: "
        + ", ".join(f"{k} {v} s" for k, v in out["seconds"].items()))
    return out


# ------------------------------------------------------------------ phase 24
#: the hybrid serving cell: jamba-v0.1-52b (src/repro/configs/jamba_v0p1_52b.py)
#: at its published widths, depth cut to ``periods`` periods of 8 layers
#: (one period's f32 masters take 53 GB of the card's 80), on the kernel
#: backend; 8 greedy requests of the prompt lengths below (131 is prime:
#: chunks of 1; 100 one chunk of 100), 16 new tokens each, on 4 slots with
#: whole-prompt prefill.  Prompts stop at 4096: an 8192-token prefill's
#: dense attention needs 22.4 GB of temporaries, which beside the masters
#: leaves no room for the float32 oracle.  ``shape_lens`` are the prefills
#: whose launch layouts are timed (128: one chunk, ``CBt`` on ``stream``)
JAMBA_SERVE = dict(arch="jamba-v0.1-52b", periods=1,
                   prompts=(64, 100, 128, 131, 256, 512, 2048, 4096), max_new=16, slots=4,
                   shape_lens=(128, 512, 4096))


def jamba_serve_path(dev, seed: int, counters) -> dict:
    """Phase 24: jamba-v0.1-52b at its published widths, one period deep,
    through ``ServingRuntime`` on the kernel backend (see the module
    docstring).  Returns ``native_gemm``'s hybrid serving record."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime.engine import ServingRuntime
    from repro_torch.serving.engine import ServeEngine

    t_start = time.perf_counter()
    took, mark = {}, [t_start]

    def lap(label):
        took[label] = round(time.perf_counter() - mark[0], 1)
        mark[0] = time.perf_counter()

    spec = JAMBA_SERVE
    full = get_config(spec["arch"])
    cfg = full.with_(n_periods=spec["periods"], **KERNEL_BACKEND)
    cfg_t = cfg.with_(contract_backend="torch", contract_strategy="auto")
    s, m = cfg.ssm, cfg.moe
    layers = [f"{sp.mixer}+{sp.ff}" for sp in cfg.pattern]
    log(f"jamba: {cfg.arch_id} at published widths, depth cut to {cfg.n_periods} period of "
        f"{len(cfg.pattern)} layers ({len(cfg.pattern) * cfg.n_periods} of "
        f"{len(full.pattern) * full.n_periods}): {', '.join(layers)}; d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; MoE {m.n_experts} experts top-{m.top_k}, d_expert "
        f"{m.d_expert}, capacity factor {m.capacity_factor}; SSD d_state {s.d_state}, headdim "
        f"{s.headdim}, expand {s.expand}, chunk {s.chunk}; {cfg.dtype} activations, "
        f"{cfg.param_dtype} params, contract_backend {cfg.contract_backend}, strategy "
        f"{cfg.contract_strategy}; {cfg.param_count() / 1e9:.3f}B params, "
        f"{cfg.param_count(active_only=True) / 1e9:.3f}B active")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    masters = torch.cuda.memory_allocated(dev) - base
    log(f"jamba: random weights drawn on the card, {masters / 1e9:.2f} GB "
        f"({base / 2**30:.2f} GiB allocated before)")
    max_len = max(spec["prompts"]) + spec["max_new"]
    kw = dict(slots=spec["slots"], max_len=max_len)

    def traffic_of():
        return ssm_traffic(cfg, seed, spec, 24)

    rt = ServingRuntime(cfg, params, **kw)
    check(not rt.lattice.chunked, "jamba: the runtime chunks a hybrid model's prompts")
    with dropped_tokens() as dispatched:
        warm = rt.serve(traffic_of())
    lap("warm-up")

    # the main path, and every prefill and decode pass by its routes
    traffic = traffic_of()
    main = counted_serve("jamba", rt, cfg, traffic, warm, counters)
    seen, counted, routes = main["seen"], main["counted"], main["routes"]
    prefills, decodes, peak, outputs = (main[k] for k in ("prefills", "decodes", "peak",
                                                          "outputs"))
    log(f"jamba: the serve's peak {(peak - masters) / 1e9:.2f} GB above the masters")
    # GShard's drops: a prefill routes its prompt as one group, a decode
    # row its token alone (4 slots an expert for its top-2: none drop)
    drops = {}
    for t, cap, lost, _ in dispatched:
        drops.setdefault(t, []).append((cap, lost))
    check(all(lost == 0 for cap, lost in drops.get(1, [])),
          "jamba: a decode row lost an expert slot")
    for L in spec["prompts"]:
        log(f"jamba: tokens GShard dropped in the prefill of {L} (capacity "
            f"{drops[L][0][0]}), by MoE layer: {[lost for _, lost in drops[L]]}")
    lap("counted serve")

    # (a) each request's prefill logits against the forward's last position
    errs_a = prefill_vs_forward("jamba", cfg, params, traffic, seen, dev)

    # (b) the legacy engine's tokens
    legacy = ServeEngine(cfg, params, **kw).serve(traffic_of())
    check([r.output for r in legacy] == outputs,
          "jamba: the runtime's tokens differ from ServeEngine's (the legacy oracle)")
    del legacy
    log("jamba: (b) tokens equal ServeEngine's")
    lap("(a), (b)")

    # (c) the runtime on the torch backend in bf16 and in float32 (the
    # oracle), each fed the kernel runtime's tokens: every row routes its
    # MoE tokens as the served row did
    kern_out = {r.rid: list(r.output) for r in traffic}

    def fed(conf):
        rt_x, seen_x = ServingRuntime(conf, params, **kw), {}
        with served_events(rt_x, seen_x, [], forced=kern_out):
            done = rt_x.serve(traffic_of())
        check(all(r.output == kern_out[r.rid] for r in done),
              "jamba: a runtime fed the kernel's tokens generated others")
        return rt_x, seen_x

    rt_t, seen_t = fed(cfg_t)
    rt32, ref = fed(cfg_t.with_(dtype="float32"))
    del rt32
    phase_peak = torch.cuda.max_memory_allocated(dev)
    errs = oracle_check("jamba", "(c)", seen, seen_t, ref, kern_out,
                        len(traffic) * spec["max_new"],
                        note=f"phase peak {phase_peak / 1e9:.2f} GB allocated")
    del ref, seen_t
    lap("(c)")

    # (d) every launch layout of three prefills and a 4-slot decode pass
    passes = serve_passes(cfg, params, traffic, spec["shape_lens"], spec["slots"], max_len,
                          dev)
    shapes, per_pass, by_route = pass_layouts("jamba: (d)", passes,
                                              torch.Generator(dev).manual_seed(seed + 24), dev)
    # the expert weights' casts to bf16, made by every MoE layer's call
    j = next(i for i, sp in enumerate(cfg.pattern) if sp.ff == "moe")
    experts = [params["pattern"][j]["moe"][k][0] for k in ("wi", "wg", "wo")]
    cast_bytes = sum(w.numel() * (w.element_size() + 2) for w in experts)
    cast_ms = queued_ms(lambda: [w.to(torch.bfloat16) for w in experts], 3)
    n_moe = cfg.n_periods * sum(sp.ff == "moe" for sp in cfg.pattern)
    cast_bound = bound(cast_bytes, 0, torch.bfloat16)[0]
    log(f"jamba: (d) one MoE layer's expert weight casts to bf16 ({len(experts)} weights, "
        f"{cast_bytes / 1e9:.2f} GB read and written): {cast_ms:.4f} ms queued, bound "
        f"{cast_bound:.4f} ms (bytes); {n_moe} MoE layers: {n_moe * cast_ms:.3f} ms a pass")
    lap("(d)")

    # (e) times: one serve on each backend; a decode pass profiled on each
    saved = [c.launches for c in counters]
    runs = {"kernel": [], "torch": []}
    for backend in runs:
        res = timed_serve(rt if backend == "kernel" else rt_t, traffic_of())
        runs[backend].append(res)
        log(f"jamba [{backend}]: {res['tokens']} tokens in {res['wall_ms']:.1f} ms, "
            f"{res['tokens_per_s']:.2f} tokens/s; ms per prefill by length: "
            f"{', '.join(f'{c}: {v:.3f}' for c, v in res['chunk_ms_by_len'].items())}; "
            f"ms per decode pass by bucket: "
            f"{', '.join(f'{b}: {v:.3f} (x{res['ticks_by_bucket'][b]})' for b, v in res['tick_ms_by_bucket'].items())}")
    check(all(r["outputs"] == outputs for r in runs["kernel"]),
          "jamba: a timed kernel serve gave other tokens")
    profiles = {}
    with torch.no_grad():
        for backend, conf in (("kernel", cfg), ("torch", cfg_t)):
            fn = functools.partial(passes["decode pass"], conf)
            fn()
            profiles[f"{backend} decode pass"] = profile_device(
                f"one jamba decode pass [{backend}]", fn, top=8)
    for c, n in zip(counters, saved):
        c.launches = n
    lap("(e)")
    del rt, rt_t, passes, params, experts
    log(f"jamba: phase 24 took {time.perf_counter() - t_start:.1f} s: "
        + ", ".join(f"{k} {v} s" for k, v in took.items()))
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                prefill_launches_by_route={str(L): prefills[L] for L in spec["prompts"]},
                decode_launches_by_route=decodes[0], prefill_logits_err=errs_a,
                dropped={str(L): [lost for _, lost in drops[L]] for L in spec["prompts"]},
                logits_err={k: v for k, v in errs.items() if k != "rows"},
                peak_bytes=peak, phase_peak_bytes=phase_peak, master_bytes=masters,
                shapes=shapes, shapes_by_route=by_route, per_pass=per_pass,
                moe_cast=dict(ms=cast_ms, bound_ms=cast_bound, bytes=cast_bytes, layers=n_moe),
                profiles=profiles,
                tokens_per_s={b: [r["tokens_per_s"] for r in v] for b, v in runs.items()},
                runs={b: [{k: v for k, v in r.items() if k != "outputs"} for r in rs]
                      for b, rs in runs.items()},
                seconds=took)


# ------------------------------------------------------------------ phase 25
#: the sliding-window cell: gemma2-27b (src/repro/configs/gemma2_27b.py) at
#: its published widths, depth cut from 46 layers to ``periods`` periods of a
#: local layer (window 4096) and a global one, on the kernel backend; 8
#: greedy requests of the prompt lengths below (4095 crosses the window
#: while decoding, 4097 drops key 0 at its last prompt token, 8192 fills
#: Gemma 2's context), 16 new tokens each, on 4 slots with chunked prefill
#: in chunks of up to ``chunk`` tokens, unpaged and off the page pool
#: (``page_size``-row pages, the default pool).  Traced on fake tensors at 16
#: layers, a whole 8192-token prompt peaks under 75 GB (1e9) beside the
#: masters, in ``transformer.forward`` and in the legacy engine's prefill
#: (``tests/test_torch_gemma2_serve.py``), so (c) and (d) run at every
#: prompt; the phase runs 8 layers (16 until phase 28 took its time), its
#: checks unchanged
GEMMA_SERVE = dict(arch="gemma2-27b", periods=4,
                   prompts=(64, 511, 2048, 4095, 4096, 4097, 6000, 8192), max_new=16,
                   slots=4, chunk=512, page_size=16)


def layer0_filled(conf, params, toks, rows: int, max_len: int, window, dev) -> tuple:
    """Layer 0 of the first pattern entry on the last ``rows`` positions of
    ``toks`` (1, L): its attention params, its normed input there and its
    KV cache of ``max_len`` rows filled by the positions before, in chunks
    of ``rows`` (``window`` on every chunk)."""
    from repro_torch.models import layers
    from repro_torch.models.tree import tree_map

    L, G, D = toks.shape[1], conf.n_kv_heads, conf.hd
    layer = tree_map(lambda t: t[0], params["pattern"][0])
    dt = conf.activation_dtype()
    h = layers.rms_norm(params["embed"][toks].to(dt), layer["norm1"], conf.rms_eps)
    cache = {"k": torch.zeros((1, max_len, G, D), dtype=dt, device=dev),
             "v": torch.zeros((1, max_len, G, D), dtype=dt, device=dev),
             "length": torch.zeros((), dtype=torch.int32, device=dev)}
    for start in range(0, L - rows, rows):
        _, cache = layers.attention(conf, layer["attn"], h[:, start:start + rows],
                                    positions=torch.arange(start, start + rows, device=dev),
                                    window=window, kv_cache=cache)
    return layer["attn"], h[:, L - rows:], cache


def layer0_last(conf, attn, h, cache, L: int, window, dev):
    """Layer 0's attention output (float32) at the query rows ``h`` that
    end at position ``L``, against ``cache``."""
    from repro_torch.models import layers

    out, _ = layers.attention(conf, attn, h, positions=torch.arange(L - h.shape[1], L, device=dev),
                              window=window, kv_cache=cache)
    return out.float()


def layer_drops(tag: str, drops: list, n_moe: int, label: str, lens: dict) -> dict:
    """The tokens GShard dropped in a serve's passes (:func:`served_events`'
    ``drops``), by MoE layer: ``{label: {prompt length: [[lost a layer] a
    prefill]}, label + " decode": [[lost a layer] a pass]}``.  Each pass
    must dispatch once a MoE layer, and no decode row may lose a slot (one
    token's top-k in a group of its own)."""
    prefills, decodes, groups = {}, [], {}
    for kind, rid, size, seen in drops:
        check(len(seen) == n_moe, f"{tag}: a {kind} of {size} dispatched {len(seen)} times, "
                                  f"not once in each of {n_moe} MoE layers")
        lost = [n for _, _, n, _ in seen]
        if kind == "decode":
            decodes.append(lost)
        else:
            prefills.setdefault(lens[rid], []).append(lost)
            groups.setdefault(lens[rid], set()).update((t, cap) for t, cap, *_ in seen)
    bad = [lost for lost in decodes if any(lost)]
    check(not bad, f"{tag}: a decode pass dropped tokens {bad}")
    for L, passes in sorted(prefills.items()):
        log(f"{tag}: tokens GShard dropped by MoE layer in the prefill of {L} in "
            f"{len(passes)} {label} pass{'es' if len(passes) > 1 else ''} (groups of (tokens, "
            f"capacity) {sorted(groups[L])}): {passes if len(passes) > 1 else passes[0]}")
    log(f"{tag}: {len(decodes)} decode passes, none dropped a token")
    return {label: prefills, f"{label} decode": decodes}


def cast_weights(cfg, params) -> list:
    """Every weight one pass casts from its f32 master to bf16, each as
    its call casts it: the head, and each layer's attention projections,
    dense MLP, routed experts (each stacked over the experts: one cast)
    and shared experts (one MLP each); the router stays float32."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    out = [head]
    for blk in params["pattern"]:
        for i in range(cfg.n_periods):
            out += [w[i] for w in (*blk.get("attn", {}).values(), *blk.get("mlp", {}).values())]
            if "moe" in blk:
                m = blk["moe"]
                out += [m[k][i] for k in ("wi", "wg", "wo") if k in m]
                out += [w for ws in m.get("shared", {}).values() for w in ws[i]]
    return out


def weight_casts(cfg, params) -> dict:
    """What a pass pays besides its products to cast its weights: each of
    :func:`cast_weights`' weights cast to bf16 once, queued, against the
    byte bound of reading its f32 master and writing the bf16 copy."""
    weights = cast_weights(cfg, params)
    nbytes = sum(w.numel() * (w.element_size() + 2) for w in weights)

    def cast_all():
        for w in weights:
            w.to(torch.bfloat16)

    return dict(ms=queued_ms(cast_all, 2), bound_ms=bound(nbytes, 0, torch.bfloat16)[0],
                bytes=nbytes, weights=len(weights))


def profile_passes(tag: str, passes: dict, confs: dict, kinds: dict | None = None) -> dict:
    """One call of each pass in ``passes`` (name to a function of the
    config) on each config of ``confs`` (backend to config) under the
    profiler (:func:`profile_device`, its ``kinds``), keyed ``"{backend}
    {pass}"``."""
    out = {}
    with torch.no_grad():
        for name, run in passes.items():
            for backend, conf in confs.items():
                out[f"{backend} {name}"] = profile_device(
                    f"one {tag} {name} [{backend}]", functools.partial(run, conf), top=8,
                    kinds=kinds)
    return out


def serve_at_width(dev, seed: int, counters, tag: str, phase: int, cfg, spec: dict,
                   probe) -> dict:
    """The serving checks of phases 25, 27 and 28: ``cfg`` (published
    widths, the kernel backend) with random weights from ``seed`` through
    ``ServingRuntime(slots, max_len, prefill_chunk=spec["chunk"])`` on the
    greedy requests of ``spec``'s prompts (drawn from ``seed + phase``),
    ``max_len`` the longest prompt plus ``max_new`` rounded up to a
    multiple of 16 (bf16 cache rows a tensor map reads): (a) a warm-up
    serve, the counted serve and the paged serve (:func:`counted_serve`:
    every chunk and decode pass by the routes :func:`ssm_routes` derives
    from the layer pattern); (b) the phase's own check, ``probe(params,
    toks, max_len)`` on the longest prompt's tokens ``toks`` (1, L), whose
    dict joins the record; (d) ``ServeEngine``'s tokens; (e) the float32
    oracle (on ``spec["oracle_slots"]`` slots where given: the same rows,
    a smaller cache); (c) each served prefill against ``forward``; (f)
    every launch layout of the longest prompt's last chunk and of a decode
    pass, the weights' casts and one layer's cache rewrite; (g) the times,
    decode-pass profiles and peaks by stage.

    A MoE stack's chunked prefill routes each chunk's tokens as dispatch
    groups of their own (in the JAX package's runtime too), so its
    capacity drops other tokens than a whole prompt's: for such a stack
    (c) and (d) hold a serve through ``ServingRuntime(...,
    chunked_prefill=False)`` (whole-prompt prefill, as ``forward`` and
    ``ServeEngine`` route) and the chunked serve only at prompts of one
    chunk (its tokens, and its prefill against ``forward``); elsewhere the
    chunked prefill's distance from ``forward`` is logged beside the
    tokens GShard dropped, every MoE layer's, in each chunk (the warm-up
    serve's, the counted serve's passes), each whole-prompt prefill and
    each decode pass (none may drop).  Returns ``native_gemm``'s serving
    record."""
    from repro_torch.models import layers, transformer
    from repro_torch.runtime.buckets import chunk_schedule
    from repro_torch.runtime.engine import ServingRuntime, slot_cache
    from repro_torch.serving.engine import ServeEngine

    t_start = time.perf_counter()
    took, mark = {}, [t_start]

    def lap(label):
        took[label] = round(time.perf_counter() - mark[0], 1)
        mark[0] = time.perf_counter()

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    cfg_t = cfg.with_(contract_backend="torch", contract_strategy="auto")
    cfg32 = cfg_t.with_(dtype="float32")
    G, D = cfg.n_kv_heads, cfg.hd
    regroups = any(sp.ff == "moe" for sp in cfg.pattern)
    n_moe = cfg.n_periods * sum(sp.ff == "moe" for sp in cfg.pattern)
    release()
    base = torch.cuda.memory_allocated(dev)
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    masters = torch.cuda.memory_allocated(dev) - base
    log(f"{tag}: random weights drawn on the card, {masters / 1e9:.2f} GB "
        f"({base / 2**30:.2f} GiB allocated before)")
    max_len = -(-(max(spec["prompts"]) + spec["max_new"]) // 16) * 16
    kw = dict(slots=spec["slots"], max_len=max_len, prefill_chunk=spec["chunk"])
    peaks = {}

    def traffic_of(prompts=spec["prompts"]):
        return [r for r in ssm_traffic(cfg, seed, spec, phase) if len(r.prompt) in prompts]

    t0 = time.perf_counter()
    rt = ServingRuntime(cfg, params, **kw)
    torch.cuda.synchronize()
    check(rt.lattice.chunked and rt.lattice.max_chunk == spec["chunk"],
          f"{tag}: the runtime's lattice {rt.lattice.describe()}")
    log(f"{tag}: runtime built, every lattice point {rt.lattice.describe()} run once in "
        f"{time.perf_counter() - t0:.1f} s")
    # a warm-up serve, whose tokens the counted serve must repeat; without
    # it (``spec["warm_up"]`` false) the runtime's build has run every
    # lattice point, every bucket entry is built here, and the paged serve
    # repeats the counted serve's tokens
    warm = None
    if spec.get("warm_up", True):
        warm = rt.serve(traffic_of())
        lap("warm-up")
    else:
        rt.precompile_buckets()

    # (a) the main path: every prefill chunk and decode pass by its routes
    traffic = traffic_of()
    main = counted_serve(tag, rt, cfg, traffic, warm, counters)
    seen, counted, routes, decodes, outputs = (main[k] for k in (
        "seen", "counted", "routes", "decodes", "outputs"))
    runs = {"kernel": main["timed"]}
    peaks["serve"] = main["peak"]
    per_pass = ssm_routes(cfg)
    n_pass = sum(per_pass.values())
    schedule = {L: chunk_schedule(L, rt.lattice.chunk_buckets) for L in spec["prompts"]}
    n_chunks = sum(map(len, schedule.values()))
    check(main["n_prefills"] == n_chunks
          and counted["native_gemm"] == n_pass * (n_chunks + len(decodes)),
          f"{tag}: {counted['native_gemm']} launches over {main['n_prefills']} chunks and "
          f"{len(decodes)} decode passes, not {n_pass} a pass over {n_chunks} chunks")
    log(f"{tag}: (a) {n_chunks} prefill chunks ({', '.join(f'{L}: {len(c)}' for L, c in schedule.items())} "
        f"by prompt) and {len(decodes)} decode passes, each {n_pass} launches {per_pass}: "
        f"{counted['native_gemm']} in all, the {max(spec['prompts'])}-token prompt's "
        f"{n_pass * len(schedule[max(spec['prompts'])])}; the serve's peak "
        f"{(main['peak'] - masters) / 1e9:.2f} GB above the masters")
    lens = {r.rid: len(r.prompt) for r in traffic}
    del rt
    release()
    lap("counted serve")

    # (a) off the page pool: the unpaged serve's tokens, a whole pool, no
    # bucket entry built after the warm-up (every lattice entry built; the
    # kernels and programs warm from the unpaged serves)
    t0 = time.perf_counter()
    rt_p = ServingRuntime(cfg, params, paged=True, page_size=spec["page_size"],
                          precompile=False, **kw)
    entries = rt_p.precompile_buckets()
    log(f"{tag} paged: pool of {rt_p.pool.usable} usable pages x {rt_p.pool.page_size} rows, "
        f"lattice {rt_p.lattice.describe()}; built with its {entries} bucket entries in "
        f"{time.perf_counter() - t0:.1f} s")
    # the paged serve, untimed, records every pass's GShard drops (one host
    # read a MoE layer): its chunks and decode passes are the counted serve's
    traffic_p, drops = traffic_of(), []
    paged = counted_serve(f"{tag} paged", rt_p, cfg, traffic_p, traffic, counters,
                          drops=drops if regroups else None)
    dropped = layer_drops(tag, drops, n_moe, "chunk", lens) if regroups else {}
    peaks["paged serve"] = paged["peak"]
    check_pool_whole(rt_p, f"{tag} paged serve")
    stats = rt_p.pool.stats()
    log(f"{tag} paged: tokens equal the unpaged serve's; pool whole after the drain "
        f"({stats['pages_free']} of {stats['pages_total']} free, {stats['page_allocs']} "
        f"allocations); bucket entries {rt_p.buckets.compiles}, none built by the counted "
        f"serve; {paged['counted']['native_gemm']} launches by route {paged['routes']}")
    del rt_p
    release()
    lap("paged serves")

    # (b) the phase's own check on the longest prompt
    L = max(spec["prompts"])
    rows = spec["chunk"]
    toks = torch.as_tensor(next(r.prompt for r in traffic if len(r.prompt) == L),
                           device=dev)[None].long()
    found = probe(params, toks, max_len)
    release()
    lap("(b)")

    # a MoE stack: the same traffic with whole-prompt prefill, which (c)
    # and (d) hold (it routes each prompt as forward and ServeEngine do)
    whole, seen_w = outputs, seen
    if regroups:
        torch.cuda.reset_peak_memory_stats()
        rt_w = ServingRuntime(cfg, params, chunked_prefill=False, precompile=False,
                              slots=spec["slots"], max_len=max_len)
        traffic_w, seen_w, events_w, drops_w = traffic_of(), {}, [], []
        with served_events(rt_w, seen_w, events_w, drops=drops_w):
            rt_w.serve(traffic_w)
        peaks["whole-prompt runtime"] = torch.cuda.max_memory_allocated()
        whole = [r.output for r in traffic_w]
        for kind, size, by in events_w:
            check(by == per_pass, f"{tag}: a whole-prompt {kind} of {size} launched by route "
                                  f"{by}, not {per_pass}")
        check(sorted(size for kind, size, _ in events_w if kind == "prefill")
              == sorted(lens.values()), f"{tag}: the whole-prompt runtime's prefills")
        dropped |= layer_drops(f"{tag} whole-prompt", drops_w, n_moe, "whole", lens)
        one = [(r, w) for r, w in zip(traffic, traffic_w) if len(schedule[len(r.prompt)]) == 1]
        differ = [r.rid for r, w in one if r.output != w.output]
        check(not differ, f"{tag}: at prompts of one chunk the chunked serve's tokens differ "
                          f"from the whole-prompt serve's for requests {differ}")
        log(f"{tag}: whole-prompt runtime (chunked_prefill=False): {len(events_w)} passes, "
            f"each {per_pass}; tokens equal the chunked serve's at the prompts of one chunk "
            f"({', '.join(str(len(r.prompt)) for r, _ in one)}), differ at "
            f"{sum(o != w for o, w in zip(outputs, whole))} of {len(traffic)} requests; its "
            f"peak {peaks['whole-prompt runtime'] / 1e9:.2f} GB allocated")
        del rt_w
        release()
        lap("whole-prompt serve")

    # (d) the legacy engine's tokens (whole-prompt prefill beside its
    # 4-slot cache)
    torch.cuda.reset_peak_memory_stats()
    legacy = ServeEngine(cfg, params, slots=spec["slots"], max_len=max_len).serve(traffic_of())
    peaks["legacy"] = torch.cuda.max_memory_allocated()
    check([r.output for r in legacy] == whole,
          f"{tag}: the {'whole-prompt ' if regroups else ''}runtime's tokens differ from "
          f"ServeEngine's (the legacy oracle)")
    log(f"{tag}: (d) the {'whole-prompt ' if regroups else ''}runtime's tokens equal "
        f"ServeEngine's (whole-prompt prefill, the 4-slot cache held) at every prompt; its "
        f"peak {peaks['legacy'] / 1e9:.2f} GB allocated")
    del legacy
    release()
    lap("(d)")

    # (e) the runtime on the torch backend in bf16 (its fed serve, timed as
    # the kernel's counted serve is, gives the torch backend's times) and in
    # float32 (the oracle), each fed the kernel runtime's tokens, one cache
    # on the card at a time
    kern_out = {r.rid: list(r.output) for r in traffic}

    def fed(conf, timed, slots=spec["slots"]):
        rt_x, seen_x, reqs = ServingRuntime(conf, params, precompile=False,
                                            **(kw | dict(slots=slots))), {}, traffic_of()
        with served_events(rt_x, seen_x, [], forced=kern_out):
            res = timed_serve(rt_x, reqs) if timed else rt_x.serve(reqs)
        check(all(r.output == kern_out[r.rid] for r in reqs),
              f"{tag}: a runtime fed the kernel's tokens generated others")
        return (res if timed else None), seen_x

    runs["torch"], seen_t = fed(cfg_t, True)
    release()
    torch.cuda.reset_peak_memory_stats()
    _, ref = fed(cfg32, False, spec.get("oracle_slots", spec["slots"]))
    peaks["float32 oracle"] = torch.cuda.max_memory_allocated()
    release()
    errs = oracle_check(
        tag, "(e)", seen, seen_t, ref, kern_out, len(traffic) * spec["max_new"],
        note=f"the float32 runtime ({spec.get('oracle_slots', spec['slots'])} slots) peaked "
             f"at {peaks['float32 oracle'] / 1e9:.2f} GB allocated")
    del ref, seen_t
    lap("(e)")

    # (c) each served prefill (a MoE stack's: the whole-prompt serve's)
    # against transformer.forward's last position, the longest last,
    # nothing else on the card
    fwd_peaks = {}
    ordered = sorted(traffic_of(), key=lambda r: len(r.prompt))
    chunked_c, routed = {}, {}
    if not regroups:
        errs_c = prefill_vs_forward(tag, cfg, params, ordered, seen, dev, fwd_peaks, "(c)")
    else:
        errs_c, chunked_c, routed = prefill_vs_forward(
            tag, cfg, params, ordered, seen_w, dev, fwd_peaks, "(c)", beside=seen,
            routing={rid: [rt_[3] for rt_ in seen_d] for kind, rid, _, seen_d in drops_w
                     if kind == "prefill"})
        # at a prompt of one chunk the chunked serve routes as the whole
        # prompt: its prefill logits the whole-prompt serve's
        one = {lens[rid]: mag_err(seen[(rid, 0)], seen_w[(rid, 0)]) for rid in lens
               if len(schedule[lens[rid]]) == 1}
        check(max(one.values()) <= TOL[torch.bfloat16],
              f"{tag}: the chunked serve's prefill logits of one-chunk prompts against the "
              f"whole-prompt serve's {one} (limit {TOL[torch.bfloat16]})")
        log(f"{tag}: (c) the chunked serve's prefill logits at the prompts of one chunk "
            f"against the whole-prompt serve's: "
            + ", ".join(f"{L}: {e:.3g}" for L, e in one.items()))
        for L, e in chunked_c.items():
            n = len(schedule[L])
            log(f"{tag}: (c) the chunked serve's prefill of {L} ("
                f"{f'{n} chunks' if n > 1 else 'one chunk'}) against forward's last "
                f"position: {e:.3g} of the largest magnitude; tokens GShard dropped, summed "
                f"over the {n_moe} MoE layers: in its chunks "
                f"{[sum(c) for c in dropped['chunk'][L]]}, in its whole prompt "
                f"{sum(dropped['whole'][L][0])}")
    peaks["forward"] = max(fwd_peaks.values())
    log(f"{tag}: (c) forward's peak by prompt length, allocated: "
        + ", ".join(f"{n}: {p / 1e9:.2f}" for n, p in fwd_peaks.items()) + " GB")
    release()
    lap("(c)")

    # (f) every launch layout of the longest prompt's last chunk and of a
    # 4-slot decode pass at the cache's full width
    scratch = slot_cache(cfg, spec["slots"], max_len, device=dev)
    toks4 = torch.zeros((spec["slots"], 1), dtype=torch.long, device=dev)

    def chunk_pass(conf=cfg):
        cache = transformer.init_cache(conf, 1, max_len, device=dev)
        for leaf in (cache["length"], *(c["length"] for c in cache["pattern"])):
            leaf.fill_(L - rows)
        return transformer.prefill(conf, params, {"tokens": toks[:, L - rows:]}, cache)

    passes = {f"prefill chunk of {rows} at {L - rows}": chunk_pass,
              "decode pass": lambda conf=cfg: transformer.decode_step(conf, params, scratch,
                                                                      toks4)}
    shapes, per_pass_t, by_route = pass_layouts(
        f"{tag}: (f)", passes, torch.Generator(dev).manual_seed(seed + phase), dev)
    # what a pass pays besides its products: every weight's cast to bf16
    # (dense() and moe_ffn cast their f32 masters on every call; the head
    # first), and one layer's out-of-place cache write (_write_rows) of a
    # decode pass
    casts = weight_casts(cfg, params)
    k0 = scratch["pattern"][0]["k"][0]
    new = torch.zeros((spec["slots"], 1, G, D), dtype=k0.dtype, device=dev)
    at = torch.full((spec["slots"],), L, dtype=torch.int32, device=dev)
    write_ms = queued_ms(lambda: layers._write_rows(k0, new, at), 5)
    write_bound = bound(2 * k0.numel() * k0.element_size(), 0, torch.bfloat16)[0]
    n_writes = 2 * len(cfg.pattern) * cfg.n_periods
    log(f"{tag}: (f) the casts of the {casts['weights']} weights a pass to bf16 "
        f"({casts['bytes'] / 1e9:.2f} GB read and written): {casts['ms']:.3f} ms queued, bound "
        f"{casts['bound_ms']:.3f} ms (bytes); one layer's K cache rewrite in a decode pass "
        f"(_write_rows, {tuple(k0.shape)}): {write_ms:.4f} ms queued, bound {write_bound:.4f} "
        f"ms; x{n_writes} a pass: {n_writes * write_ms:.3f} ms")
    del new
    lap("(f)")

    # (g) the timed serves (the kernel's counted serve, the torch backend's
    # fed serve: both record every row's logits on the host); where a decode
    # pass spends device time on each backend (both paths warm from the
    # serves)
    for backend, res in runs.items():
        log(f"{tag} [{backend}]: {res['tokens']} tokens in {res['wall_ms']:.1f} ms, "
            f"{res['tokens_per_s']:.2f} tokens/s; ms per prefill by prompt length (its "
            f"chunks summed): "
            f"{', '.join(f'{n}: {v:.1f}' for n, v in res['prefill_ms_by_prompt'].items())}; "
            f"ms per chunk by length: "
            f"{', '.join(f'{c}: {v:.2f}' for c, v in res['chunk_ms_by_len'].items())}; "
            f"ms per decode pass by bucket: "
            f"{', '.join(f'{b}: {v:.2f} (x{res['ticks_by_bucket'][b]})' for b, v in res['tick_ms_by_bucket'].items())}")
    profiles = profile_passes(tag, {"decode pass": passes["decode pass"]},
                              {"kernel": cfg, "torch": cfg_t})
    del scratch, passes, params, k0
    release()
    lap("(g)")
    log(f"{tag}: peaks allocated by stage: "
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in peaks.items())
        + f"; phase {phase} took {time.perf_counter() - t_start:.1f} s: "
        + ", ".join(f"{k} {v} s" for k, v in took.items()))
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                launches_per_pass=per_pass, prefill_chunks=n_chunks, decode_passes=len(decodes),
                paged_launches=paged["counted"]["native_gemm"],
                paged_launches_by_route=paged["routes"], **found, prefill_logits_err=errs_c,
                chunked_prefill_logits_err=chunked_c, forward_routing=routed, dropped=dropped,
                logits_err={k: v for k, v in errs.items() if k != "rows"},
                peak_bytes=peaks, master_bytes=masters, forward_peak_bytes=fwd_peaks,
                shapes=shapes, shapes_by_route=by_route, per_pass=per_pass_t,
                weight_cast=casts,
                cache_write=dict(ms=write_ms, bound_ms=write_bound, per_pass=n_writes),
                profiles=profiles,
                tokens_per_s={b: r["tokens_per_s"] for b, r in runs.items()},
                runs={b: {k: v for k, v in r.items() if k != "outputs"}
                      for b, r in runs.items()},
                seconds=took)


def gemma2_serve_path(dev, seed: int, counters) -> dict:
    """Phase 25: gemma2-27b at its published widths, 8 of 46 layers,
    through ``ServingRuntime`` with chunked prefill, unpaged and paged, on
    the kernel backend (:func:`serve_at_width`; its (b) is the window at
    width).  Returns ``native_gemm``'s sliding-window serving record."""
    from repro_torch.configs import get_config

    spec = GEMMA_SERVE
    full = get_config(spec["arch"])
    cfg = full.with_(n_periods=spec["periods"], **KERNEL_BACKEND)
    cfg32 = cfg.with_(contract_backend="torch", contract_strategy="auto", dtype="float32")
    local = cfg.pattern[0].window
    check(local is not None and cfg.pattern[1].window is None
          and max(spec["prompts"]) - spec["chunk"] >= local,
          f"gemma2: the pattern's windows {[sp.window for sp in cfg.pattern]}: the last "
          f"chunk of the longest prompt must drop keys on the local layer")
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    log(f"gemma2: {cfg.arch_id} at published widths, depth cut from "
        f"{len(full.pattern) * full.n_periods} layers to {len(cfg.pattern) * cfg.n_periods} "
        f"({cfg.n_periods} periods of a local layer, window {local}, and a global one); "
        f"d_model {cfg.d_model}, {H} query heads over {G} KV heads of {D} (query width "
        f"{H * D}), d_ff {cfg.d_ff} ({cfg.mlp_act}), vocab {cfg.vocab_size} tied "
        f"{cfg.tie_embeddings}, softcaps {cfg.attn_softcap:g} (attention) and "
        f"{cfg.final_softcap:g} (logits); {cfg.dtype} activations, {cfg.param_dtype} params, "
        f"contract_backend {cfg.contract_backend}, strategy {cfg.contract_strategy}; "
        f"{cfg.param_count() / 1e9:.3f}B params")

    def window_check(params, toks, max_len):
        # (b) the window at width: layer 0 (local) at the longest prompt's
        # last chunk of query rows, after the rows before it filled its cache
        L, rows = toks.shape[1], spec["chunk"]
        with torch.no_grad():
            attn, h, cache = layer0_filled(cfg, params, toks, rows, max_len, local, dev)
            out_k = layer0_last(cfg, attn, h, cache, L, local, dev)
            out_none = layer0_last(cfg, attn, h, cache, L, None, dev)
            attn, h, cache = layer0_filled(cfg32, params, toks, rows, max_len, local, dev)
            out_32 = layer0_last(cfg32, attn, h, cache, L, local, dev)
            del h, cache
        e_win, e_none = mag_err(out_k, out_32), mag_err(out_none, out_32)
        check(e_win <= TOL[torch.bfloat16] and e_none > 10 * e_win,
              f"gemma2: (b) layer 0's attention at rows {L - rows}-{L - 1}: the kernel's "
              f"{e_win} from float32 (limit {TOL[torch.bfloat16]}), without the window "
              f"{e_none} (must exceed 10x the kernel's)")
        log(f"gemma2: (b) layer 0 (window {local}) attention at query rows {L - rows}-{L - 1} "
            f"of the {L}-token prompt (each row drops {L - rows - local + 1}-{L - local} keys) "
            f"against the float32 torch backend's, of its largest magnitude: kernel backend "
            f"{e_win:.3g} (limit {TOL[torch.bfloat16]:g}); the same layer with window=None "
            f"{e_none:.3g} ({e_none / max(e_win, 1e-30):.0f}x the kernel's; must exceed 10x)")
        return dict(window_err=dict(kernel=e_win, no_window=e_none))

    return serve_at_width(dev, seed, counters, "gemma2", 25, cfg, spec, window_check)


# ------------------------------------------------------------------ phase 26
#: the encoder-only training cell: hubert-xlarge (src/repro/configs/
#: hubert_xlarge.py) at its published widths and depth (48 layers, no
#: cut), ``batch`` crops of ``seq_len`` frames a step: fairseq's HuBERT
#: pretraining crop cap, 250000 samples at 16 kHz, after the wav2vec 2.0
#: conv stack (strides 5,2,2,2,2,2,2; kernels 10,3,3,3,3,2,2); the oracle's
#: limits as phase 23's; phase 13's warmup and schedule at a tenth of its
#: lr, since at 1e-3 both backends' losses climb alike for 5 steps (to 17.0
#: at step 4) before they fall; ``aligned_len`` frames, whose bf16
#: probability rows are a multiple of 16 bytes, time the attention layouts
#: once more
HUBERT_TRAIN = dict(arch="hubert-xlarge", seq_len=781, batch=4, steps=6, timed_steps=1,
                    top_shapes=8, f32_tol=1e-3, bf16_floor=5e-2, loss_tol=2e-2, lr=1e-4,
                    aligned_len=768)


def hubert_train_launches_per_step(cfg, seq_len: int, batch: int = 1) -> dict:
    """``native_gemm`` launches of one kernel-backend train step of an
    encoder-only attention stack fed by an audio frontend, ``batch`` crops
    of ``seq_len`` frames, by route, derived from the model.  A layer's Q,
    K, V, O and its 2 (gelu) or 3 (swiglu) MLP products on ``wgmma``, each
    launched in the forward, in remat's recompute (the down projection
    too: the recompute stops only after an autograd Function's forward has
    launched, ROADMAP C2b) and twice in the backward (dX, and dW whose
    ``b`` and ``s`` fuse).  Its attention: the scores in the forward and
    the recompute and dP (scores-shaped, from dO and V) on ``batched``;
    P.V in the forward and the recompute, and the three backward products
    that read P or dS (dV, dQ, dK) on the route ``native_route`` gives
    P.V on a bf16 probability tensor of ``seq_len`` keys: ``batched``
    where a row is a multiple of 16 bytes, ``gathered`` where no tensor
    map reads it.  The frontend's projection twice (forward and dW: the
    features need no gradient), the untied head three times."""
    from repro_torch.kernels.sb_gemm import native_route

    G, D, S = cfg.n_kv_heads, cfg.hd, seq_len
    probs = torch.empty((batch, G, cfg.n_heads // G, S, S), dtype=torch.bfloat16, device="meta")
    v = torch.empty((batch, S, G, D), dtype=torch.bfloat16, device="meta")
    pv = native_route(probs, v, a_modes="bgrst", b_modes="btgd", c_modes="bsgrd")
    ff = 3 if cfg.mlp_act == "swiglu" else 2
    n = cfg.n_periods
    attn = n * sum(s.mixer == "attn" for s in cfg.pattern)
    dense = n * sum(s.ff == "dense" for s in cfg.pattern)
    routes = Counter({"wgmma": 4 * (4 * attn + ff * dense) + 2 + 3, "batched": 3 * attn})
    routes[pv] += 5 * attn
    return {r: k for r, k in routes.items() if k}


def hubert_train_path(dev, seed: int, counters) -> dict:
    """Phase 26: hubert-xlarge at its published widths and depth trained
    through ``Trainer`` on the kernel backend with ``contract_strategy=
    "native"`` (phase 23's checks, :func:`train_at_width`), then every
    attention layout of a step at ``aligned_len`` frames against the same
    product at ``seq_len``, and one layer's weight casts (see the module
    docstring).  Returns ``native_gemm``'s encoder training record."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.trainer import value_and_grad

    t_start = time.perf_counter()
    cfg = get_config(HUBERT_TRAIN["arch"]).with_(**KERNEL_BACKEND)
    S, B = HUBERT_TRAIN["seq_len"], HUBERT_TRAIN["batch"]
    per_step = hubert_train_launches_per_step(cfg, S, B)
    check(sum(per_step.values()) == 32 * cfg.n_periods + 5,
          f"hubert train: {per_step} is not 8 products a layer x4 (forward, recompute, dX, dW) "
          f"+ 2 for the frontend + 3 for the head")
    fe = cfg.frontend
    log(f"hubert train: {cfg.arch_id} {cfg.n_periods} layers (no cut), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff} ({cfg.mlp_act}), vocab "
        f"{cfg.vocab_size} untied, bidirectional (causal {cfg.causal}, encoder_only "
        f"{cfg.encoder_only}), {fe.kind} frontend from {fe.feature_dim}-d frames; {cfg.dtype} "
        f"activations over {cfg.param_dtype} masters, remat on; {cfg.param_count() / 1e9:.3f}B "
        f"params; {B} x {S} frames a step; kernel backend, contract_strategy native; launches "
        f"a step {per_step}; leaves the loss does not reach: {sorted(unreached_leaves(cfg))}")

    def data(seq_len=S):
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=B, seed=seed,
                           with_features=(fe.n_positions or None, fe.feature_dim), labels=True)

    out = train_at_width(dev, seed, counters, "hubert train", cfg, data, per_step, HUBERT_TRAIN)
    t0 = time.perf_counter()

    # (5) the attention layouts again at aligned_len frames, from one layer
    # (each layer's are the same), and one layer's weight casts to bf16
    one = cfg.with_(n_periods=1)
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), one)
    T = HUBERT_TRAIN["aligned_len"]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data(T)).items()}
    saved = [c.launches for c in counters]
    with recording_launch_keys() as keys:
        value_and_grad(one, params, batch)
        torch.cuda.synchronize()
    for c, n in zip(counters, saved):
        c.launches = n
    attn = {k: v for k, v in keys.items() if "t" in k[0] + k[1]}     # t: the key frames
    n_attn = sum(n for n, _ in attn.values())
    check(n_attn == 8, f"hubert train: {n_attn} attention launches a layer at {T} frames")
    aligned = layout_rows(attn, torch.Generator(dev).manual_seed(seed + 26), dev)
    check({r["route"] for r in aligned} == {"batched"},
          f"hubert train: attention at {T} frames took {sorted({r['route'] for r in aligned})}")
    crop = [r for r in out["shapes"] if "t" in r["spec"].split("->")[0]]
    compare = {}
    for spec in sorted({r["spec"] for r in crop}):
        compare[spec] = {}
        for k, rs, layers in (("crop", crop, cfg.n_periods), ("aligned", aligned, 1)):
            mine = [r for r in rs if r["spec"] == spec]
            compare[spec][k] = dict(routes=sorted({r["route"] for r in mine}),
                                    **{m: sum(r["launches"] * r[m] for r in mine) / layers
                                       for m in ("ms", "bound_ms", "library_ms", "plain_ms")})
        c, a = compare[spec]["crop"], compare[spec]["aligned"]
        log(f"hubert train: (5) {spec} a layer: {S} frames {c['routes']} {c['ms']:.4f} ms "
            f"({100 * c['bound_ms'] / c['ms']:.1f}% of bound {c['bound_ms']:.4f}; einsum "
            f"{c['library_ms']:.4f}), {T} frames {a['routes']} {a['ms']:.4f} ms "
            f"({100 * a['bound_ms'] / a['ms']:.1f}% of bound {a['bound_ms']:.4f}; einsum "
            f"{a['library_ms']:.4f})")
    layer = params["pattern"][0]
    weights = [w for w in (*layer["attn"].values(), *layer["mlp"].values()) if w.ndim == 3]
    cast_bytes = sum(w.numel() * (w.element_size() + 2) for w in weights)
    cast_ms = queued_ms(lambda: [w.to(torch.bfloat16) for w in weights], 3)
    cast_bound = bound(cast_bytes, 0, torch.bfloat16)[0]
    log(f"hubert train: (5) one layer's {len(weights)} weight casts to bf16 "
        f"({cast_bytes / 1e9:.3f} GB read and written) {cast_ms:.4f} ms queued, bound "
        f"{cast_bound:.4f} ms (bytes); in the forward and the recompute of {cfg.n_periods} "
        f"layers: {2 * cfg.n_periods * cast_ms:.2f} ms a step")
    del params, batch
    out["seconds"]["(5) aligned"] = round(time.perf_counter() - t0, 1)
    log(f"hubert train: phase 26 took {time.perf_counter() - t_start:.1f} s: "
        + ", ".join(f"{k} {v} s" for k, v in out["seconds"].items()))
    return dict(out, aligned_shapes=aligned, attention=compare,
                weight_cast=dict(ms=cast_ms, bound_ms=cast_bound, bytes=cast_bytes,
                                 per_step=2 * cfg.n_periods))


# ------------------------------------------------------------------ phase 27
#: the multi-query cell: granite-20b (src/repro/configs/granite_20b.py) at
#: its published widths, 48 query heads over one KV head of 128, depth cut
#: from 52 layers to ``periods`` (phase 25's cut: 3.637B params, 14.55 GB of
#: f32 masters; 16 layers until phase 28 took their time; at 52 layers
#: 81.26 GB leave the card no room), on the
#: kernel backend; code completion over repository context: 8 greedy
#: requests of the prompt lengths below (511, 512 and 513 on the chunk's
#: edge, 4097 one past a page and a chunk edge, 8192 granite-20b-code's
#: context, arXiv:2405.04324), 16 new tokens each, on 4 slots with chunked
#: prefill in chunks of up to ``chunk`` tokens, unpaged and off the page
#: pool (``page_size``-row pages, the default pool).  Traced on fake
#: tensors at 16 layers, the legacy engine's whole 8192-token prefill and
#: ``transformer.forward`` peak under 62 GB (1e9) with the masters
#: (``tests/test_torch_granite_serve.py``), so (c) and (d) run at every
#: prompt
GRANITE_SERVE = dict(arch="granite-20b", periods=8,
                     prompts=(64, 511, 512, 513, 2048, 4097, 6000, 8192), max_new=16,
                     slots=4, chunk=512, page_size=16)
#: the attention products of a pass: the scores and P·V
ATTN_SPECS = ("bsgrd,btgd->bgrst", "bgrst,btgd->bsgrd")


@contextlib.contextmanager
def recording_plans():
    """Within the block, each ``native_gemm`` launch through ``kernels.ops``
    has its route and plan (``native_plan`` on its own operands) recorded
    under its spec, with its operands' shapes: yields ``{spec: [(route,
    plan, shapes), ...]}``.  No operand is kept."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sb_gemm import native_plan

    plans: dict = {}
    real = ops.native_gemm

    def recording(A, B, **kw):
        spec = f"{kw['a_modes']},{kw['b_modes']}->{kw['c_modes']}"
        route, plan = native_plan(A, B, a_modes=kw["a_modes"], b_modes=kw["b_modes"],
                                  c_modes=kw["c_modes"])
        plans.setdefault(spec, []).append((route, plan, (tuple(A.shape), tuple(B.shape))))
        return real(A, B, **kw)

    ops.native_gemm = recording
    try:
        yield plans
    finally:
        ops.native_gemm = real


def broadcast_mode(plan, heads: int):
    """The plan's grid mode of extent ``heads`` that W does not carry
    (W stride 0: one W tile serves every query head), or None."""
    return next((g for g in plan["grid"] if g[0] == heads and g[2] == 0), None)


def granite_serve_path(dev, seed: int, counters) -> dict:
    """Phase 27: granite-20b at its published widths, 8 of 52 layers,
    through ``ServingRuntime`` with chunked prefill, unpaged and paged, on
    the kernel backend (:func:`serve_at_width`; its (b) is the broadcast of
    the one KV head across the 48 query heads).  Returns ``native_gemm``'s
    multi-query serving record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sb_gemm import H100_SMS, native_gemm
    from repro_torch.models import transformer
    from repro_torch.runtime.engine import slot_cache

    t_start = time.perf_counter()
    spec = GRANITE_SERVE
    full = get_config(spec["arch"])
    cfg = full.with_(n_periods=spec["periods"], **KERNEL_BACKEND)
    cfg32 = cfg.with_(contract_backend="torch", contract_strategy="auto", dtype="float32")
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    check(G == 1 and not cfg.tie_embeddings and cfg.mlp_act == "gelu",
          f"granite: {G} KV heads, tied head {cfg.tie_embeddings}, {cfg.mlp_act}: not the "
          f"published multi-query config")
    log(f"granite: {cfg.arch_id} at published widths, depth cut from "
        f"{len(full.pattern) * full.n_periods} layers to {len(cfg.pattern) * cfg.n_periods}; "
        f"d_model {cfg.d_model}, {H} query heads over {G} KV head of {D} (multi-query: R = "
        f"{H // G} query heads share it), d_ff {cfg.d_ff} ({cfg.mlp_act}), vocab "
        f"{cfg.vocab_size} tied {cfg.tie_embeddings}; {cfg.dtype} activations, "
        f"{cfg.param_dtype} params, contract_backend {cfg.contract_backend}, strategy "
        f"{cfg.contract_strategy}; {cfg.param_count() / 1e9:.3f}B params ({full.param_count() / 1e9:.3f}B "
        f"at {full.n_periods} layers)")

    def broadcast_check(params, toks, max_len):
        # (b) the broadcast: the plans of layer 0's scores and P·V at the
        # longest prompt's last chunk and in a 4-slot and a 1-slot decode
        # pass over the full cache width; layer 0's output there against
        # float32 and against the same layer with K and V copied out to H
        # heads
        L, rows = toks.shape[1], spec["chunk"]
        with torch.no_grad():
            attn, h, cache = layer0_filled(cfg, params, toks, rows, max_len, None, dev)
            with recording_plans() as chunk_plans:
                out_k = layer0_last(cfg, attn, h, cache, L, None, dev)
            decode_plans = {}
            for where, slots in (("decode", spec["slots"]), ("one-row decode", 1)):
                with recording_plans() as decode_plans[where]:
                    transformer.decode_step(cfg, params, slot_cache(cfg, slots, max_len,
                                                                    device=dev),
                                            torch.zeros((slots, 1), dtype=torch.long, device=dev))
            plans = {}
            for where, got in (("chunk", chunk_plans), *decode_plans.items()):
                for s in ATTN_SPECS:
                    check(s in got, f"granite: (b) no {s} launch in the {where} pass")
                    route, plan, shapes = got[s][0]
                    plans[f"{where} {s}"] = dict(route=route, shapes=shapes, M=plan["M"],
                                                 N=plan["N"], K=plan["K"], grid=plan["grid"],
                                                 G=plan["G"], tiles=plan["tiles"],
                                                 n_split=plan["n_split"])
            for s in ATTN_SPECS:
                c, d = plans[f"chunk {s}"], plans[f"decode {s}"]
                mode = broadcast_mode(c, H)
                check(c["route"] == d["route"] == "batched" and mode is not None
                      and d["M"] == H and broadcast_mode(d, H) is None
                      and all(g[2] != 0 for g in d["grid"]),
                      f"granite: (b) {s}: the chunk's plan {c}, the decode pass's {d}: not "
                      f"batched with a grid mode of {H} at W stride 0 in the chunk, and the "
                      f"{H} heads as the decode pass's row mode")
                log(f"granite: (b) {s} in a {rows}-token chunk at {L - rows}: [{c['route']}] "
                    f"A{c['shapes'][0]} B{c['shapes'][1]}, M {c['M']} x N {c['N']} x K "
                    f"{c['K']}, grid (extent, X stride, W stride, C stride) {c['grid']}: the "
                    f"{H} query heads a grid mode whose W stride is {mode[2]} (one K/V tile "
                    f"serves all {H}, no copy), {c['tiles']} tiles; in a {spec['slots']}-slot "
                    f"decode pass at {max_len} rows: [{d['route']}] A{d['shapes'][0]} "
                    f"B{d['shapes'][1]}, M {d['M']} x N {d['N']} x K {d['K']}, grid "
                    f"{d['grid']} (the slots): the {H} heads are the tile's row mode (M "
                    f"{d['M']}), W carries no head mode, {d['tiles']} tiles")
                o = plans[f"one-row decode {s}"]
                check(o["route"] == "batched" and o["M"] == H and o["n_split"] == 1
                      and [g[0] for g in o["grid"]] == [2],
                      f"granite: (b) {s} in a 1-slot decode pass: {o}, not batched and "
                      f"unsplit over the row and its copy")
                log(f"granite: (b) {s} in a 1-slot decode pass (its row copied, "
                    f"layers.attention): [{o['route']}] A{o['shapes'][0]} B{o['shapes'][1]}, "
                    f"M {o['M']} x N {o['N']} x K {o['K']}, grid {o['grid']}, {o['tiles']} "
                    f"tiles, unsplit (without the copy: wgmma, P·V split over the cache width)")
            # the copy the broadcast avoids: K and V out to H heads (G = H),
            # the new rows' K and V from the projections repeated per head
            cfg_c = cfg.with_(n_kv_heads=H)
            attn_c = dict(attn, wk=attn["wk"].repeat(1, H), wv=attn["wv"].repeat(1, H))
            cache_c = dict(cache, **{k: cache[k].expand(-1, -1, H, -1).contiguous()
                                     for k in ("k", "v")})
            out_c = layer0_last(cfg_c, attn_c, h, cache_c, L, None, dev)
            del attn_c, cache_c
            # the three scores: broadcast, copy then GEMM, einsum (random
            # operands of the chunk's layout; the comparison launches do not
            # count)
            q = torch.randn((1, rows, G, H, D), device=dev).to(torch.bfloat16)
            k = torch.randn((1, max_len, G, D), device=dev).to(torch.bfloat16)
            spec_s = ATTN_SPECS[0]
            saved = native_gemm.launches, dict(native_gemm.launches_by_route)

            def broadcast():
                return native_gemm(q, k, a_modes="bsgrd", b_modes="btgd", c_modes="bgrst")

            def copied():
                return native_gemm(q.view(1, rows, H, 1, D),
                                   k.expand(-1, -1, H, -1).contiguous(),
                                   a_modes="bsgrd", b_modes="btgd", c_modes="bgrst")

            got_b, got_c = (f().view(1, H, rows, max_len) for f in (broadcast, copied))
            same = torch.equal(got_b, got_c)
            e_s = mag_err(got_c, got_b)
            check(e_s <= TOL[torch.bfloat16],
                  f"granite: (b) the scores on the copied K {e_s} from the broadcast's")
            del got_b, got_c
            times = dict(broadcast=queued_ms(broadcast, 5), copy_then_gemm=queued_ms(copied, 5),
                         einsum=queued_ms(lambda: torch.einsum(spec_s, q, k), 5))
            native_gemm.launches, native_gemm.launches_by_route = saved
            del q, k
            attn, h, cache = layer0_filled(cfg32, params, toks, rows, max_len, None, dev)
            out_32 = layer0_last(cfg32, attn, h, cache, L, None, dev)
            del h, cache
        e_k, e_c = mag_err(out_k, out_32), mag_err(out_c, out_k)
        check(e_k <= TOL[torch.bfloat16] and e_c <= TOL[torch.bfloat16],
              f"granite: (b) layer 0's attention at rows {L - rows}-{L - 1}: the kernel's "
              f"{e_k} from float32, the copied K/V's {e_c} from the broadcast's (limit "
              f"{TOL[torch.bfloat16]})")
        log(f"granite: (b) layer 0 attention at query rows {L - rows}-{L - 1} of the "
            f"{L}-token prompt against the float32 torch backend's, of its largest "
            f"magnitude: kernel backend {e_k:.3g} (limit {TOL[torch.bfloat16]:g}); with K and "
            f"V copied out to {H} heads (G = {H}) against the broadcast: {e_c:.3g} (limit "
            f"{TOL[torch.bfloat16]:g}); the scores {spec_s} at q (1, {rows}, {G}, {H}, {D}), "
            f"k (1, {max_len}, {G}, {D}), queued: broadcast {times['broadcast']:.4f} ms, copy "
            f"then GEMM {times['copy_then_gemm']:.4f} ms, einsum {times['einsum']:.4f} ms "
            f"(the two GEMMs' scores {'bit-identical' if same else f'{e_s:.3g} apart'})")
        return dict(broadcast=dict(plans=plans, kernel_err=e_k, copy_err=e_c, scores_ms=times,
                                   scores_identical=same, scores_err=e_s))

    rec = serve_at_width(dev, seed, counters, "granite", 27, cfg, spec, broadcast_check)
    # the decode P·V by name: one tile a slot
    pv = next(r for r in rec["shapes"]
              if r["path"] == "decode pass" and r["spec"] == ATTN_SPECS[1])
    tiles = rec["broadcast"]["plans"][f"decode {ATTN_SPECS[1]}"]["tiles"]
    log(f"granite: (f) the decode pass's P·V {pv['spec']} [{pv['route']}], {tiles} tiles on "
        f"{H100_SMS} SMs, an unsplit "
        f"{max(spec['prompts']) + spec['max_new']}-deep contraction: {pv['ms']:.4f} ms queued "
        f"({100 * pv['bound_ms'] / pv['ms']:.1f}% of its {pv['bound_ms']:.4f} ms bound, "
        f"{pv['bound_by']}), einsum {pv['library_ms']:.4f} ms, plain {pv['plain_ms']:.4f} ms; "
        f"x{pv['launches']} a pass")
    took = time.perf_counter() - t_start
    log(f"granite: phase 27 took {took:.1f} s (limit 120 s)")
    return dict(rec, decode_pv=dict(pv, tiles=tiles), phase_s=took)


# ------------------------------------------------------------------ phase 28
#: the MoE cell: qwen2-moe-a2.7b (src/repro/configs/qwen2_moe_a2p7b.py) at
#: its published widths and depth (24 layers, no cut: 14.316B params,
#: 57.26 GB of f32 masters) on the kernel backend; a chat assistant's
#: traffic, 8 greedy requests of the prompt lengths below (511, 512 and 513
#: on the chunk edge; 4096 one dispatch group of GROUP_SIZE tokens, 4097
#: one past a page, a chunk and GROUP_SIZE: its whole prompt routes in 17
#: groups of 241), ``max_new`` new tokens each, on 4 slots in chunks of up
#: to 512, unpaged and off the page pool.  Traced on fake tensors at 24
#: layers (``tests/test_torch_qwen2_moe_serve.py``) a 6000-token prompt
#: (6016 cache rows) puts the paged decode pass at 76.19 GB (1e9) and a
#: 4-slot float32 oracle's decode at 85.65, so the longest prompt is 4097
#: (4112 rows: paged decode 70.20 GB) and the float32 oracle runs on
#: ``oracle_slots`` slots (71.86 GB; 76.65 on 4).  A pass costs ~0.45 s on
#: the card (505 contractions and ~6500 device ops, host-bound), so the
#: phase serves 8 new tokens a request, not 16, and has no warm-up serve:
#: the runtime's build runs every lattice point, and the paged serve must
#: repeat the counted serve's tokens
QWEN2_MOE_SERVE = dict(arch="qwen2-moe-a2.7b",
                       prompts=(64, 511, 512, 513, 1024, 2048, 4096, 4097), max_new=8,
                       slots=4, chunk=512, page_size=16, oracle_slots=3, warm_up=False)
#: the expert products of a MoE layer: up (``wi`` and ``wg``) and down
EXPERT_SPECS = ("xgce,xef->xgcf", "xgcf,xfe->xgce")


def expert_mode(plan, experts: int):
    """The plan's grid mode of extent ``experts`` that both X and W walk
    at a stride (the expert as the batch mode), or None."""
    return next((g for g in plan["grid"] if g[0] == experts and g[1] and g[2]), None)


def qwen2_moe_serve_path(dev, seed: int, counters) -> dict:
    """Phase 28: qwen2-moe-a2.7b at its published widths and depth through
    ``ServingRuntime`` with chunked prefill, unpaged and paged, on the
    kernel backend (:func:`serve_at_width`, whose (c) and (d) for a MoE
    stack hold a whole-prompt serve; its (b) is the experts at width).
    Returns ``native_gemm``'s MoE serving record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import layers, moe, transformer
    from repro_torch.models.tree import tree_map
    from repro_torch.runtime.engine import slot_cache

    t_start = time.perf_counter()
    spec = QWEN2_MOE_SERVE
    cfg = get_config(spec["arch"]).with_(**KERNEL_BACKEND)
    cfg32 = cfg.with_(contract_backend="torch", contract_strategy="auto", dtype="float32")
    m, X = cfg.moe, cfg.moe.n_experts
    check(all(sp.mixer == "attn" and sp.ff == "moe" for sp in cfg.pattern) and m.n_shared > 0
          and not cfg.tie_embeddings,
          f"qwen2-moe: pattern {cfg.pattern}, {m.n_shared} shared experts, tied head "
          f"{cfg.tie_embeddings}: not the published MoE config")
    log(f"qwen2-moe: {cfg.arch_id} at published widths and depth, "
        f"{len(cfg.pattern) * cfg.n_periods} layers (no cut); d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {cfg.hd}; every layer MoE: {X} "
        f"routed experts top-{m.top_k} (renormalised), d_expert {m.d_expert}, capacity "
        f"factor {m.capacity_factor}, GShard groups of up to {moe.GROUP_SIZE}, and "
        f"{m.n_shared} ungated shared experts of {m.d_shared} ({cfg.mlp_act}); vocab "
        f"{cfg.vocab_size} untied; {cfg.dtype} activations, {cfg.param_dtype} params, "
        f"contract_backend {cfg.contract_backend}, strategy {cfg.contract_strategy}; "
        f"{cfg.param_count() / 1e9:.3f}B params, {cfg.param_count(active_only=True) / 1e9:.3f}B "
        f"active a token")

    def experts_check(params, toks, max_len):
        # (b) the experts at width: the plans of the three expert products
        # at the longest prompt's last chunk (layer 0's MoE) and in a 4-slot
        # decode pass over the full cache width; layer 0's MoE output there
        # against the float32 torch backend's; the products timed three ways
        L, rows, slots = toks.shape[1], spec["chunk"], spec["slots"]
        layer = tree_map(lambda t: t[0], params["pattern"][0])

        def moe_input(conf):
            # layer 0's MoE input at the last rows: its residual after the
            # attention (the cache filled by the rows before), normed
            attn, h, cache = layer0_filled(conf, params, toks, rows, max_len, None, dev)
            x = params["embed"][toks[:, L - rows:]].to(conf.activation_dtype())
            x = x + layer0_last(conf, attn, h, cache, L, None, dev).to(x.dtype)
            return layers.rms_norm(x, layer["norm2"], conf.rms_eps)

        def top(h):
            gates = torch.softmax(layers.contraction(
                "gte,ef->gtf", h.float(), layer["moe"]["router"], strategy="direct"), dim=-1)
            return moe.top_k(gates, m.top_k)[1].sort(dim=-1).values[0]

        with torch.no_grad():
            h_k = moe_input(cfg)
            with (recording_plans() as chunk_plans, recording_launch_keys() as chunk_keys,
                  dropped_tokens() as lost_k):
                y_k, _ = moe.moe_ffn(cfg, layer["moe"], h_k)
            with dropped_tokens() as lost_same:
                y_same, _ = moe.moe_ffn(cfg32, layer["moe"], h_k.float())
            h_32 = moe_input(cfg32)
            with dropped_tokens() as lost_32:
                y_32, _ = moe.moe_ffn(cfg32, layer["moe"], h_32)
            flips = (top(h_k) != top(h_32)).any(dim=-1)
            same = ~flips
            with recording_plans() as decode_plans, recording_launch_keys() as decode_keys:
                transformer.decode_step(cfg, params, slot_cache(cfg, slots, max_len, device=dev),
                                        torch.zeros((slots, 1), dtype=torch.long, device=dev))
        e_same, e_own = mag_err(y_k, y_same), mag_err(y_k, y_32)
        e_agree = mag_err(y_k[:, same], y_32[:, same]) if bool(same.any()) else 0.0
        check(e_same <= TOL[torch.bfloat16],
              f"qwen2-moe: (b) layer 0's MoE at rows {L - rows}-{L - 1}: the kernel's {e_same} "
              f"from the float32 torch backend's on the same input (limit {TOL[torch.bfloat16]})")
        log(f"qwen2-moe: (b) layer 0's MoE output (routed and shared experts) at query rows "
            f"{L - rows}-{L - 1} of the {L}-token prompt, one group of {rows} (capacity "
            f"{lost_k[0][1]}), of the largest magnitude: the kernel backend against the float32 "
            f"torch backend on the same (bf16) input {e_same:.3g} (limit "
            f"{TOL[torch.bfloat16]:g}; drops {lost_k[0][2]} and {lost_same[0][2]}); each from "
            f"its own layer-0 input: {e_own:.3g}, {e_agree:.3g} over the {int(same.sum())} rows "
            f"whose top-{m.top_k} sets agree; {int(flips.sum())} of {rows} rows' top-{m.top_k} "
            f"sets differ between bf16 and float32 (drops {lost_k[0][2]} and {lost_32[0][2]})")

        plans = {}
        for where, got in (("chunk", chunk_plans), ("decode", decode_plans)):
            for s_ in EXPERT_SPECS:
                check(s_ in got, f"qwen2-moe: (b) no {s_} launch in the {where} pass")
                route, plan, shapes = got[s_][0]
                p_ = plans[f"{where} {s_}"] = dict(
                    route=route, shapes=shapes, M=plan["M"], N=plan["N"], K=plan["K"],
                    grid=plan["grid"], G=plan["G"], tiles=plan["tiles"],
                    n_split=plan["n_split"], launches=len(got[s_]))
                check(route == "batched" and expert_mode(plan, X) is not None,
                      f"qwen2-moe: (b) {s_} in the {where} pass: {p_}, not batched with the "
                      f"{X} experts a grid mode of X and W")
        up = plans[f"decode {EXPERT_SPECS[0]}"]
        mode = broadcast_mode(up, slots)
        check(mode is not None, f"qwen2-moe: (b) the decode pass's {EXPERT_SPECS[0]}: {up}, no "
                                f"grid mode of the {slots} slots at W stride 0")
        w_bytes = int(np.prod(up["shapes"][1])) * 2
        reread = dict(per_launch=(slots - 1) * w_bytes, per_pass=(slots - 1) * w_bytes
                      * up["launches"])
        for key, p_ in plans.items():
            log(f"qwen2-moe: (b) {key}: [{p_['route']}] A{p_['shapes'][0]} B{p_['shapes'][1]}, "
                f"M {p_['M']} x N {p_['N']} x K {p_['K']}, grid (extent, X stride, W stride, C "
                f"stride) {p_['grid']}, {p_['tiles']} tiles, split {p_['n_split']}; "
                f"x{p_['launches']} in the pass")
        log(f"qwen2-moe: (b) the decode pass's up-projections: the {slots} slots a grid mode "
            f"{mode} whose W stride is 0 (dispatch writes expert_in slot-major), so each slot "
            f"re-reads the {X} experts' {w_bytes / 1e6:.1f} MB of bf16 weights: "
            f"{reread['per_launch'] / 1e9:.3f} GB more a launch, {reread['per_pass'] / 1e9:.2f} GB "
            f"a pass ({up['launches']} launches)")

        # the expert products three ways on random operands of the path's
        # layouts: the kernel (the expert a grid mode, no copy), one einsum,
        # and the conventional path (expert_in copied to (x, g·c, e), then
        # one torch.bmm); the comparison launches do not count
        gen = torch.Generator(dev).manual_seed(seed + 28)
        saved = native_gemm.launches, dict(native_gemm.launches_by_route)
        times = {}
        for where, keys in (("chunk", chunk_keys), ("decode", decode_keys)):
            for key, (n, layout) in keys.items():
                s_ = f"{key[0]},{key[1]}->{key[2]}"
                if s_ not in EXPERT_SPECS:
                    continue
                A, B, kw = operands_like(layout, gen, dev)

                def conventional():
                    return torch.bmm(A.contiguous().view(X, -1, A.shape[-1]), B)

                got = native_gemm(A, B, **kw)
                e_c = mag_err(conventional().view(got.shape), got)
                check(e_c <= TOL[torch.bfloat16],
                      f"qwen2-moe: (b) {s_} copied then torch.bmm {e_c} from the kernel's")
                t = times[f"{where} {s_}"] = dict(
                    shapes=(tuple(A.shape), tuple(B.shape)), per_layer=n // (
                        1 if where == "chunk" else cfg.n_periods),
                    kernel=queued_ms(lambda: native_gemm(A, B, **kw), 5),
                    einsum=queued_ms(lambda: torch.einsum(s_, A, B), 5),
                    copy_then_bmm=queued_ms(conventional, 5), err=e_c)
                log(f"qwen2-moe: (b) {where} {s_} A{t['shapes'][0]} B{t['shapes'][1]} "
                    f"(x{t['per_layer']} a layer), queued: kernel {t['kernel']:.4f} ms, einsum "
                    f"{t['einsum']:.4f} ms, expert_in copied to (x, g·c, e) then torch.bmm "
                    f"{t['copy_then_bmm']:.4f} ms ({e_c:.3g} from the kernel's)")
                del A, B, got
        native_gemm.launches, native_gemm.launches_by_route = saved
        for where in ("chunk", "decode"):
            layer_ms = {k: sum(t[k] * t["per_layer"] for w, t in times.items()
                               if w.startswith(where))
                        for k in ("kernel", "einsum", "copy_then_bmm")}
            log(f"qwen2-moe: (b) a layer's three expert products in a {where} pass, queued: "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in layer_ms.items()))
        return dict(experts=dict(plans=plans, moe_err=dict(same_input=e_same, own_input=e_own,
                                                           own_input_agreeing=e_agree),
                                 top_k_flips=int(flips.sum()), rows=rows,
                                 layer0_dropped=dict(kernel=lost_k[0][2], same_input=lost_same[0][2],
                                                     float32=lost_32[0][2]),
                                 reread_bytes=reread, times=times))

    rec = serve_at_width(dev, seed, counters, "qwen2-moe", 28, cfg, spec, experts_check)
    # the decode pass's expert up-projection by name: each slot re-reads
    # the weights (ROADMAP R10)
    up = next(r for r in rec["shapes"]
              if r["path"] == "decode pass" and r["spec"] == EXPERT_SPECS[0])
    log(f"qwen2-moe: (f) the decode pass's expert up-projection {up['spec']} [{up['route']}]: "
        f"{up['ms']:.4f} ms queued ({100 * up['bound_ms'] / up['ms']:.1f}% of its "
        f"{up['bound_ms']:.4f} ms bound, {up['bound_by']}, each weight read once), einsum "
        f"{up['library_ms']:.4f} ms, plain {up['plain_ms']:.4f} ms; x{up['launches']} a pass")
    took = time.perf_counter() - t_start
    log(f"qwen2-moe: phase 28 took {took:.1f} s (target 150 s)")
    return dict(rec, decode_up=up, phase_s=took)


# ------------------------------------------------------------------ phase 30
#: the vision-language serving cell: internvl2-2b
#: (src/repro/configs/internvl2_2b.py) at its published widths and depth (24
#: of 24 layers, no cut: 1.892B params, 7.57 GB of f32 masters) on the kernel
#: backend; a VLM chat endpoint's requests about one image each: the image
#: 256 patch positions of 1024 features (the JAX package's stub frontend,
#: drawn N(0, 1) from the seed) prepended to the text by the frontend's
#: projection; one request alone (batch 1) of each text prompt length below,
#: then one batch of ``batch`` requests of ``batch_prompt`` text tokens, each
#: with its image; ``max_new`` greedy tokens each.  Neither package's
#: ``ServingRuntime`` takes an image (a ``Request`` carries tokens only, and
#: a chunked prefill would prepend the image to every chunk), so the serve
#: is the model's own ``prefill`` of the whole prompt and ``decode_step``
#: passes; the cache is ``max_len`` rows (the longest prompt, its image and
#: ``max_new`` rounded up to 16) for every request, so every row's softmax
#: runs at one width
VLM_SERVE = dict(arch="internvl2-2b", prompts=(32, 64, 128, 256, 512, 1024, 2048, 3840),
                 max_new=16, batch=4, batch_prompt=1024)
#: device kernels a serving pass's profile sums by kind (by name): the
#: port's products, the library's (the torch backend's), the softmax, and
#: copies (the weights' casts to bf16 among them)
SERVE_KINDS = {"native_gemm": STEP_KINDS["native_gemm"],
               "library GEMM": lambda name: any(k in name.lower() for k in LIBRARY_GEMM),
               "softmax": lambda name: "softmax" in name.lower(),
               "copies": STEP_KINDS["copies"]}


class VlmRequest(NamedTuple):
    rid: int
    prompt: np.ndarray      # (L,) int32 text tokens
    features: np.ndarray    # (n_positions, feature_dim) float32 patch embeddings


def vlm_traffic(cfg, seed: int, spec: dict = VLM_SERVE, salt: int = 30) -> list:
    """The phase's requests as the batches they are served in: each of
    ``spec["prompts"]`` alone, then ``spec["batch"]`` requests of
    ``spec["batch_prompt"]`` text tokens together; text tokens and image
    features drawn from ``seed + salt``."""
    rng = np.random.default_rng(seed + salt)
    fe = cfg.frontend
    groups = [[n] for n in spec["prompts"]] + [[spec["batch_prompt"]] * spec["batch"]]
    rids = iter(range(sum(map(len, groups))))
    return [[VlmRequest(next(rids), rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        rng.standard_normal((fe.n_positions, fe.feature_dim), dtype=np.float32))
             for n in group] for group in groups]


def vlm_batch(reqs, dev) -> dict:
    """The model's input batch of ``reqs`` (one text length): tokens and
    float32 features, which ``_embed_inputs`` casts."""
    return {"tokens": torch.as_tensor(np.stack([r.prompt for r in reqs]), device=dev).long(),
            "features": torch.as_tensor(np.stack([r.features for r in reqs]), device=dev)}


def vlm_serve(cfg, params, batches, max_len: int, max_new: int, dev,
              forced: dict | None = None) -> dict:
    """Greedy serves of a vision-language model through its entry points, a
    batch at a time: ``transformer.prefill`` of the batch's tokens and
    features on a fresh ``init_cache(cfg, B, max_len)``, then ``max_new -
    1`` ``decode_step`` passes, each pass timed by the host clock between
    device synchronisations.  Every row's logits are kept as float32 on the
    host under ``(rid, tokens generated before)``; with ``forced`` (rid to
    tokens) each row is fed those tokens in place of its own argmax.
    Returns the logits (``seen``), the tokens (``outputs``), each pass's
    ``(kind, text tokens or slots, native_gemm launches by route)``
    (``events``), each request's cache length after its prefill
    (``lengths``), the mean ms of a prefill by ``(slots, text tokens)`` and
    of a decode pass by slots, and tokens/s over the whole."""
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import transformer

    seen, outputs, events, lengths, prefill_ms, decode_ms = {}, {}, [], {}, {}, {}

    def timed(fn, kind, size, into):
        before = dict(native_gemm.launches_by_route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        into.setdefault(size if kind == "decode" else (len(reqs), size), []).append(
            (time.perf_counter() - t0) * 1e3)
        events.append((kind, size, {r: n - before[r] for r, n in
                                    native_gemm.launches_by_route.items() if n > before[r]}))
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for reqs in batches:
            batch, B = vlm_batch(reqs, dev), len(reqs)
            cache = transformer.init_cache(cfg, B, max_len, device=dev)
            logits, cache = timed(lambda: transformer.prefill(cfg, params, batch, cache),
                                  "prefill", len(reqs[0].prompt), prefill_ms)
            lengths |= dict.fromkeys((r.rid for r in reqs), int(cache["length"]))
            for pos in range(max_new):
                if pos:
                    logits, cache = timed(
                        lambda: transformer.decode_step(cfg, params, cache, toks), "decode", B,
                        decode_ms)
                rows, picked = logits.float().cpu(), []
                for r, row in zip(reqs, rows):
                    seen[(r.rid, pos)] = row
                    picked.append(int(torch.argmax(row)) if forced is None
                                  else forced[r.rid][pos])
                    outputs.setdefault(r.rid, []).append(picked[-1])
                toks = torch.tensor(picked, device=dev)[:, None]
            del cache, logits
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    tokens = sum(map(len, outputs.values()))
    return dict(seen=seen, outputs=outputs, events=events, lengths=lengths, wall_ms=wall_ms,
                tokens=tokens, tokens_per_s=tokens / wall_ms * 1e3,
                prefill_ms={k: sum(v) / len(v) for k, v in sorted(prefill_ms.items())},
                decode_ms={k: sum(v) / len(v) for k, v in sorted(decode_ms.items())},
                decode_passes={k: len(v) for k, v in sorted(decode_ms.items())})


def vlm_forward_rows(cfg, params, reqs, outputs: dict, max_new: int, dev,
                     pad_to: int | None = None) -> dict:
    """Every row a serve of ``reqs`` gave, as ``transformer.forward`` of
    each request alone gives it: one forward over the image, the prompt
    and the first ``max_new - 1`` of its ``outputs``, whose last
    ``max_new`` positions are the rows ``(rid, 0)`` (the prefill's) to
    ``(rid, max_new - 1)``, as float32 on the host.  With ``pad_to`` the
    sequence is padded after its last token (with token 0, which no row
    before it sees: the mask is causal) to ``pad_to`` positions, so that
    every softmax row of forward is as wide as a served row against a
    cache of ``pad_to`` rows."""
    from repro_torch.models import transformer

    rows = {}
    with torch.no_grad():
        for r in reqs:
            batch = vlm_batch([r], dev)
            toks = torch.cat([batch["tokens"], torch.as_tensor(
                outputs[r.rid][:max_new - 1], device=dev)[None].long()], dim=1)
            n = batch["features"].shape[1] + toks.shape[1]
            if pad_to is not None:
                toks = torch.nn.functional.pad(toks, (0, pad_to - n))
            full, _ = transformer.forward(cfg, params, {"tokens": toks,
                                                        "features": batch["features"]})
            tail = full[0, n - max_new:n].cpu()
            del full
            rows |= {(r.rid, pos): tail[pos] for pos in range(max_new)}
    return rows


def top2_margin(row) -> float:
    """The gap between a row's two largest logits over its largest
    magnitude (the scale of :func:`mag_err`)."""
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1]) / max(row.float().abs().max().item(),
                                        torch.finfo(torch.float32).tiny)


def internvl2_serve_path(dev, seed: int, counters) -> dict:
    """Phase 30: internvl2-2b at its published widths and depth, one image
    a request, through ``transformer.prefill`` and ``decode_step`` on the
    kernel backend (see :data:`VLM_SERVE` and the module docstring).
    Returns ``native_gemm``'s vision-language serving record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import frontend, transformer

    t_start = time.perf_counter()
    took, mark = {}, [t_start]

    def lap(label):
        took[label] = round(time.perf_counter() - mark[0], 1)
        mark[0] = time.perf_counter()

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    spec, tag = VLM_SERVE, "internvl2"
    cfg = get_config(spec["arch"]).with_(**KERNEL_BACKEND)
    cfg_t = cfg.with_(contract_backend="torch", contract_strategy="auto")
    cfg32 = cfg_t.with_(dtype="float32")
    fe = cfg.frontend
    check(fe is not None and fe.kind == "vision"
          and all(sp.mixer == "attn" and sp.ff == "dense" for sp in cfg.pattern),
          f"{tag}: frontend {fe}, pattern {cfg.pattern}: not the published VLM config")
    P, bf16_tol = fe.n_positions, TOL[torch.bfloat16]
    log(f"{tag}: {cfg.arch_id} at published widths and depth, "
        f"{len(cfg.pattern) * cfg.n_periods} layers (no cut); d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, d_ff {cfg.d_ff} "
        f"({cfg.mlp_act}), vocab {cfg.vocab_size} untied; {fe.kind} frontend (the JAX "
        f"package's stub): {fe.n_positions} patch positions of {fe.feature_dim} features "
        f"projected to d_model and prepended to the text; {cfg.dtype} activations, "
        f"{cfg.param_dtype} params, contract_backend {cfg.contract_backend}, strategy "
        f"{cfg.contract_strategy}; {cfg.param_count() / 1e9:.3f}B params without the "
        f"projector")
    release()
    base = torch.cuda.memory_allocated(dev)
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    masters = torch.cuda.memory_allocated(dev) - base
    log(f"{tag}: random weights drawn on the card, {masters / 1e9:.2f} GB "
        f"({base / 2**30:.2f} GiB allocated before)")
    max_len = -(-(P + max(spec["prompts"]) + spec["max_new"]) // 16) * 16
    batches = vlm_traffic(cfg, seed, spec)
    singles, group = [b[0] for b in batches[:-1]], batches[-1]
    reqs = singles + group
    lens = {r.rid: len(r.prompt) for r in reqs}
    serve = functools.partial(vlm_serve, max_len=max_len, max_new=spec["max_new"], dev=dev)
    peaks = {}
    # a warm-up serve of the shortest request's prefill and one decode
    # pass, whose tokens the counted serve must repeat
    warm = vlm_serve(cfg, params, batches[:1], max_len, 2, dev)
    lap("warm-up")

    # (a) the main path, counted: every prefill and decode pass by its routes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with native_routes_held() as held:
        main = serve(cfg, params, batches)
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    peaks["serve"] = torch.cuda.max_memory_allocated()
    seen, outputs, events = main["seen"], main["outputs"], main["events"]
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"{tag}: another kernel launched on the path: {counted}")
    check(routes == held and counted["native_gemm"] == sum(held.values()),
          f"{tag}: launches {counted['native_gemm']} by route {routes}, native_route gives "
          f"{held}")
    for kind, size, by in events:
        want = ssm_routes(cfg, size if kind == "prefill" else None)
        check(by == want, f"{tag}: a {kind} of {size} launched by route {by}, not {want}")
    per_prefill, per_decode = ssm_routes(cfg, P), ssm_routes(cfg)
    n_prefills = sum(kind == "prefill" for kind, *_ in events)
    n_decodes = len(events) - n_prefills
    check(n_prefills == len(batches) and n_decodes == len(batches) * (spec["max_new"] - 1)
          and counted["native_gemm"] == n_prefills * sum(per_prefill.values())
          + n_decodes * sum(per_decode.values()),
          f"{tag}: {counted['native_gemm']} launches over {n_prefills} prefills and "
          f"{n_decodes} decode passes, not {per_prefill} a prefill and {per_decode} a pass")
    check(outputs[0][:2] == warm["outputs"][0], f"{tag}: the counted serve's first tokens of "
                                                f"request 0 differ from the warm-up serve's")
    log(f"{tag}: (a) {len(reqs)} requests ({len(singles)} alone, prompts "
        f"{tuple(lens[r.rid] for r in singles)} text tokens after {P} image positions; "
        f"{len(group)} together of {spec['batch_prompt']}), {main['tokens']} tokens in "
        f"{main['wall_ms'] / 1e3:.2f} s; native_gemm launches {counted['native_gemm']} by "
        f"route {routes}, each on the route native_route gives: {n_prefills} prefills of "
        f"{sum(per_prefill.values())} {per_prefill} (the projector among them) and "
        f"{n_decodes} decode passes of {sum(per_decode.values())} {per_decode}; grouped_gemm "
        f"{counted['grouped_gemm']}, flash_attention {counted['flash_attention']}; peak "
        f"{peaks['serve'] / 1e9:.2f} GB allocated ({(peaks['serve'] - masters) / 1e9:.2f} "
        f"above the masters)")
    lap("counted serve")

    # (b) the image is in the answer: the cache holds the image's rows, the
    # prefill's last logits move without it, and the projector's launch
    # holds to float32 on the same (bf16) features
    short = {rid: n for rid, n in main["lengths"].items() if n != P + lens[rid]}
    check(not short, f"{tag}: (b) cache lengths after the prefill {short}, not {P} + L")
    zeroed = {}
    with torch.no_grad():
        for r in singles:
            batch = vlm_batch([r], dev)
            batch["features"] = torch.zeros_like(batch["features"])
            logits, _ = transformer.prefill(cfg, params, batch,
                                            transformer.init_cache(cfg, 1, max_len, device=dev))
            zeroed[lens[r.rid]] = mag_err(logits[0].cpu(), seen[(r.rid, 0)])
        x = vlm_batch(singles[-1:], dev)["features"].to(cfg.activation_dtype())
        before = dict(native_gemm.launches_by_route)
        y = frontend.apply_frontend(cfg, params["frontend"], x)
        proj_routes = {k: n - before[k] for k, n in native_gemm.launches_by_route.items()
                       if n > before[k]}
        e_proj = mag_err(y, frontend.apply_frontend(cfg32, params["frontend"], x.float()))
    check(min(zeroed.values()) > 10 * bf16_tol,
          f"{tag}: (b) zeroed features move the prefill's last logits by {zeroed} of the "
          f"largest magnitude, not more than {10 * bf16_tol}")
    check(e_proj <= bf16_tol and proj_routes == {"wgmma": 1},
          f"{tag}: (b) the projector on {proj_routes}, {e_proj} from float32 on the same "
          f"features (limit {bf16_tol})")
    log(f"{tag}: (b) every cache holds {P} + L rows after its prefill; zeroed features move "
        f"the prefill's last logits by "
        + ", ".join(f"{n}: {e:.3g}" for n, e in zeroed.items())
        + f" of the largest magnitude (at least {10 * bf16_tol:g}); the projector "
        f"bpf,fe->bpe {tuple(x.shape)} x {tuple(params['frontend']['proj'].shape)} on "
        f"{proj_routes}, {e_proj:.3g} from float32 on the same features (limit {bf16_tol:g})")
    del x, y
    release()
    lap("(b)")

    # (e) the torch backend in bf16 (a serve fed the kernel's tokens: its
    # times, and the yardstick) and the float32 oracle: the torch backend's
    # forward in float32 over each request's image, prompt and the tokens
    # fed before (one pass a request where a fed serve would take 16)
    runs = {"kernel": main}
    runs["torch"] = serve(cfg_t, params, batches, forced=outputs)
    release()
    torch.cuda.reset_peak_memory_stats()
    ref = vlm_forward_rows(cfg32, params, reqs, outputs, spec["max_new"], dev)
    peaks["float32 oracle"] = torch.cuda.max_memory_allocated()
    release()
    errs = oracle_check(tag, "(e)", seen, runs["torch"]["seen"], ref, outputs,
                        len(reqs) * spec["max_new"], what="serve", oracle="forward",
                        note=f"the float32 forward peaked at "
                             f"{peaks['float32 oracle'] / 1e9:.2f} GB allocated")
    lap("(e)")

    # (d) the batch against its requests alone, each fed the batch's tokens
    alone = serve(cfg, params, [[r] for r in group], forced=outputs)["seen"]
    rows = list(alone)
    e_d = {k: mag_err(seen[k], alone[k]) for k in rows}
    flips = {k: (int(torch.argmax(alone[k])), outputs[k[0]][k[1]], top2_margin(ref[k]))
             for k in rows if int(torch.argmax(alone[k])) != outputs[k[0]][k[1]]}
    held_flips = {k: v for k, v in flips.items() if v[2] > bf16_tol}
    same_bits = [k for k in rows if torch.equal(seen[k], alone[k])]
    first = min((k[1] for k in rows if k not in same_bits), default=None)
    check(max(e_d.values()) <= bf16_tol,
          f"{tag}: (d) the {len(group)}-slot batch's rows against the same requests alone: "
          f"{max(e_d.values())} (limit {bf16_tol})")
    check(not held_flips, f"{tag}: (d) the batch's tokens differ from the requests' alone where "
                          f"the float32 oracle's top-two margin exceeds {bf16_tol}: {held_flips}")
    log(f"{tag}: (d) the {len(group)}-slot batch against its requests alone (fed the batch's "
        f"tokens), over {len(rows)} rows: worst {max(e_d.values()):.3g} of the largest "
        f"magnitude (limit {bf16_tol:g}); argmax differs at {len(flips)} rows, at the float32 "
        f"oracle's top-two margins {sorted(round(v[2], 5) for v in flips.values())} (limit "
        f"{bf16_tol:g}: none above); {len(same_bits)} of {len(rows)} rows bit-identical"
        + ("" if first is None else f", the first pass whose rows differ: "
           f"{'the prefill' if first == 0 else f'decode pass {first}'}"))
    del alone
    lap("(d)")

    # (c) every served row against forward over the image, the prompt and
    # the tokens before (the prefill's row and each decode step's), the
    # sequence padded to the cache's width: forward's softmax rows then sum
    # as the served rows do (CUDA's softmax sums a row in an order set by
    # its width); the prefill rows of the requests alone also against
    # forward over image and prompt alone, its rows as wide as the prompt
    # (logged: ROADMAP B8)
    torch.cuda.reset_peak_memory_stats()
    fwd = vlm_forward_rows(cfg, params, reqs, outputs, spec["max_new"], dev, pad_to=max_len)
    peaks["forward"] = torch.cuda.max_memory_allocated()
    e_c = {k: mag_err(seen[k], fwd[k]) for k in seen}
    exact = sum(torch.equal(seen[k], fwd[k]) for k in seen)
    worst_c = {n: max(e for (rid, _), e in e_c.items() if lens[rid] == n)
               for n in sorted(set(lens.values()))}
    check(all(bool(torch.isfinite(fwd[k]).all()) and fwd[k].shape == (cfg.vocab_size,)
              for k in fwd) and max(e_c.values()) <= bf16_tol,
          f"{tag}: (c) served rows against forward by prompt length {worst_c} (limit "
          f"{bf16_tol})")
    del fwd
    unpadded = {}
    with torch.no_grad():
        for r in singles:
            full, _ = transformer.forward(cfg, params, vlm_batch([r], dev))
            unpadded[lens[r.rid]] = mag_err(seen[(r.rid, 0)], full[0, -1].cpu())
            del full
    log(f"{tag}: (c) every served row (the prefill's and each decode step's) against "
        f"transformer.forward over image, prompt and the tokens before, padded to {max_len} "
        f"positions, worst by prompt length: "
        + ", ".join(f"{n}: {e:.3g}" for n, e in worst_c.items())
        + f" of the largest magnitude (limit {bf16_tol:g}); {exact} of {len(e_c)} rows "
        f"bit-identical; forward's peak {peaks['forward'] / 1e9:.2f} GB allocated.  The "
        f"prefill rows against forward over image and prompt alone (rows as wide as the "
        f"prompt; logged, not held): "
        + ", ".join(f"{n}: {e:.3g}" for n, e in unpadded.items()))
    release()
    lap("(c)")

    # (f) every launch layout of the longest prefill and of a 1-slot and a
    # 4-slot decode pass at the cache's full width; the weights' casts
    longest = max(singles, key=lambda r: lens[r.rid])
    L = lens[longest.rid]
    decode_caches = {B: transformer.init_cache(cfg, B, max_len, device=dev) for B in (1, 4)}
    step_toks = {B: torch.zeros((B, 1), dtype=torch.long, device=dev) for B in (1, 4)}
    passes = {f"prefill of {P} + {L}": lambda conf=cfg: transformer.prefill(
        conf, params, vlm_batch([longest], dev),
        transformer.init_cache(conf, 1, max_len, device=dev))}
    for B in (1, 4):
        passes[f"decode pass of {B} slot{'s' if B > 1 else ''}"] = (
            lambda conf=cfg, B=B: transformer.decode_step(conf, params, decode_caches[B],
                                                          step_toks[B]))
    torch.cuda.reset_peak_memory_stats()
    shapes, per_pass_t, by_route = pass_layouts(
        f"{tag}: (f)", passes, torch.Generator(dev).manual_seed(seed + 30), dev)
    peaks["layouts"] = torch.cuda.max_memory_allocated()
    casts = weight_casts(cfg, params)
    log(f"{tag}: (f) the casts of the {casts['weights']} weights a decode pass to bf16 (a "
        f"prefill adds the projector's) ({casts['bytes'] / 1e9:.2f} GB read and written): "
        f"{casts['ms']:.3f} ms queued, bound {casts['bound_ms']:.3f} ms (bytes)")
    lap("(f)")

    # (g) the times of the kernel's counted serve and the torch backend's
    # fed serve; where the longest prefill and a 4-slot decode pass spend
    # device time on each backend
    for backend, res in runs.items():
        log(f"{tag} [{backend}]: {res['tokens']} tokens in {res['wall_ms']:.1f} ms, "
            f"{res['tokens_per_s']:.2f} tokens/s; ms per prefill by (slots, text tokens): "
            + ", ".join(f"{b}x{n}: {v:.2f}" for (b, n), v in res["prefill_ms"].items())
            + "; ms per decode pass by slots: "
            + ", ".join(f"{b}: {v:.2f} (x{res['decode_passes'][b]})"
                        for b, v in res["decode_ms"].items()))
    prefill_name = next(iter(passes))
    profiles = profile_passes(tag, {k: passes[k] for k in (prefill_name, "decode pass of 4 slots")},
                              {"kernel": cfg, "torch": cfg_t}, kinds=SERVE_KINDS)
    del passes, decode_caches, params
    release()
    lap("(g)")
    took_s = time.perf_counter() - t_start
    log(f"{tag}: peaks allocated by stage: "
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in peaks.items())
        + f"; phase 30 took {took_s:.1f} s (target 75 s): "
        + ", ".join(f"{k} {v} s" for k, v in took.items()))
    return dict(launches=counted["native_gemm"], launches_by_route=routes,
                prefill_launches_by_route=per_prefill, decode_launches_by_route=per_decode,
                prefills=n_prefills, decode_passes=n_decodes, zeroed_features_err=zeroed,
                projector=dict(err=e_proj, routes=proj_routes),
                forward_err=dict(worst_by_prompt=worst_c, bit_identical=exact, rows=len(e_c),
                                 unpadded_prefill=unpadded),
                batch_vs_alone=dict(err=max(e_d.values()), argmax_flips=len(flips),
                                    bit_identical=len(same_bits), rows=len(rows),
                                    first_pass_differing=first),
                logits_err={k: v for k, v in errs.items() if k != "rows"},
                peak_bytes=peaks, master_bytes=masters,
                shapes=shapes, shapes_by_route=by_route, per_pass=per_pass_t,
                weight_cast=casts, profiles=profiles,
                tokens_per_s={b: r["tokens_per_s"] for b, r in runs.items()},
                runs={b: {k: r[k] for k in ("wall_ms", "tokens", "tokens_per_s", "decode_ms",
                                             "decode_passes")}
                      | dict(prefill_ms={f"{s}x{n}": v for (s, n), v in r["prefill_ms"].items()})
                      for b, r in runs.items()},
                phase_s=took_s, seconds=took)


# ---------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=512, help="HOOI tensor edge")
    ap.add_argument("--n-iter", type=int, default=10, help="HOOI iterations")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a card")
        return 1
    # outside a checkout of the repository this import fails, before any output
    from repro_torch.core.contract import record_contractions
    from repro_torch.core.tucker import hooi
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.kernels.sb_gemm import native_gemm

    counters = [native_gemm, grouped_gemm, flash_attention]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = device_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    took, mark = {}, [t0]

    def lap(label):
        took[label] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    secs = build()
    log(f"build: {', '.join(f'{n}.cu {t:.2f} s' for n, t in secs.items())}; all compiled "
        f"and loaded in {time.perf_counter() - t0:.2f} s")
    flash_kernel_info()
    grouped_kernel_info()
    native_kernel_info()
    lap("1-2")

    check_table2(dev)
    check_layoutfuzz(dev)
    check_grads(dev)
    check_small_hooi(dev)
    check_native_routes(dev)
    check_grouped(dev)
    check_flash(dev)
    lap("3")

    T, noise_share = low_rank_plus_noise(args.size, RANKS, args.seed, device=dev)
    with record_contractions() as rec:
        hooi(T, RANKS, n_iter=1, **VARIANTS["kernel"])
    working_set = list({s: d for s, d, _ in rec}.items())
    check_copy_freedom(dev, working_set)
    lap("4")

    hooi_dec = hooi_run(T)
    counted, routes, launches, hooi_summary = main_path(hooi_dec, noise_share, args.n_iter,
                                                        counters)
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"HOOI launched another kernel: {counted}")
    lap("5")
    tuned = tuned_path(hooi_dec, rec, noise_share, args.n_iter, counters, hooi_summary)
    lap("10")
    tot = time_shapes(launches)
    lap("6")
    profile_hooi(T, args.n_iter, "kernel")
    del T, hooi_dec, launches, rec  # the recorded operands hold the tensor too
    lap("7")
    cp = cp_path(dev, args.seed, counters)
    lap("29")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    grouped = grouped_path(dev, args.seed, counters)
    lap("8")
    attention = attention_path(dev, args.seed, counters)
    lap("9")
    records = {
        "grouped_gemm": ("grouped_gemm.cu", "grouped_gemm.py:248", grouped),
        "flash_attention": ("flash_attn.cu", "flash_attn.py:79", attention),
    }
    serve = serve_path(dev, args.seed, counters)
    lap("11")
    every_arch(dev, args.seed, counters)
    lap("12")
    train = train_path(dev, args.seed, counters)
    lap("13")
    sharded = sharded_path(dev, working_set, args.seed, counters)
    lap("14")
    f32 = f32_products(dev, args.seed, counters)
    lap("19")
    former = former_generic(dev, args.seed, counters)
    lap("20")
    serve_ref = {"outputs": serve.pop("outputs"), "launches": serve["launches"],
                 "launches_by_route": serve["launches_by_route"]}
    mesh = mesh_path(dev, args.seed, counters, serve_ref)
    lap("15-16")
    tc = tc_shapes_path(dev, args.seed)
    lap("18")
    print(json.dumps({"dryrun": dryrun_path(dev, args.seed, train["ms_per_step"])}))
    lap("17")
    host = host_cost(dev, args.seed)
    lap("21")
    ssm = ssm_serve_path(dev, args.seed, counters)
    lap("22")
    ssm_train = ssm_train_path(dev, args.seed, counters)
    lap("23")
    jamba = jamba_serve_path(dev, args.seed, counters)
    lap("24")
    gemma = gemma2_serve_path(dev, args.seed, counters)
    lap("25")
    hubert = hubert_train_path(dev, args.seed, counters)
    lap("26")
    granite = granite_serve_path(dev, args.seed, counters)
    lap("27")
    qwen = qwen2_moe_serve_path(dev, args.seed, counters)
    lap("28")
    vlm = internvl2_serve_path(dev, args.seed, counters)
    lap("30")
    log("time by phase: " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
        + f"; all {time.perf_counter() - t0:.1f} s after the device line")
    records = {
        "native_gemm": ("sb_gemm.cu", "sb_gemm.py:87",
                        {**tot, "launches": counted["native_gemm"],
                         "launches_by_route": routes,
                         "tuned_launches_by_route": tuned["launches_by_route"],
                         "cp_launches": cp["launches"],
                         "cp_launches_by_route": cp["launches_by_route"],
                         "cp": cp["cases"],
                         "serve_launches": serve["launches"],
                         "serve_launches_by_route": serve["launches_by_route"],
                         "train_launches": train["launches"],
                         "train_launches_by_route": train["launches_by_route"],
                         "train": {k: v for k, v in train.items()
                                   if k not in ("launches", "launches_by_route")},
                         "sharded_launches": sharded["launches"],
                         "sharded_launches_by_route": sharded["launches_by_route"],
                         "sharded": {k: v for k, v in sharded.items()
                                     if k not in ("launches", "launches_by_route")},
                         "serve": {k: v for k, v in serve.items()
                                   if k not in ("launches", "launches_by_route")},
                         "sharded_train": mesh["sharded_train"],
                         "sharded_serve": mesh["sharded_serve"],
                         "mesh_cli_s": mesh["cli_s"],
                         "a2a_launches": mesh["a2a"]["train"]["launches"],
                         "a2a_launches_by_route": mesh["a2a"]["train"]["launches_by_route"],
                         "a2a": {k: v for k, v in mesh["a2a"].items() if k != "pipeline"},
                         "pipeline_launches": mesh["a2a"]["pipeline"]["launches"],
                         "pipeline": mesh["a2a"]["pipeline"], "host": host,
                         "ssm_serve_launches": ssm["launches"],
                         "ssm_serve_launches_by_route": ssm["launches_by_route"],
                         "ssm_serve": {k: v for k, v in ssm.items()
                                       if k not in ("launches", "launches_by_route")},
                         "ssm_train": ssm_train,
                         "jamba_serve_launches": jamba["launches"],
                         "jamba_serve_launches_by_route": jamba["launches_by_route"],
                         "jamba_serve": {k: v for k, v in jamba.items()
                                         if k not in ("launches", "launches_by_route")},
                         "gemma2_serve_launches": gemma["launches"],
                         "gemma2_serve_launches_by_route": gemma["launches_by_route"],
                         "gemma2_serve": {k: v for k, v in gemma.items()
                                          if k not in ("launches", "launches_by_route")},
                         "hubert_train": hubert,
                         "granite_serve_launches": granite["launches"],
                         "granite_serve_launches_by_route": granite["launches_by_route"],
                         "granite_serve": {k: v for k, v in granite.items()
                                           if k not in ("launches", "launches_by_route")},
                         "qwen2_moe_serve_launches": qwen["launches"],
                         "qwen2_moe_serve_launches_by_route": qwen["launches_by_route"],
                         "qwen2_moe_serve": {k: v for k, v in qwen.items()
                                             if k not in ("launches", "launches_by_route")},
                         "internvl2_serve_launches": vlm["launches"],
                         "internvl2_serve_launches_by_route": vlm["launches_by_route"],
                         "internvl2_serve": {k: v for k, v in vlm.items()
                                             if k not in ("launches", "launches_by_route")}}),
        **records,
    }
    # the batched route of native_gemm on its own line: phase 13's counted
    # launches, its times per train step from phase 18
    step = tc["paths"]["train"]["batched"]
    records["native_gemm.batched"] = ("sb_gemm.cu", "sb_gemm.py:87", dict(
        {k: step[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        launches=train["launches_by_route"]["batched"],
        max_abs_err=max(r["max_abs_err"] for r in tc["rows"] if r["kind"] == "batched"),
        tc_shapes=tc))
    # the fbatched route on its own line: phase 19's counted launches (Table
    # II at n = 256) and their summed times; phase 14's fbatched shapes
    records["native_gemm.f32"] = ("sb_gemm.cu", "sb_gemm.py:87", dict(
        {k: f32[k] for k in ("launches", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                             "max_abs_err")},
        table2=f32, sharded_fbatched=sharded["fbatched"]))
    # the products the retired generic route took: the gathered route (its
    # own nm_kernel producer) on the bf16 Table II cases at ragged extents,
    # and fbatched's widening fb_kernel on the mixed set, each on its own line
    # with phase 20's counted launches and its set's summed times
    for key, name, route in (("native_gemm.gathered", "bf16 ragged", "gathered"),
                             ("native_gemm.mixed", f"mixed n={MIXED_N}", "fbatched")):
        tot = former["sums"][name]
        records[key] = ("sb_gemm.cu", "sb_gemm.py:87", dict(
            {k: tot[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                 "max_abs_err")},
            launches=former["launches_by_route"][route],
            former_generic={n: {k: v for k, v in t.items()} for n, t in former["sums"].items()}))
    # each route's launches on the mamba2 serve of phase 22, per prefill (a
    # prompt in chunks of more than 1) and in the counted serve, and per
    # train step of phase 23; the route's SSD launch shapes of the serve,
    # summed
    for key, route in (("native_gemm.batched", "batched"), ("native_gemm.f32", "fbatched"),
                       ("native_gemm.gathered", "gathered")):
        records[key][2]["model_launches"] = {
            "mamba2-1.3b prefill": ssm["prefill_launches_by_route"][
                str(SSM_SERVE["prompts"][0])].get(route, 0),
            "mamba2-1.3b serve": ssm["launches_by_route"].get(route, 0),
            "mamba2-1.3b train step": ssm_train["launches_per_step"].get(route, 0),
            "jamba-v0.1-52b prefill": jamba["prefill_launches_by_route"][
                str(max(JAMBA_SERVE["prompts"]))].get(route, 0),
            "jamba-v0.1-52b serve": jamba["launches_by_route"].get(route, 0),
            "gemma2-27b prefill chunk or decode pass": gemma["launches_per_pass"].get(route, 0),
            "gemma2-27b serve": gemma["launches_by_route"].get(route, 0),
            "hubert-xlarge train step": hubert["launches_per_step"].get(route, 0),
            "granite-20b prefill chunk or decode pass": granite["launches_per_pass"].get(route, 0),
            "granite-20b serve": granite["launches_by_route"].get(route, 0),
            "qwen2-moe-a2.7b prefill chunk or decode pass": qwen["launches_per_pass"].get(route, 0),
            "qwen2-moe-a2.7b serve": qwen["launches_by_route"].get(route, 0),
            "internvl2-2b prefill": vlm["prefill_launches_by_route"].get(route, 0),
            "internvl2-2b decode pass": vlm["decode_launches_by_route"].get(route, 0),
            "internvl2-2b serve": vlm["launches_by_route"].get(route, 0)}
        records[key][2]["ssm_shapes"] = ssm["shapes_by_route"].get(route)
        records[key][2]["jamba_shapes"] = jamba["shapes_by_route"].get(route)
        records[key][2]["gemma2_shapes"] = gemma["shapes_by_route"].get(route)
        records[key][2]["granite_shapes"] = granite["shapes_by_route"].get(route)
        records[key][2]["qwen2_moe_shapes"] = qwen["shapes_by_route"].get(route)
        records[key][2]["internvl2_shapes"] = vlm["shapes_by_route"].get(route)
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/{tpu}",
                **{k: rec[k] for k in keys},
                **{k: rec[k] for k in ("launches_by_route", "tuned_launches_by_route",
                                       "cp_launches", "cp_launches_by_route", "cp",
                                       "serve_launches", "serve_launches_by_route", "serve",
                                       "train_launches", "train_launches_by_route", "train",
                                       "sharded_launches", "sharded_launches_by_route",
                                       "sharded", "sharded_train", "sharded_serve",
                                       "mesh_cli_s", "a2a_launches", "a2a_launches_by_route",
                                       "a2a", "pipeline_launches", "pipeline", "fma",
                                       "tc_shapes", "table2", "sharded_fbatched",
                                       "former_generic", "host", "ssm_serve_launches",
                                       "ssm_serve_launches_by_route", "ssm_serve",
                                       "ssm_train", "hubert_train", "jamba_serve_launches",
                                       "jamba_serve_launches_by_route", "jamba_serve",
                                       "gemma2_serve_launches",
                                       "gemma2_serve_launches_by_route", "gemma2_serve",
                                       "granite_serve_launches",
                                       "granite_serve_launches_by_route", "granite_serve",
                                       "qwen2_moe_serve_launches",
                                       "qwen2_moe_serve_launches_by_route", "qwen2_moe_serve",
                                       "internvl2_serve_launches",
                                       "internvl2_serve_launches_by_route", "internvl2_serve",
                                       "model_launches", "ssm_shapes", "jamba_shapes",
                                       "gemma2_shapes", "granite_shapes", "qwen2_moe_shapes",
                                       "internvl2_shapes")
                     if k in rec}}
               for name, (src, tpu, rec) in records.items()]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched no time on its path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
