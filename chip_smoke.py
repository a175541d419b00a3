#!/usr/bin/env python3
"""Drive the port's collective runtime, dense, MoE, MLA, Mamba and xLSTM
model paths (one card, expert- and tensor-parallel), training (one
process and sharded), the multi-tenant fleet and the per-shard path on
one NVIDIA card, end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` and prints the
   build time and the compiler's register and spill report, kernel by
   kernel (its mangled name carries the template instance);
3. holds each kernel against its plain torch version on the card, at the
   shapes the main path gives it: reduce_rounds and combine_rows (with
   and without its fused acc) bit-exact, each of their two bodies (staged,
   slab) in float32 and in bf16 with NaN, ±inf and -0.0 planted, timed per
   body beside combine_rows' library yardstick, ``torch.sparse.mm`` of the
   group's CSR selection matrix (timed only, never called by the port);
   block_matmul exact on integer-valued inputs and within
   rtol = atol = 2e-4 on random-normal ones (its tf32x3 body splits each
   operand into TF32 hi and lo parts and sums in another order); prints
   how far block_matmul and cuBLAS's float32 product each are from the
   float64 product;
4. drives the four collectives at full width through the user's entry
   points (``dist.collectives.*_program``, then
   ``runtime.backends.get_backend("cuda_fused").run_*``) and holds each,
   bit for bit, against the port's plain torch path on the card, counting
   every kernel launch and body: run_allreduce one staged reduce_rounds,
   run_matmul 32 staged combine_rows, each with its acc, and 16 tf32x3
   block products;
5. holds all four, at a reduced width, against the port's NumPy
   ``reference`` backend, bit for bit;
6. times every kernel and collective with CUDA events (median of several
   runs after a warm-up) beside its bound, the least time the card could
   take: the larger of bytes moved over 3.35 TB/s and operations over the
   card's peak rate for the work the function needs, the H100 SXM
   data-sheet peaks at 700 W: 67 TFLOP/s float32 outside the tensor cores,
   495 TFLOP/s TF32 for block_matmul's 2·X³ a block (beside it
   ``ffma_bound_ms``, the same work at the FFMA rate, and
   ``tf32x3_route_bound_ms``, the three TF32 products its design takes),
   989 TFLOP/s bf16 for flash attention; combine_rows' hook (with acc)
   beside its own bound, three passes of the buffer
   (``combine_hook_ms``, ``combine_hook_bound_ms``);
6b. measures the autotuner's seeds on the card (``BANDWIDTH``: one 25 MiB
   ``copy_``, best of 20; ``T_KERNEL``: one K2 launch at (16, 64), 200 back
   to back) and prints them on a line of their own beside the constants in
   ``runtime/autotune.py``; then ``get_backend("auto")`` with a measuring
   tuner on a cache in a temporary directory decides each collective at
   a cut of its cell's bytes (the matmul at X = ``AUTO_MATMUL_BLOCK`` =
   128, not 512: its ``sendrecv`` candidate, the NumPy trace interpreter,
   would move 16 times the bytes there; the all-to-all at an eighth of
   its chunk, ``AUTO_CHUNK``, and the all-reduce and broadcast at an
   eighth of the bucket, ``AUTO_BUCKET``), timing every candidate one
   process can run
   (``fused``, ``cuda_fused``, ``sendrecv``): per key every candidate's
   measured µs beside its analytic seed, the decision and the wall time it
   took; a second call of each (a memo hit) with the launch counts set to
   0, holding them to the decision (``cuda_fused``: 1 K1 for the
   all-reduce, 32 K2 and 16 K3 for the matmul; otherwise none) and every
   result bit for bit to the plain path; a second tuner on the same file
   decides every key from the cache, its timer made to raise;
7. holds flash attention (K4) against its plain version on the card: at
   TinyLlama-1.1B's prefill shape (q (8, 2048, 32, 64) bf16, k/v
   (8, 2048, 4, 64), causal), at small shapes with head_dim 64, 96
   (Phi-3-mini's) and 128, with a sliding window of 32 at Sq != Sk and at
   ragged lengths, and at Mixtral-8x7B's prefill shape (q (1, 8192, 32,
   128) bf16, k/v (1, 8192, 8, 128), causal, window 4096). bf16 within |Δ| <= 1e-2 + 1e-2·|want| everywhere and
   ||Δ|| <= 1e-2·||want|| (bf16 out, and p rounds to bf16 after scaling
   by running maxima taken over other key tiles: about one bf16 step of
   2^-8); float32 within 2e-4 in both. Shows that the bf16 bound rejects
   planted faults: on batch row 0 of the prefill shape, a materialised
   attention with the causal mask off by one, or without the diagonal
   key, or without the diagonal 64-key tile, fails it, and the same
   attention with the right mask passes. Times the kernel beside the
   plain version and ``F.scaled_dot_product_attention`` (timed only,
   never called by the port) and its bound at the 989 TFLOP/s of the bf16
   tensor cores, and the host time of one call of the wrapper at the
   prefill shape, bf16 (the wgmma body, three TMA tensor maps encoded per
   call) beside float32 (the mma_sync body, no maps); at the Mixtral
   shape, its time beside the plain version, SDPA given the same window
   as a boolean mask (KV heads expanded beforehand; timed only) and its
   bound, the keys inside the causal window at the bf16 tensor-core rate;
   then at the local-head shapes the tensor-parallel forwards give it (a
   rank's query heads and the KV heads they read: TinyLlama-1.1B's 16/2
   at (2, 2048) of step 18 d and 2/1 at (2, 32768) of step 19 b,
   Mixtral-8x7B's 4/1 at (1, 8192) of step 13 b and 2/1 at (1, 4096) of
   step 14 b with the window, DeepSeek-V3's MLA 8/8 at (1, 2048) and
   (192, 128) of step 17 b, Jamba-1.5-Large's 32/4 at (1, 2048) and
   (128, 128) of step 18 f), each against its plain version by the bf16
   bound and timed beside the plain version, SDPA and its bound, with its
   persistent grid's tiles;
8. runs TinyLlama-1.1B's prefill forward at full width (22 layers,
   random weights from a seed, tokens (8, 2048), its published context)
   through ``models.model.forward_train`` and ``loss_fn``: exactly 22 K4
   launches per forward, finite logits and loss, and last-token logits
   and loss held against the same forward on the naive attention oracle
   (bf16 through 22 layers: max |Δ| <= 0.5 and ||Δ|| <= 5 % of ||logits||,
   loss within 0.1 %); prints its ms, tokens/s and peak GiB;
9. serves 6 requests (prompts of 3–8 tokens, 12 new tokens each, the JAX
   launcher's smoke defaults) through ``serve.engine.Engine`` at full
   width with 4 slots and a 2048-token cache, checks that each gets its
   12 tokens and that the decode path's logits at the first request's
   last prompt token match the prefill forward's on that prompt (the
   logits tolerance of step 8); prints its steps, tokens/s and peak GiB. This
   is a functional check: such toy traffic does not measure serving
   throughput;
10. profiles one prefill forward and one engine step with torch.profiler:
   device time by kernel group (flash attention, matrix products, the
   rest), kernels per call, and the idle share of the wall time;
11. runs DeepSeek-V3 at its published widths (d 7168, 128 heads, MLA with
   q_lora 1536, kv_lora 512, qk head dim 128 + 64 and v head dim 128, dense
   d_ff 18432, 256 experts top-8 of d_ff 2048 and 1 shared expert, vocab
   129280, the MTP head, bf16) with the depth cut from 61 layers to its 3
   dense-prefix layers and 1 MoE layer, plus the MTP block (all 61 take
   1.34 TB of bf16 weights; each MoE layer 23.0 GB), random weights from
   seed 0 made on the card (the init's peak printed), when no other
   model's weights are resident (allocated GiB printed before and after).
   a) K4 at MLA's head dims, q and k of 192 and v of 128, v the strided
   half of the expanded latent as ``mla_train`` hands it over: the wgmma
   body at the prefill's shape (q, k (1, 4096, 128, 192) bf16, v (1, 4096,
   128, 128), causal) and a ragged small shape, the mma_sync body in
   float32 at small shapes, each within ``FLASH_TOL`` of its plain version;
   its time beside the plain version, SDPA (``is_causal``, v at 128, the
   dispatcher's choice, and each of its fused backends that takes the
   shapes; timed only) and its bound, the 4096·4097/2 key pairs × 128 heads
   × (2·192 + 2·128) operations at the bf16 tensor-core rate (0.695 ms),
   and each body's shared memory. b) ``forward_train`` and ``loss_fn`` on
   tokens (1, 4096) from seed 0 (DeepSeek-V3's pre-training length; one
   sequence, C = 160 an expert): exactly 4 wgmma K4 launches a forward and
   5 a ``loss_fn`` (the MTP block's), last-token logits, ``ce``, ``mtp``
   and ``loss`` against the naive passes with step 8's criteria, and the
   MoE layer's router logits too; its routes with step 12's near-tie
   criterion (every token's first differing route at a near-tie), its 3 %
   cap on the share printed, not required: with 256 experts, top-8,
   bf16 router logits tie exactly at the top for a large share of tokens
   (the share printed); its ms, tokens/s, device ms by part from
   torch.profiler (K4, MLA projections, dense FFN, expert products,
   dispatch and combine, the rest), kernels per call, idle share, the peak
   GiB of each pass and the capacity's drop share. c) the engine with 4
   slots, a 128-token cache and 6 requests of 12 new tokens, held like
   step 9's (a functional check);
11d. trains (``train_phase``; the plain attention: K4 has no backward,
   and no kernel of K1–K5 may launch, counted): a) TinyLlama-1.1B at
   full width with its depth cut to 2 layers, float32, tokens (2, 256)
   from ``SyntheticLM``: one ``make_train_step`` on the card and the same
   step on the CPU from the same parameters and optimizer state, each
   leaf's gradient within 1e-4 of the CPU's relative to its norm, the
   loss within 1e-5, grad_norm and lr within 1e-4; b) one Mamba layer at
   Jamba-1.5-Large's width (d_inner 16384, d_state 16) on (1, 512),
   float32: the output and the gradients of x and every weight through
   the scan's training form within 1e-5 (relative norm) of autograd
   through the step-by-step recurrence, both timed, peak GiB above the
   weights; c) TinyLlama-1.1B whole (22 layers, published widths, bf16),
   ``TRAIN_STEPS`` (4) steps on tokens (8, 2048) through
   ``launch.train.main``: the loss falls from the first step to the last;
   ms a step (median after the first),
   tokens/s, model TFLOP/s (6·N·tokens plus the causal attention's,
   against 989 TFLOP/s), peak GiB; its final checkpoint (bf16 weights,
   float32 Adam state) timed and sized, restored once with its digest
   checked and every bit compared; one more step profiled: device ms by
   part (forward, recompute, backward, optimizer) and kernel group, idle
   share; d) on the 2-layer model in bf16: 10 steps with a checkpoint at
   step 5, then ``--restore`` from step 5, the resumed losses within 1e-4
   of the uninterrupted ones (bit equality printed), and one step each of
   ``--microbatches 2``, ``--compress-grads`` and ``--straggler-drop``,
   finite (every checkpoint but step 5's, which nothing reads, not
   written: ``unwritten_save``); e) the elastic drill on the 2-layer model (0.22 B
   parameters, a 0.9 GB float32 payload in 8 rows): host D3(2,2), devices 1 and 4
   killed at steps 3 and 7, the §5 broadcast on ``cuda_fused``: shapes
   D3(1,2) then D3(2,1), zero derivations, losses within 1e-4 of an
   uninterrupted run (whose checkpoints, never restored, are not written);
12. runs Mixtral-8x7B at its published widths (d 4096, 32 heads, 8 KV
   heads of 128, 8 experts top-2 of d_ff 14336, vocab 32000, window 4096,
   bf16) with the depth cut from 32 layers to 8 (all 32 layers of bf16
   weights take 93 GB, more than the card's 80 GB), random weights from
   seed 0 made on the card: ``forward_train`` and ``loss_fn`` on tokens
   (1, 8192) from seed 0 (one sequence: the capacity couples every token
   of a batch), exactly 8 K4 launches all on the wgmma body, against the
   naive forward with step 8's criteria; the share of (token, layer)
   routes that differ between the two passes under 3 %, and each token's
   first differing route at a near-tie of the kernel pass (its router
   probabilities at the nearest rank boundary within 0.02): the bf16
   noise between the passes grows with depth and flips near-ties, not
   clear choices; prints its ms,
   tokens/s, device ms by group (expert products, dispatch and combine,
   K4, the rest) from torch.profiler, kernels per call, idle share, the
   peak GiB of each pass and the share of (token, k) entries the capacity
   dropped; then the engine on the same model with 4 slots, 6 requests,
   a 128-token cache and 12 new tokens each (the JAX launcher's smoke
   defaults; its rate is a smoke figure, not serving throughput), held
   like step 9's;
13. runs the same Mixtral-8x7B weights under expert parallelism: 8
   processes share the card on a (data 1, model 8) mesh of processes
   (``launch.mesh.make_mesh``, gloo, the host as the exchanges' carrier;
   the model axis is D3(2,2)), the weights made once in the parent and
   handed to the ranks by CUDA IPC, each rank taking its expert as a view
   (a checksum of every weight before and after). a) layer 0's MoE on
   hidden states (1, 8192, 4096) bf16 from the seed, in all four modes
   through ``moe_apply_auto`` under active rules: ``xla``, ``dragonfly``
   and ``dragonfly_overlap`` bit-identical, the fused mode within K4's
   bf16 bound of them, all four within it of the one-process
   ``moe_apply_ep_plain``, the aux equal; per mode the wall ms of a call
   of all ranks (``EP_CALLS`` after a warm-up), the exchange, expert-FFN
   and all-gather ms (``moe.timing_parts``), the carrier's copies and
   bytes, the drops and the peak; then the layer with
   ``moe_collectives="auto"``: the decision measured on the 8 ranks
   together (each on a measuring tuner of its own cache file), the same on
   every rank, the output the bits of the fixed mode it names (not
   ``xla``'s: the fused mode sums in another order), the measured µs per
   candidate beside each mode's wall ms, a second call timed (a memo
   hit), and ``Engine.collective_report()`` under those rules (measured
   and the same on every rank). b) ``forward_train`` of the first
   ``EP_FORWARD_LAYERS`` layer on tokens (1, 8192) in the ``dragonfly``
   mode with K4 on, on each rank's compute leaves (``models.local_params``:
   views of the shared weights, the attention on the rank's 4 of 32 query
   heads and its KV head, the embedding and the unembedding cut on the
   model axis too), one ``wgmma`` launch a layer and rank at (1, 8192,
   4/1, 128, window 4096), rank 0's last-token logits (gathered over the
   vocabulary) and loss against the
   one-process forward whose MoE layers are ``moe_apply_ep_plain``
   (step 8's criteria, the route flips as in step 12); its ms, tokens/s
   and the exchange's share. c) the whole-array wave replay
   ``torch_alltoall_overlapped`` of the all-to-all cell's input on the
   pipelined D3(4,4) program, bit for bit against ``torch_alltoall``,
   both timed;
14. runs the same Mixtral-8x7B weights under tensor parallelism: 16
   processes share the card on a (data 1, model 16) mesh, the production
   model axis, where 8 experts do not split and ``moe_apply_auto`` takes
   TP (gloo, the host as the all-reduce's carrier); the EP phase's
   weights are shared again by CUDA IPC, each rank taking its ff slice of
   every expert (896 of 14336) as a view, a checksum before and after.
   0) gloo sums in an order of its own, so the ranks first run 9
   all-reduces of known normals of the partials' shape (8, 2560, 4096)
   bf16 over the model group; the order of each element is read off the
   first 8 (``models.moe.ObservedSumOrder``) and must give the 9th's bits.
   a) layer 0's MoE on step 13's hidden states (1, 8192, 4096): C_loc
   2560, a (8, 2560, 4096) bf16 buffer and a 168 MB all-reduce a rank a
   call, held bit for bit against the one-process ``moe_apply_tp_plain``
   summing the 16 bf16 partial outputs in that order (a planted fault,
   the psum in float32, must not give the bits; rank order's distance is
   printed), every rank's output the same bits, the aux equal, the
   routes and drops equal to the plain version's and to
   ``moe_apply_sparse``'s (whose capacity is also 2560), the plain
   version within K4's relative rms (1e-2) of the unsplit sparse layer,
   and ``torch.bmm`` on a rank's strided ff slice copying no expert
   stack; the wall ms of a call of all ranks (``TP_CALLS`` after a
   warm-up), the all-reduce and expert-FFN ms, the carrier's copies and
   bytes and the peak a rank. b) ``forward_train`` of the first
   ``TP_FORWARD_LAYERS`` layer with K4 on tokens (1, 4096) on each
   rank's compute leaves (``models.local_params``: views of the shared
   weights; the attention on the rank's 2 of 32 query heads and the KV
   head they read, gathered, the embedding and the unembedding cut on
   the model axis too), one ``wgmma`` launch a layer and rank at
   (1, 4096, 2/1, 128, window 4096), held against the one-process
   forward whose MoE layers are ``moe_apply_tp_plain`` summing in gloo's
   order by step 8's criteria (rank 0's last-token logits, gathered over
   the vocabulary, the loss) and the route flips as in step 12; every
   rank's last-token logits the same bits; its ms, tokens/s and the
   all-reduce's share;
15. serves two Mixtral-8x7B tenants at full width, the depth cut to 1 of
   32 layers each (3.2 GB of bf16 a tenant), made on the card from seeds
   0 and 1, through ``serve.fleet.TenantFleet`` over ``torch_dist``: 8
   processes share the card as the D3(2,2) host, each tenant a D3(1,2)
   guest (n_guest 4, 2 experts a guest device, 2 slots, C 16), every rank
   driving the same fleet with the tenants' weights shared by CUDA IPC
   (each rank's expert shard a view, cast to float32 per call). Each
   tenant gets 3 requests (prompts of 3–8 tokens, 4 new tokens each); the
   combined arm, each tenant alone, the time-multiplexed arm and the
   churn drill (tenant 1 evicted after 3 steps, then re-admitted). Checks
   every tenant's tokens against its solo fleet's, the combined tokens
   against the time-multiplexed ones, the survivor across the evict, all
   8 ranks against each other, fewer replayed rounds combined than
   time-multiplexed, ``collective_report()`` after the combined arm on
   every rank (measured, the same decision on all 8, fewer combined rounds
   than time-multiplexed; printed), and the first combined boundary's
   replay output against ``guest_expert_ffn`` run per destination in one process
   (rtol = atol = 1e-4 and relative rms 1e-4: float32 products batched
   otherwise); then the launcher's path, the ``reference`` backend in one
   process with the tenants on the card, serves the combined arm's
   tokens without copying an expert to the host; prints tokens/s,
   replays, rounds, ms a boundary and the peak a rank;
16. runs the per-shard §4 all-reduce: 8 processes share the card in one
   gloo group (``launch.mesh.spawn``, D3(2,2)), each with a 25 MiB bucket
   from the seed plus its rank, and call
   ``CudaFusedBackend().allreduce_shard`` 5 times back to back with fresh
   data (in call 2 rank 3 sleeps 50 ms before its first put), 3 rounds of
   K5 each: 3 puts, 3 signals and 3 waits per call per rank, counted.
   Every call is held bit for bit against the plain exchange on host
   copies, and the first against the NumPy ``np_allreduce`` and K1
   ``run_allreduce`` on the stacked (8, 6553600) array. Prints each rank's
   median ms of one call, of one put, of one wait (add included), of one
   plain call and of one local 25 MiB ``copy_`` (the yardstick), the
   bound of one call of all 8 ranks (per round and rank: read x, read the
   partner's x, write the sum; the staging copy through the window is the
   design's cost, not the function's) and the bound of one put;
17. runs DeepSeek-V3 under expert parallelism on the production model
   axis: 16 processes share the card on a (data 1, model 16) mesh (gloo,
   the host as the exchanges' carrier; the model axis is D3(4,2)), 256
   experts, 16 a rank, so ``moe_apply_auto`` takes EP. The weights are made
   anew at 1 dense-prefix layer (``DS_EP_PREFIX``; step 11's 3, cut for
   the script's time), 1 MoE layer and the MTP block (bf16 from
   seed 0; the card's free memory printed
   first), once in the parent, and handed to the ranks by CUDA IPC; each
   rank cuts its 16 experts as views, each expert stack by its
   ``models.param_specs`` entry through ``dist.sharding.local_slices`` (a
   checksum of every weight before and after). Before the ranks start the
   parent runs the one-process oracles (``moe_apply_ep_plain(..., 1, 16)``,
   each model coordinate's 16 experts one ``bmm`` batch, as a rank runs
   them) and keeps only their outputs, and a control: the expert FFN of
   256 experts as one batch against 16 batches of 16, bits compared.
   a) the MoE layer on hidden states (1, 2048, 7168) bf16 from the seed
   (``DS_EP_TOKENS``): T_loc 128, C_loc 8, a (16, 16, 8, 7168) bf16 buffer
   of 29.4 MB a rank
   each way, in the four fixed modes through ``moe_apply_auto``: every
   rank's output the same bits, ``xla``, ``dragonfly`` and
   ``dragonfly_overlap`` the plain version's bits, the fused mode within
   K4's bf16 bound of it, the aux equal across modes and ranks (within
   1e-5 of the plain one: gloo sums it in its own order), routes and drops
   the plain version's; per mode the wall ms of a call of all ranks
   (``DS_EP_CALLS`` after a warm-up), the exchange, expert-FFN and all-gather
   ms (``moe.timing_parts``), the carrier's copies and bytes and the peak
   a rank; then ``moe_collectives="auto"``: one decision measured and
   agreed by all 16 ranks, its output the bits of the mode it names, every
   candidate's µs beside the analytic ``moe_site_report`` at that key.
   b) ``forward_train`` with K4 on tokens (1, 2048) from the seed in the
   ``dragonfly`` mode on each rank's compute leaves (``models.local_params``:
   MLA on 8 of the 128 heads, the dense MLPs and the shared expert on an ff
   slice, the embedding and the unembedding cut on the model axis too):
   exactly 2 ``wgmma`` K4 launches a rank at (1, 2048, 8/8, 192, 128) (32
   in all), every rank's last-token logits (gathered over the vocabulary)
   the same bits, rank 0's within step 8's criteria of the one-process
   forward's, the MoE layer's routes by step 10's rule for it (each
   token's first differing route at a near-tie; the share printed); every
   rank's ``loss_fn`` (its cross entropy on its vocabulary slice) the
   same, ``ce``, ``mtp`` and the loss within 1e-3 of the one-process
   ones; its ms, tokens/s, the exchange's share and the peaks a rank.
   c) one ``decode_step`` under the rules on the same
   compute leaves (MLA's ``wkv_b`` gathered, EP at ``DS_DECODE_ROWS`` 16
   rows) at the last position of a ``seeded_cache`` of ``DS_DECODE_SEQ``
   4096 positions, each rank holding its block of 256 of the latent cache:
   every rank's logits (every vocabulary entry) the same bits, within
   step 8's criteria of the parent's one-process decode on whole leaves
   and the whole cache (run before the ranks); the block written in place
   (the carrier's bytes printed: the gathered ``wkv_b`` and the EP
   exchange's buffers outweigh the block); its ms beside the one-process
   decode's;
18. trains on meshes of processes sharing the card
   (``train_sharded_phase``; ``train.train_step.make_sharded_train_step``
   on gloo, the host as the carrier; the plain attention, and no launch of
   K1–K5 in any training part, counted; the attention, the dense MLPs, the
   embedding and the unembedding computed tensor-parallel on the model
   axis, ``models.compute_specs``). Each rank makes the whole parameters from
   the seed on the card, cuts them and a fresh optimizer state to its
   shards by ``train_shardings`` and frees the rest; each one-process
   oracle runs first and only its outputs are kept; nothing is shared by
   CUDA IPC. a) TinyLlama-1.1B at full width, 2 layers, float32, mesh
   (2, 2) with FSDP (G = 2: each data coordinate holds one whole layer),
   one step on ``SyntheticLM`` tokens (4, 256): the gathered parameters,
   m and v, every leaf within 1e-4 of the one-process step on the card
   relative to its norm, the loss within 1e-5, grad_norm and lr within
   1e-4; beside it the bf16 control, the same one-process step with bf16
   weights against float32; then one step with
   ``compress_grads`` from the same state, against the one-process
   compressed step on the card: loss and grad_norm within ``SHARDED_REL``,
   every code within one of the oracle's (the codes that differ, each a
   value at a half-step of its block's scale, counted, at most
   ``FLIP_SHARE`` of the values, and set aside), the parameters and the
   error-feedback state within 1e-4 (the error relative to the gradient it
   was cut from, its error plus the dequantized gradient), its ms and
   carrier bytes a step beside the uncompressed step's; a planted fault,
   the one-process step with its codes cast to int8 without rounding
   (``truncating_quantize``), must exceed ``FLIP_SHARE``. b)
   TinyLlama-1.1B whole, bf16 weights and float32 Adam state, mesh (2, 2)
   with FSDP (11 whole layers a data coordinate; the embedding split by
   vocab over data and by d over model, the unembedding by d over data and
   by vocab over model), one step on
   ``SyntheticLM`` tokens (4, 2048) (cut from 2 steps for the script's
   time; the CPU tests run the second): loss and grad_norm within
   ``SHARDED_REL`` of the one-process step, every rank's
   parameter bytes the reference device's at those specs; its ms a step,
   tokens/s, the carrier's bytes a step, the peak a rank and the free
   memory before the ranks. c) Mixtral-8x7B at its published widths with
   1 of 32 layers, mesh (2, 4) (8 experts, 2 a rank: EP; the model axis
   D3(4,1)) with ZeRO-1, one step in each of ``xla``, ``dragonfly`` and
   ``dragonfly_overlap_fused`` (since PR 25: its round trip differentiated
   wave by wave) on tokens (2, 1024) from the seed (T_loc 256), against
   the one-process step whose MoE layer is ``moe_apply_ep_plain(..., 2,
   4)``: in ``xla`` and in the fused mode loss, moe_aux and grad_norm
   within ``SHARDED_REL``, the first moment of the router and of each
   expert stack within ``SHARDED_M_REL``, the routes that differ from it
   printed (its dense layers add their partial sums in another order);
   and against the ranks' own oracle, the same step from the same state
   with each MoE layer's exchange replaced (``ep_without_exchange``: the
   same routes, the rank's experts' arrivals built from the group's
   tokens, their outputs all-gathered): the routes equal, each first
   moment within ``RANKS_ORACLE_M_REL`` and zero nowhere the oracle's is
   above the noise, a planted zero counted; ``dragonfly`` the same bits
   as ``xla``, the fused mode's distance from ``xla`` printed;
   its ms a step, the forward's exchange share (``moe.timing_parts``), the
   carrier's copies and bytes and the peak a rank. d) in b's ranks,
   TinyLlama-1.1B whole in bf16 made anew from the seed on each rank:
   ``forward_train`` with K4 on the rank's (2, 2048) rows of b's tokens
   under the (2, 2) mesh's rules, on its compute leaves
   (``models.local_params``: 16 of 32 query heads, 2 of 4 KV heads, an
   ff slice, a vocabulary slice), exactly 22 ``wgmma`` K4 launches a rank
   at (2, 2048, 16/2, 64), held against the same rank's forward on the
   whole leaves with no rules on its vocabulary slice of the logits by
   step 8's bound (K4's own bf16 bound, ``attention_close``, printed); both
   forwards' ms and tokens/s (the slowest rank's, median of
   ``PREFILL_TP_REPS``, 1); the bound read against a
   planted wrong KV head, which it must reject, and the same two forwards
   in float32 on the same weights, within K4's float32 bound, the whole
   leaves' bf16 forward against float32 printed. e) in b's
   ranks, the tensor-parallel decode over a sequence-sharded cache:
   TinyLlama-1.1B whole in bf16 from the seed, each rank's 2 rows of a
   ``seeded_cache`` of ``DECODE_MAX_SEQ`` 32768 positions (filled below
   ``DECODE_START`` 32752 with N(0, ``DECODE_FILL_STD``²) bf16 values),
   the rank holding its block of 16384 positions (``models.cache_specs``);
   ``DECODE_STEPS`` 8 steps of ``decode_step`` under the rules on its
   compute leaves (split-KV attention joined by log-sum-exp), each timed,
   against the same rank's one-process decode on whole leaves and the
   whole cache by step 8's bound, and the rank's block against the same
   positions of that cache (untouched positions the same bits, the
   written ones within the bound's max |Δ|); the block written in place
   and the carrier's bytes a step under the block's; the ms a step beside
   the one-process decode's, the peak a rank; the bound read against the
   whole-leaf decode's own bf16-against-float32 distance (its first
   ``DECODE_CONTROL_STEPS`` steps) and two planted
   faults, each of which it must reject: the join without its exp(m − M)
   rescale, and the new token written into every rank's block. f) and g)
   in b's ranks, the Mamba, mLSTM and sLSTM mixers under
   tensor parallelism (``recurrent_tp_jobs``, ``_recurrent_tp_job``):
   Jamba-1.5-Large at full width cut to ``RECURRENT_JAMBA_LAYERS`` 2
   layers (an attention and a Mamba member, each with the dense MLP; 2.85
   B parameters), and xLSTM-1.3B at full width cut to one group of 8 (7
   mLSTM, 1 sLSTM), both bf16 from the seed on each rank; the TP prefill
   of (1, 2048) (Jamba) and (1, 512) (xLSTM) a data rank on the rank's
   compute leaves (every mixer leaf at its tensor-axis cut), Jamba's with
   exactly 1 ``wgmma`` K4 launch a rank at (1, 2048, 32/4, 128), xLSTM's
   with none; ``RECURRENT_DECODE_STEPS`` 8 decode steps on the rank's
   ``cache_specs`` shard of a ``seeded_cache`` (the recurrent states at
   their shards; Jamba's attention cache 4096 positions, 2048 a rank);
   each against the rank's run on whole leaves and the whole cache, and
   both against the same whole-leaf run in float32, the control: every TP
   output (the logits; the change over the steps of the rank's shard of
   each recurrent state, by mixer and leaf name: the mLSTM's C of every
   layer together, its n, its m, the sLSTM's c, …) no farther from
   float32 than ``RECURRENT_CONTROL_FACTOR`` 2 times the whole leaves'
   bf16 output, within step 8's max |Δ| of the whole leaves'; the
   attention block's untouched positions the same bits; two planted
   faults must fail it: in f's prefill the stored ``[x | z]`` columns of
   ``w_in`` taken as the rank's channels' (no exchange), in g's decode
   the sLSTM stepping on the rank's own ``h`` (no gather). Prints each
   prefill's ms beside the whole leaves', the decode's ms a step, the
   carrier's bytes, the worst state.

19. (since PR 25) the dry run (``launch.dryrun``) in a process of its
   own, whose fake process group is process-global: a) on the meta
   device, rank by rank of the production meshes, TinyLlama-1.1B's
   train_4k (the sharded step), DeepSeek-V3's prefill_32k (EP, 16 experts
   a rank), Mixtral-8x7B's decode_32k (TP and the cache specs) on (16,
   16), each ``ok``, OLMo-1B's train_4k on (2, 16, 16) with FSDP,
   ``FAILED`` as in the reference (16 stacked layers over pod·data = 32),
   and xLSTM-1.3B's decode_32k on (16, 16), ``ok``, its
   recurrent states traced at their shards; one line each with its
   seconds; b) ``--on-card``: TinyLlama-1.1B's
   prefill_32k, rank 0's share (2 × 32768 tokens, 22 K4 launches) run on
   the card under the fake world (the collectives' outputs unwritten, so
   only memory, counts and time are checked): the meta trace's peak within
   ``DRYRUN_PEAK_REL`` of ``torch.cuda.max_memory_allocated``, the FLOPs
   counted on the card equal to the meta count, its ms beside the
   roofline's ``compute_s`` and ``memory_s``; c) the same for
   TinyLlama-1.1B's decode_32k, rank 0's share (8 rows, its block of
   2048 of the 32768 positions of each attention cache, no K4).

20. ``examples/torch/serve_moe.py`` as a user runs it, in a
   process of its own with its default device, the card: Mixtral smoke, 3
   slots, 5 requests of 4–8 prompt tokens: exit 0, every request served
   its 8 tokens; its seconds, start-up included.

Every step ends with a ``phase: <step> <seconds> s`` line.

The float32 products of the plain versions, the references and the
library calls run in full float32: TF32 is switched off for cuBLAS and
cuDNN (block_matmul's tf32x3 body takes TF32 on purpose, three products
of split operands). Every failure raises and exits non-zero before the last
line, which is ``{"ok": true, "device": {...}}``. Without a card the
script exits non-zero at once: it has no CPU path.

The cells (layout D3(K, M) has n = K·M² routers):

  all-to-all  D3(4,4), n = 64, x (64, 64, 262144) f32: 1 MiB per (src, dst)
              chunk, 64 tokens × 4096 d_model of an MoE dispatch;
  all-reduce  D3(4,4), x (64, 6553600) f32: 25 MiB per router, PyTorch
              DDP's default gradient bucket;
  broadcast   D3(4,4) from root 0, the same 25 MiB per router;
  matmul      grid (4,4) = D3(16,4), n = 256, X = 512: B, A 8192 × 8192 f32
              with integer entries in [-4, 4], so B @ A is exact;
  per-shard   D3(2,2), 8 ranks (one 8-GPU node's shape) sharing the card,
  all-reduce  x (6553600,) f32 per rank: the DDP bucket again;
  MoE EP      Mixtral-8x7B, 8 of 32 layers, mesh (1, 8), 8 ranks sharing
              the card: T_loc 1024 tokens a rank, C_loc 320, a dispatch
              buffer (8, 1, 320, 4096) bf16 of 21 MB a rank each way;
  MoE TP      the same weights, mesh (1, 16), 16 ranks sharing the card:
              T_loc 8192, C_loc 2560, a (8, 2560, 4096) bf16 buffer and a
              168 MB all-reduce a rank; the forward on the same tokens;
  MLA prefill DeepSeek-V3, its 3 dense-prefix layers and 1 MoE layer of 61
              and the MTP block, tokens (1, 4096): C = 160 an expert, a
              (256, 160, 7168) bf16 dispatch buffer of 587 MB; K4 at
              (192, 128), 4 launches a forward, 5 a loss_fn;
  fleet       two Mixtral-8x7B tenants of 1 layer each on D3(2,2), 8
              ranks sharing the card, D3(1,2) guests, 3 requests a tenant;
  Jamba       Jamba-1.5-Large, one period of 8 layers (1 attention, 7
  prefill     Mamba, 1 MoE FFN), tokens (1, 4096): K4 at (128, 128), 64/8
              heads, 1 launch a forward;
  xLSTM       xLSTM-1.3B whole, tokens (8, 2048), no kernel;
  DeepSeek EP DeepSeek-V3, 1 dense-prefix and 1 MoE layer, mesh (1, 16), 16 ranks
              sharing the card, 16 of 256 experts a rank: T_loc 128, C_loc
              8, a (16, 16, 8, 7168) bf16 buffer of 29.4 MB a rank each
              way; the forward on tokens (1, 2048), K4 2 launches a rank;
              one decode step of 16 rows over a 4096-position latent cache,
              256 positions a rank.
  sharded    TinyLlama-1.1B whole, mesh (2, 2), FSDP, 4 ranks sharing
  training   the card, tokens (4, 2048); Mixtral-8x7B 1 layer, mesh (2, 4),
              EP with ZeRO-1, 8 ranks, tokens (2, 1024); no kernel.
  TP decode  TinyLlama-1.1B whole, mesh (2, 2), 4 ranks, 4 rows (2 a rank),
              a 32768-position cache, 16384 a rank, 8 steps; no kernel.
  recurrent  Jamba-1.5-Large 2 layers (attention, Mamba), mesh (2, 2), 4
  TP         ranks, tokens (2, 2048), K4 1 launch a rank; xLSTM-1.3B 8
              layers, tokens (2, 512), no kernel; each 8 decode steps of 4
              rows, the states at their shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core rate; only for bf16 tensor-core work
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core rate; block_matmul's tf32x3 body
SEED = 0
CHUNK = 262144  # all-to-all: floats per (src, dst) chunk, 1 MiB
BUCKET = 6553600  # all-reduce and broadcast: floats per router, 25 MiB
BLOCK = 512  # matmul: X, the side of each router's block
PREFILL = (8, 2048)  # TinyLlama-1.1B prefill: batch, tokens (its published context)
MIXTRAL_LAYERS = 8  # of 32: 8 layers of bf16 weights are 23.7 GB, all 32 are 93 GB
MIXTRAL_TOKENS = (1, 8192)  # one sequence of twice the window
DEEPSEEK_LAYERS = 4  # of 61: the 3 dense-prefix layers and 1 MoE layer (23.0 GB each)
DS_EP_TOKENS = (1, 2048)  # step 17 a, b: cut from DEEPSEEK_TOKENS' (1, 4096) for the script's
# time when steps 18 f and g came: T_loc 128, C_loc 8
DS_EP_PREFIX = 1  # step 17: of the 3 dense-prefix layers (with the 1 MoE layer), cut from 3
# for the script's time: each tensor-parallel layer adds two host all-reduces a forward
DEEPSEEK_TOKENS = (1, 4096)  # its pre-training length; one sequence (the capacity couples a batch)
ROUTE_FLIP_MAX = 0.03  # share of (token, layer) routes the kernel and naive passes may differ on
FIRST_FLIP_GAP_MAX = 0.02  # a token's first differing route must be a near-tie: the kernel
# pass's router probabilities at ranks k, k + 1 (or k - 1, k) closer than this
FLASH_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 2e-4}  # K4: rtol = atol = relative rms
# the model's profiler ranges (record_function): MLA, the dense FFN, the MoE parts, the
# recurrent mixers (mixer.mamba holds mamba.scan: its kernels count to the scan alone)
MODEL_LABELS = ("attn.mla", "ffn.mlp", "moe.dispatch", "moe.experts", "moe.combine",
                "mixer.mamba", "mamba.scan", "mixer.mlstm", "mixer.slstm")
# every profiler range the port opens: a range's own span on the card is not a kernel (the
# stack's groups and the train step's parts are the training path's)
PROFILER_RANGES = MODEL_LABELS + ("moe.exchange", "moe.gather", "moe.allreduce", "stack.group",
                                  "train.forward", "train.backward", "train.optimizer")
JAMBA_TOKENS = (1, 4096)  # Jamba: one sequence (the capacity couples a batch); the naive pass's
# float32 scores at 64 heads are 4.3 GiB here
MAMBA_CHECK_TOKENS = (1, 512)  # one Mamba layer's chunked scan against the step-by-step scan
MAMBA_SCAN_TOL = 1e-5  # rtol = atol: both scans float32, the sums in another order
XLSTM_TOKENS = (8, 2048)  # 2048: the context xLSTM trained at (arXiv:2405.04517)
MLSTM_FORM_TOL = 2e-4  # rtol = atol, chunked against parallel (tests/test_xlstm_forms.py's bound),
# the parallel form in float64 (in float32 its own rounding over 2048 positions exceeds the bound)
XLSTM_PROFILE_STEPS = 256  # positions of the sLSTM block profiled alone
XLSTM_DECODE_TOL = 1e-3  # rtol = atol: xLSTM decode against prefill logits, both float32
TRAIN_SMALL_LAYERS = 2  # step 11d a, d, e: TinyLlama-1.1B at full width, 2 of its 22 layers
TRAIN_CHECK_TOKENS = (2, 256)  # a: the float32 step on the card against the CPU
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL = 1e-4, 1e-5  # a: ||Δ|| / ||g|| per leaf; the loss, relative
MAMBA_GRAD_TOL = 1e-5  # b: ||Δ|| / ||want|| of the output and of each input's gradient
TRAIN_TOKENS = (8, 2048)  # c, d, e: the prefill cell's tokens (TinyLlama's published context)
TRAIN_STEPS = 4  # c: launcher steps, all inside the warmup; the final checkpoint follows the
# last. Cut from 6 for the script's time
TRAIN_LR = 4e-4  # c, d, e: TinyLlama's published peak learning rate (arXiv:2401.02385); the
# launcher's default 3e-3 is the smoke configs' and made the whole model's loss swing 8-15
RESTART_TOL = 1e-4  # d, e: resumed and elastic losses (tests/test_elastic.py's bound)
ELASTIC_FAILURES = {3: [1], 7: [4]}  # e: tests/test_elastic.py's cascade on D3(2,2)
SERVE_REQUESTS, SERVE_NEW = 6, 12  # the engine checks: 4 slots, so slots are reused
LOGIT_MAX_ABS, LOGIT_REL_RMS, LOSS_REL = 0.5, 0.05, 1e-3  # bf16 model-path tolerances
RANKS = 8  # per-shard phase: D3(2,2), the shape of one 8-GPU node, all on one card here
CALLS = 5  # back-to-back allreduce_shard calls with fresh data
SKEW = (2, 3, 0.05)  # in call 2, rank 3 sleeps 50 ms before its first put
EP_MESH = (1, 8)  # EP phase: (data, model); the model axis is dragonfly_layout(8) = D3(2,2)
EP_MODES = ("xla", "dragonfly", "dragonfly_overlap", "dragonfly_overlap_fused")
EP_CALLS = 1  # timed calls of the EP layer per mode, after a warm-up
EP_FORWARD_LAYERS = 1  # layers of the EP model forward (part b), of the 8 the weights hold;
# cut from 8, then 2, for the script's time (steps 18 e, 17 c and 19 c took the room)
EP_PHASE_S = 150  # the EP phase's time budget: a phase past it says so
TP_MESH = (1, 16)  # TP phase: the production model axis; 8 experts do not split over 16
TP_CALLS = 1  # timed calls of the TP layer, after a warm-up
TP_FORWARD_LAYERS = 1  # layers of the TP model forward (part b); cut from 8, then 2, for the
# script's time
TP_FORWARD_TOKENS = (1, 4096)  # cut from (1, 8192), where 16 ranks ran out of the card's memory
ORDER_CALLS = 8  # known all-reduces gloo's summation order is read off (one more is held out)
TP_PHASE_S = 300  # the TP phase's time budget
DS_EP_MESH = (1, 16)  # step 17: DeepSeek-V3 on the production model axis, 16 of 256 experts a rank
DS_EP_CALLS = 1  # timed calls of its layer per mode, after a warm-up
DS_EP_PHASE_S = 300  # step 17's time budget
DS_DECODE_ROWS = 16  # 17 c: decode rows, one a rank of the model axis (EP takes them: 16 % 16)
DS_DECODE_SEQ = 4096  # 17 c: the cache's positions (its pre-training length), 256 a rank
CHECKSUM_CHUNK = 1 << 24  # int16 values a bits checksum sums at once (128 MiB of int64)
FLEET_HOST, FLEET_GUEST = (2, 2), (1, 2)  # D3(2,2): 8 ranks; two D3(1,2) guests of 4 devices
FLEET_LAYERS = 1  # of Mixtral's 32, per tenant: 3.2 GB of bf16 weights each; cut from 2 for the
# script's time when steps 18 f and g came (every decode step replays one MoE boundary a layer)
FLEET_SLOTS, FLEET_REQUESTS, FLEET_NEW, FLEET_MAX_SEQ = 2, 3, 4, 32  # FLEET_NEW cut from 8
# for the script's time: every arm still decodes after its prefill, the evict comes mid-traffic
FLEET_FFN_TOL = 1e-4  # float32 expert FFN, the replay's wave batches against one batch
FLEET_PHASE_S = 300  # the fleet phase's time budget
AUTO_MATMUL_BLOCK = 128  # the autotuner's matmul key: X = 128, not the cell's 512. Its sendrecv
# candidate, the NumPy trace interpreter, replays 2.7–2.9 s a call at X = 128 (the autotune line),
# X = 512 has 16 times the bytes and 64 times the block products, and the tuner times 4 calls
AUTO_PHASE_S = 240  # the global-site autotuner step's time budget
AUTO_CHUNK = CHUNK // 8  # the autotuner's all-to-all key: 32 KiFloat a (src, dst) chunk (8
# tokens × 4096), and its all-reduce and broadcast key: an eighth of the bucket. Cut
# for the script's time, as AUTO_MATMUL_BLOCK was: at the cells' bytes the sendrecv candidate
# took 77 s of the all-reduce's decision and 36 s of the all-to-all's (measured on one H100);
# at a quarter 8.7 and 11.8 s
AUTO_BUCKET = BUCKET // 8
TRAIN_SHARDED_MESH = (2, 2)  # step 18 a, b: (data, model) with FSDP; G = 2 and 22 split over data
TRAIN_SHARDED_CHECK_TOKENS = (4, 256)  # a: the float32 step, SyntheticLM
TRAIN_SHARDED_TOKENS = (4, 2048)  # b: TinyLlama's published context, (2, 2048) a data rank
TRAIN_SHARDED_STEPS = 1  # b: cut from 2 for the script's time; the CPU tests run 2 steps
MIXTRAL_TRAIN_LAYERS = 1  # c: of 32; the one-process oracle's weights, gradients and Adam state
# take about 20 GB at one layer, 38 at two
MIXTRAL_TRAIN_MESH = (2, 4)  # c: 8 experts, 2 a model rank: EP; the model axis is D3(4,1)
MIXTRAL_TRAIN_TOKENS = (2, 1024)  # c: (1, 1024) a data rank, T_loc 256; cut from (2, 2048) for
# the script's time when steps 18 f and g came, and before that from (2, 4096), where 8
# ranks' plain attention (float32 (1, 32, 4096, 4096) scores, 2 GiB a copy) ran the card out of
# memory (on one H100: 7.6 GiB a rank allocated when one asked for 2 more)
MIXTRAL_TRAIN_MODES = ("xla", "dragonfly", "dragonfly_overlap_fused")
#: c: the modes held to the first mode's bits (only the transport differs); the fused mode
#: differentiates its wave pipeline wave by wave, another float order: held to the oracle
MIXTRAL_SAME_BITS = ("dragonfly",)
SHARDED_REL = 1e-3  # b, c: loss, grad_norm and moe_aux against the one-process step, relative
SHARDED_M_REL = 3e-2  # c: each watched leaf's first moment, ||Δ|| / ||m||: bf16 gradients; the
# bf16 control (the one-process step in bf16 against float32) put its worst leaf's m 2.83e-2 off.
# Also the noise below which an entry of m may be exactly zero in one order of bf16 sums and not
# in another: at most this share of the leaf's rms in the ranks' oracle
RANKS_ORACLE_M_REL = 1e-3  # c: each watched leaf's m against the ranks' oracle's (the same dense
# layers and routes): 1.6e-7 in `xla`, 5.0e-5 in the fused mode (another float order) on an H100
FLIP_SHARE = 1e-4  # a, compressed: the largest share of values whose code may differ from the
# one-process step's (a value at a half-step, rounded the other way after the sharded sum):
# 1.67e-5 measured on the card; the planted truncating cast reads about 0.5
TRAIN_SHARDED_PHASE_S = 300  # step 18's time budget
PREFILL_TP_REPS = 1  # d: timed TP prefills (and whole-leaf ones), each after a warm-up; cut
#   from 2 for the script's time
DECODE_MAX_SEQ = 32768  # e: the cache's positions, 16384 a rank on the model axis of 2
DECODE_START = 32752  # e: positions below it hold bf16 values from the seed; decoding starts there
DECODE_STEPS = 8  # e: decode steps, positions DECODE_START .. DECODE_START + 7; cut from 16 for
#   the script's time when steps 18 f and g came
DECODE_ROWS = 4  # e: 18 b's batch rows, 2 a data rank
DECODE_CONTROL_STEPS = 4  # e: the first steps the float32 whole-leaf control decodes
DECODE_FILL_STD = 2.0  # e, 17 c: the filled positions' N(0, std²): keys spread enough that a
#   query's softmax leans on a few of them (at 0.5 it is near uniform over 32k positions)
RECURRENT_JAMBA_LAYERS = 2  # f: of 72, layer 0 attention and layer 1 Mamba (attn_period 2), each
#   with Jamba's dense MLP (moe None): 2.85 B parameters, 5.7 GB of bf16 a rank
RECURRENT_JAMBA_TOKENS = (2, 2048)  # f: the prefill, (1, 2048) a data rank: K4 at (1, 2048, 32/4, 128)
RECURRENT_XLSTM_LAYERS = 8  # g: of 48, one group: 7 mLSTM and 1 sLSTM
RECURRENT_XLSTM_TOKENS = (2, 512)  # g: (1, 512) a data rank: 512 per-position gathers of h
RECURRENT_DECODE_ROWS = 4  # f, g: decode rows, 2 a data rank
RECURRENT_DECODE_SEQ = 4096  # f: Jamba's attention cache, 2048 positions a rank
RECURRENT_DECODE_STEPS = 8  # f, g: decode steps from RECURRENT_DECODE_SEQ - 8
RECURRENT_CONTROL_FACTOR = 2.0  # f, g: each TP output no farther from the float32 control (whole
#   leaves) than this many times the whole leaves' bf16 output is, relative rms
#: 19 a: (arch, shape, multi-pod, rules changes, tag, expected status) of the dry run on meta
DRYRUN_CELLS = (
    ("tinyllama-1.1b", "train_4k", False, {}, "", "ok"),          # the sharded step
    ("deepseek-v3-671b", "prefill_32k", False, {}, "", "ok"),     # EP, 16 experts a rank
    ("mixtral-8x7b", "decode_32k", False, {}, "", "ok"),          # TP, the cache specs
    ("olmo-1b", "train_4k", True, {"fsdp": True}, "fsdp", "FAILED"),  # 16 layers over 32
    ("xlstm-1.3b", "decode_32k", False, {}, "", "ok"),            # the recurrent states' shards
)
#: 19 b, c: the cells run on the card as well, each its rank's share: the prefill with K4,
#: and the tensor-parallel decode over the rank's block of the sequence-sharded cache (no K4)
DRYRUN_CARD_CELLS = (("tinyllama-1.1b", "prefill_32k", False, {}, "", "ok"),
                     ("tinyllama-1.1b", "decode_32k", False, {}, "", "ok"))
DRYRUN_PEAK_REL = 0.10  # b: the meta trace's peak against max_memory_allocated, relative
DRYRUN_PHASE_S = 90  # step 19's time budget
EXAMPLE_TIMEOUT_S = 180  # step 20: the serve_moe example's process, start-up included
EXAMPLE_REQUESTS, EXAMPLE_NEW_TOKENS = 5, 8  # what the example serves


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def attention_close(got, want, tol):
    """|Δ| <= tol + tol·|want| everywhere and ||Δ|| <= tol·||want||:
    whether both hold, max |Δ| and the relative rms error."""
    got, want = got.float(), want.float()
    diff = got - want
    rel = float(diff.norm() / want.norm())
    ok = bool((diff.abs() <= tol + tol * want.abs()).all()) and rel <= tol
    return ok, float(diff.abs().max()), rel


def route_flips(k_routes, n_routes, k):
    """(layer, token) routes that differ between two passes' per-layer
    (expert ids, kept, router logits): in any order, as a set, and first
    for the token (before it, the token's routes agreed in every layer);
    for the first ones, the first pass's gap between the router
    probabilities of ranks k and k + 1 or k - 1 and k."""
    import torch

    diff = torch.stack([(a != b).any(-1) for (a, *_), (b, *_) in zip(k_routes, n_routes)])
    set_diff = torch.stack([(a.sort(-1)[0] != b.sort(-1)[0]).any(-1)
                            for (a, *_), (b, *_) in zip(k_routes, n_routes)])
    first = diff & (diff.int().cumsum(0) == 1)
    probs = torch.stack([torch.softmax(lg.float(), -1).sort(-1, descending=True)[0]
                         for _, _, lg in k_routes])  # (L, T, E)
    gap = (probs[..., :k + 1].diff(dim=-1).abs()).amin(-1)  # nearest boundary among ranks 1..k+1
    return {"share": float(diff.float().mean()), "set_share": float(set_diff.float().mean()),
            "by_layer": diff.sum(1).tolist(), "first_by_layer": first.sum(1).tolist(),
            "tokens_ever": int(diff.any(0).sum()),
            "first_gap_median": float(gap[first].median()) if first.any() else None,
            "first_gap_max": float(gap[first].max()) if first.any() else None,
            "all_gap_median": float(gap.median())}


def zero_counts(wrappers) -> None:
    """Set every launch count of these kernel wrappers to 0, each body's too."""
    for fn in wrappers:
        fn.launches = 0
        if hasattr(fn, "body_launches"):
            fn.body_launches = dict.fromkeys(fn.body_launches, 0)
        if hasattr(fn, "acc_launches"):
            fn.acc_launches = 0


def timing_decisions(tuner) -> list:
    """Wrap ``tuner.decide`` so that each call's wall seconds are appended
    to the returned list (a memo hit's too)."""
    seconds, real = [], tuner.decide

    def timed(*args, **kw):
        t0 = time.perf_counter()
        dec = real(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return dec

    tuner.decide = timed
    return seconds


def autotune_seeds(dev, time_ms) -> dict:
    """The autotuner's measured seeds on this card: ``BANDWIDTH``, bytes a
    second of one 25 MiB device-to-device ``copy_`` (best of 20, CUDA
    events), and ``T_KERNEL``, seconds of one K2 (``combine_rows``) launch
    on (16, 64) float32 rows of grid (2, 2)'s first combine group, 200
    launches back to back (median of 5)."""
    import torch

    from repro_torch.dist import collectives as dc
    from repro_torch.runtime import optimize as opt
    from repro_torch.runtime.backends import cuda_fused as cf

    src = torch.randn(BUCKET, device=dev)
    dst = torch.empty_like(src)
    for _ in range(3):
        dst.copy_(src)
    best = float("inf")
    for _ in range(20):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    prog = dc.matmul_program(2, 2, optimized=True)
    tabs = next(t for kind, _, t in opt.matmul_tables(prog) if kind == "combine")
    tc = opt.to_device_tables(tabs, dev)
    tc["packed"] = cf.pack_tables(tc["gather"], tc["mask"])
    val = torch.randn(prog.n, 64, device=dev)
    launch_ms = time_ms(lambda: cf.combine_rows(val, tc["gather"], tc["mask"], packed=tc["packed"]),
                        reps=5, warmup=3, calls=200)
    return {"BANDWIDTH": BUCKET * 4 / (best * 1e-3), "copy_bytes": BUCKET * 4, "copy_ms": best,
            "T_KERNEL": launch_ms * 1e-3, "k2_rows": [prog.n, 64]}


def per_shard_rank(rank, group, layout, seed):
    """One rank of the per-shard phase: CALLS back-to-back calls of
    ``CudaFusedBackend().allreduce_shard`` on a fresh 25 MiB buffer each
    (one rank late by SKEW), with K5's launch counts set to 0 just before
    and read just after; then each call held bit for bit against the plain
    version on host copies, and this rank's times. Returns host data."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as dc
    from repro_torch.launch.mesh import rank_device
    from repro_torch.runtime.backends import cuda_fused as cf

    dev = rank_device(rank)
    prog = dc.allreduce_program(layout)
    be = cf.CudaFusedBackend()
    gen = torch.Generator(device=dev).manual_seed(seed + rank)
    xs = [torch.randn(BUCKET, generator=gen, device=dev) for _ in range(CALLS)]
    k5 = (cf.ring_put, cf.ring_signal, cf.ring_wait_add)
    torch.cuda.synchronize()
    dist.barrier()
    for kernel in k5:
        kernel.launches = 0
    outs = []
    for call, x in enumerate(xs):
        if (call, rank) == SKEW[:2]:
            time.sleep(SKEW[2])
        outs.append(be.allreduce_shard(x, group, prog))
    counts = {kernel.__name__: kernel.launches for kernel in k5}

    err = 0.0
    for call, (x, got) in enumerate(zip(xs, outs)):
        want, got = cf.allreduce_shard_plain(x.cpu(), group, prog), got.cpu()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"rank {rank}, call {call}: K5 differs from the plain exchange")
        err = max(err, float((got - want).abs().max()))

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def event_ms(fn, reps):
        times = []
        for _ in range(reps):
            dist.barrier()
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    x, xh = xs[0], xs[0].cpu()
    window, partners = cf.ring_window(group, x, prog), cf.ring_partners(prog)
    call_ms = host_ms(lambda: be.allreduce_shard(x, group, prog), 10)
    plain_ms = host_ms(lambda: cf.allreduce_shard_plain(xh, group, prog), 3)
    dst = torch.empty_like(x)
    copy_ms = event_ms(lambda: dst.copy_(x), 10)
    put_ms, wait_ms = [], []
    for _ in range(10):  # allreduce_shard's rounds, with events around put and wait
        dist.barrier()
        window.epoch += 1
        val, events = x, []
        for r, table in enumerate(partners):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            e[0].record()
            cf.ring_put(val, window, r, int(table[rank]))
            e[1].record()
            cf.ring_signal(window, r, int(table[rank]))
            if window.shared:  # as ring_exchange
                torch.cuda.current_stream().synchronize()
                dist.barrier()
            e[2].record()
            val = cf.ring_wait_add(val, window, r, int(table[rank]))
            e[3].record()
            events.append(e)
        window.check()
        put_ms += [e[0].elapsed_time(e[1]) for e in events]
        wait_ms += [e[2].elapsed_time(e[3]) for e in events]
    orchestration = "barrier" if window.shared else "spin"
    cf.close_ring_windows(group)
    return {"counts": counts, "rounds": len(partners), "max_abs_err": err,
            "orchestration": orchestration,
            "out0": outs[0].cpu().numpy(), "call_ms": call_ms, "plain_ms": plain_ms,
            "copy_ms": copy_ms, "put_ms": statistics.median(put_ms),
            "wait_ms": statistics.median(wait_ms)}


def ep_rank(rank, group, layout, mparams, cfg, x, tokens, want_y, layers_b, tune_dir):
    """One rank of the EP phase, on a (1, 8) mesh of processes sharing the
    card. ``mparams`` are the parent's weights, shared through CUDA IPC:
    the rank takes its expert of every layer as a view and writes to none.

    a) layer 0's MoE alone on ``x`` in every mode through
       ``moe_apply_auto`` under active rules: the first call's output and
       routes are kept (and held against the one-process ``want_y`` and
       between the modes here), then EP_CALLS timed calls (from a barrier
       to the device's end), then one call under ``moe.timing_parts``;
       then the layer with ``moe_collectives="auto"`` on a measuring tuner
       of its own cache file in ``tune_dir`` (the decision measured on the
       model group and agreed by all ranks, each decision's wall time
       kept), its output held against the named mode's, a second call (a
       memo hit) timed, and ``Engine.collective_report()`` under the
       ``auto`` rules;
    b) ``forward_train`` with K4 on ``tokens`` in the ``dragonfly`` mode over
       ``layers_b`` layers, its K4 launches counted, then ``loss_fn``, one
       forward under ``timing_parts`` and one timed forward.
    Returns host data."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.runtime import autotune as AT
    from repro_torch.serve.engine import Engine

    dev = x.device
    mesh = make_mesh(EP_MESH, ("data", "model"), device=dev.type)
    SH.set_active(SH.ShardRules(), mesh)
    rules = SH.active()[0]
    # this rank's experts: views of the shared stacks, read only
    params = {**mparams, "stack": [
        {**layer, "ffn": MOE.local_experts(layer["ffn"], cfg, rules, mesh.coords, mesh.sizes)}
        for layer in mparams["stack"]]}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wall_ms(fn):
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")

    def reset_peak():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    # a) the MoE layer alone, in every mode
    ffn0 = params["stack"][0]["ffn"]
    layer = {"modes": {}}
    outs = {}
    for mode in EP_MODES:
        SH.set_active(SH.ShardRules(moe_collectives=mode), mesh)
        mesh.carrier_copies = mesh.carrier_bytes = 0
        reset_peak()
        with MOE.recording_routes() as routes:
            (y, aux), first_ms = wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))
        copies = {"copies": mesh.carrier_copies, "bytes": mesh.carrier_bytes}
        times = [wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))[1] for _ in range(EP_CALLS)]
        with MOE.timing_parts() as parts:
            wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))
        (_, keep, _), = routes
        outs[mode] = (y, aux)
        layer["modes"][mode] = {"first_ms": first_ms, "call_ms": times, "parts": dict(parts),
                                "carrier_per_call": copies, "dropped": int((~keep).sum()),
                                "entries": keep.numel(), "peak_gib": peak_gib()}
    # a') the autotuner's pick, agreed by every rank, then a memo hit
    tuner = AT.Autotuner(cache_path=pathlib.Path(tune_dir) / f"ep-{rank}.json", device=dev)
    decide_s = timing_decisions(tuner)
    AT.set_autotuner(tuner)
    SH.set_active(SH.ShardRules(moe_collectives="auto"), mesh)
    (y_auto, aux_auto), first_ms = wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))
    dec = tuner.decisions[-1]
    mode = AT.EP_MODE[dec.strategy]
    (y_memo, _), memo_ms = wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))
    memo_hit = len(tuner.decisions) == 1 and len(decide_s) == 2
    report = Engine(cfg, params, 4, 128, device=dev).collective_report()
    AT.set_autotuner(None)
    same = [torch.equal(y.view(torch.int16), outs[mode][0].view(torch.int16))
            for y in (y_auto, y_memo)]
    layer["auto"] = {"key": str(dec.key), "strategy": dec.strategy, "source": dec.source,
                     "mode": mode, "measured_us": dec.measured_us, "analytic_us": dec.analytic_us,
                     "decide_ms": decide_s[0] * 1e3, "memo_decide_ms": decide_s[1] * 1e3,
                     "first_call_ms": first_ms, "memo_call_ms": memo_ms, "memo_hit": memo_hit,
                     "bits_equal_named_mode": all(same),
                     "aux_equal_named_mode": float(aux_auto) == float(outs[mode][1]),
                     "engine_report": report}
    del y_auto, y_memo
    xla_y = outs["xla"][0]
    layer["bit_identical_to_xla"] = {
        mode: bool(torch.equal(outs[mode][0].view(torch.int16), xla_y.view(torch.int16)))
        for mode in EP_MODES}
    layer["fused_vs_xla"] = attention_close(outs[EP_MODES[3]][0], xla_y,
                                            FLASH_TOL[str(x.dtype)])
    layer["vs_plain"] = {mode: attention_close(outs[mode][0], want_y, FLASH_TOL[str(x.dtype)])
                         for mode in EP_MODES}
    layer["aux"] = {mode: float(outs[mode][1]) for mode in EP_MODES}
    layer["finite"] = all(bool(torch.isfinite(y).all()) for y, _ in outs.values())
    layer["shape_ok"] = all(y.shape == x.shape and y.dtype == x.dtype for y, _ in outs.values())
    layer["transport"], layer["carrier"] = mesh.transport, str(mesh.carrier)
    del outs, xla_y, y

    # b) the model forward under EP, the dragonfly mode, K4 on, on the
    # rank's compute leaves: views of the shared weights, the attention,
    # the embedding and the unembedding cut on the model axis too
    SH.set_active(SH.ShardRules(moe_collectives="dragonfly"), mesh)
    cfg_b = dataclasses.replace(cfg, n_layers=layers_b)
    params_b = M.local_params({**mparams, "stack": mparams["stack"][:layers_b]}, cfg_b,
                              SH.active()[0], mesh.coords, mesh.sizes)
    batch = {"tokens": tokens, "labels": tokens}
    flash_attention.launches = 0
    flash_attention.body_launches = dict.fromkeys(flash_attention.body_launches, 0)
    reset_peak()
    with MOE.recording_routes() as routes:
        (logits, aux, _), first_ms = wall_ms(lambda: M.forward_train(params_b, batch, cfg_b, True))
    k4 = {"launches": flash_attention.launches, "bodies": dict(flash_attention.body_launches)}
    model = {"k4": k4, "first_ms": first_ms, "aux": float(aux),
             "finite": bool(torch.isfinite(logits).all()),
             "last_logits": M.whole_logits(logits[:, -1:])[:, 0].float().cpu(),
             "routes": [(idx.cpu(), keep.cpu(), lg.float().cpu()) for idx, keep, lg in routes]}
    del logits
    model["loss"] = float(M.loss_fn(params_b, batch, cfg_b, True)[0])
    with MOE.timing_parts() as parts:
        # the output dropped at once: kept, it doubled the logits held in the timed forward
        parts_ms = wall_ms(lambda: M.forward_train(params_b, batch, cfg_b, True))[1]
    model["parts"], model["parts_wall_ms"] = dict(parts), parts_ms
    model["ms"] = wall_ms(lambda: M.forward_train(params_b, batch, cfg_b, True))[1]
    model["peak_gib"] = peak_gib()
    SH.clear_active()
    _release_shared(mparams)
    return {"layer": layer, "model": model}


def ep_phase(dev, mparams, mcfg, seed):
    """The expert-parallel path at Mixtral-8x7B's full width on 8 ranks that
    share the card (gloo, the host as the exchanges' carrier). Returns its
    record and K4's launches (per rank, all ranks)."""
    import torch

    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    t_phase = time.perf_counter()
    n_data, n_model = EP_MESH
    ranks_n = n_data * n_model
    layout = dragonfly_layout(n_model)
    require((layout.topo.K, layout.topo.M) == (2, 2), f"dragonfly_layout({n_model}) is {layout.topo}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, S = MIXTRAL_TOKENS
    x = torch.randn((B, S, mcfg.d_model), generator=gen, device=dev).to(
        getattr(torch, mcfg.compute_dtype))
    tokens = torch.randint(1, mcfg.vocab, MIXTRAL_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    T_loc = B * S // ranks_n
    C = MOE.ep_capacity(mcfg, T_loc)
    E_loc = mcfg.moe.num_experts // n_model
    buf_bytes = n_model * E_loc * C * mcfg.d_model * x.element_size()

    # the one-process oracles: layer 0 and the forward with every MoE layer
    # as moe_apply_ep_plain (the main path's launches are counted in the ranks)
    ffn0 = mparams["stack"][0]["ffn"]
    want_y, want_aux = MOE.moe_apply_ep_plain(ffn0, x, mcfg, n_data, n_model)
    cfg_b = dataclasses.replace(mcfg, n_layers=EP_FORWARD_LAYERS)
    params_b = {**mparams, "stack": mparams["stack"][:EP_FORWARD_LAYERS]}
    batch = {"tokens": tokens, "labels": tokens}
    auto = MOE.moe_apply_auto
    MOE.moe_apply_auto = lambda p, h, c: MOE.moe_apply_ep_plain(p, h, c, n_data, n_model)
    try:
        with MOE.recording_routes() as plain_routes:
            plain_logits = M.forward_train(params_b, batch, cfg_b, True)[0]
        plain_last = plain_logits[:, -1].float()
        del plain_logits
        plain_loss = float(M.loss_fn(params_b, batch, cfg_b, True)[0])
    finally:
        MOE.moe_apply_auto = auto
    torch.cuda.synchronize()
    before = _checksum(mparams)

    build.build_all()  # the ranks only load the libraries
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="autotune-ep-") as tune_dir:
        ranks = spawn(ep_rank, ranks_n, device="cuda",
                      args=(mparams, mcfg, x, tokens, want_y, EP_FORWARD_LAYERS, tune_dir))
    ranks_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()  # free what the ranks released of the shared tensors
    require(_checksum(mparams) == before, "a rank wrote to the shared weights")

    # a) the layer
    lay = [r["layer"] for r in ranks]
    for r, rec in enumerate(lay):
        require(rec["finite"] and rec["shape_ok"], f"EP layer, rank {r}: shape or non-finite")
        require(all(rec["bit_identical_to_xla"][m] for m in EP_MODES[:3]),
                f"EP layer, rank {r}: xla, dragonfly and dragonfly_overlap differ: "
                f"{rec['bit_identical_to_xla']}")
        require(rec["fused_vs_xla"][0], f"EP layer, rank {r}: fused vs xla {rec['fused_vs_xla']}")
        for mode, (ok, err, rel) in rec["vs_plain"].items():
            require(ok, f"EP layer, rank {r}, {mode}: off the plain version by max {err}, "
                        f"relative rms {rel}")
        require(len(set(rec["aux"].values())) == 1, f"EP layer, rank {r}: aux {rec['aux']}")
    require(all(rec["aux"] == lay[0]["aux"] for rec in lay), "EP layer: aux differs between ranks")
    autos = [rec["auto"] for rec in lay]
    for r, a in enumerate(autos):
        require((a["key"], a["strategy"], a["source"], a["measured_us"]) == (
            autos[0]["key"], autos[0]["strategy"], "measured", autos[0]["measured_us"]),
            f"EP auto, rank {r}: decided {a['strategy']} ({a['source']}), rank 0 "
            f"{autos[0]['strategy']}")
        require(a["bits_equal_named_mode"] and a["aux_equal_named_mode"] and a["memo_hit"],
                f"EP auto, rank {r}: not the bits of {a['mode']}, or no memo hit: {a}")
        rep = a["engine_report"]
        require(rep["status"] == "ok" and rep["source"] == "measured" and
                (rep["strategy"], rep["measured_us"]) == (
                    autos[0]["engine_report"]["strategy"], autos[0]["engine_report"]["measured_us"]),
                f"EP auto, rank {r}: Engine.collective_report {rep}")
    aux_rel = abs(lay[0]["aux"]["xla"] - float(want_aux)) / abs(float(want_aux))
    require(aux_rel < 1e-5, f"EP layer aux {lay[0]['aux']['xla']} vs plain {float(want_aux)}")
    modes = {}
    for mode in EP_MODES:
        recs = [rec["modes"][mode] for rec in lay]
        per_call = [max(rec["call_ms"][i] for rec in recs) for i in range(EP_CALLS)]
        parts = {key: statistics.median(rec["parts"][key] for rec in recs)
                 for key in ("exchange_ms", "experts_ms", "gather_ms")}
        modes[mode] = {
            "call_ms": statistics.median(per_call), "call_ms_each": per_call,
            "first_call_ms": max(rec["first_ms"] for rec in recs),
            "median_rank_parts_ms": parts,
            "carrier_copies_per_call": recs[0]["carrier_per_call"],
            "dropped_share": sum(rec["dropped"] for rec in recs) / sum(rec["entries"] for rec in recs),
            "peak_gib_per_rank_max": max(rec["peak_gib"] for rec in recs),
            "bit_identical_to_xla": lay[0]["bit_identical_to_xla"][mode],
            "vs_plain": {"max_abs_err": max(rec["vs_plain"][mode][1] for rec in lay),
                         "rel_rms": max(rec["vs_plain"][mode][2] for rec in lay)}}
    layer_rec = {"x": list(x.shape), "dtype": str(x.dtype), "T_loc": T_loc, "C_loc": C,
                 "dispatch_buffer": [n_model, E_loc, C, mcfg.d_model],
                 "bytes_sent_per_rank": 2 * buf_bytes * (n_model - 1) // n_model,
                 "gather_bytes_received_per_rank": (n_model - 1) * T_loc * mcfg.d_model
                 * x.element_size(),
                 "transport": lay[0]["transport"], "carrier": lay[0]["carrier"],
                 "fused_vs_xla": {"max_abs_err": max(rec["fused_vs_xla"][1] for rec in lay),
                                  "rel_rms": max(rec["fused_vs_xla"][2] for rec in lay)},
                 "tol": FLASH_TOL[str(x.dtype)], "aux": lay[0]["aux"]["xla"],
                 "plain_aux": float(want_aux), "modes": modes,
                 "auto": {"key": autos[0]["key"], "strategy": autos[0]["strategy"],
                          "mode": autos[0]["mode"], "ranks_agree": len(autos),
                          "measured_us": autos[0]["measured_us"],
                          "mode_call_ms": {m: modes[m]["call_ms"] for m in EP_MODES},
                          "analytic_us": autos[0]["analytic_us"],
                          "decide_ms_max_rank": max(a["decide_ms"] for a in autos),
                          "first_call_ms_max_rank": max(a["first_call_ms"] for a in autos),
                          "memo_call_ms_max_rank": max(a["memo_call_ms"] for a in autos),
                          "memo_decide_ms_max_rank": max(a["memo_decide_ms"] for a in autos),
                          "bits_equal_named_mode": True,
                          "engine_report": autos[0]["engine_report"]}}

    # b) the model forward
    mod = [r["model"] for r in ranks]
    k4 = {"launches": EP_FORWARD_LAYERS,
          "bodies": {"mma_sync": 0, "wgmma": EP_FORWARD_LAYERS}}
    for r, rec in enumerate(mod):
        require(rec["k4"] == k4, f"EP forward, rank {r}: K4 launched {rec['k4']}, expected {k4}")
        require(rec["finite"], f"EP forward, rank {r}: non-finite logits")
    last = mod[0]["last_logits"].to(dev)
    err = float((last - plain_last).abs().max())
    rel = float((last - plain_last).norm() / plain_last.norm())
    require(err <= LOGIT_MAX_ABS and rel <= LOGIT_REL_RMS,
            f"EP forward: last-token logits off the one-process forward by max {err}, "
            f"relative rms {rel}")
    loss_rel = abs(mod[0]["loss"] - plain_loss) / abs(plain_loss)
    require(loss_rel <= LOSS_REL, f"EP forward loss {mod[0]['loss']} vs one-process {plain_loss}")
    ep_routes = [tuple(torch.cat([rec["routes"][li][j] for rec in mod]) for j in range(3))
                 for li in range(EP_FORWARD_LAYERS)]
    flips = route_flips(ep_routes, [tuple(t.cpu() for t in r) for r in plain_routes],
                        mcfg.moe.top_k)
    require(flips["share"] < ROUTE_FLIP_MAX and (flips["first_gap_max"] or 0) < FIRST_FLIP_GAP_MAX,
            f"EP forward: routes differ from the one-process forward's: {flips}")
    fwd_ms = max(rec["ms"] for rec in mod)
    parts_wall = max(rec["parts_wall_ms"] for rec in mod)
    ex = statistics.median(rec["parts"]["exchange_ms"] + rec["parts"]["gather_ms"] for rec in mod)
    model_rec = {"layers": f"{EP_FORWARD_LAYERS} of {mcfg.n_layers} held on the card",
                 "tokens": list(MIXTRAL_TOKENS), "mode": "dragonfly", "ms": fwd_ms,
                 "first_ms": max(rec["first_ms"] for rec in mod),
                 "tokens_per_s": B * S / fwd_ms * 1e3,
                 "exchange_and_gather_share": ex / parts_wall, "timed_with_parts_ms": parts_wall,
                 "median_rank_parts_ms": {key: statistics.median(rec["parts"][key] for rec in mod)
                                          for key in ("exchange_ms", "experts_ms", "gather_ms")},
                 "k4_per_rank": k4, "peak_gib_per_rank_max": max(rec["peak_gib"] for rec in mod),
                 "loss": mod[0]["loss"], "plain_loss": plain_loss, "aux": mod[0]["aux"],
                 "last_logits_vs_plain": {"max_abs_err": err, "rel_rms": rel},
                 "route_flips": flips}
    del want_y, plain_last, last, x, tokens
    return {"run": "moe_ep", "model": mcfg.name, "mesh": {"data": n_data, "model": n_model},
            "model_axis_layout": "D3(2,2)", "ranks_s": ranks_s,
            "phase_s": time.perf_counter() - t_phase, "weights_unchanged": True,
            "layer": layer_rec, "forward": model_rec}, ranks_n * EP_FORWARD_LAYERS


def tp_rank(rank, group, layout, mparams, cfg, x, tokens, layers_b, order_shapes):
    """One rank of the TP phase, on a (1, 16) mesh of processes sharing the
    card. ``mparams`` are the parent's weights, shared through CUDA IPC:
    the rank takes its ff slice of every expert as a view and writes to
    none.

    0) ``ObservedSumOrder.observe``: ORDER_CALLS + 1 all-reduces of known
       data over the model group at each shape of ``order_shapes`` (the
       partial outputs' (E, C_loc, d) of parts a and b), so that the
       parent can read gloo's summation order and sum its oracle in it;
    a) layer 0's MoE alone on ``x`` through ``moe_apply_auto`` under active
       rules (it takes TP: 8 experts do not split over 16 model ranks):
       the first call's output and routes kept, then TP_CALLS timed calls
       (from a barrier to the device's end), then one call under
       ``moe.timing_parts``;
    b) ``forward_train`` with K4 on ``tokens`` over ``layers_b`` layers, its
       K4 launches counted and its routes kept, then ``loss_fn``, one
       forward under ``timing_parts`` and one timed forward.
    Returns host data: the outputs, routes and logits on rank 0 only, the
    bits of the rest on every rank."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    dev = x.device
    mesh = make_mesh(TP_MESH, ("data", "model"), device=dev.type)
    SH.set_active(SH.ShardRules(), mesh)
    rules = SH.active()[0]
    # this rank's ff slice of every expert: views of the shared stacks, read only
    params = {**mparams, "stack": [
        {**layer, "ffn": MOE.local_experts(layer["ffn"], cfg, rules, mesh.coords, mesh.sizes)}
        for layer in mparams["stack"]]}
    t0 = time.perf_counter()
    orders = {shape: MOE.ObservedSumOrder.observe(mesh, "model", shape, x.dtype,
                                                  calls=ORDER_CALLS + 1)
              for shape in order_shapes}
    order_s = time.perf_counter() - t0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wall_ms(fn):
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")

    def reset_peak():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def bits(t):
        return int(t.contiguous().view(torch.int16).sum(dtype=torch.int64))

    def mine(t):
        return t.cpu() if rank == 0 else None

    # a) the MoE layer alone
    ffn0 = params["stack"][0]["ffn"]
    held = list(ffn0["w_in"].shape)
    views = all(ffn0[k].untyped_storage().data_ptr() == mparams["stack"][0]["ffn"][k]
                .untyped_storage().data_ptr() for k in ("w_in", "w_gate", "w_out"))
    mesh.carrier_copies = mesh.carrier_bytes = 0
    reset_peak()
    with MOE.recording_routes() as routes:
        (y, aux), first_ms = wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))
    copies = {"copies": mesh.carrier_copies, "bytes": mesh.carrier_bytes}
    times = [wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))[1] for _ in range(TP_CALLS)]
    with MOE.timing_parts() as parts:
        wall_ms(lambda: MOE.moe_apply_auto(ffn0, x, cfg))
    (idx, keep, _), = routes
    layer = {"first_ms": first_ms, "call_ms": times, "parts": dict(parts),
             "carrier_per_call": copies, "peak_gib": peak_gib(), "held": held, "views": views,
             "y": mine(y), "bits": bits(y), "aux": float(aux),
             "finite": bool(torch.isfinite(y).all()),
             "shape_ok": y.shape == x.shape and y.dtype == x.dtype,
             "transport": mesh.transport, "carrier": str(mesh.carrier),
             "route_idx": mine(idx), "route_keep": mine(keep)}
    del y

    # b) the model forward under TP, K4 on, on the rank's compute leaves:
    # views of the shared weights, the attention (2 of 32 query heads, the
    # KV head they read gathered), the embedding and the unembedding cut on
    # the model axis too
    cfg_b = dataclasses.replace(cfg, n_layers=layers_b)
    params_b = M.local_params({**mparams, "stack": mparams["stack"][:layers_b]}, cfg_b, rules,
                              mesh.coords, mesh.sizes)
    batch = {"tokens": tokens, "labels": tokens}
    flash_attention.launches = 0
    flash_attention.body_launches = dict.fromkeys(flash_attention.body_launches, 0)
    reset_peak()
    with MOE.recording_routes() as routes:
        (logits, aux, _), first_ms = wall_ms(lambda: M.forward_train(params_b, batch, cfg_b, True))
    k4 = {"launches": flash_attention.launches, "bodies": dict(flash_attention.body_launches)}
    last = M.whole_logits(logits[:, -1:])[:, 0]
    model = {"k4": k4, "first_ms": first_ms, "aux": float(aux),
             "finite": bool(torch.isfinite(logits).all()),
             "last_logits": mine(last), "logits_bits": bits(last),
             "routes": [tuple(t.cpu() for t in r) for r in routes] if rank == 0 else None}
    del logits, last
    model["loss"] = float(M.loss_fn(params_b, batch, cfg_b, True)[0])
    with MOE.timing_parts() as parts:
        # the output dropped at once: kept, it doubled the logits held in the timed forward
        parts_ms = wall_ms(lambda: M.forward_train(params_b, batch, cfg_b, True))[1]
    model["parts"], model["parts_wall_ms"] = dict(parts), parts_ms
    model["ms"] = wall_ms(lambda: M.forward_train(params_b, batch, cfg_b, True))[1]
    model["peak_gib"] = peak_gib()
    SH.clear_active()
    _release_shared(mparams)
    return {"layer": layer, "model": model, "order_s": order_s,
            "orders": orders if rank == 0 else None}


def read_order(outputs, n_model, dev):
    """gloo's summation order read off the first ORDER_CALLS of a rank's
    observed all-reduces (``ObservedSumOrder.read``), and whether it sums
    the held-out last call's inputs to that call's output bit for bit."""
    import torch

    from repro_torch.models import moe as MOE

    order = MOE.ObservedSumOrder.read(outputs[:ORDER_CALLS], n_model, dev)
    last = outputs[ORDER_CALLS]
    held_out = torch.equal(order(MOE.ObservedSumOrder.inputs(
        ORDER_CALLS, n_model, last.shape, last.dtype, dev)).view(torch.int16),
        last.to(dev).view(torch.int16))
    return order, held_out


def tp_phase(dev, mparams, mcfg, seed):
    """The tensor-parallel path at Mixtral-8x7B's full width on 16 ranks
    that share the card (gloo, the host as the all-reduce's carrier), the
    production model axis, where 8 experts do not split and
    ``moe_apply_auto`` takes TP. Reuses the EP phase's weights (shared by
    CUDA IPC, no second copy). The ranks' layer is held bit for bit
    against the one-process ``moe_apply_tp_plain`` summing the partials in
    gloo's order, read off known all-reduces; their tensor-parallel
    forward against the one-process forward with that oracle, by step 8's
    criteria. Returns its record and K4's launches (all ranks)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    t_phase = time.perf_counter()
    n_data, n_model = TP_MESH
    ranks_n = n_data * n_model
    E, ff, d = mcfg.moe.num_experts, mcfg.moe.d_ff_expert, mcfg.d_model
    require(E % n_model != 0, f"{E} experts split over {n_model} model ranks: EP, not TP")
    B, S = MIXTRAL_TOKENS
    x = torch.randn((B, S, d), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev).to(getattr(torch, mcfg.compute_dtype))
    tokens = torch.randint(1, mcfg.vocab, TP_FORWARD_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    C = MOE.ep_capacity(mcfg, B * S)
    C_b = MOE.ep_capacity(mcfg, TP_FORWARD_TOKENS[0] * TP_FORWARD_TOKENS[1])
    order_shapes = sorted({(E, C, d), (E, C_b, d)})
    f_loc = ff // n_model
    buf_bytes = E * C * d * x.element_size()
    tol = FLASH_TOL[str(x.dtype)]
    ffn0 = mparams["stack"][0]["ffn"]

    # a rank's w_gate slice is a strided view of the last dim: does bmm copy it?
    view = ffn0["w_gate"][..., :f_loc]
    h = torch.zeros((E, C, d), dtype=x.dtype, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = torch.bmm(h, view)
    torch.cuda.synchronize()
    bmm_extra = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
    del h, out, view
    require(bmm_extra < f_loc * d * E * x.element_size(),
            f"torch.bmm copied a rank's expert stack: {bmm_extra} extra bytes")
    torch.cuda.empty_cache()
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    print(f"moe_tp: {free_gib:.1f} GiB free on the card before {ranks_n} ranks start", flush=True)
    before = _checksum(mparams)

    build.build_all()  # the ranks only load the libraries
    t0 = time.perf_counter()
    ranks = spawn(tp_rank, ranks_n, device=dev.type,
                  args=(mparams, mcfg, x, tokens, TP_FORWARD_LAYERS, order_shapes))
    ranks_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    require(_checksum(mparams) == before, "a TP rank wrote to the shared weights")
    orders, held_out = {}, {}
    for shape, outputs in ranks[0]["orders"].items():
        orders[shape], held_out[shape] = read_order(outputs, n_model, dev)
    ranks[0]["orders"] = None
    order_rec = {str(list(shape)): {"runs": len(o.runs), "first_runs": o.runs[:4],
                                    "settled_share": o.unique_share,
                                    "held_out_call_bits_equal": held_out[shape]}
                 for shape, o in orders.items()}
    print(f"moe_tp: gloo's order {order_rec}", flush=True)
    require(all(held_out.values()), f"TP: the order read off {ORDER_CALLS} all-reduces does not "
                                    f"give a held-out call's bits: {order_rec}")

    def bits_equal(a, b):
        def raw(t):
            return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
                if t.is_floating_point() else t
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(raw(a), raw(b))

    def dev_err(a, b):
        a, b = a.float(), b.float()
        return {"max_abs_err": float((a - b).abs().max()),
                "rel_rms": float((a - b).norm() / b.norm()), "bits_equal": bits_equal(a, b)}

    # a) the layer, against the one-process oracles
    lay = [r["layer"] for r in ranks]
    y = lay[0]["y"].to(dev)
    with MOE.recording_routes() as plain_routes:
        want_y, want_aux = MOE.moe_apply_tp_plain(ffn0, x, mcfg, n_data, n_model,
                                                  reduce=orders[(E, C, d)])
    rank_order_y, _ = MOE.moe_apply_tp_plain(ffn0, x, mcfg, n_data, n_model)
    # a planted fault: the psum in float32, rounded once, in place of gloo's bf16 sum
    f32_y, _ = MOE.moe_apply_tp_plain(
        ffn0, x, mcfg, n_data, n_model,
        reduce=lambda ps: torch.stack(ps).float().sum(0).to(ps[0].dtype))
    with MOE.recording_routes() as sparse_routes:
        sparse_y, _ = MOE.moe_apply_sparse(ffn0, x, mcfg)
    C_sparse = MOE.capacity(mcfg, B * S)
    (p_idx, p_keep, _), = plain_routes
    (s_idx, s_keep, _), = sparse_routes
    vs_sparse = dev_err(want_y, sparse_y)
    per_call = [max(rec["call_ms"][i] for rec in lay) for i in range(TP_CALLS)]
    layer_rec = {
        "x": list(x.shape), "dtype": str(x.dtype), "T_loc": B * S, "C_loc": C,
        "C_sparse": C_sparse, "dispatch_buffer": [E, C, d], "ff_slice": f_loc,
        "buffer_mb": buf_bytes / 1e6, "call_ms": statistics.median(per_call),
        "call_ms_each": per_call, "first_call_ms": max(rec["first_ms"] for rec in lay),
        "median_rank_parts_ms": {key: statistics.median(rec["parts"][key] for rec in lay)
                                 for key in ("allreduce_ms", "experts_ms")},
        "carrier_per_call": lay[0]["carrier_per_call"],
        "peak_gib_per_rank_max": max(rec["peak_gib"] for rec in lay),
        "transport": lay[0]["transport"], "carrier": lay[0]["carrier"],
        "gloo_bf16_all_reduce": True, "order_calls_s": max(r["order_s"] for r in ranks),
        "vs_plain_gloo_order": dev_err(y, want_y),
        "vs_plain_rank_order": dev_err(y, rank_order_y),
        "planted_f32_psum_vs_ranks": dev_err(f32_y, y),
        "plain_vs_sparse": vs_sparse, "tol_vs_sparse_rel_rms": tol,
        "drops": int((~p_keep).sum()), "drops_sparse": int((~s_keep).sum()),
        "entries": p_keep.numel(), "aux": lay[0]["aux"], "plain_aux": float(want_aux),
        "bmm_view_extra_bytes": int(bmm_extra)}
    emit({"run": "moe_tp layer", **layer_rec})
    for r, rec in enumerate(lay):
        require(rec["finite"] and rec["shape_ok"], f"TP layer, rank {r}: shape or non-finite")
        require(rec["held"] == [E, d, f_loc] and rec["views"],
                f"TP layer, rank {r}: holds {rec['held']} (views: {rec['views']})")
    require(len({rec["bits"] for rec in lay}) == 1, "TP layer: the ranks' outputs differ")
    require(len({rec["aux"] for rec in lay}) == 1, "TP layer: the ranks' aux differ")
    require(bits_equal(y, want_y), "TP layer: not the bits of moe_apply_tp_plain summing in "
                                   f"gloo's order: {layer_rec['vs_plain_gloo_order']}")
    require(not bits_equal(f32_y, y), "TP layer: the check does not tell a float32 psum apart")
    require(lay[0]["aux"] == float(want_aux),
            f"TP layer aux {lay[0]['aux']} vs plain {float(want_aux)}")
    require(torch.equal(lay[0]["route_idx"], p_idx.cpu()) and
            torch.equal(lay[0]["route_keep"], p_keep.cpu()),
            "TP layer: routes or drops differ from moe_apply_tp_plain's")
    require(torch.equal(p_idx, s_idx), "TP layer: routes differ from moe_apply_sparse's")
    if C == C_sparse:
        require(torch.equal(p_keep, s_keep), "TP layer: drops differ from moe_apply_sparse's "
                                             f"under the same capacity {C}")
    require(vs_sparse["rel_rms"] <= tol,
            f"TP layer: moe_apply_tp_plain off the unsplit moe_apply_sparse: {vs_sparse}")
    del y, want_y, rank_order_y, f32_y, sparse_y

    # b) the model forward, against the one-process forward whose MoE layers
    # sum in gloo's order (the ranks' dense layers are tensor-parallel: their
    # partial sums add in another order, so the bf16 criteria of step 8)
    mod = [r["model"] for r in ranks]
    cfg_b = dataclasses.replace(mcfg, n_layers=TP_FORWARD_LAYERS)
    params_b = {**mparams, "stack": mparams["stack"][:TP_FORWARD_LAYERS]}
    batch = {"tokens": tokens, "labels": tokens}
    auto = MOE.moe_apply_auto
    MOE.moe_apply_auto = lambda p, hh, c: MOE.moe_apply_tp_plain(
        p, hh, c, n_data, n_model, reduce=orders[(E, C_b, d)])
    try:
        with MOE.recording_routes() as fwd_routes:
            plain_logits = M.forward_train(params_b, batch, cfg_b, True)[0]
        plain_last = plain_logits[:, -1]
        del plain_logits
        plain_loss = float(M.loss_fn(params_b, batch, cfg_b, True)[0])
    finally:
        MOE.moe_apply_auto = auto
    last = mod[0]["last_logits"].to(dev)

    def routes_equal_by_layer(want):
        return [all(bits_equal(a.to(dev), b) for a, b in zip(got, w))
                for got, w in zip(mod[0]["routes"], want)]

    routes_equal = routes_equal_by_layer(fwd_routes)
    flips = route_flips(mod[0]["routes"], [tuple(t.cpu() for t in r) for r in fwd_routes],
                        mcfg.moe.top_k)
    fwd_ms = max(rec["ms"] for rec in mod)
    parts_wall = max(rec["parts_wall_ms"] for rec in mod)
    ar = statistics.median(rec["parts"]["allreduce_ms"] for rec in mod)
    Tb = TP_FORWARD_TOKENS[0] * TP_FORWARD_TOKENS[1]
    k4 = {"launches": TP_FORWARD_LAYERS, "bodies": {"mma_sync": 0, "wgmma": TP_FORWARD_LAYERS}}
    vs_plain = dev_err(last, plain_last)
    loss_rel = abs(mod[0]["loss"] - plain_loss) / abs(plain_loss)
    model_rec = {"layers": f"{TP_FORWARD_LAYERS} of {mcfg.n_layers} held on the card",
                 "tokens": list(TP_FORWARD_TOKENS), "ms": fwd_ms,
                 "first_ms": max(rec["first_ms"] for rec in mod), "tokens_per_s": Tb / fwd_ms * 1e3,
                 "allreduce_share": ar / parts_wall, "timed_with_parts_ms": parts_wall,
                 "median_rank_parts_ms": {key: statistics.median(rec["parts"][key] for rec in mod)
                                          for key in ("allreduce_ms", "experts_ms")},
                 "k4_per_rank": k4, "k4_shape": [1, Tb, mcfg.n_heads // n_model, 1, mcfg.head_dim],
                 "peak_gib_per_rank_max": max(rec["peak_gib"] for rec in mod),
                 "loss": mod[0]["loss"], "plain_loss": plain_loss, "loss_rel": loss_rel,
                 "aux": mod[0]["aux"], "last_logits_vs_plain": vs_plain,
                 "routes_and_router_logits_equal_by_layer": routes_equal, "route_flips": flips}
    emit({"run": "moe_tp forward", **model_rec})
    for r, rec in enumerate(mod):
        require(rec["k4"] == k4, f"TP forward, rank {r}: K4 launched {rec['k4']}, expected {k4}")
        require(rec["finite"], f"TP forward, rank {r}: non-finite logits")
    require(len({rec["logits_bits"] for rec in mod}) == 1, "TP forward: the ranks' logits differ")
    require(len({rec["loss"] for rec in mod}) == 1, "TP forward: the ranks' losses differ")
    require(flips["share"] < ROUTE_FLIP_MAX and (flips["first_gap_max"] or 0) < FIRST_FLIP_GAP_MAX,
            f"TP forward: routes differ from the one-process forward's: {flips}")
    require(vs_plain["max_abs_err"] <= LOGIT_MAX_ABS and vs_plain["rel_rms"] <= LOGIT_REL_RMS,
            f"TP forward: last-token logits off the one-process forward: {vs_plain}")
    require(loss_rel <= LOSS_REL, f"TP forward loss {mod[0]['loss']} vs one-process {plain_loss}")
    del plain_last, last, x, tokens
    return {"run": "moe_tp", "model": mcfg.name, "mesh": {"data": n_data, "model": n_model},
            "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase,
            "free_gib_before_ranks": free_gib, "weights_unchanged": True,
            "gloo_order": order_rec, "layer": layer_rec, "forward": model_rec}, \
        ranks_n * TP_FORWARD_LAYERS


def _release_shared(*trees) -> None:
    """Empty the dicts and lists of parameter trees a rank got from the
    parent by CUDA IPC, and collect the rank's reference cycles (a fleet's
    hooks refer back to it), so that the rank's last references to the
    parent's tensors go when its function returns. Otherwise they live
    until the process exits without dropping them, and the parent's blocks
    stay in torch's IPC limbo (``ipc_collect`` cannot free them): Mixtral's
    weights and the fleet's tenants held 34.28 GiB of the card to the end
    of the script (``experiments/ipc_limbo.py`` shows the limbo and the
    cure)."""
    def empty(tree):
        if isinstance(tree, (dict, list)):
            for sub in (tree.values() if isinstance(tree, dict) else tree):
                empty(sub)
            tree.clear()

    for tree in trees:
        empty(tree)
    gc.collect()


def _bits_sum(t) -> int:
    """A 2-byte tensor's bits summed as int16, in chunks of CHECKSUM_CHUNK
    values: the int64 sum of a whole tensor takes an int64 copy of it (30
    GB for a 7.5 GB expert stack)."""
    import torch

    flat = t.reshape(-1).view(torch.int16)
    return sum(int(flat[i:i + CHECKSUM_CHUNK].sum(dtype=torch.int64))
               for i in range(0, flat.numel(), CHECKSUM_CHUNK))


def _checksum(tree) -> int:
    """Every weight's bits summed as int16: shared weights, unchanged."""
    if isinstance(tree, dict):
        return sum(_checksum(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_checksum(v) for v in tree)
    return _bits_sum(tree)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _cast(tree, dtype):
    """A copy of a parameter tree (dicts and lists of tensors) in ``dtype``."""
    if isinstance(tree, dict):
        return {key: _cast(val, dtype) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_cast(val, dtype) for val in tree]
    return tree.to(dtype)


def _to(tree, device):
    """A copy of a parameter tree on ``device`` (``None`` leaves stay)."""
    if isinstance(tree, dict):
        return {key: _to(val, device) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_to(val, device) for val in tree]
    return None if tree is None else tree.to(device)


def _tensors(tree):
    """Every tensor of a parameter tree of dicts and lists."""
    if isinstance(tree, (dict, list, tuple)):
        for sub in tree.values() if isinstance(tree, dict) else tree:
            yield from _tensors(sub)
    else:
        yield tree


def fleet_rank(rank, group, layout, tenants, cfg, prompts, device, tune_dir):
    """One rank of the fleet phase: 8 ranks share the card as the D3(2,2)
    host, every rank driving the same ``TenantFleet`` over ``torch_dist``.
    ``tenants`` are the parent's weights, shared through CUDA IPC. Runs
    the combined arm, each tenant alone, the time-multiplexed arm and the
    churn drill (evict tenant 1 mid-traffic, then re-admit it), each from
    a barrier, after an untimed warm-up of both tenants; after the combined
    arm, ``collective_report()`` on a measuring tuner of the rank's own
    cache file in ``tune_dir`` (timed); rank 0 also holds
    the first combined boundary's replay output against
    ``guest_expert_ffn`` run per destination in this one process. Returns
    host data."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import rank_device
    from repro_torch.runtime import autotune as AT
    from repro_torch.serve.fleet import TenantFleet

    dev = rank_device(rank, device)
    captured = {}
    AT.set_autotuner(AT.Autotuner(cache_path=pathlib.Path(tune_dir) / f"fleet-{rank}.json",
                                  device=dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def make(combined=True):
        fleet = TenantFleet(FLEET_HOST, backend="torch_dist", max_seq=FLEET_MAX_SEQ,
                            combined=combined, device=device, group=group)
        fleet.boundary_ms = []
        dispatch, replay = fleet._dispatch, fleet._replay_dist

        def timed_dispatch(items):
            t0 = time.perf_counter()
            out = dispatch(items)
            sync()
            fleet.boundary_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def kept_replay(prog, items, Xh, owner):
            out = replay(prog, items, Xh, owner)
            if combined and "first" not in captured and len(items) == len(fleet.tenants) > 1:
                captured["first"] = (Xh, out, {tid: fleet.tenants[tid].n_guest for tid in items},
                                     dict(owner), {tid: items[tid][0] for tid in items})
            return out

        fleet._dispatch, fleet._replay_dist = timed_dispatch, kept_replay
        return fleet

    def serve(fleet, tids, plan=None):
        dist.barrier()
        t0 = time.perf_counter()
        reqs = {tid: [fleet.submit(tid, p, FLEET_NEW) for p in prompts] for tid in tids}
        if plan is not None:
            plan(fleet, reqs)
        fleet.run_to_completion()
        sync()
        wall = time.perf_counter() - t0
        return {"tokens": {tid: [list(map(int, r.out)) for r in rs] for tid, rs in reqs.items()},
                "done": {tid: [r.done for r in rs] for tid, rs in reqs.items()},
                "wall_s": wall, "tokens_out": fleet.tokens_out, "steps": fleet.steps_run,
                "replays": fleet.replays, "rounds": fleet.rounds_replayed,
                "boundaries": len(fleet.boundary_ms),
                "boundary_ms": statistics.median(fleet.boundary_ms) if fleet.boundary_ms else None}

    # warm-up, untimed: each rank's first replays and expert casts on the card
    fleet = make()
    for p in tenants:
        fleet.submit(fleet.admit_model(cfg, p, guest=FLEET_GUEST, slots=FLEET_SLOTS),
                     prompts[0][:3], 2)
    fleet.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    for arm, combined in (("combined", True), ("time_mux", False)):
        fleet = make(combined)
        tids = [fleet.admit_model(cfg, p, guest=FLEET_GUEST, slots=FLEET_SLOTS) for p in tenants]
        out[arm] = serve(fleet, tids)
        out[arm]["rounds_a_boundary"] = fleet.program().num_rounds if combined else sum(
            fleet._solo_program(t.embedding).num_rounds for t in fleet.tenants.values())
        if combined:
            t0 = time.perf_counter()
            out["report"] = fleet.collective_report()
            out["report_s"] = time.perf_counter() - t0
    for i, p in enumerate(tenants):
        fleet = make()
        out[f"solo{i}"] = serve(fleet, [fleet.admit_model(cfg, p, guest=FLEET_GUEST,
                                                          slots=FLEET_SLOTS)])

    def churn(fleet, reqs):
        for _ in range(3):
            fleet.step()
        out["churn_mid"] = [len(r.out) for rs in reqs.values() for r in rs]
        plan = fleet.evict(1)
        out["churn_plan"] = (plan.surviving, plan.evicted)
        tid = fleet.admit_model(cfg, tenants[1], guest=FLEET_GUEST, slots=FLEET_SLOTS)
        reqs[tid] = [fleet.submit(tid, p, FLEET_NEW) for p in prompts]

    fleet = make()
    tids = [fleet.admit_model(cfg, p, guest=FLEET_GUEST, slots=FLEET_SLOTS) for p in tenants]
    out["churn"] = serve(fleet, tids, churn)
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                       else float("nan"))
    out["transport"] = str(dist.get_backend(group))
    if rank == 0:  # the replay against the expert FFN per destination, in one process
        out["replay_vs_ffn"] = replay_vs_ffn(*captured["first"])
    fleet = None
    captured.clear()
    _release_shared(tenants)
    return out


def replay_vs_ffn(Xh, got, n_guest, owner, ffns):
    """A boundary replay's output ``got`` of the host array ``Xh`` against
    ``guest_expert_ffn`` run per destination device in one process, with
    the owning tenant's experts there."""
    import numpy as np
    import torch

    from repro_torch.models import moe as MOE

    want = np.zeros_like(got)
    for j in range(Xh.shape[1]):
        tid, g = owner[j]
        if tid in ffns:
            w = MOE.guest_experts(ffns[tid], n_guest[tid], g)
            want[:, j] = MOE.guest_expert_ffn(torch.from_numpy(Xh[:, j]), *w).numpy()
    diff = np.abs(got - want)
    return {"max_abs_err": float(diff.max()), "max_abs_want": float(np.abs(want).max()),
            "rel_rms": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            "shape": list(Xh.shape)}


def fleet_phase(dev, mcfg, seed):
    """Two Mixtral-8x7B tenants at full width, depth cut to FLEET_LAYERS
    layers each, made on the card from seeds 0 and 1, served as D3(1,2)
    guests on the D3(2,2) host by 8 ranks sharing the card (gloo, the host
    as the replay's carrier). Returns its record."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import spawn
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve.fleet import TenantFleet

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(mcfg, n_layers=FLEET_LAYERS)
    tenants = [M.init_params(torch.Generator(device=dev).manual_seed(seed + i), cfg, device=dev)
               for i in range(2)]
    torch.cuda.synchronize()
    weight_gb = sum(_nbytes(p) for p in tenants) / 1e9
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).astype(np.int32)
               for _ in range(FLEET_REQUESTS)]
    before = [_checksum(p) for p in tenants]
    n_guest = FLEET_GUEST[0] * FLEET_GUEST[1] ** 2
    C = MOE.guest_capacity(cfg.moe, FLEET_SLOTS)
    ranks_n = FLEET_HOST[0] * FLEET_HOST[1] ** 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="autotune-fleet-") as tune_dir:
        ranks = spawn(fleet_rank, ranks_n, device=dev.type,
                      args=(tenants, cfg, prompts, dev.type, tune_dir))
    ranks_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    require([_checksum(p) for p in tenants] == before, "a fleet rank wrote to a tenant's weights")

    arms = ("combined", "time_mux", "solo0", "solo1", "churn")
    for r, rec in enumerate(ranks):
        for arm in arms:
            require(rec[arm]["tokens"] == ranks[0][arm]["tokens"],
                    f"fleet, rank {r}: the {arm} arm's tokens differ from rank 0's")
        require(rec["transport"] == "gloo", f"fleet, rank {r}: transport {rec['transport']}")
    r0 = ranks[0]
    for arm in arms:
        require(all(all(d) for d in r0[arm]["done"].values()) or arm == "churn",
                f"fleet {arm}: requests not answered")
    for tid in (0, 1):
        solo = r0[f"solo{tid}"]["tokens"][0]
        require(all(len(t) == FLEET_NEW for t in solo), f"fleet solo{tid}: {solo}")
        require(r0["combined"]["tokens"][tid] == solo,
                f"fleet: tenant {tid}'s combined tokens differ from its solo fleet's")
        require(r0["time_mux"]["tokens"][tid] == solo,
                f"fleet: tenant {tid}'s time-mux tokens differ from its solo fleet's")
    require(r0["churn_plan"] == ((0,), (1,)), f"fleet churn plan {r0['churn_plan']}")
    require(r0["churn"]["tokens"][0] == r0["solo0"]["tokens"][0],
            "fleet churn: the survivor's tokens changed across the evict")
    require(r0["churn"]["tokens"][2] == r0["solo1"]["tokens"][0],
            "fleet churn: the re-admitted tenant's tokens differ from its solo fleet's")
    require(not all(r0["churn"]["done"][1]), "fleet churn: the evicted requests finished")
    require(r0["combined"]["replays"] < r0["time_mux"]["replays"] and
            r0["combined"]["rounds"] < r0["time_mux"]["rounds"],
            "fleet: the combined arm replayed no fewer rounds than time-mux")
    report = r0["report"]
    for r, rec in enumerate(ranks):
        require((rec["report"]["key"], rec["report"]["strategy"], rec["report"]["measured_us"]) ==
                (report["key"], report["strategy"], report["measured_us"]),
                f"fleet, rank {r}: collective_report {rec['report']} differs from rank 0's")
    require(report["source"] == "measured" and
            report["combined_rounds"] < report["time_mux_rounds"],
            f"fleet: collective_report {report}")
    print(f"fleet: collective_report on every rank: {json.dumps(report)}", flush=True)
    cmp = r0["replay_vs_ffn"]
    require(cmp["max_abs_err"] <= FLEET_FFN_TOL * (1 + cmp["max_abs_want"]) and
            cmp["rel_rms"] <= FLEET_FFN_TOL,
            f"fleet: the replay's expert outputs off guest_expert_ffn per destination: {cmp}")
    # the launcher's path: the reference fleet in this one process, its
    # expert FFN on the card's views (no host copy of the experts)
    shards = MOE.guest_expert_shards
    host_copies, captured = [], {}
    MOE.guest_expert_shards = lambda *a: host_copies.append(1) or shards(*a)

    def reference_arm(tenant_params):
        fleet = TenantFleet(FLEET_HOST, backend="reference", max_seq=FLEET_MAX_SEQ, device=dev)
        replay = fleet._replay

        def kept_replay(prog, items, Xh):
            out = replay(prog, items, Xh)
            if "first" not in captured and len(items) == 2:
                captured["first"] = (Xh, out, {tid: fleet.tenants[tid].n_guest for tid in items},
                                     dict(fleet._host_owner()),
                                     {tid: items[tid][0] for tid in items})
            return out

        fleet._replay = kept_replay
        tids = [fleet.admit_model(cfg, p, guest=FLEET_GUEST, slots=FLEET_SLOTS)
                for p in tenant_params]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = {tid: [fleet.submit(tid, p, FLEET_NEW) for p in prompts] for tid in tids}
        fleet.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return ({tid: [list(map(int, r.out)) for r in rs] for tid, rs in reqs.items()},
                {"wall_s": wall, "tokens_out": fleet.tokens_out,
                 "tokens_per_s": fleet.tokens_out / wall, "replays": fleet.replays,
                 "rounds": fleet.rounds_replayed})

    try:
        ref_tokens, reference_rec = reference_arm(tenants)
        ref_solo = [reference_arm([p])[0][0] for p in tenants]
    finally:
        MOE.guest_expert_shards = shards
    reference_rec["host_expert_copies"] = len(host_copies)
    reference_rec["replay_vs_ffn"] = replay_vs_ffn(*captured["first"])
    reference_rec["tokens_equal_torch_dist_combined"] = {
        tid: [a == b for a, b in zip(ref_tokens[tid], r0["combined"]["tokens"][tid])]
        for tid in (0, 1)}
    print(f"fleet: the reference backend on the card (cold): {reference_rec}", flush=True)
    require(not host_copies, "fleet: the reference backend copied a tenant's experts to the host")
    for tid in (0, 1):
        require(ref_tokens[tid] == ref_solo[tid], f"fleet reference: tenant {tid}'s combined "
                                                  "tokens differ from its solo fleet's")
    cmp_ref = reference_rec["replay_vs_ffn"]
    require(cmp_ref["max_abs_err"] <= FLEET_FFN_TOL * (1 + cmp_ref["max_abs_want"]) and
            cmp_ref["rel_rms"] <= FLEET_FFN_TOL,
            f"fleet reference: the replay's expert outputs off guest_expert_ffn: {cmp_ref}")
    arm_rec = {"reference_combined": reference_rec}
    for arm in arms:
        recs = [rec[arm] for rec in ranks]
        wall = max(rec["wall_s"] for rec in recs)
        arm_rec[arm] = {"wall_s": wall, "tokens_out": recs[0]["tokens_out"],
                        "tokens_per_s": recs[0]["tokens_out"] / wall, "steps": recs[0]["steps"],
                        "replays": recs[0]["replays"], "rounds": recs[0]["rounds"],
                        "boundaries": recs[0]["boundaries"],
                        "boundary_ms_median_rank_max": max(rec["boundary_ms"] for rec in recs)}
    for arm in ("combined", "time_mux"):
        arm_rec[arm]["rounds_a_boundary"] = r0[arm]["rounds_a_boundary"]
    tenants.clear()
    return {"run": "fleet", "model": mcfg.name, "tenants": 2, "seeds": [seed, seed + 1],
            "layers": f"{FLEET_LAYERS} of {mcfg.n_layers} each", "weights_gb": weight_gb,
            "host": f"D3{FLEET_HOST}", "guest": f"D3{FLEET_GUEST}", "n_guest": n_guest,
            "E_loc": cfg.moe.num_experts // n_guest, "slots": FLEET_SLOTS, "C": C,
            "requests_per_tenant": FLEET_REQUESTS, "prompt_lens": [len(p) for p in prompts],
            "new_tokens": FLEET_NEW,
            "ranks": ranks_n, "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase,
            "peak_gib_per_rank_max": max(rec["peak_gib"] for rec in ranks),
            "replay_vs_ffn": cmp, "tol": FLEET_FFN_TOL, "arms": arm_rec,
            "collective_report": {**report, "ranks_agree": ranks_n,
                                  "report_s_max_rank": max(rec["report_s"] for rec in ranks)},
            "checks": ["tokens equal on all 8 ranks", "combined == solo", "time_mux == solo",
                       "reference backend on the card: combined == solo, its replay within "
                       "tol of guest_expert_ffn, no host copy of an expert",
                       "survivor bit for bit across the evict", "re-admitted == solo",
                       "combined replays fewer rounds than time_mux", "weights unchanged",
                       "collective_report measured and the same on all 8 ranks"]}


def wave_replay_check(dev, time_ms):
    """The whole-array wave replay on the card: the all-to-all phase's input
    on the pipelined dragonfly_layout(64) program, torch_alltoall_overlapped
    against torch_alltoall bit for bit, both timed."""
    import torch

    from repro_torch.dist import collectives as dc
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.runtime import optimize as opt

    layout = dragonfly_layout(64)
    prog = dc.alltoall_program(layout, optimized=True, pipelined=1)
    n = layout.n
    x = torch.randn((n, n, CHUNK), generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    waves = opt.exchange_waves(prog)
    got = opt.torch_alltoall_overlapped(prog, dev)(x)
    want = opt.torch_alltoall(prog, dev)(x)
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            "torch_alltoall_overlapped differs from torch_alltoall")
    del got, want
    rec = {"run": "alltoall_overlapped", "shape": list(x.shape), "waves": len(waves),
           "pairs_per_wave": sorted({len(s) for _, s, _ in waves}), "bit_exact": True,
           "ms": time_ms(lambda: opt.torch_alltoall_overlapped(prog, dev)(x), reps=3, warmup=1),
           "torch_alltoall_ms": time_ms(lambda: opt.torch_alltoall(prog, dev)(x), reps=3,
                                        warmup=1)}
    del x
    return rec


def per_shard_phase(dev, seed):
    """The per-shard §4 all-reduce: RANKS processes share the card in one
    gloo group (D3(2,2)), each with a 25 MiB bucket, CALLS calls of
    allreduce_shard (K5) back to back. Holds every call against the plain
    exchange (in the ranks) and the first against the port's NumPy
    np_allreduce and K1 run_allreduce on the stacked (RANKS, BUCKET) array
    (the data holds no -0.0, checked, so the per-shard x + x_partner and
    the whole-array fold from +0.0 agree bit for bit). Returns K5's record for
    the kernels line."""
    import numpy as np
    import torch

    from repro_torch.dist import collectives as dc
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import optimize as opt
    from repro_torch.runtime.backends import get_backend

    layout = dragonfly_layout(RANKS)
    require((layout.topo.K, layout.topo.M) == (2, 2), f"dragonfly_layout({RANKS}) is {layout.topo}")
    build.build_all()  # the ranks only load the libraries
    t0 = time.perf_counter()
    ranks = spawn(per_shard_rank, RANKS, device="cuda", args=(seed,))
    phase_s = time.perf_counter() - t0
    rounds = ranks[0]["rounds"]
    per_call = {"ring_put": rounds, "ring_signal": rounds, "ring_wait_add": rounds}
    for r, res in enumerate(ranks):
        require(res["counts"] == {k: CALLS * v for k, v in per_call.items()},
                f"rank {r} launched {res['counts']} in {CALLS} calls of {rounds} rounds")

    gens = [torch.Generator(device=dev).manual_seed(seed + r) for r in range(RANKS)]
    x = torch.stack([torch.randn(BUCKET, generator=g, device=dev) for g in gens])
    require(not bool(((x == 0) & torch.signbit(x)).any()), "the per-shard input holds -0.0")
    prog = dc.allreduce_program(layout, optimized=True)
    k1 = get_backend("cuda_fused").run_allreduce(x, prog).cpu().numpy()
    ref = opt.np_allreduce(x.cpu().numpy(), prog)
    for r, res in enumerate(ranks):
        for what, want in (("np_allreduce", ref[r]), ("K1 run_allreduce", k1[r])):
            require(np.array_equal(res["out0"].view(np.int32), want.view(np.int32)),
                    f"rank {r}: allreduce_shard differs from {what}")
    del x, k1, ref

    # A round of a rank reads x and the partner's x and writes the sum, once
    # each; the put's write into the window and the wait's read of it are
    # the design's staging copy, not the function's work. All ranks share
    # the card. A put alone moves its buffer twice.
    nbytes = RANKS * rounds * 3 * BUCKET * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, RANKS * rounds * BUCKET / FP32_FLOP_PER_S
    put_bound_ms = 2 * BUCKET * 4 / HBM_BYTES_PER_S * 1e3
    keys = ("call_ms", "put_ms", "wait_ms", "plain_ms", "copy_ms")
    med = {key: statistics.median(res[key] for res in ranks) for key in keys}
    emit({"run": "allreduce_shard", "ranks": RANKS, "layout": "D3(2,2)", "bucket_floats": BUCKET,
          "calls": CALLS, "skew": {"call": SKEW[0], "rank": SKEW[1], "s": SKEW[2]},
          "rounds": rounds, "launches_per_rank": ranks[0]["counts"], "phase_s": phase_s,
          "orchestration": ranks[0]["orchestration"],
          "bit_exact": ["plain exchange", "np_allreduce", "K1 run_allreduce"],
          "per_rank_ms": {key: [res[key] for res in ranks] for key in keys},
          "median_ms": med, "bound_ms": max(t_bytes, t_ops) * 1e3, "put_bound_ms": put_bound_ms})
    return dict(
        name="ring_exchange", route="cuda", source="src/repro_torch/csrc/ring_exchange.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:111",
        launches=sum(ranks[0]["counts"].values()),
        max_abs_err=max(res["max_abs_err"] for res in ranks), ms=med["call_ms"],
        plain_ms=med["plain_ms"], bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=med["copy_ms"])


def deepseek_phase(dev, kit):
    """Step 11: DeepSeek-V3 at its published widths, the depth cut to its 3
    dense-prefix layers and 1 MoE layer plus the MTP block. ``kit`` holds
    main's helpers (``time_ms``, ``bound``, ``model_run``, ``logits_close``,
    ``device_profile``, ``release``, ``Recording``) and the launch counts'
    names (``names``). Returns (K4's record at MLA's shape, the runs'
    records, K4's launches in one forward)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain, smem_bytes)
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve.engine import Request

    gib = lambda n: n / 2**30
    print(f"deepseek: {gib(torch.cuda.memory_allocated()):.2f} GiB allocated before the phase",
          flush=True)
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_LAYERS)
    m, H = cfg.mla, cfg.n_heads
    D, Dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    B, S = DEEPSEEK_TOKENS
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def mla_operands(b, sq, sk, h, dtype):
        """q, k (·, ·, h, 192) and v the strided second half of a
        (b, sk, h, 256) tensor, as ``mla_train`` hands them to K4."""
        q = torch.randn(b, sq, h, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, sk, h, D, generator=gen, device=dev).to(dtype)
        kv = torch.randn(b, sk, h, m.qk_nope_head_dim + Dv, generator=gen, device=dev).to(dtype)
        return q, k, kv[..., m.qk_nope_head_dim:]

    # a) K4 at MLA's head dims, each body against its plain version
    checks = []
    for b_, sq, sk, h, causal, dtype in [
            (B, S, S, H, True, torch.bfloat16),        # the prefill's shape: wgmma
            (1, 256, 256, 4, True, torch.float32),     # mma_sync
            (2, 200, 333, 8, False, torch.float32),    # Sq != Sk, ragged
            (1, 333, 333, 4, True, torch.bfloat16)]:   # ragged: wgmma
        q, k, v = mla_operands(b_, sq, sk, h, dtype)
        zero_counts((flash_attention,))
        got = flash_attention(q, k, v, causal=causal)
        bodies = dict(flash_attention.body_launches)
        want = flash_attention_plain(q, k, v, causal=causal)
        tol = FLASH_TOL[str(dtype)]
        ok, err, rel = attention_close(got, want, tol)
        require(ok and got.shape == (b_, sq, h, Dv),
                f"flash_attention at (192, 128) off by max {err}, relative rms {rel} at "
                f"{(b_, sq, sk, h, causal, dtype)}")
        require(bodies == {"mma_sync": int(dtype == torch.float32),
                           "wgmma": int(dtype == torch.bfloat16)}, f"bodies {bodies}")
        checks.append({"q": [b_, sq, h, D], "k": [b_, sk, h, D], "v": [b_, sk, h, Dv],
                       "causal": causal, "dtype": str(dtype), "tol": tol, "max_abs_err": err,
                       "rel_rms": rel, "bodies": bodies})
        if len(checks) == 1:
            k4_err, qkv = err, (q, k, v)
        del got, want
    emit({"check": "flash_attention at MLA's head dims", "cases": checks})
    q, k, v = qkv
    pairs = S * (S + 1) // 2 * B
    b_ms, b_by = kit.bound(2 * (q.numel() + k.numel() + 2 * v.numel()),
                           pairs * H * (2 * D + 2 * Dv), BF16_FLOP_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    backends = {}
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                backends[name] = kit.time_ms(sdpa, reps=5)
        except (RuntimeError, AttributeError) as e:
            backends[name] = f"refused: {str(e).splitlines()[0][:120]}"
    k4 = {"q": list(q.shape), "k": list(k.shape), "v": list(v.shape), "v_strides": list(v.stride()),
          "causal": True, "max_abs_err": k4_err, "key_pairs": pairs,
          "ms": kit.time_ms(lambda: flash_attention(q, k, v, causal=True), reps=10),
          "plain_ms": kit.time_ms(lambda: flash_attention_plain(q, k, v, causal=True), reps=3,
                                  warmup=1),
          "library_ms": kit.time_ms(sdpa, reps=10), "bound_ms": b_ms, "bound_by": b_by,
          "library": "SDPA, is_causal, v at 128 (the dispatcher's choice)",
          "library_backends_ms": backends,
          "smem_bytes": {body: smem_bytes(D, Dv, body) for body in ("wgmma", "mma_sync")},
          "padded_v_bound_ms": kit.bound(0, pairs * H * 4 * D, BF16_FLOP_PER_S)[0]}
    emit({"check": "flash_attention timing, DeepSeek-V3 MLA shape", **k4})
    del q, k, v, qt, kt, vt, qkv
    kit.release()

    # b) the weights, made on the card from the seed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    weight_gb = _nbytes(params) / 1e9
    init_peak = gib(torch.cuda.max_memory_allocated())
    print(f"deepseek-v3-671b: depth cut from {full.n_layers} to {cfg.n_layers} layers "
          f"({cfg.first_dense_layers} dense-prefix, {cfg.n_layers - cfg.first_dense_layers} MoE) "
          f"and the MTP block: all {full.n_layers} take {full.param_count() * 2 / 1e12:.2f} TB "
          f"of bf16 weights; these {n_params / 1e9:.2f} B parameters {weight_gb:.1f} GB, made on "
          f"the card in {init_s:.1f} s, init peak {init_peak:.2f} GiB; every width is the "
          "published one", flush=True)

    # c) forward_train and loss_fn with K4, against the naive passes
    tokens = torch.randint(1, cfg.vocab, DEEPSEEK_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
    batch = {"tokens": tokens, "labels": tokens}
    n_attn = cfg.n_layers
    only_k4 = {name: 0 for name in kit.names} | {"flash_attention": n_attn}
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as k_routes:
        (logits, aux, _), counts = kit.model_run(M.forward_train, params, batch, cfg, True)
    peaks = {"forward": gib(torch.cuda.max_memory_allocated())}
    bodies = dict(flash_attention.body_launches)
    require(counts == only_k4, f"deepseek forward_train launched {counts}, expected {only_k4}")
    require(bodies == {"mma_sync": 0, "wgmma": n_attn}, f"deepseek forward bodies {bodies}")
    require(len(k_routes) == cfg.n_layers - cfg.first_dense_layers and bool(torch.isfinite(aux)),
            f"{len(k_routes)} MoE layers routed, aux {float(aux)}")
    last = logits[:, -1].float()
    del logits
    kit.release()
    torch.cuda.reset_peak_memory_stats()
    (loss, metrics), counts = kit.model_run(M.loss_fn, params, batch, cfg, True)
    peaks["loss_fn"] = gib(torch.cuda.max_memory_allocated())
    loss_k4 = {name: 0 for name in kit.names} | {"flash_attention": n_attn + cfg.mtp_depth}
    require(counts == loss_k4, f"deepseek loss_fn launched {counts}, expected {loss_k4}")
    require(dict(flash_attention.body_launches) == {"mma_sync": 0, "wgmma": n_attn + 1},
            f"deepseek loss_fn bodies {flash_attention.body_launches}")
    require(set(metrics) == {"ce", "moe_aux", "mtp", "loss"}
            and all(bool(torch.isfinite(x)) for x in metrics.values()), f"metrics {metrics}")
    kit.release()
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as n_routes:
        (naive, _, _), counts = kit.model_run(M.forward_train, params, batch, cfg, False)
    peaks["naive forward"] = gib(torch.cuda.max_memory_allocated())
    require(counts["flash_attention"] == 0, "the naive deepseek forward launched flash_attention")
    naive_last = naive[:, -1].float()
    del naive
    kit.release()
    naive_metrics = M.loss_fn(params, batch, cfg, False)[1]
    kit.release()
    err, rel = kit.logits_close(last, naive_last, "deepseek: kernel vs naive forward")
    metric_rel = {key: abs(float(metrics[key]) - float(naive_metrics[key]))
                  / abs(float(naive_metrics[key])) for key in ("ce", "mtp", "loss")}
    require(all(r <= LOSS_REL for r in metric_rel.values()),
            f"deepseek ce, mtp, loss against the naive pass: {metrics} vs {naive_metrics}")
    flips = route_flips(k_routes, n_routes, cfg.moe.top_k)
    # The routes' noise: the router logits of the two passes, held to step 8's
    # criteria, and how many tokens sit on an exact tie of bf16 router logits
    # within their top k + 1 (the stable sort then orders by expert id).
    k_lg, n_lg = (torch.cat([lg.float() for _, _, lg in routes]) for routes in (k_routes, n_routes))
    flips["router_logits_vs_naive"] = dict(zip(("max_abs_err", "rel_rms"), kit.logits_close(
        k_lg, n_lg, "deepseek: the MoE layers' router logits, kernel vs naive")))
    top = k_lg.sort(-1, descending=True)[0][:, :cfg.moe.top_k + 1]
    flips["exact_tie_share"] = {
        "at rank k, k + 1": float((top[:, -2] == top[:, -1]).float().mean()),
        "within the top k + 1": float((top.diff(dim=-1) == 0).any(-1).float().mean())}
    kept = [keep for _, keep, _ in k_routes]
    drop_share = sum(int((~keep).sum()) for keep in kept) / sum(keep.numel() for keep in kept)
    del k_routes, n_routes, kept, last, naive_last, k_lg, n_lg, top
    kit.release()
    fwd_ms = kit.time_ms(lambda: M.forward_train(params, batch, cfg, True), reps=3, warmup=1)
    prof = kit.device_profile(lambda: M.forward_train(params, batch, cfg, True), fwd_ms,
                              labels=MODEL_LABELS, top_ops=12)
    lab, k4_ms = prof["device_ms_by_label"], prof["device_ms_by_group"].get("flash_attention", 0.0)
    if lab["attn.mla"] and lab["moe.experts"]:  # kernels were traced back to their torch ops
        parts = {"flash_attention (K4)": k4_ms,
                 "MLA projections (attn.mla without K4)": lab["attn.mla"] - k4_ms,
                 "dense FFN (ffn.mlp)": lab["ffn.mlp"],
                 "expert products (moe.experts)": lab["moe.experts"],
                 "dispatch and combine (router included)": lab["moe.dispatch"]
                 + lab["moe.combine"]}
        parts["the rest (shared expert, unembedding, norms, MTP glue)"] = \
            prof["device_ms"] - sum(parts.values())
        prof["device_ms_by_part"] = parts
    else:
        prof["device_ms_by_part"] = "not measured: the profiler tied no kernel to a torch op"
    runs = [{"run": "prefill", "model": cfg.name,
             "layers": f"{cfg.n_layers} of {full.n_layers} ({cfg.first_dense_layers} dense "
                       f"prefix, {cfg.n_layers - cfg.first_dense_layers} MoE) + MTP",
             "tokens": list(DEEPSEEK_TOKENS), "params": n_params,
             "weight_gb": weight_gb, "init_s": init_s, "init_peak_gib": init_peak,
             "launches": {"forward_train": n_attn, "loss_fn": n_attn + cfg.mtp_depth},
             "ms": fwd_ms, "tokens_per_s": B * S / fwd_ms * 1e3, "peak_gib": peaks,
             "metrics": {key: float(val) for key, val in metrics.items()},
             "naive_metrics": {key: float(val) for key, val in naive_metrics.items()},
             "metric_rel_vs_naive": metric_rel,
             "last_logits_vs_naive": {"max_abs_err": err, "rel_rms": rel},
             "capacity": MOE.capacity(cfg, B * S), "dropped_share": drop_share,
             "route_flips": flips, "profile": prof}]
    emit(runs[-1])
    del loss, metrics, naive_metrics, aux, batch, tokens
    kit.release()

    # d) the engine: 4 slots, a 128-token cache, 6 requests of 12 new tokens
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=rng.integers(3, 9))
                    .astype(np.int32), max_new_tokens=12) for i in range(6)]
    torch.cuda.reset_peak_memory_stats()
    eng = kit.Recording(cfg, params, batch_slots=4, max_seq=128, device=dev)
    eng.trace = []
    pending = list(reqs)
    t0 = time.perf_counter()
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            eng.admit(pending.pop(0))
        eng.step()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    require(all(r.done and len(r.out) == 12 for r in reqs) and eng.tokens_out == 72,
            f"deepseek requests not answered: {[(r.rid, r.done, len(r.out)) for r in reqs]}")
    p0 = reqs[0].prompt
    step_logits = next(out[0] for pos, out in eng.trace if pos[0] == len(p0) - 1)
    prefill = M.forward_train(params, {"tokens": torch.from_numpy(p0).to(dev)[None]}, cfg, True)[0]
    serve_err, serve_rel = kit.logits_close(torch.from_numpy(step_logits).to(dev), prefill[0, -1],
                                            "deepseek decode vs prefill logits")
    runs.append({"run": "serve (smoke)", "model": cfg.name, "layers": cfg.n_layers, "slots": 4,
                 "max_seq": 128, "requests": len(reqs),
                 "prompt_lens": [len(r.prompt) for r in reqs], "steps": eng.steps_run,
                 "tokens": eng.tokens_out, "s": serve_s,
                 "smoke_tokens_per_s": eng.tokens_out / serve_s,
                 "peak_gib": gib(torch.cuda.max_memory_allocated()),
                 "decode_vs_prefill_logits": {"max_abs_err": serve_err, "rel_rms": serve_rel}})
    emit(runs[-1])
    del eng, params, prefill
    kit.release()
    print(f"deepseek: {gib(torch.cuda.memory_allocated()):.2f} GiB allocated after the phase",
          flush=True)
    # Step 12's near-tie criterion holds as it is; its 3 % cap on the share is
    # Mixtral's (top-2 of 8) and is printed here, not required: with 256
    # experts, top-8, bf16 router logits tie exactly at the top for a large
    # share of tokens, and any noise reorders those (PERF.md §6).
    require((flips["first_gap_max"] or 0) < FIRST_FLIP_GAP_MAX,
            f"deepseek: a token's route first differs between the kernel and naive passes "
            f"away from a near-tie: {flips}")
    print(f"deepseek: {flips['share']:.4%} of tokens' routes differ in order between the kernel "
          f"and naive passes, {flips['set_share']:.4%} as sets (step 12's cap for Mixtral: "
          f"{ROUTE_FLIP_MAX:.0%})", flush=True)
    return k4, runs, n_attn


def deepseek_ep_rank(rank, group, layout, params, cfg, x, tokens, want_y, tune_dir,
                     decode_in):
    """One rank of step 17, on a (1, 16) mesh of processes sharing the card.
    ``params`` are the parent's DeepSeek-V3 weights, shared through CUDA
    IPC: the rank cuts its 16 experts of the MoE layer as views, each
    expert stack by its ``param_specs`` entry through ``local_slices``,
    and writes to none.

    a) the MoE layer alone on ``x`` in every fixed mode through
       ``moe_apply_auto`` (EP: 256 experts split over 16): the first call's
       output held here against the one-process ``want_y`` bit for bit and
       its routes kept, then DS_EP_CALLS timed calls (from a barrier to the
       device's end), then one under ``moe.timing_parts``; then the layer
       with ``moe_collectives="auto"`` on a measuring tuner of its own
       cache file in ``tune_dir``, its output held against the named
       mode's and a second call (a memo hit) timed;
    b) ``forward_train`` with K4 on ``tokens`` in the ``dragonfly`` mode on
       the rank's compute leaves (``models.local_params``), its K4
       launches counted, its last-token logits gathered over the
       vocabulary and their bits summed, the MoE layer's routes kept;
       then ``loss_fn`` on every rank (its cross entropy on the rank's
       vocabulary slice, 1/16 of the float32 pass one process makes), one
       forward under ``timing_parts`` and one timed forward;
    c) one ``decode_step`` under the rules on the rank's compute leaves
       (MLA's ``wkv_b`` gathered, EP at the decode's ``DS_DECODE_ROWS`` rows)
       at the last position of a ``seeded_cache`` of ``DS_DECODE_SEQ``
       positions, of which the rank holds its block of 256, timed from a
       barrier; the carrier's copies and bytes (the gathered ``wkv_b`` and
       the EP exchange's buffers among them), the block's storages, the
       logits (every vocabulary entry) against ``decode_in["want"]``, the
       parent's one-process decode on whole leaves and the whole cache.
    Returns host data."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.runtime import autotune as AT

    dev = x.device
    mesh = make_mesh(DS_EP_MESH, ("data", "model"), device=dev.type)
    SH.set_active(SH.ShardRules(), mesh)
    rules = SH.active()[0]
    specs = M.param_specs(cfg, rules)
    stack = []
    for layer, spec in zip(params["stack"], specs["stack"]):
        if "router" in layer.get("ffn", {}):
            layer = {**layer, "ffn": {
                key: w[SH.local_slices(spec["ffn"][key], w.shape, mesh.coords, mesh.sizes)]
                if key in MOE.EXPERT_FF_DIM else w for key, w in layer["ffn"].items()}}
        stack.append(layer)
    local = {**params, "stack": stack}
    ffn = stack[0]["ffn"]
    whole = params["stack"][0]["ffn"]
    held = {key: list(ffn[key].shape) for key in MOE.EXPERT_FF_DIM}
    views = all(ffn[k].untyped_storage().data_ptr() == whole[k].untyped_storage().data_ptr()
                for k in MOE.EXPERT_FF_DIM)

    def sync():
        torch.cuda.synchronize(dev)

    def wall_ms(fn):
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30

    def same(a, b):
        return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))

    # a) the MoE layer alone, in every fixed mode
    layer = {"modes": {}, "held": held, "views": views}
    outs = {}
    for mode in EP_MODES:
        SH.set_active(SH.ShardRules(moe_collectives=mode), mesh)
        mesh.carrier_copies = mesh.carrier_bytes = 0
        torch.cuda.reset_peak_memory_stats(dev)
        with MOE.recording_routes() as routes:
            (y, aux), first_ms = wall_ms(lambda: MOE.moe_apply_auto(ffn, x, cfg))
        copies = {"copies": mesh.carrier_copies, "bytes": mesh.carrier_bytes}
        times = [wall_ms(lambda: MOE.moe_apply_auto(ffn, x, cfg))[1] for _ in range(DS_EP_CALLS)]
        with MOE.timing_parts() as parts:
            wall_ms(lambda: MOE.moe_apply_auto(ffn, x, cfg))
        (idx, keep, _), = routes
        outs[mode] = y
        layer["modes"][mode] = {
            "first_ms": first_ms, "call_ms": times, "parts": dict(parts),
            "carrier_per_call": copies, "peak_gib": peak_gib(), "aux": float(aux),
            "bits": _bits_sum(y), "bits_equal_plain": same(y, want_y),
            "vs_plain": attention_close(y, want_y, FLASH_TOL[str(x.dtype)]),
            "finite": bool(torch.isfinite(y).all()),
            "shape_ok": y.shape == x.shape and y.dtype == x.dtype,
            "idx": idx.cpu(), "keep": keep.cpu()}
    # a') the autotuner's pick, agreed by every rank, then a memo hit
    tuner = AT.Autotuner(cache_path=pathlib.Path(tune_dir) / f"ds-{rank}.json", device=dev)
    decide_s = timing_decisions(tuner)
    AT.set_autotuner(tuner)
    SH.set_active(SH.ShardRules(moe_collectives="auto"), mesh)
    (y_auto, aux_auto), first_ms = wall_ms(lambda: MOE.moe_apply_auto(ffn, x, cfg))
    dec = tuner.decisions[-1]
    mode = AT.EP_MODE[dec.strategy]
    (y_memo, _), memo_ms = wall_ms(lambda: MOE.moe_apply_auto(ffn, x, cfg))
    AT.set_autotuner(None)
    layer["auto"] = {"key": str(dec.key), "strategy": dec.strategy, "source": dec.source,
                     "mode": mode, "measured_us": dec.measured_us,
                     "analytic_us": dec.analytic_us, "decide_ms": decide_s[0] * 1e3,
                     "first_call_ms": first_ms, "memo_call_ms": memo_ms,
                     "memo_hit": len(tuner.decisions) == 1 and len(decide_s) == 2,
                     "bits_equal_named_mode": same(y_auto, outs[mode]) and same(y_memo, outs[mode]),
                     "aux_equal_named_mode": float(aux_auto) == layer["modes"][mode]["aux"]}
    layer["transport"], layer["carrier"] = mesh.transport, str(mesh.carrier)
    del outs, y, y_auto, y_memo

    # b) the model forward under EP, the dragonfly mode, K4 on, on the
    # rank's compute leaves: views of the shared weights, MLA on 8 of the
    # 128 heads, the dense prefix's MLPs and the shared expert on their ff
    # slice, the embedding and the unembedding cut on the model axis too
    SH.set_active(SH.ShardRules(moe_collectives="dragonfly"), mesh)
    local = M.local_params(params, cfg, SH.active()[0], mesh.coords, mesh.sizes)
    batch = {"tokens": tokens, "labels": tokens}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts((flash_attention,))
    with MOE.recording_routes() as routes:
        (logits, aux, _), first_ms = wall_ms(lambda: M.forward_train(local, batch, cfg, True))
    k4 = {"launches": flash_attention.launches, "bodies": dict(flash_attention.body_launches)}
    (idx, keep, lg), = routes
    last = M.whole_logits(logits[:, -1:])[:, 0]
    model = {"k4": k4, "first_ms": first_ms, "aux": float(aux), "logits_bits": _bits_sum(last),
             "finite": all(bool(torch.isfinite(c).all()) for c in logits.split(256, dim=1)),
             "last_logits": last.cpu() if rank == 0 else None,
             "routes": (idx.cpu(), keep.cpu(), lg.cpu()), "forward_peak_gib": peak_gib()}
    del logits, last
    torch.cuda.empty_cache()
    # every rank runs loss_fn: its tensor-axis collectives (the MTP block's,
    # the cross entropy's over the vocabulary) meet on all 16
    loss, metrics = M.loss_fn(local, batch, cfg, True)
    model["metrics"] = {key: float(val) for key, val in metrics.items()}
    del loss
    sync()
    model["loss_peak_gib"] = peak_gib()
    torch.cuda.empty_cache()
    with MOE.timing_parts() as parts:
        # the output dropped at once: kept, it doubled the logits held in the timed forward
        parts_ms = wall_ms(lambda: M.forward_train(local, batch, cfg, True))[1]
    model["parts"], model["parts_wall_ms"] = dict(parts), parts_ms
    model["ms"] = wall_ms(lambda: M.forward_train(local, batch, cfg, True))[1]
    model["peak_gib"] = peak_gib()

    # c) one decode step over the sequence-sharded latent cache
    from repro_torch.train import optimizer as O

    SH.set_active(SH.ShardRules(), mesh)
    c, m = mesh.coords["model"], mesh.sizes["model"]
    S_loc = DS_DECODE_SEQ // m
    whole_cache = seeded_cache(cfg, DS_DECODE_ROWS, DS_DECODE_SEQ, DS_DECODE_SEQ - 1, SEED + 1,
                               dev)
    # cache_specs: (data, model, None) on (B, S, ·); the data axis is 1
    block = O.unflatten(whole_cache, [t[:, c * S_loc:(c + 1) * S_loc].clone()
                                      for _, t in O.flatten(whole_cache)])
    del whole_cache
    block_bytes = sum(t.numel() * t.element_size() for _, t in O.flatten(block))
    storages = [t.untyped_storage().data_ptr() for _, t in O.flatten(block)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.carrier_copies = mesh.carrier_bytes = 0
    with torch.no_grad():
        (logits, block), ms = wall_ms(lambda: M.decode_step(
            local, block, {"token": decode_in["tokens"]}, DS_DECODE_SEQ - 1, cfg))
    want = decode_in["want"].to(dev)
    ok, err, rel = attention_close(logits, want, FLASH_TOL[str(logits.dtype)])
    decode = {"ms": ms, "carrier": {"copies": mesh.carrier_copies, "bytes": mesh.carrier_bytes},
              "block_bytes": block_bytes, "logits": list(logits.shape),
              "in_place": [t.untyped_storage().data_ptr()
                           for _, t in O.flatten(block)] == storages,
              "finite": bool(torch.isfinite(logits).all()), "bits": _bits_sum(logits),
              "vs_whole": {"ok": ok, "max_abs_err": err, "rel_rms": rel},
              "peak_gib": peak_gib()}
    del logits, want, block, local
    SH.clear_active()
    _release_shared(params, decode_in)
    return {"layer": layer, "model": model, "decode": decode}


def deepseek_ep_phase(dev, seed):
    """Step 17: DeepSeek-V3 at its published widths under expert
    parallelism on the production model axis, 16 ranks sharing the card
    (gloo, the host as the exchanges' carrier), 16 of the 256 experts a
    rank. The weights are made anew (``DS_EP_PREFIX`` of step 11's 3
    dense-prefix layers, 1 MoE layer and the MTP block) and shared by
    CUDA IPC; the one-process oracles (``moe_apply_ep_plain`` over the same
    mesh, the layer and the forward) run before the ranks start and only
    their outputs are kept. Returns its record and K4's launches (all
    ranks)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.runtime import autotune as AT

    t_phase = time.perf_counter()
    gib = lambda n: n / 2**30
    # earlier phases' reference cycles (a fleet's hooks refer back to it) can
    # still hold views of their weights: 8.89 GiB here on an H100 80GB without it
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    free0 = gib(torch.cuda.mem_get_info()[0])
    live = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in gc.get_objects() if torch.is_tensor(t) and t.is_cuda}
    print(f"deepseek_ep: {free0:.1f} GiB free on the card before the weights are made, "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB allocated, "
          f"{gib(sum(live.values())):.2f} GiB of it in {len(live)} live storages", flush=True)
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=DS_EP_PREFIX + 1, first_dense_layers=DS_EP_PREFIX)
    n_data, n_model = DS_EP_MESH
    ranks_n = n_data * n_model
    E, d = cfg.moe.num_experts, cfg.d_model
    E_loc = E // n_model
    layout = dragonfly_layout(n_model)
    require(SH.ShardRules(model_axis_size=n_model, data_axis_size=n_data).expert_parallel(E),
            f"{E} experts do not split over {n_model} model ranks")
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # init_params' float32 draws leave the bf16 weights in split cached segments,
    # which pinned 10.6 GiB the ranks need (H100 80GB): a round trip through the
    # host gives each weight a segment of its own
    t0 = time.perf_counter()
    host = _to(params, "cpu")
    del params
    torch.cuda.empty_cache()
    params = _to(host, dev)
    del host
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    weight_gb = _nbytes(params) / 1e9
    B, S = DS_EP_TOKENS
    x = torch.randn((B, S, d), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev).to(getattr(torch, cfg.compute_dtype))
    tokens = torch.randint(1, cfg.vocab, DS_EP_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    T_loc = B * S // ranks_n
    C = MOE.ep_capacity(cfg, T_loc)
    buf_bytes = n_model * E_loc * C * d * x.element_size()
    ffn = params["stack"][0]["ffn"]

    # the control: one expert's products in a batch of 256 and of 16
    rules = SH.ShardRules(model_axis_size=n_model, data_axis_size=n_data)
    sizes = {"data": n_data, "model": n_model}
    h = torch.randn((E, n_model * C, d), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev).to(x.dtype)
    y_all = MOE._expert_ffn(ffn, h)
    y_loc = torch.cat([MOE._expert_ffn(MOE.local_experts(ffn, cfg, rules, {"data": 0, "model": j},
                                                        sizes), h[j * E_loc:(j + 1) * E_loc])
                       for j in range(n_model)])
    diff = (y_all.float() - y_loc.float()).abs()
    control = {"h": list(h.shape), "bits_equal": bool(torch.equal(y_all.view(torch.int16),
                                                                  y_loc.view(torch.int16))),
               "max_abs_diff": float(diff.max()),
               "elements_differing_share": float((diff > 0).float().mean()),
               "experts_differing": int((diff.flatten(1) > 0).any(1).sum())}
    print(f"deepseek_ep: the expert FFN in one batch of {E} against {n_model} batches of "
          f"{E_loc}: {control}", flush=True)
    del h, y_all, y_loc, diff

    # the one-process oracles, before the ranks start; only their outputs kept
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as routes:
        want_y, want_aux = MOE.moe_apply_ep_plain(ffn, x, cfg, n_data, n_model)
    want_y, want_aux = want_y.cpu(), float(want_aux)
    want_idx, want_keep = (t.cpu() for t in routes[0][:2])
    del routes
    batch = {"tokens": tokens, "labels": tokens}
    auto = MOE.moe_apply_auto
    MOE.moe_apply_auto = lambda p, h, c: MOE.moe_apply_ep_plain(p, h, c, n_data, n_model)
    try:
        with MOE.recording_routes() as plain_routes:
            logits = M.forward_train(params, batch, cfg, True)[0]
        plain = {"last_logits": logits[:, -1].cpu(), "logits_bits": _bits_sum(logits),
                 "routes": tuple(t.cpu() for t in plain_routes[0])}
        del logits, plain_routes
        torch.cuda.empty_cache()
        plain["metrics"] = {key: float(val) for key, val in
                            M.loss_fn(params, batch, cfg, True)[1].items()}
    finally:
        MOE.moe_apply_auto = auto
    oracle_peak = gib(torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # c's oracle: one decode step on the whole leaves and the whole seeded cache
    dec_tokens = torch.randint(1, cfg.vocab, (DS_DECODE_ROWS,), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(seed))
    cache = seeded_cache(cfg, DS_DECODE_ROWS, DS_DECODE_SEQ, DS_DECODE_SEQ - 1, SEED + 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        dec_want = M.decode_step(params, cache, {"token": dec_tokens}, DS_DECODE_SEQ - 1,
                                 cfg)[0].cpu()
    dec_whole_ms = (time.perf_counter() - t0) * 1e3
    del cache
    oracle_peak = max(oracle_peak, gib(torch.cuda.max_memory_allocated()))
    torch.cuda.empty_cache()
    want_y = want_y.to(dev)  # allocated anew: kept in a cached segment, it would pin it
    with tempfile.TemporaryDirectory(prefix="autotune-ds-") as tmp:
        analytic = AT.moe_site_report(
            cfg, rules, n_tokens=B * S, dtype=str(x.dtype).split(".")[1],
            tuner=AT.Autotuner(cache_path=pathlib.Path(tmp) / "analytic.json", mode="analytic",
                               device=dev))
    before = _checksum(params)
    torch.cuda.empty_cache()
    free = gib(torch.cuda.mem_get_info()[0])
    print(f"deepseek_ep: {free:.1f} GiB free on the card before {ranks_n} ranks start "
          f"({weight_gb:.1f} GB of weights resident; the parent holds "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB, reserves "
          f"{gib(torch.cuda.memory_reserved()):.2f}; the oracles' peak {oracle_peak:.2f} GiB)",
          flush=True)

    build.build_all()  # the ranks only load the libraries
    # 16 allocators share what the weights leave of the card: the ranks' grow
    # and shrink their segments instead of caching fixed ones
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="autotune-ds-ep-") as tune_dir:
            ranks = spawn(deepseek_ep_rank, ranks_n, device="cuda",
                          args=(params, cfg, x, tokens, want_y, tune_dir,
                                {"tokens": dec_tokens, "want": dec_want}))
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    ranks_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    require(_checksum(params) == before, "a DeepSeek EP rank wrote to the shared weights")

    # a) the layer
    lay = [r["layer"] for r in ranks]
    want_bits = _bits_sum(want_y)
    for r, rec in enumerate(lay):
        require(rec["views"] and rec["held"] == {
            "w_in": [E_loc, d, cfg.moe.d_ff_expert], "w_gate": [E_loc, d, cfg.moe.d_ff_expert],
            "w_out": [E_loc, cfg.moe.d_ff_expert, d]}, f"DeepSeek EP, rank {r}: held {rec['held']}")
        for mode, m in rec["modes"].items():
            require(m["finite"] and m["shape_ok"], f"DeepSeek EP layer, rank {r}, {mode}: shape "
                                                   "or non-finite")
            require(m["bits"] == lay[0]["modes"][mode]["bits"],
                    f"DeepSeek EP layer, {mode}: rank {r}'s output differs from rank 0's")
            sl = slice(r * T_loc, (r + 1) * T_loc)
            entries = slice(r * T_loc * cfg.moe.top_k, (r + 1) * T_loc * cfg.moe.top_k)
            require(torch.equal(m["idx"], want_idx[sl])
                    and torch.equal(m["keep"], want_keep[entries]),
                    f"DeepSeek EP layer, rank {r}, {mode}: routes or drops differ from the plain "
                    "version's")
            if mode in EP_MODES[:3]:
                require(m["bits_equal_plain"], f"DeepSeek EP layer, rank {r}, {mode}: not the "
                                               f"bits of moe_apply_ep_plain: {m['vs_plain']}")
            else:
                require(m["vs_plain"][0], f"DeepSeek EP layer, rank {r}, {mode}: off the plain "
                                          f"version: {m['vs_plain']}")
        auxes = {m["aux"] for m in rec["modes"].values()}
        require(len(auxes) == 1 and auxes == {m["aux"] for m in lay[0]["modes"].values()},
                f"DeepSeek EP layer, rank {r}: aux {auxes}")
        a = rec["auto"]
        require((a["key"], a["strategy"], a["source"], a["measured_us"]) == (
            lay[0]["auto"]["key"], lay[0]["auto"]["strategy"], "measured",
            lay[0]["auto"]["measured_us"]),
            f"DeepSeek EP auto, rank {r}: decided {a['strategy']} ({a['source']}), rank 0 "
            f"{lay[0]['auto']['strategy']}")
        require(a["bits_equal_named_mode"] and a["aux_equal_named_mode"] and a["memo_hit"],
                f"DeepSeek EP auto, rank {r}: not the bits of {a['mode']}, or no memo hit: {a}")
    aux = lay[0]["modes"]["xla"]["aux"]
    aux_rel = abs(aux - want_aux) / abs(want_aux)
    require(aux_rel < 1e-5, f"DeepSeek EP layer aux {aux} vs plain {want_aux}")
    require(lay[0]["auto"]["key"] == analytic["key"],
            f"DeepSeek EP auto key {lay[0]['auto']['key']} vs moe_site_report {analytic['key']}")
    modes = {}
    for mode in EP_MODES:
        recs = [rec["modes"][mode] for rec in lay]
        per_call = [max(rec["call_ms"][i] for rec in recs) for i in range(DS_EP_CALLS)]
        modes[mode] = {
            "call_ms": statistics.median(per_call), "call_ms_each": per_call,
            "first_call_ms": max(rec["first_ms"] for rec in recs),
            "median_rank_parts_ms": {key: statistics.median(rec["parts"][key] for rec in recs)
                                     for key in ("exchange_ms", "experts_ms", "gather_ms")},
            "carrier_copies_per_call": recs[0]["carrier_per_call"],
            "peak_gib_per_rank_max": max(rec["peak_gib"] for rec in recs),
            "bits_equal_plain": all(rec["bits_equal_plain"] for rec in recs),
            "vs_plain": {"max_abs_err": max(rec["vs_plain"][1] for rec in recs),
                         "rel_rms": max(rec["vs_plain"][2] for rec in recs)}}
    dropped = int((~want_keep).sum())
    layer_rec = {"x": list(x.shape), "dtype": str(x.dtype), "T_loc": T_loc, "C_loc": C,
                 "E_loc": E_loc, "dispatch_buffer": [n_model, E_loc, C, d],
                 "dispatch_buffer_mb": buf_bytes / 1e6,
                 "gather_bytes_received_per_rank": (n_model - 1) * T_loc * d * x.element_size(),
                 "transport": lay[0]["transport"], "carrier": lay[0]["carrier"],
                 "aux": aux, "plain_aux": want_aux, "aux_rel_vs_plain": aux_rel,
                 "plain_bits": want_bits, "dropped_share": dropped / want_keep.numel(),
                 "expert_ffn_control": control, "modes": modes,
                 "auto": {key: lay[0]["auto"][key] for key in (
                     "key", "strategy", "mode", "measured_us", "analytic_us")}
                 | {"ranks_agree": len(lay),
                    "decide_ms_max_rank": max(rec["auto"]["decide_ms"] for rec in lay),
                    "first_call_ms_max_rank": max(rec["auto"]["first_call_ms"] for rec in lay),
                    "memo_call_ms_max_rank": max(rec["auto"]["memo_call_ms"] for rec in lay),
                    "mode_call_ms": {m: modes[m]["call_ms"] for m in EP_MODES},
                    "moe_site_report_analytic": analytic}}

    # b) the forward: tensor-parallel dense layers add their partial sums in
    # another order than one process, so the bf16 criteria of step 8
    mod = [r["model"] for r in ranks]
    k4 = {"launches": cfg.n_layers, "bodies": {"mma_sync": 0, "wgmma": cfg.n_layers}}
    for r, rec in enumerate(mod):
        require(rec["k4"] == k4, f"DeepSeek EP forward, rank {r}: K4 launched {rec['k4']}, "
                                 f"expected {k4}")
        require(rec["finite"] and rec["logits_bits"] == mod[0]["logits_bits"],
                f"DeepSeek EP forward, rank {r}: non-finite logits, or not rank 0's bits")
        require(rec["metrics"] == mod[0]["metrics"],
                f"DeepSeek EP loss_fn, rank {r}: {rec['metrics']} vs rank 0's {mod[0]['metrics']}")
    last, want_last = mod[0]["last_logits"].float(), plain["last_logits"].float()
    vs_plain = {"max_abs_err": float((last - want_last).abs().max()),
                "rel_rms": float((last - want_last).norm() / want_last.norm())}
    require(vs_plain["max_abs_err"] <= LOGIT_MAX_ABS and vs_plain["rel_rms"] <= LOGIT_REL_RMS,
            f"DeepSeek EP forward: rank 0's last-token logits off the one-process forward's: "
            f"{vs_plain}")
    got_routes = tuple(torch.cat([rec["routes"][j] for rec in mod]) for j in range(3))
    flips = route_flips([got_routes], [plain["routes"]], cfg.moe.top_k)
    # step 10's rule for DeepSeek-V3: the near-tie criterion required, the
    # share printed (bf16 router logits over 256 experts tie at the top)
    require((flips["first_gap_max"] or 0) < FIRST_FLIP_GAP_MAX,
            f"DeepSeek EP forward: a token's route first differs from the one-process "
            f"forward's away from a near-tie: {flips}")
    print(f"deepseek_ep: {flips['share']:.4%} of tokens' routes differ in order from the "
          f"one-process forward's, {flips['set_share']:.4%} as sets", flush=True)
    got_m, want_m = mod[0]["metrics"], plain["metrics"]
    metric_rel = {key: abs(got_m[key] - want_m[key]) / abs(want_m[key])
                  for key in ("ce", "mtp", "loss")}
    require(all(v <= LOSS_REL for v in metric_rel.values()),
            f"DeepSeek EP loss_fn: {got_m} vs one-process {want_m}")
    loss_rel = metric_rel["loss"]
    fwd_ms = max(rec["ms"] for rec in mod)
    parts_wall = max(rec["parts_wall_ms"] for rec in mod)
    ex = statistics.median(rec["parts"]["exchange_ms"] + rec["parts"]["gather_ms"] for rec in mod)
    model_rec = {"layers": f"{cfg.n_layers} of {full.n_layers} ({cfg.first_dense_layers} dense "
                           f"prefix, 1 MoE) + MTP", "tokens": list(DS_EP_TOKENS),
                 "mode": "dragonfly", "ms": fwd_ms,
                 "first_ms": max(rec["first_ms"] for rec in mod),
                 "tokens_per_s": B * S / fwd_ms * 1e3,
                 "exchange_and_gather_share": ex / parts_wall, "timed_with_parts_ms": parts_wall,
                 "median_rank_parts_ms": {key: statistics.median(rec["parts"][key] for rec in mod)
                                          for key in ("exchange_ms", "experts_ms", "gather_ms")},
                 "k4_per_rank": k4, "k4_all_ranks": ranks_n * cfg.n_layers,
                 "forward_peak_gib_per_rank_max": max(rec["forward_peak_gib"] for rec in mod),
                 "loss_peak_gib_per_rank_max": max(rec["loss_peak_gib"] for rec in mod),
                 "metrics": got_m, "plain_metrics": want_m, "metrics_rel": metric_rel,
                 "loss_rel": loss_rel, "last_logits_vs_plain": vs_plain, "route_flips": flips,
                 "k4_shape": [1, DS_EP_TOKENS[1], cfg.n_heads // n_model, 192, 128],
                 "last_logits_bits_equal_all_ranks": True}
    # c) the decode step over the sequence-sharded latent cache
    dec = [r["decode"] for r in ranks]
    for r, rec in enumerate(dec):
        vs = rec["vs_whole"]
        require(rec["finite"] and rec["bits"] == dec[0]["bits"],
                f"DeepSeek TP decode, rank {r}: non-finite logits, or not rank 0's bits")
        require(vs["max_abs_err"] <= LOGIT_MAX_ABS and vs["rel_rms"] <= LOGIT_REL_RMS,
                f"DeepSeek TP decode, rank {r}: its logits off the whole leaves' decode: {vs}")
        # the carrier also moves the gathered wkv_b (33.5 MB a layer) and the EP exchange's
        # fixed-capacity buffers, each larger than the block: its bytes are printed only
        require(rec["in_place"], f"DeepSeek TP decode, rank {r}: the cache block was not "
                                 "written in place")
    decode_rec = {"rows": DS_DECODE_ROWS, "cache_positions": DS_DECODE_SEQ,
                  "positions_a_rank": DS_DECODE_SEQ // n_model, "position": DS_DECODE_SEQ - 1,
                  "fill_std": DECODE_FILL_STD, "ms": max(rec["ms"] for rec in dec),
                  "whole_leaves_ms": dec_whole_ms, "carrier_a_rank": dec[0]["carrier"],
                  "block_bytes_a_rank": dec[0]["block_bytes"],
                  "peak_gib_per_rank_max": max(rec["peak_gib"] for rec in dec),
                  "vs_whole": {key: max(rec["vs_whole"][key] for rec in dec)
                               for key in ("max_abs_err", "rel_rms")}
                  | {"bound": [LOGIT_MAX_ABS, LOGIT_REL_RMS],
                     "within_k4_bound": all(rec["vs_whole"]["ok"] for rec in dec)}}
    del params, x, tokens, want_y, ffn
    return {"run": "deepseek_ep", "model": cfg.name, "mesh": {"data": n_data, "model": n_model},
            "model_axis_layout": f"D3({layout.topo.K},{layout.topo.M})",
            "weight_gb": weight_gb, "init_s": init_s, "compact_s": compact_s,
            "card_free_gib_before": free0,
            "card_free_gib_before_ranks": free, "oracle_peak_gib": oracle_peak,
            "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase,
            "weights_unchanged": True, "layer": layer_rec, "forward": model_rec,
            "decode": decode_rec}, ranks_n * cfg.n_layers



# --------------------------------------------------------------------------
# Step 18: the sharded training step on a mesh of processes sharing the card
# --------------------------------------------------------------------------
def _flat_named(tree):
    """{path string: tensor} of a tree of dicts and lists (``None`` left out)."""
    from repro_torch.train.optimizer import flatten

    return {"/".join(map(str, path)): x for path, x in flatten(tree) if x is not None}


def _mu(state, key):
    """{param path string: the held ``key`` moment} of an optimizer state
    (a leaf the rank holds none of left out)."""
    from repro_torch.train.optimizer import flatten

    return {"/".join(map(str, path[:-1])): x for path, x in flatten(state["mu"])
            if path[-1] == key and x is not None}


def reference_device_bytes(cfg, pspecs, like, sizes) -> int:
    """The bytes one device holds of the JAX package's stacked parameters
    under these specs (every split even): each stacked member's leaf
    (G, *leaf) once, its leading dim split where a ``Holder`` names the
    batch axes, every other leaf as the port's."""
    import math

    from repro_torch.dist import sharding as SH
    from repro_torch.train import optimizer as O

    period = len(cfg.layer_kinds())
    total = 0
    for path, leaf in O.flatten(like):
        holder, own = SH.split_holder(O.get(pspecs, path))
        shape = list(leaf.shape)
        entries = list(own) + [None] * (len(shape) - len(own))
        if path[0] in O.STACKED:
            if path[1] >= (period if path[0] == "stack" else 1):
                continue  # one leaf a stacked member
            shape = [(cfg.n_layers - cfg.first_dense_layers) // period if path[0] == "stack"
                      else cfg.first_dense_layers] + shape
            entries = [holder] + entries
        parts = math.prod(math.prod(sizes[a] for a in SH.spec_axes(e)) for e in entries)
        total += math.prod(shape) // parts * leaf.element_size()
    return total


@contextlib.contextmanager
def recorded(module, name):
    """The output of every call of ``module.name`` made inside the block,
    in a list."""
    real, calls = getattr(module, name), []

    def record(*args):
        calls.append(real(*args))
        return calls[-1]

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def codes_vs_oracle(codes, want, cfg):
    """The sharded step's codes (by JAX path) against the one-process
    step's (``want["q/<path>"]``, ``want["s/<path>"]``): every code within
    one of its (a value at a half-step of its block's scale may round the
    other way when the gradient sums add in another order), each JAX
    leaf's scales ||Δ|| / ||scales|| (``scale_rel``, the worst leaf) and
    the worst block's relative difference, and how many of the values
    (the blocks' padding left out) have a code that differs (``flips``).
    Returns (a record, {port leaf path string: mask of those values})."""
    from repro_torch.train import compression as C
    from repro_torch.train import train_step as TS

    rec = {"blocks": 0, "max_code_diff": 0, "scale_rel": 0.0, "scale_rel_worst_block": 0.0}
    differ = {}
    for ref_path, (q, sc) in codes.items():
        key = "/".join(map(str, ref_path))
        wq, ws = want[f"q/{key}"], want[f"s/{key}"]
        diff = (q.int() - wq.int()).abs()
        rec["blocks"] += q.shape[0]
        rec["max_code_diff"] = max(rec["max_code_diff"], int(diff.max()))
        rec["scale_rel"] = max(rec["scale_rel"], float((sc - ws).norm() / ws.norm()))
        rec["scale_rel_worst_block"] = max(rec["scale_rel_worst_block"],
                                           float(((sc - ws).abs() / ws).max()))
        differ[ref_path] = (diff != 0).reshape(-1)
    masks = {"/".join(map(str, path)): m for path, m in C.by_port_leaf(
        differ.__getitem__, TS.param_shapes(cfg), len(cfg.layer_kinds())).items()}
    rec["values"] = sum(m.numel() for m in masks.values())
    rec["flips"] = sum(int(m.sum()) for m in masks.values())
    return rec, masks


def truncating_quantize(g):
    """A planted fault in ``train.compression.quantize``'s place: the codes
    cast to int8 without rounding (a cast truncates). Every code is within
    one of the right one and every scale is the same: only the share of
    codes that differ (``FLIP_SHARE``) tells it from the sharded sum's
    rounding."""
    import torch

    from repro_torch.train import compression as C

    flat = g.float().reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % C.BLOCK)).reshape(-1, C.BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(blocks / scale[:, None], -127, 127).to(torch.int8), scale


def k4_local_heads(dev, time_ms, bound) -> list:
    """Step 7's last part: K4 at the local-head shapes of the
    tensor-parallel forwards (a rank's query heads and the KV heads they
    read), each against its plain version by the bf16 bound and timed
    beside one SDPA call; the bound counts the key pairs the mask lets
    through, 2·D + 2·Dv operations a pair and head. ``time_ms`` and
    ``bound`` are ``main``'s. Returns a record a shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain, key_pairs)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    tl = get_config("tinyllama-1.1b")
    mcfg = get_config("mixtral-8x7b")
    ds_cfg = get_config("deepseek-v3-671b")
    ds_d = ds_cfg.mla.qk_nope_head_dim + ds_cfg.mla.qk_rope_head_dim
    jcfg = get_config("jamba-1.5-large-398b")
    local_cases = [  # (where, B, S, Hq, Hkv, D, Dv, window)
        ("step 18 d: tinyllama-1.1b, model axis 2", TRAIN_SHARDED_TOKENS[0]
         // TRAIN_SHARDED_MESH[0], TRAIN_SHARDED_TOKENS[1], tl.n_heads // TRAIN_SHARDED_MESH[1],
         tl.n_kv_heads // TRAIN_SHARDED_MESH[1], tl.head_dim, tl.head_dim, None),
        ("step 19 b: tinyllama-1.1b prefill_32k, model axis 16", 2, 32768, tl.n_heads // 16, 1,
         tl.head_dim, tl.head_dim, None),
        ("step 13 b: mixtral-8x7b EP, model axis 8", MIXTRAL_TOKENS[0], MIXTRAL_TOKENS[1],
         mcfg.n_heads // EP_MESH[1], 1, mcfg.head_dim, mcfg.head_dim, mcfg.sliding_window),
        ("step 14 b: mixtral-8x7b TP, model axis 16", TP_FORWARD_TOKENS[0], TP_FORWARD_TOKENS[1],
         mcfg.n_heads // TP_MESH[1], 1, mcfg.head_dim, mcfg.head_dim, mcfg.sliding_window),
        ("step 17 b: deepseek-v3-671b MLA, model axis 16", DS_EP_TOKENS[0],
         DS_EP_TOKENS[1], ds_cfg.n_heads // DS_EP_MESH[1], ds_cfg.n_heads // DS_EP_MESH[1],
         ds_d, ds_cfg.mla.v_head_dim, None),
        ("step 18 f: jamba-1.5-large-398b, model axis 2", RECURRENT_JAMBA_TOKENS[0]
         // TRAIN_SHARDED_MESH[0], RECURRENT_JAMBA_TOKENS[1], jcfg.n_heads // TRAIN_SHARDED_MESH[1],
         jcfg.n_kv_heads // TRAIN_SHARDED_MESH[1], jcfg.head_dim, jcfg.head_dim, None),
    ]
    local_heads = []
    for where, b_, sq, hq, hkv, d, dv, window in local_cases:
        q = randn(b_, sq, hq, d).to(torch.bfloat16)
        k = randn(b_, sq, hkv, d).to(torch.bfloat16)
        v = randn(b_, sq, hkv, dv).to(torch.bfloat16)
        zero_counts((flash_attention,))
        got = flash_attention(q, k, v, causal=True, window=window)
        bodies = dict(flash_attention.body_launches)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        ok, err, rel = attention_close(got, want, FLASH_TOL["torch.bfloat16"])
        require(ok and bool(torch.isfinite(got).all()),
                f"flash_attention at {where} off by max {err}, relative rms {rel}")
        del got, want
        pairs = key_pairs(sq, sq, True, window)
        b_ms, b_by = bound(2 * (q.numel() + b_ * sq * hq * dv + k.numel() + v.numel()),
                           b_ * hq * pairs * (2 * d + 2 * dv), BF16_FLOP_PER_S)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=hq != hkv)
            library = "SDPA, is_causal" + (", enable_gqa" if hq != hkv else "")
        else:
            pos = torch.arange(sq, device=dev)
            allowed = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
            kt, vt = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                        attn_mask=allowed)
            library = "SDPA, boolean window mask, KV heads expanded"
        rec = {"where": where, "q": [b_, sq, hq, d], "kv": [b_, sq, hkv, dv], "window": window,
               "bodies": bodies, "max_abs_err": err, "rel_rms": rel, "key_pairs": pairs,
               "ms": time_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                             reps=10),
               "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, causal=True,
                                                                 window=window),
                                   reps=1, warmup=0),  # 4.5 s a call at (2, 32768)
               "library_ms": time_ms(sdpa, reps=10), "library": library,
               "bound_ms": b_ms, "bound_by": b_by,
               "persistent_tiles": b_ * hq * -(-sq // 128)}
        local_heads.append(rec)
        emit({"check": "flash_attention, local heads", **rec})
        del q, k, v, qt, kt, vt
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return local_heads


def ep_without_exchange(params, x, cfg):
    """Step 18 c's oracle of a MoE layer, in the ranks: the expert-parallel
    layer with no all-to-all, in ``moe.moe_apply_auto``'s place. The rank
    holds its model group's whole data shard ``x``, so it routes every
    token shard of the group as that shard's rank does, builds its own
    experts' arrivals (E_loc, n_model·C_loc, d) from them where the
    exchange would deliver them, runs its experts, and all-gathers their
    outputs over the model axis (the backward: each block's cotangent from
    the one rank that reads it, the others' zeros added); then, as
    ``moe_apply_ep`` does, it combines its own token shard, all-gathers the
    tokens and means aux over every shard. The dense layers around it are
    the step's own, so its routes, the experts' arrivals and their outputs'
    cotangents are the step's. It records the rank's shard's routes as
    ``moe_apply_ep`` does."""
    import math

    import torch
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.dist.collectives import all_gather, all_reduce_sum
    from repro_torch.models import moe as MOE

    rules, mesh = SH.active()
    m = cfg.moe
    E, n_model = m.num_experts, rules.model_axis_size
    E_loc, (B, S, d) = E // n_model, x.shape
    require("shared" not in params, "ep_without_exchange: a shared expert")
    T_loc = B * S // n_model
    C = MOE.ep_capacity(cfg, T_loc)
    mc = mesh.coords[rules.tensor_axis]
    group = mesh.group(rules.tensor_axis)
    xs = x.reshape(B * S, d)
    shards = [xs[i * T_loc:(i + 1) * T_loc] for i in range(n_model)]
    routes = [MOE._route(t, params["router"], cfg, C) for t in shards]
    r = routes[mc]
    if MOE._ROUTES is not None:
        MOE._ROUTES.append((r.idx.detach(), r.keep.detach(), r.logits.detach()))
    arrivals = torch.stack([MOE._dispatch(t, q, E, C)[mc * E_loc:(mc + 1) * E_loc]
                            for t, q in zip(shards, routes)])  # (n_model, E_loc, C, d)
    experts = (params if params["w_in"].shape[0] == E_loc
               else MOE.local_experts(params, cfg, rules, mesh.coords, mesh.sizes))
    y = MOE._expert_ffn(experts, arrivals.transpose(0, 1).reshape(E_loc, n_model * C, d))
    y = all_gather(y, group, mesh=mesh).reshape(E, n_model, C, d)
    out = all_gather(MOE._combine(y[:, mc], r, T_loc), group, mesh=mesh)
    aux = MOE.load_balance_loss(r.logits, r.idx, E, m.top_k)
    total = all_reduce_sum(aux.reshape(1), dist.group.WORLD, mesh=mesh)
    return out.reshape(B, S, d), total[0] / math.prod(mesh.shape)


def train_sharded_rank(rank, group, layout, jobs, mesh_shape, seed):
    """One rank of step 18: lays the ranks out as a ``mesh_shape`` mesh of
    (data, model) and runs each job of ``jobs`` (``_train_sharded_job``) in
    turn. Returns {part: its record}."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cuda")
    jobs_by_part = {"d": _tp_prefill_job, "e": _tp_decode_job, "f": _recurrent_tp_job,
                    "g": _recurrent_tp_job}
    return {job["part"]: jobs_by_part.get(job["part"], _train_sharded_job)(rank, mesh, job, seed)
            for job in jobs}


def seeded_cache(cfg, rows, max_seq, start, seed, dev):
    """A bf16 decode cache of ``rows`` rows and ``max_seq`` positions whose
    positions below ``start`` hold N(0, ``DECODE_FILL_STD``²) values drawn
    from ``seed`` on the card, the rest zeros, and whose recurrent states
    (Mamba, mLSTM, sLSTM) hold such values whole: the same bits wherever it
    is made from the same seed."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O

    cache = M.init_cache(cfg, rows, max_seq, torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for path, t in O.flatten(cache):
        if path[-1] in ("k", "v"):  # GQA (B, H, S, hd)
            t = t[:, :, :start]
        elif path[-1] in ("c_kv", "k_rope"):  # MLA (B, S, r)
            t = t[:, :start]
        t.normal_(0.0, DECODE_FILL_STD, generator=gen)
    return cache


def no_rescale_join(o, m, l, tp):  # noqa: E741
    """A planted fault: the ranks' split-KV partials added without their
    exp(m − M) rescale."""
    import torch

    both = tp.sum(torch.cat([o, l[..., None]], dim=-1))
    return both[..., :-1] / both[..., -1:]


def every_rank_writes(pos_b, S_loc, tp):
    """A planted fault: every rank writes the new token into its own block
    of the cache (at the position modulo the block), not only its owner."""
    import torch

    return pos_b % S_loc, torch.ones_like(pos_b, dtype=torch.bool)


def own_h_only(tp):
    """A planted fault: a copy of the tensor axis ``tp`` whose all-gather
    gives the rank's own block among zeros, so that the sLSTM steps on its
    own ``h`` (no gather)."""
    import copy

    def gather_last(h):
        out = h.new_zeros((*h.shape[:-1], h.shape[-1] * tp.size))
        out[..., tp.coord * h.shape[-1]:(tp.coord + 1) * h.shape[-1]] = h
        return out

    bad = copy.copy(tp)
    bad.gather_last = gather_last
    return bad


def planted_slstm(T):
    """``transformer._RECURRENT``'s sLSTM entry with ``own_h_only``'s axis
    given to its train and decode forms (the planted fault of step 18 g)."""
    init, train, decode, state = T._RECURRENT["slstm"]
    return (init, lambda p, x, cfg, tp=None: train(p, x, cfg, tp=own_h_only(tp)),
            lambda p, x, s_, cfg, tp=None: decode(p, x, s_, cfg, tp=own_h_only(tp)), state)


def block_vs_cache(block, cache, c, S_loc, written):
    """The rank's block of every cache leaf against the same positions of
    the oracle's whole ``cache``: the positions ``written`` (global, those
    the steps wrote) that fall in the block within what bf16 moves (their
    max |Δ|), every other position the same bits (no rank writes where it
    does not own the position)."""
    import torch

    from repro_torch.train import optimizer as O

    lo, hi = c * S_loc, (c + 1) * S_loc
    mine = [p - lo for p in written if lo <= p < hi]
    err, same = 0.0, True
    for (_, blk), (_, whole) in zip(O.flatten(block), O.flatten(cache)):
        ref = whole[:, :, lo:hi]
        keep = torch.ones(S_loc, dtype=torch.bool, device=blk.device)
        keep[mine] = False
        same &= bool(torch.equal(blk[:, :, keep], ref[:, :, keep]))
        if mine:
            err = max(err, float((blk[:, :, mine].float() - ref[:, :, mine].float()).abs().max()))
    return {"untouched_same_bits": same, "written_max_abs": err, "written_in_block": len(mine)}


def _tp_decode_job(rank, mesh, job, seed):
    """Step 18 e, in 18 b's ranks: ``job["cfg"]`` (TinyLlama-1.1B whole,
    bf16) made whole from ``seed`` on the card, and the rank's rows of a
    ``seeded_cache`` of ``DECODE_MAX_SEQ`` positions (seed + 1 + its data
    coordinate), filled below ``DECODE_START``; the rank holds its block of
    it, ``DECODE_MAX_SEQ`` / m positions on the model axis, as
    ``models.cache_specs`` cuts it. ``DECODE_STEPS`` steps of
    ``decode_step`` under the mesh's rules on its compute leaves
    (``models.local_params``), each timed from a barrier, the carrier's
    copies and bytes counted, the block's storages checked to be the ones
    it was given (written in place, never gathered); then the same steps
    on the whole leaves and the whole cache with no rules (the oracle),
    timed, and the TP logits against them; the planted faults at the first
    step (the join without its rescale; every rank writing the new token);
    last the whole-leaf decode's first ``DECODE_CONTROL_STEPS`` steps in
    float32 on the same weights and cache against the bf16 one
    (``bf16_control``: what bf16 alone moves).
    Returns host data."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as CL
    from repro_torch.dist import sharding as SH
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O

    t_job = time.perf_counter()
    cfg, dev = job["cfg"], mesh.device
    n_d, m, c = mesh.sizes["data"], mesh.sizes["model"], mesh.coords["model"]
    rows = slice(mesh.coords["data"] * DECODE_ROWS // n_d,
                 (mesh.coords["data"] + 1) * DECODE_ROWS // n_d)
    tokens = torch.from_numpy(job["batch"]["tokens"][:, rows]).to(dev)
    whole = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    cache = seeded_cache(cfg, tokens.shape[1], DECODE_MAX_SEQ, DECODE_START,
                         seed + 1 + mesh.coords["data"], dev)
    S_loc = DECODE_MAX_SEQ // m
    # cache_specs: (data, None, model, None); the rows are already the rank's
    block = O.unflatten(cache, [t[:, :, c * S_loc:(c + 1) * S_loc].clone()
                                for _, t in O.flatten(cache)])
    block_bytes = sum(t.numel() * t.element_size() for _, t in O.flatten(block))
    storages = [t.untyped_storage().data_ptr() for _, t in O.flatten(block)]
    SH.set_active(SH.ShardRules(), mesh)
    local = M.local_params(whole, cfg, SH.active()[0], mesh.coords, mesh.sizes)

    def steps(params, held, sync_ranks, n=DECODE_STEPS):
        logits, ms = [], []
        for i in range(n):
            if sync_ranks:
                dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, held = M.decode_step(params, held, {"token": tokens[i]}, DECODE_START + i, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(out)
        return torch.stack(logits), ms, held

    with torch.no_grad():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh.carrier_copies = mesh.carrier_bytes = 0
        got, tp_ms, block = steps(local, block, True)
        carrier = {"copies": mesh.carrier_copies, "bytes": mesh.carrier_bytes}
        peak = torch.cuda.max_memory_allocated() / 2**30
        in_place = [t.untyped_storage().data_ptr() for _, t in O.flatten(block)] == storages
        SH.clear_active()
        want, whole_ms, cache = steps(whole, cache, False)
        ok, err, rel = attention_close(got, want, FLASH_TOL[str(got.dtype)])
        written = range(DECODE_START, DECODE_START + DECODE_STEPS)
        out = {"coords": mesh.coords, "rows": int(tokens.shape[1]), "logits": list(got.shape),
               "ms": tp_ms, "whole_ms": whole_ms, "carrier_a_step": {
                   k: v / DECODE_STEPS for k, v in carrier.items()},
               "block_bytes": block_bytes, "in_place": in_place,
               "finite": bool(torch.isfinite(got).all()), "peak_gib": peak,
               "vs_whole": {"ok": ok, "max_abs_err": err, "rel_rms": rel},
               "block": block_vs_cache(block, cache, c, S_loc, written)}
        del got
        # the planted faults, each at the first step (the block's later positions are
        # masked there); every-rank-writes last, since it writes into a block it does not own
        SH.set_active(SH.ShardRules(), mesh)
        for name, (module, attr, fake) in (("no_rescale", (CL, "lse_combine", no_rescale_join)),
                                           ("every_rank_writes", (A, "_owned",
                                                                  every_rank_writes))):
            with patched(module, attr, fake):
                bad, _, block = steps(local, block, True, n=1)
            _, err, rel = attention_close(bad, want[:1], FLASH_TOL[str(bad.dtype)])
            out[f"planted_{name}"] = {"max_abs_err": err, "rel_rms": rel,
                                      "block": block_vs_cache(block, cache, c, S_loc, written)}
        SH.clear_active()
        del local, block, bad
        # the first steps on whole leaves in float32, on the same weights and cache
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        whole = _cast(whole, torch.float32)
        cache = _cast(cache, torch.float32)
        want32 = torch.stack([M.decode_step(whole, cache, {"token": tokens[i]}, DECODE_START + i,
                                            cfg32)[0] for i in range(DECODE_CONTROL_STEPS)])
        _, err, rel = attention_close(want[:DECODE_CONTROL_STEPS], want32,
                                      FLASH_TOL[str(want.dtype)])
        out["bf16_control"] = {"max_abs_err": err, "rel_rms": rel}
    del whole, cache, want, want32
    torch.cuda.empty_cache()
    out["job_s"] = time.perf_counter() - t_job
    return out


def _timed(fn, barrier: bool) -> list:
    """The ms of ``PREFILL_TP_REPS`` calls of ``fn``, each after the one
    before (the first call a warm-up, not kept), each from a barrier of the
    world where ``barrier`` says so."""
    import torch
    import torch.distributed as dist

    ms = []
    for _ in range(PREFILL_TP_REPS + 1):
        if barrier:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms[1:]


def _tp_prefill_job(rank, mesh, job, seed):
    """Step 18 d, in 18 b's ranks: ``job["cfg"]`` (TinyLlama-1.1B whole,
    bf16) made whole from ``seed`` on the card; ``forward_train`` with K4
    on the rank's rows of ``job["batch"]`` under the mesh's rules, on the
    rank's compute leaves (``models.local_params``: views of the whole
    parameters, its heads, ff slice and vocabulary slice), K4's launches
    and bodies counted; then the same rows through the same forward on the
    whole leaves with no rules (one process's), compared with it on the
    rank's vocabulary slice of the logits: K4's bf16 bound
    (``attention_close``: whether it holds, max |Δ|, relative rms), the
    parent holding the last two to the model path's bound. Both timed
    (``PREFILL_TP_REPS`` calls after a warm-up, the TP ones from a
    barrier). Then what that bound is read against: the TP forward with a
    planted fault (each query head reads the other of the rank's KV
    heads), which it must reject; the same two forwards in float32 on the
    same weights (``witness_f32``: TP against whole leaves, where only the
    order of the row blocks' partial sums differs); and the whole-leaf
    bf16 forward against that float32 one (``bf16_control``: what bf16
    alone moves). Returns host data."""
    import torch

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    cfg, dev = job["cfg"], mesh.device
    SH.set_active(SH.ShardRules(), mesh)
    rules = SH.active()[0]
    whole = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    local = M.local_params(whole, cfg, rules, mesh.coords, mesh.sizes)
    batch = TS.shard_batch({"tokens": torch.from_numpy(job["batch"]["tokens"])},
                           {"tokens": rules.tokens()}, mesh)

    with torch.no_grad():
        zero_counts((flash_attention,))
        logits = M.forward_train(local, batch, cfg, use_kernel=True, remat=False)[0]
        torch.cuda.synchronize()
        k4 = {"launches": flash_attention.launches, "bodies": dict(flash_attention.body_launches)}
        tp_ms = _timed(lambda: M.forward_train(local, batch, cfg, True, remat=False), True)
        SH.clear_active()
        want = M.forward_train(whole, batch, cfg, use_kernel=True, remat=False)[0]
        whole_ms = _timed(lambda: M.forward_train(whole, batch, cfg, True, remat=False), False)
        n = cfg.vocab // mesh.sizes["model"]
        c = mesh.coords["model"]
        mine = want[..., c * n:(c + 1) * n]
        ok, err, rel = attention_close(logits, mine, FLASH_TOL[str(logits.dtype)])
        out = {"coords": mesh.coords, "rows": list(batch["tokens"].shape),
               "logits": list(logits.shape), "k4": k4, "ms": tp_ms, "whole_ms": whole_ms,
               "vs_whole": {"ok": ok, "max_abs_err": err, "rel_rms": rel},
               "finite": bool(torch.isfinite(logits).all()),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del logits
        real = A.kv_heads_read

        def other_kv(H, Hkv, h0, h1):  # each query head reads the rank's other KV head
            k0, k1, pick = real(H, Hkv, h0, h1)
            return k0, k1, [(i + 1) % (k1 - k0) for i in pick]

        SH.set_active(SH.ShardRules(), mesh)
        with patched(A, "kv_heads_read", other_kv):
            bad = M.forward_train(local, batch, cfg, use_kernel=True, remat=False)[0]
        _, err, rel = attention_close(bad, mine, FLASH_TOL[str(bad.dtype)])
        out["planted_wrong_kv"] = {"max_abs_err": err, "rel_rms": rel}
        del bad, local
        # float32 on the same weights: whole leaves, then the TP forward on their cut
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        whole = _cast(whole, torch.float32)
        SH.clear_active()
        want32 = M.forward_train(whole, batch, cfg32, use_kernel=True, remat=False)[0]
        want32 = want32[..., c * n:(c + 1) * n].clone()
        _, err, rel = attention_close(mine, want32, FLASH_TOL[str(mine.dtype)])
        out["bf16_control"] = {"max_abs_err": err, "rel_rms": rel}
        del want, mine
        SH.set_active(SH.ShardRules(), mesh)
        local = M.local_params(whole, cfg32, rules, mesh.coords, mesh.sizes)
        got32 = M.forward_train(local, batch, cfg32, use_kernel=True, remat=False)[0]
        SH.clear_active()
        _, err, rel = attention_close(got32, want32, FLASH_TOL[str(got32.dtype)])
        out["witness_f32"] = {"max_abs_err": err, "rel_rms": rel}
    del whole, local, got32, want32
    torch.cuda.empty_cache()
    return out


def _widen(tree):
    """Every tensor of a parameter or cache tree (dicts and lists) cast to
    float32 in place, one leaf at a time (the bf16 leaf freed as its copy
    is made)."""
    import torch

    for key in (tree if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[key], (dict, list)):
            _widen(tree[key])
        else:
            tree[key] = tree[key].to(torch.float32)


def _spread(got, want):
    """(max |Δ|, relative rms) of ``got`` against ``want``, lists of tensors
    taken as one vector, in float32."""
    d2 = w2 = 0.0
    top = 0.0
    for g, w in zip(got, want):
        diff = g.float() - w.float()
        d2 += float(diff.square().sum())
        w2 += float(w.float().square().sum())
        top = max(top, float(diff.abs().max()))
    return top, (d2 / max(w2, 1e-30)) ** 0.5


def _recurrent_tp_job(rank, mesh, job, seed):
    """Step 18 f (Jamba-1.5-Large, 2 layers) and g (xLSTM-1.3B, 8 layers),
    in 18 b's ranks: ``job["cfg"]`` (bf16) made whole from ``seed`` on the
    card. The prefill: ``forward_train`` with K4 on the rank's rows of
    ``job["batch"]`` under the mesh's rules on its compute leaves
    (``models.local_params``: every Mamba, mLSTM and sLSTM leaf cut as
    ``param_specs`` cuts it), K4's launches and the carrier's bytes
    counted, then the same rows on the whole leaves with no rules, both
    timed; where ``job["planted"]`` is the unpaired ``w_in``, the TP
    forward with the stored ``[x | z]`` columns of ``w_in`` taken as the
    rank's channels' x and z (no exchange). The decode:
    ``RECURRENT_DECODE_STEPS`` steps of ``decode_step`` under the rules on
    the rank's ``cache_specs`` shard of every leaf of a ``seeded_cache``
    (the recurrent states at their shards, never gathered), each timed
    from a barrier; where ``job["planted"]`` is the sLSTM on the rank's own
    ``h`` (``planted_slstm``), the same steps with it planted (its prefill
    moves the logits too little for the check to see: 2.3 % rms against
    the whole leaves' 1.9 % from float32, on one H100); then the same
    steps on the whole leaves and the whole cache. Last the control: the
    whole-leaf prefill and decode in float32 on the same weights and cache.
    Each of the rank's outputs (its vocabulary slice of the prefill's
    logits, the decode's logits, and the change of its shard of every
    recurrent state over the steps, the new state less the seeded fill,
    taken by mixer and leaf name: the mLSTM's C of every layer together,
    its n, its m, the sLSTM's c, …) is measured against the whole leaves'
    bf16 one and against the float32 one, beside the whole leaves' own
    distance from float32. Returns host data."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as CL
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    t_job = time.perf_counter()
    cfg, dev = job["cfg"], mesh.device
    plant = {"unpaired_w_in": (CL.TensorParallel, "own_parts", lambda self, x, parts: x),
             "slstm_own_h": (T._RECURRENT, "slstm", planted_slstm(T))}.get(job["planted"])
    n_d, m, c, dc = mesh.sizes["data"], mesh.sizes["model"], mesh.coords["model"], \
        mesh.coords["data"]
    SH.set_active(SH.ShardRules(), mesh)
    rules = SH.active()[0]
    whole = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    local = M.local_params(whole, cfg, rules, mesh.coords, mesh.sizes)
    batch = TS.shard_batch({"tokens": torch.from_numpy(job["batch"]["tokens"])},
                           {"tokens": rules.tokens()}, mesh)
    n = cfg.vocab // m

    def forward(params, c_=cfg):
        return M.forward_train(params, batch, c_, use_kernel=True, remat=False)[0]

    def versus(tp, whole_, f32):
        """The TP output against the whole leaves' and float32's."""
        err, rel = _spread(tp, whole_)
        return {"max_abs_err": err, "rel_rms": rel, "vs_f32_rel_rms": _spread(tp, f32)[1],
                "whole_vs_f32_rel_rms": _spread(whole_, f32)[1]}

    out = {"coords": mesh.coords, "rows": list(batch["tokens"].shape)}
    with torch.no_grad():
        # the prefill
        zero_counts((flash_attention,))
        mesh.carrier_copies = mesh.carrier_bytes = 0
        logits = forward(local)
        torch.cuda.synchronize()
        k4 = {"launches": flash_attention.launches, "bodies": dict(flash_attention.body_launches)}
        carrier = {"copies": mesh.carrier_copies, "bytes": mesh.carrier_bytes}
        tp_ms = _timed(lambda: forward(local), True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        bad = None
        if job["planted"] == "unpaired_w_in":
            with patched(*plant):
                bad = forward(local)
        SH.clear_active()
        want = forward(whole)[..., c * n:(c + 1) * n].clone()
        whole_ms = _timed(lambda: forward(whole), False)
        out["prefill"] = {"k4": k4, "carrier": carrier, "ms": tp_ms, "whole_ms": whole_ms,
                          "logits": list(logits.shape), "peak_gib": peak,
                          "finite": bool(torch.isfinite(logits).all())}

        # the decode, the rank's shard of every cache leaf
        R = RECURRENT_DECODE_ROWS
        rows = slice(dc * R // n_d, (dc + 1) * R // n_d)
        tokens = torch.from_numpy(job["decode_tokens"][:, rows]).to(dev)
        start = RECURRENT_DECODE_SEQ - RECURRENT_DECODE_STEPS

        def fresh():
            return seeded_cache(cfg, tokens.shape[1], RECURRENT_DECODE_SEQ, start,
                                seed + 1 + dc, dev)

        cache = fresh()
        cspecs = M.cache_specs(cfg, rules, False)
        one = dict(mesh.sizes, data=1)  # the rows are already the rank's
        at = dict(mesh.coords, data=0)

        def shards(tree):
            return {path: t[SH.local_slices(O.get(cspecs, path), t.shape, at, one)]
                    for path, t in O.flatten(tree)}

        fill = {path: t.clone() for path, t in shards(cache).items()}

        def held_fill():
            return O.unflatten(cache, [fill[path].clone() for path, _ in O.flatten(cache)])

        held = held_fill()

        def steps(params, state, sync_ranks, c_=cfg):
            logits_, ms = [], []
            for i in range(RECURRENT_DECODE_STEPS):
                if sync_ranks:
                    dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o, state = M.decode_step(params, state, {"token": tokens[i]}, start + i, c_)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits_.append(o)
            return torch.stack(logits_), ms, state

        SH.set_active(SH.ShardRules(), mesh)
        mesh.carrier_copies = mesh.carrier_bytes = 0
        got, tp_steps, held = steps(local, held, True)
        carrier = {"copies": mesh.carrier_copies / RECURRENT_DECODE_STEPS,
                   "bytes": mesh.carrier_bytes / RECURRENT_DECODE_STEPS}
        bad_held = None
        if job["planted"] == "slstm_own_h":
            with patched(*plant):
                bad_held = dict(O.flatten(steps(local, held_fill(), True)[2]))
        SH.clear_active()
        dwant, whole_steps, cache = steps(whole, cache, False)
        attn = ("k", "v", "c_kv", "k_rope")
        mine_new, want_new = dict(O.flatten(held)), shards(cache)
        states = [p for p in mine_new if p[-1] not in attn]
        kv = [p for p in mine_new if p[-1] in ("k", "v")]
        block = (block_vs_cache([mine_new[p] for p in kv], [O.get(cache, p) for p in kv],
                                c, RECURRENT_DECODE_SEQ // m, range(start, RECURRENT_DECODE_SEQ))
                 if kv else None)
        out["decode"] = {"ms": tp_steps, "whole_ms": whole_steps, "carrier_a_step": carrier,
                         "finite": bool(torch.isfinite(got).all()), "state_leaves": len(states),
                         "shapes_are_shards": all(tuple(mine_new[p].shape)
                                                  == tuple(want_new[p].shape) for p in mine_new),
                         "attention_block": block}
        del local, held

        # the control: whole leaves in float32, on the same weights and cache
        _widen(whole)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        want32 = forward(whole, cfg32)[..., c * n:(c + 1) * n]
        out["prefill"]["vs"] = versus([logits], [want], [want32])
        out["planted"] = {"name": job["planted"]}
        if bad is not None:
            out["planted"]["prefill"] = versus([bad], [want], [want32])
        del logits, want, want32, bad
        cache32 = fresh()
        _widen(cache32)
        dwant32, _, cache32 = steps(whole, cache32, False, cfg32)
        out["decode"]["vs"] = versus([got], [dwant], [dwant32])
        ref32 = shards(cache32)

        kinds = [mixer for mixer, _ in cfg.layer_kinds()] * cfg.n_groups
        groups = {}  # "mixer/leaf" -> that leaf's paths in every layer of the mixer
        for p in states:
            groups.setdefault(f"{kinds[p[1]]}/{p[-1]}", []).append(p)

        def changes(new):  # each state's change over the steps, by mixer and leaf name
            return {name: versus([new[p].float() - fill[p].float() for p in ps],
                                 [want_new[p].float() - fill[p].float() for p in ps],
                                 [ref32[p].float() - fill[p].float() for p in ps])
                    for name, ps in groups.items()}

        out["decode"]["states"] = changes(mine_new)
        if bad_held is not None:
            out["planted"]["states"] = changes(bad_held)
    del whole, cache, cache32, got, dwant, dwant32, fill, bad_held
    torch.cuda.empty_cache()
    out["job_s"] = time.perf_counter() - t_job
    return out


def recurrent_tp_jobs(dev) -> list:
    """Step 18 f and g's jobs: Jamba-1.5-Large cut to
    ``RECURRENT_JAMBA_LAYERS`` (an attention and a Mamba member, each with
    the dense MLP) with the planted unpaired ``w_in``, and xLSTM-1.3B cut
    to ``RECURRENT_XLSTM_LAYERS`` with the planted sLSTM on its own ``h``;
    tokens from the seed."""
    import torch

    from repro_torch.configs import get_config

    jamba = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                                n_layers=RECURRENT_JAMBA_LAYERS, attn_period=2, moe=None)
    xlstm = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=RECURRENT_XLSTM_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(vocab, shape):
        return torch.randint(1, vocab, shape, device=dev, generator=gen).cpu().numpy()

    return [{"part": part, "cfg": cfg, "batch": {"tokens": draw(cfg.vocab, tokens)},
             "decode_tokens": draw(cfg.vocab, (RECURRENT_DECODE_STEPS, RECURRENT_DECODE_ROWS)),
             "planted": {"f": "unpaired_w_in", "g": "slstm_own_h"}[part]}
            for part, cfg, tokens in (("f", jamba, RECURRENT_JAMBA_TOKENS),
                                      ("g", xlstm, RECURRENT_XLSTM_TOKENS))]


def recurrent_tp_runs(ranks, cfgs, mesh_shape) -> tuple[list, int]:
    """Step 18 f and g's records from the ranks' ``_recurrent_tp_job``
    results (``ranks``: per rank, {part: record}; ``cfgs``: {part: config}),
    each check required on every rank: the TP prefill's and decode's
    logits and the change of the rank's shard of each recurrent state (by
    mixer and leaf name) no farther from the float32 control than
    ``RECURRENT_CONTROL_FACTOR`` times the whole leaves' bf16 ones are,
    and within the model path's max |Δ| of the whole leaves'; each planted
    fault outside that: the unpaired ``w_in`` in the prefill's logits, the
    sLSTM on its own ``h`` in a state of the decode; K4
    one ``wgmma`` launch a rank in Jamba's TP prefill, none in xLSTM's;
    the attention block's untouched positions the same bits. Returns (the
    records, K4's launches)."""
    runs, k4_launches = [], 0
    keys = ("max_abs_err", "rel_rms", "vs_f32_rel_rms", "whole_vs_f32_rel_rms")
    for part, cfg in cfgs.items():
        recs = [r[part] for r in ranks]
        n_attn = sum(1 for mixer, _ in cfg.layer_kinds() * cfg.n_groups if mixer == "attn")
        want_k4 = {"launches": n_attn, "bodies": {"mma_sync": 0, "wgmma": n_attn}}

        def within(vs):
            return (vs["vs_f32_rel_rms"] <= RECURRENT_CONTROL_FACTOR * vs["whole_vs_f32_rel_rms"]
                    and vs["max_abs_err"] <= LOGIT_MAX_ABS)

        def worst_state(states):
            """The state farthest from float32 against the whole leaves' own
            distance, with its name."""
            name = max(states, key=lambda k: states[k]["vs_f32_rel_rms"]
                       / max(states[k]["whole_vs_f32_rel_rms"], 1e-30))
            return dict(states[name], state=name)

        for r, rec in enumerate(recs):
            pf, dec = rec["prefill"], rec["decode"]
            require(pf["k4"] == want_k4, f"step 18 {part}, rank {r}: K4 launched {pf['k4']}, "
                                         f"expected {want_k4}")
            for key, vs, finite in (("prefill", pf["vs"], pf["finite"]),
                                    ("decode", dec["vs"], dec["finite"]),
                                    *((f"state {k}", v, True) for k, v in dec["states"].items())):
                require(finite and within(vs), f"step 18 {part}, rank {r}: the TP {key} against "
                                               f"whole leaves and float32: {vs}")
            require(dec["shapes_are_shards"], f"step 18 {part}, rank {r}: a state is not at its "
                                              "cache_specs shard")
            blk = dec["attention_block"]
            require(blk is None or (blk["untouched_same_bits"]
                                    and blk["written_max_abs"] <= LOGIT_MAX_ABS),
                    f"step 18 {part}, rank {r}: its attention block off the whole cache's: {blk}")
            bad = rec["planted"]
            caught = (any(not within(v) for v in bad["states"].values()) if "states" in bad
                      else not within(bad["prefill"]))
            require(caught, f"step 18 {part}, rank {r}: the planted {bad['name']} passes the "
                            f"check: {bad}")
        k4_launches += sum(rec["prefill"]["k4"]["launches"] for rec in recs)
        tokens = sum(rec["rows"][0] * rec["rows"][1] for rec in recs) // mesh_shape[1]
        tp_ms = statistics.median(max(rec["prefill"]["ms"][i] for rec in recs)
                                  for i in range(PREFILL_TP_REPS))
        whole_ms = statistics.median(max(rec["prefill"]["whole_ms"][i] for rec in recs)
                                     for i in range(PREFILL_TP_REPS))
        step_ms = [max(rec["decode"]["ms"][i] for rec in recs)
                   for i in range(RECURRENT_DECODE_STEPS)]
        whole_step = [max(rec["decode"]["whole_ms"][i] for rec in recs)
                      for i in range(RECURRENT_DECODE_STEPS)]

        def worst(get):
            return {k: max(get(rec)[k] for rec in recs) for k in keys}

        planted = {"name": recs[0]["planted"]["name"]}
        if "prefill" in recs[0]["planted"]:
            planted["prefill"] = worst(lambda rec: rec["planted"]["prefill"])
        if "states" in recs[0]["planted"]:
            planted["worst_state"] = [worst_state(rec["planted"]["states"]) for rec in recs]
        runs.append({
            "run": f"recurrent_tp {part}", "model": f"{cfg.name}, {cfg.n_layers} layers, bf16",
            "mesh": list(mesh_shape), "rows_a_rank": recs[0]["rows"],
            "k4_per_rank": recs[0]["prefill"]["k4"], "control_factor": RECURRENT_CONTROL_FACTOR,
            "prefill": {"ms": tp_ms, "tokens_per_s": tokens / tp_ms * 1e3,
                        "whole_leaves_ms": whole_ms,
                        "whole_leaves_tokens_per_s": tokens / whole_ms * 1e3,
                        "carrier_a_rank": recs[0]["prefill"]["carrier"],
                        "vs": worst(lambda rec: rec["prefill"]["vs"]),
                        "peak_gib_a_rank": max(rec["prefill"]["peak_gib"] for rec in recs)},
            "decode": {"steps": RECURRENT_DECODE_STEPS, "rows": RECURRENT_DECODE_ROWS,
                       "ms_a_step": statistics.median(step_ms[1:]), "first_step_ms": step_ms[0],
                       "whole_ms_a_step": statistics.median(whole_step[1:]),
                       "carrier_a_step_a_rank": recs[0]["decode"]["carrier_a_step"],
                       "vs": worst(lambda rec: rec["decode"]["vs"]),
                       "state_leaves": recs[0]["decode"]["state_leaves"],
                       "worst_state": [worst_state(rec["decode"]["states"]) for rec in recs],
                       "attention_blocks": [rec["decode"]["attention_block"] for rec in recs]},
            "planted": planted,
            "job_s": max(rec["job_s"] for rec in recs)})
        emit(runs[-1])
    return runs, k4_launches


def _train_sharded_job(rank, mesh, job, seed):
    """Makes the whole parameters from ``seed`` on the card (every rank and
    the parent's oracle draw the same bits), cuts them and a fresh
    optimizer state to the rank's shards by ``train_shardings``, frees the
    rest, takes its rows of the job's batch and runs its steps in each of
    its modes from the same state (kept on the host between modes), every
    launch count of K1–K5 at 0 first. ``want`` holds the oracle's tensors
    on the card, shared by CUDA IPC: the first moment of each leaf it names
    is held against the rank's slice of it in the first mode (the other
    modes are held to the first's bits), and parts "a" and "a_compress"
    gather the whole state and hold every leaf against it (``a_compress``
    its codes too, ``codes_vs_oracle``). The rank empties ``want`` before
    it returns (``_release_shared``). Returns host data."""
    import torch

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.block_matmul.block_matmul import block_matmul
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.runtime.backends import cuda_fused as cf
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    counters = (cf.reduce_rounds, cf.combine_rows, block_matmul, flash_attention, cf.ring_put,
                cf.ring_signal, cf.ring_wait_add)
    cfg, opt_cfg, rules_kw, modes = job["cfg"], job["opt_cfg"], job["rules_kw"], job["modes"]
    dev = mesh.device
    gib = lambda n: n / 2**30
    settings = TS.TrainSettings(use_kernel=False, remat=True, compress_grads=job["compress"])
    SH.set_active(SH.ShardRules(**dict(rules_kw, moe_collectives=modes[0])), mesh)
    rules = SH.active()[0]
    specs = TS.train_shardings(cfg, rules, opt_cfg, settings)
    like = TS.state_shapes(cfg, opt_cfg)
    fresh = like[1]
    if job["compress"]:  # the error-feedback state: zeros of the parameters' shapes, float32
        fresh = dict(fresh, err=O.unflatten(like[0], [
            torch.empty(x.shape, dtype=torch.float32, device="meta")
            for _, x in O.flatten(like[0])]))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whole = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    p0, s0 = TS.shard_train_state(whole, fresh, specs[:2], mesh)
    del whole
    torch.cuda.empty_cache()
    out = {"coords": mesh.coords, "init_s": time.perf_counter() - t0, "modes": {},
           "held_bytes": {"params": _nbytes(_flat_named(p0)), "m": _nbytes(_mu(s0, "m")),
                          "v": _nbytes(_mu(s0, "v"))}}
    if len(modes) > 1:  # every mode starts from these shards, kept on the host
        p0, s0 = _to(p0, "cpu"), _to(s0, "cpu")
    b = TS.shard_batch({k: torch.from_numpy(v) for k, v in job["batch"].items()}, specs[2], mesh)
    step = TS.make_sharded_train_step(cfg, opt_cfg, settings)
    paths = {name: tuple(int(k) if k.isdigit() else k for k in name.split("/"))
             for name in job["watch"]}
    ranks_m = {}
    if job["watch"]:  # the oracle in the ranks: the same step from the same state, its MoE
        # layers without the exchange (``ep_without_exchange``); kept on the host
        p, s = _to(p0, dev), _to(s0, dev)
        with patched(MOE, "moe_apply_auto", ep_without_exchange), \
                MOE.recording_routes() as routes:
            p, s, _ = step(p, s, b)
        ranks_m = {name: O.get(s["mu"], path)["m"].cpu() for name, path in paths.items()}
        out["oracle_routes"] = [t.cpu() for t in routes[0][:2]]
        del p, s
        torch.cuda.empty_cache()
    kept = None
    for mode in modes:
        SH.set_active(SH.ShardRules(**dict(rules_kw, moe_collectives=mode)), mesh)
        p, s = (_to(p0, dev), _to(s0, dev)) if len(modes) > 1 else (p0, s0)
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"metrics": [], "ms": [], "carrier_bytes": [], "carrier_copies": []}
        for _ in range(job["steps"]):
            c0, k0 = mesh.carrier_bytes, mesh.carrier_copies
            with MOE.timing_parts() as parts, TS.timing_parts() as step_parts, \
                    recorded(TS, "_compress") as codes, MOE.recording_routes() as routes:
                t0 = time.perf_counter()
                p, s, m = step(p, s, b)
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
            if routes and "routes" not in rec:  # the first forward's, the first MoE layer's
                rec["routes"] = [t.cpu() for t in routes[0][:2]]
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            rec["carrier_bytes"].append(mesh.carrier_bytes - c0)
            rec["carrier_copies"].append(mesh.carrier_copies - k0)
            rec["moe_parts"] = dict(parts)
            rec["step_parts"] = dict(step_parts)
        rec["launches"] = {c.__name__: c.launches for c in counters}
        rec["peak_gib"] = gib(torch.cuda.max_memory_allocated())
        if job["watch"]:  # the first moment against both oracles', slice by slice
            cmp = {}
            for name, path in paths.items():
                mspec = O.get(specs[1]["mu"], path)["m"]
                sl = SH.held_slices(mspec, O.get(like[0], path).shape, mesh.coords, mesh.sizes)
                if sl is None or TS._replica(mspec, mesh):
                    continue
                want = job["want"][name][sl].float()  # the one-process step's
                ref = ranks_m[name].to(dev).float()  # the ranks' oracle's
                got = O.get(s["mu"], path)["m"].float()
                # zero where the ranks' oracle's is not: above bf16's noise (an entry whose
                # gradient cancels to zero in one order of bf16 sums may not in another)
                noise = SHARDED_M_REL * ref.pow(2).mean().sqrt()
                above = ref.abs() > noise
                c = {"d2": float(torch.sum((got - want) ** 2)), "w2": float(torch.sum(want ** 2)),
                     "d2_ranks": float(torch.sum((got - ref) ** 2)),
                     "r2": float(torch.sum(ref ** 2)),
                     "zeros_above": int((above & (got == 0)).sum()),
                     "nonzero": int((ref != 0).sum()),
                     "zeros_of_nonzero": int(((ref != 0) & (got == 0)).sum()),
                     "zeros": int((got == 0).sum()), "ranks_oracle_zeros": int((ref == 0).sum()),
                     # against the one-process step's, by its own noise (routes may differ)
                     "zeros_above_one_process": int(((want.abs() > SHARDED_M_REL
                                                      * want.pow(2).mean().sqrt())
                                                     & (got == 0)).sum()),
                     "one_process_zeros": int((want == 0).sum())}
                if name.endswith("w_gate"):  # planted: one entry zeroed, the ranks' largest
                    planted = got.clone().reshape(-1)
                    planted[ref.abs().argmax()] = 0
                    c["planted_zeros_above"] = int((above.reshape(-1) & (planted == 0)).sum())
                    del planted
                cmp[name] = c
                del want, ref, got, above
            rec["m_vs_oracle"] = cmp
        if kept is None:
            kept = (_to(p, "cpu"), _to(s, "cpu")) if len(modes) > 1 else (p, s)
        else:  # another mode: the first mode's bits, every held slice, and its distance, on
            # the card a leaf of the first mode's at a time (on the host, 8 ranks' comparisons
            # took longer than the step)
            same, worst = True, 0.0
            for x, y in zip(list(_flat_named(p).values()) + list(_mu(s, "m").values())
                            + list(_mu(s, "v").values()),
                            list(_flat_named(kept[0]).values()) + list(_mu(kept[1], "m").values())
                            + list(_mu(kept[1], "v").values())):
                y = y.to(dev)
                same = same and torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                                            y.contiguous().reshape(-1).view(torch.uint8))
                worst = max(worst, float((x.float() - y.float()).norm()
                                         / y.float().norm().clamp(min=1e-30)))
                del y
            rec["same_bits_as_first"], rec["worst_leaf_rel_to_first"] = same, worst
        del p, s
        out["modes"][mode] = rec
    if job["part"] in ("a", "a_compress"):  # the whole state, every leaf against the oracle's
        gp, gs = TS.gather_train_state(kept[0], kept[1], specs[:2], like, mesh)
        errs = {}
        if rank == 0:
            want = job["want"]
            got = {**{f"p/{k}": v for k, v in _flat_named(gp).items()},
                   **{f"m/{k}": v for k, v in _mu(gs, "m").items()},
                   **{f"v/{k}": v for k, v in _mu(gs, "v").items()},
                   **{f"e/{k}": v for k, v in _flat_named(gs.get("err", {})).items()}}
            skip, norm_of = {}, {}
            if job["compress"]:  # the codes, and what a value at a half-step moves
                out["codes"], skip = codes_vs_oracle(codes[-1][0], want, cfg)
                norm_of = {k: want[k].float() + want[f"d/{k[2:]}"].float() for k in got
                           if k.startswith("e/")}
            require(set(got) == {k for k in want if k[:2] in ("p/", "m/", "v/", "e/")},
                    f"the gathered state's leaves {sorted(set(got) ^ set(want))}")
            for k in got:
                w, g = want[k].to(dev).float(), got[k].float()
                ref = norm_of.get(k, w)
                if not k.startswith("p/") and k[2:] in skip:  # each flip's own value set aside
                    keep = ~skip[k[2:]]
                    w, g, ref = w[keep], g[keep], ref[keep]
                errs[k] = float((g - w).norm() / ref.norm().clamp(min=1e-30))
        out["leaf_rel_err"] = errs
        del gp, gs
    del kept, p0, s0, b
    _release_shared(job["want"])
    SH.clear_active()
    torch.cuda.empty_cache()
    return out


def train_sharded_phase(dev, counters):
    """Step 18: the sharded training step (``train.train_step.
    make_sharded_train_step``) on meshes of processes sharing the card
    (gloo, the host as the carrier). a) TinyLlama-1.1B at full width, 2
    layers, float32, mesh (2, 2) with FSDP (each data coordinate holds one
    whole layer), one step against the one-process step on the card;
    b) TinyLlama-1.1B whole, bf16, mesh (2, 2) with FSDP, one step on (4,
    2048), and d) its tensor-parallel prefill with K4 in the same ranks;
    c) Mixtral-8x7B at its published widths with 1 layer, mesh (2, 4)
    under EP with ZeRO-1, one step in each of ``MIXTRAL_TRAIN_MODES``
    beside the ranks' own oracle (``ep_without_exchange``).
    Each one-process oracle runs first and only its outputs are kept.
    ``counters`` are the kernel wrappers: every part launches none.
    Returns the runs' records."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.train import compression as C
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import DataState, SyntheticLM

    t_phase = time.perf_counter()
    gib = lambda n: n / 2**30
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    print(f"train_sharded: {gib(torch.cuda.memory_allocated()):.2f} GiB allocated before the "
          "phase", flush=True)
    settings = TS.TrainSettings(use_kernel=False, remat=True)
    runs = []

    def oracle(cfg, opt_cfg, batch, steps, moe=None, compress=False):
        """The one-process step on the card from the same seed: (params,
        state, metrics a step, its ms, peak, the first forward's routes of
        its first MoE layer (idx, keep) and, with ``compress``, the last
        step's codes and dequantized gradient), the MoE layers as ``moe``
        gives them."""
        params = M.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
        state = O.init_state(params, opt_cfg)
        if compress:
            state = dict(state, err=C.init_error(params))
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        auto = MOE.moe_apply_auto
        if moe is not None:
            MOE.moe_apply_auto = moe
        zero_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        try:
            step = TS.make_train_step(cfg, opt_cfg,
                                      dataclasses.replace(settings, compress_grads=compress))
            metrics, ms = [], []
            with recorded(C, "compress_tree") as codes, recorded(C, "decompress_tree") as deq, \
                    MOE.recording_routes() as routes:
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    params, state, m = step(params, state, b)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    metrics.append({k: float(v) for k, v in m.items()})
        finally:
            MOE.moe_apply_auto = auto
        launches = {c.__name__: c.launches for c in counters}
        require(not any(launches.values()), f"the one-process step launched {launches}")
        peak = gib(torch.cuda.max_memory_allocated())
        return params, state, metrics, {"ms": ms, "peak_gib": peak,
                                        "routes": [t.cpu() for t in routes[0][:2]] if routes
                                        else None,
                                        "codes": codes[-1][0] if codes else None,
                                        "deq": deq[-1] if deq else None}

    def run_ranks(jobs, mesh_shape):
        """The jobs on one spawn of ``mesh_shape`` ranks: (per-rank {part:
        record}, the free GiB before they start, their seconds)."""
        torch.cuda.empty_cache()
        free = gib(torch.cuda.mem_get_info()[0])
        n = mesh_shape[0] * mesh_shape[1]
        parts = ", ".join(job["part"] for job in jobs)
        print(f"train_sharded {parts}: {free:.1f} GiB free on the card before {n} ranks start",
              flush=True)
        conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        try:
            ranks = spawn(train_sharded_rank, n, device="cuda",
                          args=(jobs, mesh_shape, SEED))
        finally:
            if conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
        for job in jobs:
            part = job["part"]
            for r, rec in enumerate(ranks):
                for mode, m in rec[part].get("modes", {}).items():
                    require(not any(m["launches"].values()),
                            f"step 18 {part}, rank {r}, {mode}: launched {m['launches']}")
                    require(m["metrics"] == ranks[0][part]["modes"][mode]["metrics"],
                            f"step 18 {part}: rank {r}'s metrics differ from rank 0's")
        return ranks, free, time.perf_counter() - t0

    def job(part, cfg, opt_cfg, rules_kw, batch, modes=("xla",), steps=1, watch=(), want=None,
            compress=False):
        return {"part": part, "cfg": cfg, "opt_cfg": opt_cfg, "rules_kw": rules_kw,
                "batch": batch, "modes": modes, "steps": steps, "watch": tuple(watch),
                "want": want or {}, "compress": compress}

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    full = get_config("tinyllama-1.1b")
    mesh_ab = TRAIN_SHARDED_MESH
    sizes_ab = {"data": mesh_ab[0], "model": mesh_ab[1]}
    opt_cfg = O.OptConfig(lr=TRAIN_LR, warmup_steps=1)

    # a and b on one spawn of 4 ranks, the oracles first. a) TinyLlama-1.1B, 2 layers, float32
    t_part = time.perf_counter()
    cfg32 = dataclasses.replace(full, n_layers=TRAIN_SMALL_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    data_a = SyntheticLM(DataState(seed=SEED, batch=TRAIN_SHARDED_CHECK_TOKENS[0],
                                   seq=TRAIN_SHARDED_CHECK_TOKENS[1], vocab=full.vocab)).next_batch()
    params, state, want_a, orc_a = oracle(cfg32, opt_cfg, data_a, 1)
    want_state = {**{f"p/{k}": v for k, v in _flat_named(params).items()},
                  **{f"m/{k}": v for k, v in _mu(state, "m").items()},
                  **{f"v/{k}": v for k, v in _mu(state, "v").items()}}
    # the control: the same one-process step with bf16 weights, against float32: the
    # distance bf16 alone puts between two correct steps (what b and c's bounds face)
    m32 = _mu(state, "m")
    del params, state
    p16, s16, want16, _ = oracle(dataclasses.replace(cfg32, param_dtype="bfloat16",
                                                     compute_dtype="bfloat16"), opt_cfg, data_a, 1)
    m_rel16 = {k: float((v.float() - m32[k]).norm() / m32[k].norm().clamp(min=1e-30))
               for k, v in _mu(s16, "m").items()}
    control = {"loss": rel(want16[0]["loss"], want_a[0]["loss"]),
               "grad_norm": rel(want16[0]["grad_norm"], want_a[0]["grad_norm"]),
               "m_worst_leaf": max(m_rel16.values()), "m_median_leaf":
               statistics.median(m_rel16.values())}
    print(f"train_sharded a: the bf16 control, one-process bf16 against float32: {control}",
          flush=True)
    del p16, s16, m32
    # a, compressed: the one-process compressed step; its codes and dequantized gradient too
    params, state, want_ac, orc_ac = oracle(cfg32, opt_cfg, data_a, 1, compress=True)
    want_compress = {**{f"p/{k}": v for k, v in _flat_named(params).items()},
                     **{f"m/{k}": v for k, v in _mu(state, "m").items()},
                     **{f"v/{k}": v for k, v in _mu(state, "v").items()},
                     **{f"e/{k}": v for k, v in _flat_named(state["err"]).items()},
                     **{f"d/{k}": v for k, v in _flat_named(orc_ac["deq"]).items()}}
    for ref_path, (q, sc) in orc_ac["codes"].items():
        key = "/".join(map(str, ref_path))
        want_compress[f"q/{key}"], want_compress[f"s/{key}"] = q, sc
    del params, state, orc_ac["codes"], orc_ac["deq"]
    # the planted fault FLIP_SHARE must reject: the same step, its codes cast without rounding
    with patched(C, "quantize", truncating_quantize):
        _, _, _, orc_t = oracle(cfg32, opt_cfg, data_a, 1, compress=True)
    planted, _ = codes_vs_oracle(orc_t["codes"], want_compress, cfg32)
    del orc_t
    require(planted["max_code_diff"] <= 1 and planted["flips"] > FLIP_SHARE * planted["values"],
            f"step 18 a, compressed: the truncating cast's codes {planted} pass the cap")
    # b) TinyLlama-1.1B whole, bf16 weights and float32 Adam state, TRAIN_SHARDED_STEPS steps
    data_b = SyntheticLM(DataState(seed=SEED, batch=TRAIN_SHARDED_TOKENS[0],
                                   seq=TRAIN_SHARDED_TOKENS[1], vocab=full.vocab)).next_batch()
    params, state, want_b, orc_b = oracle(full, opt_cfg, data_b, TRAIN_SHARDED_STEPS)
    del params, state
    oracles_s = time.perf_counter() - t_part
    # e's tokens: a step's token for each of its rows, from the seed
    data_e = {"tokens": torch.randint(
        1, full.vocab, (DECODE_STEPS, DECODE_ROWS), device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED)).cpu().numpy()}
    recurrent = recurrent_tp_jobs(dev)
    ranks, free_ab, ranks_s = run_ranks(
        [job("a", cfg32, opt_cfg, {"fsdp": True}, data_a, want=want_state),
         job("a_compress", cfg32, opt_cfg, {"fsdp": True}, data_a, want=want_compress,
             compress=True),
         job("b", full, opt_cfg, {"fsdp": True}, data_b, steps=TRAIN_SHARDED_STEPS),
         job("d", full, opt_cfg, {}, data_b),
         job("e", full, opt_cfg, {}, data_e), *recurrent], mesh_ab)

    got = ranks[0]["a"]["modes"]["xla"]["metrics"][0]
    errs = ranks[0]["a"]["leaf_rel_err"]
    worst = max(errs, key=errs.get)
    require(errs[worst] <= TRAIN_GRAD_TOL, f"step 18 a: leaf {worst} {errs[worst]:.3g} off the "
                                           "one-process step")
    require(rel(got["loss"], want_a[0]["loss"]) <= TRAIN_LOSS_TOL
            and rel(got["grad_norm"], want_a[0]["grad_norm"]) <= TRAIN_GRAD_TOL
            and rel(got["lr"], want_a[0]["lr"]) <= TRAIN_GRAD_TOL,
            f"step 18 a: metrics {got} against the one-process step's {want_a[0]}")
    runs.append({"run": "train_sharded a", "model": f"{full.name}, {cfg32.n_layers} layers, float32",
                 "mesh": list(mesh_ab), "rules": "fsdp", "tokens": list(TRAIN_SHARDED_CHECK_TOKENS),
                 "metrics": got, "oracle_metrics": want_a[0], "leaves": len(errs),
                 "worst_leaf": [worst, errs[worst]], "bf16_control": control,
                 "ms": ranks[0]["a"]["modes"]["xla"]["ms"], "oracle_ms": orc_a["ms"],
                 "peak_gib_a_rank": max(r["a"]["modes"]["xla"]["peak_gib"] for r in ranks),
                 "launches": ranks[0]["a"]["modes"]["xla"]["launches"]})
    emit(runs[-1])

    plain_a, got_c = ranks[0]["a"]["modes"]["xla"], ranks[0]["a_compress"]["modes"]["xla"]
    errs, codes = ranks[0]["a_compress"]["leaf_rel_err"], ranks[0]["a_compress"]["codes"]
    worst = max(errs, key=errs.get)
    require(codes["max_code_diff"] <= 1 and codes["scale_rel"] <= TRAIN_GRAD_TOL
            and codes["flips"] <= FLIP_SHARE * codes["values"],
            f"step 18 a, compressed: codes {codes} against the one-process step's")
    require(errs[worst] <= TRAIN_GRAD_TOL, f"step 18 a, compressed: leaf {worst} "
                                           f"{errs[worst]:.3g} off the one-process step")
    for key in ("loss", "grad_norm"):
        require(rel(got_c["metrics"][0][key], want_ac[0][key]) <= SHARDED_REL,
                f"step 18 a, compressed: {key} {got_c['metrics'][0][key]} against the "
                f"one-process {want_ac[0][key]}")
    runs.append({"run": "train_sharded a compressed", "model": f"{full.name}, {cfg32.n_layers} "
                 "layers, float32", "mesh": list(mesh_ab), "rules": "fsdp, compress_grads",
                 "tokens": list(TRAIN_SHARDED_CHECK_TOKENS), "metrics": got_c["metrics"][0],
                 "oracle_metrics": want_ac[0], "codes": codes,
                 "flip_share": codes["flips"] / codes["values"], "flip_share_cap": FLIP_SHARE,
                 "planted_truncating_cast": dict(
                     planted, flip_share=planted["flips"] / planted["values"]),
                 "leaves": len(errs),
                 "worst_leaf": [worst, errs[worst]],
                 "worst_by_kind": {kind: max(v for k, v in errs.items() if k.startswith(kind))
                                   for kind in ("p/", "m/", "v/", "e/")},
                 "ms": got_c["ms"], "uncompressed_ms": plain_a["ms"],
                 "carrier_bytes_a_step": got_c["carrier_bytes"],
                 "uncompressed_carrier_bytes_a_step": plain_a["carrier_bytes"],
                 "carrier_copies_a_step": got_c["carrier_copies"],
                 "uncompressed_carrier_copies_a_step": plain_a["carrier_copies"],
                 "step_parts_rank0": got_c["step_parts"],
                 "uncompressed_step_parts_rank0": plain_a["step_parts"],
                 "oracle_ms": orc_ac["ms"],
                 "peak_gib_a_rank": max(r["a_compress"]["modes"]["xla"]["peak_gib"]
                                        for r in ranks),
                 "launches": got_c["launches"]})
    emit(runs[-1])

    got = ranks[0]["b"]["modes"]["xla"]
    for i, m in enumerate(got["metrics"]):
        for key in ("loss", "grad_norm"):
            require(rel(m[key], want_b[i][key]) <= SHARDED_REL,
                    f"step 18 b, step {i}: {key} {m[key]} against the one-process "
                    f"{want_b[i][key]}")
    rules_b = SH.ShardRules(fsdp=True, data_axis_size=mesh_ab[0], model_axis_size=mesh_ab[1])
    pspecs = TS.train_shardings(full, rules_b, opt_cfg, settings)[0]
    ref_bytes = reference_device_bytes(full, pspecs, TS.param_shapes(full), sizes_ab)
    held = [r["b"]["held_bytes"] for r in ranks]
    require(all(h["params"] == ref_bytes for h in held),
            f"step 18 b: the ranks hold {[h['params'] for h in held]} bytes of parameters, the "
            f"reference's device {ref_bytes}")
    tokens_b = TRAIN_SHARDED_TOKENS[0] * TRAIN_SHARDED_TOKENS[1]
    step_ms = statistics.median(max(r["b"]["modes"]["xla"]["ms"][i] for r in ranks)
                                for i in range(TRAIN_SHARDED_STEPS))
    runs.append({"run": "train_sharded b", "model": f"{full.name} whole", "mesh": list(mesh_ab),
                 "rules": "fsdp", "tokens": list(TRAIN_SHARDED_TOKENS),
                 "metrics": got["metrics"], "oracle_metrics": want_b,
                 "rel": [{k: rel(m[k], w[k]) for k in ("loss", "grad_norm")}
                         for m, w in zip(got["metrics"], want_b)],
                 "ms": [r["b"]["modes"]["xla"]["ms"] for r in ranks], "step_ms": step_ms,
                 "tokens_per_s": tokens_b / step_ms * 1e3, "oracle_ms": orc_b["ms"],
                 "oracle_tokens_per_s": tokens_b / orc_b["ms"][-1] * 1e3,
                 "step_parts_rank0": got["step_parts"],
                 "carrier_bytes_a_step": got["carrier_bytes"],
                 "carrier_copies_a_step": got["carrier_copies"],
                 "held_bytes_a_rank": held, "reference_device_param_bytes": ref_bytes,
                 "peak_gib_a_rank": [r["b"]["modes"]["xla"]["peak_gib"] for r in ranks],
                 "oracle_peak_gib": orc_b["peak_gib"], "free_gib_before_ranks": free_ab,
                 "oracles_s": oracles_s, "ranks_s": ranks_s,
                 "rank_init_s": max(r["b"]["init_s"] for r in ranks),
                 "launches": got["launches"], "parts_a_b_s": time.perf_counter() - t_part})
    emit(runs[-1])

    # d) the tensor-parallel prefill with K4, in b's ranks, against each rank's whole leaves
    d = [r["d"] for r in ranks]
    k4_d = {"launches": full.n_layers, "bodies": {"mma_sync": 0, "wgmma": full.n_layers}}
    # held by the model path's bf16 bound (step 8's, PERF.md §2): K4's own bound is one
    # attention call's, and the row blocks' bf16 partial sums round where the whole leaves'
    # products do not. Read against: in float32 the same two forwards within K4's float32
    # bound, and a planted wrong KV head outside the bf16 one
    for r, rec in enumerate(d):
        require(rec["k4"] == k4_d, f"step 18 d, rank {r}: K4 launched {rec['k4']}, "
                                   f"expected {k4_d}")
        vs, bad, w32 = rec["vs_whole"], rec["planted_wrong_kv"], rec["witness_f32"]
        require(rec["finite"] and vs["max_abs_err"] <= LOGIT_MAX_ABS
                and vs["rel_rms"] <= LOGIT_REL_RMS,
                f"step 18 d, rank {r}: the TP prefill off the whole leaves' forward: {vs}")
        require(bad["max_abs_err"] > LOGIT_MAX_ABS or bad["rel_rms"] > LOGIT_REL_RMS,
                f"step 18 d, rank {r}: the planted wrong KV head passes the bound: {bad}")
        require(w32["rel_rms"] <= FLASH_TOL["torch.float32"],
                f"step 18 d, rank {r}: in float32 the TP prefill off the whole leaves': {w32}")
    tp_ms = statistics.median(max(rec["ms"][i] for rec in d) for i in range(PREFILL_TP_REPS))
    whole_ms = statistics.median(max(rec["whole_ms"][i] for rec in d)
                                 for i in range(PREFILL_TP_REPS))
    runs.append({"run": "prefill_tp d", "model": f"{full.name} whole, bf16",
                 "mesh": list(mesh_ab), "tokens": list(TRAIN_SHARDED_TOKENS),
                 "rows_a_rank": d[0]["rows"], "logits_a_rank": d[0]["logits"],
                 "k4_per_rank": k4_d, "k4_shape": [d[0]["rows"][0], d[0]["rows"][1],
                                                   full.n_heads // mesh_ab[1],
                                                   full.n_kv_heads // mesh_ab[1], full.head_dim],
                 "ms": tp_ms, "tokens_per_s": tokens_b / tp_ms * 1e3,
                 "whole_leaves_ms": whole_ms, "whole_leaves_tokens_per_s": tokens_b / whole_ms * 1e3,
                 "vs_whole": {"max_abs_err": max(rec["vs_whole"]["max_abs_err"] for rec in d),
                              "rel_rms": max(rec["vs_whole"]["rel_rms"] for rec in d),
                              "bound": [LOGIT_MAX_ABS, LOGIT_REL_RMS],
                              "within_k4_bound": all(rec["vs_whole"]["ok"] for rec in d)},
                 "planted_wrong_kv_vs_whole": {
                     key: min(rec["planted_wrong_kv"][key] for rec in d)
                     for key in ("max_abs_err", "rel_rms")},
                 "witness_f32_vs_whole": {key: max(rec["witness_f32"][key] for rec in d)
                                          for key in ("max_abs_err", "rel_rms")},
                 "witness_f32_bound": FLASH_TOL["torch.float32"],
                 "bf16_control_whole_vs_f32": {key: max(rec["bf16_control"][key] for rec in d)
                                               for key in ("max_abs_err", "rel_rms")},
                 "peak_gib_a_rank": max(rec["peak_gib"] for rec in d)})
    emit(runs[-1])
    k4_launches = len(d) * full.n_layers

    # e) the tensor-parallel decode over the sequence-sharded cache, in b's ranks,
    # against each rank's one-process decode on whole leaves and the whole cache
    e = [r["e"] for r in ranks]
    for r, rec in enumerate(e):
        vs, blk = rec["vs_whole"], rec["block"]
        require(rec["finite"] and vs["max_abs_err"] <= LOGIT_MAX_ABS
                and vs["rel_rms"] <= LOGIT_REL_RMS,
                f"step 18 e, rank {r}: the TP decode's logits off the whole leaves': {vs}")
        require(blk["untouched_same_bits"] and blk["written_max_abs"] <= LOGIT_MAX_ABS,
                f"step 18 e, rank {r}: its cache block off the whole cache's: {blk}")
        require(rec["in_place"] and rec["carrier_a_step"]["bytes"] < rec["block_bytes"],
                f"step 18 e, rank {r}: a cache block moved (in place {rec['in_place']}, "
                f"{rec['carrier_a_step']} on the carrier a step, the block "
                f"{rec['block_bytes']} bytes)")
    for name in ("no_rescale", "every_rank_writes"):
        bad = [rec[f"planted_{name}"] for rec in e]
        caught = [b["max_abs_err"] > LOGIT_MAX_ABS or b["rel_rms"] > LOGIT_REL_RMS
                  or not b["block"]["untouched_same_bits"]
                  or b["block"]["written_max_abs"] > LOGIT_MAX_ABS for b in bad]
        require(any(caught), f"step 18 e: the planted {name} passes the bound: {bad}")
    step_ms = [max(rec["ms"][i] for rec in e) for i in range(DECODE_STEPS)]
    whole_step_ms = [max(rec["whole_ms"][i] for rec in e) for i in range(DECODE_STEPS)]
    rows_e = sum(rec["rows"] for rec in e) // mesh_ab[1]
    runs.append({"run": "decode_tp e", "model": f"{full.name} whole, bf16",
                 "mesh": list(mesh_ab), "rows": DECODE_ROWS, "rows_a_rank": e[0]["rows"],
                 "cache_positions": DECODE_MAX_SEQ,
                 "positions_a_rank": DECODE_MAX_SEQ // mesh_ab[1],
                 "positions": [DECODE_START, DECODE_START + DECODE_STEPS - 1],
                 "fill_std": DECODE_FILL_STD, "steps": DECODE_STEPS,
                 "ms_a_step": statistics.median(step_ms[1:]), "first_step_ms": step_ms[0],
                 "tokens_per_s": rows_e / statistics.median(step_ms[1:]) * 1e3,
                 "whole_ms_a_step": statistics.median(whole_step_ms[1:]),
                 "whole_tokens_per_s": rows_e / statistics.median(whole_step_ms[1:]) * 1e3,
                 "carrier_a_step_a_rank": e[0]["carrier_a_step"],
                 "block_bytes_a_rank": e[0]["block_bytes"],
                 "peak_gib_a_rank": max(rec["peak_gib"] for rec in e),
                 "vs_whole": {key: max(rec["vs_whole"][key] for rec in e)
                              for key in ("max_abs_err", "rel_rms")}
                 | {"bound": [LOGIT_MAX_ABS, LOGIT_REL_RMS],
                    "within_k4_bound": all(rec["vs_whole"]["ok"] for rec in e)},
                 "bf16_control_whole_vs_f32": {key: max(rec["bf16_control"][key] for rec in e)
                                               for key in ("max_abs_err", "rel_rms")},
                 "bf16_control_steps": DECODE_CONTROL_STEPS,
                 "job_s": max(rec["job_s"] for rec in e),
                 "block_vs_whole_cache": [rec["block"] for rec in e],
                 "planted_no_rescale": [rec["planted_no_rescale"] for rec in e],
                 "planted_every_rank_writes": [rec["planted_every_rank_writes"] for rec in e]})
    emit(runs[-1])

    # f, g) the recurrent mixers under tensor parallelism, in b's ranks
    recurrent_runs, f_k4 = recurrent_tp_runs(ranks, {j["part"]: j["cfg"] for j in recurrent},
                                             mesh_ab)
    runs.extend(recurrent_runs)
    del want_state, want_compress
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()

    # c) Mixtral-8x7B at its published widths, 1 layer, EP on (2, 4) with ZeRO-1
    t_part = time.perf_counter()
    mfull = get_config("mixtral-8x7b")
    mcfg = dataclasses.replace(mfull, n_layers=MIXTRAL_TRAIN_LAYERS)
    tokens = torch.randint(1, mcfg.vocab, MIXTRAL_TRAIN_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED)).cpu().numpy()
    data = {"tokens": tokens, "labels": tokens}
    n_d, n_m = MIXTRAL_TRAIN_MESH
    watch = [f"stack/0/ffn/{k}" for k in ("router", "w_in", "w_gate", "w_out")]
    params, state, want, orc = oracle(
        mcfg, opt_cfg, data, 1,
        moe=lambda p, x, c: MOE.moe_apply_ep_plain(p, x, c, n_d, n_m))
    n_params = sum(t.numel() for t in _tensors(params))
    want_m = {name: O.get(state["mu"], tuple(int(k) if k.isdigit() else k
                                             for k in name.split("/")))["m"] for name in watch}
    del params, state
    gc.collect()
    ranks, free_c, ranks_s = run_ranks([job("c", mcfg, opt_cfg, {"zero1": True}, data,
                                            MIXTRAL_TRAIN_MODES, 1, watch, want_m)],
                                       MIXTRAL_TRAIN_MESH)
    del want_m
    torch.cuda.ipc_collect()
    ranks = [r["c"] for r in ranks]
    first = MIXTRAL_TRAIN_MODES[0]
    got = ranks[0]["modes"][first]["metrics"][0]
    held = [mode for mode in MIXTRAL_TRAIN_MODES if mode not in MIXTRAL_SAME_BITS]
    # the routes of the first MoE layer's first forward, shard r on rank r (data-major): the
    # ranks' oracle's are the step's bit for bit; the one-process step's, whose dense layers
    # add their partial sums in another order, may differ where a token's experts near-tie
    step_idx = torch.cat([r["modes"][first]["routes"][0] for r in ranks])
    step_keep = torch.cat([r["modes"][first]["routes"][1] for r in ranks])
    for rk, r in enumerate(ranks):
        require(all(torch.equal(a, b)
                    for a, b in zip(r["oracle_routes"], r["modes"][first]["routes"])),
                f"step 18 c, rank {rk}: the ranks' oracle routes otherwise than the step")
    want_idx, want_keep = orc["routes"]
    route_flips = {"tokens": int((step_idx != want_idx).any(dim=1).sum()),
                   "tokens_as_sets": int((step_idx.sort(dim=1).values
                                          != want_idx.sort(dim=1).values).any(dim=1).sum()),
                   "kept_entries": int((step_keep != want_keep).sum()),
                   "of_tokens": int(step_idx.shape[0])}
    m_rel, m_rel_ranks, m_zero, metrics_rel = {}, {}, {}, {}
    for mode in held:  # against the oracles; the same-bits modes are held to the first's below
        m = ranks[0]["modes"][mode]["metrics"][0]
        metrics_rel[mode] = {key: rel(m[key], want[0][key])
                             for key in ("loss", "moe_aux", "grad_norm")}
        for key, err in metrics_rel[mode].items():
            require(err <= SHARDED_REL,
                    f"step 18 c, {mode}: {key} {m[key]} against the one-process {want[0][key]}")
        m_rel[mode], m_rel_ranks[mode], m_zero[mode] = {}, {}, {}
        for name in watch:
            parts = [r["modes"][mode]["m_vs_oracle"][name] for r in ranks
                     if name in r["modes"][mode]["m_vs_oracle"]]
            total = {k: sum(p.get(k, 0) for p in parts) for k in parts[0]}
            err = (total["d2"] / max(total["w2"], 1e-30)) ** 0.5
            err_ranks = (total["d2_ranks"] / max(total["r2"], 1e-30)) ** 0.5
            m_rel[mode][name], m_rel_ranks[mode][name] = err, err_ranks
            m_zero[mode][name] = {k: v for k, v in total.items()
                                  if k not in ("d2", "w2", "d2_ranks", "r2")}
            require(err <= SHARDED_M_REL and err_ranks <= RANKS_ORACLE_M_REL
                    and total["zeros_above"] == 0,
                    f"step 18 c, {mode}: the first moment of {name}: {err:.3g} off the "
                    f"one-process step's, {err_ranks:.3g} off the ranks' oracle's; zero at "
                    f"{total['zeros_above']} of the entries where the ranks' oracle's is above "
                    f"the noise, at {total['zeros_of_nonzero']} of its {total['nonzero']} nonzero "
                    "ones")
            if "planted_zeros_above" in total:  # one entry zeroed a rank: the check counts each
                require(total["planted_zeros_above"] == len(parts),
                        f"step 18 c, {mode}: {len(parts)} planted zeros of {name} counted "
                        f"{total['planted_zeros_above']} times")
    for mode in MIXTRAL_SAME_BITS:
        require(all(r["modes"][mode]["same_bits_as_first"] for r in ranks),
                f"step 18 c: {mode} does not give {first}'s bits")
        require(ranks[0]["modes"][mode]["metrics"] == ranks[0]["modes"][first]["metrics"],
                f"step 18 c: {mode}'s metrics differ from {first}'s")
    from_first = {mode: {"worst_leaf_rel": max(r["modes"][mode]["worst_leaf_rel_to_first"]
                                               for r in ranks),
                         "metrics_rel": {key: rel(ranks[0]["modes"][mode]["metrics"][0][key],
                                                  got[key])
                                         for key in ("loss", "moe_aux", "grad_norm")}}
                  for mode in MIXTRAL_TRAIN_MODES[1:]}
    print(f"train_sharded c: each mode against {first}: {from_first}", flush=True)
    tokens_c = MIXTRAL_TRAIN_TOKENS[0] * MIXTRAL_TRAIN_TOKENS[1]
    by_mode = {}
    for mode in MIXTRAL_TRAIN_MODES:
        ms = max(r["modes"][mode]["ms"][0] for r in ranks)
        parts = ranks[0]["modes"][mode]["moe_parts"]
        by_mode[mode] = {"ms": ms, "tokens_per_s": tokens_c / ms * 1e3,
                         "forward_exchange_ms": parts["exchange_ms"],
                         "forward_gather_ms": parts["gather_ms"],
                         "forward_exchange_share": parts["exchange_ms"] / ms,
                         "step_parts_rank0": ranks[0]["modes"][mode]["step_parts"],
                         "carrier_bytes": ranks[0]["modes"][mode]["carrier_bytes"][0],
                         "carrier_copies": ranks[0]["modes"][mode]["carrier_copies"][0],
                         "peak_gib_a_rank": max(r["modes"][mode]["peak_gib"] for r in ranks)}
    runs.append({"run": "train_sharded c", "model": f"{mcfg.name}, {mcfg.n_layers} of "
                 f"{mfull.n_layers} layers", "params": n_params, "mesh": list(MIXTRAL_TRAIN_MESH),
                 "rules": "zero1, EP", "tokens": list(MIXTRAL_TRAIN_TOKENS), "metrics": got,
                 "oracle_metrics": want[0], "metrics_rel": metrics_rel, "m_rel": m_rel,
                 "m_rel_vs_ranks_oracle": m_rel_ranks, "route_flips_vs_one_process": route_flips,
                 "from_first": from_first,
                 # zeros of the step's m: where the ranks' oracle's is above the noise, of its
                 # nonzero ones, in all; the planted zero; against the one-process step's
                 "m_zeros": m_zero,
                 "modes": by_mode, "oracle_ms": orc["ms"], "oracle_peak_gib": orc["peak_gib"],
                 "free_gib_before_ranks": free_c, "ranks_s": ranks_s,
                 "rank_init_s": max(r["init_s"] for r in ranks),
                 "held_bytes_a_rank": [r["held_bytes"] for r in ranks],
                 "launches": ranks[0]["modes"][first]["launches"],
                 "part_s": time.perf_counter() - t_part})
    emit(runs[-1])
    torch.cuda.empty_cache()
    print(f"train_sharded: phase_s {time.perf_counter() - t_phase:.1f}", flush=True)
    return runs, {"d": k4_launches, "f": f_k4}


def serve_with_reuse(kit, cfg, params, dev, what):
    """The engine on ``params``: 4 slots, a 128-token cache and 6 requests
    of 3–8 prompt tokens and 12 new tokens each, so later requests sit in
    slots earlier ones left. Holds each request seated in a used slot to
    the tokens a fresh engine gives it alone (the engine resets a seated
    slot's recurrent states). Returns (the run's record, request 0's
    prompt, the engine's logits at its last prompt token)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import Engine, Request

    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=rng.integers(3, 9))
                    .astype(np.int32), max_new_tokens=SERVE_NEW) for i in range(SERVE_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    eng = kit.Recording(cfg, params, batch_slots=4, max_seq=128, device=dev)
    eng.trace = []
    pending, used, reused = list(reqs), set(), []
    t0 = time.perf_counter()
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            slot = eng.free_slots[0]
            if slot in used:
                reused.append(pending[0])
            used.add(slot)
            eng.admit(pending.pop(0))
        eng.step()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    rec = {"run": "serve (smoke)", "model": cfg.name, "layers": cfg.n_layers, "slots": 4,
           "max_seq": 128, "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
           "steps": eng.steps_run, "tokens": eng.tokens_out, "s": serve_s,
           "smoke_tokens_per_s": eng.tokens_out / serve_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "reused_slot_requests": [r.rid for r in reused]}
    require(all(r.done and len(r.out) == SERVE_NEW for r in reqs)
            and eng.tokens_out == SERVE_REQUESTS * SERVE_NEW,
            f"{what} requests not answered: {[(r.rid, r.done, len(r.out)) for r in reqs]}")
    require(bool(reused), f"{what}: no request sat in a used slot")
    p0 = reqs[0].prompt  # request 0 sits in slot 0
    step_logits = torch.from_numpy(next(out[0] for pos, out in eng.trace
                                        if pos[0] == len(p0) - 1)).to(dev)
    del eng
    fresh = {}
    for req in reused:
        solo = Engine(cfg, params, batch_slots=4, max_seq=128, device=dev)
        again = Request(rid=req.rid, prompt=req.prompt, max_new_tokens=SERVE_NEW)
        solo.admit(again)
        solo.run_to_completion()
        fresh[req.rid] = again.out
    rec["reused_equal_fresh"] = {r.rid: fresh[r.rid] == r.out for r in reused}
    require(all(rec["reused_equal_fresh"].values()),
            f"{what}: a request in a reused slot got other tokens than a fresh engine gives it: "
            f"{[(r.rid, r.out, fresh[r.rid]) for r in reused]}")
    return rec, p0, step_logits


def jamba_phase(dev, kit):
    """Step 11b: Jamba-1.5-Large at its published widths, one period of 8
    layers with one MoE FFN. ``kit`` as for ``deepseek_phase``. Returns
    (K4's record at Jamba's shape, the runs' records, K4's launches in one
    forward)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models import mamba as MB
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    t_phase = time.perf_counter()
    gib = lambda n: n / 2**30
    print(f"jamba: {gib(torch.cuda.memory_allocated()):.2f} GiB allocated before the phase",
          flush=True)
    full = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, n_layers=8, moe=dataclasses.replace(full.moe, layer_period=8))
    B, S = JAMBA_TOKENS
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # a) K4 at the attention layer's shape against its plain version, timed
    q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    zero_counts((flash_attention,))
    got = flash_attention(q, k, v, causal=True)
    bodies = dict(flash_attention.body_launches)
    want = flash_attention_plain(q, k, v, causal=True)
    tol = FLASH_TOL["torch.bfloat16"]
    ok, err, rel = attention_close(got, want, tol)
    require(ok and bodies == {"mma_sync": 0, "wgmma": 1},
            f"flash_attention at Jamba's shape off by max {err}, relative rms {rel}, bodies {bodies}")
    del got, want
    pairs = S * (S + 1) // 2 * B
    b_ms, b_by = kit.bound(2 * q.numel() * 2 + 2 * k.numel() * 2, pairs * H * 4 * D,
                           BF16_FLOP_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    k4 = {"q": list(q.shape), "kv": list(k.shape), "causal": True, "window": None, "tol": tol,
          "max_abs_err": err, "rel_rms": rel, "bodies": bodies, "key_pairs": pairs,
          "ms": kit.time_ms(lambda: flash_attention(q, k, v, causal=True), reps=10),
          "plain_ms": kit.time_ms(lambda: flash_attention_plain(q, k, v, causal=True), reps=3,
                                  warmup=1),
          "library_ms": kit.time_ms(lambda: F.scaled_dot_product_attention(
              qt, kt, vt, is_causal=True, enable_gqa=True), reps=10),
          "library": "SDPA, is_causal, enable_gqa", "bound_ms": b_ms, "bound_by": b_by}
    emit({"check": "flash_attention timing, Jamba-1.5-Large shape", **k4})
    del q, k, v, qt, kt, vt
    kit.release()

    # b) one Mamba layer at full width: the chunked scan against the step-by-step one
    layer = MB.mamba_init(gen, cfg, torch.bfloat16, dev)
    x = torch.randn(*MAMBA_CHECK_TOKENS, cfg.d_model, generator=gen, device=dev).bfloat16()
    xc, _, dt, Bm, Cm, A = MB.scan_inputs(layer, x, cfg)
    got = MB.selective_scan(dt, xc, Bm, Cm, A)
    want = MB.selective_scan_plain(dt, xc, Bm, Cm, A)
    diff = (got - want).abs()
    scan = {"check": "mamba chunked scan vs step-by-step scan", "tokens": list(MAMBA_CHECK_TOKENS),
            "d_inner": xc.shape[-1], "d_state": A.shape[1], "chunk": MB.CHUNK,
            "block_tokens": MB.BLOCK_TOKENS, "rtol": MAMBA_SCAN_TOL, "atol": MAMBA_SCAN_TOL,
            "max_abs_err": float(diff.max()), "max_abs_want": float(want.abs().max()),
            "rel_rms": float((got - want).norm() / want.norm()),
            "ms": kit.time_ms(lambda: MB.selective_scan(dt, xc, Bm, Cm, A), reps=5),
            "plain_ms": kit.time_ms(lambda: MB.selective_scan_plain(dt, xc, Bm, Cm, A), reps=2,
                                    warmup=1)}
    emit(scan)
    require(bool(torch.isfinite(got).all())
            and bool((diff <= MAMBA_SCAN_TOL + MAMBA_SCAN_TOL * want.abs()).all()),
            f"the chunked Mamba scan is off the step-by-step scan: {scan}")
    del layer, x, xc, dt, Bm, Cm, A, got, want, diff
    kit.release()

    # c) the weights, made on the card from the seed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    weight_gb = _nbytes(params) / 1e9
    init_peak = gib(torch.cuda.max_memory_allocated())
    kinds = cfg.layer_kinds()
    print(f"jamba-1.5-large-398b: depth cut from {full.n_layers} to {cfg.n_layers} layers, one "
          f"period ({', '.join('+'.join(kind) for kind in kinds)}); the published period, MoE "
          f"every 2nd layer, takes {dataclasses.replace(full, n_layers=8).param_count() * 2 / 1e9:.1f}"
          f" GB of bf16 weights; all {full.n_layers} layers {full.param_count() * 2 / 1e9:.1f} GB; "
          f"these {n_params / 1e9:.2f} B parameters {weight_gb:.1f} GB, made on the card in "
          f"{init_s:.1f} s, init peak {init_peak:.2f} GiB; every width is the published one",
          flush=True)

    # d) forward_train and loss_fn with K4, against the naive passes
    tokens = torch.randint(1, cfg.vocab, JAMBA_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
    batch = {"tokens": tokens, "labels": tokens}
    n_attn = sum(mixer == "attn" for mixer, _ in kinds) * cfg.n_groups
    n_moe = sum(ffn == "moe" for _, ffn in kinds) * cfg.n_groups
    only_k4 = {name: 0 for name in kit.names} | {"flash_attention": n_attn}
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as k_routes:
        (logits, aux, _), counts = kit.model_run(M.forward_train, params, batch, cfg, True)
    peaks = {"forward": gib(torch.cuda.max_memory_allocated())}
    bodies = dict(flash_attention.body_launches)
    require(counts == only_k4, f"jamba forward_train launched {counts}, expected {only_k4}")
    require(bodies == {"mma_sync": 0, "wgmma": n_attn}, f"jamba forward bodies {bodies}")
    require(len(k_routes) == n_moe and bool(torch.isfinite(aux)),
            f"{len(k_routes)} MoE layers routed, aux {float(aux)}")
    last = logits[:, -1].float()
    del logits
    kit.release()
    (loss, metrics), counts = kit.model_run(M.loss_fn, params, batch, cfg, True)
    require(counts == only_k4, f"jamba loss_fn launched {counts}, expected {only_k4}")
    require(set(metrics) == {"ce", "moe_aux", "loss"}
            and all(bool(torch.isfinite(x)) for x in metrics.values()), f"metrics {metrics}")
    kit.release()
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as n_routes:
        (naive, _, _), counts = kit.model_run(M.forward_train, params, batch, cfg, False)
    peaks["naive forward"] = gib(torch.cuda.max_memory_allocated())
    require(counts["flash_attention"] == 0, "the naive jamba forward launched flash_attention")
    naive_last = naive[:, -1].float()
    del naive
    kit.release()
    naive_metrics = M.loss_fn(params, batch, cfg, False)[1]
    kit.release()
    err, rel = kit.logits_close(last, naive_last, "jamba: kernel vs naive forward")
    metric_rel = {key: abs(float(metrics[key]) - float(naive_metrics[key]))
                  / abs(float(naive_metrics[key])) for key in ("ce", "loss")}
    require(all(r <= LOSS_REL for r in metric_rel.values()),
            f"jamba ce, loss against the naive pass: {metrics} vs {naive_metrics}")
    flips = route_flips(k_routes, n_routes, cfg.moe.top_k)
    # How many tokens sit on an exact tie of bf16 router logits at ranks k, k + 1 or
    # within the top k + 1 (any noise reorders those), and how many of the tokens whose
    # route differs sit on one.
    (_, _, lg), (k_ids, _, _), (n_ids, _, _) = k_routes[0], k_routes[0], n_routes[0]
    top = lg.float().sort(-1, descending=True)[0][:, :cfg.moe.top_k + 1]
    tied = (top.diff(dim=-1) == 0).any(-1)
    differs = (k_ids != n_ids).any(-1)
    flips["exact_tie_share"] = {
        "at rank k, k + 1": float((top[:, -2] == top[:, -1]).float().mean()),
        "within the top k + 1": float(tied.float().mean()),
        "of the differing routes": float(tied[differs].float().mean()) if differs.any() else None}
    kept = [keep for _, keep, _ in k_routes]
    drop_share = sum(int((~keep).sum()) for keep in kept) / sum(keep.numel() for keep in kept)
    del k_routes, n_routes, kept, last, naive_last, lg, top, tied, differs
    kit.release()
    fwd_ms = kit.time_ms(lambda: M.forward_train(params, batch, cfg, True), reps=3, warmup=1)
    prof = kit.device_profile(lambda: M.forward_train(params, batch, cfg, True), fwd_ms,
                              labels=MODEL_LABELS, top_ops=12)
    lab, k4_ms = prof["device_ms_by_label"], prof["device_ms_by_group"].get("flash_attention", 0.0)
    if lab["mamba.scan"] and lab["moe.experts"]:  # kernels were traced back to their torch ops
        parts = {"Mamba scan (mamba.scan)": lab["mamba.scan"],
                 "Mamba projections, conv and dt (mixer.mamba without the scan)":
                     lab["mixer.mamba"],
                 "flash_attention (K4)": k4_ms,
                 "dense FFN (ffn.mlp)": lab["ffn.mlp"],
                 "expert products (moe.experts)": lab["moe.experts"],
                 "dispatch and combine (router included)": lab["moe.dispatch"]
                 + lab["moe.combine"]}
        parts["the rest (attention projections, norms, embedding, unembedding)"] = \
            prof["device_ms"] - sum(parts.values())
        prof["device_ms_by_part"] = parts
    else:
        prof["device_ms_by_part"] = "not measured: the profiler tied no kernel to a torch op"
    runs = [{"run": "prefill", "model": cfg.name,
             "layers": f"{cfg.n_layers} of {full.n_layers} (1 attn, 7 mamba; 6 mlp, 1 moe)",
             "tokens": list(JAMBA_TOKENS), "params": n_params, "weight_gb": weight_gb,
             "init_s": init_s, "init_peak_gib": init_peak,
             "launches": {"forward_train": n_attn, "loss_fn": n_attn},
             "ms": fwd_ms, "tokens_per_s": B * S / fwd_ms * 1e3, "peak_gib": peaks,
             "metrics": {key: float(val) for key, val in metrics.items()},
             "naive_metrics": {key: float(val) for key, val in naive_metrics.items()},
             "metric_rel_vs_naive": metric_rel,
             "last_logits_vs_naive": {"max_abs_err": err, "rel_rms": rel},
             "capacity": MOE.capacity(cfg, B * S), "dropped_share": drop_share,
             "route_flips": flips, "profile": prof}]
    emit(runs[-1])
    # Step 12's near-tie criterion holds as it is. Its 3 % cap on the share is Mixtral's,
    # an average over 8 MoE layers of which the first see little noise; Jamba's one MoE
    # layer is its last, after 7 layers of the two passes' bf16 noise, and picks 2 of 16
    # experts, so more of its tokens sit at a near-tie: the cap is printed here, not
    # required (PERF.md §6).
    require((flips["first_gap_max"] or 0) < FIRST_FLIP_GAP_MAX,
            f"jamba: a token's route first differs between the kernel and naive passes away "
            f"from a near-tie: {flips}")
    print(f"jamba: {flips['share']:.4%} of tokens' routes differ in order between the kernel and "
          f"naive passes, {flips['set_share']:.4%} as sets (step 12's cap for Mixtral: "
          f"{ROUTE_FLIP_MAX:.0%}); exact bf16 router-logit ties: {flips['exact_tie_share']}",
          flush=True)
    del loss, metrics, naive_metrics, aux, batch, tokens
    kit.release()

    # e) the engine, slots reused; decode against prefill at request 0's last prompt token
    rec, p0, step_logits = serve_with_reuse(kit, cfg, params, dev, "jamba")
    prefill = M.forward_train(params, {"tokens": torch.from_numpy(p0).to(dev)[None]}, cfg, True)[0]
    err, rel = kit.logits_close(step_logits, prefill[0, -1], "jamba decode vs prefill logits")
    rec["decode_vs_prefill_logits"] = {"max_abs_err": err, "rel_rms": rel}
    runs.append(rec)
    emit(runs[-1])
    del prefill, step_logits
    del params
    kit.release()
    phase_s = time.perf_counter() - t_phase
    print(f"jamba: {gib(torch.cuda.memory_allocated()):.2f} GiB allocated after the phase; "
          f"phase_s {phase_s:.1f}", flush=True)
    runs[0]["phase_s"] = phase_s
    return k4, runs, n_attn


def xlstm_phase(dev, kit):
    """Step 11c: xLSTM-1.3B whole. ``kit`` as for ``deepseek_phase``.
    Returns the runs' records."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as CL
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as XL

    t_phase = time.perf_counter()
    gib = lambda n: n / 2**30
    cfg = get_config("xlstm-1.3b")
    B, S = XLSTM_TOKENS
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # a) one mLSTM layer at full width: the chunked form (float32, as the model runs it)
    # against the parallel form in float64; the float32 parallel form's own distance
    # from it printed beside
    layer = XL.mlstm_init(gen, cfg, torch.bfloat16, dev)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).bfloat16()
    dp = layer["w_if"].shape[0]
    heads = XL._mlstm_heads(layer, (x @ layer["w_up"]).chunk(2, dim=-1)[0], (0, cfg.n_heads),
                            (0, dp // cfg.n_heads), (0, dp), CL.TensorParallel.one_process())
    chunk = 256  # mlstm_train's
    got = XL.mlstm_chunked_inner(*heads, chunk)
    want = XL.mlstm_parallel_inner(*(h.double() for h in heads))
    f32 = XL.mlstm_parallel_inner(*heads)
    diff = (got.double() - want).abs()
    form = {"check": "mLSTM chunked form vs parallel form in float64",
            "tokens": list(XLSTM_TOKENS), "heads": cfg.n_heads, "head_dim": heads[0].shape[-1],
            "chunk": chunk, "rtol": MLSTM_FORM_TOL, "atol": MLSTM_FORM_TOL,
            "max_abs_err": float(diff.max()), "max_abs_want": float(want.abs().max()),
            "rel_rms": float(diff.norm() / want.norm()),
            "float32_parallel_max_abs_err": float((f32.double() - want).abs().max()),
            "ms": kit.time_ms(lambda: XL.mlstm_chunked_inner(*heads, chunk), reps=3, warmup=1),
            "parallel_ms": kit.time_ms(lambda: XL.mlstm_parallel_inner(*heads), reps=3, warmup=1)}
    emit(form)
    require(bool(torch.isfinite(got).all())
            and bool((diff <= MLSTM_FORM_TOL + MLSTM_FORM_TOL * want.abs()).all()),
            f"the chunked mLSTM is off the parallel form: {form}")
    del layer, x, heads, got, want, f32, diff
    kit.release()

    # b) the whole model, made on the card from the seed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    print(f"xlstm-1.3b: all {cfg.n_layers} blocks, {n_params / 1e9:.2f} B parameters, "
          f"{_nbytes(params) / 1e9:.2f} GB of bf16, made on the card in {init_s:.1f} s", flush=True)

    # c) forward_train and loss_fn: no kernel of the port on this path
    tokens = torch.randint(1, cfg.vocab, XLSTM_TOKENS, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
    batch = {"tokens": tokens, "labels": tokens}
    none = {name: 0 for name in kit.names}
    torch.cuda.reset_peak_memory_stats()
    (logits, aux, _), counts = kit.model_run(M.forward_train, params, batch, cfg, True)
    peaks = {"forward": gib(torch.cuda.max_memory_allocated())}
    require(counts == none, f"xlstm forward_train launched {counts}")
    require(logits.shape == (B, S, cfg.vocab) and bool(torch.isfinite(logits).all())
            and float(aux) == 0.0, "xlstm logits")
    del logits
    kit.release()
    torch.cuda.reset_peak_memory_stats()
    (loss, metrics), counts = kit.model_run(M.loss_fn, params, batch, cfg, True)
    peaks["loss_fn"] = gib(torch.cuda.max_memory_allocated())
    require(counts == none and bool(torch.isfinite(loss)), f"xlstm loss {float(loss)}, {counts}")
    kit.release()
    # one timed forward: two ran above
    fwd_ms = kit.time_ms(lambda: M.forward_train(params, batch, cfg, True), reps=1, warmup=0)
    # Where the time goes, block by block: a profile of the whole forward (over 300,000
    # launches) takes minutes to read, so each kind of block is timed alone on the
    # forward's first block's input (CUDA events) and profiled alone, the sLSTM on the
    # first XLSTM_PROFILE_STEPS positions (its loop does the same work at each position).
    kinds = T.layer_kinds(cfg)
    x = L.embed_apply(params["embed"], tokens).to(getattr(torch, cfg.compute_dtype))
    blocks = {}
    for kind, h in (("mlstm", x), ("slstm", x), ("slstm", x[:, :XLSTM_PROFILE_STEPS])):
        i = kinds.index((kind, "none"))
        run = lambda i=i, h=h, kind=kind: T.member_train(params["stack"][i], h, cfg, kind,
                                                          "none", None, None, True)
        ms = kit.time_ms(run, reps=2, warmup=1)
        rec = {"blocks": sum(k == (kind, "none") for k in kinds), "tokens": list(h.shape[:2]),
               "ms": ms}
        if kind == "mlstm" or h.shape[1] < S:
            rec["profile"] = kit.device_profile(run, ms, reps=1, top_ops=8)
        blocks[f"{kind} {h.shape[1]}"] = rec
    per_block = {kind: blocks[f"{kind} {S}"] for kind in ("mlstm", "slstm")}
    blocks["blocks_ms_of_the_forward"] = sum(rec["blocks"] * rec["ms"] for rec in per_block.values())
    del x
    runs = [{"run": "prefill", "model": cfg.name, "layers": cfg.n_layers,
             "tokens": list(XLSTM_TOKENS), "params": n_params, "init_s": init_s,
             "launches": counts, "ms": fwd_ms, "tokens_per_s": B * S / fwd_ms * 1e3,
             "peak_gib": peaks, "loss": float(loss), "by_block": blocks}]
    emit(runs[-1])
    del loss, metrics, batch, tokens
    kit.release()

    # d) the engine, slots reused. Decode against prefill at request 0's last prompt
    # token is held in float32 (the weights cast on the card): in bf16 the two forms
    # round apart through 48 blocks by as much as bf16 is off float32 (both printed).
    rec, p0, step_logits = serve_with_reuse(kit, cfg, params, dev, "xlstm")
    prompt = torch.from_numpy(p0).to(dev)
    prefill = M.forward_train(params, {"tokens": prompt[None]}, cfg, True)[0][0, -1].float()
    params = _cast(params, torch.float32)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    cache = M.init_cache(cfg32, 1, len(p0), dtype=torch.float32, device=dev)
    for i, tok in enumerate(prompt):
        logits, cache = M.decode_step(params, cache, {"token": tok[None]}, i, cfg32)
    want = M.forward_train(params, {"tokens": prompt[None]}, cfg32, True)[0][0, -1]
    diff = (logits[0] - want).abs()
    rel = lambda a, b: float((a - b).norm() / b.norm())
    rec["decode_vs_prefill_logits"] = {
        "float32": {"rtol": XLSTM_DECODE_TOL, "atol": XLSTM_DECODE_TOL,
                    "max_abs_err": float(diff.max()), "rel_rms": rel(logits[0], want)},
        "compute dtype (printed)": {"max_abs_err": float((step_logits.float() - prefill).abs().max()),
                           "rel_rms": rel(step_logits.float(), prefill),
                           "prefill_rel_rms_vs_float32": rel(prefill, want),
                           "decode_rel_rms_vs_float32": rel(step_logits.float(), want)}}
    runs.append(rec)
    emit(runs[-1])
    require(bool(torch.isfinite(logits).all())
            and bool((diff <= XLSTM_DECODE_TOL + XLSTM_DECODE_TOL * want.abs()).all()),
            f"xlstm decode vs prefill logits in float32: {rec['decode_vs_prefill_logits']}")
    del params, cache, logits, want, prefill, step_logits
    kit.release()
    phase_s = time.perf_counter() - t_phase
    print(f"xlstm: phase_s {phase_s:.1f}", flush=True)
    runs[0]["phase_s"] = phase_s
    return runs



@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` (or a dict's entry ``name``) set to ``value`` inside
    the block."""
    get, put = ((dict.__getitem__, dict.__setitem__) if isinstance(module, dict)
                else (getattr, setattr))
    old = get(module, name)
    put(module, name, value)
    try:
        yield
    finally:
        put(module, name, old)


def unwritten_save(ckpt_dir, step, tree, **kwargs) -> str:
    """``train.checkpoint.save`` in a run whose checkpoints nothing reads:
    writes nothing and returns the path it would have written."""
    return str(pathlib.Path(ckpt_dir) / f"step_{step:08d}")


@contextlib.contextmanager
def launcher_probe(launcher):
    """Runs of ``launch.train.main`` with each step's loss and wall ms
    (the step and the sync the launcher makes to read the loss) and each
    checkpoint's seconds and tree recorded: the launcher prints neither
    at full precision."""
    import torch

    rec = types.SimpleNamespace(losses=[], step_ms=[], saves=[])
    make_step, save = launcher.make_train_step, launcher.ckpt.save

    def make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(params, opt_state, batch):
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            rec.losses.append(float(out[2]["loss"]))
            rec.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def timed_save(ckpt_dir, step, tree, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, tree, **kwargs)
        rec.saves.append({"step": step, "s": time.perf_counter() - t0, "tree": tree,
                          "bytes": (pathlib.Path(path) / "arrays.npz").stat().st_size})
        return path

    with patched(launcher, "make_train_step", make_train_step), \
            patched(launcher.ckpt, "save", timed_save):
        yield rec


def step_breakdown(fn, wall_ms):
    """One profiled call of a train step: device ms by part (the forward,
    the backward's recompute of the remat'd groups, the backward proper,
    the optimizer) and kernel group (matrix products, the rest), and the
    idle share of ``wall_ms`` (a call timed without the profiler). The
    parts come from the step's profiler ranges: ``train.forward`` and
    ``train.optimizer`` on the calling thread, ``stack.group`` there
    (forward) or on the autograd thread (recompute); kernels the autograd
    thread launches outside a group are the backward's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    labels = ("stack.group", "train.forward", "train.optimizer", "train.backward")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    main_thread = next(e.thread for e in events if e.name == "train.forward")
    parts: dict = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels \
                or e.name == "Command Buffer Full":
            continue
        up = e
        while up is not None and up.name not in labels:
            up = up.cpu_parent
        name = up.name if up is not None else "train.backward"
        part = {"stack.group": "forward" if e.thread == main_thread else "recompute",
                "train.forward": "forward", "train.optimizer": "optimizer",
                "train.backward": "backward"}[name]
        for k in e.kernels:
            group = ("matmul" if any(w in k.name.lower() for w in
                                     ("gemm", "gemv", "cutlass", "xmma", "nvjet")) else "other")
            by = parts.setdefault(part, {"matmul": 0.0, "other": 0.0, "kernels": 0})
            by[group] += k.duration / 1e3
            by["kernels"] += 1
    busy = sum(p["matmul"] + p["other"] for p in parts.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_ms_by_part": parts}


def train_phase(dev, kit, counters):
    """Step 11d: the training path. a) one train step of TinyLlama-1.1B at
    full width with its depth cut to 2 layers, float32, on the card and on
    the CPU from the same state; b) one Mamba layer at Jamba-1.5-Large's
    width, the scan's training form against autograd through the
    step-by-step recurrence; c) TinyLlama-1.1B whole, bf16, TRAIN_STEPS steps
    through ``launch.train.main`` with its final checkpoint written,
    restored and timed, and one step profiled; d) the launcher's restart
    and its microbatch, compression and straggler paths on the 2-layer
    model; e) the elastic drill on the 2-layer model with the §5 broadcast
    on ``cuda_fused``. ``counters`` are the kernel wrappers: the path
    launches none of them. Returns the runs' records."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.topology import D3
    from repro_torch.launch import train as launcher
    from repro_torch.models import mamba as MB
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import DataState, SyntheticLM
    from repro_torch.train.elastic import ElasticTrainer, FaultInjector, max_loss_divergence
    from repro_torch.train.optimizer import OptConfig, flatten, unflatten
    from repro_torch.train.train_step import (
        TrainSettings, init_train_state, make_microbatch_grads, make_train_step)

    t_phase = time.perf_counter()
    gib = lambda n: n / 2**30
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    print(f"train: {gib(torch.cuda.memory_allocated()):.2f} GiB allocated before the phase; "
          f"{shutil.disk_usage(work).free / 1e9:.1f} GB free on the checkout's disk", flush=True)
    arch = "tinyllama-1.1b"
    full = get_config(arch)
    small = dataclasses.replace(full, n_layers=TRAIN_SMALL_LAYERS)
    settings = TrainSettings(use_kernel=False, remat=True)
    runs = []

    def rel(got, want):
        return float((got.float() - want.float()).norm() / want.float().norm())

    def counts():
        return {c.__name__: c.launches for c in counters}

    # a) the step held in float32: the card against the CPU from the same state
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(small, param_dtype="float32", compute_dtype="float32")
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=10)
    params, opt_state = init_train_state(SEED, cfg32, opt_cfg, settings, device=dev)
    on_cpu = lambda tree: unflatten(tree, [t.cpu() for _, t in flatten(tree)])
    p_cpu, o_cpu = on_cpu(params), on_cpu(opt_state)
    data = SyntheticLM(DataState(seed=SEED, batch=TRAIN_CHECK_TOKENS[0],
                                 seq=TRAIN_CHECK_TOKENS[1], vocab=cfg32.vocab)).next_batch()
    b_cpu = {k: torch.from_numpy(v) for k, v in data.items()}
    b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
    zero_counts(counters)
    grads_fn = make_microbatch_grads(cfg32, settings)
    loss_d, _, g_d = grads_fn(params, b_dev)
    loss_c, _, g_c = grads_fn(p_cpu, b_cpu)
    g_c = dict(flatten(g_c))
    leaf_rel = {"/".join(map(str, path)): rel(g.cpu(), g_c[path]) for path, g in flatten(g_d)}
    step = make_train_step(cfg32, opt_cfg, settings)
    _, _, m_d = step(params, opt_state, b_dev)
    _, _, m_c = step(p_cpu, o_cpu, b_cpu)
    worst = max(leaf_rel, key=leaf_rel.get)
    rec = {"run": "train step, card against CPU", "model": cfg32.name, "layers": cfg32.n_layers,
           "dtype": "float32", "tokens": list(TRAIN_CHECK_TOKENS), "leaves": len(leaf_rel),
           "grad_rel_max": leaf_rel[worst], "grad_rel_max_leaf": worst,
           "grad_tol": TRAIN_GRAD_TOL, "loss_card": float(loss_d), "loss_cpu": float(loss_c),
           "loss_tol": TRAIN_LOSS_TOL,
           "step": {k: [float(m_d[k]), float(m_c[k])] for k in ("loss", "grad_norm", "lr")},
           "launches": counts(), "phase_s": time.perf_counter() - t0}
    runs.append(rec)
    emit(rec)
    require(leaf_rel[worst] <= TRAIN_GRAD_TOL
            and abs(float(loss_d) - float(loss_c)) <= TRAIN_LOSS_TOL * abs(float(loss_c))
            and all(abs(a - b) <= TRAIN_GRAD_TOL * abs(b) for a, b in rec["step"].values())
            and not any(rec["launches"].values()),
            f"the train step on the card is off the CPU's: {rec}")
    del params, opt_state, p_cpu, o_cpu, g_d, g_c, step, grads_fn
    kit.release()

    # b) the Mamba scan's training form at Jamba-1.5-Large's width
    t0 = time.perf_counter()
    jcfg = get_config("jamba-1.5-large-398b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer = MB.mamba_init(gen, jcfg, torch.float32, dev)
    x = torch.randn(*MAMBA_CHECK_TOKENS, jcfg.d_model, generator=gen, device=dev)
    gy = torch.randn(*MAMBA_CHECK_TOKENS, jcfg.d_model, generator=gen, device=dev)

    def layer_grads(scan):
        leaves = {k: v.detach().requires_grad_(True) for k, v in layer.items()}
        xx = x.detach().requires_grad_(True)
        xc, z, dt, Bm, Cm, A = MB.scan_inputs(leaves, xx, jcfg)
        out = MB._out(leaves, scan(dt, xc, Bm, Cm, A), xc, z, xx.dtype)
        return out.detach(), dict(zip(["x", *leaves], torch.autograd.grad(
            out, [xx, *leaves.values()], gy)))

    ins = [t.detach().requires_grad_(True) for t in MB.scan_inputs(layer, x, jcfg)]
    xc, _, dt, Bm, Cm, A = ins
    gs = torch.randn(xc.shape, generator=gen, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(MB.selective_scan(dt, xc, Bm, Cm, A), [dt, xc, Bm, Cm, A], gs)
    torch.cuda.synchronize()
    scan_peak = gib(torch.cuda.max_memory_allocated() - base)
    del ins, xc, dt, Bm, Cm, A, gs
    forms = {}
    for name, scan in (("training form", MB.selective_scan),
                       ("step by step", MB.selective_scan_plain)):
        layer_grads(scan)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out, grads = layer_grads(scan)
        torch.cuda.synchronize()
        forms[name] = (out, grads, (time.perf_counter() - t1) * 1e3,
                       gib(torch.cuda.max_memory_allocated() - base))
    (out, grads, ms, peak), (want, wgrads, plain_ms, plain_peak) = forms.values()
    grad_rel = {k: rel(grads[k], wgrads[k]) for k in grads}
    weight_gib = gib(sum(t.numel() * t.element_size() for t in layer.values()))
    rec = {"run": "mamba scan training form", "tokens": list(MAMBA_CHECK_TOKENS),
           "d_model": jcfg.d_model, "d_inner": jcfg.mamba.expand * jcfg.d_model,
           "d_state": jcfg.mamba.d_state, "dtype": "float32", "tol": MAMBA_GRAD_TOL,
           "train_block_tokens": MB.TRAIN_BLOCK_TOKENS,
           "out_rel": rel(out, want), "grad_rel": grad_rel,
           "layer_fwd_bwd_ms": ms, "plain_layer_fwd_bwd_ms": plain_ms, "weights_gib": weight_gib,
           "layer_peak_gib_above_weights": peak,
           "plain_layer_peak_gib_above_weights": plain_peak,
           "scan_fwd_bwd_peak_gib": scan_peak,
           "reference_three_f32_gib": 3 * gib(4 * x.shape[0] * x.shape[1]
                                              * jcfg.mamba.expand * jcfg.d_model
                                              * jcfg.mamba.d_state),
           "phase_s": time.perf_counter() - t0}
    runs.append(rec)
    emit(rec)
    require(rec["out_rel"] <= MAMBA_GRAD_TOL and max(grad_rel.values()) <= MAMBA_GRAD_TOL
            and scan_peak < rec["reference_three_f32_gib"],
            f"the Mamba scan's training form is off the step-by-step one, or holds more than "
            f"the reference's three (B, S, di, N) float32 tensors: {rec}")
    del layer, x, gy, forms, out, grads, want, wgrads
    kit.release()

    # c) TinyLlama-1.1B whole, bf16, through the launcher
    t0 = time.perf_counter()
    B, S = TRAIN_TOKENS
    ck = work / "tinyllama"
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    with launcher_probe(launcher) as probe:
        final = launcher.main(["--arch", arch, "--steps", str(TRAIN_STEPS),
                               "--batch", str(B), "--seq", str(S), "--lr", str(TRAIN_LR),
                               "--ckpt-dir", str(ck),
                               "--ckpt-every", str(TRAIN_STEPS), "--seed", str(SEED)])
    train_s = time.perf_counter() - t0
    peak = gib(torch.cuda.max_memory_allocated())
    launches = counts()
    (save,) = probe.saves
    t1 = time.perf_counter()
    ck_step, tree = ckpt.restore(ck)
    restore_s = time.perf_counter() - t1
    restored = dict(flatten({"params": tree["params"], "opt": tree["opt"]}))
    bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    same_bits = all(
        torch.equal(bits(torch.as_tensor(restored[path]).to(dev)), bits(t))
        for path, t in flatten({"params": save["tree"]["params"], "opt": save["tree"]["opt"]}))
    params, opt_state = save["tree"]["params"], save["tree"]["opt"]
    del save["tree"], tree, restored
    kit.release()
    n_params = sum(t.numel() for _, t in flatten(params))
    n_matmul = n_params - params["embed"]["table"].numel()  # the lookup does no products
    tokens = B * S
    attn_flops = 3 * 4 * B * full.n_heads * full.head_dim * (S * (S + 1) // 2) * full.n_layers
    model_flops = 6 * n_matmul * tokens + attn_flops
    step_ms = statistics.median(probe.step_ms[1:])
    data = SyntheticLM(DataState(seed=SEED + 1, batch=B, seq=S, vocab=full.vocab)).next_batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    step = make_train_step(full, OptConfig(lr=TRAIN_LR, warmup_steps=10,
                                           total_steps=TRAIN_STEPS), settings)
    wall = []
    for _ in range(2):  # the optimizer's outputs are dropped: the state stays the restored one
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step(params, opt_state, batch)
        float(out[2]["loss"])
        wall.append((time.perf_counter() - t1) * 1e3)
        del out
    profile = step_breakdown(lambda: step(params, opt_state, batch), wall[-1])
    rec = {"run": "train: tinyllama-1.1b whole", "layers": full.n_layers, "dtype": full.param_dtype,
           "tokens": [B, S], "params": n_params, "steps": TRAIN_STEPS,
           "losses": probe.losses, "final_loss": final, "step_ms": probe.step_ms,
           "ms_per_step_median_after_first": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "model_tflop_per_step": model_flops / 1e12,
           "model_tflop_per_s": model_flops / step_ms / 1e9,
           "model_flops_share_of_bf16_peak": model_flops / (step_ms / 1e3) / BF16_FLOP_PER_S,
           "peak_gib": peak, "launches": launches,
           "checkpoint": {"step": ck_step, "save_s": save["s"], "bytes": save["bytes"],
                          "restore_s_digest_checked": restore_s, "same_bits": same_bits},
           "profiled_step": profile, "train_s": train_s}
    runs.append(rec)
    emit(rec)
    require(all(np.isfinite(probe.losses)) and probe.losses[-1] < probe.losses[0]
            and same_bits and ck_step == TRAIN_STEPS and not any(launches.values()),
            f"tinyllama training: {rec}")
    del params, opt_state, batch, step
    shutil.rmtree(ck, ignore_errors=True)
    kit.release()

    # d) restart, and the microbatch, compression and straggler paths (2 layers, bf16)
    t0 = time.perf_counter()
    argv = ["--arch", arch, "--batch", str(B), "--seq", str(S), "--seed", str(SEED),
            "--lr", str(TRAIN_LR)]
    write = ckpt.save

    def resume_point_only(ckpt_dir, step, tree, **kwargs):  # for time: only step 5 is read
        return (write if step == 5 else unwritten_save)(ckpt_dir, step, tree, **kwargs)

    with patched(launcher, "get_config", lambda arch: small):
        with launcher_probe(launcher) as whole, \
                patched(launcher.ckpt, "save", resume_point_only):
            launcher.main(argv + ["--steps", "10", "--ckpt-every", "5",
                                  "--ckpt-dir", str(work / "restart")])
        with launcher_probe(launcher) as resumed, patched(launcher.ckpt, "save", unwritten_save):
            launcher.main(argv + ["--steps", "10", "--restore",
                                  "--ckpt-dir", str(work / "restart")])
        paths = {}
        for name, extra in (("microbatches 2", ["--microbatches", "2"]),
                            ("compress-grads", ["--compress-grads"]),
                            ("straggler-drop", ["--microbatches", "2", "--straggler-drop"])):
            with patched(launcher.ckpt, "save", unwritten_save):  # for time: nothing reads it
                paths[name] = launcher.main(argv + ["--steps", "1", *extra,
                                                    "--ckpt-dir", str(work / name.split()[0])])
    diffs = [abs(a - b) for a, b in zip(whole.losses[5:], resumed.losses)]
    rec = {"run": "train: restart and step paths, 2 layers", "layers": small.n_layers,
           "tokens": [B, S], "losses": whole.losses, "resumed_losses": resumed.losses,
           "resumed_max_abs_diff": max(diffs), "resumed_bit_equal": diffs == [0.0] * 5,
           "tol": RESTART_TOL, "path_losses": paths, "phase_s": time.perf_counter() - t0}
    runs.append(rec)
    emit(rec)
    require(len(resumed.losses) == 5 and max(diffs) <= RESTART_TOL
            and all(np.isfinite(list(paths.values()))), f"restart and step paths: {rec}")
    kit.release()

    # e) the elastic drill on the 2-layer model, the §5 broadcast on the card
    t0 = time.perf_counter()
    drill = dict(host=D3(2, 2), batch=B, seq=S, seed=SEED, ckpt_every=5, device=dev)
    drill_opt = OptConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=10)
    base = ElasticTrainer(small, drill_opt, settings, ckpt_dir=work / "base", **drill)
    with patched(ckpt, "save", unwritten_save):  # for time: the uninterrupted run never restores
        base_losses = base.run(10)
    el = ElasticTrainer(small, drill_opt, settings, ckpt_dir=work / "elastic",
                        injector=FaultInjector(ELASTIC_FAILURES), **drill)
    el_losses = el.run(10)
    events = [{"step": e.step, "failed": list(e.failed), "shape": list(e.shape),
               "survivors": list(e.survivors), "resumed_from": e.resumed_from,
               "broadcast_rounds": e.broadcast_rounds,
               "payload_gb": e.bytes_redistributed / 1e9, "wall_s": e.wall_s,
               "derivations": e.derivations} for e in el.events]
    div = max_loss_divergence(base_losses, el_losses)
    rec = {"run": "train: elastic drill, 2 layers", "host": "D3(2, 2)",
           "failures": ELASTIC_FAILURES, "backend": type(el.backend).__name__,
           "events": events,
           "max_loss_divergence": div, "tol": RESTART_TOL,
           "phase_s": time.perf_counter() - t0}
    runs.append(rec)
    emit(rec)
    require([e["shape"] for e in events] == [[1, 2], [2, 1]]
            and rec["backend"] == "CudaFusedBackend"
            and all(e["derivations"] == 0 for e in events) and div <= RESTART_TOL
            and len(el_losses) == 10, f"elastic drill: {rec}")
    del base, el
    shutil.rmtree(work, ignore_errors=True)
    kit.release()
    phase_s = time.perf_counter() - t_phase
    print(f"train: phase_s {phase_s:.1f}", flush=True)
    runs[0]["train_phase_s"] = phase_s
    return runs


def dryrun_cells(cells, out_dir) -> list:
    """Step 19's child process: each cell of ``cells`` through
    ``launch.dryrun.analyze_cell`` (the last one also ``--on-card`` when
    its flag says so), with its seconds. Returns the results."""
    from repro_torch.launch import dryrun as D

    out = []
    for arch, shape, multi_pod, variant, tag, on_card in cells:
        t0 = time.perf_counter()
        r = D.analyze_cell(arch, shape, multi_pod, force=True, variant=dict(variant) or None,
                           tag=tag, out_dir=out_dir, on_card=on_card)
        r["seconds"] = time.perf_counter() - t0
        out.append(r)
    return out


def dryrun_phase(dev) -> tuple[list, int, dict]:
    """Step 19: the dry run in a spawned process (the fake world is
    process-global), ``DRYRUN_CELLS`` on meta and ``DRYRUN_CARD_CELLS`` on
    the card too. Returns (the records, K4 launches of the on-card runs'
    counted traces, and those launches by body)."""
    import concurrent.futures
    import multiprocessing

    import torch

    t_phase = time.perf_counter()
    cells = [c[:5] + (False,) for c in DRYRUN_CELLS] + [c[:5] + (True,)
                                                        for c in DRYRUN_CARD_CELLS]
    want = [c[5] for c in DRYRUN_CELLS + DRYRUN_CARD_CELLS]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun-") as out_dir, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
        results = pool.submit(dryrun_cells, cells, out_dir).result()
    runs = []
    for (arch, shape, mp_, variant, tag, card), status, r in zip(cells, want, results):
        cell = f"{arch} {shape} {'pod2' if mp_ else 'pod1'}{' ' + tag if tag else ''}"
        require(r["status"] == status, f"dryrun {cell}: {r['status']} where {status} is "
                f"expected: {r.get('error', '')[:300]}")
        rec = {"run": f"dryrun {cell}{' on card' if card else ''}", "status": r["status"],
               "seconds": r["seconds"]}
        if status == "FAILED":
            require("does not split" in r["error"], f"dryrun {cell}: {r['error'][:300]}")
            rec["error"] = r["error"][:300]
        else:
            rec.update({k: r[k] for k in ("rank", "memory", "cost", "collectives", "roofline",
                                          "trace_seconds")})
            rf = r["roofline"]
            require(all(rf[k] >= 0 and rf[k] < float("inf")
                        for k in ("compute_s", "memory_s", "collective_s")),
                    f"dryrun {cell}: roofline {rf}")
        if card:
            c = r["on_card"]
            rec["on_card"] = c
            rec["ms_median"] = statistics.median(c["ms"])
            require(c["peak_rel_diff"] <= DRYRUN_PEAK_REL,
                    f"dryrun {cell}: the meta trace's peak {c['meta_peak_bytes']} is "
                    f"{c['peak_rel_diff']:.3g} off max_memory_allocated "
                    f"{c['max_memory_allocated']}")
            require(c["flops_equal"], f"dryrun {cell}: {c['flops']} FLOPs on the card, "
                    f"{r['cost']['flops']} on meta")
            # the decode attends over its cache in plain torch, as the JAX package does
            require((c["k4_launches"] > 0) == (shape != "decode_32k"),
                    f"dryrun {cell}: the card's run launched K4 {c['k4_launches']} times")
            require(sum(c["k4_bodies"].values()) == c["k4_launches"],
                    f"dryrun {cell}: K4's bodies {c['k4_bodies']} do not sum to its "
                    f"{c['k4_launches']} launches")
            print(f"dryrun {cell}: {rec['ms_median']:.1f} ms on the card beside compute_s "
                  f"{rf['compute_s'] * 1e3:.1f} ms and memory_s {rf['memory_s'] * 1e3:.1f} ms; "
                  f"max_memory_allocated {c['max_memory_allocated'] / 2**30:.3f} GiB beside the "
                  f"meta peak {c['meta_peak_bytes'] / 2**30:.3f} GiB", flush=True)
        emit(rec)
        runs.append(rec)
    if "all-to-all" not in results[1]["collectives"]:
        require(False, f"dryrun: DeepSeek's EP prefill has no all-to-all: {results[1]}")
    phase_s = time.perf_counter() - t_phase
    print(f"dryrun: phase_s {phase_s:.1f}", flush=True)
    if phase_s > DRYRUN_PHASE_S:
        print(f"dryrun: the phase took {phase_s:.0f} s, past its {DRYRUN_PHASE_S} s", flush=True)
    card_runs = [r["on_card"] for r in results[len(DRYRUN_CELLS):]]
    bodies = {body: sum(c["k4_bodies"][body] for c in card_runs)
              for body in card_runs[0]["k4_bodies"]}
    return runs, sum(c["k4_launches"] for c in card_runs), bodies


def serve_example_phase() -> dict:
    """Step 20: ``examples/torch/serve_moe.py`` in a process of its own,
    as a user runs it (its default device is the card): it must exit 0
    and serve every request its tokens. Returns its record."""
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(root / "examples" / "torch" / "serve_moe.py")],
                          env=env, capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"examples/torch/serve_moe.py exited {proc.returncode}: "
                                  f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    served = [re.fullmatch(r"rid=(\d+) prompt=.* -> generated \[([\d, ]*)\]", line)
              for line in lines[:-1]]
    last = re.fullmatch(r"(\d+) requests served in (\d+) engine steps .*", lines[-1])
    require(last is not None and int(last.group(1)) == EXAMPLE_REQUESTS
            and len(served) == EXAMPLE_REQUESTS
            and all(m is not None and len(m.group(2).split(",")) == EXAMPLE_NEW_TOKENS
                    for m in served),
            f"examples/torch/serve_moe.py printed {lines}")
    return {"run": "example serve_moe", "command": "python examples/torch/serve_moe.py",
            "returncode": proc.returncode, "requests": int(last.group(1)),
            "engine_steps": int(last.group(2)), "seconds": seconds}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA card; this script runs the "
                 "port on the card and has no CPU path")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.matmul import MatmulGrid
    from repro_torch.dist import collectives as dc
    from repro_torch.dist.mesh import dragonfly_layout
    from repro_torch.kernels import build
    from repro_torch.kernels.block_matmul.block_matmul import block_matmul
    from repro_torch.kernels.block_matmul.ref import block_matmul_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.runtime import optimize as opt
    from repro_torch.runtime.backends import get_backend
    from repro_torch.runtime.backends import cuda_fused as cf
    from repro_torch.serve.engine import Engine, Request

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kind = torch.cuda.get_device_name(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randint(*shape):
        return torch.randint(-4, 5, shape, generator=gen, device=dev).float()

    def same_bits(a, b) -> bool:
        return (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))

    def max_abs_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def time_ms(fn, reps=5, warmup=2, calls=1) -> float:
        """Median ms of one call over ``reps`` timings of ``calls`` calls
        back to back (more than one keeps the card busy past the host's
        cost of a call, so a short kernel's time is the card's)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / calls)
        return statistics.median(times)

    def bound(nbytes: float, flops: float, rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    def release():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    phase_end = [time.perf_counter()]

    def phase(step: str) -> None:
        """One ``phase: <step> <seconds> s`` line: the seconds since the
        last step ended (the first step's since main began)."""
        now = time.perf_counter()
        print(f"phase: {step} {now - phase_end[0]:.1f} s", flush=True)
        phase_end[0] = now

    # ------------------------------------------------------------ 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    phase("1")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(build.SOURCES)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the kernel (template instance) below
                entry = line.split("'")[1]
                print(f"  {name}: {entry}", flush=True)
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    be = get_backend("cuda_fused")
    ref = get_backend("reference")
    t0 = time.perf_counter()
    layout = dragonfly_layout(64)
    require((layout.topo.K, layout.topo.M) == (4, 4), f"dragonfly_layout(64) is {layout.topo}")
    progs = {
        "alltoall": dc.alltoall_program(layout, optimized=True),
        "allreduce": dc.allreduce_program(layout, optimized=True),
        "broadcast": dc.broadcast_program(layout, 0, optimized=True),
        "matmul": dc.matmul_program(4, 4, optimized=True),
    }
    print(f"programs: derived and fused in {time.perf_counter() - t0:.2f} s", flush=True)
    n, n_mm = layout.n, progs["matmul"].n
    F, X, N = BUCKET, BLOCK, MatmulGrid(4, 4).n * BLOCK

    phase("2")

    # ------------------------------------- 3. each kernel against its plain version
    kernels = {}

    def planted(*shape, dtype=torch.float32):
        """Random normals with NaN, ±inf and -0.0 at a few random places."""
        x = randn(*shape)
        flat = x.view(-1)
        picks = torch.randint(0, flat.numel(), (6,), generator=gen, device=dev)
        flat[picks] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, -0.0,
                                    float("nan")], device=dev)
        return x.to(dtype)

    # K1 and K2: each body against the plain version, float32 and bf16, with
    # special values planted; times of each body. bf16 adds round at once.
    t = opt.to_device_tables(opt.allreduce_tables(progs["allreduce"]), dev)
    t["packed"] = cf.pack_tables(t["gather"], t["mask"])
    R, k = t["gather"].shape[:2]
    allreduce_ops = R * (k + 1) * n * F  # k selected adds and the self-add per round
    k1 = {"ms": {}, "bound_ms": {}}
    for dtype in (torch.float32, torch.bfloat16):
        x = planted(n, F, dtype=dtype)
        want = cf._reduce_rounds_plain(x, t["gather"], t["mask"])
        esize = x.element_size()
        k1["bound_ms"][str(dtype)] = bound(2 * n * F * esize + R * k * n * 5, allreduce_ops)
        for body in cf.BODIES:
            got = cf.reduce_rounds(x, t["gather"], t["mask"], packed=t["packed"], body=body)
            require(same_bits(got, want), f"reduce_rounds ({body}, {dtype}) differs from its "
                                          "plain version")
            k1["ms"][f"{body} {dtype}"] = time_ms(
                lambda: cf.reduce_rounds(x, t["gather"], t["mask"], packed=t["packed"],
                                         body=body), reps=10)
        k1["ms"][f"plain {dtype}"] = time_ms(
            lambda: cf._reduce_rounds_plain(x, t["gather"], t["mask"]), reps=3, warmup=1)
        if dtype == torch.float32:
            err = max_abs_err(got.nan_to_num(), want.nan_to_num())
        del x, got, want
        release()
    b_ms, b_by = k1["bound_ms"]["torch.float32"]
    kernels["reduce_rounds"] = dict(
        name="reduce_rounds", route="cuda", source="src/repro_torch/csrc/reduce_rounds.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:133",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=k1["ms"]["staged torch.float32"], plain_ms=k1["ms"]["plain torch.float32"],
        library_ms=None, body_ms=k1["ms"])
    emit({"check": "reduce_rounds", "shape": [n, F], "tables": [R, k, n], "bit_exact": True,
          "special_values": True, **k1})

    groups = [tabs for kind_, _, tabs in opt.matmul_tables(progs["matmul"]) if kind_ == "combine"]
    require(len(groups) == 32, f"expected 32 combine groups at grid (4,4), got {len(groups)}")
    k2 = {"k": [], "ms": {}, "hook_ms": {}, "bound_ms": {}, "hook_bound_ms": {}}
    for dtype in (torch.float32, torch.bfloat16):
        val, acc = planted(n_mm, X * X, dtype=dtype), randn(n_mm, X * X).to(dtype)
        widths = set()
        for tabs in groups[:2]:  # one round's two groups (k = 5 and k = 4)
            tc = opt.to_device_tables(tabs, dev)
            tc["packed"] = cf.pack_tables(tc["gather"], tc["mask"])
            want = cf._combine_rows_plain(val, tc["gather"], tc["mask"])
            for body in cf.BODIES:
                for with_acc in (False, True):
                    got = cf.combine_rows(val, tc["gather"], tc["mask"], packed=tc["packed"],
                                          acc=acc if with_acc else None, body=body)
                    require(same_bits(got, acc + want if with_acc else want),
                            f"combine_rows ({body}, {dtype}, acc={with_acc}) differs from its "
                            "plain version")
            widths.add(tc["gather"].shape[0])
        k2["k"] = sorted(widths)
        kk = tc["gather"].shape[0]
        esize = val.element_size()
        k2["bound_ms"][str(dtype)] = bound(2 * n_mm * X * X * esize + kk * n_mm * 5,
                                           kk * n_mm * X * X)
        k2["hook_bound_ms"][str(dtype)] = bound(3 * n_mm * X * X * esize + kk * n_mm * 5,
                                                (kk + 1) * n_mm * X * X)
        for body in cf.BODIES:
            k2["ms"][f"{body} {dtype}"] = time_ms(lambda: cf.combine_rows(
                val, tc["gather"], tc["mask"], packed=tc["packed"], body=body), calls=10)
            k2["hook_ms"][f"{body} {dtype}"] = time_ms(lambda: cf.combine_rows(
                val, tc["gather"], tc["mask"], packed=tc["packed"], acc=acc, body=body), calls=10)
        k2["ms"][f"plain {dtype}"] = time_ms(
            lambda: cf._combine_rows_plain(val, tc["gather"], tc["mask"]), calls=10)
        k2["hook_ms"][f"plain {dtype}"] = time_ms(
            lambda: acc + cf._combine_rows_plain(val, tc["gather"], tc["mask"]), calls=10)
        if dtype == torch.float32:
            err = max_abs_err(got.nan_to_num(), (acc + want).nan_to_num())
            # the library's way to the same sums: the group's (n, n) selection
            # matrix times val through cuSPARSE (another order of the adds)
            rows = torch.arange(n_mm, device=dev).expand(kk, n_mm)
            sel = torch.sparse_coo_tensor(
                torch.stack([rows[tc["mask"]], tc["gather"][tc["mask"]].long()]),
                torch.ones(int(tc["mask"].sum()), device=dev), (n_mm, n_mm)).coalesce()
            csr = sel.to_sparse_csr()
            library_ms = time_ms(lambda: torch.sparse.mm(csr, val), calls=10)
            del csr, sel
        del val, acc, got, want
        release()
    b_ms, b_by = k2["bound_ms"]["torch.float32"]
    kernels["combine_rows"] = dict(
        name="combine_rows", route="cuda", source="src/repro_torch/csrc/reduce_rounds.cu",
        replaces="src/repro/runtime/backends/pallas_fused.py:161",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=k2["ms"]["staged torch.float32"], plain_ms=k2["ms"]["plain torch.float32"],
        library_ms=library_ms, body_ms=k2["ms"],
        combine_hook_ms=k2["hook_ms"]["staged torch.float32"],
        combine_hook_bound_ms=k2["hook_bound_ms"]["torch.float32"][0])
    emit({"check": "combine_rows", "shape": [n_mm, X * X], "bit_exact": True,
          "special_values": True,
          "library": "torch.sparse.mm (CSR selection matrix)", "library_ms": library_ms, **k2})
    release()

    a, b = randint(n_mm, X, X), randint(n_mm, X, X)
    zero_counts((block_matmul,))
    require(same_bits(block_matmul(a, b), block_matmul_ref(a, b)),
            "block_matmul is not exact on integer-valued inputs")
    a, b = randn(n_mm, X, X), randn(n_mm, X, X)
    got, want = block_matmul(a, b), block_matmul_ref(a, b)
    require(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
            f"block_matmul off by {max_abs_err(got, want)} on random-normal inputs")
    require(block_matmul.body_launches == {"simt": 0, "tf32x3": 2},
            f"block_matmul's checks launched {block_matmul.body_launches}")
    exact = torch.bmm(a.double(), b.double())  # how far each float32 product is from exact
    err_f64 = {"tf32x3": max_abs_err(got, exact), "cublas_f32": max_abs_err(want, exact)}
    del exact
    # the function's 2·X³ a block at the TF32 tensor cores' rate; beside it
    # the same work at the FFMA rate and the tf32x3 design's three products
    mm_bytes = 3 * n_mm * X * X * 4
    b_ms, b_by = bound(mm_bytes, 2 * n_mm * X ** 3, TF32_FLOP_PER_S)
    kernels["block_matmul"] = dict(
        name="block_matmul", route="cuda", source="src/repro_torch/csrc/block_matmul.cu",
        replaces="src/repro/kernels/block_matmul/block_matmul.py:46",
        max_abs_err=max_abs_err(got, want), bound_ms=b_ms, bound_by=b_by,
        ffma_bound_ms=bound(mm_bytes, 2 * n_mm * X ** 3)[0],
        tf32x3_route_bound_ms=bound(mm_bytes, 3 * 2 * n_mm * X ** 3, TF32_FLOP_PER_S)[0],
        ms=time_ms(lambda: block_matmul(a, b)),
        plain_ms=time_ms(lambda: block_matmul_ref(a, b)),
        library_ms=time_ms(lambda: torch.bmm(a, b)))
    emit({"check": "block_matmul", "shape": [n_mm, X, X], "body": "tf32x3",
          "exact_on_integers": True, "rtol": 2e-4, "atol": 2e-4, "max_abs_err_vs_f64": err_f64,
          **{key: kernels["block_matmul"][key] for key in (
              "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
              "ffma_bound_ms", "tf32x3_route_bound_ms")}})
    del a, b, got, want
    release()

    phase("3")

    # --------------------------------------- 4. the main path at full width
    counters = (cf.reduce_rounds, cf.combine_rows, block_matmul)
    expected = {
        "alltoall": {},
        "allreduce": {"reduce_rounds": 1},
        "broadcast": {},
        "matmul": {"combine_rows": 32, "block_matmul": 16},
    }
    plain = {
        "alltoall": lambda x: opt.torch_alltoall(progs["alltoall"], dev)(x),
        "allreduce": lambda x: opt.torch_allreduce(progs["allreduce"], dev)(x),
        "broadcast": lambda x: opt.torch_broadcast(progs["broadcast"], dev)(x),
        "matmul": lambda B, A: opt.torch_gather_blocks(
            opt.torch_matmul_blocks(progs["matmul"], dev)(
                opt.torch_scatter_blocks(B, (4, 4)), opt.torch_scatter_blocks(A, (4, 4))),
            (4, 4)),
    }
    run = {
        "alltoall": lambda x: be.run_alltoall(x, progs["alltoall"]),
        "allreduce": lambda x: be.run_allreduce(x, progs["allreduce"]),
        "broadcast": lambda x: be.run_broadcast(x, progs["broadcast"]),
        "matmul": lambda B, A: be.run_matmul(B, A, progs["matmul"]),
    }
    inputs = {
        "alltoall": lambda: (randn(n, n, CHUNK),),
        "allreduce": lambda: (randn(n, F),),
        "broadcast": lambda: (randn(n, F),),
        "matmul": lambda: (randint(N, N), randint(N, N)),
    }
    launches = {fn.__name__: 0 for fn in counters}
    runs = []
    for coll in ("alltoall", "allreduce", "broadcast", "matmul"):
        args = inputs[coll]()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        got = run[coll](*args)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters}
        bodies = dict(block_matmul.body_launches)
        require(counts == {name: expected[coll].get(name, 0) for name in counts},
                f"run_{coll} launched {counts}, expected {expected[coll]}")
        if coll == "allreduce":  # the main-path shape takes the staged body
            k1_bodies = dict(cf.reduce_rounds.body_launches)
            require(k1_bodies == {"slab": 0, "staged": 1},
                    f"run_allreduce launched reduce_rounds' bodies {k1_bodies}")
            kernels["reduce_rounds"].update(body="staged", body_launches=k1_bodies)
        if coll == "matmul":  # tf32x3 products, staged combines each with its acc
            require(bodies == {"simt": 0, "tf32x3": counts["block_matmul"]},
                    f"run_matmul launched block_matmul's bodies {bodies}")
            kernels["block_matmul"].update(body="tf32x3", body_launches=bodies)
            k2_bodies = dict(cf.combine_rows.body_launches)
            require(k2_bodies == {"slab": 0, "staged": 32} and cf.combine_rows.acc_launches == 32,
                    f"run_matmul launched combine_rows' bodies {k2_bodies}, "
                    f"{cf.combine_rows.acc_launches} with acc")
            kernels["combine_rows"].update(body="staged", body_launches=k2_bodies,
                                           acc_launches=cf.combine_rows.acc_launches)
        for name, count in counts.items():
            launches[name] += count
        want = plain[coll](*args)
        require(same_bits(got, want), f"run_{coll} differs from the plain torch path")
        if coll == "alltoall":  # the native exchange is the (src, dst) transpose
            require(same_bits(got, args[0].transpose(0, 1).contiguous()), "all-to-all is not x[j, i]")
        elif coll == "allreduce":
            total = args[0].sum(0, keepdim=True).expand_as(got)
            require(torch.allclose(got, total, rtol=1e-5, atol=1e-4), "all-reduce is not the sum")
        elif coll == "broadcast":
            require(same_bits(got, args[0][:1].expand_as(got)), "broadcast is not root 0's row")
        else:
            require(same_bits(got, torch.matmul(*args)), "run_matmul is not B @ A")
        require(bool(torch.isfinite(got).all()), f"run_{coll} has non-finite values")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del got, want
        release()
        io_bytes = sum(t.numel() * 4 for t in args) + args[0].numel() * 4
        flops = {"allreduce": allreduce_ops, "matmul": 2 * N ** 3}
        b_ms, b_by = bound(io_bytes, flops.get(coll, 0))
        rec = {"run": coll, "shape": [list(t.shape) for t in args], "bit_exact_vs_plain": True,
               "launches": counts, "peak_gib": peak,
               **({"block_matmul_bodies": bodies, "combine_rows_bodies": k2_bodies,
                   "combine_rows_acc_launches": cf.combine_rows.acc_launches}
                  if coll == "matmul" else
                  {"reduce_rounds_bodies": k1_bodies} if coll == "allreduce" else {}),
               "ms": time_ms(lambda: run[coll](*args), reps=3, warmup=1),
               "plain_ms": time_ms(lambda: plain[coll](*args), reps=3, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by}
        runs.append(rec)
        emit(rec)
        del args
        release()
    for name in ("reduce_rounds", "combine_rows", "block_matmul"):
        require(launches[name] > 0, f"the main path never launched {name}")

    phase("4")

    # ------------------------------- 5. reduced width against the NumPy reference
    rng = np.random.default_rng(SEED)
    plain_progs = {
        "alltoall": dc.alltoall_program(layout),
        "allreduce": dc.allreduce_program(layout),
        "broadcast": dc.broadcast_program(layout, 0),
        "matmul": dc.matmul_program(4, 4),
    }
    N_small = MatmulGrid(4, 4).n * 4
    small = {
        "alltoall": (rng.standard_normal((n, n, 8)).astype(np.float32),),
        "allreduce": (rng.standard_normal((n, 1000)).astype(np.float32),),
        "broadcast": (rng.standard_normal((n, 1000)).astype(np.float32),),
        "matmul": tuple(rng.integers(-4, 5, (N_small, N_small)).astype(np.float32)
                        for _ in range(2)),
    }
    for coll, args in small.items():
        for form, prog in (("optimized", progs[coll]), ("plain", plain_progs[coll])):
            got = getattr(be, f"run_{coll}")(*args, prog).cpu().numpy()
            want = getattr(ref, f"run_{coll}")(*args, prog)
            require(got.dtype == want.dtype and np.array_equal(
                np.ascontiguousarray(got).view(np.uint8), np.ascontiguousarray(want).view(np.uint8)),
                    f"run_{coll} ({form}) differs from the NumPy reference")
        emit({"reference": coll, "shape": [list(a.shape) for a in args], "forms": ["optimized", "plain"],
              "bit_exact": True})

    phase("5-6")

    # ------------------ 6b. the autotuner at the global site, the cells' own bytes
    # get_backend("auto") with a measuring tuner on a cache in a temporary
    # directory decides each collective on its first call (timed), then runs
    # it once more with the launch counts set to 0 (a memo hit); every result
    # the plain path's bits. A second tuner on the same file then decides
    # each key from the cache, with the timer made to raise.
    from repro_torch.runtime import autotune as AT
    from repro_torch.runtime.backends.auto import AutoBackend

    seeds = autotune_seeds(dev, time_ms)
    print(f"autotune seeds: {json.dumps(seeds)} ({card}; the constants in "
          f"runtime/autotune.py: BANDWIDTH {AT.BANDWIDTH}, T_KERNEL {AT.T_KERNEL})", flush=True)
    t_auto = time.perf_counter()
    tune_dir = tempfile.TemporaryDirectory(prefix="autotune-")
    cache = pathlib.Path(tune_dir.name) / "autotune_cache.json"
    tuner = AT.Autotuner(cache_path=cache, device=dev)
    decide_s = timing_decisions(tuner)
    auto = get_backend("auto", tuner=tuner)
    N_auto = MatmulGrid(4, 4).n * AUTO_MATMUL_BLOCK
    agen = torch.Generator(device=dev).manual_seed(SEED + 6)  # leaves gen's stream as it was
    auto_inputs = {
        "alltoall": lambda: (torch.randn((n, n, AUTO_CHUNK), generator=agen, device=dev),),
        "allreduce": lambda: (torch.randn((n, AUTO_BUCKET), generator=agen, device=dev),),
        "broadcast": lambda: (torch.randn((n, AUTO_BUCKET), generator=agen, device=dev),),
        "matmul": lambda: tuple(torch.randint(-4, 5, (N_auto, N_auto), generator=agen,
                                              device=dev).float() for _ in range(2)),
    }
    auto_args, auto_rows = {}, []
    for coll in ("alltoall", "allreduce", "broadcast", "matmul"):
        args = auto_args[coll] = auto_inputs[coll]()
        n_dec = len(decide_s)
        t0 = time.perf_counter()
        first = getattr(auto, f"run_{coll}")(*args, progs[coll])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        dec = tuner.decisions[-1]
        require(dec.source == "measured" and len(decide_s) == n_dec + 1,
                f"auto {coll}: the first call's decision is {dec.source}")
        ran = AutoBackend._global_strategy(dec)
        zero_counts(counters)
        got = getattr(auto, f"run_{coll}")(*args, progs[coll])
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters}
        want_counts = expected[coll] if ran == "cuda_fused" else {}
        require(counts == {name: want_counts.get(name, 0) for name in counts},
                f"auto run_{coll} under {ran} launched {counts}, expected {want_counts}")
        require(len(tuner.decisions) == len(auto_rows) + 1 and len(decide_s) == n_dec + 2,
                f"auto {coll}: the second call was no memo hit")
        for name, count in counts.items():
            launches[name] += count
        want = plain[coll](*args)
        require(same_bits(got, want) and same_bits(first, want),
                f"auto run_{coll} ({ran}) differs from the plain torch path")
        row = {"autotune": "global", "run": coll, "shape": [list(t.shape) for t in args],
               "key": str(dec.key), "strategy": dec.strategy, "ran": ran, "source": dec.source,
               "measured_us": dec.measured_us, "analytic_us": dec.analytic_us,
               "decide_s": decide_s[n_dec], "first_call_s": first_s, "memo_decide_s": decide_s[-1],
               "launches": counts, "bit_exact_vs_plain": True,
               **({"combine_rows_bodies": dict(cf.combine_rows.body_launches),
                   "block_matmul_bodies": dict(block_matmul.body_launches)}
                  if ran == "cuda_fused" and coll == "matmul" else {}),
               **({"reduce_rounds_bodies": dict(cf.reduce_rounds.body_launches)}
                  if ran == "cuda_fused" and coll == "allreduce" else {})}
        auto_rows.append(row)
        emit(row)
        del first, got, want
        release()
    real_time_us = AT._time_us

    def no_timing(*_a, **_k):
        raise AssertionError("a tuner warm from the cache timed a candidate")

    AT._time_us = no_timing
    try:
        warm = AT.Autotuner(cache_path=cache, device=dev)
        auto_warm = get_backend("auto", tuner=warm)
        for coll, row in zip(auto_args, auto_rows):
            got = getattr(auto_warm, f"run_{coll}")(*auto_args[coll], progs[coll])
            dec = warm.decisions[-1]
            require((str(dec.key), dec.strategy, dec.source) == (row["key"], row["strategy"], "cache"),
                    f"the warm tuner decided {coll} as {dec.key} -> {dec.strategy} ({dec.source})")
            require(same_bits(got, plain[coll](*auto_args[coll])), f"warm auto run_{coll} differs")
            del got
    finally:
        AT._time_us = real_time_us
    del auto_args
    tune_dir.cleanup()
    release()
    auto_rec = {"run": "autotune_global", "card": card, "cache_device": AT.device_tag(dev),
                "matmul_block": AUTO_MATMUL_BLOCK, "alltoall_chunk": AUTO_CHUNK,
                "bucket": AUTO_BUCKET, "seeds": seeds,
                "decisions": {row["run"]: {k: row[k] for k in ("key", "strategy", "ran", "decide_s")}
                              for row in auto_rows},
                "warm_tuner": "every key from the cache, nothing timed",
                "phase_s": time.perf_counter() - t_auto}
    emit(auto_rec)
    if auto_rec["phase_s"] > AUTO_PHASE_S:
        print(f"autotune: the global step took {auto_rec['phase_s']:.0f} s, past its "
              f"{AUTO_PHASE_S} s", flush=True)

    phase("6b")

    # ------------------------- 7. flash attention against its plain version
    B, S = PREFILL
    cfg = get_config("tinyllama-1.1b")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    full_mcfg = get_config("mixtral-8x7b")
    mcfg = dataclasses.replace(full_mcfg, n_layers=MIXTRAL_LAYERS)
    MS = MIXTRAL_TOKENS[1]
    mixtral_case = (MIXTRAL_TOKENS[0], MS, MS, mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim,
                    True, mcfg.sliding_window, torch.bfloat16)
    cases = [  # (B, Sq, Sk, Hq, Hkv, D, causal, window, dtype)
        (B, S, S, Hq, Hkv, D, True, None, torch.bfloat16),  # the prefill shape
        mixtral_case,  # Mixtral-8x7B's prefill shape: the window binds on half the rows
        (2, 256, 256, 8, 2, 64, True, None, torch.float32),
        (2, 192, 320, 4, 4, 96, False, None, torch.float32),  # Phi-3-mini's head_dim
        (2, 160, 160, 8, 8, 96, True, None, torch.bfloat16),
        (1, 128, 128, 4, 1, 128, True, None, torch.float32),
        (2, 200, 333, 8, 2, 64, True, 32, torch.float32),  # window, Sq != Sk, ragged
        (2, 333, 200, 8, 2, 64, True, 32, torch.bfloat16),  # rows that see no key
        (3, 1, 77, 8, 8, 64, False, None, torch.bfloat16),
    ]

    for i, (b_, sq, sk, hq, hkv, d, causal, window, dtype) in enumerate(cases):
        tol = FLASH_TOL[str(dtype)]
        q, k, v = randn(b_, sq, hq, d).to(dtype), randn(b_, sk, hkv, d).to(dtype), \
            randn(b_, sk, hkv, d).to(dtype)
        zero_counts((flash_attention,))
        got = flash_attention(q, k, v, causal=causal, window=window)
        bodies = dict(flash_attention.body_launches)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        require(got.dtype == dtype and bool(torch.isfinite(got).all()), "flash_attention output")
        ok, err, rel = attention_close(got, want, tol)
        require(ok, f"flash_attention off by max {err}, relative rms {rel} at "
                    f"{(b_, sq, sk, hq, hkv, d, causal, window, dtype)}")
        emit({"check": "flash_attention", "q": [b_, sq, hq, d], "kv": [b_, sk, hkv, d],
              "causal": causal, "window": window, "dtype": str(dtype), "rtol": tol, "atol": tol,
              "rel_rms_tol": tol, "max_abs_err": err, "rel_rms": rel, "bodies": bodies})
        if i == 0:
            prefill_err, prefill_qkv, prefill_want0 = err, (q, k, v), want[0]
        if cases[i] == mixtral_case:
            mixtral_err, mixtral_qkv = err, (q, k, v)
    q, k, v = prefill_qkv

    # The bf16 bound rejects a kernel with a planted fault: a materialised
    # attention on batch row 0 of the prefill shape with the causal mask off
    # by one, without the diagonal key or without the diagonal 64-key tile
    # fails it, and the same attention with the right mask passes.
    def masked_attention(q, k, v, mask):
        """q (Sq, Hq, D), k/v (Sk, Hkv, D), mask (Sq, Sk); float32 softmax,
        rows that see no key give 0."""
        G = q.shape[1] // k.shape[1]
        kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
        s = torch.einsum("qhd,khd->hqk", q.float(), kf) / q.shape[-1] ** 0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1).nan_to_num(0.0)
        return torch.einsum("hqk,khd->qhd", p, vf).to(q.dtype)

    pos = torch.arange(S, device=dev)
    q_pos, k_pos = pos[:, None], pos[None, :]
    faults = {"right mask": k_pos <= q_pos, "causal mask off by one": k_pos <= q_pos + 1,
              "diagonal key dropped": k_pos < q_pos,
              "diagonal 64-key tile dropped": k_pos < q_pos // 64 * 64}
    verdicts = {}
    for name, mask in faults.items():
        ok, err, rel = attention_close(masked_attention(q[0], k[0], v[0], mask), prefill_want0,
                                       FLASH_TOL["torch.bfloat16"])
        require(ok == (name == "right mask"),
                f"the bf16 bound {'rejects' if name == 'right mask' else 'passes'} {name}: "
                f"max {err}, relative rms {rel}")
        verdicts[name] = {"passes": ok, "max_abs_err": err, "rel_rms": rel}
    emit({"check": "flash_attention bound against planted faults", "q": [1, S, Hq, D],
          "tol": FLASH_TOL["torch.bfloat16"], **verdicts})
    del prefill_want0, faults, mask
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2  # q and o, k and v, bf16
    b_ms, b_by = bound(nbytes, 4 * B * Hq * S * S * D / 2, BF16_FLOP_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def host_us(fn, rounds=5, calls=20) -> float:
        """Host time of one call in µs, least over rounds of back-to-back
        calls: the card is still busy with the calls before, so this is
        the wrapper's and the launch's own cost."""
        best = float("inf")
        for _ in range(rounds):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return best

    q32, k32, v32 = q.float(), k.float(), v.float()
    host = {"wgmma": host_us(lambda: flash_attention(q, k, v, causal=True)),
            "mma_sync": host_us(lambda: flash_attention(q32, k32, v32, causal=True))}
    del q32, k32, v32
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:84",
        max_abs_err=prefill_err, bound_ms=b_ms, bound_by=b_by,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), reps=10),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, causal=True), reps=3, warmup=1),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=10))
    emit({"check": "flash_attention timing", "q": list(q.shape), "kv": list(k.shape),
          **{key: kernels["flash_attention"][key] for key in (
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
          "host_us": host, "tensor_map_host_us": host["wgmma"] - host["mma_sync"]})
    del q, k, v, qt, kt, vt, prefill_qkv, got, want
    release()

    # K4 at Mixtral's prefill shape. Its bound counts only the keys inside
    # the causal window: sum over q of min(q + 1, window) pairs, 4·D
    # operations a pair and head. The yardstick is one SDPA call given the
    # same window as a boolean mask, with the KV heads expanded beforehand.
    q, k, v = mixtral_qkv
    window = mcfg.sliding_window
    pairs = sum(min(i + 1, window) for i in range(MS))
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * k.numel() * 2,
                       4 * pairs * mcfg.head_dim * mcfg.n_heads, BF16_FLOP_PER_S)
    pos = torch.arange(MS, device=dev)
    allowed = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
    G = mcfg.n_heads // mcfg.n_kv_heads
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)

    lib_err = max_abs_err(sdpa().transpose(1, 2), flash_attention(q, k, v, causal=True,
                                                                   window=window))
    mixtral_k4 = {"q": list(q.shape), "kv": list(k.shape), "window": window,
                  "max_abs_err": mixtral_err, "key_pairs": pairs,
                  "ms": time_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                                reps=10),
                  "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, causal=True,
                                                                    window=window),
                                      reps=3, warmup=1),
                  "library_ms": time_ms(sdpa, reps=10), "bound_ms": b_ms, "bound_by": b_by,
                  "library": "SDPA, boolean window mask, KV heads expanded",
                  "library_max_abs_err_vs_kernel": lib_err}
    kernels["flash_attention"]["mixtral_shape"] = mixtral_k4
    emit({"check": "flash_attention timing, Mixtral-8x7B shape", **mixtral_k4})
    del q, k, v, qt, kt, vt, mixtral_qkv, allowed, pos
    release()

    kernels["flash_attention"]["local_heads"] = k4_local_heads(dev, time_ms, bound)

    phase("7")

    # ------------------------------- 8. TinyLlama-1.1B prefill at full width
    all_counters = counters + (flash_attention,)
    params = M.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    tokens = torch.randint(1, cfg.vocab, PREFILL, generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": tokens}

    def model_run(fn, *args):
        """Run fn with every launch count at 0; return its result and the counts."""
        zero_counts(all_counters)
        out = fn(*args)
        torch.cuda.synchronize()
        return out, {c.__name__: c.launches for c in all_counters}

    def logits_close(got, want, what):
        got, want = got.float(), want.float()
        err = max_abs_err(got, want)
        rel = float((got - want).norm() / want.norm())
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
        require(err <= LOGIT_MAX_ABS and rel <= LOGIT_REL_RMS,
                f"{what}: logits off by max {err}, relative rms {rel}")
        return err, rel

    only_k4 = {name: 0 for name in launches} | {"flash_attention": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    (logits, _, _), counts = model_run(M.forward_train, params, batch, cfg, True)
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
    require(counts == only_k4, f"forward_train launched {counts}, expected {only_k4}")
    bodies = dict(flash_attention.body_launches)  # the prefill shape takes the wgmma body
    require(bodies == {"mma_sync": 0, "wgmma": cfg.n_layers},
            f"forward_train launched flash_attention's bodies {bodies}")
    launches["flash_attention"] = counts["flash_attention"]
    kernels["flash_attention"].update(body="wgmma", body_launches=bodies)
    last = logits[:, -1].float()
    del logits
    (loss, metrics), counts = model_run(M.loss_fn, params, batch, cfg, True)
    require(counts == only_k4, f"loss_fn launched {counts}, expected {only_k4}")
    require(bool(torch.isfinite(loss)), f"loss is {float(loss)}")
    (naive, _, _), counts = model_run(M.forward_train, params, batch, cfg, False)
    require(counts["flash_attention"] == 0, "the naive forward launched flash_attention")
    naive_last = naive[:, -1].float()
    del naive
    release()
    naive_loss = M.loss_fn(params, batch, cfg, False)[0]
    err, rel = logits_close(last, naive_last, "kernel vs naive forward")
    loss_rel = abs(float(loss) - float(naive_loss)) / abs(float(naive_loss))
    require(loss_rel <= LOSS_REL, f"loss {float(loss)} vs naive {float(naive_loss)}")
    fwd_ms = time_ms(lambda: M.forward_train(params, batch, cfg, True), reps=3, warmup=1)
    runs.append({"run": "prefill", "model": cfg.name, "tokens": list(PREFILL),
                 "launches": {"flash_attention": cfg.n_layers}, "flash_attention_bodies": bodies,
                 "ms": fwd_ms,
                 "tokens_per_s": B * S / fwd_ms * 1e3, "peak_gib": prefill_peak,
                 "loss": float(loss), "naive_loss": float(naive_loss),
                 "last_logits_vs_naive": {"max_abs_err": err, "rel_rms": rel}})
    emit(runs[-1])
    del last, naive_last
    release()

    phase("8")

    # --------------------------------- 9. serving at full width, 4 slots
    class Recording(Engine):
        """The engine, keeping each step's positions and logits."""

        def _forward(self):
            out = super()._forward()
            self.trace.append((self.positions.copy(), out))
            return out

    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).astype(np.int32),
                    max_new_tokens=12) for i in range(6)]
    torch.cuda.reset_peak_memory_stats()
    eng = Recording(cfg, params, batch_slots=4, max_seq=2048, device=dev)
    eng.trace = []
    zero_counts(all_counters)
    pending = list(reqs)
    t0 = time.perf_counter()
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            eng.admit(pending.pop(0))
        eng.step()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    serve_counts = {c.__name__: c.launches for c in all_counters}
    require(all(r.done and len(r.out) == 12 for r in reqs),
            f"requests not answered: {[(r.rid, r.done, len(r.out)) for r in reqs]}")
    require(eng.tokens_out == 72, f"engine committed {eng.tokens_out} tokens, expected 72")
    p0 = reqs[0].prompt  # request 0 sits in slot 0
    step_logits = next(out[0] for pos, out in eng.trace if pos[0] == len(p0) - 1)
    full = M.forward_train(params, {"tokens": torch.from_numpy(p0).to(dev)[None]}, cfg, True)[0]
    err, rel = logits_close(torch.from_numpy(step_logits).to(dev), full[0, -1],
                            "decode vs prefill logits")
    runs.append({"run": "serve", "model": cfg.name, "slots": 4, "max_seq": 2048,
                 "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
                 "steps": eng.steps_run, "tokens": eng.tokens_out, "s": serve_s,
                 "tokens_per_s": eng.tokens_out / serve_s, "peak_gib": serve_peak,
                 "launches": serve_counts,
                 "decode_vs_prefill_logits": {"max_abs_err": err, "rel_rms": rel}})
    emit(runs[-1])
    del full
    release()

    phase("9")

    # ---------------------------- 10. where the model path's device time goes
    def device_profile(fn, wall_ms, reps=3, labels=(), top_ops=0):
        """Device time per call by kernel group, from torch.profiler, beside
        a wall time taken without the profiler; the idle share is the part
        of the wall time with no kernel running (None where the profiler
        saw no device time). The device spans of the port's profiler ranges
        (``PROFILER_RANGES``, and any other user annotation) are not
        kernels and are left out of the groups.
        With ``labels``, also the device time of the kernels launched
        inside each ``record_function`` range of that name; with
        ``top_ops``, the device time of the kernels
        each torch op launches itself, for the ops with the most. The
        profiler's "Command Buffer Full" markers (a launch that waited for
        room in the queue) list kernels that their op lists too: they are
        left out of the ops and labels, and their device time is given
        apart (``queue_full_ms``)."""
        from torch.profiler import ProfilerActivity, profile

        stall = "Command Buffer Full"

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        groups, n_kernels = {}, 0
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA or e.key in PROFILER_RANGES
                    or getattr(e, "is_user_annotation", False)):
                continue
            name = e.key.lower()
            group = ("flash_attention" if "flash_attention" in name else
                     "matmul" if any(w in name for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet"))
                     else "other")
            groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3 / reps
            n_kernels += e.count
        busy = sum(groups.values())
        rec = {"wall_ms": wall_ms, "device_ms": busy, "kernels_per_call": n_kernels / reps,
               "idle_share": 1 - busy / wall_ms if busy else None, "device_ms_by_group": groups}
        rec["queue_full_ms"] = sum(e.self_device_time_total for e in prof.key_averages()
                                   if e.key == stall) / 1e3 / reps
        if top_ops:
            own = sorted(((e.self_device_time_total / 1e3 / reps, e.key)
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CPU
                          and e.self_device_time_total > 0 and e.key != stall), reverse=True)
            rec["device_ms_by_op"] = {key: ms for ms, key in own[:top_ops]}
        if labels:
            by_label = dict.fromkeys(labels, 0.0)
            for e in prof.events():
                if (e.device_type != torch.autograd.DeviceType.CPU or not e.kernels
                        or e.name == stall):
                    continue
                up = e
                while up is not None and up.name not in by_label:
                    up = up.cpu_parent
                if up is not None:
                    by_label[up.name] += sum(k.duration for k in e.kernels) / 1e3 / reps
            rec["device_ms_by_label"] = by_label
        return rec

    step_ms = time_ms(eng._forward, reps=5, warmup=1)
    emit({"profile": "prefill forward", **device_profile(
        lambda: M.forward_train(params, batch, cfg, True), fwd_ms)})
    emit({"profile": "engine step, 4 slots", **device_profile(eng._forward, step_ms)})
    del params, eng, batch
    release()

    phase("10")

    # -------- 11. DeepSeek-V3 at full width, the depth cut to 3 dense + 1 MoE layers
    kit = types.SimpleNamespace(time_ms=time_ms, bound=bound, model_run=model_run,
                                logits_close=logits_close, device_profile=device_profile,
                                release=release, Recording=Recording, names=list(launches))
    ds_k4, ds_runs, ds_launches = deepseek_phase(dev, kit)
    runs.extend(ds_runs)
    launches["flash_attention"] += ds_launches
    kernels["flash_attention"]["mla_shape"] = ds_k4
    kernels["flash_attention"]["launches_by_path"] = {
        f"{cfg.name} prefill": cfg.n_layers, "deepseek-v3-671b prefill": ds_launches}
    kernels["flash_attention"]["body_launches"]["wgmma"] += ds_launches

    phase("11")

    # --- 11b. Jamba-1.5-Large at full width, one period of 8 layers; 11c. xLSTM-1.3B whole
    jamba_k4, jamba_runs, jamba_launches = jamba_phase(dev, kit)
    runs.extend(jamba_runs)
    launches["flash_attention"] += jamba_launches
    kernels["flash_attention"]["jamba_shape"] = jamba_k4
    kernels["flash_attention"]["launches_by_path"]["jamba-1.5-large-398b prefill"] = jamba_launches
    kernels["flash_attention"]["body_launches"]["wgmma"] += jamba_launches
    phase("11b")
    runs.extend(xlstm_phase(dev, kit))

    phase("11c")

    # ----- 11d. training: TinyLlama-1.1B (whole, and 2 layers), Jamba's Mamba layer
    runs.extend(train_phase(dev, kit, all_counters + (cf.ring_put, cf.ring_signal,
                                                     cf.ring_wait_add)))

    phase("11d")

    # ----------------- 12. Mixtral-8x7B at full width, the depth cut to 8 layers
    t0 = time.perf_counter()
    mparams = M.init_params(torch.Generator(device=dev).manual_seed(SEED), mcfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    n_params = sum(t.numel() for t in _tensors(mparams))
    weight_gb = _nbytes(mparams) / 1e9
    print(f"mixtral-8x7b: depth cut from {full_mcfg.n_layers} to {mcfg.n_layers} layers: all "
          f"{full_mcfg.n_layers} take {full_mcfg.param_count() * 2 / 1e9:.1f} GB of bf16 "
          f"weights, more than the card holds; {mcfg.n_layers} layers: {n_params / 1e9:.2f} B "
          f"parameters, {weight_gb:.1f} GB (made on the card in {init_s:.1f} s); every width "
          "is the published one", flush=True)
    mtokens = torch.randint(1, mcfg.vocab, MIXTRAL_TOKENS, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED))
    mbatch = {"tokens": mtokens, "labels": mtokens}
    T_m = mtokens.numel()
    only_k4 = {name: 0 for name in launches} | {"flash_attention": mcfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as k_routes:
        (logits, aux, _), counts = model_run(M.forward_train, mparams, mbatch, mcfg, True)
    kernel_peak = torch.cuda.max_memory_allocated() / 2**30
    require(counts == only_k4, f"mixtral forward_train launched {counts}, expected {only_k4}")
    m_launches = counts["flash_attention"]
    m_bodies = dict(flash_attention.body_launches)
    require(m_bodies == {"mma_sync": 0, "wgmma": mcfg.n_layers},
            f"mixtral forward_train launched flash_attention's bodies {m_bodies}")
    require(len(k_routes) == mcfg.n_layers and bool(torch.isfinite(aux)),
            f"{len(k_routes)} MoE layers routed, aux {float(aux)}")
    last = logits[:, -1].float()
    del logits
    (loss, metrics), counts = model_run(M.loss_fn, mparams, mbatch, mcfg, True)
    require(counts == only_k4, f"mixtral loss_fn launched {counts}, expected {only_k4}")
    require(bool(torch.isfinite(loss)) and "moe_aux" in metrics, f"mixtral loss {float(loss)}")
    release()
    torch.cuda.reset_peak_memory_stats()
    with MOE.recording_routes() as n_routes:
        (naive, naive_aux, _), counts = model_run(M.forward_train, mparams, mbatch, mcfg, False)
    naive_peak = torch.cuda.max_memory_allocated() / 2**30
    require(counts["flash_attention"] == 0, "the naive mixtral forward launched flash_attention")
    naive_last = naive[:, -1].float()
    del naive
    release()
    naive_loss = M.loss_fn(mparams, mbatch, mcfg, False)[0]
    release()
    err, rel = logits_close(last, naive_last, "mixtral: kernel vs naive forward")
    loss_rel = abs(float(loss) - float(naive_loss)) / abs(float(naive_loss))
    require(loss_rel <= LOSS_REL, f"mixtral loss {float(loss)} vs naive {float(naive_loss)}")
    flips = route_flips(k_routes, n_routes, mcfg.moe.top_k)
    flip_share = flips["share"]
    kept = [keep for _, keep, _ in k_routes]
    drop_share = sum(int((~keep).sum()) for keep in kept) / sum(keep.numel() for keep in kept)
    drops_by_layer = [int((~keep).sum()) for keep in kept]
    del k_routes, n_routes, kept, last, naive_last
    release()
    m_fwd_ms = time_ms(lambda: M.forward_train(mparams, mbatch, mcfg, True), reps=3, warmup=1)
    labels = ("moe.dispatch", "moe.experts", "moe.combine")
    mprof = device_profile(lambda: M.forward_train(mparams, mbatch, mcfg, True), m_fwd_ms,
                           labels=labels, top_ops=16)
    lab = mprof["device_ms_by_label"]
    k4_ms = mprof["device_ms_by_group"].get("flash_attention", 0.0)
    if lab["moe.experts"]:  # kernels were traced back to their torch ops
        dc_ms = lab["moe.dispatch"] + lab["moe.combine"]
        mprof["device_ms_by_part"] = {
            "expert products (moe.experts: 3 bmm and the gate)": lab["moe.experts"],
            "dispatch and combine (router included)": dc_ms, "flash_attention (K4)": k4_ms,
            "the rest": mprof["device_ms"] - lab["moe.experts"] - dc_ms - k4_ms}
    else:
        mprof["device_ms_by_part"] = "not measured: the profiler tied no kernel to a torch op"
    C_m = MOE.capacity(mcfg, T_m)
    launches["flash_attention"] += m_launches
    kernels["flash_attention"]["launches_by_path"][f"{mcfg.name} prefill"] = m_launches
    kernels["flash_attention"]["body_launches"] = {
        body: kernels["flash_attention"]["body_launches"][body] + m_bodies[body]
        for body in m_bodies}
    runs.append({"run": "prefill", "model": mcfg.name, "layers": f"{mcfg.n_layers} of "
                 f"{full_mcfg.n_layers}", "tokens": list(MIXTRAL_TOKENS), "params": n_params,
                 "launches": {"flash_attention": mcfg.n_layers}, "flash_attention_bodies": m_bodies,
                 "ms": m_fwd_ms, "tokens_per_s": T_m / m_fwd_ms * 1e3,
                 "peak_gib": {"kernel": kernel_peak, "naive": naive_peak},
                 "loss": float(loss), "naive_loss": float(naive_loss), "moe_aux": float(aux),
                 "naive_moe_aux": float(naive_aux),
                 "last_logits_vs_naive": {"max_abs_err": err, "rel_rms": rel},
                 "capacity": C_m, "dropped_share": drop_share, "dropped_by_layer": drops_by_layer,
                 "route_flips": flips, "profile": mprof})
    emit(runs[-1])
    del loss, metrics, naive_loss, aux, naive_aux
    release()

    rng = np.random.default_rng(SEED)
    mreqs = [Request(rid=i, prompt=rng.integers(1, mcfg.vocab, size=rng.integers(3, 9))
                     .astype(np.int32), max_new_tokens=12) for i in range(6)]
    torch.cuda.reset_peak_memory_stats()
    meng = Recording(mcfg, mparams, batch_slots=4, max_seq=128, device=dev)
    meng.trace = []
    zero_counts(all_counters)
    pending = list(mreqs)
    t0 = time.perf_counter()
    while pending or meng.slot_req:
        while pending and meng.free_slots:
            meng.admit(pending.pop(0))
        meng.step()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    require(all(r.done and len(r.out) == 12 for r in mreqs),
            f"mixtral requests not answered: {[(r.rid, r.done, len(r.out)) for r in mreqs]}")
    require(meng.tokens_out == 72, f"mixtral engine committed {meng.tokens_out} tokens")
    p0 = mreqs[0].prompt
    step_logits = next(out[0] for pos, out in meng.trace if pos[0] == len(p0) - 1)
    full = M.forward_train(mparams, {"tokens": torch.from_numpy(p0).to(dev)[None]}, mcfg, True)[0]
    err, rel = logits_close(torch.from_numpy(step_logits).to(dev), full[0, -1],
                            "mixtral decode vs prefill logits")
    runs.append({"run": "serve (smoke)", "model": mcfg.name, "layers": mcfg.n_layers, "slots": 4,
                 "max_seq": 128, "requests": len(mreqs),
                 "prompt_lens": [len(r.prompt) for r in mreqs], "steps": meng.steps_run,
                 "tokens": meng.tokens_out, "s": serve_s,
                 "smoke_tokens_per_s": meng.tokens_out / serve_s,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "launches": {c.__name__: c.launches for c in all_counters},
                 "decode_vs_prefill_logits": {"max_abs_err": err, "rel_rms": rel}})
    emit(runs[-1])
    del meng, mbatch, mtokens, full
    release()
    require(flip_share < ROUTE_FLIP_MAX and (flips["first_gap_max"] or 0) < FIRST_FLIP_GAP_MAX,
            f"mixtral: {flip_share:.4%} of (token, layer) routes differ between the kernel and "
            f"naive passes, or one first differs away from a near-tie: {flips}")

    phase("12")

    # ----------- 13. Mixtral-8x7B under expert parallelism, 8 ranks on the card
    if EP_FORWARD_LAYERS < mcfg.n_layers:
        print(f"moe_ep: the forward (part b) runs {EP_FORWARD_LAYERS} of the "
              f"{mcfg.n_layers} layers the weights hold", flush=True)
    ep_rec, ep_k4 = ep_phase(dev, mparams, mcfg, SEED)
    release()
    phase("13")
    if TP_FORWARD_TOKENS != MIXTRAL_TOKENS:
        print(f"moe_tp: the forward (part b) runs {TP_FORWARD_TOKENS} tokens, cut from "
              f"{MIXTRAL_TOKENS}: there 16 ranks ran out of the card's memory", flush=True)
    # ---- 14. the same weights under tensor parallelism, 16 ranks on the card
    tp_rec, tp_k4 = tp_phase(dev, mparams, mcfg, SEED)
    del mparams
    release()
    ep_rec["card_free_gib_after"] = torch.cuda.mem_get_info()[0] / 2**30
    ep_rec["wave_replay"] = wave_replay_check(dev, time_ms)
    emit(ep_rec)
    if ep_rec["phase_s"] > EP_PHASE_S:
        print(f"moe_ep: the phase took {ep_rec['phase_s']:.0f} s, past its {EP_PHASE_S} s",
              flush=True)
    launches["flash_attention"] += ep_k4
    kernels["flash_attention"]["launches_by_path"][f"{mcfg.name} EP forward, all ranks"] = ep_k4
    kernels["flash_attention"]["body_launches"]["wgmma"] += ep_k4
    tp_rec["card_free_gib_after"] = torch.cuda.mem_get_info()[0] / 2**30
    emit(tp_rec)
    if tp_rec["phase_s"] > TP_PHASE_S:
        print(f"moe_tp: the phase took {tp_rec['phase_s']:.0f} s, past its {TP_PHASE_S} s",
              flush=True)
    launches["flash_attention"] += tp_k4
    kernels["flash_attention"]["launches_by_path"][f"{mcfg.name} TP forward, all ranks"] = tp_k4
    kernels["flash_attention"]["body_launches"]["wgmma"] += tp_k4
    release()

    phase("14")

    # ------- 15. two Mixtral-8x7B tenants as guests of one fleet, 8 ranks on the card
    fleet_rec = fleet_phase(dev, mcfg, SEED)
    release()
    fleet_rec["card_free_gib_after"] = torch.cuda.mem_get_info()[0] / 2**30
    emit(fleet_rec)
    if fleet_rec["phase_s"] > FLEET_PHASE_S:
        print(f"fleet: the phase took {fleet_rec['phase_s']:.0f} s, past its {FLEET_PHASE_S} s",
              flush=True)

    phase("15")

    # ------------------------ 16. the per-shard all-reduce, 8 ranks on the card
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
    kernels["ring_exchange"] = per_shard_phase(dev, SEED)

    phase("16")

    # ------ 17. DeepSeek-V3 under expert parallelism, 16 ranks on the card, K4 on each
    ds_ep_rec, ds_ep_k4 = deepseek_ep_phase(dev, SEED)
    release()
    ds_ep_rec["card_free_gib_after"] = torch.cuda.mem_get_info()[0] / 2**30
    emit(ds_ep_rec)
    if ds_ep_rec["phase_s"] > DS_EP_PHASE_S:
        print(f"deepseek_ep: the phase took {ds_ep_rec['phase_s']:.0f} s, past its "
              f"{DS_EP_PHASE_S} s", flush=True)
    k4_rec = kernels["flash_attention"]
    k4_rec["launches"] += ds_ep_k4
    k4_rec["launches_by_path"]["deepseek-v3-671b EP forward, all ranks"] = ds_ep_k4
    k4_rec["body_launches"]["wgmma"] += ds_ep_k4
    phase("17")

    # ------- 18. the sharded training step, 4 and 8 ranks on the card, no kernel
    t18 = time.perf_counter()
    sharded_runs, tp_k4 = train_sharded_phase(dev, all_counters + (cf.ring_put, cf.ring_signal,
                                                                   cf.ring_wait_add))
    runs.extend(sharded_runs)
    for part, path in (("d", "tinyllama-1.1b TP prefill (step 18 d), all ranks"),
                       ("f", "jamba-1.5-large-398b TP prefill (step 18 f), all ranks")):
        k4_rec["launches"] += tp_k4[part]
        k4_rec["launches_by_path"][path] = tp_k4[part]
        k4_rec["body_launches"]["wgmma"] += tp_k4[part]
    if time.perf_counter() - t18 > TRAIN_SHARDED_PHASE_S:
        print(f"train_sharded: the phase took {time.perf_counter() - t18:.0f} s, past its "
              f"{TRAIN_SHARDED_PHASE_S} s", flush=True)
    phase("18")

    # ---------------- 19. the dry run on meta, and one rank's share on the card
    dry_runs, dry_k4, dry_bodies = dryrun_phase(dev)
    runs.extend(dry_runs)
    k4_rec["launches"] += dry_k4
    k4_rec["launches_by_path"]["tinyllama-1.1b prefill_32k, rank 0's share (dry run)"] = dry_k4
    for body, n in dry_bodies.items():
        k4_rec["body_launches"][body] += n
    phase("19")

    # ------------- 20. the serve_moe example as a user runs it, on the card
    runs.append(serve_example_phase())
    emit(runs[-1])
    phase("20")

    # --------------------------------------------------------------- report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("body", "body_launches", "acc_launches", "body_ms", "combine_hook_ms",
             "combine_hook_bound_ms", "ffma_bound_ms", "tf32x3_route_bound_ms",
             "launches_by_path", "mixtral_shape", "mla_shape", "jamba_shape", "local_heads")
    print(card, flush=True)
    emit({"kernels": [{key: rec[key] for key in keys + extra if key in rec or key in keys}
                      for rec in kernels.values()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
